#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own line(s) before the last line:

1. device: the card's name and power limit (nvidia-smi); TF32 off for
   matrix products and convolutions (the reference computes in f32); the
   allocator's expandable segments on (set before torch allocates on the
   card; phase 14d's 4 GB slabs fragment the default pool);
2. build: nvcc builds the kernels from src/repro_torch/csrc, each source
   by its own nvcc, all started together; the update (B1), channel (B2),
   accumulating transmit (B3b), quantize transmit (B3c), receive (B4)
   and CMS-draw kernels as compiled: registers, shared memory and
   spills from the compiler's report (-Xptxas -v), which must show no
   spill; then the Hopper flash-attention kernel
   (its two instances, by padded head width 64 and 128): the same report
   (registers, which must be 168 for setmaxnreg's balance, and no spill),
   its dynamic shared memory, no note of ptxas's that it fenced or
   serialized the wgmma pipeline, and a cuobjdump -sass count that must
   show wgmma (HGMMA) and TMA loads (UTMALDG) and no local memory;
3. kernel adaptive_update_slab against its plain version: six modes,
   f32 and bf16 g/w, alpha in {1.2, 1.5, 2.0}, at the main path's slab
   (175,104 entries), at the same slab 3 elements off 16-byte alignment,
   and at the million-client stream's (4096);
4. kernel ota_channel_slab against its plain version at 50 x 175,104,
   alpha in {1.2, 1.5, 2.0}, then at alpha 1.5 at 1 x 175,104 and
   1 x 4096 (the streamed finishes), 2000 x 4096 (h in two chunks) and
   37 x 4097 (d % 4 != 0: plain loads), each with pilot statistics on
   and off (count exact, padding exactly 0); the bulk-copy ring and the
   plain loads bitwise equal;
5. kernel ota_transmit_slab against its plain version at 50 x 175,104
   (the last 38 columns zero, as the slab's padding): int8 with host
   stochastic rounding and round-to-nearest, sign and folded sign, each
   with and without error feedback; the in-kernel Philox rounding held
   to one quantization step and to zero bias; then the plain quantizer
   applied to the kernel's own sum (the accumulating transmit's no-carry
   call + ef) at 50 x 175,104, 1 x 175,104 (the streamed finish: h = 1,
   n_total = 1) and 7 x 640 (a last tile of one quantization block):
   the int8 payload, scales and residual (host rounding, RTN) and the
   sign payload bitwise, the sign scales and residuals at 1e-6;
6. kernel ota_receive_slab against its plain version: R in {1, 3}, the
   int8 container and the fold / planes sign words, alpha in
   {1.2, 1.5, 2.0}, pilot statistics on and off; its grid resident in
   one wave (blocks an SM from the occupancy API); with statistics one
   launch (torch.profiler sees one kernel), the same bits in two runs;
   1 x 640 with statistics;
7. runtime alpha: adaptive_update_slab with alpha a device tensor,
   launched under torch.cuda.set_sync_debug_mode("error"), against its
   plain version, and the server half of a tracked round (the MAC with
   statistics, the EMA, the update) under the same mode: no read back
   to the host;
7b. kernel cms_draws_slab, the round's CMS draws, against its plain
   version (kernels.ref.cms_draws_ref: two torch.rand calls, the
   transforms, the padding) on two card generators seeded alike, at the
   main path's slab (175,066 entries padded to 175,104) and at run (b)'s
   (987,833,344, no padding): u, e and the (0, 1) tail bitwise, the
   generators' offsets after the draw equal, the next torch.rand of each
   bitwise, one launch a draw;
8. reference: small inputs through the round on the card and on the CPU
   (plain versions), same draws: logistic regression and a small
   ResNet-tiny agree within their tiers; then quantized rounds (int8 +
   error feedback, folded sign + error feedback) of logistic regression;
9. main path: ResNet-tiny at full width (channels 16/32/64, 2 blocks
   per stage; 175,066 parameters), 50 clients, batch 8 of 32x32x3,
   adam_ota then adagrad_ota, 5 rounds each, through
   make_slab_round_runner + run_rounds_slab with the port's own draws.
   Every launch counter (the CMS draws' among them) is set to 0 just
   before and read just after: each kernel must have launched exactly
   once per round. Then four
   wire runs of adam_ota, 5 rounds each, the counters set to 0 before
   and read after each: f32 uplink with alpha="auto"; int8 uplink with
   error feedback and the int8 downlink, alpha="auto"; folded sign with
   error feedback, static alpha 1.5; int8 with in-kernel rounding
   (sr_inkernel) and error feedback, static alpha 1.5;
10. kernel ota_transmit_slab(acc=, row_chunk=), the accumulating
   transmit of the streamed client axis, against its plain version:
   row_chunk None / 1 / 7 / N, the carry absent or random, n_total != N,
   at 50 x 175,104 and 37 x 4,097 (random rows) and at 2000 x 4096 (the
   million-client path's own gradient rows, and row_chunk 64 and 1999);
   the f32 transmit without a carry (the same kernel) too; then, with a
   carry, 2001 x 4,100 (a last column tile of 4 columns and a ragged last
   segment; row_chunk None and 64) and 5 x 4096 (fewer rows than
   segments the grid would like). 37 x 4,097 runs the scalar path. Every
   case where the rows split across blocks (S > 1) is also bitwise its
   summation order (ota_transmit_split_model) and itself run to run;
   each case's S is printed. The bulk-copy ring and the plain loads (G
   off a 16-byte boundary) agree bitwise. One chunk with no carry is
   bitwise the channel kernel's faded sum (scale 0) at 50 x 175,104,
   2000 x 4096 and 1 x 4096;
10b. kernel B3a, the no-carry f32 transmit of the sharded round,
   against its plain version at 50 x 175,104 (the (1,)-mesh ResNet
   round), 8 x 62,928,640 (the (1,)-mesh 100m CLI round), 25 x 175,104
   (a rank's rows at P = 2) and 4 x 987,833,344 (run (b)'s width); past
   175,104 the plain version a 2^26-column piece at a time; the last
   two no one-card run launches: checked and timed, not kernels-line
   rows;
11. reference: streamed logistic-regression rounds on the card against
   the same rounds on the CPU: serial, double-buffered, ragged, weighted;
11b. reference LM: the tiny preset in f32 (4 clients x batch 2 x seq
   32 of the training CLI's corpus, adam_ota), 3 rounds through
   make_slab_round_runner on the card and on the CPU with the same
   parameters, batches and draws, on the f32 wire and on int8 + EF: the
   losses within 1e-5, the state slabs within the tiers of
   tests/test_torch_lm_train.py;
12. streamed equals resident: ResNet-tiny at full width, 50 clients,
   chunk 50, 3 rounds of adam_ota, bitwise the resident round's state;
13. streamed runs S1-S3 of ResNet-tiny at full width: 200 clients,
   batch 8, sample_rate 0.25, Dirichlet data-size weights, alpha="auto",
   3 rounds each (S1 chunk 50 serial f32; S2 chunk 50 double-buffered
   f32; S3 chunk 64, ragged, int8 + EF + int8 downlink), every counter
   set to 0 before and read after each; then a dead round (an all-zero
   mask) on S3's state under set_sync_debug_mode("error");
14. the million-client stream: d = 4096, the quadratic loss of the JAX
   package's streamed benchmark, batches made from the client index,
   1,000,000 clients in chunks of 2000, 2 rounds serial and 2
   double-buffered, with launch counts and peak memory; one more serial
   round under set_sync_debug_mode("error"); one more round of the same
   step under torch.profiler: the card time of its accumulating-transmit
   launches, which the counter and the profiler must both count 500;
14a. the per-round pytree API at full width: ResNet-tiny, 50 clients,
   batch 8, init_server + make_round_step + run_rounds for each of the
   six optimizers on the f32 uplink, then adam_ota on the int8 uplink,
   5 rounds each, beside the resident runner (make_slab_round_runner +
   run_rounds_slab) on the same draws and batches: every counter set to
   0 before each run and read after (one channel and one update launch
   a f32 round; one transmit, one receive and one update an int8
   round), the final params, optimizer state and history bitwise the
   resident runner's, ms per round of both on the host clock; then the
   quickstart twin (examples/quickstart_torch.py) on the card:
   logistic regression, 20 clients, xi_scale 0.5, 60 rounds, adam_ota
   and fedavgm, both accuracies printed, the losses finite;
14b. checkpoint and resume on the card: ResNet-tiny at full width,
   adam_ota, int8 uplink with error feedback, the int8 downlink and
   alpha="auto", 6 rounds with chunk_hook writing save_slab_state
   (blocking=False) at round 3 beside a blocking save, then
   load_slab_state onto the card and run_rounds_slab(start_round=3):
   the final state bitwise the uninterrupted run's, the async file's
   bytes the blocking file's; the file's size and both saves' host
   times printed;
14c. LM training: the training CLI (repro_torch.launch.train.main) at
   --preset 100m (8 layers, d_model 768, 12 heads / 4 kv, d_ff 2048,
   vocab 8192; 62,928,640 parameters) with its defaults (8 clients x
   batch 2 x seq 128, adam_ota) but --lr 0.002 (at the default 0.02 the
   loss rises, in the JAX package too), 6 rounds on each of four wires: f32;
   int8 + EF + int8 downlink + --track-alpha; folded sign + EF; --client-
   chunk 4 --sample-rate 0.5 --client-weights datasize. Every counter,
   B5's among them, set to 0 before and read after each run: one B2 and
   one B1 a f32 round, one B3c, one B4 and one B1 a quantized round, two
   B3b (one a chunk), one B2 (the finish) and one B1 a streamed round,
   and no B5 launch; the losses finite and falling; ms a round, tokens
   per second and peak memory printed. Then a --ckpt-dir run of 3 rounds
   resumed to 6, bitwise the uninterrupted f32 run;
14d. LM at full width: StarCoder2-15B's width at depth 1 (d_model 6144,
   48 heads / 4 kv, d_ff 24576, vocab 49,152; 987,833,344 parameters, a
   3.95 GB f32 slab), 4 clients x batch 2 x seq 128, 4 rounds on the f32
   wire and 4 on int8 + EF (the first cold, the median of the rest
   quoted) through make_slab_round_runner(model.loss_fn)
   + run_rounds_slab, the calls the CLI makes: the same launch counts
   and one CMS draw a round (runs (b)-(g) alike), ms a round, tokens
   per second and peak memory;
14g. (after 14d) the moe, mla, rwkv and hybrid families trained: the
   training CLI at --preset tiny for qwen3-moe-235b-a22b,
   kimi-k2-1t-a32b, minicpm3-4b, rwkv6-7b and hymba-1.5b (its defaults
   otherwise: 8 clients x batch 2 x seq 128,
   adam_ota), 4 rounds on the f32 wire and 4 on int8 + EF, every counter
   (B5's among them) set to 0 before and read after each run: one B2
   and one B1 a f32 round, one B3c, one B4 and one B1 an int8 round, no
   B5 launch; the losses finite;
14h. run (c): MiniCPM3-4B's full width (MLA) at depth 8 (877,455,872
   parameters, a 3.51 GB f32 slab), as 14d: 4 clients x batch 2 x seq
   128, 4 rounds on the f32 wire and 4 on int8 + EF through
   make_slab_round_runner(model.loss_fn) + run_rounds_slab, launches
   counted, ms a round, tokens per second and peak memory;
14h'. runs (d) and (e), the recurrent families at full width, as 14h:
   (d) RWKV-6-7B's width at depth 2 (979,501,056 parameters, a 3.92 GB
   f32 slab), (e) Hymba-1.5B's width at depth 8 (492,600,000 parameters,
   its SSM's sequential scan under vmap(grad)), each 4 clients x batch
   2 x seq 128, 4 rounds on the f32 wire and 4 on int8 + EF, launches
   counted (no B5), ms a round, tokens per second and peak memory;
14k. runs (f) and (g), the cross-attention families at full width with
   their embeddings in every batch (fresh standard normals each round:
   1601 bf16 image tokens, 1500 f32 frames an example), as 14h: (f)
   Llama-3.2-Vision-11B's width, one group cut to 1 gated cross-attention
   + 1 dense layer (1,486,901,250 parameters, a 5.95 GB f32 slab; the
   published group of 1 + 4 does not fit the round's server update), 2
   clients x batch 1 x seq 128, 4 rounds on the f32 wire; (g)
   Whisper-medium whole (24 + 24 layers, 811,579,392 parameters), 4
   clients x batch 1 x seq 128, 4 rounds on the f32 wire and 4 on int8
   + EF; launches counted (no B5: the training forward's encoder and
   cross-attention take the plain path), ms a round, tokens per second
   and peak memory. Runs (b)-(g) take their published configs' remat:
   every layer of loss_fn's stacks is recomputed in the backward (a vlm
   group as one);
14l. the remat trade: run (g)'s Whisper-medium at 2 clients x 1 on the
   f32 wire with remat off, then on, a warm-up round and 3 timed each,
   launches counted: peak memory and the median ms a round of each, the
   warm-up losses within 1e-6;
14m. the levers: the smoke configs of qwen3-14b (kv_chunk 8),
   starcoder2-15b (window_block at window 8) and hymba-1.5b (both and
   ssm_chunk 8), each with remat, in f32 on the card against the same
   model with them off: vmap(grad_and_value(loss_fn)) over 3 clients x 2
   x 40 tokens within 1e-5 of scale, no B5 launch; prefill + 8 greedy
   tokens, the ids equal;
14n. a long sequence: run (b)'s cut (StarCoder2-15B's width at depth 1),
   one round at 1 client x 1 x 8192 tokens at its window 4096 (or its
   out-of-memory error: the round's slabs hold ~36 GB), then the round's
   client step alone, vmap(grad_and_value(loss_fn)) over 1 client, at
   8192 tokens (2 windows: the blocked branch not taken, the two runs the
   same computation) and 12288 at window 4096, 8192 at window 2048 and
   4096 at window 1024 (the window cut so that S > 2W fits), window_block
   off and on, a warm-up step and one timed each, launches counted
   (none): peak memory and ms, or the out-of-memory error of a step the
   card cannot hold (the blocked steps at the cut windows must fit; where
   both fit, the losses within the bf16 tier, 2e-3);
14j. examples/serve_decode_torch.py on the card with its defaults
   (rwkv6-7b --preset tiny, batch 2 x prompt 32, 8 tokens): the JAX
   CLI's two lines, then the port's rate and memory line;
14i. examples/alpha_mismatch_torch.py on the card: AdaGrad-OTA on a
   true-alpha 1.2 channel, matched, alpha 2.0 and alpha="auto", 80
   rounds each (one B2 and one B1 a round, counted); the tracked
   alpha_hat within 0.1 of 1.2, the example's verdict line printed;
14o. the paper's figure experiments (repro_torch/experiments/
   paper_figs.py, the twin of benchmarks/paper_figs.py) on the card
   through the per-round API: examples/paper_experiment_torch.py
   --skip-mismatch at its defaults (fig 2 and fig 5 on logistic
   regression, 50 clients, 60 rounds; its assertion, Adam-OTA's
   accuracy >= FedAvgM's, must hold), then fig3, fig4, fig6 (2 to 100
   clients), fig7 (the MLP), beyond_yogi and fig2 on the cnn task
   (ResNet-tiny at channels 8/16, one block a stage) at 80 rounds, the
   count the JAX script runs; a line a run (final_loss, speed_loss,
   accuracy, us_per_round); every counter set to 0 before and read
   after: one B2 and one B1 a round (2020 each), nothing else; the
   paper's orderings printed OK / VIOLATED (not held); B1 (adam,
   adagrad, yogi, momentum) and B2 against their plain versions at the
   figure shapes (d = 384 / 2816 / 5248, N = 2 / 50 / 100); a 5-round
   _run card vs CPU on the same draws, the losses and accuracy within
   1e-5; the phase's seconds beside the card's name and power limit;
14e. the sharded engine (core/shard.py) on the (1,)-mesh: one rank in
   this process, NCCL on a HashStore. ResNet-tiny at full width, 5
   rounds of adam_ota on f32, int8 + EF + int8 downlink + alpha "auto",
   folded sign + EF and S1 (200 clients, chunk 50, sample_rate 0.25,
   data-size weights, alpha "auto"), each on the resident and the
   sharded runner in turns (resident, sharded, sharded, resident) from
   one state with the same draws and batches: every counter set to 0
   before each sharded run and read after (f32: one B3a and one B1 a
   round, no B2; quantized: two B3c, two B4 (one with pilot statistics
   under alpha "auto", by its own counter), one B1; S1: four B3b, one
   B1), the f32 state within 1e-5 of the resident runner's, the quantized
   state bitwise, ms a round of both; one more sharded round under
   sync_debug_mode("error");
14f. the training CLI at --preset 100m --lr 0.002, 3 rounds, with
   --backend pallas_sharded --mesh 1 beside the resident CLI, f32 and
   int8 + EF, launches counted: the f32 losses within 1e-5 relative and
   its state within 1e-5 of the resident CLI's (as 14e), the int8 state
   bitwise; ms a round, tokens per second and peak memory of
   both;
15. kernel flash_attention against its plain version: the six
   FLASH_CASES of tests/test_kernels.py and three small ones at head
   dims 80, 96 and 112 (padded to 128 by the Hopper kernel) in f32 and
   bf16, then the
   prefill shapes of Qwen3-14B (1 x 4096, 40 heads, 8 kv heads, D 128,
   causal), StarCoder2-15B (1 x 6144, 48 heads, 4 kv heads, D 128,
   causal, window 4096), Qwen3-MoE-235B-A22B (1 x 4096, 64 heads, 4 kv
   heads, D 128, causal) and Kimi-K2 (1 x 4096, 64 heads, 8 kv heads,
   D 112, causal: the Hopper variant in bf16, padded to 128) and
   Hymba-1.5B (1 x 4224
   with its 128 meta tokens, and 4 x 192, 25 heads, 5 kv heads, D 64,
   causal, window 1024), Llama-3.2-Vision-11B (32 / 8 heads, D 128: its
   causal 1 x 4096 and 4 x 64, its cross-attention over 1601 image
   tokens at 1 x 4096 and 4 x 64, and decode's 4 x 1 and 1 x 1 against
   them) and Whisper-medium (16 / 16 heads, D 64: the encoder's 1 x 1500
   and 4 x 1500 both ways, the decoder's causal 1 x 448 and 4 x 64, its
   cross-attention over 1500 frames at 1 x 448 and 4 x 64, decode's 4 x 1
   and 1 x 1): B5's first non-causal launches with Sq != Sk and Sq = 1 at
   a model's shapes, each key count a ragged last tile; then three
   cases with query rows that see no key (D 128, 64 and 112),
   each in f32 and bf16 through the variant the wrapper picks (printed,
   and checked against flash_variant): the Hopper kernel (bf16, D 64 or
   80-128 in steps of 16) per element at 2^-7 |ref| + 2^-8 attn(q, k,
   |v|) + 2e-5, the
   scalar one at 2e-5 in f32 and 2^-7 |ref| + 2e-5 in bf16; before any
   language model is on the card;
15b. the kernels at the LM runs' shapes against their plain versions:
   B1 (adam) at d = 62,928,640, 987,833,344 and 877,455,872; B2 at 8 x
   62,928,640, 1 x 62,928,640 (the streamed finish), 4 x 987,833,344 and
   4 x 877,455,872; B3b at 4 x 62,928,640 with a carry; B3c int8 + EF
   at 8 x 62,928,640, 4 x 987,833,344 and 4 x 877,455,872, folded sign +
   EF at 8 x 62,928,640; B4 at 1 x 62,928,640 (int8 with and without
   statistics, folded sign), 1 x 987,833,344 and 1 x 877,455,872 (int8),
   at
   the tiers of phases 3-6 and 10; then B1 at d = 979,501,056 and
   492,600,064, B2 and B3c at 4 x each, B4 at 1 x each (runs (d), (e));
   B1 at d = 1,486,901,376 and B2 at 2 x it (run (f)), B1 at d =
   811,579,392, B2 and B3c at 4 x it, B4 at 1 x it (run (g));
16. serve qwen3-14b: full width and depth (40 layers, 14.8 B parameters,
   bf16, random from seed 0) through repro_torch.launch.serve.generate,
   greedy: (a) the serve CLI's defaults, batch 4 x prompt 64, 32 tokens;
   (b) batch 1 x prompt 4096, 8 tokens. Each shape runs cold (its
   first run), then warm (the timed run), with the same ids; the flash
   counters are set to 0 before and read after each run, by variant: one
   launch per layer in the prefill, of the variant flash_variant picks
   (here Hopper), and none in decode; logits finite; then one prefill and
   one decode step under torch.profiler, each printed with its own
   host-clock time and the card's busy and idle shares;
17. serve starcoder2-15b: full width (40 layers, 16.0 B parameters),
   batch 1 x prompt 6144 (past the 4096 window: the ring cache and the
   window mask both run), 8 tokens, the same checks;
17b. serve qwen3-moe-235b-a22b at full width, 12 of 94 layers (31.1 B
   parameters, 62.2 GB), 4 x 64 -> 32 and 1 x 4096 -> 8, the same
   checks (12 Hopper launches a prefill); first its expert product (bf16
   operands, f32 result: cuBLAS with an f32 output) against the f32
   product at the 1 x 4096 prefill's dispatch shape; batch-4 decode runs
   at capacity 1 (the JAX package's rule: a second token routed to an
   expert is dropped);
17c. serve kimi-k2-1t-a32b at full width, 1 of 61 layers (19.4 B
   parameters, 38.8 GB; 384 experts and a shared one), 1 x 4096 -> 8, the
   same checks (1 Hopper launch a prefill: head_dim 112, padded to 128;
   no scalar launch);
17d. serve minicpm3-4b at full width and depth (62 layers, 4.26 B
   parameters, MLA), 4 x 64 -> 32 and 1 x 4096 -> 8, the same checks with
   no flash launch (MLA attention is plain torch);
17e. serve rwkv6-7b at full width and depth (32 layers, 7.62 B
   parameters), 4 x 64 -> 32 and 1 x 4096 -> 8, the same checks with no
   flash launch (attention-free; the O(1) recurrent cache);
17f. serve hymba-1.5b at full width and depth (32 layers, 1.66 B
   parameters, 128 meta tokens, window 1024), 4 x 64 -> 32 and
   1 x 4096 -> 8, the same checks (32 Hopper launches a prefill, D 64),
   and the KV cache's length JAX's min(s + gen + 128, 1024) (the ring
   at 1 x 4096);
17g. serve llama-3.2-vision-11b at full width and depth (40 layers in 8
   groups, 9.78 B parameters) with the serve CLI's stub image tokens
   (1601 bf16 an example), 4 x 64 -> 32 and 1 x 4096 -> 8, the same
   checks: 40 Hopper launches a prefill (32 causal, 8 cross-attention
   over the image tokens) and 8 a decode step (the cross-attention at
   Sq = 1), counted by variant and by shape; the card time a decode step
   spends recomputing the cross-attention keys and values from the
   cached image tokens (CUDA events);
17h. serve whisper-medium at full width and depth (24 + 24 layers,
   0.81 B parameters) with the stub frames (1500 f32 an example), 4 x 64
   -> 32 and 1 x 448 -> 8 (its text context), the same checks: 72 Hopper
   launches a prefill (24 encoder, 24 causal, 24 cross-attention) and 24
   a decode step, and the cross K/V recomputation's card time;
18. reference serve: the smoke configs of qwen3-14b, starcoder2-15b,
   qwen3-moe-235b-a22b, kimi-k2-1t-a32b, minicpm3-4b, rwkv6-7b and
   hymba-1.5b, llama-3.2-vision-11b and whisper-medium (the last two
   with the stub inputs) in f32 on the card against the same parameters
   on the CPU (plain versions): prefill logits, caches and 8 greedy ids;
   the f32 path of the scalar flash kernel, one launch a layer in each
   prefill (none in minicpm3's and rwkv6's) and one a cross-attention
   layer in each decode step, none of the Hopper one;
19. times: the launch floor (a near-empty launch, timed as the kernels
   are); then CUDA events, first at the LM runs' shapes (those of 15b,
   torch.addmv beside B3b), then B3a at the shapes of 10b beside its
   plain version and torch.addmv, then median of 50 launches, each after
   an L2 flush
   and a device sleep that covers the host's enqueue, of each kernel and
   its plain version at the main path's shapes (B1 also at d = 4096; B2
   at 50 x 175,104 in turns with B3b's no-carry call, with pilot
   statistics, and at the streamed finishes 1 x 175,104 and 1 x 4096;
   B3c at 50 x 175,104 in turns with B3b's no-carry call, with in-kernel
   rounding, and at S3's finish 1 x 175,104; B4 with pilot statistics;
   the CMS draws at 175,104 and at run (b)'s 987,833,344: 8 B an entry
   written), beside the least time the card needs for the bytes or the
   operations
   and the launch floor (and, where one
   PyTorch call computes the same function, that call: torch.addmv for
   the accumulating transmit, scaled_dot_product_attention for flash
   attention: the variant flash_variant picks at each FLASH_MODEL_SHAPES
   shape in bf16 (Hymba's with its window mask, the non-causal ones with
   none, is_causal as the kernel's), with its TFLOP/s and its ratio to
   scaled_dot_product_attention, and the scalar one at Qwen3-14B's in
   f32; then the scalar kernel at Kimi-K2's bf16 shape through its C
   entry, which the wrapper no longer sends there: the Hopper kernel's
   before and after in one call); the accumulating transmit's S, and at
   the
   million-client chunk the same kernel on the same grid without a fold,
   to show what the fold costs;
then the script's seconds so far, one JSON line listing the kernels (and
the launch floor), and the result line.

Exits non-zero, and prints no result, without a CUDA device, without the
repository beside it, or when any phase fails.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet: device memory rate, f32 rate outside the
# tensor cores and the dense bf16 tensor-core rate (at the full 700 W
# power limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

D_MAIN = 175104          # ResNet-tiny's padded slab (175,066 parameters)
N_CLIENTS = 50
BATCH = 8
ROUNDS = 5
N_STREAM = 200           # the streamed runs S1-S3
STREAM_ROUNDS = 3
SAMPLE_RATE = 0.25
# The JAX package's million-client streamed benchmark
# (benchmarks/train_loop_bench.py, bench_streamed_loop).
N_MILLION = 1_000_000
D_MILLION = 4096
CHUNK_MILLION = 2000
TIMED_LAUNCHES = 50
# Flash attention (B5): tests/test_kernels.py's cases, (B, Sq, Sk, H, K,
# D, causal, window), and the two models' prefill shapes.
FLASH_CASES = [
    (1, 32, 32, 2, 2, 16, True, None),
    (2, 64, 64, 4, 2, 32, True, None),
    (1, 100, 100, 8, 8, 64, True, 48),
    (2, 1, 96, 4, 2, 32, False, None),
    (1, 80, 80, 6, 3, 16, True, 16),
    (1, 33, 65, 2, 1, 8, False, None),
    # head dims the Hopper kernel pads to 128 columns: ragged, GQA, a
    # window, Sq != Sk
    (1, 100, 100, 8, 8, 80, True, 48),
    (2, 64, 150, 4, 2, 96, False, None),
    (1, 200, 200, 8, 1, 112, True, None),
]
FLASH_MODEL_SHAPES = {
    "qwen3-14b": (1, 4096, 4096, 40, 8, 128, True, None),
    "starcoder2-15b": (1, 6144, 6144, 48, 4, 128, True, 4096),
    "qwen3-moe-235b-a22b": (1, 4096, 4096, 64, 4, 128, True, None),
    "kimi-k2-1t-a32b": (1, 4096, 4096, 64, 8, 112, True, None),
    # 1 x 4096 prompt tokens after 128 meta tokens: 33 q tiles of 128
    "hymba-1.5b": (1, 4224, 4224, 25, 5, 64, True, 1024),
    # Llama-3.2-Vision: its dense layers' causal prefill (32 / 8 heads),
    # the cross-attention over the 1601 image tokens (12 x 128 + 65: a
    # ragged last key tile) and decode's one query row against them
    "llama-3.2-vision-11b": (1, 4096, 4096, 32, 8, 128, True, None),
    "llama-3.2-vision-11b cross": (1, 4096, 1601, 32, 8, 128, False, None),
    "llama-3.2-vision-11b cross decode": (4, 1, 1601, 32, 8, 128, False,
                                          None),
    # Whisper (16 / 16 heads, D 64): the encoder's bidirectional 1500
    # frames (11 x 128 + 92), the decoder's causal 448 tokens (its text
    # context), its cross-attention over the frames and decode's row
    "whisper-medium encoder": (1, 1500, 1500, 16, 16, 64, False, None),
    "whisper-medium": (1, 448, 448, 16, 16, 64, True, None),
    "whisper-medium cross": (1, 448, 1500, 16, 16, 64, False, None),
    "whisper-medium cross decode": (4, 1, 1500, 16, 16, 64, False, None),
}
# serve shapes checked in phase 15 but not timed: Hymba's 4 x 64, the
# 4 x 64 runs' shapes of the cross-attention families, their 1 x ... decode
FLASH_SERVE_SHAPES = {
    "hymba-1.5b 4x64": (4, 192, 192, 25, 5, 64, True, 1024),
    "llama-3.2-vision-11b 4x64": (4, 64, 64, 32, 8, 128, True, None),
    "llama-3.2-vision-11b cross 4x64": (4, 64, 1601, 32, 8, 128, False, None),
    "llama-3.2-vision-11b cross decode 1x1": (1, 1, 1601, 32, 8, 128, False,
                                              None),
    "whisper-medium encoder 4x1500": (4, 1500, 1500, 16, 16, 64, False, None),
    "whisper-medium 4x64": (4, 64, 64, 16, 16, 64, True, None),
    "whisper-medium cross 4x64": (4, 64, 1500, 16, 16, 64, False, None),
    "whisper-medium cross decode 1x1": (1, 1, 1500, 16, 16, 64, False, None),
}
# serve runs: (name, arch, batch, prompt, tokens generated)
SERVE_RUNS = (("qwen3-14b a", "qwen3-14b", 4, 64, 32),
              ("qwen3-14b b", "qwen3-14b", 1, 4096, 8),
              ("starcoder2-15b", "starcoder2-15b", 1, 6144, 8),
              ("qwen3-moe a", "qwen3-moe-235b-a22b", 4, 64, 32),
              ("qwen3-moe b", "qwen3-moe-235b-a22b", 1, 4096, 8),
              ("kimi-k2", "kimi-k2-1t-a32b", 1, 4096, 8),
              ("minicpm3 a", "minicpm3-4b", 4, 64, 32),
              ("minicpm3 b", "minicpm3-4b", 1, 4096, 8),
              ("rwkv6 a", "rwkv6-7b", 4, 64, 32),
              ("rwkv6 b", "rwkv6-7b", 1, 4096, 8),
              ("hymba a", "hymba-1.5b", 4, 64, 32),
              ("hymba b", "hymba-1.5b", 1, 4096, 8),
              ("llama-3.2-vision a", "llama-3.2-vision-11b", 4, 64, 32),
              ("llama-3.2-vision b", "llama-3.2-vision-11b", 1, 4096, 8),
              ("whisper a", "whisper-medium", 4, 64, 32),
              ("whisper b", "whisper-medium", 1, 448, 8))
SERVE_PRESET = "full"
# Depth cuts of the served configs at full width (bf16 weights on one
# 80 GB card): Qwen3-MoE 12 of 94 layers (62.2 GB), Kimi-K2 1 of 61
# (38.8 GB); the dense ones and MiniCPM3 at full depth.
SERVE_LAYERS = {"qwen3-moe-235b-a22b": 12, "kimi-k2-1t-a32b": 1}
FLASH = "flash_attention"
# Query rows that see no key (a window, Sq > Sk + window - 1): each
# variant must give them the plain version's mean of v over all keys.
FLASH_KEYLESS = [(1, 300, 100, 4, 2, 128, False, 64),
                 (1, 300, 100, 4, 2, 64, True, 64),
                 (1, 300, 100, 4, 2, 112, True, 64)]
HOPPER_KERNEL = "flash_attention_sm90_kernel"
HOPPER_REGS = 168       # 65,536 / 384 threads, what setmaxnreg rebalances
SLEEP_CYCLES = 4_000_000   # ~2 ms at the H100's 1.98 GHz boost clock


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


class Counter:
    """One launch counter of a kernel wrapper (an attribute of it), with
    the ``launches`` / ``__name__`` interface of a wrapper itself."""

    def __init__(self, fn, attr: str, name: str):
        self.fn, self.attr, self.__name__ = fn, attr, name

    @property
    def launches(self) -> int:
        return getattr(self.fn, self.attr)

    @launches.setter
    def launches(self, value: int) -> None:
        setattr(self.fn, self.attr, value)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _ptxas_report(lib_path):
    """The compiler's -Xptxas -v report by kernel (mangled name):
    {"regs": "Used N registers, ... smem ...", "spill": "N bytes stack
    frame, N bytes spill stores, N bytes spill loads"}."""
    import re

    # "Used N registers" follows its entry function's "Compiling entry
    # function" line, a spill line its "Function properties for" line
    # (a kernel's own, or a callee's such as the sinf slow path).
    report, entry, props = {}, None, None
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '?([\w]+)", line)
        if m:
            entry = props = m.group(1)
            continue
        m = re.search(r"Function properties for '?([\w]+)", line)
        if m:
            props = m.group(1)
        elif entry and "registers" in line:
            report.setdefault(entry, {})["regs"] = line.split(":", 1)[-1].strip()
        elif props and "spill" in line:
            report.setdefault(props, {})["spill"] = line.strip()
    return report


def phase_build_report(build, lib_path):
    """The kernels as compiled. B1 (adaptive_update_kernel, 24
    instances), B2 (ota_channel_kernel, 4), B3b
    (ota_transmit_stream_kernel, 2), B3c (ota_transmit_kernel, 5), B4
    (ota_receive_kernel, 6) and the CMS draws (cms_draws_kernel, 1):
    registers, shared memory and spills from the compiler's report
    (-Xptxas -v), which must show no spill. The Hopper
    flash-attention kernels: the same report, their
    dynamic shared memory, and their SASS, which must hold wgmma (HGMMA)
    and TMA loads (UTMALDG); a register count other than HOPPER_REGS
    would unbalance setmaxnreg, so it fails here, before any launch, as
    does a spill, local memory, or a note of ptxas's that it fenced or
    serialized their wgmma pipeline. Two instances, by the padded head
    width P: 64 (D 64) and 128 (D 80-128 in steps of 16)."""
    import re

    full = _ptxas_report(lib_path)
    for kernel in ("adaptive_update_kernel", "ota_channel_kernel",
                   "ota_transmit_stream_kernel", "ota_transmit_kernel",
                   "ota_receive_kernel", "cms_draws_kernel"):
        found = {fn: r for fn, r in full.items() if kernel in fn}
        check(len(found) > 0 and all("regs" in r for r in found.values()),
              f"no compiler report for {kernel}")
        regs = sorted({int(re.search(r"Used (\d+) registers",
                                     r["regs"]).group(1))
                       for r in found.values()})
        smem = sorted({m.group(0) for r in found.values()
                       for m in [re.search(r"[\d+]+ bytes smem", r["regs"])]
                       if m})
        spills = sum(int(n) for r in found.values() for n in re.findall(
            r"(\d+) bytes spill", r.get("spill", "")))
        check(spills == 0, f"{kernel}: {spills} bytes of spill stores and "
              "loads")
        print(f"[build] {kernel}: {len(found)} instances, registers "
              f"{regs[0]}-{regs[-1]}, static shared memory "
              f"{', '.join(smem) or 'none'}, 0 bytes spilled; e.g. "
              + "; ".join(f"{r['regs']} / {r.get('spill', '')}"
                          for r in list(found.values())[:2]) + "; ok")
    report = {fn: r for fn, r in full.items() if HOPPER_KERNEL in fn}
    cuobjdump = Path(build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    ops, fn = {}, None     # SASS instructions by kernel: wgmma, TMA
    for line in sass.splitlines():   # loads, setmaxnreg, local memory
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            if HOPPER_KERNEL in fn:
                ops[fn] = dict.fromkeys(("HGMMA", "UTMALDG", "USETMAXREG",
                                         "LDL", "STL"), 0)
        elif fn in ops:
            for op in ops[fn]:
                ops[fn][op] += f" {op}" in line
    lib = build.load_library()
    # ptxas's notes where it fences (C7519: warpgroup.arrive injected) or
    # serializes the kernel's wgmma pipeline: a branch around a wgmma
    # inside a pipeline stage draws them, and spills with them
    fenced = [line.strip() for line in lib_path.with_suffix(".log")
              .read_text().splitlines() if HOPPER_KERNEL in line
              and ("C7519" in line or "serializ" in line)]
    check(not fenced, f"{HOPPER_KERNEL}: ptxas fenced or serialized its "
          f"wgmma pipeline: {fenced[:2]}")
    check(len(report) == 2 and len(ops) == 2,
          f"{HOPPER_KERNEL}: {len(report)} compiler reports and {len(ops)} "
          "SASS listings, want 2 each (P = 64, 128)")
    for fn in sorted(report):
        pw = 128 if "ILi128E" in fn else 64
        regs = int(re.search(r"Used (\d+) registers",
                             report[fn]["regs"]).group(1))
        check(regs == HOPPER_REGS, f"{HOPPER_KERNEL}<{pw}>: {regs} "
              f"registers at entry, want {HOPPER_REGS}")
        count = ops[fn]
        check(count["HGMMA"] > 0 and count["UTMALDG"] > 0,
              f"{HOPPER_KERNEL}<{pw}> SASS: {count}")
        # o[] indexed at a run-time bound would live in local memory
        spills = sum(int(n) for n in re.findall(
            r"(\d+) bytes spill", report[fn].get("spill", "")))
        check(spills == 0 and count["LDL"] + count["STL"] == 0,
              f"{HOPPER_KERNEL}<{pw}>: {spills} bytes of spill stores and "
              f"loads, SASS {count}")
        print(f"[build] {HOPPER_KERNEL}<P={pw}>: {report[fn]['regs']}; "
              f"{report[fn].get('spill', '')}; dynamic shared memory "
              f"{lib.repro_flash_attention_sm90_smem(pw)} B; SASS "
              + ", ".join(f"{op} x{n}" for op, n in count.items()) + "; ok")


def phase_kernel_update(torch, dev):
    """B1 against its plain version: six modes x f32 / bf16 g and w x
    alpha 1.2 / 1.5 / 2.0, at the main path's slab, at the same slab
    three elements off its allocation (no operand 16-byte aligned), and
    at the million-client stream's slab. Returns the worst f32 error by
    slab length."""
    from repro_torch.kernels.adaptive_update import (MODES,
                                                     adaptive_update_slab)
    from repro_torch.kernels.ref import adaptive_update_ref

    gen = torch.Generator(device=dev).manual_seed(0)
    worst_f32, worst_rel, worst_bf16 = {}, 0.0, 0.0
    cases = 0
    for d, offset in ((D_MAIN, 0), (D_MAIN, 3), (D_MILLION, 0)):
        def r(scale=1.0):
            return (scale * torch.randn(d + offset, generator=gen,
                                        device=dev))[offset:]
        for dtype in (torch.float32, torch.bfloat16):
            g, w = r().to(dtype), r().to(dtype)
            delta = r(0.1)
            delta[::17] = 0.0
            nu = r(0.01).abs()
            nu_max = nu + r(0.01).abs()
            for mode in MODES:
                for alpha in (1.2, 1.5, 2.0):
                    kw = dict(lr=0.01, beta1=0.9, beta2=0.3, alpha=alpha,
                              eps=1e-8, mode=mode,
                              nu_max=nu_max if mode == "amsgrad" else None)
                    got = adaptive_update_slab(g, delta, nu, w, **kw)
                    want = adaptive_update_ref(g, delta, nu, w, **kw)
                    torch.cuda.synchronize()
                    cases += 1
                    for i, (a, b) in enumerate(zip(got, want)):
                        a, b = a.float(), b.float()
                        err = (a - b).abs()
                        if dtype == torch.bfloat16 and i == len(got) - 1:
                            steps = err / (2.0 ** -7 * b.abs().clamp_min(
                                2.0 ** -126))
                            worst_bf16 = max(worst_bf16, float(steps.max()))
                            continue
                        tol = 1e-6 * b.abs() + 1e-6 * float(b.abs().max())
                        check(bool(torch.all(err <= tol)),
                              f"adaptive_update_slab d={d}+{offset} {mode} "
                              f"{dtype} a={alpha} output {i}: max err "
                              f"{float(err.max())}")
                        worst_f32[d] = max(worst_f32.get(d, 0.0),
                                           float(err.max()))
                        worst_rel = max(worst_rel, float(
                            (err / b.abs().clamp_min(1e-30)).max()))
    check(worst_bf16 <= 1.0, f"bf16 w off by {worst_bf16} steps")
    print(f"[kernel adaptive_update_slab] {cases} cases (6 modes x f32/bf16 "
          f"x alpha 1.2/1.5/2.0 at d={D_MAIN}, at d={D_MAIN} 3 elements off "
          f"16-byte alignment, and at d={D_MILLION}): max_abs_err="
          f"{max(worst_f32.values()):.3e} max_rel_err={worst_rel:.3e} (tol "
          f"1e-6 rel + 1e-6 of scale); bf16 w within {worst_bf16:.2f} bf16 "
          f"steps (tol 1) ok")
    return worst_f32


# B2's shapes: (N, d) -> what runs it. The streamed finishes are one row
# (h = 1, n_total = 1); 2000 x 4096 stages h in two chunks; 37 x 4097
# (d % 4 != 0) takes the plain-load path.
CHANNEL_SHAPES = {(N_CLIENTS, D_MAIN): "the resident round",
                  (1, D_MAIN): "the streamed finish, S1-S3",
                  (1, D_MILLION): "the million-client finish",
                  (CHUNK_MILLION, D_MILLION): "h in two chunks",
                  (37, 4097): "d % 4 != 0: plain loads"}


def phase_kernel_channel(torch, dev, total):
    """B2 against its plain version: at the main path's 50 x 175,104
    alpha 1.2 / 1.5 / 2.0, then every CHANNEL_SHAPES entry at alpha 1.5,
    each with pilot statistics on and off; the padding exactly 0 and the
    statistics' count exact. The bulk-copy ring and the plain loads (the
    same rows 4 bytes off a 16-byte boundary) agree bitwise. Returns the
    worst error by shape."""
    from repro_torch.core.channel import CMS_U_BOUND
    from repro_torch.kernels.ota_channel import ota_channel_slab
    from repro_torch.kernels.ref import ota_channel_ref

    gen = torch.Generator(device=dev).manual_seed(1)
    worst, worst_stats, cases = {}, 0.0, 0
    for n, d in CHANNEL_SHAPES:
        grads = torch.randn(n, d, generator=gen, device=dev)
        h = (torch.ones(n, device=dev) if n == 1 else
             0.5 + torch.rand(n, generator=gen, device=dev))
        u = (2 * torch.rand(d, generator=gen, device=dev) - 1) * CMS_U_BOUND
        e = -torch.log(torch.rand(d, generator=gen, device=dev))
        # the slab's padding tail: no gradient, the CMS fixed point (0, 1)
        pad = D_MAIN - total if d == D_MAIN else 38
        grads[:, d - pad:], u[d - pad:], e[d - pad:] = 0.0, 0.0, 1.0
        n_total = 1 if n == 1 else None
        alphas = (1.2, 1.5, 2.0) if (n, d) == (N_CLIENTS, D_MAIN) else (1.5,)
        for alpha in alphas:
            for stats in (False, True):
                kw = dict(alpha=alpha, scale=0.1, pilot_stats=stats,
                          n_total=n_total)
                got = ota_channel_slab(grads, h, u, e, **kw)
                want = ota_channel_ref(grads, h, u, e, **kw)
                torch.cuda.synchronize()
                what = f"ota_channel_slab {n}x{d} a={alpha} stats={stats}"
                if stats:
                    (got, gs), (want, ws) = got, want
                    check(float(gs[0]) == float(ws[0]) == d - pad,
                          f"{what}: count {float(gs[0])} vs {float(ws[0])}")
                    rel = float(((gs - ws).abs()
                                 / ws.abs().clamp_min(1)).max())
                    check(rel <= 1e-5, f"{what}: stats rel err {rel}")
                    worst_stats = max(worst_stats, rel)
                err = (got - want).abs()
                scale = float(want.abs().max())
                check(bool(torch.all(err <= 1e-6 * want.abs()
                                     + 1e-6 * scale)),
                      f"{what}: max err {float(err.max())}")
                check(bool(torch.all(got[d - pad:] == 0.0)),
                      f"{what}: padding not 0")
                worst[(n, d)] = max(worst.get((n, d), 0.0), float(err.max()))
                cases += 1
        if d % 4 == 0 and n > 1:
            off = torch.empty(grads.numel() + 1, device=dev)[1:].view(n, d)
            off.copy_(grads)
            check(torch.equal(ota_channel_slab(grads, h, u, e, alpha=1.5,
                                               scale=0.1),
                              ota_channel_slab(off, h, u, e, alpha=1.5,
                                               scale=0.1)),
                  f"ota_channel_slab {n}x{d}: the load paths disagree")
            del off
    print(f"[kernel ota_channel_slab] {cases} cases ({N_CLIENTS}x{D_MAIN} "
          f"alpha 1.2/1.5/2.0, then " + ", ".join(
              f"{n}x{d} ({what})" for (n, d), what in CHANNEL_SHAPES.items()
              if (n, d) != (N_CLIENTS, D_MAIN))
          + " at alpha 1.5; stats on/off): max_abs_err="
          f"{max(worst.values()):.3e} (tol 1e-6 rel + 1e-6 of scale); "
          f"padding exactly 0; stats max_rel_err={worst_stats:.3e} (tol "
          f"1e-5), count exact; the bulk-copy ring and plain loads bitwise "
          f"equal at {N_CLIENTS}x{D_MAIN} and {CHUNK_MILLION}x{D_MILLION}; ok")
    return worst


def _wire_inputs(torch, dev, total, seed):
    """50 x 175,104 gradients, fading, SR uniforms and a residual carry,
    the padding tail zero as the round's slab has it."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    grads = torch.randn(N_CLIENTS, D_MAIN, generator=gen, device=dev)
    h = 0.5 + torch.rand(N_CLIENTS, generator=gen, device=dev)
    r = torch.rand(D_MAIN, generator=gen, device=dev)
    ef = 0.01 * torch.randn(D_MAIN, generator=gen, device=dev)
    grads[:, total:], ef[total:] = 0.0, 0.0
    return grads, h, r, ef


def _check_transmit(torch, got, want, x, what):
    """Payload equal on >= 99.9 % of entries and within one step on the
    rest; scales within 1e-6 rel + 1e-6 of their largest; the residual
    within 1e-6 rel + 1e-6 of max|x| where the payloads agree, and where
    an entry flipped within one step plus that tolerance plus |q| times
    its scale's own error (x - q s moves by |q| |ds| when s moves by
    ds). Returns the largest error."""
    q, s = got[0].float(), got[1]
    qw, sw = want[0].float(), want[1]
    same = q == qw
    check(float(same.float().mean()) >= 0.999, f"{what}: payload equal on "
          f"{float(same.float().mean()):.5f} of entries")
    check(bool(torch.all((q - qw).abs() <= 1.0)), f"{what}: payload off "
          "by more than one step")
    err_s = (s - sw).abs()
    check(bool(torch.all(err_s <= 1e-6 * sw.abs() + 1e-6 * float(
        sw.abs().max()))), f"{what}: scales err {float(err_s.max())}")
    worst = float(err_s.max())
    if len(got) == 3:
        err = (got[2] - want[2]).abs()
        tol = 1e-6 * want[2].abs() + 1e-6 * float(x.abs().max())
        step = sw.repeat_interleave(128)
        flip_tol = step + tol + q.abs() * err_s.repeat_interleave(128)
        check(bool(torch.all(torch.where(same, err <= tol,
                                         err <= flip_tol))),
              f"{what}: residual err {float(err.max())}")
        worst = max(worst, float(torch.where(same, err,
                                             torch.zeros_like(err)).max()))
    return worst, int((~same).sum())


def phase_kernel_transmit(torch, dev, total):
    from repro_torch.kernels.ota_channel import ota_transmit_slab
    from repro_torch.kernels.ref import ota_transmit_ref

    grads, h, r, ef = _wire_inputs(torch, dev, total, 4)
    worst, flips, cases = 0.0, 0, 0
    modes = [("int8", True, False), ("int8", False, False),
             ("sign", False, False), ("sign", False, True)]
    for qmode, stochastic, zero_fold in modes:
        for use_ef in (False, True):
            kw = dict(quantize=True, r=r if stochastic else None,
                      stochastic=stochastic, qmode=qmode, zero_fold=zero_fold,
                      ef=ef if use_ef else None, return_residual=use_ef)
            got = ota_transmit_slab(grads, h, **kw)
            want = ota_transmit_ref(grads, h, **kw)
            x = ota_transmit_ref(grads, h) + (ef if use_ef else 0.0)
            torch.cuda.synchronize()
            what = f"ota_transmit_slab {qmode} sr={stochastic} " \
                   f"fold={zero_fold} ef={use_ef}"
            w, f = _check_transmit(torch, got, want, x, what)
            worst, flips, cases = max(worst, w), flips + f, cases + 1
            check(bool(torch.all(got[0][total:] == (1 if zero_fold else 0))),
                  f"{what}: padding payload")
            if use_ef and not zero_fold:
                # (under fold the round re-masks the tail afterwards)
                check(bool(torch.all(got[2][total:] == 0.0)),
                      f"{what}: padding residual")
    # In-kernel Philox rounding: another uniform stream, so held to one
    # step of x/s on every entry and to zero bias over the slab.
    x = ota_transmit_ref(grads, h) + ef
    q, s, res = ota_transmit_slab(grads, h, quantize=True, sr_seed=12345,
                                  ef=ef, return_residual=True)
    torch.cuda.synchronize()
    sb = s.repeat_interleave(128)
    y = x / sb
    dev_steps = (q.float() - y)[:total]
    check(bool(torch.all(dev_steps.abs() < 1.0 + 1e-5)),
          f"in-kernel SR: {float(dev_steps.abs().max())} steps from x/s")
    frac = (y - torch.floor(y))[:total].double()
    se = float(torch.sqrt((frac * (1 - frac)).sum())) / total
    bias = float(dev_steps.double().mean())
    check(abs(bias) <= 3 * se, f"in-kernel SR bias {bias} vs 3 se "
          f"{3 * se}")
    check(bool(torch.all((res - (x - q.float() * sb)).abs()
                         <= 1e-6 * x.abs().max())), "in-kernel SR residual")
    check(bool(torch.all(q[total:] == 0)), "in-kernel SR padding")
    print(f"[kernel ota_transmit_slab] N={N_CLIENTS} d={D_MAIN} {cases} cases "
          f"(int8 SR/RTN, sign, sign fold x EF on/off): scales and residual "
          f"max_abs_err={worst:.3e} (tol 1e-6 rel + 1e-6 of scale); payload "
          f"entries one step apart: {flips} of {cases * D_MAIN} (tol 0.1 %); "
          f"padding exact; in-kernel SR within one step, mean (q - x/s) = "
          f"{bias:.3e} vs 3 se {3 * se:.3e}; ok")
    _check_transmit_composition(torch, dev, grads, h, r, ef)
    return worst


def _check_transmit_composition(torch, dev, grads, h, r, ef):
    """The kernel's output against the plain quantizer applied to its own
    sum: x = the accumulating transmit's no-carry call + ef, and
    ota_transmit_ref(x[None], 1, n_total=1) must give the kernel's int8
    payload, scales and residual (host rounding, RTN) and its sign
    payload bit for bit; the sign scales and residuals within 1e-6 rel +
    1e-6 of scale (the warp sums |x| in another order than torch.mean).
    At 50 x 175,104, at 1 x 175,104 as the streamed finish calls it
    (h = 1, n_total = 1), and at 7 x 640 (a last tile of one
    quantization block)."""
    from repro_torch.kernels.ota_channel import ota_transmit_slab
    from repro_torch.kernels.ref import ota_transmit_ref

    one = torch.ones(1, device=dev)
    small = slice(D_MAIN - 640, None)     # 640 columns, the padding last
    shapes = ((f"{N_CLIENTS}x{D_MAIN}", grads, h, None, r, ef),
              (f"1x{D_MAIN}", grads[:1], one, 1, r, ef),
              ("7x640", grads[:7, small].contiguous(), h[:7], None,
               r[small].contiguous(), ef[small].contiguous()))
    modes = [("int8", True, False), ("int8", False, False),
             ("sign", False, False), ("sign", False, True)]
    worst, cases = 0.0, 0
    for shape, g, hh, n_total, rr, ee in shapes:
        x = ota_transmit_slab(g, hh, n_total=n_total) + ee
        for qmode, stochastic, zero_fold in modes:
            sr = qmode == "int8" and stochastic
            kw = dict(quantize=True, r=rr if sr else None,
                      stochastic=stochastic, qmode=qmode,
                      zero_fold=zero_fold, return_residual=True)
            got = ota_transmit_slab(g, hh, n_total=n_total, ef=ee, **kw)
            want = ota_transmit_ref(x[None], one, n_total=1, **kw)
            torch.cuda.synchronize()
            what = (f"ota_transmit_slab {shape} {qmode} sr={stochastic} "
                    f"fold={zero_fold}: the plain quantizer on its sum")
            check(torch.equal(got[0], want[0]), f"{what}: payload differs "
                  f"on {int((got[0] != want[0]).sum())} entries")
            if qmode == "int8":
                check(torch.equal(got[1], want[1]), f"{what}: scales")
                check(torch.equal(got[2], want[2]), f"{what}: residual")
            else:
                scale = float(x.abs().max())
                for a, b, name in ((got[1], want[1], "scales"),
                                   (got[2], want[2], "residual")):
                    err = (a - b).abs()
                    check(bool(torch.all(err <= 1e-6 * b.abs()
                                         + 1e-6 * scale)),
                          f"{what}: {name} err {float(err.max())}")
                    worst = max(worst, float(err.max()))
            cases += 1
    print(f"[kernel ota_transmit_slab] the plain quantizer on the kernel's "
          f"own sum (the accumulating transmit's no-carry call + ef), at "
          f"{', '.join(s[0] for s in shapes)}, {cases} cases: int8 payload, "
          f"scales and residual and the sign payload bitwise; sign scales "
          f"and residuals max_abs_err={worst:.3e} (tol 1e-6 rel + 1e-6 of "
          f"scale); ok")


def phase_kernel_receive(torch, dev, total):
    from repro_torch.core.channel import CMS_U_BOUND
    from repro_torch.kernels.ota_channel import (ota_receive_slab,
                                                 pack_sign_slab)
    from repro_torch.kernels.ref import ota_receive_ref

    gen = torch.Generator(device=dev).manual_seed(5)
    u = (2 * torch.rand(D_MAIN, generator=gen, device=dev) - 1) * CMS_U_BOUND
    e = -torch.log(torch.rand(D_MAIN, generator=gen, device=dev))
    u[total:], e[total:] = 0.0, 1.0
    worst = worst_stats = 0.0
    cases = 0
    for rows in (1, 3):
        s = torch.rand(rows, D_MAIN // 128, generator=gen, device=dev)
        q8 = torch.randint(-127, 128, (rows, D_MAIN), generator=gen,
                           device=dev, dtype=torch.int8)
        q3 = torch.randint(-1, 2, (rows, D_MAIN), generator=gen, device=dev,
                           dtype=torch.int8)
        q8[:, total:], q3[:, total:] = 0, 0
        payloads = {None: q8,
                    "fold": pack_sign_slab(torch.where(q3 < 0, -1, 1).to(
                        torch.int8)),
                    "planes": pack_sign_slab(q3, planes=True)}
        for packed, payload in payloads.items():
            for alpha in (1.2, 1.5, 2.0):
                for stats in (False, True):
                    kw = dict(alpha=alpha, scale=0.1, packed=packed,
                              pilot_stats=stats)
                    got = ota_receive_slab(payload, s, u, e, **kw)
                    want = ota_receive_ref(payload, s, u, e, **kw)
                    torch.cuda.synchronize()
                    cases += 1
                    what = f"ota_receive_slab R={rows} {packed} a={alpha}"
                    if stats:
                        (got, gs), (want, ws) = got, want
                        check(float(gs[0]) == float(ws[0]) == total,
                              f"{what}: stats count {float(gs[0])}")
                        rel = float(((gs - ws).abs()
                                     / ws.abs().clamp_min(1)).max())
                        check(rel <= 1e-5, f"{what}: stats rel err {rel}")
                        worst_stats = max(worst_stats, rel)
                    err = (got - want).abs()
                    check(bool(torch.all(err <= 1e-6 * want.abs() + 1e-6
                                         * float(want.abs().max()))),
                          f"{what}: max err {float(err.max())}")
                    if packed != "fold":
                        check(bool(torch.all(got[total:] == 0.0)),
                              f"{what}: padding not 0")
                    worst = max(worst, float(err.max()))
    print(f"[kernel ota_receive_slab] d={D_MAIN} {cases} cases (R 1/3 x int8"
          f"/fold/planes x alpha 1.2/1.5/2.0 x stats on/off): max_abs_err="
          f"{worst:.3e} (tol 1e-6 rel + 1e-6 of scale); padding exactly 0 on "
          f"int8 and planes; stats max_rel_err={worst_stats:.3e} (tol 1e-5), "
          "count exact; ok")
    return max(worst, _check_receive_grid(torch, dev, u, e, total))


def _check_receive_grid(torch, dev, u, e, total):
    """The receive kernel's grid and its statistics fold: every instance
    resident in one wave at the main path's slab (blocks an SM x SMs >=
    receive_blocks); with pilot statistics one launch (the profiler sees
    one kernel: no second launch sums the blocks' rows), the same bits in
    two runs, the ticket counter back at 0; and 640 columns (R = 1, two
    quantization blocks of padding) against the plain version. Returns
    the largest output error."""
    from repro_torch.kernels import build
    from repro_torch.kernels.ota_channel import (_PACKED, _TILE_COUNTERS,
                                                 RECEIVE_THREADS,
                                                 ota_receive_slab,
                                                 pack_sign_slab,
                                                 receive_blocks, sm_count)
    from repro_torch.kernels.ref import ota_receive_ref

    lib = build.load_library()
    sms, blocks = sm_count(dev.index), receive_blocks(D_MAIN)
    per_sm = {(p, st): lib.repro_ota_receive_blocks_per_sm(_PACKED[p], st)
              for p in _PACKED for st in (0, 1)}
    check(all(n * sms >= blocks for n in per_sm.values()),
          f"receive grid of {blocks} blocks not resident on {sms} SMs: "
          f"blocks an SM {per_sm}")
    gen = torch.Generator(device=dev).manual_seed(7)
    s = torch.rand(1, D_MAIN // 128, generator=gen, device=dev)
    q = torch.randint(-127, 128, (1, D_MAIN), generator=gen, device=dev,
                      dtype=torch.int8)
    q[:, total:] = 0
    worst = 0.0
    for packed, payload in ((None, q), ("fold", pack_sign_slab(
            torch.where(q < 0, -1, 1).to(torch.int8)))):
        kw = dict(alpha=1.5, scale=0.1, packed=packed, pilot_stats=True)
        first = ota_receive_slab(payload, s, u, e, **kw)
        n0 = ota_receive_slab.launches
        _, dev_ev = _profile_run(torch, lambda: ota_receive_slab(
            payload, s, u, e, **kw))
        names = [a.key for a in dev_ev for _ in range(a.count)]
        check(ota_receive_slab.launches == n0 + 1 and len(names) == 1
              and "ota_receive_kernel" in names[0],
              f"receive with statistics ({packed}): kernels {names}")
        again = ota_receive_slab(payload, s, u, e, **kw)
        torch.cuda.synchronize()
        check(torch.equal(first[0], again[0])
              and torch.equal(first[1], again[1]),
              f"receive with statistics ({packed}): runs differ")
        check(all(int(c.abs().sum()) == 0 for c in _TILE_COUNTERS.values()),
              "receive: ticket counter not back at 0")
    d = 640
    cols = slice(D_MAIN - d, None)
    for packed in (None, "fold", "planes"):
        q3 = torch.randint(-1, 2, (1, d), generator=gen, device=dev,
                           dtype=torch.int8)
        q3[:, d - 38:] = 0
        payload = (torch.randint(-127, 128, (1, d), generator=gen,
                                 device=dev, dtype=torch.int8)
                   if packed is None else pack_sign_slab(
                       torch.where(q3 < 0, -1, 1).to(torch.int8)
                       if packed == "fold" else q3,
                       planes=packed == "planes"))
        if packed is None:
            payload[:, d - 38:] = 0
        sd = s[:, :d // 128].contiguous()
        ud, ed = u[cols].contiguous(), e[cols].contiguous()
        kw = dict(alpha=1.5, scale=0.1, packed=packed, pilot_stats=True)
        (got, gs), (want, ws) = (ota_receive_slab(payload, sd, ud, ed, **kw),
                                 ota_receive_ref(payload, sd, ud, ed, **kw))
        torch.cuda.synchronize()
        err = (got - want).abs()
        check(bool(torch.all(err <= 1e-6 * want.abs() + 1e-6
                             * float(want.abs().max()))),
              f"ota_receive_slab 1x{d} {packed}: max err {float(err.max())}")
        rel = float(((gs - ws).abs() / ws.abs().clamp_min(1)).max())
        check(float(gs[0]) == float(ws[0]) and rel <= 1e-5,
              f"ota_receive_slab 1x{d} {packed}: stats {gs.tolist()} vs "
              f"{ws.tolist()}")
        worst = max(worst, float(err.max()))
    print(f"[kernel ota_receive_slab] grid: {blocks} blocks of "
          f"{RECEIVE_THREADS} threads at d={D_MAIN}, resident in one wave "
          f"({min(per_sm.values())}-"
          f"{max(per_sm.values())} blocks an SM x {sms} SMs); with pilot "
          f"statistics one launch (int8, fold), the same bits in two runs, "
          f"the ticket counter back at 0; 1x640 int8 / fold / planes with "
          f"statistics max_abs_err={worst:.3e} (tol 1e-6 rel + 1e-6 of "
          f"scale); ok")
    return worst


def phase_runtime_alpha(torch, dev, total):
    """The update with alpha a device tensor, and the server half of a
    tracked round with host syncs made errors."""
    from repro_torch.core.adaptive import AdaptiveConfig, slab_update_slabs
    from repro_torch.core.tail_index import effective_alpha, update_alpha_ema
    from repro_torch.kernels.adaptive_update import adaptive_update_slab
    from repro_torch.kernels.ota_channel import ota_channel_slab
    from repro_torch.kernels.ref import adaptive_update_ref

    gen = torch.Generator(device=dev).manual_seed(6)
    g, w = (torch.randn(D_MAIN, generator=gen, device=dev) for _ in range(2))
    delta = 0.1 * torch.randn(D_MAIN, generator=gen, device=dev)
    delta[::17] = 0.0
    nu = 0.01 * torch.rand(D_MAIN, generator=gen, device=dev)
    nu_max = nu + 0.01 * torch.rand(D_MAIN, generator=gen, device=dev)
    worst = 0.0
    for mode in ("adagrad", "adam", "amsgrad", "yogi"):
        for a in (1.2, 1.5, 1.83, 2.0):
            kw = dict(lr=0.01, beta1=0.9, beta2=0.3, eps=1e-8, mode=mode,
                      nu_max=nu_max if mode == "amsgrad" else None,
                      alpha=torch.tensor(a, device=dev))
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:    # the kernel reads alpha where it lies: no host sync
                got = adaptive_update_slab(g, delta, nu, w, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            want = adaptive_update_ref(g, delta, nu, w, **kw)
            torch.cuda.synchronize()
            for i, (x, y) in enumerate(zip(got, want)):
                err = (x - y).abs()
                check(bool(torch.all(err <= 1e-6 * y.abs() + 1e-6 * float(
                    y.abs().max()))), f"runtime alpha {mode} a={a} output "
                      f"{i}: max err {float(err.max())}")
                worst = max(worst, float(err.max()))
    grads, h, _, _ = _wire_inputs(torch, dev, total, 7)
    # the CMS draws of a real round: u uniform on the open half-circle,
    # e ~ Exp(1); the residual is then alpha-stable with alpha = 1.5
    u = (2 * torch.rand(D_MAIN, generator=gen, device=dev) - 1) * 1.5707
    e = -torch.log(torch.rand(D_MAIN, generator=gen, device=dev))
    u[total:], e[total:] = 0.0, 1.0
    cfg = AdaptiveConfig(optimizer="adam_ota", lr=0.01, alpha="auto")
    alpha_hat = torch.zeros((), device=dev)
    state = (delta.clone(), nu.clone())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            g_slab, stats = ota_channel_slab(grads, h, u, e, alpha=1.5,
                                             scale=0.1, pilot_stats=True)
            alpha_hat = update_alpha_ema(alpha_hat, stats, cfg.alpha_ema)
            state, w = slab_update_slabs(cfg, g_slab, state, w,
                                         alpha=effective_alpha(alpha_hat))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(abs(float(alpha_hat) - 1.5) < 0.1, f"alpha_hat {float(alpha_hat)}")
    check(bool(torch.isfinite(w).all()), "tracked update: w not finite")
    print(f"[runtime alpha] adaptive_update_slab with a device alpha, 16 "
          f"cases (4 modes x alpha 1.2/1.5/1.83/2.0), each launched under "
          f"sync_debug_mode='error': max_abs_err="
          f"{worst:.3e} (tol 1e-6 rel + 1e-6 of scale); 3 tracked server "
          f"steps (MAC + stats, EMA, update) under sync_debug_mode='error' "
          f"with no host sync, alpha_hat={float(alpha_hat):.4f}; ok")
    return worst


def _draws_spec(torch, total):
    """A one-leaf slab spec of ``total`` entries, padded as the round's."""
    from repro_torch.core.slab import make_slab_spec
    return make_slab_spec({"x": torch.empty(total, device="meta")})


def phase_kernel_draws(torch, dev, total):
    """The round's CMS draws (cms_draws_slab) against their plain version
    on two card generators seeded alike, each after the same fading draw,
    at the main path's slab (``total`` entries) and at run (b)'s: u, e
    and the tail bitwise, the offsets after the draw equal, the next
    torch.rand of each bitwise. Returns the largest |difference| (0.0:
    bitwise) by padded slab, the kernels line's max_abs_err."""
    from repro_torch.kernels.cms_draws import cms_draws_slab
    from repro_torch.kernels.ref import cms_draws_ref

    out = {}
    for d in (total, D_WIDTH):
        spec = _draws_spec(torch, d)
        gk, gr = (torch.Generator(device=dev).manual_seed(4_000_000_007 + d)
                  for _ in range(2))
        for g in (gk, gr):
            torch.rand((N_CLIENTS,), generator=g, device=dev)
        before = cms_draws_slab.launches
        u, e = cms_draws_slab(spec, gk)
        check(cms_draws_slab.launches == before + 1,
              f"cms_draws_slab {d}: {cms_draws_slab.launches - before} "
              "launches, want 1")
        ur, er = cms_draws_ref(spec, gr)
        bad_u, bad_e = int((u != ur).sum()), int((e != er).sum())
        check(bad_u == 0 and bad_e == 0, f"cms_draws_slab {d}: {bad_u} u and "
              f"{bad_e} e entries differ from the plain version")
        pad = spec.padded - spec.total
        check(bool(torch.all(u[spec.total:] == 0.0))
              and bool(torch.all(e[spec.total:] == 1.0)),
              f"cms_draws_slab {d}: the tail is not (0, 1)")
        off_k, off_r = gk.get_offset(), gr.get_offset()
        check(off_k == off_r, f"cms_draws_slab {d}: offset {off_k}, the "
              f"plain version's {off_r}")
        nxt = torch.equal(torch.rand((1000,), generator=gk, device=dev),
                          torch.rand((1000,), generator=gr, device=dev))
        check(nxt, f"cms_draws_slab {d}: the next torch.rand differs")
        out[spec.padded] = 0.0
        print(f"[kernel] cms_draws_slab at {d:,} entries (padded "
              f"{spec.padded:,}, a tail of {pad}) against cms_draws_ref on "
              f"two generators seeded alike: u, e and the tail bitwise, "
              f"offsets {off_k} both, the next torch.rand bitwise, 1 "
              f"launch; ok")
        del u, e, ur, er
        torch.cuda.empty_cache()
    return out


def phase_reference(torch, np):
    """The round on the card against the round on the CPU (plain
    versions), same inputs and draws."""
    from repro_torch.core.adaptive import AdaptiveConfig
    from repro_torch.core.channel import OTAChannelConfig
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.fl import FLConfig, make_slab_round_step
    from repro_torch.core.slab_state import init_train_state
    from repro_torch.models.vision import logistic_regression, resnet_tiny

    rng = np.random.default_rng(0)
    cases = [("logreg", logistic_regression(16, 4), (16,), 4, 3, 1e-5),
             ("resnet_tiny(8,16)x1", resnet_tiny(
                 10, channels=(8, 16), blocks_per_stage=1), (8, 8, 3), 10, 2,
              1e-4)]
    worst = {}
    for name, model, xshape, n_classes, rounds, tol in cases:
        params = model.init(seed=1, device="cpu")
        ch, ad, fl = (OTAChannelConfig(), AdaptiveConfig(optimizer="adam_ota",
                                                         lr=0.01),
                      FLConfig(n_clients=4))
        states = {d: init_train_state(ad, params, device=d)
                  for d in ("cpu", "cuda")}
        steps = {d: make_slab_round_step(model.loss_fn, ch, ad, fl, device=d)
                 for d in states}
        draws = TorchDraws(ch, states["cpu"].spec, 4, seed=3, device="cpu")
        for t in range(rounds):
            batch = {"x": rng.normal(size=(4, 3) + xshape).astype(np.float32),
                     "y": rng.integers(0, n_classes, (4, 3)).astype(np.int64)}
            for d in states:
                states[d], _ = steps[d](states[d], draws(t), batch)
        a, b = states["cuda"].w.cpu(), states["cpu"].w
        check(bool(torch.allclose(a, b, rtol=tol, atol=tol)),
              f"{name}: card vs CPU w differ by {float((a - b).abs().max())}")
        worst[name] = float((a - b).abs().max())
    print("[reference] the round on the card vs on the CPU (plain versions),"
          " same draws: " + ", ".join(f"{k} max|dw|={v:.3e}" for k, v in
                                      worst.items())
          + " (tiers 1e-5 logreg, 1e-4 conv); ok")


def phase_reference_wire(torch, np):
    """Quantized rounds on the card against the same rounds on the CPU
    (plain versions), same draws: logistic regression, 3 rounds."""
    from repro_torch.core.adaptive import AdaptiveConfig
    from repro_torch.core.channel import OTAChannelConfig, UplinkConfig
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.fl import FLConfig, make_slab_round_step
    from repro_torch.core.slab_state import init_train_state
    from repro_torch.models.vision import logistic_regression

    rng = np.random.default_rng(1)
    model = logistic_regression(16, 4)
    params = model.init(seed=2, device="cpu")
    worst = {}
    for name, up in (("int8+EF", UplinkConfig(mode="int8",
                                              error_feedback=True)),
                     ("sign fold+EF", UplinkConfig(mode="sign",
                                                   error_feedback=True))):
        ch = OTAChannelConfig(uplink=up)
        ad = AdaptiveConfig(optimizer="adam_ota", lr=0.01)
        fl = FLConfig(n_clients=4)
        states = {d: init_train_state(ad, params, error_feedback=True,
                                      device=d) for d in ("cpu", "cuda")}
        steps = {d: make_slab_round_step(model.loss_fn, ch, ad, fl, device=d)
                 for d in states}
        draws = TorchDraws(ch, states["cpu"].spec, 4, seed=5, device="cpu")
        for t in range(3):
            batch = {"x": rng.normal(size=(4, 3, 16)).astype(np.float32),
                     "y": rng.integers(0, 4, (4, 3)).astype(np.int64)}
            for d in states:
                states[d], _ = steps[d](states[d], draws(t), batch)
        err = 0.0
        for a, b in ((states["cuda"].w, states["cpu"].w),
                     (states["cuda"].ef, states["cpu"].ef),
                     *zip(states["cuda"].opt, states["cpu"].opt)):
            a = a.cpu()
            check(bool(torch.allclose(a, b, rtol=1e-5, atol=1e-5)),
                  f"{name}: card vs CPU differ by {float((a - b).abs().max())}")
            err = max(err, float((a - b).abs().max()))
        check(float(states["cuda"].ef.abs().max()) > 0.0, f"{name}: ef zero")
        worst[name] = err
    print("[reference] quantized rounds on the card vs on the CPU (plain "
          "versions), same draws, logreg 3 rounds: "
          + ", ".join(f"{k} max|d(w, opt, ef)|={v:.3e}"
                      for k, v in worst.items()) + " (tier 1e-5); ok")


WIRE_RUNS = ("f32-auto", "int8-ef-dl8-auto", "sign-fold-ef", "int8-srk-ef")


def phase_wire_runs(torch, np, dev, counters):
    """Four runs of the main path on the wire's configurations. Every
    counter is set to 0 just before each run and read just after.
    Returns the launches over all of them and those of each run."""
    from repro_torch.core.adaptive import AdaptiveConfig
    from repro_torch.core.channel import OTAChannelConfig, UplinkConfig
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.fl import (FLConfig, make_slab_round_runner,
                                     run_rounds_slab)
    from repro_torch.core.slab_state import init_train_state
    from repro_torch.data import FederatedBatcher, synthetic_images
    from repro_torch.models.vision import resnet_tiny

    model = resnet_tiny(10)
    data = synthetic_images(3000, 32, 3, 10, seed=0)
    fl = FLConfig(n_clients=N_CLIENTS)
    configs = {
        "f32-auto": (OTAChannelConfig(), "auto",
                     {"ota_channel_slab", "adaptive_update_slab"}),
        "int8-ef-dl8-auto": (
            OTAChannelConfig(uplink=UplinkConfig(mode="int8",
                                                 error_feedback=True),
                             downlink="int8"), "auto",
            {"ota_transmit_slab", "ota_receive_slab",
             "adaptive_update_slab"}),
        "sign-fold-ef": (
            OTAChannelConfig(uplink=UplinkConfig(mode="sign",
                                                 error_feedback=True,
                                                 sign_pack="fold")), 1.5,
            {"ota_transmit_slab", "ota_receive_slab",
             "adaptive_update_slab"}),
        # the transmit kernel draws its own rounding uniforms (Philox)
        "int8-srk-ef": (
            OTAChannelConfig(uplink=UplinkConfig(mode="int8",
                                                 error_feedback=True,
                                                 sr_inkernel=True)), 1.5,
            {"ota_transmit_slab", "ota_receive_slab",
             "adaptive_update_slab"}),
    }
    totals = {c.__name__: 0 for c in counters}
    by_run = {}
    for name in WIRE_RUNS:
        ch, alpha, launched = configs[name]
        ad = AdaptiveConfig(optimizer="adam_ota", lr=0.01, alpha=alpha)
        ef = ch.uplink.error_feedback
        state = init_train_state(ad, model.init(seed=0, device=dev),
                                 error_feedback=ef, device=dev)
        run = make_slab_round_runner(model.loss_fn, ch, ad, fl, device=dev)
        draws = TorchDraws(ch, state.spec, N_CLIENTS, seed=1, device=dev)
        batcher = FederatedBatcher(data, N_CLIENTS, BATCH, seed=1)
        # one warm-up round outside the counted run
        run_rounds_slab(run, state, lambda t: draws(1000 + t), batcher, 1)
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        state, hist = run_rounds_slab(run, state, draws, batcher, ROUNDS,
                                      chunk=ROUNDS)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / ROUNDS
        counts = {c.__name__: c.launches for c in counters}
        want = {k: ROUNDS if k in launched else 0 for k in counts}
        check(counts == want, f"{name}: launches {counts}, want {want}")
        by_run[name] = counts
        for k, v in counts.items():
            totals[k] += v
        losses = [x["loss"] for x in hist]
        check(all(math.isfinite(x) for x in losses), f"{name}: losses "
              f"{losses}")
        check(bool(torch.isfinite(state.w).all()), f"{name}: w not finite")
        check(int(state.step) == ROUNDS, f"{name}: step {int(state.step)}")
        extra = ""
        if alpha == "auto":
            a_hat = float(state.alpha_hat)
            check(abs(a_hat - ch.alpha) <= 0.1, f"{name}: alpha_hat {a_hat}")
            extra += f"; alpha_hat {a_hat:.4f} (channel 1.5, tol 0.1)"
        if ef:
            check(bool(torch.isfinite(state.ef).all())
                  and float(state.ef.abs().max()) > 0.0, f"{name}: ef")
            extra += f"; max|ef| {float(state.ef.abs().max()):.3e}"
        if ch.uplink.zero_fold:
            check(bool(torch.all(state.w[state.spec.total:] == 0.0)),
                  f"{name}: w padding tail not 0")
            extra += "; w padding tail exactly 0"
        print(f"[main path] {name}: resnet_tiny full width, {N_CLIENTS} "
              f"clients x batch {BATCH}, adam_ota, {ROUNDS} rounds: losses "
              + " ".join(f"{x:.4f}" for x in losses)
              + f"; {ms:.2f} ms/round (host clock, synchronized); launches "
              f"{counts}{extra}; ok")
    return totals, by_run


def phase_main_path(torch, np, dev, counters):
    from repro_torch.core.adaptive import AdaptiveConfig
    from repro_torch.core.channel import OTAChannelConfig
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.fl import (FLConfig, make_slab_round_runner,
                                     run_rounds_slab)
    from repro_torch.core.slab_state import init_train_state
    from repro_torch.data import FederatedBatcher, synthetic_images
    from repro_torch.models.vision import resnet_tiny

    model = resnet_tiny(10)
    data = synthetic_images(3000, 32, 3, 10, seed=0)
    ch = OTAChannelConfig()
    fl = FLConfig(n_clients=N_CLIENTS)
    runs = {}
    for opt in ("adam_ota", "adagrad_ota"):
        ad = AdaptiveConfig(optimizer=opt, lr=0.01)
        state = init_train_state(ad, model.init(seed=0, device=dev),
                                 device=dev)
        check(state.spec.padded == D_MAIN, f"slab {state.spec.padded}")
        run = make_slab_round_runner(model.loss_fn, ch, ad, fl, device=dev)
        runs[opt] = (state, run, TorchDraws(ch, state.spec, N_CLIENTS,
                                            seed=0, device=dev),
                     FederatedBatcher(data, N_CLIENTS, BATCH, seed=0))
    # One warm-up round (cuDNN and vmap set-up) outside the counted run.
    state, run, draws, batcher = runs["adam_ota"]
    run_rounds_slab(run, state, draws, batcher, 1)
    torch.cuda.synchronize()

    for c in counters:
        c.launches = 0
    out = {}
    for opt, (state, run, draws, batcher) in runs.items():
        before = [c.launches for c in counters]
        t0 = time.perf_counter()
        state, hist = run_rounds_slab(run, state, draws, batcher, ROUNDS,
                                      chunk=ROUNDS)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / ROUNDS
        deltas = [c.launches - b for c, b in zip(counters, before)]
        check(deltas == [ROUNDS] * len(counters),
              f"{opt}: launches per kernel {deltas}, want {ROUNDS} each")
        losses = [h["loss"] for h in hist]
        check(all(math.isfinite(x) for x in losses), f"{opt}: losses "
              f"{losses}")
        check(bool(torch.isfinite(state.w).all()), f"{opt}: w not finite")
        check(tuple(state.w.shape) == (D_MAIN,) and int(state.step) == ROUNDS,
              f"{opt}: state shape {tuple(state.w.shape)} step "
              f"{int(state.step)}")
        out[opt] = (losses, ms)
    launches = {c.__name__: c.launches for c in counters}
    for opt, (losses, ms) in out.items():
        print(f"[main path] resnet_tiny full width (175,066 params, slab "
              f"{D_MAIN}), {N_CLIENTS} clients x batch {BATCH} of 32x32x3, "
              f"{opt}, {ROUNDS} rounds: losses "
              + " ".join(f"{x:.4f}" for x in losses)
              + f"; {ms:.2f} ms/round (host clock, synchronized)")
    print(f"[main path] launches over both runs: {launches} "
          f"(want {2 * ROUNDS} each: one per round); ok")
    return launches


def _quad_loss(p, b):
    """The JAX package's streamed benchmark loss: each client pulls w
    towards sin(phase) of its own index."""
    return (p["w"] - b["phase"].sin()).square().mean()


def _phase_batch(draws, idx):
    """A client's data is a function of its index: nothing of size N is
    ever materialised."""
    return {"phase": idx.float() * 1e-3}


def _million_rows(torch, dev):
    """The million-client path's first chunk: its 2000 x 4096 gradient
    rows (the port's vmap of the quadratic loss at a random w) and its
    fading draw."""
    from torch.func import grad, vmap

    from repro_torch.core.channel import OTAChannelConfig
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.slab import make_slab_spec

    gen = torch.Generator(device=dev).manual_seed(10)
    w = {"w": torch.randn(D_MILLION, generator=gen, device=dev)}
    idx = torch.arange(CHUNK_MILLION, device=dev)
    g = vmap(grad(_quad_loss), in_dims=(None, 0))(w, _phase_batch(None, idx))
    draws = TorchDraws(OTAChannelConfig(), make_slab_spec(w), N_MILLION,
                       seed=2, device=dev)(0)
    return g["w"].contiguous(), draws.h[:CHUNK_MILLION].contiguous()


def phase_kernel_stream(torch, dev, total):
    """The accumulating transmit (B3b; B3a through it) against its plain
    version; where the rows split across blocks (S > 1), also bitwise
    against the kernel's summation order written out in torch
    (ota_transmit_split_model) and against itself run to run; with the
    clean carry (clean=, mask=) its faded sum bitwise the same call's
    without and its clean sum bitwise the split model's clean order,
    every S; one chunk with no carry against the channel kernel."""
    from repro_torch.kernels.ota_channel import (ota_channel_slab,
                                                 ota_transmit_slab,
                                                 ota_transmit_split_model,
                                                 row_split, sm_count)
    from repro_torch.kernels.ref import ota_transmit_ref

    sms = sm_count(dev.index)
    gen = torch.Generator(device=dev).manual_seed(9)
    carry_all = (None, 1, 7, "N")
    # (n, d, padding columns, row chunks; the carry cases' only, when
    # the case is there for the split)
    shapes = [(N_CLIENTS, D_MAIN, D_MAIN - total, carry_all, False),
              (37, 4097, 38, carry_all, False),
              (CHUNK_MILLION, D_MILLION, 0, carry_all + (64, 1999), False),
              (2001, 4100, 0, (None, 64), True),
              (5, D_MILLION, 0, (None,), True),
              (2, D_MAIN, D_MAIN - total, (None, 1), True)]
    worst, cases, splits, seen, cleans = 0.0, 0, 0, [], 0
    for n, d, pad, chunks, split_only in shapes:
        if n == CHUNK_MILLION:
            grads, h = _million_rows(torch, dev)
        else:
            grads = torch.randn(n, d, generator=gen, device=dev)
            h = 0.5 + torch.rand(n, generator=gen, device=dev)
        acc = torch.randn(d, generator=gen, device=dev)
        if pad:
            grads[:, d - pad:], acc[d - pad:] = 0.0, 0.0
        kws = [] if split_only else [dict()]
        for rc in chunks:
            rc = n if rc == "N" else rc
            kws += [dict(n_total=n + 3, acc=a, row_chunk=rc)
                    for a in ((acc,) if split_only else (None, acc))]
        for kw in kws:
            n_seg = row_split(n, d, kw.get("row_chunk"),
                              kw.get("acc") is not None, sms)
            n0 = ota_transmit_slab.stream_launches
            got = ota_transmit_slab(grads, h, **kw)
            want = ota_transmit_ref(grads, h, **kw)
            torch.cuda.synchronize()
            check(ota_transmit_slab.stream_launches == n0 + 1,
                  "stream transmit did not launch its kernel")
            err = (got - want).abs()
            scale = float(want.abs().max())
            what = (f"ota_transmit_slab {n}x{d} carry="
                    f"{kw.get('acc') is not None} "
                    f"row_chunk={kw.get('row_chunk')} S={n_seg}")
            check(bool(torch.all(err <= 1e-6 * want.abs() + 1e-6 * scale)),
                  f"{what}: max err {float(err.max())} (scale {scale})")
            if pad:
                check(bool(torch.all(got[d - pad:] == 0.0)),
                      f"{what}: padding not 0")
            if n_seg > 1:
                model = ota_transmit_split_model(grads, h, n_seg=n_seg,
                                                 **kw)
                again = ota_transmit_slab(grads, h, **kw)
                torch.cuda.synchronize()
                check(torch.equal(got, model), f"{what}: differs from its "
                      f"summation order by {float((got - model).abs().max())}")
                check(torch.equal(got, again), f"{what}: differs run to run")
                splits += 1
            # the clean carry: a 0/1 mask, a random carry
            clean = torch.randn(d, generator=gen, device=dev)
            mask = (torch.rand(n, generator=gen, device=dev) < 0.5).float()
            c0 = ota_transmit_slab.clean_launches
            fused, clean_out = ota_transmit_slab(grads, h, clean=clean,
                                                 mask=mask, **kw)
            _, clean_model = ota_transmit_split_model(
                grads, h, n_seg=n_seg, clean=clean, mask=mask, **kw)
            torch.cuda.synchronize()
            check(ota_transmit_slab.clean_launches == c0 + 1,
                  f"{what}: the clean carry's launch was not counted")
            check(torch.equal(fused, got), f"{what}: the clean carry moved "
                  f"the faded sum by {float((fused - got).abs().max())}")
            check(torch.equal(clean_out, clean_model), f"{what}: clean sum "
                  f"differs from its order by "
                  f"{float((clean_out - clean_model).abs().max())}")
            cleans += 1
            worst, cases = max(worst, float(err.max())), cases + 1
            if kw.get("acc") is not None:
                seen.append(f"{n}x{d} rc={kw['row_chunk']}: S={n_seg}")
    # The kernel's two ways of reading G give the same bits: the
    # bulk-copy ring (16-byte aligned G) and plain loads (the same rows
    # 4 bytes off a 16-byte boundary).
    grads, h = _million_rows(torch, dev)
    off = torch.empty(grads.numel() + 1, device=dev)[1:].view(grads.shape)
    off.copy_(grads)
    acc = torch.randn(D_MILLION, generator=gen, device=dev)
    for a in (None, acc):
        check(torch.equal(ota_transmit_slab(grads, h, acc=a),
                          ota_transmit_slab(off, h, acc=a)),
              "the transmit kernel's load paths disagree")
    del off
    # One chunk and no carry: bitwise the channel kernel's faded sum
    # (u = 0, e = 1 synthesize no interference), at the streamed runs'
    # width (the column tiles fill the card) and at the million-client
    # chunk (they do not: the no-carry call takes one segment anyway).
    bitwise = []
    for n, d in ((N_CLIENTS, D_MAIN), (CHUNK_MILLION, D_MILLION),
                 (1, D_MILLION)):
        if n == CHUNK_MILLION:
            grads, h = _million_rows(torch, dev)
        else:
            grads = torch.randn(n, d, generator=gen, device=dev)
            h = 0.5 + torch.rand(n, generator=gen, device=dev)
        chan = ota_channel_slab(grads, h, torch.zeros(d, device=dev),
                                torch.ones(d, device=dev), alpha=1.5,
                                scale=0.0)
        kws = [dict(), dict(row_chunk=n)]
        if row_split(n, d, None, True, sms) == 1:
            kws.append(dict(acc=torch.zeros(d, device=dev)))
        for kw in kws:
            check(torch.equal(ota_transmit_slab(grads, h, **kw), chan),
                  f"one-chunk stream transmit {n}x{d} {sorted(kw)} differs "
                  f"from the channel kernel")
        bitwise.append(f"{n}x{d} ({len(kws)} calls)")
    print(f"[kernel ota_transmit_slab stream] {cases} cases (50x{D_MAIN} and "
          f"37x4097 random rows (the scalar path), {CHUNK_MILLION}x"
          f"{D_MILLION} the million-"
          f"client path's gradient rows; no carry and no row_chunk (the f32 "
          f"transmit), then row_chunk None/1/7/N (and 64, 1999 at the "
          f"million chunk) x carry absent/random, n_total = N + 3; then "
          f"with a carry 2001x4100 (a 4-column last tile, a ragged last "
          f"segment) "
          f"row_chunk None/64 and 5x{D_MILLION}, fewer rows than the grid "
          f"would like): max_abs_err={worst:.3e} (tol 1e-6 rel + 1e-6 of "
          f"scale); padding exact; the {splits} split cases bitwise their "
          f"summation order (ota_transmit_split_model) and themselves run "
          f"to run; the {cleans} cases with the clean carry (and 2x{D_MAIN}"
          f" row_chunk None/1, the few-row schedule) bitwise the faded sum "
          f"without it and the split model's clean order; the bulk-copy "
          f"ring and plain loads bitwise equal at "
          f"{CHUNK_MILLION}x{D_MILLION}; no carry bitwise the "
          f"channel kernel's faded sum at {', '.join(bitwise)}; ok")
    print(f"[kernel ota_transmit_slab stream] segments S on {sms} SMs, "
          f"the carry cases (no carry: S = 1): " + "; ".join(seen))
    return worst


def phase_reference_stream(torch, np):
    """Streamed logistic-regression rounds on the card against the same
    rounds on the CPU (plain versions), same draws."""
    from repro_torch.core.adaptive import AdaptiveConfig
    from repro_torch.core.channel import OTAChannelConfig
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.fl import FLConfig, make_slab_round_step
    from repro_torch.core.slab_state import init_train_state
    from repro_torch.models.vision import logistic_regression

    n = 10
    rng = np.random.default_rng(3)
    model = logistic_regression(16, 4)
    params = {"w": torch.from_numpy(
        0.1 * rng.normal(size=(16, 4)).astype(np.float32)),
        "b": torch.zeros(4)}
    cases = {
        "serial chunk 5": dict(client_chunk=5),
        "double-buffered chunk 5": dict(client_chunk=5, double_buffer=True),
        "ragged chunk 4": dict(client_chunk=4),
        "weighted sampled chunk 4": dict(
            client_chunk=4, sample_rate=0.5,
            client_weights=tuple(float(i + 1) for i in range(n))),
    }
    ch = OTAChannelConfig()
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.05, alpha="auto")
    batches = [{"x": rng.normal(size=(n, 3, 16)).astype(np.float32),
                "y": rng.integers(0, 4, (n, 3)).astype(np.int64)}
               for _ in range(3)]
    worst = {}
    for name, kw in cases.items():
        fl = FLConfig(n_clients=n, **kw)
        states = {d: init_train_state(ad, params, device=d)
                  for d in ("cpu", "cuda")}
        steps = {d: make_slab_round_step(model.loss_fn, ch, ad, fl, device=d)
                 for d in states}
        draws = TorchDraws(ch, states["cpu"].spec, n, seed=6, device="cpu",
                           sample_rate=fl.sample_rate)
        for t in range(3):
            for d in states:
                states[d], _ = steps[d](states[d], draws(t), batches[t])
        err = 0.0
        for a, b in ((states["cuda"].w, states["cpu"].w),
                     (states["cuda"].alpha_hat, states["cpu"].alpha_hat),
                     *zip(states["cuda"].opt, states["cpu"].opt)):
            a = a.cpu()
            check(bool(torch.allclose(a, b, rtol=1e-5, atol=1e-5)),
                  f"{name}: card vs CPU differ by {float((a - b).abs().max())}")
            err = max(err, float((a - b).abs().max()))
        worst[name] = err
    print("[reference] streamed rounds on the card vs on the CPU (plain "
          "versions), same draws, logreg 10 clients, alpha auto, 3 rounds: "
          + ", ".join(f"{k} max|d(w, opt, alpha_hat)|={v:.3e}"
                      for k, v in worst.items()) + " (tier 1e-5); ok")


def phase_stream_equals_resident(torch, np, dev):
    """chunk = N, full participation, no weights: the streamed round's
    state is bitwise the resident round's, on the same draws."""
    from repro_torch.core.adaptive import AdaptiveConfig
    from repro_torch.core.channel import OTAChannelConfig
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.fl import FLConfig, make_slab_round_step
    from repro_torch.core.slab_state import init_train_state
    from repro_torch.data import FederatedBatcher, synthetic_images
    from repro_torch.models.vision import resnet_tiny

    model = resnet_tiny(10)
    batcher = FederatedBatcher(synthetic_images(3000, 32, 3, 10, seed=0),
                               N_CLIENTS, BATCH, seed=3)
    batches = [{k: torch.as_tensor(v, device=dev)
                for k, v in batcher(t).items()} for t in range(3)]
    ch = OTAChannelConfig()
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.01)
    runs = (("resident", FLConfig(n_clients=N_CLIENTS)),
            ("resident again", FLConfig(n_clients=N_CLIENTS)),
            ("streamed", FLConfig(n_clients=N_CLIENTS,
                                  client_chunk=N_CLIENTS)))
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        states = {}
        for name, fl in runs:
            state = init_train_state(ad, model.init(seed=0, device=dev),
                                     device=dev)
            step = make_slab_round_step(model.loss_fn, ch, ad, fl, device=dev)
            draws = TorchDraws(ch, state.spec, N_CLIENTS, seed=3, device=dev)
            for t in range(3):
                state, _ = step(state, draws(t), batches[t])
            states[name] = state
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = prev

    def same(a, b):
        return (torch.equal(a.w, b.w) and torch.equal(a.alpha_hat, b.alpha_hat)
                and all(torch.equal(x, y) for x, y in zip(a.opt, b.opt)))

    check(same(states["resident"], states["resident again"]),
          "the resident round is not deterministic run to run")
    diff = float((states["streamed"].w - states["resident"].w).abs().max())
    check(same(states["streamed"], states["resident"]),
          f"streamed (chunk = N) differs from resident: max|dw| {diff}")
    print(f"[stream == resident] resnet_tiny full width, {N_CLIENTS} clients,"
          f" chunk {N_CLIENTS}, adam_ota, 3 rounds, cudnn deterministic: w, "
          f"opt and alpha_hat bitwise equal to the resident round's (and the "
          f"resident round to itself run to run); ok")


STREAM_RUNS = ("S1", "S2", "S3")
STREAM = "ota_transmit_slab(acc=)"     # the accumulating kernel's counter


def phase_streamed_runs(torch, np, dev, counters):
    """S1-S3 on ResNet-tiny at full width; every counter set to 0 just
    before each run and read just after. Then a dead round on S3's
    state under sync_debug_mode("error")."""
    from repro_torch.core.adaptive import AdaptiveConfig
    from repro_torch.core.channel import OTAChannelConfig, UplinkConfig
    from repro_torch.core.draws import RoundDraws, TorchDraws
    from repro_torch.core.fl import (FLConfig, make_slab_round_runner,
                                     make_slab_round_step, run_rounds_slab)
    from repro_torch.core.slab_state import init_train_state
    from repro_torch.data import FederatedBatcher, synthetic_images
    from repro_torch.models.vision import resnet_tiny

    model = resnet_tiny(10)
    # 10,000 images: with 3,000, Dir(0.1) over 200 clients leaves some
    # client without an example
    data = synthetic_images(10000, 32, 3, 10, seed=0)
    # --client-weights datasize: a client's weight is its shard's size
    weights = tuple(float(len(p)) for p in
                    FederatedBatcher(data, N_STREAM, BATCH, seed=2).parts)
    f32_up = OTAChannelConfig()
    int8_up = OTAChannelConfig(uplink=UplinkConfig(mode="int8",
                                                   error_feedback=True),
                               downlink="int8")
    configs = {
        "S1": (dict(client_chunk=50), f32_up,
               {STREAM: 4, "ota_channel_slab": 1, "adaptive_update_slab": 1}),
        "S2": (dict(client_chunk=50, double_buffer=True), f32_up,
               {"ota_channel_slab": 1, "adaptive_update_slab": 1}),
        "S3": (dict(client_chunk=64), int8_up,
               {STREAM: 4, "ota_transmit_slab": 1, "ota_receive_slab": 1,
                "adaptive_update_slab": 1}),
    }
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.01, alpha="auto")
    totals = {c.__name__: 0 for c in counters}
    for name in STREAM_RUNS:
        flkw, ch, per_round = configs[name]
        fl = FLConfig(n_clients=N_STREAM, sample_rate=SAMPLE_RATE,
                      client_weights=weights, **flkw)
        ef = ch.uplink.error_feedback
        state = init_train_state(ad, model.init(seed=0, device=dev),
                                 error_feedback=ef, device=dev)
        run = make_slab_round_runner(model.loss_fn, ch, ad, fl, device=dev)
        draws = TorchDraws(ch, state.spec, N_STREAM, seed=1, device=dev,
                           sample_rate=SAMPLE_RATE)
        batcher = FederatedBatcher(data, N_STREAM, BATCH, seed=2)
        # one warm-up round outside the counted run
        run_rounds_slab(run, state, lambda t: draws(1000 + t), batcher, 1)
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        state, hist = run_rounds_slab(run, state, draws, batcher,
                                      STREAM_ROUNDS, chunk=STREAM_ROUNDS)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / STREAM_ROUNDS
        counts = {c.__name__: c.launches for c in counters}
        want = {k: STREAM_ROUNDS * per_round.get(k, 0) for k in counts}
        check(counts == want, f"{name}: launches {counts}, want {want}")
        for k, v in counts.items():
            totals[k] += v
        losses = [x["loss"] for x in hist]
        parts = [int(x["n_participants"]) for x in hist]
        check(all(math.isfinite(x) for x in losses), f"{name}: losses "
              f"{losses}")
        check(all(0 < p < N_STREAM for p in parts), f"{name}: participants "
              f"{parts}")
        check(bool(torch.isfinite(state.w).all()), f"{name}: w not finite")
        a_hat = float(state.alpha_hat)
        check(abs(a_hat - ch.alpha) <= 0.1, f"{name}: alpha_hat {a_hat}")
        print(f"[streamed] {name}: resnet_tiny full width, {N_STREAM} clients"
              f" x batch {BATCH}, chunk {fl.client_chunk}"
              f"{' double-buffered' if fl.double_buffer else ' serial'}, "
              f"uplink {ch.uplink.mode}{' + EF' if ef else ''} / downlink "
              f"{ch.downlink}, sample_rate {SAMPLE_RATE}, data-size weights, "
              f"adam_ota alpha auto, {STREAM_ROUNDS} rounds: losses "
              + " ".join(f"{x:.4f}" for x in losses)
              + f"; n_participants {parts}; alpha_hat {a_hat:.4f}; "
              f"{ms:.2f} ms/round (host clock, synchronized); launches "
              f"{counts}; ok")
    # A dead round on S3's state: an all-zero mask through the draws.
    step = make_slab_round_step(model.loss_fn, ch, ad, fl, device=dev)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in batcher(99).items()}
    dead = RoundDraws(**{**draws(99).__dict__,
                         "mask": torch.zeros(N_STREAM, device=dev)})
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        new, m = step(state, dead, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(torch.equal(new.w, state.w) and torch.equal(new.ef, state.ef)
          and torch.equal(new.alpha_hat, state.alpha_hat)
          and all(torch.equal(a, b) for a, b in zip(new.opt, state.opt)),
          "dead round moved the state")
    check(int(new.step) == int(state.step) + 1, "dead round: step")
    check(float(m.n_participants) == 0.0 and math.isfinite(float(m.loss)),
          f"dead round metrics {float(m.n_participants)} {float(m.loss)}")
    print(f"[dead round] S3's state (int8 + EF, alpha auto), an all-zero "
          f"mask, under sync_debug_mode='error': w, opt, alpha_hat and ef "
          f"bitwise unchanged, step {int(state.step)} -> {int(new.step)}, "
          f"n_participants 0, loss {float(m.loss)}; ok")
    return totals


def phase_million(torch, dev, counters):
    """The million-client stream, serial and double-buffered; every
    counter set to 0 before each run and read after. One more serial
    round under sync_debug_mode("error")."""
    from repro_torch.core.adaptive import AdaptiveConfig
    from repro_torch.core.channel import OTAChannelConfig
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.fl import (FLConfig, make_slab_round_runner,
                                     make_slab_round_step, run_rounds_slab)
    from repro_torch.core.slab_state import init_train_state

    ch = OTAChannelConfig(alpha=1.5, xi_scale=0.1)
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.02, alpha=1.5)
    w0 = {"w": torch.randn(D_MILLION,
                           generator=torch.Generator().manual_seed(0))}
    rounds = 2
    chunks = N_MILLION // CHUNK_MILLION
    resident_bytes = 4 * N_MILLION * D_MILLION
    totals = {c.__name__: 0 for c in counters}
    out = {}
    for name, dbuf in (("serial", False), ("double-buffered", True)):
        fl = FLConfig(n_clients=N_MILLION, client_chunk=CHUNK_MILLION,
                      double_buffer=dbuf)
        state = init_train_state(ad, w0, device=dev)
        run = make_slab_round_runner(_quad_loss, ch, ad, fl, device=dev,
                                     batch_gen=_phase_batch)
        draws = TorchDraws(ch, state.spec, N_MILLION, seed=2, device=dev)
        # warm-up outside the counted run: the same chunk shapes over two
        # chunks of clients
        small = FLConfig(n_clients=2 * CHUNK_MILLION,
                         client_chunk=CHUNK_MILLION, double_buffer=dbuf)
        warm = make_slab_round_runner(_quad_loss, ch, ad, small, device=dev,
                                      batch_gen=_phase_batch)
        run_rounds_slab(warm, state, TorchDraws(ch, state.spec,
                                                2 * CHUNK_MILLION,
                                                device=dev),
                        lambda t: None, 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        state, hist = run_rounds_slab(run, state, draws, lambda t: None,
                                      rounds, chunk=rounds)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / rounds
        peak = torch.cuda.max_memory_allocated(dev)
        counts = {c.__name__: c.launches for c in counters}
        want = {k: 0 for k in counts}
        want.update({"ota_channel_slab": rounds,
                     "adaptive_update_slab": rounds,
                     STREAM: 0 if dbuf else rounds * chunks})
        check(counts == want, f"million {name}: launches {counts}, want "
              f"{want}")
        for k, v in counts.items():
            totals[k] += v
        losses = [x["loss"] for x in hist]
        check(all(math.isfinite(x) for x in losses), f"million {name}: "
              f"losses {losses}")
        check(bool(torch.isfinite(state.w).all()) and int(state.step) ==
              rounds, f"million {name}: state")
        check(all(x["n_participants"] == N_MILLION for x in hist),
              f"million {name}: participants")
        out[name] = state
        print(f"[million] {name}: {N_MILLION} clients, d={D_MILLION}, chunk "
              f"{CHUNK_MILLION} ({chunks} chunks a round), adam_ota lr 0.02 "
              f"alpha 1.5 xi_scale 0.1, {rounds} rounds: losses "
              + " ".join(f"{x:.6f}" for x in losses)
              + f"; {1e3 * sec:.1f} ms/round, {N_MILLION / sec:.0f} clients/s "
              f"(host clock, synchronized); peak memory allocated "
              f"{peak / 1e9:.3f} GB ({(peak - base) / 1e9:.3f} GB above the "
              f"state) vs {resident_bytes / 1e9:.1f} GB for a resident "
              f"({N_MILLION}, {D_MILLION}) f32 stack; launches {counts}; ok")
    dw = float((out["serial"].w - out["double-buffered"].w).abs().max())
    check(dw <= 1e-5, f"million: serial vs double-buffered max|dw| {dw}")
    # one more serial round with host syncs made errors
    fl = FLConfig(n_clients=N_MILLION, client_chunk=CHUNK_MILLION)
    step = make_slab_round_step(_quad_loss, ch, ad, fl, device=dev,
                                batch_gen=_phase_batch)
    state = out["serial"]
    d = TorchDraws(ch, state.spec, N_MILLION, seed=2, device=dev)(rounds)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = step(state, d, None)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(math.isfinite(float(m.loss)) and int(state.step) == rounds + 1,
          "million: sync-checked round")
    print(f"[million] serial vs double-buffered after {rounds} rounds: "
          f"max|dw|={dw:.3e} (tier 1e-5: the fold reassociates each chunk's "
          f"sum); one more serial round ({chunks} chunks, the finish, the "
          f"update) under sync_debug_mode='error' with no host sync; ok")
    # one more round of the same step, on its own under torch.profiler:
    # the card time of its transmits (they hide under the host clock)
    from repro_torch.kernels.ota_channel import ota_transmit_slab
    d = TorchDraws(ch, state.spec, N_MILLION, seed=2, device=dev)(rounds + 1)
    ota_transmit_slab.stream_launches = 0
    wall_ms, dev_ev = _profile_run(torch, lambda: step(state, d, None))
    tx = [a for a in dev_ev if "ota_transmit_stream" in a.key]
    tx_n = sum(a.count for a in tx)
    check(ota_transmit_slab.stream_launches == chunks and tx_n == chunks,
          f"million profiled round: {ota_transmit_slab.stream_launches} "
          f"transmit launches counted, {tx_n} seen by the profiler, want "
          f"{chunks}")
    busy_ms = sum(a.self_device_time_total for a in dev_ev) / 1e3
    tx_ms = sum(a.self_device_time_total for a in tx) / 1e3
    check(tx_ms > 0, "million profiled round: no transmit card time")
    print(f"[million] one more serial round ({chunks} chunks) under "
          f"torch.profiler: host clock {wall_ms:.1f} ms (under the "
          f"profiler), card busy {busy_ms:.2f} ms; the accumulating "
          f"transmit {tx_ms:.3f} ms of card time over {tx_n} launches "
          f"({1e3 * tx_ms / tx_n:.2f} us each, {tx_ms / busy_ms:.1%} of "
          f"busy); ok")
    return totals


ROUND_API_OPTIMIZERS = ("adagrad_ota", "adam_ota", "amsgrad_ota",
                        "yogi_ota", "fedavgm", "fedavg")
CKPT_ROUNDS, CKPT_AT = 6, 3


def _state_bitwise(torch, a, b) -> bool:
    """Two SlabTrainStates hold the same bits in every slot."""
    same_ef = (a.ef is None and b.ef is None) or (
        a.ef is not None and b.ef is not None and torch.equal(a.ef, b.ef))
    return (torch.equal(a.step, b.step) and torch.equal(a.w, b.w)
            and len(a.opt) == len(b.opt)
            and all(torch.equal(x, y) for x, y in zip(a.opt, b.opt))
            and torch.equal(a.alpha_hat, b.alpha_hat) and same_ef)


def phase_round_api(torch, np, dev, counters):
    """The per-round pytree API (init_server + make_round_step +
    run_rounds) at full width: each optimizer on the f32 uplink, then
    adam_ota on the int8 uplink, 5 rounds each, beside the resident
    runner (make_slab_round_runner + run_rounds_slab) on the same draws
    and batches; every counter set to 0 before each run and read after.
    Both start from the same slab (the per-round API from its pytrees,
    an exact f32 round trip) and launch the same kernels on the same
    inputs, so their final states must agree bitwise. Then the
    quickstart twin on the card. Returns the launches of all the
    counted runs."""
    import importlib.util

    from repro_torch.core.adaptive import AdaptiveConfig
    from repro_torch.core.channel import OTAChannelConfig, UplinkConfig
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.fl import (FLConfig, init_server, make_round_step,
                                     make_slab_round_runner, run_rounds,
                                     run_rounds_slab)
    from repro_torch.core.slab_state import (init_train_state,
                                             pack_train_state,
                                             unpack_train_state)
    from repro_torch.data import FederatedBatcher, synthetic_images
    from repro_torch.models.vision import resnet_tiny

    model = resnet_tiny(10)
    batcher = FederatedBatcher(synthetic_images(3000, 32, 3, 10, seed=0),
                               N_CLIENTS, BATCH, seed=4)
    # keyed by the absolute round, as both loops take them
    batches = [batcher(t) for t in range(ROUNDS)]
    fl = FLConfig(n_clients=N_CLIENTS)
    f32 = OTAChannelConfig()
    int8 = OTAChannelConfig(uplink=UplinkConfig(mode="int8"))
    runs = [(opt, "f32", f32) for opt in ROUND_API_OPTIMIZERS]
    runs.append(("adam_ota", "int8", int8))
    kernels = {"f32": {"ota_channel_slab", "adaptive_update_slab"},
               "int8": {"ota_transmit_slab", "ota_receive_slab",
                        "adaptive_update_slab"}}
    totals = {c.__name__: 0 for c in counters}

    def counted(fn, wire, what):
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / ROUNDS
        counts = {c.__name__: c.launches for c in counters}
        want = {k: ROUNDS if k in kernels[wire] else 0 for k in counts}
        check(counts == want, f"{what}: launches {counts}, want {want}")
        for k, v in counts.items():
            totals[k] += v
        return out, ms

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for opt, wire, ch in runs:
            what = f"round API {opt} {wire}"
            ad = AdaptiveConfig(optimizer=opt, lr=0.01)
            state0 = init_train_state(ad, model.init(seed=0, device=dev),
                                      device=dev)
            draws = TorchDraws(ch, state0.spec, N_CLIENTS, seed=5,
                               device=dev)
            step = make_round_step(model.loss_fn, ch, ad, fl, device=dev)
            runner = make_slab_round_runner(model.loss_fn, ch, ad, fl,
                                            device=dev)
            params, _ = unpack_train_state(ad, state0)
            opt_state = init_server(params, ad)
            # one warm-up round of each outside the counted runs
            run_rounds(step, params, opt_state, lambda t: draws(1000 + t),
                       batches.__getitem__, 1)
            run_rounds_slab(runner, state0, lambda t: draws(1000 + t),
                            batches.__getitem__, 1)
            torch.cuda.synchronize()
            (params, opt_state, hist), ms_api = counted(
                lambda: run_rounds(step, params, opt_state, draws,
                                   batches.__getitem__, ROUNDS), wire, what)
            (state, rhist), ms_res = counted(
                lambda: run_rounds_slab(runner, state0, draws,
                                        batches.__getitem__, ROUNDS,
                                        chunk=ROUNDS), wire,
                f"resident {opt} {wire}")
            packed = pack_train_state(ad, state.spec, params, opt_state)
            check(_state_bitwise(torch, packed, state),
                  f"{what}: the final state differs from the resident "
                  f"runner's: max|dw| "
                  f"{float((packed.w - state.w).abs().max())}")
            check(hist == rhist, f"{what}: history differs from the "
                  f"resident runner's")
            losses = [h["loss"] for h in hist]
            check(all(math.isfinite(x) for x in losses),
                  f"{what}: losses {losses}")
            print(f"[round API] resnet_tiny full width, {N_CLIENTS} clients "
                  f"x batch {BATCH}, {opt}, {wire} uplink, {ROUNDS} rounds: "
                  "losses " + " ".join(f"{x:.4f}" for x in losses)
                  + f"; {ms_api:.2f} ms/round (per-round API) vs "
                  f"{ms_res:.2f} (resident runner), host clock, "
                  f"synchronized; one launch a round of each of "
                  f"{sorted(kernels[wire])}; params, optimizer state and "
                  "history bitwise the resident runner's; ok")
    finally:
        torch.backends.cudnn.deterministic = prev

    path = ROOT / "examples" / "quickstart_torch.py"
    spec = importlib.util.spec_from_file_location("quickstart_torch", path)
    quickstart = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quickstart)
    accs = {}
    for opt, lr in (("adam_ota", 0.05), ("fedavgm", 0.01)):
        acc, hist = quickstart.train(opt, lr, device=dev, log_every=0)
        check(len(hist) == 60 and all(math.isfinite(h["loss"])
                                      for h in hist),
              f"quickstart {opt}: losses not finite")
        accs[opt] = acc
    print(f"[round API] quickstart twin on the card (logistic regression, "
          f"20 clients, xi_scale 0.5, 60 rounds): adam_ota acc "
          f"{accs['adam_ota']:.4f}, fedavgm acc {accs['fedavgm']:.4f}; "
          "losses finite; ok")
    return totals


def phase_checkpoint(torch, np, dev, counters):
    """Checkpoint and resume on the card: ResNet-tiny at full width,
    adam_ota, int8 uplink with error feedback, the int8 downlink and
    alpha="auto" (every slot of the state: two optimizer slabs, ef,
    alpha_hat). 6 rounds with chunk_hook writing an async checkpoint at
    round 3 (and a blocking one beside it), then the file loaded back
    onto the card and the run resumed at start_round=3: bitwise the
    uninterrupted run, and the async file's bytes the blocking file's.
    Every counter set to 0 before each run and read after. Returns the
    launches of both runs."""
    import hashlib
    import tempfile

    from repro_torch.checkpoint import (latest_round, load_slab_state,
                                        save_slab_state,
                                        wait_for_async_saves)
    from repro_torch.core.adaptive import AdaptiveConfig
    from repro_torch.core.channel import OTAChannelConfig, UplinkConfig
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.fl import (FLConfig, make_slab_round_runner,
                                     run_rounds_slab)
    from repro_torch.core.slab_state import init_train_state
    from repro_torch.data import FederatedBatcher, synthetic_images
    from repro_torch.models.vision import resnet_tiny

    model = resnet_tiny(10)
    batcher = FederatedBatcher(synthetic_images(3000, 32, 3, 10, seed=0),
                               N_CLIENTS, BATCH, seed=6)
    batches = [batcher(t) for t in range(CKPT_ROUNDS)]
    ch = OTAChannelConfig(uplink=UplinkConfig(mode="int8",
                                              error_feedback=True),
                          downlink="int8")
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.01, alpha="auto")
    runner = make_slab_round_runner(model.loss_fn, ch, ad,
                                    FLConfig(n_clients=N_CLIENTS), device=dev)
    state0 = init_train_state(ad, model.init(seed=0, device=dev),
                              error_feedback=True, device=dev)
    draws = TorchDraws(ch, state0.spec, N_CLIENTS, seed=6, device=dev)
    want_kernels = {"ota_transmit_slab", "ota_receive_slab",
                    "adaptive_update_slab"}
    totals = {c.__name__: 0 for c in counters}

    def counted(fn, rounds, what):
        for c in counters:
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {c.__name__: c.launches for c in counters}
        want = {k: rounds if k in want_kernels else 0 for k in counts}
        check(counts == want, f"{what}: launches {counts}, want {want}")
        for k, v in counts.items():
            totals[k] += v
        return out

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        run_rounds_slab(runner, state0, lambda t: draws(1000 + t),
                        batches.__getitem__, 1)     # warm-up, not counted
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            saved = {}

            def hook(t, state, history):
                if t != CKPT_AT:
                    return
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                save_slab_state(f"{tmp}/round_{t}.npz", state,
                                blocking=False)
                saved["async_ms"] = 1e3 * (time.perf_counter() - t0)
                t0 = time.perf_counter()
                save_slab_state(f"{tmp}/blocking_{t}.npz", state)
                saved["blocking_ms"] = 1e3 * (time.perf_counter() - t0)

            full, hist = counted(
                lambda: run_rounds_slab(runner, state0, draws,
                                        batches.__getitem__, CKPT_ROUNDS,
                                        chunk=CKPT_ROUNDS, align=(CKPT_AT,),
                                        chunk_hook=hook),
                CKPT_ROUNDS, "checkpoint: uninterrupted run")
            wait_for_async_saves()
            path = latest_round(tmp)
            check(path == f"{tmp}/round_{CKPT_AT}.npz",
                  f"latest_round {path}")
            digests = [hashlib.sha256(Path(p).read_bytes()).hexdigest()
                       for p in (path, f"{tmp}/blocking_{CKPT_AT}.npz")]
            check(digests[0] == digests[1],
                  "the async checkpoint's bytes differ from the blocking's")
            size = Path(path).stat().st_size
            loaded, _ = load_slab_state(path, state0.spec, device=dev)
            check(int(loaded.step) == CKPT_AT and loaded.ef is not None
                  and len(loaded.opt) == 2 and float(loaded.alpha_hat) > 0
                  and loaded.w.device == dev,
                  f"loaded state: step {int(loaded.step)}")
            resumed, rhist = counted(
                lambda: run_rounds_slab(runner, loaded, draws,
                                        batches.__getitem__, CKPT_ROUNDS,
                                        start_round=CKPT_AT),
                CKPT_ROUNDS - CKPT_AT, "checkpoint: resumed run")
    finally:
        torch.backends.cudnn.deterministic = prev
    check(_state_bitwise(torch, resumed, full),
          f"the resumed run differs from the uninterrupted one: max|dw| "
          f"{float((resumed.w - full.w).abs().max())}")
    check(rhist == hist[CKPT_AT:], "the resumed history differs")
    print(f"[checkpoint] resnet_tiny full width, {N_CLIENTS} clients, "
          f"adam_ota, int8 + EF + int8 downlink, alpha=\"auto\": "
          f"{CKPT_ROUNDS} rounds with an async save at round {CKPT_AT} "
          f"({size} bytes; {saved['async_ms']:.2f} ms host time for the "
          f"async call, {saved['blocking_ms']:.2f} ms for a blocking save), "
          f"loaded onto the card and resumed for "
          f"{CKPT_ROUNDS - CKPT_AT} rounds: w, opt, ef, alpha_hat "
          f"({float(full.alpha_hat):.4f}) and history bitwise the "
          "uninterrupted run's; the async file's bytes the blocking "
          "file's; ok")
    return totals


# --------------------------------------------------------------------------
# LM training (phases 14c-14d): the training CLI's 100m preset through
# repro_torch.launch.train.main, and StarCoder2-15B's width at depth 1
# through the calls the CLI makes.
# --------------------------------------------------------------------------

LM_ROUNDS, LM_CKPT_AT = 6, 3
# The CLI's default lr (0.02) makes the 100m preset's loss rise in both
# packages (Adam-OTA moves every coordinate by about lr a round; tests/
# test_torch_lm_train.py::test_100m_width_round_matches_jax); at 0.002 it
# falls, so the runs take that and keep every other default.
LM_LR = 0.002
LM_PARAMS = 62_928_640        # the 100m preset (8 layers, d_model 768)
D_LM = 62_928_640             # its slab (a multiple of 128 already)
LM_TOKENS = 8 * 2 * 128       # the CLI's defaults: clients x batch x seq
CMS = "cms_draws_slab"      # the round's CMS draws, one launch a round
TX, RX, UPD, CHAN = ("ota_transmit_slab", "ota_receive_slab",
                     "adaptive_update_slab", "ota_channel_slab")
# (name, flags, launches a round of each kernel)
LM_RUNS = (
    ("f32", [], {CHAN: 1, UPD: 1}),
    ("int8-ef-dl8-auto", ["--uplink", "int8", "--error-feedback",
                          "--downlink", "int8", "--track-alpha"],
     {TX: 1, RX: 1, UPD: 1}),
    ("sign-fold-ef", ["--uplink", "sign", "--sign-pack", "fold",
                      "--error-feedback"], {TX: 1, RX: 1, UPD: 1}),
    ("chunk4-sr0.5-datasize", ["--client-chunk", "4", "--sample-rate",
                               "0.5", "--client-weights", "datasize"],
     {STREAM: 2, CHAN: 1, UPD: 1}),
)
WIDTH_ARCH, WIDTH_PARAMS = "starcoder2-15b", 987_833_344
D_WIDTH = 987_833_344         # its slab (a multiple of 128 already)
# run (c): MiniCPM3-4B's full width (MLA) with its depth cut to 8 layers
C_ARCH, C_PARAMS = "minicpm3-4b", 877_455_872
D_C = 877_455_872             # its slab (a multiple of 128 already)
# runs (d) and (e): the recurrent families' full widths, RWKV-6-7B at
# depth 2 and Hymba-1.5B at depth 8 (its SSM scan saves about two
# (B, S, C, N) f32 tensors a layer and client under vmap(grad))
D_ARCH, D_PARAMS = "rwkv6-7b", 979_501_056
D_D = 979_501_056             # its slab (a multiple of 128 already)
E_ARCH, E_PARAMS = "hymba-1.5b", 492_600_000
D_E = 492_600_064             # its slab, padded to a multiple of 128
# runs (f) and (g), the cross-attention families with their embeddings
# in every batch (the stubbed vision tower's 1601 bf16 image tokens, the
# audio frontend's 1500 f32 frames): (f) Llama-3.2-Vision's width, one
# group cut to 1 cross + 1 dense layer (cross_attn_period 2; the
# published group of 1 + 4, 2.14 B parameters, needs ~98 GB at the
# server update: the old and new w, delta and nu, the f32 copy of the
# bf16 weights, the draws u and e, g and the clean mean, 11.5 slabs of
# 8.56 GB); (g) Whisper-medium at full width and depth
F_ARCH, F_PARAMS = "llama-3.2-vision-11b", 1_486_901_250
D_F = 1_486_901_376           # its slab, padded to a multiple of 128
G_ARCH, G_PARAMS = "whisper-medium", 811_579_392
D_G = 811_579_392             # its slab (a multiple of 128 already)
# (name, uplink, error feedback, launches a round)
WIDTH_RUNS = (("f32", "f32", False, {CHAN: 1, UPD: 1}),
              ("int8-ef", "int8", True, {TX: 1, RX: 1, UPD: 1}))
# run: (its tag, config changes, parameters, slab, clients, batch, wires)
WIDTH_CUTS = {
    WIDTH_ARCH: ("LM width", dict(n_layers=1), WIDTH_PARAMS, D_WIDTH, 4, 2,
                 WIDTH_RUNS),
    C_ARCH: ("LM run (c)", dict(n_layers=8), C_PARAMS, D_C, 4, 2,
             WIDTH_RUNS),
    D_ARCH: ("LM run (d)", dict(n_layers=2), D_PARAMS, D_D, 4, 2,
             WIDTH_RUNS),
    E_ARCH: ("LM run (e)", dict(n_layers=8), E_PARAMS, D_E, 4, 2,
             WIDTH_RUNS),
    # the f32 wire only: error feedback adds two 5.95 GB rows a client
    F_ARCH: ("LM run (f)", dict(n_layers=2, cross_attn_period=2), F_PARAMS,
             D_F, 2, 1, WIDTH_RUNS[:1]),
    # whole, at its config's remat (each layer recomputed in the
    # backward): without it the encoder's 24 layers keep their f32
    # scores, and 4 clients x 1 example do not fit the 80 GB
    G_ARCH: ("LM run (g)", {}, G_PARAMS, D_G, 4, 1, WIDTH_RUNS),
}
WIDTH_ROUNDS = 4


def _lm_counted(torch, counters, want_per_round, rounds, what, fn):
    """Run ``fn`` with every counter set to 0 just before and read just
    after; the launches must be ``rounds`` x ``want_per_round`` (0 for
    every other kernel, B5 among them)."""
    for c in counters:
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    counts = {c.__name__: c.launches for c in counters}
    want = {k: rounds * want_per_round.get(k, 0) for k in counts}
    check(counts == want, f"{what}: launches {counts}, want {want}")
    return out, counts


def phase_lm_train(torch, dev, counters):
    """Phase 14c: the training CLI at --preset 100m on the card through
    ``main([...])``, LM_ROUNDS rounds of each LM_RUNS wire, the counters
    set to 0 before and read after each run (B5 must stay at 0); then a
    --ckpt-dir run of LM_CKPT_AT rounds resumed to LM_ROUNDS, bitwise the
    uninterrupted f32 run. Returns the launches by run."""
    import gc
    import tempfile

    from repro_torch.configs import preset_config
    from repro_torch.launch import train

    check(preset_config("qwen3-14b", "100m").n_params() == LM_PARAMS,
          "the 100m preset's parameter count")
    base = ["--preset", "100m", "--lr", str(LM_LR), "--rounds",
            str(LM_ROUNDS), "--log-every", str(LM_CKPT_AT)]
    train.main(base[:4] + ["--rounds", "1"])      # warm-up, not counted
    out, results = {}, {}
    for name, flags, per_round in LM_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        r, out[name] = _lm_counted(torch, counters, per_round, LM_ROUNDS,
                                   f"LM train {name}",
                                   lambda: train.main(base + flags))
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        losses = [h["loss"] for h in r["history"]]
        check(len(losses) == LM_ROUNDS and all(math.isfinite(x)
                                               for x in losses)
              and losses[-1] < losses[0], f"LM train {name}: losses {losses}")
        check(bool(torch.isfinite(r["state"].w).all()),
              f"LM train {name}: w not finite")
        ms = 1e3 * r["seconds"] / LM_ROUNDS
        print(f"[LM train] 100m preset ({LM_PARAMS:,} params, bf16; 8 "
              f"clients x batch 2 x seq 128, adam_ota, lr {LM_LR}), {name}: "
              "losses "
              + " ".join(f"{x:.4f}" for x in losses)
              + f"; {ms:.2f} ms/round, {LM_TOKENS * 1e3 / ms:.0f} tokens/s "
              f"(host clock, synchronized); peak memory {peak:.2f} GB; "
              f"launches {out[name]}: "
              + ", ".join(f"{v} a round of {k}" for k, v in per_round.items())
              + f", no {FLASH}; ok")
        results[name] = r
    _profile_lm_round(torch, dev, "100m preset, f32", "qwen3-14b", "100m",
                      results["f32"]["state"], 8)
    # resume: LM_CKPT_AT rounds with a checkpoint, then --resume to the end
    full = results["f32"]
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    per_round = LM_RUNS[0][2]
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        ck = ["--ckpt-dir", tmp, "--ckpt-every", str(LM_CKPT_AT)]
        _, first = _lm_counted(
            torch, counters, per_round, LM_CKPT_AT, "LM train: first half",
            lambda: train.main(base[:4] + ["--rounds", str(LM_CKPT_AT),
                                           "--log-every", str(LM_CKPT_AT),
                                           *ck]))
        resumed, second = _lm_counted(
            torch, counters, per_round, LM_ROUNDS - LM_CKPT_AT,
            "LM train: resumed", lambda: train.main(base + ck + ["--resume"]))
    check(_state_bitwise(torch, resumed["state"], full["state"]),
          "LM train: the resumed run differs from the uninterrupted one: "
          f"max|dw| {float((resumed['state'].w - full['state'].w).abs().max())}")
    check(resumed["history"] == full["history"][LM_CKPT_AT:],
          "LM train: the resumed history differs")
    out["resume"] = {k: first[k] + second[k] for k in first}
    print(f"[LM train] 100m preset, f32: {LM_CKPT_AT} rounds with a "
          f"checkpoint, then --resume to round {LM_ROUNDS}: w, optimizer "
          "state and history bitwise the uninterrupted run's; ok")
    del results, full, resumed
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _profile_lm_round(torch, dev, what, arch, preset, state, n_clients):
    """One more f32 round of the training CLI's configuration (its
    defaults, lr LM_LR) from ``state``, under torch.profiler: the card's
    busy and idle shares. Not counted."""
    from repro_torch.configs import preset_config
    from repro_torch.core.adaptive import AdaptiveConfig
    from repro_torch.core.channel import OTAChannelConfig
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.fl import (FLConfig, make_slab_round_runner,
                                     run_rounds_slab)
    from repro_torch.launch import train
    from repro_torch.models.model import build_model

    cfg = preset_config(arch, preset)
    ch = OTAChannelConfig(alpha=1.5, xi_scale=0.05)
    ad = AdaptiveConfig(optimizer="adam_ota", lr=LM_LR, beta2=0.3)
    run = make_slab_round_runner(build_model(cfg).loss_fn, ch, ad,
                                 FLConfig(n_clients=n_clients), device=dev)
    corpus = train.client_corpus(cfg.vocab, 128, n_clients, 2, 0.5, 0)
    batch_fn = train.make_batch_fn(*corpus, batch=2, seq=128, seed=0)
    draws = TorchDraws(ch, state.spec, n_clients, seed=1, device=dev)
    t = int(state.step)
    _profile(torch, f"LM train {what}: one more round", lambda: (
        run_rounds_slab(run, state, draws, batch_fn, t + 1, chunk=1,
                        start_round=t)))


def _with_embeddings(torch, cfg, batch_fn, n, b, dev):
    """``batch_fn`` with the family's extra entries for n clients x b
    examples added, drawn on the card from a generator seeded by the
    round (the serve CLI's law: ``image_embed`` bf16, ``audio_embed``
    f32, standard normal); ``batch_fn`` itself for the other families."""
    shape = {"vlm": ("image_embed", cfg.n_img_tokens, torch.bfloat16),
             "encdec": ("audio_embed", cfg.enc_seq, torch.float32)}
    if cfg.family not in shape:
        return batch_fn
    key, rows, dtype = shape[cfg.family]

    def with_embeddings(t):
        gen = torch.Generator(device=dev).manual_seed(1000 + t)
        return {**batch_fn(t), key: torch.randn(
            (n, b, rows, cfg.d_model), generator=gen, device=dev).to(dtype)}

    return with_embeddings


def phase_lm_width(torch, dev, counters, run=WIDTH_ARCH):
    """Phases 14d, 14h, 14h' and 14k: a language model at full width with
    its depth cut (WIDTH_CUTS: run (b), StarCoder2-15B's width at depth
    1, 987.8 M parameters; run (c), MiniCPM3-4B's at depth 8, 877.5 M;
    run (d), RWKV-6-7B's at depth 2, 979.5 M; run (e), Hymba-1.5B's at
    depth 8, 492.6 M; run (f), Llama-3.2-Vision's, one group of 1 cross +
    1 dense layer, 1.49 B, with 1601 image tokens an example; run (g),
    Whisper-medium whole, 811.6 M, with 1500 frames an example), the
    cut's clients x batch x seq 128 of the CLI's corpus (plus the
    embeddings, ``_with_embeddings``), adam_ota as the CLI configures it,
    WIDTH_ROUNDS rounds of each of the cut's wires through
    make_slab_round_runner(model.loss_fn) + run_rounds_slab (one round a
    chunk: a chunk's draws are 7.9 GB a round at run (b)'s slab), the
    counters set to 0 before and read after each run. Run (b)'s int8
    round peaks near 70 GB of the card's 80: main() turns on the
    allocator's expandable segments, or the 4 GB slabs fragment the
    default pool. Returns the launches by run."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.core.adaptive import AdaptiveConfig
    from repro_torch.core.channel import OTAChannelConfig, UplinkConfig
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.fl import (FLConfig, make_slab_round_runner,
                                     run_rounds_slab)
    from repro_torch.core.slab import make_slab_spec
    from repro_torch.core.slab_state import init_train_state
    from repro_torch.launch import train
    from repro_torch.models.model import build_model

    tag, cut, n_params, d_slab, n_clients, batch, wires = WIDTH_CUTS[run]
    cfg = dataclasses.replace(get_config(run), **cut)
    check(cfg.n_params() == n_params, f"{tag}: the parameter count")
    model = build_model(cfg)
    corpus = train.client_corpus(cfg.vocab, 128, n_clients, batch, 0.5, 0)
    batch_fn = _with_embeddings(
        torch, cfg, train.make_batch_fn(*corpus, batch=batch, seq=128,
                                        seed=0), n_clients, batch, dev)
    fl = FLConfig(n_clients=n_clients)
    ad = AdaptiveConfig(optimizer="adam_ota", lr=LM_LR, beta2=0.3)
    tokens = n_clients * batch * 128
    out = {}
    for name, uplink, ef, per_round in wires:
        ch = OTAChannelConfig(xi_scale=0.05, uplink=UplinkConfig(
            mode=uplink, error_feedback=ef))
        gc.collect()
        torch.cuda.empty_cache()
        # the state is the only copy of the parameters, and the runner's
        # argument is its only reference (the round's old and new state
        # are 24 GB together at run (b); a third copy would not fit
        # beside int8)
        params = model.init(seed=0, device=dev)
        spec = make_slab_spec(params)
        check(spec.padded == d_slab, f"{tag} slab {spec.padded}")
        box = [init_train_state(ad, params, spec=spec, error_feedback=ef,
                                device=dev)]
        del params
        draws = TorchDraws(ch, spec, n_clients, seed=1, device=dev)
        runner = make_slab_round_runner(model.loss_fn, ch, ad, fl, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        stamps = [time.perf_counter()]
        (state, hist), out[name] = _lm_counted(
            torch, counters, {**per_round, CMS: 1}, WIDTH_ROUNDS,
            f"{tag} {name}",
            lambda: run_rounds_slab(
                runner, box.pop(), draws, batch_fn, WIDTH_ROUNDS, chunk=1,
                chunk_hook=lambda t, st, h: stamps.append(
                    time.perf_counter())))
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
        losses = [h["loss"] for h in hist]
        check(all(math.isfinite(x) for x in losses),
              f"{tag} {name}: losses {losses}")
        check(bool(torch.isfinite(state.w).all()) and int(state.step)
              == WIDTH_ROUNDS, f"{tag} {name}: w not finite")
        warm = statistics.median(ms[1:])
        if name == "f32":
            _profile(torch, f"{tag} {name}: one more round", lambda: (
                run_rounds_slab(runner, state, draws, batch_fn,
                                WIDTH_ROUNDS + 1, chunk=1,
                                start_round=WIDTH_ROUNDS)))
        shape = ", ".join(f"{k} {v}" for k, v in cut.items())
        extra = {"vlm": f" + {cfg.n_img_tokens} image tokens",
                 "encdec": f" + {cfg.enc_seq} frames"}.get(cfg.family, "")
        print(f"[{tag}] {run} width at {shape or 'full depth'} "
              f"({n_params:,} params, bf16; slab {d_slab:,} f32 = "
              f"{4 * d_slab / 1e9:.2f} GB), {n_clients} clients x batch "
              f"{batch} x seq 128{extra}, adam_ota, "
              f"{name}: losses " + " ".join(f"{x:.4f}" for x in losses)
              + "; ms a round " + " ".join(f"{x:.1f}" for x in ms)
              + f" (the first cold), {warm:.1f} ms warm, "
              f"{tokens * 1e3 / warm:.0f} tokens/s (host clock, "
              f"synchronized); peak memory {peak:.2f} GB; launches "
              f"{out[name]}, no {FLASH}; ok")
        del state, draws, runner, hist
        gc.collect()
        torch.cuda.empty_cache()
    return out


TIMED_ROUNDS = 3


def _timed_round(torch, dev, counters, cfg, n_clients, batch, seq, what):
    """A warm-up round and TIMED_ROUNDS timed ones of ``cfg`` on the f32
    wire (adam_ota as the CLI configures it; the CLI's corpus at ``seq``
    tokens and the family's embeddings) through make_slab_round_runner +
    run_rounds_slab, every counter set to 0 before and read after (one
    B2 and one B1 a round, no B5): (peak GB of the timed rounds, their
    median ms on the host clock, the losses)."""
    import gc

    from repro_torch.core.adaptive import AdaptiveConfig
    from repro_torch.core.channel import OTAChannelConfig
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.fl import (FLConfig, make_slab_round_runner,
                                     run_rounds_slab)
    from repro_torch.core.slab_state import init_train_state
    from repro_torch.launch import train
    from repro_torch.models.model import build_model

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(cfg)
    corpus = train.client_corpus(cfg.vocab, seq, n_clients, batch, 0.5, 0)
    batch_fn = _with_embeddings(
        torch, cfg, train.make_batch_fn(*corpus, batch=batch, seq=seq,
                                        seed=0), n_clients, batch, dev)
    ad = AdaptiveConfig(optimizer="adam_ota", lr=LM_LR, beta2=0.3)
    ch = OTAChannelConfig(xi_scale=0.05)
    box = [init_train_state(ad, model.init(seed=0, device=dev), device=dev)]
    draws = TorchDraws(ch, box[0].spec, n_clients, seed=1, device=dev)
    runner = make_slab_round_runner(model.loss_fn, ch, ad,
                                    FLConfig(n_clients=n_clients), device=dev)
    stamps = []

    def hook(t, st, h):
        stamps.append(time.perf_counter())
        if t == 1:                      # the warm-up round is done
            torch.cuda.reset_peak_memory_stats(dev)

    rounds = 1 + TIMED_ROUNDS
    (state, hist), _ = _lm_counted(
        torch, counters, {CHAN: 1, UPD: 1}, rounds, what,
        lambda: run_rounds_slab(runner, box.pop(), draws, batch_fn, rounds,
                                chunk=1, chunk_hook=hook))
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    losses = [h["loss"] for h in hist]
    check(all(math.isfinite(x) for x in losses)
          and bool(torch.isfinite(state.w).all()), f"{what}: losses {losses}")
    del state, draws, runner, hist
    gc.collect()
    torch.cuda.empty_cache()
    return peak, statistics.median(
        1e3 * (b - a) for a, b in zip(stamps, stamps[1:])), losses


TRADE_CLIENTS = 2


def phase_remat_trade(torch, dev, counters):
    """Phase 14l: what remat buys and costs at run (g)'s Whisper-medium
    whole, TRADE_CLIENTS clients x 1 example (4 do not fit without it),
    f32 wire: remat off, then on, a warm-up round and TIMED_ROUNDS timed
    each (``_timed_round``): peak memory and the median ms a round; the
    warm-up rounds' losses within 1e-6 relative (the same function on
    the same weights)."""
    import dataclasses

    from repro_torch.configs import get_config

    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(get_config(G_ARCH), remat=remat)
        out[remat] = _timed_round(torch, dev, counters, cfg, TRADE_CLIENTS,
                                  1, 128, f"remat trade, remat={remat}")
    (p0, ms0, l0), (p1, ms1, l1) = out[False], out[True]
    # the first round runs both on the same weights: the same function;
    # after it the bf16 gradients' last bits part the weights
    check(abs(l0[0] - l1[0]) <= 1e-6 * abs(l0[0]),
          f"remat trade: first losses {l0[0]} (off) vs {l1[0]} (on)")
    print(f"[remat trade] {G_ARCH} whole ({G_PARAMS:,} params, bf16), "
          f"{TRADE_CLIENTS} clients x batch 1 x seq 128 + "
          f"{get_config(G_ARCH).enc_seq} frames, f32 wire, adam_ota, the "
          f"median of {TIMED_ROUNDS} rounds after a warm-up: remat "
          f"off {p0:.2f} GB peak, {ms0:.1f} ms a round; remat on "
          f"{p1:.2f} GB, {ms1:.1f} ms ({p1 - p0:+.2f} GB, "
          f"{100 * (ms1 / ms0 - 1):+.1f} % ms); losses "
          + " ".join(f"{x:.6f}" for x in l0) + " / "
          + " ".join(f"{x:.6f}" for x in l1) + "; launches counted, no "
          f"{FLASH}; ok")
    return out


# (arch, the levers) at the smoke configs, window 8 where windowed
LEVER_CASES = (("qwen3-14b", dict(kv_chunk=8)),
               ("starcoder2-15b", dict(window=8, window_block=True)),
               ("hymba-1.5b", dict(window=8, window_block=True, kv_chunk=8,
                                   ssm_chunk=8)))


def phase_levers(torch, dev, flash_attention):
    """Phase 14m: the training forward's levers on the card, each
    LEVER_CASES smoke config in f32 with its levers and remat against the
    same model (window 8 where the case windows it) with both off, on
    the same parameters: vmap(grad_and_value(loss_fn)) over 3 clients x 2
    x 40 tokens, the losses and every gradient leaf within 1e-5 of its
    scale, no B5 launch; then the serve loop (launch.serve.generate),
    prefill + 8 greedy tokens of 2 x 40, the ids equal."""
    import dataclasses

    from torch.func import grad_and_value, vmap

    from repro_torch.configs import smoke_config
    from repro_torch.core.slab import tree_flatten
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import build_model

    gen = torch.Generator(device=dev).manual_seed(3)
    for arch, levers in LEVER_CASES:
        base = dataclasses.replace(smoke_config(arch), param_dtype="float32",
                                   **{k: v for k, v in levers.items()
                                      if k == "window"})
        on = dataclasses.replace(base, remat=True, **levers)
        off = dataclasses.replace(base, remat=False)
        params = build_model(off).init(seed=0, device=dev)
        toks = torch.randint(0, base.vocab, (3, 2, 40), generator=gen,
                             device=dev)
        res, ids = {}, {}
        for name, cfg in (("off", off), ("on", on)):
            model = build_model(cfg)
            n0 = flash_attention.launches
            res[name] = vmap(grad_and_value(model.loss_fn),
                             in_dims=(None, 0))(params, {"tokens": toks})
            torch.cuda.synchronize()
            check(flash_attention.launches == n0,
                  f"levers {arch} {name}: training launched {FLASH}")
            ids[name] = generate(model, params, toks[0], 8)["ids"]
        (g0, l0), (g1, l1) = res["off"], res["on"]
        worst = float(((l1 - l0).abs() / l0.abs()).max())
        for a, b in zip(tree_flatten(g1)[0], tree_flatten(g0)[0]):
            err = float((a - b).abs().max())
            scale = float(b.abs().max())
            check(err <= 1e-5 * scale, f"levers {arch}: gradient {err} of "
                  f"{scale}")
            worst = max(worst, err / max(scale, 1e-30))
        check(worst <= 1e-5, f"levers {arch}: losses {l1} vs {l0}")
        check(torch.equal(ids["on"], ids["off"]),
              f"levers {arch}: greedy ids differ")
        print(f"[levers] {arch} smoke config, f32, "
              + ", ".join(f"{k}={v}" for k, v in levers.items())
              + ", remat on vs all off: loss and gradients of 3 clients x 2 "
              f"x 40 within {worst:.2e} of scale (tol 1e-5), no {FLASH} in "
              "training; prefill + 8 greedy tokens: ids equal; ok")


# run (b)'s cut on one long sequence: (tokens S, window W, whether the
# blocked step must fit). The published window 4096 at S = 2W (JAX's
# condition S > 2W keeps the plain path: the same computation both ways)
# and at 3W; then the window cut to 2048 and 1024, where S > 2W takes the
# blocked branch at lengths one card can hold
LONG_CASES = ((8192, 4096, False), (12288, 4096, False), (8192, 2048, True),
              (4096, 1024, True))


def _client_step(torch, dev, counters, cfg, seq, what):
    """A warm-up and a timed client step of the round, vmap(grad_and_value(
    loss_fn)) over 1 client x 1 x ``seq`` tokens of the CLI's corpus,
    every counter set to 0 before and read after (no kernel of the port
    launches in it, B5 included): (peak GB of the timed step, its ms on
    the host clock, the two losses), or the out-of-memory error's first
    words and the peak reached."""
    import gc

    from torch.func import grad_and_value, vmap

    from repro_torch.launch import train
    from repro_torch.models.model import build_model

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(cfg)
    box = {"params": model.init(seed=0, device=dev)}
    batch_fn = train.make_batch_fn(*train.client_corpus(cfg.vocab, seq, 1, 1,
                                                        0.5, 0),
                                   batch=1, seq=seq, seed=0)
    step = vmap(grad_and_value(model.loss_fn), in_dims=(None, 0))
    ms, losses = [], []

    def two_steps():
        for t in range(2):
            batch = {k: v.to(dev) for k, v in batch_fn(t).items()}
            torch.cuda.synchronize()
            if t == 1:
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            _, loss = step(box["params"], batch)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            losses.append(float(loss[0]))

    try:
        _lm_counted(torch, counters, {}, 2, what, two_steps)
        out = (torch.cuda.max_memory_allocated(dev) / 1e9, ms[1], losses)
    except torch.cuda.OutOfMemoryError as exc:
        out = (str(exc).split(". GPU")[0] + ", at a peak of "
               f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    box.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_long_sequence(torch, dev, counters):
    """Phase 14n: StarCoder2-15B's width at depth 1 (run (b)'s cut, remat
    as published) on one long sequence. First one round at 1 client x 1
    x 8192 tokens on the f32 wire at its published window 4096
    (``_timed_round``): the card may not hold it beside the round's ~36
    GB of slabs (its out-of-memory error is printed). Then the round's
    client step alone (``_client_step``) at each LONG_CASES length and
    window, window_block off and on: peak memory and ms, or the
    out-of-memory error. Where the case says so the blocked step must
    fit; where both fit their first losses agree within the bf16 loss
    tier of the model tests, 2e-3 (the same function summed in blocks,
    the attention's output rounded to the config's bf16; bitwise at
    S <= 2W, one path)."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config

    def config(window, wb):
        return dataclasses.replace(get_config(WIDTH_ARCH), n_layers=1,
                                   window=window, window_block=wb)

    head = (f"[long sequence] {WIDTH_ARCH} width at depth 1 ({WIDTH_PARAMS:,} "
            "params), 1 client x 1 x")
    s, w = LONG_CASES[0][:2]
    try:
        r = _timed_round(torch, dev, counters, config(w, False), 1, 1, s,
                         f"long sequence round {s}")
        line = f"{r[0]:.2f} GB peak, {r[1]:.1f} ms a round"
    except torch.cuda.OutOfMemoryError as exc:
        line = (f"out of memory ({str(exc).split('. GPU')[0]}, at a peak of "
                f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB)")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{head} {s} tokens, window {w}, one round on the f32 wire: "
          f"{line}; ok")
    for s, w, must_fit in LONG_CASES:
        got = {wb: _client_step(torch, dev, counters, config(w, wb), s,
                                f"long sequence {s} window {w}, "
                                f"window_block={wb}")
               for wb in (False, True)}
        for wb, r in got.items():
            print(f"{head} {s} tokens, window {w}, the client step, "
                  f"window_block={wb}: "
                  + (f"out of memory ({r})" if isinstance(r, str) else
                     f"{r[0]:.2f} GB peak, {r[1]:.1f} ms, losses "
                     + " ".join(f"{x:.6f}" for x in r[2]) + "; launches "
                     f"counted, no {FLASH}") + "; ok")
        check(not (must_fit and isinstance(got[True], str)),
              f"long sequence {s} window {w}: window_block on out of memory")
        if not any(isinstance(r, str) for r in got.values()):
            a, b = got[False][2][0], got[True][2][0]
            check(abs(a - b) <= 2e-3 and (s > 2 * w or a == b),
                  f"long sequence {s} window {w}: losses {a} (plain) vs {b}")


FAMILY_ARCHS = ("qwen3-moe-235b-a22b", "kimi-k2-1t-a32b", "minicpm3-4b",
                "rwkv6-7b", "hymba-1.5b")
FAMILY_ROUNDS = 4
# (name, flags, launches a round of each kernel)
FAMILY_RUNS = (("f32", [], {CHAN: 1, UPD: 1}),
               ("int8-ef", ["--uplink", "int8", "--error-feedback"],
                {TX: 1, RX: 1, UPD: 1}))


def phase_families_train(torch, counters):
    """Phase 14g: the training CLI (repro_torch.launch.train.main) at
    --preset tiny for each FAMILY_ARCHS (the moe, mla, rwkv and hybrid
    families; the
    CLI's defaults otherwise: 8 clients x batch 2 x seq 128, adam_ota,
    lr 0.02), FAMILY_ROUNDS rounds on each FAMILY_RUNS wire, every
    counter (B5's among them) set to 0 before and read after each run:
    one B2 and one B1 a f32 round, one B3c, one B4 and one B1 an int8 +
    EF round, no B5 launch; the losses finite. Returns the launches by
    run."""
    from repro_torch.launch import train

    out = {}
    for arch in FAMILY_ARCHS:
        for name, flags, per_round in FAMILY_RUNS:
            what = f"train {arch} tiny {name}"
            r, out[what] = _lm_counted(
                torch, counters, per_round, FAMILY_ROUNDS, what,
                lambda: train.main(["--arch", arch, "--preset", "tiny",
                                    "--rounds", str(FAMILY_ROUNDS),
                                    "--log-every", str(FAMILY_ROUNDS)]
                                   + flags))
            losses = [h["loss"] for h in r["history"]]
            check(len(losses) == FAMILY_ROUNDS
                  and all(math.isfinite(x) for x in losses)
                  and bool(torch.isfinite(r["state"].w).all()),
                  f"{what}: losses {losses}")
            print(f"[families train] {arch} --preset tiny, {name}: losses "
                  + " ".join(f"{x:.4f}" for x in losses)
                  + f"; {1e3 * r['seconds'] / FAMILY_ROUNDS:.2f} ms/round "
                  f"(host clock); launches {out[what]}: "
                  + ", ".join(f"{v} a round of {k}"
                              for k, v in per_round.items())
                  + f", no {FLASH}; ok")
    return out


ALPHA_ROUNDS = 80


def phase_alpha_mismatch(torch, counters):
    """Phase 14i: examples/alpha_mismatch_torch.py (the twin of the JAX
    example, paper Remark 3) on the card: three AdaGrad-OTA trainings of
    ALPHA_ROUNDS rounds on a true-alpha 1.2 channel (matched, alpha 2.0,
    alpha="auto"), 20 clients, the counters set to 0 before and read
    after (one B2 and one B1 a round); its lines printed, the tracked
    alpha_hat within 0.1 of 1.2 (PERF.md section 2's tier). Returns the
    launches."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "alpha_mismatch_torch", ROOT / "examples" / "alpha_mismatch_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    r, counts = _lm_counted(
        torch, counters, {CHAN: 1, UPD: 1}, 3 * ALPHA_ROUNDS,
        "alpha mismatch", lambda: example.main(["--rounds",
                                                 str(ALPHA_ROUNDS)]))
    err = abs(r["alpha_hat"] - example.TRUE_ALPHA)
    check(err <= 0.1 and all(math.isfinite(r[k]) for k in
                             ("matched", "mismatched", "tracked")),
          f"alpha mismatch: alpha_hat {r['alpha_hat']}, losses {r}")
    print(f"[alpha mismatch] 3 x {ALPHA_ROUNDS} rounds: tracked alpha_hat "
          f"{r['alpha_hat']:.4f}, {err:.4f} from {example.TRUE_ALPHA} (tol "
          f"0.1); the verdict line above says "
          f"{'OK' if r['recovered'] else 'VIOLATED'}; launches {counts}; ok")
    return counts


# The paper's figure runs (repro_torch/experiments/paper_figs.py): the
# count benchmarks/paper_figs.py really runs (its _run binds ROUNDS at
# import) and the example twin's default.
PAPER_ROUNDS = 80
PAPER_EXAMPLE_ROUNDS = 60
# the figure tasks' slabs, padded -> total (logreg, mlp, cnn), and fig 6's
# client counts at their ends and fig 2's 50
PAPER_SLABS = {384: 330, 2816: 2762, 5248: 5234}
PAPER_CLIENTS = (2, 50, 100)
# what each figure varies, as its records name it
PAPER_VARIED = {"fig2": "optimizer", "fig5": "alpha", "fig3": "optimizer",
                "fig4": "beta2", "fig6": "n_clients", "fig7": "dir_alpha",
                "beyond_yogi": "optimizer", "fig2 cnn": "optimizer"}


def _falls(recs, key, metric) -> bool:
    """``metric`` never rises as ``key`` rises."""
    ys = [r[metric] for r in sorted(recs, key=lambda r: r[key])]
    return all(a >= b for a, b in zip(ys, ys[1:]))


def _beats_fedavgm(recs) -> bool:
    by = {r["optimizer"]: r for r in recs}
    return by["adam_ota"]["accuracy"] >= by["fedavgm"]["accuracy"]


# (figure, the paper's ordering, its check)
PAPER_ORDERINGS = (
    ("fig3", "Adam-OTA accuracy >= FedAvgM's", _beats_fedavgm),
    ("fig4", "beta2 = 0.3 lowest final_loss",
     lambda recs: min(recs, key=lambda r: r["final_loss"])["beta2"] == 0.3),
    ("fig5", "final_loss falls as alpha rises",
     lambda recs: _falls(recs, "alpha", "final_loss")),
    ("fig6", "final_loss falls as N rises",
     lambda recs: _falls(recs, "n_clients", "final_loss")),
    ("fig7", "speed_loss falls as Dir rises",
     lambda recs: _falls(recs, "dir_alpha", "speed_loss")),
    ("fig2 cnn", "Adam-OTA accuracy >= FedAvgM's", _beats_fedavgm))


def _paper_kernels(torch, dev):
    """B1 (the figures' four modes) and B2 against their plain versions
    at the figure shapes: d in PAPER_SLABS (the padding tail zero, u and e
    its fixed point), B2 at N in PAPER_CLIENTS, alpha 1.2 to 2.0. Returns
    the largest error of each, absolute and as a share of its output's
    scale."""
    from repro_torch.core.channel import CMS_U_BOUND
    from repro_torch.kernels.adaptive_update import adaptive_update_slab
    from repro_torch.kernels.ota_channel import ota_channel_slab
    from repro_torch.kernels.ref import adaptive_update_ref, ota_channel_ref

    gen = torch.Generator(device=dev).manual_seed(27)
    worst = {"B1": [0.0, 0.0], "B2": [0.0, 0.0]}
    cases = 0

    def held(kernel, got, want, what):
        err = (got - want).abs()
        scale = float(want.abs().max())
        check(bool(torch.all(err <= 1e-6 * want.abs() + 1e-6 * scale)),
              f"{what}: max err {float(err.max())} at scale {scale}")
        w = worst[kernel]
        w[0] = max(w[0], float(err.max()))
        w[1] = max(w[1], float(err.max()) / max(scale, 1e-30))

    for d, total in PAPER_SLABS.items():
        def r(scale=1.0, rows=()):
            x = scale * torch.randn(*rows, d, generator=gen, device=dev)
            x[..., total:] = 0.0
            return x
        g, w, delta, nu = r(), r(), r(0.1), r(0.01).abs()
        for mode in ("adam", "adagrad", "yogi", "momentum"):
            for alpha in (1.2, 1.5, 1.8, 2.0):
                kw = dict(lr=0.05, beta1=0.9, beta2=0.3, alpha=alpha,
                          eps=1e-8, mode=mode, nu_max=None)
                got = adaptive_update_slab(g, delta, nu, w, **kw)
                want = adaptive_update_ref(g, delta, nu, w, **kw)
                torch.cuda.synchronize()
                for i, (a, b) in enumerate(zip(got, want)):
                    held("B1", a, b, f"paper B1 d={d} {mode} a={alpha} "
                         f"output {i}")
                cases += 1
        u = (2 * torch.rand(d, generator=gen, device=dev) - 1) * CMS_U_BOUND
        e = -torch.log(torch.rand(d, generator=gen, device=dev))
        u[total:], e[total:] = 0.0, 1.0
        for n in PAPER_CLIENTS:
            grads = r(rows=(n,))
            h = 0.5 + torch.rand(n, generator=gen, device=dev)
            for alpha in (1.2, 1.5, 1.8, 2.0):
                got = ota_channel_slab(grads, h, u, e, alpha=alpha, scale=0.3)
                want = ota_channel_ref(grads, h, u, e, alpha=alpha,
                                       scale=0.3)
                torch.cuda.synchronize()
                what = f"paper B2 {n}x{d} a={alpha}"
                held("B2", got, want, what)
                check(bool(torch.all(got[total:] == 0.0)),
                      f"{what}: padding not 0")
                cases += 1
    print(f"[paper figures] kernels at the figure shapes, {cases} cases: "
          f"B1 (adam, adagrad, yogi, momentum) at d = "
          f"{'/'.join(map(str, PAPER_SLABS))} max_abs_err "
          f"{worst['B1'][0]:.3e} ({worst['B1'][1]:.3e} of scale); B2 at N = "
          f"{'/'.join(map(str, PAPER_CLIENTS))} x the same d, scale 0.3, "
          f"max_abs_err {worst['B2'][0]:.3e} ({worst['B2'][1]:.3e} of "
          "scale); alpha 1.2 / 1.5 / 1.8 / 2.0; tol 1e-6 rel + 1e-6 of "
          "scale; padding exactly 0; ok")
    return worst


def _paper_card_vs_cpu(paper_figs, dev, rounds=5):
    """One ``_run("adam_ota")`` on the card and on the CPU, on the same
    draws (made on the CPU; the round moves them to the card): the raw
    losses and the accuracy within 1e-5."""
    real_draws, real_rounds = paper_figs.TorchDraws, paper_figs.run_rounds
    losses = []

    def keep(*args):
        out = real_rounds(*args)
        losses.append([h["loss"] for h in out[2]])
        return out

    paper_figs.TorchDraws = lambda ch, spec, n, seed, device: real_draws(
        ch, spec, n, seed=seed, device="cpu")
    paper_figs.run_rounds = keep
    try:
        cpu = paper_figs._run("adam_ota", rounds=rounds, device="cpu")
        card = paper_figs._run("adam_ota", rounds=rounds, device=dev)
    finally:
        paper_figs.TorchDraws, paper_figs.run_rounds = real_draws, real_rounds
    err = max(abs(a - b) for a, b in zip(*losses))
    acc_err = abs(card["accuracy"] - cpu["accuracy"])
    check(len(losses[1]) == rounds and err <= 1e-5 and acc_err <= 1e-5,
          f"paper _run card vs CPU: losses {losses}, accuracy "
          f"{card['accuracy']} vs {cpu['accuracy']}")
    print(f"[paper figures] _run('adam_ota'), {rounds} rounds, card vs CPU "
          f"on the same draws: losses within {err:.3e}, accuracy {card['accuracy']:.4f} vs {cpu['accuracy']:.4f} (tol "
          "1e-5); ok")


def phase_paper_figs(torch, dev, counters):
    """Phase 14o: the paper's figure experiments on the card through the
    per-round API. (a) examples/paper_experiment_torch.py --skip-mismatch
    at its defaults (fig 2 and fig 5, PAPER_EXAMPLE_ROUNDS rounds; its
    assertion must hold); (b) fig3, fig4, fig6, fig7, beyond_yogi and
    fig2(task="cnn") at PAPER_ROUNDS, a line a run; every counter set to
    0 before (a) and read after (b): one B2 and one B1 a round, nothing
    else; (c) the paper's orderings, OK / VIOLATED (printed, not held);
    (e) B1 and B2 against their plain versions at the figure shapes;
    (f) a 5-round run card vs CPU on the same draws. Returns the
    launches."""
    import importlib.util

    from repro_torch.experiments import paper_figs

    t0 = time.perf_counter()
    spec = importlib.util.spec_from_file_location(
        "paper_experiment_torch",
        ROOT / "examples" / "paper_experiment_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    figs = {"fig3": paper_figs.fig3, "fig4": paper_figs.fig4,
            "fig6": paper_figs.fig6, "fig7": paper_figs.fig7,
            "beyond_yogi": paper_figs.beyond_yogi,
            "fig2 cnn": lambda: paper_figs.fig2(task="cnn")}
    for c in counters:
        c.launches = 0
    out = example.main(["--skip-mismatch"])
    recs = {"fig2": out["fig2"], "fig5": out["fig5"]}
    saved, paper_figs.ROUNDS = paper_figs.ROUNDS, PAPER_ROUNDS
    try:
        for name, fn in figs.items():
            recs[name] = fn()
    finally:
        paper_figs.ROUNDS = saved
    torch.cuda.synchronize()
    counts = {c.__name__: c.launches for c in counters}
    rounds = sum(len(r["loss_curve"]) for rs in recs.values() for r in rs)
    check(rounds == 7 * PAPER_EXAMPLE_ROUNDS + 20 * PAPER_ROUNDS,
          f"paper figures: {rounds} rounds")
    want = {k: rounds if k in (CHAN, UPD) else 0 for k in counts}
    check(counts == want, f"paper figures: launches {counts}, want {want}")
    for name, rs in recs.items():
        key = PAPER_VARIED[name]
        for r in rs:
            check(all(math.isfinite(x) for x in r["loss_curve"]),
                  f"paper {name}: losses {r['loss_curve']}")
            print(f"[paper figures] {name} ({r['task']}, "
                  f"{len(r['loss_curve'])} rounds) {key}={r[key]}: "
                  f"final_loss {r['final_loss']:.4f} speed_loss "
                  f"{r['speed_loss']:.4f} accuracy {r['accuracy']:.4f} "
                  f"us_per_round {r['us_per_round']:.1f}")
    verdicts = {}
    for name, claim, holds in PAPER_ORDERINGS:
        verdicts[name] = "OK" if holds(recs[name]) else "VIOLATED"
        print(f"[paper figures] {name}: {claim}: {verdicts[name]}")
    t_runs = time.perf_counter() - t0
    worst = _paper_kernels(torch, dev)
    _paper_card_vs_cpu(paper_figs, dev)
    print(f"[paper figures] {rounds} rounds in {len(recs)} figures "
          f"({7 * PAPER_EXAMPLE_ROUNDS} of the example at its default "
          f"{PAPER_EXAMPLE_ROUNDS}, {20 * PAPER_ROUNDS} at {PAPER_ROUNDS}) "
          f"in {t_runs:.1f} s; launches {counts}: one {CHAN} and one {UPD} "
          f"a round, no other; orderings {verdicts}; B1 / B2 max_abs_err "
          f"{worst['B1'][0]:.3e} / {worst['B2'][0]:.3e}; phase "
          f"{time.perf_counter() - t0:.1f} s on {nvidia_smi()}; ok")
    return counts


def phase_serve_example(torch, flash_attention):
    """Phase 14j: examples/serve_decode_torch.py (the twin of the JAX
    example) on the card with its defaults: rwkv6-7b at --preset tiny,
    batch 2 x prompt 32, 8 tokens greedy; its lines printed, the ids of
    the expected shape, no flash launch (RWKV has no attention)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "serve_decode_torch", ROOT / "examples" / "serve_decode_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    flash_attention.launches = 0
    r = example.main(example.launcher_argv([]))
    torch.cuda.synchronize()
    check(tuple(r["ids"].shape) == (2, 8) and r["ids"].is_cuda
          and flash_attention.launches == 0,
          f"serve_decode_torch: ids {tuple(r['ids'].shape)} on "
          f"{r['ids'].device}, {flash_attention.launches} flash launches")
    print(f"[serve example] examples/serve_decode_torch.py with its defaults "
          f"({' '.join(example.DEFAULT_ARGV)}) on the card: the lines above;"
          " no flash launch; ok")


# ---------------------------------------------------------------------------
# The sharded engine (core/shard.py) at world size 1, over NCCL.
# ---------------------------------------------------------------------------

B3A = "ota_transmit_slab f32"       # B3a: the f32 transmit with no carry
NOCARRY = "ota_transmit_slab no-carry"   # its counter
RXSTATS = "ota_receive_slab(pilot_stats)"   # B4's launches with statistics
# B3a at the shapes the sharded runs launch it (phase 14e's ResNet round,
# phase 14f's 100m CLI with its 8 clients), then two that no one-card run
# launches (a rank's rows at P = 2, run (b)'s width at P = 1): checked and
# timed, but not rows of the kernels line
B3A_PATH_SHAPES = ((N_CLIENTS, D_MAIN), (8, D_LM))
B3A_SHAPES = B3A_PATH_SHAPES + ((N_CLIENTS // 2, D_MAIN), (4, D_WIDTH))
SHARD_RUNS = ("f32", "int8-ef-dl8-auto", "sign-fold-ef", "S1")
SHARD_CLI_ROUNDS = 3


def phase_kernel_b3a(torch, dev, total):
    """B3a, the no-carry f32 transmit, against its plain version at the
    shapes of phase "times": the (1,)-mesh ResNet round (50 x 175,104,
    the slab's padding columns zero), the (1,)-mesh 100m CLI round (8 x
    62,928,640), a rank's rows at P = 2 (25 x 175,104) and run (b)'s
    width at P = 1 (4 x 987,833,344); past D_MAIN the plain version a
    2^26-column piece at a time. Each call one launch of the no-carry
    counter; tier 1e-6 of the sum's scale."""
    from repro_torch.kernels.ota_channel import ota_transmit_slab
    from repro_torch.kernels.ref import ota_transmit_ref

    gen = torch.Generator(device=dev).manual_seed(21)
    errs = {}
    for n, d in B3A_SHAPES:
        grads = torch.randn(n, d, generator=gen, device=dev)
        h = 0.5 + torch.rand(n, generator=gen, device=dev)
        if d == D_MAIN:
            grads[:, total:] = 0.0
        n0 = ota_transmit_slab.nocarry_launches
        got = ota_transmit_slab(grads, h)
        torch.cuda.synchronize()
        check(ota_transmit_slab.nocarry_launches == n0 + 1,
              f"B3a {n}x{d} did not launch its kernel")
        worst, scale, ok = 0.0, 0.0, True
        for a, b in _pieces(d):
            want = ota_transmit_ref(grads[:, a:b], h)
            err = (got[a:b] - want).abs()
            piece = float(want.abs().max())
            scale, worst = max(scale, piece), max(worst, float(err.max()))
            ok &= bool(torch.all(err <= 1e-6 * want.abs() + 1e-6 * piece))
        check(ok, f"B3a {n}x{d}: max err {worst} (scale {scale})")
        if d == D_MAIN:
            check(bool(torch.all(got[total:] == 0.0)),
                  f"B3a {n}x{d}: padding not 0")
        errs[f"{B3A} {n}x{d}"] = worst
        print(f"[kernel B3a] ota_transmit_slab (no carry) {n}x{d}: one "
              f"launch, max_abs_err={worst:.3e} (scale {scale:.3f}; tier "
              f"1e-6 of scale"
              + ("; padding exactly 0" if d == D_MAIN else
                 "; plain version a 2^26-column piece at a time")
              + "); ok")
        del grads, got
        torch.cuda.empty_cache()
    return errs


def _shard_configs():
    """The sharded runs: (clients, data images, channel, adaptive, fl
    keywords, launches a sharded round)."""
    from repro_torch.core.adaptive import AdaptiveConfig
    from repro_torch.core.channel import OTAChannelConfig, UplinkConfig
    adam = dict(optimizer="adam_ota", lr=0.01)
    return {
        "f32": (N_CLIENTS, OTAChannelConfig(), AdaptiveConfig(**adam), {},
                {UPD: 1, STREAM: 1, NOCARRY: 1}),
        "int8-ef-dl8-auto": (
            N_CLIENTS, OTAChannelConfig(uplink=UplinkConfig(
                mode="int8", error_feedback=True), downlink="int8"),
            AdaptiveConfig(**adam, alpha="auto"), {},
            {TX: 2, RX: 2, RXSTATS: 1, UPD: 1}),
        "sign-fold-ef": (
            N_CLIENTS, OTAChannelConfig(uplink=UplinkConfig(
                mode="sign", error_feedback=True)), AdaptiveConfig(**adam),
            {}, {TX: 2, RX: 2, UPD: 1}),
        "S1": (N_STREAM, OTAChannelConfig(),
               AdaptiveConfig(**adam, alpha="auto"),
               dict(client_chunk=50, sample_rate=SAMPLE_RATE),
               {UPD: 1, STREAM: 4}),
    }


def _sharded_runs(mesh, torch, np, dev, counters):
    """Phase 14e on this rank (the only one): each run of SHARD_RUNS, 5
    rounds from one initial state on the resident and on the sharded
    runner, in turns (resident, sharded, sharded, resident), the same
    draws and batches; the counters set to 0 just before and read just
    after each sharded run; one more sharded round under
    sync_debug_mode("error"). Returns the sharded runs' launches by run."""
    # cuDNN's convolution backward in a fixed order: runs of one
    # configuration give the same bits
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _sharded_configs(mesh, torch, np, dev, counters)
    finally:
        torch.backends.cudnn.deterministic = prev


def _sharded_configs(mesh, torch, np, dev, counters):
    from repro_torch.core import shard
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.fl import (FLConfig, make_slab_round_runner,
                                     make_slab_round_step, run_rounds_slab)
    from repro_torch.core.slab_state import init_train_state
    from repro_torch.data import FederatedBatcher, synthetic_images
    from repro_torch.models.vision import resnet_tiny

    model = resnet_tiny(10)
    data = {N_CLIENTS: synthetic_images(3000, 32, 3, 10, seed=0),
            N_STREAM: synthetic_images(10000, 32, 3, 10, seed=0)}
    weights = tuple(float(len(p)) for p in FederatedBatcher(
        data[N_STREAM], N_STREAM, BATCH, seed=2).parts)
    out = {}
    for name, (n, ch, ad, flkw, per_round) in _shard_configs().items():
        fl = FLConfig(n_clients=n, client_weights=weights if flkw else None,
                      **flkw)
        ef = ch.uplink.error_feedback
        state0 = init_train_state(ad, model.init(seed=0, device=dev),
                                  error_feedback=ef, device=dev)
        spec = state0.spec
        runners = {
            "resident": (make_slab_round_runner(model.loss_fn, ch, ad, fl,
                                                device=dev),
                         TorchDraws(ch, spec, n, seed=1, device=dev,
                                    sample_rate=fl.sample_rate)),
            "sharded": (make_slab_round_runner(model.loss_fn, ch, ad, fl,
                                               device=dev,
                                               backend="pallas_sharded",
                                               mesh=mesh),
                        TorchDraws(ch, spec, n, seed=1, device=dev,
                                   sample_rate=fl.sample_rate,
                                   shard_index=0))}
        batcher = FederatedBatcher(data[n], n, BATCH, seed=2)
        batches = [batcher(t) for t in range(ROUNDS + 1)]

        def start(which):
            return (state0 if which == "resident"
                    else shard.shard_train_state(state0, mesh))

        for which, (run, draws) in runners.items():   # warm-up rounds
            run_rounds_slab(run, start(which), lambda t: draws(1000 + t),
                            lambda t: batches[ROUNDS], 1)
        torch.cuda.synchronize()
        finals, times, counts = {}, {}, {}
        for which in ("resident", "sharded", "sharded", "resident"):
            run, draws = runners[which]
            for c in counters:
                c.launches = 0
            t0 = time.perf_counter()
            st, hist = run_rounds_slab(run, start(which), draws,
                                       lambda t: batches[t], ROUNDS,
                                       chunk=ROUNDS)
            torch.cuda.synchronize()
            times.setdefault(which, []).append(
                1e3 * (time.perf_counter() - t0) / ROUNDS)
            got = {c.__name__: c.launches for c in counters}
            if which == "sharded":
                want = {k: ROUNDS * per_round.get(k, 0) for k in got}
                check(got == want, f"sharded {name}: launches {got}, want "
                      f"{want}")
                counts = {k: counts.get(k, 0) + v for k, v in got.items()}
                st = shard.gather_train_state(st, mesh)
            losses = [h["loss"] for h in hist]
            check(all(math.isfinite(x) for x in losses),
                  f"{which} {name}: losses {losses}")
            if which in finals:
                check(_state_bitwise(torch, st, finals[which][0]),
                      f"{which} {name}: two runs differ")
            finals[which] = (st, losses)
        (a, la), (b, lb) = finals["resident"], finals["sharded"]
        if ch.uplink.quantized:
            check(_state_bitwise(torch, a, b), f"sharded {name}: state "
                  "differs from the resident runner's")
            agree = "bitwise"
        else:
            worst = _state_off(a, b)
            check(worst <= 1e-5, f"sharded {name}: state off the resident "
                  f"runner's by {worst:.3e}")
            agree = f"within {worst:.2e} (tier 1e-5)"
        # one more sharded round with no host sync
        step = make_slab_round_step(model.loss_fn, ch, ad, fl, device=dev,
                                    backend="pallas_sharded", mesh=mesh)
        st = shard.shard_train_state(b, mesh)
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in batches[ROUNDS].items()}
        d = runners["sharded"][1](ROUNDS)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            st, m = step(st, d, batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        check(math.isfinite(float(m.loss)), f"sharded {name}: synced round")
        out[name] = counts
        print(f"[sharded] resnet_tiny full width (slab {D_MAIN}), {n} "
              f"clients x batch {BATCH}, {name}"
              + (f" (chunk 50, sample_rate {SAMPLE_RATE}, data-size "
                 "weights)" if flkw else "")
              + f", {ROUNDS} rounds on the (1,)-mesh over NCCL: the state "
              f"{agree} of the resident runner's; losses sharded "
              + " ".join(f"{x:.4f}" for x in lb) + "; ms/round (host clock, "
              "synchronized) in turns resident, sharded, sharded, resident: "
              + " ".join(f"{t:.2f}" for t in (times["resident"][0],
                                              *times["sharded"],
                                              times["resident"][1]))
              + f"; launches a sharded round {per_round} (no "
              f"ota_channel_slab); one more round under "
              f"sync_debug_mode='error' with no host sync; ok")
    return out


def _state_off(a, b) -> float:
    """The largest difference of two SlabTrainStates' w, optimizer rows
    and alpha_hat, each over 1 + the second's largest magnitude."""
    return max(float((x - y).abs().max() / (1.0 + y.abs().max()))
               for x, y in zip((a.w, *a.opt, a.alpha_hat),
                               (b.w, *b.opt, b.alpha_hat)))


def phase_sharded(torch, np, dev, counters):
    """Phase 14e: the sharded engine at world size 1 over NCCL (one rank
    in this process, on a HashStore)."""
    from repro_torch.launch.mesh import run_on_mesh
    return run_on_mesh(_sharded_runs, (1,), "cuda",
                       args=(torch, np, dev, counters))


def phase_sharded_cli(torch, dev, counters):
    """Phase 14f: the training CLI at --preset 100m with --backend
    pallas_sharded --mesh 1 beside the resident CLI, SHARD_CLI_ROUNDS
    rounds each, f32 (resident first) and int8 + EF (sharded first); the
    counters set to 0 before and read after each run; the int8 state
    bitwise; the f32 state within 1e-5 of the resident CLI's (each slab
    over 1 + its largest magnitude, as phase 14e) and its losses within
    1e-5 relative. Returns the sharded runs' launches."""
    import gc

    from repro_torch.launch import train

    base = ["--preset", "100m", "--lr", str(LM_LR), "--rounds",
            str(SHARD_CLI_ROUNDS), "--log-every", str(SHARD_CLI_ROUNDS)]
    sharded = ["--backend", "pallas_sharded", "--mesh", "1"]
    runs = (("f32", [], ("resident", "sharded"),
             {CHAN: 1, UPD: 1}, {UPD: 1, STREAM: 1, NOCARRY: 1}),
            ("int8-ef", ["--uplink", "int8", "--error-feedback"],
             ("sharded", "resident"), {TX: 1, RX: 1, UPD: 1},
             {TX: 2, RX: 2, UPD: 1}))
    out = {}
    for name, flags, order, want_res, want_sh in runs:
        res = {}
        for which in order:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            argv = base + flags + (sharded if which == "sharded" else [])
            r, counts = _lm_counted(
                torch, counters,
                want_sh if which == "sharded" else want_res,
                SHARD_CLI_ROUNDS, f"sharded CLI {name} {which}",
                lambda: train.main(argv))
            peak = torch.cuda.max_memory_allocated(dev) / 1e9
            ms = 1e3 * r["seconds"] / SHARD_CLI_ROUNDS
            res[which] = (r, ms, peak)
            if which == "sharded":
                out[name] = counts
        (ra, ms_a, pk_a), (rb, ms_b, pk_b) = res["resident"], res["sharded"]
        la = [h["loss"] for h in ra["history"]]
        lb = [h["loss"] for h in rb["history"]]
        check(all(math.isfinite(x) for x in la + lb), f"sharded CLI {name}: "
              f"losses {la} {lb}")
        rel = max(abs(x - y) / abs(y) for x, y in zip(lb, la))
        if name == "f32":
            check(rel <= 1e-5, f"sharded CLI f32: losses {lb} vs {la}")
            off = _state_off(rb["state"], ra["state"])
            check(off <= 1e-5, f"sharded CLI f32: state off the resident "
                  f"CLI's by {off:.3e}")
            same = _state_bitwise(torch, ra["state"], rb["state"])
            agree = (f"losses within {rel:.2e} relative of the resident "
                     f"CLI's, the state "
                     + ("bitwise" if same else f"within {off:.2e}")
                     + " of its state (tier 1e-5)")
        else:
            check(_state_bitwise(torch, ra["state"], rb["state"]),
                  "sharded CLI int8-ef: state differs from the resident's")
            agree = "state bitwise the resident CLI's"
        print(f"[sharded CLI] 100m preset ({LM_PARAMS:,} params), {name}, "
              f"{SHARD_CLI_ROUNDS} rounds, --backend pallas_sharded --mesh 1 "
              f"(run {order.index('sharded') + 1} of 2) beside the resident "
              f"CLI: {agree}; ms/round sharded {ms_b:.2f} vs resident "
              f"{ms_a:.2f} (host clock, synchronized, the first round and "
              f"the sharded run's NCCL set-up included), tokens/s "
              f"{LM_TOKENS * 1e3 / ms_b:.0f} vs {LM_TOKENS * 1e3 / ms_a:.0f}, "
              f"peak memory {pk_b:.2f} vs {pk_a:.2f} GB; launches a sharded "
              f"round {want_sh}; ok")
        del res, ra, rb
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _b3a_times(torch, dev, gen, flush):
    """B3a's times at B3A_SHAPES: the kernel, its plain version and
    torch.addmv computing the same h^T G / n (one cuBLAS GEMV, the
    yardstick, never called by the port); bytes (n d + n + d) x 4, 2 n d
    + d operations. Returns the rows and the library times by name."""
    from repro_torch.kernels.ota_channel import ota_transmit_slab
    from repro_torch.kernels.ref import ota_transmit_ref

    rows, library = {}, {}
    for n, d in B3A_SHAPES:
        name = f"{B3A} {n}x{d}"
        gs = torch.randn(n, d, generator=gen, device=dev)
        hs = torch.rand(n, generator=gen, device=dev)
        zero = torch.zeros(d, device=dev)
        ms = _median_ms(torch, lambda: ota_transmit_slab(gs, hs), flush)
        plain_ms = _median_ms(torch, lambda: ota_transmit_ref(gs, hs), flush)
        lib_ms = _median_ms(torch, lambda: torch.addmv(
            zero, gs.t(), hs, beta=0.0, alpha=1.0 / n), flush)
        diff = float((torch.addmv(zero, gs.t(), hs, beta=0.0, alpha=1.0 / n)
                      - ota_transmit_slab(gs, hs)).abs().max())
        rows[name] = (ms, plain_ms, 4 * (n * d + n + d), 2 * n * d + d)
        library[name] = ("torch.addmv", lib_ms)
        print(f"[times] {name}: {ms / lib_ms:.3f} x torch.addmv's time, "
              f"which differs from the kernel by {diff:.3e} at most")
        del gs, zero
        torch.cuda.empty_cache()
    return rows, library


def _slabs_within(torch, a_state, b_state, share, everywhere, what):
    """The state slabs of two runs: within 1e-5 + 1e-5 |x| on all but
    ``share`` of the entries, within ``everywhere`` on all, mean error at
    most 1e-6 (the tiers of tests/test_torch_lm_train.py). Returns the
    largest error."""
    slabs = [("w", a_state.w, b_state.w)]
    slabs += [(f"opt[{i}]", a, b) for i, (a, b) in
              enumerate(zip(a_state.opt, b_state.opt))]
    if b_state.ef is not None:
        slabs.append(("ef", a_state.ef, b_state.ef))
    worst = 0.0
    for name, a, b in slabs:
        a, b = a.cpu().float(), b.cpu().float()
        diff = (a - b).abs()
        off = int((diff > 1e-5 + 1e-5 * b.abs()).sum())
        check(off <= share * diff.numel() and float(diff.max()) <= everywhere
              and float(diff.mean()) <= 1e-6,
              f"{what} {name}: {off} entries off, max {float(diff.max())}, "
              f"mean {float(diff.mean())}")
        worst = max(worst, float(diff.max()))
    return worst


def phase_reference_lm(torch, dev):
    """The tiny preset in f32 (the CLI's corpus, 4 clients x batch 2 x
    seq 32, adam_ota), 3 rounds through make_slab_round_runner on the
    card and on the CPU, same parameters, batches and draws: the losses
    within 1e-5, the state slabs within the tiers of
    tests/test_torch_lm_train.py (the gradients differ in their last bits
    and Adam-OTA's normalised update amplifies them on small
    coordinates): the f32 wire within 1e-5 on all but 1e-4 of entries
    and 1e-4 everywhere; int8 + EF on all but 1e-3 and 2 lr R."""
    import dataclasses

    from repro_torch.configs import preset_config
    from repro_torch.core.adaptive import AdaptiveConfig
    from repro_torch.core.channel import OTAChannelConfig, UplinkConfig
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.fl import (FLConfig, make_slab_round_runner,
                                     run_rounds_slab)
    from repro_torch.core.slab import make_slab_spec, tree_map
    from repro_torch.core.slab_state import init_train_state
    from repro_torch.launch import train
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(preset_config("qwen3-14b", "tiny"),
                              param_dtype="float32")
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    spec = make_slab_spec(params)
    corpus = train.client_corpus(cfg.vocab, 32, 4, 2, 0.5, 0)
    batch_fn = train.make_batch_fn(*corpus, batch=2, seq=32, seed=0)
    ad = AdaptiveConfig(optimizer="adam_ota", lr=0.02, beta2=0.3)
    fl = FLConfig(n_clients=4)
    rounds, worst, worst_loss = 3, 0.0, 0.0
    for name, ch, share, everywhere in (
            ("f32", OTAChannelConfig(xi_scale=0.05), 1e-4, 1e-4),
            ("int8-ef", OTAChannelConfig(xi_scale=0.05, uplink=UplinkConfig(
                mode="int8", error_feedback=True)), 1e-3, 2 * 0.02 * rounds)):
        ef = ch.uplink.error_feedback
        draws = TorchDraws(ch, spec, 4, seed=1, device="cpu")
        finals = []
        for where, p in (("cpu", params),
                         (dev, tree_map(lambda t: t.to(dev), params))):
            run = make_slab_round_runner(model.loss_fn, ch, ad, fl,
                                         device=where)
            state = init_train_state(ad, p, spec=spec, error_feedback=ef,
                                     device=where)
            finals.append(run_rounds_slab(run, state, draws, batch_fn,
                                          rounds, chunk=rounds))
        (cpu, cpu_hist), (card, card_hist) = finals
        lc = [h["loss"] for h in cpu_hist]
        lg = [h["loss"] for h in card_hist]
        err = max(abs(a - b) / max(abs(b), 1.0) for a, b in zip(lg, lc))
        check(err <= 1e-5, f"reference LM {name}: losses {lg} vs {lc}")
        worst_loss = max(worst_loss, err)
        worst = max(worst, _slabs_within(torch, card, cpu, share, everywhere,
                                         f"reference LM {name}"))
    print(f"[reference LM] tiny preset in f32 (qwen3-14b smoke width, vocab "
          f"257), 4 clients x batch 2 x seq 32, adam_ota, {rounds} rounds on "
          f"the f32 wire and int8 + EF, card vs cpu on the same parameters, "
          f"batches and draws: losses within {worst_loss:.2e} (tol 1e-5), "
          f"state slabs max err {worst:.2e} (within 1e-5 on all but 1e-4 / "
          f"1e-3 of entries); ok")


def _pieces(d: int, cols: int = 1 << 26):
    """Column ranges [a, b) covering d, each a multiple of 512 columns
    long but the last: the plain versions are compared a piece at a time,
    so their temporaries stay ~1 GB at the width run's slab."""
    return [(a, min(a + cols, d)) for a in range(0, d, cols)]


def _lm_draws(torch, gen, d):
    """(u, e) over a (d,) slab as the round's draws make them
    (``kernels.cms_draws.cms_draws_slab``, held to its plain version in
    phase 7b: e floored, never inf)."""
    from repro_torch.kernels.cms_draws import cms_draws_slab
    return cms_draws_slab(_draws_spec(torch, d), gen)


def phase_kernel_lm(torch, dev):
    """Every kernel of the LM runs against its plain version at the
    shapes those runs give it, the plain version a piece of columns at a
    time (``_pieces``; every kernel here is column-separable): B1 (adam,
    alpha 1.5) at d = D_LM, D_WIDTH, D_C, D_D and D_E; B2 at 8 x D_LM,
    1 x D_LM (the streamed finish, n_total 1) and 4 x each wider d; B3b
    at 4 x D_LM with a carry; B3c at 8 x D_LM (int8 with host rounding +
    EF, folded sign + EF) and 4 x each wider d (int8 + EF); B4 at 1 x
    D_LM (int8 with and without statistics, folded sign) and 1 x each
    wider d (int8). Tiers as phases 3-6 and 10; B3c
    also bitwise the plain quantizer on its own sum (phase 5's
    composition), and its sign payload equal to the plain version's
    wherever the sum is not within 1e-6 of its scale of 0 (another
    summation order can flip the sign of a sum that small). Returns the
    worst error by the JSON line's row name."""
    import gc

    from repro_torch.kernels.adaptive_update import adaptive_update_slab
    from repro_torch.kernels.ota_channel import (ota_channel_slab,
                                                 ota_receive_slab,
                                                 ota_transmit_slab,
                                                 pack_sign_slab)
    from repro_torch.kernels.ref import (adaptive_update_ref, ota_channel_ref,
                                        ota_receive_ref, ota_transmit_ref)

    gen = torch.Generator(device=dev).manual_seed(9)
    errs, flips = {}, {}

    def close(got, want, what, name):
        err = (got - want).abs()
        check(bool(torch.all(err <= 1e-6 * want.abs()
                             + 1e-6 * float(want.abs().max()))),
              f"{what}: max err {float(err.max())}")
        errs[name] = max(errs.get(name, 0.0), float(err.max()))

    kw = dict(lr=0.02, beta1=0.9, beta2=0.3, alpha=1.5, eps=1e-8,
              mode="adam")
    for d in (D_LM, D_WIDTH, D_C, D_D, D_E, D_F, D_G):
        g, w = (torch.randn(d, generator=gen, device=dev) for _ in range(2))
        delta = 0.1 * torch.randn(d, generator=gen, device=dev)
        nu = 0.01 * torch.rand(d, generator=gen, device=dev)
        got = adaptive_update_slab(g, delta, nu, w, **kw)
        for a, b in _pieces(d):
            want = adaptive_update_ref(g[a:b], delta[a:b], nu[a:b], w[a:b],
                                       **kw)
            for i, (x, y) in enumerate(zip(got, want)):
                close(x[a:b], y, f"adaptive_update_slab d={d} output {i}",
                      f"{UPD} d={d}")
        del g, w, delta, nu, got, want
    for n, d in ((8, D_LM), (1, D_LM), (4, D_WIDTH), (4, D_C), (4, D_D),
                 (4, D_E), (2, D_F), (4, D_G)):
        # run (f) takes the f32 wire only: no quantized kernel at its d
        quantized = n > 1 and d != D_F
        grads = torch.randn(n, d, generator=gen, device=dev)
        h = (torch.ones(1, device=dev) if n == 1 else
             0.5 + torch.rand(n, generator=gen, device=dev))
        u, e = _lm_draws(torch, gen, d)
        ckw = dict(alpha=1.5, scale=0.05, n_total=1 if n == 1 else None)
        got = ota_channel_slab(grads, h, u, e, **ckw)
        for a, b in _pieces(d):
            close(got[a:b], ota_channel_ref(grads[:, a:b], h, u[a:b],
                                            e[a:b], **ckw),
                  f"ota_channel_slab {n}x{d}", f"{CHAN} {n}x{d}")
        del got
        if n == 8:
            # the accumulating transmit at the streamed run's chunk
            acc = torch.randn(d, generator=gen, device=dev)
            got = ota_transmit_slab(grads[:4], h[:4], n_total=1, acc=acc)
            for a, b in _pieces(d):
                close(got[a:b], ota_transmit_ref(grads[:4, a:b], h[:4],
                                                 n_total=1, acc=acc[a:b]),
                      f"{STREAM} 4x{d}", f"{STREAM} 4x{d}")
            del acc, got
        if quantized:
            r = torch.rand(d, generator=gen, device=dev)
            ef = 0.01 * torch.randn(d, generator=gen, device=dev)
            name = f"{TX} {n}x{d}"
            modes = ((("int8", True, False), ("sign", False, True)) if n == 8
                     else (("int8", True, False),))
            # the kernel's own sum (the no-carry accumulating call) + ef
            x = ota_transmit_slab(grads, h) + ef
            one = torch.ones(1, device=dev)
            for qmode, sr, fold in modes:
                tkw = dict(quantize=True, qmode=qmode, stochastic=sr,
                           zero_fold=fold, return_residual=True)
                got = ota_transmit_slab(grads, h, r=r if sr else None, ef=ef,
                                        **tkw)
                what = f"ota_transmit_slab {n}x{d} {qmode}"
                for a, b in _pieces(d):
                    sa, sb = a // 128, b // 128
                    rr = r[a:b] if sr else None
                    part = tuple(t[a:b] if i != 1 else t[sa:sb]
                                 for i, t in enumerate(got))
                    own = ota_transmit_ref(x[None, a:b], one, n_total=1,
                                           r=rr, **tkw)
                    check(torch.equal(part[0], own[0]),
                          f"{what}: payload differs from the plain quantizer "
                          f"on its own sum at {int((part[0] != own[0]).sum())}"
                          " entries")
                    if qmode == "int8":
                        check(torch.equal(part[1], own[1])
                              and torch.equal(part[2], own[2]),
                              f"{what}: scales / residual differ from the "
                              "plain quantizer on its own sum")
                        want = ota_transmit_ref(grads[:, a:b], h, r=rr,
                                                ef=ef[a:b], **tkw)
                        xs = ota_transmit_ref(grads[:, a:b], h) + ef[a:b]
                        w_err, f = _check_transmit(torch, part, want, xs,
                                                   what)
                        errs[name] = max(errs.get(name, 0.0), w_err)
                    else:
                        for t, o, which in ((part[1], own[1], "scales"),
                                            (part[2], own[2], "residual")):
                            close(t, o, f"{what} {which}", name)
                        want = ota_transmit_ref(grads[:, a:b], h, ef=ef[a:b],
                                                **tkw)
                        xs = ota_transmit_ref(grads[:, a:b], h) + ef[a:b]
                        flip = part[0] != want[0]
                        f = int(flip.sum())
                        at = xs[flip].abs()
                        check(bool(torch.all(at <= 1e-6 * float(
                            xs.abs().max()))), f"{what}: a sign flipped on "
                            f"a sum of {float(at.max()) if f else 0.0}")
                    flips[what] = flips.get(what, 0) + f
                del got, part, own, want, xs
            del r, ef, x
        del grads
        # the receive of this slab: one row
        if quantized:
            s = torch.rand(1, d // 128, generator=gen, device=dev)
            q8 = torch.randint(-127, 128, (1, d), generator=gen, device=dev,
                               dtype=torch.int8)
            cases = [(q8, None, d == D_LM, f"{RX} 1x{d}")]
            if d == D_LM:
                # the sharded CLI's receives: int8 without statistics
                cases.append((q8, None, False, f"{RX} no-stats 1x{d}"))
                q3 = torch.randint(-1, 2, (1, d), generator=gen, device=dev,
                                   dtype=torch.int8)
                cases.append((pack_sign_slab(torch.where(q3 < 0, -1, 1).to(
                    torch.int8)), "fold", False, f"{RX} fold 1x{d}"))
            for payload, packed, stats, name in cases:
                rkw = dict(alpha=1.5, scale=0.05, packed=packed,
                           pilot_stats=stats)
                got = ota_receive_slab(payload, s, u, e, **rkw)
                if stats:
                    got, gs = got
                    ws = torch.zeros(3, device=dev)
                per_col = 32 if packed == "fold" else 1
                for a, b in _pieces(d):
                    want = ota_receive_ref(payload[:, a // per_col:
                                                   b // per_col],
                                           s[:, a // 128:b // 128], u[a:b],
                                           e[a:b], **rkw)
                    if stats:
                        want, piece_stats = want
                        ws = ws + piece_stats
                    close(got[a:b], want, name, name)
                if stats:
                    rel = float(((gs - ws).abs()
                                 / ws.abs().clamp_min(1)).max())
                    check(float(gs[0]) == float(ws[0]) == d and rel <= 1e-5,
                          f"{name}: stats {gs.tolist()} vs {ws.tolist()}")
            del s, q8, cases, got, want
        del u, e
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    wide = f"{D_WIDTH}, {D_C}, {D_D} and {D_E}"
    print(f"[kernel LM shapes] B1 adam at d = {D_LM}, {wide}, {D_F} and "
          f"{D_G}; B2 at 8x{D_LM}, 1x{D_LM}, 4 x each of {wide}, 2x{D_F} and "
          f"4x{D_G}; B3b at 4x{D_LM} with a carry; B3c int8 + EF at "
          f"8x{D_LM}, 4 x each of {wide} and 4x{D_G},"
          f" folded sign + EF at 8x{D_LM}; B4 int8 (with and without "
          f"statistics) and fold at 1x{D_LM}, int8 at 1 x each of {wide} "
          f"and {D_G}; "
          f"the plain versions {1 << 26} columns at a "
          "time: max_abs_err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + " (tol 1e-6 rel + 1e-6 of scale); transmit payloads bitwise the "
          "plain quantizer on the kernel's own sum, and against the plain "
          "version on the same inputs: "
          + ", ".join(f"{k} {v} entries apart" for k, v in flips.items())
          + " (int8: one step, on at most 0.1 %; sign: only sums within "
          "1e-6 of scale of 0); ok")
    return errs


def _lm_times(torch, dev, gen, flush):
    """Times (kernel, plain version, bytes, operations) of each kernel at
    the LM runs' shapes, counted as phase_times counts them; and
    torch.addmv beside the accumulating transmit. Run first in phase
    "times", while nothing else is on the card (the plain versions at
    the width run's slab hold 40-60 GB of temporaries)."""
    import gc

    from repro_torch.kernels.adaptive_update import adaptive_update_slab
    from repro_torch.kernels.ota_channel import (ota_channel_slab,
                                                 ota_receive_slab,
                                                 ota_transmit_slab,
                                                 pack_sign_slab)
    from repro_torch.kernels.ref import (adaptive_update_ref, ota_channel_ref,
                                        ota_receive_ref, ota_transmit_ref)

    rows, library = {}, {}
    kw = dict(lr=0.02, beta1=0.9, beta2=0.3, alpha=1.5, eps=1e-8,
              mode="adam")
    for d in (D_LM, D_WIDTH, D_C, D_D, D_E, D_F, D_G):
        g, w = (torch.randn(d, generator=gen, device=dev) for _ in range(2))
        delta = 0.1 * torch.randn(d, generator=gen, device=dev)
        nu = 0.01 * torch.rand(d, generator=gen, device=dev)
        rows[f"{UPD} d={d}"] = (
            _median_ms(torch, lambda: adaptive_update_slab(g, delta, nu, w,
                                                           **kw), flush),
            _median_ms(torch, lambda: adaptive_update_ref(g, delta, nu, w,
                                                          **kw), flush),
            7 * 4 * d, 16 * d)
        del g, w, delta, nu
        gc.collect()
        torch.cuda.empty_cache()
    for n, d in ((8, D_LM), (1, D_LM), (4, D_WIDTH), (4, D_C), (4, D_D),
                 (4, D_E), (2, D_F), (4, D_G)):
        grads = torch.randn(n, d, generator=gen, device=dev)
        h = (torch.ones(1, device=dev) if n == 1 else
             torch.rand(n, generator=gen, device=dev))
        u = torch.rand(d, generator=gen, device=dev) - 0.5
        e = torch.rand(d, generator=gen, device=dev) + 0.5
        ckw = dict(alpha=1.5, scale=0.05, n_total=1 if n == 1 else None)
        rows[f"{CHAN} {n}x{d}"] = (
            _median_ms(torch, lambda: ota_channel_slab(grads, h, u, e, **ckw),
                       flush),
            _median_ms(torch, lambda: ota_channel_ref(grads, h, u, e, **ckw),
                       flush),
            4 * (n * d + n + 3 * d), 2 * n * d + 12 * d)
        if n == 8:
            gs, hs = grads[:4], h[:4]
            acc = torch.randn(d, generator=gen, device=dev)
            skw = dict(n_total=1, acc=acc)
            name = f"{STREAM} 4x{d}"
            rows[name] = (
                _median_ms(torch, lambda: ota_transmit_slab(gs, hs, **skw),
                           flush),
                _median_ms(torch, lambda: ota_transmit_ref(gs, hs, **skw),
                           flush),
                4 * (4 * d + 4 + 2 * d), 2 * 4 * d + 2 * d)
            library[name] = ("torch.addmv", _median_ms(
                torch, lambda: torch.addmv(acc, gs.t(), hs), flush))
            del gs, acc
        if n > 1 and d != D_F:       # run (f): the f32 wire only
            r = torch.rand(d, generator=gen, device=dev)
            ef = 0.01 * torch.randn(d, generator=gen, device=dev)
            tkw = dict(quantize=True, r=r, ef=ef, return_residual=True)
            rows[f"{TX} {n}x{d}"] = (
                _median_ms(torch, lambda: ota_transmit_slab(grads, h, **tkw),
                           flush),
                _median_ms(torch, lambda: ota_transmit_ref(grads, h, **tkw),
                           flush),
                4 * n * d + 4 * n + 3 * 4 * d + d + 4 * (d // 128),
                2 * n * d + 8 * d)
            q, s = ota_transmit_slab(grads, h, quantize=True, r=r)
            del r, ef
            q, s = q[None], s[None]
            # the tracked run's receive (statistics) at the 100m slab, the
            # width run's without
            stats = d == D_LM
            rkw = dict(alpha=1.5, scale=0.05, pilot_stats=stats)
            rows[f"{RX} 1x{d}"] = (
                _median_ms(torch, lambda: ota_receive_slab(q, s, u, e, **rkw),
                           flush),
                _median_ms(torch, lambda: ota_receive_ref(q, s, u, e, **rkw),
                           flush),
                d + 4 * (d // 128) + 3 * 4 * d + (12 if stats else 0),
                14 * d + (6 * d if stats else 0))
            if d == D_LM:
                # the sharded CLI's receive: int8, no statistics
                nkw = dict(alpha=1.5, scale=0.05)
                rows[f"{RX} no-stats 1x{d}"] = (
                    _median_ms(torch, lambda: ota_receive_slab(q, s, u, e,
                                                               **nkw), flush),
                    _median_ms(torch, lambda: ota_receive_ref(q, s, u, e,
                                                              **nkw), flush),
                    d + 4 * (d // 128) + 3 * 4 * d, 14 * d)
                words = pack_sign_slab(torch.where(q < 0, -1, 1).to(
                    torch.int8))
                fkw = dict(alpha=1.5, scale=0.05, packed="fold")
                rows[f"{RX} fold 1x{d}"] = (
                    _median_ms(torch, lambda: ota_receive_slab(
                        words, s, u, e, **fkw), flush),
                    _median_ms(torch, lambda: ota_receive_ref(
                        words, s, u, e, **fkw), flush),
                    4 * (d // 32) + 4 * (d // 128) + 3 * 4 * d, 14 * d)
                del words
            del q, s
        del grads, u, e
        gc.collect()
        torch.cuda.empty_cache()
    return rows, library


def _flash_inputs(torch, dev, case, dtype, seed):
    b, sq, sk, h, kh, d = case[:6]
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=gen, device=dev).to(dtype)
            for s in ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d))]


def _flash_tier(torch, variant, want, q, k, v, causal, window):
    """The per-element tolerance a variant's output is held to against the
    plain version (kernels.flash_attention.flash_tolerance), and its
    formula for the log."""
    from repro_torch.kernels.flash_attention import flash_tolerance
    from repro_torch.kernels.ref import flash_attention_ref

    if variant == "hopper":
        ref_abs_v = flash_attention_ref(q.float(), k.float(), v.float().abs(),
                                        causal=causal, window=window)
        return (flash_tolerance(variant, want, ref_abs_v),
                "2^-7 |ref| + 2^-8 attn(q, k, |v|) + 2e-5")
    return (flash_tolerance(variant, want),
            "2e-5" if want.dtype == torch.float32 else "2^-7 |ref| + 2e-5")


def phase_kernel_flash(torch, dev):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_variant)
    from repro_torch.kernels.ref import flash_attention_ref

    # the FLASH_CASES, the models' shapes and the rows without keys,
    # each in f32 and bf16, through the variant the wrapper picks
    labels = ([f"FLASH_CASES[{i}]" for i in range(len(FLASH_CASES))]
              + [f"{a} shape" for a in FLASH_MODEL_SHAPES]
              + [f"{a} shape" for a in FLASH_SERVE_SHAPES]
              + ["rows without keys"] * len(FLASH_KEYLESS))
    shapes = (FLASH_CASES + list(FLASH_MODEL_SHAPES.values())
              + list(FLASH_SERVE_SHAPES.values()) + FLASH_KEYLESS)
    cases = [(lab, c, dt) for lab, c in zip(labels, shapes)
             for dt in (torch.float32, torch.bfloat16)]
    worst = {"hopper": (0.0, 0.0), "scalar": (0.0, 0.0)}
    for i, (label, case, dtype) in enumerate(cases):
        causal, window = case[6:]
        what = f"flash_attention {label} {case} {str(dtype)[6:]}"
        q, k, v = _flash_inputs(torch, dev, case, dtype, 100 + i)
        n0 = flash_attention.hopper_launches
        got = flash_attention(q, k, v, causal=causal, window=window)
        want = flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        variant = "hopper" if flash_attention.hopper_launches > n0 else \
            "scalar"
        chosen = flash_variant(dtype, case[5], case[1],
                               (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                got.data_ptr()))
        check(variant == chosen, f"{what}: launched {variant}, "
              f"flash_variant says {chosen}")
        check(got.dtype == dtype and got.shape == q.shape,
              f"{what}: {got.dtype} {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), f"{what}: not finite")
        diff = (got.float() - want.float()).abs()
        tol, tier = _flash_tier(torch, variant, want, q, k, v, causal,
                                window)
        err, share = float(diff.max()), float((diff / tol).max())
        check(share <= 1.0, f"{what} ({variant}): max err {err}, "
              f"{share:.3f} of the per-element tier {tier}")
        worst[variant] = (max(worst[variant][0], err),
                          max(worst[variant][1], share))
        print(f"[kernel flash_attention] {label} {case} {str(dtype)[6:]}: "
              f"{variant}, max_abs_err={err:.3e}, worst element "
              f"{share:.3f} of its tier ({tier}); ok")
        del q, k, v, got, want, diff, tol
    torch.cuda.empty_cache()
    print(f"[kernel flash_attention] {len(cases)} cases "
          f"({len(FLASH_CASES)} FLASH_CASES, "
          f"{len(FLASH_MODEL_SHAPES) + len(FLASH_SERVE_SHAPES)} model "
          f"shapes and {len(FLASH_KEYLESS)} "
          "with rows without keys, "
          "each f32 and bf16): "
          + "; ".join(f"{v}: max_abs_err {e:.3e}, worst element {sh:.3f} of "
                      "its tier" for v, (e, sh) in worst.items()) + "; ok")
    return {v: e for v, (e, _) in worst.items()}


def _flash_per_prefill(cfg, prompt):
    """The flash launches a prefill of ``prompt`` tokens makes, and those
    a decode step makes, by variant: one a layer in the prefill, of the
    variant ``flash_variant`` picks for the config's dtype and head dim
    (fresh allocations are 16-byte aligned), Whisper's encoder layers and
    its decoder's self- and cross-attention each; one a cross-attention
    layer in decode (Whisper's decoder layers, Llama-3.2-Vision's
    groups), none else; none in the mla family, whose attention is plain
    torch, nor in the attention-free rwkv one."""
    from repro_torch.kernels.flash_attention import flash_variant

    prefill = {"hopper": 0, "scalar": 0}
    step = dict(prefill)
    v = flash_variant(cfg.dtype, cfg.resolved_head_dim, prompt, (0, 0, 0, 0))
    if cfg.family in ("dense", "moe", "hybrid", "vlm"):
        prefill[v] = cfg.n_layers
    if cfg.family == "vlm":
        step[v] = cfg.n_layers // cfg.cross_attn_period
    if cfg.family == "encdec":
        prefill[v] = (cfg.n_enc_layers or cfg.n_layers) + 2 * cfg.n_layers
        step[v] = cfg.n_layers
    return prefill, step


def _flash_row(torch, key):
    """The kernels-line row of B5 at a FLASH_MODEL_SHAPES shape in bf16,
    named by the variant ``flash_variant`` picks for it."""
    from repro_torch.kernels.flash_attention import flash_variant

    variant = flash_variant(torch.bfloat16, FLASH_MODEL_SHAPES[key][5], 1,
                            (0, 0, 0, 0))
    return f"{FLASH} {variant} {key}"


def _flash_rows(torch, cfg, shape_launches):
    """A run's B5 launches (``flash_attention.shape_launches``) by
    kernels-line row: causal ones on the arch's prefill row, the rest
    (not causal, no window) on its "cross decode" row (Sq == 1), else on
    its "encoder" row (Whisper's encoder: Sq == Sk, which its prompts,
    shorter than the 1500 frames, never give cross-attention) or its
    "cross" row; every row must be in FLASH_MODEL_SHAPES."""
    out = {}
    for (_, sq, sk, *_, causal, window), n in shape_launches.items():
        kind = ("" if causal or window is not None else
                " cross decode" if sq == 1 else
                " encoder" if cfg.family == "encdec" and sq == sk else
                " cross")
        check(cfg.arch + kind in FLASH_MODEL_SHAPES,
              f"{cfg.arch}: B5 launched at a shape with no kernels-line row "
              f"({sq} x {sk}, causal {causal}, window {window})")
        row = _flash_row(torch, cfg.arch + kind)
        out[row] = out.get(row, 0) + n
    return out


def _kv_cache(cache):
    """The KV cache of a model's cache (a vlm's under its groups'
    ``selfs``), or None (the recurrent state only, or MLA's latent)."""
    layers = cache["layers"]
    return layers.get("kv") or layers.get("selfs", {}).get("kv")


def _serve_run(torch, model, params, dev, batch, prompt, gen, variants):
    """One greedy serve shape through the CLI's generate, with the
    family's stub inputs (``launch.serve.stub_inputs``): a cold run (the
    shape's first), then the timed warm run, each with the flash
    counters by variant (``variants``: "hopper" and "scalar") and by
    shape set to 0 just before and read just after, which must be
    ``_flash_per_prefill``'s prefill plus gen - 1 decode steps; then one
    more decode step with the counters at 0 (its own launches), and a
    prefill and a decode step under the profiler. Returns the warm run's
    numbers, its launches by kernels-line row and the cold prefill."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import generate, stub_inputs

    cfg = model.config
    check(cfg.family != "encdec" or prompt < cfg.enc_seq,
          f"{cfg.arch}: a prompt of {prompt} tokens, not fewer than the "
          f"{cfg.enc_seq} frames, would mix cross-attention into the "
          "encoder's row")
    per_prefill, per_step = _flash_per_prefill(cfg, prompt)
    want = {v: per_prefill[v] + (gen - 1) * per_step[v] for v in per_prefill}
    tokens = torch.randint(0, cfg.vocab, (batch, prompt), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    inputs = stub_inputs(cfg, batch, dev)
    runs = []
    for _ in ("cold", "warm"):
        for c in variants.values():
            c.launches = 0
        flash_attention.shape_launches.clear()
        runs.append(generate(model, params, tokens, gen, inputs=inputs))
        counts = {v: c.launches for v, c in variants.items()}
        check(counts == want, f"{cfg.arch} {batch}x{prompt}: flash launches "
              f"by variant {counts}, want {want} (one a layer in the "
              "prefill, of the variant flash_variant picks; "
              f"{per_step} a decode step)")
    by_row = _flash_rows(torch, cfg, flash_attention.shape_launches)
    for v, n in counts.items():
        check(sum(k for row, k in by_row.items() if row.split()[1] == v)
              == n, f"{cfg.arch}: rows {by_row} against launches {counts}")
    cold, r = runs
    check(torch.equal(cold["ids"], r["ids"]),
          f"{cfg.arch} {batch}x{prompt}: the warm run's ids differ")
    for c in variants.values():
        c.launches = 0
    logits, cache = model.decode_step(params, r["cache"], r["ids"][:, -1:],
                                      prompt + gen - 1)
    torch.cuda.synchronize()
    step = {v: c.launches for v, c in variants.items()}
    check(step == per_step, f"{cfg.arch}: a decode step launched flash "
          f"{step}, want {per_step}")
    check(bool(torch.isfinite(r["prefill_logits"]).all())
          and bool(torch.isfinite(logits).all()),
          f"{cfg.arch} {batch}x{prompt}: logits not finite")
    check(tuple(r["ids"].shape) == (batch, gen)
          and int(r["ids"].min()) >= 0 and int(r["ids"].max()) < cfg.vocab,
          f"{cfg.arch}: ids {tuple(r['ids'].shape)}")
    # the cache holds the prompt, the tokens and the meta tokens, at most
    # a window of them (the JAX CLI's length)
    total = prompt + gen + cfg.n_meta_tokens
    length = min(total, cfg.window) if cfg.window else total
    kv = _kv_cache(cache)
    if kv is not None:
        pos = kv["pos"].reshape(-1, kv["pos"].shape[-1])[0]
        check(pos.shape[0] == length, f"{cfg.arch}: a cache of "
              f"{pos.shape[0]} positions, want {length}")
        if cfg.window and total > cfg.window:
            # the ring holds exactly the last `window` positions
            check(sorted(pos.tolist()) == list(range(total - cfg.window,
                                                     total)),
                  f"{cfg.arch}: ring positions")
    ms_tok = 1e3 * r["t_decode"] / max(gen - 1, 1)
    # where the time goes: one more prefill and one decode step under the
    # profiler (not counted above), each with its own host clock
    batch_in = {"tokens": tokens, **inputs}
    _profile(torch, f"{cfg.arch} {batch}x{prompt} prefill",
             lambda: model.prefill(params, batch_in, length=length))
    _profile(torch, f"{cfg.arch} {batch}x{prompt} decode step",
             lambda: model.decode_step(params, cache, r["ids"][:, -1:],
                                       prompt + gen - 1))
    out = dict(prefill_ms=1e3 * r["t_prefill"], decode_ms_per_token=ms_tok,
               tokens_per_s=batch * (gen - 1) / r["t_decode"],
               prefill_tokens_per_s=batch * prompt / r["t_prefill"],
               cold_prefill_ms=1e3 * cold["t_prefill"],
               cold_decode_ms_per_token=1e3 * cold["t_decode"]
               / max(gen - 1, 1), cache_length=length if kv is not None
               else None, launches=counts, per_step=per_step, by_row=by_row,
               ids=r["ids"][0, :8].tolist())
    if cfg.family in ("vlm", "encdec"):
        out["cross_kv_ms"] = _cross_kv_ms(torch, cfg, params, cache)
    return out


def _cross_kv_ms(torch, cfg, params, cache, reps=10):
    """The card time a decode step spends recomputing the cross-attention
    keys and values from the cached image tokens / encoder output (as
    the JAX package's decode does; no cross-K/V cache): every cross
    layer's wk and wv projections of that source, timed with CUDA events
    over ``reps`` steps after a warm one; ms a step."""
    from repro_torch.core.slab import tree_map
    from repro_torch.models.layers import dense

    if cfg.family == "vlm":
        p, src = params["blocks"]["x_attn"], cache["image_embed"]
    else:
        p, src = params["dec_blocks"]["cross"], cache["enc_out"]
    n = p["wk"]["kernel"].shape[0]
    layers = [tree_map(lambda a: a[i], p) for i in range(n)]

    def step():
        for lp in layers:
            dense(lp["wk"], src)
            dense(lp["wv"], src)

    step()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        step()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _profile_run(torch, fn):
    """Run fn once under torch.profiler: its host-clock ms and the
    profiler's CUDA events (key_averages). fn runs in the active step of
    a schedule whose warm-up step runs one near-empty kernel: that step
    sets up CUPTI's activity tracing, whose first kernel records a
    capture of one step alone can miss (the receive's one-launch check
    saw no kernel at all in a process's first capture). Before it,
    ``device.warm_up_profiler`` runs one throwaway session in the
    process: a first session's warm-up step alone did not always do (the
    same check saw no kernel once more)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.device import warm_up_profiler
    from repro_torch.spans import PREFIX

    warm_up_profiler()
    traces = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: traces.append(p.key_averages())
                 ) as prof:
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        prof.step()
    check(len(traces) == 1, f"the profiler gave {len(traces)} traces")
    # annotations show on the card's timeline too, each over the kernels
    # launched inside it: the step's own and the round's spans
    return wall_ms, [a for a in traces[0] if a.device_type == DeviceType.CUDA
                     and not a.key.startswith(("ProfilerStep", PREFIX))]


def _profile(torch, what, fn):
    """Run fn once under torch.profiler; print the host-clock time, the
    card's kernel time (sum over CUDA events: one stream, no overlap),
    hence the card's busy and idle shares, the kernel count and the
    flash kernel's share. Measures; checks nothing."""
    wall_ms, dev_ev = _profile_run(torch, fn)
    busy_ms = sum(a.self_device_time_total for a in dev_ev) / 1e3
    if busy_ms <= 0:
        print(f"[profile] {what}: host clock {wall_ms:.2f} ms; card time "
              "not measured (the profiler saw no kernel)")
        return
    flash_ms = sum(a.self_device_time_total for a in dev_ev
                   if "flash_attention" in a.key) / 1e3
    top = sorted(dev_ev, key=lambda a: -a.self_device_time_total)[:3]
    print(f"[profile] {what}: host clock {wall_ms:.2f} ms (under the "
          f"profiler), card busy {busy_ms:.2f} ms ({busy_ms / wall_ms:.1%};"
          f" idle {1 - busy_ms / wall_ms:.1%}), "
          f"{sum(a.count for a in dev_ev)} kernels; {FLASH} "
          f"{flash_ms:.2f} ms ({flash_ms / busy_ms:.1%} of busy); top: "
          + "; ".join(f"{a.key[:60]} {a.self_device_time_total / 1e3:.2f} ms"
                      f" x{a.count}" for a in top))


def _check_expert_product(torch, dev, cfg, params, prompt=4096,
                          experts=16):
    """models.moe._expert_product, the bf16 expert product with an f32
    result (on the card cuBLAS with an f32 output, torch.bmm(out_dtype=)),
    at a 1 x ``prompt`` prefill's dispatch shape (its capacity; the first
    ``experts`` experts of layer 0's gate and down weights) against the
    product of the operands cast to f32: within 1e-5 of scale."""
    from repro_torch.models.moe import _expert_product

    cap = max(1, int(prompt * cfg.top_k * cfg.capacity_factor
                     / cfg.n_experts))
    gen = torch.Generator(device=dev).manual_seed(3)
    errs = []
    for name in ("gate", "down"):
        w = params["blocks"]["moe"][name][0, :experts]
        a = torch.randn(experts, cap, w.shape[1], generator=gen,
                        device=dev).bfloat16()
        got = _expert_product(a, w)
        want = torch.bmm(a.float(), w.float())
        scale = float(want.abs().max())
        errs.append(float((got - want).abs().max()) / scale)
        check(got.dtype == torch.float32 and errs[-1] <= 1e-5,
              f"{cfg.arch} expert product {name}: {got.dtype}, max err "
              f"{errs[-1]} of scale")
        del a, got, want
    print(f"[serve {cfg.arch}] the expert product (bf16 operands, f32 "
          f"result) at ({experts}, {cap}, {cfg.d_model}) x ({experts}, "
          f"{cfg.d_model}, {cfg.d_ff}) and back: within "
          f"{max(errs):.2e} of scale of the f32 product (tol 1e-5); ok")


def phase_serve(torch, dev, variants, arch):
    """Serve one architecture at full width (depth cut by SERVE_LAYERS):
    random parameters on the card, then each of its SERVE_RUNS
    (``variants``: the flash counters by variant)."""
    import dataclasses
    import gc

    from repro_torch.configs import preset_config
    from repro_torch.core.slab import tree_flatten
    from repro_torch.models.model import build_model

    cfg = preset_config(arch, SERVE_PRESET)
    full_depth = cfg.n_layers
    cfg = dataclasses.replace(cfg, n_layers=SERVE_LAYERS.get(arch,
                                                             full_depth))
    model = build_model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_flatten(params)[0])
    init_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    extra = ({"vlm": f", a gated cross-attention layer every "
              f"{cfg.cross_attn_period} over {cfg.n_img_tokens} image tokens",
              "encdec": f", {cfg.n_enc_layers} encoder layers over "
              f"{cfg.enc_seq} frames"}.get(cfg.family, ""))
    print(f"[serve {arch}] preset {SERVE_PRESET}: {cfg.n_layers} of "
          f"{full_depth} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
          f"/ {cfg.n_kv_heads} kv, head_dim {cfg.resolved_head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, window {cfg.window}, "
          f"{cfg.n_experts} experts top-{cfg.top_k} + {cfg.n_shared_experts} "
          f"shared, {cfg.n_meta_tokens} meta tokens{extra}, family "
          f"{cfg.family}: "
          f"{n_params / 1e9:.3f} B parameters "
          f"({cfg.param_dtype}, {2 * n_params / 1e9:.2f} GB) drawn on the "
          f"card in {time.perf_counter() - t0:.1f} s, peak {init_peak:.2f} "
          "GB while drawing")
    out = {}
    with torch.no_grad():
        if cfg.family == "moe":
            _check_expert_product(torch, dev, cfg, params)
        for name, a, batch, prompt, gen in SERVE_RUNS:
            if a != arch:
                continue
            torch.cuda.reset_peak_memory_stats(dev)
            r = _serve_run(torch, model, params, dev, batch, prompt, gen,
                           variants)
            r["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
            out[name] = r
            print(f"[serve {arch}] {name}: batch {batch} x prompt {prompt}, "
                  f"{gen} tokens greedy, warm run: prefill "
                  f"{r['prefill_ms']:.1f} ms ({r['prefill_tokens_per_s']:.0f}"
                  f" tokens/s), decode {r['decode_ms_per_token']:.2f} "
                  f"ms/token ({r['tokens_per_s']:.1f} tokens/s); cold run "
                  f"(the shape's first): prefill {r['cold_prefill_ms']:.1f} "
                  f"ms, decode {r['cold_decode_ms_per_token']:.2f} ms/token;"
                  f" peak memory {r['peak_gb']:.2f} GB; {FLASH} launches by "
                  f"variant {r['launches']} in each run ({r['per_step']} a "
                  f"decode step), by row {r['by_row']}; "
                  + (f"the cross-attention K/V recomputed from the cache "
                     f"{r['cross_kv_ms']:.3f} ms of card time a decode step "
                     f"({r['cross_kv_ms'] / r['decode_ms_per_token']:.1%} of "
                     "its host-clock ms/token); " if "cross_kv_ms" in r
                     else "")
                  + (f"KV cache length {r['cache_length']} (min(s + gen + "
                     f"{cfg.n_meta_tokens}, window {cfg.window})); "
                     if r["cache_length"] is not None else
                     "no KV cache (the O(1) recurrent state); ")
                  + f"ids[0,:8] {r['ids']}, the same in both runs; logits "
                  "finite; ok")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


REFERENCE_SERVE = (("qwen3-14b", 48), ("starcoder2-15b", 80),
                   ("qwen3-moe-235b-a22b", 48), ("kimi-k2-1t-a32b", 48),
                   ("minicpm3-4b", 48), ("rwkv6-7b", 48),
                   ("hymba-1.5b", 48), ("llama-3.2-vision-11b", 48),
                   ("whisper-medium", 48))


def phase_reference_serve(torch, dev):
    """The REFERENCE_SERVE smoke configs (dense, moe, mla, rwkv, hybrid,
    vlm, encdec; the last two with the serve CLI's stub inputs) in f32 on
    the card against the same parameters on the CPU: prefill logits,
    every cache leaf and 8 greedy ids. The f32 serving path of the scalar
    flash kernel (none in the mla and rwkv families; cross-attention in
    the vlm and encdec decode steps too): its counters are set to 0 just
    before and read just after; returns its launches."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.core.slab import tree_flatten, tree_map
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import generate, stub_inputs
    from repro_torch.models.model import build_model

    worst = 0.0
    layers = 0
    flash_attention.scalar_launches = flash_attention.hopper_launches = 0
    for arch, prompt in REFERENCE_SERVE:
        cfg = dataclasses.replace(smoke_config(arch), param_dtype="float32")
        model = build_model(cfg)
        params = model.init(seed=0, device="cpu")
        tokens = torch.randint(0, cfg.vocab, (2, prompt),
                               generator=torch.Generator().manual_seed(1))
        inputs = stub_inputs(cfg, 2, "cpu")
        cpu = generate(model, params, tokens, 8, inputs=inputs)
        card = generate(model, tree_map(lambda t: t.to(dev), params),
                        tokens.to(dev), 8,
                        inputs=tree_map(lambda t: t.to(dev), inputs))
        per_prefill, per_step = _flash_per_prefill(cfg, prompt)
        layers += per_prefill["scalar"] + 7 * per_step["scalar"]
        pairs = [("prefill logits", card["prefill_logits"],
                  cpu["prefill_logits"])]
        pairs += [(f"cache leaf {i}", a, b) for i, (a, b) in enumerate(zip(
            tree_flatten(card["cache"])[0], tree_flatten(cpu["cache"])[0]))]
        for what, a, b in pairs:
            a, b = a.cpu().float(), b.float()
            scale = max(float(b.abs().max()), 1.0)
            err = float((a - b).abs().max())
            check(err <= 1e-4 * scale, f"reference serve {arch} {what}: "
                  f"max err {err} > 1e-4 x {scale}")
            worst = max(worst, err / scale)
        check(torch.equal(card["ids"].cpu(), cpu["ids"]),
              f"reference serve {arch}: ids {card['ids'].tolist()} vs "
              f"{cpu['ids'].tolist()}")
    scalar = flash_attention.scalar_launches
    check(scalar == layers and flash_attention.hopper_launches == 0,
          f"reference serve: {scalar} scalar and "
          f"{flash_attention.hopper_launches} Hopper flash launches, want "
          f"{layers} scalar (one a layer in each f32 prefill, one a "
          "cross-attention layer in each decode step)")
    print("[reference serve] the smoke configs of "
          + ", ".join(f"{a} (prompt {p})" for a, p in REFERENCE_SERVE)
          + " in f32 (starcoder2's prompt past its window of 64: the ring "
          "cache; the moe ones drop tokens in decode; hymba's 8 meta tokens "
          "and 48 prompt tokens in its window of 64; llama-3.2-vision's 16 "
          "image tokens, whisper's 24 frames), card vs cpu: prefill "
          f"logits and caches within {worst:.2e} of scale (tol 1e-4), 8 "
          f"greedy ids equal; {FLASH} launches {scalar}, all of the scalar "
          "variant (one a layer, none in minicpm3's MLA or rwkv6's; one a "
          "cross-attention layer a decode step); ok")
    return scalar


def _median_ms(torch, fn, flush):
    """Median of per-launch CUDA-event times, each launch after an L2
    flush (the round finds its operands cold: ~40 MB of other traffic
    runs between two launches of one kernel). A 2 ms device sleep after
    the flush holds the card while the host enqueues the start event,
    the call and the end event, so the time is the card's and not the
    host's enqueue time (a wrapper's Python can outlast the flush)."""
    fn()
    times = []
    for _ in range(TIMED_LAUNCHES):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in times)


def _fold_cost(torch, dev, gen, flush, gs, hs, acc, n_seg):
    """Time a split call of the accumulating transmit beside the same
    kernel on as many blocks and about the same bytes without a split,
    two turns each: (n_y, d_y) has a column tile for each block of the
    split call, each block reading a segment's rows x 2 KB; its column
    tiles fill the card, so it takes S = 1 (no partials, no ticket, no
    fold). The difference is what the split costs."""
    from repro_torch.kernels.ota_channel import (TRANSMIT_TILE,
                                                 ota_transmit_slab, row_split,
                                                 segment_rows, sm_count)

    (n, d), blocks = gs.shape, -(-gs.shape[1] // TRANSMIT_TILE) * n_seg
    n_y, d_y = segment_rows(n, None, n_seg), blocks * TRANSMIT_TILE
    check(row_split(n_y, d_y, None, True, sm_count(dev.index)) == 1,
          f"the fold's yardstick {n_y}x{d_y} splits its rows")
    gy = torch.randn(n_y, d_y, generator=gen, device=dev)
    hy = torch.rand(n_y, generator=gen, device=dev)
    acc_y = torch.randn(d_y, generator=gen, device=dev)
    calls = [(f"{n}x{d}, S = {n_seg}, {4 * n * d / 1e6:.1f} MB",
              lambda: ota_transmit_slab(gs, hs, n_total=n, acc=acc)),
             (f"{n_y}x{d_y}, S = 1, {4 * n_y * d_y / 1e6:.1f} MB",
              lambda: ota_transmit_slab(gy, hy, n_total=n_y, acc=acc_y))]
    ms = _in_turns(torch, flush, [fn for _, fn in calls])
    fold, plain = (statistics.median(t) for t in ms)
    print(f"[times] {STREAM} {n}x{d} against the same kernel without a "
          f"fold ({blocks} blocks of {n_y} rows x 2 KB each), two turns: "
          + "; ".join(f"{what}: " + " ".join(f"{t:.4f}" for t in times)
                      + " ms" for (what, _), times in zip(calls, ms))
          + f"; the split costs {fold - plain:.4f} ms")


def _in_turns(torch, flush, fns, turns=2):
    """Each call's _median_ms, taken in turns: A B .. B A (the order
    reverses every turn); one list of times a call."""
    ms = [[] for _ in fns]
    for t in range(turns):
        order = list(range(len(fns)))
        for i in (order if t % 2 == 0 else order[::-1]):
            ms[i].append(_median_ms(torch, fns[i], flush))
    return ms


def phase_times(torch, dev, total):
    """Times of every kernel at its main-path shapes (see the module
    docstring, phase 19; ``total``, the main path's slab entries).
    Returns the rows by name and the launch floor:
    a near-empty launch (torch.cuda._sleep of one cycle) timed the same
    way, the least any kernel's time can read in this harness."""
    from repro_torch.kernels.adaptive_update import adaptive_update_slab
    from repro_torch.kernels.ota_channel import (channel_blocks,
                                                 ota_channel_slab,
                                                 ota_transmit_slab)
    from repro_torch.kernels.cms_draws import cms_draws_slab
    from repro_torch.kernels.ref import (adaptive_update_ref, cms_draws_ref,
                                         ota_channel_ref)

    flush = torch.empty(64 * 2 ** 20, device=dev)      # 256 MB > 50 MB L2
    gen = torch.Generator(device=dev).manual_seed(2)
    floor = _median_ms(torch, lambda: torch.cuda._sleep(1), flush)
    print(f"[times] launch floor: {floor:.4f} ms, the median of "
          f"{TIMED_LAUNCHES} near-empty launches (torch.cuda._sleep(1)) "
          "under the same flush and sleep")
    rows, library = _lm_times(torch, dev, gen, flush)
    b3a_rows, b3a_library = _b3a_times(torch, dev, gen, flush)
    rows.update(b3a_rows)
    library.update(b3a_library)
    # the CMS draws: read nothing and write u and e (f32) over the padded
    # slab; about 6 f32 operations an entry (the Philox rounds and the
    # conversion to a uniform are integer work, not counted). At the main
    # path's slab and at run (b)'s.
    g_cms = torch.Generator(device=dev).manual_seed(3)
    for t_c, name in ((total, CMS), (D_WIDTH, f"{CMS} d={D_WIDTH}")):
        spec_c = _draws_spec(torch, t_c)
        rows[name] = (
            _median_ms(torch, lambda: cms_draws_slab(spec_c, g_cms), flush),
            _median_ms(torch, lambda: cms_draws_ref(spec_c, g_cms), flush),
            8 * spec_c.padded, 6 * t_c)
        torch.cuda.empty_cache()
    d, n = D_MAIN, N_CLIENTS
    kw = dict(lr=0.01, beta1=0.9, beta2=0.3, alpha=1.5, eps=1e-8, mode="adam")
    # adam: reads g, delta, nu, w and writes delta, nu, w (f32); about 16
    # f32 operations an element, counting each powf as one. At the main
    # path's slab and at the million-client stream's.
    for d_u, name in ((D_MAIN, "adaptive_update_slab"),
                      (D_MILLION, f"adaptive_update_slab d={D_MILLION}")):
        g, w = (torch.randn(d_u, generator=gen, device=dev)
                for _ in range(2))
        delta = 0.1 * torch.randn(d_u, generator=gen, device=dev)
        nu = 0.01 * torch.rand(d_u, generator=gen, device=dev)
        rows[name] = (
            _median_ms(torch, lambda: adaptive_update_slab(g, delta, nu, w,
                                                           **kw), flush),
            _median_ms(torch, lambda: adaptive_update_ref(g, delta, nu, w,
                                                          **kw), flush),
            7 * 4 * d_u, 16 * d_u)
    # channel: reads G, h, u, e and writes out; 2 N d for the faded sum
    # and about 12 a column for the CMS transform. At 50 x 175,104 in
    # turns with the accumulating transmit's no-carry call (the same rows
    # through the same ring, no CMS), then with pilot statistics (the
    # wrapper's call: the kernel and the sum of its (blocks, 3) rows);
    # then the one-row streamed finishes.
    ckw = dict(alpha=1.5, scale=0.1)
    for n_c, d_c in ((n, d), (1, D_MAIN), (1, D_MILLION)):
        grads = torch.randn(n_c, d_c, generator=gen, device=dev)
        h = torch.rand(n_c, generator=gen, device=dev)
        u = torch.rand(d_c, generator=gen, device=dev) - 0.5
        e = torch.rand(d_c, generator=gen, device=dev) + 0.5
        name = ("ota_channel_slab" if n_c > 1 else
                f"ota_channel_slab {n_c}x{d_c}")
        if n_c > 1:
            b2, b3 = _in_turns(torch, flush, [
                lambda: ota_channel_slab(grads, h, u, e, **ckw),
                lambda: ota_transmit_slab(grads, h)])
            ms = statistics.median(b2)
            stats_ms = _median_ms(torch, lambda: ota_channel_slab(
                grads, h, u, e, pilot_stats=True, **ckw), flush)
            rows_ = torch.rand(channel_blocks(d_c), 3, generator=gen,
                               device=dev)
            sum_ms = _median_ms(torch, lambda: torch.sum(rows_, dim=0), flush)
            # the same two launches without the statistics epilogue: the
            # difference is what the epilogue costs inside the kernel
            pair_ms = _median_ms(torch, lambda: (
                ota_channel_slab(grads, h, u, e, **ckw),
                torch.sum(rows_, dim=0)), flush)
            print(f"[times] ota_channel_slab {n_c}x{d_c} and {STREAM}'s "
                  f"no-carry call, in turns: "
                  + " ".join(f"{t:.4f}" for t in b2) + " ms against "
                  + " ".join(f"{t:.4f}" for t in b3) + " ms: "
                  f"{1e3 * (ms - statistics.median(b3)):.2f} us over it; "
                  f"with pilot statistics {stats_ms:.4f} ms "
                  f"(+{1e3 * (stats_ms - ms):.2f} us): the kernel and the "
                  f"wrapper's sum of its {channel_blocks(d_c)} statistics "
                  f"rows, a launch of its own ({sum_ms:.4f} ms alone); the "
                  f"kernel without statistics and the same sum "
                  f"{pair_ms:.4f} ms, so the epilogue costs "
                  f"{1e3 * (stats_ms - pair_ms):.2f} us in the kernel")
        else:
            ms = _median_ms(torch, lambda: ota_channel_slab(
                grads, h, u, e, n_total=1, **ckw), flush)
        rows[name] = (
            ms, _median_ms(torch, lambda: ota_channel_ref(grads, h, u, e,
                                                          **ckw), flush),
            4 * (n_c * d_c + n_c + 3 * d_c), 2 * n_c * d_c + 12 * d_c)
    del grads
    d, n = D_MAIN, N_CLIENTS
    grads = torch.randn(n, d, generator=gen, device=dev)
    h = torch.rand(n, generator=gen, device=dev)
    u = torch.rand(d, generator=gen, device=dev) - 0.5
    e = torch.rand(d, generator=gen, device=dev) + 0.5
    # transmit, int8 SR + EF + residual: reads G, h, r, ef; writes q
    # (int8), s (one f32 per 128 columns) and the residual; 2 N d for the
    # faded sum and about 8 an entry for the epilogue.
    from repro_torch.kernels.ota_channel import (ota_receive_slab,
                                                 ota_transmit_slab,
                                                 pack_sign_slab, row_split,
                                                 sm_count)
    from repro_torch.kernels.ref import ota_receive_ref, ota_transmit_ref
    r = torch.rand(d, generator=gen, device=dev)
    ef = 0.01 * torch.randn(d, generator=gen, device=dev)
    tkw = dict(quantize=True, r=r, ef=ef, return_residual=True)
    bytes_t = 4 * n * d + 4 * n + 3 * 4 * d + d + 4 * (d // 128)
    ops_t = 2 * n * d + 8 * d
    # in turns with the accumulating transmit's no-carry call (the same
    # rows through the same ring, no epilogue)
    b3c, b3b = _in_turns(torch, flush, [
        lambda: ota_transmit_slab(grads, h, **tkw),
        lambda: ota_transmit_slab(grads, h)])
    ms = statistics.median(b3c)
    print(f"[times] ota_transmit_slab {n}x{d} (int8, host rounding, EF, "
          f"residual) and {STREAM}'s no-carry call, in turns: "
          + " ".join(f"{t:.4f}" for t in b3c) + " ms against "
          + " ".join(f"{t:.4f}" for t in b3b) + " ms: "
          f"{1e3 * (ms - statistics.median(b3b)):.2f} us over it")
    rows["ota_transmit_slab"] = (
        ms,
        _median_ms(torch, lambda: ota_transmit_ref(grads, h, **tkw), flush),
        bytes_t, ops_t)
    # in-kernel rounding: no r to read, a Philox draw a 4-column group
    # (about 40 integer operations); its plain version takes r (it has no
    # Philox), the same work otherwise
    skw = dict(quantize=True, ef=ef, return_residual=True)
    rows["ota_transmit_slab sr_seed"] = (
        _median_ms(torch, lambda: ota_transmit_slab(grads, h, sr_seed=7,
                                                    **skw), flush),
        rows["ota_transmit_slab"][1], bytes_t - 4 * d, ops_t + 10 * d)
    # S3's quantized finish: one row, h = 1, n_total = 1
    g1, h1 = grads[:1], torch.ones(1, device=dev)
    rows[f"ota_transmit_slab 1x{d}"] = (
        _median_ms(torch, lambda: ota_transmit_slab(g1, h1, n_total=1, **tkw),
                   flush),
        _median_ms(torch, lambda: ota_transmit_ref(g1, h1, n_total=1, **tkw),
                   flush),
        4 * d + 4 + 3 * 4 * d + d + 4 * (d // 128), 2 * d + 8 * d)
    # receive, R = 1: reads q (int8, or 1 bit a column packed), s, u, e;
    # writes out; 2 an entry to dequantize and about 12 for the CMS
    # transform.
    q, s = ota_transmit_slab(grads, h, quantize=True, r=r)
    q, s = q[None], s[None]
    words = pack_sign_slab(torch.where(q < 0, -1, 1).to(torch.int8))
    rkw = dict(alpha=1.5, scale=0.1)
    bytes_r = d + 4 * (d // 128) + 3 * 4 * d
    bytes_f = 4 * (d // 32) + 4 * (d // 128) + 3 * 4 * d
    ops_r = 14 * d
    rows["ota_receive_slab"] = (
        _median_ms(torch, lambda: ota_receive_slab(q, s, u, e, **rkw), flush),
        _median_ms(torch, lambda: ota_receive_ref(q, s, u, e, **rkw), flush),
        bytes_r, ops_r)
    # with pilot statistics: + 12 bytes out, and a log, a square and 3
    # adds a column; the wrapper's whole call (one launch since the fold
    # moved into the kernel; two before, the kernel and a torch.sum)
    rows["ota_receive_slab stats"] = (
        _median_ms(torch, lambda: ota_receive_slab(q, s, u, e,
                                                   pilot_stats=True, **rkw),
                   flush),
        _median_ms(torch, lambda: ota_receive_ref(q, s, u, e,
                                                  pilot_stats=True, **rkw),
                   flush), bytes_r + 12, ops_r + 6 * d)
    rows["ota_receive_slab fold"] = (
        _median_ms(torch, lambda: ota_receive_slab(words, s, u, e,
                                                   packed="fold", **rkw),
                   flush),
        _median_ms(torch, lambda: ota_receive_ref(words, s, u, e,
                                                  packed="fold", **rkw),
                   flush), bytes_f, ops_r)
    # the accumulating transmit, one chunk with a carry, at the streamed
    # runs' chunk (50 x 175,104) and the million-client chunk (2000 x
    # 4096): reads G, h, acc and writes out; 2 n d flops for the faded
    # sum and 2 d for the carry. torch.addmv is the one PyTorch call that
    # computes the same function (cuBLAS GEMV), the yardstick.
    for n_s, d_s in ((N_CLIENTS, D_MAIN), (CHUNK_MILLION, D_MILLION)):
        gs = torch.randn(n_s, d_s, generator=gen, device=dev)
        hs = torch.rand(n_s, generator=gen, device=dev)
        acc = torch.randn(d_s, generator=gen, device=dev)
        skw = dict(n_total=n_s, acc=acc)
        name = f"{STREAM} {n_s}x{d_s}"
        rows[name] = (
            _median_ms(torch, lambda: ota_transmit_slab(gs, hs, **skw),
                       flush),
            _median_ms(torch, lambda: ota_transmit_ref(gs, hs, **skw),
                       flush),
            4 * (n_s * d_s + n_s + 2 * d_s), 2 * n_s * d_s + 2 * d_s)
        library[name] = ("torch.addmv", _median_ms(
            torch, lambda: torch.addmv(acc, gs.t(), hs, alpha=1.0 / n_s),
            flush))
        n_seg = row_split(n_s, d_s, None, True, sm_count(dev.index))
        print(f"[times] {name}: the rows split into S = {n_seg} segments; "
              f"{rows[name][0] / library[name][1]:.3f} x torch.addmv's time")
        if n_seg > 1:
            _fold_cost(torch, dev, gen, flush, gs, hs, acc, n_seg)
    del gs, acc
    # flash attention at the models' FLASH_MODEL_SHAPES, bf16 (the
    # variant flash_variant picks): reads q, k, v and writes out once; 4 D
    # flops for each visible (query, key) pair and head, counted for these
    # masks (every pair when neither causal nor windowed), at the bf16
    # tensor-core rate. Then the scalar variant at Qwen3's shape in
    # f32 (what an f32 prefill at full width would run), at the f32 rate.
    # scaled_dot_product_attention computes the same function (the window
    # as a boolean mask): the yardstick, never called by the port.
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    rates = {}
    flash_runs = [(_flash_row(torch, a), c, torch.bfloat16)
                  for a, c in FLASH_MODEL_SHAPES.items()]
    flash_runs.append((f"{FLASH} scalar f32 qwen3-14b",
                       FLASH_MODEL_SHAPES["qwen3-14b"], torch.float32))
    for name, case, dtype in flash_runs:
        b, sq, sk, h, kh, d, causal, window = case
        q, k, v = _flash_inputs(torch, dev, case, dtype, 7)
        i = np.arange(sq)
        lo = np.maximum(0, i - window + 1) if window else np.zeros_like(i)
        hi = np.minimum(sk - 1, i) if causal else np.full_like(i, sk - 1)
        pairs = int(np.maximum(0, hi - lo + 1).sum())
        fkw = dict(causal=causal, window=window)
        ops = b * pairs * h * 4 * d
        rows[name] = (
            _median_ms(torch, lambda: flash_attention(q, k, v, **fkw), flush),
            _median_ms(torch, lambda: flash_attention_ref(q, k, v, **fkw),
                       flush),
            q.element_size() * (2 * q.numel() + 2 * k.numel()), ops)
        if dtype == torch.bfloat16:
            rates[name] = (BF16_FLOPS_PER_S, "bf16 flops at 989 TFLOP/s")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if window is None:
            # the same mask as the kernel's: causal or none (a causal
            # SDPA beside a non-causal kernel would do half the work)
            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True)
        else:
            dpos = (torch.arange(sq, device=dev)[:, None]
                    - torch.arange(sk, device=dev)[None, :])
            mask = (dpos >= 0) & (dpos < window)

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)
        diff = float((sdpa().transpose(1, 2).float()
                      - flash_attention(q, k, v, **fkw).float()).abs().max())
        sdpa_ms = _median_ms(torch, sdpa, flush)
        library[name] = ("scaled_dot_product_attention", sdpa_ms)
        ms = rows[name][0]
        print(f"[times] {name}: {pairs} visible pairs a head, "
              f"{ops / ms / 1e9:.1f} TFLOP/s; {ms / sdpa_ms:.3f} x "
              f"scaled_dot_product_attention's time, which differs from "
              f"the kernel by {diff:.3e} at most")
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    _flash_scalar_at(torch, dev, flush, "kimi-k2-1t-a32b", rows)
    out = {}
    for name, (ms, plain_ms, nbytes, ops) in rows.items():
        rate, what = rates.get(name, (F32_FLOPS_PER_S,
                                      "f32 ops at 67 TFLOP/s"))
        t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        t_ops = 1e3 * ops / rate
        bound = max(t_bytes, t_ops)
        lib_name, lib_ms = library.get(name, (None, None))
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                         bound_by="bytes" if t_bytes >= t_ops else
                         "operations", bytes=nbytes, library_ms=lib_ms)
        print(f"[times] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound:.5f} ms ({out[name]['bound_by']}: {nbytes} B at "
              f"3.35 TB/s; {ops} {what}), share of bound "
              f"{bound / ms:.3f}; launch floor {floor:.4f} ms, kernel - "
              f"floor {ms - floor:.4f} ms; "
              + (f"library ({lib_name}) {lib_ms:.4f} ms" if lib_ms else
                 "library_ms null: no single PyTorch call computes this "
                 "function"))
    return out, floor


def _flash_scalar_at(torch, dev, flush, key, rows):
    """The scalar flash kernel at a FLASH_MODEL_SHAPES shape in bf16 that
    the wrapper sends to the Hopper kernel, through the library's C entry
    (``repro_flash_attention``, bf16): checked once against the plain
    version at the scalar bf16 tier, then timed as the rows are, beside
    the Hopper row of the same call (its time before the Hopper kernel
    took the shape). Launches no counter; prints, returns nothing."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_tolerance
    from repro_torch.kernels.ref import flash_attention_ref

    case = FLASH_MODEL_SHAPES[key]
    b, sq, sk, h, kh, d, causal, window = case
    q, k, v = _flash_inputs(torch, dev, case, torch.bfloat16, 7)
    out = torch.empty_like(q)
    lib = build.load_library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            sk, h, kh, d, int(causal), window or 0, 1.0 / math.sqrt(d),
            torch.cuda.current_stream(dev).cuda_stream)

    def scalar():
        build.check(lib.repro_flash_attention(1, *args),
                    "flash_attention (scalar, C entry)")

    scalar()
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    diff = (out.float() - want.float()).abs()
    share = float((diff / flash_tolerance("scalar", want)).max())
    check(share <= 1.0, f"{FLASH} scalar bf16 {key}: {share:.3f} of its "
          "tier")
    ms = _median_ms(torch, scalar, flush)
    hopper = rows[_flash_row(torch, key)][0]
    print(f"[times] {FLASH} scalar bf16 {key} (the C entry; the wrapper "
          f"sends this shape to the Hopper kernel): {ms:.4f} ms, "
          f"max_abs_err {float(diff.max()):.3e} ({share:.3f} of the scalar "
          f"bf16 tier); the Hopper kernel at the same shape {hopper:.4f} "
          f"ms, {ms / hopper:.2f} x faster")
    del q, k, v, out, want, diff
    torch.cuda.empty_cache()


def main() -> int:
    t_start = time.perf_counter()
    import os
    # before torch allocates on the card: phase 14d's 4 GB slabs leave the
    # default pool's segments too fragmented for its int8 round
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no port package under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build
    from repro_torch.kernels.adaptive_update import adaptive_update_slab
    from repro_torch.kernels.cms_draws import cms_draws_slab
    from repro_torch.kernels.ota_channel import (ota_channel_slab,
                                                 ota_receive_slab,
                                                 ota_transmit_slab)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    print(nvidia_smi())
    print(f"[device] {kind}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    lib_path = build.build()
    build.load_library()
    print(f"[build] {', '.join(build.SOURCES)} -> {lib_path.name} in "
          f"{time.perf_counter() - t0:.1f} s (nvcc {' '.join(build.NVCC_FLAGS)}"
          "; " + ", ".join(f"{src} {' '.join(fl) or 'no more'}"
                           for src, fl in build.SOURCE_FLAGS.items()) + ")")
    phase_build_report(build, lib_path)

    from repro_torch.core.slab import make_slab_spec
    from repro_torch.models.vision import resnet_tiny
    spec = make_slab_spec(resnet_tiny(10).init(seed=0, device="cpu"))
    check(spec.padded == D_MAIN, f"ResNet-tiny slab {spec.padded}")

    err_update = phase_kernel_update(torch, dev)
    err_channel = phase_kernel_channel(torch, dev, spec.total)
    err_transmit = phase_kernel_transmit(torch, dev, spec.total)
    err_receive = phase_kernel_receive(torch, dev, spec.total)
    err_update[D_MAIN] = max(err_update[D_MAIN],
                             phase_runtime_alpha(torch, dev, spec.total))
    err_draws = phase_kernel_draws(torch, dev, spec.total)
    err_stream = phase_kernel_stream(torch, dev, spec.total)
    err_b3a = phase_kernel_b3a(torch, dev, spec.total)
    err_flash = phase_kernel_flash(torch, dev)
    err_lm = phase_kernel_lm(torch, dev)
    phase_reference(torch, np)
    phase_reference_wire(torch, np)
    phase_reference_stream(torch, np)
    phase_reference_lm(torch, dev)
    phase_stream_equals_resident(torch, np, dev)
    counters = (adaptive_update_slab, ota_channel_slab)
    launches = phase_main_path(torch, np, dev, counters + (cms_draws_slab,))
    all_counters = counters + (ota_transmit_slab, ota_receive_slab,
                               Counter(ota_transmit_slab, "stream_launches",
                                       STREAM))
    launches[STREAM] = 0
    wire_launches, wire_by_run = phase_wire_runs(torch, np, dev,
                                                 all_counters)
    stream_launches = phase_streamed_runs(torch, np, dev, all_counters)
    million_launches = phase_million(torch, dev, all_counters)
    api_launches = phase_round_api(torch, np, dev, all_counters)
    ckpt_launches = phase_checkpoint(torch, np, dev, all_counters)
    from repro_torch.kernels.flash_attention import flash_attention
    lm = phase_lm_train(torch, dev, all_counters + (flash_attention,))
    wd = phase_lm_width(torch, dev,
                        all_counters + (flash_attention, cms_draws_slab))
    phase_families_train(torch, all_counters + (flash_attention,))
    wd_c = phase_lm_width(
        torch, dev, all_counters + (flash_attention, cms_draws_slab), C_ARCH)
    wd_d = phase_lm_width(
        torch, dev, all_counters + (flash_attention, cms_draws_slab), D_ARCH)
    wd_e = phase_lm_width(
        torch, dev, all_counters + (flash_attention, cms_draws_slab), E_ARCH)
    wd_f = phase_lm_width(
        torch, dev, all_counters + (flash_attention, cms_draws_slab), F_ARCH)
    wd_g = phase_lm_width(
        torch, dev, all_counters + (flash_attention, cms_draws_slab), G_ARCH)
    phase_remat_trade(torch, dev, all_counters + (flash_attention,))
    phase_levers(torch, dev, flash_attention)
    phase_long_sequence(torch, dev, all_counters + (flash_attention,))
    phase_serve_example(torch, flash_attention)
    phase_alpha_mismatch(torch, all_counters + (flash_attention,))
    phase_paper_figs(torch, dev, all_counters + (flash_attention,))
    nocarry = Counter(ota_transmit_slab, "nocarry_launches", NOCARRY)
    rxstats = Counter(ota_receive_slab, "stats_launches", RXSTATS)
    sh = phase_sharded(torch, np, dev, all_counters + (nocarry, rxstats))
    sh_cli = phase_sharded_cli(torch, dev,
                               all_counters + (nocarry, rxstats))
    for part in (wire_launches, stream_launches, million_launches):
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v
    # launches by shape: the accumulating kernel's chunks, the streamed
    # runs' one-row channel finish, the million-client stream's finish
    # and update
    launches[f"{STREAM} {N_CLIENTS}x{D_MAIN}"] = stream_launches[STREAM]
    launches[f"{STREAM} {CHUNK_MILLION}x{D_MILLION}"] = \
        million_launches[STREAM]
    launches[f"ota_channel_slab 1x{D_MAIN}"] = \
        stream_launches["ota_channel_slab"]
    launches[f"ota_channel_slab 1x{D_MILLION}"] = \
        million_launches["ota_channel_slab"]
    launches[f"adaptive_update_slab d={D_MILLION}"] = \
        million_launches["adaptive_update_slab"]
    # the quantized wire by variant: the transmit at 50 x 175,104 with
    # host rounding or the sign quantizer, with in-kernel rounding, and
    # S3's one-row finish; the receive with pilot statistics (the
    # alpha="auto" runs) and without
    tx, rx = "ota_transmit_slab", "ota_receive_slab"
    launches[f"{tx} sr_seed"] = wire_by_run["int8-srk-ef"][tx]
    launches[tx] = wire_launches[tx] - launches[f"{tx} sr_seed"]
    launches[f"{tx} 1x{D_MAIN}"] = stream_launches[tx]
    launches[f"{rx} stats"] = (wire_by_run["int8-ef-dl8-auto"][rx]
                               + stream_launches[rx])
    launches[rx] = wire_launches[rx] + stream_launches[rx] - \
        launches[f"{rx} stats"]
    # the per-round API's runs and the resident runs beside them (f32:
    # channel and update; int8: transmit with host rounding, receive
    # without statistics, update), and the checkpoint runs (alpha="auto":
    # the receive with statistics)
    upd, chan = "adaptive_update_slab", "ota_channel_slab"
    launches[upd] += api_launches[upd] + ckpt_launches[upd]
    launches[chan] += api_launches[chan]
    launches[tx] += api_launches[tx] + ckpt_launches[tx]
    launches[rx] += api_launches[rx]
    launches[f"{rx} stats"] += ckpt_launches[rx]
    # the LM runs by shape: the 100m preset's (phase 14c: the four wires
    # and the resume) and the width run's (phase 14d)
    chunked = lm["chunk4-sr0.5-datasize"]
    launches[f"{UPD} d={D_LM}"] = sum(r[UPD] for r in lm.values())
    launches[f"{CHAN} 8x{D_LM}"] = lm["f32"][CHAN] + lm["resume"][CHAN]
    launches[f"{CHAN} 1x{D_LM}"] = chunked[CHAN]
    launches[f"{STREAM} 4x{D_LM}"] = chunked[STREAM]
    launches[f"{TX} 8x{D_LM}"] = (lm["int8-ef-dl8-auto"][TX]
                                  + lm["sign-fold-ef"][TX])
    launches[f"{RX} 1x{D_LM}"] = lm["int8-ef-dl8-auto"][RX]
    launches[f"{RX} fold 1x{D_LM}"] = lm["sign-fold-ef"][RX]
    launches[f"{UPD} d={D_WIDTH}"] = sum(r[UPD] for r in wd.values())
    launches[f"{CHAN} 4x{D_WIDTH}"] = wd["f32"][CHAN]
    launches[f"{TX} 4x{D_WIDTH}"] = wd["int8-ef"][TX]
    launches[f"{RX} 1x{D_WIDTH}"] = wd["int8-ef"][RX]
    launches[f"{UPD} d={D_C}"] = sum(r[UPD] for r in wd_c.values())
    launches[f"{CHAN} 4x{D_C}"] = wd_c["f32"][CHAN]
    launches[f"{TX} 4x{D_C}"] = wd_c["int8-ef"][TX]
    launches[f"{RX} 1x{D_C}"] = wd_c["int8-ef"][RX]
    for n, d, runs in ((4, D_D, wd_d), (4, D_E, wd_e), (4, D_G, wd_g)):
        launches[f"{UPD} d={d}"] = sum(r[UPD] for r in runs.values())
        launches[f"{CHAN} {n}x{d}"] = runs["f32"][CHAN]
        launches[f"{TX} {n}x{d}"] = runs["int8-ef"][TX]
        launches[f"{RX} 1x{d}"] = runs["int8-ef"][RX]
    launches[f"{UPD} d={D_F}"] = wd_f["f32"][UPD]
    launches[f"{CHAN} 2x{D_F}"] = wd_f["f32"][CHAN]
    # the sharded runs (phases 14e-14f): B3a's launches at each of its
    # two shapes (phase 14e's ResNet rounds, phase 14f's 100m CLI), and
    # the other kernels' on their rows; the receive's launches with
    # statistics by their own counter
    for (n, d), runs in zip(B3A_PATH_SHAPES, (sh, sh_cli)):
        launches[f"{B3A} {n}x{d}"] = sum(r[NOCARRY] for r in runs.values())
    rx_sh = sum(r[RX] for r in sh.values())
    stats_sh = sum(r[RXSTATS] for r in sh.values())
    launches[UPD] += sum(r[UPD] for r in sh.values())
    launches[TX] += sh["int8-ef-dl8-auto"][TX] + sh["sign-fold-ef"][TX]
    launches[f"{RX} stats"] += stats_sh
    launches[RX] += rx_sh - stats_sh
    launches[f"{STREAM} {N_CLIENTS}x{D_MAIN}"] += sh["S1"][STREAM]
    launches[f"{UPD} d={D_LM}"] += sum(r[UPD] for r in sh_cli.values())
    launches[f"{TX} 8x{D_LM}"] += sh_cli["int8-ef"][TX]
    launches[f"{RX} 1x{D_LM}"] += sum(r[RXSTATS] for r in sh_cli.values())
    launches[f"{RX} no-stats 1x{D_LM}"] = sum(r[RX] - r[RXSTATS]
                                              for r in sh_cli.values())
    variants = {v: Counter(flash_attention, f"{v}_launches", f"{FLASH} {v}")
                for v in ("hopper", "scalar")}
    for arch in dict.fromkeys(a for _, a, *_ in SERVE_RUNS):
        runs = phase_serve(torch, dev, variants, arch)
        for r in runs.values():
            for row, n in r["by_row"].items():
                launches[row] = launches.get(row, 0) + n
    launches[f"{FLASH} scalar f32 qwen3-14b"] = phase_reference_serve(
        torch, dev)
    # the CMS draws: the main path's runs (phase 9) and run (b)'s
    launches[f"{CMS} d={D_WIDTH}"] = sum(r[CMS] for r in wd.values())
    times, floor = phase_times(torch, dev, spec.total)

    b1 = ("adaptive_update.cu", "src/repro/kernels/adaptive_update.py:188")
    b2 = ("ota_channel.cu", "src/repro/kernels/ota_channel.py:222")
    b3c = ("ota_transmit.cu", "src/repro/kernels/ota_channel.py:527")
    b4 = ("ota_receive.cu", "src/repro/kernels/ota_channel.py:679")
    rows = (("adaptive_update_slab", *b1, err_update[D_MAIN]),
            (f"adaptive_update_slab d={D_MILLION}", *b1,
             err_update[D_MILLION]),
            ("ota_channel_slab", *b2, err_channel[(N_CLIENTS, D_MAIN)]),
            (f"ota_channel_slab 1x{D_MAIN}", *b2, err_channel[(1, D_MAIN)]),
            (f"ota_channel_slab 1x{D_MILLION}", *b2,
             err_channel[(1, D_MILLION)]),
            ("ota_transmit_slab", *b3c, err_transmit),
            ("ota_transmit_slab sr_seed", *b3c, err_transmit),
            (f"ota_transmit_slab 1x{D_MAIN}", *b3c, err_transmit),
            ("ota_receive_slab", *b4, err_receive),
            ("ota_receive_slab stats", *b4, err_receive),
            (f"{STREAM} {N_CLIENTS}x{D_MAIN}", "ota_transmit_stream.cu",
             "src/repro/kernels/ota_channel.py:447", err_stream),
            (f"{STREAM} {CHUNK_MILLION}x{D_MILLION}", "ota_transmit_stream.cu",
             "src/repro/kernels/ota_channel.py:447", err_stream))
    b3b = ("ota_transmit_stream.cu", "src/repro/kernels/ota_channel.py:447")
    rows += tuple((name, *src, err_lm[name]) for name, src in (
        (f"{UPD} d={D_LM}", b1), (f"{UPD} d={D_WIDTH}", b1),
        (f"{CHAN} 8x{D_LM}", b2), (f"{CHAN} 1x{D_LM}", b2),
        (f"{CHAN} 4x{D_WIDTH}", b2), (f"{STREAM} 4x{D_LM}", b3b),
        (f"{TX} 8x{D_LM}", b3c), (f"{TX} 4x{D_WIDTH}", b3c),
        (f"{RX} 1x{D_LM}", b4), (f"{RX} no-stats 1x{D_LM}", b4),
        (f"{RX} fold 1x{D_LM}", b4),
        (f"{RX} 1x{D_WIDTH}", b4), (f"{UPD} d={D_C}", b1),
        (f"{CHAN} 4x{D_C}", b2), (f"{TX} 4x{D_C}", b3c),
        (f"{RX} 1x{D_C}", b4))
        + tuple(row for n, d in ((4, D_D), (4, D_E), (4, D_G)) for row in (
            (f"{UPD} d={d}", b1), (f"{CHAN} {n}x{d}", b2),
            (f"{TX} {n}x{d}", b3c), (f"{RX} 1x{d}", b4)))
        + ((f"{UPD} d={D_F}", b1), (f"{CHAN} 2x{D_F}", b2)))
    cms = ("cms_draws.cu", "src/repro/core/ota.py:103")
    rows += ((CMS, *cms, err_draws[D_MAIN]),
             (f"{CMS} d={D_WIDTH}", *cms, err_draws[D_WIDTH]))
    rows += tuple((f"{B3A} {n}x{d}", "ota_transmit_stream.cu",
                   "src/repro/kernels/ota_channel.py:419",
                   err_b3a[f"{B3A} {n}x{d}"]) for n, d in B3A_PATH_SHAPES)
    flash_src = {"hopper": "flash_attention_sm90.cu",
                 "scalar": "flash_attention.cu"}
    for name in (_flash_row(torch, a) for a in FLASH_MODEL_SHAPES):
        v = name.split()[1]
        rows += ((name, flash_src[v],
                  "src/repro/kernels/flash_attention.py:106", err_flash[v]),)
    rows += ((f"{FLASH} scalar f32 qwen3-14b", "flash_attention.cu",
              "src/repro/kernels/flash_attention.py:106",
              err_flash["scalar"]),)
    kernels = [dict(name=name, route="cuda",
                    source="src/repro_torch/csrc/" + source,
                    replaces=replaces, launches=launches[name],
                    max_abs_err=err,
                    **{k: times[name][k] for k in ("ms", "plain_ms",
                                                   "bound_ms", "bound_by",
                                                   "library_ms")})
               for name, source, replaces, err in rows]
    print(f"[chip_smoke] {time.perf_counter() - t_start:.1f} s from start "
          f"to the kernels line, on {nvidia_smi()}")
    print(json.dumps({"kernels": kernels, "launch_floor_ms": floor}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
