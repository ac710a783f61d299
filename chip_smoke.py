"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line, none catching its own failure:

  1. card      the card's name and power limit (nvidia-smi), torch / CUDA;
  2. build     every hand-written CUDA kernel library, one nvcc each, in
               parallel; each kernel instance's registers and spills;
  3. kernels   each paged attention kernel against its plain PyTorch version
               on the same CUDA tensors (atol 2e-3) at the main path's
               shapes, the smoke shapes, int8 pages at the main path's
               lengths and at other ones (prefill on tensor cores, like
               bf16 and f16), f16 pages and pt 8 / hd 128 (bf16 and int8),
               each int8 pool with a page whose scales are 0,
               each kernel's grid logged; kernel and yardstick times
               (``scaled_dot_product_attention`` over already-gathered
               dense K/V, int8 pages dequantized to bf16 beforehand: it
               leaves the page walk out and is not the same function) from
               CUDA-graph replays, plain times from CUDA events, beside the
               least time the card could take, for bf16 and for int8 pages
               (decode at the serving decode shape, prefill at C 256 /
               start 1500); then at yi-34b's decode step and chunk (B 8,
               H 56, K 8, hd 128: G 7; bf16, timed, and int8), at
               minitron-4b's (H 24, K 8: G 3; timed), at
               granite-moe-3b-a800m's (H 24, K 8, hd 64: G 3; timed) and
               at one rank's shard of qwen2-0.5b at tp = 2 (H 7, K 1, hd
               64; timed), whose split must equal the unsharded call's;
  4. suite kernels  the AutoDMA builder with each gemm body (mxu, vpu,
               loop), matvec and matvec_t against the plain grid walker on
               the same CUDA tensors: gemm 2048³ and 1024×1024×4608, matvec
               2048², every mode, bf16, and a ragged shape with a tile that
               does not divide; then conv2d (its own kernel, in its own
               bands) against its row-tile walk at 2048² in every mode,
               bf16, and ragged shapes on the 16-byte path (1001×1500 f32)
               and the scalar path (1001×1500 bf16, 999×1001 f32), f32 bit
               for bit, each path run at least once; and covar (the
               builder's center and gram bodies) against the walker at
               2048² in every mode and a ragged 1000×600; tolerances as
               relative Frobenius error (mxu f32 and covar 5e-3: TF32; vpu
               / loop / matvec f32 1e-5; bf16 1e-2); each matvec / matvec_t
               case also captured in a CUDA graph and replayed twice, bit
               for bit equal to the eager call, and logged with its layout
               (ks, blocks, shared memory) and its kernel instance's
               registers and spills;
               kernel, plain, yardstick (``torch.matmul``
               / ``torch.mv`` / ``F.conv2d`` with a [1,1,3,3] weight and
               padding 1, cuDNN TF32 off / ``torch.cov(D.T)`` under TF32)
               and bound times at the main shapes;
  5. attention kernels  flash_decode at the serving path's decode shape
               (B 8, H 14, K 2, S 2048, hd 64, bf16; ragged lengths from
               the serving mix, a length-0 slot, which must return the
               mean of V, and a full one) and at the reference tests'
               shapes in f32 (and hd 16, the smoke width), then captured
               in a CUDA graph at the main shape and replayed twice, bit for bit equal to the eager
               call (its one launch, split grid and in-kernel merge
               logged); flash_attention at qwen2-0.5b's full width
               (B 1, H 14, L 2048, hd 64, bf16, causal), gemma3-27b's
               local layer (B 1, H 32, L 4096, hd 128, bf16, causal,
               window 1024) and small softcap / window / no-key-row /
               ragged cases at hd 32, 64 and 128, each in bf16 (the
               tensor-core kernel) and f32 (the CUDA-core kernel), and at
               hd 16 in f32 (the smoke width, which phase 8's dense
               prefill takes); each against its plain version on the same CUDA tensors within
               atol 2e-3, plus one bf16 rounding step of the value for bf16
               outputs (both sides round an f32 result to bf16); kernel,
               plain, ``scaled_dot_product_attention`` yardstick (mask
               stated in the log) and bound times; then both at
               gemma3-27b's serving shapes (phase 7i's traffic):
               flash_attention at the longest prompt's prefill (B 1, H
               32, L 1326, hd 128, bf16, causal) with window 1024 (a
               local layer; SDPA with a bool window mask) and without (a
               global one), flash_decode at the decode step (B 8, H 32, K
               16, hd 128) over 1024-row rings (lengths ≤ 1024, two
               wrapped; again with a free slot at length 1) and 2048-row
               global caches (SDPA with a length mask), each held and
               timed; then every attention call of phases 7k / 7l, bf16
               (the calls ``train.step.attention_calls`` lists for their
               runs, kv heads repeated as the path repeats them):
               flash_attention non-causal over whisper's 1500 frames (B 8,
               H 16, hd 64), at each arch's causal self prefill (8×32×256
               ×128, G 4; 8×16×4×64) and its cross prefill (q 8×32×256×128
               over k/v 8×32×1600×128, and q 8×16×4×64 over 8×16×1500×64:
               Lq ≠ Lk); flash_decode at each decode step's lengths over
               the self caches (B 8, H 32, K 8, S 2048, hd 128, lengths
               257-319; B 8, H 16, K 16, S 448, hd 64, lengths 5-67) and
               the cross caches, every slot at S (S 1600; S 1500: a ragged
               last split); each held, and each entry timed beside SDPA
               (no mask, is_causal or a length mask) and its bound (K/V
               bytes counted once a kv head); then every attention call
               of phase 7n (zamba2-1.2b's shared sites, MHA, H = K = 32,
               hd 64, bf16): flash_attention at each of the 8 prefills
               (B 1, causal, L 151-1326) and flash_decode at each of the
               63 decode steps' lengths (B 8, S 2048, slot b at prompt +
               1 + step), each held, the longest prefill and the middle
               step timed; then both with a logit softcap
               (``SOFTCAP``): flash_decode with its lse at the serving
               decode shape and at gemma3-27b's global decode (B 8, H 32,
               K 16, S 2048, hd 128), flash_attention at qwen2-0.5b's
               prefill (B 1, H 14, L 2048, hd 64, causal), each held
               against its plain version (the lse within 1e-3) and the
               qwen2 shapes timed, beside the library yardstick
               ``flex_attention`` compiled with a tanh ``score_mod`` and
               the same mask (held against plain first);
  6. suite     the paper's kernel suite through ``kernels/ops.py``
               (``launch/kernel_suite.py``: Fig. 7 at N=2048 with conv2d
               and covar, darknet, the ISA study, the attention rows),
               every kernel launch counted from 0, then each output against
               its oracle;
  7. serve     full-width qwen2-0.5b (random weights, seed 0, bf16) through
               the chunked paged engine: 8 requests, prompts of 128-1536
               tokens, 64 new tokens each; every kernel launch counted;
  7b. serve int8+prefix  the same model on int8 pages with the prefix
               layer: request 0 (a 1024-token system prompt and a suffix of
               64-512 tokens) alone, then six requests sharing the system
               prompt and one exact copy of request 0's prompt, 64 new
               tokens each; gates: 7 prefix hits, 1 of them full, shared
               and chunk-prefilled tokens that add up to the prompts, every
               kernel launch counted, every page free after clear(), the
               same streams from a second run; logged, not gated: the
               share of tokens equal to a bf16-page run without the prefix
               layer and to an f32 run (compute and pages), beside two
               controls: bf16 against f32, bf16 + prefix against bf16;
  7c. serve tiered  phase 7's model, engine and traffic over a hot tier of
               160 pages (30 MiB, ~2.1x oversubscribed) above host DRAM
               (the default budget); gates: at least one preemption, swap
               counts and bytes balanced, no cold sequence, every hot page
               free, the L3 arena empty, the allocator audit clean, every
               kernel launch counted, the same streams and counters from a
               second (traced) run, and a full-width swap round trip of a
               1500-token sequence that restores every leaf bit for bit on
               bf16 pages and on int8 pages with their scales; logged, not
               gated: preemptions, swap counts and bytes, tok/s, TTFT and
               ITL, the tracer's dma windows and stall share, each way's
               GB/s on the copy stream beside the PCIe link, and the share
               of tokens equal to phase 7's untiered streams;
  7d. serve fleet  two replicas of phase 7's model (one set of weights)
               behind the fleet router, each a chunked engine on bf16
               pages with the prefix layer: two 1024-token system prompts,
               A0 and B0 (suffixes of 64-512 tokens) stepped until both
               prefills land, then 12 followers in pairs, A A B B ...,
               64 new tokens each; gates: every request finishes, all 12
               followers routed by prefix (12 x 1024 matched tokens), 6
               prefix hits a replica, every kernel launch counted, every
               page free and each allocator's audit clean after clear()
               and a drain; then the same traffic under round robin (it
               splits each pair: no prefix-routed request, at most 10
               hits), and
               under the prefix router with r1 killed while it decodes
               (its requests finish on r0, none lost; respawn, drain,
               audits clean); logged, not gated: tok/s, TTFT and ITL per
               run and the share of tokens equal to the un-killed run;
  7e. serve dense  phase 7's model and traffic through the dense engine (a
               slot pool of 8 x 2048 x 12,288 B) and the monolithic paged
               engine (bf16 pages); gates: every request finishes, the
               dense run launches flash_decode 24 x decode steps and
               flash_attention 24 x prefills times, the monolithic run
               paged_flash_decode 24 x decode steps and flash_attention
               24 x prefills times and paged_flash_prefill never, every
               slot or page free at the end; logged: tok/s, TTFT, ITL and
               the share of tokens equal to phase 7's chunked streams;
               then the dense engine again with ``logit_softcap`` set
               (``SOFTCAP``, the same weights; the same gates, its
               launches the ``_softcap`` entries', its tok/s and its
               token match against the uncapped dense run logged); then
               flash_decode at the dense decode step's shape (each
               slot at its last step's length) and flash_attention at the
               longest prompt's prefill, each held against its plain
               version and timed for its serving entries;
  7f. serve yi-34b  yi-34b at full width, cut in depth to 20 of its 60
               layers (``ZOO_LAYERS``; d_model 7168, 56/8
               heads, hd 128, d_ff 20480, vocab 64000, untied; the
               parameters drawn at bf16, seed 0: 34.4 B at 60 layers)
               through phase 7's
               chunked engine and traffic (a pool of 1024 pages x
               3,932,160 B), run after every earlier model and pool is
               freed; gates: every request finishes, 8 x 64 tokens, the
               prompt tokens all chunk-prefilled, every page free, audit
               clean, each paged kernel launched layers x steps (chunks)
               times; logged: free memory before the weights, peak
               memory, tok/s, TTFT and ITL p50 / p99, decode steps and
               chunks; then a second run, gated to the same streams,
               with iterations 8-12 (``PROFILE_WINDOW``, as in every
               profiled phase: the profile's analysis is slow) under
               torch.profiler: the device's busy share of that window and
               its top kernels;
  7g. serve minitron-4b  minitron-4b at full width (32 layers, d_model
               3072, 24/8 heads, squared-ReLU MLP, a 256,000-wide untied
               head) on the same engine, traffic and gates;
  7h. serve tp  phase 7's model, engine and traffic at tp = 2: two ranks
               (parallel/launch.py) on this one card over gloo, which
               stages CUDA tensors through the host (NCCL refuses two
               ranks on one GPU), so the run is for correctness only;
               each rank holds one of the two kv heads; gates: every
               rank's streams equal phase 7's tp = 1 streams, each paged
               kernel launched layers x steps (chunks) times a rank, the
               rank-consistency check on after every iteration, every
               page free; then, in the same spawn, each rank serves
               ``TP_CLOCK``'s 12 requests behind an ITL target and
               deadlines on a smaller engine (every scheduler clock read
               rank 0's, broadcast over gloo): under a manual clock
               (rank 1's skewed x 7 + 100 s), its streams, admission
               order, sheds and counters equal to the same engine's at
               tp = 1 in this process under rank 0's clock, with budget
               squeezes in some but not all iterations with a
               mid-prefill resident, a deadline lapsed and one met
               (gates); under the real clock, both ranks equal, the rank
               check clean, the broadcasts per iteration logged;
  7i. serve gemma3-27b  (``dense_zoo_serve``, as 7m / 7n) gemma3-27b at
               full width (d_model 5376, 32/16 heads, hd 128, d_ff 21504,
               vocab 262144, tied, zero-centred and sandwich norms, the
               embedding scaled; local layers with window 1024 on ring
               caches): first the memory-fit gate (``full_depth_fit``) at
               the published 62 layers (52 local, 10 global;
               27,008,986,368 parameters drawn at bf16, seed 0, cache
               leaves 4,831,838,208 B: both gated) serving the traffic's
               shortest prompt to 4 tokens; then, cut in depth to 14 of
               the 62 layers (``DENSE_ZOO``: 12 local, 2 global;
               7,189,867,776 parameters) to keep the script inside its
               time limit, through the dense engine (8 slots x 2048; its
               local layers are not pageable) on phase 7's traffic, after
               every earlier model is freed; gates: every request
               finishes with 64 tokens, every slot free, the cache leaves
               1,073,741,824 B, no warm-up pool left resident,
               flash_attention 14 x 8 = 112 calls, flash_decode 14 x
               decode steps; logged: free memory before the weights, peak
               memory, tok/s, TTFT and ITL p50 / p99; then a second run,
               gated to the same streams, with iterations 8-12 under
               torch.profiler: the device's busy share and its top
               kernels;
  7j. serve granite-moe-3b-a800m  granite-moe at full width, cut in
               depth to 8 of its 32 layers (``ZOO_LAYERS``; d_model 1536,
               24/8 heads, hd 64, 40 experts of d_ff 512,
               top-8 with capacity dispatch, vocab 49155, tied; the
               parameters drawn at bf16, seed 0: 3,298,793,472 at 32
               layers) through phase 7f's chunked engine, traffic and
               gates;
               logged besides: the (token, expert) assignments the
               capacity drops on one 256-token chunk at each layer
               (request 0's first 256 tokens, counted with the port's
               own route / select on the layer's input), and the profiled
               second run's top 15 kernels (the MoE's ops among them);
  7k. steps llama-3.2-vision-11b  at full width (40 layers: 8 units of 4
               gqa + 1 cross layer; d_model 4096, 32/8 heads, hd 128,
               d_ff 14336, vocab 128256, untied; 9,775,157,248
               parameters drawn at bf16, seed 0; nothing cut) through
               the prefill / decode steps (train/step.py), the path the
               reference runs it on (no engine takes its image input),
               after every earlier model is freed: 8 requests, each a
               256-token prompt and 1600 stub patch embeddings (N(0, 1),
               seed 0), max_seq 2048, a prefill and 63 decode steps;
               gates: the parameter count, cache leaves of 2,147,483,648
               B (self) and 419,430,400 B (cross), every logit finite and
               every token in the vocabulary, flash_attention 40 calls (32
               causal + 8 cross), flash_decode 40 x 63 = 2520, each kind
               of layer's share (told apart by wrapping cross_forward and
               encoder_forward for the run) equal to what
               ``attention_calls`` lists, and a second run, profiled over
               decode steps 8-12, with the same streams; logged: free
               memory before the weights, peak memory, prefill ms, tok/s,
               ITL p50 / p99, busy share and top kernels;
  7l. steps whisper-medium  at full width (24 encoder + 2 x 24 decoder
               layers, d_model 1024, 16 heads, hd 64, d_ff 4096, layer
               norms, GELU, learned positions, vocab 51865; 813,500,416
               parameters at bf16) on the same steps: 8 clips of 1500
               stub frames and the 4-token start of transcript, max_seq
               448 (its decoder's maximum), 64 new tokens; gates as 7k:
               cache leaves of 352,321,536 B (self) and 1,179,648,000 B
               (cross), flash_attention 24 encoder + 24 self + 24 cross =
               72 calls, flash_decode 48 x 63 = 3024;
  7m. serve xlstm-1.3b  at full width (d_model 2048, 4 heads, vocab
               50304, tied): first the memory-fit gate at the published
               48 layers (6 x (7 mLSTM + 1 sLSTM); 3,502,733,312
               parameters drawn at bf16, seed 0, cache leaves
               5,652,086,784 B: the mLSTM states, 42 x 8 x 4 x 1024 x
               1025 x 4 B, with the conv and sLSTM leaves); then, cut in
               depth to 16 of the 48 layers (2 x (7 mLSTM + 1 sLSTM);
               1,236,260,864 parameters) through the dense engine, the
               only one that serves it in either package (its layers are
               not pageable), 8 slots x 2048, on phase 7's traffic; gates
               as 7i: the parameter count, cache leaves of 1,884,028,928
               B (constant in max_seq), every request with 64 tokens,
               every slot free, both attention kernels launched 0 times
               (it has no attention layer), and a second, profiled run
               with the same streams;
  7n. serve zamba2-1.2b  at full width (38 layers = 6 x (5 Mamba2 + 1
               shared attention site) + 2 Mamba2, d_model 2048, 32 heads
               (MHA), d_ff 8192, d_state 64, head_dim 64, vocab 32000,
               tied; 951,304,192 parameters) on the same engine, traffic
               and gates: cache leaves of 1,080,229,888 B,
               flash_attention 6 x 8 = 48 calls, flash_decode 6 x decode
               steps;
  7o. serve deepseek-v3-671b  every layer at full width (d_model 7168,
               128 heads, MLA q_lora 1536 / kv_lora 512 / qk_nope 128 /
               qk_rope 64 / v_dim 128, dense d_ff 18432, 256 experts of
               d_ff 2048 top-8 with 1 shared expert and a sigmoid router,
               vocab 129280, untied) but CUT IN DEPTH to 3 dense + 2 MoE
               layers of the published 3 + 58, the MTP head undrawn (the
               published 682,636,457,984 parameters fit no card):
               26,618,387,456 parameters drawn at bf16, seed 0, on the
               same engine, traffic and gates: cache leaves of 94,371,840
               B (5 layers x 8 x 2048 x (512 + 64) x 2 B), 5,760 B a
               token, 0 launches of each of the four attention kernels
               (MLA runs plain PyTorch, as the reference's runs plain
               jnp); logged besides: each MoE layer's capacity drops at
               the engine's first prefill (request 0 in slot 0, token 0
               in the other 7 rows) and the profiled run's top 12
               kernels;
  8. card/cpu  the smoke config in f32 on the card and on the CPU (asked
               for explicitly) gives equal greedy streams and equal
               preemption, swap, refusal and prefix-hit counters, on the
               paged, int8 + prefix, tiered and int8 + tiered + prefix
               stacks (a 6-page hot tier: the tiered ones must preempt),
               and the same shed verdicts on the chunked shedding mix
               behind ``PolicyConfig(max_in_system=2, max_queue=4)``; the
               dense engine and the monolithic paged engine (paged, and
               int8 + tiered on a 4-page hot tier, which must preempt) on
               prompts of 3, 9, 5 and 12 tokens, and gemma3-27b's smoke
               config (window 8: two of them wrap their rings) through
               the dense engine on the same prompts; a two-replica prefix
               fleet with one kill and one respawn, whose streams, fleet
               counters and placements also equal on both devices, and
               whose streams equal one chunked engine's; the yi-34b,
               minitron-4b and granite-moe-3b-a800m smoke configs through
               the chunked engine, and granite's through the monolithic
               paged and dense engines on prompts of 3, 9, 5 and 12
               tokens, whose streams and counters equal on both devices;
               and the llama-3.2-vision-11b and whisper-medium smoke
               configs (every bias and norm perturbed) through the
               prefill / decode steps, 8-token prompts and 70 decode
               steps (whisper past its 64 learned positions): equal
               streams, logits within 1e-3 at every step; and the
               xlstm-1.3b and zamba2-1.2b smoke configs through the dense
               engine on prompts of 3, 9, 5 and 12 tokens in 4 slots and
               on six prompts of 33-70 tokens (past the smoke chunk of
               32) in 2 slots, whose streams and counters equal on both
               devices and whose slot-reuse streams each equal its
               request served alone; deepseek-v3-671b's smoke config on
               the same two mixes, streams and counters equal on both
               devices;
  9a. train qwen2-0.5b  the training path (launch/train.py ``train()``:
               train/step.py, the training forward with flash_xla, the
               loss, AdamW, checkpoints) on qwen2-0.5b at its published
               width, cut in depth to 8 of its 24 layers (``TRAIN``;
               d_model 896, 14/2 heads, d_ff 4864, vocab 151936; random
               weights, seed 0), f32 master weights, bf16
               compute, remat ``full``, sequence 4096 (the reference's
               train_4k), batch 4 in 2 microbatches: 3 steps with a
               checkpoint at step 2, then a second ``train()`` that
               restores it and runs step 3 again. Gates: finite losses,
               the resumed step 3's loss within 1e-3 of the first run's
               and resumed at data step 2, 0 launches of each of the
               hand-written kernels (the training path reaches none, as
               the reference's reaches no pallas_call). Logs each step's
               loss and ms (host clock, ending in a synchronize), the step
               time and tokens/s of the restarted step 3 (the one step run
               without the profiler after the warm-up), the peak memory,
               and the device's busy share over steps 2-3 (torch.profiler)
               with its top kernels;
  9b. train card/cpu  2 steps of ``make_train_step`` (``grad_accum`` 2,
               AdamW's default config) at the f32 smoke configs of
               qwen2-0.5b and deepseek-v3-671b (MLA, the MoE aux, MTP),
               from the same weights on the card (TF32 off) and the CPU:
               losses and grad norms within 1e-4 relative, every weight
               within 1e-4 relative (plus 2 x the two steps' learning
               rates), and the update itself: each element's change over
               a step within 1e-3 of lr (plus 2 f32 spacings of the new
               weight) and the moments within 1e-4 of each leaf's
               largest, but for the elements (at most 2 %, counted in the
               log) whose CPU gradient is nonzero and within 1e-4 of its
               leaf's largest, where Adam's step is the rounding's;
  10a. gpipe qwen2-0.5b  parallel/pipeline.py's ``gpipe`` over qwen2-0.5b's
               24 decoder layers at full width (d_model 896, 14/2 heads,
               d_ff 4864, bf16, seed 0; the no-cache training layer as
               ``layer_fn``) in 4 stages of 6 on 4 gloo ranks sharing the
               card, 8 microbatches of [1, 1024] hidden states: the
               outputs, the inputs' gradient and each stage's weight
               gradients of the backward of their sum held against the
               same layers applied in order on the card, within one bf16
               step of the value (bit for bit expected: the ring moves
               bytes); logs the largest difference, the 11 ticks, the
               bubble (3/11), each rank's wall and peak memory (gloo's
               transport: correctness only) and 0 launches of the
               kernels (gated);
  10b. moe mesh  the MoE's mesh paths at full width on 4 gloo ranks (model
               = 4): one deepseek-v3-671b MoE layer (256 experts, d 7168,
               expert d_ff 2048, 1 shared, sigmoid router; 22.5 GB of
               experts at bf16, each rank drawing only its 64 from
               per-expert seeds) on the gather / EP path and the a2a
               dispatch, and one granite-moe-3b-a800m layer (40 experts,
               ``ep=False``) on the slot-parallel path, over 8 x 256
               tokens; the meshless layer runs first in this process (its
               weights freed before the spawn): gather and slot-parallel
               within the all-reduce order's rounding bound of it (each
               element within (2k + 2) x 2^-8 of the sum of its terms'
               and shared output's magnitudes, k = top_k; the whole within
               1e-2 relative), a2a (routed per sequence shard, as the
               reference) with at least 95 % of elements within that bound
               (the reference's criterion) and every element within it of
               the meshless layer run on each sequence part alone, every
               rank's output equal; logs each path's drops beside the
               meshless drops, the largest difference and 0 launches;
  10c. fsdp qwen2-0.5b  FSDP data-parallel training through launch/train.py
               ``train`` on 2 gloo ranks sharing the card, phase 9a's
               config and data (batch 4 x 4096 in 2 microbatches, f32
               master weights, bf16 compute, remat full, TF32 off), 2
               steps: each step's loss and grad norm within 1e-3 relative
               of phase 9a's same step, the checkpoint the 2 ranks wrote
               restored at 1 rank equal bit for bit to each rank's shards
               (digests), 0 launches; logs each rank's peak memory and
               step times (gloo's transport: correctness only);
  10d. tp serve  the serving steps on a rank's shards (train/step.py
               ``init_shards`` / ``rank_caches``; parallel/mesh_jobs.py
               ``ServeJob``) on gloo ranks sharing the card, each rank
               drawing only its shards (seed 0, bf16) and, in bf16,
               also running the one-rank step itself
               (``TP_SERVE``), at full width under each arch's
               decode_32k cell's rules: qwen2-0.5b (``kv_seq`` → model)
               on (1, 4) (SP decode; q columns 3.5 heads a rank,
               gathered) and (2, 2) (the FSDP gather too; its kv heads
               on the model axis, head-aligned): a decode
               step at S 32768, B 8 over caches drawn N(0, 1), 7 slots at
               32767 and one at 100 (its later slices empty), and a
               prefill of B 2 x 2048 tokens; llama-3.2-vision-11b cut in
               depth to its first group (4 self + 1 cross layers; its 8
               kv heads do not cover the production model axis of 16, so
               ``kv_seq`` cuts the self caches' rows and the cross
               caches' 1600; a rule override keeps them whole on this
               smaller mesh too) on (1, 4): the same
               decode, and a prefill of B 2 x 256 tokens with 1600 stub
               patches; whisper-medium whole (its kv heads on the model
               axis) on (1, 4) and (2, 2): a decode at S 448 and a
               prefill of the 4-token start of transcript, B 2, through
               the encoder over 1500 stub frames on a rank's heads;
               and in f32 (TF32 off) on (1, 4) a decode step at S
               min(1024, S) of each of those, of granite-moe-3b-a800m
               at full width (experts whole, slot-parallel) and of
               deepseek-v3-671b cut in depth to 1 dense + 1 MoE layer
               (MTP head undrawn; the latents' rows on ``kv_seq``, slot 7's
               later slices empty; each rank draws its shards alone: the
               whole f32 weights on each of 4 ranks would not fit), both
               MoE archs at capacity factor E / top_k so that neither
               path drops a token, and in f32 alone, since in bf16 a
               rank's routing may flip against the one-rank step's and
               their own bf16 error bounds nothing; and the recurrent
               mixers (models/ssm.py on a rank's heads) at full width:
               xlstm-1.3b cut to one unit (7 mLSTM + 1 sLSTM layers;
               mLSTM projections cut over the model axis,
               its 4 heads' state a rank's on (1, 4) and whole on
               (2, 2)) on (1, 4) and (2, 2), and zamba2-1.2b (Mamba2 by
               heads; its shared attention sites' caches at S 8192) on
               (1, 4): a decode step over states and caches drawn
               N(0, 1) and a prefill of B 2 x 256 tokens, and in f32 on
               (1, 4) a decode of each; and gemma3-27b's rings cut over
               their rows (``kv_heads_tp`` None, ``shard_kv_seq``: one
               local + one global layer, f32 on (1, 4), a decode at S
               2048 past the local layer's 1024-row ring and a prefill
               of B 2 x 1024, gated at 1e-5). Gates, every rank: in
               bf16 its logits, against the
               one-rank step, within 3x that step's own bf16 error (the
               same step in f32 on the same values, run first in this
               process: largest element and norm), its cache parts
               within 3x the one-rank caches' bf16 error (the greedy
               tokens reported); in f32 its logits within 1e-4 of the
               largest one-rank f32 logit (element and norm) and the
               greedy token equal on every row whose one-rank top-2 gap
               passes twice that (at least one row); its kernel
               (flash_decode / flash_attention) launched, none on
               deepseek's or xlstm's path (MLA and the recurrent mixers
               are plain) and none inside a recurrent layer (zamba2's
               shared sites launch); and its collectives
               (kind, bytes, group, in order) equal to
               ``specs.trace_cell``'s of the same cell on the abstract
               mesh. First, ``flash_decode(..., return_lse=True)`` at a
               (1, 4) rank's shapes (qwen2's SP slice: B 8, H 14, K 2, S
               8192, hd 64, bf16, one slot empty; llama-vision's cross
               rows: B 8, H 32, K 8, S 400, hd 128) against its plain
               version (lse within 1e-3, NEG for an empty slot, the
               output the same bits as without the flag), timed beside
               the library's attention with its lse (``aten._scaled_dot_
               product_efficient_attention``, the lengths as a bias,
               held against plain) and its byte bound; and
               ``flash_attention`` at whisper's encoder on a (1, 4)
               rank's heads (B 2, H 4, 1500 frames, hd 64, non-causal)
               against plain, timed beside SDPA and its bound;
  10e. tp train  training with a model axis (train/step.py
               ``init_shards`` / ``init_state`` under the train_4k cell's
               rules, parallel/mesh_jobs.py ``FsdpJob``) on 4 gloo ranks
               of the card, each drawing its shards of the model seed 0
               gives, a piece of a leaf at a time: qwen2-0.5b at phase 9a's width, depth, data
               and optimizer (f32 master, bf16 compute, remat full, TF32
               off) on (data 2, model 2), two steps of 4 x 4096 in 2
               microbatches, each rank one row of each: heads, kv heads,
               the MLP's hidden and the vocabulary over model (the loss
               over the vocabulary line), the FSDP gather over data;
               losses and grad norms within 1e-3 relative of phase 9a's
               steps 1-2 (10c's gate), 0 kernel launches (the training
               attention is flash_xla, plain in both packages), each
               rank's peak memory logged; and qwen2's gradient norm of
               each weight at step 1, read from the ranks' first
               moments (m = (1 - b1)·scale·g), within 5e-2 of phase
               9a's; then in f32 (TF32 off) on (1, 4), at full width
               with depth cut (``TP_TRAIN_F32``): granite-moe-3b-a800m
               cut to 2 layers (its experts whole, slot-parallel; one
               step of 2 x 1024 tokens), whisper-medium whole (its
               encoder, cross and GELU layers; 2 x 448 tokens over 1500
               frames), zamba2-1.2b cut to one unit (5 Mamba2 layers and
               the shared block's site), xlstm-1.3b cut to one unit (7
               mLSTM + 1 sLSTM) and deepseek-v3-671b cut to one dense
               MLA layer, its MTP head undrawn (each 2 x 512 tokens),
               the last four after a fit check of the one-rank state
               (its parameter count and 24 B a parameter free): each
               one step, loss, nll (moe_aux) and grad norm
               within 1e-4 relative of the same step on one rank in
               this process, and each rank's weight, m and v shards
               after it against its slices of the one-rank state
               through their (Σx, Σ|x|, Σx²) in f64 (``FsdpJob``'s
               ``sums``: a rank's state is too large to carry back), Σx
               and Σ|x| within 1e-4 of Σ|x|, Σx² within 2e-4 of Σx², 0
               launches (their attention is flash_xla, their mixers and
               MLA plain, as the reference's are plain jnp); the ranks'
               allocators use expandable segments and give back a step's
               freed blocks before the fingerprints, so that four ranks
               near a quarter of the card each do not starve one another;
  11a. dma     ``core/dma.hero_memcpy2d`` (``csrc/hero_memcpy2d.cu``: rows
               staged through the TMA bulk copy of ``csrc/hero_dma.cuh``)
               against its plain version, the reference's sequential row
               loop, bit for bit: the main path's tile gather (4096 x 4096
               f32 out of a 4096 x 8192 matrix into a packed buffer, its
               one launch counted), odd offsets and strides with elems 1001
               in bf16, int8, f32 and f64, and overlapping destinations
               (dst stride < elems, and 0: the later row wins); the tile
               gather timed (kernel and a ``copy_`` between strided views
               from CUDA-graph replays, the plain loop with CUDA events)
               beside its bound (bytes read + written at 3.35 TB/s);
  11b. dryrun 1x1  the dry run's one-card check: ``launch/dryrun.run_cell``
               on a 1x1 mesh (the ``meta`` trace) for qwen2-0.5b
               decode_32k (B 128, S 32768: 51.54 GB of caches and 0.99 GB
               of weights) and xlstm-1.3b long_500k (B 1, state only), at
               full width, bf16, seed 0; the same arguments built on the
               card (bytes equal to the record's, gate), one step's FLOPs
               on the card (``core/perf.TraceCount``: ATen ops plus the
               kernels' own counts) equal to the trace's (gate), the step
               at cache_pos S - 1 timed (3 warm, 10 timed, CUDA events)
               beside the roofline bound, and one more warm step's temp
               on the card (its peak over the arguments less its logits)
               within 2 MiB + 1 % of the record's temp (gate: traced on
               meta, the storages the pass creates and the kernels'
               scratch at their launch), logged beside the allocator's
               rounding, the cuBLAS workspaces and the first call's
               one-time allocations;
  examples  examples/quickstart_torch.py and examples/serve_batch_torch.py
               through their ``main``, on the card (gates: the gemm
               within TF32's 5e-3 of the f64 oracle; every request
               served, flash_attention / flash_decode launched one a
               prefill / decode step a layer);
  12. a ``{"kernels": [...]}`` line (the paged kernels with phase 7's
     launches, as ``_int8`` with phase 7b's, as ``_yi34b``,
     ``_minitron4b``, ``_tp`` and ``_granite`` with phases 7f, 7g, 7h
     (rank 0's) and 7j's, each timed at its own phase 3 shape;
     flash_decode and flash_attention with phase 5's suite launches, and
     again as
     flash_decode_dense, flash_attention_dense and
     flash_attention_monolithic, each with the launches of its own 7e run
     and timed at 7e's shapes, and flash_decode_gemma3 and
     flash_attention_gemma3 with phase 7i's, timed at its local layers'
     shapes in phase 5; for 7k flash_attention_vlm_self,
     flash_decode_vlm_self, flash_attention_cross and flash_decode_cross,
     for 7l flash_attention_encoder, flash_attention_whisper_self,
     flash_decode_whisper_self, flash_attention_whisper_cross and
     flash_decode_whisper_cross, each with the launches of one kind of
     layer in its phase and timed at that kind's shape in phase 5; and
     flash_attention_zamba2 and flash_decode_zamba2 with phase 7n's
     launches, timed in phase 5; flash_decode_sp with the launches of
     phase 10d's (1, 4) qwen2-0.5b decode step on rank 0, timed with its
     lse at that rank's shape; flash_decode_cross_sp with the cross
     layer's launches of 10d's (1, 4) llama-3.2-vision-11b decode step on
     rank 0, timed with its lse at that rank's cross rows;
     flash_attention_encoder_tp with the encoder layers' launches of 10d's
     (1, 4) whisper-medium prefill on rank 0, timed at that rank's heads;
     flash_decode_softcap and flash_attention_softcap with the launches
     of 7e's capped dense run, timed with the cap in phase 5;
     hero_memcpy2d with phase 11a's; every entry launched at least
     once).
     The recurrent mixers of 7m / 7n (models/ssm.py) and 7o's MLA have
     no entry, nor has phase 9's training attention (models/flash_xla.py):
     the reference computes them in plain jnp / XLA and reaches no
     pallas_call, so the port runs them in plain PyTorch on the card by
     design (logged beside the line). Then
     the card's name and power limit, then ``{"ok": true, "device":
     {...}}`` as the last line.

Any failure exits non-zero before the last line. Without a card, or run
from a directory that lacks the repository's ``src/``, it fails too.
"""
from __future__ import annotations

import collections
import concurrent.futures
import copy
import dataclasses
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import repro_torch  # noqa: E402,F401  (fails outside a checkout of the repo)

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (data sheet)
F32_FLOP_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
TF32_FLOP_PER_S = 495e12        # H100 SXM dense TF32 tensor cores
BF16_FLOP_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
TOL = 2e-3
LAYERS = 24                     # qwen2-0.5b depth: timing cycles layer pools


def log(phase: str, msg: str) -> None:
    print(f"[chip_smoke:{phase}] {msg}", flush=True)


def cuda_ms(fn, iters: int = 20, warm: int = 3) -> float:
    """Mean ms per call of ``fn(i)`` over ``iters`` calls, CUDA events,
    after ``warm`` warm-up calls; ``i`` lets the caller cycle inputs (cold
    L2)."""
    for i in range(warm):
        fn(i)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(iters):
        fn(i)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(bytes_moved: float, flops: float, rate: float = F32_FLOP_PER_S):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------
def make_pool(g, P, K, pt, hd, dtype, layers=1):
    kp = torch.randn(layers, P, K, pt, hd, generator=g, device="cuda")
    vp = torch.randn(layers, P, K, pt, hd, generator=g, device="cuda")
    if dtype == torch.int8:
        out = []
        for x in (kp, vp):
            s = x.abs().amax(dim=(-1, -2)) / 127.0          # [layers, P, K]
            qx = torch.round(x / s[..., None, None]).clamp(-127, 127)
            out += [qx.to(torch.int8).contiguous(), s.contiguous()]
        return out
    return [kp.to(dtype).contiguous(), None, vp.to(dtype).contiguous(), None]


def make_tables(lengths, pt, max_pages, P, g):
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(1))
    table = torch.full((len(lengths), max_pages), -1, dtype=torch.int32)
    i = 0
    for b, n in enumerate(lengths):
        need = -(-n // pt)
        table[b, :need] = perm[i:i + need]
        i += need
    return table.cuda()


def check_kernels(results):
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    g = torch.Generator(device="cuda").manual_seed(0)
    timed = {"main": ("paged_flash_decode", "paged_flash_prefill"),
             "int8": ("paged_flash_decode_int8", "paged_flash_prefill_int8")}
    for name, suffix in (("yi-34b", "_yi34b"), ("minitron-4b", "_minitron4b"),
                         ("tp2-shard", "_tp"), ("granite-moe", "_granite")):
        timed[name] = ("paged_flash_decode" + suffix,
                       "paged_flash_prefill" + suffix)
    serving = [0, 1, 16, 17, 255, 256, 1000, 2048]
    cases = [  # name, H, K, hd, pt, page dtype, lengths, max_pages, chunks
        #        [, shards: the tp degree of a kv-head shard]
        ("main", 14, 2, 64, 16, torch.bfloat16,
         [0, 1, 16, 17, 255, 256, 1000, 2048], 128,
         [(1, 2047), (37, 100), (256, 1500), (256, 0)]),
        # yi-34b's decode step and chunk (G 7, hd 128), minitron-4b's (G 3)
        ("yi-34b", 56, 8, 128, 16, torch.bfloat16, serving, 128,
         [(1, 2047), (37, 100), (256, 1500)]),
        ("yi-34b-int8", 56, 8, 128, 16, torch.int8, serving, 128,
         [(1, 2047), (37, 100), (256, 1500)]),
        ("minitron-4b", 24, 8, 128, 16, torch.bfloat16, serving, 128,
         [(1, 2047), (256, 1500)]),
        # granite-moe-3b-a800m's (H 24, K 8: G 3 at hd 64)
        ("granite-moe", 24, 8, 64, 16, torch.bfloat16, serving, 128,
         [(1, 2047), (37, 100), (256, 1500)]),
        # one rank's kv-head shard of qwen2-0.5b at tp = 2 (K_local 1),
        # split as the unsharded call does
        ("tp2-shard", 7, 1, 64, 16, torch.bfloat16, serving, 128,
         [(1, 2047), (37, 100), (256, 1500)], 2),
        ("smoke", 4, 2, 16, 8, torch.float32, [0, 3, 8, 9, 31, 40, 63, 17],
         8, [(1, 0), (3, 5), (8, 56)]),
        ("int8", 14, 2, 64, 16, torch.int8,
         [0, 1, 16, 17, 255, 256, 1000, 2048], 128,
         [(1, 2047), (37, 100), (256, 1500)]),
        ("int8-ragged", 14, 2, 64, 16, torch.int8,
         [0, 7, 16, 33, 512, 513, 1999, 2048], 128,
         [(1, 2047), (37, 100), (256, 1500)]),
        ("f16", 14, 2, 64, 16, torch.float16,
         [0, 1, 15, 64, 300, 1024, 1999, 2048], 128,
         [(1, 2047), (37, 100), (256, 1500)]),
        ("pt8-hd128", 14, 2, 128, 8, torch.bfloat16,
         [0, 5, 8, 9, 300, 1001, 1777, 2048], 256,
         [(1, 2047), (37, 100), (256, 1500), (64, 3)]),
        ("int8-pt8-hd128", 14, 2, 128, 8, torch.int8,
         [0, 5, 8, 9, 300, 1001, 1777, 2048], 256,
         [(1, 2047), (37, 100), (256, 1500), (64, 3)]),
    ]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for name, H, K, hd, pt, dt, lengths, max_pages, chunks, *tp in cases:
        shards = tp[0] if tp else 1
        dec, pre = (results[n] for n in timed.get(
            name, timed["int8" if dt == torch.int8 else "main"]))
        B = len(lengths)
        P = sum(-(-n // pt) for n in lengths) + 4
        layers = LAYERS if name in timed else 1
        kp, ks, vp, vs = make_pool(g, P, K, pt, hd, dt, layers)
        table = make_tables(lengths, pt, max_pages, P, g)
        if dt == torch.int8:
            # a page whose scales are 0 (its payload left as it is): its
            # keys get logit 0 and value 0, in the kernels as in the plain
            # versions
            zero = int(table[int(np.argmax(lengths)), 1])
            ks[:, zero] = 0.0
            vs[:, zero] = 0.0
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        q = torch.randn(B, H, hd, generator=g, device="cuda")
        sc = (lambda x, i: None if x is None else x[i % layers])

        def dec_call(i, fn=pda.paged_flash_decode):
            kw = {"shards": shards} if fn is pda.paged_flash_decode else {}
            return fn(q, kp[i % layers], vp[i % layers], table, lens,
                      k_scale=sc(ks, i), v_scale=sc(vs, i), **kw)

        out = dec_call(0)
        torch.cuda.synchronize()
        err = (out - dec_call(0, pda.paged_flash_decode_plain)).abs().max()
        err = err.item()
        assert torch.isfinite(out).all() and err <= TOL, (name, err)
        assert out[0].abs().max().item() == 0.0, "length-0 slot not zero"
        dec["max_abs_err"] = max(dec["max_abs_err"], err)
        grid = pda.decode_grid(B, H, K, hd, max_pages, n_sm, shards)
        if shards > 1:     # the shard splits as the unsharded call does
            whole = pda.decode_grid(B, H * shards, K * shards, hd, max_pages,
                                    n_sm)
            assert grid[:2] == whole[:2], (grid, whole)
        log("kernels", f"decode {name}: B {B} H {H} K {K} hd {hd} pt {pt} "
            f"{str(dt)[6:]} pages, {grid.nsplit} splits of "
            f"{grid.pages_per_split} pages, {grid.blocks} blocks + merge "
            f"{B * H}, max |kernel - plain| {err:.3e}")
        if name == "main":
            assert grid.blocks >= n_sm, grid
        if name in timed:
            time_decode(dec, dec_call, q, kp, vp, ks, vs, table, lens,
                        lengths, K, pt, hd, layers)
        row = table[int(np.argmax(lengths))]  # the longest sequence's pages
        for C, start in chunks:
            q2 = torch.randn(C, H, hd, generator=g, device="cuda")

            def pre_call(i, fn=ppa.paged_flash_prefill):
                kw = {"shards": shards} \
                    if fn is ppa.paged_flash_prefill else {}
                return fn(q2, kp[i % layers], vp[i % layers], row, start,
                          k_scale=sc(ks, i), v_scale=sc(vs, i), **kw)

            out = pre_call(0)
            torch.cuda.synchronize()
            err = (out - pre_call(0, ppa.paged_flash_prefill_plain)).abs()
            err = err.max().item()
            assert torch.isfinite(out).all() and err <= TOL, (name, C, err)
            pre["max_abs_err"] = max(pre["max_abs_err"], err)
            grid = ppa.prefill_grid(C, H, K, hd, pt, max_pages, start, n_sm,
                                    dt, shards)
            kind = ("tensor cores" if dt in ppa.TENSOR_CORE_DTYPES
                    else "CUDA cores")
            log("kernels", f"prefill {name}: C {C} start {start}, {kind}, "
                f"{grid.nsplit} splits of {grid.tiles_per_split} key tiles, "
                f"{grid.blocks} blocks"
                f"{f' + merge {C * H}' if grid.nsplit > 1 else ''}, max "
                f"|kernel - plain| {err:.3e}")
            if (C, start) == (256, 1500):
                assert dt == torch.float32 or grid.blocks >= n_sm, grid
                if name in timed:
                    time_prefill(pre, pre_call, q2, kp, vp, ks, vs, row,
                                 start, K, pt, hd, layers)


def dense_pool(pages, scales, layer):
    """One layer's pool as the SDPA yardstick reads it: bf16 / f16 pages
    as they are, int8 pages dequantized to bf16 beforehand."""
    from repro_torch.kernels import paged_decode_attention as pda
    if scales is None:
        return pages[layer]
    return pda.dequant_pages(pages[layer], scales[layer]).bfloat16()


def time_decode(res, call, q, kp, vp, ks, vs, table, lens, lengths, K, pt,
                hd, layers):
    """Kernel and the SDPA yardstick: device time of 20 calls replayed from
    one CUDA graph (kernel_suite.graph_ms), cycling the layer pools; plain:
    CUDA events around eager calls. int8 pages: the yardstick reads K / V
    dequantized to bf16 beforehand, and the bytes count the scale rows."""
    import itertools
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.launch.kernel_suite import graph_ms
    B, H, _ = q.shape
    G = H // K
    cyc = itertools.cycle(range(layers))
    res["ms"] = graph_ms(lambda: call(next(cyc)), 20)
    res["plain_ms"] = cuda_ms(lambda i: call(i, pda.paged_flash_decode_plain))
    # yardstick: SDPA over K/V gathered dense beforehand (no page walk)
    S = table.shape[1] * pt
    kd = [pda.gather_pages(dense_pool(kp, ks, i), table)
          for i in range(layers)]
    vd = [pda.gather_pages(dense_pool(vp, vs, i), table)
          for i in range(layers)]
    qb = q.to(kd[0].dtype)[:, :, None]                     # [B, H, 1, hd]
    mask = (torch.arange(S, device="cuda")[None] <
            lens[:, None])[:, None, None]

    def sdpa(i):
        return F.scaled_dot_product_attention(qb, kd[i], vd[i],
                                              attn_mask=mask, enable_gqa=True)

    res["library_ms"] = graph_ms(lambda: sdpa(next(cyc)), 20)
    page_rows = sum(-(-n // pt) * pt for n in lengths)
    nbytes = (K * page_rows * hd * 2 * kp.element_size()
              + 2 * q.numel() * 4 + table.numel() * 4 + lens.numel() * 4)
    if ks is not None:
        nbytes += 2 * K * (page_rows // pt) * 4
    flops = 4 * G * K * hd * sum(lengths)
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops)
    log("kernels", f"decode {str(kp.dtype)[6:]} pages timing: kernel "
        f"(graph) {res['ms']:.4f} "
        f"ms, plain {res['plain_ms']:.4f} ms, sdpa yardstick (graph) "
        f"{res['library_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}: {nbytes} B at 3.35 TB/s, {flops} flop at 67 "
        "TFLOP/s f32)")


def time_prefill(res, call, q, kp, vp, ks, vs, row, start, K, pt, hd,
                 layers):
    """Timed as :func:`time_decode`; the bound takes the bf16 tensor-core
    rate, at which the kernel multiplies bf16 and int8 pages (int8 widened
    to bf16)."""
    import itertools
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.launch.kernel_suite import graph_ms
    C, H, _ = q.shape
    cyc = itertools.cycle(range(layers))
    res["ms"] = graph_ms(lambda: call(next(cyc)), 20)
    res["plain_ms"] = cuda_ms(lambda i: call(i,
                                             ppa.paged_flash_prefill_plain))
    kd = [pda.gather_pages(dense_pool(kp, ks, i), row[None])
          for i in range(layers)]
    vd = [pda.gather_pages(dense_pool(vp, vs, i), row[None])
          for i in range(layers)]
    S = row.shape[0] * pt
    qb = q.to(kd[0].dtype).transpose(0, 1)[None]           # [1, H, C, hd]
    mask = (torch.arange(S, device="cuda")[None] <=
            start + torch.arange(C, device="cuda")[:, None])

    def sdpa(i):
        return F.scaled_dot_product_attention(qb, kd[i], vd[i],
                                              attn_mask=mask, enable_gqa=True)

    res["library_ms"] = graph_ms(lambda: sdpa(next(cyc)), 20)
    rows = -(-(start + C) // pt) * pt
    nbytes = (K * rows * hd * 2 * kp.element_size() + 2 * q.numel() * 4
              + row.numel() * 4)
    if ks is not None:
        nbytes += 2 * K * (rows // pt) * 4
    flops = 4 * H * hd * sum(start + c + 1 for c in range(C))
    assert kp.dtype in (torch.bfloat16, torch.int8), "the rate is bf16's"
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops, BF16_FLOP_PER_S)
    log("kernels", f"prefill {str(kp.dtype)[6:]} pages timing (C {C}, "
        f"start {start}): kernel "
        f"(graph) {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, sdpa "
        f"yardstick (graph) {res['library_ms']:.4f} ms, bound "
        f"{res['bound_ms']:.4f} ms ({res['bound_by']}: {nbytes} B at 3.35 "
        f"TB/s, {flops} flop at 989 TFLOP/s bf16)")


# --------------------------------------------------------------------------
# phases 4 and 5: the AutoDMA kernel suite
# --------------------------------------------------------------------------
SUITE_MODES = ("unmodified", "paper", "autodma", "handwritten")
RAGGED_MODES = ("unmodified", "autodma", "handwritten")
RAGGED_GEMM, RAGGED_MATVEC = (1000, 600, 1100), (1000, 1500)
RAGGED_CONV, RAGGED_COVAR = (1001, 1500), (1000, 600)
RAGGED_CONV_SCALAR = (999, 1001)   # f32 W % 4 = 1; RAGGED_CONV bf16 W % 8 = 4
BODIES = ("mxu", "vpu", "loop")
BF16_TOL = 1e-2                 # bf16 output rounded every reduction step
MXU_F32_TOL = 5e-3              # TF32 operands: a 10-bit mantissa
F32_TOL = 1e-5                  # f32 sums taken in another order


def rel_err(out, ref) -> float:
    return ((out.float() - ref.float()).norm() / ref.float().norm()).item()


def hold(rows, out, ref, tol, what):
    """Fail unless ``out`` is finite and within ``tol`` (relative Frobenius)
    of ``ref``; record the max abs error on every row in ``rows``."""
    err = rel_err(out, ref)
    abs_err = (out.float() - ref.float()).abs().max().item()
    assert torch.isfinite(out.float()).all() and err <= tol, (what, err, tol)
    for r in rows:
        r["max_abs_err"] = max(r["max_abs_err"], abs_err)
    log("suite kernels", f"{what}: rel err {err:.2e} (tol {tol:g}), max "
        f"|kernel - plain| {abs_err:.3e}")


def replay_equals_eager(call, eager, what, phase="suite kernels"):
    """Fail unless ``call()`` captured in a CUDA graph and replayed twice
    gives ``eager`` bit for bit (graph safety, run-to-run determinism)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager), (what, "graph replay")
    log(phase, f"{what}: two graph replays equal the eager call bit for "
        "bit")


def check_suite_kernels(results):
    import functools
    from repro_torch.core import autodma
    from repro_torch.kernels import gemm as tg
    from repro_torch.kernels import polybench as pb
    from repro_torch.kernels import tiled
    from repro_torch.launch.kernel_suite import HANDWRITTEN_TILES
    g = torch.Generator(device="cuda").manual_seed(2)
    builder = results["autodma_tiled"]
    f32, bf16 = torch.float32, torch.bfloat16
    gemm_cases = [  # shape, dtype, alpha, bodies, modes, handwritten tiles
        ((2048, 2048, 2048), f32, 1.0, BODIES, SUITE_MODES,
         HANDWRITTEN_TILES),
        ((1024, 1024, 4608), f32, 1.0, BODIES, SUITE_MODES,
         HANDWRITTEN_TILES),
        ((2048, 2048, 2048), bf16, 1.0, ("mxu",), SUITE_MODES,
         HANDWRITTEN_TILES),
        ((2048, 2048, 2048), bf16, 1.0, ("vpu", "loop"), ("autodma",), None),
        # ragged: no tile divides 1000 x 600 x 1100, so autodma degrades to
        # granule tiles and the last block of every axis is short; paper's
        # rule falls back to whole axes, which shared memory cannot hold
        (RAGGED_GEMM, f32, 0.5, BODIES, RAGGED_MODES, (48, 80, 96)),
        (RAGGED_GEMM, bf16, 0.5, BODIES, RAGGED_MODES, (48, 80, 96)),
    ]
    for (M, N, K), dt, alpha, bodies, modes, hw in gemm_cases:
        A = torch.randn(M, K, generator=g, device="cuda").to(dt)
        B = torch.randn(K, N, generator=g, device="cuda").to(dt)
        for body in bodies:
            tol = BF16_TOL if dt == bf16 else (
                MXU_F32_TOL if body == "mxu" else F32_TOL)
            for mode in modes:
                kw = (dict(handwritten_tiles=hw) if mode == "handwritten"
                      else dict(mode=mode))
                out, plan = tg.gemm(A, B, alpha=alpha, body=body, **kw)
                torch.cuda.synchronize()
                plain = autodma.walk(functools.partial(
                    tg.BODIES[body], alpha=alpha), plan, A, B)
                hold([builder, results["gemm"]], out, plain, tol,
                     f"gemm {M}x{N}x{K} {str(dt)[6:]} {body} {mode} tiles "
                     f"{plan.tiles}")
        if (M, N, K) == RAGGED_GEMM:  # a plan over the limit: raise, no fallback
            try:
                tg.gemm(A, B, mode="paper")
            except ValueError as e:
                log("suite kernels", f"gemm {M}x{N}x{K} paper refused: {e}")
            else:
                raise AssertionError("an over-budget plan was launched")
    bodies = {"matvec": pb._matvec_body, "matvec_t": pb._matvec_t_body}
    for (M, N), dt, modes in [((2048, 2048), f32, SUITE_MODES[:3]),
                              ((2048, 2048), bf16, SUITE_MODES[:3]),
                              (RAGGED_MATVEC, f32, RAGGED_MODES[:2])]:
        A = torch.randn(M, N, generator=g, device="cuda").to(dt)
        x = torch.randn(N, generator=g, device="cuda").to(dt)
        xt = torch.randn(M, generator=g, device="cuda").to(dt)
        for name, v in (("matvec", x), ("matvec_t", xt)):
            if (M, N) == RAGGED_MATVEC:
                try:
                    getattr(pb, name)(A, v, mode="paper")
                except ValueError as e:
                    log("suite kernels", f"{name} {M}x{N} paper refused: {e}")
                else:
                    raise AssertionError("an over-budget plan was launched")
            for mode in modes:
                y, plan = getattr(pb, name)(A, v, mode=mode)
                torch.cuda.synchronize()
                plain = autodma.walk(bodies[name], plan, A, v)
                what = f"{name} {M}x{N} {str(dt)[6:]} {mode}"
                hold([builder, results[name]], y, plain,
                     BF16_TOL if dt == bf16 else F32_TOL,
                     f"{what} tiles {plan.tiles}")
                replay_equals_eager(lambda: getattr(pb, name)(A, v,
                                                              mode=mode)[0],
                                    y, what)
                lay = tiled.layout(name, plan)
                inst = (f"{name} {'f32' if dt == f32 else 'bf16'} "
                        f"{'staged' if lay['staged'] else 'unstaged'}")
                log("suite kernels", f"{what}: {lay['blocks']} tiles x ks "
                    f"{lay['ks']} = {lay['blocks'] * lay['ks']} blocks of "
                    f"{lay['threads']} threads, {lay['smem']} B shared "
                    f"memory; {inst}: {INSTANCES.get(inst, 'not built here')}")
    c = torch.randn(3, 3, generator=g, device="cuda")
    paths = set()
    for (H, W), dt, modes in [((2048, 2048), f32, SUITE_MODES[:3]),
                              ((2048, 2048), bf16, ("autodma",)),
                              (RAGGED_CONV, f32, ("autodma",)),
                              (RAGGED_CONV, bf16, ("autodma",)),
                              (RAGGED_CONV_SCALAR, f32, ("autodma",))]:
        A = torch.randn(H, W, generator=g, device="cuda").to(dt)
        plain = pb.conv2d_plain(A, c, pb.conv2d_row_tile(H, W))
        shape = pb.conv2d_launch(H, W, dt)
        path = "16-byte" if shape.vec > 1 else "scalar"
        paths.add(path)
        inst = f"conv2d {'f32' if dt == f32 else 'bf16'} vec {shape.vec}"
        for mode in modes:   # one kernel in every mode: the plan changes
            out, plan = pb.conv2d(A, c, mode=mode)
            torch.cuda.synchronize()
            what = (f"conv2d {H}x{W} {str(dt)[6:]} {mode} (row tile "
                    f"{pb.conv2d_row_tile(H, W)}, plan tiles {plan.tiles}; "
                    f"{path} path: bands of {shape.band} rows, "
                    f"{shape.blocks} blocks; {inst}: "
                    f"{INSTANCES.get(inst, 'not built here')})")
            hold([results["conv2d"]], out, plain,
                 BF16_TOL if dt == bf16 else F32_TOL, what)
            if dt == f32:    # the same products and sums: the same bits
                assert torch.equal(out, plain), (what, "not bit for bit")
                log("suite kernels", f"conv2d {H}x{W} f32 {mode}: equal to "
                    "the row-tile walk bit for bit")
    assert paths == {"16-byte", "scalar"}, paths
    for (M, N), modes in [((2048, 2048), SUITE_MODES[:3]),
                          (RAGGED_COVAR, RAGGED_MODES[:2])]:
        D = torch.randn(M, N, generator=g, device="cuda")
        if (M, N) == RAGGED_COVAR:   # paper's whole-axis blocks: must raise
            try:
                pb.covar(D, mode="paper")
            except ValueError as e:
                log("suite kernels", f"covar {M}x{N} paper refused: {e}")
            else:
                raise AssertionError("an over-budget plan was launched")
        for mode in modes:
            out, (p1, p2) = pb.covar(D, mode=mode)
            torch.cuda.synchronize()
            plain = pb.covar_plain(D, p1, p2)
            hold([builder, results["covar"]], out, plain, MXU_F32_TOL,
                 f"covar {M}x{N} f32 {mode} tiles {p1.tiles} / {p2.tiles}")
    torch.cuda.synchronize()
    time_suite_kernels(results)


def _library_tf32(fn):
    """Time a yardstick under TF32, as the mxu body computes."""
    from repro_torch.launch.kernel_suite import graph_ms
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return graph_ms(fn, 20)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def time_suite_kernels(results):
    """Kernel and yardstick: device time of 20 calls replayed from a CUDA
    graph (kernel_suite.graph_ms), as the kernel suite times (torch.cov,
    which waits on the host, with CUDA events around eager calls); plain:
    CUDA events around calls of the grid walker, whose many small launches
    the host issues one by one."""
    import functools
    import itertools
    from repro_torch.core import autodma
    from repro_torch.kernels import gemm as tg
    from repro_torch.kernels import polybench as pb
    from repro_torch.kernels import tiled
    from repro_torch.launch.kernel_suite import graph_ms
    g = torch.Generator(device="cuda").manual_seed(3)
    mxu = functools.partial(tg.BODIES["mxu"], alpha=1.0)
    # gemm 2048^3 (autodma, mxu) and the builder at darknet's conv-as-gemm
    for name, (M, N, K) in (("gemm", (2048, 2048, 2048)),
                            ("autodma_tiled", (1024, 1024, 4608))):
        res = results[name]
        A = torch.randn(M, K, generator=g, device="cuda")
        B = torch.randn(K, N, generator=g, device="cuda")
        if name == "gemm":
            _, plan = tg.gemm(A, B)
            res["ms"] = graph_ms(lambda: tg.gemm(A, B), 20)
        else:
            call, plan = autodma.tiled_call(
                autodma.Body("gemm_mxu", mxu), autodma.matmul_spec(M, N, K))
            res["ms"] = graph_ms(lambda: call(A, B), 20)
        res["plain_ms"] = cuda_ms(lambda i: autodma.walk(mxu, plan, A, B),
                                  iters=2, warm=1)
        res["library_ms"] = _library_tf32(lambda: torch.matmul(A, B))
        nbytes = (M * K + K * N + M * N) * 4
        res["bound_ms"], res["bound_by"] = bound(nbytes, 2 * M * N * K,
                                                 TF32_FLOP_PER_S)
        lay = tiled.layout("gemm_mxu", plan)
        log("suite kernels", f"{name} {M}x{N}x{K} f32 mxu autodma tiles "
            f"{plan.tiles} ({lay['threads'] // 32} warps of "
            f"{16 * lay['fpw']}x32, {lay['npass']} pass): kernel "
            f"{res['ms']:.4f} ms, plain "
            f"{res['plain_ms']:.4f} ms, torch.matmul (TF32) yardstick "
            f"{res['library_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
            f"({res['bound_by']}: {nbytes} B at 3.35 TB/s, "
            f"{2 * M * N * K} flop at 495 TFLOP/s TF32)")
    # matvec / matvec_t at 2048^2, cycling 4 matrices (64 MB > 50 MB L2)
    M = N = 2048
    As = [torch.randn(M, N, generator=g, device="cuda") for _ in range(4)]
    x = torch.randn(N, generator=g, device="cuda")
    for name, body, lib in (
            ("matvec", pb._matvec_body, lambda a: torch.mv(a, x)),
            ("matvec_t", pb._matvec_t_body, lambda a: torch.mv(a.t(), x))):
        res, fn = results[name], getattr(pb, name)
        _, plan = fn(As[0], x)
        cycle = itertools.cycle(As)     # each captured call reads the next
        res["ms"] = graph_ms(lambda: fn(next(cycle), x), 20)
        res["plain_ms"] = cuda_ms(
            lambda i: autodma.walk(body, plan, As[i % 4], x), iters=4,
            warm=1)
        res["library_ms"] = graph_ms(lambda: lib(next(cycle)), 20)
        nbytes = (M * N + M + N) * 4
        res["bound_ms"], res["bound_by"] = bound(nbytes, 2 * M * N)
        log("suite kernels", f"{name} {M}x{N} f32 autodma tiles "
            f"{plan.tiles}: kernel {res['ms']:.4f} ms, plain "
            f"{res['plain_ms']:.4f} ms, torch.mv yardstick "
            f"{res['library_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
            f"({res['bound_by']}: {nbytes} B at 3.35 TB/s)")
    # conv2d at 2048^2 f32 (row tile 8), cycling the 4 matrices
    cycle = itertools.cycle(As)
    res = results["conv2d"]
    c = torch.randn(3, 3, generator=g, device="cuda")
    bh = pb.conv2d_row_tile(M, N)
    res["ms"] = graph_ms(lambda: pb.conv2d(next(cycle), c), 20)
    res["plain_ms"] = cuda_ms(lambda i: pb.conv2d_plain(As[i % 4], c, bh),
                              iters=2, warm=1)
    w = c[None, None].contiguous()                         # [1, 1, 3, 3]
    res["library_ms"] = graph_ms(
        lambda: F.conv2d(next(cycle)[None, None], w, padding=1), 20)
    nbytes = 2 * M * N * 4 + 9 * 4
    res["bound_ms"], res["bound_by"] = bound(nbytes, 18 * M * N)
    shape = pb.conv2d_launch(M, N)
    log("suite kernels", f"conv2d {M}x{N} f32 row tile {bh} (kernel: bands "
        f"of {shape.band} rows, {shape.blocks} blocks): kernel "
        f"{res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, F.conv2d "
        f"(cuDNN, TF32 off) yardstick {res['library_ms']:.4f} ms, bound "
        f"{res['bound_ms']:.4f} ms ({res['bound_by']}: {nbytes} B at 3.35 "
        f"TB/s, {18 * M * N} flop at 67 TFLOP/s f32)")
    # covar at 2048^2 f32, autodma: mean, center, gram (TF32)
    res = results["covar"]
    _, (p1, p2) = pb.covar(As[0])
    res["ms"] = graph_ms(lambda: pb.covar(next(cycle)), 20)
    res["plain_ms"] = cuda_ms(lambda i: pb.covar_plain(As[i % 4], p1, p2),
                              iters=1, warm=1)
    # torch.cov waits on the host inside, so it cannot be graphed: CUDA
    # events around eager calls, under TF32 as the gram computes
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        res["library_ms"] = cuda_ms(lambda i: torch.cov(As[i % 4].T))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    nbytes = (M * N + N * N) * 4
    flops = 2 * N * N * M
    t_ops = (flops / TF32_FLOP_PER_S + 2 * M * N / F32_FLOP_PER_S) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    res["bound_ms"], res["bound_by"] = ((t_ops, "operations")
                                        if t_ops >= t_bytes
                                        else (t_bytes, "bytes"))
    log("suite kernels", f"covar {M}x{N} f32 autodma tiles {p1.tiles} / "
        f"{p2.tiles}: kernel {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, torch.cov (TF32, eager) yardstick "
        f"{res['library_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}: {flops} flop at 495 TFLOP/s TF32 + "
        f"{2 * M * N} at 67 TFLOP/s f32; {nbytes} B at 3.35 TB/s)")


# --------------------------------------------------------------------------
# phase 5: the attention kernels against their plain versions
# --------------------------------------------------------------------------
def bf16_step(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x|: 2^(e - 7) for |x| in [2^e,
    2^(e+1)) (2^-8 to 2^-7 of |x|), 0 at 0."""
    x = x.float().abs()
    e = torch.floor(torch.log2(x.clamp_min(2.0**-126)))
    return torch.where(x > 0, torch.exp2(e - 7), 0.0)


def close(out, plain, tol: float = TOL) -> float:
    """Fail unless ``out`` is finite and within ``tol`` of ``plain`` plus,
    for bf16, one bf16 rounding step of the value (both sides round an f32
    result to bf16: two f32 values a few ulp apart on either side of a
    midpoint land one step apart); returns max |diff|."""
    diff = (out.float() - plain.float()).abs()
    lim = tol + (bf16_step(plain) if plain.dtype == torch.bfloat16 else 0.0)
    assert torch.isfinite(out.float()).all() and bool((diff <= lim).all()), \
        (diff.max().item(), tol)
    return diff.max().item()


def check_attention_kernels(results):
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.kernel_suite import (ATTENTION, DECODE,
                                                 decode_lengths)
    g = torch.Generator(device="cuda").manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    dec, att = results["flash_decode"], results["flash_attention"]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    B, H, K, S, hd = DECODE
    main_lens = decode_lengths(B, S)
    cases = [((B, H, K, S, hd), bf16, main_lens),
             ((B, H, K, S, hd), f32, main_lens),
             ((2, 8, 2, 256, 64), f32, [0, 200]),
             ((1, 4, 4, 512, 128), f32, [512]),
             ((3, 6, 3, 384, 64), f32, [383, 0, 17]),
             ((2, 4, 2, 100, 32), bf16, [0, 99]),
             ((4, 4, 2, 64, 16), f32, [4, 0, 13, 64])]   # the smoke width
    for (B_, H_, K_, S_, hd_), dt, lens in cases:
        q = torch.randn(B_, H_, hd_, generator=g, device="cuda").to(dt)
        kc, vc = (torch.randn(B_, K_, S_, hd_, generator=g, device="cuda")
                  .to(dt) for _ in range(2))
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        out = da.flash_decode(q, kc, vc, lengths)
        torch.cuda.synchronize()
        err = close(out, da.flash_decode_plain(q, kc, vc, lengths))
        for b in [i for i, n in enumerate(lens) if n == 0]:
            mean_v = vc[b].float().mean(dim=1).repeat_interleave(H_ // K_, 0)
            close(out[b], mean_v.to(dt))
        dec["max_abs_err"] = max(dec["max_abs_err"], err)
        launch = da.decode_launch(B_, H_, K_, S_, hd_, n_sm)
        log("attention kernels", f"flash_decode B {B_} H {H_} K {K_} S {S_} "
            f"hd {hd_} {str(dt)[6:]} lengths {lens}: one launch of "
            f"{launch.nsplit} splits of {launch.chunk} keys x {B_ * K_} "
            f"(slot, kv head) x {launch.groups} row groups = "
            f"{launch.blocks} blocks, merged by the last block of each; "
            f"max |kernel - plain| {err:.3e}")
        if (B_, H_, K_, S_, hd_) == DECODE and dt == bf16:
            inst = f"flash_decode bf16 hd {hd_}"
            n0 = da.flash_decode.launches
            replay_equals_eager(lambda: da.flash_decode(q, kc, vc, lengths),
                                out, f"flash_decode main shape bf16 "
                                f"({launch.blocks} blocks, "
                                f"{launch.blocks / n_sm:.2f} an SM; {inst}: "
                                f"{INSTANCES.get(inst, 'not built here')})",
                                "attention kernels")
            assert da.flash_decode.launches == n0 + 1, "one launch a call"
    time_decode_dense(dec, DECODE, main_lens, g)
    small = [  # (B, H, L, Lk, hd), causal, window, softcap; bf16 and f32
        ((2, 4, 256, 256, 32), False, None, 20.0),
        ((2, 4, 128, 128, 128), True, 64, 20.0),
        ((1, 2, 256, 256, 64), False, 48, 5.0),
        ((1, 2, 256, 128, 64), True, 32, None),    # rows that see no key
        ((1, 2, 200, 130, 64), False, None, None),
        ((1, 3, 300, 300, 32), True, None, None),
        ((1, 2, 384, 384, 128), True, 100, None)]
    main = [((B_, H_, L, L, hd_), causal, window, None, bf16)
            for B_, H_, L, hd_, causal, window in ATTENTION.values()]
    cases = main + [c + (dt,) for c in small for dt in (bf16, f32)]
    # hd 16 (the smoke configuration's width; the f32 kernel only)
    cases += [((3, 4, 45, 45, 16), True, None, None, f32),
              ((1, 4, 200, 200, 16), False, 48, 5.0, f32)]
    for (B_, H_, L, Lk, hd_), causal, window, softcap, dt in cases:
        q = torch.randn(B_, H_, L, hd_, generator=g, device="cuda").to(dt)
        k, v = (torch.randn(B_, H_, Lk, hd_, generator=g, device="cuda")
                .to(dt) for _ in range(2))
        kw = dict(causal=causal, window=window, softcap=softcap)
        out = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        err = close(out, fa.flash_attention_plain(q, k, v, **kw))
        att["max_abs_err"] = max(att["max_abs_err"], err)
        shape = fa.launch_shape(L, hd_, dt)
        log("attention kernels", f"flash_attention B {B_} H {H_} L {L} Lk "
            f"{Lk} hd {hd_} {str(dt)[6:]} causal {causal} window {window} "
            f"softcap {softcap}: "
            f"{'tensor cores' if dt == bf16 else 'CUDA cores'}, "
            f"{shape.blocks * B_ * H_} blocks of {shape.threads} threads, "
            f"{shape.smem} B shared; max |kernel - plain| {err:.3e}")
        if (B_, H_, L, Lk, hd_) == (1, 14, 2048, 2048, 64):
            time_flash(att, q, k, v, causal, window)
        elif Lk == L and L >= 4096:
            time_flash({}, q, k, v, causal, window)
    check_gemma3_attention(results, g)
    check_cross_attention(results, g)
    check_zamba2_attention(results, g)
    check_softcap_attention(results, g)


GEMMA3 = dict(H=32, K=16, hd=128, window=1024)   # gemma3-27b's attention
SOFTCAP = 5.0     # the capped cases' logit_softcap (phases 5 and 7e)


def check_softcap_attention(results, g):
    """Both dense kernels with a logit softcap (``SOFTCAP``) against their
    plain versions: flash_decode (and its lse) at qwen2-0.5b's dense
    decode shape (``DECODE``, the serving lengths) and at gemma3-27b's
    global decode shape (B 8, H 32, K 16, S 2048, hd 128, phase 7i's
    lengths), flash_attention at qwen2-0.5b's dense prefill shape (B 1, H
    14, L 2048, hd 64, causal); the qwen2 shapes give the ``_softcap``
    entries their times (gemma3's is held, not timed)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.kernel_suite import (ATTENTION, DECODE,
                                                 decode_lengths)
    bf16 = torch.bfloat16
    lens7, _ = phase7_prompts(16)
    gl = (8, GEMMA3["H"], GEMMA3["K"], 2 * GEMMA3["window"], GEMMA3["hd"])
    # (shape, lengths, the results entry it is timed for or None, what)
    for shape, lengths, res, what in (
            (DECODE, decode_lengths(DECODE[0], DECODE[3]),
             results["flash_decode_softcap"], "qwen2-0.5b dense decode"),
            (gl, [int(n) + 63 for n in lens7], None,
             "gemma3-27b global decode")):
        B, H, K, S, hd = shape
        q = torch.randn(B, H, hd, generator=g, device="cuda").to(bf16)
        kc, vc = (torch.randn(B, K, S, hd, generator=g, device="cuda")
                  .to(bf16) for _ in range(2))
        lt = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        out, lse = da.flash_decode(q, kc, vc, lt, return_lse=True,
                                   softcap=SOFTCAP)
        p_out, p_lse = da.flash_decode_plain(q, kc, vc, lt, return_lse=True,
                                             softcap=SOFTCAP)
        err = close(out, p_out)
        seen = lt > 0
        lse_err = float((lse[seen] - p_lse[seen]).abs().max())
        assert lse_err <= 1e-3, (what, lse_err)
        moved = float((out.float() - da.flash_decode(q, kc, vc, lt).float())
                      .abs().max())
        log("attention kernels", f"{what} with softcap {SOFTCAP}: "
            f"flash_decode B {B} H {H} K {K} S {S} hd {hd} bf16 lengths "
            f"{lengths}: max |kernel - plain| {err:.3e} "
            f"(2e-3 + one bf16 step), lse within {lse_err:.3e} of plain "
            f"(gate 1e-3); the cap moves the output by up to {moved:.3e}")
        if res is not None:
            res["max_abs_err"] = err
            time_decode_dense(res, shape, lengths, g, SOFTCAP)
    B, H, L, hd, causal, window = ATTENTION["qwen2-0.5b"]
    q, k, v = (torch.randn(B, H, L, hd, generator=g, device="cuda").to(bf16)
               for _ in range(3))
    kw = dict(causal=causal, window=window, softcap=SOFTCAP)
    res = results["flash_attention_softcap"]
    res["max_abs_err"] = close(fa.flash_attention(q, k, v, **kw),
                               fa.flash_attention_plain(q, k, v, **kw))
    log("attention kernels", f"qwen2-0.5b dense prefill with softcap "
        f"{SOFTCAP}: flash_attention B {B} H {H} L {L} hd {hd} bf16 causal: "
        f"max |kernel - plain| {res['max_abs_err']:.3e} (2e-3 + one bf16 "
        "step)")
    time_flash(res, q, k, v, causal, window, softcap=SOFTCAP)


def check_gemma3_attention(results, g):
    """Both attention kernels at gemma3-27b's serving shapes (phase 7i's
    traffic): flash_attention at the longest prompt's prefill (B 1, H 32,
    L 1326, hd 128, bf16, causal) with window 1024 (a local layer) and
    without (a global one, kv heads repeated: G 2); flash_decode at the
    decode step (B 8, H 32, K 16, hd 128) over the rings (S 1024: lengths
    min(prompt + 63, 1024), the two prompts past the window wrapped; and a
    free slot at length 1) and the global caches (S 2048). Each against
    its plain version, timed beside SDPA; the local shapes give the
    ``_gemma3`` entries their times."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    bf16 = torch.bfloat16
    H, K, hd, W = GEMMA3["H"], GEMMA3["K"], GEMMA3["hd"], GEMMA3["window"]
    lens, _ = phase7_prompts(16)
    L = int(max(lens))
    q, k, v = (torch.randn(1, H, L, hd, generator=g, device="cuda").to(bf16)
               for _ in range(3))
    for window, res in ((W, results["flash_attention_gemma3"]), (None, {})):
        kw = dict(causal=True, window=window)
        err = close(fa.flash_attention(q, k, v, **kw),
                    fa.flash_attention_plain(q, k, v, **kw))
        res["max_abs_err"] = err
        log("attention kernels", f"gemma3-27b {'local' if window else 'global'}"
            f" prefill: flash_attention B 1 H {H} L {L} hd {hd} bf16 causal "
            f"window {window}: max |kernel - plain| {err:.3e}")
        time_flash(res, q, k, v, True, window)
    B = 8
    ring = [min(int(n) + 63, W) for n in lens]
    assert ring.count(W) >= 1, ring              # a wrapped ring
    for S, lengths, res in ((W, ring, results["flash_decode_gemma3"]),
                            (W, ring[:-1] + [1], {}),
                            (2 * W, [int(n) + 63 for n in lens], {})):
        qd = torch.randn(B, H, hd, generator=g, device="cuda").to(bf16)
        kc, vc = (torch.randn(B, K, S, hd, generator=g, device="cuda")
                  .to(bf16) for _ in range(2))
        lt = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        err = close(da.flash_decode(qd, kc, vc, lt),
                    da.flash_decode_plain(qd, kc, vc, lt))
        res["max_abs_err"] = err
        log("attention kernels", f"gemma3-27b decode: flash_decode B {B} H "
            f"{H} K {K} S {S} hd {hd} bf16 lengths {lengths}: max |kernel - "
            f"plain| {err:.3e}")
        if lengths[-1] != 1:
            time_decode_dense(res, (B, H, K, S, hd), lengths, g)


def check_cross_attention(results, g):
    """Both attention kernels at every call of phases 7k / 7l (the calls
    ``attention_calls`` lists for their runs), bf16, each against its plain
    version on the same tensors: flash_attention at each prefill shape
    (whisper's encoder over 1500 frames, the causal self prefills, the
    cross prefills with Lq != Lk; the kv heads repeated as the path
    repeats them), flash_decode at each decode step's lengths (the self
    caches' 63; the cross caches at S 1600, and 1500, which is no multiple
    of the 64-key split: the last is ragged). Then each entry is timed at
    its shape (a decode entry at its middle step's lengths) beside SDPA
    and its bound."""
    from repro_torch import configs
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.train.step import attention_calls
    bf16 = torch.bfloat16
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for arch, spec in CROSS_STEPS.items():
        calls = attention_calls(configs.get_config(arch), CROSS_BATCH,
                                spec["prompt"], spec["max_seq"], NEW_TOKENS)
        for c in calls:
            name = spec["entries"][(c.mixer, c.kernel)]
            res = results[name]
            q = torch.randn(c.q, generator=g, device="cuda").to(bf16)
            if c.kernel == "flash_attention":
                B, H, Lk, hd = c.kv
                k, v = (torch.randn(B, H // c.group, Lk, hd, generator=g,
                                    device="cuda").to(bf16)
                        .repeat_interleave(c.group, 1) for _ in range(2))
                kw = dict(causal=c.causal, window=c.window)
                res["max_abs_err"] = close(
                    fa.flash_attention(q, k, v, **kw),
                    fa.flash_attention_plain(q, k, v, **kw))
                log("attention kernels", f"{arch} {name}: flash_attention q "
                    f"{list(c.q)} over k/v {list(c.kv)} (kv heads repeated, "
                    f"G {c.group}) bf16 causal {c.causal}, {c.launches} "
                    f"calls in phase {spec['phase']}: max |kernel - plain| "
                    f"{res['max_abs_err']:.3e}")
                time_flash(res, q, k, v, c.causal, c.window, c.group)
                continue
            B, K, S, hd = c.kv
            kc, vc = (torch.randn(c.kv, generator=g, device="cuda").to(bf16)
                      for _ in range(2))
            res["max_abs_err"] = max(
                close(da.flash_decode(q, kc, vc, lens),
                      da.flash_decode_plain(q, kc, vc, lens))
                for lens in (torch.full((B,), n, dtype=torch.int32,
                                        device="cuda")
                             for n in sorted(set(c.lengths))))
            launch = da.decode_launch(B, c.q[1], K, S, hd, n_sm)
            log("attention kernels", f"{arch} {name}: flash_decode B {B} H "
                f"{c.q[1]} K {K} S {S} hd {hd} bf16 at each step's lengths "
                f"{c.lengths[0]}-{c.lengths[-1]} (every slot at it; at S, "
                f"{launch.nsplit} splits of {launch.chunk} keys, the last "
                f"{S - (launch.nsplit - 1) * launch.chunk}), {c.launches} "
                f"calls in phase {spec['phase']}: max |kernel - plain| "
                f"{res['max_abs_err']:.3e}")
            mid = c.lengths[len(c.lengths) // 2]
            time_decode_dense(res, (B, c.q[1], K, S, hd), [mid] * B, g)


def check_zamba2_attention(results, g):
    """Both attention kernels at every call of phase 7n: zamba2-1.2b's 6
    shared sites through the dense engine on phase 7's traffic, bf16, MHA
    (H = K = 32, G 1) at hd 64. flash_attention at each request's prefill
    (B 1, causal, L its prompt: 8 shapes); flash_decode at each of the 63
    decode steps (B 8, S 2048; slot b at length prompt_b + 1 + i at step
    i: every slot is admitted before the first step). Each against its
    plain version on the same tensors; then the longest prefill and the
    middle step timed beside SDPA."""
    from repro_torch import configs
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    bf16 = torch.bfloat16
    cfg = configs.get_config("zamba2-1.2b")
    H, K, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    lens, _ = phase7_prompts(cfg.vocab)
    res = results["flash_attention_zamba2"]
    for L in sorted(int(n) for n in lens):
        q, k, v = (torch.randn(1, H, L, hd, generator=g, device="cuda")
                   .to(bf16) for _ in range(3))
        res["max_abs_err"] = max(res["max_abs_err"], close(
            fa.flash_attention(q, k, v, causal=True),
            fa.flash_attention_plain(q, k, v, causal=True)))
    log("attention kernels", f"zamba2-1.2b shared-site prefills: "
        f"flash_attention B 1 H {H} hd {hd} bf16 causal (G 1) at L "
        f"{sorted(lens.tolist())}, 6 calls each in phase 7n: max |kernel - "
        f"plain| {res['max_abs_err']:.3e}")
    time_flash(res, q, k, v, True, None)
    res, B, S = results["flash_decode_zamba2"], len(lens), 2048
    steps = [[int(n) + 1 + i for n in lens] for i in range(NEW_TOKENS - 1)]
    qd = torch.randn(B, H, hd, generator=g, device="cuda").to(bf16)
    kc, vc = (torch.randn(B, K, S, hd, generator=g, device="cuda").to(bf16)
              for _ in range(2))
    for lengths in steps:
        lt = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        res["max_abs_err"] = max(res["max_abs_err"], close(
            da.flash_decode(qd, kc, vc, lt),
            da.flash_decode_plain(qd, kc, vc, lt)))
    log("attention kernels", f"zamba2-1.2b shared-site decode: flash_decode "
        f"B {B} H {H} K {K} S {S} hd {hd} bf16 at each of the {len(steps)} "
        f"steps' lengths ({steps[0]} to {steps[-1]}), 6 calls a step in "
        f"phase 7n: max |kernel - plain| {res['max_abs_err']:.3e}")
    time_decode_dense(res, (B, H, K, S, hd), steps[len(steps) // 2], g)


def flex_softcap(q, kvs, softcap, mask_mod, plain, rows):
    """The library yardstick of a capped attention: ``flex_attention``, one
    PyTorch call (compiled by ``torch.compile``, as PyTorch runs it), with
    the cap ``tanh(s / c) * c`` as its ``score_mod`` (after the scale,
    before the mask, the reference's order) and ``mask_mod`` as its block
    mask, over q [B, H, Lq, hd] and each (k, v) of ``kvs`` [B, K, Lk, hd]
    in turn. Compiled and held against ``plain`` (the plain version's
    output on ``kvs[0]`` as [B, H, Lq, hd]; ``rows``: the batch rows with a
    key to attend) within 2e-2 first (a yardstick's gate, as
    ``flash_decode_sp``'s: its bf16 P·V rounds otherwise than the
    kernels'), then timed as the other yardsticks are (:func:`graph_ms`). Returns (ms, max |flex -
    plain|). Its compiler's caches go under ``build/`` of the checkout."""
    import itertools
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    from repro_torch.launch.kernel_suite import graph_ms
    cache = os.path.join(ROOT, "build", "torch_compile")
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          os.path.join(cache, "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    B, H, Lq, _ = q.shape
    K, Lk = kvs[0][0].shape[1], kvs[0][0].shape[2]
    block = create_block_mask(mask_mod, B, None, Lq, Lk, device="cuda")

    def cap(score, b, h, q_idx, kv_idx):
        return torch.tanh(score / softcap) * softcap

    compiled = torch.compile(flex_attention, dynamic=False)

    def call(k, v):
        return compiled(q, k, v, score_mod=cap, block_mask=block,
                        enable_gqa=H != K)

    out = call(*kvs[0])[rows].float()
    err = float((out - plain[rows].float()).abs().max())
    assert torch.isfinite(out).all() and err <= 2e-2, err
    cyc = itertools.cycle(kvs)
    return graph_ms(lambda: call(*next(cyc)), 20), err


def time_decode_dense(res, shape, lens, g, softcap=None):
    """Kernel and the library yardstick: device time of 20 calls replayed
    from a CUDA graph, cycling 8 caches (67 MB > the 50 MB L2); plain: CUDA
    events around eager calls. The yardstick: SDPA with a key position <
    length mask, or with ``softcap`` (both then cap their logits)
    :func:`flex_softcap` under the same mask."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch.kernel_suite import graph_ms
    import itertools
    B, H, K, S, hd = shape
    q = torch.randn(B, H, hd, generator=g, device="cuda").to(torch.bfloat16)
    caches = [tuple(torch.randn(B, K, S, hd, generator=g, device="cuda")
                    .to(torch.bfloat16) for _ in range(2)) for _ in range(8)]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    cyc = itertools.cycle(caches)
    res["ms"] = graph_ms(lambda: da.flash_decode(
        q, *next(cyc), lengths, softcap=softcap), 20)
    res["plain_ms"] = cuda_ms(lambda i: da.flash_decode_plain(
        q, *caches[i % 8], lengths, softcap=softcap), iters=4, warm=1)
    qb = q[:, :, None]                                     # [B, H, 1, hd]
    if softcap:
        res["library_ms"], err = flex_softcap(
            qb, caches, softcap,
            lambda b, h, q_idx, kv_idx: kv_idx < lengths[b],
            da.flash_decode_plain(qb[:, :, 0], *caches[0], lengths,
                                  softcap=softcap)[:, :, None],
            lengths > 0)
        lib = (f"flex_attention yardstick (compiled, graph; tanh score_mod, "
               f"block mask key position < length; max |flex - plain| "
               f"{err:.3e} on the rows with a key, gate 2e-2) "
               f"{res['library_ms']:.4f} ms")
    else:
        mask = (torch.arange(S, device="cuda")[None] <
                lengths[:, None])[:, None, None]           # key pos < length
        res["library_ms"] = graph_ms(lambda: F.scaled_dot_product_attention(
            qb, *next(cyc), attn_mask=mask, enable_gqa=True), 20)
        lib = (f"sdpa yardstick (graph; mask: key position < length) "
               f"{res['library_ms']:.4f} ms")
    G, item = H // K, 2
    nbytes = (sum(K * hd * item * (n + (n if n > 0 else S)) for n in lens)
              + 2 * q.numel() * item + 4 * B)
    cap = 3 if softcap else 0      # a capped logit: a division, tanh, product
    flops = sum(K * G * ((4 * hd + cap) * n if n > 0 else 2 * hd * S)
                for n in lens)
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops, BF16_FLOP_PER_S)
    log("attention kernels", f"flash_decode timing B {B} H {H} K {K} S {S} "
        f"hd {hd} bf16 softcap {softcap} lengths {lens}: kernel "
        f"{res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, {lib}, bound "
        f"{res['bound_ms']:.4f} ms "
        f"({res['bound_by']}: {nbytes} B at 3.35 TB/s, {flops} flop at 989 "
        "TFLOP/s bf16)")


def time_flash(res, q, k, v, causal, window, G=1, softcap=None):
    """Kernel and the SDPA yardstick: device time of 20 calls replayed from
    a CUDA graph; plain (the block walk): CUDA events around eager calls.
    Causal (with or without a window) over L keys, or non-causal over
    every one of Lk keys. ``G``: k and v hold each kv head G times over
    (repeated to the query heads); the bound reads each once. With
    ``softcap`` both cap their logits and the yardstick is
    :func:`flex_softcap` under the same causal mask."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.kernel_suite import graph_ms
    B, H, L, hd = q.shape
    Lk = k.shape[2]
    assert causal or window is None, "the pair counts below"
    kw = dict(causal=causal, window=window, softcap=softcap)
    res["ms"] = graph_ms(lambda: fa.flash_attention(q, k, v, **kw), 20)
    res["plain_ms"] = cuda_ms(lambda i: fa.flash_attention_plain(
        q, k, v, **kw), iters=2, warm=1)
    if softcap:
        assert causal and window is None, "flex_softcap's mask below"
        res["library_ms"], err = flex_softcap(
            q, [(k, v)], softcap,
            lambda b, h, q_idx, kv_idx: kv_idx <= q_idx,
            fa.flash_attention_plain(q, k, v, **kw), slice(None))
        what = (f"compiled flex_attention, tanh score_mod, causal block "
                f"mask; max |flex - plain| {err:.3e}, gate 2e-2")
    elif not causal:
        what = f"no mask, Lq {L} x Lk {Lk}"
        res["library_ms"] = graph_ms(lambda: F.scaled_dot_product_attention(
            q, k, v), 20)
    elif window is None:
        what = "is_causal=True"
        res["library_ms"] = graph_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), 20)
    else:
        i = torch.arange(L, device="cuda")
        mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)
        what = f"bool [L, L] mask, causal and window {window}"
        res["library_ms"] = graph_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), 20)
    pairs = (L * Lk if not causal else
             sum(min(n + 1, window or n + 1) for n in range(L)))
    flops = (4 * hd + (3 if softcap else 0)) * pairs * B * H
    nbytes = ((2 * q.numel() + (k.numel() + v.numel()) // G)
              * q.element_size())
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops, BF16_FLOP_PER_S)
    log("attention kernels", f"flash_attention timing B {B} H {H} L {L} Lk "
        f"{Lk} hd {hd} bf16 causal {causal} window {window} softcap "
        f"{softcap} (K/V bytes counted once a kv head: G {G}): kernel "
        f"{res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, library "
        f"yardstick (graph, {what}) {res['library_ms']:.4f} ms, bound "
        f"{res['bound_ms']:.4f} ms ({res['bound_by']}: {flops} flop at 989 "
        f"TFLOP/s bf16, {nbytes} B at 3.35 TB/s)")


def suite_main_path(results):
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gemm as tg
    from repro_torch.kernels import ops
    from repro_torch.kernels import polybench as pb
    from repro_torch.kernels import ref
    from repro_torch.kernels import tiled
    from repro_torch.launch import kernel_suite
    counters = {"autodma_tiled": tiled.launch, "gemm": tg.gemm,
                "matvec": pb.matvec, "matvec_t": pb.matvec_t,
                "conv2d": pb.conv2d, "covar": pb.covar,
                "flash_attention": fa.flash_attention,
                "flash_decode": da.flash_decode}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = kernel_suite.run("cuda", 1, iters=3,
                           log=lambda m: print(m, flush=True))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in counters.items()}
    assert all(n > 0 for n in counts.values()), counts
    assert counts["autodma_tiled"] == (counts["gemm"] + counts["matvec"]
                                       + counts["matvec_t"]
                                       + 2 * counts["covar"]), counts
    for name, n in counts.items():
        results[name]["launches"] = n
    log("suite", f"{len(res['fig7'])} Fig. 7 rows, {len(res['isa'])} ISA "
        f"rows and {len(res['attention'])} attention rows in {wall:.1f} s; "
        f"launches {counts}")
    log("suite", json.dumps({"fig7": res["fig7"], "isa": res["isa"],
                             "attention": res["attention"],
                             "summary": res["summary"]}))
    # what comes out is right: each Fig. 7 kernel (autodma) against its
    # oracle in f32; the mxu products run in TF32, 3mm chains three
    g = torch.Generator(device="cuda").manual_seed(4)
    n = kernel_suite.N
    A, B, C, D = (torch.randn(n, n, generator=g, device="cuda")
                  for _ in range(4))
    x, r = (torch.randn(n, generator=g, device="cuda") for _ in range(2))
    Ad = torch.randn(1024, 4608, generator=g, device="cuda")
    Bd = torch.randn(4608, 1024, generator=g, device="cuda")
    checks = [("gemm", ops.gemm(A, B), ops.REFS["gemm"](A, B), MXU_F32_TOL),
              ("2mm", ops.mm2(A, B, C), ops.REFS["mm2"](A, B, C),
               2 * MXU_F32_TOL),
              ("3mm", ops.mm3(A, B, C, D), ops.REFS["mm3"](A, B, C, D),
               3 * MXU_F32_TOL),
              ("atax", ops.atax(A, x), ops.REFS["atax"](A, x), F32_TOL),
              ("darknet", ops.gemm(Ad, Bd), ops.REFS["gemm"](Ad, Bd),
               MXU_F32_TOL)]
    c = torch.randn(3, 3, generator=g, device="cuda")
    checks += [("conv2d", ops.conv2d(A, c), ops.REFS["conv2d"](A, c),
                F32_TOL),
               ("covar", ops.covar(A), ops.REFS["covar"](A), MXU_F32_TOL)]
    for got, exp in zip(ops.bicg(A, x, r), ops.REFS["bicg"](A, x, r)):
        checks.append(("bicg", got, exp, F32_TOL))
    for name, got, exp, tol in checks:
        err = rel_err(got, exp)
        assert tuple(got.shape) == tuple(exp.shape) and \
            torch.isfinite(got).all() and err <= tol, (name, err)
        log("suite", f"{name} (autodma) against its oracle: rel err "
            f"{err:.2e} (tol {tol:g})")
    # the attention kernels against their oracles, f32, within 2e-3
    q, k, v = (torch.randn(1, 14, 512, 64, generator=g, device="cuda")
               for _ in range(3))
    B, H, K, S, hd = kernel_suite.DECODE
    qd = torch.randn(B, H, hd, generator=g, device="cuda")
    kc, vc = (torch.randn(B, K, S, hd, generator=g, device="cuda")
              for _ in range(2))
    lens = torch.tensor(kernel_suite.decode_lengths(B, S), dtype=torch.int32,
                        device="cuda")
    for name, got, exp in [
            ("flash_attention", ops.flash_attention(q, k, v, window=128),
             ops.REFS["flash_attention"](q, k, v, window=128)),
            ("flash_decode", da.flash_decode(qd, kc, vc, lens),
             ref.decode_attention(qd, kc, vc, lens))]:
        err = (got - exp).abs().max().item()
        assert tuple(got.shape) == tuple(exp.shape) and \
            torch.isfinite(got).all() and err <= TOL, (name, err)
        log("suite", f"{name} against its oracle (f32): max abs err "
            f"{err:.2e} (tol {TOL:g})")


# --------------------------------------------------------------------------
# phases 6 and 7: the engine
# --------------------------------------------------------------------------
def serve(engine, prompts, max_new, classes=None):
    """Submit the prompts (with ``(priority, deadline_s)`` classes, if
    given) and run to idle; every request finishes or is shed."""
    from repro_torch.serve.engine import Request
    for i, p in enumerate(prompts):
        pri, deadline = classes[i] if classes else (0, None)
        assert engine.submit(Request(seq_id=i, prompt=p.copy(),
                                     max_new=max_new, priority=pri,
                                     deadline_s=deadline))
    done = engine.run(max_steps=100000)
    torch.cuda.synchronize()
    assert engine.idle and len(done) + len(engine.shed) == len(prompts), \
        "requests unfinished"
    return {r.seq_id: list(r.tokens_out) for r in done}


def full_width_serve(results, card: str):
    from repro_torch import configs
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.launch.serve import warm_up
    from repro_torch.models import transformer
    from repro_torch.serve.cache import CacheConfig
    from repro_torch.serve.engine import Engine, EngineConfig
    cfg = configs.get_config("qwen2-0.5b")                 # bf16 compute
    t0 = time.perf_counter()
    model = transformer.init_model(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    conf = EngineConfig(n_slots=8, max_seq=2048, chunked=True,
                        token_budget=256,
                        cache=CacheConfig(page_tokens=16))
    warm_up(cfg, model, conf, "cuda")
    eng = Engine(cfg, model, config=conf, device="cuda")
    torch.cuda.synchronize()
    log("serve", f"set-up {time.perf_counter() - t0:.2f} s: qwen2-0.5b "
        f"{cfg.n_layers()} layers d_model {cfg.d_model} heads "
        f"{cfg.n_heads}/{cfg.n_kv} vocab {cfg.vocab}, "
        f"{transformer.count_params(eng.model)} parameters in "
        f"{eng.model.embed.dtype}")
    rng = np.random.default_rng(0)
    lens = rng.integers(128, 1537, 8)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in lens]
    pda.paged_flash_decode.launches = 0
    ppa.paged_flash_prefill.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    streams = serve(eng, prompts, 64)
    wall = time.perf_counter() - t0
    n_dec = pda.paged_flash_decode.launches
    n_pre = ppa.paged_flash_prefill.launches
    s = eng.stats_summary()
    assert all(len(t) == 64 for t in streams.values())
    assert s["prefill_chunk_tokens"] == int(lens.sum()), s
    assert s["max_iter_tokens"] <= s["token_budget"]
    assert eng.pool.alloc.free_pages == eng.pool.alloc.n_pages
    eng.pool.alloc.audit()
    assert n_dec == cfg.n_layers() * s["decode_steps"] > 0, (n_dec, s)
    assert n_pre == cfg.n_layers() * s["prefill_chunks"] > 0, (n_pre, s)
    results["paged_flash_decode"]["launches"] = n_dec
    results["paged_flash_prefill"]["launches"] = n_pre
    toks = sum(len(t) for t in streams.values())
    log("serve", f"{card}: {len(streams)} requests, prompts "
        f"{sorted(lens.tolist())} ({int(lens.sum())} tok), {toks} new "
        f"tokens in {wall:.3f} s ({toks / wall:.1f} tok/s), ttft p50/p99 "
        f"{s['ttft_p50_s']:.4f}/{s['ttft_p99_s']:.4f} s, itl p50/p99 {s['itl_p50_s'] * 1e3:.2f}/"
        f"{s['itl_p99_s'] * 1e3:.2f} ms, decode steps {s['decode_steps']}, "
        f"prefill chunks {s['prefill_chunks']}, max iter tokens "
        f"{s['max_iter_tokens']}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("serve", f"launches: paged_flash_decode {n_dec} = "
        f"{cfg.n_layers()} x {s['decode_steps']} decode steps, "
        f"paged_flash_prefill {n_pre} = "
        f"{cfg.n_layers()} x {s['prefill_chunks']} prompt chunks")
    return streams


HOT_PAGES = 160          # phase 7c's hot tier: ~2.1x oversubscribed
TIER_COUNTERS = ("preemptions", "preempted_mid_prefill", "swap_out_count",
                 "swap_in_count", "swap_out_bytes", "swap_in_bytes",
                 "admission_refusals", "evictions_reprefill", "decode_steps",
                 "prefill_chunks", "prefill_chunk_tokens", "shed")


def swap_trace(tracer):
    """The tracer's ``dma``-track windows and ``swap_wait`` spans: (windows,
    their total ms, waits, their total ms)."""
    begin, win, n_win, wait, n_wait = {}, 0.0, 0, 0.0, 0
    for ev in tracer.chrome_trace()["traceEvents"]:
        if ev["ph"] == "X" and ev["name"] == "swap_wait":
            wait += ev["dur"]
            n_wait += 1
        elif ev.get("cat") == "dma" and ev["ph"] == "b":
            begin[ev["id"]] = ev["ts"]
        elif ev.get("cat") == "dma" and ev["ph"] == "e":
            win += ev["ts"] - begin.pop(ev["id"])
            n_win += 1
    return n_win, win / 1e3, n_wait, wait / 1e3


def swap_round_trip(cfg, kv_dtype: str):
    """One resident 1500-token sequence of a full-width pool with random
    page contents: swap it out, let another sequence take pages, swap it
    back, and hold every leaf (scale rows too) bit for bit. Returns the
    bytes moved and the copy stream's ms each way."""
    from repro_torch.core import dma
    from repro_torch.serve.cache import CacheConfig, build_cache_manager
    pool = build_cache_manager(
        cfg, CacheConfig(page_tokens=16, n_pages=HOT_PAGES, tiered=True,
                         kv_dtype=kv_dtype), 8, 2048, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    slot = pool.admit_prefill(0, 1500)
    pool.lengths[slot] = 1500
    old = list(pool.alloc._seq_pages[0])
    idx = torch.tensor(old, device="cuda")
    before = []
    for per_pos in pool.pages:
        for kv in per_pos:
            for arr in kv.values():
                shape = (arr.shape[0], len(old)) + tuple(arr.shape[2:])
                if arr.dtype == torch.int8:
                    rows = torch.randint(-127, 128, shape, generator=g,
                                         device="cuda", dtype=torch.int8)
                else:
                    rows = torch.rand(shape, generator=g, device="cuda")
                arr[:, idx] = rows.to(arr.dtype)
                before.append(arr[:, idx].clone())
    torch.cuda.synchronize()
    pool.swap_out(slot)
    out_ms = dma.device_window_ms(pool.last_transfers)
    assert pool.host_used_bytes() == pool.swap_out_bytes > 0
    other = pool.admit_prefill(1, 320)          # takes 20 of the freed pages
    slot = pool.swap_in(0)
    torch.cuda.synchronize()
    in_ms = dma.device_window_ms(pool.last_transfers)
    new = list(pool.alloc._seq_pages[0])
    assert new != old and int(pool.lengths[slot]) == 1500
    idx = torch.tensor(new, device="cuda")
    after = [arr[:, idx] for per_pos in pool.pages for kv in per_pos
             for arr in kv.values()]
    assert len(after) == len(before) == (4 if kv_dtype == "int8" else 2)
    assert all(torch.equal(a, b) for a, b in zip(after, before)), kv_dtype
    assert pool.swap_in_bytes == pool.swap_out_bytes
    pool.release(slot)
    pool.release(other)
    assert pool.alloc.free_pages == pool.alloc.n_pages
    assert pool.hero.levels[3].in_use() == 0
    return pool.swap_out_bytes, len(new), out_ms, in_ms


def tiered_serve(results, card: str, untiered):
    """Phase 7's traffic through a 160-page hot tier over host DRAM; then
    the same traffic again, traced; then full-width swap round trips."""
    import subprocess
    from repro_torch import configs
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.launch.serve import warm_up
    from repro_torch.models import transformer
    from repro_torch.serve.cache import CacheConfig
    from repro_torch.serve.engine import Engine, EngineConfig
    cfg = configs.get_config("qwen2-0.5b")                 # bf16 compute
    model = transformer.init_model(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    conf = EngineConfig(n_slots=8, max_seq=2048, chunked=True,
                        token_budget=256,
                        cache=CacheConfig(page_tokens=16, n_pages=HOT_PAGES,
                                          tiered=True))
    warm_up(cfg, model, conf, "cuda")
    rng = np.random.default_rng(0)
    lens = rng.integers(128, 1537, 8)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in lens]

    def run(config):
        eng = Engine(cfg, model, config=config, device="cuda")
        pda.paged_flash_decode.launches = 0
        ppa.paged_flash_prefill.launches = 0
        t0 = time.perf_counter()
        streams = serve(eng, prompts, 64)
        wall = time.perf_counter() - t0
        s = eng.stats_summary()
        n_dec = pda.paged_flash_decode.launches
        n_pre = ppa.paged_flash_prefill.launches
        assert n_dec == cfg.n_layers() * s["decode_steps"] > 0, (n_dec, s)
        assert n_pre == cfg.n_layers() * s["prefill_chunks"] > 0, (n_pre, s)
        pool, a = eng.pool, eng.pool.alloc
        assert all(len(t) == 64 for t in streams.values())
        assert s["preemptions"] >= 1, s
        assert s["swap_out_count"] == s["swap_in_count"] > 0, s
        assert s["swap_out_bytes"] == s["swap_in_bytes"] > 0, s
        assert not pool.cold_seqs() and pool.host_used_bytes() == 0
        assert a.free_pages == a.n_pages and a._seq_pages == {}
        # the arena is empty again; its largest guaranteed allocation
        # (host_free_bytes) need not return: o1heap never merges its bins
        assert pool.hero.levels[3].in_use() == 0
        a.audit()
        assert s["max_iter_tokens"] <= s["token_budget"]
        return eng, streams, wall, s, n_dec, n_pre

    eng, streams, wall, s, n_dec, n_pre = run(conf)
    toks = sum(len(t) for t in streams.values())
    log("serve tiered", f"{card}: {len(streams)} requests, prompts "
        f"{sorted(lens.tolist())} ({int(lens.sum())} tok), hot tier "
        f"{HOT_PAGES} pages x {eng.pool.page_nbytes()} B = "
        f"{eng.pool.footprint_bytes()} B, host budget "
        f"{eng.pool.hero.levels[3].arena} B; {toks} new tokens in "
        f"{wall:.3f} s ({toks / wall:.1f} tok/s), ttft p50/p99 "
        f"{s['ttft_p50_s']:.4f}/{s['ttft_p99_s']:.4f} s, itl p50/p99 "
        f"{s['itl_p50_s'] * 1e3:.2f}/{s['itl_p99_s'] * 1e3:.2f} ms, decode "
        f"steps {s['decode_steps']}, prefill chunks {s['prefill_chunks']}")
    log("serve tiered", f"preemptions {s['preemptions']} (mid-prefill "
        f"{s['preempted_mid_prefill']}), swap out {s['swap_out_count']}x/"
        f"{s['swap_out_bytes']} B, swap in {s['swap_in_count']}x/"
        f"{s['swap_in_bytes']} B, peak host {s['peak_host_bytes']} B, "
        f"admission refusals {s['admission_refusals']}; launches: "
        f"paged_flash_decode {n_dec} = {cfg.n_layers()} x "
        f"{s['decode_steps']}, paged_flash_prefill {n_pre} = "
        f"{cfg.n_layers()} x {s['prefill_chunks']}; every hot page free, no "
        "cold sequence, the L3 arena empty (its largest free block "
        f"{eng.pool.host_free_bytes()} B), audit clean")
    traced, again, _, s2, _, _ = run(dataclasses.replace(conf, trace=True))
    assert again == streams, "a second run of the same traffic differs"
    assert {k: s2[k] for k in TIER_COUNTERS} == \
        {k: s[k] for k in TIER_COUNTERS}, (s, s2)
    n_win, win_ms, n_wait, wait_ms = swap_trace(traced.tracer)
    assert n_win == n_wait == s2["swap_out_count"] + s2["swap_in_count"]
    ts = traced.trace_summary()
    log("serve tiered", f"a second run (traced) gives the same streams and "
        f"counters; dma windows {n_win}, {win_ms:.2f} ms in all; swap_wait "
        f"spans {n_wait}, {wait_ms:.2f} ms in all; stall% dma "
        f"{ts['stall_pct_dma']:.2f}, schedule "
        f"{ts['stall_pct_schedule']:.1f}, fetch {ts['stall_pct_fetch']:.1f},"
        f" shadowed {ts['stall_pct_shadowed']:.1f}, other "
        f"{ts['stall_pct_other']:.1f}")
    same = sum(x == y for i in streams for x, y in zip(streams[i],
                                                      untiered[i]))
    log("serve tiered", f"token match against phase 7's untiered streams: "
        f"{same}/{toks} ({same / toks:.3f}) (reported, not gated)")
    link = subprocess.run(
        ["nvidia-smi", "--query-gpu=pcie.link.gen.current,"
         "pcie.link.gen.max,pcie.link.width.current",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    for kv_dtype in ("compute", "int8"):
        nbytes, n_pages, out_ms, in_ms = swap_round_trip(cfg, kv_dtype)
        log("serve tiered", f"swap round trip, {kv_dtype} pages: a "
            f"1500-token sequence, {n_pages} pages, {nbytes} B, every leaf "
            f"bit for bit on other pages; dev->host {out_ms:.3f} ms "
            f"({nbytes / out_ms / 1e6:.2f} GB/s), host->dev {in_ms:.3f} ms "
            f"({nbytes / in_ms / 1e6:.2f} GB/s) on the copy stream; PCIe "
            f"link gen current, max, width: {link}")


SYSTEM_PROMPT = 1024     # tokens of the shared system prompt (phase 7b)


def prefix_int8_serve(results, card: str):
    """Full-width qwen2-0.5b on the int8 + prefix stack: request 0 alone,
    then six requests sharing its system prompt and one exact copy of its
    prompt; then the same traffic again after clear(), and once each on
    bf16 pages, bf16 pages with the prefix layer and in f32 (the shares of
    equal tokens are reported, not gated)."""
    from repro_torch import configs
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.launch.serve import warm_up
    from repro_torch.models import transformer
    from repro_torch.serve.cache import CacheConfig
    from repro_torch.serve.engine import Engine, EngineConfig, Request
    cfg = configs.get_config("qwen2-0.5b")                 # bf16 compute
    model = transformer.init_model(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    conf = EngineConfig(n_slots=8, max_seq=2048, chunked=True,
                        token_budget=256,
                        cache=CacheConfig(page_tokens=16, kv_dtype="int8",
                                          prefix=True))
    warm_up(cfg, model, conf, "cuda")
    eng = Engine(cfg, model, config=conf, device="cuda")
    rng = np.random.default_rng(0)
    system = rng.integers(0, cfg.vocab, SYSTEM_PROMPT)
    prompts = [np.concatenate([system, rng.integers(
        0, cfg.vocab, int(n))]).astype(np.int32)
        for n in rng.integers(64, 513, 7)]
    prompts.append(prompts[0].copy())              # an exact repeat of 0

    def waves(engine):
        """Request 0 alone to completion, then the other seven at once."""
        engine.submit(Request(seq_id=0, prompt=prompts[0].copy(),
                              max_new=64))
        done = engine.run(max_steps=100000)
        for i, p in enumerate(prompts[1:], 1):
            engine.submit(Request(seq_id=i, prompt=p.copy(), max_new=64))
        done += engine.run(max_steps=100000)
        torch.cuda.synchronize()
        assert engine.idle and len(done) == len(prompts)
        return {r.seq_id: list(r.tokens_out) for r in done}

    pda.paged_flash_decode.launches = 0
    ppa.paged_flash_prefill.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    streams = waves(eng)
    wall = time.perf_counter() - t0
    n_dec = pda.paged_flash_decode.launches
    n_pre = ppa.paged_flash_prefill.launches
    s = eng.stats_summary()
    peak = torch.cuda.max_memory_allocated()
    lens = [len(p) for p in prompts]
    assert all(len(t) == 64 for t in streams.values())
    assert s["prefix_hits"] == 7 and s["prefix_full_hits"] == 1, s
    assert s["prefix_shared_tokens"] == 6 * SYSTEM_PROMPT + lens[0], s
    assert s["evictions_reprefill"] == 0, s
    assert s["prefill_chunk_tokens"] == sum(lens) - \
        s["prefix_shared_tokens"], s
    assert s["max_iter_tokens"] <= s["token_budget"]
    assert n_dec == cfg.n_layers() * s["decode_steps"] > 0, (n_dec, s)
    assert n_pre == cfg.n_layers() * s["prefill_chunks"] > 0, (n_pre, s)
    results["paged_flash_decode_int8"]["launches"] = n_dec
    results["paged_flash_prefill_int8"]["launches"] = n_pre
    pool, a = eng.pool, eng.pool.alloc
    assert a._seq_pages == {}
    cached = eng.prefix.cached_pages()
    assert all(a.refcount(p) == 1 for p in cached)
    assert a.free_pages == a.n_pages - len(cached)
    a.audit()
    eng.prefix.clear()
    assert a.free_pages == a.n_pages
    a.audit()
    toks = sum(len(t) for t in streams.values())
    log("serve int8+prefix", f"{card}: {len(streams)} requests (1, then 7), "
        f"prompts {lens} ({sum(lens)} tok, a {SYSTEM_PROMPT}-token system "
        f"prompt), {toks} new tokens in {wall:.3f} s ({toks / wall:.1f} "
        f"tok/s), ttft p50/p99 {s['ttft_p50_s']:.4f}/{s['ttft_p99_s']:.4f} "
        f"s, itl p50/p99 {s['itl_p50_s'] * 1e3:.2f}/"
        f"{s['itl_p99_s'] * 1e3:.2f} ms, peak memory {peak / 2**30:.2f} GiB, "
        f"pool {pool.footprint_bytes()} B ({pool.page_nbytes()} B a page, "
        f"int8 + scales)")
    log("serve int8+prefix", f"prefix hits {s['prefix_hits']} "
        f"({s['prefix_full_hits']} full), shared tokens "
        f"{s['prefix_shared_tokens']}, prefill chunk tokens "
        f"{s['prefill_chunk_tokens']} = {sum(lens)} - "
        f"{s['prefix_shared_tokens']}, cow forks {s['cow_forks']}, cached "
        f"pages {len(cached)}; launches: paged_flash_decode {n_dec} = "
        f"{cfg.n_layers()} x {s['decode_steps']} decode steps, "
        f"paged_flash_prefill {n_pre} = {cfg.n_layers()} x "
        f"{s['prefill_chunks']} prompt chunks; after clear() every page "
        "free, audit clean")
    again = waves(eng)
    assert again == streams, "a second run of the same traffic differs"
    # controls for the token match: how far greedy streams at this width
    # part under changes that are not int8 pages
    bf16 = waves(Engine(cfg, model, config=dataclasses.replace(
        conf, cache=CacheConfig(page_tokens=16)), device="cuda"))
    bf16_prefix = waves(Engine(cfg, model, config=dataclasses.replace(
        conf, cache=CacheConfig(page_tokens=16, prefix=True)), device="cuda"))
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    f32 = waves(Engine(cfg32, copy.deepcopy(model).float(),
                       config=dataclasses.replace(
                           conf, cache=CacheConfig(page_tokens=16)),
                       device="cuda"))

    def match(a, b, what):
        same = sum(x == y for i in a for x, y in zip(a[i], b[i]))
        first = sum(a[i][0] == b[i][0] for i in a)
        common = [next((j for j, (x, y) in enumerate(zip(a[i], b[i]))
                        if x != y), len(a[i])) for i in a]
        log("serve int8+prefix", f"token match, {what}: {same}/{toks} "
            f"({same / toks:.3f}), first tokens equal in {first}/{len(a)} "
            f"streams, common prefixes {common} tokens (reported, not gated)")

    log("serve int8+prefix", "a second run of the same traffic gives the "
        "same streams")
    match(streams, bf16, "int8 + prefix against bf16 pages")
    match(streams, f32, "int8 + prefix against f32 (compute and pages)")
    match(bf16, f32, "control: bf16 against f32 (compute and pages)")
    match(bf16_prefix, bf16, "control: bf16 + prefix against bf16 pages")


def _latency(reqs):
    """TTFT and ITL p50 / p99 (s) over finished requests' own stamps."""
    from repro_torch.serve.metrics import percentiles
    ttft = [r.t_first - r.t_submit for r in reqs]
    itl = [b - a for r in reqs for a, b in zip(r.t_tokens, r.t_tokens[1:])]
    out = percentiles(ttft, (50, 99), prefix="ttft_", suffix="_s")
    out.update(percentiles(itl, (50, 99), prefix="itl_", suffix="_s"))
    return out


def _match(a, b) -> float:
    """The share of tokens of streams ``a`` equal, position for position,
    to streams ``b``."""
    same = sum(x == y for i in a for x, y in zip(a[i], b[i]))
    return same / sum(len(t) for t in a.values())


def fleet_serve(card: str):
    """Two full-width replicas sharing one model, each a chunked engine on
    bf16 pages with the prefix layer: two 1024-token system prompts, A0
    and B0 first (stepped until both prefills land), then six followers of
    each, in pairs A A B B ...; under the prefix router, under round robin,
    and
    under the prefix router again with r1 killed while it decodes."""
    from repro_torch import configs
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.launch.serve import warm_up
    from repro_torch.models import transformer
    from repro_torch.serve.cache import CacheConfig
    from repro_torch.serve.engine import EngineConfig, Request
    from repro_torch.serve.replica import DEAD
    from repro_torch.serve.router import Fleet
    cfg = configs.get_config("qwen2-0.5b")                 # bf16 compute
    model = transformer.init_model(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    conf = EngineConfig(n_slots=8, max_seq=2048, chunked=True,
                        token_budget=256,
                        cache=CacheConfig(page_tokens=16, prefix=True))
    warm_up(cfg, model, conf, "cuda")
    rng = np.random.default_rng(7)
    system = [rng.integers(0, cfg.vocab, SYSTEM_PROMPT) for _ in range(2)]
    first = [np.concatenate([system[i], rng.integers(
        0, cfg.vocab, int(rng.integers(64, 513)))]).astype(np.int32)
        for i in range(2)]
    # followers in pairs, A A B B ...: round robin splits each pair over
    # both replicas, the prefix router sends both to the one holding it
    followers = [np.concatenate([system[i // 2 % 2], rng.integers(
        0, cfg.vocab, int(rng.integers(64, 513)))]).astype(np.int32)
        for i in range(12)]
    prompts = first + followers
    n_req = len(prompts)

    def run(router, kill_after=None):
        fleet = Fleet(cfg, model, conf, replicas=2, router=router,
                      device="cuda")
        pda.paged_flash_decode.launches = 0
        ppa.paged_flash_prefill.launches = 0
        t0 = time.perf_counter()
        reqs = [Request(seq_id=i, prompt=p.copy(), max_new=64)
                for i, p in enumerate(prompts)]
        done = []
        for r in reqs[:2]:
            fleet.submit(r)
        while not all(r.tokens_out for r in reqs[:2]):
            done += fleet.step()
        for r in reqs[2:]:
            fleet.submit(r)
        steps, killed = 0, None
        while not fleet.idle:
            if kill_after is not None and steps == kill_after:
                r1 = fleet._by_name["r1"]
                assert r1.engine.scheduler.active, "r1 is not decoding"
                r1.fail_after(1)
            done += fleet.step()
            steps += 1
            if killed is None and fleet._by_name["r1"].state == DEAD:
                killed = fleet._finished_by["r1"]
            assert steps < 100000
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_dec = pda.paged_flash_decode.launches
        n_pre = ppa.paged_flash_prefill.launches
        streams = {int(r.seq_id): list(r.tokens_out) for r in done}
        assert sorted(streams) == list(range(n_req)), "requests lost"
        assert all(len(t) == 64 for t in streams.values())
        assert not fleet.shed and not fleet._pending and not fleet._inflight
        summ = fleet.stats_summary()
        per = summ["per_replica"]
        steps_dec = sum(s["decode_steps"] for s in per.values())
        chunks = sum(s["prefill_chunks"] for s in per.values())
        if kill_after is None:
            assert n_dec == cfg.n_layers() * steps_dec > 0, (n_dec, per)
            assert n_pre == cfg.n_layers() * chunks > 0, (n_pre, per)
        return fleet, streams, wall, summ, (n_dec, n_pre), killed, done

    def report(what, fleet, streams, wall, summ, launches, done):
        fs, per = summ["fleet"], summ["per_replica"]
        toks = sum(len(t) for t in streams.values())
        lat = _latency(done)
        log("serve fleet", f"{card}: {what}: {n_req} requests (prompts "
            f"{[len(p) for p in prompts]}), "
            f"{toks} new tokens in {wall:.3f} s ({toks / wall:.1f} tok/s), "
            f"ttft p50/p99 {lat['ttft_p50_s']:.4f}/{lat['ttft_p99_s']:.4f} "
            f"s, itl p50/p99 {lat['itl_p50_s'] * 1e3:.2f}/"
            f"{lat['itl_p99_s'] * 1e3:.2f} ms; routed {fs['routed']} "
            f"({fs['routed_prefix']} prefix-affine, "
            f"{fs['routed_prefix_tokens']} matched tok), requeued "
            f"{fs['requeued_kill']} on a kill; launches: paged_flash_decode "
            f"{launches[0]}, paged_flash_prefill {launches[1]}")
        for name, s in sorted(per.items()):
            log("serve fleet", f"  {name} ({fs['replicas'][name]['state']},"
                f" gen {fs['replicas'][name]['generation']}): finished "
                f"{fs['replicas'][name]['finished']}, prefix hits "
                f"{s['prefix_hits']}, shared tokens "
                f"{s['prefix_shared_tokens']}, prefill chunk tokens "
                f"{s['prefill_chunk_tokens']}, decode steps "
                f"{s['decode_steps']}")

    def drain_and_audit(fleet):
        for rep in fleet.replicas:
            if rep.engine is not None and rep.engine.prefix is not None:
                rep.engine.prefix.clear()
            if rep.state == "ready":
                fleet.drain(rep.name)
        fleet.run(50)
        for rep in fleet.replicas:
            a = rep.engine.pool.alloc
            assert rep.state == DEAD and a.free_pages == a.n_pages
            assert a._seq_pages == {}
            a.audit()

    fleet, streams, wall, summ, launches, _, done = run("prefix")
    fs = summ["fleet"]
    assert fs["routed"] == n_req and fs["routed_prefix"] == 12, fs
    assert fs["routed_prefix_tokens"] == 12 * SYSTEM_PROMPT, fs
    assert {r: s["prefix_hits"] for r, s in summ["per_replica"].items()} \
        == {"r0": 6, "r1": 6}, summ["per_replica"]
    report("prefix router", fleet, streams, wall, summ, launches, done)
    drain_and_audit(fleet)
    log("serve fleet", "prefix router: every follower on the replica that "
        "holds its system prompt (12 prefix-routed, 12 x 1024 matched "
        "tokens), 6 hits a replica; after clear() and a drain of both, every"
        " page free, audits clean")
    t_rr = run("round_robin")
    report("round_robin router", *t_rr[:5], t_rr[6])
    rr_hits = sum(s["prefix_hits"] for s in t_rr[3]["per_replica"].values())
    # the first A on r1 and the first B on r0 find nothing to share
    assert t_rr[3]["fleet"]["routed_prefix"] == 0 and rr_hits <= 10, rr_hits
    drain_and_audit(t_rr[0])
    k = run("prefix", kill_after=8)
    kfleet, kstreams, killed = k[0], k[1], k[5]
    ks = k[3]["fleet"]
    assert kfleet._by_name["r1"].state == DEAD and killed is not None
    assert ks["requeued_kill"] > 0, ks
    assert ks["replicas"]["r0"]["finished"] == n_req - killed, ks
    report("prefix router, r1 killed while decoding", *k[:5], k[6])
    kfleet.respawn("r1")
    drain_and_audit(kfleet)
    log("serve fleet", f"kill: r1 failed at the top of a step after "
        f"{killed} of its requests finished; {ks['requeued_kill']} requeued "
        f"requests finished on r0, none lost; respawn('r1') (generation "
        f"{kfleet._by_name['r1'].generation}), drain, audits clean; token "
        f"match against the un-killed run {_match(kstreams, streams):.3f}, "
        f"round robin against the prefix router "
        f"{_match(t_rr[1], streams):.3f} (reported, not gated); prefix hits "
        f"12 under the prefix router, {rr_hits} under round robin")


def dense_serve(results, card: str, chunked):
    """Phase 7's model and traffic through the dense engine and through the
    monolithic paged engine (bf16 pages), then through the dense engine
    with ``logit_softcap`` set (``SOFTCAP``; the same weights, drawn again
    from the seed under the capped config): both attention kernels of the
    dense path counted, from 0, in each run."""
    from repro_torch import configs
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.launch.serve import warm_up
    from repro_torch.models import transformer
    from repro_torch.serve.cache import CacheConfig
    from repro_torch.serve.engine import Engine, EngineConfig
    from repro_torch.serve.kvcache import CachePool
    cfg = configs.get_config("qwen2-0.5b")                 # bf16 compute
    model = transformer.init_model(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    rng = np.random.default_rng(0)
    lens = rng.integers(128, 1537, 8)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in lens]
    counters = (da.flash_decode, fa.flash_attention, pda.paged_flash_decode,
                ppa.paged_flash_prefill)
    dense_streams = None
    for name, cache in (("dense", CacheConfig()),
                        ("monolithic paged", CacheConfig(paged=True,
                                                         page_tokens=16)),
                        (f"dense, softcap {SOFTCAP}", CacheConfig())):
        if "softcap" in name:
            cfg = dataclasses.replace(cfg, logit_softcap=SOFTCAP)
            del model
            model = transformer.init_model(
                cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        conf = EngineConfig(n_slots=8, max_seq=2048, cache=cache)
        warm_up(cfg, model, conf, "cuda")
        eng = Engine(cfg, model, config=conf, device="cuda")
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        streams = serve(eng, prompts, 64)
        wall = time.perf_counter() - t0
        n_dd, n_fa, n_pd, n_pp = (fn.launches for fn in counters)
        s = eng.stats_summary()
        L = cfg.n_layers()
        assert all(len(t) == 64 for t in streams.values())
        assert s["prefills"] == len(prompts), s
        assert n_fa == L * s["prefills"], (n_fa, s)
        if cache.paged:
            assert n_pd == L * s["decode_steps"] > 0 and n_dd == 0, \
                (n_pd, n_dd, s)
            assert n_pp == 0, n_pp
            a = eng.pool.alloc
            assert a.free_pages == a.n_pages and eng.pool._reserved == {}
            a.audit()
            pool = (f"pool {a.n_pages} pages ({eng.pool.footprint_bytes()} "
                    "B), every page free, audit clean")
        else:
            assert isinstance(eng.pool, CachePool)
            assert eng.pool.footprint_bytes() == 8 * 2048 * 12_288
            assert n_dd == L * s["decode_steps"] > 0 and n_pd == n_pp == 0, \
                (n_dd, n_pd, n_pp, s)
            assert (eng.pool.seq_ids < 0).all()
            pool = (f"slot pool {eng.pool.footprint_bytes()} B, every slot "
                    "free")
        key = ("softcap" if cfg.logit_softcap else
               "monolithic" if cache.paged else "dense")
        results[f"flash_attention_{key}"]["launches"] = n_fa
        if not cache.paged:
            results[f"flash_decode_{key}"]["launches"] = n_dd
        if key == "dense":
            dense_streams = streams
        elif key == "softcap":
            pool += (f"; token match against the uncapped dense streams "
                     f"{_match(streams, dense_streams):.3f} (reported)")
        toks = sum(len(t) for t in streams.values())
        dec = "paged_flash_decode" if cache.paged else "flash_decode"
        log("serve dense", f"{card}: {name}: {len(streams)} requests, "
            f"{toks} new tokens in {wall:.3f} s ({toks / wall:.1f} tok/s), "
            f"ttft p50/p99 {s['ttft_p50_s']:.4f}/{s['ttft_p99_s']:.4f} s, "
            f"itl p50/p99 {s['itl_p50_s'] * 1e3:.2f}/"
            f"{s['itl_p99_s'] * 1e3:.2f} ms, decode steps "
            f"{s['decode_steps']}, prefills {s['prefills']}; {pool}; "
            f"launches: flash_attention {n_fa} = {L} x {s['prefills']} "
            f"prefills, {dec} {max(n_dd, n_pd)} = {L} x "
            f"{s['decode_steps']} decode steps (flash_decode {n_dd}, "
            f"paged_flash_decode {n_pd}, paged_flash_prefill {n_pp}); token "
            f"match against phase 7's chunked streams "
            f"{_match(streams, chunked):.3f} (reported, not gated)")
    time_serving_attention(results, lens)


def time_serving_attention(results, lens):
    """The serving entries of flash_decode and flash_attention, checked
    against their plain versions and timed at 7e's shapes: the dense decode
    step at the lengths of each request's last step (prompt + 63), the
    prefill of its longest prompt (B 1, 14 heads, kv heads repeated)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.kernel_suite import DECODE
    g = torch.Generator(device="cuda").manual_seed(9)
    bf16 = torch.bfloat16
    B, H, K, S, hd = DECODE
    dec_lens = [int(n) + 63 for n in lens]
    q = torch.randn(B, H, hd, generator=g, device="cuda").to(bf16)
    kc, vc = (torch.randn(B, K, S, hd, generator=g, device="cuda").to(bf16)
              for _ in range(2))
    lengths = torch.tensor(dec_lens, dtype=torch.int32, device="cuda")
    res = results["flash_decode_dense"]
    res["max_abs_err"] = close(da.flash_decode(q, kc, vc, lengths),
                               da.flash_decode_plain(q, kc, vc, lengths))
    time_decode_dense(res, DECODE, dec_lens, g)
    L = int(max(lens))
    q, k, v = (torch.randn(1, H, L, hd, generator=g, device="cuda").to(bf16)
               for _ in range(3))
    err = close(fa.flash_attention(q, k, v, causal=True),
                fa.flash_attention_plain(q, k, v, causal=True))
    for key in ("dense", "monolithic"):
        res = results[f"flash_attention_{key}"]
        res["max_abs_err"] = err
        time_flash(res, q, k, v, True, None)


ZOO = {"yi-34b": "_yi34b", "minitron-4b": "_minitron4b",
       "granite-moe-3b-a800m": "_granite"}
PROFILE_WINDOW = (8, 12)  # every profiled run's traced iterations / decode
#                           steps (the profile's analysis is slow: 8-16
#                           took 84 s of yi-34b's phase and 67 s of
#                           granite's, so the window was halved to keep the
#                           script inside its time limit)
ROOT = os.path.dirname(os.path.abspath(__file__))
# depth cuts at full width (the paged kernels' shapes do not depend on the
# depth), so that the script keeps inside its time limit as phases are
# added: yi-34b serves 20 of its 60 layers, granite-moe 8 of its 32
ZOO_LAYERS = {"yi-34b": 20, "granite-moe-3b-a800m": 8}


def free_card(phase: str, when: str = "before the weights are drawn"):
    """Let go of every earlier model and pool, and log what is free."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(phase, f"device memory {when}: {free / 2**30:.2f} GiB free of "
        f"{total / 2**30:.2f} GiB")


def phase7_prompts(vocab: int):
    """Phase 7's traffic: 8 prompts of 128-1536 tokens from default_rng(0)."""
    rng = np.random.default_rng(0)
    lens = rng.integers(128, 1537, 8)
    return lens, [rng.integers(0, vocab, int(n)).astype(np.int32)
                  for n in lens]


def device_busy(eng, prompts, window=PROFILE_WINDOW, n_top=5):
    """Serve ``prompts`` again, tracing iterations ``window`` with
    torch.profiler: the device's busy share of that window's wall time
    (kernel time summed by name; the profiler's own cost lengthens the
    wall time) and the kernels with the most device time. Returns the
    streams."""
    from repro_torch.launch.serve import profile_rows, profiler
    from repro_torch.serve.engine import Request
    for i, p in enumerate(prompts):
        assert eng.submit(Request(seq_id=i, prompt=p.copy(), max_new=64))
    done, it = [], 0
    prof = profiler()
    while not eng.idle:
        if it == window[0]:
            torch.cuda.synchronize()
            prof.start()
            t0 = time.perf_counter()
        done.extend(eng.step())
        it += 1
        if it == window[1]:
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prof.stop()
    assert it > window[1], it
    busy_us, rows = profile_rows(prof)
    busy_ms = busy_us / 1e3
    top = "; ".join(f"{us / 1e3:.1f} ms {n}x {key[:48]}"
                    for us, n, key in rows[:n_top])
    return ({r.seq_id: list(r.tokens_out) for r in done},
            busy_ms, wall * 1e3, top)


def capacity_drops(model, cfg, tokens):
    """(assignments dropped, routed) at each layer's MoE on one prefill of
    ``tokens`` [B, L] (host ints) from position 0 over fresh dense caches
    (phases 7f / 7g / 7j: a 256-token chunk, one row; 7o: the dense
    engine's first prefill, request 0's prompt in slot 0 and token 0 in
    the other seven rows), counted with the port's own ``route`` /
    ``select`` on the layer's input, intercepted for this call alone."""
    from repro_torch.models import moe, transformer
    inner, seen = moe.dispatch_compute, []

    def counting(xf, router_w, *weights):
        gates, idx, _ = moe.route(router_w, xf, cfg.moe)
        sel = moe.select(gates, idx, cfg.moe)
        seen.append((moe.dropped(idx, *sel[1:], cfg.moe.n_experts),
                     idx.numel()))
        return inner(xf, router_w, *weights)

    device = model.embed.device
    caches = transformer.init_caches(cfg, *tokens.shape, device=device)
    toks = torch.from_numpy(tokens).to(device)
    moe.dispatch_compute = counting
    try:
        with torch.no_grad():
            transformer.hidden(model, toks, caches, 0, "prefill")
    finally:
        moe.dispatch_compute = inner
    return [(int(d), n) for d, n in seen]


def zoo_serve(results, card: str, arch: str, profile: bool):
    """Phases 7f / 7g / 7j: ``arch`` at its published width (random
    weights, seed 0, drawn at bf16) through the chunked engine on phase
    7's traffic and pool shape, each paged kernel counted from 0. A MoE
    arch also logs its capacity drops on one 256-token chunk."""
    from repro_torch import configs
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.launch.serve import warm_up
    from repro_torch.models import transformer
    from repro_torch.serve.cache import CacheConfig
    from repro_torch.serve.engine import Engine, EngineConfig
    phase = f"serve {arch}"
    free_card(phase)
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get_config(arch, param_dtype=torch.bfloat16)
    if arch in ZOO_LAYERS:
        (pattern, _), = cfg.groups
        cfg = dataclasses.replace(cfg, groups=((pattern, ZOO_LAYERS[arch]),))
    t0 = time.perf_counter()
    model = transformer.init_model(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    conf = EngineConfig(n_slots=8, max_seq=2048, chunked=True,
                        token_budget=256, cache=CacheConfig(page_tokens=16))
    warm_up(cfg, model, conf, "cuda")
    eng = Engine(cfg, model, config=conf, device="cuda")
    torch.cuda.synchronize()
    n_par = transformer.count_params(eng.model)
    pool = eng.pool
    ffn = (f"MoE {cfg.moe.n_experts} experts top-{cfg.moe.top_k} d_ff "
           f"{cfg.d_ff}" if cfg.moe else f"d_ff {cfg.d_ff} ({cfg.mlp})")
    log(phase, f"set-up {time.perf_counter() - t0:.2f} s: {arch} "
        f"{cfg.n_layers()} layers d_model {cfg.d_model} heads "
        f"{cfg.n_heads}/{cfg.n_kv} hd {cfg.hd} {ffn} vocab {cfg.vocab} "
        f"{'tied' if cfg.tie_embeddings else 'untied'}, {n_par} parameters "
        f"in {eng.model.embed.dtype} ({2 * n_par} B); pool "
        f"{pool.alloc.n_pages} pages x {pool.page_nbytes()} B = "
        f"{pool.footprint_bytes()} B")
    lens, prompts = phase7_prompts(cfg.vocab)
    pda.paged_flash_decode.launches = 0
    ppa.paged_flash_prefill.launches = 0
    t0 = time.perf_counter()
    streams = serve(eng, prompts, 64)
    wall = time.perf_counter() - t0
    n_dec = pda.paged_flash_decode.launches
    n_pre = ppa.paged_flash_prefill.launches
    s = eng.stats_summary()
    L = cfg.n_layers()
    toks = sum(len(t) for t in streams.values())
    assert len(streams) == 8 and toks == 8 * 64, (len(streams), toks)
    assert s["prefill_chunk_tokens"] == int(lens.sum()), s
    assert s["max_iter_tokens"] <= s["token_budget"]
    assert pool.alloc.free_pages == pool.alloc.n_pages and \
        pool._reserved == {}
    pool.alloc.audit()
    assert n_dec == L * s["decode_steps"] > 0, (n_dec, s)
    assert n_pre == L * s["prefill_chunks"] > 0, (n_pre, s)
    suffix = ZOO[arch]
    results["paged_flash_decode" + suffix]["launches"] = n_dec
    results["paged_flash_prefill" + suffix]["launches"] = n_pre
    log(phase, f"{card}: {len(streams)} requests, prompts "
        f"{sorted(lens.tolist())} ({int(lens.sum())} tok), {toks} new "
        f"tokens in {wall:.3f} s ({toks / wall:.1f} tok/s), ttft p50/p99 "
        f"{s['ttft_p50_s']:.4f}/{s['ttft_p99_s']:.4f} s, itl p50/p99 "
        f"{s['itl_p50_s'] * 1e3:.2f}/{s['itl_p99_s'] * 1e3:.2f} ms, decode "
        f"steps {s['decode_steps']}, prefill chunks {s['prefill_chunks']}, "
        f"max iter tokens {s['max_iter_tokens']}, every page free, audit "
        f"clean, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB; launches: paged_flash_decode {n_dec} = {L} x "
        f"{s['decode_steps']} decode steps, paged_flash_prefill {n_pre} = "
        f"{L} x {s['prefill_chunks']} prompt chunks")
    if cfg.moe:
        from repro_torch.models import moe
        drops = capacity_drops(eng.model, cfg, prompts[0][None, :256])
        log(phase, f"capacity drops on one 256-token chunk (request 0's "
            f"first 256 tokens; C {moe.capacity(256, cfg.moe)} an expert of "
            f"{cfg.moe.n_experts}): layer 0 {drops[0][0]} of {drops[0][1]} "
            f"assignments, all {len(drops)} layers {sum(d for d, _ in drops)}"
            f" of {sum(n for _, n in drops)}, most in a layer "
            f"{max(d for d, _ in drops)}")
    if profile:
        del eng
        free_card(phase, "with the weights, before a second pool")
        eng = Engine(cfg, model, config=conf, device="cuda")
        t0 = time.perf_counter()
        again, busy, wall_ms, top = device_busy(
            eng, prompts, n_top=15 if cfg.moe else 5)
        assert again == streams, "a second run gave other streams"
        log(phase, f"{card}: profiled second run (iterations "
            f"{PROFILE_WINDOW[0]}-{PROFILE_WINDOW[1]}, the "
            f"same streams; {time.perf_counter() - t0:.1f} s with the "
            f"profile's analysis): device busy {busy:.1f} ms of "
            f"{wall_ms:.1f} ms wall ({100 * busy / wall_ms:.1f} %); top "
            f"kernels: {top}")


# phase 7h's clocked runs: qwen2-0.5b at full width on a smaller engine
# than phase 7's, behind an ITL target and deadlines. The schedule (12
# requests over 16 iterations, prompts of 16-119 tokens, 4-16 new) and the
# manual clock's ticks (steps of 5 ms growing 5 % an iteration, so the ITL
# p99 crosses the 20 ms target mid-run) give squeezes in some iterations
# with a mid-prefill resident, one deadline lapsed and eight met; rank 1's
# clock is skewed, as in tests/test_torch_tp_clock.py. The real clock's run
# takes the first 6 requests behind a 250 ms target: two gloo ranks sharing
# the card step in ~0.2 s (on an H100 80GB HBM3 at 700 W a 30 ms target
# squeezed every iteration: 138 iterations in 34.2 s)
TP_CLOCK = dict(seed=5, requests=12, arrivals=16, lens=(16, 120),
                new=(4, 17), deadlines=(None, 0.05, 0.25, 2.0),
                itl_target_s=0.02, tick_s=0.005, growth=1.05,
                skew=(7.0, 100.0), real_requests=6,
                real_itl_target_s=0.25)
TP_CLOCK_ENGINE = dict(n_slots=4, max_seq=512, chunked=True,
                       token_budget=64)


def clock_schedule(vocab: int):
    """Phase 7h's clocked schedule: (arrival, prompt, max_new, priority,
    deadline_s); its shapes do not depend on ``vocab``."""
    c = TP_CLOCK
    rng = np.random.default_rng(c["seed"])
    n = c["requests"]
    arr = rng.integers(0, c["arrivals"], n)
    lens, new = rng.integers(*c["lens"], n), rng.integers(*c["new"], n)
    prompts = np.random.default_rng(c["seed"] + 1)
    return [(int(arr[i]), prompts.integers(0, vocab, int(lens[i])).astype(
        np.int32), int(new[i]), 0, c["deadlines"][i % 4]) for i in range(n)]


def clock_ticks():
    c = TP_CLOCK
    return tuple(float(t) for t in np.cumsum(
        [0.0] + [c["tick_s"] * c["growth"] ** i for i in range(1999)]))


def clock_summary(r):
    """What one clocked run decided: streams, admissions, sheds, counters,
    the squeezes and the iterations with a mid-prefill resident."""
    return dict(streams=r["streams"], admission_order=r["admission_order"],
                shed=r["shed"], counters={
                    k: r["stats"].get(k, 0) for k in (
                        "decode_steps", "decode_tokens", "prefill_chunks",
                        "prefill_chunk_tokens", "admission_refusals",
                        "shed")},
                squeezes=r["bus_counters"].get("itl_budget_squeezes", 0),
                mids=sum(1 for e in r["iter_log"] if e["mid_prefill"]))


def tp_serve(results, card: str, chunked):
    """Phase 7h: phase 7's model, engine and traffic at tp = 2, two ranks
    on this one card over gloo (NCCL refuses two ranks on one GPU; gloo
    stages CUDA tensors through the host, so its speed means nothing
    here). Each rank holds one of qwen2-0.5b's two kv heads; the streams
    must equal phase 7's at tp = 1 on the card. In the same spawn each
    rank then serves the clocked schedule (``TP_CLOCK``) behind an ITL
    target and deadlines: under a manual clock, rank 1's skewed, equal to
    the same engine at tp = 1 here under rank 0's clock; and under the
    real clock, the ranks equal to each other with the rank check on, the
    broadcasts of rank 0's clock logged per iteration."""
    import tempfile
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.parallel import launch
    from repro_torch.serve.cache import CacheConfig
    from repro_torch.serve.engine import Engine, EngineConfig
    from repro_torch.serve.policy import PolicyConfig
    from repro_torch.parallel.mesh_jobs import each
    from repro_torch.parallel.tp_jobs import (ManualClock, ServeJob, drive,
                                              replicated, serve_schedule)
    free_card("serve tp")
    cfg = configs.get_config("qwen2-0.5b")
    lens, prompts = phase7_prompts(cfg.vocab)
    cuda = ("cuda:0", "cuda:0")
    job = ServeJob(
        cfg=cfg, weights=0, schedule=[(0, p, 64) for p in prompts],
        devices=cuda,
        config=EngineConfig(n_slots=8, max_seq=2048, chunked=True,
                            token_budget=256, tp=2, check_ranks=True,
                            cache=CacheConfig(page_tokens=16)))
    sched, ticks = clock_schedule(cfg.vocab), clock_ticks()
    clocked = EngineConfig(
        **TP_CLOCK_ENGINE, tp=2, check_ranks=True,
        policy=PolicyConfig(itl_target_s=TP_CLOCK["itl_target_s"]),
        cache=CacheConfig(page_tokens=16))
    manual = ServeJob(cfg=cfg, weights=0, schedule=sched, devices=cuda,
                      config=clocked, ticks=ticks,
                      clocks=(ManualClock(), ManualClock(*TP_CLOCK["skew"])))
    real = ServeJob(cfg=cfg, weights=0, devices=cuda,
                    schedule=sched[:TP_CLOCK["real_requests"]],
                    config=dataclasses.replace(clocked, policy=PolicyConfig(
                        itl_target_s=TP_CLOCK["real_itl_target_s"])))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as store:
        out = launch.spawn(each, 2, (serve_schedule, [job, manual, real]),
                           store_dir=store, backend="gloo", timeout_s=600.0)
    spawn_s = time.perf_counter() - t0
    every = ("streams", "stats", "admission_order", "shed", "bus_counters",
             "iter_log", "executor", "pool")
    r = replicated([o[0] for o in out], ("streams", "stats", "launches",
                                         "pool"))
    s, n = r["summary"], r["launches"]
    L = cfg.n_layers()
    assert r["streams"] == chunked, "tp = 2 streams differ from tp = 1's"
    assert r["pool"]["kv_heads"] == 1 and r["pool"]["seq_pages"] == {}
    assert r["pool"]["free_pages"] == r["pool"]["n_pages"]
    assert n["paged_flash_decode"] == L * s["decode_steps"] > 0, (n, s)
    assert n["paged_flash_prefill"] == L * s["prefill_chunks"] > 0, (n, s)
    assert r["executor"]["rank_checks"] > 0
    results["paged_flash_decode_tp"]["launches"] = n["paged_flash_decode"]
    results["paged_flash_prefill_tp"]["launches"] = n["paged_flash_prefill"]
    toks = sum(len(t) for t in r["streams"].values())
    log("serve tp", f"{card}: tp = 2 as two ranks on cuda:0 over gloo (the "
        "one card; gloo is the transport here for correctness only, its "
        f"speed means nothing): {len(r['streams'])} requests, {toks} new "
        f"tokens, the same streams as phase 7's tp = 1 run on every rank, "
        f"{r['executor']['rank_checks']} rank-consistency checks, each rank "
        f"1 of 2 kv heads ({r['pool']['page_nbytes']} B a whole page), every "
        f"page free, audit clean; launches per rank: paged_flash_decode "
        f"{n['paged_flash_decode']} = {L} x {s['decode_steps']} decode "
        f"steps, paged_flash_prefill {n['paged_flash_prefill']} = {L} x "
        f"{s['prefill_chunks']} prompt chunks; ranks' serve "
        f"{r['wall_s']:.1f} s, the whole spawn {spawn_s:.1f} s")
    # the clocked runs: tp = 2 under rank 0's manual clock against tp = 1
    # on the card under the same clock
    m = replicated([o[1] for o in out], every)
    t0 = time.perf_counter()
    clock = ManualClock()
    eng = Engine(cfg, transformer.init_model(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"),
        device="cuda:0", config=dataclasses.replace(
            clocked, tp=1, check_ranks=False, clock=clock))
    done = drive(eng, manual, clock)
    one = dict(streams={q.seq_id: list(q.tokens_out) for q in done},
               admission_order=list(eng.stats["admission_order"]),
               shed=[(int(q.seq_id), q.verdict.code) for q in eng.shed],
               stats=eng.stats, iter_log=eng.stats["iter_log"],
               bus_counters=eng.metrics_snapshot()["counters"])
    one_s = time.perf_counter() - t0
    del eng, done
    free_card("serve tp", "after the tp = 1 clocked run")
    want, got = clock_summary(one), clock_summary(m)
    assert got == want, ("tp = 2 under rank 0's clock differs from tp = 1",
                         {k: (got[k], want[k]) for k in got
                          if got[k] != want[k]})
    assert 0 < want["squeezes"] < want["mids"], want
    assert any(code == "deadline" for _, code in want["shed"]), want["shed"]
    met = [i for i in want["admission_order"] if sched[i][4] is not None]
    assert met, want["admission_order"]
    assert m["executor"]["rank_checks"] > 0 and m["executor"]["clock_reads"]
    iters = len(m["iter_log"])
    log("serve tp", f"{card}: clocked, manual clock (rank 1's x "
        f"{TP_CLOCK['skew'][0]:g} + {TP_CLOCK['skew'][1]:g} s), ITL target "
        f"{TP_CLOCK['itl_target_s'] * 1e3:g} ms: both ranks' streams, "
        f"admission order, sheds {want['shed']} and counters equal the tp "
        f"= 1 run on the card under rank 0's clock ({one_s:.1f} s); "
        f"{want['squeezes']} budget squeezes in {want['mids']} iterations "
        f"with a mid-prefill resident, {len(met)} requests with a deadline "
        f"admitted; {m['executor']['clock_reads']} clock reads broadcast "
        f"over {iters} iterations ({m['executor']['clock_reads'] / iters:.2f}"
        f" an iteration), {m['executor']['rank_checks']} rank checks; "
        f"ranks' serve {m['wall_s']:.1f} s")
    q = replicated([o[2] for o in out], every)
    qs, iters = clock_summary(q), len(q["iter_log"])
    reads = q["executor"]["clock_reads"]
    assert q["executor"]["rank_checks"] > 0 and reads > 0
    assert len(qs["shed"]) + len(qs["streams"]) == len(real.schedule)
    log("serve tp", f"{card}: clocked, the real clock, ITL target "
        f"{TP_CLOCK['real_itl_target_s'] * 1e3:g} ms: both ranks equal "
        f"(streams, admissions, sheds {qs['shed']}, counters), "
        f"{q['executor']['rank_checks']} rank checks clean; "
        f"{qs['squeezes']} squeezes in {qs['mids']} iterations with a "
        f"mid-prefill resident; {reads} clock reads broadcast over {iters} "
        f"iterations ({reads / iters:.2f} an iteration, "
        f"{q['summary']['itl_p50_s'] * 1e3:.1f} / "
        f"{q['summary']['itl_p99_s'] * 1e3:.1f} ms ITL p50 / p99 on gloo "
        f"ranks sharing the card), ranks' serve {q['wall_s']:.1f} s")


# phases 7i / 7m / 7n / 7o: an arch at full width through the dense
# engine, the only one that serves it in either package (its local,
# recurrent or MLA layers are not pageable); ``params`` / ``leaves`` /
# ``token_bytes``: the gates on its parameter count, its 8 x 2048 slot
# pool's bytes and the reference's per-token estimate (rings and state
# uncounted); ``entries``: the kernels line's (flash_attention,
# flash_decode) entries for its attention layers, none when it has none
# (xlstm-1.3b, deepseek-v3-671b: both kernels gated at 0 launches);
# ``cut``: config overrides that cut the depth (deepseek-v3-671b's 1.37
# TB fit no card: 3 dense + 2 MoE layers, every one at full width, the
# MTP head undrawn)
DENSE_ZOO = {
    "gemma3-27b": dict(
        phase="7i", params=7_189_867_776, leaves=1_073_741_824,
        token_bytes=16_384,
        entries=("flash_attention_gemma3", "flash_decode_gemma3"),
        cut=dict(groups=((("local:mlp",) * 5 + ("global:mlp",), 2),
                         (("local:mlp",), 2))),
        why="to keep the script inside its time limit",
        fit=(27_008_986_368, 4_831_838_208)),
    "xlstm-1.3b": dict(
        phase="7m", params=1_236_260_864, leaves=1_884_028_928,
        token_bytes=0, entries=None,
        cut=dict(groups=((("mlstm:none",) * 7 + ("slstm:none",), 2),)),
        why="to keep the script inside its time limit",
        fit=(3_502_733_312, 5_652_086_784)),
    "zamba2-1.2b": dict(
        phase="7n", params=951_304_192, leaves=1_080_229_888,
        token_bytes=49_152,
        entries=("flash_attention_zamba2", "flash_decode_zamba2")),
    "deepseek-v3-671b": dict(
        phase="7o", params=26_618_387_456, leaves=94_371_840,
        token_bytes=5_760, entries=None,
        cut=dict(groups=((("mla:mlp",), 3), (("mla:moe",), 2)), mtp=False),
        why="the MTP head undrawn; the published parameters fit no card")}


FIT_NEW = 4      # the memory-fit gate's new tokens (3 decode steps)


def full_depth_fit(card: str, arch: str, fit, phase: str):
    """The memory-fit gate of an arch whose traffic ``dense_zoo_serve``
    serves cut in depth: the published depth drawn at bf16 (seed 0) with
    the dense engine's pool (8 slots x 2048), gated on the published
    parameter count and cache leaves (``fit``), and the traffic's
    shortest prompt served to ``FIT_NEW`` tokens, so that a prefill and
    decode steps run through every layer; then all of it freed."""
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Engine, EngineConfig
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = configs.get_config(arch, param_dtype=torch.bfloat16)
    model = transformer.init_model(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    eng = Engine(cfg, model, config=EngineConfig(n_slots=8, max_seq=2048),
                 device="cuda")
    n_par, leaves = transformer.count_params(eng.model), \
        eng.pool.leaf_nbytes()
    assert (n_par, leaves) == fit, (n_par, leaves)
    lens, prompts = phase7_prompts(cfg.vocab)
    i = int(np.argmin(lens))
    streams = serve(eng, [prompts[i]], FIT_NEW)
    assert [len(t) for t in streams.values()] == [FIT_NEW], streams
    assert (eng.pool.seq_ids < 0).all()
    log(phase, f"{card}: memory-fit gate at the published depth "
        f"({cfg.n_layers()} layers, {n_par} parameters in bf16, {2 * n_par} "
        f"B; dense pool 8 slots x 2048, cache leaves {leaves} B): one "
        f"request of {int(lens[i])} prompt tokens served to {FIT_NEW} new "
        f"tokens, every slot free, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"{time.perf_counter() - t0:.1f} s")
    del eng, model
    free_card(phase, "after the memory-fit gate")


def dense_zoo_serve(results, card: str, arch: str):
    """Phases 7i / 7m / 7n / 7o: ``arch`` at its published width (random
    weights, seed 0, drawn at bf16; nothing cut but the depth of all but
    zamba2-1.2b, ``DENSE_ZOO``; gemma3-27b and xlstm-1.3b pass
    :func:`full_depth_fit` at their published depth first) through the
    dense engine (8 slots x 2048) on
    phase 7's traffic, after every earlier model is freed. Both attention
    kernels counted from 0: one flash_attention a prefill and one
    flash_decode a decode step in each attention layer (gemma3-27b's 52
    local layers on 1024-row rings and 10 global ones; zamba2-1.2b's 6
    shared sites; none in xlstm-1.3b, whose mLSTM / sLSTM layers run
    models/ssm.py's plain PyTorch, nor in deepseek-v3-671b, whose MLA
    layers run plain PyTorch, as the reference's run plain jnp); the
    paged kernels too, at 0. A MoE arch logs the capacity drops of each
    MoE layer at its first prefill. Then a second, profiled run with the
    same streams."""
    from repro_torch import configs
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.launch.serve import warm_up
    from repro_torch.models import ssm, transformer
    from repro_torch.serve.engine import Engine, EngineConfig
    from repro_torch.serve.kvcache import CachePool
    spec = DENSE_ZOO[arch]
    phase = f"serve {arch}"
    free_card(phase)
    if "fit" in spec:
        full_depth_fit(card, arch, spec["fit"], phase)
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get_config(arch, param_dtype=torch.bfloat16,
                             **spec.get("cut", {}))
    t0 = time.perf_counter()
    model = transformer.init_model(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    conf = EngineConfig(n_slots=8, max_seq=2048)
    # one product first: cuBLAS keeps a 32 MiB workspace from its first
    # call on a stream, which is no pool (deepseek's is 94 MB, so the gate
    # below has 11.8 MB of slack; run alone, 7o met the workspace there)
    eye = torch.eye(8, device="cuda", dtype=torch.bfloat16)
    (eye @ eye).sum().item()
    before_warm_up = torch.cuda.memory_allocated()   # the weights and what
    warm_up(cfg, model, conf, "cuda")                # earlier phases keep
    after_warm_up = torch.cuda.memory_allocated()
    eng = Engine(cfg, model, config=conf, device="cuda")
    torch.cuda.synchronize()
    n_par = transformer.count_params(eng.model)
    pool = eng.pool
    assert isinstance(pool, CachePool) and n_par == spec["params"], n_par
    leaves = pool.leaf_nbytes()
    assert leaves == spec["leaves"], leaves
    assert pool.token_bytes() == spec["token_bytes"], pool.token_bytes()
    # the warm-up's throwaway pool is gone before the timed one is made
    assert after_warm_up - before_warm_up < leaves // 8, \
        (after_warm_up, before_warm_up)
    def kinds_of(c):
        return collections.Counter(k for pattern, count in c.groups
                                   for k in pattern for _ in range(count))

    kinds, cut = kinds_of(cfg), "; nothing cut"
    if "cut" in spec:
        full = configs.get_config(arch)
        n_full = transformer.count_params(
            transformer.init_model(full, None, "meta"))
        per_kind = ", ".join(f"{n} of {kinds_of(full)[k]} {k}"
                             for k, n in kinds.items())
        cut = (f"; CUT IN DEPTH to {cfg.n_layers()} of the published "
               f"{full.n_layers()} layers ({per_kind}), every layer at "
               f"full width ({spec['why']}; {n_full} parameters "
               "published)")
    mla = (f" MLA q_lora {cfg.mla.q_lora} kv_lora {cfg.mla.kv_lora} "
           f"qk_nope {cfg.mla.qk_nope} qk_rope {cfg.mla.qk_rope} v_dim "
           f"{cfg.mla.v_dim}" if cfg.mla else "")
    moe_w = (f" MoE {cfg.moe.n_experts} experts top-{cfg.moe.top_k} d_ff "
             f"{cfg.moe.d_ff} shared {cfg.moe.n_shared} router "
             f"{cfg.moe.router}" if cfg.moe else "")
    log(phase, f"set-up {time.perf_counter() - t0:.2f} s: {arch} "
        f"{cfg.n_layers()} layers "
        f"({', '.join(f'{n} {k}' for k, n in kinds.items())}; window "
        f"{cfg.window}) d_model {cfg.d_model} heads {cfg.n_heads}/"
        f"{cfg.n_kv}{mla or f' hd {cfg.hd}'} d_ff {cfg.d_ff}{moe_w} vocab "
        f"{cfg.vocab} {'tied' if cfg.tie_embeddings else 'untied'}{cut}; "
        f"{n_par} parameters in {eng.model.embed.dtype} ({2 * n_par} B); "
        f"dense pool 8 slots x 2048: cache leaves {leaves} B (the "
        f"reference's estimate, rings and recurrent state uncounted: "
        f"{pool.footprint_bytes()} B, {pool.token_bytes()} B a token); "
        f"memory before the warm-up {before_warm_up / 2**30:.2f} GiB, "
        f"after it {after_warm_up / 2**30:.2f} GiB, with the pool "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    lens, prompts = phase7_prompts(cfg.vocab)
    kernels = (da.flash_decode, fa.flash_attention, pda.paged_flash_decode,
               ppa.paged_flash_prefill)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    streams = serve(eng, prompts, 64)
    wall = time.perf_counter() - t0
    n_dec, n_fa, n_pd, n_pp = (k.launches for k in kernels)
    s = eng.stats_summary()
    L = sum(n for k, n in kinds.items() if transformer.parse_kind(k)[0]
            not in ssm.RECURRENT + ("mla",))
    toks = sum(len(t) for t in streams.values())
    assert len(streams) == 8 and toks == 8 * 64, (len(streams), toks)
    assert all(len(t) == 64 for t in streams.values())
    assert s["prefills"] == 8 and (pool.seq_ids < 0).all(), s
    assert s["decode_steps"] > 0, s
    assert n_fa == L * 8, (n_fa, L, s)
    assert n_dec == L * s["decode_steps"], (n_dec, L, s)
    assert n_pd == n_pp == 0, (n_pd, n_pp)
    if spec["entries"]:
        results[spec["entries"][0]]["launches"] = n_fa
        results[spec["entries"][1]]["launches"] = n_dec
    log(phase, f"{card}: {len(streams)} requests, prompts "
        f"{sorted(lens.tolist())} ({int(lens.sum())} tok), {toks} new "
        f"tokens in {wall:.3f} s ({toks / wall:.1f} tok/s), ttft p50/p99 "
        f"{s['ttft_p50_s']:.4f}/{s['ttft_p99_s']:.4f} s, itl p50/p99 "
        f"{s['itl_p50_s'] * 1e3:.2f}/{s['itl_p99_s'] * 1e3:.2f} ms, decode "
        f"steps {s['decode_steps']}, prefills {s['prefills']}, every slot "
        f"free, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB; launches: flash_attention {n_fa} = {L} attention layers x "
        f"8 prefills, flash_decode {n_dec} = {L} x {s['decode_steps']} "
        f"decode steps, paged_flash_decode {n_pd}, paged_flash_prefill "
        f"{n_pp}; request 0's first tokens {streams[0][:12]}")
    if cfg.moe:
        from repro_torch.models import moe
        first = np.zeros((8, len(prompts[0])), np.int32)
        first[0] = prompts[0]
        drops = capacity_drops(eng.model, cfg, first)
        log(phase, f"capacity drops at the first prefill (request 0's "
            f"{len(prompts[0])} tokens in slot 0, token 0 in the other 7 "
            f"rows: {first.size} tokens, C "
            f"{moe.capacity(first.size, cfg.moe)} an expert of "
            f"{cfg.moe.n_experts}): "
            + ", ".join(f"MoE layer {i} {d} of {n} assignments"
                        for i, (d, n) in enumerate(drops))
            + f"; a decode step's 8 tokens: C "
            f"{moe.capacity(8, cfg.moe)}, none can drop")
    del eng
    free_card(phase, "with the weights, before a second pool")
    eng = Engine(cfg, model, config=conf, device="cuda")
    t0 = time.perf_counter()
    again, busy, wall_ms, top = device_busy(eng, prompts,
                                            n_top=12 if cfg.moe else 8)
    assert again == streams, "a second run gave other streams"
    log(phase, f"{card}: profiled second run (iterations "
        f"{PROFILE_WINDOW[0]}-{PROFILE_WINDOW[1]}, the same streams; "
        f"{time.perf_counter() - t0:.1f} s with the profile's analysis): "
        f"device busy {busy:.1f} ms of {wall_ms:.1f} ms wall "
        f"({100 * busy / wall_ms:.1f} %); top kernels: {top}")


# phases 7k / 7l: each cross-attention arch at full width through the
# prefill / decode steps; ``launches``: the gates on flash_attention's and
# flash_decode's totals; ``entries``: the kernels line's entry for each
# (mixer kind, kernel) of ``attention_calls``, with the launches of that
# kind's layers and timed at their shape (phase 5)
CROSS_STEPS = {
    "llama-3.2-vision-11b": dict(
        phase="7k", prompt=256, max_seq=2048, params=9_775_157_248,
        self_bytes=2_147_483_648, cross_bytes=419_430_400,
        launches=(40, 40 * 63),
        entries={("gqa", "flash_attention"): "flash_attention_vlm_self",
                 ("gqa", "flash_decode"): "flash_decode_vlm_self",
                 ("cross", "flash_attention"): "flash_attention_cross",
                 ("cross", "flash_decode"): "flash_decode_cross"}),
    "whisper-medium": dict(
        phase="7l", prompt=4, max_seq=448, params=813_500_416,
        self_bytes=352_321_536, cross_bytes=1_179_648_000,
        launches=(72, 48 * 63),
        entries={("enc", "flash_attention"): "flash_attention_encoder",
                 ("gqa", "flash_attention"): "flash_attention_whisper_self",
                 ("gqa", "flash_decode"): "flash_decode_whisper_self",
                 ("cross", "flash_attention"):
                     "flash_attention_whisper_cross",
                 ("cross", "flash_decode"): "flash_decode_whisper_cross"})}
CROSS_BATCH = 8
# whisper's start of transcript: <|startoftranscript|> <|en|> <|transcribe|>
# <|notimestamps|> (ids of its multilingual vocabulary)
WHISPER_SOT = (50258, 50259, 50359, 50363)
NEW_TOKENS = 64


def greedy(cfg, model, tokens, extra, caches, hook=None, n_new=NEW_TOKENS):
    """The steps' greedy loop on the tensors' device: ``make_prefill_step``
    on ``tokens`` [B, L], then ``n_new - 1`` ``make_decode_step`` calls at
    the scalar positions L, L + 1, ..., each step on the card ending in a
    synchronise (a server reads its tokens every step). Returns (streams
    [B, n_new] on the host, each step's last-position logits [n_new, B,
    vocab] on the device, prefill s, the decode steps' s); ``hook(i)`` runs
    before decode step i."""
    from repro_torch.train.step import make_decode_step, make_prefill_step
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    sync = torch.cuda.synchronize if tokens.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    logits, caches = prefill(model, tokens, caches, extra)
    out = [logits[:, -1]]
    tok = out[-1].argmax(-1)
    sync()
    t_prefill, steps, toks = time.perf_counter() - t0, [], [tok]
    L = tokens.shape[1]
    for i in range(n_new - 1):
        if hook is not None:
            hook(i)
        t0 = time.perf_counter()
        logits, caches = decode(model, tok[:, None], caches, L + i)
        out.append(logits[:, -1])
        tok = out[-1].argmax(-1)
        toks.append(tok)
        sync()
        steps.append(time.perf_counter() - t0)
    return torch.stack(toks, 1).cpu(), torch.stack(out), t_prefill, steps


def launches_by_mixer(run):
    """``run()``'s launches of both attention kernels, counted from 0, by
    the mixer kind of the layer that made them
    (parallel/mesh_jobs.py ``attention_launches``). Returns (run's result,
    {(mixer, kernel): launches} of those launched, {kernel: launches})."""
    from repro_torch.parallel import mesh_jobs as jobs
    with jobs.attention_launches() as counts:
        out = run()
    return out, counts["by_mixer"], counts["total"]


def cross_steps(results, card: str, arch: str):
    """Phases 7k / 7l: a cross-attention arch at its published width
    (random weights, seed 0, drawn at bf16; nothing cut) through the
    prefill / decode steps, the path the reference runs it on: 8 requests,
    each with its stub encoder input (N(0, 1), seed 0: llama-vision's 1600
    patch embeddings with a 256-token prompt, max_seq 2048; whisper's 1500
    frames with the 4-token start of transcript, max_seq 448), a prefill
    and 63 decode steps; both attention kernels counted from 0, by the
    mixer kind of the layers that launch them. Then a second run,
    profiled over decode steps ``PROFILE_WINDOW``, gated to the same
    streams."""
    from repro_torch import configs
    from repro_torch.launch.serve import profile_rows, profiler
    from repro_torch.models import transformer
    from repro_torch.train.step import attention_calls
    spec = CROSS_STEPS[arch]
    phase = f"steps {arch}"
    free_card(phase)
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get_config(arch, param_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = transformer.init_model(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    n_par = transformer.count_params(model)
    assert n_par == spec["params"], n_par
    B, max_seq = CROSS_BATCH, spec["max_seq"]
    width = cfg.cross_kv_dim if cfg.family == "vlm" else cfg.d_model
    extra = torch.randn(B, cfg.encoder_seq, width, device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(0)).to(torch.bfloat16)
    if arch == "whisper-medium":
        tokens = torch.tensor([WHISPER_SOT] * B, device="cuda")
    else:
        rng = np.random.default_rng(0)
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab, (B, spec["prompt"]))).to("cuda")
    caches = transformer.init_caches(cfg, B, max_seq, device="cuda")
    kinds = {"self": 0, "cross": 0}
    for (pattern, _), group in zip(cfg.groups, caches):
        for kind, leaves in zip(pattern, group):
            mixer = transformer.parse_kind(kind)[0]
            kinds["cross" if mixer == "cross" else "self"] += sum(
                t.nbytes for t in leaves.values())
    assert kinds == {"self": spec["self_bytes"],
                     "cross": spec["cross_bytes"]}, kinds
    greedy(cfg, model, tokens, extra, caches, n_new=3)    # first calls
    torch.cuda.synchronize()
    log(phase, f"set-up {time.perf_counter() - t0:.2f} s (with a warm-up "
        f"run): {arch} {cfg.n_layers()} layers ({len(cfg.groups[0][0])} a "
        f"unit: {', '.join(cfg.groups[0][0])}; encoder "
        f"{cfg.encoder_groups or 'none'}) d_model {cfg.d_model} heads "
        f"{cfg.n_heads}/{cfg.n_kv} hd {cfg.hd} d_ff {cfg.d_ff} ({cfg.mlp}, "
        f"{cfg.norm} norm) vocab {cfg.vocab}, {n_par} parameters in "
        f"{model.embed.dtype} ({2 * n_par} B); caches of {B} x {max_seq} "
        f"self rows and {B} x {cfg.encoder_seq} cross rows: self "
        f"{kinds['self']} B, cross {kinds['cross']} B")
    (streams, logits, t_pre, steps), by_mixer, total = launches_by_mixer(
        lambda: greedy(cfg, model, tokens, extra, caches))
    assert bool(torch.isfinite(logits).all()), "a logit is not finite"
    assert streams.shape == (B, NEW_TOKENS), streams.shape
    assert int(streams.min()) >= 0 and int(streams.max()) < cfg.vocab
    n_fa, n_fd = total["flash_attention"], total["flash_decode"]
    assert (n_fa, n_fd) == spec["launches"], (n_fa, n_fd)
    calls = attention_calls(cfg, B, spec["prompt"], max_seq, NEW_TOKENS)
    want = {(c.mixer, c.kernel): c.launches for c in calls}
    assert by_mixer == want, (by_mixer, want)
    for key, n in by_mixer.items():
        results[spec["entries"][key]]["launches"] = n
    wall = t_pre + sum(steps)
    itl = np.sort(np.array(steps)) * 1e3
    log(phase, f"{card}: {B} requests, prompts of {tokens.shape[1]} tokens "
        f"with {cfg.encoder_seq} x {width} stub encoder rows each, "
        f"{B * NEW_TOKENS} new tokens in {wall:.3f} s "
        f"({B * NEW_TOKENS / wall:.1f} tok/s), prefill {t_pre * 1e3:.2f} "
        f"ms, itl p50/p99 {np.percentile(itl, 50):.2f}/"
        f"{np.percentile(itl, 99):.2f} ms, every logit finite, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches: "
        f"flash_attention {n_fa}, flash_decode {n_fd} = "
        f"{n_fd // (NEW_TOKENS - 1)} attention layers x {NEW_TOKENS - 1} "
        f"decode steps; by layer kind "
        f"{ {f'{m} {k}': n for (m, k), n in by_mixer.items()} }; request "
        f"0's first tokens {streams[0, :12].tolist()}")
    prof, mark = profiler(), {}
    first, last = PROFILE_WINDOW

    def hook(i):           # the window leaves out the profiler's start-up
        if i == first:
            torch.cuda.synchronize()
            prof.start()
            mark[i] = time.perf_counter()
        elif i == last:
            torch.cuda.synchronize()
            mark[i] = time.perf_counter()
            prof.stop()

    again = greedy(cfg, model, tokens, extra, caches, hook)[0]
    assert torch.equal(again, streams), "a second run gave other streams"
    busy_us, rows = profile_rows(prof)
    wall_ms = (mark[last] - mark[first]) * 1e3
    top = "; ".join(f"{us / 1e3:.1f} ms {n}x {key[:48]}"
                    for us, n, key in rows[:5])
    log(phase, f"{card}: profiled second run (decode steps {first}-{last}, "
        f"the same streams): device busy {busy_us / 1e3:.1f} ms of "
        f"{wall_ms:.1f} ms wall ({100 * busy_us / 1e3 / wall_ms:.1f} %); "
        f"top kernels: {top}")


def steps_vs_cpu():
    """Both cross-attention smoke configs in f32 through the prefill /
    decode steps (``greedy``) on the card and on the CPU (asked for
    explicitly): 2 prompts of 8 tokens with their stub encoder input, then
    70 decode steps (whisper's past its 64 learned positions), every bias
    and norm of the seed-0 weights perturbed (at init they are 0 and 1);
    the same greedy streams and logits within 1e-3 at every step."""
    from repro_torch import configs
    from repro_torch.models import transformer
    for arch in CROSS_STEPS:
        cfg = configs.get_smoke_config(arch, compute_dtype=torch.float32)
        g = torch.Generator().manual_seed(1)
        model = transformer.init_model(cfg, torch.Generator().manual_seed(0))
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.startswith(("ln", "final_norm", "b")):
                p.add_(0.1 * torch.randn(p.shape, generator=g))
        width = cfg.cross_kv_dim if cfg.family == "vlm" else cfg.d_model
        extra = torch.randn(2, cfg.encoder_seq, width, generator=g)
        tokens = torch.randint(0, cfg.vocab, (2, 8), generator=g)
        runs = []
        for device in ("cpu", "cuda"):
            caches = transformer.init_caches(cfg, 2, 80, device=device)
            streams, logits = greedy(
                cfg, copy.deepcopy(model).to(device), tokens.to(device),
                extra.to(device), caches, n_new=71)[:2]
            runs.append((streams, logits.cpu()))
        err = (runs[1][1] - runs[0][1]).abs().max().item()
        assert torch.equal(runs[1][0], runs[0][0]), arch
        assert err <= 1e-3, (arch, err)
        log("card/cpu", f"smoke config f32, {arch}: prefill of 8 tokens and "
            f"70 decode steps (positions to 77; learned positions: "
            f"{cfg.learned_pos or 'none'}): greedy streams equal on cuda and "
            f"cpu, logits within {err:.2e} (tol 1e-3); stream 0 "
            f"{runs[0][0][0, :16].tolist()}...")


def card_vs_cpu():
    """The smoke config in f32, each stack on the card and on the CPU: the
    same streams, scheduling counters and shed verdicts."""
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.serve.cache import CacheConfig
    from repro_torch.serve.engine import Engine, EngineConfig
    from repro_torch.serve.kvcache import token_bytes
    from repro_torch.serve.policy import PolicyConfig
    cfg = configs.get_smoke_config("qwen2-0.5b", compute_dtype=torch.float32)
    model = transformer.init_model(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in (6, 13, 3, 9, 30, 1)]
    system = rng.integers(0, cfg.vocab, 12)
    shared = [np.concatenate([system, p[:5]]).astype(np.int32)
              for p in prompts]
    # the chunked shedding mix: 12 six-token requests over a 4-page hot
    # tier, every third one class 1, two with a deadline already lapsed
    rng = np.random.default_rng(0)
    shedding = [rng.integers(0, cfg.vocab, 6).astype(np.int32)
                for _ in range(12)]
    classes = [(1 if i % 3 == 0 else 0, None) for i in range(12)]
    for i in (10, 11):
        classes[i] = (0, 1e-6)
    budget = 16 * 2 * 12 * token_bytes(cfg) * 8
    small = dict(n_slots=3, max_seq=64, chunked=True, token_budget=8)
    tight = dict(page_tokens=8, n_pages=6, tiered=True)
    counters = ("preemptions", "preempted_mid_prefill", "swap_out_count",
                "swap_in_count", "swap_out_bytes", "swap_in_bytes",
                "admission_refusals", "prefix_hits", "decode_steps")
    for stack, conf, reqs, new, cls in (
            ("paged", EngineConfig(cache=CacheConfig(page_tokens=8),
                                   **small), prompts, 8, None),
            ("int8+prefix", EngineConfig(cache=CacheConfig(
                page_tokens=8, kv_dtype="int8", prefix=True), **small),
             shared, 8, None),
            ("tiered", EngineConfig(cache=CacheConfig(**tight), **small),
             prompts, 8, None),
            ("int8+tiered+prefix", EngineConfig(cache=CacheConfig(
                kv_dtype="int8", prefix=True, prefix_pages=2, **tight),
                **small), shared, 8, None),
            ("tiered, policy (the shedding mix)", EngineConfig(
                n_slots=2, max_seq=64, chunked=True, token_budget=6,
                policy=PolicyConfig(max_in_system=2, max_queue=4),
                cache=CacheConfig(page_tokens=8, n_pages=4, tiered=True,
                                  host_budget_bytes=budget)),
             shedding, 6, classes)):
        runs = []
        for device in ("cpu", "cuda"):
            eng = Engine(cfg, copy.deepcopy(model), config=conf,
                         device=device)
            streams = serve(eng, reqs, new, cls)
            runs.append((streams, {k: eng.stats[k] for k in counters},
                         [(r.seq_id, r.verdict.code) for r in eng.shed]))
        assert runs[1] == runs[0], (stack, runs)
        streams, count, shed = runs[1]
        if conf.cache.tiered and conf.policy is None:
            # every request arrives at once, so the churn leaves the tiered
            # prefix stack no completed prefill to hit: preemption is gated
            assert count["preemptions"] >= 1, (stack, count)
        elif conf.cache.prefix:
            assert count["prefix_hits"] > 0, (stack, count)
        if conf.policy is not None:
            assert count["admission_refusals"] == 0 and len(shed) == 6
        log("card/cpu", f"smoke config f32, {stack} stack: {len(streams)} "
            f"greedy streams equal on cuda and cpu, and the counters "
            f"{count}" + (f", shed {shed}" if shed else ""))
    # the dense and monolithic paged loops on a ragged mix: the dense
    # engine keeps each slot at its own position
    rng = np.random.default_rng(1)
    ragged = [rng.integers(0, cfg.vocab, n).astype(np.int32)
              for n in (3, 9, 5, 12)]
    four = dict(n_slots=4, max_seq=64)
    for stack, conf in (
            ("dense", EngineConfig(**four)),
            ("monolithic paged", EngineConfig(
                cache=CacheConfig(paged=True, page_tokens=8), **four)),
            ("monolithic int8+tiered", EngineConfig(cache=CacheConfig(
                paged=True, page_tokens=8, kv_dtype="int8", tiered=True,
                n_pages=4), **four))):
        runs = []
        for device in ("cpu", "cuda"):
            eng = Engine(cfg, copy.deepcopy(model), config=conf,
                         device=device)
            runs.append((serve(eng, ragged, 6),
                         {k: eng.stats[k] for k in counters}))
        assert runs[1] == runs[0], (stack, runs)
        streams, count = runs[1]
        if conf.cache.tiered:
            assert count["preemptions"] >= 1, (stack, count)
        log("card/cpu", f"smoke config f32, {stack} engine, prompts of 3, 9,"
            f" 5 and 12 tokens: {len(streams)} greedy streams equal on cuda "
            f"and cpu, and the counters {count}")
    gcfg = configs.get_smoke_config("gemma3-27b", compute_dtype=torch.float32)
    gmodel = transformer.init_model(gcfg, torch.Generator().manual_seed(0))
    grng = np.random.default_rng(1)
    gprompts = [grng.integers(0, gcfg.vocab, n).astype(np.int32)
                for n in (3, 9, 5, 12)]
    runs = []
    for device in ("cpu", "cuda"):
        eng = Engine(gcfg, copy.deepcopy(gmodel), device=device,
                     config=EngineConfig(**four))
        runs.append((serve(eng, gprompts, 6),
                     {k: eng.stats[k] for k in counters}))
    assert runs[1] == runs[0], ("gemma3-27b", runs)
    log("card/cpu", f"smoke config f32, gemma3-27b (window {gcfg.window}: "
        f"the 9- and 12-token prompts wrap their rings), dense engine, "
        f"prompts of 3, 9, 5 and 12 tokens: {len(runs[1][0])} greedy streams "
        f"equal on cuda and cpu, and the counters {runs[1][1]}")
    fleet_vs_single(cfg, model)
    for arch in ZOO:
        zcfg = configs.get_smoke_config(arch, compute_dtype=torch.float32)
        zmodel = transformer.init_model(zcfg, torch.Generator().manual_seed(0))
        zrng = np.random.default_rng(4)
        zprompts = [zrng.integers(0, zcfg.vocab, n).astype(np.int32)
                    for n in (6, 13, 3, 9, 30, 1)]
        runs = []
        for device in ("cpu", "cuda"):
            eng = Engine(zcfg, copy.deepcopy(zmodel), device=device,
                         config=EngineConfig(cache=CacheConfig(page_tokens=8),
                                             **small))
            runs.append((serve(eng, zprompts, 8),
                         {k: eng.stats[k] for k in counters}))
        assert runs[1] == runs[0], (arch, runs)
        kind = "MoE" if zcfg.moe else zcfg.mlp
        log("card/cpu", f"smoke config f32, {arch} ({kind}, "
            f"{'tied' if zcfg.tie_embeddings else 'untied'}), chunked "
            f"engine: {len(runs[1][0])} greedy streams equal on cuda and "
            f"cpu, and the counters {runs[1][1]}")
    # granite-moe through the monolithic paged and dense engines too: its
    # rows share expert capacity, and the dense prefill routes every slot's
    mcfg = configs.get_smoke_config("granite-moe-3b-a800m",
                                    compute_dtype=torch.float32)
    mmodel = transformer.init_model(mcfg, torch.Generator().manual_seed(0))
    mrng = np.random.default_rng(1)
    mprompts = [mrng.integers(0, mcfg.vocab, n).astype(np.int32)
                for n in (3, 9, 5, 12)]
    for stack, conf in (
            ("monolithic paged", EngineConfig(
                cache=CacheConfig(paged=True, page_tokens=8), **four)),
            ("dense", EngineConfig(**four))):
        runs = []
        for device in ("cpu", "cuda"):
            eng = Engine(mcfg, copy.deepcopy(mmodel), device=device,
                         config=conf)
            runs.append((serve(eng, mprompts, 6),
                         {k: eng.stats[k] for k in counters}))
        assert runs[1] == runs[0], ("granite-moe-3b-a800m", stack, runs)
        log("card/cpu", f"smoke config f32, granite-moe-3b-a800m (MoE), "
            f"{stack} engine, prompts of 3, 9, 5 and 12 tokens: "
            f"{len(runs[1][0])} greedy streams equal on cuda and cpu, and "
            f"the counters {runs[1][1]}")


def dense_zoo_vs_cpu():
    """The xlstm-1.3b, zamba2-1.2b and deepseek-v3-671b smoke configs in
    f32 through the dense engine on the card and on the CPU: the ragged
    mix in four slots, then six prompts past the smoke chunk of 32 tokens
    in two slots (gla_chunked carries state across chunks; four requests
    land in reused slots, whose prefill starts from a zero state, or over
    the latents an earlier request left). The same streams and counters,
    and for the recurrent archs each slot-reuse stream equal to its
    request served alone on the card (deepseek's MoE couples a call's
    rows, so alone is another computation)."""
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Engine, EngineConfig
    counters = ("decode_steps", "decode_tokens", "prefills",
                "admission_refusals")
    four = dict(n_slots=4, max_seq=64)
    for arch in ("xlstm-1.3b", "zamba2-1.2b", "deepseek-v3-671b"):
        rcfg = configs.get_smoke_config(arch, compute_dtype=torch.float32)
        rmodel = transformer.init_model(rcfg,
                                        torch.Generator().manual_seed(0))
        rrng = np.random.default_rng(1)
        mixes = (("prompts of 3, 9, 5 and 12 tokens in 4 slots", four,
                  (3, 9, 5, 12)),
                 ("six prompts of 33-70 tokens in 2 slots (slot reuse)",
                  dict(n_slots=2, max_seq=96), (40, 70, 35, 66, 33, 50)))
        for what, kw, lens in mixes:
            rprompts = [rrng.integers(0, rcfg.vocab, n).astype(np.int32)
                        for n in lens]
            runs = []
            for device in ("cpu", "cuda"):
                eng = Engine(rcfg, copy.deepcopy(rmodel), device=device,
                             config=EngineConfig(**kw))
                runs.append((serve(eng, rprompts, 6),
                             {k: eng.stats[k] for k in counters}))
            assert runs[1] == runs[0], (arch, what, runs)
            alone = kw["n_slots"] < len(lens) and \
                not transformer.couples_rows(rcfg)
            if alone:
                for i, p in enumerate(rprompts):
                    alone = serve(Engine(rcfg, copy.deepcopy(rmodel),
                                         device="cuda",
                                         config=EngineConfig(**kw)), [p], 6)
                    assert alone[0] == runs[1][0][i], (arch, i)
            log("card/cpu", f"smoke config f32, {arch}, dense engine, "
                f"{what}: {len(runs[1][0])} greedy streams equal on cuda and "
                f"cpu, and the counters {runs[1][1]}"
                + (", each stream equal to its request alone" if alone
                   else ""))


def fleet_vs_single(cfg, model):
    """A two-replica prefix fleet of chunked engines with r0 killed at
    iteration 4 and respawned at 9, on the card and on the CPU: the same
    streams, placements and fleet counters, and the streams of one chunked
    engine."""
    from repro_torch.serve.cache import CacheConfig
    from repro_torch.serve.engine import Engine, EngineConfig, Request
    from repro_torch.serve.replica import DEAD, READY
    from repro_torch.serve.router import Fleet
    conf = EngineConfig(n_slots=2, max_seq=64, token_budget=12,
                        cache=CacheConfig(page_tokens=8, n_pages=24,
                                          prefix=True, prefix_pages=6))
    rng = np.random.default_rng(2)
    shared = rng.integers(0, cfg.vocab, 12)
    mix = []          # (arrival iteration, seq_id, prompt, max_new)
    for i in range(8):
        suffix = rng.integers(0, cfg.vocab, 2 + int(rng.integers(0, 4)))
        mix.append((2 * i, i,
                    np.concatenate([shared, suffix]).astype(np.int32),
                    3 + int(rng.integers(0, 4))))

    def drive(target, hook=None):
        pending, done, it = list(mix), [], 0
        while True:
            while pending and pending[0][0] <= it:
                _, sid, p, new = pending.pop(0)
                assert target.submit(Request(seq_id=sid, prompt=p.copy(),
                                             max_new=new))
            if hook is not None:
                hook(it)
            if not pending and target.idle:
                return {int(r.seq_id): list(r.tokens_out) for r in done}
            done += target.step()
            it += 1
            assert it < 2000, "the mix did not drain"

    runs = []
    for device in ("cpu", "cuda"):
        single = drive(Engine(cfg, copy.deepcopy(model), config=conf,
                              device=device))
        fleet = Fleet(cfg, copy.deepcopy(model), conf, replicas=2,
                      device=device)
        placements = []
        for rep in fleet.replicas:
            def submit(req, rep=rep, inner=rep.submit):
                ok = inner(req)
                placements.append((int(req.seq_id), rep.name))
                return ok
            rep.submit = submit

        def hook(it):
            if it == 4:
                fleet.kill("r0")
            elif it == 9:
                assert fleet.respawn("r0").state == READY

        streams = drive(fleet, hook)
        assert streams == single, (device, streams, single)
        for rep in fleet.replicas:
            fleet.drain(rep.name)
        fleet.run(50)
        for rep in fleet.replicas:
            assert rep.state == DEAD
            a = rep.engine.pool.alloc
            assert a._seq_pages == {}
            a.audit()
        runs.append((streams, dict(fleet.stats), placements))
    assert runs[1] == runs[0], runs
    stats = runs[1][1]
    assert stats["requeued_kill"] > 0 and stats["respawns"] == 1, stats
    log("card/cpu", f"smoke config f32, a two-replica prefix fleet with r0 "
        f"killed at iteration 4 and respawned at 9: {len(runs[1][0])} greedy"
        f" streams equal on cuda and cpu and equal to one chunked engine's, "
        f"the same {len(runs[1][2])} placements and fleet counters {stats}")


# ---------------------------------------------------------------------------
# phase 9: the training path
# ---------------------------------------------------------------------------
TRAIN = dict(arch="qwen2-0.5b", seq=4096, batch=4, grad_accum=2, steps=3,
             ckpt_every=2, lr=3e-3,
             # cut in depth at full width (9a and 10c alike), to keep the
             # script inside its time limit: 8 of the 24 layers
             overrides=dict(groups=((("gqa:mlp",), 8),)))


def train_full(card: str):
    """Phase 9a (see the module docstring)."""
    import shutil
    from repro_torch import configs
    from repro_torch import kernels as kernels_lib
    from repro_torch.checkpoint.manager import MANIFEST, CheckpointManager
    from repro_torch.launch import train as train_lib
    from repro_torch.core import tree as tree_lib
    from repro_torch.launch.serve import profile_rows, profiler
    from repro_torch.models import transformer
    from repro_torch.train import step as step_lib
    phase = f"train {TRAIN['arch']}"
    free_card(phase)
    cfg = configs.get_config(TRAIN["arch"], **TRAIN["overrides"])
    full = configs.get_config(TRAIN["arch"])
    assert (cfg.param_dtype, cfg.compute_dtype, cfg.remat) == (
        torch.float32, torch.bfloat16, "full"), cfg
    n_par = transformer.count_params(transformer.init_model(cfg, None,
                                                            "meta"))
    ckpt = os.path.join(ROOT, "build", "train_smoke_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    kernels = kernels_lib.wrappers()
    for k in kernels.values():
        k.launches = 0
    steps, prof, m_sq = [], profiler(), []

    def on_step(step, loss, dt, state, metrics):
        steps.append((step, loss, dt, time.perf_counter(),
                      float(metrics["grad_norm"])))
        if step == 1:                  # profile steps 2-3
            m_sq.extend(float(t.double().square().sum()) for t in
                        tree_lib.leaves(step_lib.state_tree(state).opt.m))
            torch.cuda.synchronize()
            prof.start()
        elif step == 3:
            torch.cuda.synchronize()
            prof.stop()

    args = (TRAIN["arch"], False, TRAIN["steps"], ckpt, TRAIN["batch"],
            TRAIN["seq"], TRAIN["lr"])
    kw = dict(ckpt_every=TRAIN["ckpt_every"], grad_accum=TRAIN["grad_accum"],
              device="cuda", log_every=1, overrides=TRAIN["overrides"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = train_lib.train(*args, on_step=on_step, **kw)
    t_end = time.perf_counter()
    wall = t_end - t0
    # host-clock breakdown of the run around its three steps
    setup = steps[0][3] - steps[0][2] - t0
    between = steps[2][3] - steps[2][2] - steps[1][3]
    tail = t_end - steps[2][3]
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {n: k.launches for n, k in kernels.items()}
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses), losses
    assert not any(launches.values()), launches
    busy_us, rows = profile_rows(prof)
    # the step-2 checkpoint's snapshot (device-to-host copies) falls between
    # the two profiled steps, outside their step times: left out of both
    snap_us = sum(us for us, _, key in rows if key.startswith("Memcpy DtoH"))
    busy_ms = (busy_us - snap_us) / 1e3
    step_ms = [st[2] * 1e3 for st in steps]
    prof_ms = step_ms[1] + step_ms[2]
    tokens = TRAIN["batch"] * TRAIN["seq"]
    top = "; ".join(f"{us / 1e3:.1f} ms {n}x {key[:48]}"
                    for us, n, key in rows[:8])
    log(phase, f"{card}: {cfg.n_layers()} layers d_model {cfg.d_model} "
        f"heads {cfg.n_heads}/{cfg.n_kv} d_ff {cfg.d_ff} vocab {cfg.vocab} "
        f"(cut in depth to {cfg.n_layers()} of its {full.n_layers()} "
        f"layers at full width, to keep the script inside its time "
        f"limit), {n_par} parameters, f32 master weights, bf16 "
        f"compute, remat {cfg.remat}; batch {TRAIN['batch']} x seq "
        f"{TRAIN['seq']} in {TRAIN['grad_accum']} microbatches; losses "
        + ", ".join(f"step {st[0]} {st[1]:.4f}" for st in steps)
        + "; step ms " + ", ".join(f"{m:.1f}" for m in step_ms)
        + " (host clock, each ending in a synchronize; step 1 with the "
        f"warm-up, steps 2-3 under the profiler, so not the step time: "
        f"see the restart below); tokens/s "
        + ", ".join(f"{tokens / m * 1e3:.0f}" for m in step_ms)
        + f"; peak memory {peak:.2f} GiB; {wall:.1f} s in train(): "
        f"{setup:.1f} s before step 1 (weights, state), {between:.1f} s "
        f"between steps 2 and 3 (the step-2 checkpoint's snapshot), "
        f"{tail:.1f} s after step 3 (the profiler's stop, the last "
        f"checkpoint); launches of the hand-written kernels: "
        f"{sum(launches.values())}")
    log(phase, f"{card}: device busy over steps 2-3 {busy_ms:.1f} ms of "
        f"{prof_ms:.1f} ms ({100 * busy_ms / prof_ms:.1f} %; the step-2 "
        f"checkpoint's {snap_us / 1e3:.1f} ms of device-to-host copies "
        f"left out); top device ops: {top}")
    # the restart: step 3's checkpoint removed, a second train() resumes
    shutil.rmtree(os.path.join(ckpt, "step_00000003"))
    assert CheckpointManager(ckpt).latest_step() == 2
    again = []
    t0 = time.perf_counter()
    resumed = train_lib.train(
        *args, on_step=lambda step, loss, dt, state, metrics: again.append(
            (step, loss, dt)), **kw)
    wall = time.perf_counter() - t0
    with open(os.path.join(ckpt, "step_00000003", MANIFEST)) as f:
        data_step = json.load(f)["extra"]["data_step"]
    rel = abs(resumed[0] - losses[2]) / abs(losses[2])
    assert len(resumed) == 1 and again[0][0] == 3 and data_step == 3, \
        (resumed, again, data_step)
    assert rel <= 1e-3, (resumed, losses)
    assert not any(k.launches for k in kernels.values())
    shutil.rmtree(ckpt)
    step_s = again[0][2]
    log(phase, f"{card}: restart from the step-2 checkpoint: resumed at "
        f"data step 2, step 3 loss {resumed[0]:.6f} against "
        f"{losses[2]:.6f} uninterrupted (rel {rel:.2e}); {wall:.1f} s with "
        f"the restore and the last checkpoint")
    log(phase, f"{card}: step time (the restarted step 3, no profiler, "
        f"host clock ending in a synchronize) {step_s * 1e3:.1f} ms, "
        f"{tokens / step_s:.0f} tokens/s")
    return [(st[0], st[1], st[4]) for st in steps], m_sq


def snapshot(state):
    """(weights, m, v) of a train state as host numpy trees."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.train import step as step_lib
    t = step_lib.state_tree(state)
    return tuple(tree_lib.tree_map(tree_lib.to_host, x)
                 for x in (t.params, t.opt.m, t.opt.v))


def train_vs_cpu():
    """Phase 9b (see the module docstring)."""
    from repro_torch import configs
    from repro_torch.core import tree as tree_lib
    from repro_torch.data import pipeline as dp
    from repro_torch.models import transformer
    from repro_torch.models.convert import params_from_numpy, params_to_numpy
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_lib
    phase = "train card/cpu"
    for arch in ("qwen2-0.5b", "deepseek-v3-671b"):
        cfg = configs.get_smoke_config(arch, compute_dtype=torch.float32)
        tree = params_to_numpy(transformer.init_model(
            cfg, torch.Generator().manual_seed(0), "cpu"))
        opt = adamw.Config()
        ts = step_lib.make_train_step(cfg, opt, grad_accum=2)
        dcfg = dp.DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4,
                             mtp=cfg.mtp)
        runs = {}
        for dev in ("cuda", "cpu"):
            state = step_lib.init_state(params_from_numpy(tree, cfg, dev))
            metrics, trail = [], [snapshot(state)]
            for s in range(2):
                state, m = ts(state, dp.to_device(dp.make_batch(dcfg, s),
                                                  dev))
                metrics.append({k: float(v) for k, v in m.items()})
                trail.append(snapshot(state))
            runs[dev] = (metrics, trail)
        (gm, gt), (cm, ct) = runs["cuda"], runs["cpu"]
        worst = {"loss": 0.0, "grad_norm": 0.0}
        for g, c in zip(gm, cm):
            for k in worst:
                worst[k] = max(worst[k], abs(g[k] - c[k]) / abs(c[k]))
        assert max(worst.values()) <= 1e-4, (arch, worst, gm, cm)
        floor = 2 * sum(m["lr"] for m in cm)
        keys = [key for key, _ in tree_lib.paths(gt[0][0])]
        flagged, worst_update, n_out = None, (0.0, ""), []
        for s in range(2):
            (g_p0, _, _), (g_p1, g_m, g_v) = gt[s], gt[s + 1]
            (c_p0, c_m0, _), (c_p1, c_m, c_v) = ct[s], ct[s + 1]
            # the CPU's gradient as the optimizer saw it, from its first
            # moment: an element whose Adam step the rounding decides is
            # left out of the update's check from then on
            now = []
            for m0, m1 in zip(tree_lib.leaves(c_m0), tree_lib.leaves(c_m)):
                a = np.abs((m1 - opt.b1 * m0) / (1 - opt.b1))
                now.append((a > 0) & (a <= 1e-4 * a.max()))
            flagged = now if flagged is None else [
                a | b for a, b in zip(flagged, now)]
            n_out.append(sum(int(f.sum()) for f in flagged))
            lr = cm[s]["lr"]
            for key, q0, q1, p0, p1, f in zip(
                    keys, tree_lib.leaves(g_p0), tree_lib.leaves(g_p1),
                    tree_lib.leaves(c_p0), tree_lib.leaves(c_p1), flagged):
                # in units of lr, less the new weights' f32 rounding
                err = (np.abs((q1 - q0) - (p1 - p0))
                       - 2 * np.spacing(np.abs(p1)))[~f] / lr
                top = float(err.max(initial=0))
                if top > worst_update[0]:
                    worst_update = (top, f"{key} after step {s + 1}")
            for part, got, ref in (("m", g_m, c_m), ("v", g_v, c_v)):
                for key, a, b, f in zip(keys, tree_lib.leaves(got),
                                        tree_lib.leaves(ref), flagged):
                    err = np.abs(a - b)[~f]
                    assert (err <= 1e-4 * (np.abs(b)[~f] + np.abs(b).max())
                            ).all(), (arch, s, part, key)
        n_all = sum(f.size for f in flagged)
        assert n_out[-1] <= 0.02 * n_all, (arch, n_out, n_all)
        assert worst_update[0] <= 1e-3, (arch, worst_update)
        n_leaves = 0
        for key, a, b in zip(keys, tree_lib.leaves(gt[-1][0]),
                             tree_lib.leaves(ct[-1][0])):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=floor,
                                       err_msg=f"{arch} {key}")
            n_leaves += 1
        log(phase, f"{arch} f32 smoke, 2 steps of grad_accum 2 on card and "
            "CPU from the same weights: losses "
            + ", ".join(f"{g['loss']:.6f}/{c['loss']:.6f}"
                        for g, c in zip(gm, cm))
            + f" (card/cpu), worst rel loss {worst['loss']:.2e}, grad_norm "
            f"{worst['grad_norm']:.2e}; all {n_leaves} weight leaves within "
            f"1e-4 (+ {floor:.1e} abs); each element's change over a step "
            f"within 1e-3 of lr (+ 2 f32 spacings), worst "
            f"{worst_update[0]:.2e} of lr ({worst_update[1]}), and m, v "
            f"within 1e-4 of each leaf's largest, but for "
            f"{n_out[0]} / {n_out[1]} of {n_all} elements after steps 1 / 2 "
            "whose CPU gradient is nonzero and within 1e-4 of its leaf's "
            "largest (Adam's step there is the rounding's)")


# --------------------------------------------------------------------------
# phase 10: the mesh paths (gloo ranks sharing the card: every wall time
# there is transport for correctness, never speed)
# --------------------------------------------------------------------------
def _spawn(fn, n, args, timeout_s):
    import tempfile
    from repro_torch.parallel import launch
    with tempfile.TemporaryDirectory() as store:
        return launch.spawn(fn, n, args, store_dir=store, backend="gloo",
                            timeout_s=timeout_s)


TRANSPORT_NOTE = ("transport: gloo, a CUDA tensor staged through the host "
                  "(parallel/sharding.py; the ring an all-gather and a "
                  "pick), for correctness only")


def gpipe_full(card: str):
    """Phase 10a (see the module docstring)."""
    from repro_torch.parallel import pipeline
    from repro_torch.parallel import mesh_jobs as jobs
    phase = "gpipe qwen2-0.5b"
    free_card(phase)
    job = jobs.PipelineJob(stages=4, n_layers=24, arch="qwen2-0.5b", seed=0,
                           micro=8, rows=1, seq=1024, device="cuda:0")
    t0 = time.perf_counter()
    ref = jobs.sequential(job, torch.device("cuda"))
    seq_s = time.perf_counter() - t0
    free_card(phase, "after the sequential reference")
    t0 = time.perf_counter()
    out = _spawn(jobs.pipeline_job, 4, (job,), 900.0)
    spawn_s = time.perf_counter() - t0
    per = job.n_layers // job.stages
    worst, n = {"ys": 0.0, "x_grad": 0.0, "w_grads": 0.0}, 0
    for r in out:
        s = r["stage"]
        pairs = [("ys", r["ys"], ref["ys"]),
                 ("x_grad", r["x_grad"], ref["x_grad"])] + [
            ("w_grads", r["w_grads"][k], v[s * per:(s + 1) * per])
            for k, v in ref["w_grads"].items()]
        for what, got, want in pairs:
            got, want = torch.from_numpy(got), torch.from_numpy(want)
            diff = (got - want).abs()
            assert torch.isfinite(got).all() and bool(
                (diff <= bf16_step(want)).all()), (what, s, diff.max())
            worst[what] = max(worst[what], float(diff.max()))
            n += got.numel()
        assert r["ticks"] == 11 and r["launches"] == 0, r
    assert sorted(r["stage"] for r in out) == [0, 1, 2, 3]
    log(phase, f"{card}: 24 layers (d_model 896, heads 14/2, d_ff 4864, "
        f"bf16, seed 0, nothing cut) in 4 stages of 6 on 4 gloo ranks of "
        f"cuda:0, 8 microbatches of [1, 1024, 896]: outputs, input and "
        f"weight gradients ({n} values over the 4 ranks) within one bf16 "
        f"step of the sequential layers on the card; largest difference "
        f"ys {worst['ys']:.3e}, input grad {worst['x_grad']:.3e}, weight "
        f"grads {worst['w_grads']:.3e}; {out[0]['ticks']} ticks, bubble "
        f"{pipeline.bubble_fraction(4, 8):.4f} (3/11); launches of the "
        f"kernels {sum(r['launches'] for r in out)}; sequential reference "
        f"{seq_s:.1f} s; ranks' forward + backward "
        + ", ".join(f"{r['wall_s']:.1f}" for r in sorted(
            out, key=lambda r: r["stage"]))
        + " s, peak " + ", ".join(f"{r['peak_gib']:.2f}" for r in sorted(
            out, key=lambda r: r["stage"]))
        + f" GiB a rank, the whole spawn {spawn_s:.1f} s ({TRANSPORT_NOTE})")


def _meshless_moe(p, x, cfg):
    """The meshless layer on ``x``, and each element's bound on a mesh
    path's difference from it: the all-reduce order re-rounds at most the
    k - 1 bf16 adds of a token's terms on either side, the cast of the f32
    sum and the shared expert's add, each by at most 2^-8 of the sum of
    the magnitudes of its terms and shared output (the terms themselves
    may round one step apart: 2^-7 of that sum) → (y, aux, bound, drops,
    routed), host tensors and numbers."""
    from repro_torch.models import moe
    with torch.no_grad():
        y, aux = moe.moe_forward(p, x, cfg)
        xf = x.reshape(-1, cfg.d_model)
        gates, idx, _ = moe.route(p["router"], xf, cfg)
        sg, st, sv = moe.select(gates, idx, cfg)
        xg = torch.where(sv[..., None], xf[st], torch.zeros_like(xf[st]))
        ye = moe._experts(xg, p["w_gate"], p["w_up"], p["w_down"])
        ye = ye * sg[..., None].to(ye.dtype)
        mag = moe._combine(ye.float().abs(), idx, st, sv)
        if cfg.n_shared:
            sh = p["shared"]
            mag = mag + (F.silu(xf @ sh["w_gate"]) * (xf @ sh["w_up"])
                         @ sh["w_down"]).float().abs()
        bound = ((2 * cfg.top_k + 2) * 2.0**-8 * mag).reshape(y.shape)
        drops = int(moe.dropped(idx, st, sv, cfg.n_experts))
    return y.float().cpu(), float(aux), bound.cpu(), drops, idx.numel()


def moe_mesh_full(card: str):
    """Phase 10b (see the module docstring)."""
    from repro_torch import configs
    from repro_torch.parallel import mesh_jobs as jobs
    phase = "moe mesh"
    free_card(phase)
    ds = configs.get_config("deepseek-v3-671b").moe
    gr = configs.get_config("granite-moe-3b-a800m").moe
    assert (ds.n_experts, ds.d_model, ds.d_ff, ds.n_shared, ds.router,
            ds.ep) == (256, 7168, 2048, 1, "sigmoid", True), ds
    assert (gr.n_experts, gr.ep) == (40, False), gr
    cases = {"deepseek-v3-671b gather": (ds, "ep"),
             "deepseek-v3-671b a2a": (dataclasses.replace(
                 ds, dispatch="a2a"), "a2a"),
             "granite-moe-3b-a800m slot-parallel": (gr, "slot")}
    mesh_jobs = [jobs.MoeJob(cfg=cfg, mesh=(1, 4), seed=0, tokens=(8, 256),
                             dtype=torch.bfloat16, device="cuda:0")
                 for cfg, _ in cases.values()]
    expert_gb = 3 * ds.n_experts * ds.d_model * ds.d_ff * 2 / 1e9
    device = torch.device("cuda")
    t0 = time.perf_counter()
    meshless = {}
    for arch in ("deepseek-v3-671b", "granite-moe-3b-a800m"):
        job = mesh_jobs[0 if arch.startswith("deepseek") else 2]
        cfg = job.cfg
        p = jobs.draw_moe(cfg, 0, cfg.n_experts, job.seed, device, job.dtype)
        x = jobs.moe_input(job, device)
        meshless[arch] = _meshless_moe(p, x, cfg)
        if arch.startswith("deepseek"):   # a2a: each sequence part alone
            L = x.shape[1]
            parts = [_meshless_moe(p, x[:, m * L // 4:(m + 1) * L // 4],
                                   cfg) for m in range(4)]
            meshless["parts"] = (torch.cat([q[0] for q in parts], 1),
                                 torch.cat([q[2] for q in parts], 1),
                                 [q[3] for q in parts])
        del p, x
        free_card(phase, f"after the meshless {arch} layer")
    ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = _spawn(jobs.each, 4, (jobs.moe_job, mesh_jobs), 900.0)
    spawn_s = time.perf_counter() - t0
    for i, (name, (cfg, path)) in enumerate(cases.items()):
        y0, aux0, bound, drops0, routed = meshless[name.split()[0]]
        ranks = sorted((r[i] for r in out), key=lambda r: r["coords"]["model"])
        assert all(r["path"] == path and r["launches"] == 0
                   for r in ranks), [(r["path"], r["launches"]) for r in ranks]
        y = torch.from_numpy(ranks[0]["y"])
        for r in ranks[1:]:          # every model rank holds the output
            assert torch.equal(torch.from_numpy(r["y"]), y), name
        assert torch.isfinite(y).all()
        diff = (y - y0).abs()
        within = diff <= bound
        rel = float((y - y0).norm() / y0.norm())
        if path == "a2a":
            share = float(within.float().mean())
            assert share >= 0.95, (name, share)
            y_parts, b_parts, d_parts = meshless["parts"]
            d_own = (y - y_parts).abs()
            assert bool((d_own <= b_parts).all()), float(
                (d_own - b_parts).max())
            assert [r["drops"][0] for r in ranks] == d_parts, (ranks, d_parts)
            aux = [r["aux"] for r in ranks]
            assert len(set(aux)) == 1, aux
            log(phase, f"{card}: {name}: 4 gloo ranks, each its 64 experts "
                f"and a 64-token part of each of the 8 rows, routed alone "
                f"(the reference's a2a: capacity per sequence shard), two "
                f"all-to-alls: every element within the bound of the "
                f"meshless layer run on each part alone (largest difference "
                f"{float(d_own.max()):.3e}); against the meshless layer on "
                f"all 2048 tokens (the reference's criterion) "
                f"{100 * share:.2f} % of elements within the bound (gate "
                f"95 %), rel {rel:.3e}; drops per sequence part "
                + ", ".join(f"{r['drops'][0]}/{r['drops'][1]}"
                            for r in ranks)
                + f" against {drops0}/{routed} on all tokens; aux "
                f"{aux[0]:.6f} (mean over the parts) against {aux0:.6f}; "
                "rank walls "
                + ", ".join(f"{r['wall_s']:.2f}" for r in ranks)
                + f" s ({TRANSPORT_NOTE}); launches 0")
            continue
        used = float((diff / bound)[bound > 0].max())
        assert bool(within.all()), (name, float((diff - bound).max()))
        assert rel <= 1e-2, (name, rel)
        assert all(abs(r["aux"] - aux0) <= 1e-6 * abs(aux0)
                   for r in ranks), (name, aux0, [r["aux"] for r in ranks])
        what = ("EP: each rank its 64 experts (drawn alone from per-expert "
                f"seeds; {expert_gb:.1f} GB of experts in all at bf16)"
                if path == "ep" else
                f"slot-parallel: all {cfg.n_experts} experts on each rank, "
                "rank r slot slice r of each expert's capacity")
        log(phase, f"{card}: {name}: 4 gloo ranks (model = 4), {what}, the "
            f"partial outputs summed over the ranks in f32: every element "
            f"within the all-reduce order's bound of the meshless layer, "
            f"largest difference {float(diff.max()):.3e}, at most "
            f"{used:.3f} of an element's bound, rel {rel:.3e}; aux "
            f"{ranks[0]['aux']:.6f} against {aux0:.6f}; drops "
            f"{ranks[0]['drops'][0]}/{ranks[0]['drops'][1]} on every rank "
            f"against {drops0}/{routed} meshless; rank walls "
            + ", ".join(f"{r['wall_s']:.2f}" for r in ranks)
            + f" s ({TRANSPORT_NOTE}); launches 0")
    log(phase, f"meshless layers {ref_s:.1f} s, the spawn {spawn_s:.1f} s")


def fsdp_full(card: str, ref_steps):
    """Phase 10c (see the module docstring); ``ref_steps``: phase 9a's
    (step, loss, grad norm)."""
    import shutil
    from repro_torch import configs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import tree as tree_lib
    from repro_torch.launch import train as train_lib
    from repro_torch.parallel import sharding
    from repro_torch.train import step as step_lib
    from repro_torch.parallel import mesh_jobs as jobs
    phase = f"fsdp {TRAIN['arch']}"
    free_card(phase)
    ckpt = os.path.join(ROOT, "build", "fsdp_smoke_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    kw = dict(arch=TRAIN["arch"], smoke=False, steps_total=2, ckpt_dir=ckpt,
              batch=TRAIN["batch"], seq=TRAIN["seq"], lr=TRAIN["lr"],
              ckpt_every=TRAIN["ckpt_every"],
              grad_accum=TRAIN["grad_accum"], device="cuda", log_every=1,
              overrides=TRAIN["overrides"])
    t0 = time.perf_counter()
    out = _spawn(jobs.train_job, 2, (jobs.TrainJob(kwargs=kw),), 1500.0)
    spawn_s = time.perf_counter() - t0
    worst = {"loss": 0.0, "grad_norm": 0.0}
    for r in out:
        assert [st["step"] for st in r["steps"]] == [1, 2], r["steps"]
        assert r["launches"] == 0, r["launches"]
        for st, (step, loss, gnorm) in zip(r["steps"], ref_steps):
            for k, ref in (("loss", loss), ("grad_norm", gnorm)):
                worst[k] = max(worst[k], abs(st[k] - ref) / abs(ref))
    assert max(worst.values()) <= 1e-3, (worst, out[0]["steps"], ref_steps)
    # the 2 ranks' checkpoint at 1 rank: equal to each rank's shards
    mgr = CheckpointManager(ckpt)
    assert mgr.latest_step() == 2
    cfg = configs.get_config(TRAIN["arch"], **TRAIN["overrides"])
    t1 = time.perf_counter()
    state = train_lib.build_state(cfg, 1, "cuda")     # another seed
    host, extra = mgr.restore(step_lib.state_tree(state))
    step_lib.load_state(state, host)
    assert extra == {"data_step": 2} and int(state.step) == 2
    mesh = sharding.Mesh.abstract((2, 1), ("data", "model"))
    specs = step_lib.state_specs(step_lib.param_specs(state.params, mesh))
    for r in out:
        rank = mesh.rank_at(r["coords"])
        shards = [tree_lib.to_host(sharding.shard_of(t, s, mesh, rank))
                  for t, s in zip(tree_lib.leaves(step_lib.state_tree(
                      state)), tree_lib.leaves(specs,
                                               is_leaf=sharding.is_spec))]
        assert jobs.digest(shards) == r["digest"], rank
    restore_s = time.perf_counter() - t1
    del state, host
    shutil.rmtree(ckpt)
    log(phase, f"{card}: {TRAIN['arch']} at full width (phase 9a's "
        f"depth), FSDP over 2 gloo "
        f"ranks of cuda:0 (data = 2: every embed_fsdp dimension halved, the "
        f"embedding whole), batch {TRAIN['batch']} x {TRAIN['seq']} in "
        f"{TRAIN['grad_accum']} microbatches, each rank 1 row of each; "
        f"f32 master, bf16 compute, remat full, TF32 off: losses "
        + ", ".join(f"{st['loss']:.6f}" for st in out[0]["steps"])
        + " against phase 9a's "
        + ", ".join(f"{loss:.6f}" for _, loss, _ in ref_steps[:2])
        + ", grad norms "
        + ", ".join(f"{st['grad_norm']:.6f}" for st in out[0]["steps"])
        + " against "
        + ", ".join(f"{g:.6f}" for _, _, g in ref_steps[:2])
        + f" (worst rel loss {worst['loss']:.2e}, grad norm "
        f"{worst['grad_norm']:.2e}; gate 1e-3); the 2 ranks' step-2 "
        f"checkpoint restored at 1 rank equals each rank's shards bit for "
        f"bit ({restore_s:.1f} s); peak memory a rank "
        + ", ".join(f"{r['peak_gib']:.2f}" for r in out)
        + " GiB; step s " + "; ".join(
            ", ".join(f"{st['s']:.1f}" for st in r["steps"]) for r in out)
        + f", the whole spawn {spawn_s:.1f} s ({TRANSPORT_NOTE}); launches "
        f"of the kernels {sum(r['launches'] for r in out)}")


# --------------------------------------------------------------------------
# phase 10d: the serving steps on a rank's shards
# --------------------------------------------------------------------------
# phase 10d's bound: a rank's bf16 step may stray from the same step in f32
# (one rank, the same bf16 weights, caches and tokens) at most twice as far
# as the one-rank bf16 step does, so it lies within 3x the one-rank step's
# own bf16 error of the one-rank step (largest element and norm alike)
TP_TIMES = 3.0
TP_F32_TOL = 1e-4   # in f32 (TF32 off): only the order of the sums differs
SP_SHAPE = (8, 14, 2, 8192, 64)          # a (1, 4) rank's decode (S 32768)
SP_LENS = (0, 8192, 1, 100, 4097, 8191, 5000, 8192)
# llama-3.2-vision-11b's cross rows on a (1, 4) rank (1600 / 4, every
# row valid) and whisper-medium's encoder on a (1, 4) rank (16 / 4 heads)
CROSS_SP_SHAPE = (8, 32, 8, 400, 128)
ENCODER_TP_SHAPE = (2, 4, 1500, 64)


def check_sp_decode(res, shape, lens, what, seed):
    """``flash_decode(..., return_lse=True)`` at a rank's SP-decode shape
    against its plain version (an empty slice where ``lens`` has one), its
    output the same bits as without the flag; timed beside the library's
    attention with its log-sum-exp (the efficient-attention op, the
    lengths as a bias) and the byte bound (kernel and library from
    CUDA-graph replays, cycling 8 caches; plain from CUDA events)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch.kernel_suite import graph_ms
    import itertools
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, H, K, S, hd = shape
    q = torch.randn(B, H, hd, generator=g, device="cuda").to(torch.bfloat16)
    caches = [tuple(torch.randn(B, K, S, hd, generator=g, device="cuda")
                    .to(torch.bfloat16) for _ in range(2)) for _ in range(8)]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    out, lse = da.flash_decode(q, *caches[0], lengths, return_lse=True)
    assert torch.equal(out, da.flash_decode(q, *caches[0], lengths))
    p_out, p_lse = da.flash_decode_plain(q, *caches[0], lengths,
                                         return_lse=True)
    res["max_abs_err"] = close(out, p_out)
    empty = lengths == 0
    assert bool((lse[empty] == da.NEG).all()), lse[empty]
    lse_err = float((lse[~empty] - p_lse[~empty]).abs().max())
    assert lse_err <= 1e-3, lse_err
    cyc = itertools.cycle(caches)
    res["ms"] = graph_ms(lambda: da.flash_decode(
        q, *next(cyc), lengths, return_lse=True), 20)
    res["plain_ms"] = cuda_ms(lambda i: da.flash_decode_plain(
        q, *caches[i % 8], lengths, return_lse=True), iters=4, warm=1)
    # the library's (out, lse): the efficient-attention op with its
    # log-sum-exp, each kv head's G query heads as G query rows, the
    # lengths as a bias; held against plain on the slots with a key
    G, item = H // K, 2
    qg = q.view(B, K, G, hd)
    bias = torch.zeros(B, 1, 1, S, dtype=q.dtype, device="cuda").masked_fill(
        torch.arange(S, device="cuda") >= lengths[:, None, None, None],
        float("-inf")).expand(B, K, G, S)
    lib = lambda k, v: torch.ops.aten._scaled_dot_product_efficient_attention(
        qg, k, v, bias, True)[:2]   # noqa: E731
    l_out, l_lse = lib(*caches[0])
    l_out = l_out.reshape(B, H, hd)[~empty]
    l_lse = l_lse[..., :G].reshape(B, H)[~empty]
    lib_err = (float((l_out.float() - p_out[~empty].float()).abs().max()),
               float((l_lse - p_lse[~empty]).abs().max()))
    assert lib_err[0] <= 2e-2 and lib_err[1] <= 1e-2, lib_err
    res["library_ms"] = graph_ms(lambda: lib(*next(cyc)), 20)
    nbytes = (sum(K * hd * item * (n + (n if n > 0 else S)) for n in lens)
              + 2 * q.numel() * item + 4 * B + 4 * B * H)
    flops = sum(K * G * hd * (4 * n if n > 0 else 2 * S) for n in lens)
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops, BF16_FLOP_PER_S)
    log("tp serve", f"flash_decode with lse at {what} B {B} H {H} K {K} S "
        f"{S} hd {hd} bf16, lengths {tuple(lens)}: "
        f"out within {res['max_abs_err']:.3e} of plain (2e-3 + one bf16 "
        f"step), the same bits as without lse; lse within {lse_err:.3e} of "
        f"plain (gate 1e-3), NEG for an empty slot; kernel "
        f"{res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, library "
        f"(aten._scaled_dot_product_efficient_attention with its lse, "
        f"G query rows a kv head, a length bias; graph) "
        f"{res['library_ms']:.4f} ms, out / lse within {lib_err[0]:.3e} / "
        f"{lib_err[1]:.3e} of plain on the slots with a key, bound "
        f"{res['bound_ms']:.4f} ms ({res['bound_by']}: {nbytes} B at 3.35 "
        "TB/s)")


def check_rank_attention(results):
    """Both attention kernels at phase 10d's rank shapes against their
    plain versions, timed beside the library and their bounds:
    flash_decode with its lse at qwen2-0.5b's SP slice and at
    llama-3.2-vision-11b's cross rows (``CROSS_SP_SHAPE``), and
    flash_attention over whisper-medium's 1500 frames on a rank's heads
    (``ENCODER_TP_SHAPE``, non-causal)."""
    from repro_torch.kernels import flash_attention as fa
    check_sp_decode(results["flash_decode_sp"], SP_SHAPE, SP_LENS,
                    "a (1, 4) rank's SP-decode shape (qwen2-0.5b, S 32768)",
                    10)
    check_sp_decode(results["flash_decode_cross_sp"], CROSS_SP_SHAPE,
                    (CROSS_SP_SHAPE[3],) * CROSS_SP_SHAPE[0],
                    "a (1, 4) rank's cross rows (llama-3.2-vision-11b, "
                    "1600 patches)", 12)
    res = results["flash_attention_encoder_tp"]
    g = torch.Generator(device="cuda").manual_seed(13)
    q, k, v = (torch.randn(ENCODER_TP_SHAPE, generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    plain = fa.flash_attention_plain(q, k, v, causal=False)
    res["max_abs_err"] = close(fa.flash_attention(q, k, v, causal=False),
                               plain)
    lib_err = float((F.scaled_dot_product_attention(q, k, v).float()
                     - plain.float()).abs().max())
    assert lib_err <= 2e-2, lib_err
    log("tp serve", f"flash_attention at a (1, 4) rank's heads of "
        f"whisper-medium's encoder {list(ENCODER_TP_SHAPE)} bf16, "
        f"non-causal: max |kernel - plain| {res['max_abs_err']:.3e} "
        f"(2e-3 + one bf16 step), sdpa within {lib_err:.3e} of plain")
    time_flash(res, q, k, v, False, None)


# phase 10d's archs at full width: ``meshes`` for the bf16 steps, a bf16
# decode at S ``S_dec`` (0: none) over caches drawn N(0, 1), a bf16
# prefill of ``prefill`` = (B, L) tokens (with the encoder input of a
# cross-attention arch), and each arch in f32 on (1, 4) first (a decode at
# S min(1024, S_dec)); ``cut``:
# the depth cuts memory forces (config overrides); ``rules``: rule
# overrides beside the cell's (llama-vision's kv heads kept whole, as on
# the production mesh, whose model axis of 16 its 8 do not cover: so
# ``kv_seq`` cuts its self and cross caches' rows on these small meshes
# too, whose model axis they would cover). The MoE archs run in f32 alone:
# in bf16 a rank's routing may flip against the one-rank step's (granite
# against f32 itself; deepseek's rank 0 once strayed 0.161 of the logits'
# norm, 12x the one-rank step's own bf16 error), so that error bounds
# nothing
TP_SERVE = {
    "qwen2-0.5b": dict(meshes=((1, 4), (2, 2)), S_dec=32768,
                       prefill=(2, 2048)),
    "granite-moe-3b-a800m": dict(meshes=(), S_dec=0, prefill=None),
    "llama-3.2-vision-11b": dict(
        meshes=((1, 4),), S_dec=32768, prefill=(2, 256),
        cut=dict(groups=((("gqa:mlp",) * 4 + ("cross:mlp",), 1),)),
        rules=dict(kv_heads_tp=None)),
    # (2, 2): the FSDP gather over data beside the model axis, of the
    # cross and encoder leaves (whisper) and of a whole-state recurrence
    # beside cut projections (xlstm's 4 heads on a model axis of 2, the
    # layout of the production 16x16 mesh)
    "whisper-medium": dict(meshes=((1, 4), (2, 2)), S_dec=448,
                           prefill=(2, 4)),
    "deepseek-v3-671b": dict(
        meshes=(), S_dec=32768, prefill=None,
        cut=dict(groups=((("mla:mlp",), 1), (("mla:moe",), 1)), mtp=False)),
    # the recurrent mixers (models/ssm.py) on a rank's shards: xlstm's
    # state is constant in S (cut to one unit, 7 mLSTM + 1 sLSTM: its
    # 0.94 GB of state a unit is drawn whole on each of four ranks);
    # zamba2's shared sites keep K/V of S_dec rows (8192, not the cell's
    # 32768: each rank draws the whole caches before it cuts its part)
    "xlstm-1.3b": dict(meshes=((1, 4), (2, 2)), S_dec=1024,
                       prefill=(2, 256),
                       cut=dict(groups=((("mlstm:none",) * 7
                                         + ("slstm:none",), 1),))),
    "zamba2-1.2b": dict(meshes=((1, 4),), S_dec=8192,
                        prefill=(2, 256)),
    # the sliding-window rings cut over their rows (16.11b-4): the kv
    # heads whole (kv_heads_tp None) and shard_kv_seq on (the decode cell's
    # 16 kv heads would cover the production model axis instead), so
    # kv_seq cuts every cache's rows on the model axis; one local + one
    # global layer, in f32 alone, its
    # decode at S 2048 past the local layer's 1024-row ring (positions
    # 2047 and 100: ring rows 1023 and 100) and a prefill of 2 x 1024 (L
    # = W: every ring row written once, on the rank that holds it), held
    # at 1e-5 of the one-rank step
    "gemma3-27b": dict(
        meshes=(), S_dec=0, prefill=None, S_f32=2048, f32_prefill=(2, 1024),
        f32_tol=1e-5, rules=dict(kv_heads_tp=None),
        cut=dict(groups=((("local:mlp", "global:mlp"), 1),),
                 shard_kv_seq=True)),
}


def tp_serve_jobs():
    """Phase 10d's cases (``TP_SERVE``): {mesh: [(name, ServeJob, the
    ShapeSpec and build_cell's config and rule levers of the same cell on
    an abstract mesh)]}."""
    from repro_torch import configs
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import specs
    from repro_torch.parallel import mesh_jobs as jobs
    rng = np.random.default_rng(0)
    out = {}
    f32 = dict(param_dtype=torch.float32, compute_dtype=torch.float32)
    for arch, spec in TP_SERVE.items():
        cfg = specs.cell_config(arch, configs.SHAPES["decode_32k"])
        over = dict({"shard_kv_seq": cfg.shard_kv_seq}, **spec.get("cut", {}))
        if cfg.moe is not None:    # no capacity drops, meshless or not
            over["moe"] = dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)
        cfg = dataclasses.replace(cfg, **over)
        extra_rules = spec.get("rules", {})
        rules = dict(specs.rule_overrides(cfg), **extra_rules)
        tok = rng.integers(0, cfg.vocab, (8, 1)).astype(np.int32)
        S_dec = spec["S_dec"] or spec.get("S_f32", 1024)
        S32 = spec.get("S_f32", min(1024, S_dec))
        pos = np.array([S_dec - 1] * 7 + [100])
        prefill = spec["prefill"]
        if prefill:
            Bp, L = prefill
            prompt = np.tile(np.array(WHISPER_SOT, np.int32), (Bp, 1)) \
                if arch == "whisper-medium" else \
                rng.integers(0, cfg.vocab, (Bp, L)).astype(np.int32)
            extra = None
            if cfg.encoder_seq:
                dim = cfg.cross_kv_dim if cfg.family == "vlm" else \
                    cfg.d_model
                extra = rng.standard_normal(
                    (Bp, cfg.encoder_seq, dim)).astype(np.float32)
        base = dict(cfg=cfg, rules=rules, device="cuda:0")
        # f32 (TF32 off) on (1, 4), first: the exact gates
        items = out.setdefault((1, 4), [])
        exact = dict(base, cfg=dataclasses.replace(cfg, **f32), mesh=(1, 4),
                     compare=False, keep=("logits",))
        items.insert(0, (f"{arch} decode f32", jobs.ServeJob(
            **exact, batch=8, max_seq=S32, decode=[(tok, np.minimum(
                pos, S32 - 1))], fill=True),
            (arch, ShapeSpec("decode_32k", S32, 8, "decode"),
             dict(over, **f32), extra_rules)))
        if spec.get("f32_prefill"):
            Bp, L = spec["f32_prefill"]
            items.insert(1, (f"{arch} prefill f32", jobs.ServeJob(
                **exact, batch=Bp, max_seq=L, prompt=rng.integers(
                    0, cfg.vocab, (Bp, L)).astype(np.int32)),
                (arch, ShapeSpec("prefill_32k", L, Bp, "prefill"),
                 dict(over, **f32), extra_rules)))
        for mesh in spec["meshes"]:
            kw = dict(base, mesh=mesh, compare=True, keep=())
            items = out.setdefault(mesh, [])
            if spec["S_dec"]:
                items.append((f"{arch} decode", jobs.ServeJob(
                    batch=8, max_seq=S_dec, decode=[(tok, pos)], fill=True,
                    **kw), (arch, ShapeSpec("decode_32k", S_dec, 8,
                                            "decode"), over, extra_rules)))
            if prefill:
                items.append((f"{arch} prefill", jobs.ServeJob(
                    batch=Bp, max_seq=L, prompt=prompt, extra=extra, **kw),
                    (arch, ShapeSpec("prefill_32k", L, Bp, "prefill"),
                     over, extra_rules)))
    return out


def bf16_error(job):
    """The one-rank step's own bf16 error: its logits and caches against
    the same step in f32 on the same values → ([(max |diff|, norm of the
    difference over the f32 logits') a step], max |diff| of the caches)."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.parallel import mesh_jobs as jobs
    b, cb = jobs.one_rank(job)
    f, cf = jobs.one_rank(job, torch.float32)
    out = ([(float((x - y).abs().max()), float((x - y).norm() / y.norm()))
            for x, y in zip(b, f)],
           max(float((p.float() - q).abs().max()) for p, q in zip(
               tree_lib.leaves(cb), tree_lib.leaves(cf))))
    del b, cb, f, cf
    free_card("tp serve", f"after the one-rank bf16 / f32 steps of a job")
    return out


PLAIN_MIXERS = ("mla", "mamba", "mlstm", "slstm")   # no kernel: plain jnp


def tp_serve_full(card: str, results):
    """Phase 10d (see the module docstring)."""
    from repro_torch.launch import specs
    from repro_torch.models import transformer
    from repro_torch.parallel import mesh_jobs as jobs
    from repro_torch.parallel import sharding
    phase = "tp serve"
    free_card(phase)
    check_rank_attention(results)
    t0 = time.perf_counter()
    cases = tp_serve_jobs()
    noise, exact = {}, {}
    for items in cases.values():
        for name, job, _ in items:
            if job.cfg.compute_dtype == torch.float32:  # the logits here
                exact[name] = [t.cpu() for t in jobs.one_rank(job)[0]]
                free_card(phase, f"after the one-rank {name} step")
            elif name not in noise:
                noise[name] = bf16_error(job)
                log(phase, f"{name}: the one-rank step's own bf16 error "
                    f"against f32 (largest element, norm) "
                    + ", ".join(f"({a:.4g}, {n:.4g})"
                                for a, n in noise[name][0])
                    + f", caches {noise[name][1]:.4g}")
    noise_s = time.perf_counter() - t0

    def trace_all():      # on meta, on the CPU: beside the spawns
        t = time.perf_counter()
        out = {}
        for mesh, items in cases.items():
            amesh = sharding.Mesh.abstract(mesh, ("data", "model"))
            for name, _, (arch, shape, over, rules) in items:
                cell = specs.build_cell(arch, shape, amesh, cfg_over=over,
                                        rules_over=rules)
                out[mesh, name] = [
                    (c.kind, c.nbytes, c.group)
                    for c in specs.trace_cell(cell).collectives]
        return out, time.perf_counter() - t

    pool = concurrent.futures.ThreadPoolExecutor(1)
    tracing = pool.submit(trace_all)
    walls, runs = {}, {}
    for mesh, items in cases.items():
        t0 = time.perf_counter()
        runs[mesh] = _spawn(jobs.each, mesh[0] * mesh[1], (
            jobs.serve_job, [job for _, job, _ in items]), 900.0)
        walls[mesh] = time.perf_counter() - t0
    traced, trace_s = tracing.result()
    pool.shutdown()
    for mesh, items in cases.items():
        n, out = mesh[0] * mesh[1], runs[mesh]
        for i, (name, job, _) in enumerate(items):
            ranks = sorted((r[i] for r in out),
                           key=lambda r: (r["coords"]["data"],
                                          r["coords"]["model"]))
            kernel = "flash_decode" if job.decode else "flash_attention"
            # MLA and the recurrent mixers are plain: no kernel launches
            # inside them (zamba2's shared attention sites launch)
            plain = all(transformer.parse_kind(kind)[0] in PLAIN_MIXERS
                        for pattern, _ in job.cfg.groups for kind in pattern)
            for r in ranks:
                assert not any(m == "recurrent"
                               for m, _ in r["launches_by_mixer"]), (
                    name, mesh, r["launches_by_mixer"])
                if plain:
                    assert not any(r["launches"].values()), (
                        name, mesh, r["launches"])
                else:
                    assert r["launches"][kernel] > 0, (name, mesh,
                                                       r["launches"])
                colls = [tuple(c) for c in r["collectives"]]
                assert colls == traced[mesh, name], (
                    name, mesh, colls[:4], traced[mesh, name][:4])
            launched = ", ".join(str(r["launches"][kernel]) for r in ranks)
            if job.cfg.compute_dtype == torch.float32:
                tol = TP_SERVE[items[i][2][0]].get("f32_tol", TP_F32_TOL)
                worst, rel, held, rows = 0.0, 0.0, 0, 0
                for r in ranks:
                    lo, hi = r["rows"]
                    for got, want in zip(r["logits"], exact[name]):
                        got, want = torch.from_numpy(got), want[lo:hi]
                        d, amax = got - want, float(want.abs().max())
                        worst = max(worst, float(d.abs().max()) / amax)
                        rel = max(rel, float(d.norm() / want.norm()))
                        # a flip needs a top-2 gap under twice the gate
                        top = want.topk(2, dim=-1).values
                        sure = top[..., 0] - top[..., 1] > 2 * tol * amax
                        assert torch.equal(got.argmax(-1)[sure],
                                           want.argmax(-1)[sure]), name
                        held += int(sure.sum())
                        rows += sure.numel()
                assert worst <= tol and rel <= tol, (name, worst, rel)
                assert held > 0, (name, "no row's top-2 gap passes 2x "
                                  "the gate: the greedy gate holds nothing")
                log(phase, f"{card}: {name} on (data {mesh[0]}, model "
                    f"{mesh[1]}), f32 (TF32 off): every rank's logits within "
                    f"{worst:.3e} of the largest one-rank logit, difference "
                    f"norm {rel:.3e} of the one-rank logits' (gate "
                    f"{tol:g}); greedy tokens equal on the {held} of "
                    f"{rows} rows whose one-rank top-2 gap passes twice the "
                    f"gate (gate); collectives equal to the meta trace's; "
                    f"{kernel} launches a rank {launched}; rank set-ups "
                    + ", ".join(f"{r['setup_s']:.2f}" for r in ranks)
                    + " s")
                continue
            worst, rel, c_worst, same, rows = 0.0, 0.0, 0.0, 0, 0
            steps_err, cache_err = noise[name]
            for r in ranks:
                for (diff, top, norm, got, want, gap), (e_max, e_norm) in \
                        zip(r["logits_vs_one"], steps_err):
                    lim = TP_TIMES * e_max
                    assert np.isfinite(diff) and diff <= lim and \
                        norm <= TP_TIMES * e_norm, (
                            name, mesh, r["coords"], diff, lim, norm,
                            e_norm)
                    worst = max(worst, diff / e_max)
                    rel = max(rel, norm / e_norm)
                    same += int((got == want).sum())
                    rows += got.size
                c_diff, _ = r["caches_vs_one"]
                assert c_diff <= TP_TIMES * cache_err, (name, mesh, c_diff,
                                                        cache_err)
                c_worst = max(c_worst, c_diff / cache_err)
            r0 = ranks[0]
            if mesh == (1, 4):       # the kernels line's rank-shape rows
                for entry, arch_step, key in (
                        ("flash_decode_sp", "qwen2-0.5b decode",
                         ("gqa", "flash_decode")),
                        ("flash_decode_cross_sp",
                         "llama-3.2-vision-11b decode",
                         ("cross", "flash_decode")),
                        ("flash_attention_encoder_tp",
                         "whisper-medium prefill",
                         ("enc", "flash_attention"))):
                    if name == arch_step:
                        results[entry]["launches"] = \
                            r0["launches_by_mixer"][key]
            log(phase, f"{card}: {name} on (data {mesh[0]}, model "
                f"{mesh[1]}), {n} gloo ranks of cuda:0, cache "
                f"{r0['cache_shapes'][0]} a rank: against the one-rank "
                f"step, the largest logit difference {worst:.3f}x and the "
                f"difference norm {rel:.3f}x the one-rank step's own bf16 "
                f"error, the caches {c_worst:.3f}x (gates {TP_TIMES:g}x); "
                f"greedy tokens equal on {same} of {rows} rows (reported, "
                f"not gated: random weights' top-2 gaps lie inside the "
                f"bf16 bound; the f32 cases gate them); "
                f"{len(r0['collectives'])} collectives a "
                f"rank, kinds and bytes equal to the meta trace's on the "
                f"abstract mesh; attention launches a rank by layer kind "
                + "; ".join(str(r["launches_by_mixer"]) for r in ranks)
                + "; rank walls " + ", ".join(f"{r['wall_s']:.2f}"
                                              for r in ranks)
                + " s, set-ups " + ", ".join(f"{r['setup_s']:.2f}"
                                             for r in ranks)
                + f" s ({TRANSPORT_NOTE})")
    log(phase, f"one-rank bf16 / f32 steps {noise_s:.1f} s; meta traces "
        f"{trace_s:.1f} s (beside the spawns); spawns " + ", ".join(
        f"{m}: {w:.1f} s" for m, w in walls.items()))


# --------------------------------------------------------------------------
# phase 10e: training with a model axis
# --------------------------------------------------------------------------
TP_TRAIN_MESH = (2, 2)                    # qwen2-0.5b at phase 9a's depth
# the f32 cases on (1, 4), each one step against the same step on one
# rank in this process, at full width with depth cut: granite's experts
# whole (slot-parallel); whisper whole (its encoder, cross and GELU
# layers); zamba2 one unit (5 Mamba2 + the shared block's site); xlstm one
# unit (7 mLSTM + 1 sLSTM); deepseek one dense MLA layer, its MTP head
# (a 256-expert MLA + MoE layer, ~11 B parameters) undrawn. ``params``:
# the cut model's parameter count (the fit check's)
TP_TRAIN_F32 = {
    "granite-moe-3b-a800m": dict(batch=2, seq=1024, params=None,
                                 overrides=dict(groups=((("gqa:moe",), 2),))),
    "whisper-medium": dict(batch=2, seq=448, params=813500416,
                           overrides={}),
    "zamba2-1.2b": dict(batch=2, seq=512, params=260562368, overrides=dict(
        groups=((("mamba:none",) * 5 + ("shared:mlp",), 1),))),
    "xlstm-1.3b": dict(batch=2, seq=512, params=669642752, overrides=dict(
        groups=((("mlstm:none",) * 7 + ("slstm:none",), 1),))),
    "deepseek-v3-671b": dict(batch=2, seq=512, params=2436848640,
                             overrides=dict(groups=((("mla:mlp",), 1),),
                                            mtp=False)),
}
TP_TRAIN_F32_MESH = (1, 4)
# the leaves whose gradient is zero in exact arithmetic (whisper's key
# biases: the softmax ignores a shift of all of a query's logits), so
# that their Adam step is rounding alone: left out of the shard gate
TP_TRAIN_NULL = ("mixer/bk",)
# Mamba2's per-head scalars: each gradient one sum over every token's
# term, which cancel (zamba2's A_log m: Σx 3.0e-06 of Σ|x| 2.5e-05 on a
# rank's 16 heads), so the order of the sums shows in Σx at 1.2e-04 of
# Σ|x| on the card; their shards are gated at this instead (a sum over a
# wrong line is a factor of 2 or more)
TP_TRAIN_HEAD_SCALARS = ("mixer/A_log", "mixer/dt_bias", "mixer/D")
TP_TRAIN_HEAD_TOL = 1e-3
# xlstm-1.3b's shards: its unit's 7 mLSTM layers amplify the f32 rounding
# of their exponential gates (on the card the Σv of the mLSTM
# projections and the embedding 2.9e-04 to 5.2e-04 off the one-rank
# step's; on the CPU its smoke stack of 8 parts from one rank by 1e-3 of
# a leaf's largest v, one mLSTM + one sLSTM by 3e-6), as its serving and
# training tests hold it at 1e-4 rather than 1e-5
TP_TRAIN_SHARD_TOL = {"xlstm-1.3b": 1e-3}
TP_TRAIN_F32_TOL = 1e-4   # in f32 (TF32 off): only the order of the sums
# qwen2's gradient norm of each leaf, step 1, against phase 9a's: both
# bf16 compute, summed in other orders; a sum over a wrong line of the
# model axis of 2 is a factor of 2 or 1/2 on its leaves
TP_TRAIN_LEAF_TOL = 5e-2
# the fit check: a one-rank f32 step (weight, grad, m, v and the new m
# and v, 24 B a parameter) and this share of it again for the step's
# activations and the optimizer's one leaf at a time must fit in what is
# free
TP_TRAIN_FIT_SLACK = 0.25


def state_leaf_specs(cfg, mesh, rules):
    """The names of the weights, the abstract (data, model) ``mesh`` and
    the spec of each leaf of train/step.py ``state_tree`` on it under
    ``rules`` (weights, m, v, the step)."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.models import transformer
    from repro_torch.parallel import sharding
    from repro_torch.train import step as step_lib
    amesh = sharding.Mesh.abstract(mesh, ("data", "model"))
    model = transformer.init_model(cfg, None, "meta")
    with sharding.use_mesh(amesh, rules):
        p_specs = step_lib.param_specs(model, amesh)
    names = [p for p, _ in tree_lib.paths(transformer.param_tree(model))]
    return names, amesh, tree_lib.leaves(step_lib.state_specs(p_specs),
                                         is_leaf=sharding.is_spec)


def f32_case(phase: str, arch: str):
    """One of ``TP_TRAIN_F32``'s cases: (its config, rules, batch, the
    one-rank step's metrics, the weights' names, the abstract mesh, each
    rank's fingerprints of its slices of the one-rank state after the
    step, the step's seconds, its peak GiB). The one-rank state is drawn
    from seed 0 in this process after a fit check (the cut model's
    parameter count, and 24 B a parameter and ``TP_TRAIN_FIT_SLACK`` of
    it again free), stepped and freed."""
    from repro_torch import configs
    from repro_torch.core import tree as tree_lib
    from repro_torch.data import pipeline as dp
    from repro_torch.launch import specs
    from repro_torch.launch import train as train_lib
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.parallel import mesh_jobs as jobs
    from repro_torch.parallel import sharding
    from repro_torch.train import step as step_lib
    c = TP_TRAIN_F32[arch]
    cfg = configs.get_config(arch, **c["overrides"],
                             param_dtype=torch.float32,
                             compute_dtype=torch.float32)
    rules = specs.rule_overrides(specs.cell_config(
        arch, configs.SHAPES["train_4k"]))
    batch = dp.make_batch(dp.DataConfig(
        vocab=cfg.vocab, seq_len=c["seq"], global_batch=c["batch"], seed=0,
        mtp=False), 0)
    if transformer.has_cross(cfg):        # whisper's frames
        batch["extra"] = np.random.default_rng(0).standard_normal(
            (c["batch"], cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    n_par = transformer.count_params(transformer.init_model(cfg, None,
                                                            "meta"))
    assert c["params"] in (None, n_par), (arch, n_par, c["params"])
    free_card(phase, f"before {arch}'s one-rank step")
    need = 24 * n_par * (1 + TP_TRAIN_FIT_SLACK)
    assert torch.cuda.mem_get_info()[0] >= need, (arch, need)
    torch.cuda.reset_peak_memory_stats()
    state = train_lib.build_state(cfg, 0, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, one = step_lib.make_train_step(cfg, adamw.Config())(
        state, dp.to_device(batch, "cuda"))
    one = {k: float(v) for k, v in one.items()}
    step_s = time.perf_counter() - t0
    names, amesh, leaf_specs = state_leaf_specs(cfg, TP_TRAIN_F32_MESH,
                                                rules)
    whole = tree_lib.leaves(step_lib.state_tree(state))
    sums = [[jobs.fingerprint(t[sharding.shard_slices(
        t.shape, spec, amesh, rank)]) for t, spec in zip(whole, leaf_specs)]
        for rank in range(amesh.size)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    del state, whole
    job = jobs.FsdpJob(cfg=cfg, weights=None, seed=0, device="cuda:0",
                       batches=[batch], mesh=TP_TRAIN_F32_MESH,
                       wholes=False, rules=rules, sums=True)
    return dict(cfg=cfg, one=one, names=names, amesh=amesh, sums=sums,
                step_s=step_s, peak=peak, n_par=n_par, job=job)


def hold_f32(case, ranks):
    """Phase 10e's gates on an f32 case (``case``: :func:`f32_case`'s;
    ``ranks``: each rank's ``fsdp_job`` result): 0 launches, the loss,
    nll (the MoE's aux) and grad norm within ``TP_TRAIN_F32_TOL``
    relative of the one-rank step's, and each rank's weight, m and v
    shards after the step against its slices of the one-rank state: Σx
    and Σ|x| within the gate of Σ|x|, Σx² within twice it of Σx² (m =
    (1 - b1)·scale·g: a gradient summed over a wrong line scales its
    leaf's), ``TP_TRAIN_HEAD_SCALARS`` within ``TP_TRAIN_HEAD_TOL`` and an
    arch of ``TP_TRAIN_SHARD_TOL`` within its own, but the
    ``TP_TRAIN_NULL`` leaves'. Returns (worst metric, worst of weights /
    m / v)."""
    one, names, amesh = case["one"], case["names"], case["amesh"]
    n = len(names)
    worst, shard_worst, bad = 0.0, [0.0, 0.0, 0.0], []
    for r in ranks:
        assert r["launches"] == 0, r["launches"]
        got = r["metrics"][0]
        for k in ("loss", "nll", "moe_aux", "grad_norm"):
            if one.get(k):                # no MoE: moe_aux 0 on both
                worst = max(worst, abs(got[k] - one[k]) / abs(one[k]))
            elif k in one:
                assert got[k] == one[k], (k, got[k], one[k])
        rank = amesh.rank_at(r["coords"])
        sums = r["sums"][1]
        assert len(sums) == len(case["sums"][rank]) == 3 * n + 1
        for i, ((s, a, q), (s1, a1, q1)) in enumerate(zip(
                sums, case["sums"][rank])):
            name = names[i % n] if i < 3 * n else "step"
            if name.endswith(TP_TRAIN_NULL):
                continue
            err = max(abs(s - s1) / max(a1, 1e-30),
                      abs(a - a1) / max(a1, 1e-30),
                      abs(q - q1) / max(2 * q1, 1e-30))
            tol = TP_TRAIN_HEAD_TOL if name.endswith(
                TP_TRAIN_HEAD_SCALARS) else TP_TRAIN_SHARD_TOL.get(
                    case["cfg"].name, TP_TRAIN_F32_TOL)
            if err > tol:
                bad.append((rank, "wmv"[min(i // n, 2)], name, err,
                            (s, a, q), (s1, a1, q1)))
            part = min(i // n, 2)
            shard_worst[part] = max(shard_worst[part], err)
    assert not bad, (case["cfg"].name, len(bad), sorted(
        bad, key=lambda b: -b[3])[:12])
    assert worst <= TP_TRAIN_F32_TOL, (case["cfg"].name, worst,
                                       ranks[0]["metrics"], one)
    return worst, shard_worst


def tp_train_full(card: str, ref_steps, ref_m_sq):
    """Phase 10e (see the module docstring); ``ref_steps``: phase 9a's
    (step, loss, grad norm); ``ref_m_sq``: its Σm² of each weight after
    step 1."""
    from repro_torch import configs
    from repro_torch.data import pipeline as dp
    from repro_torch.launch import specs
    from repro_torch.optim import adamw
    from repro_torch.parallel import mesh_jobs as jobs
    from repro_torch.parallel import sharding
    phase = "tp train"
    arch = TRAIN["arch"]
    cfg = configs.get_config(arch, **TRAIN["overrides"])
    rules = specs.rule_overrides(specs.cell_config(arch,
                                                   configs.SHAPES["train_4k"]))
    dcfg = dp.DataConfig(vocab=cfg.vocab, seq_len=TRAIN["seq"],
                         global_batch=TRAIN["batch"], seed=0, mtp=False)
    # launch/train.py's optimizer for phase 9a's run
    opt = adamw.Config(lr=TRAIN["lr"], total_steps=TRAIN["steps"])
    dense = jobs.FsdpJob(cfg=cfg, weights=None, seed=0, device="cuda:0",
                         batches=[dp.make_batch(dcfg, s) for s in range(2)],
                         grad_accum=TRAIN["grad_accum"], mesh=TP_TRAIN_MESH,
                         rules=rules, opt=opt, wholes=False, sums=True)
    t0 = time.perf_counter()
    cases = {a: f32_case(phase, a) for a in TP_TRAIN_F32}
    one_s = time.perf_counter() - t0
    free_card(phase, "after the one-rank steps")
    t0 = time.perf_counter()
    # the small MoE job first: its step takes the ranks' one-time costs
    # (the autograd device thread's first GEMMs, gloo's first CUDA tensors)
    order = ["granite-moe-3b-a800m", "dense"] + list(TP_TRAIN_F32)[1:]
    # the four ranks share the card, each with its own caching allocator:
    # with expandable segments a rank holds little beyond what it uses, so
    # the blocks one rank keeps cannot leave another short (deepseek's
    # ranks peak near a quarter of the card each); the ranks read the
    # setting when they start, this process keeps its own
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        out = _spawn(jobs.run_jobs, 4, ([(jobs.fsdp_job, dense if a == "dense"
                                          else cases[a]["job"])
                                         for a in order],), 900.0)
    finally:
        if conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
    spawn_s = time.perf_counter() - t0
    got = {a: [r[i] for r in out] for i, a in enumerate(order)}
    worst = {"loss": 0.0, "grad_norm": 0.0}
    for d in got["dense"]:
        assert d["launches"] == 0, d["launches"]
        assert len(d["metrics"]) == 2
        for st, (_, loss, gnorm) in zip(d["metrics"], ref_steps):
            for k, ref in (("loss", loss), ("grad_norm", gnorm)):
                worst[k] = max(worst[k], abs(st[k] - ref) / abs(ref))
    assert max(worst.values()) <= 1e-3, (worst, got["dense"][0]["metrics"],
                                          ref_steps)
    held, failed = {}, {}
    for a in TP_TRAIN_F32:        # every case's gates read before a failure
        try:
            held[a] = hold_f32(cases[a], got[a])
        except AssertionError as e:
            failed[a] = e
    # qwen2: each weight's gradient norm at step 1 from the ranks' Σm²
    # (a shard cut over a line summed over it, a replica counted once)
    # against phase 9a's, g = sqrt(Σm²) / ((1 - b1)·min(1, clip / norm))
    names, amesh, leaf_specs = state_leaf_specs(cfg, TP_TRAIN_MESH, rules)
    n = len(names)
    assert len(ref_m_sq) == n
    m_sq = [0.0] * n
    for r in got["dense"]:
        for i, spec in enumerate(leaf_specs[n:2 * n]):
            axes = sharding.spec_axes(spec)
            reps = math.prod(k for a, k in amesh.shape.items()
                             if a not in axes)
            m_sq[i] += r["sums"][1][n + i][2] / reps

    def norms(sq, gnorm):
        scale = 1.0 if opt.clip_norm is None else min(
            1.0, opt.clip_norm / max(gnorm, 1e-9))
        return [math.sqrt(x) / ((1 - opt.b1) * scale) for x in sq]
    mine = norms(m_sq, got["dense"][0]["metrics"][0]["grad_norm"])
    ref = norms(ref_m_sq, ref_steps[0][2])
    leaf_rel = [abs(a - b) / max(b, 1e-30) for a, b in zip(mine, ref)]
    w = max(range(n), key=leaf_rel.__getitem__)
    assert leaf_rel[w] <= TP_TRAIN_LEAF_TOL, (names[w], mine[w], ref[w])
    r0 = got["dense"]
    log(phase, f"{card}: {arch} at full width and phase 9a's depth "
        f"({cfg.n_layers()} layers) on (data {TP_TRAIN_MESH[0]}, model "
        f"{TP_TRAIN_MESH[1]}), 4 gloo ranks of cuda:0 under the train_4k "
        f"rules (heads, kv heads, the MLP's hidden and the vocabulary over "
        f"model; the loss over the vocabulary line), batch "
        f"{TRAIN['batch']} x {TRAIN['seq']} in {TRAIN['grad_accum']} "
        f"microbatches, each rank 1 row of each; f32 master, bf16 "
        f"compute, remat full, TF32 off: losses "
        + ", ".join(f"{st['loss']:.6f}" for st in r0[0]["metrics"])
        + " against phase 9a's "
        + ", ".join(f"{loss:.6f}" for _, loss, _ in ref_steps[:2])
        + ", grad norms "
        + ", ".join(f"{st['grad_norm']:.6f}" for st in r0[0]["metrics"])
        + " against "
        + ", ".join(f"{g:.6f}" for _, _, g in ref_steps[:2])
        + f" (worst rel loss {worst['loss']:.2e}, grad norm "
        f"{worst['grad_norm']:.2e}; gate 1e-3); peak memory a rank "
        + ", ".join(f"{r['peak_gib']:.2f}" for r in r0)
        + " GiB; step s " + "; ".join(
            ", ".join(f"{t:.1f}" for t in r["step_s"]) for r in r0)
        + ", set-ups " + ", ".join(f"{r['setup_s']:.1f}" for r in r0)
        + f" s ({TRANSPORT_NOTE}); launches of the kernels "
        f"{sum(r['launches'] for r in r0)}; step 1's gradient norm "
        f"of each of the {n} weights (from the ranks' first moment) "
        f"within {leaf_rel[w]:.2e} of phase 9a's (worst {names[w]}: "
        f"{mine[w]:.6g} against {ref[w]:.6g}; gate "
        f"{TP_TRAIN_LEAF_TOL:g}), median "
        f"{sorted(leaf_rel)[n // 2]:.2e}")
    for a, (mworst, shard_worst) in held.items():
        c, case, rs = TP_TRAIN_F32[a], cases[a], got[a]
        log(phase, f"{card}: {a} in f32 cut to {case['cfg'].n_layers()} "
            f"layers ({case['n_par']} parameters; groups "
            f"{[(list(p), k) for p, k in case['cfg'].groups]}"
            + (", MTP head undrawn" if a == "deepseek-v3-671b" else "")
            + f") on (data {TP_TRAIN_F32_MESH[0]}, model "
            f"{TP_TRAIN_F32_MESH[1]}) under the train_4k rules"
            + (" (experts whole, slot-parallel)" if c["params"] is None
               else "")
            + f", one step of {c['batch']} x {c['seq']}: loss "
            f"{rs[0]['metrics'][0]['loss']:.7f}, grad norm "
            f"{rs[0]['metrics'][0]['grad_norm']:.7f} against the one-rank "
            f"step's {case['one']['loss']:.7f}, "
            f"{case['one']['grad_norm']:.7f} (worst rel of the loss terms "
            f"and grad norm over the ranks {mworst:.2e}; gate "
            f"{TP_TRAIN_F32_TOL:g}); every rank's weight, m and v shards "
            f"after the step against its slices of the one-rank state: "
            f"(Σx, Σ|x|, Σx²) within "
            + ", ".join(f"{e:.2e}" for e in shard_worst)
            + f" (gate {TP_TRAIN_SHARD_TOL.get(a, TP_TRAIN_F32_TOL):g}"
            + (f"; Mamba2's A_log / dt_bias / D {TP_TRAIN_HEAD_TOL:g}"
               if a == "zamba2-1.2b" else "") + "); launches "
            f"{sum(r['launches'] for r in rs)}; one-rank step "
            f"{case['step_s']:.1f} s, peak {case['peak']:.2f} GiB; rank "
            "steps s " + ", ".join(f"{r['step_s'][0]:.1f}" for r in rs)
            + ", set-ups " + ", ".join(f"{r['setup_s']:.1f}" for r in rs)
            + " s, peaks " + ", ".join(f"{r['peak_gib']:.2f}" for r in rs)
            + " GiB allocated, " + ", ".join(f"{r['reserved_gib']:.2f}"
                                             for r in rs)
            + " GiB reserved (expandable segments)")
    log(phase, f"one-rank steps with their fingerprints {one_s:.1f} s; "
        f"the spawn {spawn_s:.1f} s")
    for a, e in failed.items():
        log(phase, f"{card}: {a} FAILED its gates: metrics "
            f"{got[a][0]['metrics'][0]} against the one-rank step's "
            f"{cases[a]['one']}; rank steps s "
            + ", ".join(f"{r['step_s'][0]:.1f}" for r in got[a])
            + f"; {e}")
    assert not failed, sorted(failed)


# --------------------------------------------------------------------------
# phase 11: the in-kernel DMA and the dry run's one-card check
# --------------------------------------------------------------------------
# (name, dtype, rows, elems, src stride, dst stride, src off, dst off); the
# first is the main path's call: a 4096 x 4096 f32 tile out of a 4096 x 8192
# matrix into a packed buffer
MEMCPY2D_CASES = (
    ("tile gather", torch.float32, 4096, 4096, 8192, 4096, 2048, 0),
    ("unaligned bf16", torch.bfloat16, 300, 1001, 1003, 1005, 3, 5),
    ("unaligned int8", torch.int8, 300, 1001, 1013, 1001, 7, 1),
    ("unaligned f32", torch.float32, 257, 1001, 1001, 1003, 1, 0),
    ("f64 rows", torch.float64, 64, 999, 1000, 1001, 1, 3),
    ("overlap bf16 (ds < elems)", torch.bfloat16, 64, 1001, 1003, 700, 1, 2),
    ("overlap int8 (ds < elems)", torch.int8, 64, 1001, 1001, 13, 0, 3),
    ("overlap f32 (ds 0)", torch.float32, 9, 1001, 1100, 0, 4, 1),
    ("overlap bf16 (ds 0)", torch.bfloat16, 5, 40000, 40001, 0, 0, 0),
)


def memcpy2d_check(results):
    """Phase 11a: ``core/dma.hero_memcpy2d`` on the card against its plain
    version (the reference's sequential row loop in PyTorch) on the same
    CUDA tensors, bit for bit, in every case of ``MEMCPY2D_CASES``; the
    tile gather timed: kernel and yardstick (one ``copy_`` between strided
    views) as 20 calls replayed from a CUDA graph, the plain loop with CUDA
    events."""
    from repro_torch.core import dma
    from repro_torch.launch.kernel_suite import graph_ms
    phase = "dma"
    res = results["hero_memcpy2d"]
    g = torch.Generator(device="cuda").manual_seed(11)

    def inputs(dtype, rows, elems, ss, ds, so, do):
        n_src = so + (rows - 1) * ss + elems
        n_dst = do + (rows - 1) * ds + elems
        if dtype.is_floating_point:
            src = torch.randn(n_src, generator=g, device="cuda").to(dtype)
        else:
            src = torch.randint(-128, 128, (n_src,), generator=g,
                                device="cuda").to(dtype)
        return src, torch.zeros(n_dst, dtype=dtype, device="cuda")

    for k, (what, dtype, *geom) in enumerate(MEMCPY2D_CASES):
        src, dst = inputs(dtype, *geom)
        plain = dma.hero_memcpy2d_plain(dst.clone(), src, *geom)
        if k == 0:    # the main path's call: its launch alone is counted
            dma.hero_memcpy2d.launches = 0
        out = dma.hero_memcpy2d(dst, src, *geom)
        torch.cuda.synchronize()
        if k == 0:
            res["launches"] = dma.hero_memcpy2d.launches
        bad = int((out.view(torch.uint8) != plain.view(torch.uint8)).sum())
        log(phase, f"hero_memcpy2d {what}: {dtype} rows {geom[0]} elems "
            f"{geom[1]} strides {geom[2]}/{geom[3]} offsets {geom[4]}/"
            f"{geom[5]}: {'bit for bit' if not bad else f'{bad} bytes differ'}")
        assert not bad, f"hero_memcpy2d {what}: {bad} bytes differ from plain"
    res["max_abs_err"] = 0.0
    # the tile gather, timed
    _, dtype, *geom = MEMCPY2D_CASES[0]
    rows, elems, ss, ds, so, do = geom
    src, dst = inputs(dtype, *geom)
    res["ms"] = graph_ms(lambda: dma.hero_memcpy2d(dst, src, *geom), 20)
    res["plain_ms"] = cuda_ms(
        lambda i: dma.hero_memcpy2d_plain(dst, src, *geom), iters=2, warm=1)
    view_src = src.as_strided((rows, elems), (ss, 1), so)
    view_dst = dst.as_strided((rows, elems), (ds, 1), do)
    res["library_ms"] = graph_ms(lambda: view_dst.copy_(view_src), 20)
    nbytes = 2 * rows * elems * src.element_size()
    res["bound_ms"], res["bound_by"] = bound(nbytes, 0)
    log(phase, f"hero_memcpy2d tile gather {rows}x{elems} f32 of a {rows}x"
        f"{ss} matrix: kernel {res['ms']:.4f} ms, plain (row loop) "
        f"{res['plain_ms']:.4f} ms, copy_ of strided views yardstick "
        f"{res['library_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}: {nbytes} B at 3.35 TB/s); "
        f"{res['launches']} launch on the main path")


# the dry run's cells that phase 11b runs on the card at full width (bf16,
# seed 0) on a mesh of one rank
DRYRUN_CELLS = (("qwen2-0.5b", "decode_32k"), ("xlstm-1.3b", "long_500k"))
# phase 11b's gate on temp: the card's caching allocator counts each block
# rounded up to 512 B, and hands a request a cached block whole when less
# than 1 MiB would be left of it, so its peak may pass the storages' exact
# bytes that the trace counts by up to 1 MiB a live block; the few blocks
# alive at a step's peak are held to 2 MiB, and 1 % of temp besides
TEMP_TOL_BYTES = 2 * 2**20
TEMP_TOL_REL = 0.01


def alive_at_peak(snapshot):
    """The bytes alive at the peak of a ``torch.cuda.memory._snapshot()``'s
    recorded trace (allocations made while it was recorded) and at its
    end, each summed by the innermost frame of this repository's code that
    made them → (at the peak, at the end)."""
    def where(frames):
        for f in frames:
            if "repro_torch" in f.get("filename", ""):
                return (f"{f['filename'].split('repro_torch/')[-1]}:"
                        f"{f['line']} {f['name']}")
        return "outside repro_torch"

    live, cur, best, at = {}, 0, 0, {}
    for ev in snapshot["device_traces"][0]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = (ev["size"], where(ev.get("frames", ())))
            cur += ev["size"]
            if cur > best:
                best, at = cur, dict(live)
        elif ev["action"] == "free_requested" and ev["addr"] in live:
            cur -= live.pop(ev["addr"])[0]
    def by_frame(alive):
        out = collections.Counter()
        for size, w in alive.values():
            out[w] += size
        return out
    return by_frame(at), by_frame(live)


def dryrun_check(card: str):
    """Phase 11b: the one-card check of the dry run (launch/dryrun.py
    ``run_cell`` on the 1x1 mesh). For each cell of ``DRYRUN_CELLS``: the
    ``meta`` trace on the host; the real arguments built on the card by the
    same ``specs.build_cell``, whose bytes must equal the record's argument
    bytes; one step under ``core/perf.TraceCount`` on the card, whose FLOPs
    (ATen ops plus the kernels' own counts) must equal the trace's; then
    the step (cache_pos S - 1: the whole cache read) timed, 3 warm and 10
    timed calls between CUDA events, beside the roofline's bound; then one
    more warm step alone, whose peak over the arguments less its new
    outputs is the card's temp, gated against the record's temp (traced on
    meta: the storages the pass creates and the kernels' scratch at their
    launch) within ``TEMP_TOL_BYTES`` + ``TEMP_TOL_REL``; beside it, what
    the card's peak counts that is no step's scratch: the allocator's
    rounding at that peak, the cuBLAS workspaces the process holds, the
    first call's one-time allocations, and what the first call outside
    ``TraceCount`` makes and leaves behind (its memory history)."""
    from repro_torch import configs
    from repro_torch.core import perf
    from repro_torch.launch import dryrun, specs
    phase = "dryrun 1x1"
    for arch, shape_name in DRYRUN_CELLS:
        shape = configs.SHAPES[shape_name]
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, "1x1", verbose=False)
        t_meta = time.perf_counter() - t0
        free_card(phase)
        ws = torch.cuda.memory_allocated()
        torch._C._cuda_clearCublasWorkspaces()
        ws -= torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        req = torch.cuda.memory_stats()["requested_bytes.all.current"]
        cell = specs.build_cell(arch, shape, dryrun.mesh_of("1x1"),
                                device="cuda", seed=0)
        arg = specs.nbytes(cell.args)
        want = rec["memory"]["argument_size_in_bytes"]
        assert arg == want, f"{arch}: card arguments {arg} B, dry run {want}"
        base = torch.cuda.memory_allocated()
        held = base - before - arg       # the arguments' blocks beyond them
        held_rounding = base - before - (
            torch.cuda.memory_stats()["requested_bytes.all.current"] - req)
        with perf.TraceCount() as count:
            logits, _ = cell.fn(*cell.args)
        torch.cuda.synchronize()
        first = torch.cuda.max_memory_allocated() - base
        traced = rec["traced"]["flops"]
        assert count.flops == traced, \
            f"{arch}: card FLOPs {count.flops}, meta trace {traced}"
        assert torch.isfinite(logits.float()).all(), f"{arch}: logits"
        del logits
        mem = rec["memory"]
        new = mem["output_size_in_bytes"] - mem["alias_size_in_bytes"]
        # the first call outside TraceCount, recorded: what is alive at its
        # peak and what stays after it, by where it was made
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.memory._record_memory_history(max_entries=200000,
                                                 stacks="python")
        cell.fn(*cell.args)
        torch.cuda.synchronize()
        stays = torch.cuda.memory_allocated() - base
        at_peak, after = alive_at_peak(torch.cuda.memory._snapshot())
        torch.cuda.memory._record_memory_history(enabled=None)
        ms = cuda_ms(lambda i: cell.fn(*cell.args), iters=10, warm=3)
        peak = torch.cuda.max_memory_allocated() - before
        # one warm step alone: its peak over the arguments, less its logits
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        req = torch.cuda.memory_stats()["requested_bytes.all.current"]
        torch.cuda.reset_peak_memory_stats()
        logits, _ = cell.fn(*cell.args)
        torch.cuda.synchronize()
        st = torch.cuda.memory_stats()
        card_temp = st["allocated_bytes.all.peak"] - base - new
        rounding = (st["allocated_bytes.all.peak"] - base) - \
            (st["requested_bytes.all.peak"] - req)
        temp = mem["temp_size_in_bytes"]
        tol = TEMP_TOL_BYTES + TEMP_TOL_REL * temp
        assert abs(card_temp - temp) <= tol, (
            f"{arch}: temp {card_temp} B on the card, {temp} B traced, "
            f"tolerance {tol:.0f} B")
        rl = rec["roofline"]
        log(phase, f"{arch} x {shape_name} ({card}): arguments {arg} B on "
            f"the card = the dry run's; step FLOPs on the card "
            f"{count.flops:.0f} (ATen {count.aten_flops}, kernels "
            f"{count.kernel_flops}) = the meta trace's (analytic "
            f"{rec['analytic']['flops']:.0f}); step {ms:.4f} ms (cache_pos "
            f"{shape.seq_len - 1}, 10 timed after 3 warm) against the "
            f"roofline bound {rl['bound_s'] * 1e3:.4f} ms ({rl['dominant']}: "
            f"{rec['analytic']['hbm_bytes']:.0f} B at 3.35 TB/s, "
            f"{rec['analytic']['flops']:.0f} flop at 989 TFLOP/s); temp "
            f"{card_temp} B on the card (one warm step's peak over the "
            f"arguments less its {new} B of logits) against {temp} B "
            f"traced on meta (of which the kernels' scratch at their "
            f"launch: peak {rec['traced']['scratch_peak_bytes']} B alive "
            f"with it), within {abs(card_temp - temp)} B (gate "
            f"{tol:.0f} B); not the step's scratch: the allocator's "
            f"rounding at that peak {rounding} B, the cuBLAS workspaces the "
            f"process held before the cell {ws} B (made again by its first "
            f"GEMM), the first call's peak over the arguments {first} B, "
            f"{first - card_temp - new} B above a warm step's (its one-time "
            f"allocations); the next call (the first outside TraceCount) "
            f"peaks with {sum(at_peak.values())} B alive that it made, by "
            f"where made: "
            + ", ".join(f"{n} B {w}" for w, n in at_peak.most_common(4))
            + f", and leaves {stays} B allocated ("
            + ", ".join(f"{n} B {w}" for w, n in after.most_common(3))
            + f"); the arguments' blocks hold {held} B beyond their bytes "
            f"({held_rounding} B of it the allocator's rounding); peak "
            f"device memory over the build and all 14 calls "
            f"{peak / 1e9:.3f} GB against the dry run's "
            f"{mem['total_per_device'] / 1e9:.3f} GB (arguments + outputs "
            f"- alias + temp); meta trace {t_meta:.1f} s on the host")
        del cell, logits
    free_card(phase, "after phase 11b")


# the kernel templates' mangled names, as ptxas prints them, shortened
PAGE_TYPES = {"13__nv_bfloat16": "bf16", "6__half": "f16", "a": "int8"}
KERNEL_NAMES = (
    (r"GemmBodyILi(\d)ELi(\d)E(f|13__nv_bfloat16)Lb(\d)E",
     lambda m: f"gemm {('mxu', 'vpu', 'loop')[int(m[1])]} fpw {m[2]} "
     f"{'f32' if m[3] == 'f' else 'bf16'}{' gram' if m[4] == '1' else ''}"),
    (r"MatvecBodyILb(\d)E(f|13__nv_bfloat16)Lb(\d)E",
     lambda m: f"matvec{'_t' if m[1] == '1' else ''} "
     f"{'f32' if m[2] == 'f' else 'bf16'} "
     f"{'staged' if m[3] == '1' else 'unstaged'}"),
    (r"CenterBodyI(f|13__nv_bfloat16)E",
     lambda m: f"center {'f32' if m[1] == 'f' else 'bf16'}"),
    (r"decode_kernelI(f|13__nv_bfloat16)Li(\d+)E",
     lambda m: f"flash_decode {'f32' if m[1] == 'f' else 'bf16'} hd {m[2]}"),
    (r"conv2d_bandI(f|13__nv_bfloat16)Li(\d+)E",
     lambda m: f"conv2d {'f32' if m[1] == 'f' else 'bf16'} vec {m[2]}"),
    (r"paged_prefill_mmaI(13__nv_bfloat16|6__half)(a|S\d*_)Li(\d+)E",
     lambda m: f"paged_prefill_mma {PAGE_TYPES.get(m[2], PAGE_TYPES[m[1]])} "
     f"pages hd {m[3]} (tensor cores)"),
    (r"flash_mmaILi(\d+)E", lambda m: f"flash_mma hd {m[1]} (tensor cores)"),
    (r"flash_kernelIfLi(\d+)E",
     lambda m: f"flash_kernel hd {m[1]} (CUDA cores, f32)"),
    (r"memcpy2d_kernelI([htjy])E",
     lambda m: f"hero_memcpy2d {dict(h=1, t=2, j=4, y=8)[m[1]]}-byte "
     "elements"))


INSTANCES = {}   # short kernel instance name -> "N registers; spills"


# --------------------------------------------------------------------------
# the examples: the README's first steps on the card
# --------------------------------------------------------------------------
def examples_on_card(card: str):
    """examples/quickstart_torch.py and examples/serve_batch_torch.py
    through their ``main`` with no arguments, as a reader runs them: on
    the card, the gemm on the builder kernel within the TF32 gate of the
    f64 oracle, the batch server's attention on ``flash_attention`` (one
    prefill a request a layer) and ``flash_decode`` (one a decode step a
    layer)."""
    import importlib.util
    from repro_torch.kernels.decode_attention import flash_decode
    from repro_torch.kernels.flash_attention import flash_attention
    here = os.path.dirname(os.path.abspath(__file__))

    def load(name):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(here, "examples", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    t0 = time.perf_counter()
    q = load("quickstart_torch").main([])
    assert q["launches"] == 2 and q["rel_err"] <= MXU_F32_TOL, q
    n_fa, n_dd = flash_attention.launches, flash_decode.launches
    done, eng = load("serve_batch_torch").main([])
    n_fa = flash_attention.launches - n_fa
    n_dd = flash_decode.launches - n_dd
    L = eng.cfg.n_layers()
    assert eng.device.type == "cuda" and len(done) == 10
    assert all(len(r.tokens_out) == 12 for r in done)
    assert n_fa == 10 * L and n_dd == eng.stats["decode_steps"] * L > 0, (
        n_fa, n_dd, eng.stats["decode_steps"])
    log("examples", f"{card}: quickstart_torch: gemm on the builder kernel "
        f"({q['launches']} launches) within {q['rel_err']:.2e} of the f64 "
        f"oracle (gate {MXU_F32_TOL:g}, TF32); serve_batch_torch: "
        f"{len(done)} requests x 12 tokens on cuda, flash_attention "
        f"{n_fa} = 10 x {L} layers, flash_decode {n_dd} = "
        f"{eng.stats['decode_steps']} decode steps x {L}; "
        f"{time.perf_counter() - t0:.1f} s")


def build_kernels() -> None:
    """Build every kernel library (one nvcc each, in parallel) and log each
    kernel instance's registers and spills from ptxas."""
    import re
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    log("build", f"{len(_build.SIGNATURES)} kernel libraries built with "
        f"nvcc for sm_90a in {time.perf_counter() - t0:.2f} s (set-up)")
    for name, out in _build.BUILD_LOG.items():
        fn, spill = "", ""
        for line in out.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
                for pat, short in KERNEL_NAMES:
                    m = re.search(pat, fn)
                    if m:
                        fn = short(m)
                        break
            elif "spill stores" in line:
                spill = line.strip()
            elif "registers" in line:
                regs = re.search(r"Used (\d+) registers", line)
                INSTANCES[fn] = f"{regs[1]} registers; {spill}"
                log("build", f"{name}: {fn[-60:]}: {regs[1]} registers; "
                    f"{spill}")


def kernel_entries():
    """The ``kernels`` line's entries, by name: every hand-written kernel,
    and again for each serving path that runs it at other shapes."""
    results = {
        "paged_flash_decode": {
            "name": "paged_flash_decode", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_decode_attention.cu",
            "replaces": "src/repro/kernels/paged_decode_attention.py:44",
            "launches": 0, "max_abs_err": 0.0},
        "paged_flash_prefill": {
            "name": "paged_flash_prefill", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_prefill_attention.cu",
            "replaces": "src/repro/kernels/paged_prefill_attention.py:46",
            "launches": 0, "max_abs_err": 0.0},
    }
    for name in ("paged_flash_decode", "paged_flash_prefill"):
        results[name + "_int8"] = dict(results[name], name=name + "_int8")
    for name, replaces in (
            ("autodma_tiled", "src/repro/core/autodma.py:321"),
            ("gemm", "src/repro/kernels/gemm.py:62"),
            ("matvec", "src/repro/kernels/polybench.py:31"),
            ("matvec_t", "src/repro/kernels/polybench.py:39"),
            ("covar", "src/repro/kernels/polybench.py:142")):
        results[name] = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/autodma_tiled.cu",
            "replaces": replaces, "launches": 0, "max_abs_err": 0.0}
    results["hero_memcpy2d"] = {
        "name": "hero_memcpy2d", "route": "cuda",
        "source": "src/repro_torch/csrc/hero_memcpy2d.cu",
        "replaces": "src/repro/core/dma.py:148", "launches": 0,
        "max_abs_err": 0.0}
    for name, source, replaces in (
            ("conv2d", "conv2d_3x3.cu", "polybench.py:94"),
            ("flash_decode", "decode_attention.cu", "decode_attention.py:26"),
            ("flash_attention", "flash_attention.cu",
             "flash_attention.py:55")):
        results[name] = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}", "launches": 0,
            "max_abs_err": 0.0}
    # the serving paths' own entries: launches from phase 7e's runs alone
    # (``_gemma3``: phase 7i's, timed at its local layers' shapes, phase
    # 5; CROSS_STEPS' entries: the launches of one mixer kind's layers in
    # phase 7k or 7l, timed at their shape in phase 5), times at their
    # shapes (the entries above carry the suite's)
    for name, base in (("flash_decode_dense", "flash_decode"),
                       ("flash_decode_sp", "flash_decode"),
                       ("flash_decode_cross_sp", "flash_decode"),
                       ("flash_attention_encoder_tp", "flash_attention"),
                       ("flash_attention_dense", "flash_attention"),
                       ("flash_attention_monolithic", "flash_attention"),
                       ("flash_decode_gemma3", "flash_decode"),
                       ("flash_attention_gemma3", "flash_attention"),
                       ("flash_attention_zamba2", "flash_attention"),
                       ("flash_decode_zamba2", "flash_decode"),
                       ("flash_decode_softcap", "flash_decode"),
                       ("flash_attention_softcap", "flash_attention"),
                       *((name, kernel) for spec in CROSS_STEPS.values()
                         for (_, kernel), name in spec["entries"].items())):
        results[name] = dict(results[base], name=name)
    # the paged kernels on phases 7f-7h and 7j's paths: launches from each
    # run, times at its shapes (phase 3)
    for suffix in (*ZOO.values(), "_tp"):
        for base in ("paged_flash_decode", "paged_flash_prefill"):
            results[base + suffix] = dict(results[base], name=base + suffix)
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch.kernel_suite import card_line
    card = card_line()
    log("card", f"{card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; tf32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}, tf32 cudnn "
        f"{torch.backends.cudnn.allow_tf32}")
    build_kernels()
    results = kernel_entries()
    check_kernels(results)
    torch.cuda.synchronize()
    check_suite_kernels(results)
    torch.cuda.synchronize()
    check_attention_kernels(results)
    torch.cuda.synchronize()
    suite_main_path(results)
    torch.cuda.synchronize()
    untiered = full_width_serve(results, card)
    prefix_int8_serve(results, card)
    tiered_serve(results, card, untiered)
    t0 = time.perf_counter()
    fleet_serve(card)
    log("serve fleet", f"phase 7d in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dense_serve(results, card, untiered)
    log("serve dense", f"phase 7e in {time.perf_counter() - t0:.1f} s")
    for arch, profile in (("yi-34b", True), ("minitron-4b", False)):
        t0 = time.perf_counter()
        zoo_serve(results, card, arch, profile)
        log(f"serve {arch}", f"phase {'7f' if profile else '7g'} in "
            f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tp_serve(results, card, untiered)
    log("serve tp", f"phase 7h in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dense_zoo_serve(results, card, "gemma3-27b")
    log("serve gemma3-27b", f"phase 7i in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    zoo_serve(results, card, "granite-moe-3b-a800m", True)
    log("serve granite-moe-3b-a800m",
        f"phase 7j in {time.perf_counter() - t0:.1f} s")
    for arch, spec in CROSS_STEPS.items():
        t0 = time.perf_counter()
        cross_steps(results, card, arch)
        log(f"steps {arch}", f"phase {spec['phase']} in "
            f"{time.perf_counter() - t0:.1f} s")
    for arch in ("xlstm-1.3b", "zamba2-1.2b", "deepseek-v3-671b"):
        t0 = time.perf_counter()
        dense_zoo_serve(results, card, arch)
        log(f"serve {arch}", f"phase {DENSE_ZOO[arch]['phase']} in "
            f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    card_vs_cpu()
    dense_zoo_vs_cpu()
    steps_vs_cpu()
    log("card/cpu", f"phase 8 in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ref_steps, ref_m_sq = train_full(card)
    log(f"train {TRAIN['arch']}", f"phase 9a in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_vs_cpu()
    log("train card/cpu", f"phase 9b in {time.perf_counter() - t0:.1f} s")
    for name, fn, args in (("10a", gpipe_full, ()),
                           ("10b", moe_mesh_full, ()),
                           ("10c", fsdp_full, (ref_steps,)),
                           ("10d", tp_serve_full, (results,)),
                           ("10e", tp_train_full, (ref_steps, ref_m_sq))):
        t0 = time.perf_counter()
        fn(card, *args)
        log("mesh", f"phase {name} in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    memcpy2d_check(results)
    log("dma", f"phase 11a in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dryrun_check(card)
    log("dryrun 1x1", f"phase 11b in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    examples_on_card(card)
    log("examples", f"in {time.perf_counter() - t0:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: r[k] for k in keys} for r in results.values()]
    assert all(math.isfinite(r["ms"]) for r in kernels)
    log("kernels", "no entry for models/ssm.py's Mamba2 / mLSTM / sLSTM "
        "(phases 7m, 7n) nor for deepseek-v3-671b's MLA (phase 7o, "
        "models/attention.py mla_forward; its MoE's experts are torch.bmm, "
        "as since 7j), nor for phase 9's training attention "
        "(models/flash_xla.py, whose counterpart is plain XLA with a "
        "custom VJP): the reference computes them in plain jnp and "
        "reaches no pallas_call, so they run plain PyTorch on the card by "
        "design, not for want of a port")
    assert all(r["launches"] > 0 for r in kernels), \
        [r["name"] for r in kernels if not r["launches"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
