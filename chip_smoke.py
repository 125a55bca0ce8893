#!/usr/bin/env python3
"""Drives the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. build the CUDA kernels from src/repro_torch/csrc (one nvcc each, in
     parallel);
  2. print the card's name and power limit (nvidia-smi);
  3. hold each kernel against its plain PyTorch version on the card, at
     small ragged shapes and at the shapes full dlrm-rm1 gives it, and time
     kernel, plain version and one library call beside the kernel's bound
     (the logged update, bitwise in the table and its undo rows, in f32,
     f16 and bf16, beside the index_select + index_add_ pair; rm1's bag,
     logged update and gather on f32 tables too, phase 21's path);
  4. train full-width dlrm-rm1 (bf16, 20 x 1M x 32 tables) at batch 128:
     5 relaxed steps then 2 strict ones, with the kernels' launch counts
     read around that run (a relaxed step updates the table through the
     logged update, a strict step through the plain one); repeat 3 relaxed
     steps from the same seed and require bitwise-equal losses;
  5. train dlrm-rm1 smoke on the card and on the CPU from the same params
     and require the loss curves to agree;
  6. checkpointed training at full rm1 on a pmem pool (in a temporary
     directory under build/, removed at the end; pool_compress none, as in
     phases 20 and 21: zlib is driven at full width by phase 18, and its
     tier-M of the dense tree took 13-22 s a step here): run A checkpoints 2
     relaxed steps and recovers a mirror equal to its tables; run B
     crashes between the undo COMMIT and the mirror apply of step 1,
     recovers the step-0 mirror bitwise, and resumes with losses equal to
     those of run A's state after step 0 with its relaxed carry rebuilt
     (and within 1e-2 of run A's own). The launch counts are read around
     run A, and each of its steps' undo image, captured on the card by the
     logged update, must equal the pool's bitwise;
  7. hold the flash-attention forward against its plain version on the
     card (f32 on the CUDA-core route, bf16 and f16 on the tensor-core
     route, the per-route launch count checked; causal and full; S in {1,
     17, 128, 1000}; small ragged shapes and the tinyllama and qwen3 head
     shapes, k and v read from a cache prefix; each case repeated
     bitwise), and time kernel, plain version and SDPA at full
     tinyllama-1.1b's prefill shape in bf16, f16 and f32 beside the
     kernel's bound, holding the timed calls against the plain version
     too;
  8. serve full-width tinyllama-1.1b (bf16, 22 layers, random weights) with
     greedy_generate at batch 4, prompt 1024, 32 new tokens: prefill and
     decode times, launch counts read around each part (22 flash launches
     per prefill, all on the tensor-core route, and none per decode step;
     one row gather per prefill and
     per decode step), the row gather held against its plain version and
     timed at the prefill's and a decode step's shape, a bitwise-equal
     repeat, decode at position S against a prefill of S + 1 tokens, and
     smoke tinyllama on the card against the CPU;
  9. hold the wkv6 kernels against their plain version on the card (r, k,
     v in f32 and bf16; S in {1, 15, 16, 17, 31, 63, 64, 65, 100, 1024,
     4096}; zero and random initial state; 2 heads and rwkv6-3b's 40; y and
     the final state; each case repeated bitwise, its launch counted on the
     decode route exactly when S = 1), 17 decode-route calls chained
     through the state against one call of 17, and time kernel and plain
     version at full rwkv6-3b's prefill shape and at a decode step's beside
     the kernel's bound (with and without the host's launch, each kernel
     time's min, median and max of 20), holding the timed calls against the
     plain version too;
 10. serve full-width rwkv6-3b (bf16, 32 layers, random weights) as phase 8
     serves tinyllama: 32 wkv6 launches per prefill (none on the decode
     route) and per decode step (all on it), one row gather per prefill and
     per decode step, the gather at serving's shapes, a bitwise repeat,
     decode against prefill, and smoke rwkv6 on the card against the CPU;
 11. hold the flash-attention backward kernels against their plain version
     on the card (f32 on the CUDA-core route, bf16 and f16 on the
     tensor-core route, those also against the plain emulation of its
     rounding; causal and full; S in {1, 17, 128, 1000}; (Hq, Hkv) in
     {(4, 2), (32, 4), (16, 8)}; D in {16, 64, 128}; each case repeated
     bitwise, the forward's log-sum-exp checked too), and time kernel (each
     pass too), plain version and SDPA's backward at full tinyllama-1.1b's
     training shape beside the bound, in bf16 and in f32;
 12. train full-width tinyllama-1.1b (bf16, 22 layers, remat) at batch 4 x
     1024: 3 relaxed and 3 strict steps from the same params with bitwise
     equal losses, a bitwise repeat of the relaxed run, the launch counts of
     each step (the flash forwards on the tensor-core route), step ms,
     tokens/s, busy share (one profiled step) and peak memory, which must
     fall below the functional AdamW's 41.25 GB; two smoke steps of the
     in-place AdamW and clip bitwise equal to the functional ones; the sparse
     kernels at the step's shapes (the duplicate combine
     beside F.embedding_bag, the plain update of the bf16 table and of the
     f32 scratch beside index_add_, the logged update beside index_select +
     index_add_); smoke tinyllama on the card against the CPU: 5 f32 steps
     (losses and the AdamW-trained dense params) and one bf16 step (the
     losses before and after it);
 13. checkpointed tinyllama on a pmem pool under build/ (removed at the
     end): full width with tier-E only (4 relaxed steps, each step's undo
     image on the card equal to the pool's bitwise, the recovered mirror
     bitwise the table), then at the smoke size a crash between the undo
     COMMIT and the mirror apply, bitwise recovery and a resume with the
     uninterrupted run's losses;
 14. run the port's examples on the card as a user does, one process each,
     all at once (python -m repro_torch.examples.<name>): the crash drills
     (remote, the default: a memory node and a trainer in processes of
     their own; sharded: two memory nodes, the mirror's node killed and
     restarted, a live migration whose destination is killed mid-copy, a
     node lost for good and its replica promoted; pmem; dram),
     shared_pool_demo (two trainer tenants with quotas on one node),
     train_dlrm_e2e at 20 steps, quickstart, serve_batched for
     tinyllama-1.1b and rwkv6-3b, and serve_batched's sharded drill (the
     read replica serving after the primary's node is shut down), and the
     seeded fault soak under the checker (REPRO_POOL_CHECK=1: pmem, remote
     and sharded cells over 3 seeds, a migration, a serving and a
     node-loss cell); each must exit 0 and print its marker line;
 15. hold the wkv6 backward kernel against its plain version and the plain
     emulation of its TF32 split on the card (r, k, v in f32 and bf16; S in
     {1, 15, 16, 17, 64, 100, 1024}; 2 heads and rwkv6-3b's 40; zero and
     random initial state and final-state gradient; then f16, one head at
     S around the kernel's stage edges (31-33, 47-49) in all three types,
     and r, k, v and logw as strided views, bitwise the contiguous call;
     every gradient; each case repeated bitwise, its launch counted), and
     time kernel and plain version at full rwkv6-3b's training shape beside
     the bound (the bytes: its products run on the tensor cores), device
     only beside its share of the bound, the tensor-core time of its split,
     the f32 CUDA-core time of the same operations and the floor its
     scratch of chunk-start states sets (autograd through the plain forward
     printed as a reference point), and the forward there too;
 16. train full-width rwkv6-3b (bf16, 32 layers, remat) at batch 4 x 1024
     as phase 12 trains tinyllama: bitwise-equal relaxed and strict losses,
     a bitwise repeat, each step's launches (64 wkv6 forwards on the
     chunked route, 32 backwards), step ms, tokens/s, busy share and peak
     memory (below 80 GB); the sparse kernels at its shapes; smoke rwkv6 on
     the card against the CPU (5 f32 steps: losses within 1e-5 and the
     AdamW-trained dense params, all but one element in 10^4 within 1e-5
     and every one within 1e-4, against a plain CPU run and one whose
     forward emulates the wkv6 kernel's TF32 split);
 17. serve from the trainer's pool mirror (files under build/, removed):
     full tinyllama-1.1b and rwkv6-3b as in phases 8 and 10, every token
     lookup read from a pmem pool mirror of the table (f32) through the
     hot-row serving tier; tokens and logits bitwise equal to phases 8 and
     10, the sequence mixer's launches counted per part, none of the row
     gather's; prefill and decode ms of each route in turns (gather, pool,
     pool, gather), the tier's hit rate, p50 and p99, the link and
     host-to-card bytes. Then full dlrm-rm1 trains 2 relaxed steps into a
     pmem pool while the tier serves from the same mirror, kept coherent by
     the manager's commit hook: after each commit the rows served (the
     step's touched rows and 4096 others) equal the card's tables bitwise
     and the invalidations equal the cached touched rows exactly; then one
     rm1 forward through the pool route (an EmbeddingPoolMirror of the
     stacked tables, the bags reduced near the data) against the bag
     kernel's: f32 bags within 1e-5, click probabilities within
     DLRM_POOL_PROB_TOL (0: bitwise, the gap measured);
 18. (18, 20 and 21 run at once, each in a child process of this script,
     ``python3 chip_smoke.py --drill N``, with its own directories and
     sockets under build/; their seconds are taken while they share the
     host, and a child that fails or gives no result line fails the run)
     full-width dlrm-rm1 checkpointed into a memory node in a process of
     its own (python -m repro_torch.pool.server, a pmem image under build/,
     a unix socket; removed at the end), the paper's arrangement. Run A, in
     this process: the manager loads the 2.56 GB f32 mirror over the
     socket (seconds and frames printed: it exceeds one frame's 1 GiB cap),
     1 relaxed step is checkpointed (zlib, the default, with a tier-M of
     the dense tree at step 0), its undo image captured on the card must
     equal the node's bitwise, the tier-E's link bytes must stay within
     idx + new rows + 4 KB while its media bytes exceed them (its ms
     printed beside phase 6's pmem pool, which does not compress), and the
     mirror and dense step recovered over a fresh connection must be step
     0's, the mirror equal to the tables bitwise. The drill, on a fresh
     node: the train CLI (python -m repro_torch.launch.train --full
     --pool-backend remote ..., zlib, a tier-M at step 0) in a subprocess
     is SIGKILLed once the node's manifest shows 2 committed steps; the
     node must be alive, the mirror recovered from POOL.json
     over a fresh connection must equal a clean replay on the card
     bitwise, and a resumed step (a manager on the recovered connection)
     must give the loss of the replay's twin (its tables and dense tree
     at the recovered steps, the relaxed carry rebuilt); the trainer's
     launch counts per kernel, read from its last log line, must be those
     of its relaxed steps;
 19. row-wise Adagrad on the sparse tier at full width: full dlrm-rm1
     (batch 128, embed lr 1e-5) and full tinyllama-1.1b (batch 4 x 1024,
     0.01), each from the seed's params: 3 relaxed Adagrad steps, 3
     relaxed sgd steps twice and the Adagrad run again (step ms in turns;
     the repeat bitwise in losses and accumulator; the loss within twice
     its first), 2 strict Adagrad steps: tinyllama's within 1e-6 of the
     relaxed ones, its accumulator bitwise at each step; rm1's equal at
     step 0, and with f32 tables 2 relaxed and 2 strict steps within 2e-5
     in losses and accumulator (with bf16 tables the schedules round the
     update differently from step 1, as the reference does); the Adagrad
     run's launches are the sgd run's plus exactly the accumulator's, for
     tinyllama a scatter_update and a gather_rows a step on the narrow
     route (rm1's per-table accumulator is a masked sum, no kernel), every
     table launch on the 16-byte route; tinyllama's accumulator kernels at
     the run's shapes against their plain versions, timed; smoke rm1 and
     tinyllama, 5 Adagrad steps on the card against the CPU (losses, and
     the accumulator within 1e-4);
 20. full dlrm-rm1 checkpointed into a sharded pool of three memory nodes
     (python -m repro_torch.pool.server processes, pmem images under
     build/, unix sockets; removed at the end): the mirror and the
     manifest's primary pinned to node 0, the dense tier to node 1, the
     mirror's read replica (every 2 steps), the undo ring's commit-coupled
     replica and the manifest's quorum witnesses on the others. 4 relaxed
     steps (each step's undo image on the card equal to node 0's bitwise;
     the mirror load, each tier-E step, each replica refresh's seconds and
     link bytes and each node's used bytes printed, no replication
     failure; step 0's refresh makes the replica, step 2's refreshes it in
     place), then node 0 is SIGKILLed and its image deleted; the
     survivors reopen (the lost node as typed errors), the manifest is
     elected 2 of 3, the replica is promoted in one epoch, the recovered
     mirror equals the card's tables at the replication watermark bitwise
     (the step after it rolled back from the replica's undo ring), and a
     resumed step gives the uninterrupted twin's loss; every client's
     reply stalls printed;
 21. full dlrm-rm1 with f32 tables trained under the crash-consistency
     checker (REPRO_POOL_CHECK=1) into a pmem pool under build/ (removed),
     relaxed, dense_interval=1, pool_compress none: run U checkpoints 2
     steps (launch counts, 16-byte routes, the mirror equal to the
     tables), then an undo-commit persisted over a dirty payload in its
     ring must raise CommitBeforePayloadError; its state after step 0,
     the relaxed carry dropped, is the twin, which takes step 1 without a
     manager. A torn run (seed 32) under FaultSchedule.seeded(seed, the
     soak's POINTS, every=4) faults in step 1's tier-E, is power-cycled,
     recovered under the checker (step 0, gap 0, rolled back, the mirror
     bitwise the twin's tables) and resumed to step 2:
     losses bitwise the twin's and within the reference soak's gap-0
     bound (rtol 1e-5) of run U's, the mirror bitwise the twin's tables.
     The fault that fired, each run's seconds, the checked tier-E seconds
     beside phase 6's unchecked ones, the seconds inside the tracker and
     its most dirty intervals printed;
 22. the remaining decoders: flash held against its plain version and
     timed beside SDPA and its bound at head dim 128 (each served id's
     prefill shape; the forward with lse and the backward at llama3.2-3b's
     training shape, the backward also at granite-20b's, MQA); then
     llama3.2-3b, granite-20b, jamba-v0.1-52b (8 of 32 layers),
     qwen3-moe-235b-a22b (4 of 94) and arctic-480b (2 of 35) served at
     full width as phase 8 serves tinyllama, one at a time (random bf16
     weights from seed 0; the init's peak at most the params and the f32
     token table; three timed generations; flash launched once a prefill
     per attention layer; the MoE pairs capacity dropped in the prefill;
     decode vs a prefill of S + 1 on the rows routed alike, and the first
     MoE layer's input on every row; smoke card vs CPU); full llama3.2-3b
     trained as phase 12 trains tinyllama (relaxed == strict bitwise, a
     bitwise repeat, launches per step) and its sparse tier timed; smoke
     qwen3-moe, arctic and jamba trained on the card (5 f32 steps; a strict
     run and a second relaxed one, both bitwise the first) against the
     CPU (1e-5).
 23. the last two families, whisper-base (encoder and decoder, the head
     tied to the token table) and qwen2-vl-7b (M-RoPE, vision embeds):
     flash held against its plain version with the full (not causal)
     mask at whisper's widths (1 to 1024 queries against 1000 to 1500
     keys, ragged against the tiles) and timed beside SDPA and its bound
     at the encoder's and the cross-attention's shapes (1024 and 1500
     frames) and qwen2-vl's prefill shape (28 q and 4 kv heads of 128);
     the forward with lse and the backward at both models' training
     shapes and the cross-attention's over 1500 frames; both served at
     full width and depth as phase 8 serves tinyllama (the batch's frames
     or vision embeds and M-RoPE positions with the prompt; flash 18
     times a whisper prefill: 6 encoder, 6 self- and 6 cross-attention
     layers); whisper-base trained at full width and depth and qwen2-vl-7b
     at full width and QWEN2VL_TRAIN_LAYERS layers as phase 12 trains
     tinyllama (the tied head: every row of the table updated, one more
     update a step for the rows' gradient, no scratch), each sparse tier
     timed; both at the smoke size on the card against the CPU (5 f32
     steps, strict and a second relaxed run bitwise the first). Prints the
     device memory held at its start and its peak.
 24. serving under a mesh: two ranks on this one card (gloo, cuda:0 for
     both, ``repro_torch.launch.mesh.spawn``) under {"batch": None,
     "cache_seq": "model"}. jamba-v0.1-52b at phase 22's width and depth,
     each rank drawing the whole model's random stream and keeping its
     half of the vocab rows and of the experts (``sharding.keep_shard``):
     the near-data lookup through the gather kernel on its rows,
     context-parallel decode over its 528 cache positions, 8 of 16
     experts a MoE layer. Three greedy generations (repeated bitwise; the
     first counted by part: launches, collective calls and bytes) and a
     teacher-forced one on phase 22's tokens, held against phase 22's
     run (rerun here teacher-forced for its routing, bitwise its logits):
     the prefill's logits, the decode logits on the rows routed alike,
     the first MoE input after attention on every row, and the greedy
     tokens (a token may differ only after a near-tie or a rerouted
     row). Then full rm1's forward at batch 128, 500,000 rows of each
     table a rank (the near-data bag: one B*T*d f32 all-reduce, whatever
     L is), against the one-rank forward of phase 4's params. Rank 0
     holds the shards' gather and bag and flash at jamba's prefill shape
     against their plain versions and times them beside their bounds.
 25. training under a mesh: full dlrm-rm1 with f32 tables at batch 128,
     two gloo ranks on this card under {"batch": ("data",)}, through
     ``train_loop.train`` under ``sharding.use_sharding``: 4 relaxed steps
     at (data, model) = (1, 2), each rank half of every table's rows, and
     at (2, 1), each rank half of every batch, held against the one-rank
     run of phase 4's params (losses within rtol 2e-5, the tables within
     1e-5 of the largest value; each gap printed beside its gate), with
     each step's host ms and each collective's calls, bytes and seconds;
     then a crash drill at (1, 2) through one writer into a pmem pool
     (``distributed.checkpoint.MeshCheckpoint``): the writer crashes
     between step 1's undo COMMIT and its mirror apply, recovery at both
     ranks (``recover_on_mesh``) gives each rank its block bitwise as it
     held it after step 0, every committed undo entry equals the ranks'
     images, and 2 resumed steps match the uninterrupted run within rtol
     2e-5. Rank 0 holds the duplicate combine, the logged update, the
     scratch update and the checkpoint gather on its block against their
     plain versions and times them beside their bounds.
 26. the paper's evaluation model (``repro_torch.sim``, the simulator of
     Figs. 11-13 for the paper's testbed; its batch times and joules are
     the model's, not the card's): the four headline figures uncalibrated,
     within tests/test_sim.py's bands; then calibrated
     (``engine.calibrate_from_pool``) from phase 6 run A's pool counters
     over its checkpointed steps (the mirror load left out; no undo
     compression ratio, since phase 6 runs without zlib), every system x
     RM's batch time printed and finite and positive; then one measured
     pool batch (``calibration.measured_pool_batch``, the reference's
     default sizes) on dram and on a pmem file under build/ in both
     capture modes (wire: the image out and back through
     ``UndoRing.append``; pool: the fused ``log_and_apply`` with zlib):
     link and media bytes and the compression tallies equal to the
     values tests/test_torch_sim.py pins, pool mode below wire mode in
     link bytes, the energy terms, link_savings_x and energy_savings_pct
     as benchmarks/fig13_energy.py forms them, each batch's wall seconds
     on this host, and the calibration from the pmem pool-mode batch. It
     launches no kernel.
 27. dense tensor parallelism and the Megatron-SP residual stream: full
     tinyllama-1.1b (22 layers, bf16, remat) at two gloo ranks sharing
     this card, (data, model) = (1, 2), under the rules the port's
     ``launch.dryrun.build_rules`` gives its profile (heads, kv heads and,
     for training, the sequence over model), each rank drawing the whole
     model's random stream and keeping its column, row and vocab blocks.
     Rank 0 first runs the one-rank reference alone. Then, at batch 1 x
     1024 (cut from 4 x 1024: every layer's stream crosses gloo as f32
     through the host), 2 strict and 2 relaxed steps: losses, gradient
     norms and the params gathered whole against the one-rank run within
     TP_LOSS_RTOL / TP_PARAM_MAX / TP_PARAM_MEAN, relaxed == strict
     bitwise, each step's host ms, collectives and launches a rank, peak
     memory; a crash drill through one writer (tier-E only: a full-width
     tier-M is about 13 GB), the writer crashing between step 1's undo
     COMMIT and its mirror apply, recovery at both ranks bitwise the
     twin's blocks, one resumed step bitwise the uninterrupted one;
     serving at batch 4, prompt 1024, 16 new tokens under the decode
     rules (each rank its kv heads over every position): tokens equal to
     the one-rank run's, logits within TP_LOGIT_TOL, prefill and decode ms
     beside one rank's; context-parallel decode ({"batch": None,
     "cache_seq": "model"}) teacher-forced on the one-rank tokens, every
     row's logits within CP_LOGIT_TOL. Rank 0 holds flash (forward with
     lse and backward at 16/2 heads, the prefill shape), the gather on its
     (16000, 2048) vocab block, the duplicate combine, the updates of the
     block and its f32 scratch and the logged update against their plain
     versions and times them beside their bounds.
 28. FSDP and a kv head the mesh does not divide: full-width granite-20b
     (d 6144, 48 heads, one kv head, d_ff 24576, vocab 49152; depth cut
     to FS_LAYERS of 52 layers) at four gloo ranks sharing this card,
     (data, model) = (2, 2), under the rules ``build_rules`` gives its own
     profile (the weights' embed dimension over data, heads and the
     sequence over model, the kv head whole on every model rank). Each
     rank holds a quarter of every projection and of the head, gathered
     at its use (``distributed.fsdp``). Rank 0 first runs the one-rank
     reference alone (2 strict steps, a generation). Then, at a global
     batch of 4 x 512: one strict step, and 2 relaxed steps into a mesh
     checkpoint (tier-E) whose writer crashes in step 1, recovery at every
     rank bitwise the twin's blocks; relaxed == strict bitwise after step
     0; each rank's held elements exactly a quarter of each blocked leaf
     and every other leaf whole, its peak (less the checks' copies) below
     half the one-rank peak, its collectives a step; the losses, step 0's
     gradient norm and rank 0's blocks against the one-rank run within
     FS_LOSS0_RTOL / FS_LOSS_RTOL / FS_NORM0_RTOL / FS_PARAM_MEAN;
     serving at batch 2, prompt 512, a prefill and 2 decode steps under
     the decode rules, each step gathering every layer's blocks, logits
     within FS_LOGIT_TOL. Rank 0 holds flash (24 query heads and the one
     kv head of dim 128, with lse and backward, and the prefill shape),
     the gather on its (24576, 6144) vocab block, the duplicate combine,
     both updates and the logged update against their plain versions and
     times them beside their bounds.
 29. The MoE and mamba blocks under their models' own profiles: full-width
     qwen3-moe-235b-a22b (1 of 94 layers), jamba-v0.1-52b (trained at 2
     of 32 layers, a mamba layer with a dense FFN and one with MoE; served
     at 8, one attention period) and arctic-480b (served at 1 of 35
     layers; a trained layer would hold about 160 GB) at four gloo ranks
     sharing this card, (data, model) = MM_MESH = (1, 4), under the rules
     ``build_rules`` gives each profile (the experts, heads, jamba's SSD
     heads and the sequence over model, ``w_embed`` over a data axis of
     one rank). Rank 0 first runs each one-rank reference alone. Then
     qwen3-moe at a global batch of 2 x 512: one strict step, 2 relaxed
     steps into a mesh checkpoint (tier-E) whose writer crashes in step 1,
     recovery at every rank bitwise the twin's state, one resumed step
     bitwise the uninterrupted one; jamba one strict and one relaxed
     step, bitwise equal; each rank's held elements exactly its blocks;
     step 0's loss against the one-rank run within MM_LOSS0_RTOL, step 1's
     within MM_LOSS_RTOL; each id served at batch 2, prompt 512, a prefill
     and 2 decode steps under its decode rules, the logits on the rows
     routed alike in every MoE layer within MM_LOGIT_TOL of the one-rank
     run's, the (token, slot) pairs whose experts flipped at most
     MM_FLIP_MAX of them, the prefill's first MoE input within
     MM_MOE_INPUT_TOL; the 2 decode steps again from the one-rank
     prefill's state (each rank its block of it), fed the one-rank
     tokens, their logits within MM_LOGIT_TOL on the (row, step)s routed
     alike, at least one of them; peak memory, step host ms and
     collectives a rank. Rank 0 holds flash (16
     query heads over 1 kv head of dim 128, with lse and backward, and the
     prefill shape), the gather on its (37984, 4096) vocab block, the
     duplicate combine, both updates and the logged update against their
     plain versions and times them beside their bounds.
Phases 6 to 29 print their wall time. Phases 4, 8, 10, 12 and 16 also
require every scatter_update and gather_rows launch of the path on its
16-byte route (su.wide_launches, gr.wide_launches), and phases 4, 6, 12,
13, 16, 18 and 20 every scatter_update_logged launch
(su.wide_launches_logged); phases 18 and 20 every row kernel launch.

The line before the last is {"kernels": [...]}, one entry per kernel and
path (the row gather runs on eight: each checkpoint, each served model's
prefill and decode steps, and each LM's training; the plain update on
six: each training path's relaxed run, on the f32 scratch, and its
strict run, on the bf16 table; the logged update on the three training
paths; wkv6 forward on rwkv6-3b's prefill, decode and training, its
backward on training; each flash direction's tensor-core route on the
bf16 paths and its f32 route in phase 12's f32 smoke training; phase 17's
pool-served tinyllama prefill (flash) and rwkv6-3b prefill and decode
(wkv6) as paths of their own; phase 18's run A, the rm1 path checkpointed
into the memory node, as one more for the bag, both updates and the
gather; phase 19's Adagrad runs of rm1 and tinyllama, tinyllama's
accumulator launches (narrow) as paths of their own; phase 20's rm1 run into the
sharded pool; phase 21's run U, rm1 on f32 tables under the checker;
phase 22's five served ids (flash, the gather in prefill and decode) and
llama3.2-3b's training; phase 23's two served ids and their training;
phase 24's rank 0: the gather on its shard in jamba's prefill and decode,
flash in its prefill, the bag on its shard in rm1's forward; phase 25's
rank 0: the bag, both updates on its block of rm1's rows and the
checkpoint's gather there; phase 27's rank 0, phase 28's and 29's: flash's
forward and backward at its heads in training and its forward in the
prefill, the gather on its vocab block in training, serving and the
checkpoint, the combine, both updates and the logged update on its
block);
the last line is
{"ok": true, "device": {...}}. Phase 1 prints each kernel's registers,
shared memory and spills from ptxas.
Imports nothing of JAX.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate (data sheet)
F32_OPS_PER_S = 67e12        # H100 SXM f32 rate outside the tensor cores
BF16_TENSOR_OPS_PER_S = 989e12   # H100 SXM dense bf16 tensor-core rate
TF32_TENSOR_OPS_PER_S = 495e12   # H100 SXM dense TF32 tensor-core rate
SPIN_CYCLES = 2_000_000      # about 1 ms at the H100's clock


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def time_ms(torch, fn, iters=20, warmup=3, hide_host=False, samples=None):
    """Median time of fn() in ms over ``iters`` calls, CUDA events around
    each call, with the 50 MB L2 flushed before each so the gathered rows
    start cold. The median, not the mean: one call that waits on the host
    (a scheduler or collector pause of a millisecond or more) would move
    the mean of 20 single calls by tens of microseconds. ``samples``, a
    list, receives every call's time.

    The card reaches the start event before the host has enqueued fn's
    kernels, so the time includes the host's launch overhead (the way the
    kernel rows of PERF.md have been timed). With ``hide_host`` the card
    first spins for about 1 ms, long enough for the host to enqueue fn,
    and the time is the device's alone, unless the host took longer than
    the spin."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        if hide_host:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    if samples is not None:
        samples.extend(times)
    return statistics.median(times)


def bound(nbytes: float, nops: float, ops_per_s: float = F32_OPS_PER_S):
    """Least time in ms for the work, and which of bytes or operations sets
    it; the operations run at ``ops_per_s``, the card's peak for their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_shapes(torch, tag, shapes):
    """Each shape's kernel, plain version and library call timed (medians
    of 20 single calls, and device only) beside its bound; returns
    {name: the kernels line's numbers}."""
    timing = {}
    for name, (kern, plain, lib, (b_ms, b_by)) in shapes.items():
        timing[name] = {"ms": time_ms(torch, kern), "plain_ms": time_ms(torch, plain),
                        "library_ms": None if lib is None else time_ms(torch, lib),
                        "bound_ms": b_ms, "bound_by": b_by}
        device_only = {"ms": time_ms(torch, kern, hide_host=True),
                       "plain_ms": time_ms(torch, plain, hide_host=True),
                       "library_ms": None if lib is None
                       else time_ms(torch, lib, hide_host=True)}
        print(f"{tag} {name}: " + json.dumps(timing[name]) + "; device only: "
              + json.dumps(device_only))
    return timing


def time_manager(mgr, times):
    """Times each call of ``mgr``'s on_step, flush and writer items into
    ``times`` (ms lists by name): the wrappers shadow the methods that the
    writer thread looks up on the instance."""
    for name in ("on_step", "flush", "_do_tier_e", "_do_tier_m"):
        fn = getattr(mgr, name)

        def wrapper(*a, _fn=fn, _name=name):
            t = time.perf_counter()
            try:
                return _fn(*a)
            finally:
                times.setdefault(_name, []).append(1e3 * (time.perf_counter() - t))
        setattr(mgr, name, wrapper)


def checkpoint_phase(torch, np, cfg, tc, Bsz, dev, fresh_state,
                     plain_step_ms=None):
    """Phase 6: run A checkpoints 2 relaxed steps; run B crashes between
    the undo COMMIT and the mirror apply of step 1, recovers step 0 and
    resumes to step 1. Returns the launch counts of run A, the checkpointed
    path, its writer's tier-E ms per step, and its pool's counters over its
    checkpointed steps (the mirror load left out)."""
    import contextlib
    import dataclasses
    import gc
    import shutil
    import tempfile

    from repro_torch.core.checkpoint import recovery
    from repro_torch.core.checkpoint.manager import (CheckpointManager,
                                                     check_undo_images,
                                                     touched_rows, undo_image)
    from repro_torch.data.lookahead import LookaheadIterator
    from repro_torch.data.synthetic import DLRMBatches
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import gather_rows as gr
    from repro_torch.kernels import ops
    from repro_torch.kernels import scatter_update as su
    from repro_torch.pool import FaultSchedule, InjectedCrash
    from repro_torch.training import train_loop
    from repro_torch.tree import tree_map

    T, R, d = cfg.dlrm_num_tables, cfg.dlrm_rows_per_table, cfg.dlrm_bottom_mlp[-1]
    mirror_gb = T * R * d * 4 / 1e9
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with open("/proc/meminfo") as f:
        avail_gb = next(int(ln.split()[1]) for ln in f
                        if ln.startswith("MemAvailable:")) / 1e6
    disk_gb = shutil.disk_usage(build).free / 1e9
    print(f"[ckpt] before: host RAM available {avail_gb:.1f} GB, disk free "
          f"{disk_gb:.1f} GB under build/; f32 mirror {mirror_gb:.2f} GB, "
          f"pool image {2 * mirror_gb:.2f} GB")
    # RAM: the pool's cache (2 x mirror) of a run and of its recovery, the
    # host copies of the tables it compares, the recovered mirror. Disk: one
    # pool image at a time (run A's is removed before run B)
    check(avail_gb >= 8 * mirror_gb, f"checkpoint phase needs {8 * mirror_gb:.0f} "
          f"GB of free host RAM, {avail_gb:.1f} GB available")
    check(disk_gb >= 2 * mirror_gb, f"checkpoint phase needs {2 * mirror_gb:.0f} "
          f"GB of free disk under {build}, {disk_gb:.1f} GB free")

    # every batch made first (set-up), as in phase 4; runs A and B share them
    batches = LookaheadIterator(DLRMBatches(cfg, Bsz, seed=0, device=dev), cfg,
                                depth=5)
    work = tempfile.mkdtemp(prefix="ckpt-smoke-", dir=build)
    try:
        def config(name):
            cc = dataclasses.replace(tc.checkpoint, directory=os.path.join(work, name),
                                     dense_interval=1, pool_backend="pmem",
                                     pool_compress="none")
            return dataclasses.replace(tc, checkpoint=cc)

        def host_tables(state):
            t = state["embed"]["emb_tables"]   # updated in place: copy
            return t.to("cpu", torch.float32, copy=True).numpy().reshape(-1, d)

        # run A: 2 relaxed steps, every step checkpointed, dense_interval=1
        tca = config("A")
        state = fresh_state()
        t = time.perf_counter()
        mgr = CheckpointManager(cfg, tca.checkpoint, embed_init=state["embed"])
        load_s = time.perf_counter() - t
        print(f"[ckpt] manager start + mirror load (2.56 GB f32 written and "
              f"fsynced): {load_s:.2f}s")
        # phase 26 reads the pool's counters over the checkpointed steps
        # only, the mirror load left out
        loaded = pool_counters(mgr.pool.metrics)
        times, kept, stamps = {}, {"s": 0.0}, [time.perf_counter()]
        time_manager(mgr, times)
        timed_on_step = mgr.on_step

        def on_step(step, st, feed):
            timed_on_step(step, st, feed)
            if step == 0:
                # run A after the step run B recovers: the tables on the
                # host in f32, and a twin state on the card with its relaxed
                # carry dropped, as a resume rebuilds it (the tables, the
                # dense leaves and their moments are updated in place:
                # cloned)
                t = time.perf_counter()
                kept["rows"] = host_tables(st)
                kept["state"] = {
                    **st, "prefetch": None,
                    "embed": {"emb_tables": st["embed"]["emb_tables"].clone()},
                    "dense": tree_map(torch.clone, st["dense"]),
                    "opt_dense": tree_map(torch.clone, st["opt_dense"])}
                kept["s"] += time.perf_counter() - t   # not the step's time
        mgr.on_step = on_step
        images = {}

        def on_metrics(n, m):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter() - kept["s"])
            kept["feed"] = m["ckpt_feed"]
            t = time.perf_counter()        # the undo image to the host
            images[n] = undo_image(m["ckpt_feed"])
            kept["s"] += time.perf_counter() - t

        eb.launches = su.launches = su.launches_logged = gr.launches = 0
        su.wide_launches_logged = 0
        _, la = train_loop.train(cfg, tca, batches, 2, relaxed=True, state=state,
                                 ckpt_manager=mgr, on_metrics=on_metrics)
        # (train flushed the writer; the checks below read the ring)
        steps_metrics = metrics_since(loaded, mgr.pool.metrics)
        launches = {"embedding_bag": eb.launches, "scatter_update": su.launches,
                    "scatter_update_logged": su.launches_logged,
                    "gather_rows": gr.launches}
        check(su.wide_launches_logged == su.launches_logged, "run A: the logged "
              f"updates did not all move 16-byte chunks ({su.wide_launches_logged} "
              f"of {su.launches_logged})")
        checked = check_undo_images(mgr.ring, images)
        check(checked == 2, f"run A: {checked} undo entries checked, want 2")
        print(f"[ckpt] run A: the undo images of all {checked} steps, captured on "
              "the card by the logged update, equal the pool's bitwise")
        del images
        step_ms = [1e3 * (b - a) for a, b in zip(stamps[:-1], stamps[1:], strict=True)]
        print(f"[ckpt] run A losses {la} step ms (with on_step) {step_ms}"
              + ("" if plain_step_ms is None else
                 f"; plain relaxed step (phase 4 median) {plain_step_ms:.2f} ms"))
        print(f"[ckpt] on_step ms {times['on_step']}; flush ms {times['flush']}; "
              f"writer tier-E ms {times['_do_tier_e']}, tier-M ms {times['_do_tier_m']}")
        # on_step's two halves again, with the writer idle: the touched rows
        # (gather, widen, to the host) and the dense tree to the host
        flat_tab = state["embed"]["emb_tables"].view(-1, d)
        parts = {"rows": [], "dense": []}
        for _ in range(3):
            t = time.perf_counter()
            ids, _ = touched_rows(kept["feed"])
            ops.gather_rows(flat_tab, ids).float().cpu().numpy()
            parts["rows"].append(1e3 * (time.perf_counter() - t))
            t = time.perf_counter()
            tree_map(lambda x: x.detach().to("cpu", copy=True),
                     {k: state[k] for k in ("dense", "opt_dense", "opt_embed")})
            parts["dense"].append(1e3 * (time.perf_counter() - t))
        del kept["feed"]
        print(f"[ckpt] on_step parts with the writer idle, ms: touched rows "
              f"{parts['rows']}, dense tree {parts['dense']}")
        print(f"[ckpt] stats {json.dumps(mgr.stats)}")
        print(f"[ckpt] pool image {os.path.getsize(os.path.join(work, 'A', 'pool.img'))} "
              f"bytes; launches {launches}")
        check(launches == checkpointed_launches(2),
              f"checkpoint run: unexpected launch counts {launches}")
        print(mgr.pool.metrics.report())
        mgr.close()
        final = host_tables(state)
        del mgr, state
        gc.collect()                      # frees the pool's 5 GB cache now
        torch.cuda.empty_cache()
        t = time.perf_counter()
        rec = recovery.recover(os.path.join(work, "A"))
        print(f"[ckpt] run A recover: {time.perf_counter() - t:.2f}s")
        check(rec.mirror_step == rec.dense_step == 1 and not rec.rolled_back,
              f"run A recovered mirror@{rec.mirror_step} dense@{rec.dense_step}")
        check(np.array_equal(rec.embed_rows, final),
              "run A: recovered mirror differs from the final tables")
        rec.pool.close()
        del rec, final
        shutil.rmtree(os.path.join(work, "A"))
        # the twin: run A's state after step 0, carry rebuilt, 1 relaxed step
        _, lt = train_loop.train(cfg, tca, batches, 1, relaxed=True,
                                 state=kept.pop("state"), start_step=1)
        gc.collect()
        torch.cuda.empty_cache()

        # run B: the same seed and batches, power loss between the COMMIT
        # and the mirror apply of step 1 (the second tier-E)
        tcb = config("B")
        state = fresh_state()
        mgr = CheckpointManager(cfg, tcb.checkpoint, embed_init=state["embed"],
                                faults=FaultSchedule.crash_at(
                                    "tier_e.between-commit-and-apply", occurrence=2))
        crashed = False
        try:
            train_loop.train(cfg, tcb, batches, 2, relaxed=True, state=state,
                             ckpt_manager=mgr)
        except InjectedCrash:
            crashed = True
        check(crashed, "run B: no InjectedCrash")
        with contextlib.suppress(InjectedCrash):
            mgr.close()                   # process death: the pool file stays
        del mgr, state
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        rec = recovery.recover(os.path.join(work, "B"))
        print(f"[ckpt] run B recover: {time.perf_counter() - t:.2f}s, "
              f"mirror@{rec.mirror_step} dense@{rec.dense_step} "
              f"rolled_back={rec.rolled_back}")
        check(rec.mirror_step == rec.dense_step == 0 and rec.rolled_back,
              "run B: expected mirror@0, dense@0 with a rollback")
        check(np.array_equal(rec.embed_rows, kept["rows"]),
              "run B: recovered mirror differs from run A's tables after step 0")
        del kept["rows"]

        # resume as the CLI does: a manager on the recovered pool, 1 relaxed
        # step (its loss against run A's step 1), then 1 strict step
        state, start = recovery.resume_train_state(rec, fresh_state())
        check(start == 1, f"resume step {start}")
        mgr = CheckpointManager(cfg, tcb.checkpoint, pool=rec.pool)
        mgr.init_mirror(state["embed"], step=rec.mirror_step)
        del rec
        gr.launches = 0
        state, lb = train_loop.train(cfg, tcb, batches, 1, relaxed=True,
                                     state=state, start_step=start, ckpt_manager=mgr)
        relaxed_gathers = gr.launches
        train_loop.train(cfg, tcb, batches, 1, relaxed=False, state=state,
                         start_step=start + 1, ckpt_manager=mgr)
        mgr.close()
        rel = max(abs(x - y) / abs(y) for x, y in zip(lb, la[start:], strict=True))
        print(f"[ckpt] resumed losses {lb}; run A's twin (state after step 0, "
              f"carry rebuilt) {lt}; run A {la[start:]} (max relative difference "
              f"{rel:.3g}); gather launches {relaxed_gathers} for 1 relaxed "
              f"step, {gr.launches} after 1 strict")
        # The recovered state is run A's after step 0 bit for bit, so the
        # resumed losses equal the twin's exactly.
        check(lb == lt, "resumed losses differ from run A's twin")
        # Against run A itself they differ by the carry: run A's bags for
        # the resumed step were rounded to bf16 twice (the stale bag, then
        # with the correction added), the resumed ones once, from the
        # updated tables. bf16 keeps 8 bits, so a bag moves by up to 2^-9 of itself
        # and the loss by about 1e-3; 1e-2 bounds it.
        check(rel <= 1e-2, f"resumed losses differ from run A's by {rel:.3g}")
        check(relaxed_gathers == 1 and gr.launches == 1,
              "gather_rows: want 1 launch per relaxed step, 0 per strict step")
        del mgr, state
        gc.collect()
        torch.cuda.empty_cache()
        print("[ckpt] crash, bitwise recovery and resume: ok")
        return launches, times["_do_tier_e"], steps_metrics
    finally:
        shutil.rmtree(work, ignore_errors=True)


def flash_phase(torch, dev):
    """Phase 7. Returns (each route's max abs error against the plain
    version, timings at full tinyllama-1.1b's prefill shape: bf16 and f16 on
    the tensor-core route, f32 on the CUDA-core route)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    errs = {}

    def qkv(B, S, Hq, Hkv, D, dtype, smax):
        # k, v are the first S entries of a (B, smax, Hkv, D) cache, read in
        # place as prefill reads them
        q = torch.randn((B, S, Hq, D), generator=gen, device=dev).to(dtype)
        kc, vc = (torch.randn((B, smax, Hkv, D), generator=gen, device=dev).to(dtype)
                  for _ in range(2))
        return q, kc[:, :S], vc[:, :S]

    # small ragged shapes, then tinyllama's heads (D=64, G=8) and qwen3's
    # (D=128, G=2); f32 takes the CUDA-core route, f16 and bf16 the
    # tensor-core one (the per-route launch count says which ran); each
    # case is repeated and must give the same bits
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for causal in (True, False):
            for S in (1, 17, 128, 1000):
                for B, Hq, Hkv, D in ((2, 4, 2, 16), (1, 6, 2, 16),
                                      (4, 32, 4, 64), (2, 16, 8, 128)):
                    q, k, v = qkv(B, S, Hq, Hkv, D, dtype, S + 7)
                    tc0 = fa.tc_launches
                    got = ops.flash_attention(q, k, v, causal=causal)
                    again = ops.flash_attention(q, k, v, causal=causal)
                    want = ref.flash_attention_ref(q, k, v, causal=causal)
                    torch.cuda.synchronize()
                    what = f"{dtype} causal={causal} B={B} S={S} Hq={Hq} Hkv={Hkv} D={D}"
                    check(got.dtype == dtype and got.shape == want.shape,
                          f"flash_attention {what}: shape/dtype")
                    check(fa.tc_launches - tc0 == 2 * (dtype != torch.float32),
                          f"flash_attention {what}: wrong route")
                    check(torch.equal(got, again), f"flash_attention {what}: two calls differ")
                    # f32: 2e-5 (another summation order); f16/bf16: torch's
                    # defaults, one rounding of the output
                    tol = {"rtol": 2e-5, "atol": 2e-5} if dtype == torch.float32 else {}
                    try:
                        torch.testing.assert_close(got, want, **tol)
                    except AssertionError as e:
                        fail(f"flash_attention {what}: {e}")
                    e = (got.float() - want.float()).abs().max().item()
                    errs[dtype] = max(errs.get(dtype, 0.0), e)
    print("[flash] 96 cases against the plain version, each repeated bitwise: ok; "
          "max abs err " + ", ".join(f"{d}: {e:.3g}" for d, e in errs.items()))

    # full tinyllama-1.1b prefill: B=4, S=1024, Hq=32, Hkv=4, D=64, causal, k
    # and v a prefix of a 1056-deep cache; bf16 (the served type) and f16 on
    # the tensor-core route, f32 on the CUDA-core route
    B, S, Hq, Hkv, D = 4, 1024, 32, 4, 64
    # q, k, v read once and o written once; a causal call multiplies
    # S(S+1)/2 (query, key) pairs twice over D (scores and P.V); the
    # tensor-core route's split of P makes the second product two
    pairs = B * Hq * S * (S + 1) / 2
    nops, nops_split = 4 * D * pairs, 6 * D * pairs
    timings = {}
    for dtype, rate in ((torch.bfloat16, BF16_TENSOR_OPS_PER_S),
                        (torch.float16, BF16_TENSOR_OPS_PER_S),
                        (torch.float32, F32_OPS_PER_S)):
        q, k, v = qkv(B, S, Hq, Hkv, D, dtype, S + 32)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))   # SDPA's layout, views
        nbytes = q.element_size() * (2 * B * S * Hq * D + 2 * B * S * Hkv * D)
        b_ms, b_by = bound(nbytes, nops, rate)

        def library(qt=qt, kt=kt, vt=vt):
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)

        def kern(q=q, k=k, v=v):
            return ops.flash_attention(q, k, v)

        def plain(q=q, k=k, v=v):
            return ref.flash_attention_ref(q, k, v)
        got, want = kern(), plain()
        lib_err = (library().transpose(1, 2).float() - want.float()).abs().max().item()
        tol = {"rtol": 2e-5, "atol": 2e-5} if dtype == torch.float32 else {}
        try:
            torch.testing.assert_close(got, want, **tol)   # as the 96 cases
        except AssertionError as e:
            fail(f"flash_attention {dtype} at the tinyllama prefill shape: {e}")
        errs[dtype] = max(errs[dtype], (got.float() - want.float()).abs().max().item())
        del got, want
        timing = {"ms": time_ms(torch, kern), "plain_ms": time_ms(torch, plain),
                  "library_ms": time_ms(torch, library), "bound_ms": b_ms,
                  "bound_by": b_by}
        device_only = {"ms": time_ms(torch, kern, hide_host=True),
                       "plain_ms": time_ms(torch, plain, hide_host=True),
                       "library_ms": time_ms(torch, library, hide_host=True)}
        split = "" if dtype == torch.float32 else (
            f", {nops_split / 1e9:.2f} GFLOP with P split, bound "
            f"{bound(nbytes, nops_split, rate)[0]:.5f} ms")
        print(f"[flash] tinyllama prefill shape B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} "
              f"{dtype} ({nops / 1e9:.2f} GFLOP{split}, {nbytes / 1e6:.1f} MB): "
              + json.dumps(timing) + "; device only: " + json.dumps(device_only)
              + f"; SDPA vs plain max abs diff {lib_err:.3g}")
        timings[dtype] = timing
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    # each route's own largest error: f32 the CUDA-core kernel, f16 and bf16
    # the tensor-core one
    route_err = {"flash_attention": errs[torch.float32],
                 "flash_attention_tc": max(errs[torch.bfloat16], errs[torch.float16])}
    return route_err, timings


def wkv6_phase(torch, dev):
    """Phase 9. Returns (max abs error against the plain version, timings at
    full rwkv6-3b's prefill shape and at a decode step's)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import wkv6 as wk

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    K, err = 64, 0.0

    def inputs(B, S, H, dtype, with_s0):
        # r, k, v in dtype; logw over the whole clamp range [-5, -1e-4]
        def rand(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device=dev) * scale
        r, k, v = (rand(B, S, H, K, scale=0.5).to(dtype) for _ in range(3))
        logw = torch.clamp(-torch.exp(rand(B, S, H, K, scale=1.5) - 1.0), -5.0, -1e-4)
        return (r, k, v, logw, rand(H, K, scale=0.3),
                rand(B, H, K, K, scale=0.1) if with_s0 else None)

    def compare(got, want, what):
        # 3e-4: the tolerance tests/test_kernels.py holds the Pallas kernel to
        nonlocal err
        for name, g, w in zip(("y", "s_fin"), got, want, strict=True):
            try:
                torch.testing.assert_close(g, w, rtol=3e-4, atol=3e-4)
            except AssertionError as e:
                fail(f"wkv6 {what} {name}: {e}")
            err = max(err, (g - w).abs().max().item())

    # every case twice: one launch a call, on the decode route exactly when
    # S = 1, and the same bits both times
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for S in (1, 15, 16, 17, 31, 63, 64, 65, 100, 1024, 4096):
            for with_s0 in (False, True):
                for B, H in ((2, 2), (4, 40)):
                    what = f"{dtype} B={B} S={S} H={H} s0={with_s0}"
                    x = inputs(B, S, H, dtype, with_s0)
                    before = (wk.launches, wk.decode_launches)
                    got = ops.wkv6(*x)
                    again = ops.wkv6(*x)
                    check((wk.launches, wk.decode_launches)
                          == (before[0] + 2, before[1] + 2 * (S == 1)),
                          f"wkv6 {what}: want 2 launches, on the decode route iff S = 1")
                    want = ref.wkv6_ref(*x)
                    torch.cuda.synchronize()
                    check(all(torch.equal(a, b) for a, b in zip(got, again)),
                          f"wkv6 {what}: two calls differ")
                    compare(got, want, what)
                    n += 1
                    del x, got, again, want
    # S = 17 as 17 decode-route calls, the state carried through s_out, against
    # one call
    for dtype in (torch.float32, torch.bfloat16):
        for B, H in ((2, 2), (4, 40)):
            r, k, v, logw, u, s0 = inputs(B, 17, H, dtype, True)
            y_one, s_one = ops.wkv6(r, k, v, logw, u, s0)
            state = s0.clone()
            rows = [ops.wkv6(r[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1], logw[:, t:t + 1],
                             u, state, s_out=state)[0] for t in range(17)]
            compare((torch.cat(rows, dim=1), state), (y_one, s_one),
                    f"{dtype} B={B} H={H}: 17 decode steps against one call of 17")
            n += 1
    torch.cuda.empty_cache()
    print(f"[wkv6] {n} cases against the plain version (each repeated bitwise; 4 of "
          f"them 17 decode steps against one call): ok; max abs err {err:.3g}")

    # full rwkv6-3b: B=4, H=40, bf16 r, k, v, a random state in; the final
    # state goes to its own buffer so that repeated calls see the same inputs
    timing = {}
    for name, S in (("prefill", 1024), ("decode", 1)):
        B, H = 4, 40
        x = inputs(B, S, H, torch.bfloat16, True)
        s_out = torch.empty_like(x[5])

        def kern(x=x, s_out=s_out):
            return ops.wkv6(*x, s_out=s_out)

        def plain(x=x):
            return ref.wkv6_ref(*x)
        compare(kern(), plain(), f"rwkv6-3b {name} shape (timed inputs)")
        # r, k, v (bf16), logw (f32) and u read once, the state read and
        # written once, y (f32) written once; per chunk of c rows and head,
        # the products the function needs: the scores' lower triangle with
        # its diagonal (the bonus r u k^T) and their product with v, c (c+1)/2
        # dot products of K each, then r_f S and k^T v, c x K x K each (the
        # exps, the cumulative sums and the state's decay, about 4% more,
        # are not counted)
        nbytes = B * S * H * K * (3 * 2 + 4 + 4) + H * K * 4 + 2 * B * H * K * K * 4
        nops = sum(2 * (c * (c + 1) * K + 2 * c * K * K) * B * H
                   for c in [16] * (S // 16) + ([S % 16] if S % 16 else []))
        b_ms, b_by = bound(nbytes, nops)
        with_host, alone = [], []
        timing[name] = {"ms": time_ms(torch, kern, samples=with_host),
                        "plain_ms": time_ms(torch, plain),
                        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        device_only = {"ms": time_ms(torch, kern, hide_host=True, samples=alone),
                       "plain_ms": time_ms(torch, plain, hide_host=True)}
        spread = {k: [min(v), statistics.median(v), max(v)]
                  for k, v in (("with_host", with_host), ("device_only", alone))}
        print(f"[wkv6] rwkv6-3b {name} shape B={B} S={S} H={H} K={K} bf16 "
              f"({nops / 1e9:.4f} GFLOP, {nbytes / 1e6:.1f} MB): "
              + json.dumps(timing[name]) + "; device only: " + json.dumps(device_only)
              + "; kernel min, median, max of 20: " + json.dumps(spread))
    torch.cuda.empty_cache()
    return err, timing


def wkv6_bwd_phase(torch, dev):
    """Phase 15. Returns (max abs error against the plain version, timings
    of the backward and of the forward at full rwkv6-3b's training shape)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import wkv6 as wk

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    K, err, emul_gap = 64, 0.0, 0.0
    out_rtol = {torch.float32: 0.0, torch.float16: 2**-11, torch.bfloat16: 2**-8}

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def inputs(B, S, H, dtype, with_state):
        # r, k, v in dtype; logw over the whole clamp range [-5, -1e-4]; the
        # cotangents dy and (with a state) ds_fin
        r, k, v = (rand(B, S, H, K, scale=0.5).to(dtype) for _ in range(3))
        logw = torch.clamp(-torch.exp(rand(B, S, H, K, scale=1.5) - 1.0), -5.0, -1e-4)
        s0 = rand(B, H, K, K, scale=0.1) if with_state else None
        return (r, k, v, logw, rand(H, K, scale=0.3), s0, rand(B, S, H, K),
                rand(B, H, K, K) if with_state else None)

    def compare(got, want, what, atol_share=1e-4, track=True):
        # 1e-4 of each gradient's largest magnitude: both f32, the sums in
        # other orders; dr, dk, dv in bf16 (f16) also one rounding, 2^-8
        # (2^-11) relative (tests/test_torch_cuda.py's WKV6_BWD_TOL). Against
        # the emulation of the kernel's TF32 split, 1e-5 (WKV6_BWD_EMUL_TOL)
        nonlocal err, emul_gap
        for name, g, w in zip(("dr", "dk", "dv", "dlogw", "du", "ds0"), got, want,
                              strict=True):
            if w is None:
                check(g is None, f"wkv6_bwd {what}: {name} given without s0")
                continue
            scale = w.abs().max().item() + 1e-30
            try:
                torch.testing.assert_close(g.float(), w, rtol=out_rtol[g.dtype],
                                           atol=atol_share * scale)
            except AssertionError as e:
                fail(f"wkv6_bwd {what} {name}: {e}")
            if track:
                err = max(err, (g.float() - w).abs().max().item())
            elif g.dtype == torch.float32:
                # the gap to the emulation, in f32 outputs, of the largest magnitude
                emul_gap = max(emul_gap, (g - w).abs().max().item() / scale)

    def twice(x, what):
        # one launch a call and the same bits both times
        before = wk.bwd_launches
        got = ops.wkv6_bwd(*x)
        again = ops.wkv6_bwd(*x)
        check(wk.bwd_launches == before + 2, f"wkv6_bwd {what}: want 2 launches")
        torch.cuda.synchronize()
        check(all((a is None and b is None) or torch.equal(a, b)
                  for a, b in zip(got, again, strict=True)),
              f"wkv6_bwd {what}: two calls differ")
        return got

    def case(x, what):
        got = twice(x, what)
        compare(got, ref.wkv6_bwd_ref(*x), what)
        compare(got, ref.wkv6_bwd_ref(*x, tf32="split"), what + " (TF32 emulation)",
                atol_share=1e-5, track=False)

    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for S in (1, 15, 16, 17, 64, 100, 1024):
            for with_state in (False, True):
                for B, H in ((2, 2), (4, 40)):
                    case(inputs(B, S, H, dtype, with_state),
                         f"{dtype} B={B} S={S} H={H} state={with_state}")
                    n += 1
    # f16; the design's edges (one head, S around the ring of three 16-row
    # input stages and the two output stages); r, k, v as head-strided
    # views and logw sequence-strided, bitwise the contiguous call
    for S in (1, 17, 100, 1024):
        for with_state in (False, True):
            case(inputs(2, S, 3, torch.float16, with_state),
                 f"f16 B=2 S={S} H=3 state={with_state}")
            n += 1
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for S in (31, 32, 33, 47, 48, 49):
            case(inputs(1, S, 1, dtype, True), f"{dtype} B=1 S={S} H=1 state=True")
            n += 1
    for dtype in (torch.float32, torch.bfloat16):
        for S in (37, 1024):
            x = inputs(2, S, 3, dtype, True)
            wide = torch.cat([t.float() for t in x[:3]], dim=-1).to(dtype)
            logw = torch.cat([x[3], torch.zeros_like(x[3])], dim=1)[:, :S]
            got = twice((wide[..., :K], wide[..., K:2 * K], wide[..., 2 * K:], logw, *x[4:]),
                        f"strided {dtype} S={S}")
            check(all(torch.equal(a, b) for a, b in zip(got, ops.wkv6_bwd(*x), strict=True)),
                  f"wkv6_bwd strided {dtype} S={S}: differs from the contiguous call")
            n += 1
    torch.cuda.empty_cache()
    print(f"[wkv6-bwd] {n} cases against the plain version and the emulation of its "
          f"TF32 split (each repeated bitwise): ok; max abs err {err:.3g}; largest gap to "
          f"the emulation in an f32 output {emul_gap:.3g} of its largest magnitude")

    # full rwkv6-3b training: B=4, S=1024, H=40, bf16 r, k, v, no state in
    # and no gradient of the final state, as each layer's call in a step
    B, S, H = 4, 1024, 40
    r, k, v, logw, u, _, dy, _ = inputs(B, S, H, torch.bfloat16, False)
    compare(ops.wkv6_bwd(r, k, v, logw, u, None, dy),
            ref.wkv6_bwd_ref(r, k, v, logw, u, None, dy),
            "rwkv6-3b training shape (timed inputs)")
    chunks = [16] * (S // 16) + ([S % 16] if S % 16 else [])
    # bytes: r, k, v read and dr, dk, dv written once (bf16), logw and dy
    # read and dlogw written once (f32), u read and du written once.
    # Operations, per chunk of c rows and head: five c x K x K products (the
    # state's recompute, r_f^T dy, v G^T, kd G, dy S_prev^T), three over the
    # scores' triangle with its diagonal and two over the strict one, K
    # multiply-adds an entry (the exps and the scan, a few percent, not
    # counted)
    nbytes = B * S * H * K * (6 * 2 + 3 * 4) + 2 * H * K * 4
    nops = sum(2 * (5 * c * K * K + 3 * c * (c + 1) // 2 * K + 2 * c * (c - 1) // 2 * K)
               * B * H for c in chunks)
    # the kernel does every product on the tensor cores as three TF32
    # products (hi hi + hi lo + lo hi), so they run at the TF32 rate; the
    # f32 CUDA-core time of the same operations is printed beside it. The
    # scratch of chunk-start states (written once, read once) sets the
    # design's own floor
    b_ms, b_by = bound(nbytes, 3 * nops, TF32_TENSOR_OPS_PER_S)
    scratch = B * H * len(chunks) * K * K * 4
    floor_ms = (nbytes + 2 * scratch) / HBM_BYTES_PER_S * 1e3
    leaves = [t.detach().requires_grad_() for t in (r, k, v, logw, u)]

    def autograd_plain():
        y, _ = ref.wkv6_ref(*leaves)
        return torch.autograd.grad(y, leaves, dy)

    def kern():
        return ops.wkv6_bwd(r, k, v, logw, u, None, dy)
    timing = {"wkv6_bwd": {
        "ms": time_ms(torch, kern),
        "plain_ms": time_ms(torch, lambda: ref.wkv6_bwd_ref(r, k, v, logw, u, None, dy)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}}
    dev_ms = time_ms(torch, kern, hide_host=True)
    reference_ms = time_ms(torch, autograd_plain)
    print(f"[wkv6-bwd] rwkv6-3b training shape B={B} S={S} H={H} K={K} bf16 "
          f"({nops / 1e9:.4f} GFLOP, {nbytes / 1e6:.1f} MB): "
          + json.dumps(timing["wkv6_bwd"]) + "; " + json.dumps({
              "device_only_ms": dev_ms, "share_of_bound": b_ms / dev_ms,
              "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
              "tf32_split_tensor_core_ms": 3 * nops / TF32_TENSOR_OPS_PER_S * 1e3,
              "f32_cuda_core_ms": nops / F32_OPS_PER_S * 1e3,
              "share_of_f32_cuda_core_ms": nops / F32_OPS_PER_S * 1e3 / dev_ms,
              "scratch_mb": scratch / 1e6, "scratch_floor_ms": floor_ms})
          + "; library: none (no single PyTorch call computes it); reference point "
          f"only, not a library call: autograd through ref.wkv6_ref, forward and "
          f"backward, {reference_ms:.4f} ms")
    # the forward as training calls it (no state in; the final state
    # written): r, k, v, logw and u read once, y and the state written once
    nbytes_f = B * S * H * K * (3 * 2 + 4 + 4) + H * K * 4 + B * H * K * K * 4
    nops_f = sum(2 * (c * (c + 1) * K + 2 * c * K * K) * B * H for c in chunks)
    compare_f = (ops.wkv6(r, k, v, logw, u), ref.wkv6_ref(r, k, v, logw, u))
    for name, g, w in zip(("y", "s_fin"), *compare_f, strict=True):
        try:
            torch.testing.assert_close(g, w, rtol=3e-4, atol=3e-4)
        except AssertionError as e:
            fail(f"wkv6 forward at the training shape, {name}: {e}")
    fb_ms, fb_by = bound(nbytes_f, nops_f)
    timing["wkv6_train"] = {"ms": time_ms(torch, lambda: ops.wkv6(r, k, v, logw, u)),
                            "plain_ms": time_ms(torch, lambda: ref.wkv6_ref(r, k, v, logw, u)),
                            "library_ms": None, "bound_ms": fb_ms, "bound_by": fb_by}
    print("[wkv6-bwd] the forward at the training shape (no state in): "
          + json.dumps(timing["wkv6_train"]) + "; device only: " + json.dumps(
              {"ms": time_ms(torch, lambda: ops.wkv6(r, k, v, logw, u), hide_host=True)}))
    del r, k, v, logw, u, dy, leaves
    torch.cuda.empty_cache()
    return err, timing


def serve_counts(mixer, gr, zero=False):
    """The serving path's launch counters: the sequence mixer's (flash
    attention also counts its tensor-core route, which bf16 serving must
    take, wkv6 its decode route, a decode step's S = 1) and the row
    gather's. With ``zero`` they are set to 0 first."""
    mix = mixer.__name__.rsplit(".", 1)[1]
    names = {mix: "launches", mix + "_tc": "tc_launches",
             mix + "_decode": "decode_launches"}
    counters = [(k, mixer, a) for k, a in names.items() if hasattr(mixer, a)]
    counters.append(("gather_rows", gr, "launches"))
    if zero:
        for _, mod, attr in counters:
            setattr(mod, attr, 0)
    return {k: getattr(mod, attr) for k, mod, attr in counters}


def serve_want(mixer, cfg, per_step, new, gathers):
    """The launches each part of a served generation of ``new`` tokens must
    make: the sequence mixer once a layer that has it in the prefill (every
    layer but jamba's mamba ones; all on the tensor-core route where it has
    one, none on a decode route) and ``per_step`` times a decode step (all
    on a decode route where it has one); ``gathers`` row gathers a forward
    pass."""
    mix = mixer.__name__.rsplit(".", 1)[1]
    n_mix = sum(t == "attn" for t in cfg.layer_types)
    if cfg.arch_type == "whisper":   # the encoder's layers and the cross-attention
        n_mix += cfg.encoder_layers + cfg.num_layers
    want = {"prefill": {mix: n_mix, "gather_rows": gathers},
            "decode": {mix: per_step * (new - 1), "gather_rows": gathers * (new - 1)}}
    if hasattr(mixer, "tc_launches"):
        for part in want.values():
            part[mix + "_tc"] = part[mix]
    if hasattr(mixer, "decode_launches"):
        want["prefill"][mix + "_decode"] = 0
        want["decode"][mix + "_decode"] = want["decode"][mix]
    return want


def part_counter(parts, read):
    """A ``greedy_generate`` part hook that stores in ``parts[name]`` how
    much each counter of ``read()`` (a dict) moved over that part."""
    @contextlib.contextmanager
    def count(name):
        before = read()
        yield
        parts[name] = {k: v - before[k] for k, v in read().items()}
    return count


def prefill_extras(torch, cfg, extras, S):
    """The keywords of a prefill of S tokens of the request whose batch
    extras are ``extras``: whisper's frames; qwen2-vl's vision embeds and
    its M-RoPE positions, t = h = w = the token's position, as the batches
    make them."""
    if cfg.arch_type == "whisper":
        return {"frames": extras["frames"]}
    if cfg.arch_type == "qwen2vl":
        B = extras["vision_embeds"].shape[0]
        pos = torch.arange(S, device=extras["vision_embeds"].device)
        return {"vision_embeds": extras["vision_embeds"],
                "positions3": pos.expand(3, B, S).contiguous()}
    return {}


def request(make_batches, cfg, B, S, device):
    """Step 0's batch of the synthetic stream: (its tokens, its other
    entries but the labels: frames, vision embeds, M-RoPE positions)."""
    batch = make_batches(cfg, B, S, device=device).next(0)
    return batch["tokens"], {k: v for k, v in batch.items()
                             if k not in ("tokens", "labels")}


def serve_phase(torch, np, dev, check_gather, arch, mixer, per_step, layers=None):
    """Phases 8, 10, 22 and 23: serve ``arch`` at full width, at ``layers``
    layers if given (else its own depth); a request's extras (whisper's
    frames, qwen2-vl's vision embeds and positions) come from the batch.
    ``mixer`` is the wrapper module of
    the path's sequence-mixer kernel (flash attention, wkv6), launched
    once per layer that has it in the prefill and ``per_step`` times in each
    decode step. The generation runs three times (the first counted, the
    second its bitwise repeat; prefill and decode ms are also given as the
    medians of the three). Returns the serving run's launch counts for
    each part ("prefill", "decode"), the row gather's timings at each
    part's shape, the run's tokens and logits (on the host), which phase 17
    holds the pool-served run to, and the run's metrics."""
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import make_batches
    from repro_torch.kernels import gather_rows as gr
    from repro_torch.kernels import ops, ref
    from repro_torch.models import moe
    from repro_torch.models.registry import get_api
    from repro_torch.training.serve_loop import greedy_generate
    from repro_torch.tree import tree_leaves, tree_map

    mix = mixer.__name__.rsplit(".", 1)[1]
    cfg = get_arch(arch).model
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    api = get_api(cfg)
    B, S, new = 4, 1024, 32
    n_moe = sum(t == "moe" for t in cfg.ffn_types)
    t = time.perf_counter()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = api.init(gen, cfg)
    torch.cuda.synchronize()
    init_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    n_params = sum(p.numel() for p in tree_leaves(params))
    params_gb = sum(p.numel() * p.element_size() for p in tree_leaves(params)) / 1e9
    # the init draws the token table in f32 and casts it: the stack's
    # leaves are allocated once, each layer drawn into its slice
    table_f32_gb = cfg.vocab_size * cfg.d_model * 4 / 1e9
    prompt, extras = request(make_batches, cfg, B, S, dev)
    print(f"[serve] full-width {arch}, {cfg.num_layers} layers: {n_params} params "
          f"({params_gb:.2f} GB, {cfg.dtype}), init and prompt "
          f"{time.perf_counter() - t:.1f}s; peak device GB over the init {init_gb:.3f} "
          f"(the params' {params_gb:.3f} + the f32 table's {table_f32_gb:.3f} = "
          f"{params_gb + table_f32_gb:.3f} at most)")
    check(init_gb <= params_gb + table_f32_gb, f"serve {arch}: the init peaked at "
          f"{init_gb:.3f} GB, above the params and the f32 table")
    greedy_generate(cfg, params, prompt, 2, extras=extras, max_seq=S + new)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    parts = {}
    serve_counts(mixer, gr, zero=True)
    gr.wide_launches = 0
    stats = {}
    with moe.recording() as routed:
        toks = greedy_generate(cfg, params, prompt, new, extras=extras, max_seq=S + new,
                               stats=stats,
                               part=part_counter(parts, lambda: serve_counts(mixer, gr)))
    launches = serve_counts(mixer, gr)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    metrics = {"prefill_ms": 1e3 * stats["prefill_s"],
               "decode_ms_per_token": 1e3 * stats["decode_s"] / (new - 1),
               "tokens_per_s": B * new / (stats["prefill_s"] + stats["decode_s"]),
               "peak_device_gb": peak_gb, "params": n_params, "params_gb": params_gb,
               "init_peak_gb": init_gb}
    if n_moe:
        # the prefill's MoE layers come first, one routing record each
        pre = routed[:n_moe]
        metrics["moe_dropped_share_prefill"] = \
            sum(int(r["dropped"].sum()) for r in pre) / sum(r["dropped"].numel() for r in pre)
    print(f"[serve] batch {B}, prompt {S}, {new} new tokens: {json.dumps(metrics)}; "
          f"launches {launches}, by part {parts}")
    print(f"[serve] tokens[0] {toks[0].tolist()}")
    check(parts == serve_want(mixer, cfg, per_step, new, gathers=1)
          and launches == {k: parts["prefill"][k] + parts["decode"][k] for k in launches},
          f"serve: want {cfg.num_layers} {mix} launches in the prefill (all on the "
          f"tensor-core route where it has one, none on a decode route), {per_step} "
          f"per decode step (all on a decode route where it has one), and one "
          f"gather per prefill and per decode step; got {parts}, {launches} in all")
    check(gr.wide_launches == gr.launches, "serve: the gathers did not all move "
          f"16-byte chunks ({gr.wide_launches} of {gr.launches})")
    check(toks.shape == (B, new) and 0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size,
          "serve: tokens out of range")
    check(bool(torch.isfinite(stats["logits"]).all()), "serve: non-finite logits")

    again = {}
    toks2 = greedy_generate(cfg, params, prompt, new, extras=extras, max_seq=S + new,
                            stats=again)
    check(torch.equal(toks, toks2) and torch.equal(stats["logits"], again["logits"]),
          "serve: a second run gave other tokens or logits")
    walls = [(stats["prefill_s"], stats["decode_s"]), (again["prefill_s"], again["decode_s"])]
    del again
    more = {}
    greedy_generate(cfg, params, prompt, new, extras=extras, max_seq=S + new, stats=more)
    walls.append((more["prefill_s"], more["decode_s"]))
    del more
    metrics["prefill_ms_runs"] = [1e3 * p for p, _ in walls]
    metrics["decode_ms_per_token_runs"] = [1e3 * d / (new - 1) for _, d in walls]
    metrics["prefill_ms_median"] = statistics.median(metrics["prefill_ms_runs"])
    metrics["decode_ms_per_token_median"] = statistics.median(
        metrics["decode_ms_per_token_runs"])
    print(f"[serve] {arch} over 3 runs: prefill ms {metrics['prefill_ms_runs']}, "
          f"decode ms a token {metrics['decode_ms_per_token_runs']}; medians "
          f"{metrics['prefill_ms_median']:.2f}, "
          f"{metrics['decode_ms_per_token_median']:.2f}")
    served = (toks.cpu(), stats["logits"].cpu())

    # the row gather at the shapes serving gives it: the token table with
    # the prompt's B * S ids (prefill) and with the first decode step's B ids
    table = params["embed"]["table"]
    row_bytes = table.shape[1] * table.element_size()
    timing = {}
    for name, ids in (("prefill", prompt.reshape(-1).to(torch.int32).contiguous()),
                      ("decode", toks[:, 0].contiguous())):
        check_gather(table, ids, f"{arch} {name} ({ids.numel()} ids, "
                                 f"table {tuple(table.shape)} {table.dtype})")
        # the ids once, each distinct row read once, each output row written
        # once; no operations
        n_rows = torch.unique(ids).numel()
        b_ms, b_by = bound(ids.numel() * 4 + (n_rows + ids.numel()) * row_bytes, 0)

        def kern(ids=ids):
            return ops.gather_rows(table, ids)

        def plain(ids=ids):
            return ref.gather_rows_ref(table, ids)

        def library(ids=ids):
            return torch.index_select(table, 0, ids)
        timing[name] = {"ms": time_ms(torch, kern), "plain_ms": time_ms(torch, plain),
                        "library_ms": time_ms(torch, library), "bound_ms": b_ms,
                        "bound_by": b_by}
        device_only = {"ms": time_ms(torch, kern, hide_host=True),
                       "plain_ms": time_ms(torch, plain, hide_host=True),
                       "library_ms": time_ms(torch, library, hide_host=True)}
        print(f"[serve] gather_rows {name}: {ids.numel()} ids, {n_rows} distinct: "
              + json.dumps(timing[name]) + "; device only: " + json.dumps(device_only))

    # decode at position S (the first generated token) against a prefill of
    # the S + 1 tokens. The two paths round bf16 activations at different
    # places (other matmul shapes; for tinyllama the flash kernel against
    # the plain decode), about 2^-9 relative per rounding over 22 or 32
    # layers; 3e-2 of the logits' largest magnitude bounds that.
    # With MoE layers the logits gate holds the rows whose new token the two
    # paths routed alike: the same experts in every MoE layer and no pair
    # dropped by capacity in the prefill (a decode step of B tokens drops
    # none). Elsewhere the two are other functions of the input, as in the
    # reference: with random weights the routing concentrates and capacity
    # drops most of a long prefill's pairs. On every row the first MoE
    # layer's input for the new token (embedding and attention over the
    # cache, before any routing) is held to 3e-2 of its largest magnitude.
    ext = torch.cat([prompt, toks[:, :1]], dim=1)
    with moe.recording() as routed_full:
        full, _ = api.prefill(params, cfg, ext, api.init_cache(cfg, B, S + 1, dev),
                              **prefill_extras(torch, cfg, extras, S + 1))
    dec = stats["logits"][:, 1]
    alike = torch.ones(B, dtype=torch.bool, device=dev)
    last = torch.arange(B, device=dev) * (S + 1) + S
    for p_rec, d_rec in zip(routed_full[:n_moe], routed[n_moe:2 * n_moe], strict=True):
        same = (p_rec["choice"][last].sort(-1).values == d_rec["choice"].sort(-1).values)
        alike &= same.all(-1) & ~p_rec["dropped"][last].any(-1)
    if n_moe:
        x_full = routed_full[0]["x"][last].float()
        x_diff = (routed[n_moe]["x"].float() - x_full).abs().max().item()
        x_scale = x_full.abs().max().item()
        metrics["first_moe_input_share_of_gate"] = x_diff / (3e-2 * x_scale)
        print(f"[serve] the first MoE layer's input for the new token, decode vs "
              f"prefill of {S + 1}: max abs diff {x_diff:.4g}, its max abs "
              f"{x_scale:.4g} (share of the 3e-2 gate {x_diff / (3e-2 * x_scale):.4g})")
        check(x_diff <= 3e-2 * x_scale, f"serve {arch}: the first MoE layer's input "
              "differs between decode and prefill")
    del routed, routed_full
    row_diff = (dec - full).abs().amax(-1)
    diff, scale = row_diff.max().item(), full.abs().max().item()
    n_alike = int(alike.sum())
    diff_alike = row_diff[alike].max().item() if n_alike else 0.0
    metrics["decode_vs_prefill_share_of_gate"] = diff_alike / (3e-2 * scale)
    metrics["decode_vs_prefill_rows_routed_alike"] = n_alike
    print(f"[serve] decode at position {S} vs prefill of {S + 1}: max abs diff "
          f"{diff:.4g} over all {B} rows (share of the gate "
          f"{diff / (3e-2 * scale):.4g}), {diff_alike:.4g} over the {n_alike} rows "
          f"routed alike; logits max abs {scale:.4g} (limit 3e-2 of it: share used "
          f"{diff_alike / (3e-2 * scale):.4g}); argmax equal in "
          f"{int((dec.argmax(-1) == full.argmax(-1)).sum())} of {B} rows")
    check(n_moe > 0 or n_alike == B, "serve: a model without MoE layers routed rows")
    check(diff_alike <= 3e-2 * scale, "serve: decode disagrees with prefill")
    del params, stats, full
    torch.cuda.empty_cache()

    # the smoke model on the card and on the CPU from the same params (f32)
    scfg = get_arch(arch, smoke=True).model
    gen = torch.Generator()
    gen.manual_seed(0)
    sparams = api.init(gen, scfg)
    sprompt, sextras = request(make_batches, scfg, 2, 9, "cpu")
    out = {}
    for name, where in (("card", dev), ("cpu", torch.device("cpu"))):
        st = {}
        tk = greedy_generate(scfg, tree_map(lambda p, w=where: p.to(w), sparams),
                             sprompt.to(where), 4, max_seq=16, stats=st,
                             extras={k: v.to(where) for k, v in sextras.items()})
        out[name] = (tk.cpu(), st["logits"].cpu())
    print(f"[serve] smoke tokens card {out['card'][0].tolist()} cpu "
          f"{out['cpu'][0].tolist()}; logits max abs diff "
          f"{(out['card'][1] - out['cpu'][1]).abs().max().item():.3g}")
    check(torch.equal(out["card"][0], out["cpu"][0]), "serve smoke: tokens differ")
    np.testing.assert_allclose(out["card"][1].numpy(), out["cpu"][1].numpy(),
                               rtol=1e-4, atol=1e-5)
    return parts, timing, served, metrics


def flash_bwd_phase(torch, dev):
    """Phase 11. Returns (each route's max abs error against the plain
    version, timings of the bf16 backward and of the forward with its
    log-sum-exp at full tinyllama-1.1b's training shape, and of the f32
    backward route at the same shape)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # the tolerance, scaled by each gradient's largest magnitude: f32 1e-4;
    # f16 and bf16 the rtol phase 7 holds the forward to (torch's defaults:
    # one rounding of the output). The 1e-5 floor covers S = 1 (and row 0
    # under a causal mask): one key gives dP = Delta, so dq and dk are zero
    # in exact arithmetic and both versions return rounding noise.
    rtol = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2, torch.float16: 1e-3}
    # f16 and bf16 take the tensor-core route: held also against its plain
    # emulation (P and dS rounded before their products; f32, no output
    # rounding) at tests/test_torch_cuda.py's TC_EMUL_RTOL
    emul_rtol = {torch.bfloat16: 1.25 * 2**-8, torch.float16: 1.25 * 2**-11}
    used, worst, emul_used, n = {}, {}, {}, 0
    err = {torch.float32: 0.0, torch.bfloat16: 0.0, torch.float16: 0.0}

    def inputs(B, S, Hq, Hkv, D, dtype, causal):
        q, do = (torch.randn((B, S, Hq, D), generator=gen, device=dev).to(dtype)
                 for _ in range(2))
        k, v = (torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(dtype)
                for _ in range(2))
        o, lse = ops.flash_attention_lse(q, k, v, causal=causal)
        return q, k, v, o, lse, do

    def compare(got, want, dtype, what, S):
        for name, g, w in zip(("dq", "dk", "dv"), got, want, strict=True):
            check(g.dtype == w.dtype == dtype and g.shape == w.shape,
                  f"flash backward {what} {name}: shape/dtype")
            e = (g.float() - w.float()).abs().max().item()
            scale = w.float().abs().max().item()
            limit = rtol[dtype] * scale + 1e-5
            check(e <= limit, f"flash backward {what} {name}: max abs err "
                  f"{e:.3g}, gradient max {scale:.3g}, limit {limit:.3g}")
            err[dtype] = max(err[dtype], e)
            used[dtype] = max(used.get(dtype, 0.0), e / limit)
            if S > 1:         # S = 1's dq and dk are rounding noise around 0
                worst[dtype] = max(worst.get(dtype, 0.0), e / scale)

    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for causal in (True, False):
            for S in (1, 17, 128, 1000):
                for Hq, Hkv in ((4, 2), (32, 4), (16, 8)):
                    for D in (16, 64, 128):
                        B = 1 if S == 1000 else 2
                        x = inputs(B, S, Hq, Hkv, D, dtype, causal)
                        what = (f"{dtype} causal={causal} B={B} S={S} Hq={Hq} "
                                f"Hkv={Hkv} D={D}")
                        lse_want = ref.flash_attention_ref(
                            *x[:3], causal=causal, return_lse=True)[1]
                        e = (x[4] - lse_want).abs().max().item()
                        check(e <= 1e-4, f"flash forward lse {what}: max abs err {e:.3g}")
                        got = ops.flash_attention_bwd(*x, causal=causal)
                        want = ref.flash_attention_bwd_ref(*x, causal=causal)
                        again = ops.flash_attention_bwd(*x, causal=causal)
                        torch.cuda.synchronize()
                        compare(got, want, dtype, what, S)
                        if dtype != torch.float32:
                            emul = ref.flash_attention_bwd_ref(
                                *(t.float() for t in x), causal=causal,
                                round_to=dtype)
                            for name, g, w in zip(("dq", "dk", "dv"), got, emul,
                                                  strict=True):
                                e = (g.float() - w).abs().max().item()
                                limit = emul_rtol[dtype] * w.abs().max().item() + 1e-5
                                check(e <= limit, f"flash backward {what} {name}: "
                                      f"{e:.3g} from the rounding emulation, "
                                      f"limit {limit:.3g}")
                                emul_used[dtype] = max(emul_used.get(dtype, 0.0),
                                                       e / limit)
                        check(all(torch.equal(a, b) for a, b in zip(got, again, strict=True)),
                              f"flash backward {what}: two calls differ")
                        n += 1
    print(f"[flash-bwd] {n} cases against the plain version, each repeated "
          f"bitwise: ok; max abs err {max(err.values()):.3g}; largest share of the limit "
          "used: " + ", ".join(f"{d}: {e:.3g}" for d, e in used.items())
          + "; largest error over the gradient's max for S > 1: "
          + ", ".join(f"{d}: {e:.3g}" for d, e in worst.items())
          + "; largest share of the emulation's limit used: "
          + ", ".join(f"{d}: {e:.3g}" for d, e in emul_used.items()))

    # full tinyllama-1.1b training: B=4, S=1024, Hq=32, Hkv=4, D=64, bf16,
    # causal (q, k, v contiguous, as the training step gives them)
    B, S, Hq, Hkv, D = 4, 1024, 32, 4, 64
    x = inputs(B, S, Hq, Hkv, D, torch.bfloat16, True)
    q, k, v, o, lse, do = x

    def kern():
        return ops.flash_attention_bwd(*x)

    def plain():
        return ref.flash_attention_bwd_ref(*x)
    got, want = kern(), plain()
    compare(got, want, torch.bfloat16, "at the tinyllama training shape", S)
    timed_err = max((g.float() - w.float()).abs().max().item()
                    for g, w in zip(got, want, strict=True))
    print("[flash-bwd] at the training shape, (elements that differ, "
          "max |gradient|) for dq, dk, dv: "
          + str([(int((g != w).sum()), w.float().abs().max().item())
                 for g, w in zip(got, want, strict=True)]))
    del got, want
    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    do_t = do.transpose(1, 2)

    def sdpa_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(*leaves, is_causal=True,
                                                  enable_gqa=True)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                             enable_gqa=True)
        return torch.autograd.grad(out, leaves, do_t)
    # q, k, v, o and do read once (bf16) and lse (f32); dq, dk, dv written
    # once; the five products the backward needs over S(S+1)/2 (query, key)
    # pairs, 5/2 of the forward's operations
    nbytes = 2 * (3 * B * S * Hq * D + 2 * B * S * Hkv * D) + 4 * B * Hq * S \
        + 2 * (B * S * Hq * D + 2 * B * S * Hkv * D)
    nops = 10 * B * Hq * D * S * (S + 1) / 2
    b_ms, b_by = bound(nbytes, nops, BF16_TENSOR_OPS_PER_S)
    lib = {"fwd_bwd": time_ms(torch, sdpa_fwd_bwd), "fwd": time_ms(torch, sdpa_fwd)}
    timing = {"ms": time_ms(torch, kern), "plain_ms": time_ms(torch, plain),
              "library_ms": lib["fwd_bwd"] - lib["fwd"], "bound_ms": b_ms,
              "bound_by": b_by}
    dev_lib = {"fwd_bwd": time_ms(torch, sdpa_fwd_bwd, hide_host=True),
               "fwd": time_ms(torch, sdpa_fwd, hide_host=True)}
    device_only = {"ms": time_ms(torch, kern, hide_host=True),
                   "plain_ms": time_ms(torch, plain, hide_host=True),
                   "library_ms": dev_lib["fwd_bwd"] - dev_lib["fwd"]}
    # each pass of the bf16 route alone, on the card's clock
    from repro_torch.kernels import _build
    delta = torch.empty((B, Hq, S), dtype=torch.float32, device=dev)
    outs = [torch.empty_like(t) for t in (q, k, v)]
    parts = [torch.empty((B, Hq, S, D), dtype=torch.float32, device=dev)
             for _ in range(2)]
    ptrs = [t.data_ptr() for t in (q, k, v, o, do, lse, delta, *outs, *parts)]
    passes = [time_ms(torch, lambda p=p: _build.launch(
        "flash_attention_bwd_tc", dev, p, *ptrs, _build.DTYPE_CODES[q.dtype],
        B, S, S, Hq, Hkv, D, 1, 0), hide_host=True)
        for p in range(fa.BWD_PASSES[q.dtype])]
    del outs, parts
    print(f"[flash-bwd] tinyllama training shape B={B} S={S} Hq={Hq} Hkv={Hkv} "
          f"D={D} bf16 causal ({nops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB; "
          f"{nops / F32_OPS_PER_S * 1e3:.4f} ms at the f32 CUDA-core rate): "
          + json.dumps(timing) + "; device only: " + json.dumps(device_only)
          + f"; SDPA forward+backward {json.dumps(lib)}, device only "
          + json.dumps(dev_lib) + "; passes (Delta, dk dv partials, dq, head "
          f"sum) device only {passes} ms; max abs err {timed_err:.3g}")

    # the f32 route (the CUDA-core kernel) at the same shape: the card-vs-CPU
    # smoke training runs in f32
    x32 = tuple(t.float() for t in x[:4]) + (x[4], x[5].float())

    def kern32():
        return ops.flash_attention_bwd(*x32)

    def plain32():
        return ref.flash_attention_bwd_ref(*x32)
    got, want = kern32(), plain32()
    compare(got, want, torch.float32, "f32 at the tinyllama training shape", S)
    err32 = max((g - w).abs().max().item() for g, w in zip(got, want, strict=True))
    del got, want
    # the same five products at the f32 rate outside the tensor cores, each
    # f32 input read once and each gradient written once
    b32_ms, b32_by = bound(2 * nbytes - 4 * B * Hq * S, nops, F32_OPS_PER_S)
    leaves32 = [t.transpose(1, 2).float().detach().requires_grad_() for t in (q, k, v)]
    do32_t = do.transpose(1, 2).float()

    def sdpa32_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(*leaves32, is_causal=True,
                                                  enable_gqa=True)

    def sdpa32_fwd_bwd():
        out = F.scaled_dot_product_attention(*leaves32, is_causal=True,
                                             enable_gqa=True)
        return torch.autograd.grad(out, leaves32, do32_t)
    timing32 = {"ms": time_ms(torch, kern32), "plain_ms": time_ms(torch, plain32),
                "library_ms": time_ms(torch, sdpa32_fwd_bwd) - time_ms(torch, sdpa32_fwd),
                "bound_ms": b32_ms, "bound_by": b32_by}
    print("[flash-bwd] f32 route at the training shape: " + json.dumps(timing32)
          + "; device only: " + json.dumps({"ms": time_ms(torch, kern32, hide_host=True)})
          + f"; max abs err {err32:.3g}")
    del x32, leaves32, do32_t

    # the forward as training calls it (log-sum-exp written), same inputs
    def fwd_lse():
        return ops.flash_attention_lse(q, k, v)

    def fwd_plain():
        return ref.flash_attention_ref(q, k, v, return_lse=True)
    nbytes_f = 2 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D) + 4 * B * Hq * S
    fb_ms, fb_by = bound(nbytes_f, 4 * B * Hq * D * S * (S + 1) / 2,
                         BF16_TENSOR_OPS_PER_S)
    fwd_timing = {"ms": time_ms(torch, fwd_lse), "plain_ms": time_ms(torch, fwd_plain),
                  "library_ms": time_ms(torch, sdpa_fwd), "bound_ms": fb_ms,
                  "bound_by": fb_by}
    print("[flash-bwd] forward with log-sum-exp at the training shape: "
          + json.dumps(fwd_timing) + "; device only: "
          + json.dumps({"ms": time_ms(torch, fwd_lse, hide_host=True)}))
    del x, q, k, v, o, lse, do, leaves, do_t, delta
    torch.cuda.empty_cache()
    # each route's own largest error: f32 the CUDA-core kernel, f16 and bf16
    # the tensor-core one
    errs = {"flash_attention_bwd": max(err[torch.float32], err32),
            "flash_attention_bwd_tc": max(err[torch.bfloat16], err[torch.float16],
                                          timed_err)}
    return errs, timing, fwd_timing, timing32


def device_busy(torch, fn):
    """(wall ms, summed kernel ms) of one call of fn under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    return wall, busy


def lm_counts(mods):
    """The launch counters of the LM training paths' kernels: the sparse
    tier's, flash attention's and wkv6's (``mods``: name -> wrapper module)."""
    fa, wk, su, gr = mods["flash_attention"], mods["wkv6"], mods["scatter_update"], \
        mods["gather_rows"]

    def counts():
        c = {name: m.launches for name, m in mods.items()}
        c["flash_attention_tc"] = fa.tc_launches
        c["flash_attention_bwd"] = fa.bwd_launches
        c["wkv6_decode"] = wk.decode_launches
        c["wkv6_bwd"] = wk.bwd_launches
        c["scatter_update_logged"] = su.launches_logged
        return c

    def wide():   # launches of the row kernels on their 16-byte route
        return {"scatter_update": su.wide_launches, "gather_rows": gr.wide_launches,
                "scatter_update_logged": su.wide_launches_logged}

    def zero_counts():
        for m in mods.values():
            m.launches = 0
        fa.tc_launches = fa.bwd_launches = su.launches_logged = 0
        wk.decode_launches = wk.bwd_launches = 0
        su.wide_launches = gr.wide_launches = su.wide_launches_logged = 0
    return counts, wide, zero_counts


def lm_train_runs(torch, dev, arch, mixer_want, layers=None):
    """Full-width training of ``arch`` (bf16, remat, batch 4 x 1024), at
    ``layers`` layers if given: 3 relaxed steps, 3 strict ones and the
    relaxed run again, each from the same params, and one profiled relaxed
    step. ``mixer_want`` is the sequence mixer's launches per step. Checks
    bitwise-equal losses, the repeat and every step's launch counts.
    Returns (the relaxed run's launch counts with the strict run's table
    updates as "scatter_update_strict", the step metrics, the run's
    batches)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.lookahead import LookaheadIterator
    from repro_torch.data.synthetic import make_batches
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gather_rows as gr
    from repro_torch.kernels import scatter_update as su
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models.registry import get_api
    from repro_torch.training import train_loop
    from repro_torch.tree import tree_leaves

    tag = f"[{arch}-train]"
    cfg = get_arch(arch).model
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    check(cfg.remat and cfg.dtype == "bfloat16", f"{arch}: want bf16 with remat")
    tc = TrainConfig(embed_learning_rate=0.05)
    B, S, steps = 4, 1024, 3
    api = get_api(cfg)
    init_fn = train_loop.make_step_fns(cfg, tc)[0]
    counts, wide, zero_counts = lm_counts({
        "flash_attention": fa, "wkv6": wk, "embedding_bag": eb,
        "scatter_update": su, "gather_rows": gr})

    def fresh_state():
        gen = torch.Generator(device=dev)
        gen.manual_seed(tc.seed)
        state = init_fn(api.init(gen, cfg))
        torch.cuda.synchronize()
        return state

    def make_batches_first():
        # every batch of a run is made before it (set-up, on the host)
        return LookaheadIterator(make_batches(cfg, B, S, device=dev), cfg,
                                 depth=steps + 2)

    t = time.perf_counter()
    state = fresh_state()
    n_params = sum(p.numel() for p in tree_leaves(state["dense"])) \
        + state["embed"]["table"].numel()
    print(f"{tag} full-width {arch}, {cfg.num_layers} layers: {n_params} params, "
          f"{cfg.dtype}, remat, batch {B} x seq {S}; init {time.perf_counter() - t:.1f}s")

    def run(state, relaxed, per_step=None):
        batches = make_batches_first()
        stamps, marks = [time.perf_counter()], [counts()]

        def on_metrics(n, m):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            marks.append(counts())
        state, losses = train_loop.train(cfg, tc, batches, steps, relaxed=relaxed,
                                         state=state, on_metrics=on_metrics)
        ms = [1e3 * (b - a) for a, b in zip(stamps[:-1], stamps[1:], strict=True)]
        if per_step is not None:   # the launches of each step, read around it
            per_step.extend({k: b[k] - a[k] for k in a}
                            for a, b in zip(marks[:-1], marks[1:], strict=True))
        return state, losses, ms

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    relaxed_steps = []
    state, rl, rms = run(state, True, relaxed_steps)
    launches = counts()
    check(wide() == {k: launches[k] for k in wide()}, f"{arch}: the row kernels "
          f"did not all move 16-byte chunks: {wide()} of {launches}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    batches = make_batches_first()
    wall, busy = device_busy(torch, lambda: train_loop.train(
        cfg, tc, batches, 1, relaxed=True, state=state, start_step=steps))
    del state
    torch.cuda.empty_cache()
    strict_steps = []
    zero_counts()
    state, sl, sms = run(fresh_state(), False, strict_steps)
    check(su.wide_launches == su.launches, f"{arch}: the strict run's updates "
          f"did not all move 16-byte chunks ({su.wide_launches} of {su.launches})")
    # one update of the bf16 table a step (a tied head's also adds the
    # touched rows' gradient into the head's, f32)
    strict_updates = su.launches - (steps if cfg.tie_embeddings else 0)
    del state
    torch.cuda.empty_cache()
    state, rl2, rms2 = run(fresh_state(), True)
    del state
    torch.cuda.empty_cache()
    # the first step of a run holds the warm-up (and the first run the
    # card's own: cuBLAS handles, the allocator's first blocks)
    med = statistics.median(rms[1:] + rms2[1:])
    step = {"relaxed_ms": rms, "strict_ms": sms, "relaxed_repeat_ms": rms2,
            "relaxed_ms_median": med, "strict_ms_median": statistics.median(sms[1:]),
            "tokens_per_s": B * S / (med / 1e3),
            "profiled_step_wall_ms": wall, "profiled_step_busy_ms": busy,
            "busy_share": busy / wall, "peak_device_gb": peak_gb,
            "layers": cfg.num_layers, "params": n_params}
    print(f"{tag} relaxed losses {rl}; strict {sl}; relaxed again {rl2}")
    print(f"{tag} launches per relaxed step {relaxed_steps}; per strict "
          f"step {strict_steps}; relaxed run {launches}")
    print(f"{tag} {json.dumps(step)}")
    check(all(math.isfinite(x) for x in rl + sl), f"{arch}: non-finite loss")
    check(rl == sl, f"{arch}: relaxed losses {rl} differ from strict {sl}")
    check(rl2 == rl, f"{arch}: relaxed losses not repeatable: {rl2} vs {rl}")
    check(peak_gb < 80, f"{arch}: peak device memory {peak_gb:.2f} GB")
    # per step: the sequence mixer's launches, one duplicate combine (a bag,
    # eb.PASSES launches), the table update (logged in a relaxed step,
    # plain in a strict one); relaxed steps also the stale lookup and the
    # correction (set, gather, clear the scratch), strict steps the lookup.
    # A tied head adds the rows' gradient into its own (one update) and
    # updates every row; its correction gathers from the dense update, with
    # no scratch to set or clear
    common = {"flash_attention": 0, "flash_attention_tc": 0, "flash_attention_bwd": 0,
              "wkv6": 0, "wkv6_decode": 0, "wkv6_bwd": 0, **mixer_want,
              "embedding_bag": eb.PASSES}
    tied = int(cfg.tie_embeddings)
    want_relaxed = {**common, "gather_rows": 2, "scatter_update": 2 - tied,
                    "scatter_update_logged": 1}
    want_strict = {**common, "gather_rows": 1, "scatter_update": 1 + tied,
                   "scatter_update_logged": 0}
    # (the warm-up's lookup runs inside the first relaxed step's reading)
    check(relaxed_steps == [{**want_relaxed, "gather_rows": 3}]
          + [want_relaxed] * (steps - 1),
          f"{arch} relaxed step launches {relaxed_steps}, want {want_relaxed} "
          "(and the warm-up's gather in the first)")
    check(strict_steps == [want_strict] * steps,
          f"{arch} strict step launches {strict_steps}, want {want_strict}")
    check(launches == {k: steps * v + (k == "gather_rows")   # the warm-up lookup
                       for k, v in want_relaxed.items()},
          f"{arch} relaxed run launches {launches}")
    check(strict_updates == steps, f"{arch} strict run: {strict_updates} updates")
    launches["scatter_update_strict"] = strict_updates
    return launches, step, batches


def lm_sparse_timing(torch, dev, cfg, batches, check_bag, check_update,
                     check_update_logged, check_gather, prefix):
    """The sparse tier's kernels at an LM training step's shapes: batch 0's
    tokens, their row gradients (bf16) combined, the bf16 table updated,
    held against their plain versions and timed beside the library's
    calls. Returns the timings, keyed ``prefix`` + shape."""
    from repro_torch.kernels import ops, ref

    table = (torch.randn((cfg.vocab_size, cfg.d_model), device=dev) * 0.02) \
        .to(torch.bfloat16)
    d = table.shape[1]
    ids = batches.next(0)["tokens"].reshape(-1).to(torch.int32).contiguous()
    N = ids.numel()
    g_rows = (torch.randn((N, d), device=dev) * 1e-3).to(torch.bfloat16)
    uniq, comb = ops.combine_duplicates(ids, g_rows)
    upd = -0.05 * comb
    n_rows = int((uniq >= 0).sum())
    order = torch.sort(ids, stable=True)[1]
    sorted_ids = ids[order]
    firsts = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                        sorted_ids[1:] != sorted_ids[:-1]])
    comb_seg = torch.cumsum(firsts, 0, dtype=torch.int32) - 1
    comb_src = order.to(torch.int32)
    comb_starts = torch.nonzero(firsts).flatten().to(torch.int32)
    what = f"{cfg.name}"
    check_bag(g_rows, comb_src, comb_seg, N, f"{what} duplicate combine")
    check_update(table.clone(), uniq, upd, f"{what} bf16 table")
    scratch = torch.zeros(table.shape, dtype=torch.float32, device=dev)
    check_update(scratch, uniq, upd, f"{what} f32 scratch")
    check_update_logged(table.clone(), uniq, upd, f"{what} bf16 table")
    check_gather(table, ids, f"{what} token lookup (training batch 0)")
    touched = uniq[:n_rows]                # the checkpoint's gather
    check_gather(table, touched, f"{what} touched rows (bf16 table)")
    real = touched.long()
    t_tab = table.clone()
    upd_real = upd[:n_rows].to(torch.bfloat16)
    upd_real_f32 = upd[:n_rows]
    shapes = {
        # the ids and the bag ids once, each row gradient once, the (N, d)
        # f32 output
        # (the library's bags are the n_rows distinct tokens, in bf16)
        "bag_combine": (lambda: ops.embedding_bag(g_rows, comb_src, comb_seg, N),
                        lambda: ref.embedding_bag_ref(g_rows, comb_src, comb_seg, N),
                        lambda: torch.nn.functional.embedding_bag(
                            comb_src, g_rows, comb_starts, mode="sum"),
                        bound(N * 4 * 2 + N * d * 2 + N * d * 4, N * d)),
        # the ids, each touched row's f32 delta, the row read and written
        "update_bf16": (lambda: ops.scatter_update(t_tab, uniq, upd),
                        lambda: ref.scatter_update_ref(t_tab, uniq, upd),
                        lambda: t_tab.index_add_(0, real, upd_real),
                        bound(N * 4 + n_rows * d * (4 + 2 * 2), n_rows * d)),
        # the relaxed step's two launches: the correction's f32 scratch
        "update_f32": (lambda: ops.scatter_update(scratch, uniq, upd),
                       lambda: ref.scatter_update_ref(scratch, uniq, upd),
                       lambda: scratch.index_add_(0, real, upd_real_f32),
                       bound(N * 4 + n_rows * d * 12, n_rows * d)),
        # a real slot: its id, its f32 delta, the row read, written and
        # logged; a pad: its id and a zero undo row
        "update_logged_bf16": (
            lambda: ops.scatter_update_logged(t_tab, uniq, upd),
            lambda: ref.scatter_update_logged_ref(t_tab, uniq, upd),
            lambda: (t_tab.index_select(0, real), t_tab.index_add_(0, real, upd_real)),
            bound(n_rows * (4 + d * (4 + 3 * 2)) + (N - n_rows) * (4 + d * 2),
                  n_rows * d)),
        # the ids once, each touched row read once and written once; no ops
        "gather_touched": (lambda: ops.gather_rows(table, touched),
                           lambda: ref.gather_rows_ref(table, touched),
                           lambda: torch.index_select(table, 0, touched),
                           bound(n_rows * 4 + 2 * n_rows * d * 2, 0)),
    }
    print(f"[{cfg.name}-train] the sparse tier's shapes: {N} ids, {n_rows} distinct")
    timing = time_shapes(torch, f"[{cfg.name}-train]",
                         {prefix + name: v for name, v in shapes.items()})
    del table, t_tab, scratch, g_rows, comb, upd, upd_real, upd_real_f32, touched, real
    torch.cuda.empty_cache()
    return timing


def smoke_train_card_vs_cpu(torch, dev, arch, dtype, n_steps, on_card=None,
                            cpu_runs=None, card_runs=None):
    """Smoke ``arch`` trained on the card and on the CPU from the same
    params (``n_steps`` relaxed steps in ``dtype``, TF32 off). Returns
    {run name: (losses, dense params f32 on the host, table f32)} for the
    run "card" and the CPU runs; ``on_card()`` reads counters before and
    after the card's run, their difference going to "card_counts".
    ``cpu_runs`` maps each CPU run's name to a context it runs in (default:
    one run, "cpu", as it is). ``card_runs`` maps the names of more runs on
    the card to their schedule (True relaxed, False strict)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.synthetic import make_batches
    from repro_torch.models.registry import get_api
    from repro_torch.training import train_loop
    from repro_torch.tree import tree_leaves, tree_map

    c = dataclasses.replace(get_arch(arch, smoke=True).model, dtype=dtype)
    tc = TrainConfig(embed_learning_rate=0.05)
    gen = torch.Generator()
    gen.manual_seed(0)
    sparams = get_api(c).init(gen, c)
    sinit = train_loop.make_step_fns(c, tc)[0]
    out = {}
    runs = [("card", dev, contextlib.nullcontext, True)] + [
        (name, dev, contextlib.nullcontext, relaxed)
        for name, relaxed in (card_runs or {}).items()] + [
        (name, torch.device("cpu"), ctx, True) for name, ctx in
        (cpu_runs or {"cpu": contextlib.nullcontext}).items()]
    for name, where, ctx, relaxed in runs:
        st = sinit(tree_map(lambda p, w=where: p.to(w, copy=True), sparams))
        before = on_card() if on_card is not None and name == "card" else None
        with ctx():
            st, losses = train_loop.train(c, tc, make_batches(c, 4, 16, device=where),
                                          n_steps, relaxed=relaxed, state=st,
                                          device=where)
        out[name] = (losses, [p.detach().float().cpu() for p in tree_leaves(st["dense"])],
                     st["embed"]["table"].float().cpu())
        if before is not None:
            out["card_counts"] = {k: v - before[k] for k, v in on_card().items()}
    return out


# Phase 22's served ids at full width: (id, layers run). The cuts are the
# card's 80 GB (bf16 params): jamba one period of 8 of its 32 layers (the
# attention layer and four MoE ones), qwen3-moe 4 of 94, arctic 2 of 35.
DECODERS = (("llama3.2-3b", None), ("granite-20b", None), ("jamba-v0.1-52b", 8),
            ("qwen3-moe-235b-a22b", 4), ("arctic-480b", 2))
# the ids trained at the smoke size on the card against the CPU
SMOKE_TRAINED = ("qwen3-moe-235b-a22b", "arctic-480b", "jamba-v0.1-52b")


def flash_timing(torch, tag, name, kern, plain, library, b, what):
    """kern, its plain version and one library call timed (medians of 20
    single calls, and device only) beside the bound ``b`` (ms, what bounds
    it); printed. Returns the kernels line's numbers."""
    timing = {"ms": time_ms(torch, kern), "plain_ms": time_ms(torch, plain),
              "library_ms": time_ms(torch, library), "bound_ms": b[0], "bound_by": b[1]}
    device_only = {"ms": time_ms(torch, kern, hide_host=True),
                   "plain_ms": time_ms(torch, plain, hide_host=True),
                   "library_ms": time_ms(torch, library, hide_host=True)}
    print(f"{tag} {name} {what}: " + json.dumps(timing) + "; device only: "
          + json.dumps(device_only))
    return timing


def flash_fwd_bytes(B, Sq, Sk, Hq, Hkv, D, lse=False):
    """q, k, v (bf16) read once and o written once, and the f32 lse."""
    return 2 * (2 * B * Sq * Hq * D + 2 * B * Sk * Hkv * D) + (4 * B * Hq * Sq if lse else 0)


def flash_hold(torch, err, q, k, v, what, causal=True):
    """The bf16 forward against its plain version (phase 7's bf16 gate, the
    default of ``assert_close``), and a second call bitwise the first."""
    from repro_torch.kernels import ops, ref

    got = ops.flash_attention(q, k, v, causal=causal)
    again = ops.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    check(torch.equal(got, again), f"flash {what}: two calls differ")
    try:
        torch.testing.assert_close(got, want)
    except AssertionError as e:
        fail(f"flash_attention {what}: {e}")
    err["flash_attention_tc"] = max(err["flash_attention_tc"],
                                    (got.float() - want.float()).abs().max().item())


def flash_train_shape(torch, err, tag, arch, q, k, v, do, causal, pairs, with_lse):
    """Flash at a training shape (q, k, v and do contiguous, bf16): the
    forward's output and lse against the plain version (lse within 1e-4);
    with ``with_lse`` the forward timed; the backward held against its
    plain version (phase 11's bf16 gate, each gradient), a second call
    bitwise the first, and timed beside SDPA's backward (forward and
    ``autograd.grad`` less the forward) and its bound. ``pairs``: the
    (query, key) pairs the mask keeps. Returns {"flash_lse_<arch>": ...,
    "flash_bwd_<arch>": ...}."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    shape = (f"B={B} Sq={Sq} Sk={Sk} Hq={Hq} Hkv={Hkv} D={D} bf16 "
             f"{'causal' if causal else 'full'}")
    timings = {}
    o, lse = ops.flash_attention_lse(q, k, v, causal=causal)
    o_ref, lse_ref = ref.flash_attention_ref(q, k, v, causal=causal, return_lse=True)
    e = (lse - lse_ref).abs().max().item()
    check(e <= 1e-4, f"flash lse at {arch}'s training shape: max abs err {e:.3g}")
    torch.testing.assert_close(o, o_ref)
    del o_ref, lse_ref
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if with_lse:
        timings[f"flash_lse_{arch}"] = flash_timing(
            torch, tag, f"flash_lse_{arch}",
            lambda: ops.flash_attention_lse(q, k, v, causal=causal),
            lambda: ref.flash_attention_ref(q, k, v, causal=causal, return_lse=True),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                   enable_gqa=True),
            bound(flash_fwd_bytes(B, Sq, Sk, Hq, Hkv, D, lse=True), 4 * D * B * Hq * pairs,
                  BF16_TENSOR_OPS_PER_S),
            f"forward with lse, training shape {shape}")
    x = (q, k, v, o, lse, do)
    got = ops.flash_attention_bwd(*x, causal=causal)
    again = ops.flash_attention_bwd(*x, causal=causal)
    want = ref.flash_attention_bwd_ref(*x, causal=causal)
    for name, g, w, a in zip(("dq", "dk", "dv"), got, want, again, strict=True):
        check(torch.equal(g, a), f"flash backward at {arch}'s shape: {name} "
              "differs between two calls")
        e = (g.float() - w.float()).abs().max().item()
        limit = 1.6e-2 * w.float().abs().max().item() + 1e-5   # phase 11's bf16 gate
        check(e <= limit, f"flash backward at {arch}'s shape {name}: max abs "
              f"err {e:.3g}, limit {limit:.3g}")
        err["flash_attention_bwd_tc"] = max(err["flash_attention_bwd_tc"], e)
    del got, again, want
    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    do_t = do.transpose(1, 2)

    def sdpa_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                                  enable_gqa=True)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(*leaves, is_causal=causal, enable_gqa=True)
        return torch.autograd.grad(out, leaves, do_t)
    # as phase 11: q, k, v, o, do and lse read once, dq, dk, dv written
    # once; five products over the pairs the mask keeps
    nbytes = 2 * (3 * B * Sq * Hq * D + 2 * B * Sk * Hkv * D) + 4 * B * Hq * Sq \
        + 2 * (B * Sq * Hq * D + 2 * B * Sk * Hkv * D)
    nops = 10 * B * Hq * D * pairs
    b_ms, b_by = bound(nbytes, nops, BF16_TENSOR_OPS_PER_S)
    lib = {"fwd_bwd": time_ms(torch, sdpa_fwd_bwd), "fwd": time_ms(torch, sdpa_fwd)}
    dev_lib = {"fwd_bwd": time_ms(torch, sdpa_fwd_bwd, hide_host=True),
               "fwd": time_ms(torch, sdpa_fwd, hide_host=True)}
    timing = {"ms": time_ms(torch, lambda: ops.flash_attention_bwd(*x, causal=causal)),
              "plain_ms": time_ms(torch, lambda: ref.flash_attention_bwd_ref(
                  *x, causal=causal)),
              "library_ms": lib["fwd_bwd"] - lib["fwd"], "bound_ms": b_ms,
              "bound_by": b_by}
    device_only = {"ms": time_ms(torch, lambda: ops.flash_attention_bwd(*x, causal=causal),
                                 hide_host=True),
                   "library_ms": dev_lib["fwd_bwd"] - dev_lib["fwd"]}
    print(f"{tag} flash_bwd_{arch} backward, training shape {shape} "
          f"({nops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB): " + json.dumps(timing)
          + "; device only: " + json.dumps(device_only) + f"; SDPA forward {json.dumps(lib)}")
    timings[f"flash_bwd_{arch}"] = timing
    return timings


def flash_hd128_phase(torch, dev, err):
    """Phase 22's flash timings at head dim 128, bf16 (the tensor-core
    routes), each held against its plain version: the forward at each
    served id's prefill shape (B 4, S 1024, its q and kv heads), the
    forward with its log-sum-exp at llama3.2-3b's training shape, and the
    backward there and at granite-20b's (MQA); beside SDPA (``enable_gqa``,
    causal) and the bound, by row 5's formulas. Raises ``err``'s entries to
    the largest errors. Returns {"flash_<id>": ..., "flash_lse_llama3.2-3b":
    ..., "flash_bwd_<id>": ...}."""
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    B, S, D = 4, 1024, 128
    timings = {}

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    for arch, _ in DECODERS:
        cfg = get_arch(arch).model
        Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
        check(cfg.resolved_head_dim == D, f"{arch}: head dim {cfg.resolved_head_dim}")
        # k, v the first S entries of a (B, S + 32, Hkv, D) cache, as prefill
        # reads them
        q = rand(B, S, Hq, D)
        k, v = (rand(B, S + 32, Hkv, D)[:, :S] for _ in range(2))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        flash_hold(torch, err, q, k, v, f"at {arch}'s prefill shape")
        # two products over the S(S+1)/2 causal (query, key) pairs of each q head
        nbytes = flash_fwd_bytes(B, S, S, Hq, Hkv, D)
        nops = 4 * D * B * Hq * S * (S + 1) / 2
        timings[f"flash_{arch}"] = flash_timing(
            torch, "[decoders]", f"flash_{arch}",
            lambda q=q, k=k, v=v: ops.flash_attention(q, k, v),
            lambda q=q, k=k, v=v: ref.flash_attention_ref(q, k, v),
            lambda qt=qt, kt=kt, vt=vt: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True),
            bound(nbytes, nops, BF16_TENSOR_OPS_PER_S),
            f"forward B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} bf16 "
            f"({nops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()

    # the training shape (q, k, v contiguous, as the step gives them):
    # llama3.2-3b's, whose step runs it, and granite-20b's (MQA: its dk/dv
    # pass has one block per key tile and kv head), timed only
    for arch in ("llama3.2-3b", "granite-20b"):
        cfg = get_arch(arch).model
        q, do = rand(B, S, cfg.num_heads, D), rand(B, S, cfg.num_heads, D)
        k, v = rand(B, S, cfg.num_kv_heads, D), rand(B, S, cfg.num_kv_heads, D)
        timings.update(flash_train_shape(torch, err, "[decoders]", arch, q, k, v, do, True,
                                         S * (S + 1) / 2, arch == "llama3.2-3b"))
        del q, k, v, do
        torch.cuda.empty_cache()
    return timings


def decoders_phase(torch, np, dev, err, check_bag, check_update, check_update_logged,
                   check_gather):
    """Phase 22: the remaining decoder families. Serves each of DECODERS at
    full width (bf16, seed 0, batch 4, a 1024-token prompt, 32 new tokens;
    one model on the card at a time), trains llama3.2-3b at full width and
    depth (relaxed and strict, 3 steps each), trains SMOKE_TRAINED at the
    smoke size on the card against the CPU, and times flash at head dim 128.
    Returns (serving launches by id and part, llama3.2-3b's training
    launches, the timings for the kernels line, the metrics)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa

    out = {"serve": {}, "smoke_train": {}}
    timing = flash_hd128_phase(torch, dev, err)
    serve_parts = {}
    for arch, layers in DECODERS:
        t = time.perf_counter()
        parts, gather_t, run, metrics = serve_phase(torch, np, dev, check_gather, arch,
                                                    fa, 0, layers=layers)
        if arch == DIST_JAMBA[0]:
            out["dist_served"] = run          # phase 24 holds its two ranks to it
        serve_parts[arch] = parts
        timing[f"gather_{arch}_prefill"] = gather_t["prefill"]
        timing[f"gather_{arch}_decode"] = gather_t["decode"]
        out["serve"][arch] = {**metrics, "wall_s": time.perf_counter() - t}
        torch.cuda.empty_cache()

    arch = "llama3.2-3b"
    L = get_arch(arch).model.num_layers
    # per step: L flash forwards and L more in the remat recompute, all on
    # the tensor-core route, one bf16 backward of BWD_PASSES launches a layer
    launches, step, batches = lm_train_runs(torch, dev, arch, {
        "flash_attention": 2 * L, "flash_attention_tc": 2 * L,
        "flash_attention_bwd": L * fa.BWD_PASSES[torch.bfloat16]})
    out["train"] = step
    timing.update(lm_sparse_timing(torch, dev, get_arch(arch).model, batches, check_bag,
                                   check_update, check_update_logged, check_gather,
                                   "llama_"))

    for arch in SMOKE_TRAINED:
        out["smoke_train"][arch] = smoke_train_checks(torch, np, dev, arch, "[decoders]")
    return serve_parts, launches, timing, out


def smoke_train_checks(torch, np, dev, arch, tag):
    """``arch`` at the smoke size, f32, TF32 off: 5 relaxed steps on the
    card and on the CPU (phase 12's 1e-5), a strict run and a second
    relaxed run on the card, bitwise the first (a combine summed in a
    racing order would show here). Returns the losses."""
    runs = smoke_train_card_vs_cpu(torch, dev, arch, "float32", 5,
                                   card_runs={"card_strict": False, "card_again": True})
    lc, lp = runs["card"][0], runs["cpu"][0]
    rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lp, strict=True))
    print(f"{tag} smoke {arch} f32: losses card {lc} cpu {lp} (largest "
          f"relative difference {rel:.3g}); card strict {runs['card_strict'][0]}, "
          f"card again {runs['card_again'][0]}")
    np.testing.assert_allclose(lc, lp, rtol=1e-5, atol=0)
    check(runs["card_strict"][0] == lc, f"smoke {arch}: relaxed != strict on the card")
    check(runs["card_again"][0] == lc
          and all(torch.equal(a, b) for a, b in zip(runs["card"][1], runs["card_again"][1],
                                                     strict=True))
          and torch.equal(runs["card"][2], runs["card_again"][2]),
          f"smoke {arch}: a second run on the card is not bitwise the first")
    return {"card": lc, "cpu": lp, "largest_relative": rel}


# Phase 23's ids, served at full width and depth and trained at full width;
# qwen2-vl-7b trains at QWEN2VL_TRAIN_LAYERS of its 28 layers: with bf16
# params and grads and f32 AdamW moments a layer holds about 2.8 GB, the
# head, the table and its f32 scratch about 10 GB, and the step's f32
# logits (4 x 1024 x 152064) and their gradient some 8 GB more
ENCDEC_VLM = ("whisper-base", "qwen2-vl-7b")
QWEN2VL_TRAIN_LAYERS = 16


def flash_encdec_phase(torch, dev, err):
    """Phase 23's flash shapes, bf16 (the tensor-core routes), each held
    against its plain version and repeated bitwise: the full (not causal)
    mask at whisper-base's shapes (8 heads of 64; its encoder's self-
    attention and its decoder's cross-attention over 1024 frames, and over
    1500, the 30 s encoder length, ragged against the key tiles, with 1 to
    1024 queries) and the causal one at qwen2-vl-7b's 28 q and 4 kv heads
    of 128; forwards, with their log-sum-exp at the training shapes, and
    backwards (the cross-attention's dk and dv flow into the encoder). The
    timed ones beside SDPA (``is_causal`` as the call, ``enable_gqa``) and
    their bound. Raises ``err``'s entries to the largest errors. Returns
    the timings for the kernels line."""
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    B = 4
    w, qv = get_arch("whisper-base").model, get_arch("qwen2-vl-7b").model
    WH, WD = w.num_heads, w.resolved_head_dim
    QH, QKV, QD = qv.num_heads, qv.num_kv_heads, qv.resolved_head_dim
    timings = {}

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def pairs(Sq, Sk, causal):
        # the (query, key) pairs the mask keeps (causal only where Sq == Sk)
        return Sq * (Sq + 1) / 2 if causal else Sq * Sk

    # the full mask at whisper's widths, ragged key and query counts: held only
    for Sq, Sk in ((1, 1500), (77, 1500), (448, 1500), (1024, 1500), (333, 1000),
                   (1024, 1024)):
        flash_hold(torch, err, rand(B, Sq, WH, WD), rand(B, Sk, WH, WD),
                   rand(B, Sk, WH, WD), f"full mask Sq={Sq} Sk={Sk} H={WH} D={WD}",
                   causal=False)
    print("[encdec] flash, full mask at whisper-base's widths: Sq 1, 77, 448, 1024 "
          "against Sk 1500; 333 against 1000; 1024 against 1024: ok")

    # forwards timed at the served paths' shapes; qwen2-vl's k and v the
    # first S entries of a (B, S + 32, Hkv, D) cache, as prefill reads them
    for name, Sq, Sk, Hq, Hkv, D, causal, cache, what in (
            ("flash_whisper-base", 1024, 1024, WH, WH, WD, False, 0,
             "encoder self-attention, and the cross-attention over 1024 frames"),
            ("flash_whisper-base_xattn1500", 1024, 1500, WH, WH, WD, False, 0,
             "cross-attention over a 30 s (1500-frame) encoder output"),
            ("flash_qwen2-vl-7b", 1024, 1024, QH, QKV, QD, True, 32,
             "prefill (k, v a prefix of the cache)")):
        q = rand(B, Sq, Hq, D)
        k, v = (rand(B, Sk + cache, Hkv, D)[:, :Sk] for _ in range(2))
        flash_hold(torch, err, q, k, v, name, causal=causal)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        nbytes = flash_fwd_bytes(B, Sq, Sk, Hq, Hkv, D)
        nops = 4 * D * B * Hq * pairs(Sq, Sk, causal)
        timings[name] = flash_timing(
            torch, "[encdec]", name,
            lambda q=q, k=k, v=v, c=causal: ops.flash_attention(q, k, v, causal=c),
            lambda q=q, k=k, v=v, c=causal: ref.flash_attention_ref(q, k, v, causal=c),
            lambda qt=qt, kt=kt, vt=vt, c=causal: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=c, enable_gqa=True),
            bound(nbytes, nops, BF16_TENSOR_OPS_PER_S),
            f"{what}: forward B={B} Sq={Sq} Sk={Sk} Hq={Hq} Hkv={Hkv} D={D} bf16 "
            f"{'causal' if causal else 'full'} ({nops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB)")
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()

    # the training shapes (q, k, v contiguous, as the step gives them): the
    # forward with its log-sum-exp (timed where a step runs it), the backward
    for arch, Sq, Sk, Hq, Hkv, D, causal, with_lse in (
            ("whisper-base", 1024, 1024, WH, WH, WD, False, True),
            ("whisper-base_xattn1500", 1024, 1500, WH, WH, WD, False, False),
            ("qwen2-vl-7b", 1024, 1024, QH, QKV, QD, True, True)):
        q, do = rand(B, Sq, Hq, D), rand(B, Sq, Hq, D)
        k, v = rand(B, Sk, Hkv, D), rand(B, Sk, Hkv, D)
        timings.update(flash_train_shape(torch, err, "[encdec]", arch, q, k, v, do, causal,
                                         pairs(Sq, Sk, causal), with_lse))
        del q, k, v, do
        torch.cuda.empty_cache()
    return timings


def tied_sparse_timing(torch, dev, cfg, batches, check_bag, check_update,
                       check_update_logged, check_gather, prefix):
    """A tied head's sparse tier at its training step's shapes: batch 0's
    tokens, their row gradients (bf16) combined and added into the head's
    dense (V, d) f32 gradient at their rows, the bf16 table updated at
    every row (plain in a strict step, logged in a relaxed one, the whole
    table its undo image), the correction gathered from the dense f32
    update, and the token lookup; each held against its plain version and
    timed beside one library call. Returns the timings, keyed ``prefix`` +
    shape."""
    from repro_torch.kernels import ops, ref

    V, d = cfg.vocab_size, cfg.d_model
    table = (torch.randn((V, d), device=dev) * 0.02).to(torch.bfloat16)
    ids = batches.next(0)["tokens"].reshape(-1).to(torch.int32).contiguous()
    N = ids.numel()
    g_rows = (torch.randn((N, d), device=dev) * 1e-3).to(torch.bfloat16)
    uniq, comb = ops.combine_duplicates(ids, g_rows)
    n_rows = int((uniq >= 0).sum())
    real = uniq[:n_rows].long()
    comb_real = comb[:n_rows]
    g_head = torch.randn((V, d), device=dev) * 1e-4
    every = torch.arange(V, dtype=torch.int32, device=dev)
    upd = -0.05 * g_head
    what = cfg.name
    check_update(g_head.clone(), uniq, comb, f"{what} rows' gradient into the head's (f32)")
    check_update(table.clone(), every, upd, f"{what} every row (bf16 table)")
    check_update_logged(table.clone(), every, upd, f"{what} every row (bf16 table)")
    check_gather(upd, ids, f"{what} correction from the dense update (f32)")
    check_gather(table, ids, f"{what} token lookup (training batch 0)")
    order = torch.sort(ids, stable=True)[1]
    sorted_ids = ids[order]
    firsts = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                        sorted_ids[1:] != sorted_ids[:-1]])
    comb_seg = torch.cumsum(firsts, 0, dtype=torch.int32) - 1
    comb_src = order.to(torch.int32)
    comb_starts = torch.nonzero(firsts).flatten().to(torch.int32)
    check_bag(g_rows, comb_src, comb_seg, N, f"{what} duplicate combine")
    g_t, t_tab = g_head.clone(), table.clone()
    shapes = {
        # as lm_sparse_timing's
        "bag_combine": (lambda: ops.embedding_bag(g_rows, comb_src, comb_seg, N),
                        lambda: ref.embedding_bag_ref(g_rows, comb_src, comb_seg, N),
                        lambda: torch.nn.functional.embedding_bag(
                            comb_src, g_rows, comb_starts, mode="sum"),
                        bound(N * 4 * 2 + N * d * 2 + N * d * 4, N * d)),
        # the ids, each touched row's f32 gradient, the f32 row read and
        # written
        "grad_add_f32": (lambda: ops.scatter_update(g_t, uniq, comb),
                         lambda: ref.scatter_update_ref(g_t, uniq, comb),
                         lambda: g_t.index_add_(0, real, comb_real),
                         bound(N * 4 + n_rows * d * 12, n_rows * d)),
        # every row: its id, its f32 delta, the bf16 row read and written;
        # add_ of the f32 update into the bf16 table rounds the same f32 sum
        "update_every_bf16": (lambda: ops.scatter_update(t_tab, every, upd),
                              lambda: ref.scatter_update_ref(t_tab, every, upd),
                              lambda: t_tab.add_(upd),
                              bound(V * 4 + V * d * (4 + 2 * 2), V * d)),
        # and each row's old value logged
        "update_logged_every_bf16": (
            lambda: ops.scatter_update_logged(t_tab, every, upd),
            lambda: ref.scatter_update_logged_ref(t_tab, every, upd),
            lambda: (t_tab.clone(), t_tab.add_(upd)),
            bound(V * (4 + d * (4 + 3 * 2)), V * d)),
        # the ids once, each distinct row read once, each output row written
        # once; no operations
        "gather_corr_f32": (lambda: ops.gather_rows(upd, ids),
                            lambda: ref.gather_rows_ref(upd, ids),
                            lambda: torch.index_select(upd, 0, ids),
                            bound(N * 4 + (n_rows + N) * d * 4, 0)),
        "gather_tokens": (lambda: ops.gather_rows(table, ids),
                          lambda: ref.gather_rows_ref(table, ids),
                          lambda: torch.index_select(table, 0, ids),
                          bound(N * 4 + (n_rows + N) * d * 2, 0)),
    }
    print(f"[{cfg.name}-train] the tied head's sparse tier: {N} ids, {n_rows} distinct, "
          f"{V} rows updated")
    timing = time_shapes(torch, f"[{cfg.name}-train]",
                         {prefix + name: v for name, v in shapes.items()})
    del table, t_tab, g_head, g_t, g_rows, comb, upd, every
    torch.cuda.empty_cache()
    return timing


def encdec_vlm_phase(torch, np, dev, err, check_bag, check_update, check_update_logged,
                     check_gather):
    """Phase 23: the last two families. Times flash at their shapes
    (``flash_encdec_phase``), serves whisper-base and qwen2-vl-7b at full
    width and depth (bf16, seed 0, batch 4, a 1024-token prompt with its
    batch's frames or vision embeds, 32 new tokens; one model on the card at
    a time), trains whisper-base at full width and depth and qwen2-vl-7b at
    full width and QWEN2VL_TRAIN_LAYERS layers (relaxed and strict, 3 steps
    each), then both at the smoke size on the card against the CPU.
    Returns (serving launches by id and part, training launches by id, the
    timings for the kernels line, the metrics)."""
    import gc

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    start_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    out = {"start_allocated_gb": start_gb, "serve": {}, "train": {}, "smoke_train": {}}
    print(f"[encdec] device memory allocated at the phase's start: {start_gb:.3f} GB")
    t = time.perf_counter()
    timing = flash_encdec_phase(torch, dev, err)
    out["flash_wall_s"] = time.perf_counter() - t
    peaks = [torch.cuda.max_memory_allocated() / 1e9]
    serve_parts = {}
    for arch in ENCDEC_VLM:
        t = time.perf_counter()
        parts, gather_t, _, metrics = serve_phase(torch, np, dev, check_gather, arch, fa, 0)
        serve_parts[arch] = parts
        timing[f"gather_{arch}_prefill"] = gather_t["prefill"]
        timing[f"gather_{arch}_decode"] = gather_t["decode"]
        out["serve"][arch] = {**metrics, "wall_s": time.perf_counter() - t}
        peaks.append(metrics["peak_device_gb"])
        torch.cuda.empty_cache()

    train = {}
    bwd = fa.BWD_PASSES[torch.bfloat16]
    w = get_arch("whisper-base").model
    # per step: the encoder's self-attention, the decoder's and its
    # cross-attention, each once and again in the remat recompute, all on
    # the tensor-core route, and one bf16 backward of ``bwd`` launches each
    n = w.encoder_layers + 2 * w.num_layers
    t = time.perf_counter()
    train["whisper-base"], step, batches = lm_train_runs(torch, dev, "whisper-base", {
        "flash_attention": 2 * n, "flash_attention_tc": 2 * n,
        "flash_attention_bwd": n * bwd})
    timing.update(tied_sparse_timing(torch, dev, w, batches, check_bag, check_update,
                                     check_update_logged, check_gather, "whisper_"))
    out["train"]["whisper-base"] = {**step, "wall_s": time.perf_counter() - t}
    L = QWEN2VL_TRAIN_LAYERS
    t = time.perf_counter()
    train["qwen2-vl-7b"], step, batches = lm_train_runs(torch, dev, "qwen2-vl-7b", {
        "flash_attention": 2 * L, "flash_attention_tc": 2 * L,
        "flash_attention_bwd": L * bwd}, layers=L)
    timing.update(lm_sparse_timing(torch, dev, get_arch("qwen2-vl-7b").model, batches,
                                   check_bag, check_update, check_update_logged,
                                   check_gather, "qwen2vl_"))
    out["train"]["qwen2-vl-7b"] = {**step, "wall_s": time.perf_counter() - t}
    peaks += [s["peak_device_gb"] for s in out["train"].values()]
    for arch in ENCDEC_VLM:
        out["smoke_train"][arch] = smoke_train_checks(torch, np, dev, arch, "[encdec]")
    out["peak_device_gb"] = max(peaks)
    print(f"[encdec] phase 23's peak device memory {out['peak_device_gb']:.2f} GB "
          f"(flash, serving whisper-base and qwen2-vl-7b, training them: "
          f"{[round(p, 2) for p in peaks]}); qwen2-vl-7b trained at {L} of 28 layers")
    return serve_parts, train, timing, out


def adamw_inplace_check(torch, dev):
    """One smoke tinyllama step's dense update (bf16 params, the grads of
    its loss on a batch, clipped) twice over on the card: the functional
    AdamW and the in-place one the trainer runs, from the same state; the
    params, moments and norm must be bitwise equal after each of two
    steps."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.synthetic import make_batches
    from repro_torch.models.registry import get_api
    from repro_torch.optim import optimizers as opt
    from repro_torch.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(get_arch("tinyllama-1.1b", smoke=True).model,
                              dtype="bfloat16")
    tc = TrainConfig()
    api = get_api(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = api.init(gen, cfg)
    dense = {k: v for k, v in params.items() if k != "embed"}
    leaves = [p.detach().requires_grad_() for p in tree_leaves(dense)]
    it = iter(leaves)
    loss = api.loss({**tree_map(lambda _: next(it), dense), "embed": params["embed"]},
                    cfg, make_batches(cfg, 4, 16, device=dev).next(0))
    it = iter(torch.autograd.grad(loss, leaves))
    grads = tree_map(lambda _: next(it), dense)
    adam = opt.make_optimizer("adamw", tc.learning_rate, tc)
    p_fun, p_in = tree_map(torch.clone, dense), tree_map(torch.clone, dense)
    s_fun, s_in = adam.init(p_fun), adam.init(p_in)
    for _ in range(2):
        g_fun, norm_fun = opt.global_norm_clip(grads, tc.grad_clip)
        upd, s_fun = adam.update(g_fun, s_fun, p_fun)
        p_fun = tree_map(lambda p, u: (p.float() + u).to(p.dtype), p_fun, upd)
        g_in = tree_map(torch.clone, grads)
        norm_in = opt.global_norm_clip_(g_in, tc.grad_clip)
        s_in = adam.update_inplace(g_in, s_in, p_in)
        torch.cuda.synchronize()
        check(torch.equal(norm_fun, norm_in), "in-place clip: norm differs")
        check(all(torch.equal(a, b) for a, b in zip(
            tree_leaves((p_fun, s_fun)), tree_leaves((p_in, s_in)), strict=True)),
            "in-place AdamW differs from the functional one")
    print(f"[lm-train] in-place AdamW and clip on the card: 2 steps of smoke "
          f"tinyllama (bf16, {len(leaves)} dense leaves) bitwise equal to the "
          "functional ones")


def lm_train_phase(torch, np, dev, check_bag, check_update, check_update_logged,
                   check_gather):
    """Phase 12: full-width tinyllama-1.1b training. Returns (the launch
    counts of the relaxed run, with the strict run's updates as
    "scatter_update_strict", the step metrics, the sparse kernels'
    timings at the step's shapes)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa

    L = get_arch("tinyllama-1.1b").model.num_layers
    # per step: 22 flash forwards and 22 more in the remat recompute, all on
    # the tensor-core route, one bf16 backward of BWD_PASSES launches per layer
    launches, step, batches = lm_train_runs(torch, dev, "tinyllama-1.1b", {
        "flash_attention": 2 * L, "flash_attention_tc": 2 * L,
        "flash_attention_bwd": L * fa.BWD_PASSES[torch.bfloat16]})
    print(f"[lm-train] tinyllama peak device memory {step['peak_device_gb']:.2f} GB "
          "(PR 15, the functional AdamW: 41.25 GB)")
    check(step["peak_device_gb"] < 41.25, "tinyllama: the peak did not fall below "
          f"the functional AdamW's 41.25 GB: {step['peak_device_gb']:.2f} GB")
    adamw_inplace_check(torch, dev)
    timing = lm_sparse_timing(torch, dev, get_arch("tinyllama-1.1b").model, batches,
                              check_bag, check_update, check_update_logged,
                              check_gather, "lm_")

    # smoke tinyllama on the card and on the CPU from the same params: 5
    # relaxed steps in f32 (TF32 off; the f32 backward route), then one step
    # in bf16 (the tensor-core route) and the loss after it
    scfg = get_arch("tinyllama-1.1b", smoke=True).model

    def fa_counts():
        return {"bwd": fa.bwd_launches, "f32": fa.launches - fa.tc_launches}
    smoke = smoke_train_card_vs_cpu(torch, dev, "tinyllama-1.1b", "float32", 5, fa_counts)
    launches["flash_attention_bwd_f32"] = smoke["card_counts"]["bwd"]
    launches["flash_attention_f32"] = smoke["card_counts"]["f32"]
    (lc, dc, tc_), (lp, dp, tp) = smoke["card"], smoke["cpu"]
    dense_diff = max((a - b).abs().max().item() for a, b in zip(dc, dp, strict=True))
    print(f"[lm-train] smoke f32 losses card {lc} cpu {lp}; dense params max abs "
          f"difference {dense_diff:.3g}; table {(tc_ - tp).abs().max().item():.3g}")
    np.testing.assert_allclose(lc, lp, rtol=1e-5, atol=0)
    # AdamW's first steps, near sign(g), could amplify float-order noise in
    # the tiniest gradients; the dense params agree within 1e-5 all the same
    torch.testing.assert_close(dc, dp, rtol=1e-5, atol=1e-5)
    check(launches["flash_attention_bwd_f32"]
          == 5 * scfg.num_layers * fa.BWD_PASSES[torch.float32],
          f"smoke f32 backward launches {launches['flash_attention_bwd_f32']}")
    # the f32 forward route: one forward a layer and step (no remat at the
    # smoke size), two with it
    check(launches["flash_attention_f32"]
          == 5 * scfg.num_layers * (2 if scfg.remat else 1),
          f"smoke f32 forward launches {launches['flash_attention_f32']}")
    # bf16: the first loss is the forward alone, the second follows one step
    # (the backward on the card's tensor-core route, on the CPU in f32).
    # bf16 keeps 8 bits (unit roundoff 2^-9); the losses, f32 means over bf16
    # logits, agree within two such roundings, 2^-8 relative. The params are
    # printed, not held: an element near 0 moves by lr times a gradient that
    # the two routes round at different places.
    smoke = smoke_train_card_vs_cpu(torch, dev, "tinyllama-1.1b", "bfloat16", 2)
    (lc, dc, tc_), (lp, dp, tp) = smoke["card"], smoke["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lp, strict=True))
    dense_diff = max((a - b).abs().max().item() for a, b in zip(dc, dp, strict=True))
    print(f"[lm-train] smoke bf16 step: losses card {lc} cpu {lp} (largest relative "
          f"difference {rel:.3g}, limit {2**-8:.3g}); table max abs difference "
          f"{(tc_ - tp).abs().max().item():.3g}; dense params {dense_diff:.3g}")
    check(rel <= 2**-8, f"smoke bf16 step: losses differ by {rel:.3g} relative")
    return launches, step, timing


def rwkv_train_phase(torch, np, dev, check_bag, check_update, check_update_logged,
                     check_gather):
    """Phase 16: full-width rwkv6-3b training. Returns (the launch counts of
    the relaxed run, with the strict run's updates as
    "scatter_update_strict", the step metrics, the sparse kernels' timings
    at the step's shapes)."""
    import functools

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv6 as wk

    cfg = get_arch("rwkv6-3b").model
    L = cfg.num_layers
    # per step: 32 wkv6 forwards (chunked route) and 32 more in the remat
    # recompute, and one backward a layer
    launches, step, batches = lm_train_runs(torch, dev, "rwkv6-3b", {
        "wkv6": 2 * L, "wkv6_bwd": L})
    print(f"[rwkv6-3b-train] peak device memory {step['peak_device_gb']:.2f} GB")
    timing = lm_sparse_timing(torch, dev, cfg, batches, check_bag, check_update,
                              check_update_logged, check_gather, "rwkv_")
    # smoke rwkv6 on the card and on the CPU from the same params: 5 relaxed
    # steps in f32 (TF32 off for the matmuls). The card's wkv6 forward takes
    # its products in TF32 split hi + lo (within 3e-4 of f32, phase 9), its
    # backward in f32. AdamW divides each moment by its own magnitude, so
    # where a gradient is near 0 a relative difference of 1e-2 in it moves
    # the param by about lr x 1e-2 = 1e-5. The card is compared with a plain
    # f32 CPU run and with one whose forward emulates the split
    # (ref.wkv6_ref(..., tf32="split")). The losses are held at phase 12's
    # 1e-5 against both, and so are the dense params, all but at most one
    # element in 10^4, which must still lie within 1e-4.
    @contextlib.contextmanager
    def split_forward():
        plain = ref.wkv6_ref
        ref.wkv6_ref = functools.partial(plain, tf32="split")
        try:
            yield
        finally:
            ref.wkv6_ref = plain
    smoke = smoke_train_card_vs_cpu(
        torch, dev, "rwkv6-3b", "float32", 5,
        lambda: {"wkv6": wk.launches, "wkv6_bwd": wk.bwd_launches},
        {"cpu": contextlib.nullcontext, "cpu_split": split_forward})
    scfg = get_arch("rwkv6-3b", smoke=True).model
    check(smoke["card_counts"] == {"wkv6": 5 * scfg.num_layers * (2 if scfg.remat else 1),
                                   "wkv6_bwd": 5 * scfg.num_layers},
          f"smoke rwkv6 launches {smoke['card_counts']}")
    lc, dc, tc_ = smoke["card"]
    card = torch.cat([p.flatten() for p in dc])
    for name in ("cpu", "cpu_split"):
        lp, dp, tp = smoke[name]
        cpu = torch.cat([p.flatten() for p in dp])
        outside = int((~torch.isclose(card, cpu, rtol=1e-5, atol=1e-5)).sum())
        print(f"[rwkv6-3b-train] smoke f32 losses card {lc} {name} {lp}; dense params "
              f"max abs difference {(card - cpu).abs().max().item():.3g}, {outside} of "
              f"{card.numel()} elements beyond 1e-5; table "
              f"{(tc_ - tp).abs().max().item():.3g}")
        # phase 12's tolerance for tinyllama
        np.testing.assert_allclose(lc, lp, rtol=1e-5, atol=0)
        check(outside <= card.numel() // 10_000, f"smoke rwkv6 vs {name}: {outside} "
              f"dense elements beyond 1e-5, at most {card.numel() // 10_000} allowed")
        torch.testing.assert_close(card, cpu, rtol=1e-5, atol=1e-4)
    return launches, step, timing


def lm_checkpoint_phase(torch, np, dev):
    """Phase 13: checkpointed tinyllama-1.1b training on a pmem pool, in a
    temporary directory under build/. Returns the full-width run's launch
    counts."""
    import contextlib
    import dataclasses
    import gc
    import shutil
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import CheckpointConfig, TrainConfig
    from repro_torch.core.checkpoint import recovery
    from repro_torch.core.checkpoint.manager import (CheckpointManager,
                                                     check_undo_images, undo_image)
    from repro_torch.data.lookahead import LookaheadIterator
    from repro_torch.data.synthetic import make_batches
    from repro_torch.kernels import gather_rows as gr
    from repro_torch.kernels import scatter_update as su
    from repro_torch.models.registry import get_api
    from repro_torch.pool import FaultSchedule, InjectedCrash
    from repro_torch.training import train_loop

    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="lm-ckpt-smoke-", dir=build)
    try:
        def setup(name, arch, smoke, dense_interval):
            cfg = get_arch(arch, smoke=smoke).model
            cc = CheckpointConfig(directory=os.path.join(work, name),
                                  dense_interval=dense_interval, pool_backend="pmem")
            tc = TrainConfig(embed_learning_rate=0.05, checkpoint=cc)

            def fresh():
                g = torch.Generator(device=dev)
                g.manual_seed(tc.seed)
                return train_loop.make_step_fns(cfg, tc)[0](get_api(cfg).init(g, cfg))
            return cfg, tc, cc, fresh

        # full width, tier-E only: 4 relaxed steps, then the recovered mirror
        # against the table
        cfg, tc, cc, fresh = setup("full", "tinyllama-1.1b", False, 0)
        batches = LookaheadIterator(make_batches(cfg, 4, 1024, device=dev), cfg, depth=6)
        state = fresh()
        t = time.perf_counter()
        mgr = CheckpointManager(cfg, cc, embed_init=state["embed"])
        load_s = time.perf_counter() - t
        stamps, images, skip = [time.perf_counter()], {}, [0.0]

        def on_metrics(n, m):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter() - skip[0])
            t = time.perf_counter()        # the undo image to the host
            images[n] = undo_image(m["ckpt_feed"])
            skip[0] += time.perf_counter() - t
        gr.launches = su.launches_logged = su.wide_launches_logged = 0
        _, losses = train_loop.train(cfg, tc, batches, 4, relaxed=True, state=state,
                                     ckpt_manager=mgr, on_metrics=on_metrics)
        gathers = gr.launches
        check(su.launches_logged == 4 and su.wide_launches_logged == 4,
              f"lm full run: {su.launches_logged} logged updates, "
              f"{su.wide_launches_logged} on the 16-byte route, want 4 and 4")
        step_ms = [1e3 * (b - a) for a, b in zip(stamps[:-1], stamps[1:], strict=True)]
        checked = check_undo_images(mgr.ring, images)   # train flushed the writer
        check(checked == 4, f"lm full run: {checked} undo entries checked, want 4")
        print(f"[lm-ckpt] the undo images of all {checked} steps "
              f"({images[0][0].size} to {max(v[0].size for v in images.values())} "
              "rows), captured on the card by the logged update, equal the pool's "
              "bitwise")
        del images
        t = time.perf_counter()
        mgr.close()
        close_s = time.perf_counter() - t
        final = state["embed"]["table"].to("cpu", torch.float32).numpy()
        print(f"[lm-ckpt] full tinyllama, dense_interval=0: mirror load {load_s:.2f}s; "
              f"losses {losses}; step ms with on_step {step_ms}; close (flush) "
              f"{close_s:.2f}s; stats {json.dumps(mgr.stats)}; gather launches {gathers}")
        # warm-up lookup, then per step: stale lookup, correction, on_step's
        # touched rows
        check(gathers == 1 + 4 * 3, f"lm checkpoint run: {gathers} gathers, want 13")
        del mgr, state
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        rec = recovery.recover(cc.directory)
        print(f"[lm-ckpt] recover {time.perf_counter() - t:.2f}s: mirror@{rec.mirror_step} "
              f"dense@{rec.dense_step}, table {rec.table_name} {rec.table_shape}")
        check(rec.mirror_step == 3 and rec.dense_step == -1 and not rec.rolled_back
              and rec.table_name == "table", "lm full run: unexpected recovery")
        check(np.array_equal(rec.embed_rows, final),
              "lm full run: recovered mirror differs from the table")
        rec.pool.close()
        del rec, final, batches
        shutil.rmtree(cc.directory)

        # smoke size, dense_interval=1: crash between the undo COMMIT and
        # the mirror apply of step 2, recovery of the step-1 mirror, resume
        cfg, tc, cc, fresh = setup("crash", "tinyllama-1.1b", True, 1)
        data = make_batches(cfg, 4, 16, device=dev)
        _, full = train_loop.train(cfg, tc, data, 5, relaxed=True, state=fresh())
        ref_cc = dataclasses.replace(cc, directory=os.path.join(work, "ref"))
        state = fresh()
        mgr = CheckpointManager(cfg, ref_cc, embed_init=state["embed"])
        train_loop.train(cfg, tc, data, 2, relaxed=True, state=state, ckpt_manager=mgr)
        ref_rows = np.array(mgr.mirror_rows)
        mgr.close()
        state = fresh()
        mgr = CheckpointManager(cfg, cc, embed_init=state["embed"],
                                faults=FaultSchedule.crash_at(
                                    "tier_e.between-commit-and-apply", occurrence=3))
        crashed = False
        try:
            train_loop.train(cfg, tc, data, 5, relaxed=True, state=state, ckpt_manager=mgr)
        except InjectedCrash:
            crashed = True
        check(crashed, "lm smoke run: no InjectedCrash")
        with contextlib.suppress(InjectedCrash):
            mgr.close()                   # process death: the pool file stays
        rec = recovery.recover(cc.directory)
        check(rec.mirror_step == 1 and rec.dense_step == 1 and rec.rolled_back,
              f"lm smoke run: recovered mirror@{rec.mirror_step} "
              f"dense@{rec.dense_step} rolled_back={rec.rolled_back}")
        check(np.array_equal(rec.embed_rows, ref_rows),
              "lm smoke run: recovered mirror differs from a clean run's after step 1")
        resumed, start = recovery.resume_train_state(rec, fresh())
        mgr = CheckpointManager(cfg, cc, pool=rec.pool)
        mgr.init_mirror(resumed["embed"], step=rec.mirror_step)
        _, tail = train_loop.train(cfg, tc, data, 3, relaxed=True, state=resumed,
                                   start_step=start, ckpt_manager=mgr)
        mgr.close()
        print(f"[lm-ckpt] smoke crash at step 2: recovered mirror@{rec.mirror_step} "
              f"(rolled back), resumed at {start}: losses {tail}, uninterrupted "
              f"{full[start:]}")
        check(start == 2 and tail == full[start:],
              "lm smoke run: resumed losses differ from the uninterrupted run's")
        print("[lm-ckpt] full-width mirror, crash, bitwise recovery and resume: ok")
        return {"gather_rows": gathers}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def examples_phase():
    """Phase 14: the port's examples on the card, each in a process of its
    own as a user runs it, all started at once; their pool files go to a
    temporary directory under build/. Returns each one's wall time in s."""
    import shutil
    import tempfile

    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="examples-smoke-", dir=build)
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    runs = (("fault_tolerance_demo (remote, its default)", "fault_tolerance_demo",
             ["--work-dir", work], "fault-tolerance demo PASSED"),
            ("shared_pool_demo", "shared_pool_demo", ["--work-dir", work],
             "shared-pool demo PASSED"),
            ("fault_tolerance_demo pmem", "fault_tolerance_demo",
             ["--pool-backend", "pmem", "--work-dir", work], "fault-tolerance demo PASSED"),
            ("fault_tolerance_demo dram", "fault_tolerance_demo",
             ["--pool-backend", "dram", "--work-dir", work], "fault-tolerance demo PASSED"),
            ("fault_tolerance_demo sharded", "fault_tolerance_demo",
             ["--pool-backend", "sharded", "--work-dir", work],
             "fault-tolerance demo PASSED"),
            ("serve_batched sharded", "serve_batched", ["--pool-backend", "sharded"],
             "pool-serving drill PASSED"),
            ("train_dlrm_e2e", "train_dlrm_e2e", ["--steps", "20", "--work-dir", work],
             "== done: 20 steps"),
            ("quickstart", "quickstart", [], "strict == relaxed: True"),
            ("serve_batched tinyllama-1.1b", "serve_batched",
             ["--arch", "tinyllama-1.1b"], "[decode] 8x32 tokens"),
            ("serve_batched rwkv6-3b", "serve_batched", ["--arch", "rwkv6-3b"],
             "[decode] 8x32 tokens"),
            # the seeded soak, under the checker as its nightly run is
            ("pool_soak (REPRO_POOL_CHECK=1)", "pool_soak",
             ["--backends", "pmem,remote,sharded", "--seeds", "3", "--migrations", "1",
              "--serve", "1", "--node-loss", "1",
              "--out", os.path.join(work, "soak_metrics.json")],
             "soak: 12 ok, 0 failed"))
    checked = {**env, "REPRO_POOL_CHECK": "1"}
    procs, wall = {}, {}
    t0 = time.perf_counter()
    try:
        for i, (label, name, args, _) in enumerate(runs):
            # output to a file: a full pipe would stall a process not yet read
            # (a process group of its own: the kill below reaches the demo's trainer)
            with open(os.path.join(work, f"{i}.log"), "w") as log:
                procs[label] = subprocess.Popen(
                    [sys.executable, "-m", f"repro_torch.examples.{name}", *args],
                    env=checked if name == "pool_soak" else env, cwd=ROOT, stdout=log,
                    stderr=subprocess.STDOUT, text=True, start_new_session=True)
        while len(wall) < len(procs):
            check(time.perf_counter() - t0 < 300, "examples: not all exited within "
                  f"300 s: {sorted(set(procs) - set(wall))}")
            for label, proc in procs.items():
                if label not in wall and proc.poll() is not None:
                    wall[label] = time.perf_counter() - t0
            time.sleep(0.1)
        for i, (label, name, _, marker) in enumerate(runs):
            rc = procs[label].returncode
            with open(os.path.join(work, f"{i}.log")) as log:
                out = log.read()
            lines = [ln for ln in out.splitlines()
                     if ln.startswith(("==", "[prefill]", "[decode]", "strict", "loss:",
                                       "fault-tolerance", "shared-pool", "-- tenant",
                                       "[pool-serve]", "pool-serving", "soak"))]
            print(f"[examples] {label}: exit {rc}, done at {wall[label]:.1f}s; "
                  + " | ".join(lines[-13:] if name == "pool_soak" else lines[-4:]))
            check(rc == 0 and marker in out,
                  f"example {label}: exit {rc}, no {marker!r}:\n{out[-6000:]}")
    finally:
        for proc in procs.values():      # none outlives the phase
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    return wall


def pool_serve_phase(torch, np, dev, arch, mixer, per_step, served):
    """Phase 17 (a): serve full ``arch`` as phases 8 and 10 do, with every
    token lookup read from a pmem pool mirror of the table (f32, in
    ``embedding-mirror/rows``) through the hot-row serving tier
    (``pool_serving``; the tier's default cache of 4096 rows). Tokens and
    logits must equal ``served``, the device-gather run of phase 8 or 10,
    bitwise: the bf16 rows round-trip through f32 exactly. The sequence
    mixer's launches are counted per part as there, and the row gather's
    must not move. Each route is timed in turns (gather, pool, pool,
    gather). Returns the pool run's launch counts for each part and the
    phase's numbers."""
    import shutil
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import make_batches
    from repro_torch.kernels import gather_rows as gr
    from repro_torch.launch.serve import build_tier
    from repro_torch.models.registry import get_api
    from repro_torch.training.serve_loop import greedy_generate, pool_serving

    cfg = get_arch(arch).model
    B, S, new = 4, 1024, 32
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)            # phases 8 and 10's params and prompt
    params = get_api(cfg).init(gen, cfg)
    prompt = make_batches(cfg, B, S, device=dev).next(0)["tokens"]
    table = params["embed"]["table"]
    V, d = table.shape
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="pool-serve-", dir=build)
    try:
        t = time.perf_counter()
        tier = build_tier(table, "pmem", pool_dir=work)
        print(f"[pool-serve] {arch}: f32 mirror {V * d * 4 / 1e6:.1f} MB ({V} x {d}) "
              f"in a pmem pool image of "
              f"{os.path.getsize(os.path.join(work, 'pool.img'))} bytes, written and "
              f"fsynced in {time.perf_counter() - t:.2f}s; hot-row cache "
              f"{tier.cache.capacity} rows")

        def generate(pool, stats=None, part=None, n=new):
            with pool_serving(tier) if pool else contextlib.nullcontext():
                return greedy_generate(cfg, params, prompt, n, max_seq=S + new,
                                       stats=stats, part=part)

        def read():
            # the launches and the pool's link bytes
            return {**serve_counts(mixer, gr),
                    "link_bytes": tier.pool.metrics.link_bytes()}
        cold, parts = {}, {}
        generate(True, n=2, part=part_counter(cold, read))   # warm-up, cold cache
        serve_counts(mixer, gr, zero=True)
        stats = {}
        toks = generate(True, stats, part=part_counter(parts, read))
        link = {k: v.pop("link_bytes") for k, v in parts.items()}
        want = serve_want(mixer, cfg, per_step, new, gathers=0)
        print(f"[pool-serve] {arch} pool route launches by part {parts}; pool link "
              f"bytes by part {link}")
        check(parts == want, f"pool serve {arch}: want {want} launches by part "
              f"(the sequence mixer as on the gather route, no row gather), got "
              f"{parts}")
        want_toks, want_logits = served
        check(torch.equal(toks.cpu(), want_toks)
              and torch.equal(stats["logits"].cpu(), want_logits),
              f"pool serve {arch}: tokens or logits differ from the device-gather "
              "run's (phases 8, 10) by at least one bit")
        del stats

        # each route in turns; every run's tokens and logits bitwise served's
        times = {"gather": [], "pool": []}
        for route in ("gather", "pool", "pool", "gather"):
            st = {}
            tk = generate(route == "pool", st)
            check(torch.equal(tk.cpu(), want_toks)
                  and torch.equal(st["logits"].cpu(), want_logits),
                  f"pool serve {arch}: the {route} route's timed run differs from "
                  "phases 8, 10")
            times[route].append((1e3 * st["prefill_s"],
                                 1e3 * st["decode_s"] / (new - 1)))
        s = tier.stats()
        # what each lookup pays while the pool has no undo ring: the look-up
        # of the ring's meta, against the readonly attach that fails, which
        # every lookup used to retry
        from repro_torch.pool import PoolError
        from repro_torch.serve import CommitTailer

        def failed_attach():
            try:
                CommitTailer.attach(tier.pool, tier.cache)
            except PoolError:
                return
            raise AssertionError("the LM pool holds no undo ring")

        def median_ms(fn, n=200):
            ts = []
            for _ in range(n):
                t = time.perf_counter()
                fn()
                ts.append(time.perf_counter() - t)
            return 1e3 * statistics.median(ts)
        check(tier.tailer is None and not tier._attach_tailer(),
              f"pool serve {arch}: a tailer attached to a pool with no undo ring")
        out = {
            "attach_check_ms": median_ms(tier._attach_tailer),
            "failed_attach_ms": median_ms(failed_attach),
            "prefill_ms": {r: [round(p, 3) for p, _ in v] for r, v in times.items()},
            "decode_ms_per_token": {r: [round(q, 3) for _, q in v]
                                    for r, v in times.items()},
            "tier_lookups": s["requests"], "tier_rows": s["rows"],
            "hit_rate": s["hit_rate"], "lookup_p50_ms": s["p50_ms"],
            "lookup_p99_ms": s["p99_ms"],
            "link_bytes_cold_prefill": cold["prefill"]["link_bytes"],
            "link_bytes_prefill": link["prefill"],
            "link_bytes_decode_step": link["decode"] / (new - 1),
            "host_to_card_bytes_prefill": B * S * d * 4}
        print(f"[pool-serve] {arch}, batch {B}, prompt {S}, {new} new tokens, "
              f"routes in turns (gather, pool, pool, gather): {json.dumps(out)}")
        print(f"[pool-serve] {arch}: tokens and logits of every pool-served run "
              f"bitwise equal to the device-gather run's")
        print(tier.pool.metrics.report())
        tier.pool.close()
        del params, tier
        torch.cuda.empty_cache()
        return parts, out
    finally:
        shutil.rmtree(work, ignore_errors=True)


# click probabilities of full rm1 through the pool route against the bag
# kernel's route. The limit is the gap measured on an H100 80GB HBM3: 0.
# numpy sums a bag's 80 rows in item order, in f32, as the kernel sums a bag
# of at most 80 items, so the bags, and all that follows them, agree bit
# for bit
DLRM_POOL_PROB_TOL = 0.0


def dlrm_pool_serve_phase(torch, np, cfg, tc, Bsz, dev, fresh_state):
    """Phase 17 (b): full dlrm-rm1 trains into a pmem pool (2 relaxed
    steps, tier-E only) while the serving tier serves rows from the same
    mirror, kept coherent by the manager's commit hook. Serving traffic is
    requests of one sample each (its T x L zipf ids, as training draws
    them), two a batch, before the first step and after each commit: the
    cache then holds hot rows that the next step touches. After each
    ``flush()`` a check batch holds the step's touched rows and 4096 it
    did not touch; every row served must equal the card's tables (as f32)
    bitwise, and the invalidations must equal exactly the touched rows
    that were cached. Then one rm1 forward with ``lookup_mode("pool")`` over an
    ``EmbeddingPoolMirror`` of the stacked tables (a dram pool): its f32
    bags within the bag's 1e-5 of the bag kernel's, its click
    probabilities within DLRM_POOL_PROB_TOL of the kernel route's. Returns
    the phase's numbers."""
    import gc
    import shutil
    import tempfile

    from repro_torch.core import embedding_ops
    from repro_torch.core.checkpoint.manager import CheckpointManager, touched_rows
    from repro_torch.data.lookahead import LookaheadIterator
    from repro_torch.data.synthetic import DLRMBatches
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ops
    from repro_torch.models import dlrm
    from repro_torch.pool import DramPool, EmbeddingPoolMirror
    from repro_torch.pool.allocator import DATA_START
    from repro_torch.serve import EmbeddingServeTier, make_commit_hook
    from repro_torch.training import state as st
    from repro_torch.training import train_loop

    T, R, d = cfg.dlrm_num_tables, cfg.dlrm_rows_per_table, cfg.dlrm_bottom_mlp[-1]
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="pool-dlrm-", dir=build)
    out = {}
    try:
        cc = dataclasses.replace(tc.checkpoint, directory=work, dense_interval=0,
                                 pool_backend="pmem")
        tcp = dataclasses.replace(tc, checkpoint=cc)
        state = fresh_state()
        t = time.perf_counter()
        mgr = CheckpointManager(cfg, cc, embed_init=state["embed"])
        tier = EmbeddingServeTier(mgr.pool)
        check(tier.tailer is not None, "pool dlrm: the tier found no undo ring")
        mgr.add_commit_hook(make_commit_hook(tier.cache, tier.tailer))
        print(f"[pool-dlrm] manager + mirror load ({T * R * d * 4 / 1e9:.2f} GB f32, "
              f"pmem) and tier: {time.perf_counter() - t:.2f}s; cache "
              f"{tier.cache.capacity} rows")
        rng = np.random.default_rng(1)
        flat_tab = state["embed"]["emb_tables"].view(-1, d)
        offs = (np.arange(T) * R)[None, :, None]
        requests = DLRMBatches(cfg, 2, seed=1, device=dev)
        log, request_ms = [], []

        def check_rows(ids, got, what):
            want = flat_tab[torch.from_numpy(ids).to(dev)].float().cpu().numpy()
            check(got.tobytes() == want.tobytes(),
                  f"pool dlrm {what}: served rows differ from the card's tables")

        def serve_requests(n):
            # two requests of one sample each: its bags' flat row ids
            ids = requests.next(n)["sparse"].cpu().numpy().astype(np.int64) + offs
            t = time.perf_counter()
            rows = tier.serve_batch([ids[0], ids[1]])
            request_ms.append(1e3 * (time.perf_counter() - t))
            for i, got in zip(ids, rows, strict=True):
                check_rows(i.reshape(-1), got.reshape(-1, d), f"requests {n}")
        serve_requests(0)
        real_on_step = mgr.on_step

        def on_step(step, stt, feed):
            _, idx = touched_rows(feed)
            cached = sum(1 for i in idx.tolist() if i in tier.cache)
            before = tier.metrics.cache_invalidations
            real_on_step(step, stt, feed)
            t = time.perf_counter()
            mgr.flush()
            flush_ms = 1e3 * (time.perf_counter() - t)
            inval = tier.metrics.cache_invalidations - before
            other = np.setdiff1d(rng.integers(0, T * R, 4096), idx)
            t = time.perf_counter()
            rows = tier.serve_batch([idx, other])
            serve_ms = 1e3 * (time.perf_counter() - t)
            for ids, got in zip((idx, other), rows, strict=True):
                check_rows(ids, got, f"step {step}")
            serve_requests(step + 1)
            check(inval == cached, f"pool dlrm step {step}: {inval} rows "
                  f"invalidated, {cached} of the touched rows were cached")
            log.append({"step": step, "touched": int(idx.size),
                        "untouched": int(other.size), "cached_touched": cached,
                        "invalidated": inval, "flush_ms": round(flush_ms, 1),
                        "check_batch_ms": round(serve_ms, 2),
                        "request_batch_ms": round(request_ms[-1], 3)})
        mgr.on_step = on_step
        batches = LookaheadIterator(DLRMBatches(cfg, Bsz, seed=0, device=dev), cfg,
                                    depth=3)
        train_loop.train(cfg, tcp, batches, 2, relaxed=True, state=state,
                         ckpt_manager=mgr)
        s = tier.stats()
        check(len(log) == 2 and s["watermark"] == 1, f"pool dlrm: {log}, {s}")
        check(all(x["invalidated"] > 0 for x in log),
              "pool dlrm: a commit invalidated no cached row")
        print(f"[pool-dlrm] after each commit: {json.dumps(log)}")
        print(f"[pool-dlrm] tier {json.dumps(s)}")
        out["after_commit"] = log
        out["tier"] = {k: s[k] for k in ("requests", "rows", "p50_ms", "p99_ms",
                                         "hit_rate", "invalidations")}
        out["request_batch_ms"] = request_ms
        mgr.close()
        del mgr, tier
        gc.collect()

        # one rm1 forward through the pool route over the stacked tables
        tabs = state["embed"]["emb_tables"]
        t = time.perf_counter()
        host = tabs.float().cpu().numpy()
        pool = DramPool(DATA_START + host.nbytes + (1 << 20))
        mirror = EmbeddingPoolMirror(pool, host)
        del host
        print(f"[pool-dlrm] EmbeddingPoolMirror {tuple(mirror.shape)} f32 in a dram "
              f"pool: {time.perf_counter() - t:.2f}s")
        batch = DLRMBatches(cfg, Bsz, seed=0, device=dev).next(0)
        t = time.perf_counter()
        pool_bags = mirror.bag_lookup(batch["sparse"].cpu().numpy())
        bag_ms = 1e3 * (time.perf_counter() - t)
        flat, seg = embedding_ops.bag_items(batch["sparse"], R)
        kern_bags = ops.embedding_bag(tabs.view(T * R, d), flat, seg, Bsz * T)
        kern_bags = kern_bags.view(Bsz, T, d).cpu().numpy()
        bag_err = float(np.abs(pool_bags - kern_bags).max())
        np.testing.assert_allclose(pool_bags, kern_bags, rtol=1e-5, atol=1e-5)
        same_bf16 = int((torch.from_numpy(pool_bags).to(tabs.dtype)
                         == torch.from_numpy(kern_bags).to(tabs.dtype))
                        .all(-1).sum())
        params = st.merge_params(state["dense"], state["embed"])
        with torch.no_grad():
            p_kern = torch.sigmoid(dlrm.forward(params, cfg, batch).float())
            bag_launches = eb.launches
            embedding_ops.attach_pool(mirror)
            try:
                with embedding_ops.lookup_mode("pool"):
                    t = time.perf_counter()
                    p_pool = torch.sigmoid(dlrm.forward(params, cfg, batch).float())
                    torch.cuda.synchronize()
                    fwd_ms = 1e3 * (time.perf_counter() - t)
            finally:
                embedding_ops.detach_pool()
        check(eb.launches == bag_launches, "pool dlrm: the pool route launched "
              "the bag kernel")
        gap = (p_pool - p_kern).abs().max().item()
        out.update(bag_max_abs_err=bag_err, bags_equal_in_bf16=same_bf16,
                   bag_lookup_ms=bag_ms, prob_gap=gap, prob_tol=DLRM_POOL_PROB_TOL,
                   pool_forward_ms=fwd_ms)
        print(f"[pool-dlrm] rm1 forward, batch {Bsz}, pool route against the bag "
              f"kernel's: f32 bags max abs diff {bag_err:.3g} (gate 1e-5), equal "
              f"once rounded to bf16 in {same_bf16} of {Bsz * T}; click "
              f"probabilities max abs diff {gap:.3g} (limit {DLRM_POOL_PROB_TOL}); "
              f"the mirror's bag_lookup {bag_ms:.1f} ms, the pool-route forward "
              f"{fwd_ms:.1f} ms")
        check(gap <= DLRM_POOL_PROB_TOL, f"pool dlrm: probabilities differ by {gap}")
        pool.close()
        del state, mirror, pool, params
        gc.collect()
        torch.cuda.empty_cache()
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


ROW_COUNTERS = ("launches", "wide_launches", "narrow_launches")


def row_counts():
    """The sparse tier's launch counters, the row kernels' by route."""
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import gather_rows as gr
    from repro_torch.kernels import scatter_update as su
    c = {"embedding_bag": eb.launches,
         "scatter_update_logged": su.launches_logged,
         "scatter_update_logged_wide": su.wide_launches_logged}
    for name, mod in (("scatter_update", su), ("gather_rows", gr)):
        for k in ROW_COUNTERS:
            c[f"{name}_{k}".replace("_launches", "")] = getattr(mod, k)
    return c


def zero_row_counts():
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import gather_rows as gr
    from repro_torch.kernels import scatter_update as su
    eb.launches = su.launches_logged = su.wide_launches_logged = 0
    su.narrow_launches_logged = 0
    for mod in (su, gr):
        for k in ROW_COUNTERS:
            setattr(mod, k, 0)


def checkpointed_launches(n):
    """The launches of n relaxed rm1 steps under a checkpoint manager: the
    warm-up bag and 3 bags a step (lookup, combine, correction), the
    scratch's two updates and one logged table update a step, and the
    manager's gather of the touched rows."""
    from repro_torch.kernels import embedding_bag as eb
    return {"embedding_bag": (1 + 3 * n) * eb.PASSES, "scatter_update": 2 * n,
            "scatter_update_logged": n, "gather_rows": n}


def host_room(tag, what, build, ram_gb, disk_gb):
    """Fails unless the host has ``ram_gb`` of RAM available and ``disk_gb``
    free under ``build``."""
    import shutil
    with open("/proc/meminfo") as f:
        avail_gb = next(int(ln.split()[1]) for ln in f
                        if ln.startswith("MemAvailable:")) / 1e6
    free_gb = shutil.disk_usage(build).free / 1e9
    print(f"{tag} before: host RAM available {avail_gb:.1f} GB, disk free "
          f"{free_gb:.1f} GB under build/")
    check(avail_gb >= ram_gb, f"{what} needs {ram_gb:.0f} GB of free host RAM, "
          f"{avail_gb:.1f} GB available")
    check(free_gb >= disk_gb, f"{what} needs {disk_gb:.0f} GB of free disk under "
          f"{build}, {free_gb:.1f} GB free")


def stop_nodes(procs):
    """Kills every memory-node process still in ``procs`` and reaps it."""
    for proc in procs:
        if proc is not None:
            with contextlib.suppress(ProcessLookupError):
                proc.kill()
            proc.wait()
            if proc.stdout is not None:
                proc.stdout.close()


def wire_stalls(tag, out, name, pool):
    """Records and prints the reply pauses past the reader's tick that the
    pool's channels waited out (a sharded pool: per node)."""
    def pick(st):
        return {k: st[k] for k in ("stalls", "stall_s_total", "stall_s_max")}
    st = pool.wire_stats()
    got = pick(st) if "stalls" in st else {i: pick(v) for i, v in st.items()}
    out.setdefault("wire_stalls", {})[name] = got
    print(f"{tag} {name}: reply stalls waited out {got}")


def checkpointed_steps(tag, cfg, tc, Bsz, dev, state, mgr, where, n):
    """n relaxed steps of full rm1 checkpointed by ``mgr``: exactly the
    launches of that many steps, every row kernel on the 16-byte route,
    and each step's undo image, captured on the card by the logged update,
    equal to the pool's (``where``) bitwise. Returns (state, losses,
    launches)."""
    from repro_torch.core.checkpoint.manager import check_undo_images, undo_image
    from repro_torch.data.lookahead import LookaheadIterator
    from repro_torch.data.synthetic import DLRMBatches
    batches = LookaheadIterator(DLRMBatches(cfg, Bsz, seed=0, device=dev), cfg,
                                depth=n + 1)
    images = {}

    def on_metrics(step, m):
        images[step] = undo_image(m["ckpt_feed"])
    zero_row_counts()
    state, losses = train_loop_train(cfg, tc, batches, n, state, mgr, on_metrics)
    c = row_counts()
    launches = {k: c[k] for k in checkpointed_launches(n)}
    print(f"{tag} {n} relaxed steps, losses {losses}; launches {launches}")
    check(launches == checkpointed_launches(n),
          f"{tag} unexpected launch counts {launches}")
    check(c["scatter_update_wide"] == c["scatter_update"]
          and c["gather_rows_wide"] == c["gather_rows"]
          and c["scatter_update_logged_wide"] == c["scatter_update_logged"],
          f"{tag} a row kernel launch off the 16-byte route: {c}")
    checked = check_undo_images(mgr.ring, images)
    check(checked == n, f"{tag} {checked} undo entries checked, want {n}")
    print(f"{tag} the undo images of all {checked} steps, captured on the card "
          f"by the logged update, equal {where}'s bitwise")
    return state, losses, launches


def twin_and_resume(tag, cfg, tc, cc, Bsz, dev, fresh_state, rec, twin, m):
    """The uninterrupted twin, ``twin`` (the tables and the dense tree after
    step m) with its relaxed carry rebuilt, takes 1 relaxed step; then the
    resume as the CLI does it: the state from ``rec``, a manager with ``cc``
    on the recovered pool, the mirror re-initialised at m, 1 relaxed step.
    Fails unless the two give the same losses. Returns the resumed
    run's manager, still open, and its mirror load in seconds."""
    import gc

    import torch

    from repro_torch.core.checkpoint import recovery
    from repro_torch.core.checkpoint.manager import CheckpointManager
    from repro_torch.data.lookahead import LookaheadIterator
    from repro_torch.data.synthetic import DLRMBatches

    def batches(start):
        return LookaheadIterator(DLRMBatches(cfg, Bsz, seed=0, device=dev), cfg,
                                 depth=2, start_step=start)
    twin = {**twin, "prefetch": None,
            "step": torch.tensor(m + 1, dtype=torch.int32, device=dev)}
    _, lt = train_loop_train(cfg, tc, batches(m + 1), 1, twin, None, None,
                             start=m + 1)
    del twin
    gc.collect()
    torch.cuda.empty_cache()
    state, start = recovery.resume_train_state(rec, fresh_state())
    check(start == m + 1, f"{tag} resume step {start}, want {m + 1}")
    t = time.perf_counter()
    mgr = CheckpointManager(cfg, cc, pool=rec.pool)
    mgr.init_mirror(state["embed"], step=m)
    load_s = time.perf_counter() - t
    _, lb = train_loop_train(cfg, dataclasses.replace(tc, checkpoint=cc),
                             batches(start), 1, state, mgr, None, start=start)
    mgr.flush()
    print(f"{tag} resumed at step {start} (mirror load {load_s:.2f}s): losses "
          f"{lb}; the uninterrupted twin's {lt}")
    check(lb == lt, f"{tag} resumed losses differ from the twin's")
    return mgr, load_s


def remote_checkpoint_phase(torch, np, cfg, tc, Bsz, dev, fresh_state,
                            pmem_tier_e_ms):
    """Phase 18: full-width dlrm-rm1 checkpointed into a memory node in a
    process of its own (``python -m repro_torch.pool.server``, pmem, on a
    unix socket), the paper's arrangement. Returns run A's launch counts
    and the numbers it printed."""
    import ast
    import gc
    import shutil
    import tempfile

    from repro_torch.core.checkpoint import recovery
    from repro_torch.core.checkpoint.manager import CheckpointManager
    from repro_torch.data.lookahead import LookaheadIterator
    from repro_torch.data.synthetic import DLRMBatches
    from repro_torch.pool import PoolAllocator, PoolError, RemotePool
    from repro_torch.pool.allocator import JsonRegion
    from repro_torch.pool.server import start_node, unix_addr
    from repro_torch.tree import tree_map

    T, R, d = cfg.dlrm_num_tables, cfg.dlrm_rows_per_table, cfg.dlrm_bottom_mlp[-1]
    mirror_bytes = T * R * d * 4
    mirror_gb = mirror_bytes / 1e9
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    # RAM: the node's cache and page cache (2 x mirror each), the trainer's
    # f32 copy, the recovered mirror and the replay's tables on the host.
    # Disk: one node image at a time (run A's node is gone before the drill)
    host_room("[remote]", "remote phase", build, 8 * mirror_gb, 2 * mirror_gb)
    work = tempfile.mkdtemp(prefix="remote-ckpt-", dir=build)
    addr = unix_addr(work)
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    procs = {}
    out = {}

    def node_up(name):
        # the node sized for one tenant's mirror, ring and dense slots
        try:
            procs["node"] = start_node(addr, path=os.path.join(work, f"{name}.img"),
                                       capacity=2 * mirror_bytes + (64 << 20),
                                       env=env)
        except PoolError as e:
            fail(f"remote: the memory node did not start: {e}")
        print(f"[remote] memory node ({name}) up at {addr}, pid {procs['node'].pid}")

    def node_down():
        node = procs.pop("node")
        check(node.poll() is None, f"remote: the memory node exited early "
              f"(exit {node.returncode})")
        node.terminate()
        node.wait(timeout=60)
        node.stdout.close()

    def host_tables(state):
        t = state["embed"]["emb_tables"]
        return t.to("cpu", torch.float32, copy=True).numpy().reshape(-1, d)

    try:
        # -- run A, in process: 1 relaxed step over the unix socket --------
        # (zlib, the default: its tier-E and step 0's tier-M of the dense
        # tree, which recovery reads back)
        node_up("A")
        cca = dataclasses.replace(tc.checkpoint, directory=os.path.join(work, "A"),
                                  dense_interval=4, pool_backend="remote",
                                  pool_addr=addr, pool_tenant="A")
        tca = dataclasses.replace(tc, checkpoint=cca)
        state = fresh_state()
        t = time.perf_counter()
        mgr = CheckpointManager(cfg, cca, embed_init=state["embed"])
        out["mirror_load_s"] = time.perf_counter() - t
        out["mirror_load_frames"] = mgr.pool.frames_split
        print(f"[remote] manager start + mirror load over the socket "
              f"({mirror_gb:.2f} GB f32, persisted on the node): "
              f"{out['mirror_load_s']:.2f}s in {out['mirror_load_frames']} frames "
              f"(wire v{mgr.pool.wire})")
        steps = []
        tier_e = mgr._do_tier_e

        def measured_tier_e(step, idx, new_rows):
            # the writer thread's tier-E, between two snapshots of the
            # tenant's counters on the node (nothing else uses the pool
            # while it runs: tier-M runs on the same thread)
            before = mgr.pool.metrics
            t = time.perf_counter()
            tier_e(step, idx, new_rows)
            ms = 1e3 * (time.perf_counter() - t)
            after = mgr.pool.metrics
            steps.append({"step": step, "ms": ms, "idx_bytes": idx.nbytes,
                          "new_rows_bytes": new_rows.nbytes,
                          "link_bytes": after.link_bytes() - before.link_bytes(),
                          "media_bytes": after.media_bytes() - before.media_bytes()})
        mgr._do_tier_e = measured_tier_e
        state, _, launches = checkpointed_steps(
            "[remote] run A:", cfg, tca, Bsz, dev, state, mgr, "the node", 1)
        for s_ in steps:
            print(f"[remote] tier-E step {s_['step']}: {s_['ms']:.1f} ms, link "
                  f"{s_['link_bytes']} B (idx {s_['idx_bytes']} + new rows "
                  f"{s_['new_rows_bytes']} B), media {s_['media_bytes']} B")
            check(s_["link_bytes"] <= s_["idx_bytes"] + s_["new_rows_bytes"] + 4096,
                  f"remote tier-E step {s_['step']}: {s_['link_bytes']} link "
                  "bytes exceed idx + new rows + 4 KB")
            check(s_["media_bytes"] > s_["link_bytes"],
                  f"remote tier-E step {s_['step']}: media bytes do not exceed "
                  "the link bytes")
        out["tier_e_ms"] = [s_["ms"] for s_ in steps]
        out["tier_e_link_bytes"] = [s_["link_bytes"] for s_ in steps]
        out["tier_e_media_bytes"] = [s_["media_bytes"] for s_ in steps]
        print(f"[remote] tier-E ms per step {out['tier_e_ms']}; phase 6's pmem pool "
              f"in process (pool_compress none) {pmem_tier_e_ms}")
        print(f"[ckpt-remote] stats {json.dumps(mgr.stats)}")
        print(mgr.pool.metrics.report())
        wire_stalls("[remote]", out, "run A load + steps", mgr.pool)
        mgr.close()
        final = host_tables(state)
        del mgr, state
        gc.collect()
        t = time.perf_counter()
        rec = recovery.recover(os.path.join(work, "A"))
        out["recover_a_s"] = time.perf_counter() - t
        print(f"[remote] run A recover over a fresh connection: "
              f"{out['recover_a_s']:.2f}s")
        check(rec.mirror_step == rec.dense_step == 0 and not rec.rolled_back,
              f"remote run A recovered mirror@{rec.mirror_step} "
              f"dense@{rec.dense_step}")
        check(np.array_equal(rec.embed_rows.view(np.uint32), final.view(np.uint32)),
              "remote run A: recovered mirror differs from the final tables")
        wire_stalls("[remote]", out, "run A recover", rec.pool)
        rec.pool.close()
        del rec, final
        gc.collect()
        torch.cuda.empty_cache()
        # the emulated allocator never reuses freed bytes (a bump pointer),
        # so the drill gets a node of its own on a fresh image
        node_down()
        os.remove(os.path.join(work, "A.img"))

        # -- the drill: the CLI trainer in a subprocess, kill -9 ------------
        node_up("drill")
        ck = os.path.join(work, "drill")
        with open(os.path.join(work, "trainer.log"), "w") as log:
            procs["trainer"] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                 "dlrm-rm1", "--full", "--batch", str(Bsz), "--steps", "1000",
                 "--lr", str(tc.learning_rate), "--embed-lr",
                 str(tc.embed_learning_rate), "--ckpt-dir", ck,
                 "--pool-backend", "remote", "--pool-addr", addr,
                 "--pool-tenant", "drill"],
                env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
                text=True, start_new_session=True)
        watcher = RemotePool(addr, tenant="drill", readonly=True, timeout=60.0)
        t0, committed = time.perf_counter(), -1
        while committed < 1:        # 2 steps committed, step 0's tier-M too
            trainer = procs["trainer"]
            if trainer.poll() is not None:
                with open(os.path.join(work, "trainer.log")) as f:
                    fail(f"remote drill: the trainer exited (exit "
                         f"{trainer.returncode}) before it was killed:\n"
                         f"{f.read()[-6000:]}")
            check(time.perf_counter() - t0 < 600, "remote drill: fewer than 2 "
                  "committed steps within 600 s")
            region = PoolAllocator(watcher).domain("manifest").get("manifest")
            man = JsonRegion(region).read() if region is not None else None
            committed = man["mirror_step"] if man else -1
            time.sleep(0.2)
        os.killpg(procs["trainer"].pid, signal.SIGKILL)    # kill -9
        procs.pop("trainer").wait()
        watcher.close()
        out["killed_after_s"] = time.perf_counter() - t0
        check(procs["node"].poll() is None, "remote drill: the memory node died "
              "with the trainer")
        with open(os.path.join(work, "trainer.log")) as f:
            lines = f.read().splitlines()
        logged = [ln for ln in lines if ln.startswith("[train] step")]
        print(f"[remote] drill: trainer SIGKILLed {out['killed_after_s']:.1f}s after "
              f"its start, the node's manifest at step {committed}; the memory "
              f"node is alive. Trainer's last lines: {' | '.join(logged[-3:])}")
        check(logged and "launches {" in logged[-1], "remote drill: the trainer "
              "reported no launch counts")
        child = ast.literal_eval(logged[-1].split("launches ", 1)[1])
        n_child = int(logged[-1].split()[2]) + 1
        out["trainer_launches"] = child
        print(f"[remote] drill: the trainer subprocess's launch counts after "
              f"{n_child} steps: {child}")
        check(child == checkpointed_launches(n_child),
              f"remote drill: the trainer's launch counts {child} are not "
              f"those of {n_child} relaxed steps")
        t = time.perf_counter()
        rec = recovery.recover(ck)
        out["recover_s"] = time.perf_counter() - t
        m, ds = rec.mirror_step, rec.dense_step
        print(f"[remote] drill recover over a fresh connection (POOL.json): "
              f"{out['recover_s']:.2f}s, mirror@{m} dense@{ds} gap={rec.gap} "
              f"rolled_back={rec.rolled_back}")
        check(m >= 1 and 0 <= ds <= m, f"remote drill: recovered mirror@{m} "
              f"dense@{ds}")
        wire_stalls("[remote]", out, "drill recover", rec.pool)

        # the clean replay on the card: the CLI's trainer (params from
        # tc.seed, batches of seed 0) to step m, keeping the dense tree as
        # it was after step ds
        class Replay:
            dense = None

            def on_step(self, n, st, feed):
                if n == ds:
                    self.dense = tree_map(torch.clone, {
                        k: st[k] for k in ("dense", "opt_dense", "opt_embed")})

            def flush(self):
                pass

        replay = Replay()
        state, _ = train_loop_train(
            cfg, tc, LookaheadIterator(DLRMBatches(cfg, Bsz, seed=0, device=dev),
                                       cfg, depth=m + 2), m + 1, fresh_state(),
            replay, None)
        check(np.array_equal(rec.embed_rows.view(np.uint32),
                             host_tables(state).view(np.uint32)),
              "remote drill: the recovered mirror differs from a clean replay")
        print(f"[remote] drill: recovered mirror is BIT-IDENTICAL to a clean "
              f"replay on the card through step {m}")
        # the replay's twin of the recovered state: its tables at m, its
        # dense tree at ds; the resume as the CLI does it
        ccd = dataclasses.replace(tc.checkpoint, directory=ck, pool_backend="remote",
                                  pool_addr=addr, pool_tenant="drill")
        mgr, _ = twin_and_resume("[remote] drill:", cfg, tc, ccd, Bsz, dev,
                                 fresh_state, rec, {**state, **replay.dense}, m)
        mgr.close()
        del state, replay, rec
        check(procs["node"].poll() is None, "remote drill: the memory node exited")
        del mgr
        gc.collect()
        torch.cuda.empty_cache()
        node_down()
        print("[remote] memory node in its own process: checkpoint, kill -9, "
              "bitwise recovery and resume: ok")
        return launches, out
    finally:
        # none outlives the phase: the trainer's process group, the node
        with contextlib.suppress(ProcessLookupError):
            if "trainer" in procs:
                os.killpg(procs["trainer"].pid, signal.SIGKILL)
        stop_nodes(procs.values())
        shutil.rmtree(work, ignore_errors=True)


# The embedding rate of phase 19's runs. DLRM's accumulator is per table:
# the mean of g^2 over the table's R * d elements, so a touched element
# moves by about lr * sqrt(R / rows touched) on the first step (about 88 lr
# for rm1), where an LM's per-row accumulator moves it by about lr. rm1's
# loss descends at 1e-5 (4.57, 2.93, 1.92) and reaches 1e5 at 0.01.
ADAGRAD_EMBED_LR = {"dlrm-rm1": 1e-5, "tinyllama-1.1b": 0.01}


def adagrad_phase(torch, np, dev, check_update, check_gather):
    """Phase 19: row-wise Adagrad on the sparse tier at full width. For
    full dlrm-rm1 (bf16, batch 128) and full tinyllama-1.1b (bf16, remat,
    batch 4 x 1024), each run from the seed's params: 3 relaxed Adagrad
    steps, 3 relaxed sgd steps twice, the Adagrad run again (bitwise the
    first: losses and accumulator), 2 strict Adagrad steps. tinyllama's
    strict losses are within the reference's relaxed-vs-strict tolerance
    of the relaxed run's, each step's accumulator bitwise the relaxed
    run's. rm1's bf16 schedules see the same rows only at step 0 (loss
    and accumulator bitwise there): from step 1 the strict step reads rows
    rounded to bf16 after the update and the relaxed one the stale rows
    plus the f32 correction, as the reference rounds them. So rm1 is held
    at the reference's bag tolerance with f32 tables, 2 relaxed and 2
    strict steps, losses and accumulators. The loss stays within twice its
    first value. The Adagrad run's launches must be the
    sgd run's plus exactly the accumulator's: for an LM a scatter_update
    and a gather_rows a step on the narrow route; for DLRM none (its per
    table accumulator is a masked sum, as the reference's is plain jnp).
    Every table launch stays on the 16-byte route. Then the LM
    accumulator's kernels at the run's shapes against their plain
    versions, timed; then smoke dlrm-rm1 and tinyllama, 5 Adagrad steps on
    the card against the CPU. Returns ({arch: the first Adagrad run's
    counts}, step ms, timings)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import relaxed as rx
    from repro_torch.data.lookahead import LookaheadIterator
    from repro_torch.data.synthetic import make_batches
    from repro_torch.kernels import ops, ref
    from repro_torch.models.registry import get_api
    from repro_torch.training import train_loop
    from repro_torch.tree import tree_map

    ADA = "rowwise_adagrad"
    tol = {"dlrm-rm1": 2e-5, "tinyllama-1.1b": 1e-6}   # tests/test_relaxed.py's
    all_counts, all_steps, timing = {}, {}, {}
    for arch in ("dlrm-rm1", "tinyllama-1.1b"):
        tag = f"[adagrad {arch}]"
        cfg = cfg_ = get_arch(arch).model
        dlrm = cfg.arch_type == "dlrm"
        B, S, steps = (128, 0, 3) if dlrm else (4, 1024, 3)
        api = get_api(cfg)
        leaf = rx.embed_leaf(cfg)

        def run(opt, relaxed, n, f32=False, api=api, B=B, S=S, leaf=leaf):
            cfg = dataclasses.replace(cfg_, dtype="float32") if f32 else cfg_
            tc = TrainConfig(learning_rate=1e-3, embed_optimizer=opt,
                             embed_learning_rate=ADAGRAD_EMBED_LR[arch])
            gen = torch.Generator(device=dev)
            gen.manual_seed(tc.seed)
            state = train_loop.make_step_fns(cfg, tc)[0](api.init(gen, cfg))
            acc, accs = state["opt_embed"][leaf] if opt == ADA else None, []
            # every batch of a run is made first (set-up, on the host)
            batches = LookaheadIterator(make_batches(cfg, B, S, seed=0, device=dev),
                                        cfg, depth=n + 1)
            torch.cuda.synchronize()
            stamps = [time.perf_counter()]

            def on_metrics(n_, m):
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
                if acc is not None:     # updated in place: this step's
                    accs.append(acc.clone())
            zero_row_counts()
            state, losses = train_loop.train(cfg, tc, batches, n, relaxed=relaxed,
                                             state=state, on_metrics=on_metrics)
            counts = row_counts()
            del state
            torch.cuda.empty_cache()
            ms = [1e3 * (b - a) for a, b in zip(stamps[:-1], stamps[1:], strict=True)]
            return losses, ms, counts, accs

        t0 = time.perf_counter()
        ada = run(ADA, True, steps)
        sgd = run("sgd", True, steps)
        sgd2 = run("sgd", True, steps)
        ada2 = run(ADA, True, steps)
        strict = run(ADA, False, 2)
        print(f"{tag} relaxed losses {ada[0]}; again {ada2[0]}; strict {strict[0]}; "
              f"sgd {sgd[0]}")
        print(f"{tag} launches: adagrad relaxed {ada[2]}; sgd relaxed {sgd[2]}; "
              f"adagrad strict {strict[2]}")
        check(all(math.isfinite(x) for x in ada[0] + strict[0]),
              f"{arch} adagrad: non-finite loss")
        check(ada2[0] == ada[0] and all(torch.equal(a, b) for a, b in
                                        zip(ada2[3], ada[3], strict=True)),
              f"{arch} adagrad: the relaxed run is not repeatable bitwise")
        check(max(ada[0]) <= 2 * ada[0][0], f"{arch} adagrad: the loss leaves its "
              f"range at embed lr {ADAGRAD_EMBED_LR[arch]}: {ada[0]}")

        def acc_rel(a, b):
            return ((a - b).abs().max() / b.abs().max()).item()
        same = [torch.equal(a, b) for a, b in zip(strict[3], ada[3], strict=False)]
        print(f"{tag} strict vs relaxed: losses max rel diff "
              f"{max(abs(a - b) / abs(b) for a, b in zip(strict[0], ada[0]))}; "
              f"accumulator bitwise at each step {same}, max rel diff "
              f"{[acc_rel(a, b) for a, b in zip(strict[3], ada[3], strict=False)]}")
        if dlrm:
            check(strict[0][0] == ada[0][0] and same[0], f"{arch} adagrad: the "
                  "schedules differ at step 0, on the same rows")
            r32, s32 = run(ADA, True, 2, f32=True), run(ADA, False, 2, f32=True)
            rel = [acc_rel(a, b) for a, b in zip(s32[3], r32[3], strict=True)]
            print(f"{tag} f32 tables: relaxed losses {r32[0]}, strict {s32[0]}; "
                  f"accumulator max rel diff {rel}")
            check(np.allclose(s32[0], r32[0], rtol=tol[arch], atol=tol[arch])
                  and max(rel) <= tol[arch], f"{arch} adagrad, f32 tables: strict "
                  f"vs relaxed beyond {tol[arch]}")
            del r32, s32
        else:
            check(np.allclose(strict[0], ada[0][:2], rtol=tol[arch], atol=tol[arch]),
                  f"{arch} adagrad: strict {strict[0]} vs relaxed {ada[0][:2]} "
                  f"beyond {tol[arch]}")
            check(len(same) == 2 and all(same), f"{arch} adagrad: the strict run's "
                  "accumulator differs from the relaxed run's")
        last = ada[3][-1]
        want_acc = (cfg.dlrm_num_tables, 1, 1) if dlrm else (cfg.vocab_size, 1)
        check(tuple(last.shape) == want_acc and bool((last >= 0).all())
              and bool((last > 0).any()), f"{arch}: accumulator {tuple(last.shape)}")
        # the accumulator's launches, and only those, on the narrow route
        acc_n = 0 if dlrm else steps
        extra = {"scatter_update": acc_n, "scatter_update_narrow": acc_n,
                 "gather_rows": acc_n, "gather_rows_narrow": acc_n}
        want = {k: v + extra.get(k, 0) for k, v in sgd[2].items()}
        check(sgd[2]["scatter_update_narrow"] == sgd[2]["gather_rows_narrow"] == 0,
              f"{arch} sgd: narrow launches {sgd[2]}")
        check(ada[2] == want, f"{arch} adagrad relaxed launches {ada[2]}, want the "
              f"sgd run's plus the accumulator's {want}")
        check(ada[2]["scatter_update_logged_wide"] == ada[2]["scatter_update_logged"],
              f"{arch} adagrad: a logged update off the 16-byte route")
        n_strict, acc_n = 2, 0 if dlrm else 2
        check(strict[2]["scatter_update_narrow"] == strict[2]["gather_rows_narrow"]
              == acc_n and strict[2]["scatter_update_wide"] == n_strict
              and strict[2]["gather_rows_wide"] == (0 if dlrm else n_strict)
              and strict[2]["scatter_update"] == n_strict + acc_n,
              f"{arch} adagrad strict launches {strict[2]}")
        step = {"adagrad_ms": ada[1] + ada2[1], "sgd_ms": sgd[1] + sgd2[1],
                "adagrad_ms_median": statistics.median(ada[1][1:] + ada2[1][1:]),
                "sgd_ms_median": statistics.median(sgd[1][1:] + sgd2[1][1:])}
        step["adagrad_over_sgd"] = step["adagrad_ms_median"] / step["sgd_ms_median"]
        print(f"{tag} step ms in turns (adagrad, sgd, sgd, adagrad): {json.dumps(step)}; "
              f"{time.perf_counter() - t0:.1f}s")
        all_counts[arch], all_steps[arch] = ada[2], step

        # the LM accumulator's kernels at the run's shapes
        if not dlrm:
            batch = make_batches(cfg, B, S, seed=0, device=dev).next(0)
            d = cfg.d_model
            ids = batch["tokens"].reshape(-1).to(torch.int32).contiguous()
            N = ids.numel()
            uniq, g = ops.combine_duplicates(ids, torch.randn((N, d), device=dev) * 1e-3)
            n_rows = int((uniq >= 0).sum())
            acc = torch.rand((cfg.vocab_size, 1), device=dev)
            msq = torch.mean(torch.square(g), dim=1, keepdim=True)
            clamped = uniq.clamp(min=0)
            real = uniq[:n_rows].long()
            check_gather(acc, clamped, "tinyllama adagrad accumulator rows")
            check_update(acc.clone(), uniq, msq, "tinyllama adagrad accumulator")
            shapes = {
                # the ids once, each slot's accumulator read and written
                "lm_acc_gather": (lambda: ops.gather_rows(acc, clamped),
                                  lambda: ref.gather_rows_ref(acc, clamped),
                                  lambda: torch.index_select(acc, 0, clamped),
                                  bound(N * 4 * 3, 0)),
                # the ids, each touched row's f32 increment, read and written
                "lm_acc_update": (lambda: ops.scatter_update(acc, uniq, msq),
                                  lambda: ref.scatter_update_ref(acc, uniq, msq),
                                  lambda: acc.index_add_(0, real, msq[:n_rows]),
                                  bound(N * 4 + n_rows * 4 * 3, n_rows)),
            }
            timing.update(time_shapes(torch, tag, shapes))

        # smoke on the card against the CPU, from the same params
        scfg = get_arch(arch, smoke=True).model
        stc = TrainConfig(embed_learning_rate=0.01, embed_optimizer=ADA)
        gen = torch.Generator()
        gen.manual_seed(0)
        params = get_api(scfg).init(gen, scfg)
        res = {}
        for name, where in (("card", dev), ("cpu", torch.device("cpu"))):
            st = train_loop.make_step_fns(scfg, stc)[0](
                tree_map(lambda p, w=where: p.to(w, copy=True), params))
            st, losses = train_loop.train(scfg, stc, make_batches(scfg, 4, 16, seed=0,
                                                                  device=where),
                                          5, relaxed=True, state=st, device=where)
            res[name] = (np.asarray(losses), st["opt_embed"][leaf].cpu().numpy())
        (lc, ac), (lh, ah) = res["card"], res["cpu"]
        rel = np.abs(ac - ah).max() / np.abs(ah).max()
        print(f"{tag} smoke card vs cpu, 5 adagrad steps: losses {lc.tolist()} vs "
              f"{lh.tolist()}; accumulator max rel diff {rel:.3g}")
        # AdamW's first steps amplify float-order differences (phase 5)
        check(np.allclose(lc, lh, rtol=1e-4, atol=1e-5),
              f"{arch} smoke adagrad: card losses {lc} vs cpu {lh}")
        check(rel <= 1e-4, f"{arch} smoke adagrad: accumulator differs by {rel:.3g}")
    return all_counts, all_steps, timing


def sharded_checkpoint_phase(torch, np, cfg, tc, Bsz, dev, fresh_state):
    """Phase 20: full-width dlrm-rm1 checkpointed into a sharded pool of
    three memory nodes (``python -m repro_torch.pool.server`` processes on
    pmem images under build/, unix sockets), which survives the permanent
    loss of the node that holds the mirror and the manifest's primary.
    Returns the run's launch counts and the numbers it printed."""
    import gc
    import shutil
    import tempfile

    from repro_torch.core.checkpoint import recovery
    from repro_torch.core.checkpoint.manager import CheckpointManager
    from repro_torch.pool import PoolError
    from repro_torch.pool.server import start_node, unix_addr
    from repro_torch.tree import tree_map

    T, R, d = cfg.dlrm_num_tables, cfg.dlrm_rows_per_table, cfg.dlrm_bottom_mlp[-1]
    mirror_gb = T * R * d * 4 / 1e9
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    # RAM: three node caches with their page cache (the mirror, its replica
    # and the promoted copy), the trainer's f32 load and recovered copies.
    # Disk: the mirror, its replica and the promoted copy, plus the rings
    host_room("[sharded]", "sharded phase", build, 10 * mirror_gb, 4 * mirror_gb)
    work = tempfile.mkdtemp(prefix="sharded-ckpt-", dir=build)
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    addrs = [unix_addr(work, f"node{i}.sock") for i in range(3)]
    images = [os.path.join(work, f"node{i}.img") for i in range(3)]
    procs = [None] * 3
    out = {}
    lost, keep, spare = 0, 1, 2     # the mirror's node, dense's, the replica's
    ck = os.path.join(work, "ck")

    def used(pool, name):
        snaps = pool.shard_metrics()
        out.setdefault("used_bytes", {})[name] = [
            None if s.get("unreachable") else s["used_bytes"] for s in snaps]
        print(f"[sharded] {name}: used bytes per node {out['used_bytes'][name]}")

    try:
        t0 = time.perf_counter()
        for i in range(3):
            try:
                procs[i] = start_node(addrs[i], path=images[i], env=env,
                                      capacity=(64 << 20))
            except PoolError as e:
                fail(f"sharded: memory node {i} did not start: {e}")
        print(f"[sharded] three memory nodes up in {time.perf_counter() - t0:.1f}s "
              f"(pmem images, unix sockets); node {lost} holds the mirror and the "
              f"manifest's primary, node {keep} the dense tier, node {spare} the "
              f"replicas")
        # pool_compress none: a zlib refresh of the 2.56 GB mirror runs at the
        # node's zlib rate, a minute or more (PERF.md)
        cc = dataclasses.replace(
            tc.checkpoint, directory=ck, dense_interval=2, max_undo_logs=4,
            pool_backend="sharded", pool_shards=",".join(addrs),
            pool_placement=f"embedding-mirror={lost},manifest={lost},dense={keep}",
            pool_tenant="sharded", pool_compress="none", pool_manifest_quorum=True,
            pool_replica=spare, pool_replica_every=2, pool_ckpt_replica=spare)
        tcs = dataclasses.replace(tc, checkpoint=cc)
        state = fresh_state()
        t = time.perf_counter()
        mgr = CheckpointManager(cfg, cc, embed_init=state["embed"])
        out["mirror_load_s"] = time.perf_counter() - t
        pool = mgr.pool
        check(pool.backend == "sharded" and pool.nshards == 3,
              "sharded: the manager's pool is not the three nodes")
        check(pool.placement.place("embedding-mirror") == lost
              and pool.placement.place("undo-log") == lost
              and pool.placement.place("manifest") == lost,
              f"sharded: placement {pool.placement.to_json()}")
        print(f"[sharded] manager start + mirror load onto node {lost} "
              f"({mirror_gb:.2f} GB f32): {out['mirror_load_s']:.2f}s; witnesses "
              f"on nodes {[pool.placement.place(f'manifest@w{k}') for k in (1, 2)]}")
        refreshes, tier_e = [], []
        replicate = pool.replicate_domain

        def timed_replicate(domain, dst, **kw):
            t = time.perf_counter()
            info = replicate(domain, dst, **kw)
            refreshes.append({"domain": domain, "s": time.perf_counter() - t,
                              "link_bytes": info["link_bytes"],
                              "watermark": info["watermark"]})
            return info
        pool.replicate_domain = timed_replicate
        do_tier_e = mgr._do_tier_e

        def timed_tier_e(step, idx, new_rows):
            n0 = len(refreshes)
            t = time.perf_counter()
            do_tier_e(step, idx, new_rows)
            s = time.perf_counter() - t
            tier_e.append({"step": step, "s": s, "replication_s": sum(
                r["s"] for r in refreshes[n0:])})
        mgr._do_tier_e = timed_tier_e
        kept = {}
        on_step = mgr.on_step

        def keeping_on_step(n, st, feed):
            if n % cc.pool_replica_every == 0:     # a refresh step: the
                kept[n] = tree_map(torch.clone, {  # twin's state there
                    k: st[k] for k in ("embed", "dense", "opt_dense",
                                       "opt_embed")})
            on_step(n, st, feed)
        mgr.on_step = keeping_on_step
        state, _, launches = checkpointed_steps(
            "[sharded]", cfg, tcs, Bsz, dev, state, mgr, f"node {lost}", 4)
        for s_ in tier_e:
            print(f"[sharded] tier-E step {s_['step']}: {s_['s']:.2f}s, of which "
                  f"replication {s_['replication_s']:.2f}s")
        for r in refreshes:
            print(f"[sharded] refresh of {r['domain']}@replica on node {spare}: "
                  f"{r['s']:.2f}s, {r['link_bytes']} link bytes, watermark "
                  f"{r['watermark']}")
        out["tier_e_s"] = [s_["s"] for s_ in tier_e]
        out["replication_s"] = [s_["replication_s"] for s_ in tier_e]
        out["refreshes"] = refreshes
        st = dict(mgr.stats)
        print(f"[sharded] checkpoint stats {json.dumps(st)}")
        check(st["replica_refresh_failures"] == 0 and st["manifest_witness_failures"] == 0,
              f"sharded: replication degraded {st}")
        # the refresh of step 0 makes the replica, that of step 2 refreshes
        # it in place; step 3 is rolled back after the loss
        check(st["replica_refreshes"] == 2 and st["ship_steps"] == 4,
              f"sharded: {st['replica_refreshes']} mirror refreshes and "
              f"{st['ship_steps']} ships, want 2 and 4")
        used(pool, "after 4 steps")
        wire_stalls("[sharded]", out, "4 steps", pool)
        last = max(kept)
        mgr._do_tier_e, mgr.on_step = do_tier_e, on_step
        pool.replicate_domain = replicate

        # node `lost` dies for good: kill -9, image deleted, never restarted
        os.kill(procs[lost].pid, signal.SIGKILL)
        procs[lost].wait()
        procs[lost].stdout.close()
        procs[lost] = None
        os.remove(images[lost])
        print(f"[sharded] kill -9'd memory node {lost} and DELETED its image")
        with contextlib.suppress(PoolError, RuntimeError):
            mgr.close()                    # the trainer goes down with it
        del mgr, state
        gc.collect()
        torch.cuda.empty_cache()

        t = time.perf_counter()
        pool = recovery.open_pool(ck)      # the survivors only
        out["reopen_s"] = time.perf_counter() - t
        check(pool.dead_shards() == [lost], f"sharded: dead shards "
              f"{pool.dead_shards()}")
        man = recovery._read_manifest(recovery.PoolAllocator(pool), pool)
        check(man is not None and man["mirror_step"] == 3,
              f"sharded: the 2-of-3 manifest election gave {man}")
        print(f"[sharded] reopened with the survivors in {out['reopen_s']:.2f}s; the "
              f"manifest elected 2 of 3 (witnesses on nodes "
              f"{[pool.placement.place(f'manifest@w{k}') for k in (1, 2)]}): "
              f"mirror@{man['mirror_step']} dense@{man['dense_step']}")
        epoch0 = pool.placement.epoch
        pool.epoch_sink = lambda pm: recovery.record_placement(ck, pool)
        t = time.perf_counter()
        info = pool.promote_replica("embedding-mirror", compress="none")
        out["promote_s"] = time.perf_counter() - t
        check(set(info["promoted"]) == {"embedding-mirror", "undo-log"}
              and info["epoch"] == epoch0 + 1
              and all(v == spare for v in info["dst"].values()),
              f"sharded: promotion {info}")
        print(f"[sharded] promoted embedding-mirror + undo-log to node {spare} in "
              f"ONE epoch ({info['epoch']}): {out['promote_s']:.2f}s, "
              f"{info['link_bytes']} link bytes")
        info = pool.promote_replica("manifest", compress="none",
                                    from_domain="manifest@w1")
        print(f"[sharded] the manifest's primary promoted from witness 1 on node "
              f"{info['dst']['manifest']} (epoch {info['epoch']})")
        pool.close()
        t = time.perf_counter()
        rec = recovery.recover(ck)
        out["recover_s"] = time.perf_counter() - t
        m, ds = rec.mirror_step, rec.dense_step
        print(f"[sharded] recover after the promotion: {out['recover_s']:.2f}s, "
              f"mirror@{m} dense@{ds} gap={rec.gap} rolled_back={rec.rolled_back}")
        check(m == last and ds == last and rec.rolled_back,
              f"sharded: recovered mirror@{m} dense@{ds} rolled_back="
              f"{rec.rolled_back}, want {last}, {last}, True")
        want = kept[last]["embed"]["emb_tables"].to("cpu", torch.float32).numpy()
        check(np.array_equal(rec.embed_rows.view(np.uint32),
                             want.reshape(-1, d).view(np.uint32)),
              f"sharded: the promoted mirror differs from the tables at step {m}")
        print(f"[sharded] the promoted mirror equals the card's tables at step {m} "
              f"(the replication watermark) BITWISE; step {m + 1} rolled back from "
              f"the replica's undo ring")
        wire_stalls("[sharded]", out, "recover", rec.pool)
        used(rec.pool, "after the promotion")
        del want
        # the uninterrupted twin: tables and dense tree at m; the resume
        # on the survivors, replication off
        ccr = dataclasses.replace(cc, pool_replica=-1, pool_ckpt_replica=-1)
        twin = {**fresh_state(), **kept.pop(last)}
        kept.clear()
        mgr, out["resume_mirror_load_s"] = twin_and_resume(
            "[sharded] on the survivors:", cfg, tc, ccr, Bsz, dev, fresh_state, rec,
            twin, m)
        del twin, rec
        check(mgr.stats["replica_refresh_failures"] == 0,
              "sharded: replication degraded after the resume")
        wire_stalls("[sharded]", out, "resume", mgr.pool)
        mgr.close()
        del mgr
        gc.collect()
        torch.cuda.empty_cache()
        for i in (keep, spare):
            check(procs[i].poll() is None, f"sharded: memory node {i} exited")
        print("[sharded] three memory nodes, the mirror's node lost for good: "
              "promotion, bitwise recovery and resume: ok")
        return launches, out
    finally:
        stop_nodes(procs)      # none outlives the phase
        shutil.rmtree(work, ignore_errors=True)


# Phase 21's faulted runs. FaultSchedule.seeded(seed, POINTS, every=SOAK_EVERY)
# arms each of the soak's points, which fire once a step at dense_interval=1,
# at occurrence crc32(f"{seed}:{point}") % SOAK_EVERY + 1. For these two seeds
# no point is armed before its second occurrence, and the first to come due
# fires in step 1's tier-E, after step 0 was committed: seed 1 crashes before
# step 1's undo payload persists (nothing to roll back), seed 32 tears step
# 1's mirror apply (the committed entry rolls the torn rows back). Both
# recover step SOAK_RECOVERED with the dense tier caught up (gap 0). Each run
# takes SOAK_STEPS steps, enough for step 1's tier-E.
# the torn run alone: a crash run's recovery without a rollback is what
# phase 6 run A's and phase 18's recoveries and
# tests/test_torch_checkpoint.py::test_seeded_fault_after_a_committed_step_recovers_as_jax
# (both seeds, under the checker) drive already
SOAK_SEEDS = (("torn", 32),)
SOAK_EVERY = 4
SOAK_STEPS = 2
SOAK_RECOVERED = 0


def clock_tracker(tracker):
    """Adds up the seconds spent in ``tracker``'s event methods (the
    checker's own cost, on whichever thread calls them) and the most dirty
    intervals it held at a mirror-apply persist. Returns the dict it
    fills."""
    clock = {"s": 0.0, "dirty_intervals_max": 0, "mirror_applies": 0}
    for name in ("note_write", "note_read", "note_persist", "note_crash",
                 "note_alloc", "note_free"):
        fn = getattr(tracker, name)

        def wrapper(*a, _fn=fn, _name=name, **k):
            if _name == "note_persist" and k.get("point") == "mirror-apply":
                clock["dirty_intervals_max"] = max(clock["dirty_intervals_max"],
                                                   sum(1 for _ in tracker.dirty))
                clock["mirror_applies"] += 1
            t = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                clock["s"] += time.perf_counter() - t
        setattr(tracker, name, wrapper)
    return clock


def checked_soak_phase(torch, np, cfg, tc, Bsz, dev, pmem_tier_e_ms):
    """Phase 21: full dlrm-rm1 with f32 tables trained under the
    crash-consistency checker (``REPRO_POOL_CHECK=1``, as a user sets it)
    into a pmem pool under build/, relaxed, dense_interval=1 as in the soak,
    pool_compress none as in phase 6. Run U checkpoints SOAK_STEPS steps
    (launch counts, 16-byte routes, the mirror equal to the tables); its
    state after step SOAK_RECOVERED is kept on the card with the relaxed
    carry dropped, as a resume rebuilds it (the twin, as phase 6's); then
    one known-bad sequence (an undo-commit persist over a dirty payload)
    must raise ``CommitBeforePayloadError``, and the twin takes the
    remaining steps without a manager. Then a crash run and a torn run under
    ``FaultSchedule.seeded(seed, POINTS, every=SOAK_EVERY)``: after the
    ``InjectedCrash`` the pool is power-cycled and recovered under the
    checker, at step SOAK_RECOVERED with gap 0 and a mirror bitwise the
    twin's tables, and resumed to step SOAK_STEPS, whose losses must be the
    twin's bitwise and run U's within the reference soak's gap-0 bound
    (rtol 1e-5, atol 1e-6), and whose mirror must be the twin's tables
    bitwise. Returns (run U's launches, the phase's numbers)."""
    import gc
    import shutil
    import tempfile

    from repro_torch.analysis import CheckedPool, CommitBeforePayloadError
    from repro_torch.core.checkpoint import recovery
    from repro_torch.core.checkpoint.manager import CheckpointManager
    from repro_torch.data.lookahead import LookaheadIterator
    from repro_torch.data.synthetic import DLRMBatches
    from repro_torch.examples.pool_soak import POINTS
    from repro_torch.models.registry import get_api
    from repro_torch.pool import FaultSchedule, InjectedCrash
    from repro_torch.pool import undo_codec as uc
    from repro_torch.training import train_loop
    from repro_torch.tree import tree_map

    tag = "[soak]"
    cfg = cfg.replace(dtype="float32")
    T, R, d = cfg.dlrm_num_tables, cfg.dlrm_rows_per_table, cfg.dlrm_bottom_mlp[-1]
    mirror_gb = T * R * d * 4 / 1e9
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    # RAM: a pool's cache (2 x mirror), the recovered mirror and three host
    # copies of the tables (run U's mirror, the twin's at both ends)
    host_room(tag, "checked soak phase", build, 8 * mirror_gb, 2 * mirror_gb)
    work = tempfile.mkdtemp(prefix="soak-ckpt-", dir=build)
    out = {"pool_compress": "none", "steps": SOAK_STEPS}

    def fresh():
        gen = torch.Generator(device=dev)
        gen.manual_seed(tc.seed)
        state = train_loop.make_step_fns(cfg, tc)[0](get_api(cfg).init(gen, cfg))
        torch.cuda.synchronize()
        return state

    def config(name):
        return dataclasses.replace(tc, checkpoint=dataclasses.replace(
            tc.checkpoint, directory=os.path.join(work, name), dense_interval=1,
            pool_backend="pmem", pool_compress="none"))

    def run(tcx, state, mgr, start=0):
        batches = LookaheadIterator(DLRMBatches(cfg, Bsz, seed=0, device=dev), cfg,
                                    depth=SOAK_STEPS - start + 1, start_step=start)
        state, losses = train_loop_train(cfg, tcx, batches, SOAK_STEPS - start,
                                         state, mgr, None, start=start)
        if mgr is not None:
            mgr.flush()
        return state, losses

    def host_tables(state):
        return state["embed"]["emb_tables"].to("cpu", copy=True).numpy().reshape(-1, d)

    prev = os.environ.get("REPRO_POOL_CHECK")
    os.environ["REPRO_POOL_CHECK"] = "1"          # as a user sets it
    tier_e, clocks = [], []
    try:
        # -- run U: uninterrupted, under the checker ----------------------------
        t0 = time.perf_counter()
        tcu = config("U")
        state = fresh()
        mgr = CheckpointManager(cfg, tcu.checkpoint, embed_init=state["embed"])
        check(isinstance(mgr.pool, CheckedPool), f"{tag} REPRO_POOL_CHECK=1 gave a "
              f"{type(mgr.pool).__name__}, not a CheckedPool")
        load_s = time.perf_counter() - t0
        clocks.append(clock_tracker(mgr.pool.tracker))
        times, twin = {}, {}
        time_manager(mgr, times)
        timed_on_step = mgr.on_step

        def on_step(step, st, feed):
            timed_on_step(step, st, feed)
            if step == SOAK_RECOVERED:
                # the step the faulted runs recover: the tables on the host,
                # and a twin on the card with its relaxed carry dropped (the
                # tables and the dense tree are updated in place: cloned)
                twin["rows"] = host_tables(st)
                twin["state"] = {
                    **st, "prefetch": None,
                    "step": torch.tensor(step + 1, dtype=torch.int32, device=dev),
                    "embed": {"emb_tables": st["embed"]["emb_tables"].clone()},
                    "dense": tree_map(torch.clone, st["dense"]),
                    "opt_dense": tree_map(torch.clone, st["opt_dense"])}
        mgr.on_step = on_step
        zero_row_counts()
        state, lu = run(tcu, state, mgr)
        c = row_counts()
        launches = {k: c[k] for k in checkpointed_launches(SOAK_STEPS)}
        check(launches == checkpointed_launches(SOAK_STEPS),
              f"{tag} run U: unexpected launch counts {launches}")
        check(c["scatter_update_wide"] == c["scatter_update"]
              and c["gather_rows_wide"] == c["gather_rows"]
              and c["scatter_update_logged_wide"] == c["scatter_update_logged"],
              f"{tag} run U: a row kernel launch off the 16-byte route: {c}")
        check(all(math.isfinite(x) for x in lu), f"{tag} run U: non-finite loss {lu}")
        mirror_u = np.array(mgr.mirror_rows)
        check(np.array_equal(mirror_u, host_tables(state)), f"{tag} run U: mirror "
              "differs from the tables on the card")
        del state
        tier_e += times["_do_tier_e"]
        tracker = mgr.pool.tracker
        out["U"] = {"s": time.perf_counter() - t0, "mirror_load_s": load_s,
                    "losses": lu, "tier_e_ms": times["_do_tier_e"],
                    "tier_m_ms": times["_do_tier_m"], "events": dict(tracker.events),
                    "tracker_s": clocks[0]["s"],
                    "dirty_intervals_max": clocks[0]["dirty_intervals_max"],
                    "live_regions": len(tracker.live)}
        print(f"{tag} run U: {SOAK_STEPS} checked steps of full rm1 (f32 tables) in "
              f"{out['U']['s']:.2f}s (mirror load {load_s:.2f}s); losses {lu}; "
              f"launches {launches}")
        print(f"{tag} run U: tier-E ms {times['_do_tier_e']}, tier-M ms "
              f"{times['_do_tier_m']}; tracker events {tracker.events}, "
              f"{clocks[0]['s']:.3f}s inside the tracker, at most "
              f"{clocks[0]['dirty_intervals_max']} dirty intervals at a mirror "
              f"apply, {len(tracker.live)} live regions")

        # -- the negative check: a COMMIT over a dirty payload --------------------
        ring = mgr.ring.ring
        buf, _, _ = uc.pack_slot(SOAK_STEPS, np.arange(4, dtype=np.int64),
                                 np.ones((4, d), np.float32), None, mode="none",
                                 slot_bytes=1024)
        mgr.pool.write(ring.off, buf)             # the payload, never persisted
        mgr.pool.write(ring.off + uc.COMMIT_OFF, uc.COMMIT_SET)
        try:
            mgr.pool.persist(ring.off + uc.COMMIT_OFF, 4, point="undo-commit")
            raised = None
        except CommitBeforePayloadError as e:
            raised = str(e)
        check(raised is not None, f"{tag} an undo-commit over a dirty payload in "
              "the full-width ring raised nothing")
        print(f"{tag} negative check: CommitBeforePayloadError: {raised}")
        out["negative_check"] = "CommitBeforePayloadError"
        mgr.close()
        del mgr
        gc.collect()
        shutil.rmtree(os.path.join(work, "U"))

        # -- the twin: run U's state after step SOAK_RECOVERED, carry rebuilt -----
        state, lt = run(tcu, twin.pop("state"), None, start=SOAK_RECOVERED + 1)
        twin["final"] = host_tables(state)
        del state
        gc.collect()
        torch.cuda.empty_cache()
        out["twin_losses"] = lt
        print(f"{tag} twin: run U's state after step {SOAK_RECOVERED}, carry "
              f"rebuilt, to step {SOAK_STEPS}: losses {lt} (run U's "
              f"{lu[SOAK_RECOVERED + 1:]})")

        # -- the faulted runs ---------------------------------------------------------
        for kind, seed in SOAK_SEEDS:
            t0 = time.perf_counter()
            name = f"{kind}{seed}"
            tcf = config(name)
            faults = FaultSchedule.seeded(seed, POINTS, every=SOAK_EVERY, kind=kind)
            state = fresh()
            mgr = CheckpointManager(cfg, tcf.checkpoint, embed_init=state["embed"],
                                    faults=faults)
            clocks.append(clock_tracker(mgr.pool.tracker))
            crashed = False
            try:
                run(tcf, state, mgr)
            except InjectedCrash:
                crashed = True
            check(crashed, f"{tag} {name}: the seeded {kind} never fired")
            fired = [(ev.point, n, ev.kind) for ev, n in faults.fired]
            del state
            mgr.pool.crash()                       # power-cycle the device
            mgr.pool.faults = None
            t = time.perf_counter()
            rec = recovery.recover(tcf.checkpoint.directory, pool=mgr.pool)
            rec_s = time.perf_counter() - t
            check(isinstance(rec.pool, CheckedPool), f"{tag} {name}: recovery's "
                  "pool is not checked")
            print(f"{tag} {name}: fired {fired}; recovered under the checker in "
                  f"{rec_s:.2f}s: mirror_step {rec.mirror_step}, dense_step "
                  f"{rec.dense_step}, rolled_back {rec.rolled_back}, gap {rec.gap}")
            rec_info = {"mirror_step": rec.mirror_step, "dense_step": rec.dense_step,
                        "rolled_back": rec.rolled_back, "gap": rec.gap}
            check(rec_info == {"mirror_step": SOAK_RECOVERED,
                               "dense_step": SOAK_RECOVERED,
                               "rolled_back": kind == "torn", "gap": 0},
                  f"{tag} {name}: recovered {rec_info}, want step {SOAK_RECOVERED} "
                  "at gap 0, rolled back after the torn apply only")
            check(np.array_equal(rec.embed_rows, twin["rows"]), f"{tag} {name}: "
                  f"recovered mirror differs from run U's tables after step "
                  f"{SOAK_RECOVERED}")
            state, start = recovery.resume_train_state(rec, fresh())
            check(start == SOAK_RECOVERED + 1, f"{tag} {name}: resume step {start}")
            times = {}
            t = time.perf_counter()
            mgr2 = CheckpointManager(cfg, tcf.checkpoint, pool=rec.pool)
            mgr2.init_mirror(state["embed"], step=rec.mirror_step)
            resume_load_s = time.perf_counter() - t
            time_manager(mgr2, times)
            del rec
            state, tail = run(tcf, state, mgr2, start=start)
            del state
            tier_e += times["_do_tier_e"]
            mirror = np.asarray(mgr2.mirror_rows)
            same_mirror = np.array_equal(mirror, twin["final"])
            from_u = float(np.abs(mirror - mirror_u).max())
            del mirror
            mgr2.close()
            with contextlib.suppress(InjectedCrash):
                mgr.close()                        # its writer thread ends
            del mgr, mgr2
            gc.collect()
            shutil.rmtree(os.path.join(work, name))
            rel = max(abs(a - b) / max(abs(b), 1e-6)
                      for a, b in zip(tail, lu[start:], strict=True))
            out[name] = {"s": time.perf_counter() - t0, "fired": fired, **rec_info,
                         "recover_s": rec_s, "resume_step": start,
                         "resume_mirror_load_s": resume_load_s, "tail_losses": tail,
                         "tail_rel_from_U": rel, "mirror_abs_from_U": from_u,
                         "tier_e_ms": times["_do_tier_e"], "tracker_s": clocks[-1]["s"]}
            print(f"{tag} {name}: resumed at step {start} (mirror load "
                  f"{resume_load_s:.2f}s), losses {tail}: the twin's {lt}, run U's "
                  f"{lu[start:]} (largest relative difference {rel:.3g}); mirror at "
                  f"step {SOAK_STEPS} bitwise the twin's: {same_mirror}, from run "
                  f"U's at most {from_u:.3g}; run {out[name]['s']:.2f}s")
            check(tail == lt, f"{tag} {name}: resumed losses differ from the twin's")
            check(all(abs(a - b) <= 1e-6 + 1e-5 * abs(b)
                      for a, b in zip(tail, lu[start:], strict=True)),
                  f"{tag} {name}: resumed losses {rel:.3g} from run U's, beyond the "
                  "soak's gap-0 bound (rtol 1e-5, atol 1e-6)")
            check(same_mirror, f"{tag} {name}: the mirror at step {SOAK_STEPS} "
                  "differs from the twin's tables")
        checked_s = [ms / 1e3 for ms in tier_e]
        out["tier_e_s_checked"] = checked_s
        out["tier_e_s_phase6"] = [ms / 1e3 for ms in pmem_tier_e_ms]
        out["tracker_s_per_tier_e"] = sum(c["s"] for c in clocks) / max(
            1, sum(c["mirror_applies"] for c in clocks))
        print(f"{tag} tier-E s per step, checked: {checked_s}; phase 6, unchecked "
              f"(bf16 tables, the same f32 mirror): {out['tier_e_s_phase6']}; inside "
              f"the tracker {out['tracker_s_per_tier_e']:.3f}s per tier-E")
    finally:
        if prev is None:
            os.environ.pop("REPRO_POOL_CHECK", None)
        else:
            os.environ["REPRO_POOL_CHECK"] = prev
        shutil.rmtree(work, ignore_errors=True)
    return launches, out


DIST_WORLD = 2
DIST_RULES = {"batch": None, "cache_seq": "model"}
DIST_JAMBA = ("jamba-v0.1-52b", 8)   # phase 22's depth
# Phase 24's gates, each a share of the one-rank run's largest magnitude,
# set from the differences measured on an H100 80GB HBM3 at 700 W, none
# above 1.5e-2. The prefill is bitwise (0 in two
# runs): the ranks run its arithmetic unchanged (the lookup's rows plus
# zeros, a top-2 token's two expert outputs added once, in f32, and
# rounded). The decode steps' logits on the rows routed alike (6.44e-3)
# and the first MoE input after the attention layer on every row
# (6.99e-3) differ by the order of context-parallel decode's softmax
# sums. rm1's logits were equal (0), but its bags sum their items in two
# groups, so an element may round the other way in bf16.
DIST_PREFILL_TOL = 0.0
DIST_DECODE_TOL = 1e-2
DIST_MOE_INPUT_TOL = 1e-2
DIST_RM1_TOL = 1e-3


def dist_counts(zero=False):
    """The launch counters of the kernels on phase 24's paths (flash also
    counts its tensor-core route); with ``zero`` they are set to 0 first."""
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gather_rows as gr
    counters = (("gather_rows", gr, "launches"), ("embedding_bag", eb, "launches"),
                ("flash_attention", fa, "launches"), ("flash_attention_tc", fa, "tc_launches"))
    if zero:
        for _, mod, attr in counters:
            setattr(mod, attr, 0)
    return {k: getattr(mod, attr) for k, mod, attr in counters}


def moved_since(mesh, before):
    """{collective: {"calls", "bytes"}} the mesh moved since ``before``
    (an earlier ``mesh.stats()``)."""
    now = mesh.stats()
    return {k: {f: v[f] - before.get(k, {}).get(f, 0) for f in ("calls", "bytes")}
            for k, v in now.items() if v["calls"] != before.get(k, {}).get("calls", 0)}


def decode_routing(cfg, routed, steps):
    """From ``moe.recording``'s records of a prefill and ``steps`` decode
    steps: each step's experts in every MoE layer, sorted, (steps, n_moe,
    B, k), and each step's input to the first MoE layer after the
    attention layer, (steps, B, d) f32, on the host."""
    import torch

    moe_layers = [i for i, f in enumerate(cfg.ffn_types) if f == "moe"]
    n = len(moe_layers)
    first = next(j for j, i in enumerate(moe_layers) if i >= cfg.layer_types.index("attn"))
    dec = routed[n:]
    check(len(dec) == n * steps, f"[dist] {len(dec)} MoE records for {steps} decode steps")
    choices = torch.stack([r["choice"].sort(-1).values for r in dec])
    return (choices.reshape(steps, n, *choices.shape[1:]).cpu(),
            torch.stack([dec[s * n + first]["x"].float() for s in range(steps)]).cpu())


def teacher_forced(torch, api, cfg, params, prompt, toks, device):
    """A prefill of ``prompt`` and a decode step on each of ``toks`` but
    the last, at positions S, S + 1, ... (the greedy run's inputs, given):
    (the (B, steps + 1, V) f32 logits, ``decode_routing``'s records)."""
    from repro_torch.models import moe

    B, S = prompt.shape
    steps = toks.shape[1] - 1
    with torch.no_grad(), moe.recording() as routed:
        caches = api.init_cache(cfg, B, S + steps + 1, device)
        logits, caches = api.prefill(params, cfg, prompt, caches)
        out = [logits]
        for s in range(steps):
            logits, caches = api.decode_step(params, cfg, toks[:, s:s + 1], S + s, caches)
            out.append(logits)
        return torch.stack(out, 1).cpu(), decode_routing(cfg, routed, steps)


def dist_rank(rank, world, device, work, rm1_seed):
    """Phase 24, one rank of ``world`` gloo ranks sharing ``device``. Serves
    full-width jamba-v0.1-52b at phase 22's depth under DIST_RULES (its
    vocab rows and experts cut as drawn, so no rank holds the whole model):
    a warm-up, three greedy generations (the first counted by part: kernel
    launches, collective calls and bytes), then a prefill and decode steps
    teacher-forced on phase 22's tokens. Then full rm1's forward with its
    table rows cut (phase 4's params, ``rm1_seed``). Rank 0 also holds the
    shards' gather and bag, and flash at jamba's prefill shape, against
    their plain versions and times them while rank 1 waits. Writes its
    results to ``work/rank{rank}.pt``; any failure raises (or exits) and
    fails the spawn."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.core import embedding_ops
    from repro_torch.data.synthetic import make_batches
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import dlrm
    from repro_torch.models.registry import get_api
    from repro_torch.training.serve_loop import greedy_generate
    from repro_torch.tree import tree_leaves

    mesh = make_local_mesh(model_parallel=world, device=device)
    keep = sharding.keep_shard(mesh)
    one = torch.load(os.path.join(work, "one_rank.pt"), weights_only=True)
    out = {"backend": mesh.backend, "world": world, "device": str(device),
           "name": torch.cuda.get_device_name(device)}
    err = {"gather_rows": 0.0, "embedding_bag": 0.0, "flash_attention_tc": 0.0}
    timing = {}

    # (a) jamba at full width, its vocab rows and experts cut as drawn
    arch, layers = DIST_JAMBA
    cfg = get_arch(arch).model.replace(num_layers=layers)
    api = get_api(cfg)
    ref_toks = one["toks"].to(device)
    B, new, S = ref_toks.shape[0], ref_toks.shape[1], int(one["S"])
    torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(0)                       # phase 22's params
    params = api.init(gen, cfg, keep=keep)
    torch.cuda.synchronize(device)
    leaves = tree_leaves(params)
    table = params["embed"]["table"]
    out["init_s"] = time.perf_counter() - t
    out["init_peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    out["params"] = sum(p.numel() for p in leaves)
    out["params_gb"] = sum(p.numel() * p.element_size() for p in leaves) / 1e9
    out["vocab_rows"] = table.shape[0]
    out["experts"] = [g["moe"]["wi"].shape[1] for g in params["groups"] if "moe" in g]
    prompt = make_batches(cfg, B, S, device=device).next(0)["tokens"]

    parts = {}

    @contextlib.contextmanager
    def count(name):
        k0, m0 = dist_counts(), mesh.stats()
        yield
        parts[name] = {"kernels": {k: v - k0[k] for k, v in dist_counts().items()},
                       "moved": moved_since(mesh, m0)}

    walls = []
    with sharding.use_sharding(mesh, DIST_RULES), torch.no_grad():
        greedy_generate(cfg, params, prompt, 2, max_seq=S + new)      # warm-up
        dist_counts(zero=True)
        stats = {}
        toks = greedy_generate(cfg, params, prompt, new, max_seq=S + new, stats=stats,
                               part=count)
        out["launches"] = dist_counts()
        walls.append((stats["prefill_s"], stats["decode_s"]))
        for _ in range(2):
            again = {}
            toks2 = greedy_generate(cfg, params, prompt, new, max_seq=S + new, stats=again)
            check(torch.equal(toks, toks2) and torch.equal(stats["logits"], again["logits"]),
                  f"[dist] rank {rank}: a second generation gave other tokens or logits")
            walls.append((again["prefill_s"], again["decode_s"]))
        out["forced"], (out["choices"], out["moe_input"]) = teacher_forced(
            torch, api, cfg, params, prompt, ref_toks, device)
    out["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    out["toks"], out["parts"] = toks.cpu(), parts
    out["prefill_ms_runs"] = [1e3 * p for p, _ in walls]
    out["decode_ms_per_token_runs"] = [1e3 * d / (new - 1) for _, d in walls]
    del stats

    dist.barrier()
    if rank == 0:
        # the shard's row gather at the prefill's and a decode step's shape:
        # the ids the near-data lookup hands it, clipped into the shard
        rows_local = table.shape[0]
        row_bytes = table.shape[1] * table.element_size()
        for name, ids in (("prefill", prompt.reshape(-1)), ("decode", toks[:, 0])):
            idx = (ids.long() - mesh.axis_index("model") * rows_local) \
                .clamp(0, rows_local - 1).to(torch.int32).contiguous()
            got, want = ops.gather_rows(table, idx), ref.gather_rows_ref(table, idx)
            check(torch.equal(got, want), f"[dist] gather_rows {name}: not bitwise equal")
            n_rows = torch.unique(idx).numel()
            timing[f"gather_jamba_shard_{name}"] = flash_timing(
                torch, "[dist]", f"gather_jamba_shard_{name}",
                lambda idx=idx: ops.gather_rows(table, idx),
                lambda idx=idx: ref.gather_rows_ref(table, idx),
                lambda idx=idx: torch.index_select(table, 0, idx),
                bound(idx.numel() * 4 + (n_rows + idx.numel()) * row_bytes, 0),
                f"{idx.numel()} ids ({n_rows} distinct) of the shard "
                f"{tuple(table.shape)} {table.dtype}")
        # flash at jamba's prefill shape (k, v as the projections give them)
        Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        g = torch.Generator(device=device)
        g.manual_seed(0)
        q, k, v = (torch.randn((B, S, h, D), generator=g, device=device)
                   .to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
        fl = ops.flash_attention(q, k, v)
        want = ref.flash_attention_ref(q, k, v)
        torch.testing.assert_close(fl, want)
        err["flash_attention_tc"] = (fl.float() - want.float()).abs().max().item()
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        nops = 4 * D * B * Hq * S * (S + 1) / 2
        timing["flash_jamba_ranks"] = flash_timing(
            torch, "[dist]", "flash_jamba_ranks", lambda: ops.flash_attention(q, k, v),
            lambda: ref.flash_attention_ref(q, k, v),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                   enable_gqa=True),
            bound(flash_fwd_bytes(B, S, S, Hq, Hkv, D), nops, BF16_TENSOR_OPS_PER_S),
            f"forward B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} bf16, k and v contiguous")
        del q, k, v, qt, kt, vt, fl, want
    dist.barrier()
    del params, table, leaves
    torch.cuda.empty_cache()

    # (b) full rm1's forward, each rank its block of every table's rows
    cfg = get_arch("dlrm-rm1").model
    gen = torch.Generator(device=device)
    gen.manual_seed(rm1_seed)                # phase 4's params
    params = get_api(cfg).init(gen, cfg, keep=keep)
    batch = {k: v.to(device) for k, v in one["rm1_batch"].items()}
    tables = params["embed"]["emb_tables"]
    T, R_loc, d = tables.shape
    flat, seg = embedding_ops.local_bag_items(batch["sparse"], mesh.axis_index("model")
                                              * R_loc, R_loc, R_loc, 0)
    out["rm1_rows"], out["rm1_items"] = R_loc, flat.numel()
    dist_counts(zero=True)
    m0 = mesh.stats()
    with sharding.use_sharding(mesh, DIST_RULES), torch.no_grad():
        out["rm1_logits"] = dlrm.forward(params, cfg, batch).float().cpu()
    out["rm1_launches"] = dist_counts()
    out["rm1_moved"] = moved_since(mesh, m0)
    dist.barrier()
    if rank == 0:
        nb, N = batch["sparse"].shape[0] * T, flat.numel()
        table2 = tables.reshape(T * R_loc, d)
        got = ops.embedding_bag(table2, flat, seg, nb)
        want = ref.embedding_bag_ref(table2, flat, seg, nb)
        diff = (got - want).abs()
        check(bool((diff <= 1e-5 + 1e-5 * want.abs()).all()),
              f"[dist] embedding_bag: max abs err {diff.max().item():.3g}")
        err["embedding_bag"] = diff.max().item()
        offsets = torch.searchsorted(seg, torch.arange(nb, dtype=torch.int32, device=device))
        n_rows = torch.unique(flat).numel()
        timing["bag_rm1_shard"] = flash_timing(
            torch, "[dist]", "bag_rm1_shard",
            lambda: ops.embedding_bag(table2, flat, seg, nb),
            lambda: ref.embedding_bag_ref(table2, flat, seg, nb),
            lambda: F.embedding_bag(flat, table2, offsets, mode="sum"),
            bound(N * 4 * 2 + n_rows * d * table2.element_size() + nb * d * 4, N * d),
            f"{N} items ({n_rows} distinct rows) of the shard {tuple(table2.shape)} "
            f"{table2.dtype} into {nb} bags")
    dist.barrier()
    out["err"], out["timing"] = err, timing
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))


def dist_phase(torch, np, dev, tc, served, metrics):
    """Phase 24: serving under a mesh, two gloo ranks on this one card
    (``dist_rank``), held against the one-rank runs: jamba's tokens and
    logits from phase 22 (``served``; its medians in ``metrics``) and
    rm1's forward of phase 4's params, run here first. Returns (rank 0's
    launches by path, its timings, its kernel errors, the metrics)."""
    import shutil
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import DLRMBatches, make_batches
    from repro_torch.launch import mesh
    from repro_torch.models import dlrm
    from repro_torch.models.registry import get_api

    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="dist-", dir=build)
    toks, logits = served
    try:
        # phase 22's run again, teacher-forced on its own tokens (so its
        # logits bitwise), for the routing of each decode step
        arch, layers = DIST_JAMBA
        cfg = get_arch(arch).model.replace(num_layers=layers)
        api = get_api(cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = api.init(gen, cfg)
        prompt = make_batches(cfg, toks.shape[0], 1024, device=dev).next(0)["tokens"]
        one, (one_choices, one_input) = teacher_forced(torch, api, cfg, params, prompt,
                                                       toks.to(dev), dev)
        check(torch.equal(one, logits), "[dist] the one-rank run, teacher-forced on its "
              "own tokens, did not repeat phase 22's logits bitwise")
        del params, one
        torch.cuda.empty_cache()

        cfg = get_arch("dlrm-rm1").model
        gen = torch.Generator(device=dev)
        gen.manual_seed(tc.seed)
        params = get_api(cfg).init(gen, cfg)
        batch = DLRMBatches(cfg, 128, seed=0, device=dev).next(0)
        with torch.no_grad():
            rm1_logits = dlrm.forward(params, cfg, batch).float().cpu()
        del params
        torch.save({"toks": toks, "logits": logits, "S": 1024,
                    "rm1_batch": {k: batch[k].cpu() for k in ("dense", "sparse")}},
                   os.path.join(work, "one_rank.pt"))
        del batch
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        mesh.spawn(dist_rank, DIST_WORLD, backend="gloo", device=f"cuda:{dev.index or 0}",
                   args=(work, tc.seed))
        spawn_s = time.perf_counter() - t
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=True)
                 for r in range(DIST_WORLD)]
    finally:
        shutil.rmtree(work, ignore_errors=True)

    r0 = ranks[0]
    arch, layers = DIST_JAMBA
    jcfg, rcfg = get_arch(arch).model, get_arch("dlrm-rm1").model
    print(f"[dist] backend {r0['backend']}, world size {r0['world']}, the ranks' devices "
          f"{[r['device'] for r in ranks]} ({r0['name']}); spawn to the last rank's "
          f"end {spawn_s:.1f}s")
    for r, res in enumerate(ranks):
        print(f"[dist] rank {r}: {arch} at {layers} layers holds {res['vocab_rows']} of "
              f"{jcfg.vocab_size} vocab rows and {res['experts']} of "
              f"{jcfg.moe.num_experts} experts a MoE layer: {res['params']} params "
              f"({res['params_gb']:.2f} GB), init {res['init_s']:.1f}s peaking at "
              f"{res['init_peak_gb']:.2f} GB, serving peak {res['peak_gb']:.2f} GB; rm1 "
              f"{res['rm1_rows']} rows a table, {res['rm1_items']} of the batch's items")
        check(res["vocab_rows"] * DIST_WORLD == jcfg.vocab_size
              and all(e * DIST_WORLD == jcfg.moe.num_experts for e in res["experts"]),
              f"[dist] rank {r} holds other shards than its half")
        check(res["rm1_rows"] * DIST_WORLD == rcfg.dlrm_rows_per_table,
              f"[dist] rank {r} holds other rm1 rows than its half")
    check(sum(r["rm1_items"] for r in ranks)
          == 128 * rcfg.dlrm_num_tables * rcfg.dlrm_num_sparse,
          "[dist] the ranks' rm1 items do not add up to the batch's")
    for res in ranks[1:]:
        check(torch.equal(res["toks"], r0["toks"]) and torch.equal(res["forced"], r0["forced"])
              and torch.equal(res["rm1_logits"], r0["rm1_logits"]),
              "[dist] the ranks disagree")

    # jamba against phase 22's one-rank run. A decode step's logits are
    # held on the rows routed alike in both runs (the same experts in every
    # MoE layer), as phase 22 holds decode against prefill: with random
    # weights the routing sits near ties, and context-parallel decode sums
    # the softmax in another order, so a row's bf16 attention output may
    # round the other way and flip its experts. Every row's input to the
    # first MoE layer after the attention layer (before any routing can
    # differ) is held on every step.
    forced = r0["forced"]
    scale = logits.abs().max().item()
    pre = (forced[:, 0] - logits[:, 0]).abs().max().item() / scale
    alike = (r0["choices"] == one_choices).all(-1).all(1).T           # (B, steps)
    row_diff = (forced[:, 1:] - logits[:, 1:]).abs().amax(-1)        # (B, steps)
    dec_all = row_diff.max().item() / scale
    dec = (row_diff[alike].max().item() if alike.any() else 0.0) / scale
    x_share = (r0["moe_input"] - one_input).abs().max().item() / one_input.abs().max().item()
    same = r0["toks"] == toks
    # a greedy token may differ only at or after a step where phase 22's top
    # two logits were within twice the decode gate (a near-tie) or the
    # teacher-forced runs routed the row otherwise
    top2 = logits.topk(2, dim=-1).values
    loose = (top2[..., 0] - top2[..., 1]) <= 2 * DIST_DECODE_TOL * scale
    loose[:, 1:] |= ~alike
    after_loose = loose.int().cumsum(dim=1) > 0
    out = {"prefill_logits_share": pre, "decode_logits_share_routed_alike": dec,
           "decode_logits_share_all_rows": dec_all, "decode_steps_routed_alike":
           int(alike.sum()), "decode_steps": alike.numel(), "moe_input_share": x_share,
           "tokens_equal": int(same.sum()), "tokens": same.numel(),
           "near_ties_or_rerouted": int(loose.sum()),
           "prefill_ms_runs": r0["prefill_ms_runs"],
           "decode_ms_per_token_runs": r0["decode_ms_per_token_runs"],
           "prefill_ms_median": statistics.median(r0["prefill_ms_runs"]),
           "decode_ms_per_token_median": statistics.median(r0["decode_ms_per_token_runs"]),
           "one_rank_prefill_ms_median": metrics["prefill_ms_median"],
           "one_rank_decode_ms_per_token_median": metrics["decode_ms_per_token_median"],
           "parts": r0["parts"], "spawn_s": spawn_s}
    print(f"[dist] {arch} vs phase 22's one-rank run: prefill logits max abs diff {pre:.4g} "
          f"of the largest logit {scale:.4g} (gate {DIST_PREFILL_TOL}); teacher-forced decode "
          f"{dec:.4g} on the {out['decode_steps_routed_alike']} of {alike.numel()} row-steps "
          f"routed alike (gate {DIST_DECODE_TOL}; {dec_all:.4g} over all); the first MoE "
          f"input after attention {x_share:.4g} of its largest (gate {DIST_MOE_INPUT_TOL}); "
          f"greedy tokens equal {out['tokens_equal']} of {out['tokens']} "
          f"({out['near_ties_or_rerouted']} near-ties or rerouted row-steps)")
    print(f"[dist] two ranks: prefill ms {r0['prefill_ms_runs']}, decode ms a token "
          f"{r0['decode_ms_per_token_runs']}; medians {out['prefill_ms_median']:.2f}, "
          f"{out['decode_ms_per_token_median']:.2f}; one rank (phase 22) "
          f"{metrics['prefill_ms_median']:.2f}, {metrics['decode_ms_per_token_median']:.2f}")
    n_dec = toks.shape[1] - 1
    for name, part in r0["parts"].items():
        per = 1 if name == "prefill" else n_dec
        print(f"[dist] {name}: launches {part['kernels']}; collectives a "
              f"{'prefill' if per == 1 else 'decode step'}: " + json.dumps(
                  {k: {"calls": v["calls"] / per, "bytes": v["bytes"] / per}
                   for k, v in part["moved"].items()}))

    # rm1 against the one-rank forward
    T, d = rcfg.dlrm_num_tables, rcfg.dlrm_bottom_mlp[-1]
    rm1_scale = rm1_logits.abs().max().item()
    rm1_diff = (r0["rm1_logits"] - rm1_logits).abs().max().item()
    moved = r0["rm1_moved"]
    out.update(rm1_logits_share=rm1_diff / rm1_scale, rm1_moved=moved,
               rm1_items=[r["rm1_items"] for r in ranks])
    print(f"[dist] rm1 forward, batch 128: items a rank {out['rm1_items']}; all-reduced "
          f"{json.dumps(moved)} (B*T*d*4 = {128 * T * d * 4}); logits vs one rank: max abs "
          f"diff {rm1_diff:.4g} of the largest {rm1_scale:.4g} (share {rm1_diff / rm1_scale:.4g},"
          f" gate {DIST_RM1_TOL}); launches {r0['rm1_launches']}")

    check(pre <= DIST_PREFILL_TOL, "[dist] prefill logits differ from phase 22's")
    check(dec <= DIST_DECODE_TOL, "[dist] teacher-forced decode logits differ from phase "
          "22's on the rows routed alike")
    check(x_share <= DIST_MOE_INPUT_TOL, "[dist] the first MoE input after attention "
          "differs from phase 22's")
    check(bool((same | after_loose).all()), "[dist] a greedy token differs from phase 22's "
          "before any near-tie or rerouting")
    want = {"prefill": {"gather_rows": 1, "embedding_bag": 0, "flash_attention": 1,
                        "flash_attention_tc": 1},
            "decode": {"gather_rows": n_dec, "embedding_bag": 0, "flash_attention": 0,
                       "flash_attention_tc": 0}}
    check({k: p["kernels"] for k, p in r0["parts"].items()} == want,
          f"[dist] {arch}: want one gather a forward and one flash a prefill (its one "
          f"attention layer), got {r0['parts']}")
    check(moved == {"all_reduce_sum": {"calls": 1, "bytes": 128 * T * d * 4}},
          "[dist] rm1's near-data bag moved other than one B*T*d f32 all-reduce")
    check(rm1_diff <= DIST_RM1_TOL * rm1_scale, "[dist] rm1 logits differ from one rank's")
    from repro_torch.kernels import embedding_bag as eb
    check(r0["rm1_launches"]["embedding_bag"] == eb.PASSES,
          f"[dist] rm1: want one bag call ({eb.PASSES} launches), got {r0['rm1_launches']}")
    launches = {"gather_prefill": r0["parts"]["prefill"]["kernels"]["gather_rows"],
                "gather_decode": r0["parts"]["decode"]["kernels"]["gather_rows"],
                "flash_prefill": r0["parts"]["prefill"]["kernels"]["flash_attention_tc"],
                "bag": r0["rm1_launches"]["embedding_bag"]}
    return launches, r0["timing"], r0["err"], out


DIST_TRAIN_RULES = {"batch": ("data",)}
DIST_TRAIN_BATCH = 128
DIST_TRAIN_STEPS = 4
DIST_TRAIN_CRASH = 1       # the writer crashes between step 1's COMMIT and apply
DIST_TRAIN_RESUMED = 2
# phase 25's gates: the losses within tests/test_relaxed.py:39's rtol, the
# gathered tables within 1e-5 of the largest table value (f32 tables; bf16
# relaxed and strict differ from step 1, ROADMAP section 3)
DIST_TRAIN_LOSS_RTOL = 2e-5
DIST_TRAIN_TABLE_TOL = 1e-5


def stats_since(mesh, before):
    """{collective: {"calls", "bytes", "s"}} the mesh moved since ``before``
    (an earlier ``mesh.stats()``)."""
    now = mesh.stats()
    return {k: {f: v[f] - before.get(k, {}).get(f, 0) for f in ("calls", "bytes", "s")}
            for k, v in now.items() if v["calls"] != before.get(k, {}).get("calls", 0)}


def dist_train_rank(rank, world, device, work, seed):
    """Phase 25, one rank of ``world`` gloo ranks sharing ``device``: full
    dlrm-rm1 with f32 tables at batch 128. The one-rank run (every rank
    runs it alone, for its own reference), then DIST_TRAIN_STEPS relaxed
    steps through ``train_loop.train`` under (data, model) = (1, 2), each
    rank its half of every table's rows, and under (2, 1), each rank the
    tables whole and half of every batch; each rank holds its tables
    against the one-rank run's. Then a crash drill at (1, 2) into a pmem
    pool through one writer (``MeshCheckpoint``): the writer crashes
    between step DIST_TRAIN_CRASH's undo COMMIT and its mirror apply,
    every rank stops there, recovery at both ranks (``recover_on_mesh``),
    DIST_TRAIN_RESUMED steps resumed. Rank 0 also holds the sparse tier's
    kernels on its block against their plain versions and times them.
    Writes its results to ``work/rank{rank}.pt``."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import CheckpointConfig, TrainConfig
    from repro_torch.core import embedding_ops
    from repro_torch.core.checkpoint.manager import check_undo_images, undo_image
    from repro_torch.core.checkpoint.undo_log import UndoRing
    from repro_torch.data.lookahead import LookaheadIterator
    from repro_torch.data.synthetic import DLRMBatches
    from repro_torch.distributed import sharding
    from repro_torch.distributed.checkpoint import MeshCheckpoint, recover_on_mesh
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.registry import get_api
    from repro_torch.pool import FaultSchedule, InjectedCrash
    from repro_torch.pool.allocator import PoolAllocator
    from repro_torch.training import train_loop

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("dlrm-rm1").model.replace(dtype="float32")
    tc = TrainConfig(learning_rate=1e-3, embed_learning_rate=0.05, seed=seed)
    T, R, d = cfg.dlrm_num_tables, cfg.dlrm_rows_per_table, cfg.dlrm_bottom_mlp[-1]
    steps, writer = DIST_TRAIN_STEPS, rank == 0
    meshes = {"1x2": make_local_mesh(model_parallel=2, device=device),
              "2x1": make_local_mesh(model_parallel=1, device=device)}
    out = {"device": str(device), "runs": {}}
    err = {"embedding_bag": 0.0, "scatter_update": 0.0, "scatter_update_logged": 0.0,
           "gather_rows": 0.0}

    def say(msg):
        print(f"[dist-train] rank {rank}: {msg}", flush=True)

    def draw(mesh=None):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)                       # phase 4's params, f32
        kw = {} if mesh is None else {"keep": sharding.keep_shard(mesh, DIST_TRAIN_RULES)}
        state = train_loop.make_step_fns(cfg, tc)[0](get_api(cfg).init(gen, cfg, **kw))
        torch.cuda.synchronize(device)
        return state

    def run(name, state, mesh=None, mgr=None, n=steps, start=0, on_step=None):
        """``n`` relaxed steps from ``start`` (the batches made first), each
        step's host seconds (the first with the warm-up) and collectives."""
        batches = LookaheadIterator(DLRMBatches(cfg, DIST_TRAIN_BATCH, seed=0,
                                                device=device), cfg, depth=n + 1,
                                    start_step=start)
        times, moved = [], []
        torch.cuda.synchronize(device)
        mark = [time.perf_counter(), mesh.stats() if mesh is not None else {}]

        def on_metrics(k, m):
            if on_step is not None:
                on_step(k, m)
            torch.cuda.synchronize(device)
            now = time.perf_counter()
            times.append(now - mark[0])
            if mesh is not None:
                moved.append(stats_since(mesh, mark[1]))
                mark[1] = mesh.stats()
            mark[0] = time.perf_counter()
        try:
            state, losses = train_loop.train(cfg, tc, batches, n, state=state,
                                             start_step=start, ckpt_manager=mgr,
                                             on_metrics=on_metrics)
        finally:
            out["runs"][name] = {"step_s": times, "moved": moved}
        out["runs"][name]["losses"] = losses
        return state

    # (a) one rank, no context
    torch.cuda.reset_peak_memory_stats(device)
    state = run("one", draw())
    one = state["embed"]["emb_tables"]
    del state
    torch.cuda.empty_cache()
    scale = one.abs().max().item()
    out["one_peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    say(f"one-rank run done, losses {out['runs']['one']['losses']}")

    # (b) (1, 2): each rank its half of every table's rows; (c) (2, 1)
    for name in ("1x2", "2x1"):
        mesh = meshes[name]
        torch.cuda.reset_peak_memory_stats(device)
        with sharding.use_sharding(mesh, DIST_TRAIN_RULES):
            state = draw(mesh)
            zero_row_counts()
            state = run(name, state, mesh)
            c = row_counts()
            out["runs"][name]["launches"] = {k: c[k] for k in (
                "embedding_bag", "scatter_update", "scatter_update_wide",
                "scatter_update_logged", "scatter_update_logged_wide")}
        held = state["embed"]["emb_tables"]
        base = mesh.axis_index("model") * held.shape[1] if held.shape[1] != R else 0
        diff = (held - one[:, base:base + held.shape[1]]).abs().max().item()
        out["runs"][name].update(rows_held=held.shape[1], table_diff=diff,
                                 table_share=diff / scale,
                                 peak_gb=torch.cuda.max_memory_allocated(device) / 1e9)
        if name == "1x2":
            block = held
        del state, held
        torch.cuda.empty_cache()
        say(f"{name} run done, losses {out['runs'][name]['losses']}, table diff {diff:.4g}")

    # (d) the sparse tier's kernels on rank 0's block, at the main path's
    # shapes: batch 0's items in the block, against their plain versions
    mesh = meshes["1x2"]
    mesh.barrier()
    if writer:
        R_held = block.shape[1]
        table = block.reshape(T * R_held, d)
        ids = DLRMBatches(cfg, DIST_TRAIN_BATCH, seed=0, device=device).next(0)["sparse"]
        flat, seg = embedding_ops.local_bag_items(ids, 0, R_held, R_held, 0)
        N_all, N = ids.numel(), flat.numel()
        # bag-row gradients of a training step's size (the loss is a mean
        # over the batch), as phase 3 draws them
        g = torch.randn((ids.shape[0] * T, d), generator=torch.Generator(device=device)
                        .manual_seed(0), device=device) * 1e-3
        sorted_idx, order = torch.sort(flat, stable=True)
        first = torch.ones(N, dtype=torch.bool, device=device)
        first[1:] = sorted_idx[1:] != sorted_idx[:-1]
        comb_seg = torch.cumsum(first, 0, dtype=torch.int32) - 1
        comb_src = seg[order].contiguous()
        comb_starts = torch.nonzero(first).flatten().to(torch.int32)
        got = ops.embedding_bag(g, comb_src, comb_seg, N)
        want = ref.embedding_bag_ref(g, comb_src, comb_seg, N)
        diff = (got - want).abs()
        check(bool((diff <= 1e-5 + 1e-5 * want.abs()).all())
              and torch.equal(got, ops.embedding_bag(g, comb_src, comb_seg, N)),
              f"[dist-train] embedding_bag (duplicate combine): max abs err "
              f"{diff.max().item():.3g}")
        err["embedding_bag"] = diff.max().item()
        # the library's bags are the distinct rows; the kernel's N outputs
        # beyond them are zero
        lib_out = torch.nn.functional.embedding_bag(comb_src, g, comb_starts, mode="sum")
        k = lib_out.shape[0]
        check(bool(((lib_out - want[:k]).abs() <= 1e-5 + 1e-5 * want[:k].abs()).all()),
              "[dist-train] the library's duplicate combine differs from the plain one")
        del lib_out
        uniq, comb = ops.combine_duplicates(flat, g, item_rows=seg)
        n = int((uniq >= 0).sum())
        pad = N_all - N                         # the trainer pads to the items
        uniq = torch.cat([uniq, uniq.new_full((pad,), -1)])
        upd = torch.cat([-0.05 * comb, comb.new_zeros((pad, d))])
        real = uniq[:n].long()
        t_tab = table.clone()
        want_t, want_old = ref.scatter_update_logged_ref(t_tab.clone(), uniq, upd)
        _, old = ops.scatter_update_logged(t_tab, uniq, upd)
        check(torch.equal(t_tab, want_t) and torch.equal(old.view(torch.int32),
                                                         want_old.view(torch.int32)),
              "[dist-train] scatter_update_logged on the block: not bitwise equal")
        scratch = torch.zeros_like(table)
        want_s = ref.scatter_update_ref(scratch.clone(), uniq, upd)
        ops.scatter_update(scratch, uniq, upd)
        check(torch.equal(scratch, want_s), "[dist-train] scatter_update on the "
              "block's scratch: not bitwise equal")
        ids_local = uniq[:n].contiguous()
        check(torch.equal(ops.gather_rows(t_tab, ids_local),
                          ref.gather_rows_ref(t_tab, ids_local)),
              "[dist-train] gather_rows on the block: not bitwise equal")
        ops.scatter_update(scratch, uniq, -upd)
        check(not scratch.any().item(), "[dist-train] the block's scratch not cleared")
        nb = ids.shape[0] * T
        out["block"] = {"table": list(table.shape), "items": N, "items_all": N_all,
                        "rows": n, "bags": nb}
        shapes = {
            # idx and seg once, each bag row once, the f32 output
            "bag_combine_rm1_block": (
                lambda: ops.embedding_bag(g, comb_src, comb_seg, N),
                lambda: ref.embedding_bag_ref(g, comb_src, comb_seg, N),
                lambda: torch.nn.functional.embedding_bag(comb_src, g, comb_starts,
                                                          mode="sum"),
                bound(N * 4 * 2 + nb * d * 4 + N * d * 4, N * d)),
            # a real slot: its id, its f32 delta, the row read, written and
            # logged; a pad: its id and a zero undo row
            "update_logged_rm1_block": (
                lambda: ops.scatter_update_logged(t_tab, uniq, upd),
                lambda: ref.scatter_update_logged_ref(t_tab, uniq, upd),
                lambda: (t_tab.index_select(0, real), t_tab.index_add_(0, real, upd[:n])),
                bound(n * (4 + d * 16) + (N_all - n) * (4 + d * 4), n * d)),
            "scratch_update_rm1_block": (
                lambda: ops.scatter_update(scratch, uniq, upd),
                lambda: ref.scatter_update_ref(scratch, uniq, upd),
                lambda: scratch.index_add_(0, real, upd[:n]),
                bound(N_all * 4 + n * d * 12, n * d)),
            # the ids once, each touched row read once and written once
            "gather_rm1_block": (
                lambda: ops.gather_rows(t_tab, ids_local),
                lambda: ref.gather_rows_ref(t_tab, ids_local),
                lambda: torch.index_select(t_tab, 0, ids_local),
                bound(n * 4 + 2 * n * d * 4, 0)),
        }
        say(f"the block's kernels hold against their plain versions: {out['block']}")
        out["timing"] = time_shapes(torch, "[dist-train]", shapes)
        del t_tab, scratch, want_t, want_old, want_s, old, g, got, want
    del block
    torch.cuda.empty_cache()
    mesh.barrier()

    # (e) the crash drill at (1, 2) through one writer, into a pmem pool
    cc = CheckpointConfig(directory=os.path.join(work, "ckpt"), dense_interval=1,
                          pool_backend="pmem", pool_compress="none")
    tc = dataclasses.replace(tc, checkpoint=cc)
    images, snap = {}, {}
    torch.cuda.reset_peak_memory_stats(device)
    with sharding.use_sharding(mesh, DIST_TRAIN_RULES):
        state = draw(mesh)
        faults = FaultSchedule.crash_at("tier_e.between-commit-and-apply",
                                        occurrence=DIST_TRAIN_CRASH + 1)
        mgr = MeshCheckpoint(cfg, cc, embed_init=state["embed"],
                             faults=faults if writer else None)
        out["mirror_load_s"] = mgr.stats["mirror_load_s"]
        mgr.add_feed_hook(lambda k, feed: images.__setitem__(k, undo_image(feed)))
        table = state["embed"]["emb_tables"]          # updated in place

        def keep(k, _):
            if k == DIST_TRAIN_CRASH - 1:
                snap["tables"] = table.clone()
        zero_row_counts()
        out["crashed"] = False
        try:
            run("crash", state, mesh, mgr, n=DIST_TRAIN_CRASH + 1, on_step=keep)
        except InjectedCrash:
            out["crashed"] = True
            mgr.manager.pool.close()                  # the writer's process death
        c = row_counts()
        out["ckpt_launches"] = {k: c[k] for k in ("gather_rows", "gather_rows_wide")}
        say(f"checkpointed run done, crashed {out['crashed']}")
        out["gather_s"] = mgr.stats["gather_s"]
        del state, table, mgr
        torch.cuda.empty_cache()
        t = time.perf_counter()
        state, start, rec = recover_on_mesh(cfg, cc.directory, draw(mesh))
        torch.cuda.synchronize(device)
        out["recover_s"] = time.perf_counter() - t
        out["resume_at"] = start
        out["recovered_bitwise"] = torch.equal(state["embed"]["emb_tables"], snap["tables"])
        del snap
        if writer:
            out["rec"] = [rec.mirror_step, rec.dense_step, rec.rolled_back]
            ring = UndoRing(PoolAllocator(rec.pool), cc.max_undo_logs)
            out["undo_checked"] = check_undo_images(ring, images)
            rec.pool.close()
        del images
        state = run("resumed", state, mesh, n=DIST_TRAIN_RESUMED, start=start)
    out["ckpt_peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    out["err"] = err
    del state
    mesh.barrier()
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))


def dist_train_phase(torch, np, dev, tc):
    """Phase 25: full dlrm-rm1 (f32 tables) trained under a mesh, two gloo
    ranks on this one card (``dist_train_rank``), held against the
    one-rank run. Returns (rank 0's launches by path, its timings, its
    kernel errors, the metrics)."""
    import shutil
    import tempfile

    from repro_torch.launch import mesh

    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    R_mirror_gb = 20 * 1_000_000 * 32 * 4 / 1e9
    # RAM: the writer's host mirror, the pool's image, the recovered mirror
    host_room("[dist-train]", "phase 25", build, 5 * R_mirror_gb, 2.5 * R_mirror_gb)
    work = tempfile.mkdtemp(prefix="dist-train-", dir=build)
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        mesh.spawn(dist_train_rank, DIST_WORLD, backend="gloo",
                   device=f"cuda:{dev.index or 0}", args=(work, tc.seed), timeout=600)
        spawn_s = time.perf_counter() - t
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
                 for r in range(DIST_WORLD)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return dist_train_report(ranks, spawn_s)


def dist_train_report(ranks, spawn_s):
    """Phase 25's results from its ranks: printed, held to the gates."""
    from repro_torch.configs import get_arch
    R = get_arch("dlrm-rm1").model.dlrm_rows_per_table
    tag, r0 = "[dist-train]", ranks[0]
    one = r0["runs"]["one"]["losses"]
    out = {"spawn_s": spawn_s, "one_losses": one, "block": r0.get("block"),
           "mirror_load_s": r0["mirror_load_s"], "recover_s": [r["recover_s"] for r in ranks],
           "gather_s": r0["gather_s"], "peak_gb": {}}
    print(f"{tag} two gloo ranks on {[r['device'] for r in ranks]}; spawn to the last "
          f"rank's end {spawn_s:.1f}s; one-rank losses {one}")
    for name in ("1x2", "2x1"):
        loss_gap = max(abs(a - b) / abs(b) for r in ranks
                       for a, b in zip(r["runs"][name]["losses"], one, strict=True))
        table_share = max(r["runs"][name]["table_share"] for r in ranks)
        out[name] = {"losses": r0["runs"][name]["losses"], "loss_rel_gap": loss_gap,
                     "table_share": table_share,
                     "rows_held": [r["runs"][name]["rows_held"] for r in ranks],
                     "step_ms": [[1e3 * s for s in r["runs"][name]["step_s"]] for r in ranks],
                     "moved_per_step": r0["runs"][name]["moved"],
                     "peak_gb": [r["runs"][name]["peak_gb"] for r in ranks]}
        print(f"{tag} (data, model) = ({name[0]}, {name[2]}): rows held a table "
              f"{out[name]['rows_held']}; losses {out[name]['losses']}; max relative gap "
              f"to the one-rank run {loss_gap:.4g} (gate {DIST_TRAIN_LOSS_RTOL}); tables' max "
              f"abs diff {table_share:.4g} of the largest value (gate {DIST_TRAIN_TABLE_TOL}); "
              f"peak GB a rank {out[name]['peak_gb']}")
        print(f"{tag} {name} step ms a rank {out[name]['step_ms']} (the first with the "
              f"warm-up); one rank {[1e3 * s for s in r0['runs']['one']['step_s']]}")
        print(f"{tag} {name} rank 0's collectives a step: "
              + json.dumps(out[name]["moved_per_step"]))
    out["one_step_ms"] = [1e3 * s for s in r0["runs"]["one"]["step_s"]]
    out["one_peak_gb"] = [r["one_peak_gb"] for r in ranks]
    out["ckpt_peak_gb"] = [r["ckpt_peak_gb"] for r in ranks]
    crash, res = r0["runs"]["crash"], r0["runs"]["resumed"]
    full = r0["runs"]["1x2"]["losses"]
    want = full[DIST_TRAIN_CRASH:DIST_TRAIN_CRASH + DIST_TRAIN_RESUMED]
    res_gap = max(abs(a - b) / abs(b) for r in ranks
                  for a, b in zip(r["runs"]["resumed"]["losses"], want, strict=True))
    out.update(crash_losses=crash["losses"] if "losses" in crash else None,
               crash_step_ms=[1e3 * s for s in crash["step_s"]],
               crash_moved_per_step=crash["moved"], resumed_losses=res["losses"],
               resumed_rel_gap=res_gap, rec=r0["rec"], undo_checked=r0["undo_checked"])
    print(f"{tag} crash drill at (1, 2), one writer: mirror load {r0['mirror_load_s']:.2f}s "
          f"(rank 1 {ranks[1]['mirror_load_s']:.2f}s); step ms with the checkpoint "
          f"{out['crash_step_ms']}; the writer's gather and merge {r0['gather_s']:.3f}s in "
          f"all; crashed {r0['crashed']}; recovered (mirror step, dense step, rolled back) "
          f"{r0['rec']} in {out['recover_s']} s a rank; blocks bitwise the tables after "
          f"step {DIST_TRAIN_CRASH - 1}: {[r['recovered_bitwise'] for r in ranks]}; undo "
          f"entries equal to the ranks' images {r0['undo_checked']}; resumed at "
          f"{[r['resume_at'] for r in ranks]}: losses {res['losses']} vs {want} "
          f"(gap {res_gap:.4g}, gate {DIST_TRAIN_LOSS_RTOL}); peak GB a rank "
          f"{out['ckpt_peak_gb']}")
    print(f"{tag} rank 0's collectives a checkpointed step: "
          + json.dumps(crash["moved"]))
    for name in ("1x2", "2x1"):
        check(out[name]["loss_rel_gap"] <= DIST_TRAIN_LOSS_RTOL,
              f"{tag} {name}: losses differ from the one-rank run's")
        check(out[name]["table_share"] <= DIST_TRAIN_TABLE_TOL,
              f"{tag} {name}: tables differ from the one-rank run's")
    check(out["1x2"]["rows_held"] == [R // 2] * 2 and out["2x1"]["rows_held"] == [R] * 2,
          f"{tag} the ranks hold other rows than their blocks")
    check(r0["crashed"] and not ranks[1]["crashed"], f"{tag} the writer did not crash "
          "alone at the scheduled step")
    check(r0["rec"] == [DIST_TRAIN_CRASH - 1, DIST_TRAIN_CRASH - 1, True],
          f"{tag} recovered {r0['rec']}")
    check(all(r["recovered_bitwise"] for r in ranks), f"{tag} a recovered block differs "
          "from the tables the rank held at the last committed step")
    check(r0["undo_checked"] == DIST_TRAIN_CRASH + 1, f"{tag} {r0['undo_checked']} undo "
          "entries checked")
    check(all(r["resume_at"] == DIST_TRAIN_CRASH for r in ranks), f"{tag} resume step")
    check(res_gap <= DIST_TRAIN_LOSS_RTOL, f"{tag} resumed losses differ from the "
          "uninterrupted run's")
    from repro_torch.kernels import embedding_bag as eb
    n = DIST_TRAIN_STEPS
    want_l = {"embedding_bag": (1 + 3 * n) * eb.PASSES, "scatter_update": 2 * n,
              "scatter_update_wide": 2 * n, "scatter_update_logged": n,
              "scatter_update_logged_wide": n}
    for name in ("1x2", "2x1"):
        got_l = [r["runs"][name]["launches"] for r in ranks]
        check(all(g == want_l for g in got_l),
              f"{tag} {name} launches a rank {got_l}, want {want_l}")
    ck = r0["ckpt_launches"]
    check(ck == {"gather_rows": DIST_TRAIN_CRASH + 1, "gather_rows_wide": DIST_TRAIN_CRASH + 1},
          f"{tag} checkpoint gathers {ck}")
    print(f"{tag} rank 0's launches, (1, 2) run: {r0['runs']['1x2']['launches']}; (2, 1) "
          f"run: {r0['runs']['2x1']['launches']}; checkpointed run: {ck}")
    launches = {"bag": r0["runs"]["1x2"]["launches"]["embedding_bag"],
                "update": r0["runs"]["1x2"]["launches"]["scatter_update"],
                "logged": r0["runs"]["1x2"]["launches"]["scatter_update_logged"],
                "gather": ck["gather_rows"]}
    return launches, r0["timing"], r0["err"], out


TP_ARCH = "tinyllama-1.1b"
TP_WORLD = 2
TP_B, TP_S = 1, 1024          # the training batch (cut from phase 12's 4 x 1024)
# serving: phase 8's batch 4 and prompt 1024, 16 new tokens (cut from 32
# for the script's time; each decode step a rank is 0.22 s)
TP_SERVE_B, TP_NEW = 4, 16
TP_STEPS = 2                  # strict steps, then relaxed ones, from the seed's params
TP_CRASH = 1                  # the writer crashes between step 1's COMMIT and apply
CP_RULES = {"batch": None, "cache_seq": "model"}
# Phase 27's gates, each set from the differences measured on an H100 80GB
# HBM3 at 700 W against the one-rank run of the same steps (when a rank
# still rounded its row-parallel output to bf16 before the f32 sum; in
# f32 the two-rank losses were the one-rank ones to the bit). The losses'
# relative gap (measured 5.1e-4); step 0's gradient norm, taken before any
# update (5.7e-4); each leaf's
# mean difference as a share of its largest magnitude (1.41e-3); the least
# share, over the leaves that moved, of a leaf's moved elements whose
# update after the steps has the one-rank update's sign (0.9939:
# AdamW's first steps move an element by about the learning rate whatever
# its gradient's size, so an element whose gradient is near zero moves
# either way on a rounding, and the largest difference, 0.256 of a leaf's
# largest, is printed but not a gate; the bf16 norms at 1.0 do not move
# by 1e-3, and the replicated leaves and their moments are held bitwise
# across the ranks instead); the logits of
# serving and of context-parallel decode, teacher-forced on the one-rank
# tokens, on every row as a share of the largest logit (1.33e-2 and
# 1.07e-2). A greedy token may differ only where the one-rank logits tie
# within the two runs' difference (bf16 logits tie exactly: the first
# differing token measured had a top-2 gap of 0)
TP_LOSS_RTOL = 2e-3
TP_NORM0_RTOL = 2e-3
TP_PARAM_MEAN = 3e-3
TP_SIGN_MIN = 0.98
TP_LOGIT_TOL = 3e-2
CP_LOGIT_TOL = 2.5e-2


def tp_counts(zero=False):
    """The launch counters of phase 27's kernels (flash by route and
    direction, the row kernels); with ``zero`` they are set to 0 first."""
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gather_rows as gr
    from repro_torch.kernels import scatter_update as su
    counters = (("flash_attention_tc", fa, "tc_launches"),
                ("flash_attention_bwd", fa, "bwd_launches"),
                ("gather_rows", gr, "launches"), ("embedding_bag", eb, "launches"),
                ("scatter_update", su, "launches"),
                ("scatter_update_logged", su, "launches_logged"))
    if zero:
        for _, mod, attr in counters:
            setattr(mod, attr, 0)
    return {k: getattr(mod, attr) for k, mod, attr in counters}


def tp_rank(rank, world, device, work, seed):
    """Phase 27, one rank of ``world`` gloo ranks sharing ``device``:
    full-width tinyllama-1.1b under dense tensor parallelism and the
    Megatron-SP residual stream, the rules the port's ``build_rules`` gives
    its profile at (data, model) = (1, 2). Rank 0 first runs the one-rank
    reference alone (TP_STEPS strict steps, a greedy generation). Then
    both ranks: TP_STEPS strict and TP_STEPS relaxed steps from the seed's
    params (each rank drawing the whole model's random stream and keeping
    its blocks), the crash drill through one writer (tier-E only), serving
    under the decode rules, and context-parallel decode teacher-forced on
    the one-rank tokens. Rank 0 holds the kernels at its shapes against
    their plain versions and times them. Writes ``work/rank{rank}.pt``."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import SHAPES, CheckpointConfig, TrainConfig
    from repro_torch.data.lookahead import LookaheadIterator
    from repro_torch.data.synthetic import make_batches
    from repro_torch.distributed import sharding
    from repro_torch.distributed.checkpoint import (MeshCheckpoint, _whole_leaves,
                                                    recover_on_mesh)
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.registry import get_api
    from repro_torch.pool import FaultSchedule, InjectedCrash
    from repro_torch.training import train_loop
    from repro_torch.kernels import gather_rows as gr
    from repro_torch.training.serve_loop import greedy_generate
    from repro_torch.training.state import split_params
    from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

    torch.backends.cuda.matmul.allow_tf32 = False
    bundle = get_arch(TP_ARCH)
    cfg = bundle.model
    tc = TrainConfig(embed_learning_rate=0.05, seed=seed)
    api = get_api(cfg)
    writer = rank == 0
    mesh = make_local_mesh(model_parallel=world, device=device)
    train_rules, _, _ = dryrun.build_rules(bundle, SHAPES["train_4k"], mesh)
    serve_rules, _, _ = dryrun.build_rules(bundle, SHAPES["decode_32k"], mesh)
    out = {"device": str(device), "train_rules": train_rules, "serve_rules": serve_rules,
           "runs": {}}

    def say(msg):
        print(f"[tp] rank {rank}: {msg}", flush=True)

    def params(rules=None):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        kw = {} if rules is None else {"keep": sharding.keep_shard(mesh, rules)}
        p = api.init(gen, cfg, **kw)
        torch.cuda.synchronize(device)
        return p

    def run(name, state, relaxed, n=TP_STEPS, start=0, mgr=None, on_step=None):
        """``n`` steps from ``start`` (the batches made first): losses,
        gradient norms, each step's host ms and collectives, launches."""
        batches = LookaheadIterator(make_batches(cfg, TP_B, TP_S, device=device), cfg,
                                    depth=n + 2, start_step=start)
        rec = out["runs"][name] = {"losses": [], "norms": [], "step_ms": [], "moved": []}
        torch.cuda.synchronize(device)
        tp_counts(zero=True)
        ctx = sharding.current()
        mark = [time.perf_counter(), mesh.stats() if ctx else {}]

        def on_metrics(k, m):
            rec["losses"].append(float(m["loss"]))
            rec["norms"].append(float(m["grad_norm"]))
            if on_step is not None:
                on_step(k, m)
            torch.cuda.synchronize(device)
            rec["step_ms"].append(1e3 * (time.perf_counter() - mark[0]))
            if ctx is not None:
                rec["moved"].append(stats_since(mesh, mark[1]))
                mark[1] = mesh.stats()
            mark[0] = time.perf_counter()
        try:
            state, _ = train_loop.train(cfg, tc, batches, n, relaxed=relaxed, state=state,
                                        start_step=start, ckpt_manager=mgr,
                                        on_metrics=on_metrics)
        finally:
            rec["launches"] = tp_counts()
        return state

    def generate(p, rules=None):
        prompt = make_batches(cfg, TP_SERVE_B, TP_S, device=device).next(0)["tokens"]
        parts = {}

        @contextlib.contextmanager
        def part(name):
            # each part's launches: the counts before and after it
            before = tp_counts()
            yield
            parts[name] = {k: v - before[k] for k, v in tp_counts().items()}
        with torch.no_grad():
            greedy_generate(cfg, p, prompt, 2, max_seq=TP_S + TP_NEW)       # warm-up
            tp_counts(zero=True)
            before = mesh.stats()
            st = {}
            toks = greedy_generate(cfg, p, prompt, TP_NEW, stats=st, part=part)
            return {"tokens": toks, "logits": st["logits"],
                    "prefill_ms": 1e3 * st["prefill_s"],
                    "decode_ms": 1e3 * st["decode_s"] / (TP_NEW - 1),
                    "launches": tp_counts(), "parts": parts,
                    "moved": stats_since(mesh, before)}

    def replicated_equal(state):
        """The replicated dense leaves and their AdamW moments that differ
        from rank 0's, bit for bit (every rank calls it)."""
        differ = []

        def same(path, x):
            if not sharding.is_tp_leaf(path):
                got = mesh.broadcast(x.clone(), mesh.axis_names, 0)
                if not torch.equal(x, got):
                    differ.append(path)
                return 1
            return 0
        n = sum(tree_leaves(tree_map_with_path(same, {
            "dense": state["dense"], "m": state["opt_dense"]["m"],
            "v": state["opt_dense"]["v"]})))
        return {"leaves": n, "differ": differ}

    def whole(state):
        return {"dense": _whole_leaves(state["dense"], cfg),
                "table": mesh.all_gather(state["embed"]["table"], "model", 0)}

    # (a) the one-rank reference, rank 0 alone
    ref_one = {}
    if writer:
        t = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(device)
        init_fn = train_loop.make_step_fns(cfg, tc)[0]
        state = run("one", init_fn(params()), relaxed=False)
        ref_one["dense"] = tree_map(torch.clone, state["dense"])
        ref_one["table"] = state["embed"]["table"].clone()
        out["one_peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
        del state
        torch.cuda.empty_cache()
        p = params()
        ref_one["serve"] = generate(p)
        del p
        torch.cuda.empty_cache()
        out["one_serve"] = {k: v for k, v in ref_one["serve"].items()
                            if k not in ("tokens", "logits")}
        out["one_s"] = time.perf_counter() - t
        say(f"one-rank reference: losses {out['runs']['one']['losses']}, prefill "
            f"{out['one_serve']['prefill_ms']:.1f} ms, decode "
            f"{out['one_serve']['decode_ms']:.2f} ms a token")
    mesh.barrier()

    # (b) TP + SP training, strict then relaxed from the same params
    t = time.perf_counter()
    kept = None
    with sharding.use_sharding(mesh, train_rules):
        for name, relaxed in (("strict", False), ("relaxed", True)):
            torch.cuda.reset_peak_memory_stats(device)
            state = train_loop.make_step_fns(cfg, tc)[0](params(train_rules))
            if name == "strict":
                out["held"] = {"wq": list(state["dense"]["blocks"]["attn"]["wq"].shape),
                               "wo": list(state["dense"]["blocks"]["attn"]["wo"].shape),
                               "wi": list(state["dense"]["blocks"]["mlp"]["wi"].shape),
                               "lm_head": list(state["dense"]["lm_head"].shape),
                               "table": list(state["embed"]["table"].shape),
                               "adam_m_wq": list(state["opt_dense"]["m"]["blocks"]["attn"]
                                                 ["wq"].shape)}
            state = run(name, state, relaxed)
            out["runs"][name]["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
            out["runs"][name]["replicated"] = replicated_equal(state)
            local = {"dense": state["dense"], "table": state["embed"]["table"]}
            if name == "strict":
                # the params re-gathered whole, against the one-rank run's:
                # each leaf's differences, and the share of its elements
                # that moved in the one-rank run whose update has that
                # run's sign (the updates from the seed's params)
                w = whole(state)
                if writer:
                    dense0, embed0 = split_params(params())
                    gaps, signs = [], []
                    for a, b, z in zip(tree_leaves(w), tree_leaves(
                            {"dense": ref_one.pop("dense"), "table": ref_one.pop("table")}),
                            tree_leaves({"dense": dense0, "table": embed0["table"]}),
                            strict=True):
                        s_ = b.float().abs().max().item() or 1.0
                        d = (a.float() - b.float()).abs()
                        gaps.append((d.max().item() / s_, d.mean().item() / s_))
                        ua, ub = a.float() - z.float(), b.float() - z.float()
                        moved = int((ub != 0).sum())
                        if moved:
                            signs.append(int(((ua.sign() == ub.sign()) & (ub != 0)).sum())
                                         / moved)
                        del d, ua, ub
                    del dense0, embed0
                    out["param_max_share"] = max(g[0] for g in gaps)
                    out["param_mean_share"] = max(g[1] for g in gaps)
                    out["sign_agree_min"] = min(signs)
                    out["sign_leaves"] = [len(signs), len(gaps)]
                del w
                kept = tree_map(torch.clone, local)
            else:
                out["relaxed_is_strict"] = (
                    out["runs"]["relaxed"]["losses"] == out["runs"]["strict"]["losses"]
                    and all(torch.equal(a, b) for a, b in zip(
                        tree_leaves(local), tree_leaves(kept), strict=True)))
                batch0 = sharding.shard_batch(
                    make_batches(cfg, TP_B, TP_S, device=device).next(0), mesh, train_rules)
                block = state["embed"]["table"].clone()
            del state, local
            torch.cuda.empty_cache()
            say(f"{name}: losses {out['runs'][name]['losses']}")
    del kept
    torch.cuda.empty_cache()
    out["train_s"] = time.perf_counter() - t

    # (c) the crash drill through one writer, tier-E only (a full-width
    # tier-M of tinyllama is about 13 GB): the writer crashes between step
    # TP_CRASH's undo COMMIT and its mirror apply
    t = time.perf_counter()
    cc = CheckpointConfig(directory=os.path.join(work, "ckpt"), dense_interval=0,
                          pool_backend="pmem", pool_compress="none")
    snap = {}
    with sharding.use_sharding(mesh, train_rules):
        state = train_loop.make_step_fns(cfg, tc)[0](params(train_rules))
        faults = FaultSchedule.crash_at("tier_e.between-commit-and-apply",
                                        occurrence=TP_CRASH + 1)
        mgr = MeshCheckpoint(cfg, cc, embed_init=state["embed"],
                             faults=faults if writer else None)
        out["mirror_load_s"] = mgr.stats["mirror_load_s"]
        out["ckpt_gathers"] = 0
        inner = mgr.on_step

        def counted(step, st, feed):
            # the checkpoint's own gathers: the count before and after each call
            before = gr.launches
            try:
                return inner(step, st, feed)
            finally:
                out["ckpt_gathers"] += gr.launches - before
        mgr.on_step = counted

        def keep(k, _):
            if k == TP_CRASH - 1:   # the twin: the state after this step, in place
                snap["table"] = state["embed"]["table"].clone()
                snap["dense"] = tree_map(torch.clone, state["dense"])
                snap["opt_dense"] = {**tree_map(torch.clone, {
                    "m": state["opt_dense"]["m"], "v": state["opt_dense"]["v"]}),
                    "t": torch.tensor(k + 1, dtype=torch.int32, device=device)}
        out["crashed"] = False
        try:
            run("crash", state, relaxed=True, n=TP_CRASH + 1, mgr=mgr, on_step=keep)
        except InjectedCrash:
            out["crashed"] = True
            mgr.manager.pool.close()           # the writer's process death
        out["gather_s"] = mgr.stats["gather_s"]
        del state, mgr
        torch.cuda.empty_cache()
        t_rec = time.perf_counter()
        fresh = train_loop.make_step_fns(cfg, tc)[0](params(train_rules))
        # no tier-M: the dense tree comes from the twin, the table from the pool
        fresh = {**fresh, "dense": snap.pop("dense"), "opt_dense": snap.pop("opt_dense")}
        state, start, rec = recover_on_mesh(cfg, cc.directory, fresh)
        torch.cuda.synchronize(device)
        out["recover_s"] = time.perf_counter() - t_rec
        out["resume_at"] = start
        out["recovered_bitwise"] = torch.equal(state["embed"]["table"], snap.pop("table"))
        if writer:
            out["rec"] = [rec.mirror_step, rec.dense_step, rec.rolled_back]
            rec.pool.close()
        state = run("resumed", state, relaxed=True, n=1, start=start)
        del state, fresh
    torch.cuda.empty_cache()
    out["drill_s"] = time.perf_counter() - t
    say(f"crash drill: crashed {out['crashed']}, resumed at {out['resume_at']}, "
        f"losses {out['runs']['resumed']['losses']}")

    # (d) serving under the decode rules (heads and kv heads over model; the
    # cache holds the rank's kv heads over every position), then
    # context-parallel decode teacher-forced on the one-rank tokens
    t = time.perf_counter()
    with sharding.use_sharding(mesh, serve_rules):
        p = params(serve_rules)
        got = generate(p)
        out["serve"] = {k: v for k, v in got.items() if k not in ("tokens", "logits")}
        del p
    torch.cuda.empty_cache()
    one_tokens = mesh.broadcast(ref_one["serve"]["tokens"] if writer else
                                got["tokens"].new_empty(got["tokens"].shape),
                                mesh.axis_names, 0)
    with sharding.use_sharding(mesh, serve_rules):
        p = params(serve_rules)
        prompt = make_batches(cfg, TP_SERVE_B, TP_S, device=device).next(0)["tokens"]
        forced = forced_logits(torch, api, cfg, p, prompt, one_tokens, device)
        del p
    torch.cuda.empty_cache()
    if writer:
        want = ref_one["serve"]
        scale = want["logits"].abs().max().item()
        gap = (forced - want["logits"].cpu()).abs()
        out["serve"]["logit_share"] = gap.max().item() / scale
        out["serve"]["prefill_logit_share"] = gap[:, 0].max().item() / scale
        # the greedy tokens: equal, or apart from the first position at which
        # the one-rank run's two best logits lie closer than the two runs'
        # logits there do (a near tie)
        same = got["tokens"] == want["tokens"]
        out["serve"]["tokens_equal"] = int(same.sum())
        out["serve"]["tokens"] = int(same.numel())
        cols = torch.nonzero(~same.all(dim=0)).flatten()
        out["serve"]["first_differing"] = None
        if cols.numel():
            t0_ = int(cols[0])
            rows = torch.nonzero(~same[:, t0_]).flatten().tolist()
            top2 = want["logits"][rows, t0_].topk(2, dim=-1).values
            out["serve"]["first_differing"] = {
                "position": t0_, "rows": rows,
                "top2_gap": (top2[:, 0] - top2[:, 1]).tolist(),
                "logit_gap": gap[rows, t0_].amax(dim=-1).tolist()}
    del got
    with sharding.use_sharding(mesh, CP_RULES):
        p = params(CP_RULES)
        prompt = make_batches(cfg, TP_SERVE_B, TP_S, device=device).next(0)["tokens"]
        tp_counts(zero=True)
        logits = forced_logits(torch, api, cfg, p, prompt, one_tokens, device)
        out["cp"] = {"launches": tp_counts(),
                     "cache_positions": (TP_S + TP_NEW) // world}
        del p
    if writer:
        out["cp"]["logit_share"] = (logits - want["logits"].cpu()).abs().max().item() / scale
        out["cp"]["rows"] = int(logits.shape[0] * logits.shape[1])
    out["serve_s"] = time.perf_counter() - t
    torch.cuda.empty_cache()

    # (e) rank 0: the kernels at its shapes against their plain versions, timed
    if writer:
        serve_ids = {"prefill": make_batches(cfg, TP_SERVE_B, TP_S,
                                             device=device).next(0)["tokens"],
                     "decode": one_tokens[:, 0]}
        out["timing"], out["err"], out["shapes"] = tp_kernels(torch, device, cfg, block,
                                                              batch0, serve_ids)
        del block
    mesh.barrier()
    out["stats"] = mesh.stats()
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))


def forced_logits(torch, api, cfg, params, prompt, toks, device):
    """A prefill of ``prompt`` and a decode step on each of ``toks`` but
    the last, at positions S, S + 1, ... (a greedy run's inputs, given):
    the (B, steps + 1, V) f32 logits on the host."""
    B, S = prompt.shape
    steps = toks.shape[1] - 1
    with torch.no_grad():
        caches = api.init_cache(cfg, B, S + steps + 1, device)
        logits, caches = api.prefill(params, cfg, prompt, caches)
        out = [logits]
        for s in range(steps):
            logits, caches = api.decode_step(params, cfg, toks[:, s:s + 1], S + s, caches)
            out.append(logits)
        return torch.stack(out, 1).cpu()


def tp_kernels(torch, device, cfg, block, batch, serve_ids, tag="[tp]", key="tp",
               heads=None, train=(TP_B, TP_S), serve=(TP_SERVE_B, TP_S)):
    """Phase 27's kernels at rank 0's shapes (its 16 of 32 query heads and 2
    of 4 kv heads, its (16000, 2048) bf16 vocab block), each against its
    plain version and timed beside its bound and one library call. The
    lookups are the near-data lookup's: the training batch's ids, the
    serving prefill's (``serve_ids["prefill"]``, B x S) and a decode step's
    (``serve_ids["decode"]``, B), each clamped into the block. Phase 28
    calls it at its own rank's shapes: ``heads`` (query, kv heads of a
    rank), ``train`` and ``serve`` (a rank's batch and sequence), its
    names ending in ``key``."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    err = {"flash_attention_tc": 0.0, "flash_attention_bwd_tc": 0.0, "gather_rows": 0.0,
           "embedding_bag": 0.0, "scatter_update": 0.0, "scatter_update_logged": 0.0}
    D = cfg.resolved_head_dim
    hq, hkv = heads or (cfg.num_heads // TP_WORLD, cfg.num_kv_heads // TP_WORLD)
    (tb, ts), (sb, ss) = train, serve
    gen = torch.Generator(device=device).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    timing = {}
    # flash forward with lse and backward at the training shape
    q, k, v, do = rnd(tb, ts, hq, D), rnd(tb, ts, hkv, D), rnd(tb, ts, hkv, D), \
        rnd(tb, ts, hq, D)
    pairs = ts * (ts + 1) // 2
    arch = "tinyllama_tp" if key == "tp" else f"{cfg.name}_{key}"
    got = flash_train_shape(torch, err, tag, arch, q, k, v, do, True, pairs, True)
    timing[f"flash_lse_{key}"], timing[f"flash_bwd_{key}"] = got[f"flash_lse_{arch}"], \
        got[f"flash_bwd_{arch}"]
    # flash forward at the serving prefill's shape
    q, k, v = rnd(sb, ss, hq, D), rnd(sb, ss, hkv, D), rnd(sb, ss, hkv, D)
    flash_hold(torch, err, q, k, v, f"{key} prefill shape")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    pairs = ss * (ss + 1) // 2
    timing[f"flash_prefill_{key}"] = flash_timing(
        torch, tag, f"flash_prefill_{key}",
        lambda: ops.flash_attention(q, k, v, causal=True),
        lambda: ref.flash_attention_ref(q, k, v, causal=True),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True),
        bound(flash_fwd_bytes(sb, ss, ss, hq, hkv, D), 4 * D * sb * hq * pairs,
              BF16_TENSOR_OPS_PER_S),
        f"prefill shape B={sb} S={ss} Hq={hq} Hkv={hkv} D={D} bf16 causal")
    del q, k, v, do, qt, kt, vt
    # the sparse tier on the vocab block: the near-data lookup gathers every
    # token id clamped into the block, the adjoint combines the tokens in it
    V_held, d = block.shape
    toks = batch["tokens"].reshape(-1).to(torch.int32)
    ids = toks.clamp(0, V_held - 1).contiguous()
    keep = toks < V_held
    flat = toks[keep].contiguous()
    seg = torch.nonzero(keep).squeeze(1).to(torch.int32)
    N_all, N = toks.numel(), flat.numel()
    g = torch.randn((N_all, d), generator=gen, device=device) * 1e-3
    uniq, comb = ops.combine_duplicates(flat, g, item_rows=seg)
    n = int((uniq >= 0).sum())
    pad = N_all - N
    uniq = torch.cat([uniq, uniq.new_full((pad,), -1)])
    upd = torch.cat([-0.05 * comb, comb.new_zeros((pad, d))])
    real = uniq[:n].long()
    real_ids = uniq[:n].contiguous()
    distinct = torch.unique(ids).numel()
    sorted_idx, order = torch.sort(flat, stable=True)
    first = torch.ones(N, dtype=torch.bool, device=device)
    first[1:] = sorted_idx[1:] != sorted_idx[:-1]
    comb_seg = torch.cumsum(first, 0, dtype=torch.int32) - 1
    comb_src = seg[order].contiguous()
    comb_starts = torch.nonzero(first).flatten().to(torch.int32)
    served = {k: v.reshape(-1).to(torch.int32).clamp(0, V_held - 1).contiguous()
              for k, v in serve_ids.items()}
    for what, idx in (("lookup", ids), ("checkpoint", real_ids),
                      ("serving prefill", served["prefill"]),
                      ("serving decode", served["decode"])):
        a, b = ops.gather_rows(block, idx), ref.gather_rows_ref(block, idx)
        check(torch.equal(a, b), f"{tag} gather_rows on the block ({what}): not bitwise")
    a = ops.embedding_bag(g, comb_src, comb_seg, N)
    b = ref.embedding_bag_ref(g, comb_src, comb_seg, N)
    e = (a - b).abs()
    check(bool((e <= 1e-5 + 1e-5 * b.abs()).all()) and torch.equal(
        a, ops.embedding_bag(g, comb_src, comb_seg, N)),
        f"{tag} embedding_bag (duplicate combine): max abs err {e.max().item():.3g}")
    err["embedding_bag"] = e.max().item()
    t_tab = block.clone()
    want_t, want_old = ref.scatter_update_logged_ref(t_tab.clone(), uniq, upd)
    _, old = ops.scatter_update_logged(t_tab, uniq, upd)
    check(torch.equal(t_tab, want_t) and torch.equal(old.view(torch.int16),
                                                     want_old.view(torch.int16)),
          f"{tag} scatter_update_logged on the block: not bitwise equal")
    s_tab = block.clone()
    want_s = ref.scatter_update_ref(s_tab.clone(), uniq, upd)
    ops.scatter_update(s_tab, uniq, upd)
    check(torch.equal(s_tab, want_s), f"{tag} scatter_update on the block: not bitwise")
    scratch = torch.zeros((V_held, d), dtype=torch.float32, device=device)
    want_f = ref.scatter_update_ref(scratch.clone(), uniq, upd)
    ops.scatter_update(scratch, uniq, upd)
    check(torch.equal(scratch, want_f), f"{tag} scatter_update on the block's scratch: "
          "not bitwise")
    del want_t, want_old, want_s, want_f, old
    upd_bf16 = upd[:n].to(torch.bfloat16)
    shapes = {
        # the ids once, each distinct row read once, every row written once
        f"gather_{key}_lookup": (lambda: ops.gather_rows(block, ids),
                             lambda: ref.gather_rows_ref(block, ids),
                             lambda: torch.index_select(block, 0, ids),
                             bound(N_all * 4 + distinct * d * 2 + N_all * d * 2, 0)),
        **{f"gather_{key}_serve_{k}": (
            lambda i=i: ops.gather_rows(block, i), lambda i=i: ref.gather_rows_ref(block, i),
            lambda i=i: torch.index_select(block, 0, i),
            bound(i.numel() * 4 + torch.unique(i).numel() * d * 2 + i.numel() * d * 2, 0))
           for k, i in served.items()},
        f"gather_{key}_checkpoint": (lambda: ops.gather_rows(block, real_ids),
                                 lambda: ref.gather_rows_ref(block, real_ids),
                                 lambda: torch.index_select(block, 0, real_ids),
                                 bound(n * 4 + 2 * n * d * 2, 0)),
        f"bag_combine_{key}": (lambda: ops.embedding_bag(g, comb_src, comb_seg, N),
                           lambda: ref.embedding_bag_ref(g, comb_src, comb_seg, N),
                           lambda: F.embedding_bag(comb_src, g, comb_starts, mode="sum"),
                           bound(N * 4 * 2 + N * d * 4 + n * d * 4, N * d)),
        f"update_f32_{key}": (lambda: ops.scatter_update(scratch, uniq, upd),
                          lambda: ref.scatter_update_ref(scratch, uniq, upd),
                          lambda: scratch.index_add_(0, real, upd[:n]),
                          bound(N_all * 4 + n * d * 12, n * d)),
        f"update_bf16_{key}": (lambda: ops.scatter_update(s_tab, uniq, upd),
                           lambda: ref.scatter_update_ref(s_tab, uniq, upd),
                           lambda: s_tab.index_add_(0, real, upd_bf16),
                           bound(N_all * 4 + n * d * (4 + 2 * 2), n * d)),
        f"update_logged_{key}": (lambda: ops.scatter_update_logged(t_tab, uniq, upd),
                             lambda: ref.scatter_update_logged_ref(t_tab, uniq, upd),
                             lambda: (t_tab.index_select(0, real),
                                      t_tab.index_add_(0, real, upd_bf16)),
                             bound(n * (4 + d * (4 + 3 * 2)) + (N_all - n) * (4 + d * 2),
                                   n * d)),
    }
    timing.update(time_shapes(torch, tag, shapes))
    return timing, err, {"block": [V_held, d], "ids": N_all, "distinct": distinct,
                         "items_in_block": N, "rows_touched": n,
                         "serve_ids": {k: i.numel() for k, i in served.items()}}


def tp_phase(torch, np, dev, tc):
    """Phase 27: full-width tinyllama-1.1b under dense tensor parallelism and
    the Megatron-SP residual stream, two gloo ranks on this one card
    (``tp_rank``), held against the one-rank run. Returns (rank 0's
    launches by path, its timings, its kernel errors, the metrics)."""
    import shutil
    import tempfile

    from repro_torch.launch import mesh

    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="tp-", dir=build)
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        mesh.spawn(tp_rank, TP_WORLD, backend="gloo", device=f"cuda:{dev.index or 0}",
                   args=(work, tc.seed), timeout=600)
        spawn_s = time.perf_counter() - t
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
                 for r in range(TP_WORLD)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return tp_report(ranks, spawn_s)


def tp_report(ranks, spawn_s):
    """Phase 27's results from its ranks: printed, held to the gates."""
    from repro_torch.configs import get_arch
    cfg = get_arch(TP_ARCH).model
    tag, r0 = "[tp]", ranks[0]
    one = r0["runs"]["one"]
    out = {"spawn_s": spawn_s, "rules": r0["train_rules"], "held": r0["held"],
           "one_losses": one["losses"], "one_step_ms": one["step_ms"],
           "one_peak_gb": r0["one_peak_gb"], "one_serve": r0["one_serve"],
           "seconds": {k: r0[k] for k in ("one_s", "train_s", "drill_s", "serve_s")}}
    print(f"{tag} two gloo ranks on {[r['device'] for r in ranks]}, (data, model) = "
          f"(1, {TP_WORLD}), rules {r0['train_rules']}; spawn to the last rank's end "
          f"{spawn_s:.1f}s; rank 0's parts (s) {out['seconds']}")
    print(f"{tag} rank 0 holds {r0['held']} (whole: wq {[cfg.num_layers, cfg.d_model, cfg.d_model]}, "
          f"table {[cfg.vocab_size, cfg.d_model]})")
    loss_gap = max(abs(a - b) / abs(b) for r in ranks
                   for a, b in zip(r["runs"]["strict"]["losses"], one["losses"], strict=True))
    norm_gap = max(abs(a - b) / abs(b) for r in ranks
                   for a, b in zip(r["runs"]["strict"]["norms"], one["norms"], strict=True))
    norm0_gap = max(abs(r["runs"]["strict"]["norms"][0] - one["norms"][0]) / one["norms"][0]
                    for r in ranks)
    out.update(loss_rel_gap=loss_gap, norm_rel_gap=norm_gap, norm0_rel_gap=norm0_gap,
               param_max_share=r0["param_max_share"], param_mean_share=r0["param_mean_share"],
               sign_agree_min=r0["sign_agree_min"], sign_leaves=r0["sign_leaves"],
               replicated={n: [r["runs"][n]["replicated"] for r in ranks]
                           for n in ("strict", "relaxed")})
    for name in ("strict", "relaxed"):
        rr = r0["runs"][name]
        out[name] = {"losses": rr["losses"], "norms": rr["norms"],
                     "step_ms": [r["runs"][name]["step_ms"] for r in ranks],
                     "peak_gb": [r["runs"][name]["peak_gb"] for r in ranks],
                     "launches": [r["runs"][name]["launches"] for r in ranks],
                     "moved_per_step": rr["moved"]}
        print(f"{tag} {name}: losses {rr['losses']} (one rank {one['losses']}), gradient "
              f"norms {rr['norms']} (one rank {one['norms']}); step ms a rank "
              f"{out[name]['step_ms']} (one rank {one['step_ms']}); peak GB a rank "
              f"{out[name]['peak_gb']} (one rank {r0['one_peak_gb']:.2f}); launches a rank "
              f"{out[name]['launches']}")
        print(f"{tag} {name} rank 0's collectives a step: " + json.dumps(rr["moved"]))
    print(f"{tag} against the one-rank run: losses {loss_gap:.4g} relative (gate "
          f"{TP_LOSS_RTOL}), step 0's gradient norm {norm0_gap:.4g} (gate {TP_NORM0_RTOL}; "
          f"every step's {norm_gap:.4g}), params' largest difference "
          f"{r0['param_max_share']:.4g} of a leaf's largest, mean "
          f"{r0['param_mean_share']:.4g} (gate {TP_PARAM_MEAN}), the least share of a leaf's "
          f"moved elements updated with the one-rank sign {r0['sign_agree_min']:.6g} (gate "
          f"{TP_SIGN_MIN}; leaves that moved, of all: {r0['sign_leaves']}); relaxed == strict "
          f"bitwise {[r['relaxed_is_strict'] for r in ranks]}; replicated leaves and moments "
          f"against rank 0's {out['replicated']}")
    res = r0["runs"]["resumed"]
    crash = r0["runs"]["crash"]
    out.update(mirror_load_s=r0["mirror_load_s"], gather_s=r0["gather_s"],
               recover_s=[r["recover_s"] for r in ranks], rec=r0["rec"],
               crash_losses=crash["losses"], crash_step_ms=crash["step_ms"],
               resumed_losses=res["losses"], ckpt_launches=crash["launches"])
    print(f"{tag} crash drill (tier-E only, one writer): mirror load "
          f"{r0['mirror_load_s']:.2f}s, step ms {crash['step_ms']}, the writer's gather and "
          f"merge {r0['gather_s']:.3f}s, crashed {[r['crashed'] for r in ranks]}, recovered "
          f"{r0['rec']} in {out['recover_s']} s a rank, blocks bitwise the twin's "
          f"{[r['recovered_bitwise'] for r in ranks]}; resumed at "
          f"{[r['resume_at'] for r in ranks]}: loss {res['losses']} vs the run's "
          f"{crash['losses'][TP_CRASH:]}; launches {crash['launches']}")
    sv = r0["serve"]
    out["serve"] = {"prefill_ms": [r["serve"]["prefill_ms"] for r in ranks],
                    "decode_ms": [r["serve"]["decode_ms"] for r in ranks],
                    "launches": sv["launches"], "parts": sv["parts"], "moved": sv["moved"],
                    "logit_share": sv["logit_share"]}
    out["serve"].update({k: sv[k] for k in ("tokens_equal", "tokens", "first_differing",
                                            "prefill_logit_share")})
    print(f"{tag} serving B={TP_SERVE_B} prompt {TP_S} + {TP_NEW} tokens: prefill ms a rank "
          f"{out['serve']['prefill_ms']} (one rank {r0['one_serve']['prefill_ms']:.2f}), decode "
          f"ms a token {out['serve']['decode_ms']} (one rank "
          f"{r0['one_serve']['decode_ms']:.3f}); greedy tokens equal to the one-rank run's: "
          f"{sv['tokens_equal']} of {sv['tokens']}, the first that differs "
          f"{sv['first_differing']}; teacher-forced on the one-rank tokens, every row's logits "
          f"within {sv['logit_share']:.4g} of the largest (the prefill's "
          f"{sv['prefill_logit_share']:.4g}; gate {TP_LOGIT_TOL}); launches "
          f"{sv['parts']}; collectives {json.dumps(sv['moved'])}")
    cp = r0["cp"]
    out["cp"] = cp
    print(f"{tag} context-parallel decode ({CP_RULES}, {cp['cache_positions']} cache "
          f"positions a rank), teacher-forced on the one-rank tokens: every one of "
          f"{cp['rows']} rows' logits within {cp['logit_share']:.4g} of the largest (gate "
          f"{CP_LOGIT_TOL}); launches {cp['launches']}")
    print(f"{tag} rank 0's shapes {r0['shapes']}; its collectives in all "
          + json.dumps(r0["stats"]))
    check(r0["held"]["wq"] == [cfg.num_layers, cfg.d_model, cfg.d_model // TP_WORLD]
          and r0["held"]["wo"] == [cfg.num_layers, cfg.d_model // TP_WORLD, cfg.d_model]
          and r0["held"]["wi"] == [cfg.num_layers, cfg.d_model, cfg.d_ff // TP_WORLD]
          and r0["held"]["lm_head"] == [cfg.d_model, cfg.vocab_size // TP_WORLD]
          and r0["held"]["table"] == [cfg.vocab_size // TP_WORLD, cfg.d_model]
          and r0["held"]["adam_m_wq"] == r0["held"]["wq"],
          f"{tag} rank 0 holds {r0['held']}, not its blocks")
    check(all(math.isfinite(x) for r in ranks for n in ("strict", "relaxed")
              for x in r["runs"][n]["losses"]), f"{tag} a non-finite loss")
    check(loss_gap <= TP_LOSS_RTOL, f"{tag} losses {loss_gap:.4g} from the one-rank run's")
    check(norm0_gap <= TP_NORM0_RTOL, f"{tag} step 0's gradient norm {norm0_gap:.4g} from "
          "the one-rank run's")
    check(r0["param_mean_share"] <= TP_PARAM_MEAN and r0["sign_agree_min"] >= TP_SIGN_MIN,
          f"{tag} params differ from the one-rank run's")
    check(all(rep_["leaves"] > 0 and not rep_["differ"]
              for reps in out["replicated"].values() for rep_ in reps),
          f"{tag} a replicated leaf differs across the ranks: {out['replicated']}")
    check(all(r["relaxed_is_strict"] for r in ranks), f"{tag} relaxed differs from strict")
    check(all(r["runs"]["strict"]["losses"] == r0["runs"]["strict"]["losses"]
              for r in ranks), f"{tag} the ranks report different losses")
    check(r0["crashed"] and not ranks[1]["crashed"], f"{tag} the writer did not crash "
          "alone at the scheduled step")
    check(r0["rec"] == [TP_CRASH - 1, -1, True], f"{tag} recovered {r0['rec']}")
    check(all(r["recovered_bitwise"] for r in ranks), f"{tag} a recovered block differs "
          "from the twin's")
    check(all(r["resume_at"] == TP_CRASH for r in ranks), f"{tag} resume step")
    check(res["losses"] == crash["losses"][TP_CRASH:TP_CRASH + 1], f"{tag} the resumed "
          "loss differs from the uninterrupted step's")
    fd = sv["first_differing"]
    check(fd is None or all(t <= g for t, g in zip(fd["top2_gap"], fd["logit_gap"],
                                                     strict=True)),
          f"{tag} a served token differs from the one-rank run's where the one-rank "
          f"logits were no near tie: {fd}")
    check(sv["logit_share"] <= TP_LOGIT_TOL, f"{tag} served logits beyond the gate")
    check(cp["logit_share"] <= CP_LOGIT_TOL, f"{tag} context-parallel decode's logits "
          "beyond the gate")
    for name in ("strict", "relaxed"):
        for r in ranks:
            c = r["runs"][name]["launches"]
            need = ("flash_attention_tc", "flash_attention_bwd", "gather_rows", "embedding_bag",
                    "scatter_update") + (("scatter_update_logged",) if name == "relaxed" else ())
            check(all(c[k] > 0 for k in need), f"{tag} {name}: a kernel of the path never "
                  f"launched: {c}")
    check(all(r["serve"]["parts"]["prefill"]["flash_attention_tc"] > 0
              and r["serve"]["parts"]["prefill"]["gather_rows"] == 1
              and r["serve"]["parts"]["decode"]["gather_rows"] == TP_NEW - 1 for r in ranks),
          f"{tag} serving: want flash and one gather in the prefill and one gather a decode "
          f"step, got {[r['serve']['parts'] for r in ranks]}")
    check(all(r["ckpt_gathers"] == TP_CRASH + 1 for r in ranks), f"{tag} the checkpoint's "
          f"gathers a rank {[r['ckpt_gathers'] for r in ranks]}, want one a checkpointed step")
    rl, sl = r0["runs"]["relaxed"]["launches"], r0["runs"]["strict"]["launches"]
    launches = {"flash_lse": rl["flash_attention_tc"], "flash_bwd": rl["flash_attention_bwd"],
                "gather": rl["gather_rows"], "bag": rl["embedding_bag"],
                "update_f32": rl["scatter_update"], "update_bf16": sl["scatter_update"],
                "logged": rl["scatter_update_logged"],
                "ckpt_gather": r0["ckpt_gathers"],
                "flash_prefill": sv["parts"]["prefill"]["flash_attention_tc"],
                "gather_serve_prefill": sv["parts"]["prefill"]["gather_rows"],
                "gather_serve_decode": sv["parts"]["decode"]["gather_rows"]}
    return launches, r0["timing"], r0["err"], out


FS_ARCH = "granite-20b"
FS_MESH = (2, 2)              # (data, model): four gloo ranks sharing the card
# of granite-20b's 52 layers: full width, the depth cut to 1 (from 2:
# a 2-layer step moved 7.4 GB a rank through gloo, 15 s a step, and the
# phase took 123 s)
FS_LAYERS = 1
FS_B, FS_S = 4, 512           # the global training batch: a data rank's 2 x 512
FS_SERVE_B, FS_NEW = 2, 3     # serving: batch 2, prompt FS_S, a prefill and 2 decode steps
FS_CRASH = 1                  # the writer crashes between step 1's COMMIT and apply
# Phase 28's gates against the one-rank run at the same depth, each set
# from the differences measured on an H100 80GB HBM3 at 700 W (PERF.md
# section 6; at 2 layers): step 0's loss, before any update
# (measured 5.1e-6 when a rank rounded its row-parallel output before the
# sum, 5.3e-6 with the partial in f32); the later step's (3.5e-3: the
# gradients reduce-scattered in bf16 round otherwise than one rank's, and
# AdamW's first step moves an element whose gradient is near zero by
# about the learning rate either way); step 0's gradient norm (4.6e-5);
# each leaf's mean difference on rank 0's blocks after step 0 as a share
# of its largest magnitude (4.8e-4; the largest, 0.269, is printed, not a
# gate); the least share of a leaf's moved elements updated with the
# one-rank sign (0.9965); the served logits on every row up to the first
# greedy token that differs, as a share of the largest logit (7.3e-3)
FS_LOSS0_RTOL = 1e-4
FS_LOSS_RTOL = 1e-2
FS_NORM0_RTOL = 2e-3
FS_PARAM_MEAN = 3e-3
FS_SIGN_MIN = 0.98
FS_LOGIT_TOL = 3e-2


def fsdp_model():
    """granite-20b at full width, its depth cut to FS_LAYERS, under its own
    profile (fsdp, Megatron-SP): (bundle, cfg)."""
    from repro_torch.configs import get_arch
    full = get_arch(FS_ARCH)
    cfg = full.model.replace(num_layers=FS_LAYERS)
    return dataclasses.replace(full, model=cfg), cfg


def fsdp_rank(rank, world, device, work, seed):
    """Phase 28, one rank of ``world`` gloo ranks sharing ``device``:
    full-width granite-20b cut to FS_LAYERS layers under the rules the
    port's ``build_rules`` gives its profile at (data, model) = FS_MESH:
    FSDP (``w_embed`` over data), dense TP and Megatron-SP over model, and
    its one kv head replicated over model. Rank 0 first runs the one-rank
    reference alone (2 strict steps, a greedy generation). Then every
    rank: one strict step
    from the seed's params (each rank drawing the whole model's random
    stream and keeping its blocks), then FS_CRASH + 1 relaxed steps into a
    mesh checkpoint (tier-E only) whose writer crashes in the last, and
    recovery at every rank; serving under the decode rules. Rank 0 holds
    the kernels at its shapes against their plain versions and times them.
    Writes ``work/rank{rank}.pt``."""
    import torch

    from repro_torch.configs.base import SHAPES, CheckpointConfig, TrainConfig
    from repro_torch.data.lookahead import LookaheadIterator
    from repro_torch.data.synthetic import make_batches
    from repro_torch.distributed import fsdp, sharding
    from repro_torch.distributed.checkpoint import MeshCheckpoint, recover_on_mesh
    from repro_torch.kernels import gather_rows as gr
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.registry import get_api
    from repro_torch.pool import FaultSchedule, InjectedCrash
    from repro_torch.training import train_loop
    from repro_torch.training.serve_loop import greedy_generate
    from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

    torch.backends.cuda.matmul.allow_tf32 = False
    bundle, cfg = fsdp_model()
    tc = TrainConfig(embed_learning_rate=0.05, seed=seed)
    api = get_api(cfg)
    init_fn = train_loop.make_step_fns(cfg, tc)[0]
    writer = rank == 0
    mesh = make_local_mesh(model_parallel=FS_MESH[1], device=device)
    rules = {}
    for kind, shape in (("train", "train_4k"), ("serve", "decode_32k")):
        act, weights, _ = dryrun.build_rules(bundle, SHAPES[shape], mesh)
        rules[kind] = {**act, **weights}
    out = {"device": str(device), "rules": rules, "runs": {},
           "coords": [mesh.coords["data"], mesh.coords["model"]]}
    t_all = time.perf_counter()

    def say(msg):
        print(f"[fsdp] rank {rank}: {msg}", flush=True)

    def params(kind=None):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        kw = {} if kind is None else {"keep": sharding.keep_shard(mesh, rules[kind])}
        p = api.init(gen, cfg, **kw)
        torch.cuda.synchronize(device)
        return p

    def run(name, state, relaxed, n, start=0, mgr=None, on_step=None):
        """``n`` steps from ``start``: losses, gradient norms, each step's
        host ms and collectives, launches."""
        batches = LookaheadIterator(make_batches(cfg, FS_B, FS_S, device=device), cfg,
                                    depth=n + 2, start_step=start)
        rec = out["runs"][name] = {"losses": [], "norms": [], "step_ms": [], "moved": []}
        torch.cuda.synchronize(device)
        tp_counts(zero=True)
        ctx = sharding.current()
        mark = [time.perf_counter(), mesh.stats() if ctx else {}]

        def on_metrics(k, m):
            rec["losses"].append(float(m["loss"]))
            rec["norms"].append(float(m["grad_norm"]))
            if on_step is not None:
                on_step(k, m)
            torch.cuda.synchronize(device)
            rec["step_ms"].append(1e3 * (time.perf_counter() - mark[0]))
            if ctx is not None:
                rec["moved"].append(stats_since(mesh, mark[1]))
                mark[1] = mesh.stats()
            mark[0] = time.perf_counter()
        try:
            train_loop.train(cfg, tc, batches, n, relaxed=relaxed, state=state,
                             start_step=start, ckpt_manager=mgr, on_metrics=on_metrics)
        finally:
            rec["launches"] = tp_counts()

    def generate(p):
        prompt = make_batches(cfg, FS_SERVE_B, FS_S, device=device).next(0)["tokens"]
        parts = {}

        @contextlib.contextmanager
        def part(name):
            before = tp_counts()
            yield
            parts[name] = {k: v - before[k] for k, v in tp_counts().items()}
        with torch.no_grad():
            tp_counts(zero=True)
            before = mesh.stats()
            st = {}
            toks = greedy_generate(cfg, p, prompt, FS_NEW, stats=st, part=part)
            return {"tokens": toks, "logits": st["logits"],
                    "prefill_ms": 1e3 * st["prefill_s"],
                    "decode_ms": 1e3 * st["decode_s"] / (FS_NEW - 1),
                    "launches": tp_counts(), "parts": parts,
                    "moved": stats_since(mesh, before)}

    def held_paths(tree):
        """{path: (held spec, whole shape)} of ``tree``'s dense leaves under
        the train rules."""
        specs = {}

        def one(path, x):
            whole = fsdp.whole_shape(cfg, path, x.dim()) if sharding.is_tp_leaf(path) \
                else tuple(x.shape)
            specs[path] = (sharding.held_spec(path, whole, mesh, rules["train"]), whole)
        tree_map_with_path(one, tree)
        return specs

    def mine(path, x):
        """Rank 0's block of a whole leaf ``x`` of the one-rank tree."""
        spec, whole = specs_d[path]
        return x[sharding.local_slices(whole, spec, mesh)].clone()

    def replicated_equal(state):
        """The leaves held whole and their AdamW moments that differ from
        rank 0's, bit for bit (every rank calls it)."""
        differ = []

        def same(path, x):
            if not fsdp.held_dims(cfg, path, x.dim()):
                got = mesh.broadcast(x.clone(), mesh.axis_names, 0)
                if not torch.equal(x, got):
                    differ.append(path)
                return 1
            return 0
        with sharding.use_sharding(mesh, rules["train"]):
            n = sum(tree_leaves(tree_map_with_path(same, {
                "dense": state["dense"], "m": state["opt_dense"]["m"],
                "v": state["opt_dense"]["v"]})))
        return {"leaves": n, "differ": differ}

    def in_place(state):
        return {"dense": state["dense"], "m": state["opt_dense"]["m"],
                "v": state["opt_dense"]["v"], "table": state["embed"]["table"]}

    # (a) the one-rank reference, rank 0 alone: the state after step 0 cut
    # to rank 0's blocks, the losses, norms and peak, and a generation
    specs_d = None
    one = {}
    if writer:
        t = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(device)
        state = init_fn(params())
        specs_d = held_paths(state["dense"])
        t_spec = sharding.held_spec("embed/table", tuple(state["embed"]["table"].shape),
                                    mesh, rules["train"])

        def after0(k, _):
            if k == 0:
                one["dense"] = tree_map_with_path(mine, state["dense"])
                one["table"] = state["embed"]["table"][sharding.local_slices(
                    tuple(state["embed"]["table"].shape), t_spec, mesh)].clone()
        run("one", state, relaxed=False, n=2, on_step=after0)
        out["one_peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
        out["one_elems"] = {"dense": sum(x.numel() for x in tree_leaves(state["dense"])),
                            "table": state["embed"]["table"].numel()}
        del state
        torch.cuda.empty_cache()
        p = params()
        one["serve"] = generate(p)
        del p
        torch.cuda.empty_cache()
        out["one_serve"] = {k: v for k, v in one["serve"].items()
                            if k not in ("tokens", "logits")}
        out["one_s"] = time.perf_counter() - t
        say(f"one-rank reference: losses {out['runs']['one']['losses']}, peak "
            f"{out['one_peak_gb']:.2f} GB, prefill {out['one_serve']['prefill_ms']:.1f} ms, "
            f"decode {out['one_serve']['decode_ms']:.2f} ms a token")
    mesh.barrier()
    for axes in ("data", "model", mesh.axis_names):    # each group's first use
        x = torch.ones((4, 4), dtype=torch.bfloat16, device=device)
        dims = {0: "data", 1: "model"} if axes == mesh.axis_names else {0: axes}
        mesh.reduce_scatter_blocks(mesh.all_gather_blocks(x, dims), dims)
    mesh.moved.clear()

    # (b) one strict step, then the relaxed steps through the mesh
    # checkpoint, whose writer crashes in step FS_CRASH; recovery
    t = time.perf_counter()
    cc = CheckpointConfig(directory=os.path.join(work, "ckpt"), dense_interval=0,
                          pool_backend="pmem", pool_compress="none")
    with sharding.use_sharding(mesh, rules["train"]):
        torch.cuda.reset_peak_memory_stats(device)
        state = init_fn(params("train"))
        spec = held_paths(state["dense"])
        held = {"params": sum(x.numel() for x in tree_leaves(state["dense"])),
                "moments": sum(x.numel() for k in ("m", "v")
                               for x in tree_leaves(state["opt_dense"][k])),
                "table": state["embed"]["table"].numel()}
        # a quarter of each leaf held in blocks, every other leaf whole
        want = sum(math.prod(w) // mesh.axis_size(tuple(a for a in s if a)) for s, w
                   in spec.values())
        out["held"] = {**held, "want_params": want, "want_moments": 2 * want,
                       "want_table": cfg.vocab_size * cfg.d_model // FS_MESH[1],
                       "bytes": {"params": sum(x.numel() * x.element_size()
                                               for x in tree_leaves(state["dense"])),
                                 "moments": sum(x.numel() * x.element_size()
                                                for k in ("m", "v") for x in
                                                tree_leaves(state["opt_dense"][k])),
                                 "table": state["embed"]["table"].numel()
                                 * state["embed"]["table"].element_size()},
                       "shapes": {"wq": list(state["dense"]["blocks"]["attn"]["wq"].shape),
                                  "wk": list(state["dense"]["blocks"]["attn"]["wk"].shape),
                                  "attn_wo": list(state["dense"]["blocks"]["attn"]["wo"].shape),
                                  "wi": list(state["dense"]["blocks"]["mlp"]["wi"].shape),
                                  "mlp_wo": list(state["dense"]["blocks"]["mlp"]["wo"].shape),
                                  "lm_head": list(state["dense"]["lm_head"].shape),
                                  "table": list(state["embed"]["table"].shape),
                                  "adam_m_wk": list(state["opt_dense"]["m"]["blocks"]
                                                    ["attn"]["wk"].shape)}}
        init0 = tree_map(torch.clone, state["dense"]) if writer else None
        table0 = state["embed"]["table"].clone() if writer else None
        # the copies the checks hold on the card beside the run (rank 0's:
        # its initial blocks and the one-rank run's blocks after step 0)
        checks = 2 * nbytes({"d": init0, "t": table0}) if writer else 0
        run("strict", state, relaxed=False, n=1)
        out["runs"]["strict"]["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
        out["runs"]["strict"]["checks_gb"] = checks / 1e9
        out["runs"]["strict"]["replicated"] = replicated_equal(state)
        strict = {k: tree_map(torch.clone, v) for k, v in in_place(state).items()}
        checks = nbytes(strict)
        if writer:
            # rank 0's blocks against the one-rank run's after step 0: each
            # leaf's differences, and the share of its elements that moved in
            # the one-rank run whose update has that run's sign
            gaps, signs = [], []
            for a, b, z in zip(tree_leaves({"d": state["dense"], "t": state["embed"]["table"]}),
                               tree_leaves({"d": one.pop("dense"), "t": one.pop("table")}),
                               tree_leaves({"d": init0, "t": table0}), strict=True):
                s_ = b.float().abs().max().item() or 1.0
                d = (a.float() - b.float()).abs()
                gaps.append((d.max().item() / s_, d.mean().item() / s_))
                ua, ub = a.float() - z.float(), b.float() - z.float()
                moved = int((ub != 0).sum())
                if moved:
                    signs.append(int(((ua.sign() == ub.sign()) & (ub != 0)).sum()) / moved)
                del d, ua, ub
            out["param_max_share"] = max(g[0] for g in gaps)
            out["param_mean_share"] = max(g[1] for g in gaps)
            out["sign_agree_min"] = min(signs)
            out["sign_leaves"] = [len(signs), len(gaps)]
            del init0, table0
        del state
        torch.cuda.empty_cache()
        say(f"strict: losses {out['runs']['strict']['losses']}")

        torch.cuda.reset_peak_memory_stats(device)
        state = init_fn(params("train"))
        faults = FaultSchedule.crash_at("tier_e.between-commit-and-apply",
                                        occurrence=FS_CRASH + 1)
        mgr = MeshCheckpoint(cfg, cc, embed_init=state["embed"],
                             faults=faults if writer else None)
        out["mirror_load_s"] = mgr.stats["mirror_load_s"]
        out["ckpt_gathers"] = 0
        inner = mgr.on_step

        def counted(step, st, feed):
            # the checkpoint's own gathers: the count before and after each call
            before = gr.launches
            try:
                return inner(step, st, feed)
            finally:
                out["ckpt_gathers"] += gr.launches - before
        mgr.on_step = counted
        snap = {}

        def keep(k, _):
            if k == FS_CRASH - 1:   # the twin: the state after this step, in place
                snap.update({n_: tree_map(torch.clone, v) for n_, v in in_place(state).items()})
                snap["t"] = torch.tensor(k + 1, dtype=torch.int32, device=device)
        out["crashed"] = False
        try:
            run("relaxed", state, relaxed=True, n=FS_CRASH + 1, mgr=mgr, on_step=keep)
        except InjectedCrash:
            out["crashed"] = True
            mgr.manager.pool.close()           # the writer's process death
        out["runs"]["relaxed"]["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
        # the strict run's state and the twin
        out["runs"]["relaxed"]["checks_gb"] = (checks + nbytes(snap)) / 1e9
        out["runs"]["relaxed"]["replicated"] = replicated_equal(state)
        out["relaxed_is_strict"] = (
            out["runs"]["relaxed"]["losses"][:1] == out["runs"]["strict"]["losses"]
            and all(torch.equal(a, b) for a, b in zip(
                tree_leaves({k: snap[k] for k in strict}), tree_leaves(strict), strict=True)))
        del strict
        out["gather_s"] = mgr.stats["gather_s"]
        batch0 = sharding.shard_batch(make_batches(cfg, FS_B, FS_S, device=device).next(0),
                                      mesh, rules["train"])
        block = state["embed"]["table"].clone() if writer else None
        del state, mgr, counted, inner       # the wrapper and the manager hold each other
        torch.cuda.empty_cache()
        t_rec = time.perf_counter()
        fresh = init_fn(params("train"))
        # no tier-M: the dense tree comes from the twin, the table from the pool
        fresh = {**fresh, "dense": snap.pop("dense"),
                 "opt_dense": {"m": snap.pop("m"), "v": snap.pop("v"), "t": snap.pop("t")}}
        state, start, rec = recover_on_mesh(cfg, cc.directory, fresh)
        torch.cuda.synchronize(device)
        out["recover_s"] = time.perf_counter() - t_rec
        out["resume_at"] = start
        out["recovered_bitwise"] = torch.equal(state["embed"]["table"], snap.pop("table"))
        if writer:
            out["rec"] = [rec.mirror_step, rec.dense_step, rec.rolled_back]
            rec.pool.close()
        del state, fresh
    torch.cuda.empty_cache()
    out["train_s"] = time.perf_counter() - t
    say(f"relaxed: losses {out['runs']['relaxed']['losses']}, crashed {out['crashed']}, "
        f"recovered to resume at {out['resume_at']}")

    # (c) serving under the decode rules: every layer's blocks gathered a
    # step; the cache holds the one kv head over every position
    t = time.perf_counter()
    with sharding.use_sharding(mesh, rules["serve"]):
        p = params("serve")
        got = generate(p)
        del p
    torch.cuda.empty_cache()
    out["serve"] = {k: v for k, v in got.items() if k not in ("tokens", "logits")}
    toks0 = mesh.broadcast(got["tokens"].clone(), mesh.axis_names, 0)
    out["serve"]["tokens_as_rank0"] = bool(torch.equal(toks0, got["tokens"]))
    if writer:
        want = one["serve"]
        scale = want["logits"].abs().max().item()
        same = got["tokens"] == want["tokens"]
        cols = torch.nonzero(~same.all(dim=0)).flatten()
        # the logits are teacher-forced on the one-rank tokens up to the first
        # position where a greedy token differs (that position included)
        upto = int(cols[0]) + 1 if cols.numel() else FS_NEW
        gap = (got["logits"][:, :upto] - want["logits"][:, :upto]).abs()
        out["serve"].update(logit_share=gap.max().item() / scale,
                            prefill_logit_share=gap[:, 0].max().item() / scale,
                            tokens_equal=int(same.sum()), tokens=int(same.numel()),
                            compared_positions=upto, first_differing=None)
        if cols.numel():
            t0_ = int(cols[0])
            rows = torch.nonzero(~same[:, t0_]).flatten().tolist()
            top2 = want["logits"][rows, t0_].topk(2, dim=-1).values
            out["serve"]["first_differing"] = {
                "position": t0_, "rows": rows,
                "top2_gap": (top2[:, 0] - top2[:, 1]).tolist(),
                "logit_gap": gap[rows, t0_].amax(dim=-1).tolist()}
    out["serve_s"] = time.perf_counter() - t

    # (d) rank 0: the kernels at its shapes against their plain versions, timed
    if writer:
        t = time.perf_counter()
        serve_ids = {"prefill": make_batches(cfg, FS_SERVE_B, FS_S,
                                             device=device).next(0)["tokens"],
                     "decode": got["tokens"][:, 0]}
        out["timing"], out["err"], out["shapes"] = tp_kernels(
            torch, device, cfg, block, batch0, serve_ids, tag="[fsdp]", key="fsdp",
            heads=(cfg.num_heads // FS_MESH[1], 1), train=(FS_B // FS_MESH[0], FS_S),
            serve=(FS_SERVE_B, FS_S))
        out["kernels_s"] = time.perf_counter() - t
        del block
    del got
    mesh.barrier()
    out["stats"] = mesh.stats()
    out["rank_s"] = time.perf_counter() - t_all
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))


def nbytes(tree) -> int:
    from repro_torch.tree import tree_leaves
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def fsdp_phase(torch, np, dev, tc):
    """Phase 28: full-width granite-20b (FS_LAYERS layers) under FSDP, dense
    TP, Megatron-SP and one kv head replicated over model, four gloo ranks
    on this one card (``fsdp_rank``), held against the one-rank run.
    Returns (rank 0's launches by path, its timings, its kernel errors, the
    metrics)."""
    import shutil
    import tempfile

    from repro_torch.launch import mesh

    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="fsdp-", dir=build)
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        mesh.spawn(fsdp_rank, math.prod(FS_MESH), backend="gloo",
                   device=f"cuda:{dev.index or 0}", args=(work, tc.seed), timeout=600)
        spawn_s = time.perf_counter() - t
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
                 for r in range(math.prod(FS_MESH))]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return fsdp_report(ranks, spawn_s)


def fsdp_report(ranks, spawn_s):
    """Phase 28's results from its ranks: printed, held to the gates."""
    _, cfg = fsdp_model()
    tag, r0 = "[fsdp]", ranks[0]
    one = r0["runs"]["one"]
    d, V, n_q = cfg.d_model, cfg.vocab_size, cfg.num_heads * cfg.resolved_head_dim
    kv, ff, L = cfg.num_kv_heads * cfg.resolved_head_dim, cfg.d_ff, cfg.num_layers
    out = {"spawn_s": spawn_s, "mesh": list(FS_MESH), "layers": L,
           "layers_full": 52, "rules": r0["rules"], "held": [r["held"] for r in ranks],
           "one_losses": one["losses"], "one_step_ms": one["step_ms"],
           "one_peak_gb": r0["one_peak_gb"], "one_elems": r0["one_elems"],
           "one_serve": r0["one_serve"],
           "seconds": {k: r0[k] for k in ("one_s", "train_s", "serve_s", "kernels_s",
                                           "rank_s")}}
    print(f"{tag} four gloo ranks on {[r['device'] for r in ranks]}, (data, model) = "
          f"{FS_MESH}, granite-20b at full width (d {d}, {cfg.num_heads} heads, "
          f"{cfg.num_kv_heads} kv head, d_ff {ff}, vocab {V}), depth cut to {L} of 52 "
          f"layers; train rules {r0['rules']['train']}, serve rules {r0['rules']['serve']}; "
          f"spawn to the last rank's end {spawn_s:.1f}s; rank 0's parts (s) {out['seconds']}")
    for r in ranks:
        h = r["held"]
        print(f"{tag} rank {r['coords']} holds params {h['params']:,} elements "
              f"({h['bytes']['params'] / 1e9:.3f} GB; want {h['want_params']:,}), moments "
              f"{h['moments']:,} ({h['bytes']['moments'] / 1e9:.3f} GB; want "
              f"{h['want_moments']:,}), table block {h['table']:,} "
              f"({h['bytes']['table'] / 1e9:.3f} GB); the one-rank tree: params "
              f"{r0['one_elems']['dense']:,}, moments {2 * r0['one_elems']['dense']:,}, "
              f"table {r0['one_elems']['table']:,}; shapes {h['shapes']}")
    losses4 = [r["runs"]["relaxed"]["losses"] for r in ranks]
    loss0_gap = max(abs(ls[0] - one["losses"][0]) / abs(one["losses"][0]) for ls in losses4)
    loss_gap = max(abs(a - b) / abs(b) for ls in losses4
                   for a, b in zip(ls, one["losses"], strict=True))
    norm0_gap = max(abs(r["runs"]["strict"]["norms"][0] - one["norms"][0]) / one["norms"][0]
                    for r in ranks)
    out.update(loss0_rel_gap=loss0_gap, loss_rel_gap=loss_gap, norm0_rel_gap=norm0_gap,
               param_max_share=r0["param_max_share"], param_mean_share=r0["param_mean_share"],
               sign_agree_min=r0["sign_agree_min"], sign_leaves=r0["sign_leaves"],
               replicated={n: [r["runs"][n]["replicated"] for r in ranks]
                           for n in ("strict", "relaxed")})
    for name in ("strict", "relaxed"):
        rr = r0["runs"][name]
        out[name] = {"losses": rr["losses"], "norms": rr["norms"],
                     "step_ms": [r["runs"][name]["step_ms"] for r in ranks],
                     "launches": [r["runs"][name]["launches"] for r in ranks],
                     "moved_per_step": [r["runs"][name]["moved"] for r in ranks],
                     "peak_gb": [r["runs"][name]["peak_gb"] for r in ranks],
                     "checks_gb": [r["runs"][name]["checks_gb"] for r in ranks]}
        print(f"{tag} {name}: losses {rr['losses']} (one rank {one['losses']}), gradient "
              f"norms {rr['norms']} (one rank {one['norms']}); step ms a rank "
              f"{out[name]['step_ms']} (one rank {one['step_ms']}); peak GB a rank "
              f"{out[name]['peak_gb']}, of which the checks' copies {out[name]['checks_gb']} "
              f"(one rank {r0['one_peak_gb']:.2f}); launches a rank {out[name]['launches']}")
        for r in ranks:
            print(f"{tag} {name} rank {r['coords']}'s collectives a step: "
                  + json.dumps(r["runs"][name]["moved"]))
    print(f"{tag} against the one-rank run: step 0's loss {loss0_gap:.4g} relative (gate "
          f"{FS_LOSS0_RTOL}), every step's {loss_gap:.4g} (gate {FS_LOSS_RTOL}), step 0's "
          f"gradient norm {norm0_gap:.4g} (gate {FS_NORM0_RTOL}), "
          f"rank 0's blocks after step 0: largest difference {r0['param_max_share']:.4g} of a "
          f"leaf's largest, mean {r0['param_mean_share']:.4g} (gate {FS_PARAM_MEAN}), the "
          f"least share of a leaf's moved elements updated with the one-rank sign "
          f"{r0['sign_agree_min']:.6g} (gate {FS_SIGN_MIN}; leaves that moved, of all: "
          f"{r0['sign_leaves']}); relaxed == strict bitwise "
          f"{[r['relaxed_is_strict'] for r in ranks]}; leaves held whole and their moments "
          f"against rank 0's {out['replicated']}")
    out.update(mirror_load_s=r0["mirror_load_s"], gather_s=r0["gather_s"],
               recover_s=[r["recover_s"] for r in ranks], rec=r0["rec"])
    print(f"{tag} crash drill (tier-E only, one writer): mirror load "
          f"{r0['mirror_load_s']:.2f}s, the writer's gather and merge {r0['gather_s']:.3f}s, "
          f"crashed {[r['crashed'] for r in ranks]}, recovered {r0['rec']} in "
          f"{out['recover_s']} s a rank, blocks bitwise the twin's "
          f"{[r['recovered_bitwise'] for r in ranks]}; resume at "
          f"{[r['resume_at'] for r in ranks]}")
    sv = r0["serve"]
    out["serve"] = {"prefill_ms": [r["serve"]["prefill_ms"] for r in ranks],
                    "decode_ms": [r["serve"]["decode_ms"] for r in ranks],
                    "launches": sv["launches"], "parts": sv["parts"],
                    "moved": [r["serve"]["moved"] for r in ranks]}
    out["serve"].update({k: sv[k] for k in ("tokens_equal", "tokens", "first_differing",
                                            "logit_share", "prefill_logit_share",
                                            "compared_positions")})
    print(f"{tag} serving B={FS_SERVE_B} prompt {FS_S} + {FS_NEW} tokens (no warm-up): "
          f"prefill ms a rank {out['serve']['prefill_ms']} (one rank "
          f"{r0['one_serve']['prefill_ms']:.2f}), decode ms a token "
          f"{out['serve']['decode_ms']} (one rank {r0['one_serve']['decode_ms']:.3f}); "
          f"greedy tokens equal to the one-rank run's: {sv['tokens_equal']} of "
          f"{sv['tokens']}, the first that differs {sv['first_differing']}; logits over "
          f"the first {sv['compared_positions']} positions within {sv['logit_share']:.4g} of "
          f"the largest (the prefill's {sv['prefill_logit_share']:.4g}; gate "
          f"{FS_LOGIT_TOL}); launches {sv['parts']}; rank 0's collectives "
          f"{json.dumps(sv['moved'])}")
    print(f"{tag} rank 0's shapes {r0['shapes']}; each rank's collectives in all "
          + json.dumps([r["stats"] for r in ranks]))
    dq = (d // FS_MESH[0], n_q // FS_MESH[1])
    check(r0["held"]["shapes"] == {
        "wq": [L, *dq], "wk": [L, d // FS_MESH[0], kv // FS_MESH[1]],
        "attn_wo": [L, n_q // FS_MESH[1], d // FS_MESH[0]],
        "wi": [L, d // FS_MESH[0], ff // FS_MESH[1]],
        "mlp_wo": [L, ff // FS_MESH[1], d // FS_MESH[0]],
        "lm_head": [d // FS_MESH[0], V // FS_MESH[1]], "table": [V // FS_MESH[1], d],
        "adam_m_wk": [L, d // FS_MESH[0], kv // FS_MESH[1]]},
        f"{tag} rank 0 holds {r0['held']['shapes']}, not its (data, model) blocks")
    check(all(r["held"]["params"] == r["held"]["want_params"]
              and r["held"]["moments"] == r["held"]["want_moments"]
              and r["held"]["table"] == r["held"]["want_table"] for r in ranks),
          f"{tag} a rank holds other than a quarter of each blocked leaf and every other "
          f"leaf whole: {[r['held'] for r in ranks]}")
    check(all(math.isfinite(x) for r in ranks for n in ("strict", "relaxed")
              for x in r["runs"][n]["losses"]), f"{tag} a non-finite loss")
    check(all(r["runs"][n]["losses"] == r0["runs"][n]["losses"] for r in ranks
              for n in ("strict", "relaxed")), f"{tag} the ranks report different losses")
    check(loss0_gap <= FS_LOSS0_RTOL, f"{tag} step 0's loss {loss0_gap:.4g} from the "
          "one-rank run's")
    check(loss_gap <= FS_LOSS_RTOL, f"{tag} losses {loss_gap:.4g} from the one-rank run's")
    check(norm0_gap <= FS_NORM0_RTOL, f"{tag} step 0's gradient norm {norm0_gap:.4g} from "
          "the one-rank run's")
    check(r0["param_mean_share"] <= FS_PARAM_MEAN and r0["sign_agree_min"] >= FS_SIGN_MIN,
          f"{tag} params differ from the one-rank run's")
    check(all(rep_["leaves"] > 0 and not rep_["differ"]
              for reps in out["replicated"].values() for rep_ in reps),
          f"{tag} a leaf held whole differs across the ranks: {out['replicated']}")
    check(all(r["relaxed_is_strict"] for r in ranks), f"{tag} relaxed differs from strict")
    check(r0["crashed"] and not any(r["crashed"] for r in ranks[1:]),
          f"{tag} the writer did not crash alone at the scheduled step")
    check(r0["rec"] == [FS_CRASH - 1, -1, True], f"{tag} recovered {r0['rec']}")
    check(all(r["recovered_bitwise"] for r in ranks), f"{tag} a recovered block differs "
          "from the twin's")
    check(all(r["resume_at"] == FS_CRASH for r in ranks), f"{tag} resume step")
    check(all(r["serve"]["tokens_as_rank0"] for r in ranks), f"{tag} the ranks served "
          "different tokens")
    fd = sv["first_differing"]
    check(fd is None or all(t <= g for t, g in zip(fd["top2_gap"], fd["logit_gap"],
                                                     strict=True)),
          f"{tag} a served token differs from the one-rank run's where the one-rank "
          f"logits were no near tie: {fd}")
    check(sv["logit_share"] <= FS_LOGIT_TOL, f"{tag} served logits beyond the gate")
    check(all(r["runs"][n]["peak_gb"] - r["runs"][n]["checks_gb"] < r0["one_peak_gb"] / 2
              for r in ranks for n in ("strict", "relaxed")), f"{tag} a rank's peak, less "
          "the checks' copies, is not below half the one-rank run's")
    for name in ("strict", "relaxed"):
        for r in ranks:
            c = r["runs"][name]["launches"]
            need = ("flash_attention_tc", "flash_attention_bwd", "gather_rows", "embedding_bag",
                    "scatter_update") + (("scatter_update_logged",) if name == "relaxed" else ())
            check(all(c[k] > 0 for k in need), f"{tag} {name}: a kernel of the path never "
                  f"launched: {c}")
    check(all(r["serve"]["parts"]["prefill"]["flash_attention_tc"] > 0
              and r["serve"]["parts"]["prefill"]["gather_rows"] == 1
              and r["serve"]["parts"]["decode"]["gather_rows"] == FS_NEW - 1 for r in ranks),
          f"{tag} serving: want flash and one gather in the prefill and one gather a decode "
          f"step, got {[r['serve']['parts'] for r in ranks]}")
    # the ranks at data 0 hold the blocks of one copy of the table and send
    # them (one gather a checkpointed step); the others hold copies
    check(all(r["ckpt_gathers"] == (FS_CRASH + 1 if r["coords"][0] == 0 else 0)
              for r in ranks), f"{tag} the checkpoint's gathers a rank "
          f"{[r['ckpt_gathers'] for r in ranks]}, want one a checkpointed step on the "
          "ranks at data 0, none on the others")
    rl, sl = r0["runs"]["relaxed"]["launches"], r0["runs"]["strict"]["launches"]
    launches = {"flash_lse": rl["flash_attention_tc"], "flash_bwd": rl["flash_attention_bwd"],
                "gather": rl["gather_rows"], "bag": rl["embedding_bag"],
                "update_f32": rl["scatter_update"], "update_bf16": sl["scatter_update"],
                "logged": rl["scatter_update_logged"],
                "ckpt_gather": r0["ckpt_gathers"],
                "flash_prefill": sv["parts"]["prefill"]["flash_attention_tc"],
                "gather_serve_prefill": sv["parts"]["prefill"]["gather_rows"],
                "gather_serve_decode": sv["parts"]["decode"]["gather_rows"]}
    return launches, r0["timing"], r0["err"], out


MM_MESH = (1, 4)              # (data, model): four gloo ranks sharing the card
MM_QWEN, MM_ARCTIC, MM_JAMBA = "qwen3-moe-235b-a22b", "arctic-480b", "jamba-v0.1-52b"
# the depths run, of 94, 35 and 32 layers: qwen3-moe's one layer trained
# and served; jamba trained at 2 (a mamba layer with a dense FFN and one
# with MoE) and served at 8 (one attention period: its caches need one);
# arctic served at 1 (one layer trained would hold about 160 GB: 13.4e9
# expert elements at 12 bytes with AdamW, so it trains on the CPU only)
MM_LAYERS = {("train", MM_QWEN): 1, ("serve", MM_QWEN): 1, ("train", MM_JAMBA): 2,
             ("serve", MM_JAMBA): 8, ("serve", MM_ARCTIC): 1}
MM_B, MM_S = 2, 512           # the global training batch, one data group at (1, 4)
MM_SERVE_B, MM_NEW = 2, 3     # serving: batch 2, prompt MM_S, a prefill and 2 decode steps
MM_CRASH = 1                  # qwen3-moe's writer crashes between step 1's COMMIT and apply
# Phase 29's gates against the one-rank run of the same weights, each
# beside what an H100 80GB HBM3 at 700 W measured: step 0's loss (1.96e-6
# qwen3-moe, 6.43e-6 jamba: each rank's row-parallel partial is f32 and
# the sum is rounded once, the remaining gap the products' other
# summation orders; with the partials widened and summed as TF32, jamba's
# was 2.37e-5); qwen3-moe step 1's (3.39e-4: AdamW's first step
# moves an element whose gradient is near zero by about the learning rate
# either way); the served logits on the rows routed alike in every MoE
# layer up to the first greedy token that differs, as a share of the
# largest logit (qwen3-moe 5.71e-3)
MM_LOSS0_RTOL = 1e-5
MM_LOSS_RTOL = 1e-2
MM_LOGIT_TOL = 1.5e-2
# A row that routes alike is rare at prompt 512: one near tie in any of its
# tokens' top-k flips a route (on the same card: jamba 104 of 8,224 (token,
# slot) pairs, arctic 6 of 2,056, qwen3-moe 0), and a flip moves every
# later logit of its row (jamba's by 8.4e-2 of the largest). So the
# routing is held by the share of pairs that flipped, and what precedes
# any routing by the prefill's input to the first MoE layer on every row,
# as a share of its largest magnitude (phase 24's rule, 6.99e-3 there;
# here 6.25e-3 qwen3-moe, 8.98e-3 jamba, 8.93e-3 arctic). The decode steps
# are held on their own: run again from the one-rank prefill's state, cut
# to each rank's heads and channels, and fed the one-rank tokens, their
# logits on the (row, step)s routed alike within MM_LOGIT_TOL (5.71e-3,
# 1.17e-2 and 6.13e-3; no pair flipped), so a flip in the prefill does not
# hide a decode fault
MM_FLIP_MAX = 0.05
MM_MOE_INPUT_TOL = 2e-2


def moe_mesh_model(arch, kind):
    """``arch`` at full width, its depth cut to MM_LAYERS, under its own
    profile: (bundle, cfg)."""
    from repro_torch.configs import get_arch
    full = get_arch(arch)
    cfg = full.model.replace(num_layers=MM_LAYERS[(kind, arch)])
    return dataclasses.replace(full, model=cfg), cfg


def bits_digest(torch, tree):
    """Two sums of each leaf's bit patterns (the second weighted by the
    element's place): equal trees give equal digests, so two runs' states
    are compared bitwise without a second copy of either on the card."""
    from repro_torch.tree import tree_leaves
    out = []
    for x in tree_leaves(tree):
        bits = x.detach().reshape(-1).view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                                            8: torch.int64}[x.element_size()])
        s1 = s2 = 0
        for i in range(0, bits.numel(), 1 << 26):
            c = bits[i:i + (1 << 26)].to(torch.int64)
            w = torch.arange(i, i + c.numel(), device=c.device) % 65521 + 1
            s1 += int(c.sum())
            s2 += int((c * w).sum())
        out.append((s1, s2))
    return out


def routing_alike(torch, a, b, steps, recorded=MM_NEW):
    """Two serving runs' ``moe.recording`` records of ``recorded`` steps (a
    prefill's MoE layers, then each decode step's; or decode steps alone)
    compared over the first ``steps`` steps: (rows (B, steps) bool, row b
    routed alike in every MoE layer of every step up to t; the (token,
    slot) pairs whose sorted experts differ; the pairs compared)."""
    n = len(a) // recorded
    alike, flipped, pairs = [], 0, 0
    for t in range(steps):
        ok = None
        for ra, rb in zip(a[t * n:(t + 1) * n], b[t * n:(t + 1) * n], strict=True):
            ca, cb = ra["choice"].sort(-1).values, rb["choice"].sort(-1).values
            flipped += int((ca != cb).sum())
            pairs += ca.numel()
            same = (ca == cb).all(-1).reshape(MM_SERVE_B, -1).all(-1).cpu()
            ok = same if ok is None else ok & same
        alike.append(ok if not alike else alike[-1] & ok)
    return torch.stack(alike, 1), flipped, pairs


def moe_mesh_rank(rank, world, device, work, seed):
    """Phase 29, one rank of ``world`` gloo ranks sharing ``device``:
    qwen3-moe, jamba and arctic at full width, their depths cut to
    MM_LAYERS, under the rules the port's ``build_rules`` gives each
    profile (fsdp, Megatron-SP) at (data, model) = MM_MESH: the experts
    over model, heads and the sequence over model, jamba's SSD heads split
    over model, ``w_embed`` over a data axis of one rank (FSDP's code runs,
    moves no weight). Rank 0 first runs each one-rank reference alone
    (qwen3-moe 2 strict steps and a generation, jamba 1 strict step at 2
    layers and a generation at 8, arctic a generation), freeing each. Then
    every rank: qwen3-moe 1 strict step, then MM_CRASH + 1 relaxed steps
    into a mesh checkpoint (tier-E only) whose writer crashes in the
    last, recovery at every rank, one resumed step; jamba 1 strict and 1
    relaxed step; each id served under its decode rules. Rank 0 holds the
    kernels at qwen3-moe's rank shapes against their plain versions and
    times them. Writes ``work/rank{rank}.pt``."""
    import torch

    from repro_torch.configs.base import SHAPES, CheckpointConfig, TrainConfig
    from repro_torch.data.lookahead import LookaheadIterator
    from repro_torch.data.synthetic import make_batches
    from repro_torch.distributed import fsdp, sharding
    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.distributed.checkpoint import MeshCheckpoint, recover_on_mesh
    from repro_torch.kernels import gather_rows as gr
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe
    from repro_torch.models.registry import get_api
    from repro_torch.pool import FaultSchedule, InjectedCrash
    from repro_torch.training import train_loop
    from repro_torch.training.serve_loop import greedy_generate, make_serve_fns
    from repro_torch.tree import tree_map, tree_map_with_path

    torch.backends.cuda.matmul.allow_tf32 = False
    tc = TrainConfig(embed_learning_rate=0.05, seed=seed)
    writer = rank == 0
    mesh = make_local_mesh(model_parallel=MM_MESH[1], device=device)
    models = {key: moe_mesh_model(key[1], key[0]) for key in MM_LAYERS}
    rules = {}
    for key, (bundle, _) in models.items():
        act, weights, _ = dryrun.build_rules(
            bundle, SHAPES["train_4k" if key[0] == "train" else "decode_32k"], mesh)
        rules[key] = {**act, **weights}
    out = {"device": str(device), "rules": {f"{k}/{a}": r for (k, a), r in rules.items()},
           "runs": {}, "serve": {}, "coords": [mesh.coords["data"], mesh.coords["model"]]}
    t_all = time.perf_counter()

    def say(msg):
        print(f"[moe-mesh] rank {rank}: {msg}", flush=True)

    def params(key, sharded):
        cfg = models[key][1]
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        kw = {"keep": sharding.keep_shard(mesh, rules[key])} if sharded else {}
        p = get_api(cfg).init(gen, cfg, **kw)
        torch.cuda.synchronize(device)
        # the whole leaves drawn and cut go back to the card, not to this
        # rank's cache: the four ranks share it
        torch.cuda.empty_cache()
        return p

    def run(name, key, state, relaxed, n, start=0, mgr=None, on_step=None):
        """``n`` steps from ``start``: losses, gradient norms, each step's
        host ms and collectives, launches."""
        cfg = models[key][1]
        batches = LookaheadIterator(make_batches(cfg, MM_B, MM_S, device=device), cfg,
                                    depth=n + 2, start_step=start)
        rec = out["runs"][name] = {"losses": [], "norms": [], "step_ms": [], "moved": []}
        torch.cuda.synchronize(device)
        tp_counts(zero=True)
        ctx = sharding.current()
        mark = [time.perf_counter(), mesh.stats() if ctx else {}]

        def on_metrics(k, m):
            rec["losses"].append(float(m["loss"]))
            rec["norms"].append(float(m["grad_norm"]))
            if on_step is not None:
                on_step(k, m)
            torch.cuda.synchronize(device)
            rec["step_ms"].append(1e3 * (time.perf_counter() - mark[0]))
            if ctx is not None:
                rec["moved"].append(stats_since(mesh, mark[1]))
                mark[1] = mesh.stats()
            mark[0] = time.perf_counter()
        try:
            train_loop.train(cfg, tc, batches, n, relaxed=relaxed, state=state,
                             start_step=start, ckpt_manager=mgr, on_metrics=on_metrics)
        finally:
            rec["launches"] = tp_counts()

    def generate(key, p):
        cfg = models[key][1]
        prompt = make_batches(cfg, MM_SERVE_B, MM_S, device=device).next(0)["tokens"]
        parts = {}

        @contextlib.contextmanager
        def part(name):
            before = tp_counts()
            yield
            parts[name] = {k: v - before[k] for k, v in tp_counts().items()}
        with torch.no_grad(), moe.recording() as routed:
            tp_counts(zero=True)
            before = mesh.stats()
            st = {}
            toks = greedy_generate(cfg, p, prompt, MM_NEW, stats=st, part=part)
            return {"tokens": toks, "logits": st["logits"], "routed": [
                        {"choice": r["choice"]} for r in routed],
                    "moe_input": routed[0]["x"].float(),
                    "prefill_ms": 1e3 * st["prefill_s"],
                    "decode_ms": 1e3 * st["decode_s"] / (MM_NEW - 1),
                    "launches": tp_counts(), "parts": parts,
                    "moved": stats_since(mesh, before)}

    def prefilled(key, p):
        """The one-rank prefill's caches of the served prompt, on the host."""
        cfg = models[key][1]
        prefill_step, _, init_cache = make_serve_fns(cfg)
        prompt = make_batches(cfg, MM_SERVE_B, MM_S, device=device).next(0)["tokens"]
        with torch.no_grad():
            _, caches = prefill_step(p, {"tokens": prompt},
                                     init_cache(MM_SERVE_B, MM_S + MM_NEW, device))
        return tree_map(lambda a: a.cpu(), caches)

    def forced(key, p, whole, tokens):
        """The decode steps from the one-rank prefill's caches ``whole``
        (each leaf cut to this rank's block of its SSD heads, channels or kv
        heads), fed the one-rank run's greedy tokens: (logits (B, MM_NEW -
        1, V) f32, each step's routing records). A decode step is so held
        against one rank's from the same state, whatever the prefills'
        routes did."""
        cfg = models[key][1]
        _, decode_step, init_cache = make_serve_fns(cfg)
        n, r = mesh.axis_size("model"), mesh.axis_index("model")

        def cut(path, local, a):
            a = a.to(device, copy=True)           # the decode steps write the caches
            for dim, (lo, wh) in enumerate(zip(local.shape, a.shape)):
                if lo == wh:
                    continue
                if path.split("/")[-1] in ("k", "v") and tpm.kv_replicated(cfg):
                    first = tpm.kv_cols(cfg).start // cfg.resolved_head_dim
                elif wh == lo * n:
                    first = r * lo
                else:
                    raise ValueError(f"{path}: a cache leaf {tuple(a.shape)} is no {n} "
                                     f"blocks of {tuple(local.shape)}")
                a = a.narrow(dim, first, lo)
            return a.contiguous()
        caches = tree_map_with_path(cut, init_cache(MM_SERVE_B, MM_S + MM_NEW, device),
                                    whole)
        tokens = tokens.to(device)
        kept = []
        with torch.no_grad(), moe.recording() as routed:
            for t in range(MM_NEW - 1):
                logits, caches = decode_step(p, tokens[:, t:t + 1], MM_S + t, caches)
                kept.append(logits)
        return torch.stack(kept, 1), [{"choice": x["choice"]} for x in routed]

    def held(key, state):
        """The elements this rank holds and those it should: every blocked
        leaf's whole elements over the ranks of its held axes, every other
        leaf whole."""
        cfg = models[key][1]
        have = want = 0

        def one(path, x):
            nonlocal have, want
            have += x.numel()
            dims = fsdp.held_dims(cfg, path, x.dim())
            want += (math.prod(fsdp.whole_shape(cfg, path, x.dim())) //
                     math.prod(mesh.sizes[a] for a in dims.values())) if dims else x.numel()
        tree_map_with_path(one, state["dense"])
        return {"params": have, "want_params": want,
                "bytes": nbytes(state["dense"]) + nbytes(state["opt_dense"]),
                "table": list(state["embed"]["table"].shape)}

    def in_place(state):
        return {"dense": state["dense"], "m": state["opt_dense"]["m"],
                "v": state["opt_dense"]["v"], "table": state["embed"]["table"]}

    # (a) the one-rank references, rank 0 alone, each freed before the next
    one = {}
    if writer:
        t = time.perf_counter()
        for key in MM_LAYERS:
            torch.cuda.reset_peak_memory_stats(device)
            cfg = models[key][1]
            if key[0] == "train":
                n = 2 if key[1] == MM_QWEN else 1
                state = train_loop.make_step_fns(cfg, tc)[0](params(key, False))
                run(f"one/{key[1]}", key, state, relaxed=False, n=n)
                del state
            else:
                p = params(key, False)
                one[key] = generate(key, p)
                whole = prefilled(key, p)
                one[key]["forced"] = forced(key, p, whole, one[key]["tokens"])
                torch.save({"caches": whole, "tokens": one[key]["tokens"].cpu()},
                           os.path.join(work, f"prefilled-{key[1]}.pt"))
                del p, whole
            out[f"one_peak_gb/{key[0]}/{key[1]}"] = \
                torch.cuda.max_memory_allocated(device) / 1e9
            torch.cuda.empty_cache()
        out["one_s"] = time.perf_counter() - t
        say(f"one-rank references in {out['one_s']:.1f}s")
    mesh.barrier()
    x = torch.ones((4, 4), dtype=torch.bfloat16, device=device)
    mesh.reduce_scatter(mesh.all_gather(x, "model", 0), "model", 0)  # the group's first use
    mesh.moved.clear()

    # (b) qwen3-moe trained: one strict step; the relaxed steps through the
    # mesh checkpoint, whose writer crashes in step MM_CRASH; recovery at
    # every rank; one resumed step
    t = time.perf_counter()
    key = ("train", MM_QWEN)
    cfg = models[key][1]
    init_fn = train_loop.make_step_fns(cfg, tc)[0]
    cc = CheckpointConfig(directory=os.path.join(work, "ckpt"), dense_interval=0,
                          pool_backend="pmem", pool_compress="none")
    with sharding.use_sharding(mesh, rules[key]):
        torch.cuda.reset_peak_memory_stats(device)
        state = init_fn(params(key, True))
        out["held"] = held(key, state)
        run("qwen_strict", key, state, relaxed=False, n=1)
        out["runs"]["qwen_strict"]["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
        strict = bits_digest(torch, in_place(state))
        del state
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        state = init_fn(params(key, True))
        faults = FaultSchedule.crash_at("tier_e.between-commit-and-apply",
                                        occurrence=MM_CRASH + 1)
        mgr = MeshCheckpoint(cfg, cc, embed_init=state["embed"],
                             faults=faults if writer else None)
        out["ckpt_gathers"] = 0
        inner = mgr.on_step

        def counted(step, st, feed):
            before = gr.launches
            try:
                return inner(step, st, feed)
            finally:
                out["ckpt_gathers"] += gr.launches - before
        mgr.on_step = counted
        twin = {}

        def keep(k, _):
            if k == MM_CRASH - 1:   # the twin after this step: its digest, the
                # dense tier and moments on the host, the table block on the card
                twin["digest"] = bits_digest(torch, in_place(state))
                twin["dense"] = tree_map(lambda x: x.to("cpu", copy=True), {
                    "dense": state["dense"], "m": state["opt_dense"]["m"],
                    "v": state["opt_dense"]["v"]})
                twin["table"] = state["embed"]["table"].clone()
        out["crashed"] = False
        try:
            run("qwen_relaxed", key, state, relaxed=True, n=MM_CRASH + 1, mgr=mgr,
                on_step=keep)
        except InjectedCrash:
            out["crashed"] = True
            mgr.manager.pool.close()           # the writer's process death
        out["runs"]["qwen_relaxed"]["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
        out["relaxed_is_strict"] = twin["digest"] == strict
        batch0 = sharding.shard_batch(make_batches(cfg, MM_B, MM_S, device=device).next(0),
                                      mesh, rules[key])
        block = state["embed"]["table"].clone() if writer else None
        del state, mgr, counted, inner       # the wrapper and the manager hold each other
        torch.cuda.empty_cache()
        t_rec = time.perf_counter()
        fresh = init_fn(params(key, True))
        d = twin.pop("dense")
        tree_map(lambda a, b: a.copy_(b), {"dense": fresh["dense"],
                                           "m": fresh["opt_dense"]["m"],
                                           "v": fresh["opt_dense"]["v"]}, d)
        fresh["opt_dense"]["t"].fill_(MM_CRASH)
        del d
        state, start, rec = recover_on_mesh(cfg, cc.directory, fresh)
        torch.cuda.synchronize(device)
        out["recover_s"] = time.perf_counter() - t_rec
        out["resume_at"] = start
        out["recovered_bitwise"] = bits_digest(torch, in_place(state)) == twin["digest"] \
            and torch.equal(state["embed"]["table"], twin.pop("table"))
        if writer:
            out["rec"] = [rec.mirror_step, rec.dense_step, rec.rolled_back]
            rec.pool.close()
        run("qwen_resumed", key, state, relaxed=True, n=1, start=start)
        del state, fresh
    torch.cuda.empty_cache()
    out["qwen_train_s"] = time.perf_counter() - t
    say(f"qwen3-moe: strict {out['runs']['qwen_strict']['losses']}, relaxed "
        f"{out['runs']['qwen_relaxed']['losses']}, resumed {out['runs']['qwen_resumed']['losses']}")

    # (c) jamba trained at 2 layers: one strict and one relaxed step
    t = time.perf_counter()
    key = ("train", MM_JAMBA)
    cfg = models[key][1]
    init_fn = train_loop.make_step_fns(cfg, tc)[0]
    with sharding.use_sharding(mesh, rules[key]):
        digests = {}
        for name, relaxed in (("jamba_strict", False), ("jamba_relaxed", True)):
            torch.cuda.reset_peak_memory_stats(device)
            state = init_fn(params(key, True))
            out.setdefault("held_jamba", held(key, state))
            run(name, key, state, relaxed=relaxed, n=1)
            out["runs"][name]["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
            digests[name] = bits_digest(torch, in_place(state))
            del state
            torch.cuda.empty_cache()
        out["jamba_relaxed_is_strict"] = digests["jamba_strict"] == digests["jamba_relaxed"]
    out["jamba_train_s"] = time.perf_counter() - t
    say(f"jamba: strict {out['runs']['jamba_strict']['losses']}, relaxed "
        f"{out['runs']['jamba_relaxed']['losses']}")

    # (d) each id served under its decode rules; rank 0 against the one-rank
    # run on the rows routed alike
    for key in (k for k in MM_LAYERS if k[0] == "serve"):
        t = time.perf_counter()
        cfg = models[key][1]
        with sharding.use_sharding(mesh, rules[key]):
            torch.cuda.reset_peak_memory_stats(device)
            if key[1] == MM_ARCTIC:      # ranks draw in turn: a whole expert leaf is 8.9 GB
                for r in range(world):
                    if r == rank:
                        p = params(key, True)
                    mesh.barrier()
            else:
                p = params(key, True)
            got = generate(key, p)
            peak = torch.cuda.max_memory_allocated(device) / 1e9
            ref = torch.load(os.path.join(work, f"prefilled-{key[1]}.pt"))
            got["forced"] = forced(key, p, ref["caches"], ref["tokens"])
            del p, ref
        torch.cuda.empty_cache()
        sv = {k: v for k, v in got.items()
              if k not in ("tokens", "logits", "routed", "moe_input", "forced")}
        sv["peak_gb"] = peak
        toks0 = mesh.broadcast(got["tokens"].clone(), mesh.axis_names, 0)
        sv["tokens_as_rank0"] = bool(torch.equal(toks0, got["tokens"]))
        if writer:
            want = one.pop(key)
            scale = want["logits"].abs().max().item()
            same = got["tokens"] == want["tokens"]
            cols = torch.nonzero(~same.all(dim=0)).flatten()
            upto = int(cols[0]) + 1 if cols.numel() else MM_NEW
            rows, flipped, pairs = routing_alike(torch, got["routed"], want["routed"], upto)
            gap = (got["logits"][:, :upto] - want["logits"][:, :upto]).abs().amax(-1).cpu()
            x_gap = (got["moe_input"] - want["moe_input"]).abs().max().item() \
                / want["moe_input"].abs().max().item()
            f_logits, f_routed = got["forced"]
            w_logits, w_routed = want["forced"]
            f_rows, f_flipped, f_pairs = routing_alike(torch, f_routed, w_routed,
                                                       MM_NEW - 1, MM_NEW - 1)
            f_gap = (f_logits - w_logits).abs().amax(-1).cpu()
            sv.update(forced_flipped_pairs=f_flipped, forced_pairs=f_pairs,
                      forced_rows_alike=int(f_rows.sum()), forced_rows=int(f_rows.numel()),
                      forced_logit_share=(f_gap[f_rows].max().item() / scale)
                      if f_rows.any() else float("inf"),
                      forced_logit_share_all=f_gap.max().item() / scale)
            sv.update(tokens_equal=int(same.sum()), tokens=int(same.numel()),
                      compared_positions=upto, flipped_pairs=flipped, pairs=pairs,
                      moe_input_share=x_gap,
                      rows_alike=int(rows.sum()), rows=int(rows.numel()),
                      logit_share=(gap[rows].max().item() / scale) if rows.any() else 0.0,
                      logit_share_all=gap.max().item() / scale,
                      one_prefill_ms=want["prefill_ms"], one_decode_ms=want["decode_ms"])
        out["serve"][key[1]] = sv
        out["serve"][key[1]]["s"] = time.perf_counter() - t
        del got
    say(f"served {[(a, out['serve'][a].get('tokens_equal')) for a in out['serve']]}")

    # (e) rank 0: the kernels at qwen3-moe's rank shapes against their plain
    # versions, timed
    if writer:
        t = time.perf_counter()
        cfg = models[("train", MM_QWEN)][1]
        serve_ids = {"prefill": make_batches(cfg, MM_SERVE_B, MM_S,
                                             device=device).next(0)["tokens"],
                     "decode": batch0["tokens"][:, 0]}
        out["timing"], out["err"], out["shapes"] = tp_kernels(
            torch, device, cfg, block, batch0, serve_ids, tag="[moe-mesh]", key="moe",
            heads=(cfg.num_heads // MM_MESH[1], cfg.num_kv_heads // MM_MESH[1]),
            train=(MM_B // MM_MESH[0], MM_S), serve=(MM_SERVE_B, MM_S))
        out["kernels_s"] = time.perf_counter() - t
        del block
    mesh.barrier()
    out["stats"] = mesh.stats()
    out["rank_s"] = time.perf_counter() - t_all
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))


def moe_mesh_phase(torch, np, dev, tc):
    """Phase 29: full-width qwen3-moe, jamba and arctic (cut in depth) under
    their own profiles at four gloo ranks on this one card
    (``moe_mesh_rank``), held against the one-rank runs. Returns (rank 0's
    launches by path, its timings, its kernel errors, the metrics)."""
    import shutil
    import tempfile

    from repro_torch.launch import mesh

    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="moe-mesh-", dir=build)
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        mesh.spawn(moe_mesh_rank, math.prod(MM_MESH), backend="gloo",
                   device=f"cuda:{dev.index or 0}", args=(work, tc.seed), timeout=600)
        spawn_s = time.perf_counter() - t
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
                 for r in range(math.prod(MM_MESH))]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return moe_mesh_report(ranks, spawn_s)


def moe_mesh_report(ranks, spawn_s):
    """Phase 29's results from its ranks: printed, held to the gates."""
    tag, r0 = "[moe-mesh]", ranks[0]
    runs = r0["runs"]
    out = {"spawn_s": spawn_s, "mesh": list(MM_MESH),
           "layers": {f"{k}/{a}": n for (k, a), n in MM_LAYERS.items()},
           "rules": r0["rules"], "held": [r["held"] for r in ranks],
           "held_jamba": [r["held_jamba"] for r in ranks],
           "one_peak_gb": {k: v for k, v in r0.items() if k.startswith("one_peak_gb/")},
           "seconds": {k: r0[k] for k in ("one_s", "qwen_train_s", "jamba_train_s",
                                           "kernels_s", "rank_s")}}
    print(f"{tag} four gloo ranks on {[r['device'] for r in ranks]}, (data, model) = "
          f"{MM_MESH}, depths {out['layers']}; rules {r0['rules']}; spawn to the last "
          f"rank's end {spawn_s:.1f}s; rank 0's parts (s) {out['seconds']}")
    for r in ranks:
        print(f"{tag} rank {r['coords']} holds qwen3-moe {r['held']} and jamba "
              f"{r['held_jamba']} (params: elements held, and those its blocks should "
              "hold; bytes: params and AdamW moments)")
    one_q, one_j = runs[f"one/{MM_QWEN}"], runs[f"one/{MM_JAMBA}"]
    q_losses = [r["runs"]["qwen_strict"]["losses"][:1] + r["runs"]["qwen_relaxed"]["losses"]
                for r in ranks]
    j_losses = [r["runs"]["jamba_strict"]["losses"] + r["runs"]["jamba_relaxed"]["losses"]
                for r in ranks]
    gaps0 = {name: max(abs(ls[0] - want["losses"][0]) / abs(want["losses"][0])
                       for ls in ls_all)
             for name, ls_all, want in (("qwen", q_losses, one_q), ("jamba", j_losses, one_j))}
    loss0_gap = max(gaps0.values())
    loss_gap = max(abs(ls[2] - one_q["losses"][1]) / abs(one_q["losses"][1])
                   for ls in q_losses)
    out.update(loss0_rel_gap=gaps0, loss1_rel_gap=loss_gap,
               one_losses={"qwen": one_q["losses"], "jamba": one_j["losses"]},
               one_step_ms={"qwen": one_q["step_ms"], "jamba": one_j["step_ms"]})
    for name in ("qwen_strict", "qwen_relaxed", "qwen_resumed", "jamba_strict",
                 "jamba_relaxed"):
        rr = runs[name]
        out[name] = {"losses": rr["losses"], "norms": rr["norms"],
                     "step_ms": [r["runs"][name]["step_ms"] for r in ranks],
                     "launches": [r["runs"][name]["launches"] for r in ranks],
                     "moved_per_step": [r["runs"][name]["moved"] for r in ranks],
                     "peak_gb": [r["runs"][name].get("peak_gb") for r in ranks]}
        print(f"{tag} {name}: losses {rr['losses']}, gradient norms {rr['norms']}; "
              f"step ms a rank {out[name]['step_ms']}; peak GB a rank {out[name]['peak_gb']}; "
              f"launches a rank {out[name]['launches']}")
        print(f"{tag} {name} rank 0's collectives a step: " + json.dumps(rr["moved"]))
    print(f"{tag} one-rank references: qwen3-moe losses {one_q['losses']} step ms "
          f"{one_q['step_ms']}, jamba {one_j['losses']} step ms {one_j['step_ms']}; peaks "
          f"{out['one_peak_gb']}")
    print(f"{tag} against the one-rank run: step 0's loss {gaps0} relative (gate "
          f"{MM_LOSS0_RTOL}), qwen3-moe step 1's {loss_gap:.4g} (gate {MM_LOSS_RTOL}); "
          f"relaxed == strict bitwise: qwen3-moe {[r['relaxed_is_strict'] for r in ranks]}, "
          f"jamba {[r['jamba_relaxed_is_strict'] for r in ranks]}")
    out.update(recover_s=[r["recover_s"] for r in ranks], rec=r0["rec"],
               ckpt_gathers=[r["ckpt_gathers"] for r in ranks])
    print(f"{tag} crash drill (qwen3-moe, tier-E only, one writer): crashed "
          f"{[r['crashed'] for r in ranks]}, recovered {r0['rec']} in {out['recover_s']} s "
          f"a rank, bitwise the twin's {[r['recovered_bitwise'] for r in ranks]}, resume at "
          f"{[r['resume_at'] for r in ranks]}, the resumed step's loss "
          f"{runs['qwen_resumed']['losses']} (the uninterrupted step's "
          f"{runs['qwen_relaxed']['losses'][MM_CRASH:]})")
    for arch, sv in r0["serve"].items():
        out.setdefault("serve", {})[arch] = {
            **{k: sv[k] for k in ("tokens_equal", "tokens", "compared_positions",
                                  "flipped_pairs", "pairs", "moe_input_share",
                                  "rows_alike", "rows", "logit_share",
                                  "logit_share_all", "forced_flipped_pairs",
                                  "forced_pairs", "forced_rows_alike", "forced_rows",
                                  "forced_logit_share", "forced_logit_share_all",
                                  "one_prefill_ms", "one_decode_ms",
                                  "parts", "moved", "s")},
            "prefill_ms": [r["serve"][arch]["prefill_ms"] for r in ranks],
            "decode_ms": [r["serve"][arch]["decode_ms"] for r in ranks],
            "peak_gb": [r["serve"][arch]["peak_gb"] for r in ranks]}
        print(f"{tag} {arch} served B={MM_SERVE_B} prompt {MM_S} + {MM_NEW} tokens (no "
              f"warm-up): prefill ms a rank {out['serve'][arch]['prefill_ms']} (one rank "
              f"{sv['one_prefill_ms']:.2f}), decode ms a token {out['serve'][arch]['decode_ms']}"
              f" (one rank {sv['one_decode_ms']:.2f}); tokens equal {sv['tokens_equal']} of "
              f"{sv['tokens']}; routing: {sv['flipped_pairs']} of {sv['pairs']} (token, "
              f"slot) pairs flipped over the first {sv['compared_positions']} positions "
              f"(gate a share of {MM_FLIP_MAX}), rows routed alike {sv['rows_alike']} of "
              f"{sv['rows']}; logits on those rows within {sv['logit_share']:.4g} of the "
              f"largest (gate {MM_LOGIT_TOL}; every row {sv['logit_share_all']:.4g}); the "
              f"prefill's first MoE input within {sv['moe_input_share']:.4g} of its largest "
              f"(gate {MM_MOE_INPUT_TOL}); the {MM_NEW - 1} decode steps from the one-rank "
              f"prefill's state fed its tokens: {sv['forced_flipped_pairs']} of "
              f"{sv['forced_pairs']} pairs flipped, (row, step)s routed alike "
              f"{sv['forced_rows_alike']} of {sv['forced_rows']}, their logits within "
              f"{sv['forced_logit_share']:.4g} of the largest (gate {MM_LOGIT_TOL}; every "
              f"(row, step) {sv['forced_logit_share_all']:.4g}); "
              f"peak GB a rank {out['serve'][arch]['peak_gb']}; "
              f"launches {sv['parts']}; rank 0's collectives {json.dumps(sv['moved'])}")
    print(f"{tag} rank 0's shapes {r0['shapes']}; each rank's collectives in all "
          + json.dumps([r["stats"] for r in ranks]))
    print(f"{tag} the gates' readings, unrounded: " + json.dumps(
        {"loss0_rel_gap": gaps0, "loss1_rel_gap": loss_gap,
         "serve": {a: {k: v for k, v in sv.items() if k.endswith(("share", "share_all", "pairs"))}
                   for a, sv in out["serve"].items()}}))
    check(all(r["held"]["params"] == r["held"]["want_params"]
              and r["held_jamba"]["params"] == r["held_jamba"]["want_params"] for r in ranks),
          f"{tag} a rank holds other than its blocks: {[r['held'] for r in ranks]}")
    every = [x for ls in q_losses + j_losses for x in ls]
    check(all(math.isfinite(x) for x in every), f"{tag} a non-finite loss")
    check(all(ls == q_losses[0] for ls in q_losses) and all(ls == j_losses[0]
                                                            for ls in j_losses),
          f"{tag} the ranks report different losses")
    check(loss0_gap <= MM_LOSS0_RTOL, f"{tag} step 0's loss {loss0_gap:.4g} from the "
          "one-rank run's")
    check(loss_gap <= MM_LOSS_RTOL, f"{tag} step 1's loss {loss_gap:.4g} from the one-rank "
          "run's")
    check(all(r["relaxed_is_strict"] and r["jamba_relaxed_is_strict"] for r in ranks),
          f"{tag} relaxed differs from strict")
    check(r0["crashed"] and not any(r["crashed"] for r in ranks[1:]),
          f"{tag} the writer did not crash alone at the scheduled step")
    check(r0["rec"] == [MM_CRASH - 1, -1, True], f"{tag} recovered {r0['rec']}")
    check(all(r["recovered_bitwise"] for r in ranks), f"{tag} a recovered state differs "
          "from the twin's")
    check(all(r["resume_at"] == MM_CRASH for r in ranks), f"{tag} resume step")
    check(runs["qwen_resumed"]["losses"] == runs["qwen_relaxed"]["losses"][MM_CRASH:],
          f"{tag} the resumed step's loss is not the uninterrupted step's")
    for arch, sv in out["serve"].items():
        check(all(r["serve"][arch]["tokens_as_rank0"] for r in ranks),
              f"{tag} {arch}: the ranks served different tokens")
        check(sv["logit_share"] <= MM_LOGIT_TOL,
              f"{tag} {arch}: served logits beyond the gate on the rows routed alike")
        check(sv["flipped_pairs"] <= MM_FLIP_MAX * sv["pairs"],
              f"{tag} {arch}: {sv['flipped_pairs']} of {sv['pairs']} routes flipped")
        check(sv["moe_input_share"] <= MM_MOE_INPUT_TOL,
              f"{tag} {arch}: the prefill's first MoE input differs from the one-rank run's")
        check(sv["forced_logit_share"] <= MM_LOGIT_TOL,
              f"{tag} {arch}: the decode steps from the one-rank state beyond the gate on "
              f"the (row, step)s routed alike ({sv['forced_rows_alike']} of "
              f"{sv['forced_rows']})")
        check(sv["parts"]["prefill"]["flash_attention_tc"] > 0
              and sv["parts"]["prefill"]["gather_rows"] == 1
              and sv["parts"]["decode"]["gather_rows"] == MM_NEW - 1,
              f"{tag} {arch} serving: want flash and one gather in the prefill and one "
              f"gather a decode step, got {sv['parts']}")
    for name in ("qwen_strict", "qwen_relaxed", "jamba_strict", "jamba_relaxed"):
        for r in ranks:
            c = r["runs"][name]["launches"]
            need = ("gather_rows", "embedding_bag", "scatter_update") \
                + (("flash_attention_tc", "flash_attention_bwd") if "qwen" in name else ()) \
                + (("scatter_update_logged",) if "relaxed" in name else ())
            check(all(c[k] > 0 for k in need), f"{tag} {name}: a kernel of the path never "
                  f"launched: {c}")
    # the ranks hold the blocks of one copy of the table and send them (one
    # gather a checkpointed step)
    check(all(r["ckpt_gathers"] == MM_CRASH + 1 for r in ranks),
          f"{tag} the checkpoint's gathers a rank {out['ckpt_gathers']}")
    rl, sl = runs["qwen_relaxed"]["launches"], runs["qwen_strict"]["launches"]
    sv = r0["serve"][MM_QWEN]["parts"]
    launches = {"flash_lse": rl["flash_attention_tc"], "flash_bwd": rl["flash_attention_bwd"],
                "gather": rl["gather_rows"], "bag": rl["embedding_bag"],
                "update_f32": rl["scatter_update"], "update_bf16": sl["scatter_update"],
                "logged": rl["scatter_update_logged"], "ckpt_gather": r0["ckpt_gathers"],
                "flash_prefill": sv["prefill"]["flash_attention_tc"],
                "gather_serve_prefill": sv["prefill"]["gather_rows"],
                "gather_serve_decode": sv["decode"]["gather_rows"]}
    return launches, r0["timing"], r0["err"], out


def train_loop_train(cfg, tc, batches, steps, state, mgr, on_metrics, start=0):
    """``train_loop.train`` of relaxed steps on the card."""
    from repro_torch.training import train_loop
    return train_loop.train(cfg, tc, batches, steps, relaxed=True, state=state,
                            start_step=start, ckpt_manager=mgr,
                            on_metrics=on_metrics)


def pool_counters(metrics):
    """A copy of ``metrics.snapshot()`` (a snapshot's per-kind entries are
    the live counters' own dicts)."""
    return json.loads(json.dumps(metrics.snapshot()))


def metrics_since(before, metrics):
    """The port's PoolMetrics of the traffic ``metrics`` counted since
    ``before``, a ``pool_counters`` copy of the same pool's: each kind's
    ops, bytes and modelled seconds, the near-memory and compression meters
    and the compression tallies."""
    from repro_torch.pool import PoolMetrics
    m = PoolMetrics.from_snapshot(pool_counters(metrics))
    for side, table in (("media", m.media), ("link", m.link)):
        for kind, st in (before.get(side) or {}).items():
            now = table[kind]
            now.ops -= int(st["ops"])
            now.nbytes -= int(st["nbytes"])
            now.time_s -= float(st["time_s"])
            if now.ops == 0:
                del table[kind]
    m.ndp_time_s -= before["ndp_time_s"]
    m.comp_raw_bytes -= before["comp_raw_bytes"]
    m.comp_stored_bytes -= before["comp_stored_bytes"]
    m.comp_time_s -= before["comp_time_s"]
    for kind, (raw, stored) in before["comp"].items():
        m.comp[kind] = [m.comp[kind][0] - raw, m.comp[kind][1] - stored]
        if m.comp[kind][0] == 0:
            del m.comp[kind]
    return m


# Phase 26's pinned numbers: measured_pool_batch at the reference's default
# sizes (seed 0), the same on dram and pmem; tests/test_torch_sim.py holds
# the CPU's run to the same values
SIM_PINNED = {"wire": {"link_bytes": 11549832, "media_bytes": 22232728,
                       "comp": {}},
              "pool": {"link_bytes": 4505352, "media_bytes": 18335402,
                       "comp": {"undo": [3522264, 1573601]}}}
# tests/test_sim.py's bands for the paper's four headline figures
SIM_BANDS = {"pmem_over_cxl_x": (4.2, 6.2), "cxl_d_vs_pcie": (0.10, 0.35),
             "relaxation_gain": (0.07, 0.25), "energy_saving": (0.66, 0.86)}


def sim_headline(engine, energy, models_rm):
    """Each system's batch time a RM (s, the model's) and the paper's four
    headline figures, as tests/test_sim.py forms them."""
    t = {rm: {s: engine.simulate(s, w).batch_time for s in engine.SYSTEMS}
         for rm, w in models_rm.RMS.items()}
    e = energy.energy_table()
    rms = list(models_rm.RMS)
    return t, {
        "pmem_over_cxl_x": statistics.fmean(t[r]["PMEM"] / t[r]["CXL"] for r in rms),
        "cxl_d_vs_pcie": statistics.fmean(1 - t[r]["CXL-D"] / t[r]["PCIe"] for r in rms),
        "relaxation_gain": statistics.fmean(1 - t[r]["CXL"] / t[r]["CXL-B"] for r in rms),
        "energy_saving": statistics.fmean(1 - e[r]["CXL"] for r in rms)}


def sim_phase(steps_metrics):
    """Phase 26: the simulator of paper Figs. 11-13, calibrated from phase
    6's checkpointed rm1 steps and from measured pool batches on this host.
    Its batch times and joules are the model's of the paper's testbed, not
    measurements of the card. Returns the numbers it printed."""
    import shutil
    import tempfile

    from repro_torch.sim import calibration, energy, engine, models_rm
    out = {}
    engine.clear_pool_calibration()
    times, fig = sim_headline(engine, energy, models_rm)
    out["uncalibrated"] = fig
    print(f"[sim] the model's batch times, uncalibrated (s): {json.dumps(times)}")
    for name, (lo, hi) in SIM_BANDS.items():
        print(f"[sim] {name}: {fig[name]!r} (tests/test_sim.py's band {lo}-{hi})")
        check(lo <= fig[name] <= hi, f"sim: uncalibrated {name} {fig[name]} "
              f"outside {lo}-{hi}")

    def calibrated(tag, metrics):
        cal = engine.calibrate_from_pool(metrics)
        try:
            t, f = sim_headline(engine, energy, models_rm)
        finally:
            engine.clear_pool_calibration()
        print(f"[sim] {tag}: calibrate_from_pool -> {json.dumps(cal)}")
        print(f"[sim] {tag}: the model's batch times, calibrated (s): {json.dumps(t)}")
        for name in SIM_BANDS:
            print(f"[sim] {tag}: {name} calibrated {f[name]!r}, uncalibrated "
                  f"{fig[name]!r}")
        bad = [(rm, s_, v) for rm, row in t.items() for s_, v in row.items()
               if not (math.isfinite(v) and v > 0)]
        check(not bad, f"sim {tag}: calibrated batch times not finite and "
              f"positive: {bad}")
        return {"cal": cal, "figures": f, "batch_time_s": t}

    # (a) phase 6's run A: full rm1's 2 checkpointed steps into a pmem pool
    print(f"[sim] phase 6 run A's counters over its checkpointed steps "
          f"(mirror load left out):\n{steps_metrics.report()}")
    out["phase6"] = calibrated("phase 6 rm1", steps_metrics)
    if "undo_comp_ratio" not in out["phase6"]["cal"]:
        print("[sim] phase 6 rm1: no undo_comp_ratio: phase 6 runs without "
              "zlib (pool_compress none), so the pool compressed nothing")

    # (b) one measured batch a backend and capture mode, at the reference's
    # default sizes
    work = tempfile.mkdtemp(prefix="sim-", dir=os.path.join(ROOT, "build"))
    try:
        cells = {}
        for backend in ("dram", "pmem"):
            for mode in ("wire", "pool"):
                t0 = time.perf_counter()
                m = calibration.measured_pool_batch(
                    backend, mode, path=os.path.join(work, f"{backend}-{mode}.img"))
                wall = time.perf_counter() - t0
                cell = {"wall_s": wall, "link_bytes": m.link_bytes(),
                        "media_bytes": m.media_bytes(),
                        "undo_comp_ratio": m.comp_ratio("undo"), "comp": m.comp,
                        "energy_j": m.energy()}
                cells[backend, mode] = (cell, m)
                print(f"[sim] measured batch {backend} {mode}: {json.dumps(cell)}")
                want = SIM_PINNED[mode]
                check(cell["link_bytes"] == want["link_bytes"]
                      and cell["media_bytes"] == want["media_bytes"]
                      and m.comp == want["comp"],
                      f"sim: measured batch {backend} {mode}: bytes "
                      f"{cell['link_bytes']}, {cell['media_bytes']}, {m.comp}; "
                      f"the CPU tests pin {want}")
            wire, pool = cells[backend, "wire"][0], cells[backend, "pool"][0]
            check(pool["link_bytes"] < wire["link_bytes"], f"sim {backend}: pool "
                  "mode moved no fewer link bytes than wire mode")
            # benchmarks/fig13_energy.py's two rows
            out[f"{backend}_link_savings_x"] = (wire["link_bytes"]
                                                / max(1, pool["link_bytes"]))
            out[f"{backend}_energy_savings_pct"] = 100 * (
                1 - pool["energy_j"]["total"] / max(wire["energy_j"]["total"], 1e-12))
            print(f"[sim] {backend}: link_savings_x "
                  f"{out[f'{backend}_link_savings_x']!r}, energy_savings_pct "
                  f"{out[f'{backend}_energy_savings_pct']!r}")
        out["measured"] = {f"{b}-{m_}": c for (b, m_), (c, _) in cells.items()}
        out["pmem_pool"] = calibrated("pmem pool-mode batch", cells["pmem", "pool"][1])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


DRILLS = (18, 20, 21)
DRILL_MARK = "DRILL_RESULT "
# each drill's host needs, in units of full rm1's 2.56 GB f32 mirror (the
# phases' own host_room calls): RAM, disk
DRILL_ROOM = {18: (8, 2), 20: (10, 4), 21: (8, 2)}
# free device memory the three need together: their peaks were 11.12, 8.39
# and 11.04 GB (measured on an H100 80GB HBM3 at 700 W), and each holds a context
DRILL_CARD_GB = 33


def drill_child(num, pmem_tier_e_ms):
    """One pool drill in a process of its own (``python3 chip_smoke.py
    --drill N [--tier-e-ms JSON]``, started by ``drills_phase``): phase 18,
    20 or 21 on full rm1 from the config's seed, as ``main`` would run it.
    Prints the phase's lines and, last, DRILL_MARK and one JSON object:
    its launches, its numbers, its wall seconds and its peak device GB."""
    import numpy as np
    import torch
    dev = start_on_card()
    from repro_torch.configs import get_arch
    cfg = get_arch("dlrm-rm1").model
    tc, fresh_state = rm1_training(torch, cfg, dev)
    t0 = time.perf_counter()
    if num == 18:
        launches, out = remote_checkpoint_phase(torch, np, cfg, tc, 128, dev, fresh_state,
                                                pmem_tier_e_ms)
    elif num == 20:
        launches, out = sharded_checkpoint_phase(torch, np, cfg, tc, 128, dev, fresh_state)
    elif num == 21:
        launches, out = checked_soak_phase(torch, np, cfg, tc, 128, dev, pmem_tier_e_ms)
    else:
        fail(f"no drill {num}: the drills are phases {DRILLS}")
    print(DRILL_MARK + json.dumps({
        "launches": launches, "out": out, "wall_s": time.perf_counter() - t0,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}), flush=True)
    # the result is out and the phase released what it made: end without
    # the interpreter's teardown, where a native thread left joinable once
    # aborted drill 21 after its result line ("terminate called without an
    # active exception", exit -6)
    sys.stderr.flush()
    os._exit(0)


def drills_phase(torch, pmem_tier_e_ms):
    """Phases 18, 20 and 21, the rm1 pool drills, run at once: each in a
    child process of this script (``drill_child``) with its own work
    directory and sockets under build/ (each phase makes its own), the
    checker (REPRO_POOL_CHECK=1) set in phase 21's environment alone. Their
    seconds are taken while they share the host's cores, disk and memory.
    Each child's lines are printed; a child that exits non-zero, or gives
    no result line, fails the run. Returns {phase: (launches, numbers)}."""
    import shutil
    import tempfile

    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    mirror_gb = 20 * 1_000_000 * 32 * 4 / 1e9
    host_room("[drills]", "phases 18, 20 and 21 at once", build,
              sum(r for r, _ in DRILL_ROOM.values()) * mirror_gb,
              sum(d for _, d in DRILL_ROOM.values()) * mirror_gb)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free_gb = torch.cuda.mem_get_info()[0] / 1e9
    print(f"[drills] device memory free before the drills {free_gb:.1f} GB")
    check(free_gb >= DRILL_CARD_GB, f"the drills need {DRILL_CARD_GB} GB of free device "
          f"memory, {free_gb:.1f} GB free")
    work = tempfile.mkdtemp(prefix="drills-", dir=build)
    base = {k: v for k, v in os.environ.items() if k != "REPRO_POOL_CHECK"}
    procs, wall, results = {}, {}, {}
    t0 = time.perf_counter()
    try:
        for num in DRILLS:
            env = {**base, "REPRO_POOL_CHECK": "1"} if num == 21 else base
            with open(os.path.join(work, f"{num}.log"), "w") as log:
                procs[num] = subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--drill", str(num),
                     "--tier-e-ms", json.dumps(list(pmem_tier_e_ms))],
                    env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT, text=True,
                    start_new_session=True)
        while len(wall) < len(procs):
            check(time.perf_counter() - t0 < 900, "drills: not all exited within 900 s: "
                  f"{sorted(set(procs) - set(wall))}")
            for num, proc in procs.items():
                if num not in wall and proc.poll() is not None:
                    wall[num] = time.perf_counter() - t0
            time.sleep(0.2)
        for num in DRILLS:
            with open(os.path.join(work, f"{num}.log")) as log:
                text = log.read()
            lines = text.splitlines()
            got = [ln[len(DRILL_MARK):] for ln in lines if ln.startswith(DRILL_MARK)]
            for ln in lines:
                if not ln.startswith(DRILL_MARK):
                    print(ln)
            rc = procs[num].returncode
            check(rc == 0 and len(got) == 1, f"drill {num}: exit {rc}, "
                  f"{len(got)} result lines:\n{text[-6000:]}")
            res = json.loads(got[0])
            results[num] = (res["launches"], res["out"])
            print(f"[drills] phase {num}: exit {rc}, done {wall[num]:.1f}s after the "
                  f"start (its phase {res['wall_s']:.1f}s, sharing the host with the "
                  f"other drills), peak device memory {res['peak_gb']:.2f} GB")
    finally:
        for proc in procs.values():      # none outlives the phase
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    return results


def start_on_card():
    """What every run of this script starts with: a CUDA card, the
    checkout's src/ on the path, full-f32 matmuls. Returns the card."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        fail("no src/repro_torch beside this script: run it from the repo's root")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False   # full-f32 matmuls
    return torch.device("cuda")


def rm1_training(torch, cfg, dev):
    """The train config of phases 4 on, and ``fresh_state``: full rm1's
    state made anew from the config's seed."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models.registry import get_api
    from repro_torch.training import train_loop
    tc = TrainConfig(learning_rate=1e-3, embed_learning_rate=0.05)

    def fresh_state():
        gen = torch.Generator(device=dev)
        gen.manual_seed(tc.seed)
        init_fn = train_loop.make_step_fns(cfg, tc)[0]
        state = init_fn(get_api(cfg).init(gen, cfg))
        torch.cuda.synchronize()
        return state
    return tc, fresh_state


def ckpt_sim_alone():
    """Phases 6 and 26 alone (phase 26 reads phase 6's counters), from the
    repo's root: python3 -c "import chip_smoke; chip_smoke.ckpt_sim_alone()"."""
    import numpy as np
    import torch
    dev = start_on_card()
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build

    _build.build()
    cfg = get_arch("dlrm-rm1").model
    tc, fresh_state = rm1_training(torch, cfg, dev)
    t0 = time.perf_counter()
    _, _, metrics = checkpoint_phase(torch, np, cfg, tc, 128, dev, fresh_state)
    print(f"[ckpt] phase 6 wall time {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    zero_row_counts()
    out = sim_phase(metrics)
    check(not any(row_counts().values()), f"sim: a kernel launched: {row_counts()}")
    print(f"[sim] phase 26 wall time {time.perf_counter() - t0:.1f}s")
    print(f"[sim] phase 26: {json.dumps(out)}")


def mesh_phases_alone(phases="27,28,29"):
    """The mesh phases named (of 27, 28 and 29) alone, one after another,
    from the repo's root: python3 -c "import chip_smoke;
    chip_smoke.mesh_phases_alone('27,28')". Each prints its own lines, then
    its metrics as one JSON line and its wall time; exits 1 if one
    failed."""
    import numpy as np
    import torch
    dev = start_on_card()
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib

    t = time.perf_counter()
    _build.build()
    print(f"[alone] build {time.perf_counter() - t:.1f}s", flush=True)
    mesh_lib.start_fork_server()
    atexit.register(mesh_lib.stop_fork_server)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    fns = {"27": tp_phase, "28": fsdp_phase, "29": moe_mesh_phase}
    failed = False
    for name in phases.split(","):
        t = time.perf_counter()
        try:
            out = fns[name](torch, np, dev, TrainConfig(embed_learning_rate=0.05))[-1]
            print(f"[alone] phase {name} metrics " + json.dumps(out, default=str), flush=True)
        except SystemExit as e:
            failed = True
            print(f"[alone] phase {name} FAILED ({e})", flush=True)
        print(f"[alone] phase {name} wall time {time.perf_counter() - t:.1f}s", flush=True)
    sys.exit(1 if failed else 0)


def tf32_probe():
    """A bf16 product widened to f32, as a row-parallel partial's backward
    forms its products (``fsdp._Project``'s ``f32``), with TF32 on against
    off: the largest
    difference as a share of the largest element, and the median device ms
    of each beside the bf16 product's; from the repo's root: python3 -c
    "import chip_smoke; chip_smoke.tf32_probe()"."""
    import torch
    start_on_card()
    from repro_torch.distributed import fsdp

    def ms(f, n=20):
        f()
        torch.cuda.synchronize()
        ts = []
        for _ in range(n):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            f()
            b.record()
            torch.cuda.synchronize()
            ts.append(a.elapsed_time(b))
        return sorted(ts)[n // 2]
    g = torch.Generator(device="cuda").manual_seed(0)
    # tinyllama's attention wo at two ranks (B 1, S 1024: 1,024 rows),
    # granite-20b's MLP wo at four, qwen3-moe's attention wo at four
    for m, k, n in ((1024, 1024, 2048), (1024, 6144, 6144), (1024, 2048, 4096)):
        x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn(k, n, generator=g, device="cuda") / k ** 0.5).to(torch.bfloat16)
        with fsdp._tf32(False):
            want = x.float() @ w.float()
            t_off = ms(lambda: x.float() @ w.float())
        with fsdp._tf32(True):
            got = x.float() @ w.float()
            t_on = ms(lambda: x.float() @ w.float())
        t_bf = ms(lambda: x @ w)
        print(f"[tf32] ({m}, {k}) @ ({k}, {n}) bf16 widened to f32: TF32 on against off, "
              f"largest difference {(got - want).abs().max().item():.4g} "
              f"({(got - want).abs().max().item() / want.abs().max().item():.4g} of the "
              f"largest); device ms off {t_off:.4f}, on {t_on:.4f}, the bf16 product "
              f"(bf16 out) {t_bf:.4f}", flush=True)


def main():
    import numpy as np
    import torch
    dev = start_on_card()
    from repro_torch.configs import get_arch
    from repro_torch.core import embedding_ops
    from repro_torch.data.lookahead import LookaheadIterator
    from repro_torch.data.synthetic import DLRMBatches, zipf_indices
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gather_rows as gr
    from repro_torch.kernels import scatter_update as su
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models.registry import get_api
    from repro_torch.training import train_loop
    from repro_torch.tree import tree_map

    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    for name, log in logs.items():
        for line in log.splitlines():   # ptxas -v: each kernel's resources
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] {len(logs)} built, {len(_build.KERNELS) - len(logs)} cached, "
          f"{time.perf_counter() - t0:.1f}s")
    # the ranks of phases 24, 25, 27 and 28 fork from a server that imports
    # torch once, beside phases 2-23 (a fresh rank spent 17 s in imports)
    from repro_torch.launch import mesh as mesh_lib
    mesh_lib.start_fork_server()
    atexit.register(mesh_lib.stop_fork_server)

    # -- 2. the card -----------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0])

    # -- 3. kernels against their plain versions ---------------------------------
    rng = np.random.default_rng(0)
    err = {"embedding_bag": 0.0, "scatter_update": 0.0, "gather_rows": 0.0,
           "scatter_update_logged": 0.0}

    def check_bag(table, idx, seg, num_bags, what):
        got = ops.embedding_bag(table, idx, seg, num_bags)
        again = ops.embedding_bag(table, idx, seg, num_bags)
        want = ref.embedding_bag_ref(table, idx, seg, num_bags)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"embedding_bag {what}: two calls differ")
        check(got.dtype == torch.float32 and got.shape == want.shape,
              f"embedding_bag {what}: shape/dtype")
        diff = (got - want).abs()
        check(bool((diff <= 1e-5 + 1e-5 * want.abs()).all()),
              f"embedding_bag {what}: max abs err {diff.max().item():.3g}")
        empty = torch.ones(num_bags, dtype=torch.bool, device=dev)
        empty[seg.long()] = False
        check(not got[empty].any().item(), f"embedding_bag {what}: empty bag not 0")
        err["embedding_bag"] = max(err["embedding_bag"], diff.max().item()
                                   if diff.numel() else 0.0)

    def check_update(table, idx, delta, what):
        want = ref.scatter_update_ref(table.clone(), idx, delta)
        ops.scatter_update(table, idx, delta)
        torch.cuda.synchronize()
        check(torch.equal(table, want), f"scatter_update {what}: not bitwise equal")
        err["scatter_update"] = max(err["scatter_update"],
                                    (table.float() - want.float()).abs().max().item())

    def check_update_logged(table, idx, delta, what):
        want, want_old = ref.scatter_update_logged_ref(table.clone(), idx, delta)
        _, old = ops.scatter_update_logged(table, idx, delta)
        torch.cuda.synchronize()
        bits = torch.int32 if table.dtype == torch.float32 else torch.int16
        check(torch.equal(table, want), f"scatter_update_logged {what}: table "
              "not bitwise equal")
        check(old.dtype == table.dtype and torch.equal(old.view(bits),
                                                       want_old.view(bits)),
              f"scatter_update_logged {what}: undo rows not bitwise equal")
        err["scatter_update_logged"] = max(
            err["scatter_update_logged"],
            (table.float() - want.float()).abs().max().item() if table.numel() else 0.0,
            (old.float() - want_old.float()).abs().max().item() if old.numel() else 0.0)

    def check_gather(table, idx, what):
        got = ops.gather_rows(table, idx)
        want = ref.gather_rows_ref(table, idx)
        torch.cuda.synchronize()
        check(got.dtype == table.dtype and torch.equal(got, want),
              f"gather_rows {what}: not bitwise equal")
        err["gather_rows"] = max(err["gather_rows"], (got.float() - want.float())
                                 .abs().max().item() if got.numel() else 0.0)

    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        # D=45 in f16/bf16 gives 90-byte rows: the 2-byte chunk path
        for R, D, N in ((1000, 32, 700), (500, 45, 91), (64, 1, 5), (10, 8, 0)):
            table = torch.randn((R, D), device=dev).to(dtype)
            idx = torch.from_numpy(zipf_indices(rng, (N,), R)).to(dev)
            check_gather(table, idx, f"{dtype} R={R} D={D} N={N}")
        for R, D, B, N in ((1000, 32, 64, 700), (500, 45, 40, 90), (64, 100, 7, 0)):
            table = torch.randn((R, D), device=dev).to(dtype)
            idx = torch.from_numpy(zipf_indices(rng, (N,), R)).to(dev)
            # only every third bag gets items; the others stay empty
            seg_np = np.sort(rng.choice(np.arange(0, B, 3) + 1, N) % B)
            seg = torch.from_numpy(seg_np.astype(np.int32)).to(dev)
            check_bag(table, idx, seg, B, f"{dtype} R={R} D={D} N={N}")
    for dtype in (torch.float32, torch.bfloat16):
        # zipf ids with heavy duplicates, row 0 real, pads (-1) trailing
        ids = np.concatenate([[0, 0], zipf_indices(rng, (400,), 300)])
        uniq, comb = ops.combine_duplicates(
            torch.from_numpy(ids.astype(np.int32)).to(dev),
            torch.randn((402, 32), device=dev))
        check(uniq[0].item() == 0 and (uniq < 0).any().item(), "combine: no pads")
        table = torch.randn((300, 32), device=dev).to(dtype)
        before = table[0].float() + comb[0]
        check_update(table, uniq, comb, f"{dtype} zipf")
        check(torch.equal(table[0], before.to(dtype)), "scatter_update: row 0 lost")
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        # zipf ids, row 0 real or absent, -1 pads trailing; D=45 is ragged;
        # a call of pads only and an empty one
        for R, D, N, row0 in ((300, 32, 400, True), (500, 45, 91, False),
                              (64, 1, 5, True), (10, 8, 0, False)):
            ids = zipf_indices(rng, (N,), R) if not row0 else \
                np.concatenate([[0], zipf_indices(rng, (N - 1,), R)])
            if not row0:
                ids = ids[ids != 0]
            uniq, comb = ops.combine_duplicates(
                torch.from_numpy(ids.astype(np.int32)).to(dev),
                torch.randn((ids.size, D), device=dev))
            table = torch.randn((R, D), device=dev).to(dtype)
            row_0 = table[0].clone()
            check_update_logged(table, uniq, comb,
                                f"{dtype} R={R} D={D} N={ids.size} row 0 {row0}")
            check(row0 or torch.equal(table[0], row_0),
                  "scatter_update_logged: a pad touched row 0")
        pads = torch.full((7,), -1, dtype=torch.int32, device=dev)
        check_update_logged(torch.randn((9, 16), device=dev).to(dtype), pads,
                            torch.randn((7, 16), device=dev), f"{dtype} pads only")
    # combine on the card vs on the CPU: same slots, same sums (row 0 real)
    ids = np.concatenate([[0], zipf_indices(rng, (999,), 500)]).astype(np.int32)
    delta = rng.standard_normal((1000, 32)).astype(np.float32)
    cu, cc = ops.combine_duplicates(torch.from_numpy(ids).to(dev),
                                    torch.from_numpy(delta).to(dev))
    hu, hc = ops.combine_duplicates(torch.from_numpy(ids), torch.from_numpy(delta))
    check(torch.equal(cu.cpu(), hu), "combine_duplicates: slots differ from CPU")
    torch.testing.assert_close(cc.cpu(), hc, rtol=1e-5, atol=1e-5)
    err["embedding_bag"] = max(err["embedding_bag"], (cc.cpu() - hc).abs().max().item())
    print("[kernels] small ragged cases: ok")

    # the shapes full dlrm-rm1 at batch 128 gives the kernels
    cfg = get_arch("dlrm-rm1").model
    T, R, d = cfg.dlrm_num_tables, cfg.dlrm_rows_per_table, cfg.dlrm_bottom_mlp[-1]
    Bsz = 128
    batch = DLRMBatches(cfg, Bsz, seed=0, device=dev).next(0)
    flat, seg = embedding_ops.bag_items(batch["sparse"], R)
    N, nb = flat.numel(), Bsz * T
    n_rows = torch.unique(flat).numel()
    tables = (torch.randn((T * R, d), device=dev) / math.sqrt(d)).to(torch.bfloat16)
    g_rows = (torch.randn((nb, d), device=dev) * 1e-3).to(torch.bfloat16)
    uniq, g_comb = ops.combine_duplicates(flat, g_rows, item_rows=seg)
    upd = -0.05 * g_comb
    scratch = torch.zeros((T * R, d), dtype=torch.float32, device=dev)
    sorted_items = torch.sort(flat, stable=True)[1]
    comb_src = seg[sorted_items].contiguous()
    comb_first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                            flat[sorted_items][1:] != flat[sorted_items][:-1]])
    comb_seg = torch.cumsum(comb_first, 0, dtype=torch.int32) - 1
    comb_starts = torch.nonzero(comb_first).flatten().to(torch.int32)
    check_bag(tables, flat, seg, nb, "rm1 forward bag (bf16 table)")
    check_bag(g_rows, comb_src, comb_seg, N, "rm1 duplicate combine")
    check_update(tables.clone(), uniq, upd, "rm1 bf16 table")
    check_update_logged(tables.clone(), uniq, upd, "rm1 bf16 table")
    check_update(scratch, uniq, upd, "rm1 f32 scratch")
    real_ids = uniq[: (uniq >= 0).sum().item()]   # the checkpoint's gather
    check_gather(tables, real_ids, "rm1 touched rows (bf16 table)")
    # phase 21 trains rm1 with f32 tables
    tables32 = tables.float()
    check_bag(tables32, flat, seg, nb, "rm1 forward bag (f32 table)")
    check_update_logged(tables32.clone(), uniq, upd, "rm1 f32 table")
    check_gather(tables32, real_ids, "rm1 touched rows (f32 table)")
    check_bag(scratch, flat, seg, nb, "rm1 correction bag (f32 scratch)")
    ops.scatter_update(scratch, uniq, -upd)
    check(not scratch.any().item(), "scratch not cleared by u + (-u)")
    print(f"[kernels] rm1 shapes: ok ({N} items, {nb} bags, {n_rows} distinct rows)")

    # times at the rm1 shapes (ms), plain version and one library call beside
    offsets = torch.arange(nb + 1, device=dev, dtype=torch.int32) * cfg.dlrm_num_sparse
    real = uniq[uniq >= 0].long()
    upd_real_bf16 = upd[: real.numel()].to(torch.bfloat16)
    t_tab = tables.clone()
    t_tab32 = tables32.clone()
    upd_real = upd[: real.numel()]
    rows_b = 2   # bf16

    def bag_bytes(n_bags, rows_read, row_bytes):
        # idx and seg once, each distinct row once, the f32 output
        return N * 4 * 2 + rows_read * row_bytes + n_bags * d * 4

    shapes = {
        "bag_fwd": (lambda: ops.embedding_bag(tables, flat, seg, nb),
                    lambda: ref.embedding_bag_ref(tables, flat, seg, nb),
                    lambda: torch.nn.functional.embedding_bag(
                        flat, tables, offsets, mode="sum"),
                    bound(bag_bytes(nb, n_rows, d * rows_b), N * d)),
        # (the library's bags are the distinct rows' runs, in bf16)
        "bag_combine": (lambda: ops.embedding_bag(g_rows, comb_src, comb_seg, N),
                        lambda: ref.embedding_bag_ref(g_rows, comb_src, comb_seg, N),
                        lambda: torch.nn.functional.embedding_bag(
                            comb_src, g_rows, comb_starts, mode="sum"),
                        bound(bag_bytes(N, nb, d * rows_b), N * d)),
        "bag_corr_f32": (lambda: ops.embedding_bag(scratch, flat, seg, nb),
                         lambda: ref.embedding_bag_ref(scratch, flat, seg, nb),
                         lambda: torch.nn.functional.embedding_bag(
                             flat, scratch, offsets, mode="sum"),
                         bound(bag_bytes(nb, n_rows, d * 4), N * d)),
        "update_bf16": (lambda: ops.scatter_update(t_tab, uniq, upd),
                        lambda: ref.scatter_update_ref(t_tab, uniq, upd),
                        lambda: t_tab.index_add_(0, real, upd_real_bf16),
                        bound(N * 4 + n_rows * d * (4 + 2 * rows_b), n_rows * d)),
        # a real slot: its id, its f32 delta, the row read, written and
        # logged; a pad: its id and a zero undo row
        "update_logged_bf16": (
            lambda: ops.scatter_update_logged(t_tab, uniq, upd),
            lambda: ref.scatter_update_logged_ref(t_tab, uniq, upd),
            lambda: (t_tab.index_select(0, real), t_tab.index_add_(0, real, upd_real_bf16)),
            bound(n_rows * (4 + d * (4 + 3 * rows_b)) + (N - n_rows) * (4 + d * rows_b),
                  n_rows * d)),
        # f32 with unique rows: index_add_ computes the same function
        "update_f32": (lambda: ops.scatter_update(scratch, uniq, upd),
                       lambda: ref.scatter_update_ref(scratch, uniq, upd),
                       lambda: scratch.index_add_(0, real, upd[: real.numel()]),
                       bound(N * 4 + n_rows * d * 12, n_rows * d)),
        # the ids once, each touched row read once and written once; no ops
        "gather_bf16": (lambda: ops.gather_rows(tables, real_ids),
                        lambda: ref.gather_rows_ref(tables, real_ids),
                        lambda: torch.index_select(tables, 0, real_ids),
                        bound(n_rows * 4 + 2 * n_rows * d * rows_b, 0)),
        # phase 21's f32 tables: the same work at 4-byte rows
        "bag_fwd_f32": (lambda: ops.embedding_bag(tables32, flat, seg, nb),
                        lambda: ref.embedding_bag_ref(tables32, flat, seg, nb),
                        lambda: torch.nn.functional.embedding_bag(
                            flat, tables32, offsets, mode="sum"),
                        bound(bag_bytes(nb, n_rows, d * 4), N * d)),
        "update_logged_f32": (
            lambda: ops.scatter_update_logged(t_tab32, uniq, upd),
            lambda: ref.scatter_update_logged_ref(t_tab32, uniq, upd),
            lambda: (t_tab32.index_select(0, real), t_tab32.index_add_(0, real, upd_real)),
            bound(n_rows * (4 + d * (4 + 3 * 4)) + (N - n_rows) * (4 + d * 4),
                  n_rows * d)),
        "gather_f32": (lambda: ops.gather_rows(tables32, real_ids),
                       lambda: ref.gather_rows_ref(tables32, real_ids),
                       lambda: torch.index_select(tables32, 0, real_ids),
                       bound(n_rows * 4 + 2 * n_rows * d * 4, 0)),
    }
    timing = time_shapes(torch, "[kernels]", shapes)
    del tables, t_tab, scratch, g_rows, g_comb, upd, upd_real_bf16, real_ids
    del tables32, t_tab32, upd_real
    torch.cuda.empty_cache()

    # -- 4. full-width dlrm-rm1 through the port's train -------------------------
    tc, fresh_state = rm1_training(torch, cfg, dev)

    def run(state, steps, relaxed, start=0):
        # every batch of the run is made first (set-up, on the host), so
        # the step times below are the training path's alone
        t = time.perf_counter()
        batches = LookaheadIterator(DLRMBatches(cfg, Bsz, seed=0, device=dev),
                                    cfg, depth=steps + 1, start_step=start)
        print(f"[train] host batch generation: "
              f"{1e3 * (time.perf_counter() - t) / (steps + 1):.1f} ms per batch")
        stamps = [time.perf_counter()]

        def on_metrics(n, m):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        state, losses = train_loop.train(cfg, tc, batches, steps, relaxed=relaxed,
                                         state=state, start_step=start,
                                         on_metrics=on_metrics)
        step_ms = [1e3 * (b - a) for a, b in zip(stamps[:-1], stamps[1:], strict=True)]
        return state, losses, step_ms

    t0 = time.perf_counter()
    state = fresh_state()
    print(f"[train] full dlrm-rm1 init on the card: {time.perf_counter() - t0:.1f}s, "
          f"tables {tuple(state['embed']['emb_tables'].shape)} "
          f"{state['embed']['emb_tables'].dtype}")
    torch.cuda.reset_peak_memory_stats()
    eb.launches = su.launches = su.launches_logged = gr.launches = su.wide_launches = 0
    su.wide_launches_logged = 0
    state, rl, rt = run(state, 5, relaxed=True)
    relaxed_updates = su.launches   # all on the f32 scratch
    state, sl, stt = run(state, 2, relaxed=False, start=5)
    launches = {"embedding_bag": eb.launches, "scatter_update": su.launches,
                "scatter_update_logged": su.launches_logged,
                "gather_rows": gr.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[train] relaxed losses {rl} step ms {rt}")
    print(f"[train] strict losses {sl} step ms {stt}")
    print(f"[train] launches {launches}; peak device memory {peak_gb:.2f} GB")
    check(all(math.isfinite(x) for x in rl + sl), "non-finite loss")
    # warmup bag + per relaxed step 3 bags (stale, combine, correction),
    # the table's logged update and 2 plain ones (scratch set, scratch
    # clear); per strict step 2 bags and the table's plain update; no
    # checkpoint manager here, so no gather. Each bag is eb.PASSES launches.
    check(launches == {"embedding_bag": (1 + 5 * 3 + 2 * 2) * eb.PASSES,
                       "scatter_update": 5 * 2 + 2 * 1,
                       "scatter_update_logged": 5, "gather_rows": 0},
          f"unexpected launch counts {launches}")
    check(su.wide_launches == su.launches, "scatter_update: the rm1 run's updates did "
          f"not all move 16-byte chunks ({su.wide_launches} of {su.launches})")
    check(su.wide_launches_logged == su.launches_logged, "scatter_update_logged: the "
          f"rm1 run's logged updates did not all move 16-byte chunks "
          f"({su.wide_launches_logged} of {su.launches_logged})")
    check(not state["prefetch"]["scratch"].any().item(), "scratch not zero after run")
    del state
    torch.cuda.empty_cache()
    state2, rl2, _ = run(fresh_state(), 3, relaxed=True)
    check(rl2 == rl[:3], f"relaxed losses not repeatable: {rl2} vs {rl[:3]}")
    del state2
    torch.cuda.empty_cache()
    print("[train] repeat run: bitwise-equal losses")

    # -- 5. the card against the CPU at the smoke size ---------------------------
    scfg = get_arch("dlrm-rm1", smoke=True).model
    gen = torch.Generator()
    gen.manual_seed(0)
    params = get_api(scfg).init(gen, scfg)
    init_fn = train_loop.make_step_fns(scfg, tc)[0]
    curves = {}
    for name, where, relaxed in (("cuda", dev, True), ("cpu", torch.device("cpu"), True),
                                 ("cuda_strict", dev, False)):
        st = init_fn(tree_map(lambda p, w=where: p.clone().to(w), params))
        _, curves[name] = train_loop.train(
            scfg, tc, DLRMBatches(scfg, 4, seed=0, device=where), 5,
            relaxed=relaxed, state=st, device=where)
    print(f"[smoke] losses {curves}")
    # AdamW's first steps amplify float-order differences (as in the tests)
    np.testing.assert_allclose(curves["cuda"], curves["cpu"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(curves["cuda"], curves["cuda_strict"],
                               rtol=2e-5, atol=2e-5)

    # -- 6. checkpointed training, crash, recovery and resume ---------------------
    step = {"relaxed_ms_median": statistics.median(rt[1:]),
            "strict_ms_median": statistics.median(stt)}
    t0 = time.perf_counter()
    ck_launches, ck_tier_e_ms, ck_metrics = checkpoint_phase(
        torch, np, cfg, tc, Bsz, dev, fresh_state, step["relaxed_ms_median"])
    print(f"[ckpt] phase 6 wall time {time.perf_counter() - t0:.1f}s")
    # -- 7. the flash-attention kernel on the card ---------------------------------
    t0 = time.perf_counter()
    flash_err, flash_t = flash_phase(torch, dev)
    err.update(flash_err)
    timing["flash_bf16"], timing["flash_f32"] = (flash_t[torch.bfloat16],
                                                 flash_t[torch.float32])
    print(f"[flash] phase 7 wall time {time.perf_counter() - t0:.1f}s")

    # -- 8. serving full tinyllama-1.1b ------------------------------------------
    t0 = time.perf_counter()
    sv_parts, sv_gather, sv_served, _ = serve_phase(torch, np, dev, check_gather,
                                                    "tinyllama-1.1b", fa, 0)
    timing["gather_prefill"], timing["gather_decode"] = (sv_gather["prefill"],
                                                         sv_gather["decode"])
    print(f"[serve] phase 8 wall time {time.perf_counter() - t0:.1f}s")

    # -- 9. the wkv6 kernel on the card -------------------------------------------
    t0 = time.perf_counter()
    err["wkv6"], wkv_timing = wkv6_phase(torch, dev)
    timing["wkv6_prefill"], timing["wkv6_decode"] = (wkv_timing["prefill"],
                                                     wkv_timing["decode"])
    print(f"[wkv6] phase 9 wall time {time.perf_counter() - t0:.1f}s")

    # -- 10. serving full rwkv6-3b -----------------------------------------------
    t0 = time.perf_counter()
    rw_parts, rw_gather, rw_served, _ = serve_phase(
        torch, np, dev, check_gather, "rwkv6-3b", wk,
        get_arch("rwkv6-3b").model.num_layers)
    timing["gather_rwkv_prefill"], timing["gather_rwkv_decode"] = (
        rw_gather["prefill"], rw_gather["decode"])
    print(f"[serve] phase 10 wall time {time.perf_counter() - t0:.1f}s")

    # -- 11. the flash-attention backward on the card ------------------------------
    t0 = time.perf_counter()
    bwd_err, timing["flash_bwd"], timing["flash_lse"], timing["flash_bwd_f32"] = \
        flash_bwd_phase(torch, dev)
    err.update(bwd_err)
    print(f"[flash-bwd] phase 11 wall time {time.perf_counter() - t0:.1f}s")

    # -- 12. training full tinyllama-1.1b ------------------------------------------
    t0 = time.perf_counter()
    lm_launches, lm_step, lm_timing = lm_train_phase(torch, np, dev, check_bag,
                                                     check_update, check_update_logged,
                                                     check_gather)
    timing.update(lm_timing)
    print(f"[lm-train] phase 12 wall time {time.perf_counter() - t0:.1f}s")

    # -- 13. checkpointed tinyllama training, crash, recovery, resume ---------------
    t0 = time.perf_counter()
    lm_ck_launches = lm_checkpoint_phase(torch, np, dev)
    print(f"[lm-ckpt] phase 13 wall time {time.perf_counter() - t0:.1f}s")

    # -- 14. the examples on the card ------------------------------------------------
    t0 = time.perf_counter()
    ex_wall = examples_phase()
    print(f"[examples] each one's end, s after the start: {json.dumps(ex_wall)}")
    print(f"[examples] phase 14 wall time {time.perf_counter() - t0:.1f}s")

    # -- 15. the wkv6 backward on the card -------------------------------------------
    t0 = time.perf_counter()
    err["wkv6_bwd"], wkv_bwd_timing = wkv6_bwd_phase(torch, dev)
    timing.update(wkv_bwd_timing)
    print(f"[wkv6-bwd] phase 15 wall time {time.perf_counter() - t0:.1f}s")

    # -- 16. training full rwkv6-3b ----------------------------------------------------
    t0 = time.perf_counter()
    rw_launches, rw_step, rw_timing = rwkv_train_phase(torch, np, dev, check_bag,
                                                       check_update, check_update_logged,
                                                       check_gather)
    timing.update(rw_timing)
    print(f"[rwkv6-3b-train] phase 16 wall time {time.perf_counter() - t0:.1f}s")

    # -- 17. serving from the trainer's pool mirror --------------------------------------
    t0 = time.perf_counter()
    pool_parts, pool_out = {}, {}
    for arch, mixer, per_step, served in (
            ("tinyllama-1.1b", fa, 0, sv_served),
            ("rwkv6-3b", wk, get_arch("rwkv6-3b").model.num_layers, rw_served)):
        pool_parts[arch], pool_out[arch] = pool_serve_phase(torch, np, dev, arch, mixer,
                                                            per_step, served)
    del sv_served, rw_served
    pool_out["dlrm-rm1"] = dlrm_pool_serve_phase(torch, np, cfg, tc, Bsz, dev,
                                                 fresh_state)
    print(f"[pool-serve] phase 17 wall time {time.perf_counter() - t0:.1f}s")

    # -- 18, 20, 21. the pool drills, each in a process of its own, at once --------
    t0 = time.perf_counter()
    drills = drills_phase(torch, ck_tier_e_ms)
    remote_launches, remote_out = drills[18]
    sharded_launches, sharded_out = drills[20]
    soak_launches, soak_out = drills[21]
    print(f"[drills] phases 18, 20 and 21 wall time {time.perf_counter() - t0:.1f}s")

    # -- 19. row-wise Adagrad on the sparse tier at full width ---------------------
    t0 = time.perf_counter()
    ada_launches, ada_step, ada_timing = adagrad_phase(torch, np, dev, check_update,
                                                       check_gather)
    timing.update(ada_timing)
    print(f"[adagrad] phase 19 wall time {time.perf_counter() - t0:.1f}s")

    # -- 22. the remaining decoder families at full width --------------------------
    t0 = time.perf_counter()
    dec_parts, dec_train, dec_timing, dec_out = decoders_phase(
        torch, np, dev, err, check_bag, check_update, check_update_logged, check_gather)
    timing.update(dec_timing)
    print(f"[decoders] phase 22 wall time {time.perf_counter() - t0:.1f}s")

    # -- 23. whisper-base and qwen2-vl-7b: served and trained at full width ------
    t0 = time.perf_counter()
    enc_parts, enc_train, enc_timing, enc_out = encdec_vlm_phase(
        torch, np, dev, err, check_bag, check_update, check_update_logged, check_gather)
    timing.update(enc_timing)
    print(f"[encdec] phase 23 wall time {time.perf_counter() - t0:.1f}s")

    # -- 24. serving under a mesh: two gloo ranks on this card ---------------------
    t0 = time.perf_counter()
    dist_launches, dist_timing, dist_err, dist_out = dist_phase(
        torch, np, dev, tc, dec_out.pop("dist_served"), dec_out["serve"][DIST_JAMBA[0]])
    timing.update(dist_timing)
    for name, e in dist_err.items():
        err[name] = max(err[name], e)
    print(f"[dist] phase 24 wall time {time.perf_counter() - t0:.1f}s")

    # -- 25. full rm1 trained under a mesh: two gloo ranks on this card -------------
    t0 = time.perf_counter()
    dt_launches, dt_timing, dt_err, dt_out = dist_train_phase(torch, np, dev, tc)
    timing.update(dt_timing)
    for name, e in dt_err.items():
        err[name] = max(err[name], e)
    dt_out["wall_s"] = time.perf_counter() - t0
    print(f"[dist-train] phase 25 wall time {dt_out['wall_s']:.1f}s")

    # -- 26. the paper's evaluation model, calibrated from phase 6's steps --------
    t0 = time.perf_counter()
    zero_row_counts()
    sim_out = sim_phase(ck_metrics)
    check(not any(row_counts().values()), f"sim: a kernel launched: {row_counts()}")
    print(f"[sim] phase 26 wall time {time.perf_counter() - t0:.1f}s")

    # -- 27. tinyllama-1.1b under dense TP and Megatron-SP: two gloo ranks --------
    t0 = time.perf_counter()
    tp_launches, tp_timing, tp_err, tp_out = tp_phase(torch, np, dev, tc)
    timing.update(tp_timing)
    for name, e in tp_err.items():
        err[name] = max(err.get(name, 0.0), e)
    tp_out["wall_s"] = time.perf_counter() - t0
    print(f"[tp] phase 27 wall time {tp_out['wall_s']:.1f}s")

    # -- 28. granite-20b under FSDP, TP and SP with one kv head: four gloo ranks ---
    t0 = time.perf_counter()
    fs_launches, fs_timing, fs_err, fs_out = fsdp_phase(torch, np, dev, tc)
    timing.update(fs_timing)
    for name, e in fs_err.items():
        err[name] = max(err.get(name, 0.0), e)
    fs_out["wall_s"] = time.perf_counter() - t0
    print(f"[fsdp] phase 28 wall time {fs_out['wall_s']:.1f}s")

    # -- 29. qwen3-moe, jamba and arctic under their own profiles: four gloo ranks --
    t0 = time.perf_counter()
    mm_launches, mm_timing, mm_err, mm_out = moe_mesh_phase(torch, np, dev, tc)
    timing.update(mm_timing)
    for name, e in mm_err.items():
        err[name] = max(err.get(name, 0.0), e)
    mm_out["wall_s"] = time.perf_counter() - t0
    print(f"[moe-mesh] phase 29 wall time {mm_out['wall_s']:.1f}s")

    # one entry per kernel and path: phase 4's counts for the training
    # kernels, run A's for the checkpoint's gather, the serving runs' parts
    # for the gather, flash attention and wkv6, phases 12's and 16's relaxed
    # runs for the LM training paths and phase 13's full-width run for its
    # checkpoint
    gather_src = ("src/repro_torch/csrc/gather_rows.cu",
                  "src/repro/kernels/embedding_bag.py:73")
    wkv6_src = ("src/repro_torch/csrc/wkv6.cu", "src/repro/kernels/wkv6.py:65")
    update_src = ("src/repro_torch/csrc/scatter_update.cu",
                  "src/repro/kernels/scatter_update.py:24")
    logged_src = ("src/repro_torch/csrc/scatter_update_logged.cu",
                  "src/repro/kernels/scatter_update.py:56")
    bag_src = ("src/repro_torch/csrc/embedding_bag.cu",
               "src/repro/kernels/embedding_bag.py:40")
    ada_rm1, ada_lm = ada_launches["dlrm-rm1"], ada_launches["tinyllama-1.1b"]
    flash_tc_src = ("src/repro_torch/csrc/flash_attention_tc.cu",
                    "src/repro/kernels/flash_attention.py:62")
    # phase 22: each served id's prefill and decode, and llama3.2-3b's training
    decoder_paths = [row for arch, _ in DECODERS for row in (
        ("flash_attention_tc", f"{arch} prefill", f"flash_{arch}",
         dec_parts[arch]["prefill"]["flash_attention_tc"], *flash_tc_src),
        ("gather_rows", f"{arch} prefill", f"gather_{arch}_prefill",
         dec_parts[arch]["prefill"]["gather_rows"], *gather_src),
        ("gather_rows", f"{arch} decode", f"gather_{arch}_decode",
         dec_parts[arch]["decode"]["gather_rows"], *gather_src))] + [
        ("flash_attention_tc", "llama3.2-3b train", "flash_lse_llama3.2-3b",
         dec_train["flash_attention_tc"], *flash_tc_src),
        ("flash_attention_bwd_tc", "llama3.2-3b train", "flash_bwd_llama3.2-3b",
         dec_train["flash_attention_bwd"], "src/repro_torch/csrc/flash_attention_bwd_tc.cu",
         "src/repro/kernels/flash_attention.py:62"),
        ("gather_rows", "llama3.2-3b train", "gather_llama3.2-3b_prefill",
         dec_train["gather_rows"], *gather_src),
        ("embedding_bag", "llama3.2-3b train", "llama_bag_combine",
         dec_train["embedding_bag"], *bag_src),
        ("scatter_update", "llama3.2-3b train", "llama_update_f32",
         dec_train["scatter_update"], *update_src),
        ("scatter_update", "llama3.2-3b train (strict)", "llama_update_bf16",
         dec_train["scatter_update_strict"], *update_src),
        ("scatter_update_logged", "llama3.2-3b train", "llama_update_logged_bf16",
         dec_train["scatter_update_logged"], *logged_src)]
    # phase 23: each id's prefill and decode, and its training
    bwd_tc_src = ("src/repro_torch/csrc/flash_attention_bwd_tc.cu",
                  "src/repro/kernels/flash_attention.py:62")
    encdec_paths = [row for arch in ENCDEC_VLM for row in (
        ("flash_attention_tc", f"{arch} prefill", f"flash_{arch}",
         enc_parts[arch]["prefill"]["flash_attention_tc"], *flash_tc_src),
        ("gather_rows", f"{arch} prefill", f"gather_{arch}_prefill",
         enc_parts[arch]["prefill"]["gather_rows"], *gather_src),
        ("gather_rows", f"{arch} decode", f"gather_{arch}_decode",
         enc_parts[arch]["decode"]["gather_rows"], *gather_src))]
    for arch, pre, tied in (("whisper-base", "whisper_", True),
                            ("qwen2-vl-7b", "qwen2vl_", False)):
        tr = enc_train[arch]
        encdec_paths += [
            ("flash_attention_tc", f"{arch} train", f"flash_lse_{arch}",
             tr["flash_attention_tc"], *flash_tc_src),
            ("flash_attention_bwd_tc", f"{arch} train", f"flash_bwd_{arch}",
             tr["flash_attention_bwd"], *bwd_tc_src),
            ("gather_rows", f"{arch} train",
             "whisper_gather_tokens" if tied else f"gather_{arch}_prefill",
             tr["gather_rows"], *gather_src),
            ("embedding_bag", f"{arch} train", pre + "bag_combine", tr["embedding_bag"],
             *bag_src),
            ("scatter_update", f"{arch} train", pre + ("grad_add_f32" if tied else "update_f32"),
             tr["scatter_update"], *update_src),
            ("scatter_update", f"{arch} train (strict)",
             pre + ("update_every_bf16" if tied else "update_bf16"),
             tr["scatter_update_strict"], *update_src),
            ("scatter_update_logged", f"{arch} train",
             pre + ("update_logged_every_bf16" if tied else "update_logged_bf16"),
             tr["scatter_update_logged"], *logged_src)]
    kernels = []
    for name, path, main_shape, n, src, replaces in (
            ("embedding_bag", "dlrm-rm1 train", "bag_fwd", launches["embedding_bag"],
             "src/repro_torch/csrc/embedding_bag.cu", "src/repro/kernels/embedding_bag.py:40"),
            ("gather_rows", "dlrm-rm1 checkpoint", "gather_bf16", ck_launches["gather_rows"],
             *gather_src),
            ("gather_rows", "tinyllama-1.1b prefill", "gather_prefill",
             sv_parts["prefill"]["gather_rows"], *gather_src),
            ("gather_rows", "tinyllama-1.1b decode", "gather_decode",
             sv_parts["decode"]["gather_rows"], *gather_src),
            ("scatter_update", "dlrm-rm1 train", "update_f32", relaxed_updates,
             *update_src),
            ("scatter_update", "dlrm-rm1 train (strict)", "update_bf16",
             launches["scatter_update"] - relaxed_updates, *update_src),
            ("flash_attention_tc", "tinyllama-1.1b prefill", "flash_bf16",
             sv_parts["prefill"]["flash_attention_tc"],
             "src/repro_torch/csrc/flash_attention_tc.cu",
             "src/repro/kernels/flash_attention.py:62"),
            ("gather_rows", "rwkv6-3b prefill", "gather_rwkv_prefill",
             rw_parts["prefill"]["gather_rows"], *gather_src),
            ("gather_rows", "rwkv6-3b decode", "gather_rwkv_decode",
             rw_parts["decode"]["gather_rows"], *gather_src),
            ("wkv6", "rwkv6-3b prefill", "wkv6_prefill", rw_parts["prefill"]["wkv6"],
             *wkv6_src),
            ("wkv6", "rwkv6-3b decode", "wkv6_decode", rw_parts["decode"]["wkv6"],
             *wkv6_src),
            ("flash_attention_bwd_tc", "tinyllama-1.1b train", "flash_bwd",
             lm_launches["flash_attention_bwd"],
             "src/repro_torch/csrc/flash_attention_bwd_tc.cu",
             "src/repro/kernels/flash_attention.py:62"),
            ("flash_attention_bwd", "smoke tinyllama-1.1b train (f32)", "flash_bwd_f32",
             lm_launches["flash_attention_bwd_f32"],
             "src/repro_torch/csrc/flash_attention_bwd.cu",
             "src/repro/kernels/flash_attention.py:62"),
            ("flash_attention_tc", "tinyllama-1.1b train", "flash_lse",
             lm_launches["flash_attention_tc"], "src/repro_torch/csrc/flash_attention_tc.cu",
             "src/repro/kernels/flash_attention.py:62"),
            ("flash_attention", "smoke tinyllama-1.1b train (f32)", "flash_f32",
             lm_launches["flash_attention_f32"], "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:62"),
            ("gather_rows", "tinyllama-1.1b train", "gather_prefill",
             lm_launches["gather_rows"], *gather_src),
            ("gather_rows", "tinyllama-1.1b checkpoint", "lm_gather_touched",
             lm_ck_launches["gather_rows"], *gather_src),
            ("embedding_bag", "tinyllama-1.1b train", "lm_bag_combine",
             lm_launches["embedding_bag"], "src/repro_torch/csrc/embedding_bag.cu",
             "src/repro/kernels/embedding_bag.py:40"),
            ("scatter_update", "tinyllama-1.1b train", "lm_update_f32",
             lm_launches["scatter_update"], *update_src),
            ("scatter_update", "tinyllama-1.1b train (strict)", "lm_update_bf16",
             lm_launches["scatter_update_strict"], *update_src),
            ("scatter_update_logged", "dlrm-rm1 train", "update_logged_bf16",
             launches["scatter_update_logged"], *logged_src),
            ("scatter_update_logged", "tinyllama-1.1b train", "lm_update_logged_bf16",
             lm_launches["scatter_update_logged"], *logged_src),
            ("wkv6", "rwkv6-3b train", "wkv6_train", rw_launches["wkv6"], *wkv6_src),
            # no Pallas kernel: XLA differentiates the reference's wkv6_chunked
            ("wkv6_bwd", "rwkv6-3b train", "wkv6_bwd", rw_launches["wkv6_bwd"],
             "src/repro_torch/csrc/wkv6_bwd.cu", "src/repro/models/rwkv6.py:97"),
            ("gather_rows", "rwkv6-3b train", "gather_rwkv_prefill",
             rw_launches["gather_rows"], *gather_src),
            ("embedding_bag", "rwkv6-3b train", "rwkv_bag_combine",
             rw_launches["embedding_bag"], "src/repro_torch/csrc/embedding_bag.cu",
             "src/repro/kernels/embedding_bag.py:40"),
            ("scatter_update", "rwkv6-3b train", "rwkv_update_f32",
             rw_launches["scatter_update"], *update_src),
            ("scatter_update", "rwkv6-3b train (strict)", "rwkv_update_bf16",
             rw_launches["scatter_update_strict"], *update_src),
            ("scatter_update_logged", "rwkv6-3b train", "rwkv_update_logged_bf16",
             rw_launches["scatter_update_logged"], *logged_src),
            # phase 17: the token lookups read from a pmem pool mirror
            ("flash_attention_tc", "tinyllama-1.1b prefill (pool-served)", "flash_bf16",
             pool_parts["tinyllama-1.1b"]["prefill"]["flash_attention_tc"],
             "src/repro_torch/csrc/flash_attention_tc.cu",
             "src/repro/kernels/flash_attention.py:62"),
            ("wkv6", "rwkv6-3b prefill (pool-served)", "wkv6_prefill",
             pool_parts["rwkv6-3b"]["prefill"]["wkv6"], *wkv6_src),
            ("wkv6", "rwkv6-3b decode (pool-served)", "wkv6_decode",
             pool_parts["rwkv6-3b"]["decode"]["wkv6"], *wkv6_src),
            # phase 18: run A, checkpointed into a memory node over a socket
            ("embedding_bag", "dlrm-rm1 train (memory node)", "bag_fwd",
             remote_launches["embedding_bag"], "src/repro_torch/csrc/embedding_bag.cu",
             "src/repro/kernels/embedding_bag.py:40"),
            ("scatter_update", "dlrm-rm1 train (memory node)", "update_f32",
             remote_launches["scatter_update"], *update_src),
            ("scatter_update_logged", "dlrm-rm1 train (memory node)",
             "update_logged_bf16", remote_launches["scatter_update_logged"],
             *logged_src),
            ("gather_rows", "dlrm-rm1 checkpoint (memory node)", "gather_bf16",
             remote_launches["gather_rows"], *gather_src),
            # phase 19: the Adagrad runs, the accumulator's launches apart
            ("embedding_bag", "dlrm-rm1 train (adagrad)", "bag_fwd",
             ada_rm1["embedding_bag"], *bag_src),
            ("scatter_update", "dlrm-rm1 train (adagrad)", "update_f32",
             ada_rm1["scatter_update"], *update_src),
            ("scatter_update_logged", "dlrm-rm1 train (adagrad)", "update_logged_bf16",
             ada_rm1["scatter_update_logged"], *logged_src),
            ("embedding_bag", "tinyllama-1.1b train (adagrad)", "lm_bag_combine",
             ada_lm["embedding_bag"], *bag_src),
            ("gather_rows", "tinyllama-1.1b train (adagrad)", "gather_prefill",
             ada_lm["gather_rows_wide"], *gather_src),
            ("gather_rows", "tinyllama-1.1b train (adagrad accumulator)",
             "lm_acc_gather", ada_lm["gather_rows_narrow"], *gather_src),
            ("scatter_update", "tinyllama-1.1b train (adagrad)", "lm_update_f32",
             ada_lm["scatter_update_wide"], *update_src),
            ("scatter_update", "tinyllama-1.1b train (adagrad accumulator)",
             "lm_acc_update", ada_lm["scatter_update_narrow"], *update_src),
            ("scatter_update_logged", "tinyllama-1.1b train (adagrad)",
             "lm_update_logged_bf16", ada_lm["scatter_update_logged"], *logged_src),
            # phase 20: rm1 checkpointed into three memory nodes
            ("embedding_bag", "dlrm-rm1 train (sharded pool)", "bag_fwd",
             sharded_launches["embedding_bag"], *bag_src),
            ("scatter_update", "dlrm-rm1 train (sharded pool)", "update_f32",
             sharded_launches["scatter_update"], *update_src),
            ("scatter_update_logged", "dlrm-rm1 train (sharded pool)",
             "update_logged_bf16", sharded_launches["scatter_update_logged"],
             *logged_src),
            ("gather_rows", "dlrm-rm1 checkpoint (sharded pool)", "gather_bf16",
             sharded_launches["gather_rows"], *gather_src),
            # phase 21: run U of rm1 (f32 tables) under the checker
            ("embedding_bag", "dlrm-rm1 train (checked, f32 tables)", "bag_fwd_f32",
             soak_launches["embedding_bag"], *bag_src),
            ("scatter_update", "dlrm-rm1 train (checked, f32 tables)", "update_f32",
             soak_launches["scatter_update"], *update_src),
            ("scatter_update_logged", "dlrm-rm1 train (checked, f32 tables)",
             "update_logged_f32", soak_launches["scatter_update_logged"], *logged_src),
            ("gather_rows", "dlrm-rm1 checkpoint (checked, f32 tables)", "gather_f32",
             soak_launches["gather_rows"], *gather_src), *decoder_paths, *encdec_paths,
            # phase 24: rank 0 of two, each kernel over its shard
            ("gather_rows", "jamba-v0.1-52b prefill (2 ranks, near-data shard)",
             "gather_jamba_shard_prefill", dist_launches["gather_prefill"], *gather_src),
            ("gather_rows", "jamba-v0.1-52b decode (2 ranks, near-data shard)",
             "gather_jamba_shard_decode", dist_launches["gather_decode"], *gather_src),
            ("flash_attention_tc", "jamba-v0.1-52b prefill (2 ranks)", "flash_jamba_ranks",
             dist_launches["flash_prefill"], *flash_tc_src),
            ("embedding_bag", "dlrm-rm1 forward (2 ranks, near-data shard)", "bag_rm1_shard",
             dist_launches["bag"], *bag_src),
            # phase 25: rank 0 of two, the sparse tier on its block of rm1's rows
            ("embedding_bag", "dlrm-rm1 train (2 ranks, a rank's block, f32)",
             "bag_combine_rm1_block", dt_launches["bag"], *bag_src),
            ("scatter_update", "dlrm-rm1 train (2 ranks, a rank's block, f32)",
             "scratch_update_rm1_block", dt_launches["update"], *update_src),
            ("scatter_update_logged", "dlrm-rm1 train (2 ranks, a rank's block, f32)",
             "update_logged_rm1_block", dt_launches["logged"], *logged_src),
            ("gather_rows", "dlrm-rm1 checkpoint (2 ranks, one writer, f32)",
             "gather_rm1_block", dt_launches["gather"], *gather_src),
            # phase 27: rank 0 of two, tinyllama-1.1b under TP + SP at its shapes
            ("flash_attention_tc", "tinyllama-1.1b train (2 ranks, TP + SP, 16/2 heads)",
             "flash_lse_tp", tp_launches["flash_lse"], *flash_tc_src),
            ("flash_attention_bwd_tc", "tinyllama-1.1b train (2 ranks, TP + SP, 16/2 heads)",
             "flash_bwd_tp", tp_launches["flash_bwd"], *bwd_tc_src),
            ("gather_rows", "tinyllama-1.1b train (2 ranks, near-data vocab block)",
             "gather_tp_lookup", tp_launches["gather"], *gather_src),
            ("embedding_bag", "tinyllama-1.1b train (2 ranks, a rank's vocab block)",
             "bag_combine_tp", tp_launches["bag"], *bag_src),
            ("scatter_update", "tinyllama-1.1b train (2 ranks, the block's f32 scratch)",
             "update_f32_tp", tp_launches["update_f32"], *update_src),
            ("scatter_update", "tinyllama-1.1b train (strict, 2 ranks, the bf16 block)",
             "update_bf16_tp", tp_launches["update_bf16"], *update_src),
            ("scatter_update_logged", "tinyllama-1.1b train (2 ranks, the bf16 block)",
             "update_logged_tp", tp_launches["logged"], *logged_src),
            ("gather_rows", "tinyllama-1.1b checkpoint (2 ranks, one writer)",
             "gather_tp_checkpoint", tp_launches["ckpt_gather"], *gather_src),
            ("flash_attention_tc", "tinyllama-1.1b prefill (2 ranks, TP, 16/2 heads)",
             "flash_prefill_tp", tp_launches["flash_prefill"], *flash_tc_src),
            ("gather_rows", "tinyllama-1.1b prefill (2 ranks, near-data vocab block)",
             "gather_tp_serve_prefill", tp_launches["gather_serve_prefill"], *gather_src),
            ("gather_rows", "tinyllama-1.1b decode (2 ranks, near-data vocab block)",
             "gather_tp_serve_decode", tp_launches["gather_serve_decode"], *gather_src),
            # phase 28: rank 0 of four, granite-20b under FSDP + TP + SP at its shapes
            ("flash_attention_tc",
             "granite-20b train (4 ranks, FSDP + TP + SP, 24/1 heads, kv replicated)",
             "flash_lse_fsdp", fs_launches["flash_lse"], *flash_tc_src),
            ("flash_attention_bwd_tc",
             "granite-20b train (4 ranks, FSDP + TP + SP, 24/1 heads, kv replicated)",
             "flash_bwd_fsdp", fs_launches["flash_bwd"], *bwd_tc_src),
            ("gather_rows", "granite-20b train (4 ranks, near-data vocab block)",
             "gather_fsdp_lookup", fs_launches["gather"], *gather_src),
            ("embedding_bag", "granite-20b train (4 ranks, a rank's vocab block)",
             "bag_combine_fsdp", fs_launches["bag"], *bag_src),
            ("scatter_update", "granite-20b train (4 ranks, the block's f32 scratch)",
             "update_f32_fsdp", fs_launches["update_f32"], *update_src),
            ("scatter_update", "granite-20b train (strict, 4 ranks, the bf16 block)",
             "update_bf16_fsdp", fs_launches["update_bf16"], *update_src),
            ("scatter_update_logged", "granite-20b train (4 ranks, the bf16 block)",
             "update_logged_fsdp", fs_launches["logged"], *logged_src),
            ("gather_rows", "granite-20b checkpoint (4 ranks, one writer)",
             "gather_fsdp_checkpoint", fs_launches["ckpt_gather"], *gather_src),
            ("flash_attention_tc", "granite-20b prefill (4 ranks, FSDP + TP, 24/1 heads)",
             "flash_prefill_fsdp", fs_launches["flash_prefill"], *flash_tc_src),
            ("gather_rows", "granite-20b prefill (4 ranks, near-data vocab block)",
             "gather_fsdp_serve_prefill", fs_launches["gather_serve_prefill"], *gather_src),
            ("gather_rows", "granite-20b decode (4 ranks, near-data vocab block)",
             "gather_fsdp_serve_decode", fs_launches["gather_serve_decode"], *gather_src),
            # phase 29: rank 0 of four, qwen3-moe-235b-a22b under its profile at (1, 4)
            ("flash_attention_tc",
             "qwen3-moe-235b-a22b train (4 ranks, TP + SP + EP, 16/1 heads)",
             "flash_lse_moe", mm_launches["flash_lse"], *flash_tc_src),
            ("flash_attention_bwd_tc",
             "qwen3-moe-235b-a22b train (4 ranks, TP + SP + EP, 16/1 heads)",
             "flash_bwd_moe", mm_launches["flash_bwd"], *bwd_tc_src),
            ("gather_rows", "qwen3-moe-235b-a22b train (4 ranks, near-data vocab block)",
             "gather_moe_lookup", mm_launches["gather"], *gather_src),
            ("embedding_bag", "qwen3-moe-235b-a22b train (4 ranks, a rank's vocab block)",
             "bag_combine_moe", mm_launches["bag"], *bag_src),
            ("scatter_update", "qwen3-moe-235b-a22b train (4 ranks, the block's f32 scratch)",
             "update_f32_moe", mm_launches["update_f32"], *update_src),
            ("scatter_update", "qwen3-moe-235b-a22b train (strict, 4 ranks, the bf16 block)",
             "update_bf16_moe", mm_launches["update_bf16"], *update_src),
            ("scatter_update_logged", "qwen3-moe-235b-a22b train (4 ranks, the bf16 block)",
             "update_logged_moe", mm_launches["logged"], *logged_src),
            ("gather_rows", "qwen3-moe-235b-a22b checkpoint (4 ranks, one writer)",
             "gather_moe_checkpoint", mm_launches["ckpt_gather"], *gather_src),
            ("flash_attention_tc", "qwen3-moe-235b-a22b prefill (4 ranks, TP + EP, 16/1 heads)",
             "flash_prefill_moe", mm_launches["flash_prefill"], *flash_tc_src),
            ("gather_rows", "qwen3-moe-235b-a22b prefill (4 ranks, near-data vocab block)",
             "gather_moe_serve_prefill", mm_launches["gather_serve_prefill"], *gather_src),
            ("gather_rows", "qwen3-moe-235b-a22b decode (4 ranks, near-data vocab block)",
             "gather_moe_serve_decode", mm_launches["gather_serve_decode"], *gather_src)):
        kernels.append({"name": name, "path": path, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": n,
                        "max_abs_err": err[name], **timing[main_shape]})
    print(f"[train] full dlrm-rm1 batch {Bsz}: {json.dumps(step)}")
    print(f"[lm-train] full tinyllama-1.1b batch 4 x 1024: {json.dumps(lm_step)}")
    print(f"[rwkv6-3b-train] full rwkv6-3b batch 4 x 1024: {json.dumps(rw_step)}")
    print(f"[pool-serve] served from the pool mirror: {json.dumps(pool_out)}")
    print(f"[remote] memory node: {json.dumps(remote_out)}")
    print(f"[adagrad] step ms in turns: {json.dumps(ada_step)}")
    print(f"[sharded] three memory nodes: {json.dumps(sharded_out)}")
    print(f"[soak] checked soak: {json.dumps(soak_out)}")
    print(f"[decoders] phase 22: {json.dumps(dec_out)}")
    print(f"[encdec] phase 23: {json.dumps(enc_out)}")
    print(f"[dist] phase 24: {json.dumps(dist_out)}")
    print(f"[dist-train] phase 25: {json.dumps(dt_out)}")
    print(f"[sim] phase 26: {json.dumps(sim_out)}")
    print(f"[tp] phase 27: {json.dumps(tp_out)}")
    print(f"[fsdp] phase 28: {json.dumps(fs_out)}")
    print(f"[moe-mesh] phase 29: {json.dumps(mm_out)}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--drill"]:
        drill_child(int(sys.argv[2]), json.loads(sys.argv[4]) if sys.argv[3:4] == [
            "--tier-e-ms"] else [])
    else:
        main()
