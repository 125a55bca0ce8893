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
     tier-M of the dense tree took 13-22 s a step here): run A checkpoints 4
     relaxed steps and recovers a mirror equal to its tables; run B
     crashes between the undo COMMIT and the mirror apply of step 2,
     recovers the step-1 mirror bitwise, and resumes with losses equal to
     those of run A's state after step 1 with its relaxed carry rebuilt
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
     host-to-card bytes. Then full dlrm-rm1 trains 3 relaxed steps into a
     pmem pool while the tier serves from the same mirror, kept coherent by
     the manager's commit hook: after each commit the rows served (the
     step's touched rows and 4096 others) equal the card's tables bitwise
     and the invalidations equal the cached touched rows exactly; then one
     rm1 forward through the pool route (an EmbeddingPoolMirror of the
     stacked tables, the bags reduced near the data) against the bag
     kernel's: f32 bags within 1e-5, click probabilities within
     DLRM_POOL_PROB_TOL (0: bitwise, the gap measured);
 18. full-width dlrm-rm1 checkpointed into a memory node in a process of
     its own (python -m repro_torch.pool.server, a pmem image under build/,
     a unix socket; removed at the end), the paper's arrangement. Run A, in
     this process: the manager loads the 2.56 GB f32 mirror over the
     socket (seconds and frames printed: it exceeds one frame's 1 GiB cap),
     4 relaxed steps are checkpointed, each step's undo image captured on
     the card must equal the node's bitwise, each tier-E step's link bytes
     must stay within idx + new rows + 4 KB while its media bytes exceed
     them (its ms printed beside phase 6's pmem pool, which does not
     compress), and the mirror
     recovered over a fresh connection must equal the tables bitwise. The
     drill, on a fresh node: the train CLI (python -m
     repro_torch.launch.train --full --pool-backend remote ...) in a
     subprocess is SIGKILLed once the node's manifest shows 3 committed
     steps; the node must be alive, the mirror recovered from POOL.json
     over a fresh connection must equal a clean replay on the card
     bitwise, and 2 resumed steps (a manager on the recovered connection)
     must give the losses of the replay's twin (its tables and dense tree
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
     failure), then node 0 is SIGKILLed and its image deleted; the
     survivors reopen (the lost node as typed errors), the manifest is
     elected 2 of 3, the replica is promoted in one epoch, the recovered
     mirror equals the card's tables at the replication watermark bitwise
     (the step after it rolled back from the replica's undo ring), and 2
     resumed steps give the uninterrupted twin's losses; every client's
     reply stalls printed;
 21. full dlrm-rm1 with f32 tables trained under the crash-consistency
     checker (REPRO_POOL_CHECK=1) into a pmem pool under build/ (removed),
     relaxed, dense_interval=1, pool_compress none: run U checkpoints 4
     steps (launch counts, 16-byte routes, the mirror equal to the
     tables), then an undo-commit persisted over a dirty payload in its
     ring must raise CommitBeforePayloadError; its state after step 0,
     the relaxed carry dropped, is the twin, which takes steps 1-3 without
     a manager. A crash run (seed 1) and a torn run (seed 32) under
     FaultSchedule.seeded(seed, the soak's POINTS, every=4) fault in step
     1's tier-E, are power-cycled, recovered under the checker (step 0,
     gap 0, the mirror bitwise the twin's tables) and resumed to step 4:
     losses bitwise the twin's and within the reference soak's gap-0
     bound (rtol 1e-5) of run U's, the mirror bitwise the twin's tables.
     The fault that fired, each run's seconds, the checked tier-E seconds
     beside phase 6's unchecked ones, the seconds inside the tracker and
     its most dirty intervals printed.
Phases 6 to 21 print their wall time. Phases 4, 8, 10, 12 and 16 also
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
sharded pool; phase 21's run U, rm1 on f32 tables under the checker); the
last line is
{"ok": true, "device": {...}}. Phase 1 prints each kernel's registers,
shared memory and spills from ptxas.
Imports nothing of JAX.
"""
from __future__ import annotations

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
                     plain_step_ms):
    """Phase 6. Returns the launch counts of run A, the checkpointed path,
    and its writer's tier-E ms per step."""
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

        # run A: 4 relaxed steps, every step checkpointed, dense_interval=1
        tca = config("A")
        state = fresh_state()
        t = time.perf_counter()
        mgr = CheckpointManager(cfg, tca.checkpoint, embed_init=state["embed"])
        load_s = time.perf_counter() - t
        print(f"[ckpt] manager start + mirror load (2.56 GB f32 written and "
              f"fsynced): {load_s:.2f}s")
        times, after1, stamps = {}, {"s": 0.0}, [time.perf_counter()]
        time_manager(mgr, times)
        timed_on_step = mgr.on_step

        def on_step(step, st, feed):
            timed_on_step(step, st, feed)
            if step == 1:
                # run A after step 1: the tables on the host in f32, and a
                # twin state on the card with its relaxed carry dropped, as
                # a resume rebuilds it (the tables, the dense leaves and
                # their moments are updated in place: cloned)
                t = time.perf_counter()
                after1["rows"] = host_tables(st)
                after1["state"] = {
                    **st, "prefetch": None,
                    "embed": {"emb_tables": st["embed"]["emb_tables"].clone()},
                    "dense": tree_map(torch.clone, st["dense"]),
                    "opt_dense": tree_map(torch.clone, st["opt_dense"])}
                after1["s"] += time.perf_counter() - t   # not the step's time
        mgr.on_step = on_step
        images = {}

        def on_metrics(n, m):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter() - after1["s"])
            after1["feed"] = m["ckpt_feed"]
            t = time.perf_counter()        # the undo image to the host
            images[n] = undo_image(m["ckpt_feed"])
            after1["s"] += time.perf_counter() - t

        eb.launches = su.launches = su.launches_logged = gr.launches = 0
        su.wide_launches_logged = 0
        _, la = train_loop.train(cfg, tca, batches, 4, relaxed=True, state=state,
                                 ckpt_manager=mgr, on_metrics=on_metrics)
        launches = {"embedding_bag": eb.launches, "scatter_update": su.launches,
                    "scatter_update_logged": su.launches_logged,
                    "gather_rows": gr.launches}
        check(su.wide_launches_logged == su.launches_logged, "run A: the logged "
              f"updates did not all move 16-byte chunks ({su.wide_launches_logged} "
              f"of {su.launches_logged})")
        checked = check_undo_images(mgr.ring, images)
        check(checked == 4, f"run A: {checked} undo entries checked, want 4")
        print(f"[ckpt] run A: the undo images of all {checked} steps, captured on "
              "the card by the logged update, equal the pool's bitwise")
        del images
        step_ms = [1e3 * (b - a) for a, b in zip(stamps[:-1], stamps[1:], strict=True)]
        print(f"[ckpt] run A losses {la} step ms (with on_step) {step_ms}; "
              f"plain relaxed step (phase 4 median) {plain_step_ms:.2f} ms")
        print(f"[ckpt] on_step ms {times['on_step']}; flush ms {times['flush']}; "
              f"writer tier-E ms {times['_do_tier_e']}, tier-M ms {times['_do_tier_m']}")
        # on_step's two halves again, with the writer idle: the touched rows
        # (gather, widen, to the host) and the dense tree to the host
        flat_tab = state["embed"]["emb_tables"].view(-1, d)
        parts = {"rows": [], "dense": []}
        for _ in range(3):
            t = time.perf_counter()
            ids, _ = touched_rows(after1["feed"])
            ops.gather_rows(flat_tab, ids).float().cpu().numpy()
            parts["rows"].append(1e3 * (time.perf_counter() - t))
            t = time.perf_counter()
            tree_map(lambda x: x.detach().to("cpu", copy=True),
                     {k: state[k] for k in ("dense", "opt_dense", "opt_embed")})
            parts["dense"].append(1e3 * (time.perf_counter() - t))
        del after1["feed"]
        print(f"[ckpt] on_step parts with the writer idle, ms: touched rows "
              f"{parts['rows']}, dense tree {parts['dense']}")
        print(f"[ckpt] stats {json.dumps(mgr.stats)}")
        print(f"[ckpt] pool image {os.path.getsize(os.path.join(work, 'A', 'pool.img'))} "
              f"bytes; launches {launches}")
        check(launches == checkpointed_launches(4),
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
        check(rec.mirror_step == 3 and rec.dense_step == 3 and not rec.rolled_back,
              f"run A recovered mirror@{rec.mirror_step} dense@{rec.dense_step}")
        check(np.array_equal(rec.embed_rows, final),
              "run A: recovered mirror differs from the final tables")
        rec.pool.close()
        del rec, final
        shutil.rmtree(os.path.join(work, "A"))
        # the twin: run A's state after step 1, carry rebuilt, 2 relaxed steps
        _, lt = train_loop.train(cfg, tca, batches, 2, relaxed=True,
                                 state=after1.pop("state"), start_step=2)
        gc.collect()
        torch.cuda.empty_cache()

        # run B: the same seed and batches, power loss between the COMMIT
        # and the mirror apply of step 2 (the third tier-E)
        tcb = config("B")
        state = fresh_state()
        mgr = CheckpointManager(cfg, tcb.checkpoint, embed_init=state["embed"],
                                faults=FaultSchedule.crash_at(
                                    "tier_e.between-commit-and-apply", occurrence=3))
        crashed = False
        try:
            train_loop.train(cfg, tcb, batches, 4, relaxed=True, state=state,
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
        check(rec.mirror_step == 1 and rec.dense_step == 1 and rec.rolled_back,
              "run B: expected mirror@1, dense@1 with a rollback")
        check(np.array_equal(rec.embed_rows, after1["rows"]),
              "run B: recovered mirror differs from run A's tables after step 1")
        del after1["rows"]

        # resume as the CLI does: a manager on the recovered pool, 2 relaxed
        # steps (losses against run A's steps 2-3), then 1 strict step
        state, start = recovery.resume_train_state(rec, fresh_state())
        check(start == 2, f"resume step {start}")
        mgr = CheckpointManager(cfg, tcb.checkpoint, pool=rec.pool)
        mgr.init_mirror(state["embed"], step=rec.mirror_step)
        del rec
        gr.launches = 0
        state, lb = train_loop.train(cfg, tcb, batches, 2, relaxed=True,
                                     state=state, start_step=start, ckpt_manager=mgr)
        relaxed_gathers = gr.launches
        train_loop.train(cfg, tcb, batches, 1, relaxed=False, state=state,
                         start_step=start + 2, ckpt_manager=mgr)
        mgr.close()
        rel = max(abs(x - y) / abs(y) for x, y in zip(lb, la[2:], strict=True))
        print(f"[ckpt] resumed losses {lb}; run A's twin (state after step 1, "
              f"carry rebuilt) {lt}; run A {la[2:]} (max relative difference "
              f"{rel:.3g}); gather launches {relaxed_gathers} for 2 relaxed "
              f"steps, {gr.launches} after 1 strict")
        # The recovered state is run A's after step 1 bit for bit, so the
        # resumed losses equal the twin's exactly.
        check(lb == lt, "resumed losses differ from run A's twin")
        # Against run A itself they differ by the carry: run A's bags for
        # step 2 were rounded to bf16 twice (the stale bag, then with the
        # correction added), the resumed ones once, from the updated
        # tables. bf16 keeps 8 bits, so a bag moves by up to 2^-9 of itself
        # and the loss by about 1e-3; 1e-2 bounds it.
        check(rel <= 1e-2, f"resumed losses differ from run A's by {rel:.3g}")
        check(relaxed_gathers == 2 and gr.launches == 2,
              "gather_rows: want 1 launch per relaxed step, 0 per strict step")
        del mgr, state
        gc.collect()
        torch.cuda.empty_cache()
        print("[ckpt] crash, bitwise recovery and resume: ok")
        return launches, times["_do_tier_e"]
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
    make: the sequence mixer once a layer in the prefill (all on the
    tensor-core route where it has one, none on a decode route) and
    ``per_step`` times a decode step (all on a decode route where it has
    one); ``gathers`` row gathers a forward pass."""
    mix = mixer.__name__.rsplit(".", 1)[1]
    want = {"prefill": {mix: cfg.num_layers, "gather_rows": gathers},
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


def serve_phase(torch, np, dev, check_gather, arch, mixer, per_step):
    """Phases 8 and 10: serve full ``arch``. ``mixer`` is the wrapper module
    of the path's sequence-mixer kernel (flash attention, wkv6), launched
    once per layer in the prefill and ``per_step`` times in each decode
    step. Returns the serving run's launch counts for each part ("prefill",
    "decode"), the row gather's timings at each part's shape, and the run's
    tokens and logits (on the host), which phase 17 holds the pool-served
    run to."""
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import make_batches
    from repro_torch.kernels import gather_rows as gr
    from repro_torch.kernels import ops, ref
    from repro_torch.models.registry import get_api
    from repro_torch.training.serve_loop import greedy_generate
    from repro_torch.tree import tree_leaves, tree_map

    mix = mixer.__name__.rsplit(".", 1)[1]
    cfg = get_arch(arch).model
    api = get_api(cfg)
    B, S, new = 4, 1024, 32
    t = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = api.init(gen, cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(params))
    prompt = make_batches(cfg, B, S, device=dev).next(0)["tokens"]
    print(f"[serve] full {arch}: {n_params} params "
          f"({sum(p.numel() * p.element_size() for p in tree_leaves(params)) / 1e9:.2f} "
          f"GB, {cfg.dtype}), init and prompt {time.perf_counter() - t:.1f}s")
    greedy_generate(cfg, params, prompt, 2, max_seq=S + new)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    parts = {}
    serve_counts(mixer, gr, zero=True)
    gr.wide_launches = 0
    stats = {}
    toks = greedy_generate(cfg, params, prompt, new, max_seq=S + new, stats=stats,
                           part=part_counter(parts, lambda: serve_counts(mixer, gr)))
    launches = serve_counts(mixer, gr)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    metrics = {"prefill_ms": 1e3 * stats["prefill_s"],
               "decode_ms_per_token": 1e3 * stats["decode_s"] / (new - 1),
               "tokens_per_s": B * new / (stats["prefill_s"] + stats["decode_s"]),
               "peak_device_gb": peak_gb}
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
    toks2 = greedy_generate(cfg, params, prompt, new, max_seq=S + new, stats=again)
    check(torch.equal(toks, toks2) and torch.equal(stats["logits"], again["logits"]),
          "serve: a second run gave other tokens or logits")
    del again
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
    ext = torch.cat([prompt, toks[:, :1]], dim=1)
    full, _ = api.prefill(params, cfg, ext, api.init_cache(cfg, B, S + 1, dev))
    dec = stats["logits"][:, 1]
    diff, scale = (dec - full).abs().max().item(), full.abs().max().item()
    print(f"[serve] decode at position {S} vs prefill of {S + 1}: max abs diff "
          f"{diff:.4g}, logits max abs {scale:.4g} (limit 3e-2 of it); argmax "
          f"equal in {int((dec.argmax(-1) == full.argmax(-1)).sum())} of {B} rows")
    check(diff <= 3e-2 * scale, "serve: decode disagrees with prefill")
    del params, stats, full
    torch.cuda.empty_cache()

    # the smoke model on the card and on the CPU from the same params (f32)
    scfg = get_arch(arch, smoke=True).model
    gen = torch.Generator()
    gen.manual_seed(0)
    sparams = api.init(gen, scfg)
    sprompt = make_batches(scfg, 2, 9, device="cpu").next(0)["tokens"]
    out = {}
    for name, where in (("card", dev), ("cpu", torch.device("cpu"))):
        st = {}
        tk = greedy_generate(scfg, tree_map(lambda p, w=where: p.to(w), sparams),
                             sprompt.to(where), 4, max_seq=16, stats=st)
        out[name] = (tk.cpu(), st["logits"].cpu())
    print(f"[serve] smoke tokens card {out['card'][0].tolist()} cpu "
          f"{out['cpu'][0].tolist()}; logits max abs diff "
          f"{(out['card'][1] - out['cpu'][1]).abs().max().item():.3g}")
    check(torch.equal(out["card"][0], out["cpu"][0]), "serve smoke: tokens differ")
    np.testing.assert_allclose(out["card"][1].numpy(), out["cpu"][1].numpy(),
                               rtol=1e-4, atol=1e-5)
    return parts, timing, served


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


def lm_train_runs(torch, dev, arch, mixer_want):
    """Full-width training of ``arch`` (bf16, remat, batch 4 x 1024): 3
    relaxed steps, 3 strict ones and the relaxed run again, each from the
    same params, and one profiled relaxed step. ``mixer_want`` is the
    sequence mixer's launches per step. Checks bitwise-equal losses, the
    repeat and every step's launch counts. Returns (the relaxed run's
    launch counts with the strict run's updates as "scatter_update_strict",
    the step metrics, the run's batches)."""
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
    print(f"{tag} full {arch}: {n_params} params, {cfg.dtype}, remat, batch {B} x "
          f"seq {S}; init {time.perf_counter() - t:.1f}s")

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
    strict_updates = su.launches   # all on the bf16 table
    check(su.wide_launches == strict_updates, f"{arch}: the strict run's updates "
          f"did not all move 16-byte chunks ({su.wide_launches} of {strict_updates})")
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
            "busy_share": busy / wall, "peak_device_gb": peak_gb}
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
    # correction (set, gather, clear the scratch), strict steps the lookup
    common = {"flash_attention": 0, "flash_attention_tc": 0, "flash_attention_bwd": 0,
              "wkv6": 0, "wkv6_decode": 0, "wkv6_bwd": 0, **mixer_want,
              "embedding_bag": eb.PASSES}
    want_relaxed = {**common, "gather_rows": 2, "scatter_update": 2,
                    "scatter_update_logged": 1}
    want_strict = {**common, "gather_rows": 1, "scatter_update": 1,
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
                            cpu_runs=None):
    """Smoke ``arch`` trained on the card and on the CPU from the same
    params (``n_steps`` relaxed steps in ``dtype``, TF32 off). Returns
    {run name: (losses, dense params f32 on the host, table f32)} for the
    run "card" and the CPU runs; ``on_card()`` reads counters before and
    after the card's run, their difference going to "card_counts".
    ``cpu_runs`` maps each CPU run's name to a context it runs in (default:
    one run, "cpu", as it is)."""
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
    runs = [("card", dev, contextlib.nullcontext)] + [
        (name, torch.device("cpu"), ctx) for name, ctx in
        (cpu_runs or {"cpu": contextlib.nullcontext}).items()]
    for name, where, ctx in runs:
        st = sinit(tree_map(lambda p, w=where: p.to(w, copy=True), sparams))
        before = on_card() if on_card is not None and name == "card" else None
        with ctx():
            st, losses = train_loop.train(c, tc, make_batches(c, 4, 16, device=where),
                                          n_steps, relaxed=True, state=st, device=where)
        out[name] = (losses, [p.detach().float().cpu() for p in tree_leaves(st["dense"])],
                     st["embed"]["table"].float().cpu())
        if before is not None:
            out["card_counts"] = {k: v - before[k] for k, v in on_card().items()}
    return out


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
    """Phase 17 (b): full dlrm-rm1 trains into a pmem pool (3 relaxed
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
                                    depth=4)
        train_loop.train(cfg, tcp, batches, 3, relaxed=True, state=state,
                         ckpt_manager=mgr)
        s = tier.stats()
        check(len(log) == 3 and s["watermark"] == 2, f"pool dlrm: {log}, {s}")
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


def four_checkpointed_steps(tag, cfg, tc, Bsz, dev, state, mgr, where):
    """4 relaxed steps of full rm1 checkpointed by ``mgr``: exactly the
    launches of 4 such steps, every row kernel on the 16-byte route, and
    each step's undo image, captured on the card by the logged update,
    equal to the pool's (``where``) bitwise. Returns (state, losses,
    launches)."""
    from repro_torch.core.checkpoint.manager import check_undo_images, undo_image
    from repro_torch.data.lookahead import LookaheadIterator
    from repro_torch.data.synthetic import DLRMBatches
    batches = LookaheadIterator(DLRMBatches(cfg, Bsz, seed=0, device=dev), cfg,
                                depth=5)
    images = {}

    def on_metrics(n, m):
        images[n] = undo_image(m["ckpt_feed"])
    zero_row_counts()
    state, losses = train_loop_train(cfg, tc, batches, 4, state, mgr, on_metrics)
    c = row_counts()
    launches = {k: c[k] for k in checkpointed_launches(4)}
    print(f"{tag} 4 relaxed steps, losses {losses}; launches {launches}")
    check(launches == checkpointed_launches(4),
          f"{tag} unexpected launch counts {launches}")
    check(c["scatter_update_wide"] == c["scatter_update"]
          and c["gather_rows_wide"] == c["gather_rows"]
          and c["scatter_update_logged_wide"] == c["scatter_update_logged"],
          f"{tag} a row kernel launch off the 16-byte route: {c}")
    checked = check_undo_images(mgr.ring, images)
    check(checked == 4, f"{tag} {checked} undo entries checked, want 4")
    print(f"{tag} the undo images of all {checked} steps, captured on the card "
          f"by the logged update, equal {where}'s bitwise")
    return state, losses, launches


def twin_and_resume(tag, cfg, tc, cc, Bsz, dev, fresh_state, rec, twin, m):
    """The uninterrupted twin, ``twin`` (the tables and the dense tree after
    step m) with its relaxed carry rebuilt, takes 2 relaxed steps; then the
    resume as the CLI does it: the state from ``rec``, a manager with
    ``cc`` on the recovered pool, the mirror re-initialised at m, 2 relaxed
    steps. Fails unless the two give the same losses. Returns the resumed
    run's manager, still open, and its mirror load in seconds."""
    import gc

    import torch

    from repro_torch.core.checkpoint import recovery
    from repro_torch.core.checkpoint.manager import CheckpointManager
    from repro_torch.data.lookahead import LookaheadIterator
    from repro_torch.data.synthetic import DLRMBatches

    def batches(start):
        return LookaheadIterator(DLRMBatches(cfg, Bsz, seed=0, device=dev), cfg,
                                 depth=3, start_step=start)
    twin = {**twin, "prefetch": None,
            "step": torch.tensor(m + 1, dtype=torch.int32, device=dev)}
    _, lt = train_loop_train(cfg, tc, batches(m + 1), 2, twin, None, None,
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
                             batches(start), 2, state, mgr, None, start=start)
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
        # -- run A, in process: 4 relaxed steps over the unix socket -------
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
        state, _, launches = four_checkpointed_steps(
            "[remote] run A:", cfg, tca, Bsz, dev, state, mgr, "the node")
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
        check(rec.mirror_step == 3 and not rec.rolled_back,
              f"remote run A recovered mirror@{rec.mirror_step}")
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
        while committed < 2:
            trainer = procs["trainer"]
            if trainer.poll() is not None:
                with open(os.path.join(work, "trainer.log")) as f:
                    fail(f"remote drill: the trainer exited (exit "
                         f"{trainer.returncode}) before it was killed:\n"
                         f"{f.read()[-6000:]}")
            check(time.perf_counter() - t0 < 600, "remote drill: fewer than 3 "
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
        check(m >= 2 and 0 <= ds <= m, f"remote drill: recovered mirror@{m} "
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
        state, _, launches = four_checkpointed_steps(
            "[sharded]", cfg, tcs, Bsz, dev, state, mgr, f"node {lost}")
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


# Phase 21's faulted runs. FaultSchedule.seeded(seed, POINTS, every=SOAK_STEPS)
# arms each of the soak's points, which fire once a step at dense_interval=1,
# at occurrence crc32(f"{seed}:{point}") % SOAK_STEPS + 1. For these two seeds
# no point is armed before its second occurrence, and the first to come due
# fires in step 1's tier-E, after step 0 was committed: seed 1 crashes before
# step 1's undo payload persists (nothing to roll back), seed 32 tears step
# 1's mirror apply (the committed entry rolls the torn rows back). Both
# recover step SOAK_RECOVERED with the dense tier caught up (gap 0).
SOAK_SEEDS = (("crash", 1), ("torn", 32))
SOAK_STEPS = 4
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
    ``FaultSchedule.seeded(seed, POINTS, every=SOAK_STEPS)``: after the
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
            faults = FaultSchedule.seeded(seed, POINTS, every=SOAK_STEPS, kind=kind)
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


def train_loop_train(cfg, tc, batches, steps, state, mgr, on_metrics, start=0):
    """``train_loop.train`` of relaxed steps on the card."""
    from repro_torch.training import train_loop
    return train_loop.train(cfg, tc, batches, steps, relaxed=True, state=state,
                            start_step=start, ckpt_manager=mgr,
                            on_metrics=on_metrics)


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        fail("no src/repro_torch beside this script: run it from the repo's root")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import TrainConfig
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

    torch.backends.cuda.matmul.allow_tf32 = False   # full-f32 matmuls
    dev = torch.device("cuda")
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
    comb_seg = torch.cumsum(torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                                       flat[sorted_items][1:] != flat[sorted_items][:-1]]),
                            0, dtype=torch.int32) - 1
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
        "bag_combine": (lambda: ops.embedding_bag(g_rows, comb_src, comb_seg, N),
                        lambda: ref.embedding_bag_ref(g_rows, comb_src, comb_seg, N),
                        None,
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
    tc = TrainConfig(learning_rate=1e-3, embed_learning_rate=0.05)

    def fresh_state():
        gen = torch.Generator(device=dev)
        gen.manual_seed(tc.seed)
        init_fn = train_loop.make_step_fns(cfg, tc)[0]
        state = init_fn(get_api(cfg).init(gen, cfg))
        torch.cuda.synchronize()
        return state

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
    ck_launches, ck_tier_e_ms = checkpoint_phase(torch, np, cfg, tc, Bsz, dev,
                                                 fresh_state,
                                                 step["relaxed_ms_median"])
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
    sv_parts, sv_gather, sv_served = serve_phase(torch, np, dev, check_gather,
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
    rw_parts, rw_gather, rw_served = serve_phase(
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

    # -- 18. full rm1 checkpointed into a memory node in its own process ------------
    t0 = time.perf_counter()
    remote_launches, remote_out = remote_checkpoint_phase(
        torch, np, cfg, tc, Bsz, dev, fresh_state, ck_tier_e_ms)
    print(f"[remote] phase 18 wall time {time.perf_counter() - t0:.1f}s")

    # -- 19. row-wise Adagrad on the sparse tier at full width ---------------------
    t0 = time.perf_counter()
    ada_launches, ada_step, ada_timing = adagrad_phase(torch, np, dev, check_update,
                                                       check_gather)
    timing.update(ada_timing)
    print(f"[adagrad] phase 19 wall time {time.perf_counter() - t0:.1f}s")

    # -- 20. full rm1 checkpointed into a sharded pool of three memory nodes ------
    t0 = time.perf_counter()
    sharded_launches, sharded_out = sharded_checkpoint_phase(torch, np, cfg, tc, Bsz,
                                                             dev, fresh_state)
    print(f"[sharded] phase 20 wall time {time.perf_counter() - t0:.1f}s")

    # -- 21. full rm1 trained under the checker through seeded crashes -----------
    t0 = time.perf_counter()
    soak_launches, soak_out = checked_soak_phase(torch, np, cfg, tc, Bsz, dev,
                                                 ck_tier_e_ms)
    print(f"[soak] phase 21 wall time {time.perf_counter() - t0:.1f}s")

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
             soak_launches["gather_rows"], *gather_src)):
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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
