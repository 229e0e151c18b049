#!/usr/bin/env python3
"""Drive multiverso_tpu_torch's main path on one NVIDIA card and check it.

Phases, every one on every run, in this order:

1. build    compile every CUDA kernel from ``multiverso_tpu_torch/csrc``
            into ``build/torch_kernels/`` (one nvcc per source, in
            parallel; the 472M LM's numpy parameters are drawn on a
            thread meanwhile), print ptxas's registers and spills, and
            check with
            ``cuobjdump -sass`` that the bf16 B1 (forward), B2 (dQ) and B3
            (dK/dV) kernels hold wgmma (HGMMA) and TMA-load (UTMALDG)
            instructions, and in ptxas's report that they spill nothing
2. kernel   each kernel (B1 forward, B2 dQ, B3 dK/dV) against its plain
            PyTorch version on the card, at the main paths' shape and at
            edge shapes, plus CUDA-event times: the kernel and its library
            call in turns (median of 6 runs each), the kernel with a cold
            L2, and the plain version
3. ps       init() on the card, the 472M LM's parameters in one ArrayTable
            (SharedPytree), Get, two syncs (Add of a delta, then Get), with
            and without the write-triggered prefetch, each checked against
            numpy bit for bit, and a Get at an unchanged version served by
            the get cache; each updater timed on a 16M-element table; on
            16M-element tables: 16 pipelined numpy adds merged into one
            apply (default, sgd) against numpy's float64 sum bit for bit,
            beside 16 blocking adds; store/load of an adam table bit for
            bit; wire_filter bf16, 1bit and topk over 8 adds with error
            feedback against the numpy filters bit for bit, the codec on
            the card too
4. request  the full-width LM built from the table's Get scores request
            batches [2, 1024] with attn="flash" under inference_mode (a
            main path: launch counts are zeroed just before and read just
            after), checked against attn="local" on the same weights
5. train    the full-width LM built from the table's Get trains through
            the PS (``train_ps``: SGD steps on one batch, a delta-sync
            every few steps; the other main path, counted the same way),
            each sync checked against numpy bit for bit, the gradients of
            attn="flash" against attn="local", and one step profiled; then
            the torch.optim step (``make_optim_train_step``) with AdamW: a
            warm step held to the plain AdamW update, 3 timed steps, the
            loss falling, peak memory (its launches count into train)
6. we       the WordEmbedding path (no kernel of its own: gathers, matrix
            products, index_add_ and the threefry sampler's integer
            arithmetic): the native data library built and loaded,
            MatrixTable row Add/Get with duplicate ids on a 71,290 x 128
            table against numpy bit for bit, and with the hot-row train
            cache (a full-hit get_rows, the cached rows equal to the
            table's after zipf add_rows), ``train_fused`` on the
            real-text corpus (bench.py:220-221) with the shared pool and
            on the synthetic one (bench.py:114-121), one warm and one
            timed epoch each (words/s, device span, falling loss), the
            real-text probe's nearest neighbours, bf16 against f32 from the
            same start (by loss over the first 8 batches; the full epoch
            beside the f32-twice spread), the card's f32 epoch against the
            CPU's on the same batches, one profiled epoch; then the four
            other branches on the real text at the same width (skip-gram
            with per-pair negatives, skip-gram HS, CBOW NS, CBOW HS), each
            with warm and timed epochs, its f32 epoch against the CPU's,
            the run-to-run spread, for per-pair negatives the ids of the
            epoch's first 32 batches drawn on the card against the CPU's
            bit for bit, and one
            profiled epoch; and the app's command line (``python -m
            multiverso_tpu_torch.apps.word_embedding``, with the shared
            pool, with ``-cbow 1 -hs 1`` and, for the we_ps phase's PS
            block path, with ``-use_ps 1``), each in its own process, the
            three side by side, their vectors read back
7. we_ps    the PS block path (``train_ps_blocks``, ``-use_ps 1``; no
            kernel of its own either) at bench.py:158-159's widths (batch
            8,192, blocks of 50,000 tokens) on the real text: the four
            variants on the device plane (HS at the batch where its loss
            falls, found by halving), each with warm and timed epochs
            (words/s, device span, the host's cost per block), one
            profiled epoch and its first 2 blocks against the CPU's;
            skip-gram NS on the host plane, pipelined and inline, the
            planes held against each other within the run-to-run spread;
            skip-gram NS on the pipelined host plane with the hot-row train
            cache (hit rate, device blocks, words/s, its tables against the
            cache-off spread, its rows against the tables' bit for bit);
            and the 1M-token synthetic corpus (bench.py:178) (its
            ``-use_ps 1`` command line runs beside the we phase's). Launches
            are counted apart from the ``we`` phase's
8. lr       LogisticRegression (``apps/logistic_regression.py``; no kernel
            of its own: matrix products and elementwise ops) at LR-MNIST's
            width (784 inputs, 10 classes, bench.py:194-199's softmax,
            minibatch 64, lr 0.05, SGD) on the JAX package's MNIST-shaped
            fixture (60,000 + 10,000 samples): the fused ``train_arrays``
            (a warm and 3 timed epochs, samples/s, device span, one
            profiled epoch, its first epoch's table and test accuracy
            against the CPU's); the ``use_ps`` host loop over a dense file
            of 8,192 samples with sync_frequency 1 and 3, each with and
            without the pipelined pull, and with the SSP clock (the
            deterministic run against the CPU's); the sparse path on a
            SparseMatrixTable at rcv1.binary's shape (47,236 features,
            20,242 samples) with sigmoid + FTRL and softmax + SGD (two
            epochs, the first against the CPU's, the stale share of the
            second's pulls, FTRL's exact zeros, held-out accuracy); and
            the command line, its model read back. Launches are counted
            apart
9. ps_async the async parameter-server plane (``multiverso_tpu_torch/ps``:
            PSService, shards on the card, the async tables; no kernel of
            its own), launches counted apart: (a) two ranks in this
            process over a FileRendezvous and loopback TCP on a 100,000 x
            128 f32 AsyncMatrixTable (tools/bench_async_ps.py:57), 1,024-row
            strided batches from both ranks' clients at once for 1 s, with
            the default updater and AdaGrad, over wire none and bf16
            (adds/s, gets/s, Get p50/p99 ms); each full Get from both
            ranks held against a numpy model of the same f32 operations,
            bit for bit for the default updater (bf16 deltas and replies
            where they cross the socket) and within 1e-5 for AdaGrad;
            (b) WordEmbedding in two OS processes on this card
            (``examples/we_async.py``, -use_ps 1 -async_ps 1 at
            bench.py:146-182's PS cell, in the reference's layout: every
            rank sweeps every block with its deltas divided by the world,
            the ranks meeting before each epoch after the warm one), on
            the real text and the 1M-token synthetic corpus, a warm and a
            measured epoch (words/s per rank and summed, the losses
            finite, their mean over the ranks falling by at least 0.25%
            of itself on the real text and 30% on the synthetic corpus
            (half the least fall of either package), both ranks reading
            the same tables and counting every rank's words; host ms by
            monitor; on the real text one more epoch profiled for the
            idle share),
            then at world 1 the pipelined path with the train cache
            against the unpipelined, uncached oracle on 125,000 tokens
            (bench.py:361-375) within 4x the oracle's run-to-run spread;
            (c) LR with async_ps=true, dense and sparse FTRL at
            rcv1.binary's shape (samples/s), each first epoch held against
            the CPU's within 1e-4 of max |x|
10. resnet  ResNet-CIFAR (``apps/resnet_cifar.py``: every parameter in one
            Adam ArrayTable; no kernel of its own: cuDNN's convolutions
            and elementwise ops) at bench_resnet's shape (depth 32, batch
            128) on 25,000 synthetic_cifar images uploaded once (half of
            its 50,000): the card's first 2 steps against the CPU's from
            one start, a warm and a timed epoch (s/epoch, images/s, a
            full 50k epoch scaled from it beside the
            reference's GTX TITAN X times), the loss falling epoch over
            epoch, one profiled epoch (conv, BN and elementwise, Adam,
            other; the idle share), the eval accuracy on 512 images
11. lda     the topic model (``models/lda.py``) over a SparseMatrixTable:
            the planted-topic run of tests/test_lda.py (purity, the
            likelihood ascending, the table against the CPU's), then a
            timed run at 100,000 words x 1,024 topics, batches of 512
            documents (tokens/s, get_rows_sparse and add_rows ms, the
            stale share of the pulls)
12. decode  the LM's serving path (``generate``, ``generate_beam``, int8
            weights; dense attention over the KV cache, not the flash
            kernel): bench_decode's config in f32 and int8 (tokens/s, ms a
            step) with its checks (the teacher-forced argmax, batched
            against token-by-token prefill, num_beams=1 against greedy,
            the card's first-step logits against the CPU's, the int8
            logits within their scales' bound, a top_p sample), then the
            472M LM in bf16, int8 and a beam of 4 (tokens/s, ms a step,
            peak memory, weight bytes). Each of the three phases counts
            its launches apart and launches no flash kernel
13. ps_window the client send and get windows (``ps/tables.py``) on two
            ranks in this process: 1-row adds window on vs off (p50 per
            call, tools/bench_small_add.py), 1-row gets with the get
            coalescer on vs off (p50/p99), 4 threads pulling at once (gets
            per frame), a 120,000 x 8 bf16 get plain and chunk-streamed
            (tools/bench_get_rows.py), and ps_async (a)'s 100,000 x 128
            plane with the send window on and off (adds/s, shard sub-ops
            and applies); every pair of arms equal bit for bit, the plane
            against a numpy model
14. serving DLRM train-while-serve (``apps/dlrm_serving.py``: the async
            PS, ``serving/replica.py``'s ReadReplica with its hot-row cache
            on the card, admission control): the card's first 4 train
            steps (app and ``make_train_step``) against the CPU's, then (a)
            tools/bench_serving.py's cell and (b) DLRM at the Criteo Kaggle
            widths of facebookresearch/dlrm (26 fields capped at 1,000,000
            rows, MLPs 13-512-256-64-16 and 512-256-1, batch 128), each
            through the tool's calib, steady and overload phases: train
            steps/s, write ms p50/p99 by phase, served QPS, infer
            p50/p99/p999, staleness against the bound, shed rate,
            deferred refreshes, the hot cache's hit rate against the
            sketch's estimate; asserted: replica parity bit for bit, every
            served read within the bound, overload sheds while the write
            p50 degrades at most 2x, the loss falls; each part then 20
            profiled train steps (the idle share); (b) also a timed
            snapshot pull (which sets the cadence) and a pull of the
            uncapped 33.76M-row table. Both phases count their launches
            apart and launch no flash kernel
15. chaos   failover, faults and replay on the async plane
            (``examples/chaos.py``, tools/bench_chaos.py's scenarios and
            gates; no kernel of the port): (a) partition_heal,
            dup_reorder, slow_shard_shed, replica_kill and noisy_neighbor
            on two ranks in this process, both shards on the card, 32 x 8
            with a 1 ms send window and replay on, the SLO sentinel
            judging an availability objective on explicit polls (it fires
            in the cut and clears after the heal, stays quiet under
            duplicates and reorders, ends clear after the slow phase,
            whose mid-slow signal bus makes mvautoscale say GROW), each
            episode printed with its burns and times; noisy_neighbor's
            two tenants over their own budgets (the storm capped, the
            victim's p99, one verdict opened and cleared); (b) combined
            at 64 x 8 (two OS
            processes, each shard on the card: SIGKILL of rank 1 and a
            replica kill at one instant, this process's
            FailoverSupervisor respawning rank 1 at generation 1 from its
            newest committed per-shard checkpoint); (c) combined at
            100,000 x 128; then save_shard_state and restore_shard_state
            of a 100,000 x 128 AdaGrad shard, timed, with the add p99
            while saves run. Asserted, strict: exactly-once (no op lost,
            none applied twice, the table equal to the acked oracle bit
            for bit), served reads within their bound, the spare
            activated, injections nonzero and deduped, the respawn at
            generation 1 restored from a tag; recovery to 90% of the
            pre-fault rate gets one more run before it fails. It counts
            its launches apart and launches no flash kernel
16. ps_native the native C++ transport (``ps/native.py`` over
            ``csrc/mv_ps.cpp``, built with g++ at first use; host code,
            no kernel of the card) against the Python wire plane on
            examples/ps_bench.py's cell (tools/bench_async_ps.py:57: a
            100,000 x 128 f32 table, 1,024-row strided batches from both
            ranks' clients at once for 1 s): (a) both ranks in this
            process, shards on the card (the C++ server punts every op;
            the client is native); (b) the same with the shards on the
            CPU, registered with the C++ server, which serves every add
            and get; (c) one rank per OS process, shards on the card.
            Each part, each plane: adds/s, gets/s, Get p50/p99, the plane
            asserted (the table's client, the server, registration, the
            native applies), every full Get equal to numpy bit for bit;
            then a bf16-wire table, which punts. It counts its launches
            apart and launches no flash kernel
17. cluster the cluster telemetry plane (``telemetry/aggregator.py``,
            ``signals.py``, ``slo.py``, ``tenants.py``; the port's
            ``tools/mvtop.py`` and ``mvautoscale.py``; host code, no
            kernel of the card), counted apart: (a) two ranks in this
            process on a 100,000 x 128 table, rank 0's service starting
            the poller itself (``stats_poll_interval_s`` 0.5,
            ``metrics_dir`` set), Zipf-hot traffic from 4 client threads:
            the record's per-table adds, applies and gets equal the
            shards' ``stats()`` sums exactly, the merged monitors the
            ranks' sums, the planted hot rows head the top-K, the windowed
            skew is about 1 for uniform traffic and 2 for rank 1's rows
            only, applies/s equal the shards' deltas over the polls'
            interval, ``cluster.jsonl`` holds every poll and the final one
            and ``cluster.prom`` parses; card shards on the Python plane,
            card shards on the native plane (punted), CPU shards on the
            native plane (served by C++); (b) four ranks, one a process
            (ps_bench, card shards) read by ``mvtop --once --json`` (exit
            0, 4 ranks) and ``mvautoscale --dry-run`` (hold) from other
            processes; (c) two tenants on card shards, each tenant's ops
            metered exactly, ``tenant_add_qps`` deferring the over-budget
            tenant within its token bucket's bound; (d) printed, not
            gated: one poll's wall time at world 2 and 4, the jsonl bytes
            a record, the 1-row add p50/p99 with the poller at 0.5 s
            against off, in turns
18. spmd    the PS half of the mesh data plane (``ps/spmd.py``: flags
            ``ps_fanout`` and ``ps_spmd_stack``; host code and the
            shards' index_add_, index_select and elementwise ops, no
            kernel of the port) on tools/bench_scale.py's cell (40,000 x
            128 f32, 2048-row batches, M = min(cores, 4) clients at every
            point), every world in this process with every shard on the
            card: (a) 4 ranks stacked into one plane on the card, the
            default updater, AdaGrad and momentum, seeded 2048-row adds
            from every rank's client, the full Get equal to a 1-shard
            classic world's bit for bit, one plane dispatch and one apply
            a shard for each multi-owner add; (b) a pinned slab of a
            grouped shard unchanged by a grouped apply, then ``set_rows``
            evicting that member alone, the table still equal to the
            classic one; (c) the scale curve at 1, 2, 4 and 8 shards,
            flags armed then off, for 1 s each: adds of ones on each
            client's own strided rows and gets of them, every row equal
            to its count of adds; T_n (rows/s), E_n = T_n / (n T_1), Get
            p50/p99, plane dispatches an add, and the idle share of the
            armed 4-shard point (profiled). It counts its launches apart
            and launches no flash kernel
19. telemetry the per-process telemetry plane (``telemetry/``,
            ``utils/profiling.py``, ``tools/``), counted apart: (a) the
            step profiler over ps_async (b)'s measured WE epoch at world 2
            (``we_async.py --step_profile``): each rank's per-step phase
            means, held on the real text to the JAX WE async bench's
            in-run bounds (attributed >= 0.90, stall < 0.2, 0 steady
            rebuilds); (b) one train step of the 472M LM under
            ``utils.profiling.trace`` with ``annotate`` regions: the
            Chrome trace names B1-B3 by their CUDA functions as often as
            the wrappers counted their launches (one a layer each), the
            memory ledger's gauge of the LM's ArrayTable equals its bytes
            and the device census holds at least those bytes on cuda:0;
            (c) ps_bench's 100,000 x 128 cell in two processes with trace
            IDs and the metrics exporter on (0.5 s): every metrics record
            and ``.prom`` file reads with the port's ``dump_metrics``, and
            a client add's trace reaches the owner's serve and apply; (d)
            chaos (b)'s survivor's flight-recorder dump names the killed
            rank with its unacked requests, and the port's ``postmortem``
            merges the dumps; (e) the always-on recorder's cost: the
            windowed 1-row add p50, the native plane's adds/s and Get p50
            and the serving write-p50 ratio beside the figures PERF.md
            records (notes, not gates)

20. mesh   the parallel layers (``parallel/``, the LM's mesh layouts) on
            two ranks spawned on this one card over gloo (NCCL refuses
            two ranks on one card; ``ppermute``'s sends run on host
            copies, counted), at the 472M LM's widths, each part against
            world-1 references built in this process first (the LM's
            seed-0 params, handed over as .npy files): (a) tp=2 with
            attn="flash", 4 layers: the logits and the loss, two SGD
            steps each with its gathered gradient, B1-B3 on each rank's 8
            heads, step ms and each collective's bytes and ms; (b) sp=2
            at seq 1024 (2 layers), ring, zigzag and Ulysses, one forward
            and backward each against world 1's local attention; (c)
            pp=2, n_micro 2 (4 layers, 2 a stage) and (d) fsdp=2 (2
            layers), one train step each; (e) ep=2 MoE (README.md:107-110: 64 experts, top-2; 2
            layers), a forward at the capacity where nothing drops
            against the dense every-expert oracle (f32), then two bf16
            train steps at capacity 2.0 (loss, aux); (f) ``worker_step``
            BSP at examples/cnn_worker_map.py's shape, the loss falling.
            Its launches are the ranks' own, summed
21. world  the multi-process world (``net_init`` over a TCPStore,
            ``Zoo``'s world, collective adds and unions, ``aggregate``,
            ``StoreRendezvous``): two ranks on this card, started as a
            launcher starts them (environment, LOCAL_RANK) and met over
            gloo: (a) tests/multiprocess_worker.py's steps with the
            tables on the card, held to its closed forms (the async
            rows' sum 96, the store's publish/lookup round trip); (b)
            the LM at its widths cut to 2 layers, each rank its own
            seeded batch, 4 ``train_ps`` steps with a sync every 2, each
            sync equal to numpy's last + both ranks' deltas bit for bit
            and the replicas to each other, the loss falling, B1-B3
            counted on each rank and held to their plain versions there;
            (c) bench.py:419's aggregate cell, 16 MB, ``process_sum``
            against allgather + sum at world 2 (not 4), equal, ms
22. harness the reference's Test/main.cpp battery
            (``multiverso_tpu_torch/harness.py``) and the binding
            surfaces (``handlers.py``, ``examples/xor_mlp.py``,
            ``torch_ext.py``; host code and torch ops on the tables, no
            kernel of the port), counted apart: (a) every entry of the
            battery's ``_ALL`` and dense_perf and sparse_perf in one
            process on the card, each entry's seconds and the perf
            entries' timings; (b) beside it, kv, matrix, array and
            allreduce as a world of two processes on this card
            (``-nprocs=2``, gloo) in one relaunch; (c) the handlers and
            TorchParamManager on the card equal to the same run on the
            CPU bit for bit, XOR's
            losses within 1e-4; (d) ``threefry.normal`` on the card
            against the CPU within 3 ulps. Every process it starts has a
            timeout that fails the run

It prints the card's name and power limit, each phase's wall seconds as
the phase ends (``phase <name>: <s> s (total <s> s)``) and the walls of
the large phases' parts (``part <phase>/<part>: <s> s``), one
``{"kernels": [...]}`` JSON line, and as its last line ``{"ok": true,
"device": {...}}``. Any failed check raises and the script exits
non-zero; it also exits non-zero when no CUDA device is present, and
through its watchdog (``WATCHDOG_S``), with every thread's stack, when a
run passes 1100 s.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import os
import subprocess
import sys
import time

import numpy as np

# the whole script's limit is 1200 s: past WATCHDOG_S the run dumps every
# thread's stack and exits non-zero, so a cut run says where it was
WATCHDOG_S = 1100

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and bf16
# tensor-core FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

# tolerances of the kernel against its plain version (max abs error). bf16
# is ~2x the largest error this script measured on an H100 (3.9e-3, one
# bf16 ulp at |out| in [0.5, 1)); the kernel phase also checks that a
# plain version which skips p's rounding to bf16 before p@v lands outside it
ATOL_OUT = {"float32": 2e-5, "bfloat16": 8e-3}
ATOL_LSE = 1e-4   # f32 sums over up to 1024 keys in another order
# B2/B3 (dq, dk, dv) against the plain backward, max abs error. f32: the
# kernels sum delta and the products over up to 1024 keys or queries in
# another order (largest error measured on an H100: 1.1e-6, so ~4x).
# bf16: ~2x the largest error of the FMA kernels (1.95e-3, one bf16 ulp at
# |dk| in [0.25, 0.5)); the wgmma dK/dV kernel reaches 3.9e-3 (one ulp in
# [0.5, 1)). dk and dv reach |x| > 5, where one ulp is 3.1e-2: an f32 sum
# grouped otherwise than the plain version's moves them by an ulp, so the
# kernels and flash_backward_plain sum them per 64-row q tile alike. The
# kernel phase also checks that a plain backward which skips ds's and p's
# rounding to bf16 lands outside the limit in dq, dk and dv
ATOL_BWD = {"float32": 4e-6, "bfloat16": 4e-3}
# attn="flash" vs attn="local" on the bf16 model: p is rounded to bf16 at
# another point (running vs final max) and the error passes 8 layers;
# 0.25 is 8 bf16 ulps at the logits' magnitude (|logits| in [4, 8))
ATOL_LOGITS = 0.25
ATOL_LOSS = 1e-2
# one step's gradients, attn="flash" vs attn="local" on the bf16 model:
# ||g_flash - g_local|| / ||g_local|| over each parameter leaf. p is rounded
# to bf16 at other points (against the lse vs the softmax output) and the
# difference passes 8 layers; ~2.5x the largest measured (7.7e-3, embed)
RTOL_GRAD = 2e-2

# the "472M" LM of bench.py (vocab 32768, dim 2048, 16 heads, seq 1024)
LM = dict(vocab_size=32768, dim=2048, num_heads=16, max_seq=1024)
LAYERS = 8
BATCH = 2
BATCHES = 4        # request batches scored on the main path
TRAIN_STEPS = 6    # SGD steps on the training path, as bench.py's step
SYNC_EVERY = 3     # a delta-sync through the PS after every 3rd step
LR = 1e-2
# the ps phase's table checks: a table of 16M f32 (the updater timings'
# size), PS_ADDS pipelined adds (the coalescing queue's depth, _ADDQ_CAP)
# and PS_WIRE_ADDS adds through each wire filter
PS_TABLE = 16 * 2**20
PS_ADDS = 16
PS_WIRE_ADDS = 4   # cut from 8 to keep the script in its time
# the train phase's torch.optim step: AdamW with every hyperparameter
# explicit (optax and torch.optim default differently). Adam's first
# update moves every weight by ~lr in the sign of its gradient, a coherent
# step that raises the next loss; at lr 5e-4 the loss rose for two steps
# before it fell, so lr is 5e-5: the update is still more than half a bf16
# ulp for weights of |x| < 2^-6 (most of the embedding and the matrices),
# so most weights move. The first step's parameters are held to the plain
# AdamW update computed in f32 from the same bf16 parameters and
# gradients: within one bf16 ulp of the parameter (torch rounds the result
# to bf16) plus OPTIM_UPDATE_RTOL of lr (torch's AdamW keeps m, v and the
# denominator in bf16, ~2^-9 relative per rounding, a few roundings)
OPTIM = dict(lr=5e-5, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1)
OPTIM_TIMED_STEPS = 3
OPTIM_UPDATE_RTOL = 0.02


def log(msg: str) -> None:
    print(msg, flush=True)


def walled(fn):
    """Logs the wall seconds of each call of ``fn`` as it returns or
    raises, with its label when its first argument is one."""
    import functools

    @functools.wraps(fn)
    def inner(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            label = f" {args[0]}" if args and isinstance(args[0], str) else ""
            log(f"part {fn.__name__}{label}: "
                f"{time.perf_counter() - t0:.1f} s")
    return inner


class Laps:
    """Logs the wall seconds of each sub-part of a phase as it ends (the
    time since the previous lap, or since the Laps was made), so a run
    cut by any clock still shows where its time went."""

    def __init__(self, phase: str):
        self.phase = phase
        self.t = time.perf_counter()

    def __call__(self, label: str) -> None:
        now = time.perf_counter()
        log(f"part {self.phase}/{label}: {now - self.t:.1f} s")
        self.t = now


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (warm
    L2: the inputs stay in the 50 MB cache)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(kernel, library, rounds: int = 3) -> tuple:
    """(kernel ms, library ms): the medians of warm ``cuda_ms`` runs taken
    in turns, kernel, library, library, kernel, over ``rounds`` rounds, so
    a drift of the card's clocks falls on both alike."""
    ks, ls = [], []
    for _ in range(rounds):
        ks.append(cuda_ms(kernel))
        ls.append(cuda_ms(library))
        ls.append(cuda_ms(library))
        ks.append(cuda_ms(kernel))
    return float(np.median(ks)), float(np.median(ls))


def cold_ms(fn, iters: int = 10) -> float:
    """Median device time of one call of ``fn`` with a cold L2: a 64 MB
    write before each launch evicts the 50 MB cache, and each launch is
    timed by its own pair of events."""
    import torch
    flush = torch.empty(16 * 2**20, dtype=torch.float32, device="cuda")
    fn()
    times = []
    for _ in range(iters):
        flush.fill_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# the kernels that must run on the tensor cores and be fed by TMA, by the
# name of their (mangled) function in the SASS
TENSOR_CORE_KERNELS = ("flash_fwd_wgmma", "flash_bwd_dq_wgmma",
                       "flash_bwd_dkv_wgmma")


def sass_counts(lib) -> dict:
    """{function: (HGMMA, UTMALDG)}: the wgmma and TMA-load instructions
    of each kernel in a built library, from ``cuobjdump -sass``."""
    import os
    from multiverso_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = [0, 0]
        elif fn is not None:
            counts[fn][0] += "HGMMA" in line
            counts[fn][1] += "UTMALDG" in line
    return {f: tuple(c) for f, c in counts.items()}


def spills(text: str) -> dict:
    """{function: spill store + load bytes} from ptxas's ``-v`` report."""
    out, fn = {}, None
    for line in text.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for", 1)[1].strip()
        elif fn is not None and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            out[fn] = sum(nums[1:3])   # stack frame, spill stores, loads
            fn = None
    return out


def phase_build() -> None:
    """Build every kernel, print ptxas's registers and spills, and check in
    the SASS that the bf16 B1, B2 and B3 kernels use wgmma and TMA, and in
    ptxas's report that they do not spill."""
    from multiverso_tpu_torch.ops import _build
    t0 = time.perf_counter()
    results = _build.build_all()
    for name, (seconds, text) in results.items():
        log(f"build {name}: {seconds:.1f} s")
        for line in text.splitlines():
            if any(t in line for t in ("entry function", "registers",
                                         "spill")):
                log(f"  ptxas: {line.strip()}")
        for fn, nbytes in spills(text).items():
            if nbytes and any(k in fn for k in TENSOR_CORE_KERNELS):
                raise AssertionError(f"{fn} spills {nbytes} bytes")
    log(f"build total: {time.perf_counter() - t0:.1f} s")
    found = {k: 0 for k in TENSOR_CORE_KERNELS}
    for name in _build.KERNELS:
        for fn, (hgmma, utmaldg) in sass_counts(
                _build.library_path(name)).items():
            log(f"  sass {name}: {fn}: HGMMA {hgmma}, UTMALDG {utmaldg}")
            for k in TENSOR_CORE_KERNELS:
                if k in fn:
                    if not (hgmma and utmaldg):
                        raise AssertionError(f"{fn} has no HGMMA or no "
                                             f"UTMALDG instruction")
                    found[k] += 1
    if not all(found.values()):
        raise AssertionError(f"tensor-core kernels missing from the SASS: "
                             f"{found}")


SLICE_SHAPE = (BATCH, LM["num_heads"], LM["max_seq"],
               LM["dim"] // LM["num_heads"])
# the edge shapes each kernel is held at: S = 40 and S = 200 are not
# multiples of the kernels' tiles (64 rows; the bf16 B1 and B2 take 128 q
# rows, and 128 (B1) or 64 (B2) k rows; the bf16 B3 128 k rows and 64 q
# rows), (2,3,200,128) has several heads, so a tile read past the end of
# one head's S would take the next head's rows; (1,2,96,32) has several
# tiles at head dim 32, (2,4,1024,64) is head dim 64 at full S;
# (1,2,320,128) leaves B3 a last k tile of 64 rows (one consumer
# warpgroup's rows all past S) while 5 q tiles are live
EDGE_SHAPES = (((1, 4, 64, 64), 128), ((1, 4, 40, 64), 128),
               ((2, 3, 200, 128), 200), ((1, 2, 96, 32), 32),
               ((2, 4, 1024, 64), 128), ((1, 2, 320, 128), 64))


def phase_kernel(dev) -> list:
    """B1, B2 and B3 against their plain versions; returns their records,
    whose ``launches`` the request and train phases fill in."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, dtype, n):
        return [torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32).to(dtype) for _ in range(n)]

    return [kernel_fwd(randn)] + kernel_bwd(randn)


def bound(nbytes: int, flops: int) -> dict:
    """The least time for the work: bytes over the memory rate, operations
    over the bf16 tensor-core rate, whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def kernel_fwd(randn) -> dict:
    """B1 against its plain version, and its times."""
    import torch
    import torch.nn.functional as F
    from multiverso_tpu_torch.ops import attention_kernels as ak

    def qkv(shape, dtype):
        return randn(shape, dtype, 3)

    slice_shape = SLICE_SHAPE
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for causal in (True, False):
            for lse in (False, True):
                cases.append((slice_shape, dtype, causal, lse, 128))
        for shape, blk in EDGE_SHAPES:
            for causal in (True, False):
                cases.append((shape, dtype, causal, True, blk))
    slice_err = None
    for shape, dtype, causal, with_lse, blk in cases:
        q, k, v = qkv(shape, dtype)
        if with_lse:
            out, lse = ak.flash_attention_with_lse(q, k, v, causal, blk, blk)
        else:
            out, lse = ak.flash_attention(q, k, v, causal, blk, blk), None
        ref, ref_lse = ak.flash_forward_plain(q, k, v, causal, with_lse)
        torch.cuda.synchronize()
        name = str(dtype).replace("torch.", "")
        err = max_err(out, ref)
        lse_err = max_err(lse, ref_lse) if with_lse else 0.0
        log(f"kernel flash_fwd {tuple(shape)} {name} causal={causal} "
            f"lse={with_lse}: max_abs_err out {err:.3e} lse {lse_err:.3e}")
        if not (err <= ATOL_OUT[name] and lse_err <= ATOL_LSE):
            raise AssertionError(f"flash_fwd disagrees with its plain version "
                                 f"at {shape} {name} causal={causal}")
        if not torch.isfinite(out).all():
            raise AssertionError("flash_fwd produced non-finite values")
        if (shape, dtype, causal, with_lse) == (slice_shape, torch.bfloat16,
                                                True, False):
            slice_err = err
            # p@v with p left in f32: the slip the bf16 tolerance must catch
            slip = max_err(ak.flash_forward_plain(
                q.float(), k.float(), v.float(), causal, False)[0].to(dtype),
                ref)
            log(f"kernel flash_fwd {tuple(shape)} bf16: p unrounded before "
                f"p@v would err {slip:.3e} (tolerance {ATOL_OUT[name]:.0e})")
            if slip <= ATOL_OUT[name]:
                raise AssertionError("the bf16 tolerance does not tell p's "
                                     "rounding before p@v")
    q, k, v = qkv((1, 2, 96, 32), torch.bfloat16)
    try:
        ak.flash_attention(q, k, v, True, 64, 64)
    except ValueError as e:
        log(f"kernel flash_fwd ValueError contract holds: {e}")
    else:
        raise AssertionError("S=96 with 64-row blocks must raise ValueError")

    q, k, v = qkv(slice_shape, torch.bfloat16)

    def kernel():
        return ak._flash_forward_cuda(q, k, v, True, False)

    def library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    ms, library_ms = in_turns(kernel, library)
    ms_cold = cold_ms(kernel)
    plain_ms = cuda_ms(lambda: ak.flash_forward_plain(q, k, v, True, False),
                       iters=5)
    b, h, s, d = slice_shape
    nbytes = 4 * b * h * s * d * q.element_size()       # q, k, v read, o written
    flops = 4 * d * b * h * s * (s + 1) // 2             # unmasked pairs only
    lim = bound(nbytes, flops)
    log(f"kernel flash_fwd {slice_shape} bf16 causal: {ms:.4f} ms (median "
        f"in turns with sdpa; cold L2 {ms_cold:.4f} ms), plain "
        f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, kernel/sdpa "
        f"{ms / library_ms:.2f}, bound {lim['bound_ms']:.4f} ms ({nbytes} B, "
        f"{flops} FLOP)")
    return {
        "name": "flash_fwd", "route": "cuda",
        "source": "multiverso_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "multiverso_tpu/ops/attention_kernels.py:138",
        "design": {"bfloat16": "wgmma+tma", "float32": "fma"},
        "launches": None, "max_abs_err": slice_err, "ms": ms,
        "ms_cold_l2": ms_cold, "plain_ms": plain_ms, **lim,
        "library_ms": library_ms, "library_ratio": ms / library_ms,
    }


def kernel_bwd(randn) -> list:
    """B2 (dQ) and B3 (dK/dV) against the plain backward, on the forward
    kernel's out and lse, at the training path's shape and the edge
    shapes; then their times at the training path's shape."""
    import torch
    import torch.nn.functional as F
    from multiverso_tpu_torch.ops import attention_kernels as ak

    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for causal in (True, False):
            cases.append((SLICE_SHAPE, dtype, causal, 128))
        for shape, blk in EDGE_SHAPES:
            for causal in (True, False):
                cases.append((shape, dtype, causal, blk))
    slice_err = {}
    for shape, dtype, causal, blk in cases:
        q, k, v, do = randn(shape, dtype, 4)
        out, lse = ak.flash_attention_with_lse(q, k, v, causal, blk, blk)
        dq = ak._flash_bwd_dq_cuda(q, k, v, out, lse, do, causal)
        dk, dv = ak._flash_bwd_dkv_cuda(q, k, v, out, lse, do, causal)
        ref = ak.flash_backward_plain(q, k, v, out, lse, do, causal)
        torch.cuda.synchronize()
        name = str(dtype).replace("torch.", "")
        errs = [max_err(a, b) for a, b in zip((dq, dk, dv), ref)]
        mags = [float(t.float().abs().max()) for t in ref]
        log(f"kernel flash_bwd {tuple(shape)} {name} causal={causal}: "
            f"max_abs_err dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e}"
            f" (max |dq| {mags[0]:.3f} |dk| {mags[1]:.3f} |dv| "
            f"{mags[2]:.3f})")
        if not all(torch.isfinite(t).all() for t in (dq, dk, dv)):
            raise AssertionError("flash_bwd produced non-finite values")
        if max(errs) > ATOL_BWD[name]:
            raise AssertionError(f"flash_bwd disagrees with its plain version "
                                 f"at {shape} {name} causal={causal}")
        if (shape, dtype, causal) == (SLICE_SHAPE, torch.bfloat16, True):
            slice_err = {"flash_bwd_dq": errs[0],
                         "flash_bwd_dkv": max(errs[1:])}
            # the plain backward in f32, ds and p left unrounded before
            # ds@k, ds^T@q and p^T@dO: the roundings the kernels must keep
            slip = [max_err(a.to(dtype), b) for a, b in zip(
                ak.flash_backward_plain(q.float(), k.float(), v.float(),
                                        out.float(), lse, do.float(),
                                        causal), ref)]
            log(f"kernel flash_bwd {tuple(shape)} bf16: ds and p unrounded "
                f"would err dq {slip[0]:.3e}, dk {slip[1]:.3e}, dv "
                f"{slip[2]:.3e} (kernel {errs[0]:.3e}, {errs[1]:.3e}, "
                f"{errs[2]:.3e}; tolerance {ATOL_BWD[name]:.0e})")
            for what, err in zip(("ds's rounding before ds@k",
                                  "ds's rounding before ds^T@q",
                                  "p's rounding before p^T@dO"), slip):
                if err <= ATOL_BWD[name]:
                    raise AssertionError(f"the bf16 tolerance does not tell "
                                         f"{what}")

    q, k, v, do = randn(SLICE_SHAPE, torch.bfloat16, 4)
    out, lse = ak.flash_attention_with_lse(q, k, v, True)
    plain_ms = cuda_ms(lambda: ak.flash_backward_plain(q, k, v, out, lse, do,
                                                       True), iters=5)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    o = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)

    def library():
        return torch.autograd.grad(o, (qr, kr, vr), do, retain_graph=True)

    b, h, s, d = SLICE_SHAPE
    t = b * h * s * d * q.element_size()    # one [B*H, S, D] tensor
    lse_b = b * h * s * 4
    pairs = b * h * s * (s + 1) // 2         # unmasked pairs only
    recs = []
    for name, kernel, nbytes, flops, line, design in (
            ("flash_bwd_dq", lambda: ak._flash_bwd_dq_cuda(
                q, k, v, out, lse, do, True), 6 * t + lse_b, 6 * d * pairs,
             262, "wgmma+tma"),
            ("flash_bwd_dkv", lambda: ak._flash_bwd_dkv_cuda(
                q, k, v, out, lse, do, True), 7 * t + lse_b, 8 * d * pairs,
             280, "wgmma+tma")):
        ms, library_ms = in_turns(kernel, library)
        ms_cold = cold_ms(kernel)
        lim = bound(nbytes, flops)
        log(f"kernel {name} {SLICE_SHAPE} bf16 causal: {ms:.4f} ms (median "
            f"in turns with the sdpa backward; cold L2 {ms_cold:.4f} ms), "
            f"plain backward (dq, dk, dv) {plain_ms:.4f} ms, sdpa backward "
            f"(dq, dk, dv) {library_ms:.4f} ms, kernel/sdpa "
            f"{ms / library_ms:.2f}, bound {lim['bound_ms']:.4f} ms "
            f"({nbytes} B, {flops} FLOP, {lim['bound_by']})")
        recs.append({
            "name": name, "route": "cuda",
            "source": "multiverso_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"multiverso_tpu/ops/attention_kernels.py:{line}",
            "design": {"bfloat16": design, "float32": "fma"},
            "launches": None, "max_abs_err": slice_err[name], "ms": ms,
            "ms_cold_l2": ms_cold, "plain_ms": plain_ms, **lim,
            "library_ms": library_ms, "library_ratio": ms / library_ms,
        })
    return recs


def lm_config(layers: int):
    import torch
    from multiverso_tpu_torch.models import transformer as tfm
    return tfm.TransformerConfig(num_layers=layers, dtype=torch.bfloat16,
                                 attn="flash", **LM)


_LM_PARAMS = {}


def lm_init_params(layers: int) -> dict:
    """The 472M LM's ``init_params(seed=0)`` tree (numpy, ~11 s of draws),
    drawn once and shared by the phases that start from it (ps, decode,
    telemetry, mesh): the same arrays each time, never written to."""
    from multiverso_tpu_torch.models import transformer as tfm
    if layers not in _LM_PARAMS:
        tree = tfm.init_params(lm_config(layers), seed=0)
        for _, leaf in tfm.tp_lib.leaves(tree):
            leaf.flags.writeable = False
        _LM_PARAMS[layers] = tree
    return _LM_PARAMS[layers]


def phase_ps(dev, layers: int):
    """The LM's parameters through the PS; returns the SharedPytree."""
    import torch
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch import updaters
    from multiverso_tpu_torch.models import transformer as tfm
    from multiverso_tpu_torch.sharedvar import _flatten
    from multiverso_tpu_torch.utils import config

    lap = Laps("ps")
    refs = WireReference()   # numpy, on a thread, beside the LM's checks
    cfg = lm_config(layers)
    t0 = time.perf_counter()
    params = lm_init_params(layers)
    log(f"ps init_params (numpy, seed 0): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    shared = mv.SharedPytree(params, name="lm_params")
    torch.cuda.synchronize()
    n = shared.table.size
    log(f"ps SharedPytree: {n} f32 parameters in one ArrayTable on {dev} "
        f"({n * 4 / 2**30:.2f} GiB), {time.perf_counter() - t0:.1f} s")
    if shared.table.raw().device != dev:
        raise AssertionError(f"the table is on {shared.table.raw().device}")
    lap("init_params and SharedPytree")

    t0 = time.perf_counter()
    got = shared.get()
    log(f"ps get: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    if not np.array_equal(got["layers"]["wqkv"], params["layers"]["wqkv"]):
        raise AssertionError("Get does not return the initial parameters")

    rng = np.random.default_rng(1)
    local = got
    local["ln_f"] = local["ln_f"] + np.float32(0.5)
    local["layers"]["wo"][0] += rng.normal(0, 1e-3, local["layers"]["wo"][0]
                                           .shape).astype(np.float32)
    table = shared.table
    sync_ms = {}
    for prefetch in (True, False):
        # the first sync's add takes the write-triggered prefetch (the Get
        # of SharedPytree's start armed it), the second runs without it
        config.set_flag("table_get_prefetch", prefetch)
        local["ln_f"] = local["ln_f"] + np.float32(0.25)
        last = shared._last
        expected = last + (_flatten(local) - last)
        hits = dash_count("table[lm_params].get.prefetched")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        merged = shared.sync(local)
        sync_ms[prefetch] = (time.perf_counter() - t0) * 1e3
        took = dash_count("table[lm_params].get.prefetched") - hits
        if took != int(prefetch):
            raise AssertionError(f"sync with table_get_prefetch={prefetch}"
                                 f" took {took} prefetched snapshots")
        if not np.array_equal(shared._last, expected):
            raise AssertionError("sync: table disagrees with numpy")
        if not np.array_equal(merged["ln_f"],
                              expected_leaf(expected, merged)):
            raise AssertionError("sync: merged tree disagrees with numpy")
    config.set_flag("table_get_prefetch", True)
    log(f"ps sync (Add of the delta, then Get) with the write-triggered "
        f"prefetch {sync_ms[True]:.1f} ms, without it {sync_ms[False]:.1f} "
        f"ms; both match numpy bit for bit")
    # a second Get at an unchanged version is served by the get cache
    hits = dash_count("table[lm_params].get.cached")
    t0 = time.perf_counter()
    again = table.get()
    cached_ms = (time.perf_counter() - t0) * 1e3
    if (dash_count("table[lm_params].get.cached") != hits + 1
            or not np.array_equal(again, expected)):
        raise AssertionError("a Get at an unchanged version is not the "
                             "cached copy")
    t0 = time.perf_counter()
    fresh = table.raw()[:n].cpu().numpy()
    log(f"ps get at an unchanged version: {cached_ms:.1f} ms from the get "
        f"cache (.get.cached +1, equal bytes) against "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms for a copy off the card")
    if not np.array_equal(fresh, again):
        raise AssertionError("the get cache disagrees with the card")
    del params, local, merged, expected, last, again, fresh
    lap("syncs and cached get")

    size = 16 * 2**20
    opt = updaters.AddOption(momentum=0.9, learning_rate=0.1, rho=0.1)
    for name in ("default", "sgd", "momentum_sgd", "adagrad", "adam", "ftrl"):
        times = {}
        for where in ("cuda", "cpu"):
            d = dev if where == "cuda" else torch.device("cpu")
            upd = updaters.get_updater(name)
            data = torch.zeros(size + 1, device=d)
            state = upd.init_state((size + 1,), torch.float32, d)
            delta = torch.full((size + 1,), 1e-3, device=d)
            if where == "cuda":
                times[where] = cuda_ms(lambda: upd.apply(data, state, delta,
                                                         opt))
            else:
                t0 = time.perf_counter()
                for _ in range(3):
                    upd.apply(data, state, delta, opt)
                times[where] = (time.perf_counter() - t0) / 3 * 1e3
        table = mv.ArrayTable(size, updater=name, name=f"bench_{name}")
        delta = torch.full(table.padded_shape, 1e-3, device=dev)
        table.add(delta, opt)
        t0 = time.perf_counter()
        for _ in range(10):
            table.add(delta, opt)
        add_ms = (time.perf_counter() - t0) / 10 * 1e3
        log(f"ps updater {name} on {size} f32: apply {times['cuda']:.4f} ms "
            f"on the card, {times['cpu']:.2f} ms on the CPU; table.add "
            f"(device delta, blocking) {add_ms:.4f} ms")
        del table
    lap("updaters")
    ps_coalesce()
    lap("coalesce")
    ps_store_load()
    lap("store/load")
    ps_wire(refs)
    lap("wire filters")
    return shared


def dash_count(name: str) -> int:
    """A Dashboard monitor's count (0 before its first event)."""
    from multiverso_tpu_torch.utils.dashboard import Dashboard
    snap = Dashboard.snapshot()
    return snap[name].count if name in snap else 0


def counted_applies(table) -> list:
    """Count the calls of ``table``'s updater (one per applied add)."""
    calls, real = [], table.updater.apply

    def apply(*args):
        calls.append(1)
        return real(*args)

    table.updater.apply = apply
    return calls


def ps_coalesce() -> None:
    """PS_ADDS pipelined numpy add_async on a PS_TABLE-element table, under
    the default and the sgd updater, queued while the test holds the
    dispatch lock (so the applier takes them as one batch): ONE apply,
    and the table equals numpy's float64 sum, cast to f32 and added, bit
    for bit. Beside it PS_ADDS blocking adds, equal to numpy's f32 adds
    in order."""
    import torch
    import multiverso_tpu_torch as mv

    rng = np.random.default_rng(21)
    deltas = [rng.standard_normal(PS_TABLE, dtype=np.float32)
              for _ in range(PS_ADDS)]
    acc = np.zeros(PS_TABLE, np.float64)
    for d in deltas:
        acc += d
    merged = acc.astype(np.float32)
    del acc
    for name, sign in (("default", 1), ("sgd", -1)):
        t = mv.ArrayTable(PS_TABLE, updater=name, name=f"coalesce_{name}")
        applies = counted_applies(t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with t._dispatch_lock:
            mids = [t.add_async(d) for d in deltas]
        for m in mids:
            t.wait(m)
        piped_ms = (time.perf_counter() - t0) * 1e3
        want = np.zeros(PS_TABLE, np.float32) + np.float32(sign) * merged
        if len(applies) != 1 or not np.array_equal(t.get(), want):
            raise AssertionError(f"{name}: {PS_ADDS} queued adds made "
                                 f"{len(applies)} applies, or disagree "
                                 f"with numpy's float64 sum")
        del t
        t = mv.ArrayTable(PS_TABLE, updater=name, name=f"blocking_{name}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for d in deltas:
            t.add(d)
        block_ms = (time.perf_counter() - t0) * 1e3
        want = np.zeros(PS_TABLE, np.float32)
        for d in deltas:
            want = want + d if sign > 0 else want - d
        if not np.array_equal(t.get(), want):
            raise AssertionError(f"{name}: blocking adds disagree with "
                                 f"numpy")
        del t
        log(f"ps coalescing {name}, {PS_ADDS} numpy adds of {PS_TABLE} f32: "
            f"queued then merged into one apply {piped_ms:.1f} ms "
            f"({piped_ms / PS_ADDS:.2f} ms per add), equal to numpy's "
            f"float64 sum cast and added bit for bit; {PS_ADDS} blocking "
            f"adds {block_ms:.1f} ms ({block_ms / PS_ADDS:.2f} ms per add), "
            f"equal to numpy's f32 adds")


def ps_store_load() -> None:
    """store/load of an adam table of PS_TABLE elements round-trips bit for
    bit: data and each updater-state leaf."""
    import io

    import torch
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch import updaters

    opt = updaters.AddOption(learning_rate=0.1)
    src = mv.ArrayTable(PS_TABLE, updater="adam", name="ckpt_src")
    gen = torch.Generator(device=src.device).manual_seed(3)
    for _ in range(2):
        src.add(torch.randn(src.padded_shape, generator=gen,
                            device=src.device), opt)
    buf = io.BytesIO()
    t0 = time.perf_counter()
    src.store(buf)
    store_ms = (time.perf_counter() - t0) * 1e3
    dst = mv.ArrayTable(PS_TABLE, updater="adam", name="ckpt_dst")
    buf.seek(0)
    t0 = time.perf_counter()
    dst.load(buf)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    a, b = src.state, dst.state
    same = torch.equal(a["data"], b["data"]) and all(
        torch.equal(a["ustate"][k], b["ustate"][k]) for k in a["ustate"])
    log(f"ps store/load of an adam table of {PS_TABLE} f32 "
        f"({len(buf.getvalue()) / 2**20:.0f} MiB, leaves "
        f"{sorted(a['ustate'])}): store {store_ms:.1f} ms, load "
        f"{load_ms:.1f} ms, round trip bit for bit {same}")
    if not same:
        raise AssertionError("store/load does not round-trip")


def bf16_round(x: np.ndarray) -> np.ndarray:
    """f32 -> the nearest bf16 (ties to even), as f32: numpy's stand-in
    for a bf16 cast (finite inputs)."""
    u = x.view(np.uint32)
    r = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return r.view(np.float32)


class WireReference:
    """The wire-filter checks' deltas (PS_WIRE_ADDS of PS_TABLE elements)
    and the tables that the port's numpy ``utils/filters.py`` gives for
    them, applied in order from zeros with error feedback, computed on a
    thread (numpy's sort and adds leave the GIL) while the phase goes on."""

    def __init__(self):
        import threading
        rng = np.random.default_rng(22)
        self.deltas = [rng.standard_normal(PS_TABLE, dtype=np.float32)
                       * np.float32(1e-2) for _ in range(PS_WIRE_ADDS)]
        self.tables, self.first = {}, {}
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        from multiverso_tpu_torch.utils import filters
        n = PS_TABLE
        onebit = filters.OneBitsFilter(block=1024)
        topk = filters.TopKFilter(filters.default_topk(n))
        ref = {w: np.zeros(n, np.float32) for w in ("bf16", "1bit", "topk")}
        for i, d in enumerate(self.deltas):
            ref["bf16"] = ref["bf16"] + bf16_round(d)
            _, bits, scales = onebit.filter_in(d)
            ref["1bit"] = ref["1bit"] + filters.onebit_decode_np(
                bits, scales, n)
            _, idx, vals = topk.filter_in(d)
            ref["topk"] = ref["topk"] + filters.topk_decode_np(idx, vals, n)
            if i == 0:
                self.first = {"1bit": (bits, scales, onebit._residual.copy()),
                              "topk": (idx, vals, topk._residual.copy())}
        self.tables = ref

    def result(self):
        self._thread.join()
        if not self.tables:
            raise AssertionError("the numpy wire reference failed")
        return self.tables, self.first


def ps_wire(refs: WireReference) -> None:
    """wire_filter bf16, 1bit and topk on a PS_TABLE-element table:
    PS_WIRE_ADDS blocking adds of numpy deltas with error feedback (host
    encode, payload to the card, decode there); the table equals the numpy
    filters' reference applied in order, bit for bit, and Get reads it
    rounded to bf16. The codec on the card is held to the numpy filter on
    the first delta too (bits, scales, residual). Prints the encode ms on
    the host and on the card, the wire bytes per add against f32's, and
    the add's ms against a plain one."""
    import torch
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.ops import wire_codec as wc

    n = PS_TABLE
    dev = mv.device()
    plain = mv.ArrayTable(n, name="wire_none")
    add_ms = {}
    tables = {}
    for wire in ("none", "bf16", "1bit", "topk"):
        t = plain if wire == "none" else mv.ArrayTable(
            n, name=f"wire_{wire}", wire_filter=wire)
        times = []
        for d in refs.deltas:
            t0 = time.perf_counter()
            t.add(d)
            times.append((time.perf_counter() - t0) * 1e3)
        add_ms[wire] = float(np.median(times))
        tables[wire] = (t.raw()[:n].cpu().numpy(), t.get())
        del t
    del plain
    ref, first = refs.result()
    x = torch.from_numpy(refs.deltas[0])
    zero = torch.zeros(n)
    nbytes = {"none": 4 * n, "bf16": 2 * n,
              "1bit": wc.onebit_compressed_nbytes(n),
              "topk": wc.topk_compressed_nbytes(wc.default_topk(n))}
    for wire in ("bf16", "1bit", "topk"):
        raw, got = tables[wire]
        if not np.array_equal(raw, ref[wire]):
            raise AssertionError(f"wire_filter={wire}: the table disagrees "
                                 f"with the numpy filters")
        if not np.array_equal(got, bf16_round(raw)):
            raise AssertionError(f"wire_filter={wire}: Get is not the table "
                                 f"rounded to bf16")
        enc = {"bf16": lambda v, r: wc.bf16_cast(v),
               "1bit": lambda v, r: wc.onebit_encode(v, r),
               "topk": lambda v, r: wc.topk_encode(v, r,
                                                   wc.default_topk(n))}[wire]
        t0 = time.perf_counter()
        enc(x, zero)
        host_ms = (time.perf_counter() - t0) * 1e3
        xd, zd = x.to(dev), zero.to(dev)
        enc(xd, zd)
        card_ms = cuda_ms(lambda: enc(xd, zd), iters=5, warmup=1)
        if wire != "bf16":
            out = [o.cpu().numpy() for o in enc(xd, zd)]
            if not all(np.array_equal(a, b)
                       for a, b in zip(out, first[wire])):
                raise AssertionError(f"the {wire} codec on the card "
                                     f"disagrees with the numpy filter")
        log(f"ps wire_filter={wire} on {n} f32, {PS_WIRE_ADDS} adds with "
            f"error feedback: table equal to the numpy filters bit for "
            f"bit, Get bf16; encode {host_ms:.1f} ms on the host "
            f"({card_ms:.3f} ms on the card"
            + (", bits/scales/residual or idx/vals/residual equal to numpy"
               if wire != "bf16" else "")
            + f"); {nbytes[wire]} wire bytes per add "
            f"({4 * n / nbytes[wire]:.1f}x fewer than f32); blocking add p50 "
            f"{add_ms[wire]:.1f} ms against {add_ms['none']:.1f} ms "
            f"unfiltered")


def expected_leaf(flat: np.ndarray, tree: dict) -> np.ndarray:
    """``ln_f`` out of a flat vector in sorted-key order (embed, layers,
    ln_f, pos)."""
    off = tree["embed"].size + sum(a.size for a in tree["layers"].values())
    return flat[off: off + tree["ln_f"].size]


def phase_request(dev, shared, layers: int, batches: int) -> int:
    """Score request batches with attn="flash" under inference_mode;
    returns flash_fwd launches."""
    import torch
    from multiverso_tpu_torch.models import transformer as tfm
    from multiverso_tpu_torch.ops import attention_kernels as ak

    cfg = lm_config(layers)
    t0 = time.perf_counter()
    model = tfm.params_from_jax(shared.get(), cfg, dev)
    torch.cuda.synchronize()
    log(f"request model from the table's Get: "
        f"{sum(p.numel() for p in model.parameters())} parameters, bf16, "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batches, BATCH, cfg.max_seq + 1))).to(dev)
    with torch.inference_mode():
        # warm-up request (cuBLAS handles, allocator) outside the counted run
        float(tfm._nll(tfm.forward(model, toks[0, :, :-1]), toks[0, :, 1:]))

        ak.reset_launch_counts()
        lat, losses, first_logits, events = [], [], None, []
        t_run = time.perf_counter()
        for i in range(batches):
            t0 = time.perf_counter()
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            logits = tfm.forward(model, toks[i, :, :-1])
            loss = tfm._nll(logits, toks[i, :, 1:])
            ev[1].record()
            losses.append(float(loss))   # host readback = end of the request
            lat.append((time.perf_counter() - t0) * 1e3)
            events.append(ev)
            if i == 0:
                first_logits = logits
        run_s = time.perf_counter() - t_run
        counts = ak.launch_counts()
        launches = counts["flash_fwd"]
        if counts != {"flash_fwd": layers * batches, "flash_bwd_dq": 0,
                      "flash_bwd_dkv": 0}:
            raise AssertionError(f"request launches {counts}, expected "
                                 f"{layers * batches} flash_fwd only")
        tokens = batches * BATCH * cfg.max_seq
        log(f"request scored {batches} batches [{BATCH}, {cfg.max_seq}]: "
            f"losses {[round(l, 5) for l in losses]}, latency ms "
            f"{[round(t, 3) for t in lat]}, p50 {float(np.median(lat)):.3f} "
            f"ms; device span ms (CUDA events) "
            f"{[round(a.elapsed_time(b), 3) for a, b in events]}; {tokens} "
            f"tokens in {run_s * 1e3:.3f} ms = {tokens / run_s:.0f} tokens/s;"
            f" flash_fwd launches {launches}")
        if not (torch.isfinite(first_logits).all()
                and np.isfinite(losses).all()):
            raise AssertionError("non-finite logits or loss")
        if first_logits.shape != (BATCH, cfg.max_seq, cfg.vocab_size):
            raise AssertionError(f"logits shape {tuple(first_logits.shape)}")

        ref_logits = tfm.forward(model, toks[0, :, :-1],
                                 cfg._replace(attn="local"))
        ref_loss = float(tfm._nll(ref_logits, toks[0, :, 1:]))
        d_logits = max_err(first_logits, ref_logits)
        d_loss = abs(losses[0] - ref_loss)
        log(f"request flash vs local: max |logits diff| {d_logits:.4e} "
            f"(logits max |x| {float(ref_logits.float().abs().max()):.3f}), "
            f"|loss diff| {d_loss:.4e} (local loss {ref_loss:.5f})")
        if not (d_logits <= ATOL_LOGITS and d_loss <= ATOL_LOSS):
            raise AssertionError("attn='flash' disagrees with attn='local'")
        tok, tgt = toks[0, :, :-1], toks[0, :, 1:]
        profile("request", lambda: float(tfm._nll(tfm.forward(model, tok),
                                                    tgt)))
    return launches


class CheckedSync:
    """A SharedPytree whose ``sync`` is timed and checked: after each sync
    the table (its Get, which ``sync`` keeps as ``_last``) must equal the
    numpy ``last + (current - last)`` bit for bit."""

    def __init__(self, shared):
        self.shared = shared
        self.ms = []

    def sync(self, params):
        import torch
        from multiverso_tpu_torch.sharedvar import _flatten
        last = self.shared._last
        expected = last + (_flatten(params) - last)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        merged = self.shared.sync(params)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(self.shared._last, expected):
            raise AssertionError("train sync: table disagrees with numpy")
        return merged


def phase_train(dev, shared, layers: int) -> dict:
    """Train the full-width LM through the PS with ``train_ps``; returns
    the launch counts of the counted run."""
    import torch
    from multiverso_tpu_torch.examples.transformer_ps import train_ps
    from multiverso_tpu_torch.models import transformer as tfm
    from multiverso_tpu_torch.ops import attention_kernels as ak

    cfg = lm_config(layers)
    t0 = time.perf_counter()
    model = tfm.params_from_jax(shared.get(), cfg, dev)
    torch.cuda.synchronize()
    log(f"train model from the table's Get: "
        f"{sum(p.numel() for p in model.parameters())} parameters, bf16, "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (BATCH, cfg.max_seq + 1))).to(dev)
    tok, tgt = toks[:, :-1], toks[:, 1:]

    sgd = tfm.make_train_step(cfg, LR)
    host_ms, spans = [], []

    def timed_step(model, tok, tgt):
        t0 = time.perf_counter()
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        loss = sgd(model, tok, tgt)
        ev[1].record()
        float(loss)   # host readback = end of the step
        host_ms.append((time.perf_counter() - t0) * 1e3)
        spans.append(ev)
        return loss

    # warm-up step (cuBLAS handles, allocator) outside the counted run
    float(sgd(model, tok, tgt))
    checked = CheckedSync(shared)
    ak.reset_launch_counts()
    t_run = time.perf_counter()
    losses = train_ps(model, checked, tok, tgt, TRAIN_STEPS, SYNC_EVERY, LR,
                      step_fn=timed_step)
    run_s = time.perf_counter() - t_run
    counts = ak.launch_counts()
    want = layers * TRAIN_STEPS
    if counts != {"flash_fwd": want, "flash_bwd_dq": want,
                  "flash_bwd_dkv": want}:
        raise AssertionError(f"train launches {counts}, expected {want} of "
                             f"each kernel")
    dev_ms = [a.elapsed_time(b) for a, b in spans]
    tokens = TRAIN_STEPS * BATCH * cfg.max_seq
    log(f"train {TRAIN_STEPS} SGD steps (lr {LR}) on one batch [{BATCH}, "
        f"{cfg.max_seq}], sync every {SYNC_EVERY}: losses "
        f"{[round(l, 5) for l in losses]}")
    log(f"train step ms (host, to the loss readback) "
        f"{[round(t, 3) for t in host_ms]}, p50 "
        f"{float(np.median(host_ms)):.3f}; device span ms (CUDA events) "
        f"{[round(t, 3) for t in dev_ms]}, p50 {float(np.median(dev_ms)):.3f}"
        f"; {tokens} tokens in {sum(host_ms):.3f} ms of steps = "
        f"{tokens / sum(host_ms) * 1e3:.0f} tokens/s, in {run_s * 1e3:.3f} "
        f"ms with the syncs = {tokens / run_s:.0f} tokens/s; sync ms "
        f"{[round(t, 3) for t in checked.ms]}; launches {counts}")
    log(f"train syncs match numpy bit for bit ({len(checked.ms)} syncs)")
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite train loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")

    # one step's gradients, attn="flash" against attn="local"
    params = list(model.parameters())
    grads = {}
    for attn in ("flash", "local"):
        loss = tfm.loss_fn(model, tok, tgt, cfg=cfg._replace(attn=attn))
        grads[attn] = torch.autograd.grad(loss, params)
    rel = {}
    for (name, _), gf, gl in zip(model.named_parameters(), grads["flash"],
                                 grads["local"]):
        rel[name] = float((gf.float() - gl.float()).norm()
                          / gl.float().norm())
    del grads
    log("train grads flash vs local, ||g_flash - g_local|| / ||g_local||: "
        + ", ".join(f"{n} {r:.3e}" for n, r in rel.items()))
    if not max(rel.values()) <= RTOL_GRAD:
        raise AssertionError("attn='flash' gradients disagree with "
                             "attn='local'")
    profile("train step", lambda: float(sgd(model, tok, tgt)))
    optim = train_optim(model, tok, tgt, cfg, layers)
    return {k: counts[k] + optim[k] for k in counts}


def train_optim(model, tok, tgt, cfg, layers: int) -> dict:
    """The torch.optim step (``make_optim_train_step``) with AdamW and
    explicit hyperparameters (OPTIM) on the full-width LM, attn="flash":
    one warm step, whose parameters are held to an AdamW update written
    out in plain tensor ops from the same parameters and gradients, then
    OPTIM_TIMED_STEPS timed steps. The loss must fall. Returns the launch
    counts of the steps (counted from 0 just before them)."""
    import torch
    from multiverso_tpu_torch.models import transformer as tfm
    from multiverso_tpu_torch.ops import attention_kernels as ak

    params = list(model.parameters())
    opt = torch.optim.AdamW(params, **OPTIM)
    step = tfm.make_optim_train_step(cfg, opt)
    seen = {}
    real_step = opt.step

    def first_step(*args, **kw):
        if not seen:   # the parameters and gradients the update starts from
            seen["p"] = [p.detach().clone() for p in params]
            seen["g"] = [p.grad.detach().clone() for p in params]
        return real_step(*args, **kw)

    opt.step = first_step
    torch.cuda.synchronize()
    ak.reset_launch_counts()
    t0 = time.perf_counter()
    losses = [float(step(model, tok, tgt))]
    warm_ms = (time.perf_counter() - t0) * 1e3
    lr, (b1, b2) = OPTIM["lr"], OPTIM["betas"]
    eps, wd = OPTIM["eps"], OPTIM["weight_decay"]
    worst, moved, expect, total = 0.0, 0, 0, 0
    for p0, g, p1 in zip(seen["p"], seen["g"], params):
        g = g.float()
        m_hat = (1 - b1) * g / (1 - b1)
        v_hat = (1 - b2) * g * g / (1 - b2)
        want = p0.float() * (1 - lr * wd) - lr * m_hat / (v_hat.sqrt() + eps)
        got = p1.detach().float()
        mag = torch.maximum(want.abs(), got.abs())
        ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
        worst = max(worst, float(((got - want).abs()
                                  / (ulp + OPTIM_UPDATE_RTOL * lr)).max()))
        moved += int((p1.detach() != p0).sum())
        expect += int((want.to(p0.dtype) != p0).sum())
        total += p0.numel()
    opt.step = real_step
    seen.clear()
    torch.cuda.reset_peak_memory_stats()   # the timed steps' peak alone
    log(f"train torch.optim AdamW {OPTIM}: first step against the plain "
        f"AdamW update, max |diff| / (1 bf16 ulp + {OPTIM_UPDATE_RTOL} lr) "
        f"= {worst:.3f} (bound 1); {moved / total:.3f} of the {total} "
        f"parameters moved, {expect / total:.3f} by the plain update")
    if not (worst <= 1.0 and expect > 0 and moved >= 0.9 * expect):
        raise AssertionError("the AdamW step disagrees with the plain "
                             "update")
    ms, spans = [], []
    for _ in range(OPTIM_TIMED_STEPS):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        ev[0].record()
        loss = step(model, tok, tgt)
        ev[1].record()
        losses.append(float(loss))
        ms.append((time.perf_counter() - t0) * 1e3)
        spans.append(ev[0].elapsed_time(ev[1]))
    counts = ak.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want_n = layers * (1 + OPTIM_TIMED_STEPS)
    log(f"train torch.optim AdamW steps: losses (warm first) "
        f"{[round(l, 5) for l in losses]}; warm step {warm_ms:.3f} ms, "
        f"timed step ms (host, to the loss readback) "
        f"{[round(t, 3) for t in ms]}, device span ms "
        f"{[round(t, 3) for t in spans]}; peak memory of the timed steps "
        f"{peak:.2f} GiB (model, AdamW state, gradients, activations); "
        f"launches {counts}")
    if counts != {k: want_n for k in counts}:
        raise AssertionError(f"torch.optim steps launched {counts}, "
                             f"expected {want_n} of each kernel")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"the AdamW loss did not fall: {losses}")
    return counts


# WordEmbedding (the we phase): the repo's two configurations of the fused
# skip-gram path with a shared negative pool. Real text: bench.py:220-221
# (size 128, batch 16384, 5 negatives, window 5, a pool of 256, min_count
# 5, sample 1e-4 by default) on data/realtext.txt.gz. Synthetic:
# bench.py:114-121 (400k zipf tokens, vocab 10,000, seed 7, the same
# widths, epoch 1)
WE_CFG = dict(size=128, min_count=5, batch_size=16384, negative=5, window=5,
              shared_negatives=256)
WE_SYNTH_CORPUS = dict(num_tokens=400_000, vocab=10_000, seed=7)
# the other four branches of train_fused, each on the real text at the same
# widths (WE_CFG; CBOW and HS leave the pool size unread): per-pair
# negatives from jax.random's threefry stream, hierarchical softmax (HS),
# CBOW with per-pair negatives, CBOW with HS. All four compute in f32
WE_VARIANTS = (("skipgram per-pair", dict(shared_negatives=0)),
               ("skipgram HS", dict(hs=1)),
               ("CBOW NS", dict(cbow=1)),
               ("CBOW HS", dict(cbow=1, hs=1)))
# at batch 16384 the HS epochs diverge, in the JAX package as in the port:
# each batch adds every path's update into the Huffman root and its
# children at lr 0.025 (on the CPU the loss passes 1e6 within 16 batches
# and is inf by batch 31, tests/test_torch_word2vec.py). So an HS branch is
# timed there without a check on its loss, and trained at the largest
# power of two below it at which the loss falls in each of its four epochs,
# found by halving down to WE_HS_MIN_BATCH (we_hs_sweep). On the CPU, in
# both packages, that is 512 for CBOW HS, where 1024 rises in its third
# epoch (tests/test_torch_we_bench_width.py)
WE_HS_MIN_BATCH = 128
WE_TIMED_EPOCHS = 1   # cut from 3 to 1 to keep the script in its time
WE_PROBES = ("array", "matrix", "value", "data")   # bench.py:233
# a MatrixTable of text8's vocabulary at min_count 5 by 128 columns
TEXT8_VOCAB = 71_290
# bf16 against f32 from the same start, on the same pairs and negatives:
# the products round to bf16 (8 significant bits, a relative 2^-9 per
# rounding) and the tables take bf16-rounded deltas, so the mean loss moves
# by a fraction of a percent. At this width every batch adds hundreds to
# thousands of updates into the frequent rows, so any rounding difference
# grows about 1000x every 16 batches (in the JAX package as in the port):
# over a 222-batch epoch the bf16 and f32 tables end 11-15% apart, and two
# f32 runs of it, which differ only in the order of index_add_'s atomics,
# end up to 2.2e-2 apart in loss. So the loss is bounded over the first
# WE_REF_BATCHES batches (<= 16), where the card's f32 loss stays within
# 1.2e-7 of the CPU's and the atomics' order cannot reach the bound; the
# full epoch's bf16-vs-f32 difference is printed beside the f32-twice
# spread, and its bf16 loss need only be finite and below the warm epoch's
WE_BF16_LOSS_RTOL = 1e-2
# the card's f32 epoch against the CPU's on the same inputs (the first
# WE_REF_BATCHES batches, from the tables the timed epochs left): index_add_
# adds duplicate rows with atomics on the card, in an order that changes
# from run to run, and cuBLAS sums in another order than the CPU, so the
# tables differ from the CPU's by f32 rounding, amplified over the batches.
# WE_REF_BATCHES must stay at 16 or fewer (the amplification above). Shared
# pool: the loss to 1e-5 relative. The tables are held to the rounding
# noise of this epoch, measured in the same run: within
# WE_REF_F32_ERR_FACTOR times the larger of the CPU f32's own error (max
# |diff| from an f64 run of the epoch from the same start) and the card's
# run-to-run spread (its two f32 runs). A fixed bound of 2e-5 of max |x|
# failed a correct run: examples/we_f32_error.py over 60 starts on an
# H100 80GB HBM3 at 700 W gave card-vs-CPU up to 5.60e-5 of max |x|
# beside CPU f32 errors up to 8.94e-5 and card spreads up to 2.29e-5; the
# card-vs-CPU difference over the larger noise was at most 2.30 (median
# 0.52), and 2.36 in another 40 starts, so the factor 6. A wrong update
# moves rows by the update itself, O(1) of max |x|, far beyond the bound.
WE_REF_BATCHES = 8
WE_REF_LOSS_RTOL = 1e-5
WE_REF_F32_ERR_FACTOR = 6
# the other branches against the CPU: each loss sums 16,384 x 6 to 18
# terms a batch in another order than the CPU (the two packages differ by
# 2e-6 to 8e-6 relative on the CPU at this width), so 2e-5 (measured on an
# H100 80GB HBM3 at 700 W: <= 1.2e-7). The tables to 1e-4 of their
# largest magnitude: HS adds all 16,384 paths' updates into the Huffman
# root and its children with atomics, and the per-pair epoch runs from
# tables |x| ~5 (measured there: up to 1.2e-5, skip-gram per-pair; HS
# 2.5e-6 to 3.5e-6 from the fresh tables)
WE_VARIANT_LOSS_RTOL = 2e-5
WE_VARIANT_TABLE_RTOL = 1e-4
# the per-pair negatives drawn on the card against the CPU's, bit for bit,
# over the epoch's first batches (cut from the whole epoch's 222 to keep
# the script in its time: the CPU's draw of 18M ids took ~6 s)
WE_NEG_BATCHES = 32

# the PS block path (the we_ps phase): bench_wordembedding_ps's
# configuration, bench.py:158-159 (size 128, batch 8,192, 5 negatives,
# window 5, blocks of 50,000 tokens, use_ps 1, an f32 scan), on the real
# text (13 blocks an epoch) and on the bench's 1M-token synthetic corpus
# (bench.py:178, vocab 5,000, seed 12)
WE_PS_CFG = dict(size=128, min_count=5, batch_size=8192, negative=5,
                 window=5, data_block_size=50_000, use_ps=1)
WE_PS_SYNTH_CORPUS = dict(num_tokens=1_000_000, vocab=5_000, seed=12)
WE_PS_VARIANTS = (("skipgram NS", {}), ("CBOW NS", dict(cbow=1)),
                  ("skipgram HS", dict(hs=1)), ("CBOW HS", dict(cbow=1, hs=1)))
# the block path's HS diverges at 8,192 in both packages, and skip-gram HS
# at 4,096 too (its pairs come from 50,000 neighbouring tokens, so each
# minibatch piles more updates into the same Huffman nodes than the fused
# epoch's shuffled ones; tests/test_torch_ps_blocks.py): each HS variant
# is trained at the largest power of two below 8,192 at which its loss
# falls in every epoch, found by halving (we_ps_hs_sweep)
# the card against the CPU over the first 2 blocks (100,000 training
# tokens) from the same seeded tables: the block losses to 1e-4 relative,
# the tables to 1e-2 of their largest magnitude. Each minibatch adds
# thousands of updates into the frequent rows, so f32 rounding (atomics'
# order on the card, the GEMMs' sums) grows minibatch after minibatch: on
# the CPU the port and the JAX package end the 2 blocks 5.5e-5 of max |x|
# apart in skip-gram NS. A wrong update moves the tables by O(1)
WE_PS_REF_TOKENS = 100_000
WE_PS_REF_LOSS_RTOL = 1e-4
WE_PS_REF_TABLE_RTOL = 1e-2
# device plane against host plane (their first block, where the planes
# compute the same: the host plane's one-block staleness starts at its
# second) and pipelined against inline (2 blocks): within this many times
# the card's run-to-run spread of the same runs, plus 1e-6 of max |x|
WE_PS_SPREAD_FACTOR = 4
# the hot-row train cache on the host plane: rows per table, at least the
# real text's vocabulary at min_count 5 (8,106), so every row can be cached
WE_PS_CACHE_ROWS = 16_384


def we_group(name: str) -> str:
    """The WordEmbedding epoch's kernel groups, by kernel name."""
    low = name.lower()
    return ("scatter-add" if any(t in low for t in ("indexfunc", "index_add",
                                                    "scatter")) else
            "gather" if any(t in low for t in ("indexselect", "index_select",
                                               "gather", "index_elementwise"))
            else "matmul" if any(t in low for t in ("gemm", "gemv", "nvjet",
                                                    "cutlass", "sm90_xmma"))
            else "elementwise/reduce/copy")


def phase_we_table(dev) -> None:
    """MatrixTable row Add/Get with duplicate ids on a 71,290 x 128 table on
    the card, against numpy bit for bit: duplicates summed in float64 and
    cast, then one f32 add per touched element."""
    import torch
    import multiverso_tpu_torch as mv

    rng = np.random.default_rng(5)
    table = mv.MatrixTable(TEXT8_VOCAB, 128, name="we_text8", seed=3,
                           init_scale=0.5 / 128)
    if table.raw().device != dev:
        raise AssertionError(f"the table is on {table.raw().device}")
    ref = table.get()
    add_ms, get_ms = [], []
    for _ in range(3):
        # zipf ids: many duplicates among the frequent rows, as a batch of
        # word2vec rows has
        ids = (rng.zipf(1.2, 16384) - 1) % TEXT8_VOCAB
        vals = rng.normal(0, 1e-2, (ids.size, 128)).astype(np.float32)
        acc = np.zeros((TEXT8_VOCAB, 128), np.float64)
        np.add.at(acc, ids, vals.astype(np.float64))
        touched = np.unique(ids)
        ref[touched] = ref[touched] + acc[touched].astype(np.float32)
        t0 = time.perf_counter()
        table.add_rows(ids, vals)
        torch.cuda.synchronize()
        add_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        rows = table.get_rows(ids)
        get_ms.append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(rows, ref[ids]):
            raise AssertionError("get_rows disagrees with numpy")
        if not np.array_equal(table.get(), ref):
            raise AssertionError("add_rows disagrees with numpy")
        log(f"we table {TEXT8_VOCAB}x128: add_rows of {ids.size} ids "
            f"({touched.size} distinct) {add_ms[-1]:.3f} ms, get_rows "
            f"{get_ms[-1]:.3f} ms (host, blocking)")
    for bad, err in (([TEXT8_VOCAB], IndexError), ([1.5], TypeError)):
        try:
            table.get_rows(bad)
        except err:
            pass
        else:
            raise AssertionError(f"get_rows({bad}) must raise {err.__name__}")
    log("we table add_rows/get_rows with duplicate ids match numpy bit for "
        "bit (3 rounds); out-of-range and float ids raise")
    we_table_cache(dev)


class train_cache:
    """Context: MatrixTables made inside it get a hot-row train cache of
    ``rows`` rows (flags train_cache_rows, train_cache_mode)."""

    def __init__(self, rows: int, mode: str = "auto"):
        self.rows, self.mode = rows, mode

    def __enter__(self):
        from multiverso_tpu_torch.utils import config
        config.set_flag("train_cache_rows", self.rows)
        config.set_flag("train_cache_mode", self.mode)

    def __exit__(self, *exc):
        from multiverso_tpu_torch.utils import config
        config.set_flag("train_cache_rows", 0)
        config.set_flag("train_cache_mode", "auto")
        return False


def cache_equals_table(table) -> int:
    """The train cache's host rows and its device block against the table's
    rows, bit for bit; returns the rows cached."""
    import torch
    tc = table._train_cache
    ids = tc.ids()
    _, rows = tc.serve_full(ids)
    dev = table.raw().index_select(0, torch.from_numpy(ids).to(table.device))
    bucket = 1 << max(int(ids.size) - 1, 0).bit_length()
    blk = table.train_cache_device_block(ids, bucket)
    if not (np.array_equal(rows, dev.cpu().numpy())
            and np.array_equal(rows, table.get()[ids])
            and blk is not None and torch.equal(blk[: ids.size], dev)):
        raise AssertionError(f"table[{table.name}]: the train cache "
                             f"disagrees with the table's rows")
    return int(ids.size)


def we_table_cache(dev) -> None:
    """The hot-row train cache on the 71,290 x 128 table, write-through
    (capacity: every row): after one get_rows of zipf ids fills it, a
    second get_rows of the same ids is a full hit, bit-equal to the card's
    rows (its ms beside the uncached get's); after zipf add_rows, the
    cached rows (host copy and device mirror) still equal the table's
    rows bit for bit."""
    import torch
    import multiverso_tpu_torch as mv

    rng = np.random.default_rng(6)
    with train_cache(TEXT8_VOCAB, "writethrough"):
        table = mv.MatrixTable(TEXT8_VOCAB, 128, name="we_text8_cache",
                               seed=3, init_scale=0.5 / 128)
    ids = (rng.zipf(1.2, 16384) - 1) % TEXT8_VOCAB
    uids = np.unique(ids)
    ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        rows = table.get_rows(ids)
        ms.append((time.perf_counter() - t0) * 1e3)
    stats = table.train_cache_stats()
    dev_rows = table.raw().index_select(
        0, torch.from_numpy(ids).to(dev)).cpu().numpy()
    log(f"we table train cache ({stats['mode']}, capacity {TEXT8_VOCAB}): "
        f"get_rows of {ids.size} zipf ids ({uids.size} distinct) "
        f"{ms[0]:.3f} ms uncached (fills the cache), {ms[1]:.3f} ms from "
        f"the cache; hits {stats['hits']}, misses {stats['misses']}")
    if not (stats["hits"] == stats["misses"] == uids.size
            and np.array_equal(rows, dev_rows)):
        raise AssertionError("the second get_rows is not a full hit equal "
                             "to the card's rows")
    for _ in range(3):
        ids = (rng.zipf(1.2, 16384) - 1) % TEXT8_VOCAB
        vals = rng.normal(0, 1e-2, (ids.size, 128)).astype(np.float32)
        table.add_rows(ids, vals)
        table.get_rows(ids)
    cached = cache_equals_table(table)
    log(f"we table train cache after 3 rounds of zipf add_rows: {cached} "
        f"cached rows, host copy and device block equal to the table's "
        f"rows bit for bit")


@walled
def we_run(label: str, we, ids, trains: bool = True) -> dict:
    """One warm epoch, then WE_TIMED_EPOCHS timed ones of ``train_fused``:
    words/s by the host's clock (train_fused ends with the loss readback)
    and the device span of each epoch by CUDA events. The losses must be
    finite and fall, unless ``trains`` is False (a configuration that
    diverges in both packages, timed all the same)."""
    import torch
    losses, wps, span_ms = [], [], []
    stats = we.train_fused(ids, epochs=1)    # warm: pairs to the card
    losses.append(stats["loss"])
    log(f"we {label} warm epoch: {stats['seconds'] * 1e3:.3f} ms with the "
        f"pair generation and upload, {stats['pairs']} pairs, loss "
        f"{stats['loss']:.6f}")
    for _ in range(WE_TIMED_EPOCHS):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        stats = we.train_fused(ids, epochs=1)
        ev[1].record()
        ev[1].synchronize()
        losses.append(stats["loss"])
        wps.append(stats["words_per_sec"])
        span_ms.append(ev[0].elapsed_time(ev[1]))
    host_ms = [ids.size / w * 1e3 for w in wps]
    log(f"we {label}: {ids.size} tokens, {stats['pairs']} pairs "
        f"({stats['pairs'] // we.cfg.batch_size} batches of "
        f"{we.cfg.batch_size}) an epoch; timed epochs host ms "
        f"{[round(t, 3) for t in host_ms]}, words/s "
        f"{[round(w) for w in wps]} (median {float(np.median(wps)):.0f}); "
        f"device span ms (CUDA events) {[round(t, 3) for t in span_ms]}; "
        f"loss per epoch (warm first) {[round(l, 6) for l in losses]}")
    if not trains:
        return {"losses": losses, "words_per_sec": wps, "span_ms": span_ms}
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite WordEmbedding loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the WordEmbedding loss did not fall: {losses}")
    return {"losses": losses, "words_per_sec": wps, "span_ms": span_ms}


def phase_we(dev) -> dict:
    """The WordEmbedding path on the card: the host pipeline's library,
    the MatrixTable checks, train_fused on real text with the shared pool
    (bf16 against f32, the card's f32 epoch against the CPU's, one
    profiled epoch), the four other branches on real text (we_variant),
    the synthetic corpus, and the command lines (the we_ps phase's too)."""
    import torch
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch import native
    from multiverso_tpu_torch.apps.word_embedding import (WEConfig,
                                                          WordEmbedding,
                                                          synthetic_corpus)
    from multiverso_tpu_torch.data.dictionary import Dictionary
    from multiverso_tpu_torch.io import realtext
    from multiverso_tpu_torch.models import word2vec as w2v

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native data library did not build")
    log(f"we native library {native.library_path().name}: "
        f"{time.perf_counter() - t0:.1f} s (build and load)")
    lap = Laps("we")
    phase_we_table(dev)
    lap("table")

    t0 = time.perf_counter()
    tokens = realtext.load_tokens()
    cfg = WEConfig(**WE_CFG)
    d = Dictionary.build(tokens, cfg.min_count)
    we = WordEmbedding(cfg, d)
    ids = we.prepare_ids(tokens)
    log(f"we realtext ({realtext.provenance()}): {len(tokens)} tokens, "
        f"vocab {len(d)} at min_count {cfg.min_count}, {ids.size} training "
        f"tokens after subsampling ({time.perf_counter() - t0:.1f} s on the "
        f"host); tables {we.table_in.raw().device}, compute dtype "
        f"{we.compute_dtype()}")
    if we.compute_dtype() != torch.bfloat16:
        raise AssertionError("the card must compute in bf16")
    real = we_run("realtext", we, ids)
    lap("realtext epochs")
    vocab_real = len(d)
    probe = next((w for w in WE_PROBES if w in d.word2id), None)
    log(f"we realtext nearest neighbours of {probe!r}: "
        f"{we.nearest(probe, 6)[1:] if probe else []}")
    log(f"we realtext word_count {we.total_word_count()} "
        f"(= {1 + WE_TIMED_EPOCHS} epochs x {ids.size})")
    if we.total_word_count() != (1 + WE_TIMED_EPOCHS) * ids.size:
        raise AssertionError("the word_count KVTable is off")

    # bf16 against f32 from the same tables, pairs and LCG: by loss over
    # the first WE_REF_BATCHES batches; the full epoch beside the spread of
    # two f32 runs of it
    w2v_cfg = w2v.W2VConfig(len(d), cfg.size, cfg.negative, cfg.window,
                            cfg.alpha, False, False, cfg.shared_negatives)
    cbd, xbd, _ = we._device_pairs(ids)
    start = (we.table_in.raw(), we.table_out.raw(), we._lcg)
    epochs = {dt: w2v.make_fused_shared_epoch(w2v_cfg, we.unigram,
                                              compute_dtype=dt)
              for dt in (torch.bfloat16, torch.float32)}

    def from_start(dt, batches=None):
        win, _, loss, _ = epochs[dt](*(t.clone() for t in start[:2]),
                                     cbd[:batches], xbd[:batches],
                                     start[2].clone())
        return float(loss), win

    n = WE_REF_BATCHES
    (lb, _), (lf, _) = (from_start(dt, n)
                        for dt in (torch.bfloat16, torch.float32))
    rel = abs(lb - lf) / abs(lf)
    log(f"we bf16 vs f32 over the first {n} batches from the same start: "
        f"loss {lb:.6f} vs {lf:.6f}, relative difference {rel:.3e} (bound "
        f"{WE_BF16_LOSS_RTOL:.0e})")
    if not rel <= WE_BF16_LOSS_RTOL:
        raise AssertionError("the bf16 loss is outside its bound")
    (lb, wb), (lf, wf), (lf2, wf2) = (
        from_start(dt) for dt in (torch.bfloat16, torch.float32,
                                  torch.float32))
    log(f"we bf16 vs f32, the full epoch ({cbd.shape[0]} batches) from the "
        f"same start: loss {lb:.6f} vs {lf:.6f}, relative difference "
        f"{abs(lb - lf) / abs(lf):.3e}; f32 run twice (the atomics' order "
        f"alone): loss {lf2:.6f}, relative {abs(lf2 - lf) / abs(lf):.3e}; "
        f"embed_in ||bf16 - f32|| / ||f32|| "
        f"{float((wb - wf).norm() / wf.norm()):.3e}, f32 twice "
        f"{float((wf2 - wf).norm() / wf.norm()):.3e}")
    if not (np.isfinite(lb) and lb < real["losses"][0]):
        raise AssertionError(f"the bf16 epoch's loss {lb} is not finite and "
                             f"below the warm epoch's {real['losses'][0]}")
    del wb, wf, wf2
    lap("bf16 vs f32")

    # the card's f32 epoch against the CPU's on the first batches
    n = WE_REF_BATCHES
    fn = w2v.make_fused_shared_epoch(w2v_cfg, we.unigram,
                                     compute_dtype=torch.float32)

    fn64 = w2v.make_fused_shared_epoch(w2v_cfg, we.unigram,
                                       compute_dtype=torch.float64)

    def shared_f32(d_, dt=torch.float32):
        win, wout, loss, lcg = (fn if dt == torch.float32 else fn64)(
            *(t.to(d_, dt, copy=True) for t in start[:2]), cbd[:n].to(d_),
            xbd[:n].to(d_), start[2].to(d_, copy=True))
        return float(loss), (win, wout), (lcg,)

    we_card_vs_cpu("shared pool", shared_f32, dev, WE_REF_LOSS_RTOL,
                   f32_err_factor=WE_REF_F32_ERR_FACTOR)
    lap("shared pool vs CPU")
    we_profile("realtext", lambda: we.train_fused(ids, epochs=1),
               real["span_ms"])
    lap("realtext profile")
    del we
    variants = {}
    for label, extra in WE_VARIANTS:
        variants[label] = we_variant(dev, label, extra, d, ids)
        lap(label)

    t0 = time.perf_counter()
    tokens = synthetic_corpus(**WE_SYNTH_CORPUS)
    cfg = WEConfig(epoch=1, **WE_CFG)
    d = Dictionary.build(tokens, cfg.min_count)
    we_s = WordEmbedding(cfg, d)
    ids_s = we_s.prepare_ids(tokens)
    log(f"we synthetic: {len(tokens)} tokens, vocab {len(d)}, {ids_s.size} "
        f"training tokens ({time.perf_counter() - t0:.1f} s on the host)")
    synth = we_run("synthetic", we_s, ids_s)
    lap("synthetic")
    del we_s
    mv.barrier()
    # the three command lines side by side (the PS block path's, at
    # WE_PS_CFG, is the we_ps phase's)
    phase_we_cli("we", vocab_real, [
        {}, {"cbow": 1, "hs": 1,
             "batch_size": variants["CBOW HS"]["trained"]["batch"]},
        WE_PS_CFG])
    return {"realtext": real, "synthetic": synth, **variants}


@walled
def we_card_vs_cpu(label: str, epoch, dev, loss_rtol: float,
                   table_rtol: float = None,
                   f32_err_factor: float = None) -> float:
    """``epoch(device[, dtype]) -> (loss, tables, exact)`` trains the first
    WE_REF_BATCHES batches from one start on ``device``. It runs twice on
    the card and once on the CPU: each card run's loss within ``loss_rtol``
    (relative) of the CPU's, its ``exact`` tensors equal, and its tables
    within ``table_rtol`` of their largest magnitude or, given
    ``f32_err_factor``, within that many times the larger of the CPU's own
    f32 rounding error (the max |diff| of the CPU's f32 tables from an f64
    run of the same epoch, ``epoch("cpu", torch.float64)``) and the card's
    run-to-run spread. Returns that spread (max |diff| of the tables)."""
    import torch
    res = {where: epoch(dev if where != "cpu" else torch.device("cpu"))
           for where in ("cuda", "cuda again", "cpu")}
    res = {w: (l, [t.cpu() for t in ts], [t.cpu() for t in ex])
           for w, (l, ts, ex) in res.items()}
    lc, tc, exc = res["cpu"]
    scale = max(float(t.abs().max()) for t in tc)
    spread = max(float((a - b).abs().max())
                 for a, b in zip(res["cuda"][1], res["cuda again"][1]))
    if f32_err_factor is None:
        bound = table_rtol * scale
        how = f"bound {table_rtol:.0e} of max |x|"
    else:
        _, t64, _ = epoch(torch.device("cpu"), torch.float64)
        err32 = max(float((c.double() - e).abs().max())
                    for c, e in zip(tc, t64))
        bound = f32_err_factor * max(err32, spread)
        how = (f"bound {f32_err_factor} x max(the CPU's f32 error against "
               f"f64 {err32:.3e}, the card's spread {spread:.3e}) = "
               f"{bound / scale:.3e} of max |x|")
        del t64
    for where in ("cuda", "cuda again"):
        lg, tg, exg = res[where]
        derr = max(float((g - c).abs().max()) for g, c in zip(tg, tc))
        lrel = abs(lg - lc) / abs(lc)
        exact = all(torch.equal(g, c) for g, c in zip(exg, exc))
        msg = (f"we {label} f32 epoch of {WE_REF_BATCHES} batches, {where} "
               f"vs the CPU: loss {lg:.8f} vs {lc:.8f} (relative {lrel:.3e}, "
               f"bound {loss_rtol:.0e}), tables max |diff| {derr:.3e} at max "
               f"|x| {scale:.3f} (relative {derr / scale:.3e}, {how})"
               + (f", {len(exc)} sampler tensor(s) equal {exact}"
                  if exc else ""))
        log(msg)
        if not (lrel <= loss_rtol and derr <= bound and exact):
            raise AssertionError(f"the card's {label} epoch disagrees with "
                                 f"the CPU's: {msg}")
    log(f"we {label} f32 card epoch run to run (index_add_ atomics): tables "
        f"max |diff| {spread:.3e} ({spread / scale:.3e} of max |x|)")
    return spread


def we_profile(label: str, fn, span_ms) -> dict:
    """One profiled epoch: device time by group, and the idle share
    against the median unprofiled span."""
    prof = profile(f"we {label} epoch", fn, top=12, group=we_group)
    if prof["busy_ms"]:
        span = float(np.median(span_ms))
        prof["idle_share"] = max(0.0, 1 - prof["busy_ms"] / span)
        log(f"we {label} epoch: device busy {prof['busy_ms']:.3f} ms "
            f"(profiled) against a device span of {span:.3f} ms (median "
            f"unprofiled epoch): idle share {prof['idle_share']:.3f}")
    return prof


def we_variant(dev, label: str, extra: dict, d, ids) -> dict:
    """One more branch of ``train_fused`` on the real text at full width:
    warm and timed epochs, the card's f32 epoch against the CPU's on its
    first WE_REF_BATCHES batches, for per-pair negatives the negative ids
    of the epoch's first WE_NEG_BATCHES batches drawn on the card against
    the CPU's (bit for bit), and
    one profiled epoch. An HS branch diverges at the full batch: there the
    check runs from the fresh tables, before the loss leaves the f32
    range, the full-batch epochs are timed and profiled without a check on
    their losses, and we_hs_sweep finds the batch where it trains."""
    import torch
    from multiverso_tpu_torch.apps.word_embedding import (WEConfig,
                                                          WordEmbedding)
    from multiverso_tpu_torch.models import word2vec as w2v
    from multiverso_tpu_torch.utils import threefry

    cfg = WEConfig(**{**WE_CFG, **extra})
    we = WordEmbedding(cfg, d)
    if not cfg.hs:
        run = we_run(label, we, ids)
    *batches, _ = (we._device_cbow(ids) if cfg.cbow
                   else we._device_pairs(ids))
    fn = we._epoch_fn()
    out = we.table_hs if cfg.hs else we.table_out
    start = (we.table_in.raw(), out.raw())
    # the first epoch's key of a train_fused call
    key = threefry.split(threefry.key(cfg.seed))[1]
    n = WE_REF_BATCHES

    def f32(d_):
        win, wout, loss = fn(*(t.to(d_, copy=True) for t in start),
                             *(b[:n].to(d_) for b in batches), key)
        return float(loss), (win, wout), ()

    spread = we_card_vs_cpu(label + (" (fresh tables)" if cfg.hs else ""),
                            f32, dev, WE_VARIANT_LOSS_RTOL,
                            WE_VARIANT_TABLE_RTOL)
    if cfg.hs:
        run = we_run(f"{label} at batch {cfg.batch_size} (diverges in both "
                     f"packages)", we, ids, trains=False)
    run["spread"] = spread
    if not cfg.hs:
        table = torch.from_numpy(w2v.build_negative_table(we.unigram)
                                 .astype(np.int64))
        nb, b = batches[-1].shape
        shape = (min(nb, WE_NEG_BATCHES), b, cfg.negative)
        on_card = w2v.epoch_negatives(key, table.to(dev), *shape).cpu()
        on_cpu = w2v.epoch_negatives(key, table, *shape)
        log(f"we {label}: the epoch's first {shape[0]} batches' "
            f"{on_cpu.numel()} negative ids {tuple(shape)} drawn on the "
            f"card equal the CPU's bit for bit "
            f"{torch.equal(on_card, on_cpu)}")
        if not torch.equal(on_card, on_cpu):
            raise AssertionError(f"the {label} negatives drawn on the card "
                                 f"differ from the CPU's")
    run["profile"] = we_profile(
        label + (f" at batch {cfg.batch_size} (the scatter-adds' load; "
                 f"the loss diverges)" if cfg.hs else ""),
        lambda: we.train_fused(ids, epochs=1), run["span_ms"])
    if we.total_word_count() != (2 + WE_TIMED_EPOCHS) * ids.size:
        raise AssertionError("the word_count KVTable is off")
    del we
    if cfg.hs:
        run["trained"] = we_hs_sweep(label, extra, d, ids)
    return run


@walled
def we_hs_sweep(label: str, extra: dict, d, ids) -> dict:
    """The largest power of two below the bench batch at which an HS
    branch trains: halving from WE_CFG's batch, each batch gets we_run's
    warm and timed epochs from fresh tables, and the first whose losses
    are all finite and each below the one before is the answer (then one
    profiled epoch there). Fails if none down to WE_HS_MIN_BATCH does."""
    from multiverso_tpu_torch.apps.word_embedding import (WEConfig,
                                                          WordEmbedding)
    batch = WE_CFG["batch_size"] // 2
    while batch >= WE_HS_MIN_BATCH:
        we = WordEmbedding(
            WEConfig(**{**WE_CFG, **extra, "batch_size": batch}), d)
        run = we_run(f"{label} at batch {batch}", we, ids, trains=False)
        losses = run["losses"]
        if (np.isfinite(losses).all()
                and all(b < a for a, b in zip(losses, losses[1:]))):
            log(f"we {label}: {batch} is the largest batch (a power of two) "
                f"at which the loss falls in every epoch")
            run["batch"] = batch
            run["profile"] = we_profile(
                f"{label} at batch {batch}",
                lambda: we.train_fused(ids, epochs=1), run["span_ms"])
            return run
        del we
        batch //= 2
    raise AssertionError(f"{label} trains at no batch down to "
                         f"{WE_HS_MIN_BATCH}")


def phase_we_cli(phase: str, vocab: int, runs) -> None:
    """The app's command line on the card, each run in its own process,
    the processes side by side: one epoch of the real-text corpus at
    WE_CFG's config with each run's keys over it (skip-gram with the
    shared pool; CBOW with HS at the batch where we_hs_sweep found it
    trains; ``-use_ps 1``, the PS block path, at WE_PS_CFG's), binary
    vectors out, read back and checked (``vocab`` rows of finite
    values)."""
    import os
    import tempfile
    from multiverso_tpu_torch.apps.word_embedding import load_embeddings
    from multiverso_tpu_torch.io import realtext

    with tempfile.TemporaryDirectory() as tmp:
        corpus = realtext.materialize(os.path.join(tmp, "rt.txt"))
        started = []
        t0 = time.perf_counter()
        for i, keys in enumerate(runs):
            out = os.path.join(tmp, f"vec{i}.bin")
            argv = [sys.executable, "-m",
                    "multiverso_tpu_torch.apps.word_embedding",
                    "-train_file", corpus, "-output", out, "-binary", "1",
                    "-epoch", "1"]
            flags = [x for key, value in keys.items()
                     for x in (f"-{key}", str(value))]
            for key, value in WE_CFG.items():
                argv += [f"-{key}", str(value)]
            argv += flags           # a later key overrides an earlier one
            started.append((flags, out, subprocess.Popen(
                argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        try:
            results = [(flags, out, p.communicate(timeout=300), p.returncode,
                        time.perf_counter() - t0)
                       for flags, out, p in started]
        finally:
            for _, _, p in started:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for flags, out, (so, se), rc, seconds in results:
            if rc != 0:
                raise AssertionError(
                    f"the WordEmbedding CLI {flags} failed ({rc}):\n"
                    f"{so[-2000:]}\n{se[-2000:]}")
            trained = [l for l in so.splitlines() if "trained:" in l]
            words, emb = load_embeddings(out)
            what = " ".join(flags) or "(skip-gram, shared pool)"
            log(f"part {phase}/cli {what}: {seconds:.1f} s for the process "
                f"(start, corpus, one epoch, binary output; {len(runs)} "
                f"processes side by side); "
                f"{trained[-1].split('] ')[-1] if trained else ''}; "
                f"{len(words)} x {emb.shape[1]} vectors read back")
            if (emb.shape != (vocab, WE_CFG["size"])
                    or not np.isfinite(emb).all()):
                raise AssertionError(f"the CLI {flags} wrote {emb.shape} "
                                     f"vectors, or non-finite ones")


@walled
def we_ps_run(label: str, we, ids, trains: bool = True) -> dict:
    """One warm epoch, then WE_TIMED_EPOCHS timed ones of
    ``train_ps_blocks``: words/s by the host's clock (the call ends with
    the device drained), the device span of each epoch by CUDA events, and
    the host's cost per block over the timed epochs from the Dashboard's
    monitors (``we.prepare`` on the producer threads, ``we.block`` and
    ``we.push`` on the training thread). The losses must be finite and
    fall, unless ``trains`` is False (a batch that diverges in both
    packages, timed all the same)."""
    import torch
    from multiverso_tpu_torch.utils.dashboard import Dashboard
    losses, wps, span_ms = [], [], []
    stats = we.train_ps_blocks(ids, epochs=1)
    losses.append(stats["loss"])
    log(f"we_ps {label} warm epoch: {stats['seconds'] * 1e3:.3f} ms, loss "
        f"{stats['loss']:.6f}")
    Dashboard.reset()
    for _ in range(WE_TIMED_EPOCHS):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        stats = we.train_ps_blocks(ids, epochs=1)
        ev[1].record()
        ev[1].synchronize()
        losses.append(stats["loss"])
        wps.append(stats["words_per_sec"])
        span_ms.append(ev[0].elapsed_time(ev[1]))
    blocks = -(-ids.size // we.cfg.data_block_size)
    per_block = {name: snap.total_ms / (WE_TIMED_EPOCHS * blocks)
                 for name, snap in Dashboard.snapshot().items()
                 if name.startswith("we.") or name.endswith("_rows")}
    host_ms = [ids.size / w * 1e3 for w in wps]
    log(f"we_ps {label}: {ids.size} tokens, {blocks} blocks of "
        f"{we.cfg.data_block_size}, batch {we.cfg.batch_size}; timed epochs "
        f"host ms {[round(t, 3) for t in host_ms]}, words/s "
        f"{[round(w) for w in wps]} (median {float(np.median(wps)):.0f}); "
        f"device span ms (CUDA events) {[round(t, 3) for t in span_ms]}; "
        f"loss per epoch (warm first) {[round(l, 6) for l in losses]}")
    log(f"we_ps {label} host ms per block (Dashboard, timed epochs): "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(per_block.items())))
    run = {"losses": losses, "words_per_sec": wps, "span_ms": span_ms,
           "host_ms_per_block": per_block}
    if not trains:
        return run
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite PS-block loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the PS-block loss did not fall: {losses}")
    return run


def we_ps_blocks(keys: dict, d, ids, n_tokens: int):
    """A fresh WordEmbedding at WE_PS_CFG with ``keys`` over it, on the
    Zoo's device, trained by ``train_ps_blocks`` over ``ids[:n_tokens]``:
    (the blocks' losses, [embed_in, the second table] on the host)."""
    from multiverso_tpu_torch.apps.word_embedding import (WEConfig,
                                                          WordEmbedding)
    we = WordEmbedding(WEConfig(**{**WE_PS_CFG, **keys}), d)
    name = "_train_block_device" if we._use_device_plane(1) else (
        "_train_prepared")
    losses, inner = [], getattr(we, name)

    def record(*args):
        loss = inner(*args)
        losses.append(loss)
        return loss

    setattr(we, name, record)
    we.train_ps_blocks(ids[:n_tokens], epochs=1)
    sec = we.table_hs if we.cfg.hs else we.table_out
    return [float(l) for l in losses], [we.table_in.get(), sec.get()]


@walled
def we_ps_card_vs_cpu(label: str, keys: dict, d, ids) -> dict:
    """The device plane's first 2 blocks (WE_PS_REF_TOKENS) from the seeded
    tables, twice on the card and once on the CPU (the Zoo restarted
    there and back): each card run's block losses within
    WE_PS_REF_LOSS_RTOL of the CPU's and its tables within
    WE_PS_REF_TABLE_RTOL of their largest magnitude. Returns the errors
    and the card's run-to-run spread."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.utils.dashboard import Dashboard
    card = [we_ps_blocks(keys, d, ids, WE_PS_REF_TOKENS) for _ in range(2)]
    Dashboard.reset()     # shutdown would print it
    mv.shutdown()
    mv.init(device="cpu")
    try:
        lc, tc = we_ps_blocks(keys, d, ids, WE_PS_REF_TOKENS)
    finally:
        Dashboard.reset()
        mv.shutdown()
        mv.init()
    scale = max(float(np.abs(t).max()) for t in tc)
    out = {"scale": scale}
    for i, (lg, tg) in enumerate(card):
        lrel = max(abs(g - c) / abs(c) for g, c in zip(lg, lc))
        terr = max(float(np.abs(g - c).max()) for g, c in zip(tg, tc))
        log(f"we_ps {label} first 2 blocks, card run {i + 1} vs the CPU: "
            f"block losses {[round(l, 6) for l in lg]} vs "
            f"{[round(l, 6) for l in lc]} (relative {lrel:.3e}, bound "
            f"{WE_PS_REF_LOSS_RTOL:.0e}); tables max |diff| {terr:.3e} at "
            f"max |x| {scale:.3f} (relative {terr / scale:.3e}, bound "
            f"{WE_PS_REF_TABLE_RTOL:.0e})")
        if not (len(lg) == len(lc) == 2 and lrel <= WE_PS_REF_LOSS_RTOL
                and terr <= WE_PS_REF_TABLE_RTOL * scale):
            raise AssertionError(f"the card's {label} blocks disagree with "
                                 f"the CPU's")
        out[f"loss_rel_{i}"], out[f"table_rel_{i}"] = lrel, terr / scale
    out["spread"] = max(float(np.abs(a - b).max())
                        for a, b in zip(card[0][1], card[1][1])) / scale
    log(f"we_ps {label} first 2 blocks, card run to run (index_add_ "
        f"atomics): tables {out['spread']:.3e} of max |x|")
    return out


@walled
def we_ps_planes(d, ids) -> dict:
    """Skip-gram NS on the card: the device plane against the host plane
    over their first block (the planes compute alike there; the host
    plane's staleness starts at the second), and the pipelined host plane
    against the inline one over 2 blocks; each within WE_PS_SPREAD_FACTOR
    times the run-to-run spread of the same runs measured here, plus 1e-6
    of max |x|."""
    block = WE_PS_CFG["data_block_size"]
    pairs = (("device plane", {}, "host plane", {"ps_device_plane": "0"},
              block),
             ("host plane pipelined", {"ps_device_plane": "0"},
              "host plane inline", {"ps_device_plane": "0",
                                    "pipeline": "0"}, 2 * block))
    out = {}
    for name_a, keys_a, name_b, keys_b, n in pairs:
        (la, ta), (la2, ta2) = (we_ps_blocks(keys_a, d, ids, n)
                                for _ in range(2))
        lb, tb = we_ps_blocks(keys_b, d, ids, n)
        scale = max(float(np.abs(t).max()) for t in ta)
        spread = max(float(np.abs(a - b).max()) for a, b in zip(ta, ta2))
        diff = max(float(np.abs(a - b).max()) for a, b in zip(ta, tb))
        bound = WE_PS_SPREAD_FACTOR * spread + 1e-6 * scale
        lrel = max(abs(a - b) / abs(a) for a, b in zip(la, lb))
        lspread = max(abs(a - b) / abs(a) for a, b in zip(la, la2))
        log(f"we_ps {name_a} vs {name_b}, {n // block} block(s): tables max "
            f"|diff| {diff:.3e} (run to run {spread:.3e}; bound "
            f"{bound:.3e}; max |x| {scale:.3f}), block losses relative "
            f"{lrel:.3e} (run to run {lspread:.3e})")
        if not (diff <= bound and len(la) == len(lb)
                and lrel <= WE_PS_SPREAD_FACTOR * lspread + 1e-6):
            raise AssertionError(f"the {name_a} and the {name_b} disagree")
        out[f"{name_a} vs {name_b}"] = {"diff": diff, "spread": spread,
                                        "scale": scale}
    return out


@walled
def we_ps_cache(d, ids, off: dict) -> dict:
    """Skip-gram NS on the pipelined host plane with the hot-row train
    cache (write-through, WE_PS_CACHE_ROWS >= the vocabulary): the hit
    rate, the blocks served as device blocks, words/s beside the cache-off
    run (``off``); a one-epoch run's tables against a cache-off run's,
    within WE_PS_SPREAD_FACTOR times the run-to-run spread of the
    cache-off runs (plus 1e-6 of max |x|): over a whole epoch the atomics'
    order alone moves the tables by an amount that varies from pair to
    pair, so the spread is the largest of three cache-off runs' pairs;
    after the epochs the cache's rows equal the table's rows bit for
    bit."""
    from multiverso_tpu_torch.apps.word_embedding import (WEConfig,
                                                          WordEmbedding)
    keys = {"ps_device_plane": "0"}
    with train_cache(WE_PS_CACHE_ROWS):
        we = WordEmbedding(WEConfig(**{**WE_PS_CFG, **keys}), d)
    if WE_PS_CACHE_ROWS < len(d) or we.table_in._train_cache is None:
        raise AssertionError("the train cache is smaller than the vocabulary")
    served = []
    inner = we._train_prepared

    def record(prep, nw):
        if prep is not None:
            served.append(("dev_in" in prep) + ("dev_sec" in prep))
        return inner(prep, nw)

    we._train_prepared = record
    run = we_ps_run("skipgram NS host plane pipelined, train cache", we, ids)
    stats = {t.name: t.train_cache_stats() for t in (we.table_in,
                                                     we.table_out)}
    rows = sum(cache_equals_table(t) for t in (we.table_in, we.table_out))
    log(f"we_ps train cache: hit rate {[s['hit_rate'] for s in stats.values()]}"
        f" (embed_in, embed_out; {stats}); {sum(served)} of {2 * len(served)}"
        f" block pulls served as device blocks; words/s median "
        f"{float(np.median(run['words_per_sec'])):.0f} with the cache, "
        f"{float(np.median(off['words_per_sec'])):.0f} without; after the "
        f"epochs {rows} cached rows equal the tables' rows bit for bit")
    del we
    offs = [we_ps_blocks(keys, d, ids, ids.size)[1] for _ in range(3)]
    with train_cache(WE_PS_CACHE_ROWS):
        _, tb = we_ps_blocks(keys, d, ids, ids.size)

    def gap(x, y):
        return max(float(np.abs(a - b).max()) for a, b in zip(x, y))

    scale = max(float(np.abs(t).max()) for t in offs[0])
    pairs = [gap(offs[i], offs[j]) for i, j in ((0, 1), (0, 2), (1, 2))]
    spread, diff = max(pairs), gap(offs[0], tb)
    bound = WE_PS_SPREAD_FACTOR * spread + 1e-6 * scale
    log(f"we_ps host plane with the train cache vs without, one epoch: "
        f"tables max |diff| {diff:.3e} (cache-off run to run "
        f"{[float(f'{p:.3e}') for p in pairs]}; bound {bound:.3e}; max |x| "
        f"{scale:.3f})")
    if not (sum(served) > 0 and diff <= bound):
        raise AssertionError("the train cache served no block, or its run "
                             "disagrees with the cache-off run")
    run.update(stats=stats, device_blocks=sum(served), diff=diff,
               spread=spread)
    return run


@walled
def we_ps_hs_sweep(label: str, extra: dict, d, ids) -> dict:
    """The largest power of two below WE_PS_CFG's batch at which an HS
    variant's block path trains: halving, each batch gets we_ps_run's warm
    and timed epochs from fresh tables, and the first whose losses are all
    finite and each below the one before is the answer. Fails if none
    down to WE_HS_MIN_BATCH does."""
    from multiverso_tpu_torch.apps.word_embedding import (WEConfig,
                                                          WordEmbedding)
    batch = WE_PS_CFG["batch_size"] // 2
    while batch >= WE_HS_MIN_BATCH:
        we = WordEmbedding(
            WEConfig(**{**WE_PS_CFG, **extra, "batch_size": batch}), d)
        run = we_ps_run(f"{label} at batch {batch}", we, ids, trains=False)
        losses = run["losses"]
        if (np.isfinite(losses).all()
                and all(b < a for a, b in zip(losses, losses[1:]))):
            log(f"we_ps {label}: {batch} is the largest batch (a power of "
                f"two) at which the loss falls in every epoch")
            run.update(batch=batch, we=we)
            return run
        del we
        batch //= 2
    raise AssertionError(f"{label} (PS blocks) trains at no batch down to "
                         f"{WE_HS_MIN_BATCH}")


def phase_we_ps(dev) -> dict:
    """The PS block path (``train_ps_blocks``) on the card at
    bench_wordembedding_ps's widths: the four variants on the real text
    (HS at the batch we_ps_hs_sweep finds, after its divergent epochs at
    8,192), each with warm and timed epochs, its first 2 blocks against
    the CPU's and one profiled epoch; skip-gram NS on the host plane,
    pipelined and inline, with the planes held against each other; and
    the 1M-token synthetic corpus (``-use_ps 1`` on the command line runs
    beside the we phase's command lines, ``phase_we_cli``)."""
    from multiverso_tpu_torch.apps.word_embedding import (WEConfig,
                                                          WordEmbedding,
                                                          synthetic_corpus)
    from multiverso_tpu_torch.data.dictionary import Dictionary
    from multiverso_tpu_torch.io import realtext

    tokens = realtext.load_tokens()
    d = Dictionary.build(tokens, WE_PS_CFG["min_count"])
    ids = WordEmbedding(WEConfig(**WE_PS_CFG), d).prepare_ids(tokens)
    lap = Laps("we_ps")
    out = {}
    for label, extra in WE_PS_VARIANTS:
        keys = dict(extra)
        if "hs" in extra:
            we = WordEmbedding(WEConfig(**{**WE_PS_CFG, **extra}), d)
            out[f"{label} at {WE_PS_CFG['batch_size']}"] = we_ps_run(
                f"{label} at batch {WE_PS_CFG['batch_size']} (diverges in "
                f"both packages)", we, ids, trains=False)
            del we
            run = we_ps_hs_sweep(label, extra, d, ids)
            we = run.pop("we")
            keys["batch_size"] = run["batch"]
        else:
            we = WordEmbedding(WEConfig(**{**WE_PS_CFG, **extra}), d)
            run = we_ps_run(label, we, ids)
        if not we._use_device_plane(1) or we.table_in.raw().device != dev:
            raise AssertionError(f"{label} is not on the card's device plane")
        run["profile"] = we_profile(
            f"PS blocks {label} at batch {we.cfg.batch_size}",
            lambda: we.train_ps_blocks(ids, epochs=1), run["span_ms"])
        if we.total_word_count() != (2 + WE_TIMED_EPOCHS) * ids.size:
            raise AssertionError("the word_count KVTable is off")
        del we
        run["vs_cpu"] = we_ps_card_vs_cpu(label, keys, d, ids)
        out[label] = run
        lap(label)

    for label, keys in (("host plane pipelined", {"ps_device_plane": "0"}),
                        ("host plane inline", {"ps_device_plane": "0",
                                               "pipeline": "0"})):
        we = WordEmbedding(WEConfig(**{**WE_PS_CFG, **keys}), d)
        out[label] = we_ps_run(f"skipgram NS {label}", we, ids)
        out[label]["profile"] = we_profile(
            f"PS blocks skipgram NS {label}",
            lambda: we.train_ps_blocks(ids, epochs=1), out[label]["span_ms"])
        del we
        lap(label)
    out["planes"] = we_ps_planes(d, ids)
    lap("planes")
    out["train cache"] = we_ps_cache(d, ids, out["host plane pipelined"])
    lap("train cache")

    t0 = time.perf_counter()
    tokens = synthetic_corpus(**WE_PS_SYNTH_CORPUS)
    ds = Dictionary.build(tokens, WE_PS_CFG["min_count"])
    we = WordEmbedding(WEConfig(**WE_PS_CFG), ds)
    ids_s = we.prepare_ids(tokens)
    log(f"we_ps synthetic: {len(tokens)} tokens, vocab {len(ds)}, "
        f"{ids_s.size} training tokens ({time.perf_counter() - t0:.1f} s on "
        f"the host)")
    out["synthetic"] = we_ps_run("skipgram NS synthetic 1M", we, ids_s)
    lap("synthetic")
    del we
    return out


# LogisticRegression (``apps/logistic_regression.py``), LR-MNIST at its
# full width with bench.py:194-199's settings (softmax, minibatch 64, lr
# 0.05, SGD). The card's machine has no scikit-learn and no MNIST files,
# so the fused path trains the JAX package's MNIST-shaped fixture
# (``models/logreg.synthetic_dataset``, models/logreg.py:113-127) from
# fixed seeds: 60,000 training and 10,000 test samples, MNIST's split.
LR_KEYS = dict(input_size=784, output_size=10, objective_type="softmax",
               updater_type="sgd", minibatch_size=64, learning_rate=0.05)
LR_TRAIN = (60_000, 0)       # samples, synthetic_dataset seed
LR_TEST = (10_000, 1)
LR_TIMED_EPOCHS = 3
# card vs CPU from the same start, one epoch: the tables' max |diff| over
# their max |x| (cuBLAS and the CPU's BLAS sum the products in other
# orders; this phase read 9.7e-8 to 1.8e-6 on an H100), and the test
# accuracy within 2 of 10,000 samples (a near-tie may flip)
LR_TABLE_RTOL = 1e-4
LR_ACC_TOL = 2e-4
LR_MIN_ACC = 0.9             # the blobs are separable at this noise
# the host loop (use_ps): 8,192 MNIST-shaped samples written as ``dense``
# text (libsvm would be too slow to parse at 784 features), one epoch per
# run, sync_frequency 1 or 3, each with and without the pipelined pull
LR_HOST_SAMPLES = (8_192, 2)
LR_HOST_RUNS = ((1, False), (1, True), (3, False), (3, True))
# the sparse path at the shape of LIBSVM's rcv1.binary (47,236 features,
# 20,242 training samples, ~74 nonzeros a sample, values of unit L2 norm
# per sample): zipf-distributed feature ids and labels from a planted
# sparse weight vector (normal on the 1,000 most frequent ids, 0
# elsewhere), from a seed; 2,048 held-out samples of the same model for
# the accuracy
LR_RCV1 = dict(features=47_236, train=20_242, test=2_048, nnz=74,
               zipf=1.1, planted=1_000, seed=3)
LR_SPARSE_RUNS = (("sigmoid", "ftrl", 0.1), ("softmax", "sgd", 0.5))
# two epochs reach 0.73-0.76 held-out in a CPU run of this phase, against a
# majority class of ~0.50: hold each at least 0.1 above the majority
LR_SPARSE_MIN_GAIN = 0.1


def lr_pairs(**over) -> dict:
    """A LogRegConfig's key=value pairs: LR_KEYS with ``over``."""
    return {k: str(v).lower() if isinstance(v, bool) else str(v)
            for k, v in {**LR_KEYS, **over}.items()}


def on_cpu(fn):
    """``fn()`` with the Zoo restarted on the CPU, on one intra-op thread
    (LR's ops are small: a thread pool costs more than it saves), then
    back on the card."""
    import torch
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.utils.dashboard import Dashboard
    Dashboard.reset()     # shutdown would print it
    mv.shutdown()
    mv.init(device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(threads)
        Dashboard.reset()
        mv.shutdown()
        mv.init()


def table_vs_cpu(label: str, card: np.ndarray, cpu: np.ndarray) -> float:
    """The card's table against the CPU's: max |diff| over max |x|, within
    LR_TABLE_RTOL."""
    scale = float(np.abs(cpu).max())
    rel = float(np.abs(card - cpu).max()) / scale
    log(f"lr {label}, card vs CPU from the same start: tables max |diff| "
        f"{rel * scale:.3e} at max |x| {scale:.4f} (relative {rel:.3e}, "
        f"bound {LR_TABLE_RTOL:.0e})")
    if not (np.isfinite(card).all() and rel <= LR_TABLE_RTOL):
        raise AssertionError(f"the card's LR table ({label}) disagrees "
                             f"with the CPU's")
    return rel


def lr_write_dense(path: str, x: np.ndarray, y: np.ndarray) -> None:
    with open(path, "w") as f:
        np.savetxt(f, np.column_stack([y, x]), fmt=["%d"] + ["%.4f"] *
                   x.shape[1])


def lr_write_rcv1(train: str, test: str) -> dict:
    """Write LR_RCV1's train and test files (libsvm). Feature ids: a zipf
    draw per slot, through a fixed permutation of the ids, deduplicated
    and cut at ``nnz`` a sample; values uniform, normalized to unit L2
    norm a sample; label 1 where the planted weights (normal on the
    ``planted`` most frequent ids) score the sample above the training
    samples' median score, so the classes are balanced."""
    c = LR_RCV1
    rng = np.random.default_rng(c["seed"])
    F = c["features"]
    perm = rng.permutation(F)          # zipf rank -> feature id
    w = np.zeros(F)
    w[perm[: c["planted"]]] = rng.normal(size=c["planted"])
    samples = []
    for n in (c["train"], c["test"]):
        z = rng.zipf(c["zipf"], (n, 2 * c["nnz"] + 16)) - 1
        rows = []
        for row in z:
            ids = np.unique(perm[row[row < F]])[: c["nnz"]]
            v = rng.uniform(0.1, 1.0, ids.size)
            rows.append((ids, v / np.linalg.norm(v)))
        samples.append(rows)
    cut = np.median([v @ w[ids] for ids, v in samples[0]])
    nnz, labels = [], []
    for path, rows in zip((train, test), samples):
        with open(path, "w") as f:
            for ids, v in rows:
                nnz.append(ids.size)
                labels.append(int(v @ w[ids] > cut))
                f.write(f"{labels[-1]} " + " ".join(
                    f"{i}:{x:.5f}" for i, x in zip(ids.tolist(),
                                                   v.tolist())) + "\n")
    test_pos = float(np.mean(labels[c["train"]:]))
    return {"nnz": float(np.mean(nnz)),
            "majority": max(test_pos, 1 - test_pos)}


@walled
def lr_fused(xy) -> dict:
    """``train_arrays`` at LR_KEYS on LR-MNIST's shape: a warm epoch (from
    zeros: its table and accuracy are held against the CPU's), 3 timed
    epochs (samples/s by the call's own clock, the CUDA-event span of the
    call, the upload of the 188 MB epoch included), one profiled epoch,
    the loss falling and the test accuracy."""
    import torch
    from multiverso_tpu_torch.apps.logistic_regression import (LogReg,
                                                               LogRegConfig)
    x, y, xt, yt = xy
    lr = LogReg(LogRegConfig(lr_pairs()))
    warm = lr.train_arrays(x, y, epochs=1)
    table1, acc1 = lr.table.get(), lr.test_arrays(xt, yt)
    losses, sps, span_ms = [warm["loss"]], [], []
    for _ in range(LR_TIMED_EPOCHS):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        stats = lr.train_arrays(x, y, epochs=1)
        ev[1].record()
        ev[1].synchronize()
        losses.append(stats["loss"])
        sps.append(stats["samples_per_sec"])
        span_ms.append(ev[0].elapsed_time(ev[1]))
    prof = profile("lr fused epoch", lambda: lr.train_arrays(x, y, epochs=1),
                   group=lm_group)
    span = float(np.median(span_ms))
    if prof["busy_ms"]:
        prof["idle_share"] = max(0.0, 1 - prof["busy_ms"] / span)
        log(f"lr fused epoch: device busy {prof['busy_ms']:.3f} ms "
            f"(profiled) against a device span of {span:.3f} ms (median "
            f"unprofiled epoch): idle share {prof['idle_share']:.3f}")
    acc = lr.test_arrays(xt, yt)
    n = len(y) // LR_KEYS["minibatch_size"]
    log(f"lr fused: {len(y)} samples, {n} minibatches of "
        f"{LR_KEYS['minibatch_size']} an epoch; timed epochs samples/s "
        f"{[round(s) for s in sps]} (median {float(np.median(sps)):.0f}); "
        f"device span ms (CUDA events, with the upload) "
        f"{[round(t, 3) for t in span_ms]}; loss (mean of the last 10 "
        f"minibatches, warm first) {[round(l, 6) for l in losses]}; test "
        f"accuracy after 1 epoch {acc1:.4f}, after {2 + LR_TIMED_EPOCHS} "
        f"{acc:.4f}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"the fused LR loss did not fall: {losses}")
    if not acc >= LR_MIN_ACC:
        raise AssertionError(f"fused LR test accuracy {acc}")

    def cpu():
        ref = LogReg(LogRegConfig(lr_pairs()))
        ref.train_arrays(x, y, epochs=1)
        return ref.table.get(), ref.test_arrays(xt, yt)

    table_c, acc_c = on_cpu(cpu)
    rel = table_vs_cpu("fused, 1 epoch", table1, table_c)
    log(f"lr fused, 1 epoch: test accuracy card {acc1:.4f}, CPU "
        f"{acc_c:.4f} (bound {LR_ACC_TOL:.0e})")
    if abs(acc1 - acc_c) > LR_ACC_TOL:
        raise AssertionError("the card's fused LR accuracy disagrees with "
                             "the CPU's")
    return {"samples_per_sec": sps, "span_ms": span_ms, "losses": losses,
            "accuracy": acc, "table_rel": rel, "profile": prof}


@walled
def lr_host(paths: dict, xy, tmp: str) -> dict:
    """The use_ps host loop (``train_file``) over the dense file: the four
    LR_HOST_RUNS, each a fresh table and one epoch (samples/s over the
    call, the Dashboard's ``logreg.minibatch`` mean ms, the test
    accuracy), then sync_frequency 1 with the SSP clock at staleness 0,
    and its minibatches again with the reader drained first (the
    ``logreg.minibatch`` ms with no parsing thread beside it); the
    deterministic run (sync_frequency 1, no pipeline) against the
    CPU's."""
    import os
    from multiverso_tpu_torch.apps.logistic_regression import (LogReg,
                                                               LogRegConfig)
    from multiverso_tpu_torch.utils.dashboard import Dashboard
    _, _, xt, yt = xy
    base = dict(train_file=paths["dense"], reader_type="dense")
    out = {}
    runs = [(sf, pipe, {}) for sf, pipe in LR_HOST_RUNS] + [
        (1, False, {"staleness": 0, "ssp_dir": os.path.join(tmp, "ssp")})]
    for sf, pipe, extra in runs:
        label = f"sync_frequency {sf}{', pipeline' if pipe else ''}" + (
            ", SSP staleness 0" if extra else "")
        Dashboard.reset()
        lr = LogReg(LogRegConfig(lr_pairs(**base, **extra,
                                          sync_frequency=sf, pipeline=pipe)))
        stats = lr.train_file()
        mb = Dashboard.snapshot()["logreg.minibatch"]
        acc = lr.test_arrays(xt, yt)
        log(f"lr host loop, {label}: {LR_HOST_SAMPLES[0]} samples, "
            f"{mb.count} minibatches in {stats['seconds'] * 1e3:.3f} ms, "
            f"{stats['samples_per_sec']:.0f} samples/s; logreg.minibatch "
            f"mean {mb.average_ms:.3f} ms (p50 {mb.p50_ms:.3f}); loss "
            f"{stats['loss']:.6f}; test accuracy {acc:.4f}")
        if not (np.isfinite(stats["loss"]) and acc >= LR_MIN_ACC):
            raise AssertionError(f"the LR host loop ({label}) did not train")
        if extra:
            from multiverso_tpu_torch.ssp import SSPClock
            clock = SSPClock(extra["ssp_dir"], staleness=0).clock
            if clock != mb.count:
                raise AssertionError(f"SSP clock {clock} after {mb.count} "
                                     f"minibatches")
            log(f"lr host loop SSP: the clock reads {clock}")
        out[label] = {"samples_per_sec": stats["samples_per_sec"],
                      "minibatch_ms": mb.average_ms, "accuracy": acc}
        if (sf, pipe, extra) == (1, False, {}):
            table1 = lr.table.get()

    # the same minibatches with the reader drained first: no parsing
    # thread competes with the training thread for the interpreter
    from multiverso_tpu_torch.io.sample_reader import SampleReader
    batches = list(SampleReader(paths["dense"], LR_KEYS["input_size"],
                                LR_KEYS["minibatch_size"], fmt="dense"))
    lr = LogReg(LogRegConfig(lr_pairs(**base)))
    lr._sync_model()
    Dashboard.reset()
    for i, (xb, yb, _) in enumerate(batches):
        lr._train_minibatch(xb, yb, i, None)
    mb = Dashboard.snapshot()["logreg.minibatch"]
    out["drained_minibatch_ms"] = mb.average_ms
    log(f"lr host loop, sync_frequency 1, the reader drained first: "
        f"logreg.minibatch mean {mb.average_ms:.3f} ms (p50 "
        f"{mb.p50_ms:.3f}) over {mb.count} minibatches")

    def cpu():
        ref = LogReg(LogRegConfig(lr_pairs(**base)))
        ref.train_file()
        return ref.table.get()

    out["table_rel"] = table_vs_cpu("host loop, sync_frequency 1", table1,
                                    on_cpu(cpu))
    return out


def lr_count_pulls(table) -> dict:
    """Count, on the host, the distinct rows each sparse Get asks for and
    the stale ones it copies off the card (the worker cache's puts)."""
    import multiverso_tpu_torch as mv
    counts = {"asked": 0, "pulled": 0}
    cache = table._worker_cache(mv.worker_id())
    put, get = cache.put, table.get_rows_sparse

    def counted_put(ids, rows):
        counts["pulled"] += len(ids)
        return put(ids, rows)

    def counted_get(ids, worker_id=0):
        counts["asked"] += np.unique(ids).size
        return get(ids, worker_id)

    cache.put, table.get_rows_sparse = counted_put, counted_get
    return counts


@walled
def lr_sparse(paths: dict, majority: float) -> dict:
    """The sparse path (``sparse=true``, a 47,237 x 2 SparseMatrixTable) on
    the rcv1.binary-shaped file, for each of LR_SPARSE_RUNS: epoch 1 (its
    table held against the CPU's), epoch 2 with the stale share of its
    pulls counted; samples/s, the ``get_rows_sparse`` ms, the held-out
    accuracy LR_SPARSE_MIN_GAIN above the majority class's share, FTRL's
    exact zeros."""
    from multiverso_tpu_torch.apps.logistic_regression import (LogReg,
                                                               LogRegConfig)
    from multiverso_tpu_torch.utils.dashboard import Dashboard
    out = {}
    for objective, updater, rate in LR_SPARSE_RUNS:
        label = f"{objective} + {updater}"
        pairs = lr_pairs(input_size=LR_RCV1["features"], output_size=2,
                         sparse=True, objective_type=objective,
                         updater_type=updater, learning_rate=rate,
                         train_file=paths["rcv1"],
                         test_file=paths["rcv1_test"])
        lr = LogReg(LogRegConfig(pairs))
        epochs = []
        for epoch in range(2):
            counts = lr_count_pulls(lr.sparse_table) if epoch else None
            Dashboard.reset()
            stats = lr.train_file()
            snap = Dashboard.snapshot()
            get = snap[f"table[{lr.sparse_table.name}].get_rows_sparse"]
            mb = snap["logreg.sparse_minibatch"]
            epochs.append({"samples_per_sec": stats["samples_per_sec"],
                           "get_rows_sparse_ms": get.average_ms,
                           "minibatch_ms": mb.average_ms,
                           "loss": stats["loss"]})
            stale = (counts["pulled"] / counts["asked"] if counts
                     else None)
            log(f"lr sparse {label}, epoch {epoch + 1}: {mb.count} "
                f"minibatches in {stats['seconds'] * 1e3:.3f} ms, "
                f"{stats['samples_per_sec']:.0f} samples/s; "
                f"logreg.sparse_minibatch mean {mb.average_ms:.3f} ms, "
                f"get_rows_sparse mean {get.average_ms:.3f} ms (p50 "
                f"{get.p50_ms:.3f}); loss {stats['loss']:.6f}"
                + (f"; stale share of the pulls {stale:.4f} "
                   f"({counts['pulled']} of {counts['asked']} rows)"
                   if counts else ""))
            if epoch == 0:
                table1 = lr.sparse_table.get()
        acc = lr.test_file()
        table = lr.sparse_table.get()
        zeros = float(np.mean(table == 0))
        log(f"lr sparse {label}: held-out accuracy {acc:.4f} (majority "
            f"class {majority:.4f}, bound +{LR_SPARSE_MIN_GAIN}); exact "
            f"zeros {zeros:.4f} of the table")
        if not (np.isfinite(table).all()
                and acc >= majority + LR_SPARSE_MIN_GAIN):
            raise AssertionError(f"the sparse LR ({label}) did not train")
        if updater == "ftrl" and not 0 < zeros < 1:
            raise AssertionError("the FTRL table holds no exact zeros")

        def cpu():
            ref = LogReg(LogRegConfig(pairs))
            ref.train_file()
            return ref.sparse_table.get()

        out[label] = {"epochs": epochs, "stale_share": stale,
                      "accuracy": acc, "zeros": zeros,
                      "table_rel": table_vs_cpu(f"sparse {label}, epoch 1",
                                                table1, on_cpu(cpu))}
    return out


def lr_cli_start(paths: dict, tmp: str) -> tuple:
    """Start the app's command line in its own process on the card: one
    epoch of the dense file with ``output_file``."""
    import os
    model = os.path.join(tmp, "lr.model")
    pairs = lr_pairs(train_file=paths["dense"], reader_type="dense",
                     output_file=model)
    cfg = os.path.join(tmp, "lr.cfg")
    with open(cfg, "w") as f:
        f.write("".join(f"{k}={v}\n" for k, v in pairs.items()))
    proc = subprocess.Popen([sys.executable, "-m",
                             "multiverso_tpu_torch.apps.logistic_regression",
                             cfg], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, time.perf_counter(), pairs, model


def lr_cli_finish(started: tuple, xy) -> None:
    """Wait for :func:`lr_cli_start`'s process; the model read back with
    ``load_model`` scores the test set."""
    from multiverso_tpu_torch.apps.logistic_regression import (LogReg,
                                                               LogRegConfig)
    proc, t0, pairs, model = started
    _, _, xt, yt = xy
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the LR CLI failed ({proc.returncode}):\n"
                             f"{out[-2000:]}\n{err[-2000:]}")
    done = [l for l in out.splitlines() if "train done" in l]
    lr = LogReg(LogRegConfig(pairs))
    lr.load_model(model)
    acc = lr.test_arrays(xt, yt)
    log(f"lr cli: {seconds:.1f} s for the process (start, one epoch, the "
        f"model written; beside the rcv1 files' writing); "
        f"{done[-1].split('] ')[-1] if done else ''}; "
        f"read back: test accuracy {acc:.4f}")
    if not acc >= LR_MIN_ACC:
        raise AssertionError(f"the LR CLI's model scores {acc}")


def phase_lr(dev, tmp: str) -> dict:
    """LogisticRegression on the card: the fused path on LR-MNIST's shape,
    the host loop (four runs and SSP), the sparse path at rcv1.binary's
    shape with FTRL and SGD, each held against the CPU, and the command
    line. The data files stay in ``tmp`` for the ps_async phase
    (``out["data"]``)."""
    from multiverso_tpu_torch.models import logreg
    t0 = time.perf_counter()
    x, y = logreg.synthetic_dataset(LR_TRAIN[0], 784, 10, seed=LR_TRAIN[1])
    xt, yt = logreg.synthetic_dataset(LR_TEST[0], 784, 10, seed=LR_TEST[1])
    xy = (x, y, xt, yt)
    lap = Laps("lr")
    out = {"fused": lr_fused(xy)}
    lap("fused")
    paths = {"dense": f"{tmp}/host.dense", "rcv1": f"{tmp}/rcv1.svm",
             "rcv1_test": f"{tmp}/rcv1_test.svm"}
    t1 = time.perf_counter()
    xh, yh = logreg.synthetic_dataset(LR_HOST_SAMPLES[0], 784, 10,
                                      seed=LR_HOST_SAMPLES[1])
    lr_write_dense(paths["dense"], xh, yh)
    # the command line trains on the dense file while the rcv1 files are
    # written (host code, nothing timed)
    cli = lr_cli_start(paths, tmp)
    try:
        rcv1 = lr_write_rcv1(paths["rcv1"], paths["rcv1_test"])
        log(f"lr data: the dense and rcv1-shaped files written in "
            f"{time.perf_counter() - t1:.1f} s on the host "
            f"({rcv1['nnz']:.1f} nonzeros a sparse sample)")
    finally:
        lr_cli_finish(cli, xy)
    lap("data files and cli")
    out["host"] = lr_host(paths, xy, tmp)
    lap("host loop")
    out["sparse"] = lr_sparse(paths, rcv1["majority"])
    lap("sparse")
    out["data"] = {"paths": paths, "xy": xy, "majority": rcv1["majority"]}
    log(f"lr phase: {time.perf_counter() - t0:.1f} s")
    return out


# ps_async: the async parameter-server plane (``multiverso_tpu_torch/ps``;
# no kernel of its own: a shard's update is a gather, the updater's
# elementwise ops and a scatter, or one index_add_).
# (a) the plane: two ranks in this process, over a FileRendezvous and
# loopback TCP, on tools/bench_async_ps.py:57's table and batches (a
# 100,000 x 128 f32 AsyncMatrixTable, 1,024-row batches strided so each
# spans both owners, rank r's rows r, r + 97, ...), each rank's client on
# its own thread for PSA_SECONDS: add_rows_async (at most 4 in flight) and
# a timed get_rows of the same rows. Rows never overlap between ranks, so
# each row takes its adds in one client's order, and a numpy model of the
# same f32 operations follows it exactly: the full Get from both ranks
# equals it bit for bit for the default updater (the bf16 wire: its
# deltas and the other rank's reply rows rounded to bf16 where they cross
# the socket), and within PSA_ADAGRAD_RTOL for AdaGrad (the card's sqrt
# and division against numpy's)
PSA_TABLE = (100_000, 128)
PSA_BATCH = 1024
PSA_SECONDS = 1.0   # cut from 2 to keep the script in its time
PSA_DEPTH = 4
PSA_CONFIGS = (("default", "none"), ("default", "bf16"),
               ("adagrad", "none"), ("adagrad", "bf16"))
PSA_ADAGRAD = dict(learning_rate=0.5, rho=0.1)
PSA_ADAGRAD_RTOL = 1e-5
# (b) the product shape: two OS processes on this card, each a rank of
# WordEmbedding on async tables (multiverso_tpu_torch/examples/we_async.py:
# bench.py:146-182's PS cell, -use_ps 1 -async_ps 1, in the reference's
# layout of tools/bench_we_async.py:125-155: -data_presplit 1, every rank
# sweeping every block with its deltas divided by the world, the ranks
# meeting at a barrier before every epoch after the warm one), on the
# real text and on the 1M-token synthetic corpus, a warm epoch, then
# PSA_WE_EPOCHS - 1 measured ones and one more under torch.profiler; each
# rank's losses must be finite and the loss averaged over the ranks must
# fall from the warm epoch to the last measured one by at least
# PSA_WE_MIN_FALL of itself (a single rank's epoch mean rises now and then
# in this layout, in both packages); then at world 1 in this process the
# pipelined path with the hot-row train cache against the unpipelined,
# uncached oracle (bench.py:361-375) on the first PSA_PARITY_TOKENS
# synthetic tokens, within WE_PS_SPREAD_FACTOR times the oracle's own
# run-to-run spread (index_add_'s atomics in the block scan), plus 1e-6 of
# max |x|
PSA_WE_EPOCHS = 2
PSA_WE_CORPORA = ("realtext", "synthetic")
# the corpora whose ranks profile one more epoch (the idle share): the real
# text, the bench's PS cell (cut from both corpora to keep the script in
# its time: each rank's first profile took ~18 s, mostly CUPTI's start)
PSA_WE_PROFILED = ("realtext",)
# the least relative fall of the ranks' mean loss, warm epoch -> last
# measured: half the smallest fall seen in this layout, rounded down, over
# world-2 runs of the JAX package on the CPU
# (tests/we_async_layout_losses.py: 16 runs 0.0053-0.0584 on the real
# text, 8 runs 0.693-0.701 on the synthetic corpus) and 12 runs of this
# part alone on an H100 (0.0116-0.0922 and 0.648-0.702)
PSA_WE_MIN_FALL = {"realtext": 0.0025, "synthetic": 0.3}
PSA_WE_TOKENS = 0             # 0: each corpus whole
PSA_PARITY_TOKENS = 125_000   # bench.py:362: max(30,000, 1M // 8)
PSA_WE_TIMEOUT = 400
# (c) LR with async_ps=true at world 1 on the lr phase's files: the dense
# host loop (sync_frequency 1, an AsyncArrayTable) and the sparse path at
# rcv1.binary's shape with sigmoid + FTRL, pipelined (an
# AsyncSparseKVTable; its lookahead pulls ride one FIFO with the pushes,
# so the run is deterministic), one epoch each held against the CPU's
# within LR_TABLE_RTOL


def psa_model(model: np.ndarray, state, ids: np.ndarray, vals: np.ndarray,
              updater: str) -> None:
    """One add of ``vals`` to rows ``ids`` of the numpy model, in the
    port's f32 order of operations (updaters/__init__.py)."""
    if updater == "default":
        model[ids] += vals
        return
    lr = np.float32(PSA_ADAGRAD["learning_rate"])
    rho = np.float32(PSA_ADAGRAD["rho"])
    state[ids] += np.square(vals) / np.square(lr)
    model[ids] -= vals * rho / (np.sqrt(state[ids]) + np.float32(1e-10))


def psa_plane(dev, configs=PSA_CONFIGS) -> dict:
    """Part (a): ``configs`` through two in-process ranks on the card,
    each held against its numpy model; adds/s, gets/s and the Get's p50
    and p99 ms across both ranks, and the plane each table took (the
    native server live, the client native)."""
    import tempfile
    import threading
    import torch
    from multiverso_tpu_torch.ps.service import (FileRendezvous, PSContext,
                                                 PSService)
    from multiverso_tpu_torch.ps.tables import AsyncMatrixTable
    from multiverso_tpu_torch.ps.wire import bf16_to_f32, f32_to_bf16
    from multiverso_tpu_torch.updaters import AddOption
    rows, cols = PSA_TABLE
    rows_per = -(-rows // 2)
    out = {}
    with tempfile.TemporaryDirectory() as rdv_dir:
        rdv = FileRendezvous(rdv_dir)
        ctxs = [PSContext(r, 2, PSService(r, 2, rdv), device=dev)
                for r in range(2)]
        try:
            for updater, wire in configs:
                label = f"{updater}, wire {wire}"
                name = f"psa_{updater}_{wire}"
                ts = [AsyncMatrixTable(rows, cols, updater=updater,
                                       wire=wire, name=name, ctx=c)
                      for c in ctxs]
                rng = np.random.default_rng(0)
                ids = [(np.arange(PSA_BATCH) * (rows // PSA_BATCH) + r)
                       % rows for r in range(2)]
                vals = [(rng.normal(size=(PSA_BATCH, cols)) * 0.01
                         ).astype(np.float32) for _ in range(2)]
                opt = [AddOption(worker_id=r, **PSA_ADAGRAD)
                       for r in range(2)]
                for r in range(2):   # warm: one add and one get a rank
                    ts[r].add_rows(ids[r], vals[r], opt[r])
                    ts[r].get_rows(ids[r])
                counts, lat = [1, 1], [[], []]

                def client(r):
                    mids = []
                    t_end = time.perf_counter() + PSA_SECONDS
                    while time.perf_counter() < t_end:
                        mids.append(ts[r].add_rows_async(ids[r], vals[r],
                                                         opt[r]))
                        counts[r] += 1
                        if len(mids) >= PSA_DEPTH:
                            ts[r].wait(mids.pop(0))
                        g0 = time.perf_counter()
                        ts[r].get_rows(ids[r])
                        lat[r].append((time.perf_counter() - g0) * 1e3)
                    for m in mids:
                        ts[r].wait(m)

                t0 = time.perf_counter()
                th = [threading.Thread(target=client, args=(r,))
                      for r in range(2)]
                for t in th:
                    t.start()
                for t in th:
                    t.join(timeout=PSA_SECONDS + 120)
                    if t.is_alive():
                        raise AssertionError(f"ps_async {label}: a client "
                                             "did not finish")
                dt = time.perf_counter() - t0
                gets = [t.get() for t in ts]
                # the numpy model: each rank's adds, in its order, on its
                # own rows; a delta crossing the socket is rounded to bf16
                model = np.zeros(PSA_TABLE, np.float32)
                state = np.zeros(PSA_TABLE, np.float32)
                for r in range(2):
                    v = vals[r]
                    if wire == "bf16":
                        remote = (ids[r] // rows_per) != r
                        v = v.copy()
                        v[remote] = bf16_to_f32(f32_to_bf16(v[remote]))
                    for _ in range(counts[r]):
                        psa_model(model, state, ids[r], v, updater)
                errs = []
                for r in range(2):
                    want = model.copy()
                    if wire == "bf16":   # the other rank's rows came bf16
                        other = slice(0, rows_per) if r else slice(
                            rows_per, rows)
                        want[other] = bf16_to_f32(f32_to_bf16(want[other]))
                    scale = float(np.abs(want).max())
                    err = float(np.abs(gets[r] - want).max())
                    errs.append(err / scale)
                    ok = (np.array_equal(gets[r], want)
                          if updater == "default"
                          else err <= PSA_ADAGRAD_RTOL * scale)
                    if not (ok and np.isfinite(gets[r]).all()):
                        raise AssertionError(
                            f"ps_async {label}: rank {r}'s full Get is "
                            f"{err:.3e} from the numpy model (max |x| "
                            f"{scale:.3e})")
                lat_all = np.concatenate([np.asarray(l) for l in lat])
                shards = [t._shard.stats() for t in ts]
                adds = sum(counts) - 2
                nbytes = PSA_BATCH * cols * 4
                res = {"adds_per_sec": adds / dt,
                       "gets_per_sec": lat_all.size / dt,
                       "rows_per_sec": 2 * PSA_BATCH * lat_all.size / dt,
                       "mb_per_sec": 2 * nbytes * lat_all.size / dt / 1e6,
                       "get_p50_ms": float(np.percentile(lat_all, 50)),
                       "get_p99_ms": float(np.percentile(lat_all, 99)),
                       "adds": adds, "gets": int(lat_all.size),
                       "applies": [s["applies"] for s in shards],
                       "shard_adds": [s["adds"] for s in shards],
                       "cow_applies": [s["cow_applies"] for s in shards],
                       "native_applies": [s["native_applies"]
                                          for s in shards],
                       "native_server": ctxs[0].service._native is not None,
                       "native_client": ts[0]._native_ok,
                       "model_rel_err": errs}
                log(f"ps_async plane, {label}: {adds} adds and "
                    f"{lat_all.size} gets of {PSA_BATCH} rows in "
                    f"{dt:.3f} s: {res['adds_per_sec']:.1f} adds/s, "
                    f"{res['gets_per_sec']:.1f} gets/s "
                    f"({res['rows_per_sec']:.0f} rows/s, "
                    f"{res['mb_per_sec']:.1f} MB/s of adds and gets); Get "
                    f"p50 {res['get_p50_ms']:.3f} ms, p99 "
                    f"{res['get_p99_ms']:.3f} ms; shard adds "
                    f"{res['shard_adds']} in {res['applies']} applies, "
                    f"copy-on-write applies {res['cow_applies']}; native "
                    f"server {res['native_server']}, native client "
                    f"{res['native_client']}; full Get "
                    f"vs the numpy model: "
                    + ("bit for bit" if updater == "default" else
                       f"relative {max(errs):.3e} (bound "
                       f"{PSA_ADAGRAD_RTOL:.0e})"))
                out[label] = res
                del ts, gets, model, state
                torch.cuda.empty_cache()
        finally:
            for c in ctxs:
                c.close()
    return out


def psa_we_world2(dev) -> dict:
    """Part (b), the product shape: for each corpus, two processes of
    ``examples/we_async.py`` (ranks 0 and 1 of one rendezvous directory)
    on this card; their RESULT lines: words/s per rank and summed, the
    loss of each epoch (finite; the mean over the ranks falling by at
    least ``PSA_WE_MIN_FALL`` of itself), the
    same tables on both ranks, every rank's words counted."""
    import json
    import os
    import tempfile
    out = {}
    repo = os.path.dirname(os.path.abspath(__file__))
    for corpus in PSA_WE_CORPORA:
        with tempfile.TemporaryDirectory() as rdv:
            cmd = [sys.executable, "-m",
                   "multiverso_tpu_torch.examples.we_async", "--rdv", rdv,
                   "--world", "2", "--corpus", corpus, "--epochs",
                   str(PSA_WE_EPOCHS), "--tokens", str(PSA_WE_TOKENS),
                   *(["--profile"] if corpus in PSA_WE_PROFILED else []),
                   "--step_profile",
                   "--device", str(dev), "--timeout", str(PSA_WE_TIMEOUT)]
            t0 = time.perf_counter()
            procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=repo,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)
                     for r in range(2)]
            try:
                outs = [p.communicate(timeout=PSA_WE_TIMEOUT)
                        for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            wall = time.perf_counter() - t0
        results = []
        for r, (p, (so, se)) in enumerate(zip(procs, outs)):
            lines = [l for l in so.splitlines() if l.startswith("RESULT ")]
            if p.returncode != 0 or not lines:
                raise AssertionError(
                    f"ps_async WE rank {r} ({corpus}) failed "
                    f"({p.returncode}):\n{so[-2000:]}\n{se[-3000:]}")
            results.append(json.loads(lines[-1][len("RESULT "):]))
        per_epoch = [sum(res["epochs"][e]["words_per_sec"]
                         for res in results)
                     for e in range(PSA_WE_EPOCHS)]
        for res in results:
            losses = [e["loss"] for e in res["epochs"]]
            log(f"ps_async WE world 2, {corpus}, rank {res['rank']} on "
                f"{res['device']}: {res['tokens']} tokens, vocab "
                f"{res['vocab']}, rows [{res['shard_rows'][0]}, "
                f"{res['shard_rows'][1]}) of each table here; setup "
                f"{res['setup_s']:.1f} s; the process's walls (s) "
                f"{ {k: round(v, 1) for k, v in res['walls'].items()} }; "
                f"epochs: words/s "
                f"{[round(e['words_per_sec']) for e in res['epochs']]}, "
                f"seconds {[round(e['seconds'], 3) for e in res['epochs']]}"
                f", loss {[round(l, 6) for l in losses]}")
            mon = res["monitors"]
            prof = res["profiled_epoch"]
            log(f"ps_async WE world 2, {corpus}, rank {res['rank']}, last "
                f"epoch ({res['epochs'][-1]['seconds'] * 1e3:.3f} ms): host "
                "ms by monitor (calls) "
                + ", ".join(f"{k} {v['total_ms']:.3f} ({v['count']})"
                            for k, v in sorted(mon.items()))
                + (f"; one more epoch profiled: {prof['seconds'] * 1e3:.3f} "
                   f"ms, device busy {prof['busy_ms']:.3f} ms, idle share "
                   f"{max(0.0, 1 - prof['busy_ms'] / (prof['seconds'] * 1e3)):.3f}"
                   if prof and prof["busy_ms"] else
                   "; not profiled" if prof is None else
                   "; device time not measured (the profiler saw no device "
                   "activity)"))
            if not (np.isfinite(losses).all() and res["emb_finite"]):
                raise AssertionError(f"ps_async WE rank {res['rank']} "
                                     f"({corpus}) did not train: {losses}")
        # convergence: the loss averaged over the ranks falls by at least
        # PSA_WE_MIN_FALL of itself from the warm epoch to the last
        # measured one. A single rank's epoch mean is noisier than that:
        # in this layout one rank's loss rose in 3 of 12 runs on an H100
        # (2.7178 -> 2.7473, 2.3472 -> 2.3954, 2.3993 -> 2.4116) and in 1
        # of 16 runs of the JAX package on the CPU (2.7574 -> 2.7764)
        warm = float(np.mean([r["epochs"][0]["loss"] for r in results]))
        last = float(np.mean([r["epochs"][-1]["loss"] for r in results]))
        fall = (warm - last) / warm
        log(f"ps_async WE world 2, {corpus}: loss averaged over the ranks "
            f"{warm:.6f} (warm epoch) -> {last:.6f} (last measured), a "
            f"relative fall of {fall:.4f} (at least "
            f"{PSA_WE_MIN_FALL[corpus]})")
        if not fall >= PSA_WE_MIN_FALL[corpus]:
            raise AssertionError(
                f"ps_async WE ({corpus}) did not train: the ranks' mean loss "
                f"{warm:.6f} -> {last:.6f}, a relative fall of {fall:.4f} "
                f"(at least {PSA_WE_MIN_FALL[corpus]})")
        r0, r1 = results
        # every rank sweeps every block of every epoch (the measured ones
        # and the profiled one): the word counter aggregates all of them
        words = (len(results) * r0["tokens"]
                 * (PSA_WE_EPOCHS + (corpus in PSA_WE_PROFILED)))
        if not (r0["emb_sha"] == r1["emb_sha"]
                and r0["total_word_count"] == r1["total_word_count"]
                == words):
            raise AssertionError(
                f"ps_async WE ({corpus}): the ranks disagree on the tables "
                f"or the word count ({r0['total_word_count']}, "
                f"{r1['total_word_count']}; expected {words})")
        log(f"ps_async WE world 2, {corpus}: words/s summed over the ranks "
            f"per epoch {[round(w) for w in per_epoch]}; both ranks read "
            f"the same tables (sha {r0['emb_sha'][:12]}) and count "
            f"{r0['total_word_count']} words; {wall:.1f} s for the two "
            "processes")
        out[corpus] = {"ranks": results, "words_per_sec_sum": per_epoch,
                       "wall_s": wall}
    return out


def psa_we_parity() -> dict:
    """Part (b) at world 1: the pipelined path with the hot-row train
    cache (write-through) against the unpipelined, uncached oracle, and
    the oracle twice for the card's run-to-run spread, on the first
    PSA_PARITY_TOKENS synthetic tokens, two epochs."""
    from multiverso_tpu_torch.apps.word_embedding import (
        WEConfig, WordEmbedding, synthetic_corpus)
    from multiverso_tpu_torch.data.dictionary import Dictionary
    from multiverso_tpu_torch.examples.we_async import SYNTH, WE_CFG
    from multiverso_tpu_torch.utils import config
    tokens = synthetic_corpus(SYNTH["num_tokens"], vocab=SYNTH["vocab"],
                              seed=SYNTH["seed"])[:PSA_PARITY_TOKENS]
    d = Dictionary.build(tokens, WE_CFG["min_count"])
    runs = {}
    for mode in ("pipeline", "oracle", "oracle again"):
        config.set_flag("train_cache_rows",
                        1 << 16 if mode == "pipeline" else 0)
        we = WordEmbedding(WEConfig(**{**WE_CFG, "pipeline": "1" if mode
                                       == "pipeline" else "0"}), d)
        stats = we.train_ps_blocks(we.prepare_ids(tokens), epochs=2)
        runs[mode] = (stats, [we.table_in.get(), we.table_out.get()],
                      we.table_in.train_cache_stats())
    config.set_flag("train_cache_rows", 0)
    tp, to, to2 = (runs[m][1] for m in ("pipeline", "oracle",
                                        "oracle again"))
    scale = max(float(np.abs(t).max()) for t in to)
    spread = max(float(np.abs(a - b).max()) for a, b in zip(to, to2))
    diff = max(float(np.abs(a - b).max()) for a, b in zip(tp, to))
    bound = WE_PS_SPREAD_FACTOR * spread + 1e-6 * scale
    losses = {m: runs[m][0]["loss"] for m in runs}
    cache = runs["pipeline"][2]
    log(f"ps_async WE world 1, pipelined + train cache vs the oracle, "
        f"{PSA_PARITY_TOKENS} tokens x 2 epochs: tables max |diff| "
        f"{diff:.3e} (oracle run to run {spread:.3e}; bound {bound:.3e}; "
        f"max |x| {scale:.3f}); losses {losses}; words/s "
        f"{ {m: round(runs[m][0]['words_per_sec']) for m in runs} }; cache "
        f"hits {cache['hits']}, misses {cache['misses']}")
    if not (diff <= bound and np.isfinite(list(losses.values())).all()):
        raise AssertionError("the pipelined async WE run disagrees with the "
                             "oracle")
    return {"diff": diff, "spread": spread, "scale": scale,
            "losses": losses, "cache": cache}


def psa_lr(data: dict) -> dict:
    """Part (c): LR with async_ps=true on the card, dense and sparse FTRL,
    each epoch 1 held against the CPU's; samples/s."""
    from multiverso_tpu_torch.apps.logistic_regression import (LogReg,
                                                               LogRegConfig)
    paths, (_, _, xt, yt) = data["paths"], data["xy"]
    runs = (("dense, sync_frequency 1", "table",
             lr_pairs(train_file=paths["dense"], reader_type="dense",
                      async_ps=True)),
            ("sparse sigmoid + ftrl, pipelined", "sparse_table",
             lr_pairs(input_size=LR_RCV1["features"], output_size=2,
                      sparse=True, objective_type="sigmoid",
                      updater_type="ftrl", learning_rate=0.1,
                      pipeline=True, async_ps=True,
                      train_file=paths["rcv1"],
                      test_file=paths["rcv1_test"])))
    out = {}
    for label, attr, pairs in runs:
        lr = LogReg(LogRegConfig(pairs))
        table = getattr(lr, attr)
        stats = lr.train_file()
        card = table.get()
        acc = (lr.test_arrays(xt, yt) if attr == "table"
               else lr.test_file())
        floor = (LR_MIN_ACC if attr == "table"
                 else data["majority"] + LR_SPARSE_MIN_GAIN / 2)
        log(f"ps_async lr {label} ({type(table).__name__}): "
            f"{stats['samples_per_sec']:.0f} samples/s over "
            f"{stats['seconds']:.3f} s, loss {stats['loss']:.6f}, "
            f"accuracy {acc:.4f} (bound {floor:.4f})")
        if not (np.isfinite(card).all() and acc >= floor):
            raise AssertionError(f"the async LR ({label}) did not train")

        def cpu(pairs=pairs, attr=attr):
            ref = LogReg(LogRegConfig(pairs))
            ref.train_file()
            return getattr(ref, attr).get()

        out[label] = {"samples_per_sec": stats["samples_per_sec"],
                      "accuracy": acc,
                      "table_rel": table_vs_cpu(f"async {label}, epoch 1",
                                                card, on_cpu(cpu))}
    return out


def phase_ps_async(dev, lr_data: dict) -> dict:
    """The async PS plane on the card: (a) the in-process two-rank plane
    against numpy, (b) WE in two processes and the world-1 parity, (c) LR
    with async_ps=true against the CPU."""
    lap = Laps("ps_async")
    out = {"plane": psa_plane(dev)}
    lap("psa_plane")
    out["we_world2"] = psa_we_world2(dev)
    lap("psa_we_world2")
    out["we_parity"] = psa_we_parity()
    lap("psa_we_parity")
    out["lr"] = psa_lr(lr_data)
    lap("psa_lr")
    return out


# resnet: ResNet-CIFAR (``apps/resnet_cifar.py``; no kernel of its own:
# cuDNN's convolutions, the BatchNorm and Adam elementwise ops) at
# bench_resnet's shape (bench.py:965-997): depth 32, batch 128, on
# RES_IMAGES synthetic_cifar images of seed 1 uploaded once (half of its
# 50,000), the remainder of the count % 128 dropped as the JAX trainer
# drops it; a warm epoch, timed
# epochs, RES_PROFILE_STEPS profiled steps (the profiler's bookkeeping
# of a whole epoch's ~1.5M events took ~7 minutes on the card's host),
# and the eval accuracy on 512 images of seed 2.
# The card's first RES_CPU_STEPS steps are held against the CPU's from
# the same start: the mean loss within 1e-4 relative and the table within
# 2 * lr * steps absolute, as in tests/test_torch_resnet.py (Adam's first
# steps move a weight by ~lr whatever its gradient's size, so a near-zero
# gradient whose sign the two sums disagree on moves it by up to 2 * lr a
# step). That test's third bound, 99.9% of the table within 1e-6, holds
# at depth 8; at depth 32 f32's own rounding passes it: this phase's
# first run found the first step's gradient off from a float64 run's by
# up to 2.1e-2 (card) and 1.0e-2 (CPU) of a leaf's max |g|, 3.7e-3 and
# 3.5e-3 of its L2 norm (measured on an H100 80GB HBM3 at 700 W), and
# Adam's normalization turns that into table differences past 1e-6 on
# most weights (0.14 of them within it). So each run measures the noise:
# the card's first-step gradient (the worst leaf's relative L2 error)
# and its table's mean error against a float64 run of the same steps on
# the CPU are held within RES_F64_FACTOR times the CPU f32's own (the
# card's f32 convolutions are other algorithms, with other rounding). A
# wrong gradient, or a wrong sign on a leaf (relative L2 error 2), puts
# the card far past it
RES_DEPTH = 32
RES_BATCH = 128
# synthetic_cifar count, seed: half of CIFAR-10's 50,000 (cut from 50,000
# to keep the script in its time; the s/epoch is scaled to RES_FULL)
RES_IMAGES = (25_000, 1)
RES_FULL = 50_000
RES_EVAL = (512, 2)
RES_TIMED_EPOCHS = 1   # cut from 3 to keep the script in its time
RES_PROFILE_STEPS = 20
RES_MIN_ACC = 0.3             # 10 classes: chance is 0.1
RES_CPU_STEPS = 2
RES_LOSS_RTOL = 1e-4
RES_F64_FACTOR = 4.0
# the reference's published ResNet-32 sec/epoch on a GTX TITAN X
# (BASELINE.md:12,17)
RES_REFERENCE = (("Torch", 20.366), ("Theano/Lasagne", 100.02))


def res_group(name: str) -> str:
    """The ResNet step's kernel groups: convolutions (cuDNN's and the
    GEMMs), elementwise and reductions (BatchNorm, ReLU, the loss, Adam),
    the rest."""
    low = name.lower()
    if any(t in low for t in ("conv", "cudnn", "dgrad", "wgrad", "fprop",
                              "implicit", "xmma", "winograd", "fft",
                              "gemm", "nvjet", "cutlass")):
        return "conv"
    if any(t in low for t in ("elementwise", "reduce", "vectorized",
                              "unrolled", "batch_norm", "softmax")):
        return "elementwise/reduce"
    return "other"


def res_tree_cast(tree, dtype, device):
    if isinstance(tree, dict):
        return {k: res_tree_cast(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [res_tree_cast(v, dtype, device) for v in tree]
    return tree.to(device=device, dtype=dtype)


def res_steps(flat: np.ndarray, bn, meta, x, y, lr: float, steps: int,
              device, dtype):
    """``steps`` Adam steps of the trainer's math in ``dtype`` on
    ``device``: (the first step's flat gradient, the final flat weights),
    both float64 numpy."""
    import torch
    from multiverso_tpu_torch import updaters
    from multiverso_tpu_torch.models import resnet

    # a copy: Adam writes ``w`` in place
    w = torch.tensor(flat, device=device, dtype=dtype)
    bn = res_tree_cast(bn, dtype, device)
    adam = updaters.AdamUpdater()
    state = adam.init_state(w.shape, dtype, device)
    opt = updaters.AddOption(learning_rate=lr)
    for i in range(steps):
        f = w.clone().requires_grad_()
        sl = slice(i * RES_BATCH, (i + 1) * RES_BATCH)
        loss, bn = resnet.loss_fn(
            resnet.unflatten_params(f, meta), bn,
            torch.from_numpy(x[sl]).to(device=device, dtype=dtype),
            torch.from_numpy(y[sl]).to(device))
        loss.backward()
        if i == 0:
            g0 = f.grad.double().cpu().numpy()
        with torch.no_grad():
            adam.apply(w, state, f.grad, opt)
    return g0, w.double().cpu().numpy()


def res_worst_leaf(g: np.ndarray, ref: np.ndarray, meta) -> tuple:
    """Over the leaves, the largest relative L2 error ||g - ref|| / ||ref||
    and the largest max |g - ref| over the leaf's max |ref|."""
    l2, peak, off = 0.0, 0.0, 0
    for _, shape in meta:
        n = int(np.prod(shape))
        a, b = g[off:off + n], ref[off:off + n]
        l2 = max(l2, float(np.linalg.norm(a - b) / np.linalg.norm(b)))
        peak = max(peak, float(np.abs(a - b).max() / np.abs(b).max()))
        off += n
    return l2, peak


@walled
def res_card_vs_cpu(x: np.ndarray, y: np.ndarray) -> dict:
    """The first RES_CPU_STEPS steps at depth 32 on the card and on the
    CPU from one start (the port's init of seed 0), through the trainer,
    and the same steps in float64 on the CPU, the noise's measure."""
    import torch
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.apps.resnet_cifar import ResNetTrainer
    from multiverso_tpu_torch.models import resnet

    params, bn = resnet.init_resnet(0, depth=RES_DEPTH)
    init = resnet.resnet_from_jax(params, bn)
    _, meta = resnet.flatten_params(params)
    n = RES_CPU_STEPS * RES_BATCH

    def run():
        t = ResNetTrainer(depth=RES_DEPTH, batch_size=RES_BATCH, init=init)
        stats = t.train(x[:n], y[:n], epochs=1)
        return stats["loss"], t.table.get()[: t.n_params], t.learning_rate

    card_loss, card, lr = run()
    t0 = time.perf_counter()
    cpu_loss, cpu, _ = on_cpu(run)
    t1 = time.perf_counter()
    dev = mv.device()    # the card again, after on_cpu
    g_card, _ = res_steps(init[0], bn, meta, x, y, lr, 1, dev, torch.float32)
    g_cpu, _ = res_steps(init[0], bn, meta, x, y, lr, 1, "cpu",
                         torch.float32)
    g64, w64 = res_steps(init[0], bn, meta, x, y, lr, RES_CPU_STEPS, "cpu",
                         torch.float64)
    t2 = time.perf_counter()
    grad_card = res_worst_leaf(g_card, g64, meta)
    grad_cpu = res_worst_leaf(g_cpu, g64, meta)
    err_card = float(np.abs(card - w64).mean())
    err_cpu = float(np.abs(cpu - w64).mean())
    diff = float(np.abs(card - cpu).max())
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    log(f"resnet card vs CPU, {RES_CPU_STEPS} steps at depth {RES_DEPTH} "
        f"from one start (CPU trainer {t1 - t0:.1f} s, the f32 and float64 "
        f"reference steps {t2 - t1:.1f} s): mean loss {card_loss:.7f} vs "
        f"{cpu_loss:.7f} (relative {rel:.2e}, bound {RES_LOSS_RTOL:.0e}); "
        f"tables max |diff| {diff:.3e} (bound {2 * lr * RES_CPU_STEPS:.0e}), "
        f"{float((np.abs(card - cpu) <= 1e-6).mean()):.4f} of it within "
        f"1e-6")
    log(f"resnet against float64 (the f32 noise): the first step's "
        f"gradient, worst leaf's relative L2 error: card {grad_card[0]:.3e}, "
        f"CPU {grad_cpu[0]:.3e} (worst leaf's max |err| over its max |g|: "
        f"card {grad_card[1]:.3e}, CPU {grad_cpu[1]:.3e}); the table's mean "
        f"|err| after {RES_CPU_STEPS} steps: card {err_card:.3e}, CPU "
        f"{err_cpu:.3e} (the card's bounds: {RES_F64_FACTOR}x the CPU's)")
    if not (np.isfinite(card).all() and rel <= RES_LOSS_RTOL
            and diff <= 2 * lr * RES_CPU_STEPS
            and grad_card[0] <= RES_F64_FACTOR * grad_cpu[0]
            and err_card <= RES_F64_FACTOR * err_cpu):
        raise AssertionError("the card's ResNet steps disagree with the "
                             "CPU's past f32's own noise")
    return {"loss_rel": rel, "table_max": diff, "grad_card": grad_card,
            "grad_cpu": grad_cpu, "err_card": err_card, "err_cpu": err_cpu}


def phase_resnet(dev) -> dict:
    """ResNet-32 on the card at bench_resnet's shape: card vs CPU, a warm
    epoch, timed epochs with a falling loss, a profiled epoch, the eval
    accuracy."""
    import torch
    from multiverso_tpu_torch.apps.resnet_cifar import ResNetTrainer
    from multiverso_tpu_torch.models import resnet
    from multiverso_tpu_torch.updaters import AddOption

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    x, y = resnet.synthetic_cifar(RES_IMAGES[0], seed=RES_IMAGES[1])
    log(f"resnet settings: depth {RES_DEPTH}, batch {RES_BATCH}, "
        f"{RES_IMAGES[0]} synthetic_cifar images (seed {RES_IMAGES[1]}, "
        f"{x.nbytes / 1e6:.0f} MB f32, made in "
        f"{time.perf_counter() - t0:.1f} s), Adam lr 1e-3 in one "
        f"ArrayTable, f32, TF32 "
        f"{'on' if torch.backends.cudnn.allow_tf32 else 'off'}")
    lap = Laps("resnet")
    out = {"card_vs_cpu": res_card_vs_cpu(x, y)}
    lap("card vs CPU")

    trainer = ResNetTrainer(depth=RES_DEPTH, batch_size=RES_BATCH, seed=0)
    t0 = time.perf_counter()
    xd = torch.from_numpy(x).to(dev)      # uploaded once
    yd = torch.from_numpy(y).to(dev)
    data = trainer._batches(xd, yd)       # views of xd and yd
    torch.cuda.synchronize()
    steps = data[0].shape[0]
    images = steps * RES_BATCH
    log(f"resnet: {trainer.n_params} parameters; {images} images a epoch "
        f"({steps} steps) on {dev} in {time.perf_counter() - t0:.1f} s")
    epochs = [trainer.train(xd, yd, epochs=1)]   # warm
    for _ in range(RES_TIMED_EPOCHS):
        epochs.append(trainer.train(xd, yd, epochs=1))
    losses = [e["loss"] for e in epochs]
    secs = [e["seconds"] for e in epochs[1:]]
    sec = float(np.median(secs))
    sec_50k = sec * RES_FULL / images
    log(f"resnet epochs (warm + {RES_TIMED_EPOCHS} timed): mean losses "
        f"{[round(v, 5) for v in losses]}, seconds "
        f"{[round(s, 3) for s in secs]}")
    log(f"resnet-{RES_DEPTH}: {sec:.3f} s/epoch ({images} images), "
        f"{images / sec:.0f} images/s, {sec_50k:.3f} s for a full 50k epoch; "
        f"the reference on a GTX TITAN X (BASELINE.md): " + ", ".join(
            f"{name} {ref} s ({ref / sec_50k:.1f}x this)"
            for name, ref in RES_REFERENCE))
    if not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"the ResNet loss does not fall epoch over "
                             f"epoch: {losses}")
    lap("epochs")

    # Adam's share: its apply alone, timed on a copy of the state
    state = trainer.table.state
    copy = {"data": state["data"].clone(),
            "ustate": {k: v.clone() for k, v in state["ustate"].items()}}
    delta = torch.randn_like(copy["data"]) * 1e-3
    opt = AddOption(learning_rate=trainer.learning_rate)
    adam_ms = cuda_ms(lambda: trainer.table.updater.apply(
        copy["data"], copy["ustate"], delta, opt))
    del copy, delta

    n_prof = min(RES_PROFILE_STEPS, steps)

    def some_steps():
        live = trainer.table.state
        for i in range(n_prof):
            trainer.step(live, data[0][i], data[1][i], opt)
        torch.cuda.synchronize()
        trainer.table.adopt(live)

    prof = profile(f"resnet {n_prof} steps", some_steps, top=10,
                   group=res_group)
    if prof["busy_ms"]:
        span_ms = sec * 1e3 * n_prof / steps
        adam = adam_ms * n_prof
        groups = dict(prof["groups"])
        ew = groups.get("elementwise/reduce", 0.0)
        prof["idle_share"] = max(0.0, 1 - prof["busy_ms"] / span_ms)
        log(f"resnet busy by group over {n_prof} steps: conv "
            f"{groups.get('conv', 0.0):.1f} ms, BN and elementwise "
            f"{max(ew - adam, 0.0):.1f} ms, Adam {adam:.1f} ms ({adam_ms:.4f} "
            f"ms a step, timed alone), other {groups.get('other', 0.0):.1f} "
            f"ms; busy {prof['busy_ms']:.1f} ms against {span_ms:.1f} ms of "
            f"the median unprofiled epoch: idle share "
            f"{prof['idle_share']:.3f}")

    lap("profile")
    acc = trainer.evaluate(*resnet.synthetic_cifar(RES_EVAL[0],
                                                   seed=RES_EVAL[1]))
    log(f"resnet eval accuracy on {RES_EVAL[0]} images (seed {RES_EVAL[1]})"
        f": {acc:.4f} (bound > {RES_MIN_ACC}, chance 0.1)")
    if not acc > RES_MIN_ACC:
        raise AssertionError(f"ResNet eval accuracy {acc} <= {RES_MIN_ACC}")
    out.update(sec_per_epoch=sec, images_per_sec=images / sec,
               sec_50k=sec_50k, losses=losses, accuracy=acc, profile=prof)
    del trainer, data, xd, yd
    torch.cuda.empty_cache()
    log(f"resnet phase: {time.perf_counter() - t_phase:.1f} s")
    return out


# lda: the topic model (``models/lda.py``; no kernel of its own: gathers,
# elementwise ops, reductions and index_add_) over a SparseMatrixTable on
# the card. (a) tests/test_lda.py:29-44's planted-topic run: purity above
# 0.85, the likelihood ascending, and the table within 1e-4 of max |x| of
# the CPU's run (index_add_ adds with atomics on the card, so not bit for
# bit). (b) A size a topic-model user holds on one card: 100,000 words x
# 1,024 topics (a 410 MB f32 table), documents of 64 tokens, 5 EM
# iterations, batches of 512 documents (134 MB of responsibilities)
LDA_PLANTED = dict(vocab_size=400, num_topics=4, doc_len=32, em_iters=4)
LDA_PLANTED_DOCS = (600, 3)   # documents, corpus seed (tests/test_lda.py)
LDA_PLANTED_EPOCHS = 3
LDA_PLANTED_BATCH = 64
LDA_TABLE_RTOL = 1e-4
LDA_MIN_PURITY = 0.85
LDA_WIDE = dict(vocab_size=100_000, num_topics=1024, doc_len=64,
                em_iters=5)
LDA_WIDE_BATCH = 512
LDA_WIDE_BATCHES = (2, 8)     # warm, timed
LDA_WIDE_SEED = 4


def lda_purity(word_topics: np.ndarray, labels: np.ndarray, k: int) -> float:
    """tests/test_lda.py's agreement of the learned topics with the
    planted ones."""
    conf = np.zeros((k, k))
    np.add.at(conf, (labels[: word_topics.size], word_topics), 1)
    return float(conf.max(axis=1).sum() / conf.sum())


def lda_planted() -> dict:
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.models import lda

    cfg = lda.LDAConfig(**LDA_PLANTED)
    docs, labels = lda.synthetic_corpus(cfg, *LDA_PLANTED_DOCS)

    def run():
        table = mv.SparseMatrixTable(cfg.vocab_size, cfg.num_topics,
                                     name="lda_planted", num_workers=1)
        trainer = lda.LDATrainer(cfg, table)
        lls = [trainer.train_batch(docs[lo: lo + LDA_PLANTED_BATCH])
               for _ in range(LDA_PLANTED_EPOCHS)
               for lo in range(0, len(docs), LDA_PLANTED_BATCH)]
        return lls, table.get(), trainer.word_topics()

    lls, card, topics = run()
    _, cpu, _ = on_cpu(run)
    purity = lda_purity(topics, labels, cfg.num_topics)
    rise = float(np.mean(lls[-5:]) - np.mean(lls[:5]))
    scale = float(np.abs(cpu).max())
    rel = float(np.abs(card - cpu).max()) / scale
    log(f"lda planted topics ({cfg.vocab_size} words, {cfg.num_topics} "
        f"topics, {LDA_PLANTED_DOCS[0]} documents, {LDA_PLANTED_EPOCHS} "
        f"epochs of {LDA_PLANTED_BATCH}): purity {purity:.4f} (bound > "
        f"{LDA_MIN_PURITY}), mean ll of the last 5 batches minus the first "
        f"5: {rise:.4f} (bound > 0.1); card vs CPU tables max |diff| "
        f"{rel * scale:.3e} at max |x| {scale:.2f} (relative {rel:.2e}, "
        f"bound {LDA_TABLE_RTOL:.0e})")
    if not (purity > LDA_MIN_PURITY and rise > 0.1
            and rel <= LDA_TABLE_RTOL and np.isfinite(card).all()):
        raise AssertionError("the planted-topic LDA run failed its checks")
    return {"purity": purity, "ll_rise": rise, "table_rel": rel}


def timed_method(obj, name: str, into: list) -> None:
    """Wrap ``obj.name`` to append each call's host milliseconds to
    ``into`` (the table's row ops return or wait for their result, so the
    host clock spans the device work)."""
    real = getattr(obj, name)

    def wrapped(*args, **kw):
        t0 = time.perf_counter()
        try:
            return real(*args, **kw)
        finally:
            into.append((time.perf_counter() - t0) * 1e3)

    setattr(obj, name, wrapped)


def lda_wide(dev) -> dict:
    import torch
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.models import lda

    cfg = lda.LDAConfig(**LDA_WIDE)
    n_batches = sum(LDA_WIDE_BATCHES)
    t0 = time.perf_counter()
    docs, _ = lda.synthetic_corpus(cfg, n_batches * LDA_WIDE_BATCH,
                                   seed=LDA_WIDE_SEED)
    table = mv.SparseMatrixTable(cfg.vocab_size, cfg.num_topics,
                                 name="lda_wide", num_workers=1)
    torch.cuda.synchronize()
    log(f"lda wide settings: {cfg.vocab_size} words x {cfg.num_topics} "
        f"topics ({cfg.vocab_size * cfg.num_topics * 4 / 1e6:.0f} MB f32 "
        f"table on {dev}), documents of {cfg.doc_len} tokens, "
        f"{cfg.em_iters} EM iterations, batches of {LDA_WIDE_BATCH} "
        f"({LDA_WIDE_BATCH * cfg.doc_len * cfg.num_topics * 4 / 1e6:.0f} "
        f"MB of responsibilities); corpus of {len(docs)} documents (seed "
        f"{LDA_WIDE_SEED}) made in {time.perf_counter() - t0:.1f} s")
    trainer = lda.LDATrainer(cfg, table)
    gets, adds, secs, stale, rows, lls = [], [], [], [], [], []
    for i in range(n_batches):
        batch = docs[i * LDA_WIDE_BATCH: (i + 1) * LDA_WIDE_BATCH]
        if i == LDA_WIDE_BATCHES[0]:       # the timed batches start
            timed_method(table, "get_rows_sparse", gets)
            timed_method(table, "add_rows", adds)
        uids = np.unique(batch)
        if i >= LDA_WIDE_BATCHES[0]:
            stale.append(table.stale_fraction(uids))
            rows.append(uids.size)
        t0 = time.perf_counter()
        lls.append(trainer.train_batch(batch))
        if i >= LDA_WIDE_BATCHES[0]:
            secs.append(time.perf_counter() - t0)
    tokens = LDA_WIDE_BATCH * cfg.doc_len
    sec = float(np.median(secs))
    log(f"lda wide: {tokens / sec:.0f} tokens/s ({sec * 1e3:.1f} ms a batch "
        f"of {tokens} tokens, median of {len(secs)}), get_rows_sparse "
        f"{np.median(gets):.1f} ms, add_rows {np.median(adds):.1f} ms, "
        f"{np.mean(rows):.0f} distinct rows a batch, stale share of the "
        f"pulls {np.mean(stale):.4f}; lls {[round(v, 4) for v in lls]}")
    if not np.isfinite(lls).all():
        raise AssertionError("the wide LDA run's likelihood is not finite")
    mass = float(torch.sum(table.state["data"]))
    if abs(mass - n_batches * tokens) > 1e-3 * n_batches * tokens:
        raise AssertionError(f"the wide table holds {mass} counts, not "
                             f"{n_batches * tokens}")
    return {"tokens_per_sec": tokens / sec, "batch_ms": sec * 1e3,
            "get_rows_sparse_ms": float(np.median(gets)),
            "add_rows_ms": float(np.median(adds)),
            "stale_share": float(np.mean(stale)), "rows": float(np.mean(rows))}


def phase_lda(dev) -> dict:
    """LDA on the card: (a) the planted-topic run against the CPU, (b) the
    timed run at 100,000 x 1,024."""
    import torch
    t0 = time.perf_counter()
    out = {"planted": lda_planted(), "wide": lda_wide(dev)}
    torch.cuda.empty_cache()
    log(f"lda phase: {time.perf_counter() - t0:.1f} s")
    return out


# decode: the LM's serving path (``models/transformer.generate``,
# ``generate_beam``, int8 weights from ``ops/quantization.py``; no kernel of
# its own: the prefill and each step's attention are dense products over
# the KV cache, not the flash kernel, whose rounding of p would give other
# tokens). (a) bench_decode's config (bench.py:926-962): vocab 8192, dim
# 256, 8 heads, 4 layers, max_seq 192, f32, batch 8, a 64-token prompt and
# 128 new tokens, with f32 and with int8 weights. (b) The 472M LM (LM) at
# full width, bf16, random weights of seed 0: greedy in bf16 and in int8,
# and a beam of 4 in bf16. Checks on (a) in f32: the greedy tokens equal
# the teacher-forced argmax of forward(attn="local") at every position
# where the top two logits lie more than DEC_TIE apart; the batched
# prefill's logits within 1e-5 of the token-by-token prefill's; num_beams=1
# equal to greedy; the card's first-step logits within 1e-4 of the CPU's;
# the int8 tied-logits product within its bound: each int8 weight is off
# by at most scale/2, so a logit v of hidden state x is off by at most
# ||x||_1 * scale_v / 2 (plus f32 rounding, 1e-5 of max |logit|); a
# top_p=0.9 sampled decode with its tokens in range
DEC_SMALL = dict(vocab_size=8192, dim=256, num_heads=8, num_layers=4,
                 max_seq=192)
DEC_BATCH, DEC_PROMPT, DEC_NEW = 8, 64, 128
DEC_TIMED = 2   # cut from 3 to keep the script in its time
DEC_TIE = 1e-4
DEC_PREFILL_ATOL = 1e-5
DEC_CPU_ATOL = 1e-4
DEC_BEAMS = 4


def dec_time(fn, label: str, timed: int = DEC_TIMED, warm=None) -> dict:
    """A warm call (``warm``, by default ``fn``: a whole decode), then
    ``timed`` calls of ``fn`` on the host clock, each ended by a
    synchronize: median seconds, tokens/s, ms a step, peak device
    memory."""
    import torch
    (warm or fn)()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(timed):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    sec = float(np.median(secs))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"decode {label}: {DEC_BATCH * DEC_NEW / sec:.0f} tokens/s, "
        f"{sec / DEC_NEW * 1e3:.3f} ms a step (median of {timed} decodes of "
        f"{DEC_NEW} tokens x batch {DEC_BATCH}, prefill included), peak "
        f"memory {peak:.2f} GiB")
    return {"out": out, "tokens_per_sec": DEC_BATCH * DEC_NEW / sec,
            "ms_per_step": sec / DEC_NEW * 1e3, "peak_gib": peak}


def weight_bytes(tree) -> int:
    from multiverso_tpu_torch.ops.quantization import QuantizedTensor
    if isinstance(tree, dict):
        return sum(weight_bytes(v) for v in tree.values())
    if isinstance(tree, QuantizedTensor):
        return weight_bytes(tree.q) + weight_bytes(tree.scale)
    return tree.numel() * tree.element_size()


def dec_checks(model, tree, qtree, prompt, cfg, out) -> dict:
    """(a)'s checks in f32 on the greedy tokens ``out``."""
    import torch
    from multiverso_tpu_torch.models import transformer as tfm
    from multiverso_tpu_torch.utils import threefry

    p = DEC_PROMPT
    with torch.inference_mode():
        logits = tfm.forward(model, out[:, :-1].long(), cfg)[:, p - 1:]
    top2 = torch.topk(logits, 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > DEC_TIE
    agree = logits.argmax(-1) == out[:, p:]
    skipped = int((~clear).sum())
    log(f"decode (a) greedy vs the teacher-forced argmax of forward(attn="
        f"'local'): {int((agree & clear).sum())} of {int(clear.sum())} "
        f"positions agree; {skipped} of {clear.numel()} skipped (top two "
        f"logits within {DEC_TIE})")
    if not bool(agree[clear].all()):
        raise AssertionError("greedy decode disagrees with the forward's "
                             "argmax")

    seen = []
    real = tfm._tied_logits

    def capture(x, e):
        seen.append(x)
        return real(x, e)

    tfm._tied_logits = capture
    try:
        caches, batched = tfm._prefill(tree, prompt, cfg, p + 1)
    finally:
        tfm._tied_logits = real
    _, seq = tfm._prefill(tree, prompt, cfg, p + 1, batched=False)
    pre = max_err(batched, seq)
    log(f"decode (a) batched prefill vs token by token: logits max |diff| "
        f"{pre:.3e} (bound {DEC_PREFILL_ATOL:.0e})")
    if not pre <= DEC_PREFILL_ATOL:
        raise AssertionError("the batched prefill disagrees with the "
                             "token-by-token prefill")

    beam1 = tfm.generate_beam(model, prompt, cfg, DEC_NEW, num_beams=1)
    if not torch.equal(beam1, out):
        raise AssertionError("num_beams=1 is not greedy")
    log("decode (a) num_beams=1 equals greedy")

    cpu_model = tfm.params_from_jax(tfm.params_to_numpy(model), cfg, "cpu")
    _, cpu_logits = tfm._prefill(tfm.param_tree(cpu_model), prompt.cpu(),
                                 cfg, p + 1)
    cpu_err = max_err(batched.cpu(), cpu_logits)
    log(f"decode (a) first-step logits, card vs CPU: max |diff| "
        f"{cpu_err:.3e} (bound {DEC_CPU_ATOL:.0e})")
    if not cpu_err <= DEC_CPU_ATOL:
        raise AssertionError("the card's first-step logits disagree with "
                             "the CPU's")

    x = seen[0].float()                                    # [B, D]
    e = qtree["embed"]
    exact = tfm._tied_logits(x, tree["embed"])
    q = tfm._tied_logits(x, e)
    bound = (x.abs().sum(-1, keepdim=True) * e.scale[:, 0][None] / 2
             + 1e-5 * exact.abs().max())
    ratio = float(((q - exact).abs() / bound).max())
    _, qlogits = tfm._prefill(qtree, prompt, cfg, p + 1)
    log(f"decode (a) int8 tied logits on the f32 hidden state: max |diff| "
        f"{max_err(q, exact):.3e}, at most {ratio:.3f} of the bound "
        f"||x||_1 * scale_v / 2 (+1e-5 of max |logit| "
        f"{float(exact.abs().max()):.2f}); the whole int8 first step: "
        f"logits max |diff| {max_err(qlogits, batched):.3e}")
    if not ratio <= 1.0:
        raise AssertionError("the int8 logits pass the bound their scales "
                             "imply")

    sampled = tfm.generate(model, prompt, cfg, DEC_NEW, temperature=1.0,
                           key=threefry.key(0), top_p=0.9)
    new = sampled[:, p:]
    if not (tuple(sampled.shape) == (DEC_BATCH, p + DEC_NEW)
            and int(new.min()) >= 0 and int(new.max()) < cfg.vocab_size):
        raise AssertionError("the top_p sample is out of range")
    log(f"decode (a) top_p=0.9 sample: {tuple(sampled.shape)}, tokens in "
        f"[{int(new.min())}, {int(new.max())}], "
        f"{int((new != out[:, p:]).sum())} of {new.numel()} differ from "
        f"greedy")
    return {"skipped": skipped, "prefill_err": pre, "cpu_err": cpu_err,
            "int8_ratio": ratio}


def phase_decode(dev) -> dict:
    """Decode on the card: (a) bench_decode's config in f32 and int8 with
    the checks, (b) the 472M LM greedy in bf16 and int8 and a beam of 4."""
    import torch
    from multiverso_tpu_torch.models import transformer as tfm
    from multiverso_tpu_torch.ops.quantization import quantize_lm_params

    t_phase = time.perf_counter()
    rng = np.random.default_rng(0)
    cfg = tfm.TransformerConfig(dtype=torch.float32, attn="local",
                                **DEC_SMALL)
    log(f"decode settings: (a) {DEC_SMALL}, f32, attn='local'; (b) the LM "
        f"{LM} with {LAYERS} layers, bf16; batch {DEC_BATCH}, prompt "
        f"{DEC_PROMPT}, {DEC_NEW} new tokens, greedy unless named; TF32 "
        f"{'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'}")
    model = tfm.params_from_jax(tfm.init_params(cfg, seed=0), cfg, dev)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (DEC_BATCH, DEC_PROMPT)).astype(np.int32)).to(dev)
    tree = tfm.param_tree(model)
    qtree = quantize_lm_params(model)
    out = {"small_f32": dec_time(
        lambda: tfm.generate(model, prompt, cfg, DEC_NEW), "(a) f32")}
    out["small_int8"] = dec_time(
        lambda: tfm.generate(qtree, prompt, cfg, DEC_NEW), "(a) int8")
    greedy = out["small_f32"]["out"]
    out["checks"] = dec_checks(model, tree, qtree, prompt, cfg, greedy)
    differ = int((out["small_int8"]["out"] != greedy).sum())
    log(f"decode (a) int8 greedy: {differ} of "
        f"{greedy[:, DEC_PROMPT:].numel()} tokens differ from f32")
    del model, tree, qtree

    big = tfm.TransformerConfig(num_layers=LAYERS, dtype=torch.bfloat16,
                                attn="local", **LM)
    t0 = time.perf_counter()
    model = tfm.params_from_jax(lm_init_params(LAYERS), big, dev)
    qtree = quantize_lm_params(model)
    torch.cuda.synchronize()
    bf16_bytes, int8_bytes = weight_bytes(tfm.param_tree(model)), \
        weight_bytes(qtree)
    log(f"decode (b) the LM built (seed 0) and quantized in "
        f"{time.perf_counter() - t0:.1f} s: weights {bf16_bytes / 2**30:.3f} "
        f"GiB in bf16, {int8_bytes / 2**30:.3f} GiB in int8 (q and scales)")
    prompt = torch.from_numpy(rng.integers(
        0, big.vocab_size, (DEC_BATCH, DEC_PROMPT)).astype(np.int32)).to(dev)
    out["big_bf16"] = dec_time(
        lambda: tfm.generate(model, prompt, big, DEC_NEW), "(b) bf16")
    out["big_int8"] = dec_time(
        lambda: tfm.generate(qtree, prompt, big, DEC_NEW), "(b) int8")
    out["big_beam"] = dec_time(
        lambda: tfm.generate_beam(model, prompt, big, DEC_NEW,
                                  num_beams=DEC_BEAMS),
        f"(b) beam of {DEC_BEAMS} bf16", timed=1,
        warm=lambda: tfm.generate_beam(model, prompt, big, 2,
                                       num_beams=DEC_BEAMS))
    for key in ("big_bf16", "big_int8", "big_beam"):
        toks = out[key].pop("out")
        if not (tuple(toks.shape) == (DEC_BATCH, DEC_PROMPT + DEC_NEW)
                and int(toks.min()) >= 0
                and int(toks.max()) < big.vocab_size):
            raise AssertionError(f"decode {key}: tokens out of range")
    for key in ("small_f32", "small_int8"):
        out[key].pop("out")
    out.update(bf16_bytes=bf16_bytes, int8_bytes=int8_bytes)
    del model, qtree
    torch.cuda.empty_cache()
    log(f"decode phase: {time.perf_counter() - t_phase:.1f} s")
    return out


# ps_window: the client send and get windows (ps/tables._SendWindow,
# _GetWindow) on the port's plane on the card, the counterparts of
# tools/bench_small_add.py and tools/bench_get_rows.py: two ranks in this
# process over a FileRendezvous and loopback TCP, every op to the REMOTE
# rank's rows, each arm's timed loop run apart (the JAX tools' rule:
# interleaving per call lets one arm's serve threads pollute the other's
# p50) and the arms alternated over two passes, the same ids and values
# to both; a number is kept only when both arms' tables agree bit for bit.
# (a) 1-row adds, window 2 ms (bench_small_add.py:79-91): p50 per call;
# (b) 1-row gets with the get coalescer (bench_get_rows.py): p50/p99,
# then 4 threads pulling at once (the fan-in dedupe: gets per frame), and
# a 120,000 x 8 bf16 get plain and chunk-streamed; (c) ps_async part (a)'s
# plane (100,000 x 128 f32, 2 ranks, 1,024-row adds) with and without the
# send window: each rank adds a new set of its own rows each call (rows
# that no other add in flight touches, so a window may merge them), in
# bursts of PSA_DEPTH adds, then waits for the burst (a wait fences the
# window); with the window a burst leaves as one frame an owner (its 4 x
# 256 KB reach batch_window_bytes' 1 MiB); adds/s, the shards' sub-ops
# and applies against the adds, and each rank's full Get against a numpy
# model bit for bit
PSW_SMALL = (1024, 32)
PSW_SMALL_ITERS = 400
PSW_GET = (4096, 32)
PSW_GET_ITERS = 300
PSW_FAN_THREADS = 4
PSW_BIG = (120_000, 8)
PSW_WINDOW_MS = 2.0
PSW_PLANE_SETS = 48           # disjoint 1,024-row sets a rank rotates


def psw_world(dev):
    """Two PSContexts on ``dev`` over a fresh rendezvous directory."""
    import tempfile
    from multiverso_tpu_torch.ps.service import (FileRendezvous, PSContext,
                                                 PSService)
    tmp = tempfile.TemporaryDirectory()
    rdv = FileRendezvous(tmp.name)
    return tmp, [PSContext(r, 2, PSService(r, 2, rdv), device=dev)
                 for r in range(2)]


def psw_pair(ctxs, rows, cols, name, **kw):
    """The table on rank 0 (the client) and its shard on rank 1."""
    from multiverso_tpu_torch.ps.tables import AsyncMatrixTable
    peer_kw = {k: v for k, v in kw.items()
               if k not in ("send_window_ms", "get_window_ms")}
    return (AsyncMatrixTable(rows, cols, name=name, ctx=ctxs[0], **kw),
            AsyncMatrixTable(rows, cols, name=name, ctx=ctxs[1], **peer_kw))


def psw_small_add(ctxs) -> dict:
    rows, cols = PSW_SMALL
    t_off, _ = psw_pair(ctxs, rows, cols, "psw_add_off")
    t_on, _ = psw_pair(ctxs, rows, cols, "psw_add_on",
                       send_window_ms=PSW_WINDOW_MS)
    rng = np.random.default_rng(0)
    ids = rng.integers(rows // 2, rows, PSW_SMALL_ITERS)
    vals = rng.normal(size=(PSW_SMALL_ITERS, 1, cols)).astype(np.float32)
    for t in (t_off, t_on):   # warm the conns and the shard's update
        for i in range(32):
            t.add_rows_async([ids[i]], vals[i])
        t.flush()

    def arm(table):
        samples = []
        for i in range(PSW_SMALL_ITERS):
            t0 = time.perf_counter()
            table.add_rows_async([ids[i]], vals[i])
            samples.append(time.perf_counter() - t0)
            if (i + 1) % 50 == 0:
                table.flush()
        table.flush()
        return np.asarray(samples) * 1e3

    passes = []
    for order in ((t_on, t_off), (t_off, t_on)):
        got = {id(t): arm(t) for t in order}
        passes.append({"on_p50_ms": float(np.percentile(got[id(t_on)], 50)),
                       "off_p50_ms": float(np.percentile(got[id(t_off)],
                                                         50))})
    if not np.array_equal(t_on.get(), t_off.get()):
        raise AssertionError("ps_window: the window-on table diverged from "
                             "the window-off table under the same adds")
    best = max(passes, key=lambda p: p["off_p50_ms"] / p["on_p50_ms"])
    snap = {k: dash_count(f"table[psw_add_on].add_rows.{k}")
            for k in ("windowed", "flushes", "merged_rows")}
    log(f"ps_window small adds (1 row of {cols} f32, {PSW_SMALL_ITERS} a "
        f"pass, 2 passes): p50 per call window on "
        + ", ".join(f"{p['on_p50_ms']:.4f}" for p in passes)
        + " ms, off " + ", ".join(f"{p['off_p50_ms']:.4f}" for p in passes)
        + f" ms (best speedup {best['off_p50_ms'] / best['on_p50_ms']:.2f}"
        f"x); window counters {snap}; the two tables equal bit for bit")
    return {"passes": passes, "counters": snap}


def psw_small_get(ctxs) -> dict:
    import threading
    rows, cols = PSW_GET
    rng = np.random.default_rng(7)
    init = rng.normal(size=(rows, cols)).astype(np.float32)
    t_off, _ = psw_pair(ctxs, rows, cols, "psw_get_off", init=init)
    t_on, _ = psw_pair(ctxs, rows, cols, "psw_get_on", init=init,
                       get_window_ms=PSW_WINDOW_MS)
    ids = rng.integers(rows // 2, rows, PSW_GET_ITERS)
    for i in rng.integers(rows // 2, rows, 32):
        t_off.get_rows([i])
        t_on.get_rows([i])

    def serial(table):
        samples, last = [], None
        for i in range(PSW_GET_ITERS):
            t0 = time.perf_counter()
            last = table.get_rows([ids[i]])
            samples.append(time.perf_counter() - t0)
        return np.asarray(samples) * 1e3, last

    on_ms, on_last = serial(t_on)
    off_ms, off_last = serial(t_off)
    if not (np.array_equal(on_last, off_last) and np.array_equal(
            t_on.get_rows(np.arange(rows)), t_off.get_rows(np.arange(rows)))):
        raise AssertionError("ps_window: the get coalescer returned other "
                             "bytes than the plain get")
    fetch0 = dash_count("table[psw_get_on].get_rows.fetches")
    win0 = dash_count("table[psw_get_on].get_rows.windowed")
    fan_iters = max(PSW_GET_ITERS // 4, 25)

    def fan(table):
        errs = []

        def run(seed):
            r = np.random.default_rng(seed)
            try:
                for _ in range(fan_iters):
                    want = r.integers(rows // 2, rows, 4)
                    if not np.array_equal(table.get_rows(want), init[want]):
                        errs.append(AssertionError("a fan-in get returned "
                                                   "other rows"))
            except Exception as e:   # noqa: BLE001 — raised after the join
                errs.append(e)

        ths = [threading.Thread(target=run, args=(s,))
               for s in range(PSW_FAN_THREADS)]
        t0 = time.perf_counter()
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=120)
            if th.is_alive():
                raise AssertionError("ps_window: a fan-in getter hung")
        if errs:
            raise errs[0]
        return time.perf_counter() - t0

    fan_on = fan(t_on)
    fan_off = fan(t_off)
    gets = dash_count("table[psw_get_on].get_rows.windowed") - win0
    frames = dash_count("table[psw_get_on].get_rows.fetches") - fetch0
    big_rows, big_cols = PSW_BIG
    t_big, _ = psw_pair(ctxs, big_rows, big_cols, "psw_big", wire="bf16")
    t_big.set_rows(np.arange(big_rows), rng.normal(
        size=PSW_BIG).astype(np.float32))
    all_ids = np.arange(big_rows)

    def timed_big():
        t0 = time.perf_counter()
        got = t_big.get_rows(all_ids)
        return (time.perf_counter() - t0) * 1e3, got

    from multiverso_tpu_torch.utils import config
    timed_big()
    plain = [timed_big() for _ in range(3)]
    config.set_flag("get_chunk_rows", max(big_rows // 8, 256))
    try:
        chunked = [timed_big() for _ in range(3)]
    finally:
        config.set_flag("get_chunk_rows", 0)
    if not all(np.array_equal(g, plain[0][1]) for _, g in plain + chunked):
        raise AssertionError("ps_window: the chunk-streamed get differs from "
                             "the one-frame get")
    out = {"on_p50_ms": float(np.percentile(on_ms, 50)),
           "on_p99_ms": float(np.percentile(on_ms, 99)),
           "off_p50_ms": float(np.percentile(off_ms, 50)),
           "off_p99_ms": float(np.percentile(off_ms, 99)),
           "fan_gets": gets, "fan_frames": frames,
           "fan_dedupe": gets / max(frames, 1),
           "fan_on_s": fan_on, "fan_off_s": fan_off,
           "big_plain_ms": min(ms for ms, _ in plain),
           "big_chunked_ms": min(ms for ms, _ in chunked)}
    log(f"ps_window small gets (1 row of {cols} f32, {PSW_GET_ITERS} each): "
        f"window on p50 {out['on_p50_ms']:.4f} ms, p99 "
        f"{out['on_p99_ms']:.4f} ms; off p50 {out['off_p50_ms']:.4f} ms, p99 "
        f"{out['off_p99_ms']:.4f} ms; {PSW_FAN_THREADS} threads x "
        f"{fan_iters} gets of 4 rows: {gets} gets in {frames} frames "
        f"(dedupe {out['fan_dedupe']:.2f}), {fan_on:.3f} s on vs "
        f"{fan_off:.3f} s off; {big_rows} x {big_cols} bf16 get "
        f"{out['big_plain_ms']:.3f} ms plain, {out['big_chunked_ms']:.3f} ms "
        f"chunk-streamed (min of 3); every reply equal bit for bit")
    return out


def psw_plane(ctxs) -> dict:
    """ps_async part (a)'s config with the send window on and off."""
    import threading
    from multiverso_tpu_torch.ps.tables import AsyncMatrixTable
    rows, cols = PSA_TABLE
    sets = [[((np.arange(PSA_BATCH) * 2 + r) + 2 * PSA_BATCH * k) % rows
             for k in range(PSW_PLANE_SETS)] for r in range(2)]
    rng = np.random.default_rng(3)
    vals = [(rng.normal(size=(PSA_BATCH, cols)) * 0.01).astype(np.float32)
            for _ in range(2)]
    out = {}
    for label, wm in (("window on", PSW_WINDOW_MS), ("window off", 0.0)):
        name = "psw_plane_" + label.split()[1]
        ts = [AsyncMatrixTable(rows, cols, name=name, ctx=c,
                               send_window_ms=wm) for c in ctxs]
        for r in range(2):   # warm
            ts[r].add_rows(sets[r][0], vals[r])
        counts = [1, 1]

        def client(r):
            t_end = time.perf_counter() + PSA_SECONDS
            k = 1
            while time.perf_counter() < t_end:
                mids = []
                for _ in range(PSA_DEPTH):
                    mids.append(ts[r].add_rows_async(
                        sets[r][k % PSW_PLANE_SETS], vals[r]))
                    k += 1
                for m in mids:
                    ts[r].wait(m)
            counts[r] = k

        t0 = time.perf_counter()
        th = [threading.Thread(target=client, args=(r,)) for r in range(2)]
        for t in th:
            t.start()
        for t in th:
            t.join(timeout=PSA_SECONDS + 120)
            if t.is_alive():
                raise AssertionError(f"ps_window plane ({label}): a client "
                                     "did not finish")
        dt = time.perf_counter() - t0
        model = np.zeros(PSA_TABLE, np.float32)
        for r in range(2):
            for k in range(counts[r]):
                model[sets[r][k % PSW_PLANE_SETS]] += vals[r]
        for r in range(2):
            if not np.array_equal(ts[r].get(), model):
                raise AssertionError(f"ps_window plane ({label}): rank {r}'s "
                                     "full Get differs from the numpy model")
        shards = [t._shard.stats() for t in ts]
        adds = sum(counts) - 2
        res = {"adds_per_sec": adds / dt, "adds": adds,
               "shard_adds": [s["adds"] for s in shards],
               "applies": [s["applies"] for s in shards],
               "frames": dash_count(f"table[{name}].add_rows.flushes"),
               "merged_rows": dash_count(
                   f"table[{name}].add_rows.merged_rows")}
        log(f"ps_window plane, {label} ({rows:,} x {cols} f32, "
            f"{PSA_BATCH}-row adds from both ranks for {PSA_SECONDS} s, "
            f"bursts of {PSA_DEPTH}): {adds} adds in {dt:.3f} s, "
            f"{res['adds_per_sec']:.1f} adds/s; shard sub-ops "
            f"{res['shard_adds']} in {res['applies']} applies; window "
            f"frames {res['frames']}, merged rows {res['merged_rows']}; "
            f"both ranks' full Gets equal the numpy model bit for bit")
        out[label] = res
        del ts, model
    return out


def phase_ps_window(dev) -> dict:
    t0 = time.perf_counter()
    tmp, ctxs = psw_world(dev)
    try:
        out = {"small_add": psw_small_add(ctxs),
               "small_get": psw_small_get(ctxs),
               "plane": psw_plane(ctxs)}
    finally:
        for c in ctxs:
            c.close()
        tmp.cleanup()
    log(f"ps_window phase: {time.perf_counter() - t0:.1f} s")
    return out


# serving: DLRM train-while-serve (apps/dlrm_serving.py over the async
# PS, serving/replica.py, serving/admission.py; no kernel of the port:
# autograd's GEMMs, gathers and index ops), the counterpart of
# tools/bench_serving.py: two ranks in this process over a FileRendezvous
# and loopback TCP, the embedding table sharded over both on the card, the
# replica's snapshot on the host and its hot-row cache on the card;
# training threads push AdaGrad row gradients through blocking adds (the
# protected write latency) while inference threads read the replica with
# field 0 on a zipf(1.2) head through ONE shared permutation (the
# training samples' field 0 rides the same head, so the shards' sketch
# ranks the keys inference hits). Phases: calib (unpaced, no admission:
# the loaded rate), steady (paced at 0.95 of an admission limit of 0.3 x
# the loaded rate), overload (unpaced: far over the limit). Asserted, as
# the tool asserts (bench_serving.py:341-414): every served read's age <=
# the bound; after the writes quiesce and one refresh, every row through
# the replica equals the shards' own, bit for bit; overload sheds (> 0)
# while the training write p50 degrades at most 2x its steady value; and
# the loss falls over the run (the last 16 steps' mean below the first
# 16's).
# (a) the tool's own cell (bench_serving.py:62-71, :122-267): vocab
# (4096, 1024, 256, 64), embed 16, dense 8, bottom (32, 16), top (16, 1),
# AdaGrad lr 0.05, cache 128 rows, refresh 0.2 s, bound 1.0 s,
# hotkeys_capacity 1024, serving_snapshot_chunk_rows 2048, 2 train
# threads at batch 64, 4 infer threads at batch 16, 10 s (calib 1 s,
# steady and overload 5 s each).
# (b) DLRM at the published widths of facebookresearch/dlrm's Criteo
# Kaggle configuration (bench/dlrm_s_criteo_kaggle.sh): 26 categorical
# fields of the Kaggle set's row counts capped at 1,000,000 a field (the
# script's own --max-ind-range; 5,569,296 of 33,762,577 rows: the cap
# is forced by the run's time, since at full rows one snapshot is 2.16 GB
# through the Python wire), --arch-sparse-feature-size=16, 13 dense
# features, --arch-mlp-bot=13-512-256-64-16, --arch-mlp-top=512-256-1,
# train batch 128, f32, AdaGrad; refresh = max(0.2, 2P) and bound =
# max(1.0, 4P) from one timed snapshot pull P; the same traffic shape as
# (a); and, time allowing, one pull of the uncapped table. After each
# part's traffic, 20 train steps on one thread under the profiler (the
# replica's refresh stopped) give the device's busy time.
# Card vs CPU: the first SERVE_CPU_STEPS DLRMServing.train_steps at (a)'s
# config, single-threaded, from the same start (the loss within 1e-5
# relative, the table and the MLP within 1e-5 of max |x|), and
# models/dlrm.make_train_step on MatrixTable + ArrayTable the same way.
SERVE_A = dict(vocab_sizes=(4096, 1024, 256, 64), embed_dim=16,
               dense_dim=8, bottom_mlp=(32, 16), top_mlp=(16, 1))
SERVE_KAGGLE_ROWS = (1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3,
                     93145, 5683, 8351593, 3194, 27, 14992, 5461306, 10,
                     5652, 2173, 4, 7046547, 18, 15, 286181, 105, 142572)
SERVE_ROW_CAP = 1_000_000     # dlrm_s_criteo_kaggle.sh --max-ind-range
SERVE_B = dict(vocab_sizes=tuple(min(v, SERVE_ROW_CAP)
                                 for v in SERVE_KAGGLE_ROWS),
               embed_dim=16, dense_dim=13, bottom_mlp=(512, 256, 64, 16),
               top_mlp=(512, 256, 1))
SERVE_LR = 0.05
SERVE_CACHE_ROWS = 128
SERVE_REFRESH_S = 0.2
SERVE_BOUND_S = 1.0
SERVE_HOTKEYS = 1024
SERVE_CHUNK_ROWS = 2048
SERVE_ZIPF = 1.2
SERVE_SHED_BACKOFF_S = 0.005
SERVE_TRAIN = (2, 64)         # threads, batch
SERVE_TRAIN_B = (2, 128)
SERVE_INFER = (4, 16)
SERVE_SECONDS = 10.0
SERVE_SAMPLES = 8192
SERVE_PROFILE_STEPS = 20
SERVE_CPU_STEPS = 4
SERVE_CPU_RTOL = 1e-5
SERVE_FULL_PULL_BUDGET_S = 150.0   # pull the uncapped table only below
SERVE_PHASES = ("calib", "steady", "overload")


def serve_zipf(rng, n: int, perm: np.ndarray):
    """Bounded zipf over [0, n) through the shared rank -> id
    permutation (bench_serving.py:_zipf_sampler's distribution). It draws
    through a CDF built once, where the tool's ``rng.choice(n, p=p)``
    rebuilds and checks the CDF on every call (75 us against 7 us for 16
    ids of 4,096 on a CPU): the load generator runs in the trainer's
    process, and its own cost is not the serving plane's."""
    cdf = np.cumsum(1.0 / np.arange(1, n + 1, dtype=np.float64)
                    ** SERVE_ZIPF)
    cdf /= cdf[-1]

    def sample(size: int) -> np.ndarray:
        return perm[np.minimum(np.searchsorted(cdf, rng.random(size),
                                               side="right"), n - 1)]

    return sample


def serve_pct(samples, q):
    return float(np.percentile(np.asarray(samples), q)) if samples else None


def serve_world(dev, name: str, cfg, refresh_s: float, bound_s: float,
                start: bool = True):
    """The app on rank 0, the table's other shard on rank 1, the data."""
    from multiverso_tpu_torch.apps.dlrm_serving import DLRMServing
    from multiverso_tpu_torch.models import dlrm
    from multiverso_tpu_torch.ps.tables import AsyncMatrixTable
    tmp, ctxs = psw_world(dev)
    app = DLRMServing(cfg, ctx=ctxs[0], name=name, lr=SERVE_LR,
                      cache_rows=SERVE_CACHE_ROWS, refresh_s=refresh_s,
                      staleness_s=bound_s, start_replica=start)
    peer = AsyncMatrixTable(dlrm.total_rows(cfg), cfg.embed_dim,
                            updater="adagrad", seed=0, init_scale=0.05,
                            name=app.emb.name, ctx=ctxs[1])
    cat, dense, labels = dlrm.synthetic_ctr(cfg, SERVE_SAMPLES, seed=2)
    perm = np.random.default_rng(13).permutation(cfg.vocab_sizes[0])
    cat[:, 0] = serve_zipf(np.random.default_rng(11), cfg.vocab_sizes[0],
                           perm)(len(cat))
    return {"tmp": tmp, "ctxs": ctxs, "app": app, "peer": peer,
            "data": (cat, dense, labels), "perm": perm, "cfg": cfg}


def serve_close(w) -> None:
    w["app"].close()
    for c in w["ctxs"]:
        c.close()
    w["tmp"].cleanup()


def serve_traffic(label: str, w, train: tuple, bound_s: float) -> dict:
    """bench_serving.py's three phases over ``w``; the contract checks."""
    import threading
    from multiverso_tpu_torch.serving.admission import SheddingError
    from multiverso_tpu_torch.telemetry import hotkeys
    app, cfg = w["app"], w["cfg"]
    cat, dense, labels = w["data"]
    table = app.emb.name
    train_threads, bs = train
    infer_threads, ib = SERVE_INFER
    app.train_step(cat[:bs], dense[:bs], labels[:bs])   # warm
    app.replica.refresh()
    app.infer(cat[:ib], dense[:ib])
    stop = threading.Event()
    ctl = {"phase": "calib", "pace": 0.0}
    results, losses = [], []

    def train_worker(j):
        r = np.random.default_rng(100 + j)
        my = {"write_ms": {p: [] for p in SERVE_PHASES}, "errors": []}
        results.append(my)
        while not stop.is_set():
            idx = r.integers(0, len(labels), bs)
            try:
                loss, ms = app.train_step(cat[idx], dense[idx], labels[idx])
            except Exception as e:   # noqa: BLE001 — counted, raised below
                my["errors"].append(repr(e))
                continue
            losses.append(loss)
            my["write_ms"][ctl["phase"]].append(ms)

    def infer_worker(j):
        r = np.random.default_rng(200 + j)
        zipf = serve_zipf(np.random.default_rng(300 + j), cfg.vocab_sizes[0],
                          w["perm"])
        my = {"lat_ms": {p: [] for p in SERVE_PHASES},
              "served": {p: 0 for p in SERVE_PHASES},
              "shed": {p: 0 for p in SERVE_PHASES},
              "age_max": 0.0, "errors": []}
        results.append(my)
        highs = np.asarray(cfg.vocab_sizes[1:], np.int64)
        next_t = time.perf_counter()
        while not stop.is_set():
            c = np.column_stack([zipf(ib), r.integers(0, highs,
                                                      (ib, highs.size))])
            ids = app._ids(c)
            ph = ctl["phase"]
            t0 = time.perf_counter()
            try:
                _rows, age = app.replica.get_rows(ids, with_age=True)
            except SheddingError:
                my["shed"][ph] += 1
                time.sleep(SERVE_SHED_BACKOFF_S)
                continue
            except Exception as e:   # noqa: BLE001
                my["errors"].append(repr(e))
                continue
            my["lat_ms"][ph].append((time.perf_counter() - t0) * 1e3)
            my["served"][ph] += 1
            my["age_max"] = max(my["age_max"], age)
            if my["served"][ph] % 64 == 0:
                # now and then the whole app path: rows -> forward -> scores
                try:
                    app.infer(c, dense[:ib])
                except SheddingError:
                    my["shed"][ph] += 1
                except Exception as e:   # noqa: BLE001
                    my["errors"].append(repr(e))
            pace = ctl["pace"]
            if pace > 0 and ph == "steady":
                next_t = max(next_t + pace, time.perf_counter() - pace)
                dt = next_t - time.perf_counter()
                if dt > 0:
                    time.sleep(dt)

    threads = [threading.Thread(target=train_worker, args=(j,), daemon=True)
               for j in range(train_threads)]
    threads += [threading.Thread(target=infer_worker, args=(j,),
                                 daemon=True) for j in range(infer_threads)]
    calib_s = 1.0
    steady_s = overload_s = max(SERVE_SECONDS * 0.5, 2.0)
    for th in threads:
        th.start()
    time.sleep(calib_s)
    calib_served = sum(my["served"]["calib"] for my in results
                       if "served" in my)
    loaded_qps = max(calib_served / calib_s, 50.0)
    limit_qps = loaded_qps * 0.3
    app.admission.set_limit(table, "infer", limit_qps,
                            burst=max(limit_qps * 0.1, 2.0))
    ctl["pace"] = infer_threads / (limit_qps * 0.95)
    ctl["phase"] = "steady"
    time.sleep(steady_s)
    rs0 = app.replica.stats()
    ctl["pace"] = 0.0
    ctl["phase"] = "overload"
    time.sleep(overload_s)
    stop.set()
    for th in threads:
        th.join(timeout=120)
        if th.is_alive():
            raise AssertionError(f"serving {label}: a worker did not stop")
    rs1 = app.replica.stats()
    dh = rs1["cache_hits"] - rs0["cache_hits"]
    dm = rs1["cache_misses"] - rs0["cache_misses"]
    train_ms = {p: [] for p in SERVE_PHASES}
    infer_ms = {p: [] for p in SERVE_PHASES}
    served = {p: 0 for p in SERVE_PHASES}
    shed = {p: 0 for p in SERVE_PHASES}
    age_max, errors = 0.0, []
    for my in results:
        errors += my["errors"]
        if "write_ms" in my:
            for p in SERVE_PHASES:
                train_ms[p] += my["write_ms"][p]
        else:
            for p in SERVE_PHASES:
                infer_ms[p] += my["lat_ms"][p]
                served[p] += my["served"][p]
                shed[p] += my["shed"][p]
            age_max = max(age_max, my["age_max"])
    if errors:
        raise AssertionError(f"serving {label}: {len(errors)} worker "
                             f"errors, first {errors[0]}")
    # parity at the shards' final version: writes quiesced, one refresh
    app.emb.flush()
    app.replica.refresh()
    direct = app.emb.get()
    via = app.replica.get_rows(np.arange(app.emb.num_row), cls="train")
    parity = bool(np.array_equal(direct, via))
    rep = app.replica.stats()
    versions = {str(r): app.emb.server_stats(r)["shards"][table]["version"]
                for r in (0, 1)}
    sketches = [app.emb.server_stats(r)["shards"][table].get("hotkeys")
                for r in (0, 1)]
    merged = hotkeys.merge_sketches(sketches)
    k, items = rep["cache_rows"], merged.get("items", [])
    total = merged.get("total") or 0
    est_hi = sum(c for _, c, _ in items[:k]) / total if k and total else None
    est_lo = (sum(max(c - e, 0) for _, c, e in items[:k]) / total
              if k and total else None)
    measured = dh / (dh + dm) if dh + dm else None
    all_infer = infer_ms["steady"] + infer_ms["overload"]
    p50_s, p50_o = (serve_pct(train_ms["steady"], 50),
                    serve_pct(train_ms["overload"], 50))
    degradation = p50_o / p50_s if p50_s and p50_o else None
    demand = served["overload"] + shed["overload"]
    out = {
        "train_steps": len(losses),
        "train_steps_per_s": len(losses) / (calib_s + steady_s + overload_s),
        "examples_per_s": len(losses) * bs / (calib_s + steady_s
                                               + overload_s),
        "train_write_ms": {p: {"p50": serve_pct(train_ms[p], 50),
                               "p99": serve_pct(train_ms[p], 99)}
                           for p in SERVE_PHASES},
        "loaded_qps": loaded_qps, "limit_qps": limit_qps,
        "served_qps_steady": served["steady"] / steady_s,
        "served_qps_overload": served["overload"] / overload_s,
        "infer_p50_ms": serve_pct(all_infer, 50),
        "infer_p99_ms": serve_pct(all_infer, 99),
        "infer_p999_ms": serve_pct(all_infer, 99.9),
        "staleness_max_s": age_max, "bound_s": bound_s,
        "shed": shed, "shed_rate_overload": (shed["overload"] / demand
                                             if demand else 0.0),
        "degradation_x": degradation,
        "deferred": rep["deferred"], "unchanged_pulls": rep["unchanged_pulls"],
        "epochs": rep["epoch"], "refresh_ms": rep["refresh_ms"],
        "cache_measured": measured, "cache_estimate": est_hi,
        "cache_estimate_lower": est_lo,
        "hit_rate_curve": hotkeys.hit_rate_curve(merged),
        "loss_first": float(np.mean(losses[:16])),
        "loss_last": float(np.mean(losses[-16:])),
        "parity": parity,
        "versions_match": all(rep["versions"].get(r) == v
                              for r, v in versions.items()),
    }
    wm = out["train_write_ms"]
    log(f"serving {label} on {card_label()}: {out['train_steps']} train "
        f"steps ({out['train_steps_per_s']:.1f} steps/s, "
        f"{out['examples_per_s']:.0f} examples/s) on {train_threads} "
        f"threads; write ms p50/p99 calib {wm['calib']['p50']:.3f}/"
        f"{wm['calib']['p99']:.3f}, steady {wm['steady']['p50']:.3f}/"
        f"{wm['steady']['p99']:.3f}, overload {wm['overload']['p50']:.3f}/"
        f"{wm['overload']['p99']:.3f} (p50 x{degradation:.3f} under "
        f"overload)")
    log(f"serving {label} on {card_label()}: loaded rate {loaded_qps:.1f} "
        f"QPS, limit "
        f"{limit_qps:.1f}; served {out['served_qps_steady']:.1f} QPS steady, "
        f"{out['served_qps_overload']:.1f} overload; infer p50/p99/p999 "
        f"{out['infer_p50_ms']:.4f}/{out['infer_p99_ms']:.4f}/"
        f"{out['infer_p999_ms']:.4f} ms; staleness max {age_max:.4f} s "
        f"(bound {bound_s:.3f} s); shed {shed} (overload rate "
        f"{out['shed_rate_overload']:.4f}); deferred refreshes "
        f"{rep['deferred']}, unchanged pulls {rep['unchanged_pulls']}, "
        f"{rep['epoch']} epochs (last pull {rep['refresh_ms']:.3f} ms)")
    log(f"serving {label}: hot cache ({k} rows) measured hit rate "
        + (f"{measured:.4f}" if measured is not None else "none")
        + " against the sketch's estimate "
        + (f"{est_hi:.4f} (lower {est_lo:.4f})" if est_hi is not None
           else "none")
        + f"; loss {out['loss_first']:.4f} (first 16) -> "
        f"{out['loss_last']:.4f} (last 16); replica parity bit for bit "
        f"{parity}, versions {versions} (match {out['versions_match']})")
    if not (parity and out["versions_match"]):
        raise AssertionError(f"serving {label}: the replica's rows differ "
                             "from the shards'")
    if not age_max <= bound_s:
        raise AssertionError(f"serving {label}: a read served data "
                             f"{age_max:.4f} s old, over the bound")
    if not (shed["overload"] > 0 and degradation is not None
            and degradation <= 2.0):
        raise AssertionError(f"serving {label}: the overload contract "
                             f"failed (shed {shed}, degradation "
                             f"{degradation})")
    if not (np.isfinite(losses).all()
            and out["loss_last"] < out["loss_first"]):
        raise AssertionError(f"serving {label}: the loss did not fall")
    return out


def dlrm_group(name: str) -> str:
    low = name.lower()
    return ("matmul" if any(t in low for t in ("gemm", "nvjet", "cutlass",
                                               "sm90_xmma", "bmm")) else
            "gather/scatter/index" if any(t in low for t in (
                "index", "gather", "scatter")) else
            "elementwise/reduce/copy")


def serve_card_vs_cpu(dev) -> dict:
    """The first SERVE_CPU_STEPS steps on the card and on the CPU from one
    start: DLRMServing.train_step (world 1) and make_train_step."""
    from multiverso_tpu_torch.apps.dlrm_serving import DLRMServing
    from multiverso_tpu_torch.models import dlrm
    from multiverso_tpu_torch.ps.service import PSContext, PSService
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.updaters import AddOption
    cfg = dlrm.DLRMConfig(**SERVE_A)
    cat, dense, labels = dlrm.synthetic_ctr(cfg, SERVE_CPU_STEPS * 64,
                                            seed=5)

    def app_run(device):
        ctx = PSContext(0, 1, PSService(0, 1), device=device)
        try:
            app = DLRMServing(cfg, ctx=ctx, name="serve_cpu", lr=SERVE_LR,
                              start_replica=False)
            losses = [app.train_step(cat[i * 64:(i + 1) * 64],
                                     dense[i * 64:(i + 1) * 64],
                                     labels[i * 64:(i + 1) * 64])[0]
                      for i in range(SERVE_CPU_STEPS)]
            flat, _ = dlrm.flatten_mlp(app.mlp)
            out = (np.asarray(losses), app.emb.get(), flat)
            app.close()
            return out
        finally:
            ctx.close()

    def step_run():
        emb = mv.MatrixTable(dlrm.total_rows(cfg), cfg.embed_dim,
                             updater="adagrad", seed=0, init_scale=0.05,
                             name="serve_step_emb")
        flat, meta = dlrm.flatten_mlp(dlrm.init_mlp_params(cfg, 0))
        mlp = mv.ArrayTable(flat.size, updater="adagrad", init=flat,
                            name="serve_step_mlp")
        opt = AddOption(learning_rate=SERVE_LR, rho=0.1)
        step = dlrm.make_train_step(cfg, emb, mlp, meta, emb_opt=opt,
                                    mlp_opt=opt)
        es, ms = emb.state, mlp.state
        losses = []
        for i in range(SERVE_CPU_STEPS):
            sl = slice(i * 64, (i + 1) * 64)
            es, ms, loss = step(es, ms, cat[sl], dense[sl], labels[sl])
            losses.append(loss.item())
        return np.asarray(losses), emb.get(), mlp.get()

    out = {}
    for label, card, cpu in (
            ("DLRMServing.train_step", app_run(dev),
             app_run("cpu")),
            ("make_train_step", step_run(), on_cpu(step_run))):
        lrel = float(np.max(np.abs(card[0] - cpu[0]) / np.abs(cpu[0])))
        trel = [float(np.abs(a - b).max() / np.abs(b).max())
                for a, b in zip(card[1:], cpu[1:])]
        log(f"serving card vs CPU, {label} ({SERVE_CPU_STEPS} steps from one "
            f"start): losses {card[0].tolist()} vs {cpu[0].tolist()}, max "
            f"relative {lrel:.3e}; table and MLP max |diff| over max |x| "
            f"{trel[0]:.3e}, {trel[1]:.3e} (bound {SERVE_CPU_RTOL:.0e})")
        if not (lrel <= SERVE_CPU_RTOL and max(trel) <= SERVE_CPU_RTOL):
            raise AssertionError(f"serving: the card's {label} disagrees "
                                 "with the CPU's")
        out[label] = {"loss_rel": lrel, "table_rel": trel}
    return out


def serve_profile(label: str, w, bs: int) -> dict:
    """SERVE_PROFILE_STEPS train steps of ``w``'s app, one thread, the
    replica's refresh stopped: the device's busy time and idle share."""
    import torch
    app = w["app"]
    cat, dense, labels = w["data"]
    app.replica.close()

    def steps():
        for i in range(SERVE_PROFILE_STEPS):
            sl = (np.arange(bs) + i * bs) % len(labels)
            app.train_step(cat[sl], dense[sl], labels[sl])
        torch.cuda.synchronize()

    return profile(f"serving {label}, {SERVE_PROFILE_STEPS} train steps on "
                   f"{card_label()}", steps, group=dlrm_group)


def card_label() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return "no card (nvidia-smi absent)"


def serve_part_a(dev) -> dict:
    from multiverso_tpu_torch.models import dlrm
    w = serve_world(dev, "serve_a", dlrm.DLRMConfig(**SERVE_A),
                    SERVE_REFRESH_S, SERVE_BOUND_S)
    try:
        out = serve_traffic("(a) bench_serving's cell", w, SERVE_TRAIN,
                            SERVE_BOUND_S)
        out["profile"] = serve_profile("(a)", w, SERVE_TRAIN[1])
        return out
    finally:
        serve_close(w)


def serve_pull(rep) -> tuple:
    """One full snapshot pull, timed: (ms, MB/s)."""
    rep._versions, rep._gens = {}, {}   # since=-1: every shard ships
    t0 = time.perf_counter()
    rep.refresh(need_from=float("inf"))
    ms = (time.perf_counter() - t0) * 1e3
    return ms, rep.num_row * rep.num_col * 4 / 1e6 / (ms / 1e3)


def serve_part_b(dev, t_phase0: float) -> dict:
    import torch
    from multiverso_tpu_torch.models import dlrm
    from multiverso_tpu_torch.serving.replica import ReadReplica
    cfg = dlrm.DLRMConfig(**SERVE_B)
    rows = dlrm.total_rows(cfg)
    # the replica starts manual: the pull is timed before the cadence
    w = serve_world(dev, "serve_b", cfg, SERVE_REFRESH_S, 3600.0,
                    start=False)
    app = w["app"]
    out = {"rows": rows, "table_mb": rows * cfg.embed_dim * 4 / 1e6}
    try:
        rep = app.replica
        serve_pull(rep)   # warm: the first pull allocates the snapshot
        pull_ms, mbs = min(serve_pull(rep) for _ in range(2))
        rep.close()
        p = pull_ms / 1e3
        refresh_s, bound_s = max(0.2, 2 * p), max(1.0, 4 * p)
        log(f"serving (b) Kaggle widths, {rows:,} rows x {cfg.embed_dim} "
            f"f32 ({out['table_mb']:.1f} MB, its AdaGrad state as much "
            f"again, on the card): one full snapshot pull {pull_ms:.3f} ms "
            f"({mbs:.1f} MB/s); refresh_s {refresh_s:.3f}, staleness bound "
            f"{bound_s:.3f} s")
        out.update(pull_ms=pull_ms, pull_mb_per_s=mbs, refresh_s=refresh_s,
                   bound_s=bound_s)
        app.replica = ReadReplica(app.emb, admission=app.admission,
                                  cache_rows=SERVE_CACHE_ROWS,
                                  refresh_s=refresh_s, staleness_s=bound_s)
        out.update(serve_traffic("(b) Kaggle widths", w, SERVE_TRAIN_B,
                                 bound_s))
        out["profile"] = serve_profile("(b)", w, SERVE_TRAIN_B[1])
    finally:
        serve_close(w)
    torch.cuda.empty_cache()
    if time.perf_counter() - t_phase0 < SERVE_FULL_PULL_BUDGET_S:
        out["full_pull"] = serve_full_pull(dev)
    else:
        log("serving (b): the uncapped table's pull skipped: the phase is "
            "past its budget")
    return out


def serve_full_pull(dev) -> dict:
    """One snapshot pull of the uncapped Kaggle table (33,762,577 x 16
    f32, zero rows on the card; the default updater: no state)."""
    from multiverso_tpu_torch.ps.tables import AsyncMatrixTable
    from multiverso_tpu_torch.serving.replica import ReadReplica
    import torch
    rows = sum(SERVE_KAGGLE_ROWS)
    tmp, ctxs = psw_world(dev)
    try:
        ts = [AsyncMatrixTable(rows, 16, name="serve_full", ctx=c)
              for c in ctxs]
        rep = ReadReplica(ts[0], start=False, staleness_s=3600.0)
        ms, mbs = serve_pull(rep)
        rep.close()
        del ts, rep
    finally:
        for c in ctxs:
            c.close()
        tmp.cleanup()
    torch.cuda.empty_cache()
    log(f"serving (b), uncapped: one snapshot pull of {rows:,} x 16 f32 "
        f"({rows * 64 / 1e9:.2f} GB) {ms:.1f} ms ({mbs:.1f} MB/s), the "
        "first (it allocates the host snapshot)")
    return {"rows": rows, "pull_ms": ms, "mb_per_s": mbs}


def phase_serving(dev) -> dict:
    from multiverso_tpu_torch.utils import config
    t0 = time.perf_counter()
    config.set_flag("serving_snapshot_chunk_rows", SERVE_CHUNK_ROWS)
    config.set_flag("hotkeys_capacity", SERVE_HOTKEYS)
    try:
        out = {"card_vs_cpu": serve_card_vs_cpu(dev)}
        t1 = time.perf_counter()
        out["a"] = serve_part_a(dev)
        t2 = time.perf_counter()
        out["b"] = serve_part_b(dev, t0)
    finally:
        config.set_flag("serving_snapshot_chunk_rows", 4096)
        config.set_flag("hotkeys_capacity", 128)
    log(f"serving phase: {time.perf_counter() - t0:.1f} s (card vs CPU "
        f"{t1 - t0:.1f} s, part (a) {t2 - t1:.1f} s, part (b) "
        f"{time.perf_counter() - t2:.1f} s)")
    return out


# chaos: failover, faults and replay on the async plane
# (examples/chaos.py, the counterpart of tools/bench_chaos.py; no kernel
# of the port: host code, wire frames, and shard copies between the card
# and the host). (a) the four in-process scenarios at the tool's shape
# (bench_chaos.py:1276-1290): two PSContexts in this process, both shards
# on the card, AsyncMatrixTable(32, 8) with a 1 ms send window and replay
# on, max(seconds * 0.6, 8) s each. (b) ``combined`` at the tool's shape
# (:1268-1270: 64 x 8, 4 threads, 18 s): two OS processes, each shard on
# the card, the rank-1 process SIGKILLed and pool replica 0 felled at one
# instant; this process's FailoverSupervisor (timeout 2 s, poll 0.2 s,
# ranks [1]) respawns rank 1 at generation 1, which restores its newest
# committed tag before it publishes. (c) ``combined`` at the async
# plane's table, 100,000 x 128 f32 (tools/bench_async_ps.py:57): 25.6 MB
# a shard, checkpointed every 0.5 s, 51.2 MB a replica refresh; the adds
# stay 1-row adds of ones (the oracle is exact counts). Then one
# save_shard_state and one restore_shard_state of a 100,000 x 128 AdaGrad
# shard (data and one state leaf, 102.4 MB) on the card, timed, with the
# 1-row add p99 before and while saves run. Gates, as the tool's, strict
# on every run: exactly-once (no op lost, none applied twice, the final
# table equal to the acked oracle bit for bit), served reads nonzero and
# none over its bound, the spare activated, the dup/reorder injections
# nonzero and deduped; the recovery-to-90% gate alone gets one more run
# (tests/test_chaos.py:775-793).
CHAOS_SECONDS = 18.0                # bench_chaos.py:1268
CHAOS_INPROC_SECONDS = 8.0          # each in-process scenario (the CPU
#                                     smokes' length)
CHAOS_COMBINED = (64, 8, 4)         # rows, dim, threads (:1269-1270)
CHAOS_DEPLOYED = (100_000, 128, 4)  # bench_async_ps.py:57's table
CHAOS_CKPT_TABLE = (100_000, 128)   # the AdaGrad shard timed alone
CHAOS_SAVE_WINDOW_S = 3.0           # saves back to back under adds


def chaos_run(label: str, dev, fn, **kw) -> dict:
    """One scenario under the weather rule: every strict gate must hold;
    a failed recovery gate alone earns one more run."""
    for attempt in range(2):
        t0 = time.perf_counter()
        r = fn(**kw)
        r["wall_s"] = time.perf_counter() - t0
        bad = [g for g, ok in r["gates"].items() if not ok]
        strict = [g for g in bad if g != "recovery"]
        chaos_log(label, r, attempt, dev)
        if strict:
            raise AssertionError(f"chaos {label}: gates {strict} failed: "
                                 f"{r['gates']}")
        if not bad:
            return r
    raise AssertionError(f"chaos {label}: recovery to 90% failed twice: "
                         f"{r['gates']}")


def chaos_log(label: str, r: dict, attempt: int, dev) -> None:
    if "victim" in r:   # noisy_neighbor: tenants, budgets and a verdict
        v, s, tb = r["victim"], r["storm"], r["tenants_block"]
        log(f"chaos {label} (run {attempt + 1}, {r['wall_s']:.1f} s): "
            f"victim served {v['served']} shed {v['shed']} at "
            f"{v['qps_limit']} qps, p99 {v['base_p99_ms']} ms quiet -> "
            f"{v['storm_p99_ms']} ms under the storm; storm served "
            f"{s['served']} (allowed {s['allowed_at_budget']}) shed "
            f"{s['shed']} at {s['qps_limit']} qps, share "
            f"{r['storm_share']}; verdict {tb.get('verdict')}, episodes "
            f"{r['episodes']}, recorder verdicts {r['flight_verdicts']}, "
            f"open {tb.get('active')}; gates {r['gates']}")
        return
    rates = ", ".join(f"{k} {r[k]}" for k in (
        "pre_fault_ops_per_s", "post_fault_ops_per_s", "pre_fault_qps",
        "post_fault_qps") if k in r)
    slo = r.get("slo")
    if slo is not None:
        # each SLO episode: the objective, fired or cleared, its burns
        # and the judging poll's wall clock against the fault's
        t_fault = r.get("fault_wall")
        eps = "; ".join(
            f"{e['objective']} {e['kind']} burn {e['burn_fast']}/"
            f"{e['burn_slow']} at "
            + (f"{e['ts'] - t_fault:+.2f} s from the fault"
               if t_fault and e.get("ts") else f"{e.get('ts')}")
            for e in slo.get("episodes_log", [])) or "none"
        log(f"chaos {label} SLO: evals {slo['evals']}, episodes "
            f"{slo['episodes']}, firing {slo['firing']}; {eps}"
            + (f"; heal at {r['heal_wall'] - t_fault:+.2f} s"
               if t_fault and r.get("heal_wall") else ""))
    if "autoscale" in r:
        log(f"chaos {label} autoscale (dry run, mid-slow): "
            f"{r['autoscale']}")
    log(f"chaos {label} (run {attempt + 1}, {r['wall_s']:.1f} s): "
        f"recovery_s {r.get('recovery_s')}, train_recovery_s "
        f"{r.get('train_recovery_s', '-')}; {rates}; acked ops "
        f"{r['acked_ops']}, lost {r['ops_lost']}, applied twice "
        f"{r['ops_double_applied']}, parity {r['parity_bit_for_bit']}, "
        f"add errors {r['add_errors']}; replay {r.get('replay')}; "
        f"injected {r.get('injected', '-')}; serving "
        f"{r.get('serving', '-')}; gates {r['gates']}")
    if "supervisor" in r:
        v, re = r["victim_shard"], r["respawned"]
        log(f"chaos {label}: victim shard dup_frames {v.get('dup_frames')}"
            f", version {v.get('version')}, on {v.get('device')}; "
            f"supervisor {[e['phase'] for e in r['supervisor']['events']]}"
            f", detect->rejoin "
            f"{[s['detect_to_rejoin_s'] for s in r['supervisor']['spans']]}"
            f" s; respawned rank generation {re.get('gen')}, restored "
            f"{re.get('rejoin')}, on {re.get('device')}; respawns "
            f"{r['respawns']}; checkpoint saves {r['ckpt_saves']}; worker "
            f"startup {r['startup_s']} s")
        if re.get("gen") != 1 or (re.get("rejoin") or {}).get(
                "restored") != 1 or r["respawns"] != 1:
            raise AssertionError(f"chaos {label}: the respawned rank is "
                                 f"not generation 1 restored from a tag: "
                                 f"{re}, respawns {r['respawns']}")
        if dev.type not in str(v.get("device")) or dev.type not in str(
                re.get("device")):
            raise AssertionError(f"chaos {label}: a shard is not on "
                                 f"{dev.type}: {v}, {re}")


def chaos_ckpt(dev) -> dict:
    """save_shard_state / restore_shard_state of a 100,000 x 128 AdaGrad
    shard on the card, timed, the rows and the state back bit for bit;
    and the 1-row add latency before and while saves run back to back."""
    import tempfile
    import threading
    import torch
    from multiverso_tpu_torch import checkpoint
    from multiverso_tpu_torch.ps.service import PSContext, PSService
    from multiverso_tpu_torch.ps.tables import AsyncMatrixTable
    from multiverso_tpu_torch.updaters import AddOption
    rows, cols = CHAOS_CKPT_TABLE
    ctx = PSContext(0, 1, PSService(0, 1), device=dev)
    tmp = tempfile.TemporaryDirectory()
    try:
        t = AsyncMatrixTable(rows, cols, updater="adagrad", name="ckpt",
                             ctx=ctx)
        rng = np.random.default_rng(0)
        opt = AddOption(learning_rate=0.1, rho=0.1)
        for _ in range(8):
            ids = rng.choice(rows, 8192, replace=False)
            t.add_rows(ids, rng.normal(size=(8192, cols)).astype(
                np.float32), opt)
        shard = t._shard
        nbytes = 2 * rows * cols * 4
        want = t.get_rows(np.arange(rows))
        want_g = shard._ustate["g_sqr"][:rows].cpu().numpy().copy()
        t0 = time.perf_counter()
        path = checkpoint.save_shard_state(tmp.name, 0, [t])
        save_ms = (time.perf_counter() - t0) * 1e3
        t.add_rows(np.arange(4), np.ones((4, cols), np.float32), opt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = checkpoint.restore_shard_state(tmp.name, 0, [t])
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        if n != 1 or shard._data.device != shard.device or any(
                v.device != shard.device for v in shard._ustate.values()):
            raise AssertionError(f"the AdaGrad shard did not restore onto "
                                 f"{shard.device}")
        if not (np.array_equal(t.get_rows(np.arange(rows)), want)
                and np.array_equal(
                    shard._ustate["g_sqr"][:rows].cpu().numpy(), want_g)):
            raise AssertionError("the restored AdaGrad shard differs from "
                                 "the saved one")

        def adds(seconds: float) -> list:
            lat, end = [], time.perf_counter() + seconds
            one = np.ones((1, cols), np.float32)
            while time.perf_counter() < end:
                a = time.perf_counter()
                t.add_rows([int(rng.integers(rows))], one, opt)
                lat.append((time.perf_counter() - a) * 1e3)
            return lat

        quiet = adds(1.0)
        stop, saves = threading.Event(), []

        def saver():
            while not stop.is_set():
                a = time.perf_counter()
                checkpoint.save_shard_state(tmp.name, 0, [t])
                checkpoint.prune_shard_tags(tmp.name, 0, 2)
                saves.append((time.perf_counter() - a) * 1e3)

        th = threading.Thread(target=saver, daemon=True)
        th.start()
        busy = adds(CHAOS_SAVE_WINDOW_S)
        stop.set()
        th.join(timeout=60)
    finally:
        ctx.close()
        tmp.cleanup()
    out = {"rows": rows, "cols": cols, "mb": nbytes / 1e6,
           "save_ms": save_ms, "save_mb_per_s": nbytes / 1e6 / (save_ms /
                                                               1e3),
           "restore_ms": restore_ms,
           "restore_mb_per_s": nbytes / 1e6 / (restore_ms / 1e3),
           "add_p50_ms_quiet": float(np.percentile(quiet, 50)),
           "add_p99_ms_quiet": float(np.percentile(quiet, 99)),
           "add_p50_ms_saving": float(np.percentile(busy, 50)),
           "add_p99_ms_saving": float(np.percentile(busy, 99)),
           "adds_saving": len(busy), "saves": len(saves),
           "save_ms_under_adds": float(np.median(saves)) if saves else None}
    log(f"chaos checkpoint: a {rows:,} x {cols} AdaGrad shard on {dev} "
        f"(data + g_sqr, {out['mb']:.1f} MB): save_shard_state "
        f"{save_ms:.1f} ms ({out['save_mb_per_s']:.0f} MB/s, {path}), "
        f"restore_shard_state {restore_ms:.1f} ms "
        f"({out['restore_mb_per_s']:.0f} MB/s), rows and state back bit "
        f"for bit; 1-row add p50/p99 {out['add_p50_ms_quiet']:.3f}/"
        f"{out['add_p99_ms_quiet']:.3f} ms quiet, "
        f"{out['add_p50_ms_saving']:.3f}/{out['add_p99_ms_saving']:.3f} "
        f"ms while {len(saves)} saves ran (median "
        f"{out['save_ms_under_adds']} ms each)")
    return out


def phase_chaos(dev) -> dict:
    from multiverso_tpu_torch.examples import chaos
    from multiverso_tpu_torch.utils import config
    keys = ("ps_replay", "ps_timeout", "ps_connect_timeout",
            "ps_reconnect_backoff", "ps_replay_backoff",
            "ps_replay_backoff_cap", "ps_health_timeout")
    saved = {k: config.get_flag(k) for k in keys}
    lap = Laps("chaos")
    out = {}
    try:
        for name, fn in chaos.SCENARIOS.items():
            out[name] = chaos_run(f"(a) {name}", dev, fn,
                                  seconds=CHAOS_INPROC_SECONDS,
                                  device=dev)
            lap(f"(a) {name}")
        # the worker processes resolve the card themselves
        wdev = None if dev.type == "cuda" else str(dev)
        rows, dim, threads = CHAOS_COMBINED
        out["combined"] = chaos_run(
            f"(b) combined {rows} x {dim}", dev, chaos.scenario_combined,
            seconds=CHAOS_SECONDS, rows=rows, dim=dim, threads=threads,
            device=wdev)
        lap("(b) combined")
        rows, dim, threads = CHAOS_DEPLOYED
        log(f"chaos (c): {rows:,} x {dim} f32, {rows // 2 * dim * 4 / 1e6:.1f}"
            f" MB a shard on the card, a replica refresh "
            f"{rows * dim * 4 / 1e6:.1f} MB")
        out["deployed"] = chaos_run(
            f"(c) combined {rows:,} x {dim}", dev, chaos.scenario_combined,
            seconds=CHAOS_SECONDS, rows=rows, dim=dim, threads=threads,
            device=wdev)
        lap("(c) combined")
        out["checkpoint"] = chaos_ckpt(dev)
        lap("checkpoint")
    finally:
        for k, v in saved.items():
            config.set_flag(k, v)
    return out


# ps_native: the native C++ transport of the async plane
# (``ps/native.py`` over ``csrc/mv_ps.cpp``: host C++ built with g++ at
# first use, no kernel of the card) against the Python wire plane, on
# examples/ps_bench.py's cell (tools/bench_async_ps.py:57: a 100,000 x
# 128 f32 AsyncMatrixTable, the default updater, wire none, 1,024-row
# batches strided over both owners, each rank's client adding (at most 4
# in flight) and timing a get of its rows for PSN_SECONDS):
# (a) both ranks in this process with their shards on the card, once per
# plane. A card shard never registers with the C++ server, so on the
# native plane every op the server receives punts to Python; what the
# native plane changes there is the client (counted adds, gets scattered
# into the result in C, one socket to the local rank too);
# (b) the same with the shards on the CPU (``device="cpu"``, the JAX
# package's CPU parameter host): the shards register, and C++ serves every
# add and get with no Python in the loop;
# (c) one rank per OS process (examples/ps_bench.py), card shards, each
# plane: in one process the two ranks share one interpreter lock, here
# each has its own;
# then a bf16-wire table (ps_async (a)'s check), which punts on the native
# server. Each part asserts the plane it claims to measure, and every
# full Get equals the numpy model of the same f32 adds bit for bit
PSN_SECONDS = 1.0   # cut from 2 to keep the script in its time
PSN_PLANES = ("native", "python")
PSN_TIMEOUT = 180
PSN_BUILD: dict = {}   # the library's first build and load (main)


def psn_build() -> dict:
    """Build and load ``csrc/mv_ps.cpp`` (the first use in this run);
    its path and seconds."""
    from multiverso_tpu_torch.ps import native as ps_native
    t0 = time.perf_counter()
    if not ps_native.available():
        raise AssertionError("the native PS library did not build from "
                             "csrc/mv_ps.cpp")
    PSN_BUILD.update(path=str(ps_native.library_path()),
                     seconds=time.perf_counter() - t0)
    log(f"ps_native library {PSN_BUILD['path']}: "
        f"{PSN_BUILD['seconds']:.1f} s (build and load)")
    return PSN_BUILD


def psn_inproc(plane: str, shard_dev) -> dict:
    """Two ranks in this process, shards on ``shard_dev``, on ``plane``:
    both clients at once for PSN_SECONDS, the full Gets against numpy, and
    the plane asserted (the client's conns, the server, registration)."""
    import tempfile
    import threading
    from multiverso_tpu_torch.examples import ps_bench as pb
    from multiverso_tpu_torch.ps.native import NativeConn
    from multiverso_tpu_torch.ps.service import (FileRendezvous, PSContext,
                                                 PSService)
    from multiverso_tpu_torch.ps.tables import AsyncMatrixTable
    from multiverso_tpu_torch.utils import config
    native = plane == "native"
    on_card = str(shard_dev).startswith("cuda")
    where = "card" if on_card else "CPU"
    label = f"ps_native shards on the {where}, {plane} plane"
    config.set_flag("ps_native", native)
    with tempfile.TemporaryDirectory() as rdv_dir:
        rdv = FileRendezvous(rdv_dir)
        ctxs = [PSContext(r, 2, PSService(r, 2, rdv), device=shard_dev)
                for r in range(2)]
        try:
            ts = [AsyncMatrixTable(pb.ROWS, pb.DIM, name="psn", ctx=c)
                  for c in ctxs]
            ids = [pb.strided_ids(r) for r in range(2)]
            vals = [pb.rank_values(r) for r in range(2)]
            for r in range(2):   # warm: one add and one get a rank
                ts[r].add_rows(ids[r], vals[r])
                ts[r].get_rows(ids[r])
            runs = [None, None]

            def client(r):
                runs[r] = pb.drive(ts[r], ids[r], vals[r], PSN_SECONDS)

            t0 = time.perf_counter()
            th = [threading.Thread(target=client, args=(r,))
                  for r in range(2)]
            for t in th:
                t.start()
            for t in th:
                t.join(timeout=PSN_SECONDS + PSN_TIMEOUT)
                if t.is_alive():
                    raise AssertionError(f"{label}: a client did not "
                                         "finish")
            dt = time.perf_counter() - t0
            counts = [runs[r][0] + 1 for r in range(2)]   # + the warm add
            want = pb.model([(ids[r], vals[r], counts[r])
                             for r in range(2)])
            for r in range(2):
                if not np.array_equal(ts[r].get(), want):
                    raise AssertionError(f"{label}: rank {r}'s full Get is "
                                         "not the numpy model's")
            stats = [t._shard.stats() for t in ts]
            conns = [c.service.native_conns() for c in ctxs]
            # the plane this part claims to measure
            for r in range(2):
                if ts[r]._native_ok != native:
                    raise AssertionError(f"{label}: rank {r}'s table took "
                                         "the other client plane")
                if (ctxs[r].service._native is not None) != native:
                    raise AssertionError(f"{label}: rank {r}'s native "
                                         "server is " + ("down" if native
                                                         else "up"))
                if native and not (conns[r] and all(
                        isinstance(c, NativeConn) for c in conns[r])):
                    raise AssertionError(f"{label}: rank {r}'s client "
                                         "holds no NativeConn")
                registered = ts[r]._shard._native_ref is not None
                if registered != (native and not on_card):
                    raise AssertionError(
                        f"{label}: rank {r}'s shard is "
                        + ("" if registered else "not ")
                        + "registered with the C++ server")
                if native and on_card and stats[r]["native_applies"]:
                    raise AssertionError(f"{label}: C++ applied an add to "
                                         "a shard on the card")
                if native and not on_card and (
                        stats[r]["native_applies"] != sum(counts)
                        or ts[r]._shard._stat_adds != 0):
                    raise AssertionError(
                        f"{label}: rank {r}'s shard applied "
                        f"{stats[r]['native_applies']} adds in C++ and "
                        f"{ts[r]._shard._stat_adds} in Python; every one "
                        f"of the {sum(counts)} belongs to C++")
            lat = np.concatenate([np.asarray(runs[r][1]) for r in range(2)])
            adds = sum(runs[r][0] for r in range(2))
            res = {"plane": plane, "shards": where,
                   "adds_per_sec": adds / dt,
                   "gets_per_sec": lat.size / dt,
                   "get_p50_ms": float(np.percentile(lat, 50)),
                   "get_p99_ms": float(np.percentile(lat, 99)),
                   "adds": adds, "gets": int(lat.size), "seconds": dt,
                   "native_applies": [st["native_applies"]
                                      for st in stats],
                   "python_adds": [t._shard._stat_adds for t in ts],
                   "registered": [t._shard._native_ref is not None
                                  for t in ts]}
            log(f"{label}: {adds} adds and {lat.size} gets of {pb.BATCH} "
                f"rows in {dt:.3f} s summed over 2 ranks: "
                f"{res['adds_per_sec']:.1f} adds/s, "
                f"{res['gets_per_sec']:.1f} gets/s, Get p50 "
                f"{res['get_p50_ms']:.3f} ms, p99 {res['get_p99_ms']:.3f} "
                f"ms; shard adds applied in C++ {res['native_applies']}, "
                f"in Python {res['python_adds']}, registered "
                f"{res['registered']}; full Gets = numpy bit for bit "
                f"({card_label()})")
            return res
        finally:
            for c in ctxs:
                c.close()


def psn_processes(dev, plane: str) -> dict:
    """Part (c): examples/ps_bench.py's two ranks as two OS processes on
    this card, on ``plane``: adds/s and the Get p50/p99 per rank and
    summed; rank 0's full Get against numpy, bit for bit."""
    import tempfile
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as rdv:
        cmd = [sys.executable, "-m", "multiverso_tpu_torch.examples.ps_bench",
               "--rdv", rdv, "--world", "2", "--seconds", str(PSN_SECONDS),
               "--plane", plane, "--device", str(dev),
               "--timeout", str(PSN_TIMEOUT)]
        procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=repo,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for r in range(2)]
        try:
            outs = [p.communicate(timeout=PSN_TIMEOUT) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    results = []
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        lines = [l for l in so.splitlines() if l.startswith("RESULT ")]
        if p.returncode != 0 or not lines:
            raise AssertionError(f"ps_native rank {r} ({plane}) failed "
                                 f"({p.returncode}):\n{so[-2000:]}\n"
                                 f"{se[-3000:]}")
        results.append(json.loads(lines[-1][len("RESULT "):]))
    native = plane == "native"
    # shards on the card never register; on the CPU (a rehearsal) they do
    registers = native and not str(dev).startswith("cuda")
    for res in results:
        if (res["native_client"] != native or res["native_server"] != native
                or res["registered"] != registers
                or bool(res["native_applies"]) != registers):
            raise AssertionError(f"ps_native processes, {plane} plane: rank "
                                 f"{res['rank']} ran another plane: {res}")
        log(f"ps_native processes, {plane} plane, rank {res['rank']} (shards "
            f"on {res['device']}): {res['adds']} adds and {res['gets']} "
            f"gets in {res['seconds']:.3f} s: {res['adds_per_sec']:.1f} "
            f"adds/s, Get p50 {res['get_p50_ms']:.3f} ms, p99 "
            f"{res['get_p99_ms']:.3f} ms ({card_label()})")
    if not results[0].get("exact"):
        raise AssertionError(f"ps_native processes, {plane} plane: the full "
                             "Get is not the numpy model's")
    summed = {"adds_per_sec": sum(r["adds_per_sec"] for r in results),
              "gets_per_sec": sum(r["gets_per_sec"] for r in results)}
    log(f"ps_native processes, {plane} plane, summed over 2 ranks: "
        f"{summed['adds_per_sec']:.1f} adds/s, {summed['gets_per_sec']:.1f} "
        f"gets/s; rank 0's full Get = numpy bit for bit ({card_label()})")
    return {"ranks": results, **summed}


def phase_ps_native(dev) -> dict:
    """The native transport against the Python plane: (a) card shards in
    this process, (b) CPU shards in this process, (c) one rank per OS
    process, each plane; then a bf16-wire table that punts."""
    from multiverso_tpu_torch.utils import config
    saved = config.get_flag("ps_native")
    t0 = time.perf_counter()
    out = {"library": psn_build() if not PSN_BUILD else dict(PSN_BUILD)}
    log(f"ps_native library {out['library']['path']}, built in "
        f"{out['library']['seconds']:.1f} s at its first use")
    try:
        out["card"] = {p: psn_inproc(p, dev) for p in PSN_PLANES}
        t1 = time.perf_counter()
        out["cpu"] = {p: psn_inproc(p, "cpu") for p in PSN_PLANES}
        t2 = time.perf_counter()
        out["processes"] = {p: psn_processes(dev, p) for p in PSN_PLANES}
        t3 = time.perf_counter()
        config.set_flag("ps_native", True)
        bf16 = psa_plane(dev, configs=(("default", "bf16"),))
        res = bf16["default, wire bf16"]
        if not res["native_server"] or res["native_client"] or any(
                res["native_applies"]):
            raise AssertionError(f"ps_native bf16: not the native server's "
                                 f"punt path: {res}")
        out["bf16"] = res
    finally:
        config.set_flag("ps_native", saved)
    for part in ("card", "cpu", "processes"):
        n, p = out[part]["native"], out[part]["python"]
        log(f"ps_native {part}: native / python adds/s "
            f"{n['adds_per_sec'] / p['adds_per_sec']:.2f}x, gets/s "
            f"{n['gets_per_sec'] / p['gets_per_sec']:.2f}x"
            + (f", Get p50 {n['get_p50_ms']:.3f} vs {p['get_p50_ms']:.3f} ms"
               if "get_p50_ms" in n else "")
            + f" ({card_label()})")
    log(f"ps_native phase: {time.perf_counter() - t0:.1f} s ((a) card "
        f"{t1 - t0:.1f} s, (b) CPU {t2 - t1:.1f} s, (c) processes "
        f"{t3 - t2:.1f} s, bf16 {time.perf_counter() - t3:.1f} s)")
    return out


# telemetry: the per-process telemetry plane (telemetry/, utils/profiling,
# tools/; no kernel of its own: its device readings come from torch.cuda
# and torch.profiler). (a) reads ps_async (b)'s WE world-2 run, whose
# measured epoch ran under the step profiler, and holds it on the real
# text to tools/bench_we_async.py:150-186's in-run bounds; (b) one train
# step of the 472M LM (batch 2, seq 1024, bf16) under
# utils.profiling.trace; (c) ps_bench's cell (tools/bench_async_ps.py:57,
# 100,000 x 128) in two processes with trace IDs and the exporter on, on
# the Python plane (the native fast path is untraced by design); (d)
# chaos (b)'s combined run's dumps; (e) the always-on flight recorder's
# cost on the hot paths, beside the last figures PERF.md §5 records
# before the recorder rode them (the windowed 1-row add p50, the native
# plane's rates and Get p50s, the serving write-p50 ratio under
# overload) — notes, not gates.
TEL_CORPUS = "realtext"         # bench.py's PS cell: the real text
TEL_METRICS_INTERVAL_S = 0.5
TEL_PSB_SECONDS = 2.0
TEL_PREVIOUS = {
    "window_add_p50_ms": 0.031,
    "native_adds_per_s": {"card": 133.9, "cpu": 927.2, "processes": 275.4},
    "python_adds_per_s": {"card": 166.8, "cpu": 136.1, "processes": 297.0},
    "native_get_p50_ms": {"card": 11.288, "cpu": 1.005},
    "python_get_p50_ms": {"card": 10.239, "cpu": 12.247},
    "serving_write_p50_ratio": 0.80,
}


def tel_we_profile(we_world2: dict) -> dict:
    """(a): each rank's step-profile block, printed for both corpora,
    then held on the real text to the JAX bench's bounds."""
    from multiverso_tpu_torch.examples import we_async
    out = {}
    for corpus, run in we_world2.items():
        for res in run["ranks"]:
            p = res["profile"]
            if not p:
                raise AssertionError(f"telemetry (a): rank {res['rank']} "
                                     f"({corpus}) has no profile block")
            ph = p["phase_ms_per_step"]
            log(f"telemetry (a) WE world 2, {corpus}, rank {res['rank']} "
                f"on {card_label()}: {p['steps']} steps, "
                f"{p['wall_ms_per_step']:.2f} ms a step; phase ms a step "
                + ", ".join(f"{k} {ph.get(k, 0.0):.2f}" for k in (
                    "prepare", "ps_wait", "compute", "push", "io_wait"))
                + f" (all: {ph}); async spans ms a step "
                f"{p['async_ms_per_step']}; attributed "
                f"{p['attributed_fraction']:.4f}, stall "
                f"{p['stall_fraction']:.4f}, overlap "
                f"{p['overlap_ms_per_step']:.2f} ms; prepare dominates "
                f"{p['prepare_dominates']}; steady rebuilds "
                f"{p['steady_recompiles']}, builds {p['compiles']}, "
                f"{p['transfer_mb']} MB uploaded")
            out.setdefault(corpus, []).append(p)
    for p in out[TEL_CORPUS]:
        we_async.check_profile(p)
    log(f"telemetry (a): both ranks on the {TEL_CORPUS} corpus hold "
        f"attributed >= {we_async.ATTRIBUTED_FRACTION_FLOOR}, stall < "
        f"{we_async.STALL_FRACTION_CEILING} and 0 steady rebuilds")
    return out


def tel_lm_trace(dev, layers: int) -> dict:
    """(b): the 472M LM in one ArrayTable (the ledger's gauge = its
    bytes, the census at least that on the card), then one train step
    under profiling.trace, whose Chrome trace names B1-B3."""
    import tempfile
    import torch
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.models import transformer as tfm
    from multiverso_tpu_torch.ops import attention_kernels as ak
    from multiverso_tpu_torch.telemetry import devstats, memstats
    from multiverso_tpu_torch.utils import profiling

    cfg = lm_config(layers)
    t0 = time.perf_counter()
    shared = mv.SharedPytree(lm_init_params(layers), name="tel_lm")
    torch.cuda.synchronize()
    data = shared.table.raw()
    nbytes = data.numel() * data.element_size()
    gauge = memstats.LEDGER.snapshot()["components"]["table[tel_lm]"]
    census = memstats.device_census()
    rollup = devstats.device_rollup()
    on_card = {g["device"]: g["bytes"] for g in census["top"]}
    log(f"telemetry (b) the LM's table: {shared.table.size} f32, "
        f"{nbytes} bytes on {data.device} ({time.perf_counter() - t0:.1f} s"
        f" to build); ledger table[tel_lm] {gauge}; census {census['bytes']}"
        f" bytes in {census['arrays']} live blocks over {census['groups']} "
        f"device(s), cuda:0 {on_card.get('cuda:0')}; rollup {rollup}")
    if gauge["table_bytes"] != nbytes:
        raise AssertionError(f"telemetry (b): the ledger's gauge "
                             f"{gauge['table_bytes']} != the table's "
                             f"{nbytes} bytes")
    if not (on_card.get("cuda:0", 0) >= nbytes
            and rollup["cuda:0"]["bytes"] >= nbytes):
        raise AssertionError(f"telemetry (b): the census holds fewer than "
                             f"the table's {nbytes} bytes on cuda:0")
    model = tfm.params_from_jax(shared.get(), cfg, dev)
    del shared, data
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (BATCH, cfg.max_seq + 1))).to(dev)
    tok, tgt = toks[:, :-1], toks[:, 1:]
    sgd = tfm.make_train_step(cfg, LR)
    float(sgd(model, tok, tgt))   # warm, outside the trace
    before = ak.launch_counts()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        with profiling.trace("lm_train_step", trace_dir=d) as path:
            with profiling.annotate("lm.train_step"):
                loss = float(sgd(model, tok, tgt))
        traced_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    step = {k: v - before[k] for k, v in ak.launch_counts().items()}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    found, dev_us = {}, {}
    for fn, key in (("flash_fwd_wgmma", "flash_fwd"),
                    ("flash_bwd_dq_wgmma", "flash_bwd_dq"),
                    ("flash_bwd_dkv_wgmma", "flash_bwd_dkv")):
        hits = [e for e in kernels if fn in e.get("name", "")]
        found[key] = len(hits)
        dev_us[key] = sum(float(e.get("dur", 0.0)) for e in hits)
    marks = [e for e in events if e.get("name") == "lm.train_step"]
    busy_us = sum(float(e.get("dur", 0.0)) for e in kernels)
    log(f"telemetry (b) one LM train step under profiling.trace: loss "
        f"{loss:.5f}, {traced_s:.2f} s with the trace's export, {size} "
        f"bytes, {len(events)} events, {len(kernels)} kernels "
        f"({busy_us / 1e3:.3f} ms of device time); the flash kernels by "
        f"CUDA function {found} ({ {k: round(v / 1e3, 3) for k, v in dev_us.items()} } ms)"
        f", the wrappers counted {step}; annotate regions {len(marks)}")
    if not (found == step == {k: layers for k in step}):
        raise AssertionError(f"telemetry (b): the trace holds {found} flash "
                             f"kernels, the wrappers counted {step}, one "
                             f"step launches {layers} of each")
    if not marks:
        raise AssertionError("telemetry (b): the annotate region is not in "
                             "the trace")
    del model
    torch.cuda.empty_cache()
    return {"ledger_bytes": gauge["table_bytes"], "table_bytes": nbytes,
            "census_bytes": census["bytes"], "kernels": found,
            "kernel_ms": {k: v / 1e3 for k, v in dev_us.items()},
            "busy_ms": busy_us / 1e3, "trace_bytes": size}


def tel_exporter(dev) -> dict:
    """(c): two ps_bench processes with trace IDs and the exporter on;
    every metrics record and .prom file reads with the port's
    dump_metrics, and each client's adds stitch to the other rank's
    serve and apply by trace id."""
    import tempfile
    from multiverso_tpu_torch.telemetry import exporter
    from multiverso_tpu_torch.tools import dump_metrics
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        mdir = os.path.join(tmp, "metrics")
        cmd = [sys.executable, "-m", "multiverso_tpu_torch.examples.ps_bench",
               "--rdv", os.path.join(tmp, "rdv"), "--seconds",
               str(TEL_PSB_SECONDS), "--plane", "python", "--telemetry",
               mdir, "--device", str(dev)]
        procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=repo,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for r in range(2)]
        try:
            outs = [p.communicate(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        res = []
        for r, (p, (so, se)) in enumerate(zip(procs, outs)):
            lines = [l for l in so.splitlines() if l.startswith("RESULT ")]
            if p.returncode != 0 or not lines:
                raise AssertionError(f"telemetry (c) rank {r} failed "
                                     f"({p.returncode}):\n{se[-3000:]}")
            res.append(json.loads(lines[-1][len("RESULT "):]))
        out = {"ranks": res, "records": {}, "prom_samples": {},
               "spans": {}}
        spans = {}
        for r in range(2):
            recs = dump_metrics.load_records(
                os.path.join(mdir, f"metrics-rank{r}.jsonl"))
            for rec in recs:
                dump_metrics.format_record(rec)
            prom = dump_metrics.load_prom(
                os.path.join(mdir, f"metrics-rank{r}.prom"))
            with open(os.path.join(mdir, f"metrics-rank{r}.prom")) as f:
                text = f.read()
            if text != exporter.prometheus_text(recs[-1]):
                raise AssertionError(f"telemetry (c): rank {r}'s .prom is "
                                     "not its last record's text")
            # the exporter starts with the service, before the table
            # exists: the shard is in the last record (written at close)
            if not (all(rec.get("rank") == r and "memory" in rec
                        for rec in recs)
                    and "ps_bench" in recs[-1].get("shards", {})):
                raise AssertionError(f"telemetry (c): rank {r}'s records "
                                     "miss their rank, memory or shard")
            with open(os.path.join(mdir, f"trace-rank{r}.jsonl")) as f:
                spans[r] = [json.loads(l) for l in f]
            out["records"][r] = len(recs)
            out["prom_samples"][r] = len(prom)
            out["spans"][r] = len(spans[r])
    stitched = {}
    for client, owner in ((0, 1), (1, 0)):
        adds = {e["args"]["trace"] for e in spans[client]
                if e["name"] == "client.add_rows"}
        by_name = {}
        for e in spans[owner]:
            t = e["args"].get("trace")
            if t in adds:
                by_name.setdefault(e["name"], set()).add(t)
        chain = (by_name.get("ps.serve", set())
                 & (by_name.get("shard.apply", set())
                    | by_name.get("shard.wave_apply", set())))
        stitched[client] = {"adds": len(adds), "reached_serve_and_apply":
                            len(chain), "owner_spans": sorted(by_name)}
        if not (adds and chain):
            raise AssertionError(f"telemetry (c): rank {client}'s traced "
                                 f"adds do not reach rank {owner}'s serve "
                                 f"and apply: {stitched[client]}")
    out["stitched"] = stitched
    log(f"telemetry (c) ps_bench with trace IDs and the exporter "
        f"({TEL_METRICS_INTERVAL_S} s) on {card_label()}: adds/s "
        f"{[round(r['adds_per_sec'], 1) for r in res]}, Get p50 "
        f"{[round(r['get_p50_ms'], 3) for r in res]} ms; metrics records "
        f"{out['records']}, .prom samples {out['prom_samples']}, all read "
        f"by dump_metrics; spans {out['spans']}; traced adds reaching the "
        f"owner's serve and apply {stitched}")
    return out


def tel_postmortem(combined: dict) -> dict:
    """(d): chaos (b)'s dumps: the survivor's names the killed rank with
    its unacked requests, and the port's postmortem merges them all."""
    import contextlib
    import glob
    import io
    from multiverso_tpu_torch.tools import postmortem
    fr = combined["flightrec_dir"]
    paths = sorted(glob.glob(os.path.join(fr, "gen*",
                                          "flightrec-rank*.jsonl")))
    survivor = os.path.join(fr, "gen0", "flightrec-rank0.jsonl")
    if survivor not in paths:
        raise AssertionError(f"telemetry (d): the survivor left no dump "
                             f"(found {paths})")
    d0 = postmortem.load_dump(survivor)
    unacked = [r for r in d0["inflight"] if r.get("peer") == 1]
    deaths = [e for e in d0["events"] if e.get("ev") == "peer.dead"
              and e.get("peer") == 1]
    suspects = postmortem.dead_suspects([d0])
    log(f"telemetry (d) chaos (b)'s survivor dump: reason "
        f"{d0['header'].get('reason')!r}, {len(d0['events'])} events, "
        f"{len(d0['inflight'])} in flight ({len(unacked)} to rank 1), "
        f"peer.dead of rank 1 {len(deaths)}; suspects {suspects}")
    if not (unacked and any(s["rank"] == 1 for s in suspects)):
        raise AssertionError("telemetry (d): the survivor's dump does not "
                             "name the killed rank 1 with its unacked "
                             "requests")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = postmortem.main(sorted({os.path.dirname(p) for p in paths})
                             + ["--json"])
    rep = json.loads(buf.getvalue())
    log(f"telemetry (d) postmortem over {len(paths)} dump(s): ranks "
        f"{rep['ranks']}, {len(rep['timeline'])} timeline records, "
        f"recovery {rep['recovery']}")
    if rc != 0 or 0 not in rep["ranks"]:
        raise AssertionError(f"telemetry (d): postmortem failed ({rc})")
    return {"dumps": len(paths), "unacked_to_1": len(unacked),
            "ranks": rep["ranks"]}


def tel_cost(later: dict) -> dict:
    """(e): the hot paths with the always-on recorder, beside the figures
    PERF.md recorded before it rode them (notes, not gates)."""
    win = min(p["on_p50_ms"] for p in later["ps_window"]["small_add"]
              ["passes"])
    out = {"window_add_p50_ms": win, "native_adds_per_s": {},
           "python_adds_per_s": {}, "native_get_p50_ms": {},
           "python_get_p50_ms": {}}
    for part in ("card", "cpu", "processes"):
        for plane in ("native", "python"):
            r = later["ps_native"][part][plane]
            out[f"{plane}_adds_per_s"][part] = r["adds_per_sec"]
            if "get_p50_ms" in r and part != "processes":
                out[f"{plane}_get_p50_ms"][part] = r["get_p50_ms"]
    out["serving_write_p50_ratio"] = later["serving"]["a"]["degradation_x"]
    log(f"telemetry (e) always-on cost on {card_label()}, now (the figure "
        f"before the recorder): windowed 1-row add p50 {win:.4f} ms "
        f"({TEL_PREVIOUS['window_add_p50_ms']}); "
        + "; ".join(
            f"{k} " + ", ".join(
                f"{p} {v:.3f} ({TEL_PREVIOUS[k][p]})"
                for p, v in out[k].items())
            for k in ("native_adds_per_s", "python_adds_per_s",
                      "native_get_p50_ms", "python_get_p50_ms"))
        + f"; serving (a) write p50 under overload "
        f"x{out['serving_write_p50_ratio']:.3f} "
        f"({TEL_PREVIOUS['serving_write_p50_ratio']})")
    return out


# cluster: the cluster telemetry plane (telemetry/aggregator.py,
# signals.py, slo.py, tenants.py; tools/mvtop.py and mvautoscale.py; host
# code, no kernel of the card). (a) Two ranks in this process on
# ps_async (a)'s 100,000 x 128 plane, the service starting rank 0's
# poller itself (stats_poll_interval_s 0.5, metrics_dir set): Zipf-hot
# traffic from CLU_THREADS client threads, then the record against the
# shards' stats() exactly, the merged monitors against the ranks' own,
# the planted hot rows in the top-K, the windowed skew of uniform and
# of rank-1-only traffic, the rates against the shards' deltas, and the
# jsonl/prom files; card shards on the Python plane, card shards on the
# native plane (the C++ server punts them), CPU shards on the native
# plane (C++ serves). (b) Four ranks, one a process (ps_bench, card
# shards), read from other processes by mvtop --once --json and
# mvautoscale --dry-run. (c) Two tenants on card shards: their ops
# metered exactly, and tenant_add_qps deferring the over-budget one.
# (d) The costs: a poll's wall time at world 2 and 4, the jsonl bytes a
# record, and the 1-row add p50/p99 with the poller at 0.5 s against
# off, in turns (printed, not gated)
CLU_TABLE = (100_000, 128)
CLU_HOT = (7, 11, 50_003, 50_011)   # planted hot rows, two a rank
CLU_SECONDS = 4.0                   # the first run's traffic
CLU_SECONDS_OTHER = 2.0             # the other two planes' traffic
CLU_THREADS = 4
CLU_BATCH = 8
CLU_POLL_S = 0.5
CLU_SKEW_S = 1.0                    # each windowed-skew phase
CLU_POLLS_TIMED = 20
CLU_W4_SECONDS = 6.0                # the world of 4's drive after warm-up
# a reader of part (b): started beside the ranks, so that its imports
# overlap their start-up, it waits for every rank's warm mark and then
# runs the tool's main with the remaining arguments
CLU_READER = """
import importlib, os, sys, time
tool = importlib.import_module(sys.argv[1])
rdv, world, end = sys.argv[2], int(sys.argv[3]), time.monotonic() + float(
    sys.argv[4])
while not all(os.path.exists(os.path.join(rdv, f"ps_bench_warm.{r}"))
              for r in range(world)):
    if time.monotonic() > end:
        sys.exit(f"{sys.argv[1]}: the ranks never warmed up")
    time.sleep(0.05)
sys.exit(tool.main(sys.argv[5:]))
"""
CLU_TENANT_QPS = 20.0
CLU_STORM_S = 2.0
CLU_COST_TURNS = 3                  # poller on/off turns, each
CLU_COST_TURN_S = 1.0


def clu_traffic(table, seconds: float, pick, threads: int = CLU_THREADS
                ) -> int:
    """``threads`` clients adding to and reading batches of
    ``pick(rng)`` rows for ``seconds``; the ops issued."""
    import threading
    counts = [0] * threads
    stop = time.perf_counter() + seconds
    dim = table.num_col

    def run(j):
        rng = np.random.default_rng(1000 + j)
        vals = np.full((CLU_BATCH, dim), 0.01 * (j + 1), np.float32)
        while time.perf_counter() < stop:
            ids = np.unique(pick(rng))
            table.add_rows(ids, vals[:ids.size])
            table.get_rows(ids)
            counts[j] += 2

    th = [threading.Thread(target=run, args=(j,)) for j in range(threads)]
    for t in th:
        t.start()
    for t in th:
        t.join(timeout=seconds + 120)
        if t.is_alive():
            raise AssertionError("cluster: a traffic thread did not finish")
    table.flush()
    return sum(counts)


def clu_pick_zipf(rows: int):
    hot = np.asarray(CLU_HOT)

    def pick(rng):
        ids = rng.integers(0, rows, CLU_BATCH)
        m = rng.random(CLU_BATCH) < 0.6
        ids[m] = hot[rng.integers(0, hot.size, int(m.sum()))]
        return ids
    return pick


def clu_sums(ctxs, name: str) -> dict:
    st = [c.service._shards[name].stats() for c in ctxs]
    return {k: sum(int(s.get(k) or 0) for s in st)
            for k in ("adds", "applies", "gets", "get_bytes", "add_bytes")}


def clu_probe_merge(service, world: int):
    """One poll through ``service``'s one-shot probes, the raw per-rank
    payloads kept: (stats, merged record)."""
    from multiverso_tpu_torch.telemetry import aggregator

    def probe_one(r, stats, health):
        health[r] = service.health(r)
        stats[r] = service.stats_oneshot(r)

    stats, health = aggregator.probe_all(range(world), probe_one, 30.0)
    return stats, aggregator.merge_cluster(stats, health, world=world)


def clu_check_monitors(stats: dict, rec: dict, label: str) -> int:
    """Each merged monitor's count against the sum over the answering
    processes (ranks of one process report one registry: counted once)."""
    seen, want = set(), {}
    for r in sorted(stats):
        st = stats[r]
        key = ((st.get("addr") or "").rsplit(":", 1)[0], st.get("pid"))
        if key in seen:
            continue
        seen.add(key)
        for name, m in st.get("monitors", {}).items():
            want[name] = want.get(name, 0) + int(m.get("count") or 0)
    got = {n: m["count"] for n, m in rec["monitors"].items()}
    if got != want:
        bad = {n: (got.get(n), want.get(n)) for n in set(got) | set(want)
               if got.get(n) != want.get(n)}
        raise AssertionError(f"{label}: merged monitor counts are not the "
                             f"ranks' sums: {bad}")
    return len(got)


def clu_pcts(ms) -> dict:
    a = np.asarray(ms, np.float64)
    return {"n": int(a.size), "p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99))}


def clu_world2(shard_dev, plane: str, seconds: float, full: bool) -> dict:
    """Part (a) on one plane; ``full`` adds the skew phases and part
    (d)'s poll and add costs."""
    import tempfile
    from multiverso_tpu_torch.ps.service import (FileRendezvous, PSContext,
                                                 PSService)
    from multiverso_tpu_torch.ps.tables import AsyncMatrixTable
    from multiverso_tpu_torch.telemetry import aggregator
    from multiverso_tpu_torch.tools import dump_metrics
    from multiverso_tpu_torch.utils import config
    where = "card" if str(shard_dev).startswith("cuda") else "CPU"
    label = f"cluster (a) shards on the {where}, {plane} plane"
    rows, dim = CLU_TABLE
    out = {"plane": plane, "shards": where}
    with tempfile.TemporaryDirectory() as tmp:
        mdir = os.path.join(tmp, "metrics")
        config.set_flag("ps_native", plane == "native")
        config.set_flag("stats_poll_interval_s", CLU_POLL_S)
        config.set_flag("metrics_dir", mdir)
        rdv = FileRendezvous(os.path.join(tmp, "rdv"))
        ctxs = [PSContext(r, 2, PSService(r, 2, rdv), device=shard_dev)
                for r in range(2)]
        try:
            # the first service (rank 0) started the poller itself
            agg = aggregator.global_aggregator()
            if (agg is None or agg.service is not ctxs[0].service
                    or agg._thread is None or agg.interval_s != CLU_POLL_S):
                raise AssertionError(f"{label}: rank 0's service did not "
                                     "start the poller")
            ts = [AsyncMatrixTable(rows, dim, name="clu", ctx=c)
                  for c in ctxs]
            registered = ts[0]._shard._native_ref is not None
            if registered != (plane == "native" and where == "CPU"):
                raise AssertionError(f"{label}: the shard's registration "
                                     "with the C++ server is wrong")
            t0 = time.perf_counter()
            ops = clu_traffic(ts[0], seconds, clu_pick_zipf(rows))
            dt = time.perf_counter() - t0
            agg.stop(final=False)   # quiesced: the poller too
            polls_bg = len(agg.history())
            rec = agg.poll_once()
            tab, sums = rec["tables"]["clu"], clu_sums(ctxs, "clu")
            for k in ("adds", "applies", "gets", "get_bytes", "add_bytes"):
                if tab[k] != sums[k]:
                    raise AssertionError(f"{label}: the record's {k} "
                                         f"{tab[k]} is not the shards' sum "
                                         f"{sums[k]}")
            stats, prec = clu_probe_merge(ctxs[0].service, 2)
            nmon = clu_check_monitors(stats, prec, label)
            top = [k for k, _c, _e in
                   rec.get("hotkeys", {}).get("clu", {}).get("top", [])[:8]]
            if not registered and not set(CLU_HOT) <= set(top):
                raise AssertionError(f"{label}: planted hot rows {CLU_HOT} "
                                     f"not in the top-8 {top}")
            out.update(ops=ops, seconds=dt, polls_background=polls_bg,
                       record_tables=tab["adds"], sums=sums,
                       monitors_checked=nmon, top8=top,
                       skew=tab["skew"], registered=registered)
            log(f"{label}: {ops} ops from {CLU_THREADS} threads in "
                f"{dt:.2f} s, {polls_bg} background polls; record = shards' "
                f"stats() exactly {sums}; {nmon} merged monitors = the "
                f"ranks' sums; top-8 {top}" + (" (the C++ server serves "
                f"every op: no sketch)" if registered else "")
                + f"; cumulative skew {tab['skew']}")
            if full:
                out.update(clu_skew_and_rates(label, agg, ctxs, ts[0], rows))
                out.update(clu_costs(label, agg, ctxs, ts[0]))
        finally:
            for c in ctxs:
                c.close()   # rank 0's close: the poller's final poll
        lines = dump_metrics.load_records(os.path.join(mdir,
                                                       "cluster.jsonl"))
        size = os.path.getsize(os.path.join(mdir, "cluster.jsonl"))
        if (len(lines) != len(agg.history())
                or len(lines) < seconds / CLU_POLL_S - 1
                or any(r.get("kind") != "cluster" for r in lines)):
            raise AssertionError(f"{label}: cluster.jsonl holds "
                                 f"{len(lines)} records for "
                                 f"{len(agg.history())} polls")
        prom = dump_metrics.load_prom(os.path.join(mdir, "cluster.prom"))
        if not any(n == "mv_shard_skew" and lb.get("table") == "clu"
                   and lb.get("rank") == "cluster" for n, lb, _v in prom):
            raise AssertionError(f"{label}: cluster.prom has no "
                                 "mv_shard_skew of the table")
        out.update(jsonl_records=len(lines),
                   jsonl_bytes_per_record=size / len(lines),
                   prom_samples=len(prom))
        log(f"{label}: cluster.jsonl {len(lines)} records (every poll and "
            f"the final one), {size / len(lines):.0f} bytes a record; "
            f"cluster.prom {len(prom)} samples parse ({card_label()})")
    return out


def clu_skew_and_rates(label: str, agg, ctxs, table, rows: int) -> dict:
    """The windowed skew of uniform traffic (about 1) and of traffic on
    rank 1's rows only (2 at world 2), and the applies/s of the second
    window against the shards' stats() deltas over the polls' interval."""
    res = {}
    for name, pick in (
            ("uniform", lambda rng: rng.integers(0, rows, CLU_BATCH)),
            ("rank1", lambda rng: rng.integers(rows // 2, rows,
                                               CLU_BATCH))):
        a = agg.poll_once()
        s0 = clu_sums(ctxs, "clu")
        clu_traffic(table, CLU_SKEW_S, pick)
        b = agg.poll_once()
        s1 = clu_sums(ctxs, "clu")
        r = b["rates"]["clu"]
        dt = b["ts"] - a["ts"]
        want = (s1["applies"] - s0["applies"]) / dt
        res[f"skew_{name}"] = r["skew_window"]
        res[f"applies_per_s_{name}"] = r["applies_per_s"]
        if abs(r["applies_per_s"] - want) > 0.006:
            raise AssertionError(f"{label}: applies/s {r['applies_per_s']}"
                                 f" against the shards' {want:.3f}")
    if not res["skew_uniform"] <= 1.1 or res["skew_rank1"] != 2.0:
        raise AssertionError(f"{label}: windowed skew uniform "
                             f"{res['skew_uniform']}, rank 1 only "
                             f"{res['skew_rank1']} (want ~1 and 2)")
    log(f"{label}: windowed skew {res['skew_uniform']} (uniform) and "
        f"{res['skew_rank1']} (rank 1's rows only); applies/s "
        f"{res['applies_per_s_uniform']} and {res['applies_per_s_rank1']}"
        f" = the shards' deltas over the polls' interval")
    return res


def clu_costs(label: str, agg, ctxs, table) -> dict:
    """Part (d) at world 2: one poll's wall time, and the 1-row add's
    p50/p99 to a row of rank 1 with a poller at CLU_POLL_S against none,
    in turns."""
    from multiverso_tpu_torch.telemetry import aggregator
    polls = []
    for _ in range(CLU_POLLS_TIMED):
        t0 = time.perf_counter()
        agg.poll_once()
        polls.append((time.perf_counter() - t0) * 1e3)
    lat = {"on": [], "off": []}
    one = np.ones((1, table.num_col), np.float32)
    row = [CLU_TABLE[0] - 1]
    for turn in range(2 * CLU_COST_TURNS):
        arm = "on" if turn % 2 == 0 else "off"
        poller = (aggregator.ClusterAggregator(ctxs[0].service,
                                               CLU_POLL_S).start()
                  if arm == "on" else None)
        try:
            end = time.perf_counter() + CLU_COST_TURN_S
            while time.perf_counter() < end:
                t0 = time.perf_counter()
                table.add_rows(row, one)
                lat[arm].append((time.perf_counter() - t0) * 1e3)
        finally:
            if poller is not None:
                poller.stop(final=False)
    res = {"poll_w2": clu_pcts(polls),
           "add_poller_on": clu_pcts(lat["on"]),
           "add_poller_off": clu_pcts(lat["off"])}
    log(f"{label} (d): one poll at world 2 p50 "
        f"{res['poll_w2']['p50_ms']:.3f} ms, p99 "
        f"{res['poll_w2']['p99_ms']:.3f} ms ({CLU_POLLS_TIMED} polls); "
        f"1-row add with the poller at {CLU_POLL_S} s: p50 "
        f"{res['add_poller_on']['p50_ms']:.3f} ms, p99 "
        f"{res['add_poller_on']['p99_ms']:.3f} ms ({res['add_poller_on']['n']}"
        f" adds); off: p50 {res['add_poller_off']['p50_ms']:.3f} ms, p99 "
        f"{res['add_poller_off']['p99_ms']:.3f} ms "
        f"({res['add_poller_off']['n']} adds); {CLU_COST_TURNS} turns of "
        f"{CLU_COST_TURN_S} s each ({card_label()})")
    return res


def clu_world4(dev) -> dict:
    """Part (b): ps_bench's four ranks, one a process, shards on the
    card; while they drive, mvtop --once --json and mvautoscale
    --dry-run read them from two more processes, and this process times
    its own polls (part (d) at world 4) and holds one poll's merged
    monitors to the four payloads' sums."""
    import tempfile
    from multiverso_tpu_torch.ps import service as svc
    from multiverso_tpu_torch.telemetry import aggregator
    from multiverso_tpu_torch.tools import mvtop
    repo = os.path.dirname(os.path.abspath(__file__))
    world = 4
    with tempfile.TemporaryDirectory() as tmp:
        rdv = os.path.join(tmp, "rdv")
        cmd = [sys.executable, "-m", "multiverso_tpu_torch.examples.ps_bench",
               "--rdv", rdv, "--world", str(world), "--seconds",
               str(CLU_W4_SECONDS), "--device", str(dev), "--timeout",
               str(PSN_TIMEOUT)]
        procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=repo,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for r in range(world)]
        tools = {"mvtop": ["multiverso_tpu_torch.tools.mvtop", "--once",
                           "--json"],
                 "mvautoscale": ["multiverso_tpu_torch.tools.mvautoscale",
                                 "--dry-run", "--json"]}
        readers = [(k, subprocess.Popen(
            [sys.executable, "-c", CLU_READER, a[0], rdv, str(world),
             str(PSN_TIMEOUT)] + a[1:] + ["--rdv", rdv, "--world",
                                          str(world)],
            cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)) for k, a in tools.items()]
        try:
            deadline = time.monotonic() + PSN_TIMEOUT
            while not all(os.path.exists(os.path.join(
                    rdv, f"ps_bench_warm.{r}")) for r in range(world)):
                if time.monotonic() > deadline or any(
                        p.poll() is not None for p in procs):
                    raise AssertionError("cluster (b): the ranks never "
                                         "warmed up")
                time.sleep(0.05)
            t_warm = time.perf_counter()
            addrs = mvtop.read_addrs(rdv, world)
            polls = []
            for _ in range(CLU_POLLS_TIMED):
                t0 = time.perf_counter()
                rec = mvtop.poll(addrs, 5.0)
                polls.append((time.perf_counter() - t0) * 1e3)
                if rec["polled"] != world:
                    raise AssertionError(f"cluster (b): a poll reached "
                                         f"{rec['polled']} of {world} ranks")

            def probe_one(r, stats, health):
                health[r] = svc.oneshot_probe(addrs[r], svc.MSG_HEALTH, 5.0)
                stats[r] = svc.oneshot_probe(addrs[r], svc.MSG_STATS, 5.0)

            stats, health = aggregator.probe_all(range(world), probe_one,
                                                 30.0)
            nmon = clu_check_monitors(
                stats, aggregator.merge_cluster(stats, health, world=world),
                "cluster (b)")
            outs = {k: p.communicate(timeout=120) for k, p in readers}
            t_read = time.perf_counter() - t_warm
            # the readers must have read a live cluster, not its end
            if any(p.poll() is not None for p in procs):
                raise AssertionError(f"cluster (b): a rank ended before "
                                     f"the readers did ({t_read:.1f} s "
                                     f"after the warm mark)")
            rcs = {k: p.returncode for k, p in readers}
            res = [p.communicate(timeout=PSN_TIMEOUT) for p in procs]
        finally:
            for p in procs + [p for _k, p in readers]:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for r, (p, (so, se)) in enumerate(zip(procs, res)):
        lines = [l for l in so.splitlines() if l.startswith("RESULT ")]
        if p.returncode != 0 or not lines:
            raise AssertionError(f"cluster (b) rank {r} failed "
                                 f"({p.returncode}):\n{se[-3000:]}")
        if r == 0 and not json.loads(lines[-1][len("RESULT "):])["exact"]:
            raise AssertionError("cluster (b): the full Get is not the "
                                 "numpy model's")
    top = json.loads(outs["mvtop"][0]) if rcs["mvtop"] == 0 else {}
    tab = top.get("tables", {}).get("ps_bench", {})
    if (rcs["mvtop"] != 0 or top.get("polled") != world
            or sorted(top.get("ranks", {})) != [str(r) for r in range(world)]
            or any(e.get("status") == "unreachable"
                   for e in top["ranks"].values())
            or len(tab.get("shards", {})) != world):
        raise AssertionError(f"cluster (b): mvtop exited {rcs['mvtop']}: "
                             f"{outs['mvtop'][0][:500]}"
                             f"{outs['mvtop'][1][-2000:]}")
    verdict = (json.loads(outs["mvautoscale"][0])
               if rcs["mvautoscale"] == 0 else {})
    if rcs["mvautoscale"] != 0 or verdict.get("action") != "hold":
        raise AssertionError(f"cluster (b): mvautoscale exited "
                             f"{rcs['mvautoscale']}: "
                             f"{outs['mvautoscale'][0][:500]}"
                             f"{outs['mvautoscale'][1][-2000:]}")
    out = {"poll_w4": clu_pcts(polls), "monitors_checked": nmon,
           "mvtop_ranks": len(top["ranks"]), "mvtop_adds": tab.get("adds"),
           "mvtop_skew": tab.get("skew"), "autoscale": verdict,
           "readers_s": t_read}
    where = "the card" if dev.type == "cuda" else str(dev)
    log(f"cluster (b) world of 4, one rank a process, shards on {where}: "
        f"mvtop --once --json exit 0 with {world} ranks ok, ps_bench "
        f"{tab.get('adds')} adds over {world} shards, skew "
        f"{tab.get('skew')}; mvautoscale --dry-run: {verdict['action']} "
        f"({verdict['reason']}); both read {t_read:.1f} s after the warm "
        f"mark; {nmon} merged monitors = the 4 payloads' sums; one poll at "
        f"world 4 p50 {out['poll_w4']['p50_ms']:.3f} ms, p99 "
        f"{out['poll_w4']['p99_ms']:.3f} ms ({CLU_POLLS_TIMED} polls, from "
        f"this process under the ranks' traffic; {card_label()})")
    return out


def clu_tenants(dev) -> dict:
    """Part (c): two tenants on card shards; each tenant's ops metered
    exactly by the owner's shard (and in the record's wire block), and
    tenant_add_qps deferring the over-budget tenant's windowed adds."""
    import tempfile
    from multiverso_tpu_torch.ps.service import (FileRendezvous, PSContext,
                                                 PSService)
    from multiverso_tpu_torch.ps.tables import AsyncMatrixTable
    from multiverso_tpu_torch.serving.admission import TokenBucket
    from multiverso_tpu_torch.telemetry import aggregator, tenants
    from multiverso_tpu_torch.utils import config
    label = f"cluster (c) tenants, shards on {dev}"
    rows, dim = 1000, 16
    tenants.reset()
    with tempfile.TemporaryDirectory() as tmp:
        rdv = FileRendezvous(os.path.join(tmp, "rdv"))
        ctxs = [PSContext(r, 2, PSService(r, 2, rdv), device=dev)
                for r in range(2)]
        try:
            plain = [AsyncMatrixTable(rows, dim, name="clt", ctx=c)
                     for c in ctxs]
            one = np.ones((1, dim), np.float32)
            plan = {"a": (30, 10), "b": (20, 5)}   # adds, gets
            for tn, (na, ng) in plan.items():
                with tenants.tenant_scope(tn):
                    for i in range(na):
                        plain[0].add_rows([rows // 2 + i], one)
                    for _ in range(ng):
                        plain[0].get_rows([rows - 1])
            plain[0].flush()
            meter = ctxs[1].service._shards["clt"].stats()["tenants"]
            rec = aggregator.ClusterAggregator(ctxs[0].service).poll_once()
            wire = rec["tenants"]["wire"]
            for tn, (na, ng) in plan.items():
                if meter[tn]["ops"] != na + ng or wire[tn]["ops"] != na + ng:
                    raise AssertionError(f"{label}: tenant {tn}'s ops "
                                         f"{meter[tn]}, record {wire[tn]}; "
                                         f"want {na + ng}")
            # the budget: one token bucket per (table, tenant) at the
            # send window
            config.set_flag("tenant_add_qps", CLU_TENANT_QPS)
            win = [AsyncMatrixTable(rows, dim, name="clw", ctx=c,
                                    **({"send_window_ms": 1.0} if r == 0
                                       else {}))
                   for r, c in enumerate(ctxs)]
            n = {"storm": 0, "quiet": 0}
            t0 = time.perf_counter()
            with tenants.tenant_scope("storm"):
                while time.perf_counter() - t0 < CLU_STORM_S:
                    win[0].add_rows_async([rows - 2], one)
                    n["storm"] += 1
            T = time.perf_counter() - t0
            with tenants.tenant_scope("quiet"):
                for _ in range(5):
                    win[0].add_rows_async([rows - 3], one)
                    n["quiet"] += 1
            win[0].flush()
            got = win[0].get_rows([rows - 2, rows - 3])[:, 0]
            led = tenants.LEDGER.stats_snapshot()["tables"]["clw"]
            deferred = {tn: led.get(tn, {}).get("deferred", 0) for tn in n}
            admitted = n["storm"] - deferred["storm"]
            burst = TokenBucket(CLU_TENANT_QPS).burst
            bound = burst + CLU_TENANT_QPS * T
            if (not deferred["storm"] or deferred["quiet"]
                    or not burst <= admitted <= bound + 1
                    or got.tolist() != [float(n["storm"]),
                                        float(n["quiet"])]):
                raise AssertionError(
                    f"{label}: storm {n['storm']} adds in {T:.2f} s, "
                    f"deferred {deferred}, admitted {admitted} (bound "
                    f"{bound:.1f}), rows {got.tolist()}")
        finally:
            config.set_flag("tenant_add_qps", 0.0)
            tenants.reset()
            for c in ctxs:
                c.close()
    log(f"{label}: ops metered exactly (a {meter['a']['ops']}, b "
        f"{meter['b']['ops']}; the record's wire block the same); storm "
        f"{n['storm']} windowed adds in {T:.2f} s at tenant_add_qps "
        f"{CLU_TENANT_QPS}: {admitted} admitted (bound burst {burst:.0f} + "
        f"qps x T = {bound:.1f}), {deferred['storm']} deferred and still "
        f"applied (rows = the adds); quiet tenant 0 deferred")
    return {"meter": {tn: meter[tn] for tn in plan}, "storm_adds": n["storm"],
            "storm_s": T, "admitted": admitted, "deferred": deferred,
            "bound": bound}


def phase_cluster(dev) -> dict:
    from multiverso_tpu_torch.telemetry import aggregator
    from multiverso_tpu_torch.utils import config
    keys = ("ps_native", "stats_poll_interval_s", "metrics_dir",
            "ps_timeout", "tenant_add_qps", "ps_health_timeout")
    saved = {k: config.get_flag(k) for k in keys}
    t0 = time.perf_counter()
    out = {}
    try:
        config.set_flag("ps_timeout", 60.0)
        out["card_python"] = clu_world2(dev, "python", CLU_SECONDS, True)
        out["card_native"] = clu_world2(dev, "native", CLU_SECONDS_OTHER,
                                        False)
        out["cpu_native"] = clu_world2("cpu", "native", CLU_SECONDS_OTHER,
                                       False)
        config.set_flag("stats_poll_interval_s", 0.0)
        config.set_flag("metrics_dir", "")
        t1 = time.perf_counter()
        out["world4"] = clu_world4(dev)
        t2 = time.perf_counter()
        out["tenants"] = clu_tenants(dev)
    finally:
        aggregator.stop_global(final=False)
        for k, v in saved.items():
            config.set_flag(k, v)
    log(f"cluster phase: {time.perf_counter() - t0:.1f} s ((a) "
        f"{t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) "
        f"{time.perf_counter() - t2:.1f} s)")
    return out


def phase_telemetry(dev, we_world2: dict, later: dict) -> dict:
    t0 = time.perf_counter()
    out = {"we_profile": tel_we_profile(we_world2)}
    t1 = time.perf_counter()
    out["lm_trace"] = tel_lm_trace(dev, LAYERS)
    t2 = time.perf_counter()
    out["exporter"] = tel_exporter(dev)
    t3 = time.perf_counter()
    out["postmortem"] = tel_postmortem(later["chaos"]["combined"])
    out["cost"] = tel_cost(later)
    log(f"telemetry phase: {time.perf_counter() - t0:.1f} s ((a) "
        f"{t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) {t3 - t2:.1f} s, (d) "
        f"and (e) {time.perf_counter() - t3:.1f} s)")
    return out


# ---------------------------------------------------------------------- #
# mesh: the parallel layers, two ranks on one card over gloo
# ---------------------------------------------------------------------- #
MESH_WORLD = 2            # ranks, spawned, both on cuda:0 (gloo)
MESH_DEVICE = "cuda"
# (a) and (c) at a depth cut to 4 (cut from 8, the 472M LM's depth, to
# keep the script in its time; their layers are the first 4 of its params)
MESH_LAYERS = 4
# (b) and (d) at a depth cut to 2 (their layers are the first 2 of the
# same params): the phase's share of the script's time
MESH_SHORT_LAYERS = 2
MESH_SP_ATTNS = ("ring", "zigzag", "ulysses")
MESH_PP_MICRO = 2
# (e) README.md:107-110's MoE (64 experts, top-2) at the LM's widths, cut
# to 2 layers: at 8 layers the experts alone are ~17B parameters
MESH_MOE = dict(moe_experts=64, moe_top_k=2, moe_axis="ep")
MESH_MOE_LAYERS = 2
MESH_MOE_SEED = 1000
# capacity = every local token (E / k): nothing can drop
MESH_MOE_CF_ALL = MESH_MOE["moe_experts"] / MESH_MOE["moe_top_k"]
# the forward against the dense oracle runs in f32: in bf16 the router's
# logits for a rank's half of the tokens round otherwise than for the
# whole batch (cuBLAS picks its kernel by the row count), and a near-tie
# flips a token's second expert: in bf16 the logits differed from the
# oracle's by up to 2.82 on an H100. f32 logits: the expert and
# attention sums in another order through 2 layers, ~100x the error
# expected from that
MESH_MOE_ATOL = 1e-3
MESH_MOE_CF = 2.0
MESH_MOE_STEPS = 2
MESH_CNN_EPOCHS = 2       # (f) examples/cnn_worker_map.py's shape
MESH_TIMEOUT_S = 400


def mesh_bits(t) -> np.ndarray:
    """A bf16 tensor's bits as a host uint16 array (the files' format)."""
    import torch
    return t.detach().to(torch.bfloat16).contiguous().view(
        torch.int16).cpu().numpy().view(np.uint16)


def mesh_unbits(arr: np.ndarray, dev):
    import torch
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).to(
        dev).view(torch.bfloat16)


def mesh_moe_cfg():
    from multiverso_tpu_torch.models import transformer as tfm
    return lm_config(MESH_MOE_LAYERS)._replace(
        moe_capacity_factor=MESH_MOE_CF_ALL, **MESH_MOE)


def mesh_moe_weights(layer: int, experts, dev, dtype) -> dict:
    """Layer ``layer``'s router and the experts ``experts`` (a range), drawn
    on the card from seeds fixed per expert, so the parent's oracle and
    each rank draw the same weights for the same expert."""
    import torch
    cfg = mesh_moe_cfg()
    d, m, e = cfg.dim, cfg.mlp_ratio * cfg.dim, cfg.moe_experts
    s1 = 1.0 / np.sqrt(d)
    s2 = np.sqrt(1.0 / m) / np.sqrt(2 * cfg.num_layers)

    def draw(seed, shape, scale):
        g = torch.Generator(device=dev).manual_seed(seed)
        return (torch.randn(shape, generator=g, device=dev) * scale).to(
            dtype)

    base = MESH_MOE_SEED + 1000 * layer
    return {"router": draw(base, (d, e), s1),
            "w1": torch.stack([draw(base + 1 + j, (d, m), s1)
                               for j in experts]),
            "w2": torch.stack([draw(base + 1 + e + j, (m, d), s2)
                               for j in experts])}


def mesh_moe_oracle(tree: dict, tok, dev):
    """The MoE LM's f32 logits with every expert on every token, combined
    by the top-k gates (the layout-free form of tests/test_moe.py:21-34's
    dense oracle), on the whole batch: nothing is dropped."""
    import torch
    import torch.nn.functional as F
    from multiverso_tpu_torch.models import transformer as tfm
    from multiverso_tpu_torch.ops.attention_kernels import flash_attention
    from multiverso_tpu_torch.parallel.moe import top_k_gates
    cfg = mesh_moe_cfg()
    b, s = tok.shape
    d, h = cfg.dim, cfg.num_heads
    hd = d // h
    w = lambda a: torch.from_numpy(np.array(a, np.float32)).to(dev)
    emb = w(tree["embed"])
    x = emb[tok] + w(tree["pos"][:s])[None]
    with torch.no_grad():
        for i in range(cfg.num_layers):
            lay = {k: w(v[i]) for k, v in tree["layers"].items()
                   if k in ("wqkv", "wo", "ln1", "ln2")}
            y = tfm._rmsnorm(x, lay["ln1"])
            q, k, v = torch.matmul(y, lay["wqkv"]).chunk(3, -1)
            sp = lambda t: t.reshape(b, s, h, hd).transpose(1, 2)
            o = flash_attention(sp(q), sp(k), sp(v), causal=True)
            x = x + torch.matmul(o.transpose(1, 2).reshape(b, s, d),
                                 lay["wo"])
            y = tfm._rmsnorm(x, lay["ln2"]).reshape(-1, d)
            mw = mesh_moe_weights(i, range(cfg.moe_experts), dev,
                                  torch.float32)
            probs = torch.softmax(torch.matmul(y, mw["router"]).float(), -1)
            gates, topi = top_k_gates(probs, cfg.moe_top_k)
            out = torch.zeros(y.shape, dtype=torch.float32, device=dev)
            for e in range(cfg.moe_experts):
                wt = (gates * (topi == e)).sum(-1)
                ye = torch.matmul(F.gelu(torch.matmul(y, mw["w1"][e]),
                                         approximate="tanh"), mw["w2"][e])
                out += ye.float() * wt[:, None]
            x = x + out.to(x.dtype).reshape(b, s, d)
            del mw
        return tfm._lm_head(x, w(tree["ln_f"]), emb)


def mesh_short_tree(tree: dict) -> dict:
    """The first MESH_SHORT_LAYERS layers of the LM's tree (views)."""
    out = dict(tree)
    out["layers"] = {k: v[:MESH_SHORT_LAYERS]
                     for k, v in tree["layers"].items()}
    return out


def mesh_references(dev, tmp: str) -> dict:
    """The world-1 references on the card, in this process, before the
    ranks start: the params (the LM's seed-0 tree, saved as float32
    numpy), the flash LM's logits, loss and two SGD steps' gradients, the
    short flash and local-attention LMs' losses and gradients, and the
    MoE oracle's logits. Arrays go to ``tmp`` as .npy; returns the
    scalars and the batch."""
    import torch
    from multiverso_tpu_torch.models import transformer as tfm
    t0 = time.perf_counter()
    cfg = lm_config(MESH_LAYERS)
    tree, n = {"layers": {}}, 0
    for key, leaf in tfm.tp_lib.leaves(lm_init_params(LAYERS)):
        if key[0] == "layers":
            leaf = leaf[:MESH_LAYERS]
        path = os.path.join(tmp, "p_" + "_".join(key) + ".npy")
        np.save(path, leaf)
        node = tree["layers"] if key[0] == "layers" else tree
        node[key[-1]] = np.load(path, mmap_mode="r")
        n += leaf.size
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (BATCH, cfg.max_seq + 1)).astype(
        np.int64)
    tok_np, tgt_np = toks[:, :-1], toks[:, 1:]
    tok = torch.from_numpy(tok_np).to(dev)
    tgt = torch.from_numpy(tgt_np).to(dev)
    refs = {"tokens": tok_np, "targets": tgt_np, "params": n}

    def save_grads(model, grads, tag):
        for (path, _), g in zip(tfm._paths(model), grads):
            np.save(os.path.join(tmp, f"{tag}_{'_'.join(path)}.npy"),
                    mesh_bits(g))

    model = tfm.params_from_jax(tree, cfg, dev)
    with torch.no_grad():
        logits = tfm.forward(model, tok)
    np.save(os.path.join(tmp, "logits.npy"), mesh_bits(logits))
    del logits
    losses = []
    for stepno in (1, 2):
        loss, grads = tfm.loss_and_grads(model, tok, tgt)
        losses.append(float(loss))
        save_grads(model, grads, f"g{stepno}")
        tfm.sgd_update_(list(model.parameters()), grads, LR)
        del grads
    refs["loss_flash"] = losses
    del model
    short = lm_config(MESH_SHORT_LAYERS)
    for attn, tag in (("flash", "f2"), ("local", "l2")):
        model = tfm.params_from_jax(mesh_short_tree(tree),
                                    short._replace(attn=attn), dev)
        loss, grads = tfm.loss_and_grads(model, tok, tgt)
        refs[f"loss_{tag}"] = float(loss)
        save_grads(model, grads, tag)
        del model, grads
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    moe = mesh_moe_oracle(tree, tok, dev)
    np.save(os.path.join(tmp, "logits_moe.npy"), moe.float().cpu().numpy())
    del moe
    torch.cuda.empty_cache()
    log(f"mesh references (world 1, this process): the LM's {n} "
        f"parameters (seed 0), flash losses {losses}, {MESH_SHORT_LAYERS} "
        f"layers: flash {refs['loss_f2']:.5f}, local {refs['loss_l2']:.5f}, "
        f"in {t1 - t0:.1f} s; the MoE dense oracle "
        f"({MESH_MOE['moe_experts']} experts x {MESH_MOE_LAYERS} layers, "
        f"every expert on every token) in {time.perf_counter() - t1:.1f} s")
    return refs


def mesh_load_tree(tmp: str) -> dict:
    """The params the parent saved, memory-mapped (a rank reads only its
    blocks)."""
    from multiverso_tpu_torch.models import transformer as tfm
    tree = {"layers": {}}
    for key, _ in tfm.tp_lib.leaves(tfm.param_shapes(lm_config(
            MESH_LAYERS))):
        arr = np.load(os.path.join(tmp, "p_" + "_".join(key) + ".npy"),
                      mmap_mode="r")
        (tree["layers"] if key[0] == "layers" else tree)[key[-1]] = arr
    return tree


def mesh_grad_errors(model, grads, tmp: str, tag: str, dev) -> dict:
    """||g - g_ref|| / ||g_ref|| per leaf, each rank's blocks gathered on
    the card (every rank takes part; rank 0's numbers are the check)."""
    import torch
    from multiverso_tpu_torch.models import transformer as tfm
    out = {}
    for (path, _), g in zip(tfm._paths(model), grads):
        full = tfm.tp_lib.gather_leaf(g, model.spec(path), model.mesh)
        if path[-1] == "wqkv" and model.qkv_perm is not None:
            inv = np.empty_like(model.qkv_perm)
            inv[model.qkv_perm] = np.arange(model.qkv_perm.size)
            full = full[..., torch.from_numpy(inv).to(dev)]
        ref = mesh_unbits(np.load(os.path.join(
            tmp, f"{tag}_{'_'.join(path)}.npy")), dev).float()
        out[".".join(path)] = float((full.float() - ref).norm() / ref.norm())
    return out


def mesh_logits_error(logits, cfg, mesh, vocab_sharded, path, dev) -> float:
    """max |gathered logits - the reference file's| (bf16 bits or f32)."""
    import torch
    from multiverso_tpu_torch.parallel.mesh import P
    from multiverso_tpu_torch.models import transformer as tfm
    spec = P(cfg.batch_axis if cfg.batch_axis in mesh.shape else None,
             cfg.seq_axis if cfg.seq_axis in mesh.shape else None,
             cfg.tp_axis if vocab_sharded else None)
    full = tfm.tp_lib.gather_leaf(logits, spec, mesh)
    arr = np.load(path)
    ref = mesh_unbits(arr, dev) if arr.dtype == np.uint16 else \
        torch.from_numpy(arr).to(dev)
    return float((full.float() - ref.float()).abs().max())


def mesh_timed(fn):
    """(result, ms): ``fn()`` timed to its end on the card."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def mesh_tp(rank, dev, tree, tmp, refs) -> dict:
    """(a) tp=2, attn="flash", 8 layers: the logits and the loss against
    world 1, two SGD steps each with its gathered gradient against world
    1's; each rank runs B1-B3 on its 8 local heads."""
    import torch
    from multiverso_tpu_torch.models import transformer as tfm
    from multiverso_tpu_torch.ops import attention_kernels as ak
    from multiverso_tpu_torch.parallel.mesh import Mesh
    from multiverso_tpu_torch.telemetry import devstats
    cfg = lm_config(MESH_LAYERS)._replace(tp_axis="tp")
    mesh = Mesh({"tp": MESH_WORLD}, device=dev)
    model = tfm.params_from_jax(tree, cfg, dev, mesh=mesh)
    heads = model.layers.wqkv.shape[-1] // 3 // (cfg.dim // cfg.num_heads)
    tok = tfm.shard_batch(refs["tokens"], cfg, mesh)
    tgt = tfm.shard_batch(refs["targets"], cfg, mesh)
    devstats.reset()
    before = ak.launch_counts()
    with torch.no_grad():
        logits = tfm.forward(model, tok)
    err = mesh_logits_error(logits, cfg, mesh, True,
                            os.path.join(tmp, "logits.npy"), dev)
    del logits
    out = {"local_heads": heads, "logits_err": err, "losses": [],
           "grad_rel": [], "step_ms": []}
    for stepno in (1, 2):
        (loss, grads), ms = mesh_timed(lambda: tfm.loss_and_grads(
            model, tok, tgt))
        out["losses"].append(float(loss))
        out["grad_rel"].append(mesh_grad_errors(model, grads, tmp,
                                                f"g{stepno}", dev))
        _, ms_upd = mesh_timed(lambda: tfm.sgd_update_(
            list(model.parameters()), grads, LR))
        out["step_ms"].append(ms + ms_upd)
        del grads
    after = ak.launch_counts()
    out["launches"] = {k: after[k] - before[k] for k in after}
    out["collectives"] = devstats.collectives()
    return out


def mesh_sp(rank, dev, tree, tmp, refs) -> dict:
    """(b) sp=2 at seq 1024 (2 layers): ring, zigzag and Ulysses, one
    forward and backward each, the loss and the gradient against world
    1's local."""
    from multiverso_tpu_torch.models import transformer as tfm
    from multiverso_tpu_torch.parallel.mesh import Mesh
    from multiverso_tpu_torch.telemetry import devstats
    mesh = Mesh({"sp": MESH_WORLD}, device=dev)
    base = lm_config(MESH_SHORT_LAYERS)._replace(attn="local",
                                                 seq_axis="sp")
    model = tfm.params_from_jax(mesh_short_tree(tree), base, dev, mesh=mesh)
    out = {}
    for attn in MESH_SP_ATTNS:
        cfg = base._replace(attn=attn)
        tok = tfm.shard_batch(refs["tokens"], cfg, mesh)
        tgt = tfm.shard_batch(refs["targets"], cfg, mesh)
        devstats.reset()
        (loss, grads), ms = mesh_timed(lambda: tfm.loss_and_grads(
            model, tok, tgt, cfg=cfg))
        out[attn] = {"loss": float(loss), "ms": ms,
                     "grad_rel": mesh_grad_errors(model, grads, tmp, "l2",
                                                  dev),
                     "collectives": devstats.collectives()}
        del grads
    return out


def mesh_pp(rank, dev, tree, tmp, refs) -> dict:
    """(c) pp=2, n_micro 2, 8 layers (4 a stage): one train step, its loss
    and gathered gradient against world 1's."""
    import torch
    from multiverso_tpu_torch.models import transformer as tfm
    from multiverso_tpu_torch.parallel.mesh import Mesh, P
    from multiverso_tpu_torch.telemetry import devstats
    cfg = lm_config(MESH_LAYERS)
    mesh = Mesh({"pp": MESH_WORLD}, device=dev)
    stacked = tfm.shard_params_pp(tfm.stack_pp_params(tree, cfg, MESH_WORLD),
                                  mesh, "pp", cfg)
    tok = tfm.shard_batch(refs["tokens"], cfg, mesh)
    tgt = tfm.shard_batch(refs["targets"], cfg, mesh)
    f = tfm.make_pp_loss_and_grads(cfg, MESH_PP_MICRO, "pp", mesh)
    devstats.reset()
    (loss, grads), ms = mesh_timed(lambda: f(stacked, tok, tgt))
    rel = {}
    names = [p for p, _ in tfm.tp_lib.leaves(stacked)]
    for path, g in zip(names, grads):
        if path[0] == "stages":
            g = tfm.tp_lib.gather_leaf(g, P("pp"), mesh)
            g = g.reshape((-1,) + tuple(g.shape[2:]))
            key = ("layers", path[1])
        else:
            key = path
        ref = mesh_unbits(np.load(os.path.join(
            tmp, f"g1_{'_'.join(key)}.npy")), dev).float()
        rel[".".join(key)] = float((g.float() - ref).norm() / ref.norm())
    tfm.sgd_update_(tfm.pp_leaves(stacked), grads, LR)
    return {"loss": float(loss), "ms": ms, "grad_rel": rel,
            "collectives": devstats.collectives()}


def mesh_fsdp(rank, dev, tree, tmp, refs) -> dict:
    """(d) fsdp=2, 2 layers (each rank stores half of every large leaf,
    computes on its batch row): one train step against world 1."""
    from multiverso_tpu_torch.models import transformer as tfm
    from multiverso_tpu_torch.parallel.mesh import Mesh
    from multiverso_tpu_torch.telemetry import devstats
    cfg = lm_config(MESH_SHORT_LAYERS)._replace(batch_axis="fsdp")
    mesh = Mesh({"fsdp": MESH_WORLD}, device=dev)
    model = tfm.shard_params_fsdp(mesh_short_tree(tree), cfg, mesh,
                                  axis="fsdp", device=dev)
    tok = tfm.shard_batch(refs["tokens"], cfg, mesh)
    tgt = tfm.shard_batch(refs["targets"], cfg, mesh)
    devstats.reset()
    (loss, grads), ms = mesh_timed(lambda: tfm.loss_and_grads(model, tok,
                                                              tgt))
    rel = mesh_grad_errors(model, grads, tmp, "f2", dev)
    tfm.sgd_update_(list(model.parameters()), grads, LR)
    return {"loss": float(loss), "ms": ms, "grad_rel": rel,
            "stored": int(sum(p.numel() for p in model.parameters())),
            "params": int(sum(leaf.size for _, leaf in tfm.tp_lib.leaves(
                mesh_short_tree(tree)))),
            "collectives": devstats.collectives()}


def mesh_moe(rank, dev, tree, tmp, refs) -> dict:
    """(e) ep=2 MoE (64 experts, top-2, 2 layers): one forward with
    nothing dropped against the dense oracle, then two train steps at
    capacity 2.0."""
    import torch
    from multiverso_tpu_torch.models import transformer as tfm
    from multiverso_tpu_torch.parallel.mesh import Mesh
    from multiverso_tpu_torch.telemetry import devstats
    cfg32 = mesh_moe_cfg()._replace(dtype=torch.float32)
    mesh = Mesh({"ep": MESH_WORLD}, device=dev)
    model = tfm.Transformer(cfg32, dev, mesh)
    el = cfg32.moe_experts // MESH_WORLD
    mine = range(rank * el, (rank + 1) * el)
    with torch.no_grad():
        for path, p in tfm._paths(model):
            if path[-1].startswith("moe_"):
                continue
            arr = tree[path[0]] if path[0] != "layers" else \
                tree["layers"][path[1]][:cfg32.num_layers]
            p.copy_(torch.from_numpy(np.array(arr, np.float32)))
        for i in range(cfg32.num_layers):
            mw = mesh_moe_weights(i, mine, dev, torch.float32)
            model.layers.moe_router[i].copy_(mw["router"])
            model.layers.moe_w1[i].copy_(mw["w1"])
            model.layers.moe_w2[i].copy_(mw["w2"])
            del mw
    tok = tfm.shard_batch(refs["tokens"], cfg32, mesh)
    tgt = tfm.shard_batch(refs["targets"], cfg32, mesh)
    stats = {}
    devstats.reset()
    with torch.no_grad():
        logits, aux = tfm.forward_with_aux(model, tok, stats=stats)
    err = mesh_logits_error(logits, cfg32, mesh, False,
                            os.path.join(tmp, "logits_moe.npy"), dev)
    del logits
    # the train steps in the LM's bf16, from the same weights
    cfg = mesh_moe_cfg()
    bf16 = tfm.Transformer(cfg, dev, mesh)
    with torch.no_grad():
        for p, q in zip(bf16.parameters(), model.parameters()):
            p.copy_(q)
    model = bf16
    out = {"oracle_err": err, "dropped": stats["dropped"],
           "aux_all": stats["aux"], "losses": [], "aux": [],
           "dropped_cf": [], "step_ms": []}
    step_cfg = cfg._replace(moe_capacity_factor=MESH_MOE_CF)
    for _ in range(MESH_MOE_STEPS):
        s = {}
        with torch.no_grad():
            tfm.forward_with_aux(model, tok, step_cfg, stats=s)
        (loss, grads), ms = mesh_timed(lambda: tfm.loss_and_grads(
            model, tok, tgt, cfg=step_cfg))
        tfm.sgd_update_(list(model.parameters()), grads, LR)
        del grads
        out["losses"].append(float(loss))
        out["aux"].append(s["aux"])
        out["dropped_cf"].append(s["dropped"])
        out["step_ms"].append(ms)
    out["collectives"] = devstats.collectives()
    return out


def mesh_rank(rank: int, world: int, dev, tmp: str, refs: dict) -> dict:
    """One rank of the mesh phase: (a)-(f) in turn, each on its own mesh
    of the two ranks."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    from multiverso_tpu_torch.examples import cnn_worker_map
    from multiverso_tpu_torch.ops import attention_kernels as ak
    from multiverso_tpu_torch.parallel import collectives as coll
    ak.reset_launch_counts()
    coll.reset_staged_counts()
    tree = mesh_load_tree(tmp)
    walls = {}
    out = {}
    for name, fn in (("tp", mesh_tp), ("sp", mesh_sp), ("pp", mesh_pp),
                     ("fsdp", mesh_fsdp), ("moe", mesh_moe)):
        t0 = time.perf_counter()
        out[name] = fn(rank, dev, tree, tmp, refs)
        torch.cuda.empty_cache()
        walls[name] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    losses, acc = cnn_worker_map.rank_main(rank, world, dev,
                                           MESH_CNN_EPOCHS, "", 256)
    walls["bsp"] = round(time.perf_counter() - t0, 1)
    out["bsp"] = {"losses": losses, "acc": acc}
    out["launches"] = ak.launch_counts()
    out["staged"] = coll.staged_counts()
    out["walls"] = walls
    return out


def mesh_colls(c: dict) -> str:
    return ", ".join(f"{op} {d['calls']}x {d['bytes'] / 2**20:.1f} MiB "
                     f"{d['ms']:.1f} ms" for op, d in sorted(c.items()))


def phase_mesh(dev) -> dict:
    """The parallel layers on two ranks spawned on this card (gloo: NCCL
    refuses two ranks on one card), against world-1 references built
    here first; returns the launch counts summed over the ranks."""
    import shutil
    import tempfile
    import torch
    from multiverso_tpu_torch.ops import attention_kernels as ak
    from multiverso_tpu_torch.parallel.mesh import spawn
    tmp = tempfile.mkdtemp(prefix="mv_mesh_")
    try:
        t0 = time.perf_counter()
        refs = mesh_references(dev, tmp)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        ranks = spawn(mesh_rank, MESH_WORLD, MESH_DEVICE, (tmp, refs),
                      timeout=MESH_TIMEOUT_S)
        t2 = time.perf_counter()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r0 = ranks[0]
    # (a)
    a = r0["tp"]
    for r, rk in enumerate(ranks):
        log(f"mesh (a) tp=2 flash rank {r}: {rk['tp']['local_heads']} local "
            f"heads, B1-B3 launches {rk['tp']['launches']}, step ms "
            f"{[round(t, 1) for t in rk['tp']['step_ms']]}; collectives: "
            f"{mesh_colls(rk['tp']['collectives'])}")
    log(f"mesh (a) logits max |tp - world 1| {a['logits_err']:.4f} "
        f"(tolerance {ATOL_LOGITS}); losses {a['losses']} against "
        f"{refs['loss_flash']}; gradients ||g - g1|| / ||g1||, worst leaf "
        f"by step: {[round(max(g.values()), 5) for g in a['grad_rel']]}")
    for rk in ranks:
        if rk["tp"]["local_heads"] != LM["num_heads"] // MESH_WORLD:
            raise AssertionError("tp ranks do not hold 8 heads each")
        got = rk["tp"]["launches"]
        if not (got["flash_fwd"] == MESH_LAYERS * 3
                and got["flash_bwd_dq"] == MESH_LAYERS * 2
                and got["flash_bwd_dkv"] == MESH_LAYERS * 2):
            raise AssertionError(f"(a) launched {got}: expected B1 "
                                 f"{3 * MESH_LAYERS}, B2 and B3 "
                                 f"{2 * MESH_LAYERS} on each rank")
    if a["logits_err"] > ATOL_LOGITS:
        raise AssertionError("(a) tp logits disagree with world 1")
    for got, want_l in zip(a["losses"], refs["loss_flash"]):
        if abs(got - want_l) > ATOL_LOSS:
            raise AssertionError(f"(a) tp loss {got} vs world 1 {want_l}")
    for g in a["grad_rel"]:
        if max(g.values()) > RTOL_GRAD:
            raise AssertionError(f"(a) tp gradients disagree: {g}")
    # (b)
    for attn, b in r0["sp"].items():
        log(f"mesh (b) sp=2 {attn}, {MESH_SHORT_LAYERS} layers: loss "
            f"{b['loss']:.5f} vs world 1 local {refs['loss_l2']:.5f}, "
            f"fwd+bwd {b['ms']:.1f} ms, worst "
            f"gradient leaf {max(b['grad_rel'].values()):.5f} "
            f"({max(b['grad_rel'], key=b['grad_rel'].get)}); collectives: "
            f"{mesh_colls(b['collectives'])}")
        if abs(b["loss"] - refs["loss_l2"]) > ATOL_LOSS \
                or max(b["grad_rel"].values()) > RTOL_GRAD:
            raise AssertionError(f"(b) {attn} disagrees with world 1")
    # (c), (d)
    for name, tag, want in (
            ("pp", f"(c) pp=2 n_micro 2, {MESH_LAYERS} layers",
             refs["loss_flash"][0]),
            ("fsdp", f"(d) fsdp=2, {MESH_SHORT_LAYERS} layers",
             refs["loss_f2"])):
        c = r0[name]
        log(f"mesh {tag}: loss {c['loss']:.5f} vs world 1 {want:.5f}, step "
            f"{c['ms']:.1f} ms, worst gradient leaf "
            f"{max(c['grad_rel'].values()):.5f}; "
            + (f"rank 0 stores {c['stored']} of {c['params']} "
               "parameters; " if name == "fsdp" else "")
            + f"collectives: {mesh_colls(c['collectives'])}")
        if abs(c["loss"] - want) > ATOL_LOSS \
                or max(c["grad_rel"].values()) > RTOL_GRAD:
            raise AssertionError(f"mesh {tag} disagrees with world 1")
    # (e)
    e = r0["moe"]
    log(f"mesh (e) ep=2 MoE {MESH_MOE['moe_experts']} experts top-"
        f"{MESH_MOE['moe_top_k']}, {MESH_MOE_LAYERS} layers: capacity "
        f"factor {MESH_MOE_CF_ALL:g} (f32) dropped {e['dropped']}, logits "
        f"max |ep - dense oracle| {e['oracle_err']:.3e} (tolerance "
        f"{MESH_MOE_ATOL:g}); bf16 at {MESH_MOE_CF:g}: "
        f"losses {e['losses']}, aux by layer {e['aux']}, dropped "
        f"{e['dropped_cf']}, step ms {[round(t, 1) for t in e['step_ms']]}"
        f"; collectives: {mesh_colls(e['collectives'])}")
    if any(x != 0.0 for x in e["dropped"]):
        raise AssertionError("(e) tokens dropped at full capacity")
    if e["oracle_err"] > MESH_MOE_ATOL:
        raise AssertionError("(e) MoE logits disagree with the dense oracle")
    if not np.isfinite(e["losses"]).all():
        raise AssertionError(f"(e) non-finite MoE loss {e['losses']}")
    # (f)
    f = r0["bsp"]
    log(f"mesh (f) worker_step BSP (cnn_worker_map, 2 workers): epoch "
        f"losses {[round(x, 4) for x in f['losses']]}, train accuracy "
        f"{f['acc']:.4f}")
    if not f["losses"][-1] < f["losses"][0]:
        raise AssertionError("(f) the BSP loss did not fall")
    if any(rk["bsp"]["losses"] != f["losses"] for rk in ranks):
        raise AssertionError("(f) the workers' losses differ")
    counts = {k: sum(rk["launches"][k] for rk in ranks)
              for k in r0["launches"]}
    log(f"mesh staged through host buffers (gloo lacks the op on CUDA "
        f"tensors), rank 0: {r0['staged']}")
    log(f"mesh launches summed over the ranks {counts}; rank walls (s) "
        f"{[rk['walls'] for rk in ranks]}; references {t1 - t0:.1f} s, "
        f"ranks {t2 - t1:.1f} s")
    return counts


# spmd: the PS half of the mesh data plane (``ps/spmd.py``; no kernel of
# its own: index_add_, index_select and the updaters' elementwise ops).
# The shape is the JAX package's cell of this plane, tools/bench_scale.py:
# a 40,000 x 128 f32 AsyncMatrixTable (DEFAULT_ROWS, DEFAULT_DIM), 2048-row
# batches (BATCH_ROWS) and the same M client threads at every point
# (worker_count(): its constant offered load). Every world is in this
# process over one FileRendezvous, every shard on the card.
SPMD_TABLE = (40_000, 128)
SPMD_BATCH = 2048
SPMD_CLIENTS = max(2, min(os.cpu_count() or 2, 4))   # bench_scale:79-80
SPMD_RANKS = 4              # (a) and (b)
SPMD_STEPS = 8              # (a)'s seeded adds, rank by rank
SPMD_UPDATERS = (("default", {}), ("adagrad", PSA_ADAGRAD),
                 ("momentum_sgd", dict(momentum=0.5)))
SPMD_SHARDS = (1, 2, 4, 8)  # (c)'s points
SPMD_SECONDS = 0.75         # one window of a point's drive
SPMD_WINDOWS = 3            # windows a plane, armed and off in turns
SPMD_WARM = 2               # add + get rounds per client before a point
SPMD_PROFILE_N = 4          # the profiled point (armed)
# the hot-key sketch sized to the cell's key set, as bench_scale:207-214
# sets it: at the default 128 every observe of the clients' strided rows
# is a heap eviction, a pure-Python cost that took about two thirds of a
# 2048-row op's host time in a CPU profile of this phase
SPMD_HOTKEYS = 16384


def spmd_world(dev, n: int, rdv: str, name: str, updater="default",
               armed: bool = True):
    """``n`` ranks in this process over ``rdv``, shards on ``dev``, with
    ps_fanout and ps_spmd_stack both ``armed`` (or both off)."""
    from multiverso_tpu_torch.ps.service import (FileRendezvous, PSContext,
                                                 PSService)
    from multiverso_tpu_torch.ps.tables import AsyncMatrixTable
    from multiverso_tpu_torch.utils import config
    config.set_flag("ps_fanout", armed)
    config.set_flag("ps_spmd_stack", armed)
    ctxs = [PSContext(r, n, PSService(r, n, FileRendezvous(rdv)),
                      device=dev) for r in range(n)]
    try:
        tabs = [AsyncMatrixTable(*SPMD_TABLE, name=name, updater=updater,
                                 ctx=c) for c in ctxs]
    except BaseException:
        spmd_close(ctxs)
        raise
    return ctxs, tabs


def spmd_close(ctxs) -> None:
    from multiverso_tpu_torch.ps import spmd
    for c in ctxs:
        c.close()
    spmd.reset_registry()


def spmd_stream(seed: int = 31):
    """(a)'s seeded adds: 2048 sorted rows each (a stride plus a random
    offset: every shard's range is hit), normal deltas."""
    rng = np.random.default_rng(seed)
    rows, dim = SPMD_TABLE
    stride = rows // SPMD_BATCH
    out = []
    for _ in range(SPMD_STEPS):
        ids = (np.arange(SPMD_BATCH) * stride
               + rng.integers(0, stride, SPMD_BATCH))
        out.append((np.sort(ids), rng.normal(
            size=(SPMD_BATCH, dim)).astype(np.float32)))
    return out


def spmd_parity(dev, tmp: str) -> dict:
    """(a) each updater: a 4-rank stacked world against a 1-shard classic
    world on the card, the same adds from every rank's client in turn,
    full Gets bit for bit; the applies and dispatches counted. (b) on the
    default updater's worlds: a pinned slab survives a grouped apply, then
    ``set_rows`` evicts one member alone and the tables still agree."""
    import torch
    from multiverso_tpu_torch.updaters import AddOption
    out = {}
    stream = spmd_stream()
    for upd, opt_kw in SPMD_UPDATERS:
        label = f"spmd (a) {upd}"
        # the classic world first: the flags stay armed for the stacked
        # world's ops (routing reads them at each request)
        octxs, otab = spmd_world(dev, 1, os.path.join(tmp, upd + "_o"),
                                 "spmd_o", upd, armed=False)
        try:
            ctxs, tabs = spmd_world(dev, SPMD_RANKS,
                                    os.path.join(tmp, upd), "spmd_a", upd)
        except BaseException:
            spmd_close(octxs)
            raise
        try:
            plane = tabs[0]._shard._plane
            if (plane is None or not plane.active
                    or len(plane.members) != SPMD_RANKS
                    or any(t._shard._plane is not plane for t in tabs)
                    or str(plane.device) != str(dev)):
                raise AssertionError(f"{label}: the shards are not one "
                                     f"{SPMD_RANKS}-slot plane on {dev}")
            if not tabs[0]._fanout or otab[0]._shard._plane is not None:
                raise AssertionError(f"{label}: the worlds took the other "
                                     "planes")
            d0 = plane._dispatches
            t0 = time.perf_counter()
            for step, (ids, vals) in enumerate(stream):
                opt = AddOption(worker_id=step % SPMD_RANKS, **opt_kw)
                tabs[step % SPMD_RANKS].add_rows(ids, vals, opt)
                otab[0].add_rows(ids, vals, opt)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            got, want = tabs[1].get(), otab[0].get()
            if not np.array_equal(got, want):
                raise AssertionError(
                    f"{label}: the stacked table differs from the classic "
                    f"one (max |diff| {np.abs(got - want).max()})")
            dispatches = plane._dispatches - d0
            applies = [t._shard._stat_applies for t in tabs]
            per_add = dispatches / len(stream)
            log(f"{label}: {len(stream)} adds of {SPMD_BATCH} rows from "
                f"{SPMD_RANKS} ranks' clients, each over all {SPMD_RANKS} "
                f"slots on {plane.device}: full Get = the 1-shard classic "
                f"world bit for bit; applies a shard {applies}, plane "
                f"dispatches {dispatches} ({per_add:.2f} a multi-owner add);"
                f" both worlds' adds took {dt * 1e3:.1f} ms "
                f"({card_label()})")
            if per_add != 1 or applies != [len(stream)] * SPMD_RANKS:
                raise AssertionError(f"{label}: a one-option round must "
                                     "be one dispatch and one apply a "
                                     "shard")
            res = {"adds": len(stream), "applies": applies,
                   "dispatches": dispatches, "per_add": per_add}
            if upd == "default":
                res["aliasing"] = spmd_aliasing(tabs, otab[0], stream)
            out[upd] = res
        finally:
            spmd_close(ctxs + octxs)
    return out


def spmd_aliasing(tabs, oracle, stream) -> dict:
    """(b): pin one grouped shard's slab, apply a grouped wave, and hold
    the pinned rows to a copy taken before; then ``set_rows`` on that
    member evicts it alone, and the table equals the classic one with the
    same ``set_rows``."""
    import torch
    sh = tabs[1]._shard
    plane = sh._plane
    pin = sh._pin_data()
    try:
        before = pin.data.clone()
        ids, vals = stream[0]
        tabs[2].add_rows(ids, vals)   # a grouped wave over every slot
        oracle.add_rows(ids, vals)
        torch.cuda.synchronize()
        if pin.data.data_ptr() == plane.stack.data_ptr() or not \
                torch.equal(pin.data, before):
            raise AssertionError("spmd (b): the pinned slab changed under "
                                 "a grouped apply")
        if torch.equal(sh._data, before):
            raise AssertionError("spmd (b): the grouped apply missed the "
                                 "pinned shard")
    finally:
        sh._release_data(pin)
    rows = np.arange(sh.lo, sh.lo + 64)
    vals = np.full((rows.size, SPMD_TABLE[1]), 3.0, np.float32)
    tabs[0].set_rows(rows, vals)
    oracle.set_rows(rows, vals)
    others = [t._shard._plane is plane for i, t in enumerate(tabs) if i != 1]
    if sh._plane is not None or not all(others):
        raise AssertionError("spmd (b): set_rows did not evict exactly its "
                             "member")
    if not np.array_equal(tabs[3].get(), oracle.get()):
        raise AssertionError("spmd (b): after the eviction the table "
                             "differs from the classic one")
    log("spmd (b) pinned slab unchanged by a grouped apply; set_rows "
        f"evicted slot 1 alone ({sum(others)} members still grouped); the "
        "table = the classic one bit for bit")
    return {"pinned_unchanged": True, "grouped_after_evict": sum(others)}


def spmd_clients(tabs, seconds: float, counts: list, lat: list,
                 warm: bool = False) -> float:
    """SPMD_CLIENTS threads, client w on ``tabs[w % n]``: a 2048-row
    ``add_rows_async`` of ones on its own strided rows (every shard's
    range), then a ``get_rows`` of them, for ``seconds`` (or SPMD_WARM
    rounds when ``warm``). Returns the wall seconds."""
    import threading
    rows, dim = SPMD_TABLE
    ones = np.ones((SPMD_BATCH, dim), np.float32)
    n = len(tabs)
    errors = []

    def client(w):
        try:
            t = tabs[w % n]
            ids = np.arange(SPMD_BATCH) * (rows // SPMD_BATCH) + w
            mids = []
            stop = time.perf_counter() + seconds
            k = 0
            while (k < SPMD_WARM) if warm else (time.perf_counter() < stop):
                mids.append(t.add_rows_async(ids, ones))
                counts[w] += 1
                if len(mids) >= 4:
                    t.wait(mids.pop(0))
                g0 = time.perf_counter()
                t.get_rows(ids)
                if not warm:
                    lat.append((time.perf_counter() - g0) * 1e3)
                k += 1
            for m in mids:
                t.wait(m)
        except BaseException as e:   # noqa: BLE001 — surfaced below
            errors.append(e)

    ths = [threading.Thread(target=client, args=(w,))
           for w in range(SPMD_CLIENTS)]
    t0 = time.perf_counter()
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=seconds + 120)
    dt = time.perf_counter() - t0
    if any(th.is_alive() for th in ths):
        raise AssertionError("spmd (c): a client did not finish")
    if errors:
        raise errors[0]
    return dt


def spmd_pair(dev, n: int, tmp: str) -> dict:
    """(c) one point of the curve: n shards, a world with both flags armed
    and one with both off, alive together and driven in turns (armed,
    off, armed, ...: SPMD_WINDOWS windows of SPMD_SECONDS each), so a
    drift of the host's speed falls on both planes alike and the spread
    of the windows says whether the planes differ. Returns
    {"armed": point, "off": point}."""
    import torch
    rows, dim = SPMD_TABLE
    worlds = {}
    t0 = time.perf_counter()
    try:
        for armed in (True, False):
            name = "armed" if armed else "off"
            worlds[name] = spmd_world(
                dev, n, os.path.join(tmp, f"c{n}{name}"), "spmd_c",
                "default", armed=armed)
        pts = {}
        for name, (_ctxs, tabs) in worlds.items():
            counts = [0] * SPMD_CLIENTS
            spmd_clients(tabs, 0.0, counts, [], warm=True)
            plane = tabs[0]._shard._plane
            if name == "armed" and n > 1 and (plane is None
                                              or not plane.active):
                raise AssertionError(f"spmd (c) n={n}: the shards did not "
                                     "stack")
            if name == "off" and plane is not None:
                raise AssertionError(f"spmd (c) n={n}: a plane with the "
                                     "flags off")
            pts[name] = {"tabs": tabs, "plane": plane, "counts": counts,
                         "c0": sum(counts), "lat": [], "windows": [],
                         "d0": plane._dispatches if plane is not None else 0,
                         "cow0": sum(t._shard._stat_cow for t in tabs)}
        t_warm = time.perf_counter()
        for _ in range(SPMD_WINDOWS):
            for name, pt in pts.items():
                ops0 = sum(pt["counts"]) + len(pt["lat"])
                dt = spmd_clients(pt["tabs"], SPMD_SECONDS, pt["counts"],
                                  pt["lat"])
                ops = sum(pt["counts"]) + len(pt["lat"]) - ops0
                pt["windows"].append((dt, ops * SPMD_BATCH / dt))
        torch.cuda.synchronize()
        t_drive = time.perf_counter()
        out = {}
        for name, pt in pts.items():
            tabs, plane, counts, lat = (pt["tabs"], pt["plane"],
                                        pt["counts"], pt["lat"])
            adds = sum(counts) - pt["c0"]
            # the deltas are ones: a row's value is exactly its count of
            # adds
            want = np.zeros((rows, dim), np.float32)
            for w in range(SPMD_CLIENTS):
                want[np.arange(SPMD_BATCH) * (rows // SPMD_BATCH) + w] = \
                    counts[w]
            if not np.array_equal(tabs[0].get(), want):
                raise AssertionError(f"spmd (c) n={n} {name}: a row is "
                                     "not its count of adds")
            secs = sum(dt for dt, _r in pt["windows"])
            wr = [r for _dt, r in pt["windows"]]
            out[name] = {
                "n": n, "plane": name, "seconds": secs, "adds": adds,
                "gets": len(lat),
                # rows moved: each op carries one 2048-row batch
                "rows_per_s": (adds + len(lat)) * SPMD_BATCH / secs,
                "window_rows_per_s": wr,
                "get_p50_ms": float(np.percentile(lat, 50)),
                "get_p99_ms": float(np.percentile(lat, 99)),
                "dispatches_per_add": ((plane._dispatches - pt["d0"]) / adds
                                       if plane is not None else None),
                # copy-on-write clones of a shard's table (an add that
                # found the slab pinned by a get), per add
                "cow_per_add": (sum(t._shard._stat_cow for t in tabs)
                                - pt["cow0"]) / adds}
        if n == SPMD_PROFILE_N:
            out["armed"]["profile"] = profile(
                f"spmd (c) n={n} armed, {SPMD_CLIENTS} clients for 0.3 s",
                lambda: spmd_clients(pts["armed"]["tabs"], 0.3,
                                     [0] * SPMD_CLIENTS, []))
        t_check = time.perf_counter()
        return out
    finally:
        for ctxs, _tabs in worlds.values():
            for c in ctxs:
                c.close()
        from multiverso_tpu_torch.ps import spmd
        spmd.reset_registry()
        if worlds and "t_check" in locals():
            log(f"spmd (c) n={n} seconds: worlds and warm-up "
                f"{t_warm - t0:.2f}, the windows {t_drive - t_warm:.2f}, "
                f"the checks (and the profile) {t_check - t_drive:.2f}, "
                f"the close {time.perf_counter() - t_check:.2f}")


def phase_spmd(dev) -> dict:
    """The PS half of the mesh data plane: (a) grouped parity on the card,
    (b) the aliasing check, (c) the scale curve, flags armed and off."""
    import tempfile
    from multiverso_tpu_torch.utils import config
    saved = {f: config.get_flag(f)
             for f in ("ps_fanout", "ps_spmd_stack", "hotkeys_capacity")}
    config.set_flag("hotkeys_capacity", SPMD_HOTKEYS)
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out = {"parity": spmd_parity(dev, tmp)}
            t1 = time.perf_counter()
            curve = {"armed": {}, "off": {}}
            for n in SPMD_SHARDS:
                for name, p in spmd_pair(dev, n, tmp).items():
                    curve[name][n] = p
    finally:
        for f, v in saved.items():
            config.set_flag(f, v)
    for name, pts in curve.items():
        t_1 = pts[1]["rows_per_s"]
        for n, p in pts.items():
            p["efficiency"] = p["rows_per_s"] / (n * t_1)
            dpa = p["dispatches_per_add"]
            wr = p["window_rows_per_s"]
            log(f"spmd (c) {name} n={n}: T_n {p['rows_per_s']:.0f} rows/s "
                f"({p['adds']} adds and {p['gets']} gets of {SPMD_BATCH} "
                f"rows in {p['seconds']:.3f} s, {SPMD_CLIENTS} clients; "
                f"its {len(wr)} windows {min(wr):.0f}-{max(wr):.0f}), "
                f"E_n {p['efficiency']:.3f}, Get p50 {p['get_p50_ms']:.3f} "
                f"ms, p99 {p['get_p99_ms']:.3f} ms, plane dispatches an add "
                + ("-" if dpa is None else f"{dpa:.2f}")
                + f", table copies an add {p['cow_per_add']:.3f}"
                + f"; every row = its count of adds ({card_label()})")
    for n in SPMD_SHARDS:
        a, o = curve["armed"][n], curve["off"][n]
        aw, ow = a["window_rows_per_s"], o["window_rows_per_s"]
        # the windows ran in turns: armed below off in every turn means the
        # plane is slower there, whatever the host's drift
        verdict = ("armed slower in every turn" if max(aw) < min(ow) else
                   "armed faster in every turn" if min(aw) > max(ow) else
                   "the windows overlap")
        turns = ", ".join(f"{x / y:.3f}" for x, y in zip(aw, ow))
        log(f"spmd (c) n={n}: armed/off T_n "
            f"{a['rows_per_s'] / o['rows_per_s']:.3f} (turn by turn "
            f"{turns}): {verdict}")
    out["curve"] = curve
    log(f"spmd phase: {time.perf_counter() - t0:.1f} s ((a)+(b) "
        f"{t1 - t0:.1f} s, (c) {time.perf_counter() - t1:.1f} s)")
    return out


# world: the multi-process world (``net_init`` over a TCPStore, the Zoo's
# world, the collective table adds and unions, ``aggregate``,
# ``StoreRendezvous``): two ranks on this one card, started as a launcher
# starts them (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK), meet
# over gloo (NCCL refuses two ranks on one card); each keeps a replica of
# every table. (a) tests/multiprocess_worker.py's steps with the tables on
# the card; (b) the LM at its widths, cut to WORLD_LAYERS layers, trained
# data-parallel through one shared table; (c) bench.py:419's aggregate
# cell (16 MB, process_sum against allgather + sum) at world 2, not 4
WORLD_RANKS = 2
WORLD_LAYERS = 2          # the LM's depth cut (widths kept)
WORLD_STEPS = 4           # train_ps steps a rank, each on its own batch
WORLD_SYNC_EVERY = 2
WORLD_AGG_MB = 16.0       # bench.py:419 bench_aggregate_path's payload
WORLD_AGG_REPS = 5
WORLD_TIMEOUT_S = 300


def world_tree_save(tmp: str) -> int:
    """The LM's seed-0 tree cut to WORLD_LAYERS layers, saved as .npy
    files for the ranks; returns its parameter count."""
    from multiverso_tpu_torch.models import transformer as tfm
    n = 0
    for key, leaf in tfm.tp_lib.leaves(lm_init_params(LAYERS)):
        if key[0] == "layers":
            leaf = leaf[:WORLD_LAYERS]
        np.save(os.path.join(tmp, "w_" + "_".join(key) + ".npy"), leaf)
        n += leaf.size
    return n


def world_tree_load(tmp: str) -> dict:
    from multiverso_tpu_torch.models import transformer as tfm
    tree = {"layers": {}}
    for key, _ in tfm.tp_lib.leaves(tfm.param_shapes(lm_config(
            WORLD_LAYERS))):
        arr = np.load(os.path.join(tmp, "w_" + "_".join(key) + ".npy"),
                      mmap_mode="r")
        (tree["layers"] if key[0] == "layers" else tree)[key[-1]] = arr
    return tree


def world_digest(a: np.ndarray) -> list:
    """A cheap fingerprint of a table's bytes (wrapping sum and xor of its
    64-bit words), to hold the ranks' replicas to each other."""
    w = np.ascontiguousarray(a).view(np.uint8)
    w = w[: w.size // 8 * 8].view(np.uint64)
    return [int(np.sum(w, dtype=np.uint64)),
            int(np.bitwise_xor.reduce(w))]


def ulps(a, ref, atol: float) -> float:
    """The largest |a - ref| over each element's allowance: one bf16 ulp
    of the element of ``ref``, or ``atol`` where that is larger (a value
    of 1 or less passes). The kernel phase's absolute tolerances are one
    ulp at the magnitudes its seed-0 inputs reach; other inputs reach
    larger ones."""
    import torch
    r = ref.float().abs()
    ulp = torch.exp2(torch.floor(torch.log2(r.clamp_min(2.0 ** -126))) - 7)
    return float(((a.float() - ref.float()).abs() / ulp.clamp_min(atol)
                  ).max())


def world_kernels(dev, rank: int) -> dict:
    """B1-B3 against their plain versions on this rank, at the shape the
    LM gives them (bf16, causal): each element within one bf16 ulp of the
    plain version's, or the kernel phase's tolerance where that is larger
    (ATOL_OUT, ATOL_LSE, ATOL_BWD). Returns the max abs errors and the
    ulps."""
    import torch
    from multiverso_tpu_torch.ops import attention_kernels as ak
    gen = torch.Generator(device=dev).manual_seed(100 + rank)
    q, k, v, do = (torch.randn(SLICE_SHAPE, generator=gen, device=dev
                               ).to(torch.bfloat16) for _ in range(4))
    out, lse = ak.flash_attention_with_lse(q, k, v, True)
    ref, ref_lse = ak.flash_forward_plain(q, k, v, True, True)
    dq = ak._flash_bwd_dq_cuda(q, k, v, out, lse, do, True)
    dk, dv = ak._flash_bwd_dkv_cuda(q, k, v, out, lse, do, True)
    bwd = ak.flash_backward_plain(q, k, v, out, lse, do, True)
    torch.cuda.synchronize()
    tol_b = ATOL_BWD["bfloat16"]
    errs = {"flash_fwd": max_err(out, ref),
            "flash_bwd_dq": max_err(dq, bwd[0]),
            "flash_bwd_dkv": max(max_err(dk, bwd[1]), max_err(dv, bwd[2])),
            "lse": max_err(lse, ref_lse)}
    within = {"flash_fwd": ulps(out, ref, ATOL_OUT["bfloat16"]),
              "flash_bwd_dq": ulps(dq, bwd[0], tol_b),
              "flash_bwd_dkv": max(ulps(dk, bwd[1], tol_b),
                                   ulps(dv, bwd[2], tol_b))}
    if max(within.values()) > 1.0 or errs["lse"] > ATOL_LSE:
        raise AssertionError(f"rank {rank}: a flash kernel disagrees with "
                             f"its plain version: max abs {errs}, ulps "
                             f"{within}")
    return {"max_abs_err": errs, "ulps": within}


class WorldSync:
    """A SharedPytree whose collective ``sync`` is timed and checked:
    before the sync each rank saves its delta in the phase's directory
    (a path apart from the table's all_reduce); after it the table must
    equal numpy's ``last + sum of the ranks' deltas`` bit for bit (two
    f32 terms: their sum does not depend on the order). Every rank has
    saved its delta before it enters the sync's all_reduce, so the files
    are whole once the sync returns."""

    def __init__(self, shared, tmp: str, rank: int, world: int):
        self.shared, self.tmp = shared, tmp
        self.rank, self.world = rank, world
        self.ms, self.check_ms, self.digests = [], [], []

    def sync(self, params):
        import torch
        from multiverso_tpu_torch.sharedvar import _flatten
        last = self.shared._last
        paths = [os.path.join(self.tmp, f"delta_{len(self.ms)}_{r}.npy")
                 for r in range(self.world)]
        t0 = time.perf_counter()
        np.save(paths[self.rank], _flatten(params) - last)
        check_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        merged = self.shared.sync(params)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        total = np.load(paths[0])
        for p in paths[1:]:
            total += np.load(p, mmap_mode="r")
        if not np.array_equal(self.shared._last, last + total):
            raise AssertionError("world sync: the table is not last + the "
                                 "sum of every rank's delta")
        self.check_ms.append(check_ms + (time.perf_counter() - t0) * 1e3)
        self.digests.append(world_digest(self.shared._last))
        return merged


def world_lm(tmp: str) -> dict:
    """(b) on this rank: the LM's table shared across the world, the
    model built from its Get, WORLD_STEPS SGD steps on this rank's own
    batch with a checked collective sync every WORLD_SYNC_EVERY."""
    import torch
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.examples.transformer_ps import train_ps
    from multiverso_tpu_torch.models import transformer as tfm
    from multiverso_tpu_torch.ops import attention_kernels as ak
    from multiverso_tpu_torch.sharedvar import _flatten
    dev, rank = mv.device(), mv.rank()
    cfg = lm_config(WORLD_LAYERS)
    errs = world_kernels(dev, rank)
    tree = world_tree_load(tmp)
    t0 = time.perf_counter()
    shared = mv.SharedPytree(tree, name="world_lm")   # rank 0's values
    share_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(shared._last, _flatten(tree)):
        raise AssertionError("the shared table is not rank 0's parameters")
    model = tfm.params_from_jax(shared.get(), cfg, dev)
    rng = np.random.default_rng(1 + rank)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (BATCH, cfg.max_seq + 1))).to(dev)
    tok, tgt = toks[:, :-1], toks[:, 1:]
    sgd = tfm.make_train_step(cfg, LR)
    float(sgd(model, tok, tgt))   # warm-up, outside the counted run
    checked = WorldSync(shared, tmp, rank, mv.size())
    ak.reset_launch_counts()
    losses = train_ps(model, checked, tok, tgt, WORLD_STEPS,
                      WORLD_SYNC_EVERY, LR)
    counts = ak.launch_counts()
    want = WORLD_LAYERS * WORLD_STEPS
    if counts != {k: want for k in ("flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv")}:
        raise AssertionError(f"rank {rank}: world launches {counts}, "
                             f"expected {want} of each kernel")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"rank {rank}: the loss did not fall: {losses}")
    n = shared.table.size
    del model, shared
    torch.cuda.empty_cache()
    return {"losses": losses, "launches": counts, "kernel_errs": errs,
            "params": n, "share_ms": share_ms, "sync_ms": checked.ms,
            "check_ms": checked.check_ms, "digests": checked.digests,
            "sync_bytes": n * 4}


def world_aggregate() -> dict:
    """(c) on this rank: ``process_sum`` (one all_reduce, what
    ``mv.aggregate`` runs) against allgather + numpy sum on a 16 MB f32
    payload, in turns; equal results; ms per call."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.parallel import collectives as coll
    rank, world = mv.rank(), mv.size()
    arr = np.full(int(WORLD_AGG_MB * 1e6 / 4), float(rank + 1), np.float32)
    want = np.float32(world * (world + 1) / 2)

    def gathered(a):
        return coll.process_allgather(a).sum(axis=0, dtype=np.float32)

    paths = {"process_sum": coll.process_sum, "allgather": gathered}
    ms = {k: [] for k in paths}
    for name, fn in paths.items():   # warm
        if not np.all(fn(arr) == want):
            raise AssertionError(f"aggregate {name} is not {want}")
    for _ in range(WORLD_AGG_REPS):
        for name, fn in paths.items():
            t0 = time.perf_counter()
            got = fn(arr)
            ms[name].append((time.perf_counter() - t0) * 1e3)
            if not np.all(got == want):
                raise AssertionError(f"aggregate {name} is not {want}")
    data = arr.copy()
    if mv.aggregate(data) is not data or not np.all(data == want):
        raise AssertionError("mv.aggregate is not the in-place sum")
    return {"ms": ms, "bytes": arr.nbytes}


def world_rank(tmp: str) -> None:
    """One rank of the world phase, in its own process: join the world
    from the environment (net_init), run (a), (b) and (c), print one
    ``RESULT <json>`` line."""
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.parallel.mesh import leave_world
    from multiverso_tpu_torch.utils import config
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "tests"))
    import torch_world_worker as tw
    walls = {}
    t0 = time.perf_counter()
    config.set_flag("net_timeout_s", float(WORLD_TIMEOUT_S))
    if mv.net_init() != 0:
        raise RuntimeError("net_init failed")
    walls["join"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = {"scenario": tw.scenario(None)}   # the card: no device argument
    walls["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mv.init()
    out["backend"] = dist.get_backend()
    out["device"] = str(mv.device())
    out["lm"] = world_lm(tmp)
    walls["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["agg"] = world_aggregate()
    walls["c"] = time.perf_counter() - t0
    mv.shutdown()
    leave_world()
    out["walls"] = {k: round(v, 2) for k, v in walls.items()}
    print("RESULT " + json.dumps(out), flush=True)


def world_launch(tmp: str) -> list:
    """Start WORLD_RANKS rank processes by environment, as a launcher
    does; their RESULT dicts in rank order. A world whose store lost its
    free port before rank 0 bound it is started once more."""
    import socket
    root = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke;"
            " chip_smoke.world_rank(sys.argv[2])")
    for attempt in range(2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = []
        for r in range(WORLD_RANKS):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), RANK=str(r),
                       WORLD_SIZE=str(WORLD_RANKS), LOCAL_RANK=str(r),
                       LOCAL_WORLD_SIZE=str(WORLD_RANKS))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, root, tmp], env=env, cwd=root,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        outs = []
        try:
            for p in procs:
                o, e = p.communicate(timeout=WORLD_TIMEOUT_S)
                outs.append((p.returncode, o, e))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if all(rc == 0 for rc, _, _ in outs):
            break
        if attempt or not any("address already in use" in e.lower()
                              for _, _, e in outs):
            raise AssertionError("world: a rank failed:\n" + "\n".join(
                f"rank {r} rc={rc}\n{e[-3000:]}"
                for r, (rc, _, e) in enumerate(outs) if rc != 0))
    res = []
    for r, (rc, o, e) in enumerate(outs):
        lines = [l for l in o.splitlines() if l.startswith("RESULT ")]
        if not lines:
            raise AssertionError(f"world: rank {r} printed no RESULT\n"
                                 f"{e[-2000:]}")
        res.append(json.loads(lines[-1][len("RESULT "):]))
    return res


def phase_world(dev) -> dict:
    """Two ranks of a world on this card, started by environment: (a) the
    JAX scenario's closed forms with the tables on the card, (b) the LM
    trained data-parallel through one shared table, (c) the aggregate
    cell. Returns the flash launches summed over the ranks."""
    import shutil
    import tempfile
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import torch_world_worker as tw
    tmp = tempfile.mkdtemp(prefix="mv_world_")
    try:
        t0 = time.perf_counter()
        n = world_tree_save(tmp)
        t1 = time.perf_counter()
        ranks = world_launch(tmp)
        t2 = time.perf_counter()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"world: {WORLD_RANKS} ranks on this card (backend "
        f"{ranks[0]['backend']}, {[rk['device'] for rk in ranks]}), the "
        f"LM's {n} parameters saved for them in {t1 - t0:.1f} s, ranks "
        f"{t2 - t1:.1f} s; rank walls (s) {[rk['walls'] for rk in ranks]}")
    # (a)
    want = tw.closed_forms(WORLD_RANKS)
    for r, rk in enumerate(ranks):
        got = rk["scenario"]
        bad = {k: got.get(k) for k, v in want.items() if got.get(k) != v}
        if got["rank"] != r or bad:
            raise AssertionError(f"world (a) rank {r}: {bad}")
        if not (got["devices"] == got["num_servers"] == WORLD_RANKS
                and got["rendezvous"] == "StoreRendezvous"):
            raise AssertionError(f"world (a) rank {r}: {got}")
    log(f"world (a) the JAX multi-process scenario on the card, both ranks "
        f"equal to its closed forms: {ranks[0]['scenario']}")
    # (b)
    b = [rk["lm"] for rk in ranks]
    for r, lm in enumerate(b):
        log(f"world (b) rank {r}: {WORLD_LAYERS} layers, {lm['params']} "
            f"f32 parameters in the shared table, shared in "
            f"{lm['share_ms']:.1f} ms; losses "
            f"{[round(x, 5) for x in lm['losses']]}; sync ms "
            f"{[round(x, 1) for x in lm['sync_ms']]} ({lm['sync_bytes']} B "
            f"all-reduced through gloo a sync); the numpy check's ms "
            f"(deltas through files) {[round(x, 1) for x in lm['check_ms']]}"
            f"; B1-B3 "
            f"{lm['launches']}; kernel vs plain "
            f"{lm['kernel_errs']['max_abs_err']}, in allowances (one bf16 "
            f"ulp or the kernel phase's tolerance) "
            f"{lm['kernel_errs']['ulps']}")
    if any(lm["digests"] != b[0]["digests"] for lm in b):
        raise AssertionError("world (b): the ranks' tables differ")
    log(f"world (b) every sync equal to numpy's last + the ranks' deltas "
        f"bit for bit on each rank, the replicas equal ({len(b[0]['digests'])}"
        f" syncs)")
    # (c)
    for r, rk in enumerate(ranks):
        ms = rk["agg"]["ms"]
        log(f"world (c) aggregate rank {r}, {rk['agg']['bytes']} B f32 at "
            f"world {WORLD_RANKS}: process_sum p50 "
            f"{float(np.median(ms['process_sum'])):.2f} ms "
            f"{[round(x, 2) for x in ms['process_sum']]}, allgather + sum "
            f"p50 {float(np.median(ms['allgather'])):.2f} ms "
            f"{[round(x, 2) for x in ms['allgather']]}; equal results")
    counts = {k: sum(rk["lm"]["launches"][k] for rk in ranks)
              for k in ranks[0]["lm"]["launches"]}
    log(f"world launches summed over the ranks {counts}")
    return counts


# harness: the reference's Test/main.cpp battery
# (``multiverso_tpu_torch/harness.py``, ``python -m
# multiverso_tpu_torch.harness``), the binding handlers, the XOR example
# trained on them, TorchParamManager and threefry.normal; host code and
# torch ops on the tables, no kernel of the port. (a) every entry of the
# battery's _ALL and the two perf entries (rows at the harness's default,
# 100,000 x 50) in one process on the card; (b) kv, matrix, array and
# allreduce as two processes of one world on this card (gloo), in one
# relaunch; (c) the handlers, examples/xor_mlp.py and TorchParamManager on
# the card against the same runs on the CPU; (d) threefry.normal on the
# card against the CPU at tests/test_torch_threefry.py's bound
HAR_ENTRIES = ("kv", "array", "net", "ip", "matrix", "checkpoint",
               "restore", "allreduce", "async", "ftrl_sparse", "readers",
               "dense_perf", "sparse_perf")
HAR_WORLD_ENTRIES = ("kv", "matrix", "array", "allreduce")
HAR_TIMEOUT_S = 120      # each battery process, and (b)'s world
# XOR's losses: 1,000 f32 gradient steps whose tanh, sigmoid and log are
# the card's and the CPU's own; the print's last digit (the CPU test holds
# the port to the JAX example within it too)
HAR_XOR_ATOL = 1e-4
# threefry.normal, the card against the CPU: log1p is each device's own
# (within an ulp of the exact value on each), the rest exact in f32 or
# f64: tests/test_torch_threefry.py's bound against jax.random.normal
HAR_NORMAL_MAX_ULPS = 3
HAR_NORMAL_MAX_SHARE = 0.015
HAR_NORMAL_SHAPES = ((7,), (3, 5), (64, 64), (256, 512))


def har_start(args) -> tuple:
    """Start one ``python -m multiverso_tpu_torch.harness`` run."""
    root = os.path.dirname(os.path.abspath(__file__))
    return (subprocess.Popen(
        [sys.executable, "-m", "multiverso_tpu_torch.harness", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=root), time.perf_counter())


def har_finish(started: tuple, label: str) -> dict:
    """Wait for a run of :func:`har_start` within HAR_TIMEOUT_S of its
    start (killed and failed past it); its HARNESS PASS lines and entry
    seconds."""
    proc, t0 = started
    try:
        out, err = proc.communicate(
            timeout=max(HAR_TIMEOUT_S - (time.perf_counter() - t0), 1))
    except subprocess.TimeoutExpired as e:
        proc.kill()
        proc.wait()
        raise AssertionError(f"harness {label}: no end within "
                             f"{HAR_TIMEOUT_S} s") from e
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"harness {label} failed (rc "
                             f"{proc.returncode}; 77 is distributed "
                             f"unavailable, a failure here too):\n"
                             f"{out[-2000:]}\n{err[-3000:]}")
    lines = out.splitlines()
    passes = [l for l in lines if l.startswith("HARNESS PASS")]
    times = {l.split()[2]: float(l.split()[3]) for l in lines
             if l.startswith("HARNESS TIME")}
    perf = [l.split("] ")[-1] for l in lines if "get all rows" in l]
    return {"passes": passes, "times": times, "perf": perf, "wall": wall}


def har_handlers() -> dict:
    """The handlers and TorchParamManager on the Zoo's device: the tables
    and the module's parameters after the same adds, syncs and pulls
    (float32 adds and subtractions: exact on any device)."""
    import torch
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.handlers import (ArrayTableHandler,
                                               MatrixTableHandler)
    from multiverso_tpu_torch.torch_ext import TorchParamManager

    dev = mv.device()
    rng = np.random.default_rng(21)
    init = rng.normal(size=(64, 32)).astype(np.float32)
    a = ArrayTableHandler(init.size, init_value=init.reshape(-1),
                          name="har_array")
    m = MatrixTableHandler(64, 32, init_value=init, name="har_matrix")
    for k in range(4):
        d = rng.normal(size=(64, 32)).astype(np.float32)
        a.add(d.reshape(-1), sync=True)
        m.add(torch.from_numpy(d).to(dev) if k % 2 else d, sync=True)
        rows = rng.integers(0, 64, 16)
        m.add(d[rows], row_ids=rows, sync=True)
    out = {"array": a.get(), "matrix": m.get(), "rows": m.get([3, 5, 63])}
    torch.manual_seed(5)
    model = torch.nn.Sequential(torch.nn.Linear(32, 64), torch.nn.Tanh(),
                                torch.nn.Linear(64, 8)).to(dev)
    mgr = TorchParamManager(model, name="har_params")
    if mgr.table.raw().device != dev or next(model.parameters()).device != dev:
        raise AssertionError("TorchParamManager left the Zoo's device")
    flats = []
    for step in range(4):
        with torch.no_grad():
            for p in model.parameters():
                p.add_(torch.from_numpy(rng.normal(
                    0, 0.1, tuple(p.shape)).astype(np.float32)).to(dev))
        mgr.pull() if step == 2 else mgr.sync()
        flats.append(torch.cat([p.detach().reshape(-1).cpu()
                                for p in model.parameters()]).numpy())
    out["params"] = np.stack(flats)
    out["table"] = mgr.table.get()
    return out


def har_normal(dev) -> dict:
    """threefry.normal on ``dev`` against the CPU, seeds 0-7."""
    from multiverso_tpu_torch.utils import threefry

    def ordered(x):
        i = np.ascontiguousarray(x, np.float32).view(np.int32).astype(
            np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    worst, differ, total = 0, 0, 0
    for seed in range(8):
        for shape in HAR_NORMAL_SHAPES:
            card = threefry.normal(threefry.key(seed), shape, device=dev)
            cpu = threefry.normal(threefry.key(seed), shape)
            if card.device != dev:
                raise AssertionError(f"threefry.normal drew on {card.device}")
            d = np.abs(ordered(card.cpu().numpy()) - ordered(cpu.numpy()))
            worst = max(worst, int(d.max()))
            differ += int((d > 0).sum())
            total += d.size
    return {"max_ulps": worst, "share": differ / total, "draws": total}


def phase_harness(dev) -> dict:
    """(a) the single-process battery on the card, (b) four entries as a
    world of two processes on this card, (c) the handlers, XOR and
    TorchParamManager on the card against the CPU, (d) threefry.normal on
    the card against the CPU."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.examples import xor_mlp

    lap = Laps("harness")
    # the battery runs on the card by default; a rehearsal on the CPU
    # names it
    where = ["-device=cpu"] if dev.type == "cpu" else []
    # (a) and (b) side by side: each process spends most of its wall
    # starting torch and CUDA
    b_run = har_start([*HAR_WORLD_ENTRIES, *where, "-nprocs=2",
                       f"-timeout_s={HAR_TIMEOUT_S - 10}"])
    try:
        a = har_finish(har_start([*HAR_ENTRIES, *where]), "(a)")
    finally:
        b = har_finish(b_run, "(b)")
    if a["passes"] != [f"HARNESS PASS {n}" for n in HAR_ENTRIES]:
        raise AssertionError(f"harness (a): {a['passes']}")
    log(f"harness (a) {len(HAR_ENTRIES)} entries in one process on the "
        f"card, each passed; seconds by entry {a['times']}; "
        f"{a['wall']:.1f} s for the process (beside (b)'s relaunch)")
    for line in a["perf"]:
        log(f"harness (a) perf: {line}")
    want = [f"HARNESS PASS {n}" for n in HAR_WORLD_ENTRIES]
    if b["passes"] != want + [f"{w} (nprocs=2)" for w in want]:
        raise AssertionError(f"harness (b): {b['passes']}")
    log(f"harness (b) {', '.join(HAR_WORLD_ENTRIES)} as a world of 2 "
        f"processes on this card (gloo), each passed on both ranks; rank "
        f"0's seconds by entry {b['times']}; {b['wall']:.1f} s for the "
        f"relaunch")
    lap("(a) battery and (b) world of 2, side by side")

    # (c): the card's Zoo (this run's) first, then the CPU's, then back
    card = har_handlers()
    mv.shutdown()
    card_xor = xor_mlp.train(device=dev)
    cpu_xor = xor_mlp.train(device="cpu")
    mv.init(device="cpu")
    cpu = har_handlers()
    mv.shutdown()
    mv.init(device=dev)
    for k in card:
        if not np.array_equal(card[k], cpu[k]):
            raise AssertionError(f"harness (c) {k}: the card's differs from "
                                 f"the CPU's")
    err = max(abs(x - y) for (_, x), (_, y) in zip(card_xor[0], cpu_xor[0]))
    log(f"harness (c) the handlers' tables (sync adds, numpy and tensor "
        f"deltas, row adds) and TorchParamManager's parameters over 4 "
        f"syncs and pulls on the card equal the CPU's bit for bit; XOR on "
        f"the card: losses {card_xor[0]}, predictions {card_xor[1]}; CPU "
        f"{cpu_xor[0]}; max |diff| {err:.2e} (bound {HAR_XOR_ATOL})")
    if not (err <= HAR_XOR_ATOL and card_xor[1] == [0, 1, 1, 0]):
        raise AssertionError("harness (c): XOR on the card")
    lap("(c) handlers, XOR, TorchParamManager")
    n = har_normal(dev)
    log(f"harness (d) threefry.normal, {n['draws']} draws (seeds 0-7), the "
        f"card against the CPU: max {n['max_ulps']} ulps (bound "
        f"{HAR_NORMAL_MAX_ULPS}), {n['share']:.4%} differ (bound "
        f"{HAR_NORMAL_MAX_SHARE:.1%})")
    if not (n["max_ulps"] <= HAR_NORMAL_MAX_ULPS
            and n["share"] <= HAR_NORMAL_MAX_SHARE):
        raise AssertionError("harness (d): threefry.normal on the card")
    lap("(d) threefry.normal")
    return {"battery": a, "world": b, "normal": n, "xor": card_xor}


def lm_group(name: str) -> str:
    """The LM's kernel groups: each flash kernel, the GEMMs, the rest."""
    low = name.lower()
    return ("flash_bwd_dq" if "flash_bwd_dq" in low else
            "flash_bwd_dkv" if "flash_bwd_dkv" in low else
            "flash_fwd" if "flash_fwd" in low else
            "matmul" if any(t in low for t in ("gemm", "nvjet", "cutlass",
                                               "sm90_xmma")) else
            "elementwise/reduce/copy")


@walled
def profile(label: str, fn, top: int = 8, group=lm_group) -> dict:
    """Where one call of ``fn`` spends its device time: torch.profiler over
    it (after the counted run), device time by kernel and by ``group`` of
    the kernel's name, and the idle share. Returns {"wall_ms", "busy_ms",
    "groups"} (busy 0 when the profiler saw no device activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as trace

    # the device's activity only: every number below is read from it, and
    # recording each CPU op as well took the profiler's own bookkeeping to
    # 12.6-33.0 s for one profiled WE epoch on the card's host
    with trace(activities=[ProfilerActivity.CUDA
                           if torch.cuda.is_available()
                           else ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, memcpy)
    rows = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    busy = sum(ms for _, ms in rows)
    if busy == 0:
        log(f"{label} profile: wall {wall:.3f} ms, device time not measured "
            f"(the profiler saw no device activity)")
        return {"wall_ms": wall, "busy_ms": 0.0, "groups": {}}
    log(f"{label} profile (profiler on): wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms, idle share {max(0.0, 1 - busy / wall):.3f}")
    groups = {}
    for name, ms in rows:
        g = group(name)
        groups[g] = groups.get(g, 0.0) + ms
    log(f"{label} profile by group: " + ", ".join(
        f"{g} {ms:.3f} ms ({ms / busy:.1%})"
        for g, ms in sorted(groups.items(), key=lambda kv: -kv[1])))
    for name, ms in rows[:top]:
        log(f"  {ms:9.3f} ms {ms / busy:6.1%}  {name[:90]}")
    return {"wall_ms": wall, "busy_ms": busy, "groups": groups}


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    # a hang, or a run heading past its limit, dumps every thread's stack
    # and exits non-zero here instead of dying silently at the limit
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)

    # after a torch.profiler session kineto leaves CUPTI attached unless it
    # is told to tear it down, and every later launch pays for it on the
    # host: on an H100 a decode step of the decode phase's config (a) took
    # 1.8-3.1 ms after profiled calls without the teardown and 1.3-2.1 ms
    # with it (1.4-1.5 ms before any). The phases after the first profile
    # are host-bound, so their times would carry the profiler's cost
    os.environ.setdefault("TEARDOWN_CUPTI", "1")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script checks the port on the card",
              file=sys.stderr)
        return 1
    import multiverso_tpu_torch as mv

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, numpy {np.__version__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    walls = {}   # each phase's wall seconds, printed at the end

    def mark(name: str) -> None:
        walls[name] = round(time.perf_counter() - t_start - sum(
            walls.values()), 1)
        log(f"phase {name}: {walls[name]} s (total "
            f"{time.perf_counter() - t_start:.1f} s)")

    # the 472M LM's numpy parameters (ps, decode, telemetry, mesh and world
    # start from them) are drawn on a thread while nvcc builds the kernels,
    # and joined before anything is timed
    import threading
    draw = threading.Thread(target=lm_init_params, args=(LAYERS,),
                            name="lm_init_params")
    draw.start()
    phase_build()
    draw.join()
    mark("build")
    records = phase_kernel(torch.device("cuda", 0))
    mark("kernel")
    psn_build()   # the native PS library's first use in this run
    mv.init()   # the card: no device argument
    dev = mv.device()
    shared = phase_ps(dev, LAYERS)
    mark("ps")
    paths = {"request": {"flash_fwd": phase_request(dev, shared, LAYERS,
                                                    BATCHES)}}
    mark("request")
    torch.cuda.empty_cache()   # the request model is gone
    paths["train"] = phase_train(dev, shared, LAYERS)
    mark("train")
    del shared
    torch.cuda.empty_cache()   # the LM is gone
    # the WordEmbedding path, driven with the counts at 0: it runs no
    # kernel of the port (gathers, GEMMs and index_add_ are PyTorch's)
    from multiverso_tpu_torch.ops import attention_kernels as ak
    ak.reset_launch_counts()
    phase_we(dev)
    mark("we")
    paths["we"] = ak.launch_counts()
    log(f"we launches {paths['we']}")
    if any(paths["we"].values()):
        raise AssertionError("the WordEmbedding path launched a flash kernel")
    # the PS block path, counted the same way: no kernel of the port either
    ak.reset_launch_counts()
    phase_we_ps(dev)
    mark("we_ps")
    paths["we_ps"] = ak.launch_counts()
    log(f"we_ps launches {paths['we_ps']}")
    if any(paths["we_ps"].values()):
        raise AssertionError("the PS block path launched a flash kernel")
    import tempfile
    with tempfile.TemporaryDirectory() as lr_tmp:
        # LogisticRegression, counted the same way: no kernel of the port
        ak.reset_launch_counts()
        lr = phase_lr(dev, lr_tmp)
        mark("lr")
        paths["lr"] = ak.launch_counts()
        log(f"lr launches {paths['lr']}")
        if any(paths["lr"].values()):
            raise AssertionError("the LogisticRegression path launched a "
                                 "flash kernel")
        # the async PS plane, counted the same way: no kernel of the port
        ak.reset_launch_counts()
        psa = phase_ps_async(dev, lr["data"])
        mark("ps_async")
        paths["ps_async"] = ak.launch_counts()
        log(f"ps_async launches {paths['ps_async']}")
        if any(paths["ps_async"].values()):
            raise AssertionError("the async PS path launched a flash kernel")
    # ResNet, LDA and decode, each counted the same way: none of them runs
    # a kernel of the port (cuDNN's convolutions, index_add_, dense
    # products over the KV cache)
    # the client windows and train-while-serve DLRM, counted the same way:
    # host code, wire frames, autograd's GEMMs and index ops, no kernel
    # of the port; and failover, faults and replay: host code, wire frames
    # and shard copies between the card and the host; and the native
    # transport: host C++ and the same shard ops; and the cluster
    # telemetry plane and the PS half of the mesh data plane (stacked
    # shard groups: index_add_, index_select, the updaters' elementwise
    # ops), host code and the same shard ops
    later = {}
    for name, phase in (("resnet", phase_resnet), ("lda", phase_lda),
                        ("decode", phase_decode),
                        ("ps_window", phase_ps_window),
                        ("serving", phase_serving),
                        ("chaos", phase_chaos),
                        ("ps_native", phase_ps_native),
                        ("cluster", phase_cluster),
                        ("spmd", phase_spmd)):
        ak.reset_launch_counts()
        later[name] = phase(dev)
        mark(name)
        paths[name] = ak.launch_counts()
        log(f"{name} launches {paths[name]}")
        if any(paths[name].values()):
            raise AssertionError(f"the {name} path launched a flash kernel")
    # the telemetry plane: its LM's warm step and traced step each run
    # B1-B3 once a layer
    ak.reset_launch_counts()
    phase_telemetry(dev, psa["we_world2"], later)
    mark("telemetry")
    paths["telemetry"] = ak.launch_counts()
    log(f"telemetry launches {paths['telemetry']}")
    if paths["telemetry"] != {k: 2 * LAYERS for k in paths["telemetry"]}:
        raise AssertionError(f"the telemetry path launched "
                             f"{paths['telemetry']}, expected "
                             f"{2 * LAYERS} of each flash kernel")
    # the parallel layers on two ranks spawned on this card: the ranks
    # count their own launches (zeroed as each starts) and send them back
    paths["mesh"] = phase_mesh(dev)
    mark("mesh")
    if not all(paths["mesh"].values()):
        raise AssertionError(f"the mesh path launched {paths['mesh']}: "
                             "every flash kernel must run there")
    # the multi-process world: two ranks started by environment on this
    # card, each counting its own launches of the LM's train steps
    paths["world"] = phase_world(dev)
    mark("world")
    if not all(paths["world"].values()):
        raise AssertionError(f"the world path launched {paths['world']}: "
                             "every flash kernel must run there")
    # the battery, the handlers and TorchParamManager: host code and torch
    # ops on the tables, no kernel of the port (the battery's processes
    # are its own: they run no LM)
    ak.reset_launch_counts()
    phase_harness(dev)
    mark("harness")
    paths["harness"] = ak.launch_counts()
    log(f"harness launches {paths['harness']}")
    if any(paths["harness"].values()):
        raise AssertionError("the harness path launched a flash kernel")
    mv.shutdown()
    for rec in records:
        by_path = {p: c.get(rec["name"], 0) for p, c in paths.items()}
        rec["launches"] = sum(by_path.values())
        rec["launches_by_path"] = by_path
    log(f"total {time.perf_counter() - t_start:.1f} s; by phase (s) {walls}")
    log(f"card: {smi}")   # again: the run's first lines scroll away
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
