#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's batched query path, its rule
construction path, its path-compressed, quantized and seed layouts, its
streaming tries, its serve loop, its sharded trie, its launch profiler,
its LM serving path (dense, then MLA + MoE, then Mamba2 and Jamba's
hybrid unit), its placed LM paths on a process mesh, its training path
and its dry run on one NVIDIA GPU.

    python3 chip_smoke.py [--edges N] [--seed S] [--reps R]
                          [--tuning-out DIR] [--tuning-only]
                          [--dryrun-out DIR] [--dryrun-only] [--mesh-only]

1. Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc, in
   parallel, beside the latency probe ``probes/pointer_chase.cu``).
2. Builds ``synthetic_csr_trie(--edges)`` (default 2^20 rules) on the host
   and uploads it.  Then the ``[tuning]`` phase prints the launch config
   every later phase runs under (``kernels/tuning.get_kernel_config()``,
   which must be the defaults).  With ``--tuning-only`` it sweeps instead,
   and stops: every launch knob of ``kernels/tuning.py`` one at a time
   over powers of two around its default, every other knob at its
   default, on step 4's traffic (the rank kernel at k = 10 and 100 over
   the 256 prefixes, the membership kernel over the 256 items a role,
   trie_reduce on the trie, on 2^23 random columns and on its first 2-16
   tiles), the seed layout's 8192 x 8 sweep rows, the retail support
   counts of step 5 and a 1,024-request serve-loop drain.  Each value's
   outputs == the plain version's (``kernels.ref`` on the same card
   tensors) and the default's, bitwise (the reduction's sums bitwise
   against ``ref.trie_reduce_split_ref`` at the launch's block count and
   within 1e-6 of the default's; the drain against the default's drain);
   one line per (knob, value) with each lane's device ms by name (L2
   flushed, mean of --reps) and ``launch.roofline.kernel_roofline``'s
   bandwidth share, and the value the sweep would choose (the default
   unless another beats it by 2% in the sweep and again in turns).  The
   sweep's record goes to ``--tuning-out``/``sweep.json`` (default
   ``chiprun_out/tuning/``).
3. Holds every kernel against its plain PyTorch version on the card at
   full size: all rank metrics, k in {10, 100} and a k past small ranges,
   every rules_with role (min_depth 0 too: the item -1's consequent row
   holds the root, as in the reference), whole-trie and prefix ranges,
   duplicate, nested, empty and out-of-bounds ranges (a duplicate's row
   equal to its first copy's), and a tie-heavy copy of the columns.
   Bitwise equal, except the trie_reduce sums (1e-6 relative; bitwise
   against ``ref.trie_reduce_split_ref``, the plain mirror of the
   kernel's order, here and on every trie below).
4. Drives the main path through ``TrieQueryEngine`` with the launch
   counters at 0, checks every kernel launched and every answer against
   the tensor oracles, and times each op (CUDA events, median of --reps
   runs after warm-up) and each kernel beside its plain version (device
   time from a torch.profiler trace with the L2 flushed before each call,
   mean of --reps calls, and CUDA events around one call); the
   membership kernel once per role, each with its own bound (the score
   bytes at its members, ``ref.member_ranges_ref``, and the postings it
   reads).  The two descent searches (fused here, span in step 6) also
   get a latency floor: their longest chain of dependent load rounds on
   this data (the plain mirrors ``ref.rule_search_*_group_ref`` count it
   on the CPU) times one dependent load's latency, which a one-thread
   pointer chase measures on the card, cold (device memory) and warm
   (L2).  The reduction also gets its launch floor (the trie's first
   4,096 nodes), a time with the L2 flushed by reading, and a row on the
   2^23 hub trie (twice the L2), driven through ``ops.trie_reduce``.
5. Construction: makes ``online_retail_db()`` on the host, checks that
   apriori on the card finds the itemsets host apriori and fpgrowth find,
   holds the support-count kernel against its plain version on the card
   and the host bitmap sweep at every counting level and at the
   annotation, and its unstaged variant on a launch of 15,000 distinct
   items (past the shared-memory staging limit), exactly; then drives ``build_trie_of_rules(db, 0.002,
   miner="apriori", engine="arrays")`` with the counters at 0 (one launch
   per level, one for the annotation), compares its trie with the host
   build (structure bitwise, metrics to rtol 1e-6 / atol 1e-7) and its
   f32 columns with the same annotation on CPU tensors (bitwise), serves
   it through ``TrieQueryEngine`` against the oracles, and times each
   launch, its plain version and the build's mine / build / annotate
   split.
6. Compressed layout: builds ``synthetic_chain_trie(2^20,
   chain_fraction=0.75, seed=3)`` and four device tries from it (plain;
   ``layout="auto"``, which must pick compressed; int32 support + bf16
   and int32 support + int8 columns at ``n_transactions = 100,000``),
   drives every op on each with the launch counters at 0 (4096 search
   rows of width 8, 256 prefixes at k = 10 and 100, 256 items per role,
   trie_reduce), and checks: compressed f32 == plain bitwise (node ids,
   values, tie order), every kernel call == its plain version on the card
   bitwise on every trie (sums to 1e-6), the quantized answers within the
   README's error bounds of plain f32 (found and node exact), the
   membership kernel at min_depth 0 (the root answers the item -1's
   consequent row), and that the span search and the quantized rank,
   membership and reduce variants launched.  Then the retail trie of step
   5: ``auto`` keeps it plain, and served compressed with int32 + bf16
   columns at its real ``n_transactions`` it finds all its rules.  Both
   descent kernels == their plain versions on the plain chain trie, the
   retail trie (plain, and compressed f32 and int32 + bf16) and a 2^20
   hub trie with a 5,000-wide root (plain and compressed), with the
   edge-case rows of ``synthetic.edge_case_queries``.  Prints
   resident bytes, op ms compressed against plain, and the span and
   quantized kernels' times (the membership kernel per role, beside its
   f32 twin).
7. Seed layout (no CSR offsets): serves the 2^20 trie of step 2 (under a
   larger ``--edges`` a 2^20 trie of its own: the sweep is O(Q L E)) as a
   seed-layout ``DeviceTrie`` with the traffic of step 4 (the 4096 search
   rows and the canonical rows of the 256 ragged pairs in one batch),
   with the launch counters at 0: every answer == the CSR layout's in the
   same run bitwise (trie_reduce sums to 1e-6), one search makes exactly
   two full-sweep launches and no fused one, and both launches (the rows,
   then their consequent columns) == the plain version bitwise.  Logs each
   launch's active row-steps per step beside the row-steps it sweeps.
   Times the ops, the sweep kernel (both launches) beside its plain
   version, its bound and its compare floor (one 32-bit integer
   instruction per compare, 64 a clock per SM), and the
   reference bench's grid (``benchmarks/paper_figs.py``: E in {1,000,
   10,000, 100,000} x Q in {128, 2048}, width 6, plus the 2^20 x 4096 x 8
   point): the sweep kernel, the seed two-launch op, the fused kernel and
   the seed (lex binary search) and CSR oracles, with the fused-vs-sweep
   speedup.
8. Streaming: builds ``online_retail_db()``'s 100,000 sampled rule
   sequences into a base trie (the first 99,000) and the full trie on the
   card (one support-count launch each), and serves
   ``StreamingTrie(base)`` through ``TrieQueryEngine``: the ~1,960 novel
   paths of the full trie inserted shortest-first in batches of 64, then
   256 base rules re-inserted (half with another node's metrics, exact
   ties; half fresh).  At the final epoch, with the launch counters at 0,
   4096 search rows (half the delta's paths) and 256 ragged pairs, 256
   prefixes at k = 10 and 100 and 256 items per role (min_depth 1, and
   0 once) answer == the same ops on the from-scratch rebuild with those
   256 rules patched, served frozen on the card, bitwise; the rank,
   membership and fused search kernels ran on the frozen side; the plain
   versions (``use_kernel=False``) answer the same.  Times each streamed
   op beside the frozen one, then one staggered fold and a full refreeze,
   each followed by the same check; the refrozen trie == the rebuild
   array for array.
9. Serve loop: the 2^20 trie of step 2 through
   ``TrieScheduler(ResilientTrieEngine(FaultyEngine(TrieQueryEngine)))``
   at the reference bench's ``max_batch`` 32, with ``time.perf_counter``
   charging each launch (its host copy, so the device's work, included)
   to a virtual clock.  A drain of 4096 ``zipfian_workload`` requests
   with the launch counters at 0: every response ok, every row (cache
   hits included) == the same single query on the bare engine, bitwise,
   and the rank, fused-search and membership kernels launched.  The
   reference bench's load sweep at 0.5x, 0.9x and 2x the drain's
   capacity (deadlines 4x, 16x and 64x its launch ms, ``max_pending``
   32): latency percentiles, QPS and rates, one response per admitted
   request, statuses == the stats.  Faults on fresh schedulers: a
   transient (retried, bitwise), a poison item (only its rows invalid),
   a shard failure at the sixth launch (one failover, the in-flight batch
   bitwise on the primary, older cache entries orphaned), and the
   ladder's replicated rung over a one-shard sharded primary (on the
   card, bitwise).  Then step 8's
   retail base as a fresh ``StreamingTrie`` through the loop: 31 rounds
   of 64 inserts (its novel paths shortest-first with the full trie's
   metrics) and 128 queries (the base's zipfian traffic and the inserted
   paths): every answer == the engine at its round's epoch, bitwise, no
   cache hit across an epoch, 1,960 inserted, the last round == the full
   trie served frozen, bitwise, and the stream refrozen == the full trie
   array for array.
10. Sharded trie: the 2^20 trie of step 2 cut into P = 1, 2 and 4
   contiguous DFS subtree ranges (``shard_device_trie``) over the first P
   visible GPUs, or P shards on one card where fewer are visible (the ms
   are then the cost of the split on one card, not scaling): the 4096
   search rows and 256 pairs, the 256 prefixes at k = 10 and 100 for
   every metric and the 256 items for every role == the replicated
   engine bitwise (tie order, int32), with the rank, membership and
   fused search kernels launched once a live shard an op; per-shard
   resident bytes and each op's ms (CUDA events, median of --reps) beside
   the replicated op's.  The chain trie of step 6, compressed f32 and
   int32 + bf16, at P = 4 through the span kernel == the single-device
   compressed ops.  ``mask_dead_shards(plan, [1, 3])`` on the card == the
   same masked plan on the CPU (plain versions), and masking every shard
   raises.  The ladder over a P = 4 primary with a shard failure on
   shard 1: the replicated rung == the replicated engine, the masked rung
   ``degraded=True`` == the masked plan.  Step 8's retail stream over a
   P = 4 mesh beside the unsharded stream: two rounds of 64 inserts and
   128 queries, then a fold, every answer bitwise, ``owner_shard`` ==
   the plan's ranges, the fold's cuts the drift gate's.
11. Observability: one pass of step 4's main path with the launch
   profiler on: one record per op dispatch under the reference's op names
   and the answers of the pass without it, bitwise.
12. The LM serving path (``[lm]``): smollm-360m at full width and depth
   (32 units, d_model 960, 15 / 5 heads, vocab 49,152), random f32 weights
   from a generator seeded by --seed, through ``serve.engine`` and
   ``serve.spec_decode``; a 512-token prompt (the chunked prefill) and 64
   greedy tokens.  In f32 (TF32 off), speculative decoding == greedy token
   for token with a corpus ``NgramTrie(n=4)`` and a trie fit on the greedy
   continuation (drafts accepted, the cache rewound); 64-token prefill
   logits on the card == the CPU's within 1e-3; in bf16, the share of
   positions where the two agree.  Prefill ms, decode ms a token and
   tokens/s at batch 1 and 8, resident bytes.  No kernel of its own.
13. MLA and MoE (``[deepseek]``): DeepSeek-V2-Lite-16B at full width and
   depth (27 layers, d_model 2048, 16 heads, MLA kv_lora 512, 64 routed
   experts top-6 + 2 shared, vocab 102,400), f32 weights drawn on the card
   from a generator seeded by --seed, bf16 compute and cache, no mesh (the
   MoE's one-device dense path).  (a) In f32 (TF32 off), speculative ==
   greedy token for token with the three proposers of step 12, a
   512-token prompt (the chunked absorbed prefill) and 32 greedy tokens;
   (b) the full-width two-layer slice (the prefix layer and unit 0) on the
   card against a CPU copy: 64-token f32 prefill logits within 1e-3, and
   its aux loss; (c) on the slice, expanded (no cache) against absorbed
   (into a cache) logits within 1e-3; (d) unit 0's MoE on 512 tokens
   under a mesh {"model": ep}, ep in {1, 4}: at capacity_factor 8 the
   dispatch path == dense within the reference test's tolerance, at 0.1
   finite with drops and ep = 1 == ep = 4 within f32 rounding.  Prefill
   ms (dense and dispatch at ep = 1), decode ms a token and tokens/s at
   batch 1 and 8, resident bytes and the decode bound.  No kernel of its
   own.
13b. The placed LM paths (``[mesh]``; alone with ``--mesh-only``): a
   one-rank NCCL world in this process (an in-process ``HashStore``, no
   port), ``make_host_mesh()`` the 1 x 1 ``("data", "model")`` process
   mesh on the card.  (a) smollm-360m at full width and depth, its f32
   weights placed as DTensors by ``remesh_state`` (no copy: a block is
   the whole leaf): a 512-token prefill and 64 greedy tokens at batch 1
   and 8 into a placed cache (bf16), prefill logits bitwise against the
   plain path (or the first gap printed and within 1e-5) and tokens
   equal; an 8 x 256 ``loss_and_grads`` the same way (loss and each
   gradient leaf); decode ms a token and AdamW step ms placed beside
   plain, in turns.  (b) DeepSeek-V2-Lite-16B at full width and depth on
   step 13's weights, placed without a copy, its MoE through
   ``moe_alltoall``'s process-group path, against the one-process
   dispatch path at ep = 1 under deterministic algorithms (the
   dispatch's scatter-add sums by atomics otherwise): prefill logits and
   32 greedy tokens after a 512-token prompt; decode ms placed beside
   the dispatch path.  (c) mamba2-370m at full width and depth, f32
   weights placed without a copy: a 512-token prefill (the chunked SSD
   into the cache) and 64 greedy tokens (the recurrence) at batch 1 and
   8 into a placed bf16 cache, as (a); a 4 x 256 ``loss_and_grads``
   under remat (loss and each gradient leaf); decode ms placed beside
   plain, in turns.  (d) Jamba's reduced hybrid unit in f32, placed
   against plain: logits of a 16-token prefill and of a 5- and a 1-token
   decode, the aux loss and ``pos``.  (e) DeepSeek-V3 at full width
   (bf16 params, 256 routed experts, the MTP head), its depth cut to the
   3 dense layers and one MoE unit (15.8 B params): ``loss_fn`` on 1 x
   128 tokens under deterministic algorithms, placed against the
   dispatch path at ep = 1: ``lm_loss``, ``mtp_loss`` and the total
   bitwise, the gradients of the MTP head, ``embed`` and ``lm_head`` (the
   rest frozen) bitwise or within 1e-5 of each leaf's max; bytes and
   seconds.  Each part's seconds on the phase's last line.  Four gloo
   ranks on the one card are not run: DTensor's all-gather kills them
   (``probes/gloo_cuda_collectives.py``).  No kernel of its own.
14. Mamba2 (``[mamba]``): mamba2-370m at full width and depth (48
   Mamba2 layers, d_model 1024, 32 SSD heads of 64, d_state 128, chunk
   256, vocab 50,280, 368,338,432 params), f32 weights drawn on the card
   from --seed, through ``materialize_params``, ``init_cache`` and
   ``serve.engine.greedy_generate``.  (a) In f32 (TF32 off), 64-token
   prefill logits on the card within 1e-3 of a CPU copy's; (b) in f32,
   a 256-token chunked prefill into an empty f32 cache against the same
   tokens as 256 one-token decode steps (the recurrence): the last logits
   within 1e-3, the SSM state within 1e-4 of its max |state| in the first
   4 layers and 1e-3 in all 48 (f32 rounding grows with depth; the
   chunked prefill on a CPU copy is measured beside it);
   (c) in the config's bf16 compute and cache, greedy tokens at batch 1
   and 8, prefill ms of 512 tokens (the chunked SSD) and of 256 against
   255 (the recurrence, one step a token), decode ms a token and
   tokens/s at batch 1 and 8 (64 greedy steps), resident bytes, the
   decode bound and a profiler trace of three decode steps; (d) Jamba's
   reduced hybrid unit (attention, then 7 Mamba layers, the dense MoE on
   odd layers) in f32 on the card against a CPU copy: a 16-token prefill
   (the chunked path), a 5-token and a 1-token decode (the recurrence),
   logits within 1e-3, the aux loss within 1e-6 relative, ``pos`` equal.
   No kernel of its own.
15. Training (``[train]``): smollm-360m at full width and depth, f32
   weights drawn on the card from --seed.  (a) One ``loss_fn`` and its
   gradients in f32 (TF32 off) at 2 x 64 pipeline tokens (``segment_ids``,
   ``loss_mask``) against a CPU copy: loss and global grad norm within
   1e-4 relative, each leaf within 1e-3 of its max |grad|, the worst leaf
   printed; (b) remat on against off at 8 x 256 in f32: within 1e-6, the
   peak bytes of each; (e) 2 microbatches against 1 in f32 within the
   reference test's tolerance; (c) ``launch.train.main`` for 24 steps at
   8 x 256 (bf16 compute, AdamW, checkpoints every 8): finite losses, the
   last 4 below the first 4; step ms (CUDA events, median after 2
   warm-up steps), tokens/s, peak bytes, param and AdamW bytes and the
   step's bound, and a profiler trace of one more step; (d) the CPU
   copy's params checkpointed and restored onto the card bitwise, and 17
   steps, then resumed to 24: params and state within 1e-6 of each leaf's
   max of the uninterrupted run's (bitwise reported); (g) Adafactor
   forced for 4 steps, its state bytes beside AdamW's; (f)
   ``--compress-grads`` for 4 steps: finite losses and residual; then 4
   AdamW steps of mamba2-370m at
   full width at 4 x 256 (the chunked SSD's backward), and reduced
   DeepSeek-V3 (MLA, MoE aux, MTP) and Jamba: loss, metrics and every
   gradient card against CPU in f32 within 1e-3.  Then ``[train long]``:
   one remat step of 1 x 4096 tokens in bf16 compute (16 query chunks a
   layer, each checkpointed) through ``dryrun_held``: FLOPs, argument
   bytes and the step's added allocation held against
   ``launch.dryrun.run_cell``'s as in step 16 (a), a finite loss, and
   one layer's whole probabilities (15 heads x 4096^2 x 4 B) beside the
   peak.  No kernel of its own.
16. The dry run (``[dryrun]``; alone with ``--dryrun-only``): (a)
   ``launch.dryrun.run_cell`` of smollm-360m at full width and depth on a
   1 x 1 mesh, on meta tensors, for step 15's train cell (8 x 256
   tokens, AdamW, remat) and step 12's decode cell (batch 8, a cache of
   512 + 64),
   each held against the same step on the card: FLOPs equal as integers
   (``FlopCounterMode`` around the real step), the argument bytes equal
   to the bytes the allocator is asked for when params, optimizer state,
   batch and cache are placed and ``memory_allocated``'s growth within
   its slack (512 B a tensor, plus 1 MiB a tensor over 1 MiB), the step's
   added allocation within 5% (or 64 MiB) of the dry run's temp, the
   predicted and measured peaks and the roofline terms beside the step
   ms (CUDA events, median); (b) meanwhile, in one worker process each,
   DeepSeek-V3 train_4k on both production meshes, Jamba-1.5-Large
   long_500k, smollm-360m decode_32k and Yi-6B prefill_32k on meta
   tensors, their seconds, their records under ``--dryrun-out`` (default
   ``dryrun_out/smoke/``) and the roofline table over them.
17. Prints the GPU's name and power limit, one ``{"kernels": [...]}``
   line, and last ``{"ok": true, "device": {...}}``.

Exits non-zero with no result when CUDA is unavailable, when
``REPRO_TORCH_FORCE_INTERPRET`` asks for the plain versions (which run on
CPU tensors only), or when any phase fails.  The card's peaks (bounds) come from
``repro_torch.launch.roofline``.
"""
import argparse
import contextlib
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# the card's peaks (H100 SXM at 700 W: HBM bytes/s, float32 CUDA-core
# and dense bf16 tensor-core operations/s)
from repro_torch.launch.roofline import (  # noqa: E402
    FP32_FLOPS as FP32_OPS_PER_S, HBM_BW as HBM_BYTES_PER_S,
    PEAK_FLOPS as BF16_OPS_PER_S,
)
MINSUP = 0.002               # the retail operating point (arm/datasets.py)
COMPRESS_N_TX = 100_000      # int32 support denominator of the chain trie
# the compressed tries of step 6: FrozenTrie.device_arrays arguments
QUANT = {
    "compressed": dict(layout="auto"),
    "i32+bf16": dict(layout="compressed", quantize=True,
                     n_transactions=COMPRESS_N_TX),
    "i32+int8": dict(layout="compressed", quantize=True,
                     n_transactions=COMPRESS_N_TX, columns="int8"),
}
L2_FLUSH_BYTES = 128 << 20   # written between timed calls: over 2x the L2
# device ms of the rank kernel's earlier design (a chunked sweep of every
# range with pairwise merges) on the main path at k = 100 and 2^20 rules,
# on an NVIDIA H100 80GB HBM3 at 700 W: logged beside the kernel's own,
# never part of the kernels line
EARLIER_RANK_MS = 0.4876
SEED_EDGES = 1 << 20         # the seed phase's trie: the sweep is O(Q L E)
# the reference bench's search grid (benchmarks/paper_figs.py
# SEARCH_KERNEL_SIZES, width 6) as (E, Q, width); the seed phase adds its
# own 2^20 x 4096 x 8 point
SEARCH_GRID = ((1_000, 128, 6), (1_000, 2048, 6), (10_000, 128, 6),
               (10_000, 2048, 6), (100_000, 128, 6))
METRICS = ("support", "confidence", "lift", "leverage", "conviction")
ROLES = ("consequent", "antecedent", "any")


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps, warmup=3):
    """Median milliseconds of ``fn`` between two CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps, flush, kernel=None):
    """Mean device milliseconds per call of ``fn`` with a cold L2: the
    durations of the kernels (and copies) it ran on the card, summed from
    a torch.profiler trace of ``reps`` calls each after ``flush()``, less
    ``flush()``'s own per-call time from a trace of it alone.  With
    ``kernel`` (a name, or a tuple of names), only the device events whose
    name holds one of them count (those kernels alone, without the
    wrapper's other device work) and nothing is subtracted.  None, logged
    with the traces' event counts, when a trace holds no such event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def traced_us(call, name=None, n=reps):
        # a short trace now and then comes back without its device events:
        # take it again, up to three times
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    flush()
                    call()
                torch.cuda.synchronize()
            events = prof.events()
            on_card = [e for e in events if e.device_type == DeviceType.CUDA]
            us = sum(e.time_range.elapsed_us() for e in on_card
                     if name is None or any(k in e.name for k in name))
            if us > 0:
                return us
            log(f"[profiler] no device time in a trace of {len(events)} "
                f"events, {len(on_card)} on the card (kernel {name})")
        return 0

    fn()
    torch.cuda.synchronize()
    if kernel is not None:
        only = traced_us(fn, (kernel,) if isinstance(kernel, str) else kernel)
        return only / reps / 1e3 if only > 0 else None
    # the flush-only trace takes at least 20 calls: shorter ones have come
    # back without their device events
    n_alone = max(reps, 20)
    both, alone = traced_us(fn), traced_us(lambda: None, n=n_alone)
    if both <= 0 or alone <= 0:
        return None
    return (both / reps - alone / n_alone) / 1e3


def bitwise_equal(a, b):
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def max_abs_err(a, b):
    import torch

    if not a.dtype.is_floating_point or a.numel() == 0:
        return 0.0 if torch.equal(a, b) else float("inf")
    same = a == b
    diff = torch.where(same, 0.0, (a.double() - b.double()).abs())
    return float(diff.max())


def check_same(what, got, want, errs):
    """Bitwise comparison of two result tuples; records the worst error."""
    for g, w in zip(got, want):
        errs.append(max_abs_err(g, w))
        if not bitwise_equal(g, w):
            raise AssertionError(f"{what}: kernel differs from plain version"
                                 f" (max abs err {errs[-1]})")


def check_reduce(what, support, confidence, depth, errs,
                 n_transactions=0, confidence_scale=1.0):
    """The reduction kernel on one trie's columns: all five outputs
    bitwise equal to ``ref.trie_reduce_split_ref`` (the kernel's order at
    the launch's own geometry) and to a repeated call, count and max
    bitwise equal to ``ref.trie_reduce_ref`` and its sums within 1e-6
    relative (each sum's error goes to ``errs``).  Returns the kernel's
    five outputs."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.trie_reduce import (
        launch_shape, trie_reduce_stats, vector_head,
        vector_nodes,
    )

    cols = (support, confidence, depth)
    rq = dict(n_transactions=n_transactions,
              confidence_scale=confidence_scale)
    got = trie_reduce_stats(*cols, **rq)
    head = vector_head(*cols)[0]
    shape = launch_shape(support.shape[0], vector_nodes(confidence.dtype),
                         head, _build.sm_count(support.device))
    mirror = ref.trie_reduce_split_ref(*cols, **rq, blocks=shape["blocks"],
                                       threads=shape["threads"],
                                       unroll=shape["unroll"],
                                       head=head)
    check_same(f"trie_reduce {what} (its mirror, {shape['blocks']} blocks)",
               got, mirror, [])
    check_same(f"trie_reduce {what} (a repeated call)",
               trie_reduce_stats(*cols, **rq), got, [])
    want = ref.trie_reduce_ref(*cols, **rq)
    check_same(f"trie_reduce {what} count/max", (got[0], got[2]),
               (want[0], want[2]), errs)
    for g, w in ((got[1], want[1]), (got[3], want[3])):
        errs.append(abs(float(g) - float(w)))
        if errs[-1] > 1e-6 * abs(float(w)):
            raise AssertionError(f"trie_reduce {what}: a sum is off by "
                                 f"{errs[-1]} (of {float(w)})")
    return got


def prefixes_for(arrs, n_items, count, rng):
    """Whole-trie, absent and real 1-3 item prefixes, in turn."""
    out = []
    n = arrs["node_item"].shape[0]
    for i in range(count):
        if i % 8 == 0:
            out.append([])
        elif i % 8 == 7:
            out.append([n_items + 5])
        else:
            nid, path = int(rng.randint(1, n)), []
            while nid > 0:
                path.append(int(arrs["node_item"][nid]))
                nid = int(arrs["node_parent"][nid])
            out.append(path[::-1][: 1 + i % 3])
    return out


def items_for(n_items, rng):
    """256 items: 248 random, two duplicates, two absent, four fixed."""
    items = [int(x) for x in rng.randint(0, n_items, size=248)]
    return items + [items[0], items[1], -1, n_items + 3, 0, 1, 2, 3]


def member_kernel_rows(ia, items, dev):
    """The membership kernel's item rows as ``rules_with`` launches them:
    posting slices of the deduped items, padded to a power of two."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops

    slices = ops._posting_slices(ia["item_offsets"], items)
    first = np.unique(slices[2], return_index=True)[1]
    return [torch.as_tensor(a, device=dev)
            for a in ops._pad_pow2_rows(*[a[first] for a in slices])]


def query_traffic(arrs, seed):
    """The query path's traffic on one trie: 4096 search rows of width 8,
    256 ragged pairs cut from the first 512 rows, 256 prefixes and 256
    items."""
    import numpy as np
    from repro_torch.core import synthetic

    n_items = int(arrs["edge_item"].max()) + 1
    rng = np.random.RandomState(seed + 1)
    prefixes = prefixes_for(arrs, n_items, 256, rng)
    items = items_for(n_items, rng)
    queries, ant_len = synthetic.synthetic_search_queries(
        arrs, 4096, 8, seed=seed + 2)
    pairs = []
    for row in range(0, 512, 2):
        path = [int(x) for x in queries[row] if x >= 0]
        cut = int(rng.randint(0, len(path) + 1))
        pairs.append((path[:cut][::-1], path[cut:]))
    return queries, ant_len, pairs, prefixes, items


def chain_traffic(arrs, seed):
    """The compressed phase's traffic on the chain trie: 4096
    ``mixed_queries`` rows of width 8, 256 prefixes and 256 items."""
    import numpy as np
    from repro_torch.core import synthetic

    n_items = int(arrs["edge_item"].max()) + 1
    rng = np.random.RandomState(seed + 4)
    queries, ant_len = synthetic.mixed_queries(rng, arrs, 4096, 8)
    prefixes = prefixes_for(arrs, n_items, 256, rng)
    return queries, ant_len, prefixes, items_for(n_items, rng)


def walk_steps(dt, queries, ant_len):
    """Bucket lookups the two walks of a rule search perform on this data
    (the data-dependent part of its byte bound)."""
    import torch
    from repro_torch.core.array_trie import child_lookup

    q = queries.shape[0]
    node = torch.zeros((q,), dtype=torch.int32, device=queries.device)
    cnode = node.clone()
    ok = torch.ones((q,), dtype=torch.bool, device=queries.device)
    cok = ok.clone()
    main = cons = 0
    for s in range(queries.shape[1]):
        item = queries[:, s]
        active = (item >= 0) & ok
        c_active = (item >= 0) & (s >= ant_len) & cok
        main += int(active.sum())
        cons += int(c_active.sum())
        child = child_lookup(dt, node, item)
        ok = torch.where(active, child >= 0, ok)
        node = torch.where(active & (child >= 0), child, node)
        cchild = child_lookup(dt, cnode, item)
        cok = torch.where(c_active, cchild >= 0, cok)
        cnode = torch.where(c_active & (cchild >= 0), cchild, cnode)
    return main, cons


def member_launches_by_role(role_launches, role, call):
    """``call()``, adding the membership kernel's launches it made to
    ``role_launches[role]`` (when a dict is given)."""
    from repro_torch.kernels.item_index import rules_with_member

    before = rules_with_member.launches
    out = call()
    if role_launches is not None:
        role_launches[role] = role_launches.get(role, 0) + \
            rules_with_member.launches - before
    return out


def drive_engine(engine, queries, ant_len, pairs, prefixes, items,
                 role_launches=None):
    """One pass of every batched op through ``engine``; the membership
    kernel's launches per role go to ``role_launches``."""
    res = {
        "search": engine.rule_search_batch(queries, ant_len),
        "search_pairs": engine.rule_search_batch(pairs),
        "topk10": engine.top_k_rules_batch(prefixes, 10),
        "topk100": engine.top_k_rules_batch(prefixes, 100),
        "reduce": engine.trie_reduce(),
    }
    for role in ROLES:
        res[role] = member_launches_by_role(
            role_launches, role,
            lambda: engine.rules_with(items, role=role, k=10))
    return res


def check_answers(what, res, engine, queries, ant_len, pairs, prefixes,
                  items):
    """Every answer of ``drive_engine`` against the tensor oracles and the
    plain ops on the same device."""
    import torch
    from repro_torch.core.array_trie import batched_rule_search, traverse_reduce
    from repro_torch.kernels import ops

    dt, frozen, dev = engine.dt, engine.frozen, engine.device
    n = frozen.n_nodes
    dfs = ops.dfs_rank_arrays(dt)
    dfs["_device_trie"] = dt
    ia = ops.item_rank_arrays(dt)
    pq, pal = frozen.canonicalize_queries([p[0] for p in pairs],
                                          [p[1] for p in pairs])
    for key_res, (q, al) in (("search", (queries, ant_len)),
                             ("search_pairs", (pq, pal))):
        oracle = batched_rule_search(dt, torch.as_tensor(q, device=dev),
                                     torch.as_tensor(al, device=dev))
        for key in oracle:
            if not bitwise_equal(res[key_res][key], oracle[key]):
                raise AssertionError(f"{what}: rule_search_batch "
                                     f"{key_res} {key} != oracle")
    for k in (10, 100):
        want = ops.top_k_rules_batch(frozen, prefixes, k, arrays=dfs,
                                     use_kernel=False, device=dev)
        for key in want:
            if not bitwise_equal(res[f"topk{k}"][key], want[key]):
                raise AssertionError(f"{what}: top_k_rules_batch k={k} {key}")
        if res[f"topk{k}"]["values"].shape != (len(prefixes), k):
            raise AssertionError(f"{what}: top_k_rules_batch shape")
    for role in ROLES:
        want = ops.rules_with(frozen, items, role=role, k=10, arrays=ia,
                              use_kernel=False, device=dev)
        for key in want:
            if not bitwise_equal(res[role][key], want[key]):
                raise AssertionError(f"{what}: rules_with {role} {key}")
    want = traverse_reduce(dt)
    if float(res["reduce"]["n_rules"]) != float(want["n_rules"]) or \
            float(res["reduce"]["n_rules"]) != n - 1:
        raise AssertionError(f"{what}: trie_reduce n_rules")
    for key in ("support_sum", "confidence_max", "mean_conf"):
        got, w = float(res["reduce"][key]), float(want[key])
        if not math.isfinite(got) or abs(got - w) > 1e-6 * abs(w):
            raise AssertionError(f"{what}: trie_reduce {key}: {got} vs {w}")


# the kernels a query on the plain layout launches, and on the compressed
PLAIN_QUERY_KERNELS = ("topk_rank_batch", "rule_search_fused",
                       "rules_with_member", "trie_reduce_columns")
SPAN_QUERY_KERNELS = ("topk_rank_batch", "rule_search_span",
                      "rules_with_member", "trie_reduce_columns")
SEED_QUERY_KERNELS = ("topk_rank_batch", "rule_search_sweep",
                      "rules_with_member", "trie_reduce_columns")


def require_launched(what, launches, names):
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"{what}: kernel {name} never launched")


def time_ops(engine, queries, ant_len, prefixes, items, reps):
    """Median CUDA-event milliseconds of each engine op."""
    op_ms = {
        "rule_search_batch": cuda_ms(
            lambda: engine.rule_search_batch(queries, ant_len), reps),
        "top_k_rules_batch_k10": cuda_ms(
            lambda: engine.top_k_rules_batch(prefixes, 10), reps),
        "top_k_rules_batch_k100": cuda_ms(
            lambda: engine.top_k_rules_batch(prefixes, 100), reps),
        "trie_reduce": cuda_ms(engine.trie_reduce, reps),
    }
    for role in ROLES:
        op_ms[f"rules_with_{role}"] = cuda_ms(
            lambda: engine.rules_with(items, role=role, k=10), reps)
    return op_ms


# the device kernels each wrapper launches, by name in a profiler trace
KERNEL_NAMES = {
    "topk_rank_batch": ("score_kernel", "rank_seed_kernel",
                        "rank_topk_kernel"),
    "rules_with_member": ("score_kernel", "member_count_kernel",
                          "member_ranges_kernel", "member_plan_kernel",
                          "member_topk_kernel"),
    "rule_search_fused": ("rule_search_fused_kernel",),
    "rule_search_span": ("rule_search_span_kernel",),
    # the fingerprint pass, then per step the advance (and compaction)
    # and the match launch, and a last advance
    "rule_search_sweep": ("sweep_fingerprint_kernel", "sweep_advance_kernel",
                          "sweep_match_kernel"),
    "trie_reduce_columns": ("trie_reduce_kernel",),
    # the pre-pass clears its scratch with a memset ("Memset (Device)")
    "support_count_bitmap": ("Memset", "support_mark_kernel",
                             "support_tile_kernel"),
}


def score_bytes(metric, support, confidence):
    """Bytes per position a score of ``metric`` reads: the columns it
    needs (``metrics_inkernel.METRIC_COLUMNS``, which the score pass
    loads and no other) in their storage types, and the 4-byte depth of
    the min_depth mask."""
    from repro_torch.kernels.metrics_inkernel import METRIC_COLUMNS

    size = {"support": support.element_size(),
            "confidence": confidence.element_size(),
            "lift": confidence.element_size()}
    return 4 + sum(size[c] for c in METRIC_COLUMNS[metric])


def covered_positions(n, los, his):
    """Positions of ``[0, n)`` that one of the ranges ``[los, his)``
    covers: each is read once however many ranges hold it."""
    import torch

    los, his = los.long().clamp(0, n), his.long().clamp(0, n)
    ones = torch.ones_like(los, dtype=torch.int32)
    covered = torch.zeros((n + 1,), dtype=torch.int32, device=los.device)
    covered.index_add_(0, los, ones)
    covered.index_add_(0, his, -ones)
    return int((covered.cumsum(0)[:n] > 0).sum())


def member_work(ia, rows, role, k, score_b):
    """(bytes, operations) a membership top-k of ``role`` needs on this
    data, whatever computes it: the score's columns at every member
    position (``ref.member_ranges_ref``; each read once however many
    queries hold it), the posting bounds the role reads (post_lo and
    post_hi, 8 bytes a posting; post_lo alone for consequent), the item
    rows (12 bytes each) and the k results per item (8 bytes each); a
    score, a compare and a select per member of each query."""
    from repro_torch.kernels import ref

    plos, phis, items = rows
    _, lo, hi = ref.member_ranges_ref(ia["post_lo"], ia["post_hi"], plos,
                                      phis, items, ia["node_item"], role)
    n, q = ia["node_item"].shape[0], plos.shape[0]
    postings = int((phis.long() - plos.long()).clamp(min=0).sum())
    per_posting = 4 if role == "consequent" else 8
    return (score_b * covered_positions(n, lo, hi) + per_posting * postings
            + 12 * q + 8 * q * k, 3 * float((hi - lo).sum()))


def member_rows(ia, rows, k, role_launches, errs, reps, flush, label,
                twin=None):
    """One ``kernels`` row per role for the membership kernel over the
    item arrays ``ia`` and the deduped, padded query rows ``rows`` (role
    any keeps the plain ``label``, the others add theirs); ``twin`` maps
    each role to the device ms of the same call on an f32 twin trie."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.item_index import rules_with_member

    dq = ops._dequant_statics(ia)
    args = (ia["support"], ia["confidence"], ia["lift"], ia["depth"],
            ia["node_item"], ia["post_lo"], ia["post_hi"], *rows)
    where = ("cuda", "src/repro_torch/kernels/csrc/item_index.cu",
             "src/repro/kernels/item_index.py:162")
    out = []
    for role in ROLES:
        kw = dict(k=k, metric="confidence", min_depth=1, role=role, **dq)
        work = member_work(ia, rows, role, k,
                           score_bytes("confidence", ia["support"],
                                       ia["confidence"]))
        name = label if role == "any" else f"{label} [{role}]"
        if label.endswith("]"):
            name = f"{label[:-1]} {role}]"
        # the plain version launches a few kernels per query: fewer reps
        row = kernel_row(
            "rules_with_member",
            lambda: rules_with_member(*args, **kw),
            lambda: ref.rules_with_ref(*args, **kw),
            work, where, role_launches.get(role, 0), max(errs), reps, flush,
            label=name, plain_reps=max(2, reps // 4))
        row["role"] = role
        if twin is not None:
            row["f32_ms"] = twin[role]
            log(f"[kernel] {name}: its f32 twin on the same trie "
                f"{twin[role]} ms device")
        out.append(row)
    return out


def member_twin_ms(ia, rows, k, reps, flush):
    """Device ms of the membership kernel per role on ``ia``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.item_index import rules_with_member

    dq = ops._dequant_statics(ia)
    args = (ia["support"], ia["confidence"], ia["lift"], ia["depth"],
            ia["node_item"], ia["post_lo"], ia["post_hi"], *rows)
    return {role: device_ms(
        lambda: rules_with_member(*args, k=k, metric="confidence",
                                  min_depth=1, role=role, **dq),
        reps, flush, kernel=KERNEL_NAMES["rules_with_member"])
        for role in ROLES}


def kernel_row(name, kern, plain, work, where, launches, max_err, reps,
               flush, label=None, plain_reps=None):
    """One row of the ``kernels`` line: the kernel's device ms (its own
    kernels in a profiler trace, cold L2), and on the scope of the plain
    version's ``plain_ms`` (every device event of the call, the flush
    subtracted) ``whole_call_ms``, which adds the wrapper's own device
    work (casts, clamps, its range reduction); CUDA events per call
    around each (``call_ms``; the device ms fall back to these when a
    trace holds no device time), and the bound of ``work = (bytes,
    operations)`` at the card's peaks.  ``where`` is (route, source,
    file:line of the TPU kernel); ``plain_reps`` (default ``reps``) times
    a slow plain version fewer times."""
    plain_reps = plain_reps or reps
    call_ms = cuda_ms(kern, reps)
    plain_call_ms = cuda_ms(plain, plain_reps, warmup=1)
    ms = device_ms(kern, reps, flush, kernel=KERNEL_NAMES[name])
    whole_call_ms = device_ms(kern, reps, flush)
    plain_ms = device_ms(plain, plain_reps, flush)
    timer = "profiler"
    if ms is None or plain_ms is None:
        ms, plain_ms, timer = call_ms, plain_call_ms, "events"
    t_bytes = work[0] / HBM_BYTES_PER_S * 1e3
    t_ops = work[1] / FP32_OPS_PER_S * 1e3
    route, source, replaces = where
    row = {
        "name": label or name, "route": route, "source": source,
        "replaces": replaces, "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "timer": timer, "whole_call_ms": whole_call_ms,
        "call_ms": call_ms, "plain_call_ms": plain_call_ms,
    }
    log(f"[kernel] {row['name']}: {ms:.4f} ms device ({timer}), whole call "
        f"{whole_call_ms} ms device, "
        f"{call_ms:.4f} ms per call; plain {plain_ms:.4f} / "
        f"{plain_call_ms:.4f} ms; bound {row['bound_ms']:.5f} ms "
        f"({row['bound_by']})")
    return row


def support_work(mat, n_words):
    """(bytes, operations) a support-count launch needs on this data: the
    bitmap rows it touches read once, the candidate rows, lengths and
    counts; an AND and a popcount-add per word of each distinct valid
    item of each row."""
    import numpy as np

    c, k = mat.shape
    srt = np.sort(mat, axis=1)
    new = np.ones_like(srt, dtype=bool)
    new[:, 1:] = srt[:, 1:] != srt[:, :-1]
    distinct = int(((srt >= 0) & new).sum())
    rows = int(np.unique(mat[mat >= 0]).size)
    return rows * n_words * 4 + c * k * 4 + 8 * c, 2 * distinct * n_words


def support_levels(db, minsup, device):
    """``apriori(db, minsup)`` on the kernel path on ``device``, with each
    counting level's ``(candidates, lengths)`` recorded as apriori makes
    them; returns ``(itemsets, levels)``."""
    import numpy as np
    from repro_torch.arm.apriori import apriori

    levels = []
    host_batch = db.support_batch

    def recording(mat, lens=None, **kw):
        levels.append((np.asarray(mat, np.int32), np.asarray(lens, np.int32)))
        return host_batch(mat, lens, **kw)

    db.support_batch = recording
    try:
        itemsets = apriori(db, minsup, use_kernel=True, device=device)
    finally:
        del db.support_batch
    return itemsets, levels


def annotation_rows(db, itemsets):
    """The trie arrays of ``itemsets`` as ``build_trie_of_rules`` lays them
    out, and the annotation's support-count rows ``(cand, lengths)``."""
    import numpy as np
    from repro_torch.arm.rulegen import canonical_sequences
    from repro_torch.core.array_trie import item_tables
    from repro_torch.core.build_arrays import (
        canonicalize_matrix, pack_sequences, trie_arrays,
    )

    mat, _ = pack_sequences(canonical_sequences(itemsets.keys(), db))
    _, item_rank = item_tables(db.frequency_order())
    mat = canonicalize_matrix(mat, item_rank)
    arrs = trie_arrays(mat, (mat >= 0).sum(axis=1))
    return arrs, (arrs["cand"], arrs["node_depth"][1:].astype(np.int32))


def support_launches(db, minsup, device):
    """Every support-count launch of one build of ``db`` at ``minsup``:
    ``(tags, [(candidates, lengths)], itemsets)``, the counting levels then
    the annotation."""
    itemsets, levels = support_levels(db, minsup, device)
    levels.append(annotation_rows(db, itemsets)[1])
    tags = [f"level {i + 2}" for i in range(len(levels) - 1)] + ["annotate"]
    return tags, levels, itemsets


def sm_clock_hz():
    """The card's top SM clock (``nvidia-smi clocks.max.sm``), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    return float(out.split()[0]) * 1e6


def unstaged_case(dev, seed):
    """A launch past the staging limit (every one of 15,000 items named,
    so D > ``support_count.staging_limit(15,000)``): the unstaged variant, held
    against the plain version on the card and the host sweep, exactly."""
    import numpy as np
    import torch
    from repro_torch.arm.transactions import TransactionDB
    from repro_torch.kernels import ref
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.support_count import (
        launch_shape, staging_limit, support_count_bitmap,
    )

    rng = np.random.RandomState(seed + 5)
    n_items, n_tx, c = 15_000, 500, 20_000
    hot = rng.choice(n_items, size=40, replace=False)
    txs = [sorted(set(hot[rng.rand(40) < 0.5].tolist())
                  | set(rng.randint(0, n_items, size=60).tolist()))
           for _ in range(n_tx)]
    db = TransactionDB(txs, n_items)
    mat = np.full((c, 3), -1, np.int32)
    mat[:n_items, 0] = rng.permutation(n_items)
    mat[n_items:, 0] = rng.randint(0, n_items, size=c - n_items)
    mat[:, 1] = hot[rng.randint(0, 40, size=c)]
    extra = rng.rand(c) < 0.5
    mat[extra, 2] = hot[rng.randint(0, 40, size=int(extra.sum()))]
    lens = (mat >= 0).sum(axis=1).astype(np.int32)
    shape = launch_shape(n_items, db.n_words, n_items, c, sm_count(0))
    if n_items <= staging_limit(n_items) or shape["staged"]:
        raise AssertionError("construct unstaged: the case stages its rows")
    args_t = (db.device_bitmaps(dev), torch.as_tensor(mat, device=dev),
              torch.as_tensor(lens, device=dev), n_tx)
    got = support_count_bitmap(*args_t)
    if not torch.equal(got, ref.support_count_bitmap_ref(*args_t)):
        raise AssertionError("construct unstaged: kernel != plain version")
    if not np.array_equal(got.cpu().numpy(), db.support_batch(mat, lens)):
        raise AssertionError("construct unstaged: kernel != host sweep")
    log(f"[construct] unstaged variant: {c} rows over {n_items} distinct "
        f"items (staging limit {staging_limit(n_items)}), {db.n_words} "
        f"words, "
        f"launch {shape}: kernel == plain version == host sweep, exactly; "
        f"{cuda_ms(lambda: support_count_bitmap(*args_t), 5):.4f} ms per "
        f"call")


# ----------------------------------------------------------------------
# the tuning sweep: every launch knob, one at a time, on the card
# ----------------------------------------------------------------------
# the values each knob is swept over (powers of two around its default)
TUNING_VALUES = {
    "select_work_blocks": (256, 512, 1024, 2048, 4096),
    "rank_min_tiles": (1, 2, 4, 8, 16, 32),
    "member_min_tiles": (1, 2, 4, 8, 16, 32),
    "reduce_blocks_per_sm": (1, 2, 4, 8),
    "reduce_single_block_tiles": (1, 2, 4, 8),
    "sweep_blocks_per_sm": (1, 2, 4, 8),
    "support_max_bw": (4, 8, 16, 32),
    "launch_pad_floor": (1, 8, 32),
}
# the lanes of traffic each knob's sweep times (tuning_lanes)
MEMBER_LANES = tuple(f"member {role}" for role in ROLES)
TUNING_LANES = {
    "select_work_blocks": ("rank k=10", "rank k=100", *MEMBER_LANES),
    "rank_min_tiles": ("rank k=10", "rank k=100"),
    "member_min_tiles": MEMBER_LANES,
    "reduce_blocks_per_sm": ("reduce 2^20", "reduce 2^23 columns"),
    "reduce_single_block_tiles": tuple(f"reduce {t} tiles"
                                       for t in (2, 4, 8, 16)),
    "sweep_blocks_per_sm": ("sweep rows", "sweep consequent rows"),
    "support_max_bw": ("support retail levels",),
    "launch_pad_floor": ("serve drain",),
}
# a value replaces the default only when its lanes' summed ms are this
# share under the default's (the spread between repeated runs, PERF.md §5)
TUNING_MARGIN = 0.02
TUNING_DRAIN = 1024          # requests of the floor's serve-loop drain
REDUCE_NODES = 1 << 23       # synthetic columns: twice the L2, 2048 tiles


def tuple_of(out):
    """A wrapper's outputs as a tuple of tensors (a dict in key order)."""
    return tuple(out.values()) if isinstance(out, dict) else tuple(out)


def drain_lane(engine, frozen, seed):
    """The floor's lane: ``TUNING_DRAIN`` zipfian requests drained at once
    through a fresh ``TrieScheduler`` on a virtual clock with no timer
    (the same batches at every value); returns each request's (status,
    host rows)."""
    from repro_torch.serve import (
        FaultInjector, FaultyEngine, ResilientTrieEngine, TrieScheduler,
        VirtualClock, zipfian_workload,
    )

    wl = zipfian_workload(frozen, TUNING_DRAIN, seed=seed,
                          deadline_ms=(math.inf,))

    def call():
        clock = VirtualClock()
        sched = TrieScheduler(
            ResilientTrieEngine(FaultyEngine(engine, FaultInjector(),
                                             clock=clock)),
            clock=clock, max_batch=SERVE_MAX_BATCH, max_pending=len(wl))
        reqs = [sched.submit(w["op"], w["payload"], w["kwargs"],
                             tenant=w["tenant"]) for w in wl]
        sched.drain()
        return [(sched.responses[r.id].status, sched.responses[r.id].result)
                for r in reqs]
    return call


def tuning_lanes(args, dev, engine, frozen, traffic):
    """Every lane of the sweep, by name: ``call`` (one pass, returning
    its outputs), ``plain`` (the plain PyTorch version of the same call,
    from ``kernels.ref``, for the ``exact`` lanes), ``kernels`` (the
    device kernels timed by name), ``bytes`` (the work's bytes at the
    card's rate, or None), ``kind`` (``exact``: every output bitwise;
    ``reduce``: ``check_reduce``'s rules on ``cols``; ``drain``: statuses
    and rows bitwise).  Made under the default config (the member and
    sweep rows are padded by ``launch_pad``)."""
    import dataclasses

    import torch
    from repro_torch.arm.datasets import online_retail_db
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.item_index import rules_with_member
    from repro_torch.kernels.rank import topk_rank_batch
    from repro_torch.kernels.rule_search import rule_search_sweep
    from repro_torch.kernels.support_count import support_count_bitmap
    from repro_torch.kernels.trie_reduce import trie_reduce_stats

    queries, ant_len, pairs, prefixes, items = traffic
    dt, n = engine.dt, frozen.n_nodes
    lanes = {}
    dfs = ops.dfs_rank_arrays(dt)
    los, his, _ = ops.prefix_ranges(frozen, prefixes, dt=dt)
    r_args = (dfs["support"], dfs["confidence"], dfs["lift"], dfs["depth"],
              los, his)
    covered = covered_positions(n, los, his)
    for k in (10, 100):
        kw = dict(k=k, metric="confidence", min_depth=1)
        lanes[f"rank k={k}"] = dict(
            call=functools.partial(topk_rank_batch, *r_args, **kw),
            plain=functools.partial(ref.topk_rank_batch_ref, *r_args, **kw),
            kernels=KERNEL_NAMES["topk_rank_batch"], kind="exact",
            bytes=score_bytes("confidence", *r_args[:2]) * covered
            + 8 * los.numel() * (1 + k))
    ia = ops.item_rank_arrays(dt)
    m_rows = member_kernel_rows(ia, items, dev)
    m_args = (ia["support"], ia["confidence"], ia["lift"], ia["depth"],
              ia["node_item"], ia["post_lo"], ia["post_hi"], *m_rows)
    for role in ROLES:
        kw = dict(k=10, metric="confidence", min_depth=1, role=role)
        lanes[f"member {role}"] = dict(
            call=functools.partial(rules_with_member, *m_args, **kw),
            plain=functools.partial(ref.rules_with_ref, *m_args, **kw),
            kernels=KERNEL_NAMES["rules_with_member"], kind="exact",
            bytes=member_work(ia, m_rows, role, 10, score_bytes(
                "confidence", ia["support"], ia["confidence"]))[0])

    def reduce_lane(cols):
        return dict(call=functools.partial(trie_reduce_stats, *cols),
                    kernels=KERNEL_NAMES["trie_reduce_columns"],
                    kind="reduce", cols=cols,
                    bytes=12 * cols[0].shape[0] + 20)
    red = (dt.support, dt.confidence, dt.node_depth)
    lanes["reduce 2^20"] = reduce_lane(red)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    lanes["reduce 2^23 columns"] = reduce_lane((
        torch.rand((REDUCE_NODES,), generator=g, device=dev),
        torch.rand((REDUCE_NODES,), generator=g, device=dev),
        torch.randint(0, 8, (REDUCE_NODES,), generator=g, device=dev,
                      dtype=torch.int32)))
    # 4,096 f32 nodes a tile: the first t tiles of the 2^20 trie
    for t in (2, 4, 8, 16):
        lanes[f"reduce {t} tiles"] = reduce_lane(
            tuple(c[:4096 * t] for c in red))

    seed_dt = dataclasses.replace(dt, child_offsets=None, max_fanout=0)
    sw = ops.edge_metric_arrays(seed_dt)
    sw_cols = [sw[k] for k in ("edge_parent", "edge_item", "edge_child",
                               "edge_conf", "edge_sup", "edge_lift")]
    rows, rows_al = seed_rows(queries, ant_len, frozen, pairs)
    e = int(sw_cols[0].shape[0])
    for tag, (q_t, al_t) in sweep_launch_rows(rows, rows_al, dev).items():
        lanes[f"sweep {tag}"] = dict(
            call=functools.partial(rule_search_sweep, *sw_cols, q_t, al_t),
            plain=functools.partial(ref.rule_search_sweep_ref, *sw_cols,
                                    q_t, al_t),
            kernels=KERNEL_NAMES["rule_search_sweep"], kind="exact",
            bytes=sweep_work(dt, e, q_t, al_t)[0])

    db = online_retail_db()
    _, levels, _ = support_launches(db, MINSUP, dev)
    bm = db.device_bitmaps(dev)
    up = [(torch.as_tensor(m, device=dev), torch.as_tensor(ln, device=dev))
          for m, ln in levels]
    lanes["support retail levels"] = dict(
        call=lambda: tuple(support_count_bitmap(bm, m, ln, db.n_transactions)
                           for m, ln in up),
        plain=lambda: tuple(ref.support_count_bitmap_ref(
            bm, m, ln, db.n_transactions) for m, ln in up),
        kernels=KERNEL_NAMES["support_count_bitmap"], kind="exact",
        bytes=sum(support_work(m, db.n_words)[0] for m, _ in levels))

    lanes["serve drain"] = dict(
        call=drain_lane(engine, frozen, args.seed), kind="drain",
        kernels=sum((KERNEL_NAMES[k] for k in PLAIN_QUERY_KERNELS), ()),
        bytes=None)
    return lanes


def tuning_check(what, lane, got, plain, default):
    """One value's outputs of ``lane`` against the plain version's and
    the default value's: bitwise, but for the reduction's sums (bitwise
    against ``ref.trie_reduce_split_ref`` at the launch's block count,
    within 1e-6 relative of the default's).  The drain has no plain
    version of its own and is held to the default's drain: every kernel
    it launches is held to its plain version by the other lanes."""
    if lane["kind"] == "exact":
        check_same(f"{what} (plain version)", tuple_of(got), plain, [])
        check_same(f"{what} (the default)", tuple_of(got), default, [])
    elif lane["kind"] == "reduce":
        check_reduce(what, *lane["cols"], [])
        got = tuple_of(got)
        check_same(f"{what} count/max (the default)", (got[0], got[2]),
                   (default[0], default[2]), [])
        for i in (1, 3, 4):
            g, w = float(got[i]), float(default[i])
            if abs(g - w) > 1e-6 * abs(w):
                raise AssertionError(f"{what}: a sum {g} is off the "
                                     f"default's {w}")
    else:
        for want in (default,):
            if len(got) != len(want):
                raise AssertionError(f"{what}: {len(got)} responses")
            for i, ((gs, gr), (ws, wr)) in enumerate(zip(got, want)):
                if gs != ws or gs != "ok":
                    raise AssertionError(f"{what}: request {i} {gs} / {ws}")
                host_fields_equal(f"{what} request {i}", gr, wr)


def lane_ms(lane, args, l2_flush):
    """``(ms, timer)`` of one pass of ``lane``: its kernels' device ms by
    name (L2 flushed, mean of --reps; of 2 for the drain), or CUDA events
    around a pass where a trace holds no device time."""
    reps = 2 if lane["kind"] == "drain" else args.reps
    ms = device_ms(lane["call"], reps, l2_flush.zero_,
                   kernel=lane["kernels"])
    if ms is None:
        return cuda_ms(lane["call"], reps), "events"
    return ms, "profiler"


def tuning_sweep(args, dev, smi, engine, frozen, traffic, l2_flush):
    """Sweep each knob over ``TUNING_VALUES`` with every other knob at its
    default: each value's lanes checked against the plain version and the
    default, and timed (device ms of their kernels by name, L2 flushed,
    mean of --reps; CUDA events where a trace holds no device time).
    Returns ``(the config the sweep would choose, sweep record)``; a
    value is chosen where its summed ms beat the default's by
    ``TUNING_MARGIN``, in the sweep and again in turns."""
    import dataclasses

    import torch
    from repro_torch.kernels.tuning import (
        DEFAULTS, get_kernel_config, tuning_overrides,
    )
    from repro_torch.launch.roofline import kernel_roofline

    t0 = time.perf_counter()
    if get_kernel_config() != DEFAULTS:
        raise AssertionError("[tuning] the sweep starts from the defaults")
    lanes = tuning_lanes(args, dev, engine, frozen, traffic)
    plain, default = {}, {}
    for name, lane in lanes.items():
        # the drain's outputs are responses; the reduction's plain
        # version is check_reduce's
        keep = (lambda out: out) if lane["kind"] == "drain" else tuple_of
        default[name] = keep(lane["call"]())
        if "plain" in lane:
            plain[name] = tuple_of(lane["plain"]())
    torch.cuda.synchronize()
    log(f"[tuning] {smi}: {len(lanes)} lanes, each run once at the "
        f"defaults and, but for the drain and the reductions, once as "
        f"its plain version on the card "
        f"({time.perf_counter() - t0:.1f} s)")
    record, chosen = {}, {}
    for knob, values in TUNING_VALUES.items():
        base = getattr(DEFAULTS, knob)
        record[knob] = {}
        for v in values:
            with tuning_overrides(**{knob: v}):
                parts = []
                total = 0.0
                for name in TUNING_LANES[knob]:
                    lane = lanes[name]
                    tuning_check(f"[tuning] {knob}={v} {name}", lane,
                                 lane["call"](), plain.get(name),
                                 default[name])
                    ms, timer = lane_ms(lane, args, l2_flush)
                    total += ms
                    share = "" if lane["bytes"] is None else \
                        " (bw {:.1%})".format(kernel_roofline(
                            lane["bytes"], ms / 1e3, dev)
                            ["bandwidth_util"])
                    parts.append(f"{name} {ms:.5f} ms{share}"
                                 + ("" if timer == "profiler"
                                    else " [events]"))
                    record[knob].setdefault(str(v), {})[name] = ms
            record[knob][str(v)]["total"] = total
            log(f"[tuning] {knob}={v}{' (default)' if v == base else ''}"
                f": {'; '.join(parts)}; total {total:.5f} ms; == plain "
                f"version and default")
        totals = {v: record[knob][str(v)]["total"] for v in values}
        best = min(values, key=totals.get)
        chosen[knob] = base
        if best != base and \
                totals[best] < (1 - TUNING_MARGIN) * totals[base]:
            # the sweep's winner against the default again, in turns
            # (default, winner, winner, default)
            turns = {base: [], best: []}
            for v in (base, best, best, base):
                with tuning_overrides(**{knob: v}):
                    turns[v].append(sum(
                        lane_ms(lanes[name], args, l2_flush)[0]
                        for name in TUNING_LANES[knob]))
            ratio = sum(turns[best]) / sum(turns[base])
            record[knob]["confirm"] = {str(v): t for v, t in
                                       turns.items()}
            if ratio < 1 - TUNING_MARGIN:
                chosen[knob] = best
            log(f"[tuning] {knob}: {best} against the default {base} "
                f"in turns: {turns[base][0]:.5f} / {turns[best][0]:.5f}"
                f" / {turns[best][1]:.5f} / {turns[base][1]:.5f} ms "
                f"({ratio - 1:+.1%})")
        log(f"[tuning] {knob}: chose {chosen[knob]}"
            f"{' (the default)' if chosen[knob] == base else ''}; the "
            f"sweep's best {best} at "
            f"{totals[best] / totals[base] - 1:+.1%} of the default's "
            f"ms (a value must beat it by {TUNING_MARGIN:.0%}, in the "
            f"sweep and in turns); {smi}")
    cfg = dataclasses.replace(DEFAULTS, **chosen)
    log(f"[tuning] sweep done in {time.perf_counter() - t0:.1f} s: "
        f"{dataclasses.asdict(cfg)}")
    return cfg, record


def tuning_live(what):
    """The launch knobs every later phase runs under: ``get_kernel_config()``
    on the card, which must be the defaults (no override is active and
    the port has no table).  Returns the config."""
    import dataclasses

    from repro_torch.kernels.tuning import DEFAULTS, get_kernel_config

    live = get_kernel_config()
    if live != DEFAULTS:
        raise AssertionError(f"{what}: get_kernel_config() {live} is not "
                             f"the defaults")
    log(f"{what} resolved config {dataclasses.asdict(live)} (the defaults)")
    return live


def tuning_phase(args, dev, smi, engine, frozen, traffic, l2_flush):
    """The ``[tuning]`` phase.  With ``--tuning-only``: the sweep, its
    record written to ``--tuning-out``/``sweep.json``.  Otherwise the
    config every later phase runs under, printed."""
    import dataclasses

    import torch

    if not args.tuning_only:
        return tuning_live("[tuning]")
    cfg, record = tuning_sweep(args, dev, smi, engine, frozen, traffic,
                               l2_flush)
    os.makedirs(args.tuning_out, exist_ok=True)
    path = os.path.join(args.tuning_out, "sweep.json")
    with open(path, "w") as fh:
        json.dump({"device": smi, "torch": torch.__version__,
                   "cuda": torch.version.cuda, "reps": args.reps,
                   "margin": TUNING_MARGIN, "chosen": dataclasses.asdict(cfg),
                   "lanes": TUNING_LANES, "sweep_ms": record}, fh, indent=2)
        fh.write("\n")
    log(f"[tuning] the sweep's record -> {path}")
    return cfg


def construction_phase(args, dev, l2_flush):
    """Mine, build and annotate ``online_retail_db()`` at ``MINSUP`` on
    the card, check every step, serve the trie, and time the support-count
    launches; returns the kernel's row of the ``kernels`` line."""
    import numpy as np
    import torch
    from repro_torch.arm.apriori import apriori
    from repro_torch.arm.datasets import online_retail_db
    from repro_torch.arm.fpgrowth import fpgrowth
    from repro_torch.core.build_arrays import build_frozen_trie
    from repro_torch.core.builder import build_trie_of_rules
    from repro_torch.kernels import (
        KERNELS, launch_counts, ops, ref, reset_launch_counts,
    )
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.support_count import support_count_bitmap
    from repro_torch.serve import TrieQueryEngine

    minsup, reps = MINSUP, args.reps
    name = "support_count_bitmap"

    # -- 6a. the DB and the itemsets -----------------------------------
    t0 = time.perf_counter()
    db = online_retail_db()
    n_tx, n_words = db.n_transactions, db.n_words
    log(f"[construct] online_retail_db: {n_tx} transactions x {db.n_items} "
        f"items, bitmaps {db.item_bitmaps.shape} "
        f"({db.item_bitmaps.nbytes} bytes), made in "
        f"{time.perf_counter() - t0:.1f} s")
    # the kernel path's own counting levels, recorded as apriori makes them
    t0 = time.perf_counter()
    on_card, launches_in = support_levels(db, minsup, dev)
    t1 = time.perf_counter()
    by_fpgrowth = fpgrowth(db, minsup)
    t2 = time.perf_counter()
    on_host = apriori(db, minsup)
    t3 = time.perf_counter()
    if not (on_card == by_fpgrowth == on_host):
        raise AssertionError("construct: apriori on the card, fpgrowth and "
                             "host apriori found different itemsets")
    log(f"[construct] minsup {minsup}: {len(on_card)} frequent itemsets, "
        f"max size {max(len(s) for s in on_card)}; apriori on the card "
        f"{t1 - t0:.2f} s, fpgrowth {t2 - t1:.2f} s, host apriori "
        f"{t3 - t2:.2f} s; all three equal")

    # -- 6b. every launch: kernel == plain version == host sweep -------
    bm = db.device_bitmaps(dev)

    def upload(mat, lens):
        return (torch.as_tensor(mat, device=dev),
                torch.as_tensor(lens, device=dev))

    arrs, (cand, clens) = annotation_rows(db, on_card)
    launches_in.append((cand, clens))
    tags = [f"level {i + 2}" for i in range(len(launches_in) - 1)] + \
        ["annotate"]
    for tag, (mat_l, lens_l) in zip(tags, launches_in):
        args_t = (bm, *upload(mat_l, lens_l), n_tx)
        got = support_count_bitmap(*args_t)
        want = ref.support_count_bitmap_ref(*args_t)
        if not torch.equal(got, want):
            raise AssertionError(f"construct {tag}: kernel != plain version")
        if not np.array_equal(got.cpu().numpy(),
                              db.support_batch(mat_l, lens_l)):
            raise AssertionError(f"construct {tag}: kernel != host sweep")
    torch.cuda.synchronize()
    log(f"[construct] {len(launches_in)} launches (C = "
        f"{[m.shape[0] for m, _ in launches_in]}): kernel == plain version "
        f"on the card == host bitmap sweep, exactly")
    unstaged_case(dev, args.seed)

    # -- 6c. the main path: build_trie_of_rules on the default device --
    reset_launch_counts()
    t0 = time.perf_counter()
    built = build_trie_of_rules(db, minsup, miner="apriori", engine="arrays")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    log(f"[construct main path] {wall:.2f} s (mine {built.mine_seconds:.3f}"
        f", build {built.build_seconds:.3f}, annotate "
        f"{built.annotate_seconds:.3f}), launches {launches}")
    if launches[name] != len(launches_in):
        raise AssertionError(f"construct: {launches[name]} {name} launches, "
                             f"expected {len(launches_in)}")
    if any(launches[k] for k in KERNELS if k != name):
        raise AssertionError("construct: a query kernel ran while building")
    frozen = built.frozen
    if built.itemsets != on_host:
        raise AssertionError("construct: the build mined other itemsets")
    host, _, _ = build_frozen_trie(db, built.sequences, use_kernel=False)
    metrics = ("support", "confidence", "lift")
    for f in ("node_item", "node_parent", "node_depth", "edge_parent",
              "edge_item", "edge_child", "item_order", "item_rank",
              "child_offsets", "dfs_order", "subtree_size", "dfs_to_node",
              "item_offsets", "item_nodes", *metrics):
        g, w = getattr(frozen, f), getattr(host, f)
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"construct: {f} shape/dtype")
        if f in metrics:
            if not np.allclose(g, w, rtol=1e-6, atol=1e-7):
                raise AssertionError(f"construct: {f} off the host build")
        elif not np.array_equal(g, w):
            raise AssertionError(f"construct: {f} != host build")
    cpu_cols = ops.annotate_candidates(
        cand, clens, arrs["node_parent"][1:], arrs["node_item"][1:],
        db.item_counts(), n_tx, item_bitmaps=db.item_bitmaps, device="cpu")
    for f in metrics:
        if not np.array_equal(getattr(frozen, f)[1:].view(np.int32),
                              cpu_cols[f].numpy().view(np.int32)):
            raise AssertionError(f"construct: {f} on the card != on CPU "
                                 f"tensors")
    err = max(float(np.abs(getattr(frozen, f).astype(np.float64)
                           - getattr(host, f).astype(np.float64)).max())
              for f in metrics)
    log(f"[construct main path] {len(built.itemsets)} itemsets -> "
        f"{frozen.n_nodes} nodes, depth {frozen.max_depth}; structure == "
        f"host build, metrics within 1e-6 (max abs diff {err:.3g}), f32 "
        f"columns == annotate on CPU tensors, bitwise")

    # -- 6d. serve the mined trie --------------------------------------
    engine = TrieQueryEngine(frozen)
    n = frozen.n_nodes
    rng = np.random.RandomState(args.seed + 3)
    queries, ant_len = cand, clens - 1
    pairs = []
    for v in rng.randint(1, n, size=256):
        path = list(frozen.path_items(int(v)))
        cut = int(rng.randint(0, len(path)))
        pairs.append((path[:cut], path[cut:]))
    prefixes = prefixes_for({"node_item": frozen.node_item,
                             "node_parent": frozen.node_parent},
                            db.n_items, 256, rng)
    items = [int(x) for x in rng.randint(0, db.n_items, size=248)]
    items += [items[0], items[1], -1, db.n_items + 3, 0, 1, 2, 3]
    reset_launch_counts()
    t0 = time.perf_counter()
    res = drive_engine(engine, queries, ant_len, pairs, prefixes, items)
    torch.cuda.synchronize()
    served = launch_counts()
    log(f"[construct serve] {time.perf_counter() - t0:.2f} s, launches "
        f"{served}")
    require_launched("construct serve", served, PLAIN_QUERY_KERNELS)
    check_answers("construct serve", res, engine, queries, ant_len, pairs,
                  prefixes, items)
    found = res["search"]["found"].cpu().numpy()
    node = res["search"]["node"].cpu().numpy()
    if not found.all() or not np.array_equal(node, np.arange(1, n)):
        raise AssertionError("construct serve: a mined rule was not found")
    check_reduce("retail", engine.dt.support, engine.dt.confidence,
                 engine.dt.node_depth, [])
    log(f"[construct serve] all {int(found.sum())} rules found at their "
        f"nodes; every answer equals the oracles")
    op_ms = time_ops(engine, queries, ant_len, prefixes, items, reps)
    log("[construct ops ms] " + json.dumps(op_ms))

    # -- 6e. timing ----------------------------------------------------
    splits = []
    for _ in range(3):
        r = build_trie_of_rules(db, minsup, miner="apriori", engine="arrays")
        splits.append((r.mine_seconds, r.build_seconds, r.annotate_seconds))
    mine_s, build_s, annotate_s = (statistics.median(x) for x in zip(*splits))
    log(f"[construct build s] mine {mine_s:.4f} build {build_s:.4f} annotate "
        f"{annotate_s:.4f} (median of 3; each run "
        f"{[tuple(round(x, 4) for x in sp) for sp in splits]})")
    plain_reps = max(2, reps // 4)
    # the popcount floor: one 32-bit __popc per candidate word, at 16 a
    # clock per SM (compute capability 9.0) and the card's top SM clock
    popc_per_s = 16 * sm_count(0) * sm_clock_hz()
    per_launch = []
    for tag, (mat_l, lens_l) in zip(tags, launches_in):
        args_t = (bm, *upload(mat_l, lens_l), n_tx)
        kern = lambda: support_count_bitmap(*args_t)
        plain = lambda: ref.support_count_bitmap_ref(*args_t)
        call_ms = cuda_ms(kern, reps)
        plain_call_ms = cuda_ms(plain, plain_reps, warmup=1)
        # every kernel of the wrapper by name (the pre-pass, whose 8-byte
        # read of (largest id, D) is in call_ms, and the tile pass)
        ms = device_ms(kern, reps, l2_flush.zero_, kernel=KERNEL_NAMES[name])
        # on plain_ms's scope: every device event of the call
        whole_call_ms = device_ms(kern, reps, l2_flush.zero_)
        plain_ms = device_ms(plain, plain_reps, l2_flush.zero_)
        timer = "events" if ms is None else "profiler"
        plain_timer = "events" if plain_ms is None else "profiler"
        ms = call_ms if ms is None else ms
        plain_ms = plain_call_ms if plain_ms is None else plain_ms
        nbytes, nops = support_work(mat_l, n_words)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / FP32_OPS_PER_S * 1e3
        dense_ms = 2.0 * n_tx * mat_l.shape[0] * db.n_items \
            / BF16_OPS_PER_S * 1e3
        popc_ms = mat_l.shape[0] * n_words / popc_per_s * 1e3
        per_launch.append({
            "launch": tag, "C": int(mat_l.shape[0]), "K": int(mat_l.shape[1]),
            "ms": ms, "whole_call_ms": whole_call_ms, "call_ms": call_ms,
            "plain_ms": plain_ms,
            "plain_call_ms": plain_call_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": nops, "dense_bf16_ms": dense_ms,
            "popc_floor_ms": popc_ms, "timer": timer,
            "plain_timer": plain_timer,
        })
        log(f"[kernel] {name} {tag} C={mat_l.shape[0]} K={mat_l.shape[1]}: "
            f"{ms:.4f} ms device ({timer}), whole call {whole_call_ms} ms "
            f"device, {call_ms:.4f} ms per call; plain "
            f"{plain_ms:.4f} ({plain_timer}) / {plain_call_ms:.4f} ms; bound "
            f"{per_launch[-1]['bound_ms']:.5f} ms "
            f"({per_launch[-1]['bound_by']}), popcount floor "
            f"{popc_ms:.5f} ms; a dense bf16 product would take "
            f"{dense_ms:.4f} ms at peak")
    total = {key: sum(p[key] for p in per_launch)
             for key in ("ms", "call_ms", "plain_ms", "plain_call_ms",
                         "dense_bf16_ms", "popc_floor_ms")}
    total["whole_call_ms"] = None if any(
        p["whole_call_ms"] is None for p in per_launch) else sum(
        p["whole_call_ms"] for p in per_launch)
    t_bytes = sum(p["bytes"] for p in per_launch) / HBM_BYTES_PER_S * 1e3
    t_ops = sum(p["ops"] for p in per_launch) / FP32_OPS_PER_S * 1e3
    log(f"[construct] one build's {len(per_launch)} support counts: "
        f"{total['ms']:.4f} ms device ({total['call_ms']:.4f} ms per call), "
        f"bound {sum(p['bound_ms'] for p in per_launch):.5f} ms, popcount "
        f"floor {total['popc_floor_ms']:.5f} ms; the dense formulation's "
        f"bf16 bound {total['dense_bf16_ms']:.4f} ms")
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/support_count.cu",
        "replaces": "src/repro/kernels/support_count.py:52",
        "launches": launches[name], "max_abs_err": 0.0,
        "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": sum(p["bound_ms"] for p in per_launch),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "timer": "/".join(sorted({p["timer"] for p in per_launch})),
        "plain_timer": "/".join(sorted({p["plain_timer"] for p in per_launch})),
        "whole_call_ms": total["whole_call_ms"], "call_ms": total["call_ms"],
        "plain_call_ms": total["plain_call_ms"],
        "popc_floor_ms": total["popc_floor_ms"], "per_launch": per_launch,
    }, frozen, n_tx


def resident_bytes(*sources):
    """Bytes of the distinct device buffers a query configuration keeps:
    every tensor of a ``DeviceTrie`` and of its memoized column dicts,
    counted once per storage (a dict that holds the trie's own tensors
    adds nothing; a gathered copy adds its bytes)."""
    import torch

    seen = {}
    for src in sources:
        vals = src.values() if isinstance(src, dict) else vars(src).values()
        for v in vals:
            if isinstance(v, torch.Tensor) and v.is_cuda:
                st = v.untyped_storage()
                seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def layout_columns(dt):
    """The op-level column dicts a serving front door memoizes."""
    from repro_torch.kernels import ops

    dfs = ops.dfs_rank_arrays(dt)
    dfs["_device_trie"] = dt
    return {"edges": ops.edge_metric_arrays(dt), "dfs": dfs,
            "ia": ops.item_rank_arrays(dt)}


def drive_layout(dt, cols, queries, ant_len, prefixes, items,
                 role_launches=None):
    """One pass of every batched op over one device trie; the membership
    kernel's launches per role go to ``role_launches``."""
    from repro_torch.kernels import ops

    res = {
        "search": ops.rule_search_batch(dt, queries, ant_len,
                                        edges=cols["edges"]),
        "topk10": ops.top_k_rules_batch(dt, prefixes, 10, arrays=cols["dfs"]),
        "topk100": ops.top_k_rules_batch(dt, prefixes, 100,
                                         arrays=cols["dfs"]),
        "reduce": ops.trie_reduce(dt),
    }
    for role in ROLES:
        res[role] = member_launches_by_role(
            role_launches, role,
            lambda: ops.rules_with(dt, items, role=role, k=10,
                                   arrays=cols["ia"]))
    return res


def time_layout_ops(dt, cols, queries, ant_len, prefixes, items, reps):
    """Median CUDA-event milliseconds of each op over one device trie."""
    from repro_torch.kernels import ops

    op_ms = {
        "rule_search_batch": cuda_ms(
            lambda: ops.rule_search_batch(dt, queries, ant_len,
                                          edges=cols["edges"]), reps),
        "top_k_rules_batch_k10": cuda_ms(
            lambda: ops.top_k_rules_batch(dt, prefixes, 10,
                                          arrays=cols["dfs"]), reps),
        "top_k_rules_batch_k100": cuda_ms(
            lambda: ops.top_k_rules_batch(dt, prefixes, 100,
                                          arrays=cols["dfs"]), reps),
        "trie_reduce": cuda_ms(lambda: ops.trie_reduce(dt), reps),
    }
    for role in ROLES:
        op_ms[f"rules_with_{role}"] = cuda_ms(
            lambda: ops.rules_with(dt, items, role=role, k=10,
                                   arrays=cols["ia"]), reps)
    return op_ms


def span_args(dt):
    """The span search's arguments on a compressed trie, and its keywords
    (bucket width and dequantization scalars)."""
    from repro_torch.kernels import ops

    e = ops.edge_metric_arrays(dt)
    names = ("child_offsets", "edge_item", "edge_pos", "edge_span",
             "edge_tail", "node_item", "support", "confidence", "lift")
    return [e[k] for k in names], dict(max_fanout=e["max_fanout"],
                                       **ops._dequant_statics(e))


def span_walk_work(dt, queries, ant_len):
    """Bytes the two span walks of a search need on this data: per step a
    4-byte item-column gather inside a span, or at a CSR node the two
    bucket bounds and the found edge's four columns (24 bytes); a
    confidence gather per consequent step of the main walk; the support
    and lift of each found row and the support of each found consequent
    path."""
    import torch
    from repro_torch.core.array_trie import compressed_step

    q = queries.shape[0]
    z = torch.zeros((q,), dtype=torch.int32, device=queries.device)
    ones = torch.ones((q,), dtype=torch.bool, device=queries.device)
    es = {"sup": dt.support.element_size(),
          "col": dt.confidence.element_size()}
    total = 0
    for main in (True, False):
        pos, rem, ctail, ok = z, z, z, ones
        for s in range(queries.shape[1]):
            item = queries[:, s]
            active = (item >= 0) & ok
            if not main:
                active &= s >= ant_len
            p2, r2, t2, hit = compressed_step(dt, pos, rem, ctail, item)
            total += 4 * int((active & (rem > 0)).sum())
            total += 24 * int((active & (rem <= 0)).sum())
            adv = active & hit
            if main:
                total += es["col"] * int((adv & (s >= ant_len)).sum())
            ok = torch.where(active, hit, ok)
            pos = torch.where(adv, p2, pos)
            rem = torch.where(adv, r2, rem)
            ctail = torch.where(adv, t2, ctail)
        hits = int((ok & (pos > 0)).sum())
        total += hits * (es["sup"] + es["col"] if main else es["sup"])
    return total + queries.numel() * 4 + q * 4 + q * 24


F32_ULP = 2.0 ** -23
BF16_REL = 2.0 ** -8         # README: bf16 columns, relative


def column_bound(w, col):
    """The README's bound on one quantized column's error, at the plain f32
    values ``w`` (float64): int32 support counts 2 ulp relative plus the
    count's rounding, 1 / (2 n) absolute; bf16 2^-8 relative; int8
    scale / 2 absolute."""
    if col["kind"] == "count":
        return 2 * F32_ULP * w.abs() + 0.5 / col["n_transactions"]
    if col["kind"] == "bf16":
        return BF16_REL * w.abs()
    return col["scale"] / 2 + 0.0 * w


def product_bound(conf, m, col):
    """Bound on a compound confidence, the product of ``m`` quantized
    factors, each in [0, 1]: relative errors compound for bf16,
    absolute ones add for int8."""
    if col["kind"] == "bf16":
        return ((1 + BF16_REL) ** m - 1) * conf.abs()
    return m * col["scale"] / 2


def within(what, got, want, bound, mask, rtol):
    """Raise unless ``|got - want| <= bound`` (plus the f32 roundings of
    the widening and of the search's own products) on ``mask``; returns
    how many values lie outside ``rtol``, the tolerance of the reference's
    small-size test (2e-2 bf16, 6e-2 int8)."""
    import torch

    g, w = got.double()[mask], want.double()[mask]
    b = bound[mask] if isinstance(bound, torch.Tensor) and bound.dim() \
        else bound
    b = b + 32 * F32_ULP * w.abs()
    err = (g - w).abs()
    bad = err > b
    if bool(bad.any()):
        i = int(torch.nonzero(bad)[0])
        bi = float(b[i]) if isinstance(b, torch.Tensor) else float(b)
        raise AssertionError(f"{what}: {float(g[i])} vs plain {float(w[i])}"
                             f" beyond the README bound {bi}")
    return int((err > rtol * w.abs()).sum())


def compressed_phase(args, dev, l2_flush, retail, retail_n_tx, lat):
    """The path-compressed, quantized layout at 2^20 rules and on the
    retail trie: drive, check and time it; returns the span kernel's and
    the quantized variants' rows of the ``kernels`` line, the span row
    with its latency floor at the load latencies ``lat``, and the chain
    trie ``(arrays, FrozenTrie)``."""
    import numpy as np
    import torch
    from repro_torch.core import synthetic
    from repro_torch.kernels import launch_counts, ops, ref, \
        reset_launch_counts
    from repro_torch.kernels.item_index import rules_with_member
    from repro_torch.kernels.rank import topk_rank_batch
    from repro_torch.kernels.rule_search import (
        rule_search_fused, rule_search_span,
    )
    from repro_torch.kernels.trie_reduce import trie_reduce_columns

    reps = args.reps
    t0 = time.perf_counter()
    arrs = synthetic.synthetic_chain_trie(1 << 20, chain_fraction=0.75,
                                          seed=3)
    fz = synthetic.frozen_from_arrays(arrs)
    t_gen = time.perf_counter() - t0
    tries = {"plain": fz.device_arrays(device=dev)}
    t0 = time.perf_counter()
    for tag, kw in QUANT.items():
        tries[tag] = fz.device_arrays(device=dev, **kw)
    t_comp = (time.perf_counter() - t0) / len(QUANT)
    if tries["compressed"].layout != "compressed":
        raise AssertionError("compress: layout='auto' kept the chain trie "
                             "plain")
    comp = tries["compressed"]
    n = fz.n_nodes
    log(f"[compress] synthetic_chain_trie(2^20, 0.75, seed=3): {n} nodes, "
        f"span fraction {fz.span_fraction():.4f}, "
        f"{comp.edge_item.shape[0]} compressed edges, max fanout "
        f"{fz.max_fanout}, depth {fz.max_depth}; made in {t_gen:.1f} s, "
        f"compressed and uploaded in {t_comp:.2f} s each; layout='auto' "
        f"-> compressed")

    queries, ant_len, prefixes, items = chain_traffic(arrs, args.seed)
    q_t = torch.as_tensor(queries, device=dev)
    al_t = torch.as_tensor(ant_len, device=dev)

    # -- 7a. the main path on each trie, counters at 0 around each ------
    cols, res, launched, role_launched = {}, {}, {}, {}
    for tag, dt in tries.items():
        cols[tag] = layout_columns(dt)
        reset_launch_counts()
        role_launched[tag] = {}
        res[tag] = drive_layout(dt, cols[tag], queries, ant_len, prefixes,
                                items, role_launched[tag])
        torch.cuda.synchronize()
        launched[tag] = launch_counts()
        log(f"[compress main path] {tag}: launches {launched[tag]}")
        if tag == "plain":
            require_launched(f"compress {tag}", launched[tag],
                             PLAIN_QUERY_KERNELS)
        else:
            require_launched(f"compress {tag}", launched[tag],
                             SPAN_QUERY_KERNELS)
            if launched[tag]["rule_search_fused"]:
                raise AssertionError(f"compress {tag}: the plain search ran")

    # -- 7b. compressed f32 == plain, bitwise ---------------------------
    def same(what, got, want):
        if not bitwise_equal(got, want):
            raise AssertionError(f"compress: {what} differs")

    p, c = res["plain"], res["compressed"]
    for key in p["search"]:
        same(f"search {key}", c["search"][key], p["search"][key])
    for k in ("topk10", "topk100"):
        for key in p[k]:
            same(f"{k} {key}", c[k][key], p[k][key])
    for role in ROLES:
        keys = ("values", "node") if role == "consequent" else \
            ("values", "node", "pos")
        for key in keys:
            same(f"rules_with {role} {key}", c[role][key], p[role][key])
    for key in ("n_rules", "confidence_max"):
        same(f"trie_reduce {key}", c["reduce"][key], p["reduce"][key])
    for key in ("support_sum", "mean_conf"):
        g, w = float(c["reduce"][key]), float(p["reduce"][key])
        if abs(g - w) > 1e-6 * abs(w):
            raise AssertionError(f"compress: trie_reduce {key} {g} vs {w}")
    found = p["search"]["found"]
    log(f"[compress] compressed f32 == plain on every op, bitwise "
        f"({int(found.sum())} of {len(queries)} rows found)")

    # -- 7c. every kernel call == its plain version, on every trie ------
    m_rows = member_kernel_rows(cols["compressed"]["ia"], items, dev)
    errs = {}
    pe = cols["plain"]["edges"]
    fused = [pe[k] for k in ("child_offsets", "edge_item", "edge_child",
                             "edge_conf", "edge_sup", "edge_lift")]
    want = ref.rule_search_fused_ref(*fused, q_t, al_t,
                                     max_fanout=pe["max_fanout"])
    check_same("rule_search_fused plain chain trie",
               [rule_search_fused(*fused, q_t, al_t,
                                  max_fanout=pe["max_fanout"])[k]
                for k in want], list(want.values()), [])
    for tag in QUANT:
        dt, cl = tries[tag], cols[tag]
        dq = ops._dequant_statics(dt)
        sa, skw = span_args(dt)
        got = rule_search_span(*sa, q_t, al_t, **skw)
        want = ref.rule_search_span_ref(*sa, q_t, al_t, **skw)
        check_same(f"rule_search_span {tag}", [got[k] for k in want],
                   [want[k] for k in want], errs.setdefault(
                       ("rule_search_span", tag), []))
        for k in (10, 100):
            want = ops.top_k_rules_batch(dt, prefixes, k, arrays=cl["dfs"],
                                         use_kernel=False)
            check_same(f"topk_rank_batch {tag} k={k}",
                       [res[tag][f"topk{k}"][x] for x in want],
                       [want[x] for x in want],
                       errs.setdefault(("topk_rank_batch", tag), []))
        for role in ROLES:
            want = ops.rules_with(dt, items, role=role, k=10, arrays=cl["ia"],
                                  use_kernel=False)
            check_same(f"rules_with_member {tag} {role}",
                       [res[tag][role][x] for x in want],
                       [want[x] for x in want],
                       errs.setdefault(("rules_with_member", tag), []))
            # min_depth 0: the item -1's consequent row is the root
            ia = cl["ia"]
            m_args = (ia["support"], ia["confidence"], ia["lift"],
                      ia["depth"], ia["node_item"], ia["post_lo"],
                      ia["post_hi"], *m_rows)
            m_kw = dict(k=10, metric="confidence", min_depth=0, role=role,
                        **dq)
            got = rules_with_member(*m_args, **m_kw)
            check_same(f"rules_with_member {tag} {role} min_depth=0", got,
                       ref.rules_with_ref(*m_args, **m_kw),
                       errs[("rules_with_member", tag)])
            absent = got[1][m_rows[2] == -1]
            if role == "consequent" and not bool(
                    (absent[:, 0] == 0).all()):
                raise AssertionError(f"compress {tag}: the item -1's "
                                     f"consequent row lost the root")
        got = check_reduce(
            f"chain {tag}", dt.support, dt.confidence, dt.node_depth,
            errs.setdefault(("trie_reduce_columns", tag), []),
            n_transactions=dq["n_transactions"],
            confidence_scale=dq["confidence_scale"])
        # the op's answers are the kernel's, the mean as the op computed
        # it before the kernel wrote it
        red = res[tag]["reduce"]
        for key, i in (("n_rules", 0), ("support_sum", 1),
                       ("confidence_max", 2), ("mean_conf", 4)):
            if not bitwise_equal(red[key], got[i]):
                raise AssertionError(f"compress {tag}: trie_reduce op "
                                     f"{key} != kernel")
        if not bitwise_equal(red["mean_conf"], got[3] / got[0].clamp(min=1)):
            raise AssertionError(f"compress {tag}: mean_conf != "
                                 f"conf_sum / n.clamp(min=1)")
    torch.cuda.synchronize()
    log("[compress] every span, rank, membership and reduce call equals "
        "its plain version on the card, on the f32, i32+bf16 and i32+int8 "
        "tries (bitwise; reduce sums to 1e-6)")

    # -- 7d. the quantized answers within the README's bounds ----------
    p_search = p["search"]
    mask = p_search["found"]
    cons_steps = ((q_t >= 0) & (torch.arange(q_t.shape[1], device=dev)[None]
                                >= al_t[:, None])).sum(1)
    single = cons_steps == 1
    # the plain consequent-path support of each row, for compound lift
    cons_q = torch.where(torch.arange(q_t.shape[1], device=dev)[None]
                         >= al_t[:, None], q_t, -1)
    cons = ops.rule_search(tries["plain"], cons_q, torch.zeros_like(al_t))
    con_sup = torch.where(cons["found"], cons["support"], 0.0)
    outside = {}
    p_conf = p_search["confidence"].double()
    for tag in ("i32+bf16", "i32+int8"):
        dt = tries[tag]
        q_s = res[tag]["search"]
        for key in ("found", "node"):
            same(f"{tag} search {key}", q_s[key], p_search[key])
        kind = "bf16" if dt.confidence.dtype == torch.bfloat16 else "int8"
        rtol = 2e-2 if kind == "bf16" else 6e-2
        sup_col = {"kind": "count", "n_transactions": dt.n_transactions}
        conf_col = {"kind": kind, "scale": dt.confidence_scale}
        lift_col = {"kind": kind, "scale": dt.lift_scale}
        w_sup = p_search["support"].double()
        w_lift = p_search["lift"].double()
        conf_b = product_bound(p_conf, cons_steps.double(), conf_col)
        # compound lift = confidence / consequent support; that support
        # is a count (error d), so the quotient moves by at most
        # (conf_b + lift d) / (support - d)
        cs = con_sup.double()
        d = column_bound(cs, sup_col)
        compound_b = torch.where(
            cs > 0, (conf_b + w_lift.abs() * d) / (cs - d).clamp(min=1e-30),
            0.0)
        lift_b = torch.where(single, column_bound(w_lift, lift_col),
                             compound_b)
        out = {
            "support": within(f"{tag} search support", q_s["support"],
                              p_search["support"],
                              column_bound(w_sup, sup_col), mask, rtol),
            "confidence": within(f"{tag} search confidence",
                                 q_s["confidence"], p_search["confidence"],
                                 conf_b, mask, rtol),
            "lift": within(f"{tag} search lift", q_s["lift"],
                           p_search["lift"], lift_b, mask, rtol),
        }
        # rankings by confidence: when every value moves by at most the
        # column's bound, so does the k-th best of any set; the live slots
        # are the same
        for k in ("topk10", "topk100", *ROLES):
            g, w = res[tag][k]["values"], res["plain"][k]["values"]
            live = w > -torch.inf
            same(f"{tag} {k} live slots", g > -torch.inf, live)
            wd = torch.where(live, w, 0.0).double()
            out[k] = within(f"{tag} {k} values", g, w,
                            column_bound(wd, conf_col), live, rtol)
        outside[tag] = out
    log(f"[compress] quantized answers within the README bounds of plain "
        f"f32 (found and node exact); values outside the reference test's "
        f"rtol (2e-2 bf16, 6e-2 int8): {json.dumps(outside)}")

    # -- 7e. the retail trie: auto keeps it plain; served compressed ----
    if retail.device_arrays(device=dev, layout="auto").layout != "plain":
        raise AssertionError("compress: layout='auto' compressed the retail "
                             "trie")
    rt = retail.device_arrays(device=dev, layout="compressed", quantize=True,
                              n_transactions=retail_n_tx)
    rp = retail.device_arrays(device=dev)
    paths = np.full((retail.n_nodes - 1, max(retail.max_depth, 1)), -1,
                    np.int32)
    for v in range(1, retail.n_nodes):
        path = retail.path_items(v)
        paths[v - 1, :len(path)] = path
    r_al = np.maximum((paths >= 0).sum(1) - 1, 0).astype(np.int32)
    reset_launch_counts()
    r_res = ops.rule_search_batch(rt, paths, r_al)
    torch.cuda.synchronize()
    r_launch = launch_counts()
    require_launched("compress retail", r_launch, ("rule_search_span",))
    r_plain = ops.rule_search_batch(rp, paths, r_al)
    r_found = r_res["found"].cpu().numpy()
    if not r_found.all() or not np.array_equal(
            r_res["node"].cpu().numpy(), np.arange(1, retail.n_nodes)):
        raise AssertionError("compress retail: a rule was not found")
    r_mask = torch.ones_like(r_res["found"])
    r_out = {"support": within(
        "retail support", r_res["support"], r_plain["support"],
        column_bound(r_plain["support"].double(),
                     {"kind": "count", "n_transactions": retail_n_tx}),
        r_mask, 2e-2)}
    for key in ("confidence", "lift"):
        # every retail row has a one-item consequent: the node's own value
        r_out[key] = within(
            f"retail {key}", r_res[key], r_plain[key],
            column_bound(r_plain[key].double(), {"kind": "bf16"}),
            r_mask, 2e-2)
    log(f"[compress retail] span fraction {retail.span_fraction():.4f}: "
        f"layout='auto' -> plain; compressed + int32/bf16 at n_transactions "
        f"{retail_n_tx}: all {int(r_found.sum())} rules found at their "
        f"nodes, values within the README bounds (outside rtol 2e-2: "
        f"{r_out}); launches {r_launch}; resident {rp.nbytes()} bytes "
        f"plain, {rt.nbytes()} compressed + quantized")

    # -- 7f. resident bytes and op ms, compressed against plain ---------
    for tag, dt in tries.items():
        log(f"[compress resident] {tag}: DeviceTrie {dt.nbytes()} bytes; "
            f"with the three memoized column dicts "
            f"{resident_bytes(dt, *cols[tag].values())} bytes")
    op_ms = {tag: time_layout_ops(dt, cols[tag], queries, ant_len, prefixes,
                                  items, reps)
             for tag, dt in tries.items()}
    log("[compress ops ms] " + json.dumps(op_ms))

    # -- 7g. kernel times: the span search and the quantized variants ---
    los, his, _ = ops.prefix_ranges(comp, prefixes)
    union = covered_positions(n, los, his)
    span_len = float((his - los).clamp(min=0).sum())
    dq_rows = []
    f32_ms = {}
    for tag in QUANT:
        # the membership kernel per role: the f32 twin's device ms, then
        # a row per role on each quantized trie
        if tag == "compressed":
            member_f32 = member_twin_ms(cols[tag]["ia"], m_rows, 10, reps,
                                        l2_flush.zero_)
        else:
            dq_rows.extend(member_rows(
                cols[tag]["ia"], m_rows, 10, role_launched[tag],
                errs[("rules_with_member", tag)], reps, l2_flush.zero_,
                f"rules_with_member [{tag}]", twin=member_f32))
        dt, cl = tries[tag], cols[tag]
        dq = ops._dequant_statics(dt)
        es_s, es_c = dt.support.element_size(), dt.confidence.element_size()
        sa, skw = span_args(dt)
        r_args = (dt.support, dt.confidence, dt.lift, dt.node_depth, los, his)
        r_kw = dict(k=100, metric="confidence", min_depth=1, **dq)
        rq = dict(n_transactions=dq["n_transactions"],
                  confidence_scale=dq["confidence_scale"])
        calls = {
            "rule_search_span": (
                lambda: rule_search_span(*sa, q_t, al_t, **skw),
                lambda: ref.rule_search_span_ref(*sa, q_t, al_t, **skw),
                (span_walk_work(dt, q_t, al_t), q_t.shape[0] * 8),
                "cuda", "src/repro_torch/kernels/csrc/rule_search.cu",
                "src/repro/kernels/rule_search.py:565"),
            "topk_rank_batch": (
                lambda: topk_rank_batch(*r_args, **r_kw),
                lambda: ref.topk_rank_batch_ref(*r_args, **r_kw),
                (score_bytes(r_kw["metric"], dt.support, dt.confidence)
                 * union + 8 * los.numel() + 8 * los.numel() * r_kw["k"],
                 3 * span_len),
                "cuda", "src/repro_torch/kernels/csrc/rank.cu",
                "src/repro/kernels/rank.py:178"),
            "trie_reduce_columns": (
                lambda: trie_reduce_columns(dt.support, dt.confidence,
                                            dt.node_depth, **rq),
                lambda: ref.trie_reduce_ref(dt.support, dt.confidence,
                                            dt.node_depth, **rq),
                ((es_s + es_c + 4) * n + 20, 4 * n),
                "cuda", "src/repro_torch/kernels/csrc/trie_reduce.cu",
                "src/repro/kernels/trie_reduce.py:50"),
        }
        for name, (kern, plain, work, *where) in calls.items():
            if name != "rule_search_span" and tag == "compressed":
                # the f32 twin of a quantized row, timed in the same run
                f32_ms[name] = device_ms(kern, reps, l2_flush.zero_,
                                         kernel=KERNEL_NAMES[name])
                continue
            if name == "rule_search_span" and tag != "compressed":
                f32_ms[f"rule_search_span {tag}"] = device_ms(
                    kern, reps, l2_flush.zero_, kernel=KERNEL_NAMES[name])
                continue
            row = kernel_row(
                name, kern, plain, work, where, launched[tag][name],
                max(errs[(name, tag)]), reps, l2_flush.zero_,
                label=name if tag == "compressed" else f"{name} [{tag}]")
            if name != "rule_search_span":
                row["f32_ms"] = f32_ms[name]
                log(f"[kernel] {row['name']}: its f32 twin on the same trie "
                    f"{f32_ms[name]} ms device")
            else:
                # the plain layout's fused search on the same rows
                row["plain_layout_fused_ms"] = device_ms(
                    lambda: rule_search_fused(
                        *fused, q_t, al_t, max_fanout=pe["max_fanout"]),
                    reps, l2_flush.zero_,
                    kernel=KERNEL_NAMES["rule_search_fused"])
                log(f"[kernel] rule_search_fused on the plain chain trie, "
                    f"same rows: {row['plain_layout_fused_ms']} ms device")
            dq_rows.append(row)
    span_row = next(r for r in dq_rows if r["name"] == "rule_search_span")
    span_row["quantized_ms"] = {k.split(" ", 1)[1]: v
                                for k, v in f32_ms.items()
                                if k.startswith("rule_search_span")}
    sa, skw = span_args(comp)
    latency_floor(span_row, chain_rounds(
        ref.rule_search_span_group_ref, [*sa, q_t, al_t],
        **{k: v for k, v in skw.items() if k != "max_fanout"}), lat)
    log(f"[kernel] rule_search_span on the quantized tries (device ms): "
        f"{span_row['quantized_ms']}")
    return dq_rows, (arrs, fz)


def sweep_row_steps(dt, queries):
    """Active rows at each step of a full-sweep launch on this data: rows
    still on the trie, at a column that holds an item (a blank column
    neither ends a row nor advances it)."""
    import torch
    from repro_torch.core.array_trie import child_lookup

    q, width = queries.shape
    node = torch.zeros((q,), dtype=torch.int32, device=queries.device)
    ok = torch.ones((q,), dtype=torch.bool, device=queries.device)
    per_step, hits = [], 0
    for s in range(width):
        item = queries[:, s]
        active = (item >= 0) & ok
        child = child_lookup(dt, node, item)
        per_step.append(int(active.sum()))
        hits += int((active & (child >= 0)).sum())
        ok = torch.where(active, child >= 0, ok)
        node = torch.where(active & (child >= 0), child, node)
    return per_step, hits


def sweep_work(dt, e, queries, ant_len):
    """(bytes, operations) one full-sweep launch needs on this data: the
    (parent, item) table read once, the child and three metrics of each
    matched edge, the rows, ant_len and the five outputs; one pair compare
    per edge for each active row-step (``sweep_row_steps``: the max over
    matches needs the whole table), none for the others."""
    per_step, hits = sweep_row_steps(dt, queries)
    return (8 * e + 16 * hits + 4 * queries.numel() + 24 * queries.shape[0],
            sum(per_step) * e)


def seed_rows(queries, ant_len, frozen, pairs):
    """The seed phase's one search batch: the query path's search rows and
    the canonical rows of its ragged pairs, ``(rows, ant_len)``."""
    import numpy as np

    pq, pal = frozen.canonicalize_queries([p[0] for p in pairs],
                                          [p[1] for p in pairs])
    width = max(queries.shape[1], pq.shape[1])
    rows = np.full((queries.shape[0] + pq.shape[0], width), -1, np.int32)
    rows[:queries.shape[0], :queries.shape[1]] = queries
    rows[queries.shape[0]:, :pq.shape[1]] = pq
    return rows, np.concatenate([ant_len, pal]).astype(np.int32)


def sweep_launch_rows(rows, rows_al, dev):
    """The rows of the two sweep launches one seed search of ``rows``
    makes (``ops._seed_rule_search`` after the dedup): the unique rows
    with their ant_len, then their consequent columns (the antecedent
    blanked to -1) with ant_len 0; on ``dev``."""
    import torch
    from repro_torch.kernels import ops

    uq, ual, _ = ops.dedup_query_rows(rows, rows_al)
    uq_t = torch.as_tensor(uq, device=dev)
    ual_t = torch.as_tensor(ual, device=dev)
    pos = torch.arange(uq.shape[1], dtype=torch.int32, device=dev)
    cons_t = torch.where(pos[None, :] >= ual_t[:, None], uq_t, -1)
    return {"rows": (uq_t, ual_t), "consequent rows": (cons_t,
                                                       torch.zeros_like(ual_t))}


def compare_floor_ms(compares):
    """Milliseconds for ``compares`` at one 32-bit integer instruction
    each, 64 a clock per SM (compute capability 9.0), at the card's SM
    count and top SM clock."""
    from repro_torch.kernels._build import sm_count

    return compares / (64 * sm_count(0) * sm_clock_hz()) * 1e3


PROBE_SRC = os.path.join(HERE, "probes", "pointer_chase.cu")
CHASE_STEPS = 20_000         # dependent loads one latency reading chases
CHASE_LINE = 32              # int32 words of a 128-byte line


def start_probe_build():
    """Start nvcc on the latency probe (``probes/pointer_chase.cu``, built
    by this script alone) into ``build/probes/<hash>/``, beside the
    kernels' own build; ``load_probe`` waits for it."""
    import hashlib

    from repro_torch.kernels import _build

    with open(PROBE_SRC, "rb") as f:
        key = f.read() + " ".join(_build.NVCC_FLAGS).encode()
    out_dir = os.path.join(HERE, "build", "probes",
                           hashlib.sha256(key).hexdigest()[:16])
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libpointer_chase.so")
    if os.path.exists(so):
        return None, so
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", tmp, PROBE_SRC],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return (proc, tmp), so


def load_probe(build):
    import ctypes

    pending, so = build
    if pending is not None:
        proc, tmp = pending
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {PROBE_SRC}:\n{out}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    lib.pointer_chase_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.pointer_chase_launch.restype = ctypes.c_int
    return lib


def load_latency_ns(lib, dev, flush, seed):
    """Nanoseconds of one dependent device load: ``cold_ns`` over a
    random cycle of the 128-byte lines of a 64 MB array with the L2
    flushed first (each load reads device memory), ``warm_ns`` over a
    4 MB cycle walked once just before (each load reads the L2); CUDA
    events around a ``CHASE_STEPS``-load chase of one thread, over its
    length, median of 5."""
    import torch
    from repro_torch.kernels import _build

    gen = torch.Generator().manual_seed(seed)
    end = torch.empty((1,), dtype=torch.int32, device=dev)
    stream = _build.stream_handle(dev)
    out = {}
    for tag, n_bytes in (("cold", 64 << 20), ("warm", 4 << 20)):
        lines = n_bytes // (4 * CHASE_LINE)
        perm = torch.randperm(lines, generator=gen)
        nxt = torch.zeros((lines * CHASE_LINE,), dtype=torch.int32)
        nxt[perm * CHASE_LINE] = (perm.roll(-1) * CHASE_LINE).to(torch.int32)
        nxt = nxt.to(dev)
        start = int(perm[0]) * CHASE_LINE

        def chase(n):
            _build.check(lib.pointer_chase_launch(
                nxt.data_ptr(), start, n, end.data_ptr(), stream),
                "pointer_chase")

        times = []
        for _ in range(5):
            if tag == "cold":
                flush()
            else:
                chase(lines)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            chase(CHASE_STEPS)
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1) * 1e6 / CHASE_STEPS)
        if int(end) != int(perm[CHASE_STEPS % lines]) * CHASE_LINE:
            raise AssertionError(f"pointer chase ({tag}) ended off its "
                                 f"cycle")
        out[f"{tag}_ns"] = statistics.median(times)
    return out


def chain_rounds(group_ref, args, **kw):
    """The descent design's dependent chain on these rows: rounds of
    device loads per row, the longer of its two walks (the mirror
    ``group_ref`` of ``kernels/ref.py``, on the CPU), as (longest, mean)."""
    _, rounds = group_ref(*[a.cpu() for a in args], **kw)
    return int(rounds.max()), float(rounds.double().mean())


def latency_floor(row, chain, lat):
    """Put the latency floor on a descent kernel's row: ``floor_ms`` =
    the longest chain of dependent rounds x the cold load latency (the
    timing flushes the L2), ``floor_warm_ms`` the same at the warm one."""
    row["chain_max"], row["chain_mean"] = chain
    row["load_ns"] = lat
    row["floor_ms"] = chain[0] * lat["cold_ns"] * 1e-6
    row["floor_warm_ms"] = chain[0] * lat["warm_ns"] * 1e-6
    log(f"[kernel] {row['name']}: latency floor {row['floor_ms']:.5f} ms "
        f"({chain[0]} dependent rounds, mean {chain[1]:.2f}, x "
        f"{lat['cold_ns']:.1f} ns cold; {row['floor_warm_ms']:.5f} ms at "
        f"{lat['warm_ns']:.1f} ns warm); device {row['ms']:.4f} ms")


def reduce_rows(main_row, dt, dev, l2_flush, reps, seed):
    """Row 4's yardsticks beside the main path's reduction row: its launch
    floor (the kernel over the trie's first 4,096 nodes: its fixed cost)
    and, on a row of its own, the 2^23 hub trie (twice the L2: the
    streaming rate), driven through ``ops.trie_reduce`` with the counters
    at 0 and held to its mirror and plain version.  Each row also gets
    ``clean_l2_ms``: device ms with the L2 flushed by reading (full of
    clean lines) instead of writing, where no write-back of the flush's
    dirty lines shares device memory with the kernel's reads."""
    import torch
    from repro_torch.core import synthetic
    from repro_torch.kernels import launch_counts, ops, ref
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.trie_reduce import trie_reduce_columns

    name = "trie_reduce_columns"
    sink = torch.empty((1,), dtype=torch.float32, device=dev)

    def clean_flush():
        torch.sum(l2_flush, 0, keepdim=True, out=sink)

    def clean_ms(cols):
        return device_ms(lambda: trie_reduce_columns(*cols), reps,
                         clean_flush, kernel=KERNEL_NAMES[name])

    cols = (dt.support, dt.confidence, dt.node_depth)
    main_row["clean_l2_ms"] = clean_ms(cols)
    head = tuple(c[:4096] for c in cols)
    check_reduce("hub, first 4,096 nodes", *head, [])
    main_row["launch_floor_ms"] = device_ms(
        lambda: trie_reduce_columns(*head), reps, l2_flush.zero_,
        kernel=KERNEL_NAMES[name])
    log(f"[kernel] {name}: launch floor (4,096 nodes) "
        f"{main_row['launch_floor_ms']} ms device; {main_row['ms']} ms at "
        f"{cols[0].shape[0]} nodes, {main_row['clean_l2_ms']} ms with a "
        f"clean L2")
    if dt.support.shape[0] < (1 << 23):
        dt = synthetic.frozen_from_arrays(synthetic.synthetic_csr_trie(
            1 << 23, seed=seed)).device_arrays(device=dev)
        cols = (dt.support, dt.confidence, dt.node_depth)
    errs = []
    got = check_reduce("hub 2^23", *cols, errs)
    reset_launch_counts()
    op = ops.trie_reduce(dt)
    torch.cuda.synchronize()
    launches = launch_counts()[name]
    if launches != 1:
        raise AssertionError(f"trie_reduce on 2^23: {launches} launches")
    for key, i in (("n_rules", 0), ("support_sum", 1),
                   ("confidence_max", 2), ("mean_conf", 4)):
        if not bitwise_equal(op[key], got[i]):
            raise AssertionError(f"trie_reduce on 2^23: op {key} != kernel")
    n = cols[0].shape[0]
    row = kernel_row(
        name, lambda: trie_reduce_columns(*cols),
        lambda: ref.trie_reduce_ref(*cols), (12 * n + 20, 4 * n),
        ("cuda", "src/repro_torch/kernels/csrc/trie_reduce.cu",
         "src/repro/kernels/trie_reduce.py:50"), launches, max(errs), reps,
        l2_flush.zero_, label=f"{name} [2^23 hub]")
    row["clean_l2_ms"] = clean_ms(cols)
    row["op_ms"] = cuda_ms(lambda: ops.trie_reduce(dt), reps)
    log(f"[kernel] {row['name']}: {row['clean_l2_ms']} ms device with a "
        f"clean L2; ops.trie_reduce {row['op_ms']:.4f} ms (events)")
    return row


def descent_cases(dev, retail, retail_n_tx, seed):
    """Both descent kernels against their plain versions past the main
    path's tries, bitwise: the retail trie's root paths (fused on its plain
    layout, span on its compressed f32 and int32 + bf16 layouts), and a
    2^20 hub trie with a 5,000-wide root (past the staged cap and two
    probe rounds), with the query traffic's rows and the edge-case rows
    of ``synthetic.edge_case_queries``."""
    import numpy as np
    import torch
    from repro_torch.core import synthetic
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.rule_search import (
        rule_search_fused, rule_search_span,
    )

    def both(what, plain, compressed, rows):
        e = ops.edge_metric_arrays(plain)
        fused = [e[k] for k in ("child_offsets", "edge_item", "edge_child",
                                "edge_conf", "edge_sup", "edge_lift")]
        for q, al in rows:
            qa = (torch.as_tensor(q, device=dev),
                  torch.as_tensor(al, device=dev))
            kw = dict(max_fanout=e["max_fanout"])
            want = ref.rule_search_fused_ref(*fused, *qa, **kw)
            check_same(f"rule_search_fused {what}",
                       [rule_search_fused(*fused, *qa, **kw)[k]
                        for k in want], list(want.values()), [])
            for tag, dt in compressed.items():
                sa, skw = span_args(dt)
                want = ref.rule_search_span_ref(*sa, *qa, **skw)
                check_same(f"rule_search_span {what} {tag}",
                           [rule_search_span(*sa, *qa, **skw)[k]
                            for k in want], list(want.values()), [])
        log(f"[search] {what}: fused and span ({', '.join(compressed)}) "
            f"== plain versions bitwise over {sum(len(r[0]) for r in rows)} "
            f"rows")

    paths = np.full((retail.n_nodes - 1, max(retail.max_depth, 1)), -1,
                    np.int32)
    for v in range(1, retail.n_nodes):
        path = retail.path_items(v)
        paths[v - 1, :len(path)] = path
    r_al = np.maximum((paths >= 0).sum(1) - 1, 0).astype(np.int32)
    both("retail", retail.device_arrays(device=dev), {
        "compressed": retail.device_arrays(device=dev, layout="compressed"),
        "i32+bf16": retail.device_arrays(
            device=dev, layout="compressed", quantize=True,
            n_transactions=retail_n_tx)}, [(paths, r_al)])
    arrs = synthetic.synthetic_csr_trie(1 << 20, root_fanout=5000,
                                        seed=seed)
    fz = synthetic.frozen_from_arrays(arrs)
    queries, ant_len = query_traffic(arrs, seed)[:2]
    edge = synthetic.edge_case_queries(np.random.RandomState(seed), arrs,
                                       4096, 8)
    both("hub 2^20, root fanout 5000", fz.device_arrays(device=dev),
         {"compressed": fz.device_arrays(device=dev, layout="compressed")},
         [(queries, ant_len), edge])


def search_grid(args, dev, l2_flush, point):
    """The reference bench's search grid on the card, and the seed phase's
    own point ``(E, Q, width, arrs, queries, ant_len)``: per size the sweep
    kernel (one launch), the seed two-launch op, the fused kernel, and the
    seed (lex binary search) and CSR oracles, CUDA events per call (median
    of --reps) and the two kernels' device ms; the four full-metric lanes
    must agree bitwise."""
    import dataclasses

    import torch
    from repro_torch.core import synthetic
    from repro_torch.core.array_trie import batched_rule_search
    from repro_torch.kernels import ops
    from repro_torch.kernels.rule_search import (
        rule_search_fused, rule_search_sweep,
    )

    sizes = [(e, q, w, None, None, None) for e, q, w in SEARCH_GRID]
    sizes.append(point)
    out = []
    for e, q, width, arrs, queries, ant_len in sizes:
        if arrs is None:
            arrs = synthetic.synthetic_csr_trie(e)
            queries, ant_len = synthetic.synthetic_search_queries(
                arrs, q, width)
        csr = synthetic.frozen_from_arrays(arrs).device_arrays(device=dev)
        seed = dataclasses.replace(csr, child_offsets=None, max_fanout=0)
        ed = ops.edge_metric_arrays(csr)
        seed_edges = ops.edge_metric_arrays(seed)
        q_t = torch.as_tensor(queries, device=dev)
        al_t = torch.as_tensor(ant_len, device=dev)
        metric_cols = (ed["edge_item"], ed["edge_child"], ed["edge_conf"],
                       ed["edge_sup"], ed["edge_lift"])
        lanes = {
            "sweep_kernel": lambda: rule_search_sweep(
                ed["edge_parent"], *metric_cols, q_t, al_t),
            "seed_full_2launch": lambda: ops.rule_search(
                seed, q_t, al_t, edges=seed_edges),
            "csr_fused_kernel": lambda: rule_search_fused(
                ed["child_offsets"], *metric_cols, q_t, al_t,
                max_fanout=ed["max_fanout"]),
            "oracle_binsearch": lambda: batched_rule_search(seed, q_t, al_t),
            "oracle_csr": lambda: batched_rule_search(csr, q_t, al_t),
        }
        answers = {k: lanes[k]() for k in lanes if k != "sweep_kernel"}
        keys = ("found", "node", "support", "confidence", "lift")
        for k in ("csr_fused_kernel", "oracle_binsearch", "oracle_csr"):
            for key in keys:
                if not bitwise_equal(answers[k][key],
                                     answers["seed_full_2launch"][key]):
                    raise AssertionError(f"grid E={e} Q={q}: {k} {key} != "
                                         f"the seed op")
        ms = {k: cuda_ms(fn, args.reps) for k, fn in lanes.items()}
        dev_ms = {
            "sweep_kernel": device_ms(lanes["sweep_kernel"], args.reps,
                                      l2_flush.zero_,
                                      kernel=KERNEL_NAMES["rule_search_sweep"]),
            "csr_fused_kernel": device_ms(
                lanes["csr_fused_kernel"], args.reps, l2_flush.zero_,
                kernel=KERNEL_NAMES["rule_search_fused"]),
        }
        speedup = ms["sweep_kernel"] / ms["csr_fused_kernel"]
        dev_speedup = None if None in dev_ms.values() else \
            dev_ms["sweep_kernel"] / dev_ms["csr_fused_kernel"]
        out.append({"n_edges": e, "batch": q, "width": width,
                    "ms_per_call": ms, "device_ms": dev_ms,
                    "speedup_fused_vs_sweep": speedup,
                    "device_speedup_fused_vs_sweep": dev_speedup})
        log(f"[seed grid] E={e} Q={q} L={width}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in ms.items())
            + f" ms per call; device sweep {dev_ms['sweep_kernel']} / fused "
            f"{dev_ms['csr_fused_kernel']} ms; fused vs sweep {speedup:.1f}x"
            f" per call, {dev_speedup} on the device")
    return out


def seed_phase(args, dev, l2_flush, main_trie):
    """The seed layout (no CSR offsets) on the 2^20 query-path trie: drive
    every op with the counters at 0, hold the answers to the CSR layout's
    and the sweep kernel to its plain version, and time the ops, the
    kernel and the reference bench's grid; returns the sweep's row of the
    ``kernels`` line."""
    import dataclasses

    import torch
    from repro_torch.core import synthetic
    from repro_torch.kernels import launch_counts, ops, ref, \
        reset_launch_counts
    from repro_torch.kernels.rule_search import rule_search_sweep

    reps = args.reps
    if args.edges == SEED_EDGES:
        arrs, frozen = main_trie
    else:
        arrs = synthetic.synthetic_csr_trie(SEED_EDGES, seed=args.seed)
        frozen = synthetic.frozen_from_arrays(arrs)
        log(f"[seed] --edges {args.edges}: the seed phase stays at 2^20 "
            f"edges (the full sweep is O(Q L E)) on a trie of its own")
    queries, ant_len, pairs, prefixes, items = query_traffic(arrs,
                                                            args.seed)
    rows, rows_al = seed_rows(queries, ant_len, frozen, pairs)
    width = rows.shape[1]
    csr = frozen.device_arrays(device=dev)
    seed = dataclasses.replace(csr, child_offsets=None, max_fanout=0)
    e = int(seed.edge_parent.shape[0])
    log(f"[seed] {frozen.n_nodes} nodes, {e} edges, served without CSR "
        f"offsets; {rows.shape[0]} search rows of width {width}")

    # -- 8a. the main path, counters at 0 -------------------------------
    cols = {"seed": layout_columns(seed), "csr": layout_columns(csr)}
    reset_launch_counts()
    t0 = time.perf_counter()
    res = drive_layout(seed, cols["seed"], rows, rows_al, prefixes, items)
    torch.cuda.synchronize()
    launched = launch_counts()
    log(f"[seed main path] {time.perf_counter() - t0:.2f} s, launches "
        f"{launched}")
    require_launched("seed main path", launched, SEED_QUERY_KERNELS)
    if launched["rule_search_sweep"] != 2 or launched["rule_search_fused"]:
        raise AssertionError("seed main path: the search made "
                             f"{launched['rule_search_sweep']} sweep and "
                             f"{launched['rule_search_fused']} fused "
                             f"launches, expected 2 and 0")
    reset_launch_counts()
    ops.rule_search(seed, queries, ant_len, edges=cols["seed"]["edges"])
    one = launch_counts()
    if one["rule_search_sweep"] != 2 or any(
            v for k, v in one.items() if k != "rule_search_sweep"):
        raise AssertionError(f"seed: one rule_search launched {one}")

    # -- 8b. the answers == the CSR layout's, bitwise -------------------
    want = drive_layout(csr, cols["csr"], rows, rows_al, prefixes, items)
    for op in want:
        if op == "reduce":
            continue
        for key in want[op]:
            if not bitwise_equal(res[op][key], want[op][key]):
                raise AssertionError(f"seed: {op} {key} != the CSR layout's")
    for key in ("n_rules", "confidence_max"):
        if not bitwise_equal(res["reduce"][key], want["reduce"][key]):
            raise AssertionError(f"seed: trie_reduce {key}")
    for key in ("support_sum", "mean_conf"):
        g, w = float(res["reduce"][key]), float(want["reduce"][key])
        if abs(g - w) > 1e-6 * abs(w):
            raise AssertionError(f"seed: trie_reduce {key} {g} vs {w}")
    check_reduce("seed", seed.support, seed.confidence, seed.node_depth, [])
    found = res["search"]["found"]
    log(f"[seed] every answer == the CSR layout's, bitwise "
        f"({int(found.sum())} of {rows.shape[0]} rows found)")

    # -- 8c. both launches == the plain version, bitwise ----------------
    launch_rows = sweep_launch_rows(rows, rows_al, dev)
    uq_t, ual_t = launch_rows["rows"]
    cons_t, zeros = launch_rows["consequent rows"]
    sw = cols["seed"]["edges"]
    sw_cols = [sw[k] for k in ("edge_parent", "edge_item", "edge_child",
                               "edge_conf", "edge_sup", "edge_lift")]
    errs = []
    for tag, (q_t, al_t) in launch_rows.items():
        got = rule_search_sweep(*sw_cols, q_t, al_t)
        want_k = ref.rule_search_sweep_ref(*sw_cols, q_t, al_t)
        check_same(f"rule_search_sweep {tag}", [got[k] for k in want_k],
                   [want_k[k] for k in want_k], errs)
    torch.cuda.synchronize()
    log(f"[seed] both sweep launches ({uq_t.shape[0]} x {uq_t.shape[1]} "
        f"rows) == the plain version on the card, bitwise")
    # the row-steps each launch must compare with the table, and the ones
    # it sweeps: each step's active rows in whole tiles of SWEEP_ROWS
    steps = {}
    for tag, (q_t, _) in launch_rows.items():
        per_step, _ = sweep_row_steps(csr, q_t)
        swept = sum(-(-n // ref.SWEEP_ROWS) * ref.SWEEP_ROWS
                    for n in per_step)
        steps[tag] = per_step
        log(f"[seed] {tag}: {sum(per_step)} active row-steps (per step "
            f"{per_step}), {swept} swept in tiles of {ref.SWEEP_ROWS}, of "
            f"{q_t.numel()} row-steps in the launch")

    # -- 8d. op ms, seed against CSR in the same run --------------------
    op_ms = {tag: time_layout_ops(dt, cols[tag], rows, rows_al, prefixes,
                                  items, reps)
             for tag, dt in (("seed", seed), ("csr", csr))}
    log("[seed ops ms] " + json.dumps(op_ms))

    # -- 8e. the kernel row: the full-row launch; the consequent launch
    # beside it -------------------------------------------------------
    plain_reps = 2
    row = kernel_row(
        "rule_search_sweep",
        lambda: rule_search_sweep(*sw_cols, uq_t, ual_t),
        lambda: ref.rule_search_sweep_ref(*sw_cols, uq_t, ual_t),
        sweep_work(csr, e, uq_t, ual_t),
        ("cuda", "src/repro_torch/kernels/csrc/rule_search.cu",
         "src/repro/kernels/rule_search.py:153"),
        launched["rule_search_sweep"], max(errs), reps, l2_flush.zero_,
        plain_reps=plain_reps)
    c_bytes, c_ops = sweep_work(csr, e, cons_t, zeros)
    cons_call = lambda: rule_search_sweep(*sw_cols, cons_t, zeros)  # noqa
    row["cons_ms"] = device_ms(cons_call, reps, l2_flush.zero_,
                               kernel=KERNEL_NAMES["rule_search_sweep"])
    row["cons_whole_call_ms"] = device_ms(cons_call, reps, l2_flush.zero_)
    row["cons_call_ms"] = cuda_ms(cons_call, reps)
    row["cons_bound_ms"] = max(c_bytes / HBM_BYTES_PER_S,
                               c_ops / FP32_OPS_PER_S) * 1e3
    row["compare_floor_ms"] = compare_floor_ms(sum(steps["rows"]) * e)
    row["cons_compare_floor_ms"] = compare_floor_ms(
        sum(steps["consequent rows"]) * e)
    row["active_row_steps"] = sum(steps["rows"])
    row["cons_active_row_steps"] = sum(steps["consequent rows"])
    full_ops = uq_t.shape[0] * uq_t.shape[1] * e
    row["qle_bound_ms"] = full_ops / FP32_OPS_PER_S * 1e3
    row["plain_reps"] = plain_reps
    row["library_note"] = (
        "none: no single PyTorch call does a multi-step descent, and "
        "torch.searchsorted on a fused (parent, item) key gives one lookup "
        "step, not the sweep's max over matches")
    log(f"[kernel] rule_search_sweep: compare floor "
        f"{row['compare_floor_ms']:.4f} ms (one 32-bit integer instruction "
        f"per compare, 64 a clock per SM); consequent launch: "
        f"{row['cons_ms']} ms device, whole call "
        f"{row['cons_whole_call_ms']} ms, {row['cons_call_ms']:.4f} ms per "
        f"call; bound {row['cons_bound_ms']:.5f} ms, compare floor "
        f"{row['cons_compare_floor_ms']:.4f} ms; the full Q x L x E grid "
        f"({full_ops} compares) would bound a launch at "
        f"{row['qle_bound_ms']:.4f} ms")

    # -- 8f. the reference bench's grid ---------------------------------
    row["grid"] = search_grid(args, dev, l2_flush,
                              (e, queries.shape[0], queries.shape[1], arrs,
                               queries, ant_len))
    return row


# ----------------------------------------------------------------------
# streaming: a StreamingTrie over a retail base, served on the card
# ----------------------------------------------------------------------
STREAM_SEQS = 100_000        # the reference build bench's largest lane
STREAM_HOLDOUT = 1_000       # sequences held out of the base
STREAM_CHUNK = 64            # novel paths per insert batch
STREAM_UPDATES = 256         # base rules re-inserted with new metrics
STREAM_WIDTH = 10            # search row width (sample_rule_sequences' max)


def root_paths(frozen, dev):
    """Every node's root path as a tuple (index = node id), from one
    parent-pointer walk (``reconstruct_paths``) on the card."""
    import torch
    from repro_torch.core import reconstruct_paths

    dt = frozen.device_arrays(device=dev)
    mat = reconstruct_paths(
        dt, torch.arange(frozen.n_nodes, dtype=torch.int32, device=dev),
        max(frozen.max_depth, 1)).cpu().numpy()
    return [tuple(int(x) for x in row[row >= 0]) for row in mat]


def stream_split(rng, path):
    """``path`` as an (antecedent, consequent) pair at a random antecedent
    length (0 for a one-item path)."""
    a = rng.randint(1, len(path)) if len(path) > 1 else 0
    return list(path[:a]), list(path[a:])


def stream_traffic(base, delta_paths, base_paths, novel, n_items, seed):
    """The streaming phase's queries: 4096 search rows of width 10 (half
    the delta's paths, a quarter base paths, a quarter junk) and 256
    ragged pairs; 256 prefixes (a quarter parents of novel paths, 1/8
    whole-trie, 1/8 absent, the rest base paths); 256 items (half the last
    items of novel paths)."""
    import numpy as np

    rng = np.random.RandomState(seed + 23)

    def pick(paths, n):
        return [paths[i] for i in rng.randint(0, len(paths), size=n)]

    def junk():
        return tuple(int(x) for x in
                     rng.randint(0, n_items, size=rng.randint(1, 11)))

    rows = pick(delta_paths, 2048) + pick(base_paths, 1024) + \
        [junk() for _ in range(1024)]
    split = [stream_split(rng, p) for p in rows]
    queries, ant_len = base.canonicalize_queries(
        [s[0] for s in split], [s[1] for s in split], max_len=STREAM_WIDTH)
    # ragged pairs in raw (reversed) item order: canonicalized by the op
    pairs = [tuple(s[::-1] for s in stream_split(rng, p))
             for p in pick(delta_paths, 128) + pick(base_paths, 64)] + \
        [stream_split(rng, junk()) for _ in range(64)]
    parents = [list(p[:-1]) for p in pick(novel, 64)]
    prefixes = parents + [[]] * 32 + \
        [[n_items + 7 + i] for i in range(32)] + \
        [list(p) for p in pick(base_paths, 128)]
    items = [p[-1] for p in pick(novel, 128)] + \
        [int(x) for x in rng.randint(0, n_items, size=128)]
    return {"queries": queries, "ant_len": ant_len, "pairs": pairs,
            "prefixes": prefixes, "items": items}


def stream_calls(t):
    """The streaming traffic's calls, ``key -> (op, args, kwargs)``:
    min_depth 1, and 0 once for each ranking."""
    calls = {
        "search": ("rule_search_batch", (t["queries"], t["ant_len"]), {}),
        "search_pairs": ("rule_search_batch", (t["pairs"],), {}),
        "topk10": ("top_k_rules_batch", (t["prefixes"], 10), {}),
        "topk100": ("top_k_rules_batch", (t["prefixes"], 100), {}),
        "topk10_depth0": ("top_k_rules_batch", (t["prefixes"], 10),
                          {"min_depth": 0}),
        "any_depth0": ("rules_with", (t["items"],),
                       {"role": "any", "k": 10, "min_depth": 0}),
    }
    for role in ROLES:
        calls[role] = ("rules_with", (t["items"],), {"role": role, "k": 10})
    return calls


def stream_pass(run, t):
    """One pass of the streaming traffic; ``run(op, *args, **kw)`` makes
    each call (on an engine, or on the stream with the plain versions)."""
    return {key: run(op, *a, **kw)
            for key, (op, a, kw) in stream_calls(t).items()}


def check_pass(what, got, want):
    """Bitwise equality of two ``stream_pass`` results: every value, node
    id and position, tie order and dtype."""
    for key in want:
        if set(got[key]) != set(want[key]):
            raise AssertionError(f"{what}: {key} keys differ")
        for field, w in want[key].items():
            if not bitwise_equal(got[key][field], w):
                raise AssertionError(f"{what}: {key} {field} differs")


def host_fields_equal(what, got, want):
    """``got`` equals ``want`` (each ``name -> array``) field for field
    on the host, bitwise, dtypes and shapes included."""
    import numpy as np

    if set(got) != set(want):
        raise AssertionError(f"{what}: fields differ")
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        if g.dtype != w.dtype or g.shape != w.shape or \
                g.tobytes() != w.tobytes():
            raise AssertionError(f"{what}: {k} differs")


def frozen_arrays_equal(what, got, want):
    """``got`` equals ``want`` field for field: the node, edge and metric
    columns and the derived CSR, DFS and posting arrays."""
    import dataclasses

    names = [f.name for f in dataclasses.fields(want)]
    host_fields_equal(what, {n: getattr(got, n) for n in names},
                      {n: getattr(want, n) for n in names})


def streaming_phase(args, dev, smi):
    """A ``StreamingTrie`` over the retail base, served through
    ``TrieQueryEngine``: insert the held-out rules and 256 updates, and
    hold every streamed answer to the same op on the from-scratch rebuild
    served frozen on the card, bitwise, at the final epoch, after one
    staggered fold and after a full refreeze; time the streamed ops beside
    the frozen ones."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.arm.datasets import online_retail_db
    from repro_torch.arm.rulegen import sample_rule_sequences
    from repro_torch.core import FrozenTrie, StreamingTrie
    from repro_torch.core.build_arrays import build_frozen_trie
    from repro_torch.kernels import launch_counts, ops, reset_launch_counts
    from repro_torch.serve import TrieQueryEngine

    # -- the base, the full trie and the split -------------------------
    t0 = time.perf_counter()
    db = online_retail_db()
    seqs = sample_rule_sequences(db, STREAM_SEQS, max_len=STREAM_WIDTH,
                                 seed=args.seed)
    t1 = time.perf_counter()
    reset_launch_counts()
    full, _, _ = build_frozen_trie(db, seqs, device=dev)
    base, _, _ = build_frozen_trie(db, seqs[:STREAM_SEQS - STREAM_HOLDOUT],
                                   device=dev)
    builds = launch_counts()["support_count_bitmap"]
    if builds != 2:
        raise AssertionError(f"stream: {builds} support_count launches for "
                             f"two builds (one each)")
    t2 = time.perf_counter()
    full_paths, base_paths = root_paths(full, dev), root_paths(base, dev)
    have = set(base_paths)
    novel = sorted((p for p in full_paths[1:] if p not in have), key=len)
    node_of = {p: v for v, p in enumerate(full_paths)}
    rng = np.random.RandomState(args.seed + 29)
    picked = [base_paths[v]
              for v in rng.choice(np.arange(1, base.n_nodes),
                                  STREAM_UPDATES, replace=False)]
    cols = {f: np.asarray(getattr(full, f)).copy()
            for f in ("support", "confidence", "lift")}
    upd = np.zeros((3, STREAM_UPDATES), np.float32)
    for i, p in enumerate(picked):
        if i % 2 == 0:
            # another node's metric triple: exact ties with frozen values
            other = int(rng.randint(1, full.n_nodes))
            upd[:, i] = [cols[f][other] for f in cols]
        else:
            upd[:, i] = rng.rand(3).astype(np.float32)
    nov = np.asarray([[cols[f][node_of[p]] for f in cols] for p in novel],
                     np.float32).T
    for i, p in enumerate(picked):
        for j, f in enumerate(cols):
            cols[f][node_of[p]] = upd[j, i]
    oracle = FrozenTrie.from_arrays({
        **{f.name: getattr(full, f.name) for f in dataclasses.fields(full)},
        **cols})
    log(f"[stream] retail base {base.n_nodes} nodes from "
        f"{STREAM_SEQS - STREAM_HOLDOUT} sequences, full {full.n_nodes} "
        f"from {STREAM_SEQS}: {len(novel)} novel paths (depth up to "
        f"{max(len(p) for p in novel)}), {STREAM_UPDATES} updates; db and "
        f"sequences {t1 - t0:.1f} s, two builds on the card {t2 - t1:.1f} s "
        f"({builds} support_count launches)")

    # -- the stream: novel rules shortest-first, then the updates --------
    stream = StreamingTrie(base, refreeze_max_delta=1024, device=dev)
    engine = TrieQueryEngine(stream)
    t0 = time.perf_counter()
    for i in range(0, len(novel), STREAM_CHUNK):
        engine.insert(novel[i:i + STREAM_CHUNK],
                      *nov[:, i:i + STREAM_CHUNK])
    t1 = time.perf_counter()
    engine.insert(picked, *upd)
    t2 = time.perf_counter()
    ov = stream.overlay()
    t3 = time.perf_counter()
    log(f"[stream] inserts: {len(novel)} novel in "
        f"{-(-len(novel) // STREAM_CHUNK)} batches of {STREAM_CHUNK}, "
        f"{len(novel) / (t1 - t0):.0f} inserts/s; {STREAM_UPDATES} updates "
        f"in one batch, {STREAM_UPDATES / (t2 - t1):.0f} inserts/s; overlay "
        f"of {ov.d} entries ({int(ov.is_novel.sum())} novel, "
        f"{ov.masked_nodes.size} masked) built in {(t3 - t2) * 1e3:.1f} ms; "
        f"epoch {engine.epoch}")

    # -- the final epoch against the rebuild, with the counters at 0 -----
    t = stream_traffic(base, [tuple(p) for p in ov.modified], base_paths[1:],
                       novel, int(base.item_rank.shape[0]), args.seed)
    frozen_eng = TrieQueryEngine(oracle, device=dev)

    def on(eng):
        return lambda op, *a, **kw: getattr(eng, op)(*a, **kw)

    def plain(op, *a, **kw):
        return getattr(ops, op)(stream, *a, use_kernel=False, **kw)

    want = stream_pass(on(frozen_eng), t)
    reset_launch_counts()
    got = stream_pass(on(engine), t)
    torch.cuda.synchronize()
    launches = launch_counts()
    require_launched("stream frozen side", launches,
                     ("topk_rank_batch", "rules_with_member",
                      "rule_search_fused"))
    check_pass("stream final epoch vs rebuild", got, want)
    check_pass("stream kernels vs plain versions", got,
               stream_pass(plain, t))
    found = got["search"]["found"][:2048].cpu().numpy()
    if not found.all():
        raise AssertionError("stream: a delta rule was not found")
    log(f"[stream] final epoch: every answer == the rebuild served frozen "
        f"(bitwise) and == the plain versions on the card; launches "
        f"{ {k: v for k, v in launches.items() if v} }")

    # -- timing: each streamed op beside the same op on the rebuild ------
    reps = max(3, args.reps // 4)

    def timed(run):
        return {key: cuda_ms(lambda: run(op, *a, **kw), reps, warmup=1)
                for key, (op, a, kw) in stream_calls(t).items()}

    stream_ms, frozen_ms = timed(on(engine)), timed(on(frozen_eng))
    log(f"[stream ms] {smi}, median of {reps}: " + json.dumps({
        k: {"stream": stream_ms[k], "frozen": frozen_ms[k],
            "overhead": stream_ms[k] / frozen_ms[k]} for k in stream_ms}))

    # -- one staggered fold, then the full refreeze ----------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    item = engine.maybe_refreeze()
    fold_s = time.perf_counter() - t0
    if item is None:
        raise AssertionError("stream: a delta over refreeze_max_delta did "
                             "not fold")
    left = stream.n_delta
    check_pass("stream after one staggered fold vs rebuild",
               stream_pass(on(engine), t), want)
    t0 = time.perf_counter()
    folded = stream.refreeze()
    full_s = time.perf_counter() - t0
    check_pass("stream after refreeze vs rebuild",
               stream_pass(on(engine), t), want)
    frozen_arrays_equal("stream refreeze vs rebuild", stream.frozen, oracle)
    log(f"[stream fold] {smi}: one staggered fold (first item {item}) "
        f"{fold_s * 1e3:.1f} ms, {left} entries left; full refreeze of "
        f"{folded} entries {full_s * 1e3:.1f} ms; the refrozen trie == the "
        f"rebuild array for array; answers == the rebuild after each; "
        f"epoch {engine.epoch}")
    return base, full, novel, nov


# ----------------------------------------------------------------------
# the serve loop: scheduler, ladder and faults over the port's engines
# ----------------------------------------------------------------------
SERVE_REQUESTS = 4096        # requests per replay on the 2^20 trie
SERVE_MAX_BATCH = 32         # the reference bench's (paper_figs.bench_serve)
SERVE_LOADS = (("low", 0.5), ("med", 0.9), ("overload", 2.0))
SERVE_SWEEP_PENDING = 32      # the reference bench's admission limit
SERVE_DEADLINE_X = (4.0, 16.0, 64.0)    # deadlines in launch ms
SERVE_ROUND_INSERTS = 64     # the stream's inserts per round
SERVE_ROUND_QUERIES = 128    # the stream's queries per round


def serve_replay(sched, workload, clock):
    """Discrete-event replay (``paper_figs._serve_replay``): admit each
    request at its arrival time, step between arrivals.  Returns the
    responses and the count refused at admission."""
    from collections import deque

    from repro_torch.serve import QueueFull

    arrivals = deque(sorted(workload, key=lambda w: w["arrival_s"]))
    responses, refused = [], 0
    while arrivals or sched.pending:
        while arrivals and arrivals[0]["arrival_s"] <= clock.now() + 1e-12:
            w = arrivals.popleft()
            try:
                sched.submit(w["op"], w["payload"], w["kwargs"],
                             deadline_ms=w["deadline_ms"],
                             tenant=w["tenant"])
            except QueueFull:
                refused += 1
        if sched.pending:
            responses.extend(sched.step())
        elif arrivals:
            clock.sleep(arrivals[0]["arrival_s"] - clock.now())
    return responses, refused


def serve_closed_loop(sched, workload, depth):
    """Serve ``workload`` with ``depth`` requests pending: the queue is
    refilled before each step, so the loop runs as fast as it can under
    that admission limit.  Returns ``(request, workload dict)`` pairs."""
    from collections import deque

    waiting, reqs = deque(workload), []
    while waiting or sched.pending:
        while waiting and sched.pending < depth:
            w = waiting.popleft()
            reqs.append((sched.submit(w["op"], w["payload"], w["kwargs"],
                                      tenant=w["tenant"]), w))
        sched.step()
    return reqs


def serve_key(op, payload, kwargs):
    return (op, json.dumps(payload), json.dumps(kwargs, sort_keys=True))


def single_query(engine, op, payload, kwargs):
    """One request's op, run alone on ``engine``: its row on the host."""
    if op == "rule_search":
        out = engine.rule_search_batch([tuple(payload)])
    elif op == "top_k":
        out = engine.top_k_rules_batch([payload], kwargs["k"],
                                       metric=kwargs["metric"])
    else:
        out = engine.rules_with([payload], **kwargs)
    return {k: v.cpu().numpy()[0] for k, v in out.items()}


def check_rows(what, engine, sched, reqs, memo):
    """Every ok response of ``reqs`` (``(request, workload dict)``), cache
    hits included, == the same single query on ``engine``, bitwise."""
    for req, w in reqs:
        r = sched.responses[req.id]
        if r.status != "ok":
            continue
        key = serve_key(w["op"], w["payload"], w["kwargs"])
        if key not in memo:
            memo[key] = single_query(engine, w["op"], w["payload"],
                                     w["kwargs"])
        host_fields_equal(f"{what} request {req.id}", r.result, memo[key])


def serve_warm(engine, frozen, max_batch):
    """One call of every launch shape the scheduler makes (pow2 rows up
    to ``max_batch`` at its fixed width), as the reference bench warms."""
    import numpy as np

    depth = np.asarray(frozen.node_depth)
    width = 1 << max(int(depth.max()) - 1, 0).bit_length()
    b = 1
    while b <= max_batch:
        q = np.full((b, width), -1, np.int32)
        q[:, 0] = np.arange(b, dtype=np.int32)
        engine.rule_search_batch(q, np.ones((b,), np.int32))
        engine.top_k_rules_batch(q, 8, metric="confidence")
        engine.rules_with(list(range(b)), role="any", k=8, metric="lift")
        b *= 2


def latency_stats(responses):
    import numpy as np

    ok = [r for r in responses if r.status == "ok"]
    lat = np.array([r.latency_ms for r in ok])
    served = np.array([r.latency_ms for r in ok if not r.cache_hit])

    def pct(a, q):
        return float(np.percentile(a, q)) if len(a) else 0.0

    return {"p50_ms": pct(lat, 50), "p99_ms": pct(lat, 99),
            "p50_served_ms": pct(served, 50),
            "p99_served_ms": pct(served, 99)}


def serve_faults(args, dev, frozen, engine, memo):
    """The fault scenarios on fresh schedulers over the 2^20 trie."""
    from repro_torch.launch.mesh import TrieMesh
    from repro_torch.serve import (
        FaultInjector, FaultyEngine, ResilientTrieEngine, TrieQueryEngine,
        TrieScheduler, VirtualClock, zipfian_workload,
    )

    def fresh(inj, primary=engine, **kw):
        clock = VirtualClock()
        res = ResilientTrieEngine(FaultyEngine(primary, inj, clock=clock),
                                  **kw)
        return TrieScheduler(res, clock=clock, max_batch=SERVE_MAX_BATCH,
                             max_pending=SERVE_REQUESTS,
                             timer=time.perf_counter), res

    wl = zipfian_workload(frozen, 512, seed=args.seed + 2,
                          deadline_ms=(math.inf,))

    # a transient failure at the third launch: retried, answered bitwise
    inj = FaultInjector().fail_transient(3)
    sched, _ = fresh(inj)
    reqs = [(sched.submit(w["op"], w["payload"], w["kwargs"]), w)
            for w in wl[:256]]
    out = sched.drain()
    if len(out) != 256 or any(r.status != "ok" for r in out) or \
            sched.stats["retries"] != 1 or \
            not any(r.retries == 1 for r in out):
        raise AssertionError(f"serve transient: {sched.stats}")
    check_rows("serve transient", engine, sched, reqs, memo)

    # a poison query: only its rows are invalid, its batchmates answer
    items = []
    for w in wl:
        if w["op"] == "rules_with" and w["payload"] not in items:
            items.append(w["payload"])
    hot, kw = items[0], {"role": "any", "k": 8, "metric": "lift"}
    inj = FaultInjector().poison_payload(
        lambda p: isinstance(p, list) and hot in p, times=2)
    sched, _ = fresh(inj)
    batch = [hot] + items[1:12] + [hot, hot]
    reqs = [(sched.submit("rules_with", it, kw),
             {"op": "rules_with", "payload": it, "kwargs": kw})
            for it in batch]
    sched.drain()
    for req, w in reqs:
        status = sched.responses[req.id].status
        if status != ("invalid" if w["payload"] == hot else "ok"):
            raise AssertionError(f"serve poison: item {w['payload']} "
                                 f"{status}")
    check_rows("serve poison", engine, sched, reqs, memo)

    # a shard failure at the sixth launch: one failover, the in-flight
    # batch answered on the primary, older cache entries orphaned
    inj = FaultInjector().fail_nth_launch(6, shard=0)
    sched, res = fresh(inj)
    groups = {}
    for w in wl:
        g = groups.setdefault((w["op"], json.dumps(w["kwargs"])), [])
        if w["payload"] not in [x["payload"] for x in g]:
            g.append(w)
    rs = groups[("rule_search", "{}")]
    tk = next(g for (op, _), g in groups.items() if op == "top_k")
    rw = next(g for (op, _), g in groups.items() if op == "rules_with")
    if len(rs) < 16:
        raise AssertionError(f"serve failover: {len(rs)} distinct rule "
                             f"searches in the traffic")
    k4 = [dict(w, kwargs=dict(w["kwargs"], k=4)) for w in tk[:8]]
    r4 = [dict(w, kwargs=dict(w["kwargs"], k=4)) for w in rw[:8]]
    first = [rs[:8], tk[:8], rw[:8], k4, r4]
    done = []
    for g in first:
        done.append([(sched.submit(w["op"], w["payload"], w["kwargs"]), w)
                     for w in g])
        sched.drain()
    if inj.launches != 5 or sched.stats["cache_hits"]:
        raise AssertionError(f"serve failover: {inj.launches} launches "
                             f"before the failure")
    hits = [(sched.submit(w["op"], w["payload"], w["kwargs"]), w)
            for w in rs[:8]]
    sched.drain()
    if not all(sched.responses[q.id].cache_hit for q, _ in hits):
        raise AssertionError("serve failover: a cached entry missed "
                             "before the failure")
    cached = sched.cache_len
    inflight = [(sched.submit(w["op"], w["payload"], w["kwargs"]), w)
                for w in rs[8:16]]
    sched.drain()
    if res.failovers != 1 or res.health.dead != {0} or any(
            sched.responses[q.id].status != "ok"
            or sched.responses[q.id].backend != "replicated"
            for q, _ in inflight):
        raise AssertionError(f"serve failover: failovers {res.failovers}, "
                             f"dead {res.health.dead}")
    check_rows("serve failover in flight", engine, sched, inflight, memo)
    hits0 = sched.stats["cache_hits"]
    again = [[(sched.submit(w["op"], w["payload"], w["kwargs"]), w)
              for w in g] for g in first]
    sched.drain()
    if sched.stats["cache_hits"] != hits0 or any(
            sched.responses[q.id].cache_hit for g in again for q, _ in g):
        raise AssertionError("serve failover: an entry cached before the "
                             "failover was served after it")
    for g in done + again:
        check_rows("serve failover", engine, sched, g, memo)

    # the ladder's replicated rung over a one-shard sharded primary: a
    # one-device engine on the primary's device, bitwise (the [shard]
    # phase drives both rungs over four shards)
    primary = TrieQueryEngine(frozen, mesh=TrieMesh([dev]), mode="sharded")
    inj = FaultInjector().fail_nth_launch(1, shard=0)
    sched, res = fresh(inj, primary)
    reqs = [(sched.submit(w["op"], w["payload"], w["kwargs"]), w)
            for w in wl[:64]]
    sched.drain()
    if res.backend != "replicated" or res._replicated.device != dev or \
            res._replicated.plan is not None or \
            any(sched.responses[q.id].status != "ok" for q, _ in reqs):
        raise AssertionError("serve ladder: the replicated rung")
    check_rows("serve ladder replicated rung", engine, sched, reqs, memo)
    log(f"[serve faults] transient at launch 3: retried once, answered "
        f"bitwise; poison item: only its 3 rows invalid, "
        f"{len(batch) - 3} batchmates bitwise; shard failure at launch 6: "
        f"1 failover, the in-flight batch bitwise on the primary, "
        f"{cached} entries cached before it missed after it; a one-shard "
        f"sharded primary: replicated rung on {dev}, bitwise")


def serve_frozen(args, dev, smi, frozen):
    """The 2^20 trie through the whole serve stack: a drain, the capacity
    at the sweep's admission limit, the reference bench's load sweep, and
    the faults."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import (
        FaultInjector, FaultyEngine, ResilientTrieEngine, TrieQueryEngine,
        TrieScheduler, VirtualClock, zipfian_workload,
    )

    engine = TrieQueryEngine(frozen, device=dev)
    serve_warm(engine, frozen, SERVE_MAX_BATCH)
    torch.cuda.synchronize()

    def fresh(clock, **kw):
        res = ResilientTrieEngine(FaultyEngine(engine, FaultInjector(),
                                               clock=clock))
        return TrieScheduler(res, clock=clock, max_batch=SERVE_MAX_BATCH,
                             timer=time.perf_counter, **kw)

    # -- the drain: everything at once, no deadlines ---------------------
    wl = zipfian_workload(frozen, SERVE_REQUESTS, seed=args.seed,
                          deadline_ms=(math.inf,))
    clock = VirtualClock()
    sched = fresh(clock, max_pending=SERVE_REQUESTS)
    reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [(sched.submit(w["op"], w["payload"], w["kwargs"],
                          tenant=w["tenant"]), w) for w in wl]
    out = sched.drain()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    require_launched("serve drain", launches,
                     ("topk_rank_batch", "rule_search_fused",
                      "rules_with_member"))
    if len(out) != SERVE_REQUESTS or any(r.status != "ok" for r in out):
        raise AssertionError(f"serve drain: {sched.stats}")
    memo = {}
    check_rows("serve drain", engine, sched, reqs, memo)
    st = sched.stats
    burst = st["ok"] / max(clock.now(), 1e-9)
    log(f"[serve drain] {smi}: {SERVE_REQUESTS} zipfian requests on the "
        f"{frozen.n_nodes}-node trie, max_batch {SERVE_MAX_BATCH}: "
        f"{st['launches']} launches, {st['cache_hits']} cache hits, "
        f"{st['dedup_collapsed']} dedup collapsed; every row (cache hits "
        f"included) == the single query on the card, bitwise "
        f"({len(memo)} distinct); service {clock.now() * 1e3:.3f} ms on "
        f"the virtual clock "
        f"({clock.now() * 1e3 / max(st['launches'], 1):.4f} ms a launch, "
        f"a burst's rate {burst:.1f} requests/s), host wall "
        f"{wall * 1e3:.1f} ms; kernel launches "
        f"{ {k: v for k, v in launches.items() if v} }")

    # -- capacity at the sweep's admission limit: the same requests with
    # the queue held at max_pending, the loop's sustained rate ----------
    clock = VirtualClock()
    sched = fresh(clock, max_pending=SERVE_SWEEP_PENDING)
    reqs = serve_closed_loop(sched, wl, SERVE_SWEEP_PENDING)
    st = sched.stats
    if st["ok"] != SERVE_REQUESTS or len(sched.responses) != SERVE_REQUESTS:
        raise AssertionError(f"serve capacity: {st}")
    check_rows("serve capacity", engine, sched, reqs, memo)
    capacity = st["ok"] / max(clock.now(), 1e-9)
    launch_ms = clock.now() * 1e3 / max(st["launches"], 1)
    log(f"[serve capacity] {smi}: the drain's {SERVE_REQUESTS} requests "
        f"with {SERVE_SWEEP_PENDING} pending: {st['launches']} launches, "
        f"{st['cache_hits']} cache hits, {st['dedup_collapsed']} dedup "
        f"collapsed, every row bitwise; {launch_ms:.4f} ms a launch, "
        f"capacity {capacity:.1f} requests/s (the sweep's 1x)")

    # -- the load sweep at 0.5x, 0.9x and 2x that capacity ---------------
    deadlines = tuple(m * launch_ms for m in SERVE_DEADLINE_X)
    for name, mult in SERVE_LOADS:
        wl = zipfian_workload(frozen, SERVE_REQUESTS, seed=args.seed + 1,
                              arrival_rate=mult * capacity,
                              deadline_ms=deadlines)
        clock = VirtualClock()
        sched = fresh(clock, max_pending=SERVE_SWEEP_PENDING)
        out, refused = serve_replay(sched, wl, clock)
        st = sched.stats
        ids = [r.id for r in out]
        counts = {s: sum(r.status == s for r in out)
                  for s in ("ok", "timeout", "shed", "failed", "invalid")}
        if len(set(ids)) != len(ids) or \
                sorted(ids) != sorted(sched.responses) or \
                len(ids) != st["submitted"] or \
                len(ids) + refused != SERVE_REQUESTS or \
                any(counts[s] != st[s]
                    for s in ("ok", "timeout", "failed", "invalid")) or \
                counts["shed"] + refused != st["shed"]:
            raise AssertionError(f"serve load {name}: responses {counts}, "
                                 f"refused {refused}, stats {st}")
        n = SERVE_REQUESTS
        log(f"[serve load] {smi}: {name}, offered "
            f"{mult * capacity:.1f} requests/s ({mult}x the capacity at "
            f"max_pending {SERVE_SWEEP_PENDING}), deadlines "
            f"{', '.join(f'{d:.3f}' for d in deadlines)} ms: " + json.dumps({
                **latency_stats(out),
                "qps_sustained": counts["ok"] / max(clock.now(), 1e-9),
                "ok_rate": counts["ok"] / n,
                "timeout_rate": st["timeout"] / n,
                "shed_rate": st["shed"] / n,
                "cache_hit_rate": st["cache_hits"] / n,
                "launches": st["launches"]}))

    serve_faults(args, dev, frozen, engine, memo)


def stream_round_queries(rng, base_wl, inserted, n):
    """``n`` requests: ``base_wl`` (the base's zipfian traffic), the rest over
    the paths inserted so far (the newest the most popular, Zipf s=1.2):
    a rule split of the path, its parent prefix, its last item."""
    import numpy as np

    out = list(base_wl)
    ranks = np.arange(1, len(inserted) + 1, dtype=np.float64) ** -1.2
    picks = rng.choice(len(inserted), size=n - len(out),
                       p=ranks / ranks.sum())
    for i, j in enumerate(picks):
        p = list(inserted[len(inserted) - 1 - int(j)])
        if i % 3 == 0:
            cut = int(rng.randint(1, len(p))) if len(p) > 1 else 1
            out.append({"op": "rule_search", "kwargs": {},
                        "payload": (p[:cut], p[cut:] or p[:cut])})
        elif i % 3 == 1:
            out.append({"op": "top_k", "payload": p[:-1],
                        "kwargs": {"k": 8, "metric": "confidence"}})
        else:
            out.append({"op": "rules_with", "payload": p[-1],
                        "kwargs": {"role": "any", "k": 8,
                                   "metric": "lift"}})
    return out


def batched_calls(ws):
    """The requests ``ws`` grouped as ``batched_rows`` calls them: one
    ``(op, kwargs, requests)`` per op and distinct kwargs."""
    for op in ("rule_search", "top_k", "rules_with"):
        sel = [w for w in ws if w["op"] == op]
        for kw in sorted({json.dumps(w["kwargs"], sort_keys=True)
                          for w in sel}):
            yield op, json.loads(kw), [
                w for w in sel
                if json.dumps(w["kwargs"], sort_keys=True) == kw]


def batched_rows(engine, ws):
    """The requests ``ws`` as one batched call per op on ``engine``:
    ``serve_key -> host row``."""
    rows = {}
    for op, kwargs, part in batched_calls(ws):
        if op == "rule_search":
            out = engine.rule_search_batch(
                [tuple(w["payload"]) for w in part])
        elif op == "top_k":
            out = engine.top_k_rules_batch(
                [w["payload"] for w in part], kwargs["k"],
                metric=kwargs["metric"])
        else:
            out = engine.rules_with([w["payload"] for w in part],
                                    **kwargs)
        host = {k: v.cpu().numpy() for k, v in out.items()}
        for i, w in enumerate(part):
            rows[serve_key(op, w["payload"], w["kwargs"])] = {
                k: v[i] for k, v in host.items()}
    return rows


def serve_stream(args, dev, smi, parts):
    """The retail stream through the scheduler, inserts and
    queries together, round by round."""
    import numpy as np
    from repro_torch.core import StreamingTrie
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs import Observability
    from repro_torch.serve import (
        TrieQueryEngine, TrieScheduler, zipfian_workload,
    )

    base, full, novel, nov = parts
    stream = StreamingTrie(base, device=dev)
    engine = TrieQueryEngine(stream)
    obs = Observability(tracing=True)
    sched = TrieScheduler(engine, max_batch=SERVE_MAX_BATCH,
                          max_pending=1 << 16, obs=obs)
    rng = np.random.RandomState(args.seed + 31)
    n_rounds = -(-len(novel) // SERVE_ROUND_INSERTS)
    half = SERVE_ROUND_QUERIES // 2
    base_wl = zipfian_workload(base, n_rounds * half, seed=args.seed + 100)
    launches = {}
    t0 = time.perf_counter()
    last = None
    for r in range(n_rounds):
        lo, hi = r * SERVE_ROUND_INSERTS, (r + 1) * SERVE_ROUND_INSERTS
        for i in range(lo, min(hi, len(novel))):
            sched.submit("insert", (novel[i], *(float(x) for x in nov[:, i])))
        ws = stream_round_queries(
            rng, base_wl[r * half:(r + 1) * half],
            novel[:min(hi, len(novel))], SERVE_ROUND_QUERIES)
        reqs = [(sched.submit(w["op"], w["payload"], w["kwargs"]), w)
                for w in ws]
        # the scheduler's own launches: counted over the drain alone,
        # before the check's direct calls below
        reset_launch_counts()
        out = sched.drain()
        for k, v in launch_counts().items():
            launches[k] = launches.get(k, 0) + v
        if any(x.status != "ok" for x in out):
            raise AssertionError(f"serve stream round {r}: "
                                 f"{sched.stats}")
        # the round's inserts land before any of its queries: a cache
        # hit can only come from a miss of the same round
        key_of = {q.id: q.key for q, _ in reqs}
        missed = set()
        for x in out:
            if x.op == "insert":
                continue
            key = key_of[x.id]
            if x.cache_hit and key not in missed:
                raise AssertionError(f"serve stream round {r}: a response "
                                     f"from a cache entry of an older "
                                     f"epoch")
            missed.add(key)
        want = batched_rows(engine, ws)
        for q, w in reqs:
            host_fields_equal(f"serve stream round {r} request {q.id}",
                       sched.responses[q.id].result,
                       want[serve_key(w["op"], w["payload"], w["kwargs"])])
        last = (reqs, ws)
    wall = time.perf_counter() - t0
    require_launched("serve stream", launches,
                     ("topk_rank_batch", "rule_search_fused",
                      "rules_with_member"))
    st = sched.stats
    if st["inserted"] != len(novel):
        raise AssertionError(f"serve stream: {st['inserted']} inserted of "
                             f"{len(novel)}")
    reqs, ws = last
    full_eng = TrieQueryEngine(full, device=dev)
    want = batched_rows(full_eng, ws)
    for q, w in reqs:
        host_fields_equal(f"serve stream vs full request {q.id}",
                   sched.responses[q.id].result,
                   want[serve_key(w["op"], w["payload"], w["kwargs"])])
    stream.refreeze()
    frozen_arrays_equal("serve stream refreeze vs full", stream.frozen, full)
    spans = obs.tracer.finished()
    drain_s = sum(s.duration_s for s in spans if s.name == "insert_drain")
    fold_s = [s.duration_s for s in spans if s.name == "refreeze"
              and s.attrs.get("folded")]
    lat = {}
    for op in ("rule_search", "top_k", "rules_with"):
        ms = np.array([x.latency_ms for x in sched.responses.values()
                       if x.op == op])
        svc = np.array([s.duration_s * 1e3 for s in spans
                        if s.name == "launch" and s.attrs.get("op") == op])
        lat[op] = {"p50_ms": float(np.percentile(ms, 50)),
                   "p99_ms": float(np.percentile(ms, 99)),
                   "launch_ms_mean": float(svc.mean()), "launches": len(svc)}
    log(f"[serve stream] {smi}: {len(novel)} inserts in {n_rounds} rounds "
        f"of {SERVE_ROUND_INSERTS} with {SERVE_ROUND_QUERIES} queries each "
        f"on the {base.n_nodes}-node retail base; every query == the "
        f"engine at its round's epoch, bitwise; no cache hit across an "
        f"epoch; last round == the full trie served frozen, bitwise; the "
        f"stream refrozen == the full trie array for array; "
        f"{st['inserted']} inserted, {st['refreezes']} refreezes "
        f"({sum(fold_s) * 1e3:.1f} ms folding), "
        f"{len(novel) / max(drain_s - sum(fold_s), 1e-9):.0f} inserts/s "
        f"through the loop, {st['cache_hits']} cache hits, "
        f"{st['launches']} launches (kernel launches in the drains "
        f"{ {k: v for k, v in launches.items() if v} }), wall "
        f"{wall:.1f} s; per op: " + json.dumps(lat))


def serve_phase(args, dev, smi, frozen, stream_parts):
    """The serve loop on the card: over the main path's trie, then over
    the streaming phase's retail base."""
    serve_frozen(args, dev, smi, frozen)
    serve_stream(args, dev, smi, stream_parts)


SHARD_COUNTS = (1, 2, 4)      # the [shard] phase's shard counts
SHARD_DEAD = (1, 3)           # the shards it masks dead at P = 4
SHARD_MASK_PREFIXES = 32      # rows of the masked plan's CPU twin (its
SHARD_MASK_ITEMS = 16         # plain versions run on the host cores)


def shard_meshes(dev):
    """A ``TrieMesh`` per P of ``SHARD_COUNTS``: the first P visible GPUs,
    or P shards on ``dev`` where fewer are visible."""
    import torch
    from repro_torch.launch.mesh import TrieMesh

    n = torch.cuda.device_count()
    return {p: TrieMesh([torch.device("cuda", i) for i in range(p)]
                        if n >= p else [dev] * p) for p in SHARD_COUNTS}


def live_shards(plan):
    """Shards with a DFS range: each launches every kernel of an op once."""
    return sum(sh.dfs_len > 0 for sh in plan.trie.shards)


def shard_drive(engine, traffic, metrics=METRICS, chain=False):
    """The [shard] phase's ops on ``engine``: the search rows (and the
    ragged pairs), top-k at k = 10 and 100 for each metric, rules_with
    for each role."""
    queries, ant_len, pairs, prefixes, items = traffic
    out = {"search": engine.rule_search_batch(queries, ant_len)}
    if not chain:
        out["pairs"] = engine.rule_search_batch(pairs)
    for metric in metrics:
        for k in (10, 100):
            out[f"topk {metric} k={k}"] = engine.top_k_rules_batch(
                prefixes, k, metric=metric)
    for role in ROLES:
        out[role] = engine.rules_with(items, role=role, k=10)
    return out


def shard_same(what, got, want):
    """Every field of every answer bitwise, on the host."""
    for key, w in want.items():
        host_fields_equal(f"{what} {key}",
                          {f: v.cpu().numpy() for f, v in got[key].items()},
                          {f: v.cpu().numpy() for f, v in w.items()})


def shard_launches(what, launches, want):
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{what}: {name} launched {launches[name]}"
                                 f" times, expected {n} (once a live shard"
                                 f" an op)")


def shard_op_ms(engine, traffic, reps):
    queries, ant_len, _, prefixes, items = traffic
    return {
        "rule_search_batch": cuda_ms(
            lambda: engine.rule_search_batch(queries, ant_len), reps),
        "top_k_rules_batch_k10": cuda_ms(
            lambda: engine.top_k_rules_batch(prefixes, 10), reps),
        "top_k_rules_batch_k100": cuda_ms(
            lambda: engine.top_k_rules_batch(prefixes, 100), reps),
        "rules_with_any": cuda_ms(
            lambda: engine.rules_with(items, role="any", k=10), reps),
    }


def shard_query_path(args, dev, smi, engine, traffic, meshes):
    """The query-path trie at each P against the replicated engine; the
    plans, for the mask and the ladder."""
    import torch
    from repro_torch.distributed.trie_sharding import shard_device_trie
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import TrieQueryEngine

    frozen = engine.frozen
    want = shard_drive(engine, traffic)
    plans, op_ms = {}, {"replicated": shard_op_ms(engine, traffic,
                                                  args.reps)}
    for p, mesh in meshes.items():
        t0 = time.perf_counter()
        plan = shard_device_trie(frozen, mesh)
        build_s = time.perf_counter() - t0
        sharded = TrieQueryEngine(frozen, plan=plan)
        reset_launch_counts()
        got = shard_drive(sharded, traffic)
        torch.cuda.synchronize()
        launches = launch_counts()
        live = live_shards(plan)
        shard_launches(f"shard P={p}", launches, {
            "rule_search_fused": 2 * live,
            "topk_rank_batch": (2 * len(METRICS) + 1) * live,
            "rules_with_member": 2 * live})
        shard_same(f"shard P={p}", got, want)
        plans[p] = plan
        op_ms[f"P={p}"] = shard_op_ms(sharded, traffic, args.reps)
        log(f"[shard] P={p} over {[str(d) for d in mesh.devices]}: ranges "
            f"{list(plan.ranges)}, resident bytes per shard "
            f"{[sh.nbytes() for sh in plan.trie.shards]} (replicated "
            f"{engine.dt.nbytes()}), plan built in {build_s:.2f} s; every "
            f"answer == the replicated engine's bitwise (4096 rows, 256 "
            f"pairs, 256 prefixes at k = 10 and 100 for each metric, 256 "
            f"items each role); launches a live shard an op: "
            f"{ {k: v for k, v in launches.items() if v} }")
    log(f"[shard ms] {smi}; P shards on ONE card (the cost of the split, "
        f"not scaling across GPUs), CUDA events, median of {args.reps}: "
        + json.dumps(op_ms))
    return plans


def trie_ops(trie):
    """``kernels.ops`` on one trie (a compressed ``DeviceTrie`` or a plan)
    under the engine's method names, for ``shard_drive``."""
    from functools import partial
    from types import SimpleNamespace

    from repro_torch.kernels import ops

    return SimpleNamespace(
        rule_search_batch=partial(ops.rule_search_batch, trie),
        top_k_rules_batch=partial(ops.top_k_rules_batch, trie),
        rules_with=partial(ops.rules_with, trie))


def shard_chain(args, dev, chain, mesh):
    """The chain trie compressed (f32, int32 + bf16) at P = 4 through the
    span kernel against the single-device compressed tries."""
    import torch
    from repro_torch.core.array_trie import canonical_prefix_rows
    from repro_torch.distributed.trie_sharding import shard_device_trie
    from repro_torch.kernels import launch_counts, reset_launch_counts

    arrs, fz = chain
    queries, ant_len, prefixes, items = chain_traffic(arrs, args.seed)
    # a compressed DeviceTrie keeps no item ranks: prefixes go in already
    # in frequency order, so both sides descend the same rows
    prefixes = canonical_prefix_rows(prefixes, fz.item_rank)
    traffic = (queries, ant_len, None, prefixes, items)
    for tag in ("compressed", "i32+bf16"):
        kw = dict(QUANT[tag], layout="compressed")
        dt = fz.device_arrays(device=dev, **kw)
        t0 = time.perf_counter()
        plan = shard_device_trie(fz, mesh, **kw)
        build_s = time.perf_counter() - t0

        want = shard_drive(trie_ops(dt), traffic, ("confidence",),
                           chain=True)
        reset_launch_counts()
        got = shard_drive(trie_ops(plan), traffic, ("confidence",),
                          chain=True)
        torch.cuda.synchronize()
        launches = launch_counts()
        live = live_shards(plan)
        shard_launches(f"shard chain {tag}", launches, {
            "rule_search_span": live, "topk_rank_batch": 2 * live,
            "rules_with_member": 3 * live, "rule_search_fused": 0})
        shard_same(f"shard chain {tag}", got, want)
        log(f"[shard chain] {tag}, P={plan.n_shards}: ranges "
            f"{list(plan.ranges)}, resident bytes per shard "
            f"{[sh.nbytes() for sh in plan.trie.shards]} (one device "
            f"{dt.nbytes()}), plan built in {build_s:.2f} s; every answer "
            f"== the single-device compressed ops bitwise; launches "
            f"{ {k: v for k, v in launches.items() if v} }")


def shard_mask(args, dev, frozen, plan, traffic):
    """``mask_dead_shards`` on the card against the same masked plan on
    the CPU (plain versions), bitwise; masking every shard raises."""
    import torch
    from repro_torch.distributed.trie_sharding import (
        mask_dead_shards, shard_device_trie,
    )
    from repro_torch.kernels import launch_counts, ops, reset_launch_counts
    from repro_torch.launch.mesh import TrieMesh

    queries, ant_len, _, prefixes, items = traffic
    p = plan.n_shards
    masked = mask_dead_shards(plan, SHARD_DEAD)
    t0 = time.perf_counter()
    twin = mask_dead_shards(
        shard_device_trie(frozen, TrieMesh(["cpu"] * p)), SHARD_DEAD)
    prefixes, items = prefixes[:SHARD_MASK_PREFIXES], items[
        :SHARD_MASK_ITEMS]

    def run(trie):
        return {
            "search": ops.rule_search_batch(trie, queries, ant_len),
            "topk": ops.top_k_rules_batch(trie, prefixes, 10),
            "antecedent": ops.rules_with(trie, items, role="antecedent",
                                         k=10),
        }

    reset_launch_counts()
    got = run(masked)
    torch.cuda.synchronize()
    launches = launch_counts()
    live = live_shards(masked)
    shard_launches("shard mask", launches, {
        "rule_search_fused": live, "topk_rank_batch": live,
        "rules_with_member": live})
    shard_same("shard mask vs CPU twin", got, run(twin))
    try:
        mask_dead_shards(plan, range(p))
    except ValueError:
        pass
    else:
        raise AssertionError("shard mask: masking every shard answered")
    found = int(got["search"]["found"].sum())
    log(f"[shard mask] shards {list(SHARD_DEAD)} of {p} dead: {live} live "
        f"shards launch; 4096 rows ({found} found), {len(prefixes)} "
        f"prefixes, {len(items)} items == the masked plan on the CPU "
        f"(plain versions) bitwise ({time.perf_counter() - t0:.1f} s); "
        f"masking all {p} raises ValueError")


def shard_ladder(args, dev, engine, plan):
    """Both ladder rungs over a sharded P = 4 primary with a ShardFailure
    on shard 1."""
    from repro_torch.distributed.trie_sharding import mask_dead_shards
    from repro_torch.serve import (
        FaultInjector, FaultyEngine, ResilientTrieEngine, TrieQueryEngine,
        TrieScheduler, VirtualClock, zipfian_workload,
    )

    frozen = engine.frozen
    primary = TrieQueryEngine(frozen, plan=plan)
    masked = TrieQueryEngine(frozen, plan=mask_dead_shards(plan, [1]))
    wl = zipfian_workload(frozen, 128, seed=args.seed + 5,
                          deadline_ms=(math.inf,))
    for allow, oracle in ((True, engine), (False, masked)):
        clock = VirtualClock()
        inj = FaultInjector().fail_nth_launch(1, shard=1)
        res = ResilientTrieEngine(FaultyEngine(primary, inj, clock=clock),
                                  allow_replicated_fallback=allow)
        sched = TrieScheduler(res, clock=clock, max_batch=SERVE_MAX_BATCH,
                              max_pending=SERVE_REQUESTS,
                              timer=time.perf_counter)
        reqs = [(sched.submit(w["op"], w["payload"], w["kwargs"]), w)
                for w in wl]
        sched.drain()
        rung = "replicated" if allow else "degraded"
        if res.failovers != 1 or res.health.dead != {1} or \
                res.backend != rung or any(
                    sched.responses[q.id].status != "ok"
                    or sched.responses[q.id].degraded is allow
                    for q, _ in reqs):
            raise AssertionError(f"shard ladder {rung}: failovers "
                                 f"{res.failovers}, {sched.stats}")
        check_rows(f"shard ladder {rung}", oracle, sched, reqs, {})
    log(f"[shard ladder] a P={plan.n_shards} primary, ShardFailure on "
        f"shard 1 at the first launch: the replicated rung answers "
        f"{len(wl)} requests == the replicated engine bitwise; the masked "
        f"rung answers them degraded=True == mask_dead_shards(plan, [1]) "
        f"bitwise")


def batched_launches(ws, live):
    """The kernel launches of ``batched_rows(engine, ws)`` on a sharded
    plain-layout engine with ``live`` live shards: each batched call
    launches its op's kernel once a live shard (the consequent role ranks
    the posting-ordered columns, the other roles run membership)."""
    want = Counter({"rule_search_fused": 0, "topk_rank_batch": 0,
                    "rules_with_member": 0, "rule_search_span": 0})
    for op, kwargs, _ in batched_calls(ws):
        if op == "rule_search":
            want["rule_search_fused"] += live
        elif op == "top_k" or kwargs.get("role") == "consequent":
            want["topk_rank_batch"] += live
        else:
            want["rules_with_member"] += live
    return want


def shard_stream(args, dev, mesh, parts):
    """The retail stream over a P = 4 mesh beside the unsharded stream:
    two rounds of inserts and queries, then a fold.  The launch counts are
    the sharded engine's alone: reset after the unsharded stream's call,
    read after the sharded one's."""
    import numpy as np
    import torch
    from repro_torch.core import StreamingTrie
    from repro_torch.distributed.trie_sharding import shard_dfs_ranges
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import TrieQueryEngine, zipfian_workload

    base, full, novel, nov = parts
    plain = TrieQueryEngine(StreamingTrie(base, device=dev))
    st = StreamingTrie(base, mesh=mesh, device=dev)
    sharded = TrieQueryEngine(st, mode="sharded")
    rng = np.random.RandomState(args.seed + 37)
    base_wl = zipfian_workload(base, 128, seed=args.seed + 38)
    sample = [base.path_items(int(v))
              for v in rng.randint(1, base.n_nodes, size=32)]
    t0 = time.perf_counter()
    launches = Counter()
    for step in ("round 1", "round 2", "fold"):
        if step == "fold":
            prev = st._last_ranges
            plain.stream.refreeze()
            st.refreeze()
            inserted = novel[:2 * SERVE_ROUND_INSERTS]
        else:
            r = int(step[-1]) - 1
            lo, hi = r * SERVE_ROUND_INSERTS, (r + 1) * SERVE_ROUND_INSERTS
            for eng in (plain, sharded):
                eng.insert([list(p) for p in novel[lo:hi]],
                           *(nov[j, lo:hi] for j in range(3)))
            inserted = novel[:hi]
        ws = stream_round_queries(rng, base_wl[:64], inserted, 128)
        want = batched_rows(plain, ws)
        reset_launch_counts()
        got = batched_rows(sharded, ws)
        torch.cuda.synchronize()
        counts = launch_counts()
        launches.update(counts)
        for key, row in want.items():
            host_fields_equal(f"shard stream {step} {key}", got[key], row)
        plan = st.shard_plan()
        shard_launches(f"shard stream {step}", counts,
                       batched_launches(ws, live_shards(plan)))
        for p in list(inserted) + sample:
            owner = st.owner_shard(p)
            node = st._frozen_node((p[0],))
            if node is not None:
                lo, hi = plan.ranges[owner]
                if not lo <= int(st.frozen.dfs_order[node]) < hi:
                    raise AssertionError(f"shard stream {step}: owner of "
                                         f"{p} is {owner}")
        if step == "fold" and plan.ranges != tuple(shard_dfs_ranges(
                st.frozen, plan.n_shards, prev, st.rebalance_drift)):
            raise AssertionError("shard stream: the fold's cuts")
    log(f"[shard stream] the retail base ({base.n_nodes} nodes) over "
        f"P={mesh.shape['data']}: two rounds of {SERVE_ROUND_INSERTS} "
        f"inserts and 128 queries, then a fold: every answer == the "
        f"unsharded stream's bitwise; owner_shard agrees with the plan's "
        f"ranges ({len(sample)} base paths and every inserted one); the "
        f"fold's cuts {list(plan.ranges)} are the drift gate's; "
        f"{time.perf_counter() - t0:.1f} s; the sharded stream's own "
        f"launches (each kernel once a live shard a batched call): "
        f"{ {k: v for k, v in sorted(launches.items()) if v} }")


def shard_phase(args, dev, smi, engine, traffic, chain, stream_parts):
    """The sharded trie on the card: P = 1, 2 and 4 shards (on as many
    GPUs as are visible, else on one), every answer bitwise against one
    device; the mask, the ladder and the stream over four shards."""
    meshes = shard_meshes(dev)
    plans = shard_query_path(args, dev, smi, engine, traffic, meshes)
    shard_chain(args, dev, chain, meshes[4])
    shard_mask(args, dev, engine.frozen, plans[4], traffic)
    shard_ladder(args, dev, engine, plans[4])
    shard_stream(args, dev, meshes[4], stream_parts)


def profiler_pass(engine, queries, ant_len, pairs, prefixes, items, res):
    """One pass of the main path with the launch profiler on: one record
    per op dispatch under the reference's op names, and the same answers
    as the pass without it, bitwise."""
    from repro_torch.obs import kernel_profiler

    kernel_profiler.clear()
    with kernel_profiler.enabled_scope():
        got = drive_engine(engine, queries, ant_len, pairs, prefixes, items)
    counts = {op: len(kernel_profiler.ring(op))
              for op in kernel_profiler.ops()}
    expect = {"rule_search": 2, "rules_with": 3, "top_k": 2,
              "trie_reduce": 1}
    if counts != expect:
        raise AssertionError(f"obs: profiler records {counts}, one per op "
                             f"dispatch is {expect}")
    for key in res:
        for field, w in res[key].items():
            if not bitwise_equal(got[key][field], w):
                raise AssertionError(f"obs: {key} {field} differs with the "
                                     f"profiler on")
    ms = {op: sum(r.seconds for r in kernel_profiler.ring(op)) * 1e3
          / counts[op] for op in counts}
    log(f"[obs] profiler ring counts {counts}; answers == the pass without "
        f"it (bitwise); host ms per dispatch, device synchronized: "
        f"{json.dumps(ms)}")
    kernel_profiler.clear()


# the LM serving phase: smollm-360m at full width and depth
LM_ARCH = "smollm-360m"
LM_SIZES = dict(prompt=512,   # chunked prefill: > 256 and a multiple of it
                decode=64, max_seq=1024, xdev=64, corpus_docs=200)
LM_XDEV_TOL = 1e-3            # card against CPU, f32 prefill logits
LM_BATCHES = (1, 8)
LM_TIMED_STEPS = 32           # decode steps a timed run (median of 3)


def lm_token_stream(n_docs, seed):
    """Byte-tokenized ``synthetic_corpus`` documents: the rows the corpus
    proposer is fit on, and one stream the prompts are cut from."""
    import numpy as np
    from repro_torch.data import ByteTokenizer, synthetic_corpus

    tok = ByteTokenizer()
    rows = [tok.encode(d) for d in synthetic_corpus(n_docs, seed=seed)]
    return rows, np.concatenate([np.asarray(r, np.int32) for r in rows])


def rejecting_rows(seq, n, vocab):
    """The n-grams of ``seq`` with the last token changed at two positions
    in three: a trie fit on them drafts a wrong token after most contexts
    (after a repeated one too), so its drafts are rejected."""
    rows = []
    for i in range(n - 1, len(seq)):
        gram = [int(t) for t in seq[i - n + 1:i + 1]]
        if i % 3:
            gram[-1] = (gram[-1] + 1) % vocab
        rows.append(gram)
    return rows


def lm_spec_vs_greedy(cfg, params, dev, prompt, sizes, corpus_trie,
                      cache_dtype):
    """Greedy tokens, then speculative decoding with three proposers: the
    corpus n-gram trie (a random model's tokens leave the byte vocabulary,
    so it drafts little or nothing), a trie fit on the greedy continuation
    itself (drafts accepted) and one fit on its 4-grams with the last
    token changed in two of three (drafts rejected, the cache rewound).
    Returns (greedy tokens, {proposer: (speculative tokens, stats)})."""
    from repro_torch.data import NgramTrie
    from repro_torch.models import init_cache
    from repro_torch.serve.engine import greedy_generate
    from repro_torch.serve.spec_decode import speculative_generate

    n, max_seq = sizes["decode"], sizes["max_seq"]
    greedy, _ = greedy_generate(
        cfg, params, init_cache(cfg, 1, max_seq, cache_dtype, dev), prompt, n)
    greedy = greedy.cpu().numpy()[0]
    seq = list(prompt[0]) + list(greedy)
    tries = {"corpus": corpus_trie,
             "continuation": NgramTrie(n=4).fit([seq]),
             "rejecting": NgramTrie(n=4).fit(
                 rejecting_rows(seq, 4, cfg.vocab_size))}
    out = {}
    for name, trie in tries.items():
        toks, stats = speculative_generate(
            cfg, params, init_cache(cfg, 1, max_seq, cache_dtype, dev),
            prompt, trie, n)
        out[name] = (toks[0], stats)
    return greedy, out


def lm_logit_gap(cfg, params, dev, prompt, greedy, i):
    """top-1 minus top-2 of the greedy step's f32 logits before token i."""
    import numpy as np
    import torch
    from repro_torch.models import forward

    toks = np.concatenate([prompt[0], greedy[:i]])[None]
    with torch.inference_mode():
        logits, _, _ = forward(cfg, params, {"tokens": torch.as_tensor(
            toks, device=dev)}, logits_mode="last")
    top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0] - top[1])


def lm_spec_checks(cfg32, params, dev, prompt, sizes, corpus_trie, label):
    """In f32 (the caller turns TF32 off): speculative == greedy token for
    token with every proposer of ``lm_spec_vs_greedy``, some drafts
    accepted and some rejected.  On a mismatch, raises with the position
    and the greedy step's top-2 logit gap there.  Returns the stats."""
    import numpy as np
    import torch

    res = {}
    greedy, spec = lm_spec_vs_greedy(cfg32, params, dev, prompt, sizes,
                                     corpus_trie, torch.float32)
    greedy_calls = (1 + sizes["decode"]) / sizes["decode"]
    for name, (toks, stats) in spec.items():
        calls = (1 + stats["verify_steps"]) / sizes["decode"]
        log(f"[{label} f32] {name} proposer: proposed "
            f"{stats['proposed']}, accepted {stats['accepted']}, verify "
            f"steps {stats['verify_steps']}, model calls per token "
            f"{calls:.4f} (greedy {greedy_calls:.4f})")
        if not np.array_equal(toks, greedy):
            i = int(np.flatnonzero(toks != greedy)[0])
            gap = lm_logit_gap(cfg32, params, dev, prompt, greedy, i)
            raise AssertionError(
                f"{label}: f32 speculative ({name}) differs from greedy "
                f"at position {i}: {toks[i]} against {greedy[i]}; the "
                f"greedy step's top-2 logit gap there is {gap:.3e}")
        res[name] = stats
    ok, cut = res["continuation"], res["rejecting"]
    if ok["accepted"] == 0 or cut["accepted"] == cut["proposed"]:
        raise AssertionError(
            f"{label}: no draft accepted ({ok}) or none rejected "
            f"({cut}): the verify step or the rewind went unchecked")
    log(f"[{label} f32] speculative == greedy, {sizes['decode']} tokens "
        f"after a {sizes['prompt']}-token prompt, every proposer")
    return res


def lm_checks(cfg, params, dev, cpu_params, sizes, seed, label="lm"):
    """The phase's checks on ``params`` (f32) on ``dev``: (a) in f32,
    speculative == greedy token for token with every proposer; (b) f32
    prefill logits of ``sizes["xdev"]`` tokens on ``dev`` against the CPU
    (``cpu_params``) within LM_XDEV_TOL; then, in the config's bf16, the
    share of positions where speculative and greedy agree.  Raises on a
    failed check; returns what it measured."""
    import numpy as np
    import torch
    from repro_torch.data import NgramTrie
    from repro_torch.models import forward

    rows, stream = lm_token_stream(sizes["corpus_docs"], seed)
    corpus_trie = NgramTrie(n=4).fit(rows)
    prompt = stream[:sizes["prompt"]][None]
    cfg32 = cfg.scaled(compute_dtype="float32")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        res = lm_spec_checks(cfg32, params, dev, prompt, sizes, corpus_trie,
                             label)

        x = torch.as_tensor(stream[:sizes["xdev"]][None])
        with torch.inference_mode():
            on_dev, _, _ = forward(cfg32, params, {"tokens": x.to(dev)})
            on_cpu, _, _ = forward(cfg32, cpu_params, {"tokens": x})
        err = float((on_dev.cpu().double() - on_cpu.double()).abs().max())
        finite = bool(torch.isfinite(on_dev).all())
        log(f"[{label} xdev] f32 prefill logits of {sizes['xdev']} tokens "
            f"{tuple(on_dev.shape)}, {dev} against the CPU: max abs err "
            f"{err:.3e} (limit {LM_XDEV_TOL})")
        if not finite or not err <= LM_XDEV_TOL:
            raise AssertionError(f"{label}: {dev} and CPU logits differ by "
                                 f"{err} (finite {finite})")
        res["xdev_err"] = err
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32

    greedy, spec = lm_spec_vs_greedy(cfg, params, dev, prompt, sizes,
                                     corpus_trie, torch.bfloat16)
    res["bf16_agree"] = {
        name: float(np.mean(toks == greedy)) for name, (toks, _) in
        spec.items()}
    log(f"[{label} bf16] share of positions where speculative == greedy: "
        f"{json.dumps(res['bf16_agree'])}")
    return res


def tree_bytes(tree):
    from repro_torch.pytree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def lm_phase(args, dev, smi):
    """smollm-360m at full width and depth on the card: random f32
    weights from a generator seeded by --seed, bf16 compute and a bf16
    cache (the config's own).  The checks of ``lm_checks``, then prefill
    ms (CUDA events, median of 5) and decode ms a token and tokens/s at
    batch 1 and 8 (CUDA events over LM_TIMED_STEPS greedy steps, median
    of 3 runs), and the resident bytes of params and cache."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_cache, materialize_params
    from repro_torch.pytree import tree_leaves, tree_map
    from repro_torch.serve import make_decode_step, make_prefill_step

    t0 = time.perf_counter()
    cfg = get_config(LM_ARCH)
    params, _ = materialize_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    p_bytes = tree_bytes(params)
    c_bytes = tree_bytes(init_cache(cfg, 1, LM_SIZES["max_seq"], device=dev))
    log(f"[lm] {LM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, vocab {cfg.vocab_size}; "
        f"{n_params} params, {p_bytes} resident bytes ({cfg.param_dtype}), "
        f"bf16 cache at max_seq {LM_SIZES['max_seq']} {c_bytes} bytes; "
        f"built in {time.perf_counter() - t0:.1f} s")
    lm_checks(cfg, params, dev, cpu_params, LM_SIZES, args.seed)
    del cpu_params
    log(f"[lm] checks done in {time.perf_counter() - t0:.1f} s")

    _, stream = lm_token_stream(LM_SIZES["corpus_docs"], args.seed)
    n_prompt = LM_SIZES["prompt"]
    line = lm_timings(cfg, params, dev, stream, n_prompt, LM_SIZES["max_seq"])
    # one decode step reads every f32 weight once and writes its bf16 cast
    bound_ms = (p_bytes + p_bytes // 2) / HBM_BYTES_PER_S * 1e3
    line.update(param_bytes=p_bytes, decode_bound_ms_b1=bound_ms)
    log(f"[lm ms] {smi}: " + json.dumps(line))
    log(f"[lm] phase done in {time.perf_counter() - t0:.1f} s")


def lm_prefill_ms(cfg, params, dev, stream, n_prompt, max_seq, reps=5,
                  warmup=1):
    """Prefill ms of ``n_prompt`` tokens at batch 1 into a cache (CUDA
    events, median of ``reps`` after ``warmup`` calls)."""
    import torch
    from repro_torch.models import init_cache
    from repro_torch.serve import make_prefill_step

    prefill = make_prefill_step(cfg)
    prompt = torch.as_tensor(stream[:n_prompt][None], device=dev)
    cache = init_cache(cfg, 1, max_seq, device=dev)
    return cuda_ms(lambda: prefill(params, cache, {"tokens": prompt}), reps,
                   warmup=warmup)


def lm_decode_ms(cfg, params, dev, stream, b, n_prompt, max_seq,
                 n_dec=LM_TIMED_STEPS):
    """Decode ms a token at batch ``b`` after an ``n_prompt``-token
    prefill (CUDA events over ``n_dec`` greedy steps, median of 3 runs),
    and the cache's resident bytes."""
    import torch
    from repro_torch.models import init_cache
    from repro_torch.serve import make_decode_step, make_prefill_step

    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    rows = torch.as_tensor(stream[:b * n_prompt].reshape(b, n_prompt),
                           device=dev)
    times = []
    for _ in range(3):
        cache = init_cache(cfg, b, max_seq, device=dev)
        logits, cache = prefill(params, cache, {"tokens": rows})
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_dec):
            logits, cache = decode(params, cache, tok)
            tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n_dec)
    return statistics.median(times), tree_bytes(cache)


def lm_timings(cfg, params, dev, stream, n_prompt, max_seq,
               n_dec=LM_TIMED_STEPS):
    """Prefill ms, then decode ms a token (over ``n_dec`` steps),
    tokens/s and cache bytes at each of LM_BATCHES."""
    line = {"prefill_ms": lm_prefill_ms(cfg, params, dev, stream, n_prompt,
                                        max_seq),
            "prefill_tokens": n_prompt}
    for b in LM_BATCHES:
        ms, c_bytes = lm_decode_ms(cfg, params, dev, stream, b, n_prompt,
                                   max_seq, n_dec)
        line[f"decode_ms_b{b}"] = ms
        line[f"tokens_per_s_b{b}"] = b * 1e3 / ms
        line[f"cache_bytes_b{b}"] = c_bytes
    return line


def trace_steps(run, steps):
    """A torch.profiler trace of ``steps`` calls of ``run`` (the device
    synchronized before and after): wall ms a step (host clock around the
    traced calls, the profiler's own cost included), device-busy ms a
    step (the durations of the kernels and copies on the card), the
    device's idle share of the wall, kernel launches a step, the busy
    time's shares in copies (the weight casts and upcasts) and in GEMMs,
    and the five costliest device events by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    events = prof.events()
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    by_name = Counter()
    for e in on_card:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3 / steps
    busy = sum(by_name.values())
    gemm = sum(ms for n, ms in by_name.items()
               if any(k in n.lower()
                      for k in ("gemm", "xmma", "cutlass", "nvjet")))
    copy = sum(ms for n, ms in by_name.items() if "copy" in n.lower())
    launches = sum(1 for e in events if e.name.startswith(
        ("cudaLaunchKernel", "cuLaunchKernel"))) / steps
    return {"trace_wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall if wall > 0 else None,
            "launches_per_step": launches,
            "copy_share": copy / busy if busy else None,
            "gemm_share": gemm / busy if busy else None,
            "top": [[n[:80], ms] for n, ms in by_name.most_common(5)]}


def lm_decode_trace(cfg, params, dev, stream, n_prompt, max_seq, steps=3):
    """``trace_steps`` of ``steps`` greedy decode steps at batch 1 after
    an ``n_prompt``-token prefill."""
    import torch
    from repro_torch.models import init_cache
    from repro_torch.serve import make_decode_step, make_prefill_step

    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    prompt = torch.as_tensor(stream[:n_prompt][None], device=dev)
    cache = init_cache(cfg, 1, max_seq, device=dev)
    logits, cache = prefill(params, cache, {"tokens": prompt})
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    logits, cache = decode(params, cache, tok)
    state = {"cache": cache, "tok": tok}

    def run():
        logits, state["cache"] = decode(params, state["cache"], state["tok"])
        state["tok"] = torch.argmax(logits[:, -1], -1)[:, None].to(
            torch.int32)

    return trace_steps(run, steps)


# the DeepSeek phase: DeepSeek-V2-Lite-16B (MLA + MoE) at full width and
# depth
DS_ARCH = "deepseek-v2-lite-16b"
DS_SIZES = dict(prompt=512,   # the chunked absorbed prefill
                decode=32, max_seq=1024, xdev=64, corpus_docs=200,
                moe_tokens=512)
DS_EPS = (1, 4)               # expert slices of the dispatch path
DS_MOE_TOL = dict(rtol=2e-2, atol=2e-3)   # tests/test_distributed.py:92-120
DS_AUX_RTOL = 1e-4
DS_ABSORBED_TOL = 1e-3        # expanded against absorbed, f32 logits
DS_EP_RTOL = 1e-5             # ep = 1 against ep = 4 in f32, of max |y|


def model_mesh(ep):
    """A mesh of one ``model`` axis of extent ``ep`` (what the MoE reads
    of a mesh)."""
    import types

    return types.SimpleNamespace(shape={"model": ep})


def ds_slice(cfg, params):
    """The full-width two-layer slice: the prefix layer and unit 0, with
    the embedding and the head (views of ``params``)."""
    from repro_torch.pytree import tree_map

    sub = dict(params, units=tree_map(lambda t: t[:1], params["units"]))
    return cfg.scaled(n_units=1), sub


def ds_moe_checks(cfg, params, dev, n_tokens, seed, label):
    """(d) the MoE of unit 0 on ``n_tokens`` tokens under a mesh
    {"model": ep}: at capacity_factor 8 (no drops) the dispatch path ==
    ``moe_dense`` within the reference test's tolerance at every ep of
    DS_EPS (the config's compute dtype); at capacity_factor 0.1 (drops)
    finite, and ep = 1 == the largest ep within f32 rounding (f32
    compute)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.models.moe import (
        _capacity, _router, moe_alltoall, moe_dense,
    )
    from repro_torch.pytree import tree_map

    p_moe = tree_map(lambda t: t[0], params["units"]["0"]["ffn"])
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.randn((1, n_tokens, cfg.d_model), generator=gen,
                    device=dev) * 0.3

    def run(c, ep):
        with use_mesh(model_mesh(ep)), torch.inference_mode():
            return moe_alltoall(c, p_moe, x)

    res = {}
    wide = cfg.scaled(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    with torch.inference_mode():
        y_dense, aux_dense = moe_dense(wide, p_moe, x)
    for ep in DS_EPS:
        y, aux = run(wide, ep)
        err = float((y.double() - y_dense.double()).abs().max())
        aux_err = abs(float(aux) - float(aux_dense)) / abs(float(aux_dense))
        close = torch.allclose(y.double(), y_dense.double(), **DS_MOE_TOL)
        log(f"[{label} moe] dispatch ep={ep} capacity_factor 8 "
            f"({_capacity(n_tokens, wide)} slots an expert) against dense, "
            f"{n_tokens} tokens: max abs err {err:.3e}, aux rel err "
            f"{aux_err:.3e} (rtol {DS_MOE_TOL['rtol']}, atol "
            f"{DS_MOE_TOL['atol']}; aux rtol {DS_AUX_RTOL})")
        if not close or not aux_err <= DS_AUX_RTOL:
            raise AssertionError(f"{label}: dispatch at ep={ep} differs from "
                                 f"dense by {err}, aux by {aux_err}")
        res[f"ep{ep}_err"] = err
    tight = cfg.scaled(compute_dtype="float32", moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.1))
    ys = {ep: run(tight, ep) for ep in DS_EPS}
    with torch.inference_mode():
        _, top_i, _ = _router(tight, p_moe, x.reshape(-1, cfg.d_model))
    cap = _capacity(n_tokens, tight)
    counts = np.bincount(top_i.reshape(-1).cpu().numpy(),
                         minlength=cfg.moe.n_routed)
    dropped = int(np.maximum(counts - cap, 0).sum())
    lo, hi = DS_EPS[0], DS_EPS[-1]
    # the largest |y(ep=hi) - y(ep=lo)| over the largest |y(ep=lo)|
    ep_err = float((ys[hi][0].double() - ys[lo][0].double()).abs().max()
                   / ys[lo][0].double().abs().max())
    finite = all(bool(torch.isfinite(y).all()) for y, _ in ys.values())
    log(f"[{label} moe] capacity_factor 0.1 ({cap} slots an expert, "
        f"{dropped} of {top_i.numel()} token copies dropped), f32: finite "
        f"{finite}, ep={hi} against ep={lo} max err {ep_err:.3e} of max |y| "
        f"(limit {DS_EP_RTOL}), aux {float(ys[hi][1]):.6f} / "
        f"{float(ys[lo][1]):.6f}")
    if not finite or not ep_err <= DS_EP_RTOL or dropped == 0:
        raise AssertionError(f"{label}: capacity_factor 0.1: finite {finite}, "
                             f"ep error {ep_err}, {dropped} dropped")
    res.update(ep_err=ep_err, dropped=dropped)
    return res


def ds_checks(cfg, params, dev, sizes, seed, label="deepseek"):
    """The DeepSeek phase's checks on ``params`` (f32) on ``dev``, TF32
    off: (a) in f32, speculative == greedy with every proposer after a
    ``sizes["prompt"]``-token prompt; (b) the two-layer slice's f32
    prefill logits of ``sizes["xdev"]`` tokens and its aux loss on
    ``dev`` against a CPU copy of the slice; (c) on the slice, logits
    without a cache (the expanded form) against a prefill into a cache
    (the absorbed form) within DS_ABSORBED_TOL; (d) ``ds_moe_checks``.
    Raises on a failed check; returns what it measured."""
    import torch
    from repro_torch.data import NgramTrie
    from repro_torch.models import forward, init_cache
    from repro_torch.pytree import tree_leaves, tree_map

    rows, stream = lm_token_stream(sizes["corpus_docs"], seed)
    prompt = stream[:sizes["prompt"]][None]
    cfg32 = cfg.scaled(compute_dtype="float32")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        res = lm_spec_checks(cfg32, params, dev, prompt, sizes,
                             NgramTrie(n=4).fit(rows), label)

        scfg, sparams = ds_slice(cfg32, params)
        cpu_sparams = tree_map(lambda t: t.cpu(), sparams)
        x = torch.as_tensor(stream[:sizes["xdev"]][None])
        with torch.inference_mode():
            on_dev, e_dev, _ = forward(scfg, sparams, {"tokens": x.to(dev)})
            on_cpu, e_cpu, _ = forward(scfg, cpu_sparams, {"tokens": x})
        del cpu_sparams
        err = float((on_dev.cpu().double() - on_cpu.double()).abs().max())
        aux_d, aux_c = float(e_dev["aux_loss"]), float(e_cpu["aux_loss"])
        aux_err = abs(aux_d - aux_c) / abs(aux_c)
        finite = bool(torch.isfinite(on_dev).all())
        log(f"[{label} xdev] two-layer slice ({scfg.n_layers} layers, "
            f"{sum(t.numel() for t in tree_leaves(sparams))} params), f32 "
            f"prefill logits of {sizes['xdev']} tokens {tuple(on_dev.shape)},"
            f" {dev} against the CPU: max abs err {err:.3e} (limit "
            f"{LM_XDEV_TOL}); aux loss {aux_d:.6f} against {aux_c:.6f}, rel "
            f"err {aux_err:.3e} (limit {DS_AUX_RTOL})")
        if not finite or not err <= LM_XDEV_TOL or \
                not aux_err <= DS_AUX_RTOL:
            raise AssertionError(f"{label}: {dev} and CPU differ: logits by "
                                 f"{err} (finite {finite}), aux by {aux_err}")
        res["xdev_err"], res["aux_err"] = err, aux_err

        full = torch.as_tensor(prompt, device=dev)
        with torch.inference_mode():
            expanded, _, _ = forward(scfg, sparams, {"tokens": full})
            absorbed, _, cache = forward(
                scfg, sparams, {"tokens": full}, cache=init_cache(
                    scfg, 1, sizes["max_seq"], torch.float32, dev))
        err = float((expanded.double() - absorbed.double()).abs().max())
        log(f"[{label} absorbed] two-layer slice, {full.shape[1]}-token f32 "
            f"prefill: expanded (no cache) against absorbed (into a cache) "
            f"max abs err {err:.3e} (limit {DS_ABSORBED_TOL}); cache pos "
            f"{cache['units']['0']['pos'].tolist()}")
        if not err <= DS_ABSORBED_TOL:
            raise AssertionError(f"{label}: expanded and absorbed logits "
                                 f"differ by {err}")
        res["absorbed_err"] = err
        res.update(ds_moe_checks(cfg, params, dev, sizes["moe_tokens"], seed,
                                 label))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return res


def ds_phase(args, dev, smi):
    """DeepSeek-V2-Lite-16B at full width and depth on the card: random
    f32 weights drawn on the card from a generator seeded by --seed, the
    config's bf16 compute and cache, no mesh (the MoE's one-device dense
    path).  The checks of ``ds_checks``; then prefill ms of 512 tokens on
    the dense path and on the dispatch path at ep = 1, decode ms a token
    and tokens/s at batch 1 and 8 (and at batch 1 on the dispatch path),
    the resident bytes of params and cache, the decode bound, and a
    profiler trace of three decode steps (``lm_decode_trace``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.models import init_cache, materialize_params
    from repro_torch.pytree import tree_leaves

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    log(f"[deepseek] before the weights: {torch.cuda.memory_allocated()} "
        f"bytes allocated, {torch.cuda.memory_reserved()} reserved")
    cfg = get_config(DS_ARCH)
    params, _ = materialize_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    p_bytes = tree_bytes(params)
    cache = init_cache(cfg, 1, DS_SIZES["max_seq"], device=dev)
    c_bytes = tree_bytes(cache)
    pos_bytes = sum(t.numel() * t.element_size()
                    for t in tree_leaves(cache) if t.dtype == torch.int32)
    del cache
    m, mo = cfg.mla, cfg.moe
    log(f"[deepseek] {DS_ARCH}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads, MLA kv_lora {m.kv_lora_rank}, "
        f"{mo.n_routed} routed experts top-{mo.top_k} + {mo.n_shared} "
        f"shared, vocab {cfg.vocab_size}; {n_params} params, {p_bytes} "
        f"resident bytes ({cfg.param_dtype}), bf16 cache at max_seq "
        f"{DS_SIZES['max_seq']} {c_bytes} bytes ({pos_bytes} of them pos); "
        f"peak {torch.cuda.max_memory_allocated()} bytes; built in "
        f"{time.perf_counter() - t0:.1f} s")
    res = ds_checks(cfg, params, dev, DS_SIZES, args.seed)
    log(f"[deepseek] checks done in {time.perf_counter() - t0:.1f} s")

    _, stream = lm_token_stream(DS_SIZES["corpus_docs"], args.seed)
    n_prompt, max_seq = DS_SIZES["prompt"], DS_SIZES["max_seq"]
    line = lm_timings(cfg, params, dev, stream, n_prompt, max_seq)
    with use_mesh(model_mesh(1)):
        line["dispatch_prefill_ms"] = lm_prefill_ms(
            cfg, params, dev, stream, n_prompt, max_seq)
        line["dispatch_decode_ms_b1"] = lm_decode_ms(
            cfg, params, dev, stream, 1, n_prompt, max_seq)[0]
    # the dense path's decode step reads every f32 weight once and writes
    # its bf16 cast
    bound_ms = (p_bytes + p_bytes // 2) / HBM_BYTES_PER_S * 1e3
    line.update(param_bytes=p_bytes, decode_bound_ms_b1=bound_ms,
                peak_bytes=torch.cuda.max_memory_allocated(),
                xdev_err=res["xdev_err"], absorbed_err=res["absorbed_err"])
    log(f"[deepseek ms] {smi}: " + json.dumps(line))
    log(f"[deepseek trace] {smi}: 3 decode steps at batch 1, dense path: "
        + json.dumps(lm_decode_trace(cfg, params, dev, stream, n_prompt,
                                     max_seq)))
    log(f"[deepseek] phase done in {time.perf_counter() - t0:.1f} s")
    return params


# the mesh phase: the placed LM paths (DTensors on a process mesh) on a
# one-rank NCCL world in this process, against the plain paths
MESH_SIZES = dict(prompt=512, decode=64, max_seq=1024, batch=8, seq=256,
                  timed=16, ds_decode=32, mamba_batch=4, v3_tokens=128)
MESH_TOL = 1e-5               # placed against plain, where not bitwise
V3_ARCH = "deepseek-v3-671b"
# the leaves (e) takes gradients for: the MTP head and what it reads
MESH_V3_TRAINED = ("mtp", "embed", "lm_head")


def mesh_world(dev):
    """A one-rank NCCL world in this process (an in-process HashStore: no
    port) and ``make_host_mesh()`` over it: the 1 x 1 ``("data",
    "model")`` process mesh on ``dev``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    mesh = make_host_mesh()
    if mesh.shape != {"data": 1, "model": 1} or mesh.device != dev:
        raise AssertionError(f"mesh: make_host_mesh() gave {mesh} on "
                             f"{mesh.device}")
    return mesh


def under(mesh):
    """``use_mesh(mesh)``, or no mesh for ``None``."""
    from repro_torch.distributed.sharding import use_mesh

    return contextlib.nullcontext() if mesh is None else use_mesh(mesh)


def whole(x):
    from repro_torch.distributed.sharding import is_placed

    return x.full_tensor() if is_placed(x) else x


def held(what, got, want, tol=MESH_TOL, scale=None):
    """``got`` (placed or not) against ``want``: bitwise, or the first
    differing index printed and the max difference within ``tol`` (of
    ``scale`` when given).  Returns the max abs difference."""
    import torch

    got = whole(got).detach()
    if torch.equal(got, want):
        return 0.0
    diff = (got.double() - want.double()).abs()
    err = float(diff.max())
    first = [int(i) for i in (diff > 0).nonzero()[0].tolist()]
    limit = tol * (scale if scale is not None else 1.0)
    log(f"[mesh] {what}: not bitwise, first gap at {first}: "
        f"{float(got[tuple(first)])} against {float(want[tuple(first)])}; "
        f"max abs err {err:.3e} (limit {limit:.3e})")
    if not err <= limit:
        raise AssertionError(f"mesh: {what} differs by {err}")
    return err


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms inside the block: the MoE dispatch's
    scatter-add (``index_add_``) sums in a fixed order on the card, not
    by atomics, so two runs of it can agree bitwise."""
    import torch

    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def mesh_greedy(cfg, plain, placed, mesh, dev, rows, n, label, plain_mesh):
    """Prefill logits and ``n`` greedy tokens of ``rows`` (batch, prompt),
    plain (under ``plain_mesh``) and placed (params and cache placed by
    ``remesh_state``; under ``mesh``): tokens equal, logits bitwise or
    within MESH_TOL.  Returns the logits' max abs err."""
    import torch
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.models import cache_axes, cache_position, init_cache
    from repro_torch.serve import make_prefill_step
    from repro_torch.serve.engine import greedy_generate
    from repro_torch.train.elastic import remesh_state

    b, max_seq = rows.shape[0], MESH_SIZES["max_seq"]
    prefill = make_prefill_step(cfg)
    prompt = torch.as_tensor(rows, device=dev)
    with under(plain_mesh):
        want, _ = prefill(plain, init_cache(cfg, b, max_seq, device=dev),
                          {"tokens": prompt})
        toks, _ = greedy_generate(cfg, plain, init_cache(
            cfg, b, max_seq, device=dev), rows, n)
    with use_mesh(mesh):
        cache = remesh_state(init_cache(cfg, b, max_seq, device=dev),
                             cache_axes(cfg), mesh)
        got, _ = prefill(placed, cache, {"tokens": prompt})
        cache = remesh_state(init_cache(cfg, b, max_seq, device=dev),
                             cache_axes(cfg), mesh)
        gtoks, cache = greedy_generate(cfg, placed, cache, rows, n)
    err = held(f"{label} prefill logits, batch {b}", got, want)
    gtoks = whole(gtoks)
    if not torch.equal(gtoks, toks):
        i = int((gtoks != toks).nonzero()[0][1])
        raise AssertionError(f"mesh: {label} batch {b}: placed tokens "
                             f"differ from plain at step {i}")
    pos = int(whole(cache_position(cache)))
    # a pure-SSM cache counts no position: it reads 0
    want_pos = 0 if all(sp.mixer == "mamba" for sp in cfg.layer_specs()) \
        else rows.shape[1] + n
    log(f"[mesh {label}] batch {b}: prefill of {rows.shape[1]} tokens, "
        f"logits max abs err {err:.3e} placed against plain; {n} greedy "
        f"tokens equal; placed cache pos {pos}")
    if pos != want_pos:
        raise AssertionError(f"mesh: {label} cache pos {pos}")
    return err


def in_turns(sides, run, rounds=4):
    """``run(side)`` (ms) for each of ``sides`` in turns, the order
    reversed every round (plain, placed, placed, plain, ...); the median
    of each side's rounds, by name."""
    times = {name: [] for name, *_ in sides}
    for r in range(rounds):
        for side in (sides if r % 2 == 0 else sides[::-1]):
            times[side[0]].append(run(side))
    return {name: statistics.median(t) for name, t in times.items()}


def mesh_decode_ms(cfg, sides, dev, rows, rounds=4):
    """Decode ms a token at ``rows``' batch after its prefill (CUDA
    events over MESH_SIZES["timed"] greedy steps) for each side (name,
    params, mesh or None, whether the cache is placed), in turns over
    ``rounds`` rounds."""
    import torch
    from repro_torch.models import cache_axes, init_cache
    from repro_torch.serve import make_decode_step, make_prefill_step
    from repro_torch.serve.engine import _next_token
    from repro_torch.train.elastic import remesh_state

    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    prompt = torch.as_tensor(rows, device=dev)
    n = MESH_SIZES["timed"]

    def run(side):
        _, params, mesh, place = side
        with under(mesh):
            cache = init_cache(cfg, rows.shape[0], MESH_SIZES["max_seq"],
                               device=dev)
            if place:
                cache = remesh_state(cache, cache_axes(cfg), mesh)
            logits, cache = prefill(params, cache, {"tokens": prompt})
            tok = _next_token(logits)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                logits, cache = decode(params, cache, tok)
                tok = _next_token(logits)
            end.record()
            end.synchronize()
        return start.elapsed_time(end) / n

    return in_turns(sides, run, rounds)


def mesh_train(cfg, plain, placed, mesh, dev, label, batch_size=None,
               seq=None, timed=True):
    """One pipeline batch (MESH_SIZES' 8 x 256 unless named):
    ``loss_and_grads`` placed against plain (loss and each gradient leaf
    bitwise, or within MESH_TOL of its max |grad|), then, when
    ``timed``, AdamW step ms of each (CUDA events, in turns: one warm-up
    step each, then the median of 4)."""
    import torch
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.pytree import tree_leaves, tree_leaves_with_path
    from repro_torch.train.optimizer import AdamW, OptConfig
    from repro_torch.train.train_step import loss_and_grads, make_train_step

    batch_size = batch_size or MESH_SIZES["batch"]
    seq = seq or MESH_SIZES["seq"]
    batch = on_device(train_pipeline(seq, batch_size).batch_at(0), dev)
    loss, _, grads = loss_and_grads(cfg, plain, batch)
    with use_mesh(mesh):
        ploss, _, pgrads = loss_and_grads(cfg, placed, batch)
    out = {"loss_err": held(f"{label} loss", ploss, loss)}
    worst = 0.0
    for (path, g), w in zip(tree_leaves_with_path(pgrads),
                            tree_leaves(grads)):
        peak = float(w.abs().max()) or 1.0
        worst = max(worst, held(f"{label} grad {'/'.join(map(str, path))}",
                                g, w, scale=peak) / peak)
    out["grad_rel_err"] = worst
    del grads, pgrads
    log(f"[mesh {label}] train batch {batch_size} x {seq}: loss "
        f"{float(loss):.6f}, placed against plain: loss err "
        f"{out['loss_err']:.3e}, worst gradient leaf {worst:.3e} of its "
        f"max |grad|")
    if not timed:
        return out
    opt = AdamW(OptConfig())
    step = make_train_step(cfg, opt)
    state = {"plain": [plain, None, 0], "placed": [placed, mesh, 0]}
    for name, st in state.items():
        st.append(opt.init(st[0]))

    def run(side):
        params, m, i, opt_state = state[side[0]]
        with under(m):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            params, opt_state, _ = step(params, opt_state, batch, float(i))
            end.record()
            end.synchronize()
        state[side[0]] = [params, m, i + 1, opt_state]
        return start.elapsed_time(end)

    sides = [("plain",), ("placed",)]
    in_turns(sides, run, rounds=2)              # one warm-up step each
    for name, ms in in_turns(sides, run).items():
        out[f"{name}_step_ms"] = ms
    del state
    return out


def mesh_lm(args, dev, smi, mesh):
    """(a) smollm-360m at full width and depth, params placed as DTensors
    by ``remesh_state`` on the one-rank mesh (no copy: each block is the
    whole leaf): ``mesh_greedy`` at batch 1 and 8, ``mesh_train``, and
    decode ms a token placed against plain, in turns."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import materialize_params
    from repro_torch.pytree import tree_leaves
    from repro_torch.train.elastic import remesh_state

    cfg = get_config(LM_ARCH)
    plain, axes = materialize_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    placed = remesh_state(plain, axes, mesh)
    placed_without_copy(LM_ARCH, plain, placed)
    log(f"[mesh lm] {LM_ARCH}: {len(tree_leaves(placed))} leaves placed on "
        f"{mesh}; blocks share the plain leaves' memory")
    _, stream = lm_token_stream(LM_SIZES["corpus_docs"], args.seed)
    n_prompt = MESH_SIZES["prompt"]
    line = {}
    for b in LM_BATCHES:
        rows = stream[:b * n_prompt].reshape(b, n_prompt)
        line[f"logits_err_b{b}"] = mesh_greedy(
            cfg, plain, placed, mesh, dev, rows, MESH_SIZES["decode"], "lm",
            None)
        ms = mesh_decode_ms(cfg, [("plain", plain, None, False),
                                  ("placed", placed, mesh, True)], dev, rows)
        line[f"decode_ms_b{b}"] = ms["plain"]
        line[f"placed_decode_ms_b{b}"] = ms["placed"]
    line.update(mesh_train(cfg, plain, placed, mesh, dev, "lm"))
    log(f"[mesh lm ms] {smi}: " + json.dumps(line))
    return line


def mesh_ds(args, dev, smi, mesh, params):
    """(b) DeepSeek-V2-Lite-16B at full width and depth (``params``: f32
    on the card, placed by ``remesh_state`` without a copy), its MoE
    through ``moe_alltoall``'s process-group path on the mesh, against
    the one-process dispatch path at ep = 1 (``[deepseek]``'s
    ``model_mesh(1)``): prefill logits and MESH_SIZES["ds_decode"]
    greedy tokens after a 512-token prompt at batch 1, both under
    ``deterministic()`` (the dispatch's scatter-add by atomics is not
    reproducible run to run, and one flipped routing choice moves the
    logits by whole units), then decode ms a token of each as it runs
    (atomics)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import abstract_params
    from repro_torch.train.elastic import remesh_state

    cfg = get_config(DS_ARCH)
    before = torch.cuda.memory_allocated()
    placed = remesh_state(params, abstract_params(cfg)[1], mesh)
    added = torch.cuda.memory_allocated() - before
    log(f"[mesh deepseek] {DS_ARCH} placed on {mesh}: {added} bytes "
        f"allocated by the placement")
    if added > 1 << 20:
        raise AssertionError(f"mesh: placing DeepSeek copied {added} bytes")
    _, stream = lm_token_stream(DS_SIZES["corpus_docs"], args.seed)
    rows = stream[:DS_SIZES["prompt"]][None]
    with deterministic():
        line = {"logits_err_b1": mesh_greedy(
            cfg, params, placed, mesh, dev, rows, MESH_SIZES["ds_decode"],
            "deepseek", model_mesh(1))}
    ms = mesh_decode_ms(cfg, [("dispatch", params, model_mesh(1), False),
                              ("placed", placed, mesh, True)], dev, rows)
    line["dispatch_decode_ms_b1"] = ms["dispatch"]
    line["placed_decode_ms_b1"] = ms["placed"]
    log(f"[mesh deepseek ms] {smi}: " + json.dumps(line))
    return line


def placed_without_copy(what, plain, placed):
    """Every placed leaf's block shares its plain leaf's memory (on the
    1 x 1 mesh a block is the whole leaf)."""
    from repro_torch.pytree import tree_leaves

    shared = all(p.to_local().data_ptr() == q.data_ptr()
                 for p, q in zip(tree_leaves(placed), tree_leaves(plain)))
    if not shared:
        raise AssertionError(f"mesh: remesh_state copied a leaf of {what}")


def mesh_mamba(args, dev, smi, mesh):
    """(c) mamba2-370m at full width and depth, f32 weights drawn on the
    card from --seed and placed by ``remesh_state`` without a copy: a
    512-token prefill (the chunked SSD into the cache) and 64 greedy
    tokens (the recurrence, one step a token) at batch 1 and 8 into a
    placed bf16 cache, ``mesh_greedy``; decode ms a token placed beside
    plain, in turns (two rounds); a 4 x 256 ``loss_and_grads`` (each
    unit under remat, the chunked SSD's backward) placed against
    plain."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import materialize_params
    from repro_torch.pytree import tree_leaves
    from repro_torch.train.elastic import remesh_state

    cfg = get_config(MAMBA_ARCH)
    plain, axes = materialize_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    placed = remesh_state(plain, axes, mesh)
    placed_without_copy(MAMBA_ARCH, plain, placed)
    log(f"[mesh mamba] {MAMBA_ARCH}: {cfg.n_layers} layers, "
        f"{len(tree_leaves(placed))} leaves placed on {mesh} without a "
        f"copy; remat {cfg.remat}")
    _, stream = lm_token_stream(MAMBA_SIZES["corpus_docs"], args.seed)
    n_prompt = MESH_SIZES["prompt"]
    line = {}
    for b in LM_BATCHES:
        rows = stream[:b * n_prompt].reshape(b, n_prompt)
        line[f"logits_err_b{b}"] = mesh_greedy(
            cfg, plain, placed, mesh, dev, rows, MESH_SIZES["decode"],
            "mamba", None)
        ms = mesh_decode_ms(cfg, [("plain", plain, None, False),
                                  ("placed", placed, mesh, True)], dev,
                            rows, rounds=2)
        line[f"decode_ms_b{b}"] = ms["plain"]
        line[f"placed_decode_ms_b{b}"] = ms["placed"]
    line.update(mesh_train(cfg, plain, placed, mesh, dev, "mamba",
                           MESH_SIZES["mamba_batch"], MESH_SIZES["seq"],
                           timed=False))
    log(f"[mesh mamba ms] {smi}: " + json.dumps(line))
    return line


def mesh_jamba(args, dev, mesh):
    """(d) Jamba's reduced hybrid unit (attention, 7 Mamba2 layers, the
    dense MoE on odd layers) in f32 on the card, weights drawn from
    --seed, placed against plain, params and cache: the logits of a
    JAMBA_STEPS[0]-token prefill (the chunked SSD) and of decode steps of
    the rest (the recurrence), bitwise or within MESH_TOL; the prefill's
    aux loss and the cache's ``pos`` equal."""
    import numpy as np
    import torch
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import (
        cache_axes, cache_position, forward, init_cache, materialize_params,
    )
    from repro_torch.train.elastic import remesh_state

    cfg = get_reduced_config(JAMBA_ARCH).scaled(compute_dtype="float32")
    plain, axes = materialize_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    placed = remesh_state(plain, axes, mesh)
    toks = torch.as_tensor(np.random.RandomState(args.seed).randint(
        0, cfg.vocab_size, (2, sum(JAMBA_STEPS))), dtype=torch.int32,
        device=dev)
    out = {}
    for side, params, m in (("plain", plain, None), ("placed", placed,
                                                     mesh)):
        with under(m), torch.inference_mode():
            cache = init_cache(cfg, 2, 64, torch.float32, dev)
            if m is not None:
                cache = remesh_state(cache, cache_axes(cfg), m)
            logits, aux, lo = [], None, 0
            for n in JAMBA_STEPS:
                lg, ex, cache = forward(cfg, params, {
                    "tokens": toks[:, lo:lo + n]}, cache=cache)
                logits.append(lg)
                aux = ex["aux_loss"] if aux is None else aux
                lo += n
            out[side] = (logits, aux, int(whole(cache_position(cache))))
    errs = [held(f"jamba logits, a step of {n} tokens", g, w)
            for n, g, w in zip(JAMBA_STEPS, out["placed"][0],
                               out["plain"][0])]
    aux_err = held("jamba aux loss", out["placed"][1], out["plain"][1],
                   tol=0.0)
    pos = (out["placed"][2], out["plain"][2])
    log(f"[mesh jamba] reduced {JAMBA_ARCH} ({cfg.n_layers} layers: "
        f"{[sp.mixer + '+' + sp.ffn for sp in cfg.unit]}), f32, placed "
        f"against plain: logits max abs err {['%.3e' % e for e in errs]} "
        f"over steps of {list(JAMBA_STEPS)} tokens; aux loss "
        f"{float(out['plain'][1]):.6f}, err {aux_err:.3e}; pos {pos}")
    if pos[0] != pos[1] or pos[0] != sum(JAMBA_STEPS):
        raise AssertionError(f"mesh: jamba pos {pos}")
    return {"jamba_logits_err": max(errs)}


def head_grads(cfg, params, batch):
    """``loss_fn`` and its gradients with respect to the leaves under
    MESH_V3_TRAINED only (the rest frozen): (loss, metrics, [(path,
    grad)])."""
    import torch
    from repro_torch.models import loss_fn
    from repro_torch.pytree import tree_leaves_with_path, tree_unflatten

    leaves, trained = [], []
    for path, p in tree_leaves_with_path(params):
        p = p.detach()
        if path[0] in MESH_V3_TRAINED:
            trained.append((path, p.requires_grad_(True)))
        leaves.append(p)
    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, [p for _, p in trained])
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            [(path, g) for (path, _), g in zip(trained, grads)])


def mesh_v3(args, dev, smi, mesh):
    """(e) DeepSeek-V3 at full width (d_model 7168, 128 heads, vocab
    129,280, bf16 params, MLA, 256 routed experts top-8 + 1 shared, the
    MTP head), its depth cut to the 3 dense prefix layers and one MoE
    unit, weights drawn on the card from --seed and placed without a
    copy: ``loss_fn`` with the MTP loss on 1 x MESH_SIZES["v3_tokens"]
    tokens and its gradients for the MTP head, ``embed`` and ``lm_head``
    (the rest frozen), placed against the one-process dispatch path at
    ep = 1, both under ``deterministic()``: ``lm_loss``, ``mtp_loss`` and
    the total bitwise, each gradient leaf bitwise or within MESH_TOL of
    its max.  Bytes and seconds printed."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import materialize_params
    from repro_torch.pytree import tree_leaves
    from repro_torch.train.elastic import remesh_state

    t0 = time.perf_counter()
    cfg = get_config(V3_ARCH).scaled(n_units=1)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    plain, axes = materialize_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    placed = remesh_state(plain, axes, mesh)
    placed_without_copy(V3_ARCH, plain, placed)
    n_params = sum(t.numel() for t in tree_leaves(plain))
    p_bytes = tree_bytes(plain)
    t_init = time.perf_counter() - t0
    _, stream = lm_token_stream(LM_SIZES["corpus_docs"], args.seed)
    n = MESH_SIZES["v3_tokens"]
    toks = torch.as_tensor(stream[:n + 1], device=dev)
    batch = {"tokens": toks[None, :n], "labels": toks[None, 1:]}
    runs = {}
    for side, params, m in (("plain", plain, model_mesh(1)),
                            ("placed", placed, mesh)):
        t1 = time.perf_counter()
        with under(m), deterministic():
            runs[side] = head_grads(cfg, params, batch)
        torch.cuda.synchronize()
        runs[side] += (time.perf_counter() - t1,)
    (ploss, pm, pg, p_s), (loss, wm, g, s_) = runs["placed"], runs["plain"]
    held("v3 total loss", ploss, loss, tol=0.0)
    for k in ("lm_loss", "mtp_loss"):
        held(f"v3 {k}", pm[k], wm[k], tol=0.0)
    worst, g_bytes = 0.0, 0
    for (path, a), (_, w) in zip(pg, g):
        peak = float(w.float().abs().max()) or 1.0
        worst = max(worst, held(f"v3 grad {'/'.join(map(str, path))}", a,
                                w, scale=peak) / peak)
        g_bytes += w.numel() * w.element_size()
    line = {"params": n_params, "param_bytes": p_bytes,
            "grad_leaves": len(g), "grad_bytes_a_side": g_bytes,
            "peak_bytes": torch.cuda.max_memory_allocated(dev) - base,
            "lm_loss": float(wm["lm_loss"]),
            "mtp_loss": float(wm["mtp_loss"]),
            "loss": float(loss), "worst_grad_rel_err": worst,
            "init_s": t_init, "plain_s": s_, "placed_s": p_s}
    del runs, pg, g, placed, plain
    torch.cuda.empty_cache()
    log(f"[mesh v3] {smi}: {V3_ARCH} at full width, {len(cfg.prefix)} "
        f"dense layers + {cfg.n_units} MoE unit + the MTP head, "
        f"{cfg.param_dtype} params, 1 x {n} tokens, gradients of "
        f"{'/'.join(MESH_V3_TRAINED)}; placed against plain: losses "
        f"bitwise, worst gradient leaf {worst:.3e} of its max: "
        + json.dumps(line))
    return line


def mesh_phase(args, dev, smi, ds_held=None):
    """The ``[mesh]`` phase's one-rank NCCL world in this process:
    ``mesh_ds`` on the DeepSeek phase's weights (``ds_held``: a list
    holding them, emptied here so that they are freed before smollm's
    train step needs the card; else weights drawn here), then
    ``mesh_lm``, ``mesh_mamba``, ``mesh_jamba`` and ``mesh_v3``, each
    part's seconds printed; the world torn down after."""
    import torch
    import torch.distributed as dist

    t0 = time.perf_counter()
    secs = {}

    def lap(name, since=[t0]):
        now = time.perf_counter()
        secs[name] = now - since[0]
        since[0] = now
        torch.cuda.empty_cache()

    mesh = mesh_world(dev)
    try:
        if ds_held:
            params = ds_held.pop()
        else:
            from repro_torch.configs import get_config
            from repro_torch.models import materialize_params

            torch.cuda.empty_cache()
            params, _ = materialize_params(
                get_config(DS_ARCH),
                torch.Generator(device=dev).manual_seed(args.seed), dev)
        mesh_ds(args, dev, smi, mesh, params)
        del params
        lap(DS_ARCH)
        mesh_lm(args, dev, smi, mesh)
        lap(LM_ARCH)
        mesh_mamba(args, dev, smi, mesh)
        lap(MAMBA_ARCH)
        mesh_jamba(args, dev, mesh)
        lap(JAMBA_ARCH)
        mesh_v3(args, dev, smi, mesh)
        lap(V3_ARCH)
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    log(f"[mesh] phase done in {time.perf_counter() - t0:.1f} s: "
        + json.dumps(secs))


# the Mamba phase: mamba2-370m (SSD) at full width and depth, then
# Jamba's hybrid unit at its reduced widths
MAMBA_ARCH = "mamba2-370m"
JAMBA_ARCH = "jamba-1.5-large-398b"
MAMBA_SIZES = dict(prompt=512,   # the chunked prefill: 2 chunks of 256
                   decode=64, max_seq=1024, xdev=64,
                   state=256,    # (b): one full chunk, against 256 steps
                   recurrent=255,  # a prompt off the chunk: the recurrence
                   corpus_docs=200)
# chunked vs recurrent state, of max |state|: in the first MAMBA_SHALLOW
# layers, and in all of them (f32 rounding of the reference's SSD grows
# with depth through the random-weight stack: float64 puts the two
# branches together, tests/test_torch_mamba.py::test_ssd_duality_float64)
MAMBA_STATE_RTOL = 1e-4
MAMBA_SHALLOW = 4
MAMBA_DEEP_RTOL = 1e-3
JAMBA_AUX_RTOL = 1e-6         # card vs CPU aux loss, f32
JAMBA_STEPS = (16, 5, 1)      # prefill (chunked), then two decode steps


def mamba_xdev(cfg32, params, cpu_params, dev, x, label):
    """(a) f32 prefill logits of ``x`` (no cache) on ``dev`` against the
    CPU copy within LM_XDEV_TOL."""
    import torch
    from repro_torch.models import forward

    with torch.inference_mode():
        on_dev, _, _ = forward(cfg32, params, {"tokens": x.to(dev)})
        on_cpu, _, _ = forward(cfg32, cpu_params, {"tokens": x})
    err = float((on_dev.cpu().double() - on_cpu.double()).abs().max())
    finite = bool(torch.isfinite(on_dev).all())
    log(f"[{label} xdev] f32 prefill logits of {x.shape[1]} tokens "
        f"{tuple(on_dev.shape)}, {dev} against the CPU: max abs err "
        f"{err:.3e} (limit {LM_XDEV_TOL})")
    if not finite or not err <= LM_XDEV_TOL:
        raise AssertionError(f"{label}: {dev} and CPU logits differ by "
                             f"{err} (finite {finite})")
    return err


def mamba_duality(cfg32, params, cpu_params, dev, x, max_seq, label):
    """(b) In f32 (cache too): ``x`` [1, n] as one chunked prefill into an
    empty cache (n a multiple of the chunk) against n one-token decode
    steps into another (the recurrence): the last logits within
    LM_XDEV_TOL; each layer's SSM state within MAMBA_STATE_RTOL of its
    max |state| in the first MAMBA_SHALLOW layers and within
    MAMBA_DEEP_RTOL in every layer.  Beside it, the same chunked prefill
    on the CPU copy against the card's: the f32 rounding of one branch,
    layer by layer."""
    import torch
    from repro_torch.models import decode_step, forward, init_cache

    n = x.shape[1]
    if n % cfg32.ssm.chunk:
        raise ValueError(f"{label}: {n} tokens are not whole chunks of "
                         f"{cfg32.ssm.chunk}")
    t0 = time.perf_counter()

    def chunked(p, where):
        return forward(cfg32, p, {"tokens": x.to(where)},
                       cache=init_cache(cfg32, 1, max_seq, torch.float32,
                                        where), logits_mode="last")

    with torch.inference_mode():
        logits, _, c_chunk = chunked(params, dev)
        c_rec = init_cache(cfg32, 1, max_seq, torch.float32, dev)
        for i in range(n):
            step, c_rec = decode_step(cfg32, params, c_rec, x[:, i:i + 1])
        _, _, c_cpu = chunked(cpu_params, torch.device("cpu"))
    torch.cuda.synchronize()
    err = float((logits[:, -1].double() - step[:, -1].double()).abs().max())

    def per_layer(got, want):
        """max |got - want| over max |want|, layer by layer."""
        a, b = (c["units"]["0"]["ssm"].double().cpu() for c in (got, want))
        return (a - b).flatten(1).abs().amax(1) / b.flatten(1).abs().amax(1)

    rel, xdev = per_layer(c_rec, c_chunk), per_layer(c_chunk, c_cpu)
    win = max(float((c_chunk["units"]["0"][k].double()
                     - c_rec["units"]["0"][k].double()).abs().max())
              for k in ("conv_x", "conv_b", "conv_c"))
    shallow = float(rel[:MAMBA_SHALLOW].max())

    def show(r):
        return (f"first {MAMBA_SHALLOW} layers "
                f"{['%.2e' % v for v in r[:MAMBA_SHALLOW].tolist()]}, median "
                f"{float(r.median()):.3e}, max {float(r.max()):.3e} at "
                f"layer {int(r.argmax())}")

    log(f"[{label} duality] f32, {n} tokens as one chunked prefill "
        f"(chunk {cfg32.ssm.chunk}) against {n} one-token decode steps "
        f"(the recurrence): last logits max abs err {err:.3e} (limit "
        f"{LM_XDEV_TOL}); SSM state max err over max |state|: "
        f"{show(rel)} (limits {MAMBA_STATE_RTOL} for the first "
        f"{MAMBA_SHALLOW}, {MAMBA_DEEP_RTOL} for all {len(rel)}); conv "
        f"windows max abs err {win:.3e}; the chunked prefill on the CPU "
        f"against the card's, the same measure: {show(xdev)}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not err <= LM_XDEV_TOL or not shallow <= MAMBA_STATE_RTOL or \
            not float(rel.max()) <= MAMBA_DEEP_RTOL:
        raise AssertionError(f"{label}: chunked and recurrent differ: "
                             f"logits by {err}, state by {shallow} in the "
                             f"first {MAMBA_SHALLOW} layers, "
                             f"{float(rel.max())} in all")
    return {"duality_logit_err": err, "duality_state_rel_err_shallow":
            shallow, "duality_state_rel_err": float(rel.max()),
            "chunked_xdev_state_rel_err": float(xdev.max())}


def jamba_checks(dev, seed, label="jamba"):
    """(d) Jamba's reduced hybrid unit (attention at layer 0, Mamba at
    1-7, the dense MoE on odd layers), f32 compute and cache, weights
    drawn on the card from ``seed``, against a CPU copy: a prefill of
    JAMBA_STEPS[0] tokens (the chunked path), then decode steps of the
    rest (the recurrence): logits within LM_XDEV_TOL at every step, the
    prefill's aux loss within JAMBA_AUX_RTOL, ``pos`` equal."""
    import numpy as np
    import torch
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import (
        cache_position, forward, init_cache, materialize_params,
    )
    from repro_torch.pytree import tree_leaves, tree_map

    cfg = get_reduced_config(JAMBA_ARCH).scaled(compute_dtype="float32")
    params, _ = materialize_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    toks = torch.as_tensor(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (2, sum(JAMBA_STEPS))), dtype=torch.int32)
    out = []
    for where, p in ((dev, params), (torch.device("cpu"), cpu_params)):
        cache = init_cache(cfg, 2, 64, torch.float32, where)
        logits, aux, lo = [], None, 0
        with torch.inference_mode():
            for n in JAMBA_STEPS:
                lg, ex, cache = forward(
                    cfg, p, {"tokens": toks[:, lo:lo + n].to(where)},
                    cache=cache)
                logits.append(lg.cpu().double())
                aux = float(ex["aux_loss"]) if aux is None else aux
                lo += n
        out.append((logits, aux, int(cache_position(cache)), cache))
    (g, g_aux, g_pos, g_c), (w, w_aux, w_pos, w_c) = out
    errs = [float((a - b).abs().max()) for a, b in zip(g, w)]
    aux_err = abs(g_aux - w_aux) / abs(w_aux)
    state_err = max(float((a.cpu().double() - b.double()).abs().max())
                    for a, b in zip(tree_leaves(g_c), tree_leaves(w_c)))
    finite = all(bool(torch.isfinite(a).all()) for a in g)
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"[{label}] reduced {JAMBA_ARCH} ({cfg.n_layers} layers: "
        f"{[s.mixer + '+' + s.ffn for s in cfg.unit]}, d_model "
        f"{cfg.d_model}, {n_params} params), f32, {dev} against the CPU: "
        f"logits max abs err {['%.3e' % e for e in errs]} over steps of "
        f"{list(JAMBA_STEPS)} tokens (limit {LM_XDEV_TOL}); aux loss "
        f"{g_aux:.6f} against {w_aux:.6f}, rel err {aux_err:.3e} (limit "
        f"{JAMBA_AUX_RTOL}); pos {g_pos} / {w_pos}; cache leaves max abs "
        f"err {state_err:.3e}")
    if not finite or not max(errs) <= LM_XDEV_TOL or \
            not aux_err <= JAMBA_AUX_RTOL or g_pos != w_pos or \
            g_pos != sum(JAMBA_STEPS):
        raise AssertionError(f"{label}: {dev} and CPU differ: logits by "
                             f"{errs} (finite {finite}), aux by {aux_err}, "
                             f"pos {g_pos} / {w_pos}")
    return {"jamba_logit_err": max(errs), "jamba_aux_err": aux_err}


def mamba_checks(cfg, params, dev, cpu_params, sizes, seed, label="mamba"):
    """The phase's checks on ``params`` (f32) on ``dev``, TF32 off: (a)
    ``mamba_xdev`` on ``sizes["xdev"]`` tokens, (b) ``mamba_duality`` on
    ``sizes["state"]``, (d) ``jamba_checks``.  Raises on a failed check;
    returns what it measured."""
    import torch

    _, stream = lm_token_stream(sizes["corpus_docs"], seed)
    cfg32 = cfg.scaled(compute_dtype="float32")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        res = {"xdev_err": mamba_xdev(
            cfg32, params, cpu_params, dev,
            torch.as_tensor(stream[:sizes["xdev"]][None]), label)}
        x = torch.as_tensor(stream[:sizes["state"]][None], device=dev)
        res.update(mamba_duality(cfg32, params, cpu_params, dev, x,
                                 sizes["max_seq"], label))
        res.update(jamba_checks(dev, seed))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return res


def mamba_greedy(cfg, params, dev, stream, n_prompt, n_dec, max_seq):
    """``greedy_generate`` of ``n_dec`` tokens after an ``n_prompt``-token
    prompt at batch 1 and 8 (the batch-8 rows cut from the stream, row 0
    the batch-1 prompt): tokens in the vocabulary, and the share of steps
    where batch 8's row 0 picks batch 1's token."""
    import numpy as np
    from repro_torch.models import init_cache
    from repro_torch.serve.engine import greedy_generate

    toks = {}
    for b in LM_BATCHES:
        rows = stream[:b * n_prompt].reshape(b, n_prompt)
        out, _ = greedy_generate(cfg, params, init_cache(
            cfg, b, max_seq, device=dev), rows, n_dec)
        toks[b] = out.cpu().numpy()
        if toks[b].shape != (b, n_dec) or toks[b].min() < 0 or \
                toks[b].max() >= cfg.vocab_size:
            raise AssertionError(f"greedy tokens at batch {b}: shape "
                                 f"{toks[b].shape}, range {toks[b].min()}-"
                                 f"{toks[b].max()}")
    return float(np.mean(toks[LM_BATCHES[0]][0] == toks[LM_BATCHES[-1]][0]))


def mamba_phase(args, dev, smi):
    """mamba2-370m at full width and depth on the card: random f32
    weights drawn on the card from a generator seeded by --seed.  The
    checks of ``mamba_checks``; then, in the config's bf16 compute and
    cache, ``greedy_generate`` at batch 1 and 8, prefill ms of 512 tokens
    (the chunked SSD, CUDA events, median of 5), decode ms a token and
    tokens/s at batch 1 and 8 (64 greedy steps, median of 3 runs), a
    prompt of 255 tokens against 256 (the recurrence against one chunk),
    the resident bytes of params and cache, the decode bound, and a
    profiler trace of three decode steps (``lm_decode_trace``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_cache, materialize_params
    from repro_torch.pytree import tree_leaves, tree_map

    t0 = time.perf_counter()
    cfg = get_config(MAMBA_ARCH)
    params, _ = materialize_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    p_bytes = tree_bytes(params)
    s = cfg.ssm
    log(f"[mamba] {MAMBA_ARCH}: {cfg.n_layers} Mamba2 layers, d_model "
        f"{cfg.d_model}, d_inner {s.expand * cfg.d_model}, "
        f"{s.expand * cfg.d_model // s.head_dim} SSD heads of "
        f"{s.head_dim}, d_state {s.d_state}, chunk {s.chunk}, vocab "
        f"{cfg.vocab_size}; {n_params} params, {p_bytes} resident bytes "
        f"({cfg.param_dtype}); built in {time.perf_counter() - t0:.1f} s")
    res = mamba_checks(cfg, params, dev, cpu_params, MAMBA_SIZES, args.seed)
    del cpu_params
    log(f"[mamba] checks done in {time.perf_counter() - t0:.1f} s")

    _, stream = lm_token_stream(MAMBA_SIZES["corpus_docs"], args.seed)
    n_prompt, max_seq = MAMBA_SIZES["prompt"], MAMBA_SIZES["max_seq"]
    n_dec = MAMBA_SIZES["decode"]
    agree = mamba_greedy(cfg, params, dev, stream, n_prompt, n_dec, max_seq)
    line = lm_timings(cfg, params, dev, stream, n_prompt, max_seq, n_dec)
    # one chunk, then a token fewer: the recurrence, one step a token
    n_rec = MAMBA_SIZES["recurrent"]
    line[f"prefill_ms_{n_rec + 1}"] = lm_prefill_ms(
        cfg, params, dev, stream, n_rec + 1, max_seq)
    line[f"prefill_ms_{n_rec}"] = lm_prefill_ms(
        cfg, params, dev, stream, n_rec, max_seq, reps=1, warmup=0)
    # one decode step reads every f32 weight once and writes its bf16 cast
    bound_ms = (p_bytes + p_bytes // 2) / HBM_BYTES_PER_S * 1e3
    line.update(param_bytes=p_bytes, decode_bound_ms_b1=bound_ms,
                greedy_row0_agree_b1_b8=agree, **res)
    log(f"[mamba ms] {smi}: " + json.dumps(line))
    trace = lm_decode_trace(cfg, params, dev, stream, n_prompt, max_seq)
    trace["launches_per_layer"] = trace["launches_per_step"] / cfg.n_layers
    log(f"[mamba trace] {smi}: 3 decode steps at batch 1: "
        + json.dumps(trace))
    cache_b1 = tree_bytes(init_cache(cfg, 1, max_seq, device=dev))
    if p_bytes != 4 * n_params or line["cache_bytes_b1"] != cache_b1 or \
            line["cache_bytes_b8"] != 8 * cache_b1:
        raise AssertionError(f"mamba: resident bytes {p_bytes}, cache "
                             f"{line['cache_bytes_b1']} / "
                             f"{line['cache_bytes_b8']} (one batch row "
                             f"{cache_b1})")
    del params
    torch.cuda.empty_cache()
    log(f"[mamba] phase done in {time.perf_counter() - t0:.1f} s")


# the training phase: smollm-360m trained at full width and depth through
# launch/train.py, with mamba2-370m's steps and the reduced DeepSeek-V3
# and Jamba gradients beside it
TRAIN_ARCH = "smollm-360m"
TRAIN_SIZES = dict(xdev_batch=2, xdev_seq=64,   # (a): card against CPU
                   batch=8, seq=256,             # (b), (c)-(g)
                   steps=24, ckpt_every=8,       # (c)
                   resume_at=17,                 # (d): its checkpoint: 16
                   short=4,                      # (f), (g), mamba2-370m
                   mamba_batch=4, mamba_seq=256,
                   reduced_batch=2, reduced_seq=32,
                   long_seq=4096)                # one remat step of 1 x 4096
TRAIN_XDEV_RTOL = 1e-4        # (a) loss and global grad norm, relative
TRAIN_XDEV_LEAF = 1e-3        # (a) a leaf's max grad err over its max |grad|
TRAIN_REMAT_RTOL = 1e-6       # (b) remat on against off, the same measures
TRAIN_RESUME_TOL = 1e-6       # (d) of each leaf's max |param|
TRAIN_MB_LOSS_RTOL = 1e-3     # (e) tests/test_train.py's tolerance
TRAIN_MB_TOL = dict(rtol=2e-2, atol=2e-4)
TRAIN_REDUCED_TOL = 1e-3      # reduced DeepSeek-V3 / Jamba, card vs CPU
ADAMW_BYTES = 28              # a param's f32 p, g, m, v read, p, m, v written
TRAIN_REDUCED = ("deepseek-v3-671b", "jamba-1.5-large-398b")


@contextlib.contextmanager
def f32_exact():
    """TF32 off for matmuls and cuDNN inside the block."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@functools.lru_cache(maxsize=None)
def train_pipeline(seq, batch):
    """The trainer's pipeline (``launch/train.py``: 512 synthetic
    documents, seed 1), built once a shape."""
    from repro_torch.data.pipeline import (
        PipelineConfig, TokenPipeline, synthetic_corpus,
    )

    return TokenPipeline(synthetic_corpus(512, seed=1),
                         PipelineConfig(seq_len=seq, global_batch=batch))


def on_device(batch, dev):
    import torch

    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def tree_rel_err(got, want):
    """(worst leaf's path, its max |got - want| over max |want|), leaf by
    leaf in float64 on ``want``'s device."""
    from repro_torch.pytree import tree_leaves, tree_leaves_with_path

    worst = ("", 0.0)
    for (path, g), w in zip(tree_leaves_with_path(got), tree_leaves(want)):
        w = w.double()
        diff = float((g.to(w.device).double() - w).abs().max())
        peak = float(w.abs().max())
        err = diff / peak if peak > 0 else diff
        if not err <= worst[1]:
            worst = ("/".join(map(str, path)), err)
    return worst


def rel(a, b):
    a, b = float(a), float(b)
    return abs(a - b) / abs(b) if b else abs(a - b)


def grads_xdev(cfg, params, cpu_params, dev, batch, label, leaf_tol,
               rtol):
    """``loss_and_grads`` on ``dev`` against the CPU copy in f32 (the
    CPU without remat's recompute): the loss and each metric within
    ``rtol`` relative, the global grad norm too, every leaf within
    ``leaf_tol`` of its max |grad|."""
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_step import loss_and_grads

    with f32_exact():
        got = loss_and_grads(cfg, params, on_device(batch, dev))
        # remat changes no value (``train_remat``): the CPU skips it
        want = loss_and_grads(cfg.scaled(remat=False), cpu_params,
                              on_device(batch, "cpu"))
    errs = {"loss": rel(got[0], want[0]),
            "grad_norm": rel(global_norm(got[2]), global_norm(want[2]))}
    errs.update({k: rel(got[1][k], want[1][k]) for k in want[1]})
    leaf, leaf_err = tree_rel_err(got[2], want[2])
    log(f"[{label}] f32, {dev} against the CPU: loss {float(got[0]):.6f} "
        f"against {float(want[0]):.6f}; relative errors "
        f"{json.dumps(errs)} (limit {rtol}); worst leaf {leaf}: max grad "
        f"err {leaf_err:.3e} of its max |grad| (limit {leaf_tol})")
    finite = all(math.isfinite(float(v)) for v in
                 [got[0], *got[1].values()])
    if not finite or max(errs.values()) > rtol or not leaf_err <= leaf_tol:
        raise AssertionError(f"{label}: {dev} and CPU differ: {errs}, "
                             f"leaf {leaf} by {leaf_err} (finite {finite})")
    return {"rel_errs": errs, "worst_leaf": leaf, "worst_leaf_err": leaf_err}


def train_remat(cfg32, params, dev, batch, label):
    """(b) ``loss_and_grads`` with remat on (the config's policy) and off,
    on the card in f32: loss and every leaf within TRAIN_REMAT_RTOL, and
    each run's peak bytes above what it found allocated."""
    import torch
    from repro_torch.pytree import tree_leaves
    from repro_torch.train.train_step import loss_and_grads

    runs = {}
    with f32_exact():
        for remat in (True, False):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            loss, _, grads = loss_and_grads(cfg32.scaled(remat=remat),
                                            params, on_device(batch, dev))
            torch.cuda.synchronize()
            runs[remat] = (loss, grads,
                           torch.cuda.max_memory_allocated(dev) - base)
    loss_err = rel(runs[True][0], runs[False][0])
    leaf, leaf_err = tree_rel_err(runs[True][1], runs[False][1])
    bitwise = bool(torch.equal(runs[True][0], runs[False][0])) and all(
        torch.equal(a, b) for a, b in zip(
            *(tree_leaves(runs[r][1]) for r in (True, False))))
    peaks = {"peak_bytes_remat": runs[True][2],
             "peak_bytes_no_remat": runs[False][2]}
    log(f"[{label}] remat ({cfg32.remat_policy}) against none, f32, batch "
        f"{tuple(batch['tokens'].shape)}: loss rel err {loss_err:.3e}, "
        f"worst leaf {leaf} {leaf_err:.3e} (limit {TRAIN_REMAT_RTOL}); "
        f"bitwise {bitwise}; peak bytes above the resident "
        f"{json.dumps(peaks)}")
    if loss_err > TRAIN_REMAT_RTOL or not leaf_err <= TRAIN_REMAT_RTOL:
        raise AssertionError(f"{label}: remat changed values: loss by "
                             f"{loss_err}, {leaf} by {leaf_err}")
    return dict(peaks, remat_bitwise=bitwise)


def train_microbatches(cfg32, params, dev, batch, label):
    """(e) ``make_train_step`` with 2 microbatches against 1 on the same
    batch, f32, AdamW at lr 1e-3 (tests/test_train.py's case): the loss
    within TRAIN_MB_LOSS_RTOL, params within TRAIN_MB_TOL."""
    import torch
    from repro_torch.pytree import tree_leaves
    from repro_torch.train import OptConfig, make_train_step, pick_optimizer

    opt = pick_optimizer(cfg32, OptConfig(lr=1e-3))
    out = {}
    with f32_exact():
        for mb in (1, 2):
            step = make_train_step(cfg32, opt, microbatches=mb)
            p, _, m = step(params, opt.init(params), on_device(batch, dev),
                           0)
            out[mb] = (p, float(m["loss"]))
    loss_err = rel(out[2][1], out[1][1])
    bad, worst = 0, 0.0
    for a, b in zip(tree_leaves(out[2][0]), tree_leaves(out[1][0])):
        d = (a.float() - b.float()).abs()
        bad += int((d > TRAIN_MB_TOL["atol"]
                    + TRAIN_MB_TOL["rtol"] * b.float().abs()).sum())
        worst = max(worst, float(d.max()))
    log(f"[{label}] microbatches 2 against 1, f32, batch "
        f"{tuple(batch['tokens'].shape)}: loss {out[2][1]:.6f} / "
        f"{out[1][1]:.6f}, rel err {loss_err:.3e} (limit "
        f"{TRAIN_MB_LOSS_RTOL}); params max abs diff {worst:.3e}, {bad} "
        f"outside rtol {TRAIN_MB_TOL['rtol']} / atol {TRAIN_MB_TOL['atol']}")
    if loss_err > TRAIN_MB_LOSS_RTOL or bad:
        raise AssertionError(f"{label}: microbatches differ: loss by "
                             f"{loss_err}, {bad} params")
    return {"mb_loss_rel_err": loss_err, "mb_param_max_diff": worst}


def run_trainer(arch, dev, seed, ckpt_dir, steps, batch, seq, *extra):
    """``launch.train.main`` in process; its result."""
    from repro_torch.launch import train as launch_train

    return launch_train.main([
        "--arch", arch, "--steps", str(steps), "--batch", str(batch),
        "--seq", str(seq), "--seed", str(seed), "--device", str(dev),
        "--ckpt-dir", ckpt_dir, *extra])


def step_ms_of(res):
    """Median step ms after 2 warm-up steps (CUDA events)."""
    return statistics.median(res["step_ms"][2:])


def train_driver(args, dev, tmp, label):
    """(c) The driver for TRAIN_SIZES["steps"] steps with a checkpoint
    every ``ckpt_every``: finite losses falling (the mean of the last 4
    below the first 4's), step ms, tokens/s, peak bytes, param and AdamW
    state bytes and the step's bound.  Returns the run's result."""
    import numpy as np
    import torch
    from repro_torch.pytree import tree_leaves

    sz = TRAIN_SIZES
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = run_trainer(TRAIN_ARCH, dev, args.seed, os.path.join(tmp, "whole"),
                      sz["steps"], sz["batch"], sz["seq"], "--ckpt-every",
                      str(sz["ckpt_every"]), "--log-every",
                      str(sz["ckpt_every"]))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    losses = np.asarray(res["losses"])
    first, last = float(losses[:4].mean()), float(losses[-4:].mean())
    n = sum(t.numel() for t in tree_leaves(res["params"]))
    tokens = sz["batch"] * sz["seq"]
    ms = step_ms_of(res)
    # forward 2N, backward 4N and the remat recompute 2N flops a token;
    # AdamW's bytes once
    passes = 8 if res["cfg"].remat else 6
    bound_ms = (passes * n * tokens / BF16_OPS_PER_S
                + ADAMW_BYTES * n / HBM_BYTES_PER_S) * 1e3
    line = {"arch": TRAIN_ARCH, "params": n, "batch": sz["batch"],
            "seq": sz["seq"], "steps": sz["steps"],
            "optimizer": type(res["optimizer"]).__name__,
            "step_ms": ms, "tokens_per_s": tokens * 1e3 / ms,
            # before the first checkpoint's writer thread starts
            "step_ms_before_ckpt": statistics.median(
                res["step_ms"][2:sz["ckpt_every"] + 1]),
            "step_ms_all": res["step_ms"], "peak_bytes": peak,
            "param_bytes": tree_bytes(res["params"]),
            "opt_state_bytes": tree_bytes(res["opt_state"]),
            "bound_ms": bound_ms, "bound_share": bound_ms / ms,
            "loss_first4": first, "loss_last4": last,
            "run_s": wall}
    log(f"[{label} driver] {json.dumps(line)}")
    if not np.isfinite(losses).all() or not last < first:
        raise AssertionError(f"{label}: losses {losses.tolist()}")
    if line["optimizer"] != "AdamW":
        raise AssertionError(f"{label}: picked {line['optimizer']}")
    return res, line


def train_resume(args, dev, tmp, whole, label):
    """(d) The same run stopped at TRAIN_SIZES["resume_at"] steps (one
    checkpoint, at its last step) and resumed to the end: final params
    and AdamW state within TRAIN_RESUME_TOL of each leaf's max of the
    uninterrupted run's, the resumed losses too."""
    import torch
    from repro_torch.pytree import tree_leaves

    sz = TRAIN_SIZES
    ckpt = os.path.join(tmp, "resumed")
    common = (TRAIN_ARCH, dev, args.seed, ckpt)
    log_every = ("--log-every", str(sz["ckpt_every"]))
    # stopped: its one checkpoint is its last step's
    run_trainer(*common, sz["resume_at"], sz["batch"], sz["seq"],
                "--ckpt-every", "1000000", *log_every)
    res = run_trainer(*common, sz["steps"], sz["batch"], sz["seq"],
                      "--ckpt-every", str(sz["ckpt_every"]), *log_every)
    if res["start_step"] != sz["resume_at"]:
        raise AssertionError(f"{label}: resumed at {res['start_step']}")
    state = {"params": res["params"], "opt": res["opt_state"]}
    want = {"params": whole["params"], "opt": whole["opt_state"]}
    leaf, err = tree_rel_err(state, want)
    bitwise = all(torch.equal(a, b) for a, b in zip(tree_leaves(state),
                                                    tree_leaves(want)))
    loss_err = max(rel(a, b) for a, b in zip(
        res["losses"], whole["losses"][sz["resume_at"]:]))
    log(f"[{label} resume] {sz['resume_at']} steps, then resumed to "
        f"{sz['steps']} from step {res['start_step'] - 1}: params and "
        f"AdamW state against the uninterrupted run: worst leaf {leaf} "
        f"{err:.3e} of its max (limit {TRAIN_RESUME_TOL}), bitwise "
        f"{bitwise}; resumed losses max rel err {loss_err:.3e}")
    if not err <= TRAIN_RESUME_TOL:
        raise AssertionError(f"{label}: resume differs: {leaf} by {err}")
    return {"resume_bitwise": bitwise, "resume_worst_err": err,
            "resume_loss_err": loss_err}


def train_cpu_checkpoint(cpu_params, params, tmp, label):
    """(d) The CPU copy's params saved by ``train.checkpoint.save`` and
    restored onto the card's tree: every leaf on the card, bitwise."""
    import torch
    from repro_torch.pytree import tree_leaves
    from repro_torch.train.checkpoint import restore_latest, save

    t0 = time.perf_counter()
    path = os.path.join(tmp, "from_cpu")
    save(path, 0, {"params": cpu_params})
    restored, _ = restore_latest(path, {"params": params})
    secs = time.perf_counter() - t0
    ok = restored is not None and all(
        a.device == b.device and torch.equal(a, b) for a, b in zip(
            tree_leaves(restored), tree_leaves({"params": params})))
    log(f"[{label} checkpoint] the CPU copy's params ({tree_bytes(params)} "
        f"bytes) saved and restored onto the card's tree: bitwise {ok} "
        f"({secs:.1f} s)")
    if not ok:
        raise AssertionError(f"{label}: the CPU checkpoint did not restore")
    shutil.rmtree(path)
    return {"cpu_ckpt_restore_s": secs}


def train_steps(cfg, opt, params, dev, seq, batch, n):
    """``n`` steps of ``make_train_step(cfg, opt)`` on the trainer's
    pipeline batches 0..n-1: losses, step ms (CUDA events) and the final
    optimizer state."""
    import torch
    from repro_torch.train import make_train_step

    step = make_train_step(cfg, opt)
    state = opt.init(params)
    pipe = train_pipeline(seq, batch)
    losses, times = [], []
    for i in range(n):
        b = on_device(pipe.batch_at(i), dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in "se"]
        ev[0].record()
        params, state, m = step(params, state, b, float(i))
        ev[1].record()
        losses.append(float(m["loss"]))
        times.append(ev[0].elapsed_time(ev[1]))
    return losses, times, state


def train_adafactor(cfg, whole, dev, label):
    """(g) Adafactor forced on smollm-360m, TRAIN_SIZES["short"] steps
    from the driver's final params: finite losses, step ms and the state's
    bytes beside AdamW's."""
    import numpy as np
    from repro_torch.train import Adafactor, OptConfig

    sz = TRAIN_SIZES
    opt = Adafactor(OptConfig(name="adafactor", warmup_steps=20))
    losses, times, state = train_steps(cfg, opt, whole["params"], dev,
                                       sz["seq"], sz["batch"], sz["short"])
    line = {"adafactor_losses": losses,
            "adafactor_step_ms": statistics.median(times[2:]),
            "adafactor_state_bytes": tree_bytes(state),
            "adamw_state_bytes": tree_bytes(whole["opt_state"])}
    log(f"[{label} adafactor] {json.dumps(line)}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"{label}: Adafactor losses {losses}")
    return line


def train_mamba(dev, seed, label):
    """mamba2-370m at full width and depth, f32 weights drawn on the card
    from ``seed``: TRAIN_SIZES["short"] AdamW steps (``pick_optimizer``)
    at mamba_batch x mamba_seq tokens (the chunked SSD's backward):
    finite losses, step ms."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import materialize_params
    from repro_torch.train import OptConfig, pick_optimizer

    sz = TRAIN_SIZES
    cfg = get_config("mamba2-370m")
    params, _ = materialize_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    opt = pick_optimizer(cfg, OptConfig(warmup_steps=20))
    losses, times, _ = train_steps(cfg, opt, params, dev, sz["mamba_seq"],
                                   sz["mamba_batch"], sz["short"])
    line = {"arch": "mamba2-370m", "optimizer": type(opt).__name__,
            "batch": sz["mamba_batch"], "seq": sz["mamba_seq"],
            "losses": losses, "step_ms": statistics.median(times[2:]),
            "step_ms_all": times}
    log(f"[{label}] {json.dumps(line)}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"{label}: losses {losses}")
    return line


def train_compress(dev, seed, tmp, label):
    """(f) The driver with ``--compress-grads`` for TRAIN_SIZES["short"]
    steps (one checkpoint, at the end): finite losses and a finite
    residual; step ms."""
    import numpy as np
    from repro_torch.pytree import tree_leaves

    sz = TRAIN_SIZES
    res = run_trainer(TRAIN_ARCH, dev, seed, os.path.join(tmp, "compress"),
                      sz["short"], sz["batch"], sz["seq"], "--ckpt-every",
                      "1000000", "--compress-grads")
    residual = tree_leaves(res["residual"])
    line = {"losses": res["losses"], "step_ms": step_ms_of(res),
            "step_ms_all": res["step_ms"],
            "residual_max_abs": max(float(r.abs().max()) for r in residual),
            "residual_finite": all(bool(r.isfinite().all())
                                   for r in residual)}
    log(f"[{label}] {json.dumps(line)}")
    if not np.isfinite(res["losses"]).all() or not line["residual_finite"]:
        raise AssertionError(f"{label}: {line}")
    return line


def train_reduced(dev, seed, label="train"):
    """Reduced DeepSeek-V3 (MLA, the MoE aux, MTP) and Jamba (attention,
    Mamba, the MoE aux), f32 weights drawn on the card from ``seed``:
    loss, metrics and every gradient card against CPU within
    TRAIN_REDUCED_TOL."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import materialize_params
    from repro_torch.pytree import tree_map

    import torch

    sz = TRAIN_SIZES
    batch = train_pipeline(sz["reduced_seq"], sz["reduced_batch"]).batch_at(0)
    out = {}
    for arch in TRAIN_REDUCED:
        cfg = get_reduced_config(arch)
        cfg = cfg.scaled(compute_dtype="float32",
                         vocab_size=max(cfg.vocab_size, 260))
        params, _ = materialize_params(
            cfg, torch.Generator(device=dev).manual_seed(seed), dev)
        out[arch] = grads_xdev(
            cfg, params, tree_map(lambda t: t.cpu(), params), dev, batch,
            f"{label} {arch}", TRAIN_REDUCED_TOL, TRAIN_REDUCED_TOL)
    return out


def train_long(args, dev, smi, label="train long"):
    """One remat train step of smollm-360m at full width and depth on
    TRAIN_SIZES["long_seq"] tokens (bf16 compute, AdamW; 16 query chunks
    of 256, each checkpointed inside its unit's checkpoint) through
    ``dryrun_held``: its FLOPs, argument bytes and added allocation held
    against the dry run's as ``[dryrun]`` holds its cells; a finite loss;
    the peak added allocation printed beside the bytes one layer's whole
    probabilities would take (heads x seq^2 x 4 B: what the unit's
    recompute kept before the chunks were checkpointed) and the dry
    run's temp."""
    from repro_torch.configs import get_config

    cfg = get_config(TRAIN_ARCH)
    seq = TRAIN_SIZES["long_seq"]
    out_dir = os.path.join(args.dryrun_out, "held")
    os.makedirs(out_dir, exist_ok=True)
    line = dryrun_held(dev, smi, args.seed,
                       (f"train_1x{seq}", seq, 1, "train"), out_dir, label)
    probs = cfg.n_heads * seq * seq * 4
    log(f"[{label}] {smi}: {TRAIN_ARCH}, 1 x {seq} tokens, q_chunk 256, "
        f"remat {cfg.remat}: loss {line['loss']:.6f}; peak added "
        f"allocation {line['step_temp_bytes']} B beside one layer's whole "
        f"probabilities {probs} B ({cfg.n_heads} heads x {seq}^2 x 4 B) "
        f"and the dry run's temp {line['temp_bytes']} B")
    if not math.isfinite(line["loss"]):
        raise AssertionError(f"{label}: loss {line['loss']}")


def train_phase(args, dev, smi):
    """smollm-360m trained at full width and depth on the card, f32
    weights drawn from --seed: (a) one ``loss_fn`` and its gradients in
    f32 against a CPU copy; (b) remat on against off; (e) 2 microbatches
    against 1; (c) ``launch.train.main`` for 24 steps (bf16 compute, AdamW,
    checkpoints every 8) with a profiler trace of one more step; (d) the
    CPU copy's checkpoint restored on the card, and a run stopped at 17
    steps and resumed; (g) Adafactor forced for 4 steps; (f) the driver
    with --compress-grads for 4 steps; then 4 steps of mamba2-370m at full
    width (the chunked SSD's backward) and the reduced DeepSeek-V3 and
    Jamba gradients card against CPU."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import materialize_params
    from repro_torch.pytree import tree_leaves, tree_map
    from repro_torch.train import make_train_step

    t0 = time.perf_counter()
    secs = {}

    def lap(name, since=[t0]):
        now = time.perf_counter()
        secs[name] = now - since[0]
        since[0] = now

    sz = TRAIN_SIZES
    cfg = get_config(TRAIN_ARCH)
    cfg32 = cfg.scaled(compute_dtype="float32")
    params, _ = materialize_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"[train] {TRAIN_ARCH}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}; {n_params} {cfg.param_dtype}"
        f" params; remat {cfg.remat} ({cfg.remat_policy}); the CPU copy "
        f"runs on {torch.get_num_threads()} threads of {os.cpu_count()} "
        f"cores")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        xdev_pipe = train_pipeline(sz["xdev_seq"], sz["xdev_batch"])
        res = {"xdev": grads_xdev(cfg32, params, cpu_params, dev,
                                  xdev_pipe.batch_at(0), "train xdev",
                                  TRAIN_XDEV_LEAF, TRAIN_XDEV_RTOL)}
        lap("xdev")
        res.update(train_cpu_checkpoint(cpu_params, params, tmp, "train"))
        del cpu_params
        lap("cpu_checkpoint")
        batch = train_pipeline(sz["seq"], sz["batch"]).batch_at(0)
        res.update(train_remat(cfg32, params, dev, batch, "train"))
        res.update(train_microbatches(cfg32, params, dev, batch,
                                      "train microbatches"))
        del params
        torch.cuda.empty_cache()
        lap("remat_microbatches")

        whole, line = train_driver(args, dev, tmp, "train")
        shutil.rmtree(os.path.join(tmp, "whole"))
        lap("driver")
        step = make_train_step(whole["cfg"], whole["optimizer"])
        state = {"p": whole["params"], "s": whole["opt_state"]}
        batch = on_device(train_pipeline(sz["seq"], sz["batch"]).batch_at(
            sz["steps"]), dev)

        def run():
            state["p"], state["s"], _ = step(state["p"], state["s"], batch,
                                             float(sz["steps"]))

        trace = trace_steps(run, 1)
        del state
        log(f"[train trace] {smi}: one train step at batch "
            f"{sz['batch']} x {sz['seq']}: " + json.dumps(trace))
        lap("trace")
        line.update(res)
        line.update(train_resume(args, dev, tmp, whole, "train"))
        lap("resume")
        line.update(train_adafactor(whole["cfg"], whole, dev, "train"))
        del whole
        torch.cuda.empty_cache()
        lap("adafactor")
        line["compress_step_ms"] = train_compress(
            dev, args.seed, tmp, "train compress")["step_ms"]
        lap("compress")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    line["mamba_step_ms"] = train_mamba(dev, args.seed,
                                        "train mamba")["step_ms"]
    torch.cuda.empty_cache()
    lap("mamba")
    line["reduced"] = train_reduced(dev, args.seed)
    lap("reduced")
    line.pop("step_ms_all")
    line["seconds"] = secs
    log(f"[train ms] {smi}: " + json.dumps(line))
    log(f"[train] phase done in {time.perf_counter() - t0:.1f} s")


DRYRUN_ARCH = "smollm-360m"
# (a) the cells held against the card, on a 1 x 1 mesh: the [train]
# phase's cell (8 x 256 tokens, AdamW, remat) and the [lm] decode cell
# (batch 8, a cache of a 512-token prompt + 64 decoded tokens)
DRYRUN_HELD = (("train_8x256", 256, 8, "train"),
               ("decode_8x576", 576, 8, "decode"))
DRYRUN_STEPS = {"train": 3, "decode": 10}   # timed steps after one warm-up
# the caching allocator's slack a tensor: a request rounded up to 512 B,
# and a block of over 1 MiB not split where less than 1 MiB would remain
DRYRUN_ALLOC_ROUND = 512
DRYRUN_ALLOC_SPLIT = 1 << 20
# the predicted step peak (argument + temp) against the card's: the
# allocated bytes a step adds over what was live before it, within 5% of
# the dry run's temp or 64 MiB (PERF.md §6, written before the run)
DRYRUN_TEMP_RTOL = 0.05
DRYRUN_TEMP_ATOL = 64 << 20
# (b) the production cells, on meta tensors
DRYRUN_CELLS = (("deepseek-v3-671b", "train_4k", False),
                ("deepseek-v3-671b", "train_4k", True),
                ("jamba-1.5-large-398b", "long_500k", False),
                ("smollm-360m", "decode_32k", False),
                ("yi-6b", "prefill_32k", False))


def dryrun_held(dev, smi, seed, cell, out_dir, label="dryrun held"):
    """One cell of (a): the dry run of smollm-360m at full width and
    depth on a 1 x 1 mesh (meta tensors, this host), then the same step
    on the card: FLOPs equal as integers (``FlopCounterMode`` around the
    real step); the argument bytes equal to the requested bytes the
    allocator gains when the params, optimizer state, batch and cache
    are placed, and ``memory_allocated``'s growth within the allocator's
    slack (``DRYRUN_ALLOC_ROUND`` a tensor, plus ``DRYRUN_ALLOC_SPLIT``
    for a tensor over 1 MiB); the predicted peak (argument + temp) beside
    ``max_memory_allocated``; and the roofline terms beside the measured
    step ms (and a train step's loss).  Returns the line it logs under
    ``label``."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.perf import terms_of
    from repro_torch.models import init_cache, materialize_params
    from repro_torch.pytree import tree_leaves
    from repro_torch.serve.engine import make_decode_step
    from repro_torch.train.optimizer import pick_optimizer
    from repro_torch.train.train_step import make_train_step

    name, seq, batch, kind = cell
    shape = ShapeConfig(name, seq, batch, kind)
    mesh = AbstractMesh((1, 1), ("data", "model"))
    cfg = get_config(DRYRUN_ARCH)
    t0 = time.perf_counter()
    rec = dryrun.run_cell(DRYRUN_ARCH, name, False, shape=shape, mesh=mesh)
    meta_s = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"{DRYRUN_ARCH}__{name}__1x1.json"),
              "w") as f:
        json.dump(rec, f, indent=1)

    def requested():
        return torch.cuda.memory_stats(dev)["requested_bytes.all.current"]

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    a0, r0 = torch.cuda.memory_allocated(dev), requested()
    gen = torch.Generator(device=dev).manual_seed(seed)
    params, _ = materialize_params(cfg, gen, dev)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device=dev, dtype=torch.int32)
    if kind == "train":
        opt = pick_optimizer(cfg)
        state = opt.init(params)
        data = {"tokens": tokens, "labels": tokens.clone()}
        args = (params, state, data)
        step = make_train_step(cfg, opt)
        box = {"p": params, "s": state}

        def run(i):
            box["p"], box["s"], box["m"] = step(box["p"], box["s"], data,
                                                float(i))
    else:
        cache = init_cache(cfg, batch, seq, device=dev)
        last = tokens[:, :1].clone()
        del tokens
        args = (params, cache, last)
        decode = make_decode_step(cfg)
        box = {"p": params, "c": cache}

        def run(i):
            _, box["c"] = decode(box["p"], box["c"], last)
    torch.cuda.synchronize()
    growth = torch.cuda.memory_allocated(dev) - a0
    req_growth = requested() - r0
    sizes = [t.numel() * t.element_size() for t in tree_leaves(list(args))
             if isinstance(t, torch.Tensor)]
    n_tensors = len(sizes)
    slack = DRYRUN_ALLOC_ROUND * n_tensors + DRYRUN_ALLOC_SPLIT * sum(
        n > DRYRUN_ALLOC_SPLIT for n in sizes)
    del args, params
    if kind == "train":
        del state
    else:
        del cache
    argument = int(rec["memory"]["argument_size_in_bytes"])
    with use_mesh(mesh):
        run(0)                                   # warm-up: cuBLAS, caches
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        with FlopCounterMode(display=False) as fc:
            run(1)
        torch.cuda.synchronize()
        step_temp = torch.cuda.max_memory_allocated(dev) - base
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(DRYRUN_STEPS[kind] + 1)]
        ev[0].record()
        for i in range(DRYRUN_STEPS[kind]):
            run(2 + i)
            ev[i + 1].record()
        torch.cuda.synchronize()
    ms = statistics.median(a.elapsed_time(b) for a, b in zip(ev, ev[1:]))
    loss = float(box["m"]["loss"]) if kind == "train" else None
    del box, run
    torch.cuda.empty_cache()
    flops_card = fc.get_total_flops()
    temp = int(rec["memory"]["temp_size_in_bytes"])
    terms = terms_of(rec)
    bound_ms = max(terms["compute_s"], terms["memory_s"]) * 1e3
    line = {"arch": DRYRUN_ARCH, "cell": name, "kind": kind,
            "mesh": rec["mesh"], "flops_dry_run": rec["flops_per_device"],
            "flops_card": flops_card,
            "argument_bytes": argument, "requested_growth": req_growth,
            "allocated_growth": growth, "tensors": n_tensors,
            "allocator_slack": slack,
            "temp_bytes": temp, "step_temp_bytes": step_temp,
            "predicted_peak": argument + temp,
            "measured_peak": growth + step_temp,
            "peak_gap": growth + step_temp - (argument + temp),
            "output_bytes": rec["memory"]["output_size_in_bytes"],
            "bytes_per_device": rec["bytes_per_device"],
            "bytes_boundary_per_device": rec["bytes_boundary_per_device"],
            "compute_ms": terms["compute_s"] * 1e3,
            "memory_ms": terms["memory_s"] * 1e3,
            "memory_boundary_ms": terms["memory_boundary_s"] * 1e3,
            "bound_ms": bound_ms, "step_ms": ms,
            "bound_share": bound_ms / ms, "dry_run_s": meta_s}
    if loss is not None:
        line["loss"] = loss
    log(f"[{label}] {smi}: " + json.dumps(line))
    if flops_card != rec["flops_per_device"]:
        raise AssertionError(f"dryrun {name}: {rec['flops_per_device']} "
                             f"FLOPs counted, {flops_card} on the card")
    if req_growth != argument or not 0 <= growth - argument <= slack:
        raise AssertionError(
            f"dryrun {name}: {argument} argument bytes, {req_growth} "
            f"requested and {growth} allocated for {n_tensors} tensors")
    if abs(step_temp - temp) > max(DRYRUN_TEMP_RTOL * temp,
                                   DRYRUN_TEMP_ATOL):
        raise AssertionError(f"dryrun {name}: temp {temp} predicted, "
                             f"{step_temp} on the card")
    return line


def dryrun_cell(cell):
    """One production cell's record on meta tensors, and its seconds (a
    worker process of ``dryrun_phase``)."""
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    rec = dryrun.run_cell(*cell)
    return rec, time.perf_counter() - t0


def dryrun_phase(args, dev, smi):
    """(b) the production cells on meta tensors, one worker process each
    (the card is not used there), while (a) smollm-360m's train and
    decode cells are held against real steps on the card
    (``dryrun_held``); then the cells' records under ``--dryrun-out`` and
    the roofline table over them.  Any failing cell fails the phase."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch.launch import dryrun, roofline

    t0 = time.perf_counter()
    out_dir = args.dryrun_out
    os.makedirs(os.path.join(out_dir, "held"), exist_ok=True)
    with ProcessPoolExecutor(
            max_workers=len(DRYRUN_CELLS),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [pool.submit(dryrun_cell, cell) for cell in DRYRUN_CELLS]
        held = [dryrun_held(dev, smi, args.seed, cell,
                            os.path.join(out_dir, "held"))
                for cell in DRYRUN_HELD]
        t_held = time.perf_counter() - t0
        done = [f.result() for f in futures]
    for (arch, shape, multi_pod), (rec, secs) in zip(DRYRUN_CELLS, done):
        tag = dryrun.cell_tag(arch, shape, multi_pod)
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
        mem = rec["memory"]
        log(f"[dryrun cell] {tag}: {secs:.1f} s "
            f"(build {rec['lower_seconds']:.2f}, full depth "
            f"{rec['compile_seconds']:.2f}, counts "
            f"{rec['cost_measure_seconds']:.2f}); flops/dev "
            f"{rec['flops_per_device']:.4e}, bytes/dev "
            f"{rec['bytes_per_device']:.4e}, boundary "
            f"{rec['bytes_boundary_per_device']:.4e}, collectives "
            + json.dumps(rec["collective_bytes_per_device"])
            + f", argument {mem['argument_size_in_bytes']:.4e} B, temp "
            f"{mem['temp_size_in_bytes']:.4e} B")
    records = roofline.load_records(out_dir)
    log(f"[dryrun table] peaks: {roofline.CARD}")
    for mesh in ("pod16x16", "pod2x16x16"):
        for row in roofline.table(records, mesh).splitlines():
            log(f"[dryrun table] {row}")
    for rec in records:
        a = roofline.analyze_record(rec)
        log(f"[dryrun table] {a['arch']} x {a['shape']} x {a['mesh']}: "
            f"{a['dominant'][:-2]}-bound - {roofline.what_moves_it(a)}")
    total = time.perf_counter() - t0
    log(f"[dryrun] phase done in {total:.1f} s (held cells "
        f"{t_held:.1f} s): " + json.dumps(
            {k: [h[k] for h in held]
             for k in ("cell", "flops_dry_run", "flops_card", "step_ms",
                       "bound_ms", "predicted_peak", "measured_peak")}))
    if len(records) != len(DRYRUN_CELLS):
        raise AssertionError(f"{len(records)} records in {out_dir}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--edges", type=int, default=1 << 20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--tuning-out", default=os.path.join(
        HERE, "chiprun_out", "tuning"),
        help="where --tuning-only writes its sweep's record")
    ap.add_argument("--tuning-only", action="store_true",
                    help="build, sweep every launch knob, write the "
                    "sweep's record and stop")
    ap.add_argument("--dryrun-out", default=os.path.join(
        HERE, "dryrun_out", "smoke"),
        help="where the [dryrun] phase writes its records")
    ap.add_argument("--dryrun-only", action="store_true",
                    help="run the [dryrun] phase alone and stop")
    ap.add_argument("--mesh-only", action="store_true",
                    help="run the [mesh] phase alone and stop")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2

    from repro_torch.core import synthetic
    from repro_torch.kernels import (
        KERNELS, interpret_mode, launch_counts, ops, reset_launch_counts,
    )
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.item_index import rules_with_member
    from repro_torch.kernels.rank import topk_rank_batch
    from repro_torch.kernels.rule_search import rule_search_fused
    from repro_torch.kernels.trie_reduce import trie_reduce_columns
    from repro_torch.serve import TrieQueryEngine

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)
    try:
        interpret_mode(dev)
    except ValueError as exc:
        # REPRO_TORCH_FORCE_INTERPRET asks for the plain versions
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    if args.dryrun_only:
        dryrun_phase(args, dev, smi)
        return 0
    if args.mesh_only:
        mesh_phase(args, dev, smi)
        return 0

    # -- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    probe = start_probe_build()
    try:
        _build.build_all()
    except BaseException:
        if probe[0] is not None:
            probe[0][0].kill()
            probe[0][0].wait()
        raise
    chase = load_probe(probe)
    log(f"[build] nvcc {sorted(_build.SIGNATURES)} and the latency probe in "
        f"{time.perf_counter() - t0:.1f} s -> {_build.build_info['dir']}")
    for name, text in _build.build_info["ptxas"].items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas {name}] {line.strip()}")

    # -- 2. the trie ---------------------------------------------------
    t0 = time.perf_counter()
    arrs = synthetic.synthetic_csr_trie(args.edges, seed=args.seed)
    frozen = synthetic.frozen_from_arrays(arrs)
    engine = TrieQueryEngine(frozen, device=dev)
    dt = engine.dt
    n = frozen.n_nodes
    log(f"[trie] {n} nodes, {frozen.n_edges} edges, max_fanout "
        f"{frozen.max_fanout}, max_postings {frozen.max_postings}, "
        f"{dt.nbytes()} resident bytes, built in "
        f"{time.perf_counter() - t0:.1f} s")

    queries, ant_len, pairs, prefixes, items = query_traffic(arrs,
                                                            args.seed)

    dfs = ops.dfs_rank_arrays(dt)
    dfs["_device_trie"] = dt
    ia = ops.item_rank_arrays(dt)
    edges = ops.edge_metric_arrays(dt)
    los, his, _ = ops.prefix_ranges(frozen, prefixes, dt=dt)
    q_t = torch.as_tensor(queries, device=dev)
    al_t = torch.as_tensor(ant_len, device=dev)
    plos, phis, qitems = ops._posting_slices(ia["item_offsets"], items)
    plos_t = torch.as_tensor(plos, device=dev)
    phis_t = torch.as_tensor(phis, device=dev)
    qitems_t = torch.as_tensor(qitems, device=dev)

    # written between timed calls: the L2 cold for every device time
    l2_flush = torch.empty((L2_FLUSH_BYTES // 4,), dtype=torch.float32,
                           device=dev)

    # -- 2b. the launch knobs: the sweep (--tuning-only), else the config --
    tuning_phase(args, dev, smi, engine, frozen,
                 (queries, ant_len, pairs, prefixes, items), l2_flush)
    log(f"[tuning] phase done at {time.perf_counter() - t_start:.1f} s")
    if args.tuning_only:
        return 0

    def tie_heavy(cols):
        return [torch.round(c * 10) / 10 for c in cols]

    # -- 3. kernel vs plain version at full size -----------------------
    t0 = time.perf_counter()
    errs = {name: [] for name in KERNELS}
    rank_cols = [dfs["support"], dfs["confidence"], dfs["lift"]]
    for cols, tag in ((rank_cols, "plain"), (tie_heavy(rank_cols), "ties")):
        for metric in METRICS:
            # k = 1500 passes the 1024-position tile: the chunk lists then
            # live in global scratch
            for k in ((10, 100, 1500) if metric == "confidence" else (10, 100)):
                kw = dict(k=k, metric=metric, min_depth=1)
                check_same(
                    f"topk_rank_batch {tag} {metric} k={k}",
                    topk_rank_batch(*cols, dfs["depth"], los, his, **kw),
                    ref.topk_rank_batch_ref(*cols, dfs["depth"], los, his,
                                            **kw),
                    errs["topk_rank_batch"])
    # duplicate, nested, empty and out-of-bounds ranges in one call: each
    # range is ranked once, and a duplicate's row is its first copy's
    dup = torch.tensor(
        [[0, n], [1024, 4096], [1000, 4120], [3, 1027], [2048, 2050],
         [5, 5], [-9, 3000], [n - 700, n + 50], [n + 1, n + 9],
         [1024, 4096], [0, n]], dtype=torch.int32, device=dev)
    d_los, d_his = torch.cat([los, dup[:, 0]]), torch.cat([his, dup[:, 1]])
    same_rows = [(0, 8), (0, len(prefixes)), (len(prefixes) + 1,
                                              len(prefixes) + 9)]
    for cols, tag in ((rank_cols, "plain"), (tie_heavy(rank_cols), "ties")):
        for k in (10, 100, 1500):
            kw = dict(k=k, metric="confidence", min_depth=1)
            got = topk_rank_batch(*cols, dfs["depth"], d_los, d_his, **kw)
            check_same(
                f"topk_rank_batch duplicate ranges {tag} k={k}", got,
                ref.topk_rank_batch_ref(*cols, dfs["depth"], d_los, d_his,
                                        **kw),
                errs["topk_rank_batch"])
            for a, b in same_rows:
                check_same(f"topk_rank_batch duplicate row {b} of {a}",
                           (got[0][b], got[1][b]), (got[0][a], got[1][a]),
                           errs["topk_rank_batch"])
    p_cols = [ia["p_support"], ia["p_confidence"], ia["p_lift"]]
    for metric in METRICS:
        kw = dict(k=10, metric=metric, min_depth=1)
        check_same(
            f"topk_rank_batch posting ranges {metric}",
            topk_rank_batch(*p_cols, ia["p_depth"], plos_t, phis_t, **kw),
            ref.topk_rank_batch_ref(*p_cols, ia["p_depth"], plos_t, phis_t,
                                    **kw),
            errs["topk_rank_batch"])
    m_cols = [ia["support"], ia["confidence"], ia["lift"]]
    # 56 random items and the last 8 (duplicates, -1, an absent id, fixed)
    sel = torch.as_tensor(np.r_[0:56, len(items) - 8:len(items)],
                          device=dev)
    for cols, tag in ((m_cols, "plain"), (tie_heavy(m_cols), "ties")):
        for role in ROLES:
            for metric in METRICS:
                # min_depth 0: the root is a member of the item -1's
                # consequent row (the traffic's absent items)
                for k, min_depth in (((10, 1), (100, 1), (1500, 1), (10, 0))
                                     if metric == "confidence"
                                     else ((10, 1),)):
                    args_m = (*cols, ia["depth"], ia["node_item"],
                              ia["post_lo"], ia["post_hi"], plos_t[sel],
                              phis_t[sel], qitems_t[sel])
                    kw = dict(k=k, metric=metric, min_depth=min_depth,
                              role=role)
                    check_same(
                        f"rules_with_member {tag} {role} {metric} k={k} "
                        f"min_depth={min_depth}",
                        rules_with_member(*args_m, **kw),
                        ref.rules_with_ref(*args_m, **kw),
                        errs["rules_with_member"])
    e_args = (edges["child_offsets"], edges["edge_item"], edges["edge_child"],
              edges["edge_conf"], edges["edge_sup"], edges["edge_lift"],
              q_t, al_t)
    got = rule_search_fused(*e_args, max_fanout=edges["max_fanout"])
    want = ref.rule_search_fused_ref(*e_args, max_fanout=edges["max_fanout"])
    check_same("rule_search_fused", [got[k] for k in want],
               [want[k] for k in want], errs["rule_search_fused"])
    for cols, tag in (((dt.support, dt.confidence), "hub"),
                      (tie_heavy((dt.support, dt.confidence)), "hub ties")):
        check_reduce(tag, *cols, dt.node_depth, errs["trie_reduce_columns"])
    torch.cuda.synchronize()
    log(f"[parity] every kernel equals its plain version "
        f"({time.perf_counter() - t0:.1f} s)")

    # -- 4. the main path through TrieQueryEngine ----------------------
    reset_launch_counts()
    t0 = time.perf_counter()
    role_launches = {}
    res = drive_engine(engine, queries, ant_len, pairs, prefixes, items,
                       role_launches)
    torch.cuda.synchronize()
    launches = launch_counts()
    log(f"[main path] {time.perf_counter() - t0:.2f} s, launches {launches}")
    require_launched("main path", launches, PLAIN_QUERY_KERNELS)
    check_answers("main path", res, engine, queries, ant_len, pairs,
                  prefixes, items)
    found = res["search"]["found"].cpu().numpy()
    if not found[0::2].all():
        raise AssertionError("a real root path was not found")
    log("[main path] answers equal the oracles")

    # -- 5. timing -----------------------------------------------------
    reps = args.reps
    op_ms = time_ops(engine, queries, ant_len, prefixes, items, reps)
    log("[ops ms] " + json.dumps(op_ms))

    m_rows = member_kernel_rows(ia, items, dev)
    r_args = (*rank_cols, dfs["depth"], los, his)
    r_kw = dict(k=100, metric="confidence", min_depth=1)
    f_kw = dict(max_fanout=edges["max_fanout"])
    red_args = (dt.support, dt.confidence, dt.node_depth)
    calls = {
        "topk_rank_batch": (
            lambda: topk_rank_batch(*r_args, **r_kw),
            lambda: ref.topk_rank_batch_ref(*r_args, **r_kw)),
        "rule_search_fused": (
            lambda: rule_search_fused(*e_args, **f_kw),
            lambda: ref.rule_search_fused_ref(*e_args, **f_kw)),
        "trie_reduce_columns": (
            lambda: trie_reduce_columns(*red_args),
            lambda: ref.trie_reduce_ref(*red_args)),
    }

    # the least time the card needs for each call's work on this data:
    # the columns each score reads (score_bytes), once per covered position
    span = (his - los).clamp(min=0)
    main_steps, cons_steps = walk_steps(dt, q_t, al_t)
    work = {
        "topk_rank_batch": (
            score_bytes(r_kw["metric"], *rank_cols[:2])
            * covered_positions(n, los, his)
            + 8 * los.numel() + 8 * los.numel() * r_kw["k"],
            3 * float(span.sum())),
        "rule_search_fused": (
            queries.size * 4 + ant_len.size * 4 + 24 * queries.shape[0]
            + 28 * main_steps + 20 * cons_steps,
            queries.shape[0] * 8),
        "trie_reduce_columns": (12 * n + 20, 4 * n),
    }
    sources = {
        "topk_rank_batch": ("cuda", "src/repro_torch/kernels/csrc/rank.cu",
                            "src/repro/kernels/rank.py:178"),
        "rule_search_fused": (
            "cuda", "src/repro_torch/kernels/csrc/rule_search.cu",
            "src/repro/kernels/rule_search.py:333"),
        "trie_reduce_columns": (
            "cuda", "src/repro_torch/kernels/csrc/trie_reduce.cu",
            "src/repro/kernels/trie_reduce.py:50"),
    }
    # "ms" and "plain_ms" are device time from a profiler trace, the 50 MB
    # L2 flushed before each call: the wrapper's own kernels
    # (KERNEL_NAMES), and every kernel the plain version ran;
    # "whole_call_ms" is the wrapper's call on plain_ms's scope (its own
    # casts, clamps and reductions too); "call_ms" and "plain_call_ms" are
    # CUDA events around one call, host launch work included, which is
    # all a call shorter than its launches shows
    rows = [kernel_row(name, kern, plain, work[name], sources[name],
                       launches[name], max(errs[name]), reps, l2_flush.zero_)
            for name, (kern, plain) in calls.items()]
    # the descent kernels' latency floor: their longest chain of dependent
    # load rounds on these rows x one load's latency on this card
    lat = load_latency_ns(chase, dev, l2_flush.zero_, args.seed)
    log(f"[latency] dependent load: {lat['cold_ns']:.1f} ns cold (device "
        f"memory), {lat['warm_ns']:.1f} ns warm (L2); pointer chase of "
        f"{CHASE_STEPS} loads")
    latency_floor(rows[list(calls).index("rule_search_fused")],
                  chain_rounds(ref.rule_search_fused_group_ref, e_args), lat)
    rows.append(reduce_rows(rows[list(calls).index("trie_reduce_columns")],
                            dt, dev, l2_flush, reps, args.seed))
    rank_row = rows[list(calls).index("topk_rank_batch")]
    log(f"[kernel] topk_rank_batch: {rank_row['ms']:.4f} ms device against "
        f"its bound {rank_row['bound_ms']:.5f} ms and the earlier design's "
        f"{EARLIER_RANK_MS} ms (chunked sweep, same shape, H100 80GB HBM3 "
        f"at 700 W)")
    # the membership kernel per role; on this plain layout the consequent
    # role of the main path ranks posting-ordered columns with the rank
    # kernel, so its row shows no main-path launch
    rows[2:2] = member_rows(ia, m_rows, 10, role_launches,
                            errs["rules_with_member"], reps, l2_flush.zero_,
                            "rules_with_member")

    # -- 6. construction: mine -> trie -> annotate, then serve it -------
    row, retail, retail_n_tx = construction_phase(args, dev, l2_flush)
    rows.append(row)
    log(f"[construct] phase done at {time.perf_counter() - t_start:.1f} s")

    # -- 7. the compressed layout: the chain trie, then the retail trie --
    comp_rows, chain = compressed_phase(args, dev, l2_flush, retail,
                                        retail_n_tx, lat)
    rows.extend(comp_rows)
    descent_cases(dev, retail, retail_n_tx, args.seed)
    log(f"[compress] phase done at {time.perf_counter() - t_start:.1f} s")

    # -- 8. the seed layout: the full sweep on the query-path trie -------
    rows.append(seed_phase(args, dev, l2_flush, (arrs, frozen)))
    log(f"[seed] phase done at {time.perf_counter() - t_start:.1f} s")

    # -- 9. streaming: inserts and refreezes over a retail base ---------
    stream_parts = streaming_phase(args, dev, smi)
    log(f"[stream] phase done at {time.perf_counter() - t_start:.1f} s")

    # -- 10. the serve loop: the 2^20 trie, then the retail stream -------
    serve_phase(args, dev, smi, frozen, stream_parts)
    log(f"[serve] phase done at {time.perf_counter() - t_start:.1f} s")

    # -- 11. the sharded trie: P = 1, 2, 4 against one device -----------
    shard_phase(args, dev, smi, engine,
                (queries, ant_len, pairs, prefixes, items), chain,
                stream_parts)
    log(f"[shard] phase done at {time.perf_counter() - t_start:.1f} s")

    # -- 12. observability: the launch profiler on the main path --------
    profiler_pass(engine, queries, ant_len, pairs, prefixes, items, res)

    # -- 13. the LM serving path: smollm-360m at full width -------------
    lm_phase(args, dev, smi)

    # -- 14. MLA and MoE: DeepSeek-V2-Lite-16B at full width and depth ---
    ds_held = [ds_phase(args, dev, smi)]

    # -- 14b. the placed LM paths on a one-rank process mesh -------------
    mesh_phase(args, dev, smi, ds_held)

    # -- 15. Mamba2: mamba2-370m at full width and depth, Jamba's unit ----
    mamba_phase(args, dev, smi)

    # -- 16. training: smollm-360m at full width and depth -------------
    train_phase(args, dev, smi)
    t0 = time.perf_counter()
    train_long(args, dev, smi)
    log(f"[train long] done in {time.perf_counter() - t0:.1f} s")

    # -- 17. the dry run: held against the card, then the production cells
    dryrun_phase(args, dev, smi)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
