#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card.

    python3 chip_smoke.py [--out FILE]

Phases, in order; any failure raises and the script exits non-zero.
On the card every ``RecEngine`` micro-batch replays the captured CUDA
graph of its (path, bucket) pair, which runs no Python: the kernel
wrappers count the forwards of ``warmup()`` (an eager pass and a capture
a pair), and a replayed micro-batch's kernels are taken by name from the
profiler's trace of the card and held equal to those counts of one
forward. Each serving phase zeroes the counts just before its engine's
``warmup()``, and fails if serving its requests moves them.

1. Card: print the card's name and power limit (nvidia-smi), build the
   CUDA kernels from ``src/repro_torch/kernels/csrc`` and print the build
   time and ptxas's report.
2. Kernels: at the serving path's shapes (bucket 32) and at edge shapes,
   hold each kernel against its plain PyTorch version on the card under
   a stated tolerance; time kernel, plain version, the one PyTorch call
   that computes the same function (``library_ms``, a yardstick the port
   never calls) and the least time the card could take (``bound_ms``),
   at bucket 32 and at 2048 samples, with CUDA events (median).
   ``fused_cached_segment_sum`` runs over a K = 4,096 hot cache ranked by
   a warm trace; on a coherent cache it must equal the in-order loop and
   the ``fused_segment_sum`` kernel over the arena bit for bit (the
   hot/cold law, on the card), and on a stale one its plain version; its
   stage entry (the hit split inside the kernel, one launch) must equal
   the TPU kernel's form bit for bit, and is timed beside the split's
   torch ops and the kernel it replaced; both at every tile depth the
   plan picks, on bags longer than a tile, at D = 6, 16 and 48 and on an
   arena 4 bytes off 16-byte alignment.
   ``fused_segment_sum`` must also equal a loop that adds a bag's rows
   in order of j bit for bit, at every tile depth its plan picks (8 to
   64 rows): at the serving path's shapes, on bags longer than one tile
   (70 to 200 rows), at D = 6, 16 and 48 and on a table 4 bytes off
   16-byte alignment.
   ``interaction``'s
   stage (the features, the kept pairs and the concat in one launch) and
   its backward (one launch) run at B = 1, 9, 32 and 2048 with F = 6 and
   D = 32 and at F = 51, D = 16: within tolerance of their plain
   versions, the features exact, two launches and a batch's first
   samples alone bit for bit, one kernel each way in the profiler, timed
   beside the five-op composition it replaced and its autograd.
   ``embedding_bag`` at DLRM(1)'s fixed shapes (and L = 1 through
   ``gather_rows``, L = 80, D = 16 and 48) and ``sparse_lengths_sum`` on
   poisson bags (empty bags, a padded tail, a bag longer than ``max_l``)
   must also equal ``fused_segment_sum`` over the same bags bit for bit,
   and two launches must give the same bits: at every depth their plans
   pick (``embedding_bag`` 1 for ``gather_rows`` and 8 to 64, long bags
   of 80, 130 and 200 in equal chunks; ``sparse_lengths_sum`` 8 to 40,
   bounds up to 200 in chunks of 40), on a table whose row 0 is 1e6 and
   no bag's id (a read
   past a bag's end that was added would show), with a padded tail of
   out-of-range ids (-1 and V + 7) that must never be loaded, and for
   ``sparse_lengths_sum`` at the host tier's bound (``HostTier.reduce_flat``,
   ``max_l`` the stream's length, equal to its ``reduce_dense``); each
   kernel's plan and ptxas's registers and spills are printed.
   ``gemm`` runs every DLRM(1) layer at M = 1, 8, 32, 64, 65 and 2048
   (the cluster split-K tiling, and 3xTF32 for the 512 x 256 layers
   above 64 rows) and the 33 x 70 x 65 edge case;
   two launches must give the same bits, and at M <= 64 the first 1, 8
   and 31 rows of a product must equal the product of those rows alone.
3. Serve: DLRM(1) at full size (5 x 200,000 x 32 fp32 arena, MLPs
   13-512-256-32 and 47-512-256-1) from a seeded generator, served by
   ``RecEngine(max_l=40, max_batch=32)`` for 512 requests. Every serving
   kernel must have launched on that run (warmup's passes and captures,
   each kernel's count per forward times two per pair), a replayed
   micro-batch must run the same kernels (profiler), the probabilities
   must be
   finite in (0, 1) and equal, within tolerance, those of the port's CPU
   path on a CPU copy of the same params. Then a few more micro-batches
   say where the time goes: device time per kernel group and the
   device's idle share (torch.profiler on the card), host time per stage
   (on the host).
4. Train: DLRM(1) at full size, batch 32, both modes of
   ``make_train_step_ragged`` (the row-wise sparse step and the
   dense-gradient baseline). (a) ``sls_grad_table`` against its plain
   version at 6,400 and 409,600 positions of the dense id form, on the
   sparse step's unique-row ids and at the kernel's schedule edges (runs
   longer than a chunk, runs on both sides of the edges between blocks'
   rows, one row for every position, ``skip_row`` inside a hot run,
   tables smaller than one block's rows, D = 1, 6 and 48, unaligned
   ids): two launches bitwise equal, and equal bit for bit to the plain
   version on the CPU, which adds in the same order; the wrapper's
   device time by kernel (its one kernel and nothing else) and its bound
   with the whole output written, at both sizes and for the sparse
   step's row gradients; and ``gemm_nt`` (dx) and ``gemm_tn`` (dw) at the
   backward shapes at batch 32 and 2048, each against its plain version
   and timed against ``torch.matmul`` on the transposed view. (b) A few steps
   of each mode from one set of params on the same numpy batches, each
   on the card and on the CPU path from a copy of the card's state:
   losses, touched rows, MLP params and touched arena rows. (c) Time per step (CUDA events), device busy and
   idle share (torch.profiler), launches per step, the kernels on the
   card and ``gemm``'s device ms per step. (d) The main path:
   an uncached ``OnlineTrainer`` on the card takes those steps again;
   every kernel must launch exactly as often as the step claims, and the
   run must repeat (b)'s card run bit for bit; its kernels on the card
   per step are printed. Then the training
   launcher takes three steps of each mode on the card.
5. Serve cached: the same 512 requests through
   ``RecEngine(source="cached", cache_k=4096)``. Every probability must
   equal the fp plan's of phase 3 bit for bit and the CPU path's within
   tolerance, the hit rate must equal a numpy recount of the served ids,
   and each forward must launch ``fused_cached_segment_sum`` once,
   through its stage entry, and ``fused_segment_sum`` never; then host
   and device time and the kernels on the card per micro-batch. Then the
   int8 cold arena (``quantize_cold=True``).
6. Online refresh: a caching ``OnlineTrainer`` (K = 4,096, a rebuild
   every 10 steps) takes 30 steps of drifting Zipf traffic at batch 32
   while one engine serves. After each rebuild the engine adopts the
   published cache with the params copy and must serve the uncached
   forward on the trainer's params bit for bit; three steps later,
   unsynced, it must still serve the forward as of the sync; a stale
   artifact must be refused; a fresh engine adopting
   ``publish_source()`` must serve the live forward. No swap recaptures:
   the engine's graphs of warmup serve every batch.
7. Fixed serving and the hybrid pipeline: 512 fixed-L requests (L = 20)
   through ``RecEngine(source="fixed")``: one ``embedding_bag`` launch
   per forward (``bag_plan``: 160 bags of 20 rows, one chunk of 24)
   and no ``fused_segment_sum``, probabilities within tolerance of the
   CPU path and equal bit for bit to the ragged fp plan's on the same
   bags. The flat route: the phase 3 requests served through a source
   that implements ``reduce_flat`` alone (the base class's fallback onto
   ``sparse_lengths_sum``, one launch a micro-batch, ``sls_plan``: one
   chunk of 40), equal bit for bit to phase 3's probabilities. The
   two-stream pipelines
   (``pipelined_forward``, ``pipelined_forward_ragged``, 4 micro-batches)
   against the single-shot forwards at bucket 32 and at 2048 samples,
   their launches, device time, idle share and whether the two streams'
   kernels overlap; then the serve launcher with and without
   ``--pipelined``.
8. Fixed training: 4 steps of ``make_train_step`` at batch 32, card
   against the CPU path from the card's state each step, two card runs
   equal bit for bit, launches, kernels and time per step, and three
   steps of the training launcher without ``--ragged``.
9. Tiered storage: ``fused_int4_segment_sum`` against its plain version
   (within 1e-6 of each bag's sum of |terms|) and against
   ``fused_segment_sum`` over ``int4_unpack`` (bit for bit) at the
   serving shape, at 2048 samples, at every tile depth its plan picks,
   on long bags, at D = 6 to 48 and on a table 4 bytes off 16-byte
   alignment, with its times and bound; the phase 3 requests served on
   ``SourceSpec(tiers=TierPolicy(hot=4096, warm=65536, cold="int4"))``
   (the CPU path within tolerance, pooled bags within the quantization
   bound of the fp arena, all-hot bags equal to the fp plan bit for bit)
   and on a host cold tier (hot 4096, no warm tier, a 16,384-row staging
   arena: the fp plan within tolerance, one-tier bags bit for bit, hits +
   misses == touches, no stream synchronize on the staging path); then a
   tiered ``OnlineTrainer`` (migration every 10 steps) takes 30 steps
   feeding one engine: the hot tier exact after every step, each
   migration equal to a full ``build_tiered``, post-sync probabilities
   equal to the forward over the trainer's source, the engine's tensors
   at fixed addresses.
10. LM serving: (a) ``flash_attention`` against its plain version in
   bf16 (within 2^-7 (1 + |plain|)) at smollm-360m's heads at S = 2048
   and 4096 (and at 2048 without the causal mask), danube's hd 80 with
   a window of 512, qwen's hd 128, the smoke configs' hd 16 and 20 and
   at S = 100 and 2049; at the four timed shapes two launches must give
   the same bits, and its times (warm, back to back and one call at a
   time, and with a cold L2: a 64 MB buffer written between single
   calls) and TFLOP/s stand beside the
   plain version's, ``F.scaled_dot_product_attention``'s and the bound
   (bf16 operations of the band); (b) smollm-360m at
   full width (32 layers, d 960, vocab 49,152, bf16, seeded weights):
   ``api.prefill`` at S = 2048 and 4096 launches the kernel once a layer
   and nothing else of the port, gives finite logits, and its tokens/s,
   device time by group, idle share and the kernel's device time a
   launch (beside its time alone) are measured; (c) on one prompt
   of 2,048 tokens, the card's prefill, forward and decode after a
   prefill of all but the last token at 16 of the 32 layers (the depth
   cut keeps the whole script within its time limit), and a 2-layer
   prefill, each
   within twice the CPU bf16 path's own error of the CPU path's fp32
   logits, with the same greedy token (or a tie within that); (d) a
   ``DecodeEngine`` serves 8 requests in waves of 4 slots (16-token
   prompts, 16 new tokens; latency, tokens/s, launches per decode step),
   then the serve launcher serves smollm-360m at full width.
11. Graphed serving, every plan (fp, cached, int8 cold, fixed, the flat
   route through a registered ``reduce_flat``-only source, tiered int4,
   tiered host) on an engine of buckets 16 and 32: ``warmup()`` captures
   one graph a pair (and, on the fp plan after ``enable_downgrade``, the
   downgrade path's); 512 requests in micro-batches of 9 to 32 through
   ``dispatch``/``settle``, two in flight, every probability equal bit
   for bit to the eager serve step (``dlrm.make_ragged_serve_step`` /
   ``make_serve_step``) on the same padded batch; no capture, cold
   dispatch or wrapper launch after ``warmup()``; a replayed
   micro-batch's kernels by name (profiler) equal to one forward's
   counts at capture; per plan the host ms a micro-batch, p50/p95/p99
   at depth 2, device busy ms, idle share, kernels a replay and the
   graph pool's bytes. Then a params assignment, ``update_source`` and
   ``update_cache`` (where the plan has them): no capture, and a few
   micro-batches equal bit for bit to the eager step on the new params
   and source. The downgrade path: bit for bit against the eager step
   over the int8 source and within 0.05 of the primary path, its
   source re-quantized in place after the params assignment. Last,
   ``retune_buckets`` after traffic of one size: the new bucket's graph
   captured, the dropped one's freed, none cold after.
12. Table groups: ``dlrm_het2`` at full size (26 tables of 2,307 to
   223,260 rows, dims 8/16/32/64, 104.2 MB of fp32 rows; poisson bags of
   mean 38, max 76; batch 32; seeded weights). (a) The kernels at the
   shapes the group sends them: ``fused_segment_sum`` and the cached stage
   over members of width 8, 16, 32 and 64, against their plain versions
   and bit for bit against the in-order loop, with device ms a call;
   ``interaction`` at F = 27 both ways; ``sls_grad_table``'s table
   gradient on the smallest table and a 64-wide one, bit for bit against
   the CPU. (b) Two plans on buckets 16 and 32: the fp group
   (``dlrm.group_source``) and the mixed plan (``dlrm.table_plans``: the
   13 tables of highest alpha cached, K = min(2048, rows / 4) ranked by a
   4-batch ``group_trace_counts``, the three of over 100,000 rows int8,
   ten plain fp). Each: ``warmup()`` captures one graph a pair and a
   forward launches one kernel a member as its plan says; the grouped
   lookup equals ``lookup_bags_per_table`` bit for bit; 512 requests at
   depth 2 bit for bit against the eager serve step and within 1e-5 of
   the CPU path; per-table hits and lookups equal a numpy recount; no
   capture, cold dispatch or wrapper launch after ``warmup()`` or a
   ``replace_member`` swap; a replay's kernels by name equal its
   capture's; host ms, p50/p95/p99, device busy, idle share, kernels and
   device ms by group a micro-batch; on the fp plan the downgrade group
   (one int8 member a table) within 0.05 of the primary path. (c) Four
   sparse and four dense-gradient group steps at batch 32, card against
   CPU from the same state under phase 4's laws (touched rows exact a
   table, the tables' budget a table), the wrappers' launches a step by
   name, step ms, kernels and device ms by group.
13. The serving plane, every check a hard one: (a) on DLRM(1)'s fp and
   cached plans, a ``Telemetry()`` and a ``Telemetry.disabled()`` engine
   serve the same 512 requests in turns through dispatch and settle:
   probabilities equal bit for bit, ``rec_requests_total`` 512,
   ``rec_batches_total`` 16, ``rec_cold_compiles_total`` 0, the latency
   histogram's count 512 and its p50/p99 equal to ``np.percentile`` over
   its samples, nothing recorded by the disabled engine, host ms a
   micro-batch of each and their ratio; a replay's kernels by name, the
   disabled cached one's the instrumented one's minus the hit probe's.
   (b) On the cached plan, a cache swap's event carries the outgoing
   version's hits and lookups (a numpy recount), ``since_swap`` restarts,
   a stale broadcast is refused with a ``stale_rejected`` event, and no
   capture follows. (c) ``Telemetry(device_stages=True)`` serves the 512
   requests through the three stages, bit for bit the graph replay's,
   with ``stats()["stages"] == live_fig5()``, printed beside phase 3's
   profiler split. (d) The reference's open-loop scenario at full size:
   ``t_batch`` the median of 10 full-bucket dispatch + settle calls,
   ``sla_ms`` 3 t_batch, 3,000 Poisson arrivals (seed 17) at twice the
   capacity through the synchronous loop and through ``SlaScheduler``
   (max_queue 128, depth 2), then a diurnal drifting-Zipf trace near
   capacity: served + shed = n, one shed event and flag a shed request,
   the primary path within 1e-6 of the synchronous loop (bit equality
   printed), downgraded requests within 0.05; nominal and achieved qps,
   p50/p99 of both loops, the tightening, shed and downgrade fractions,
   queue waits. (e) ``dlrm_het2``'s mixed plan under the scheduler, 800
   Poisson requests at 1.5 x its capacity: exact accounting, downgraded
   micro-batches from the per-member int8 source, per-table hits after
   ``drain()`` equal to a numpy recount. (f) In phases 6 and 9: the
   trainer's counters and events, the host store's ``rec_prefetch_*``
   counters against ``stats()["prefetch"]``, snapshots through
   ``json.dumps``. The launch counts are zeroed before (a) and read after
   (e). Phases 3 to 7 run with ``obs.enable_stage_annotations(True)``,
   whose host spans they print.
14. The fleet, ``dlrm_het2`` at full width: (a) ``FleetRunner`` (one
   ``OnlineGroupTrainer`` with a K = 512 hot cache a table and a rebuild
   every 4 steps at batch 32, poisson bags of mean 38 and max 76; two
   replicas of an A and a B engine each and two reference engines, all
   graphed on bucket 32; a ``CheckpointManager`` in a temporary
   directory) runs six rounds through the reference bench's chaos plan
   (``FaultPlan(seed=6, drop=0.3, dup=0.3, delay=0.6, max_delay=3)``):
   stale deliveries injected == refused, drops and dups above 0, the
   ``hit_dip`` beside each engine's hit rate by version; ``recover(k=3)``
   bit for bit on both models within 3 bumps and no capture after
   ``warmup()``; replica 0 restarted from ``restore_source`` and exact
   again; ``run_trainer_with_crash(extra_steps=6, fail_after=3,
   ckpt_every=2)`` whose params equal bit for bit an uninterrupted
   control trainer's on the same step-seeded batches; per round train,
   serialize, ``save_source`` and deliver ms and the blob's bytes,
   ``recovery_s``, a checkpoint's save and restore ms and bytes, the
   wrappers' launches from the fleet's construction to the resume. (b)
   The group trainer with phase 12's mixed plan, its two largest tables
   tiered (host and int4 cold), 4 steps on the card against the CPU path
   from the card's params and optimizer state (histograms, hot sets,
   tier maps and dirty masks exact, hot rows under phase 4's budget),
   its group served through one graph synced after every step, bit for
   bit against the eager step, with the engine's own host store.
15. LM training, smollm-360m at full width: (a) the flash op's backward
   (a recompute through ``models.layers._sdpa_chunked``, no kernel of its
   own) at smollm-360m's heads at S = 2048 and 4096: equal bit for bit to
   autograd through ``_sdpa_chunked`` on the same inputs and upstream
   gradient, two backward passes equal, the forward within phase 10's
   tolerance of the plain version; the backward's and the op's forward +
   backward times beside ``F.scaled_dot_product_attention``'s forward +
   backward and the bound (five bf16 products a pair of the band). (b)
   Two layers at full width, one ``make_train_step`` step on one
   ``LMSynthetic`` batch of 2,048 tokens on the card and on the CPU path
   (bf16 and fp32) from copies of the card's params: loss, grad norm and
   every leaf's clipped gradient and update within twice the CPU bf16
   step's own error against the fp32 step (budgets printed); its CPU
   passes run on the CPU reference worker (below), handed in after
   phase 16 so that they run beside 17 to 19 and not beside 16's
   host-bound gloo ranks, its check at the end of 19. (c) The main
   path: the model at full width, 4 of its 32 layers (the depth cut
   keeps the whole script within its time limit),
   ``layerwise(adamw(3e-4))``, grad clip 1.0, fed by a ``Prefetcher`` of
   ``LMSynthetic`` batches placed on the card by ``make_placer``: 3 timed
   steps and a profiled one at 2,048 x 4 and at 4,096 x 2 in two
   micro-batches, each step launching the flash kernel 2 x 4 times a
   micro-batch (forward and remat) and nothing else of the port, losses
   finite, every param moved; a gradient pass with remat off launches it
   4 times and gives the first step's loss bit for bit; step ms (CUDA events), tokens/s, peak memory, kernels, device ms
   by group (flash forward, the backward's recompute, matmul, other) and
   the idle share. (d) The training launcher at full width (``--arch
   smollm-360m --seq-len 2048``): 3 steps uninterrupted against 2 steps
   with a checkpoint and a ``--resume`` run of the third, final params and
   optimizer state equal bit for bit.
16. The row-sharded path, DLRM(1) at full width (its 1,000,001 arena
   rows padded to 1,000,002 and 1,000,004), on 2 and 4 gloo ranks that
   share the card (``distributed.spawn``; NCCL refuses two ranks on one
   device), each rank's block its rows and a zero sentinel row: (a) in
   this process, ``fused_segment_sum`` and ``embedding_bag`` over the
   first and the last rank's block with every id the rank does not own on
   the sentinel, against their plain versions (and the in-order loop,
   ``fused_segment_sum``, bit for bit), the sharded step's row gradients
   (``sls_grad_table``) bit for bit against the CPU and projected by
   ``shard_local_rows``, ``gemm`` and the interaction stage at the head's
   batch-32 shapes; then in the ranks, with the launch counts zeroed
   first and read after (b) and (c): (b) the phase 3 requests through
   ``RecEngine(source="sharded")`` and ``source="cached"`` (K = 2,048 over
   a ``ShardedArena`` cold), and 128 fixed-L requests through
   ``source="fixed"`` and (their bags) the sharded ragged plan: every
   rank's probabilities bit for bit the others', within 1e-5 of phase 3's
   (and of each other), served eagerly by construction (no capture, no
   cold dispatch, ``stats()`` saying why), and both pipelined forms on the
   mesh at bucket 32 (lookups and their all-reduces on the side stream)
   within 1e-5 of the single-shot sharded forwards; (c) 4 sharded sparse steps,
   rank 0 holding the replicated sparse step on the card from the same
   state before each: touched rows equal, loss within rtol 1e-5, params
   under phase 4's budget rule, every rank's MLP leaves bit for bit the
   others', the sentinels zero; (d) the 4 ranks save their state
   (``CheckpointManager.save(shardings=)``, unsharded on disk) and take a
   5th step; the 2 ranks restore it (rows bit for bit) and take the same
   step: within (c)'s bounds. (e) and (f) run in 4 gloo ranks on a (2,
   2) (data, model) mesh (``spawn(..., mesh_shape=(2, 2),
   mesh_axes=("data", "model"))``), the launch counts zeroed first and
   read after: (e) DLRM(1) at full width, a 64 MB block a rank (500,001
   rows of 32 fp32, replicated over 'data'): the phase 3 requests through
   the ragged, sharded and cached-over-sharded plans, within 1e-5 of phase
   3's, 128 fixed-L requests through the fixed plan (its bags split over
   'data') within 1e-5 of the sharded ragged plan, 3 dense-gradient
   fixed-L steps and 3 sparse sharded steps, each step's loss (rtol
   1e-5), MLP and touched arena rows and accumulators held against the
   one-rank step on the card from the same start, within 1e-4 after 3
   steps under phase 4's sign-flip budget (this is what catches a block
   gradient not summed over 'data'); (f) the MoE layer of kimi-k2-1t-a32b
   at full width (d_model 7168, expert_ff 2048, top-8) cut to 128 of its
   384 experts (19(c)'s cut), bf16, on 2 x 2,048 tokens (1,024 a rank):
   each rank's ("expert", "fsdp", None) block of the expert weights
   (``lm_moe.shard_moe_params``, a quarter each, the FSDP half gathered
   over 'data' in the layer), the expert-parallel ``apply_moe`` with the
   routes pinned to the one-rank run's at capacity factor 4 (no choice
   dropped, counted on both sides) against the one-rank ``apply_moe``,
   and at cf 1.25 against the one-rank emulation of the per-shard
   capacity (``_moe_local`` a rank's block of tokens), within 2e-2 of the
   reference's largest output; every rank's outputs bit for bit the
   others' in both. (g) and (h) run beside (e) and (f), started from
   threads of this process, their ranks processes of their own: (g)
   ``launch/train.py --ragged --shards 2
   --backend gloo`` for 3 steps, and ``launch/serve.py --shards 2
   --backend gloo`` for 4 batches of 32 (the ranks' probabilities bit
   for bit, the launcher checks). (h) One rank over nccl: its all-reduce
   and broadcast, a served batch through a one-shard ``ShardedArena`` and
   the step on a mesh of one, exact against the replicated path; at one
   rank the port's collectives make no call, so this exercises the NCCL
   communicator only, not the port's collectives over it. (i) In (e)'s
   ranks after (f), the launch counts zeroed first and read after: the
   LM's logical axes, tensor- and sequence-parallel over 'model' and
   data-parallel over 'data', qwen1.5-4b at full width (d 2,560, 20/20
   heads of 128, ff 6,912, vocab 151,936 untied, qkv bias) and
   smollm-360m (15/5 heads of 64: 9/6 query heads on 3/2 kv heads a
   rank), each at 2 layers, one sequence of 2,048 tokens a data rank,
   from seeded weights: prefill and (qwen) 4 decode steps, their logits
   gathered over 'model' within the bf16 floor (rtol 2e-2, atol 5e-2) of
   the one-rank path on the card, and AdamW steps (qwen 2, smollm 1):
   loss rtol 1e-4, grad norm 2e-3 (1e-2 after a step), each param block
   within 2 bf16 ulps of its leaf's scale or, where finer, phase 4's
   sign-flip rule a step; every rank's losses and grad norms the same
   bits, a data group's logits and the data replicas' blocks the same
   bits, the flash kernel launched on every rank at its local heads (and
   timed there beside the whole models' heads); each model's (2, 2)
   train state saved (unsharded on disk) and restored onto (1, 4)
   (smollm's heads split 6/3/3/3 there), each rank restoring one
   coordinate bit for bit against the part of its own blocks. (j) After
   (e)'s ranks exit, a model at a time in a start of 4 gloo ranks as
   (2, 2) of its own (the one-rank params it hands its ranks on the
   card fit beside one model's ranks, not beside (i)'s), the launch
   counts zeroed first and read after:
   the MoE and MLA decoders on the mesh, tensor-parallel attention beside
   the expert-parallel MoE on the S-sharded stream: kimi-k2-1t-a32b
   (64/8 heads of 112: 32/4 a rank; vocab 163,840 untied) and
   arctic-480b (56/8 heads of 128: 28/4 a rank; its dense residual FFN
   beside the MoE), each at 1 layer with 16 of its experts (top-k kept),
   and minicpm3-4b (MLA, 40 heads: 20 a rank, the latent cache whole on
   every 'model' rank) at 2 layers, one sequence of 2,048 tokens a data
   rank, from seeded weights, the MoE at the capacity factor E / k
   (an expert's capacity every token of the call: nothing drops, counted
   on both sides) with its routes pinned to the one-rank run's and its
   load-balance loss left out (on the mesh it is the mean of the ranks'
   own): prefill and 4 decode steps within the bf16 floor of the
   one-rank path on the card, 2 steps of each model's default optimizer
   (Adafactor for the MoEs, its factored statistics across shards; AdamW
   for minicpm3): (i)'s loss and grad-norm tolerances, each param block
   within 2 bf16 ulps plus both sides' largest moves of the leaf a step,
   each leaf's move within 3/4 of the one-rank path's, Adafactor's
   statistics within 5e-2 of a leaf's largest; (i)'s cross-rank laws,
   the flash kernel launched on every rank and held against its plain
   version at the ranks' heads (timed beside SDPA); kimi's (2, 2) layer
   stack and Adafactor state saved and restored onto (1, 4) bit for bit
   (the vocab leaves' layout is (i)'s); each
   rank's peak memory printed. The times (ms a micro-batch and a step,
   host clock) are gloo collectives through host memory: agreement
   runs, not the sharded path's speed.
   The checks of 15(b), 17, 18 and 19(b) against the CPU path: the CPU
   passes run on one thread of their own (the CPU reference worker, at
   a lower priority), in the order handed in, beside the card's work;
   each check is made when they are done, at the end of 19, and fails
   the run there. 17(c) and (d)'s cuts are made, and their passes
   handed in, before phase 15, so that those run beside 15 and 16.
17. The MoE, MLA and vision-prefix decoders at full width: (a)
   ``flash_attention`` at kimi-k2's heads, 64 query and 8 kv heads of
   112 (the wrapper pads them to depth 128), causal, at S = 2048 and
   4096 (timed as in 10(a), with the three padding copies' device time
   beside the kernel's) and at S = 100 and 2049, within 10(a)'s bound;
   (b) kimi-k2-1t-a32b (d 7168, 384 experts of 2048, top-8, vocab
   163,840 untied; seeded weights) at 1 layer (the depth cuts of 17
   keep the whole script within its time limit):
   ``api.prefill`` at 2,048
   launches the kernel once a layer and nothing else, gives finite
   logits, and its tokens/s, peak memory, device time by group (flash,
   matmul, the indexing of the MoE's dispatch and combine, other), the
   top kernels and the idle share are printed; prefill against forward
   (the same experts, logits within 2e-2) and decode after a prefill of
   all but the last token against the forward (printed at 2,048, where
   the forward's capacity drops choices; held within 5e-2 on 8 tokens,
   where it cannot), each with its routing flips and drops counted; a
   ``DecodeEngine`` serves 8 requests (10(d)'s waves), with the expert
   bytes a decode step reads against the HBM rate; (c) 16 of kimi's
   experts (top-8 kept), 1 layer (the depth cut keeps the whole script
   within its time limit): a 2,048-token prefill and a decode
   after 2,047 on the card (the hd-112 kernel) against the CPU path's
   fp32 logits within twice the CPU bf16 path's own error, and the
   card's routing flips against the CPU fp32 path's at most twice the
   CPU bf16 path's plus 1% of the (token, layer) pairs; (d) arctic-480b
   (128 experts of 4864, top-2, beside its dense residual FFN), 1
   layer: (b)'s prefill, laws and engine, and (c)'s check on 16 of its
   experts; (e) minicpm3-4b at 6 of
   its 62 layers (MLA, which runs no kernel: the chunked path at 2,048;
   the depth cut keeps the whole script within its time limit):
   (b)'s prefill, laws and engine, layer 0's absorbed decode against
   naive in fp32 at full width (1e-3, the reference's test), and (c)'s
   check at 1 layer; (f) internvl2-2b at 12 of 24 layers: 256 patch
   embeddings and 1,792 tokens (the flash kernel at hd 128 once a
   layer), (b)'s checks and (c)'s at 1 layer (the depth cuts of (c)
   keep the whole script within its time limit); (g) the serve launcher
   with ``--arch minicpm3-4b`` at full width. The launch counts are
   zeroed before and read after each prefill of (b), (d), (e) and (f).
18. The recurrent, RWKV and encoder-decoder LMs at full width: (a)
   ``flash_attention`` at recurrentgemma-9b's heads, 16 query heads and
   one kv head of 256 with its window of 2048, at S = 2048 and 4096
   (timed as in 10(a); the library call takes is_causal at 2048, where
   the window bounds nothing, and the band as a mask at 4096) and at S =
   100 and 2049, and at seamless-m4t's encoder, 16/16 heads of 64 not
   causal at its 3,200 frames (timed), each within 10(a)'s bound with
   two launches equal; ptxas's report for depth 256, which must show no
   spills; (b) recurrentgemma-9b at 14 of its 38 layers (4 (rec, rec,
   attn) groups and the tail of (rec, rec), the whole model's shape; the
   depth cuts of (b), (d) and (e) keep the whole script within its time
   limit; seeded weights): ``api.prefill`` at 2,048 and 4,096 launches
   the kernel once an attention layer (4) and
   nothing else, gives finite logits, and its tokens/s, peak memory,
   device time by group (flash, matmul, the RG-LRU scan's span, other)
   and the idle share are printed; prefill against the forward at 4,096
   (2e-2), and decode after a 4,095-token prefill (its attention caches
   rings of 2,048 slots, every position past the window) against the
   fp32 logits of the same weights within twice the bf16 forward's own
   distance from them; a ``DecodeEngine`` serves 8 requests (10(d)'s
   waves), ms and launches a step printed; (c) its first group (3
   layers), a 2,048-token prefill and decode after 2,047 on the card
   against the CPU path's fp32 logits within twice the CPU bf16 path's
   own error; (d) rwkv6-7b at 8 of its 32 layers: (b)'s checks at 2,048
   (the prefill through the chunked WKV, whose span is its own group;
   decode after 2,047 tokens, whose prefill takes the sequential form)
   and (c)'s at 1 layer; (e) seamless-m4t-large-v2 at 12 + 12 of its
   24 + 24 layers (3,200 frames): the prefill at 2,048 tokens launches
   the kernel 12 times not causal (the encoder) and 12 times causal (the
   decoder's self-attention), cross-attention taking the chunked path;
   (b)'s laws with the real memory, its engine (zero cross K/V, as the
   reference's engine serves), and (c)'s check at 1 + 1 layers (the
   depth cuts of (c), (d) and (e)'s checks keep the script within its
   time limit); (f) the
   serve launcher with ``--arch seamless-m4t-large-v2`` at full width.
   The launch counts are zeroed before and read after each counted
   prefill of (b), (d) and (e).
19. LM training of the seven families at full width, in the order
   (b)'s jobs, (d), (a), (c), then the checks against the CPU path: (a)
   the flash op's
   backward (the recompute
   through ``_sdpa_chunked``) at kimi-k2's 64/8 heads of 112, arctic's
   56/8 and internvl2's 16/8 of 128, recurrentgemma's 16/1 of 256 with
   its window of 2,048 at 2,048 and 4,096, seamless's encoder not causal
   at 3,200 and its decoder causal at 2,048: gradients equal bit for bit
   to autograd through ``_sdpa_chunked``, two passes equal, the forward
   within 10(a)'s bound, times beside SDPA's forward + backward and the
   bound; (c) timed steps at 2,048 tokens, through a ``Prefetcher`` of
   ``LMSynthetic`` batches, cfg's default optimizer (Adafactor for
   kimi-k2 and arctic, AdamW for the rest), clip 1.0: kimi-k2 and arctic
   at one layer with the largest power-of-two expert count whose
   reckoned peak leaves 10 GB free (``moe_fit``), minicpm3-4b at 6
   layers, internvl2-2b at 12 (256 patches + 1,792 tokens),
   recurrentgemma-9b at 12, rwkv6-7b at 4, seamless at 4 + 4 (3,200
   frames), and arctic at one layer and 16 experts, batch 2 in two
   micro-batches: step ms (a warm step), tokens/s, peak memory (a MoE's
   beside its reckoning), flash launches a step (2 an attention layer a
   micro-batch) against the counter and the trace's records, device ms
   by group (the recurrence's span its own) and the idle share, every
   leaf moved (but one that bf16 rounding provably freezes); kimi's
   remat-off gradient pass equal to its first step's loss and grad norm
   bit for bit; the scan's and the WKV's backward timed alone; (b) one
   train step a family at full width and one layer (recurrentgemma's
   first group, seamless 1 + 1; kimi's and arctic's experts cut to 16),
   256 tokens of the loss, batch 1, on the card in bf16, on the CPU path
   in bf16 (on the worker) and in fp32 on the card (the floor's
   reference): loss, grad norm and each leaf's gradient and update within
   twice the CPU bf16 step's own error (``update_floor``), the bf16
   paths' experts pinned to the fp32 path's layer by layer through the
   checkpoint's recompute (``layer_routes``), their own flips within
   17's budget; (d) the training launcher with ``--arch
   seamless-m4t-large-v2`` at full width and 2 + 2 of its 24 + 24
   layers: 2 steps against 1 with a checkpoint and a ``--resume`` of
   the last, bit for bit. The launch counts are zeroed before each run
   of (c) and (d). The host times of 17 to 19 are taken beside the
   worker while it runs (19(a) and (c) print whether it did); the
   card's device times do not see it.
20. Report: one JSON line of the kernels, then the device line, which is
   always the last line of the output.

Without a CUDA device it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import bisect
import concurrent.futures
import contextlib
import dataclasses
import hashlib
import json
import os
import pathlib
import queue
import re
import subprocess
import sys
import tempfile
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.dlrm import (DLRM_CONFIGS,  # noqa: E402
                                      DLRM_HET_CONFIGS)
from repro_torch.core import dlrm  # noqa: E402
from repro_torch.core import embedding_source as es  # noqa: E402
from repro_torch.core import hybrid  # noqa: E402
from repro_torch.core import sparse_engine as se  # noqa: E402
from repro_torch.data import (DLRMSynthetic, LMSynthetic,  # noqa: E402
                              Prefetcher, make_placer)
from repro_torch.fleet import FaultPlan, FleetRunner  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import embedding_gather as eg_k  # noqa: E402
from repro_torch.kernels import feature_interaction as fi_k  # noqa: E402
from repro_torch.kernels import flash_attention as fa_k  # noqa: E402
from repro_torch.kernels import fused_dispatch as fd_k  # noqa: E402
from repro_torch.kernels import gemm as gm_k  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.checkpoint.manager import (  # noqa: E402
    _full_shape as ckpt_full_shape)
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    row_shardings)
from repro_torch.distributed import collectives, sharding, spawn  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import api as lm_api  # noqa: E402
from repro_torch.models import embedding as lm_emb  # noqa: E402
from repro_torch.models import layers as lm_layers  # noqa: E402
from repro_torch.models import mla as lm_mla  # noqa: E402
from repro_torch.models import moe as lm_moe  # noqa: E402
from repro_torch.models import params as lm_params  # noqa: E402
from repro_torch.models import rglru as lm_rglru  # noqa: E402
from repro_torch.models import rwkv6 as lm_rwkv6  # noqa: E402
from repro_torch.models import transformer as lm_transformer  # noqa: E402
from repro_torch.optim import optimizers as lm_optimizers  # noqa: E402
from repro_torch.optim import (Optimizer, global_norm,  # noqa: E402
                               tree_leaves, tree_map, tree_paths)
from repro_torch.serving import (Batcher, DecodeEngine, RecEngine,  # noqa: E402
                                 Request, SlaPolicy, SlaScheduler, loadgen,
                                 requests_from_ragged_batch)
from repro_torch.storage import tiered as st  # noqa: E402
from repro_torch.storage.host_store import HostTier  # noqa: E402
from repro_torch.training import (OnlineCacheConfig,  # noqa: E402
                                  OnlineGroupTrainer, OnlineTrainer,
                                  VersionedHotCache, VersionedSource,
                                  make_drifting_zipf, unique_padded)
from repro_torch.training import sparse_optim as so  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12           # fp32 on the CUDA cores, no tensor cores

BUCKET = 32                        # the serving path's micro-batch
LARGE = 2048                       # samples of the large timing row
MAX_L = 40                         # 2 x lookups_per_table, as served
N_REQUESTS = 512
CACHE_K = 4096                     # hot rows pinned by the cached plan
WARM = 4096                        # samples of the warm trace that ranks them
ONLINE_STEPS = 30                  # phase 6: train steps, a rebuild every
REFRESH = 10                       # REFRESH of them
UNSYNCED = 3                       # steps after a sync that skip the sync
DRIFT = 64                         # rows the Zipf head moves per batch
TRAIN_STEPS = 4                    # steps of each mode, card against CPU
TIMED_STEPS = 20                   # steps per timing trial
LR = 1e-3                          # make_train_step_ragged's default
N_MICRO = 4                        # micro-batches of the pipelined forwards
TRACE_DIR = None                   # keeps the profiler traces: the --out
                                   # file's directory, when one is given

# launches per served forward on the fp plan, per train step (either
# mode), per served forward on the cached plan, per served forward on the
# fixed plan, per forward through a reduce_flat-only source, per fixed-L
# train step and per served forward on the two tiered plans: a step runs
# the forward (6 gemm, one interaction stage), dw of all six layers and
# dx of five (the bottom MLP's input needs none), the interaction stage's
# backward (one more interaction launch), and one sls_grad_table -- the
# table gradient
# in the dense modes, the row gradients in the sparse mode; a tiered
# forward reduces its hot tier with fused_segment_sum, its int8 warm tier
# with torch ops and its cold tier with fused_int4_segment_sum or, host
# cold, fused_segment_sum over the staging arena. "counter" names the
# wrapper module's launch count.
KERNELS = {
    "fused_segment_sum": {
        "module": fd_k, "counter": "launches",
        "source": "src/repro_torch/kernels/csrc/fused_segment_sum.cu",
        "replaces": "src/repro/kernels/fused_dispatch.py:61",
        "per_forward": 1, "per_step": 1, "per_cached_forward": 0,
        "per_fixed_forward": 0, "per_flat_forward": 0, "per_fixed_step": 0,
        "per_tiered_forward": 1, "per_host_forward": 2},
    "gemm": {
        "module": gm_k, "counter": "launches",
        "source": "src/repro_torch/kernels/csrc/gemm.cu",
        "replaces": "src/repro/kernels/gemm.py:39",
        "per_forward": 6, "per_step": 17, "per_cached_forward": 6,
        "per_fixed_forward": 6, "per_flat_forward": 6, "per_fixed_step": 17,
        "per_tiered_forward": 6, "per_host_forward": 6},
    "interaction": {
        "module": fi_k, "counter": "launches",
        "source": "src/repro_torch/kernels/csrc/interaction.cu",
        "replaces": "src/repro/kernels/feature_interaction.py:30",
        "per_forward": 1, "per_step": 2, "per_cached_forward": 1,
        "per_fixed_forward": 1, "per_flat_forward": 1, "per_fixed_step": 2,
        "per_tiered_forward": 1, "per_host_forward": 1},
    "sls_grad_table": {
        "module": eg_k, "counter": "launches",
        "source": "src/repro_torch/kernels/csrc/sls_grad_table.cu",
        "replaces": "src/repro/kernels/embedding_gather.py:188",
        "per_forward": 0, "per_step": 1, "per_cached_forward": 0,
        "per_fixed_forward": 0, "per_flat_forward": 0, "per_fixed_step": 1,
        "per_tiered_forward": 0, "per_host_forward": 0},
    "fused_cached_segment_sum": {
        "module": fd_k, "counter": "cached_launches",
        "source": "src/repro_torch/kernels/csrc/fused_cached_segment_sum.cu",
        "replaces": "src/repro/kernels/fused_dispatch.py:116",
        "per_forward": 0, "per_step": 0, "per_cached_forward": 1,
        "per_fixed_forward": 0, "per_flat_forward": 0, "per_fixed_step": 0,
        "per_tiered_forward": 0, "per_host_forward": 0},
    "embedding_bag": {
        "module": eg_k, "counter": "bag_launches",
        "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_gather.py:57",
        "per_forward": 0, "per_step": 0, "per_cached_forward": 0,
        "per_fixed_forward": 1, "per_flat_forward": 0, "per_fixed_step": 1,
        "per_tiered_forward": 0, "per_host_forward": 0},
    "sparse_lengths_sum": {
        "module": eg_k, "counter": "sls_launches",
        "source": "src/repro_torch/kernels/csrc/sparse_lengths_sum.cu",
        "replaces": "src/repro/kernels/embedding_gather.py:125",
        "per_forward": 0, "per_step": 0, "per_cached_forward": 0,
        "per_fixed_forward": 0, "per_flat_forward": 1, "per_fixed_step": 0,
        "per_tiered_forward": 0, "per_host_forward": 0},
    "fused_int4_segment_sum": {
        "module": fd_k, "counter": "int4_launches",
        "source": "src/repro_torch/kernels/csrc/fused_int4_segment_sum.cu",
        "replaces": "src/repro/kernels/fused_dispatch.py:183",
        "per_forward": 0, "per_step": 0, "per_cached_forward": 0,
        "per_fixed_forward": 0, "per_flat_forward": 0, "per_fixed_step": 0,
        "per_tiered_forward": 1, "per_host_forward": 0},
    # no DLRM path runs it; an LM prefill runs it once a layer (phase 10)
    "flash_attention": {
        "module": fa_k, "counter": "launches",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:77",
        "per_forward": 0, "per_step": 0, "per_cached_forward": 0,
        "per_fixed_forward": 0, "per_flat_forward": 0, "per_fixed_step": 0,
        "per_tiered_forward": 0, "per_host_forward": 0},
}


def launch_counts() -> dict:
    return {n: getattr(k["module"], k["counter"]) for n, k in KERNELS.items()}


def cold_compiles(engine) -> int:
    """Dispatches that found their (path, bucket) pair cold."""
    return int(engine.telemetry.registry.counter(
        "rec_cold_compiles_total").value)


def recent_latency(engine, n: int) -> dict:
    """p50/p95/p99 of an engine's last n request latencies, exact: they
    lie in its latency histogram's ring."""
    lat = engine._lat_hist.ring_values()[-n:]
    return {f"p{q}_ms": float(np.percentile(lat, q)) for q in (50, 95, 99)}


def reset_counts() -> None:
    for k in KERNELS.values():
        setattr(k["module"], k["counter"], 0)
    # the cached kernel's stage entry, counted in cached_launches too
    fd_k.cached_stage_launches = 0


# ------------------------------------------- the CPU reference worker
# Phases 15(b) and 17 to 19 hold the card against the CPU path at full
# width, and on this card's host (8 cores) those CPU passes took ~440 s
# of the script ("final32"; 15(b)'s ~70 more). They run on one thread of
# their own, beside the card's work from phase 15 on, and their checks
# are made once it is done (``settle``). The thread runs CPU tensors
# only, so it launches no kernel and moves no launch count; it runs at a
# lower priority (CPU_REFS_NICE) so that the card's own host thread keeps
# its core.
# The module functions the script spies on (MoE routing, the cross
# entropy, the flash op) are patched once, by ``patched``: each thread
# sees the spies entered on its side only, "cpu" for this thread and
# "card" for every other (the main thread, and the autograd engine's
# device threads, where the card's backward runs; a CPU backward runs on
# the thread that calls it).
CPU_REFS = "cpu_refs"              # the worker thread's name
CPU_REFS_NICE = 10
_PATCHES = {}


def _side() -> str:
    return ("cpu" if threading.current_thread().name == CPU_REFS
            else "card")


@contextlib.contextmanager
def patched(module, name: str, make):
    """``module.name`` replaced by ``make(inner)`` for the calls made on
    this thread's side (``_side``) while inside, ``inner`` being what
    those calls reached before; the other side's calls do not see it."""
    slot = _PATCHES.get((module, name))
    if slot is None:
        slot = {"inner": getattr(module, name), "card": [], "cpu": []}

        def dispatch(*args, **kw):
            stack = slot[_side()]
            return (stack[-1] if stack else slot["inner"])(*args, **kw)
        _PATCHES[(module, name)] = slot
        setattr(module, name, dispatch)
    stack = slot[_side()]
    fn = make(stack[-1] if stack else slot["inner"])
    stack.append(fn)
    try:
        yield
    finally:
        if stack.pop() is not fn:
            fail(f"{name}: spies left out of order")


class CpuRefs:
    """One daemon thread that runs the CPU reference passes handed to
    it, in order; ``submit`` returns each one's future."""

    def __init__(self):
        self.jobs = queue.Queue()
        self.thread = threading.Thread(target=self._run, name=CPU_REFS,
                                       daemon=True)
        self.thread.start()

    def _run(self) -> None:
        os.setpriority(os.PRIO_PROCESS, threading.get_native_id(),
                       CPU_REFS_NICE)
        while (job := self.jobs.get()) is not None:
            fut, fn = job
            try:
                fut.set_result(fn())
            except BaseException as e:  # raised where the result is read
                fut.set_exception(e)
            del job, fut, fn       # a pass's inputs go with it

    def submit(self, fn) -> concurrent.futures.Future:
        fut = concurrent.futures.Future()
        self.jobs.put((fut, fn))
        return fut

    def close(self) -> None:
        self.jobs.put(None)
        self.thread.join()


_CPU_REFS = []                     # the worker, started at first use
_PENDING = []                      # checks waiting on it, in order


def cpu_refs() -> CpuRefs:
    if not _CPU_REFS:
        _CPU_REFS.append(CpuRefs())
    return _CPU_REFS[0]


class Pending:
    """A card-against-CPU check whose CPU passes run on the worker:
    ``settle`` calls ``finish(their result)`` and puts what it returns
    in ``target[key]``."""

    def __init__(self, what: str, target: dict, key: str, cpu_pass,
                 finish):
        self.what, self.target, self.key = what, target, key
        self.finish = finish
        self.future = cpu_refs().submit(cpu_pass)
        target[key] = self
        _PENDING.append(self)


def settle() -> dict:
    """Wait for the worker, make every pending check in the order
    handed in (each fails the run as it would have in its phase), and
    stop the worker. Returns the seconds waited."""
    t0 = time.perf_counter()
    for p in _PENDING:
        p.future.result()
    waited = time.perf_counter() - t0
    while _PENDING:
        p = _PENDING.pop(0)
        print(f"  {p.what}")
        p.target[p.key] = p.finish(p.future.result())
    if _CPU_REFS:
        _CPU_REFS.pop().close()
    return {"waited_s": waited}


@contextlib.contextmanager
def uncounted():
    """Launches made inside (reference forwards that a main path is held
    against) do not count towards that path. On the CPU reference worker
    it does nothing: that thread launches no kernel, and the counts it
    would restore are the card's."""
    if _side() == "cpu":
        yield
        return
    saved = launch_counts()
    stage = fd_k.cached_stage_launches
    try:
        yield
    finally:
        for n, k in KERNELS.items():
            setattr(k["module"], k["counter"], saved[n])
        fd_k.cached_stage_launches = stage

# the pipelined forwards against the single-shot ones: every kernel of
# the port computes a bag, a sample or an output row on its own (gemm in
# order of k), so they are expected equal bit for bit; should a layer
# ever add in another order per micro-batch, logits of magnitude <= ~10
# summed over K <= 512 agree within 1e-5.
PIPE_ATOL = 1e-5

# Tolerances, kernel against plain version, both fp32 on the card:
# fused_segment_sum and fused_cached_segment_sum: <= 40 terms of ~1e-2
# summed in another order.
# gemm: up to K = 512 products of O(1) values against cuBLAS's blocked
# order; relative error grows ~ sqrt(K) * 6e-8. The kernel sums in one of
# two orders, each fixed by K (and N): on the CUDA cores (M <= 64, or K
# <= 64, or N <= 32), fmaf in order of k within each cluster rank's slice
# of K, then the slices in rank order; else 3xTF32 on the tensor cores
# (lo*hi + hi*lo + hi*hi, the lo*lo term of ~2^-22 of a product
# dropped), each 32-deep k-tile summed in the tensor core and added to
# the accumulator in fp32, then the slices in rank order.
# gemm_long: dw at batch 2048 sums K = 2048 O(1) products, where fp32 in
# any order lies past TOL["gemm"] from the exact sum: on the H100 the
# plain version (cuBLAS) itself lies up to 5.8e-5 from the fp64 product
# at these shapes. Two sums each that close to the truth differ by at
# most twice that, so atol 1.2e-4: the kernel held to be as accurate as
# the plain version. Both distances from the fp64 product are printed.
# fused_cached_segment_sum on a stale cache: hot copies moved by 0.5, so
# up to 40 terms of ~0.5 and sums up to ~20, whose ulp is ~2e-6 (the
# first chip run saw 1.4e-6 at 1e-6).
# interaction: D = 32 products of O(1) values; the same for the stage's
# kept pairs. interaction_backward: F - 1 <= 50 products of O(1) values
# (pair gradients and features ~ N(0, 1)) against cuBLAS's order, plus the
# pass-throughs, as gemm's K <= 64.
# sls_grad_table: g ~ N(0, 1); the plain version on the card adds with
# float atomics, in an order that changes from run to run. A run of k <=
# ~2,200 terms (the hottest Zipf row at 2048 samples) differs between two
# orders by a random walk of ~sqrt(k) * 6e-8 * |partial sum| ~ 1.5e-4;
# five runs on the H100 saw 1.9e-4 to 3.5e-4.
# Against the plain version on the CPU, which adds in the kernel's
# order, the tolerance is 0.
# embedding_bag and sparse_lengths_sum: as fused_segment_sum, <= 80
# terms of ~1e-2; both must besides equal the fused_segment_sum kernel
# bit for bit, since all three add a bag's rows in order of position.
TOL = {"fused_segment_sum": dict(rtol=0.0, atol=1e-6),
       "embedding_bag": dict(rtol=0.0, atol=1e-6),
       "sparse_lengths_sum": dict(rtol=0.0, atol=1e-6),
       "fused_cached_segment_sum": dict(rtol=0.0, atol=1e-6),
       "fused_cached_segment_sum_stale": dict(rtol=0.0, atol=1e-5),
       "gemm": dict(rtol=1e-5, atol=1e-5),
       "gemm_long": dict(rtol=1e-5, atol=1.2e-4),
       "interaction": dict(rtol=1e-5, atol=1e-5),
       "interaction_backward": dict(rtol=1e-5, atol=1e-5),
       "sls_grad_table": dict(rtol=1e-5, atol=1e-3),
       "flash_attention": dict(rtol=2 ** -7, atol=2 ** -7)}
# flash_attention (phase 10), bf16 on both sides: each output is rounded
# to bf16, whose ulp is at most 2^-7 of the value, and fp32 scores summed
# in another order can flip the bf16 rounding of a P entry before the PV
# product; so |kernel - plain| <= 2^-7 (1 + |plain|). The mma.sync kernel
# and the wgmma kernel that replaced it each saw at most one ulp on the
# card, 7.8e-3 at |o| in [2, 4); the latter's exp2 with the scale folded
# in moves P by a few fp32 ulps, far inside that.
# served probabilities, card kernels against the CPU path: fp32 logits
# of magnitude <= ~10 through sigmoid (slope <= 1/4); the same for the
# int8 cold arena, whose codes the card and the CPU share. The int8 plan
# against the fp plan: the reference's stated bound
# (tests/test_rec_serving.py, int8 tail with fp hot rows).
PROB_ATOL = 1e-5
INT8_PROB_ATOL = 0.05
# train steps, card against the CPU path. Each step starts both from the
# card's state, so differences do not compound. The two sum in other
# orders, ~1e-6 of each value, and two things amplify that:
# * a ReLU pre-activation within rounding of zero is kept on one side and
#   dropped on the other, which changes that one sample's gradient through
#   the unit. The first runs of this phase on the H100 saw one: top MLP
#   layer 0, sample 15, unit 277, +9.0e-7 on the card and -6.4e-7 on the
#   CPU; it moved that sample's d_emb by 1.6e-4 (of 0.037) and no other
#   sample's by more than 3e-8;
# * AdamW's first steps move a param by ~lr * sign(g), so a gradient
#   element whose sign flips moves by 2 lr instead of ~1e-6 lr.
# So per step: the loss (a forward from equal params) to rtol 1e-5, the
# touched rows exactly, and of the updated params all within atol 1e-5
# but for at most 1e-3 of the MLP elements and the rows of two samples'
# bags (2 * T * max_l rows) of the arena, and none further apart than two
# steps of opposite sign: 2 lr (1.01 + wd |p|) for AdamW (|m_hat /
# sqrt(v_hat)| <= 1.002 over the first four steps, by Cauchy-Schwarz over
# the moment weights), 2 * 10 lr * sqrt(D) for row-wise Adagrad (|g_i| /
# rms(g) <= sqrt(D)).
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
MLP_SHARE = 1e-3
ARENA_SAMPLES = 2


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, reps: int = 20, trials: int = 15) -> float:
    """Median over trials of the mean time of `reps` back-to-back calls,
    with CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return float(np.median(out))


def _kernel_times_us(prof) -> dict:
    """Device time (us) per kernel name from a torch.profiler run."""
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            out[e.key] = out.get(e.key, 0.0) + us
    return out


def device_ms(fn, reps: int = 20):
    """Mean device time per call, summed over every kernel `fn` runs, from
    torch.profiler's CUPTI trace; None when the trace holds no device
    time. Unlike `time_ms`, the host's launch cost is not in it. A trace
    that comes back empty (the profiler on the card has lost one) is
    taken once more."""
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(_kernel_times_us(prof).values())
        if total > 0:
            return total / 1e3 / reps
    return None


def measure(kernel, plain, library) -> dict:
    """Per-call times of a kernel, its plain version and the library call:
    host-inclusive (CUDA events around back-to-back calls) and device-only
    (profiler)."""
    return {"ms": time_ms(kernel), "plain_ms": time_ms(plain),
            "library_ms": time_ms(library), "device_ms": device_ms(kernel),
            "plain_device_ms": device_ms(plain),
            "library_device_ms": device_ms(library)}


def _fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def bound(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, got: torch.Tensor, want: torch.Tensor,
            what: str, tol: dict = None) -> float:
    tol = TOL[name] if tol is None else tol
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name} {what}: {tuple(got.shape)} {got.dtype} against "
             f"{tuple(want.shape)} {want.dtype}")
    err = (got - want).abs().max().item() if got.numel() else 0.0
    if not torch.allclose(got, want, **tol):
        fail(f"{name} {what}: max |kernel - plain| = {err} over {tol}")
    print(f"  {name:24s} {what:34s} max_abs_err {err:.3e}")
    return err


# ---------------------------------------------------------------- phase 1

def phase_card() -> dict:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; the port's smoke run needs "
                 "the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.2f} s for {len(libs)} libraries "
          f"({', '.join(sorted(libs))})")
    for name, log in _build.build_logs().items():
        print(f"--- nvcc {name}\n{log.strip()}")
    return {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
            "build_s": build_s}


# ---------------------------------------------------------------- phase 2

def serving_dense_ids(cfg, batch_size: int, seed: int) -> torch.Tensor:
    """The dense id matrix the serving path hands the kernel: a poisson
    ragged batch, flattened into the arena and relayouted to max_l."""
    rb = DLRMSynthetic(cfg, seed=seed).ragged_batch(
        batch_size, dist="poisson", max_l=MAX_L,
        pad_to=batch_size * cfg.n_tables * MAX_L)
    spec = dlrm.arena_spec(cfg)
    idx = torch.from_numpy(rb["indices"]).cuda()
    off = torch.from_numpy(rb["offsets"]).cuda()
    flat = se.flatten_ragged_indices(spec, idx, off)
    return se.ragged_dense_ids(flat, off, max_l=MAX_L, fill=spec.null_row)


def in_order(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The bag sum added strictly in order of j from zeros, one torch add
    a position: the order the embedding kernels keep."""
    acc = torch.zeros((ids.shape[0], table.shape[1]), device=table.device)
    for j in range(ids.shape[1]):
        acc = acc + table[ids[:, j]]
    return acc


def check_fused(arena, cfg, gen) -> tuple:
    """Against the plain version within tolerance and against the in-order
    loop bit for bit, at each of the tile depths segment_plan picks (8 to
    64 rows in steps of 8): the serving path's ids at 32 and 2048
    samples, max_l = 0, D = 16, bags longer than one tile (70, 97, 130
    and 200 rows), D = 48 (two passes of 32 columns), D = 6 and a table 4
    bytes off 16-byte alignment."""
    name = "fused_segment_sum"
    errs = []
    ids32 = serving_dense_ids(cfg, BUCKET, seed=11)
    large = serving_dense_ids(cfg, LARGE, seed=12)

    def check(table, ids, what):
        got = fd_k.fused_segment_sum(table, ids)
        errs.append(compare(name, got, ref.fused_segment_sum(table, ids),
                            what))
        want = in_order(table, ids)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"{name} {what}: differs from the in-order loop by "
                 f"{(got - want).abs().max().item()}")
        print(f"  {name:24s} {what:34s} equal to the in-order loop "
              f"(torch.equal)")

    check(arena, ids32, f"ids {tuple(ids32.shape)}")
    check(arena, large, f"ids {tuple(large.shape)}")
    empty = ids32[:, :0].contiguous()
    errs.append(compare(name, fd_k.fused_segment_sum(arena, empty),
                        torch.zeros(ids32.shape[0], arena.shape[1],
                                    device="cuda"), "max_l = 0"))
    small = torch.randn((50, 16), generator=gen, device="cuda")
    small_ids = torch.randint(0, 50, (9, 7), generator=gen, device="cuda",
                              dtype=torch.int32)
    check(small, small_ids, "D = 16, B = 9, max_l = 7")
    for v, d, b, l in ((300, 32, 37, 200), (300, 48, 9, 97), (300, 6, 9, 45),
                       (300, 32, 3000, 70), (300, 48, 3000, 130),
                       (300, 32, 9, 12), (300, 32, 9, 20), (300, 32, 300, 30),
                       (300, 32, 300, 64)):
        table = _small_table(gen, v, d)
        ids = torch.randint(0, v, (b, l), generator=gen, device="cuda",
                            dtype=torch.int32)
        check(table, ids, f"D = {d}, B = {b}, max_l = {l}")
    # rows 4 bytes off 16-byte alignment: the 4-byte copies
    flat = _small_table(gen, 300 * 32 + 1, 1).reshape(-1)
    check(flat[1:].view(300, 32), torch.randint(
        0, 300, (9, 40), generator=gen, device="cuda", dtype=torch.int32),
        "unaligned table, D = 32")
    rows = []
    for ids in (ids32, large):
        b, l = ids.shape
        d = arena.shape[1]
        touched = torch.unique(ids).numel()
        bound_ms, by = bound(4 * (ids.numel() + touched * d + b * d),
                             ids.numel() * d)
        rows.append({
            "samples": b // cfg.n_tables, "shape": [b, l, d],
            **measure(lambda: fd_k.fused_segment_sum(arena, ids),
                      lambda: ref.fused_segment_sum(arena, ids),
                      lambda: F.embedding_bag(ids, arena, mode="sum")),
            "bound_ms": bound_ms, "bound_by": by})
    return max(errs), rows


def warm_counts(cfg) -> np.ndarray:
    """The trace that ranks the hot rows, as the reference's serving
    example takes it: a warm ragged batch of 4,096 samples (its own seed,
    apart from the served requests)."""
    warm = DLRMSynthetic(cfg, seed=17).ragged_batch(WARM, dist="poisson",
                                                    max_l=MAX_L)
    return se.trace_row_counts(dlrm.arena_spec(cfg), warm["indices"],
                               warm["offsets"])


# (V, D, B, max_l) of the cached kernel's edge cases: every tile depth
# segment_plan picks (8 at max_l 1, 16 at 12, 24 at 20, 32 at 30, 40 at
# 40, 48 at 45, 64 at 64, 56 at 97), bags longer than a tile (70 rows in
# two chunks of 40, 97, 130 in three of 48, 200 in four of 56), D = 48
# (two passes of 32 columns), 16 and 6
CACHED_CASES = ((300, 32, 9, 1), (300, 32, 9, 12), (300, 32, 37, 20),
                (300, 32, 300, 30), (300, 32, 300, 40), (300, 48, 9, 45),
                (300, 32, 300, 64), (300, 32, 3000, 70), (300, 48, 37, 97),
                (300, 32, 3000, 130), (300, 32, 37, 200), (300, 16, 9, 45),
                (300, 6, 9, 45))


def check_cached(arena, cfg, gen) -> tuple:
    """The cached kernel's two entries over a K = 4,096 cache ranked by a
    warm trace at the serving path's shapes: the TPU kernel's form
    against its plain version and, on a coherent cache, bit for bit
    against the in-order loop over the arena and the fused_segment_sum
    kernel; the stage form (the hit split in the kernel) bit for bit
    against the TPU kernel's form, one launch on the card, timed beside
    the split's torch ops and the kernel it replaced. Then every tile
    depth the plan picks, bags longer than a tile, D = 48, 16 and 6, an
    arena 4 bytes off 16-byte alignment, and a stale cache against the
    plain version."""
    name = "fused_cached_segment_sum"
    spec = dlrm.arena_spec(cfg)
    cache = se.build_hot_cache(arena, spec, warm_counts(cfg), CACHE_K)
    hot = cache.hot_rows
    errs = []

    def case(c, table, dense, null_row, what):
        """Both entries on a coherent cache: the TPU kernel's form against
        the plain version, the in-order loop and fused_segment_sum, the
        stage form against the TPU kernel's form, all bit for bit."""
        slots, cold = ref.cached_split(c.slot_of, dense, c.k, null_row)
        got = fd_k.fused_cached_segment_sum(c.hot_rows, table, slots, cold)
        errs.append(compare(name, got, ref.fused_cached_segment_sum(
            c.hot_rows, table, slots, cold), what))
        want = in_order(table, dense)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"{name} {what}: differs from the in-order loop by "
                 f"{(got - want).abs().max().item()} on a coherent cache")
        _same_as_fused(name, got, table, dense, what)
        _same_bits(name, [got], [fd_k.fused_cached_segment_stage(
            c.hot_rows, c.slot_of, table, dense)], what + " stage form")
        return slots, cold

    rows = []
    for samples, seed in ((BUCKET, 11), (LARGE, 12)):
        dense = serving_dense_ids(cfg, samples, seed=seed)
        what = f"ids {tuple(dense.shape)}"
        slots, cold = case(cache, arena, dense, spec.null_row, what)
        b, l = dense.shape
        d = arena.shape[1]
        hits = int((slots < cache.k).sum())
        valid = int((dense != spec.null_row).sum())
        # each row the kernel reads, once: the hot slots hit and, for the
        # misses, the cold rows (the null row of the fill slots included)
        read = torch.where(slots < cache.k, slots, cache.k + 1 + cold)
        touched = torch.unique(read).numel()
        ids_read = torch.unique(dense).numel()
        bound_ms, by = bound(4 * (2 * b * l + touched * d + b * d), b * l * d)
        rows.append({
            "samples": samples, "shape": [b, l, d], "k": cache.k,
            "hit_rate": hits / valid, "rows_read": touched,
            **measure(lambda: fd_k.fused_cached_segment_sum(hot, arena,
                                                            slots, cold),
                      lambda: ref.fused_cached_segment_sum(hot, arena,
                                                           slots, cold),
                      lambda: F.embedding_bag(slots, hot, mode="sum")
                      + F.embedding_bag(cold, arena, mode="sum")),
            "bound_ms": bound_ms, "bound_by": by,
            # the same bytes with one row read per position, as if no row
            # were read twice from the L2
            "bound_per_position_ms": bound(4 * (2 * b * l + b * l * d
                                                + b * d), b * l * d)[0]})

        # the stage form as the cached plan runs it, one launch, beside
        # the composition it replaced: the split's three torch ops and the
        # TPU kernel's form
        def stage():
            return ops.fused_cached_segment_stage(
                hot, cache.slot_of, arena, dense, null_row=spec.null_row)

        def composition():
            s, c = ref.cached_split(cache.slot_of, dense, cache.k,
                                    spec.null_row)
            return fd_k.fused_cached_segment_sum(hot, arena, s, c)
        n_stage = _stage_kernels(stage)
        n_old = _stage_kernels(composition)
        if n_stage != 1:
            fail(f"{name} {what}: the stage form ran {n_stage} kernels")
        print(f"  {name:24s} {what}: stage form {n_stage} kernel a call, "
              f"the split and the kernel {n_old}")
        # the ids, the slot map's entry of each id read, the rows, the out
        stage_bound = bound(4 * (b * l + ids_read + touched * d + b * d),
                            b * l * d)
        rows.append({
            "what": "stage forward", "samples": samples, "shape": [b, l, d],
            "kernels": n_stage, "composition_kernels": n_old,
            **measure(stage, lambda: ref.fused_cached_segment_stage(
                hot, cache.slot_of, arena, dense, spec.null_row),
                composition),
            "bound_ms": stage_bound[0], "bound_by": stage_bound[1]})
    # a stale cache: the hot copies drift from the arena, the kernel serves
    # them as they are (the slot K stays zero)
    dense = serving_dense_ids(cfg, BUCKET, seed=11)
    slots, cold = ref.cached_split(cache.slot_of, dense, cache.k,
                                   spec.null_row)
    stale = hot + 0.5
    stale[-1] = 0.0
    got = fd_k.fused_cached_segment_sum(stale, arena, slots, cold)
    errs.append(compare(name, got, ref.fused_cached_segment_sum(
        stale, arena, slots, cold), "stale cache",
        TOL["fused_cached_segment_sum_stale"]))
    _same_bits(name, [got], [fd_k.fused_cached_segment_stage(
        stale, cache.slot_of, arena, dense)], "stale cache stage form")
    if torch.equal(got, fd_k.fused_segment_sum(arena, dense)):
        fail(f"{name}: a stale cache served the fresh arena")
    # edges: max_l 0, every tile depth, long bags, narrow and wide rows
    errs.append(compare(name, fd_k.fused_cached_segment_sum(
        hot, arena, slots[:, :0].contiguous(), cold[:, :0].contiguous()),
        torch.zeros(slots.shape[0], arena.shape[1], device="cuda"),
        "max_l = 0"))
    errs.append(compare(name, fd_k.fused_cached_segment_stage(
        hot, cache.slot_of, arena, dense[:, :0].contiguous()),
        torch.zeros(slots.shape[0], arena.shape[1], device="cuda"),
        "max_l = 0, stage form"))
    case(cache, arena, dense[:, :1].contiguous(), spec.null_row, "max_l = 1")

    def small_cache(table, ids, k):
        v = table.shape[0]
        return se.build_hot_cache(table, se.ArenaSpec(1, v - 1,
                                                      table.shape[1]),
                                  np.bincount(ids.cpu().numpy().ravel(),
                                              minlength=v), k)
    for v, d, b, l in CACHED_CASES:
        table = _small_table(gen, v, d)
        ids = torch.randint(0, v, (b, l), generator=gen, device="cuda",
                            dtype=torch.int32)
        depth = fd_k.segment_plan(b, l, d, _build.sm_count(ids.device)).depth
        case(small_cache(table, ids, 20), table, ids, v - 1,
             f"D = {d}, B = {b}, max_l = {l} (depth {depth})")
    # rows 4 bytes off 16-byte alignment
    flat = _small_table(gen, 300 * 32 + 1, 1).reshape(-1)
    table = flat[1:].view(300, 32)
    table[-1] = 0.0
    ids = torch.randint(0, 300, (9, 40), generator=gen, device="cuda",
                        dtype=torch.int32)
    case(small_cache(table, ids, 20), table, ids, 299,
         "unaligned arena, D = 32")
    return max(errs), rows


GEMM_ROWS = (1, 8, 32, 64, 65, LARGE)   # both tilings and their edge
GEMM_LONG = 512                          # contractions under TOL["gemm"]
GEMM_PREFIXES = (1, 8, 31)               # rows checked against a full run


def _gemm_layers(params) -> list:
    return [w for w, _ in params["bottom"]] + [w for w, _ in params["top"]]


def check_gemm(params, gen) -> tuple:
    """Every layer at M = 1, 8, 32, 64, 65 and 2048 (both tilings: see
    ``gm_k.plan``), and the 33 x 70 x 65 edge case, against the plain
    version; two launches equal bit for bit; at M <= 64 the first m rows
    of a product equal the m-row product bit for bit. Times at bucket 32
    and 2048, the six layers summed."""
    name = "gemm"
    layers = _gemm_layers(params)
    errs = []
    for m in GEMM_ROWS:
        for w in layers:
            x = torch.randn((m, w.shape[0]), generator=gen, device="cuda")
            got = gm_k.gemm(x, w)
            what = f"{m} x {w.shape[0]} x {w.shape[1]}"
            errs.append(compare(name, got, ref.gemm(x, w), what))
            if not torch.equal(got, gm_k.gemm(x, w)):
                fail(f"{name} {what}: two launches differ")
            for r in GEMM_PREFIXES if m <= gm_k.CLUSTER_ROWS else ():
                if r < m and not torch.equal(gm_k.gemm(x[:r].contiguous(), w),
                                             got[:r]):
                    fail(f"{name} {what}: rows 0..{r - 1} differ from the "
                         f"{r}-row product")
    x = torch.randn((33, 70), generator=gen, device="cuda")
    w = torch.randn((70, 65), generator=gen, device="cuda")
    errs.append(compare(name, gm_k.gemm(x, w), ref.gemm(x, w),
                        "33 x 70 x 65 (tile edges)"))
    print(f"  {name:24s} two launches equal at every shape; rows "
          f"{GEMM_PREFIXES} equal the full product's at M <= "
          f"{gm_k.CLUSTER_ROWS}")
    rows = []
    for m in (BUCKET, LARGE):
        xs = [torch.randn((m, w.shape[0]), generator=gen, device="cuda")
              for w in layers]
        rows.append(_gemm_row(
            m, [(m, w.shape[0], w.shape[1]) for w in layers],
            [(lambda x=x, w=w: gm_k.gemm(x, w)) for x, w in zip(xs, layers)],
            [(lambda x=x, w=w: ref.gemm(x, w)) for x, w in zip(xs, layers)],
            [(lambda x=x, w=w: torch.matmul(x, w))
             for x, w in zip(xs, layers)]))
    return max(errs), rows


def _gemm_row(samples: int, shapes, kernels, plains, libraries) -> dict:
    """Times of a list of products (M, K, N), summed: kernel, plain
    version and library call; the bound of each product summed."""
    row = {"samples": samples, "shape": [list(s) for s in shapes],
           "bound_ms": 0.0, "bytes": 0, "flops": 0}
    for (m, k, n), kern, plain, lib in zip(shapes, kernels, plains,
                                           libraries):
        for key, v in measure(kern, plain, lib).items():
            # the sum; None once any product has no trace
            row[key] = (None if v is None or row.get(key, 0.0) is None
                        else row.get(key, 0.0) + v)
        row["bytes"] += 4 * (m * k + k * n + m * n)
        row["flops"] += 2 * m * k * n
        row["bound_ms"] += bound(4 * (m * k + k * n + m * n),
                                 2 * m * k * n)[0]
    row["bound_by"] = bound(row["bytes"], row["flops"])[1]
    return row


# the interaction stage's shapes (B, T, D), F = T + 1: DLRM(1) at the
# serving batch, 1, 9 and 2048 samples, and the 50 tables of DLRM(2), (4)
# and (5) at D = 16
STAGE_SHAPES = ((BUCKET, 5, 32), (1, 5, 32), (9, 5, 32), (LARGE, 5, 32),
                (BUCKET, 50, 16), (9, 50, 16))


def stage_composition(bot, emb):
    """The interaction stage as the dense engine ran it before it was one
    kernel each way: five launches and the autograd of each (the
    features' cat, the full-matrix kernel, tril_indices made on the card,
    the gather of the pairs, the cat with the bottom output)."""
    feats = torch.cat([bot[:, None, :], emb], dim=1)
    return torch.cat([bot, ops.interaction_tril(feats)], dim=-1), feats


def _same_bits(name: str, a, b, what: str) -> None:
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        fail(f"{name} {what}: differs bit for bit")
    print(f"  {name:24s} {what:34s} equal (torch.equal)")


STAGE_CALLS = 3                    # counted calls in a trace of one stage


def _stage_kernels(fn) -> int:
    """Kernels on the card of one call of fn (profiler, copies and fills
    apart). The trace holds a lead-in call and STAGE_CALLS counted ones,
    each followed by a device synchronize; a call's kernels are those whose
    CUPTI correlation id falls between its synchronizes (the profiler adds
    one more when it stops). The lead-in takes
    the place of the records that the first call of a trace can lose, and
    a trace whose counted calls disagree, or show none, lost records and
    is taken again, at most TRACE_TAKES times (as in `trace_replays`)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(TRACE_TAKES):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(STAGE_CALLS + 1):
                fn()
                torch.cuda.synchronize()
        events = prof.profiler.kineto_results.events()
        syncs = sorted(e.correlation_id() for e in events
                       if e.name() == "cudaDeviceSynchronize")
        counts = [0] * (STAGE_CALLS + 1)
        for e in events:
            low = e.name().lower()
            if e.device_type() == torch.autograd.DeviceType.CUDA \
                    and "memcpy" not in low and "memset" not in low:
                call = bisect.bisect_left(syncs, e.correlation_id())
                if call < len(counts):
                    counts[call] += 1
        counted = counts[1:]
        if len(syncs) >= STAGE_CALLS + 1 and len(set(counted)) == 1 \
                and counted[0]:
            return counted[0]
    fail(f"{TRACE_TAKES} traces of {STAGE_CALLS} calls lost records: "
         f"kernels a call {counted}, {len(syncs)} synchronizes")


def check_interaction(cfg, gen) -> tuple:
    """The full-matrix kernel (the TPU kernel's function) against its
    plain version and beside bmm; the stage's forward and backward (one
    launch each) against their plain versions at STAGE_SHAPES, two
    launches and a batch's first samples alone bit for bit, one kernel
    each way on the card, timed beside the five-op composition it
    replaced and its autograd."""
    name = "interaction"
    f, d = cfg.n_interact_features, cfg.emb_dim
    errs = []
    for shape in ((BUCKET, f, d), (1, f, d), (9, f, d), (3, 4, 16),
                  (BUCKET, 51, 16)):
        x = torch.randn(shape, generator=gen, device="cuda")
        errs.append(compare(name, fi_k.interaction(x), ref.interaction(x),
                            f"x {shape}"))
    rows = []
    for b in (BUCKET, LARGE):
        x = torch.randn((b, f, d), generator=gen, device="cuda")
        xt = x.transpose(1, 2)
        bound_ms, by = bound(4 * (b * f * d + b * f * f), 2 * b * f * f * d)
        rows.append({
            "what": "full X X^T", "samples": b, "shape": [b, f, d],
            **measure(lambda: fi_k.interaction(x),
                      lambda: ref.interaction(x),
                      lambda: torch.bmm(x, xt)),
            "bound_ms": bound_ms, "bound_by": by})
    for b, t, d in STAGE_SHAPES:
        bot = torch.randn((b, d), generator=gen, device="cuda")
        emb = torch.randn((b, t, d), generator=gen, device="cuda")
        f = t + 1
        p = f * (f - 1) // 2
        g = torch.randn((b, d + p), generator=gen, device="cuda")
        gf = torch.randn((b, f, d), generator=gen, device="cuda")
        what = f"stage B {b}, F {f}, D {d}"
        got = fi_k.feature_interaction(bot, emb)
        want = ref.feature_interaction(bot, emb)
        errs.append(compare(name, got[0], want[0], what + " out"))
        _same_bits(name, got[1:], want[1:], what + " feats")
        _same_bits(name, got, fi_k.feature_interaction(bot, emb),
                   what + " twice")
        for grad_feats in (None, gf):
            back = fi_k.feature_interaction_backward(g, grad_feats, bot, emb)
            plain = ref.feature_interaction_backward(g, grad_feats, bot, emb)
            tag = what + (" bwd" if grad_feats is None else " bwd + feats")
            for got_d, want_d in zip(back, plain):
                errs.append(compare(name, got_d, want_d, tag,
                                    TOL["interaction_backward"]))
            _same_bits(name, back, fi_k.feature_interaction_backward(
                g, grad_feats, bot, emb), tag + " twice")
        # a sample's bits do not depend on the batch or the grid (at 2048
        # a block holds several samples, at 32 one)
        n = min(BUCKET, b // 2)
        if n:
            head = [x[:n].contiguous() for x in (g, bot, emb)]
            _same_bits(name, [x[:n] for x in got],
                       fi_k.feature_interaction(*head[1:]),
                       f"{what}: first {n} alone")
            _same_bits(name, [x[:n] for x in fi_k.feature_interaction_backward(
                g, None, bot, emb)], fi_k.feature_interaction_backward(
                head[0], None, *head[1:]), f"{what} bwd: first {n} alone")
        if (t, d) != (cfg.n_tables, cfg.emb_dim) or b not in (BUCKET, LARGE):
            continue
        # one kernel each way on the card, as the main path runs them
        leaf_b = bot.clone().requires_grad_()
        leaf_e = emb.clone().requires_grad_()
        out, _ = ops.feature_interaction(leaf_b, leaf_e)
        n_fwd = _stage_kernels(lambda: ops.feature_interaction(bot, emb))
        n_bwd = _stage_kernels(lambda: torch.autograd.grad(
            out, (leaf_b, leaf_e), g, retain_graph=True))
        if (n_fwd, n_bwd) != (1, 1):
            fail(f"{name} {what}: {n_fwd} kernels forward, {n_bwd} backward"
                 f"; the stage is one launch each way")
        old_out, _ = stage_composition(leaf_b, leaf_e)
        old_kernels = (
            _stage_kernels(lambda: stage_composition(bot, emb)),
            _stage_kernels(lambda: torch.autograd.grad(
                old_out, (leaf_b, leaf_e), g, retain_graph=True)))
        print(f"  {name:24s} {what}: kernels a call forward / backward "
              f"{n_fwd} / {n_bwd}; the five-op composition {old_kernels[0]} / "
              f"{old_kernels[1]}")
        bound_f = bound(4 * (b * d + b * t * d + b * (d + p) + b * f * d),
                        2 * b * p * d)
        rows.append({
            "what": "stage forward", "samples": b, "shape": [b, t, d],
            "kernels": n_fwd, "composition_kernels": old_kernels[0],
            **measure(lambda: fi_k.feature_interaction(bot, emb),
                      lambda: ref.feature_interaction(bot, emb),
                      lambda: stage_composition(bot, emb)),
            "bound_ms": bound_f[0], "bound_by": bound_f[1]})
        # the main path's backward: the output's gradient alone (the head
        # drops the features)
        bound_b = bound(4 * (b * (d + p) + 2 * (b * d + b * t * d)),
                        2 * b * f * (f - 1) * d)
        rows.append({
            "what": "stage backward", "samples": b, "shape": [b, t, d],
            "kernels": n_bwd, "composition_kernels": old_kernels[1],
            **measure(
                lambda: fi_k.feature_interaction_backward(g, None, bot, emb),
                lambda: ref.feature_interaction_backward(g, None, bot, emb),
                lambda: torch.autograd.grad(old_out, (leaf_b, leaf_e), g,
                                            retain_graph=True)),
            "bound_ms": bound_b[0], "bound_by": bound_b[1]})
    return max(errs), rows


def _same_as_fused(name: str, got: torch.Tensor, table: torch.Tensor,
                   dense: torch.Tensor, what: str) -> None:
    """The law of the three embedding kernels: one bag, summed in order
    of position, gives the same bits in every form."""
    want = fd_k.fused_segment_sum(table, dense)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"{name} {what}: differs from the fused_segment_sum kernel by "
             f"{(got - want).abs().max().item()}")
    print(f"  {name:24s} {what:34s} equal to fused_segment_sum "
          f"(torch.equal)")


def fixed_ids(cfg, samples: int, seed: int) -> torch.Tensor:
    """The (B*T, L) arena ids the fixed path hands the kernel: a
    DLRMSynthetic.batch, flattened into the arena."""
    b = DLRMSynthetic(cfg, seed=seed).batch(samples)
    return se.flatten_indices(dlrm.arena_spec(cfg),
                              torch.from_numpy(b["indices"]).cuda())


def _small_table(gen, v: int, d: int) -> torch.Tensor:
    # rows of the arena's scale, so the stated tolerance holds
    t = 0.01 * torch.randn((v, d), generator=gen, device="cuda")
    t[-1] = 0.0
    return t


# a row 0 of 1e6 that no bag names: a read past a bag's end that was
# added would show far past the tolerance
ROW0 = 1e6
# the bag lengths (embedding_bag) and bounds (sparse_lengths_sum) that
# reach every depth the plans pick: embedding_bag 1 (gather_rows' own),
# 8, 16 (12), 24 (20), 32 (30), 40, 48 (45), 56, 64, and long bags in
# equal chunks (80 in two of 40, 130 in three of 48, 200 in four of 56);
# sparse_lengths_sum 8 to 40 (SLS_DEPTH), every bound from 40 up in
# chunks of 40
PLAN_LENGTHS = (1, 8, 12, 20, 30, 40, 45, 56, 64, 80, 130, 200)
PLAN_BAGS = 301                    # blocks of three warps, the last part-full


def _row0_table(gen, v: int, d: int) -> torch.Tensor:
    """_small_table with row 0 at ROW0; the last row is the zero null
    row."""
    t = _small_table(gen, v, d)
    t[0] = ROW0
    return t


def _row0_stream(v: int, b: int, max_l: int, seed: int) -> tuple:
    """Poisson bags (mean max_l / 2, every fifth empty, bag 1 three rows
    longer than max_l) of ids in 1 .. v-2, then a padded tail of
    out-of-range ids (-1 and v + 7) that no kernel may load."""
    rng = np.random.RandomState(seed)
    lens = np.minimum(rng.poisson(max_l / 2, b), max_l)
    lens[::5] = 0
    lens[1] = max_l + 3
    off = np.zeros(b + 1, np.int32)
    np.cumsum(lens, out=off[1:])
    ids = np.concatenate([rng.randint(1, v - 1, int(off[-1])),
                          np.tile([-1, v + 7], 5)]).astype(np.int32)
    return torch.from_numpy(ids).cuda(), torch.from_numpy(off).cuda()


def _plan(p) -> str:
    return (f"{p.blocks} blocks x {p.warps_per_block} warps, depth "
            f"{p.depth}")


def ptxas_report(name: str) -> list:
    """ptxas's registers and spills for each instantiation of a kernel,
    from its build log: one line a template depth."""
    out, depth, spill = [], None, ""
    for line in _build.build_logs().get(name, "").splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"ILi(\d+)E", line)
            depth = m.group(1) if m else "?"
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and depth is not None:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"depth {depth}: {regs} registers, {spill}")
            depth = None
    return out


def _print_ptxas(name: str) -> None:
    for line in ptxas_report(name):
        print(f"  {name:24s} ptxas {line}")


def _same_launches(name: str, fn, what: str) -> None:
    a, b = fn(), fn()
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        fail(f"{name} {what}: two launches differ")


def check_embedding_bag(arena, cfg, gen) -> tuple:
    """embedding_bag at DLRM(1)'s fixed shapes (and gather_rows, L = 80,
    D = 16 and 48): against its plain version, and bit for bit against
    fused_segment_sum over the same bags padded with null-row fill; two
    launches equal. Then at every depth bag_plan picks (PLAN_LENGTHS) on
    a table whose row 0 is ROW0 and no bag's id."""
    name = "embedding_bag"
    spec = dlrm.arena_spec(cfg)
    errs, rows = [], []
    _print_ptxas(name)

    def check(table, ids, null_row, what):
        got = eg_k.embedding_bag(table, ids)
        errs.append(compare(name, got, ref.embedding_bag(table, ids), what))
        fill = torch.full_like(ids, null_row)
        _same_as_fused(name, got, table, torch.cat([ids, fill], 1), what)
        _same_launches(name, lambda: eg_k.embedding_bag(table, ids), what)

    for samples, seed in ((BUCKET, 31), (LARGE, 32)):
        ids = fixed_ids(cfg, samples, seed)
        b, n_l = ids.shape
        d = arena.shape[1]
        p = eg_k.bag_plan(b, n_l, d, _build.sm_count(ids.device))
        check(arena, ids, spec.null_row, f"ids {tuple(ids.shape)}")
        print(f"  {name:24s} plan at {tuple(ids.shape)}: {_plan(p)}")
        touched = torch.unique(ids).numel()
        bound_ms, by = bound(4 * (ids.numel() + touched * d + b * d),
                             ids.numel() * d)
        rows.append({
            "samples": samples, "shape": [b, n_l, d], "rows_read": touched,
            **measure(lambda: eg_k.embedding_bag(arena, ids),
                      lambda: ref.embedding_bag(arena, ids),
                      lambda: F.embedding_bag(ids, arena, mode="sum")),
            "bound_ms": bound_ms, "bound_by": by})
    # DLRM(3)'s bags of 80 over the same arena
    check(arena, fixed_ids(dataclasses.replace(cfg, lookups_per_table=80),
                           BUCKET, 33), spec.null_row, "L = 80 (DLRM(3))")
    # gather_rows: single-row bags, an exact copy of the rows
    one = fixed_ids(cfg, BUCKET, 34)[:, 0].contiguous()
    got = eg_k.gather_rows(arena, one)
    torch.cuda.synchronize()
    if not torch.equal(got, arena[one]):
        fail(f"{name} gather_rows: differs from arena[ids]")
    print(f"  {name:24s} {'gather_rows, L = 1':34s} equal to arena[ids]")
    errs.append(compare(name, eg_k.embedding_bag(
        arena, one[:, None][:, :0].contiguous()),
        torch.zeros(one.shape[0], arena.shape[1], device="cuda"), "L = 0"))
    for d in (48, 16):
        small = _small_table(gen, 300, d)
        ids = torch.randint(0, 299, (9, 45), generator=gen, device="cuda",
                            dtype=torch.int32)
        check(small, ids, 299, f"D = {d}, B = 9, L = 45")
    for n_l in PLAN_LENGTHS:
        table = _row0_table(gen, 300, 32)
        ids = torch.randint(1, 299, (PLAN_BAGS, n_l), generator=gen,
                            device="cuda", dtype=torch.int32)
        p = eg_k.bag_plan(PLAN_BAGS, n_l, 32, _build.sm_count(ids.device))
        check(table, ids, 299, f"L = {n_l}, row 0 {ROW0:g}: {_plan(p)}")
        if n_l == 1:
            got = eg_k.gather_rows(table, ids[:, 0].contiguous())
            torch.cuda.synchronize()
            if not torch.equal(got, table[ids[:, 0]]):
                fail(f"{name} gather_rows at depth 1: differs from "
                     "table[ids]")
    return max(errs), rows


def check_sls(arena, cfg, gen) -> tuple:
    """sparse_lengths_sum on poisson bags (mean 20, max 40) at bucket 32
    and 2048 samples, with their padded tail: against its plain version,
    bit for bit against fused_segment_sum over the relayouted ids; then
    empty bags, a bag longer than max_l, D = 16 and 48, and the cached
    source's flat split."""
    name = "sparse_lengths_sum"
    spec = dlrm.arena_spec(cfg)
    errs, rows = [], []
    _print_ptxas(name)

    def check(table, ids, off, max_l, null_row, what):
        got = eg_k.sparse_lengths_sum(table, ids, off, max_l=max_l)
        errs.append(compare(name, got, ref.sparse_lengths_sum(
            table, ids, off, max_l), what))
        dense = se.ragged_dense_ids(ids, off, max_l=max_l, fill=null_row)
        _same_as_fused(name, got, table, dense, what)
        _same_launches(name, lambda: eg_k.sparse_lengths_sum(
            table, ids, off, max_l=max_l), what)
        return got

    for samples, seed in ((BUCKET, 11), (LARGE, 12)):
        rb = DLRMSynthetic(cfg, seed=seed).ragged_batch(
            samples, dist="poisson", max_l=MAX_L,
            pad_to=samples * cfg.n_tables * MAX_L)
        off = torch.from_numpy(rb["offsets"]).cuda()
        flat = se.flatten_ragged_indices(
            spec, torch.from_numpy(rb["indices"]).cuda(), off)
        n_valid = int(rb["offsets"][-1])
        b, d = off.numel() - 1, arena.shape[1]
        check(arena, flat, off, MAX_L, spec.null_row,
              f"{off.numel() - 1} poisson bags, padded")
        p = eg_k.sls_plan(b, MAX_L, d, _build.sm_count(off.device))
        print(f"  {name:24s} plan at {b} bags, max_l {MAX_L}: {_plan(p)}")
        valid = flat[:n_valid].contiguous()
        touched = torch.unique(valid).numel()
        bound_ms, by = bound(4 * (n_valid + (b + 1) + touched * d + b * d),
                             n_valid * d)
        rows.append({
            "samples": samples, "bags": b, "ids": n_valid,
            "positions": flat.numel(), "rows_read": touched,
            **measure(lambda: eg_k.sparse_lengths_sum(arena, flat, off,
                                                      max_l=MAX_L),
                      lambda: ref.sparse_lengths_sum(arena, flat, off,
                                                     MAX_L),
                      lambda: F.embedding_bag(valid, arena, off, mode="sum",
                                              include_last_offset=True)),
            "bound_ms": bound_ms, "bound_by": by})
    # empty bags and a padded tail, D = 16 and 48
    off = torch.tensor([0, 0, 3, 3, 7, 9, 9], dtype=torch.int32,
                       device="cuda")
    for d in (48, 16):
        small = _small_table(gen, 300, d)
        ids = torch.randint(0, 299, (14,), generator=gen, device="cuda",
                            dtype=torch.int32)
        check(small, ids, off, 5, 299, f"D = {d}, empty bags, padded tail")
    # a bag longer than max_l: the first max_l rows, as the reference's
    # Pallas kernel sums them
    table = torch.arange(40, dtype=torch.float32, device="cuda").reshape(10, 4)
    ids = torch.tensor([1, 2, 3, 4, 5, 6, 0, 0], dtype=torch.int32,
                       device="cuda")
    off = torch.tensor([0, 5, 6], dtype=torch.int32, device="cuda")
    got = eg_k.sparse_lengths_sum(table, ids, off, max_l=2)
    want = torch.tensor([[12, 14, 16, 18], [24, 25, 26, 27]],
                        dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    if not torch.equal(got, want) or not torch.equal(
            got, ref.sparse_lengths_sum(table, ids, off, 2)):
        fail(f"{name} bag longer than max_l: {got.tolist()}")
    print(f"  {name:24s} {'bag of 5 at max_l = 2':34s} sums its first 2 "
          f"rows, as the Pallas kernel")
    # every depth sls_plan picks, on a table whose row 0 is ROW0 and no
    # bag's id, with empty bags, a bag longer than max_l and a padded tail
    # of out-of-range ids
    for max_l in PLAN_LENGTHS:
        table = _row0_table(gen, 300, 32)
        ids, off = _row0_stream(300, PLAN_BAGS, max_l, seed=max_l)
        p = eg_k.sls_plan(PLAN_BAGS, max_l, 32, _build.sm_count(ids.device))
        check(table, ids, off, max_l, 299,
              f"max_l = {max_l}, row 0 {ROW0:g}, tail -1 and V + 7: "
              f"{_plan(p)}")
    # the cached source's flat form: hot slots and cold redirects, each
    # through the kernel, against the fp arena's flat form
    rb = DLRMSynthetic(cfg, seed=11).ragged_batch(
        BUCKET, dist="poisson", max_l=MAX_L,
        pad_to=BUCKET * cfg.n_tables * MAX_L)
    off = torch.from_numpy(rb["offsets"]).cuda()
    flat = se.flatten_ragged_indices(
        spec, torch.from_numpy(rb["indices"]).cuda(), off)
    cache = se.build_hot_cache(arena, spec, warm_counts(cfg), CACHE_K)
    cached = es.CachedSource(cache, es.FpArena(arena))
    errs.append(compare(name, cached.reduce_flat(spec, flat, off,
                                                 max_l=MAX_L),
                        es.FpArena(arena).reduce_flat(spec, flat, off,
                                                      max_l=MAX_L),
                        "CachedSource.reduce_flat"))
    # the host tier's flat form, whose bound is the stream's length: a
    # staging arena whose row 0 is ROW0 and no arena row's slot
    staging = _row0_table(gen, STAGING + 1, arena.shape[1])
    slot_of = (torch.arange(arena.shape[0], device="cuda") * 7919
               % (STAGING - 1) + 1).int()
    slot_of[spec.null_row] = STAGING
    tier = HostTier(staging=staging, slot_of=slot_of)
    n = flat.shape[0]
    p = eg_k.sls_plan(off.numel() - 1, n, staging.shape[1],
                      _build.sm_count(off.device))
    got = check(staging, slot_of[flat], off, n, STAGING,
                f"host tier, max_l = {n}: {_plan(p)}")
    flat_form = tier.reduce_flat(spec, flat, off, max_l=MAX_L)
    dense = se.ragged_dense_ids(flat, off, max_l=MAX_L, fill=spec.null_row)
    torch.cuda.synchronize()
    if not (torch.equal(flat_form, got)
            and torch.equal(flat_form, tier.reduce_dense(spec, dense))):
        fail(f"{name}: HostTier.reduce_flat differs from its kernel call or "
             "from reduce_dense")
    print(f"  {name:24s} {'HostTier.reduce_flat':34s} equal to its "
          "reduce_dense (torch.equal)")
    return max(errs), rows


def phase_kernels(cfg, params, gen) -> dict:
    out = {}
    for name, (err, rows) in (
            ("fused_segment_sum", check_fused(params["arena"], cfg, gen)),
            ("gemm", check_gemm(params, gen)),
            ("interaction", check_interaction(cfg, gen)),
            ("fused_cached_segment_sum",
             check_cached(params["arena"], cfg, gen)),
            ("embedding_bag", check_embedding_bag(params["arena"], cfg, gen)),
            ("sparse_lengths_sum", check_sls(params["arena"], cfg, gen))):
        out[name] = {"max_abs_err": err, "rows": rows}
        for r in rows:
            if "hit_rate" in r:
                print(f"  {name:24s} {r['samples']:5d} samples: K "
                      f"{r['k']}, batch hit rate {r['hit_rate']:.4f}, "
                      f"{r['rows_read']} rows read, bound with one row per "
                      f"position {r['bound_per_position_ms']:.5f} ms")
            print(f"  {name:24s} {r.get('what', ''):14s} "
                  f"{r['samples']:5d} samples, ms per call "
                  f"(device ms): kernel {r['ms']:.4f} "
                  f"({_fmt(r['device_ms'])}), plain {r['plain_ms']:.4f} "
                  f"({_fmt(r['plain_device_ms'])}), library "
                  f"{r['library_ms']:.4f} ({_fmt(r['library_device_ms'])}), "
                  f"bound {r['bound_ms']:.5f} ({r['bound_by']})")
    return out


# ---------------------------------------------------------------- phase 3

def served_batch(cfg) -> dict:
    return DLRMSynthetic(cfg, seed=7).ragged_batch(N_REQUESTS,
                                                   dist="poisson",
                                                   max_l=MAX_L)


def serve(cfg, params, device: str, batch=None, **plan):
    """512 requests (``batch``, in the ragged dict form; default the
    poisson ``served_batch``), sent by the client 32 at a time: each group
    is stamped when it is sent and served by one engine step. ``plan``
    goes to the engine (source, cache_k, ...). On the card the launch
    counts are zeroed just before ``warmup()``, which captures every
    (path, bucket) pair's graph (an eager pass and a capture, each
    counted), and must not move while the requests are served: every
    micro-batch replays its pair's graph, which runs no wrapper."""
    engine = RecEngine(cfg, params, max_l=MAX_L, max_batch=BUCKET,
                       device=device, **plan)
    if device == "cuda":
        reset_counts()
    engine.warmup()
    warm = launch_counts()
    reqs = requests_from_ragged_batch(
        served_batch(cfg) if batch is None else batch, cfg.n_tables)
    for i in range(0, len(reqs), BUCKET):
        sent = time.monotonic()
        for r in reqs[i:i + BUCKET]:
            r.submitted_mono = sent
            engine.submit(r)
        engine.step()
    engine.drain()
    if device == "cuda" and launch_counts() != warm:
        fail(f"served micro-batches ran the kernel wrappers ("
             f"{launch_counts()} after warmup's {warm}); on the card each "
             f"must replay its pair's graph")
    return engine, np.array([r.prob for r in reqs], np.float64)


def _kernel_group(name: str) -> str:
    for group, symbol in (("fused_cached_segment_sum",
                           "fused_cached_segment_sum_kernel"),
                          ("fused_int4_segment_sum",
                           "fused_int4_segment_sum_kernel"),
                          ("fused_segment_sum", "fused_segment_sum_kernel"),
                          ("embedding_bag", "embedding_bag_kernel"),
                          ("sparse_lengths_sum",
                           "sparse_lengths_sum_kernel"),
                          ("gemm", "gemm_splitk_cluster_kernel"),
                          ("gemm", "gemm_tf32x3_kernel"),
                          ("interaction", "interaction_forward_kernel"),
                          ("interaction", "interaction_backward_kernel"),
                          ("sls_grad_table", "sls_grad_table_kernel"),
                          ("sls_grad_table", "sls_grad_partition_kernel")):
        if symbol in name:
            return group
    low = name.lower()
    return "copies" if "memcpy" in low or "memset" in low else "torch ops"


STAGES = ("sparse_lookup", "emb_lookup", "interaction", "mlp")


def poisson_batch(cfg, n: int, seed: int) -> dict:
    return DLRMSynthetic(cfg, seed=seed).ragged_batch(n, dist="poisson",
                                                      max_l=MAX_L)


def profile_serve(engine, cfg, n_batches: int = 4,
                  batch_fn=poisson_batch) -> dict:
    """Where a served micro-batch's time goes. Three passes of n_batches
    micro-batches of 32: plain (host clock), under torch.profiler tracing
    the card (device time per kernel group; see `trace_replays`), and
    tracing the host (time inside each stage's record_function span). The
    device's idle share is 1 - device time / plain host time per batch.
    The profiled passes run slower than the plain one; their times are for
    shares, not totals."""
    walls = []

    def serve(seed: int):
        reqs = requests_from_ragged_batch(
            batch_fn(cfg, n_batches * BUCKET, seed), cfg.n_tables)

        def run() -> None:
            t0 = time.perf_counter()
            for i in range(0, len(reqs), BUCKET):
                for r in reqs[i:i + BUCKET]:
                    engine.submit(r)
                engine.step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3 / n_batches)
        return run

    lead_in = requests_from_ragged_batch(batch_fn(cfg, BUCKET, 11),
                                         cfg.n_tables)

    def lead() -> None:
        for r in lead_in:
            engine.submit(r)
        engine.step()
    torch.cuda.synchronize()
    serve(8)()
    device = trace_replays(serve(9), n_batches, lead)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as host_prof:
        serve(10)()
    stats = _record_stats(device["records"], n_batches)
    busy = stats["device_busy_ms_per_batch"]
    host = {e.key: e.cpu_time_total / 1e3 / n_batches
            for e in host_prof.key_averages() if e.key in STAGES}
    return {"batches": n_batches, "wall_ms_per_batch": walls[0],
            "device_traced_wall_ms_per_batch": walls[-2],
            "host_traced_wall_ms_per_batch": walls[-1], **stats,
            "kernels_by_replay": device["by_replay"],
            "trace_takes": device["takes"],
            "device_idle_share": (1.0 - busy / walls[0]) if busy else None,
            "host_stage_ms_per_batch": host}


TRACE_TAKES = 5                    # takes of a trace that lost records


def trace_replays(run, n_batches: int, lead_in) -> dict:
    """Trace the card while ``lead_in()`` serves one micro-batch and then
    ``run()`` serves ``n_batches``, each one replay of the same graph, and
    join each replay's kernels to its cudaGraphLaunch by CUPTI correlation
    id. The lead-in's replay is not counted: once LM serving (phase 10) has
    run in the process, the first replay of every trace lacks its first
    kernels' records (whatever the idle time before it), and no other
    record carries them. The trace is whole when it holds ``n_batches``
    more launches that ran the same kernels: one graph runs the same nodes
    at every replay, so a replay that shows fewer is a trace that lost
    records, not a replay that ran fewer, and a replay that shows none is
    a trace that lost them all. CUPTI also now and then loses whole
    replays, or every device record, of a trace; such a trace is taken
    again, at most TRACE_TAKES times in all. ``by_replay`` is one replay's kernels per
    kernel group, ``records`` the device records (name, us) of ``run()``."""
    for take in range(1, TRACE_TAKES + 1):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            lead_in()
            torch.cuda.synchronize()
            run()
            torch.cuda.synchronize()
        events = prof.profiler.kineto_results.events()
        split = _lead_in_end(events)
        replays = [] if split is None else _replays(events, split)
        kinds = {}
        for r in replays:
            key = tuple(sorted(r.items()))
            kinds[key] = kinds.get(key, 0) + 1
        if len(replays) == n_batches and len(kinds) == 1 and replays[0]:
            return {"by_replay": _by_group(replays[0]),
                    "by_name": replays[0],
                    "takes": take, "records": [
                        (e.name(), e.duration_ns() / 1e3) for e in events
                        if e.device_type() == torch.autograd.DeviceType.CUDA
                        and e.correlation_id() > split]}
        common = max(kinds, key=kinds.get) if kinds else ()
        print(f"  trace take {take}: {len(replays)} graph launches of "
              f"{n_batches} after the lead-in; kernel sets (replays: "
              f"kernels against the commonest set) "
              f"{[(n, _diff(dict(k), dict(common))) for k, n in kinds.items()]}")
    fail(f"{TRACE_TAKES} traces of {n_batches} replayed micro-batches lost "
         f"records: the last held {len(replays)} graph launches after the "
         f"lead-in with {len(kinds)} different kernel sets")


def _diff(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) - b.get(k, 0) for k in set(a) | set(b)
            if a.get(k, 0) != b.get(k, 0)}


def _by_group(replay: dict) -> dict:
    out = {}
    for name, n in replay.items():
        g = _kernel_group(name)
        out[g] = out.get(g, 0) + n
    return out


def _lead_in_end(events):
    """The correlation id that ends the lead-in: CUPTI's ids grow with the
    API calls, and the lead-in ends at the first cudaDeviceSynchronize
    after its graph launch (the engine itself waits on events alone).
    None when the trace holds no such launch or synchronize."""
    launches = [e.correlation_id() for e in events
                if e.name().startswith("cudaGraphLaunch")]
    if not launches:
        return None
    syncs = [e.correlation_id() for e in events
             if e.name() == "cudaDeviceSynchronize"
             and e.correlation_id() > min(launches)]
    return min(syncs) if syncs else None


def _replays(events, split: int) -> list:
    """Each cudaGraphLaunch after ``split``: its kernels by name, joined by
    CUPTI correlation id (a graph's kernels carry its launch's)."""
    launches = {e.correlation_id(): {} for e in events
                if e.name().startswith("cudaGraphLaunch")
                and e.correlation_id() > split}
    for e in events:
        got = launches.get(e.correlation_id())
        if got is not None \
                and e.device_type() == torch.autograd.DeviceType.CUDA:
            got[e.name()] = got.get(e.name(), 0) + 1
    return list(launches.values())


def _record_stats(records: list, n_batches: int) -> dict:
    """Device time per kernel name and group, and kernels (copies and
    fills apart) and records per group, per micro-batch, of a trace's
    device records."""
    by_name, groups, counts, kernels = {}, {}, {}, 0
    for name, us in records:
        g = _kernel_group(name)
        by_name[name] = by_name.get(name, 0.0) + us
        groups[g] = groups.get(g, 0.0) + us / 1e3 / n_batches
        counts[g] = counts.get(g, 0) + 1 / n_batches
        low = name.lower()
        kernels += "memcpy" not in low and "memset" not in low
    return {"device_us_by_kernel": by_name, "device_ms_per_batch": groups,
            "device_busy_ms_per_batch": sum(groups.values()),
            "kernels_per_batch": kernels / n_batches,
            "kernels_by_group": counts}


def _cpu(params) -> dict:
    return {"bottom": [(w.cpu(), b.cpu()) for w, b in params["bottom"]],
            "top": [(w.cpu(), b.cpu()) for w, b in params["top"]],
            "arena": params["arena"].cpu()}


def _print_profile(prof: dict, what: str) -> None:
    print(f"  {what}: per micro-batch of {BUCKET}: host "
          f"{prof['wall_ms_per_batch']:.4f} ms, device "
          f"{prof['device_busy_ms_per_batch']:.4f} ms "
          f"{ {k: round(v, 5) for k, v in prof['device_ms_per_batch'].items()} }"
          f", device idle share {prof['device_idle_share']}, "
          f"{prof['kernels_per_batch']:.1f} kernels")
    print(f"  {what}: host ms per micro-batch inside each stage (traced, "
          f"{prof['host_traced_wall_ms_per_batch']:.4f} ms per batch): "
          f"{ {k: round(v, 4) for k, v in prof['host_stage_ms_per_batch'].items()} }")


def phase_serve(cfg, params) -> tuple:
    t0 = time.perf_counter()
    engine, probs = serve(cfg, params, "cuda")
    serve_s = time.perf_counter() - t0
    launches = launch_counts()
    stats = engine.stats()
    print(f"  served {engine.served} requests in {engine.batches} batches "
          f"({serve_s:.2f} s with warmup); launches {launches}")
    print(f"  stats {stats}")
    if engine.served != N_REQUESTS:
        fail(f"served {engine.served} of {N_REQUESTS} requests")
    _check_launches(launches, "per_forward", 2 * engine.captures,
                    "fp plan")
    if not (np.isfinite(probs).all() and (probs > 0).all()
            and (probs < 1).all()):
        fail("probabilities outside (0, 1) or not finite")
    _, cpu_probs = serve(cfg, _cpu(params), "cpu")
    err = float(np.abs(probs - cpu_probs).max())
    print(f"  card vs CPU path: max |prob diff| {err:.3e} (atol {PROB_ATOL})")
    if err > PROB_ATOL:
        fail(f"card probabilities differ from the CPU path by {err}")
    prof = profile_serve(engine, cfg)
    _print_profile(prof, "fp plan")
    _check_replay(prof, "per_forward", "fp plan")
    return {"launches": launches, "stats": stats, "batches": engine.batches,
            "serve_s": serve_s, "prob_max_abs_err": err,
            "prob_range": [float(probs.min()), float(probs.max())],
            "profile": prof}, probs


# ---------------------------------------------------------------- phase 4

def _runs(ids: torch.Tensor, off: torch.Tensor, skip, n_rows: int) -> dict:
    """Longest run of one destination among the valid positions, the
    skipped row's run apart, and the rows touched."""
    pos = torch.arange(ids.numel(), device=ids.device)
    rows, counts = torch.unique(ids[pos < off[-1]], return_counts=True)
    real = (rows != (-1 if skip is None else skip)) & (rows < n_rows)
    return {"longest_run": int(counts[real].max()) if real.any() else 0,
            "skipped_run": int(counts[~real].sum()),
            "touched_rows": int(real.sum())}


# the wrapper's two kernels: the partition by owner block, and the main one
SLS_SYMBOLS = ("sls_grad_partition_kernel", "sls_grad_table_kernel")


def sls_device_parts(fn, reps: int = 20) -> dict:
    """Device ms per call of each kernel the wrapper runs, and kernels a
    call (torch.profiler); fails if anything but its two kernels runs. A
    trace that comes back empty is taken once more, then reported as not
    measured."""
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        parts = {name: us / 1e3 / reps
                 for name, us in _kernel_times_us(prof).items()}
        if parts:
            break
    others = [k for k in parts if not any(s in k for s in SLS_SYMBOLS)]
    if others:
        fail(f"sls_grad_table: the wrapper ran more than its kernels: "
             f"{others}")
    return {"by_kernel": parts or None,
            "kernels_per_call": _kernel_count(prof) / reps if parts
            else None}


def sls_row(what: str, samples: int, g, ids, off, n_rows: int,
            skip) -> dict:
    """Times of the wrapper at one of the path's calls, beside the plain
    version, ``zeros`` + ``index_add_`` and the bound: each input read
    once (ids, offsets, g) and the whole (n_rows, D) output written."""
    n_bags, d = g.shape
    pos = torch.arange(ids.numel(), device="cuda", dtype=torch.int32)
    bag = torch.clamp(torch.searchsorted(off[1:], pos, right=True),
                      max=n_bags - 1)
    keep = pos < off[-1]
    if skip is not None:
        keep &= ids != skip
    valid = keep.float()[:, None]

    def kernel():
        return eg_k.sls_grad_table(g, ids, off, n_rows=n_rows, skip_row=skip)

    bound_ms, by = bound(4 * (ids.numel() + off.numel() + n_bags * d
                              + n_rows * d), int(keep.sum()) * d)
    return {"what": what, "samples": samples, "positions": ids.numel(),
            "n_rows": n_rows, **_runs(ids, off, skip, n_rows),
            "device_parts": sls_device_parts(kernel),
            **measure(kernel, lambda: ref.sls_grad_table(g, ids, off, n_rows),
                      lambda: torch.zeros(n_rows, d, device="cuda")
                      .index_add_(0, ids, g[bag] * valid)),
            "bound_ms": bound_ms, "bound_by": by}


def _hot_ids(gen, n: int, hot: list, n_rows: int) -> torch.Tensor:
    """n ids: each of the `hot` (row, share) pairs takes its share of
    the positions, the rest uniform over the table, in random order."""
    ids = torch.randint(0, n_rows, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    u = torch.rand(n, generator=gen, device="cuda")
    edge = 0.0
    for row, share in hot:
        ids = torch.where((u >= edge) & (u < edge + share), row, ids)
        edge += share
    return ids.to(torch.int32)


def check_sls_grad_table(cfg, gen) -> tuple:
    """The kernel at the training path's shapes: the dense-gradient
    backward over the dense id form (null row skipped, 6,400 and 409,600
    positions), the sparse step's row gradients, and edge cases: runs
    longer than a chunk, runs on both sides of the boundaries between
    blocks' rows, one row for every position, skip_row inside a hot run,
    tables smaller than a block's rows, D = 1, 6 and 48, unaligned ids.
    Every case must equal the plain version on the CPU bit for bit and
    repeat bit for bit on a second launch."""
    name = "sls_grad_table"
    spec = dlrm.arena_spec(cfg)
    d = spec.dim
    errs = []

    def check(g, ids, off, n_rows, skip, what, card_plain=True):
        k1 = eg_k.sls_grad_table(g, ids, off, n_rows=n_rows, skip_row=skip)
        k2 = eg_k.sls_grad_table(g, ids, off, n_rows=n_rows, skip_row=skip)
        torch.cuda.synchronize()
        if not torch.equal(k1, k2):
            fail(f"{name} {what}: two launches differ")
        cpu = ref.sls_grad_table(g.cpu(), ids.cpu(), off.cpu(), n_rows)
        if skip is not None:
            cpu[skip] = 0.0
        if not torch.equal(k1.cpu(), cpu):
            fail(f"{name} {what}: differs from the plain version on the "
                 f"CPU by {(k1.cpu() - cpu).abs().max().item()}")
        if not card_plain:
            print(f"  {name:24s} {what:34s} equal to the CPU plain version")
            return
        plain = ref.sls_grad_table(g, ids, off, n_rows)
        if skip is not None:
            plain[skip] = 0.0
        errs.append(compare(name, k1, plain, what))

    rows = []
    for b in (BUCKET, LARGE):
        ids = serving_dense_ids(cfg, b, seed=13).reshape(-1)
        n_bags = b * cfg.n_tables
        off = torch.arange(n_bags + 1, dtype=torch.int32,
                           device="cuda") * MAX_L
        g = torch.randn((n_bags, d), generator=gen, device="cuda")
        check(g, ids, off, spec.total_rows, spec.null_row,
              f"dense ids, {ids.numel()} positions")
        rows.append(sls_row("dense ids", b, g, ids, off, spec.total_rows,
                            spec.null_row))
    # the sparse step's use: row gradients over unique-row ids, n_rows = N
    rb = DLRMSynthetic(cfg, seed=14).ragged_batch(
        BUCKET, max_l=MAX_L, pad_to=BUCKET * cfg.n_tables * MAX_L)
    idx = torch.from_numpy(rb["indices"]).cuda()
    off = torch.from_numpy(rb["offsets"]).cuda()
    flat = se.flatten_ragged_indices(spec, idx, off)
    _, inv = unique_padded(flat, spec.null_row)
    inv = inv.to(torch.int32)
    g = torch.randn((off.numel() - 1, d), generator=gen, device="cuda")
    check(g, inv, off, flat.numel(), None, "unique-row ids (sparse step)")
    rows.append(sls_row("sparse step row gradients", BUCKET, g, inv, off,
                        flat.numel(), None))
    check(g, flat, off, spec.total_rows, None, "ragged, padded tail")
    # edges: empty bags and a padded tail, D = 16, no ids at all
    small_off = torch.tensor([0, 0, 3, 3, 7, 9], dtype=torch.int32,
                             device="cuda")
    small_ids = torch.randint(0, 6, (12,), generator=gen, device="cuda",
                              dtype=torch.int32)
    check(torch.randn((5, 16), generator=gen, device="cuda"), small_ids,
          small_off, 6, 2, "empty bags, padded tail, D = 16")
    check(torch.randn((5, 16), generator=gen, device="cuda"),
          small_ids[:0].contiguous(), torch.zeros_like(small_off), 6, None,
          "N = 0")
    # the schedule's edges, at the kernels' plan for each shape: 128
    # blocks own granules of 4 rows (D = 32), chunks of 4,096 positions;
    # past 8,192 positions the partition kernel runs first
    v, n = 100_000, 12_000
    off = torch.arange(0, n + 1, 10, dtype=torch.int32, device="cuda")
    off[-1] = n - 7                              # a padded tail
    g = torch.randn((off.numel() - 1, d), generator=gen, device="cuda")
    for hot, skip, what in (
            ([(77, 0.75)], None, "a run of ~9,000: three chunks"),
            ([(77, 0.6), (78, 0.3)], 77, "skip_row inside a hot run"),
            ([(3, 1.0)], None, "every position on one row"),
            ([(3, 0.2), (4, 0.2), (511, 0.2), (512, 0.2)], None,
             "runs on both sides of block edges")):
        check(g, _hot_ids(gen, n, hot, v), off, v, skip, what,
              card_plain=False)
    ids = _hot_ids(gen, n + 1, [(5, 0.5)], v)
    check(g, ids[1:], off, v, None, "ids not 16-byte aligned",
          card_plain=False)
    # no partition (8,000 positions): one row takes both tiles, two chunks
    check(g[:800].contiguous(), _hot_ids(gen, n, [(9, 1.0)], v)[:8_000],
          off[:801].contiguous(), v, None, "8,000 on one row, no partition",
          card_plain=False)
    for dim, v in ((1, 3), (6, 5), (48, 5), (32, 5), (1, 300)):
        gd = torch.randn((off.numel() - 1, dim), generator=gen,
                         device="cuda")
        check(gd, _hot_ids(gen, n, [(1, 0.5)], v), off, v, 0 if v > 5
              else None, f"{v} rows, D = {dim}", card_plain=False)
    return max(errs), rows


def check_gemm_backward(params, gen) -> tuple:
    """The two backward GEMMs of every layer, dx = g w^T (``gemm_nt``) and
    dw = x^T g (``gemm_tn``), each operand read in place, at batch 32 and
    2048 against the plain versions; two launches equal bit for bit.
    Times per batch, the twelve products summed, against
    ``torch.matmul(g, w.t())`` and ``torch.matmul(x.t(), g)``."""
    name = "gemm"
    layers = _gemm_layers(params)
    errs, rows = [], []
    for b in (BUCKET, LARGE):
        shapes, kernels, plains, libraries = [], [], [], []
        for w in layers:
            k, n = w.shape
            gy = torch.randn((b, n), generator=gen, device="cuda")
            x = torch.randn((b, k), generator=gen, device="cuda")
            for what, kern, plain, lib, shape, tol in (
                    (f"dx {b} x {n} x {k}", lambda gy=gy, w=w:
                     gm_k.gemm_nt(gy, w), lambda gy=gy, w=w:
                     ref.gemm_nt(gy, w), lambda gy=gy, w=w:
                     torch.matmul(gy, w.t()), (b, n, k), None),
                    (f"dw {k} x {b} x {n}", lambda x=x, gy=gy:
                     gm_k.gemm_tn(x, gy), lambda x=x, gy=gy:
                     ref.gemm_tn(x, gy), lambda x=x, gy=gy:
                     torch.matmul(x.t(), gy), (k, b, n),
                     TOL["gemm_long"] if b > GEMM_LONG else None)):
                got, want = kern(), plain()
                errs.append(compare(name, got, want, what, tol))
                if not torch.equal(got, kern()):
                    fail(f"{name} {what}: two launches differ")
                if tol is not None:
                    exact = x.double().t() @ gy.double()
                    far = [(t.double() - exact).abs().max().item()
                           for t in (got, want)]
                    print(f"  {name:24s} {what}: from the fp64 product "
                          f"kernel {far[0]:.3e}, plain {far[1]:.3e}")
                shapes.append(shape)
                kernels.append(kern)
                plains.append(plain)
                libraries.append(lib)
        rows.append(_gemm_row(b, shapes, kernels, plains, libraries))
        r = rows[-1]
        print(f"  {name:24s} backward {b:5d} samples (dx and dw of six "
              f"layers), ms (device ms): kernel {r['ms']:.4f} "
              f"({_fmt(r['device_ms'])}), plain {r['plain_ms']:.4f} "
              f"({_fmt(r['plain_device_ms'])}), library {r['library_ms']:.4f}"
              f" ({_fmt(r['library_device_ms'])}), bound {r['bound_ms']:.5f} "
              f"({r['bound_by']})")
    return max(errs), rows


def train_batches(cfg, n: int, seed: int) -> list:
    data = DLRMSynthetic(cfg, seed=seed)
    return [data.ragged_batch(BUCKET, max_l=MAX_L,
                              pad_to=BUCKET * cfg.n_tables * MAX_L)
            for _ in range(n)]


TRAIN_KEYS = ("dense", "indices", "offsets", "labels")


def _copy(tree, device: str):
    return tree_map(lambda t: t.detach().to(device).clone()
                    if isinstance(t, torch.Tensor) else t, tree)


def _beyond(a: torch.Tensor, b: torch.Tensor, budget: int, limit: float,
            what: str, atol: float = PARAM_ATOL) -> dict:
    """Rows of a (card) and b (CPU) with an element further apart than
    ``atol``: at most `budget` of them, none further than `limit`."""
    d = (a.cpu() - b).abs().reshape(a.shape[0], -1).amax(dim=1)
    out = {"max_abs_err": d.max().item() if d.numel() else 0.0,
           "beyond": int((d > atol).sum()), "of": d.numel()}
    if out["beyond"] > budget or out["max_abs_err"] > limit:
        fail(f"{what}: {out['beyond']} of {d.numel()} beyond {atol},"
             f" max {out['max_abs_err']} (limit {limit})")
    return out


def train_card_vs_cpu(cfg, p0, batches, sparse: bool) -> dict:
    """Each step on the card, and on the CPU path from a copy of the card's
    state before it; returns the card's trajectory and the comparisons."""
    mode = "sparse" if sparse else "dense"
    spec = dlrm.arena_spec(cfg)
    opt, step = dlrm.make_train_step_ragged(cfg, max_l=MAX_L, sparse=sparse)
    params = _copy(p0, "cuda")
    state = opt.init(params)
    losses, cmp = [], []
    p_max = max(w.abs().max().item() for w in tree_leaves(
        {k: p0[k] for k in ("bottom", "top")}))
    for i, b in enumerate(batches):
        cpu_params, cpu_state = _copy(params, "cpu"), _copy(state, "cpu")
        params, state, loss, r = step(params, state, {
            k: torch.from_numpy(b[k]).cuda() for k in TRAIN_KEYS})
        cpu_params, cpu_state, cpu_loss, cpu_r = step(
            cpu_params, cpu_state,
            {k: torch.from_numpy(b[k]) for k in TRAIN_KEYS})
        losses.append(float(loss))
        rel = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
        if rel > LOSS_RTOL:
            fail(f"train {mode} step {i}: loss {float(loss)} on the card, "
                 f"{float(cpu_loss)} on the CPU")
        if not torch.equal(r.cpu(), cpu_r):
            fail(f"train {mode} step {i}: touched rows differ")
        touched = r[r != spec.null_row].long()
        mlp_card, mlp_cpu = (torch.cat([t.reshape(-1)
                                        for k in ("bottom", "top")
                                        for t in tree_leaves(p[k])])
                             for p in (params, cpu_params))
        mlp = _beyond(mlp_card, mlp_cpu, int(MLP_SHARE * mlp_cpu.numel()),
                      2 * LR * (1.01 + 0.01 * p_max),
                      f"train {mode} step {i} MLP")
        arena = _beyond(params["arena"][touched],
                        cpu_params["arena"][touched.cpu()],
                        ARENA_SAMPLES * cfg.n_tables * MAX_L,
                        2 * 10 * LR * spec.dim ** 0.5,
                        f"train {mode} step {i} arena rows")
        if params["arena"][spec.null_row].any():
            fail(f"train {mode} step {i}: the null row moved")
        cmp.append({"loss_card": float(loss), "loss_cpu": float(cpu_loss),
                    "loss_rel_err": rel, "mlp": mlp, "arena": arena})
        print(f"  train {mode:6s} step {i}: loss {float(loss):.6f} (card "
              f"vs CPU rel {rel:.1e}); touched rows equal; MLP {mlp['beyond']}"
              f" of {mlp['of']} beyond {PARAM_ATOL} (max {mlp['max_abs_err']:.1e}),"
              f" touched arena rows {arena['beyond']} of {arena['of']} (max "
              f"{arena['max_abs_err']:.1e})")
    return {"params": params, "losses": losses, "steps": cmp}


TRAIN_STAGES = ("sparse_lookup", "emb_lookup", "interaction", "mlp",
                "backward", "optimizer")


def profile_train(cfg, params, batch, sparse: bool) -> dict:
    """Where one train step's time goes (batch 32): ms per step with CUDA
    events (median over trials of TIMED_STEPS steps), device time per
    kernel group and idle share (torch.profiler tracing the card), host
    time per stage (tracing the host), and kernel launches per step."""
    opt, step = dlrm.make_train_step_ragged(cfg, max_l=MAX_L, sparse=sparse)
    state = [opt.init(params)]

    def one():
        _, state[0], _, _ = step(params, state[0], batch)

    before = launch_counts()
    ms = time_ms(one, reps=TIMED_STEPS, trials=5)
    calls = 3 + 5 * TIMED_STEPS
    after = launch_counts()
    per_step = {n: (after[n] - before[n]) / calls for n in KERNELS}
    traces = []
    for activity in (torch.profiler.ProfilerActivity.CUDA,
                     torch.profiler.ProfilerActivity.CPU):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[activity]) as prof:
            for _ in range(TIMED_STEPS):
                one()
            torch.cuda.synchronize()
        traces.append(prof)
    groups = {}
    for kname, us in _kernel_times_us(traces[0]).items():
        g = _kernel_group(kname)
        groups[g] = groups.get(g, 0.0) + us / 1e3 / TIMED_STEPS
    busy = sum(groups.values())
    host = {e.key: e.cpu_time_total / 1e3 / TIMED_STEPS
            for e in traces[1].key_averages() if e.key in TRAIN_STAGES}
    # CUDA runtime calls per step (kernel launches, copies, syncs), from
    # the card's trace, and the host ops that take the most time
    runtime = {e.key: [e.count / TIMED_STEPS,
                       e.cpu_time_total / 1e3 / TIMED_STEPS]
               for e in traces[0].key_averages() if e.key.startswith("cuda")}
    top = sorted(((e.self_cpu_time_total / 1e3 / TIMED_STEPS,
                   e.count / TIMED_STEPS, e.key)
                  for e in traces[1].key_averages()), reverse=True)[:12]
    return {"ms_per_step": ms, "device_ms_per_step": groups,
            "kernels_per_step": _kernel_count(traces[0]) / TIMED_STEPS,
            "device_busy_ms_per_step": busy,
            "device_idle_share": (1.0 - busy / ms) if busy else None,
            "host_stage_ms_per_step": host, "launches_per_step": per_step,
            "runtime_calls_per_step": runtime,
            "host_top_self_ms_per_step": top}


def phase_train(cfg, gen) -> dict:
    sls_err, sls_rows = check_sls_grad_table(cfg, gen)
    for r in sls_rows:
        parts = r["device_parts"]
        print(f"  sls_grad_table     {r['what']}, {r['samples']} samples, "
              f"{r['positions']} positions into {r['n_rows']} rows (longest "
              f"run {r['longest_run']}, skipped run {r['skipped_run']}, "
              f"{r['touched_rows']} rows touched): ms per call (device ms): "
              f"kernel {r['ms']:.4f} ({_fmt(r['device_ms'])}), plain "
              f"{r['plain_ms']:.4f} ({_fmt(r['plain_device_ms'])}), library "
              f"{r['library_ms']:.4f} ({_fmt(r['library_device_ms'])}), "
              f"bound {r['bound_ms']:.5f} ({r['bound_by']}); kernels a call "
              f"{parts['kernels_per_call']}, device ms by kernel "
              f"{parts['by_kernel']}")
    p0 = dlrm.init(torch.Generator(device="cuda").manual_seed(1), cfg,
                   device="cuda")
    gemm_err, gemm_rows = check_gemm_backward(p0, gen)
    batches = train_batches(cfg, TRAIN_STEPS, seed=21)
    out = {"sls_grad_table": {"max_abs_err": sls_err, "rows": sls_rows},
           "gemm_backward_max_abs_err": gemm_err,
           "gemm_backward_rows": gemm_rows}
    for sparse, mode in ((True, "sparse"), (False, "dense")):
        card = train_card_vs_cpu(cfg, p0, batches, sparse)
        out[mode] = {"steps": card["steps"]}
        # the main path: the uncached online trainer on the card
        trainer = OnlineTrainer(cfg, _copy(p0, "cuda"), max_l=MAX_L,
                                sparse=sparse, device="cuda")
        reset_counts()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as tprof:
            trainer.train(batches)
            torch.cuda.synchronize()
        launches = launch_counts()
        for n, k in KERNELS.items():
            if launches[n] != k["per_step"] * TRAIN_STEPS:
                fail(f"train {mode}: {n} launched {launches[n]} times in "
                     f"{TRAIN_STEPS} steps; {k['per_step']} per step")
        if trainer.losses != card["losses"] or not all(
                torch.equal(a, b) for a, b in zip(
                    tree_leaves(trainer.params),
                    tree_leaves(card["params"]))):
            fail(f"train {mode}: two runs on the card differ")
        kernels = _kernel_count(tprof) / TRAIN_STEPS
        print(f"  train {mode:6s} OnlineTrainer on the card: launches "
              f"{launches}; {kernels:.1f} kernels on the card per step; "
              f"repeats the card run bit for bit")
        out[mode]["launches"] = launches
        out[mode]["trainer_kernels_per_step"] = kernels
        batch = {k: torch.from_numpy(batches[0][k]).cuda()
                 for k in TRAIN_KEYS}
        prof = profile_train(cfg, _copy(p0, "cuda"), batch, sparse)
        out[mode]["profile"] = prof
        print(f"  train {mode:6s} per step of {BUCKET}: "
              f"{prof['ms_per_step']:.4f} ms (CUDA events), device "
              f"{prof['device_busy_ms_per_step']:.4f} ms "
              f"{ {k: round(v, 5) for k, v in prof['device_ms_per_step'].items()} }"
              f", idle share {prof['device_idle_share']}")
        print(f"  train {mode:6s} gemm device ms per step "
              f"{prof['device_ms_per_step'].get('gemm', 0.0):.5f}, "
              f"sls_grad_table "
              f"{prof['device_ms_per_step'].get('sls_grad_table', 0.0):.5f}"
              f"; kernels on the card per step {prof['kernels_per_step']:.1f}")
        print(f"  train {mode:6s} host ms per step inside each stage "
              f"(traced): "
              f"{ {k: round(v, 4) for k, v in prof['host_stage_ms_per_step'].items()} }"
              f"; launches per step {prof['launches_per_step']}")
        print(f"  train {mode:6s} CUDA runtime calls per step [count, host "
              f"ms]: { {k: [round(x, 3) for x in v] for k, v in prof['runtime_calls_per_step'].items()} }")
        print(f"  train {mode:6s} host ops by self ms per step (traced): "
              f"{[(round(t, 3), round(c, 1), k) for t, c, k in prof['host_top_self_ms_per_step']]}")
    # the launcher's --ragged path, on the card by default (no --device)
    for extra in ([], ["--dense-grads"]):
        loss = train_launcher.main(["--arch", "dlrm1", "--ragged", "--steps",
                                    "3", "--log-every", "1", *extra])
        if not np.isfinite(loss):
            fail(f"launcher {extra}: final loss {loss}")
        out[f"launcher_loss{''.join(extra)}"] = loss
    return out


# ---------------------------------------------------------------- phase 5

def _check_launches(launches: dict, per: str, n: int, what: str) -> None:
    """The wrappers' counts of a served run on the card: ``n`` forwards
    through them, two for each captured (path, bucket) pair (its eager
    pass and its capture); the served micro-batches replay graphs."""
    for name, k in KERNELS.items():
        want = k[per] * n
        if launches[name] != want or (k[per] and not want):
            fail(f"{what}: {name} launched {launches[name]} times; "
                 f"{k[per]} per forward x {n} forwards (an eager pass and "
                 f"a capture for each pair) = {want}")


def _check_replay(prof: dict, per, what: str) -> None:
    """Every replayed micro-batch's kernels, by name from the profiler's
    trace of the card (joined to their graph launch, `trace_replays`),
    against the wrappers' counts of one forward at capture (``per``: a
    KERNELS column, or {kernel: count})."""
    got = prof["kernels_by_replay"]
    for name, k in KERNELS.items():
        want = k[per] if isinstance(per, str) else per.get(name, 0)
        if got.get(name, 0) != want:
            fail(f"{what}: each replayed micro-batch ran {got.get(name, 0)} "
                 f"{name} kernels (profiler), its capture {want}")
    print(f"  {what}: each replayed micro-batch's kernels by name "
          f"(profiler, trace taken {prof['trace_takes']}x) equal its "
          f"capture's counts: "
          f"{ {n: v for n, v in got.items() if n in KERNELS} }")


def recount_hit_rate(cfg, cache) -> float:
    """The served ids' hit rate, recounted in numpy from the requests."""
    rb = served_batch(cfg)
    spec = dlrm.arena_spec(cfg)
    off = rb["offsets"]
    seg = np.searchsorted(off[1:], np.arange(off[-1]), side="right")
    flat = rb["indices"][:off[-1]] + (seg % spec.n_tables) \
        * spec.rows_per_table
    return float((cache.slot_of.cpu().numpy()[flat] < cache.k).sum()
                 / flat.size)


def phase_serve_cached(cfg, params, fp_probs) -> dict:
    counts = warm_counts(cfg)
    plan = {"source": "cached", "cache_k": CACHE_K, "cache_trace": counts}
    t0 = time.perf_counter()
    engine, probs = serve(cfg, params, "cuda", **plan)
    serve_s = time.perf_counter() - t0
    launches = launch_counts()
    stats = engine.stats()
    print(f"  served {engine.served} requests in {engine.batches} batches "
          f"({serve_s:.2f} s with warmup); launches {launches}")
    print(f"  stats {stats}")
    if engine.served != N_REQUESTS:
        fail(f"cached: served {engine.served} of {N_REQUESTS} requests")
    _check_launches(launches, "per_cached_forward", 2 * engine.captures,
                    "cached plan")
    # the kernel through its stage entry: the split made inside it
    if fd_k.cached_stage_launches != 2 * engine.captures:
        fail(f"cached plan: the stage entry launched "
             f"{fd_k.cached_stage_launches} times in "
             f"{2 * engine.captures} forwards")
    print(f"  cached plan: {fd_k.cached_stage_launches} launches of the "
          f"stage entry, one a forward")
    if not np.array_equal(probs, fp_probs):
        fail(f"cached plan differs from the fp plan by "
             f"{np.abs(probs - fp_probs).max()} (must be equal)")
    print("  cached plan: every probability equal to the fp plan's "
          "(np.array_equal)")
    _, cpu_probs = serve(cfg, _cpu(params), "cpu", **plan)
    err = float(np.abs(probs - cpu_probs).max())
    print(f"  card vs CPU path: max |prob diff| {err:.3e} (atol {PROB_ATOL})")
    if err > PROB_ATOL:
        fail(f"cached: card probabilities differ from the CPU path by {err}")
    recount = recount_hit_rate(cfg, engine.cache)
    print(f"  hit rate {stats['cache_hit_rate']} (numpy recount {recount})")
    if stats["cache_hit_rate"] != recount:
        fail(f"hit rate {stats['cache_hit_rate']} against a recount of "
             f"{recount}")
    prof = profile_serve(engine, cfg)
    _print_profile(prof, "cached plan")
    _check_replay(prof, "per_cached_forward", "cached plan")
    print(f"  cached plan: {prof['kernels_per_batch']:.1f} kernels a "
          f"micro-batch on the card (profiler), the hit split inside the "
          f"gather")
    out = {"launches": launches, "stats": stats, "batches": engine.batches,
           "serve_s": serve_s, "prob_max_abs_err": err,
           "hit_rate_recount": recount, "profile": prof}
    # the int8 cold arena: hot rows fp, the tail int8 (torch ops, no kernel
    # of the port in the embedding stage)
    plan["quantize_cold"] = True
    engine, probs = serve(cfg, params, "cuda", **plan)
    launches = launch_counts()
    per_int8 = {n: (k["per_cached_forward"] if n in ("gemm", "interaction")
                    else 0) for n, k in KERNELS.items()}
    want = {n: c * 2 * engine.captures for n, c in per_int8.items()}
    if launches != want or fd_k.cached_stage_launches:
        fail(f"int8 cold: launches {launches}, expected {want}; stage "
             f"entry {fd_k.cached_stage_launches}")
    _, cpu_probs = serve(cfg, _cpu(params), "cpu", **plan)
    err = float(np.abs(probs - cpu_probs).max())
    err_fp = float(np.abs(probs - fp_probs).max())
    print(f"  int8 cold: card vs CPU path max |prob diff| {err:.3e} (atol "
          f"{PROB_ATOL}); against the fp plan {err_fp:.3e} (bound "
          f"{INT8_PROB_ATOL}); launches {launches}")
    if err > PROB_ATOL or err_fp > INT8_PROB_ATOL:
        fail(f"int8 cold: {err} from the CPU path, {err_fp} from fp")
    prof8 = profile_serve(engine, cfg)
    _print_profile(prof8, "int8 cold")
    _check_replay(prof8, per_int8, "int8 cold")
    out["int8"] = {"launches": launches, "stats": engine.stats(),
                   "prob_max_abs_err": err, "prob_max_abs_err_vs_fp": err_fp,
                   "profile": prof8}
    return out


# ---------------------------------------------------------------- phase 6

def _requests(batch: dict, cfg) -> list:
    return requests_from_ragged_batch(batch, cfg.n_tables)


def _served(engine, reqs) -> np.ndarray:
    for r in reqs:
        engine.submit(r)
    engine.drain()
    return np.array([r.prob for r in reqs], np.float32)


def _uncached(cfg, engine, params, reqs) -> np.ndarray:
    """The uncached forward on ``params`` over the batch the engine pads
    these requests to; its launches do not count."""
    with uncounted():
        batch, _ = engine._assemble(reqs, BUCKET)
        step = dlrm.make_ragged_serve_step(cfg, max_l=MAX_L)
        return step(params, batch).cpu().numpy()


def trainer_telemetry(trainer, steps: int, rebuilds: int) -> dict:
    """Phase 13(f), on phase 6's trainer: its counters against the steps
    and rebuilds it took, one ``hot_cache_rebuild`` and one ``publish``
    event a rebuild, and its snapshot through ``json.dumps``."""
    tel = trainer.telemetry
    reg = tel.registry
    got = {"train_steps_total": reg.counter("train_steps_total").value,
           "train_rebuilds_total": reg.counter("train_rebuilds_total").value,
           "hot_cache_rebuild": len(tel.events.query("hot_cache_rebuild")),
           "publish": len(tel.events.query("publish"))}
    want = {"train_steps_total": steps, "train_rebuilds_total": rebuilds,
            "hot_cache_rebuild": rebuilds, "publish": rebuilds}
    if got != want:
        fail(f"online: the trainer's telemetry reads {got}, the run {want}")
    snap = tel.snapshot()
    if json.loads(json.dumps(snap)) != snap:
        fail("online: the trainer's telemetry snapshot does not round-trip "
             "through json")
    print(f"  13(f) trainer telemetry: {got} for {steps} steps and "
          f"{rebuilds} rebuilds; train_loss gauge "
          f"{reg.gauge('train_loss').value:.6f}; the snapshot round-trips "
          f"through json ({len(json.dumps(snap))} bytes)")
    return got


def phase_online(cfg) -> dict:
    spec = dlrm.arena_spec(cfg)
    p0 = dlrm.init(torch.Generator(device="cuda").manual_seed(2), cfg,
                   device="cuda")
    tel = obs.Telemetry()
    trainer = OnlineTrainer(cfg, p0, max_l=MAX_L, device="cuda",
                            cache_cfg=OnlineCacheConfig(k=CACHE_K,
                                                        refresh_every=REFRESH),
                            telemetry=tel)
    reset_counts()
    engine = RecEngine(cfg, trainer.params, source="cached", cache_k=CACHE_K,
                       cache_trace=np.ones(spec.total_rows), max_l=MAX_L,
                       max_batch=BUCKET, device="cuda")
    engine.warmup()
    captures = engine.captures
    train = make_drifting_zipf(cfg, batch_size=BUCKET, mean_l=20,
                               max_l=MAX_L, drift_per_batch=DRIFT, seed=3)
    traffic = make_drifting_zipf(cfg, batch_size=BUCKET, mean_l=20,
                                 max_l=MAX_L, drift_per_batch=DRIFT, seed=4)
    step_ms, checks, first_blob, at_sync = [], [], None, None
    served_batches = 0
    for step in range(1, ONLINE_STEPS + 1):
        batch, live = next(train), next(traffic)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        since = step % REFRESH
        what = None
        if since == 0:
            # a rebuild just ran: the params copy, then the published cache
            blob = trainer.publish()
            first_blob = first_blob or blob
            engine.params = trainer.params
            if not VersionedHotCache.deserialize(blob,
                                                 device="cuda").apply(engine):
                fail(f"online step {step}: version {trainer.version} was "
                     f"not adopted")
            with uncounted():
                at_sync = _copy(trainer.params, "cuda")
            what = f"v{engine.cache_version} adopted"
        elif since == UNSYNCED and at_sync is not None:
            what = f"{UNSYNCED} steps unsynced"
        elif since == REFRESH // 2 and at_sync is not None:
            if not trainer.sync_engine(engine):
                fail(f"online step {step}: sync_engine did not publish")
            with uncounted():
                at_sync = _copy(trainer.params, "cuda")
            what = f"sync_engine at v{engine.cache_version}"
        if what is None:
            continue
        reqs = _requests(live, cfg)
        got = _served(engine, reqs)
        served_batches += 1
        want = _uncached(cfg, engine, at_sync, reqs)
        if not np.array_equal(got, want):
            fail(f"online step {step} ({what}): served probabilities differ "
                 f"from the forward as of the sync by "
                 f"{np.abs(got - want).max()}")
        live_diff = float(np.abs(
            _uncached(cfg, engine, trainer.params, reqs) - got).max())
        if since == UNSYNCED and live_diff == 0.0:
            fail(f"online step {step}: the unsynced engine served the live "
                 f"params")
        checks.append({"step": step, "what": what,
                       "version": engine.cache_version,
                       "hit_rate": engine.stats()["cache_hit_rate"],
                       "max_abs_diff_vs_live": live_diff})
        print(f"  online step {step:2d}: {what}; served batch equal to the "
              f"forward as of the sync (bit for bit); |served - live "
              f"forward| {live_diff:.3e}; hit rate "
              f"{checks[-1]['hit_rate']}")
    launches = launch_counts()
    n_steps = ONLINE_STEPS
    telemetry = trainer_telemetry(trainer, n_steps, ONLINE_STEPS // REFRESH)
    if engine.captures != captures:
        fail(f"online: the swaps recaptured ({engine.captures} captures, "
             f"{captures} after warmup)")
    for name, k in KERNELS.items():
        want = k["per_step"] * n_steps \
            + k["per_cached_forward"] * 2 * captures
        on_path = k["per_step"] or k["per_cached_forward"]
        if launches[name] != want or (on_path and not launches[name]):
            fail(f"online: {name} launched {launches[name]} times; "
                 f"{k['per_step']} x {n_steps} steps + "
                 f"{k['per_cached_forward']} x {2 * captures} forwards of "
                 f"warmup's captures = {want}")
    print(f"  online launches {launches} ({n_steps} steps; {served_batches} "
          f"served micro-batches replayed the {captures} graphs of warmup, "
          f"none recaptured)")
    # a stale artifact is refused
    old = VersionedHotCache.deserialize(first_blob, device="cuda")
    if old.apply(engine):
        fail("online: a stale hot-cache artifact was adopted")
    try:
        engine.update_cache(old.cache, version=old.version)
    except ValueError as e:
        print(f"  stale artifact v{old.version} absorbed by apply and "
              f"refused by update_cache: {e}")
    else:
        fail("online: update_cache took a stale version")
    # the whole source, adopted by a fresh engine
    blob = trainer.publish_source(include_head=True)
    with uncounted():
        fresh = RecEngine(cfg, dlrm.init(torch.Generator(device="cuda")
                                         .manual_seed(99), cfg,
                                         device="cuda"),
                          source="cached", cache_k=CACHE_K, max_l=MAX_L,
                          max_batch=BUCKET, device="cuda")
        fresh.warmup()
    if not VersionedSource.deserialize(blob, device="cuda").apply(fresh):
        fail("online: a fresh engine refused publish_source()")
    reqs = _requests(next(traffic), cfg)
    got = _served(fresh, reqs)
    if not np.array_equal(got, _uncached(cfg, fresh, trainer.params, reqs)):
        fail("online: the adopted full source differs from the live forward")
    print(f"  publish_source(include_head=True): {len(blob)} bytes, "
          f"adopted by a fresh engine at v{fresh.source_version}; served "
          f"batch equal to the live forward (bit for bit)")
    # costs: step ms (rebuild steps apart), the rebuild's own work and the
    # host work of observe (bincount over the arena's rows + decay)
    rebuild_steps = [m for i, m in enumerate(step_ms, 1) if i % REFRESH == 0]
    plain_steps = [m for i, m in enumerate(step_ms, 1) if i % REFRESH]
    b = next(train)
    obs_ms = []
    for _ in range(10):
        hist = trainer.hist.copy()
        t0 = time.perf_counter()
        counts = se.trace_row_counts(spec, b["indices"], b["offsets"])
        hist = trainer.cache_cfg.decay * hist + counts
        obs_ms.append((time.perf_counter() - t0) * 1e3)
    rebuild_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        se.build_hot_cache(trainer.params["arena"], spec, trainer.hist,
                           CACHE_K)
        torch.cuda.synchronize()
        rebuild_ms.append((time.perf_counter() - t0) * 1e3)
    costs = {"step_ms_median": float(np.median(plain_steps)),
             "rebuild_step_ms": rebuild_steps,
             "rebuild_ms_median": float(np.median(rebuild_ms)),
             "observe_host_ms_median": float(np.median(obs_ms)),
             "publish_bytes": len(trainer.publish()),
             "publish_source_bytes": len(blob)}
    print(f"  online costs: step {costs['step_ms_median']:.3f} ms (median "
          f"of the {len(plain_steps)} steps without a rebuild), rebuild "
          f"steps {[round(m, 3) for m in rebuild_steps]} ms, build_hot_cache "
          f"{costs['rebuild_ms_median']:.3f} ms, observe's host work "
          f"{costs['observe_host_ms_median']:.3f} ms, hot-cache blob "
          f"{costs['publish_bytes']} bytes")
    return {"launches": launches, "served_batches": served_batches,
            "checks": checks, "costs": costs, "losses": trainer.losses,
            "telemetry": telemetry}


# ---------------------------------------------------------------- phase 7

def fixed_as_ragged(b: dict) -> dict:
    """A DLRMSynthetic.batch in the ragged dict form: every bag L long."""
    n, t, n_l = b["indices"].shape
    return {"dense": b["dense"], "indices": b["indices"].reshape(-1),
            "offsets": (np.arange(n * t + 1) * n_l).astype(np.int32),
            "labels": b["labels"]}


def fixed_batch(cfg, n: int, seed: int) -> dict:
    return fixed_as_ragged(DLRMSynthetic(cfg, seed=seed).batch(n))


@dataclasses.dataclass(frozen=True)
class FlatArena(es.EmbeddingSource):
    """A source as the protocol lets a user add one: ``reduce_flat``
    alone. Both entry points reach it through the base class's fallback
    ``reduce_dense``, so its lookups run on ``sparse_lengths_sum``."""
    arena: torch.Tensor

    @property
    def out_dtype(self) -> torch.dtype:
        return self.arena.dtype

    def reduce_flat(self, spec, flat, offsets, *, max_l):
        return ops.sparse_lengths_sum(self.arena, flat, offsets,
                                      max_l=max_l).float()


def serve_flat(cfg, params, fp_probs) -> dict:
    """Phase 3's requests, in its micro-batches of 32 and its padded
    shapes, through the ragged serve step over a FlatArena."""
    rb = served_batch(cfg)
    dev = {k: torch.from_numpy(rb[k]).cuda()
           for k in ("dense", "indices", "offsets")}
    n = N_REQUESTS // BUCKET
    idx_s, off_s = hybrid.split_ragged_microbatches(
        dev["indices"], dev["offsets"], n, MAX_L)
    dense_s = dev["dense"].reshape(n, BUCKET, -1)
    step = dlrm.make_ragged_serve_step(cfg, max_l=MAX_L)
    src = FlatArena(params["arena"])
    reset_counts()
    probs = [step(params, {"dense": dense_s[i], "indices": idx_s[i],
                           "offsets": off_s[i]}, src) for i in range(n)]
    launches = launch_counts()
    _check_launches(launches, "per_flat_forward", n, "flat route")
    probs = torch.cat(probs).cpu().numpy().astype(np.float64)
    if not np.array_equal(probs, fp_probs):
        fail(f"flat route differs from the fp plan by "
             f"{np.abs(probs - fp_probs).max()} (must be equal)")
    print(f"  flat route (reduce_flat-only source, {n} micro-batches): "
          f"every probability equal to phase 3's fp plan (np.array_equal); "
          f"launches {launches}")
    return {"launches": launches, "batches": n}


def stream_profile(fn, tag: str, reps: int = 10) -> dict:
    """Kernel intervals of ``reps`` calls from the profiler's trace of the
    card (kept beside the --out file): device busy time per call (the
    union of kernel intervals), summed kernel time, the time two kernels
    ran at once (in a pipeline only kernels of different streams can) and
    the streams used."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(TRACE_DIR or tmp) / f"trace_{tag}.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    ks = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                 e.get("args", {}).get("stream"))
                for e in events if e.get("cat") == "kernel" and "dur" in e)
    if not ks:
        return {"kernels": 0}
    total = sum(b - a for a, b, _ in ks)
    union, (lo, hi) = 0.0, ks[0][:2]
    for a, b, _ in ks[1:]:
        if a > hi:
            union += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    union += hi - lo
    return {"kernels": len(ks) / reps,
            "streams": sorted({str(st) for *_, st in ks}),
            "device_busy_ms": union / 1e3 / reps,
            "kernel_sum_ms": total / 1e3 / reps,
            "overlap_ms": (total - union) / 1e3 / reps,
            "trace": str(path) if TRACE_DIR else None}


def check_pipelines(cfg, params) -> dict:
    """Both pipelines (N_MICRO micro-batches, two streams) against the
    single-shot forwards at bucket 32 and 2048 samples; their launches
    at bucket 32 (the main path of this sub-phase); time per call, device
    busy time, idle share and stream overlap."""
    launches = {n: 0 for n in KERNELS}
    out = {"rows": []}
    for samples, seed in ((BUCKET, 41), (LARGE, 42)):
        fb = DLRMSynthetic(cfg, seed=seed).batch(samples)
        rb = poisson_batch(cfg, samples, seed)
        f = {k: torch.from_numpy(fb[k]).cuda() for k in ("dense", "indices")}
        r = {k: torch.from_numpy(rb[k]).cuda()
             for k in ("dense", "indices", "offsets")}
        runs = {
            "fixed": (
                lambda: dlrm.forward(params, cfg, f["dense"], f["indices"]),
                lambda: hybrid.pipelined_forward(params, cfg, f["dense"],
                                                 f["indices"], N_MICRO),
                {"embedding_bag": N_MICRO + 1}),
            "ragged": (
                lambda: dlrm.forward_ragged(params, cfg, r["dense"],
                                            r["indices"], r["offsets"],
                                            max_l=MAX_L),
                lambda: hybrid.pipelined_forward_ragged(
                    params, cfg, r["dense"], r["indices"], r["offsets"],
                    max_l=MAX_L, n_micro=N_MICRO),
                {"fused_segment_sum": N_MICRO + 1})}
        for kind, (single, piped, lookups) in runs.items():
            with torch.inference_mode():
                with uncounted():
                    want = single()
                if samples == BUCKET:
                    reset_counts()
                    got = piped()
                    counts = launch_counts()
                    expect = {n: lookups.get(n, 0) for n in KERNELS}
                    expect["gemm"] = 6 * N_MICRO
                    expect["interaction"] = N_MICRO
                    if counts != expect:
                        fail(f"pipelined {kind}: launches {counts}, "
                             f"expected {expect}")
                    for n in KERNELS:
                        launches[n] += counts[n]
                else:
                    with uncounted():
                        got = piped()
                torch.cuda.synchronize()
                equal = torch.equal(got, want)
                err = (got - want).abs().max().item()
                if not equal and err > PIPE_ATOL:
                    fail(f"pipelined {kind} at {samples}: differs from the "
                         f"single-shot forward by {err}")

                def timed(fn):
                    def call():
                        with torch.inference_mode():
                            fn()
                    return call
                with uncounted():
                    row = {"kind": kind, "samples": samples,
                           "equal": equal, "max_abs_err": err,
                           "single_ms": time_ms(timed(single), reps=10,
                                                trials=5),
                           "pipelined_ms": time_ms(timed(piped), reps=10,
                                                   trials=5),
                           "single": stream_profile(
                               timed(single), f"{kind}_{samples}_single"),
                           "pipelined": stream_profile(
                               timed(piped), f"{kind}_{samples}_pipelined")}
            for key, ms in (("single", row["single_ms"]),
                            ("pipelined", row["pipelined_ms"])):
                busy = row[key].get("device_busy_ms")
                row[key]["idle_share"] = (1.0 - busy / ms) if busy else None
            out["rows"].append(row)
            p = row["pipelined"]
            print(f"  pipelined {kind:6s} {samples:5d} samples: "
                  f"{'equal to the single-shot forward (torch.equal)' if equal else f'within {PIPE_ATOL} of the single-shot forward ({err:.2e})'}"
                  f"; ms per call single {row['single_ms']:.4f} / pipelined "
                  f"{row['pipelined_ms']:.4f}; pipelined device busy "
                  f"{_fmt(p.get('device_busy_ms'))} ms, idle share "
                  f"{p.get('idle_share')}, kernels {p.get('kernels')} on "
                  f"streams {p.get('streams')}, overlap "
                  f"{_fmt(p.get('overlap_ms'))} ms (single-shot busy "
                  f"{_fmt(row['single'].get('device_busy_ms'))} ms, "
                  f"{row['single'].get('kernels')} kernels)")
    out["launches"] = launches
    return out


def phase_serve_fixed(cfg, params, fp_probs) -> dict:
    batch = fixed_batch(cfg, N_REQUESTS, seed=7)
    t0 = time.perf_counter()
    engine, probs = serve(cfg, params, "cuda", batch=batch, source="fixed")
    serve_s = time.perf_counter() - t0
    launches = launch_counts()
    stats = engine.stats()
    print(f"  served {engine.served} fixed-L requests (L "
          f"{cfg.lookups_per_table}) in {engine.batches} batches "
          f"({serve_s:.2f} s with warmup); launches {launches}")
    print(f"  stats {stats}")
    if engine.served != N_REQUESTS:
        fail(f"fixed: served {engine.served} of {N_REQUESTS} requests")
    _check_launches(launches, "per_fixed_forward", 2 * engine.captures,
                    "fixed plan")
    if not (np.isfinite(probs).all() and (probs > 0).all()
            and (probs < 1).all()):
        fail("fixed: probabilities outside (0, 1) or not finite")
    _, cpu_probs = serve(cfg, _cpu(params), "cpu", batch=batch,
                         source="fixed")
    err = float(np.abs(probs - cpu_probs).max())
    print(f"  card vs CPU path: max |prob diff| {err:.3e} (atol {PROB_ATOL})")
    if err > PROB_ATOL:
        fail(f"fixed: card probabilities differ from the CPU path by {err}")
    with uncounted():
        _, ragged_probs = serve(cfg, params, "cuda", batch=batch)
    if not np.array_equal(probs, ragged_probs):
        fail(f"fixed plan differs from the ragged fp plan on the same bags "
             f"by {np.abs(probs - ragged_probs).max()} (must be equal)")
    print("  fixed plan: every probability equal to the ragged fp plan's on "
          "the same bags (np.array_equal)")
    prof = profile_serve(engine, cfg, batch_fn=fixed_batch)
    _print_profile(prof, "fixed plan")
    _check_replay(prof, "per_fixed_forward", "fixed plan")
    out = {"launches": launches, "stats": stats, "batches": engine.batches,
           "serve_s": serve_s, "prob_max_abs_err": err, "profile": prof}
    out["flat"] = serve_flat(cfg, params, fp_probs)
    out["pipelined"] = check_pipelines(cfg, params)
    # the serve launcher, on the card by default (no --device)
    for extra in ([], ["--pipelined", "--microbatches", str(N_MICRO)]):
        stats = serve_launcher.main(["--arch", "dlrm1", "--requests", "256",
                                     "--batch-size", str(BUCKET), *extra])
        out["launcher" + ("_pipelined" if extra else "")] = stats
    return out


# ---------------------------------------------------------------- phase 8

FIXED_KEYS = ("dense", "indices", "labels")


def phase_train_fixed(cfg) -> dict:
    """make_train_step (fixed L, dense gradients) at batch 32: each step
    on the card and on the CPU path from a copy of the card's state; a
    second card run, counted, equal bit for bit; time per step; the
    launcher without --ragged."""
    spec = dlrm.arena_spec(cfg)
    p0 = dlrm.init(torch.Generator(device="cuda").manual_seed(1), cfg,
                   device="cuda")
    data = DLRMSynthetic(cfg, seed=51)
    batches = [data.batch(BUCKET) for _ in range(TRAIN_STEPS)]
    opt, step = dlrm.make_train_step(cfg)
    p_max = max(w.abs().max().item() for w in tree_leaves(
        {k: p0[k] for k in ("bottom", "top")}))
    params = _copy(p0, "cuda")
    state = opt.init(params)
    losses, cmp = [], []
    for i, b in enumerate(batches):
        cpu_params, cpu_state = _copy(params, "cpu"), _copy(state, "cpu")
        params, state, loss = step(params, state, {
            k: torch.from_numpy(b[k]).cuda() for k in FIXED_KEYS})
        cpu_params, cpu_state, cpu_loss = step(
            cpu_params, cpu_state,
            {k: torch.from_numpy(b[k]) for k in FIXED_KEYS})
        losses.append(float(loss))
        rel = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
        if rel > LOSS_RTOL:
            fail(f"train fixed step {i}: loss {float(loss)} on the card, "
                 f"{float(cpu_loss)} on the CPU")
        touched = torch.unique(se.flatten_indices(
            spec, torch.from_numpy(b["indices"]))).long()
        mlp_card, mlp_cpu = (torch.cat([t.reshape(-1)
                                        for k in ("bottom", "top")
                                        for t in tree_leaves(p[k])])
                             for p in (params, cpu_params))
        mlp = _beyond(mlp_card, mlp_cpu, int(MLP_SHARE * mlp_cpu.numel()),
                      2 * LR * (1.01 + 0.01 * p_max),
                      f"train fixed step {i} MLP")
        arena = _beyond(params["arena"][touched.cuda()],
                        cpu_params["arena"][touched],
                        ARENA_SAMPLES * cfg.n_tables * cfg.lookups_per_table,
                        2 * 10 * LR * spec.dim ** 0.5,
                        f"train fixed step {i} arena rows")
        # rows no bag touched have a zero gradient and stay where they
        # were, on both devices
        moved = ((params["arena"].cpu() - cpu_params["arena"]).abs()
                 .amax(dim=1) > 0).nonzero().reshape(-1)
        if not torch.isin(moved, touched).all():
            fail(f"train fixed step {i}: untouched arena rows differ")
        if params["arena"][spec.null_row].any():
            fail(f"train fixed step {i}: the null row moved")
        cmp.append({"loss_card": float(loss), "loss_cpu": float(cpu_loss),
                    "loss_rel_err": rel, "mlp": mlp, "arena": arena})
        print(f"  train fixed  step {i}: loss {float(loss):.6f} (card vs "
              f"CPU rel {rel:.1e}); MLP {mlp['beyond']} of {mlp['of']} "
              f"beyond {PARAM_ATOL} (max {mlp['max_abs_err']:.1e}), touched"
              f" arena rows {arena['beyond']} of {arena['of']} (max "
              f"{arena['max_abs_err']:.1e}); untouched rows unmoved")
    # the main path: the same steps again on the card, counted
    again = _copy(p0, "cuda")
    again_state = opt.init(again)
    again_losses = []
    reset_counts()
    for b in batches:
        again, again_state, loss = step(again, again_state, {
            k: torch.from_numpy(b[k]).cuda() for k in FIXED_KEYS})
        again_losses.append(float(loss))
    launches = launch_counts()
    _check_launches(launches, "per_fixed_step", TRAIN_STEPS, "train fixed")
    if again_losses != losses or not all(
            torch.equal(a, c) for a, c in zip(tree_leaves(again),
                                              tree_leaves(params))):
        fail("train fixed: two runs on the card differ")
    print(f"  train fixed  two card runs equal bit for bit; launches "
          f"{launches}")
    batch = {k: torch.from_numpy(batches[0][k]).cuda() for k in FIXED_KEYS}
    st = [opt.init(again)]

    def one():
        _, st[0], _ = step(again, st[0], batch)

    with uncounted():
        before = launch_counts()
        ms = time_ms(one, reps=10, trials=5)
        after = launch_counts()
        dev = device_ms(one, reps=10)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                one()
            torch.cuda.synchronize()
    per_step = {n: (after[n] - before[n]) / (3 + 50) for n in KERNELS}
    kernels = _kernel_count(prof) / 10
    idle = (1.0 - dev / ms) if dev else None
    print(f"  train fixed  per step of {BUCKET}: {ms:.4f} ms (CUDA events), "
          f"device {_fmt(dev)} ms, idle share {idle}; {kernels:.1f} kernels "
          f"on the card per step; launches per step {per_step}")
    loss = train_launcher.main(["--arch", "dlrm1", "--steps", "3",
                                "--log-every", "1"])
    if not np.isfinite(loss):
        fail(f"fixed launcher: final loss {loss}")
    return {"steps": cmp, "losses": losses, "launches": launches,
            "ms_per_step": ms, "device_ms_per_step": dev,
            "device_idle_share": idle, "launches_per_step": per_step,
            "kernels_per_step": kernels,
            "launcher_loss": loss}


# ---------------------------------------------------------------- phase 9

TIER_HOT = 4096                    # rows of the fp hot tier
TIER_WARM = 65_536                 # rows of the int8 warm tier
STAGING = 16_384                   # staging arena of the host cold tier
MAX_STAGE = 4_096                  # rows per staging flush chunk
# the int4 kernel against its plain version on the card: the two sum a
# bag's terms in other orders, so each output may differ by a few ulp of
# the partial sums, bounded by 1e-6 of the bag's sum of |terms| (40
# terms x 6e-8 relative rounding each is 2.4e-6 at worst, ~4e-7 as a
# random walk). Against fused_segment_sum over int4_unpack: exact, the
# same rounded products added in the same order.
INT4_REL = 1e-6


def int4_policy() -> st.TierPolicy:
    return st.TierPolicy(hot=TIER_HOT, warm=TIER_WARM, cold="int4")


def host_policy() -> st.TierPolicy:
    return st.TierPolicy(hot=TIER_HOT, warm=0, cold="host",
                         staging_rows=STAGING, max_stage_per_batch=MAX_STAGE)


def cold_ids_of(tiered, dense: torch.Tensor) -> torch.Tensor:
    """The cold tier's ids of a dense id matrix, as TieredSource makes
    them (every other position reads the cold null row)."""
    h, w, c = tiered.n_hot, tiered.n_warm, tiered.n_cold
    ts = tiered.tier_slot[dense]
    return torch.where(ts >= h + w, torch.clamp(ts - (h + w), max=c), c)


def check_int4_case(packed, scales, ids, dim: int, what: str) -> float:
    """The kernel against its plain version (within INT4_REL of each
    bag's sum of |terms|) and against fused_segment_sum over the
    unpacked table (torch.equal), on the card."""
    name = "fused_int4_segment_sum"
    got = fd_k.fused_int4_segment_sum(packed, scales, ids, dim=dim)
    want = ref.fused_int4_segment_sum(packed, scales, ids, dim)
    table = ops.int4_unpack(packed, scales, dim)
    with uncounted():
        same = fd_k.fused_segment_sum(table, ids)
    abs_terms = ref.fused_segment_sum(table.abs(), ids)
    torch.cuda.synchronize()
    err = (got - want).abs()
    worst = float(err.max()) if err.numel() else 0.0
    if not bool((err <= INT4_REL * abs_terms).all()):
        fail(f"{name} {what}: |kernel - plain| {worst} over {INT4_REL} x "
             f"the bag's sum of |terms|")
    if not torch.equal(got, same):
        fail(f"{name} {what}: differs from fused_segment_sum over "
             f"int4_unpack by {float((got - same).abs().max())}")
    print(f"  {name:24s} {what:34s} max_abs_err {worst:.3e}; equal to "
          f"fused_segment_sum(int4_unpack)")
    return worst


def check_int4(params, cfg, counts, gen) -> tuple:
    """The int4 kernel over the cold tier of DLRM(1) (930,368 rows of 16
    bytes + a 4-byte scale): the serving shape (bucket 32 and max_l 40,
    ids through the tier map), 2048 samples, and edge shapes; times and
    bounds at the first two."""
    spec = dlrm.arena_spec(cfg)
    tiered = st.build_tiered(params["arena"], spec, int4_policy(), counts)
    cold = tiered.cold
    errs, rows = [], []
    for samples, seed in ((BUCKET, 11), (LARGE, 12)):
        ids = cold_ids_of(tiered, serving_dense_ids(cfg, samples, seed))
        errs.append(check_int4_case(cold.packed, cold.scales, ids, cold.dim,
                                    f"ids {tuple(ids.shape)}"))
        b, l = ids.shape
        d, p = cold.dim, cold.packed.shape[1]
        touched = torch.unique(ids).numel()
        bound_ms, by = bound(4 * ids.numel() + touched * (p + 4)
                             + 4 * b * d, 2 * ids.numel() * d)
        table = ops.int4_unpack(cold.packed, cold.scales, d)
        r = measure(
            lambda: fd_k.fused_int4_segment_sum(cold.packed, cold.scales,
                                                ids, dim=d),
            lambda: ref.fused_int4_segment_sum(cold.packed, cold.scales,
                                               ids, d),
            # a reference point, not the same function: no one PyTorch
            # call reduces int4 rows, so F.embedding_bag sums the
            # dequantized fp32 table over the same ids
            lambda: F.embedding_bag(ids, table, mode="sum"))
        r["reference_point_ms"] = r.pop("library_ms")
        r["reference_point_device_ms"] = r.pop("library_device_ms")
        r["library_ms"] = None
        r["library_device_ms"] = None
        rows.append({"samples": samples, "shape": [b, l, d], **r,
                     "bound_ms": bound_ms, "bound_by": by,
                     "rows_read": touched,
                     "cold_share": float((ids != cold.packed.shape[0] - 1)
                                         .float().mean()),
                     "bound_per_position_ms": bound(
                         4 * ids.numel() + ids.numel() * 64 + 4 * b * d,
                         0)[0]})
    # every tile depth, long bags, D 32 / 48 / 16 / 6 on the cached
    # kernel's cases, D = 100 (passes of 32 columns), and a table 4 bytes
    # off 16-byte alignment
    for v, d, b, l in CACHED_CASES + ((300, 100, 9, 45),):
        table = _small_table(gen, v, d)
        packed, scales = ops.int4_pack(table)
        ids = torch.randint(0, v, (b, l), generator=gen, device="cuda",
                            dtype=torch.int32)
        p = fd_k.segment_plan(b, l, d, _build.sm_count(ids.device))
        errs.append(check_int4_case(
            packed, scales, ids, d,
            f"D = {d}, B = {b}, max_l = {l} (depth {p.depth})"))
    table = _small_table(gen, 300, 32)
    packed, scales = ops.int4_pack(table)
    off = torch.empty(300 * 16 + 4, dtype=torch.uint8, device="cuda")
    shifted = off[4:].view(300, 16)
    shifted.copy_(packed)
    ids = torch.randint(0, 300, (9, 40), generator=gen, device="cuda",
                        dtype=torch.int32)
    errs.append(check_int4_case(shifted, scales, ids, 32,
                                "unaligned table, D = 32"))
    # edges: D 7/16/32/48 (an all-zero row among them), max_l 0, bags of
    # fill slots only
    for d in (7, 16, 32, 48):
        table = torch.randn((50, d), generator=gen, device="cuda") * 0.05
        table[3] = 0.0
        table[49] = 0.0                          # the null row
        packed, scales = ops.int4_pack(table)
        ids = torch.randint(0, 50, (9, 7), generator=gen, device="cuda",
                            dtype=torch.int32)
        ids[0] = 3
        ids[1, 2:] = 49
        ids[2] = 49
        errs.append(check_int4_case(packed, scales, ids, d,
                                    f"D = {d}, B = 9, max_l = 7"))
        if float(scales[3]) != 0.0:
            fail("int4: an all-zero row packed with a nonzero scale")
        got = fd_k.fused_int4_segment_sum(packed, scales, ids, dim=d)
        if got[0].any() or got[2].any():
            fail(f"int4 D = {d}: a bag of zero rows or fill slots only is "
                 f"not zero")
    empty = torch.zeros((9, 0), dtype=torch.int32, device="cuda")
    before = fd_k.int4_launches
    out = fd_k.fused_int4_segment_sum(packed, scales, empty, dim=48)
    if out.shape != (9, 48) or out.any():
        fail("int4: max_l = 0 must give zeros")
    if fd_k.int4_launches != before:
        fail("int4: max_l = 0 launched the kernel")
    print(f"  {'fused_int4_segment_sum':24s} {'max_l = 0':34s} zeros, no "
          f"launch")
    return max(errs), rows, tiered


def _all_in(cfg, tier_rows: np.ndarray, n: int, seed: int) -> dict:
    """A ragged batch of n samples whose every bag holds 20 ids drawn from
    ``tier_rows`` (arena rows) of its own table."""
    rng = np.random.RandomState(seed)
    v, t = cfg.rows_per_table, cfg.n_tables
    per_table = [tier_rows[(tier_rows // v) == j] % v for j in range(t)]
    idx = np.concatenate([rng.choice(per_table[j], 20)
                          for _ in range(n) for j in range(t)])
    off = (np.arange(n * t + 1) * 20).astype(np.int32)
    dense = np.random.RandomState(seed + 1).randn(
        n, cfg.dense_features).astype(np.float32)
    return {"dense": dense, "indices": idx.astype(np.int32),
            "offsets": off}


def _pooled(source, spec, batch) -> torch.Tensor:
    with uncounted():
        return es.lookup_bags(source, spec,
                              torch.from_numpy(batch["indices"]).cuda(),
                              torch.from_numpy(batch["offsets"]).cuda(),
                              max_l=MAX_L)


def _runtime_calls(fn) -> dict:
    """CUDA runtime calls made while ``fn`` runs and the card finishes
    (profiler, tracing the card), less those of the same profiled window
    around nothing: the profiler's and the closing synchronize."""
    def window(f):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            f()
            torch.cuda.synchronize()
        return {e.key: e.count for e in prof.key_averages()
                if e.key.startswith("cuda")}
    base, calls = window(lambda: None), window(fn)
    return {k: n - base.get(k, 0) for k, n in calls.items()
            if n - base.get(k, 0)}


def _staging_syncs(engine, cfg, n: int = 4) -> dict:
    """CUDA runtime calls of the staging path alone over n micro-batches
    of fresh requests: its copies must be asynchronous, with no
    synchronize."""
    reqs = requests_from_ragged_batch(poisson_batch(cfg, n * BUCKET, 31),
                                      cfg.n_tables)
    for r in reqs:
        engine.submit(r)

    def stage():
        for i in range(0, len(reqs), BUCKET):
            engine._stage_batch(reqs[i:i + BUCKET])
    calls = _runtime_calls(stage)
    engine.drain()
    return calls


def serve_tiered(cfg, params, fp_probs, counts) -> dict:
    spec = dlrm.arena_spec(cfg)
    out = {}
    # -- int4 cold
    plan = {"source": es.SourceSpec(tiers=int4_policy()),
            "cache_trace": counts}
    t0 = time.perf_counter()
    engine, probs = serve(cfg, params, "cuda", **plan)
    serve_s = time.perf_counter() - t0
    launches = launch_counts()
    stats = engine.stats()
    print(f"  int4 cold: served {engine.served} requests in "
          f"{engine.batches} batches ({serve_s:.2f} s with warmup); "
          f"launches {launches}")
    if engine.served != N_REQUESTS or stats["path"] != "tiered":
        fail(f"tiered int4: served {engine.served}, path {stats['path']}")
    _check_launches(launches, "per_tiered_forward", 2 * engine.captures,
                    "tiered int4 plan")
    _, cpu_probs = serve(cfg, _cpu(params), "cpu", **plan)
    err = float(np.abs(probs - cpu_probs).max())
    err_fp = float(np.abs(probs - fp_probs).max())
    print(f"  int4 cold: card vs CPU path max |prob diff| {err:.3e} (atol "
          f"{PROB_ATOL}); against the fp plan {err_fp:.3e}")
    if err > PROB_ATOL:
        fail(f"tiered int4: card probabilities differ from the CPU path by "
             f"{err}")
    # pooled bags against the fp arena: the reference's per-bag bound
    batch = served_batch(cfg)
    got = _pooled(engine.source, spec, batch)
    want = _pooled(es.FpArena(params["arena"]), spec, batch)
    amax = float(params["arena"].abs().max())
    limit = MAX_L * (amax / 254.0 + amax / 14.0)
    pooled_err = float((got - want).abs().max())
    print(f"  int4 cold: pooled bags against the fp arena max |diff| "
          f"{pooled_err:.3e} (bound max_l x (amax/254 + amax/14) = "
          f"{limit:.3e})")
    if pooled_err > limit:
        fail(f"tiered int4: pooled bags {pooled_err} beyond {limit}")
    # bags of hot rows only: the fp plan's bits
    hot_batch = _all_in(cfg, engine.source.hot_ids.cpu().numpy(), 64, 41)
    _, hot_probs = serve(cfg, params, "cuda", batch=hot_batch, **plan)
    _, hot_fp = serve(cfg, params, "cuda", batch=hot_batch)
    if not np.array_equal(hot_probs, hot_fp):
        fail(f"tiered int4: all-hot bags differ from the fp plan by "
             f"{np.abs(hot_probs - hot_fp).max()}")
    print("  int4 cold: 64 requests of all-hot bags equal to the fp plan "
          "(np.array_equal)")
    tb = st.tier_bytes(engine.source)
    print(f"  int4 cold: tier bytes {tb} against the fp arena's "
          f"{es.source_bytes(es.FpArena(params['arena']))}")
    prof = profile_serve(engine, cfg)
    _print_profile(prof, "tiered int4")
    _check_replay(prof, "per_tiered_forward", "tiered int4")
    out["int4"] = {"launches": launches, "stats": stats, "serve_s": serve_s,
                   "batches": engine.batches, "prob_max_abs_err": err,
                   "prob_max_abs_err_vs_fp": err_fp,
                   "pooled_max_abs_err_vs_fp": pooled_err,
                   "pooled_bound": limit, "tier_bytes": tb,
                   "profile": prof}
    del engine
    # -- host cold, no warm tier: every row fp32
    plan = {"source": es.SourceSpec(tiers=host_policy()),
            "cache_trace": counts}
    t0 = time.perf_counter()
    engine, probs = serve(cfg, params, "cuda", **plan)
    serve_s = time.perf_counter() - t0
    launches = launch_counts()
    stats = engine.stats()
    pre = stats["prefetch"]
    print(f"  host cold: served {engine.served} requests in {engine.batches}"
          f" batches ({serve_s:.2f} s with warmup); launches {launches}; "
          f"prefetch {pre}")
    _check_launches(launches, "per_host_forward", 2 * engine.captures,
                    "tiered host plan")
    err_fp = float(np.abs(probs - fp_probs).max())
    print(f"  host cold: against the fp plan max |prob diff| {err_fp:.3e} "
          f"(atol {PROB_ATOL})")
    if err_fp > PROB_ATOL:
        fail(f"tiered host: differs from the fp plan by {err_fp}")
    store = engine._host_stores[0]
    s = store.stats()
    if s["hits"] + s["misses"] != s["touches"] or pre["touches"] == 0:
        fail(f"tiered host: hits + misses != touches: {s}")
    reqs = requests_from_ragged_batch(served_batch(cfg), cfg.n_tables)
    largest = max(len(store.cold_ids_of(engine._host_ids(
        reqs[i:i + BUCKET]))) for i in range(0, len(reqs), BUCKET))
    print(f"  host cold: the largest micro-batch touches {largest} unique "
          f"cold rows (staging arena {STAGING}, half {STAGING // 2}); "
          f"prefetch hit rate {pre['hit_rate']:.4f}")
    if largest >= STAGING // 2:
        fail(f"tiered host: {largest} unique cold rows leave no room for "
             f"the lookahead")
    # one-tier bags: hot only, host cold only
    hot_ids = engine.source.hot_ids.cpu().numpy()
    cold_rows = np.nonzero(store.compact_of < store.n_cold)[0]
    for tag, rows_, seed in (("hot", hot_ids, 42), ("host", cold_rows, 43)):
        b = _all_in(cfg, rows_, 64, seed)
        _, a = serve(cfg, params, "cuda", batch=b, **plan)
        _, f = serve(cfg, params, "cuda", batch=b)
        if not np.array_equal(a, f):
            fail(f"tiered host: all-{tag} bags differ from the fp plan by "
                 f"{np.abs(a - f).max()}")
    print("  host cold: 64 requests of all-hot and 64 of all-cold bags "
          "equal to the fp plan (np.array_equal)")
    # the prefetcher with a queue to look into: all 512 requests admitted
    # first, so each step stages its own batch and the next one's rows
    tel = obs.Telemetry()
    with uncounted():
        ahead = RecEngine(cfg, params, max_l=MAX_L, max_batch=BUCKET,
                          telemetry=tel, device="cuda", **plan)
        ahead.warmup()
        for r in requests_from_ragged_batch(served_batch(cfg),
                                            cfg.n_tables):
            ahead.submit(r)
        ahead.drain()
    pre_q = ahead.stats()["prefetch"]
    if pre_q["hits"] + pre_q["misses"] != pre_q["touches"]:
        fail(f"tiered host, queued: hits + misses != touches: {pre_q}")
    store_counts = {k: tel.registry.counter(name).value for k, name in (
        ("hits", "rec_prefetch_hit"), ("misses", "rec_prefetch_miss"))}
    snap = tel.snapshot()
    if store_counts != {k: pre_q[k] for k in ("hits", "misses")} \
            or json.loads(json.dumps(snap)) != snap:
        fail(f"tiered host: rec_prefetch_hit/miss {store_counts} against "
             f"stats()['prefetch'] {pre_q}, or a snapshot that does not "
             f"round-trip through json")
    print(f"  13(f) host store telemetry: rec_prefetch_hit/miss "
          f"{store_counts} equal stats()['prefetch']; the snapshot "
          f"round-trips through json")
    print(f"  host cold, all 512 requests queued first (the lookahead sees "
          f"the next micro-batch): prefetch {pre_q}")
    del ahead
    calls = _staging_syncs(engine, cfg)
    print(f"  host cold: CUDA runtime calls of the staging path over 4 "
          f"micro-batches: {calls}")
    if any(k.endswith("Synchronize") for k in calls):
        fail(f"tiered host: the staging path synchronized: {calls}")
    # for comparison, one whole served micro-batch: its request copies and
    # the probabilities' copy back wait for the stream, staging does not
    step_reqs = requests_from_ragged_batch(poisson_batch(cfg, BUCKET, 32),
                                           cfg.n_tables)

    def one_step():
        for r in step_reqs:
            engine.submit(r)
        engine.step(force=True)
    step_calls = _runtime_calls(one_step)
    print(f"  host cold: CUDA runtime calls of one served micro-batch: "
          f"{step_calls}")
    tb = st.tier_bytes(engine.source)
    print(f"  host cold: tier bytes {tb}")
    prof = profile_serve(engine, cfg)
    _print_profile(prof, "tiered host")
    _check_replay(prof, "per_host_forward", "tiered host")
    out["host"] = {"launches": launches, "stats": stats,
                   "serve_s": serve_s, "batches": engine.batches,
                   "prob_max_abs_err_vs_fp": err_fp,
                   "largest_unique_cold": largest,
                   "prefetch_queued": pre_q,
                   "store_telemetry": store_counts,
                   "staging_runtime_calls": calls,
                   "step_runtime_calls": step_calls, "tier_bytes": tb,
                   "profile": prof}
    return out


def online_tiered(cfg, counts) -> dict:
    """A tiered OnlineTrainer (int4 cold, a migration every REFRESH
    steps) feeding one engine through sync_engine every 5 steps."""
    spec = dlrm.arena_spec(cfg)
    pol = int4_policy()
    p0 = dlrm.init(torch.Generator(device="cuda").manual_seed(2), cfg,
                   device="cuda")
    trainer = OnlineTrainer(cfg, p0, max_l=MAX_L, device="cuda",
                            cache_cfg=OnlineCacheConfig(
                                k=0, tiers=pol, refresh_every=REFRESH))
    reset_counts()
    engine = RecEngine(cfg, trainer.params, source=es.SourceSpec(tiers=pol),
                       cache_trace=counts, max_l=MAX_L, max_batch=BUCKET,
                       device="cuda")
    engine.warmup()
    captures = engine.captures
    own = engine.source
    ptrs = [t.data_ptr() for t in es.source_structure(own)[1]] \
        + [t.data_ptr() for t in tree_leaves(engine.params)]
    train = make_drifting_zipf(cfg, batch_size=BUCKET, mean_l=20,
                               max_l=MAX_L, drift_per_batch=DRIFT, seed=3)
    traffic = make_drifting_zipf(cfg, batch_size=BUCKET, mean_l=20,
                                 max_l=MAX_L, drift_per_batch=DRIFT, seed=4)
    step_fn = dlrm.make_ragged_serve_step(cfg, max_l=MAX_L)
    step_ms, migrations, served = [], [], 0
    for i in range(1, ONLINE_STEPS + 1):
        batch = next(train)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        src = trainer.tiered
        with uncounted():
            if not torch.equal(src.hot_rows[:-1],
                               trainer.params["arena"][src.hot_ids.long()]):
                fail(f"online tiered step {i}: the hot tier differs from "
                     f"the trainer's arena rows")
        if i % REFRESH == 0:
            with uncounted():
                full = st.build_tiered(trainer.params["arena"], spec, pol,
                                       trainer.hist)
                for a, b in zip(es.source_structure(src)[1],
                                es.source_structure(full)[1]):
                    if not torch.equal(a, b):
                        fail(f"online tiered step {i}: the migration "
                             f"differs from a full build_tiered")
            migrations.append({"step": i, **trainer.last_migration})
            print(f"  online tiered step {i:2d}: migration v"
                  f"{trainer.version} {trainer.last_migration}, equal to "
                  f"build_tiered bit for bit")
        if i % 5:
            continue
        if not trainer.sync_engine(engine):
            fail(f"online tiered step {i}: sync_engine did not publish")
        if engine.source is not own or [
                t.data_ptr() for t in es.source_structure(own)[1]] \
                + [t.data_ptr() for t in tree_leaves(engine.params)] != ptrs:
            fail(f"online tiered step {i}: the engine's tensors moved")
        reqs = _requests(next(traffic), cfg)
        got = _served(engine, reqs)
        served += 1
        with uncounted():
            b, _ = engine._assemble(reqs, BUCKET)
            want = step_fn(trainer.params, b,
                           trainer.serving_source()).cpu().numpy()
        if not np.array_equal(got, want):
            fail(f"online tiered step {i}: served probabilities differ from "
                 f"the forward over the trainer's source by "
                 f"{np.abs(got - want).max()}")
        print(f"  online tiered step {i:2d}: sync at v{engine.source_version}"
              f"; served batch equal to the forward over the trainer's "
              f"source (bit for bit); engine tensors at fixed addresses")
    launches = launch_counts()
    if engine.captures != captures:
        fail(f"online tiered: the syncs recaptured ({engine.captures} "
             f"captures, {captures} after warmup)")
    for name, k in KERNELS.items():
        want = k["per_step"] * ONLINE_STEPS \
            + k["per_tiered_forward"] * 2 * captures
        on_path = k["per_step"] or k["per_tiered_forward"]
        if launches[name] != want or (on_path and not launches[name]):
            fail(f"online tiered: {name} launched {launches[name]} times; "
                 f"{k['per_step']} x {ONLINE_STEPS} steps + "
                 f"{k['per_tiered_forward']} x {2 * captures} forwards of "
                 f"warmup's captures = {want}")
    print(f"  online tiered launches {launches} ({ONLINE_STEPS} steps; "
          f"{served} served micro-batches replayed the {captures} graphs of "
          f"warmup, none recaptured)")
    # the migration's own cost: host wall (synchronised) and device time
    dirty = np.zeros(spec.total_rows, bool)
    dirty[np.unique(next(train)["indices"])] = True

    def retier():
        return st.migrate(trainer.tiered, trainer.params["arena"], spec, pol,
                          trainer.hist, dirty)
    wall = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        retier()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    dev = device_ms(retier, reps=3)
    plain = [m for j, m in enumerate(step_ms, 1) if j % REFRESH]
    costs = {"step_ms_median": float(np.median(plain)),
             "migration_step_ms": [m for j, m in enumerate(step_ms, 1)
                                   if j % REFRESH == 0],
             "retier_host_ms_median": float(np.median(wall)),
             "retier_device_ms": dev}
    print(f"  online tiered costs: step {costs['step_ms_median']:.3f} ms "
          f"(median of the {len(plain)} steps without a migration), "
          f"migration steps "
          f"{[round(m, 3) for m in costs['migration_step_ms']]} ms, "
          f"migrate {costs['retier_host_ms_median']:.3f} ms host (device "
          f"{_fmt(dev)} ms)")
    return {"launches": launches, "served_batches": served,
            "migrations": migrations, "costs": costs,
            "losses": trainer.losses}


def phase_tiered(cfg, params, fp_probs, gen) -> tuple:
    counts = warm_counts(cfg)
    err, rows, _ = check_int4(params, cfg, counts, gen)
    for r in rows:
        print(f"  fused_int4_segment_sum {r['samples']:5d} samples, ms per "
              f"call (device ms): kernel {r['ms']:.4f} "
              f"({_fmt(r['device_ms'])}), plain {r['plain_ms']:.4f} "
              f"({_fmt(r['plain_device_ms'])}), reference point "
              f"F.embedding_bag over the dequantized table "
              f"{r['reference_point_ms']:.4f} "
              f"({_fmt(r['reference_point_device_ms'])}), bound "
              f"{r['bound_ms']:.5f} ({r['bound_by']}; one row and scale "
              f"sector pair per position {r['bound_per_position_ms']:.5f});"
              f" {r['rows_read']} rows read, cold share of positions "
              f"{r['cold_share']:.3f}")
    served = serve_tiered(cfg, params, fp_probs, counts)
    print("  -- online tier migration")
    online = online_tiered(cfg, counts)
    return {"max_abs_err": err, "rows": rows}, served, online


# ---------------------------------------------------------------- phase 11

GRAPH_BUCKETS = (16, 32)           # phase 11's engines: two buckets
DEPTH = 2                          # micro-batches in flight
SWAP_BATCHES = 4                   # served after the swaps, both buckets
RETUNE_SIZE = 24                   # the one size of the retune's traffic
GRAPH_PLAN_BUDGET_S = 20.0         # phase 11's time budget for each plan

es.register_source(FlatArena, ("arena",), ())


def mixed_sizes(n: int, seed: int) -> list:
    """Micro-batch sizes of 9 to 32 summing to n: both of phase 11's
    buckets serve."""
    rng = np.random.RandomState(seed)
    out = []
    while sum(out) < n:
        out.append(int(min(rng.randint(9, BUCKET + 1), n - sum(out))))
    return out


def graph_pool_bytes(engine):
    """Device bytes of the engine's graph memory pool (its segments in the
    caching allocator's snapshot), None if the snapshot does not say."""
    pool = tuple(engine._pool)
    segs = [s for s in torch.cuda.memory_snapshot()
            if tuple(s.get("segment_pool_id", ())) == pool]
    return sum(s["total_size"] for s in segs) if segs else None


def eager_step(cfg, fixed: bool):
    """The eager serve step an engine's graphs capture, over the batch the
    engine pads ``reqs`` to; its launches do not count."""
    step = (dlrm.make_serve_step(cfg) if fixed
            else dlrm.make_ragged_serve_step(cfg, max_l=MAX_L))

    def run(engine, reqs, bucket, params, source):
        with uncounted():
            batch, _ = engine._assemble(reqs, bucket)
            return (step(params, batch) if fixed
                    else step(params, batch, source))
    return run


def pipelined(engine, reqs, sizes, reference=None, downgraded=False):
    """Serve ``reqs`` in micro-batches of ``sizes`` through dispatch and
    settle, DEPTH in flight. ``reference(mb, bucket)`` is the eager serve
    step's device result on the same batch, enqueued right after the
    micro-batch's dispatch (so a host tier's staging is as the graph read
    it); each settled batch must equal it bit for bit. Returns the
    buckets served."""
    inflight, bad, i, buckets = [], [], 0, set()

    def settle_one():
        ib, want = inflight.pop(0)
        engine.settle(ib)
        if want is not None:
            got = np.array([r.prob for r in ib.reqs], np.float32)
            ref_ = want.cpu().numpy()[:len(ib.reqs)]
            if not np.array_equal(got, ref_):
                bad.append((ib.bucket, float(np.abs(got - ref_).max())))
    for n in sizes:
        mb = reqs[i:i + n]
        i += n
        sent = time.monotonic()
        for r in mb:
            r.submitted_mono = sent
        ib = engine.dispatch(mb, downgraded=downgraded)
        buckets.add(ib.bucket)
        inflight.append((ib, None if reference is None
                         else reference(mb, ib.bucket)))
        if len(inflight) == DEPTH:
            settle_one()
    while inflight:
        settle_one()
    if bad:
        fail(f"graphed serving: {len(bad)} micro-batches differ from the "
             f"eager serve step (bucket, max |diff|): {bad[:4]}")
    return sorted(buckets)


def _plan_requests(cfg, fixed: bool, n: int, seed: int) -> list:
    batch = fixed_batch(cfg, n, seed) if fixed else poisson_batch(cfg, n,
                                                                  seed)
    return requests_from_ragged_batch(batch, cfg.n_tables)


def _capture_counts(engine, what: str) -> dict:
    """The wrappers' counts of one forward at capture, from warmup's run
    (an eager pass and a capture per pair), for the pairs warmup just
    captured."""
    counts, pairs = launch_counts(), engine.captures
    per = {}
    for n, c in counts.items():
        if c % (2 * pairs):
            fail(f"{what}: {n} counted {c} in warmup's {pairs} captures")
        per[n] = c // (2 * pairs)
    return per


def graphed_plan(cfg, params, name: str, plan: dict, counts) -> dict:
    """One plan of phase 11: warmup's captures, 512 requests at depth 2
    over both buckets bit for bit against the eager serve step, where the
    time goes, then the three swaps with no recapture."""
    fixed = name == "fixed"
    spec = dlrm.arena_spec(cfg)
    step = eager_step(cfg, fixed)
    reset_counts()
    engine = RecEngine(cfg, params, max_l=MAX_L, max_batch=BUCKET,
                       buckets=GRAPH_BUCKETS, device="cuda", **plan)
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    pairs = len(GRAPH_BUCKETS)
    if engine.captures != pairs or cold_compiles(engine):
        fail(f"{name}: warmup made {engine.captures} captures for {pairs} "
             f"pairs, {cold_compiles(engine)} cold")
    per = _capture_counts(engine, name)
    launches = launch_counts()
    pool = graph_pool_bytes(engine)
    # 512 requests, both buckets, two in flight, each batch held bit for
    # bit against the eager serve step on the same padded batch
    reqs = _plan_requests(cfg, fixed, N_REQUESTS, 7)
    sizes = mixed_sizes(N_REQUESTS, 5)
    n_mb = len(sizes)
    buckets = pipelined(engine, reqs, sizes, lambda mb, b: step(
        engine, mb, b, engine.params, engine.source))
    if buckets != list(GRAPH_BUCKETS):
        fail(f"{name}: the mixed traffic served buckets {buckets}")
    if engine.captures != pairs or cold_compiles(engine) \
            or launch_counts() != launches:
        fail(f"{name}: dispatches after warmup captured or ran the "
             f"wrappers ({engine.captures} captures, {cold_compiles(engine)}"
             f" cold, launches {launch_counts()})")
    # request latency at depth 2 (the client sends each micro-batch as it
    # is dispatched), without the checks
    timed = _plan_requests(cfg, fixed, N_REQUESTS, 12)
    mark = engine._lat_hist.count
    t0 = time.perf_counter()
    pipelined(engine, timed, mixed_sizes(N_REQUESTS, 6))
    pipe_s = time.perf_counter() - t0
    stats = engine.stats()
    stats.update(recent_latency(engine, engine._lat_hist.count - mark))
    prof = profile_serve(engine, cfg, n_batches=16,
                         batch_fn=fixed_batch if fixed else poisson_batch)
    _check_replay(prof, per, name)
    row = {"captures": engine.captures, "warmup_s": warmup_s,
           "graph_pool_bytes": pool, "micro_batches_checked": n_mb,
           "p50_ms": stats["p50_ms"], "p95_ms": stats["p95_ms"],
           "p99_ms": stats["p99_ms"],
           "depth2_ms_per_batch": pipe_s * 1e3 / len(mixed_sizes(
               N_REQUESTS, 6)),
           "host_ms_per_batch": prof["wall_ms_per_batch"],
           "device_busy_ms": prof["device_busy_ms_per_batch"],
           "idle_share": prof["device_idle_share"],
           "kernels_per_replay": prof["kernels_per_batch"],
           "kernels_by_group": prof["kernels_by_group"],
           "capture_counts": per}
    if name == "fp":
        row["downgrade"] = graphed_downgrade(cfg, engine, step)
        launches = launch_counts()       # with the downgrade's captures
        pairs = engine.captures
    # the three swaps: params, the whole source, the hot cache
    p2 = tree_map(lambda t: t * 1.5, params)
    ref_src = None
    engine.params = p2
    if not fixed:
        rolled = np.roll(counts, 7)
        if engine.plan is not None and engine.plan.tiers is not None:
            ref_src = st.build_tiered(p2["arena"], spec, engine.plan.tiers,
                                      rolled)
        elif engine.plan is not None:
            ref_src = engine.plan.build(p2["arena"], spec, rolled)
        else:
            ref_src = FlatArena(p2["arena"])
        engine.update_source(ref_src, version=1)
        if engine.cache is not None:
            fresh = se.build_hot_cache(p2["arena"], spec, np.roll(counts, 3),
                                       CACHE_K)
            engine.update_cache(fresh, version=2)
            ref_src = es.with_hot_cache(ref_src, fresh)
        if es.hot_cache_of(engine.source) is None \
                and st.host_stores_of(engine.source):
            # the handed host store stages nothing: the engine's own copy
            # of its rows, staged as the graph read them, is the reference
            ref_src = engine.source
    after = _plan_requests(cfg, fixed, SWAP_BATCHES * BUCKET, 13)
    pipelined(engine, after, [BUCKET, 11] * (SWAP_BATCHES // 2),
              lambda mb, b: step(engine, mb, b, p2, ref_src))
    if engine.captures != pairs or cold_compiles(engine) \
            or launch_counts() != launches:
        fail(f"{name}: the swaps recaptured or ran the wrappers")
    if name == "fp":
        row["downgrade_after_swap"] = graphed_downgrade(cfg, engine, step,
                                                        p2)
    print(f"  {name:12s} captures {engine.captures} "
          f"({warmup_s:.3f} s, graph pool {pool} bytes); {n_mb} micro-"
          f"batches of 512 requests at depth {DEPTH} over buckets "
          f"{GRAPH_BUCKETS} equal to the eager serve step bit for bit, "
          f"none cold; after a params assignment"
          f"{'' if fixed else ', update_source'}"
          f"{', update_cache' if engine.cache is not None else ''}: no "
          f"capture, {SWAP_BATCHES} micro-batches equal to the eager step "
          f"on the new {'params' if fixed else 'source'}")
    print(f"  {name:12s} per micro-batch of {BUCKET}: host "
          f"{row['host_ms_per_batch']:.4f} ms, device busy "
          f"{row['device_busy_ms']:.4f} ms, idle share "
          f"{row['idle_share']:.3f}, {row['kernels_per_replay']:.0f} "
          f"kernels a replay; depth {DEPTH}: {row['depth2_ms_per_batch']:.4f}"
          f" ms a micro-batch, p50 {row['p50_ms']:.4f} p95 "
          f"{row['p95_ms']:.4f} p99 {row['p99_ms']:.4f} ms")
    row["launches"] = launches
    return row


def graphed_downgrade(cfg, engine, step, params=None) -> dict:
    """The int8 downgrade path's own pairs: captured by warmup once
    ``enable_downgrade`` has run, held bit for bit against the eager step
    over the downgrade source and within the reference's bound of the
    primary path's eager step; after a params assignment the source is the
    re-quantized arena."""
    params = engine.params if params is None else params
    first = engine.downgrade_source is None
    if first:
        before = launch_counts()
        engine.enable_downgrade()
        captures = engine.captures
        engine.warmup()
        if engine.captures != captures + len(GRAPH_BUCKETS):
            fail(f"downgrade: warmup made {engine.captures - captures} "
                 f"captures")
        added = {n: c - before[n] for n, c in launch_counts().items()}
    down = engine.downgrade_source
    requant = es.QuantizedArena.from_arena(params["arena"])
    if not (torch.equal(down.q, requant.q)
            and torch.equal(down.scales, requant.scales)):
        fail("downgrade: the source is not the quantized arena")
    reqs = _plan_requests(cfg, False, 4 * BUCKET, 14)
    primary = [step(engine, reqs[i:i + BUCKET], BUCKET, params,
                    engine.source).cpu().numpy()
               for i in range(0, len(reqs), BUCKET)]
    pipelined(engine, reqs, [BUCKET] * 4, lambda mb, b: step(
        engine, mb, b, params, down), downgraded=True)
    got = np.array([r.prob for r in reqs], np.float32)
    err = float(np.abs(got - np.concatenate(primary)).max())
    if err > INT8_PROB_ATOL or not all(r.downgraded for r in reqs):
        fail(f"downgrade: {err} from the primary path (bound "
             f"{INT8_PROB_ATOL})")
    out = {"max_abs_err_vs_primary": err}
    if first:
        prof = profile_serve_downgraded(engine, cfg)
        per = {n: c // (2 * len(GRAPH_BUCKETS)) for n, c in added.items()}
        _check_replay(prof, per, "downgrade")
        out.update(kernels_per_replay=prof["kernels_per_batch"],
                   device_busy_ms=prof["device_busy_ms_per_batch"])
    print(f"  downgrade (int8 arena): {4} micro-batches equal to the eager "
          f"step over the downgrade source bit for bit, within {err:.3e} of "
          f"the primary path (bound {INT8_PROB_ATOL})")
    return out


def profile_serve_downgraded(engine, cfg, n_batches: int = 8) -> dict:
    """Kernels by name of downgraded micro-batches (profiler, the card)."""
    reqs = _plan_requests(cfg, False, (n_batches + 1) * BUCKET, 15)

    def serve(i: int) -> None:
        engine.settle(engine.dispatch(reqs[i:i + BUCKET], downgraded=True))

    def run() -> None:
        for i in range(BUCKET, len(reqs), BUCKET):
            serve(i)
    device = trace_replays(run, n_batches, lambda: serve(0))
    stats = _record_stats(device["records"], n_batches)
    return {"kernels_by_group": stats["kernels_by_group"],
            "kernels_by_replay": device["by_replay"],
            "trace_takes": device["takes"],
            "kernels_per_batch": stats["kernels_per_batch"],
            "device_busy_ms_per_batch": stats["device_busy_ms_per_batch"]}


def graphed_retune(cfg, params) -> dict:
    """retune_buckets after traffic of one size: the new bucket's graph
    captured, the dropped one's freed, no cold dispatch after."""
    step = eager_step(cfg, False)
    engine = RecEngine(cfg, params, max_l=MAX_L, max_batch=BUCKET,
                       buckets=GRAPH_BUCKETS, device="cuda")
    engine.warmup()
    reqs = _plan_requests(cfg, False, 8 * RETUNE_SIZE, 16)
    pipelined(engine, reqs, [RETUNE_SIZE] * 8)
    buckets = engine.retune_buckets()
    want = tuple(sorted({RETUNE_SIZE, BUCKET}))
    if buckets != want or set(engine._graphs) != {
            ("primary", b) for b in want} or engine.captures != 3:
        fail(f"retune: buckets {buckets}, graphs {sorted(engine._graphs)}, "
             f"{engine.captures} captures")
    reqs = _plan_requests(cfg, False, 4 * RETUNE_SIZE, 17)
    pipelined(engine, reqs, [RETUNE_SIZE] * 4, lambda mb, b: step(
        engine, mb, b, engine.params, engine.source))
    if cold_compiles(engine) or engine.captures != 3:
        fail(f"retune: {cold_compiles(engine)} cold dispatches, "
             f"{engine.captures} captures")
    print(f"  retune_buckets after {8} micro-batches of {RETUNE_SIZE}: "
          f"buckets {GRAPH_BUCKETS} -> {buckets}, bucket "
          f"{GRAPH_BUCKETS[0]}'s graph freed, {RETUNE_SIZE}'s captured; "
          f"4 micro-batches of {RETUNE_SIZE} equal to the eager step, none "
          f"cold")
    return {"buckets": list(buckets), "captures": engine.captures}


def phase_graphed(cfg, params) -> dict:
    counts = warm_counts(cfg)
    plans = {
        "fp": {"source": "ragged"},
        "cached": {"source": "cached", "cache_k": CACHE_K,
                   "cache_trace": counts},
        "int8": {"source": "cached", "cache_k": CACHE_K,
                 "cache_trace": counts, "quantize_cold": True},
        "fixed": {"source": "fixed"},
        "flat": {"source": FlatArena(params["arena"])},
        "tiered_int4": {"source": es.SourceSpec(tiers=int4_policy()),
                        "cache_trace": counts},
        "tiered_host": {"source": es.SourceSpec(tiers=host_policy()),
                        "cache_trace": counts}}
    out, launches = {}, {n: 0 for n in KERNELS}
    for name, plan in plans.items():
        t0 = time.perf_counter()
        out[name] = graphed_plan(cfg, params, name, plan, counts)
        out[name]["phase_s"] = time.perf_counter() - t0
        if out[name]["phase_s"] > GRAPH_PLAN_BUDGET_S:
            fail(f"{name}: phase 11 took {out[name]['phase_s']:.1f} s, over "
                 f"its budget of {GRAPH_PLAN_BUDGET_S} s")
        for n in KERNELS:
            launches[n] += out[name]["launches"][n]
    out["retune"] = graphed_retune(cfg, params)
    out["launches"] = launches
    return out


# ---------------------------------------------------------------- phase 10

BF16_FLOPS_PER_S = 989e12          # bf16 on the tensor cores, dense

LM_ARCH = "smollm-360m"
LM_PREFILL_S = (2048, 4096)        # prompt lengths of the prefill rows
LM_AGREE_S = 2048                  # decode-after-prefill against forward
LM_CPU_LAYERS = 2                  # depth of the card-against-CPU check
# 10(c)'s prefill, forward and decode against the CPU: half the model's
# depth. Its CPU passes (about 33 s at full depth on the card's host) run
# on the main thread before the CPU reference worker starts, so they add
# to the script's time whole
LM_AGREE_LAYERS = 16
LM_REQUESTS = 8                    # DecodeEngine: requests, slots, prompt
LM_SLOTS = 4                       # and new tokens of each request, and
LM_PROMPT = 16                     # the cache length
LM_NEW = 16
LM_MAX_LEN = 64
LM_TIMED = 3                       # timed prefills per length

# logits of smollm-360m at full width (bf16 params, fp32 logits of
# magnitude up to ~3): every card result is held against an fp32
# evaluation of the same weights on the CPU path. The bar is the error
# of one bf16 evaluation there: ``floor`` = max |CPU bf16 - CPU fp32|
# logit of the same prompt. A card result (prefill through the kernel,
# the forward through the kernel, decode after a prefill of the prompt
# but its last token) must lie within LM_FLOOR_FACTOR x floor of the
# fp32 logits, a path as accurate as the CPU's with room for rounding
# in another order; and its greedy token must be the fp32 one, unless
# the two are tied within that bound. (A fixed tolerance cannot serve:
# the first full-width run saw 2.7e-2 between the 2-layer card and CPU
# prefills, and the CPU bf16 path alone 3.0e-2 from fp32.)
LM_FLOOR_FACTOR = 2.0

# (what, B, S, H, KH, hd, causal, window): the path's shapes (smollm-360m's
# heads at both prefill lengths), danube's hd 80 with a window, qwen's hd
# 128 (the four timed ones), smollm-360m's heads without the causal mask
# (the encoder self-attention of ROADMAP item 15b), the smoke configs' 16
# and 20 (the latter padded to 32 by the wrapper), and lengths that are
# no multiple of the kernel's 64- or 128-row q tiles and 128-key kv tiles
FLASH_SHAPES = (
    ("smollm-360m", 1, 2048, 15, 5, 64, True, None),
    ("smollm-360m", 1, 4096, 15, 5, 64, True, None),
    ("danube hd 80, window 512", 1, 4096, 32, 8, 80, True, 512),
    ("qwen hd 128", 1, 2048, 20, 20, 128, True, None),
    ("smollm-360m, not causal", 1, 2048, 15, 5, 64, False, None),
    ("danube smoke hd 16, window 16", 2, 2048, 4, 2, 16, True, 16),
    ("smollm smoke hd 20", 2, 2048, 3, 1, 20, True, None),
    ("ragged S = 100", 2, 100, 3, 1, 20, True, None),
    ("ragged S = 2049", 1, 2049, 15, 5, 64, True, None),
)
FLASH_TIMED = 4                    # the first rows are timed
L2_FLUSH_BYTES = 64 << 20          # written between cold-L2 calls (L2: 50 MB)


def attention_pairs(s: int, causal: bool, window) -> int:
    """(q, k) pairs of the band, each counted once."""
    if not causal:
        return s * s
    if window is None:
        return s * (s + 1) // 2
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def flash_flops(b, s, h, d, causal, window) -> int:
    """Two products of 2 d flops a (q, k) pair of the band, a head."""
    return 4 * d * attention_pairs(s, causal, window) * h * b


def flash_bound(b, s, h, kh, d, causal, window):
    n_bytes = 2 * b * s * d * (2 * h + 2 * kh)   # q, out; k, v (bf16)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flash_flops(b, s, h, d, causal, window) / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def single_call_ms(fn, cold: bool, reps: int = 10) -> float:
    """Median device time of single calls, each between two CUDA events.
    A spin of ~0.5 ms on the device before the start event lets the host
    enqueue the call meanwhile, so its launch cost stays out. With
    ``cold``, L2_FLUSH_BYTES are written before the spin, outside the
    timed span, so that the call finds its inputs in device memory and
    not in the 50 MB L2. Warm, it checks the profiler's device time by
    another clock."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    out = []
    for i in range(reps):
        if cold:
            flush.fill_(i)
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return float(np.median(out))


def flash_split(fn, reps: int = 10) -> dict:
    """Device ms a call of the wrapper on the pad route, split by the
    profiler into the kernel and the rest (the three padding copies)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernel = pad = 0.0
    for kname, us in _kernel_times_us(prof).items():
        if "flash_attention_kernel" in kname:
            kernel += us
        else:
            pad += us
    return {"kernel_device_ms": kernel / 1e3 / reps,
            "pad_device_ms": pad / 1e3 / reps}


def check_flash(gen, shapes=FLASH_SHAPES, timed: int = FLASH_TIMED) -> tuple:
    """The kernel against its plain version at every listed shape, two
    launches equal bit for bit, and at the first ``timed`` the times of
    the kernel (warm and with a cold L2; its TFLOP/s over the band),
    the plain version and F.scaled_dot_product_attention (a yardstick
    the port never calls, on kv heads repeated before the timing; with a
    window it needs an explicit boolean mask, which takes it off its
    flash backend). On the pad route (hd 20, 112) a timed row also
    splits the wrapper's device time into the kernel and the padding
    copies."""
    name = "flash_attention"
    errs, rows = [], []
    for i, (what, b, s, h, kh, d, causal, window) in enumerate(shapes):
        q = torch.randn((b, s, h, d), generator=gen, device="cuda").bfloat16()
        k = torch.randn((b, s, kh, d), generator=gen,
                        device="cuda").bfloat16()
        v = torch.randn((b, s, kh, d), generator=gen,
                        device="cuda").bfloat16()
        got = fa_k.flash_attention_gqa(q, k, v, causal=causal,
                                       window=window)
        # the plain version's blocks shrink to a divisor of S, as the
        # reference's do: 2049 = 3 x 683 would take 683^2 blocks of 3;
        # one block of S is the same function
        blk = 512 if any(s % c == 0 for c in range(64, 513)) else s
        errs.append(compare(name, got, ref.flash_attention_gqa(
            q, k, v, causal=causal, window=window, bq=blk, bk=blk),
            f"{what}: {b}x{s}x{h}/{kh}x{d}"))
        again = fa_k.flash_attention_gqa(q, k, v, causal=causal,
                                         window=window)
        if not torch.equal(got, again):
            fail(f"{name} {what}: two launches on the same inputs differ")
        if i >= timed:
            continue
        qt = q.transpose(1, 2)
        kt, vt = (t.transpose(1, 2).repeat_interleave(h // kh, dim=1)
                  for t in (k, v))
        mask = None
        if window is not None and s > window:
            pos = torch.arange(s, device="cuda")
            mask = ((pos[None, :] <= pos[:, None])
                    & (pos[None, :] > pos[:, None] - window))

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None)

        def kernel():
            return fa_k.flash_attention_gqa(q, k, v, causal=causal,
                                            window=window)

        bound_ms, by = flash_bound(b, s, h, kh, d, causal, window)
        row = {"what": what, "shape": [b, s, h, kh, d], "causal": causal,
               "window": window,
               "ms": time_ms(kernel, reps=10, trials=10),
               "plain_ms": time_ms(lambda: ref.flash_attention_gqa(
                   q, k, v, causal=causal, window=window), reps=1, trials=3),
               "library_ms": time_ms(library, reps=10, trials=10),
               "device_ms": device_ms(kernel, reps=10),
               "single_ms": single_call_ms(kernel, cold=False),
               "cold_l2_ms": single_call_ms(kernel, cold=True),
               "plain_device_ms": device_ms(lambda: ref.flash_attention_gqa(
                   q, k, v, causal=causal, window=window), reps=2),
               "library_device_ms": device_ms(library, reps=10),
               "library_single_ms": single_call_ms(library, cold=False),
               "library_cold_l2_ms": single_call_ms(library, cold=True),
               "bound_ms": bound_ms, "bound_by": by,
               "deterministic": True,
               "library_err": float((library().transpose(1, 2).float()
                                     - got.float()).abs().max())}
        flops = flash_flops(b, s, h, d, causal, window)
        for key in ("device_ms", "library_device_ms"):
            ms = row[key]
            row[key.replace("ms", "tflops")] = (
                None if ms is None else flops / ms / 1e9)
        if fa_k.route(d) == "pad":
            row.update(flash_split(kernel))
            print(f"  {name:24s} {what}: pad route, depth {fa_k.depth(d)}: "
                  f"kernel {row['kernel_device_ms']:.4f} device ms, the "
                  f"three padding copies {row['pad_device_ms']:.4f}")
        rows.append(row)
        print(f"  {name:24s} {what}: ms per call (device ms): kernel "
              f"{row['ms']:.4f} ({_fmt(row['device_ms'])}; one call "
              f"{row['single_ms']:.4f}, cold L2 {row['cold_l2_ms']:.4f}; "
              f"{_fmt(row['device_tflops'])} TFLOP/s), plain "
              f"{row['plain_ms']:.4f} ({_fmt(row['plain_device_ms'])}), "
              f"library {row['library_ms']:.4f} "
              f"({_fmt(row['library_device_ms'])}; one call "
              f"{row['library_single_ms']:.4f}, cold L2 "
              f"{row['library_cold_l2_ms']:.4f}; "
              f"{_fmt(row['library_device_tflops'])} TFLOP/s), bound "
              f"{bound_ms:.5f} ({by}); |library - kernel| "
              f"{row['library_err']:.3e}; two launches equal")
    return max(errs), rows


def _kernel_count(prof) -> int:
    """Kernels a torch.profiler run of the card saw (copies and fills
    apart)."""
    n = 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        low = e.key.lower()
        if us > 0 and "memcpy" not in low and "memset" not in low:
            n += e.count
    return n


def _lm_group(name: str) -> str:
    low = name.lower()
    if "flash_attention_kernel" in name:
        return "flash"
    if any(s in low for s in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matmul"
    return "copies" if "memcpy" in low or "memset" in low else "other"


def _lm_tokens(cfg, b: int, s: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).cuda()


def lm_prefill(cfg, params) -> dict:
    """``api.prefill`` of smollm-360m at full width, B = 1, at each length:
    flash_attention launched once a layer, finite logits, tokens/s (host
    clock around a synchronised prefill), device time by group and the
    device's idle share."""
    out = {}
    for s in LM_PREFILL_S:
        batch = {"tokens": _lm_tokens(cfg, 1, s, seed=s)}
        reset_counts()
        logits, cache = lm_api.prefill(params, cfg, batch, s)
        torch.cuda.synchronize()
        launches = launch_counts()
        if launches["flash_attention"] != cfg.n_layers or any(
                n != "flash_attention" and c for n, c in launches.items()):
            fail(f"prefill S = {s}: launches {launches}, expected "
                 f"flash_attention x {cfg.n_layers} only")
        if not bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()):
            fail(f"prefill S = {s}: non-finite logits")
        walls = []
        for _ in range(LM_TIMED):
            t0 = time.perf_counter()
            lm_api.prefill(params, cfg, batch, s)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = float(np.median(walls))
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            lm_api.prefill(params, cfg, batch, s)
            torch.cuda.synchronize()
        groups = {}
        for kname, us in _kernel_times_us(prof).items():
            g = _lm_group(kname)
            groups[g] = groups.get(g, 0.0) + us / 1e3
        busy = sum(groups.values())
        kernels = _kernel_count(prof)
        # the kernel's device time per launch inside the model, against
        # phase 10(a)'s time of the same shape alone
        per_launch = groups.get("flash", 0.0) / cfg.n_layers
        out[s] = {"launches": launches, "ms": wall, "walls_ms": walls,
                  "kernel_launches": kernels,
                  "flash_device_ms_per_launch": per_launch,
                  "tokens_per_s": s / wall * 1e3,
                  "device_ms": groups, "device_busy_ms": busy,
                  "device_idle_share": (1.0 - busy / wall) if busy else None,
                  "logits_range": [float(logits[:, :cfg.vocab_size].min()),
                                   float(logits[:, :cfg.vocab_size].max())]}
        print(f"  prefill S = {s}: {wall:.2f} ms ({s / wall * 1e3:.0f} "
              f"tokens/s), device {busy:.3f} ms "
              f"{ {g: round(v, 4) for g, v in groups.items()} }, idle share "
              f"{out[s]['device_idle_share']}, {kernels} kernel launches; "
              f"flash {per_launch:.4f} device ms a launch in the model; "
              f"launches {launches}")
        del cache
    return out


def _against_fp32(what: str, got: torch.Tensor, want32: torch.Tensor,
                  floor: float) -> dict:
    """A card result against the fp32 logits, within LM_FLOOR_FACTOR x
    floor, and its greedy token against theirs (or a tie within that)."""
    bound = LM_FLOOR_FACTOR * floor
    err = float((got - want32).abs().max())
    a, b = int(got.argmax()), int(want32.argmax())
    margin = float(want32[b] - want32[a])
    print(f"  {what}: max |card - CPU fp32| {err:.3e} (bound {bound:.3e}), "
          f"greedy token {a} / {b} (fp32 margin {margin:.3e})")
    if err > bound or (a != b and margin > bound):
        fail(f"{what}: {err} from the fp32 logits (bound {bound}), token "
             f"{a} against {b}")
    return {"max_abs_err_vs_fp32": err, "bound": bound,
            "token": a, "fp32_token": b, "fp32_margin": margin}


def _cpu_logits(params, cfg, batch: dict) -> tuple:
    """Last-position logits of ``batch`` on the CPU path, in the
    working bf16 and in fp32 from the same weights, and the floor."""
    cpu = tree_map(lambda t: t.cpu(), params)
    batch = {k: t.cpu() for k, t in batch.items()}
    s = sum(t.shape[1] for t in batch.values())
    c16, _ = lm_api.prefill(cpu, cfg, batch, s)
    c32, _ = lm_api.prefill(tree_map(lambda t: t.float(), cpu),
                            cfg.replace(dtype="float32"), batch, s)
    v = cfg.vocab_size
    c16, c32 = c16[0, :v].float(), c32[0, :v]
    return c16, c32, float((c16 - c32).abs().max())


def lm_agree(cfg, params) -> dict:
    """Card against the CPU path's fp32 logits on one prompt of LM_AGREE_S
    tokens, each within LM_FLOOR_FACTOR x the CPU bf16 path's own error:
    (1) at the first LM_AGREE_LAYERS layers, the prefill (the kernel at S
    = 2048), the forward (the kernel; its last position) and decode_step
    after prefill of the prompt but its last token (S = 2047, the direct
    path; decode's einsum over the cache is independent of the kernel);
    (2) a prefill of the first LM_CPU_LAYERS layers, card against the
    CPU path."""
    v = cfg.vocab_size
    toks = _lm_tokens(cfg, 1, LM_AGREE_S, seed=5)
    full_cfg, full_params = cfg, params
    cfg, params = _shallow(cfg, params, LM_AGREE_LAYERS)
    with uncounted():
        pre, _ = lm_api.prefill(params, cfg, {"tokens": toks}, LM_AGREE_S)
        full, _ = lm_api.forward(params, cfg, {"tokens": toks})
        _, cache = lm_api.prefill(params, cfg, {"tokens": toks[:, :-1]},
                                  LM_AGREE_S)
        dec, _ = lm_api.decode_step(params, cfg, cache, toks[:, -1],
                                    LM_AGREE_S - 1)
    card = {"prefill": pre[0, :v], "forward": full[0, -1, :v],
            "decode after prefill": dec[0, :v]}
    card = {k: t.float().cpu() for k, t in card.items()}
    del full, cache
    t0 = time.perf_counter()
    c16, c32, floor = _cpu_logits(params, cfg, {"tokens": toks})
    print(f"  {cfg.n_layers} layers, S = {LM_AGREE_S}: CPU path bf16 vs "
          f"fp32 (floor) {floor:.3e}, |logits| <= "
          f"{float(c32.abs().max()):.3f} ({time.perf_counter() - t0:.1f} s "
          f"on the CPU)")
    out = {"floor": floor, "cpu_bf16_token": int(c16.argmax())}
    for what, t in card.items():
        out[what] = _against_fp32(what, t, c32, floor)
    out["decode_vs_forward_max_abs_err"] = float(
        (card["decode after prefill"] - card["forward"]).abs().max())
    shallow = full_cfg.replace(n_layers=LM_CPU_LAYERS)
    sub = dict(full_params, layers=tree_map(
        lambda t: t[:LM_CPU_LAYERS].clone(), full_params["layers"]))
    with uncounted():
        card2, _ = lm_api.prefill(sub, shallow, {"tokens": toks}, LM_AGREE_S)
    c16, c32, floor2 = _cpu_logits(sub, shallow, {"tokens": toks})
    card2 = card2[0, :v].float().cpu()
    out["shallow"] = {"floor": floor2,
                      "card_vs_cpu_bf16": float((card2 - c16).abs().max())}
    print(f"  {LM_CPU_LAYERS} layers: CPU path bf16 vs fp32 (floor) "
          f"{floor2:.3e}; card vs CPU bf16 "
          f"{out['shallow']['card_vs_cpu_bf16']:.3e}")
    out["shallow"].update(_against_fp32(
        f"prefill, {LM_CPU_LAYERS} layers", card2, c32, floor2))
    return out


def lm_serve(cfg, params) -> dict:
    """DecodeEngine at full width (``lm_engine``), then the serve
    launcher at full width."""
    return {"engine": lm_engine(cfg, params),
            "launcher": serve_launch(LM_ARCH)}


def serve_launch(arch: str) -> dict:
    """The serve launcher at full width: LM_SLOTS requests of LM_PROMPT
    tokens, 8 new tokens each."""
    argv = ["--arch", arch, "--requests", str(LM_SLOTS), "--batch-size",
            str(LM_SLOTS), "--prompt-len", str(LM_PROMPT), "--new-tokens",
            "8", "--max-len", str(LM_MAX_LEN)]
    launcher = serve_launcher.main(argv)
    if launcher.get("n") != LM_SLOTS:
        fail(f"serve launcher: {launcher}")
    print(f"  serve launcher {' '.join(argv)}: {launcher}")
    return launcher


def lm_engine(cfg, params, profile_steps=None) -> dict:
    """DecodeEngine at full width: LM_REQUESTS requests of LM_PROMPT random
    tokens in waves of LM_SLOTS, LM_NEW new tokens each; p50/p99,
    generated tokens/s, ms and kernel launches per decode step (profiled
    over one wave after a warm-up wave; with ``profile_steps``, no
    warm-up wave, and the profile takes that many ``decode_step`` calls
    of LM_SLOTS rows on a fresh cache, the work of an engine step)."""
    rng = np.random.RandomState(9)

    def requests():
        return [Request(rid=i, prompt=rng.randint(
            0, cfg.vocab_size, LM_PROMPT).astype(np.int32),
            max_new_tokens=LM_NEW) for i in range(LM_REQUESTS)]

    def run(engine, reqs):
        """Serve ``reqs``; returns the decode_step calls it took (a
        wave's prompt positions, then one per generated position)."""
        batcher = Batcher(max_batch=LM_SLOTS, max_wait_ms=0.0)
        for r in reqs:
            batcher.submit(r)
        calls = 0
        while any(r.finished_at is None for r in reqs):
            if engine.idle():
                wave = batcher.take()
                engine.admit(wave)
                calls += max(len(r.prompt) for r in wave)
            engine.step()
            calls += 1
        torch.cuda.synchronize()
        return calls

    engine = DecodeEngine(cfg, params, n_slots=LM_SLOTS, max_len=LM_MAX_LEN)
    if profile_steps is None:
        run(engine, requests()[:LM_SLOTS])          # warm the allocator
        engine.latencies.clear()
    reqs = requests()
    reset_counts()
    t0 = time.perf_counter()
    steps = run(engine, reqs)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    if any(launches.values()):
        fail(f"decode serving launched {launches}; its attention is the "
             "plain einsum over the cache")
    generated = sum(len(r.output) for r in reqs)
    if generated != LM_REQUESTS * LM_NEW or any(
            not 0 <= t < cfg.vocab_size for r in reqs for t in r.output):
        fail(f"served {generated} tokens, expected {LM_REQUESTS * LM_NEW}")
    stats = engine.stats()
    if profile_steps is None:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            prof_steps = run(engine, requests()[:LM_SLOTS])
    else:
        cache = lm_api.init_cache(cfg, LM_SLOTS, LM_MAX_LEN, device="cuda")
        tok = torch.zeros((LM_SLOTS,), dtype=torch.int32, device="cuda")
        lm_api.decode_step(params, cfg, cache, tok, 0)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for pos in range(1, profile_steps + 1):
                lm_api.decode_step(params, cfg, cache, tok, pos)
            torch.cuda.synchronize()
        prof_steps = profile_steps
        del cache
    kernels = _kernel_count(prof)
    busy = sum(_kernel_times_us(prof).values()) / 1e3
    out = {**stats, "decode_steps": steps, "wall_s": wall,
           "generated_tokens": generated,
           "tokens_per_s": generated / wall,
           "ms_per_decode_step": wall * 1e3 / steps,
           "launches_per_decode_step": kernels / prof_steps,
           "device_ms_per_decode_step": busy / prof_steps}
    print(f"  DecodeEngine: {LM_REQUESTS} requests, {LM_SLOTS} slots, "
          f"prompts {LM_PROMPT}, {LM_NEW} new tokens: p50 "
          f"{stats['p50_ms']:.1f} ms, p99 {stats['p99_ms']:.1f} ms, "
          f"{out['tokens_per_s']:.1f} generated tokens/s, "
          f"{out['ms_per_decode_step']:.2f} ms and "
          f"{out['launches_per_decode_step']:.0f} kernel launches per "
          f"decode step (device {out['device_ms_per_decode_step']:.3f} ms)")
    return out


def phase_lm(gen) -> dict:
    err, rows = check_flash(gen)
    cfg = registry.get_arch(LM_ARCH)
    params = lm_api.init(torch.Generator(device="cuda").manual_seed(0),
                         cfg, device="cuda")
    print(f"  {LM_ARCH}: {cfg.n_layers} layers, d {cfg.d_model}, heads "
          f"{cfg.attention.n_heads}/{cfg.attention.n_kv_heads}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}, "
          f"{sum(t.numel() for t in tree_leaves(params)) / 1e6:.1f} M "
          f"params from a seeded generator")
    prefill = lm_prefill(cfg, params)
    for s, r in prefill.items():
        alone = next((row for row in rows if row["what"] == LM_ARCH
                      and row["shape"][1] == s), None)
        if alone is None:
            continue
        r["flash_device_ms_alone"] = alone["device_ms"]
        print(f"  flash_attention at S = {s}: "
              f"{r['flash_device_ms_per_launch']:.4f} device ms a launch in "
              f"the prefill, {_fmt(alone['device_ms'])} alone (warm; one "
              f"call {alone['single_ms']:.4f}), {alone['cold_l2_ms']:.4f} "
              f"alone with a cold L2 (events)")
    agree = lm_agree(cfg, params)
    served = lm_serve(cfg, params)
    return {"max_abs_err": err, "rows": rows}, {
        "prefill": {str(s): r for s, r in prefill.items()},
        "launches": prefill[LM_PREFILL_S[0]]["launches"],
        "agree": agree, "serve": served}


# ---------------------------------------------------------------- phase 12

HET_CFG = "dlrm_het2"
HET_MAX_L = 76                     # 2 x lookups_per_table, as served
HET_TRACE = 4                      # micro-batches of 32 in the trace that
                                   # ranks the mixed plan's hot rows
HET_HOT_TABLES = 13                # the tables of highest alpha get a
HET_K = 2048                       # cache of min(HET_K, rows // 4) rows
HET_QUANTIZE_ABOVE = 100_000       # int8 the tables of more rows
HET_DIMS = (8, 16, 32, 64)         # row widths held; 32 as every path before
HET_TIMED = 5                      # train steps per timing trial


def het_batch(cfg, n: int, seed: int, pad: bool = False) -> dict:
    return DLRMSynthetic(cfg, seed=seed).ragged_batch(
        n, dist="poisson", max_l=HET_MAX_L,
        pad_to=n * cfg.n_tables * HET_MAX_L if pad else None)


def het_plans(cfg) -> tuple:
    """The mixed plan of phase 12 and the per-table trace histograms that
    rank its hot rows (HET_TRACE micro-batches of a seed of their own)."""
    trace = het_batch(cfg, HET_TRACE * BUCKET, seed=31)
    counts = es.group_trace_counts(dlrm.member_specs(cfg), trace["indices"],
                                   trace["offsets"])
    hot = set(np.argsort(-np.asarray(cfg.table_alphas),
                         kind="stable")[:HET_HOT_TABLES].tolist())
    k = [min(HET_K, r // 4) if t in hot else 0
         for t, r in enumerate(cfg.table_rows)]
    return dlrm.table_plans(cfg, cache_k=k,
                            quantize_rows_above=HET_QUANTIZE_ABOVE), counts


def het_member_ids(cfg, batch: dict) -> list:
    """Each member's (B, max_l) id matrix as the group hands it over: the
    interleaved stream relayouted once, the -1 slots sent to the member's
    null row."""
    idx = torch.from_numpy(batch["indices"]).cuda()
    off = torch.from_numpy(batch["offsets"]).cuda()
    dense = se.ragged_dense_ids(idx, off, max_l=HET_MAX_L, fill=-1)
    dense = dense.reshape(-1, cfg.n_tables, HET_MAX_L)
    return [torch.where(dense[:, t] >= 0, dense[:, t], sp.null_row)
            for t, sp in enumerate(dlrm.member_specs(cfg))]


def check_het_kernels(cfg, params, counts, gen) -> dict:
    """The kernels at the shapes the group sends them: fused_segment_sum
    and the cached stage over members of row width 8, 16, 32 and 64 at 32
    samples, against the plain version and bit for bit against the
    in-order loop (a coherent cache: the hot/cold law), with device ms a
    call; interaction at F = 27 (the TPU kernel's form, and the stage both
    ways); the dense group step's table gradient (sls_grad_table) on the
    smallest table (32-byte rows) and a 64-wide one, bit for bit against
    the CPU plain version."""
    specs = dlrm.member_specs(cfg)
    ids = het_member_ids(cfg, het_batch(cfg, BUCKET, seed=32))
    errs = {"fused_segment_sum": [], "fused_cached_segment_sum": [],
            "interaction": [], "sls_grad_table": []}
    rows = []
    for d in HET_DIMS:
        t = cfg.table_dims.index(d)
        table, sp, dense = params["tables"][t], specs[t], ids[t]
        what = f"table {t}: {sp.rows_per_table} x {d}"
        got = fd_k.fused_segment_sum(table, dense)
        errs["fused_segment_sum"].append(compare(
            "fused_segment_sum", got, ref.fused_segment_sum(table, dense),
            what))
        cache = se.build_hot_cache(table, sp, counts[t],
                                   min(HET_K, sp.rows_per_table // 4))
        stage = fd_k.fused_cached_segment_stage(cache.hot_rows, cache.slot_of,
                                                table, dense)
        errs["fused_cached_segment_sum"].append(compare(
            "fused_cached_segment_sum", stage,
            ref.fused_cached_segment_stage(cache.hot_rows, cache.slot_of,
                                           table, dense, sp.null_row),
            what + " stage"))
        want = in_order(table, dense)
        torch.cuda.synchronize()
        for name, out in (("fused_segment_sum", got),
                          ("fused_cached_segment_sum", stage)):
            if not torch.equal(out, want):
                fail(f"{name} {what}: differs from the in-order loop by "
                     f"{(out - want).abs().max().item()}")
        print(f"  {'both':24s} {what:34s} equal to the in-order loop "
              f"(torch.equal)")
        b, l = dense.shape
        touched = torch.unique(dense).numel()
        rows.append({
            "table": t, "rows": sp.rows_per_table, "dim": d,
            "shape": [b, l, d], "k": cache.k,
            "fused_segment_sum_device_ms": device_ms(
                lambda: fd_k.fused_segment_sum(table, dense)),
            "cached_stage_device_ms": device_ms(
                lambda: fd_k.fused_cached_segment_stage(
                    cache.hot_rows, cache.slot_of, table, dense)),
            "bound_ms": bound(4 * (b * l + touched * d + b * d),
                              b * l * d)[0]})
    f, dim = cfg.n_interact_features, cfg.emb_dim
    x = torch.randn((BUCKET, f, dim), generator=gen, device="cuda")
    errs["interaction"].append(compare("interaction", fi_k.interaction(x),
                                       ref.interaction(x),
                                       f"x {(BUCKET, f, dim)}"))
    bot = torch.randn((BUCKET, dim), generator=gen, device="cuda")
    emb = torch.randn((BUCKET, cfg.n_tables, dim), generator=gen,
                      device="cuda")
    g = torch.randn((BUCKET, dim + f * (f - 1) // 2), generator=gen,
                    device="cuda")
    got = fi_k.feature_interaction(bot, emb)
    want = ref.feature_interaction(bot, emb)
    errs["interaction"].append(compare("interaction", got[0], want[0],
                                       f"stage B {BUCKET}, F {f} out"))
    _same_bits("interaction", got[1:], want[1:], f"stage F {f} feats")
    for got_d, want_d in zip(
            fi_k.feature_interaction_backward(g, None, bot, emb),
            ref.feature_interaction_backward(g, None, bot, emb)):
        errs["interaction"].append(compare(
            "interaction", got_d, want_d, f"stage F {f} bwd",
            TOL["interaction_backward"]))
    for t in (int(np.argmin(cfg.table_rows)), cfg.table_dims.index(64)):
        sp, dense = specs[t], ids[t]
        b, l = dense.shape
        off = torch.arange(b + 1, dtype=torch.int32, device="cuda") * l
        gt = torch.randn((b, sp.dim), generator=gen, device="cuda")
        got = eg_k.sls_grad_table(gt, dense.reshape(-1), off,
                                  n_rows=sp.total_rows, skip_row=sp.null_row)
        cpu = ref.sls_grad_table(gt.cpu(), dense.reshape(-1).cpu(),
                                 off.cpu(), sp.total_rows)
        cpu[sp.null_row] = 0.0
        if not torch.equal(got.cpu(), cpu):
            fail(f"sls_grad_table table {t} ({sp.total_rows} x {sp.dim}): "
                 f"differs from the CPU plain version by "
                 f"{(got.cpu() - cpu).abs().max().item()}")
        errs["sls_grad_table"].append(0.0)
        print(f"  {'sls_grad_table':24s} table {t}: {sp.total_rows} x "
              f"{sp.dim}, {dense.numel()} positions: equal to the CPU plain "
              f"version (torch.equal)")
    for r in rows:
        print(f"  dim {r['dim']:2d} (table {r['table']}, {r['rows']} rows, "
              f"ids {r['shape'][:2]}, K {r['k']}): device ms a call "
              f"fused_segment_sum {_fmt(r['fused_segment_sum_device_ms'])}, "
              f"cached stage {_fmt(r['cached_stage_device_ms'])}, bound "
              f"{r['bound_ms']:.5f}")
    return {"rows": rows, "max_abs_err": {k: max(v) for k, v in errs.items()}}


def het_eager(cfg):
    """The eager serve step a group engine's graphs capture, over the
    batch the engine pads ``reqs`` to; its launches do not count."""
    step = dlrm.make_ragged_serve_step(cfg, max_l=HET_MAX_L)

    def run(engine, reqs, bucket, params, source):
        with uncounted():
            batch, _ = engine._assemble(reqs, bucket)
            return step(params, batch, source)
    return run


def het_recount(engine, reqs) -> None:
    """The engine's hits and lookups, table by table, against a numpy
    recount of the served ids."""
    snap = engine._hit_snapshot()["per_table"]
    for t, m in enumerate(engine.source.members):
        ids = np.concatenate([r.sparse_ids[t] for r in reqs])
        cache = es.hot_cache_of(m)
        hits = 0 if cache is None else int(
            (cache.slot_of.cpu().numpy()[ids] < cache.k).sum())
        if snap[str(t)] != (float(hits), float(ids.size)):
            fail(f"table {t}: the engine counted {snap[str(t)]} (hits, "
                 f"lookups), the served ids {hits}, {ids.size}")


def het_serve(cfg, params, name: str, plan, counts) -> dict:
    """One plan of phase 12 on buckets 16 and 32: warmup's captures and
    the kernels a forward launches, the grouped lookup against the
    per-table streams, 512 requests at depth 2 bit for bit against the
    eager serve step and within PROB_ATOL of the CPU path, the per-table
    hits recounted, where the time goes, the downgrade (fp plan) and a
    one-member swap with no capture."""
    spec, specs = dlrm.arena_spec(cfg), dlrm.member_specs(cfg)
    step = het_eager(cfg)
    reset_counts()
    engine = RecEngine(cfg, params, source=(
        dlrm.group_source(params, cfg) if plan is None
        else es.SourceSpec(tables=plan)),
        cache_trace=None if plan is None else counts, max_l=HET_MAX_L,
        max_batch=BUCKET, buckets=GRAPH_BUCKETS, device="cuda")
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    if engine.captures != len(GRAPH_BUCKETS) or cold_compiles(engine):
        fail(f"{name}: warmup made {engine.captures} captures, "
             f"{cold_compiles(engine)} cold")
    per = _capture_counts(engine, name)
    kinds = es.describe_source(engine.source)[len("group["):-1].split(",")
    want = {n: c for n, c in (
        ("gemm", 6), ("interaction", 1),
        ("fused_segment_sum", kinds.count("fp")),
        ("fused_cached_segment_sum", kinds.count("cached(fp)"))) if c}
    if {n: c for n, c in per.items() if c} != want:
        fail(f"{name}: a forward launched {per}, the plan {want}")
    launches = launch_counts()
    pool = graph_pool_bytes(engine)
    # the grouped lookup against the per-table streams, on the card
    rb = het_batch(cfg, BUCKET, seed=33)
    with uncounted():
        idx_t, off_t = DLRMSynthetic.ragged_per_table(rb, cfg.n_tables)
        grouped = es.lookup_bags(engine.source, spec,
                                 torch.from_numpy(rb["indices"]).cuda(),
                                 torch.from_numpy(rb["offsets"]).cuda(),
                                 max_l=HET_MAX_L)
        loop = es.lookup_bags_per_table(
            engine.source, [torch.from_numpy(i).cuda() for i in idx_t],
            [torch.from_numpy(o).cuda() for o in off_t], max_l=HET_MAX_L)
    _same_bits(name, [grouped], [loop], "grouped == per-table streams")
    # 512 requests at depth 2 over both buckets, each micro-batch bit for
    # bit against the eager serve step
    batch = het_batch(cfg, N_REQUESTS, seed=7)
    reqs = requests_from_ragged_batch(batch, cfg.n_tables)
    sizes = mixed_sizes(N_REQUESTS, 5)
    buckets = pipelined(engine, reqs, sizes, lambda mb, b: step(
        engine, mb, b, engine.params, engine.source))
    probs = np.array([r.prob for r in reqs], np.float64)
    if buckets != list(GRAPH_BUCKETS) or engine.captures != len(
            GRAPH_BUCKETS) or cold_compiles(engine) \
            or launch_counts() != launches:
        fail(f"{name}: served buckets {buckets}, {engine.captures} "
             f"captures, {cold_compiles(engine)} cold, launches "
             f"{launch_counts()} after warmup's {launches}")
    if any(es.hot_cache_of(m) is not None for m in engine.source.members):
        het_recount(engine, reqs)
        rates = {t: round(r, 3) for t, r in
                 engine.stats()["cache_hit_rate"].items() if r is not None}
        print(f"  {name:6s} per-table hits and lookups equal a numpy recount "
              f"of the served ids; hit rates {rates}")
    cpu_params = _copy(params, "cpu")
    cpu = RecEngine(cfg, cpu_params, source=(
        dlrm.group_source(cpu_params, cfg) if plan is None
        else es.SourceSpec(tables=plan)),
        cache_trace=None if plan is None else counts, max_l=HET_MAX_L,
        max_batch=BUCKET, buckets=GRAPH_BUCKETS, device="cpu")
    cpu_reqs = requests_from_ragged_batch(batch, cfg.n_tables)
    pipelined(cpu, cpu_reqs, sizes)
    err = float(np.abs(probs - np.array([r.prob for r in cpu_reqs])).max())
    if err > PROB_ATOL or not (np.isfinite(probs).all() and (probs > 0).all()
                               and (probs < 1).all()):
        fail(f"{name}: card probabilities {err} from the CPU path")
    # request latency at depth 2, without the checks
    timed = requests_from_ragged_batch(het_batch(cfg, N_REQUESTS, seed=12),
                                       cfg.n_tables)
    mark = engine._lat_hist.count
    t0 = time.perf_counter()
    pipelined(engine, timed, mixed_sizes(N_REQUESTS, 6))
    pipe_s = time.perf_counter() - t0
    stats = engine.stats()
    stats.update(recent_latency(engine, engine._lat_hist.count - mark))
    prof = profile_serve(engine, cfg, n_batches=16, batch_fn=het_batch)
    _check_replay(prof, per, name)
    row = {"source": stats["source"], "captures": engine.captures,
           "warmup_s": warmup_s, "graph_pool_bytes": pool,
           "capture_counts": per, "prob_max_abs_err_vs_cpu": err,
           "p50_ms": stats["p50_ms"], "p95_ms": stats["p95_ms"],
           "p99_ms": stats["p99_ms"],
           "depth2_ms_per_batch": pipe_s * 1e3 / len(mixed_sizes(
               N_REQUESTS, 6)),
           "host_ms_per_batch": prof["wall_ms_per_batch"],
           "device_busy_ms": prof["device_busy_ms_per_batch"],
           "device_ms_by_group": prof["device_ms_per_batch"],
           "idle_share": prof["device_idle_share"],
           "kernels_per_replay": prof["kernels_per_batch"],
           "kernels_by_group": prof["kernels_by_group"],
           "device_us_by_kernel": prof["device_us_by_kernel"],
           "cache_hit_rate": stats["cache_hit_rate"]}
    if plan is None:
        row["downgrade"] = het_downgrade(cfg, engine, step)
        launches = launch_counts()
    # one member swapped: the fp plan's first arena, the mixed plan's
    # first cached member's hot cache; copied in place, no capture
    t = next((i for i, m in enumerate(engine.source.members)
              if es.hot_cache_of(m) is not None), 0)
    m = engine.source.members[t]
    if es.hot_cache_of(m) is None:
        new = es.FpArena(params["tables"][t] * 1.5)
    else:
        new = es.with_hot_cache(m, se.build_hot_cache(
            params["tables"][t], specs[t], np.roll(counts[t], 7), m.k))
    swapped = es.replace_member(engine.source, t, new)
    captures = engine.captures
    engine.update_source(swapped, version=1)
    after = requests_from_ragged_batch(het_batch(cfg, 4 * BUCKET, seed=13),
                                       cfg.n_tables)
    pipelined(engine, after, [BUCKET, 11] * 2, lambda mb, b: step(
        engine, mb, b, engine.params, swapped))
    if engine.captures != captures or cold_compiles(engine) \
            or launch_counts() != launches:
        fail(f"{name}: the member swap recaptured or ran the wrappers")
    print(f"  {name:6s} {row['source'][:48]}...: captures {captures} "
          f"({warmup_s:.3f} s, graph pool {pool} bytes), a forward "
          f"{want}; {len(sizes)} micro-batches at depth {DEPTH} over "
          f"{GRAPH_BUCKETS} equal to the eager step bit for bit, within "
          f"{err:.2e} of the CPU path; after replace_member({t}): no "
          f"capture, 4 micro-batches equal")
    print(f"  {name:6s} per micro-batch of {BUCKET}: host "
          f"{row['host_ms_per_batch']:.4f} ms, device busy "
          f"{row['device_busy_ms']:.4f} ms "
          f"{ {k: round(v, 5) for k, v in row['device_ms_by_group'].items()} }"
          f", idle share {row['idle_share']:.3f}, "
          f"{row['kernels_per_replay']:.0f} kernels a replay; depth {DEPTH}: "
          f"{row['depth2_ms_per_batch']:.4f} ms a micro-batch, p50 "
          f"{row['p50_ms']:.4f} p95 {row['p95_ms']:.4f} p99 "
          f"{row['p99_ms']:.4f} ms")
    row["launches"] = launches
    return row


def het_downgrade(cfg, engine, step) -> dict:
    """The group's int8 downgrade, one int8 member a table: captured by
    warmup, bit for bit against the eager step over it and within the
    reference's bound of the primary path."""
    engine.enable_downgrade()
    captures = engine.captures
    engine.warmup()
    if engine.captures != captures + len(GRAPH_BUCKETS):
        fail(f"downgrade: warmup made {engine.captures - captures} captures")
    down = engine.downgrade_source
    for m, a in zip(down.members, engine.params["tables"]):
        q = es.QuantizedArena.from_arena(a)
        if not (torch.equal(m.q, q.q) and torch.equal(m.scales, q.scales)):
            fail("downgrade: a member is not its quantized arena")
    reqs = requests_from_ragged_batch(het_batch(cfg, 4 * BUCKET, seed=14),
                                      cfg.n_tables)
    primary = [step(engine, reqs[i:i + BUCKET], BUCKET, engine.params,
                    engine.source).cpu().numpy()
               for i in range(0, len(reqs), BUCKET)]
    pipelined(engine, reqs, [BUCKET] * 4, lambda mb, b: step(
        engine, mb, b, engine.params, down), downgraded=True)
    got = np.array([r.prob for r in reqs], np.float32)
    err = float(np.abs(got - np.concatenate(primary)).max())
    if err > INT8_PROB_ATOL or not all(r.downgraded for r in reqs):
        fail(f"downgrade: {err} from the primary path")
    print(f"  downgrade (26 int8 members): 4 micro-batches equal to the "
          f"eager step bit for bit, within {err:.3e} of the primary path "
          f"(bound {INT8_PROB_ATOL})")
    return {"max_abs_err_vs_primary": err}


def het_train(cfg) -> dict:
    """TRAIN_STEPS steps of each group step at batch 32, each on the card
    and on the CPU path from a copy of the card's state before it, under
    phase 4's laws (the tables' budget, table by table: the rows of two
    samples' bags); the wrappers' launches by name a step; then ms and
    kernels a step, device ms by group."""
    p0 = dlrm.init(torch.Generator(device="cuda").manual_seed(5), cfg,
                   device="cuda")
    specs = dlrm.member_specs(cfg)
    batches = [het_batch(cfg, BUCKET, seed=41 + i, pad=True)
               for i in range(TRAIN_STEPS)]
    head = ("bottom", "top", "proj")
    p_max = max(w.abs().max().item() for k in head
                for w in tree_leaves(p0[k]))
    want = {"gemm": 17, "interaction": 2, "fused_segment_sum": cfg.n_tables,
            "sls_grad_table": cfg.n_tables}
    out = {}
    for sparse, mode in ((True, "sparse"), (False, "dense")):
        opt, step = dlrm.make_train_step_ragged(cfg, max_l=HET_MAX_L,
                                                sparse=sparse)
        params = _copy(p0, "cuda")
        state = opt.init(params)
        reset_counts()
        steps = []
        for i, b in enumerate(batches):
            cpu_params, cpu_state = _copy(params, "cpu"), _copy(state, "cpu")
            params, state, loss, rows = step(params, state, {
                k: torch.from_numpy(b[k]).cuda() for k in TRAIN_KEYS})
            cpu_params, cpu_state, cpu_loss, cpu_rows = step(
                cpu_params, cpu_state,
                {k: torch.from_numpy(b[k]) for k in TRAIN_KEYS})
            rel = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
            if rel > LOSS_RTOL:
                fail(f"het {mode} step {i}: loss {float(loss)} on the card, "
                     f"{float(cpu_loss)} on the CPU")
            if not all(torch.equal(r.cpu(), c)
                       for r, c in zip(rows, cpu_rows)):
                fail(f"het {mode} step {i}: touched rows differ")
            mlp_card, mlp_cpu = (torch.cat([t.reshape(-1) for k in head
                                            for t in tree_leaves(p[k])])
                                 for p in (params, cpu_params))
            mlp = _beyond(mlp_card, mlp_cpu,
                          int(MLP_SHARE * mlp_cpu.numel()),
                          2 * LR * (1.01 + 0.01 * p_max),
                          f"het {mode} step {i} MLP and projections")
            beyond, worst = 0, 0.0
            for t, (sp, r) in enumerate(zip(specs, rows)):
                touched = r[r != sp.null_row].long()
                tab = _beyond(params["tables"][t][touched],
                              cpu_params["tables"][t][touched.cpu()],
                              ARENA_SAMPLES * HET_MAX_L,
                              2 * 10 * LR * sp.dim ** 0.5,
                              f"het {mode} step {i} table {t} rows")
                beyond += tab["beyond"]
                worst = max(worst, tab["max_abs_err"])
                if params["tables"][t][sp.null_row].any():
                    fail(f"het {mode} step {i}: table {t}'s null row moved")
            steps.append({"loss_card": float(loss), "loss_cpu":
                          float(cpu_loss), "loss_rel_err": rel, "mlp": mlp,
                          "table_rows_beyond": beyond,
                          "table_rows_max_abs_err": worst})
            print(f"  het {mode:6s} step {i}: loss {float(loss):.6f} (card vs "
                  f"CPU rel {rel:.1e}); touched rows equal on "
                  f"{cfg.n_tables} tables; MLPs and projections "
                  f"{mlp['beyond']} of {mlp['of']} beyond {PARAM_ATOL} (max "
                  f"{mlp['max_abs_err']:.1e}), touched table rows {beyond} "
                  f"(max {worst:.1e})")
        launches = launch_counts()
        for n in KERNELS:
            if launches[n] != want.get(n, 0) * TRAIN_STEPS:
                fail(f"het {mode}: {n} launched {launches[n]} times in "
                     f"{TRAIN_STEPS} steps; {want.get(n, 0)} a step")
        batch = {k: torch.from_numpy(batches[0][k]).cuda()
                 for k in TRAIN_KEYS}
        tp = _copy(p0, "cuda")
        ts = [opt.init(tp)]

        def one():
            _, ts[0], _, _ = step(tp, ts[0], batch)
        ms = time_ms(one, reps=HET_TIMED, trials=3)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(HET_TIMED):
                one()
            torch.cuda.synchronize()
        groups, by_kernel = {}, _kernel_times_us(prof)
        for kname, us in by_kernel.items():
            g = _kernel_group(kname)
            groups[g] = groups.get(g, 0.0) + us / 1e3 / HET_TIMED
        busy = sum(groups.values())
        out[mode] = {"steps": steps, "launches": launches,
                     "device_us_by_kernel": by_kernel,
                     "launches_per_step": want, "ms_per_step": ms,
                     "kernels_per_step": _kernel_count(prof) / HET_TIMED,
                     "device_ms_per_step": groups,
                     "device_busy_ms_per_step": busy,
                     "device_idle_share": (1.0 - busy / ms) if busy
                     else None}
        print(f"  het {mode:6s} per step of {BUCKET}: {ms:.4f} ms (CUDA "
              f"events), {out[mode]['kernels_per_step']:.0f} kernels on the "
              f"card, device {busy:.4f} ms "
              f"{ {k: round(v, 5) for k, v in groups.items()} }, idle share "
              f"{out[mode]['device_idle_share']}; wrapper launches a step "
              f"{want}")
    return out


def phase_het(gen) -> dict:
    """Phase 12: dlrm_het2 at full size on the card."""
    cfg = DLRM_HET_CONFIGS[HET_CFG]
    params = dlrm.init(torch.Generator(device="cuda").manual_seed(3), cfg,
                       device="cuda")
    print(f"  {HET_CFG}: {cfg.n_tables} tables of {min(cfg.table_rows)}-"
          f"{max(cfg.table_rows)} rows, dims {sorted(set(cfg.table_dims))}, "
          f"{cfg.table_bytes / 1e6:.1f} MB of fp32 rows, max_l {HET_MAX_L}, "
          f"batch {BUCKET}")
    mixed, counts = het_plans(cfg)
    out = {"kernels": check_het_kernels(cfg, params, counts, gen)}
    for name, plan in (("fp", None), ("mixed", mixed)):
        out[name] = het_serve(cfg, params, name, plan, counts)
    out["train"] = het_train(cfg)
    return out


# ---------------------------------------------------------------- phase 13

PLANE_N = 3000                     # 13(d): requests of each open-loop trace
PLANE_SEED = 17                    # the reference's trace seed
PLANE_BUCKETS = (BUCKET // 4, BUCKET)   # the reference's (8, 32)
PLANE_WAIT_MS = 1.0
PLANE_OVERLOAD = 2.0               # the Poisson trace, x capacity
DIURNAL_TROUGH = 0.6               # the diurnal trace, x capacity at t = 0
DIURNAL_PEAK = 2.5                 # its peak, x the trough
CAL_CALLS = 10                     # full-bucket calls that set t_batch
HET_PLANE_N = 800                  # 13(e): requests of dlrm_het2's trace
HET_PLANE_OVERLOAD = 1.5
PLANE_EXACT = 1e-6                 # the primary path against the sync loop
                                   # (every kernel computes a row on its
                                   # own: equal bits expected)


def _plane_engine(cfg, params, telemetry=None, **kw):
    return RecEngine(cfg, params, max_l=MAX_L, max_batch=BUCKET,
                     telemetry=telemetry, device="cuda", **kw)


def _probe_kernels(engine, cfg) -> dict:
    """The hit probe's kernels by name, run eagerly over one padded
    micro-batch under the profiler (it adds to the engine's counter).
    Each trace opens with an uncounted lead-in call, ended by a
    synchronize: once phase 10 has run, a trace's first records go
    missing (see ``trace_replays``). Traces are taken until two agree, at
    most TRACE_TAKES."""
    probe = engine._hit_probe()
    reqs = requests_from_ragged_batch(poisson_batch(cfg, BUCKET, 13),
                                      cfg.n_tables)
    batch, _ = engine._assemble(reqs, BUCKET)
    taken = []
    for _ in range(TRACE_TAKES):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            probe(batch)
            torch.cuda.synchronize()
            probe(batch)
            torch.cuda.synchronize()
        events = prof.profiler.kineto_results.events()
        split = min((e.correlation_id() for e in events
                     if e.name() == "cudaDeviceSynchronize"), default=None)
        out = {}
        for e in events:
            if split is not None and e.correlation_id() > split \
                    and e.device_type() == torch.autograd.DeviceType.CUDA:
                out[e.name()] = out.get(e.name(), 0) + 1
        if out and out in taken:
            return out
        taken.append(out)
    fail(f"13(a): {TRACE_TAKES} traces of the hit probe disagreed: "
         f"{[sum(t.values()) for t in taken]} kernels")


def _replay_kernels(engine, cfg) -> dict:
    """One served micro-batch's kernels by name, from the profiler's
    trace of graph replays (``trace_replays``)."""
    def batches(seed: int, n: int):
        reqs = requests_from_ragged_batch(poisson_batch(cfg, n * BUCKET,
                                                        seed), cfg.n_tables)

        def run() -> None:
            for i in range(0, len(reqs), BUCKET):
                for r in reqs[i:i + BUCKET]:
                    engine.submit(r)
                engine.step()
        return run
    return trace_replays(batches(14, 4), 4, batches(15, 1))["by_name"]


def _without_copies(names: dict) -> dict:
    return {n: c for n, c in names.items() if _kernel_group(n) != "copies"}


def plane_overhead(cfg, params, counts) -> tuple:
    """13(a): a Telemetry() and a Telemetry.disabled() engine of each plan
    serve the same 512 requests, micro-batch by micro-batch in turns,
    through dispatch and settle."""
    out, engines, batch = {}, {}, served_batch(cfg)
    plans = (("fp", {}), ("cached", {"source": "cached", "cache_k": CACHE_K,
                                     "cache_trace": counts}))
    for name, plan in plans:
        pair = {tag: _plane_engine(cfg, params, tel, buckets=(BUCKET,),
                                   **plan)
                for tag, tel in (("on", obs.Telemetry()),
                                 ("off", obs.Telemetry.disabled()))}
        for eng in pair.values():
            eng.warmup()
        reqs = {tag: requests_from_ragged_batch(batch, cfg.n_tables)
                for tag in pair}
        host_ms = {tag: [] for tag in pair}
        bound_ms = []                      # each micro-batch's client wait
        for i, lo in enumerate(range(0, N_REQUESTS, BUCKET)):
            for tag in (("on", "off") if i % 2 == 0 else ("off", "on")):
                mb = reqs[tag][lo:lo + BUCKET]
                sent = time.monotonic()
                for r in mb:
                    r.submitted_mono = sent
                t0 = time.perf_counter()
                pair[tag].settle(pair[tag].dispatch(mb))
                host_ms[tag].append((time.perf_counter() - t0) * 1e3)
                if tag == "on":
                    bound_ms.append((time.monotonic() - sent) * 1e3)
        probs = {tag: np.array([r.prob for r in reqs[tag]]) for tag in pair}
        if not np.array_equal(probs["on"], probs["off"]):
            fail(f"13(a) {name}: instrumented and disabled probabilities "
                 f"differ by {np.abs(probs['on'] - probs['off']).max()}")
        on, off = pair["on"], pair["off"]
        reg = on.telemetry.registry
        got = {k: reg.counter(k).value for k in (
            "rec_requests_total", "rec_batches_total",
            "rec_cold_compiles_total")}
        want = {"rec_requests_total": N_REQUESTS,
                "rec_batches_total": N_REQUESTS // BUCKET,
                "rec_cold_compiles_total": 0}
        if got != want:
            fail(f"13(a) {name}: counters {got}, the run {want}")
        h, st = on._lat_hist, on.stats()
        lat = h.ring_values()
        pct = {q: float(np.percentile(lat, q)) for q in (50, 99)}
        if h.count != N_REQUESTS or st["p50_ms"] != pct[50] \
                or st["p99_ms"] != pct[99]:
            fail(f"13(a) {name}: latency count {h.count}, p50/p99 "
                 f"{st['p50_ms']}/{st['p99_ms']} against np.percentile "
                 f"{pct}")
        if (lat < 0).any() or (lat.reshape(-1, BUCKET)
                               > np.array(bound_ms)[:, None]).any():
            fail(f"13(a) {name}: a latency outside [0, the client's wait]")
        off_reg = off.telemetry.registry.snapshot()
        if off.stats() != {"n": 0} or len(off.telemetry.events) \
                or any(off_reg["counters"].values()) \
                or any(v["count"] for v in off_reg["histograms"].values()) \
                or off._lookups:
            fail(f"13(a) {name}: the disabled engine recorded {off_reg}")
        med = {tag: float(np.median(host_ms[tag])) for tag in pair}
        ratio = med["on"] / med["off"]
        print(f"  13(a) {name:6s}: 512 requests in 16 micro-batches each, "
              f"in turns; probabilities equal bit for bit; counters {got}; "
              f"latency count {h.count}, p50 {pct[50]:.4f} ms, p99 "
              f"{pct[99]:.4f} ms (= np.percentile); host ms a micro-batch "
              f"(dispatch + settle, median) instrumented {med['on']:.4f}, "
              f"disabled {med['off']:.4f}, ratio {ratio:.4f}")
        out[name] = {"host_ms_on": med["on"], "host_ms_off": med["off"],
                     "ratio": ratio, "p50_ms": pct[50], "p99_ms": pct[99],
                     "counters": got}
        engines[name] = (pair, reqs["on"])
    return out, engines


def plane_kernels(cfg, engines) -> dict:
    """13(a): a replay's kernels by name; the disabled cached replay's are
    the instrumented one's minus the hit probe's, and the fp plan's are
    the same both ways."""
    out = {}
    for name, (pair, _) in engines.items():
        on, off = (_without_copies(_replay_kernels(pair[t], cfg))
                   for t in ("on", "off"))
        probe = (_without_copies(_probe_kernels(pair["on"], cfg))
                 if name == "cached" else {})
        diff = {k: on.get(k, 0) - off.get(k, 0) for k in set(on) | set(off)
                if on.get(k, 0) != off.get(k, 0)}
        if diff != probe:
            fail(f"13(a) {name}: instrumented replay minus disabled replay "
                 f"{diff}, the hit probe's kernels {probe}")
        print(f"  13(a) {name:6s}: a replay runs {sum(on.values())} kernels "
              f"instrumented, {sum(off.values())} disabled; the difference "
              f"is the hit probe's {sum(probe.values())} "
              f"({sorted(_kernel_group(k) for k in probe)})")
        out[name] = {"kernels_on": sum(on.values()),
                     "kernels_off": sum(off.values()),
                     "probe_kernels": probe}
    return out


def _arena_ids(cfg, reqs) -> np.ndarray:
    return np.concatenate([ids.astype(np.int64) + t * cfg.rows_per_table
                           for r in reqs for t, ids in
                           enumerate(r.sparse_ids)])


def plane_versions(cfg, engines) -> dict:
    """13(b): the instrumented cached engine's outgoing version attributed
    at a cache swap, the since-swap window, a stale broadcast refused; no
    capture."""
    (pair, served), (fp_pair, _) = engines["cached"], engines["fp"]
    eng, spec = pair["on"], dlrm.arena_spec(cfg)
    captures = eng.captures
    cache = eng.cache
    ids = _arena_ids(cfg, served)
    hits = int((cache.slot_of.cpu().numpy()[ids] < cache.k).sum())
    warm = poisson_batch(cfg, WARM, 23)
    fresh = se.build_hot_cache(eng.params["arena"], spec,
                               se.trace_row_counts(spec, warm["indices"],
                                                   warm["offsets"]), CACHE_K)
    eng.update_cache(fresh, version=1)
    evs = eng.telemetry.events.query("cache_swap")
    if len(evs) != 1 or evs[0].version != 1 \
            or (evs[0].attrs["hits"], evs[0].attrs["lookups"]) \
            != (float(hits), float(ids.size)) \
            or eng.telemetry.events.hit_rate_by_version() != {
                0: hits / ids.size}:
        fail(f"13(b): cache_swap events {evs} against the recount of the "
             f"outgoing version's {ids.size} lookups, {hits} hits")
    more = {tag: requests_from_ragged_batch(poisson_batch(cfg, 2 * BUCKET,
                                                          24), cfg.n_tables)
            for tag in ("cached", "fp")}
    for tag, e in (("cached", eng), ("fp", fp_pair["on"])):
        for lo in (0, BUCKET):
            e.settle(e.dispatch(more[tag][lo:lo + BUCKET]))
    got = np.array([r.prob for r in more["cached"]])
    if not np.array_equal(got, np.array([r.prob for r in more["fp"]])):
        fail("13(b): the swapped cache serves other bits than the fp plan")
    st = eng.stats()
    new_ids = _arena_ids(cfg, more["cached"])
    rate = float((eng.cache.slot_of.cpu().numpy()[new_ids]
                  < CACHE_K).sum()) / new_ids.size
    if st["since_swap"]["n"] != 2 * BUCKET \
            or st["n"] != N_REQUESTS + 2 * BUCKET \
            or st["cache_hit_rate"] != rate:
        fail(f"13(b): since_swap n {st['since_swap']['n']}, n {st['n']}, "
             f"hit rate {st['cache_hit_rate']} (recount {rate})")
    try:
        eng.update_cache(cache, version=0)
    except ValueError as e:
        refused = str(e)
    else:
        fail("13(b): a stale cache broadcast was adopted")
    stale = eng.telemetry.events.query("stale_rejected")
    if eng.telemetry.registry.counter("rec_stale_rejected_total").value != 1 \
            or len(stale) != 1 or eng.captures != captures:
        fail(f"13(b): stale events {stale}, {eng.captures} captures "
             f"({captures} before the swap)")
    print(f"  13(b) cache_swap v0 -> v1 carries hits {hits} of {ids.size} "
          f"lookups (= the numpy recount; hit_rate_by_version "
          f"{hits / ids.size:.4f}); since_swap n {st['since_swap']['n']} of "
          f"n {st['n']}; the new version's hit rate {rate:.4f} (recount); "
          f"served bits equal the fp plan; stale v0 refused ({refused}) "
          f"with a stale_rejected event; no capture after the swap")
    return {"outgoing_hits": hits, "outgoing_lookups": int(ids.size),
            "new_hit_rate": rate, "since_swap_n": st["since_swap"]["n"]}


def plane_fig5(cfg, params, engines, served) -> dict:
    """13(c): the live Fig-5 mode on the fp plan, against the graphed
    engine's bits on the same micro-batches."""
    eng = _plane_engine(cfg, params, obs.Telemetry(device_stages=True),
                        buckets=(BUCKET,))
    eng.warmup()
    reqs = requests_from_ragged_batch(served_batch(cfg), cfg.n_tables)
    for lo in range(0, N_REQUESTS, BUCKET):
        for r in reqs[lo:lo + BUCKET]:
            eng.submit(r)
        eng.step()
    eng.drain()
    graphed = np.array([r.prob for r in engines["fp"][1]])
    got = np.array([r.prob for r in reqs])
    if not np.array_equal(got, graphed):
        fail(f"13(c): the staged forward differs from the graph replay by "
             f"{np.abs(got - graphed).max()}")
    fig5, st = eng.live_fig5(), eng.stats()
    if st["stages"] != fig5 or not 0.0 < fig5["emb_frac"] < 1.0:
        fail(f"13(c): stats()['stages'] {st['stages']}, live_fig5 {fig5}")
    split = served["profile"]["device_ms_per_batch"]
    busy = served["profile"]["device_busy_ms_per_batch"]
    emb3 = split.get("fused_segment_sum", 0.0) / busy if busy else None
    print(f"  13(c) live Fig-5 over 16 micro-batches of 32 (CUDA events "
          f"between the stages, a synchronize after each): "
          f"{ {k: round(v, 4) for k, v in fig5.items()} }; probabilities "
          f"equal the graph replay's bit for bit")
    print(f"  13(c) beside phase 3's profiler split of a replay (device ms "
          f"by kernel group): { {k: round(v, 4) for k, v in split.items()} }"
          f", embedding share {emb3}")
    return {**fig5, "phase3_device_ms_by_group": split,
            "phase3_emb_frac": emb3}


def _t_batch(call, n: int = CAL_CALLS) -> float:
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _check_open_loop(what: str, sched, reqs, want: dict,
                     down_want: dict) -> dict:
    """Accounting and answers of one scheduled trace: served + shed = n,
    one shed event and one flag a shed request; the primary path within
    PLANE_EXACT of ``want`` (rid -> prob), downgraded requests within
    INT8_PROB_ATOL of it (and within PLANE_EXACT of ``down_want`` where
    given)."""
    n = len(reqs)
    events = len(sched.telemetry.events.query("shed"))
    flagged = sum(r.shed for r in reqs)
    if sched.served + sched.shed != n or events != sched.shed \
            or flagged != sched.shed:
        fail(f"{what}: served {sched.served} + shed {sched.shed} of {n}, "
             f"{events} shed events, {flagged} flagged")
    prim = [r for r in reqs if not r.shed and not r.downgraded]
    down = [r for r in reqs if not r.shed and r.downgraded]
    if any(r.prob is not None for r in reqs if r.shed):
        fail(f"{what}: a shed request was served")
    d_prim = np.array([abs(r.prob - want[r.rid]) for r in prim])
    d_down = np.array([abs(r.prob - want[r.rid]) for r in down])
    if len(d_prim) and d_prim.max() > PLANE_EXACT:
        fail(f"{what}: the primary path lies {d_prim.max()} from the "
             f"reference")
    if len(d_down) and d_down.max() > INT8_PROB_ATOL:
        fail(f"{what}: a downgraded request lies {d_down.max()} from the "
             f"primary path")
    d_own = np.array([abs(r.prob - down_want[r.rid]) for r in down
                      if r.rid in down_want])
    if len(d_own) and d_own.max() > PLANE_EXACT:
        fail(f"{what}: the downgrade path lies {d_own.max()} from the int8 "
             f"source's eager forward")
    return {"primary": len(prim), "downgraded": len(down),
            "primary_bit_equal": bool(len(d_prim) == 0 or d_prim.max() == 0),
            "primary_max_abs_diff": float(d_prim.max()) if len(d_prim)
            else 0.0,
            "downgrade_max_abs_diff": float(d_down.max()) if len(d_down)
            else 0.0}


def _loop_row(what: str, stats: dict, secs: float, n: int) -> dict:
    row = {"p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
           "replay_s": secs, "achieved_qps": n / secs,
           **{k: stats[k] for k in ("shed_frac", "downgrade_frac",
                                     "queue_wait_p50_ms",
                                     "queue_wait_p99_ms") if k in stats}}
    print(f"  {what}: p50 {row['p50_ms']:.4f} ms, p99 {row['p99_ms']:.4f} ms"
          f", replayed in {secs:.4f} s (achieved {row['achieved_qps']:.0f} "
          f"qps)" + "".join(f", {k} {row[k]:.4f}" for k in (
              "shed_frac", "downgrade_frac", "queue_wait_p50_ms",
              "queue_wait_p99_ms") if k in row))
    return row


def plane_open_loop(cfg, params) -> dict:
    """13(d): the reference's open-loop scenario (bench_paper.py
    bench_serve_open_loop) on DLRM(1)'s ragged fp plan at full size."""
    mean_l = cfg.lookups_per_table

    def engine():
        return _plane_engine(cfg, params, obs.Telemetry(),
                             buckets=PLANE_BUCKETS,
                             max_wait_ms=PLANE_WAIT_MS)

    def trace(**kw):
        return loadgen.make_trace(cfg, PLANE_N, mean_l=mean_l, max_l=MAX_L,
                                  seed=PLANE_SEED, **kw)

    cal = engine()
    cal.enable_downgrade()
    cal.warmup()
    cal_reqs = loadgen.zipf_requests(cfg, BUCKET, mean_l=mean_l, max_l=MAX_L,
                                     seed=3)
    cal.settle(cal.dispatch(cal_reqs))
    t_batch = _t_batch(lambda: cal.settle(cal.dispatch(cal_reqs)))
    capacity = BUCKET / t_batch
    sla_ms = 3.0 * t_batch * 1e3
    rate = PLANE_OVERLOAD * capacity
    print(f"  13(d) t_batch {t_batch * 1e3:.4f} ms (median of {CAL_CALLS} "
          f"full-bucket dispatch + settle), capacity {capacity:.0f} qps, "
          f"sla_ms {sla_ms:.4f}, Poisson at {PLANE_OVERLOAD} x capacity = "
          f"{rate:.0f} qps nominal, n {PLANE_N}, seed {PLANE_SEED}")
    # the synchronous loop: serves everything, its p99 is the backlog
    sync = engine()
    sync.warmup()
    tr_sync = trace(kind="poisson", rate_qps=rate)
    secs = loadgen.replay(tr_sync, sync.submit, sync.step)
    sync.drain()
    s_sync = sync.stats()
    if s_sync["n"] != PLANE_N:
        fail(f"13(d): the synchronous loop served {s_sync['n']}")
    want = {r.rid: r.prob for r in tr_sync.requests}
    out = {"t_batch_ms": t_batch * 1e3, "capacity_qps": capacity,
           "sla_ms": sla_ms, "nominal_qps": rate,
           "sync": _loop_row("13(d) synchronous loop", s_sync, secs,
                             PLANE_N)}
    # the SLA scheduler on the same trace: the slice's main path. Its
    # launches are warmup's captures (each counted at its eager pass and
    # its capture); the replay runs no wrapper.
    base = launch_counts()
    eng = engine()
    sched = SlaScheduler(eng, SlaPolicy(
        sla_ms=sla_ms, default_service_ms=t_batch * 1e3,
        max_queue=4 * BUCKET), pipeline_depth=2)
    sched.warmup()
    warm = _diff(launch_counts(), base)
    tr = trace(kind="poisson", rate_qps=rate)
    secs = loadgen.replay(tr, sched.submit, sched.pump)
    sched.drain()
    launches = {n: launch_counts()[n] - base[n] for n in KERNELS}
    pairs = 2 * len(PLANE_BUCKETS)
    if eng.captures != pairs or _diff(launches, {}) != warm \
            or cold_compiles(eng) != 0:
        fail(f"13(d): {eng.captures} captures ({pairs} pairs), "
             f"{cold_compiles(eng)} cold, launches {launches} after "
             f"warmup's {warm}")
    for name, k in KERNELS.items():
        # the int8 downgrade graphs gather with torch ops
        n_want = k["per_forward"] * 2 * (
            len(PLANE_BUCKETS) if name == "fused_segment_sum" else pairs)
        if launches[name] != n_want:
            fail(f"13(d): {name} launched {launches[name]} times in the "
                 f"scheduler's warmup, {n_want} expected (2 a capture, "
                 f"{pairs} captures, the int8 path's gather in torch ops)")
    s = sched.stats()
    out["sla"] = _loop_row("13(d) SLA scheduler", s, secs, PLANE_N)
    out["sla"]["answers"] = _check_open_loop("13(d) Poisson", sched,
                                             tr.requests, want, {})
    out["tightening"] = s_sync["p99_ms"] / s["p99_ms"]
    out["launches"] = launches
    print(f"  13(d) p99 tightening (sync / scheduler) "
          f"{out['tightening']:.3f} (the reference's smoke target >= 2); "
          f"answers {out['sla']['answers']}; launches {launches} (warmup's "
          f"captures; the replay ran no wrapper)")
    # a diurnal drifting-Zipf trace near capacity: downgrades absorb peaks
    peak = engine()
    psched = SlaScheduler(peak, SlaPolicy(
        sla_ms=sla_ms, downgrade_margin=0.5,
        default_service_ms=t_batch * 1e3, max_queue=4 * BUCKET),
        pipeline_depth=2)
    psched.warmup()
    kw = dict(kind="diurnal", rate_qps=DIURNAL_TROUGH * capacity,
              peak_ratio=DIURNAL_PEAK, period_s=PLANE_N / rate,
              drift_per_chunk=64)
    tr = trace(**kw)
    secs = loadgen.replay(tr, psched.submit, psched.pump)
    psched.drain()
    # its reference: the same bodies through the calibration engine's
    # graphs, full micro-batches, both paths
    ref_reqs = trace(**kw).requests
    ref, down_ref = {}, {}
    for downgraded, into in ((False, ref), (True, down_ref)):
        for lo in range(0, PLANE_N, BUCKET):
            mb = ref_reqs[lo:lo + BUCKET]
            cal.settle(cal.dispatch(mb, downgraded=downgraded))
            into.update((r.rid, r.prob) for r in mb)
    out["diurnal"] = _loop_row("13(d) diurnal", psched.stats(), secs,
                               PLANE_N)
    out["diurnal"]["offered_qps"] = tr.offered_qps
    out["diurnal"]["answers"] = _check_open_loop(
        "13(d) diurnal", psched, tr.requests, ref, down_ref)
    print(f"  13(d) diurnal: trough {DIURNAL_TROUGH} x capacity, peak ratio "
          f"{DIURNAL_PEAK}, period {PLANE_N / rate:.4f} s, trace offers "
          f"{tr.offered_qps:.0f} qps; answers {out['diurnal']['answers']}")
    return out


def plane_het(gen_seed: int = 3) -> dict:
    """13(e): dlrm_het2's mixed plan (phase 12's) under the scheduler, a
    Poisson trace at HET_PLANE_OVERLOAD x its measured capacity."""
    cfg = DLRM_HET_CONFIGS[HET_CFG]
    params = dlrm.init(torch.Generator(device="cuda").manual_seed(gen_seed),
                       cfg, device="cuda")
    mixed, counts = het_plans(cfg)
    eng = RecEngine(cfg, params, source=es.SourceSpec(tables=mixed),
                    cache_trace=counts, max_l=HET_MAX_L, max_batch=BUCKET,
                    max_wait_ms=PLANE_WAIT_MS, buckets=PLANE_BUCKETS,
                    telemetry=obs.Telemetry(), device="cuda")
    eng.enable_downgrade()
    eng.warmup()
    # capacity from full-bucket replays, which touch no counter
    # (RecEngine._serve_once)
    cal = requests_from_ragged_batch(het_batch(cfg, BUCKET, 40),
                                     cfg.n_tables)
    eng._serve_once("primary", BUCKET, cal)
    t_batch = _t_batch(lambda: eng._serve_once("primary", BUCKET, cal))
    capacity = BUCKET / t_batch
    rate = HET_PLANE_OVERLOAD * capacity
    sla_ms = 3.0 * t_batch * 1e3
    sched = SlaScheduler(eng, SlaPolicy(
        sla_ms=sla_ms, default_service_ms=t_batch * 1e3,
        max_queue=4 * BUCKET), pipeline_depth=2)
    sched.warmup()
    reqs = requests_from_ragged_batch(het_batch(cfg, HET_PLANE_N, 41),
                                      cfg.n_tables)
    tr = loadgen.OpenLoopTrace(
        kind="poisson", requests=reqs,
        arrivals_s=loadgen.poisson_arrivals(rate, HET_PLANE_N,
                                            seed=PLANE_SEED))
    secs = loadgen.replay(tr, sched.submit, sched.pump)
    sched.drain()
    down = eng.downgrade_source
    if not (isinstance(down, es.TableGroupSource) and all(
            isinstance(m, es.QuantizedArena) for m in down.members)):
        fail(f"13(e): the downgrade source is {es.describe_source(down)}")
    # answers against the eager serve step of each path, 32 at a time
    step = het_eager(cfg)
    want, down_want = {}, {}
    for lo in range(0, HET_PLANE_N, BUCKET):
        mb = reqs[lo:lo + BUCKET]
        for source, into in ((eng.source, want), (down, down_want)):
            p = step(eng, mb, BUCKET, eng.params, source).cpu().numpy()
            into.update((r.rid, float(p[i])) for i, r in enumerate(mb))
    answers = _check_open_loop("13(e) dlrm_het2", sched, reqs, want,
                               down_want)
    het_recount(eng, [r for r in reqs if not r.shed and not r.downgraded])
    s = sched.stats()
    rates = {t: round(v, 4) for t, v in s["cache_hit_rate"].items()
             if v is not None}
    print(f"  13(e) {HET_CFG} mixed plan: t_batch {t_batch * 1e3:.4f} ms "
          f"(median of {CAL_CALLS} full-bucket replays), capacity "
          f"{capacity:.0f} qps, sla_ms {sla_ms:.4f}, Poisson at "
          f"{HET_PLANE_OVERLOAD} x = {rate:.0f} qps nominal, n "
          f"{HET_PLANE_N}; answers {answers}; downgraded micro-batches "
          f"served from {es.describe_source(down)}; per-table hits and "
          f"lookups after drain() equal the numpy recount; hit rates {rates}")
    return {"t_batch_ms": t_batch * 1e3, "capacity_qps": capacity,
            "sla_ms": sla_ms, "nominal_qps": rate,
            "loop": _loop_row("13(e) dlrm_het2 scheduler", s, secs,
                              HET_PLANE_N),
            "answers": answers, "hit_rates": rates}


PLANE_KERNELS = ("fused_segment_sum", "gemm", "interaction",
                 "fused_cached_segment_sum")


def phase_plane(cfg, served, online, tiered) -> dict:
    """Phase 13: the serving plane on the card. The launch counts are
    zeroed before (a) and read after (e): every kernel of the slice's
    path must have launched."""
    params = dlrm.init(torch.Generator(device="cuda").manual_seed(5), cfg,
                       device="cuda")
    out = {}
    reset_counts()
    out["overhead"], engines = plane_overhead(cfg, params, warm_counts(cfg))
    out["versions"] = plane_versions(cfg, engines)
    out["fig5"] = plane_fig5(cfg, params, engines, served)
    with uncounted():
        out["replay_kernels"] = plane_kernels(cfg, engines)
    del engines
    out["open_loop"] = plane_open_loop(cfg, params)
    del params
    out["het"] = plane_het()
    out["launches"] = launch_counts()
    idle = [n for n in PLANE_KERNELS if not out["launches"][n]]
    if idle:
        fail(f"13: {idle} never launched on the serving plane's path "
             f"({out['launches']})")
    out["trainer_telemetry"] = online["telemetry"]
    out["store_telemetry"] = tiered["host"]["store_telemetry"]
    print(f"  13 launches {out['launches']}; 13(f) checked in phases 6 "
          f"(trainer {out['trainer_telemetry']}) and 9 (host store "
          f"{out['store_telemetry']})")
    return out


# ---------------------------------------------------------------- phase 14

FLEET_K = 512                      # hot rows a table (every table of
#                                    dlrm_het2 has at least 2,000 rows)
FLEET_MEAN_L = 38                  # dlrm_het2's lookups_per_table
FLEET_REFRESH = 4                  # train steps a version
FLEET_REPLICAS = 2
FLEET_ROUNDS = 6                   # chaos rounds before recovery
FLEET_BUMPS = 3                    # recovery within this many versions
# the reference bench's plan (bench_paper.py:1108): drops, duplicates and
# reorders on every replica
FLEET_PLAN = FaultPlan(seed=6, drop=0.3, dup=0.3, delay=0.6, max_delay=3)
FLEET_CRASH = dict(extra_steps=6, fail_after=3, ckpt_every=2)
FLEET_KERNELS = ("fused_segment_sum", "fused_cached_segment_sum", "gemm",
                 "interaction", "sls_grad_table")
GROUP_STEPS = 4                    # 14(b): group trainer steps, card vs CPU
GROUP_REFRESH = 2                  # a rebuild and a migration every 2
GROUP_HOT, GROUP_WARM = 2048, 16_384   # 14(b)'s two tiered tables
GROUP_STAGING, GROUP_STAGE = 8192, 2048


def _dir_bytes(path: pathlib.Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def fleet_checkpoint(fr) -> dict:
    """One save and one restore of the trainer's (params, optimizer
    state) through the fleet's CheckpointManager: ms (synchronized) and
    bytes on disk."""
    t = fr.trainer
    step = fr.next_step - 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = fr.ckpt.save(step, (t.params, t.opt_state))
    save_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    (params, _), _ = fr.ckpt.restore((t.params, t.opt_state), step=step)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    if not all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 tree_leaves(t.params))):
        fail("fleet: a checkpoint's restore differs from what was saved")
    src = fr.ckpt.dir / f"src_{fr.ckpt.latest_source_step()}"
    return {"save_ms": save_ms, "restore_ms": restore_ms,
            "bytes": _dir_bytes(path), "source_bytes": _dir_bytes(src)}


def fleet_rounds(fr) -> list:
    """Each round's parts in ms and its blob's bytes, read from its spans
    on the trainer's telemetry (host times: the train step ends on its
    loss and the serialize on its copy to the host, both waiting for the
    card)."""
    out = []
    for spans in fr.trainer.telemetry.tracer.traces().values():
        root = next(x for x in spans if x.name == "fleet_round")
        ms = {}
        for x in spans:
            ms.setdefault(x.name, []).append(x.duration_ms)
        out.append({**root.attrs, "train_ms": ms["fleet_train"][0],
                    "serialize_ms": ms["fleet_serialize"][0],
                    "save_source_ms": ms["fleet_save_source"][0],
                    "deliver_ms": ms["fleet_deliver"]})
    if len(out) != fr.rounds:
        fail(f"fleet: {len(out)} traced rounds, {fr.rounds} run")
    return out


def fleet_hit_dip(fr) -> float:
    """The deepest per-version hit-rate shortfall of a chaos-fed replica
    below the reference engine at the same version (the bench's
    ``hit_dip``)."""
    dip = 0.0
    for model in ("a", "b"):
        want = fr.ref[model].telemetry.events.hit_rate_by_version()
        for rep in fr.replicas:
            for v, rate in rep.hit_rate_by_version(model).items():
                if rate is not None and want.get(v) is not None:
                    dip = max(dip, want[v] - rate)
    return dip


def _recovered(rec: dict, what: str) -> None:
    exact = all(all(v) for v in rec["exact"].values())
    captures = [n for per in rec["recompiles"] for n in per.values()]
    if not exact or rec["bumps"] > FLEET_BUMPS or any(captures):
        fail(f"fleet {what}: exact {rec['exact']} after {rec['bumps']} "
             f"bumps (at most {FLEET_BUMPS}), captures since warmup "
             f"{rec['recompiles']}")


def fleet_run(cfg, ckpt_dir) -> dict:
    """14(a): the fleet, its launches counted from its construction to the
    trainer's resume."""
    reset_counts()
    t0 = time.perf_counter()
    fr = FleetRunner(cfg, n_replicas=FLEET_REPLICAS, plan=FLEET_PLAN,
                     seed=0, cache_k=FLEET_K, refresh_every=FLEET_REFRESH,
                     batch_size=BUCKET, max_l=HET_MAX_L,
                     mean_l=FLEET_MEAN_L, ckpt_dir=ckpt_dir, device="cuda")
    setup_s = time.perf_counter() - t0
    fr.trainer.telemetry.tracer.enabled = True     # the rounds' spans
    t0 = time.perf_counter()
    for _ in range(FLEET_ROUNDS):
        fr.round()
    chaos_s = time.perf_counter() - t0
    inj = [r.stale_injected for r in fr.replicas]
    rej = [r.stale_rejections() for r in fr.replicas]
    drops = [r.channel.dropped for r in fr.replicas]
    dups = [r.channel.duplicated for r in fr.replicas]
    print(f"  {FLEET_ROUNDS} chaos rounds in {chaos_s:.2f} s (set-up "
          f"{setup_s:.2f} s): stale injected {inj}, rejected {rej}, "
          f"dropped {drops}, duplicated {dups}")
    if inj != rej or not sum(inj) or not sum(drops) or not sum(dups):
        fail(f"fleet: stale injected {inj} against rejected {rej}, drops "
             f"{drops}, dups {dups}: the plan must drop, duplicate and "
             f"reorder, and every stale delivery be refused")
    dip = fleet_hit_dip(fr)
    hrv = {f"replica{i}_{m}": rep.hit_rate_by_version(m)
           for i, rep in enumerate(fr.replicas) for m in ("a", "b")}
    hrv.update({f"ref_{m}": e.telemetry.events.hit_rate_by_version()
                for m, e in fr.ref.items()})
    print(f"  hit_dip {dip:.4f}; hit_rate_by_version {hrv}")
    t0 = time.perf_counter()
    rec = fr.recover(k=FLEET_BUMPS)
    recovery_s = time.perf_counter() - t0
    _recovered(rec, "recovery")
    print(f"  recovery: {rec['bumps']} bumps in {recovery_s:.2f} s, exact "
          f"{rec['exact']}, captures since warmup {rec['recompiles']}")
    rep = fr.crash_replica(0)
    exact_now = fr.exactness()
    rec_restart = fr.recover(k=FLEET_BUMPS)
    _recovered(rec_restart, "replica restart")
    print(f"  replica 0 restarted from src_{fr.ckpt.latest_source_step()} "
          f"(version {rep.versions()}): exact at once {exact_now}, after "
          f"{rec_restart['bumps']} bumps {rec_restart['exact']}")
    start = fr.next_step
    res = fr.run_trainer_with_crash(**FLEET_CRASH)
    launches = launch_counts()
    for n in FLEET_KERNELS:
        if not launches[n]:
            fail(f"fleet: {n} never launched on the fleet's path")
    print(f"  trainer crash at step {start + FLEET_CRASH['fail_after']}, "
          f"resumed ({res['restarts']} restart, "
          f"{res['resume_events']} trainer_resume event) through step "
          f"{fr.next_step - 1} in {res['wall_s']:.2f} s, version "
          f"{res['version']}")
    with uncounted():
        ctl = OnlineGroupTrainer(
            cfg, dlrm.init(torch.Generator(device="cuda").manual_seed(0),
                           cfg, device="cuda"),
            max_l=HET_MAX_L, plans=dlrm.table_plans(cfg, cache_k=FLEET_K),
            refresh_every=FLEET_REFRESH, device="cuda")
        for step in range(fr.next_step):
            ctl.train_step(fr.batch_fn(step))
        got, want = tree_leaves(fr.trainer.params), tree_leaves(ctl.params)
        same = len(got) == len(want) and all(
            torch.equal(a, b) for a, b in zip(got, want))
        if not same:
            fail("fleet: the resumed trainer's params differ from the "
                 "uninterrupted control trainer's")
        print(f"  resumed params equal the control trainer's bit for bit "
              f"({len(got)} tensors, {fr.next_step} steps)")
        rec_crash = fr.recover(k=FLEET_BUMPS)
        _recovered(rec_crash, "after the trainer's resume")
        ckpt = fleet_checkpoint(fr)
    print(f"  checkpoint of the trainer: save {ckpt['save_ms']:.1f} ms, "
          f"restore {ckpt['restore_ms']:.1f} ms, {ckpt['bytes']} bytes; a "
          f"source artifact {ckpt['source_bytes']} bytes")
    rounds = fleet_rounds(fr)
    for t in rounds:
        print(f"  round v{t['version']} ({'chaos' if t['chaos'] else 'clean'}"
              f"): train {t['train_ms']:.1f} ms, serialize "
              f"{t['serialize_ms']:.1f} ms, blob {t['blob_bytes']} bytes, "
              f"save_source {t['save_source_ms']:.1f} ms, deliver ms a "
              f"replica {[round(x, 2) for x in t['deliver_ms']]}")
    print(f"  recovery_s {recovery_s:.3f}; launches {launches}")
    return {"stale_injected": inj, "stale_rejected": rej, "dropped": drops,
            "duplicated": dups, "hit_dip": dip, "hit_rate_by_version": hrv,
            "recovery": {"bumps": rec["bumps"], "exact": rec["exact"],
                         "recompiles": rec["recompiles"],
                         "recovery_s": recovery_s},
            "restart": {"exact_at_once": exact_now,
                        "bumps": rec_restart["bumps"],
                        "exact": rec_restart["exact"]},
            "crash": {**res, "params_equal_control": same,
                      "bumps_after": rec_crash["bumps"]},
            "checkpoint": ckpt, "rounds": rounds, "chaos_s": chaos_s,
            "setup_s": setup_s, "launches": launches}


def group_plans(cfg) -> tuple:
    """Phase 12's mixed plan with its two largest int8 tables tiered: the
    largest with a host cold tier, the next with an int4 one."""
    mixed, _ = het_plans(cfg)
    plans = list(mixed)
    big = sorted((t for t, p in enumerate(plans) if p.quantize),
                 key=lambda t: -plans[t].rows)
    for t, cold in zip(big[:2], ("host", "int4")):
        plans[t] = es.TablePlan(rows=plans[t].rows, dim=plans[t].dim,
                                tiers=st.TierPolicy(
                                    hot=GROUP_HOT, warm=GROUP_WARM,
                                    cold=cold, staging_rows=GROUP_STAGING,
                                    max_stage_per_batch=GROUP_STAGE))
    return tuple(plans)


def group_trainer(cfg) -> dict:
    """14(b): OnlineGroupTrainer with cached, int8, fp and tiered members
    on the card against the CPU path, each step from the card's params and
    optimizer state; then its group served through a graph, synced after
    every step, bit for bit against the eager step."""
    plans = group_plans(cfg)
    p0 = dlrm.init(torch.Generator(device="cuda").manual_seed(7), cfg,
                   device="cuda")
    mk = dict(max_l=HET_MAX_L, plans=plans, refresh_every=GROUP_REFRESH)
    card = OnlineGroupTrainer(cfg, _copy(p0, "cuda"), device="cuda", **mk)
    cpu = OnlineGroupTrainer(cfg, _copy(p0, "cpu"), device="cpu", **mk)
    specs = dlrm.member_specs(cfg)
    gen = make_drifting_zipf(cfg, batch_size=BUCKET, mean_l=FLEET_MEAN_L,
                             max_l=HET_MAX_L, drift_per_batch=DRIFT, seed=5)
    batches = [next(gen) for _ in range(GROUP_STEPS + 2)]
    reset_counts()
    engine = RecEngine(cfg, card.params, source=card.serving_source(),
                       max_l=HET_MAX_L, max_batch=BUCKET, buckets=(BUCKET,),
                       device="cuda")
    engine.warmup()
    warm = launch_counts()
    if not warm["fused_int4_segment_sum"]:
        fail("group trainer: the int4-tiered member's forward launched no "
             "fused_int4_segment_sum")
    step = het_eager(cfg)
    steps, step_ms = [], []
    for i, b in enumerate(batches[:GROUP_STEPS]):
        cpu.params, cpu.opt_state = (_copy(card.params, "cpu"),
                                     _copy(card.opt_state, "cpu"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = card.train_step(b)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        with uncounted():
            cpu_loss = cpu.train_step(b)
        rel = abs(loss - cpu_loss) / abs(cpu_loss)
        if rel > LOSS_RTOL or card.version != cpu.version:
            fail(f"group trainer step {i}: loss {loss} / {cpu_loss}, "
                 f"versions {card.version} / {cpu.version}")
        budget = ARENA_SAMPLES * HET_MAX_L * (i + 1)
        worst, beyond = 0.0, 0
        for t, sp in enumerate(specs):
            if not np.array_equal(card.hists[t], cpu.hists[t]):
                fail(f"group trainer step {i}: table {t}'s histogram")
            d_card, d_cpu = card._dirty_q[t], cpu._dirty_q[t]
            if d_card is not None and not torch.equal(d_card.cpu(), d_cpu):
                fail(f"group trainer step {i}: table {t}'s dirty mask")
            hot, hot_cpu = ((card.caches[t], cpu.caches[t])
                            if card.caches[t] is not None
                            else (card.tiered[t], cpu.tiered[t]))
            if hot is None:
                continue
            if not torch.equal(hot.hot_ids.cpu(), hot_cpu.hot_ids):
                fail(f"group trainer step {i}: table {t}'s hot set")
            if card.tiered[t] is not None and not torch.equal(
                    card.tiered[t].tier_slot.cpu(),
                    cpu.tiered[t].tier_slot):
                fail(f"group trainer step {i}: table {t}'s tier map")
            rows = _beyond(hot.hot_rows, hot_cpu.hot_rows, budget,
                           2 * 10 * LR * sp.dim ** 0.5 * (i + 1),
                           f"group trainer step {i} table {t} hot rows")
            worst = max(worst, rows["max_abs_err"])
            beyond += rows["beyond"]
        engine_synced = card.sync_engine(engine)
        reqs = requests_from_ragged_batch(batches[GROUP_STEPS + i % 2],
                                          cfg.n_tables)
        pipelined(engine, reqs, [BUCKET],
                  reference=lambda mb, bucket: step(
                      engine, mb, bucket, engine.params, engine.source))
        steps.append({"loss_card": loss, "loss_cpu": cpu_loss,
                      "loss_rel_err": rel, "version": card.version,
                      "hot_rows_beyond": beyond,
                      "hot_rows_max_abs_err": worst,
                      "synced": engine_synced})
        print(f"  group trainer step {i}: loss {loss:.6f} (CPU rel "
              f"{rel:.1e}), v{card.version}, hot sets and tier maps "
              f"equal, hot rows {beyond} beyond {PARAM_ATOL} (max "
              f"{worst:.1e}); served v{engine.source_version} bit for bit "
              f"against the eager step")
    if engine.captures != 1:
        fail(f"group trainer: the engine captured {engine.captures} graphs; "
             f"warmup's one must serve every sync")
    ev = [e.attrs for e in card.telemetry.events.query("tier_migration")]
    store = engine._host_stores[0].stats()
    if store["hits"] + store["misses"] != store["touches"]:
        fail(f"group trainer: host store hits + misses != touches {store}")
    launches = launch_counts()
    print(f"  card step ms {[round(x, 1) for x in step_ms]}; migrations "
          f"{len(ev)}; the engine's host store {store}; launches "
          f"(warmup and steps) {launches}")
    return {"steps": steps, "step_ms": step_ms, "launches": launches,
            "migrations": ev, "host_store": store}


def phase_fleet() -> dict:
    """Phase 14: the fleet on dlrm_het2 at full width, then the group
    trainer's tiered members against the CPU path."""
    cfg = DLRM_HET_CONFIGS[HET_CFG]
    with tempfile.TemporaryDirectory() as d:
        fleet = fleet_run(cfg, d)
    fleet["group_trainer"] = group_trainer(cfg)
    return fleet


# ---------------------------------------------------------------- phase 15

LM_BWD_S = (2048, 4096)            # 15(a): the op's backward at these S
LM_TRAIN_CPU_S = 2048              # 15(b): card against CPU, 2 layers, B 1
LM_TRAIN_RUNS = ((2048, 4, 1), (4096, 2, 2))   # 15(c): (S, batch, micro-
LM_TRAIN_STEPS = 3                 # batches); timed steps of each, then one
                                   # profiled step
LM_TRAIN_CLIP = 1.0
# 15(c) trains smollm-360m at 4 of its 32 layers (full width): whole,
# 15(c) took 137 s of "final29b"'s 878 (the 4,096 x 2 steps host-bound
# by ~120k launches a step); at 16 layers 53 s of "final30"'s 762, and
# the script grows with phases 18 and 19
LM_TRAIN_LAYERS = 4
LM_LAUNCH_S = 2048                 # 15(d): the launcher's sequences, batch 1
LM_LAUNCH_STEPS = 3
# 15(b): card against the CPU path, one train step of 2 layers at full
# width. The bar is phase 10(c)'s: the card within LM_FLOOR_FACTOR x the
# CPU bf16 path's own error against an fp32 CPU step from the same
# weights. For the loss (a mean over tokens) that error is the mean
# |bf16 - fp32| next-token loss over the batch's tokens, which bounds the
# error of the mean of any path as accurate; for the grad norm it is the
# norm of the (unclipped) gradient's difference, which bounds the
# difference of the norms. Gradients and updates per leaf by their
# largest element. AdamW's first step moves a param by ~lr * sign(g):
# an element whose gradient is within rounding of zero may step the other
# way on either bf16 path, so a leaf's update floor is at least 2 lr
# (1 + wd |p|) (phase 4's rule; |p| < 1 here).
LM_LR = 3e-4                       # default_optimizer's AdamW


def flash_backward_bound(b, s, h, kh, d, causal, window):
    """The backward's least time: q, k, v and the output's gradient read,
    dq, dk and dv written (bf16), and five products of 2 d flops a (q, k)
    pair of the band a head (S recomputed, dP, dV, dQ, dK), as a flash
    backward does them, on the bf16 tensor cores."""
    n_bytes = 2 * b * s * d * (2 * h + 2 * kh) * 2
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (10 * d * attention_pairs(s, causal, window) * h * b
             / BF16_FLOPS_PER_S * 1e3)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


LM_BWD_SHAPES = tuple(("smollm-360m", 1, s, 15, 5, 64, True, None)
                      for s in LM_BWD_S)


def check_flash_backward(gen, shapes=LM_BWD_SHAPES, trials: int = 5) -> tuple:
    """15(a), 19(a): the op's backward (the recompute through the chunked
    path) at each of ``shapes`` ((what, B, S, H, KH, hd, causal,
    window), phase 10's form): equal bit for bit to autograd through
    ``layers._sdpa_chunked`` at the op's chunks on the same inputs and
    upstream gradient, two backward passes equal, the forward within
    phase 10's tolerance of the plain version; times of the backward, of
    the op's forward + backward, and of F.scaled_dot_product_attention's
    forward + backward (a yardstick the port never calls, on kv heads
    repeated before the timing; with a window shorter than S it takes an
    explicit band mask)."""
    name = "flash_attention"
    errs, rows = [], []
    for what, b, s, h, kh, d, causal, window in shapes:
        q = torch.randn((b, s, h, d), generator=gen,
                        device="cuda").bfloat16().requires_grad_()
        k, v = (torch.randn((b, s, kh, d), generator=gen,
                            device="cuda").bfloat16().requires_grad_()
                for _ in range(2))
        g = torch.randn((b, s, h, d), generator=gen, device="cuda").bfloat16()
        blk = 512 if any(s % c == 0 for c in range(64, 513)) else s

        def op():
            return ops.flash_attention_gqa(q, k, v, causal=causal,
                                           window=window)
        with uncounted():
            out = op()
            errs.append(compare(name, out.detach(), ref.flash_attention_gqa(
                q.detach(), k.detach(), v.detach(), causal=causal,
                window=window, bq=blk, bk=blk),
                f"forward before backward, {what}, S = {s}"))
            got = torch.autograd.grad(out, (q, k, v), g, retain_graph=True)
            again = torch.autograd.grad(op(), (q, k, v), g)
        pos = torch.arange(s, device="cuda")
        chunked = lm_layers._sdpa_chunked(
            q.reshape(b, s, kh, h // kh, d), k, v, pos, pos, causal, window,
            lm_layers.pick_chunk(s, lm_layers.Q_CHUNK),
            lm_layers.pick_chunk(s, lm_layers.KV_CHUNK))
        want = torch.autograd.grad(chunked.reshape(b, s, h, d), (q, k, v), g)
        torch.cuda.synchronize()
        for which, x, y, z in zip("qkv", got, again, want):
            if not torch.equal(x, z):
                fail(f"{name} backward {what}, S = {s}: d{which} differs "
                     f"from autograd through _sdpa_chunked by "
                     f"{float((x.float() - z.float()).abs().max())}")
            if not torch.equal(x, y):
                fail(f"{name} backward {what}, S = {s}: two backward passes "
                     f"differ in d{which}")
        del got, again, want, chunked
        qt = q.detach().transpose(1, 2).requires_grad_()
        kt, vt = (t.detach().transpose(1, 2).repeat_interleave(h // kh, 1)
                  .requires_grad_() for t in (k, v))
        gt = g.transpose(1, 2)
        mask = None
        if causal and window is not None and s > window:
            mask = ((pos[None, :] <= pos[:, None])
                    & (pos[None, :] > pos[:, None] - window))

        def backward():
            return torch.autograd.grad(out, (q, k, v), g, retain_graph=True)

        def forward_backward():
            return torch.autograd.grad(op(), (q, k, v), g)

        def library():
            return torch.autograd.grad(F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=causal and mask is None), (qt, kt, vt), gt)

        with uncounted():
            bound_ms, by = flash_backward_bound(b, s, h, kh, d, causal,
                                                window)
            fwd_ms, _ = flash_bound(b, s, h, kh, d, causal, window)
            row = {"what": what, "shape": [b, s, h, kh, d], "causal": causal,
                   "window": window,
                   "ms": time_ms(backward, reps=2, trials=trials),
                   "device_ms": device_ms(backward, reps=2),
                   "forward_backward_ms": time_ms(forward_backward, reps=2,
                                                  trials=trials),
                   "forward_backward_device_ms": device_ms(forward_backward,
                                                           reps=2),
                   "library_ms": time_ms(library, reps=10, trials=10),
                   "library_device_ms": device_ms(library, reps=10),
                   "bound_ms": bound_ms, "bound_by": by,
                   "forward_backward_bound_ms": bound_ms + fwd_ms,
                   "bit_equal_to_chunked_autograd": True,
                   "deterministic": True}
        rows.append(row)
        print(f"  {name} backward (recompute) {what}, S = {s}, "
              f"{b}x{s}x{h}/{kh}x{d}: {row['ms']:.3f} ms "
              f"({_fmt(row['device_ms'])} device); forward + backward "
              f"{row['forward_backward_ms']:.3f} "
              f"({_fmt(row['forward_backward_device_ms'])}); library "
              f"forward + backward {row['library_ms']:.3f} "
              f"({_fmt(row['library_device_ms'])}); bound {bound_ms:.5f} "
              f"({by}), forward + backward {row['forward_backward_bound_ms']:.5f}"
              f"; equal to autograd through _sdpa_chunked, two passes equal")
        del out, q, k, v, qt, kt, vt
    return max(errs), rows


def _token_nll(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token loss a position, (B, S - 1), fp32."""
    lg = logits[:, :-1].float()
    m = lg.amax(-1, keepdim=True)
    logz = m[..., 0] + torch.log(torch.exp(lg - m).sum(-1))
    return logz - torch.gather(lg, -1, tokens[:, 1:].long()[..., None])[..., 0]


def _spied_step(cfg):
    """make_train_step with the default optimizer, whose update records
    the (clipped) gradients it is handed."""
    name, opt = lm_api.default_optimizer(cfg)
    seen = {}

    def update(grads, state, params):
        seen["grads"] = tree_map(lambda t: t.detach().clone(), grads)
        return opt.update(grads, state, params)
    _, opt2, step = lm_api.make_train_step(
        cfg, optimizer=(name, Optimizer(opt.init, update)),
        grad_clip=LM_TRAIN_CLIP)
    return opt2, step, seen


def _one_step(cfg, params, batch) -> dict:
    """One train step from ``params`` (copied first): loss, grad norm, the
    clipped gradients, the unclipped ones (divided by the clip's scale)
    and each leaf's update, all fp32 on the CPU."""
    before = tree_map(lambda t: t.detach().float().cpu(), params)
    opt, step, seen = _spied_step(cfg)
    p = tree_map(lambda t: t.detach().clone(), params)
    p, _, m = step(p, opt.init(p), batch)
    gn = float(m["grad_norm"])
    scale = min(1.0, LM_TRAIN_CLIP / (gn + 1e-9))
    clipped = tree_map(lambda t: t.float().cpu(), seen["grads"])
    return {"loss": float(m["loss"]), "grad_norm": gn, "grads": clipped,
            "raw": tree_map(lambda t: t / scale, clipped),
            "update": tree_map(lambda a, b_: a.float().cpu() - b_, p, before)}


def lm_train_card_vs_cpu(cfg, target: dict, key: str):
    """15(b): smollm-360m at full width, 2 layers, one train step from one
    set of params on one LMSynthetic batch at S = LM_TRAIN_CPU_S, on the
    card and on the CPU path (bf16 and fp32) from copies of the card's
    params; loss, grad norm, each leaf's clipped gradient and update. The
    card's step runs here; returns the function that hands the CPU
    passes to the CPU reference worker (main calls it after phase 16, so
    that they run beside 17 to 19, not beside 16's host-bound gloo
    ranks); the check is made when they are done (``settle``), its
    record then in ``target[key]``."""
    shallow = cfg.replace(n_layers=LM_CPU_LAYERS)
    params = lm_api.init(torch.Generator(device="cuda").manual_seed(15),
                         shallow, device="cuda")
    toks = torch.from_numpy(LMSynthetic(shallow, seed=15).batch(
        1, LM_TRAIN_CPU_S)["tokens"])
    with uncounted():
        card = _one_step(shallow, params, {"tokens": toks.cuda()})
    cpu16 = tree_map(lambda t: t.detach().cpu(), params)
    del params

    def cpu_pass():
        t0 = time.perf_counter()
        cpu32 = tree_map(lambda t: t.float(), cpu16)
        f32 = shallow.replace(dtype="float32")
        nll16 = _token_nll(lm_api.forward(cpu16, shallow,
                                          {"tokens": toks})[0], toks)
        nll32 = _token_nll(lm_api.forward(cpu32, f32,
                                          {"tokens": toks})[0], toks)
        return {"nll16": nll16, "nll32": nll32,
                "c16": _one_step(shallow, cpu16, {"tokens": toks}),
                "c32": _one_step(f32, cpu32, {"tokens": toks}),
                "cpu_s": time.perf_counter() - t0}

    def finish(r):
        c16, c32 = r["c16"], r["c32"]
        out = {"cpu_s": r["cpu_s"], "steps": {}}
        checks = [("loss", abs(card["loss"] - c32["loss"]),
                   float((r["nll16"] - r["nll32"]).abs().mean())),
                  ("grad_norm", abs(card["grad_norm"] - c32["grad_norm"]),
                   diff_norm(c16["raw"], c32["raw"]))]
        for what in ("grads", "update"):
            for (path, a), (_, b16), (_, b32) in zip(
                    tree_paths(card[what]), tree_paths(c16[what]),
                    tree_paths(c32[what])):
                floor = float((b16 - b32).abs().max())
                if what == "update":
                    floor = max(floor, 2 * LM_LR * 1.01)
                checks.append((f"{what} {path}",
                               float((a - b32).abs().max()), floor))
        worst = 0.0
        for what, err, floor in checks:
            bound = LM_FLOOR_FACTOR * floor
            out["steps"][what] = {"err": err, "floor": floor,
                                  "bound": bound}
            worst = max(worst, err / bound if bound else float("inf"))
            if err > bound:
                fail(f"lm train step, card against CPU: {what} {err} from "
                     f"the fp32 step, bound {bound} (floor {floor})")
        for k in ("loss", "grad_norm"):
            out[k] = {"card": card[k], "cpu_bf16": c16[k],
                      "cpu_fp32": c32[k]}
        out["worst_err_over_bound"] = worst
        print(f"  {LM_CPU_LAYERS} layers, S = {LM_TRAIN_CPU_S}: loss card "
              f"{card['loss']:.6f} / CPU bf16 {c16['loss']:.6f} / fp32 "
              f"{c32['loss']:.6f} (|card - fp32| {checks[0][1]:.3e}, bound "
              f"{LM_FLOOR_FACTOR * checks[0][2]:.3e}); grad norm "
              f"{card['grad_norm']:.5f} / {c16['grad_norm']:.5f} / "
              f"{c32['grad_norm']:.5f} (|card - fp32| {checks[1][1]:.3e}, "
              f"bound {LM_FLOOR_FACTOR * checks[1][2]:.3e}); "
              f"{len(checks) - 2} leaf gradients and updates each within "
              f"{LM_FLOOR_FACTOR}x the CPU bf16 step's error (worst error / "
              f"bound {worst:.3f}); {r['cpu_s']:.1f} s on the CPU worker")
        for what in ("grads", "update"):
            for path, rec in out["steps"].items():
                if path.startswith(what):
                    print(f"    {path:40s} err {rec['err']:.3e} floor "
                          f"{rec['floor']:.3e}")
        return out

    def diff_norm(a, b_):
        return float(torch.sqrt(sum(((x - y) ** 2).sum() for x, y in zip(
            tree_leaves(a), tree_leaves(b_)))))

    def hand_in():
        Pending(f"15(b) {cfg.name}: one train step, card against the CPU "
                "path", target, key, cpu_pass, finish)
    return hand_in


# the kernels a profiled step's trace opens with, under their own span:
# the profiler can lose a trace's first records ("p19a": 2 flash
# kernels traced as 1), and
# these are the ones to lose
LEAD_IN_SPAN = "trace_lead_in"
LEAD_IN_KERNELS = 256


def _lead_in() -> None:
    with torch.profiler.record_function(LEAD_IN_SPAN):
        x = torch.empty(256, device="cuda")
        for i in range(LEAD_IN_KERNELS):
            x.fill_(i)
    torch.cuda.synchronize()


def _train_groups(prof, spans=(), group=_lm_group) -> tuple:
    """(device ms by group, kernels) of a profiled train step: the flash
    kernel, the backward's recompute (every kernel launched under
    ``ops.RECOMPUTE_SPAN``), each of ``spans`` (the kernels launched
    under that profiler span), then by ``group``'s name: matmul, copies,
    other. The device's own records give each kernel name's time; the
    kernels linked to host ops split it among the groups in proportion
    (a trace can link one launch to more than one op: "p19c" summed
    1,100 linked ms in a 588 ms step); a name that no op links is
    "unlinked". The lead-in's kernels (``_lead_in``) are left out."""
    names = (ops.RECOMPUTE_SPAN, LEAD_IN_SPAN) + tuple(spans)
    inside, linked = {}, {}

    def span_of(e):
        """The outermost of ``names`` that ``e`` runs under, or None."""
        if id(e) not in inside:
            p = e.cpu_parent
            up = None if p is None else span_of(p)
            inside[id(e)] = up or (e.name if e.name in names else None)
        return inside[id(e)]
    events = prof.events()
    lead = 0
    for e in events:
        for k in e.kernels:
            sp = span_of(e)
            g = ("recompute" if sp == ops.RECOMPUTE_SPAN
                 else sp or group(k.name))
            by = linked.setdefault(k.name, {})
            by[g] = by.get(g, 0.0) + k.duration / 1e3
            lead += g == LEAD_IN_SPAN
    device, n = {}, 0
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not e.is_user_annotation and e.name not in names:
            device[e.name] = device.get(e.name, 0.0) \
                + e.device_time_total / 1e3
            n += group(e.name) != "copies"
    groups = {}
    for name, ms in device.items():
        parts = linked.get(name) or {"unlinked": 1.0}
        total = sum(parts.values())
        for g, v in parts.items():
            groups[g] = groups.get(g, 0.0) + ms * v / total
    groups.pop(LEAD_IN_SPAN, None)
    return groups, n - lead


def _top_kernels(prof, n: int = 6) -> list:
    """The ``n`` kernel names of most device time in a trace of the card
    (its device-side records), with their ms."""
    by = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not e.is_user_annotation:
            by[e.name] = by.get(e.name, 0.0) + e.device_time_total / 1e3
    return [[k[:90], v] for k, v in
            sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _flash_kernels(prof) -> int:
    """The flash kernel's records in a trace of the card."""
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "flash_attention_kernel" in e.name)


def lm_train_run(cfg, params, opt_state, s: int, b: int, mb: int,
                 seed: int, attn_layers=None, spans=(), group=_lm_group,
                 steps: int = LM_TRAIN_STEPS, takes: int = 1,
                 warm: int = 0) -> tuple:
    """``steps`` timed steps and one profiled step of ``b`` x ``s``
    tokens in ``mb`` micro-batches through a Prefetcher of LMSynthetic
    batches placed on the card, cfg's default optimizer, clip 1.0: the
    flash wrapper's launches a step (2 x ``attn_layers``, the layers that
    attend through it, a micro-batch under remat, nothing else of the
    port), the loss finite, step ms (CUDA events), tokens/s, peak memory,
    kernels and device ms by group a step (profiler; ``spans`` and
    ``group`` as ``_train_groups`` takes them), the idle share. With
    ``takes`` > 1 the profiled step is taken again, up to ``takes``
    times, until the trace holds as many flash kernels as the counter
    counted (the profiler can lose a trace's records). Step ms is the
    median of the timed steps after the first ``warm`` (which grow the
    allocator's pool)."""
    _, _, step = lm_api.make_train_step(cfg, grad_clip=LM_TRAIN_CLIP,
                                        microbatches=mb)
    data = LMSynthetic(cfg, seed=seed)
    pf = Prefetcher((data.batch(b, s) for _ in range(steps + takes)),
                    place=make_placer("cuda"))
    want = 2 * (cfg.n_layers if attn_layers is None else attn_layers) * mb
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses, norms, traced = [], [], [], []
    prof = None
    for i, batch in enumerate(pf):
        before = launch_counts()
        profiled = i >= steps
        if profiled:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with prof if profiled else contextlib.nullcontext():
            if profiled:
                _lead_in()
            start.record()
            params, opt_state, m = step(params, opt_state, batch)
            end.record()
            end.synchronize()
        if not profiled:
            times.append(start.elapsed_time(end))
        else:
            profiled_ms = start.elapsed_time(end)
        after = launch_counts()
        delta = {n: after[n] - before[n] for n in after}
        if delta["flash_attention"] != want or any(
                c for n, c in delta.items() if n != "flash_attention"):
            fail(f"{cfg.name} train S = {s} x {b}, {mb} micro-batches, step "
                 f"{i}: launches {delta}, expected flash_attention x {want} "
                 "only")
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if not np.isfinite(losses[-1]) or not np.isfinite(norms[-1]):
            fail(f"{cfg.name} train S = {s}: step {i} loss {losses[-1]}, "
                 f"grad norm {norms[-1]}")
        if profiled:
            traced.append(_flash_kernels(prof))
            if takes > 1 and traced[-1] == want:
                break
    pf.close()
    if takes > 1 and traced[-1] != want:
        fail(f"{cfg.name} train: the profiled steps' traces hold {traced} "
             f"flash kernels, the counter {want} a step")
    peak = torch.cuda.max_memory_allocated()
    groups, kernels = _train_groups(prof, spans, group)
    top = _top_kernels(prof)
    busy = sum(groups.values()) or None
    ms = float(np.median(times[warm:]))
    out = {"seq_len": s, "batch": b, "microbatches": mb,
           "step_ms": ms, "steps_ms": times, "tokens_per_s": b * s / ms * 1e3,
           "peak_memory_bytes": peak, "launches_per_step": want,
           "traced_flash_kernels": traced, "profiled_step_ms": profiled_ms,
           "top_kernels_ms": top,
           "kernels_per_step": kernels, "device_ms": groups,
           "device_busy_ms": busy,
           "device_idle_share": None if busy is None else 1.0 - busy / ms,
           "recompute_share_of_busy": (
               None if busy is None else groups.get("recompute", 0.0) / busy),
           "losses": losses, "grad_norms": norms}
    print(f"  train S = {s} x batch {b}, {mb} micro-batch(es): step "
          f"{ms:.1f} ms (steps {[round(t, 1) for t in times]}), "
          f"{out['tokens_per_s']:.0f} tokens/s, peak memory "
          f"{peak / 2 ** 30:.2f} GiB, flash_attention x {want} a step "
          f"(traced {traced}), {kernels} kernels in the profiled step; "
          f"device {_fmt(busy)} ms "
          f"{ {k: round(v, 2) for k, v in groups.items()} }, "
          f"idle share {out['device_idle_share']}, recompute share "
          f"{out['recompute_share_of_busy']} of device time; losses "
          f"{[round(x, 4) for x in losses]}, grad norms "
          f"{[round(x, 4) for x in norms]}; the profiled step "
          f"{profiled_ms:.1f} ms")
    for kname, t in top:
        print(f"    {t:9.3f} ms  {kname}")
    return out, params, opt_state


def remat_off_pass(cfg, params, batch: dict, attn_layers: int) -> tuple:
    """A gradient pass with remat off over ``batch`` (numpy, placed as the
    train step's Prefetcher places it): (loss, the train step's grad
    norm: the same leaves summed in the same order, the flash launches:
    ``attn_layers``, one a layer that attends through it)."""
    batch = make_placer("cuda")(batch)
    reset_counts()
    leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss_nr = lm_api.loss(leaves, cfg, batch, remat=False)
    it = iter(torch.autograd.grad(loss_nr, tree_leaves(leaves)))
    loss_nr = loss_nr.detach()
    norm_nr = global_norm(tree_map(lambda _: next(it), leaves))
    del leaves, it
    torch.cuda.synchronize()
    n_nr = launch_counts()["flash_attention"]
    if n_nr != attn_layers:
        fail(f"{cfg.name} gradient pass with remat off: {n_nr} flash "
             f"launches, expected {attn_layers}")
    return loss_nr, norm_nr, n_nr


def lm_train_main(cfg) -> dict:
    """15(c): smollm-360m at full width (LM_TRAIN_LAYERS deep), layerwise
    AdamW, grad clip 1.0. First
    a gradient pass with remat off (n_layers launches) against the first
    train step's loss on the same batch (the same bits); then the runs of
    LM_TRAIN_RUNS through a Prefetcher, every param moved."""
    params = lm_api.init(torch.Generator(device="cuda").manual_seed(16),
                         cfg, device="cuda")
    s0, b0, _ = LM_TRAIN_RUNS[0]
    loss_nr, norm_nr, n_nr = remat_off_pass(
        cfg, params, LMSynthetic(cfg, seed=s0).batch(b0, s0), cfg.n_layers)
    start = {p: t.clone() for p, t in tree_paths(params)}
    opt_state = lm_api.default_optimizer(cfg)[1].init(params)
    reset_counts()
    runs = []
    for s, b, mb in LM_TRAIN_RUNS:
        run, params, opt_state = lm_train_run(cfg, params, opt_state, s, b,
                                              mb, seed=s)
        runs.append(run)
    launches = launch_counts()
    first = (runs[0]["losses"][0], runs[0]["grad_norms"][0])
    if first != (float(loss_nr), float(norm_nr)):
        fail(f"lm train: the remat step's loss and grad norm {first} differ "
             f"from the remat-off pass's {float(loss_nr)!r}, "
             f"{float(norm_nr)!r} on the same batch")
    moved = [p for p, t in tree_paths(params) if not torch.equal(t, start[p])]
    if len(moved) != len(start):
        fail(f"lm train: params that did not move: "
             f"{sorted(set(start) - set(moved))}")
    print(f"  remat off: flash_attention x {n_nr}, loss {float(loss_nr)!r} "
          f"and grad norm {float(norm_nr)!r} equal to the remat step's bit "
          f"for bit; all {len(moved)} param leaves moved; launches "
          f"{launches}")
    return {"runs": runs, "launches": launches,
            "remat_off": {"launches": n_nr, "loss": float(loss_nr),
                          "grad_norm": float(norm_nr)}}


def at_depth(cfg, layers: int):
    """``cfg`` cut to ``layers`` layers (each stack's, for an
    encoder-decoder)."""
    if cfg.is_encdec:
        return cfg.replace(n_layers=2 * layers, enc_layers=layers,
                           dec_layers=layers)
    return cfg.replace(n_layers=layers)


def lm_launcher(arch: str = LM_ARCH, n: int = LM_LAUNCH_STEPS,
                layers=None) -> dict:
    """15(d), 19(d): the training launcher at full width, ``n`` steps
    uninterrupted against a run of all but the last step that saves a
    checkpoint after the step before, and a ``--resume`` run of the last:
    the same final params and optimizer state, bit for bit. With
    ``layers``, the registry hands the launcher ``arch`` at that depth
    (``at_depth``)."""
    def make(inner):
        return lambda a: at_depth(inner(a), layers) if a == arch \
            else inner(a)
    with (patched(registry, "get_arch", make) if layers is not None
          else contextlib.nullcontext()):
        return _lm_launcher(arch, n)


def _lm_launcher(arch: str, n: int) -> dict:
    base = ["--arch", arch, "--seq-len", str(LM_LAUNCH_S),
            "--batch-size", "1", "--log-every", "1"]
    reset_counts()
    t0 = time.perf_counter()
    loss, want = train_launcher.train_lm(train_launcher.parse_args(
        base + ["--steps", str(n)]))
    plain_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        ck = ["--ckpt-dir", d, "--ckpt-every", str(n - 1)]
        t0 = time.perf_counter()
        train_launcher.train_lm(train_launcher.parse_args(
            base + ck + ["--steps", str(n - 1)]))
        saved_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loss2, got = train_launcher.train_lm(train_launcher.parse_args(
            base + ck + ["--steps", str(n), "--resume"]))
        resumed_s = time.perf_counter() - t0
    launches = launch_counts()
    # 2n steps of one micro-batch, each 2 launches an attention layer
    # under remat
    n_attn = attention_launches(registry.get_arch(arch), LM_LAUNCH_S)
    if launches["flash_attention"] != 2 * n * 2 * n_attn or any(
            c for k, c in launches.items() if k != "flash_attention"):
        fail(f"{arch} launcher: launches {launches}, expected "
             f"flash_attention x {2 * n * 2 * n_attn} only")
    same = [torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
            for a, b in zip(tree_leaves(got), tree_leaves(want))]
    if loss2 != loss or not all(same):
        fail(f"{arch} launcher: the resumed run's loss {loss2!r} against "
             f"{loss!r}, {same.count(False)} of {len(same)} leaves differ")
    depth = registry.get_arch(arch).n_layers
    print(f"  launcher {' '.join(base)} ({depth} layers): {n} steps in "
          f"{plain_s:.1f} s; "
          f"{n - 1} steps and a checkpoint in {saved_s:.1f} s; resumed for "
          f"the last in {resumed_s:.1f} s: loss {loss2:.4f} and all "
          f"{len(same)} param and optimizer-state leaves equal to the "
          f"uninterrupted run's bit for bit; launches {launches}")
    return {"layers": depth, "loss": loss, "plain_s": plain_s,
            "saved_s": saved_s,
            "resumed_s": resumed_s, "leaves_equal": len(same),
            "launches": launches}


def phase_lm_train(gen) -> tuple:
    clock = [time.perf_counter()]

    def took(part: str) -> float:
        now = time.perf_counter()
        s, clock[0] = now - clock[0], now
        print(f"   (15({part}) took {s:.1f} s)")
        return s

    err, rows = check_flash_backward(gen)
    seconds = {"a": took("a")}
    cfg = registry.get_arch(LM_ARCH)
    out = {"seconds": seconds}
    # 15(b)'s CPU passes go to the CPU reference worker (handed in by
    # main); its check is made at the end of 19, and its record lands in
    # out["card_vs_cpu"]
    hand_in = lm_train_card_vs_cpu(cfg, out, "card_vs_cpu")
    seconds["b"] = took("b")
    out.update(lm_train_main(cfg.replace(n_layers=LM_TRAIN_LAYERS)))
    seconds["c"] = took("c")
    out["launcher"] = lm_launcher()
    seconds["d"] = took("d")
    return {"max_abs_err": err, "recompute_rows": rows}, out, hand_in


# ---------------------------------------------------------------- main

# ---------------------------------------------------------------- phase 16

SHARD_COUNTS = (2, 4)              # gloo ranks sharing the one card
SHARD_CACHE_K = 2048               # the reference bench's sharded_cached K
SHARD_STEPS = 4                    # sharded sparse steps against replicated
SHARD_TIMEOUT_S = 300              # a start's process group and join limit
SHARD_KERNELS = ("fused_segment_sum", "embedding_bag", "sls_grad_table",
                 "gemm", "interaction")


def _rank_params(cfg, shards: int, rank: int) -> tuple:
    """Phase 3's params (the same seeded draw) with the arena as rank
    ``rank``'s block of it padded for ``shards`` ranks (the padding rows
    zero, as ``dlrm.init(..., shards)`` makes them), and the whole
    arena."""
    params = dlrm.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                       device="cuda")
    full = params["arena"]
    vlocal = dlrm.arena_spec(cfg).padded_rows(shards) // shards
    params["arena"] = se.shard_block(full, rank, shards, vlocal)
    return params, full


def _mlp_flat(params) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for k in ("bottom", "top")
                      for t in tree_leaves(params[k])])


def check_sharded_kernels(cfg, params, gen) -> dict:
    """16(a): the path's kernels at a rank's shapes, against their plain
    versions: ``fused_segment_sum`` and ``embedding_bag`` over the first
    and the last rank's block at 2 and 4 ranks (the last holds the null
    row and the padding), every id the rank does not own on the zero
    sentinel; the sharded step's row gradients (the replicated step's
    ``sls_grad_table`` call, then ``shard_local_rows``); ``gemm`` and the
    interaction stage at the head's batch-32 shapes."""
    spec = dlrm.arena_spec(cfg)
    errs = {n: 0.0 for n in SHARD_KERNELS}
    dense = serving_dense_ids(cfg, BUCKET, seed=11)
    fixed = fixed_ids(cfg, BUCKET, seed=21)
    rows = []
    for n in SHARD_COUNTS:
        vlocal = spec.padded_rows(n) // n
        for r in (0, n - 1):
            block = se.shard_block(params["arena"], r, n, vlocal)
            for name, ids in (("fused_segment_sum", dense),
                              ("embedding_bag", fixed)):
                local = se.shard_local_ids(ids, r * vlocal, vlocal,
                                           spec.null_row)
                what = f"{n} ranks, rank {r}, {tuple(local.shape)}"
                if name == "fused_segment_sum":
                    got = fd_k.fused_segment_sum(block, local)
                    want = ref.fused_segment_sum(block, local)
                else:
                    got = eg_k.embedding_bag(block, local)
                    want = ref.embedding_bag(block, local)
                errs[name] = max(errs[name], compare(name, got, want, what))
                if name == "fused_segment_sum":
                    if not torch.equal(got, in_order(block, local)):
                        fail(f"{name} {what}: differs from the in-order loop")
                else:
                    _same_as_fused(name, got, block, local, what)
                on_sentinel = float((local == vlocal).float().mean())
                print(f"  {name:24s} {what:34s} {on_sentinel:.3f} of ids on "
                      f"the sentinel")
            local = se.shard_local_ids(dense, r * vlocal, vlocal,
                                       spec.null_row)
            touched = torch.unique(local).numel()
            d = block.shape[1]
            b_ms, by = bound(4 * (local.numel() + touched * d
                                  + local.shape[0] * d), local.numel() * d)
            rows.append({"ranks": n, "rank": r, "block_rows": block.shape[0],
                         "shape": list(local.shape),
                         "ms": time_ms(lambda: fd_k.fused_segment_sum(
                             block, local)),
                         "plain_ms": time_ms(lambda: ref.fused_segment_sum(
                             block, local)),
                         "bound_ms": b_ms, "bound_by": by})
    # the row gradients: every rank computes the replicated step's, and
    # keeps the rows it owns
    b = train_batches(cfg, 1, seed=31)[0]
    idx, off = (torch.from_numpy(b[k]) for k in ("indices", "offsets"))
    d_bags = torch.randn((off.shape[0] - 1, spec.dim), generator=gen,
                         device="cuda")
    r_rows, r_g = so.source_row_grads(spec, d_bags, idx.cuda(), off.cuda())
    c_rows, c_g = so.source_row_grads(spec, d_bags.cpu(), idx, off)
    torch.cuda.synchronize()
    if not (torch.equal(r_rows.cpu(), c_rows) and torch.equal(r_g.cpu(),
                                                              c_g)):
        fail("sls_grad_table: the sharded step's row gradients differ from "
             "the plain version on the CPU")
    print(f"  {'sls_grad_table':24s} {'row gradients ' + str(tuple(r_g.shape)):34s}"
          f" equal to the CPU plain version (torch.equal)")
    for n in SHARD_COUNTS:
        vlocal = spec.padded_rows(n) // n
        owned = 0
        for r in range(n):
            lrows, lg = so.shard_local_rows(r_rows, r_g, lo=r * vlocal,
                                            vlocal=vlocal,
                                            null_row=spec.null_row)
            owned += int((lg.abs().sum(dim=1) > 0).sum())
        want = int((r_g.abs().sum(dim=1) > 0).sum())
        if owned != want:
            fail(f"shard_local_rows at {n} ranks: {owned} owned rows with a "
                 f"gradient, {want} in all")
    # the head at batch 32
    for w, _ in params["bottom"] + params["top"]:
        h = torch.randn((BUCKET, w.shape[0]), generator=gen, device="cuda")
        errs["gemm"] = max(errs["gemm"], compare(
            "gemm", gm_k.gemm(h, w), ref.gemm(h, w),
            f"head {tuple(h.shape)} x {tuple(w.shape)}"))
    bot = torch.randn((BUCKET, spec.dim), generator=gen, device="cuda")
    emb = torch.randn((BUCKET, cfg.n_tables, spec.dim), generator=gen,
                      device="cuda")
    errs["interaction"] = compare(
        "interaction", fi_k.feature_interaction(bot, emb)[0],
        ref.feature_interaction(bot, emb)[0],
        f"stage {tuple(emb.shape)}")
    for row in rows:
        print(f"  fused_segment_sum over rank {row['rank']} of "
              f"{row['ranks']}'s block ({row['block_rows']} rows): "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.5f} ({row['bound_by']})")
    return {"max_abs_err": errs, "rows": rows}


def _shard_serve(cfg, params, mesh, counts) -> dict:
    """16(b), one rank: the phase 3 requests through the sharded, the
    cached-over-sharded and (their bags) the fixed plan, and the fixed
    requests' bags through the sharded ragged plan. Every rank serves the
    same micro-batches, in the same order."""
    out = {}
    for name, batch, plan in (
            ("sharded", served_batch(cfg), dict(source="sharded")),
            ("cached", served_batch(cfg),
             dict(source="cached", cache_k=SHARD_CACHE_K, cache_trace=counts)),
            ("fixed", fixed_batch(cfg, N_REQUESTS // 4, seed=23),
             dict(source="fixed")),
            ("fixed_bags_ragged", fixed_batch(cfg, N_REQUESTS // 4, seed=23),
             dict(source="sharded"))):
        eng = RecEngine(cfg, params, max_l=MAX_L, max_batch=BUCKET,
                        mesh=mesh, device="cuda", **plan)
        eng.warmup()
        reqs = _requests(batch, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs = _served(eng, reqs)
        secs = time.perf_counter() - t0
        st = eng.stats()
        out[name] = {"probs": probs,
                     "ms_per_micro_batch": secs * 1e3 / (len(reqs) // BUCKET),
                     "captures": eng.captures,
                     "cold_dispatches": cold_compiles(eng),
                     "graphed": st["graphed"], "why": st["why"],
                     "source": st["source"],
                     "hit_rate": st["cache_hit_rate"]}
    return out


def _shard_pipelines(cfg, params, mesh) -> dict:
    """16(b), one rank: both pipelined forms (N_MICRO micro-batches, the
    lookups and their all-reduces on the side stream) over the mesh at
    bucket 32, against the single-shot sharded forwards on the same
    inputs; returns each form's largest difference."""
    fb = DLRMSynthetic(cfg, seed=41).batch(BUCKET)
    rb = poisson_batch(cfg, BUCKET, 41)
    f = {k: torch.from_numpy(fb[k]).cuda() for k in ("dense", "indices")}
    r = {k: torch.from_numpy(rb[k]).cuda()
         for k in ("dense", "indices", "offsets")}
    out = {}
    with torch.inference_mode():
        for kind, single, piped in (
                ("fixed",
                 lambda: dlrm.forward(params, cfg, f["dense"], f["indices"],
                                      mesh),
                 lambda: hybrid.pipelined_forward(
                     params, cfg, f["dense"], f["indices"], N_MICRO, mesh)),
                ("ragged",
                 lambda: dlrm.forward_ragged(params, cfg, r["dense"],
                                             r["indices"], r["offsets"],
                                             max_l=MAX_L, mesh=mesh),
                 lambda: hybrid.pipelined_forward_ragged(
                     params, cfg, r["dense"], r["indices"], r["offsets"],
                     max_l=MAX_L, n_micro=N_MICRO, mesh=mesh))):
            want = single()
            got = piped()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            if not torch.isfinite(got).all() or err > PIPE_ATOL:
                fail(f"16(b) pipelined {kind} on {mesh.size('model')} ranks:"
                     f" {err} from the single-shot sharded forward")
            out[kind] = {"logits": got, "err_vs_single": err}
    return out


def _shard_train(cfg, params, full, mesh, batches, budget) -> tuple:
    """16(c), one rank: SHARD_STEPS sharded sparse steps; rank 0 holds the
    replicated sparse step, on the card, from the same state before each
    (the touched rows, accumulator rows and MLP state copied over), under
    phase 4's laws. Returns the sharded state and the record."""
    spec = dlrm.arena_spec(cfg)
    r = mesh.rank("model")
    opt, step = dlrm.make_train_step_ragged(cfg, max_l=MAX_L, mesh=mesh)
    state = opt.init(params)
    if r == 0:
        r_opt, r_step = dlrm.make_train_step_ragged(cfg, max_l=MAX_L)
        rp = {"arena": full}
        rs = {"arena": r_opt.init(rp)["arena"]}
    rec = {"losses": [], "step_ms": [], "mlp": [], "cmp": []}
    for i, b in enumerate(batches):
        tb = {k: torch.from_numpy(b[k]).cuda() for k in TRAIN_KEYS}
        if r == 0:
            for k in ("bottom", "top"):
                rp[k] = _copy(params[k], "cuda")
            rs["mlp"] = _copy(state["mlp"], "cuda")
            rs["arena"]["step"] = state["arena"]["step"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss, rows = step(params, state, tb)
        loss = float(loss)
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["losses"].append(loss)
        rec["mlp"].append(_mlp_flat(params).cpu().numpy())
        touched = rows[rows != spec.null_row].long()
        got_rows = collectives.gather_rows(params["arena"], touched, mesh)
        got_acc = collectives.gather_rows(state["arena"]["acc"], touched,
                                          mesh)
        if params["arena"][-1].any() or state["arena"]["acc"][-1].any():
            fail(f"sharded step {i}: rank {r}'s sentinel moved")
        if r != 0:
            continue
        with uncounted():
            rp, rs, r_loss, r_rows = r_step(rp, rs, tb)
        r_loss = float(r_loss)
        rel = abs(loss - r_loss) / abs(r_loss)
        if not torch.equal(rows, r_rows):
            fail(f"sharded step {i}: touched rows differ from the "
                 f"replicated step's")
        if rel > LOSS_RTOL:
            fail(f"sharded step {i}: loss {loss}, replicated {r_loss}")
        mlp = _beyond(_mlp_flat(params), _mlp_flat(rp).cpu(),
                      int(MLP_SHARE * _mlp_flat(rp).numel()), budget,
                      f"sharded step {i} MLP")
        arena = _beyond(got_rows, rp["arena"][touched].cpu(),
                        ARENA_SAMPLES * cfg.n_tables * MAX_L,
                        2 * 10 * LR * spec.dim ** 0.5,
                        f"sharded step {i} arena rows")
        if rp["arena"][spec.null_row].any():
            fail(f"sharded step {i}: the null row moved")
        # the replicated state follows the sharded one into the next step
        rp["arena"][touched] = got_rows
        rs["arena"]["acc"][touched] = got_acc
        rec["cmp"].append({"loss_rel_err": rel, "mlp": mlp, "arena": arena})
        print(f"  {mesh.size('model')} ranks, step {i}: loss {loss:.6f} "
              f"(replicated rel {rel:.1e}); touched rows equal; MLP "
              f"{mlp['beyond']} of {mlp['of']} beyond {PARAM_ATOL}, touched "
              f"arena rows {arena['beyond']} of {arena['of']} (max "
              f"{arena['max_abs_err']:.1e}); {rec['step_ms'][-1]:.2f} ms")
    return params, state, opt, step, rec


def _probe_rows(cfg, batch) -> torch.Tensor:
    """The arena rows a batch touches (the rows a restore is checked on)."""
    spec = dlrm.arena_spec(cfg)
    flat = se.flatten_ragged_indices(spec, torch.from_numpy(batch["indices"]),
                                     torch.from_numpy(batch["offsets"]))
    return torch.unique(flat[flat != spec.null_row]).long().cuda()


def _shard_rank(mesh, save_dir, restore_dir) -> dict:
    """One gloo rank of phase 16 on the shared card: (b) and (c) with the
    launch counts zeroed before and read after; then (d): with
    ``save_dir`` the state after (c) is saved and one more step taken,
    with ``restore_dir`` the 4-rank checkpoint is restored onto this mesh
    and that step taken from it."""
    cfg = DLRM_CONFIGS["dlrm1"]
    n, r = mesh.size("model"), mesh.rank("model")
    params, full = _rank_params(cfg, n, r)
    if r != 0:
        del full
        full = None
    p_max = max(w.abs().max().item() for w in tree_leaves(
        {k: params[k] for k in ("bottom", "top")}))
    budget = 2 * LR * (1.01 + 0.01 * p_max)
    batches = train_batches(cfg, SHARD_STEPS + 1, seed=41)
    reset_counts()
    served = _shard_serve(cfg, params, mesh, warm_counts(cfg))
    piped = _shard_pipelines(cfg, params, mesh)
    params, state, opt, step, trained = _shard_train(
        cfg, params, full, mesh, batches[:SHARD_STEPS], budget)
    out = {"serve": served, "pipelined": piped, "train": trained,
           "launches": launch_counts(),
           "block_bytes": params["arena"].numel() * 4,
           "acc_bytes": state["arena"]["acc"].numel() * 4,
           "allreduce_bytes": BUCKET * cfg.n_tables * cfg.emb_dim * 4}
    probe = _probe_rows(cfg, batches[SHARD_STEPS - 1])
    tree = (params, state)
    if save_dir is not None:
        t0 = time.perf_counter()
        CheckpointManager(save_dir, device="cuda").save(
            SHARD_STEPS - 1, tree, shardings=row_shardings(tree, mesh))
        out["save_s"] = time.perf_counter() - t0
    if restore_dir is not None:
        t0 = time.perf_counter()
        tree, _ = CheckpointManager(restore_dir, device="cuda").restore(
            tree, shardings=row_shardings(tree, mesh))
        out["restore_s"] = time.perf_counter() - t0
        params, state = tree
    out["probe"] = collectives.gather_rows(params["arena"], probe, mesh)
    out["probe_acc"] = collectives.gather_rows(state["arena"]["acc"], probe,
                                               mesh)
    if save_dir is not None or restore_dir is not None:
        with uncounted():
            params, state, loss, rows = step(params, state, {
                k: torch.from_numpy(batches[SHARD_STEPS][k]).cuda()
                for k in TRAIN_KEYS})
        touched = rows[rows != dlrm.arena_spec(cfg).null_row].long()
        out["next"] = {"loss": float(loss), "rows": rows,
                       "mlp": _mlp_flat(params),
                       "arena": collectives.gather_rows(params["arena"],
                                                        touched, mesh),
                       "budget": budget}
    return out


def _nccl_rank(mesh) -> dict:
    """16(h): one rank over nccl (the one NCCL run one card allows): the
    communicator's all-reduce and broadcast on a card tensor, a served
    batch through a ``ShardedArena`` of one shard and the step on a mesh
    of one, each exact against the replicated path. At one rank the
    port's collectives (``psum``, ``pmean_``, ``gather_rows``) return
    without a call, so this exercises the communicator, not them: they
    reach NCCL only across cards."""
    cfg = DLRM_CONFIGS["dlrm1"]
    if mesh.backend != "nccl":
        fail(f"16(h) runs over {mesh.backend}, not nccl")
    x = torch.arange(8.0, device="cuda")
    torch.distributed.all_reduce(x)
    torch.distributed.broadcast(x, 0)
    if not torch.equal(x, torch.arange(8.0, device="cuda")):
        fail("nccl all_reduce/broadcast over one rank changed a tensor")
    params = dlrm.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                       device="cuda")
    reqs = _requests(served_batch(cfg), cfg)[:4 * BUCKET]
    probs = {}
    for name, src in (("sharded", es.ShardedArena(es.FpArena(
            params["arena"]), mesh)), ("replicated", "ragged")):
        eng = RecEngine(cfg, params, source=src, max_l=MAX_L,
                        max_batch=BUCKET, device="cuda")
        probs[name] = _served(eng, [dataclasses.replace(q) for q in reqs])
    if not np.array_equal(probs["sharded"], probs["replicated"]):
        fail("16(h): the one-shard source served other bits")
    b = train_batches(cfg, 1, seed=43)[0]
    tb = {k: torch.from_numpy(b[k]).cuda() for k in TRAIN_KEYS}
    losses = {}
    for name, kw in (("sharded", dict(mesh=mesh, sharded=True)),
                     ("replicated", {})):
        p = _copy(params, "cuda")
        opt, step = dlrm.make_train_step_ragged(cfg, max_l=MAX_L, **kw)
        p, _, loss, _ = step(p, opt.init(p), tb)
        losses[name] = (float(loss), _mlp_flat(p), p["arena"])
    if losses["sharded"][0] != losses["replicated"][0] or not (
            torch.equal(losses["sharded"][1], losses["replicated"][1])
            and torch.equal(losses["sharded"][2], losses["replicated"][2])):
        fail("16(h): the step on a mesh of one differs from the replicated")
    return {"loss": losses["sharded"][0], "served": len(reqs)}


# 16(e), (f): the (data, model) mesh, 4 gloo ranks sharing the card
MESH2D = (2, 2)
MESH2D_AXES = ("data", "model")
MESH2D_STEPS = 3                   # dense-gradient and sparse steps each
MESH2D_JOIN_S = 600                # a start: (e), (f), (i); or a (j) model
# after 3 steps, the reference's bound (tests/test_sharded_sparse.py
# :100-115), under phase 4's sign-flip budget
MESH2D_STEP_ATOL = 1e-4
MOE_ARCH = "kimi-k2-1t-a32b"
MOE_EXPERTS = 128                  # of 384: 19(c)'s cut (moe_fit)
MOE_TOKENS = (2, 2048)             # (B, S): 1,024 tokens a rank
MOE_NODROP_CF = 4.0                # the reference test's: nothing drops
MOE_BF16_TOL = 2e-2                # of the reference's largest |y|
MOE_AUX_RTOL = 1e-3                # cf 1.25 against the emulation's mean
MOE_SEED = 7


def moe_layer() -> tuple:
    """(MoEConfig cut to MOE_EXPERTS experts, d_model) of MOE_ARCH."""
    cfg = registry.get_arch(MOE_ARCH)
    return dataclasses.replace(cfg.moe, n_experts=MOE_EXPERTS), cfg.d_model


def moe_weight(name: str, mcfg, d: int) -> torch.Tensor:
    """One leaf of the MoE layer, drawn on the card from its own seed (the
    same bits in every process), at ``init_moe``'s scale (fan_in =
    shape[0]): the router fp32, the experts bf16."""
    e, ff = mcfg.n_experts, mcfg.expert_ff
    shape, dtype = {"wr": ((d, e), torch.float32),
                    "wg": ((e, d, ff), torch.bfloat16),
                    "wu": ((e, d, ff), torch.bfloat16),
                    "wd": ((e, ff, d), torch.bfloat16)}[name]
    gen = torch.Generator(device="cuda").manual_seed(
        MOE_SEED + ("wr", "wg", "wu", "wd").index(name))
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=dtype).mul_(shape[0] ** -0.5)


def moe_tokens(d: int) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(MOE_SEED + 10)
    return torch.randn(MOE_TOKENS + (d,), generator=gen, device="cuda",
                       dtype=torch.bfloat16)


def _moe_block(x: torch.Tensor, d_rank: int, m_rank: int) -> torch.Tensor:
    """Rank (d_rank, m_rank)'s (B/2, S/2) block of the tokens."""
    b, s = MOE_TOKENS[0] // MESH2D[0], MOE_TOKENS[1] // MESH2D[1]
    return x[d_rank * b:(d_rank + 1) * b, m_rank * s:(m_rank + 1) * s]


def moe_references(path: pathlib.Path) -> dict:
    """16(f)'s one-rank references on the card, saved to ``path`` for the
    ranks, then freed: ``apply_moe`` on all 4,096 tokens at cf 4 (its
    routes and drops recorded), and the per-shard capacity at cf 1.25
    emulated in one process: ``_moe_local`` over each rank's block of
    tokens (capacity from its 1,024), its routes recorded."""
    mcfg, d = moe_layer()
    t0 = time.perf_counter()
    p = {k: moe_weight(k, mcfg, d) for k in ("wr", "wg", "wu", "wd")}
    x = moe_tokens(d)
    nodrop = dataclasses.replace(mcfg, capacity_factor=MOE_NODROP_CF)
    out = {"blocks": {}}
    with torch.inference_mode():
        with recorded_routes() as seen:
            y, aux = lm_moe.apply_moe(p, nodrop, x)
        out.update(y_nodrop=y.cpu(), aux_nodrop=float(aux),
                   idx_nodrop=seen[0][2],
                   drops_nodrop=int(dropped(seen).sum()))
        y125 = torch.empty_like(x)
        auxes = []
        for dr in range(MESH2D[0]):
            for mr in range(MESH2D[1]):
                xb = _moe_block(x, dr, mr)
                with recorded_routes() as seen:
                    yb, ab = lm_moe._moe_local(xb.reshape(-1, d), p, mcfg)
                _moe_block(y125, dr, mr).copy_(yb.view(xb.shape))
                auxes.append(float(ab))
                out["blocks"][(dr, mr)] = {
                    "idx": seen[0][2], "drops": int(dropped(seen).sum())}
        out.update(y_125=y125.cpu(), aux_125=float(np.mean(auxes)))
    torch.cuda.synchronize()
    out["s"] = time.perf_counter() - t0
    torch.save(out, path)
    del p, x, y, y125
    _free()
    if out["drops_nodrop"]:
        fail(f"16(f): {out['drops_nodrop']} tokens dropped at cf "
             f"{MOE_NODROP_CF} on one rank")
    return {k: v for k, v in out.items()
            if k not in ("y_nodrop", "y_125", "idx_nodrop", "blocks")}


def _digest(t) -> str:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()


def _moe_rank(mesh, path: str) -> dict:
    """16(f), one rank: its blocks of the expert weights (drawn whole a
    leaf at a time, sharded, the whole freed), the expert-parallel layer
    at cf 4 and at cf 1.25 with the routes pinned to the references'."""
    mcfg, d = moe_layer()
    ref_ = torch.load(path, weights_only=False)
    dr, mr = mesh.rank("data"), mesh.rank("model")
    p = {"wr": moe_weight("wr", mcfg, d)}
    for k in ("wg", "wu", "wd"):
        full = moe_weight(k, mcfg, d)
        p.update(lm_moe.shard_moe_params({k: full}, mcfg, mesh))
        del full
    torch.cuda.empty_cache()
    shapes = {k: tuple(p[k].shape) for k in ("wg", "wu", "wd")}
    x = moe_tokens(d)
    b_loc, s_loc = MOE_TOKENS[0] // MESH2D[0], MOE_TOKENS[1] // MESH2D[1]
    rows = ((dr * b_loc + torch.arange(b_loc))[:, None] * MOE_TOKENS[1]
            + mr * s_loc + torch.arange(s_loc)[None, :]).reshape(-1)
    out = {"shapes": shapes}
    with torch.inference_mode():
        for name, mc, pin, want, aux_want in (
                ("nodrop",
                 dataclasses.replace(mcfg, capacity_factor=MOE_NODROP_CF),
                 ref_["idx_nodrop"][rows], ref_["y_nodrop"],
                 ref_["aux_nodrop"]),
                ("cf125", mcfg, ref_["blocks"][(dr, mr)]["idx"],
                 ref_["y_125"], ref_["aux_125"])):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with pinned_routes([(None, None, pin)]) as own, \
                    recorded_routes() as seen:
                y, aux = lm_moe.apply_moe(p, mc, x, mesh)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if tuple(y.shape) != MOE_TOKENS + (d,) \
                    or not torch.isfinite(y).all():
                fail(f"16(f) {name}: output {tuple(y.shape)}, finite "
                     f"{bool(torch.isfinite(y).all())}")
            err = (y.float().cpu() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            out[name] = {"max_abs_err": err, "ref_max_abs": scale,
                         "aux": float(aux), "aux_ref": aux_want,
                         "drops": int(dropped(seen).sum()),
                         "own_route_flips": int(own[0].sum()),
                         "s": secs, "digest": _digest(y)}
            if err > MOE_BF16_TOL * scale:
                fail(f"16(f) {name} on rank ({dr}, {mr}): {err} from the "
                     f"one-rank reference (bound {MOE_BF16_TOL} x {scale})")
    if out["nodrop"]["drops"]:
        fail(f"16(f): {out['nodrop']['drops']} tokens dropped at cf "
             f"{MOE_NODROP_CF} on rank ({dr}, {mr})")
    if out["cf125"]["drops"] != ref_["blocks"][(dr, mr)]["drops"]:
        fail(f"16(f) cf 1.25: {out['cf125']['drops']} drops on rank "
             f"({dr}, {mr}), the emulation "
             f"{ref_['blocks'][(dr, mr)]['drops']}")
    del p
    _free()
    return out


def mesh2d_references(cfg, path: pathlib.Path) -> None:
    """16(e)'s one-rank references on the card, saved for the ranks: from
    phase 3's params, MESH2D_STEPS dense-gradient fixed-L steps and as
    many sparse ragged steps, each step's loss, MLP, and touched rows'
    arena values and accumulators."""
    spec = dlrm.arena_spec(cfg)
    out = {}
    fixed = [DLRMSynthetic(cfg, seed=53).batch(BUCKET)
             for _ in range(MESH2D_STEPS)]
    ragged = train_batches(cfg, MESH2D_STEPS, seed=57)
    with uncounted():
        for kind, batches in (("dense", fixed), ("sparse", ragged)):
            params = dlrm.init(torch.Generator(device="cuda").manual_seed(0),
                               cfg, device="cuda")
            if kind == "dense":
                opt, step = dlrm.make_train_step(cfg)
            else:
                opt, step = dlrm.make_train_step_ragged(cfg, max_l=MAX_L)
            state = opt.init(params)
            recs = []
            for b in batches:
                keys = FIXED_KEYS if kind == "dense" else TRAIN_KEYS
                tb = {k: torch.from_numpy(b[k]).cuda() for k in keys}
                res = step(params, state, tb)
                params, state, loss = res[:3]
                if kind == "dense":
                    rows = torch.unique(se.flatten_indices(spec,
                                                           tb["indices"]))
                else:
                    rows = res[3][res[3] != spec.null_row]
                rows = rows.long()
                recs.append({"loss": float(loss), "rows": rows.cpu(),
                             "mlp": _mlp_flat(params).cpu(),
                             "arena": params["arena"][rows].cpu(),
                             "acc": state["arena"]["acc"][rows].cpu()})
            out[kind] = {"batches": batches, "steps": recs}
            del params, state
    torch.save(out, path)
    _free()


def _mesh2d_dlrm(mesh, path: str, fp_probs) -> dict:
    """16(e), one rank: the plans served on the mesh, then the dense and
    sparse steps against the one-rank references."""
    cfg = DLRM_CONFIGS["dlrm1"]
    spec = dlrm.arena_spec(cfg)
    n, r = mesh.size("model"), mesh.rank("model")
    ref_ = torch.load(path, weights_only=False)
    params, full = _rank_params(cfg, n, r)
    del full
    p_max = max(w.abs().max().item() for w in tree_leaves(
        {k: params[k] for k in ("bottom", "top")}))
    out = {"serve": {}, "block_bytes": params["arena"].numel() * 4}
    served = served_batch(cfg)
    fixed = fixed_batch(cfg, N_REQUESTS // 4, seed=23)
    counts = warm_counts(cfg)
    for name, batch, plan in (
            ("ragged", served, dict(source="ragged")),
            ("sharded", served, dict(source="sharded")),
            ("cached", served, dict(source="cached", cache_k=SHARD_CACHE_K,
                                    cache_trace=counts)),
            ("fixed", fixed, dict(source="fixed")),
            ("fixed_bags_ragged", fixed, dict(source="sharded"))):
        eng = RecEngine(cfg, params, max_l=MAX_L, max_batch=BUCKET,
                        mesh=mesh, device="cuda", **plan)
        reqs = _requests(batch, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs = _served(eng, reqs)
        secs = time.perf_counter() - t0
        if not np.isfinite(probs).all():
            fail(f"16(e) {name}: probabilities not finite")
        out["serve"][name] = {
            "probs": probs, "graphed": eng.stats()["graphed"],
            "ms_per_micro_batch": secs * 1e3 / (len(reqs) // BUCKET)}
    for name in ("ragged", "sharded", "cached"):
        err = float(np.abs(out["serve"][name]["probs"] - fp_probs).max())
        out["serve"][name]["err_vs_phase3"] = err
        if err > PROB_ATOL:
            fail(f"16(e) {name}: {err} from phase 3's fp probabilities")
    err = float(np.abs(out["serve"]["fixed"]["probs"]
                       - out["serve"]["fixed_bags_ragged"]["probs"]).max())
    out["serve"]["fixed"]["err_vs_fixed_bags_ragged"] = err
    if err > PROB_ATOL:
        fail(f"16(e) fixed: {err} from the sharded ragged plan")
    base = _rank_params(cfg, n, r)[0]
    for kind in ("dense", "sparse"):
        params = _copy(base, "cuda")
        if kind == "dense":
            opt, step = dlrm.make_train_step(cfg, mesh=mesh)
        else:
            opt, step = dlrm.make_train_step_ragged(cfg, max_l=MAX_L,
                                                    mesh=mesh)
        state = opt.init(params)
        recs = []
        for i, (b, want) in enumerate(zip(ref_[kind]["batches"],
                                          ref_[kind]["steps"])):
            keys = FIXED_KEYS if kind == "dense" else TRAIN_KEYS
            tb = {k: torch.from_numpy(b[k]).cuda() for k in keys}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = step(params, state, tb)
            params, state, loss = res[:3]
            loss = float(loss)
            ms = (time.perf_counter() - t0) * 1e3
            rows = want["rows"].cuda()
            got_rows = collectives.gather_rows(params["arena"], rows, mesh)
            got_acc = collectives.gather_rows(state["arena"]["acc"], rows,
                                              mesh)
            mlp = _mlp_flat(params)
            what = f"16(e) {kind} step {i}"
            rel = abs(loss - want["loss"]) / abs(want["loss"])
            if rel > (LOSS_RTOL if i == 0 else MESH2D_STEP_ATOL):
                fail(f"{what}: loss {loss}, one rank {want['loss']}")
            if kind == "sparse" and not torch.equal(
                    res[3][res[3] != spec.null_row].cpu(), want["rows"]):
                fail(f"{what}: touched rows differ from the one-rank step's")
            steps = i + 1
            m = _beyond(mlp, want["mlp"], int(MLP_SHARE * mlp.numel()),
                        steps * 2 * LR * (1.01 + 0.01 * p_max),
                        f"{what} MLP", atol=MESH2D_STEP_ATOL)
            a = _beyond(got_rows, want["arena"],
                        ARENA_SAMPLES * cfg.n_tables * MAX_L,
                        steps * 2 * 10 * LR * spec.dim ** 0.5,
                        f"{what} arena rows", atol=MESH2D_STEP_ATOL)
            acc_rel = ((got_acc.cpu() - want["acc"]).abs()
                       / want["acc"].abs().clamp_min(1e-30)).max().item()
            # the first step starts from equal params: the accumulators
            # are each row's mean squared gradient over the whole batch,
            # which a block gradient not summed over 'data' is not
            if i == 0 and acc_rel > MESH2D_STEP_ATOL:
                fail(f"{what}: accumulators {acc_rel} (relative) from the "
                     f"one-rank step's")
            if params["arena"][-1].any() or state["arena"]["acc"][-1].any():
                fail(f"{what}: rank ({mesh.rank('data')}, {r})'s sentinel "
                     f"moved")
            recs.append({"loss": loss, "loss_rel_err": rel, "ms": ms,
                         "mlp": m, "arena": a, "acc_rel_err": acc_rel,
                         "digest": _digest(mlp) + _digest(got_rows)})
        out[kind] = recs
    return out


# 16(i): the LM's logical axes on the (2, 2) mesh, in 16(e)'s ranks:
# qwen1.5-4b at full width (20/20 heads of 128, 10 a rank) and smollm-360m
# (15/5 heads of 64: 9/6 query heads on 3/2 kv heads), each at 2 layers,
# one sequence of 2,048 tokens a data rank
LM_MESH_ARCHS = (("qwen1.5-4b", 2, 4), ("smollm-360m", 1, 0))  # steps, decodes
LM_MESH_LAYERS = 2
LM_MESH_S = 2048
LM_MESH_B = 2
LM_MESH_MAX_LEN = LM_MESH_S + 8
LM_MESH_SEED = 11
LM_MESH_LR = 3e-4                  # the default layerwise(adamw)'s
LM_MESH_B1 = 0.9                   # and its first moment's decay
LM_MESH_STEP_MAX = 1.01            # |m_hat / sqrt(v_hat)| over 2 steps
# the models whose (2, 2) state is saved and restored on (1, 4): qwen's
# 11.3 GB, and smollm's uneven 9/6 query heads, 6/3/3/3 there
LM_MESH_CKPT = ("qwen1.5-4b", "smollm-360m")
# the mesh path against the one-rank path on the card, both through the
# kernels: tests/test_torch_lm_mesh.py's tolerances (its docstring). bf16
# partial sums of the row-parallel products round before they are added,
# so the loss moves by ~1e-5 of itself; the params the test's rule
# (``_lm_mesh_leaf_check``)
LM_MESH_LOSS_RTOL = 1e-4
LM_MESH_UPDATE_RTOL = 0.75
LM_MESH_GNORM_RTOL = (2e-3, 1e-2)  # the first step, the steps after it
LM_MESH_LOGIT_TOL = {"rtol": 2e-2, "atol": 5e-2}
# the flash kernel at the ranks' heads, S 2,048, one sequence (the whole
# models' 20/20 x 128 and 15/5 x 64 are phase 10's rows)
LM_MESH_FLASH_SHAPES = (
    ("qwen1.5-4b, a rank", 1, LM_MESH_S, 10, 10, 128, True, None),
    ("smollm-360m, rank 0", 1, LM_MESH_S, 9, 3, 64, True, None),
    ("smollm-360m, rank 1", 1, LM_MESH_S, 6, 2, 64, True, None),
)


def lm_mesh_cfg(arch: str):
    return at_depth(registry.get_arch(arch), LM_MESH_LAYERS)


def lm_mesh_params(cfg) -> dict:
    """The whole params on the card, from LM_MESH_SEED (the same bits in
    every process)."""
    return lm_api.init(torch.Generator(device="cuda").manual_seed(
        LM_MESH_SEED), cfg, device="cuda")


def lm_mesh_inputs(cfg, steps: int, decodes: int) -> dict:
    rng = np.random.RandomState(LM_MESH_SEED)

    def toks(*shape):
        return rng.randint(0, cfg.vocab_size, shape).astype(np.int32)
    return {"prompt": toks(LM_MESH_B, LM_MESH_S),
            "decode": [toks(LM_MESH_B) for _ in range(decodes)],
            "train": [toks(LM_MESH_B, LM_MESH_S) for _ in range(steps)]}


def lm_mesh_references(tmp: pathlib.Path) -> dict:
    """16(i)'s one-rank path on the card (its kernels uncounted): each
    model's prefill logits, decode logits and train steps (loss, grad
    norm), the params and each step's gradient (from AdamW's first
    moments, fp32) saved whole for the ranks after each step (with
    each leaf's scale), then freed; and the flash kernel at the ranks'
    local head counts held against its plain version and timed
    (``check_flash``)."""
    t0 = time.perf_counter()
    out = {}
    with uncounted():
        for arch, steps, decodes in LM_MESH_ARCHS:
            cfg = lm_mesh_cfg(arch)
            params = lm_mesh_params(cfg)
            inp = lm_mesh_inputs(cfg, steps, decodes)
            rec = {"inputs": inp, "decode": [], "loss": [], "gnorm": [],
                   "scales": []}
            logits, cache = lm_api.prefill(
                params, cfg, {"tokens": torch.from_numpy(inp["prompt"])
                              .cuda()}, LM_MESH_MAX_LEN)
            rec["prefill"] = logits.cpu()
            for i, t in enumerate(inp["decode"]):
                logits, cache = lm_api.decode_step(
                    params, cfg, cache, torch.from_numpy(t).cuda(),
                    LM_MESH_S + i)
                rec["decode"].append(logits.cpu())
            del cache, logits
            _, opt, step = lm_api.make_train_step(cfg)
            state = opt.init(params)
            prev_m = tree_map(torch.zeros_like, state["m"])
            for s, toks in enumerate(inp["train"]):
                params, state, m = step(params, state, {
                    "tokens": torch.from_numpy(toks).cuda()})
                rec["loss"].append(float(m["loss"]))
                rec["gnorm"].append(float(m["grad_norm"]))
                rec["scales"].append({p: float(x.abs().max().float())
                                      for p, x in tree_paths(params)})
                torch.save(tree_map(lambda t: t.cpu(), params),
                           tmp / f"lm_mesh_{arch}_p{s + 1}.pt")
                torch.save(tree_map(lambda a, b: _step_grad(a, b).cpu(),
                                    state["m"], prev_m),
                           tmp / f"lm_mesh_{arch}_g{s + 1}.pt")
                prev_m = tree_map(torch.clone, state["m"])
            del prev_m
            out[arch] = rec
            del params, state
            _free()
        flash_err, flash = check_flash(
            torch.Generator(device="cuda").manual_seed(LM_MESH_SEED),
            LM_MESH_FLASH_SHAPES, timed=len(LM_MESH_FLASH_SHAPES))
    torch.save(out, tmp / "lm_mesh_ref.pt")
    return {"s": time.perf_counter() - t0, "flash": flash,
            "flash_max_abs_err": flash_err,
            **{a: {k: r[k] for k in ("loss", "gnorm")}
               for a, r in out.items()}}


def _step_grad(m, prev_m):
    """A step's gradient from AdamW's first moments after it and before
    it (m = b1 m_prev + (1 - b1) g)."""
    return (m - LM_MESH_B1 * prev_m) / (1 - LM_MESH_B1)


def _lm_mesh_leaf_check(what: str, mine: tuple, want: tuple, scale: float,
                        noise: dict) -> dict:
    """A rank's block after a step against the one-rank path's:
    ``mine`` and ``want`` are (the block before the step, after it, the
    step's gradient), ``noise`` carries an element's gradient noise
    across the steps. ``tests/test_torch_lm_mesh.py``'s rule: 2 bf16
    ulps of the leaf's scale plus 2 LM_MESH_STEP_MAX lr min(r, 1) a
    step (a step's |m_hat / sqrt(v_hat)| at most LM_MESH_STEP_MAX), where
    r is the largest relative gap between the two sides' gradients of
    the element up to that step; and the step's update, as a vector, within
    LM_MESH_UPDATE_RTOL of the one-rank path's (relative L2). The noise
    is kept in fp16 (r <= 1 and its sum over the steps, to 2^-11 of
    themselves), a rank's block of qwen1.5-4b being 0.47 B elements."""
    (p0, p1, ga), (w0, w1, gb) = mine, want
    if not p1.numel():
        return {"share": 0.0, "update": 0.0}
    r = torch.where(ga == gb, 0.0, (ga - gb).abs() / gb.abs()).clamp_(
        max=1.0).half()
    noise["r"] = torch.maximum(noise["r"], r) if "r" in noise else r
    noise["sum"] = noise["sum"] + noise["r"] if "sum" in noise \
        else noise["r"].clone()
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7) if scale > 0 else 0.0
    tol = noise["sum"].float() * (2 * LM_MESH_STEP_MAX * LM_MESH_LR) \
        + 2 * ulp
    err = (p1.float() - w1.float()).abs()
    share = float((err / tol).max())
    if share > 1:
        fail(f"16(i) {what}: {float(err.max())} from the one-rank step, "
             f"{share:.2f} of the bound at its worst element")
    dw = w1.float() - w0.float()
    upd = float((p1.float() - p0.float() - dw).norm()
                / dw.norm().clamp_min(1e-30))
    if upd > LM_MESH_UPDATE_RTOL:
        fail(f"16(i) {what}: the step's update {upd:.3f} (relative) from "
             f"the one-rank step's")
    return {"share": share, "update": upd}


def _sub_block(block, mesh_a, mesh_b, spec_a, spec_b, shape):
    """The part of this rank's block under (mesh_a, spec_a) that is the
    block of (mesh_b, spec_b) at mesh_b's coordinates, where the latter
    lies inside the former (a finer split of the same dimensions)."""
    out = block
    for dim, (ea, eb) in enumerate(zip(spec_a, spec_b)):
        ca = sharding._cuts(mesh_a, ea, shape[dim], shape)
        cb = sharding._cuts(mesh_b, eb, shape[dim], shape)
        oa, sa = ca[sharding._index(mesh_a, ea)] if ca else (0, shape[dim])
        ob, sb = cb[sharding._index(mesh_b, eb)] if cb else (0, shape[dim])
        if not (oa <= ob and ob + sb <= oa + sa):
            fail(f"16(i): block {ob}+{sb} of dimension {dim} outside "
                 f"{oa}+{sa}")
        out = out.narrow(dim, ob - oa, sb)
    return out


def _by_path(tree, path: str = "") -> dict:
    """{keystr path: leaf} of a tree of dicts whose leaves may be tuples
    (specs, shapes), in ``tree_paths``' naming."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_by_path(tree[k], f"{path}[{k!r}]"))
        return out
    return {path: tree}


def _lm_mesh_restore(cfg, mesh, state, ckpt: pathlib.Path) -> dict:
    """The (2, 2) state restored onto (1, 4) at coordinate (0, 2 m + d):
    each leaf's block the part of this rank's (2, 2) block, bit for
    bit."""
    d, m = mesh.rank("data"), mesh.rank("model")
    fine = Mesh((("data", None, 0, 1), ("model", None, 2 * m + d, 4)))
    name, opt, _ = lm_api.make_train_step(cfg)
    _, _, specs = lm_api.train_state_specs(cfg, name, opt, mesh)
    p14, s14, _ = lm_api.train_state_specs(cfg, name, opt, fine)
    spec = _by_path(specs)
    shape = _by_path(tree_map(lambda leaf: leaf.shape, lm_transformer._build(
        lm_params.SpecRecorder(torch.bfloat16), cfg)))
    params, st = state

    def part(path, block):
        return _sub_block(block, mesh, fine,
                          sharding.resolve(mesh, spec[path]),
                          sharding.resolve(fine, spec[path]), shape[path])

    def like(tree, dtype=None):
        flat = dict(tree_paths(tree))

        def build(t, path=""):
            if isinstance(t, dict):
                return {k: build(t[k], f"{path}[{k!r}]") for k in t}
            b = part(path, flat[path])
            return torch.empty(b.shape, dtype=dtype or b.dtype,
                               device="cuda")
        return build(tree)
    template = (like(params), {"m": like(st["m"]), "v": like(st["v"]),
                               "step": 0})
    t0 = time.perf_counter()
    (rp, rs), _ = CheckpointManager(ckpt, device="cuda").restore(
        template, shardings=(p14, s14))
    secs = time.perf_counter() - t0
    leaves = 0
    for mine, back in ((params, rp), (st["m"], rs["m"]),
                       (st["v"], rs["v"])):
        got = dict(tree_paths(back))
        for path, block in tree_paths(mine):
            if not torch.equal(part(path, block), got[path]):
                fail(f"16(i): {path} restored on (1, 4) at (0, {2 * m + d})"
                     f" is not the saved block")
            leaves += 1
    if rs["step"] != st["step"]:
        fail(f"16(i): restored step {rs['step']}, saved {st['step']}")
    return {"restore_s": secs, "leaves": leaves, "at": (0, 2 * m + d)}


def _lm_mesh_rank(mesh, tmp: pathlib.Path) -> dict:
    """16(i), one rank: each model's prefill, decode and train steps on
    the mesh against the one-rank references; qwen's state saved and
    restored onto (1, 4)."""
    ref_ = torch.load(tmp / "lm_mesh_ref.pt", weights_only=False)
    d = mesh.rank("data")
    b = LM_MESH_B // mesh.size("data")
    rows = slice(d * b, (d + 1) * b)
    out = {}
    for arch, steps, decodes in LM_MESH_ARCHS:
        cfg, r = lm_mesh_cfg(arch), ref_[arch]
        inp = r["inputs"]
        full = lm_mesh_params(cfg)
        blocks = lm_api.shard_params(full, cfg, mesh)
        del full
        _free()
        place = make_placer("cuda", mesh, lm_api.batch_specs(cfg, mesh))
        rec = {"logits_err": [], "loss": [], "gnorm": [], "leaves": {}}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = lm_api.make_prefill_step(
            cfg, LM_MESH_MAX_LEN, mesh=mesh)(blocks, place(
                {"tokens": inp["prompt"]}))
        dec = lm_api.make_decode_fn(cfg, mesh=mesh)
        digest = ""
        for i in range(1 + decodes):
            if i:
                logits, cache = dec(blocks, cache, {
                    "tokens": place({"tokens": inp["decode"][i - 1]})[
                        "tokens"], "pos": LM_MESH_S + i - 1})
            whole = collectives.all_gather(logits, mesh, "model", dim=-1)
            want = (r["prefill"] if i == 0 else r["decode"][i - 1])[rows]
            if whole.shape != want.shape or not torch.isfinite(whole).all():
                fail(f"16(i) {arch} logits {i}: {tuple(whole.shape)}, "
                     f"finite {bool(torch.isfinite(whole).all())}")
            err = float((whole.cpu() - want).abs().max())
            if not torch.allclose(whole.cpu(), want, **LM_MESH_LOGIT_TOL):
                fail(f"16(i) {arch} logits {i}: {err} from the one-rank "
                     f"path's (bound {LM_MESH_LOGIT_TOL})")
            rec["logits_err"].append(err)
            digest += _digest(whole)
        rec["kv_heads"] = cache["layers"]["k"].shape[3]
        del cache, logits, whole
        torch.cuda.synchronize()
        rec["serve_s"] = time.perf_counter() - t0
        spec = _by_path(lm_api.param_specs(cfg))
        _, opt, step = lm_api.make_train_step(cfg, mesh=mesh)
        state = opt.init(blocks)
        # each leaf's block before the step on both sides (the same bits
        # before the first), the first moments before it, and the
        # elements' gradient noise across the steps
        prev = {p: (x.clone(),) * 2 for p, x in tree_paths(blocks)}
        prev_m = {p: torch.zeros_like(x) for p, x in tree_paths(state["m"])}
        noise = {p: {} for p in prev}
        t0 = time.perf_counter()
        for s, toks in enumerate(inp["train"]):
            blocks, state, met = step(blocks, state, place({"tokens": toks}))
            loss, gn = float(met["loss"]), float(met["grad_norm"])
            if abs(loss - r["loss"][s]) > LM_MESH_LOSS_RTOL * abs(
                    r["loss"][s]) or abs(gn - r["gnorm"][s]) > \
                    LM_MESH_GNORM_RTOL[min(s, 1)] * r["gnorm"][s]:
                fail(f"16(i) {arch} step {s}: loss {loss}, grad norm {gn};"
                     f" one rank {r['loss'][s]}, {r['gnorm'][s]}")
            rec["loss"].append(loss)
            rec["gnorm"].append(gn)
            want, gwant = (dict(tree_paths(torch.load(
                tmp / f"lm_mesh_{arch}_{k}{s + 1}.pt", mmap=True,
                weights_only=True))) for k in "pg")
            m = dict(tree_paths(state["m"]))
            for path, blk in tree_paths(blocks):
                wb, gb = (sharding.local_block(t[path], mesh, sharding.resolve(
                    mesh, spec[path])).cuda() for t in (want, gwant))
                ga = _step_grad(m[path], prev_m[path])
                c = _lm_mesh_leaf_check(
                    f"{arch} step {s} {path}", (prev[path][0], blk, ga),
                    (prev[path][1], wb, gb), r["scales"][s][path],
                    noise[path])
                old = rec["leaves"].get(path, {"share": 0.0, "update": 0.0})
                rec["leaves"][path] = {k: max(old[k], c[k]) for k in c}
                prev[path] = (blk.clone(), wb)
                prev_m[path] = m[path].clone()
                del ga, gb
            del want, gwant, m
        del prev, prev_m, noise
        torch.cuda.synchronize()
        rec["train_s"] = time.perf_counter() - t0
        rec["digest"] = digest
        rec["blocks_digest"] = "".join(_digest(x) for x in
                                       tree_leaves(blocks))
        if arch in LM_MESH_CKPT:
            name, opt_, _ = lm_api.make_train_step(cfg)
            p_sh, s_sh, _ = lm_api.train_state_specs(cfg, name, opt_, mesh)
            t0 = time.perf_counter()
            CheckpointManager(tmp / f"lm_ckpt_{arch}", device="cuda").save(
                steps, (blocks, state), shardings=(p_sh, s_sh))
            rec["save_s"] = time.perf_counter() - t0
            rec["state"] = (blocks, state)
        else:
            del blocks, state
        out[arch] = rec
        _free()
    return out


def _mesh2d_rank(mesh, tmp: str, fp_probs) -> dict:
    """One gloo rank of 16(e) and (f), the launch counts zeroed before
    the main path and read after it."""
    tmp = pathlib.Path(tmp)
    reset_counts()
    dlrm_out = _mesh2d_dlrm(mesh, str(tmp / "mesh2d_ref.pt"), fp_probs)
    launches = launch_counts()
    moe_out = _moe_rank(mesh, str(tmp / "moe_ref.pt"))
    # 16(i): the LM main path's counts, zeroed before it and read after
    reset_counts()
    lm_out = _lm_mesh_rank(mesh, tmp)
    lm_launches = launch_counts()
    lm_out["restore"] = {}
    for arch in LM_MESH_CKPT:
        state = lm_out[arch].pop("state")
        lm_out["restore"][arch] = _lm_mesh_restore(
            lm_mesh_cfg(arch), mesh, state, tmp / f"lm_ckpt_{arch}")
        del state
        _free()
    return {"coords": (mesh.rank("data"), mesh.rank("model")),
            "dlrm": dlrm_out, "moe": moe_out, "launches": launches,
            "lm": lm_out, "lm_launches": lm_launches}


def lm_mesh_report(res: list, lm_ref: dict) -> dict:
    """16(i)'s checks across the ranks, and its printout: every rank's
    losses and grad norms the same bits, the logits of the ranks of a
    data group the same bits, the blocks of the data replicas the same
    bits, the flash kernel launched on every rank."""
    first = res[0]["lm"]
    for arch, _, _ in LM_MESH_ARCHS:
        for rr in res[1:]:
            got = rr["lm"][arch]
            if got["loss"] != first[arch]["loss"] \
                    or got["gnorm"] != first[arch]["gnorm"]:
                fail(f"16(i) {arch}: the ranks' losses or grad norms differ")
        for a in res:
            for b in res:
                da, ma = a["coords"]
                db, mb = b["coords"]
                if da == db and a["lm"][arch]["digest"] \
                        != b["lm"][arch]["digest"]:
                    fail(f"16(i) {arch}: data group {da}'s ranks computed "
                         "other logits")
                if ma == mb and a["lm"][arch]["blocks_digest"] \
                        != b["lm"][arch]["blocks_digest"]:
                    fail(f"16(i) {arch}: the data replicas of model rank "
                         f"{ma} hold other blocks")
    flash = [rr["lm_launches"]["flash_attention"] for rr in res]
    if min(flash) == 0:
        fail(f"16(i): the flash kernel's launches by rank {flash}")
    counts = {n: sum(rr["lm_launches"][n] for rr in res) for n in KERNELS}
    out = {"launches": counts, "flash_launches_by_rank": flash,
           "reference": lm_ref}
    for arch, steps, decodes in LM_MESH_ARCHS:
        r0 = first[arch]
        worst = max(rr["lm"][arch]["logits_err"][i] for rr in res
                    for i in range(1 + decodes))
        leaves = {p: {k: max(rr["lm"][arch]["leaves"][p][k] for rr in res)
                      for k in ("share", "update")} for p in r0["leaves"]}
        worst_leaf = max(leaves, key=lambda p: leaves[p]["share"])
        share = leaves[worst_leaf]["share"]
        worst_upd = max(leaves, key=lambda p: leaves[p]["update"])
        out[arch] = {"loss": r0["loss"], "gnorm": r0["gnorm"],
                     "ref_loss": lm_ref[arch]["loss"],
                     "ref_gnorm": lm_ref[arch]["gnorm"],
                     "logits_max_abs_err": worst, "leaves": leaves,
                     "worst_leaf": worst_leaf,
                     "worst_leaf_share_of_bound": share,
                     "worst_update_leaf": worst_upd,
                     "kv_heads": [rr["lm"][arch]["kv_heads"] for rr in res],
                     "serve_s": r0["serve_s"], "train_s": r0["train_s"],
                     **({"save_s": r0["save_s"]} if "save_s" in r0 else {})}
        print(f"  16(i) {arch} at {LM_MESH_LAYERS} layers, S {LM_MESH_S}, "
              f"(2, 2): prefill and {decodes} decode logits within "
              f"{worst:.3e} of the one-rank path's (bound "
              f"{LM_MESH_LOGIT_TOL}); kv heads a rank "
              f"{out[arch]['kv_heads']}; {steps} AdamW step(s): loss "
              + ", ".join(f"{a:.6f} (one rank {b:.6f})" for a, b in
                          zip(r0["loss"], lm_ref[arch]["loss"]))
              + ", grad norm " + ", ".join(
                  f"{a:.5f} (one rank {b:.5f})" for a, b in
                  zip(r0["gnorm"], lm_ref[arch]["gnorm"]))
              + f"; the worst element at {share:.2f} of its bound "
              f"({worst_leaf}), the worst step's update "
              f"{leaves[worst_upd]['update']:.3f} from the one-rank "
              f"step's ({worst_upd}, bound {LM_MESH_UPDATE_RTOL}); serve "
              f"{r0['serve_s']:.1f} s, train {r0['train_s']:.1f} s (host "
              "clock, gloo)")
    out["restore"] = {}
    for arch in LM_MESH_CKPT:
        rest = [rr["lm"]["restore"][arch] for rr in res]
        out["restore"][arch] = rest
        print(f"  16(i) {arch}'s (2, 2) state saved in "
              f"{first[arch]['save_s']:.1f} s, restored onto (1, 4) at "
              f"{[x['at'] for x in rest]}: {rest[0]['leaves']} leaves a "
              f"rank bit for bit, {max(x['restore_s'] for x in rest):.1f} s")
    print(f"  16(i) flash launches by rank {flash}; launches {counts}; at "
          f"the ranks' heads within {lm_ref['flash_max_abs_err']:.3e} of "
          f"the plain version")
    return out


# 16(j): the MoE and MLA decoders on the (2, 2) mesh, a model at a time
# in 4 gloo ranks of its own after 16(e)'s: kimi-k2 and arctic-480b at
# full width, 1 layer and 16 of their experts (19(b)'s cut, top-k kept),
# and minicpm3-4b at 2 layers,
# one sequence of 2,048 tokens a data rank; the MoE's capacity factor
# raised to n_experts / top_k, where an expert's capacity is every token
# of the call and nothing can drop, so that the mesh's per-rank capacity
# and the one rank's agree, and its routes pinned to the one-rank run's
# (16(f)'s ``pinned_routes``: a router logit within bf16 rounding of a
# tie would pick another expert on one side); its load-balance loss left
# out (coefficient 0): on the mesh it is the mean of the ranks' own, the
# reference's, not the whole batch's (kimi SMOKE: 2.339 against 2.215),
# and tests/test_torch_lm_mesh_moe.py holds it against the reference's
LM_MOE_ARCHS = (("kimi-k2-1t-a32b", 1), ("arctic-480b", 1),
                ("minicpm3-4b", 2))                 # arch, layers
LM_MOE_EXPERTS = 16                # 19(b)'s CPU_EXPERTS: of 384, of 128
LM_MOE_DECODES = 4
LM_MOE_STEPS = 2
LM_MOE_SEED = 13
LM_MOE_CKPT = "kimi-k2-1t-a32b"    # its (2, 2) train state onto (1, 4)
# the mesh path against the one-rank path on the card, both through the
# kernels and in bf16:
# * logits, losses and grad norms: 16(i)'s tolerances;
# * params after the steps. An Adafactor step moves an element by lr g k,
#   k = 1 / (sqrt(D) c), D = vr_i vc_j / mean(vr) the factored second
#   moment and c = max(1, rms(g sqrt(1/D))) the leaf's clip: its second
#   moments are a row's and a column's, not the element's, and its clip
#   bounds the leaf's RMS, not an element, so no constant bounds a step
#   as AdamW's 1.0004 lr does (16(i)'s rule): an element moves by up to
#   lr sqrt(N) of a leaf of N. Two steps of one element, on two sides
#   whose gradients of it may differ in sign, lie at most M_a + M_b apart,
#   M the side's largest move of the leaf in that step before its bf16
#   rounding (measured on each side at the update's write: the one
#   rank's over the leaf, the rank's over its block; ``moves``). So each
#   element within 2 bf16 ulps of its leaf's scale (each side's rounding
#   a step, half an ulp) plus that sum over the steps (the same holds of
#   AdamW's steps, minicpm3's);
# * each leaf's whole move over the steps, as a vector, within 3/4 of the
#   one-rank path's (relative L2; 16(i)'s): a missing or doubled update
#   is 1 away, a reversed one 2;
# * Adafactor's factored statistics after the steps, vr and vc (a vector
#   leaf's v), within LM_MOE_STAT_TOL of the leaf's largest: each is a
#   mean of squared gradients, whose gradients the two sides compute in
#   bf16 with partial sums rounded in other places (16(i): grad norms
#   within 6e-5 relative); one reduced over a rank's block only is off by
#   the half of the leaf outside it.
LM_MOE_STAT_TOL = 5e-2
# the logits: 16(i)'s rtol, and an atol of 1e-1 where 16(i) took 5e-2.
# kimi's and arctic's heads are wider (d 7,168: a logit's std about
# 0.02 sqrt(7168) = 1.7, their largest ~8, against qwen's ~1 and ~10),
# and the mesh's decode departs from the one rank's by bf16 noise at
# every one of a row's 163,840 (32,000) logits: "p16j2" saw at most 7 of
# a row past 16(i)'s bound, the worst 0.0665 at a logit of 0.31, near
# the largest of a row's draws of a noise of sigma ~0.014; 1e-1 is 7
# sigma. Prefill and the first decode step stayed within 5e-2
LM_MOE_LOGIT_TOL = {"rtol": 2e-2, "atol": 1e-1}
# the flash kernel at the ranks' heads, S 2,048, one sequence
LM_MOE_FLASH_SHAPES = (
    ("kimi-k2-1t-a32b, a rank", 1, LM_MESH_S, 32, 4, 112, True, None),
    ("arctic-480b, a rank", 1, LM_MESH_S, 28, 4, 128, True, None),
)


def lm_moe_cfg(arch: str):
    layers = dict(LM_MOE_ARCHS)[arch]
    cfg = registry.get_arch(arch).replace(n_layers=layers)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, n_experts=LM_MOE_EXPERTS,
            capacity_factor=LM_MOE_EXPERTS / cfg.moe.top_k,
            aux_loss_coef=0.0))
    return cfg


def _drops(seen: list) -> int:
    """Choices dropped in the recorded calls."""
    return sum(int(x[1].sum()) for x in seen)


def lm_moe_params(cfg) -> dict:
    """The whole params on the card, from LM_MOE_SEED (the same bits in
    every process)."""
    return lm_api.init(torch.Generator(device="cuda").manual_seed(
        LM_MOE_SEED), cfg, device="cuda")


def lm_moe_inputs(cfg) -> dict:
    rng = np.random.RandomState(LM_MOE_SEED)

    def toks(*shape):
        return rng.randint(0, cfg.vocab_size, shape).astype(np.int32)
    return {"prompt": toks(LM_MESH_B, LM_MESH_S),
            "decode": [toks(LM_MESH_B) for _ in range(LM_MOE_DECODES)],
            "train": [toks(LM_MESH_B, LM_MESH_S)
                      for _ in range(LM_MOE_STEPS)]}


def _idx(seen: list) -> list:
    """The recorded routes' expert choices in the router's order."""
    return [x[2] for x in seen]


@contextlib.contextmanager
def moves(tree):
    """Each leaf's largest move in the optimizer step taken inside, read
    at the update's write (``optimizers._write(p, delta)``, p <- p -
    delta in fp32, rounded once to p's dtype) as the largest |delta|,
    the move before that rounding (half a bf16 ulp of the leaf's scale
    at most on each side; the element bound's 2 ulps hold it): yields
    {path: max |delta|} (0 for an empty block). Every leaf must be
    written whole, once (a layer stack of fewer than 8 layers is:
    ``layerwise``); nothing is copied."""
    where = {x.data_ptr(): p for p, x in tree_paths(tree) if x.numel()}
    out = {p: 0.0 for p, _ in tree_paths(tree)}
    seen = []

    def make(inner):
        def spy(p, delta):
            path = where.get(p.data_ptr()) if p.numel() else None
            if path is not None:
                out[path] = max(abs(float(torch.amax(delta))),
                                abs(float(torch.amin(delta))))
                seen.append(path)
            return inner(p, delta)
        return spy
    with patched(lm_optimizers, "_write", make):
        yield out
    if sorted(seen) != sorted(where.values()):
        fail(f"16(j): the step wrote {len(seen)} leaves, "
             f"{len(set(seen))} of the {len(where)} whole")


def lm_moe_reference(arch: str, tmp: pathlib.Path) -> tuple:
    """16(j)'s one-rank path of ``arch`` on the card (its kernels
    uncounted): its prefill and decode logits, its MoE routes recorded
    (the pins of the ranks' calls), its train steps with the default
    optimizer (loss, grad norm, routes, each leaf's largest move a
    step) and Adafactor's statistics, saved for the ranks -> (a summary,
    the params after the steps, whole on the card, for the ranks:
    handed to them with their start by CUDA IPC, neither through the
    machine's disk (its writes are capped, and 16(i) and the other
    phases take most) nor its host memory (the CPU reference
    worker's))."""
    cfg = lm_moe_cfg(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with uncounted():
        params = lm_moe_params(cfg)
        inp = lm_moe_inputs(cfg)
        rec = {"inputs": inp, "decode": [], "loss": [], "gnorm": [],
               "moved": [], "routes": {"decode": [], "train": []},
               "drops": 0, "opt": lm_api.default_optimizer(cfg)[0]}
        with recorded_routes() as seen:
            logits, cache = lm_api.prefill(
                params, cfg, {"tokens": torch.from_numpy(inp["prompt"])
                              .cuda()}, LM_MESH_MAX_LEN)
        rec["prefill"] = logits.cpu()
        rec["routes"]["prefill"] = _idx(seen)
        rec["drops"] += _drops(seen)
        for i, t in enumerate(inp["decode"]):
            with recorded_routes() as seen:
                logits, cache = lm_api.decode_step(
                    params, cfg, cache, torch.from_numpy(t).cuda(),
                    LM_MESH_S + i)
            rec["decode"].append(logits.cpu())
            rec["routes"]["decode"].append(_idx(seen))
            rec["drops"] += _drops(seen)
        del cache, logits
        torch.cuda.synchronize()
        rec["serve_s"] = time.perf_counter() - t0
        _, opt, step = lm_api.make_train_step(cfg)
        state = opt.init(params)
        for toks in inp["train"]:
            with recorded_routes() as seen, moves(params) as moved:
                params, state, m = step(params, state, {
                    "tokens": torch.from_numpy(toks).cuda()})
            rec["loss"].append(float(m["loss"]))
            rec["gnorm"].append(float(m["grad_norm"]))
            rec["moved"].append(moved)
            rec["routes"]["train"].append(_idx(seen))
            rec["drops"] += _drops(seen)
        torch.cuda.synchronize()
    rec["train_s"] = time.perf_counter() - t0 - rec["serve_s"]
    rec["scales"] = {p: float(x.abs().max().float())
                     for p, x in tree_paths(params)}
    if rec["opt"] == "adafactor":
        rec["fac"] = tree_map(lambda t: t.cpu(), state["fac"])
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del state
    _free()
    if rec["drops"]:
        fail(f"16(j) {arch}: {rec['drops']} tokens dropped a choice on one "
             f"rank")
    torch.save(rec, tmp / f"lm_moe_ref_{arch}.pt")
    return ({k: rec[k] for k in ("loss", "gnorm", "peak_gb", "opt",
                                 "serve_s", "train_s")},
            dict(tree_paths(params)))


def _chunk_rows(mesh, s: int) -> torch.Tensor:
    """The one-rank path's token rows (b-major, B x S) of this rank's
    (B/dp, S/tp) chunk."""
    b_loc = LM_MESH_B // mesh.size("data")
    s_loc = s // mesh.size("model")
    d, m = mesh.rank("data"), mesh.rank("model")
    return ((d * b_loc + torch.arange(b_loc))[:, None] * s
            + m * s_loc + torch.arange(s_loc)[None, :]).reshape(-1)


def _pins(calls: list, rows=None) -> list:
    """``pinned_routes``' form of recorded calls, each cut to ``rows``."""
    return [(None, None, c if rows is None else c[rows]) for c in calls]


def _lm_moe_restore(cfg, mesh, state, ckpt: pathlib.Path) -> dict:
    """16(j): the (2, 2) train state (the params of ``state``'s top-level
    keys, Adafactor's state) restored onto (1, 4) at coordinate (0, 2 m
    + d): each leaf's block the part of this rank's (2, 2) block
    (gathered along the dims where it does not hold the (1, 4) block),
    bit for bit."""
    d, m = mesh.rank("data"), mesh.rank("model")
    fine = Mesh((("data", None, 0, 1), ("model", None, 2 * m + d, 4)))
    name, opt, _ = lm_api.make_train_step(cfg)
    params, st = state
    sh, fine_sh = {}, {}
    for mesh_, out in ((mesh, sh), (fine, fine_sh)):
        p_sh, out["s"], _ = lm_api.train_state_specs(cfg, name, opt, mesh_)
        out["p"] = {k: p_sh[k] for k in params}
    coarse, finer = _by_path(sh), _by_path(fine_sh)
    mine = _by_path({"p": params, "s": st})

    def whole_shape(path):
        a = coarse[path]
        return ckpt_full_shape(mine[path], a, sharding)

    def cut(mesh_, entry, n, shape):
        cuts = sharding._cuts(mesh_, entry, n, shape)
        return cuts[sharding._index(mesh_, entry)] if cuts else (0, n)

    def nested(path, dim, shape) -> bool:
        """Whether along ``dim`` every (2, 2) rank's block holds the
        (1, 4) block it is held against (fake meshes at every
        coordinate: the same answer on every rank)."""
        a, b = coarse[path].spec[dim], finer[path].spec[dim]
        for dd in range(mesh.size("data")):
            for mm in range(mesh.size("model")):
                ca = Mesh((("data", None, dd, mesh.size("data")),
                           ("model", None, mm, mesh.size("model"))))
                cb = Mesh((("data", None, 0, 1),
                           ("model", None, 2 * mm + dd, 4)))
                oa, sa = cut(ca, a, shape[dim], shape)
                ob, sb = cut(cb, b, shape[dim], shape)
                if not (oa <= ob and ob + sb <= oa + sa):
                    return False
        return True

    def part(path, block):
        """The part of this rank's (2, 2) block that is the (1, 4) block
        at ``fine``'s coordinate; a dim along which the (1, 4) block
        reaches past a (2, 2) rank's (the experts' hidden dims, split
        over 'data' there; kv heads replicated at TP 4) gathered first."""
        shape = whole_shape(path)
        spec_a = list(coarse[path].spec)
        for dim in range(len(spec_a)):
            if spec_a[dim] is None or nested(path, dim, shape):
                continue
            over = [None] * len(spec_a)
            over[dim] = spec_a[dim]
            whole_dim = list(block.shape)
            whole_dim[dim] = shape[dim]
            block = sharding.gather_full(block, mesh, tuple(over),
                                         tuple(whole_dim))
            spec_a[dim] = None
        return _sub_block(block, mesh, fine, tuple(spec_a),
                          finer[path].spec, shape)

    def like(path):
        shape = whole_shape(path)
        dims = []
        for dim, e in enumerate(finer[path].spec):
            cuts = sharding._cuts(fine, e, shape[dim], shape)
            dims.append(cuts[sharding._index(fine, e)][1] if cuts
                        else shape[dim])
        dims += shape[len(dims):]
        return torch.empty(dims, dtype=mine[path].dtype, device="cuda")

    def build(t, path):
        if isinstance(t, dict):
            return {k: build(t[k], f"{path}[{k!r}]") for k in t}
        return t if not torch.is_tensor(t) else like(path)
    template = (build(params, "['p']"), build(st, "['s']"))
    t0 = time.perf_counter()
    (rp, rs), _ = CheckpointManager(ckpt, device="cuda").restore(
        template, shardings=(fine_sh["p"], fine_sh["s"]))
    secs = time.perf_counter() - t0
    back = _by_path({"p": rp, "s": rs})
    leaves = 0
    for path, block in mine.items():
        if not torch.is_tensor(block):
            continue
        if not torch.equal(part(path, block), back[path]):
            fail(f"16(j): {path} restored on (1, 4) at (0, {2 * m + d}) is "
                 f"not the saved block")
        leaves += 1
    if rs["step"] != st["step"]:
        fail(f"16(j): restored step {rs['step']}, saved {st['step']}")
    return {"restore_s": secs, "leaves": leaves, "at": (0, 2 * m + d)}


def _lm_moe_rank(mesh, tmp: pathlib.Path, arch: str,
                 params_after: dict) -> dict:
    """16(j), one rank: the model's prefill, decode and train steps on the
    mesh, its MoE routes pinned to the one-rank path's, against the
    one-rank references (``params_after``: {path: the one-rank leaf
    after the steps}); kimi's (2, 2) layer stack and Adafactor state
    saved and restored onto (1, 4)."""
    r = torch.load(tmp / f"lm_moe_ref_{arch}.pt", weights_only=False)
    d = mesh.rank("data")
    b = LM_MESH_B // mesh.size("data")
    rows = slice(d * b, (d + 1) * b)
    chunk = _chunk_rows(mesh, LM_MESH_S)
    cfg = lm_moe_cfg(arch)
    inp = r["inputs"]
    _free()
    torch.cuda.reset_peak_memory_stats()
    full = lm_moe_params(cfg)
    blocks = lm_api.shard_params(full, cfg, mesh)
    del full
    _free()
    place = make_placer("cuda", mesh, lm_api.batch_specs(cfg, mesh))
    rec = {"logits_err": [], "loss": [], "gnorm": [], "leaves": {},
           "drops": 0, "own_route_flips": 0}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pins = _pins(r["routes"]["prefill"], chunk)
    for calls in r["routes"]["decode"]:
        pins += _pins(calls)
    digest = ""
    with pinned_routes(pins if cfg.moe is not None else None) as own, \
            recorded_routes() as seen:
        logits, cache = lm_api.make_prefill_step(
            cfg, LM_MESH_MAX_LEN, mesh=mesh)(blocks, place(
                {"tokens": inp["prompt"]}))
        dec = lm_api.make_decode_fn(cfg, mesh=mesh)
        for i in range(1 + LM_MOE_DECODES):
            if i:
                logits, cache = dec(blocks, cache, {
                    "tokens": place({"tokens": inp["decode"][i - 1]})[
                        "tokens"], "pos": LM_MESH_S + i - 1})
            whole = collectives.all_gather(logits, mesh, "model", dim=-1)
            want = (r["prefill"] if i == 0 else r["decode"][i - 1])[rows]
            if whole.shape != want.shape \
                    or not torch.isfinite(whole).all():
                fail(f"16(j) {arch} logits {i}: {tuple(whole.shape)}, "
                     f"finite {bool(torch.isfinite(whole).all())}")
            gap = (whole.cpu() - want).abs()
            err = float(gap.max())
            over = gap - (LM_MOE_LOGIT_TOL["atol"]
                          + LM_MOE_LOGIT_TOL["rtol"] * want.abs())
            if float(over.max()) > 0:
                at = int(over.argmax())
                fail(f"16(j) {arch} logits {i}: {err} from the one-rank "
                     f"path's (bound {LM_MOE_LOGIT_TOL}); "
                     f"{int((over > 0).sum())} past it, the worst "
                     f"{float(gap.view(-1)[at]):.4f} at a logit of "
                     f"{float(want.view(-1)[at]):.4f} (largest "
                     f"{float(want.abs().max()):.3f})")
            rec["logits_err"].append(err)
            digest += _digest(whole)
    rec["drops"] += _drops(seen)
    rec["own_route_flips"] += int(sum(int(o.sum()) for o in own))
    rec["cache"] = {k: tuple(v.shape) for k, v in cache["layers"].items()}
    del cache, logits, whole
    torch.cuda.synchronize()
    rec["serve_s"] = time.perf_counter() - t0
    name, opt, step = lm_api.make_train_step(cfg, mesh=mesh)
    rec["opt"] = name
    state = opt.init(blocks)
    moved = []
    t0 = time.perf_counter()
    for s, toks in enumerate(inp["train"]):
        pins = _pins(r["routes"]["train"][s], chunk) \
            if cfg.moe is not None else None
        with pinned_routes(pins) as own, recorded_routes() as seen, \
                moves(blocks) as moved_s:
            blocks, state, met = step(blocks, state,
                                      place({"tokens": toks}))
        rec["drops"] += _drops(seen)
        rec["own_route_flips"] += int(sum(int(o.sum()) for o in own))
        loss, gn = float(met["loss"]), float(met["grad_norm"])
        if abs(loss - r["loss"][s]) > LM_MESH_LOSS_RTOL * abs(
                r["loss"][s]) or abs(gn - r["gnorm"][s]) > \
                LM_MESH_GNORM_RTOL[min(s, 1)] * r["gnorm"][s]:
            fail(f"16(j) {arch} step {s}: loss {loss}, grad norm {gn};"
                 f" one rank {r['loss'][s]}, {r['gnorm'][s]}")
        rec["loss"].append(loss)
        rec["gnorm"].append(gn)
        moved.append(moved_s)
    torch.cuda.synchronize()
    rec["train_s"] = time.perf_counter() - t0
    if rec["drops"]:
        fail(f"16(j) {arch}: {rec['drops']} tokens dropped a choice "
             f"on rank {tuple(mesh.rank(a) for a in MESH2D_AXES)}")
    spec = _by_path(lm_api.param_specs(cfg))
    want = params_after
    # the blocks before the steps, drawn again (no copy was kept)
    full = lm_moe_params(cfg)
    p0 = dict(tree_paths(lm_api.shard_params(full, cfg, mesh)))
    del full
    for path, blk in tree_paths(blocks):
        res = sharding.resolve(mesh, spec[path])
        wb = sharding.local_block(want[path], mesh, res)
        scale = r["scales"][path]
        ulp = 2.0 ** (np.floor(np.log2(scale)) - 7) if scale > 0 else 0.0
        tol = 2 * ulp + sum(m_a[path] + m_b[path]
                            for m_a, m_b in zip(moved, r["moved"]))
        err = float((blk.float() - wb.float()).abs().max()) \
            if blk.numel() else 0.0
        share = err / tol if tol > 0 else float(err > 0)
        if share > 1:
            fail(f"16(j) {arch} {path}: {err} from the one-rank step, "
                 f"past its bound {tol}")
        start = p0[path].float()
        da, db = blk.float() - start, wb.float() - start
        del start
        upd = float((da - db).norm() / db.norm().clamp_min(1e-30)) \
            if blk.numel() else 0.0
        if upd > LM_MESH_UPDATE_RTOL:
            fail(f"16(j) {arch} {path}: the steps' move {upd:.3f} "
                 f"(relative) from the one-rank path's")
        rec["leaves"][path] = {"share": share, "update": upd}
        del wb, da, db
    del want, p0
    if name == "adafactor":
        _, st_sh, _ = lm_api.train_state_specs(cfg, name, opt, mesh)
        st_spec = _by_path(st_sh["fac"])
        ref_fac = dict(tree_paths(r["fac"]))
        worst = 0.0
        for path, x in tree_paths(state["fac"]):
            w = sharding.local_block(ref_fac[path], mesh,
                                     st_spec[path].spec).cuda()
            top = float(ref_fac[path].abs().max())
            gap = float((x - w).abs().max()) / top if top > 0 else 0.0
            if gap > LM_MOE_STAT_TOL:
                fail(f"16(j) {arch} Adafactor {path}: {gap:.3e} of the "
                     f"leaf's largest from the one-rank path's (bound "
                     f"{LM_MOE_STAT_TOL})")
            worst = max(worst, gap)
        rec["stat_gap"] = worst
    rec["digest"] = digest
    rec["blocks_digest"] = "".join(_digest(x) for x in
                                   tree_leaves(blocks))
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if arch == LM_MOE_CKPT:
        # the layer stack's params (the experts' ("expert", "fsdp")
        # blocks, the attention's heads) and the whole Adafactor state;
        # the vocab leaves' layout is 16(i)'s, restored there, and saved
        # here they would write 9.4 GB more (bf16 is saved as fp32) to a
        # disk whose writes are capped
        p_sh, s_sh, _ = lm_api.train_state_specs(cfg, name, opt, mesh)
        part = ({"layers": blocks["layers"]}, state)
        t0 = time.perf_counter()
        CheckpointManager(tmp / f"lm_moe_ckpt_{arch}",
                          device="cuda").save(
            LM_MOE_STEPS, part, shardings=({"layers": p_sh["layers"]},
                                           s_sh))
        rec["save_s"] = time.perf_counter() - t0
        rec["restore"] = _lm_moe_restore(cfg, mesh, part,
                                         tmp / f"lm_moe_ckpt_{arch}")
    del blocks, state
    _free()
    return rec


def lm_moe_report(res: list, ref16j: dict) -> dict:
    """16(j)'s checks across the ranks, and its printout: every rank's
    losses and grad norms the same bits, a data group's logits the same
    bits, the data replicas' blocks the same bits where the leaf is not
    split over 'data' (the experts' are), the flash kernel launched on
    every rank."""
    first = res[0]["lm_moe"]
    for arch, _ in LM_MOE_ARCHS:
        for rr in res[1:]:
            got = rr["lm_moe"][arch]
            if got["loss"] != first[arch]["loss"] \
                    or got["gnorm"] != first[arch]["gnorm"]:
                fail(f"16(j) {arch}: the ranks' losses or grad norms differ")
        for a in res:
            for b in res:
                (da, ma), (db, mb) = a["coords"], b["coords"]
                if da == db and a["lm_moe"][arch]["digest"] \
                        != b["lm_moe"][arch]["digest"]:
                    fail(f"16(j) {arch}: data group {da}'s ranks computed "
                         "other logits")
    flash = [rr["lm_moe_launches"]["flash_attention"] for rr in res]
    if min(flash) == 0:
        fail(f"16(j): the flash kernel's launches by rank {flash}")
    counts = {n: sum(rr["lm_moe_launches"][n] for rr in res)
              for n in KERNELS}
    out = {"launches": counts, "flash_launches_by_rank": flash,
           "reference": ref16j}
    for arch, layers in LM_MOE_ARCHS:
        r0 = first[arch]
        worst = max(rr["lm_moe"][arch]["logits_err"][i] for rr in res
                    for i in range(1 + LM_MOE_DECODES))
        leaves = {p: {k: max(rr["lm_moe"][arch]["leaves"][p][k]
                             for rr in res) for k in ("share", "update")}
                  for p in r0["leaves"]}
        worst_leaf = max(leaves, key=lambda p: leaves[p]["share"])
        worst_upd = max(leaves, key=lambda p: leaves[p]["update"])
        peak = [rr["lm_moe"][arch]["peak_gb"] for rr in res]
        out[arch] = {"loss": r0["loss"], "gnorm": r0["gnorm"],
                     "opt": r0["opt"],
                     "ref_loss": ref16j[arch]["loss"],
                     "ref_gnorm": ref16j[arch]["gnorm"],
                     "logits_max_abs_err": worst, "leaves": leaves,
                     "worst_leaf": worst_leaf,
                     "worst_leaf_share_of_bound": leaves[worst_leaf]["share"],
                     "worst_update_leaf": worst_upd,
                     "worst_update": leaves[worst_upd]["update"],
                     "stat_gap": max(rr["lm_moe"][arch].get("stat_gap", 0.0)
                                     for rr in res),
                     "own_route_flips": [rr["lm_moe"][arch]["own_route_flips"]
                                         for rr in res],
                     "cache": r0["cache"], "peak_gb_by_rank": peak,
                     "ref_peak_gb": ref16j[arch]["peak_gb"],
                     "serve_s": r0["serve_s"], "train_s": r0["train_s"]}
        if "restore" in r0:
            out[arch]["save_s"] = r0["save_s"]
            out[arch]["restore"] = [rr["lm_moe"][arch]["restore"]
                                    for rr in res]
        o = out[arch]
        print(f"  16(j) {arch} at {layers} layer(s), S {LM_MESH_S}, (2, 2): "
              f"prefill and {LM_MOE_DECODES} decode logits within "
              f"{worst:.3e} of the one-rank path's (bound "
              f"{LM_MOE_LOGIT_TOL}); {LM_MOE_STEPS} {o['opt']} steps: loss "
              + ", ".join(f"{a:.6f} (one rank {b:.6f})" for a, b in
                          zip(o["loss"], o["ref_loss"]))
              + ", grad norm " + ", ".join(
                  f"{a:.5f} (one rank {b:.5f})" for a, b in
                  zip(o["gnorm"], o["ref_gnorm"]))
              + f"; the worst element at {o['worst_leaf_share_of_bound']:.2f}"
              f" of its bound ({worst_leaf}), the worst move "
              f"{o['worst_update']:.3f} from the one-rank path's "
              f"({worst_upd}, bound {LM_MESH_UPDATE_RTOL}); Adafactor's "
              f"statistics within {o['stat_gap']:.2e} of a leaf's largest; "
              f"own top-k off the pin on {o['own_route_flips']} tokens by "
              f"rank; cache {o['cache']}; peak memory a rank "
              + ", ".join(f"{g:.1f}" for g in peak)
              + f" GB (one rank {o['ref_peak_gb']:.1f} GB); serve "
              f"{o['serve_s']:.1f} s, train {o['train_s']:.1f} s (host "
              "clock, gloo)")
        if "restore" in o:
            rest = o["restore"]
            print(f"  16(j) {arch}'s (2, 2) layer stack and Adafactor "
                  f"state saved in {o['save_s']:.1f} s, restored onto (1, 4)"
                  f" at "
                  f"{[x['at'] for x in rest]}: {rest[0]['leaves']} leaves a "
                  f"rank bit for bit, "
                  f"{max(x['restore_s'] for x in rest):.1f} s")
    print(f"  16(j) flash launches by rank {flash}; launches {counts}; at "
          f"the ranks' heads within {ref16j['flash_max_abs_err']:.3e} of "
          f"the plain version; one-rank references "
          + ", ".join(f"{a} {ref16j[a]['serve_s'] + ref16j[a]['train_s']:.1f}"
                      for a, _ in LM_MOE_ARCHS) + " s")
    return out


def _lm_moe_main(mesh, tmp: str, archs: tuple, params_after: dict) -> dict:
    """One gloo rank of 16(j) for ``archs``, one after the other, the
    launch counts zeroed before their main path and read after it. The
    one-rank params, mapped from the parent by CUDA IPC, are let go
    before the rank returns: a rank that exits holding them never
    releases them, and the parent keeps their memory."""
    reset_counts()
    out = {}
    for arch in archs:
        out[arch] = _lm_moe_rank(mesh, pathlib.Path(tmp), arch,
                                 params_after.pop(arch))
        _free()
    return {"coords": (mesh.rank("data"), mesh.rank("model")),
            "lm_moe": out, "lm_moe_launches": launch_counts()}


# 16(j)'s starts: the models whose one-rank params fit beside their ranks
# on the card (kimi's 6.3 GB beside its ranks' 4 x 16 GB; arctic's and
# minicpm3's 5.9 beside 4 x 8)
LM_MOE_STARTS = (("kimi-k2-1t-a32b",), ("arctic-480b", "minicpm3-4b"))


def phase_lm_moe_mesh(tmp: pathlib.Path) -> dict:
    """16(j): the flash kernel at the ranks' heads, then for each of
    LM_MOE_STARTS its models' one-rank references here and a start of 4
    gloo ranks as (2, 2) of its own, after (e)'s ranks have exited: the
    one-rank params handed to the ranks on the card fit beside a start's
    ranks, not beside 16(i)'s nor all three models' (runs ran out of
    the card's memory there). The launch counts are the starts' sums."""
    t0 = time.perf_counter()
    with uncounted():
        flash_err, flash = check_flash(
            torch.Generator(device="cuda").manual_seed(LM_MOE_SEED),
            LM_MOE_FLASH_SHAPES, timed=len(LM_MOE_FLASH_SHAPES))
    ref16j = {"flash": flash, "flash_max_abs_err": flash_err}
    res = None
    for archs in LM_MOE_STARTS:
        params_after = {}
        for arch in archs:
            ref16j[arch], params_after[arch] = lm_moe_reference(arch, tmp)
        got = spawn(_lm_moe_main, int(np.prod(MESH2D)), backend="gloo",
                    init_file=str(tmp / f"rendezvous_lm_moe_{archs[0]}"),
                    args=(str(tmp), archs, params_after),
                    timeout_s=SHARD_TIMEOUT_S,
                    join_timeout_s=MESH2D_JOIN_S, mesh_shape=MESH2D,
                    mesh_axes=MESH2D_AXES)
        del params_after
        # the card memory the ranks held by IPC goes back once they exit
        torch.cuda.ipc_collect()
        _free()
        if [rr["coords"] for rr in got] != [(0, 0), (0, 1), (1, 0), (1, 1)]:
            fail(f"16(j) {archs}: ranks at {[rr['coords'] for rr in got]}")
        if res is None:
            res = got
            continue
        for rr, g in zip(res, got):
            rr["lm_moe"].update(g["lm_moe"])
            rr["lm_moe_launches"] = {
                n: rr["lm_moe_launches"][n] + g["lm_moe_launches"][n]
                for n in KERNELS}
    ref16j["s"] = time.perf_counter() - t0
    out = lm_moe_report(res, ref16j)
    print(f"  16(j) {ref16j['s']:.1f} s with its starts")
    return out


def phase_mesh2d(cfg, fp_probs, tmp: pathlib.Path) -> dict:
    """16(e) and (f): the references here, then one start of 4 gloo ranks
    on the (2, 2) mesh."""
    t0 = time.perf_counter()
    mesh2d_references(cfg, tmp / "mesh2d_ref.pt")
    moe_ref = moe_references(tmp / "moe_ref.pt")
    lm_ref = lm_mesh_references(tmp)
    ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = spawn(_mesh2d_rank, int(np.prod(MESH2D)), backend="gloo",
                init_file=str(tmp / "rendezvous_mesh2d"),
                args=(str(tmp), fp_probs), timeout_s=SHARD_TIMEOUT_S,
                join_timeout_s=MESH2D_JOIN_S, mesh_shape=MESH2D,
                mesh_axes=MESH2D_AXES)
    ranks_s = time.perf_counter() - t0
    if [rr["coords"] for rr in res] != [(0, 0), (0, 1), (1, 0), (1, 1)]:
        fail(f"16(e): ranks at {[rr['coords'] for rr in res]}")
    first = res[0]
    for rr in res[1:]:
        for name, s in first["dlrm"]["serve"].items():
            if not np.array_equal(rr["dlrm"]["serve"][name]["probs"],
                                  s["probs"]):
                fail(f"16(e) {name}: the ranks served other bits")
        for kind in ("dense", "sparse"):
            for i, (a, b) in enumerate(zip(first["dlrm"][kind],
                                           rr["dlrm"][kind])):
                if a["loss"] != b["loss"] or a["digest"] != b["digest"]:
                    fail(f"16(e) {kind} step {i}: the ranks' losses, MLP "
                         f"or rows differ")
        for name in ("nodrop", "cf125"):
            if rr["moe"][name]["digest"] != first["moe"][name]["digest"] \
                    or rr["moe"][name]["aux"] != first["moe"][name]["aux"]:
                fail(f"16(f) {name}: the ranks computed other bits")
    m = first["moe"]
    ratio = m["nodrop"]["aux"] / m["nodrop"]["aux_ref"]
    if not 0.5 < ratio < 2.0:
        fail(f"16(f) cf 4: aux {m['nodrop']['aux']}, one rank "
             f"{m['nodrop']['aux_ref']}")
    aux_rel = abs(m["cf125"]["aux"] - m["cf125"]["aux_ref"]) \
        / abs(m["cf125"]["aux_ref"])
    if aux_rel > MOE_AUX_RTOL:
        fail(f"16(f) cf 1.25: aux {m['cf125']['aux']}, the emulation "
             f"{m['cf125']['aux_ref']}")
    counts = {n: sum(rr["launches"][n] for rr in res) for n in KERNELS}
    missing = [k for k in SHARD_KERNELS if counts[k] == 0]
    if missing:
        fail(f"16(e)'s path launched no {missing}")
    d = first["dlrm"]
    s = d["serve"]
    print(f"  16(e) (2, 2) mesh, DLRM(1), block {d['block_bytes']} bytes a "
          f"rank: every rank's probabilities, losses, MLP and rows the same "
          f"bits; from phase 3's: ragged {s['ragged']['err_vs_phase3']:.2e},"
          f" sharded {s['sharded']['err_vs_phase3']:.2e}, cached "
          f"{s['cached']['err_vs_phase3']:.2e}; fixed from its bags ragged "
          f"{s['fixed']['err_vs_fixed_bags_ragged']:.2e}; ms a micro-batch "
          f"(host clock, gloo): " + ", ".join(
              f"{k} {v['ms_per_micro_batch']:.2f}" for k, v in s.items()))
    for kind in ("dense", "sparse"):
        for i, rec in enumerate(d[kind]):
            print(f"  16(e) {kind} step {i}: loss {rec['loss']:.6f} (one "
                  f"rank rel {rec['loss_rel_err']:.1e}), MLP "
                  f"{rec['mlp']['beyond']} of {rec['mlp']['of']} beyond "
                  f"{MESH2D_STEP_ATOL} (max {rec['mlp']['max_abs_err']:.1e}),"
                  f" touched rows {rec['arena']['beyond']} of "
                  f"{rec['arena']['of']} (max "
                  f"{rec['arena']['max_abs_err']:.1e}), accumulators rel "
                  f"{rec['acc_rel_err']:.1e}; {rec['ms']:.1f} ms")
    for name in ("nodrop", "cf125"):
        r = m[name]
        print(f"  16(f) {MOE_ARCH} MoE layer, {MOE_EXPERTS} experts, "
              f"{name}: max |y - ref| {r['max_abs_err']:.3e} of "
              f"{r['ref_max_abs']:.3e} (bound {MOE_BF16_TOL} x), aux "
              f"{r['aux']:.6f} (ref {r['aux_ref']:.6f}), drops {r['drops']},"
              f" own top-k differing from the pinned on {r['own_route_flips']}"
              f" tokens, {r['s']:.2f} s (gloo)")
    print(f"  16(f) weight blocks a rank {m['shapes']}; one-rank references "
          f"{ref_s:.1f} s (MoE {moe_ref['s']:.1f} s, LM {lm_ref['s']:.1f} "
          f"s), ranks {ranks_s:.1f} s with their start; launches {counts}")
    lm = lm_mesh_report(res, lm_ref)
    lm_moe = phase_lm_moe_mesh(tmp)
    return {"launches": counts, "references_s": ref_s, "ranks_s": ranks_s,
            "moe_reference": moe_ref, "lm": lm, "lm_moe": lm_moe,
            "dlrm": {k: v for k, v in d.items() if k != "serve"}
            | {"serve": {k: {kk: vv for kk, vv in v.items()
                             if kk != "probs"} for k, v in s.items()}},
            "moe": m}


def _beside(fn, *args, **kw):
    """Start ``fn(*args, **kw)`` in a thread; returns a function that
    waits for it and gives (its result, its seconds), or raises what it
    raised."""
    box = {}

    def run():
        t0 = time.perf_counter()
        try:
            box["out"] = fn(*args, **kw)
        except BaseException as e:  # re-raised by the caller's join
            box["err"] = e
        box["s"] = time.perf_counter() - t0

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def join():
        thread.join()
        if "err" in box:
            raise box["err"]
        return box["out"], box["s"]
    return join


def phase_sharded(cfg, fp_probs, gen, card, tmp: pathlib.Path) -> dict:
    """Phase 16: the row-sharded path on the card (see the docstring);
    rendezvous files and the 4-rank checkpoint go under ``tmp``."""
    t_phase = time.perf_counter()
    params = dlrm.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                       device="cuda")
    out = {"kernels": check_sharded_kernels(cfg, params, gen)}
    del params
    counts = {n: 0 for n in KERNELS}
    ranks = {}
    for n in sorted(SHARD_COUNTS, reverse=True):      # 4 saves, 2 restores
        t0 = time.perf_counter()
        ranks[n] = spawn(
            _shard_rank, n, backend="gloo",
            init_file=str(tmp / f"rendezvous{n}"),
            args=(str(tmp / "ckpt") if n == 4 else None,
                  str(tmp / "ckpt") if n == 2 else None),
            timeout_s=SHARD_TIMEOUT_S, join_timeout_s=SHARD_TIMEOUT_S)
        print(f"  {n} gloo ranks on one card: {time.perf_counter() - t0:.1f}"
              f" s with their start")
    for n, res in ranks.items():
        for rr in res:
            for k, v in rr["launches"].items():
                counts[k] += v
        first = res[0]
        for name, s in first["serve"].items():
            for rr in res[1:]:
                if not np.array_equal(rr["serve"][name]["probs"], s["probs"]):
                    fail(f"16(b) {n} ranks, {name}: the ranks served other "
                         f"bits")
            if s["captures"] or s["cold_dispatches"] or s["graphed"] \
                    is not False or s["why"] != "sharded source":
                fail(f"16(b) {n} ranks, {name}: captures {s['captures']}, "
                     f"cold dispatches {s['cold_dispatches']}, graphed "
                     f"{s['graphed']} ({s['why']})")
        for name in ("sharded", "cached"):
            err = float(np.abs(first["serve"][name]["probs"]
                               - fp_probs).max())
            if err > PROB_ATOL:
                fail(f"16(b) {n} ranks, {name}: {err} from phase 3's fp "
                     f"probabilities")
            first["serve"][name]["err_vs_phase3"] = err
        for a, b in (("cached", "sharded"), ("fixed", "fixed_bags_ragged")):
            err = float(np.abs(first["serve"][a]["probs"]
                               - first["serve"][b]["probs"]).max())
            if err > PROB_ATOL:
                fail(f"16(b) {n} ranks: {a} {err} from {b}")
            first["serve"][a][f"err_vs_{b}"] = err
        for kind, pp in first["pipelined"].items():
            for rr in res[1:]:
                if not np.array_equal(rr["pipelined"][kind]["logits"],
                                      pp["logits"]):
                    fail(f"16(b) {n} ranks, pipelined {kind}: the ranks "
                         f"computed other bits")
        for i in range(SHARD_STEPS):
            for rr in res[1:]:
                if not np.array_equal(rr["train"]["mlp"][i],
                                      first["train"]["mlp"][i]):
                    fail(f"16(c) {n} ranks, step {i}: the ranks' MLP "
                         f"leaves differ")
                if rr["train"]["losses"][i] != first["train"]["losses"][i]:
                    fail(f"16(c) {n} ranks, step {i}: the ranks' losses "
                         f"differ")
        s = first["serve"]
        print(f"  {n} ranks: every rank's probabilities the same bits; "
              f"from phase 3's: sharded "
              f"{s['sharded']['err_vs_phase3']:.2e}, cached "
              f"{s['cached']['err_vs_phase3']:.2e} (cached from sharded "
              f"{s['cached']['err_vs_sharded']:.2e}, fixed from its bags "
              f"ragged {s['fixed']['err_vs_fixed_bags_ragged']:.2e}); "
              f"pipelined from single-shot: fixed "
              f"{first['pipelined']['fixed']['err_vs_single']:.2e}, ragged "
              f"{first['pipelined']['ragged']['err_vs_single']:.2e}; no "
              f"capture, no cold dispatch, graphed {s['sharded']['graphed']}"
              f" ({s['sharded']['why']})")
        print(f"  {n} ranks: ms a micro-batch (host clock, eager, gloo "
              f"through host memory): sharded "
              f"{s['sharded']['ms_per_micro_batch']:.3f}, cached "
              f"{s['cached']['ms_per_micro_batch']:.3f} (hit rate "
              f"{s['cached']['hit_rate']:.3f}), fixed "
              f"{s['fixed']['ms_per_micro_batch']:.3f}; step ms "
              f"{np.median(first['train']['step_ms']):.2f} (median of "
              f"{SHARD_STEPS}); bytes a rank: block {first['block_bytes']}, "
              f"accumulator {first['acc_bytes']}, all-reduce "
              f"{first['allreduce_bytes']} a micro-batch")
    # 16(d): the 4-rank checkpoint restored at 2 ranks
    saved, back = ranks[4][0], ranks[2][0]
    if not (np.array_equal(saved["probe"], back["probe"])
            and np.array_equal(saved["probe_acc"], back["probe_acc"])):
        fail("16(d): the restored rows differ from the saved ones")
    nxt4, nxt2 = saved["next"], back["next"]
    if not np.array_equal(nxt4["rows"], nxt2["rows"]):
        fail("16(d): the step after the restore touched other rows")
    rel = abs(nxt4["loss"] - nxt2["loss"]) / abs(nxt4["loss"])
    if rel > LOSS_RTOL:
        fail(f"16(d): loss {nxt2['loss']} at 2 ranks, {nxt4['loss']} at 4")
    mlp_d = _beyond(torch.from_numpy(nxt2["mlp"]), torch.from_numpy(
        nxt4["mlp"]), int(MLP_SHARE * nxt4["mlp"].size), nxt4["budget"],
        "16(d) MLP")
    arena_d = _beyond(torch.from_numpy(nxt2["arena"]), torch.from_numpy(
        nxt4["arena"]), ARENA_SAMPLES * cfg.n_tables * MAX_L,
        2 * 10 * LR * cfg.emb_dim ** 0.5, "16(d) arena rows")
    print(f"  16(d): saved at 4 ranks in {saved['save_s']:.2f} s, restored "
          f"at 2 in {back['restore_s']:.2f} s, rows bit for bit; the next "
          f"step's loss rel {rel:.1e}, MLP {mlp_d['beyond']} beyond, arena "
          f"rows {arena_d['beyond']} beyond")
    # 16(g) and (h) start beside 16(e) and (f): each runs its own ranks,
    # processes that share the card and the host's cores with the (2, 2)
    # mesh's; their checks are as they were alone, their times agreement
    # runs
    train_s = _beside(train_launcher.main, [
        "--arch", "dlrm1", "--ragged", "--shards", "2", "--backend", "gloo",
        "--steps", "3", "--rendezvous", str(tmp / "launcher"), "--timeout",
        str(SHARD_TIMEOUT_S)])
    serve_s = _beside(serve_launcher.main, [
        "--arch", "dlrm1", "--shards", "2", "--backend", "gloo",
        "--requests", str(4 * BUCKET), "--batch-size", str(BUCKET),
        "--rendezvous", str(tmp / "serve_launcher"), "--timeout",
        str(SHARD_TIMEOUT_S)])
    nccl_s = _beside(spawn, _nccl_rank, 1, backend="nccl",
                     init_file=str(tmp / "rendezvous_nccl"),
                     timeout_s=SHARD_TIMEOUT_S,
                     join_timeout_s=SHARD_TIMEOUT_S)
    # 16(e), (f): the (data, model) mesh
    mesh2d = phase_mesh2d(cfg, fp_probs, tmp)
    errs = out["kernels"]["max_abs_err"]
    errs["flash_attention"] = max(
        errs.get("flash_attention", 0.0),
        mesh2d["lm"]["reference"]["flash_max_abs_err"],
        mesh2d["lm_moe"]["reference"]["flash_max_abs_err"])
    # 16(g): the launchers
    loss, launcher_s = train_s()
    if not np.isfinite(loss):
        fail(f"16(g): the sharded launcher's loss {loss}")
    served, serve_launcher_s = serve_s()
    if not np.isfinite(served["last_probs"]).all():
        fail("16(g): the sharded serve launcher's probabilities are not "
             "finite")
    # 16(h): nccl at world size 1
    nccl = nccl_s()[0][0]
    missing = [k for k in SHARD_KERNELS if counts[k] == 0]
    if missing:
        fail(f"phase 16's path launched no {missing}")
    out.update({
        "launches": counts,
        # rank 0's record, without the arrays the ranks were held on
        "ranks": {n: {"serve": {name: {k: v for k, v in s.items()
                                       if k != "probs"}
                                for name, s in res[0]["serve"].items()},
                      "train": {k: res[0]["train"][k]
                                for k in ("losses", "step_ms", "cmp")},
                      "pipelined_err": {k: v["err_vs_single"] for k, v
                                        in res[0]["pipelined"].items()},
                      **{k: res[0][k] for k in ("block_bytes", "acc_bytes",
                                                "allreduce_bytes")}}
                  for n, res in ranks.items()},
        "restore": {"loss_rel_err": rel, "mlp": mlp_d, "arena": arena_d,
                    "save_s": saved["save_s"],
                    "restore_s": back["restore_s"]},
        "launcher": {"loss": loss, "s": launcher_s,
                     "serve_p50_ms": served["p50_ms"],
                     "serve_s": serve_launcher_s},
        "nccl": nccl, "mesh2d": mesh2d, "s": time.perf_counter() - t_phase})
    print(f"  {card['nvidia_smi']}: the collectives are gloo through host "
          f"memory (ranks sharing one card): agreement, not the sharded "
          f"path's speed; launches by kernel {counts}; launcher 3 steps "
          f"{launcher_s:.1f} s, serve launcher 4 batches "
          f"{serve_launcher_s:.1f} s (p50 {served['p50_ms']:.2f} ms); nccl "
          f"communicator at one rank exact (the port's collectives make no "
          f"call at one rank); phase "
          f"{out['s']:.1f} s")
    return out


# ---------------------------------------------------------------- phase 17

# 17(a): the flash kernel at kimi-k2's heads (64 query and 8 kv heads of
# 112, which the wrapper pads to depth 128), causal, at both prefill
# lengths (timed) and at lengths that are no multiple of the tiles; and
# at the heads of phase 17's other GQA models at their prefill length:
# arctic-480b's 56/8 of 128 (a group of 7) and internvl2-2b's 16/8
FAM_FLASH_SHAPES = (
    ("kimi-k2 hd 112", 1, 2048, 64, 8, 112, True, None),
    ("kimi-k2 hd 112", 1, 4096, 64, 8, 112, True, None),
    ("kimi-k2 hd 112, ragged S = 100", 2, 100, 64, 8, 112, True, None),
    ("kimi-k2 hd 112, ragged S = 2049", 1, 2049, 64, 8, 112, True, None),
    ("arctic-480b hd 128", 1, 2048, 56, 8, 128, True, None),
    ("internvl2-2b hd 128", 1, 2048, 16, 8, 128, True, None),
)
FAM_FLASH_TIMED = 2
FAM_S = 2048                       # positions of every prefill of phase 17
CPU_EXPERTS = 16                   # 17(c), (d): the one cut of kimi-k2's
                                   # and arctic's copies on the CPU
# depth of every card-against-CPU check of 17 and of 18's RWKV and
# encoder-decoder: at 2 (2 + 2) layers their CPU passes took 102 s of the
# CPU reference worker, which sets the script's time from phase 15 on
FAM_CPU_LAYERS = 1
# but kimi's and arctic's cuts, at 1 layer: at 2, their CPU forwards and
# decodes in two precisions took 109 and 88 s of "final30"'s 762, and
# phase 19 trains every family beside them
MOE_CPU_LAYERS = 1
# kimi-k2 and arctic serve at 1 layer (at 2, 72.8 and 55.4 GB of
# params, 17(b)-(d) took 140 s of "full31"'s 1,083)
KIMI_LAYERS = 1
ARCTIC_LAYERS = 1
# minicpm3-4b at 12 of its 62 layers: whole, its 17(e) took 113 s of the
# script's 1,200 ("final29b"), most of it the chunked MLA's host-bound
# laws and decode steps; at 24 layers 49 s of "final30"'s 762
MINICPM_LAYERS = 6
# internvl2-2b at 12 of its 24 layers (whole: 40.5 s of "full31")
INTERNVL_LAYERS = 12
# routing. A token's top-k is decided by the ordering of its router
# probabilities, and two paths that round differently (the card and the
# CPU, decode and the forward) can order a near-tie either way. A flip
# changes that token's FFN output by a whole expert's share, moves the
# token-major ranks of every later choice of both experts (so which
# choices the capacity drops changes too) and, through attention, every
# later position. So where two MoE paths' logits are held against each
# other, the second runs with its expert choices pinned to the first's
# (``pinned_routes``): its router still runs, its weights are its own
# probabilities at the pinned experts, and the (token, layer) pairs
# whose own top-k differs are counted. The card's count against the CPU
# fp32 path's may be at most LM_FLOOR_FACTOR x the CPU bf16 path's, plus
# FLIP_SHARE of the pairs.
FLIP_SHARE = 0.01
# the prefill and decode laws (tests/test_models.py:61-84), on the card:
# prefill's last logits against the forward's at 2,048 tokens, 2e-2
# (rtol and atol); decode after a prefill of all but the last token
# against the forward's last logits, the decode path's experts pinned to
# the forward's. On LAW_SHORT tokens (after a vlm model's patches), the
# reference's own shape, 5e-2, the reference's bar at its smoke depth of
# 2 layers (kimi's and arctic's here). Deeper, and at 2,048 tokens for
# the models without a MoE, phase 10(c)'s bar against an fp32 forward of
# the same weights on the card (the first full-width run read 0.115
# between minicpm3-4b's bf16 decode and forward at 2,048, over 5e-2). A
# MoE's decode law at 2,048 is printed, not held: its forward drops
# choices past capacity (that run: 1,680 of kimi's 4,096 (token, layer)
# pairs lost one, the last token among them) where the decode step drops
# none, and the fp32 forward that would set its bar does not fit the
# card (2 layers of kimi are 146 GB in fp32). Decode at 2,048 at those
# widths is held in 17(c) and (d), against the CPU.
LAW_PREFILL = 2e-2
LAW_DECODE = 5e-2
LAW_SHORT = 8
MLA_ATOL = 1e-3                    # absorbed == naive (tests/test_models.py
                                   # :107), fp32 on the card at full width


@contextlib.contextmanager
def recorded_routes():
    """Every MoE layer's routing in call order, on the host: (its expert
    choices (T, k) sorted, whether a token's choice was dropped (T,),
    the choices in the router's order (T, k))."""
    seen = []

    def make(inner):
        def spy(idx, n_experts, capacity):
            slot, valid = inner(idx, n_experts, capacity)
            seen.append((torch.sort(idx, -1).values.cpu(),
                         (~valid).view(idx.shape).any(-1).cpu(), idx.cpu()))
            return slot, valid
        return spy
    with patched(lm_moe, "_slots", make):
        yield seen


@contextlib.contextmanager
def pinned_routes(routes):
    """Every MoE layer's expert choices, in call order, replaced by the
    ones ``routes`` recorded on another path; the weights stay this
    path's router probabilities at those experts, renormalised. Yields a
    list that gets, a call, (T,) bool: the tokens whose own top-k
    differs from the pinned one. With ``routes`` None, pins nothing."""
    own = []
    if routes is None:
        yield own
        return
    calls = iter(routes)

    def make(inner):
        def pin(xf32, wr, mcfg):
            _, idx, probs = inner(xf32, wr, mcfg)
            want = next(calls, None)
            if want is None:
                fail(f"more MoE calls than the {len(routes)} recorded")
            want = want[2].to(idx.device)
            own.append((torch.sort(idx, -1).values
                        != torch.sort(want, -1).values).any(-1).cpu())
            w = torch.gather(probs, -1, want)
            return (w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9),
                    want, probs)
        return pin
    with patched(lm_moe, "_route", make):
        yield own
    if len(own) != len(routes):
        fail(f"{len(own)} MoE calls pinned to {len(routes)} recorded")


def decode_routes(r_full: list) -> list:
    """A forward's routes in the order a decode path calls its layers:
    the prefill of all but the last token, then the step of the last."""
    return ([tuple(t[:-1] for t in r) for r in r_full]
            + [tuple(t[-1:] for t in r) for r in r_full])


def route_flips(a: list, b: list) -> torch.Tensor:
    """(T, layers) bool: where two runs' expert sets differ."""
    return torch.stack([(x[0] != y[0]).any(-1) for x, y in zip(a, b)], -1)


def dropped(r: list) -> torch.Tensor:
    """(T, layers) bool: tokens with a choice past capacity."""
    return torch.stack([x[1] for x in r], -1)


@contextlib.contextmanager
def plain_attention():
    """The flash op as models.layers calls it routed to the kernel's plain
    version, for the fp32 references on the card (the kernel takes bf16
    only)."""
    with patched(ops, "flash_attention_gqa",
                 lambda inner: ref.flash_attention_gqa):
        yield


def _fam_group(name: str) -> str:
    """phase 10's groups, with the indexing kernels (the MoE's sort,
    bincount, scatter into the dispatch buffer and gather out of it;
    also the embedding gather and the cache writes) as their own."""
    g = _lm_group(name)
    low = name.lower()
    if g == "other" and any(t in low for t in (
            "index", "scatter", "gather", "sort", "bincount", "cumsum",
            "radix")):
        return "dispatch"
    return g


def fam_batch(cfg, s: int, seed: int, b: int = 1) -> dict:
    """A prompt of ``s`` positions: tokens, and for a vlm model its
    n_frontend_tokens patch embeddings (bf16, as the launchers cast
    them) before s - P tokens."""
    rng = np.random.RandomState(seed)
    batch = {}
    n_tok = s
    if cfg.family == "vlm":
        p = cfg.n_frontend_tokens
        batch["patches"] = torch.from_numpy(rng.randn(
            b, p, cfg.d_model).astype(np.float32)).cuda().bfloat16()
        n_tok = s - p
    batch["tokens"] = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (b, n_tok)).astype(np.int32)).cuda()
    return batch


def _meta_leaves(cfg) -> list:
    """cfg's param leaves (shapes, dtypes) from the port's own init on the
    meta device, nothing drawn."""
    class _Meta:
        device = torch.device("meta")
    inner = lm_params.Builder.normal_
    lm_params.Builder.normal_ = lambda self, out, scale: out
    try:
        return tree_leaves(lm_api.init(_Meta(), cfg, device="meta"))
    finally:
        lm_params.Builder.normal_ = inner


def _param_bytes(cfg) -> int:
    """Bytes of cfg's params."""
    return sum(t.numel() * t.element_size() for t in _meta_leaves(cfg))


def _describe(cfg, params) -> None:
    a, m = cfg.attention, cfg.moe
    heads = (f"{a.n_heads}/{a.n_kv_heads} heads of "
             f"{a.resolved_head_dim(cfg.d_model)}")
    if cfg.family == "hybrid":
        what = (f"RG-LRU width {cfg.rglru.lru_width}, pattern "
                f"{cfg.rglru.block_pattern}, local attention {heads}, "
                f"window {a.window}")
    elif cfg.family == "ssm":
        what = (f"RWKV-6 heads of {cfg.rwkv.head_dim}, chunk "
                f"{cfg.rwkv.chunk_size}")
    elif cfg.is_encdec:
        what = (f"{cfg.enc_layers} + {cfg.dec_layers} layers, {heads}, "
                f"{cfg.enc_memory_len} frames")
    elif a.kind == "gqa":
        what = f"gqa {heads}"
    else:
        what = (f"mla heads {a.n_heads} (qk {a.mla.qk_nope_head_dim}+"
                f"{a.mla.qk_rope_head_dim}, v {a.mla.v_head_dim}, kv rank "
                f"{a.mla.kv_lora_rank})")
    ffn = (f"{m.n_experts} experts of {m.expert_ff} top-{m.top_k}"
           + (f" + dense residual {m.dense_residual_ff}"
              if m.dense_residual_ff else "") if m else f"d_ff {cfg.d_ff}")
    print(f"  {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, {what}, "
          f"{ffn}, vocab {cfg.vocab_size}, {cfg.dtype}, "
          f"{sum(t.numel() for t in tree_leaves(params)) / 1e9:.3f} B "
          f"params ({torch.cuda.memory_allocated() / 1e9:.1f} GB on the "
          "card) from a seeded generator")


def fam_prefill(cfg, params, batch: dict, span=None) -> dict:
    """``api.prefill``: the flash kernel launched once an attention layer
    whose length reaches the threshold, nothing else of the port (and
    for the encoder-decoder, its encoder's launches not causal and its
    decoder's causal); finite logits; tokens/s (host clock around a
    synchronised prefill), peak memory, device time by group and the
    idle share. ``span`` names the recurrence's profiler span, whose
    device time is printed as its own group (taken out of "other" and
    "matmul", where its kernels fall by name)."""
    s = positions(batch)
    want = attention_launches(cfg, s)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with causal_flags() as flags:
        logits, cache = lm_api.prefill(params, cfg, batch, s)
        torch.cuda.synchronize()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    del cache
    if launches["flash_attention"] != want or any(
            n != "flash_attention" and c for n, c in launches.items()):
        fail(f"{cfg.name} prefill S = {s}: launches {launches}, expected "
             f"flash_attention x {want} only")
    t = lm_layers.CHUNKED_THRESHOLD
    if cfg.is_encdec and flags != (
            [False] * cfg.enc_layers * (cfg.enc_memory_len >= t)
            + [True] * cfg.dec_layers * (s >= t)):
        fail(f"{cfg.name}: the kernel's causal flags {flags}, expected "
             f"{cfg.enc_layers} not causal, then {cfg.dec_layers} causal")
    if not bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()):
        fail(f"{cfg.name} prefill S = {s}: non-finite logits")
    walls = []
    for _ in range(LM_TIMED):
        t0 = time.perf_counter()
        lm_api.prefill(params, cfg, batch, s)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = float(np.median(walls))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        lm_api.prefill(params, cfg, batch, s)
        torch.cuda.synchronize()
    groups, times = {}, _kernel_times_us(prof)
    for kname, us in times.items():
        g = _fam_group(kname)
        groups[g] = groups.get(g, 0.0) + us / 1e3
    busy = sum(groups.values())
    kernels = _kernel_count(prof)
    if span is not None:
        # the span's device time needs the host's ops in the trace (a
        # second run: with them, key_averages counts a kernel under its
        # op too). Its kernels are elementwise, cumsums or batched
        # matmuls (the chunked WKV's): its total is taken from "other",
        # "dispatch" and "matmul" in turn
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            lm_api.prefill(params, cfg, batch, s)
            torch.cuda.synchronize()
        in_span = _span_ms(prof, span)
        groups[span] = in_span
        rest = in_span or 0.0
        for g in ("other", "dispatch", "matmul"):
            take = min(rest, groups.get(g, 0.0))
            if take:
                groups[g] -= take
                rest -= take
    top = sorted(times.items(), key=lambda kv: -kv[1])[:8]
    out = {"s": s, "launches": launches, "ms": wall, "walls_ms": walls,
           "causal_flags": {"causal": sum(flags),
                            "not_causal": len(flags) - sum(flags)},
           "top_kernels_ms": [[k[:90], us / 1e3] for k, us in top],
           "tokens_per_s": s / wall * 1e3, "peak_gb": peak / 1e9,
           "kernel_launches": kernels,
           "device_ms": groups, "device_busy_ms": busy,
           "device_idle_share": (1.0 - busy / wall) if busy else None,
           "flash_device_ms_per_launch":
               groups.get("flash", 0.0) / want if want else None}
    print(f"  prefill S = {s}: {wall:.2f} ms ({out['tokens_per_s']:.0f} "
          f"tokens/s), peak {out['peak_gb']:.1f} GB, device {busy:.3f} ms "
          f"{ {g: None if v is None else round(v, 4) for g, v in groups.items()} }"
          f", idle share {out['device_idle_share']}, "
          f"{out['kernel_launches']} kernel launches; launches {launches}"
          + (f" ({out['causal_flags']})" if cfg.is_encdec else ""))
    for kname, ms in out["top_kernels_ms"]:
        print(f"    {ms:9.4f} ms  {_fam_group(kname):8s} {kname}")
    return out


def _law(what: str, got: torch.Tensor, want: torch.Tensor, tol: float,
         hold: bool = True, why: str = "") -> dict:
    """A law between two card results of one position: with ``hold``,
    within tol (rtol and atol) and the same greedy token; else printed,
    with ``why``."""
    err = float((got - want).abs().max())
    a, b = int(got.argmax()), int(want.argmax())
    print(f"  {what}: max |diff| {err:.3e} (tol {tol}), greedy token "
          f"{a} / {b}" + ("" if hold else f": not held ({why})"))
    if hold and (not torch.allclose(got, want, rtol=tol, atol=tol)
                 or a != b):
        fail(f"{what}: {err} over {tol}, token {a} against {b}")
    return {"max_abs_err": err, "tol": tol, "token": a, "want_token": b,
            "held": hold}


def _decode_law(cfg, params, batch: dict, full_last, r_full,
                ref32=None, hold: bool = True, why: str = "") -> dict:
    """Decode after a prefill of all but the last position against the
    forward's last logits (``full_last``; ``r_full`` its routing, to
    which the decode path's experts are pinned, its own choices that
    differ counted): within LAW_DECODE of the forward's, or with
    ``ref32`` = (an fp32 forward's last logits, the bf16 forward's error
    against them) within LM_FLOOR_FACTOR x that error of the fp32
    logits. Fails where it is to be held and the forward dropped a
    choice of the last token (which the decode step never drops, so the
    two would compare nothing); with ``hold`` False, printed."""
    v = cfg.vocab_size
    s = sum(t.shape[1] for t in batch.values())
    head = dict(batch, tokens=batch["tokens"][:, :-1])
    pin = decode_routes(r_full) if cfg.moe is not None else None
    with uncounted(), pinned_routes(pin) as own:
        _, cache = lm_api.prefill(params, cfg, head, s)
        dec, _ = lm_api.decode_step(params, cfg, cache,
                                    batch["tokens"][:, -1], s - 1)
    del cache
    out = {}
    if cfg.moe is not None:
        drops = dropped(r_full)
        out.update(own_route_flips=sum(int(f.sum()) for f in own),
                   route_pairs=sum(f.numel() for f in own),
                   forward_dropped_pairs=int(drops.sum()),
                   last_token_dropped=bool(drops[-1].any()))
        print(f"  S = {s}, decode path pinned to the forward's experts: its "
              f"own top-k differs in {out['own_route_flips']} of "
              f"{out['route_pairs']} (token, layer) pairs; the forward "
              f"dropped a choice of {out['forward_dropped_pairs']} pairs "
              f"(the last token's: {out['last_token_dropped']})")
        if hold and out["last_token_dropped"]:
            fail(f"{cfg.name}, S = {s}: the forward dropped a choice of the "
                 "last token, so its decode law compares nothing")
    what = f"S = {s}, decode after prefill of S - 1 vs forward"
    if hold and ref32 is not None:
        out.update(_against_fp32(
            what + " (the card's fp32 forward for the CPU's)",
            dec[0, :v].float(), ref32[0], ref32[1]))
        out["fp32_floor"] = ref32[1]
    else:
        out.update(_law(what, dec[0, :v].float(), full_last, LAW_DECODE,
                        hold, why))
    return out


def _ref32(cfg, params, batch: dict, full_last) -> tuple:
    """_decode_law's ``ref32``: the last logits of an fp32 forward of the
    same weights on the card (no TF32; the attention through the flash
    kernel's plain version), and the bf16 forward's (``full_last``)
    error against them."""
    v = cfg.vocab_size
    with uncounted(), plain_attention():
        f32, _ = lm_api.forward(tree_map(lambda t: t.float(), params),
                                cfg.replace(dtype="float32"),
                                {k: t.float() if t.is_floating_point()
                                 else t for k, t in batch.items()})
    last = f32[0, -1, :v].clone()
    del f32
    _free()
    err = float((full_last - last).abs().max())
    print(f"  S = {sum(t.shape[1] for t in batch.values())}: the bf16 "
          f"forward against the fp32 forward on the card (floor) {err:.3e}")
    return last, err


def _forward_last(cfg, params, batch: dict) -> tuple:
    """The forward's last logits in fp32, and its routing."""
    with uncounted(), recorded_routes() as r_full:
        full, _ = lm_api.forward(params, cfg, batch)
    return full[0, -1, :cfg.vocab_size].float(), r_full


def fam_laws(cfg, params) -> dict:
    """The reference's laws on the card at full width (see LAW_*): at
    FAM_S prefill against the forward (the same expert choices in every
    layer, exactly), and the decode law, held for the models without a
    MoE; at LAW_SHORT the decode law held."""
    v = cfg.vocab_size
    batch = fam_batch(cfg, FAM_S, seed=5)
    with uncounted(), recorded_routes() as r_pre:
        pre, _ = lm_api.prefill(params, cfg, batch, FAM_S)
    full_last, r_full = _forward_last(cfg, params, batch)
    if cfg.moe is not None and route_flips(r_pre, r_full).any():
        fail(f"{cfg.name}: prefill and forward chose different experts")
    out = {"prefill_vs_forward": _law(
        f"S = {FAM_S}, prefill vs forward", pre[0, :v].float(), full_last,
        LAW_PREFILL)}
    del pre
    if cfg.moe is None:
        out["decode_vs_forward"] = _decode_law(
            cfg, params, batch, full_last, r_full,
            ref32=_ref32(cfg, params, batch, full_last))
    else:
        out["decode_vs_forward"] = _decode_law(
            cfg, params, batch, full_last, r_full, hold=False,
            why="a MoE's forward drops choices its decode step does not; "
            "held in the check against the CPU")
    short = fam_batch(cfg, cfg.n_frontend_tokens + LAW_SHORT, seed=7)
    full_last, r_full = _forward_last(cfg, params, short)
    ref32 = (_ref32(cfg, params, short, full_last)
             if cfg.n_layers > FAM_CPU_LAYERS else None)
    out["short_decode_vs_forward"] = _decode_law(
        cfg, params, short, full_last, r_full, ref32=ref32)
    return out


def _forward_and_decode(params, cfg, batch: dict, pin=None) -> tuple:
    """A forward's logits at every position (S, V) and decode_step's
    after a prefill of all but the last position (V,), fp32 on the host;
    every MoE call's routing recorded and, given ``pin`` = (a forward's
    routes, a decode path's), pinned to those: (forward, decode, (their
    routes), the pinned calls' own flips)."""
    v = cfg.vocab_size
    s = sum(t.shape[1] for t in batch.values())
    head = dict(batch, tokens=batch["tokens"][:, :-1])
    pin_f, pin_d = pin if pin is not None else (None, None)
    with uncounted(), recorded_routes() as r_f, \
            pinned_routes(pin_f) as own_f:
        full, _ = lm_api.forward(params, cfg, batch)
    full = full[0, :, :v].cpu().float()
    with uncounted(), recorded_routes() as r_d, \
            pinned_routes(pin_d) as own_d:
        _, cache = lm_api.prefill(params, cfg, head, s)
        dec, _ = lm_api.decode_step(params, cfg, cache,
                                    batch["tokens"][:, -1], s - 1)
    return full, dec[0, :v].cpu().float(), (r_f, r_d), own_f + own_d


def _every_position(what: str, card: torch.Tensor, c16: torch.Tensor,
                    c32: torch.Tensor) -> dict:
    """Logits (S, V) of the card against the CPU path's fp32 at every
    position, within LM_FLOOR_FACTOR x the CPU bf16 path's own largest
    error, and each position's greedy token against fp32's (or a tie
    within that)."""
    floor = float((c16 - c32).abs().max())
    bound = LM_FLOOR_FACTOR * floor
    err = float((card - c32).abs().max())
    a, b = card.argmax(-1), c32.argmax(-1)
    margin = (c32.gather(-1, b[:, None]) - c32.gather(-1, a[:, None]))[:, 0]
    other = int((a != b).sum())
    beyond = int(((a != b) & (margin > bound)).sum())
    print(f"  {what}, {card.shape[0]} positions: max |card - CPU fp32| "
          f"{err:.3e} (bound {bound:.3e}, {LM_FLOOR_FACTOR:g} x the CPU "
          f"bf16 path's {floor:.3e}); greedy token other than fp32's at "
          f"{other} positions, by more than the bound at {beyond}")
    if err > bound or beyond:
        fail(f"{what}: {err} from the fp32 logits (bound {bound}), "
             f"{beyond} greedy tokens beyond it")
    return {"positions": card.shape[0], "max_abs_err_vs_fp32": err,
            "floor": floor, "bound": bound, "other_tokens": other,
            "tokens_beyond_bound": beyond}


def fam_card_vs_cpu(cfg, params, batch: dict, what: str, target: dict,
                    key: str) -> None:
    """The card against the CPU path's fp32 from the same weights: a
    forward of ``batch`` at every position, and decode after a prefill
    of all but its last position, each within LM_FLOOR_FACTOR x the CPU
    bf16 path's own error (phase 10(c)'s bar). Both bf16 paths run with
    their experts pinned to the fp32 path's, so that every position is
    held; their own routing flips are under the budget (see FLIP_SHARE).
    The CPU path's passes run on the worker; ``settle`` then takes the
    card's, from the same weights copied back (the card's own are freed
    meanwhile), and makes the check into ``target[key]``."""
    s = sum(t.shape[1] for t in batch.values())
    cpu = tree_map(lambda t: t.cpu(), params)
    cbatch = {k: t.cpu() for k, t in batch.items()}

    def cpu_pass() -> dict:
        t0 = time.perf_counter()
        c32f, c32d, r32, _ = _forward_and_decode(
            tree_map(lambda t: t.float(), cpu), cfg.replace(dtype="float32"),
            cbatch)
        c16f, c16d, _, own16 = _forward_and_decode(cpu, cfg, cbatch,
                                                   pin=r32)
        return {"c32f": c32f, "c32d": c32d, "r32": r32, "c16f": c16f,
                "c16d": c16d, "own16": own16,
                "cpu_s": time.perf_counter() - t0}

    def finish(r: dict) -> dict:
        card = tree_map(lambda t: t.cuda(), cpu)
        cpu.clear()
        card_f, card_d, _, own = _forward_and_decode(card, cfg, batch,
                                                     pin=r["r32"])
        del card
        _free()
        out = {"cpu_s": r["cpu_s"]}
        print(f"  {cfg.n_layers} layers, S = {s}: the CPU path's forward "
              f"and decode in fp32 and bf16 took {r['cpu_s']:.1f} s beside "
              "the card")
        if cfg.moe is not None:
            pairs = sum(f.numel() for f in own)
            flips, cpu_flips = (sum(int(f.sum()) for f in o)
                                for o in (own, r["own16"]))
            budget = LM_FLOOR_FACTOR * cpu_flips + FLIP_SHARE * pairs
            out.update(card_route_flips=flips,
                       cpu_bf16_route_flips=cpu_flips, route_pairs=pairs,
                       flip_budget=budget)
            print(f"  experts pinned to the CPU fp32 path's; own top-k "
                  f"other than its: card {flips}, CPU bf16 {cpu_flips} of "
                  f"{pairs} (token, layer) pairs of the forward and the "
                  f"decode path; budget {budget:.1f}")
            if flips > budget:
                fail(f"{cfg.name}: {flips} routing flips against the CPU "
                     f"path, over {budget}")
        out["forward"] = _every_position(
            f"forward, {cfg.n_layers} layers", card_f, r["c16f"], r["c32f"])
        floor = float((r["c16d"] - r["c32d"]).abs().max())
        out["decode"] = _against_fp32(
            f"decode after prefill of S - 1, {cfg.n_layers} layers (CPU "
            f"bf16 vs fp32 {floor:.3e})", card_d, r["c32d"], floor)
        out["decode"]["floor"] = floor
        return out
    Pending(what, target, key, cpu_pass, finish)


def _shallow(cfg, params, n: int) -> tuple:
    """The first n layers (a hybrid's whole groups; each stack of the
    encoder-decoder's): views of the stacked leaves."""
    if cfg.is_encdec:
        return (cfg.replace(n_layers=2 * n, enc_layers=n, dec_layers=n),
                dict(params, enc=tree_map(lambda t: t[:n], params["enc"]),
                     dec=tree_map(lambda t: t[:n], params["dec"])))
    if cfg.family == "hybrid":
        g = n // len(cfg.rglru.block_pattern)
        return cfg.replace(n_layers=n), dict(
            params, groups=tree_map(lambda t: t[:g], params["groups"]),
            tail=[])
    return cfg.replace(n_layers=n), dict(params, layers=tree_map(
        lambda t: t[:n], params["layers"]))


def _free() -> None:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def fam_engine(cfg, params) -> dict:
    """lm_engine, and for a MoE the expert bytes a decode step reads (all
    E C rows run, whatever the routing) against the HBM rate."""
    out = lm_engine(cfg, params)
    if cfg.moe is not None:
        m = cfg.moe
        n_bytes = cfg.n_layers * 3 * m.n_experts * cfg.d_model * m.expert_ff \
            * getattr(torch, cfg.dtype).itemsize
        out["expert_bytes_per_step"] = n_bytes
        out["expert_bound_ms_per_step"] = n_bytes / HBM_BYTES_PER_S * 1e3
        print(f"  decode step: {n_bytes / 1e9:.1f} GB of experts, "
              f"{out['expert_bound_ms_per_step']:.2f} ms at "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, against "
              f"{out['device_ms_per_decode_step']:.2f} device ms a step")
    return out


def fam_cut_vs_cpu(arch: str, target: dict) -> None:
    """17(c), (d): a MoE model at full width cut to CPU_EXPERTS experts
    (top-k kept) and MOE_CPU_LAYERS layers, card against the CPU, into
    ``target["card_vs_cpu"]``."""
    full = registry.get_arch(arch)
    m = full.moe
    cut = full.replace(n_layers=MOE_CPU_LAYERS, moe=dataclasses.replace(
        m, n_experts=CPU_EXPERTS))
    print(f"  {arch}: {CPU_EXPERTS} of {m.n_experts} experts (top-"
          f"{m.top_k} kept), {MOE_CPU_LAYERS} layer(s), against the CPU")
    params = lm_api.init(torch.Generator(device="cuda").manual_seed(1), cut,
                         device="cuda")
    fam_card_vs_cpu(cut, params, fam_batch(cut, FAM_S, seed=6),
                    f"{arch}, {CPU_EXPERTS} experts, {MOE_CPU_LAYERS} "
                    "layer(s): card against the CPU path", target,
                    "card_vs_cpu")
    del params
    _free()


def fam_cut_checks() -> dict:
    """17(c) and (d)'s cuts of kimi-k2 and arctic, their CPU passes
    handed to the worker first (before phase 15, so that they run beside
    15 and 16): a record for each, which phase 17 fills and ``settle``
    completes with the check."""
    print("  17(c), (d): the MoE cuts' CPU passes handed to the worker")
    cuts = {}
    for arch in ("kimi-k2-1t-a32b", "arctic-480b"):
        fam_cut_vs_cpu(arch, cuts.setdefault(arch, {}))
    return cuts


def fam_kimi(out: dict) -> dict:
    """17(b): kimi-k2-1t-a32b at full width and KIMI_LAYERS layers, into
    ``out`` (17(c), its cut against the CPU, is ``fam_cut_checks``')."""
    full = registry.get_arch("kimi-k2-1t-a32b")
    depth = KIMI_LAYERS
    cfg = full.replace(n_layers=depth)
    print(f"  depth cut to {depth} of {full.n_layers} layers "
          f"({_param_bytes(cfg) / 1e9:.1f} GB of params)")
    params = lm_api.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                         device="cuda")
    _describe(cfg, params)
    out.update(depth=depth, prefill=fam_prefill(
        cfg, params, fam_batch(cfg, FAM_S, seed=FAM_S)))
    out["laws"] = fam_laws(cfg, params)
    out["serve"] = fam_engine(cfg, params)
    del params
    _free()
    return out


def fam_model(arch: str, layers=None, seed: int = 0, out=None) -> dict:
    """17(d)-(f): a model at full width (depth ``layers`` or its own):
    prefill, the laws, the DecodeEngine; without a MoE, card against the
    CPU path at FAM_CPU_LAYERS (a MoE's own cut is ``fam_cut_vs_cpu``);
    for MLA, absorbed against naive decode."""
    cfg = registry.get_arch(arch)
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    params = lm_api.init(torch.Generator(device="cuda").manual_seed(seed),
                         cfg, device="cuda")
    _describe(cfg, params)
    out = {} if out is None else out
    out.update(depth=cfg.n_layers, prefill=fam_prefill(
        cfg, params, fam_batch(cfg, FAM_S, seed=FAM_S)))
    out["laws"] = fam_laws(cfg, params)
    out["serve"] = fam_engine(cfg, params)
    if cfg.attention.kind == "mla":
        out["absorbed_vs_naive"] = mla_absorbed_vs_naive(cfg, params)
    if cfg.moe is None:
        shallow, sub = _shallow(cfg, params, FAM_CPU_LAYERS)
        fam_card_vs_cpu(shallow, sub, fam_batch(cfg, FAM_S, seed=6),
                        f"{arch}, {FAM_CPU_LAYERS} layers: card against the "
                        "CPU path", out, "card_vs_cpu")
        del sub
    del params
    _free()
    return out


def mla_absorbed_vs_naive(cfg, params) -> dict:
    """Layer 0's MLA decode step at full width, absorbed against naive
    on one cache (a 64-token prefill's latents, then the step at 64): in
    fp32 within MLA_ATOL (the reference's test), and the working bf16's
    difference printed."""
    p = lm_transformer._layer(params["layers"], 0)["mla"]
    acfg = cfg.attention
    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((LM_SLOTS, 65, cfg.d_model), generator=g, device="cuda")
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        pd = p if dt == torch.bfloat16 else tree_map(lambda t: t.float(), p)
        h = x.to(dt)
        _, (c_kv, k_rope) = lm_mla.mla_full(
            pd, acfg, h[:, :64], torch.arange(64, device="cuda"),
            cfg.d_model, return_latent=True)
        res = []
        for absorbed in (True, False):
            cache = lm_mla.cache_from_latent(acfg, c_kv, k_rope, 128, dt)
            y, _ = lm_mla.mla_decode(pd, acfg, h[:, 64:], 64, cache,
                                     cfg.d_model, absorbed=absorbed)
            res.append(y.float())
        out[str(dt).split(".")[-1]] = float((res[0] - res[1]).abs().max())
        if dt == torch.float32 and not torch.allclose(
                res[0], res[1], rtol=MLA_ATOL, atol=MLA_ATOL):
            fail(f"MLA absorbed vs naive decode, fp32: "
                 f"{out['float32']} over {MLA_ATOL}")
    print(f"  MLA decode, layer 0, absorbed vs naive: fp32 "
          f"{out['float32']:.3e} (tol {MLA_ATOL}), bf16 "
          f"{out['bfloat16']:.3e}")
    return out


def phase_lm_families(gen, cuts: dict) -> tuple:
    clock = [time.perf_counter()]

    def took(part: str) -> float:
        now = time.perf_counter()
        s, clock[0] = now - clock[0], now
        print(f"   (17({part}) took {s:.1f} s)")
        return s

    print("  17(a): flash_attention at hd 112, and at arctic's and "
          "internvl2's heads")
    err, rows = check_flash(gen, FAM_FLASH_SHAPES, FAM_FLASH_TIMED)
    seconds = {"a": took("a")}
    print("  17(b): kimi-k2-1t-a32b")
    kimi = fam_kimi(cuts["kimi-k2-1t-a32b"])
    seconds["b"] = took("b")
    print("  17(d): arctic-480b")
    # two full layers are 55 GB of bf16, too much for a host copy beside
    # its fp32 one: the CPU check runs on the cut (``fam_cut_checks``),
    # as kimi's does
    arctic = fam_model("arctic-480b", layers=ARCTIC_LAYERS,
                       out=cuts["arctic-480b"])
    seconds["d"] = took("d")
    print(f"  17(e): minicpm3-4b, {MINICPM_LAYERS} layers")
    minicpm = fam_model("minicpm3-4b", layers=MINICPM_LAYERS)
    seconds["e"] = took("e")
    print(f"  17(f): internvl2-2b, {INTERNVL_LAYERS} layers")
    internvl = fam_model("internvl2-2b", layers=INTERNVL_LAYERS)
    seconds["f"] = took("f")
    print("  17(g): the serve launcher")
    launcher = serve_launch("minicpm3-4b")
    seconds["g"] = took("g")
    _free()
    runs = {"kimi-k2-1t-a32b": kimi, "arctic-480b": arctic,
            "minicpm3-4b": minicpm, "internvl2-2b": internvl}
    launches = {n: sum(r["prefill"]["launches"][n] for r in runs.values())
                for n in KERNELS}
    return {"max_abs_err": err, "rows": rows}, {
        **runs, "launcher": launcher, "launches": launches,
        "seconds": seconds}


# ---------------------------------------------------------------- phase 18

# 18(a): the flash kernel at recurrentgemma-9b's heads (16 query heads and
# one kv head of 256, causal, its window of 2048) at both prefill lengths
# and at lengths that are no multiple of the depth's 64-row q tile and
# 64-key kv tile, and at seamless-m4t's encoder (16/16 heads of 64, not
# causal, its 3,200 frames); the first REC_FLASH_TIMED rows are timed as
# in 10(a): at S = 2048 the window bounds nothing and the library call
# takes is_causal, at S = 4096 the band as an explicit mask
REC_FLASH_SHAPES = (
    ("recurrentgemma-9b hd 256, window 2048", 1, 2048, 16, 1, 256, True,
     2048),
    ("recurrentgemma-9b hd 256, window 2048", 1, 4096, 16, 1, 256, True,
     2048),
    ("seamless-m4t encoder hd 64, not causal", 1, 3200, 16, 16, 64, False,
     None),
    ("recurrentgemma-9b hd 256, ragged S = 100", 2, 100, 16, 1, 256, True,
     2048),
    ("recurrentgemma-9b hd 256, ragged S = 2049", 1, 2049, 16, 1, 256, True,
     2048),
)
REC_FLASH_TIMED = 3
REC_PREFILL_S = (2048, 4096)       # 18(b): recurrentgemma's prefill rows
REC_RING_S = 4096                  # 18(b): decode after 4,095 tokens, past
                                   # the window of 2,048 (a ring of 2,048)
REC_PROFILE_STEPS = 4              # 18(b, d, e): decode steps profiled
REC_CPU_LAYERS = 3                 # 18(c): one (rec, rec, attn) group
RWKV_CPU_LAYERS = 1                # 18(d)
# 18(b), (d), (e) at cut depths (full width), phase 19 training every
# family after them: recurrentgemma-9b at 14 of 38 layers (4 groups and
# the (rec, rec) tail, as whole), rwkv6-7b at 8 of 32, seamless at 12 +
# 12 of 24 + 24; whole they took 51.3, 52.9 and 21.4 s of "final30"'s
# 762 (rwkv6-7b's host-bound prefills and sequential-WKV decode)
REC_LAYERS = 14
RWKV_LAYERS = 8
ENCDEC_LAYERS = 12
ENCDEC_CPU_LAYERS = 1              # 18(e): an encoder and a decoder layer
LAUNCH_ARCH = "seamless-m4t-large-v2"  # 18(f)


def rec_batch(cfg, s: int, seed: int) -> dict:
    """``s`` target tokens, and for the encoder-decoder its
    ``enc_memory_len`` frame embeddings (bf16, as the launchers cast
    them), drawn first."""
    rng = np.random.RandomState(seed)
    batch = {}
    if cfg.is_encdec:
        batch["frames"] = torch.from_numpy(rng.randn(
            1, cfg.enc_memory_len, cfg.d_model).astype(np.float32)
        ).cuda().bfloat16()
    batch["tokens"] = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (1, s)).astype(np.int32)).cuda()
    return batch


def positions(batch: dict) -> int:
    """A batch's positions: a vlm model's patches and its tokens, an
    encoder-decoder's target tokens (its frames are the encoder's)."""
    return batch["tokens"].shape[1] + (batch["patches"].shape[1]
                                       if "patches" in batch else 0)


def attention_launches(cfg, s: int) -> int:
    """Flash launches of a prefill of ``s`` positions: one a GQA
    attention layer whose length reaches the kernel's threshold (the
    encoder's frames and the decoder's tokens counted apart; MLA and
    cross-attention never take the kernel; RWKV has no attention)."""
    t = lm_layers.CHUNKED_THRESHOLD
    if cfg.is_encdec:
        return (cfg.enc_layers * (cfg.enc_memory_len >= t)
                + cfg.dec_layers * (s >= t))
    if cfg.family == "ssm" or cfg.attention.kind != "gqa" or s < t:
        return 0
    if cfg.family != "hybrid":
        return cfg.n_layers
    groups, tail = lm_transformer._hybrid_layout(cfg)
    return groups * cfg.rglru.block_pattern.count("attn") + tail.count("attn")


@contextlib.contextmanager
def causal_flags():
    """Each flash kernel launch's ``causal`` flag, in order."""
    seen = []

    def make(inner):
        def spy(q, k, v, *, causal=True, window=None):
            seen.append(bool(causal))
            return inner(q, k, v, causal=causal, window=window)
        return spy
    with patched(fa_k, "flash_attention_gqa", make):
        yield seen


def _span_ms(prof, span: str):
    """Device ms of the kernels launched inside a profiler span (the
    span's device total), or None when the trace has none."""
    for e in prof.key_averages():
        if e.key == span:
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = getattr(e, "cuda_time_total", 0.0)
            return us / 1e3 if us > 0 else None
    return None


def _last_fp32(cfg, params, batch: dict) -> torch.Tensor:
    """The last position's logits of an fp32 prefill of the same weights
    on the card (no TF32; attention through the flash kernel's plain
    version), on the host."""
    v = cfg.vocab_size
    with uncounted(), plain_attention():
        f32, _ = lm_api.prefill(tree_map(lambda t: t.float(), params),
                                cfg.replace(dtype="float32"),
                                {k: t.float() if t.is_floating_point()
                                 else t for k, t in batch.items()},
                                batch["tokens"].shape[1])
    out = f32[0, :v].float().cpu()
    del f32
    _free()
    return out


def _decode_after(cfg, params, batch: dict, max_len: int) -> torch.Tensor:
    """decode_step's logits (V,) on the host after a prefill of all but
    the last token."""
    s = batch["tokens"].shape[1]
    head = dict(batch, tokens=batch["tokens"][:, :-1])
    with uncounted():
        _, cache = lm_api.prefill(params, cfg, head, max_len)
        dec, _ = lm_api.decode_step(params, cfg, cache,
                                    batch["tokens"][:, -1], s - 1)
    del cache
    return dec[0, :cfg.vocab_size].float().cpu()


def rec_laws(cfg, params, s: int, max_len: int) -> dict:
    """The reference's laws on the card at full width and ``s`` tokens:
    prefill against the forward's last position (LAW_PREFILL), and
    decode after a prefill of all but the last token against the fp32
    logits of the same weights within LM_FLOOR_FACTOR x the bf16
    forward's own distance from them (10(c)'s bar)."""
    v = cfg.vocab_size
    batch = rec_batch(cfg, s, seed=5)
    with uncounted():
        pre, _ = lm_api.prefill(params, cfg, batch, max_len)
        full, _ = lm_api.forward(params, cfg, batch)
    full_last = full[0, -1, :v].float().cpu()
    del full
    _free()
    out = {"prefill_vs_forward": _law(
        f"S = {s}, prefill vs forward", pre[0, :v].float().cpu(), full_last,
        LAW_PREFILL)}
    dec = _decode_after(cfg, params, batch, max_len)
    f32 = _last_fp32(cfg, params, batch)
    floor = float((full_last - f32).abs().max())
    print(f"  S = {s}: the bf16 forward against the fp32 prefill on the "
          f"card (floor) {floor:.3e}")
    out["decode_vs_forward"] = _against_fp32(
        f"S = {s}, decode after prefill of S - 1 (max_len {max_len}) vs "
        "the fp32 logits", dec, f32, floor)
    out["decode_vs_forward"]["fp32_floor"] = floor
    out["decode_vs_bf16_forward_max_abs_err"] = float(
        (dec - full_last).abs().max())
    return out


def rec_card_vs_cpu(cfg, params, s: int, what: str, target: dict,
                    key: str) -> None:
    """A cut at full width, card against the CPU path's fp32 last-position
    logits of the same weights (a prefill of ``s`` tokens): the card's
    prefill of ``s`` tokens and its decode after a prefill of ``s - 1``,
    each within LM_FLOOR_FACTOR x the CPU bf16 path's own distance from
    those fp32 logits at that position (the bf16 decode path's: one bf16
    pass on the CPU, not two, to keep the phase within its time). The
    CPU path's passes run on the worker; ``settle`` makes the check into
    ``target[key]``."""
    batch = rec_batch(cfg, s, seed=6)
    with uncounted():
        pre, _ = lm_api.prefill(params, cfg, batch, s)
    card_p = pre[0, :cfg.vocab_size].float().cpu()
    card_d = _decode_after(cfg, params, batch, s)
    cpu = tree_map(lambda t: t.cpu(), params)
    cbatch = {k: t.cpu() for k, t in batch.items()}

    def cpu_pass() -> dict:
        t0 = time.perf_counter()
        c32, _ = lm_api.prefill(tree_map(lambda t: t.float(), cpu),
                                cfg.replace(dtype="float32"),
                                {k: t.float() if t.is_floating_point() else t
                                 for k, t in cbatch.items()}, s)
        c32 = c32[0, :cfg.vocab_size]
        head = dict(cbatch, tokens=cbatch["tokens"][:, :-1])
        _, cache = lm_api.prefill(cpu, cfg, head, s)
        c16d, _ = lm_api.decode_step(cpu, cfg, cache,
                                     cbatch["tokens"][:, -1], s - 1)
        cpu.clear()
        return {"c32": c32, "c16d": c16d[0, :cfg.vocab_size].float(),
                "cpu_s": time.perf_counter() - t0}

    def finish(r: dict) -> dict:
        c32 = r["c32"]
        floor = float((r["c16d"] - c32).abs().max())
        print(f"  {cfg.n_layers} layers, S = {s}: the CPU path's fp32 "
              f"prefill and bf16 prefill-and-decode took {r['cpu_s']:.1f} s "
              f"beside the card; CPU bf16 vs fp32 (floor) {floor:.3e}")
        return {"cpu_s": r["cpu_s"], "floor": floor,
                "prefill": _against_fp32(f"prefill, {cfg.n_layers} layers",
                                         card_p, c32, floor),
                "decode": _against_fp32(
                    f"decode after prefill of S - 1, {cfg.n_layers} layers",
                    card_d, c32, floor)}
    Pending(what, target, key, cpu_pass, finish)


def rec_model(arch: str, prefill_s, law_s: int, law_max_len: int,
              cpu_layers: int, span=None, seed: int = 0,
              layers=None) -> tuple:
    """18(b)-(e): a model at full width and its depth (or ``layers``):
    prefill at each length, the laws, the DecodeEngine, then its cut
    against the CPU path. Returns (record, flash launches of the counted
    prefills)."""
    clock = time.perf_counter()
    cfg = registry.get_arch(arch)
    if layers is not None:
        cfg = at_depth(cfg, layers)
    params = lm_api.init(torch.Generator(device="cuda").manual_seed(seed),
                         cfg, device="cuda")
    _describe(cfg, params)
    out = {"depth": cfg.n_layers, "prefill": {}, "parts_s": {}}

    def took(part: str) -> None:
        nonlocal clock
        now = time.perf_counter()
        out["parts_s"][part], clock = now - clock, now

    took("init")
    launches = 0
    for s in prefill_s:
        r = fam_prefill(cfg, params, rec_batch(cfg, s, seed=s), span)
        out["prefill"][str(s)] = r
        launches += r["launches"]["flash_attention"]
    took("prefill")
    out["laws"] = rec_laws(cfg, params, law_s, law_max_len)
    took("laws")
    out["serve"] = lm_engine(cfg, params, profile_steps=REC_PROFILE_STEPS)
    took("engine")
    shallow, sub = _shallow(cfg, params, cpu_layers)
    what = (f"{cfg.name}, the first {cpu_layers} layers"
            + (" of each stack" if cfg.is_encdec else "")
            + ": card against the CPU path")
    print(f"  {what}, its CPU passes handed to the worker")
    rec_card_vs_cpu(shallow, sub, FAM_S, what, out, "card_vs_cpu")
    del params, sub
    _free()
    took("card_vs_cpu")
    print(f"  {cfg.name}: seconds by part "
          f"{ {k: round(v, 1) for k, v in out['parts_s'].items()} }")
    return out, launches


def phase_recurrent(gen) -> tuple:
    clock = [time.perf_counter()]

    def took(part: str) -> float:
        now = time.perf_counter()
        s, clock[0] = now - clock[0], now
        print(f"   (18({part}) took {s:.1f} s)")
        return s

    print("  18(a): flash_attention at hd 256 with a window, and at "
          "seamless's encoder")
    err, rows = check_flash(gen, REC_FLASH_SHAPES, REC_FLASH_TIMED)
    report = [r for r in ptxas_report("flash_attention")
              if r.startswith("depth 256:")]
    print(f"  flash_attention            ptxas {report}")
    if len(report) != 1 or "0 bytes spill stores" not in report[0] \
            or "0 bytes spill loads" not in report[0]:
        fail(f"flash_attention depth 256: ptxas {report}")
    seconds = {"a": took("a")}
    print("  18(b), (c): recurrentgemma-9b")
    rec, n_rec = rec_model("recurrentgemma-9b", REC_PREFILL_S, REC_RING_S,
                           REC_RING_S, REC_CPU_LAYERS, lm_rglru.SCAN_SPAN,
                           layers=REC_LAYERS)
    seconds["bc"] = took("b, c")
    print("  18(d): rwkv6-7b")
    rwkv, n_rwkv = rec_model("rwkv6-7b", (FAM_S,), FAM_S, FAM_S,
                             RWKV_CPU_LAYERS, lm_rwkv6.WKV_SPAN,
                             layers=RWKV_LAYERS)
    seconds["d"] = took("d")
    print("  18(e): seamless-m4t-large-v2")
    seamless, n_seam = rec_model("seamless-m4t-large-v2", (FAM_S,), FAM_S,
                                 FAM_S, ENCDEC_CPU_LAYERS,
                                 layers=ENCDEC_LAYERS)
    seconds["e"] = took("e")
    print("  18(f): the serve launcher")
    launcher = serve_launch(LAUNCH_ARCH)
    seconds["f"] = took("f")
    _free()
    launches = {n: 0 for n in KERNELS}
    launches["flash_attention"] = n_rec + n_rwkv + n_seam
    return {"max_abs_err": err, "rows": rows, "ptxas_256": report}, {
        "recurrentgemma-9b": rec, "rwkv6-7b": rwkv,
        "seamless-m4t-large-v2": seamless, "launcher": launcher,
        "launches": launches, "seconds": seconds}


# ---------------------------------------------------------------- phase 19

# 19(a): the flash op's backward at the heads of every family that
# trains through the kernel, batch 1: kimi-k2's 64/8 of 112 (the pad
# route's forward; the recompute takes 112 as it is), arctic's 56/8 and
# internvl2's 16/8 of 128, recurrentgemma's 16/1 of 256 with its window
# of 2,048 at 2,048 (where it bounds nothing) and at 4,096, seamless's
# encoder not causal over its 3,200 frames and its decoder causal
FAM_BWD_SHAPES = (
    ("kimi-k2 hd 112", 1, 2048, 64, 8, 112, True, None),
    ("arctic-480b hd 128", 1, 2048, 56, 8, 128, True, None),
    ("internvl2-2b hd 128", 1, 2048, 16, 8, 128, True, None),
    ("recurrentgemma-9b hd 256, window 2048", 1, 2048, 16, 1, 256, True,
     2048),
    ("recurrentgemma-9b hd 256, window 2048", 1, 4096, 16, 1, 256, True,
     2048),
    ("seamless encoder hd 64, not causal", 1, 3200, 16, 16, 64, False,
     None),
    ("seamless decoder hd 64", 1, 2048, 16, 16, 64, True, None),
)
TRAIN_ARCHS = ("kimi-k2-1t-a32b", "arctic-480b", "minicpm3-4b",
               "internvl2-2b", "recurrentgemma-9b", "rwkv6-7b",
               "seamless-m4t-large-v2")
# 19(b): one train step a family at full width, card against the CPU
# path, at FAM_TRAIN_CPU_S tokens of the loss (internvl2-2b's 256 patches
# before them, seamless's 3,200 frames beside them), batch 1. The CPU
# path's steps at full width dominate the phase (this card's host: 8
# cores, no bf16 instructions; "p19b": kimi's cut at 2 layers took 46.8
# s in fp32 and 57.5 in bf16, 19(b) 798 s for the seven families at 2
# layers in "p19a"), so: S is the least the phase allows; every cut is 1
# layer deep (recurrentgemma's one group of 3, seamless 1 + 1); and the
# fp32 step that sets the floor runs on the card (fp32 params, TF32 off,
# attention through the kernel's plain version), the CPU path taking
# the bf16 step whose error is the floor. Below S = 2,048 every
# self-attention but seamless's encoder takes the direct path; 19(a)
# and (c) hold the kernel's part of training
FAM_TRAIN_CPU_S = 256
FAM_TRAIN_CPU_LAYERS = 1
# the fp32 reference against the CPU bf16 step, loss and grad norm: a
# guard that the card's fp32 step is the step the floor is measured
# from (seen: within 5e-3 relative, rwkv6-7b's grad norm the farthest)
REF_AGREE = 2e-2
ADAFACTOR_LR = 1e-4                # default_optimizer's Adafactor
# 19(c): timed steps at full width, S = 2,048: (arch, layers (each stack's
# for seamless) or None for whole, experts or None, microbatches, batch).
# recurrentgemma-9b at 4 of its 12 (rec, rec, attn) groups (AdamW's
# params, gradients and two fp32 moments: ~45 GB reckoned);
# internvl2-2b at 12 of 24, minicpm3-4b at 6 of 62, rwkv6-7b at 4 of 32
# and seamless at 4 + 4 of 24 + 24, host-bound and their profiled steps'
# traces long ("p19b": rwkv6-7b 2.40 s a step at 16 layers, seamless
# 4.57 s whole, 19(c) 340 s; "final31" 145 s at twice these depths);
# kimi-k2 and arctic at one layer, their experts cut by ``moe_fit``; the
# micro-batch
# check on arctic at one layer and 16 experts, batch 2 in two
# micro-batches (seamless whole took 7.3 s a step that way in "p19b")
FAM_TRAIN_S = 2048
FAM_TRAIN_RUNS = (("kimi-k2-1t-a32b", 1, None, 1, 1),
                  ("arctic-480b", 1, None, 1, 1),
                  ("minicpm3-4b", 6, None, 1, 1),
                  ("internvl2-2b", 12, None, 1, 1),
                  ("recurrentgemma-9b", 12, None, 1, 1),
                  ("rwkv6-7b", 4, None, 1, 1),
                  ("seamless-m4t-large-v2", 4, None, 1, 1),
                  ("arctic-480b", 1, CPU_EXPERTS, 2, 2))
FAM_TRAIN_STEPS = 2                # timed steps a run (the first one warms
                                   # the allocator), then one profiled
FAM_TRACE_TAKES = 2                # profiled steps until the trace is whole
FAM_SPARE = 10e9                   # bytes moe_fit leaves free on the card
REMAT_ARCH = "kimi-k2-1t-a32b"     # 19(c): remat off against on
# 19(d): seamless's launcher, 2 steps against 1 with a checkpoint and a
# --resume of the last, at LAUNCH_LAYERS of each stack's 24: whole, its
# checkpoint (the params in fp32 and AdamW's two moments, 16.4 GB on
# disk) took most of the part's time ("p19b": 96 s at 3 steps; 249 to
# 269 s beside the CPU steps). The launcher's code path is the same at
# any depth; 15(d) runs it on a whole model
FAM_LAUNCH_STEPS = 2
LAUNCH_LAYERS = 2


@contextlib.contextmanager
def layer_routes(pin=None):
    """A train step's MoE routing keyed by layer. Under the loss's
    per-layer checkpoint each MoE layer routes twice: in the forward, and
    in the backward's recompute (layers in reverse order). Its router
    weight, a view of layer i of the stacked leaf, is the same tensor
    both times, so a layer is known by its router's storage, numbered in
    the order first seen (the forward's). Yields {"routes": the
    forward's choices (T, k) a layer, "flips": (T,) bool a layer, the
    tokens whose own top-k differs from the pinned one, "calls": routings
    a layer}. Without ``pin`` the recompute must choose what the forward
    chose; with ``pin`` (another path's routes by layer) each routing of
    layer i takes ``pin[i]``'s experts, weighted by this path's own
    probabilities there, renormalised, the recompute the same as the
    forward. It spies every thread of its side (``patched``): on the
    card the recompute runs on the autograd engine's device thread."""
    layer_of = {}
    rec = {"routes": [], "flips": [], "calls": []}

    def make(inner):
        def spy(xf32, wr, mcfg):
            w, idx, probs = inner(xf32, wr, mcfg)
            key = wr.data_ptr()
            first = key not in layer_of
            if first:
                layer_of[key] = len(layer_of)
                rec["calls"].append(0)
            i = layer_of[key]
            rec["calls"][i] += 1
            if pin is None:
                if first:
                    rec["routes"].append(idx.cpu())
                elif not torch.equal(idx.cpu(), rec["routes"][i]):
                    fail(f"MoE layer {i}: the recompute routed otherwise "
                         "than the forward")
                return w, idx, probs
            if i >= len(pin):
                fail(f"more MoE layers than the {len(pin)} pinned")
            want = pin[i].to(idx.device)
            if first:
                rec["flips"].append((torch.sort(idx, -1).values
                                     != torch.sort(want, -1).values).any(-1)
                                    .cpu())
            wt = torch.gather(probs, -1, want)
            return (wt / torch.clamp(wt.sum(-1, keepdim=True), min=1e-9),
                    want, probs)
        return spy
    with patched(lm_moe, "_route", make):
        yield rec


@contextlib.contextmanager
def token_losses():
    """The loss's cross entropy, spied: its value ("ce") and each
    next-token loss ("nll", fp32 on the host), from the logits it is
    handed (a vlm model's text region), in the thread that enters it
    (the forward's: the loss is no layer's, so no recompute calls it; a
    launcher beside the CPU reference worker calls it on its own
    thread)."""
    owner = threading.get_ident()
    seen = {}

    def make(inner):
        def spy(logits, labels, mask):
            out = inner(logits, labels, mask)
            if threading.get_ident() != owner:
                return out
            with torch.no_grad():
                lg = logits.float()
                m = lg.amax(-1, keepdim=True)
                logz = m[..., 0] + torch.log(torch.exp(lg - m).sum(-1))
                seen["nll"] = (logz - torch.gather(
                    lg, -1, labels.long()[..., None])[..., 0]).cpu()
                seen["ce"] = float(out)
            return out
        return spy
    with patched(lm_emb, "cross_entropy", make):
        yield seen


def _fam_step(cfg, params, batch: dict, pin=None) -> dict:
    """One train step of cfg's default optimizer, clip LM_TRAIN_CLIP,
    on ``params`` in place (the caller's copy): the loss, the cross
    entropy's value and next-token losses, the grad norm, the clipped
    gradients (the step's own tensors, not copies), the stepped params,
    the routing by layer (``layer_routes(pin)``), and the seconds of the
    step and of its optimizer update."""
    name, opt = lm_api.default_optimizer(cfg)
    seen = {}

    def update(grads, state, p):
        seen["grads"] = grads
        t0 = time.perf_counter()
        out = opt.update(grads, state, p)
        if p_dev.type == "cuda":
            torch.cuda.synchronize()
        seen["update_s"] = time.perf_counter() - t0
        return out
    p_dev = tree_leaves(params)[0].device
    _, spied, step = lm_api.make_train_step(
        cfg, optimizer=(name, Optimizer(opt.init, update)),
        grad_clip=LM_TRAIN_CLIP)
    t0 = time.perf_counter()
    with layer_routes(pin) as routes, token_losses() as ce:
        p, _, m = step(params, spied.init(params), batch)
        loss, gn = float(m["loss"]), float(m["grad_norm"])
    secs = time.perf_counter() - t0
    if cfg.moe is not None and routes["calls"] != [2] * len(routes["calls"]):
        fail(f"{cfg.name}: MoE routings a layer {routes['calls']}, expected "
             "2 (the forward and the recompute)")
    return {"opt": name, "loss": loss, "grad_norm": gn, "ce": ce["ce"],
            "nll": ce["nll"], "grads": seen["grads"], "params": p,
            "routes": routes, "step_s": secs, "update_s": seen["update_s"]}


def _train_cut(arch: str):
    """19(b)'s cut of ``arch`` at full width: FAM_TRAIN_CPU_LAYERS layers
    (recurrentgemma's first (rec, rec, attn) group; seamless's as many
    encoder and decoder layers), a MoE's experts cut to CPU_EXPERTS
    (top-k kept)."""
    cfg = registry.get_arch(arch)
    n = FAM_TRAIN_CPU_LAYERS
    if cfg.is_encdec:
        return cfg.replace(n_layers=2 * n, enc_layers=n, dec_layers=n)
    if cfg.family == "hybrid":
        return cfg.replace(n_layers=len(cfg.rglru.block_pattern))
    cfg = cfg.replace(n_layers=n)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  n_experts=CPU_EXPERTS))
    return cfg


def _train_batch(cfg, s: int, b: int, seed: int) -> dict:
    """An LMSynthetic batch of ``s`` tokens of the loss (a vlm model's
    patches before them, so ``s`` + P positions), numpy, a vlm model's
    patches and an encoder-decoder's frames rounded to bf16 as the card
    takes them: the same values on every path."""
    p = cfg.n_frontend_tokens if cfg.family == "vlm" else 0
    batch = LMSynthetic(cfg, seed=seed).batch(b, s + p)
    for k in ("patches", "frames"):
        if k in batch:
            batch[k] = torch.from_numpy(batch[k]).bfloat16().float().numpy()
    return batch


def _half_ulp(t: torch.Tensor) -> float:
    """Half a bf16 ulp of a leaf's largest magnitude: the most that
    rounding an update's result to bf16 moves its largest elements."""
    m = float(t.abs().max()) if t.numel() else 0.0
    return 2.0 ** (np.floor(np.log2(m)) - 8) if m > 0 else 0.0


def update_floor(opt: str, new16: torch.Tensor, p0: torch.Tensor,
                 measured: float) -> float:
    """A leaf's floor for the update of a bf16 step against the fp32
    one: the CPU bf16 step's own error (``measured``), and at least what
    the update rule allows either bf16 path to differ by.
      * AdamW (15(b)'s rule): the first step moves a param by ~lr sign(g)
        plus lr wd p, so an element whose gradient is within rounding of
        zero may step the other way: 2 lr (1 + wd max|p|).
      * Adafactor, step 1: beta = 1 - 1^-0.8 = 0, so the second-moment
        estimate is this step's own g^2 + eps. A vector leaf's update is
        lr g / sqrt(g^2 + eps) = lr sign(g) for |g| >> 1e-15, and flips
        as AdamW's does: 2 lr. A matrix leaf's (factored) is lr g_ij /
        sqrt(vr_i vc_j / mean(vr)), linear in its gradient with no sign
        step, then scaled by 1 / max(1, RMS): continuous in the
        gradients, so the measured error is its floor.
      * Either way each bf16 path rounds its new param to bf16 once:
        half an ulp of the leaf's largest magnitude."""
    floor = measured
    if opt == "adamw":
        floor = max(floor, 2 * LM_LR * (1 + 0.01 * float(p0.abs().max())))
    elif p0.dim() < 2:
        floor = max(floor, 2 * ADAFACTOR_LR)
    if new16.dtype == torch.bfloat16:
        floor = max(floor, _half_ulp(new16.float()))
    return floor


def _on(nb: dict, dev, dt) -> dict:
    """A numpy batch on ``dev``, its embeddings in ``dt``."""
    return {k: torch.from_numpy(v).to(dev) if k == "tokens"
            else torch.from_numpy(v).to(dev, dt) for k, v in nb.items()}


def _fp32_step(cfg, params, nb: dict) -> dict:
    """19(b)'s reference: the train step in fp32 on the card from an fp32
    copy of ``params`` (TF32 off; attention through the kernel's plain
    version), its routing recorded by layer."""
    with uncounted(), plain_attention():
        return _fam_step(cfg.replace(dtype="float32"),
                         tree_map(lambda t: t.to(torch.float32, copy=True),
                                  params), _on(nb, "cuda", torch.float32))


def fam_train_job(arch: str, s: int) -> dict:
    """19(b)'s inputs for ``arch``: its cut (``_train_cut``), a batch of
    ``s`` tokens of the loss, a MoE's routing from the fp32 step on the
    card (the pin of both bf16 steps), and a host copy of the seeded
    params for the CPU path's bf16 step."""
    cfg = _train_cut(arch)
    params = lm_api.init(torch.Generator(device="cuda").manual_seed(19),
                         cfg, device="cuda")
    nb = _train_batch(cfg, s, 1, seed=19)
    pin = None
    if cfg.moe is not None:
        pin = _fp32_step(cfg, params, nb)["routes"]["routes"]
    t0 = time.perf_counter()
    cpu16 = tree_map(lambda t: t.detach().to("cpu", copy=True), params)
    job = {"arch": arch, "cfg": cfg, "nb": nb, "pin": pin, "cpu16": cpu16,
           "to_host_s": time.perf_counter() - t0}
    del params
    _free()
    return job


def fam_train_checks() -> dict:
    """19(b)'s jobs, made on the card; the CPU path's bf16 steps
    (``_fam_step`` on each job's host params, pinned to its routes) are
    handed to the CPU reference worker, after the passes of phases 17
    and 18, and ``settle`` makes each check (``fam_train_check``) into
    the dict returned, by arch."""
    print(f"  19(b)'s jobs (one train step a family at S = "
          f"{FAM_TRAIN_CPU_S}), their CPU path's bf16 steps handed to the "
          "worker")
    out = {}
    for arch in TRAIN_ARCHS:
        job = fam_train_job(arch, FAM_TRAIN_CPU_S)

        def cpu_pass(job=job) -> dict:
            return _fam_step(job["cfg"], job.pop("cpu16"),
                             _on(job["nb"], "cpu", torch.bfloat16),
                             job["pin"])
        Pending(f"19(b) {arch}: one train step, card against the CPU path",
                out, arch, cpu_pass,
                lambda c16, job=job: fam_train_check(job, c16))
    return out


def fam_train_check(job: dict, c16: dict) -> dict:
    """19(b): one train step of a family's cut from one set of seeded
    params on one batch: on the card in bf16, on the CPU path in bf16
    (``c16``) and, for the floor's reference, in fp32 on the card (see
    FAM_TRAIN_CPU_S), each from its own copy of the params. The loss, the
    grad norm, each leaf's clipped gradient and update on the card within
    LM_FLOOR_FACTOR x the CPU bf16 step's own error against the fp32 step
    (15(b)'s bar; updates with ``update_floor``). The loss's floor is the
    mean |bf16 - fp32| next-token loss plus the bf16 step's error in the
    MoE aux term. A MoE's bf16 steps route to the fp32 step's experts,
    layer by layer (``layer_routes``), their own flips under phase 17's
    budget; the fp32 step, taken again here from the same seeded params,
    must route as the job's did. The results are compared on the card, a
    leaf at a time."""
    cfg, nb, pin, s = job["cfg"], job["nb"], job["pin"], FAM_TRAIN_CPU_S
    params = lm_api.init(torch.Generator(device="cuda").manual_seed(19),
                         cfg, device="cuda")
    c32 = _fp32_step(cfg, params, nb)
    if pin is not None and any(not torch.equal(a, b) for a, b in zip(
            c32["routes"]["routes"], pin)):
        fail(f"{cfg.name}: the fp32 step taken again routed otherwise")
    with uncounted():
        card = _fam_step(cfg, tree_map(lambda t: t.detach().clone(), params),
                         _on(nb, "cuda", torch.bfloat16), pin)
    torch.cuda.synchronize()
    cpu_s = c16["step_s"]
    copy_s = job["to_host_s"]
    for k in ("loss", "grad_norm"):
        if abs(c16[k] - c32[k]) > REF_AGREE * abs(c32[k]):
            fail(f"{cfg.name} train step: the CPU bf16 step's {k} {c16[k]} "
                 f"against the card's fp32 step's {c32[k]}, over "
                 f"{REF_AGREE} relative")
    t0 = time.perf_counter()
    out = {"layers": cfg.n_layers, "seq_len": s, "cpu_s": cpu_s,
           "optimizer": card["opt"], "steps": {},
           "seconds": {"to_host": copy_s, "card_fp32_step": c32["step_s"],
                       "card_fp32_update": c32["update_s"],
                       "cpu_bf16_step": c16["step_s"],
                       "cpu_bf16_update": c16["update_s"],
                       "card_step": card["step_s"]}}
    if cfg.moe is not None:
        pairs = sum(f.numel() for f in card["routes"]["flips"])
        flips, cpu_flips = (sum(int(f.sum()) for f in r["routes"]["flips"])
                            for r in (card, c16))
        budget = LM_FLOOR_FACTOR * cpu_flips + FLIP_SHARE * pairs
        out.update(experts=cfg.moe.n_experts, card_route_flips=flips,
                   cpu_bf16_route_flips=cpu_flips, route_pairs=pairs,
                   flip_budget=budget)
        if flips > budget:
            fail(f"{cfg.name} train step: {flips} routing flips against the "
                 f"fp32 path, over {budget}")

    def aux(r):
        return r["loss"] - r["ce"]
    s16, s32 = (min(1.0, LM_TRAIN_CLIP / (r["grad_norm"] + 1e-9))
                for r in (c16, c32))
    checks = [("loss", abs(card["loss"] - c32["loss"]),
               float((c16["nll"] - c32["nll"]).abs().mean())
               + abs(aux(c16) - aux(c32)))]
    sq, grads = 0.0, []
    for (path, a), (_, b16), (_, b32) in zip(
            tree_paths(card["grads"]), tree_paths(c16["grads"]),
            tree_paths(c32["grads"])):
        b16 = b16.cuda().float()
        # the norm of the bf16 step's unclipped gradient's error
        sq += float(((b16 / s16 - b32 / s32) ** 2).sum())
        grads.append((f"grads {path}", float((a.float() - b32).abs().max()),
                      float((b16 - b32).abs().max())))
    checks.append(("grad_norm", abs(card["grad_norm"] - c32["grad_norm"]),
                   float(np.sqrt(sq))))
    checks += grads
    for (path, a), (_, b16), (_, b32), (_, p0) in zip(
            tree_paths(card["params"]), tree_paths(c16["params"]),
            tree_paths(c32["params"]), tree_paths(params)):
        b16, p0 = b16.cuda(), p0.float()
        u32 = b32 - p0
        err = float((a.float() - p0 - u32).abs().max())
        measured = float((b16.float() - p0 - u32).abs().max())
        checks.append((f"update {path}", err, update_floor(
            card["opt"], b16, p0, measured)))
        del b16, p0, u32
    out["seconds"]["compare"] = time.perf_counter() - t0
    worst = 0.0
    for what, err, floor in checks:
        bound_ = LM_FLOOR_FACTOR * floor
        out["steps"][what] = {"err": err, "floor": floor, "bound": bound_}
        worst = max(worst, err / bound_ if bound_ else
                    (0.0 if err == 0 else float("inf")))
        if err > bound_:
            fail(f"{cfg.name} train step, card against CPU: {what} {err} "
                 f"from the fp32 step, bound {bound_} (floor {floor})")
    for k in ("loss", "grad_norm"):
        out[k] = {"card": card[k], "cpu_bf16": c16[k], "cpu_fp32": c32[k]}
    out["worst_err_over_bound"] = worst
    print(f"  {cfg.name}, {cfg.n_layers} layers"
          + (f", {cfg.moe.n_experts} experts" if cfg.moe else "")
          + f", {card['opt']}, S = {s}: loss card {card['loss']:.6f} / CPU "
          f"bf16 {c16['loss']:.6f} / fp32 (card) {c32['loss']:.6f} (|card "
          f"- fp32| "
          f"{checks[0][1]:.3e}, bound {LM_FLOOR_FACTOR * checks[0][2]:.3e}); "
          f"grad norm {card['grad_norm']:.5f} / {c16['grad_norm']:.5f} / "
          f"{c32['grad_norm']:.5f} (|card - fp32| {checks[1][1]:.3e}, bound "
          f"{LM_FLOOR_FACTOR * checks[1][2]:.3e}); {len(checks) - 2} leaf "
          f"gradients and updates each within {LM_FLOOR_FACTOR:g}x the CPU "
          f"bf16 step's error (worst error / bound {worst:.3f}); "
          f"{cpu_s:.1f} s on the CPU"
          + (f"; experts pinned to the fp32 path's, layer by layer, own "
             f"top-k other than its: card {out['card_route_flips']}, CPU "
             f"bf16 {out['cpu_bf16_route_flips']} of {out['route_pairs']} "
             f"(token, layer) pairs, budget {out['flip_budget']:.1f}"
             if cfg.moe else ""))
    top = sorted(((r["err"] / r["bound"] if r["bound"] else 0.0, w)
                  for w, r in out["steps"].items()), reverse=True)[:4]
    print(f"    closest to their bounds: "
          f"{[(w, round(x, 3)) for x, w in top]}; seconds "
          f"{ {k: round(v, 1) for k, v in out['seconds'].items()} }")
    del params, c32, c16, card
    _free()
    return out


def moe_reckoning(cfg, s: int) -> dict:
    """Bytes a MoE train step of cfg (Adafactor, whole stacked leaves,
    one micro-batch of ``s`` tokens) holds at its peak, from the param
    leaves: the clip, where params, the step's gradients and their
    clipped copies are alive with two fp32 temporaries of a leaf
    ((g.float() * scale)), or the update: params, clipped gradients,
    Adafactor's factored state and two fp32 temporaries of the largest
    leaf (its update in place, and ``_write``'s fp32 copy of the param);
    plus the activations: the fp32 logits and their gradient
    (2 x 2 S Vpad x 4 bytes), the dispatch buffer and its expert
    products (E C (d + 3 ff) x 2 x 2) and 16 (S, d) fp32 rows a layer."""
    leaves = _meta_leaves(cfg)
    p = sum(t.numel() * t.element_size() for t in leaves)
    big = max(t.numel() for t in leaves)
    state = sum(4 * (t.numel() // t.shape[-1] + t.numel() // t.shape[-2])
                if t.dim() >= 2 else 4 * t.numel() for t in leaves)
    m = cfg.moe
    ec = m.n_experts * lm_moe._capacity(s, m)
    act = (16 * s * lm_emb.padded_vocab(cfg.vocab_size)
           + 4 * ec * (cfg.d_model + 3 * m.expert_ff)
           + 64 * s * cfg.d_model * cfg.n_layers)
    clip = 3 * p + 8 * big
    update = 2 * p + state + 8 * big
    return {"params": p, "largest_leaf": big, "adafactor_state": state,
            "activations": act, "clip": clip, "update": update,
            "peak": max(clip, update) + act}


def moe_fit(arch: str, layers: int, s: int) -> tuple:
    """The largest power-of-two expert count (top-k kept) whose reckoned
    peak (``moe_reckoning``) leaves FAM_SPARE bytes of the card's free
    memory: (cfg, its reckoning)."""
    full = registry.get_arch(arch).replace(n_layers=layers)
    _free()
    free, _ = torch.cuda.mem_get_info()
    e = 1 << int(np.log2(full.moe.n_experts))
    while e > full.moe.top_k:
        cfg = full.replace(moe=dataclasses.replace(full.moe, n_experts=e))
        r = moe_reckoning(cfg, s)
        if r["peak"] + FAM_SPARE <= free:
            break
        e //= 2
    print(f"  {arch}: {e} of {full.moe.n_experts} experts (top-"
          f"{full.moe.top_k} kept), {layers} layer(s): reckoned peak "
          f"{r['peak'] / 1e9:.1f} GB (params {r['params'] / 1e9:.1f}, the "
          f"clip {r['clip'] / 1e9:.1f}, the update {r['update'] / 1e9:.1f}, "
          f"activations {r['activations'] / 1e9:.1f}) + "
          f"{FAM_SPARE / 1e9:.0f} GB spare of {free / 1e9:.1f} GB free")
    return cfg, dict(r, free=free)


def recurrence_backward_ms(cfg, s: int) -> dict:
    """The RG-LRU scan's or the chunked WKV's forward + backward at one
    layer's training shapes (batch 1, ``s`` positions), timed alone: its
    kernels run under no span of their own in a step's backward, so a
    step's trace cannot tell them from the rest."""
    g = torch.Generator(device="cuda").manual_seed(7)
    if cfg.family == "hybrid":
        w = cfg.rglru.lru_width or cfg.d_model
        a = torch.rand((1, s, w), generator=g, device="cuda").requires_grad_()
        bt = torch.randn((1, s, w), generator=g,
                         device="cuda").requires_grad_()
        ins = (a, bt)

        def fwd():
            return lm_rglru._scan(a, bt)
        groups, tail = lm_transformer._hybrid_layout(cfg)
        what = "RG-LRU scan"
        n = groups * cfg.rglru.block_pattern.count("rec") + tail.count("rec")
    else:
        rc = cfg.rwkv
        h = cfg.d_model // rc.head_dim
        r, k, v = (torch.randn((1, s, h, rc.head_dim), generator=g,
                               device="cuda").bfloat16().requires_grad_()
                   for _ in range(3))
        w = (0.5 + 0.5 * torch.rand((1, s, h, rc.head_dim), generator=g,
                                    device="cuda")).requires_grad_()
        u = torch.randn((h, rc.head_dim), generator=g,
                        device="cuda").requires_grad_()
        s0 = torch.zeros((1, h, rc.head_dim, rc.head_dim), device="cuda")
        ins = (r, k, v, w, u)

        def fwd():
            return lm_rwkv6._wkv_chunked(r, k, v, w, u, s0, rc.chunk_size)[0]
        what, n = "chunked WKV", cfg.n_layers
    out = fwd()
    gout = torch.randn(out.shape, generator=g, device="cuda")

    def fb():
        return torch.autograd.grad(fwd(), ins, gout)
    row = {"what": what, "layers": n, "forward_ms": time_ms(fwd, 2, 3),
           "forward_device_ms": device_ms(fwd, 2),
           "forward_backward_ms": time_ms(fb, 2, 3),
           "forward_backward_device_ms": device_ms(fb, 2)}
    row["backward_device_ms"] = (
        None if None in (row["forward_backward_device_ms"],
                         row["forward_device_ms"])
        else row["forward_backward_device_ms"] - row["forward_device_ms"])
    print(f"    {what} alone, one layer at S = {s}: forward "
          f"{row['forward_ms']:.2f} ms ({_fmt(row['forward_device_ms'])} "
          f"device), forward + backward {row['forward_backward_ms']:.2f} "
          f"({_fmt(row['forward_backward_device_ms'])}); its backward "
          f"{_fmt(row['backward_device_ms'])} device ms a layer, x {n} "
          "layers a step")
    return row


def rounding_swallows_adamw(p0: torch.Tensor) -> bool:
    """Whether no AdamW step (default_optimizer's lr, wd 0.01) can move
    any element of a bf16 leaf: the bias-corrected ratio |m^ / sqrt(v^)|
    of betas (0.9, 0.95) is at most (1 - b1) / sqrt((1 - b2)(1 - b1^2 /
    b2)) = 1.17 at any step (Cauchy-Schwarz over the moments' sums), so a
    step moves a param by at most 1.17 lr + lr wd |p|; rounded once to
    bf16, it comes back unless it reaches half an ulp, 2^(e - 9) at |p|
    in [2^e, 2^(e+1)) towards zero. (recurrentgemma's RG-LRU gate bias
    ``ba`` starts at -1.0: half an ulp is 2^-9, 5.5x the largest step.)"""
    if p0.dtype != torch.bfloat16:
        return False
    a = p0.float().abs()
    if not bool((a > 0).all()):
        return False
    half = torch.exp2(torch.floor(torch.log2(a)) - 9)
    return bool((half > 1.17 * LM_LR + LM_LR * 0.01 * a).all())


def bit_sum(t: torch.Tensor) -> int:
    """A leaf's fingerprint, taken where it lies: the sum of its
    elements' bit patterns. A leaf that did not move keeps it; one that
    moved changes it unless its changes cancel exactly, which would count
    it as not moved (a failure, not a pass, of 19(c)'s check)."""
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return int(t.detach().view(ints[t.element_size()])
               .sum(dtype=torch.int64))


def fam_train_timed(arch: str, layers, experts, mb: int, b: int) -> dict:
    """19(c): ``arch`` at full width (``layers`` deep, each stack's for the
    encoder-decoder, or whole; a MoE's experts ``experts``, or cut by
    ``moe_fit``), cfg's default optimizer: lm_train_run at
    FAM_TRAIN_S x ``b`` in ``mb`` micro-batches, device ms by group with
    the recurrence's span its own, every param leaf moved; for
    REMAT_ARCH first a gradient pass with remat off against the first
    step's loss and grad norm, bit for bit; for a recurrent model its
    scan's or WKV's backward timed alone."""
    s = FAM_TRAIN_S
    cfg, reck = registry.get_arch(arch), None
    if cfg.moe is not None and experts is None:
        cfg, reck = moe_fit(arch, layers, s)
    elif cfg.is_encdec and layers is not None:
        cfg = cfg.replace(n_layers=2 * layers, enc_layers=layers,
                          dec_layers=layers)
    elif layers is not None:
        cfg = cfg.replace(n_layers=layers)
    if experts is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  n_experts=experts))
    params = lm_api.init(torch.Generator(device="cuda").manual_seed(20),
                         cfg, device="cuda")
    _describe(cfg, params)
    opt_name = lm_api.default_optimizer(cfg)[0]
    n_attn = attention_launches(cfg, s)
    out = {"layers": cfg.n_layers, "optimizer": opt_name,
           "attention_layers": n_attn, "reckoning": reck}
    if cfg.moe is not None:
        out["experts"] = cfg.moe.n_experts
    if arch == REMAT_ARCH and mb == 1:
        loss_nr, norm_nr, n_nr = remat_off_pass(
            cfg, params, LMSynthetic(cfg, seed=s).batch(b, s), n_attn)
        _free()
    start = {p: bit_sum(t) for p, t in tree_paths(params)}
    opt_state = lm_api.default_optimizer(cfg)[1].init(params)
    span = {"hybrid": lm_rglru.SCAN_SPAN, "ssm": lm_rwkv6.WKV_SPAN}.get(
        cfg.family)
    reset_counts()
    run, params, opt_state = lm_train_run(
        cfg, params, opt_state, s, b, mb, seed=s, attn_layers=n_attn,
        spans=(span,) if span else (), group=_fam_group,
        steps=FAM_TRAIN_STEPS, takes=FAM_TRACE_TAKES, warm=1)
    out.update(run, launches=launch_counts())
    if arch == REMAT_ARCH and mb == 1:
        got = (run["losses"][0], run["grad_norms"][0])
        if got != (float(loss_nr), float(norm_nr)):
            fail(f"{arch} train: the remat step's loss and grad norm {got} "
                 f"differ from the remat-off pass's {float(loss_nr)!r}, "
                 f"{float(norm_nr)!r} on the same batch")
        out["remat_off"] = {"launches": n_nr, "loss": float(loss_nr),
                            "grad_norm": float(norm_nr)}
        print(f"  remat off: flash_attention x {n_nr}, loss "
              f"{float(loss_nr)!r} and grad norm {float(norm_nr)!r} equal "
              f"to the remat step's bit for bit")
    leaves = dict(tree_paths(params))
    still = [p for p, t in leaves.items() if bit_sum(t) == start[p]]
    frozen = [p for p in still if opt_name == "adamw"
              and rounding_swallows_adamw(leaves[p])]
    if still != frozen:
        fail(f"{arch} train: params that did not move: "
             f"{sorted(set(still) - set(frozen))}")
    out["frozen_by_rounding"] = frozen
    if frozen:
        print(f"  leaves that no AdamW step can move in bf16 (each "
              f"element's half ulp over the largest step): {frozen}")
    if reck is not None:
        print(f"  peak {run['peak_memory_bytes'] / 1e9:.1f} GB measured "
              f"against {reck['peak'] / 1e9:.1f} GB reckoned")
    print(f"  {opt_name}: {len(start) - len(still)} of {len(start)} param "
          f"leaves moved")
    del params, opt_state, leaves
    _free()
    if span and mb == 1:
        out["recurrence_alone"] = recurrence_backward_ms(cfg, s)
    return out


def phase_lm_train_families(gen) -> tuple:
    """Phase 19 in the order (b)'s jobs (``fam_train_checks``), (d), (a),
    (c), then the checks that wait on the CPU reference worker: those of
    phases 17 and 18 and 19(b)'s. The worker may still run beside (d),
    whose times are printed, not measured, and beside (a) and (c), which
    print whether it did: it runs at a lower priority, and the card's
    device times do not see it."""
    clock = [time.perf_counter()]

    def took(what: str) -> float:
        now = time.perf_counter()
        t, clock[0] = now - clock[0], now
        print(f"   ({what} took {t:.1f} s)")
        return t

    def worker_busy() -> bool:
        return any(not p.future.done() for p in _PENDING)

    agree = fam_train_checks()
    seconds = {"b_jobs": took("19(b)'s jobs")}
    launches = {n: 0 for n in KERNELS}
    print(f"  19(d): the training launcher, {LAUNCH_ARCH} at "
          f"{LAUNCH_LAYERS} + {LAUNCH_LAYERS} layers")
    launcher = lm_launcher(LAUNCH_ARCH, FAM_LAUNCH_STEPS, LAUNCH_LAYERS)
    for n in KERNELS:
        launches[n] += launcher["launches"][n]
    seconds["d"] = took("19(d)")
    busy = {"a": worker_busy()}
    print("  19(a): the flash op's backward at the families' heads"
          + (", beside the CPU reference worker" if busy["a"] else ""))
    err, rows = check_flash_backward(gen, FAM_BWD_SHAPES, trials=3)
    seconds["a"] = took("19(a)")
    busy["c"] = worker_busy()
    print(f"  19(c): timed steps at full width, S = {FAM_TRAIN_S}"
          + (", beside the CPU reference worker" if busy["c"] else ""))
    runs = []
    for arch, layers, experts, mb, b in FAM_TRAIN_RUNS:
        print(f"  {arch}, batch {b} in {mb} micro-batch(es)")
        t0 = time.perf_counter()
        r = fam_train_timed(arch, layers, experts, mb, b)
        runs.append(dict(r, arch=arch, seconds=time.perf_counter() - t0))
        print(f"   ({arch}: {runs[-1]['seconds']:.1f} s)")
        for n in KERNELS:
            launches[n] += r["launches"][n]
    seconds["c"] = took("19(c)")
    busy["c_end"] = worker_busy()
    print("  the card against the CPU path: phases 17, 18 and 19(b), as "
          "the worker's passes are done")
    waited = settle()
    seconds["checks"] = took(f"the checks (of which waiting for the worker "
                             f"{waited['waited_s']:.1f} s)")
    seconds["worker_wait"] = waited["waited_s"]
    _free()
    return {"max_abs_err": err, "rows": rows}, {
        "card_vs_cpu": agree, "runs": runs, "launcher": launcher,
        "launches": launches, "seconds": seconds, "worker_busy": busy}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args()
    global TRACE_DIR
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        TRACE_DIR = args.out.parent

    t_start = time.perf_counter()
    clock = [t_start]

    def phase(title: str) -> None:
        """Print how long the phase before took, then the next header."""
        now = time.perf_counter()
        print(f"   (the phase before took {now - clock[0]:.1f} s)")
        clock[0] = now
        print(f"== {title}")

    print("== phase 1: card")
    card = phase_card()
    cfg = DLRM_CONFIGS["dlrm1"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = dlrm.init(gen, cfg, device="cuda")
    phase("phase 2: kernels against their plain versions")
    kernels = phase_kernels(cfg, params, gen)
    # phases 3 to 7 read the model's stage annotations in host traces
    obs.enable_stage_annotations(True)
    phase("phase 3: serve DLRM(1) at full size")
    served, fp_probs = phase_serve(cfg, params)
    phase("phase 4: train DLRM(1) at full size")
    trained = phase_train(cfg, gen)
    kernels["sls_grad_table"] = trained["sls_grad_table"]
    kernels["gemm"]["max_abs_err"] = max(
        kernels["gemm"]["max_abs_err"], trained["gemm_backward_max_abs_err"])
    kernels["gemm"]["backward_rows"] = trained["gemm_backward_rows"]
    phase("phase 5: serve DLRM(1) on the cached plan")
    cached = phase_serve_cached(cfg, params, fp_probs)
    phase("phase 6: online refresh of the hot cache on the card")
    online = phase_online(cfg)
    phase("phase 7: fixed-L serving and the hybrid pipeline")
    fixed = phase_serve_fixed(cfg, params, fp_probs)
    obs.enable_stage_annotations(False)
    phase("phase 8: fixed-L training")
    trained_fixed = phase_train_fixed(cfg)
    phase("phase 9: tiered storage on DLRM(1)")
    kernels["fused_int4_segment_sum"], tiered, online_t = phase_tiered(
        cfg, params, fp_probs, gen)
    phase("phase 10: LM serving, smollm-360m at full width")
    kernels["flash_attention"], lm = phase_lm(gen)
    phase("phase 11: graphed serving, every plan")
    graphed = phase_graphed(cfg, params)
    del params
    phase("phase 12: table groups, dlrm_het2 at full size")
    het = phase_het(gen)
    for name, err in het["kernels"]["max_abs_err"].items():
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], err)
    phase("phase 13: the serving plane: telemetry, live Fig-5, the SLA "
          "scheduler under open-loop load")
    plane = phase_plane(cfg, served, online, tiered)
    phase("phase 14: the fleet, dlrm_het2 at full width")
    fleet = phase_fleet()
    phase("phase 15: LM training, smollm-360m at full width")
    cuts = fam_cut_checks()
    flash_bwd, lm_train, hand_in_15b = phase_lm_train(gen)
    kernels["flash_attention"]["max_abs_err"] = max(
        kernels["flash_attention"]["max_abs_err"], flash_bwd["max_abs_err"])
    kernels["flash_attention"]["recompute_rows"] = flash_bwd["recompute_rows"]
    phase("phase 16: the row-sharded path, DLRM(1) on 2 and 4 gloo ranks "
          "sharing the card")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shards_") as tmp:
        sharded = phase_sharded(cfg, fp_probs, gen, card, pathlib.Path(tmp))
    for name, err in sharded["kernels"]["max_abs_err"].items():
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], err)
    hand_in_15b()
    phase("phase 17: the MoE, MLA and vision-prefix decoders at full width")
    flash_112, lm_fam = phase_lm_families(gen, cuts)
    kernels["flash_attention"]["max_abs_err"] = max(
        kernels["flash_attention"]["max_abs_err"], flash_112["max_abs_err"])
    kernels["flash_attention"]["hd112_rows"] = flash_112["rows"]
    phase("phase 18: the recurrent, RWKV and encoder-decoder LMs at full "
          "width")
    flash_256, lm_rec = phase_recurrent(gen)
    kernels["flash_attention"]["max_abs_err"] = max(
        kernels["flash_attention"]["max_abs_err"], flash_256["max_abs_err"])
    kernels["flash_attention"]["hd256_rows"] = flash_256["rows"]
    phase("phase 19: LM training of the seven families at full width")
    flash_bwd19, lm_fam_train = phase_lm_train_families(gen)
    kernels["flash_attention"]["max_abs_err"] = max(
        kernels["flash_attention"]["max_abs_err"], flash_bwd19["max_abs_err"])
    kernels["flash_attention"]["recompute_rows"] += flash_bwd19["rows"]
    phase("phase 20: report")

    line = {"kernels": []}
    for name, k in KERNELS.items():
        at32 = kernels[name]["rows"][0]
        by_path = {"serve": served["launches"][name],
                   "train_sparse": trained["sparse"]["launches"][name],
                   "train_dense": trained["dense"]["launches"][name],
                   "serve_cached": cached["launches"][name],
                   "online": online["launches"][name],
                   "serve_fixed": fixed["launches"][name],
                   "serve_flat": fixed["flat"]["launches"][name],
                   "pipelined": fixed["pipelined"]["launches"][name],
                   "train_fixed": trained_fixed["launches"][name],
                   "serve_tiered_int4": tiered["int4"]["launches"][name],
                   "serve_tiered_host": tiered["host"]["launches"][name],
                   "online_tiered": online_t["launches"][name],
                   "graphed": graphed["launches"][name],
                   "lm_prefill": lm["launches"][name],
                   "serve_het_fp": het["fp"]["launches"][name],
                   "serve_het_mixed": het["mixed"]["launches"][name],
                   **{f"train_het_{m}": het["train"][m]["launches"][name]
                      for m in ("sparse", "dense")},
                   "serving_plane": plane["launches"][name],
                   "fleet": fleet["launches"][name],
                   "fleet_group_trainer":
                       fleet["group_trainer"]["launches"][name],
                   "lm_train": lm_train["launches"][name],
                   "sharded": sharded["launches"][name],
                   "sharded_mesh2d": sharded["mesh2d"]["launches"][name],
                   "lm_mesh2d": sharded["mesh2d"]["lm"]["launches"][name],
                   "lm_moe_mesh2d":
                       sharded["mesh2d"]["lm_moe"]["launches"][name],
                   "lm_families": lm_fam["launches"][name],
                   "lm_families_15c": lm_rec["launches"][name],
                   "lm_train_families": lm_fam_train["launches"][name]}
        line["kernels"].append({
            "name": name, "route": "cuda", "source": k["source"],
            "replaces": k["replaces"],
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": kernels[name]["max_abs_err"],
            "ms": at32["ms"], "plain_ms": at32["plain_ms"],
            "bound_ms": at32["bound_ms"], "bound_by": at32["bound_by"],
            "library_ms": at32["library_ms"],
            # the cached and int4 kernels: the bound with one row read
            # per position; the int4 kernel: the labelled reference point
            # (F.embedding_bag over the dequantized table), not a library
            # call of the same function
            **{k: at32[k] for k in ("bound_per_position_ms",
                                    "reference_point_ms") if k in at32},
            # interaction: the row above is the TPU kernel's function, the
            # full X X^T beside bmm; the main path runs the stage, one
            # launch each way, beside the five-op composition it replaced
            **{r["what"].replace(" ", "_"): {
                k: r[k] for k in ("ms", "device_ms", "plain_ms",
                                  "plain_device_ms", "bound_ms", "bound_by",
                                  "kernels", "composition_kernels")}
               | {"composition_ms": r["library_ms"],
                  "composition_device_ms": r["library_device_ms"]}
               for r in kernels[name]["rows"]
               if r.get("what", "").startswith("stage")
               and r["samples"] == BUCKET},
            # flash_attention: the op's backward, a recompute through the
            # chunked attention (no kernel of its own), at each length
            # (15(a)) and at each family's heads (19(a))
            **({"backward": [{k: r[k] for k in (
                "what", "shape", "causal", "window", "ms", "device_ms",
                "forward_backward_ms",
                "forward_backward_device_ms", "library_ms",
                "library_device_ms", "bound_ms", "bound_by",
                "forward_backward_bound_ms")}
                for r in kernels[name]["recompute_rows"]]}
               if "recompute_rows" in kernels[name] else {}),
            # flash_attention at kimi-k2's hd 112 (phase 17), padded to
            # depth 128: its times and the padding copies'; at
            # recurrentgemma-9b's hd 256 and seamless-m4t's encoder (phase
            # 18)
            **{key: [{k: r[k] for k in (
                "what", "shape", "ms", "device_ms", "single_ms",
                "cold_l2_ms", "device_tflops", "plain_ms", "library_ms",
                "library_device_ms", "bound_ms", "bound_by",
                "kernel_device_ms", "pad_device_ms") if k in r}
                for r in kernels[name][f"{key}_rows"]]
               for key in ("hd112", "hd256")
               if f"{key}_rows" in kernels[name]}})
    if args.out is not None:
        args.out.write_text(json.dumps(
            {"card": card, "kernels": kernels, "serve": served,
             "serve_cached": cached, "train": trained, "online": online,
             "serve_fixed": fixed, "train_fixed": trained_fixed,
             "serve_tiered": tiered, "online_tiered": online_t,
             "graphed": graphed, "lm": lm, "het": het, "plane": plane,
             "fleet": fleet, "lm_train": lm_train, "sharded": sharded,
             "lm_families": lm_fam, "lm_recurrent": lm_rec,
             "lm_train_families": lm_fam_train},
            indent=1))
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.") or m == "repro"
                    or m.startswith("repro."))
    if leaked:
        fail(f"imported the JAX side: {leaked[:5]}")
    print(f"== chip_smoke.py took {time.perf_counter() - t_start:.1f} s on "
          f"{card['nvidia_smi']}")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
