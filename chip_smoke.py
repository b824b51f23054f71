#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card and nvcc

It imports only ``repro_torch`` (from ``src/`` beside this file) and
exits non-zero on any failure.  Phases, each printing one JSON line:

1. ``device``     the card's name and power limit; fails without CUDA.
2. ``kernel_cases``  builds ``csrc/cutjoin.cu``, ``csrc/trijoin.cu``,
   ``csrc/matreduce.cu``, ``csrc/bitset.cu`` and ``csrc/flashattn.cu`` (one
   nvcc each, started together) and holds each kernel against its plain
   PyTorch version on the card: the join kernels (vector, pair, tri, and the
   keep forms of pair and tri) at n = 8192 (the tri join's dense route at n
   = 256, keep forms also at n = 512), over factor counts, kept axes,
   rectangular slices with offsets, axis-subset mixes and chunk sizes 8 /
   128 / 1024; K1's one-launch entry at odd lengths, unaligned and strided
   starts, one CTA and a capped grid, each twice (the ticket counter is
   reset by the launch); K3 on both entries (``keep_entry``: the row entry
   where the reduced axis has unit stride, the strided template
   otherwise) over row- and column-major factors, odd rows and column
   slices; the f64 instances of K1 and K3 at n = 8192 with Π max about
   2^33 against their f64 plain versions and against an int64 join of the
   same factors.  A scalar tri join runs on the route ``tri_route`` gives its
   mix — path, triangle or dense — and is held against the n^3 plain
   version and, on the path and triangle routes, against the route's own
   plain version (at n = 8192 the unmasked and sliced cases against the
   route's alone, and the same cases at n = 1024 against both); the keep
   form takes the dense route on every mix, by the entry ``tri_keep_entry``
   picks (the slab entry unless the kept axis has unit stride);
   the masked matrix-product reduce (K6) and SDDMM (f32 and bf16) on 0/1
   inputs, ragged shapes, strided views and the R-MAT adjacency included,
   both on their tensor-core routes (the flag each leaves on the card must
   admit them and equal ``sddmm_exact_plain``; the R-MAT call's tile
   occupancy must equal ``sddmm_occupancy_plain``), and both at the exact
   route's edges (±256 at K = 256, empty tiles under -0.0 mask cells,
   negative operands, K = 257 on the FMA route); K6's tile list on random
   0/1 stacks with ragged lists (tensor cores; tiles of 100 padded to 128)
   and on a stack holding 2.5 (FMA route, the flag read back); the
   bitset kernels: both intersect entries on random words (bit 31 set in
   about half), word and row counts that are no multiple of 32 or of a
   thread block's rows, and the packed R-MAT adjacency; ``bitset_pack``
   on the R-MAT adjacency and on odd n, unaligned rows, uint8 entries
   other than 0/1, a column slice and f32 input; ``bitset_edges`` on
   sorted lists with a 2000-edge star and runs that straddle its 8-edge
   chunks at the widths of its vector entry's four instances, on random
   unsorted pairs, on its word entry (W = 37, strided views), with the
   entry each call takes asserted, and pairs on the card with one outside
   the table, which must raise ``ValueError``.  Tolerance: none — the difference must be 0
   (integer-valued inputs within the exactness guard).  On random input the
   masked matrix-product reduce (FMA route) is held against an f64
   product with the reference package's tolerance, |got - want| < 3e-2 ·
   |want| + 1, and
   SDDMM (f32 on its FMA route, bf16 on the tensor cores) per cell with
   2e-4 (f32) or 2e-2 (bf16), relative and absolute —
   except f32 at K = 8192, held to the f32 dot-product rounding bound γ_K ·
   Σ_k |l_k r_k|.  Flash attention (K9) in f32 and bf16, causal and full, D
   = 64 and 128, ragged and unequal sequence lengths, strided views, views
   that TMA cannot read in place (copied first in bf16) and the serving
   shape (1, 4096, 32, 128) and B·H = 65600 (more than grid axis y takes)
   in f32 and in bf16 (two query tiles a pair, 131 200 CTAs of the bf16
   kernel's linear grid); at deepseek-v3's (Dq, Dv) = (192, 128) both
   types, causal and full, ragged and unequal lengths, strided views and
   the MLA prefill shape (1, 4096, 128, 192 / 128), launched twice (the
   same bits) (SDPA's backend printed; V zero-padded
   to 192 where no fused backend takes Dv != Dq); against its plain
   version with the reference's tolerance,
   2e-5 (f32) and 3e-2 (bf16) relative and absolute, and in bf16 against the
   f32 plain version within one rounding to bf16, a check that
   scaled_dot_product_attention (bf16 P) must fail at the serving shape; the
   largest differences are printed beside them.  Each case launches K9
   again with the row statistic K9-bwd reads, lse: the output must be the
   same bits and lse within 2^-19 · max(1, |lse|) of the plain forward's.
   K9-bwd
   (``csrc/flashattn_bwd.cu``, built with the rest) in f32 and bf16, D = 64
   and 128, causal and full, lengths that are no multiple of its 64- and
   128-row tiles (S = 129 among them), B·H = 65600 in f32 and in bf16 (S
   = 65, all on grid axis x) and a bf16 grid
   of more CTAs than 4 per SM, q, k, v and dO read by strides (dO also
   broadcast over the heads, read in place in f32 and copied for TMA in
   bf16, and D-strided, which is copied), and the two training shapes,
   (8, 1024, 10, 64) f32 and (1, 4096, 32, 128) bf16 causal, each launched
   twice (the gradients must be the same bits); the same at deepseek-v3's
   (Dq, Dv) = (192, 128) in both types (causal and full, S = 1, 77 and
   129, (B, H, S, D) storage, sliced views, a dO TMA cannot read, copied)
   and its training shape (1, 4096, 128, 192 / 128) bf16, launched twice,
   on the kernel's own forward output and lse, which are held to the plain
   forward's first (lse with a floor of 4 times the plain f32 version's
   own lse error against an f64 logsumexp); the gradients against the plain backward run from the
   plain forward's o and lse (nothing the kernels wrote), per gradient
   max|Δ| <= 1e-4 · max|plain| in f32 and the reference's 3e-2 +
   3e-2·|plain| in bf16; and against the plain version in f32 on the
   kernel's inputs, o and lse, 1e-4 · max|plain f32| plus in bf16 one
   rounding, 2^-8·|plain f32|; each f32 bound plus a floor of 4 times the plain f32
   version's own largest error against it in f64 (a gradient that is 0 in
   exact arithmetic, as dQ and dK at S = 1, leaves only rounding noise).  The plain backward is held to ``torch.autograd.grad``
   of the plain forward on the card, and a loss through
   ``flash_attention`` on tensors that require grad must launch K9 and
   K9-bwd once each (``FlashAttention``) with the direct call's gradients.
3. ``main_path``  ``compile(patterns, graph)`` on ``rmat(13, 24.0, seed=0)``
   (8192 vertices, about 10^5 edges, skewed degrees: the user's graph),
   then the same call on a *coverage graph*, ``erdos_renyi(8192, 24.0,
   seed=0)`` (same size, uniform degrees).  The coverage graph is not
   claimed to be what users bring: it is there because on it the cost
   model cuts chain(5) three ways and every join is precertified, so the
   entry points reach all three kernels.  Each graph: ``.counts()`` twice,
   a second compile that hits the plan cache; every count is checked
   against the f64 dense route (``cutjoin_kernel=False``; where that route
   refuses a |cut| = 3 join as too wide, against the direct Möbius count
   of ``CountingEngine.edge_induced``), and ``cycle(4)`` against the closed
   form (tr(A^4) - 2 Σd² + Σd) / 8.  Launches are reported per graph;
   which joins the R-MAT graph leaves to the dense route is said plainly:
   each join the f32 guard refuses takes the f64 instance of its kernel
   (route ``kernel-f64`` for |cut| = 1) where ``exact_f64`` admits its
   factors, computed here from the plan's own factors, else the dense
   route.
   Then ``compile([cycle(4), cycle(5), cycle(6)], g)`` on the coverage
   graph (role ``coverage-cycles``): the cost model cuts cycle(5) and
   cycle(6) three ways into three pair factors, one on each pair of cut
   axes, the triangle route's mix, and checks as above (cycle(5) and
   cycle(6) against ``edge_induced``).  On the R-MAT graph the same joins
   are chosen but the guard refuses them, and the dense route cannot hold
   n^3 cells, so the cycles are not driven there.  Every tri join is
   printed with its factors' axes and its route; the coverage graph's
   chain(5) join must take the path route and the cycles' joins the
   triangle route.
4. ``local_path``  the partial-embedding API on the same two graphs, each
   reusing its APCT and its plan cache from phase 3:
   ``compile(patterns, g, local=True, use_pallas=True)`` (a cache miss
   that recompiles with the union of flags), then per pattern every
   anchored vector (``local_counts(p, rep)`` per orbit), the API reads
   ``vertex_counts(p, g, top_k=10)`` and ``exists(p, g)``, and one
   unanchored |cut| = 2 tensor; then ``compile(..., domains=True)`` (a
   second union recompile) for ``mini_support`` and the domain vectors.
   Domains come in a compile of their own because with domain nodes in
   the plan the cost model serves every anchored vector as the flat
   Möbius combination those nodes hold, and no anchored join is chosen.
   Checks: Σ of each anchored vector = count · |Aut|, Σ vertex_counts =
   n_p · count, each anchored vector equal to the same plan's dense f64
   route (``cutjoin_kernel=False``) and to the domain vector of its
   orbit, and the triangle count through the fused kernel equal to
   phase 3's clique enumeration.  Each keep join the f32 guard refuses
   must take ``kernel-keep-f64`` where ``exact_f64`` admits it (on R-MAT
   the f64 instance of K3 must launch); after the phase's launches are
   read, each such join is timed on the plan's own factors on that
   instance and on the dense f64 route it replaced, vectors equal.  An
   anchored
   vector whose flat Möbius route needs an n^3 free-hom intermediate
   (the 4-clique's at n = 8192) raises ``PlanTooWide``; that refusal is accepted, and reported, only
   where ``CountingEngine.inj_free`` refuses the same vectors.  Then a
   *coverage case* for the keep form of the tri join,
   ``erdos_renyi(512, 8.0, seed=0)`` with anchored reads of chain(6),
   cycle(6) and the house (anchored |cut| = 3 candidates need n^3 within
   the budget, so n <= 512), checked against ``CountingEngine.inj_free``
   and the dense f64 route; its tri joins are printed with their axes,
   routes and entries (anchored joins carry every factor over the whole
   cut, so they take the dense route; the slab entry must run, and the
   launches per entry must match the entries recorded).
5. ``graph_ops``  the graph kernels through ``kernels.ops`` on the R-MAT
   graph: ``common_neighbors(A, g.edges)`` (the bitset kernel, rows
   gathered in the kernel) summed is 3 T, ``sddmm(A, A, A)`` read at each
   edge equals it, its sum is 6 T, T being phase 3's triangle count and
   ``triangle_count(A)``'s (K6); SDDMM and K6 must take their tensor-core
   routes, and the tiles SDDMM skipped are printed.  ``common_neighbors``
   runs under ``torch.cuda.set_sync_debug_mode("error")`` (no
   synchronising call) and must launch ``bitset_pack`` and
   ``bitset_edges`` once each; it is then split into its pieces (upload,
   packing, host check, kernel), beside the pieces of its earlier design
   (a blocking upload, packing in PyTorch, a check with two host syncs).
5b. ``morph_path``  the morph count store on the R-MAT graph with phase
   3's APCT: a ``CountStore`` under ``build/morph_store`` warmed by
   ``compile(..., morph=store)`` of the 3-star and the diamond (which
   must launch a join kernel), then every ``motif_family(4)`` member
   compiled with ``morph=`` in turn (at least one on the fast path, at
   least one searched with the held homs in its plan priced at 0), then
   the family again from a fresh ``CountStore`` on the same directory:
   every member on the fast path, no contraction (``hom_evals`` 0) and no
   kernel launch.  Every count equals the family compiled with
   ``morph=False``; the time to answer the family from the store is
   printed beside that compile and count.
5c. ``batcher_path``  the paper's serving loop, ``PatternQueryBatcher(g,
   max_batch=8, morph=<a fresh disk CountStore in a temporary directory
   under build/>)`` on the R-MAT graph with phase 3's APCT: a seeded
   stream of 18 requests in three steps (each 4-vertex motif counted
   alone, twice; chain(4) and cycle(4) together, twice; chain(4)'s
   anchored vectors at anchors 0 and 1; its 10 hottest vertices, twice),
   with launch counts set to 0 before the stream and read after it (a
   join kernel must launch); then 6 requests on ``rmat(13, 24.0, seed=0,
   num_labels=2)`` through a batcher of its own (the MINI supports of
   two labelled patterns, four times, and their counts, twice: a
   plan-cache hit on the domains plan).  Every answer is held
   integer-equal to the same pattern set compiled outside the batcher
   (no store, no cache, an engine of its own) and read by
   ``CompiledPlan.count``, ``local_counts``, ``mini_support`` and
   ``top_vertices(plan_vertex_counts(...))``; the stats must show no
   fallback and no error.  Reports seconds per step and per request,
   the stats and the launches per kernel.
6. ``mine_path``  ``repro_torch.launch.mine.main`` as a user runs it, on
   ``--graph rmat --n 8192 --deg 24`` (phase 3's graph), stdout captured:
   ``motif --k 4`` equal line for line to ``--no-compiler``; ``chain --k 5
   --local-counts`` equal to phase 3's chain(5) count and its hottest
   vertices to ``api.vertex_counts(top_k=10)``; ``pc --k 4
   --local-counts`` against ``mine_pseudo_cliques`` (Σ per_vertex = Σ n_p
   · totals); ``existence --k 5`` with and without ``--local-counts``;
   ``fsm --labels 6 --k 3`` compiled equal to ``--no-compiler`` over at
   least two levels; ``motif --k 4 --trace FILE`` equal line for line to
   the untraced run (and timed beside a second untraced run, both hits in
   the plan cache), and its trace read back: root spans and node
   coverage, the ten spans with the largest self time (kind, cut size,
   route), every join span's route equal to its plan's ``join_log``
   record, and ``obs.drift``'s report per node class × cut size ×
   route.  Then ``triangle_count_blocksparse(use_kernel=True)``
   = T with one call of K6's tile list over every output tile (one launch
   of each of its three entries, tensor-core route, no per-tile sync), and
   ``hom_oriented`` against ``hom_count`` (a clique orbit) and against
   the distinct-endpoint count (an independent orbit).
6b. ``mesh_path``  the sharded tier on the one card: the main path's
   pattern set on both graphs of phase 3 (and the coverage graph's
   cycles), then the local path's anchored reads (and its keep3 coverage
   case), at ``data_mesh(4, device="cuda")`` and ``data_mesh(3, ...)``
   (3 does not divide n = 8192: padding and trim), each graph on one
   mesh-bound engine.  Every slot is the same H100, so the times measure
   slicing and the slots' f64 sums, not scaling.  Checks: every count and
   vector ``==`` phase 3's and phase 4's, no dense adjacency built by a
   mesh engine, every join the guard granted on ``kernel-sharded`` /
   ``kernel-sharded-keep``, every refused |cut| = 1 join or |cut| = 2
   keep join that ``exact_f64`` admits on ``kernel-f64-sharded[-keep]``
   (the f64 instances of K1 and K3 on each slice) and every other one on
   ``dense-f64-sharded`` / ``dense-f64-sharded-keep``;
   ``CountingEngine(mesh=).hom_free_tensor`` equal to one device's; ``PatternQueryBatcher(mesh=)`` fanning four
   requests over the slots with phase 3's counts; ``mine --mesh 4`` line
   for line equal to phase 6's ``motif --k 4`` after its ``mesh:`` line.
   Launch counts are set to 0 before and read after; K1, K2, K3, K4,
   K4-keep and the f64 instances of K1 and K3 must each launch.  The
   contraction's gathers over the same span are printed
   (``contract.finish_gathers``, ``contract.trim_gathers``,
   ``contract.slice_gathers``: a free tensor copied whole, which only a
   tri join's factor without cut axis 0, a route that needs it whole, or
   a caller of ``hom_free_tensor`` asks for).  Then, outside the count,
   the last slot call of each tile entry point per kernel, route, entry
   and instance (a non-zero global offset) runs again and is held to its
   plain version at difference 0, ``MeshExecutor.join_batch`` is held to serial K2 joins,
   and compile + first ``counts()`` on R-MAT are timed at 1, 3 and 4
   slots, split by node kind.
6c. ``examples``  every ``examples_torch/*.py`` on the card as its user
   starts it, three subprocesses at a time; each must exit 0.
7. ``serve_path``  the LM serving path at full width: qwen3-4b unreduced
   (36 layers, d_model 2560, 4 022 468 096 parameters in bf16, random
   weights drawn on the card from a seed) behind
   ``ContinuousBatcher(cfg, params, slots=4, capacity=4224)``, six
   requests of 2048, 4096, 3072, 2048, 512 and 4096 tokens, 16 new tokens
   each.  Checks: all six finish with 16 tokens; K9 launched exactly
   36 × 5 = 180 times (every attention layer of every prefill longer than
   the flash block, 1024) and no other kernel; for the 2048- and
   512-token requests and a 12-token prompt, prefill + one decode step
   against the full forward of the same tokens (``SERVE_LOGIT_TOL``,
   bf16, argmax equal; the 12-token decode one position early must miss
   it); four more requests through the same batcher, each decode step
   run eagerly and by the captured CUDA graph in turns on the same cache
   state (tokens equal; the largest logit difference and both step
   medians printed); K9 on the path's own layer-0 q, k, v against an f64
   oracle (``flash_path_check``, which also reports K9's mean relative
   bias); then
   ``repro_torch.launch.serve.main([])`` at its own flags (reduced
   config, 12 requests, 144 tokens).  Reports seconds per admission,
   median decode step (graphed), tokens per second and peak device
   memory.
7a. ``moe_serve_path``  the MoE serving path, after qwen3-4b's parameters
   and caches are released: dbrx-132b at its published widths (16
   experts, top-4, d_expert 10752, d_model 6144, 48 heads, 8 KV heads),
   8 of its 40 layers — 27 305 809 920 bf16 parameters, equal to the
   config's ``param_count()``, drawn on the card from a seed — behind the
   same batcher, slots, capacity and six prompts.  Checks: all six finish
   with 16 tokens; K9 launched exactly 8 × 5 = 40 times and no other
   kernel; each prefill's dropped (token, choice) pairs per layer and
   smallest top-k margin printed (capacity 1.25, the reference's: pairs
   past C drop); K9 on the path's own layer-0 q, k, v held to an f64
   oracle (``flash_path_check``); decode against the forward for the
   2048- and 512-token requests and the 12-token prompt on a capacity
   that drops nothing (factor E / k, so both runs compute one function),
   with 0 drops asserted in every run, the dense-route prefill held, and
   tokens that a run routes to other experts than the forward reported
   (each flip must be explained by the runs' router-logit drift; a
   prefill or decode step is held to ``SERVE_LOGIT_TOL`` where none of
   its tokens flipped, and some decode step must be); graphed against
   eager decode steps; ``repro_torch.launch.serve.main(["--arch",
   "dbrx-132b"])`` at its own reduced flags.  Reports ``init_s``, seconds
   per admission, median decode step graphed and eager beside the bytes
   of weights one step reads (every expert) and their time at 3.35 TB/s,
   tokens per second and peak device memory.
7b. ``train_path``  the training path, after serving's parameters and
   caches are released; launch counts set to 0 before it.  (1) The CLI as
   users start it: ``repro_torch.launch.train.main(["--arch",
   "repro-100m", "--steps", "30", "--batch", "8", "--seq", "1024",
   "--ckpt-dir", <build/train_*>, "--ckpt-every", "10"])`` — the full
   config, f32, flash block 512, so K9 f32 runs at D = 64 — every loss
   finite and the last 0.2 or more below the first; then ``--steps 35`` in
   the same directory, which must print ``resumed from step 30``, with the
   restored state equal bit for bit to the step-30 files.  (2) One step
   at that shape with the counts set to 0 before it: exactly 20 K9
   launches (10 layers, forward and remat's recompute) and 10 K9-bwd.
   (3) qwen3-4b at its published widths and full depth (4 022 468 096
   bf16 parameters drawn on the card from a seed), ``OptConfig()`` (f32
   moments), three steps at batch 1 x 4096: finite losses, 72 K9 and 36
   K9-bwd launches per step, seconds per step (median of steps 2 and 3),
   tokens per second and peak device memory; then a fourth step runs
   under ``torch.profiler`` with CUDA activity (the tracer doubles the
   step's host-clock time, so it stays out of the median), and its device
   time by kernel name (the top 10), K9-bwd's share of it, and that device
   time over the unprofiled median step are printed on a line of their own
   (``train_step_profile``).  (4) One step of reduced
   qwen3-4b (f32, head dim 64, S = 64 past its flash block of 32) from one
   state on the card and on the CPU: loss, ce, lr, grad_norm, gradients
   and updated leaves within ``tests/test_torch_train.py``'s tolerances;
   the same for reduced dbrx-132b (the MoE step), each bound plus a floor
   of 4 times how far the CPU's own step moves when its weights move one
   ulp (``TRAIN_FLOOR_TIMES``).
   (3b) deepseek-v3-671b at its published widths cut to its 3 dense-prefix
   layers (MLA with 128 heads of 128 + 64 / 128 and the dense MLP of ff
   18432: 3 603 815 424 bf16 parameters drawn on the card from a seed, f32
   moments, about 43.2 GB of state; one MoE layer more would be 181 GB),
   three steps at batch 1 x 4096: finite loss and grad norm, 6 K9 launches
   (each at (4096, 128 heads, 192 / 128)) and 3 K9-bwd per step, seconds
   per step (median of steps 2 and 3), tokens per second, peak memory.
   (5) The gradients of reduced qwen3-4b at the big steps' attention —
   bf16, head dim 128, 2 x 256 tokens — on the card against the CPU in f32
   on the same weights widened: per leaf 3e-2 · max|f32| plus 4 times the
   CPU's own bf16 step's error against the f32 one.
7c. ``ssm_serve_path``  the Mamba2 serving path, after serving's
   parameters are released: mamba2-1.3b at its published widths and full
   depth (48 'M' layers, d_model 2048, 64 heads of 64, state 128,
   1 343 740 928 bf16 parameters drawn on the card from a seed) behind
   ``ContinuousBatcher(slots=4, capacity=4224)``, prompts of 4096, 3000
   (no multiple of the 256-token SSD chunk: the padding runs at full
   width), 1024, 512 and 12 tokens × 16 new tokens.  Checks: all five
   finish with 16 tokens; no kernel launches (no attention; the SSD scan
   has no TPU kernel); graphed against eager decode steps on four more
   requests, the cache copied before the first run and put back before
   the second (a Mamba step advances its state), tokens equal and the two
   new states compared; decode against the forward for the 3000- and
   512-token requests (``SERVE_LOGIT_TOL``, argmax equal); then
   ``launch.serve.main(["--arch", "mamba2-1.3b"])`` at its own flags.
   Reports seconds per admission, the median decode step graphed and
   eager beside its bytes (weights, and every slot's state read and
   written) at 3.35 TB/s, tokens per second and peak device memory.
7d. ``vlm_serve_path``  the VLM serving path: llama-3.2-vision-11b at its
   published widths and full depth (32 self-attention and 8 gated
   cross-attention layers, 9 775 157 264 bf16 parameters), its gates
   drawn non-zero (``open_gates``: the reference's zeros would let a
   broken cross-attention pass), one seeded (1, 1600, 4096) bf16 image per
   request.  ``serve.engine``'s prefill step on prompts of 2048 and 512
   tokens (K9 exactly 32 times on the first, never on the second, counts
   read per prefill), spliced into a two-slot cache, then 16 decode steps
   through ``GraphedDecode`` around ``make_decode_step``, each also run
   eagerly on the same cache state (tokens equal, no launch); decode
   against the forward for both prompts given their images on the dense
   route (``check_decode(dense_route=True)``; no qk-norm, so the K9
   prefill is printed as ``served_route``), and K9 on the path's own
   layer-0 q, k, v against an f64 oracle (``flash_path_check``).  Reports
   prefill seconds, the median decode step graphed and eager beside the
   parameters' bytes at 3.35 TB/s (5.84 ms) and the step's own bytes, and
   peak device memory.
7e. ``hybrid_card_vs_cpu``  reduced jamba-1.5-large-398b ('M', 'A' and MoE
   slots) and reduced llama-3.2-vision-11b ('A' and 'X' slots, gates
   opened), head dim 64, f32: a 64-token prefill (K9 on the card), every
   cache leaf and one decode step (``serve_card_vs_cpu``), and one
   training step (``card_vs_cpu_step``, image embeddings in the VLM's
   batch), card against CPU, each bound 1e-4 of the CPU's largest entry
   plus 4 times the CPU's own shift when its weights move one ulp.  jamba
   runs on the card only reduced: one period of its layer pattern is 8
   layers, 90.49 GB in bf16 at its published widths.  Reduced
   deepseek-v3-671b with its published MLA head dims is served and
   trained the same way (K9 and K9-bwd f32 at (192, 128), a dense and an
   MoE layer); at published widths its MoE layers train on the card only
   reduced.
7f. ``mla_serve_path``  the MLA serving path, after the VLM's parameters
   are released: deepseek-v3-671b at its published widths (MLA: q_lora
   1536, kv_lora 512, 128 heads, q and k 128 + 64 rope columns, v 128;
   256 experts of 2048, top-8, one shared), 5 of its 61 layers (3 dense,
   2 MoE; 26 618 387 456 bf16 parameters drawn on the card from a seed)
   behind ``serve_path``'s batcher, slots, capacity and six prompts.
   Checks: all six finish with 16 tokens; K9 launched exactly 5 × 5 = 25
   times, at (Sq, 192, 128) in every layer of every prefill over 1024
   tokens, and no other kernel; graphed against eager decode steps;
   decode against the forward for the 512-token request and a 12-token
   prompt on a capacity that drops nothing (as ``moe_serve_path``),
   reported in bf16 (256 experts tie in bf16 router logits: some token
   flips in every run, each flip explained by the runs' logit drift)
   and held in f32 at the published widths on 4 layers (3 dense, 1 MoE,
   60.44 GB; the 12-token decode one position early must miss); K9 on
   the path's own layer-0 q, k, v against an f64 oracle
   (``flash_path_check``); ``serve.main(["--arch", "deepseek-v3-671b"])``
   at its own reduced flags.  Reports ``init_s``, seconds per admission,
   median decode step graphed and eager beside the bytes one step reads
   (weights and latent caches) at 3.35 TB/s, peak device memory.
7g. ``dryrun_path``  the dry run (``repro_torch.launch.dryrun``) beside
   what the card did, after ``hybrid_card_vs_cpu``; over every dry-run
   call ``torch.cuda.memory_allocated()`` and its peak must stay where
   they were after a ``gc.collect()`` (the dry run traces on meta
   tensors and allocates nothing).  (1) Every (arch, shape) cell built
   on both production meshes (16 x 16 and 2 x 16 x 16, device-free), no
   trace: 32 cells and 8 ``long_500k`` skips a mesh, each cell's
   per-device argument bytes printed.  (2) On a (1, 1) host
   mesh, traced at the shapes the card ran: qwen3-4b and deepseek-v3's 3
   dense layers trained at 1 x 4096, one microbatch, f32 moments — the
   argument bytes must equal the state and batch bytes ``train_path``
   allocated — and qwen3-4b decoding ``serve_path``'s 4 slots x 4224
   positions — the argument bytes must equal the parameters, the cache
   and the step's token and position arrays the batcher allocated.
   Reported beside them: the predicted peak against ``train_path``'s
   measured peak (and their ratio), and the counted FLOPs over the median
   step's seconds as TFLOP/s beside the card's 989, with the card's name
   and power limit; each of these one-device cells must price no
   collective and count per device what it counts in all.  (3) qwen3-4b
   ``train_4k``, deepseek-v3-671b ``decode_32k`` and mamba2-1.3b
   ``long_500k`` traced on the 16 x 16 mesh: per-device bytes, the
   collective term (link bytes per device, their count, ``t_collective``),
   the dominant of the three terms, the ops that fell back to gathers and
   the trace's seconds.  (4) The layout search
   (``distributed.autoshard.circulant_autoshard``) on qwen3-4b
   ``decode_32k``, 4 evaluations in one round, cached in a temporary
   directory: its history and best record on a line of its own; its wall
   seconds, the time this phase adds for it, must stay under 60.
7h. ``dense_serve_path``  after ``mla_serve_path``, once per dense config
   at its published widths and full depth, bf16 weights drawn on the
   card from a seed with ``param_count()`` asserted: deepseek-7b (30
   layers, 32 heads, KV = H), granite-20b (52 layers, 48 heads, one KV
   head: multi-query decode at 48 groups, GELU MLP, tied head) and
   command-r-35b (40 layers, 64 heads, 8 KV heads, tied 256 000-row head,
   RoPE theta 4e6), behind ``serve_path``'s batcher, slots, capacity and
   six prompts.  Checks: all six finish with 16 tokens; K9 launched
   exactly layers × 5 = 150, 260 and 200 times and no other kernel;
   graphed against eager decode steps (tokens equal); decode against the
   forward for the 2048- and 512-token requests and a 12-token prompt on
   the dense route, reported in bf16 (``bf16_decode_checks``) and held in
   f32 at published widths on ``DENSE_F32_LAYERS`` layers (30, 2 and 16:
   at random weights none meets the tolerance in bf16, and granite-20b's
   f32 forward is chaotic past 2 layers; ``f32_decode_checks`` reports
   each model's ``ulp_sensitivity``); K9 on the path's own layer-0 q, k, v
   against an f64 oracle (``flash_path_check``); ``serve.main(["--arch",
   <arch>])`` at its own reduced flags.  Reports seconds per admission,
   the median decode step graphed and eager beside the bytes one step
   reads (weights, the tied table whole, and K and V at capacity) at 3.35
   TB/s, tokens per second and peak device memory; ``wall_seconds``
   times each config apart.
7i. ``audio_serve_path``  musicgen-large at its published widths and full
   depth (48 layers, 32 heads and 32 KV heads of 64, 3 229 812 736 bf16
   parameters), whose inputs are frame embeddings, through
   ``serve.engine``'s steps (both batchers take token ids only): prefills
   of seeded (1, T, 2048) bf16 frames at T = 4096, 2048 and 512 (K9 at
   (64, 64) 48, 48 and 0 times, counts read per prefill), spliced into a
   three-slot cache, 16 decode steps through ``GraphedDecode`` on (3, 1,
   2048) frames — each the embedding-table row of the code the step
   before sampled — each run eagerly too (codes equal, no launch); K9 on
   layer 0's q, k, v against an f64 oracle; decode against the forward
   on the same frames (the 2048- and 512-frame prompts and a 12-frame
   one; reported in bf16, held in f32 at full depth).  Its layer-0 q, k, v feed K9's (64, 64) row of phase 8.
7j. ``lm_mesh_path``  the LM side of the mesh on slot meshes of the one
   card.  dbrx-132b's MoE layer at its published widths (d_model 6144, 16
   experts, top-4, d_expert 10 752, bf16, 6.34 GB of expert weights from a
   seed) on a (6, 512) batch: the einsum path, then expert parallelism
   under ``sharding_ctx`` on ``make_host_mesh((2, 4), ..., device=)``
   (full-mesh EP: 16 experts over 8 slots) and ``(3, 2)`` (the "ff"
   variant: experts over model, FFN columns over data), ``moe_apply_ep``
   called once each, the owners' weights views of the stacked leaves.  At
   capacity factor E / top_k no pair drops on either path and EP's output
   is held to the einsum path's within 3e-2 (relative, and of the
   largest: ``tests/test_torch_moe.py``'s bf16 tolerance); at the
   published 1.25 the drops of each path are printed, not compared.  Each
   path's ms and peak bytes beyond the weights, and the bytes its
   exchanges write, computed from the shapes (not measured).  Then qwen3-4b at published widths cut to 2 layers
   (``reduced``): ``init_state`` on the card, ``checkpoint.save``,
   ``elastic_reshard`` onto (4, 2) and (2, 4) slot meshes, every shard
   ``torch.equal`` to its slice of the saved leaf and the shards of a leaf
   views of one tensor; the state's bytes and the seconds of the save and
   of each restore.  No kernel of the port runs here: the reference's MoE
   and resharding have no ``pallas_call``.
Before phase 8 a ``wall_seconds`` line gives each phase's host-clock
seconds (the kernel builds inside ``kernel_cases``); after it
``wall_seconds_kernels`` gives phase 8's and the whole run's.
8. ``kernels``    per kernel entry (K1 and K3 in f32 and f64, K3 on both
   entries): launches over its path and, beside them, over phase 6b's
   (``launches_mesh_path``) (phase 3 for the scalar
   joins, phase 4 for the keep forms and the triangle kernel, phase 5 for
   SDDMM and the bitset kernels (``bitset_edges`` and ``bitset_pack``,
   each with its row), on each graph apart; phase 7 for K9 (beside it
   7a's, 7d's, 7h's and 7i's) and 7f for its second row, at (192, 128),
   7i for its third, at (64, 64); 7b for K9-bwd; the tri
   join in one row per route: path and triangle at n = 8192, dense at n =
   512, with ptxas's register and spill counts for the path and triangle
   kernels (the triangle row also with its kernel's device ms and the
   yardstick's cuBLAS kernel by name and device ms, ``tri_split``, in a
   process of its own, and its f64 mma instructions in the SASS by
   opcode, ``tri_sass``); the keep form on its one route, dense, at n =
   512, one row per kept axis with the entry it takes and ptxas's counts of the slab
   entry's instances; SDDMM with its route, skipped tiles, the dense
   bound at the bf16 tensor-core rate beside the f32 one, the times of
   prep and of the tensor-core kernel alone, and a second yardstick on
   the tensor cores; K6 likewise, its yardstick on the tensor cores with
   the f32 one beside it, and its tile list on the R-MAT graph's tiles
   with the bound of its tile products), error
   against the plain version, time, the plain
   version's time, the card's bound for the timed function and a PyTorch
   yardstick for it, at the shapes its path gave the kernel (K9: the path's
   own q, k, v of layer 0 of a 4096-token prefill; its bound takes P·V as
   two bf16 tensor-core passes, and its row carries ptxas's register and
   spill counts from this run's build; so do K1's and K3's line entries;
   K9-bwd: rows on phase 7b's own inputs, qwen3-4b's bf16 shape,
   deepseek-v3's bf16 (1, 4096, 128, 192 / 128) and repro-100m's f32
   one, and on phase 7e's reduced deepseek-v3 f32 step at (192, 128)
   (timed also at (1, 4096, 16, 192 / 128)), each launched twice with
   equal bits, bound five products ((3·Dq + 2·Dv)·H·S(S+1) operations)
   at the inputs' rate, beside it the design's own passes at its rate
   (bf16: ten tensor-core passes; f32: seven products in three TF32
   passes), ptxas's registers and spills for each of its kernels, yardstick
   the backward of scaled_dot_product_attention, its backend printed; the
   rows' mean relative bias per gradient against the plain version in
   f64 with lse taken in f64, within 1e-5, and on the kernel's lse, within
   1e-5 in f32 and reported in bf16).  A ``bf16_sum_bias`` line gathers the bf16
   tensor cores' bias: K9's mean relative bias against f64 on every
   serving path's layer-0 q, k, v (reported, not held) and K9-bwd bf16's
   per gradient on its two training rows.
   A call that ends in ``.item()`` is timed against a yardstick that ends
   in ``.item()`` too; K1 also through its device-tensor entry against
   bare ``torch.dot``, and its launch alone by CUDA events.
9. last line: ``{"ok": true, "device": {...}}``.

No phase catches a failure and carries on.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
             "is False")

from repro_torch import api, compiler, obs                  # noqa: E402
from repro_torch.compiler import lowering                   # noqa: E402
from repro_torch.compiler import morph as cmorph            # noqa: E402
from repro_torch.compiler.cache import graph_signature      # noqa: E402
from repro_torch.compiler.ir import Intersect, pattern_key  # noqa: E402
from repro_torch.core import homomorphism as H              # noqa: E402
from repro_torch.core import search, symmetry               # noqa: E402
from repro_torch.core.apct import APCT                      # noqa: E402
from repro_torch.core.blocksparse import (                  # noqa: E402
    GROUP, BlockSparseAdjacency, tile_lists, triangle_count_blocksparse)
from repro_torch.core.counting import CountingEngine        # noqa: E402
from repro_torch.core.homomorphism import PlanTooWide       # noqa: E402
from repro_torch.core.motifs import motif_patterns          # noqa: E402
from repro_torch.core.pattern import (Pattern, chain,       # noqa: E402
                                      cycle, pseudo_clique,
                                      tailed_triangle)
from repro_torch.distributed.cutjoin import MeshExecutor    # noqa: E402
from repro_torch.distributed.contract import Sliced        # noqa: E402
from repro_torch.distributed import autoshard               # noqa: E402
from repro_torch.distributed.meshes import (               # noqa: E402
    ShardedTensor, data_mesh, shard_slices, sharding_ctx)
from repro_torch.graph.generators import erdos_renyi, rmat  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro_torch.kernels import bitset as kbs               # noqa: E402
from repro_torch.kernels import build as kbuild             # noqa: E402
from repro_torch.kernels import flashattn as kfa            # noqa: E402
from repro_torch.kernels import matreduce as mr             # noqa: E402
from repro_torch.kernels import ops                         # noqa: E402
from repro_torch.kernels import sddmm as ksd                # noqa: E402
from repro_torch.launch import mine                         # noqa: E402
from repro_torch.launch import serve                        # noqa: E402
from repro_torch.launch import train as train_launch        # noqa: E402
from repro_torch.launch import dryrun                       # noqa: E402
from repro_torch.launch.mesh import (                       # noqa: E402
    make_host_mesh, make_production_mesh)
from repro_torch.configs.base import (                      # noqa: E402
    SHAPES, MLAConfig, cell_is_applicable, reduced_config)
from repro_torch.train import checkpoint as train_ckpt      # noqa: E402
from repro_torch.train import fault_tolerance as train_ft   # noqa: E402
from repro_torch.train import optimizer as train_opt        # noqa: E402
from repro_torch.train import train_step                    # noqa: E402
from repro_torch.train import tree as train_tree            # noqa: E402
from repro_torch.train.data import TokenPipeline            # noqa: E402
from repro_torch.models import moe as moe_mod               # noqa: E402
from repro_torch.models import transformer                  # noqa: E402
from repro_torch.models.params import leaves                # noqa: E402
from repro_torch.serve.batching import (                    # noqa: E402
    ContinuousBatcher, GraphedDecode, PatternQueryBatcher, PatternRequest,
    Request)
from repro_torch.serve.engine import (                      # noqa: E402
    make_decode_step, make_prefill_step)

DEV = torch.device("cuda")
N = 8192
# published peaks of one H100 SXM (NVIDIA data sheet): memory rate and the
# f32 rate outside the tensor cores, which is what the join kernels use
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
CUTJOIN_SOURCE = "src/repro_torch/kernels/csrc/cutjoin.cu"
TRIJOIN_SOURCE = "src/repro_torch/kernels/csrc/trijoin.cu"
MATREDUCE_SOURCE = "src/repro_torch/kernels/csrc/matreduce.cu"
BITSET_SOURCE = "src/repro_torch/kernels/csrc/bitset.cu"
FLASHATTN_SOURCE = "src/repro_torch/kernels/csrc/flashattn.cu"
# every tri join counts in mr.launches ("trijoin", "trijoin_keep"), and a
# scalar one also in mr.tri_routes by route ("trijoin_path", ...)
LAUNCH_TABLES = (mr.launches, mr.tri_routes, mr.join_entries,
                 mr.matreduce_entries, ksd.launches, ksd.entries,
                 kbs.launches, kfa.launches)
# the f64 instances of K1 and K3 are checked on factors whose product
# reaches about 2^33 (beyond the f32 guard's 2^24) against an int64 join
F64_HI = int(2 ** 16.5)
# the f64 tensor-core peak (NVIDIA data sheet), for the tri join's
# triangle route: the same 67 TFLOP/s as f32 outside the tensor cores
PEAK_F64_TC_OPS_PER_S = 67e12
# the bf16 tensor-core peak (NVIDIA data sheet, dense), for K9's bound:
# its S = QKᵀ multiplies bf16 inputs, and P·V the two bf16 terms of P
PEAK_BF16_TC_OPS_PER_S = 989e12
# the TF32 tensor-core peak (NVIDIA data sheet, dense), for K9-bwd f32's
# split-TF32 products
PEAK_TF32_TC_OPS_PER_S = 495e12
# exp2 results per clock per SM on the special-function units, compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput table); times the SM count and the card's maximum SM clock as
# nvidia-smi reports it in the run
SFU_EXP2_PER_CLOCK_PER_SM = 16
# K9 against its plain version: the reference's tolerance
# (tests/test_kernels.py), relative and absolute; in bf16 also against the
# f32 plain version on the same inputs within one rounding to bf16 (half
# an ulp: 2^-8 relative) plus the f32 tolerance
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
FLASH_ONE_ROUNDING = 2.0 ** -8
# deepseek-v3's latent attention runs K9 at (Dq, Dv) = (128 + 64, 128)
MLA_HEAD_DIMS = (192, 128)
# K9-bwd against its plain version, per gradient: in f32 max|got - plain|
# <= 1e-4 · max|plain| (f32 sums in another order: over a row of S
# products, and dS formed from P and dP); in bf16 the reference's 3e-2 +
# 3e-2·|plain|, and against the plain version in f32 on the widened inputs
# within one rounding to bf16 plus the f32 tolerance, 2^-8·|plain f32| +
# 1e-4 · max|plain f32|.  Beside each f32 bound, a floor of 4 times the
# plain f32 version's own largest error against the plain version in f64
# on the same inputs: where a gradient is 0 in exact arithmetic (S = 1:
# dS = dP - D cancels) max|plain| is rounding noise, and the relative
# bound says nothing
FLASH_BWD_TOL = 1e-4
FLASH_BWD_FLOOR = 4
# K9-bwd on a training path's own inputs: per gradient, the mean relative
# bias Σ(got − f64)·f64 / Σ f64² against the plain version in f64 on the
# same inputs with lse taken in f64 from q and k: K9's lse and K9-bwd
# together, as a step takes them.  A bias moves a model's gradient norm by
# as much, and the card-vs-CPU steps hold that norm to 1e-5 relative
# (``TRAIN_SCALAR_TOL``); per cell, ``FLASH_BWD_TOL`` of max|plain| hides
# it.  The bias against f64 on the kernel's own lse is held too in f32 and
# reported in bf16: there the tensor cores round the scores' f32 sums
# toward zero, K9's lse is taken of those sums (at deepseek-v3's scores,
# in the thousands, about 5e-4 low), and P from exact scores and that lse
# is not a softmax (PERF.md §6)
FLASH_BWD_BIAS_TOL = 1e-5
# K9's row statistic lse = m + log(max(l, 1e-20)), which K9-bwd reads,
# against the plain forward's: |Δ| <= 2^-19 · max(1, |lse|), a few ulps of
# |lse| (the row's f32 sum in another order; the bf16 kernel keeps m in
# the log2 domain and writes m·ln 2 + log l); in K9-bwd's checks plus
# ``FLASH_BWD_FLOOR`` times the plain f32 version's own error against an
# f64 logsumexp
FLASH_LSE_TOL = 2.0 ** -19
FLASHATTN_BWD_SOURCE = "src/repro_torch/kernels/csrc/flashattn_bwd.cu"
# the same work as a K9 or K9-bwd row of ``kernels`` in this many calls on
# as many head slices of the same tensors (``same_work_ms``)
SAME_WORK_CALLS = 4
HOUSE = Pattern(5, [(0, 1), (1, 2), (2, 3), (3, 0), (0, 4), (1, 4)])
# counts are exact: no TF32 in the plain versions' and yardsticks' products
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel."""
    out = {}
    for table in LAUNCH_TABLES:
        out.update(table)
    return out


def reset_launch_counts():
    for table in LAUNCH_TABLES:
        for k in table:
            table[k] = 0


@contextlib.contextmanager
def recording_tri_joins(log: list):
    """Every tri join the entry points run, as it reaches the wrappers:
    its factors' axes, kept axis, sizes, the route ``tri_route`` gives
    them and, for a keep join, the entry ``tri_keep_entry`` picks."""
    scalar, keep = mr.tri_reduce_tiles, mr.tri_reduce_keep_tiles

    def record(fn, kept):
        def call(factors, axes, **kw):
            keep = kw.get("keep") if kept else None
            log.append({"axes": [list(ax) for ax in axes], "keep": keep,
                        "n": kw["n"], "route": mr.tri_route(axes, keep)})
            if kept:
                log[-1]["entry"] = mr.tri_keep_entry(
                    factors, axes, keep, mr._tri_sizes(kw["n"]))
            return fn(factors, axes, **kw)
        return call

    mr.tri_reduce_tiles = record(scalar, False)
    mr.tri_reduce_keep_tiles = record(keep, True)
    try:
        yield log
    finally:
        mr.tri_reduce_tiles, mr.tri_reduce_keep_tiles = scalar, keep


def rmat_adjacency(g) -> torch.Tensor:
    """The graph's 0/1 adjacency as an f32 tensor on the card."""
    return torch.from_numpy(g.dense_adjacency(np.float32,
                                              pad=False)).to(DEV)


def timed_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs, by CUDA events,
    after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def int_factor(rng, shape, hi: int) -> torch.Tensor:
    """Seeded integer-valued f64 factor with entries in [0, hi]."""
    return torch.from_numpy(
        rng.integers(0, hi + 1, size=shape).astype(np.float64)).to(DEV)


def dev_factor(gen, shape, hi: int) -> torch.Tensor:
    """Seeded integer-valued f64 factor with entries in [0, hi], made on
    the card."""
    return torch.randint(0, hi + 1, shape, generator=gen, device=DEV,
                         dtype=torch.float64)


def max_abs_diff(got, want) -> float:
    diff = got - want
    if isinstance(diff, torch.Tensor):
        return diff.abs().max().item()
    return abs(diff)


def max_value(nf: int, block: int, cells: int = 1) -> int:
    """Largest per-factor magnitude hi for ``nf`` factors such that the
    guard admits chunk ``block`` (hi^nf * block <= 2^24) and the whole
    sum over ``cells`` cells stays an exact f64 integer (hi^nf * cells <=
    2^53)."""
    cap = min(mr.EXACT_LIMIT / block, float(1 << 53) / cells)
    hi = int(cap ** (1.0 / nf))
    while (hi + 1) ** nf <= cap:
        hi += 1
    while hi ** nf > cap:
        hi -= 1
    return max(hi, 1)


# -- phase 1 ------------------------------------------------------------------------

def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0))
    return smi


# -- phase 2 ------------------------------------------------------------------------

def check_case(kernel: str, name: str, run_kernel, run_plain, cases: list):
    before = launch_counts()
    got = run_kernel()
    torch.cuda.synchronize()
    assert launch_counts()[kernel] == before[kernel] + 1, \
        f"{name}: wrapper did not launch {kernel}"
    t0 = time.perf_counter()
    want = run_plain()
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    diff = max_abs_diff(got, want)
    value = got.sum().item() if isinstance(got, torch.Tensor) else got
    cases.append({"kernel": kernel, "case": name, "value": value,
                  "max_abs_err": diff, "plain_s": round(plain_s, 4)})
    if diff != 0:
        raise AssertionError(f"{name}: kernel and plain version differ by "
                             f"{diff!r}")
    return got


def route_plain(axes):
    """The plain version of the path or triangle route that a tri join of
    these axes takes (the dense route's is ``tri_reduce_plain``)."""
    return {"path": mr._tri_path_plain,
            "triangle": mr._tri_triangle_plain}[mr.tri_route(axes)]


def check_tri_case(name, fs, axes, sizes, cases, *, distinct=True,
                   offsets=None, keep=None, block=128, n3_plain=True):
    """A tri join on the card against the plain version of its route
    (path and triangle) and, with ``n3_plain``, against the n^3 plain
    version ``tri_reduce_plain`` / ``tri_reduce_keep_plain``: both at
    difference 0."""
    kernel = "trijoin" if keep is None else "trijoin_keep"
    route = mr.tri_route(axes, keep)
    label = f"{name} [{route}]"
    before = launch_counts()
    if keep is None:
        run = lambda: mr.tri_reduce(fs, axes, n=sizes, distinct=distinct,
                                    block=block, offsets=offsets)
        n3 = lambda: mr.tri_reduce_plain(fs, axes, n=sizes,
                                         distinct=distinct, block=block,
                                         offsets=offsets)
    else:
        run = lambda: mr.tri_reduce_keep(fs, axes, keep=keep, n=sizes,
                                         distinct=distinct, block=block,
                                         offsets=offsets)
        n3 = lambda: mr.tri_reduce_keep_plain(fs, axes, keep=keep, n=sizes,
                                              distinct=distinct, block=block,
                                              offsets=offsets)
    if route == "dense" or n3_plain:
        got = check_case(kernel, label, run, n3, cases)
    else:
        got = run()
    key = "trijoin_keep" if keep is not None else f"trijoin_{route}"
    counted = launch_counts()[key] - before[key]
    assert counted == 1, f"{label}: {counted} launches of the {route} route"
    if route != "dense":
        t0 = time.perf_counter()
        want = route_plain(axes)(fs, axes, sizes, distinct,
                                 offsets).sum().item()
        torch.cuda.synchronize()
        diff = max_abs_diff(got, want)
        cases.append({"kernel": kernel, "case": f"{label} vs route plain",
                      "route": route, "max_abs_err": diff,
                      "plain_s": round(time.perf_counter() - t0, 4)})
        if diff != 0:
            raise AssertionError(f"{label}: kernel and the {route} route's "
                                 f"plain version differ by {diff!r}")


def phase_kernel_cases():
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=DEV).manual_seed(0)
    t0 = time.perf_counter()
    mr._lib()                                # builds every csrc/*.cu
    build_s = time.perf_counter() - t0
    cases: list = []
    blocks = (8, 128, 1024)

    # K1: 1-4 vector factors
    for k in (1, 2, 3, 4):
        for block in blocks:
            fs = [int_factor(rng, (N,), max_value(k, block))
                  for _ in range(k)]
            check_case("vecjoin", f"vec k={k} block={block}",
                       lambda: mr.prod_reduce(fs, block=block),
                       lambda: mr.prod_reduce_plain(fs, block=block), cases)

    # K2: square, and a rectangular row slice with non-zero offsets
    for k in (1, 2, 3):
        for block in blocks:
            hi = max_value(k, block)
            fs = [int_factor(rng, (N, N), hi) for _ in range(k)]
            for distinct in (True, False):
                check_case(
                    "pairjoin",
                    f"pair square k={k} block={block} distinct={distinct}",
                    lambda: mr.prod_reduce(fs, distinct=distinct,
                                           block=block),
                    lambda: mr.prod_reduce_plain(fs, distinct=distinct,
                                                 block=block), cases)
            rows, start = 1000, 3001
            sl = [F[start:start + rows] for F in fs]
            check_case(
                "pairjoin", f"pair slice {rows}x{N} offsets=({start},0) "
                            f"k={k} block={block}",
                lambda: mr.prod_reduce(sl, block=block, offsets=(start, 0)),
                lambda: mr.prod_reduce_plain(sl, block=block,
                                             offsets=(start, 0)), cases)
            # K3 on the same factors: each kept axis, masked and not, and
            # the slice with offsets
            for keep in (0, 1):
                for distinct in (True, False):
                    check_case(
                        "pairjoin_keep",
                        f"pair keep={keep} k={k} block={block} "
                        f"distinct={distinct}",
                        lambda: mr.prod_reduce_keep(
                            fs, keep=keep, distinct=distinct, block=block),
                        lambda: mr.prod_reduce_keep_plain(
                            fs, keep=keep, distinct=distinct, block=block),
                        cases)
                check_case(
                    "pairjoin_keep", f"pair keep={keep} slice {rows}x{N} "
                                     f"offsets=({start},0) k={k} "
                                     f"block={block}",
                    lambda: mr.prod_reduce_keep(sl, keep=keep, block=block,
                                                offsets=(start, 0)),
                    lambda: mr.prod_reduce_keep_plain(
                        sl, keep=keep, block=block, offsets=(start, 0)),
                    cases)
            del fs, sl

    vec_and_keep_entry_cases(rng, gen, cases)

    # K4 on its three routes.  At n = 8192 the mixes of pair factors
    # (path: chain(5)'s (0,1)+(1,2), and with a vector; triangle: +(0,2),
    # the cycles' mix), each against the route's plain version and the n^3
    # plain version; then unmasked and an axis-0 slice with offsets,
    # against the route's plain version, and the same two at n = 1024
    # against the n^3 plain version too (cheap there), so that how the
    # route assigns factors to operands is held against an independent sum
    mixes = {
        "tri (0,1)+(1,2)": [(0, 1), (1, 2)],
        "tri (0,1)+(1,2)+(0,2)": [(0, 1), (1, 2), (0, 2)],
        "tri (0,1)+(1,2)+(2,)": [(0, 1), (1, 2), (2,)],
    }
    for label, axes in mixes.items():
        for block in blocks:
            hi = max_value(len(axes), block, N ** 3)
            fs = [int_factor(rng, (N,) * len(ax), hi) for ax in axes]
            check_tri_case(f"{label} n={N} block={block}", fs, axes,
                           (N, N, N), cases, block=block)
        check_tri_case(f"{label} n={N} distinct=False", fs, axes, (N, N, N),
                       cases, distinct=False, n3_plain=False)
        sl = [F[3001:4001] if 0 in ax else F for F, ax in zip(fs, axes)]
        check_tri_case(f"{label} slice (1000,{N},{N}) offsets=(3001,0,0)",
                       sl, axes, (1000, N, N), cases, offsets=(3001, 0, 0),
                       n3_plain=False)
        del fs, sl
        n4 = 1024
        fs = [int_factor(rng, (n4,) * len(ax), max_value(len(axes), 128,
                                                         n4 ** 3))
              for ax in axes]
        check_tri_case(f"{label} n={n4} distinct=False", fs, axes,
                       (n4,) * 3, cases, distinct=False)
        sl = [F[301:701] if 0 in ax else F for F, ax in zip(fs, axes)]
        check_tri_case(f"{label} slice (400,{n4},{n4}) offsets=(301,0,0)",
                       sl, axes, (400, n4, n4), cases, offsets=(301, 0, 0))
        del fs, sl
    # the triangle route with a vector on y and two factors on (0,1),
    # ragged sizes and offsets on every axis
    axes = [(0, 1), (0, 1), (1, 2), (0, 2), (1,)]
    sizes = (1000, 777, 333)
    fs = [int_factor(rng, tuple(sizes[a] for a in ax), 3) for ax in axes]
    for distinct in (True, False):
        check_tri_case(f"tri (0,1)x2+(1,2)+(0,2)+(1,) {sizes} "
                       f"offsets=(5,130,7) distinct={distinct}", fs, axes,
                       sizes, cases, distinct=distinct, offsets=(5, 130, 7))
    # the dense route: a full 3-D factor at n = 256 beside one, two and
    # three factors that span axes 0 and 1 (the kernel's compile-time and
    # run-time paths for such factors), masked and unmasked, and as an
    # axis-0 slice with offsets
    n3 = 256
    mixes3 = [[(0, 1, 2), (0, 2)], [(0, 1, 2), (0, 1), (1, 2)],
              [(0, 1, 2), (0, 1), (0, 1), (2,)]]
    for axes in mixes3:
        label = "+".join(str(ax).replace(" ", "") for ax in axes)
        for block in blocks:
            hi = max_value(len(axes), block)
            fs = [int_factor(rng, (n3,) * len(ax), hi) for ax in axes]
            for distinct in (True, False):
                check_tri_case(f"tri {label} n={n3} block={block} "
                               f"distinct={distinct}", fs, axes, (n3,) * 3,
                               cases, distinct=distinct, block=block)
            sl = [F[100:150] if 0 in ax else F for F, ax in zip(fs, axes)]
            check_tri_case(f"tri {label} slice (50,{n3},{n3}) "
                           f"offsets=(100,0,0) block={block}", sl, axes,
                           (50, n3, n3), cases, offsets=(100, 0, 0),
                           block=block)
            # K4's keep form on the same mixes, each kept axis
            for keep in (0, 1, 2):
                check_tri_case(f"tri keep={keep} {label} n={n3} "
                               f"block={block}", fs, axes, (n3,) * 3, cases,
                               keep=keep, block=block)
                check_tri_case(f"tri keep={keep} {label} slice "
                               f"(50,{n3},{n3}) offsets=(100,0,0) "
                               f"block={block}", sl, axes, (50, n3, n3),
                               cases, offsets=(100, 0, 0), keep=keep,
                               block=block)
    # K4's keep form on the pair-factor mixes at the coverage case's size
    # (the dense route, whatever the mix), against the n^3 plain version
    n5 = 512
    for label, axes in mixes.items():
        for block in blocks:
            hi = max_value(len(axes), block, n5 ** 3)
            fs = [dev_factor(gen, (n5,) * len(ax), hi) for ax in axes]
            for keep in (0, 1, 2):
                check_tri_case(f"{label} keep={keep} n={n5} block={block}",
                               fs, axes, (n5,) * 3, cases, keep=keep,
                               block=block)
    # surplus factors beyond the kernel's table are folded exactly
    fs = [int_factor(rng, (N,), 2) for _ in range(11)]
    check_case("vecjoin", "vec k=11 (surplus factors folded) block=8",
               lambda: mr.prod_reduce(fs, block=8),
               lambda: mr.prod_reduce_plain(fs, block=8), cases)

    # K6 on 0/1 inputs: square at n = 8192 with an adjacency's density,
    # ragged shapes (no multiple of the 128 tile), a single row; the
    # tensor-core route (the flag, read from the card, must admit them)
    shapes = [(N, N, N, 0.003), (1000, 777, 333, 0.05),
              (129, 257, 130, 0.3), (1, 5, 3, 0.5), (8191, 129, 8193, 0.01)]
    for M_, N_, K_, p in shapes:
        ops01 = [(torch.rand(s, generator=gen, device=DEV) < p).float()
                 for s in ((M_, K_), (N_, K_), (M_, N_))]
        check_case("matreduce", f"matreduce 0/1 ({M_},{N_},{K_}) p={p}",
                   lambda: mr.matreduce(*ops01),
                   lambda: mr.matreduce_plain(*ops01), cases)
        cases[-1]["route"] = matreduce_route(ops01[0], ops01[1], "tc")
    matreduce_exact_edges(gen, cases)
    # and on random f32 input, against an f64 product: the FMA route
    float_cases = []
    for M_, N_, K_ in [(N, N, N), (1000, 777, 333), (129, 257, 130)]:
        lhs = torch.randn((M_, K_), generator=gen, device=DEV)
        rhs = torch.randn((N_, K_), generator=gen, device=DEV)
        mask = (torch.rand((M_, N_), generator=gen, device=DEV)
                < 0.5).float()
        got = mr.matreduce(lhs, rhs, mask)
        route = matreduce_route(lhs, rhs, "fma")
        want = ((lhs.double() @ rhs.double().T) * mask.double()).sum().item()
        err = abs(got - want)
        float_cases.append({"shape": [M_, N_, K_], "route": route,
                            "value": got, "f64_value": want, "abs_err": err,
                            "tolerance": 3e-2 * abs(want) + 1.0})
        if not err < 3e-2 * abs(want) + 1.0:
            raise AssertionError(f"matreduce random f32 {(M_, N_, K_)}: "
                                 f"{got!r} vs f64 {want!r}")
        del lhs, rhs, mask
    tilelist_cases(gen, cases)

    sddmm_float = sddmm_cases(gen, cases)
    bitset_cases(gen, cases)
    flash = flash_cases(gen)
    flash_bwd = flash_bwd_cases(gen)
    emit("kernel_cases", build_s=round(build_s, 3),
         nvcc_s={k: round(v, 3) for k, v in kbuild.build_seconds.items()},
         n_cases=len(cases), max_abs_err=max(c["max_abs_err"] for c in cases),
         cases=cases, matreduce_random_f32=float_cases,
         sddmm_random=sddmm_float, flashattn_cases=flash,
         flashattn_max_abs_err=max(c["max_abs_err"] for c in flash),
         flashattn_bwd_cases=flash_bwd,
         flashattn_bwd_worst_err_over_tolerance=max(
             c["worst_err_over_tolerance"] for c in flash_bwd))
    torch.cuda.empty_cache()


def int64_case(name: str, got, factors, keep, cases: list):
    """An f64 instance's result against the int64 join of the same factors
    on the card (exact: every product and sum stays below 2^63)."""
    prod = factors[0].long()
    for F in factors[1:]:
        prod = prod * F.long()
    if keep is None:
        want = prod.sum().item()
    else:
        eye = torch.eye(prod.shape[0], dtype=torch.bool, device=DEV)
        want = prod.masked_fill(eye, 0).sum(1 - keep).double()
    diff = max_abs_diff(got, want)
    cases.append({"kernel": "f64", "case": f"{name} vs int64 join",
                  "max_abs_err": diff})
    if diff != 0:
        raise AssertionError(f"{name}: f64 instance differs from the int64 "
                             f"join by {diff!r}")


def vec_and_keep_entry_cases(rng, gen, cases: list):
    """K1's one-launch entry and K3's two entries beyond the square cases:
    K1 at an odd length (the tail cell), a start 8 bytes off 16 and a
    stride-2 view (8-byte loads), one CTA (n = 1000) and a grid at its
    cap (n = 2^22: 256 CTAs, whose last one sums the partials), each
    twice, so that the second launch finds the ticket counter reset; K3
    on column-major factors (keep=0 on the strided template, keep=1 on
    the row entry), an odd row length and a column slice (8-byte loads);
    the f64 instances of both at n = 8192 with Π max about 2^33 against
    their f64 plain versions and the int64 join."""
    for k in (2, 5):
        hi = max_value(k, 128, 1 << 22)
        long_ = [int_factor(rng, (1 << 22,), hi) for _ in range(k)]
        views = {"n=2^22 (grid cap)": long_,
                 f"n={N - 1} odd": [F[:N - 1] for F in long_],
                 f"n={N} start 8 bytes off": [F[1:N + 1] for F in long_],
                 f"n={N} stride 2": [F[:2 * N:2] for F in long_],
                 "n=1000 (one CTA)": [F[:1000] for F in long_]}
        for label, fs in views.items():
            for rep in (1, 2):
                check_case("cutjoin_vec", f"vec {label} k={k} call {rep}",
                           lambda: mr.prod_reduce(fs, block=128),
                           lambda: mr.prod_reduce_plain(fs, block=128),
                           cases)
        del long_, views
    for k in (1, 2, 3):
        hi = max_value(k, 128)
        fs = [int_factor(rng, (N, N), hi) for _ in range(k)]
        cm = [F.T.contiguous().T for F in fs]          # column-major
        for keep in (0, 1):
            entry = ("cutjoin_pair_keep_rows" if mr.keep_entry(cm[0], keep)
                     == "rows" else "cutjoin_pair_keep")
            for distinct in (True, False):
                check_case(entry, f"pair keep={keep} column-major k={k} "
                                  f"distinct={distinct}",
                           lambda: mr.prod_reduce_keep(cm, keep=keep,
                                                       distinct=distinct),
                           lambda: mr.prod_reduce_keep_plain(
                               cm, keep=keep, distinct=distinct), cases)
        del cm
        odd = [F[:, :N - 3] for F in fs]
        cols = [F[1000:2000, 3:] for F in fs]
        for keep in (0, 1):
            check_case("pairjoin_keep", f"pair keep={keep} {N}x{N - 3} "
                                        f"k={k}",
                       lambda: mr.prod_reduce_keep(odd, keep=keep),
                       lambda: mr.prod_reduce_keep_plain(odd, keep=keep),
                       cases)
            check_case("pairjoin_keep", f"pair keep={keep} slice "
                                        f"[1000:2000, 3:] offsets=(1000,3) "
                                        f"k={k}",
                       lambda: mr.prod_reduce_keep(cols, keep=keep,
                                                   offsets=(1000, 3)),
                       lambda: mr.prod_reduce_keep_plain(
                           cols, keep=keep, offsets=(1000, 3)), cases)
        del fs, odd, cols
    # the f64 instances: the product of two factors reaches 2^33, beyond
    # what any f32 chunk holds, and the sums stay below 2^53
    fv = [dev_factor(gen, (N,), F64_HI) for _ in range(2)]
    for label, fs in ((f"n={N}", fv), (f"n={N - 1} start 8 bytes off",
                                       [F[1:] for F in fv])):
        assert mr.exact_block(fs) is None
        assert mr.exact_f64([F.abs().max().item() for F in fs], len(fs[0]))
        got = check_case("cutjoin_vec_f64", f"vec f64 {label}",
                         lambda: mr.prod_reduce(fs, f64=True),
                         lambda: mr.prod_reduce_f64_plain(fs), cases)
        int64_case(f"vec f64 {label}", got, fs, None, cases)
    fk = [dev_factor(gen, (N, N), F64_HI) for _ in range(2)]
    assert mr.exact_block(fk) is None
    assert mr.exact_f64([F.abs().max().item() for F in fk], N)
    for label, fs in (("row-major", fk),
                      ("column-major", [F.T.contiguous().T for F in fk])):
        for keep in (0, 1):
            entry = ("cutjoin_pair_keep_rows_f64"
                     if mr.keep_entry(fs[0], keep) == "rows"
                     else "cutjoin_pair_keep_f64")
            name = f"pair keep={keep} f64 {label} n={N}"
            got = check_case(entry, name,
                             lambda: mr.prod_reduce_keep(fs, keep=keep,
                                                         f64=True),
                             lambda: mr.prod_reduce_keep_f64_plain(
                                 fs, keep=keep), cases)
            int64_case(name, got, fs, keep, cases)
    del fv, fk


def k6_route(plain_exact: bool, want: str) -> str:
    """K6's route in its last call, dense or tile list, from the flag it
    left on the card (read after a synchronize): ``tc`` where the flag
    admits the operands, else ``fma``.  The flag must equal its plain
    version, ``plain_exact``, and the route ``want``."""
    exact = bool(mr.last_exact.item())
    if exact != plain_exact:
        raise AssertionError(f"K6's flag {exact} differs from its plain "
                             f"version")
    route = "tc" if exact else "fma"
    if route != want:
        raise AssertionError(f"K6 took the {route} route, not {want}")
    return route


def matreduce_route(lhs, rhs, want: str) -> str:
    return k6_route(ksd.sddmm_exact_plain(lhs.float(), rhs.float()), want)


def tilelist_route(stack, k_ptr, want: str) -> str:
    return k6_route(mr.tilelist_exact_plain(stack, k_ptr), want)


def matreduce_exact_edges(gen, cases: list):
    """K6 on ``exact_edge_inputs``, each case on its route (read from the
    flag) and at difference 0 to the plain version; on the tensor-core
    route the tile occupancy the call left on the card must equal its
    plain version."""
    for name, l, r, m, route in exact_edge_inputs(gen):
        check_case("matreduce", f"matreduce exact edge {name}",
                   lambda: mr.matreduce(l, r, m),
                   lambda: mr.matreduce_plain(l, r, m), cases)
        cases[-1]["route"] = matreduce_route(l, r, route)
        if route == "tc" and not torch.equal(
                mr.last_tiles.bool(), ksd.sddmm_occupancy_plain(m)):
            raise AssertionError(f"matreduce exact edge {name}: tile "
                                 f"occupancy differs from the plain "
                                 f"version's")
        cases[-1].update(edge_case_extras(name, l, r, mr.last_tiles, route))


def random_tile_lists(rng, T: int, O: int, longest: int):
    """Seeded lists over a stack of T tiles: O output tiles, ragged lists
    of 0 to ``longest`` entries (the first has ``longest``, the second
    none), any tile anywhere, repeats allowed."""
    lengths = rng.integers(0, longest + 1, size=O)
    lengths[0], lengths[1] = longest, 0
    k_ptr = np.concatenate([[0], np.cumsum(lengths)])
    P = int(k_ptr[-1])
    return (rng.integers(0, T, size=O), k_ptr, rng.integers(0, T, size=P),
            rng.integers(0, T, size=P))


def tilelist_cases(gen, cases: list):
    """K6's tile list against its plain version, difference 0: random 0/1
    stacks of 128 x 128 tiles with ragged lists (up to 64 entries, K =
    8192 for the flag) on the tensor-core route, tiles of 100 x 100 that
    the wrapper pads, and a stack with values 2.5 (every product a
    multiple of 1/4 below 2^22, exact in f32) on the FMA route."""
    rng = np.random.default_rng(7)
    for T, t, values, O, longest, route in (
            (300, 128, None, 200, 64, "tc"), (41, 128, None, 9, 3, "tc"),
            (120, 100, None, 77, 20, "tc"),
            (200, 128, 2.5, 120, 40, "fma")):
        stack = (torch.rand((T, t, t), generator=gen, device=DEV)
                 < 0.05).float()
        if values is not None:
            stack[torch.rand((T, t, t), generator=gen, device=DEV)
                  < 0.02] = values
        lists = random_tile_lists(rng, T, O, longest)
        name = (f"matreduce_tilelist T={T} t={t} O={O} longest={longest}"
                + (f" values 0/1/{values}" if values else " 0/1"))
        check_case("matreduce_tilelist", name,
                   lambda: mr.matreduce_tilelist(stack, *lists),
                   lambda: mr.matreduce_tilelist_plain(stack, *lists), cases)
        cases[-1]["route"] = tilelist_route(stack, lists[1], route)
        del stack


def sddmm_route(lhs, rhs, want: str) -> str:
    """K7's route in the last call, from the flag it left on the card
    (read after a synchronize): ``tc`` for bf16 operands and for f32
    operands the flag admits, else ``fma``.  The flag must equal its
    plain version, and the route ``want``."""
    exact = bool(ksd.last_exact.item())
    if exact != ksd.sddmm_exact_plain(lhs, rhs):
        raise AssertionError(f"sddmm_prep's flag {exact} differs from "
                             f"sddmm_exact_plain")
    route = "tc" if lhs.dtype == torch.bfloat16 or exact else "fma"
    if route != want:
        raise AssertionError(f"sddmm took the {route} route, not {want}")
    return route


def sddmm_skipped(tiles) -> dict:
    """From K7's tile occupancy (one word per 128 x 128 tile): the empty
    tiles, and the 128 x 256 tiles of the tensor-core kernel that skip
    their product (both words empty) under the exact flag."""
    occupied = tiles.bool()
    pairs = torch.nn.functional.pad(occupied, (0, occupied.shape[1] % 2)) \
        .view(occupied.shape[0], -1, 2).any(2)
    return {"tiles_128x128": occupied.numel(),
            "tiles_128x128_empty": int((~occupied).sum().item()),
            "cta_tiles_128x256": pairs.numel(),
            "cta_tiles_skipped": int((~pairs).sum().item())}


def exact_edge_inputs(gen):
    """The exact route at the edges of its contract, f32 operands, as
    (name, lhs, rhs, mask, route) for K7 and K6 alike: (a) integers in
    [-256, 256] at K = 256, so K · max|lhs| · max|rhs| = 2^24 exactly,
    with rows of 256, -256, 255 and a row whose partial sums climb to
    2^23 and fall back to 0, so cells reach ±2^24 and just below; (b)
    integers in [0, 256] under a mask of values in [-3, 3] with two empty
    128 x 256 tiles (one of -0.0 cells, one ragged, of +0.0 with some
    -0.0) and -0.0 cells elsewhere, so the tile skip runs on data that is
    not 0/1; (c) the same mask with +0.0 in its empty tiles and operands
    in [-256, 256]: negative operands turn the skip off.  Then one over
    the edge — K = 257, rows of 256, the rest in [-16, 16], so every
    partial sum is still exact in f32 — must take the FMA route.  Each
    case is used before the next is drawn."""
    def ints(shape, lo, hi):
        return torch.randint(lo, hi + 1, shape, generator=gen, device=DEV,
                             dtype=torch.int32).float()

    l, r = ints((384, 256), -256, 256), ints((384, 256), -256, 256)
    l[0], l[1], l[2], r[0], r[1] = 256, -256, 255, 256, 255
    l[3, :128], l[3, 128:] = 256, -256
    yield ("(a) K=256 at +-256: K*max*max = 2^24", l, r,
           ints((384, 384), -1, 2), "tc")
    M_, N_, K_ = 700, 900, 200
    m = ints((M_, N_), -3, 3)
    m[torch.rand((M_, N_), generator=gen, device=DEV) < 0.1] = -0.0
    m[128:256, 256:512] = -0.0
    m[640:, 768:] = 0.0
    m[650:700:7, 770:900:5] = -0.0
    l, r = ints((M_, K_), 0, 256), ints((N_, K_), 0, 256)
    yield "(b) non-negative, empty tiles, -0.0 mask cells", l, r, m, "tc"
    m[128:256, 256:512] = 0.0
    l, r = ints((M_, K_), -256, 256), ints((N_, K_), -256, 256)
    yield "(c) negative operands, empty +0.0 tiles: no skip", l, r, m, "tc"
    l, r = ints((300, 257), -16, 16), ints((200, 257), -16, 16)
    l[0], r[0] = 256, 256
    yield ("one over: K=257 at 256 takes the FMA route", l, r,
           ints((300, 200), -1, 2), "fma")


def edge_case_extras(name: str, l, r, tiles, route: str) -> dict:
    """What an exact-edge case reports beyond its difference: the largest
    |product| cell, the tiles skipped (from the occupancy the call left on
    the card) and whether the skip was on (the kernels skip empty tiles
    only with no operand of negative sign); case (a) must reach 2^24, (b)
    skip at least two tiles, (c) run with the skip off."""
    row = {"max_abs_product": (l.double() @ r.double().T).abs().max()
           .item()}
    if route == "tc":
        row.update(sddmm_skipped(tiles))
        row["tile_skip_on"] = not bool(l.signbit().any()
                                       or r.signbit().any())
    if (name.startswith("(a)") and row["max_abs_product"] != 2 ** 24) or (
            name.startswith("(b)") and (row["cta_tiles_skipped"] < 2
                                        or not row["tile_skip_on"])) or (
            name.startswith("(c)") and row["tile_skip_on"]):
        raise AssertionError(f"exact edge {name}: {row}")
    return row


def sddmm_exact_edges(gen, cases: list):
    """K7 on ``exact_edge_inputs``, each case on its route (read from the
    flag) and at difference 0 to the plain version; wherever the product
    is not 0 the sign of each output cell must be the plain version's (a
    skipped tile would write +0.0 where acc · +0.0 is -0.0)."""
    for name, l, r, m, route in exact_edge_inputs(gen):
        got = check_case("sddmm", f"sddmm exact edge {name}",
                         lambda: ksd.sddmm(l, r, m),
                         lambda: ksd.sddmm_plain(l, r, m), cases)
        cases[-1]["route"] = sddmm_route(l, r, route)
        prod = l.double() @ r.double().T
        want = ksd.sddmm_plain(l, r, m)
        flips = (torch.signbit(got) != torch.signbit(want)) & (prod != 0)
        cases[-1]["sign_differs_where_product_nonzero"] = int(
            flips.sum().item())
        cases[-1].update(edge_case_extras(name, l, r, ksd.last_tiles, route))
        if cases[-1]["sign_differs_where_product_nonzero"]:
            raise AssertionError(f"sddmm exact edge {name}: the sign of a "
                                 f"masked cell differs from the plain "
                                 f"version's")


def sddmm_cases(gen, cases: list) -> list:
    """K7 against its plain version on 0/1 inputs in f32 and bf16 (every
    cell an integer: difference 0) — ragged shapes, strided views, and
    the R-MAT adjacency at n = 8192, all on the tensor-core route (the
    flag, read from the card, must admit them; the R-MAT call's tile
    occupancy must equal its plain version), then integer data at the
    edges of the exact route's contract (``sddmm_exact_edges``) — then on
    random normal input (f32 on the FMA route, bf16 on the tensor cores)
    against an f64 product of the same (rounded) inputs, per cell, with the
    reference package's tolerances: 2e-4 (f32) and 2e-2 (bf16), relative
    and absolute.  Those were set for K <= 384; at K = 8192 an f32 sum of
    normal products is off by more than 2e-4 wherever the value is near
    0, so f32 at K = 8192 is held to the rounding bound of any f32
    K-term dot product instead, γ_K · Σ_k |l_k r_k| with γ_K =
    K·u / (1 - K·u), u = 2^-24."""
    A = rmat_adjacency(rmat(13, 24.0, seed=0))
    shapes = [(200, 130, 70, 0.3), (1, 5, 3, 0.5), (129, 257, 130, 0.3),
              (1000, 777, 333, 0.05), (8191, 129, 8193, 0.01)]
    for dt in (torch.float32, torch.bfloat16):
        for M_, N_, K_, p in shapes:
            l, r, m = [(torch.rand(s, generator=gen, device=DEV) < p).float()
                       for s in ((M_, K_), (N_, K_), (M_, N_))]
            l, r = l.to(dt), r.to(dt)
            check_case("sddmm", f"sddmm 0/1 {dt} ({M_},{N_},{K_}) p={p}",
                       lambda: ksd.sddmm(l, r, m),
                       lambda: ksd.sddmm_plain(l, r, m), cases)
            cases[-1]["route"] = sddmm_route(l, r, "tc")
        # row strides above the width: views into wider tensors
        L, R, Mk = [(torch.rand(s, generator=gen, device=DEV) < 0.2).float()
                    for s in ((300, 90), (200, 90), (300, 210))]
        lv, rv, mv = L[:, 5:75].to(dt), R[:, 5:75].to(dt), Mk[:, 3:203]
        check_case("sddmm", f"sddmm 0/1 {dt} strided views (300,200,70)",
                   lambda: ksd.sddmm(lv, rv, mv),
                   lambda: ksd.sddmm_plain(lv, rv, mv), cases)
        cases[-1]["route"] = sddmm_route(lv, rv, "tc")
        Ad = A.to(dt)
        check_case("sddmm", f"sddmm {dt} R-MAT adjacency n={N}",
                   lambda: ksd.sddmm(Ad, Ad, A),
                   lambda: ksd.sddmm_plain(Ad, Ad, A), cases)
        cases[-1]["route"] = sddmm_route(Ad, Ad, "tc")
        occupied = ksd.sddmm_occupancy_plain(A)
        if not torch.equal(ksd.last_tiles.bool(), occupied):
            raise AssertionError("sddmm_prep's tile occupancy differs from "
                                 "sddmm_occupancy_plain")
        cases[-1].update(sddmm_skipped(ksd.last_tiles))
        del Ad
    sddmm_exact_edges(gen, cases)
    out = []
    for dt, tol in ((torch.float32, 2e-4), (torch.bfloat16, 2e-2)):
        for M_, N_, K_ in [(200, 130, 70), (1000, 777, 333), (N, N, N)]:
            l = torch.randn((M_, K_), generator=gen, device=DEV).to(dt)
            r = torch.randn((N_, K_), generator=gen, device=DEV).to(dt)
            m = (torch.rand((M_, N_), generator=gen, device=DEV)
                 < 0.3).float()
            got = ksd.sddmm(l, r, m).double()
            torch.cuda.synchronize()
            route = sddmm_route(l, r, "fma" if dt == torch.float32 else "tc")
            want = (l.double() @ r.double().T) * m.double()
            err = (got - want).abs()
            if dt == torch.float32 and K_ > 384:
                gamma = K_ * 2.0 ** -24 / (1 - K_ * 2.0 ** -24)
                limit = gamma * (l.double().abs() @ r.double().abs().T) \
                    * m.double()
                tolerance = "gamma_K * sum_k |l_k r_k|"
            else:
                limit = tol + tol * want.abs()
                tolerance = f"{tol} + {tol}*|f64 value|"
            over = int((err > limit).sum().item())
            out.append({"dtype": str(dt), "shape": [M_, N_, K_],
                        "route": route, "max_abs_err": err.max().item(),
                        "max_abs_value": want.abs().max().item(),
                        "cells_over_2e-4_abs_and_rel": int(
                            (err > 2e-4 + 2e-4 * want.abs()).sum().item()),
                        "tolerance": tolerance,
                        "max_err_over_tolerance": (
                            err / limit.clamp_min(1e-300)).max().item(),
                        "cells_over_tolerance": over})
            if over:
                raise AssertionError(f"sddmm random {dt} {(M_, N_, K_)}: "
                                     f"{over} cells over tolerance")
            del l, r, m, got, want, err, limit
    return out


def bitset_cases(gen, cases: list):
    """K8, its three entries, against the plain versions: random words
    (about half with bit 31 set, one row all ones), word counts that are
    no multiple of 32, row counts that are no multiple of the 8 rows a
    thread block takes, a strided view, and the packed R-MAT adjacency
    with its edge list.  ``bitset_pack`` on the R-MAT adjacency and on odd
    n (scalar tail, unaligned rows, uint8 entries other than 0/1, a
    column slice, f32 input); ``bitset_edges`` on sorted lists with a
    2000-edge star (a u-run longer than a warp's 8-edge chunk) and runs
    that straddle chunks, at each width of the vector entry's four
    instances and on the word entry (W = 37, strided views), with the
    entry each call took asserted; random unsorted pairs; pairs on the
    card with one outside the table, which must raise ``ValueError``.
    Difference 0."""
    def words(E_, W_):
        w = torch.randint(-2 ** 31, 2 ** 31, (E_, W_), generator=gen,
                          device=DEV, dtype=torch.int64).to(torch.int32)
        w[0] = -1
        return w

    def edge_case(name, table, pairs, entry):
        before = dict(kbs.edge_entries)
        check_case("bitset_edges", f"{name} [{entry}]",
                   lambda: kbs.bitset_intersect_edges(table, pairs),
                   lambda: kbs.bitset_intersect_edges_plain(table, pairs),
                   cases)
        took = [k for k, v in kbs.edge_entries.items() if v != before[k]]
        assert took == [entry], f"{name}: took the {took} entry, not {entry}"

    for E_, W_ in [(1001, 37), (5, 1), (100003, 7), (79494, 256), (8, 64)]:
        a, b = words(E_, W_), words(E_, W_)
        check_case("bitset", f"bitset rows E={E_} W={W_}",
                   lambda: kbs.bitset_intersect(a, b),
                   lambda: kbs.bitset_intersect_plain(a, b), cases)
        table = torch.cat([a, b])
        pairs = torch.randint(0, 2 * E_, (E_ + 3, 2), generator=gen,
                              device=DEV)
        edge_case(f"bitset edges table=({2 * E_},{W_}) E={E_ + 3} random "
                  f"unsorted pairs", table, pairs, kbs.edges_entry(table))
    wide = words(4000, 40)
    av, bv = wide[:2000, :33], wide[2000:, 4:37]
    check_case("bitset", "bitset rows strided views E=2000 W=33",
               lambda: kbs.bitset_intersect(av, bv),
               lambda: kbs.bitset_intersect_plain(av, bv), cases)
    # sorted lists: a star of 2000 edges on one u, then runs of 7, 31, 33,
    # 1, 64 and 5 edges (so runs straddle the 8-edge chunks), at the
    # widths of the vector entry's four instances
    rng = np.random.default_rng(20)
    for rows, W_ in [(4096, 128), (4096, 256), (2048, 512), (1024, 1024)]:
        table = words(rows, W_)
        parts = [np.stack([np.full(2000, 3), rng.integers(0, rows, 2000)],
                          1), np.stack([np.full(7, 4),
                                        rng.integers(0, rows, 7)], 1)]
        for u, k in ((10, 31), (11, 33), (12, 1), (13, 64), (14, 5)):
            parts.append(np.stack([np.full(k, u), rng.integers(0, rows, k)],
                                  1))
        srt = np.concatenate(parts)
        srt = srt[np.lexsort((srt[:, 1], srt[:, 0]))]
        edge_case(f"bitset edges sorted star + straddling runs "
                  f"table=({rows},{W_}) E={len(srt)}", table,
                  torch.from_numpy(srt).to(DEV), "vec")
        edge_case(f"bitset edges the same pairs from the host "
                  f"table=({rows},{W_})", table, srt, "vec")
    srt37 = np.stack([np.repeat(np.arange(40), 50),
                      rng.integers(0, 2002, 2000)], 1)
    edge_case("bitset edges sorted runs of 50, W=37", words(2002, 37),
              torch.from_numpy(srt37).to(DEV), "word")
    wide = words(3000, 264)
    edge_case("bitset edges strided view W=256 at a 4-byte offset",
              wide[:, 1:257], torch.from_numpy(srt37).to(DEV), "word")
    edge_case("bitset edges strided view W=256 at a 16-byte offset",
              wide[:, 4:260], torch.from_numpy(srt37).to(DEV), "vec")
    g = rmat(13, 24.0, seed=0)
    Ab = rmat_adjacency(g) > 0
    packed = check_case("bitset_pack", f"bitset pack R-MAT n={N} bool",
                        lambda: kbs.pack_bitsets(Ab),
                        lambda: kbs.pack_bitsets_plain(Ab), cases)
    odd = torch.rand((1001, 8191), generator=gen, device=DEV) < 0.3
    odd_u8 = odd.to(torch.uint8) * torch.randint(
        1, 256, odd.shape, generator=gen, device=DEV, dtype=torch.uint8)
    for name, adj in [("odd n=8191 bool (unaligned rows)", odd),
                      ("odd n=8191 uint8 entries 0..255", odd_u8),
                      ("n=1000 column slice at offset 5", Ab[:1000, 5:1005]),
                      ("n=8176 (16 | n, 32 does not) f32",
                       odd[:, :8176].float()),
                      ("n=45 R=3", odd[:3, :45])]:
        check_case("bitset_pack", f"bitset pack {name}",
                   lambda: kbs.pack_bitsets(adj),
                   lambda: kbs.pack_bitsets_plain(adj), cases)
    edges = torch.from_numpy(g.edges).to(DEV)
    edge_case(f"bitset edges R-MAT n={N} packed, its {len(g.edges)} "
              f"edges", packed, edges, "vec")
    ga, gb = packed[edges[:, 0]], packed[edges[:, 1]]
    check_case("bitset", "bitset rows R-MAT gathered rows",
               lambda: kbs.bitset_intersect(ga, gb),
               lambda: kbs.bitset_intersect_plain(ga, gb), cases)
    # pairs on the card, one outside the table: the kernel's flag, read
    # once by the wrapper, raises ValueError (it never reads outside)
    for bad in ([5, N], [-1, 7]):
        wrong = edges.clone()
        wrong[40000] = torch.tensor(bad, device=DEV)
        try:
            kbs.bitset_intersect_edges(packed, wrong)
        except ValueError as exc:
            cases.append({"kernel": "bitset_edges", "case": f"pair {bad} "
                          f"outside the table raises", "raised": str(exc),
                          "max_abs_err": 0})
        else:
            raise AssertionError(f"pair {bad} outside the table did not "
                                 f"raise")
    torch.cuda.synchronize()


def sdpa(q, k, v, causal: bool):
    """PyTorch's scaled_dot_product_attention on (B, S, H, D) tensors, read
    through (B, H, S, D) views."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal).transpose(1, 2)


# SDPA's fused backends, in the order ``sdpa_call`` tries them at Dq != Dv
SDPA_FUSED = ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION")


def sdpa_call(q, k, v, causal: bool) -> tuple:
    """PyTorch's scaled_dot_product_attention on these inputs as a call
    with no arguments, and which backend it takes.  At Dq == Dv the
    default dispatch (the yardstick of the rows before (192, 128)).  At
    Dq != Dv the first fused backend of ``SDPA_FUSED`` that takes V as it
    is; else the first that takes V zero-padded to Dq, the output sliced
    back to Dv (zero columns of V add zero columns to the output: the same
    function); else the math backend."""
    if q.shape[3] == v.shape[3]:
        return (lambda: sdpa(q, k, v, causal)), "default dispatch"
    from torch.nn.attention import SDPBackend, sdpa_kernel
    Dq, Dv = q.shape[3], v.shape[3]
    padded = torch.nn.functional.pad(v, (0, Dq - Dv))
    tries = [(b, False) for b in SDPA_FUSED] + \
        [(b, True) for b in SDPA_FUSED] + [("MATH", False)]
    for backend, pad in tries:
        def call(backend=backend, pad=pad):
            with sdpa_kernel(getattr(SDPBackend, backend)):
                out = sdpa(q, k, padded if pad else v, causal)
            return out[..., :Dv] if pad else out
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                call()
                torch.cuda.synchronize()
        except RuntimeError:
            continue
        return call, backend + (f", V zero-padded to Dq = {Dq} and the "
                                f"output sliced to Dv = {Dv}" if pad else "")
    raise AssertionError("no SDPA backend takes these inputs")


def flash_check(name: str, q, k, v, causal: bool, cases: list,
                block=None, library: bool = False,
                twice: bool = False) -> dict:
    """K9 against its plain version (KV blocks of ``block`` rows, all of
    Skv when None) on the same inputs: every cell within the reference's
    tolerance, tol + tol·|plain|.  In bf16 also against the plain version
    in f32 on the same (widened) inputs, within one rounding to bf16:
    K9 keeps P to f32 grade (P_hi + P_lo) and rounds once, at the output.
    With ``library``,
    PyTorch's scaled_dot_product_attention (P rounded to bf16) is held to
    that second check too and must fail it, which shows that the check
    tells the two functions apart.  With ``twice`` K9 is launched a second
    time on the same inputs, and its output must be the same bits."""
    before = kfa.launches["flashattn"]
    got = kfa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kfa.launches["flashattn"] == before + 1, \
        f"{name}: wrapper did not launch flashattn"
    same_bits = None
    if twice:
        same_bits = torch.equal(kfa.flash_attention(q, k, v, causal=causal),
                                got)
        assert same_bits, f"{name}: two launches gave different outputs"
    want, lse_ref = kfa.flash_attention_plain(q, k, v, causal=causal,
                                              block=block, return_lse=True)
    want = want.float()
    tol = FLASH_TOL[q.dtype]
    err = (got.float() - want).abs()
    over = int((err > tol + tol * want.abs()).sum().item())
    case = {"kernel": "flashattn", "case": name,
            "max_abs_err": err.max().item(),
            "tolerance": f"{tol} + {tol}*|plain|",
            "cells_over_tolerance": over}
    if twice:
        case["two_launches_same_bits"] = same_bits
    # the same launch with the row statistic: the output unchanged, lse
    # held to the plain forward's
    with_lse, lse, _ = kfa._forward(q, k, v, causal, 1.0 / q.shape[3] ** 0.5,
                                    with_lse=True)
    case["output_with_lse_equal"] = torch.equal(with_lse, got)
    over += lse_check(lse, lse_ref, case) + (not case["output_with_lse_equal"])
    del with_lse, lse, lse_ref
    if q.dtype == torch.bfloat16:
        exact = kfa.flash_attention_plain(q.float(), k.float(), v.float(),
                                          causal=causal, block=block)
        bound = (FLASH_ONE_ROUNDING + FLASH_TOL[torch.float32]) * \
            exact.abs() + FLASH_TOL[torch.float32]
        err32 = (got.float() - exact).abs()
        case.update(max_abs_err_f32_plain=err32.max().item(),
                    tolerance_f32_plain="(2^-8 + 2e-5)*|plain f32| + 2e-5",
                    cells_over_one_rounding=int((err32 > bound).sum().item()))
        over += case["cells_over_one_rounding"]
        if library:
            call, backend = sdpa_call(q, k, v, causal)
            lib_err = (call().float() - exact).abs()
            case.update(sdpa_backend=backend,
                        sdpa_max_abs_err_f32_plain=lib_err.max().item(),
                        sdpa_cells_over_one_rounding=int(
                            (lib_err > bound).sum().item()))
            assert case["sdpa_cells_over_one_rounding"] > 0, \
                f"{name}: the one-rounding check does not separate " \
                f"K9 from SDPA: {case}"
            del lib_err
        del exact, bound, err32
    cases.append(case)
    if over or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: cells over tolerance: {case}")
    return case


def flash_cases(gen) -> list:
    """K9, both types, causal and full, D = 64 and 128, ragged and unequal
    sequence lengths, strided (B, S, H, D) views, and the serving paths'
    shapes (1, 4096, 32, 128) and (1, 4096, 48, 128) in bf16, and B·H =
    65600 in both types; the same at deepseek-v3's (Dq, Dv) = (192, 128),
    and its prefill shape (1, 4096, 128, 192 / 128) in bf16, launched twice
    (the same bits) (the paths' own q, k, v are held in phases
    ``kernels``, ``moe_serve_path`` and ``mla_serve_path``)."""
    cases: list = []

    def rnd(shape, dt):
        return torch.randn(shape, generator=gen, device=DEV).to(dt)

    for dt in (torch.float32, torch.bfloat16):
        for D in (64, 128):
            for causal in (True, False):
                q, k, v = (rnd((2, 512, 4, D), dt) for _ in range(3))
                flash_check(f"{dt} (2,512,4,{D}) causal={causal}", q, k, v,
                            causal, cases, block=128)
        for Sq, Skv, D, causal in [(77, 77, 64, True), (1000, 1000, 128, True),
                                   (50, 77, 64, False), (77, 50, 128, True),
                                   (1, 300, 128, False)]:
            q = rnd((2, Sq, 3, D), dt)
            k, v = (rnd((2, Skv, 3, D), dt) for _ in range(2))
            flash_check(f"{dt} ragged Sq={Sq} Skv={Skv} D={D} "
                        f"causal={causal}", q, k, v, causal, cases)
        # (B, H, S, D) storage read as (B, S, H, D), and head / column
        # slices of wider tensors: no unit stride but along D
        q, k, v = (rnd((2, 4, 300, 128), dt).transpose(1, 2)
                   for _ in range(3))
        flash_check(f"{dt} strided (B,H,S,D) storage (2,300,4,128)", q, k, v,
                    True, cases)
        q, k, v = (rnd((1, 257, 6, 160), dt)[:, :, 1:5, 16:80]
                   for _ in range(3))
        flash_check(f"{dt} strided slices (1,257,4,64)", q, k, v, False,
                    cases)
        # a start 4 (bf16) or 8 (f32) bytes past a 16-byte boundary, a
        # head stride of 68 elements, and v broadcast over the heads: the
        # bf16 kernel's TMA copies cannot read these in place, so the
        # wrapper copies them first
        q, k = (rnd((1, 300, 3, 68), dt)[..., 2:66] for _ in range(2))
        v = rnd((1, 300, 1, 64), dt).expand(1, 300, 3, 64)
        flash_check(f"{dt} unaligned and broadcast views (1,300,3,64)", q,
                    k, v, True, cases)
    q, k, v = (rnd((1, 4096, 32, 128), torch.bfloat16) for _ in range(3))
    flash_check("bf16 serving shape (1,4096,32,128) causal, random", q, k, v,
                True, cases, block=1024, library=True)
    # dbrx-132b's serving shape: 48 heads (its 8 KV heads expanded)
    q, k, v = (rnd((1, 4096, 48, 128), torch.bfloat16) for _ in range(3))
    flash_check("bf16 dbrx-132b serving shape (1,4096,48,128) causal, "
                "random", q, k, v, True, cases, block=1024, library=True)
    # B * H = 65600, above the 65535 that CUDA allows on grid axis y; in
    # bf16 at two query tiles a pair, 131 200 CTAs on the linear grid
    q, k, v = (rnd((2050, 16, 32, 64), torch.float32) for _ in range(3))
    flash_check("f32 B*H=65600 (2050,16,32,64) causal", q, k, v, True, cases)
    q, k, v = (rnd((2050, 129, 32, 64), torch.bfloat16) for _ in range(3))
    flash_check("bf16 B*H=65600 (2050,129,32,64) causal", q, k, v, True,
                cases)
    del q, k, v
    # deepseek-v3's latent attention: (Dq, Dv) = (192, 128)
    Dq, Dv = MLA_HEAD_DIMS
    for dt in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            q, k = (rnd((2, 512, 4, Dq), dt) for _ in range(2))
            v = rnd((2, 512, 4, Dv), dt)
            flash_check(f"{dt} (2,512,4,{Dq}/{Dv}) causal={causal}", q, k, v,
                        causal, cases, block=128)
        for Sq, Skv, causal in [(77, 77, True), (1000, 1000, True),
                                (50, 77, False), (77, 50, True),
                                (1, 300, False)]:
            q = rnd((2, Sq, 3, Dq), dt)
            k, v = rnd((2, Skv, 3, Dq), dt), rnd((2, Skv, 3, Dv), dt)
            flash_check(f"{dt} ragged Sq={Sq} Skv={Skv} {Dq}/{Dv} "
                        f"causal={causal}", q, k, v, causal, cases)
        q, k = (rnd((2, 4, 300, Dq), dt).transpose(1, 2) for _ in range(2))
        v = rnd((2, 4, 300, Dv), dt).transpose(1, 2)
        flash_check(f"{dt} strided (B,H,S,D) storage (2,300,4,{Dq}/{Dv})", q,
                    k, v, True, cases)
        q, k = (rnd((1, 257, 6, 256), dt)[:, :, 1:5, 32:224]
                for _ in range(2))
        v = rnd((1, 257, 6, 160), dt)[:, :, 1:5, 16:144]
        flash_check(f"{dt} strided slices (1,257,4,{Dq}/{Dv})", q, k, v,
                    False, cases)
    q, k = (rnd((1, 4096, 128, Dq), torch.bfloat16) for _ in range(2))
    v = rnd((1, 4096, 128, Dv), torch.bfloat16)
    flash_check(f"bf16 deepseek-v3 prefill shape (1,4096,128,{Dq}/{Dv}) "
                "causal, random", q, k, v, True, cases, block=1024,
                library=True, twice=True)
    return cases


def causal_attention_f64(q, k, v, heads_at_once: int = 12):
    """softmax(QKᵀ/√Dq)·V, causal, in f64 on the widened inputs, a group
    of heads at a time: the oracle of ``flash_path_check``."""
    B, S, H, D = q.shape
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    out = torch.empty((B, S, H, v.shape[3]), dtype=torch.float64,
                      device=q.device)
    for h in range(0, H, heads_at_once):
        hs = slice(h, h + heads_at_once)
        s = torch.einsum("bqhd,bthd->bhqt", q[:, :, hs].double(),
                         k[:, :, hs].double()) / D ** 0.5
        p = torch.softmax(s.masked_fill(~mask, -torch.inf), dim=-1)
        del s
        out[:, :, hs] = torch.einsum("bhqt,bthd->bqhd", p,
                                     v[:, :, hs].double())
        del p
    return out


def mean_relative_bias(got, exact) -> float:
    """Σ(got − exact)·exact / Σ exact², in f64: the common factor by which
    ``got`` misses ``exact`` (0 for errors of either sign alike)."""
    exact = exact.double()
    return (((got.double() - exact) * exact).sum()
            / (exact * exact).sum()).item()


def flash_path_check(name: str, q, k, v, block: int) -> dict:
    """K9 on a path's own bf16 q, k, v (causal) against the plain version
    in f64 on the same widened inputs: every cell within one rounding to
    bf16 and the f32 tolerance, as ``flash_check``'s second check, plus a
    floor of ``FLASH_BWD_FLOOR`` times the plain f32 version's own
    largest error against the f64 one.  dbrx-132b has no qk-norm, and at
    its random weights layer 0's scores reach thousands (lse about 4600):
    there f32 sums of the scores move P by more than one bf16 rounding of
    the output, in the plain f32 version as in the kernel, which the floor
    measures.  Reported beside it, not held: the mean relative bias
    against f64 (``mean_relative_bias``), which a sum that rounds one way
    (the tensor cores' f32 sums round toward zero) would move."""
    got = kfa.flash_attention(q, k, v, causal=True).double()
    exact = causal_attention_f64(q, k, v)
    plain = kfa.flash_attention_plain(q.float(), k.float(), v.float(),
                                      causal=True, block=block).double()
    floor = FLASH_BWD_FLOOR * (plain - exact).abs().max().item()
    err = (got - exact).abs()
    bound = (FLASH_ONE_ROUNDING + FLASH_TOL[torch.float32]) * exact.abs() \
        + FLASH_TOL[torch.float32] + floor
    case = {"kernel": "flashattn", "case": name, "shape": list(q.shape),
            "max_abs_err_f64": err.max().item(),
            "plain_f32_max_abs_err_f64": floor / FLASH_BWD_FLOOR,
            "max_abs_f64": exact.abs().max().item(),
            "mean_relative_bias": mean_relative_bias(got, exact),
            "plain_f32_mean_relative_bias": mean_relative_bias(plain, exact),
            "tolerance": f"(2^-8 + 2e-5)*|f64| + 2e-5 + {FLASH_BWD_FLOOR} x "
                         f"max|plain f32 - f64|",
            "cells_over_tolerance": int((err > bound).sum().item()),
            "max_err_over_bound": (err / bound).max().item()}
    del got, exact, plain, err, bound
    if case["cells_over_tolerance"]:
        raise AssertionError(f"{name}: cells over tolerance: {case}")
    return case


def lse_check(lse, lse_ref, case: dict, floor: float = 0.0) -> int:
    """K9's row statistic against the plain forward's (``FLASH_LSE_TOL``,
    plus ``floor``); the largest error and the cells over the bound go
    into ``case``."""
    err = (lse - lse_ref).abs()
    over = int((err > FLASH_LSE_TOL * lse_ref.abs().clamp(min=1)
                + floor).sum().item())
    case.update(lse_max_abs_err=err.max().item(),
                lse_max_abs=lse_ref.abs().max().item(),
                lse_tolerance="2^-19 * max(1, |plain lse|)"
                + (f" + {floor!r}" if floor else ""),
                lse_cells_over_tolerance=over)
    return over


PLAIN_HEADS = 32


def lse_f64(q, k, *, causal: bool):
    """The row statistic lse in f64 on the widened q and k, (B, H, S):
    logsumexp of the scaled scores, masked above the diagonal when
    causal (Sq == Skv)."""
    s = torch.einsum("bqhd,bthd->bhqt", q.double(), k.double()) \
        / q.shape[3] ** 0.5
    if causal:
        S = q.shape[1]
        s = s.masked_fill(~torch.ones((S, S), dtype=torch.bool,
                                      device=q.device).tril(), -torch.inf)
    return torch.logsumexp(s, dim=-1)


def plain_by_heads(fn, *xs, lse=None, **kw):
    """``fn`` (a plain forward or backward) on groups of ``PLAIN_HEADS``
    heads of (B, S, H, D) operands (and of lse, (B, H, S)), the results
    joined: each head's answer is its own, and at deepseek-v3's 128 heads
    and 4096 tokens one (B, H, S, S) tensor of f32 scores is 8.6 GB."""
    parts = []
    for h in range(0, xs[0].shape[2], PLAIN_HEADS):
        hs = slice(h, h + PLAIN_HEADS)
        extra = () if lse is None else (lse[:, hs],)
        parts.append(fn(*(x[:, :, hs] for x in xs), *extra, **kw))

    def join(ts):
        return torch.cat(ts, dim=2 if ts[0].ndim == 4 else 1)
    if isinstance(parts[0], torch.Tensor):
        return join(parts)
    return tuple(join(p) for p in zip(*parts))


def flash_bwd_check(name: str, q, k, v, do, causal: bool, cases: list,
                    twice: bool = False):
    """K9-bwd on the kernel's own forward output and row statistic (one K9
    launch with lse), held three ways.  The forward: o within K9's
    tolerance of the plain forward's and lse within ``FLASH_LSE_TOL``.
    The whole chain: the gradients against the plain backward run from
    the plain forward's o and lse, an oracle that reads nothing the
    kernels wrote, per gradient within ``FLASH_BWD_TOL`` · max|plain| in
    f32 and the reference's 3e-2 in bf16.  The backward alone: against the
    plain version in f32 on the same (widened) inputs as the kernel, the
    kernel's o and lse, within ``FLASH_BWD_TOL`` · max|plain| in f32 and
    one rounding to bf16 (``FLASH_BWD_TOL`` beside it) in bf16.  Each f32
    bound has the floor ``FLASH_BWD_FLOOR`` times the plain f32 version's
    own error against the plain version in f64, and lse's bound that times
    the plain forward's lse error against an f64 logsumexp (``lse_f64``:
    at a training path's random-weight scores, lse in the thousands, f32
    sums of the scores miss 2^-19 · |lse| in the plain version as in the
    kernel).  With ``twice`` the backward is launched a second time on the
    same inputs, and its three gradients must be the same bits (no
    atomics).  The plain versions run on groups of heads
    (``plain_by_heads``)."""
    D = q.shape[3]
    o_ref, lse_ref = plain_by_heads(kfa.flash_attention_plain, q, k, v,
                                    causal=causal, return_lse=True)
    lse_floor = FLASH_BWD_FLOOR * (lse_ref - plain_by_heads(
        lse_f64, q, k, causal=causal)).abs().max().item()
    o, lse, _ = kfa._forward(q, k, v, causal, 1.0 / D ** 0.5, with_lse=True)
    before = kfa.launches["flashattn_bwd"]
    got = kfa.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    torch.cuda.synchronize()
    assert kfa.launches["flashattn_bwd"] == before + 1, \
        f"{name}: wrapper did not launch flashattn_bwd"
    same_bits = None
    if twice:
        again = kfa.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
        same_bits = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        assert same_bits, f"{name}: two launches gave different gradients"
    bwd = kfa.flash_attention_bwd_plain
    want = plain_by_heads(bwd, q, k, v, o_ref, do, lse=lse_ref,
                          causal=causal)
    wide = [x.float() for x in (q, k, v, o, do)]
    exact = plain_by_heads(bwd, *wide, lse=lse, causal=causal)
    f64 = plain_by_heads(bwd, *(x.double() for x in wide), lse=lse,
                         causal=causal)
    floors = [FLASH_BWD_FLOOR * (e - w).abs().max().item()
              for e, w in zip(exact, f64)]
    del f64, wide
    case = {"kernel": "flashattn_bwd", "case": name,
            "shape": list(q.shape), "head_dims": [D, v.shape[3]],
            "dtype": str(q.dtype).split(".")[1], "causal": causal,
            "grads": {}}
    if twice:
        case["two_launches_same_bits"] = same_bits
    tol = FLASH_TOL[q.dtype]
    o_err = (o.float() - o_ref.float()).abs()
    case["o_max_abs_err"] = o_err.max().item()
    forward_over = lse_check(lse, lse_ref, case, lse_floor) + int(
        (o_err > tol + tol * o_ref.float().abs()).sum().item())
    del o_err, o_ref, lse_ref
    worst = 0.0
    for label, g, w, floor in zip(("dq", "dk", "dv"), got, want, floors):
        w = w.float()
        err = (g.float() - w).abs()
        scale = w.abs().max().item()
        row = {"max_abs_err": err.max().item(), "max_abs_plain": scale,
               "floor": floor}
        if q.dtype == torch.float32:
            worst = max(worst, row["max_abs_err"]
                        / (FLASH_BWD_TOL * scale + floor))
        else:
            row["cells_over_3e-2"] = int(
                (err > tol + tol * w.abs()).sum().item())
            worst = max(worst, (err / (tol + tol * w.abs())).max().item())
        case["grads"][label] = row
        del err
    rounding = FLASH_ONE_ROUNDING if q.dtype == torch.bfloat16 else 0.0
    for label, g, w, floor in zip(("dq", "dk", "dv"), got, exact, floors):
        bound = rounding * w.abs() + FLASH_BWD_TOL * w.abs().max() + floor
        err = (g.float() - w).abs()
        row = case["grads"][label]
        row.update(max_abs_err_same_inputs=err.max().item(),
                   cells_over_same_inputs=int((err > bound).sum().item()))
        worst = max(worst, (err / bound).max().item())
        del bound, err
    del exact
    case["tolerance"] = (
        ("plain forward's o and lse: "
         + (f"{FLASH_BWD_TOL} * max|plain| + floor" if q.dtype ==
            torch.float32 else "3e-2 + 3e-2*|plain|")
         + "; the kernel's o and lse, plain in f32: "
         + ("2^-8*|plain f32| + " if rounding else "")
         + f"{FLASH_BWD_TOL} * max|plain f32| + floor (floor: "
         f"{FLASH_BWD_FLOOR} x max|plain f32 - plain f64|)"))
    case["worst_err_over_tolerance"] = worst
    cases.append(case)
    if worst > 1.0 or forward_over or \
            not all(torch.isfinite(g).all() for g in got):
        raise AssertionError(f"{name}: K9-bwd over tolerance: {case}")
    return case


def flash_bwd_cases(gen) -> list:
    """K9-bwd: f32 and bf16, D = 64 and 128, causal and full; lengths that
    are no multiple of its 64- and 128-row tiles (S = 129: one row past a
    128-row tile); B·H = 65600 (f32, and bf16 at S = 65) and a bf16 grid
    of 640 x 3 CTAs, more
    than 4 per SM; q, k, v read by strides; dO with other strides (a (B,
    H, S, D) storage read in place, a view broadcast over the heads read in
    place in f32 and copied in bf16, where TMA cannot read it, a D-strided
    view copied first); the two training shapes, repro-100m's (8, 1024, 10,
    64) f32 and qwen3-4b's (1, 4096, 32, 128) bf16, causal, each launched
    twice (equal bits).  At deepseek-v3's (Dq, Dv) = (192, 128), both
    types: causal and full, S = 1 (dQ and dK are 0 in exact arithmetic),
    77 and 129, a (B, H, S, D) storage, sliced views with dO broadcast
    over the heads, and its training shape (1, 4096, 128, 192 / 128) bf16
    causal, launched twice.  Then the plain backward against
    ``torch.autograd.grad`` of the plain forward on the card, and a loss
    through ``flash_attention`` on tensors that require grad at (128, 128)
    and (192, 128): one K9 and one K9-bwd launch through
    ``FlashAttention``, gradients equal to the direct call's."""
    cases: list = []

    def rnd(shape, dt):
        return torch.randn(shape, generator=gen, device=DEV).to(dt)

    for dt in (torch.float32, torch.bfloat16):
        for D in (64, 128):
            for causal in (True, False):
                q, k, v, do = (rnd((2, 512, 4, D), dt) for _ in range(4))
                flash_bwd_check(f"{dt} (2,512,4,{D}) causal={causal}", q, k,
                                v, do, causal, cases)
        for S, D, causal in [(77, 64, True), (1000, 128, True),
                             (300, 64, False), (1, 128, True),
                             (129, 128, True), (129, 64, False)]:
            q, k, v, do = (rnd((2, S, 3, D), dt) for _ in range(4))
            flash_bwd_check(f"{dt} ragged S={S} D={D} causal={causal}", q, k,
                            v, do, causal, cases)
        q, k, v = (rnd((2, 4, 300, 128), dt).transpose(1, 2)
                   for _ in range(3))
        do = rnd((2, 4, 300, 128), dt).transpose(1, 2)
        flash_bwd_check(f"{dt} (B,H,S,D) storage q, k, v, dO (2,300,4,128)",
                        q, k, v, do, True, cases)
        q, k, v = (rnd((1, 257, 6, 160), dt)[:, :, 1:5, 16:80]
                   for _ in range(3))
        do = rnd((1, 257, 1, 64), dt).expand(1, 257, 4, 64)
        flash_bwd_check(f"{dt} sliced q, k, v, broadcast dO (1,257,4,64)", q,
                        k, v, do, False, cases)
        q, k, v = (rnd((1, 200, 3, 64), dt) for _ in range(3))
        do = rnd((1, 200, 3, 128), dt)[..., ::2]
        flash_bwd_check(f"{dt} dO with D stride 2 (1,200,3,64)", q, k, v, do,
                        True, cases)
    q, k, v, do = (rnd((2050, 16, 32, 64), torch.float32) for _ in range(4))
    flash_bwd_check("f32 B*H=65600 (2050,16,32,64) causal", q, k, v, do, True,
                    cases)
    # bf16 at B * H = 65600, one 128-row tile and two 64-row streamed
    # tiles a pair: 65 600 CTAs of each of dkdv_kernel and dq_kernel, the
    # pairs on grid axis x (at S = 129 the checks' f64 oracle and copies of
    # the operands outgrow the card)
    q, k, v, do = (rnd((2050, 65, 32, 64), torch.bfloat16)
                   for _ in range(4))
    flash_bwd_check("bf16 B*H=65600 (2050,65,32,64) causal", q, k, v, do,
                    True, cases)
    del q, k, v, do
    # 640 x 3 CTAs of each bf16 kernel (128-row tiles), 14.5 per SM
    q, k, v, do = (rnd((40, 384, 16, 64), torch.bfloat16) for _ in range(4))
    flash_bwd_check("bf16 B*H=640 (40,384,16,64) causal", q, k, v, do, True,
                    cases)
    q, k, v, do = (rnd((8, 1024, 10, 64), torch.float32) for _ in range(4))
    flash_bwd_check("f32 repro-100m training shape (8,1024,10,64) causal", q,
                    k, v, do, True, cases, twice=True)
    q, k, v, do = (rnd((1, 4096, 32, 128), torch.bfloat16) for _ in range(4))
    flash_bwd_check("bf16 qwen3-4b training shape (1,4096,32,128) causal", q,
                    k, v, do, True, cases, twice=True)
    # deepseek-v3's latent attention: q, k at Dq = 192, v, o, dO at Dv = 128
    Dq, Dv = MLA_HEAD_DIMS

    def mla(shape, dt):
        *lead, H = shape
        return (rnd((*lead, H, Dq), dt), rnd((*lead, H, Dq), dt),
                rnd((*lead, H, Dv), dt), rnd((*lead, H, Dv), dt))

    for dt in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            flash_bwd_check(f"{dt} (2,512,4,{Dq}/{Dv}) causal={causal}",
                            *mla((2, 512, 4), dt), causal, cases)
        for S, causal in [(1, True), (77, True), (77, False), (129, True),
                          (129, False)]:
            flash_bwd_check(f"{dt} ragged S={S} {Dq}/{Dv} causal={causal}",
                            *mla((2, S, 3), dt), causal, cases)
        q, k = (rnd((2, 4, 300, Dq), dt).transpose(1, 2) for _ in range(2))
        v, do = (rnd((2, 4, 300, Dv), dt).transpose(1, 2) for _ in range(2))
        flash_bwd_check(f"{dt} (B,H,S,D) storage q, k, v, dO "
                        f"(2,300,4,{Dq}/{Dv})", q, k, v, do, True, cases)
        # head and column slices of wider tensors, and dO broadcast over
        # the heads: read in place in f32, copied for TMA in bf16
        q, k = (rnd((1, 257, 6, 256), dt)[:, :, 1:5, 32:224]
                for _ in range(2))
        v = rnd((1, 257, 6, 160), dt)[:, :, 1:5, 16:144]
        do = rnd((1, 257, 1, Dv), dt).expand(1, 257, 4, Dv)
        flash_bwd_check(f"{dt} sliced q, k, v, broadcast dO "
                        f"(1,257,4,{Dq}/{Dv})", q, k, v, do, False, cases)
    q, k, v, do = mla((1, 4096, 128), torch.bfloat16)
    flash_bwd_check(f"bf16 deepseek-v3 training shape (1,4096,128,{Dq}/{Dv}) "
                    "causal", q, k, v, do, True, cases, twice=True)
    del q, k, v, do

    # the plain backward against autograd of the plain forward, on the card
    for causal in (True, False):
        q, k, v, do = (rnd((2, 256, 3, 64), torch.float32) for _ in range(4))
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        out, lse = kfa.flash_attention_plain(q, k, v, causal=causal,
                                             return_lse=True)
        want = torch.autograd.grad(out, (q, k, v), do)
        got = kfa.flash_attention_bwd_plain(q.detach(), k.detach(),
                                            v.detach(), out.detach(), do,
                                            lse.detach(), causal=causal)
        errs = [((g - w).abs().max() / w.abs().max()).item()
                for g, w in zip(got, want)]
        cases.append({"kernel": "flashattn_bwd_plain",
                      "case": f"plain backward vs autograd causal={causal}",
                      "rel_err": errs, "worst_err_over_tolerance":
                          max(errs) / FLASH_BWD_TOL})
        assert max(errs) <= FLASH_BWD_TOL, cases[-1]

    # a loss through the wrapper: FlashAttention's forward and backward
    for dt in (torch.float32, torch.bfloat16):
        for Dq, Dv in ((128, 128), MLA_HEAD_DIMS):
            q, k = (rnd((2, 512, 4, Dq), dt) for _ in range(2))
            v, do = (rnd((2, 512, 4, Dv), dt) for _ in range(2))
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            before = dict(kfa.launches)
            out = kfa.flash_attention(*leaves, causal=True)
            grads = torch.autograd.grad(out, leaves, do)
            torch.cuda.synchronize()
            assert kfa.launches["flashattn"] == before["flashattn"] + 1
            assert kfa.launches["flashattn_bwd"] == \
                before["flashattn_bwd"] + 1
            o, lse, _ = kfa._forward(q, k, v, True, Dq ** -0.5,
                                     with_lse=True)
            want = kfa.flash_attention_bwd(q, k, v, o, do, lse, causal=True)
            same = all(torch.equal(g, w) for g, w in zip(grads, want))
            cases.append({"kernel": "flashattn_bwd",
                          "case": f"{dt} ({Dq}, {Dv}) autograd through "
                                  f"FlashAttention",
                          "grads_equal_direct_call": same,
                          "worst_err_over_tolerance": 0.0 if same else 2.0})
            assert same, cases[-1]
    return cases


# -- phase 3 ------------------------------------------------------------------------

def closed_form_cycle4(A: torch.Tensor) -> float:
    """# 4-cycles = (tr(A^4) - 2 Σd² + Σd) / 8, in f64."""
    A2 = A @ A
    tr4 = torch.sum(A2 * A2)                 # tr(A^4) = ||A²||_F², A symmetric
    d = A.sum(1)
    return ((tr4 - 2.0 * torch.sum(d * d) + torch.sum(d)) / 8.0).item()


def time_nodes(cp) -> dict:
    """Attribute the first ``counts()`` to node kinds: wraps the plan's node
    evaluation, synchronises after each node and adds its own time (without
    its children's) to its kind.  Clique enumeration, the one host-only
    node, is named as such."""
    seconds: dict = {}
    children = []
    evaluate = cp._eval

    def timed(node):
        kind = type(node).__name__
        if kind == "Intersect":
            kind += " (host clique enumeration)"
        elif kind == "CutJoin":
            kind += f" cut={node.cut_size}"
        elif kind == "Contract":
            kind += " free" if node.free else " closed"
        t0 = time.perf_counter()
        children.append(0.0)
        try:
            return evaluate(node)
        finally:
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            seconds[kind] = seconds.get(kind, 0.0) + dt - children.pop()
            if children:
                children[-1] += dt

    cp._eval = timed
    return seconds


def drive(label: str, make_graph, patterns, apct=None) -> dict:
    """The main path on one graph: compile, ``counts()`` twice (the second
    from the memo), and a second compile that hits the plan cache.  Given
    the graph's ``apct``, the compile reuses it."""
    t0 = time.perf_counter()
    g = make_graph()
    graph_s = time.perf_counter() - t0
    cache = compiler.PlanCache()
    before = launch_counts()
    torch.cuda.reset_peak_memory_stats()
    obs.reset()
    t0 = time.perf_counter()
    if apct is None:
        apct = APCT(g)                       # what compile() builds unasked
    apct_s = time.perf_counter() - t0
    cp = compiler.compile(patterns, g, cache=cache, apct=apct)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    node_s = time_nodes(cp)
    t0 = time.perf_counter()
    with recording_tri_joins([]) as tri_joins:
        counts = cp.counts()
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    evals = cp.stats["node_evals"]
    t0 = time.perf_counter()
    again = cp.counts()
    torch.cuda.synchronize()
    repeat_s = time.perf_counter() - t0
    assert again == counts, "second counts() differs from the first"
    assert cp.stats["node_evals"] == evals, \
        "second counts() re-evaluated nodes instead of reading the memo"
    assert {k: v - before[k] for k, v in launch_counts().items()} \
        == launches, \
        "second counts() launched kernels"
    snapshot = obs.snapshot()
    peak_bytes = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    cp_hit = compiler.compile(patterns, g, cache=cache)
    cached_compile_s = time.perf_counter() - t0
    assert cp_hit.from_cache and (cache.hits, cache.misses) == (1, 1), \
        "second compile did not hit the plan cache"
    return {"label": label, "g": g, "cp": cp, "counts": counts,
            "apct": apct, "cache": cache, "tri_joins": tri_joins,
            "launches": launches, "obs": snapshot,
            "peak_device_bytes": peak_bytes,
            "seconds": {"make_graph": round(graph_s, 3),
                        "compile": round(compile_s, 3),
                        "compile_apct_sampling": round(apct_s, 3),
                        "first_counts": round(first_s, 3),
                        "first_counts_by_node": {
                            k: round(v, 4) for k, v in node_s.items()},
                        "repeat_counts": round(repeat_s, 6),
                        "cached_compile": round(cached_compile_s, 4)}}


def verify_run(run: dict, patterns) -> dict:
    """Hold one main-path run against routes that launch no kernel."""
    g, cp, counts = run["g"], run["cp"], run["counts"]
    for v in counts.values():
        assert np.isfinite(v) and v >= 0 and v == round(v), counts
    # the f64 dense route, on an engine of its own (fresh memo, so the
    # cost model selects the same plan)
    engine = CountingEngine(g)
    cp_dense = compiler.compile(patterns, g, cache=False, counter=engine,
                                cutjoin_kernel=False)
    assert cp_dense.plan.meta["cuts"] == cp.plan.meta["cuts"]
    checks = {}
    for p in patterns:
        key = compiler.pattern_key(p)
        try:
            want, against = cp_dense.count(p), "dense-f64 route"
        except PlanTooWide:
            # the dense route refuses to materialise n^3 cells; the direct
            # Möbius count over f64 einsums is independent of the kernels
            want, against = engine.edge_induced(p), \
                "CountingEngine.edge_induced (dense route: PlanTooWide)"
        checks[key] = {"count": counts[key], "reference": want,
                       "against": against}
        if counts[key] != want:
            raise AssertionError(f"{run['label']} {key}: kernel route "
                                 f"{counts[key]!r} != {against} {want!r}")
    c4 = closed_form_cycle4(engine.A)
    if cp.count(cycle(4)) != c4:
        raise AssertionError(f"{run['label']} cycle(4): "
                             f"{cp.count(cycle(4))!r} != closed form {c4!r}")
    refused = check_f64_routes(run["label"], cp, cp.join_log)
    return {"graph": {"generator": run["label"], "n": g.n, "edges": g.m,
                      "max_degree": int(np.max(g.degrees))},
            "counts": counts, "checks": checks, "cycle4_closed_form": c4,
            "styles": cp.plan.meta["styles"], "cuts": cp.plan.meta["cuts"],
            "joins": cp.join_log,
            "cut3_join_chosen": any(j["cut"] == 3 for j in cp.join_log),
            "tri_joins": run["tri_joins"],
            "joins_refused_by_guard": refused,
            "joins_left_to_dense_route": [
                j["node"] for j in cp.join_log if j["route"] == "dense-f64"],
            "launches": run["launches"], "obs": run["obs"],
            "peak_device_bytes": run["peak_device_bytes"],
            "seconds": run["seconds"]}


def check_f64_routes(label: str, cp, joins: list) -> list:
    """Every join the f32 guard refused took the f64 instance of its kernel
    where it has one (a |cut| = 1 join, a |cut| = 2 keep join) and
    ``exact_f64`` admits its factors, computed here from the plan's own
    factors; every other refusal kept the dense route.  Returns one record
    per refusal: node, route, cells · Π max|F_i| over 2^53."""
    out = []
    for j in joins:
        if j["guard"] != "scanned" or j["block"] is not None:
            continue
        keep = j["keep"] is not None
        dense = "dense-f64-keep" if keep else "dense-f64"
        want = dense
        bound = None
        if (j["cut"] == 1 and not keep) or \
                (j["cut"] == 2 and keep and len(j["keep"]) == 1):
            Ms, _ = cp._join_factors(cp.plan.nodes[j["node"]])
            maxes = [M.abs().max().item() for M in Ms]
            cells = Ms[0].shape[0] if not keep else \
                Ms[0].shape[1 - j["keep"][0]]
            bound = float(np.prod(maxes)) * cells / 2.0 ** 53
            if mr.exact_f64(maxes, cells):
                want = "kernel-keep-f64" if keep else "kernel-f64"
        if j["route"] != want:
            raise AssertionError(f"{label} {j['node']}: route {j['route']}, "
                                 f"want {want}")
        out.append({"node": j["node"], "route": j["route"],
                    "bound_over_2_53": bound})
    return out


MAIN_GRAPH = "rmat(13, 24.0, seed=0)"
MAIN_PATH_KERNELS = ("vecjoin", "pairjoin", "trijoin")
COVERAGE_GRAPH = "erdos_renyi(8192, 24.0, seed=0)"
CYCLES = (cycle(4), cycle(5), cycle(6))


def phase_main_path() -> dict:
    """The user's graph is the skewed one (R-MAT, the scale of the paper's
    WikiVote input): what the cost model and the exactness guard choose
    there is reported as it falls, and it must launch a kernel at least
    once.  The uniform graph of the same size (Erdős–Rényi) is a coverage
    graph, chosen because the same entry points reach all three kernels on
    it; it is not claimed to be user traffic, and its launches are kept
    apart from the R-MAT graph's."""
    patterns = [tailed_triangle(), cycle(4), chain(5)] + \
        list(motif_patterns(4))
    graphs = [(MAIN_GRAPH, "main", lambda: rmat(13, 24.0, seed=0)),
              (COVERAGE_GRAPH, "coverage",
               lambda: erdos_renyi(8192, 24.0, seed=0))]
    reset_launch_counts()                    # counts start at 0 here ...
    runs = [dict(drive(label, make, patterns), role=role, patterns=patterns)
            for label, role, make in graphs]
    g_cov, apct_cov = runs[1]["g"], runs[1]["apct"]
    runs.append(dict(drive(COVERAGE_GRAPH, lambda: g_cov, list(CYCLES),
                           apct=apct_cov),
                     role="coverage-cycles", patterns=list(CYCLES)))
    launches = launch_counts()               # ... and are read here
    by_role = {run["role"]: run["launches"] for run in runs}
    assert sum(by_role["main"].values()) >= 1, \
        f"{MAIN_GRAPH} launched no kernel"
    for kernel in MAIN_PATH_KERNELS:
        assert launches[kernel] >= 1, f"no graph launched {kernel}"
    assert by_role["coverage"]["trijoin_path"] >= 1, \
        f"{COVERAGE_GRAPH}: no tri join took the path route"
    assert by_role["coverage-cycles"]["trijoin_triangle"] >= 2, \
        f"{COVERAGE_GRAPH}: the cycles' joins did not take the triangle route"
    reports = [dict(verify_run(run, run["patterns"]), role=run["role"])
               for run in runs]
    emit("main_path", patterns=len(patterns), launches=launches,
         launches_main_graph=by_role["main"],
         launches_coverage_graph=by_role["coverage"],
         kernels_not_reached_on_main_graph=[
             k for k in MAIN_PATH_KERNELS if by_role["main"][k] == 0],
         graphs=reports)
    joins = [j for run in runs for j in run["cp"].join_log]
    # what the partial-embedding path reuses: graph, APCT, plan cache,
    # counts, and the triangle count that clique enumeration gave
    graphs = []
    for run in runs[:2]:                     # the cycles' plan has no sequel
        cp = run["cp"]
        tri = [k for k, node in cp.plan.nodes.items()
               if isinstance(node, Intersect) and node.k == 3]
        graphs.append({key: run[key] for key in
                       ("label", "role", "g", "apct", "cache", "counts")})
        graphs[-1]["intersect3"] = {k: cp.value(k) for k in tri}
    # what the graph-op and mining-driver phases read of the user's graph:
    # Intersect k=3 holds hom(K3) = 6 T
    graphs[1]["cycle_counts"] = runs[2]["counts"]
    main = graphs[0]
    rmat_info = {"g": main["g"], "apct": main["apct"],
                 "counts": main["counts"],
                 "triangles": next(iter(main["intersect3"].values())) / 6}
    del runs
    torch.cuda.empty_cache()
    return {"launches": launches, "by_role": by_role, "joins": joins,
            "graphs": graphs, "rmat": rmat_info}


# -- phase 4 ------------------------------------------------------------------------

def anchored_or_refused(cp, p) -> dict:
    """Every anchored vector of ``p`` — or None where the plan raises
    ``PlanTooWide`` (a flat Möbius vector whose free-hom contraction needs
    an n^3 intermediate, as a clique's does at n = 8192).  A refusal is
    accepted only where ``CountingEngine.inj_free``, the engine's own
    route to the same vectors, refuses as well."""
    try:
        return {o[0]: cp.local_counts(p, o[0]) for o in p.vertex_orbits()}
    except PlanTooWide:
        try:
            cp.counter.inj_free(p, 0)
        except PlanTooWide:
            return None
        raise


def read_local(cp, g, patterns, counts, cache, apct) -> dict:
    """Every partial-embedding read of one local plan, each held to the
    Σ identities: Σ anchored = count · |Aut|, Σ vertex_counts = n_p ·
    count.  Returns the anchored vectors for the route checks."""
    anchored, reads, refused = {}, {}, {}
    unanchored = None
    for i, p in enumerate(patterns):
        key = compiler.pattern_key(p)
        count = counts[key]
        inj = count * p.aut_order()
        vecs = anchored_or_refused(cp, p)
        if vecs is None:
            refused[i] = key
        for rep, vec in (vecs or {}).items():
            total = vec.sum().item()
            if total != inj:
                raise AssertionError(f"{key} anchor {rep}: Σ {total!r} "
                                     f"!= count·|Aut| {inj!r}")
            anchored[i, rep] = vec
        top = None
        if vecs is not None:
            full = api.plan_vertex_counts(cp, p)
            if full.sum().item() != p.n * count:
                raise AssertionError(f"{key}: Σ vertex_counts "
                                     f"{full.sum().item()!r} != n_p·count")
            top = api.vertex_counts(p, g, counter=cp.counter, cache=cache,
                                    apct=apct, top_k=10)
            if top != api.top_vertices(full, 10):
                raise AssertionError(f"{key}: vertex_counts top_k differs "
                                     f"from the plan's vector")
        present = api.exists(p, g, counter=cp.counter, cache=cache,
                             apct=apct)
        if present != (count > 0):
            raise AssertionError(f"{key}: exists {present} but count "
                                 f"{count!r}")
        cut = cp.plan.meta["local_cuts"].get(compiler.local_key(
            p.canonical()))
        if unanchored is None and cut is not None and len(cut) == 2:
            tensor = cp.local_counts(p)
            if tensor.sum().item() != inj:
                raise AssertionError(f"{key}: Σ unanchored local tensor "
                                     f"!= count·|Aut|")
            unanchored = {"pattern": key, "cut": cut,
                          "shape": list(tensor.shape)}
            del tensor
        reads[f"{i}:{key}"] = {"count": count, "exists": present,
                               "top_vertices": top and top[:3]}
    return {"anchored": anchored, "reads": reads, "unanchored": unanchored,
            "refused": refused}


def check_dense_route(cp, g, patterns, anchored) -> dict:
    """Each anchored vector against the same plan's dense f64 route
    (``cutjoin_kernel=False``, sharing the plan's engine so contractions
    are not redone).  Where that route refuses a |cut| = 3 join as too
    wide, against ``CountingEngine.inj_free`` instead."""
    dense = lowering.lower(cp.plan, g, counter=cp.counter,
                           cutjoin_kernel=False)
    against = {}
    for (i, rep), vec in anchored.items():
        p = patterns[i]
        key = compiler.pattern_key(p)
        try:
            want, how = dense.local_counts(p, rep), "dense-f64 route"
        except PlanTooWide:
            want = torch.from_numpy(
                cp.counter.inj_free(p, rep).copy()).to(DEV)
            how = "CountingEngine.inj_free (dense route: PlanTooWide)"
        if not torch.equal(vec, want):
            raise AssertionError(f"{key} anchor {rep}: kernel route differs "
                                 f"from {how} by {max_abs_diff(vec, want)}")
        against[f"{i}:{key}@{rep}"] = how
    return against


def local_joins(cp) -> list:
    return [j for j in cp.join_log if j["keep"] is not None]


def time_refused_keep_joins(cp, refusals: list) -> list:
    """Each keep join the f32 guard refused and the f64 instance of K3
    took, on the plan's own factors: that instance against the dense f64
    route it replaced (``lowering._join_keep`` on the stacked factors), by
    CUDA events; both must give the same vector."""
    out = []
    for r in refusals:
        if r["route"] != "kernel-keep-f64":
            continue
        node = cp.plan.nodes[r["node"]]
        Ms, _ = cp._join_factors(node)
        axis = node.keep[0]
        kernel = lambda: mr.prod_reduce_keep(  # noqa: E731
            Ms, keep=axis, f64=True)
        dense = lambda: lowering._join_keep(  # noqa: E731
            torch.stack(Ms), axis)
        if not torch.equal(kernel(), dense()):
            raise AssertionError(f"{r['node']}: the f64 instance differs "
                                 f"from the dense route")
        out.append({"node": r["node"], "keep": axis, "factors": len(Ms),
                    "shape": list(Ms[0].shape),
                    "kernel_ms": timed_ms(kernel, 10),
                    "dense_route_ms": timed_ms(dense, 10)})
    return out


def drive_local(info: dict, patterns) -> dict:
    """The partial-embedding path on one graph of phase 3."""
    g, cache, apct = info["g"], info["cache"], info["apct"]
    before = launch_counts()
    free_before = torch.cuda.mem_get_info()[0]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cp = compiler.compile(patterns, g, cache=cache, apct=apct, local=True,
                          use_pallas=True)
    compile_s = time.perf_counter() - t0
    if cp.from_cache or not cp.plan.meta["local"]:
        raise AssertionError("local=True did not recompile the cached plan")
    t0 = time.perf_counter()
    counts = cp.counts()           # the triangle count takes the fused kernel
    torch.cuda.synchronize()
    counts_s = time.perf_counter() - t0
    if counts != info["counts"]:
        raise AssertionError(f"counts of the local plan {counts} != phase 3 "
                             f"{info['counts']}")
    t0 = time.perf_counter()
    got = read_local(cp, g, patterns, counts, cache, apct)
    torch.cuda.synchronize()
    reads_s = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    # the triangle count through the fused kernel vs clique enumeration
    triangles = {}
    for key, want in info["intersect3"].items():
        value = cp.value(key)
        if value != want:
            raise AssertionError(f"{key}: fused triangle kernel {value!r} "
                                 f"!= clique enumeration {want!r}")
        triangles[key] = value
    if not triangles:
        raise AssertionError("the pattern set has no Intersect k=3 node")
    t0 = time.perf_counter()
    against = check_dense_route(cp, g, patterns, got["anchored"])
    dense_s = time.perf_counter() - t0
    refusals = check_f64_routes(info["label"], cp, local_joins(cp))
    # MINI domains: a second union recompile, same engine
    t0 = time.perf_counter()
    cpd = compiler.compile(patterns, g, cache=cache, apct=apct,
                           counter=cp.counter, domains=True)
    if cpd.from_cache or not (cpd.plan.meta["domains"]
                              and cpd.plan.meta["local"]):
        raise AssertionError("domains=True did not recompile with the union")
    mini = {}
    for i, p in enumerate(patterns):
        if i in got["refused"]:      # its domain nodes are the same vectors
            continue
        key = compiler.pattern_key(p)
        # domain vectors are keyed by orbit representatives of the
        # canonical form; so are the anchored reads of p.canonical()
        for rep, dom in cpd.domains(p).items():
            if not torch.equal(dom, cp.local_counts(p.canonical(), rep)):
                raise AssertionError(f"{key} rep {rep}: domain vector != "
                                     f"anchored vector")
        mini[key] = cpd.mini_support(p)
    domains_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    joins = local_joins(cp)
    report = {
        "graph": info["label"], "role": info["role"],
        "launches": launches,
        "local_cuts": cp.plan.meta["local_cuts"],
        "keep_joins": [{k: j[k] for k in ("node", "cut", "keep", "route",
                                          "block", "guard")}
                       for j in joins if len(j["keep"]) < j["cut"]],
        "keep_joins_left_to_dense_route": [
            j["node"] for j in joins if j["route"] == "dense-f64-keep"],
        "keep_joins_refused_by_guard": refusals,
        "triangles_via_fused_kernel": triangles,
        "anchored_checked_against": against,
        "unanchored_cut2_tensor": got["unanchored"],
        "anchored_refused_plan_too_wide": sorted(set(
            got["refused"].values())),
        "reads": got["reads"], "mini_support": mini,
        "peak_device_bytes": peak,
        "seconds": {"compile_local": round(compile_s, 3),
                    "counts_use_pallas": round(counts_s, 3),
                    "reads": round(reads_s, 3),
                    "dense_route_check": round(dense_s, 3),
                    "compile_domains_and_reads": round(domains_s, 3)}}
    report["_anchored"] = got["anchored"]     # for the mesh path
    if any(r["route"] == "kernel-keep-f64" for r in refusals):
        report["_plan"] = cp         # for time_refused_keep_joins, after
    del cp, cpd, got                 # the phase has read its launch counts
    torch.cuda.empty_cache()
    report["free_bytes_before"] = free_before
    report["free_bytes_after"] = torch.cuda.mem_get_info()[0]
    return report


COVERAGE_KEEP3_GRAPH = "erdos_renyi(512, 8.0, seed=0)"


def drive_keep3_coverage() -> dict:
    """Anchored |cut| = 3 joins are chosen only on a small graph: there
    the keep form of the tri join runs, and each anchored vector is held
    against ``CountingEngine.inj_free`` and the dense f64 route.  Each of
    its launches is reported with the entry it took (the slab entry must
    run), and the per-entry launch counts must match those entries."""
    g = erdos_renyi(512, 8.0, seed=0)
    patterns = [chain(6), cycle(6), HOUSE]
    before = launch_counts()
    checked, tri_joins, vectors = 0, [], {}
    with recording_tri_joins(tri_joins):
        cp = compiler.compile(patterns, g, cache=False, local=True)
    dense = lowering.lower(cp.plan, g, counter=cp.counter,
                           cutjoin_kernel=False)
    for p in patterns:
        for orbit in p.vertex_orbits():
            with recording_tri_joins(tri_joins):
                vec = cp.local_counts(p, orbit[0])
            want = torch.from_numpy(
                cp.counter.inj_free(p, orbit[0]).copy()).to(DEV)
            if not (torch.equal(vec, want)
                    and torch.equal(vec, dense.local_counts(p, orbit[0]))):
                raise AssertionError(f"{compiler.pattern_key(p)} anchor "
                                     f"{orbit[0]}: kernel route differs")
            vectors[patterns.index(p), orbit[0]] = vec
            checked += 1
    joins = [j for j in local_joins(cp) if j["cut"] == 3]
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    if launches["trijoin_keep"] < 1:
        raise AssertionError(f"{COVERAGE_KEEP3_GRAPH}: no keep tri join "
                             f"launched: {cp.plan.meta['local_cuts']}")
    entries = {"slab": launches["cutjoin_tri_keep_slab"],
               "template": launches["cutjoin_tri_keep"]}
    recorded = {e: sum(j.get("entry") == e for j in tri_joins)
                for e in entries}
    if entries["slab"] < 1 or entries != recorded:
        raise AssertionError(f"{COVERAGE_KEEP3_GRAPH}: keep tri joins by "
                             f"entry {entries}, recorded {recorded}")
    return {"graph": COVERAGE_KEEP3_GRAPH, "role": "coverage-keep3",
            "patterns": [compiler.pattern_key(p) for p in patterns],
            "anchored_vectors_checked": checked,
            "keep3_joins": [{k: j[k] for k in ("node", "keep", "route",
                                               "block", "guard")}
                            for j in joins],
            "tri_joins": tri_joins, "keep3_launches_by_entry": entries,
            "local_cuts": cp.plan.meta["local_cuts"], "launches": launches,
            "_anchored": vectors}


def phase_local_path(main: dict) -> dict:
    patterns = [tailed_triangle(), cycle(4), chain(5)] + \
        list(motif_patterns(4))
    reset_launch_counts()                    # counts start at 0 here ...
    reports = [drive_local(info, patterns) for info in main["graphs"]]
    coverage = drive_keep3_coverage()
    launches = launch_counts()               # ... and are read here
    for kernel in ("pairjoin_keep", "trijoin_keep", "matreduce",
                   "cutjoin_pair_keep_rows", "cutjoin_tri_keep_slab"):
        if launches[kernel] < 1:
            raise AssertionError(f"the local path launched no {kernel}")
    by_role = {r["role"]: r["launches"] for r in reports}
    main_keep = by_role["main"]
    if main_keep["cutjoin_pair_keep_rows_f64"] + \
            main_keep["cutjoin_pair_keep_f64"] < 1:
        raise AssertionError(f"{MAIN_GRAPH}: no keep join took the f64 "
                             f"instance of K3")
    # the refused keep joins on both routes, after the counts were read:
    # these launches are a measurement, not the path
    for r in reports:
        cp = r.pop("_plan", None)
        r["refused_keep_joins_timed"] = cp and time_refused_keep_joins(
            cp, r["keep_joins_refused_by_guard"])
        del cp
    torch.cuda.empty_cache()
    by_role["coverage-keep3"] = coverage["launches"]
    # the single-device vectors the mesh path is held to
    anchored = {r["role"]: r.pop("_anchored") for r in reports}
    anchored["coverage-keep3"] = coverage.pop("_anchored")
    emit("local_path", patterns=len(patterns), launches=launches,
         graphs=reports, keep3_coverage=coverage)
    joins = [j for r in reports for j in r["keep_joins"]] + \
        [dict(j, cut=3) for j in coverage["keep3_joins"]]
    refused = {r["role"]: r["anchored_refused_plan_too_wide"]
               for r in reports}
    return {"launches": launches, "by_role": by_role, "joins": joins,
            "patterns": patterns, "anchored": anchored, "refused": refused}


# -- phase 5 ------------------------------------------------------------------------

def phase_graph_ops(main: dict) -> dict:
    """The graph kernels through ``kernels.ops`` on the user's graph:
    per-edge common-neighbour counts (K8: the adjacency packed on the card,
    the packed rows gathered in the kernel), the wedge-closing product
    mask ⊙ (A·Aᵀ) (K7) and the triangle count Σ A ⊙ (A·A) / 6 (K6).
    Identities: Σ_edges common neighbours = 3 T, the product read at each
    edge equals K8's count there, Σ of the product = 6 T, where T is phase
    3's triangle count (clique enumeration) and equals K6's.  K7 and K6
    must take their tensor-core routes (read from the flags they left on
    the card).  ``common_neighbors(Ab, g.edges)`` runs under
    ``torch.cuda.set_sync_debug_mode("error")``: it must make no
    synchronising call.  Then, after the launches are read, the call is
    split into its pieces (``common_neighbors_split``)."""
    info = main["rmat"]
    g, T = info["g"], info["triangles"]
    A = rmat_adjacency(g)
    Ab = A > 0
    torch.cuda.synchronize()
    reset_launch_counts()                    # counts start at 0 here ...
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cn = ops.common_neighbors(Ab, g.edges)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    cn_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    S = ops.sddmm(A, A, A)
    torch.cuda.synchronize()
    sddmm_s = time.perf_counter() - t0
    route = sddmm_route(A, A, "tc")
    skipped = sddmm_skipped(ksd.last_tiles)
    t0 = time.perf_counter()
    k6 = ops.triangle_count(A)
    k6_s = time.perf_counter() - t0
    launches = launch_counts()               # ... and are read here
    for kernel in ("sddmm", "sddmm_prep", "sddmm_tc", "bitset_edges",
                   "bitset_pack", "matreduce", "matreduce_prep",
                   "matreduce_tc"):
        if launches[kernel] < 1:
            raise AssertionError(f"graph_ops launched no {kernel}")
    if (launches["bitset_pack"], launches["bitset_edges"]) != (1, 1):
        raise AssertionError(f"common_neighbors launched bitset_pack "
                             f"{launches['bitset_pack']} and bitset_edges "
                             f"{launches['bitset_edges']} times, not once")
    k6_route = matreduce_route(A, A, "tc")
    edges = torch.from_numpy(g.edges).to(DEV)
    at_edges = S[edges[:, 0], edges[:, 1]]
    checks = {"triangles_T": T, "sum_common_neighbors": cn.sum().item(),
              "sum_sddmm": S.sum(dtype=torch.float64).item(),
              "k6_triangles": k6,
              "sddmm_at_edges_equals_common_neighbors": bool(
                  torch.equal(at_edges, cn.float())),
              "common_neighbors_sync_debug_mode": "error"}
    if not (checks["sum_common_neighbors"] == 3 * T
            and checks["sum_sddmm"] == 6 * T and k6 == T
            and checks["sddmm_at_edges_equals_common_neighbors"]):
        raise AssertionError(f"graph_ops identities fail: {checks}")
    del S, at_edges
    split = common_neighbors_split(g, Ab, cn)
    emit("graph_ops", graph=MAIN_GRAPH, edges=len(g.edges),
         launches=launches, checks=checks, sddmm_route=route,
         sddmm_tiles=skipped, matreduce_route=k6_route,
         seconds={"common_neighbors": round(cn_s, 6),
                  "sddmm": round(sddmm_s, 4),
                  "triangle_count": round(k6_s, 4)},
         common_neighbors_split=split)
    del Ab
    torch.cuda.empty_cache()
    return {"launches": launches, "by_role": {"main": launches},
            "edges": len(g.edges), "split": split}


def common_neighbors_split(g, Ab, cn) -> dict:
    """``ops.common_neighbors(Ab, g.edges)`` in its pieces, by CUDA events
    (mean after a warm-up): the pairs' upload (not blocking), the
    packing kernel, the host check of the pairs (numpy), the edge kernel
    alone, and the whole call; beside them the pieces of its earlier design
    (a blocking upload, the packing in PyTorch
    ``pack_bitsets_plain``, the check by two reductions and two host
    syncs on the card).  Each piece's result is held to the call's."""
    packed = kbs.pack_bitsets(Ab)
    edges = kbs.upload(g.edges, DEV)
    E, W = edges.shape[0], packed.shape[1]
    counts = torch.empty((E,), dtype=torch.int32, device=DEV)
    flag = torch.zeros((1,), dtype=torch.int32, device=DEV)
    stream = torch.cuda.current_stream().cuda_stream
    launch = lambda: kbs._lib().bitset_edges(  # noqa: E731
        packed.data_ptr(), W, packed.stride(0), packed.shape[0],
        edges.data_ptr(), E, counts.data_ptr(), flag.data_ptr(), 1, stream)

    def old_check():                         # on the uploaded pairs
        return int(edges.min()) >= 0 and int(edges.max()) < packed.shape[0]

    launch()
    assert torch.equal(counts, cn) and flag.item() == 0
    assert torch.equal(kbs.pack_bitsets_plain(Ab), packed) and old_check()
    return {
        "upload_ms": timed_ms(lambda: kbs.upload(g.edges, DEV), 20),
        "pack_ms": timed_ms(lambda: kbs.pack_bitsets(Ab), 20),
        "check_ms": timed_ms(lambda: kbs.check_pairs_host(g.edges, N), 20),
        "kernel_ms": timed_ms(launch, 50),
        "call_ms": timed_ms(lambda: ops.common_neighbors(Ab, g.edges), 20),
        "earlier_design": {
            "upload_ms": timed_ms(lambda: torch.as_tensor(g.edges).to(DEV),
                                  20),
            "pack_plain_ms": timed_ms(lambda: kbs.pack_bitsets_plain(Ab), 5),
            "check_two_syncs_ms": timed_ms(old_check, 20)}}


# -- morph path --------------------------------------------------------------------

MORPH_STORE_DIR = os.path.join(ROOT, "build", "morph_store")
JOIN_KERNELS = ("vecjoin", "pairjoin", "trijoin")


def phase_morph_path(main: dict) -> dict:
    """The morph count store on the user's graph, with phase 3's APCT: a
    ``CountStore`` on disk under the ignored ``build/`` is warmed by
    compiling the 3-star and the diamond with ``morph=`` (their joins run
    the join kernels: the 3-star's |cut| = 1 join and the diamond's
    |cut| = 2 join, as in phase 3); then every ``motif_family(4)`` member
    is compiled with ``morph=`` and counted in turn (pass 1): a member
    whose identity closes over the store takes the fast path (``meta
    ["morph"]``), the others search with the held homs priced at 0 and
    feed the store back.  Pass 2 answers the family again from a fresh
    ``CountStore`` on the same directory: every member on the fast path,
    no contraction, no kernel launch.  Every count must equal the same
    family compiled with ``morph=False`` on the same graph (timed, the
    answer without the store)."""
    g, apct = main["rmat"]["g"], main["rmat"]["apct"]
    shutil.rmtree(MORPH_STORE_DIR, ignore_errors=True)
    store = cmorph.CountStore(MORPH_STORE_DIR)
    gsig = graph_signature(g)
    family = cmorph.motif_family(4)
    warm = [p for p in family if pattern_key(p) in ("4.52", "4.62")]
    assert len(warm) == 2, "the 3-star and the diamond are family members"
    before = launch_counts()
    t0 = time.perf_counter()
    cp = compiler.compile(warm, g, apct=apct, cache=False, morph=store)
    cp.counts()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_launches = {k: v - before[k] for k, v in launch_counts().items()
                     if v != before[k]}
    if not any(warm_launches.get(k) for k in JOIN_KERNELS):
        raise AssertionError(f"warming the store launched no join kernel: "
                             f"{warm_launches}")
    del cp
    t0 = time.perf_counter()
    plain = compiler.compile(family, g, apct=apct, cache=False)
    want = plain.counts()
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    del plain
    first, fallbacks = [], []
    for p in family:
        held = store.held_hom_keys(gsig)
        t0 = time.perf_counter()
        cp = compiler.compile((p,), g, apct=apct, cache=False, morph=store)
        got = cp.count(p)
        torch.cuda.synchronize()
        row = {"pattern": pattern_key(p), "count": got,
               "fast": cp.plan.meta.get("morph") is True,
               "store_reads": len(cp.morph_reads),
               "contractions": cp.counter.stats["hom_evals"],
               "seconds": round(time.perf_counter() - t0, 4)}
        if not row["fast"]:
            costs = cp.plan.meta["node_costs"]
            priced = sorted(k for k in cp.plan.nodes if k in held)
            row["held_nodes_in_plan"] = priced
            row["held_nodes_priced_0"] = all(costs.get(k) == 0.0
                                             for k in priced)
            fallbacks.append(row)
        first.append(row)
        del cp
    assert any(r["fast"] for r in first), "no member took the fast path"
    assert any(r["held_nodes_in_plan"] and r["held_nodes_priced_0"]
               for r in fallbacks), \
        "no member fell back to a search with held homs priced at 0"
    # pass 2: a fresh store on the same directory answers the family
    fresh = cmorph.CountStore(MORPH_STORE_DIR)
    before = launch_counts()
    second = []
    t0 = time.perf_counter()
    for p in family:
        cp = compiler.compile((p,), g, apct=apct, cache=False, morph=fresh)
        second.append({"pattern": pattern_key(p), "count": cp.count(p),
                       "fast": cp.plan.meta.get("morph") is True,
                       "contractions": cp.counter.stats["hom_evals"]})
    torch.cuda.synchronize()
    store_s = time.perf_counter() - t0
    moved = {k: v - before[k] for k, v in launch_counts().items()
             if v != before[k]}
    if moved:
        raise AssertionError(f"answers from the store launched {moved}")
    for r in second:
        if not r["fast"] or r["contractions"]:
            raise AssertionError(f"{r['pattern']}: not answered from the "
                                 f"store alone: {r}")
    for rows in (first, second):
        for r in rows:
            if r["count"] != want[r["pattern"]] or \
                    r["count"] != round(r["count"]):
                raise AssertionError(f"{r['pattern']}: morph count "
                                     f"{r['count']} != {want[r['pattern']]}")
    emit("morph_path", graph=MAIN_GRAPH, store_dir="build/morph_store",
         family=len(family), warm=[pattern_key(p) for p in warm],
         warm_launches=warm_launches, store_entries=len(fresh),
         first_pass=first, second_pass=second,
         seconds={"warm": round(warm_s, 4),
                  "family_without_store": round(plain_s, 4),
                  "family_from_store": round(store_s, 6)})
    return {"seconds": {"family_without_store": plain_s,
                        "family_from_store": store_s}}


# -- phase 5c -----------------------------------------------------------------------

BATCHER_LABELLED = "rmat(13, 24.0, seed=0, num_labels=2)"
# the labelled patterns of the reference's batcher support test
# (tests/test_labelled.py)
LABELLED = (Pattern(3, [(0, 1), (1, 2)], (0, 1, 0)),
            Pattern(4, [(0, 1), (1, 2), (0, 2), (2, 3)], (0, 1, 0, 1)))


def batcher_stream(seed: int = 0) -> tuple:
    """The mixed request stream on the user's graph, in three waves of at
    most 8 (one step each at ``max_batch=8``), each wave shuffled from
    ``seed``: every 4-vertex motif counted alone, twice (the second
    time from the batcher's plan memo); chain(4) and cycle(4) counted
    together, twice; chain(4)'s anchored vectors at anchors 0 and 1 (one
    local plan); chain(4)'s 10 hottest vertices, twice (the same plan).
    Then the labelled graph's stream: the supports of ``LABELLED``
    (domains plan) four times and their counts twice (a plan-cache hit
    on the domains plan)."""
    rng = np.random.default_rng(seed)
    motifs = list(motif_patterns(4))
    pair = (chain(4), cycle(4))
    waves = [[dict(patterns=(m,)) for m in motifs]
             + [dict(patterns=pair), dict(patterns=(chain(4),), local=True,
                                          anchor=0)],
             [dict(patterns=(m,)) for m in motifs]
             + [dict(patterns=(chain(4),), local=True, anchor=1),
                dict(patterns=(chain(4),), top_k=10)],
             [dict(patterns=pair), dict(patterns=(chain(4),), top_k=10)]]
    main = [spec for wave in waves for spec in
            (wave[i] for i in rng.permutation(len(wave)))]
    labelled = [dict(patterns=LABELLED, support=True)] * 4 + \
        [dict(patterns=LABELLED)] * 2
    labelled = [labelled[i] for i in rng.permutation(len(labelled))]
    uid = iter(range(10 ** 6))
    return ([PatternRequest(uid=next(uid), **spec) for spec in main],
            [PatternRequest(uid=next(uid), **spec) for spec in labelled])


def serve_stream(batcher, requests) -> list:
    """Submit ``requests``, then step until the queue is empty, each step
    timed to the card's end."""
    for req in requests:
        batcher.submit(req)
    step_s = []
    while batcher.queue:
        t0 = time.perf_counter()
        batcher.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    return step_s


def check_served(batcher, g, apct) -> list:
    """Every finished request against the same pattern set compiled
    outside the batcher (``cache=False``, no morph store, an engine of
    its own) and read directly: ``count``, ``local_counts``,
    ``mini_support`` and ``top_vertices(plan_vertex_counts(...))``, each
    integer-equal.  Returns one answer per request kind and pattern (the
    first three pairs of a ``top_k`` answer)."""
    engine = CountingEngine(g)
    plans, answers = {}, {}
    for req in batcher.finished:
        if req.error:
            raise AssertionError(f"request {req.uid} was not served")
        local = req.local or req.top_k is not None
        key = (tuple(pattern_key(p) for p in req.patterns), req.support,
               local)
        if key not in plans:
            plans[key] = compiler.compile(req.patterns, g, apct=apct,
                                          cache=False, counter=engine,
                                          domains=req.support, local=local)
        cp = plans[key]
        for p in req.patterns:
            if req.support:
                got, want = req.supports[p], cp.mini_support(p)
            elif req.top_k is not None:
                got = req.hotspots[p]
                want = api.top_vertices(api.plan_vertex_counts(cp, p),
                                        req.top_k)
            elif req.local:
                vec, ref = req.local_counts[p], \
                    cp.local_counts(p, req.anchor)
                got = vec.sum().item()
                want = ref.sum().item()
                if not torch.equal(vec, ref):
                    raise AssertionError(f"request {req.uid} {p}: anchored "
                                         f"vector differs")
            else:
                got, want = req.counts[p], cp.count(p)
            if got != want:
                raise AssertionError(f"request {req.uid} {pattern_key(p)}: "
                                     f"batcher {got!r} != direct {want!r}")
            kind = ("support" if req.support else "top_k" if req.top_k
                    else f"local@{req.anchor}" if req.local else "count")
            answers[f"{kind} {pattern_key(p)}"] = \
                got[:3] if kind == "top_k" else got
    return answers


def phase_batcher_path(main: dict) -> dict:
    """The paper's serving loop, ``PatternQueryBatcher``, on the user's
    graph with phase 3's APCT and a fresh disk ``CountStore`` in a
    temporary directory: ``batcher_stream``'s requests at ``max_batch=8``.
    Launch counts start at 0 before the stream and are read after it.
    Then the labelled graph's supports and counts through a batcher of
    its own.  Every answer is held to a direct compile and read; the
    stats must show no fallback and no error."""
    g, apct = main["rmat"]["g"], main["rmat"]["apct"]
    requests, labelled = batcher_stream()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        store = cmorph.CountStore(d)
        b = PatternQueryBatcher(g, apct=apct, max_batch=8, morph=store)
        reset_launch_counts()                # counts start at 0 here ...
        t0 = time.perf_counter()
        step_s = serve_stream(b, requests)
        stream_s = time.perf_counter() - t0
        launches = {k: v for k, v in launch_counts().items() if v}
        # ... and are read here
        store_entries = len(store)
    if not any(launches.get(k) for k in JOIN_KERNELS + ("pairjoin_keep",)):
        raise AssertionError(f"the stream launched no join kernel: "
                             f"{launches}")
    t0 = time.perf_counter()
    gl = rmat(13, 24.0, seed=0, num_labels=2)
    lab_graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    apct_l = APCT(gl)
    lab_apct_s = time.perf_counter() - t0
    bl = PatternQueryBatcher(gl, apct=apct_l, max_batch=8)
    t0 = time.perf_counter()
    lab_step_s = serve_stream(bl, labelled)
    lab_s = time.perf_counter() - t0
    stats = {"main": dict(b.stats), "labelled": dict(bl.stats)}
    for side in stats.values():
        bad = {k: v for k, v in side.items()
               if k.startswith(("fallbacks", "errors")) and v}
        if bad:
            raise AssertionError(f"batcher fell back or failed: {bad}")
    t0 = time.perf_counter()
    answers = {**check_served(b, g, apct), **check_served(bl, gl, apct_l)}
    check_s = time.perf_counter() - t0
    n_main, n_lab = len(requests), len(labelled)
    emit("batcher_path", graph=MAIN_GRAPH, labelled_graph=BATCHER_LABELLED,
         requests=n_main + n_lab, requests_main=n_main,
         requests_labelled=n_lab, max_batch=8, stats=stats,
         launches_main_stream=launches, morph_store_entries=store_entries,
         from_cache=[r.from_cache for r in b.finished + bl.finished],
         answers=answers,
         seconds={"steps_main": [round(t, 4) for t in step_s],
                  "stream_main": round(stream_s, 4),
                  "per_request_main": round(stream_s / n_main, 4),
                  "labelled_graph": round(lab_graph_s, 3),
                  "labelled_apct_sampling": round(lab_apct_s, 3),
                  "steps_labelled": [round(t, 4) for t in lab_step_s],
                  "stream_labelled": round(lab_s, 4),
                  "per_request_labelled": round(lab_s / n_lab, 4),
                  "direct_checks": round(check_s, 3)})
    del b, bl, gl, apct_l
    torch.cuda.empty_cache()
    return {"launches": launches}


# -- phase 6 ------------------------------------------------------------------------

MINE_GRAPH = ["--graph", "rmat", "--n", str(N), "--deg", "24"]
FSM_SUPPORT = 100
_TIMING = re.compile(r"^done in |plan nodes \(cache (hit|miss), ")


def run_mine(argv) -> dict:
    """``repro_torch.launch.mine.main`` as a user calls it, on the card,
    with its standard output captured: the lines without the timing ones,
    and the seconds it took."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        mine.main(list(argv) + MINE_GRAPH)
    torch.cuda.synchronize()
    lines = buf.getvalue().splitlines()
    return {"argv": " ".join(argv), "seconds": round(time.perf_counter() - t0,
                                                     3),
            "lines": [line for line in lines if not _TIMING.search(line)]}


def _number(text: str) -> float:
    return float(text.replace(",", ""))


def _after(lines, head: str) -> list:
    """(value, vertex) pairs of the ``vN: value`` lines after ``head``."""
    out = []
    for line in lines[lines.index(head) + 1:]:
        m = re.fullmatch(r"\s+v(\d+): ([\d,]+)", line)
        if not m:
            break
        out.append((_number(m.group(2)), int(m.group(1))))
    return out


@contextlib.contextmanager
def recording_compiles(plans: list):
    """Every ``CompiledPlan`` that ``compiler.compile`` returns while the
    context is open, in ``plans``."""
    compile_ = compiler.compile

    def record(*args, **kwargs):
        cp = compile_(*args, **kwargs)
        plans.append(cp)
        return cp

    compiler.compile = record
    try:
        yield plans
    finally:
        compiler.compile = compile_


def trace_report(path: str, plans: list) -> dict:
    """The first per-node split of a mining run on the card, read from
    the trace file ``mine --trace`` wrote: root spans and node coverage,
    the ten spans with the largest self time, every join span's route
    held to its plan's ``join_log`` record, and the drift report
    (``obs.drift.aggregate`` of ``pairs_from_trace``), whose groups sum
    the measured self time per node class × cut size × route."""
    with open(path) as fh:
        trace = json.load(fh)
    spans = [s for root in trace["spans"] for s in obs.drift._walk(root)]
    records = {rec["node"]: rec for cp in plans for rec in cp.join_log}
    joins = 0
    for s in spans:
        if s["kind"] in ("CutJoin", "LocalCount"):
            want = records[s["name"]]["route"]
            if s["attrs"].get("route") != want:
                raise AssertionError(f"trace {s['name']}: route "
                                     f"{s['attrs'].get('route')} != "
                                     f"join_log {want}")
            joins += 1
    if not joins:
        raise AssertionError("the traced run recorded no join span")
    nodes = sorted((s for s in spans if s["kind"] != "execute"),
                   key=lambda s: -s["self_us"])
    report = obs.drift.aggregate(obs.drift.pairs_from_trace(trace))
    return {"backend": trace["meta"]["backend"],
            "root_spans": len(trace["spans"]),
            "node_coverage": trace["coverage"], "spans": len(spans),
            "root_seconds": sum(r["dur_us"] for r in trace["spans"]) / 1e6,
            "join_spans_equal_join_log": joins,
            "top_self_time": [
                {"name": s["name"], "kind": s["kind"],
                 "self_ms": s["self_us"] / 1e3,
                 "cut_size": s["attrs"].get("cut_size"),
                 "route": s["attrs"].get("route")} for s in nodes[:10]],
            "drift": report}


def check_mine_runs(info: dict) -> dict:
    """Every ``--app`` of the mining CLI on the user's graph, each held to
    an identity or to a second route, and ``motif --k 4`` twice more, the
    second time with ``--trace`` (both hit the plan cache the first run
    filled): the same lines, and the trace read by ``trace_report``.
    Returns the runs and checks."""
    runs, checks = {}, {}
    runs["motif"] = run_mine(["--app", "motif", "--k", "4"])
    runs["motif_legacy"] = run_mine(["--app", "motif", "--k", "4",
                                     "--no-compiler"])
    if runs["motif"]["lines"] != runs["motif_legacy"]["lines"]:
        raise AssertionError("motif: compiled and --no-compiler differ")
    checks["motif_equals_no_compiler"] = len(runs["motif"]["lines"])
    # the same run again, untraced: like the traced run after it, a hit
    # in the process plan cache, so the two differ by the tracing alone
    runs["motif_cached"] = run_mine(["--app", "motif", "--k", "4"])
    if runs["motif_cached"]["lines"] != runs["motif"]["lines"]:
        raise AssertionError("motif: a second run differs from the first")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        path = os.path.join(d, "motif.json")
        with recording_compiles([]) as plans:
            run = runs["motif_traced"] = run_mine(
                ["--app", "motif", "--k", "4", "--trace", path])
        head = f"trace: {path} ({len(motif_patterns(4))} root spans, "
        if run["lines"][:-1] != runs["motif"]["lines"] or \
                not run["lines"][-1].startswith(head):
            raise AssertionError(f"motif --trace: {run['lines']} vs "
                                 f"{runs['motif']['lines']}")
        checks["motif_trace"] = trace_report(path, plans)

    run = runs["chain"] = run_mine(["--app", "chain", "--k", "5",
                                    "--local-counts"])
    count = _number(run["lines"][1].rsplit(": ", 1)[1])
    want = info["counts"][compiler.pattern_key(chain(5))]
    top = api.vertex_counts(chain(5), info["g"], apct=info["apct"],
                            top_k=10)
    printed = _after(run["lines"], "  hottest vertices (embeddings "
                                   "containing u):")
    if count != want or printed != top:
        raise AssertionError(f"chain(5): {count!r} vs phase 3 {want!r}; "
                             f"top {printed} vs vertex_counts {top}")
    checks["chain5_count"] = count
    checks["chain5_top10_equals_vertex_counts"] = True

    run = runs["pc"] = run_mine(["--app", "pc", "--k", "4",
                                 "--local-counts"])
    pc = search.mine_pseudo_cliques(info["g"], 4, missing=1)
    weighted = sum(p.n * t for p, t in pc.totals.items())
    total = _number(run["lines"][1].split(": ", 1)[1].split(" across")[0])
    hot = _after(run["lines"], "  hotspots (participation):")
    want_hot = [(pc.per_vertex[u].item(), u) for u in pc.hotspots[:10]]
    diamond = pseudo_clique(4, 1)[0]
    if not (pc.per_vertex.sum().item() == weighted
            and total == sum(pc.totals.values()) and hot == want_hot
            and pc.totals[diamond]
            == info["counts"][compiler.pattern_key(diamond)]):
        raise AssertionError(f"pc: Σ per_vertex {pc.per_vertex.sum()} vs "
                             f"Σ n_p·totals {weighted}; printed {total} / "
                             f"{hot}")
    checks["pc_sum_per_vertex_equals_sum_np_totals"] = weighted

    runs["existence_local"] = run_mine(["--app", "existence", "--k", "5",
                                        "--local-counts"])
    runs["existence"] = run_mine(["--app", "existence", "--k", "5"])
    if runs["existence"]["lines"] != runs["existence_local"]["lines"]:
        raise AssertionError("existence: --local-counts answers differ")
    checks["existence"] = runs["existence"]["lines"][1:]

    fsm_args = ["--app", "fsm", "--labels", "6", "--k", "3", "--support",
                str(FSM_SUPPORT)]
    runs["fsm"] = run_mine(fsm_args)
    runs["fsm_legacy"] = run_mine(fsm_args + ["--no-compiler"])
    head = runs["fsm"]["lines"][1]
    levels = re.search(r"(\d+)/(\d+) levels compiled", head)
    compiled_levels, total_levels = int(levels[1]), int(levels[2])
    legacy = [line.replace(f"0/{total_levels} levels",
                           f"{total_levels}/{total_levels} levels")
              for line in runs["fsm_legacy"]["lines"]]
    if runs["fsm"]["lines"] != legacy or total_levels < 2 \
            or compiled_levels != total_levels:
        raise AssertionError(f"fsm: compiled {runs['fsm']['lines']} vs "
                             f"--no-compiler {runs['fsm_legacy']['lines']}")
    checks["fsm_levels"] = total_levels
    return {"runs": runs, "checks": checks}


def check_engine_tier(info: dict) -> dict:
    """Block-sparse triangles through K6's tile list — one call (one
    launch of each of its three entries, no dense K6 launch) over every
    output tile — and partial symmetry breaking on the user's graph."""
    g, T = info["g"], info["triangles"]
    before = launch_counts()
    t0 = time.perf_counter()
    bsa = BlockSparseAdjacency(g)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    tb = triangle_count_blocksparse(bsa, use_kernel=True)
    count_s = time.perf_counter() - t1
    bs_s = time.perf_counter() - t0
    moved = {k: v - before[k] for k, v in launch_counts().items()
             if v != before[k]}
    out_idx, k_ptr = tile_lists(bsa)[:2]
    tiles = sum(1 for (i, j) in bsa.blocks
                if any((k, j) in bsa.blocks for k in bsa.row_blocks[i]))
    want = dict(matreduce_tilelist=1, **dict.fromkeys(mr.TILELIST_STEPS, 1))
    if tb != T or moved != want or len(out_idx) != tiles:
        raise AssertionError(f"blocksparse: {tb!r} vs T {T!r}; launches "
                             f"{moved} for {tiles} output tiles")
    route = tilelist_route(bsa.tiles, k_ptr, "tc")
    blocksparse = {**bsa.stats(), "triangles": tb, "launches": moved,
                   "route": route, "output_tiles": tiles,
                   "tile_products": int(k_ptr[-1]),
                   "longest_list": int(np.diff(k_ptr).max()),
                   "seconds": round(bs_s, 4),
                   "seconds_build": round(build_s, 4),
                   "seconds_count": round(count_s, 4)}
    del bsa
    A = torch.from_numpy(g.dense_adjacency(np.float64, pad=False)).to(DEV)
    # a clique orbit (the tailed triangle's (0, 1)): hom itself.  The
    # order is given: greedy_plan with free (0, 1) eliminates vertex 2
    # before the leaf 3, an n^3 intermediate (PlanTooWide at n = 8192)
    tt = tailed_triangle()
    oriented = symmetry.hom_oriented(tt, A, (0, 1),
                                     order=(3, 2, 0, 1)).item()
    hom = H.hom_count(tt, A).item()
    # an independent orbit (chain(3)'s endpoints): hom over distinct
    # endpoint assignments, Σ_v d(d - 1), which is hom(chain(3)) - 2m
    ends = symmetry.hom_oriented(chain(3), A, (0, 2)).item()
    deg = A.sum(1)
    distinct = (deg * (deg - 1)).sum().item()
    hom3 = H.hom_count(chain(3), A).item()
    if oriented != hom or ends != distinct or hom3 - ends != 2 * g.m:
        raise AssertionError(f"hom_oriented: {oriented} vs {hom}; chain(3) "
                             f"ends {ends} vs {distinct}")
    del A
    torch.cuda.empty_cache()
    return {"blocksparse": blocksparse,
            "hom_oriented": {"tailed_triangle_orbit_01": oriented,
                             "hom_count": hom,
                             "chain3_endpoints": ends,
                             "chain3_distinct_endpoints": distinct,
                             "chain3_hom_count": hom3}}


def phase_mine_path(main: dict) -> dict:
    """The mining driver as users run it, ``python -m
    repro_torch.launch.mine`` with ``--graph rmat --n 8192 --deg 24`` (the
    graph of phases 3-5), then the engine tier's block-sparse and
    symmetry routes on the same graph."""
    info = main["rmat"]
    reset_launch_counts()                    # counts start at 0 here ...
    mined = check_mine_runs(info)
    engine = check_engine_tier(info)
    launches = launch_counts()               # ... and are read here
    emit("mine_path", graph=MAIN_GRAPH, launches=launches,
         checks=mined["checks"], runs=mined["runs"], **engine)
    return {"launches": launches, "by_role": {"main": launches},
            "motif_lines": mined["runs"]["motif"]["lines"]}


# -- phase 6b -----------------------------------------------------------------------

MESH_SLOTS = (4, 3)          # 3 does not divide n = 8192: padding and trim
MESH_KERNELS = ("vecjoin", "pairjoin", "pairjoin_keep", "trijoin",
                "trijoin_keep")
# the f64 instances of K1 and K3 (K3 on either entry), for the joins the
# f32 guard refuses on the R-MAT graph
MESH_F64_ENTRIES = (("cutjoin_vec_f64",),
                    ("cutjoin_pair_keep_rows_f64", "cutjoin_pair_keep_f64"))
MESH_GATHERS = ("contract.finish_gathers", "contract.trim_gathers",
                "contract.slice_gathers")
_TILE_ENTRIES = ("prod_reduce_tiles", "prod_reduce_keep_tiles",
                 "tri_reduce_tiles", "tri_reduce_keep_tiles")


@contextlib.contextmanager
def recording_tile_calls(calls: dict):
    """The last call of each tile entry point per kernel, route and entry
    that the sharded tier makes while the context is open (the last slot:
    a non-zero global offset), with its operands — for the slice checks
    after the path's counts are read."""
    saved = {name: getattr(mr, name) for name in _TILE_ENTRIES}

    def key_of(name, factors, args, kw):
        f64 = ":f64" if kw.get("f64") else ""
        if name == "prod_reduce_tiles":
            return ("vecjoin" if factors[0].ndim == 1 else "pairjoin") + f64
        if name == "prod_reduce_keep_tiles":
            return (f"pairjoin_keep:keep={kw['keep']}:"
                    f"{mr.keep_entry(factors[0], kw['keep'])}" + f64)
        axes = args[0]
        if name == "tri_reduce_tiles":
            return f"trijoin:{mr.tri_route(axes)}"
        return (f"trijoin_keep:keep={kw['keep']}:" + mr.tri_keep_entry(
            factors, axes, kw["keep"], mr._tri_sizes(kw["n"])))

    def record(name):
        def call(factors, *args, **kw):
            calls[key_of(name, factors, args, kw)] = (name, list(factors),
                                                      args, dict(kw))
            return saved[name](factors, *args, **kw)
        return call

    for name in _TILE_ENTRIES:
        setattr(mr, name, record(name))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(mr, name, fn)


def check_slice_calls(calls: dict) -> list:
    """Each recorded slot call once more on the card, held against its
    plain version on the same slice and offsets at difference 0 (the path
    and triangle routes against the route's own plain version)."""
    cases = []
    for key, (name, fs, args, kw) in sorted(calls.items()):
        label = f"mesh slice {key} offsets {kw.get('offsets')}"
        plain_kw = {k: v for k, v in kw.items() if k != "f64"}
        if name == "prod_reduce_tiles" and kw.get("f64"):
            check_case("cutjoin_vec_f64", label,
                       lambda: mr.prod_reduce(fs, **kw),
                       lambda: mr.prod_reduce_f64_plain(fs), cases)
        elif name == "prod_reduce_tiles":
            kernel = "vecjoin" if fs[0].ndim == 1 else "pairjoin"
            check_case(kernel, label,
                       lambda: mr.prod_reduce(fs, **kw),
                       lambda: mr.prod_reduce_plain(fs, **plain_kw), cases)
        elif kw.get("f64"):
            entry = ("cutjoin_pair_keep_rows_f64"
                     if mr.keep_entry(fs[0], kw["keep"]) == "rows"
                     else "cutjoin_pair_keep_f64")
            check_case(entry, label,
                       lambda: mr.prod_reduce_keep(fs, **kw),
                       lambda: mr.prod_reduce_keep_f64_plain(
                           fs, keep=kw["keep"], offsets=kw["offsets"]),
                       cases)
        elif name == "prod_reduce_keep_tiles":
            check_case("pairjoin_keep", label,
                       lambda: mr.prod_reduce_keep(fs, **kw),
                       lambda: mr.prod_reduce_keep_plain(fs, **plain_kw),
                       cases)
        elif name == "tri_reduce_tiles":
            check_tri_case(label, fs, args[0], kw["n"], cases,
                           distinct=kw["distinct"], offsets=kw["offsets"],
                           block=kw["block"], n3_plain=False)
        else:
            check_tri_case(label, fs, args[0], kw["n"], cases,
                           distinct=kw["distinct"], offsets=kw["offsets"],
                           keep=kw["keep"], block=kw["block"])
        cases[-1]["sizes"] = [list(F.shape) for F in fs]
    return cases


def mesh_join_routes(cp, slots: int) -> dict:
    """Every join of a plan run under a mesh: a join the guard granted took
    its sharded kernel route; a refused |cut| = 1 join or |cut| = 2 keep
    join that ``exact_f64`` admits took the f64 instance on each slice
    (``kernel-f64-sharded[-keep]``), as it takes K1's / K3's f64 instance
    on one device; every other one the sharded dense f64 route.  Returns
    the tally of routes."""
    tally = {}
    for j in cp.join_log:
        keep = j["keep"] is not None and len(j["keep"]) < j["cut"]
        if j["keep"] is not None and not keep:
            want = "dense-product"
        elif j["block"] is not None:
            want = "kernel-sharded-keep" if keep else "kernel-sharded"
        else:
            want = "dense-f64-sharded-keep" if keep else "dense-f64-sharded"
            if j["guard"] == "scanned" and j["cut"] == (2 if keep else 1):
                Ms, _ = cp._join_factors(cp.plan.nodes[j["node"]])
                maxes = [abs_max(M) for M in Ms]
                n = cp.graph.n
                # the reduced axis: n cells
                if Ms[0].is_cuda and mr.exact_f64(maxes, n):
                    want = ("kernel-f64-sharded-keep" if keep
                            else "kernel-f64-sharded")
        if j["route"] != want:
            raise AssertionError(f"{slots} slots, {j['node']}: route "
                                 f"{j['route']}, want {want}")
        tally[want] = tally.get(want, 0) + 1
    return tally


def abs_max(M) -> float:
    """max |M| of a join factor: a tensor, or the contraction's slot
    blocks (``Sliced``)."""
    if isinstance(M, Sliced):
        return M.abs_max(M.parts[0].device).item()
    return M.abs().max().item()


def route_tally(tracer) -> dict:
    """Routes of the nodes a traced read evaluated, counted."""
    tally = {}
    for span in tracer.walk():
        r = span.attrs.get("route")
        if r:
            tally[r] = tally.get(r, 0) + 1
    return tally


def mesh_graph_run(info: dict, patterns, mesh, cycles=None) -> dict:
    """The main path's pattern set (and the coverage graph's cycles) on one
    graph under ``mesh``, with one mesh-bound engine: every count equal to
    phase 3's, the engine without a dense adjacency; the timed compile and
    first ``counts()`` split by node kind."""
    g, apct = info["g"], info["apct"]
    engine = CountingEngine(g, mesh=mesh)
    t0 = time.perf_counter()
    cp = compiler.compile(patterns, g, cache=False, apct=apct,
                          counter=engine, mesh=mesh)
    compile_s = time.perf_counter() - t0
    node_s = time_nodes(cp)
    cp.tracer = obs.Tracer()
    t0 = time.perf_counter()
    counts = cp.counts()
    torch.cuda.synchronize()
    counts_s = time.perf_counter() - t0
    if counts != info["counts"]:
        raise AssertionError(f"{info['label']}, {len(mesh.devices)} slots: "
                             f"{counts} != one device {info['counts']}")
    if engine._A_dense is not None:
        raise AssertionError("the mesh-bound engine built a dense adjacency")
    out = {"graph": info["label"], "role": info["role"],
           "join_routes": mesh_join_routes(cp, len(mesh.devices)),
           "node_routes": route_tally(cp.tracer),
           "seconds": {"compile": round(compile_s, 3),
                       "first_counts": round(counts_s, 3),
                       "first_counts_by_node": {
                           k: round(v, 4) for k, v in node_s.items()}}}
    if cycles is not None:
        cc = compiler.compile(list(CYCLES), g, cache=False, apct=apct,
                              counter=engine, mesh=mesh)
        got = cc.counts()
        if got != cycles:
            raise AssertionError(f"cycles under {len(mesh.devices)} slots: "
                                 f"{got} != one device {cycles}")
        out["cycles_join_routes"] = mesh_join_routes(cc, len(mesh.devices))
    out["engine"] = engine
    return out


def mesh_local_run(info: dict, patterns, mesh, engine, single: dict,
                   refused: list) -> dict:
    """The local path's anchored reads under ``mesh``, on the graph's
    mesh-bound engine: every vector equal to the local path's; a read the
    local path found too wide (``PlanTooWide``) must be too wide here."""
    g = info["g"]
    cp = compiler.compile(patterns, g, cache=False, apct=info["apct"],
                          counter=engine, local=True, mesh=mesh)
    checked = 0
    for i, p in enumerate(patterns):
        vecs = anchored_or_refused(cp, p)
        if vecs is None:
            if compiler.pattern_key(p) not in refused:
                raise AssertionError(f"{compiler.pattern_key(p)}: refused "
                                     f"under a mesh only")
            continue
        for rep, vec in vecs.items():
            if not torch.equal(vec, single[i, rep]):
                raise AssertionError(f"{compiler.pattern_key(p)} anchor "
                                     f"{rep}: {len(mesh.devices)} slots "
                                     f"differ from one device")
            checked += 1
    return {"anchored_vectors_equal": checked,
            "join_routes": mesh_join_routes(cp, len(mesh.devices))}


def mesh_keep3_run(mesh, single: dict) -> dict:
    """The keep3 coverage case under ``mesh``: K4-keep on row slices."""
    g = erdos_renyi(512, 8.0, seed=0)
    patterns = [chain(6), cycle(6), HOUSE]
    cp = compiler.compile(patterns, g, cache=False, local=True, mesh=mesh)
    for (i, rep), want in single.items():
        if not torch.equal(cp.local_counts(patterns[i], rep), want):
            raise AssertionError(f"{COVERAGE_KEEP3_GRAPH} {i}@{rep}: "
                                 f"{len(mesh.devices)} slots differ")
    return {"anchored_vectors_equal": len(single),
            "join_routes": mesh_join_routes(cp, len(mesh.devices))}


def mesh_batcher(info: dict, mesh) -> dict:
    """``PatternQueryBatcher(mesh=)`` on the user's graph: a group of four
    requests fanned over the slots, every count equal to phase 3's."""
    g = info["g"]
    pats = (cycle(4), motif_patterns(4)[0])
    b = PatternQueryBatcher(g, max_batch=8, apct=info["apct"], mesh=mesh)
    for uid in range(4):
        b.submit(PatternRequest(uid=uid, patterns=pats))
    before = obs.get("mesh.map_requests", devices=len(mesh.devices))
    b.run_to_completion()
    fanned = obs.get("mesh.map_requests", devices=len(mesh.devices)) - before
    for req in b.finished:
        for p, v in req.counts.items():
            if req.error or v != info["counts"][compiler.pattern_key(p)]:
                raise AssertionError(f"meshed batcher {req.uid}: {p} {v}")
    if fanned != 4:
        raise AssertionError(f"meshed batcher fanned {fanned} requests")
    return {"requests": len(b.finished), "fanned": fanned,
            "stats": dict(b.stats.items())}


def time_mesh_counts(info: dict, patterns, slots: int) -> dict:
    """compile + first ``counts()`` on the user's graph at ``slots`` slots
    of the card (1: no mesh), on a fresh engine, split by node kind."""
    g = info["g"]
    mesh = None if slots == 1 else data_mesh(slots, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cp = compiler.compile(patterns, g, cache=False, apct=info["apct"],
                          mesh=mesh)
    compile_s = time.perf_counter() - t0
    node_s = time_nodes(cp)
    t0 = time.perf_counter()
    if cp.counts() != info["counts"]:
        raise AssertionError(f"timed run at {slots} slots differs")
    torch.cuda.synchronize()
    counts_s = time.perf_counter() - t0
    return {"slots": slots, "compile_s": round(compile_s, 3),
            "first_counts_s": round(counts_s, 3),
            "first_counts_by_node": {k: round(v, 4)
                                     for k, v in node_s.items()}}


def phase_mesh_path(main: dict, local: dict, mined: dict) -> dict:
    """The sharded tier on one card: every slot of ``data_mesh(slots,
    device="cuda")`` is the one H100, so this measures the cost of slicing
    and summing, not a speed-up."""
    patterns = local["patterns"]
    graphs = {info["role"]: info for info in main["graphs"]}
    calls: dict = {}
    reports = []
    gathers = {name: obs.get(name) for name in MESH_GATHERS}
    reset_launch_counts()                    # counts start at 0 here ...
    with recording_tile_calls(calls):
        for slots in MESH_SLOTS:
            mesh = data_mesh(slots, device=DEV)
            runs = []
            for role in ("main", "coverage"):
                info = graphs[role]
                run = mesh_graph_run(info, patterns, mesh,
                                     info.get("cycle_counts"))
                engine = run.pop("engine")
                run["local"] = mesh_local_run(
                    info, patterns, mesh, engine, local["anchored"][role],
                    local["refused"][role])
                if role == "main":
                    run["hom_free_tensor"] = check_engine_free_tensor(
                        info, engine)
                runs.append(run)
                del engine
            keep3 = mesh_keep3_run(mesh,
                                   local["anchored"]["coverage-keep3"])
            reports.append({"slots": slots, "graphs": runs,
                            "keep3_coverage": keep3,
                            "batcher": mesh_batcher(graphs["main"], mesh)})
            torch.cuda.empty_cache()
        mine_run = run_mine(["--app", "motif", "--k", "4", "--mesh", "4"])
    launches = launch_counts()               # ... and are read here
    gathers = {name: obs.get(name) - v for name, v in gathers.items()}
    for kernel in MESH_KERNELS:
        if launches[kernel] < 1:
            raise AssertionError(f"the mesh path launched no {kernel}")
    for entries in MESH_F64_ENTRIES:
        if sum(launches[e] for e in entries) < 1:
            raise AssertionError(f"the mesh path launched none of {entries}")
    want_lines = ["mesh: 4 device(s) on axis 'data'"] + mined["motif_lines"]
    if mine_run["lines"] != want_lines:
        raise AssertionError("mine --mesh 4 differs from mine: "
                             f"{mine_run['lines']}")
    slice_cases = check_slice_calls(calls)
    calls.clear()
    batch = check_join_batch()
    timings = [time_mesh_counts(graphs["main"], patterns, slots)
               for slots in (1,) + MESH_SLOTS]
    card = torch.cuda.get_device_name(0)
    emit("mesh_path", graph=MAIN_GRAPH,
         slots_share_one_card=(f"every slot of data_mesh(N, device="
                               f"'cuda') is the one {card}: the times "
                               f"measure slicing and the f64 sums, not "
                               f"scaling"),
         launches=launches, gathers=gathers, runs=reports,
         slice_cases=slice_cases,
         join_batch=batch, mine_mesh_4={"seconds": mine_run["seconds"],
                                        "lines_equal_mine": True},
         seconds_compile_and_counts=timings)
    main["graphs"].clear()
    torch.cuda.empty_cache()
    return {"launches": launches, "by_role": {"mesh": launches}}


def check_engine_free_tensor(info: dict, engine) -> dict:
    """``CountingEngine(mesh=).hom_free_tensor`` against a one-device
    engine's on the user's graph, and no dense adjacency on the mesh
    engine."""
    p, free = chain(3), (0, 2)
    got = engine.hom_free_tensor(p, free)
    want = CountingEngine(info["g"]).hom_free_tensor(p, free)
    if not torch.equal(got, want) or engine._A_dense is not None:
        raise AssertionError("sliced hom_free_tensor differs from one "
                             "device, or the mesh engine built A")
    return {"pattern": "chain(3)", "free": list(free),
            "shape": list(got.shape), "equal": True,
            "mesh_engine_dense_adjacency": None}


def check_join_batch() -> dict:
    """``MeshExecutor.join_batch`` against serial guarded K2 joins."""
    gen = torch.Generator(device=DEV).manual_seed(7)
    stacks = dev_factor(gen, (6, 2, 1024, 1024), 5)
    block = mr.exact_block(list(stacks[0]))
    serial = [mr.prod_reduce(list(s), block=block) for s in stacks]
    out = {}
    for slots in (1,) + MESH_SLOTS:
        got = MeshExecutor(data_mesh(slots, device=DEV)).join_batch(stacks)
        if got.tolist() != serial:
            raise AssertionError(f"join_batch at {slots} slots differs from "
                                 f"serial joins")
        out[str(slots)] = "equal"
    return {"requests": 6, "shape": [2, 1024, 1024], "slots": out}


# -- phase 6c -----------------------------------------------------------------------

EXAMPLES_DIR = os.path.join(ROOT, "examples_torch")
EXAMPLES_AT_ONCE = 5


def phase_examples() -> dict:
    """Every ``examples_torch/*.py`` on the card as its user starts it, a
    subprocess each (a few at a time), exit 0 required."""
    names = sorted(f for f in os.listdir(EXAMPLES_DIR) if f.endswith(".py"))
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="examples_", dir=os.path.join(ROOT,
                                                                  "build"))
    pending, running, results = list(names), {}, {}
    t_all = time.perf_counter()
    while pending or running:
        while pending and len(running) < EXAMPLES_AT_ONCE:
            name = pending.pop(0)
            argv = [sys.executable, os.path.join(EXAMPLES_DIR, name)]
            if name == "tracing.py":
                argv += ["--out", out_dir]
            log = open(os.path.join(out_dir, name + ".log"), "w")
            running[name] = (subprocess.Popen(
                argv, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT),
                log, time.perf_counter())
        time.sleep(0.5)
        for name in [n for n, (proc, _, _) in running.items()
                     if proc.poll() is not None]:
            proc, log, t0 = running.pop(name)
            log.close()
            with open(log.name) as f:
                text = f.read().splitlines()
            results[name] = {"exit": proc.returncode,
                             "seconds": round(time.perf_counter() - t0, 3),
                             "last_line": text[-1] if text else ""}
            if proc.returncode != 0:
                for proc_, log_, _ in running.values():
                    proc_.kill()
                    proc_.wait()
                    log_.close()
                raise AssertionError(f"examples_torch/{name} exited "
                                     f"{proc.returncode}:\n"
                                     + "\n".join(text[-30:]))
    shutil.rmtree(out_dir)
    emit("examples", device=torch.cuda.get_device_name(0), at_once=EXAMPLES_AT_ONCE,
         seconds=round(time.perf_counter() - t_all, 3), runs=results)
    return results


# -- phase 7 ------------------------------------------------------------------------

SERVE_ARCH = "qwen3-4b"
SERVE_PROMPTS = (2048, 4096, 3072, 2048, 512, 4096)
SERVE_NEW = 16
SERVE_SLOTS, SERVE_CAPACITY = 4, 4224
# decode-vs-forward logits in bf16 at full width (see check_decode): the
# two sides round to bf16 in different places (other GEMM shapes, K9's
# online softmax against the dense one, the decode path's bf16 P), and
# one-ulp differences grow through 36 layers whose random weights (std
# 1/sqrt(36), fan_in being the stacked layer axis) make the residual
# stream large.  Readings on an H100 80GB HBM3 at 700 W (PERF.md, equal
# in every run so far): prefill 0.141 (2048 tokens, K9) and 0.0 (512,
# dense), decode 0.211 and 0.219, at logits up to 4.9; argmax equal in
# all four.  At those prompt lengths the one new key carries about 1/T of
# the attention weight, so a decode fault moves logits little there: the
# 12-token prompt, where every key matters, holds decode to the same
# limit and must fail it when decoded one position early (RoPE and cache
# row off by one).  Readings there, same card (PERF.md): decode 0.195,
# one position early 4.94.
SERVE_LOGIT_TOL = 0.5
SERVE_SHORT_PROMPT = 12
_SERVED = re.compile(r"^served (\d+)/(\d+) requests, (\d+) tokens in (\d+) "
                     r"engine steps, [0-9.]+s \([0-9.]+ tok/s\)$")


@contextlib.contextmanager
def recording_routes(log: list, min_tokens: int = 1):
    """Append ``moe.routing_report`` of every MoE layer call on at least
    ``min_tokens`` tokens to ``log`` (tensors: nothing is read back
    here; the call goes on as it is)."""
    real = moe_mod.moe_apply

    def call(p, x, cfg):
        if x.shape[1] >= min_tokens:
            log.append(moe_mod.routing_report(p, x, cfg))
        return real(p, x, cfg)

    moe_mod.moe_apply = call
    try:
        yield log
    finally:
        moe_mod.moe_apply = real


def routed_apart(log: list, forward: list, at: slice) -> list:
    """Per MoE layer, the tokens that a run routes to other experts than
    the forward routes the same tokens (positions ``at`` of the forward),
    each as (need, drift): the forward's logit lead of the experts only it
    chose over those only the run chose (min minus max), and the largest
    change of any of the token's router logits between the two runs.  A
    change of at most ``drift`` per logit can swap the choice only where
    need <= 2 · drift."""
    out = []
    for a, b in zip(log, forward):
        mine, theirs = a.idx, b.idx[:, at]
        apart = (mine.sort(-1)[0] != theirs.sort(-1)[0]).any(-1)
        la, lb = a.logits[apart], b.logits[:, at][apart]       # (n, E)
        in_a = torch.zeros_like(la, dtype=torch.bool).scatter_(
            -1, mine[apart], True)
        in_b = torch.zeros_like(lb, dtype=torch.bool).scatter_(
            -1, theirs[apart], True)
        need = (lb.masked_fill(~(in_b & ~in_a), torch.inf).amin(-1)
                - lb.masked_fill(~(in_a & ~in_b), -torch.inf).amax(-1))
        drift = (la - lb).abs().amax(-1)
        out.append(list(zip(need.tolist(), drift.tolist())))
    return out


def splice(cfg, cache, slot: int, prompt_caches, T: int):
    """Write a T-token prefill's caches (batch 1) into row ``slot`` of
    ``cache``, as ``ContinuousBatcher`` splices an admission: a leaf with
    a ``kv_seq`` axis (attention K and V) takes the prompt's T positions
    and zeros after them; any other (a Mamba slot's conv rows and state,
    a cross-attention slot's image K and V) is copied whole."""
    _, axes = transformer.cache_specs(cfg, 1, T)
    for one, dst, ax in zip(leaves(prompt_caches), leaves(cache),
                            leaves(axes)):
        row, one = dst.select(1, slot), one.select(1, 0)
        if "kv_seq" in ax:
            sa = ax.index("kv_seq") - 1
            row.narrow(sa, T, row.shape[sa] - T).zero_()
            row = row.narrow(sa, 0, T)
        row.copy_(one)
    return cache


def check_decode(cfg, params, prompt, uid, first=None,
                 control: bool = False, dense_route: bool = False,
                 image_embeds=None, hold: bool = True) -> dict:
    """prefill(x[:T]) then one decode step at position T, against the full
    forward (mode="train") of the T + 1 tokens, x being the prompt and the
    token the prefill samples (which must be ``first``, the batcher's,
    when given).  The full forward runs with a flash block above T + 1,
    so that it takes the dense branch of ``causal_attention`` (the flash
    branch needs S to be a multiple of the block; T + 1 is not).  Logits
    within ``SERVE_LOGIT_TOL`` and argmax equal.  With ``control``, the
    same decode step at position T - 1 must miss the forward by more than
    the tolerance.  Everything in bf16, as served.

    With ``dense_route`` and T above the flash block, the prefill held to
    the forward, and whose cache the held decode step reads, runs by the
    forward's attention route (flash block 2T); the served prefill (K9)
    and a decode step from its cache are printed beside it, as
    ``served_route`` (held by ``flash_path_check``, not here).  An MoE
    model also reports, per layer, the dropped (token, choice) pairs of
    every run (which must be 0), the smallest top-k margin, and the tokens
    each run routes to other experts than the forward does.  Every flip
    must be one that the two runs' router logit drift explains
    (``routed_apart``); the prefill's logits are
    held where no prompt token flipped, the decode step's where neither
    the prompt nor the decoded token did (``held``): a flip at a tie
    moves the output by a whole expert's share, which is the reference's
    semantics as much as the port's.  ``image_embeds`` (1, T_img, d) go to
    the prefills and the forward (a VLM's cross-attention slots; the
    decode step reads them from the cache).  With ``hold=False`` the
    logits are reported and not held (``held`` says so).

    A model of frame embeddings (``input_mode == "embeddings"``,
    musicgen-large) takes ``prompt`` as a (1, T, d) tensor, and the frame
    after it is the embedding-table row of the sampled code: the values
    the ids branch of ``forward`` would read for that code."""
    frames = cfg.input_mode == "embeddings"
    x = torch.as_tensor(prompt, device=DEV) if frames else \
        torch.tensor([list(prompt)], dtype=torch.long, device=DEV)
    T = x.shape[1]
    routed = {"prefill": [], "decode": [], "forward": []}
    served = None
    if dense_route and T > cfg.flash_block:
        routed["served_prefill"] = []
        with recording_routes(routed["served_prefill"]):
            served = make_prefill_step(cfg)(params, x, image_embeds)
        prefill_cfg = dataclasses.replace(cfg, flash_block=2 * T)
    else:
        prefill_cfg = cfg
    with recording_routes(routed["prefill"]):
        last, caches = make_prefill_step(prefill_cfg)(params, x,
                                                      image_embeds)
    sampled = int((last if served is None else served[0]).argmax(-1)[0])
    assert first is None or sampled == first, \
        f"request {uid}: prefill samples {sampled}, the batcher {first}"
    x = torch.cat([x, params["embed"][sampled][None, None].to(x.dtype)
                   if frames else torch.tensor([[sampled]], device=DEV)], 1)
    decode = make_decode_step(cfg)

    def decode_from(prompt_caches, position, log=None):
        grown = splice(cfg, transformer.init_cache(cfg, 1, T + 1, device=DEV),
                       0, prompt_caches, T)
        with recording_routes([] if log is None else log):
            return decode(params, grown, x[:, T:T + 1],
                          torch.tensor([position], device=DEV))[0]

    dec = decode_from(caches, T, routed["decode"])
    early = decode_from(caches, T - 1) if control else None
    del caches
    dense = dataclasses.replace(cfg, flash_block=2 * (T + 1))
    with recording_routes(routed["forward"]):
        full, _, _ = transformer.forward(dense, params, x, mode="train",
                                         image_embeds=image_embeds)
    full = full[0].float()
    err_prefill = (last[0].float() - full[T - 1]).abs().max().item()
    err_decode = (dec[0].float() - full[T]).abs().max().item()
    out = {"uid": uid, "prompt": T,
           "prefill_route": "no attention" if "A" not in cfg.layer_pattern
           else "flash (K9)" if T > prefill_cfg.flash_block else "dense",
           "max_abs_err_prefill": err_prefill,
           "max_abs_err_decode": err_decode,
           "max_abs_logit": full[T - 1:].abs().max().item(),
           "argmax_equal": [int(last[0].argmax()) == int(full[T - 1].argmax()),
                            int(dec[0].argmax()) == int(full[T].argmax())],
           "tolerance": SERVE_LOGIT_TOL}
    if served is not None:
        dec_served = decode_from(served[1], T)
        out["served_route"] = {
            "prefill_route": "flash (K9)",
            "max_abs_err_prefill": (served[0][0].float()
                                    - full[T - 1]).abs().max().item(),
            "max_abs_err_decode": (dec_served[0].float()
                                   - full[T]).abs().max().item(),
            "argmax_equal": [
                int(served[0][0].argmax()) == int(full[T - 1].argmax()),
                int(dec_served[0].argmax()) == int(full[T].argmax())]}
        assert torch.isfinite(dec_served).all()
        del served, dec_served
    held = {"prefill": hold, "decode": hold}
    if not hold:
        out["held"] = held
    if cfg.moe is not None:
        # MoE: every run must keep every (token, choice) pair
        out["dropped_pairs_per_layer"] = {
            run: [int(r.drops.sum()) for r in log]
            for run, log in routed.items()}
        assert not any(sum(v) for v in
                       out["dropped_pairs_per_layer"].values()), out
        out["min_top_k_margin"] = min(float(r.margin.min()) for log in
                                      routed.values() for r in log)
        flips = {"prefill": routed_apart(routed["prefill"],
                                         routed["forward"], slice(0, T)),
                 "decode": routed_apart(routed["decode"], routed["forward"],
                                        slice(T, T + 1))}
        if "served_prefill" in routed:
            flips["served_prefill"] = routed_apart(
                routed["served_prefill"], routed["forward"], slice(0, T))
        out["tokens_routed_apart_from_forward_per_layer"] = {
            run: [len(g) for g in gaps] for run, gaps in flips.items()}
        # every flip must be one that the runs' own logit drift explains
        # (need <= 2 drift): routing is the same function of the logits
        # in both runs, and the logits moved by rounding
        out["flips_need_over_twice_drift"] = {
            run: max((n / (2 * d) if d else math.inf * bool(n)
                      for g in gaps for n, d in g), default=None)
            for run, gaps in flips.items()}
        out["decode_flips_layer_need_drift"] = [
            [i, n, d] for i, g in enumerate(flips["decode"]) for n, d in g]
        for run in ("prefill", "decode"):
            worst = out["flips_need_over_twice_drift"][run]
            assert worst is None or worst <= 1.0, (run, out)
        held["prefill"] = hold and not any(flips["prefill"])
        held["decode"] = held["prefill"] and not any(flips["decode"])
        out["held"] = held
    if control:
        out["control_position"] = T - 1
        out["control_max_abs_err_decode"] = \
            (early[0].float() - full[T]).abs().max().item()
    assert torch.isfinite(full).all() and torch.isfinite(dec).all()
    for i, (run, err) in enumerate((("prefill", err_prefill),
                                    ("decode", err_decode))):
        if held[run]:
            assert err <= SERVE_LOGIT_TOL and out["argmax_equal"][i], out
    if control:
        assert out["control_max_abs_err_decode"] > SERVE_LOGIT_TOL, out
    return out


SERVE_PAIRED_PROMPTS = (256, 512, 768, 1000)
SERVE_PAIRED_NEW = 8


def paired_step(eager, graphed, params, cache, toks, pos, i: int,
                stateful: bool) -> tuple:
    """One decode step run eagerly and by the captured graph on the same
    cache state, eager first when ``i`` is even: (the graph's logits, a
    row of both times, the two argmaxes' equality and the largest logit
    difference).  With ``stateful`` (Mamba slots advance their state)
    the cache is copied before the first run and put back before the
    second, and the two new states are compared."""
    order = ("eager", "graph") if i % 2 == 0 else ("graph", "eager")
    logits, ms = {}, {}
    before = [c.clone() for c in leaves(cache)] if stateful else None
    first_state = None
    for n, which in enumerate(order):
        if stateful and n:
            first_state = [c.clone() for c in leaves(cache)]
            for c, was in zip(leaves(cache), before):
                c.copy_(was)
        step = eager if which == "eager" else graphed
        t = time.perf_counter()
        out = step(params, cache, toks, pos)[0]
        torch.cuda.synchronize()
        ms[which] = (time.perf_counter() - t) * 1e3
        logits[which] = out.clone()
    row = {"ms": ms, "tokens_equal": torch.equal(
        logits["eager"].argmax(-1), logits["graph"].argmax(-1)),
        "max_abs_logit_diff": (logits["eager"].float()
                               - logits["graph"].float()).abs().max().item()}
    if stateful:
        row["max_abs_state_diff"] = max(
            (a.float() - c.float()).abs().max().item()
            for a, c in zip(first_state, leaves(cache)))
    return logits["graph"], row


def compare_graphed_decode(cfg, params, b, rng) -> dict:
    """Graphed against eager decode steps on the same batch and cache
    state: four more requests through the same batcher (so the same
    captured graph), each step run eagerly (``make_decode_step``) and by
    the graph in turns — eager first on even steps, graph first on odd
    ones.  Both write the same cache rows (the token and position are the
    same), the graph's logits drive the batch, and the tokens the two
    sample must be equal.  A model with Mamba slots advances its state
    at every step, so there the cache is copied before the first run and
    put back before the second, and the two runs' new states are compared
    (``max_abs_state_diff``).  Returns both step medians and the largest
    logit difference."""
    eager, graphed = make_decode_step(cfg), b.decode
    stateful = "M" in cfg.layer_pattern
    rows = []

    def paired(params_, cache, toks, pos):
        logits, row = paired_step(eager, graphed, params_, cache, toks, pos,
                                  len(rows), stateful)
        rows.append(row)
        return logits, cache

    b.decode = paired
    for i, T in enumerate(SERVE_PAIRED_PROMPTS):
        b.submit(Request(uid=100 + i, prompt=rng.integers(
            0, cfg.vocab_size, T).astype(np.int32),
            max_new_tokens=SERVE_PAIRED_NEW, eos_id=-1))
    b.run_to_completion()
    b.decode = graphed
    out = {"prompts": list(SERVE_PAIRED_PROMPTS),
           "max_new_tokens": SERVE_PAIRED_NEW, "steps": len(rows),
           "eager_step_ms_median": float(np.median(
               [r["ms"]["eager"] for r in rows])),
           "graph_step_ms_median": float(np.median(
               [r["ms"]["graph"] for r in rows])),
           "tokens_equal": all(r["tokens_equal"] for r in rows),
           "max_abs_logit_diff": max(r["max_abs_logit_diff"] for r in rows)}
    if stateful:
        out["max_abs_state_diff"] = max(r["max_abs_state_diff"]
                                        for r in rows)
    assert rows and out["tokens_equal"], rows
    return out


def timing_batcher(b) -> tuple:
    """Wrap ``b``'s prefill model and decode step so that each call's
    host seconds, ending in a synchronize, are appended to the two lists
    returned (admissions as {"prompt", "seconds"}); ``restore(b)`` puts
    the calls back."""
    admissions, decode_steps = [], []
    prefill_call, decode_call = b.model, b.decode

    def timed_prefill(params_, prompt, **kw):
        t = time.perf_counter()
        out = prefill_call(params_, prompt, **kw)
        torch.cuda.synchronize()
        admissions.append({"prompt": int(prompt.shape[1]),
                           "seconds": time.perf_counter() - t})
        return out

    def timed_decode(*args):
        t = time.perf_counter()
        out = decode_call(*args)
        torch.cuda.synchronize()
        decode_steps.append(time.perf_counter() - t)
        return out

    def restore(batcher):
        batcher.model, batcher.decode = prefill_call, decode_call

    b.model, b.decode = timed_prefill, timed_decode
    return admissions, decode_steps, restore


def capturing_k9(captured: dict, length: int):
    """A stand-in for ``kfa.flash_attention`` that keeps q, k, v of the
    first call on ``length`` queries in ``captured`` and goes on to the
    kernel as it is; ``kfa.flash_attention`` is put back by the caller."""
    launch_k9 = kfa.flash_attention

    def call(q, k, v, **kw):
        if not captured and q.shape[1] == length:
            captured.update(q=q.clone(), k=k.clone(), v=v.clone())
        return launch_k9(q, k, v, **kw)
    return call, launch_k9


def run_serve_cli(argv: list, cfg) -> dict:
    """``serve.main(argv)`` on the card (the reduced config at the
    CLI's own flags: 12 requests, 12 new tokens each), its lines
    checked."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli = serve.main(argv)
    cli_s = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    m = _SERVED.match(lines[0])
    assert m and m.group(1, 2, 3) == ("12", "12", "144"), lines
    assert len(lines) == 4 and all(x.startswith("  req ") for x in lines[1:])
    assert cli.device.type == DEV.type and cli.cfg.name == cfg.name
    return {"argv": argv, "seconds": cli_s, "lines": lines}


def phase_serve_path() -> dict:
    """The LM serving path at full width: qwen3-4b unreduced (36 layers,
    bf16, random weights from a seed, drawn on the card) behind
    ``ContinuousBatcher``, six prompts of which five are longer than the
    flash block (1024), so that every attention layer of their prefills
    runs K9; then decode-vs-forward logits for two requests and a
    12-token prompt, and the serving CLI at its own flags."""
    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    params = transformer.Model(cfg).init(0, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tensors = leaves(params)
    n_params = sum(t.numel() for t in tensors)
    n_bytes = sum(t.numel() * t.element_size() for t in tensors)
    assert n_params == cfg.param_count() == 4_022_468_096, n_params
    assert {t.dtype for t in tensors} == {torch.bfloat16}
    emit("serve_params", arch=SERVE_ARCH, num_layers=cfg.num_layers,
         d_model=cfg.d_model, params=n_params, bytes=n_bytes,
         init_s=round(init_s, 3))

    rng = np.random.default_rng(0)
    b = ContinuousBatcher(cfg, params, slots=SERVE_SLOTS,
                          capacity=SERVE_CAPACITY)
    cache_bytes = sum(t.numel() * t.element_size() for t in leaves(b.cache))
    # each decode step hands the card its (slots, 1) tokens and (slots,)
    # positions as the batcher keeps them
    decode_input_bytes = b.last_token[:, None].nbytes + b.positions.nbytes
    for i, T in enumerate(SERVE_PROMPTS):
        b.submit(Request(uid=i, prompt=rng.integers(
            0, cfg.vocab_size, T).astype(np.int32),
            max_new_tokens=SERVE_NEW, eos_id=-1))
    # host time of every admission (prefill) and decode step, each ending
    # in a synchronize (the batcher reads every sampled token back anyway)
    admissions, decode_steps, restore = timing_batcher(b)
    # keep q, k, v of layer 0 of the first 4096-token prefill for phase
    # ``kernels``
    captured: dict = {}
    kfa.flash_attention, launch_k9 = capturing_k9(captured, 4096)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        steps = b.run_to_completion()
    finally:
        kfa.flash_attention = launch_k9
    run_s = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tokens = sum(len(r.generated) for r in b.finished)
    assert sorted(r.uid for r in b.finished) == list(range(6)), b.finished
    for r in b.finished:
        assert len(r.generated) == SERVE_NEW and r.done, (r.uid, r.generated)
        assert all(0 <= t < cfg.vocab_size for t in r.generated)
    want_k9 = cfg.num_layers * sum(T > cfg.flash_block for T in SERVE_PROMPTS)
    assert launches["flashattn"] == want_k9 == 180, launches
    assert {k for k, n in launches.items() if n} == {"flashattn"}, launches
    assert captured, "no 4096-token prefill reached K9"
    restore(b)
    paired = compare_graphed_decode(cfg, params, b,
                                    np.random.default_rng(1))
    by_uid = {r.uid: r for r in b.finished}
    checks = [check_decode(cfg, params, by_uid[u].prompt, u,
                           first=by_uid[u].generated[0]) for u in (0, 4)]
    checks.append(check_decode(
        cfg, params, rng.integers(0, cfg.vocab_size, SERVE_SHORT_PROMPT),
        "short", control=True))
    # K9 on the path's own layer-0 q, k, v against the f64 oracle (its
    # row in phase ``kernels`` holds it to the plain version)
    flash = flash_path_check("bf16 qwen3-4b serving path's layer-0 q, k, v",
                             captured["q"], captured["k"], captured["v"],
                             block=cfg.flash_block)

    cli = run_serve_cli([], cfg)
    out = {"arch": SERVE_ARCH, "slots": SERVE_SLOTS,
           "capacity": SERVE_CAPACITY, "param_bytes": n_bytes,
           "cache_bytes": cache_bytes,
           "decode_input_bytes": decode_input_bytes,
           "prompts": list(SERVE_PROMPTS),
           "max_new_tokens": SERVE_NEW, "steps": steps, "tokens": tokens,
           "seconds": run_s, "tokens_per_s": tokens / run_s,
           "admissions": admissions,
           "decode_steps": len(decode_steps),
           "decode_step_ms_median": float(np.median(decode_steps)) * 1e3,
           "decode_step_ms_max": max(decode_steps) * 1e3,
           "decode_step_ms_first": decode_steps[0] * 1e3,
           "graphed_vs_eager": paired,
           "launches": launches, "peak_device_bytes": peak,
           "decode_vs_forward": checks, "flash_check": flash,
           "cli": cli}
    emit("serve_path", **out)
    del b, params
    torch.cuda.empty_cache()
    return {**out, "captured": captured}


# -- phase 7a -----------------------------------------------------------------------

MOE_ARCH, MOE_LAYERS = "dbrx-132b", 8
MOE_PARAMS = 27_305_809_920
# the serving CLI as a user starts it for the MoE model: its own flags,
# so the reduced config, 12 requests and 12 new tokens each
MOE_CLI = ["--arch", MOE_ARCH]


def moe_serving_config():
    """dbrx-132b at its published widths, 8 of its 40 layers: one layer
    is 6.52 GB of bf16 weights, so 8 (54.61 GB with the embeddings) fit
    the card beside the caches and a 4096-token prefill, and 10 (67.65
    GB) would not."""
    return dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_LAYERS)


def drops_by_admission(log: list, prompts: list, cfg) -> list:
    """The batcher's prefill calls of the MoE layers, one per layer and
    admission in order: dropped (token, choice) pairs per layer and the
    smallest top-k margin, per admitted prompt."""
    layers, e = cfg.num_layers, cfg.moe
    assert len(log) == layers * len(prompts), (len(log), prompts)
    out = []
    for i, T in enumerate(prompts):
        calls = log[i * layers:(i + 1) * layers]
        out.append({"prompt": T, "capacity": moe_mod.capacity(
                        T, e.top_k, e.num_experts, e.capacity_factor),
                    "dropped_pairs_per_layer": [int(r.drops.sum())
                                                for r in calls],
                    "min_top_k_margin": min(float(r.margin.min())
                                            for r in calls)})
    return out


def phase_moe_serve_path() -> dict:
    """The MoE serving path at published widths: dbrx-132b (16 experts,
    top-4, d_expert 10752, 48 heads, 8 KV heads, head dim 128), 8 of its
    40 layers, bf16 random weights drawn on the card from a seed, behind
    ``ContinuousBatcher`` with ``serve_path``'s slots, capacity and six
    prompts, so that five prefills run K9 in every layer (48 heads).
    Then decode against the full forward on a capacity that drops nothing
    (``check_decode``), graphed against eager decode steps, K9 on the
    path's own layer-0 q, k, v against an f64 oracle, and the serving CLI
    at ``--arch dbrx-132b`` (its reduced config)."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = moe_serving_config()
    assert cfg.moe.num_experts == 16 and cfg.moe.top_k == 4
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.Model(cfg).init(0, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tensors = leaves(params)
    n_params = sum(t.numel() for t in tensors)
    n_bytes = sum(t.numel() * t.element_size() for t in tensors)
    assert n_params == cfg.param_count() == MOE_PARAMS, n_params
    assert {t.dtype for t in tensors} == {torch.bfloat16}
    # one decode step reads every weight but the embedding table, of
    # which it gathers a row per slot: all 16 experts of every layer
    step_bytes = n_bytes - params["embed"].numel() * 2
    emit("moe_serve_params", arch=MOE_ARCH, num_layers=cfg.num_layers,
         published_layers=get_config(MOE_ARCH).num_layers,
         d_model=cfg.d_model, params=n_params, bytes=n_bytes,
         init_s=round(init_s, 3))

    rng = np.random.default_rng(0)
    b = ContinuousBatcher(cfg, params, slots=SERVE_SLOTS,
                          capacity=SERVE_CAPACITY)
    cache_bytes = sum(t.numel() * t.element_size() for t in leaves(b.cache))
    # each decode step hands the card its (slots, 1) tokens and (slots,)
    # positions as the batcher keeps them
    decode_input_bytes = b.last_token[:, None].nbytes + b.positions.nbytes
    for i, T in enumerate(SERVE_PROMPTS):
        b.submit(Request(uid=i, prompt=rng.integers(
            0, cfg.vocab_size, T).astype(np.int32),
            max_new_tokens=SERVE_NEW, eos_id=-1))
    admissions, decode_steps, restore = timing_batcher(b)
    captured: dict = {}
    kfa.flash_attention, launch_k9 = capturing_k9(captured, 4096)
    routed: list = []
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        # prefills only: the graphed decode step is left as captured
        with recording_routes(routed, min_tokens=2):
            steps = b.run_to_completion()
    finally:
        kfa.flash_attention = launch_k9
    run_s = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tokens = sum(len(r.generated) for r in b.finished)
    assert sorted(r.uid for r in b.finished) == list(range(6)), b.finished
    for r in b.finished:
        assert len(r.generated) == SERVE_NEW and r.done, (r.uid, r.generated)
        assert all(0 <= t < cfg.vocab_size for t in r.generated)
    want_k9 = cfg.num_layers * sum(T > cfg.flash_block for T in SERVE_PROMPTS)
    assert launches["flashattn"] == want_k9 == 40, launches
    assert {k for k, n in launches.items() if n} == {"flashattn"}, launches
    assert captured and captured["q"].shape[2] == cfg.num_heads, \
        "no 4096-token K9 call"
    drops = drops_by_admission(routed, [a["prompt"] for a in admissions],
                               cfg)
    restore(b)
    paired = compare_graphed_decode(cfg, params, b,
                                    np.random.default_rng(1))
    # decode against the forward on a capacity that drops nothing (C = S,
    # factor E / k): at the published factor C(T) and C(T + 1) differ,
    # and a pair the prefill drops (printed in ``prefill_drops``) makes
    # the two runs different functions of the same tokens
    lossless = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    by_uid = {r.uid: r for r in b.finished}
    # admissions run in submission order: the i-th is request i; its
    # first token is the check's only where its prefill dropped nothing
    assert [a["prompt"] for a in drops] == list(SERVE_PROMPTS), drops
    checks = [check_decode(lossless, params, by_uid[u].prompt, u,
                           first=None if sum(drops[u][
                               "dropped_pairs_per_layer"])
                           else by_uid[u].generated[0], dense_route=True)
              for u in (0, 4)]
    checks.append(check_decode(
        lossless, params, rng.integers(0, cfg.vocab_size,
                                       SERVE_SHORT_PROMPT),
        "short", control=True, dense_route=True))
    # the flips a tie excuses must leave some decode step held
    assert any(c["held"]["decode"] for c in checks), checks
    del b, params, tensors
    gc.collect()
    torch.cuda.empty_cache()
    # K9 on the path's own layer-0 q, k, v of the first 4096-token prefill
    # (dbrx's shape on random inputs is a kernel case)
    flash = flash_path_check("bf16 dbrx-132b serving path's layer-0 q, k, "
                             "v", captured["q"], captured["k"], captured["v"],
                             block=1024)
    del captured

    cli = run_serve_cli(MOE_CLI, cfg)
    graphed_ms = float(np.median(decode_steps)) * 1e3
    out = {"arch": MOE_ARCH, "num_layers": cfg.num_layers,
           "published_layers": get_config(MOE_ARCH).num_layers,
           "params": n_params, "slots": SERVE_SLOTS,
           "capacity": SERVE_CAPACITY, "prompts": list(SERVE_PROMPTS),
           "max_new_tokens": SERVE_NEW, "init_s": init_s, "steps": steps,
           "tokens": tokens, "seconds": run_s, "tokens_per_s": tokens / run_s,
           "admissions": admissions,
           "decode_steps": len(decode_steps),
           "decode_step_ms_median": graphed_ms,
           "decode_step_ms_median_eager": paired["eager_step_ms_median"],
           "decode_step_ms_max": max(decode_steps) * 1e3,
           "decode_step_ms_first": decode_steps[0] * 1e3,
           "decode_step_weight_bytes": step_bytes,
           "decode_step_weight_bound_ms": step_bytes / PEAK_BYTES_PER_S * 1e3,
           "param_bytes": n_bytes,
           "param_bytes_at_peak_rate_ms": n_bytes / PEAK_BYTES_PER_S * 1e3,
           "decode_step_over_weight_bound": graphed_ms / (
               step_bytes / PEAK_BYTES_PER_S * 1e3),
           "graphed_vs_eager": paired, "launches": launches,
           "prefill_drops": drops, "peak_device_bytes": peak,
           "decode_vs_forward": checks, "flash_check": flash,
           "cli": cli}
    emit("moe_serve_path", **out)
    emit("moe_serve_report", init_s=init_s,
         seconds_per_admission=[[a["prompt"], a["seconds"]]
                                for a in admissions],
         decode_step_ms_median_graphed=graphed_ms,
         decode_step_ms_median_eager=paired["eager_step_ms_median"],
         decode_step_weight_bytes=step_bytes,
         decode_step_weight_bound_ms=out["decode_step_weight_bound_ms"],
         tokens_per_s=out["tokens_per_s"], peak_device_bytes=peak,
         dropped_pairs=[[d["prompt"], sum(d["dropped_pairs_per_layer"])]
                        for d in drops])
    torch.cuda.empty_cache()
    return out


# -- phases 7c, 7d -----------------------------------------------------------------

SSM_ARCH = "mamba2-1.3b"
SSM_PARAMS = 1_343_740_928
# 3000 is no multiple of the 256-token SSD chunk: its prefill pads
SSM_PROMPTS = (4096, 3000, 1024, 512, 12)
SSM_CLI = ["--arch", SSM_ARCH]
VLM_ARCH = "llama-3.2-vision-11b"
VLM_PARAMS = 9_775_157_264
VLM_PROMPTS = (2048, 512)
VLM_DECODE_STEPS = 16


def draw_params(cfg, want: int) -> tuple:
    """Random bf16 parameters of ``cfg`` drawn on the card from seed 0,
    gates of cross-attention slots opened (``open_gates``): (params, their
    count, bytes, seconds to draw)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.Model(cfg).init(0, device=DEV)
    open_gates(params, 1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tensors = leaves(params)
    n_params = sum(t.numel() for t in tensors)
    n_bytes = sum(t.numel() * t.element_size() for t in tensors)
    assert n_params == cfg.param_count() == want, n_params
    assert {t.dtype for t in tensors} == {torch.bfloat16}
    return params, n_params, n_bytes, init_s


def open_gates(params, seed: int):
    """Every cross-attention slot's ``gate_attn`` and ``gate_ffn`` drawn
    from ``seed``, uniform in ±[0.5, 1.5], in place.  The reference draws
    them as zeros, and tanh(0) = 0: at init an X slot adds nothing, and
    a check would pass with cross-attention broken."""
    gates = [slot[k] for seg in params["segments"] for slot in seg.values()
             for k in ("gate_attn", "gate_ffn") if k in slot]
    if not gates:
        return params
    gen = torch.Generator(device=gates[0].device).manual_seed(seed)
    with torch.no_grad():
        for g in gates:
            mag = torch.empty(g.shape, device=g.device).uniform_(
                0.5, 1.5, generator=gen)
            sign = torch.randint(0, 2, g.shape, generator=gen,
                                 device=g.device) * 2 - 1
            g.copy_(mag * sign)
    return params


def decode_checks_bf16_and_f32(cfg, params, requests, dense_route=False):
    """Decode against the forward (``check_decode``) for each (prompt,
    uid, first token, image or None) of ``requests``: in bf16 as served,
    reported and not held, then on the same weights widened to f32,
    held.  At these random weights (std 1/sqrt(layers): the stacked
    layer axis is the initialiser's fan_in) the bf16 models are
    ill-conditioned — mamba2-1.3b's forward of 513 tokens lies 2.5 from
    its 512-token prefill at logits up to 3.9 — so a bf16 rounding in
    another place moves the logits by more than a fault would; f32 puts
    that noise some 2^15 times lower.  ``params`` is widened in place,
    leaf by leaf (each bf16 leaf freed as its f32 copy is made, so the
    two trees are never whole at once); returns {"bf16": [...], "f32":
    [...]}."""
    bf16 = [check_decode(cfg, params, prompt, uid, first=first,
                         image_embeds=img, dense_route=dense_route,
                         hold=False)
            for prompt, uid, first, img in requests]

    def widen(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                widen(v)
            elif isinstance(v, list):
                for x in v:
                    widen(x)
            else:
                tree[k] = v.float()
                del v
    widen(params)
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    f32 = [check_decode(cfg32, params, prompt, uid,
                        image_embeds=None if img is None else img.float(),
                        dense_route=dense_route)
           for prompt, uid, _, img in requests]
    return {"bf16": bf16, "f32": f32}


def bf16_decode_checks(cfg, params, requests) -> dict:
    """``check_decode`` on each (prompt, uid, first token) of
    ``requests`` in bf16 as served, reported and not held
    (``f32_decode_checks`` holds the model), the prefill by the forward's
    dense route (no qk-norm: at random weights the scores reach the
    hundreds; the K9 prefill is printed as ``served_route``)."""
    return {"bf16": [check_decode(cfg, params, prompt, uid, first=first,
                                  dense_route=True, hold=False)
                     for prompt, uid, first in requests]}


def ulp_sensitivity(cfg, params, prompt) -> float:
    """How far the last logits of ``cfg``'s forward (dense route) on
    ``prompt`` move when every entry of its input embeddings moves by
    about 2^-22 of itself (a seeded normal factor: one or two f32 ulps):
    the model's own conditioning, beside which a decode-vs-forward error
    is read.  Token ids are turned into their embedding rows first."""
    x = torch.as_tensor(prompt, device=DEV)
    x = params["embed"][x.long()][None] if x.ndim == 1 else x.float()
    cfg_e = dataclasses.replace(cfg, input_mode="embeddings",
                                flash_block=2 * x.shape[1])
    gen = torch.Generator(device=DEV).manual_seed(9)
    moved = x * (1 + 2.0 ** -22 * torch.randn(x.shape, generator=gen,
                                              device=DEV))
    a, b = (transformer.forward(cfg_e, params, y, mode="train")[0][0, -1]
            .clone() for y in (x, moved))
    return (a - b).abs().max().item()


def ulp_sensitivity_by_depth(cfg, depths, prompt) -> dict:
    """``ulp_sensitivity`` of ``cfg`` at published widths in f32 on each
    of ``depths`` layers, on ``prompt``: one draw of the deepest (seed 0),
    its stacked layer axis sliced for the others (a single segment)."""
    cfg32 = dataclasses.replace(cfg, num_layers=max(depths),
                                param_dtype="float32",
                                compute_dtype="float32")
    gc.collect()
    torch.cuda.empty_cache()
    params = transformer.Model(cfg32).init(0, device=DEV)
    (seg,) = params["segments"]
    out = {}
    for n in depths:
        cut = {slot: {k: v[:n] if torch.is_tensor(v) else
                      {kk: vv[:n] for kk, vv in v.items()}
                      for k, v in layer.items()}
               for slot, layer in seg.items()}
        out[n] = ulp_sensitivity(dataclasses.replace(cfg32, num_layers=n),
                                 {**params, "segments": [cut]}, prompt)
    del params, seg, cut
    gc.collect()
    torch.cuda.empty_cache()
    return out


def f32_decode_checks(cfg, requests, f32_layers: int) -> dict:
    """Decode against the forward held in f32: ``cfg`` at its published
    widths on ``f32_layers`` layers, weights drawn on the card from seed
    0, each request of ``requests`` held (its first token not checked:
    another model), the one with uid "short" decoded one position early
    too (``control``); beside them the f32 weights' bytes, the peak and
    the model's ``ulp_sensitivity`` on the first request's prompt.  The
    bf16 weights must be released first."""
    cfg32 = dataclasses.replace(cfg, num_layers=f32_layers,
                                param_dtype="float32",
                                compute_dtype="float32")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params32 = transformer.Model(cfg32).init(0, device=DEV)
    out = {"f32": [check_decode(cfg32, params32, prompt, uid,
                                control=uid == "short", dense_route=True)
                   for prompt, uid, _ in requests],
           "f32_layers": f32_layers,
           "f32_param_bytes": sum(t.numel() * 4 for t in leaves(params32)),
           "f32_peak_device_bytes": torch.cuda.max_memory_allocated(),
           "f32_ulp_sensitivity": ulp_sensitivity(cfg32, params32,
                                                  requests[0][0])}
    del params32
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_ssm_serve_path() -> dict:
    """The Mamba2 serving path at published widths and full depth:
    mamba2-1.3b (48 'M' layers, d_model 2048, 64 heads of 64, state 128,
    no attention and no feed-forward), bf16 random weights drawn on the
    card from a seed, behind ``ContinuousBatcher`` with 4 slots, prompts
    of 4096, 3000 (padded to whole 256-token chunks), 1024, 512 and 12
    tokens, 16 new tokens each.  No kernel may launch (the model has no
    attention; the SSD scan has no TPU kernel).  Then graphed against
    eager decode steps (the state put back between the two), decode
    against the forward for the 3000- and 512-token requests, and the
    serving CLI at ``--arch mamba2-1.3b`` (its reduced config)."""
    cfg = get_config(SSM_ARCH)
    assert cfg.num_layers == 48 and cfg.layer_pattern == "M"
    params, n_params, n_bytes, init_s = draw_params(cfg, SSM_PARAMS)
    # one decode step reads every weight (the tied embedding table whole,
    # for the logits) and reads and writes every slot's conv rows and
    # state in every layer
    s = cfg.ssm
    state_bytes = SERVE_SLOTS * cfg.num_layers * 2 * (
        (s.d_conv - 1) * (cfg.d_inner + 2 * s.n_groups * s.d_state)
        + cfg.ssm_heads * s.head_dim * s.d_state)
    step_bytes = n_bytes + 2 * state_bytes
    emit("ssm_serve_params", arch=SSM_ARCH, num_layers=cfg.num_layers,
         d_model=cfg.d_model, params=n_params, bytes=n_bytes,
         init_s=round(init_s, 3))

    rng = np.random.default_rng(0)
    b = ContinuousBatcher(cfg, params, slots=SERVE_SLOTS,
                          capacity=SERVE_CAPACITY)
    for i, T in enumerate(SSM_PROMPTS):
        b.submit(Request(uid=i, prompt=rng.integers(
            0, cfg.vocab_size, T).astype(np.int32),
            max_new_tokens=SERVE_NEW, eos_id=-1))
    admissions, decode_steps, restore = timing_batcher(b)
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        steps = b.run_to_completion()
    finally:
        restore(b)
    run_s = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tokens = sum(len(r.generated) for r in b.finished)
    assert sorted(r.uid for r in b.finished) == list(range(len(SSM_PROMPTS)))
    for r in b.finished:
        assert len(r.generated) == SERVE_NEW and r.done, (r.uid, r.generated)
        assert all(0 <= t < cfg.vocab_size for t in r.generated)
    assert not any(launches.values()), launches
    paired = compare_graphed_decode(cfg, params, b, np.random.default_rng(1))
    by_uid = {r.uid: r for r in b.finished}
    checks = decode_checks_bf16_and_f32(
        cfg, params, [(by_uid[u].prompt, u, by_uid[u].generated[0], None)
                      for u in (1, 3)])

    cli = run_serve_cli(SSM_CLI, cfg)
    graphed_ms = float(np.median(decode_steps)) * 1e3
    bound_ms = step_bytes / PEAK_BYTES_PER_S * 1e3
    out = {"arch": SSM_ARCH, "num_layers": cfg.num_layers, "params": n_params,
           "slots": SERVE_SLOTS, "capacity": SERVE_CAPACITY,
           "prompts": list(SSM_PROMPTS), "max_new_tokens": SERVE_NEW,
           "init_s": init_s, "steps": steps, "tokens": tokens,
           "seconds": run_s, "tokens_per_s": tokens / run_s,
           "admissions": admissions, "decode_steps": len(decode_steps),
           "decode_step_ms_median": graphed_ms,
           "decode_step_ms_median_eager": paired["eager_step_ms_median"],
           "decode_step_ms_max": max(decode_steps) * 1e3,
           "decode_step_ms_first": decode_steps[0] * 1e3,
           "decode_step_bytes": step_bytes,
           "decode_step_state_bytes_read_and_written": 2 * state_bytes,
           "decode_step_bound_ms": bound_ms,
           "decode_step_over_bound": graphed_ms / bound_ms,
           "graphed_vs_eager": paired, "launches": launches,
           "peak_device_bytes": peak, "decode_vs_forward": checks,
           "cli": cli}
    emit("ssm_serve_path", **out)
    del b, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_vlm_serve_path() -> dict:
    """The VLM serving path at published widths and full depth:
    llama-3.2-vision-11b (32 self-attention and 8 gated cross-attention
    layers, d_model 4096, 32 heads, 8 KV heads), bf16 random weights drawn
    on the card from a seed with the gates opened (``open_gates``), one
    seeded (1, 1600, 4096) bf16 image per request (the vision encoder is a
    stub in the reference too).  ``serve.engine``'s prefill step on
    prompts of 2048 and 512 tokens — the first runs K9 in each of the 32
    attention layers, the second none — spliced into a two-slot cache,
    then 16 decode steps through ``GraphedDecode`` around
    ``make_decode_step``, each run eagerly too on the same cache state
    (tokens equal); then decode against the forward for both prompts,
    given their images."""
    cfg = get_config(VLM_ARCH)
    n_attn = cfg.layer_pattern.count("A") * (
        cfg.num_layers // len(cfg.layer_pattern))
    assert n_attn == 32 and cfg.num_layers - n_attn == 8
    params, n_params, n_bytes, init_s = draw_params(cfg, VLM_PARAMS)
    gates = [float(seg[k].float().abs().min()) for seg in
             (params["segments"][0]["slot4"],) for k in ("gate_attn",
                                                         "gate_ffn")]
    assert min(gates) >= 0.5, gates
    emit("vlm_serve_params", arch=VLM_ARCH, num_layers=cfg.num_layers,
         d_model=cfg.d_model, params=n_params, bytes=n_bytes,
         init_s=round(init_s, 3))
    gen = torch.Generator(device=DEV).manual_seed(2)
    images = [torch.randn((1, cfg.num_image_tokens, cfg.d_model),
                          generator=gen, device=DEV).to(torch.bfloat16)
              for _ in VLM_PROMPTS]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, T).astype(np.int32)
               for T in VLM_PROMPTS]
    capacity = max(VLM_PROMPTS) + VLM_DECODE_STEPS + 1
    cache = transformer.init_cache(cfg, len(VLM_PROMPTS), capacity,
                                   device=DEV)
    prefill = make_prefill_step(cfg)
    admissions, firsts = [], []
    # keep q, k, v of layer 0 of the 2048-token prefill for
    # ``flash_path_check`` (the call goes on to the kernel as it is)
    captured: dict = {}
    launch_k9 = kfa.flash_attention

    def capturing(q, k, v, **kw):
        if not captured:
            captured.update(q=q.clone(), k=k.clone(), v=v.clone())
        return launch_k9(q, k, v, **kw)

    for i, (prompt, img) in enumerate(zip(prompts, images)):
        x = torch.as_tensor(prompt[None, :], device=DEV)
        reset_launch_counts()
        kfa.flash_attention = capturing
        t = time.perf_counter()
        try:
            last, caches = prefill(params, x, img)
            torch.cuda.synchronize()
        finally:
            kfa.flash_attention = launch_k9
        seconds = time.perf_counter() - t
        admissions.append({"prompt": len(prompt), "seconds": seconds,
                           "launches": {k: n for k, n in
                                        launch_counts().items() if n}})
        firsts.append(int(last.argmax(-1)[0]))
        splice(cfg, cache, i, caches, len(prompt))
        del caches, last
    assert admissions[0]["launches"] == {"flashattn": n_attn}, admissions
    assert admissions[1]["launches"] == {}, admissions
    # the cache a decode step reads: every attention position of the
    # capacity, and the image K and V
    cache_bytes = sum(c.numel() * c.element_size() for c in leaves(cache))
    step_bytes = n_bytes - params["embed"].numel() * 2 + cache_bytes
    eager = make_decode_step(cfg)
    graphed = GraphedDecode(eager)
    toks = torch.tensor([[f] for f in firsts], device=DEV)
    pos = torch.tensor(VLM_PROMPTS, device=DEV)
    rows, generated = [], [[f] for f in firsts]
    reset_launch_counts()
    for i in range(VLM_DECODE_STEPS):
        logits, row = paired_step(eager, graphed, params, cache, toks, pos,
                                  i, stateful=False)
        rows.append(row)
        nxt = logits.argmax(-1)
        for row, t_ in zip(generated, nxt.tolist()):
            row.append(t_)
        toks, pos = nxt[:, None], pos + 1
    decode_launches = {k: n for k, n in launch_counts().items() if n}
    assert not decode_launches, decode_launches
    assert all(r["tokens_equal"] for r in rows), rows
    assert all(0 <= t_ < cfg.vocab_size for g in generated for t_ in g)
    peak = torch.cuda.max_memory_allocated()
    del cache, graphed
    gc.collect()
    torch.cuda.empty_cache()
    # the prefill held to the forward runs by the forward's dense route
    # (no qk-norm: at these random weights the scores reach the hundreds,
    # and bf16 sums in another order move the softmax); the K9 prefill
    # is printed as ``served_route`` and K9 held on the path's own q, k,
    # v by ``flash_path_check``
    assert captured and captured["q"].shape[1] == VLM_PROMPTS[0], \
        "no 2048-token K9 call"
    flash = flash_path_check("bf16 llama-3.2-vision-11b serving path's "
                             "layer-0 q, k, v", captured["q"],
                             captured["k"], captured["v"],
                             block=cfg.flash_block)
    del captured
    checks = decode_checks_bf16_and_f32(
        cfg, params, [(prompt, i, firsts[i], img)
                      for i, (prompt, img) in enumerate(zip(prompts, images))],
        dense_route=True)
    graphed_ms = float(np.median([r["ms"]["graph"] for r in rows]))
    param_bound_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    out = {"arch": VLM_ARCH, "num_layers": cfg.num_layers,
           "attention_layers": n_attn, "params": n_params,
           "param_bytes": n_bytes, "init_s": init_s,
           "image_tokens": cfg.num_image_tokens,
           "prompts": list(VLM_PROMPTS), "admissions": admissions,
           "k9_launches_per_prefill": [a["launches"].get("flashattn", 0)
                                       for a in admissions],
           "decode_steps": len(rows),
           "decode_step_ms_median": graphed_ms,
           "decode_step_ms_median_eager": float(np.median(
               [r["ms"]["eager"] for r in rows])),
           "decode_step_ms_first_graphed": rows[0]["ms"]["graph"],
           "param_bytes_at_peak_rate_ms": param_bound_ms,
           "decode_step_bytes": step_bytes,
           "decode_step_bound_ms": step_bytes / PEAK_BYTES_PER_S * 1e3,
           "decode_step_over_param_bound": graphed_ms / param_bound_ms,
           "graphed_vs_eager_max_abs_logit_diff": max(
               r["max_abs_logit_diff"] for r in rows),
           "tokens": generated, "peak_device_bytes": peak,
           "decode_vs_forward": checks, "flash_check": flash}
    emit("vlm_serve_path", **out)
    del params, images
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": {"flashattn": admissions[0]["launches"].get(
        "flashattn", 0) + admissions[1]["launches"].get("flashattn", 0)},
        **out}


# -- phase 7f -----------------------------------------------------------------------

MLA_ARCH, MLA_LAYERS = "deepseek-v3-671b", 5
MLA_PARAMS = 26_618_387_456
# decode against the forward is held in f32 on this many layers (3 dense,
# 1 MoE: 15.11 G parameters, 60.44 GB in f32)
MLA_F32_LAYERS = 4
MLA_CLI = ["--arch", MLA_ARCH]


def mla_serving_config():
    """deepseek-v3-671b at its published widths, 5 of its 61 layers: the
    3 dense-prefix layers (MLP ff 18432) and 2 MoE layers (256 experts of
    2048, top-8, one shared), so both segments run and the MoE segment's
    loop more than once.  53.24 GB of bf16 weights; 4 layers would be
    30.22 GB with one MoE layer, 6 layers 76.25 GB, which leaves no room
    for a 4096-token prefill."""
    return dataclasses.replace(get_config(MLA_ARCH), num_layers=MLA_LAYERS)


def phase_mla_serve_path() -> dict:
    """The MLA serving path at published widths: deepseek-v3-671b (MLA
    with q_lora 1536, kv_lora 512, 128 heads of 128 + 64 rope columns for
    q and k and 128 for v; MoE of 256 experts), 5 of its 61 layers, bf16
    random weights drawn on the card from a seed, behind
    ``ContinuousBatcher`` with ``serve_path``'s slots, capacity and six
    prompts, so that five prefills run K9 at (Dq, Dv) = (192, 128) in
    every layer (128 heads).  Then graphed against eager decode steps,
    decode against the full forward on a capacity that drops nothing
    (``check_decode``: reported in bf16, held in f32 on 4 layers), K9 on
    the path's own layer-0 q, k, v against an f64 oracle, and the serving
    CLI at ``--arch deepseek-v3-671b`` (its reduced config)."""
    cfg = mla_serving_config()
    m = cfg.mla
    assert (m.qk_nope_dim + m.qk_rope_dim, m.v_dim) == MLA_HEAD_DIMS
    assert cfg.moe.num_experts == 256 and cfg.moe.top_k == 8
    params, n_params, n_bytes, init_s = draw_params(cfg, MLA_PARAMS)
    emit("mla_serve_params", arch=MLA_ARCH, num_layers=cfg.num_layers,
         published_layers=get_config(MLA_ARCH).num_layers,
         d_model=cfg.d_model, params=n_params, bytes=n_bytes,
         init_s=round(init_s, 3))

    rng = np.random.default_rng(0)
    b = ContinuousBatcher(cfg, params, slots=SERVE_SLOTS,
                          capacity=SERVE_CAPACITY)
    cache_bytes = sum(t.numel() * t.element_size() for t in leaves(b.cache))
    # each decode step hands the card its (slots, 1) tokens and (slots,)
    # positions as the batcher keeps them
    decode_input_bytes = b.last_token[:, None].nbytes + b.positions.nbytes
    for i, T in enumerate(SERVE_PROMPTS):
        b.submit(Request(uid=i, prompt=rng.integers(
            0, cfg.vocab_size, T).astype(np.int32),
            max_new_tokens=SERVE_NEW, eos_id=-1))
    # one decode step reads every weight but the embedding table (of which
    # it gathers a row a slot; every expert, as the einsum path does) and
    # every slot's latent cache at full capacity
    cache_bytes = sum(c.numel() * c.element_size() for c in leaves(b.cache))
    step_bytes = n_bytes - params["embed"].numel() * 2 + cache_bytes
    admissions, decode_steps, restore = timing_batcher(b)
    # every K9 call's (Sq, Dq, Dv), and q, k, v of layer 0 of the first
    # 4096-token prefill (the calls go on to the kernel as they are)
    calls, captured = [], {}
    launch_k9 = kfa.flash_attention

    def capturing(q, k, v, **kw):
        calls.append((q.shape[1], q.shape[3], v.shape[3]))
        if not captured and q.shape[1] == 4096:
            captured.update(q=q.clone(), k=k.clone(), v=v.clone())
        return launch_k9(q, k, v, **kw)

    kfa.flash_attention = capturing
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        steps = b.run_to_completion()
    finally:
        kfa.flash_attention = launch_k9
    run_s = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tokens = sum(len(r.generated) for r in b.finished)
    assert sorted(r.uid for r in b.finished) == list(range(6)), b.finished
    for r in b.finished:
        assert len(r.generated) == SERVE_NEW and r.done, (r.uid, r.generated)
        assert all(0 <= t < cfg.vocab_size for t in r.generated)
    long_prompts = [T for T in SERVE_PROMPTS if T > cfg.flash_block]
    assert len(long_prompts) >= 4 and 4096 in long_prompts
    want_k9 = cfg.num_layers * len(long_prompts)
    assert launches["flashattn"] == want_k9 == 25, launches
    assert {k for k, n in launches.items() if n} == {"flashattn"}, launches
    # every layer of every prefill over the flash block, in admission order
    assert calls == [(T,) + MLA_HEAD_DIMS for T in long_prompts
                     for _ in range(cfg.num_layers)], calls
    assert captured and tuple(captured["q"].shape) == (
        1, 4096, cfg.num_heads, MLA_HEAD_DIMS[0]) and \
        captured["v"].shape[3] == MLA_HEAD_DIMS[1]
    restore(b)
    paired = compare_graphed_decode(cfg, params, b, np.random.default_rng(1))
    # decode against the forward on a capacity that drops nothing (factor
    # E / k): the 512-token request and a 12-token prompt (a longer
    # prompt's lossless forward would hold every expert's C = T buffers
    # beside 53 GB of weights; K9's prefills are held by
    # ``flash_path_check`` and ``hybrid_card_vs_cpu``).  In bf16, as
    # served, reported and not held: with 256 experts the router logits
    # tie in bf16 (smallest top-k margin 0), and the decode step and the
    # forward round in other places (latent weight absorption against
    # expanded K and V), so some token routes apart in every run (each
    # flip must still be explained by the runs' logit drift).  Then held
    # in f32 at the published widths on 4 layers (3 dense, 1 MoE; 60.4
    # GB: the 5 layers would be 106 GB in f32), drawn on the card from
    # seed 0
    lossless = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    by_uid = {r.uid: r for r in b.finished}
    requests = [(by_uid[4].prompt, 4), (rng.integers(
        0, cfg.vocab_size, SERVE_SHORT_PROMPT), "short")]
    checks = {"bf16": [check_decode(lossless, params, prompt, uid,
                                    dense_route=True, hold=False)
                       for prompt, uid in requests]}
    # ``restore`` holds the batcher's captured decode step, and with it
    # the weights
    del b, params, restore
    gc.collect()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated() < n_bytes // 4, \
        "the bf16 weights are still held"
    flash = flash_path_check("bf16 deepseek-v3-671b serving path's layer-0 "
                             "q, k, v", captured["q"], captured["k"],
                             captured["v"], block=cfg.flash_block)
    checks.update(f32_decode_checks(
        lossless, [(prompt, uid, None) for prompt, uid in requests],
        MLA_F32_LAYERS))
    # the flips a tie excuses must leave some f32 decode step held
    assert any(c["held"]["decode"] for c in checks["f32"]), checks

    cli = run_serve_cli(MLA_CLI, cfg)
    graphed_ms = float(np.median(decode_steps)) * 1e3
    bound_ms = step_bytes / PEAK_BYTES_PER_S * 1e3
    out = {"arch": MLA_ARCH, "num_layers": cfg.num_layers,
           "published_layers": get_config(MLA_ARCH).num_layers,
           "params": n_params, "param_bytes": n_bytes,
           "head_dims": list(MLA_HEAD_DIMS), "slots": SERVE_SLOTS,
           "capacity": SERVE_CAPACITY, "prompts": list(SERVE_PROMPTS),
           "max_new_tokens": SERVE_NEW, "init_s": init_s, "steps": steps,
           "tokens": tokens, "seconds": run_s, "tokens_per_s": tokens / run_s,
           "admissions": admissions,
           "decode_steps": len(decode_steps),
           "decode_step_ms_median": graphed_ms,
           "decode_step_ms_median_eager": paired["eager_step_ms_median"],
           "decode_step_ms_max": max(decode_steps) * 1e3,
           "decode_step_ms_first": decode_steps[0] * 1e3,
           "decode_step_bytes": step_bytes,
           "decode_step_cache_bytes": cache_bytes,
           "decode_step_bound_ms": bound_ms,
           "decode_step_over_bound": graphed_ms / bound_ms,
           "graphed_vs_eager": paired, "launches": launches,
           "peak_device_bytes": peak, "decode_vs_forward": checks,
           "flash_check": flash,
           "cli": cli}
    emit("mla_serve_path", **out)
    emit("mla_serve_report", init_s=init_s,
         seconds_per_admission=[[a["prompt"], a["seconds"]]
                                for a in admissions],
         decode_step_ms_median_graphed=graphed_ms,
         decode_step_ms_median_eager=paired["eager_step_ms_median"],
         decode_step_bytes=step_bytes, decode_step_bound_ms=bound_ms,
         tokens_per_s=out["tokens_per_s"], peak_device_bytes=peak,
         k9_launches=launches["flashattn"])
    torch.cuda.empty_cache()
    return {**out, "captured": captured}

# -- phases 7h, 7i ------------------------------------------------------------------

# the dense configs served at published widths and full depth: parameter
# count and K9 launches over ``SERVE_PROMPTS`` (layers x the five prompts
# longer than the flash block)
DENSE_SERVED = {"deepseek-7b": (6_910_365_696, 150),
                "granite-20b": (20_013_766_656, 260),
                "command-r-35b": (30_283_538_432, 200)}
# decode against the forward is reported in bf16 and held in f32 at
# published widths on this many layers.  At random weights (no qk-norm)
# none of the four meets ``SERVE_LOGIT_TOL`` with argmax equal in bf16
# (PERF.md, on an H100 80GB HBM3 at 700 W: deepseek-7b's 12-token
# argmax flips, command-r-35b misses by up to 0.90, granite-20b by up to
# 4.1, musicgen-large's 512-frame argmax flips).  deepseek-7b and
# musicgen-large fit whole in f32; command-r-35b's 16 layers are 53.5 GB.
# granite-20b's f32 forward is chaotic past a few layers
# (``DENSE_ULP_SCAN``): on 4 layers its decode missed the forward by 0.47
DENSE_F32_LAYERS = {"deepseek-7b": 30, "granite-20b": 2,
                    "command-r-35b": 16}
# granite-20b's f32 ``ulp_sensitivity`` by depth, printed beside its held
# check: why it is held on 2 layers
DENSE_ULP_SCAN = {"granite-20b": (2, 4, 8, 16, 24)}
AUDIO_ARCH = "musicgen-large"
AUDIO_PARAMS = 3_229_812_736
AUDIO_PROMPTS = (4096, 2048, 512)
AUDIO_K9 = 96                 # 48 layers x the two prompts over 1024
AUDIO_DECODE_STEPS = 16
AUDIO_F32_LAYERS = 48


def phase_dense_serve_path(arch: str) -> dict:
    """A dense config at published widths and full depth (deepseek-7b:
    32 heads and 32 KV heads of 128; granite-20b: 48 heads and one KV
    head, so decode attention runs at 48 groups, GELU MLP, tied head;
    command-r-35b: 64 heads and 8 KV heads, tied 256 000-row head, RoPE
    theta 4e6), bf16 random weights drawn on the card from a seed, behind
    ``ContinuousBatcher`` with ``serve_path``'s slots, capacity and six
    prompts, so that five prefills run K9 at (128, 128) in every layer.
    Then graphed against eager decode steps, decode against the full
    forward for two requests and a 12-token prompt (``check_decode``:
    reported in bf16, held in f32 on ``DENSE_F32_LAYERS`` layers), K9 on
    the path's own layer-0 q, k, v against an f64 oracle, and the serving
    CLI at ``--arch <arch>`` (its reduced config)."""
    cfg = get_config(arch)
    want_params, want_k9 = DENSE_SERVED[arch]
    params, n_params, n_bytes, init_s = draw_params(cfg, want_params)
    emit("dense_serve_params", arch=arch, num_layers=cfg.num_layers,
         d_model=cfg.d_model, params=n_params, bytes=n_bytes,
         init_s=round(init_s, 3))
    rng = np.random.default_rng(0)
    b = ContinuousBatcher(cfg, params, slots=SERVE_SLOTS,
                          capacity=SERVE_CAPACITY)
    cache_bytes = sum(t.numel() * t.element_size() for t in leaves(b.cache))
    decode_input_bytes = b.last_token[:, None].nbytes + b.positions.nbytes
    # one decode step reads every weight — the embedding table whole where
    # the head is tied to it, else a row a slot and the head whole — and
    # every slot's K and V at full capacity
    embed_bytes = params["embed"].numel() * params["embed"].element_size()
    step_bytes = n_bytes - (0 if cfg.tie_embeddings else embed_bytes) \
        + cache_bytes
    for i, T in enumerate(SERVE_PROMPTS):
        b.submit(Request(uid=i, prompt=rng.integers(
            0, cfg.vocab_size, T).astype(np.int32),
            max_new_tokens=SERVE_NEW, eos_id=-1))
    admissions, decode_steps, restore = timing_batcher(b)
    captured: dict = {}
    kfa.flash_attention, launch_k9 = capturing_k9(captured, 4096)
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        steps = b.run_to_completion()
    finally:
        kfa.flash_attention = launch_k9
    run_s = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tokens = sum(len(r.generated) for r in b.finished)
    assert sorted(r.uid for r in b.finished) == list(range(6)), b.finished
    for r in b.finished:
        assert len(r.generated) == SERVE_NEW and r.done, (r.uid, r.generated)
        assert all(0 <= t < cfg.vocab_size for t in r.generated)
    assert launches["flashattn"] == cfg.num_layers * sum(
        T > cfg.flash_block for T in SERVE_PROMPTS) == want_k9, launches
    assert {k for k, n in launches.items() if n} == {"flashattn"}, launches
    assert captured and tuple(captured["q"].shape) == tuple(
        captured["k"].shape) == (1, 4096, cfg.num_heads, cfg.head_dim), \
        "no 4096-token K9 call"
    restore(b)
    paired = compare_graphed_decode(cfg, params, b, np.random.default_rng(1))
    by_uid = {r.uid: r for r in b.finished}
    requests = [(by_uid[u].prompt, u, by_uid[u].generated[0])
                for u in (0, 4)] + [(rng.integers(
                    0, cfg.vocab_size, SERVE_SHORT_PROMPT), "short", None)]
    checks = bf16_decode_checks(cfg, params, requests)
    # ``restore`` holds the batcher's captured decode step, and with it
    # the weights
    del b, params, restore
    gc.collect()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated() < n_bytes // 4, \
        "the bf16 weights are still held"
    flash = flash_path_check(f"bf16 {arch} serving path's layer-0 q, k, v",
                             captured["q"], captured["k"], captured["v"],
                             block=cfg.flash_block)
    del captured
    checks.update(f32_decode_checks(cfg, requests, DENSE_F32_LAYERS[arch]))
    if arch in DENSE_ULP_SCAN:
        checks["f32_ulp_sensitivity_by_layers"] = ulp_sensitivity_by_depth(
            cfg, DENSE_ULP_SCAN[arch], requests[0][0])
    cli = run_serve_cli(["--arch", arch], cfg)
    graphed_ms = float(np.median(decode_steps)) * 1e3
    bound_ms = step_bytes / PEAK_BYTES_PER_S * 1e3
    out = {"arch": arch, "num_layers": cfg.num_layers,
           "heads": [cfg.num_heads, cfg.num_kv_heads, cfg.head_dim],
           "params": n_params, "param_bytes": n_bytes, "slots": SERVE_SLOTS,
           "capacity": SERVE_CAPACITY, "cache_bytes": cache_bytes,
           "decode_input_bytes": decode_input_bytes,
           "prompts": list(SERVE_PROMPTS), "max_new_tokens": SERVE_NEW,
           "init_s": init_s, "steps": steps, "tokens": tokens,
           "seconds": run_s, "tokens_per_s": tokens / run_s,
           "admissions": admissions, "decode_steps": len(decode_steps),
           "decode_step_ms_median": graphed_ms,
           "decode_step_ms_median_eager": paired["eager_step_ms_median"],
           "decode_step_ms_max": max(decode_steps) * 1e3,
           "decode_step_ms_first": decode_steps[0] * 1e3,
           "decode_step_bytes": step_bytes,
           "decode_step_bound_ms": bound_ms,
           "decode_step_over_bound": graphed_ms / bound_ms,
           "graphed_vs_eager": paired, "launches": launches,
           "peak_device_bytes": peak, "decode_vs_forward": checks,
           "flash_check": flash, "cli": cli}
    emit("dense_serve_path", **out)
    emit("dense_serve_report", arch=arch, init_s=init_s,
         seconds_per_admission=[[a["prompt"], a["seconds"]]
                                for a in admissions],
         decode_step_ms_median_graphed=graphed_ms,
         decode_step_ms_median_eager=paired["eager_step_ms_median"],
         decode_step_bytes=step_bytes, decode_step_bound_ms=bound_ms,
         tokens_per_s=out["tokens_per_s"], peak_device_bytes=peak,
         k9_launches=launches["flashattn"],
         k9_mean_relative_bias=flash["mean_relative_bias"])
    torch.cuda.empty_cache()
    return out


def phase_audio_serve_path() -> dict:
    """The audio serving path at published widths and full depth:
    musicgen-large (48 layers, d_model 2048, 32 heads and 32 KV heads of
    64, untied 2048-code head), whose inputs are frame embeddings (the
    EnCodec frontend is a stub in the reference too), bf16 random weights
    drawn on the card from a seed.  Both packages' batchers take token
    ids only, so it runs through ``serve.engine``'s steps, as
    ``vlm_serve_path`` does: prefill seeded (1, T, 2048) bf16 frames at T
    = 4096, 2048 and 512 (K9 at (64, 64) in each of the 48 layers of the
    first two), splice the caches into one three-slot cache, then 16
    decode steps through ``GraphedDecode`` on (3, 1, 2048) frames, each
    the embedding-table row of the code the step before sampled, each
    step run eagerly too on the same cache (codes equal).  Then K9 on the
    path's own layer-0 q, k, v against an f64 oracle, and decode against
    the forward on the same frames for the 2048- and 512-frame prompts
    and a 12-frame one (reported in bf16, held in f32 at full depth)."""
    cfg = get_config(AUDIO_ARCH)
    assert cfg.input_mode == "embeddings" and cfg.head_dim == 64 \
        and cfg.num_kv_heads == cfg.num_heads
    params, n_params, n_bytes, init_s = draw_params(cfg, AUDIO_PARAMS)
    emit("audio_serve_params", arch=AUDIO_ARCH, num_layers=cfg.num_layers,
         d_model=cfg.d_model, params=n_params, bytes=n_bytes,
         init_s=round(init_s, 3))
    gen = torch.Generator(device=DEV).manual_seed(2)
    prompts = [torch.randn((1, T, cfg.d_model), generator=gen,
                           device=DEV).to(torch.bfloat16)
               for T in AUDIO_PROMPTS]
    capacity = max(AUDIO_PROMPTS) + AUDIO_DECODE_STEPS + 1
    cache = transformer.init_cache(cfg, len(prompts), capacity, device=DEV)
    prefill = make_prefill_step(cfg)
    admissions, firsts = [], []
    captured: dict = {}
    for i, x in enumerate(prompts):
        reset_launch_counts()
        kfa.flash_attention, launch_k9 = capturing_k9(captured, 4096)
        t = time.perf_counter()
        try:
            last, caches = prefill(params, x)
            torch.cuda.synchronize()
        finally:
            kfa.flash_attention = launch_k9
        admissions.append({"prompt": x.shape[1],
                           "seconds": time.perf_counter() - t,
                           "launches": {k: n for k, n in
                                        launch_counts().items() if n}})
        firsts.append(int(last.argmax(-1)[0]))
        splice(cfg, cache, i, caches, x.shape[1])
        del caches, last
    k9 = [a["launches"].get("flashattn", 0) for a in admissions]
    assert k9 == [cfg.num_layers if T > cfg.flash_block else 0
                  for T in AUDIO_PROMPTS] and sum(k9) == AUDIO_K9, admissions
    assert all(set(a["launches"]) <= {"flashattn"} for a in admissions)
    assert captured and tuple(captured["q"].shape) == tuple(
        captured["k"].shape) == (1, 4096, cfg.num_heads, 64)
    # one decode step reads every weight but the embedding table (the next
    # frames are gathered from it outside the step) and every slot's K
    # and V at full capacity
    embed = params["embed"]
    cache_bytes = sum(c.numel() * c.element_size() for c in leaves(cache))
    step_bytes = n_bytes - embed.numel() * embed.element_size() + cache_bytes
    eager = make_decode_step(cfg)
    graphed = GraphedDecode(eager)
    codes = torch.tensor(firsts, device=DEV)
    pos = torch.tensor(AUDIO_PROMPTS, device=DEV)
    rows, generated = [], [[f] for f in firsts]
    reset_launch_counts()
    for i in range(AUDIO_DECODE_STEPS):
        logits, row = paired_step(eager, graphed, params, cache,
                                  embed[codes][:, None], pos, i,
                                  stateful=False)
        rows.append(row)
        codes = logits.argmax(-1)
        for g, c in zip(generated, codes.tolist()):
            g.append(c)
        pos = pos + 1
    decode_launches = {k: n for k, n in launch_counts().items() if n}
    assert not decode_launches, decode_launches
    assert all(r["tokens_equal"] for r in rows), rows
    assert all(0 <= c < cfg.vocab_size for g in generated for c in g)
    peak = torch.cuda.max_memory_allocated()
    del cache, graphed
    gc.collect()
    torch.cuda.empty_cache()
    flash = flash_path_check("bf16 musicgen-large serving path's layer-0 "
                             "q, k, v", captured["q"], captured["k"],
                             captured["v"], block=cfg.flash_block)
    short = torch.randn((1, SERVE_SHORT_PROMPT, cfg.d_model), generator=gen,
                        device=DEV).to(torch.bfloat16)
    requests = [(prompts[1], 1, firsts[1]), (prompts[2], 2, firsts[2]),
                (short, "short", None)]
    checks = bf16_decode_checks(cfg, params, requests)
    del params, embed
    checks.update(f32_decode_checks(cfg, requests, AUDIO_F32_LAYERS))
    graphed_ms = float(np.median([r["ms"]["graph"] for r in rows]))
    bound_ms = step_bytes / PEAK_BYTES_PER_S * 1e3
    n_codes = sum(len(g) for g in generated)
    serve_s = sum(a["seconds"] for a in admissions) + sum(
        r["ms"]["graph"] for r in rows) / 1e3
    out = {"arch": AUDIO_ARCH, "num_layers": cfg.num_layers,
           "params": n_params, "param_bytes": n_bytes, "init_s": init_s,
           "prompts": list(AUDIO_PROMPTS), "admissions": admissions,
           "k9_launches_per_prefill": k9, "cache_bytes": cache_bytes,
           "decode_steps": len(rows),
           "decode_step_ms_median": graphed_ms,
           "decode_step_ms_median_eager": float(np.median(
               [r["ms"]["eager"] for r in rows])),
           "decode_step_ms_first_graphed": rows[0]["ms"]["graph"],
           "decode_step_bytes": step_bytes,
           "decode_step_bound_ms": bound_ms,
           "decode_step_over_bound": graphed_ms / bound_ms,
           "graphed_vs_eager_max_abs_logit_diff": max(
               r["max_abs_logit_diff"] for r in rows),
           "codes": generated, "tokens": n_codes,
           "tokens_per_s": n_codes / serve_s,
           "tokens_per_s_counts": "prefills and graphed decode steps",
           "peak_device_bytes": peak, "decode_vs_forward": checks,
           "flash_check": flash}
    emit("audio_serve_path", **out)
    del prompts
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": {"flashattn": sum(k9)}, "captured": captured, **out}


# -- phase 7b -----------------------------------------------------------------------

TRAIN_ARCH, TRAIN_BIG = "repro-100m", "qwen3-4b"
TRAIN_CLI = ["--arch", TRAIN_ARCH, "--batch", "8", "--seq", "1024",
             "--ckpt-every", "10"]
TRAIN_STEPS, TRAIN_RESUME_STEPS = 30, 35
TRAIN_BIG_STEPS, TRAIN_BIG_SEQ = 3, 4096
# the card-vs-CPU step: the CPU tests' optimizer settings and tolerances
# (tests/test_torch_train.py)
TRAIN_CMP_OPT = dict(lr=1e-2, warmup_steps=2, total_steps=50)
TRAIN_SCALAR_TOL, TRAIN_GRAD_TOL, TRAIN_PARAM_TOL = 1e-5, 1e-4, 1e-4


@contextlib.contextmanager
def capturing_bwd(store: dict, shape):
    """Keep the inputs of the first K9-bwd call at ``shape`` (the call goes
    on to the kernel as it is)."""
    real = kfa.flash_attention_bwd

    def call(q, k, v, o, do, lse, **kw):
        if not store and tuple(q.shape) == tuple(shape):
            store.update(q=q.clone(), k=k.clone(), v=v.clone(), o=o.clone(),
                         do=do.clone(), lse=lse.clone(), causal=kw["causal"])
        return real(q, k, v, o, do, lse, **kw)

    kfa.flash_attention_bwd = call
    try:
        yield store
    finally:
        kfa.flash_attention_bwd = real


def run_train_cli(argv) -> tuple:
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        losses = train_launch.main(argv)
    return losses, buf.getvalue().splitlines(), time.perf_counter() - t0


def train_cli_runs(ckpt_dir: str) -> dict:
    """repro-100m through ``launch.train.main`` as users start it: 30
    steps with checkpoints every 10, then again to step 35 in the same
    directory, which must resume from step 30 with the parameters of the
    step-30 files bit for bit."""
    before = launch_counts()
    losses, lines, seconds = run_train_cli(
        TRAIN_CLI + ["--steps", str(TRAIN_STEPS), "--ckpt-dir", ckpt_dir])
    assert len(losses) == TRAIN_STEPS and np.isfinite(losses).all(), losses
    assert losses[-1] <= losses[0] - 0.2, (losses[0], losses[-1])
    assert lines[0].startswith(f"arch={TRAIN_ARCH} params="), lines
    assert lines[-1].startswith("final loss "), lines
    assert sorted(os.listdir(ckpt_dir)) == ["step_10", "step_20", "step_30"]
    files = os.path.join(ckpt_dir, f"step_{TRAIN_STEPS}")
    manifest = json.load(open(os.path.join(files, "manifest.json")))
    restored: dict = {}
    real = train_launch.ckpt.restore_latest

    def recording(directory, like, shardings=None):
        state, step = real(directory, like, shardings)
        if state is not None:
            restored["step"] = step
            restored["leaves"] = [x.detach().cpu().clone()
                                  for x in train_tree.leaves(state)]
        return state, step

    train_launch.ckpt.restore_latest = recording
    try:
        resumed, lines2, seconds2 = run_train_cli(
            TRAIN_CLI + ["--steps", str(TRAIN_RESUME_STEPS), "--ckpt-dir",
                         ckpt_dir])
    finally:
        train_launch.ckpt.restore_latest = real
    assert lines2[0] == f"resumed from step {TRAIN_STEPS}", lines2[:2]
    assert restored["step"] == TRAIN_STEPS
    assert len(resumed) == TRAIN_RESUME_STEPS - TRAIN_STEPS
    assert len(restored["leaves"]) == manifest["num_leaves"]
    for i, leaf in enumerate(restored["leaves"]):
        arr = np.load(os.path.join(files, f"arr_{i}.npy"))
        assert np.array_equal(leaf.numpy(), arr), f"leaf {i} differs"
    return {"arch": TRAIN_ARCH, "argv": TRAIN_CLI,
            "first_loss": losses[0], "last_loss": losses[-1],
            "losses": losses, "seconds": seconds, "lines": lines,
            "resume": {"lines": lines2, "seconds": seconds2,
                       "losses": resumed, "leaves_equal_to_files":
                           manifest["num_leaves"]},
            "launches": {k: v - before[k] for k, v in launch_counts().items()
                         if v != before[k]}}


def one_step_launches(captured: dict) -> dict:
    """One repro-100m step at the CLI's shape with the counts set to 0
    before it: K9 twice per layer (the forward and remat's recompute) and
    K9-bwd once.  Keeps the first K9-bwd call's inputs for phase
    ``kernels``."""
    cfg = get_config(TRAIN_ARCH)
    opt_cfg = train_opt.OptConfig()
    state = train_step.init_state(cfg, opt_cfg, 1, device=DEV)
    batch = TokenPipeline(cfg.vocab_size, 1024, 8, seed=1).batch_at(0)
    step = train_step.make_train_step(cfg, opt_cfg)
    reset_launch_counts()
    with capturing_bwd(captured, (8, 1024, cfg.num_heads, cfg.head_dim)):
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
    launches = launch_counts()
    assert cfg.remat
    assert launches["flashattn"] == 2 * cfg.num_layers == 20, launches
    assert launches["flashattn_bwd"] == cfg.num_layers == 10, launches
    assert {k for k, n in launches.items() if n} == \
        {"flashattn", "flashattn_bwd"}, launches
    return {"launches": launches, "loss": float(metrics["loss"])}


K9_BWD_KERNELS = re.compile(r"\b(stats_kernel|dkdv_kernel|dq_kernel)\b")


def device_time_split(prof, seconds: float, step: int) -> dict:
    """Device time by kernel name of one traced step (CUDA activity of
    ``torch.profiler``, kernels only): the top 10, K9-bwd's share (its
    three kernels, ``K9_BWD_KERNELS``) and the device time over the traced
    step's own host-clock seconds (which the tracer lengthens).  A trace
    without device time fails."""
    by_name: dict = {}
    launches: dict = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        by_name[evt.name] = by_name.get(evt.name, 0.0) + \
            evt.device_time_total / 1e3
        launches[evt.name] = launches.get(evt.name, 0) + 1
    total = sum(by_name.values())
    assert total > 0, "the profiler saw no device time"
    bwd = sum(ms for name, ms in by_name.items()
              if K9_BWD_KERNELS.search(name))
    top = sorted(by_name.items(), key=lambda x: -x[1])[:10]
    return {"step": step, "seconds_traced": seconds, "device_ms": total,
            "device_ms_over_traced_step": total / 1e3 / seconds,
            "k9_bwd_ms": bwd, "k9_bwd_share": bwd / total,
            "kernels": len(by_name),
            "top10": [{"name": name[:160], "ms": ms,
                       "launches": launches[name], "share": ms / total}
                      for name, ms in top]}


# deepseek-v3-671b trains on the card at its published widths cut to its 3
# dense-prefix layers: 3.6 G parameters, about 43.2 GB of bf16 parameters
# and gradients and f32 moments; a fourth layer, the first MoE one, would
# make it 15.1 G parameters and about 181 GB
MLA_TRAIN_LAYERS, MLA_TRAIN_PARAMS = 3, 3_603_815_424


def big_model_steps(captured: dict, cfg, want_params: int,
                    profile: bool = True) -> dict:
    """``cfg`` at its published widths: weights drawn on the card from a
    seed, f32 moments (``OptConfig()``), three steps of
    ``make_train_step`` at batch 1 x 4096 tokens, launches per step (K9
    twice per layer with remat, K9-bwd once) and each K9 call's (Sq, H,
    Dq, Dv); with ``profile`` a fourth step under ``torch.profiler`` for
    the device time by kernel (``device_time_split``)."""
    opt_cfg = train_opt.OptConfig()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train_step.init_state(cfg, opt_cfg, 0, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = train_tree.leaves(state["params"])
    n_params = sum(p.numel() for p in params)
    assert n_params == cfg.param_count() == want_params, n_params
    assert {p.dtype for p in params} == {torch.bfloat16}
    state_bytes = sum(x.numel() * x.element_size()
                      for x in train_tree.leaves(state))
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_BIG_SEQ, 1, seed=0)
    # what a step's batch takes on the card: the step copies each array
    # as it is (int32) to the card
    batch_bytes = sum(v.nbytes for v in pipe.batch_at(0).values())
    step = train_step.make_train_step(cfg, opt_cfg)
    head_dims = (cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim, cfg.mla.v_dim) \
        if cfg.mla else (cfg.head_dim, cfg.head_dim)
    calls: list = []
    launch_k9 = kfa.flash_attention

    def recording(q, k, v, **kw):
        calls.append((q.shape[1], q.shape[2], q.shape[3], v.shape[3]))
        return launch_k9(q, k, v, **kw)

    steps = []
    traced_profile = None
    kfa.flash_attention = recording
    try:
        for i in range(TRAIN_BIG_STEPS + profile):
            reset_launch_counts()
            calls.clear()
            traced = i == TRAIN_BIG_STEPS
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) if traced else \
                contextlib.nullcontext()
            torch.cuda.synchronize()
            t = time.perf_counter()
            with prof, capturing_bwd(captured, (1, TRAIN_BIG_SEQ,
                                                cfg.num_heads, head_dims[0])):
                state, metrics = step(state, pipe.batch_at(i))
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t
            launches = launch_counts()
            assert launches["flashattn"] == 2 * cfg.num_layers, launches
            assert launches["flashattn_bwd"] == cfg.num_layers, launches
            assert calls == [(TRAIN_BIG_SEQ, cfg.num_heads, *head_dims)] \
                * (2 * cfg.num_layers), calls
            if traced:
                traced_profile = device_time_split(prof, seconds, i + 1)
                continue
            steps.append({"loss": float(metrics["loss"]),
                          "grad_norm": float(metrics["grad_norm"]),
                          "lr": float(metrics["lr"]), "seconds": seconds,
                          "launches": {k: n for k, n in launches.items()
                                       if n}})
            assert np.isfinite(steps[-1]["loss"]), steps
            assert np.isfinite(steps[-1]["grad_norm"]), steps
    finally:
        kfa.flash_attention = launch_k9
    median = float(np.median([x["seconds"] for x in steps[1:]]))
    out = {"arch": cfg.name, "params": n_params, "num_layers":
           cfg.num_layers, "published_layers": get_config(
               cfg.name).num_layers, "d_model": cfg.d_model,
           "head_dims": list(head_dims), "batch": 1, "seq": TRAIN_BIG_SEQ,
           "state_dtype": opt_cfg.state_dtype, "init_s": init_s,
           "state_bytes": state_bytes, "batch_bytes": batch_bytes,
           "steps": steps,
           "seconds_per_step_median_2_3": median,
           "tokens_per_s": TRAIN_BIG_SEQ / median,
           "peak_device_bytes": torch.cuda.max_memory_allocated()}
    if profile:
        traced_profile["device_ms_over_median_step"] = \
            traced_profile["device_ms"] / 1e3 / median
        emit("train_step_profile", **traced_profile)
        out["profile"] = traced_profile
    del state, params, step
    torch.cuda.empty_cache()
    return out


def ulp_shifted(state, seed: int = 0):
    """A copy of a CPU training state with every f32 parameter moved one
    ulp up, one down, or left, at random (a seeded generator)."""
    gen = torch.Generator().manual_seed(seed)

    def shift(p):
        way = torch.randint(-1, 2, p.shape, generator=gen)
        toward = torch.where(way > 0, torch.inf, -torch.inf).to(p.dtype)
        moved = torch.where(way == 0, p.detach(),
                            torch.nextafter(p.detach(), toward))
        return moved.requires_grad_(p.requires_grad)

    return {"params": train_tree.map(shift, state["params"]),
            "opt": train_tree.map(lambda x: x.clone(), state["opt"])}


def cpu_floors(cfg, opt_cfg, cpu, batch, g_cpu, new_cpu, m_cpu) -> dict:
    """How far the CPU's own step moves when its weights move by one ulp
    (``ulp_shifted``): per gradient leaf, moment leaf and metric, the
    largest shift, as ``tests/test_torch_train.py`` floors its MoE
    (``ILL_CONDITIONED``) tolerances with the reference's."""
    far = lambda a, b: [(x.detach() - y.detach()).abs().max().item()
                        for x, y in zip(train_tree.leaves(a),
                                        train_tree.leaves(b))]  # noqa: E731
    _, _, g2 = train_step.make_grad_fn(cfg)(cpu["params"], batch)
    new2, m2 = train_step.make_train_step(cfg, opt_cfg)(cpu, batch)
    return {"grads": far(g_cpu, g2),
            "metrics": {k: abs(float(m2[k]) - float(m_cpu[k]))
                        for k in ("loss", "ce", "lr", "grad_norm")},
            "m": far(new_cpu["opt"]["m"], new2["opt"]["m"]),
            "v": far(new_cpu["opt"]["v"], new2["opt"]["v"])}


# the reduced configs whose f32 step is held with a floor from the CPU's
# one-ulp shift (tests/test_torch_train.py ILL_CONDITIONED: dbrx-132b has
# no qk-norm, and a one-ulp shift of its weights moves its gradients by up
# to 1.9e-4 of a leaf's largest entry; reduced deepseek-v3's, no qk-norm
# either, by up to 6.5e-5, and the port's CPU step lies 1.38e-4 from the
# reference's there, over 1e-4 alone).  The tests take twice the shift
# (two f32 runs, each about one shift from exact); the card's K9-bwd f32
# forms its products from split-TF32 terms, which keep about 22 bits of
# each operand where f32 keeps 24, so here it is 4 times
TRAIN_ILL_CONDITIONED = ("dbrx-132b", "jamba-1.5-large-398b",
                         "llama-3.2-vision-11b", MLA_ARCH)
TRAIN_FLOOR_TIMES = 4
# configs whose moments are held to the gradient bound carried through
# Adam's first step, m = (1 - b1)·u and v = (1 - b2)·u² (u the clipped
# gradient, its clip scale within the gradient norm's bound), as the
# parameters are: v is quadratic in the gradient, so a bound of 1e-4 of
# its largest entry plus its own one-ulp floor asks v for a relative
# accuracy twice the gradient's where the gradient is largest (reduced
# jamba's card step: gradients 0.79 of their bound, v 1.30 of that one;
# the earlier configs keep their bounds)
HYBRID_ARCHS = ("jamba-1.5-large-398b", "llama-3.2-vision-11b")
TRAIN_MOMENTS_FROM_GRADS = HYBRID_ARCHS + (MLA_ARCH,)


def card_vs_cpu_step(arch: str = TRAIN_BIG, **overrides) -> dict:
    """One train step of reduced ``arch`` (f32, head dim 64 so that K9
    takes it, S = 64 past its flash block of 32; ``overrides`` on top)
    from one state on the card and on the CPU: loss, ce, lr, grad_norm, every gradient and every
    updated leaf within the CPU tests' tolerances (parameters within
    ``tests/test_torch_train.py``'s ``param_bound``: 1e-4 relative to
    max(|p|, lr) plus the gradient tolerance carried through Adam's first
    step, lr·δ·eps/(max(|g·s| − δ, 0) + eps)², capped at the sign
    allowance 2·lr + wd·lr·|p|).  For ``TRAIN_ILL_CONDITIONED`` configs
    each bound adds the floor of ``cpu_floors``, from the CPU alone.  A
    VLM's gates are opened (``open_gates``) and its batch carries seeded
    image embeddings."""
    cfg = reduced_config(get_config(arch), head_dim=64, **overrides)
    opt_cfg = train_opt.OptConfig(**TRAIN_CMP_OPT)
    cpu = train_step.init_state(cfg, opt_cfg, 0, device="cpu")
    open_gates(cpu["params"], 1)
    card = train_tree.map(lambda x: x.detach().to(
        DEV, copy=True).requires_grad_(x.requires_grad), cpu)
    shifted = ulp_shifted(cpu) if arch in TRAIN_ILL_CONDITIONED else None
    batch = TokenPipeline(cfg.vocab_size, 64, 4, seed=1).batch_at(0)
    if cfg.num_image_tokens:
        batch["image_embeds"] = np.random.default_rng(2).normal(
            size=(4, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    before = launch_counts()
    _, _, g_card = train_step.make_grad_fn(cfg)(card["params"], batch)
    _, _, g_cpu = train_step.make_grad_fn(cfg)(cpu["params"], batch)
    card, m_card = train_step.make_train_step(cfg, opt_cfg)(card, batch)
    cpu, m_cpu = train_step.make_train_step(cfg, opt_cfg)(cpu, batch)
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in launch_counts().items()
                if v != before[k]}
    assert launches.get("flashattn", 0) > 0 and \
        launches.get("flashattn_bwd", 0) > 0, launches
    n = {name: len(train_tree.leaves(g_cpu)) for name in ("grads", "m", "v")}
    floor = {"metrics": {}, **{k: [0.0] * v for k, v in n.items()}}
    if shifted is not None:
        floor = cpu_floors(cfg, opt_cfg, shifted, batch, g_cpu, cpu, m_cpu)
        floor = {"metrics": {k: TRAIN_FLOOR_TIMES * v
                             for k, v in floor["metrics"].items()},
                 **{k: [TRAIN_FLOOR_TIMES * x for x in floor[k]]
                    for k in ("grads", "m", "v")}}
    scalars = {k: [float(m_card[k]), float(m_cpu[k])]
               for k in ("loss", "ce", "lr", "grad_norm")}
    worst = {"grads": 0.0, "params": 0.0, "m": 0.0, "v": 0.0}
    for k, (a, b) in scalars.items():
        bound = TRAIN_SCALAR_TOL * abs(b) + floor["metrics"].get(k, 0.0)
        worst[k] = abs(a - b) / bound if bound else \
            (float("inf") if a != b else 0.0)
    lr, wd = float(m_cpu["lr"]), opt_cfg.weight_decay
    scale = min(1.0, opt_cfg.clip_norm / float(m_cpu["grad_norm"]))
    gnorm = float(m_cpu["grad_norm"])
    rel_scale = (TRAIN_SCALAR_TOL * gnorm + floor["metrics"].get(
        "grad_norm", 0.0)) / gnorm if scale < 1.0 else 0.0
    for gk, gcpu, fl in zip(train_tree.leaves(g_card),
                            train_tree.leaves(g_cpu), floor["grads"]):
        bound = TRAIN_GRAD_TOL * gcpu.abs().max().item() + fl
        worst["grads"] = max(worst["grads"],
                             (gk.cpu() - gcpu).abs().max().item() / bound)
    for pk, pc, gcpu, fl in zip(train_tree.leaves(card["params"]),
                                train_tree.leaves(cpu["params"]),
                                train_tree.leaves(g_cpu), floor["grads"]):
        pc = pc.detach()
        delta = scale * (TRAIN_GRAD_TOL * gcpu.abs().max() + fl)
        moved = lr * delta * opt_cfg.eps / (
            (gcpu.abs() * scale - delta).clamp(min=0) + opt_cfg.eps) ** 2
        bound = TRAIN_PARAM_TOL * pc.abs().clamp(min=lr) + torch.minimum(
            moved, 2 * lr + wd * lr * pc.abs())
        worst["params"] = max(worst["params"], ((pk.detach().cpu() - pc).abs()
                                                / bound).max().item())
    for name in ("m", "v"):
        for a, b, fl, gcpu, gfl in zip(
                train_tree.leaves(card["opt"][name]),
                train_tree.leaves(cpu["opt"][name]), floor[name],
                train_tree.leaves(g_cpu), floor["grads"]):
            if arch in TRAIN_MOMENTS_FROM_GRADS:
                # the gradient bound carried through the first step's
                # m = (1 - b1)·u and v = (1 - b2)·u², u = scale·g: u moves
                # by scale·Δg and by g·Δscale, the clip scale moving with
                # the gradient norm (within its own bound)
                delta = scale * (TRAIN_GRAD_TOL * gcpu.abs().max() + gfl
                                 + gcpu.abs() * rel_scale)
                bound = (1 - opt_cfg.b1) * delta if name == "m" else \
                    (1 - opt_cfg.b2) * (2 * scale * gcpu.abs() + delta) * delta
                worst[name] = max(worst[name], ((a.cpu() - b).abs()
                                                / bound).max().item())
                continue
            bound = TRAIN_GRAD_TOL * b.abs().max().item() + fl
            worst[name] = max(worst[name],
                              (a.cpu() - b).abs().max().item() / bound)
    assert max(worst.values()) <= 1.0, worst
    out = {"config": f"reduced_config({arch}, head_dim=64"
                     + "".join(f", {k}={v}" for k, v in overrides.items())
                     + f"), f32, batch 4 x 64 tokens, flash_block "
                       f"{cfg.flash_block}",
           "metrics_card_cpu": scalars,
           "worst_err_over_tolerance": worst, "launches": launches}
    if shifted is not None:
        out["floor"] = {"metrics": floor["metrics"],
                        "grads_max": max(floor["grads"]),
                        "what": f"{TRAIN_FLOOR_TIMES} x the CPU step's "
                                f"shift when its weights move one ulp"}
    return out


def card_vs_cpu_bf16_step() -> dict:
    """The gradients of the attention the qwen3-4b steps run — bf16, head
    dim 128, K9 with lse and K9-bwd on the bf16 entries — against the CPU:
    reduced qwen3-4b with head dim 128, bf16 parameters and compute, one
    batch of 2 x 256 tokens past its flash block of 32 (two of K9's
    128-row KV tiles).  ``make_grad_fn`` on the card, and on the CPU in
    f32 on the same weights widened.  bf16 rounds every layer's
    activations, so a whole step does not stay within one rounding of the
    f32 one: per gradient leaf (and for loss, ce and grad_norm) the bound
    is the reference's bf16 tolerance, 3e-2 · max|f32|, plus a floor of
    ``FLASH_BWD_FLOOR`` times the largest error of the same step in bf16
    on the CPU (plain attention) against the f32 one."""
    cfg = reduced_config(get_config(TRAIN_BIG), head_dim=128,
                         param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    opt_cfg = train_opt.OptConfig(**TRAIN_CMP_OPT)
    cpu = train_step.init_state(cfg, opt_cfg, 0, device="cpu")["params"]
    assert {p.dtype for p in train_tree.leaves(cpu)} == {torch.bfloat16}
    card = train_tree.map(lambda x: x.detach().to(DEV).requires_grad_(), cpu)
    wide = train_tree.map(lambda x: x.detach().float().requires_grad_(), cpu)
    batch = TokenPipeline(cfg.vocab_size, 256, 2, seed=1).batch_at(0)
    shape = (2, 256, cfg.num_heads, cfg.head_dim)
    before = launch_counts()
    with capturing_bwd({}, shape) as seen:
        loss, ce, g_card = train_step.make_grad_fn(cfg)(card, batch)
        torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in launch_counts().items()
                if v != before[k]}
    assert seen and seen["q"].dtype == torch.bfloat16, "no bf16 K9-bwd call"
    assert launches == {"flashattn": (1 + cfg.remat) * cfg.num_layers,
                        "flashattn_bwd": cfg.num_layers}, launches
    runs = {"card": (loss, ce, g_card),
            "cpu_bf16": train_step.make_grad_fn(cfg)(cpu, batch),
            "cpu_f32": train_step.make_grad_fn(cfg32)(wide, batch)}
    scalars = {name: {"loss": float(l), "ce": float(c),
                      "grad_norm": float(train_opt.global_norm(g))}
               for name, (l, c, g) in runs.items()}
    tol = FLASH_TOL[torch.bfloat16]
    worst = {}
    for key, want in scalars["cpu_f32"].items():
        floor = FLASH_BWD_FLOOR * abs(scalars["cpu_bf16"][key] - want)
        worst[key] = abs(scalars["card"][key] - want) / (tol * abs(want)
                                                          + floor)
    worst["grads"], leaves = 0.0, []
    for gk, gb, gw in zip(*(train_tree.leaves(runs[n][2])
                            for n in ("card", "cpu_bf16", "cpu_f32"))):
        err = (gk.float().cpu() - gw).abs().max().item()
        floor = FLASH_BWD_FLOOR * (gb.float() - gw).abs().max().item()
        bound = tol * gw.abs().max().item() + floor
        leaves.append({"shape": list(gw.shape), "max_abs_err": err,
                       "max_abs_f32": gw.abs().max().item(),
                       "floor": floor})
        worst["grads"] = max(worst["grads"], err / bound)
        assert torch.isfinite(gk).all()
    assert max(worst.values()) <= 1.0, (worst, leaves)
    return {"config": f"reduced_config({TRAIN_BIG}, head_dim=128), bf16, "
                      f"batch 2 x 256 tokens, flash_block {cfg.flash_block}",
            "against": "the same step on the CPU in f32 on the bf16 "
                       "weights widened",
            "tolerance": f"3e-2 * max|f32| + {FLASH_BWD_FLOOR} x "
                         f"max|cpu bf16 - cpu f32|",
            "scalars": scalars, "worst_err_over_tolerance": worst,
            "leaves": leaves, "launches": launches}


def phase_train_path() -> dict:
    """The training path on the card: the repro-100m CLI with checkpoints
    and a resume, one step's launches, qwen3-4b at full width for three
    steps, deepseek-v3-671b at its published widths on its 3 dense-prefix
    layers for three, and reduced steps on the card against the CPU.
    Launch counts are set to 0 before the phase and read after it."""
    gc.collect()
    torch.cuda.empty_cache()
    allocated_at_start = torch.cuda.memory_allocated()
    reset_launch_counts()
    captured: dict = {"small": {}, "big": {}, "mla": {}}
    ckpt_dir = tempfile.mkdtemp(prefix="train_", dir=os.path.join(ROOT,
                                                                "build"))
    try:
        cli = train_cli_runs(ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir)
    one = one_step_launches(captured["small"])
    big = big_model_steps(captured["big"], get_config(TRAIN_BIG),
                          4_022_468_096)
    assert big["num_layers"] == 36
    mla = big_model_steps(captured["mla"], dataclasses.replace(
        get_config(MLA_ARCH), num_layers=MLA_TRAIN_LAYERS),
        MLA_TRAIN_PARAMS, profile=False)
    cmp = card_vs_cpu_step()
    cmp_moe = card_vs_cpu_step(MOE_ARCH)
    cmp_bf16 = card_vs_cpu_bf16_step()
    out = {"allocated_bytes_at_start": allocated_at_start, "cli": cli,
           "one_step": one, "big": big, "mla": mla, "card_vs_cpu": cmp,
           "card_vs_cpu_moe": cmp_moe, "card_vs_cpu_bf16": cmp_bf16}
    emit("train_path", **out)
    return {**out, "captured": captured}


# -- phase 7e -----------------------------------------------------------------------

HYBRID_TOL = 1e-4
HYBRID_PROMPT = 64
# deepseek-v3's MLA head dims at the reduced width: K9 at (192, 128)
HYBRID_MLA = MLAConfig(q_lora_rank=32, kv_lora_rank=32, qk_nope_dim=128,
                       qk_rope_dim=64, v_dim=128)


def serve_card_vs_cpu(arch: str, **overrides) -> dict:
    """Reduced ``arch`` (f32, head dim 64 so that K9 takes its attention
    layers, flash block 32; ``overrides`` on top) from one set of weights
    on the card and on the CPU: a 64-token prefill (K9 on the card) with
    seeded image embeddings for a VLM, then one decode step at position 64
    from each side's own caches.  The last prefill logits, every prefill
    cache leaf and the decode logits within ``HYBRID_TOL`` of the CPU's
    largest entry plus ``TRAIN_FLOOR_TIMES`` times how far the CPU's own
    run moves when every weight moves one ulp (``ulp_shifted``)."""
    cfg = reduced_config(get_config(arch), head_dim=64, **overrides)
    cpu = open_gates(transformer.Model(cfg).init(0, device="cpu"), 1)
    shifted = ulp_shifted({"params": cpu, "opt": {}})["params"]
    card = train_tree.map(lambda x: x.to(DEV, copy=True), cpu)
    rng = np.random.default_rng(3)
    T = HYBRID_PROMPT
    x = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, T + 1)))
    img = (torch.from_numpy(rng.normal(size=(2, cfg.num_image_tokens,
                                             cfg.d_model)).astype(np.float32))
           if cfg.num_image_tokens else None)

    def run(params, dev):
        last, caches = make_prefill_step(cfg)(
            params, x[:, :T].to(dev), None if img is None else img.to(dev))
        grown = transformer.init_cache(cfg, 2, T + 1, device=dev)
        for i in range(2):
            splice(cfg, grown, i, [{s: {k: v[:, i:i + 1] for k, v in c.items()}
                                    for s, c in seg.items()}
                                   for seg in caches], T)
        logits, _ = make_decode_step(cfg)(params, grown, x[:, T:].to(dev),
                                          torch.full((2,), T, device=dev))
        return [last.cpu(), *[c.cpu() for c in leaves(caches)], logits.cpu()]

    before = launch_counts()
    got = run(card, DEV)
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in launch_counts().items()
                if v != before[k]}
    n_attn = cfg.pattern_layers().count("A")
    assert launches == {"flashattn": n_attn}, launches
    want, moved = run(cpu, "cpu"), run(shifted, "cpu")
    worst, names = 0.0, ["prefill_last_logits"] + [
        f"cache_{i}" for i in range(len(want) - 2)] + ["decode_logits"]
    report = {}
    for name, g, w, m in zip(names, got, want, moved):
        floor = TRAIN_FLOOR_TIMES * (m - w).abs().max().item()
        bound = HYBRID_TOL * w.abs().max().item() + floor
        err = (g - w).abs().max().item()
        assert torch.isfinite(g).all()
        report[name] = {"max_abs_err": err, "bound": bound, "floor": floor}
        worst = max(worst, err / bound)
    assert worst <= 1.0, report
    return {"config": f"reduced_config({arch}, head_dim=64"
                      + "".join(f", {k}={v}" for k, v in overrides.items())
                      + f"), f32, prompt {T} tokens x 2, flash_block "
                      f"{cfg.flash_block}",
            "launches": launches, "worst_err_over_tolerance": worst,
            "prefill_and_decode": {k: report[k] for k in (
                "prefill_last_logits", "decode_logits")},
            "cache_leaves_worst_err_over_tolerance": max(
                v["max_abs_err"] / v["bound"] for k, v in report.items()
                if k.startswith("cache_"))}


def phase_hybrid_card_vs_cpu() -> dict:
    """Reduced jamba-1.5-large-398b ('M', 'A' and MoE slots) and reduced
    llama-3.2-vision-11b ('A' and gated 'X' slots), each at head dim 64,
    card against CPU: prefill logits, caches and a decode step
    (``serve_card_vs_cpu``), and one training step's loss, gradients,
    updated parameters and moments (``card_vs_cpu_step``, with the floor
    of ``cpu_floors``).  jamba is served on the card only reduced: one
    period of its layer pattern is 8 layers, 90.49 GB in bf16 at its
    published widths, more than the card holds.  Then reduced
    deepseek-v3-671b (a dense and an MoE layer) with its published MLA
    head dims (``HYBRID_MLA``: K9 does not take the reduced config's
    16 + 8 / 16), the same way: prefill, caches, a decode step and a
    training step (K9 and K9-bwd f32 at (192, 128) in both layers), whose
    first K9-bwd call's inputs are kept for phase ``kernels``."""
    out = {}
    for arch in HYBRID_ARCHS:
        out[arch] = {"serve": serve_card_vs_cpu(arch),
                     "train": card_vs_cpu_step(arch)}
    cfg = reduced_config(get_config(MLA_ARCH), head_dim=64, mla=HYBRID_MLA)
    captured: dict = {}
    with capturing_bwd(captured, (4, 64, cfg.num_heads, MLA_HEAD_DIMS[0])):
        train = card_vs_cpu_step(MLA_ARCH, mla=HYBRID_MLA)
    assert captured and captured["q"].dtype == torch.float32, captured.keys()
    out[MLA_ARCH] = {"serve": serve_card_vs_cpu(MLA_ARCH, mla=HYBRID_MLA),
                     "train": train}
    emit("hybrid_card_vs_cpu", **out)
    return {**out, "captured": captured}


# -- phase 7g -----------------------------------------------------------------------

DRYRUN_PRODUCTION = (("qwen3-4b", "train_4k"), ("deepseek-v3-671b",
                                                "decode_32k"),
                     ("mamba2-1.3b", "long_500k"))
DRYRUN_CELLS, DRYRUN_SKIPS = 32, 8          # applicable cells a mesh, skips
AUTOSHARD_CELL = ("qwen3-4b", "decode_32k", "single")
AUTOSHARD_EVALS, AUTOSHARD_MAX_S = 4, 60.0


def allocation_free(label: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, held to allocate nothing on the card: the
    peak of allocated bytes over the call and the bytes after it equal
    those before it.  Garbage left by earlier phases is collected first,
    so that no CUDA tensor of theirs is freed during the call."""
    gc.collect()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn(*args, **kwargs)
    peak, after = torch.cuda.max_memory_allocated(), \
        torch.cuda.memory_allocated()
    assert peak == after == before, (label, before, peak, after)
    return out


def abstract_cells(mesh_kind: str) -> dict:
    """Every (arch, shape) cell built on a production mesh, no trace: each
    applicable cell's per-device argument bytes, and the skips."""
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    built, skips = {}, []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for name, shape in SHAPES.items():
            if not cell_is_applicable(cfg, shape):
                skips.append(f"{arch}|{name}")
                continue
            rules = dryrun.rules_for(cfg, shape)
            with sharding_ctx(mesh, rules):
                _, args, in_sh, _, _ = dryrun.build_cell(cfg, shape, mesh,
                                                         rules)
            built[f"{arch}|{name}"] = dryrun.tree_bytes(args, in_sh)
    assert len(built) == DRYRUN_CELLS and len(skips) == DRYRUN_SKIPS, \
        (mesh_kind, len(built), skips)
    return {"argument_bytes": built, "skipped": skips}


def card_cell(cfg, shape, microbatches=None) -> dict:
    """``cfg`` at ``shape`` traced on a (1, 1) host mesh: per-device is
    the whole cell, and nothing moves between devices."""
    mesh = make_host_mesh((1, 1), ("data", "model"))
    rec = dryrun.analyze_cell(cfg, shape, mesh,
                              dryrun.rules_for(cfg, shape), microbatches)
    assert rec["num_collectives"] == 0 and rec["t_collective"] == 0, rec
    assert rec["flops_per_device"] == rec["flops_total"], rec
    assert rec["hbm_bytes_per_device"] == rec["hbm_bytes_total"], rec
    return rec


def beside_train(label: str, cfg, ran: dict) -> dict:
    """The dry run of one of ``train_path``'s big runs at its shape, held
    to the bytes the card allocated for its state and batch."""
    shape = dataclasses.replace(SHAPES["train_4k"], batch=ran["batch"],
                                seq=ran["seq"])
    rec = allocation_free(label, card_cell, cfg, shape, 1)
    mem = rec["memory"]
    allocated = ran["state_bytes"] + ran["batch_bytes"]
    assert mem["argument_bytes"] == allocated, (label, mem, allocated)
    assert mem["alias_bytes"] == ran["state_bytes"], (label, mem)
    seconds = ran["seconds_per_step_median_2_3"]
    return {"arch": cfg.name, "num_layers": cfg.num_layers,
            "batch": ran["batch"], "seq": ran["seq"], "microbatches": 1,
            "state_dtype": ran["state_dtype"], "memory": mem,
            "card_state_and_batch_bytes": allocated,
            "peak_est_bytes": mem["peak_est_bytes"],
            "peak_device_bytes": ran["peak_device_bytes"],
            "peak_est_over_device": mem["peak_est_bytes"]
            / ran["peak_device_bytes"],
            "flops": rec["flops_per_device"],
            "num_collectives": rec["num_collectives"],
            "seconds_per_step_median_2_3": seconds,
            "achieved_tflops": rec["flops_per_device"] / seconds / 1e12,
            "peak_tflops": dryrun.PEAK_FLOPS / 1e12,
            "hbm_bytes": rec["hbm_bytes_per_device"],
            "dominant": rec["dominant"], "trace_s": rec["lower_s"]}


def phase_dryrun_path(train: dict, served: dict, smi: str) -> dict:
    """The dry run beside the card's own runs (see the module docstring,
    7g)."""
    t0 = time.perf_counter()
    built = {mk: allocation_free(f"build {mk}", abstract_cells, mk)
             for mk in ("single", "multi")}
    build_s = time.perf_counter() - t0

    trained = {
        "qwen3-4b": beside_train("qwen3-4b train", get_config(TRAIN_BIG),
                                 train["big"]),
        MLA_ARCH: beside_train(f"{MLA_ARCH} train", dataclasses.replace(
            get_config(MLA_ARCH), num_layers=MLA_TRAIN_LAYERS), train["mla"])}
    shape = dataclasses.replace(SHAPES["decode_32k"], batch=SERVE_SLOTS,
                                seq=SERVE_CAPACITY)
    rec = allocation_free("qwen3-4b decode", card_cell,
                          get_config(SERVE_ARCH), shape)
    mem = rec["memory"]
    allocated = served["param_bytes"] + served["cache_bytes"] \
        + served["decode_input_bytes"]
    assert mem["argument_bytes"] == allocated, (mem, allocated)
    assert mem["alias_bytes"] == served["cache_bytes"], mem
    decoded = {"arch": SERVE_ARCH, "slots": SERVE_SLOTS,
               "capacity": SERVE_CAPACITY, "memory": mem,
               "card_param_cache_and_input_bytes": allocated,
               "serve_path_peak_device_bytes": served["peak_device_bytes"],
               "flops": rec["flops_per_device"],
               "num_collectives": rec["num_collectives"],
               "hbm_bytes": rec["hbm_bytes_per_device"],
               "t_memory_ms": rec["t_memory"] * 1e3,
               "decode_step_ms_median_graphed":
               served["decode_step_ms_median"],
               "dominant": rec["dominant"], "trace_s": rec["lower_s"]}

    production = []
    for arch, name in DRYRUN_PRODUCTION:
        r = allocation_free(f"{arch} {name}", dryrun.run_cell, arch, name,
                            "single", save=False)
        assert r["num_collectives"] > 0 and r["t_collective"] > 0, r
        production.append({k: r[k] for k in (
            "arch", "shape", "mesh", "chips", "memory", "flops_per_device",
            "flops_total", "hbm_bytes_per_device", "t_compute", "t_memory",
            "collective_traffic_per_device", "num_collectives",
            "t_collective", "dominant", "fallback_gathers",
            "useful_flops_ratio", "lower_s")})
    searched = allocation_free("autoshard", layout_search)
    assert searched["seconds"] < AUTOSHARD_MAX_S, searched
    out = {"card": smi, "build_s": build_s, "abstract_cells": built,
           "card_cells": {"train": trained, "decode": decoded},
           "production_single": production,
           "autoshard_seconds": searched["seconds"],
           "seconds": time.perf_counter() - t0}
    emit("dryrun_path", **out)
    return out


def layout_search() -> dict:
    """``circulant_autoshard`` on ``AUTOSHARD_CELL`` with a budget of
    ``AUTOSHARD_EVALS`` evaluations in one round, its records cached in a
    temporary directory: prints its history and best record."""
    arch, shape, mesh_kind = AUTOSHARD_CELL
    saved = autoshard.CACHE_DIR
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        autoshard.CACHE_DIR = pathlib.Path(tmp)
        try:
            assign, best, history = autoshard.circulant_autoshard(
                arch, shape, mesh_kind, budget_evals=AUTOSHARD_EVALS,
                max_rounds=1, log=lambda *a: None)
        finally:
            autoshard.CACHE_DIR = saved
    seconds = time.perf_counter() - t0
    assert len(history) == AUTOSHARD_EVALS, history

    def plain(a):
        return {k: list(v) if isinstance(v, tuple) else v
                for k, v in a.items()}
    emit("dryrun_autoshard", cell=list(AUTOSHARD_CELL),
         history=[[plain(a), c] for a, c in history],
         best_assignment=plain(assign),
         best={k: best[k] for k in (
             "t_compute", "t_memory", "t_collective", "dominant",
             "num_collectives", "collective_traffic_per_device",
             "useful_flops_ratio", "lower_s")},
         seconds=seconds)
    return {"seconds": seconds, "history": history}


# -- phase 7j -----------------------------------------------------------------------

EP_ARCH = "dbrx-132b"
EP_MESHES = (((2, 4), "full"), ((3, 2), "ff"))
EP_BATCH = (6, 512)                  # 3072 tokens: 2 and 3 divide 6
EP_BF16_TOL = 3e-2                   # tests/test_torch_moe.py's BF16_TOL
EP_REPS = 3
RESHARD_ARCH, RESHARD_LAYERS = "qwen3-4b", 2
RESHARD_MESHES = ((4, 2), (2, 4))


def ep_layer(cfg, gen) -> tuple:
    """One MoE layer of ``cfg`` at its published widths, bf16 on the card
    from ``gen``: the router (std 0.02, as its spec), wi and wg (std
    1/sqrt(d)) and wo (std 1/sqrt(d_expert)); x (6, 512, d) standard
    normal."""
    e, d = cfg.moe, cfg.d_model
    E, f = e.num_experts, e.d_expert

    def rnd(shape, std):
        return torch.randn(shape, generator=gen, device=DEV,
                           dtype=torch.bfloat16) * std
    p = {"router": rnd((d, E), 0.02), "wi": rnd((E, d, f), d ** -0.5),
         "wg": rnd((E, d, f), d ** -0.5), "wo": rnd((E, f, d), f ** -0.5)}
    return p, rnd((*EP_BATCH, d), 1.0)


def ep_path_run(p, x, cfg, mesh) -> dict:
    """``moe_apply`` under ``mesh`` (the einsum path without one): output,
    drops, which path ran, ms by CUDA events over ``EP_REPS`` calls after
    one, and the peak bytes the call allocates beyond what is live
    before it (the weights and x)."""
    taken = []
    real = moe_mod.moe_apply_ep

    def recording(*args):
        taken.append(moe_mod._ep_specs(mesh, cfg, x.shape[1], x.shape[0]))
        return real(*args)

    ctx = sharding_ctx(mesh) if mesh is not None else contextlib.nullcontext()
    moe_mod.moe_apply_ep = recording
    try:
        with ctx:
            gc.collect()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            y, aux = moe_mod.moe_apply(p, x, cfg)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - before
            calls = len(taken)
            ms = timed_ms(lambda: moe_mod.moe_apply(p, x, cfg), EP_REPS)
    finally:
        moe_mod.moe_apply_ep = real
    r = moe_mod.routing(p, x, cfg) if mesh is None else \
        moe_mod.ep_routing(p, x, cfg, mesh)
    drops, C = int((~r.keep).sum()), r.C
    return {"y": y, "aux": float(aux), "ep_calls": calls,
            "ep_specs": dict(zip(("tokens", "weights", "exchange_axes",
                                  "ffn_split"), taken[0])) if taken else None,
            "drops": drops, "capacity": C, "ms": ms,
            "peak_beyond_live_bytes": peak}


def ep_exchange_bytes(cfg, mesh, C: int, variant: str) -> int:
    """Bytes the exchanges write, computed from the shapes
    ``moe_apply_ep`` materialises (not measured): the dispatch and the return each one (G, E, C, d)
    buffer; "ff" besides gathers the tokens over data (one more), writes
    each data slot's partial outputs (data more) and takes each slot's
    own rows back (one more)."""
    G = math.prod(mesh.axis_sizes)
    one = G * cfg.moe.num_experts * C * cfg.d_model * 2
    return one * (2 if variant == "full" else 3 + mesh.shape["data"])


def ep_weights_are_views(p, cfg, mesh) -> bool:
    """The experts' weights as ``moe_apply_ep`` reads them lie in the
    stacked leaves' own storage."""
    _, _, ep_axes, wshard = moe_mod._ep_specs(mesh, cfg, EP_BATCH[1],
                                              EP_BATCH[0])
    views = moe_mod.owner_weights(p, mesh, ep_axes, wshard)
    return all(v.untyped_storage().data_ptr()
               == p[k].untyped_storage().data_ptr()
               and v.data_ptr() == p[k].data_ptr()
               for k, v in zip(("wi", "wg", "wo"), views))


def ep_on_slot_meshes() -> dict:
    """dbrx-132b's MoE layer at its published widths through the einsum
    path and through expert parallelism on each of ``EP_MESHES``, slot
    meshes on this card: at capacity factor E / top_k, where no pair can
    drop on either path, EP's output against the einsum path's within
    ``EP_BF16_TOL`` (relative, and of the largest); at the published
    factor the drops of each path, not compared."""
    cfg = get_config(EP_ARCH)
    e = cfg.moe
    p, x = ep_layer(cfg, torch.Generator(device=DEV).manual_seed(0))
    weight_bytes = sum(p[k].numel() * 2 for k in ("wi", "wg", "wo"))
    no_drop = dataclasses.replace(cfg, moe=dataclasses.replace(
        e, capacity_factor=e.num_experts / e.top_k))
    out = {"arch": EP_ARCH, "d_model": cfg.d_model,
           "num_experts": e.num_experts, "top_k": e.top_k,
           "d_expert": e.d_expert, "tokens": math.prod(EP_BATCH),
           "batch": list(EP_BATCH), "dtype": "bfloat16",
           "expert_weight_bytes": weight_bytes, "factors": {}}
    for label, c in (("no_drop", no_drop), ("published", cfg)):
        ref = ep_path_run(p, x, c, None)
        assert ref["ep_calls"] == 0, ref
        runs = {"einsum": {k: v for k, v in ref.items() if k != "y"}}
        for shape, variant in EP_MESHES:
            mesh = make_host_mesh(shape, ("data", "model"), device=DEV)
            got = ep_path_run(p, x, c, mesh)
            assert got["ep_calls"] == 1, (shape, got["ep_calls"])
            specs = moe_mod._ep_specs(mesh, c, EP_BATCH[1], EP_BATCH[0])
            assert (specs[2] == ("data", "model")) == (variant == "full") \
                and (specs[3] == "ff") == (variant == "ff"), (shape, specs)
            assert ep_weights_are_views(p, c, mesh), shape
            row = {k: v for k, v in got.items() if k != "y"}
            row.update(variant=variant, weights_are_views=True,
                       exchange_bytes_from_shapes=ep_exchange_bytes(
                           c, mesh, got["capacity"], variant))
            if label == "no_drop":
                assert ref["drops"] == got["drops"] == 0, (shape, ref, got)
                diff = (got["y"].float() - ref["y"].float()).abs()
                big = ref["y"].float().abs()
                over = int((diff > EP_BF16_TOL * big
                            + EP_BF16_TOL * big.max()).sum())
                assert over == 0, (shape, over, float(diff.max()))
                assert abs(got["aux"] - ref["aux"]) <= EP_BF16_TOL, \
                    (shape, got["aux"], ref["aux"])
                row.update(max_abs_diff_vs_einsum=float(diff.max()),
                           max_abs_einsum=float(big.max()),
                           cells_over_tolerance=over)
            runs[f"{shape[0]}x{shape[1]}"] = row
            del got
        out["factors"][label] = {"capacity_factor": c.moe.capacity_factor,
                                 "paths": runs}
        del ref
    del p, x
    torch.cuda.empty_cache()
    return out


def reshard_on_slot_meshes() -> dict:
    """qwen3-4b at its published widths, ``RESHARD_LAYERS`` layers:
    ``init_state`` on the card, ``checkpoint.save``, then
    ``elastic_reshard`` onto each of ``RESHARD_MESHES``; every shard equal
    to its slice of the state saved, and the shards of each leaf views of
    one tensor."""
    cfg = dataclasses.replace(get_config(RESHARD_ARCH),
                              num_layers=RESHARD_LAYERS)
    state = train_step.init_state(cfg, train_opt.OptConfig(), 0, device=DEV)
    leaves = train_tree.leaves(state)
    state_bytes = sum(x.numel() * x.element_size() for x in leaves)
    directory = tempfile.mkdtemp(prefix="reshard_",
                                 dir=os.path.join(ROOT, "build"))
    out = {"arch": RESHARD_ARCH, "num_layers": RESHARD_LAYERS,
           "published_layers": get_config(RESHARD_ARCH).num_layers,
           "reduced": f"depth {RESHARD_LAYERS} of "
                      f"{get_config(RESHARD_ARCH).num_layers} layers",
           "leaves": len(leaves), "state_bytes": state_bytes,
           "restores": {}}
    try:
        t = time.perf_counter()
        train_ckpt.save(directory, 1, state)
        out["save_s"] = time.perf_counter() - t
        axes = train_step.state_axes(cfg)
        for shape in RESHARD_MESHES:
            mesh = make_host_mesh(shape, ("data", "model"), device=DEV)
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = train_ft.elastic_reshard(directory, 1, state, axes, mesh)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t
            split = 0
            for leaf, want in zip(train_tree.leaves(got), leaves):
                assert isinstance(leaf, ShardedTensor) and \
                    len(leaf.shards) == mesh.size
                assert leaf.dtype == want.dtype, (leaf.dtype, want.dtype)
                base = leaf.shards[0].untyped_storage().data_ptr()
                split += any(e is not None for e in leaf.spec)
                for slot, shard in enumerate(leaf.shards):
                    assert shard.untyped_storage().data_ptr() == base
                    assert shard.device == want.device
                    assert torch.equal(shard, want.detach()[shard_slices(
                        tuple(want.shape), leaf.spec, mesh, slot)]), slot
            assert split > 0, shape
            out["restores"][f"{shape[0]}x{shape[1]}"] = {
                "seconds": seconds, "leaves_split": split,
                "shards_equal_to_saved": True, "shards_views_of_one": True}
            del got
    finally:
        shutil.rmtree(directory)
    del state, leaves
    torch.cuda.empty_cache()
    return out


def phase_lm_mesh_path() -> dict:
    """The LM side of the mesh on slot meshes of this card (see the module
    docstring, 7j)."""
    t0 = time.perf_counter()
    out = {"ep": ep_on_slot_meshes(), "reshard": reshard_on_slot_meshes()}
    out["seconds"] = time.perf_counter() - t0
    emit("lm_mesh_path", **out)
    return out


# -- phase 8 ------------------------------------------------------------------------

def tri_rows(entry, b, b_keep, rng, eye, local):
    """K4, one row per route, at the shapes its joins take, and its keep
    form on its one route.  Path: chain(5)'s mix (0,1)+(1,2) at n = 8192,
    an O(n^2) function: Σ_y a[y] b[y] − Σ_{x≠y} F1[x,y] F2[y,x] with
    a[y] = Σ_{x≠y} F1[x,y], b[y] = Σ_{z≠y} F2[y,z] — one read of both
    factors, its bound; the yardstick computes it so in f64 torch calls.
    Triangle: the cycles' mix, a third pair factor on (0,2): Σ_{x≠z}
    F3[x,z] (F1′F2′)[x,z], F1′ and F2′ without their diagonals: 2 n^3
    operations at the f64 tensor-core rate; the yardstick is the f64
    matmul form.  Dense: a full 3-D factor beside a pair factor on (0,2)
    at n = 512 — anchored |cut| = 3 joins are built with every factor over
    the whole cut, and the keep form takes this route on every mix — bound
    by the bytes of the 3-D factor; the yardstick multiplies the broadcast
    product by a precomputed 0/1 off-diagonal mask in f64."""
    replaces = "src/repro/kernels/matreduce.py:346"
    chain_axes, tri_axes = [(0, 1), (1, 2)], [(0, 1), (1, 2), (0, 2)]
    ptxas = ptxas_counts(kbuild.build_logs.get("trijoin", ""),
                         _trijoin_label)

    fs3 = [int_factor(rng, (N, N), max_value(2, b, N ** 3))
           for _ in range(2)]
    F1, F2 = fs3
    a = F1.sum(0) - F1.diagonal()
    bb = F2.sum(1) - F2.diagonal()
    G1 = F1.masked_fill(eye, 0)
    entry("trijoin_path", "trijoin_path", replaces, b,
          lambda: mr.tri_reduce(fs3, chain_axes, n=N, block=b),
          lambda: mr._tri_path_plain(fs3, chain_axes, (N, N, N), True,
                                     None).sum(),
          lambda: torch.dot(a, bb) - (G1 * F2.T).sum(), 20, 2 * N * N * 8,
          4 * N * N, source=TRIJOIN_SOURCE, join_route="path",
          factors="(0,1)+(1,2)",
          ptxas=[e for e in ptxas if e["kernel"].startswith("path")],
          yardstick="a.b - sum_{x!=y} F1[x,y] F2[y,x], f64 torch calls")
    del fs3, G1

    fs4 = [int_factor(rng, (N, N), max_value(3, b, N ** 3))
           for _ in range(3)]
    P1, P2, P3 = (F.masked_fill(eye, 0) for F in fs4)
    entry("trijoin_triangle", "trijoin_triangle", replaces, b,
          lambda: mr.tri_reduce(fs4, tri_axes, n=N, block=b),
          lambda: mr._tri_triangle_plain(fs4, tri_axes, (N, N, N), True,
                                         None).sum(),
          lambda: ((P1 @ P2) * P3).sum(), 3, 3 * N * N * 8, 2 * N ** 3,
          source=TRIJOIN_SOURCE, peak_ops=PEAK_F64_TC_OPS_PER_S,
          join_route="triangle", factors="(0,1)+(1,2)+(0,2)",
          ptxas=[e for e in ptxas if e["kernel"].startswith("tri")],
          yardstick="((F1' @ F2') * F3').sum(), ' = off-diagonal, f64",
          **tri_split(N), **tri_sass())
    del fs4, P1, P2, P3

    n5 = 512
    dense_axes = [(0, 1, 2), (0, 2)]
    i = torch.arange(n5, device=DEV)
    off3 = ((i[:, None, None] != i[None, :, None])
            & (i[:, None, None] != i[None, None, :])
            & (i[None, :, None] != i[None, None, :])).double()
    cj_slab = [e for e in ptxas_counts(kbuild.build_logs.get("cutjoin", ""),
                                       _cutjoin_label)
               if e["kernel"].startswith("slab_kernel<")]
    for keep, block in ((None, b), (0, b_keep), (1, b_keep), (2, b_keep)):
        hi = max_value(2, block, n5 ** 3)
        F3d = int_factor(rng, (n5,) * 3, hi)
        F02 = int_factor(rng, (n5, n5), hi)
        fsd = [F3d, F02]
        if keep is None:
            run = lambda: mr.tri_reduce(fsd, dense_axes, n=n5, block=block)
            plain = lambda: mr.tri_reduce_plain(fsd, dense_axes, n=n5,
                                                block=block)
            library = lambda: (F3d * F02[:, None, :] * off3).sum()
            name, kw = "cutjoin_tri", {}
            entry(name, "trijoin_dense", replaces, block, run, plain,
                  library, 20, (n5 ** 3 + n5 * n5) * 8, 2 * n5 ** 3,
                  join_route="dense", factors="(0,1,2)+(0,2)", n=n5,
                  yardstick="(F012 * F02[:, None, :] * offdiag).sum(), f64")
            del F3d, F02, fsd
            continue
        red = tuple(a for a in range(3) if a != keep)
        run = lambda: mr.tri_reduce_keep(fsd, dense_axes, keep=keep, n=n5,
                                         block=block)
        plain = lambda: mr.tri_reduce_keep_plain(fsd, dense_axes, keep=keep,
                                                 n=n5, block=block)
        library = lambda: (F3d * F02[:, None, :] * off3).sum(red)
        kind = mr.tri_keep_entry(fsd, dense_axes, keep)
        if kind != ("template" if keep == 2 else "slab"):
            raise AssertionError(f"keep={keep} took the {kind} entry")
        kw = {"entry": kind}
        if kind == "slab":
            u, v = mr._slab_axes(fsd, dense_axes, keep)
            per_cell = sum(u in ax and v in ax for ax in dense_axes)
            kw["ptxas"] = [e for e in cj_slab if e["kernel"] ==
                           f"slab_kernel<{per_cell}, mask, v2>"]
            kw["ptxas_every_slab_instance"] = cj_slab
            # the strided template on the same factors, as before the
            # slab entry existed
            real = mr.tri_keep_entry
            mr.tri_keep_entry = lambda *a, **k: "template"
            try:
                kw["ms_template"] = timed_ms(run, 10)
            finally:
                mr.tri_keep_entry = real
        name = {"slab": "cutjoin_tri_keep_slab",
                "template": "cutjoin_tri_keep"}[kind]
        entry(name, name, replaces, block, run, plain, library, 20,
              (n5 ** 3 + n5 * n5) * 8, 2 * n5 ** 3, path=local,
              join_route="dense", keep=keep, factors="(0,1,2)+(0,2)", n=n5,
              yardstick=f"(F012 * F02[:, None, :] * offdiag).sum({red}), "
                        f"f64", **kw)
        del F3d, F02, fsd
    del off3


def phase_kernels(main: dict, local: dict, graph_ops: dict, mined: dict,
                  served: dict, mesh: dict, trained: dict, hybrid: dict):
    """Every kernel at the shapes its path gave it (two factors each, as
    the joins carry; chunk = what the guard granted there, 128 where no
    graph reached the tier).  ``bound_ms`` is for the function that is
    timed, computed the cheapest way known for this run's data, not for
    the way the kernel computes it."""
    rng = np.random.default_rng(1)
    granted = {j["cut"]: j["block"] for j in main["joins"]
               if j["route"] == "kernel"}
    granted_keep = {j["cut"]: j["block"] for j in local["joins"]
                    if j["route"] == "kernel-keep"}
    out = []

    def entry(name, kernel, replaces, block, run, plain, library, reps,
              nbytes, nops, path=main, source=CUTJOIN_SOURCE,
              peak_ops=PEAK_F32_OPS_PER_S, **more):
        got = run()
        want = plain()
        err = max_abs_diff(got, want)
        if err != 0:
            raise AssertionError(f"{name}: kernel and plain version differ "
                                 f"by {err!r}")
        ms = timed_ms(run, reps)
        plain_ms = timed_ms(plain, 1)
        library_ms = None
        if library is not None:
            if max_abs_diff(library(), got) != 0:
                raise AssertionError(f"{name}: yardstick differs from the "
                                     f"kernel")
            if isinstance(got, float):
                # the call ends in .item() (a host sync): so does the
                # yardstick's, like with like
                timed_library = lambda: library().item()  # noqa: E731
            else:
                timed_library = library
            library_ms = timed_ms(timed_library, reps)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = nops / peak_ops * 1e3
        by_graph = {f"launches_{role.replace('-', '_')}_graph": n[kernel]
                    for role, n in path["by_role"].items()}
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces,
                    "launches": path["launches"][kernel], **by_graph,
                    "launches_mesh_path": mesh["launches"].get(kernel, 0),
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": library_ms, "block": block,
                    "bytes": nbytes, "operations": nops, **more})

    cj_ptxas = ptxas_counts(kbuild.build_logs.get("cutjoin", ""),
                            _cutjoin_label)

    def ptxas_of(kernel: str, f64: bool):
        """ptxas's counts for the instances of ``kernel`` this row runs
        (two factors, f32 or f64), and the instance of ``kernel`` with
        the most spill bytes, then registers."""
        tag = "f64" if f64 else "f32"
        mine = [e for e in cj_ptxas if e["kernel"].startswith(kernel + "<2,")
                and f", {tag}," in e["kernel"]]
        every = [e for e in cj_ptxas if e["kernel"].startswith(kernel + "<")]
        worst = max(every, default=None, key=lambda e: (
            e.get("spill_store_bytes", 0), e.get("registers_at_entry", 0)))
        return {"ptxas": mine, "ptxas_worst_instance": worst}

    # K1: Σ_x F1[x] F2[x], the call (ending in .item()) against
    # torch.dot(...).item(); beside it the device-tensor entry against bare
    # torch.dot, and the launch alone (the ctypes call, CUDA events around
    # it, no wrapper)
    b = granted.get(1, 128)
    fs = [int_factor(rng, (N,), max_value(2, b)) for _ in range(2)]
    fs64 = [int_factor(rng, (N,), F64_HI) for _ in range(2)]
    for kernel, f64, fv, blk in (("cutjoin_vec", False, fs, b),
                                 ("cutjoin_vec_f64", True, fs64, 1)):
        stream = torch.cuda.current_stream().cuda_stream
        scratch, slot, _ = mr._vec_scratch(fv[0].device, stream)
        table = mr._TABLES[2](*[F.data_ptr() for F in fv], 1, 0, 1, 0)
        launch1 = lambda: mr._lib().cutjoin_vec(  # noqa: E731
            table, 2, N, blk, int(f64), scratch, slot, stream)
        extra = {}
        if f64:
            extra["int64_join"] = (fv[0].long() * fv[1].long()).sum().item()
            if mr.prod_reduce(fv, f64=True) != extra["int64_join"]:
                raise AssertionError("cutjoin_vec_f64 differs from the "
                                     "int64 join")
        entry(kernel, kernel, "src/repro/kernels/matreduce.py:195", blk,
              lambda: mr.prod_reduce(fv, block=blk, f64=f64),
              (lambda: mr.prod_reduce_f64_plain(fv)) if f64
              else (lambda: mr.prod_reduce_plain(fv, block=blk)),
              lambda: torch.dot(fv[0], fv[1]), 200, 2 * N * 8 + 8, 2 * N,
              arithmetic="f64" if f64 else "f32",
              ms_tiles=timed_ms(lambda: mr.prod_reduce_tiles(
                  fv, block=blk, f64=f64), 200),
              ms_launch=timed_ms(launch1, 200),
              library_ms_tiles=timed_ms(lambda: torch.dot(fv[0], fv[1]),
                                        200),
              **ptxas_of("vec_kernel", f64), **extra,
              timed="ms: prod_reduce (one launch + .item()); ms_tiles: "
                    "prod_reduce_tiles (device tensor); ms_launch: the "
                    "ctypes launch alone",
              yardstick="library_ms: torch.dot(F1, F2).item(); "
                        "library_ms_tiles: torch.dot(F1, F2)")
    del fs, fs64
    # K2: Σ_{x≠y} F1[x,y] F2[x,y]
    b = granted.get(2, 128)
    fs2 = [int_factor(rng, (N, N), max_value(2, b)) for _ in range(2)]
    eye = torch.eye(N, dtype=torch.bool, device=DEV)
    entry("cutjoin_pair", "pairjoin", "src/repro/kernels/matreduce.py:180",
          b, lambda: mr.prod_reduce(fs2, block=b),
          lambda: mr.prod_reduce_plain(fs2, block=b),
          lambda: (fs2[0] * fs2[1]).masked_fill(eye, 0).sum(), 20,
          2 * N * N * 8, 2 * N * N)
    del fs2
    # K3 as the anchored |cut| = 2 reads call it, on row-major factors:
    # keep=0 (most of them) takes the row entry, keep=1 the strided
    # template; out[x] = Σ_{y≠x} F1[x,y] F2[x,y]; one read of both
    # factors.  The keep=0 row also times the strided template that took
    # keep=0 before the row entry existed (partials, then .sum(0)).
    b = granted_keep.get(2, 128)
    fsk = [int_factor(rng, (N, N), max_value(2, b)) for _ in range(2)]
    fsk64 = [int_factor(rng, (N, N), F64_HI) for _ in range(2)]
    for kernel, f64, fv, blk, keep in (
            ("cutjoin_pair_keep_rows", False, fsk, b, 0),
            ("cutjoin_pair_keep", False, fsk, b, 1),
            ("cutjoin_pair_keep_rows_f64", True, fsk64, 1, 0),
            ("cutjoin_pair_keep_f64", True, fsk64, 1, 1)):
        assert (mr.keep_entry(fv[0], keep) == "rows") == ("rows" in kernel)
        extra = {}
        if keep == 0:
            extra["ms_keep1"] = timed_ms(lambda: mr.prod_reduce_keep(
                fv, keep=1, block=blk, f64=f64), 20)
            extra.update(ptxas_of("keep_rows_kernel", f64))
        if kernel == "cutjoin_pair_keep_rows":
            extra["ms_old_template"] = timed_ms(lambda: mr._launch(
                "pairjoin_keep", [(F, (2, 1)) for F in fv], (1, N, N), True,
                (0, 0, 0), blk).sum(0), 20)
        if f64:
            want = (fv[0].long() * fv[1].long()).masked_fill(eye, 0) \
                .sum(1 - keep)
            if not torch.equal(mr.prod_reduce_keep(fv, keep=keep, f64=True),
                               want.double()):
                raise AssertionError(f"{kernel} differs from the int64 join")
            extra["int64_join"] = "equal"
        entry(kernel, kernel, "src/repro/kernels/matreduce.py:231", blk,
              lambda: mr.prod_reduce_keep(fv, keep=keep, block=blk,
                                          f64=f64),
              (lambda: mr.prod_reduce_keep_f64_plain(fv, keep=keep)) if f64
              else (lambda: mr.prod_reduce_keep_plain(fv, keep=keep,
                                                      block=blk)),
              lambda: (fv[0] * fv[1]).masked_fill(eye, 0).sum(1 - keep), 20,
              2 * N * N * 8 + N * 8, 2 * N * N, path=local, keep=keep,
              arithmetic="f64" if f64 else "f32", **extra,
              yardstick=f"(F1*F2).masked_fill(eye, 0).sum({1 - keep}), f64")
    del fsk, fsk64
    tri_rows(entry, granted.get(3, 128), granted_keep.get(3, 128), rng, eye,
             local)
    # K6 as the use_pallas Intersect route and ops.triangle_count call it,
    # on the R-MAT adjacency.  For 0/1 data the products it needs are the
    # 6T nonzero ones, so the bound is the bytes of its inputs — lhs, rhs
    # and mask are one tensor, read once — and of its f64 result; beside
    # it the dense algorithm's 2 n^3 operations at the bf16 tensor-core
    # rate (the route taken) and at the f32 rate.  The yardstick is the
    # product on the tensor cores, then the masked f64 sum, which computes
    # the same function exactly on this data; the f32 product (TF32 off)
    # is timed beside it.  Also beside the row: its three kernels launched
    # alone on the call's own buffers, and the FMA route on random f32.
    A = torch.from_numpy(rmat(13, 24.0, seed=0).dense_adjacency(
        np.float32, pad=False)).to(DEV)
    six_t = mr.matreduce(A, A, A)
    tc_product, tc_yardstick = sddmm_tc_yardstick(A)
    entry("matreduce", "matreduce", "src/repro/kernels/matreduce.py:128",
          None, lambda: mr.matreduce(A, A, A),
          lambda: mr.matreduce_plain(A, A, A),
          lambda: tc_product().sum(dtype=torch.float64), 5,
          distinct_bytes(A, A, A) + 8, 2 * six_t, path=local,
          source=MATREDUCE_SOURCE, value=six_t,
          launches_graph_ops=graph_ops["launches"]["matreduce"],
          launches_mine_path_dense=mined["launches"].get("matreduce", 0),
          **matreduce_row_extras(A),
          yardstick=f"library_ms: ({tc_yardstick}).sum(dtype=float64); "
                    f"library_f32_ms: torch.sum((A @ A) * A, "
                    f"dtype=float64), f32 product, TF32 off")
    # K6's tile list as block-sparse triangles call it on the R-MAT
    # graph's 128 x 128 tiles: the same function, so the same bound (the
    # bytes of the stack, read once, the lists and the result; 2 · 6T
    # products); beside it the tile products the lists name, at the bf16
    # tensor-core rate and at the f32 rate.  No one PyTorch call takes
    # tile lists: library_ms is null, and the dense row's tensor-core
    # yardstick, which counts the same 6T from the dense adjacency, is
    # given beside it.
    bsa = BlockSparseAdjacency(main["rmat"]["g"])
    lists = tile_lists(bsa, GROUP)           # as the path orders them
    stack = bsa.tiles
    if mr.matreduce_tilelist(stack, *lists) != six_t:
        raise AssertionError("the tile list differs from K6 on the dense "
                             "adjacency")
    entry("matreduce_tilelist", "matreduce_tilelist",
          "src/repro/kernels/matreduce.py:128", None,
          lambda: mr.matreduce_tilelist(stack, *lists),
          lambda: mr.matreduce_tilelist_plain(stack, *lists), None, 5,
          distinct_bytes(stack) + sum(x.size for x in lists) * 4 + 8,
          2 * six_t, path=mined, source=MATREDUCE_SOURCE, value=six_t,
          **tilelist_row_extras(stack, lists, tile_lists(bsa), tc_product),
          yardstick="none (no PyTorch call takes tile lists); beside it "
                    "dense_tc_yardstick_ms: the dense row's library call")
    del bsa, stack
    # K7 as graph_ops calls it: mask ⊙ (A @ Aᵀ) on the R-MAT adjacency, f32.
    # For 0/1 data the products it needs are the 6T nonzero ones, so the
    # bound is the bytes of its input — lhs, rhs and mask are one tensor,
    # read once — and of its output; the dense algorithm's bound, 2 n^3
    # operations, is given beside it at the bf16 tensor-core rate (the
    # route taken), also for the occupied tiles alone, and at the f32 rate.
    # The yardstick is the product on the tensor cores, which computes the
    # same function exactly on this data; the f32 product (TF32 off) is
    # timed beside it.  Also beside the row: prep, the tensor-core kernel
    # and the gated FMA kernel launched alone on the call's own buffers,
    # the call on bf16 operands, and the FMA route on random f32 operands.
    tc_library, tc_yardstick = sddmm_tc_yardstick(A)
    entry("sddmm", "sddmm", "src/repro/kernels/sddmm.py:47", None,
          lambda: ksd.sddmm(A, A, A), lambda: ksd.sddmm_plain(A, A, A),
          tc_library, 5, distinct_bytes(A, A, A) + N * N * 4, 2 * six_t,
          path=graph_ops, source=MATREDUCE_SOURCE,
          **sddmm_row_extras(A),
          yardstick=f"library_ms: {tc_yardstick}; library_f32_ms: "
                    f"(A @ A.T) * A, f32 product, TF32 off")
    # K8 as common_neighbors calls it: the packed R-MAT table (8192 x 256
    # words) and its edge list, rows gathered in the kernel (its vector
    # entry: row u held along each run).  The bound is the bytes of the
    # table, the pairs and the counts.  The row's call takes the pairs on
    # the card, so it checks them in the kernel and reads the flag once;
    # beside it the call with the pairs on the host (numpy check, upload
    # without a sync), the launch alone, the host check, and the L2
    # traffic of row reads: the old design read both rows of every edge,
    # the vector entry one row per edge plus row u once per run and chunk.
    # No single PyTorch call counts bits: the yardstick works on the
    # unpacked bool rows.
    g = main["rmat"]["g"]
    Ab = A > 0
    packed = kbs.pack_bitsets(Ab)
    edges = torch.from_numpy(g.edges).to(DEV)
    E, W = edges.shape[0], packed.shape[1]
    counts8 = torch.empty((E,), dtype=torch.int32, device=DEV)
    flag8 = torch.zeros((1,), dtype=torch.int32, device=DEV)
    stream = torch.cuda.current_stream().cuda_stream
    launch8 = lambda: kbs._lib().bitset_edges(  # noqa: E731
        packed.data_ptr(), W, packed.stride(0), packed.shape[0],
        edges.data_ptr(), E, counts8.data_ptr(), flag8.data_ptr(), 1,
        stream)
    u = g.edges[:, 0]
    u_runs = 1 + int(np.count_nonzero(np.diff(u)))
    chunks = -(-E // 8)
    row_bytes = W * 4
    bs_ptxas = ptxas_counts(kbuild.build_logs.get("bitset", ""),
                            _bitset_label)
    entry("bitset_intersect", "bitset_edges",
          "src/repro/kernels/bitset.py:39", None,
          lambda: kbs.bitset_intersect_edges(packed, edges),
          lambda: kbs.bitset_intersect_edges_plain(packed, edges),
          lambda: (Ab[edges[:, 0]] & Ab[edges[:, 1]]).sum(1), 50,
          N * W * 4 + E * 2 * 8 + E * 4, 2 * E * W, path=graph_ops,
          source=BITSET_SOURCE, shape=[N, W, E],
          entry=kbs.edges_entry(packed),
          launches_rows_entry=graph_ops["launches"]["bitset"],
          ms_launch_only=timed_ms(launch8, 50),
          ms_call_host_pairs=timed_ms(
              lambda: kbs.bitset_intersect_edges(packed, g.edges), 50),
          ms_host_check=timed_ms(lambda: kbs.check_pairs_host(g.edges, N),
                                 50),
          u_runs=u_runs, chunks=chunks,
          l2_row_bytes={"two_rows_per_edge": 2 * E * row_bytes,
                        "vec_entry_at_most": (E + u_runs + chunks)
                        * row_bytes},
          ptxas=[c for c in bs_ptxas if "edges" in c["kernel"]],
          yardstick="(Ab[u] & Ab[v]).sum(1) on the unpacked bool rows, "
                    "not a popcount")
    # the packing as common_neighbors calls it: the R-MAT bool adjacency
    # (8192 x 8192 bytes) into 8192 x 256 words.  Bound: the bytes read
    # and written.  No PyTorch call packs bits: no yardstick.
    entry("pack_bitsets", "bitset_pack",
          "src/repro/kernels/bitset.py:53 (pack_bitsets, numpy on the "
          "host, feeding bitset_intersect at :39)", None,
          lambda: kbs.pack_bitsets(Ab), lambda: kbs.pack_bitsets_plain(Ab),
          None, 20, N * N + N * W * 4, 0, path=graph_ops,
          source=BITSET_SOURCE, shape=[N, N],
          ptxas=[c for c in bs_ptxas if "pack" in c["kernel"]],
          yardstick="none (no PyTorch call packs bits)")
    out.extend(flash_rows(served))
    bwd = flash_bwd_rows(trained, hybrid)
    out.extend(bwd)
    # the bf16 tensor cores' f32 sums: K9's mean relative bias against f64
    # on every serving path's layer-0 q, k, v (reported, not held), and
    # K9-bwd bf16's per gradient on its training paths' inputs (held in
    # flash_bwd_row)
    bias = {"k9_bf16": served["k9_path_bias"],
            "k9_bwd_bf16": {f"{r['launches_where']}: {r['head_dims']}":
                            r["check"]["mean_relative_bias"]
                            for r in bwd if r["dtype"] == "bf16"}}
    emit("bf16_sum_bias", **bias, largest_abs=max(
        abs(x) for x in (*bias["k9_bf16"].values(), *(
            g for r in bias["k9_bwd_bf16"].values() for g in r.values()))),
        k9_bwd_bf16_kernel_lse={
            f"{r['launches_where']}: {r['head_dims']}":
            r["check"]["mean_relative_bias_kernel_lse"]
            for r in bwd if r["dtype"] == "bf16"},
        formula="sum((got - f64) * f64) / sum(f64^2); k9_bwd_bf16 against "
                "f64 with lse taken in f64, k9_bwd_bf16_kernel_lse on the "
                "kernel's lse")
    print(json.dumps({"kernels": out}), flush=True)


def distinct_bytes(*tensors) -> int:
    """Bytes of the tensors, each distinct one (by its first address and
    shape) counted once: a function reads an input it is given twice
    once."""
    seen = {(t.data_ptr(), tuple(t.shape), tuple(t.stride())): t
            for t in tensors}
    return sum(t.numel() * t.element_size() for t in seen.values())


def sddmm_tc_yardstick(A):
    """K7's yardstick on the tensor cores: ``torch.mm(Ab, Abᵀ,
    out_dtype=f32) * A`` on bf16 operands where the installed torch takes
    ``out_dtype``, else the fp16 product (exact here: every count is at
    most the max degree 1906 < 2048); ``entry`` holds it equal to the
    kernel.  Returns the call and its description."""
    Ab = A.bfloat16()
    try:
        call = lambda: torch.mm(  # noqa: E731
            Ab, Ab.T, out_dtype=torch.float32) * A
        call()
        return call, "torch.mm(Ab, Ab.T, out_dtype=float32) * A, bf16"
    except (TypeError, RuntimeError):
        Ah = A.half()
        return ((lambda: (Ah @ Ah.T).float() * A),
                "(Ah @ Ah.T).float() * A, fp16 product")


def sddmm_row_extras(A) -> dict:
    """K7's row beyond the common fields, on the R-MAT adjacency: the
    route and skipped tiles of the call, its bounds, its kernels timed
    alone (``ksd.buffers`` / ``ksd.launch``, the wrapper's own two
    halves), the f32 yardstick, ptxas's counts, and the FMA route on
    random normal f32 operands of the same shape: the call, and each of
    its three kernels alone (prep with its state zeroed first, as the
    call allocates it zeroed, because prep's operand blocks leave once
    the state says a value failed)."""
    got = ksd.sddmm(A, A, A)
    torch.cuda.synchronize()
    route = sddmm_route(A, A, "tc")
    skipped = sddmm_skipped(ksd.last_tiles)
    occupied = int(ksd.last_tiles.sum().item())
    n = A.shape[0]
    buf = ksd.buffers(A, A, A)
    ksd.launch(buf)
    torch.cuda.synchronize()
    if not torch.equal(buf.out, got):
        raise AssertionError("sddmm launched alone differs from the call")
    f32_library = lambda: (A @ A.T) * A  # noqa: E731
    if not torch.equal(f32_library(), got):
        raise AssertionError("the f32 yardstick differs from K7")
    Ab = A.bfloat16()
    alone = {key: timed_ms(lambda: ksd.launch(buf, (step,)), 10)
             for key, step in zip(("ms_prep", "ms_tc", "ms_fma_gated"),
                                  ksd.STEPS)}
    del buf
    # the FMA route: random normal f32 operands, the flag refuses them
    gen = torch.Generator(device=DEV).manual_seed(2)
    lr = [torch.randn((n, n), generator=gen, device=DEV) for _ in range(2)]
    mk = (torch.rand((n, n), generator=gen, device=DEV) < 0.3).float()
    ksd.sddmm(lr[0], lr[1], mk)
    torch.cuda.synchronize()
    sddmm_route(lr[0], lr[1], "fma")
    buf = ksd.buffers(lr[0], lr[1], mk)
    fma_route = {
        "shape": [n, n, n], "ms_call": timed_ms(
            lambda: ksd.sddmm(lr[0], lr[1], mk), 3),
        "ms_prep": timed_ms(lambda: (buf.state.zero_(),
                                     ksd.launch(buf, ("sddmm_prep",))), 10),
        "ms_tc_gated": timed_ms(lambda: ksd.launch(buf, ("sddmm_tc",)), 10),
        "ms_fma_alone": timed_ms(lambda: ksd.launch(buf, ("sddmm_f32",)),
                                 3)}
    del buf, lr, mk
    return {
        "sddmm_route": route, **skipped, "dense_operations": 2 * n ** 3,
        "dense_bf16_tc_bound_ms": 2 * n ** 3 / PEAK_BF16_TC_OPS_PER_S * 1e3,
        "dense_bf16_tc_bound_occupied_ms":
            2 * occupied * ksd.TILE ** 2 * n / PEAK_BF16_TC_OPS_PER_S * 1e3,
        "dense_bf16_tc_bound_cta_tiles_run_ms":
            2 * (skipped["cta_tiles_128x256"] - skipped["cta_tiles_skipped"])
            * 2 * ksd.TILE ** 2 * n / PEAK_BF16_TC_OPS_PER_S * 1e3,
        "dense_operations_bound_ms": 2 * n ** 3 / PEAK_F32_OPS_PER_S * 1e3,
        **alone,
        "ms_bf16_operands": timed_ms(lambda: ksd.sddmm(Ab, Ab, A), 10),
        "library_f32_ms": timed_ms(f32_library, 5),
        "fma_route_random_f32": fma_route,
        "ptxas": ptxas_counts(kbuild.build_logs.get("matreduce", ""),
                              _matreduce_label)}


def matreduce_row_extras(A) -> dict:
    """K6's dense row beyond the common fields, on the R-MAT adjacency:
    the route and skipped tiles of the call, its bounds, its kernels
    timed alone (``mr.matreduce_buffers`` / ``mr.matreduce_launch``, the
    wrapper's own two halves), the f32 yardstick, ptxas's counts, and the
    FMA route on random normal f32 operands of the same shape: the call,
    and each of its three kernels alone (prep with its state zeroed
    first, as the call allocates it zeroed)."""
    got = mr.matreduce(A, A, A)
    route = matreduce_route(A, A, "tc")
    skipped = sddmm_skipped(mr.last_tiles)
    n = A.shape[0]
    buf = mr.matreduce_buffers(A, A, A)
    mr.matreduce_launch(buf)
    if buf.partials.sum().item() != got:
        raise AssertionError("matreduce launched alone differs from the "
                             "call")
    f32_library = lambda: torch.sum((A @ A) * A,  # noqa: E731
                                    dtype=torch.float64)
    if f32_library().item() != got:
        raise AssertionError("the f32 yardstick differs from K6")
    alone = {key: timed_ms(lambda: mr.matreduce_launch(buf, (step,)), 10)
             for key, step in zip(("ms_prep", "ms_tc", "ms_fma_gated"),
                                  mr.MATREDUCE_STEPS)}
    del buf
    # the FMA route: random normal f32 operands, the flag refuses them
    gen = torch.Generator(device=DEV).manual_seed(3)
    lr = [torch.randn((n, n), generator=gen, device=DEV) for _ in range(2)]
    mk = (torch.rand((n, n), generator=gen, device=DEV) < 0.3).float()
    mr.matreduce(lr[0], lr[1], mk)
    matreduce_route(lr[0], lr[1], "fma")
    buf = mr.matreduce_buffers(lr[0], lr[1], mk)
    fma_route = {
        "shape": [n, n, n], "ms_call": timed_ms(
            lambda: mr.matreduce(lr[0], lr[1], mk), 3),
        "ms_prep": timed_ms(lambda: (buf.prep.state.zero_(),
                                     mr.matreduce_launch(
                                         buf, ("matreduce_prep",))), 10),
        "ms_tc_gated": timed_ms(
            lambda: mr.matreduce_launch(buf, ("matreduce_tc",)), 10),
        "ms_fma_alone": timed_ms(
            lambda: mr.matreduce_launch(buf, ("matreduce_f32",)), 3)}
    del buf, lr, mk
    return {
        "matreduce_route": route, **skipped,
        "dense_operations": 2 * n ** 3,
        "dense_bf16_tc_bound_ms": 2 * n ** 3 / PEAK_BF16_TC_OPS_PER_S * 1e3,
        "dense_bf16_tc_bound_cta_tiles_run_ms":
            2 * (skipped["cta_tiles_128x256"] - skipped["cta_tiles_skipped"])
            * 2 * mr._ksd.TILE ** 2 * n / PEAK_BF16_TC_OPS_PER_S * 1e3,
        "dense_operations_bound_ms": 2 * n ** 3 / PEAK_F32_OPS_PER_S * 1e3,
        **alone, "library_f32_ms": timed_ms(lambda: f32_library().item(), 5),
        "fma_route_random_f32": fma_route,
        "ptxas": ptxas_counts(kbuild.build_logs.get("matreduce", ""),
                              _matreduce_label)}


def tilelist_row_extras(stack, lists, ungrouped, tc_product) -> dict:
    """K6's tile-list row beyond the common fields: the lists' sizes, the
    route, the tile products' bounds, its three kernels timed alone
    (``mr.tilelist_buffers`` / ``mr.tilelist_launch``), the tensor-core
    kernel also on the same lists in ``_tile_triples``' order
    (``ungrouped``: output tiles row by row, not in groups of rows), the
    dense row's tensor-core yardstick, and the FMA route on the same
    stack with a value of 2.5 in every tile (the call and its FMA kernel
    alone)."""
    out_idx, k_ptr = lists[:2]
    products = int(k_ptr[-1])
    tops_ = 2 * products * mr._ksd.TILE ** 3
    mr.matreduce_tilelist(stack, *lists)
    route = tilelist_route(stack, k_ptr, "tc")
    buf = mr.tilelist_buffers(stack, *lists)
    mr.tilelist_launch(buf)
    got = mr.matreduce_tilelist(stack, *lists)
    if buf.partials.sum().item() != got:
        raise AssertionError("the tile list launched alone differs from "
                             "the call")
    alone = {key: timed_ms(lambda: mr.tilelist_launch(buf, (step,)), 10)
             for key, step in zip(("ms_prep", "ms_tc", "ms_fma_gated"),
                                  mr.TILELIST_STEPS)}
    buf = mr.tilelist_buffers(stack, *ungrouped)
    mr.tilelist_launch(buf)
    if buf.partials.sum().item() != got:
        raise AssertionError("the ungrouped tile list differs")
    alone["ms_tc_ungrouped"] = timed_ms(
        lambda: mr.tilelist_launch(buf, ("tilelist_tc",)), 10)
    del buf
    odd = stack.clone()
    odd[:, 0, 0] = 2.5
    want = mr.matreduce_tilelist_plain(odd, *lists)
    if mr.matreduce_tilelist(odd, *lists) != want:
        raise AssertionError("the tile list's FMA route differs from its "
                             "plain version")
    tilelist_route(odd, k_ptr, "fma")
    buf = mr.tilelist_buffers(odd, *lists)
    mr.tilelist_launch(buf, ("tilelist_prep",))      # the flag refuses
    fma_route = {"values": "0/1 and 2.5 at cell (0, 0) of every tile",
                 "ms_call": timed_ms(
                     lambda: mr.matreduce_tilelist(odd, *lists), 2),
                 "ms_fma_alone": timed_ms(
                     lambda: mr.tilelist_launch(buf, ("tilelist_f32",)), 2)}
    del buf, odd
    return {"tilelist_route": route, "tiles": stack.shape[0],
            "output_tiles": len(out_idx), "tile_products": products,
            "longest_list": int(np.diff(k_ptr).max()),
            "tile_product_operations": tops_,
            "tile_products_bf16_tc_bound_ms":
                tops_ / PEAK_BF16_TC_OPS_PER_S * 1e3,
            "tile_products_f32_bound_ms": tops_ / PEAK_F32_OPS_PER_S * 1e3,
            **alone, "fma_route": fma_route,
            "dense_tc_yardstick_ms": timed_ms(
                lambda: tc_product().sum(dtype=torch.float64).item(), 5)}


def ptxas_counts(log: str, label) -> list:
    """Registers and spills of each kernel instance, from the ``-Xptxas
    -v`` lines of this run's build of one library (none when it was not
    built in this process); ``label`` names an entry function's mangled
    name, or returns None to leave it out."""
    out, current = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            name = label(entry[1])
            current = None if name is None else {"kernel": name}
            if current is not None:
                out.append(current)
        elif current is not None:
            spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", line)
            regs = re.search(r"Used (\d+) registers", line)
            if spill:
                current.update(stack_bytes=int(spill[1]),
                               spill_store_bytes=int(spill[2]),
                               spill_load_bytes=int(spill[3]))
            if regs:
                current["registers_at_entry"] = int(regs[1])
                current = None
    return out


def _cutjoin_label(mangled: str):
    """vec_kernel<NF, f32|f64, v2|v1>, keep_rows_kernel<NF, f32|f64,
    mask|nomask, v2|v1> and slab_kernel<NC, mask|nomask, v2|v1> by their
    template arguments (NF 0: any count; NC -1: any count)."""
    m = re.search(r"(vec_kernel|keep_rows_kernel|slab_kernel)ILi(n?\d+)E"
                  r"((?:Lb[01]E)+)E", mangled)
    if not m:
        return None
    flags = re.findall(r"Lb([01])E", m[3])
    names = ([] if m[1] == "slab_kernel" else [("f32", "f64")]) + \
        ([("nomask", "mask")] if m[1] != "vec_kernel" else []) + \
        [("v1", "v2")]
    args = [m[2].replace("n", "-")] + [pair[int(f)]
                                       for pair, f in zip(names, flags)]
    return f"{m[1]}<{', '.join(args)}>"


def _matreduce_label(mangled: str):
    """tc::product_kernel<BN, Schedule, Epilogue>, tilelist_fma_kernel,
    prep_kernel<float|bf16> and masked_product_kernel<reduce|write>."""
    head = "tc14product_kernelILi"
    at = mangled.find(head)
    if at >= 0:
        bn, rest = mangled[at + len(head):].split("E", 1)
        names = []
        while (m := re.match(r"NS_(\d+)", rest)):
            end = m.end() + int(m[1])
            names.append(rest[m.end():end])
            rest = rest[end:].removeprefix("E")
        return f"tc::product_kernel<{bn}, {', '.join(names)}>"
    if "tilelist_fma_kernel" in mangled:
        return "tilelist_fma_kernel"
    m = re.search(r"(prep_kernel|masked_product_kernel)I(\w+?)E", mangled)
    if not m:
        return None
    arg = {"f": "float", "13__nv_bfloat16": "bf16", "Lb0": "reduce",
           "Lb1": "write"}.get(m[2], m[2])
    return f"{m[1]}<{arg}>"


def _bitset_label(mangled: str):
    """edges_vec_kernel<K, U>, pack_kernel<VEC>, edges_word_kernel and
    bitset_rows_kernel by their template arguments."""
    m = re.search(r"(edges_vec_kernel|pack_kernel|edges_word_kernel|"
                  r"bitset_rows_kernel)(?:I((?:L[ib]\d+E)+)E)?", mangled)
    if not m:
        return None
    if not m[2]:
        return m[1]
    args = [("true" if v == "1" else "false") if t == "b" else v
            for t, v in re.findall(r"L([ib])(\d+)E", m[2])]
    return f"{m[1]}<{', '.join(args)}>"


def _flash_label(mangled: str):
    """flash_fwd<Dq, Dv, causal|full> by its namespace (bf16k: wgmma + TMA;
    f32k: FMAs)."""
    m = re.search(r"(bf16k|f32k)9flash_fwdILi(\d+)ELi(\d+)ELb([01])E",
                  mangled)
    return m and (f"{m[1]}::flash_fwd<{m[2]}, {m[3]}, "
                  f"{'causal' if m[4] == '1' else 'full'}>")


def _trijoin_label(mangled: str):
    """path::path_cols<MASK>, path::path_finish<MASK> and
    tri::tri_mma<KIN_A, KIN_B, EXTRA> by their template flags."""
    m = re.search(r"(path_cols|path_finish|tri_mma)I((?:Lb[01]E)+)E",
                  mangled)
    if not m:
        return None
    flags = ", ".join("true" if f == "1" else "false"
                      for f in re.findall(r"Lb([01])E", m[2]))
    space = "tri" if m[1] == "tri_mma" else "path"
    return f"{space}::{m[1]}<{flags}>"


def flash_rows(served: dict) -> list:
    """K9's rows: qwen3-4b's serving path at (Dq, Dv) = (128, 128), its
    launches on every serving path beside it, deepseek-v3's MLA serving
    path at (192, 128) and musicgen-large's at (64, 64) (no qk-norm: its
    scores are held by the f64 oracle, ``flash_oracle_check``)."""
    return [flash_row(served["captured"], served["launches"]["flashattn"],
                      "serve_path: qwen3-4b, 6 prompts",
                      launches_moe_serve_path=served["moe_launches"][
                          "flashattn"],
                      launches_vlm_serve_path=served["vlm_launches"][
                          "flashattn"],
                      launches_dense_serve_path=served["dense_launches"],
                      launches_audio_serve_path_at_64_64=served[
                          "audio_launches"]["flashattn"]),
            flash_row(served["mla_captured"], served["mla_launches"][
                "flashattn"], "mla_serve_path: deepseek-v3-671b, 5 layers, "
                "6 prompts", oracle=True),
            flash_row(served["audio_captured"], served["audio_launches"][
                "flashattn"], "audio_serve_path: musicgen-large, prefills "
                "of 4096, 2048 and 512 frames", oracle=True)]


def flash_oracle_check(q, k, v) -> dict:
    """K9 on a path's own bf16 q, k, v whose scores reach the thousands
    (no qk-norm at random weights: deepseek-v3's layer 0, lse about 4600):
    there f32 sums of the scores move P by more than one bf16 rounding of
    the output and lse by more than 2^-19 of itself, in the plain f32
    version as in the kernel, so ``flash_check``'s second check and its lse
    check would fail on both alike.  Held instead against the f64 oracle
    with the floor of the plain f32 version's own error
    (``flash_path_check``), and against the plain version on the same
    inputs within the reference's tolerance, every cell.  lse feeds only
    K9-bwd, whose (192, 128) instances are held on their own cases and on
    the training path's inputs."""
    case = flash_path_check("bf16 serving path's layer-0 q, k, v", q, k, v,
                            block=1024)
    got = kfa.flash_attention(q, k, v, causal=True).float()
    want = kfa.flash_attention_plain(q, k, v, causal=True,
                                     block=1024).float()
    tol = FLASH_TOL[torch.bfloat16]
    err = (got - want).abs()
    case.update(max_abs_err=err.max().item(),
                plain_tolerance=f"{tol} + {tol}*|plain|",
                cells_over_plain_tolerance=int(
                    (err > tol + tol * want.abs()).sum().item()))
    assert not case["cells_over_plain_tolerance"], case
    return case


def flash_row(captured: dict, launches: int, where: str,
              oracle: bool = False, **more) -> dict:
    """K9 on a serving path's own q, k, v (layer 0 of a 4096-token
    prefill, bf16, causal), held as ``flash_check`` holds the cases.
    Bound, for the function at f32 grade: S = QKᵀ multiplies bf16 inputs,
    exact in f32 on the bf16 tensor cores, and P·V is two bf16 passes
    (P_hi·V + P_lo·V, within 2^-17·|P| of the f32 P): (2·Dq + 4·Dv)·H·T
    operations (T = S(S+1)/2 pairs a head) at the bf16 tensor-core rate,
    against the bytes of q, k, v and out and against one exp per visible
    score on the special-function units, which run beside the tensor
    cores.  Beside it, labelled: one pass with P rounded to bf16 (another
    function, SDPA's), P·V at the f32 rate (the bound until the split was
    used), and all in f32.  Yardstick: PyTorch's
    scaled_dot_product_attention(is_causal=True) in bf16 (``sdpa_call``:
    the backend it takes is printed).  With ``oracle`` the check is
    ``flash_oracle_check``'s, for inputs whose scores reach the
    thousands."""
    q, k, v = (captured[x] for x in "qkv")
    B, S, H, D = q.shape
    Dv = v.shape[3]
    case = flash_oracle_check(q, k, v) if oracle else flash_check(
        "bf16 serving path's layer-0 q, k, v", q, k, v, True, [],
        block=1024, library=True)
    nbytes = distinct_bytes(q, k, v) + B * S * H * Dv * q.element_size()
    pairs = B * H * S * (S + 1) // 2
    s_ops, pv_ops = 2 * D * pairs, 2 * Dv * pairs
    nops = s_ops + pv_ops
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    exp_rate = SFU_EXP2_PER_CLOCK_PER_SM * sms * clock_mhz * 1e6
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_tc = (s_ops + 2 * pv_ops) / PEAK_BF16_TC_OPS_PER_S * 1e3
    t_exp = pairs / exp_rate * 1e3
    library, backend = sdpa_call(q, k, v, True)
    ptxas = [x for x in ptxas_counts(kbuild.build_logs.get("flashattn", ""),
                                     _flash_label)
             if f"<{D}, {Dv}," in x["kernel"]]
    return {"name": "flash_attention", "route": "cuda",
            "source": FLASHATTN_SOURCE,
            "replaces": "src/repro/kernels/flashattn.py:74",
            "launches": launches, "launches_where": where, **more,
            "max_abs_err": case["max_abs_err"],
            "tolerance": case.get("plain_tolerance", case["tolerance"]),
            "check": case,
            "ms": timed_ms(lambda: kfa.flash_attention(q, k, v, causal=True),
                           20),
            "same_work_ms": same_work_ms(lambda hs: kfa.flash_attention(
                q[:, :, hs], k[:, :, hs], v[:, :, hs], causal=True), H, 20),
            "same_work_calls": f"{SAME_WORK_CALLS} x {H // SAME_WORK_CALLS} "
                               "heads",
            "plain_ms": timed_ms(lambda: kfa.flash_attention_plain(
                q, k, v, causal=True, block=1024), 3),
            "bound_ms": max(t_bytes, t_tc, t_exp),
            "bound_by": "bytes" if t_bytes >= max(t_tc, t_exp)
                        else "operations",
            "library_ms": timed_ms(library, 20),
            "library_backend": backend,
            "library_max_abs_diff": (library().float()
                                     - kfa.flash_attention(
                                         q, k, v, causal=True).float()
                                     ).abs().max().item(),
            "shape": [B, S, H, D], "head_dims": [D, Dv], "dtype": "bf16",
            "causal": True, "bytes": nbytes, "operations": nops,
            "exps": pairs, "bytes_bound_ms": t_bytes,
            "operations_bound": "S = QK^T + two-pass P.V (P_hi.V + P_lo.V) "
                                "at the bf16 tensor-core rate",
            "tensor_core_bound_ms": t_tc,
            "exp_bound_ms": t_exp,
            "exp_rate": f"{SFU_EXP2_PER_CLOCK_PER_SM} exp2 / clock / SM "
                        f"(CUDA C++ Programming Guide, cc 9.0) x {sms} SMs "
                        f"x {clock_mhz:g} MHz (nvidia-smi clocks.max.sm)",
            "one_pass_bf16_p_bound_ms": nops / PEAK_BF16_TC_OPS_PER_S * 1e3,
            "retired_pv_f32_rate_bound_ms":
                (s_ops / PEAK_BF16_TC_OPS_PER_S
                 + pv_ops / PEAK_F32_OPS_PER_S) * 1e3,
            "f32_operations_bound_ms": nops / PEAK_F32_OPS_PER_S * 1e3,
            "ptxas": ptxas,
            "yardstick": "scaled_dot_product_attention(is_causal=True) on "
                         f"(B, H, S, D) views, bf16, {backend}"}


def same_work_ms(call, H: int, reps: int):
    """``call(hs)`` on ``SAME_WORK_CALLS`` head slices ``hs`` of H heads in
    turn, timed as one (``timed_ms``): the work of one call on all H heads
    at H / ``SAME_WORK_CALLS`` heads a call, where more of the resident
    CTAs share a head; None where H does not split so."""
    if H % SAME_WORK_CALLS:
        return None
    part = H // SAME_WORK_CALLS
    slices = [slice(i * part, (i + 1) * part)
              for i in range(SAME_WORK_CALLS)]
    return timed_ms(lambda: [call(hs) for hs in slices], reps)


def _flash_bwd_label(mangled: str):
    """stats_kernel<f32|bf16, Dv>, and dkdv_kernel / dq_kernel <f32|bf16,
    Dq, Dv, causal|full> by their namespace (bf16k: wgmma; f32k: split
    TF32)."""
    m = re.search(r"(bf16k|f32k)\d+stats_kernelILi(\d+)E", mangled)
    if m:
        return f"stats_kernel<{'bf16' if m[1] == 'bf16k' else 'f32'}, {m[2]}>"
    m = re.search(r"(bf16k|f32k)\d+(dkdv_kernel|dq_kernel)ILi(\d+)ELi(\d+)E"
                  r"Lb([01])E", mangled)
    if not m:
        return None
    dtype = "bf16" if m[1] == "bf16k" else "f32"
    return (f"{m[2]}<{dtype}, {m[3]}, {m[4]}, "
            f"{'causal' if m[5] == '1' else 'full'}>")


def sdpa_bwd_call(q, k, v, do, causal: bool) -> tuple:
    """PyTorch's scaled_dot_product_attention backward alone as a call with
    no arguments (the forward once with its graph kept, then
    ``torch.autograd.grad`` of it), and which backend it takes: the
    default dispatch at Dq == Dv; at Dq != Dv the first fused backend of
    ``SDPA_FUSED`` whose backward takes V as it is, else the first that
    takes V zero-padded to Dq (dO padded alike: zero columns add nothing
    to dQ and dK), else the math backend."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    Dq, Dv = q.shape[3], v.shape[3]
    tries = [(None, False)] if Dq == Dv else \
        [(b, False) for b in SDPA_FUSED] + [(b, True) for b in SDPA_FUSED] \
        + [("MATH", False)]
    for backend, pad in tries:
        leaves = [x.detach().clone().requires_grad_() for x in (
            q, k, torch.nn.functional.pad(v, (0, Dq - Dv)) if pad else v)]
        dout = torch.nn.functional.pad(do, (0, Dq - Dv)) if pad else do
        try:
            with warnings.catch_warnings(), (
                    sdpa_kernel(getattr(SDPBackend, backend)) if backend
                    else contextlib.nullcontext()):
                warnings.simplefilter("ignore")
                out = sdpa(*leaves, causal)
                torch.autograd.grad(out, leaves, dout, retain_graph=True)
                torch.cuda.synchronize()
        except RuntimeError:
            continue
        name = backend or "default dispatch"
        return ((lambda: torch.autograd.grad(out, leaves, dout,
                                             retain_graph=True)),
                name + (f", V and dO zero-padded to Dq = {Dq}" if pad
                        else ""))
    raise AssertionError("no SDPA backend takes these inputs")


# K9-bwd f32 at (192, 128) is timed also at this shape, causal: the
# reduced step's (4, 64, 4) is all launch overhead
MLA_F32_BWD_TIMED = (1, 4096, 16)
# K9-bwd bf16's tiles: dkdv_kernel's 64 resident KV rows against 64-row Q
# tiles, dq_kernel's 128 resident Q rows against 64-row KV tiles
BWD_BF16_TILE, BWD_BF16_Q_ROWS = 64, 128


# run by `kernel_split` in a process of its own: argv = src dir, B, S, H,
# Dq, Dv, calls, dtype; prints {kernel: [device ms, launches]} over the calls
KERNEL_SPLIT_SCRIPT = r"""
import json, re, sys
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.kernels import flashattn as kfa
B, S, H, Dq, Dv, calls = map(int, sys.argv[2:8])
gen = torch.Generator(device="cuda").manual_seed(5)
q, k, v, do = [torch.randn((B, S, H, d), generator=gen, device="cuda",
                           dtype=getattr(torch, sys.argv[8]))
               for d in (Dq, Dq, Dv, Dv)]
o, lse, _ = kfa._forward(q, k, v, True, Dq ** -0.5, with_lse=True)
call = lambda: kfa.flash_attention_bwd(q, k, v, o, do, lse, causal=True)
call()
torch.cuda.synchronize()
with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    for _ in range(calls):
        call()
    torch.cuda.synchronize()
out = {}
for evt in prof.events():
    if evt.device_type == torch.autograd.DeviceType.CUDA:
        m = re.search(r"::(\w+)<", evt.name)
        ms, n = out.get(m[1] if m else evt.name[:80], (0.0, 0))
        out[m[1] if m else evt.name[:80]] = (
            ms + evt.device_time_total / 1e3, n + 1)
print(json.dumps(out))
"""


# run by `tri_split` in a process of its own: argv = src dir, n, calls;
# prints {"kernel": {name: [device ms, launches]}, "library": {...}} over
# the calls of the triangle route (the cycles' mix of three pair factors,
# seeded integers) and of its yardstick on the same factors
TRI_SPLIT_SCRIPT = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.kernels import matreduce as mr
n, calls = int(sys.argv[2]), int(sys.argv[3])
gen = torch.Generator(device="cuda").manual_seed(5)
axes = [(0, 1), (1, 2), (0, 2)]
fs = [torch.randint(0, 26, (n, n), generator=gen, device="cuda",
                    dtype=torch.float64) for _ in axes]
eye = torch.eye(n, dtype=torch.bool, device="cuda")
P1, P2, P3 = (F.masked_fill(eye, 0) for F in fs)
runs = {"kernel": lambda: mr.tri_reduce(fs, axes, n=n),
        "library": lambda: ((P1 @ P2) * P3).sum().item()}
out = {}
for key, fn in runs.items():
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            ms, k = by.get(evt.name, (0.0, 0))
            by[evt.name] = (ms + evt.device_time_total / 1e3, k + 1)
    out[key] = by
print(json.dumps(out))
"""


def tri_split(n: int, calls: int = 3) -> dict:
    """The triangle route's kernels and its yardstick's (cuBLAS's f64
    product and PyTorch's elementwise and sum kernels), device ms and
    launches a call by full kernel name, at n on seeded integer factors:
    CUDA activity of ``torch.profiler`` in a process of its own, as
    ``kernel_split`` takes it.  The yardstick's product kernel, the one of
    most device time, by its name, which names cuBLAS's tile geometry."""
    proc = subprocess.run(
        [sys.executable, "-c", TRI_SPLIT_SCRIPT, os.path.join(ROOT, "src"),
         str(n), str(calls)], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    split = json.loads(proc.stdout.strip().splitlines()[-1])
    out = {key: {name: {"ms": ms / calls, "launches_per_call": k / calls}
                 for name, (ms, k) in by.items()}
           for key, by in split.items()}
    mine = {k: v for k, v in out["kernel"].items() if "tri_mma" in k}
    assert len(mine) == 1 and sum(v["ms"] for v in mine.values()) > 0, \
        f"the profiler saw no triangle kernel: {out['kernel']}"
    gemm = max(out["library"], key=lambda k: out["library"][k]["ms"])
    return {"device_ms": next(iter(mine.values()))["ms"],
            "device_ms_by_kernel": out["kernel"],
            "library_kernel": gemm,
            "library_kernel_device_ms": out["library"][gemm]["ms"],
            "library_device_ms_by_kernel": out["library"]}


def tri_sass() -> dict:
    """The f64 mma instructions in the SASS of each triangle kernel by
    opcode, and per stage of 16 of y as the design issues them (16 x 8
    blocks of a warp's 64 x 32, each 16 / k instructions of k = the
    opcode's), or why not."""
    sass = kbuild.sass_opcodes("trijoin", r"DMMA(?:\.\w+)*")
    if sass is None:
        return {"sass_dmma": "not counted: no cuobjdump in the toolkit"}
    out = {}
    for mangled, ops in sass.items():
        label = _trijoin_label(mangled)
        if label and label.startswith("tri::"):
            per = {op: (4 * 4 * 16 // int(op.rsplit("x", 1)[1])
                        if re.fullmatch(r"DMMA\.\d+x\d+x\d+", op)
                        else None) for op in ops}
            out[label] = {"in_sass": ops, "per_stage_per_warp": per}
    return {"sass_dmma": out}


def kernel_split(shape, head_dims, dtype, calls: int = 3) -> dict:
    """Device ms a call, and launches a call, of each kernel K9-bwd
    launches, by its unqualified name, causal at ``shape`` (B, S, H) and
    ``head_dims`` on seeded random inputs: CUDA activity of
    ``torch.profiler`` over ``calls`` calls after a warm-up, in a process
    of its own (late in this script's process the profiler kept one
    launch of each kernel in three calls, or none).  A trace without
    device time fails."""
    proc = subprocess.run(
        [sys.executable, "-c", KERNEL_SPLIT_SCRIPT, os.path.join(ROOT, "src"),
         *map(str, (*shape, *head_dims, calls)),
         str(dtype).split(".")[1]], capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    split = json.loads(proc.stdout.strip().splitlines()[-1])
    out = {name: {"ms": ms / calls, "launches_per_call": n / calls}
           for name, (ms, n) in split.items()}
    assert sum(r["ms"] for r in out.values()) > 0, \
        "the profiler saw no device time"
    return out


def flash_bwd_row(c: dict, launches: int, where: str, reps: int,
                  ptxas: list, also: tuple = None) -> dict:
    """K9-bwd on a path's own inputs ``c`` (q, k, v, o, dO, lse: the first
    backward call of a step, causal), held as ``flash_bwd_check`` holds
    the cases and launched twice (the gradients must be the same bits).
    Bound, for the function: five products (S = QKᵀ, dQ = dS·K and
    dK = dSᵀ·Q over Dq; dP = dO·Vᵀ and dV = Pᵀ·dO over Dv), (3·Dq +
    2·Dv)·H·S(S+1) operations per sequence, at the rate for the inputs'
    type (bf16 tensor cores 989 TFLOP/s; f32 67 TFLOP/s), against the
    bytes of q, k, v, o, dO, lse and the three gradients.  Beside it, the
    design's own passes at its rate (bf16: S and dP twice, dV, dK and dQ in
    two terms each, over the 64 x 64 tiles the kernels run, the diagonal's
    whole, at 989 TFLOP/s; f32: the seven products in three TF32 passes
    each, at 495 TFLOP/s), ptxas's registers and spills for each of the
    entry's kernels, and each kernel's device ms and launches a call at
    the row's shape, on seeded random inputs in a process of its own
    (``kernel_split``).  Yardstick: ``torch.autograd.grad`` of
    PyTorch's scaled_dot_product_attention(is_causal=True), its backward
    alone (``sdpa_bwd_call``).  Each gradient's mean relative bias
    (``mean_relative_bias``) against the plain version in f64 with lse
    taken in f64 is held to ``FLASH_BWD_BIAS_TOL``; against it on the
    kernel's lse, held so in f32 and reported in bf16.
    ``also``: a (B, S, H) at which the call and its yardstick are timed
    besides, on seeded random inputs."""
    q, k, v, o, do, lse = (c[x] for x in ("q", "k", "v", "o", "do", "lse"))
    B, S, H, Dq = q.shape
    Dv = v.shape[3]
    case = flash_bwd_check(f"training path's own inputs {list(q.shape)} "
                           f"/ {Dv}", q, k, v, do, True, [], twice=True)
    # flash_bwd_check recomputes o and lse with the same kernel: equal
    o2, lse2, _ = kfa._forward(q, k, v, True, Dq ** -0.5, with_lse=True)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)
    bf16 = q.dtype == torch.bfloat16
    dt = "bf16" if bf16 else "f32"
    peak = PEAK_BF16_TC_OPS_PER_S if bf16 else PEAK_F32_OPS_PER_S
    pairs = B * H * S * (S + 1)
    nops = (3 * Dq + 2 * Dv) * pairs
    nbytes = B * S * H * (4 * Dq + 4 * Dv) * q.element_size() + \
        lse.numel() * 4
    t_ops = nops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    # the design's own work: bf16, S and dP twice and dV, dK, dQ in two
    # terms over the tiles the kernels run, whole ones on the diagonal
    # (dkdv_kernel, 3·Dq + 3·Dv products a cell: a 64-row KV tile's Q tiles
    # from the diagonal on; dq_kernel, 3·Dq + Dv: a 128-row Q tile's 64-row
    # KV tiles up to the diagonal); f32, S and dP twice and dV, dK, dQ
    # once, three TF32 passes each
    kv_tiles, q_tiles = -(-S // BWD_BF16_TILE), -(-S // BWD_BF16_Q_ROWS)
    dkdv_cells = B * H * kv_tiles * (kv_tiles + 1) // 2 * BWD_BF16_TILE ** 2
    dq_cells = B * H * q_tiles * (q_tiles + 1) * BWD_BF16_Q_ROWS * \
        BWD_BF16_TILE
    design_ops, rate = ((2 * ((3 * Dq + 3 * Dv) * dkdv_cells
                              + (3 * Dq + Dv) * dq_cells),
                         PEAK_BF16_TC_OPS_PER_S) if bf16 else
                        (3 * (4 * Dq + 3 * Dv) * pairs,
                         PEAK_TF32_TC_OPS_PER_S))
    call = lambda: kfa.flash_attention_bwd(  # noqa: E731
        q, k, v, o, do, lse, causal=True)
    got = kfa.flash_attention_bwd(q, k, v, o, do, lse, causal=True)
    wide = [x.double() for x in (q, k, v, o, do)]
    for key, row_lse in (("mean_relative_bias", plain_by_heads(
            lse_f64, q, k, causal=True)), ("mean_relative_bias_kernel_lse",
                                           lse)):
        f64 = plain_by_heads(kfa.flash_attention_bwd_plain, *wide,
                             lse=row_lse, causal=True)
        case[key] = {name: mean_relative_bias(g, w)
                     for name, g, w in zip(("dq", "dk", "dv"), got, f64)}
        del f64, row_lse
    del got, wide
    case["mean_relative_bias_tolerance"] = FLASH_BWD_BIAS_TOL
    held = ["mean_relative_bias"] + ([] if bf16 else
                                     ["mean_relative_bias_kernel_lse"])
    for key in held:
        assert max(map(abs, case[key].values())) <= FLASH_BWD_BIAS_TOL, \
            (key, case[key])
    library, backend = sdpa_bwd_call(q, k, v, do, True)
    split = kernel_split((B, S, H), (Dq, Dv), q.dtype)
    row = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": FLASHATTN_BWD_SOURCE,
        "replaces": "src/repro/kernels/flashattn.py:74 has no backward "
                    "(no custom_vjp): the reference differentiates the "
                    "XLA scan src/repro/models/layers.py:57 "
                    "flash_attention with jax.vjp",
        "launches": launches, "launches_where": where,
        "max_abs_err": max(g["max_abs_err"] for g in case["grads"].values()),
        "worst_err_over_tolerance": case["worst_err_over_tolerance"],
        "tolerance": case["tolerance"], "check": case,
        "ms": timed_ms(call, reps),
        "device_ms_by_kernel": split,
        "kernel_launches_per_call": sum(
            r["launches_per_call"] for r in split.values()),
        "same_work_ms": same_work_ms(lambda hs: kfa.flash_attention_bwd(
            q[:, :, hs], k[:, :, hs], v[:, :, hs], o[:, :, hs], do[:, :, hs],
            lse[:, hs], causal=True), H, reps) if bf16 else None,
        "same_work_calls": f"{SAME_WORK_CALLS} x {H // SAME_WORK_CALLS} "
                           "heads" if bf16 else None,
        "plain_ms": timed_ms(lambda: kfa.flash_attention_bwd_plain(
            q, k, v, o, do, lse, causal=True), 2),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": timed_ms(library, reps), "library_backend": backend,
        "shape": [B, S, H, Dq], "head_dims": [Dq, Dv], "dtype": dt,
        "causal": True, "operations": nops, "bytes": nbytes,
        "operations_bound": f"5 products at {peak / 1e12:g} TFLOP/s "
                            f"({dt} inputs)",
        "f32_rate_bound_ms": nops / PEAK_F32_OPS_PER_S * 1e3,
        "design_operations": design_ops,
        "design_passes_bound_ms": design_ops / rate * 1e3,
        "design": ("wgmma + TMA, P and dS as bf16 hi + lo; dkdv_kernel: "
                   "64 resident KV rows a CTA, one consumer warpgroup per "
                   "product group, P handed through shared memory, the "
                   "next tile's score product before this tile's boxes; "
                   "dq_kernel: 128 resident Q rows, 64 a consumer; both in "
                   "K9's tile order" if bf16 else
                   "split-TF32 mma.sync m16n8k8, 3 terms"),
        "same_bits_two_launches": case["two_launches_same_bits"],
        "ptxas": [x for x in ptxas
                  if x["kernel"].startswith(f"stats_kernel<{dt}, {Dv}>")
                  or f"<{dt}, {Dq}, {Dv}," in x["kernel"]],
        "yardstick": "torch.autograd.grad of "
                     "scaled_dot_product_attention(is_causal=True) on "
                     f"(B, H, S, D) views, {dt}, the backward alone, "
                     f"{backend}"}
    del library
    if also:
        gen = torch.Generator(device=DEV).manual_seed(5)
        x = [torch.randn((*also, d), generator=gen, device=DEV,
                         dtype=q.dtype) for d in (Dq, Dq, Dv, Dv)]
        xo, xlse, _ = kfa._forward(*x[:3], True, Dq ** -0.5, with_lse=True)
        lib, lib_backend = sdpa_bwd_call(*x, True)
        row["also_timed"] = {
            "shape": list(also) + [Dq], "head_dims": [Dq, Dv],
            "ms": timed_ms(lambda: kfa.flash_attention_bwd(
                *x[:3], xo, x[3], xlse, causal=True), reps),
            "library_ms": timed_ms(lib, reps),
            "library_backend": lib_backend}
        del x, xo, xlse, lib
    return row


def flash_bwd_rows(trained: dict, hybrid: dict) -> list:
    """K9-bwd on the training paths' own inputs (``flash_bwd_row``):
    qwen3-4b's (1, 4096, 32, 128) and deepseek-v3's (1, 4096, 128, 192 /
    128) in bf16, repro-100m's (8, 1024, 10, 64) in f32, and reduced
    deepseek-v3's (4, 64, 4, 192 / 128) in f32 from phase 7e, also timed
    at ``MLA_F32_BWD_TIMED``."""
    ptxas = ptxas_counts(kbuild.build_logs.get("flashattn_bwd", ""),
                         _flash_bwd_label)
    steps = lambda part: sum(x["launches"]["flashattn_bwd"]  # noqa: E731
                             for x in trained[part]["steps"])
    c = trained["captured"]
    return [
        flash_bwd_row(c["big"], steps("big"),
                      "train_path: qwen3-4b, 3 steps", 5, ptxas),
        flash_bwd_row(c["mla"], steps("mla"),
                      "train_path: deepseek-v3-671b, 3 dense layers, "
                      "3 steps", 5, ptxas),
        flash_bwd_row(c["small"], trained["cli"]["launches"]["flashattn_bwd"],
                      "train_path: the repro-100m CLI, 30 + 5 steps", 20,
                      ptxas),
        flash_bwd_row(hybrid["captured"],
                      hybrid[MLA_ARCH]["train"]["launches"]["flashattn_bwd"],
                      "hybrid_card_vs_cpu: reduced deepseek-v3-671b, one "
                      "grad and one train step", 20, ptxas,
                      also=MLA_F32_BWD_TIMED)]


def main():
    t0 = time.perf_counter()
    wall: dict = {}

    def timed(phase, *args, label=None):
        t = time.perf_counter()
        out = phase(*args)
        wall[label or phase.__name__[len("phase_"):]] = round(
            time.perf_counter() - t, 3)
        return out

    smi = timed(phase_device)
    timed(phase_kernel_cases)
    main_path = timed(phase_main_path)
    local_path = timed(phase_local_path, main_path)
    graph_ops = timed(phase_graph_ops, main_path)
    timed(phase_morph_path, main_path)
    timed(phase_batcher_path, main_path)
    mine_path = timed(phase_mine_path, main_path)
    mesh_path = timed(phase_mesh_path, main_path, local_path, mine_path)
    timed(phase_examples)
    serve_path = timed(phase_serve_path)
    moe_serve_path = timed(phase_moe_serve_path)
    timed(phase_ssm_serve_path)
    vlm_serve_path = timed(phase_vlm_serve_path)
    mla_serve_path = timed(phase_mla_serve_path)
    dense = {arch: timed(phase_dense_serve_path, arch,
                         label=f"dense_serve_path[{arch}]")
             for arch in DENSE_SERVED}
    audio_serve_path = timed(phase_audio_serve_path)
    train_path = timed(phase_train_path)
    hybrid = timed(phase_hybrid_card_vs_cpu)
    timed(phase_dryrun_path, train_path, serve_path, smi)
    timed(phase_lm_mesh_path)
    # host-clock seconds per phase so far, the kernel builds inside
    # kernel_cases; the kernels phase follows
    emit("wall_seconds", phases=wall,
         total_before_kernels=round(time.perf_counter() - t0, 3))
    t = time.perf_counter()
    phase_kernels(main_path, local_path, graph_ops, mine_path,
                  {**serve_path, "moe_launches": moe_serve_path["launches"],
                   "vlm_launches": vlm_serve_path["launches"],
                   "mla_launches": mla_serve_path["launches"],
                   "mla_captured": mla_serve_path["captured"],
                   "dense_launches": {a: d["launches"]["flashattn"]
                                      for a, d in dense.items()},
                   "audio_launches": audio_serve_path["launches"],
                   "audio_captured": audio_serve_path["captured"],
                   "k9_path_bias": {
                       f"{name}: {out['flash_check']['shape']}":
                       out["flash_check"]["mean_relative_bias"]
                       for name, out in (
                           ("serve_path", serve_path),
                           ("moe_serve_path", moe_serve_path),
                           ("vlm_serve_path", vlm_serve_path),
                           ("mla_serve_path", mla_serve_path),
                           *((f"dense_serve_path[{a}]", d)
                             for a, d in dense.items()),
                           ("audio_serve_path", audio_serve_path))}},
                  mesh_path, train_path, hybrid)
    emit("wall_seconds_kernels", seconds=round(time.perf_counter() - t, 3),
         total=round(time.perf_counter() - t0, 3))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)          # the one device this drives


if __name__ == "__main__":
    main()
