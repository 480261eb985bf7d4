#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero:

1. Environment: the card's name and power limit (as ``nvidia-smi`` reports
   them), torch and CUDA versions, the nvcc build of ``src/repro_torch/
   csrc`` and each kernel's registers and shared memory (``-Xptxas -v``).
2. Every kernel against its plain PyTorch version at the main path's
   shapes: pdist 2048x2048x784 (euclidean, manhattan, chebyshev); topk for
   the kNN graph (2048x2048x784, k=16, self excluded; euclidean, manhattan,
   chebyshev), the ground truth (10000x60000x784, k=10; euclidean,
   manhattan) and one brute f32 serve batch (512x60000x784, k=10); the
   int8 topk for one quantized-brute serve batch (512x60000x784, K=64)
   and the whole query set (10000x60000x784), bit-identical to its plain
   version, each row with its column splits, its instance's registers,
   shared memory and spill bytes; the merge of the split lists alone, for
   the brute f32 batch and the quantized brute batch; qpath 2048^3 in all
   three modes, on a fixed first sweep operand and on its last (after
   five doublings); the topk kernels at k = 600 (past the shared-memory lists) on
   one brute batch (512x60000x784: euclidean, manhattan, int8) and the f32
   one at the live cell's k' = 4096; the
   embedding bag at DeepFM's shapes (the (V, 1) first-order table at
   serve_bulk and serve_p99, the (V, 10) table for the user embeddings of
   retrieval_cand and the infinity retrieval, the launch floor (one id),
   D = 1 / 10 sum / mean rows with padding ids and weights at the
   serve_bulk batch, and the D = 10 table as bf16 and f16 there, and the
   (V, 1) table at the train batch), each bit-identical to its plain
   version, with its launch plan and instance; the bag's backward
   (``bag_backward``, no TPU counterpart) at DeepFM's train batch and one
   xDeepFM microbatch over the 30226432-row (V, 1) table and a D = 10 mean
   case with padding and weights, each bit-identical to its plain version
   on integer-valued weights and gradients (f32 atomics sum in any order;
   exact integer sums round in none).
   Each prints its error, id agreement, the kernel's time (CUDA events
   after warm-up; the bag also in a CUDA graph, without the host's calls
   between launches), the plain version's time, the time of one PyTorch
   call that computes the same function where there is one (for the
   merges, ``torch.topk`` over the lists and a gather of their ids), and
   the bound (the least time the card could take).
3. The main path at full width: an ``InfinityIndex`` with ``IndexConfig()``
   defaults over 60000 x 784 ``fashion_like`` vectors (the shape of
   Fashion-MNIST), 10000 queries served in batches of 512 (beam), one batch
   of 32 (best-first) and one k=1 search (descent).  Launch counters are
   zeroed just before and read just after each window: the build must
   launch the f32 topk (kNN graph), the matmul pdist and six minmax sweeps;
   the ground-truth scan, the f32 topk; the serving window the beam's
   level loop (``beam/levels``) once a beam batch and the exact re-score
   (``rescore``) once a search, and is reported.  Every window that
   reranks or re-scores a candidate list (the infinity and IVF engines,
   brute with a quant store, a live index's frozen oversample) must count
   its ``rescore`` launches exactly.
   Beam recall@10 must reach ``FULL_RECALL_FLOOR`` and best-first
   ``BEST_FIRST_FLOOR``.  Then the beam kernel (``csrc/beam.cu``) against
   its plain version (``core/vptree.beam_levels``) on the card over the
   index's flattened tree at the b512 cells' plan (512 queries through
   Phi, d 32, budget 1024: W 16, Bcap 32; K 256, the rerank's width), at
   q = inf and q = 2: ``buf`` and the counters equal, ids equal but on
   near ties, distances within the f32 tolerance; each row prints its
   time, the plain loop's, and the bound (the bytes the levels read).
   Then the re-score kernel (``csrc/rescore.cu``) against its plain
   version (``core/scan._plain_candidates``) on the card over phase 3's
   corpus: 512 lists of each query's 4096 nearest rows with 3000 rows
   deleted (the live cell's frozen oversample) and of its 256 nearest (the
   rerank), k 10; ids equal but on near ties, distances within the f32
   tolerance; each row prints its time, the plain version's and the bound
   (the distinct alive rows read once).
4. Recall parity with the committed JAX figures at the ``bench_infinity``
   config (manifold, n=2048, 512 queries): beam recall@10 within 0.03 of
   0.999 at q=2 and 0.939 at q=inf.  Each build is a counted window: six
   logminplus sweeps at q=2, six minmax sweeps at q=inf.
5. Quantized serving at full width, over phase 3's corpus and queries
   (batches of 512, k=10): ``brute`` in f32 (recall@10 1.0 up to near
   ties, one f32 topk launch per batch), ``brute`` with ``{"quant": True}``
   (recall@10 >= 0.99, one int8 topk launch per batch and no f32 scan), and
   phase 3's infinity index with a ``QuantStore`` attached (beam, budget
   1024, rerank 256: overlap >= 0.9 with its own f32 answers, no topk
   launch).  Each prints p50 batch ms, QPS, mean comparisons and the
   corpus bytes it reads per query.  One bench-config build goes through
   the registry's ``quant`` key.
6. The manhattan path at full width: ``IndexConfig(metric="manhattan")``
   over the same corpus.  Its build must launch the cube topk and pdist
   once each, six minmax sweeps and no f32 regime; its ground truth is the
   cube topk; beam, best-first and descent serve it, reranking in
   manhattan.  Beam recall@10 must reach ``MANHATTAN_RECALL_FLOOR`` and
   best-first ``MANHATTAN_BEST_FIRST_FLOOR``.
7. Recsys serving at full width (``configs.get(arch)``, 39 Criteo-shaped
   fields, a 30226432-row table, random weights from ``--seed``): DeepFM
   at serve_p99 (512), serve_bulk (262144) and retrieval_cand (1 query x
   1000000 candidates, k=100), FM, xDeepFM and AutoInt at serve_p99 and
   serve_bulk (xDeepFM's CIN in chunks of ``models.recsys.CIN_CHUNK`` rows), one
   model on the card at a time.  Each window is counted and must launch
   the embedding bag once per call and nothing else; each prints p50 ms,
   examples/s, peak memory and the kernel path's logits (or retrieval ids)
   against the same step with the plain bag (which must launch nothing).
   Then ``examples/recsys_retrieval.py``'s flow over DeepFM user
   embeddings: 20000 random-normal candidates and 32 users, both
   L2-normalised, an ``InfinityIndex`` (q=2) searched best-first, recall@10
   against the exact cosine top-10 (at least ``INF_RETRIEVAL_FLOOR``); its
   window launches the bag, the f32 topk, the matmul pdist and six
   logminplus sweeps.

8. Filtered serving and the other engines at full width, over phase 3's
   corpus and queries, run right after phase 5 (it reuses phase 3's index).
   Attribute columns as ``launch/serve.py``'s ``demo_attrs`` makes them
   (``score`` uniform from ``--seed``, ``category`` c0..c7 round-robin).
   Filtered ``brute``, f32 and ``quant``, at ``score <= s`` for s in
   ``FILTER_SELECTIVITIES`` and one ``category`` isin AND ``score`` range
   case, each a counted window (the masked topk / int8 kernel once per
   batch): f32 equal to the scan over the passing rows up to near ties,
   quant at recall@10 >= ``QUANT_BRUTE_FLOOR``; phase 3's index with the
   attribute store attached (beam at 512 queries, best-first at 32, at
   ``INF_FILTER_S``); ``ivf_flat`` (256 lists, nprobe 8, f32 and with a
   quant store), ``ivf_pq`` (256 lists, M 16, 256 centroids a subspace,
   rerank 64) and ``nsw`` (degree 16, 4 long links, ef 48, 128 steps),
   each built through the registry (seconds per stage) and served
   unfiltered and at score <= ``KERNEL_S``.  ``leaked``, the returned ids
   that fail the filter, must be 0 in every filtered row.  Kernel rows: the
   masked f32 and int8 topk at score <= 0.1, pdist at k-means' shapes
   (60000x256x784 and a 49-wide PQ subspace) and the topk at the NSW
   graph's (60000^2, k=16, self excluded), each against its plain version.
   Then ``benchmarks/bench_filtered.py``'s config (brute, ivf_flat, nsw,
   infinity at the four selectivities, each beside its
   ``experiments/BENCH_filtered.json`` row) and ``bench_quant.py``'s
   ivf_flat rows; prints the phase's peak device memory.

9. The serving entry point at full width (``repro_torch.launch.serve``),
   run right after phase 8 over phase 3's corpus, queries and index.
   Phase 3's index is saved with ``core/store`` (its rerank width as the
   search default) under ``build/``, verified and restored by
   ``SearchServer.restore`` (a counted window that must launch nothing and
   run no build stage); the save, verify and restore seconds are printed.
   The server's answers to batches of 1, 40, 64 and 512 (40 is padded to
   64: the beam) must equal ``index.search`` on the padded batch, sliced,
   bit for bit; then all queries in batches of 512 through ``serve`` (its
   p50 / p99 beside phase 3's direct p50 and one taken here), and the full
   batches again with telemetry off and on, where the three beam stage
   counters must sum to the served comparisons less the rerank widths.  A
   probe at ``PROBE_RATE`` over the restored index prints its estimate and
   Wilson interval beside the exact recall@10.  Live brute at full width,
   f32 and with a quant store (``delta_cap`` ``DELTA_CAP``): upsert
   ``DELTA_CAP`` perturbed rows, delete 1 % of the frozen rows, serve
   every query as a counted window (the frozen and the delta scan each
   launch their topk once a batch); every upserted row comes back at rank
   0 for its own query and no deleted id is returned (``leaked`` 0); after
   ``compact("full")`` the answers equal a fresh brute build over
   ``corpus()``; the quant server's snapshot restores to the same answers.
   A live infinity server over the bench-config corpus goes through
   ``compact("refresh")`` and is checked the same way (its answers after
   the refresh equal a refresh over ``corpus()`` with the carried
   embeddings).  Chaos: transient search errors at rate 0.3 are retried and
   every answer equals the clean server's; a snapshot-corruption rule under
   ``snapshot_dir`` and a poisoned swap make ``_heal`` restore the last
   good snapshot, the health log reading SERVING, DEGRADED, RECOVERING,
   SERVING.  Kernel rows: the masked f32 topk over the delta buffer
   (512 x 4096 x 784) and the int8 topk over its codes, each against its
   plain version.

10. Sharded serving at full width (``ShardedIndex``, every shard on the
   card), run right after phase 9 over phase 3's corpus and queries, each
   engine served over ``SHARD_BATCHES`` batches of 512 (k=10, p50 / p99,
   recall@10 against phase 3's ground truth, launches per window): brute
   f32 and brute + quant at S = 2 and 4 (S topk launches a batch; f32 ids
   equal to the one-shard brute's up to near ties, the count that differ
   printed; quantized, every rank's distance at most the one-shard quantized
   answer's, since the shards' shortlists hold the one-shard shortlist, and
   the reranked distances exact); brute f32 at S = 2 once more, built with
   ``mesh=make_test_mesh((2,), ("data",))`` (window ``sharded brute f32
   serve S=2 mesh``), its ids equal to the row without a mesh; ``ivf_flat`` and ``infinity`` (two
   ``IndexConfig()`` builds, one a shard) through ``SearchServer(shards=2)``;
   the same server over brute with shard 1 killed by chaos (every batch
   within its deadline, ``degraded``, ``shards_answered`` 1, the ids of a
   brute search over shard 0's rows); a live server over the two-shard
   brute at phase 9's ``delta_cap`` and deletes, ``LIVE_SHARD_BATCHES``
   batches (three f32 topk launches a batch; answers equal to a one-shard
   live server's up to near ties), compacted in full (the odd row carried
   into the delta) and restored from a snapshot, both answering as a fresh
   brute; ``capture_roofline`` for brute f32 (S
   = 1 and 2) and the two-shard infinity server (``pct_of_peak`` at most
   1.05); ``ServingRuntime`` and its HTTP front with ``RUNTIME_CLIENTS``
   concurrent clients posting ``RUNTIME_REQUESTS`` single queries (answers
   equal to the server's direct answer up to near ties; queue wait p50 /
   p99, batch fill) and a full queue answering 429.  Kernel rows: the f32
   and int8 topk on one shard's rows at S = 2 and 4, pdist at the IVF
   probes' shape, and the f32 topk of one live shard's frozen scan at k'.

11. Recsys training and the projection search at full width
   (``phase_training``).  DeepFM at published widths through
   ``launch.train.build("deepfm", reduced=False, batch=65536)``: one
   gradient by the bag and its backward kernel held against the same
   gradient by their plain versions (loss rtol 1e-5, the ``linear``
   gradient rtol 1e-5 / atol 1e-7, TF32 off); 2 warm-up and 10 timed AdamW
   steps, one counted window (``bag`` and ``bag_backward`` once a step):
   p50 step, examples/s, peak memory, the losses (finite); one step with
   ``microbatches=2, grad_compression="int8"``; the checkpoint round trip
   of (params, AdamW state), written by ``AsyncCheckpointer`` under
   ``build/phase11-*`` while the next step runs, restored and held equal
   bit for bit, then removed (host copy, write and restore seconds).
   xDeepFM (CIN 200-200-200) at the train batch in 8 microbatches, two
   steps.  Then ``benchmarks/bench_projection_search.py``'s config
   (fashion_like, n = 1000, 100 queries, euclidean, q in 1, 2, 4, 8, 16,
   32, inf): per q a counted window of ``project_with_queries`` (its
   projection's 10 sweeps and one product on the qpath kernel), E_q
   against the plain qpath's (minmax bit-identical, logminplus rtol 1e-4),
   and the exact best-first search over the VP tree of D_q: up to q = 8
   each first answer's E_q must be the nearest neighbour's distance
   (Prop. 1; at q = 16 and 32 the pruning of 16th and 32nd powers in f32
   can drop the neighbour, so those are read, not held); recall@1,
   recall@10 and RankOrder@10 are printed (recall@10 falls below 1 at
   q = 16 and 32: the projection keeps the nearest neighbour, not the
   order of the next nine).

12. The GCN (serve and train) and dense-LM serving at full width
   (``phase_models``, after phase 11; no kernel lies on either path, so
   every counter must read 0 in every window).  smollm-135m and gemma-2b
   at published widths and full depth, random weights from ``--seed``,
   prompts from ``TokenStream``, TF32 off: the checks first (f32
   activations: every position decoded through the cache against the
   forward, prefill's last logits against the forward's last row, the card
   against the CPU on the same weights and prompt, each rtol / atol 1e-4;
   the bf16 logits' largest difference from the f32 ones over their
   standard deviation, read), then ``LM_ROWS``: prefill at 4 x 32 768
   (smollm, the chunked path) and 4 x 4 096 (gemma) by
   ``make_prefill_step``, decode at batch 32 over a 32 768-position cache
   and (smollm) batch 1 over 524 288, each filled by a 4 096-token prompt,
   16 greedy ``make_decode_step`` calls; each ``lm`` line prints p50 ms,
   tokens/s, peak memory, its bound and its cuts (``reduced``).  Then
   ``gcn-cora`` on the four ``GNN_SHAPES`` (full_graph_sm, minibatch_lg
   sampled from a 232 965-node host graph, ogb_products, molecule: 128
   graphs packed), each a serve step timed 5 times and 10 AdamW(1e-2)
   steps; ``gnn`` lines print p50s, peak memory, bounds and the loss after
   10 steps; full_graph_sm is held against the CPU (logits rtol / atol
   1e-5, three train losses rtol 1e-5) and ogb_products' f32 forward
   against its f64 forward on the card (1e-4).  Every line names the card
   and its power limit.

13. MoE and MLA serving at published widths, and LM training
   (``phase_moe``, after phase 12; no kernel lies on these paths either, so
   every counter must read 0 in every window).  deepseek-v3-671b and
   qwen3-moe-235b-a22b keep their widths and are cut in depth
   (``MOE_DEPTH``: deepseek-v3 to its first dense layer and one MoE layer
   with the MTP module in the tree, 58.5 GB f32; qwen3-moe to 2 of 94
   layers, 24.9 GB), random weights from ``--seed``, one model on the card
   at a time.  First each arch's ``REDUCED`` config, card against CPU
   (forward, prefill and decode steps, naive and absorbed, LM_RTOL /
   LM_ATOL; 3 AdamW(3e-4) train steps, losses rtol 1e-5); then, at full
   width with f32 activations, teacher forcing through the cache (naive
   and absorbed), prefill against the forward, absorbed against naive
   logits and the MoE dispatch against ``moe_ffn_dense`` on the MoE layer
   over 64 tokens, each rtol / atol 1e-4; then ``MOE_ROWS``: deepseek-v3
   prefill 1 x 4 096, absorbed decode at batch 32 over a 32 768-position
   cache (its 4 096-token prompt prefilled one sequence at a time), naive
   and absorbed decode side by side at 4 x 4 096 (3 072-token prompt);
   qwen3-moe prefill 4 x 4 096 and decode 32 x 32 768.  Each ``lm`` line
   prints p50 ms, tokens/s, peak memory, the experts the routing reached,
   the bound (MLA's products as run; MoE flops for k routed experts and
   the shared one a token, bytes for the experts reached) and its cuts.
   Then smollm-135m at published widths and full depth through
   ``launch.train.build(reduced=False)`` on ``train_4k`` cut to batch 8
   (``LM_TRAIN``; each layer checkpointed): 10 AdamW(3e-4) steps (p50 of
   the nine after the first, tokens/s, peak memory, the losses finite)
   and one ``microbatches=2`` step.

14. Expert-parallel MoE serving on a mesh of ranks that share the card
   (``phase_mesh``, after phase 13; no kernel lies on this path, so every
   counter must read 0 in every window).  A ``mesh`` line: the meshes'
   shapes, ranks and device, and ``torch.cuda.device_count()``.  Per MoE
   arch at phase 13's depth cut: ``MESH_CHECKS`` — ``moe_ffn_ep`` (or
   ``moe_ffn_ep_zero3``) on the MoE layer at published widths, f32, TF32
   off, ``capacity_factor`` E / k so that nothing drops, against
   ``moe_ffn_dispatch`` over 96 tokens, rtol / atol 1e-4 (deepseek-v3 2d on
   (2, 4) and model on (3, 4), qwen3-moe fslice on (3, 4) and zero3 on
   (2, 4)); then ``MESH_ROWS`` under ``lm_policy`` at the published
   ``capacity_factor`` (``make_prefill_step(cfg, dctx)`` /
   ``make_decode_step(cfg, dctx)``; decode prompts prefilled without the
   mesh): each ``lm`` line prints ``ep`` (mode, ranks, E_loc, C, chunks,
   slots assigned and dropped), p50 ms, tokens/s, peak memory and
   ``one_device``, phase 13's row at the same shape where there is one.
   Last, ``REDUCED`` under ``lm_policy`` on (2, 4), card against CPU
   (prefill and decode steps, 1e-5).

15. Cells built by ``launch/cells.build`` and materialised on the card
   (``phase_cells``, after phase 14).  qwen3-moe-235b-a22b ``train_4k`` at
   published widths (``CELL_TRAIN``: cut in depth and in batch and
   sequence; ``LM_TRAIN_OPTS``: bf16 parameters, Adafactor) on a (2, 4) mesh
   of ranks under ``lm_policy(kind="train")``, its MoE layer through the EP
   ``shard_map`` with gradients: first the loss and every gradient with the
   mesh against one device (the weights' f32 twin, f32 activations,
   capacity E / k; loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-5 of each
   leaf's largest), then timed steps at microbatches 1
   and 2 (``cells`` lines: p50 ms, tokens/s, peak memory, ``ep_mode``).
   deepseek-v3-671b's cell at phase 13's depth cut is reckoned by the
   port's dry-run and left out when over the card.  deepseek-coder-33b's
   ``prefill_32k`` and ``decode_32k`` cells cut in depth (bf16 weights,
   batches cut), each first held against its f32 twin (LM_RTOL / LM_ATOL),
   then timed.  ``gcn-cora`` ``full_graph_sm`` train stepped twice; DeepFM's
   ``serve_p99`` and ``train_batch`` cells, counted windows (the bag once a
   call, its backward once a step) whose kernel rows hold the bag and
   ``bag_backward`` at the cells' ids bit for bit to their plain versions.
   Last, ``launch/dryrun.run_cell`` on smollm-135m ``train_4k``, qwen3-moe
   ``decode_32k`` and DeepFM ``train_batch`` over the production (16, 16)
   mesh of meta ranks (``dryrun`` lines, analytic: no card reading).

Last, the qpath kernel on the sweep operands the windows ran, recorded
in each window (the full-width build and the bench-config q=inf build in
minmax, the bench-config q=2 build, the infinity retrieval and the
projection search at q=2 in logminplus, the projection search at q=inf in
minmax), each held against its plain version and timed, one row per
window.

The line before the last is a JSON object listing every kernel row, each
with the launches of the window that runs it (``path``); the last is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

DEVICE = "cuda"
# main-path shapes: the projection subset (IndexConfig().proj_sample), the
# Fashion-MNIST corpus and query set, the serving batch
SUBSET, CORPUS, QUERIES, BATCH = 2048, 60000, 10000, 512

# tests/test_kernels.py:50 tolerance; manhattan sums d terms in another
# order than its plain version and is held to the same
MATMUL_RTOL, MATMUL_ATOL = 1e-5, 5e-4
K_QUANT = 64  # quant.shortlist_width(10, 60000): the int8 first pass's width
LOGMINPLUS_ATOL = 1e-5
BENCH_TARGETS = {2.0: 0.999, math.inf: 0.939}  # experiments/BENCH_infinity.json
RECALL_SLACK = 0.03
# Full width: beam recall@10 read 0.0654 and best-first 0.084 on an H100
# with this data (fashion_like falls ~2x per doubling of n at budget 1024 in both
# packages: tests/torch_recall_ladder.py).  The floors sit well above what
# a search that returned unrelated rows would score (~256 / 60000).
FULL_RECALL_FLOOR = 0.045
BEST_FIRST_FLOOR = 0.03
# Quantized serving: JAX's contract for quantized brute
# (tests/test_quant.py:137-145) and for the infinity prefilter's overlap
# with the f32 answers (tests/test_quant.py:202).
QUANT_BRUTE_FLOOR = 0.99
QUANT_OVERLAP_FLOOR = 0.9
# Manhattan at full width: beam recall@10 read 0.06679 and best-first (32
# queries) 0.0594 on an H100 with this data; the beam floor is 70 % of the
# reading, the best-first one that of euclidean (32 queries move it in
# steps of 1/320).  At n=4000 the two packages agree (0.7539 JAX, 0.7559
# port, reduced config, CPU: tests/torch_recall_ladder.py --metric
# manhattan), and on the card the port's recall halves per doubling of n
# as in euclidean (0.767 at 4000, 0.223 at 16000).
MANHATTAN_RECALL_FLOOR = 0.047
MANHATTAN_BEST_FIRST_FLOOR = 0.03
NUM_HOPS = 6  # IndexConfig().num_hops: qpath sweeps per build
K = 10  # every serving phase answers top-10
SEARCH_KW = dict(budget=1024, rerank=256, mode="auto")
BENCH_N, BENCH_Q = 2048, 512  # benchmarks/bench_infinity.py defaults
# the windows whose recorded sweep operands the qpath path rows replay, and
# the products each runs: q=inf builds sweep in minmax, finite-q builds in
# logminplus, no build sweeps in minplus; the projection search projects
# D (10 sweeps at n = 1000) and multiplies the query rows by D_q once
QPATH_WINDOWS = {"full-width build": NUM_HOPS, "bench-config build q=inf": NUM_HOPS,
                 "bench-config build q=2": NUM_HOPS, "infinity retrieval": NUM_HOPS,
                 "projection search q=2": 11, "projection search q=inf": 11}
NO_QPATH_WINDOW = ("none: a fixed 2048^3 operand; the sweeps the windows ran are "
                   "the rows named by their window")
NO_CHEBYSHEV = "none: no chebyshev window on the main path"
# topk past the shared-memory lists (k > 512): no engine on the main path
# asks for it
WIDE_K = 600
NO_WIDE_K = "none: no engine asks for k > 512 on the main path"
# the live frozen oversample of the benchmark's fresh5pct cell: k' =
# pow2ceil(10 + 3 000 deleted) over the 60 000 frozen rows
LIVE_KPRIME = 4096
LIVE_DELETED = 3000
NO_LIVE_KPRIME = ("none: bench cell fmnist784-live-fresh5pct runs it (3 000 of 60 000 "
                  "rows deleted); no window here deletes that many")
# the embedding bag and its plain version round the same products and sums
# in the same order: every bag row must be bit-identical (torch.equal)
NO_BAG_EXTRAS = "none: served ids carry no padding and no weights"
NO_BAG_D10_BULK = "none: no window pools embedding rows at the serve_bulk batch"
NO_BAG_HALF = "none: no served config declares a bf16 or f16 table"
NO_BAG_FLOOR = "none: the launch floor, a 1x1 bag; no window runs it"
# recsys logits (or retrieval scores) of the kernel path against the plain
# bag's: the same weights and ids, bit-identical bags, so 0 is expected;
# the stated tolerance is the CPU parity tests'
RECSYS_RTOL = RECSYS_ATOL = 1e-5
RECSYS_ARCHS = ("deepfm", "fm", "xdeepfm", "autoint")
SERVE_REPS = {"serve_p99": 30, "serve_bulk": 10}  # timed, after 2 warm-ups
# serve_bulk of the heavier interactions: xDeepFM's chunked CIN is ~1e13
# flops a call
BULK_REPS = {"xdeepfm": 3, "autoint": 5}
RETRIEVAL_REPS = 20
RETRIEVAL_K = 100  # train_step.make_retrieval_step's default
# examples/recsys_retrieval.py: candidates, users, the index and the search
INF_CANDIDATES, INF_USERS = 20000, 32
INF_INDEX = dict(q=2.0, metric="euclidean", proj_sample=1000, train_steps=800,
                 embed_dim=16, hidden=(128, 128))
INF_SEARCH = dict(k=10, mode="best_first", max_comparisons=384, rerank=128)
# recall@10 of that flow read 0.2406 / 0.3656 / 0.3906 / 0.3844 in the port
# and 0.3625 / 0.3219 / 0.3531 / 0.3344 in JAX on the CPU (seeds 0-3, the
# same users and candidates in both); the floor sits under the lowest
# reading and far above unrelated rows (10 / 20000)
INF_RETRIEVAL_FLOOR = 0.15
# phase 8: filtered serving over phase 3's corpus (launch/serve.py's
# demo_attrs columns) and the IVF / NSW engines at full width
FILTER_SELECTIVITIES = (0.9, 0.5, 0.1, 0.01)  # benchmarks/bench_filtered.py
FILTER_COMBO = {"category": {"isin": ["c1", "c3", "c5"]}, "score": {"range": [0.2, 0.6]}}
KERNEL_S = 0.1  # the selectivity of the masked kernel rows and the engines' filtered serve
INF_FILTER_S = (0.5, 0.1)
IVF_ITERS = 10  # the IVF builds' k-means iterations (their default)
IVF_CFG = {"num_clusters": 256, "nprobe": 8}  # ~sqrt(n) lists
IVF_PQ_CFG = {"num_clusters": 256, "M": 16, "ksub": 256, "nprobe": 8, "rerank": 64}
NSW_DEGREE = 16  # the JAX build defaults: degree 16, 4 random links
NSW_CFG = {"ef": 48, "max_steps": 128}  # benchmarks/bench_ann_compare.py:54-55
BENCH_FILTERED_N, BENCH_FILTERED_Q = 2048, 64  # benchmarks/bench_filtered.py defaults
FILTERED_SLACK = 0.05
# bench_filtered's infinity recall from the JAX package at this commit on the
# CPU (python benchmarks/bench_filtered.py, seed 0), printed beside the
# committed rows of experiments/BENCH_filtered.json, which predate the beam
# (0.383 / 0.278 / 0.178 / 0.125).  Over seeds 0-3 (tests/
# torch_filtered_spread.py) JAX reads 0.380-0.500 at s = 0.9 and the port
# 0.414-0.488: one draw moves by more than the slack, so infinity is held
# one-sided, to at least the committed row minus the slack.
INF_FILTERED_JAX = {0.9: 0.4219, 0.5: 0.4078, 0.1: 0.3031, 0.01: 0.2125}
#: every launch counter, zero unless a window requires otherwise
COUNTERS = ("topk/f32", "topk/cube", "topk/int8", "pdist/matmul", "pdist/cube",
            "qpath/minplus", "qpath/minmax", "qpath/logminplus", "bag", "bag_backward",
            "beam/levels", "rescore")


def log(msg: str) -> None:
    print(msg, flush=True)


def counted(fn):
    """Run ``fn`` as one launch-counting window: the counters are zeroed
    just before and read just after (the card synchronised).  Returns
    (result, counts)."""
    import torch

    from repro_torch.kernels import _build

    _build.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, _build.launches()


@contextlib.contextmanager
def recorded_sweeps(into: list | None):
    """While the block runs, append a copy of the operands of every
    semiring product the projection asks for to ``into`` as (mode, A, B),
    B None where it is A (the doubling sweeps square M); nothing is
    recorded where ``into`` is None.  The copies launch no counted kernel."""
    from repro_torch.core import qmetric

    inner = qmetric.qpath_ops.qpath_matmul

    def spy(A, B, *, mode="minmax", row_block=32):
        into.append((mode, A.clone(), None if B is A else B.clone()))
        return inner(A, B, mode=mode, row_block=row_block)

    if into is not None:
        qmetric.qpath_ops.qpath_matmul = spy
    try:
        yield into
    finally:
        qmetric.qpath_ops.qpath_matmul = inner


def require(counts: dict, want: dict, what: str) -> None:
    """Each ``want`` entry is an exact count, or (lo,) for at least lo; a
    counter ``want`` does not name must read 0."""
    for name in COUNTERS:
        n = want.get(name, 0)
        ok = counts[name] >= n[0] if isinstance(n, tuple) else counts[name] == n
        if not ok:
            fail(f"{what}: launch counts {counts}, want {name} "
                 + (f">= {n[0]}" if isinstance(n, tuple) else f"== {n}"))


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ---------------------------------------------------------------------------
# timing and comparison helpers
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean milliseconds per call over ``reps`` back-to-back calls after
    one warm-up call (``warmup``), by CUDA events."""
    import torch

    if warmup:
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


def graph_ms(fn, reps: int) -> float:
    """Device milliseconds per call: ``reps`` calls captured in one CUDA
    graph, replayed once to warm up and once timed by CUDA events, so no
    host work sits between the launches (``cuda_ms`` times the host's
    calls too, which bound a kernel of a few microseconds)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def close_matmul(out, ref, rtol=MATMUL_RTOL, atol=MATMUL_ATOL):
    """max |out - ref| and whether every entry is within the tolerance
    (by default the matmul family's, rtol 1e-5, atol 5e-4); infinities
    must coincide."""
    import torch

    fin = torch.isfinite(ref)
    if not torch.equal(fin, torch.isfinite(out)):
        return float("inf"), False
    err = (out[fin] - ref[fin]).abs()
    ok = bool((err <= atol + rtol * ref[fin].abs()).all())
    return float(err.max()) if err.numel() else 0.0, ok


def ids_agree(ids, ref_ids, ref_d, k: int, rtol=MATMUL_RTOL, atol=MATMUL_ATOL):
    """Kernel ids against the plain version's (computed with k+1 columns):
    every mismatch must sit on a near tie, i.e. the plain distance at that
    position is within tolerance of a neighbouring rank's distance.
    Returns (share of identical ids, ok)."""
    import torch

    ids = ids.long()
    ref = ref_ids[:, :k].long()
    same = ids == ref
    d = ref_d
    tol = atol + rtol * d.abs()
    nxt = (d[:, 1:] - d[:, :-1]).abs() <= tol[:, :-1]  # rank p ~ rank p+1
    near = torch.zeros_like(same)
    near[:, :k] |= nxt[:, :k]
    near[:, 1:k] |= nxt[:, :k - 1]
    ok = bool((same | near[:, :k]).all())
    return float(same.float().mean()), ok


# ---------------------------------------------------------------------------
# phase 1: environment
# ---------------------------------------------------------------------------

def _ptxas_summary(report: str) -> dict:
    """Registers, static shared memory and spill bytes (stores + loads) of
    every kernel instance in nvcc's ``-Xptxas -v`` report."""
    out, name, spill = {}, None, 0
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            for short in ("pdist_kernel", "topk_int8_kernel", "topk_kernel",
                          "merge_kernel", "sqnorm_kernel", "qpath_kernel",
                          "min_splits_kernel", "bag_warp_kernel", "bag_backward_kernel",
                          "bag_kernel", "beam_kernel", "rescore_kernel"):
                if short in name:
                    # template arguments: int family / mode, bool lists
                    rest = name.split(short, 1)[1]
                    args = re.findall(r"L[ib](\d+)E", rest)
                    # the re-score kernel's id type: int or long long
                    ids = re.match(r"I(?:L[ib]\d+E)*([ix])E", rest)
                    if short == "rescore_kernel" and ids:
                        args.append({"i": "int32", "x": "int64"}[ids.group(1)])
                    name = short + (f"<{','.join(args)}>" if args else "")
                    break
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers(?:, used \d+ barriers)?(.*)", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            out[name] = {"registers": int(m.group(1)),
                         "smem_bytes": int(smem.group(1)) if smem else 0,
                         "spill_bytes": spill}
            name = None
    return out


def phase_environment(build_info: dict) -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    env = {
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "build_seconds": build_info["seconds"],
        "kernels": _ptxas_summary(build_info["ptxas"]),
    }
    log(smi)
    log("env " + json.dumps(env))
    return env


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def phase_kernels(seed: int, ptxas: dict) -> list[dict]:
    import torch

    from repro_torch.core import knn_graph as knn_lib
    from repro_torch.core import quant as quant_lib
    from repro_torch.data import synthetic
    from repro_torch.dist import roofline
    from repro_torch.kernels.pdist.pdist import pdist_cuda
    from repro_torch.kernels.pdist.ref import pdist_ref
    from repro_torch.kernels.qpath.ref import qpath_matmul_ref
    from repro_torch.kernels.topk import topk as topk_mod
    from repro_torch.kernels.topk.ref import quantize_queries, topk_quant_ref, topk_ref
    from repro_torch.kernels.topk.topk import int8_plan, topk_cuda, topk_quant_cuda

    dev = torch.device(DEVICE)
    rows = []

    # pdist: D on the projection subset.  Compared as the build uses it,
    # with the diagonal set to 0: a self-distance is sqrt of f32 rounding
    # noise in |x|^2 + |x|^2 - 2 x.x (~1e-2 at these norms) in both
    # versions; its error is reported apart.  The cube metrics compute
    # |x - x| = 0 exactly on the diagonal.
    S = torch.as_tensor(synthetic.fashion_like(SUBSET, seed=seed), device=dev)
    m = n = S.shape[0]
    d = S.shape[1]
    eye = torch.eye(m, dtype=torch.bool, device=dev)
    for metric, path, lib in (
        ("euclidean", "full-width build", lambda: torch.cdist(S, S)),
        ("manhattan", "manhattan build", lambda: torch.cdist(S, S, p=1.0)),
        ("chebyshev", None, lambda: torch.cdist(S, S, p=float("inf"))),
    ):
        cube = metric != "euclidean"
        out = pdist_cuda(S, S, metric=metric)
        ref = pdist_ref(S, S, metric=metric)
        diag_err = float((out.diagonal() - ref.diagonal()).abs().max())
        if metric == "chebyshev":
            err, ok = float((out - ref).abs().max()), torch.equal(out, ref)
        else:
            err, ok = close_matmul(torch.where(eye, 0.0, out), torch.where(eye, 0.0, ref))
        if not ok:
            fail(f"pdist {metric} disagrees with its plain version (max err {err})")
        rows.append({
            "name": "pdist", "case": f"D on S {m}x{n}x{d} {metric}",
            "path": path, "idle": None if path else NO_CHEBYSHEV,
            "counter": "pdist/cube" if cube else "pdist/matmul",
            "source": "src/repro_torch/csrc/pdist.cu",
            "replaces": "src/repro/kernels/pdist/pdist.py:"
                        + ("67" if cube else "36"),
            "max_abs_err": err, "diagonal_abs_err": diag_err,
            "ms": cuda_ms(lambda: pdist_cuda(S, S, metric=metric), 20),
            "plain_ms": cuda_ms(lambda: pdist_ref(S, S, metric=metric), 3 if cube else 20),
            "library_ms": cuda_ms(lib, 5 if cube else 20),
            "bound": _bound(*roofline.pdist_work(m, n, d, cube=cube)),
        })
        log("kernel " + json.dumps(rows[-1]))

    # topk: the kNN graph of S, then the ground truth of the full corpus,
    # for the matmul family (euclidean) and the cube family
    pool = torch.as_tensor(synthetic.fashion_like(CORPUS + QUERIES, seed=seed),
                           device=dev)
    corpus, queries = pool[:CORPUS], pool[CORPUS:]
    slice_q = queries[:BATCH]
    for case, path, metric, Xq, Y, k, excl in (
        ("kNN graph", "full-width build", "euclidean", S, S, 16, True),
        ("ground truth", "full-width ground truth", "euclidean", queries, corpus, 10, False),
        ("brute batch", "brute f32 serve", "euclidean", slice_q, corpus, 10, False),
        ("kNN graph", "manhattan build", "manhattan", S, S, 16, True),
        ("ground truth", "manhattan ground truth", "manhattan", queries, corpus, 10, False),
        ("kNN graph", None, "chebyshev", S, S, 16, True),
        # k > 512: the scan writes its distances out, the select takes the k
        # smallest of each row
        ("wide k: brute batch", None, "euclidean", slice_q, corpus, WIDE_K, False),
        ("wide k: brute batch", None, "manhattan", slice_q, corpus, WIDE_K, False),
        ("wide k: live frozen oversample", None, "euclidean", slice_q, corpus,
         LIVE_KPRIME, False),
    ):
        cube = metric != "euclidean"
        m, n, d = Xq.shape[0], Y.shape[0], Xq.shape[1]
        od, oi = topk_cuda(Xq, Y, k=k, metric=metric, exclude_self=excl)
        # the cube ground truth is held against its plain version on one
        # serve batch of queries: the plain (rows, 4096, 784) cube panels
        # of all 10000 take seconds
        held = BATCH if (cube and m > SUBSET) else m
        rd, ri = topk_ref(Xq[:held], Y, k=k + 1, metric=metric, exclude_self=excl)
        od, oi = od[:held], oi[:held]
        if metric == "chebyshev":
            err = float((od - rd[:, :k]).abs().max())
            ok = ids_ok = torch.equal(od, rd[:, :k]) and torch.equal(oi, ri[:, :k])
            same = float((oi == ri[:, :k]).float().mean())
        else:
            err, ok = close_matmul(od, rd[:, :k])
            same, ids_ok = ids_agree(oi, ri, rd, k)
        if not (ok and ids_ok):
            fail(f"topk {metric} ({case}) disagrees with its plain version "
                 f"(max err {err}, identical ids {same})")
        p = 1.0 if metric == "manhattan" else (float("inf") if cube else 2.0)
        big = m > SUBSET
        reps = 3 if big else 10
        once = big and cube  # plain and cdist take seconds here: one call
        rows.append({
            "name": "topk", "case": f"{case} {m}x{n}x{d} k={k} {metric}"
                                    + (" exclude_self" if excl else "")
                                    + (f" (held to plain on {held} queries)"
                                       if held < m else ""),
            "path": path, "idle": None if path else (
                NO_LIVE_KPRIME if k == LIVE_KPRIME else NO_WIDE_K if k > 512
                else NO_CHEBYSHEV),
            "counter": "topk/cube" if cube else "topk/f32",
            "source": "src/repro_torch/csrc/topk.cu",
            "replaces": "src/repro/kernels/topk/topk.py:" + ("171" if cube else "123"),
            "max_abs_err": err, "ids_identical": same,
            "ms": cuda_ms(lambda: topk_cuda(Xq, Y, k=k, metric=metric,
                                            exclude_self=excl), 1 if once else reps),
            "plain_ms": cuda_ms(lambda: topk_ref(Xq, Y, k=k, metric=metric,
                                                 exclude_self=excl),
                                1 if once else reps, warmup=not once),
            "library_ms": cuda_ms(lambda: torch.topk(torch.cdist(Xq, Y, p=p), k, dim=1,
                                                     largest=False),
                                  1 if once else reps, warmup=not once),
            "bound": _bound(*roofline.topk_work(m, n, d, k, cube=cube, masked=False)),
        })
        log("kernel " + json.dumps(rows[-1]))

    # the merge of the brute f32 batch's split lists, alone
    plan = topk_mod.split_plan(BATCH, CORPUS, K, topk_mod._slots("euclidean", K, dev))
    rows.append(_merge_row(
        "topk", "src/repro/kernels/topk/topk.py:69", "brute f32 serve", "topk/f32",
        plan, K, lambda a, b: topk_ref(slice_q, corpus[a:b], k=K, metric="euclidean")))

    # int8 topk: the quantized brute first pass (K = shortlist_width(10, n))
    # over the corpus's codes, for one serve batch and the whole query set;
    # bit-identical to the plain version (exact int32 cross term, the same
    # f32 roundings in the same order)
    codes, scales, sqn = quant_lib.QuantStore.build(corpus).device_view()
    n, d = codes.shape
    for case, path, Xq, k in (
        ("serve batch", "quantized brute serve", slice_q, K_QUANT),
        ("whole query set", "quantized brute serve", queries, K_QUANT),
        ("wide k: serve batch", None, slice_q, WIDE_K),
    ):
        m = Xq.shape[0]
        od, oi = topk_quant_cuda(Xq, codes, scales, sqn, k=k)
        rd, ri = topk_quant_ref(Xq, codes, scales, sqn, k=k)
        err = float((od - rd).abs().max())
        same = float((oi == ri).float().mean())
        if not (torch.equal(od, rd) and torch.equal(oi, ri)):
            fail(f"topk int8 ({case}) is not bit-identical to its plain version "
                 f"(max err {err}, identical ids {same})")

        def library():
            # the same function by PyTorch's int8 GEMM (cuBLASLt) + topk
            xq, alpha, xn = quantize_queries(Xq, scales)
            acc = torch._int_mm(xq, codes.T)
            d2 = (xn[:, None] + sqn[None, :] - 2.0 * (acc.float() * alpha[:, None]))
            return torch.topk(torch.sqrt(d2.clamp_min(0.0)), k, dim=1, largest=False)

        reps = 20 if m == BATCH else 3
        rows.append({
            "name": "topk_int8", "case": f"quantized brute {case} {m}x{n}x{d} "
                                         f"K={k} euclidean",
            "path": path, "idle": None if path else NO_WIDE_K, "counter": "topk/int8",
            "source": "src/repro_torch/csrc/topk_int8.cu",
            "replaces": "src/repro/kernels/topk/topk.py:207",
            "max_abs_err": err, "ids_identical": same,
            "ms": cuda_ms(lambda: topk_quant_cuda(Xq, codes, scales, sqn, k=k), reps),
            "plain_ms": cuda_ms(lambda: topk_quant_ref(Xq, codes, scales, sqn, k=k), reps),
            "library_ms": cuda_ms(library, reps),
            "bound": _bound(*roofline.topk_int8_work(m, n, d, k, masked=False)),
            **_int8_geometry(ptxas, m, n, k, dev),
        })
        log("kernel " + json.dumps(rows[-1]))

    # the merge of the quantized brute batch's split lists, alone
    rows.append(_merge_row(
        "topk_int8", "src/repro/kernels/topk/topk.py:69", "quantized brute serve",
        "topk/int8", int8_plan(BATCH, n, K_QUANT, dev), K_QUANT,
        lambda a, b: topk_quant_ref(slice_q, codes[a:b], scales, sqn[a:b], k=K_QUANT)))
    del pool, corpus, queries, codes

    # qpath: the first sweep's operands of the projection (E = D on the
    # symmetrised kNN graph + diagonal, +inf elsewhere; 2 log E for
    # logminplus) and the last sweep's (after five doublings, by the plain
    # version): the first is ~1 % finite, the later ones ~10 %, and the
    # logminplus skip is read at both
    idx, _ = knn_lib.knn_graph(S, k=16, metric="euclidean")
    mask = knn_lib.knn_mask(idx, S.shape[0])
    D = torch.where(eye, 0.0, pdist_ref(S, S, metric="euclidean"))
    E = torch.where(mask | mask.T | eye, D, float("inf"))
    for mode in ("minmax", "minplus", "logminplus"):
        first = 2.0 * torch.log(E) if mode == "logminplus" else E
        last = first
        for _ in range(NUM_HOPS - 1):
            last = torch.minimum(last, qpath_matmul_ref(last, last, mode=mode))
        for sweep, A in (("first", first), ("last", last)):
            rows.append(_qpath_row(mode, sweep, A))
            log("kernel " + json.dumps(rows[-1]))
        del first, last
    rows += _bag_rows(seed, ptxas)
    rows += _bag_backward_rows(seed, ptxas)
    return rows


def _qpath_sweep(mode: str, A, B, what: str) -> dict:
    """qpath_matmul_cuda(A, B) against its plain version on one operand:
    minmax and minplus bit-identical, logminplus within LOGMINPLUS_ATOL;
    infinities must coincide.  Returns its error, times, splits and
    bound.  The bound is two f32 instructions per (i, j, k) in every mode:
    logminplus's max and skip test are minmax's two, and the skip shows
    that the SFU work of a combine a triple does not need is no part of
    the least time."""
    import torch

    from repro_torch.dist import roofline
    from repro_torch.kernels import _build
    from repro_torch.kernels.qpath.qpath import (
        MODE_CODES, TILE, WAVES, qpath_matmul_cuda, split_plan,
    )
    from repro_torch.kernels.qpath.ref import qpath_matmul_ref

    (m, kd), n = A.shape, B.shape[1]
    out = qpath_matmul_cuda(A, B, mode=mode)
    ref_q = qpath_matmul_ref(A, B, mode=mode)
    fin = torch.isfinite(ref_q)
    same_inf = torch.equal(fin, torch.isfinite(out)) and torch.equal(out[~fin], ref_q[~fin])
    err = float((out[fin] - ref_q[fin]).abs().max())
    ok = same_inf and (torch.equal(out, ref_q) if mode != "logminplus"
                       else err <= LOGMINPLUS_ATOL)
    if not ok:
        fail(f"qpath {mode} ({what}) disagrees with its plain version (max err {err})")
    slots = _build.resident_slots("qpath_blocks_per_sm", (MODE_CODES[mode],), A.device)
    return {
        "shape": [m, kd, n],
        "finite_share": float(torch.isfinite(A).float().mean()),
        "splits": split_plan(m, kd, n, slots, TILE[mode], WAVES[mode])[0],
        "max_abs_err": err,
        "ms": cuda_ms(lambda: qpath_matmul_cuda(A, B, mode=mode), 5),
        "plain_ms": cuda_ms(lambda: qpath_matmul_ref(A, B, mode=mode), 2),
        "bound": _bound(*roofline.qpath_work(m, kd, n)),
    }


def _qpath_row(mode: str, sweep: str, A) -> dict:
    """The kernel on a fixed 2048^3 operand (``sweep``: the first or the
    last of a doubling projection); no window runs it."""
    got = _qpath_sweep(mode, A, A, f"{sweep} sweep")
    return {
        "name": "qpath", "case": f"{mode} {A.shape[0]}^3 {sweep} sweep",
        "path": None, "idle": NO_QPATH_WINDOW, "counter": f"qpath/{mode}",
        "source": "src/repro_torch/csrc/qpath.cu",
        "replaces": "src/repro/kernels/qpath/qpath.py:45",
        **{k: got[k] for k in ("finite_share", "splits", "max_abs_err", "ms", "plain_ms",
                               "bound")},
        "library_ms": None,
    }


def phase_qpath_windows(sweeps: dict) -> list[dict]:
    """The kernel on every sweep operand each window of ``QPATH_WINDOWS``
    ran, recorded in that window, each held against its plain version.
    One row a window: ``ms`` and ``plain_ms`` are the means over its
    sweeps, so ms x launches is the window's kernel time, and ``bound``
    the mean of the sweeps' bounds; each sweep's own reading is in
    ``sweeps``."""
    rows = []
    for window in QPATH_WINDOWS:
        ops = sweeps[window]
        modes = {mode for mode, _, _ in ops}
        if len(modes) != 1 or len(ops) != QPATH_WINDOWS[window]:
            fail(f"{window}: recorded {len(ops)} products in modes {sorted(modes)}, "
                 f"want {QPATH_WINDOWS[window]} in one mode")
        mode = modes.pop()
        got = [_qpath_sweep(mode, A, A if B is None else B, f"{window}, sweep {t}")
               for t, (mode, A, B) in enumerate(ops)]
        def mean(key):
            return sum(g[key] for g in got) / len(got)

        bounds = [g["bound"] for g in got]
        m, kd, n = got[0]["shape"]
        rows.append({
            "name": "qpath", "case": f"{mode} {m}x{kd}x{n} {window}, {len(got)} products",
            "path": window, "idle": None, "counter": f"qpath/{mode}",
            "source": "src/repro_torch/csrc/qpath.cu",
            "replaces": "src/repro/kernels/qpath/qpath.py:45",
            "max_abs_err": max(g["max_abs_err"] for g in got),
            "ms": mean("ms"), "plain_ms": mean("plain_ms"), "library_ms": None,
            "bound": {"ms": sum(b["ms"] for b in bounds) / len(bounds),
                      "by": "operations" if all(b["by"] == "operations" for b in bounds)
                      else "bytes"},
            "sweeps": [{k: g[k] for k in ("shape", "finite_share", "splits", "max_abs_err",
                                         "ms", "plain_ms")} for g in got],
        })
        log("kernel " + json.dumps(rows[-1]))
        del ops[:]
    return rows


def _int8_geometry(ptxas: dict, m: int, n: int, k: int, dev) -> dict:
    """The int8 scan instance a call at this shape runs, as the wrapper
    picks it: column splits, rows per block, dynamic shared memory, and the
    instance's registers, static shared memory and spill bytes (d = 784
    takes the 16-byte copies)."""
    from repro_torch.kernels.topk import topk as topk_mod

    rows = topk_mod.int8_rows_per_block(k)
    wide = k > topk_mod.SMEM_MAX_K
    # csrc/topk_int8.cu:smem_bytes: a 3-stage ring of (rows + 128) slices
    # of 144 bytes with the tile's 128 norms and mask bytes, 33 survivor
    # slots a row, and (shared lists) k + 1 entries a row, 8 bytes each
    smem = 3 * ((rows + 128) * 144 + 128 * 5) + 8 * rows * 33
    if not wide:
        smem += 8 * rows * (k + 1)
    instance = f"topk_int8_kernel<{int(wide)},1>"
    return {"splits": len(topk_mod.int8_plan(m, n, k, dev)), "rows_per_block": rows,
            "dynamic_smem_bytes": smem, "instance": instance, **ptxas[instance],
            "merge": ptxas["merge_kernel"]}


def _merge_row(name: str, replaces: str, path: str, counter: str, plan, k: int,
               split_topk) -> dict:
    """The merge of a scan's split lists (``topk.cu:merge_kernel``, run by
    the C entry ``topk_merge``) alone, on the lists of one serve batch:
    ``split_topk(a, b)`` is the plain version's top k of columns [a, b).
    Held bit for bit to its plain version (``ref.merge_splits_ref``); its
    launches are its scan's, one merge per counted call.  Its library time
    is ``torch.topk`` over each row's lists and a gather of the ids: the
    same k distances (checked equal), ties in another order."""
    import ctypes

    import torch

    from repro_torch.dist import roofline
    from repro_torch.kernels import _build
    from repro_torch.kernels.topk.ref import merge_splits_ref

    parts = [split_topk(a, b) for a, b in plan]
    part_d = torch.stack([p[0] for p in parts], 1).contiguous()
    part_i = torch.stack([torch.where(p[1] >= 0, p[1] + a, p[1])
                          for p, (a, _) in zip(parts, plan)], 1).contiguous()
    m, S = part_d.shape[:2]
    out_d = torch.empty((m, k), dtype=torch.float32, device=part_d.device)
    out_i = torch.empty((m, k), dtype=torch.int32, device=part_d.device)
    fn = _build.function("topk_merge", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                         + [ctypes.c_void_p])

    def merge():
        _build.check(fn(part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
                        out_i.data_ptr(), m, S, k, _build.stream_handle(part_d.device)),
                     "topk_merge")

    merge()
    rd, ri = merge_splits_ref(part_d, part_i, k)
    if not (torch.equal(out_d, rd) and torch.equal(out_i, ri)):
        fail(f"{name} merge disagrees with its plain version")

    def library():
        # the same merge by one library selection over the row's lists and
        # a gather of the ids (ties in another order; distances equal)
        vals, pos = torch.topk(part_d.view(m, -1), k, dim=1, largest=False)
        return vals, torch.gather(part_i.view(m, -1), 1, pos)

    if not torch.equal(library()[0], rd):
        fail(f"{name} merge: torch.topk's distances differ from the plain version's")
    # What the merge reads on these lists: each list's head, then the next
    # entry of a list each time one of its entries is taken (while it has
    # one): S + sum_s min(taken_s, k - 1) entries a row, 8 bytes each.  An
    # id of -1 (a row with fewer than k candidates) counts as one read.
    starts = torch.tensor([a for a, _ in plan], device=out_i.device)
    owner = torch.searchsorted(starts, out_i.long(), right=True) - 1
    taken = torch.zeros((m, S), dtype=torch.long, device=out_i.device)
    taken.scatter_add_(1, owner.clamp_min(0), (out_i >= 0).long())
    reads = m * S + int(taken.clamp_max(k - 1).sum()) + int((out_i < 0).sum())
    row = {
        "name": f"{name} merge", "case": f"merge of {m}x{S}x{k} split lists",
        "path": path, "idle": None, "counter": counter,
        "source": "src/repro_torch/csrc/topk.cu", "replaces": replaces,
        "max_abs_err": 0.0, "splits": S,
        "ms": cuda_ms(merge, 20),
        "plain_ms": cuda_ms(lambda: merge_splits_ref(part_d, part_i, k), 20),
        "library_ms": cuda_ms(library, 20),
        "bound": _bound(*roofline.merge_work(m, k, S, reads)),
    }
    log("kernel " + json.dumps(row))
    return row


def _bag_bound(ids, D: int, weighted: bool, elem: int = 4) -> dict:
    """Bytes the bag must move (``roofline.bag_work``): each distinct
    32-byte sector of the table rows its ids name (a D * elem-byte row spans
    whole sectors; a row several lookups share is read once), the ids (and
    weights) once, the (B, D) output once.  ``gathered_bytes`` counts the
    sectors per lookup instead (no reuse)."""
    from repro_torch.dist import roofline

    bound = _bound(*roofline.bag_work(ids, D, weighted=weighted, elem=elem))
    bound["gathered_bytes"] = roofline.bag_work(ids, D, weighted=weighted, elem=elem,
                                                reuse=False)[2]
    return bound


def bag_inputs(seed: int):
    """DeepFM's full-width (V, 1) and (V, embed_dim) tables (random, scale
    0.01 as declared; the latter also as bf16 and f16) and the bag cases
    phase 2 runs, with ids from ``recsys_batch`` as phase 7 serves them:
    (tables, [(case, table key, ids, weights, combine, window)]), window
    None where no window runs the case."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.configs.base import RECSYS_SHAPES
    from repro_torch.data.tokens import recsys_batch
    from repro_torch.models import recsys as recsys_lib

    dev = torch.device(DEVICE)
    sizes = {shape.name: shape.batch for shape in RECSYS_SHAPES}
    cfg = configs.get("deepfm")
    V = recsys_lib._padded_vocab(cfg)
    g = torch.Generator(device=dev).manual_seed(seed)
    tables = {D: torch.randn((V, D), generator=g, device=dev).mul_(0.01)
              for D in (1, cfg.embed_dim)}
    # the embedding table as bf16 and f16, read by the kernel in its own dtype
    tables["bf16"] = tables[cfg.embed_dim].to(torch.bfloat16)
    tables["f16"] = tables[cfg.embed_dim].to(torch.float16)
    offsets = recsys_lib.field_offsets(cfg, dev)

    def flat(step: int, batch: int):
        ids = recsys_batch(step, batch, cfg.vocabs, seed=seed)["ids"]
        return torch.as_tensor(ids, device=dev) + offsets[None, :]

    bulk = flat(0, sizes["serve_bulk"])
    rng = np.random.default_rng(seed)
    padded = torch.where(torch.as_tensor(rng.random(bulk.shape) < 0.1, device=dev),
                         -1, bulk)
    padded[0] = -1  # an all-padding bag
    w = torch.as_tensor(rng.uniform(0.5, 1.5, size=bulk.shape).astype(np.float32),
                        device=dev)
    B_bulk, E = bulk.shape[0], cfg.embed_dim
    return tables, [
        ("first-order term, DeepFM train_batch", 1, flat(0, sizes["train_batch"]), None,
         "sum", "deepfm train_batch"),
        ("first-order term, DeepFM serve_bulk", 1, bulk, None, "sum", "deepfm serve_bulk"),
        ("first-order term, DeepFM serve_p99", 1, flat(0, sizes["serve_p99"]), None,
         "sum", "deepfm serve_p99"),
        ("user embedding, DeepFM retrieval_cand", E, flat(0, sizes["retrieval_cand"]),
         None, "sum", "deepfm retrieval_cand"),
        ("user embeddings, infinity retrieval", E, flat(1, INF_USERS), None, "sum",
         "infinity retrieval"),
        ("launch floor, one id", 1, bulk[:1, :1], None, "sum", None),
        (f"pooled embeddings at the serve_bulk batch {B_bulk}", E, bulk, None, "sum", None),
        (f"pooled embeddings, bf16 table, at the serve_bulk batch {B_bulk}", "bf16", bulk,
         None, "sum", None),
        (f"pooled embeddings, f16 table, at the serve_bulk batch {B_bulk}", "f16", bulk,
         None, "sum", None),
        ("10 % padding ids, weights, sum", 1, padded, w, "sum", None),
        ("10 % padding ids, weights, sum", E, padded, w, "sum", None),
        ("10 % padding ids, weights, mean", 1, padded, w, "mean", None),
        ("10 % padding ids, weights, mean", E, padded, w, "mean", None),
    ]


def _bag_idle(key, ids, wts) -> str:
    if ids.numel() == 1:
        return NO_BAG_FLOOR
    if key in ("bf16", "f16"):
        return NO_BAG_HALF
    return NO_BAG_D10_BULK if wts is None else NO_BAG_EXTRAS


def _bag_rows(seed: int, ptxas: dict) -> list[dict]:
    """The embedding bag at DeepFM's full-width shapes (``bag_inputs``):
    each row bit-identical to its plain version (``torch.equal``), with the
    launch plan it ran, its blocks, and its instance's registers, shared
    memory and spill bytes; ``graph_ms`` is the kernel's device time per
    launch with no host work between launches (a CUDA graph of the same
    calls), where ``ms`` times back-to-back calls of the wrapper."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.bag.bag import embedding_bag_cuda, launch_plan
    from repro_torch.kernels.bag.ref import (
        TABLE_DTYPES, effective_weights, embedding_bag_ref,
    )

    tables, cases = bag_inputs(seed)
    sms = torch.cuda.get_device_properties(DEVICE).multi_processor_count
    rows = []
    for case, key, ids, wts, combine, path in cases:
        table = tables[key]
        D = table.shape[1]
        B, S = ids.shape
        out = embedding_bag_cuda(table, ids, wts, combine=combine)
        ref = embedding_bag_ref(table, ids, wts, combine=combine)
        err = float((out - ref).abs().max())
        if not torch.equal(out, ref):
            fail(f"bag {case} D={D} is not bit-identical to its plain version "
                 f"(max err {err})")
        library_ms = None
        # F.embedding_bag on a bf16 / f16 table sums in that dtype: not this
        # function
        if combine == "sum" and table.dtype == torch.float32:
            # the same function by PyTorch's own bag: the padding ids clamped
            # and their weights zeroed
            safe = ids.clamp_min(0).long()
            pw = (effective_weights(ids, wts)
                  if wts is not None or bool((ids < 0).any()) else None)
            lib = F.embedding_bag(safe, table, mode="sum", per_sample_weights=pw)
            if not torch.allclose(lib, ref, rtol=1e-5, atol=1e-6):
                fail(f"F.embedding_bag disagrees on {case} D={D}")
            library_ms = cuda_ms(
                lambda: F.embedding_bag(safe, table, mode="sum", per_sample_weights=pw), 20)
        plan = launch_plan(B, S, D, sms, weighted=wts is not None)
        code = TABLE_DTYPES.index(table.dtype)
        instance = (f"bag_warp_kernel<{code}>" if plan.warp else
                    f"bag_kernel<{code},{plan.chunk}>")
        reps = 20 if B * S < 10 ** 6 else 10
        rows.append({
            "name": "bag", "case": f"{case} {B}x{S} D={D} {combine}",
            "path": path, "idle": None if path else _bag_idle(key, ids, wts),
            "counter": "bag", "source": "src/repro_torch/csrc/bag.cu",
            "replaces": "src/repro/kernels/bag/bag.py:30",
            "max_abs_err": err,
            "ms": cuda_ms(lambda: embedding_bag_cuda(table, ids, wts, combine=combine), reps),
            "graph_ms": graph_ms(lambda: embedding_bag_cuda(table, ids, wts, combine=combine),
                                 reps),
            "plain_ms": cuda_ms(lambda: embedding_bag_ref(table, ids, wts, combine=combine),
                                reps),
            "library_ms": library_ms,
            "bound": _bag_bound(ids, D, wts is not None, table.element_size()),
            "plan": {k: getattr(plan, k) for k in ("threads", "bags", "chunk", "window",
                                                   "warp")},
            "blocks": -(-B // plan.bags), "dynamic_smem_bytes": plan.smem_bytes,
            "instance": instance, **ptxas[instance],
        })
        log("kernel " + json.dumps(rows[-1]))
    del tables, cases
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def _bag_backward_rows(seed: int, ptxas: dict) -> list[dict]:
    """The bag's backward (``bag_backward``, no TPU kernel: JAX's gradient
    is XLA's scatter-add) at the training path's shapes — DeepFM's
    first-order term at the train batch and at one xDeepFM microbatch, the
    (V, 1) table's 30 226 432 rows — and a D = 10 mean case with padding
    and weights (no window), each equal bit for bit to its plain version.
    The atomics sum a row in any order, so the rows take small integer
    weights and gradients (under ``mean`` an integer times the bag's weight
    sum): every contribution and partial sum is then an exact f32 integer
    and no order rounds.  ``ms`` times the wrapper:
    the zeroed (V, D) gradient and the kernel; ``library_ms`` the same
    zeroing and one ``index_add_`` of the precomputed w * g rows."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.data.tokens import recsys_batch
    from repro_torch.dist import roofline
    from repro_torch.kernels.bag.bag import embedding_bag_backward_cuda
    from repro_torch.kernels.bag.ref import bag_scale, embedding_bag_backward_ref
    from repro_torch.models import recsys as recsys_lib

    dev = torch.device(DEVICE)
    cfg = configs.get("deepfm")
    V = recsys_lib._padded_vocab(cfg)
    offsets = recsys_lib.field_offsets(cfg, dev)
    rng = np.random.default_rng(seed)

    def flat(step: int, batch: int):
        ids = recsys_batch(step, batch, cfg.vocabs, seed=seed)["ids"]
        return torch.as_tensor(ids, device=dev) + offsets[None, :]

    train = flat(0, TRAIN_BATCH)
    micro = flat(0, TRAIN_BATCH // XDEEPFM_MICROBATCHES)
    padded = torch.where(torch.as_tensor(rng.random(train.shape) < 0.1, device=dev), -1,
                         train)
    w = torch.as_tensor(rng.integers(1, 4, size=train.shape).astype(np.float32), device=dev)
    cases = [
        ("first-order gradient, DeepFM train_batch", train, None, 1, "sum",
         "deepfm train_batch"),
        ("first-order gradient, one xDeepFM microbatch", micro, None, 1, "sum",
         f"xdeepfm train_batch mb={XDEEPFM_MICROBATCHES}"),
        ("10 % padding ids, weights, mean", padded, w, 10, "mean", None),
    ]
    rows = []
    for case, ids, wts, D, combine, path in cases:
        B, S = ids.shape
        k = torch.as_tensor(rng.integers(-4, 5, size=(B, D)).astype(np.float32), device=dev)
        ew, div = bag_scale(ids, wts, combine)
        g = k * div
        # the most a row's partial sums reach: exact in f32 below 2^24
        reach = float(embedding_bag_backward_ref(k.abs(), ids, wts, V).max())
        if reach >= 2 ** 24:
            fail(f"bag_backward {case}: integer sums reach {reach}, not exact in f32")
        out = embedding_bag_backward_cuda(g, ids, wts, V, combine=combine)
        ref = embedding_bag_backward_ref(g, ids, wts, V, combine=combine)
        err = float((out - ref).abs().max())
        if not torch.equal(out, ref):
            fail(f"bag_backward {case} disagrees with its plain version (max err {err})")
        # the library's one call: index_add_ of the w * g rows (made beforehand)
        valid = (ids >= 0).reshape(-1)
        src = (ew[:, :, None] * (g / div)[:, None, :]).reshape(B * S, D)[valid].contiguous()
        rows_ids = ids.reshape(-1)[valid].long().contiguous()
        lib = torch.zeros((V, D), device=dev).index_add_(0, rows_ids, src)
        if not torch.equal(lib, ref):
            fail(f"index_add_ disagrees with the plain backward on {case}")
        del lib
        bound = _bound(*roofline.bag_backward_work(ids, D, V, weighted=wts is not None))
        # the bytes the scatter alone moves (ids, g, and a read and a write
        # of each of the B * S * D contributions' values), beside the bound
        bound["scatter_bytes"] = 4 * B * S * (2 if wts is not None else 1) + 4 * B * D \
            + 8 * int(valid.sum()) * D
        rows.append({
            "name": "bag_backward", "case": f"{case} {B}x{S} D={D} V={V} {combine}",
            "path": path, "idle": None if path else NO_BAG_BACKWARD_EXTRAS,
            "counter": "bag_backward", "source": "src/repro_torch/csrc/bag.cu",
            "replaces": "no TPU kernel: XLA's scatter-add, the VJP of jnp.take at "
                        "src/repro/dist/embedlookup.py:23",
            "max_abs_err": err, "bit_equal": True, "max_row_reach": reach,
            "ms": cuda_ms(lambda: embedding_bag_backward_cuda(g, ids, wts, V, combine=combine),
                          10),
            "plain_ms": cuda_ms(lambda: embedding_bag_backward_ref(g, ids, wts, V,
                                                                   combine=combine), 5),
            "library_ms": cuda_ms(lambda: torch.zeros((V, D), device=dev).index_add_(
                0, rows_ids, src), 10),
            "zero_fill_ms": cuda_ms(lambda: torch.zeros((V, D), device=dev), 10),
            "bound": bound, "threads_per_block": 256, "blocks": -(-B * D // 256),
            "instance": "bag_backward_kernel", **ptxas["bag_backward_kernel"],
        })
        log("kernel " + json.dumps(rows[-1]))
        del out, ref, src
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def _bound(ops: float, kind: str, nbytes: float) -> dict:
    """The least time for a kernel's work as ``repro_torch.dist.roofline``'s
    work functions give it — (ops, their kind, bytes) — against that
    module's H100 peaks: the larger of ops over their rate and bytes over
    the HBM rate."""
    from repro_torch.dist import roofline

    t_ops = ops / roofline.RATES[kind] * 1e3
    t_bytes = nbytes / roofline.HBM_BW * 1e3
    return {"ms": max(t_ops, t_bytes),
            "by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes}


# ---------------------------------------------------------------------------
# serving helpers (phases 3-6)
# ---------------------------------------------------------------------------

def _recall(approx, truth, k: int) -> float:
    a = approx[:, :k].cpu().numpy()
    t = truth[:, :k].cpu().numpy()
    return float(sum(len(set(x.tolist()) & set(y.tolist())) for x, y in zip(a, t))
                 / (k * len(a)))


def _check_result(res, B: int, k: int, n: int, what: str) -> None:
    import torch

    idx, dist, comps = res
    if tuple(idx.shape) != (B, k) or tuple(dist.shape) != (B, k):
        fail(f"{what}: shapes {tuple(idx.shape)} / {tuple(dist.shape)}, want ({B}, {k})")
    if not bool(((idx >= 0) & (idx < n)).all()):
        fail(f"{what}: ids out of range")
    if not bool(torch.isfinite(dist).all()):
        fail(f"{what}: non-finite distances")
    if k > 1 and not bool((dist[:, 1:] >= dist[:, :-1]).all()):
        fail(f"{what}: distances not ascending")
    if not bool((comps > 0).all()):
        fail(f"{what}: zero comparisons")


def _serve(search, Qt, n: int, what: str):
    """Serve ``Qt`` in batches of ``BATCH`` through ``search``, each batch
    synchronised and checked.  Returns (seconds per batch, ids, dists,
    comparisons) over all queries."""
    import torch

    times, ids, dists, comps = [], [], [], []
    for start in range(0, Qt.shape[0], BATCH):
        t0 = time.perf_counter()
        res = search(Qt[start:start + BATCH])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        _check_result(res, min(BATCH, Qt.shape[0] - start), K, n, f"{what} batch at {start}")
        ids.append(res.idx)
        dists.append(res.dist)
        comps.append(res.comparisons)
    return times, torch.cat(ids), torch.cat(dists), torch.cat(comps)


def _rates(times: list, queries: int) -> dict:
    """p50 over the full batches and QPS over all of them."""
    import numpy as np

    full = [t for t, s in zip(times, range(0, queries, BATCH)) if queries - s >= BATCH]
    return {"p50_batch_ms": float(np.median(full)) * 1e3,
            "qps": float(queries / sum(times))}


def _infinity_full_width(label: str, corpus, Qt, cfg: dict, metric: str,
                         build_want: dict, gt_counter: str,
                         sweeps: list | None = None) -> tuple[dict, dict]:
    """Build an infinity index over ``corpus`` from ``cfg`` (a counted
    window, its sweep operands recorded into ``sweeps``), take the exact
    ground truth by the topk kernel (a counted window), and serve ``Qt``:
    beam batches, one best-first batch of 32 and one k=1 search (a counted
    window).  Returns (the printed row, the state later phases reuse)."""
    import torch

    from repro_torch.core import index as index_lib
    from repro_torch.core import scan as scan_lib

    dev = torch.device(DEVICE)
    n = corpus.shape[0]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with recorded_sweeps(sweeps):
        index, build_counts = counted(lambda: index_lib.build("infinity", corpus, cfg,
                                                              device=dev))
    build_s = time.perf_counter() - t0
    require(build_counts, build_want, f"{label} build")
    t0 = time.perf_counter()
    (gt_d, gt), gt_counts = counted(lambda: scan_lib.topk_scan(Qt, index.X, k=K,
                                                               metric=metric))
    gt_s = time.perf_counter() - t0
    require(gt_counts, {gt_counter: 1}, f"{label} ground truth")

    def serve():
        # first batch: also flattens the tree for the beam (lazy)
        t0 = time.perf_counter()
        first = index.search(Qt[:BATCH], k=K, **SEARCH_KW)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        beam = _serve(lambda q: index.search(q, k=K, **SEARCH_KW), Qt, n, f"{label} beam")
        bf = index.search(Qt[:32], k=K, **SEARCH_KW)
        torch.cuda.synchronize()
        _check_result(bf, 32, K, n, f"{label} best_first batch")
        desc = index.search(Qt[:BATCH], k=1, mode="auto")
        torch.cuda.synchronize()
        _check_result(desc, BATCH, 1, n, f"{label} descend batch")
        return first, first_s, beam, bf, desc

    (first, first_s, beam, bf, desc), serve_counts = counted(serve)
    peak = torch.cuda.max_memory_allocated()
    beams = 1 + -(-Qt.shape[0] // BATCH)  # the first batch and every served one
    # every search reranks its candidates by the re-score kernel once: the
    # beam batches, the best-first batch and the descent
    if (serve_counts["beam/levels"], serve_counts["rescore"]) != (beams, beams + 2):
        fail(f"{label} serve: launch counts {serve_counts}, want beam/levels == {beams}, "
             f"rescore == {beams + 2}")
    times, found, _, comps = beam
    row = {
        "corpus": list(corpus.shape), "queries": int(Qt.shape[0]),
        "config": cfg or "IndexConfig() defaults", "search": SEARCH_KW | {"k": K},
        "build_seconds": build_s,
        "stage_seconds": index.train_history["stage_seconds"],
        "validation": index.train_history["validation"],
        "ground_truth_seconds": gt_s, "first_batch_seconds": first_s,
        "recall@10": _recall(found, gt, K),
        "recall@10_best_first_32": _recall(bf.idx, gt[:32], K),
        "recall@1_descend": _recall(desc.idx, gt[:BATCH], 1),
        **_rates(times, Qt.shape[0]),
        "mean_comparisons_beam": float(comps.float().mean()),
        "peak_memory_bytes": int(peak),
        "launches": {"build": build_counts, "ground_truth": gt_counts,
                     "serve": serve_counts},
    }
    return row, {"index": index, "gt": gt, "gt_d": gt_d, "found": found}


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------

def _full_width_data(seed: int):
    import torch

    from repro_torch.data import synthetic

    t0 = time.perf_counter()
    pool = synthetic.fashion_like(CORPUS + QUERIES, seed=seed)
    data_s = time.perf_counter() - t0
    return pool[:CORPUS], torch.as_tensor(pool[CORPUS:], device=DEVICE), data_s


def phase_main_path(corpus, Qt, data_s: float, sweeps: dict) -> tuple[dict, dict]:
    sweeps["full-width build"] = []
    main, state = _infinity_full_width(
        "full-width", corpus, Qt, {}, "euclidean",
        {"topk/f32": 1, "pdist/matmul": 1, "qpath/minmax": NUM_HOPS}, "topk/f32",
        sweeps["full-width build"])
    main["data_seconds"] = data_s
    log("main_path " + json.dumps(main))
    if main["recall@10"] < FULL_RECALL_FLOOR:
        fail(f"full-width beam recall@10 {main['recall@10']} < {FULL_RECALL_FLOOR}")
    if main["recall@10_best_first_32"] < BEST_FIRST_FLOOR:
        fail(f"full-width best-first recall@10 {main['recall@10_best_first_32']} "
             f"< {BEST_FIRST_FLOOR}")
    return main, state


def _beam_rows(state: dict, Qt) -> list[dict]:
    """The beam's level loop (``csrc/beam.cu``; no TPU kernel behind it: the
    JAX package's ``_beam_impl`` is jnp under ``jax.jit``) on phase 3's
    flattened tree at the b512 cells' plan, against its plain version on the
    card, at q = inf (the index's; its launches are the serving window's)
    and q = 2.  The bound counts the bytes the levels read as
    ``tools/profile_beam.py`` does: a scored vantage its row and 24 bytes of
    node arrays, a ranked bucket its centroid row, the queries and the
    outputs, at the HBM rate."""
    import torch

    from repro_torch.core import embedding as embed_lib
    from repro_torch.core import vptree
    from repro_torch.kernels.beam.beam import beam_cuda

    index = state["index"]
    flat, Zf, _ = index._flat_view()
    with torch.no_grad():
        Zq = embed_lib.apply(index.phi, Qt[:BATCH]).contiguous()
    B, d = Zq.shape
    K = SEARCH_KW["rerank"]
    W, Bcap = vptree.beam_plan(SEARCH_KW["budget"], depth=flat.depth,
                               leaf_size=flat.leaf_size, num_nodes=flat.num_nodes,
                               num_buckets=flat.num_buckets, k=K)
    rows = []
    for q in (math.inf, 2.0):
        kw = dict(q=q, k=K, beam_width=W, bucket_cap=Bcap, X=Zf)
        name = f"beam levels q={q:g}"
        got = beam_cuda(flat, Zq, **kw)
        want = vptree.beam_levels(flat, Zq, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got[2:], want[2:])):
            fail(f"{name}: the kernel's buckets or counters differ from the plain version's")
        err, close = close_matmul(got[0], want[0])
        # ids equal, or the plain distance at that rank ties a neighbour's
        # (the last rank's partner is not returned)
        same = got[1] == want[1]
        tol = MATMUL_ATOL + MATMUL_RTOL * want[0].abs()
        gap = (want[0][:, 1:] - want[0][:, :-1]).abs() <= tol[:, :-1]
        near = torch.zeros_like(same)
        near[:, :-1] |= gap
        near[:, 1:] |= gap
        near[:, -1] = True
        if not (close and bool((same | near).all())):
            fail(f"{name}: distances off by {err}, ids equal at "
                 f"{float(same.float().mean())}, some off the near ties")
        c_trav, c_cent = (float(c.sum()) for c in want[3:])
        nbytes = (c_trav * (d * 4 + 24) + c_cent * d * 4 + B * d * 4
                  + B * (K * 12 + Bcap * 8 + 16))
        row = {
            "name": "beam", "case": f"{name}: B {B}, d {d}, W {W}, Bcap {Bcap}, K {K}, "
                                    f"depth {flat.depth}",
            "path": "full-width serve" if math.isinf(q) else None,
            "idle": None if math.isinf(q) else "q = 2: phase 3's index is at q = inf",
            "counter": "beam/levels", "source": "src/repro_torch/csrc/beam.cu",
            "replaces": "none (src/repro/core/vptree.py:642 _beam_impl is jnp under jax.jit)",
            "max_abs_err": err, "ids_equal": float(same.float().mean()),
            "bit_equal": bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])),
            "vantages": c_trav / B, "centroids": c_cent / B,
            "ms": cuda_ms(lambda: beam_cuda(flat, Zq, **kw), 20),
            "plain_ms": cuda_ms(lambda: vptree.beam_levels(flat, Zq, **kw), 3),
            "library_ms": None,
            "bound": _bound(0.0, "f32", nbytes),
        }
        log("kernel " + json.dumps(row))
        rows.append(row)
    return rows


def _rescore_rows(state: dict, Qt, seed: int) -> list[dict]:
    """The exact re-score of gathered candidate lists (``csrc/rescore.cu``;
    no TPU kernel behind it: the JAX package's ``topk_candidates`` is jnp
    under ``vmap``) over phase 3's corpus at the cells' shapes, against its
    plain version (``core/scan._plain_candidates``) on the same card
    inputs: 512 lists of each query's ``LIVE_KPRIME`` nearest rows with
    ``LIVE_DELETED`` rows deleted (their ids -1, ~5 % a list: the live
    cell's frozen oversample) and of its 256 nearest (the rerank's width),
    k 10.  Ids equal but on near ties, distances within the f32 tolerance.
    The bound is ``dist/roofline.rescore_work``'s bytes at the HBM rate,
    each distinct alive row once (L2 serves a row several lists share);
    ``lists_bound_ms`` reads every list's alive rows from device memory."""
    import torch

    from repro_torch.core import scan as scan_lib
    from repro_torch.dist import roofline
    from repro_torch.kernels.rescore.rescore import rescore_cuda

    X = state["index"].X
    Q = Qt[:BATCH].contiguous()
    (n, d), B = X.shape, Q.shape[0]
    g = torch.Generator(device=X.device).manual_seed(seed)
    dead = torch.zeros(n, dtype=torch.bool, device=X.device)
    dead[torch.randperm(n, generator=g, device=X.device)[:LIVE_DELETED]] = True
    rows = []
    for C, path, what in (
            (LIVE_KPRIME, "live brute f32 serve",
             "the live cell's frozen oversample (the live window's lists are k' 1024 wide)"),
            (SEARCH_KW["rerank"], "full-width serve", "the rerank")):
        _, cand = scan_lib.topk_scan(Q, X, k=C, metric="euclidean")
        cand = cand.long()
        if C == LIVE_KPRIME:
            cand = torch.where(dead[cand], -1, cand)
        cand = cand.contiguous()
        got = rescore_cuda(Q, cand, X, k=K, metric="euclidean")
        want = scan_lib._plain_candidates(Q, cand, X, k=K + 1, metric="euclidean")
        torch.cuda.synchronize()
        err, close = close_matmul(got[1], want[1][:, :K])
        same, ids_ok = ids_agree(got[0], want[0], want[1], K)
        name = f"rescore C={C}"
        if not (close and ids_ok):
            fail(f"{name}: distances off by {err}, ids equal at {same}, some off the "
                 f"near ties")
        alive = cand[cand >= 0]
        row = {
            "name": "rescore", "case": f"{what}: B {B}, C {C}, n {n}, d {d}, k {K}",
            "path": path, "idle": None, "counter": "rescore",
            "source": "src/repro_torch/csrc/rescore.cu",
            "replaces": "none (src/repro/core/scan.py:241 topk_candidates is jnp under vmap)",
            "max_abs_err": err, "ids_equal": same,
            "alive_share": alive.numel() / cand.numel(),
            "unique_rows": int(torch.unique(alive).numel()),
            "ms": cuda_ms(lambda: rescore_cuda(Q, cand, X, k=K, metric="euclidean"), 20),
            "plain_ms": cuda_ms(lambda: scan_lib._plain_candidates(
                Q, cand, X, k=K, metric="euclidean"), 3),
            "library_ms": None,
            "bound": _bound(*roofline.rescore_work(cand, d, K)),
            "lists_bound_ms": 4 * alive.numel() * d / roofline.HBM_BW * 1e3,
        }
        log("kernel " + json.dumps(row))
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phase 4: recall parity at the bench_infinity config
# ---------------------------------------------------------------------------

def _bench_data(seed: int):
    import torch

    from repro_torch.core import scan as scan_lib
    from repro_torch.data import synthetic

    pool = synthetic.make("manifold", BENCH_N + BENCH_Q, seed=seed)
    corpus, Qt = pool[:BENCH_N], torch.as_tensor(pool[BENCH_N:], device=DEVICE)
    _, gt = scan_lib.topk_scan(Qt, torch.as_tensor(corpus, device=DEVICE), k=K)
    return corpus, Qt, gt


def _bench_build(corpus, Qt, gt, q: float, extra: dict, what: str,
                 sweeps: list | None = None) -> dict:
    """Build the bench config at q (plus ``extra`` cfg keys) as a counted
    window, its sweep operands recorded into ``sweeps``, search all queries
    with its defaults and read recall@10."""
    import torch

    from repro_torch.core import index as index_lib

    t0 = time.perf_counter()
    with recorded_sweeps(sweeps):
        index, counts = counted(lambda: index_lib.build("infinity", corpus, {
            "q": q, "proj_sample": 512, "train_steps": 300,
            "budget": 1024, "rerank": 256, **extra,
        }, device=DEVICE))
    build_s = time.perf_counter() - t0
    sweeps = "qpath/minmax" if math.isinf(q) else "qpath/logminplus"
    require(counts, {"topk/f32": 1, "pdist/matmul": 1, sweeps: NUM_HOPS}, what)
    res = index.search(Qt, k=K)
    torch.cuda.synchronize()
    _check_result(res, Qt.shape[0], K, BENCH_N, what)
    return {"q": "inf" if math.isinf(q) else f"{q:g}",
            "beam_recall@10": _recall(res.idx, gt, K), "build_seconds": build_s,
            "validation": index.train_history["validation"],
            "stage_seconds": index.train_history["stage_seconds"], "launches": counts,
            "quant_store": getattr(index, "quant", None) is not None}


def phase_parity(bench, sweeps: dict) -> list[dict]:
    rows = []
    for q, target in BENCH_TARGETS.items():
        what = f"bench-config build q={q:g}"
        sweeps[what] = []
        row = _bench_build(*bench, q, {}, what, sweeps[what])
        row["target"] = target
        rows.append(row)
        log("parity " + json.dumps(row))
        rec = row["beam_recall@10"]
        if abs(rec - target) > RECALL_SLACK:
            fail(f"beam recall@10 {rec} at q={q} is not within {RECALL_SLACK} "
                 f"of {target}")
    return rows


# ---------------------------------------------------------------------------
# phase 5: quantized serving at full width
# ---------------------------------------------------------------------------

def phase_quant(corpus, Qt, main_state: dict, bench, parity: list[dict]) -> list[dict]:
    import torch

    from repro_torch.core import index as index_lib
    from repro_torch.core import quant as quant_lib

    n, d = corpus.shape
    nq = Qt.shape[0]
    batches = -(-nq // BATCH)
    gt, gt_d = main_state["gt"], main_state["gt_d"]
    rows = []

    def row_of(engine, times, ids, comps, counts, scanned) -> dict:
        return {"engine": engine, "corpus": [n, d], "queries": nq, "k": K,
                "recall@10": _recall(ids, gt, K), **_rates(times, nq),
                "mean_comparisons": float(comps.float().mean()),
                "corpus_bytes_per_query": scanned, "launches": counts}

    # brute, f32: the same kernel as the ground truth, batch by batch
    eng = index_lib.build("brute", corpus, {}, device=DEVICE)
    (times, ids, dists, comps), counts = counted(
        lambda: _serve(lambda q: eng.search(q, k=K), Qt, n, "brute f32"))
    require(counts, {"topk/f32": batches}, "brute f32 serve")
    rows.append(row_of("brute", times, ids, comps, counts, 4 * n * d))
    log("quant " + json.dumps(rows[-1]))
    if rows[-1]["recall@10"] < 1.0:
        # only near ties may differ: the returned distances are the truth's
        err, ok = close_matmul(dists, gt_d)
        if not ok:
            fail(f"brute f32 recall@10 {rows[-1]['recall@10']} with distances off "
                 f"the ground truth by {err}")
    del eng

    # brute with the quant key: int8 first pass, exact rerank of K_QUANT
    eng = index_lib.build("brute", corpus, {"quant": True}, device=DEVICE)
    if quant_lib.shortlist_width(K, n) != K_QUANT:
        fail(f"shortlist width {quant_lib.shortlist_width(K, n)} != {K_QUANT}")
    (times, ids, _, comps), counts = counted(
        lambda: _serve(lambda q: eng.search(q, k=K), Qt, n, "brute int8"))
    require(counts, {"topk/int8": batches, "rescore": batches}, "quantized brute serve")
    rows.append(row_of("brute+quant", times, ids, comps, counts,
                       n * d + 4 * K_QUANT * d))
    log("quant " + json.dumps(rows[-1]))
    if rows[-1]["recall@10"] < QUANT_BRUTE_FLOOR:
        fail(f"quantized brute recall@10 {rows[-1]['recall@10']} < {QUANT_BRUTE_FLOOR}")
    if not bool((comps == n + K_QUANT).all()):
        fail("quantized brute comparisons are not n + K")
    del eng

    # phase 3's infinity index with a store attached (what the quant key
    # does at build): beam buckets on int8 codes of the embedding, the
    # rerank's 256 candidates prefiltered to shortlist_width(10, n) on codes
    index = main_state["index"]
    index_lib.attach_quant_store(index, quant_lib.QuantStore.build(index.X))
    w = quant_lib.shortlist_width(K, n)
    (times, ids, _, comps), counts = counted(
        lambda: _serve(lambda q: index.search(q, k=K, **SEARCH_KW), Qt, n,
                       "infinity+quant"))
    require(counts, {"beam/levels": batches, "rescore": batches}, "infinity+quant serve")
    row = row_of("infinity+quant", times, ids, comps, counts,
                 d * SEARCH_KW["rerank"] + 4 * d * w)
    row["overlap@10_with_f32"] = _recall(ids, main_state["found"], K)
    row["f32_corpus_bytes_per_query"] = 4 * d * SEARCH_KW["rerank"]
    rows.append(row)
    log("quant " + json.dumps(row))
    if row["overlap@10_with_f32"] < QUANT_OVERLAP_FLOOR:
        fail(f"infinity+quant overlap {row['overlap@10_with_f32']} with its f32 "
             f"answers < {QUANT_OVERLAP_FLOOR}")

    # the registry's quant key at the bench config: within RECALL_SLACK of
    # the same build without it (phase 4, q=inf)
    row = _bench_build(*bench, math.inf, {"quant": True},
                       "bench-config build q=inf quant")
    f32 = next(p for p in parity if p["q"] == "inf")["beam_recall@10"]
    row["engine"], row["f32_beam_recall@10"] = "infinity bench config, quant key", f32
    rows.append(row)
    log("quant " + json.dumps(row))
    if not row["quant_store"] or abs(row["beam_recall@10"] - f32) > RECALL_SLACK:
        fail(f"bench-config quant build: store {row['quant_store']}, recall "
             f"{row['beam_recall@10']} vs f32 {f32}")
    return rows


# ---------------------------------------------------------------------------
# phase 6: the manhattan path at full width
# ---------------------------------------------------------------------------

def phase_manhattan(corpus, Qt) -> dict:
    row, _ = _infinity_full_width(
        "manhattan", corpus, Qt, {"metric": "manhattan"}, "manhattan",
        {"topk/cube": 1, "pdist/cube": 1, "qpath/minmax": NUM_HOPS}, "topk/cube")
    log("manhattan " + json.dumps(row))
    if row["recall@10"] < MANHATTAN_RECALL_FLOOR:
        fail(f"manhattan beam recall@10 {row['recall@10']} < {MANHATTAN_RECALL_FLOOR}")
    if row["recall@10_best_first_32"] < MANHATTAN_BEST_FIRST_FLOOR:
        fail(f"manhattan best-first recall@10 {row['recall@10_best_first_32']} "
             f"< {MANHATTAN_BEST_FIRST_FLOOR}")
    return row


# ---------------------------------------------------------------------------
# phase 7: recsys serving at full width
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_bag():
    """Within: the recsys model's embedding bags run the plain version on
    the card (it launches no kernel) — what each window's kernel path is
    held against."""
    from repro_torch.kernels.bag.ref import embedding_bag_ref
    from repro_torch.models import recsys as recsys_lib

    saved = recsys_lib.embedding_bag
    recsys_lib.embedding_bag = embedding_bag_ref
    try:
        yield
    finally:
        recsys_lib.embedding_bag = saved


def _timed_calls(fn, reps: int, warmup: int = 2):
    """``warmup`` calls, then ``reps`` calls, each synchronised and timed
    on the host clock.  Returns (the last result, seconds per timed call)."""
    import torch

    times = []
    for i in range(reps + warmup):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(time.perf_counter() - t0)
    return out, times


def _mlp_gflop(cfg, batch: int) -> float:
    D, Fs = cfg.embed_dim, cfg.n_sparse
    if cfg.interaction == "fm2" or not cfg.mlp:
        return 0.0
    dims = (Fs * D,) + tuple(cfg.mlp) + (1,)
    return 2.0 * batch * sum(a * b for a, b in zip(dims, dims[1:])) / 1e9


def _recsys_serve(arch: str, cfg, model, shape, seed: int) -> dict:
    """One serve window (``make_serve_step``) at ``shape``: p50, examples/s,
    peak memory; the logits against the plain bag's."""
    import numpy as np
    import torch

    from repro_torch.data.tokens import recsys_batch
    from repro_torch.models import recsys as recsys_lib
    from repro_torch.train.train_step import make_serve_step

    B = shape.batch
    ids = torch.as_tensor(recsys_batch(0, B, cfg.vocabs, seed=seed)["ids"], device=DEVICE)
    serve = make_serve_step(cfg, "recsys")
    reps = BULK_REPS.get(arch, SERVE_REPS[shape.name]) if shape.name == "serve_bulk" \
        else SERVE_REPS[shape.name]
    torch.cuda.reset_peak_memory_stats()
    (probs, times), counts = counted(
        lambda: _timed_calls(lambda: serve(model, {"ids": ids}), reps))
    peak = torch.cuda.max_memory_allocated()
    what = f"{arch} {shape.name}"
    require(counts, {"bag": reps + 2}, what)
    if tuple(probs.shape) != (B,) or not bool(torch.isfinite(probs).all()):
        fail(f"{what}: probabilities of shape {tuple(probs.shape)}, finite "
             f"{bool(torch.isfinite(probs).all())}")
    with torch.inference_mode():
        logits = recsys_lib.recsys_forward(model, ids, cfg)
        with plain_bag():
            plain, plain_counts = counted(lambda: recsys_lib.recsys_forward(model, ids, cfg))
    require(plain_counts, {}, f"{what} with the plain bag")
    if not bool(torch.isfinite(logits).all()):
        fail(f"{what}: non-finite logits")
    err, ok = close_matmul(logits, plain, rtol=RECSYS_RTOL, atol=RECSYS_ATOL)
    if not ok:
        fail(f"{what}: logits off the plain bag's by {err}")
    p50 = float(np.median(times))
    return {"arch": arch, "shape": shape.name, "batch": B,
            "p50_ms": p50 * 1e3, "examples_per_s": B / p50,
            "mean_ms": float(np.mean(times)) * 1e3, "calls_timed": reps,
            "peak_memory_bytes": int(peak), "mlp_gflop": _mlp_gflop(cfg, B),
            "logits_max_abs_err_vs_plain_bag": err,
            "logits_mean_abs": float(logits.abs().mean()),
            "launches": counts, "plain_bag_launches": plain_counts}


def _recsys_retrieval(cfg, model, shape, seed: int) -> dict:
    """The retrieval_cand window (``make_retrieval_step``): 1 query against
    ``shape.n_candidates`` random candidates, top RETRIEVAL_K."""
    import numpy as np
    import torch

    from repro_torch.data.tokens import recsys_batch
    from repro_torch.train.train_step import make_retrieval_step

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    batch = {"ids": torch.as_tensor(recsys_batch(0, shape.batch, cfg.vocabs,
                                                 seed=seed)["ids"], device=dev),
             "candidates": torch.randn((shape.n_candidates, cfg.embed_dim),
                                       generator=g, device=dev)}
    step = make_retrieval_step(cfg, k=RETRIEVAL_K)
    torch.cuda.reset_peak_memory_stats()
    ((scores, ids), times), counts = counted(
        lambda: _timed_calls(lambda: step(model, batch), RETRIEVAL_REPS))
    peak = torch.cuda.max_memory_allocated()
    require(counts, {"bag": RETRIEVAL_REPS + 2}, "deepfm retrieval_cand")
    with plain_bag():
        (pscores, pids), plain_counts = counted(lambda: step(model, batch))
    require(plain_counts, {}, "deepfm retrieval_cand with the plain bag")
    if not (torch.equal(ids, pids) and torch.equal(scores, pscores)):
        fail("retrieval_cand: ids or scores differ from the plain bag's")
    # the k largest scores, whatever their tie order, by one library call
    with torch.inference_mode():
        from repro_torch.models.recsys import user_embedding

        full = user_embedding(model, batch["ids"], cfg) @ batch["candidates"].T
    top = torch.topk(full, RETRIEVAL_K, dim=1).values
    if not (torch.equal(scores, top) and tuple(ids.shape) == (shape.batch, RETRIEVAL_K)
            and bool(torch.isfinite(scores).all())
            and int(torch.unique(ids).numel()) == RETRIEVAL_K):
        fail("retrieval_cand: the top-k scores are not the k largest")
    p50 = float(np.median(times))
    return {"arch": "deepfm", "shape": shape.name, "batch": shape.batch,
            "candidates": shape.n_candidates, "k": RETRIEVAL_K,
            "p50_ms": p50 * 1e3, "queries_per_s": shape.batch / p50,
            "calls_timed": RETRIEVAL_REPS, "peak_memory_bytes": int(peak),
            "ids_identical_to_plain_bag": True, "launches": counts,
            "plain_bag_launches": plain_counts,
            "selection": "stable descending sort of the scores (lax.top_k's tie rule)"}


def inf_candidates(cfg, seed: int, dev):
    """The infinity retrieval's candidates: random normal, L2-normalised."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    cand = torch.as_tensor(rng.normal(size=(INF_CANDIDATES, cfg.embed_dim))
                           .astype(np.float32), device=dev)
    return cand / cand.norm(dim=1, keepdim=True)


def _infinity_retrieval(cfg, model, seed: int, sweeps: list) -> dict:
    """``examples/recsys_retrieval.py``'s flow with full-width DeepFM user
    embeddings: one counted window from the user embeddings to the search,
    its sweep operands recorded into ``sweeps``."""
    import torch

    from repro_torch.core.search import IndexConfig, InfinityIndex
    from repro_torch.data.tokens import recsys_batch
    from repro_torch.models.recsys import user_embedding

    dev = torch.device(DEVICE)
    cn = inf_candidates(cfg, seed, dev)
    ids = torch.as_tensor(recsys_batch(1, INF_USERS, cfg.vocabs, seed=seed)["ids"],
                          device=dev)

    def run():
        with torch.no_grad():
            users = user_embedding(model, ids, cfg)
        un = users / users.norm(dim=1, keepdim=True)
        t0 = time.perf_counter()
        with recorded_sweeps(sweeps):
            index = InfinityIndex.build(cn, IndexConfig(**INF_INDEX), device=dev)
        build_s = time.perf_counter() - t0
        res = index.search(un, **INF_SEARCH)
        return un, index, build_s, res

    t0 = time.perf_counter()
    (un, index, build_s, res), counts = counted(run)
    total_s = time.perf_counter() - t0
    require(counts, {"bag": 1, "topk/f32": 1, "pdist/matmul": 1,
                     "qpath/logminplus": NUM_HOPS, "rescore": 1}, "infinity retrieval")
    _check_result(res, INF_USERS, INF_SEARCH["k"], INF_CANDIDATES, "infinity retrieval")
    exact = torch.sort(-(un @ cn.T), dim=1, stable=True).indices[:, :INF_SEARCH["k"]]
    row = {"arch": "deepfm", "shape": "infinity retrieval", "users": INF_USERS,
           "candidates": INF_CANDIDATES, "index": INF_INDEX, "search": INF_SEARCH,
           "recall@10": _recall(res.idx, exact, INF_SEARCH["k"]),
           "mean_comparisons": float(res.comparisons.float().mean()),
           "build_seconds": build_s, "window_seconds": total_s,
           "stage_seconds": index.train_history["stage_seconds"],
           "launches": counts}
    if row["recall@10"] < INF_RETRIEVAL_FLOOR:
        fail(f"infinity retrieval recall@10 {row['recall@10']} < {INF_RETRIEVAL_FLOOR}")
    return row


def phase_recsys(seed: int, sweeps: dict) -> list[dict]:
    import torch

    from repro_torch import configs
    from repro_torch.configs.base import RECSYS_SHAPES
    from repro_torch.models.recsys import RecsysModel, _padded_vocab

    shapes = {s.name: s for s in RECSYS_SHAPES}
    dev = torch.device(DEVICE)
    rows = []
    for arch in RECSYS_ARCHS:
        cfg = configs.get(arch)
        t0 = time.perf_counter()
        model = RecsysModel.build(cfg, device=dev,
                                  generator=torch.Generator(device=dev).manual_seed(seed))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        table = (_padded_vocab(cfg), cfg.embed_dim)
        served = ("serve_p99", "serve_bulk", "retrieval_cand") if arch == "deepfm" \
            else ("serve_p99", "serve_bulk")
        for name in served:
            if shapes[name].kind == "retrieval":
                row = _recsys_retrieval(cfg, model, shapes[name], seed)
            else:
                row = _recsys_serve(arch, cfg, model, shapes[name], seed)
            row.update(table=list(table), init_seconds=init_s)
            rows.append(row)
            log("recsys " + json.dumps(row))
        if arch == "deepfm":
            sweeps["infinity retrieval"] = []
            rows.append(_infinity_retrieval(cfg, model, seed, sweeps["infinity retrieval"]))
            log("recsys " + json.dumps(rows[-1]))
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 8: filtered serving and the other engines at full width
# ---------------------------------------------------------------------------

def demo_attrs(n: int, seed: int) -> dict:
    """The serving corpus's attribute columns, as ``launch/serve.py``'s
    ``demo_attrs`` makes them: ``category`` c0..c7 round-robin, ``score``
    uniform [0, 1) from the seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {"category": [f"c{i % 8}" for i in range(n)],
            "score": rng.uniform(0.0, 1.0, size=n).astype(np.float32)}


def score_filter(s: float) -> dict:
    return {"score": {"range": [None, float(s)]}}


def _check_filtered(res, B: int, k: int, mask, what: str) -> int:
    """Shapes, ascending distances, every id -1 (and its distance +inf) or
    a row in range; returns ``leaked``, the count of returned ids that
    fail the filter."""
    import torch

    idx, dist, comps = res
    if tuple(idx.shape) != (B, k) or tuple(dist.shape) != (B, k):
        fail(f"{what}: shapes {tuple(idx.shape)} / {tuple(dist.shape)}, want ({B}, {k})")
    none = idx < 0
    if not (bool((idx < mask.shape[0]).all()) and torch.equal(none, torch.isinf(dist))):
        fail(f"{what}: ids out of range or -1 ids with finite distances")
    if k > 1 and not bool((dist[:, 1:] >= dist[:, :-1]).all()):
        fail(f"{what}: distances not ascending")
    if not bool((comps >= 0).all()):
        fail(f"{what}: negative comparisons")
    return int((~mask[idx.long().clamp_min(0)] & ~none).sum())


def _serve_filtered(search, Qt, mask, what: str):
    """``_serve`` for a filtered search: batches of ``BATCH``, each checked
    with ``_check_filtered``.  Returns (seconds per batch, ids, dists,
    comparisons, leaked)."""
    import torch

    times, ids, dists, comps, leaked = [], [], [], [], 0
    for start in range(0, Qt.shape[0], BATCH):
        t0 = time.perf_counter()
        res = search(Qt[start:start + BATCH])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        leaked += _check_filtered(res, min(BATCH, Qt.shape[0] - start), K, mask,
                                  f"{what} batch at {start}")
        ids.append(res.idx)
        dists.append(res.dist)
        comps.append(res.comparisons)
    return times, torch.cat(ids), torch.cat(dists), torch.cat(comps), leaked


@contextlib.contextmanager
def timed_stages(into: dict):
    """While the block runs, the seconds of every k-means, inverted-list
    and kNN-graph call an engine's build makes add up in ``into`` under
    their names (the card synchronised around each)."""
    import torch

    from repro_torch.core import baselines
    from repro_torch.core import knn_graph as knn_lib

    saved = [(baselines, "kmeans"), (baselines, "_build_lists"), (knn_lib, "knn_graph")]
    inner = {name: getattr(mod, name) for mod, name in saved}

    def spy(name):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner[name](*args, **kw)
            torch.cuda.synchronize()
            into[name] = into.get(name, 0.0) + time.perf_counter() - t0
            return out
        return run

    for mod, name in saved:
        setattr(mod, name, spy(name))
    try:
        yield into
    finally:
        for mod, name in saved:
            setattr(mod, name, inner[name])


def _filtered_truth(X, Qt, masks: dict) -> dict:
    """Per filter, the exact top K+1 over the passing rows (the topk kernel
    over ``X[mask]``), ids mapped back to the corpus: (dists, ids)."""
    import torch

    from repro_torch.core import scan as scan_lib

    out = {}
    for name, mask in masks.items():
        rows = torch.nonzero(mask).squeeze(1)
        d, i = scan_lib.topk_scan(Qt, X[rows], k=K + 1)
        out[name] = (d, torch.where(i >= 0, rows[i.long().clamp_min(0)], -1))
    return out


def _filtered_brute(eng, engine: str, Qt, masks: dict, specs: dict, truth: dict,
                    counter: str, windows: dict) -> list[dict]:
    """Serve every filter through ``eng`` (one counted window each: one
    ``counter`` launch per batch, the masked regime, and with the int8
    first pass one exact re-score of its shortlist) and hold it to the
    filtered truth: f32 under the f32 contract (ids equal except near
    ties), quant at recall >= ``QUANT_BRUTE_FLOOR``; leaked 0."""
    nq = Qt.shape[0]
    batches = -(-nq // BATCH)
    want = {counter: batches}
    if counter == "topk/int8":
        want["rescore"] = batches
    rows = []
    for name, spec in specs.items():
        mask = masks[name]
        (times, ids, dists, comps, leaked), counts = counted(
            lambda: _serve_filtered(lambda q: eng.search(q, k=K, filter=spec), Qt, mask,
                                    f"{engine} {name}"))
        require(counts, want, f"{engine} {name} serve")
        windows[f"filtered {engine} serve {name}"] = counts
        gt_d, gt = truth[name]
        row = {"engine": engine, "filter": name, "spec": spec,
               "n_pass": int(mask.sum()), "queries": nq, "k": K,
               "recall@10": _recall(ids, gt, K), "leaked": leaked, **_rates(times, nq),
               "mean_comparisons": float(comps.float().mean()), "launches": counts}
        if leaked:
            fail(f"{engine} {name}: {leaked} returned ids fail the filter")
        if counter == "topk/f32":
            err, ok = close_matmul(dists, gt_d[:, :K])
            same, ids_ok = ids_agree(ids, gt, gt_d, K)
            row.update(max_abs_err_vs_sub_corpus=err, ids_identical=same)
            if not (ok and ids_ok):
                fail(f"{engine} {name}: not the scan over the passing rows (max err "
                     f"{err}, identical ids {same})")
        elif row["recall@10"] < QUANT_BRUTE_FLOOR:
            fail(f"{engine} {name}: recall@10 {row['recall@10']} < {QUANT_BRUTE_FLOOR}")
        rows.append(row)
        log("filtered " + json.dumps(row))
    return rows


def _filtered_infinity(index, Qt, masks: dict, specs: dict, truth: dict) -> list[dict]:
    """Phase 3's index with the attribute store attached: beam at one batch
    of ``BATCH`` queries and best-first at 32, at ``INF_FILTER_S``, with
    phase 3's search knobs; each a counted window: the beam launches its
    level loop's kernel once (``beam/levels``, at the widened K of the
    filtered rerank), best-first no tree kernel (its walk runs in plain
    torch); both rerank by the re-score kernel once (``rescore``)."""
    import torch

    rows = []
    for s in INF_FILTER_S:
        name = f"score<={s:g}"
        mask, spec = masks[name], specs[name]
        for mode, B in (("beam", BATCH), ("best_first", 32)):
            def run():
                t0 = time.perf_counter()
                res = index.search(Qt[:B], k=K, filter=spec, **SEARCH_KW | {"mode": mode})
                torch.cuda.synchronize()
                return res, time.perf_counter() - t0

            (res, secs), counts = counted(run)
            require(counts, {"beam/levels": 1, "rescore": 1} if mode == "beam"
                    else {"rescore": 1}, f"filtered infinity {mode} {name}")
            leaked = _check_filtered(res, B, K, mask, f"filtered infinity {mode} {name}")
            row = {"engine": "infinity", "mode": mode, "filter": name,
                   "n_pass": int(mask.sum()), "queries": B,
                   "search": SEARCH_KW | {"mode": mode, "k": K},
                   "recall@10": _recall(res.idx, truth[name][1][:B], K), "leaked": leaked,
                   "seconds": secs, "mean_comparisons": float(res.comparisons.float().mean()),
                   "launches": counts}
            if leaked:
                fail(f"filtered infinity {mode} {name}: {leaked} ids fail the filter")
            rows.append(row)
            log("filtered " + json.dumps(row))
    return rows


def _engine_full_width(engine: str, cfg: dict, attrs: dict, X, Qt, gt, masks, specs,
                       truth, build_want: dict, serve_want: dict,
                       windows: dict) -> tuple[dict, object]:
    """Build ``engine`` from ``cfg`` and the ``attrs`` columns over X
    through the registry (a counted window, the
    seconds of its stages taken), serve every query unfiltered and at
    score <= ``KERNEL_S`` (counted windows), and read recall@10, p50, QPS
    and peak memory.  Returns (the printed row, the engine)."""
    import torch

    from repro_torch.core import index as index_lib

    torch.cuda.reset_peak_memory_stats()
    stages: dict = {}
    t0 = time.perf_counter()
    with timed_stages(stages):
        eng, build_counts = counted(lambda: index_lib.build(engine, X, cfg | {"attrs": attrs},
                                                            device=DEVICE))
    build_s = time.perf_counter() - t0
    require(build_counts, build_want, f"{engine} build")
    windows[f"{engine} build"] = build_counts
    row = _engine_serve(engine, eng, Qt, gt, masks, specs, truth, serve_want, windows)
    row.update(config=cfg, build_seconds=build_s, stage_seconds=stages,
               launches=dict(row["launches"], build=build_counts),
               peak_memory_bytes=int(torch.cuda.max_memory_allocated()),
               memory_bytes=int(eng.memory_bytes()))
    log("engine " + json.dumps(row))
    return row, eng


def _engine_serve(engine: str, eng, Qt, gt, masks, specs, truth, serve_want: dict,
                  windows: dict) -> dict:
    nq = Qt.shape[0]
    n = eng.X.shape[0]
    batches = -(-nq // BATCH)
    want = {key: batches * v for key, v in serve_want.items()}
    (times, ids, _, comps), counts = counted(
        lambda: _serve(lambda q: eng.search(q, k=K), Qt, n, engine))
    require(counts, want, f"{engine} serve")
    windows[f"{engine} serve"] = counts
    name = f"score<={KERNEL_S:g}"
    (ftimes, fids, _, fcomps, leaked), fcounts = counted(
        lambda: _serve_filtered(lambda q: eng.search(q, k=K, filter=specs[name]), Qt,
                                masks[name], f"{engine} {name}"))
    require(fcounts, want, f"{engine} {name} serve")
    if leaked:
        fail(f"{engine} {name}: {leaked} returned ids fail the filter")
    return {"engine": engine, "corpus": list(eng.X.shape), "queries": nq, "k": K,
            "recall@10": _recall(ids, gt, K), **_rates(times, nq),
            "mean_comparisons": float(comps.float().mean()),
            f"recall@10_{name}": _recall(fids, truth[name][1], K), "leaked": leaked,
            f"p50_batch_ms_{name}": _rates(ftimes, nq)["p50_batch_ms"],
            f"mean_comparisons_{name}": float(fcomps.float().mean()),
            "launches": {"serve": counts, f"serve {name}": fcounts}}


def _filter_kernel_rows(X, Qt, mask, codes, scales, sqn) -> list[dict]:
    """The masked topk (f32, and int8 over the corpus codes) on one serve
    batch at score <= ``KERNEL_S``, against their plain versions with the
    same mask: f32 under the matmul contract, int8 bit for bit.  The bound
    counts the passing columns, what this mask's scan needs."""
    import torch

    from repro_torch.dist import roofline
    from repro_torch.kernels.topk.ref import quantize_queries, topk_quant_ref, topk_ref
    from repro_torch.kernels.topk.topk import topk_cuda, topk_quant_cuda

    q = Qt[:BATCH]
    m, d = q.shape
    n = X.shape[0]
    p = int(mask.sum())
    rows = []
    od, oi = topk_cuda(q, X, k=K, valid=mask, metric="euclidean")
    rd, ri = topk_ref(q, X, k=K + 1, valid=mask, metric="euclidean")
    err, ok = close_matmul(od, rd[:, :K])
    same, ids_ok = ids_agree(oi, ri, rd, K)
    if not (ok and ids_ok):
        fail(f"masked topk disagrees with its plain version (max err {err}, "
             f"identical ids {same})")
    far = torch.where(mask, 0.0, float("inf"))
    rows.append({
        "name": "topk", "case": f"masked brute batch {m}x{n}x{d} k={K} euclidean, "
                                f"score<={KERNEL_S:g} ({p} pass)",
        "path": f"filtered brute serve score<={KERNEL_S:g}", "idle": None,
        "counter": "topk/f32", "source": "src/repro_torch/csrc/topk.cu",
        "replaces": "src/repro/kernels/topk/topk.py:123",
        "max_abs_err": err, "ids_identical": same,
        "ms": cuda_ms(lambda: topk_cuda(q, X, k=K, valid=mask, metric="euclidean"), 10),
        "plain_ms": cuda_ms(lambda: topk_ref(q, X, k=K, valid=mask, metric="euclidean"), 10),
        "library_ms": cuda_ms(lambda: torch.topk(torch.cdist(q, X) + far, K, dim=1,
                                                 largest=False), 10),
        "bound": _bound(*roofline.topk_work(m, n, d, K, cube=False, masked=True, live=p)),
    })
    log("kernel " + json.dumps(rows[-1]))
    od, oi = topk_quant_cuda(q, codes, scales, sqn, k=K_QUANT, valid=mask)
    rd, ri = topk_quant_ref(q, codes, scales, sqn, k=K_QUANT, valid=mask)
    if not (torch.equal(od, rd) and torch.equal(oi, ri)):
        fail(f"masked topk int8 is not bit-identical to its plain version (max err "
             f"{float((od - rd).abs().max())})")

    def library():
        xq, alpha, xn = quantize_queries(q, scales)
        d2 = xn[:, None] + sqn[None, :] - 2.0 * (torch._int_mm(xq, codes.T).float()
                                                  * alpha[:, None])
        return torch.topk(torch.sqrt(d2.clamp_min(0.0)) + far, K_QUANT, dim=1, largest=False)

    rows.append({
        "name": "topk_int8", "case": f"masked quantized brute batch {m}x{n}x{d} K={K_QUANT} "
                                     f"euclidean, score<={KERNEL_S:g} ({p} pass)",
        "path": f"filtered brute+quant serve score<={KERNEL_S:g}", "idle": None,
        "counter": "topk/int8", "source": "src/repro_torch/csrc/topk_int8.cu",
        "replaces": "src/repro/kernels/topk/topk.py:207",
        "max_abs_err": 0.0, "ids_identical": 1.0,
        "ms": cuda_ms(lambda: topk_quant_cuda(q, codes, scales, sqn, k=K_QUANT, valid=mask), 20),
        "plain_ms": cuda_ms(lambda: topk_quant_ref(q, codes, scales, sqn, k=K_QUANT,
                                                   valid=mask), 20),
        "library_ms": cuda_ms(library, 20),
        "bound": _bound(*roofline.topk_int8_work(m, n, d, K_QUANT, masked=True, live=p)),
    })
    log("kernel " + json.dumps(rows[-1]))
    return rows


def _engine_kernel_rows(X, ivf, pq) -> list[dict]:
    """The pdist kernel at k-means' shapes (the corpus against the IVF
    engines' 256 coarse centroids, and one 49-wide PQ subspace of the
    residuals against its 256 centroids) and the topk kernel at the NSW
    graph's (the whole corpus against itself, k = 16, self excluded), each
    against its plain version under the matmul contract."""
    import torch

    from repro_torch.dist import roofline
    from repro_torch.kernels.pdist.pdist import pdist_cuda
    from repro_torch.kernels.pdist.ref import pdist_ref
    from repro_torch.kernels.topk.ref import topk_ref
    from repro_torch.kernels.topk.topk import topk_cuda

    rows = []
    assign = torch.cdist(X, pq.centroids).argmin(1)
    dsub = X.shape[1] // pq.codebooks.shape[0]
    sub = (X - pq.centroids[assign])[:, :dsub].contiguous()
    for what, path, A, B in (
        ("k-means: corpus x coarse centroids", "ivf_flat build", X, ivf.centroids),
        ("k-means: PQ subspace 0 x its centroids", "ivf_pq build", sub, pq.codebooks[0]),
    ):
        (m, d), n = A.shape, B.shape[0]
        out = pdist_cuda(A, B, metric="sqeuclidean")
        ref = pdist_ref(A, B, metric="sqeuclidean")
        err, ok = close_matmul(out, ref)
        if not ok:
            fail(f"pdist ({what}) disagrees with its plain version (max err {err})")
        rows.append({
            "name": "pdist", "case": f"{what} {m}x{n}x{d} sqeuclidean "
                                     "(library: torch.cdist, squared)",
            "path": path, "idle": None, "counter": "pdist/matmul",
            "source": "src/repro_torch/csrc/pdist.cu",
            "replaces": "src/repro/kernels/pdist/pdist.py:36", "max_abs_err": err,
            "ms": cuda_ms(lambda: pdist_cuda(A, B, metric="sqeuclidean"), 20),
            "plain_ms": cuda_ms(lambda: pdist_ref(A, B, metric="sqeuclidean"), 20),
            "library_ms": cuda_ms(lambda: torch.cdist(A, B).square_(), 20),
            "bound": _bound(*roofline.pdist_work(m, n, d, cube=False)),
        })
        log("kernel " + json.dumps(rows[-1]))
    n, d = X.shape
    k = NSW_DEGREE
    od, oi = topk_cuda(X, X, k=k, exclude_self=True)
    rd, ri = topk_ref(X, X, k=k + 1, exclude_self=True)
    err, ok = close_matmul(od, rd[:, :k])
    same, ids_ok = ids_agree(oi, ri, rd, k)
    if not (ok and ids_ok):
        fail(f"topk (NSW graph) disagrees with its plain version (max err {err}, "
             f"identical ids {same})")
    del rd, ri
    rows.append({
        "name": "topk", "case": f"NSW kNN graph {n}x{n}x{d} k={k} euclidean exclude_self",
        "path": "nsw build", "idle": None, "counter": "topk/f32",
        "source": "src/repro_torch/csrc/topk.cu",
        "replaces": "src/repro/kernels/topk/topk.py:123",
        "max_abs_err": err, "ids_identical": same,
        "ms": cuda_ms(lambda: topk_cuda(X, X, k=k, exclude_self=True), 2),
        "plain_ms": cuda_ms(lambda: topk_ref(X, X, k=k, exclude_self=True), 1, warmup=False),
        "library_ms": cuda_ms(lambda: torch.topk(
            torch.cdist(X, X).fill_diagonal_(float("inf")), k, dim=1, largest=False),
            1, warmup=False),
        "bound": _bound(*roofline.topk_work(n, n, d, k, cube=False, masked=False)),
    })
    log("kernel " + json.dumps(rows[-1]))
    return rows


def _bench_filtered() -> list[dict]:
    """``benchmarks/bench_filtered.py``'s configuration through the port:
    manifold n = 2048, 64 queries, ``score`` from ``default_rng(0)``, the
    serve defaults (budget 256, rerank 64; infinity at q = inf with 200
    training steps on 512 sampled rows), each engine at the four
    selectivities against the scan over the passing rows, printed beside
    its ``experiments/BENCH_filtered.json`` row; then ``bench_quant.py``'s
    ivf_flat rows, f32 and int8."""
    import numpy as np
    import torch

    from repro_torch.core import index as index_lib
    from repro_torch.data import synthetic

    n, nq = BENCH_FILTERED_N, BENCH_FILTERED_Q
    with open(os.path.join(HERE, "experiments", "BENCH_filtered.json")) as f:
        jax_rows = {(r["engine"], r["selectivity"]): r for r in json.load(f)["rows"]}
    rng = np.random.default_rng(0)
    pool = synthetic.make("manifold", n + nq, seed=0)
    corpus, Q = pool[:n], torch.as_tensor(pool[n:], device=DEVICE)
    score = rng.uniform(0.0, 1.0, size=n).astype(np.float32)
    X = torch.as_tensor(corpus, device=DEVICE)
    truth = {}
    for s in FILTER_SELECTIVITIES:
        mask = score <= s
        rows_ = torch.as_tensor(np.where(mask)[0], device=DEVICE)
        i = index_lib.build("brute", X[rows_], {}, device=DEVICE).search(Q, k=K).idx
        truth[s] = (mask, torch.where(i >= 0, rows_[i.long().clamp_min(0)], -1).cpu().numpy())
    cfgs = {"brute": {}, "ivf_flat": {}, "nsw": {},
            "infinity": {"q": math.inf, "proj_sample": 512, "train_steps": 200, "rerank": 64}}
    out = []
    for engine, cfg in cfgs.items():
        t0 = time.perf_counter()
        eng = index_lib.build(engine, corpus, cfg | {"budget": 256, "attrs": {"score": score}},
                              device=DEVICE)
        build_s = time.perf_counter() - t0
        for s, (mask, gt) in truth.items():
            res = eng.search(Q, k=K, filter=score_filter(s))
            idx = res.idx.cpu().numpy()
            jr = jax_rows[(engine, s)]
            row = {"engine": engine, "selectivity": s, "n_pass": int(mask.sum()),
                   "recall@k": _bench_recall(idx, gt),
                   "leaked": int(((idx >= 0) & ~mask[np.maximum(idx, 0)]).sum()),
                   "mean_comparisons": float(res.comparisons.float().mean()),
                   "build_s": build_s, "jax_recall@k": jr["recall@k"],
                   "jax_mean_comparisons": jr["mean_comparisons"]}
            if engine == "infinity":
                row["jax_recall@k_at_this_commit"] = INF_FILTERED_JAX[s]
            gate = _bench_gate(engine, s, row)
            row["gate"] = gate
            out.append(row)
            log("bench_filtered " + json.dumps(row))
    for quant in (False, True):
        gt = index_lib.build("brute", corpus, {}, device=DEVICE).search(Q, k=K).idx
        eng = index_lib.build("ivf_flat", corpus, {"budget": 256, "quant": quant},
                              device=DEVICE)
        res = eng.search(Q, k=K)
        row = {"engine": "ivf_flat", "mode": "int8" if quant else "f32", "n": n,
               "recall@k": _bench_recall(res.idx.cpu().numpy(), gt.cpu().numpy()),
               "mean_comparisons": float(res.comparisons.float().mean()),
               "jax_recall@k": 1.0, "gate": "recall@k == 1.0 (experiments/BENCH_quant.json)"}
        out.append(row)
        log("bench_quant " + json.dumps(row))
        if row["recall@k"] != 1.0:
            fail(f"bench-config ivf_flat {row['mode']} recall@k {row['recall@k']} != 1.0")
    return out


def _bench_recall(idx, gt) -> float:
    """``benchmarks/common.py:recall_at_k``: |approx ∩ true| / k, averaged."""
    return float(sum(len(set(map(int, a[:K])) & set(map(int, t[:K])))
                     for a, t in zip(idx, gt)) / (K * len(idx)))


def _bench_gate(engine: str, s: float, row: dict) -> str:
    """Fails the run where a gated bench-config row is off; returns what
    was held.  leaked is 0 everywhere, brute exact; ivf_flat and nsw within
    ``FILTERED_SLACK`` of the JAX row at s >= 0.1 (ivf_flat at 0.01 scores
    ~3.6 passing candidates a query and moves with the k-means draw:
    printed, not gated); infinity at least the JAX row's recall minus the
    slack (see ``INF_FILTERED_JAX``)."""
    rec, jax_rec = row["recall@k"], row["jax_recall@k"]
    if row["leaked"]:
        fail(f"bench-config {engine} s={s}: leaked {row['leaked']}")
    if engine == "brute":
        if rec != 1.0:
            fail(f"bench-config brute s={s}: recall {rec} != 1.0")
        return "recall@k == 1.0, leaked 0"
    if s < 0.1:
        return "leaked 0 (recall printed, not gated)"
    if engine == "infinity":
        floor = jax_rec - FILTERED_SLACK
        if rec < floor:
            fail(f"bench-config infinity s={s}: recall {rec} < {floor}")
        return f"recall@k >= {floor}, leaked 0"
    if abs(rec - jax_rec) > FILTERED_SLACK:
        fail(f"bench-config {engine} s={s}: recall {rec} not within {FILTERED_SLACK} "
             f"of {jax_rec}")
    return f"|recall@k - {jax_rec}| <= {FILTERED_SLACK}, leaked 0"


def phase_filtered(X, Qt, main_state: dict, seed: int) -> tuple[dict, list[dict], dict]:
    """Returns (the phase's rows, its kernel rows, its counted windows)."""
    import torch

    from repro_torch.core import attrs as attrs_lib
    from repro_torch.core import filter as filter_lib
    from repro_torch.core import index as index_lib
    from repro_torch.core import quant as quant_lib

    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    n = X.shape[0]
    attrs = demo_attrs(n, seed)
    store = attrs_lib.AttributeStore.build(attrs, n)
    specs = {f"score<={s:g}": score_filter(s) for s in FILTER_SELECTIVITIES}
    specs["category+score"] = FILTER_COMBO
    masks = {name: filter_lib.resolve_mask(spec, store, n, X.device)
             for name, spec in specs.items()}
    truth = _filtered_truth(X, Qt, masks)
    windows: dict = {}
    out: dict = {}

    brute = index_lib.build("brute", X, {"attrs": attrs}, device=DEVICE)
    out["brute"] = _filtered_brute(brute, "brute", Qt, masks, specs, truth, "topk/f32",
                                   windows)
    qbrute = index_lib.build("brute", X, {"attrs": attrs, "quant": True}, device=DEVICE)
    out["brute+quant"] = _filtered_brute(qbrute, "brute+quant", Qt, masks, specs, truth,
                                         "topk/int8", windows)
    kname = f"score<={KERNEL_S:g}"
    codes, scales, sqn = qbrute.quant.device_view()
    kernels = _filter_kernel_rows(X, Qt, masks[kname], codes, scales, sqn)
    del brute, qbrute, codes, scales, sqn

    # phase 3's index, its f32 state (phase 5's quant store detached), with
    # the attribute store attached: no rebuild
    index = main_state["index"]
    index.quant = None
    index_lib.attach_store(index, store)
    out["infinity"] = _filtered_infinity(index, Qt, masks, specs, truth)

    # each serve batch: one coarse probe by the pdist kernel and one exact
    # re-score of the probed members (IVF), no kernel (NSW scores
    # neighbours in the elementwise form)
    gt = main_state["gt"]
    probe = {"pdist/matmul": 1, "rescore": 1}
    out["ivf_flat"], ivf = _engine_full_width(
        "ivf_flat", IVF_CFG, attrs, X, Qt, gt, masks, specs, truth,
        {"pdist/matmul": IVF_ITERS + 1}, probe, windows)
    index_lib.attach_quant_store(ivf, quant_lib.QuantStore.build(ivf.X))
    row = _engine_serve("ivf_flat+quant", ivf, Qt, gt, masks, specs, truth, probe, windows)
    log("engine " + json.dumps(row))
    out["ivf_flat+quant"] = row
    out["ivf_pq"], pq = _engine_full_width(
        "ivf_pq", IVF_PQ_CFG, attrs, X, Qt, gt, masks, specs, truth,
        {"pdist/matmul": (IVF_ITERS + 1) * (1 + IVF_PQ_CFG["M"])}, probe, windows)
    out["nsw"], nsw = _engine_full_width(
        "nsw", NSW_CFG, attrs, X, Qt, gt, masks, specs, truth,
        {"topk/f32": 1}, {}, windows)
    del nsw
    gc.collect()
    torch.cuda.empty_cache()
    kernels += _engine_kernel_rows(X, ivf, pq)
    del ivf, pq
    gc.collect()
    torch.cuda.empty_cache()
    out["bench_filtered"] = _bench_filtered()
    out["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated())
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 8 peak memory {out['peak_memory_bytes']} bytes, "
        f"{out['seconds']:.3f} s")
    return out, kernels, windows


# ---------------------------------------------------------------------------
# phase 9: the serving entry point at full width
# ---------------------------------------------------------------------------

SERVE_BATCHES = (1, 40, 64, 512)  # 40 and 64 both serve as 64: the beam
DELTA_CAP = 4096
LIVE_DELETE_FRAC = 0.01  # of the frozen rows
PERTURB = 0.01  # upserted rows: corpus rows plus N(0, PERTURB^2) noise
LIVE_BENCH_DELTA_CAP, LIVE_BENCH_UPSERTS = 512, 256
BENCH_LIVE_CFG = {"q": math.inf, "proj_sample": 512, "train_steps": 300,
                  "budget": 1024, "rerank": 256}  # phase 4's bench config
#: the live brute+quant window serves this many batches: with 1 % of the
#: frozen rows deleted its frozen scan asks for k' = 1024 and an int8
#: shortlist of 4096, which the int8 topk's global-list path takes ~1.5 s
#: a batch to select (PERF.md §6)
LIVE_QUANT_BATCHES = 2
CHAOS_ERROR_RATE = 0.3
CHAOS_BATCHES = 10
PROBE_RATE = 0.05
HEAL_LOG = ["SERVING", "DEGRADED", "RECOVERING", "SERVING"]


def _padded(Qh, b: int):
    """``Qh[:b]`` padded as the server pads it: to ``_bucket(b)`` rows,
    repeating the last."""
    import numpy as np

    from repro_torch.launch.serve import _bucket

    q = Qh[:b]
    return np.concatenate([q, np.repeat(q[-1:], _bucket(b) - b, axis=0)])


def _same_served(res, want, b: int, what: str) -> None:
    """A ``ServedResult`` against an engine's answer on the padded batch,
    sliced: ids, distances and comparisons bit for bit."""
    import numpy as np

    for name, got, ref in (("ids", res.idx, want.idx), ("distances", res.dist, want.dist),
                           ("comparisons", res.comparisons, want.comparisons)):
        if not np.array_equal(got, ref[:b].cpu().numpy()):
            fail(f"{what}: served {name} differ from the engine's on the padded batch")


def _serve_all(srv, Qh, **kw) -> tuple[list, "np.ndarray"]:
    """Every query through ``srv.query`` in batches of ``BATCH``: (seconds
    per batch, the (QUERIES, K) ids)."""
    import numpy as np

    times, ids = [], []
    for s in range(0, Qh.shape[0], BATCH):
        t0 = time.perf_counter()
        res = srv.query(Qh[s:s + BATCH], k=K, **kw)
        times.append(time.perf_counter() - t0)
        ids.append(res.idx)
    return times, np.concatenate(ids)


def _p(times: list, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(times) * 1e3, q))


def _restore_and_serve(index, Qt, Qh, gt, tmp: str, direct_p50: float) -> tuple[dict, str]:
    """Save phase 3's index, verify, restore it in a server; serve it
    against ``index.search`` on the padded batches, then all queries with
    telemetry off and on.  Returns (row, snapshot path)."""
    import numpy as np
    import torch

    from repro_torch.core import store as store_lib
    from repro_torch.core import telemetry as telem
    from repro_torch.launch.serve import SearchServer

    # the server answers with the index's defaults: phase 3's rerank width
    index.search_defaults = {"rerank": SEARCH_KW["rerank"]}
    path = os.path.join(tmp, "infinity")
    t0 = time.perf_counter()
    store_lib.save(index, path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    store_lib.verify(path)
    verify_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    srv, counts = counted(lambda: SearchServer.restore(path, device=DEVICE))
    restore_s = time.perf_counter() - t0
    require(counts, {}, "restore")
    if srv.build_s != 0.0 or srv.index.train_history or srv.engine != "infinity":
        fail("restore ran a build stage")
    budget = SEARCH_KW["budget"]
    for b in SERVE_BATCHES:
        res = srv.query(Qh[:b], k=K, budget=budget)
        want = index.search(torch.as_tensor(_padded(Qh, b), device=DEVICE), k=K, **SEARCH_KW)
        _same_served(res, want, b, f"served batch of {b}")

    stats = srv.serve([Qh[s:s + BATCH] for s in range(0, Qh.shape[0], BATCH)], k=K,
                      budget=budget)
    full = [Qh[s:s + BATCH] for s in range(0, (Qh.shape[0] // BATCH) * BATCH, BATCH)]
    direct = []
    for b in full:
        q = torch.as_tensor(b, device=DEVICE)
        t0 = time.perf_counter()
        index.search(q, k=K, **SEARCH_KW)
        torch.cuda.synchronize()
        direct.append(time.perf_counter() - t0)

    def timed():
        lat, comps = [], 0
        for b in full:
            t0 = time.perf_counter()
            res = srv.query(b, k=K, budget=budget)
            lat.append(time.perf_counter() - t0)
            comps += int(res.comparisons.astype(np.int64).sum())
        return lat, comps

    off, _ = timed()
    telem.reset()
    telem.enable()
    try:
        on, on_comps = timed()
        stages = {lbl["stage"]: int(v) for lbl, v in telem.counter_series("comparisons_total")}
    finally:
        telem.disable()
        telem.reset()
    beam = sum(stages.get(s, 0) for s in ("traversal", "centroid_rank", "bucket_scan"))
    if not stages.get("bucket_scan") or beam != on_comps - stages.get("rerank", 0):
        fail(f"beam stage counters {stages} do not sum to the served comparisons "
             f"{on_comps} less the rerank widths")
    _, ids = _serve_all(srv, Qh, budget=budget)
    row = {
        "what": "restore + serve", "snapshot_bytes": sum(
            os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)),
        "save_seconds": save_s, "verify_seconds": verify_s, "restore_seconds": restore_s,
        "restore_launches": counts, "batches_checked": list(SERVE_BATCHES),
        "server_p50_ms": stats["p50_ms"], "server_p99_ms": stats["p99_ms"],
        "server_qps": stats["qps"], "direct_p50_ms_phase3": direct_p50,
        "direct_p50_ms": _p(direct, 50), "server_p50_ms_full_batches": _p(off, 50),
        "server_p50_ms_telemetry_on": _p(on, 50), "server_p99_ms_telemetry_on": _p(on, 99),
        "comparisons_by_stage": stages, "served_comparisons": on_comps,
        "recall@10": _recall(torch.as_tensor(ids), gt.cpu(), K),
    }
    log("serving " + json.dumps(row))
    return row, path


def _upserts(corpus, count: int, seed: int):
    """``count`` perturbed corpus rows (host f32) and the frozen ids to
    delete, both from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = corpus.shape[0]
    src = rng.choice(n, count, replace=False)
    rows = corpus[src] + rng.normal(scale=PERTURB, size=(count, corpus.shape[1]))
    dead = np.sort(rng.choice(n, max(1, int(n * LIVE_DELETE_FRAC)), replace=False))
    return rows.astype(np.float32), dead


def _own_rank0(srv, rows, ids) -> int:
    """How many upserted rows come back at rank 0 for their own query."""
    import numpy as np

    found = 0
    for s in range(0, rows.shape[0], BATCH):
        res = srv.query(rows[s:s + BATCH], k=K)
        found += int(np.sum(res.idx[:, 0] == ids[s:s + BATCH]))
    return found


def _live_brute(corpus, Qh, quant: bool, tmp: str, seed: int) -> tuple[dict, dict, dict]:
    """A live brute server at full width (``delta_cap`` ``DELTA_CAP``,
    f32 or with a quant store): upsert, delete 1 % of the frozen rows,
    serve every query as a counted window (the frozen scan and the delta
    scan each launch once a batch), compact in full and hold the answers
    to a fresh brute build over ``corpus()``; with ``quant``, snapshot and
    restore too.  Returns (row, window, the delta's kernel operands)."""
    import numpy as np
    import torch

    from repro_torch.core import index as index_lib
    from repro_torch.core import scan as scan_lib
    from repro_torch.launch.serve import SearchServer

    label = "live brute+quant" if quant else "live brute f32"
    counter = "topk/int8" if quant else "topk/f32"
    # a batch re-scores the frozen oversample; with quant also the frozen
    # engine's int8 shortlist and the delta's
    rescores = 3 if quant else 1
    t0 = time.perf_counter()
    srv = SearchServer(corpus, engine="brute", cfg={}, live=True, delta_cap=DELTA_CAP,
                       quant=quant, device=DEVICE)
    build_s = time.perf_counter() - t0
    rows, dead = _upserts(corpus, DELTA_CAP, seed)
    t0 = time.perf_counter()
    ids = srv.upsert(rows)
    upsert_s = time.perf_counter() - t0
    srv.delete(dead)
    served = Qh[:LIVE_QUANT_BATCHES * BATCH] if quant else Qh
    n_batches = -(-served.shape[0] // BATCH)
    (times, found), counts = counted(lambda: _serve_all(srv, served))
    require(counts, {counter: 2 * n_batches, "rescore": rescores * n_batches},
            f"{label} serve")
    leaked = int(np.isin(found, dead).sum())
    rank0 = _own_rank0(srv, rows, ids)
    if leaked or rank0 != DELTA_CAP:
        fail(f"{label}: leaked {leaked} deleted ids, {rank0}/{DELTA_CAP} upserts at rank 0")
    n = corpus.shape[0]
    kf = min(n, scan_lib.pow2ceil(K + dead.size))  # the frozen oversample
    operands = {"delta": torch.as_tensor(rows, device=DEVICE),
                "valid": torch.ones(DELTA_CAP, dtype=torch.bool, device=DEVICE),
                "frozen": srv.index.frozen_X, "kf": kf}
    if quant:
        codes, scales, sqn = srv.index.quant.device_view()
        operands.update(codes=codes[n:], scales=scales, sqnorms=sqn[n:],
                        frozen_codes=codes[:n], frozen_sqnorms=sqn[:n])
    # one batch split in two: the frozen engine's oversampled search alone,
    # then the whole live search (re-score, delta scan, merge)
    q = torch.as_tensor(Qh[:BATCH], device=DEVICE)
    frozen = srv.index._gen.frozen
    t0 = time.perf_counter()
    frozen.search(q, k=kf)
    torch.cuda.synchronize()
    frozen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    srv.index.search(q, k=K)
    torch.cuda.synchronize()
    live_s = time.perf_counter() - t0
    stats = srv.stats()

    t0 = time.perf_counter()
    srv.compact("full")
    compact_s = time.perf_counter() - t0
    fresh = index_lib.build("brute", srv.index.corpus(), {"quant": True} if quant else {},
                            device=DEVICE)
    for s in range(0, Qh.shape[0], BATCH):
        b = min(BATCH, Qh.shape[0] - s)
        _same_served(srv.query(Qh[s:s + BATCH], k=K),
                     fresh.search(torch.as_tensor(_padded(Qh[s:], b), device=DEVICE), k=K),
                     b, f"{label} after compaction, batch at {s}")
    row = {"what": label, "delta_cap": DELTA_CAP, "upserts": DELTA_CAP,
           "deleted": int(dead.size), "build_seconds": build_s, "upsert_seconds": upsert_s,
           "queries": int(served.shape[0]), "frozen_oversample": kf,
           "p50_batch_ms": _p(times, 50), "p99_batch_ms": _p(times, 99),
           "one_batch_ms": {"frozen search at k'": frozen_s * 1e3, "live search": live_s * 1e3},
           "leaked": leaked, "upserts_at_rank0": rank0, "compact_seconds": compact_s,
           "stats_before_compaction": {k: stats[k] for k in (
               "frozen_size", "delta_fill", "tombstones", "n_alive", "memory_bytes")},
           "launches": counts}
    if quant:
        path = os.path.join(tmp, "live")
        t0 = time.perf_counter()
        srv.snapshot(path)
        back = SearchServer.restore(path, device=DEVICE)
        row["snapshot_restore_seconds"] = time.perf_counter() - t0
        for s in range(0, Qh.shape[0], BATCH):
            a, b = srv.query(Qh[s:s + BATCH], k=K), back.query(Qh[s:s + BATCH], k=K)
            if not (np.array_equal(a.idx, b.idx) and np.array_equal(a.dist, b.dist)):
                fail(f"{label}: the restored snapshot answers differently at batch {s}")
        row["restored_equal"] = True
    log("serving " + json.dumps(row))
    return row, counts, operands


def _live_infinity(bench, tmp: str, seed: int) -> dict:
    """A live infinity server over the bench-config corpus through a
    refresh compaction: upserted rows at rank 0, no deleted id returned;
    after the refresh the answers equal ``refresh`` of the old frozen
    index over ``corpus()`` with the carried embeddings; a snapshot
    restores to the same answers."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import SearchServer

    corpus, Qt, _ = bench
    Qh = Qt.cpu().numpy()
    t0 = time.perf_counter()
    srv = SearchServer(corpus, engine="infinity", cfg=dict(BENCH_LIVE_CFG), live=True,
                       delta_cap=LIVE_BENCH_DELTA_CAP, device=DEVICE)
    build_s = time.perf_counter() - t0
    rows, dead = _upserts(corpus, LIVE_BENCH_UPSERTS, seed + 1)
    ids = srv.upsert(rows)
    srv.delete(dead)
    found = srv.query(Qh, k=K).idx
    leaked = int(np.isin(found, dead).sum())
    rank0 = _own_rank0(srv, rows, ids)
    if leaked or rank0 != LIVE_BENCH_UPSERTS:
        fail(f"live infinity: leaked {leaked}, {rank0}/{LIVE_BENCH_UPSERTS} at rank 0")
    live = srv.index
    gen = live._gen  # the carried embeddings, read before the swap
    alive_f = ~gen.tomb[:gen.n_frozen]
    alive_d = ~gen.tomb[gen.n_frozen:gen.n_slots]
    Z = torch.cat([gen.frozen.Z[torch.as_tensor(np.nonzero(alive_f)[0], device=DEVICE)],
                   torch.as_tensor(gen.delta_Z[:gen.fill][alive_d], device=DEVICE)])
    expect = gen.frozen.refresh(torch.as_tensor(live.corpus(), device=DEVICE), Z=Z)
    t0 = time.perf_counter()
    srv.compact("refresh")
    refresh_s = time.perf_counter() - t0
    got = srv.query(Qh, k=K)
    want = expect.search(torch.as_tensor(_padded(Qh, Qh.shape[0]), device=DEVICE), k=K)
    _same_served(got, want, Qh.shape[0], "live infinity after the refresh")
    path = os.path.join(tmp, "live_infinity")
    srv.snapshot(path)
    back = SearchServer.restore(path, device=DEVICE).query(Qh, k=K)
    if not np.array_equal(back.idx, got.idx):
        fail("live infinity: the restored snapshot answers differently")
    truth = _exact_ids(live.corpus(), Qt)
    row = {"what": "live infinity (bench config, q=inf)", "corpus": list(corpus.shape),
           "delta_cap": LIVE_BENCH_DELTA_CAP, "upserts": LIVE_BENCH_UPSERTS,
           "deleted": int(dead.size), "build_seconds": build_s, "leaked": leaked,
           "upserts_at_rank0": rank0, "refresh_seconds": refresh_s,
           "recall@10_after_refresh": _recall(torch.as_tensor(got.idx), truth, K),
           "restored_equal": True, "generation": srv.stats()["generation"]}
    log("serving " + json.dumps(row))
    return row


def _exact_ids(corpus_h, Qt):
    import torch

    from repro_torch.core import scan as scan_lib

    return scan_lib.topk_scan(Qt, torch.as_tensor(corpus_h, device=DEVICE), k=K)[1].cpu()


def _chaos_and_heal(corpus, Qh, tmp: str, seed: int) -> list[dict]:
    """Transient errors (retried; every answer the clean one), then a
    snapshot-corruption rule under ``snapshot_dir`` and a poisoned swap,
    which ``_heal`` answers by restoring the last good snapshot."""
    import numpy as np

    from repro_torch.core import chaos as chaos_lib
    from repro_torch.launch.serve import FaultPolicy, SearchServer

    plan = {"seed": seed, "rules": [{"site": "search", "kind": "error",
                                     "rate": CHAOS_ERROR_RATE}]}
    chaotic = SearchServer(corpus, engine="brute", cfg={}, chaos=plan, device=DEVICE,
                           policy=FaultPolicy(max_retries=8, backoff_base_s=0.001,
                                              backoff_cap_s=0.004))
    clean = SearchServer(corpus, engine="brute", cfg={}, device=DEVICE)
    for i in range(min(CHAOS_BATCHES, Qh.shape[0] // BATCH)):
        q = Qh[i * BATCH:(i + 1) * BATCH]
        if not np.array_equal(chaotic.query(q, k=K).idx, clean.query(q, k=K).idx):
            fail(f"chaos: batch {i} answers differently under retried faults")
    faults = dict(chaotic.fault_counters)
    if faults["retries"] == 0 or faults["retries"] != faults["faults"]:
        fail(f"chaos: fault counters {faults}")
    row = {"what": "chaos transient errors", "rate": CHAOS_ERROR_RATE,
           "batches": CHAOS_BATCHES, "fault_counters": faults,
           "injected": chaotic.chaos.stats()["injected"], "answers_equal_clean": True,
           "health": chaotic.health}
    log("serving " + json.dumps(row))
    del chaotic, clean

    plan = {"seed": seed, "rules": [{"site": "snapshot", "start": 1, "stop": 2},
                                    {"site": "build", "start": 1, "stop": 2}]}
    t0 = time.perf_counter()
    srv = SearchServer(corpus, engine="brute", cfg={}, chaos=plan, device=DEVICE,
                       snapshot_dir=os.path.join(tmp, "snaps"))
    first = srv._last_good
    second = srv._save_good_snapshot()  # the first write is corrupted, the retry clean
    before = srv.query(Qh[:BATCH], k=K)
    try:
        srv.swap("brute", cfg={})
        fail("heal: the poisoned swap did not raise")
    except chaos_lib.BuildFault:
        pass
    after = srv.query(Qh[:BATCH], k=K)
    ok = (srv.health_log == HEAL_LOG and second not in (None, first)
          and srv.fault_counters["snapshot_corrupt"] == 1
          and srv.fault_counters["snapshot_restores"] == 1
          and np.array_equal(before.idx, after.idx))
    row = {"what": "heal", "health_log": srv.health_log,
           "fault_counters": dict(srv.fault_counters),
           "injected": srv.chaos.stats()["injected"], "answers_equal_before": ok,
           "seconds": time.perf_counter() - t0}
    log("serving " + json.dumps(row))
    if not ok:
        fail(f"heal: {row}")
    return [row]


def _probe(path: str, Qh, gt) -> dict:
    """A probe at ``PROBE_RATE`` over every query of the restored index:
    its estimate and Wilson interval beside the exact recall@10 of the
    same answers."""
    import torch

    from repro_torch.core import probes as probes_lib
    from repro_torch.launch.serve import SearchServer

    srv = SearchServer.restore(path, device=DEVICE)
    srv._probe = probes_lib.RecallProbe({"rate": PROBE_RATE})
    (times, ids), counts = counted(lambda: _serve_all(srv, Qh, budget=SEARCH_KW["budget"]))
    q = srv.stats()["quality"]
    exact = _recall(torch.as_tensor(ids), gt.cpu(), K)
    # the probe's sampled ordinals are a pure function of (seed, ordinal):
    # its estimate must be the exact recall over those rows
    picked = probes_lib.sampled_mask(srv._probe.cfg.seed, PROBE_RATE, 0, Qh.shape[0])
    on_sample = _recall(torch.as_tensor(ids[picked]), gt.cpu()[torch.as_tensor(picked)], K)
    if q["probed"] != int(picked.sum()) or abs(on_sample - q["recall_estimate"]) > 5e-5:
        fail(f"probe: estimate {q['recall_estimate']} over {q['probed']} rows, exact "
             f"{on_sample} over the {int(picked.sum())} sampled rows")
    row = {"what": "probe", "rate": PROBE_RATE, "seen": q["seen"], "probed": q["probed"],
           "recall_estimate": q["recall_estimate"], "ci_low": q["ci_low"],
           "ci_high": q["ci_high"], "exact_recall@10_sampled_rows": on_sample,
           "exact_recall@10": exact,
           "p50_batch_ms": _p(times, 50), "launches": counts}
    log("serving " + json.dumps(row))
    if q["seen"] != Qh.shape[0] or not q["probed"]:
        fail(f"probe: {row}")
    return row


def _delta_kernel_rows(Qt, f32: dict, quant: dict) -> list[dict]:
    """The masked f32 topk over the live delta buffer and the int8 topk
    over its codes, at the live windows' shapes, against their plain
    versions: f32 under the matmul contract, int8 bit for bit.  The bound
    counts the valid (occupied, alive) rows."""
    import torch

    from repro_torch.core import quant as quant_lib
    from repro_torch.dist import roofline
    from repro_torch.kernels.topk.ref import topk_quant_ref, topk_ref
    from repro_torch.kernels.topk.topk import topk_cuda, topk_quant_cuda

    q = Qt[:BATCH]
    m, d = q.shape
    dX, valid = f32["delta"], f32["valid"]
    p = int(valid.sum())
    rows = []
    od, oi = topk_cuda(q, dX, k=K, valid=valid, metric="euclidean")
    rd, ri = topk_ref(q, dX, k=K + 1, valid=valid, metric="euclidean")
    err, ok = close_matmul(od, rd[:, :K])
    same, ids_ok = ids_agree(oi, ri, rd, K)
    if not (ok and ids_ok):
        fail(f"delta topk disagrees with its plain version (max err {err}, ids {same})")
    far = torch.where(valid, 0.0, float("inf"))
    rows.append({
        "name": "topk", "case": f"live delta scan {m}x{DELTA_CAP}x{d} k={K} euclidean, "
                                f"valid ({p} occupied and alive)",
        "path": "live brute f32 serve", "idle": None, "counter": "topk/f32",
        "source": "src/repro_torch/csrc/topk.cu",
        "replaces": "src/repro/kernels/topk/topk.py:123",
        "max_abs_err": err, "ids_identical": same,
        "ms": cuda_ms(lambda: topk_cuda(q, dX, k=K, valid=valid, metric="euclidean"), 20),
        "plain_ms": cuda_ms(lambda: topk_ref(q, dX, k=K, valid=valid, metric="euclidean"), 20),
        "library_ms": cuda_ms(lambda: torch.topk(torch.cdist(q, dX) + far, K, dim=1,
                                                 largest=False), 20),
        "bound": _bound(*roofline.topk_work(m, DELTA_CAP, d, K, cube=False, masked=True,
                                            live=p)),
    })
    log("kernel " + json.dumps(rows[-1]))
    codes, scales, sqn, qvalid = quant["codes"], quant["scales"], quant["sqnorms"], quant["valid"]
    kq = quant_lib.shortlist_width(K, DELTA_CAP)
    od, oi = topk_quant_cuda(q, codes, scales, sqn, k=kq, valid=qvalid)
    rd, ri = topk_quant_ref(q, codes, scales, sqn, k=kq, valid=qvalid)
    if not (torch.equal(od, rd) and torch.equal(oi, ri)):
        fail(f"delta topk int8 is not bit-identical to its plain version (max err "
             f"{float((od - rd).abs().max())})")

    rows.append({
        "name": "topk_int8", "case": f"live delta code scan {m}x{DELTA_CAP}x{d} K={kq} "
                                     f"euclidean, valid ({p} occupied and alive)",
        "path": "live brute+quant serve", "idle": None, "counter": "topk/int8",
        "source": "src/repro_torch/csrc/topk_int8.cu",
        "replaces": "src/repro/kernels/topk/topk.py:207",
        "max_abs_err": 0.0, "ids_identical": 1.0,
        "ms": cuda_ms(lambda: topk_quant_cuda(q, codes, scales, sqn, k=kq, valid=qvalid), 20),
        "plain_ms": cuda_ms(lambda: topk_quant_ref(q, codes, scales, sqn, k=kq,
                                                   valid=qvalid), 20),
        "library_ms": cuda_ms(lambda: _int8_library(q, codes, scales, sqn, kq, qvalid), 20),
        "bound": _bound(*roofline.topk_int8_work(m, DELTA_CAP, d, kq, masked=True, live=p)),
    })
    log("kernel " + json.dumps(rows[-1]))
    rows += _oversample_kernel_rows(q, f32, quant)
    return rows


def _int8_library(q, codes, scales, sqn, k: int, valid=None):
    """One PyTorch call chain for the int8 scan: quantised queries,
    ``torch._int_mm`` for the cross term, ``torch.topk``."""
    import torch

    from repro_torch.kernels.topk.ref import quantize_queries

    xq, alpha, xn = quantize_queries(q, scales)
    d2 = xn[:, None] + sqn[None, :] - 2.0 * (torch._int_mm(xq, codes.T).float()
                                              * alpha[:, None])
    dist = torch.sqrt(d2.clamp_min(0.0))
    if valid is not None:
        dist = dist + torch.where(valid, 0.0, float("inf"))
    return torch.topk(dist, k, dim=1, largest=False)


def _oversample_kernel_rows(q, f32: dict, quant: dict) -> list[dict]:
    """The frozen scans a live search asks for with 1 % of the frozen rows
    deleted: the f32 topk at k' and the int8 topk at its shortlist width,
    over the whole frozen corpus (both past 512: the f32 kernel's select,
    the int8 kernel's global-list path), against their plain versions; a
    few repetitions, the int8 call takes up to seconds."""
    import torch

    from repro_torch.core import quant as quant_lib
    from repro_torch.dist import roofline
    from repro_torch.kernels.topk.ref import topk_quant_ref, topk_ref
    from repro_torch.kernels.topk.topk import topk_cuda, topk_quant_cuda

    X, kf = f32["frozen"], f32["kf"]
    m, d = q.shape
    n = X.shape[0]
    rows = []
    od, oi = topk_cuda(q, X, k=kf, metric="euclidean")
    rd, ri = topk_ref(q, X, k=kf + 1, metric="euclidean")
    err, ok = close_matmul(od, rd[:, :kf])
    same, ids_ok = ids_agree(oi, ri, rd, kf)
    if not (ok and ids_ok):
        fail(f"wide topk disagrees with its plain version (max err {err}, ids {same})")
    rows.append({
        "name": "topk", "case": f"live frozen oversample {m}x{n}x{d} k={kf} euclidean "
                                f"(select)",
        "path": "live brute f32 serve", "idle": None, "counter": "topk/f32",
        "source": "src/repro_torch/csrc/topk.cu",
        "replaces": "src/repro/kernels/topk/topk.py:123",
        "max_abs_err": err, "ids_identical": same,
        "ms": cuda_ms(lambda: topk_cuda(q, X, k=kf, metric="euclidean"), 3),
        "plain_ms": cuda_ms(lambda: topk_ref(q, X, k=kf, metric="euclidean"), 2),
        "library_ms": cuda_ms(lambda: torch.topk(torch.cdist(q, X), kf, dim=1,
                                                 largest=False), 3),
        "bound": _bound(*roofline.topk_work(m, n, d, kf, cube=False, masked=False)),
    })
    log("kernel " + json.dumps(rows[-1]))
    codes, scales, sqn = quant["frozen_codes"], quant["scales"], quant["frozen_sqnorms"]
    kq = quant_lib.shortlist_width(quant["kf"], n)
    od, oi = topk_quant_cuda(q, codes, scales, sqn, k=kq)
    rd, ri = topk_quant_ref(q, codes, scales, sqn, k=kq)
    if not (torch.equal(od, rd) and torch.equal(oi, ri)):
        fail(f"wide topk int8 is not bit-identical to its plain version (max err "
             f"{float((od - rd).abs().max())})")
    rows.append({
        "name": "topk_int8", "case": f"live frozen oversample {m}x{n}x{d} K={kq} euclidean "
                                     f"(k'={quant['kf']}; global lists)",
        "path": "live brute+quant serve", "idle": None, "counter": "topk/int8",
        "source": "src/repro_torch/csrc/topk_int8.cu",
        "replaces": "src/repro/kernels/topk/topk.py:207",
        "max_abs_err": 0.0, "ids_identical": 1.0,
        "ms": cuda_ms(lambda: topk_quant_cuda(q, codes, scales, sqn, k=kq), 1),
        "plain_ms": cuda_ms(lambda: topk_quant_ref(q, codes, scales, sqn, k=kq), 2),
        "library_ms": cuda_ms(lambda: _int8_library(q, codes, scales, sqn, kq), 2),
        "bound": _bound(*roofline.topk_int8_work(m, n, d, kq, masked=False)),
    })
    log("kernel " + json.dumps(rows[-1]))
    return rows


def phase_serving(corpus, Qt, main_state: dict, bench, direct_p50: float,
                  seed: int) -> tuple[list[dict], list[dict], dict]:
    """Returns (the phase's rows, its kernel rows, its counted windows)."""
    import shutil
    import tempfile

    import torch

    t_phase = time.perf_counter()
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="phase9-", dir=os.path.join(HERE, "build"))
    Qh = Qt.cpu().numpy()
    try:
        served, path = _restore_and_serve(main_state["index"], Qt, Qh, main_state["gt"],
                                          tmp, direct_p50)
        out = [served, _probe(path, Qh, main_state["gt"])]
        f32, f32_counts, f32_ops = _live_brute(corpus, Qh, False, tmp, seed)
        qnt, qnt_counts, qnt_ops = _live_brute(corpus, Qh, True, tmp, seed)
        qnt_ops["valid"] = f32_ops["valid"]
        out += [f32, qnt, _live_infinity(bench, tmp, seed)]
        out += _chaos_and_heal(corpus, Qh, tmp, seed)
        kernels = _delta_kernel_rows(Qt, f32_ops, qnt_ops)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 9 {time.perf_counter() - t_phase:.3f} s")
    return out, kernels, {"live brute f32 serve": f32_counts,
                          "live brute+quant serve": qnt_counts}


# ---------------------------------------------------------------------------
# phase 10: sharded serving, degraded shards, roofline profiles, runtime
# ---------------------------------------------------------------------------

SHARD_COUNTS = (2, 4)
SHARD_BATCHES = 20  # timed batches of BATCH per sharded engine
SHARD_DEADLINE_MS = 5000.0
RUNTIME_CLIENTS = 4  # concurrent HTTP clients
RUNTIME_REQUESTS = 512  # single-query requests, spread over the clients
RUNTIME_POLICY = {"max_batch": 64, "flush_ms": 2.0, "capacity": 1024}
#: live over sharded serves this many batches: with 1 % of the frozen rows
#: deleted each shard's frozen scan asks for k' = 1024, the f32 topk's
#: select (PERF.md §6)
LIVE_SHARD_BATCHES = 2


def _shard_starts() -> list[int]:
    """Row offsets of the timed batches: ``SHARD_BATCHES`` batches of
    ``BATCH`` queries, the last ones clamped to the query set."""
    return [min(b * BATCH, QUERIES - BATCH) for b in range(SHARD_BATCHES)]


def _serve_batches(search, Qt) -> tuple[list, "torch.Tensor", "torch.Tensor", "torch.Tensor"]:
    """``search`` over the timed batches, each synchronised: (seconds per
    batch, ids, dists, comparisons) in batch order."""
    import torch

    times, ids, dists, comps = [], [], [], []
    for s in _shard_starts():
        t0 = time.perf_counter()
        res = search(Qt[s:s + BATCH])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        ids.append(res.idx)
        dists.append(res.dist)
        comps.append(res.comparisons)
    return times, torch.cat(ids), torch.cat(dists), torch.cat(comps)


def _served_rows(t):
    """The rows of a per-query tensor that the timed batches answer."""
    import torch

    return torch.cat([t[s:s + BATCH] for s in _shard_starts()])


def _sharded_row(what: str, times, ids, comps, gt, counts, **extra) -> dict:
    row = {"what": what, "batches": len(times), "batch": BATCH, "k": K,
           "p50_batch_ms": _p(times, 50), "p99_batch_ms": _p(times, 99),
           "recall@10": _recall(ids, gt, K),
           "mean_comparisons": float(comps.float().mean()),
           "launches": counts, **extra}
    log("sharded " + json.dumps(row))
    return row


def _sharded_brute(corpus_t, Qt, gt, gt_d) -> tuple[list[dict], dict]:
    """Brute f32 and brute + quant over S = 2 and 4 shards, each against
    the one-shard engine: f32 ids equal up to near ties; the quantized
    shards' union of shortlists holds the one-shard shortlist, so after the
    exact rerank each rank's distance is at most the one-shard answer's."""
    import torch

    from repro_torch.core import index as index_lib

    n = corpus_t.shape[0]
    batches = SHARD_BATCHES
    gt_s, gt_ds = _served_rows(gt), _served_rows(gt_d)
    one = index_lib.build("brute", corpus_t, {}, device=DEVICE)
    ref = [one.search(Qt[s:s + BATCH], k=K + 1) for s in _shard_starts()]
    ref_i = torch.cat([r.idx for r in ref])
    ref_d = torch.cat([r.dist for r in ref])
    one_q = index_lib.build("brute", corpus_t, {"quant": True}, device=DEVICE)
    _, one_qi, one_qd, _ = _serve_batches(lambda q: one_q.search(q, k=K), Qt)
    del one, one_q
    rows, windows = [], {}
    for S in SHARD_COUNTS:
        eng = index_lib.build("sharded", corpus_t, {"engine": "brute", "shards": S},
                              device=DEVICE)
        what = f"sharded brute f32 serve S={S}"
        (times, ids, dists, comps), counts = counted(
            lambda: _serve_batches(lambda q: eng.search(q, k=K), Qt))
        require(counts, {"topk/f32": S * batches}, what)
        same, ok = ids_agree(ids, ref_i, ref_d, K)
        err, dist_ok = close_matmul(dists, ref_d[:, :K])
        if not (ok and dist_ok) or not bool((comps == n).all()):
            fail(f"{what}: ids / distances off the one-shard brute's (identical "
                 f"{same}, max err {err})")
        rows.append(_sharded_row(
            what, times, ids, comps, gt_s, counts, shards=S,
            ids_differing_from_one_shard=int((ids != ref_i[:, :K]).sum()),
            identical_ids=same, max_abs_err_vs_one_shard=err,
            launches_per_batch=counts["topk/f32"] / batches))
        windows[what] = counts
        del eng
        if S == 2:
            row, counts = _sharded_brute_mesh(corpus_t, Qt, gt_s, ids)
            rows.append(row)
            windows[row["what"]] = counts

        eng = index_lib.build("sharded", corpus_t, {"engine": "brute", "shards": S,
                                                    "quant": True}, device=DEVICE)
        what = f"sharded brute+quant serve S={S}"
        (times, ids, dists, comps), counts = counted(
            lambda: _serve_batches(lambda q: eng.search(q, k=K), Qt))
        require(counts, {"topk/int8": S * batches, "rescore": S * batches}, what)
        worse = dists > one_qd + MATMUL_ATOL + MATMUL_RTOL * one_qd.abs()
        err, exact = close_matmul(dists, torch.linalg.vector_norm(
            corpus_t[ids.long()] - _served_rows(Qt)[:, None, :], dim=-1))
        row = _sharded_row(
            what, times, ids, comps, gt_s, counts, shards=S,
            ids_differing_from_one_shard=int((ids != one_qi).sum()),
            ranks_worse_than_one_shard=int(worse.sum()), rerank_max_abs_err=err,
            one_shard_recall=_recall(one_qi, gt_s, K),
            launches_per_batch=counts["topk/int8"] / batches)
        rows.append(row)
        windows[what] = counts
        if bool(worse.any()) or not exact or row["recall@10"] < QUANT_BRUTE_FLOOR:
            fail(f"{what}: {row}")
        del eng
    return rows, windows


def _sharded_brute_mesh(corpus_t, Qt, gt_s, ids_plain) -> tuple[dict, dict]:
    """Brute f32 at S = 2 built with ``mesh=make_test_mesh((2,), ("data",))``
    (its ``dctx`` is ``search_policy`` of that mesh): the shards are still
    searched in turn, so its ids must equal the row without a mesh."""
    from repro_torch.core import index as index_lib
    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh((2,), ("data",), device=DEVICE)
    eng = index_lib.build("sharded", corpus_t, {"engine": "brute", "shards": 2,
                                                "mesh": mesh}, device=DEVICE)
    what = "sharded brute f32 serve S=2 mesh"
    (times, ids, _, comps), counts = counted(
        lambda: _serve_batches(lambda q: eng.search(q, k=K), Qt))
    require(counts, {"topk/f32": 2 * SHARD_BATCHES}, what)
    differ = int((ids != ids_plain).sum())
    if differ or eng.dctx.mesh is not mesh:
        fail(f"{what}: {differ} ids differ from the row without a mesh")
    return _sharded_row(what, times, ids, comps, gt_s, counts, shards=2,
                        mesh={"shape": mesh.shape, "device": str(mesh.device)},
                        ids_differing_from_no_mesh=differ,
                        launches_per_batch=counts["topk/f32"] / SHARD_BATCHES), counts


def _sharded_ivf_and_infinity(corpus, Qt, gt) -> tuple[list[dict], dict, object, object]:
    """IVF-Flat and infinity over two shards, built and served through
    ``SearchServer(shards=2)``; returns (rows, windows, the infinity
    server for the roofline, shard 0's IVF centroids for the kernel
    row)."""
    import torch

    from repro_torch.launch.serve import SearchServer

    gt_s = _served_rows(gt)
    rows, windows = [], {}
    srv = SearchServer(corpus, engine="ivf_flat", shards=2,
                       cfg={**IVF_CFG, "iters": IVF_ITERS}, device=DEVICE)
    what = "sharded ivf_flat serve S=2"
    (times, ids, _, comps), counts = counted(lambda: _serve_batches(
        lambda q: srv.index.search(q, k=K), Qt))
    require(counts, {"pdist/matmul": 2 * SHARD_BATCHES, "rescore": 2 * SHARD_BATCHES}, what)
    rows.append(_sharded_row(what, times, ids, comps, gt_s, counts, shards=2,
                             config=IVF_CFG, build_seconds=srv.build_s))
    windows[what] = counts
    cents = srv.index.shard_views()[0]["centroids"].clone()
    del srv

    what = "sharded infinity build S=2"
    srv, counts = counted(lambda: SearchServer(
        corpus, engine="infinity", shards=2, cfg={"rerank": SEARCH_KW["rerank"]},
        device=DEVICE))
    require(counts, {"topk/f32": 2, "pdist/matmul": 2, "qpath/minmax": 2 * NUM_HOPS},
            what)
    windows[what] = counts
    build_s = srv.build_s
    srv.index.search(Qt[:BATCH], k=K, budget=SEARCH_KW["budget"])  # flattens the trees
    what = "sharded infinity serve S=2"
    (times, ids, _, comps), counts = counted(lambda: _serve_batches(
        lambda q: srv.index.search(q, k=K, budget=SEARCH_KW["budget"]), Qt))
    require(counts, {"beam/levels": 2 * SHARD_BATCHES, "rescore": 2 * SHARD_BATCHES}, what)
    rows.append(_sharded_row(what, times, ids, comps, gt_s, counts, shards=2,
                             config={"rerank": SEARCH_KW["rerank"],
                                     "budget": SEARCH_KW["budget"]},
                             build_seconds=build_s))
    windows[what] = counts
    if rows[-1]["recall@10"] < FULL_RECALL_FLOOR:
        fail(f"{what}: recall@10 {rows[-1]['recall@10']} < {FULL_RECALL_FLOOR}")
    torch.cuda.synchronize()
    return rows, windows, srv, cents


def _degraded(corpus, Qt) -> tuple[dict, dict]:
    """``SearchServer(shards=2)`` with shard 1 killed through chaos: every
    batch answers within its deadline from shard 0, flagged degraded, with
    the ids of a brute search over shard 0's rows."""
    import numpy as np
    import torch

    from repro_torch.core import index as index_lib
    from repro_torch.launch.serve import SearchServer

    srv = SearchServer(corpus, engine="brute", shards=2, cfg={}, device=DEVICE,
                       chaos={"seed": 0, "rules": []})
    half = corpus.shape[0] // 2
    only0 = index_lib.build("brute", corpus[:half], {}, device=DEVICE)
    srv.chaos.kill_shard(1)
    Qh = Qt.cpu().numpy()
    what = "degraded sharded brute serve S=2"

    def serve():
        out = []
        for s in _shard_starts():
            t0 = time.perf_counter()
            res = srv.query(Qh[s:s + BATCH], k=K, deadline_ms=SHARD_DEADLINE_MS)
            out.append((time.perf_counter() - t0, res))
        return out

    served, counts = counted(serve)
    require(counts, {"topk/f32": SHARD_BATCHES}, what)
    identical, worst = [], True
    for s, (_, res) in zip(_shard_starts(), served):
        ref = only0.search(Qt[s:s + BATCH], k=K + 1)
        same, ok = ids_agree(torch.as_tensor(res.idx, device=DEVICE), ref.idx, ref.dist, K)
        identical.append(same)
        worst &= (ok and res.degraded and res.shards_answered == 1
                  and res.shards_total == 2 and res.deadline_met
                  and bool((res.idx < half).all()))
    times = [t for t, _ in served]
    row = {"what": what, "batches": len(served), "deadline_ms": SHARD_DEADLINE_MS,
           "p50_batch_ms": _p(times, 50), "p99_batch_ms": _p(times, 99),
           "degraded": all(r.degraded for _, r in served),
           "shards_answered": sorted({r.shards_answered for _, r in served}),
           "deadline_met": all(r.deadline_met for _, r in served),
           "retries": int(sum(r.retries for _, r in served)),
           "identical_ids_vs_shard0_brute": float(np.mean(identical)),
           "health": srv.health, "dead_shards": sorted(srv._dead_shards),
           "fault_counters": dict(srv.fault_counters), "launches": counts}
    log("sharded " + json.dumps(row))
    if not worst or srv.health != "DEGRADED":
        fail(f"{what}: {row}")
    return row, counts


def _live_sharded(corpus, Qt, tmp: str, seed: int) -> tuple[dict, dict, dict]:
    """A live server over a two-shard brute f32 engine at phase 9's
    ``delta_cap`` and deletes: ``DELTA_CAP - 1`` upserts (an odd alive
    count, so the compaction carries one row into the new delta), 1 % of
    the frozen rows deleted, ``LIVE_SHARD_BATCHES`` batches served as a
    counted window (each shard's frozen scan at the oversampled k' and the
    delta scan: three f32 topk launches a batch), their answers against a
    one-shard live server's under the same mutations; then ``compact`` in
    full (the carry: one row in the delta, the rest on the shards) and a
    snapshot restored, both answering as a fresh brute over the live
    corpus.  Returns (row, window, the frozen scan's operands)."""
    import numpy as np
    import torch

    from repro_torch.core import index as index_lib
    from repro_torch.core import scan as scan_lib
    from repro_torch.launch.serve import SearchServer

    what = "live brute f32 serve S=2"
    Qh = Qt.cpu().numpy()
    t0 = time.perf_counter()
    srv = SearchServer(corpus, engine="brute", shards=2, cfg={}, live=True,
                       delta_cap=DELTA_CAP, device=DEVICE)
    build_s = time.perf_counter() - t0
    one = SearchServer(corpus, engine="brute", cfg={}, live=True, delta_cap=DELTA_CAP,
                       device=DEVICE)
    rows, dead = _upserts(corpus, DELTA_CAP - 1, seed)
    for s_ in (srv, one):
        s_.upsert(rows)
        s_.delete(dead)
    served = Qh[:LIVE_SHARD_BATCHES * BATCH]
    (times, found), counts = counted(lambda: _serve_all(srv, served))
    require(counts, {"topk/f32": 3 * LIVE_SHARD_BATCHES, "rescore": LIVE_SHARD_BATCHES},
            what)
    leaked = int(np.isin(found, dead).sum())
    ref = [one.query(served[s:s + BATCH], k=K + 1) for s in range(0, served.shape[0], BATCH)]
    ref_i = torch.as_tensor(np.concatenate([r.idx for r in ref]))
    ref_d = torch.as_tensor(np.concatenate([r.dist for r in ref]))
    got = [srv.query(served[s:s + BATCH], k=K) for s in range(0, served.shape[0], BATCH)]
    same, ids_ok = ids_agree(torch.as_tensor(np.concatenate([r.idx for r in got])),
                             ref_i, ref_d, K)
    err, dist_ok = close_matmul(torch.as_tensor(np.concatenate([r.dist for r in got])),
                                ref_d[:, :K])
    if leaked or not (ids_ok and dist_ok):
        fail(f"{what}: leaked {leaked} deleted ids; against the one-shard live server "
             f"identical ids {same}, max err {err}")
    n = corpus.shape[0]
    kf = min(n // 2, scan_lib.pow2ceil(K + dead.size))
    operands = {"shard": srv.index.frozen_X[:n // 2], "kf": kf}
    del one

    t0 = time.perf_counter()
    srv.compact("full")
    compact_s = time.perf_counter() - t0
    stats = srv.stats()
    alive = n - int(dead.size) + DELTA_CAP - 1
    if (stats["frozen_size"], stats["delta_fill"]) != (alive - alive % 2, alive % 2):
        fail(f"{what}: compaction left frozen {stats['frozen_size']} / delta "
             f"{stats['delta_fill']}, want {alive - alive % 2} / {alive % 2}")
    path = os.path.join(tmp, "live-sharded")
    t0 = time.perf_counter()
    srv.snapshot(path)
    back = SearchServer.restore(path, device=DEVICE)
    restore_s = time.perf_counter() - t0
    fresh = index_lib.build("brute", srv.index.corpus(), {}, device=DEVICE)
    for label, s_ in (("after compaction", srv), ("restored", back)):
        for s in range(0, served.shape[0], BATCH):
            ref = fresh.search(torch.as_tensor(served[s:s + BATCH], device=DEVICE), k=K + 1)
            res = s_.query(served[s:s + BATCH], k=K)
            same_c, ok = ids_agree(torch.as_tensor(res.idx, device=DEVICE), ref.idx,
                                   ref.dist, K)
            err_c, ok_d = close_matmul(torch.as_tensor(res.dist, device=DEVICE),
                                       ref.dist[:, :K])
            if not (ok and ok_d):
                fail(f"{what} {label}, batch at {s}: against a fresh brute identical "
                     f"ids {same_c}, max err {err_c}")
    row = {"what": what, "shards": 2, "delta_cap": DELTA_CAP, "upserts": DELTA_CAP - 1,
           "deleted": int(dead.size), "frozen_oversample": kf, "batches": len(times),
           "batch": BATCH, "build_seconds": build_s,
           "p50_batch_ms": _p(times, 50), "p99_batch_ms": _p(times, 99),
           "leaked": leaked, "identical_ids_vs_one_shard_live": same,
           "max_abs_err_vs_one_shard_live": err, "compact_seconds": compact_s,
           "carried_into_delta": stats["delta_fill"],
           "snapshot_restore_seconds": restore_s, "launches": counts}
    log("sharded " + json.dumps(row))
    del srv, back, fresh
    return row, counts, operands


def _roofline(corpus, inf_srv) -> list[dict]:
    """``capture_roofline`` for brute f32 (one shard and two) and for the
    two-shard infinity server at the serving batch; ``core/profile``
    raises where ``pct_of_peak`` would pass 1.05."""
    from repro_torch.launch.serve import SearchServer

    rows = []
    for label, srv, budget in (
            ("brute f32 S=1", SearchServer(corpus, engine="brute", cfg={}, device=DEVICE),
             None),
            ("brute f32 S=2", SearchServer(corpus, engine="brute", shards=2, cfg={},
                                           device=DEVICE), None),
            ("infinity S=2", inf_srv, SEARCH_KW["budget"])):
        t0 = time.perf_counter()
        out = srv.capture_roofline(batch=BATCH, k=K, budget=budget)
        (name, prof), = out.items()
        row = {"what": "roofline", "server": label, "seconds": time.perf_counter() - t0,
               **prof}
        rows.append(row)
        log("sharded " + json.dumps(row))
        if not 0.0 < prof["pct_of_peak"] <= 1.05:
            fail(f"roofline {label}: pct_of_peak {prof['pct_of_peak']}")
    return rows


def _runtime(corpus, Qt) -> dict:
    """``ServingRuntime`` and its HTTP front over a two-shard brute server:
    ``RUNTIME_CLIENTS`` concurrent clients post ``RUNTIME_REQUESTS``
    single-query requests; every answer equals the server's direct answer
    up to near ties; then a runtime that is not started, its queue full,
    answers 429."""
    import threading
    import urllib.error
    import urllib.request

    import numpy as np
    import torch

    from repro_torch.launch.runtime import OverloadPolicy, ServingRuntime, start_http_front
    from repro_torch.launch.serve import SearchServer

    srv = SearchServer(corpus, engine="brute", shards=2, cfg={}, device=DEVICE)
    Qh = Qt[:RUNTIME_REQUESTS].cpu().numpy()
    direct = srv.query(Qh, k=K + 1, record=False)
    for b in (1, 2, 4, 8, 16, 32, 64):  # every bucket the batcher can form
        srv.query(Qh[:b], k=K, record=False)
    run = ServingRuntime(srv, OverloadPolicy(**RUNTIME_POLICY)).start()
    httpd = start_http_front(run, port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}/search"
    answers: dict = {}
    errors: list = []

    def client(rows):
        for i in rows:
            body = json.dumps({"q": Qh[i].tolist(), "k": K,
                               "deadline_ms": SHARD_DEADLINE_MS}).encode()
            req = urllib.request.Request(url, data=body,
                                         headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=60) as resp:
                    answers[i] = json.loads(resp.read())
            except Exception as e:  # noqa: BLE001 — reported and failed below
                errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(range(c, RUNTIME_REQUESTS,
                                                           RUNTIME_CLIENTS),))
               for c in range(RUNTIME_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    httpd.shutdown()
    run.stop()
    stats = run.stats()
    if errors or len(answers) != RUNTIME_REQUESTS:
        fail(f"runtime: {len(answers)} answers, errors {errors[:3]}")
    ids = torch.as_tensor(np.stack([answers[i]["idx"] for i in range(RUNTIME_REQUESTS)]))
    same, ok = ids_agree(ids, torch.as_tensor(direct.idx), torch.as_tensor(direct.dist), K)
    waits = [answers[i]["queue_ms"] for i in range(RUNTIME_REQUESTS)]

    # a full queue answers 429 with Retry-After
    idle = ServingRuntime(srv, OverloadPolicy(capacity=2))
    httpd = start_http_front(idle, port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}/search"

    def post():
        req = urllib.request.Request(url, data=json.dumps(
            {"q": Qh[0].tolist(), "k": K}).encode(),
            headers={"Content-Type": "application/json"})
        return urllib.request.urlopen(req, timeout=60)

    def fill():
        try:
            post()
        except urllib.error.HTTPError:
            pass  # shed at shutdown: 504

    fillers = [threading.Thread(target=fill) for _ in range(2)]
    for t in fillers:
        t.start()
    deadline = time.monotonic() + 10.0
    while idle.queue.depth() < 2 and time.monotonic() < deadline:
        time.sleep(0.005)
    code = retry_after = None
    try:
        post()
    except urllib.error.HTTPError as e:
        code, retry_after = e.code, e.headers.get("Retry-After")
    httpd.shutdown()
    idle.stop()
    for t in fillers:
        t.join()
    row = {"what": "runtime + http front", "server": "brute f32 S=2",
           "clients": RUNTIME_CLIENTS, "requests": RUNTIME_REQUESTS,
           "policy": RUNTIME_POLICY, "seconds": wall,
           "requests_per_s": RUNTIME_REQUESTS / wall,
           "queue_wait_p50_ms": float(np.percentile(waits, 50)),
           "queue_wait_p99_ms": float(np.percentile(waits, 99)),
           "batches": stats["batches"],
           "batch_fill_mean": stats["completed"] / max(1, stats["batches"]),
           "identical_ids_vs_direct": same, "answers_equal_direct": ok,
           "full_queue_status": code, "retry_after": retry_after,
           "stats": stats}
    log("sharded " + json.dumps(row))
    if not ok or stats["completed"] != RUNTIME_REQUESTS or code != 429 \
            or not retry_after:
        fail(f"runtime: {row}")
    return row


def _shard_kernel_rows(corpus_t, Qt, cents, live_ops: dict) -> list[dict]:
    """The kernels at the shard windows' shapes, each against its plain
    version: the f32 topk and the int8 topk on one shard's rows (S = 2 and
    4), the pdist of the IVF-Flat probes (one shard's 256 centroids) and
    the live-over-sharded frozen scan (one shard at the oversampled k')."""
    import torch

    from repro_torch.core import quant as quant_lib
    from repro_torch.dist import roofline
    from repro_torch.kernels.pdist.pdist import pdist_cuda
    from repro_torch.kernels.pdist.ref import pdist_ref
    from repro_torch.kernels.topk.ref import quantize_queries, topk_quant_ref, topk_ref
    from repro_torch.kernels.topk.topk import topk_cuda, topk_quant_cuda

    q = Qt[:BATCH]
    n, d = corpus_t.shape
    rows = []
    for S in SHARD_COUNTS:
        Y = corpus_t[:n // S]
        m, ns = q.shape[0], Y.shape[0]
        od, oi = topk_cuda(q, Y, k=K, metric="euclidean")
        rd, ri = topk_ref(q, Y, k=K + 1, metric="euclidean")
        err, ok = close_matmul(od, rd[:, :K])
        same, ids_ok = ids_agree(oi, ri, rd, K)
        if not (ok and ids_ok):
            fail(f"topk shard S={S} disagrees with its plain version ({err}, {same})")
        rows.append({
            "name": "topk", "case": f"shard batch {m}x{ns}x{d} k={K} euclidean",
            "path": f"sharded brute f32 serve S={S}", "counter": "topk/f32",
            "source": "src/repro_torch/csrc/topk.cu",
            "replaces": "src/repro/kernels/topk/topk.py:123",
            "max_abs_err": err, "ids_identical": same,
            "ms": cuda_ms(lambda: topk_cuda(q, Y, k=K, metric="euclidean"), 20),
            "plain_ms": cuda_ms(lambda: topk_ref(q, Y, k=K, metric="euclidean"), 20),
            "library_ms": cuda_ms(lambda: torch.topk(torch.cdist(q, Y), K, dim=1,
                                                     largest=False), 20),
            "bound": _bound(*roofline.topk_work(m, ns, d, K, cube=False, masked=False)),
        })
        log("kernel " + json.dumps(rows[-1]))

        codes, scales, sqn = quant_lib.QuantStore.build(Y).device_view()
        kq = quant_lib.shortlist_width(K, ns)
        od, oi = topk_quant_cuda(q, codes, scales, sqn, k=kq)
        rd, ri = topk_quant_ref(q, codes, scales, sqn, k=kq)
        err = float((od - rd).abs().max())
        if not (torch.equal(od, rd) and torch.equal(oi, ri)):
            fail(f"topk int8 shard S={S} is not bit-identical to its plain version")

        def library():
            xq, alpha, xn = quantize_queries(q, scales)
            acc = torch._int_mm(xq, codes.T)
            d2 = xn[:, None] + sqn[None, :] - 2.0 * (acc.float() * alpha[:, None])
            return torch.topk(torch.sqrt(d2.clamp_min(0.0)), kq, dim=1, largest=False)

        rows.append({
            "name": "topk_int8", "case": f"shard batch {m}x{ns}x{d} K={kq} euclidean",
            "path": f"sharded brute+quant serve S={S}", "counter": "topk/int8",
            "source": "src/repro_torch/csrc/topk_int8.cu",
            "replaces": "src/repro/kernels/topk/topk.py:207",
            "max_abs_err": err, "ids_identical": 1.0,
            "ms": cuda_ms(lambda: topk_quant_cuda(q, codes, scales, sqn, k=kq), 20),
            "plain_ms": cuda_ms(lambda: topk_quant_ref(q, codes, scales, sqn, k=kq), 20),
            "library_ms": cuda_ms(library, 20),
            "bound": _bound(*roofline.topk_int8_work(m, ns, d, kq, masked=False)),
        })
        log("kernel " + json.dumps(rows[-1]))
        del codes, sqn

    # the IVF-Flat probes of one shard: the batch against its 256 centroids
    C = cents
    m, nc = q.shape[0], C.shape[0]
    out, ref = pdist_cuda(q, C, metric="euclidean"), pdist_ref(q, C, metric="euclidean")
    err, ok = close_matmul(out, ref)
    if not ok:
        fail(f"pdist IVF probes disagree with the plain version ({err})")
    rows.append({
        "name": "pdist", "case": f"IVF-Flat probes {m}x{nc}x{d} euclidean",
        "path": "sharded ivf_flat serve S=2", "counter": "pdist/matmul",
        "source": "src/repro_torch/csrc/pdist.cu",
        "replaces": "src/repro/kernels/pdist/pdist.py:36", "max_abs_err": err,
        "ms": cuda_ms(lambda: pdist_cuda(q, C, metric="euclidean"), 20),
        "plain_ms": cuda_ms(lambda: pdist_ref(q, C, metric="euclidean"), 20),
        "library_ms": cuda_ms(lambda: torch.cdist(q, C), 20),
        "bound": _bound(*roofline.pdist_work(m, nc, d, cube=False)),
    })
    log("kernel " + json.dumps(rows[-1]))

    # one shard's frozen scan under live at k' (the select)
    Y, kf = live_ops["shard"], live_ops["kf"]
    ns = Y.shape[0]
    od, oi = topk_cuda(q, Y, k=kf, metric="euclidean")
    rd, ri = topk_ref(q, Y, k=kf + 1, metric="euclidean")
    err, ok = close_matmul(od, rd[:, :kf])
    same, ids_ok = ids_agree(oi, ri, rd, kf)
    if not (ok and ids_ok):
        fail(f"topk live shard scan disagrees with its plain version ({err}, {same})")
    rows.append({
        "name": "topk", "case": f"live shard scan {m}x{ns}x{d} k={kf} euclidean",
        "path": "live brute f32 serve S=2", "counter": "topk/f32",
        "source": "src/repro_torch/csrc/topk.cu",
        "replaces": "src/repro/kernels/topk/topk.py:123",
        "max_abs_err": err, "ids_identical": same,
        "ms": cuda_ms(lambda: topk_cuda(q, Y, k=kf, metric="euclidean"), 3),
        "plain_ms": cuda_ms(lambda: topk_ref(q, Y, k=kf, metric="euclidean"), 3),
        "library_ms": cuda_ms(lambda: torch.topk(torch.cdist(q, Y), kf, dim=1,
                                                 largest=False), 3),
        "bound": _bound(*roofline.topk_work(m, ns, d, kf, cube=False, masked=False)),
    })
    log("kernel " + json.dumps(rows[-1]))
    return rows


def phase_sharded(corpus, Qt, main_state: dict,
                  seed: int) -> tuple[list[dict], list[dict], dict]:
    """Returns (the phase's rows, its kernel rows, its counted windows)."""
    import shutil
    import tempfile

    import torch

    t_phase = time.perf_counter()
    corpus_t = torch.as_tensor(corpus, device=DEVICE)
    gt, gt_d = main_state["gt"], main_state["gt_d"]
    rows, windows = _sharded_brute(corpus_t, Qt, gt, gt_d)
    more, more_windows, inf_srv, cents = _sharded_ivf_and_infinity(corpus, Qt, gt)
    rows += more
    windows.update(more_windows)
    row, counts = _degraded(corpus, Qt)
    rows.append(row)
    windows[row["what"]] = counts
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="phase10-", dir=os.path.join(HERE, "build"))
    try:
        row, counts, live_ops = _live_sharded(corpus, Qt, tmp, seed)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rows.append(row)
    windows[row["what"]] = counts
    rows += _roofline(corpus, inf_srv)
    del inf_srv
    rows.append(_runtime(corpus, Qt))
    kernels = _shard_kernel_rows(corpus_t, Qt, cents, live_ops)
    del corpus_t, live_ops
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 10 {time.perf_counter() - t_phase:.3f} s")
    return rows, kernels, windows


# ---------------------------------------------------------------------------
# phase 11: recsys training and the projection search at full width
# ---------------------------------------------------------------------------

TRAIN_BATCH = 65536  # configs.base.RECSYS_SHAPES train_batch
TRAIN_WARMUP, TRAIN_TIMED = 2, 10
TRAIN_LR = 1e-3  # launch/train.py's AdamW
XDEEPFM_MICROBATCHES = 8  # 8 192 rows a microbatch: ~3 x 2.6 GB of CIN outer products
# the kernel step against the plain step: the same products, the loss's
# sums and the backward's atomics in another order
TRAIN_LOSS_RTOL = 1e-5
BAG_GRAD_RTOL, BAG_GRAD_ATOL = 1e-5, 1e-7
# benchmarks/bench_projection_search.py: fashion_like, euclidean, n = 1000,
# 100 queries, the q sweep
PROJ_N, PROJ_Q = 1000, 100
PROJ_QS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, math.inf)
# E_q from the qpath kernel against the plain qpath: minmax bit-identical;
# logminplus within 1e-5 a product in the log domain (LOGMINPLUS_ATOL),
# over 11 products and back through exp(L / q): rtol 1e-4
PROJ_RTOL = 1e-4
# Prop. 1 on E_q (the nearest neighbour keeps its distance, nothing
# projects below it) is held at every q; the search's first answer is held
# to the neighbour where f32 keeps it: up to q = 8.  At q = 16 the search's pruning compares
# 16th powers that the projection makes equal up to rounding, and the
# neighbour is pruned for 1 of 100 queries on the CPU as on the card (2e-7
# of noise on E_q and D_q prunes it for 2-6; q = 8 stays at 1.0), so
# q = 16 and 32 are read, not held (PERF.md section 6)
PROJ_EXACT_Q_MAX = 8.0
NO_BAG_BACKWARD_EXTRAS = "none: the training ids carry no padding and no weights"


def _plain_bag_grad():
    """The bag under autograd by its plain versions (forward and backward)
    on the card, launching no kernel: what the training step's kernel path
    is held against."""
    import torch

    from repro_torch.kernels.bag.ref import embedding_bag_backward_ref, embedding_bag_ref

    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, table, ids, weights, combine):
            ctx.save_for_backward(ids, weights)
            ctx.combine, ctx.rows = combine, table.shape[0]
            return embedding_bag_ref(table, ids, weights, combine=combine)

        @staticmethod
        def backward(ctx, g):
            ids, weights = ctx.saved_tensors
            return (embedding_bag_backward_ref(g.contiguous(), ids, weights, ctx.rows,
                                               combine=ctx.combine), None, None, None)

    def bag(table, ids, weights=None, *, combine="sum"):
        return Fn.apply(table, ids, weights, combine)

    return bag


@contextlib.contextmanager
def plain_bag_grad():
    """Within: the recsys model's bags run their plain forward and backward
    (``_plain_bag_grad``) on the card."""
    from repro_torch.models import recsys as recsys_lib

    saved = recsys_lib.embedding_bag
    recsys_lib.embedding_bag = _plain_bag_grad()
    try:
        yield
    finally:
        recsys_lib.embedding_bag = saved


def _peak_reset():
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def _tree_bytes(tree) -> int:
    from repro_torch.train import tree as tree_lib

    return sum(t.numel() * t.element_size() for t in tree_lib.leaves(tree)
               if hasattr(t, "numel"))


def _train_deepfm(tmp: str) -> tuple[list[dict], dict]:
    """DeepFM at published widths and the train batch: the timed steps (a
    counted window), the kernel step against the plain step, one step with
    microbatches and int8 compression, and the checkpoint round trip
    written while the next step runs.  Weights and batches as
    ``launch.train.build`` makes them (seed 0, as JAX's launcher)."""
    import numpy as np
    import torch

    from repro_torch.launch import train as train_launch
    from repro_torch.models.recsys import recsys_loss
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import tree as tree_lib
    from repro_torch.train.train_step import make_train_step, value_and_grad
    from repro_torch import configs

    dev = torch.device(DEVICE)
    cfg = configs.get("deepfm")
    t0 = time.perf_counter()
    params, state, step, batches = train_launch.build("deepfm", reduced=False,
                                                      batch=TRAIN_BATCH, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = TRAIN_WARMUP + TRAIN_TIMED
    data = [batches(t) for t in range(n + 2)]
    rows, windows = [], {}

    # the kernel step against the plain step: one gradient from the same
    # weights and batch, the bag and its backward by their kernels, then by
    # their plain versions
    (g_k, m_k), counts_k = counted(lambda: value_and_grad(recsys_loss, params, data[0], cfg))
    require(counts_k, {"bag": 1, "bag_backward": 1}, "deepfm gradient, kernels")
    with plain_bag_grad():
        (g_p, m_p), counts_p = counted(
            lambda: value_and_grad(recsys_loss, params, data[0], cfg))
    require(counts_p, {}, "deepfm gradient, plain bag")
    loss_k, loss_p = float(m_k["loss"]), float(m_p["loss"])
    if not (math.isfinite(loss_k) and abs(loss_k - loss_p) <= TRAIN_LOSS_RTOL * abs(loss_p)):
        fail(f"deepfm train step: loss {loss_k} against the plain bag's {loss_p}")
    lin_k, lin_p = g_k["linear"], g_p["linear"]
    lin_err = float((lin_k - lin_p).abs().max())
    if not torch.allclose(lin_k, lin_p, rtol=BAG_GRAD_RTOL, atol=BAG_GRAD_ATOL):
        fail(f"deepfm train step: linear gradient off the plain backward's by {lin_err}")
    table_err = float((g_k["table"] - g_p["table"]).abs().max())
    parity = {"loss_kernel": loss_k, "loss_plain": loss_p,
              "linear_grad_max_abs_err": lin_err, "table_grad_max_abs_err": table_err,
              "linear_grad_rows_touched": int((lin_p != 0).sum()),
              "launches": counts_k, "plain_launches": counts_p}
    del g_k, g_p, lin_k, lin_p
    gc.collect()

    # the timed steps: TRAIN_WARMUP then TRAIN_TIMED, one counted window
    def run():
        p, s = params, state
        times, losses = [], []
        for t in range(n):
            t0 = time.perf_counter()
            p, s, m = step(p, s, data[t])
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return p, s, times, losses

    _peak_reset()
    (params2, state2, times, losses), counts = counted(run)
    peak = torch.cuda.max_memory_allocated()
    require(counts, {"bag": n, "bag_backward": n}, "deepfm train_batch")
    if not all(math.isfinite(x) for x in losses):
        fail(f"deepfm train_batch: non-finite losses {losses}")
    timed = times[TRAIN_WARMUP:]
    p50 = float(np.median(timed))
    windows["deepfm train_batch"] = counts
    rows.append({"arch": "deepfm", "shape": "train_batch", "batch": TRAIN_BATCH,
                 "optimizer": f"adamw {TRAIN_LR}", "init_seconds": init_s,
                 "steps_timed": TRAIN_TIMED, "p50_step_ms": p50 * 1e3,
                 "mean_step_ms": float(np.mean(timed)) * 1e3,
                 "step_ms": [x * 1e3 for x in times],
                 "examples_per_s": TRAIN_BATCH / p50, "peak_memory_bytes": int(peak),
                 "param_bytes": _tree_bytes(params), "opt_state_bytes": _tree_bytes(state),
                 "loss_first": losses[0], "loss_last": losses[-1], "losses": losses,
                 "launches": counts,
                 "launches_per_step": {k: v / n for k, v in counts.items() if v},
                 "kernel_vs_plain": parity, "mlp_gflop_per_step": 3 * _mlp_gflop(cfg, TRAIN_BATCH)})
    log("training " + json.dumps(rows[-1]))
    del params, state
    params, state = params2, state2
    del params2, state2
    gc.collect()

    # microbatches and int8 compression, one step
    opt = opt_lib.adamw(TRAIN_LR)
    mstep = make_train_step(cfg, "recsys", opt, microbatches=2, grad_compression="int8")
    _peak_reset()

    def one():
        t0 = time.perf_counter()
        out = mstep(params, state, data[n])
        loss = float(out[2]["loss"])
        torch.cuda.synchronize()
        return out, loss, time.perf_counter() - t0

    ((p3, s3, _), loss, dt), counts = counted(one)
    require(counts, {"bag": 2, "bag_backward": 2}, "deepfm train_batch mb=2 int8")
    if not math.isfinite(loss):
        fail(f"deepfm mb=2 int8 step: loss {loss}")
    windows["deepfm train_batch mb=2 int8"] = counts
    rows.append({"arch": "deepfm", "shape": "train_batch", "batch": TRAIN_BATCH,
                 "microbatches": 2, "grad_compression": "int8", "step_ms": dt * 1e3,
                 "loss": loss, "peak_memory_bytes": int(torch.cuda.max_memory_allocated()),
                 "launches": counts})
    log("training " + json.dumps(rows[-1]))
    del p3, s3
    gc.collect()

    # the checkpoint round trip: the host copy on this thread, the write on
    # the saver's thread while the next step runs, then the restore
    saver = ckpt_lib.AsyncCheckpointer(tmp, keep=1)
    tree = (params, state)
    t0 = time.perf_counter()
    saver.save(state.step, tree)
    t1 = time.perf_counter()
    nxt, nxt_state, m = step(params, state, data[n + 1])
    float(m["loss"])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    saver.wait()
    t3 = time.perf_counter()
    del nxt, nxt_state
    gc.collect()
    disk = sum(os.path.getsize(os.path.join(root, f)) for root, _, files in os.walk(tmp)
               for f in files)
    t4 = time.perf_counter()
    (rp, rs), rstep = ckpt_lib.restore(tmp, tree, device=dev)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    if rstep != state.step:
        fail(f"checkpoint: restored step {rstep}, saved {state.step}")
    for (key, a), (_, b) in zip(tree_lib.paths(tree), tree_lib.paths((rp, rs))):
        same = a == b if isinstance(a, int) else (a.dtype == b.dtype and torch.equal(a, b))
        if not same:
            fail(f"checkpoint: leaf {key} differs after the round trip")
    ck = {"arch": "deepfm", "what": "checkpoint round trip", "step": rstep,
          "leaves": len(tree_lib.leaves(tree)), "tree_bytes": _tree_bytes(tree),
          "disk_bytes": disk, "host_copy_seconds": t1 - t0,
          "step_during_write_ms": (t2 - t1) * 1e3, "write_seconds": t3 - t1,
          "restore_seconds": t5 - t4, "bit_equal": True}
    log("checkpoint " + json.dumps(ck))
    del rp, rs, tree, params, state, data
    gc.collect()
    torch.cuda.empty_cache()
    return rows + [ck], windows


def _train_xdeepfm() -> tuple[dict, dict]:
    """xDeepFM at published widths (CIN 200-200-200), one train batch in
    XDEEPFM_MICROBATCHES microbatches, two steps (the first builds cuBLAS's
    plans), the second timed."""
    import torch

    from repro_torch.launch import train as train_launch
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step
    from repro_torch import configs

    dev = torch.device(DEVICE)
    cfg = configs.get("xdeepfm")
    params, state, _, batches = train_launch.build("xdeepfm", reduced=False,
                                                   batch=TRAIN_BATCH, device=dev)
    step = make_train_step(cfg, "recsys", opt_lib.adamw(TRAIN_LR),
                           microbatches=XDEEPFM_MICROBATCHES)
    data = [batches(t) for t in range(2)]
    _peak_reset()

    def run():
        p, s, out = params, state, []
        for t in range(2):
            t0 = time.perf_counter()
            p, s, m = step(p, s, data[t])
            out.append((float(m["loss"]), time.perf_counter() - t0))
        torch.cuda.synchronize()
        return out

    got, counts = counted(run)
    what = f"xdeepfm train_batch mb={XDEEPFM_MICROBATCHES}"
    require(counts, {"bag": 2 * XDEEPFM_MICROBATCHES, "bag_backward": 2 * XDEEPFM_MICROBATCHES},
            what)
    if not all(math.isfinite(loss) for loss, _ in got):
        fail(f"{what}: losses {got}")
    B = TRAIN_BATCH // XDEEPFM_MICROBATCHES
    row = {"arch": "xdeepfm", "shape": "train_batch", "batch": TRAIN_BATCH,
           "microbatches": XDEEPFM_MICROBATCHES, "cin_layers": list(cfg.cin_layers),
           "step_ms": [dt * 1e3 for _, dt in got], "losses": [loss for loss, _ in got],
           "peak_memory_bytes": int(torch.cuda.max_memory_allocated()),
           "cin_outer_product_bytes_per_layer": 4 * B * max(cfg.cin_layers) * cfg.n_sparse
           * cfg.embed_dim,
           "launches": counts}
    log("training " + json.dumps(row))
    del params, state, data
    gc.collect()
    torch.cuda.empty_cache()
    return row, {what: counts}


def _projection_search(sweeps: dict) -> tuple[list[dict], dict]:
    """``benchmarks/bench_projection_search.py``'s flow on the card: D and
    the query rows by the pdist kernel, then per q the projection of the
    query rows (``project_with_queries``, a counted window: the
    projection's sweeps and one product of the rows by D_q on the qpath
    kernel), E_q against the same computed with the plain qpath, and the
    exact best-first search over the VP tree of D_q.  Prop. 1: the nearest
    neighbour survives the projection — E_q at it and E_q's least value
    are its distance (rtol ``PROJ_RTOL``), held at every q — so up to q =
    ``PROJ_EXACT_Q_MAX`` the search's first answer must be it (recall@1 =
    1.0) and have that E_q; recall@1 above that q, recall@10 and
    RankOrder@10 are read, not held."""
    import numpy as np
    import torch

    from repro_torch.core import metrics, qmetric, vptree
    from repro_torch.data import synthetic
    from repro_torch.kernels.qpath.ref import qpath_matmul_ref

    dev = torch.device(DEVICE)
    X = torch.as_tensor(synthetic.make("fashion_like", PROJ_N + PROJ_Q, seed=0), device=dev)
    Xtr, Q = X[:PROJ_N], X[PROJ_N:]
    D = metrics.pairwise(Xtr, Xtr, metric="euclidean").clone()
    D.fill_diagonal_(0.0)
    D = (D + D.T) / 2
    rows_q = metrics.pairwise(Q, Xtr, metric="euclidean")
    gt = torch.sort(rows_q, dim=1, stable=True).indices[:, :K].cpu().numpy()
    sweeps_n = qmetric._num_sweeps(PROJ_N)
    out, windows = [], {}
    for q in PROJ_QS:
        mode = "minmax" if math.isinf(q) else "logminplus"
        label = f"projection search q={'inf' if math.isinf(q) else int(q)}"
        rec = sweeps.setdefault(label, []) if label in QPATH_WINDOWS else None

        def window():
            t0 = time.perf_counter()
            with recorded_sweeps(rec):
                Eq = qmetric.project_with_queries(D, rows_q, q, row_block=16)
            torch.cuda.synchronize()
            return Eq, time.perf_counter() - t0

        (Eq, proj_s), counts = counted(window)
        require(counts, {f"qpath/{mode}": sweeps_n + 1}, label)
        windows[label] = counts
        inner = qmetric.qpath_ops.qpath_matmul
        qmetric.qpath_ops.qpath_matmul = (
            lambda A, B, *, mode="minmax", row_block=32: qpath_matmul_ref(
                A, B, mode=mode, row_block=row_block))
        try:
            (Eq_plain, Dq), plain_counts = counted(lambda: (
                qmetric.project_with_queries(D, rows_q, q, row_block=16),
                qmetric.canonical_projection(D, q, row_block=16)))
        finally:
            qmetric.qpath_ops.qpath_matmul = inner
        require(plain_counts, {}, f"{label}, plain qpath")
        err = float((Eq - Eq_plain).abs().max())
        ok = (torch.equal(Eq, Eq_plain) if math.isinf(q)
              else bool(((Eq - Eq_plain).abs() <= PROJ_RTOL * Eq_plain.abs()).all()))
        if not ok or not bool(torch.isfinite(Eq).all()):
            fail(f"{label}: E_q off the plain qpath's by {err}")
        # exp(q log d / q) may round a last ulp above d
        if not bool((Eq <= rows_q * (1 + 1e-6)).all()):
            fail(f"{label}: a projected distance above the direct one")
        t0 = time.perf_counter()
        tree = vptree.build_vptree(D=Dq.cpu().numpy(), seed=0, device=dev)
        ki, _, comps = vptree.search_best_first(tree, Eq, q=q, k=K)
        torch.cuda.synchronize()
        search_s = time.perf_counter() - t0
        # Prop. 1 on E_q itself, at every q: the nearest neighbour keeps its
        # distance and no point projects below it (any path to x starts
        # with an edge at least that long)
        nn = torch.as_tensor(gt[:, :1], device=dev)
        nearest = rows_q.gather(1, nn)[:, 0]

        def at_nearest(v):
            return bool(((v - nearest).abs() <= PROJ_RTOL * nearest).all())

        if not (at_nearest(Eq.gather(1, nn)[:, 0]) and at_nearest(Eq.min(1).values)):
            fail(f"{label}: E_q's least value is not the nearest neighbour's distance "
                 "(Prop. 1)")
        # and the search's first answer is the neighbour, at its distance,
        # where f32 keeps the VP tree's pruning exact: up to q =
        # PROJ_EXACT_Q_MAX (above it, read only)
        first = Eq.gather(1, ki[:, :1].long())[:, 0]
        top1_ok = at_nearest(first)
        ki = ki.cpu().numpy()
        r1 = float(np.mean(ki[:, 0] == gt[:, 0]))
        r10 = float(np.mean([len(set(a) & set(b)) / K for a, b in zip(ki, gt)]))
        pos = [{int(x): i + 1 for i, x in enumerate(t)} for t in gt]
        rank_order = float(np.mean([sum(abs((i + 1) - p.get(int(x), K + 1))
                                        for i, x in enumerate(a)) / K
                                    for a, p in zip(ki, pos)]))
        if q <= PROJ_EXACT_Q_MAX and not (top1_ok and r1 == 1.0):
            fail(f"{label}: the search's first answer is not the nearest neighbour "
                 f"(recall@1 {r1}, first at its distance {top1_ok}; Prop. 1)")
        out.append({"q": q if not math.isinf(q) else "inf", "n": PROJ_N, "queries": PROJ_Q,
                    "project_seconds": proj_s, "search_and_tree_seconds": search_s,
                    "E_q_max_abs_err_vs_plain": err, "recall@1": r1,
                    "first_at_nearest_distance": top1_ok,
                    "first_ids_off_nearest": int((ki[:, 0] != gt[:, 0]).sum()),
                    "recall@10": r10,
                    "rank_order@10": rank_order,
                    "mean_comparisons": float(comps.float().mean()), "launches": counts})
        log("projection " + json.dumps(out[-1]))
    return out, windows


def phase_training(sweeps: dict) -> tuple[list[dict], dict]:
    """Phase 11: DeepFM training, its kernel step against the plain step,
    microbatches + int8, the checkpoint round trip, xDeepFM training in
    microbatches, and the projection search."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="phase11-", dir=os.path.join(HERE, "build"))
    try:
        rows, windows = _train_deepfm(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row, win = _train_xdeepfm()
    rows.append(row)
    windows.update(win)
    proj, win = _projection_search(sweeps)
    rows += proj
    windows.update(win)
    log(f"phase 11 seconds {time.perf_counter() - t0:.3f}")
    return rows, windows


# ---------------------------------------------------------------------------
# phase 12: the GCN (serve and train) and dense-LM serving at full width
# ---------------------------------------------------------------------------

LM_REPS = 5  # timed calls of a prefill row, after one warm-up
LM_DECODE_STEPS = 16  # greedy steps of a decode row; the first is the warm-up
LM_PROMPT = 4096  # the decode rows' prompt, prefilled into the cache
# (arch, row, configs.base.LM_SHAPES name, batch, sequence or cache length,
# the cuts of that shape): smollm-135m and gemma-2b at published widths and
# full depth, random weights from --seed
LM_ROWS = (
    ("smollm-135m", "prefill", "prefill_32k", 4, 32768,
     ["batch 4 of 32: JAX's chunk schedule holds (B, KV, G, S, 1024) scores a "
      "chunk, 19.3 GB bf16 + 38.7 GB f32 at 32"]),
    ("smollm-135m", "decode", "decode_32k", 32, 32768,
     ["batch 32 of 128: the bf16 cache is 96.6 GB at 128",
      "the cache holds a 4096-token prompt"]),
    ("smollm-135m", "long decode", "long_500k", 1, 524288,
     ["the cache holds a 4096-token prompt: prefilling 524288 tokens through the "
      "chunk schedule takes minutes"]),
    ("gemma-2b", "prefill", "prefill_32k", 4, 4096,
     ["batch 4 of 32", "4096 tokens of 32768"]),
    ("gemma-2b", "decode", "decode_32k", 32, 32768,
     ["batch 32 of 128: the bf16 cache is 77.3 GB at 128, beside 10 GB of parameters",
      "the cache holds a 4096-token prompt"]),
)
# teacher forcing and bf16 against f32 at (B, S), and the card against the
# CPU at (B, S): f32 activations, TF32 off
LM_CHECK = {"smollm-135m": ((2, 64), (2, 64)), "gemma-2b": ((2, 64), (1, 16))}
LM_RTOL = LM_ATOL = 1e-4
GNN_SERVE_REPS = 5  # timed, after one warm-up
GNN_TRAIN_STEPS = 10  # AdamW steps; the p50 is over the nine after the first
GNN_LR = 1e-2  # launch/train.py's AdamW for gcn-cora
GNN_CPU_STEPS = 3
# full_graph_sm on the card against the CPU (index_add sums with atomics on
# the card, in another order)
GNN_RTOL = GNN_ATOL = 1e-5
# ogb_products in f32 against the same forward in f64 on the card: each
# logit within 1e-4 of its f64 value, relative, plus 1e-4 of the f64
# logits' rms (a logit near 0 is a difference of terms ~its rms in size)
GNN_F64_RTOL = 1e-4


def _lm_tokens(cfg, batch: int, seq: int, seed: int, dev):
    """``TokenStream(vocab, seq, batch, seed=seed).batch(0)`` on ``dev``."""
    import torch

    from repro_torch.data.tokens import TokenStream

    toks = TokenStream(cfg.vocab_size, seq, batch, seed=seed).batch(0)["tokens"]
    return torch.as_tensor(toks, device=dev)


def _lm_token_params(cfg, absorb: bool = False) -> int:
    """Weights one token multiplies through the layers' matmuls: GQA's or
    MLA's projections (absorbed decode: W_uk and W_uv too), the dense FFN
    or the MoE layer's router, k routed experts and the shared ones."""
    d, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cfg.attention == "mla":
        m = cfg.mla
        attn = (d * m.q_lora_rank + m.q_lora_rank * H * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                + d * (m.kv_lora_rank + m.qk_rope_head_dim) + H * m.v_head_dim * d)
        if absorb:
            attn += H * m.kv_lora_rank * (m.qk_nope_head_dim + m.v_head_dim)
    else:
        attn = 2 * d * H * Dh + 2 * d * KV * Dh
    moe = (3 * d * cfg.moe_d_ff * (cfg.num_experts_per_tok + cfg.num_shared_experts)
           + d * cfg.num_experts)
    return (cfg.num_layers * attn + cfg.num_dense_layers * 3 * d * cfg.d_ff
            + cfg.num_moe_layers * moe)


def _lm_pair_flops(cfg, absorb: bool = False) -> int:
    """Flops of one (query, key) pair in one layer: the scores and the
    value product (MLA absorbed: against the latent)."""
    H = cfg.num_heads
    if cfg.attention != "mla":
        return 4 * H * cfg.head_dim
    m = cfg.mla
    if absorb:
        return 2 * H * (2 * m.kv_lora_rank + m.qk_rope_head_dim)
    return 2 * H * (m.qk_nope_head_dim + m.qk_rope_head_dim + m.v_head_dim)


def _lm_expand_flops(cfg, absorb: bool = False) -> int:
    """Flops of expanding one key position's K and V from MLA's latent in
    one layer (the naive and chunked branches; 0 for GQA and absorbed)."""
    if cfg.attention != "mla" or absorb:
        return 0
    m = cfg.mla
    return 2 * m.kv_lora_rank * cfg.num_heads * (m.qk_nope_head_dim + m.v_head_dim)


def _lm_cache_bytes(cfg, batch: int, T: int) -> int:
    per = ((cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) if cfg.attention == "mla"
           else 2 * cfg.num_kv_heads * cfg.head_dim)
    return cfg.num_layers * batch * T * per * cfg.act_dtype().itemsize


def _lm_param_bytes(cfg, touched=None) -> int:
    """Bytes of the parameters a serving call reads (f32, as stored): all
    but the MTP module, and of each MoE layer's experts only ``touched``
    (the mean the routing reached; None: all)."""
    from repro_torch.models import params as params_lib
    from repro_torch.models import transformer

    decls = transformer.lm_decls(cfg)
    out = params_lib.param_bytes(decls)
    if "mtp" in decls:
        out -= params_lib.param_bytes(decls["mtp"])
    if cfg.moe and touched is not None:
        expert = 3 * cfg.d_model * cfg.moe_d_ff * cfg.pdtype().itemsize
        out -= round(cfg.num_moe_layers * (cfg.num_experts - touched) * expert)
    return out


def _lm_bound(cfg, batch: int, S: int, T: int, read_cache: int, absorb: bool = False,
              touched=None) -> dict:
    """The least time of one LM call on ``batch`` sequences of ``S`` new
    tokens against a cache of ``T`` positions (prefill: S = T, causal;
    decode: S = 1, attending to ``read_cache`` positions): the layers'
    matmuls (MoE: k routed experts and the shared one a token), the
    attention's products (MLA: naive or absorbed, as run, the naive
    branches expanding K / V once a key position) and the head's (last
    token only) at the bf16 peak; the bytes of the parameters read (f32, as
    stored; MoE: the experts the routing touched), the cache read
    (``read_cache`` positions) or written (``T``), and the tokens and
    logits."""
    L = cfg.num_layers
    pairs = batch * S * (S + 1) / 2 if S > 1 else batch * read_cache
    keys = batch * S if S > 1 else batch * read_cache
    flops = (2 * _lm_token_params(cfg, absorb) * batch * S
             + L * (pairs * _lm_pair_flops(cfg, absorb) + keys * _lm_expand_flops(cfg, absorb))
             + 2 * cfg.d_model * cfg.vocab_size * batch)
    cache = _lm_cache_bytes(cfg, batch, T if S > 1 else read_cache)
    nbytes = (_lm_param_bytes(cfg, touched) + cache + 4 * batch * S
              + cfg.vocab_size * batch * cfg.act_dtype().itemsize)
    return _bound(flops, "bf16", nbytes)


def _within(out, ref):
    """(max |out - ref|, whether within LM_RTOL / LM_ATOL, the largest
    |out - ref| / (LM_ATOL + LM_RTOL |ref|): the margin)."""
    err, ok = close_matmul(out, ref, rtol=LM_RTOL, atol=LM_ATOL)
    ratio = float(((out - ref).abs() / (LM_ATOL + LM_RTOL * ref.abs())).max())
    return err, ok, ratio


def _lm_checks(arch: str, model, seed: int, smi: str) -> dict:
    """Teacher forcing (every position decoded through the cache equals
    the forward; prefill's last logits the forward's last row), the card
    against the CPU (the same weights and prompt) — both with f32
    activations, held at LM_RTOL / LM_ATOL — and bf16 against f32 on the
    card (the largest logit difference over the f32 logits' standard
    deviation, read, not held)."""
    import dataclasses

    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.train import tree as tree_lib

    dev = torch.device(DEVICE)
    cfg = model.cfg
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    (B, S), (Bc, Sc) = LM_CHECK[arch]
    toks = _lm_tokens(cfg, B, S, seed + 1, dev)
    with torch.inference_mode():
        full = tf.lm_forward(model, toks, cfg32)[0]
        cache = tf.init_cache(cfg32, B, S, device=dev)
        steps = torch.cat([tf.lm_decode_step(model, cache, toks[:, t:t + 1], t, cfg32)[0]
                           for t in range(S)], dim=1)
        last, _ = tf.lm_prefill(model, toks, cfg32)
        half = tf.lm_forward(model, toks, cfg)[0].float()
        card = tf.lm_forward(model, toks[:Bc, :Sc], cfg32)[0]
    tf_err, tf_ok, tf_ratio = _within(steps, full)
    pf_err, pf_ok, pf_ratio = _within(last[:, 0], full[:, -1])
    cpu = tf.LMModel(cfg, tree_lib.tree_map(lambda t: t.cpu(), model.tree()))
    with torch.inference_mode():
        ref = tf.lm_forward(cpu, toks[:Bc, :Sc].cpu(), cfg32)[0]
    del cpu
    cc_err, cc_ok, cc_ratio = _within(card.cpu(), ref)
    out = {"arch": arch, "check": "teacher forcing, card against CPU, bf16 against f32",
           "teacher_forcing": {"batch": B, "seq": S, "max_abs_err": tf_err, "ok": tf_ok,
                               "of_tolerance": tf_ratio},
           "prefill_vs_forward": {"max_abs_err": pf_err, "ok": pf_ok,
                                  "of_tolerance": pf_ratio},
           "card_vs_cpu": {"batch": Bc, "seq": Sc, "max_abs_err": cc_err, "ok": cc_ok,
                           "of_tolerance": cc_ratio},
           "bf16_vs_f32": {"max_abs_diff": float((half - full).abs().max()),
                           "f32_std": float(full.std()),
                           "over_std": float((half - full).abs().max() / full.std())},
           "rtol": LM_RTOL, "atol": LM_ATOL, "device": smi}
    if not (tf_ok and pf_ok and cc_ok and math.isfinite(out["bf16_vs_f32"]["over_std"])):
        fail(f"lm {arch} checks: {json.dumps(out)}")
    return out


@contextlib.contextmanager
def routed_experts(into: list):
    """While the block runs, append the expert ids of every MoE dispatch
    (``top_i``, a reference: no copy, no sync) to ``into``."""
    from repro_torch.models import moe

    inner = moe.moe_ffn_dispatch

    def spy(x, top_w, top_i, p, cfg):
        into.append(top_i)
        return inner(x, top_w, top_i, p, cfg)

    moe.moe_ffn_dispatch = spy
    try:
        yield into
    finally:
        moe.moe_ffn_dispatch = inner


@contextlib.contextmanager
def slot_maps(into: list):
    """While the block runs, append (top_i, eo, E_loc, C) of every
    ``moe._slot_maps`` call (references: no copy, no sync) to ``into``:
    one per rank and chunk under expert parallelism."""
    from repro_torch.models import moe

    inner = moe._slot_maps

    def spy(top_i, top_w, eo, E_loc, C, T, k, dtype):
        into.append((top_i, eo, E_loc, C))
        return inner(top_i, top_w, eo, E_loc, C, T, k, dtype)

    moe._slot_maps = spy
    try:
        yield into
    finally:
        moe._slot_maps = inner


def _slot_counts(records: list, copies: float) -> dict:
    """Assignments and capacity drops in ``slot_maps`` records, each
    (token, expert) counted once: ``copies`` ranks hold each expert (fslice:
    the data ranks of a model rank)."""
    import torch

    assigned = dropped = 0
    for top_i, eo, E_loc, C in records:
        lid = top_i.reshape(-1) - eo
        loads = torch.bincount(lid[(lid >= 0) & (lid < E_loc)], minlength=E_loc)
        assigned += int(loads.sum())
        dropped += int((loads - C).clamp_min(0).sum())
    return {"assigned": assigned / copies, "dropped": dropped / copies}


def _touched(routed: list):
    """The mean number of distinct experts one dispatch reached (None
    where no MoE layer ran)."""
    import torch

    if not routed:
        return None
    return sum(torch.unique(i).numel() for i in routed) / len(routed)


def _prefill_prompt(model, prompt, T: int, group):
    """(last logits, cache of T positions) for the prompt: one
    ``make_prefill_step(max_len=T)`` call, or, with ``group``, one prefill
    per ``group`` sequences whose caches are copied into the rows of one
    cache of T positions."""
    import torch

    from repro_torch.models.transformer import init_cache
    from repro_torch.train.train_step import make_prefill_step

    cfg = model.cfg
    if group is None:
        return make_prefill_step(cfg, max_len=T)(model, prompt)
    B, S = prompt.shape
    cache = init_cache(cfg, B, T, device=prompt.device)
    prefill, lasts = make_prefill_step(cfg), []
    for g0 in range(0, B, group):
        last, part = prefill(model, prompt[g0:g0 + group])
        for stack, leaves in part.items():
            for name, t in leaves.items():
                cache[stack][name][:, g0:g0 + group, :S] = t
        lasts.append(last)
        del part
    return torch.cat(lasts), cache


def _lm_row(model, spec: tuple, seed: int, smi: str) -> dict:
    """One ``LM_ROWS`` / ``MOE_ROWS`` row as a counted window that must
    launch no kernel: a prefill row times LM_REPS ``make_prefill_step``
    calls after a warm-up; a decode row prefills its prompt (LM_PROMPT
    tokens unless the row's options say otherwise; in batch groups where
    they say so) into a cache of T positions and times LM_DECODE_STEPS
    ``make_decode_step(mla_absorb=...)`` calls (p50 over all but the
    first).  MoE rows count the experts each dispatch reached, for the
    bound's bytes."""
    import numpy as np
    import torch

    from repro_torch.models import transformer
    from repro_torch.models.transformer import greedy
    from repro_torch.train.train_step import make_decode_step, make_prefill_step

    from repro_torch.dist.sharding import lm_policy
    from repro_torch.launch.mesh import make_test_mesh

    arch, row, shape, B, T, cuts = spec[:6]
    opts = spec[6] if len(spec) > 6 else {}
    absorb, prompt_len = opts.get("absorb", False), opts.get("prompt", LM_PROMPT)
    cfg = model.cfg
    dev = torch.device(DEVICE)
    V = cfg.vocab_size
    out = {"arch": arch, "row": row, "shape": shape, "batch": B}
    if cfg.attention == "mla":
        out["mla_absorb"] = absorb
    mesh = make_test_mesh(opts["mesh"], device=dev) if "mesh" in opts else None
    dctx = None if mesh is None else lm_policy(
        cfg, mesh, kind="prefill" if row == "prefill" else "decode", batch=B)
    routed, slots = [], []
    _peak_reset()
    if row == "prefill":
        toks = _lm_tokens(cfg, B, T, seed, dev)
        prefill = make_prefill_step(cfg, dctx, max_len=T + LM_DECODE_STEPS)
        with routed_experts(routed), slot_maps(slots):
            (res, times), counts = counted(
                lambda: _timed_calls(lambda: prefill(model, toks), LM_REPS, warmup=1))
        last, cache = res
        if tuple(last.shape) != (B, 1, V) or not bool(torch.isfinite(last).all()):
            fail(f"lm {arch} {row}: logits {tuple(last.shape)} or not finite")
        got = {f"{k}/{n}": tuple(t.shape) for k, c in cache.items() for n, t in c.items()}
        want = {f"{k}/{n}": shape for k, _, _, L in transformer._stacks(cfg)
                for n, shape in transformer._cache_shapes(
                    cfg, L, B, T + LM_DECODE_STEPS).items()}
        if got != want:
            fail(f"lm {arch} {row}: cache {got}, want {want}")
        del res, last, cache
        p50 = float(np.median(times))
        touched = _touched(routed)
        bound = _lm_bound(cfg, B, T, T + LM_DECODE_STEPS, 0, touched=touched)
        out.update(seq=T, calls=len(times), p50_ms=p50 * 1e3, tokens_per_s=B * T / p50)
    else:
        prompt = _lm_tokens(cfg, B, prompt_len, seed, dev)
        decode = make_decode_step(cfg, dctx, mla_absorb=absorb)

        def run():
            t0 = time.perf_counter()
            last, cache = _prefill_prompt(model, prompt, T, opts.get("group"))
            tok = greedy(last)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            routed.clear()  # the bound reads the decode steps' routing
            slots.clear()
            toks, times = [tok], []
            for i in range(LM_DECODE_STEPS):
                t0 = time.perf_counter()
                tok, cache = decode(model, cache, tok[:, None], prompt_len + i)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                toks.append(tok)
            return torch.stack(toks, 1), times, prefill_s

        with routed_experts(routed), slot_maps(slots):
            (gen, times, prefill_s), counts = counted(run)
        if tuple(gen.shape) != (B, LM_DECODE_STEPS + 1) or not bool(
                ((gen >= 0) & (gen < V)).all()):
            fail(f"lm {arch} {row}: generated {tuple(gen.shape)} or out of range")
        p50 = float(np.median(times[1:]))
        touched = _touched(routed)
        bound = _lm_bound(cfg, B, 1, T, T, absorb, touched)
        valid = _lm_bound(cfg, B, 1, T, prompt_len + LM_DECODE_STEPS // 2, absorb, touched)
        out.update(cache_T=T, prompt=prompt_len, prompt_prefill_s=prefill_s,
                   steps=LM_DECODE_STEPS, p50_ms=p50 * 1e3, tokens_per_s=B / p50,
                   bound_valid_prefix_ms=valid["ms"])
    require(counts, {}, f"lm {arch} {row}")
    if touched is not None:
        out["touched_experts"] = touched
    if mesh is not None:
        out["ep"] = _ep_report(cfg, mesh, dctx, B, T if row == "prefill" else 1, slots,
                               len(times) + (1 if row == "prefill" else 0), what=f"{arch} {row}")
    out.update(peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               bound_ms=bound["ms"], bound_by=bound["by"], bound_tflop=bound["ops"] / 1e12,
               bound_gb=bound["bytes"] / 1e9, reduced=cuts, launches=counts, device=smi)
    return out


def _gnn_data(shape, seed: int, dev) -> tuple[dict, dict, list]:
    """(batch on ``dev``, host facts, cuts) for one ``GNN_SHAPES`` entry:
    random features, edges and labels from ``seed``.  full: the shape's
    nodes and uniform random edges; batched: ``n_graphs`` graphs of
    ``n_nodes`` / ``n_edges`` packed with offset node ids (one node id
    space, as ``launch/cells.py`` sizes it); sampled: ``random_graph`` over
    the shape's nodes at its average degree rounded to an integer (it
    takes an integer degree), its CSR built once, ``sample_subgraph`` from
    ``batch_nodes`` seeds at the fanout,
    the features gathered from a full random table, the label mask on the
    seeds."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import sampler

    C = configs.get("gcn-cora").num_classes
    g = torch.Generator(device=dev).manual_seed(seed)
    facts, cuts = {}, []
    if shape.kind == "sampled":
        rng = np.random.default_rng(seed)
        deg = round(shape.n_edges / shape.n_nodes)
        t0 = time.perf_counter()
        graph = sampler.random_graph(shape.n_nodes, deg, seed=seed)
        facts["csr_seconds"] = time.perf_counter() - t0
        seeds = rng.choice(shape.n_nodes, size=shape.batch_nodes, replace=False)
        t0 = time.perf_counter()
        sub = sampler.sample_subgraph(graph, seeds, shape.fanout, rng=rng)
        facts["sample_seconds"] = time.perf_counter() - t0
        facts.update(host_graph_edges=int(len(graph.indices)),
                     valid_nodes=int(sub["node_valid"].sum()),
                     valid_edges=int((sub["edges"][0] >= 0).sum()))
        cuts.append(f"host graph random_graph({shape.n_nodes}, {deg}): "
                    f"{len(graph.indices)} edges, not {shape.n_edges} (the average "
                    "degree rounded to an integer)")
        del graph
        table = torch.randn((shape.n_nodes, shape.d_feat), generator=g, device=dev)
        x = table[torch.as_tensor(sub["node_index"], device=dev).long()]
        del table
        n = sub["num_nodes"]
        edges = torch.as_tensor(sub["edges"], device=dev)
        mask = torch.zeros(n, device=dev)
        mask[torch.as_tensor(sub["seed_local"], device=dev).long()] = 1.0
        batch = {"x": x, "edges": edges, "label_mask": mask}
    else:
        graphs = shape.n_graphs if shape.kind == "batched" else 1
        n, e = shape.n_nodes * graphs, shape.n_edges
        local = torch.randint(0, shape.n_nodes, (2, graphs, e), generator=g, device=dev,
                              dtype=torch.int32)
        offsets = torch.arange(graphs, device=dev, dtype=torch.int32)[None, :, None]
        batch = {"x": torch.randn((n, shape.d_feat), generator=g, device=dev),
                 "edges": (local + offsets * shape.n_nodes).reshape(2, graphs * e)}
    batch["labels"] = torch.randint(0, C, (n,), generator=g, device=dev, dtype=torch.int32)
    return batch, facts, cuts


def _gcn_bound(cfg, n: int, E: int, d: int, train: bool) -> dict:
    """The least time of one GCN call: each layer's transform (2·n·d_in·
    d_out) and its messages (a scale and an add of d_out per edge) at the
    f32 peak (TF32 off), three times over for a train step (forward, and
    the backward's two products); bytes the features, the edges (int32)
    and the logits — for a train step the labels and the parameters, their
    gradients and AdamW's two moments (each read and written) instead of
    the logits."""
    dims = (d,) + (cfg.d_hidden,) * (cfg.num_layers - 1) + (cfg.num_classes,)
    flops = sum(2 * n * a * b + 2 * E * b for a, b in zip(dims, dims[1:]))
    P = sum(a * b + b for a, b in zip(dims, dims[1:]))
    nbytes = 4 * n * d + 8 * E + (4 * n + 4 * P * 7 if train else 4 * n * cfg.num_classes)
    return _bound(flops * (3 if train else 1), "f32", nbytes)


def _gnn_checks(shape, cfg, model, batch) -> dict:
    """full_graph_sm: the serve step's logits on the card against the CPU
    (GNN_RTOL / GNN_ATOL) and GNN_CPU_STEPS train steps' losses (rtol
    GNN_RTOL); ogb_products: the f32 forward against the f64 forward on the
    card (GNN_F64_RTOL)."""
    import torch

    from repro_torch.models import gnn
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import tree as tree_lib
    from repro_torch.train.train_step import make_serve_step, make_train_step

    serve = make_serve_step(cfg, "gnn")
    out = {}
    if shape.name == "full_graph_sm":
        cpu_p = tree_lib.tree_map(lambda t: t.cpu(), model.tree())
        cpu_b = {k: v.cpu() for k, v in batch.items()}
        err, ok = close_matmul(serve(model, batch).cpu(), serve(cpu_p, cpu_b),
                               rtol=GNN_RTOL, atol=GNN_ATOL)
        opt = opt_lib.adamw(GNN_LR)
        step = make_train_step(cfg, "gnn", opt)
        pg, pc = model.tree(), cpu_p
        sg, sc = opt.init(pg), opt.init(pc)
        losses = []
        for _ in range(GNN_CPU_STEPS):
            pg, sg, mg = step(pg, sg, batch)
            pc, sc, mc = step(pc, sc, cpu_b)
            losses.append((float(mg["loss"]), float(mc["loss"])))
        loss_ok = all(abs(a - b) <= GNN_RTOL * abs(b) for a, b in losses)
        out = {"card_vs_cpu": {"max_abs_err": err, "ok": ok, "losses": losses,
                               "losses_ok": loss_ok, "rtol": GNN_RTOL, "atol": GNN_ATOL}}
        ok = ok and loss_ok
    elif shape.name == "ogb_products":
        p64 = tree_lib.tree_map(lambda t: t.double(), model.tree())
        with torch.inference_mode():
            ref = gnn.gcn_forward(p64, batch["x"].double(), batch["edges"], cfg)
            got = serve(model, batch).double()
        diff = (got - ref).abs()
        rms = float(ref.square().mean().sqrt())
        ok = bool((diff <= GNN_F64_RTOL * (ref.abs() + rms)).all())
        out = {"f32_vs_f64": {"max_abs_err": float(diff.max()), "f64_rms": rms,
                              "max_rel_err": float((diff / ref.abs().clamp_min(rms)).max()),
                              "ok": ok, "rtol": GNN_F64_RTOL}}
        del p64, ref, got, diff
    else:
        return out
    if not ok:
        fail(f"gnn {shape.name} checks: {json.dumps(out)}")
    return out


def _gnn_row(shape, seed: int, smi: str) -> dict:
    """One GNN shape with ``gcn-cora``'s CONFIG: a counted window of
    GNN_SERVE_REPS serve steps after a warm-up and GNN_TRAIN_STEPS AdamW
    steps, which must launch no kernel, then the shape's checks."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import gnn
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_serve_step, make_train_step

    dev = torch.device(DEVICE)
    cfg = configs.get("gcn-cora")
    t0 = time.perf_counter()
    batch, facts, cuts = _gnn_data(shape, seed, dev)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    n, E = batch["x"].shape[0], batch["edges"].shape[1]
    model = gnn.GCNModel.build(cfg, shape.d_feat, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(seed))
    serve = make_serve_step(cfg, "gnn")
    opt = opt_lib.adamw(GNN_LR)
    step = make_train_step(cfg, "gnn", opt)
    _peak_reset()

    def run():
        logits, serve_times = _timed_calls(lambda: serve(model, batch), GNN_SERVE_REPS,
                                           warmup=1)
        params = model.tree()
        state = opt.init(params)
        losses, times = [], []
        for _ in range(GNN_TRAIN_STEPS):
            t0 = time.perf_counter()
            params, state, metrics = step(params, state, batch)
            losses.append(float(metrics["loss"]))  # waits for the step
            times.append(time.perf_counter() - t0)
        return logits, serve_times, losses, times

    (logits, serve_times, losses, times), counts = counted(run)
    require(counts, {}, f"gnn {shape.name}")
    if tuple(logits.shape) != (n, cfg.num_classes) or not bool(torch.isfinite(logits).all()):
        fail(f"gnn {shape.name}: logits {tuple(logits.shape)} or not finite")
    if not all(math.isfinite(v) for v in losses):
        fail(f"gnn {shape.name}: losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    serve_p50, train_p50 = float(np.median(serve_times)), float(np.median(times[1:]))
    sb, tb = (_gcn_bound(cfg, n, E, shape.d_feat, train) for train in (False, True))
    out = {"shape": shape.name, "kind": shape.kind, "nodes": n, "edges": E,
           "d_feat": shape.d_feat, "data_seconds": data_s, **facts,
           "serve_p50_ms": serve_p50 * 1e3, "nodes_per_s": n / serve_p50,
           "serve_bound_ms": sb["ms"], "serve_bound_by": sb["by"],
           "train_p50_ms": train_p50 * 1e3, "train_nodes_per_s": n / train_p50,
           "train_bound_ms": tb["ms"], "train_bound_by": tb["by"],
           "loss_first": losses[0], "loss_after_10": losses[-1], "peak_gb": peak,
           "reduced": cuts, "launches": counts, "device": smi}
    del logits
    window, counts = counted(lambda: _gnn_checks(shape, cfg, model, batch))
    require(counts, {}, f"gnn {shape.name} checks")
    out.update(window)
    return out


def phase_models(seed: int, smi: str) -> tuple[list[dict], list[dict]]:
    """Phase 12: smollm-135m and gemma-2b serving (``LM_ROWS``, with their
    checks) and the GCN on every ``GNN_SHAPES`` entry; every window must
    launch no kernel.  Returns (lm lines, gnn lines)."""
    import torch

    from repro_torch import configs
    from repro_torch.models.transformer import LMModel

    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    lm, gnn_rows = [], []
    for arch in LM_CHECK:
        model = LMModel.build(configs.get(arch), device=dev,
                              generator=torch.Generator(device=dev).manual_seed(seed))
        check, counts = counted(lambda: _lm_checks(arch, model, seed, smi))
        require(counts, {}, f"lm {arch} checks")
        check["launches"] = counts
        lm.append(check)
        log("lm " + json.dumps(check))
        for spec in LM_ROWS:
            if spec[0] == arch:
                lm.append(_lm_row(model, spec, seed, smi))
                log("lm " + json.dumps(lm[-1]))
        del model
        gc.collect()
        torch.cuda.empty_cache()
    for shape in configs.base.GNN_SHAPES:
        gnn_rows.append(_gnn_row(shape, seed, smi))
        log("gnn " + json.dumps(gnn_rows[-1]))
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase 12 seconds {time.perf_counter() - t0:.3f}")
    return lm, gnn_rows


# ---------------------------------------------------------------------------
# phase 13: MoE and MLA serving at published widths, LM training
# ---------------------------------------------------------------------------

#: the MoE archs at published widths, cut in depth only
MOE_DEPTH = {
    "deepseek-v3-671b": (dict(num_layers=2, first_dense_layers=1),
                         "2 of 61 layers: the first dense layer and one MoE layer, the MTP "
                         "module in the tree (58.5 GB f32); one MoE layer is 45.9 GB f32 "
                         "(256 x 3 x 7168 x 2048 x 4 B)"),
    "qwen3-moe-235b-a22b": (dict(num_layers=2),
                            "2 of 94 layers (24.9 GB f32); one MoE layer is 9.7 GB f32 "
                            "(128 x 3 x 4096 x 1536 x 4 B)"),
}
# (arch, row, configs.base.LM_SHAPES name, batch, sequence or cache length,
# the cuts of that shape, options: mla_absorb, the decode prompt's length,
# the prompt prefill's batch group)
MOE_ROWS = (
    ("deepseek-v3-671b", "prefill", "prefill_32k", 1, 4096,
     ["batch 1 of 32, 4096 of 32768 tokens: with 128 heads JAX's chunk schedule holds "
      "(1, 128, S, 1024) score tiles in bf16 + f32, ~4 GB at S = 4096, ~34 GB at 32768"], {}),
    ("deepseek-v3-671b", "decode", "decode_32k", 32, 32768,
     ["batch 32 of 128", "the cache holds a 4096-token prompt, prefilled one sequence at "
      "a time and copied into the cache rows"], {"absorb": True, "group": 1}),
    ("deepseek-v3-671b", "decode", "decode_32k", 4, 4096,
     ["batch 4 of 128 and a 4096-position cache: at 32 x 32768 the naive branch would "
      "expand K and V to 34 GB each", "the cache holds a 3072-token prompt"],
     {"absorb": False, "prompt": 3072, "group": 1}),
    ("deepseek-v3-671b", "decode", "decode_32k", 4, 4096,
     ["batch 4 of 128 and a 4096-position cache, beside the naive row",
      "the cache holds a 3072-token prompt"], {"absorb": True, "prompt": 3072, "group": 1}),
    ("qwen3-moe-235b-a22b", "prefill", "prefill_32k", 4, 4096,
     ["batch 4 of 32", "4096 tokens of 32768"], {}),
    ("qwen3-moe-235b-a22b", "decode", "decode_32k", 32, 32768,
     ["batch 32 of 128", "the cache holds a 4096-token prompt, prefilled 4 sequences at "
      "a time"], {"group": 4}),
)
MOE_CHECK = (2, 16)  # teacher forcing (B, S), f32 activations
MOE_DISPATCH_TOKENS = 64  # the dispatch against moe_ffn_dense, one layer
REDUCED_CHECK = (2, 12, 4)  # card against CPU at REDUCED: batch, prompt, decode steps
LM_TRAIN_LR = 3e-4  # launch/train.py's AdamW for the LM archs
LM_TRAIN_STEPS = 10  # the p50 is over the nine after the first
REDUCED_TRAIN_STEPS = 3
LM_TRAIN_RTOL = 1e-5  # REDUCED train losses, card against CPU
# (arch, configs.base.LM_SHAPES name, batch, sequence, cuts)
LM_TRAIN = ("smollm-135m", "train_4k", 8, 4096,
            ["batch 8 of 256: one card, the rest are data-parallel replicas"])


def _moe_model(arch: str, seed: int):
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.models.transformer import LMModel

    dev = torch.device(DEVICE)
    cfg = dataclasses.replace(configs.get(arch), **MOE_DEPTH[arch][0])
    return LMModel.build(cfg, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(seed))


def _moe_checks(arch: str, model, seed: int, smi: str) -> dict:
    """At published widths, f32 activations, TF32 off, each held at LM_RTOL
    / LM_ATOL: every position decoded through the cache against the
    forward (MLA: naive and absorbed), prefill's last logits against the
    forward's last row, absorbed against naive logits, and the dispatch
    against ``moe_ffn_dense`` on the MoE layer over MOE_DISPATCH_TOKENS
    random tokens."""
    import dataclasses

    import torch

    from repro_torch.models import moe
    from repro_torch.models import transformer as tf

    dev = torch.device(DEVICE)
    cfg32 = dataclasses.replace(model.cfg, dtype="float32")
    B, S = MOE_CHECK
    toks = _lm_tokens(cfg32, B, S, seed + 1, dev)
    modes = (False, True) if cfg32.attention == "mla" else (False,)
    with torch.inference_mode():
        full = tf.lm_forward(model, toks, cfg32)[0]
        last, _ = tf.lm_prefill(model, toks, cfg32)
        steps = {}
        for absorb in modes:
            cache = tf.init_cache(cfg32, B, S, device=dev)
            steps[absorb] = torch.cat([
                tf.lm_decode_step(model, cache, toks[:, t:t + 1], t, cfg32,
                                  mla_absorb=absorb)[0] for t in range(S)], dim=1)
            del cache
    out = {"arch": arch, "check": "teacher forcing, absorbed against naive, dispatch "
           "against moe_ffn_dense", "batch": B, "seq": S}
    oks = []
    for absorb in modes:
        err, ok, ratio = _within(steps[absorb], full)
        out[f"teacher_forcing{'_absorbed' if absorb else ''}"] = {
            "max_abs_err": err, "ok": ok, "of_tolerance": ratio}
        oks.append(ok)
    err, ok, ratio = _within(last[:, 0], full[:, -1])
    out["prefill_vs_forward"] = {"max_abs_err": err, "ok": ok, "of_tolerance": ratio}
    oks.append(ok)
    if len(modes) == 2:
        err, ok, ratio = _within(steps[True], steps[False])
        out["absorbed_vs_naive"] = {"max_abs_err": err, "ok": ok, "of_tolerance": ratio}
        oks.append(ok)
    del full, last, steps
    layer = tf._layer(model["moe_blocks"], 0)["mlp"]
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    x = torch.randn((1, MOE_DISPATCH_TOKENS, cfg32.d_model), generator=g, device=dev)
    with torch.inference_mode():
        probs = moe.router_probs(x, layer["router"], cfg32)
        top_w, top_i = moe.topk_weights(probs, cfg32)
        disp = moe.moe_ffn_dispatch(x, top_w, top_i, layer, cfg32)
        dense = moe.moe_ffn_dense(x, probs, layer, cfg32)
    err, ok, ratio = _within(disp, dense)
    out["dispatch_vs_dense"] = {"tokens": MOE_DISPATCH_TOKENS, "max_abs_err": err, "ok": ok,
                                "of_tolerance": ratio,
                                "experts_reached": int(torch.unique(top_i).numel())}
    oks.append(ok)
    out.update(rtol=LM_RTOL, atol=LM_ATOL, device=smi)
    if not all(oks):
        fail(f"lm {arch} checks: {json.dumps(out)}")
    return out


def _reduced_card_vs_cpu(arch: str, seed: int, smi: str) -> dict:
    """``REDUCED`` (f32), the same weights and tokens on the card and the
    CPU: forward logits, a prefill and REDUCED_CHECK decode steps fed the
    same tokens (MLA: naive and absorbed), LM_RTOL / LM_ATOL; then
    REDUCED_TRAIN_STEPS AdamW(3e-4) ``make_train_step(cfg, "lm")`` steps on
    ``TokenStream`` batches, losses within LM_TRAIN_RTOL."""
    import torch

    from repro_torch import configs
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import transformer as tf
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import tree as tree_lib
    from repro_torch.train.train_step import make_train_step

    dev, host = torch.device(DEVICE), torch.device("cpu")
    cfg = configs.get_reduced(arch)
    gpu = tf.LMModel.build(cfg, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(seed))
    cpu = tf.LMModel(cfg, tree_lib.tree_map(lambda t: t.cpu(), gpu.tree()))
    B, P, n = REDUCED_CHECK
    toks = _lm_tokens(cfg, B, P + n, seed + 3, host)
    modes = (False, True) if cfg.attention == "mla" else (False,)
    outs = {}
    for model, d in ((gpu, dev), (cpu, host)):
        t = toks.to(d)
        with torch.inference_mode():
            got = {"forward": model(t)}
            for absorb in modes:
                _, cache = tf.lm_prefill(model, t[:, :P], cfg, max_len=P + n)
                got[f"decode absorb={absorb}"] = torch.cat([tf.lm_decode_step(
                    model, cache, t[:, i:i + 1], i, cfg, mla_absorb=absorb)[0]
                    for i in range(P, P + n)], 1)
        outs[d.type] = got
    out = {"arch": arch, "check": "REDUCED card against CPU: serving, train steps"}
    oks = []
    for key, a in outs["cuda" if DEVICE == "cuda" else "cpu"].items():
        err, ok, ratio = _within(a.cpu(), outs["cpu"][key])
        out[key] = {"max_abs_err": err, "ok": ok, "of_tolerance": ratio}
        oks.append(ok)
    opt = opt_lib.adamw(LM_TRAIN_LR)
    step = make_train_step(cfg, "lm", opt)
    stream = TokenStream(cfg.vocab_size, 16, 4, seed=seed)
    pg, pc = gpu.tree(), cpu.tree()
    sg, sc = opt.init(pg), opt.init(pc)
    losses = []
    for t in range(REDUCED_TRAIN_STEPS):
        batch = torch.as_tensor(stream.batch(t)["tokens"])
        pg, sg, mg = step(pg, sg, {"tokens": batch.to(dev)})
        pc, sc, mc = step(pc, sc, {"tokens": batch})
        losses.append((float(mg["loss"]), float(mc["loss"])))
    loss_ok = all(abs(a - b) <= LM_TRAIN_RTOL * abs(b) for a, b in losses)
    out.update(train_losses=losses, losses_ok=loss_ok, rtol=LM_RTOL, atol=LM_ATOL,
               train_rtol=LM_TRAIN_RTOL, device=smi)
    if not (all(oks) and loss_ok):
        fail(f"lm {arch} REDUCED checks: {json.dumps(out)}")
    return out


def _lm_train_bound(cfg, B: int, S: int) -> dict:
    """The least time of one train step: three times the forward's flops
    (the layers, the causal attention, the head on every position) at the
    bf16 peak; bytes the parameters, their gradients and AdamW's two
    moments, f32, each read and written (7 passes), and the tokens."""
    from repro_torch.models import params as params_lib
    from repro_torch.models import transformer

    pairs = B * S * (S + 1) / 2
    fwd = (2 * _lm_token_params(cfg) * B * S
           + cfg.num_layers * (pairs * _lm_pair_flops(cfg) + B * S * _lm_expand_flops(cfg))
           + 2 * cfg.d_model * cfg.vocab_size * B * S)
    P = params_lib.param_bytes(transformer.lm_decls(cfg))
    return _bound(3 * fwd, "bf16", 7 * P + 4 * B * S)


def _lm_train_row(seed: int, smi: str) -> dict:
    """``LM_TRAIN`` at published widths and full depth through
    ``launch.train.build(reduced=False)`` (AdamW(3e-4), ``TokenStream``
    batches, each layer checkpointed: the published config sets
    ``remat``): LM_TRAIN_STEPS steps as one counted window that must
    launch no kernel (p50 of all but the first, tokens/s, peak memory, the
    losses finite), then one ``microbatches=2`` step."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.launch import train as launch_train
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step

    arch, shape, B, S, cuts = LM_TRAIN
    dev = torch.device(DEVICE)
    cfg = configs.get(arch)
    params, state, step, batches = launch_train.build(arch, reduced=False, seq_len=S,
                                                      batch=B, device=dev)
    _peak_reset()

    def run(params, state):
        losses, times = [], []
        for t in range(LM_TRAIN_STEPS):
            batch = batches(t)
            t0 = time.perf_counter()
            params, state, metrics = step(params, state, batch)
            losses.append(float(metrics["loss"]))  # waits for the step
            times.append(time.perf_counter() - t0)
        return params, state, losses, times

    (params, state, losses, times), counts = counted(lambda: run(params, state))
    require(counts, {}, f"lm {arch} {shape}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(v) for v in losses):
        fail(f"lm {arch} {shape}: losses {losses}")
    mb_step = make_train_step(cfg, "lm", opt_lib.adamw(LM_TRAIN_LR), microbatches=2)
    batch = batches(LM_TRAIN_STEPS)
    _peak_reset()

    def one():
        t0 = time.perf_counter()
        _, _, m = mb_step(params, state, batch)
        return float(m["loss"]), time.perf_counter() - t0

    (mb_loss, mb_s), mb_counts = counted(one)
    require(mb_counts, {}, f"lm {arch} {shape} microbatches=2")
    if not math.isfinite(mb_loss):
        fail(f"lm {arch} {shape} microbatches=2: loss {mb_loss}")
    p50 = float(np.median(times[1:]))
    bound = _lm_train_bound(cfg, B, S)
    return {"arch": arch, "row": "train", "shape": shape, "batch": B, "seq": S,
            "steps": LM_TRAIN_STEPS, "p50_ms": p50 * 1e3, "first_step_ms": times[0] * 1e3,
            "tokens_per_s": B * S / p50, "peak_gb": peak, "losses": losses,
            "microbatches_2": {"ms": mb_s * 1e3, "loss": mb_loss,
                               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                               "launches": mb_counts},
            "bound_ms": bound["ms"], "bound_by": bound["by"],
            "bound_tflop": bound["ops"] / 1e12, "bound_gb": bound["bytes"] / 1e9,
            "reduced": cuts, "launches": counts, "device": smi}


def phase_moe(seed: int, smi: str) -> list[dict]:
    """Phase 13: deepseek-v3 and qwen3-moe at published widths cut in depth
    (``MOE_DEPTH``; their ``REDUCED`` configs held card against CPU first,
    serving and training), the checks at full width, ``MOE_ROWS``, one
    model on the card at a time; then LM training (``LM_TRAIN``).  Every
    window must launch no kernel.  Returns the ``lm`` lines."""
    import torch

    t0 = time.perf_counter()
    lines = []
    for arch, (_, depth) in MOE_DEPTH.items():
        red, counts = counted(lambda: _reduced_card_vs_cpu(arch, seed, smi))
        require(counts, {}, f"lm {arch} REDUCED checks")
        red["launches"] = counts
        lines.append(red)
        log("lm " + json.dumps(red))
        model = _moe_model(arch, seed)
        check, counts = counted(lambda: _moe_checks(arch, model, seed, smi))
        require(counts, {}, f"lm {arch} checks")
        check.update(depth=depth, launches=counts)
        lines.append(check)
        log("lm " + json.dumps(check))
        for spec in MOE_ROWS:
            if spec[0] == arch:
                row = _lm_row(model, spec, seed, smi)
                row["reduced"] = [depth] + row["reduced"]
                lines.append(row)
                log("lm " + json.dumps(row))
        del model
        gc.collect()
        torch.cuda.empty_cache()
    lines.append(_lm_train_row(seed, smi))
    log("lm " + json.dumps(lines[-1]))
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 13 seconds {time.perf_counter() - t0:.3f}")
    return lines


# ---------------------------------------------------------------------------
# phase 14: expert-parallel MoE serving on a mesh of ranks on the card
# ---------------------------------------------------------------------------

#: the EP checks at published widths (arch, mesh, moe_impl -> the mode it
#: gives), f32, TF32 off, capacity_factor E / k so that nothing drops
MESH_CHECKS = (("deepseek-v3-671b", (2, 4), "gathered", "2d"),
               ("deepseek-v3-671b", (3, 4), "gathered", "model"),
               ("qwen3-moe-235b-a22b", (3, 4), "gathered", "fslice"),
               ("qwen3-moe-235b-a22b", (2, 4), "zero3", "zero3"))
MESH_CHECK_SHAPE = (6, 16)  # (B, S): 96 tokens, B divisible by 2 and by 3
MESH_REDUCED = ((2, 4), 2, 12, 4)  # REDUCED card against CPU: mesh, batch, prompt, steps
MESH_REDUCED_TOL = 1e-5
# MOE_ROWS-shaped, each with the mesh of its lm_policy; published capacity_factor
MESH_ROWS = (
    ("deepseek-v3-671b", "prefill", "prefill_32k", 2, 4096,
     ["batch 2 of 32 (divisible by data = 2), 4096 of 32768 tokens"], {"mesh": (2, 4)}),
    ("deepseek-v3-671b", "decode", "decode_32k", 32, 32768,
     ["batch 32 of 128", "the cache holds a 4096-token prompt, prefilled one sequence at "
      "a time without the mesh"], {"mesh": (2, 4), "absorb": True, "group": 1}),
    ("qwen3-moe-235b-a22b", "prefill", "prefill_32k", 4, 4096,
     ["batch 4 of 32", "4096 tokens of 32768"], {"mesh": (2, 4)}),
    ("qwen3-moe-235b-a22b", "decode", "decode_32k", 32, 32768,
     ["batch 32 of 128", "the cache holds a 4096-token prompt, prefilled 4 sequences at "
      "a time without the mesh"], {"mesh": (2, 4), "group": 4}),
    ("qwen3-moe-235b-a22b", "prefill", "prefill_32k", 3, 4096,
     ["batch 3 of 32 (divisible by data = 3)", "4096 tokens of 32768"], {"mesh": (3, 4)}),
)


def _ep_report(cfg, mesh, dctx, B: int, S: int, slots: list, calls: int, what: str) -> dict:
    """The expert-parallel numbers of a row under ``dctx``: its plan
    (``moe.ep_plan``), and the slots assigned and dropped over the row's
    ``calls`` (from the ``slot_maps`` records, one per rank, chunk, MoE
    layer and call, which must all be there)."""
    from repro_torch.models import moe

    if not dctx.batch_axes:
        fail(f"lm {what}: the batch {B} does not split over {mesh.shape}: no EP")
    plan = moe.ep_plan(cfg, mesh, dctx.batch_axes, B, S)
    want = plan.ranks * plan.chunks * cfg.num_moe_layers * calls
    if len(slots) != want:
        fail(f"lm {what}: {len(slots)} rank dispatches, want {want}")
    copies = plan.ranks * plan.E_loc / cfg.num_experts
    counts = _slot_counts(slots, copies)
    return {"ep_mode": plan.mode, "mesh": mesh.shape, "ranks": plan.ranks,
            "E_loc": plan.E_loc, "C": plan.C, "chunks": plan.chunks, "T_g": plan.T_g,
            "psum_axes": list(plan.psum_axes), "calls": calls,
            "slots_assigned": counts["assigned"], "dropped_slots": counts["dropped"],
            "dropped_share": counts["dropped"] / max(counts["assigned"], 1)}


def _mesh_check(model, mesh_shape, impl: str, mode: str, seed: int, smi: str) -> dict:
    """``moe_ffn_ep`` (or ``moe_ffn_ep_zero3``) on the model's MoE layer at
    published widths, f32, capacity_factor E / k, against
    ``moe_ffn_dispatch`` on the same tokens, LM_RTOL / LM_ATOL."""
    import dataclasses

    import torch

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf

    dev = torch.device(DEVICE)
    base = model.cfg
    cfg = dataclasses.replace(base, dtype="float32",
                              capacity_factor=base.num_experts / base.num_experts_per_tok)
    mesh = make_test_mesh(mesh_shape, device=dev)
    layer = tf._layer(model["moe_blocks"], 0)["mlp"]
    B, S = MESH_CHECK_SHAPE
    g = torch.Generator(device=dev).manual_seed(seed + 4)
    x = torch.randn((B, S, cfg.d_model), generator=g, device=dev)
    fn = moe.moe_ffn_ep_zero3 if impl == "zero3" else moe.moe_ffn_ep
    slots = []
    with torch.inference_mode():
        probs = moe.router_probs(x, layer["router"], cfg)
        top_w, top_i = moe.topk_weights(probs, cfg)
        want = moe.moe_ffn_dispatch(x, top_w, top_i, layer, cfg)
        t0 = time.perf_counter()
        with slot_maps(slots):
            got = fn(x, probs, layer, cfg, mesh=mesh, batch_axes=("data",))
        torch.cuda.synchronize()
        ep_s = time.perf_counter() - t0
    got_mode = "zero3" if impl == "zero3" else moe.ep_mode(cfg, mesh)
    E_loc = cfg.num_experts // (mesh.size if got_mode == "2d" else mesh.shape["model"])
    # zero3 dispatches each rank's own tokens: every (token, expert) once
    copies = 1 if impl == "zero3" else mesh.size * E_loc / cfg.num_experts
    counts = _slot_counts(slots, copies)
    err, ok, ratio = _within(got, want)
    out = {"arch": base.name, "check": "expert-parallel against moe_ffn_dispatch",
           "mesh": mesh.shape, "ep_mode": got_mode, "want_mode": mode, "E_loc": E_loc,
           "tokens": B * S, "capacity_factor": cfg.capacity_factor,
           "dropped_slots": counts["dropped"], "slots_assigned": counts["assigned"],
           "rank_dispatches": len(slots), "ep_seconds": ep_s, "max_abs_err": err, "ok": ok,
           "of_tolerance": ratio, "rtol": LM_RTOL, "atol": LM_ATOL,
           "on_card": got.device.type == dev.type, "device": smi}
    if not ok or got_mode != mode or counts["dropped"] or not out["on_card"] \
            or counts["assigned"] != B * S * cfg.num_experts_per_tok:
        fail(f"mesh check {json.dumps(out)}")
    return out


def _mesh_reduced(arch: str, seed: int, smi: str) -> dict:
    """``REDUCED`` (f32) under ``lm_policy`` on MESH_REDUCED's mesh (its MoE
    layers expert-parallel, slots dropping at the published capacity), the
    same weights and tokens on the card and the CPU: prefill and decode
    steps fed the same tokens (MLA absorbed), MESH_REDUCED_TOL."""
    import torch

    from repro_torch import configs
    from repro_torch.dist.sharding import lm_policy
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.train import tree as tree_lib

    dev, host = torch.device(DEVICE), torch.device("cpu")
    shape, B, Pn, n = MESH_REDUCED
    cfg = configs.get_reduced(arch)
    gpu = tf.LMModel.build(cfg, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(seed))
    cpu = tf.LMModel(cfg, tree_lib.tree_map(lambda t: t.cpu(), gpu.tree()))
    toks = _lm_tokens(cfg, B, Pn + n, seed + 5, host)
    absorb = cfg.attention == "mla"
    outs = {}
    for model, d in ((gpu, dev), (cpu, host)):
        mesh = make_test_mesh(shape, device=d)
        pre, dec = (lm_policy(cfg, mesh, kind=k, batch=B) for k in ("prefill", "decode"))
        t = toks.to(d)
        with torch.inference_mode():
            last, cache = tf.lm_prefill(model, t[:, :Pn], cfg, pre, max_len=Pn + n)
            steps = torch.cat([tf.lm_decode_step(model, cache, t[:, i:i + 1], i, cfg, dec,
                                                 mla_absorb=absorb)[0]
                               for i in range(Pn, Pn + n)], 1)
        outs[d.type] = {"prefill": last, "decode": steps}
    out = {"arch": arch, "check": "REDUCED under lm_policy, card against CPU",
           "mesh": list(shape), "ep_mode": moe.ep_mode(cfg, mesh), "batch": B}
    oks = []
    for key, a in outs[dev.type].items():
        err, ok = close_matmul(a.cpu(), outs["cpu"][key], rtol=MESH_REDUCED_TOL,
                               atol=MESH_REDUCED_TOL)
        out[key] = {"max_abs_err": err, "ok": ok}
        oks.append(ok)
    out.update(tol=MESH_REDUCED_TOL, device=smi)
    if not all(oks):
        fail(f"mesh REDUCED {json.dumps(out)}")
    return out


def _one_device(moe_lines: list, row: dict):
    """Phase 13's row at the same (arch, row, batch, length, MLA branch)."""
    keys = ("arch", "row", "batch", "seq", "cache_T", "mla_absorb")
    for line in moe_lines:
        if "p50_ms" in line and all(line.get(k) == row.get(k) for k in keys):
            return {k: line[k] for k in ("p50_ms", "tokens_per_s", "peak_gb")}
    return None


def phase_mesh(seed: int, smi: str, moe_lines: list) -> list[dict]:
    """Phase 14: the port's mesh (ranks sharing the card) and the
    expert-parallel MoE at published widths.  Per MoE arch (phase 13's
    depth cut): the EP checks (``MESH_CHECKS``), then ``MESH_ROWS`` under
    ``lm_policy``, beside phase 13's one-device row where one has the same
    shape; then the ``REDUCED`` card-against-CPU check.  Every window must
    launch no kernel.  Returns the ``mesh`` and ``lm`` lines."""
    import torch

    from repro_torch.launch.mesh import make_test_mesh

    t0 = time.perf_counter()
    shapes = sorted({m for _, m, _, _ in MESH_CHECKS} | {r[6]["mesh"] for r in MESH_ROWS})
    meshes = [make_test_mesh(m, device=DEVICE) for m in shapes]
    line = {"mesh": [{"shape": m.shape, "ranks": m.size, "device": str(m.device)}
                     for m in meshes],
            "ranks_share_one_device": True,
            "cuda_device_count": torch.cuda.device_count(), "device": smi}
    log("mesh " + json.dumps(line))
    lines = [line]
    for arch, (_, depth) in MOE_DEPTH.items():
        model = _moe_model(arch, seed)
        for c_arch, shape, impl, mode in MESH_CHECKS:
            if c_arch == arch:
                check, counts = counted(
                    lambda: _mesh_check(model, shape, impl, mode, seed, smi))
                require(counts, {}, f"mesh check {arch} {shape} {impl}")
                check.update(depth=depth, launches=counts)
                lines.append(check)
                log("mesh " + json.dumps(check))
        for spec in MESH_ROWS:
            if spec[0] == arch:
                row = _lm_row(model, spec, seed, smi)
                row["reduced"] = [depth] + row["reduced"]
                row["one_device"] = _one_device(moe_lines, row)
                lines.append(row)
                log("lm " + json.dumps(row))
        del model
        gc.collect()
        torch.cuda.empty_cache()
    for arch in MOE_DEPTH:
        red, counts = counted(lambda: _mesh_reduced(arch, seed, smi))
        require(counts, {}, f"mesh REDUCED {arch}")
        red["launches"] = counts
        lines.append(red)
        log("mesh " + json.dumps(red))
    log(f"phase 14 seconds {time.perf_counter() - t0:.3f}")
    return lines


# ---------------------------------------------------------------------------
# phase 15: cells built by launch/cells, materialised on the card
# ---------------------------------------------------------------------------

CELL_MESH = (2, 4)
# (arch, shape, LMConfig cuts, batch, sequence, the cuts as read)
CELL_TRAIN = ("qwen3-moe-235b-a22b", "train_4k", {"num_layers": 1}, 8, 512,
              ["1 of 94 layers (phase 13 keeps 2: with bf16 gradients, the updated "
               "parameters and Adafactor's f32 temporaries of the (L, 128, 4096, 1536) "
               "expert leaves, the port's dry-run of the 2-layer cell on a (2, 4) meta "
               "mesh reckons 79.3 GB on one card)",
               "batch 8 of 256, 512 of 4096 tokens"])
CELL_TRAIN_STEPS = 3  # timed steps a microbatch setting, after one warm-up
CELL_CHECK = (2, 64)  # (B, S) of the mesh-against-one-device gradient check
CELL_LOSS_RTOL = 1e-5  # f32: the loss with the mesh and without
# f32 gradients: the ranks' partial sums are added in another order
CELL_GRAD_RTOL = 1e-4
CELL_GRAD_ATOL = 1e-5  # of the leaf's largest |gradient|
CELL_LEFT_OUT = ("deepseek-v3-671b", "train_4k", {"num_layers": 2, "first_dense_layers": 1})
CELL_SERVE_ARCH = ("deepseek-coder-33b", {"num_layers": 4},
                   "4 of 62 layers (bf16 weights 5.2 GB, its f32 twin 10.4 GB)")
# (shape, batch, sequence or cache length, the cuts of the shape)
CELL_SERVE = (("prefill_32k", 1, 32768, ["batch 1 of 32"]),
              ("decode_32k", 32, 32768, ["batch 32 of 128",
                                         "the cache zeroed, not prefilled (a step reads "
                                         "every position either way)"]))
CELL_SERVE_REPS = 3  # timed prefill calls, after one warm-up
CELL_DECODE_STEPS = 8  # decode steps; the first is the warm-up
CELL_SERVE_CHECK = (2, 64)  # (B, S) of the f32 checks
CELL_GNN = ("gcn-cora", "full_graph_sm")
CELL_RECSYS = ("deepfm", "serve_p99", "train_batch")
CELL_RECSYS_REPS = 20  # timed serve calls, after two warm-ups
CELL_DRYRUN = (("smollm-135m", "train_4k"), ("qwen3-moe-235b-a22b", "decode_32k"),
               ("deepfm", "train_batch"))


def _cell_train(seed: int, smi: str) -> list[dict]:
    """``CELL_TRAIN`` built by ``launch/cells.build`` on a (2, 4) mesh of
    ranks on the card (``lm_policy(kind="train")``: its MoE layer through
    the EP ``shard_map`` with gradients), ``LM_TRAIN_OPTS`` (bf16
    parameters, Adafactor), materialised from ``seed``.  First the check:
    the loss and every gradient with the mesh against the same without it
    (the one-device dispatch), on the cell's weights in f32 (their f32
    twin: bf16 gradients would round, and their bf16 index accumulation
    round again), f32 activations and capacity E / k so that nothing drops
    (loss CELL_LOSS_RTOL, gradients CELL_GRAD_RTOL / CELL_GRAD_ATOL); then CELL_TRAIN_STEPS timed steps at
    microbatches 1 and 2 at the published capacity, each a counted window
    that must launch no kernel (no kernel lies on this path)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.dist.sharding import lm_policy
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.train import tree as tree_lib
    from repro_torch.train.train_step import value_and_grad

    arch, shape, cut, B, S, cuts = CELL_TRAIN
    dev = torch.device(DEVICE)
    mesh = make_test_mesh(CELL_MESH, device=dev)
    built = {mb: cells.build(arch, shape, mesh, overrides={"microbatches": mb},
                             reduce_cfg=cut, batch=B, seq_len=S) for mb in (1, 2)}
    cfg = built[1].cfg
    g = torch.Generator(device=dev).manual_seed(seed)
    _peak_reset()
    t0 = time.perf_counter()
    params, state, batch = built[1].materialize(dev, g)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    lines = []

    # the check
    cfg_c = dataclasses.replace(cfg, dtype="float32", param_dtype="float32",
                                capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)
    twin = tree_lib.tree_map(lambda t: t.float(), params)
    Bc, Sc = CELL_CHECK
    dctx_c = lm_policy(cfg_c, mesh, kind="train", batch=Bc)
    if not tf.moe_takes_ep(cfg_c, dctx_c, Bc):
        fail(f"cells {arch}: the check's batch {Bc} takes no EP path on {mesh.shape}")
    toks = {"tokens": _lm_tokens(cfg, Bc, Sc, seed + 6, dev)}

    def grads():
        return (value_and_grad(tf.lm_loss, twin, toks, cfg_c, dctx_c),
                value_and_grad(tf.lm_loss, twin, toks, cfg_c, None))

    ((g_mesh, m_mesh), (g_one, m_one)), counts = counted(grads)
    require(counts, {}, f"cells {arch} check")
    loss_m, loss_o = float(m_mesh["loss"]), float(m_one["loss"])
    worst, differ, total, ok = 0.0, 0, 0, abs(loss_m - loss_o) <= CELL_LOSS_RTOL * abs(loss_o)
    for (path, a), b in zip(tree_lib.paths(g_mesh), tree_lib.leaves(g_one)):
        tol = CELL_GRAD_RTOL * b.abs() + CELL_GRAD_ATOL * float(b.abs().max())
        diff = (a - b).abs()
        worst = max(worst, float(diff.max()))
        differ += int((diff > 0).sum())
        total += b.numel()
        if not bool((diff <= tol).all()) or not bool(torch.isfinite(a).all()):
            ok = False
            log(f"cells {arch} check: gradient {path} off by {float(diff.max())}")
    check = {"cell": f"{arch} {shape}", "check": "loss and gradients on the (2, 4) mesh "
             "against one device", "batch": Bc, "seq": Sc, "activations": "float32",
             "param_dtype": "float32 (the bf16 weights' values)",
             "capacity_factor": cfg_c.capacity_factor,
             "ep_mode": moe.ep_plan(cfg_c, mesh, dctx_c.batch_axes, Bc, Sc).mode,
             "loss_mesh": loss_m, "loss_one_device": loss_o, "loss_rtol": CELL_LOSS_RTOL,
             "grad_max_abs_err": worst, "grad_elements_differing": differ,
             "grad_elements": total, "grad_rtol": CELL_GRAD_RTOL,
             "grad_atol_of_max": CELL_GRAD_ATOL, "ok": ok, "launches": counts, "device": smi}
    log("cells " + json.dumps(check))
    if not ok:
        fail(f"cells {arch} check: {json.dumps(check)}")
    lines.append(check)
    del g_mesh, g_one, twin
    gc.collect()
    torch.cuda.empty_cache()

    # the timed steps, microbatches 1 then 2; ``carry`` holds the only
    # reference to the newest (params, state), so two trees live at most
    carry = [params, state]
    del params, state
    for mb in (1, 2):
        cell = built[mb]
        if cell.meta["microbatches"] != mb:
            fail(f"cells {arch}: asked for {mb} microbatches, the cell runs "
                 f"{cell.meta['microbatches']}")
        plan = moe.ep_plan(cfg, mesh, cell.dctx.batch_axes, B // mb, S)
        _peak_reset()

        def run():
            losses, times = [], []
            for _ in range(CELL_TRAIN_STEPS + 1):
                t0 = time.perf_counter()
                carry[0], carry[1], m = cell.step(carry[0], carry[1], batch)
                losses.append(float(m["loss"]))  # waits for the step
                times.append(time.perf_counter() - t0)
            return losses, times

        (losses, times), counts = counted(run)
        require(counts, {}, f"cells {arch} {shape} mb={mb}")
        if not all(math.isfinite(v) for v in losses):
            fail(f"cells {arch} {shape} mb={mb}: losses {losses}")
        p50 = float(np.median(times[1:]))
        row = {"cell": f"{arch} {shape}", "row": "train", "mesh": mesh.shape,
               "microbatches": mb, "batch": B, "seq": S, "optimizer": "adafactor",
               "param_dtype": cfg.param_dtype, "ep_mode": plan.mode, "E_loc": plan.E_loc,
               "C": plan.C, "chunks": plan.chunks, "steps": CELL_TRAIN_STEPS,
               "p50_ms": p50 * 1e3, "first_step_ms": times[0] * 1e3,
               "tokens_per_s": B * S / p50, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "losses": losses, "init_seconds": init_s, "reduced": cuts,
               "launches": counts, "device": smi}
        log("cells " + json.dumps(row))
        lines.append(row)
    del carry, batch
    gc.collect()
    torch.cuda.empty_cache()
    return lines


def _cell_left_out() -> dict:
    """``CELL_LEFT_OUT``: the bytes one card would hold for the cut cell's
    train step, reckoned by the port's dry-run (its (2, 4) mesh of meta
    ranks: the arguments, then the peak of the step's live bytes); left
    out when over the card.  Analytic: no card reading."""
    import torch

    from repro_torch.dist import roofline
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import make_meta_mesh
    from repro_torch.train import tree as tree_lib

    arch, shape, cut = CELL_LEFT_OUT
    B, S = CELL_TRAIN[3], CELL_TRAIN[4]
    cell = cells.build(arch, shape, make_meta_mesh(shape=CELL_MESH), reduce_cfg=cut,
                       batch=B, seq_len=S)
    args = sum(t.nbytes for t in tree_lib.leaves(cell.args) if hasattr(t, "nbytes"))
    with roofline.OpCounter() as counter:
        cell.step(*cell.args)
    card = torch.cuda.get_device_properties(DEVICE).total_memory
    out = {"cell": f"{arch} {shape}", "row": "train", "analytic": True,
           "source": "the port's dry-run on meta tensors, no card reading",
           "cut": cut, "batch": B, "seq": S, "param_dtype": cell.cfg.param_dtype,
           "argument_gb": args / 1e9, "step_peak_gb": counter.peak_bytes / 1e9,
           "reckoned_gb": (args + counter.peak_bytes) / 1e9, "card_gb": card / 1e9}
    out["left_out"] = out["reckoned_gb"] > out["card_gb"]
    out["why"] = ("bf16 parameters and gradients, the updated parameters and Adafactor's "
                  "f32 temporaries of a (1, 256, 7168, 2048) expert leaf do not fit one "
                  "card" if out["left_out"] else "fits")
    return out


def _lm_serve_check(cfg, params, seed: int) -> dict:
    """The cell's weights (bf16) with f32 activations against their f32
    twin (f32 weights, f32 activations) on the card, a prefill and one
    decode step at CELL_SERVE_CHECK, LM_RTOL / LM_ATOL (phase 12's); the
    bf16-activation logits' largest difference from the f32 ones over
    their standard deviation, read."""
    import dataclasses

    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.train import tree as tree_lib

    dev = torch.device(DEVICE)
    B, S = CELL_SERVE_CHECK
    toks = _lm_tokens(cfg, B, S + 1, seed + 7, dev)
    f32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    act32 = dataclasses.replace(cfg, dtype="float32")
    twin = tree_lib.tree_map(lambda t: t.float(), params)

    def serve(p, c):
        with torch.inference_mode():
            last, cache = tf.lm_prefill(p, toks[:, :S], c, max_len=S + 1)
            step, _ = tf.lm_decode_step(p, cache, toks[:, S:], S, c)
        return torch.cat([last, step], dim=1).float()

    ref, got, bf16 = serve(twin, f32), serve(params, act32), serve(params, cfg)
    del twin
    err, ok, ratio = _within(got, ref)
    out = {"batch": B, "seq": S, "max_abs_err": err, "ok": ok, "of_tolerance": ratio,
           "rtol": LM_RTOL, "atol": LM_ATOL,
           "bf16_activations_max_diff_over_std": float((bf16 - ref).abs().max() / ref.std())}
    if not ok:
        fail(f"cells {cfg.name} f32 check: {json.dumps(out)}")
    return out


def _cell_serve(seed: int, smi: str) -> list[dict]:
    """deepseek-coder-33b at published widths cut in depth
    (``CELL_SERVE_ARCH``), its ``prefill_32k`` and ``decode_32k`` cells on a
    1 x 1 mesh of the card (bf16 weights by the cells' rule for serving
    above 2e9 parameters; both cells draw the same weights from ``seed``,
    checked once against their f32 twin); each timed call a counted window
    that must launch no kernel."""
    import numpy as np
    import torch

    from repro_torch.launch import cells
    from repro_torch.launch.mesh import make_test_mesh

    arch, cut, depth = CELL_SERVE_ARCH
    dev = torch.device(DEVICE)
    mesh = make_test_mesh((1, 1), device=dev)
    lines, check = [], None
    for shape, B, S, cuts in CELL_SERVE:
        cell = cells.build(arch, shape, mesh, reduce_cfg=cut, batch=B, seq_len=S)
        _peak_reset()
        args = cell.materialize(dev, torch.Generator(device=dev).manual_seed(seed))
        if check is None:
            check, counts = counted(lambda: _lm_serve_check(cell.cfg, args[0], seed))
            require(counts, {}, f"cells {arch} {shape} check")
        _peak_reset()
        if shape.startswith("prefill"):
            def run():
                return _timed_calls(lambda: cell.step(*args), CELL_SERVE_REPS, warmup=1)

            (logits, times), counts = counted(run)
            out = logits[0]
            tokens = B * S
        else:
            def run():
                params, cache, tok, _ = args
                times = []
                for i in range(CELL_DECODE_STEPS):
                    t0 = time.perf_counter()
                    nxt, cache = cell.step(params, cache, tok, S - CELL_DECODE_STEPS + i)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                    tok = nxt[:, None]
                return nxt, times[1:]

            (out, times), counts = counted(run)
            tokens = B
        require(counts, {}, f"cells {arch} {shape}")
        if not bool(torch.isfinite(out.float()).all()):
            fail(f"cells {arch} {shape}: output not finite")
        p50 = float(np.median(times))
        row = {"cell": f"{arch} {shape}", "row": cell.step_name, "batch": B, "seq": S,
               "param_dtype": cell.cfg.param_dtype, "p50_ms": p50 * 1e3,
               "tokens_per_s": tokens / p50,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "f32_check": check, "reduced": [depth] + cuts, "launches": counts,
               "device": smi}
        log("cells " + json.dumps(row))
        lines.append(row)
        del args, out
        gc.collect()
        torch.cuda.empty_cache()
    return lines


def _cell_gnn(seed: int, smi: str) -> dict:
    """``CELL_GNN``'s train cell materialised on the card and stepped twice
    (the second timed), a counted window that must launch no kernel."""
    import torch

    from repro_torch.launch import cells
    from repro_torch.launch.mesh import make_test_mesh

    dev = torch.device(DEVICE)
    cell = cells.build(*CELL_GNN, make_test_mesh((1, 1), device=dev))
    params, state, batch = cell.materialize(dev, torch.Generator(device=dev).manual_seed(seed))
    _peak_reset()

    def run():
        out = []
        p, s = params, state
        for _ in range(2):
            t0 = time.perf_counter()
            p, s, m = cell.step(p, s, batch)
            out.append((float(m["loss"]), time.perf_counter() - t0))
        return out

    steps, counts = counted(run)
    require(counts, {}, f"cells {' '.join(CELL_GNN)}")
    if not all(math.isfinite(loss) for loss, _ in steps):
        fail(f"cells {CELL_GNN}: losses {steps}")
    return {"cell": " ".join(CELL_GNN), "row": "train", "nodes": cell.meta["n_nodes"],
            "edges_padded": cell.meta["n_edges"], "step_ms": steps[1][1] * 1e3,
            "first_step_ms": steps[0][1] * 1e3, "losses": [x for x, _ in steps],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": counts,
            "device": smi}


def _cell_bag_row(case: str, path: str, table, ids) -> dict:
    """The bag kernel at a cell's ids, bit-identical to its plain version,
    timed beside it and ``F.embedding_bag``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.bag.bag import embedding_bag_cuda
    from repro_torch.kernels.bag.ref import embedding_bag_ref

    out = embedding_bag_cuda(table, ids, None, combine="sum")
    ref = embedding_bag_ref(table, ids, None, combine="sum")
    err = float((out - ref).abs().max())
    if not torch.equal(out, ref):
        fail(f"bag {case}: not bit-identical to its plain version (max err {err})")
    lib_ids = ids.long()
    B, S = ids.shape
    return {"name": "bag", "case": f"{case} {B}x{S} D={table.shape[1]} sum", "path": path,
            "idle": None, "counter": "bag", "source": "src/repro_torch/csrc/bag.cu",
            "replaces": "src/repro/kernels/bag/bag.py:30", "max_abs_err": err,
            "ms": cuda_ms(lambda: embedding_bag_cuda(table, ids, None, combine="sum"), 20),
            "plain_ms": cuda_ms(lambda: embedding_bag_ref(table, ids, None, combine="sum"), 20),
            "library_ms": cuda_ms(lambda: F.embedding_bag(lib_ids, table, mode="sum"), 20),
            "bound": _bag_bound(ids, table.shape[1], False, table.element_size())}


def _cell_bag_backward_row(case: str, path: str, ids, V: int, seed: int) -> dict:
    """The bag's backward at a cell's ids into the (V, 1) gradient, on
    integer-valued gradients so the atomics' order rounds nothing: equal
    bit for bit to its plain version, timed beside it and ``index_add_``."""
    import numpy as np
    import torch

    from repro_torch.dist import roofline
    from repro_torch.kernels.bag.bag import embedding_bag_backward_cuda
    from repro_torch.kernels.bag.ref import embedding_bag_backward_ref

    dev = ids.device
    B, S = ids.shape
    g = torch.as_tensor(np.random.default_rng(seed).integers(-4, 5, size=(B, 1))
                        .astype(np.float32), device=dev)
    out = embedding_bag_backward_cuda(g, ids, None, V, combine="sum")
    ref = embedding_bag_backward_ref(g, ids, None, V, combine="sum")
    err = float((out - ref).abs().max())
    if not torch.equal(out, ref):
        fail(f"bag_backward {case}: disagrees with its plain version (max err {err})")
    rows_ids = ids.reshape(-1).long()
    src = g.repeat_interleave(S, dim=0)
    return {"name": "bag_backward", "case": f"{case} {B}x{S} D=1 V={V} sum", "path": path,
            "idle": None, "counter": "bag_backward", "source": "src/repro_torch/csrc/bag.cu",
            "replaces": "no TPU kernel: XLA's scatter-add, the VJP of jnp.take at "
                        "src/repro/dist/embedlookup.py:23",
            "max_abs_err": err,
            "ms": cuda_ms(lambda: embedding_bag_backward_cuda(g, ids, None, V,
                                                              combine="sum"), 10),
            "plain_ms": cuda_ms(lambda: embedding_bag_backward_ref(g, ids, None, V,
                                                                   combine="sum"), 5),
            "library_ms": cuda_ms(lambda: torch.zeros((V, 1), device=dev).index_add_(
                0, rows_ids, src), 10),
            "bound": _bound(*roofline.bag_backward_work(ids, 1, V, weighted=False))}


def _cell_recsys(seed: int, smi: str) -> tuple[list[dict], list[dict], dict]:
    """DeepFM's serve_p99 and train_batch cells materialised on the card:
    CELL_RECSYS_REPS serve calls (after two warm-ups) and CELL_TRAIN_STEPS
    AdamW steps (after one), each a counted window that must launch the
    bag once a call (and its backward once a step); then the kernel rows
    at the cells' ids.  Returns (lines, kernel rows, windows)."""
    import numpy as np
    import torch

    from repro_torch.launch import cells
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import recsys as recsys_lib

    arch, serve_shape, train_shape = CELL_RECSYS
    dev = torch.device(DEVICE)
    mesh = make_test_mesh((1, 1), device=dev)
    lines, rows, windows = [], [], {}

    cell = cells.build(arch, serve_shape, mesh)
    params, batch = cell.materialize(dev, torch.Generator(device=dev).manual_seed(seed))
    for _ in range(2):
        cell.step(params, batch)
    _peak_reset()
    (probs, times), counts = counted(
        lambda: _timed_calls(lambda: cell.step(params, batch), CELL_RECSYS_REPS, warmup=0))
    path = f"{arch} {serve_shape} cell"
    require(counts, {"bag": CELL_RECSYS_REPS}, path)
    if not bool(torch.isfinite(probs).all()):
        fail(f"cells {path}: scores not finite")
    windows[path] = counts
    p50 = float(np.median(times))
    lines.append({"cell": f"{arch} {serve_shape}", "row": "serve", "batch": cell.batch_per_call,
                  "p50_ms": p50 * 1e3, "examples_per_s": cell.batch_per_call / p50,
                  "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": counts,
                  "device": smi})
    log("cells " + json.dumps(lines[-1]))
    flat = recsys_lib._flat_ids(batch["ids"], cell.cfg)
    rows.append(_cell_bag_row("first-order term, DeepFM serve_p99 cell", path,
                              params["linear"], flat))
    log("kernel " + json.dumps(rows[-1]))
    del params, batch, probs
    gc.collect()

    cell = cells.build(arch, train_shape, mesh)
    params, state, batch = cell.materialize(dev, torch.Generator(device=dev).manual_seed(seed))
    V = params["linear"].shape[0]
    params, state, _ = cell.step(params, state, batch)  # the warm-up
    _peak_reset()

    def run(p, s):
        losses, times = [], []
        for _ in range(CELL_TRAIN_STEPS):
            t0 = time.perf_counter()
            p, s, m = cell.step(p, s, batch)
            losses.append(float(m["loss"]))
            times.append(time.perf_counter() - t0)
        return losses, times

    (losses, times), counts = counted(lambda: run(params, state))
    path = f"{arch} {train_shape} cell"
    require(counts, {"bag": CELL_TRAIN_STEPS, "bag_backward": CELL_TRAIN_STEPS}, path)
    if not all(math.isfinite(v) for v in losses):
        fail(f"cells {path}: losses {losses}")
    windows[path] = counts
    p50 = float(np.median(times))
    lines.append({"cell": f"{arch} {train_shape}", "row": "train",
                  "batch": cell.batch_per_call, "steps": CELL_TRAIN_STEPS,
                  "p50_ms": p50 * 1e3, "examples_per_s": cell.batch_per_call / p50,
                  "losses": losses, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                  "launches": counts, "device": smi})
    log("cells " + json.dumps(lines[-1]))
    flat = recsys_lib._flat_ids(batch["ids"], cell.cfg)
    rows.append(_cell_bag_row("first-order term, DeepFM train_batch cell", path,
                              params["linear"], flat))
    log("kernel " + json.dumps(rows[-1]))
    rows.append(_cell_bag_backward_row("first-order gradient, DeepFM train_batch cell", path,
                                       flat, V, seed))
    log("kernel " + json.dumps(rows[-1]))
    del params, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return lines, rows, windows


def _cell_dryrun(smi: str) -> list[dict]:
    """``CELL_DRYRUN`` through ``launch/dryrun.run_cell`` on the production
    (16, 16) mesh of meta ranks, on the host: the roofline terms and the
    per-device memory, analytic (no card reading)."""
    import shutil

    from repro_torch.launch import dryrun

    out_dir = os.path.join(HERE, "build", f"phase15-dryrun-{os.getpid()}")
    lines = []
    try:
        for arch, shape in CELL_DRYRUN:
            t0 = time.perf_counter()
            r = dryrun.run_cell(arch, shape, out_dir=out_dir)
            line = {"cell": f"{arch} {shape}", "mesh": r["mesh"], "analytic": True,
                    "source": "launch/dryrun.run_cell on meta tensors, on the host; "
                              "H100 peaks, not a card reading",
                    "seconds": time.perf_counter() - t0, "roofline": r["roofline"],
                    "memory_per_device": r["memory"], "cost": r["cost"],
                    "collectives": r["collectives"], "device": smi}
            log("dryrun " + json.dumps(line))
            lines.append(line)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return lines


def phase_cells(seed: int, smi: str) -> tuple[list[dict], list[dict], dict]:
    """Phase 15: cells built by ``launch/cells.build`` and materialised on
    the card — qwen3-moe training on a (2, 4) mesh of ranks, deepseek-v3's
    training reckoned, deepseek-coder-33b's serving cells, a GNN and two
    recsys cells — and a dry-run of three cells on the production mesh of
    meta ranks.  Returns (lines, kernel rows, windows)."""
    import torch

    t0 = time.perf_counter()
    lines = _cell_train(seed, smi)
    left = _cell_left_out()
    left["device"] = smi
    log("cells " + json.dumps(left))
    lines.append(left)
    lines += _cell_serve(seed, smi)
    lines.append(_cell_gnn(seed, smi))
    log("cells " + json.dumps(lines[-1]))
    recsys, rows, windows = _cell_recsys(seed, smi)
    lines += recsys
    gc.collect()
    torch.cuda.empty_cache()
    lines += _cell_dryrun(smi)
    log(f"phase 15 seconds {time.perf_counter() - t0:.3f}")
    return lines, rows, windows


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import _build  # fails outside a checkout

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    env = phase_environment(_build.build())
    rows = phase_kernels(args.seed, env["kernels"])
    corpus, Qt, data_s = _full_width_data(args.seed)
    sweeps = {}
    main_path, main_state = phase_main_path(corpus, Qt, data_s, sweeps)
    rows += _beam_rows(main_state, Qt)
    rows += _rescore_rows(main_state, Qt, args.seed)
    bench = _bench_data(args.seed)
    parity = phase_parity(bench, sweeps)
    quant = phase_quant(corpus, Qt, main_state, bench, parity)
    filtered, filtered_rows, filtered_windows = phase_filtered(
        main_state["index"].X, Qt, main_state, args.seed)
    rows += filtered_rows
    serving, serving_rows, serving_windows = phase_serving(
        corpus, Qt, main_state, bench, main_path["p50_batch_ms"], args.seed)
    rows += serving_rows
    sharded, sharded_rows, sharded_windows = phase_sharded(corpus, Qt, main_state,
                                                           args.seed)
    rows += sharded_rows
    del main_state, filtered, serving, sharded
    gc.collect()
    torch.cuda.empty_cache()
    manhattan = phase_manhattan(corpus, Qt)
    del corpus, Qt
    recsys = phase_recsys(args.seed, sweeps)
    _, training_windows = phase_training(sweeps)
    gc.collect()
    torch.cuda.empty_cache()
    phase_models(args.seed, env["nvidia_smi"])
    moe_lines = phase_moe(args.seed, env["nvidia_smi"])
    phase_mesh(args.seed, env["nvidia_smi"], moe_lines)
    _, cell_rows, cell_windows = phase_cells(args.seed, env["nvidia_smi"])
    rows += cell_rows
    rows += phase_qpath_windows(sweeps)

    windows = {"full-width build": main_path["launches"]["build"],
               "full-width ground truth": main_path["launches"]["ground_truth"],
               "full-width serve": main_path["launches"]["serve"],
               "manhattan build": manhattan["launches"]["build"],
               "manhattan ground truth": manhattan["launches"]["ground_truth"]}
    windows.update({f"bench-config build q={p['q']}": p["launches"] for p in parity})
    windows["brute f32 serve"] = next(
        r["launches"] for r in quant if r["engine"] == "brute")
    windows["quantized brute serve"] = next(
        r["launches"] for r in quant if r["engine"] == "brute+quant")
    windows.update(filtered_windows)
    windows.update(serving_windows)
    windows.update(sharded_windows)
    windows.update({f"{r['arch']} {r['shape']}" if r["shape"] != "infinity retrieval"
                    else "infinity retrieval": r["launches"]
                    for r in recsys if "launches" in r})
    windows.update(training_windows)
    windows.update(cell_windows)
    kernels = []
    for row in rows:
        path = row["path"]
        kernels.append({
            "name": row["name"], "case": row["case"], "route": "cuda",
            "source": row["source"], "replaces": row["replaces"],
            "path": path or row["idle"],
            "launches": windows[path][row["counter"]] if path else 0,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound"]["ms"],
            "bound_by": row["bound"]["by"], "library_ms": row["library_ms"],
        })
    log(f"seconds total {time.perf_counter() - t_start:.3f} "
        f"nvcc build {env['build_seconds']:.3f}")
    log(env["nvidia_smi"])
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
