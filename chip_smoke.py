#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--rows N] [--trees T] [--seed S] [--reps R]
                          [--eps-rows N] [--eps-trees T] [--bag-trees T]
                          [--bag-legacy-trees T] [--cov-default-trees T]
                          [--serve-trees T]

Phases (any failed check exits non-zero):

1. the card's name and power limit; build the CUDA kernels from
   ``dryad_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel, and the
   native host layer's ``g++`` beside them); count
   the atomic instructions in each built library (``cuobjdump -sass``):
   no shared-memory compare-and-swap in the histogram kernels, and each
   holds its asynchronous copies (TMA and cp.async in K1, bulk copies in
   K3);
2. Higgs-shaped data, ``rows`` training rows + 1M held-out rows, from the
   seed, sketched and binned by the native host layer (28 native
   sketches, one native binning); one capture tree of the wired path
   records its kernels' inputs;
3. K1 layout mode (histograms) on the card vs its plain version at the
   root and at the widest level (P=128): bitwise equal (counts and g/h:
   both sum in the tree's fixed point), two launches bitwise equal; K2
   (row move) at a depth-4 level, bitwise; each with its time, the plain
   version's, one library call's and the bound; at both K1 shapes the
   accumulate-only launch (``reduce=``) plus ``sums_to_float`` bitwise
   the full launch, both timed;
4. the wired path: the headline config (28 features, 256 bins, depthwise,
   max_depth 8, 255 leaves, learning rate 0.1) with the launch counts set
   to 0 just before: 9 K1 and 8 K2 launches per tree; a second run gives
   bitwise-equal trees;
5. predict of the held-out rows on the card, bitwise equal to the port's
   own CPU predict; AUC above 0.70 and rising from tree 1 to the last;
6. one wired tree under torch.profiler: device time by kernel and the
   device's busy share of the tree's wall time;
7. wired against legacy on a tie-free fixture (50k rows, 64 bins, 4
   trees, 128 leaves, depth 8): equal trees;
8. the legacy plan arm at the headline config (``deep_layout="legacy"``):
   one capture tree; K3 (natural-order pass) at level 4 (P=16) and K1 row
   mode at level 7 (P=128) vs their plain versions, as in phase 3, with
   the accumulate-only check;
9. the legacy path: 5 K3, 4 K1 row-mode and no other launches per tree; a
   second run bitwise equal; card predict bitwise equal to CPU predict; AUC
   above 0.70 and rising; tree 1 equal to the wired run's tree 1 (no
   node differs); one tree profiled;
10. leaf-wise growth, wired (Higgs data, ``growth="leafwise"``, 255
   leaves, max_depth 8): the batched grower and the wired gate are taken;
   one capture tree holds K2 at level 4 and K1 layout mode at the widest
   level (P=128) against their plain versions, under heap-node runs; 9 K1
   and 8 K2 launches per tree and no other; a second run bitwise equal;
   card predict bitwise equal to CPU predict; AUC above 0.70 and rising;
   one tree profiled, and the selection replay's host and device time;
11. leaf-wise at the reference's default depth (``max_depth=-1``, which
   ``effective_depth_params`` maps to 12, past the wired cap of 2^D <=
   1024, so the legacy arm): K3 at P=8 and K1 row mode at P=2048 against
   their plain versions; 4 K3 and 9 K1 row-mode launches per tree and no
   other; second run, predict and AUC as in 10; peak device memory; one
   tree profiled;
12. the leaf-wise fixture (50k rows, 64 bins, 4 trees, 128 leaves, depth
   8): wired and legacy trees equal; on one tree the batched grower equals
   the sequential ``grow_tree`` on every integer array (node ids and
   ``row_leaf`` included); ``{"objective": "binary"}`` alone trains 3
   trees of 31 leaves at effective depth 9 on the wired arm;
13. the training loop on the wired path, bagged and validated (the
   headline config with ``subsample=0.8``, ``colsample=0.8``, the 1M
   held-out rows as the valid set, AUC early stopping after 5 rounds,
   ``bag_trees`` trees): one capture tree holds K1 at the masked root and
   K2 at level 0 against their plain versions, counts the root's rows
   (the bag's), and checks that level 0's move keeps every in-bag record
   once and no out-of-bag one; 9 K1 and 8 K2 launches per tree; a second
   run bitwise equal (trees, evals, best iteration); the trainer's valid
   scores bitwise equal to predict's, its last AUC within 1e-5 of the host
   AUC, above 0.70 and risen from tree 1; trees/s with and without the
   valid set, ms per device AUC at 1M rows, peak memory;
14. checkpoint/resume on the card: 10 bagged, validated trees straight; a
   run that crashes at iteration 6 after checkpoints every 3; the resumed
   run grows 4 trees (9 K1 + 8 K2 each) and equals the straight run bit
   for bit (trees, evals, best iteration, predict of the held-out rows);
   its saved model file loads and predicts bitwise;
15. leaf-wise at the default depth (legacy arm) with ``subsample=0.8``:
   on a capture tree out-of-bag rows carry K3's drop slot and stay out of
   K1 row mode's plan, and K3 at P=8 and K1 row mode at P=2048 equal their
   plain versions; then as in 11 with ``bag_legacy_trees`` trees;
16. Epsilon-shaped regression (``eps_rows`` x 2000 features + 50k held
   out, the set's 400k + 100k rows cut to 300k + 50k for the script's
   time, still past the natural-order gate; 256 bins, max_depth 6, 63 leaves), after the Higgs tensors are
   freed: K1 row mode vs its plain version at the root and the widest
   level (P=32); 7 K1 row-mode launches per tree and no other; a second
   run bitwise equal; held-out RMSE falls from tree 1 to the last and ends
   below the label's standard deviation; time per tree, peak memory, one
   tree profiled;
17. Covertype-shaped multiclass (``covertype_like(581k + 100k, 54, 7,
   seed=11)``: 581k training rows, Covertype's size, and 100k held out as
   the valid set; 256 bins; the acceptance config: depthwise, max_depth 6,
   63 leaves, 30 iterations of 7 class trees, cut to 9
   (``COV_ITERATIONS``) for the script's time): on the last class tree of
   a capture iteration (the second, where g and h differ by class), K1 at
   the root (P=1; its sums are that class's gradient column and no
   other's) and the last level (P=32) and K2 at
   level 3 against their plain versions; 7 K1 and 6 K2 launches per tree,
   7 trees per iteration; a second run bitwise equal; card predict (N, 7)
   bitwise equal to CPU predict; the trainer's valid scores bitwise equal
   to predict's; held-out accuracy above 0.55; multi_logloss falling from
   iteration 1 to the last and its last value within 1e-5 of the host
   oracle on predict; iterations/s and trees/s with and without the valid
   set, peak memory, one iteration profiled;
18. Covertype at the reference's defaults (``{"objective": "multiclass",
   "num_class": 7}``: leaf-wise, 31 leaves, effective depth 9, wired arm)
   with ``subsample=0.8``, ``colsample=0.8``, the valid set and early
   stopping after 5 rounds, ``cov_default_trees`` iterations: 10 K1 and 9
   K2 launches per tree; the K trees of each iteration get that
   iteration's bag and feature mask; a run that crashes at iteration 6
   after checkpoints every 3 resumes bitwise equal to the straight run
   (trees, evals, best iteration, predict); its model file predicts
   bitwise; one iteration profiled;
19. the multiclass fixture (``covertype_like(50_000, 54, 3, seed=43)``, 64
   bins, depthwise, depth 8, 128 leaves, 3 iterations): on the last class
   tree of the legacy arm, K3 and K1 row mode against their plain
   versions; the legacy run's K3 and K1 row-mode launches; wired and
   legacy trees equal;
20. MSLR-WEB30K LambdaMART (``mslr_like(9,460 + 3,153 queries, (5, 234)
   documents, 136 features, seed=17)``: half the train queries of one
   fold (18,919), cut for the script's time, and the next 3,153 (half of
   6,306) as the valid set; the acceptance config: leaf-wise, 31
   leaves, max_depth 10, 50 trees cut to 15, 256 bins, NDCG@10 every
   iteration).
   145-byte records refuse the wired layout, so the batched grower's
   legacy arm: on a capture tree K3 (level 3, P=8) and K1 row mode (root
   and level 9, P=512) against their plain versions; 4 K3 and 7 K1
   row-mode launches per tree (from ``leafwise_fast.phase_plan`` and the
   K3 gate); a second run bitwise equal; card predict bitwise equal to CPU
   predict; the trainer's valid scores bitwise equal to predict's; NDCG@10
   rising from iteration 1 and above the zero-score NDCG, its last value
   within 1e-5 of the host oracle; the lambda pass on tree 12's scores
   twice bitwise and within rtol 1e-5 / atol 1e-6 of the CPU's;
   iterations/s, the lambda pass's and one NDCG eval's device ms, one
   iteration profiled (K3 and K1 row mode device ms, busy share), peak
   memory;
21. l1, huber, fair, quantile (alpha 0.9) and poisson on phase 16's binned
   Epsilon matrix (no second binning; poisson labels drawn from the
   regression labels with a seeded generator), depthwise, max_depth 6, 63
   leaves, 10 trees each: 7 K1 row-mode launches per tree; g/h on the card
   bitwise equal to the CPU's (poisson within 2 ulps); the first tree's
   renewed leaves (l1, huber, quantile) equal numpy's type-1 quantiles of
   their in-bag residuals; the held-out loss (mae, rmse, pinball at 0.9,
   poisson deviance) falls from tree 1 to 10; the device poisson deviance
   within 1e-5 of the host's; a quantile run crashed at tree 6 resumes
   bitwise equal to the straight run; the renewal's device ms per tree;
22. Criteo, CSR ingest and categorical splits (``criteo_like(1M + 100k,
   seed=19)`` drawn once: 13 dense and 26 categorical features of
   cardinality 1000; the first 1M (``CRITEO_ROWS``, cut from the public
   set's 45.8M for the time limit) train through ``Dataset(None, y,
   csr=..., categorical_features=...)``, the last 100k, sliced from the same
   CSR triple, bind through the train mapper as the valid set; the
   acceptance config: depthwise, max_depth 6, 63 leaves, 30 trees, 256
   bins, AUC every iteration): the mapper holds 26 categorical features
   and the config takes the wired arm; the first 200k rows densified bin
   bitwise as ``bin_csr`` binned them; on a capture tree K1 (root, last
   level) and K2 (level 3) against their plain versions, and the last
   level's categorical scan and route timed with and without their
   categorical arms; 7 K1 and 6 K2 launches per tree; at least one
   categorical split; a second run bitwise equal; card predict of the 100k
   valid rows bitwise equal to CPU predict; the trainer's valid scores
   bitwise equal to predict's; AUC rising from tree 1 to 30, above 0.60,
   its last value within 1e-5 of the host's; set-up seconds by step
   (generation, sketch, binning, bundling plan), trees/s with and without
   the valid set, peak memory, one tree profiled;
23. Criteo fixtures: ``criteo_like(50_000, seed=43)``, 64 bins, depthwise
   depth 6, 10 trees: wired and legacy trees equal, and K3 and K1 row mode
   of the legacy run against their plain versions; at the reference's
   defaults with the categorical features (leaf-wise, depth 9, wired) the
   batched grower equals the sequential one on a tree; a bundled (EFB)
   CSR fixture with a categorical bundle and missing values: card trees
   equal CPU trees, card predict bitwise equal to CPU predict, a model
   file saved on the card loads and predicts bitwise, and its mapper
   bytes equal the CPU run's file's; its text model (``dump_text``) loads
   and predicts bitwise.
24. GOSS (``boosting="goss"``, rates 0.2 and 0.1) on the Higgs rows of
   phase 2 at the headline config (depthwise depth 8, 255 leaves, 256
   bins, wired), the 1M held-out rows as the valid set, 10 trees: the
   card's uniforms equal the numpy copy at 10M rows for iterations 0
   and 1; the card's selection (mask, amplified g and h) equals the CPU's
   bitwise; K1's root and K2's level-0 move under the GOSS mask against
   their plain versions (the kept rows moved once); 9 K1 and 8 K2
   launches a tree; a second run bitwise; card predict bitwise CPU; the
   last eval within 1e-5 of the host AUC; AUC rising and above 0.70;
   the selection's ms, the tree's fixed-point shift with and without the
   amplification, one tree profiled;
25. monotone constraints on features 6-9 (each with the sign of its
   weight in ``higgs_like``'s linear term), depthwise and leaf-wise
   (depth 8, 255 leaves, wired), 10 trees each: 9 K1 and 8 K2 launches a
   tree; predict monotone along each constrained feature over 256 held-out
   rows x 64 grid points within 1e-6; AUC rising; the widest level's
   split scan timed with and without its monotone arm;
26. DART (drop rate 0.1, skip 0.5, at most 50) at the headline config,
   validated, 10 trees: the loop's drop sets equal ``dart_drop_set``'s;
   its final valid scores equal CPU predict of the final table bitwise;
   no best iteration; 9 K1 and 8 K2 launches a tree; the drop
   iterations' times beside the others';
27. rf (subsample 0.7, colsample 0.8) at the headline config,
   validated, 10 trees: K1's root under the bag against its plain
   version; 9 K1 and 8 K2 launches a tree; the streamed AUC equals the
   host AUC of (averaged) predict within 1e-5; card predict bitwise CPU;
28. the modes' fixtures on ``higgs_like(50_000, seed=43)``, 64 bins:
   GOSS and monotone wired = legacy (depth 8, 128 leaves; K3 and K1 row
   mode of a legacy tree against their plain versions) and, leaf-wise at
   depth 8, batched = sequential; DART and rf (depth 6) killed at
   iteration 7 and resumed from checkpoints every 3, bitwise; each mode's
   card trees equal the CPU's (values within 1e-4).

29. ``cv`` at the headline config on phase 2's Higgs rows: 3 stratified
   folds (``CV_FOLDS``, cut from 5 for the script's time) (they partition the rows) of 10 trees, AUC every iteration: 9 K1
   and 8 K2 launches a tree; each fold's last AUC within 1e-5 of the host
   AUC of its booster's card predict on its holdout; the mean curve
   rises; a second ``cv`` at 3 trees a fold bitwise the first 3
   iterations of each fold; seconds per fold;
30. the model API on phase 4's headline booster: ``pred_leaf`` of the 1M
   held-out rows on the card bitwise the CPU's, and init plus the leaves'
   values in tree order bitwise the raw predict; the booster re-indexed to
   feature ids >= 4096 (the structure-of-arrays traversal) on 100k rows
   widened to 4124 columns predicts bitwise as the packed arm; TreeSHAP of
   200 rows (``SHAP_ROWS``, cut from 2,000 for the script's time) on the
   card within 1e-9 of the CPU's, contributions plus bias within 1e-5 of
   predict, rows/s; ``refit`` on the first 250k held-out rows
   (``REFIT_ROWS``, cut from 1M)
   at decay 0.9, card = CPU structure and values within rtol 1e-5 / atol
   1e-6, two card runs bitwise, decay 1.0 bitwise the old values,
   seconds; a text model round trip predicts bitwise; split counts sum to
   the internal nodes;
31. ``DryadClassifier`` at its defaults (leaf-wise, 31 leaves, depth 9,
   wired), 10 iterations on the raw Covertype rows drawn as phase 17
   draws them, labels ``y * 10 + 3``: ``classes_`` the 7 labels; 10 K1
   and 9 K2 launches a tree; ``predict_proba`` of the 100k held-out rows
   sums to 1 within 1e-5 and is bitwise ``predict(clf.booster_, X)``;
32. serving (``dryad_tpu_torch.serve``), last: the headline config
   trained at ``serve_trees`` (50, cut from the north star's 500 for
   the script's time) trees on
   phase 2's rows (9 K1 and 8 K2 launches a tree; held-out AUC above 0.70
   and risen from tree 10; trees/s), saved, and served from the saved
   file beside a second, named model (20 regression trees, a text file):
   launches of one bucket call of the tree-at-once program against
   ``accumulate``'s; warmup captures one CUDA graph per (version, bucket),
   seconds each; served raw and transformed answers bitwise the direct
   card predict at every request shape (1 to 5000 rows, chunked past
   4096) for both models, bitwise the CPU predict on 10k rows, and 8
   concurrent clients' answers bitwise slices of one predict; no capture
   after ``warmup_complete()`` and ``/healthz`` 200; latency p50/p99 at
   1, 8, 64, 512 and 4096 rows (``SERVE_LAT_REQS`` sequential requests
   each); one HTTP round trip bitwise; a budget eviction lowers
   ``torch.cuda.memory_allocated`` and the re-staged model answers
   bitwise; staged device bytes; bulk rows/s of 4 clients sending
   4096-row requests, pipelined against serial (``run_bench_compare``,
   two windows of ``SERVE_BULK["duration_s"]`` seconds an arm).

33. data-parallel training (``dryad_tpu_torch.distributed``), after
   serving: phase 2's binned rows, the held-out rows binned through the
   same mapper, the labels and the mapper are written once to a
   git-ignored directory of the checkout; two rank processes (each
   reading its own row block, importing nothing of the reference) join a
   gloo group and share the card, with the 1M held-out rows as every
   rank's valid set: (a) the headline config ("auto" is the fused
   all-reduce at F = 28), (a') the same on the feature arm
   (``hist_reduce="feature"``), (b) the feature arm with ``subsample`` and
   ``colsample`` 0.8; then this process joins a one-rank NCCL group
   through ``initialize()`` and trains (a) and (a') through
   ``train_distributed``.  The yardsticks are one process without a
   group on all the rows, with the same valid set (its unbagged trees
   are phase 4's): every rank's trees and eval history are bitwise
   theirs; 9 K1 and 8 K2 launches per tree per rank; trees/s per run
   (and of the yardsticks), the histogram collectives' bytes per tree
   (all-reduced, or reduce-scattered and all-gathered) and their ms per
   tree (CUDA events around each collective).  The ranks run with
   introspection on, as users run a group (phase 35's too): each
   observes the first tree of each of its three runs (``dryad_prog_*``
   in its report).

34. streamed training and the grower's reach, last, on phase 2's rows at
   the headline config: (a) the 10M-row binned matrix spilled to a
   git-ignored ``_stream_rows/`` (removed at the end of the phase) with
   ``StreamedDataset.from_dataset`` at ``DEFAULT_CHUNK_ROWS`` (1,048,576)
   and at 999,983 rows a chunk; 10 trees from each spill: trees bitwise a
   resident run's, 9 K1 and 8 K2 launches a tree, held-out card predict
   bitwise the CPU predict; (b) ``dataset_from_chunks(..., mapper=,
   spill=)`` over the raw rows in 1M-row chunks: the file bitwise
   ``ds.X_binned``, chunk by chunk, and the bin pass's seconds; (c) the
   upload seconds of the resident tensor and of the streamed assembly
   (fresh sets, ending in ``torch.cuda.synchronize``), the host's peak-RSS
   growth during each (VmRSS sampled every 0.5 ms), trees/s of fresh
   resident and streamed sets in two interleaved pairs (of three, for the
   script's time), and each run's
   peak device memory above what was allocated before it; (d) the first 2M rows (``WIDE_ROWS``, cut
   from 10M for the script's time) binned at 2048 bins: 5 trees on the
   legacy arm through arm A1 (no kernel launch), a second run bitwise,
   held-out AUC above 0.70, card predict bitwise CPU; the same rows at
   1024 bins: one tree on the wired kernels (9 K1, 8 K2) bitwise one
   under ``hist_backend="xla"`` (arm A1), and the widest level's pass
   timed on both (K1 against its plain version, ``index_add_`` and the
   bound, arm A1's ms beside it); (e) the same 2M rows at 256 bins,
   depthwise depth 16 and 65536 leaves, 2 trees: the unpacked route on
   every level (asserted), the legacy arm's K3 and K1 row-mode launches,
   a second run bitwise, card predict of 200k held-out rows on the SoA
   arm bitwise CPU; ms a tree, peak memory and the widest level's
   histogram bytes.

35. the rest of distribution, last: two gloo ranks sharing the card (the
   rank processes of phase 33, ``rank_main``, one set each at a time,
   written to the git-ignored ``_dist_modes/`` and removed after), each
   run against one process without a group on all the rows: trees, eval
   history and best iteration bitwise, the launches of its path by the
   largest rank's rows, trees/s beside one process's, and the bytes,
   device ms and host ms each collective purpose adds a tree (GOSS's
   radix rounds, the renewal's gathers, lambdarank's padded width, the
   mapper digests) with the run's ``comm_stats``: (a) GOSS (rates 0.2 and
   0.1) at the headline config on phase 2's rows, 5 trees, the 1M
   held-out rows as the valid set, on both arms; (b) lambdarank on phase
   20's MSLR sets (9,460 training queries, 136 features, leaf-wise 31
   leaves, depth 10, 2 trees), split at query boundaries
   (``query_row_range``), NDCG@10 on the valid queries; (c) l1 and
   quantile (alpha 0.9) on phase 16's Epsilon matrix at full width (2000
   features, 256 bins, depth 6, 63 leaves, the feature arm), its rows cut
   to 100k (``REST_EPS_ROWS``) for the script's time, 2 trees each, the
   held-out rows as the valid set; (d) phase 23's 50k-row Criteo CSR
   fixture (39 features, 26 categorical) and its bundled EFB fixture,
   each rank binning its CSR rows through the one mapper, 5 trees each;
   then this process as one NCCL rank trains (a) fused and (c) l1; (e)
   phase 32's serving model predicts the 1M held-out rows split over
   ``[cuda:0, cuda:0]`` and over every visible card, bitwise the
   single-device predict; a cache whose sharded family splits each
   4096-row bucket over ``[cuda:0, cuda:0]`` (two CUDA graphs) serves 16
   buckets bitwise the unsharded cache with no new entry; each path's
   ms and launches a call;
36. measurement and the dispatch policy (M14b): (a) every stage probe
   (``engine/probes.py``) liveness-proven and timed on the card at 1M
   rows, and the four kernel probes (K1 row mode: ``hist_masked``,
   ``hist_segmented``; K1 layout mode: ``hist_from_layout``; K2:
   ``permute_records``) also at the headline rows with 128 slots, their
   walls printed beside phases 3's and 8's kernel times, each launching
   its kernel once a step (path "profile"); the stage gauges and a
   stamped PROFILE artifact; (b) one calibration sweep derives the card's
   policy entry and, on the same walls, ``check_walls`` finds the
   committed table in agreement; (c) the headline config (``trees`` trees, the 1M held-out
   rows as the valid set) under the committed table and under an
   explicit ``_default``-only table: trees and held-out predictions
   bitwise, 9 K1 and 8 K2 launches a tree (path "policy_headline"); (d)
   phase 32's model served with ``DRYAD_PROG`` 0 and 1 (and
   ``DRYAD_PROG_TRACE=1``): answers bitwise,
   ``stats()["policy"]`` names the card, and every captured bucket has
   its ``dryad_prog_launches``, ``dryad_prog_device_ms`` and
   ``dryad_prog_wall_ms`` gauges; (e) the runs of (c) export
   ``dryad_fetch_inflight_age_seconds``; (f) a wide (20k x 2000, 20
   trees, cut from 50) and a multiclass (20k x 54, 7 classes, 5
   iterations, cut from 10) model trained on the card, 20k held-out rows
   (cut from 50k) traversed by both
   ``predict_layout`` arms through serving's and direct predict's
   programs: answers bitwise, each arm's device ms; (g) a new headline
   config's first tree and first predict of the 1M held-out rows, then
   the same again, with ``DRYAD_PROG`` 1, 0, 0, 1: host seconds.
37. the command line, drift, the HTTP routes and F2 (M15a), last, in a
   registry of its own: (a) ``higgs_like(2M + 200k, seed + 37)`` at the
   headline widths (28 features, 256 bins; rows cut from 10M for the
   script's time) written to the git-ignored ``_cli_rows/`` (removed
   after), and ``python -m dryad_tpu_torch train`` (its ``main``, in
   this process, so the launches count) on the card at the headline
   config for 20 trees with ``--valid``, ``--metrics-port``,
   ``--trace-out`` and ``--log-jsonl``: 9 K1 and 8 K2 launches a tree
   (path "cli_train"); ``/healthz``, ``/metrics`` and ``/stats``
   scraped during the ``DRYAD_METRICS_HOLD_S`` hold show 20
   ``train.iteration`` spans; the trace holds their X events; the valid
   AUC rises above 0.70; the model's profile equals
   ``build_reference_profile(..., device="cpu")`` over the same model and
   the rows its stride sample reads; ``predict`` on the card equals
   ``predict --device cpu`` bitwise; ``dump --text`` round-trips; (b)
   phase 32's model, which carries its profile (the capture re-run and
   timed equals it), served with drift on (window 8192) and off:
   in-distribution traffic stays under the PSI budget 0.2, traffic with
   feature 0 shifted by 2 sigma breaches in ``drift_report``,
   ``stats()["drift"]`` and ``dryad_drift_psi_max``; answers bitwise on
   and off and equal to direct predict; p50 and p99 at 1 and 4096 rows
   (``SERVE_LAT_REQS`` requests each, the two servers interleaved
   request by request), and ``run_bench_drift``'s overhead; (c) over HTTP on the card, ``GET
   /models`` and ``POST /models/load|activate|rollback`` with every
   answer after them bitwise the serving version's direct predict, and
   ``/trace/events`` holding a request's spans under its given and its
   minted trace id; (d) F2: GOSS's |g| on the card bitwise numpy's
   ``np.sqrt`` on a 7-class equal-score case, and a 7-class GOSS run on
   the card growing the CPU's trees (integer arrays equal, values within
   1e-4).
38. the native host layer and supervised training (M17, M15b): (a) the
   ``g++`` build's seconds; the 1M held-out rows sketched and binned
   natively and with ``DRYAD_NATIVE=0``: edges and bins bitwise, both
   timed; (b) on phase 37's draw cut to ``higgs_like(1M + 100k, seed +
   37)`` (for the script's time; widths kept) at the headline config (20
   trees, the 100k rows as the valid set), a straight run and a
   ``supervise_train`` run with a checkpoint every 4 iterations and
   injected ``device_unavailable`` at dispatch 5, ``oom`` at dispatch 9
   and ``fetch_death`` at the checkpoint fetch of iteration 12: trees,
   eval history and valid scores bitwise; the journal holds 3 ``fault``,
   3 ``resume``, 4 ``segment_start`` and one ``complete``; 9 K1 and 8 K2
   launches a grown tree, the 26 trees the segments grow included (path
   "supervised"); both walls; (c) fresh processes on the git-ignored
   ``_sup_rows/`` (removed after; the first two start before (b) and run
   beside it): a ``torch.empty`` of twice the card's memory classifies as
   ``oom`` and the process then grows a headline tree; a supervised run
   whose hook indexes a CUDA tensor out of range at dispatch 6 journals
   ``device_unavailable``, then ``fail_closed`` with
   ``sticky_device_error``, and exits non-zero; ``python -m
   dryad_tpu_torch train --supervise --resume`` on its checkpoint
   directory finishes 12 trees bitwise the straight run's first 12.
39. the serving fleet and continual boosting (M15c, M15d), last: phase
   37's 20-tree model at the headline widths (its drift profile
   embedded) is generation 0, served by two real ``python -m
   dryad_tpu_torch serve --device cuda --warmup`` replicas sharing the
   card under ``fleet.FleetSupervisor`` (r1 through ``add_slot`` while
   ``start`` spawns r0, so they start together) behind
   ``fleet.FleetRouter``
   (drift budget PSI 0.25, window 8192, every call with a timeout): (a)
   ``replica_crash`` armed on r0's second request through
   ``DRYAD_REPLICA_FAULTS``, under a closed loop of traced interactive
   requests: no request fails, every trace id round-trips, every answer
   is bitwise the in-process card predict, the journal runs
   ``replica_crash`` -> ``replica_respawn`` -> ``replica_ready`` at
   generation 1, the merged ``/trace`` holds one id with both forward
   attempts, ``/metrics`` the merged ``dryad_fleet_latency_ms`` p99
   gauges; (b) baseline traffic keeps ``GET /drift`` green; traffic
   scaled 3x journals ``drift_breach``; the real ``RetrainScheduler``
   launches ``python -m dryad_tpu_torch retrain --device cuda``, which
   appends 10 trees on ``higgs_like(300k, seed + 39)`` scaled 3x, bitwise
   an in-process ``train(init_model=)`` on the card (9 K1 and 8 K2 a
   tree, path "fleet_append"); the probationed rolling push journals
   ``generation_promoted`` and ``/drift`` goes green; a forced retrain
   with ``retrain:1:bad_generation`` in ``DRYAD_CONTINUAL_FAULTS`` is
   journaled ``generation_rolled_back``; no request fails across the
   pushes and ``dryad_recompile_unexpected_total`` is 0 on every
   replica; (c) a min-1 / max-3 ``CapacityController`` on the same
   fleet: a 7-client ramp of 1024- and 2048-row requests, started
   before the controller, until the scale-up starts, then one client
   through its spawn: one ``scale_up`` with no shed, then the light load
   retires a replica (``replica_retired``, ``scale_down``) with no
   failed request; each replica's seconds to ready; then
   ``fleet.bench.run_fleet_bench`` at 1 and 2 replicas (p50/p95/p99 by
   priority; on one card it measures routing and shedding, not
   scale-out).
40. the audit (M15e), run right after phase 6 on phase 2's rows: first
   ``torch.cuda.set_sync_debug_mode("warn")`` must warn once each for
   ``.item()``, ``.tolist()`` and ``.cpu()`` of a card tensor (the host
   sync count rests on it); then one headline tree under the op census
   (``dryad_tpu_torch/analysis/census.py``): 9 K1 and 8 K2 events on
   uint8 128-byte records, zero row-scale sorts, zero c10d ops, its host
   syncs equal to the card golden (``goldens/census.json``, ``card``,
   written by ``python -m dryad_tpu_torch.analysis --update-goldens
   --device cuda``), and the tree bitwise phase 4's first; K1 at that tree's root and K2 at
   its depth-4 move against their plain versions, as in phase 3; then
   the census's single-process small arms on the card: kernel events,
   row-scale sorts and collectives equal to the CPU goldens, host syncs
   equal to the card goldens; one JSON line with the counts, the phase's
   seconds and the card's name and power limit.

Phases 24-31 run after phase 15, while the Higgs rows are still held; the
log's ``phase seconds`` keys them "24-27", "28", "29-30" and "31".  Phase
40 runs after phase 6 (key "40").  Phase
32 runs after phase 23 on the same rows, kept on the host until then.

Each kernel's time is held beside two bounds, the bytes over the memory
rate and, for the histogram kernels, the shared-memory atomic updates (3
per live (row, feature) pair) over the atomic rate; ``bound_ms`` is the
larger.  The histogram kernels also report their
shared memory per block, blocks and features per block.

It prints, on lines of their own, a ``kernels`` JSON object, the card's
``name, power limit`` as nvidia-smi gives them and, last,
``{"ok": true, "device": {...}}``.  Full figures also go to
``chiprun_out/chip_smoke.json``.  Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate
# shared-memory atomic rate of an H100 SXM: 132 SMs x 32 banks (one 32-bit
# atomic slot per bank per clock) x 1.98 GHz boost clock.  One (row,
# feature) update of g, h and the count takes at least 3 slots, one 32-bit
# add each; the high-word adds the kernels also issue are not counted
# (PERF.md, "Bounds")
SMEM_ATOMIC_SLOTS_PER_S = 132 * 32 * 1.98e9
SLOTS_PER_UPDATE = 3
HEADLINE_ROWS = 10_000_000
HOLDOUT_ROWS = 1_000_000
EPS_ROWS = 300_000              # of Epsilon's 400k, for the time
EPS_HOLDOUT = 50_000            # of its 100k
EPS_FEATURES = 2000
COV_ROWS = 581_000
COV_HOLDOUT = 100_000
COV_ITERATIONS = 9              # of the acceptance config's 30, for the time
COV_FEATURES = 54
COV_CLASSES = 7
OUT = "chiprun_out"
ROOT = os.path.dirname(os.path.abspath(__file__))
# phase 33's rows, written once for the rank processes and removed after
# (git-ignored; not under OUT, which comes back from the card)
DIST_DIR = os.path.join(ROOT, "_dist_rows")
DIST_RANKS = 2
DIST_TIMEOUT_S = 300
# intra-op threads of each rank process: a fixed count, whatever the
# host's load (half of an 8-core host's cores over the two ranks)
DIST_RANK_THREADS = 4
# trees of each profiled run of phase 33's NCCL-against-one-process check
DIST_PROFILE_TREES = 3


# the raw rows of phases 16, 20 and 22, drawn on one background thread
# while the Higgs phases run (numpy's generators and BLAS release the
# interpreter lock): name -> future of (result, seconds drawing it)
_DRAWN: dict = {}


def draw_ahead(pool, name: str, fn, *args, **kw) -> None:
    def timed():
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        return out, time.perf_counter() - t0

    _DRAWN[name] = pool.submit(timed)


def drawn(name: str, fn, *args, **kw) -> tuple:
    """(``fn(*args, **kw)``, seconds drawing it): the background thread's
    result where ``draw_ahead`` started it, else drawn here."""
    fut = _DRAWN.pop(name, None)
    if fut is not None:
        return fut.result()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    for fut in _DRAWN.values():         # no draw left to wait for at exit
        fut.cancel()
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


# the asynchronous copies each histogram library must hold: K1's layout
# mode stages with TMA (UTMALDG) and its row mode with cp.async (LDGSTS),
# K3 with bulk copies (UBLKCP)
ASYNC_COPIES = {"hist": ("UTMALDG", "LDGSTS"), "hist_nat": ("UBLKCP",)}


def sass_atomics() -> dict:
    """The atomic instructions in each built library (``cuobjdump -sass``),
    by opcode, and its asynchronous copies (``ASYNC_COPIES``).  Fails if a
    histogram library holds a shared-memory compare-and-swap (``ATOMS.CAS*``,
    the loop a 64-bit shared add compiles to: its adds must be native 32-bit
    ``ATOMS.ADD``), or lacks one of its asynchronous copies (the kernels
    stage rows with them)."""
    import collections
    import re
    import shutil

    from dryad_tpu_torch.engine import cuda_build

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    check(os.path.exists(tool), "cuobjdump not found: the SASS of the "
          "histogram kernels cannot be checked")
    out = {}
    for name in cuda_build.SOURCES:
        sass = subprocess.run([tool, "-sass", cuda_build.lib_path(name)],
                              capture_output=True, text=True,
                              check=True).stdout
        ops = collections.Counter(re.findall(
            r"\b((?:ATOMS|ATOMG|ATOM|RED|UTMALDG|LDGSTS|UBLKCP)"
            r"(?:\.[A-Z0-9_]+)*)", sass))
        out[name] = dict(ops)
        if name in ("hist", "hist_nat"):
            check(any(op.startswith("ATOM") for op in ops),
                  f"{name}: no atomics in its SASS")
            cas = [op for op in ops if op.startswith("ATOMS.CAS")]
            check(not cas, f"{name}: shared-memory compare-and-swap in its "
                  f"SASS ({cas}): a 64-bit shared add crept back in")
            for copy in ASYNC_COPIES[name]:
                check(any(op.startswith(copy) for op in ops),
                      f"{name}: no {copy} in its SASS: the kernel no longer "
                      "stages with its asynchronous copies")
    return out


def sync() -> None:
    import torch

    torch.cuda.synchronize()


def time_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call: CUDA events around ``reps`` calls
    after one warm-up call."""
    import torch

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


def bound_ms(nbytes: float, pairs: float) -> dict:
    """The least time for the work: the larger of the bytes over the memory
    rate and the shared-memory atomic updates (``pairs`` live (row,
    feature) pairs) over the atomic rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = pairs * SLOTS_PER_UPDATE / SMEM_ATOMIC_SLOTS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_bound_ms": t_bytes, "update_bound_ms": t_ops,
            "updates": 3 * pairs}


def capture(dt, params, ds, dev, names, init=None):
    """Train one iteration (after ``init``'s, when given) with the named
    kernel wrappers wrapped; returns each wrapper's calls as (args,
    kwargs).  ``names`` maps a label to (module, attribute)."""
    calls = {k: [] for k in names}
    real = {k: getattr(m, a) for k, (m, a) in names.items()}

    def spy(k):
        def f(*a, **kw):
            calls[k].append((a, kw))
            return real[k](*a, **kw)
        return f

    for k, (m, a) in names.items():
        setattr(m, a, spy(k))
    try:
        n = 1 if init is None else init.num_iterations + 1
        dt.train(dict(params, num_trees=n), ds, device=dev,
                 init_booster=init)
    finally:
        for k, (m, a) in names.items():
            setattr(m, a, real[k])
    return calls


def compare(name: str, run, plain) -> tuple[object, float]:
    """Kernel twice (bitwise equal) vs its plain version: bitwise equal,
    counts and g/h (both are fixed-point integer sums in the tree's shift,
    rounded once).  Returns (result, max abs error)."""
    import torch

    k1 = run()
    k2 = run()
    sync()
    check(torch.equal(k1, k2), f"{name}: two launches differ")
    ref = plain()
    sync()
    err = float((k1 - ref).abs().max())
    check(torch.equal(k1[:, 2], ref[:, 2]), f"{name}: counts differ")
    check(torch.equal(k1, ref),
          f"{name}: g/h differ from the plain version (max abs err {err})")
    return k1, err


def _accumulate_only(acc):
    """The ``reduce=`` hook of a single process: the sums as they are, so
    the launch only accumulates and ``hist.sums_to_float`` converts."""
    return acc


def check_acc_only(name: str, full, acc_only, reps: int) -> dict:
    """The accumulate-only launch plus ``sums_to_float`` (what a process
    group's reduction runs between them) bitwise the full launch on the
    same inputs; both timed."""
    import torch

    a, f = acc_only(), full()
    sync()
    check(torch.equal(a, f), f"{name}: the accumulate-only launch plus "
          "sums_to_float differs from the full launch")
    return {"acc_only_ms": time_ms(acc_only, reps),
            "full_ms": time_ms(full, reps)}


def library_ms(leaf, valid, g, h, bins, P, F, B) -> float:
    """The library yardstick: one ``index_add_`` of the live (g, h, 1) rows
    into flat (leaf, feature, bin) cells, on precomputed cells (the port
    never calls it).  Rows outside ``valid`` (out of the bag, padding) are
    left out of the call rather than sent to one dump cell, whose
    contention would time the dump and not the sums.  ``bins`` (n, F)
    int64 is overwritten with the cells."""
    import torch

    dev = bins.device
    cell = bins
    cell += (leaf.long()[:, None] * F + torch.arange(F, device=dev)) * B
    cell = cell[valid]
    vals = torch.stack([g[valid], h[valid], torch.ones_like(g[valid])],
                       -1)[:, None, :].expand(-1, F, -1).reshape(-1, 3)
    acc = torch.zeros((P * F * B, 3), device=dev)
    cell = cell.reshape(-1)
    ms = time_ms(lambda: acc.index_add_(0, cell, vals), 3)
    del cell, vals, acc
    return ms


def check_hist(args, name: str, reps: int, acc_only: bool = False) -> dict:
    """K1 layout mode on the card vs its plain version on captured inputs;
    with ``acc_only``, ``check_acc_only`` too."""
    from dryad_tpu_torch.engine import hist

    from dryad_tpu_torch.engine import cuda_build

    rec, src, tile_leaf, P, B, F, isz, shift = args
    _, err = compare(name, lambda: hist.hist_tiles(*args),
                     lambda: hist.hist_tiles_plain(*args))
    shape = dict(cuda_build.launch_info.get("hist", {}))
    acc = ({"acc_only": check_acc_only(
        name, lambda: hist.hist_tiles(*args),
        lambda: hist.hist_tiles(*args, reduce=_accumulate_only), reps)}
        if acc_only else {})
    ms = time_ms(lambda: hist.hist_tiles(*args), reps)
    plain_ms = time_ms(lambda: hist.hist_tiles_plain(*args), 2)
    T, WB = hist.TILE_ROWS, hist.REC_WB
    n_in = rec.shape[0] // T
    live = src >= 0
    rows = rec.view(n_in, T, WB)[src.clamp(0, n_in - 1)].view(-1, WB)
    g, h, valid, bins = hist.unpack_rows(rows, F, isz)
    valid = valid & live.repeat_interleave(T)
    lib = library_ms(tile_leaf.repeat_interleave(T), valid, g, h, bins,
                     P, F, B)
    live_tiles = int(live.sum())
    nbytes = (live_tiles * T * (9 + F * isz) + src.numel() * 8
              + P * 3 * F * B * 4)
    bound = bound_ms(nbytes, float(int(valid.sum())) * F)
    del rows, g, h, valid, bins
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib, **bound,
            "max_abs_err": err, "P": P, "live_tiles": live_tiles,
            "bytes": nbytes, **shape, **acc}


def check_rows(args, name: str, reps: int, acc_only: bool = False) -> dict:
    """K1 row mode on the card vs its plain version on captured inputs;
    with ``acc_only``, ``check_acc_only`` too."""
    import torch

    from dryad_tpu_torch.engine import hist

    from dryad_tpu_torch.engine import cuda_build

    recs, buf, tile_leaf, P, B, F, isz, shift = args
    _, err = compare(name, lambda: hist.hist_rows(*args),
                     lambda: hist.hist_rows_plain(*args))
    shape = dict(cuda_build.launch_info.get("hist_rows", {}))
    acc = ({"acc_only": check_acc_only(
        name, lambda: hist.hist_rows(*args),
        lambda: hist.hist_rows(*args, reduce=_accumulate_only), reps)}
        if acc_only else {})
    ms = time_ms(lambda: hist.hist_rows(*args), reps)
    plain_ms = time_ms(lambda: hist.hist_rows_plain(*args), 2)
    N = recs.shape[0]
    valid = buf < N
    n_live = int(valid.sum())
    rows = recs[buf.clamp(max=N - 1)]
    bins = hist.bin_bytes(rows.view(torch.uint8), 8, 0, F, isz)
    lib = library_ms(tile_leaf.repeat_interleave(hist.TILE_ROWS), valid,
                     rows[:, 0].view(torch.float32),
                     rows[:, 1].view(torch.float32), bins, P, F, B)
    del rows, bins
    nbytes = (n_live * (8 + F * isz) + buf.numel() * buf.element_size()
              + P * 3 * F * B * 4)
    bound = bound_ms(nbytes, float(n_live) * F)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib, **bound,
            "max_abs_err": err, "P": P, "live_rows": n_live,
            "plan_tiles": int(tile_leaf.numel()), "bytes": nbytes, **shape,
            **acc}


def check_nat(call, name: str, reps: int, acc_only: bool = False) -> dict:
    """K3 on the card vs its plain version on captured inputs; with
    ``acc_only``, ``check_acc_only`` too."""
    import torch

    from dryad_tpu_torch.engine import cuda_build, hist_nat

    (xt, g, h, sel, shift), kw = call
    kw = {k: v for k, v in kw.items() if k != "reduce"}
    P, B, F = kw["num_cols"], kw["total_bins"], kw["num_features"]
    _, err = compare(
        name, lambda: hist_nat.build_hist_nat(xt, g, h, sel, shift, **kw),
        lambda: hist_nat.build_hist_nat_plain(xt, g, h, sel, shift, P, B, F))
    shape = dict(cuda_build.launch_info.get("nat", {}))
    acc = ({"acc_only": check_acc_only(
        name, lambda: hist_nat.build_hist_nat(xt, g, h, sel, shift, **kw),
        lambda: hist_nat.build_hist_nat(xt, g, h, sel, shift,
                                        reduce=_accumulate_only, **kw),
        reps)} if acc_only else {})
    ms = time_ms(lambda: hist_nat.build_hist_nat(xt, g, h, sel, shift, **kw),
                 reps)
    plain_ms = time_ms(lambda: hist_nat.build_hist_nat_plain(
        xt, g, h, sel, shift, P, B, F), 2)
    N = g.shape[0]
    keep = (sel >= 0) & (sel < P)
    n_keep = int(keep.sum())
    bins = xt[:, :N].t().contiguous().to(torch.int64) & 0xFFFF
    lib = library_ms(torch.where(keep, sel, 0), keep, g, h, bins, P, F, B)
    del bins
    isz = xt.element_size()
    nbytes = N * 4 + n_keep * (F * isz + 8) + P * 3 * F * B * 4
    bound = bound_ms(nbytes, float(n_keep) * F)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib, **bound,
            "max_abs_err": err, "P": P, "kept_rows": n_keep, "bytes": nbytes,
            **shape, **acc}


def check_perm(args, reps: int) -> dict:
    """K2 on the card vs its plain version on the captured inputs."""
    import torch

    from dryad_tpu_torch.engine import leafperm

    rec, pos, dstl, dstr, n_out = args
    k1 = leafperm.permute_records(*args)
    k2 = leafperm.permute_records(*args)
    plain = leafperm.permute_records_plain(
        rec, pos, dstl.clamp(max=(n_out - 1) * 512),
        dstr.clamp(max=(n_out - 1) * 512), n_out)
    sync()
    check(torch.equal(k1, k2), "perm: two launches differ")
    check(torch.equal(k1, plain), "perm: kernel differs from plain version")
    ms = time_ms(lambda: leafperm.permute_records(*args), reps)
    plain_ms = time_ms(lambda: leafperm.permute_records_plain(
        rec, pos, dstl, dstr, n_out), 3)
    # library yardstick: one index_copy_ of every record to its
    # precomputed destination (sentinel rows to a dump row)
    T = leafperm.TILE_ROWS
    pl, pr = pos[:, 0, :].long(), pos[:, 1, :].long()
    dest = torch.where(pl < T, dstl.long()[:, None] + pl,
                       torch.where(pr < T, dstr.long()[:, None] + pr,
                                   n_out * T)).reshape(-1)
    out = torch.zeros((n_out * T + 1, leafperm.REC_WB), dtype=torch.uint8,
                      device=rec.device)
    library = time_ms(lambda: out.index_copy_(0, dest, rec), 3)
    real_rows = int((dest < n_out * T).sum())
    nbytes = (real_rows * leafperm.REC_WB + pos.numel() * 4
              + dstl.numel() * 8 + n_out * T * leafperm.REC_WB)
    bound = bound_ms(nbytes, 0.0)
    del out, dest
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "max_abs_err": 0.0, "real_rows": real_rows, "bytes": nbytes}


def dev_us(e) -> float:
    """Self device time of a profiler event, in microseconds."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def kernel_rows(avgs) -> list:
    """[(kernel name, self device us, launches)] of a ``key_averages``
    list, each kernel's rows summed (a grouping by input shape may split
    a name over rows)."""
    import torch

    rows: dict = {}
    for e in avgs:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            r = rows.setdefault(e.key, [0.0, 0])
            r[0] += dev_us(e)
            r[1] += e.count
    return [(k, us, n) for k, (us, n) in rows.items()]


def profile_tree(params, ds, dev, fname: str) -> dict:
    """One iteration of the grower, one tree per output (under iteration
    0's bag and feature mask, or GOSS's selection), under torch.profiler: device time by
    kernel, and the device's busy share of its wall time (measured again
    without the profiler).  The table goes to chiprun_out/<fname>."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import dryad_tpu_torch as dt
    from dryad_tpu_torch.config import effective_depth_params
    from dryad_tpu_torch.dataset import binned_to_device
    from dryad_tpu_torch.engine.goss import goss_columns
    from dryad_tpu_torch.engine.grower import grow_any
    from dryad_tpu_torch.engine.loop_state import sample_masks
    from dryad_tpu_torch.engine.train import class_grads, feature_kinds
    from dryad_tpu_torch.objectives import get_objective

    B = ds.mapper.total_bins
    p = effective_depth_params(dt.Params.from_dict(params), ds.num_features,
                               B, ds.num_rows)
    obj = get_objective(p)
    K = p.num_outputs
    Xb = binned_to_device(ds.X_binned, dev)
    y = torch.from_numpy(ds.y).to(dev)
    init = torch.tensor(obj.init_score(ds.y), dtype=torch.float32,
                        device=dev).reshape(1, K)
    cols = class_grads(obj, init.expand(ds.num_rows, K).clone(), y, None)
    row_mask, feat_mask = sample_masks(p, 0, ds.num_rows, ds.num_features)
    bag = (torch.ones(ds.num_rows, dtype=torch.bool, device=dev)
           if row_mask is None else torch.from_numpy(row_mask).to(dev))
    fmask = (torch.ones(ds.num_features, dtype=torch.bool, device=dev)
             if feat_mask is None else torch.from_numpy(feat_mask).to(dev))
    if p.boosting == "goss":
        # iteration 0's selection replaces the bag, as in the loop
        cols, bag = goss_columns(p, 0, cols, bag)

    is_cat_feat, bundled_mask = feature_kinds(ds.mapper, ds.has_missing,
                                              dev)

    def tree():
        for g, h in cols:
            grow_any(p, B, Xb, g, h, bag, fmask,
                     learn_missing=ds.has_missing, is_cat_feat=is_cat_feat,
                     bundled_mask=bundled_mask)
        torch.cuda.synchronize()

    tree()
    t0 = time.perf_counter()
    for _ in range(3):
        tree()
    wall_ms = (time.perf_counter() - t0) / 3 * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        tree()

    # one aggregation (each takes seconds at these event counts); kernels
    # only in the busy time: op-level events carry their kernels' time again
    avgs = prof.key_averages(group_by_input_shape=True)
    kernels = kernel_rows(avgs)
    total_us = sum(us for _, us, _ in kernels)
    ops = [e for e in avgs
           if e.device_type == torch.autograd.DeviceType.CPU and dev_us(e) > 0]
    with open(os.path.join(OUT, fname), "w") as f:
        f.write(avgs.table(sort_by="self_cuda_time_total", row_limit=80))
    del Xb, y, cols
    if total_us <= 0:
        return {"iteration_wall_ms": wall_ms, "device_ms": "not measured"}
    top_k = sorted(kernels, key=lambda r: r[1], reverse=True)[:10]
    top_o = sorted(ops, key=dev_us, reverse=True)[:10]
    return {"iteration_wall_ms": wall_ms, "trees": K,
            "device_ms": total_us / 1e3,
            "busy_share": total_us / 1e3 / wall_ms,
            "kernels": [[key[:60], us / 1e3, n] for key, us, n in top_k],
            "ops": [[e.key, str(e.input_shapes)[:80], dev_us(e) / 1e3,
                     e.count] for e in top_o]}


# (X, mapper bytes) -> X's bins: ``predict_rows`` bins each held-out set
# once per mapper, not once per predict
_BINNED: list = []


def predict_rows(booster, X, **kw):
    """``dt.predict(booster, X, **kw)``: the same bins through the
    booster's frozen mapper and the same ``predict_binned``, with X's bins
    kept for the next call on the same rows and mapper (binning 1M raw
    Higgs rows takes seconds of host time, and the phases predict those
    rows dozens of times)."""
    import numpy as np

    key = booster.mapper.to_bytes()
    for x, k, xb in _BINNED:
        if x is X and k == key:
            break
    else:
        xb = booster.mapper.transform(np.asarray(X, np.float32))
        _BINNED.append((X, key, xb))
        del _BINNED[:-4]
    return booster.predict_binned(xb, **kw)


def train_counted(dt, params, ds, dev):
    """One main-path training run with every launch count set to 0 just
    before it; returns (booster, counts read just after, peak bytes)."""
    import torch

    from dryad_tpu_torch.engine import cuda_build

    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_counts()
    booster = dt.train(params, ds, device=dev)
    launches = dict(cuda_build.counts)
    return booster, launches, torch.cuda.max_memory_allocated()


def legacy_calls(n_rows: int, n_features: int, depth: int,
                 leaves: int) -> tuple[int, int]:
    """(K3, K1 row-mode) launches of one legacy tree of u8 bins: K3 for the
    narrow phase when the natural-order gate admits the matrix, K1 row mode
    for the root and every other level."""
    from dryad_tpu_torch.engine import hist_nat
    from dryad_tpu_torch.engine.levelwise import phase_plan

    nat_live = hist_nat.nat_gate_admits(n_rows, n_features, 1)
    d_switch, p_narrow, _ = phase_plan(depth, min(leaves, 2 ** depth),
                                       nat_live)
    n_nat = d_switch if nat_live and p_narrow <= hist_nat.NAT_SLOTS else 0
    return n_nat, 1 + depth - n_nat


def check_launches(launches: dict, want: dict, what: str) -> None:
    for k, n in launches.items():
        check(n == want.get(k, 0),
              f"{what}: {k} launched {n} times, want {want.get(k, 0)}")


def same_trees(a, b, what: str) -> None:
    import numpy as np

    ra, rb = a.tree_arrays(), b.tree_arrays()
    for k in ra:
        check(np.array_equal(ra[k], rb[k]),
              f"{what}: second run differs in {k!r}")


def tree_summary(booster) -> dict:
    """Time of the first iteration, and the mean of the others; trees/s
    counts the K trees of each iteration (equal to iterations/s at K=1)."""
    ts = booster.tree_seconds
    rest = ts[1:] or ts
    mean = sum(rest) / len(rest)
    return {"first_iteration_s": ts[0], "mean_iteration_s": mean,
            "iterations_per_s": 1.0 / mean,
            "trees_per_s": booster.num_outputs / mean}


def train_and_check(dt, params, ds, Xv, yv, dev, want: dict,
                    what: str) -> tuple:
    """A path's main-path run: launch counts (set to 0 just before it), a
    second run bitwise equal, card predict finite and bitwise equal to CPU
    predict, AUC above 0.70 and rising.  Returns (booster, report)."""
    import numpy as np

    from dryad_tpu_torch.metrics import auc

    booster, launches, peak = train_counted(dt, params, ds, dev)
    raw_gpu = predict_rows(booster, Xv, raw_score=True, device=dev)
    check_launches(launches, want, what)
    same_trees(booster, dt.train(params, ds, device=dev), what)
    check(raw_gpu.shape == (len(yv),) and bool(np.isfinite(raw_gpu).all()),
          f"{what}: predict shape or finiteness")
    check(np.array_equal(raw_gpu, predict_rows(booster, Xv, raw_score=True,
                                             device="cpu")),
          f"{what}: card predict != CPU predict")
    auc1 = auc(yv, predict_rows(booster, Xv, num_iteration=1, device=dev))
    auc_last = auc(yv, predict_rows(booster, Xv, device=dev))
    check(auc_last > auc1, f"{what}: AUC did not rise")
    check(auc_last > 0.70, f"{what}: AUC {auc_last} <= 0.70")
    rep = dict(tree_summary(booster), peak_bytes=peak, launches=launches,
               auc={"tree_1": auc1, "last": auc_last},
               effective_max_depth=booster.params.max_depth,
               splits_per_tree=float((booster.arrays["feature"] >= 0)
                                     .sum(1).mean()))
    print(f"{what} train: " + json.dumps(rep), flush=True)
    print(f"{what}: second run bitwise equal; card predict bitwise equal to "
          "CPU", flush=True)
    return booster, rep


def phase_wired(dt, a, ds, Xv, yv, dev, report) -> tuple:
    """Phases 3-6: the wired path at the headline config."""
    import torch

    from dryad_tpu_torch.engine import hist, leafperm

    params = {"objective": "binary", "growth": "depthwise", "max_depth": 8,
              "num_leaves": 255, "max_bins": 256, "learning_rate": 0.1,
              "num_trees": a.trees}
    calls = capture(dt, params, ds, dev,
                    {"hist": (hist, "hist_tiles"),
                     "perm": (leafperm, "permute_records")})
    check(len(calls["hist"]) == 9 and len(calls["perm"]) == 8,
          f"wired capture tree made {len(calls['hist'])} histogram calls "
          f"and {len(calls['perm'])} row moves")
    root = check_hist(calls["hist"][0][0], "hist root", a.reps,
                      acc_only=True)
    print("K1 root: " + json.dumps(root), flush=True)
    level = check_hist(calls["hist"][-1][0], "hist level", a.reps,
                       acc_only=True)
    print("K1 level: " + json.dumps(level), flush=True)
    perm = check_perm(calls["perm"][4][0], a.reps)
    print("K2 depth-4 move: " + json.dumps(perm), flush=True)
    del calls
    torch.cuda.empty_cache()
    report.update(hist_root=root, hist_level=level, perm=perm)

    booster, rep = train_and_check(dt, params, ds, Xv, yv, dev,
                                   {"hist": 9 * a.trees,
                                    "perm": 8 * a.trees}, "wired")
    report["train"] = rep

    prof = profile_tree(params, ds, dev, "profile.txt")
    print("wired profile: " + json.dumps(prof), flush=True)
    report["profile"] = prof
    return params, booster, rep["launches"], level


def phase_audit(ds, dev, params, first_tree, report) -> dict:
    """Phase 40: the audit on the card (module doc)."""
    import warnings

    import numpy as np
    import torch

    from dryad_tpu_torch.analysis import census as ce
    from dryad_tpu_torch.engine import cuda_build, hist, leafperm

    t0 = time.perf_counter()
    # the sync count rests on the debug mode warning at each host sync
    x = torch.arange(16, device=dev)
    for name, fn in (("item", lambda: x.sum().item()),
                     ("tolist", lambda: x.tolist()),
                     ("cpu", lambda: x.cpu())):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        n = sum(ce.SYNC_WARNING in str(m.message) for m in w)
        check(n == 1, f"audit: sync debug mode gave {n} sync warnings for "
              f".{name}() (want 1)")
    # one headline tree under the census, K1's root and K2's depth-4 move
    # captured for the plain-version checks
    seen: dict = {"hist": [], "perm": []}
    real = (hist.hist_tiles, leafperm.permute_records)

    def spy_hist(*args, **kw):
        if not seen["hist"]:
            seen["hist"].append(args)
        return real[0](*args, **kw)

    def spy_perm(*args, **kw):
        seen["perm"].append(args if len(seen["perm"]) == 4 else None)
        return real[1](*args, **kw)

    check({k: v for k, v in params.items() if k != "num_trees"}
          == ce.HEADLINE_PARAMS,
          f"audit: phase 4's config {params} is not the census's headline "
          f"config {ce.HEADLINE_PARAMS}")
    hist.hist_tiles, leafperm.permute_records = spy_hist, spy_perm
    cuda_build.reset_counts()
    try:
        booster, cen, bad = ce.census_headline(ds, device=dev)
    finally:
        hist.hist_tiles, leafperm.permute_records = real
    launches = dict(cuda_build.counts)
    check(not bad, f"audit: headline tree invariants: {bad}")
    check(dict(cen.kernels) == {"hist_tiles": 9, "permute_records": 8},
          f"audit: headline tree kernel events {dict(cen.kernels)}")
    check(launches["hist"] == 9 and launches["perm"] == 8,
          f"audit: headline tree launches {launches}")
    for kname in ("hist_tiles", "permute_records"):
        for sig in cen.kernel_sigs[kname]:
            check(sig.startswith("(uint8(") and ", 128)," in sig,
                  f"audit: {kname} records are not uint8 x 128: {sig}")
    check(cen.row_sorts == 0, f"audit: {cen.row_sorts} row-scale sorts")
    check(not cen.collectives, f"audit: collectives {cen.collectives}")
    golden = ce.card_headline()
    check(golden is not None, "audit: no card golden for the headline tree")
    check(cen.syncs == golden["syncs"],
          f"audit: headline tree host syncs {cen.syncs} != card golden "
          f"{golden['syncs']}")
    mine = booster.tree_arrays()
    for k, v in mine.items():
        check(np.array_equal(v[0], first_tree[k][0]),
              f"audit: the censused tree differs from phase 4's in {k!r}")
    root = check_hist(seen["hist"][0], "audit K1 root", 3)
    perm = check_perm(seen["perm"][4], 3)
    del seen
    # the single-process small arms on the card
    arms = [n for n in ce.ARMS if ce.ARMS[n][2] != "group"]
    rep = ce.run_census(arm_names=arms, device="cuda")
    for arm in rep.arms:
        check(arm.ok, f"audit: arm {arm.name} on the card: {arm.failures}")
    check(rep.drift_ok, f"audit: {rep.drift}")
    out = {"headline": {"kernels": dict(cen.kernels),
                        "row_sorts": cen.row_sorts,
                        "slot_sorts": cen.slot_sorts,
                        "collectives": dict(cen.collectives),
                        "syncs": cen.syncs, "ops": len(cen.stream),
                        "digest": cen.digest},
           "k1_root": brief(root), "k2_move": brief(perm),
           "arms": {arm.name: {"kernels": dict(arm.census.kernels),
                               "row_sorts": arm.census.row_sorts,
                               "collectives": dict(arm.census.collectives),
                               "syncs": arm.census.syncs}
                    for arm in rep.arms},
           "digest_notes": rep.notes,
           "seconds": time.perf_counter() - t0, "card": smi_line()}
    print("audit: " + json.dumps(out), flush=True)
    report["audit"] = out
    return launches


def phase_fixture(dt, dev, report) -> None:
    """Phase 7: wired against legacy on the card, tie-free fixture."""
    import numpy as np

    from dryad_tpu_torch import datasets

    X, y = datasets.higgs_like(50_000, seed=43)
    ds = dt.Dataset(X, y, max_bins=64)
    base = {"objective": "binary", "num_trees": 4, "num_leaves": 128,
            "max_bins": 64, "growth": "depthwise", "max_depth": 8}
    b_w = dt.train(base, ds, device=dev)
    b_l = dt.train(dict(base, deep_layout="legacy"), ds, device=dev)
    for k in ("feature", "threshold", "left", "right"):
        check(np.array_equal(b_w.tree_arrays()[k], b_l.tree_arrays()[k]),
              f"wired vs legacy fixture: {k!r} differs")
    dv = float(np.abs(b_w.arrays["value"] - b_l.arrays["value"]).max())
    check(dv <= 1e-5, f"wired vs legacy fixture: values differ by {dv}")
    print(f"wired vs legacy fixture: equal trees (max value diff {dv})",
          flush=True)
    report["fixture"] = {"max_value_diff": dv}


def phase_legacy(dt, a, ds, Xv, yv, dev, wired_params, wired_booster,
                 report) -> tuple:
    """Phases 8-9: the legacy plan arm at the headline config."""
    import torch

    from dryad_tpu_torch.engine import hist, hist_nat

    params = dict(wired_params, deep_layout="legacy")
    n_nat, n_rows = legacy_calls(ds.num_rows, ds.num_features, 8, 255)
    check((n_nat, n_rows) == (5, 4), "the Higgs matrix left the K3 gate")
    calls = capture(dt, params, ds, dev,
                    {"rows": (hist, "hist_rows"),
                     "nat": (hist_nat, "build_hist_nat")})
    check(len(calls["rows"]) == n_rows and len(calls["nat"]) == n_nat,
          f"legacy capture tree made {len(calls['rows'])} row-mode and "
          f"{len(calls['nat'])} natural-order calls")
    nat = check_nat(calls["nat"][4], "nat level 4", a.reps, acc_only=True)
    print("K3 level 4: " + json.dumps(nat), flush=True)
    rows = check_rows(calls["rows"][-1][0], "hist rows level 7", a.reps,
                      acc_only=True)
    print("K1 rows level 7: " + json.dumps(rows), flush=True)
    del calls
    torch.cuda.empty_cache()
    report.update(nat_level=nat, rows_level=rows)

    booster, rep = train_and_check(dt, params, ds, Xv, yv, dev,
                                   {"nat": n_nat * a.trees,
                                    "hist_rows": n_rows * a.trees}, "legacy")
    w0, l0 = wired_booster.tree_arrays(), booster.tree_arrays()
    differ = int(((w0["feature"][0] != l0["feature"][0])
                  | (w0["threshold"][0] != l0["threshold"][0])).sum())
    check(differ == 0, f"legacy: {differ} tree-1 nodes differ from the wired "
          "run's tree 1")
    rep["tree1_nodes_differing_from_wired"] = differ
    prof = profile_tree(params, ds, dev, "profile_legacy.txt")
    print("legacy profile: " + json.dumps(prof), flush=True)
    rep["profile"] = prof
    report["legacy"] = rep
    return rep["launches"], nat, rows


def selection_cost(args, params, ds, dev) -> dict:
    """The leaf-wise selection replay (``leafwise_fast.select_tree``) alone
    on a captured tree's heap tables, against whole trees of the same
    config timed in the same window (alternately, 3 each, every call
    ending in a synchronisation): host wall ms of each, the replay's share
    of a tree, and its device ms and kernel launches under
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import dryad_tpu_torch as dt
    from dryad_tpu_torch.config import effective_depth_params
    from dryad_tpu_torch.engine import leafwise_fast
    from dryad_tpu_torch.engine.grower import grow_any
    from dryad_tpu_torch.dataset import binned_to_device
    from dryad_tpu_torch.objectives import get_objective

    B = ds.mapper.total_bins
    p = effective_depth_params(dt.Params.from_dict(params), ds.num_features,
                               B, ds.num_rows)
    obj = get_objective(p)
    Xb = binned_to_device(ds.X_binned, dev)
    y = torch.from_numpy(ds.y).to(dev)
    g, h = obj.grad_hess(torch.full((ds.num_rows,), obj.init_score(ds.y),
                                    dtype=torch.float32, device=dev), y)
    bag = torch.ones(ds.num_rows, dtype=torch.bool, device=dev)
    fmask = torch.ones(ds.num_features, dtype=torch.bool, device=dev)

    def wall_ms(fn):
        t0 = time.perf_counter()
        fn()
        sync()
        return (time.perf_counter() - t0) * 1e3

    def tree():
        grow_any(p, B, Xb, g, h, bag, fmask)

    def select():
        leafwise_fast.select_tree(*args)

    wall_ms(tree)
    wall_ms(select)
    trees, sels = [], []
    for _ in range(3):
        trees.append(wall_ms(tree))
        sels.append(wall_ms(select))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        select()
        sync()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    sel_us = sum(dev_us(e) for e in kernels)
    del Xb, y, g, h
    tree_ms, sel_ms = sum(trees) / 3, sum(sels) / 3
    return {"trips": int(args[0]) - 1, "host_ms": sel_ms,
            "tree_wall_ms": tree_ms, "share_of_tree_wall": sel_ms / tree_ms,
            "device_ms": sel_us / 1e3 if sel_us > 0 else "not measured",
            "kernel_launches": sum(e.count for e in kernels)}


def leafwise_capture(dt, params, ds, dev, names: dict, what: str,
                     trees: int = 1) -> dict:
    """One capture iteration (``trees`` trees) of a leaf-wise
    configuration, with the batched grower and the sequential one watched:
    the batched grower must run once per tree and the sequential one
    never."""
    from dryad_tpu_torch.engine import grower, leafwise_fast

    calls = capture(dt, params, ds, dev, dict(
        names, batched=(leafwise_fast, "grow_tree_leafwise_batched"),
        sequential=(grower, "grow_tree"),
        select=(leafwise_fast, "select_tree")))
    check(len(calls["batched"]) == trees and not calls["sequential"],
          f"{what}: the batched leaf-wise grower was not the one taken")
    return calls


def phase_leafwise_wired(dt, a, ds, Xv, yv, dev, report) -> tuple:
    """Phase 10: leaf-wise growth on the wired arm at max_depth 8."""
    import torch

    from dryad_tpu_torch.config import (
        effective_depth_params,
        leafwise_fast_supported,
    )
    from dryad_tpu_torch.engine import hist, leafperm, leafwise_fast

    params = {"objective": "binary", "growth": "leafwise", "max_depth": 8,
              "num_leaves": 255, "max_bins": 256, "learning_rate": 0.1,
              "num_trees": a.trees}
    F, B, N = ds.num_features, ds.mapper.total_bins, ds.num_rows
    p = effective_depth_params(dt.Params.from_dict(params), F, B, N)
    check(p.max_depth == 8 and leafwise_fast_supported(p, F, B, N)
          and leafwise_fast.leafwise_layout_supported(p, F, B, 1),
          "leaf-wise depth 8: not the batched grower on the wired arm")
    calls = leafwise_capture(dt, params, ds, dev,
                             {"hist": (hist, "hist_tiles"),
                              "perm": (leafperm, "permute_records")},
                             "leaf-wise wired")
    check(len(calls["hist"]) == 9 and len(calls["perm"]) == 8,
          f"leaf-wise wired capture tree made {len(calls['hist'])} "
          f"histogram calls and {len(calls['perm'])} row moves")
    level = check_hist(calls["hist"][-1][0], "leaf-wise hist level 7",
                       a.reps)
    check(level["P"] == 128, f"leaf-wise widest level P={level['P']}")
    print("K1 leaf-wise level 7: " + json.dumps(level), flush=True)
    perm = check_perm(calls["perm"][4][0], a.reps)
    print("K2 leaf-wise level 4: " + json.dumps(perm), flush=True)
    select_args = calls["select"][0][0]
    del calls
    torch.cuda.empty_cache()

    _, rep = train_and_check(dt, params, ds, Xv, yv, dev,
                             {"hist": 9 * a.trees, "perm": 8 * a.trees},
                             "leaf-wise wired")
    rep["profile"] = profile_tree(params, ds, dev, "profile_leafwise.txt")
    print("leaf-wise wired profile: " + json.dumps(rep["profile"]),
          flush=True)
    rep["selection"] = selection_cost(select_args, params, ds, dev)
    print("leaf-wise selection replay: " + json.dumps(rep["selection"]),
          flush=True)
    rep.update(hist_level=level, perm=perm)
    report["leafwise_wired"] = rep
    return rep["launches"], level, perm


def phase_leafwise_default(dt, a, ds, Xv, yv, dev, report) -> tuple:
    """Phase 11: leaf-wise at the reference's default max_depth=-1."""
    import torch

    from dryad_tpu_torch.config import (
        effective_depth_params,
        leafwise_fast_supported,
    )
    from dryad_tpu_torch.engine import hist, hist_nat, leafwise_fast

    params = {"objective": "binary", "growth": "leafwise", "num_leaves": 255,
              "max_bins": 256, "learning_rate": 0.1, "num_trees": a.trees}
    F, B, N = ds.num_features, ds.mapper.total_bins, ds.num_rows
    p = effective_depth_params(dt.Params.from_dict(params), F, B, N)
    check(p.max_depth == 12 and leafwise_fast_supported(p, F, B, N)
          and not leafwise_fast.leafwise_layout_supported(p, F, B, 1),
          f"leaf-wise default: effective depth {p.max_depth}, not the "
          "batched grower's legacy arm at 12")
    check(hist_nat.nat_gate_admits(N, F, 1), "the Higgs matrix left the "
          "K3 gate")
    calls = leafwise_capture(dt, params, ds, dev,
                             {"rows": (hist, "hist_rows"),
                              "nat": (hist_nat, "build_hist_nat")},
                             "leaf-wise default")
    check(len(calls["rows"]) == 9 and len(calls["nat"]) == 4,
          f"leaf-wise default capture tree made {len(calls['rows'])} "
          f"row-mode and {len(calls['nat'])} natural-order calls")
    nat = check_nat(calls["nat"][3], "leaf-wise nat level 3", a.reps)
    check(nat["P"] == 8, f"leaf-wise K3 P={nat['P']}")
    print("K3 leaf-wise level 3: " + json.dumps(nat), flush=True)
    rows = check_rows(calls["rows"][-1][0], "leaf-wise rows level 11",
                      a.reps)
    check(rows["P"] == 2048, f"leaf-wise K1 row mode P={rows['P']}")
    print("K1 rows leaf-wise level 11: " + json.dumps(rows), flush=True)
    select_args = calls["select"][0][0]
    del calls
    torch.cuda.empty_cache()

    _, rep = train_and_check(dt, params, ds, Xv, yv, dev,
                             {"nat": 4 * a.trees, "hist_rows": 9 * a.trees},
                             "leaf-wise default")
    rep["profile"] = profile_tree(params, ds, dev,
                                  "profile_leafwise_default.txt")
    print("leaf-wise default profile: " + json.dumps(rep["profile"]),
          flush=True)
    rep["selection"] = selection_cost(select_args, params, ds, dev)
    print("leaf-wise default selection replay: "
          + json.dumps(rep["selection"]), flush=True)
    rep.update(nat_level=nat, rows_level=rows)
    report["leafwise_default"] = rep
    return rep["launches"], nat, rows


def phase_leafwise_fixture(dt, dev, report) -> None:
    """Phase 12: the leaf-wise fixture: wired vs legacy, batched vs
    sequential, and the reference's defaults."""
    import numpy as np
    import torch

    from dryad_tpu_torch import datasets
    from dryad_tpu_torch.engine import grower, leafwise_fast
    from dryad_tpu_torch.objectives import Binary

    X, y = datasets.higgs_like(50_000, seed=43)
    ds = dt.Dataset(X, y, max_bins=64)
    base = {"objective": "binary", "num_trees": 4, "num_leaves": 128,
            "max_bins": 64, "growth": "leafwise", "max_depth": 8}
    b_w = dt.train(base, ds, device=dev)
    b_l = dt.train(dict(base, deep_layout="legacy"), ds, device=dev)
    for k in ("feature", "threshold", "left", "right", "default_left"):
        check(np.array_equal(b_w.tree_arrays()[k], b_l.tree_arrays()[k]),
              f"leaf-wise fixture, wired vs legacy: {k!r} differs")
    dv = float(np.abs(b_w.arrays["value"] - b_l.arrays["value"]).max())
    check(dv <= 1e-5, f"leaf-wise fixture, wired vs legacy: values differ "
          f"by {dv}")

    p = dt.Params.from_dict(base)
    B, F = ds.mapper.total_bins, ds.num_features
    yt = torch.from_numpy(ds.y).to(dev)
    g, h = Binary().grad_hess(
        torch.full_like(yt, float(Binary().init_score(ds.y))), yt)
    args = (p, B, torch.from_numpy(ds.X_binned).to(dev), g, h,
            torch.ones(ds.num_rows, dtype=torch.bool, device=dev),
            torch.ones(F, dtype=torch.bool, device=dev))
    bat = leafwise_fast.grow_tree_leafwise_batched(*args)
    seq = grower.grow_tree(*args)
    for k in ("feature", "threshold", "left", "right", "default_left",
              "row_leaf", "max_depth"):
        check(torch.equal(bat[k], seq[k]),
              f"leaf-wise fixture, batched vs sequential: {k!r} differs")
    check(torch.equal(bat["value"], seq["value"])
          and torch.equal(bat["cover"], seq["cover"]),
          "leaf-wise fixture, batched vs sequential: values or covers "
          "differ")
    n_split = int((bat["feature"] >= 0).sum())

    b_d = dt.train({"objective": "binary", "num_trees": 3}, ds, device=dev)
    splits = (b_d.arrays["feature"] >= 0).sum(1)
    check(b_d.params.max_depth == 9 and b_d.params.growth == "leafwise"
          and leafwise_fast.leafwise_layout_supported(b_d.params, F, B, 1),
          f"reference defaults: max_depth {b_d.params.max_depth}, not the "
          "wired arm at 9")
    check(bool((splits == 30).all()), f"reference defaults: {splits} "
          "splits per tree, want 30 (31 leaves)")
    rep = {"wired_vs_legacy_max_value_diff": dv,
           "batched_vs_sequential": "bitwise equal",
           "splits_tree_1": n_split,
           "defaults": {"max_depth": b_d.params.max_depth,
                        "splits_per_tree": splits.tolist()}}
    print("leaf-wise fixture: " + json.dumps(rep), flush=True)
    report["leafwise_fixture"] = rep


BAGGED = {"objective": "binary", "growth": "depthwise", "max_depth": 8,
          "num_leaves": 255, "max_bins": 256, "learning_rate": 0.1,
          "subsample": 0.8, "colsample": 0.8, "seed": 0, "metric": "auc",
          "early_stopping_rounds": 5}


def record_hashes(rec):
    """Sorted 64-bit hashes of the records whose flag (byte 8) is set: two
    multisets of records are equal when these are."""
    import torch

    keep = rec[:, 8] == 1
    words = rec[keep].contiguous().view(torch.int64)
    mult = torch.tensor(
        [(0x9E3779B97F4A7C15 * (2 * i + 1)) % (1 << 63) | 1
         for i in range(words.shape[1])], dtype=torch.int64,
        device=rec.device)
    return torch.sort((words * mult).sum(1)).values


def check_bag_move(args, bag_rows: int) -> None:
    """Level 0's row move under a partial bag: every in-bag record is in
    the output exactly once, and no out-of-bag record is (every written
    row carries the flag)."""
    import torch

    from dryad_tpu_torch.engine import leafperm

    rec = args[0]
    check(int((rec[:, 8] == 1).sum()) == bag_rows,
          "bagged level 0: the input's flags are not the bag")
    out = leafperm.permute_records(*args)
    written = out.ne(0).any(1)
    check(bool((out[written, 8] == 1).all()),
          "bagged level 0: an out-of-bag record was moved")
    n_out = int(written.sum())
    check(n_out == bag_rows,
          f"bagged level 0: {n_out} records out, {bag_rows} in the bag")
    check(torch.equal(record_hashes(rec), record_hashes(out)),
          "bagged level 0: the moved records are not the in-bag records")


def profile_train(dt, params, ds, dv, dev, fname: str) -> dict:
    """Three iterations of the boosting loop (valid set ``dv`` or none,
    early stopping and a callback when ``dv`` is given) under
    torch.profiler, after a warm run: device time by op and kernel, and
    the device's busy share of the loop's wall time (``tree_seconds``, so
    set-up is outside it).  The table goes to chiprun_out/<fname>."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    params = dict(params, num_trees=3)
    valid = [dv] if dv is not None else None

    def run():
        return dt.train(params, ds, valid, device=dev,
                        callback=(lambda it, info: None) if dv else None)

    run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        b = run()

    avgs = prof.key_averages()          # once: it takes seconds
    kernels = [e for e in avgs
               if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = [e for e in avgs
           if e.device_type == torch.autograd.DeviceType.CPU and dev_us(e) > 0]
    with open(os.path.join(OUT, fname), "w") as f:
        f.write(avgs.table(sort_by="self_cuda_time_total", row_limit=60))
    loop_ms = sum(b.tree_seconds) * 1e3
    total_us = sum(dev_us(e) for e in kernels)
    if total_us <= 0:
        return {"loop_wall_ms_3_trees": loop_ms, "device_ms": "not measured"}
    return {"loop_wall_ms_3_trees": loop_ms,
            "device_ms_incl_setup": total_us / 1e3,
            "ops": [[e.key[:50], dev_us(e) / 1e3, e.count]
                    for e in sorted(ops, key=dev_us, reverse=True)[:12]]}


def valid_path_costs(dt, booster, ds, dv, dev, reps: int) -> dict:
    """The costs the valid set adds to an iteration, alone: the new tree's
    packing and traversal over the valid rows (device ms), the device AUC
    (device ms), one eval fetch (host ms), and the host's Philox bag draw
    of one iteration at the training set's rows (host ms, paid with or
    without a valid set)."""
    import torch

    from dryad_tpu_torch.engine.loop_state import sample_masks
    from dryad_tpu_torch.engine.predict import add_tree, pack_words
    from dryad_tpu_torch.dataset import binned_to_device
    from dryad_tpu_torch.metrics.device import make_evaluator

    t = booster.num_iterations - 1
    arr = {k: torch.from_numpy(v[t]).to(dev)
           for k, v in booster.arrays.items()}
    vXb = binned_to_device(dv.X_binned, dev)
    vs = torch.zeros(dv.num_rows, dtype=torch.float32, device=dev)
    depth = booster.params.max_depth

    def traverse():
        words = pack_words(arr["feature"], arr["threshold"], arr["left"],
                           arr["right"], arr["default_left"])
        return add_tree(words, arr["value"], vXb, vs, depth)

    traverse_ms = time_ms(traverse, reps)
    _, _, fn = make_evaluator("binary", "auc", dv, dev)
    vs = traverse()
    auc_ms = time_ms(lambda: fn(vs), reps)
    fetch = []
    for _ in range(3):
        v = fn(vs)
        sync()
        t0 = time.perf_counter()
        torch.stack([v]).cpu()
        fetch.append((time.perf_counter() - t0) * 1e3)
    p = booster.params
    draw = []
    for it in range(3):
        t0 = time.perf_counter()
        sample_masks(p, it, ds.num_rows, ds.num_features)
        draw.append((time.perf_counter() - t0) * 1e3)
    del vXb, vs
    return {"traverse_ms": traverse_ms, "auc_device_ms": auc_ms,
            "fetch_host_ms": sum(fetch) / 3,
            "bag_draw_host_ms": sum(draw) / 3}


def spy_valid_scores(engine_train, K: int) -> tuple:
    """Wrap the loop's ``add_tree`` to keep the last K valid-score
    columns it returns (the last iteration's K class columns); returns
    (kept list, restore function)."""
    kept: list = []
    real = engine_train.add_tree

    def spy(*args):
        out = real(*args)
        kept.append(out)
        del kept[:-K]
        return out

    engine_train.add_tree = spy

    def restore():
        engine_train.add_tree = real

    return kept, restore


def phase_bagged(dt, a, ds, Xv, yv, dev, report) -> tuple:
    """Phase 13: Higgs-10M bagged and validated, depthwise wired."""
    import numpy as np
    import torch

    from dryad_tpu_torch.engine import hist, leafperm
    from dryad_tpu_torch.engine import train as engine_train
    from dryad_tpu_torch.engine.loop_state import sample_masks
    from dryad_tpu_torch.metrics import auc
    from dryad_tpu_torch.metrics.device import auc_device

    params = dict(BAGGED, num_trees=a.bag_trees)
    t0 = time.perf_counter()
    dv = ds.bind(Xv, yv)
    bind_s = time.perf_counter() - t0
    calls = capture(dt, params, ds, dev,
                    {"hist": (hist, "hist_tiles"),
                     "perm": (leafperm, "permute_records")})
    check(len(calls["hist"]) == 9 and len(calls["perm"]) == 8,
          f"bagged capture tree made {len(calls['hist'])} histogram calls "
          f"and {len(calls['perm'])} row moves")
    bag_rows = int(np.count_nonzero(sample_masks(
        dt.Params.from_dict(params), 0, ds.num_rows, ds.num_features)[0]))
    root_args = calls["hist"][0][0]
    root = check_hist(root_args, "bagged hist root", a.reps)
    n_root = int(hist.hist_tiles(*root_args)[0, 2, 0].sum())
    check(root["P"] == 1 and n_root == bag_rows,
          f"bagged root: P={root['P']}, {n_root} rows counted, "
          f"{bag_rows} in the bag")
    print("K1 bagged root: " + json.dumps(root), flush=True)
    check_bag_move(calls["perm"][0][0], bag_rows)
    perm0 = check_perm(calls["perm"][0][0], a.reps)
    perm0.update(in_bag_rows=bag_rows,
                 out_of_bag_rows=ds.num_rows - bag_rows)
    print("K2 bagged level 0: " + json.dumps(perm0), flush=True)
    del calls
    torch.cuda.empty_cache()

    # the main path: bagged, validated, early stopping on the card's AUC;
    # the trainer's running valid scores are read through add_tree
    infos = []
    kept, restore = spy_valid_scores(engine_train, 1)
    try:
        torch.cuda.reset_peak_memory_stats()
        from dryad_tpu_torch.engine import cuda_build

        cuda_build.reset_counts()
        booster = dt.train(params, ds, [dv], device=dev,
                           callback=lambda it, info: infos.append(info))
        launches = dict(cuda_build.counts)
        peak = torch.cuda.max_memory_allocated()
    finally:
        restore()
    n = booster.num_iterations
    check_launches(launches, {"hist": 9 * n, "perm": 8 * n}, "bagged")
    curve = [i["valid_auc"] for i in infos]
    check(len(curve) == n, "bagged: not every iteration was evaluated")
    again = []
    b2 = dt.train(params, ds, [dv], device=dev,
                  callback=lambda it, info: again.append(info))
    same_trees(booster, b2, "bagged")
    check(again == infos and b2.best_iteration == booster.best_iteration,
          "bagged: a second run's evals or best iteration differ")
    raw = predict_rows(booster, Xv, raw_score=True, num_iteration=n,
                     device=dev)
    check(np.array_equal(kept[-1].cpu().numpy(), raw),
          "bagged: the trainer's valid scores differ from predict's")
    host_auc = auc(yv, raw)
    check(abs(curve[-1] - host_auc) <= 1e-5,
          f"bagged: last valid_auc {curve[-1]} vs host AUC {host_auc}")
    check(curve[-1] > curve[0] and curve[-1] > 0.70,
          f"bagged: AUC {curve[0]} -> {curve[-1]}")
    y_dev = torch.from_numpy(yv).to(dev)
    eval_ms = time_ms(lambda: auc_device(y_dev, kept[-1]), a.reps)
    del kept, y_dev
    plain = dict(params, early_stopping_rounds=0)
    no_valid = dt.train(plain, ds, device=dev)
    costs = valid_path_costs(dt, booster, ds, dv, dev, a.reps)
    print("bagged valid-path costs: " + json.dumps(costs), flush=True)
    prof = {"with_valid": profile_train(dt, params, ds, dv, dev,
                                        "profile_bagged_valid.txt"),
            "without_valid": profile_train(dt, plain, ds, None, dev,
                                           "profile_bagged.txt"),
            "tree": profile_tree(params, ds, dev, "profile_bagged_tree.txt")}
    print("bagged profiles: " + json.dumps(prof), flush=True)
    rep = {"with_valid": tree_summary(booster),
           "without_valid": tree_summary(no_valid),
           "valid_path": costs, "profile": prof,
           "auc_device_ms_1M": eval_ms, "peak_bytes": peak,
           "launches": launches, "trees": n,
           "best_iteration": booster.best_iteration,
           "auc": {"tree_1": curve[0], "last": curve[-1],
                   "host_last": host_auc}, "bind_seconds": bind_s,
           "hist_root": root, "perm_level0": perm0}
    print("bagged train: " + json.dumps(
        {k: v for k, v in rep.items() if k not in ("hist_root",
                                                   "perm_level0",
                                                   "profile")}),
          flush=True)
    print("bagged: second run bitwise equal; valid scores bitwise equal to "
          "predict; last valid_auc matches the host AUC", flush=True)
    report["bagged"] = rep
    return params, dv, launches, root, perm0


def phase_resume(dt, ds, dv, Xv, dev, params, report) -> dict:
    """Phase 14: checkpoint/resume on the card, the bagged config."""
    import tempfile

    import numpy as np

    from dryad_tpu_torch.checkpoint import Checkpointer
    from dryad_tpu_torch.engine import cuda_build

    class Crash(RuntimeError):
        pass

    T, crash_at = 10, 6
    params = dict(params, num_trees=T)
    straight_infos = []
    straight = dt.train(params, ds, [dv], device=dev,
                        callback=lambda it, info: straight_infos.append(info))
    check(straight.num_iterations == T, "resume: the straight run stopped "
          "early")

    def crash(it, info):
        if it == crash_at:
            raise Crash

    with tempfile.TemporaryDirectory(dir=OUT) as ckdir:
        try:
            dt.train(params, ds, [dv], device=dev, checkpoint_dir=ckdir,
                     checkpoint_every=3, callback=crash)
            fail("resume: the crash callback did not stop the run")
        except Crash:
            pass
        check(Checkpointer(ckdir).iterations() == [3, 6],
              "resume: checkpoints are not [3, 6]")
        infos = []
        t0 = time.perf_counter()
        cuda_build.reset_counts()
        resumed = dt.train(params, ds, [dv], device=dev,
                           checkpoint_dir=ckdir, checkpoint_every=3,
                           resume=True,
                           callback=lambda it, info: infos.append(info))
        launches = dict(cuda_build.counts)
        resume_s = time.perf_counter() - t0
        grown = T - crash_at
        check_launches(launches, {"hist": 9 * grown, "perm": 8 * grown},
                       "resume")
        same_trees(straight, resumed, "resume")
        check(infos == straight_infos[crash_at:]
              and resumed.best_iteration == straight.best_iteration,
              "resume: evals or best iteration differ from the straight run")
        raw = predict_rows(straight, Xv, raw_score=True, device=dev)
        check(np.array_equal(predict_rows(resumed, Xv, raw_score=True,
                                        device=dev), raw),
              "resume: predict differs from the straight run")
        path = os.path.join(ckdir, "model.dryad")
        resumed.save(path)
        loaded = dt.Booster.load(path)
        check(np.array_equal(predict_rows(loaded, Xv, raw_score=True,
                                        device=dev), raw),
              "resume: the loaded model file predicts differently")
    rep = {"trees": T, "crash_at": crash_at, "resume_seconds": resume_s,
           "launches": launches, "best_iteration": resumed.best_iteration}
    print("resume: " + json.dumps(rep), flush=True)
    print("resume: trees, evals, best iteration and predict bitwise equal "
          "to the straight run; the saved file predicts bitwise", flush=True)
    report["resume"] = rep
    return launches


def phase_bagged_legacy(dt, a, ds, Xv, yv, dev, report) -> tuple:
    """Phase 15: leaf-wise at the default depth (legacy arm), bagged."""
    import torch

    from dryad_tpu_torch.engine import hist, hist_nat
    from dryad_tpu_torch.engine.loop_state import sample_masks

    params = {"objective": "binary", "growth": "leafwise", "num_leaves": 255,
              "max_bins": 256, "learning_rate": 0.1, "subsample": 0.8,
              "seed": 0, "num_trees": a.bag_legacy_trees}
    calls = leafwise_capture(dt, params, ds, dev,
                             {"rows": (hist, "hist_rows"),
                              "nat": (hist_nat, "build_hist_nat")},
                             "bagged leaf-wise default")
    check(len(calls["rows"]) == 9 and len(calls["nat"]) == 4,
          f"bagged leaf-wise capture tree made {len(calls['rows'])} "
          f"row-mode and {len(calls['nat'])} natural-order calls")
    bag = torch.from_numpy(sample_masks(
        dt.Params.from_dict(params), 0, ds.num_rows,
        ds.num_features)[0]).to(dev)
    sel = calls["nat"][3][0][3]
    check(bool((sel[~bag] >= calls["nat"][3][1]["num_cols"]).all()),
          "bagged K3: an out-of-bag row kept a slot")
    buf = calls["rows"][-1][0][1]
    check(bool(bag[buf[buf < ds.num_rows]].all()),
          "bagged K1 row mode: an out-of-bag row is in the plan")
    nat = check_nat(calls["nat"][3], "bagged nat level 3", a.reps)
    check(nat["P"] == 8, f"bagged K3 P={nat['P']}")
    print("K3 bagged leaf-wise level 3: " + json.dumps(nat), flush=True)
    rows = check_rows(calls["rows"][-1][0], "bagged rows level 11", a.reps)
    check(rows["P"] == 2048, f"bagged K1 row mode P={rows['P']}")
    print("K1 rows bagged leaf-wise level 11: " + json.dumps(rows),
          flush=True)
    del calls
    torch.cuda.empty_cache()
    _, rep = train_and_check(dt, params, ds, Xv, yv, dev,
                             {"nat": 4 * a.bag_legacy_trees,
                              "hist_rows": 9 * a.bag_legacy_trees},
                             "bagged leaf-wise default")
    rep.update(nat_level=nat, rows_level=rows)
    report["bagged_leafwise_default"] = rep
    return rep["launches"], nat, rows



def phase_epsilon(dt, a, dev, report) -> tuple:
    """Phase 16: Epsilon-shaped regression through the legacy arm."""
    import numpy as np
    import torch

    from dryad_tpu_torch import datasets
    from dryad_tpu_torch.engine import hist
    from dryad_tpu_torch.engine.predict import predict_binned
    from dryad_tpu_torch.metrics import rmse

    t0 = time.perf_counter()
    (X, y), t_gen = drawn("epsilon", datasets.epsilon_like,
                          a.eps_rows + a.eps_holdout,
                          num_features=EPS_FEATURES, seed=13)
    ds = dt.Dataset(X[:a.eps_rows], y[:a.eps_rows], max_bins=256)
    Xv_b = ds.mapper.transform(X[a.eps_rows:])
    yv = y[a.eps_rows:]
    del X, y
    t_data = time.perf_counter() - t0
    check(ds.num_features == EPS_FEATURES and ds.mapper.total_bins == 256,
          f"epsilon shape {ds.num_features} x {ds.mapper.total_bins} bins")
    print(f"epsilon data: {a.eps_rows} + {a.eps_holdout} x {EPS_FEATURES}, "
          f"generated in {t_gen:.1f} s, binned by {t_data:.1f} s", flush=True)
    params = {"objective": "regression", "growth": "depthwise",
              "max_depth": 6, "num_leaves": 63, "max_bins": 256,
              "num_trees": a.eps_trees}
    # 300k x 2000 u8 is 600 MB, past the natural-order gate: no K3
    n_nat, n_rows = legacy_calls(ds.num_rows, ds.num_features, 6, 63)
    calls = capture(dt, params, ds, dev, {"rows": (hist, "hist_rows")})
    check(len(calls["rows"]) == n_rows,
          f"epsilon capture tree made {len(calls['rows'])} row-mode calls")
    root = check_rows(calls["rows"][0][0], "eps rows root", a.reps)
    print("K1 rows epsilon root: " + json.dumps(root), flush=True)
    level = check_rows(calls["rows"][-1][0], "eps rows level 5", a.reps)
    print("K1 rows epsilon level 5: " + json.dumps(level), flush=True)
    if a.eps_rows == EPS_ROWS:
        check((n_nat, n_rows) == (0, 7), "the Epsilon matrix passed the K3 "
              "gate")
    del calls
    torch.cuda.empty_cache()

    booster, launches, peak = train_counted(dt, params, ds, dev)
    check_launches(launches, {"hist_rows": n_rows * a.eps_trees,
                              "nat": n_nat * a.eps_trees}, "epsilon")
    same_trees(booster, dt.train(params, ds, device=dev), "epsilon")
    r1 = rmse(yv, predict_binned(booster, Xv_b, device=dev,
                                 num_iteration=1)[:, 0])
    r_last = rmse(yv, predict_binned(booster, Xv_b, device=dev)[:, 0])
    std = float(np.std(yv))
    check(r_last < r1, f"epsilon: RMSE did not fall ({r1} -> {r_last})")
    check(r_last < std, f"epsilon: RMSE {r_last} >= label std {std}")
    rep = dict(tree_summary(booster), peak_bytes=peak, launches=launches,
               rmse={"tree_1": r1, "last": r_last, "label_std": std},
               data_seconds=t_data, gen_seconds=t_gen,
               rows_root=root, rows_level=level)
    print("epsilon train: " + json.dumps(
        {k: v for k, v in rep.items() if not k.startswith("rows_")}),
        flush=True)
    print("epsilon: second run bitwise equal", flush=True)
    prof = profile_tree(params, ds, dev, "profile_epsilon.txt")
    print("epsilon profile: " + json.dumps(prof), flush=True)
    rep["profile"] = prof
    report["epsilon"] = rep
    return launches, root, level, ds, Xv_b, yv


# Covertype's acceptance config (scripts/acceptance.py:61): 7 classes,
# depthwise, max_depth 6, 63 leaves, learning rate 0.1, 256 bins
COVERTYPE = {"objective": "multiclass", "num_class": 7, "growth": "depthwise",
             "max_depth": 6, "num_leaves": 63, "max_bins": 256}


def covertype_data(dt) -> tuple:
    """``covertype_like(581k + 100k, 54, 7, seed=11)``: the first 581k
    rows train (Covertype's size), the rest are held out and bound as the
    valid set."""
    from dryad_tpu_torch import datasets

    t0 = time.perf_counter()
    X, y = datasets.covertype_like(COV_ROWS + COV_HOLDOUT, COV_FEATURES,
                                   COV_CLASSES, seed=11)
    ds = dt.Dataset(X[:COV_ROWS], y[:COV_ROWS], max_bins=256)
    Xv, yv = X[COV_ROWS:], y[COV_ROWS:]
    dv = ds.bind(Xv, yv)
    seconds = time.perf_counter() - t0
    check(ds.num_features == COV_FEATURES and ds.mapper.total_bins == 256,
          f"covertype shape {ds.num_features} x {ds.mapper.total_bins} bins")
    print(f"covertype data: {COV_ROWS} + {COV_HOLDOUT} x {COV_FEATURES}"
          f", {COV_CLASSES} classes, {seconds:.1f} s", flush=True)
    return ds, Xv, yv, dv, seconds


def class_calls(calls: list, K: int, k: int) -> list:
    """The calls of class tree ``k`` in a captured iteration of K trees
    that make the same number of calls each."""
    n = len(calls) // K
    return calls[k * n:(k + 1) * n]


def phase_covertype(dt, a, ds, Xv, yv, dv, dev, report) -> tuple:
    """Phase 17: Covertype multiclass, depthwise wired, valid set."""
    import numpy as np
    import torch

    from dryad_tpu_torch.engine import cuda_build, hist, leafperm
    from dryad_tpu_torch.engine import train as engine_train
    from dryad_tpu_torch.metrics import accuracy, multi_logloss

    K, D = COV_CLASSES, COVERTYPE["max_depth"]
    params = dict(COVERTYPE, num_trees=COV_ITERATIONS)
    # the capture iteration is the second: at the zero init score every
    # class has the same h, so only there do g and h tell the class
    # columns apart; the spy keeps that iteration's columns
    first = dt.train(dict(params, num_trees=1), ds, device=dev)
    real_grads, cols = engine_train.class_grads, []

    def spy_grads(*args, **kw):
        out = real_grads(*args, **kw)
        cols.extend((g.double().sum(), h.double().sum()) for g, h in out)
        return out

    engine_train.class_grads = spy_grads
    try:
        calls = capture(dt, params, ds, dev,
                        {"hist": (hist, "hist_tiles"),
                         "perm": (leafperm, "permute_records")}, init=first)
    finally:
        engine_train.class_grads = real_grads
    del first
    check(len(calls["hist"]) == K * (D + 1) and len(calls["perm"]) == K * D,
          f"covertype capture iteration made {len(calls['hist'])} "
          f"histogram calls and {len(calls['perm'])} row moves")
    # the last class tree: its g/h are column 6 of the (N, 7) pass
    k = K - 1
    hc, pc = (class_calls(calls["hist"], K, k),
              class_calls(calls["perm"], K, k))
    root = check_hist(hc[0][0], "covertype hist root", a.reps)
    level = check_hist(hc[-1][0], "covertype hist level", a.reps)
    check(root["P"] == 1 and level["P"] == 32,
          f"covertype K1 P: root {root['P']}, last level {level['P']}")
    # the root's sums are class k's column, not a strided mix of classes,
    # and lie far from every other class's
    check(len(cols) == K, f"covertype capture: {len(cols)} class columns")
    root_hist = hist.hist_tiles(*hc[0][0])[0].double().sum(-1)[:, 0]
    sums = torch.tensor([[float(g), float(h)] for g, h in cols],
                        dtype=torch.float64, device=dev)
    dist = (root_hist[:2] - sums).abs().amax(1)
    gap = float(torch.cat([dist[:k], dist[k + 1:]]).min())
    check(float(dist[k]) <= 1.0
          and abs(float(root_hist[2]) - ds.num_rows) <= 1.0,
          f"covertype root of class {k}: sums {root_hist} vs its "
          f"column's {sums[k]}")
    check(gap > 100.0, f"covertype root of class {k}: within {gap} of "
          "another class's column")
    root["class_gap"] = gap
    perm = check_perm(pc[3][0], a.reps)
    print("K1 covertype root: " + json.dumps(root), flush=True)
    print("K1 covertype level: " + json.dumps(level), flush=True)
    print("K2 covertype level 3: " + json.dumps(perm), flush=True)
    del calls, hc, pc
    torch.cuda.empty_cache()

    # the main path: COV_ITERATIONS iterations of 7 trees with the held-out
    # valid set
    # scored on the card, evals deferred to the end
    kept, restore = spy_valid_scores(engine_train, K)
    try:
        torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_counts()
        booster = dt.train(params, ds, [dv], device=dev)
        launches = dict(cuda_build.counts)
        peak = torch.cuda.max_memory_allocated()
    finally:
        restore()
    n = booster.num_iterations
    check(n == COV_ITERATIONS and booster.num_total_trees == K * n,
          f"covertype: {booster.num_total_trees} trees in {n} iterations")
    check_launches(launches, {"hist": (D + 1) * K * n, "perm": D * K * n},
                   "covertype")
    vscore = torch.stack(kept, 1).cpu().numpy()
    del kept
    same_trees(booster, dt.train(params, ds, [dv], device=dev),
               "covertype")
    raw = predict_rows(booster, Xv, raw_score=True, device=dev)
    check(raw.shape == (len(yv), K) and bool(np.isfinite(raw).all()),
          f"covertype: predict shape {raw.shape} or finiteness")
    check(np.array_equal(raw, predict_rows(booster, Xv, raw_score=True,
                                         device="cpu")),
          "covertype: card predict != CPU predict")
    check(np.array_equal(vscore, raw),
          "covertype: the trainer's valid scores differ from predict's")
    curve = [v for _, v in
             booster.train_state["eval_history"]["valid_multi_logloss"]]
    check(len(curve) == n and curve[-1] < curve[0],
          f"covertype: multi_logloss {curve[0]} -> {curve[-1]}")
    prob = predict_rows(booster, Xv, device=dev)
    host = multi_logloss(yv, prob)
    check(abs(curve[-1] - host) <= 1e-5,
          f"covertype: last valid_multi_logloss {curve[-1]} vs host {host}")
    acc = accuracy(yv, prob)
    acc1 = accuracy(yv, predict_rows(booster, Xv, num_iteration=1,
                                   device=dev))
    check(acc > 0.55, f"covertype: held-out accuracy {acc} <= 0.55")
    no_valid = tree_summary(dt.train(params, ds, device=dev))
    prof = profile_tree(params, ds, dev, "profile_covertype.txt")
    rep = dict(tree_summary(booster), without_valid=no_valid,
               peak_bytes=peak, launches=launches,
               iterations=n, trees=booster.num_total_trees,
               multi_logloss={"iteration_1": curve[0], "last": curve[-1],
                              "host_last": host},
               accuracy={"iteration_1": acc1, "last": acc},
               profile=prof)
    print("covertype train: " + json.dumps(rep), flush=True)
    print("covertype: second run bitwise equal; card predict (N, 7) "
          "bitwise equal to CPU; valid scores bitwise equal to predict",
          flush=True)
    rep.update(hist_root=root, hist_level=level, perm=perm)
    report["covertype"] = rep
    return launches, root, level, perm


def phase_covertype_defaults(dt, a, ds, Xv, dv, dev, report) -> tuple:
    """Phase 18: Covertype at the reference's defaults (leaf-wise, 31
    leaves, effective depth 9, wired arm), bagged, column-sampled,
    validated, early stopping after 5 rounds; one bag and one feature
    mask per iteration; crash at iteration 6 after checkpoints every 3,
    resume bitwise; a model-file round trip."""
    import tempfile

    import numpy as np
    import torch

    from dryad_tpu_torch.checkpoint import Checkpointer
    from dryad_tpu_torch.config import (
        effective_depth_params,
        leafwise_fast_supported,
    )
    from dryad_tpu_torch.engine import cuda_build, hist, leafperm
    from dryad_tpu_torch.engine import leafwise_fast
    from dryad_tpu_torch.engine import train as engine_train
    from dryad_tpu_torch.engine.loop_state import sample_masks

    class Crash(RuntimeError):
        pass

    K, T, crash_at = COV_CLASSES, a.cov_default_trees, 6
    params = {"objective": "multiclass", "num_class": K, "subsample": 0.8,
              "colsample": 0.8, "early_stopping_rounds": 5, "num_trees": T}
    F, B, N = ds.num_features, ds.mapper.total_bins, ds.num_rows
    p = effective_depth_params(dt.Params.from_dict(params), F, B, N)
    D = p.max_depth
    check(D == 9 and p.growth == "leafwise" and p.num_leaves == 31
          and leafwise_fast_supported(p, F, B, N)
          and leafwise_fast.leafwise_layout_supported(p, F, B, 1),
          f"covertype defaults: effective depth {D}, not the batched "
          "grower's wired arm at 9")
    calls = leafwise_capture(dt, params, ds, dev,
                             {"hist": (hist, "hist_tiles"),
                              "perm": (leafperm, "permute_records")},
                             "covertype defaults", trees=K)
    check(len(calls["hist"]) == K * (D + 1)
          and len(calls["perm"]) == K * D,
          f"covertype defaults capture iteration made "
          f"{len(calls['hist'])} histogram calls and "
          f"{len(calls['perm'])} row moves")
    del calls
    torch.cuda.empty_cache()

    # the main path, with the bag and feature mask each class tree gets
    # watched: the K trees of an iteration share iteration it's draw
    grows: list = []
    real_grow = engine_train.grow_any

    def spy_grow(p_, B_, Xb, g, h, bag, fmask, **kw):
        it = len(grows) // K
        if len(grows) % K == 0:
            rm, fm = sample_masks(p, it, N, F)
            grows.append((torch.equal(bag, torch.from_numpy(rm).to(dev))
                          and torch.equal(fmask,
                                          torch.from_numpy(fm).to(dev)),
                          bag, fmask))
        else:
            first = grows[it * K]
            grows.append((torch.equal(bag, first[1])
                          and torch.equal(fmask, first[2]), None, None))
        return real_grow(p_, B_, Xb, g, h, bag, fmask, **kw)

    infos: list = []
    engine_train.grow_any = spy_grow
    try:
        torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_counts()
        straight = dt.train(params, ds, [dv], device=dev,
                            callback=lambda it, info: infos.append(info))
        launches = dict(cuda_build.counts)
        peak = torch.cuda.max_memory_allocated()
    finally:
        engine_train.grow_any = real_grow
    n = straight.num_iterations
    check(n == T, f"covertype defaults: stopped early at {n} of {T}")
    check(len(grows) == K * n and all(ok for ok, _, _ in grows),
          "covertype defaults: the K trees of an iteration did not share "
          "that iteration's bag and feature mask")
    del grows
    check_launches(launches, {"hist": (D + 1) * K * n, "perm": D * K * n},
                   "covertype defaults")
    curve = [i["valid_multi_logloss"] for i in infos]
    check(len(curve) == n and curve[-1] < curve[0],
          f"covertype defaults: multi_logloss {curve[0]} -> {curve[-1]}")

    def crash(it, info):
        if it == crash_at:
            raise Crash

    with tempfile.TemporaryDirectory(dir=OUT) as ckdir:
        try:
            dt.train(params, ds, [dv], device=dev, checkpoint_dir=ckdir,
                     checkpoint_every=3, callback=crash)
            fail("covertype resume: the crash callback did not stop the run")
        except Crash:
            pass
        check(Checkpointer(ckdir).iterations() == [3, 6],
              "covertype resume: checkpoints are not [3, 6]")
        r_infos: list = []
        t0 = time.perf_counter()
        cuda_build.reset_counts()
        resumed = dt.train(params, ds, [dv], device=dev,
                           checkpoint_dir=ckdir, checkpoint_every=3,
                           resume=True,
                           callback=lambda it, info: r_infos.append(info))
        r_launches = dict(cuda_build.counts)
        resume_s = time.perf_counter() - t0
        grown = T - crash_at
        check_launches(r_launches, {"hist": (D + 1) * K * grown,
                                    "perm": D * K * grown},
                       "covertype resume")
        same_trees(straight, resumed, "covertype resume")
        check(r_infos == infos[crash_at:]
              and resumed.best_iteration == straight.best_iteration,
              "covertype resume: evals or best iteration differ from the "
              "straight run")
        raw = predict_rows(straight, Xv, raw_score=True, device=dev)
        check(raw.shape == (len(Xv), K), f"covertype defaults: predict "
              f"shape {raw.shape}")
        check(np.array_equal(predict_rows(resumed, Xv, raw_score=True,
                                        device=dev), raw),
              "covertype resume: predict differs from the straight run")
        path = os.path.join(ckdir, "covertype.dryad")
        resumed.save(path)
        loaded = dt.Booster.load(path)
        check(loaded.num_outputs == K
              and np.array_equal(predict_rows(loaded, Xv, raw_score=True,
                                            device=dev), raw),
              "covertype: the loaded model file predicts differently")
    prof = profile_tree(params, ds, dev, "profile_covertype_defaults.txt")
    rep = dict(tree_summary(straight), peak_bytes=peak, launches=launches,
               resume_launches=r_launches, resume_seconds=resume_s,
               effective_max_depth=D, best_iteration=straight.best_iteration,
               multi_logloss={"iteration_1": curve[0], "last": curve[-1]},
               splits_per_tree=float((straight.arrays["feature"] >= 0)
                                     .sum(1).mean()), profile=prof)
    print("covertype defaults: " + json.dumps(rep), flush=True)
    print("covertype defaults: one bag per iteration; resume bitwise equal "
          "to the straight run (trees, evals, predict); the saved file "
          "predicts bitwise", flush=True)
    report["covertype_defaults"] = rep
    return launches, r_launches


def phase_covertype_fixture(dt, a, dev, report) -> tuple:
    """Phase 19: the multiclass fixture (K=3, 50k rows, 64 bins,
    depthwise depth 8): K3 and K1 row mode against their plain versions
    on a class tree of the legacy arm; wired and legacy trees equal."""
    import numpy as np

    from dryad_tpu_torch import datasets
    from dryad_tpu_torch.engine import cuda_build, hist, hist_nat

    K = 3
    X, y = datasets.covertype_like(50_000, COV_FEATURES, K, seed=43)
    ds = dt.Dataset(X, y, max_bins=64)
    base = {"objective": "multiclass", "num_class": K, "num_trees": 3,
            "num_leaves": 128, "max_bins": 64, "growth": "depthwise",
            "max_depth": 8}
    legacy = dict(base, deep_layout="legacy")
    n_nat, n_rows = legacy_calls(ds.num_rows, ds.num_features, 8, 128)
    check(n_nat > 0, "the multiclass fixture left the K3 gate")
    calls = capture(dt, legacy, ds, dev,
                    {"rows": (hist, "hist_rows"),
                     "nat": (hist_nat, "build_hist_nat")})
    check(len(calls["rows"]) == K * n_rows and len(calls["nat"]) == K * n_nat,
          f"multiclass fixture capture iteration made {len(calls['rows'])} "
          f"row-mode and {len(calls['nat'])} natural-order calls")
    nc = class_calls(calls["nat"], K, K - 1)
    rc = class_calls(calls["rows"], K, K - 1)
    nat = check_nat(nc[-1], "multiclass fixture nat", a.reps)
    rows = check_rows(rc[-1][0], "multiclass fixture rows", a.reps)
    del calls, nc, rc
    b_w = dt.train(base, ds, device=dev)
    cuda_build.reset_counts()
    b_l = dt.train(legacy, ds, device=dev)
    launches = dict(cuda_build.counts)
    check_launches(launches, {"nat": n_nat * K * 3,
                              "hist_rows": n_rows * K * 3},
                   "multiclass fixture, legacy")
    for k in ("feature", "threshold", "left", "right", "default_left"):
        check(np.array_equal(b_w.tree_arrays()[k], b_l.tree_arrays()[k]),
              f"multiclass fixture, wired vs legacy: {k!r} differs")
    dv = float(np.abs(b_w.arrays["value"] - b_l.arrays["value"]).max())
    check(dv <= 1e-5, f"multiclass fixture, wired vs legacy: values differ "
          f"by {dv}")
    rep = {"wired_vs_legacy_max_value_diff": dv, "launches": launches,
           "nat_level": brief(nat), "rows_level": brief(rows)}
    print("multiclass fixture: " + json.dumps(rep), flush=True)
    report["covertype_fixture"] = rep
    return launches, nat, rows


# MSLR-WEB30K's LambdaMART acceptance config (scripts/acceptance.py:84):
# leaf-wise, 31 leaves, max_depth 10, 50 trees (cut to 25 here, for the
# script's time), 256 bins, NDCG@10 of the valid set every iteration.  MSLR-WEB30K holds 31,531 queries of ~120
# documents, 136 features, relevance 0-4; a fold trains on 3/5 of its
# queries (18,919) and validates on 1/5 (6,306); half of each here, for the
# script's time
MSLR = {"objective": "lambdarank", "num_trees": 15, "num_leaves": 31,
        "max_depth": 10, "max_bins": 256}
MSLR_TRAIN_QUERIES = 9_460
MSLR_VALID_QUERIES = 3_153
MSLR_DOCS = (5, 234)
MSLR_FEATURES = 136


def leafwise_legacy_calls(n_rows: int, n_features: int,
                          depth: int) -> tuple[int, int]:
    """(K3, K1 row-mode) launches of one tree of the batched leaf-wise
    grower's legacy arm on u8 bins: K3 for the narrow levels when the
    natural-order gate admits the matrix, K1 row mode for the root and the
    full-width levels (``leafwise_fast.phase_plan``)."""
    from dryad_tpu_torch.engine import hist_nat, leafwise_fast

    d_switch, p_narrow, _ = leafwise_fast.phase_plan(depth)
    nat_live = (hist_nat.nat_gate_admits(n_rows, n_features, 1)
                and p_narrow <= hist_nat.NAT_SLOTS)
    n_nat = d_switch if nat_live else 0
    return n_nat, 1 + depth - n_nat


def kernel_device_ms(avgs, names: tuple) -> dict:
    """Device ms and launches of the kernels whose names start with each
    of ``names`` in a profile's ``key_averages``."""
    import torch

    out = {}
    for e in avgs:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for n in names:
            if e.key.startswith(n):
                ms, k = out.get(n, (0.0, 0))
                out[n] = (ms + dev_us(e) / 1e3, k + e.count)
    return {n: {"device_ms": ms, "launches": k}
            for n, (ms, k) in out.items()}


def profile_ranking(p, ds, dev, fname: str) -> dict:
    """One LambdaMART iteration (the lambda pass at the zero init score,
    then one tree) under torch.profiler: device time by kernel, K3's and
    K1 row mode's device ms, and the device's busy share of the
    iteration's wall time (measured again without the profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dryad_tpu_torch.engine.grower import grow_any
    from dryad_tpu_torch.engine.lambdarank import (
        PaddingPlan,
        grad_hess_ranking,
    )
    from dryad_tpu_torch.dataset import binned_to_device
    from dryad_tpu_torch.objectives import get_objective

    B, N, F = ds.mapper.total_bins, ds.num_rows, ds.num_features
    obj = get_objective(p)
    Xb = binned_to_device(ds.X_binned, dev)
    y = torch.from_numpy(ds.y).to(dev)
    plan = PaddingPlan(ds.query_offsets, dev)
    score = torch.zeros(N, dtype=torch.float32, device=dev)
    bag = torch.ones(N, dtype=torch.bool, device=dev)
    fmask = torch.ones(F, dtype=torch.bool, device=dev)

    def iteration():
        g, h = grad_hess_ranking(obj, score, y, None, plan)
        grow_any(p, B, Xb, g, h, bag, fmask)
        torch.cuda.synchronize()

    iteration()
    t0 = time.perf_counter()
    for _ in range(3):
        iteration()
    wall_ms = (time.perf_counter() - t0) / 3 * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        iteration()
    avgs = prof.key_averages()          # once: it takes seconds
    kernels = [e for e in avgs
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(dev_us(e) for e in kernels)
    with open(os.path.join(OUT, fname), "w") as f:
        f.write(avgs.table(sort_by="self_cuda_time_total", row_limit=80))
    del Xb, y, plan
    if total_us <= 0:
        return {"iteration_wall_ms": wall_ms, "device_ms": "not measured"}
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    return {"iteration_wall_ms": wall_ms, "device_ms": total_us / 1e3,
            "busy_share": total_us / 1e3 / wall_ms,
            "by_kernel": kernel_device_ms(avgs, ("nat_kernel",
                                                 "hist_rows_kernel")),
            "kernels": [[e.key[:60], dev_us(e) / 1e3, e.count] for e in top]}


def mslr_data(dt) -> tuple:
    """``mslr_like(9,460 + 3,153 queries, (5, 234) documents, 136
    features, seed=17)``: the first 9,460 queries train, the next 3,153
    are the valid set, bound through the train set's mapper with their
    groups."""
    from dryad_tpu_torch import datasets

    t0 = time.perf_counter()
    (X, y, group), t_gen = drawn(
        "mslr", datasets.mslr_like, MSLR_TRAIN_QUERIES + MSLR_VALID_QUERIES,
        docs_per_query=MSLR_DOCS, num_features=MSLR_FEATURES, seed=17)
    n = int(group[:MSLR_TRAIN_QUERIES].sum())
    ds = dt.Dataset(X[:n], y[:n], group=group[:MSLR_TRAIN_QUERIES],
                    max_bins=256)
    Xv, yv = X[n:], y[n:]
    dv = ds.bind(Xv, yv, group=group[MSLR_TRAIN_QUERIES:])
    seconds = time.perf_counter() - t0
    check(ds.num_features == MSLR_FEATURES and ds.mapper.total_bins == 256,
          f"mslr shape {ds.num_features} x {ds.mapper.total_bins} bins")
    print(f"mslr data: {MSLR_TRAIN_QUERIES} + {MSLR_VALID_QUERIES} queries, "
          f"{n} + {len(yv)} documents x {MSLR_FEATURES}, generated in "
          f"{t_gen:.1f} s, binned by {seconds:.1f} s", flush=True)
    print("mslr: the one known difference from MSLR-WEB30K: the "
          f"generator's query sizes are uniform in {list(MSLR_DOCS)}, the "
          "real set's are skewed (up to 1,251 documents)", flush=True)
    return ds, dv, Xv, yv, t_gen, seconds


def phase_mslr(dt, a, dev, report) -> tuple:
    """Phase 20: MSLR-WEB30K LambdaMART at full width, leaf-wise depth 10
    on the legacy arm (145-byte records refuse the wired layout)."""
    import numpy as np
    import torch

    from dryad_tpu_torch.config import (
        effective_depth_params,
        leafwise_fast_supported,
    )
    from dryad_tpu_torch.engine import cuda_build, hist, hist_nat
    from dryad_tpu_torch.engine import leafwise_fast
    from dryad_tpu_torch.engine import train as engine_train
    from dryad_tpu_torch.engine.lambdarank import (
        PaddingPlan,
        grad_hess_ranking,
    )
    from dryad_tpu_torch.engine.predict import predict_binned
    from dryad_tpu_torch.metrics import ndcg_at_k
    from dryad_tpu_torch.metrics.device import make_evaluator
    from dryad_tpu_torch.objectives import get_objective

    ds, dv, Xv, yv, t_gen, t_data = mslr_data(dt)
    F, B, N = ds.num_features, ds.mapper.total_bins, ds.num_rows
    D, T = MSLR["max_depth"], MSLR["num_trees"]
    p = effective_depth_params(dt.Params.from_dict(MSLR), F, B, N)
    check(p.max_depth == D and leafwise_fast_supported(p, F, B, N)
          and not leafwise_fast.leafwise_layout_supported(p, F, B, 1),
          "mslr: not the batched leaf-wise grower's legacy arm at depth 10")
    n_nat, n_rows = leafwise_legacy_calls(N, F, D)
    check((n_nat, n_rows) == (4, 7), f"mslr: {n_nat} K3 + {n_rows} K1 "
          "row-mode launches per tree, want 4 + 7 (the 309 MB matrix "
          "passes the K3 gate)")
    calls = leafwise_capture(dt, MSLR, ds, dev,
                             {"rows": (hist, "hist_rows"),
                              "nat": (hist_nat, "build_hist_nat")}, "mslr")
    check(len(calls["rows"]) == n_rows and len(calls["nat"]) == n_nat,
          f"mslr capture tree made {len(calls['rows'])} row-mode and "
          f"{len(calls['nat'])} natural-order calls")
    nat = check_nat(calls["nat"][-1], "mslr nat level 3", a.reps)
    root = check_rows(calls["rows"][0][0], "mslr rows root", a.reps)
    rows = check_rows(calls["rows"][-1][0], "mslr rows level 9", a.reps)
    check(nat["P"] == 8 and root["P"] == 1 and rows["P"] == 512,
          f"mslr P: K3 {nat['P']}, K1 root {root['P']}, level 9 "
          f"{rows['P']}")
    print("K3 mslr level 3: " + json.dumps(nat), flush=True)
    print("K1 rows mslr root: " + json.dumps(root), flush=True)
    print("K1 rows mslr level 9: " + json.dumps(rows), flush=True)
    del calls
    torch.cuda.empty_cache()

    # the main path: 15 trees, the valid set's NDCG@10 every iteration
    kept, restore = spy_valid_scores(engine_train, 1)
    try:
        torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_counts()
        booster = dt.train(MSLR, ds, [dv], device=dev)
        launches = dict(cuda_build.counts)
        peak = torch.cuda.max_memory_allocated()
    finally:
        restore()
    n = booster.num_iterations
    check(n == T, f"mslr: {n} trees, want {T}")
    check_launches(launches, {"nat": n_nat * T, "hist_rows": n_rows * T},
                   "mslr")
    vscore = kept[-1].cpu().numpy()
    del kept
    same_trees(booster, dt.train(MSLR, ds, [dv], device=dev), "mslr")
    raw = predict_rows(booster, Xv, raw_score=True, num_iteration=n,
                     device=dev)
    check(raw.shape == (len(yv),) and bool(np.isfinite(raw).all()),
          f"mslr: predict shape {raw.shape} or finiteness")
    check(np.array_equal(raw, predict_rows(booster, Xv, raw_score=True,
                                         num_iteration=n, device="cpu")),
          "mslr: card predict != CPU predict")
    check(np.array_equal(vscore, raw),
          "mslr: the trainer's valid scores differ from predict's")
    curve = [v for _, v in booster.train_state["eval_history"]["valid_ndcg"]]
    qoff_v = dv.query_offsets
    zero = ndcg_at_k(yv, np.zeros_like(yv), qoff_v, 10)
    host = ndcg_at_k(yv, raw, qoff_v, 10)
    check(len(curve) == n and curve[-1] > curve[0] and curve[-1] > zero,
          f"mslr: NDCG@10 {curve[0]} -> {curve[-1]} (zero scores {zero})")
    check(abs(curve[-1] - host) <= 1e-5,
          f"mslr: last valid NDCG@10 {curve[-1]} vs host {host}")
    print("mslr: second run bitwise equal; card predict bitwise equal to "
          "CPU; valid scores bitwise equal to predict", flush=True)

    # the lambda pass on one iteration's scores (tree T // 2's): card twice,
    # bitwise, and against the same function on the CPU
    obj = get_objective(booster.params)
    s_mid = predict_binned(booster, ds.X_binned, device=dev,
                           num_iteration=T // 2)[:, 0]
    s_d = torch.from_numpy(s_mid).to(dev)
    y_d = torch.from_numpy(ds.y).to(dev)
    plan = PaddingPlan(ds.query_offsets, dev)
    pair_grid = {"queries": plan.Q, "S": plan.S}
    g1, h1 = grad_hess_ranking(obj, s_d, y_d, None, plan)
    g2, h2 = grad_hess_ranking(obj, s_d, y_d, None, plan)
    sync()
    check(torch.equal(g1, g2) and torch.equal(h1, h2),
          "mslr: two lambda passes differ")
    t0 = time.perf_counter()
    gc_, hc_ = grad_hess_ranking(obj, torch.from_numpy(s_mid),
                                 torch.from_numpy(ds.y), None,
                                 PaddingPlan(ds.query_offsets, "cpu"))
    cpu_s = time.perf_counter() - t0
    lam_err = {}
    for name, dev_v, cpu_v in (("g", g1, gc_), ("h", h1, hc_)):
        d = dev_v.cpu().double() - cpu_v.double()
        lam_err[name] = float(d.abs().max())
        ok = bool((d.abs() <= 1e-6 + 1e-5 * cpu_v.double().abs()).all())
        check(ok, f"mslr: the card's lambda pass {name} differs from the "
              f"CPU's beyond rtol 1e-5 / atol 1e-6 (max abs {lam_err[name]})")
    lam_ms = time_ms(lambda: grad_hess_ranking(obj, s_d, y_d, None, plan),
                     3)
    _, _, fn = make_evaluator("lambdarank", "ndcg", dv, dev)
    v_d = torch.from_numpy(raw).to(dev)
    ndcg_ms = time_ms(lambda: fn(v_d), a.reps)
    del g1, h1, g2, h2, s_d, y_d, plan, v_d
    torch.cuda.empty_cache()
    prof = profile_ranking(booster.params, ds, dev, "profile_mslr.txt")
    rep = dict(tree_summary(booster), peak_bytes=peak, launches=launches,
               launches_per_tree={"nat": n_nat, "hist_rows": n_rows},
               ndcg10={"iteration_1": curve[0], "last": curve[-1],
                       "host_last": host, "zero_scores": zero},
               lambda_pass={"device_ms": lam_ms, "cpu_s": cpu_s,
                            "max_abs_err_vs_cpu": lam_err, **pair_grid},
               ndcg_device_ms=ndcg_ms, data_seconds=t_data, gen_seconds=t_gen,
               rows=N, valid_rows=len(yv),
               splits_per_tree=float((booster.arrays["feature"] >= 0)
                                     .sum(1).mean()), profile=prof)
    print("mslr train: " + json.dumps(rep), flush=True)
    rep.update(nat_level=nat, rows_root=root, rows_level=rows)
    report["mslr"] = rep
    # phase 35 trains on the same sets, kept on the host
    ds._device_cache.clear()
    dv._device_cache.clear()
    return launches, nat, root, rows, (ds, dv)


ROBUST = ("l1", "huber", "fair", "quantile", "poisson")
ROBUST_TREES = 10


def pinball(y, s, alpha: float) -> float:
    """Mean pinball loss at level ``alpha``, in float64 on the host."""
    import numpy as np

    d = y.astype(np.float64) - s.astype(np.float64)
    return float(np.mean(np.maximum(alpha * d, (alpha - 1.0) * d)))


def phase_robust(dt, a, eds, Xv_b, yv, dev, report) -> tuple:
    """Phase 21: l1, huber, fair, quantile (alpha 0.9) and poisson on phase
    16's binned Epsilon matrix (no second binning): depthwise, max_depth 6,
    63 leaves, 10 trees each."""
    import tempfile

    import numpy as np
    import torch

    from dryad_tpu_torch.checkpoint import Checkpointer
    from dryad_tpu_torch.engine import cuda_build
    from dryad_tpu_torch.engine import train as engine_train
    from dryad_tpu_torch.engine.predict import predict_binned
    from dryad_tpu_torch.metrics import mae, poisson_deviance, rmse
    from dryad_tpu_torch.metrics.device import poisson_deviance_device
    from dryad_tpu_torch.objectives import get_objective

    class Crash(RuntimeError):
        pass

    T = ROBUST_TREES
    base = {"growth": "depthwise", "max_depth": 6, "num_leaves": 63,
            "max_bins": 256, "num_trees": T}
    N, F = eds.num_rows, eds.num_features
    # at 300k rows the matrix is past the K3 gate: K1 row mode only
    n_nat, n_rows = legacy_calls(N, F, 6, 63)
    per_run = {"hist_rows": n_rows * T, "nat": n_nat * T}
    rng = np.random.Generator(np.random.Philox(21))
    std = float(np.std(eds.y))
    y_pois = rng.poisson(np.exp(np.clip(eds.y / std, -3, 3))).astype(
        np.float32)
    yv_pois = rng.poisson(np.exp(np.clip(yv / std, -3, 3))).astype(
        np.float32)
    pds = dt.Dataset.from_binned(eds.X_binned, eds.mapper, y_pois)
    losses = {"l1": lambda yy, s: mae(yy, s),
              "huber": lambda yy, s: rmse(yy, s),
              "fair": lambda yy, s: rmse(yy, s),
              "quantile": lambda yy, s: pinball(yy, s, 0.9),
              "poisson": lambda yy, s: poisson_deviance(yy, s)}
    out: dict = {}
    total = {}
    for objective in ROBUST:
        params = dict(base, objective=objective,
                      **({"alpha": 0.9} if objective == "quantile" else {}))
        ds = pds if objective == "poisson" else eds
        lab_v = yv_pois if objective == "poisson" else yv
        renewals: list = []
        real_renew = engine_train.renew_values

        def spy_renew(*args):
            res = real_renew(*args)
            if not renewals:
                # score_k is a view of the score the loop then updates
                renewals.append(([x.clone() if torch.is_tensor(x) else x
                                  for x in args], res))
            return res

        engine_train.renew_values = spy_renew
        try:
            booster, launches, peak = train_counted(dt, params, ds, dev)
        finally:
            engine_train.renew_values = real_renew
        check(booster.num_iterations == T, f"{objective}: "
              f"{booster.num_iterations} trees")
        check_launches(launches, per_run, objective)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        raw1 = predict_binned(booster, Xv_b, device=dev, num_iteration=1)[:, 0]
        raw = predict_binned(booster, Xv_b, device=dev)[:, 0]
        l1_, lT = losses[objective](lab_v, raw1), losses[objective](lab_v, raw)
        check(lT < l1_, f"{objective}: held-out loss {l1_} -> {lT} did not "
              "fall")
        rep = {"loss_tree_1": l1_, "loss_last": lT, "launches": launches,
               "peak_bytes": peak, **tree_summary(booster)}

        # g/h on the card vs the CPU, at the trained scores of the rows
        obj = get_objective(booster.params)
        s_tr = predict_binned(booster, ds.X_binned, device=dev)[:, 0]
        gd, hd = obj.grad_hess(torch.from_numpy(s_tr).to(dev),
                               torch.from_numpy(ds.y).to(dev))
        gc_, hc_ = obj.grad_hess(torch.from_numpy(s_tr),
                                 torch.from_numpy(ds.y))
        gd, hd = gd.cpu().numpy(), hd.cpu().numpy()
        gc_, hc_ = gc_.numpy(), hc_.numpy()
        if objective == "poisson":
            # 2 ulps of the larger of the result and its exp term
            def ulps(e, r):
                return np.spacing(np.maximum(np.abs(e), np.abs(r))
                                  .astype(np.float32))
            e_g = np.exp(s_tr.astype(np.float64))
            e_h = np.exp(s_tr.astype(np.float64)
                         + np.float32(booster.params.poisson_max_delta_step))
            ok = (bool((np.abs(gd - gc_) <= 2 * ulps(e_g, gc_)).all())
                  and bool((np.abs(hd - hc_) <= 2 * ulps(e_h, hc_)).all()))
            dev_pd = float(poisson_deviance_device(
                torch.from_numpy(lab_v).to(dev),
                torch.from_numpy(raw).to(dev)))
            check(abs(dev_pd - lT) <= 1e-5, f"poisson: device deviance "
                  f"{dev_pd} vs host {lT}")
            rep["poisson_deviance_device"] = dev_pd
        else:
            ok = np.array_equal(gd, gc_) and np.array_equal(hd, hc_)
        check(ok, f"{objective}: g/h on the card differ from the CPU's")
        rep["grad_hess_max_abs_err"] = float(max(np.abs(gd - gc_).max(),
                                                 np.abs(hd - hc_).max()))

        if renewals:
            # tree 1's renewed leaves vs a numpy type-1 quantile of each
            # leaf's in-bag residuals, times the learning rate
            args, res = renewals[0]
            # one process: the tenth argument, the group, is None
            value, feature, leaves, y_t, score_k, bag, alpha, lr, M = args[:9]
            r = (y_t.cpu().numpy() - score_k.cpu().numpy()).astype(
                np.float32)
            lv = leaves.cpu().numpy()
            inbag = bag.cpu().numpy()
            got = res.cpu().numpy()
            feat = feature.cpu().numpy()
            n_leaves = 0
            for m in range(M):
                rs = np.sort(r[(lv == m) & inbag])
                if feat[m] >= 0 or rs.size == 0:
                    continue
                kf = np.ceil(np.float32(alpha) * np.float32(rs.size))
                kidx = min(max(int(kf) - 1, 0), rs.size - 1)
                expect = np.float32(rs[kidx]) * np.float32(lr)
                check(got[m] == expect, f"{objective}: renewed leaf {m} "
                      f"{got[m]} != numpy quantile {expect}")
                n_leaves += 1
            rep["renewed_leaves_checked"] = n_leaves
            rep["renewal_ms"] = time_ms(lambda: real_renew(*args), a.reps)
        print(f"robust {objective}: " + json.dumps(rep), flush=True)
        out[objective] = rep

    # quantile crash at tree 6 of 10, resumed from its checkpoint
    params = dict(base, objective="quantile", alpha=0.9)
    straight = dt.train(params, eds, device=dev)

    def crash(it, info):
        if it == 6:
            raise Crash

    with tempfile.TemporaryDirectory(dir=OUT) as ckdir:
        try:
            dt.train(params, eds, device=dev, checkpoint_dir=ckdir,
                     checkpoint_every=3, callback=crash)
            fail("robust resume: the crash callback did not stop the run")
        except Crash:
            pass
        check(Checkpointer(ckdir).iterations() == [3, 6],
              "robust resume: checkpoints are not [3, 6]")
        cuda_build.reset_counts()
        resumed = dt.train(params, eds, device=dev, checkpoint_dir=ckdir,
                           checkpoint_every=3, resume=True)
        r_launches = dict(cuda_build.counts)
    check_launches(r_launches, {"hist_rows": n_rows * (T - 6),
                                "nat": n_nat * (T - 6)}, "robust resume")
    same_trees(straight, resumed, "quantile resume")
    check(np.array_equal(predict_binned(straight, Xv_b, device=dev),
                         predict_binned(resumed, Xv_b, device=dev)),
          "quantile resume: predict differs from the straight run")
    out["quantile_resume"] = {"launches": r_launches}
    print("robust: g/h bitwise equal to the CPU (poisson within 2 ulps); "
          "renewed leaves equal numpy's quantiles; held-out losses fell; "
          "quantile resume bitwise equal to the straight run", flush=True)
    for k, v in r_launches.items():
        total[k] = total.get(k, 0) + v
    report["robust"] = out
    return total


# Criteo's acceptance config (scripts/acceptance.py:94-102): binary,
# depthwise, max_depth 6, 63 leaves, 30 trees, 256 bins, its 26
# categorical features, AUC of the valid set every iteration.  The public
# Criteo Display Advertising Challenge set holds 45,840,617 rows of 13
# dense and 26 categorical features; the phase trains on 1M criteo_like
# rows, a cut made for the script's time limit only
CRITEO = {"objective": "binary", "num_trees": 30, "num_leaves": 63,
          "max_depth": 6, "growth": "depthwise", "max_bins": 256,
          "metric": "auc"}
CRITEO_ROWS = 1_000_000         # for the script's time
CRITEO_HOLDOUT = 100_000
CRITEO_PUBLIC_ROWS = 45_840_617
_INT_TREE_KEYS = ("feature", "threshold", "left", "right", "default_left",
                  "is_cat", "cat_bitset", "cover")


def csr_rows(csr, start: int, stop: int) -> tuple:
    """Rows [start, stop) of a CSR triple, as a CSR triple (views)."""
    indptr, indices, values, F = csr
    lo, hi = indptr[start], indptr[stop]
    return indptr[start:stop + 1] - lo, indices[lo:hi], values[lo:hi], F


def densify(csr):
    """The dense float matrix of a CSR triple (absent entries 0.0)."""
    import numpy as np

    indptr, indices, values, F = csr
    n = indptr.shape[0] - 1
    X = np.zeros((n, F), np.float32)
    X[np.repeat(np.arange(n), np.diff(indptr)), indices] = values
    return X


def criteo_data(dt, rows: int, holdout: int) -> tuple:
    """``criteo_like(rows + holdout, seed=19)``, drawn once: the first
    ``rows`` train, the rest, sliced from the same CSR triple, are the
    valid set bound through the train mapper.  Returns (ds, dv, csr,
    cat_ids, set-up seconds by step)."""
    from dryad_tpu_torch import dataset as dsmod
    from dryad_tpu_torch import datasets

    secs: dict = {}
    (csr, y, cat_ids), secs["generate"] = drawn(
        f"criteo{rows + holdout}", datasets.criteo_like, rows + holdout,
        seed=19)
    steps = {"_sketch_csr": "sketch", "bin_csr": "bin",
             "plan_bundles": "bundle_plan"}
    real = {k: getattr(dsmod, k) for k in steps}

    def timed(k):
        def f(*args, **kw):
            t1 = time.perf_counter()
            out = real[k](*args, **kw)
            secs[steps[k]] = time.perf_counter() - t1
            return out
        return f

    for k in steps:
        setattr(dsmod, k, timed(k))
    try:
        ds = dt.Dataset(None, y[:rows], csr=csr_rows(csr, 0, rows),
                        categorical_features=cat_ids, max_bins=256)
    finally:
        for k in steps:
            setattr(dsmod, k, real[k])
    t0 = time.perf_counter()
    dv = ds.bind(None, y[rows:], csr=csr_rows(csr, rows, rows + holdout))
    secs["bind_valid"] = time.perf_counter() - t0
    return ds, dv, csr, cat_ids, secs


def phase_criteo(dt, a, dev, report) -> tuple:
    """Phase 22: Criteo, CSR ingest and categorical splits, full width,
    depthwise on the wired arm, the held-out rows as the valid set."""
    import numpy as np
    import torch

    from dryad_tpu_torch.config import Params
    from dryad_tpu_torch.engine import (
        cuda_build,
        hist,
        leafperm,
        levelwise,
    )
    from dryad_tpu_torch.engine import train as engine_train
    from dryad_tpu_torch.engine.predict import predict_binned
    from dryad_tpu_torch.metrics import auc

    rows, D = CRITEO_ROWS, CRITEO["max_depth"]
    print(f"criteo reduced: {CRITEO_PUBLIC_ROWS} rows of the public Criteo "
          f"Display Advertising Challenge set cut to {rows} training rows "
          f"(+ {CRITEO_HOLDOUT} held out) for the time limit; widths kept "
          "(13 dense + 26 categorical, 256 bins)", flush=True)
    ds, dv, csr, cat_ids, setup = criteo_data(dt, rows, CRITEO_HOLDOUT)
    F, B = ds.num_features, ds.mapper.total_bins
    n_cat = int(ds.mapper.is_categorical.sum())
    check(n_cat == 26 and F == 39 and B == 256,
          f"criteo mapper: {n_cat} categorical of {F} features, {B} bins")
    n_bundles = len(getattr(ds.mapper, "bundles", []))
    print(f"criteo data: {rows} + {CRITEO_HOLDOUT} x {F} ({n_cat} "
          f"categorical, {n_bundles} bundles), {csr[1].size} stored "
          f"entries; set-up s {json.dumps(setup)}", flush=True)
    # the CSR binning equals the dense binning of the same rows
    n_chk = min(200_000, rows)
    dense = densify(csr_rows(csr, 0, n_chk))
    check(np.array_equal(ds.mapper.transform(dense), ds.X_binned[:n_chk]),
          "criteo: bin_csr differs from bin_matrix on the densified rows")
    del dense, csr
    params = dict(CRITEO, categorical_features=list(cat_ids))
    p = Params.from_dict(params)
    check(levelwise.deep_layout_supported(p, F, B, 1),
          "criteo: the config left the wired arm")

    # one capture tree: K1 at the root and the last level, K2 at level 3,
    # the categorical scan and route of the last level
    calls = capture(dt, params, ds, dev,
                    {"hist": (hist, "hist_tiles"),
                     "perm": (leafperm, "permute_records"),
                     "scan": (levelwise, "find_best_split"),
                     "route": (levelwise, "packed_route")})
    check(len(calls["hist"]) == D + 1 and len(calls["perm"]) == D,
          f"criteo capture tree made {len(calls['hist'])} histogram calls "
          f"and {len(calls['perm'])} row moves")
    root = check_hist(calls["hist"][0][0], "criteo hist root", a.reps)
    level = check_hist(calls["hist"][-1][0], "criteo hist level", a.reps)
    perm = check_perm(calls["perm"][3][0], a.reps)
    print("K1 criteo root: " + json.dumps(root), flush=True)
    print("K1 criteo level: " + json.dumps(level), flush=True)
    print("K2 criteo level 3: " + json.dumps(perm), flush=True)
    # the last level's scan over 2P children, with and without the
    # categorical arm; its natural-order route of every row, with and
    # without the membership gather (the layout's route reads records
    # freed after its level, so it is not replayed)
    sa, skw = calls["scan"][-1]
    scan = {"candidates": int(sa[0].shape[0]),
            "cat_ms": time_ms(lambda: levelwise.find_best_split(*sa, **skw),
                              a.reps),
            "numeric_ms": time_ms(lambda: levelwise.find_best_split(
                *sa, **dict(skw, is_cat_feat=None)), a.reps)}
    ra = calls["route"][-2][0]
    check(ra[3] is not None and ra[0].dim() == 1,
          "criteo: the natural-order route has no categorical arm")
    route = {"rows": int(ra[0].numel()),
             "cat_ms": time_ms(lambda: levelwise.packed_route(*ra), a.reps),
             "numeric_ms": time_ms(lambda: levelwise.packed_route(
                 *ra[:3], None), a.reps)}
    print("criteo last level: scan " + json.dumps(scan) + "; route "
          + json.dumps(route), flush=True)
    del calls, sa, skw, ra
    torch.cuda.empty_cache()

    # the main path: 30 trees with the valid set scored on the card
    kept, restore = spy_valid_scores(engine_train, 1)
    try:
        torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_counts()
        booster = dt.train(params, ds, [dv], device=dev)
        launches = dict(cuda_build.counts)
        peak = torch.cuda.max_memory_allocated()
    finally:
        restore()
    n = booster.num_iterations
    check(n == CRITEO["num_trees"], f"criteo: {n} trees")
    check_launches(launches, {"hist": (D + 1) * n, "perm": D * n}, "criteo")
    vscore = kept[0].cpu().numpy()
    del kept
    cat_splits = int(booster.arrays["is_cat"].sum())
    check(cat_splits > 0, "criteo: no categorical split in the model")
    same_trees(booster, dt.train(params, ds, [dv], device=dev), "criteo")
    raw = predict_binned(booster, dv.X_binned, device=dev)[:, 0]
    check(raw.shape == (CRITEO_HOLDOUT,) and bool(np.isfinite(raw).all()),
          "criteo: predict shape or finiteness")
    check(np.array_equal(raw, predict_binned(booster, dv.X_binned,
                                             device=torch.device("cpu"))[:, 0]),
          "criteo: card predict != CPU predict")
    check(np.array_equal(vscore, raw),
          "criteo: the trainer's valid scores differ from predict's")
    curve = [v for _, v in booster.train_state["eval_history"]["valid_auc"]]
    host = auc(dv.y, raw)
    check(len(curve) == n and curve[-1] > curve[0],
          f"criteo: valid AUC {curve[0]} -> {curve[-1]}")
    check(abs(curve[-1] - host) <= 1e-5,
          f"criteo: last valid AUC {curve[-1]} vs host {host}")
    check(host > 0.60, f"criteo: held-out AUC {host} <= 0.60")
    no_valid = tree_summary(dt.train(params, ds, device=dev))
    prof = profile_tree(params, ds, dev, "profile_criteo.txt")
    rep = dict(tree_summary(booster), without_valid=no_valid,
               peak_bytes=peak, launches=launches, cat_splits=cat_splits,
               auc={"tree_1": curve[0], "last": curve[-1],
                    "host_last": host},
               setup_seconds=setup, scan=scan, route=route, profile=prof,
               reduced={"rows": rows, "from": CRITEO_PUBLIC_ROWS})
    print("criteo train: " + json.dumps(rep), flush=True)
    print("criteo: second run bitwise equal; card predict bitwise equal to "
          "CPU; valid scores bitwise equal to predict", flush=True)
    rep.update(hist_root=root, hist_level=level, perm=perm)
    report["criteo"] = rep
    return launches, root, level, perm


def efb_csr(n: int = 20_000, seed: int = 61) -> tuple:
    """A CSR fixture that bundles: 3 dense numeric columns (NaN in 5% of
    the first), 4 groups of 5 mutually exclusive one-hot columns, and 4
    groups of 6 mutually exclusive sparse categorical columns of values
    1-5.  Returns (csr, y, categorical ids)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_dense, oh, oh_lv, cg, cg_per = 3, 4, 5, 4, 6
    F = n_dense + oh * oh_lv + cg * cg_per
    cat0 = n_dense + oh * oh_lv
    present = np.zeros((n, F), bool)
    vals = np.zeros((n, F), np.float32)
    present[:, :n_dense] = True
    vals[:, :n_dense] = rng.normal(size=(n, n_dense))
    vals[rng.random(n) < 0.05, 0] = np.nan
    hot = rng.integers(0, oh_lv, size=(n, oh))
    for gi in range(oh):
        present[np.arange(n), n_dense + gi * oh_lv + hot[:, gi]] = True
    vals[:, n_dense:cat0] = 1.0
    pick = rng.integers(0, cg_per, size=(n, cg))
    for gi in range(cg):
        present[np.arange(n), cat0 + gi * cg_per + pick[:, gi]] = True
    vals[:, cat0:] = rng.integers(1, 6, size=(n, cg * cg_per))
    w = rng.normal(size=cg * cg_per)
    logit = (np.nan_to_num(vals[:, 0]) + (hot[:, 0] == 2) * 1.5
             - (hot[:, 1] >= 3) + 0.3 * (vals[:, cat0:]
                                         * present[:, cat0:]) @ w)
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    r, c = np.nonzero(present)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=n))])
    return ((indptr.astype(np.int64), c.astype(np.int64), vals[r, c], F), y,
            tuple(range(cat0, F)))


def phase_criteo_fixtures(dt, a, dev, report) -> tuple:
    """Phase 23: wired = legacy with categoricals (K3 and K1 row mode
    against their plain versions), leaf-wise batched = sequential with
    categoricals, and the bundled (EFB) fixture card against CPU with a
    model-file round trip."""
    import tempfile

    import numpy as np
    import torch

    from dryad_tpu_torch import datasets
    from dryad_tpu_torch.config import Params, effective_depth_params
    from dryad_tpu_torch.data.bundling import BundledMapper
    from dryad_tpu_torch.engine import (
        cuda_build,
        grower,
        hist,
        hist_nat,
        leafwise_fast,
    )
    from dryad_tpu_torch.engine.predict import predict_binned
    from dryad_tpu_torch.engine.train import feature_kinds
    from dryad_tpu_torch.objectives import Binary

    cpu = torch.device("cpu")
    csr, y, cat_ids = datasets.criteo_like(50_000, seed=43)
    ds = dt.Dataset(None, y, csr=csr, categorical_features=cat_ids,
                    max_bins=64)
    F, B = ds.num_features, ds.mapper.total_bins
    base = {"objective": "binary", "num_trees": 10, "num_leaves": 63,
            "max_bins": 64, "growth": "depthwise", "max_depth": 6,
            "categorical_features": list(cat_ids)}
    legacy = dict(base, deep_layout="legacy")
    n_nat, n_rows = legacy_calls(ds.num_rows, F, 6, 63)
    check(n_nat > 0, "the criteo fixture left the K3 gate")
    calls = capture(dt, legacy, ds, dev,
                    {"rows": (hist, "hist_rows"),
                     "nat": (hist_nat, "build_hist_nat")})
    check(len(calls["rows"]) == n_rows and len(calls["nat"]) == n_nat,
          f"criteo fixture capture tree made {len(calls['rows'])} row-mode "
          f"and {len(calls['nat'])} natural-order calls")
    nat = check_nat(calls["nat"][-1], "criteo fixture nat", a.reps)
    rows = check_rows(calls["rows"][-1][0], "criteo fixture rows", a.reps)
    del calls
    b_w = dt.train(base, ds, device=dev)
    cuda_build.reset_counts()
    b_l = dt.train(legacy, ds, device=dev)
    launches = dict(cuda_build.counts)
    check_launches(launches, {"nat": n_nat * 10, "hist_rows": n_rows * 10},
                   "criteo fixture, legacy")
    for k in _INT_TREE_KEYS:
        check(np.array_equal(b_w.tree_arrays()[k], b_l.tree_arrays()[k]),
              f"criteo fixture, wired vs legacy: {k!r} differs")
    dv = float(np.abs(b_w.arrays["value"] - b_l.arrays["value"]).max())
    check(dv <= 1e-5, f"criteo fixture, wired vs legacy: values differ by "
          f"{dv}")
    check(bool(b_w.arrays["is_cat"].any()),
          "criteo fixture: no categorical split")

    # leaf-wise at the reference's defaults with categoricals: depth 9,
    # wired; one tree of the batched grower against the sequential one
    lw = {"objective": "binary", "categorical_features": list(cat_ids)}
    p = effective_depth_params(Params.from_dict(lw), F, B, ds.num_rows)
    check(p.max_depth == 9 and leafwise_fast.leafwise_layout_supported(
        p, F, B, 1), f"criteo fixture leaf-wise: depth {p.max_depth}, not "
        "the wired arm at 9")
    yt = torch.from_numpy(ds.y).to(dev)
    g, h = Binary().grad_hess(
        torch.full_like(yt, float(Binary().init_score(ds.y))), yt)
    is_cat_feat, _ = feature_kinds(ds.mapper, False, dev)
    args = (p, B, torch.from_numpy(ds.X_binned).to(dev), g, h,
            torch.ones(ds.num_rows, dtype=torch.bool, device=dev),
            torch.ones(F, dtype=torch.bool, device=dev))
    bat = leafwise_fast.grow_tree_leafwise_batched(
        *args, is_cat_feat=is_cat_feat)
    seq = grower.grow_tree(*args, is_cat_feat=is_cat_feat)
    for k in ("feature", "threshold", "left", "right", "default_left",
              "is_cat", "cat_bitset", "row_leaf", "max_depth", "value",
              "cover"):
        check(torch.equal(bat[k], seq[k]),
              f"criteo fixture, batched vs sequential: {k!r} differs")
    check(bool(bat["is_cat"].any()), "criteo fixture leaf-wise: no "
          "categorical split")
    b_d = dt.train(dict(lw, num_trees=3), ds, device=dev)
    check(b_d.params.max_depth == 9 and bool(b_d.arrays["is_cat"].any()),
          "criteo fixture leaf-wise: the defaults run")

    # EFB: a bundled mapper with a categorical bundle, card against CPU
    ecsr, ey, ecat = efb_csr()
    eds = dt.Dataset(None, ey, csr=ecsr, categorical_features=ecat,
                     max_bins=64)
    m = eds.mapper
    check(isinstance(m, BundledMapper) and eds.has_missing
          and any(m.base.is_categorical[b[0]] for b in m.bundles),
          "EFB fixture: no categorical bundle, or no missing values")
    ep = {"objective": "binary", "num_trees": 5, "num_leaves": 15,
          "max_bins": 64}
    b_card = dt.train(ep, eds, device=dev)
    b_cpu = dt.train(ep, eds, device=cpu)
    for k in _INT_TREE_KEYS:
        check(np.array_equal(b_card.tree_arrays()[k], b_cpu.tree_arrays()[k]),
              f"EFB fixture, card vs CPU: {k!r} differs")
    ev = float(np.abs(b_card.arrays["value"] - b_cpu.arrays["value"]).max())
    check(ev <= 1e-4, f"EFB fixture, card vs CPU: values differ by {ev}")
    used = set(b_card.arrays["feature"][b_card.arrays["is_cat"]].tolist())
    check(any(f < len(m.bundles) for f in used),
          "EFB fixture: no subset split on a categorical bundle")
    Xd = densify(ecsr)
    raw = predict_rows(b_card, Xd, raw_score=True, device=dev)
    check(np.array_equal(raw, predict_rows(b_card, Xd, raw_score=True,
                                         device=cpu)),
          "EFB fixture: card predict != CPU predict")
    check(np.array_equal(raw, predict_binned(b_card, eds.X_binned,
                                             device=dev)[:, 0]),
          "EFB fixture: raw-row predict != binned predict")
    with tempfile.TemporaryDirectory() as d:
        path_card, path_cpu = os.path.join(d, "card.dryad"), os.path.join(
            d, "cpu.dryad")
        b_card.save(path_card)
        b_cpu.save(path_cpu)
        loaded = dt.Booster.load(path_card)
        with np.load(path_card) as zc, np.load(path_cpu) as zp:
            same_mapper = bytes(zc["mapper"]) == bytes(zp["mapper"])
    check(isinstance(loaded.mapper, BundledMapper)
          and np.array_equal(raw, predict_rows(loaded, Xd, raw_score=True,
                                             device=dev)),
          "EFB fixture: the loaded model file predicts differently")
    check(same_mapper, "EFB fixture: card and CPU model files' mapper "
          "bytes differ")
    text = dt.Booster.from_text(b_card.dump_text())
    check(isinstance(text.mapper, BundledMapper)
          and np.array_equal(raw, predict_rows(text, Xd, raw_score=True,
                                             device=dev)),
          "EFB fixture: the text model predicts differently")
    rep = {"wired_vs_legacy_max_value_diff": dv, "launches": launches,
           "cat_splits_depthwise": int(b_w.arrays["is_cat"].sum()),
           "leafwise": {"max_depth": p.max_depth,
                        "cat_splits_tree_1": int(bat["is_cat"].sum())},
           "efb": {"features": eds.num_features, "base_features": ecsr[3],
                   "bundles": m.bundles, "card_vs_cpu_max_value_diff": ev,
                   "cat_splits": int(b_card.arrays["is_cat"].sum())},
           "nat_level": brief(nat), "rows_level": brief(rows)}
    print("criteo fixtures: " + json.dumps(rep), flush=True)
    report["criteo_fixtures"] = rep
    return launches, nat, rows


# ---- phases 24-28: GOSS, monotone constraints, DART and rf (M10b) ---------
MODE_BASE = {"objective": "binary", "growth": "depthwise", "max_depth": 8,
             "num_leaves": 255, "max_bins": 256, "learning_rate": 0.1,
             "seed": 0, "metric": "auc"}
MODE_TREES = 10                 # enough for AUC to rise and DART to drop
GOSS = dict(MODE_BASE, boosting="goss", goss_top_rate=0.2,
            goss_other_rate=0.1)
DART = dict(MODE_BASE, boosting="dart", drop_rate=0.1, skip_drop=0.5,
            max_drop=50)
RF = dict(MODE_BASE, boosting="rf", subsample=0.7, colsample=0.8)
MONO_FEATURES = (6, 7, 8, 9)
MONO_GRID = (256, 64)           # base rows x points along each feature


def higgs_w1(n: int, seed: int, num_features: int = 28):
    """``higgs_like``'s linear weights ``w1`` for ``n`` rows: the generator
    draws X first, so its normals are drawn again (in blocks, without
    keeping them) to reach w1."""
    import numpy as np

    rng = np.random.Generator(np.random.Philox(seed))
    left = n * num_features
    while left:
        step = min(left, 1 << 26)
        rng.normal(size=step)
        left -= step
    return rng.normal(size=num_features).astype(np.float32)


def train_valid(dt, params, ds, dv, dev, extra=None):
    """A main-path run with the valid set and a callback, the launch
    counts set to 0 just before it; returns (booster, counts, evals)."""
    from dryad_tpu_torch.engine import cuda_build

    infos = []
    cuda_build.reset_counts()
    booster = dt.train(params, ds, [dv], device=dev,
                       callback=lambda it, info: infos.append(info),
                       **(extra or {}))
    return booster, dict(cuda_build.counts), [i["valid_auc"] for i in infos]


def root_and_move(dt, a, params, ds, dev, kept: int, what: str) -> tuple:
    """One capture iteration: K1's masked root and K2's level-0 move
    against their plain versions, with ``kept`` rows in the root and
    moved exactly once."""
    import torch

    from dryad_tpu_torch.engine import hist, leafperm

    calls = capture(dt, params, ds, dev,
                    {"hist": (hist, "hist_tiles"),
                     "perm": (leafperm, "permute_records")})
    check(len(calls["hist"]) == 9 and len(calls["perm"]) == 8,
          f"{what} capture tree made {len(calls['hist'])} histogram calls "
          f"and {len(calls['perm'])} row moves")
    root_args = calls["hist"][0][0]
    root = check_hist(root_args, f"{what} hist root", a.reps)
    n_root = int(hist.hist_tiles(*root_args)[0, 2, 0].sum())
    check(root["P"] == 1 and n_root == kept,
          f"{what} root: {n_root} rows counted, {kept} kept")
    check_bag_move(calls["perm"][0][0], kept)
    perm0 = check_perm(calls["perm"][0][0], a.reps)
    perm0.update(kept_rows=kept, dropped_rows=ds.num_rows - kept)
    root["shift"] = root_args[-1].tolist()
    del calls
    torch.cuda.empty_cache()
    return root, perm0


def mode_summary(booster, curve, launches) -> dict:
    return dict(tree_summary(booster), launches=launches,
                trees=booster.num_iterations,
                auc={"tree_1": curve[0], "last": curve[-1]})


def phase_goss(dt, a, ds, dv, Xv, yv, dev, report) -> tuple:
    """Phase 24: GOSS at the headline config, validated."""
    import numpy as np
    import torch

    from dryad_tpu_torch.engine import goss, hist, loop_state
    from dryad_tpu_torch.metrics import auc
    from dryad_tpu_torch.objectives import Binary

    params = dict(GOSS, num_trees=MODE_TREES)
    p = dt.Params.from_dict(params)
    N = ds.num_rows
    for it in (0, 1):
        u = goss.goss_uniform_dev(p.seed, it, N, dev)
        check(np.array_equal(u.cpu().numpy(),
                             loop_state.goss_uniform(p, it, N)),
              f"goss: the card's uniforms of iteration {it} differ from "
              "the numpy copy")
    # iteration 0's selection on the card and on the CPU
    y_dev = torch.from_numpy(ds.y).to(dev)
    g, h = Binary().grad_hess(torch.full_like(y_dev, float(
        Binary().init_score(ds.y))), y_dev)
    u = goss.goss_uniform_dev(p.seed, 0, N, dev)
    ones = torch.ones(N, dtype=torch.bool, device=dev)
    args = (p, N, g[:, None], h[:, None], u, ones)
    card = goss.goss_select(*args)
    cpu = goss.goss_select(p, N, g[:, None].cpu(), h[:, None].cpu(),
                           u.cpu(), ones.cpu())
    for name, x, z in zip(("g", "h", "mask"), card, cpu):
        check(torch.equal(x.cpu(), z), f"goss: the card's selection ({name})"
              " differs from the CPU's")
    kept = int(card[2].sum())
    sel_ms = time_ms(lambda: goss.goss_select(*args), a.reps)
    shifts = {"goss": hist.fixed_point_shift(card[0][:, 0], card[1][:, 0],
                                             N).tolist(),
              "unsampled": hist.fixed_point_shift(g, h, N).tolist()}
    del card, cpu, args, u, ones, g, h, y_dev
    root, perm0 = root_and_move(dt, a, params, ds, dev, kept, "goss")

    booster, launches, curve = train_valid(dt, params, ds, dv, dev)
    n = booster.num_iterations
    check_launches(launches, {"hist": 9 * n, "perm": 8 * n}, "goss")
    b2, _, curve2 = train_valid(dt, params, ds, dv, dev)
    same_trees(booster, b2, "goss")
    check(curve2 == curve, "goss: a second run's evals differ")
    raw = predict_rows(booster, Xv, raw_score=True, device=dev)
    check(np.array_equal(raw, predict_rows(booster, Xv, raw_score=True,
                                         device="cpu")),
          "goss: card predict != CPU predict")
    host = auc(yv, raw)
    check(abs(curve[-1] - host) <= 1e-5,
          f"goss: last valid_auc {curve[-1]} vs host AUC {host}")
    check(curve[-1] > curve[0] and curve[-1] > 0.70,
          f"goss: AUC {curve[0]} -> {curve[-1]}")
    prof = profile_tree(params, ds, dev, "profile_goss_tree.txt")
    rep = dict(mode_summary(booster, curve, launches), kept_rows=kept,
               selection_ms=sel_ms, fixed_point_shift=shifts,
               busy_share=prof.get("busy_share", "not measured"),
               profile=prof, hist_root=brief(root), perm_level0=brief(perm0))
    print("goss: " + json.dumps(rep), flush=True)
    print("goss: uniforms and selection card = CPU bitwise; K1 root and K2 "
          "level 0 under the mask bitwise; second run and predict bitwise",
          flush=True)
    report["goss"] = rep
    return launches, root, perm0


def phase_monotone(dt, a, ds, Xv, yv, dev, report) -> tuple:
    """Phase 25: monotone constraints on features 6-9, depthwise and
    leaf-wise, both wired."""
    import numpy as np
    import torch

    from dryad_tpu_torch.engine import levelwise, split
    from dryad_tpu_torch.metrics import auc

    w1 = higgs_w1(ds.num_rows + len(yv), report["seed"])
    mono = [0] * ds.num_features
    for f in MONO_FEATURES:
        mono[f] = 1 if w1[f] > 0 else -1
    base = dict(MODE_BASE, monotone_constraints=mono, num_trees=MODE_TREES)
    nb, ng = MONO_GRID
    rep, by_path = {"constraints": mono}, {}
    for what, params in (("depthwise", base),
                         ("leafwise", dict(base, growth="leafwise"))):
        booster, launches, _ = train_counted(dt, params, ds, dev)
        n = booster.num_iterations
        check_launches(launches, {"hist": 9 * n, "perm": 8 * n},
                       f"monotone {what}")
        worst = 0.0
        for f in MONO_FEATURES:
            pts = np.repeat(Xv[:nb], ng, axis=0)
            pts[:, f] = np.tile(np.linspace(Xv[:, f].min(), Xv[:, f].max(),
                                            ng, dtype=np.float32), nb)
            s = dt.predict(booster, pts, raw_score=True,
                           device=dev).reshape(nb, ng)
            d = float((mono[f] * np.diff(s, axis=1)).min())
            worst = min(worst, d)
            check(d >= -1e-6, f"monotone {what}: feature {f} moves against "
                  f"its sign by {d}")
        a1 = auc(yv, predict_rows(booster, Xv, num_iteration=1, device=dev))
        a_last = auc(yv, predict_rows(booster, Xv, device=dev))
        check(a_last > a1, f"monotone {what}: AUC {a1} -> {a_last}")
        rep[what] = dict(tree_summary(booster), launches=launches,
                         auc={"tree_1": a1, "last": a_last},
                         worst_step=worst)
        by_path[f"monotone_{what}"] = launches
    # the scan of the widest depthwise level, with and without its arm
    calls = capture(dt, base, ds, dev,
                    {"scan": (levelwise, "find_best_split")})
    sa, skw = calls["scan"][-1]
    free = {k: v for k, v in skw.items() if k not in ("monotone", "lo",
                                                      "hi")}
    rep["scan_ms"] = {
        "monotone": time_ms(lambda: split.find_best_split(*sa, **skw),
                            a.reps),
        "unconstrained": time_ms(lambda: split.find_best_split(*sa, **free),
                                 a.reps),
        "candidates": int(sa[0].shape[0])}
    del calls, sa, skw, free
    torch.cuda.empty_cache()
    print("monotone: " + json.dumps(rep), flush=True)
    print(f"monotone: predict monotone along features {MONO_FEATURES} over "
          f"{nb} x {ng} grids on both growers", flush=True)
    report["monotone"] = rep
    return by_path


def phase_dart(dt, a, ds, dv, Xv, yv, dev, report) -> dict:
    """Phase 26: DART at the headline config, validated."""
    import numpy as np

    from dryad_tpu_torch.engine import train as engine_train
    from dryad_tpu_torch.engine.loop_state import dart_drop_set
    from dryad_tpu_torch.metrics import auc

    params = dict(DART, num_trees=MODE_TREES)
    p = dt.Params.from_dict(params)
    K = p.num_outputs
    n_valid = len(yv)
    drops, valid_out = [], []
    real = {k: getattr(engine_train, k) for k in ("dart_drop", "add_tree",
                                                  "accumulate")}

    def spy_drop(out, score, tids, *rest):
        drops.append(sorted(set((np.asarray(tids) // K).tolist())))
        return real["dart_drop"](out, score, tids, *rest)

    def keep(name):
        def f(*args):
            r = real[name](*args)
            if r.shape[0] == n_valid:
                valid_out[:] = [r]
            return r
        return f

    engine_train.dart_drop = spy_drop
    engine_train.add_tree = keep("add_tree")
    engine_train.accumulate = keep("accumulate")
    try:
        booster, launches, curve = train_valid(dt, params, ds, dv, dev)
    finally:
        for k, f in real.items():
            setattr(engine_train, k, f)
    n = booster.num_iterations
    check_launches(launches, {"hist": 9 * n, "perm": 8 * n}, "dart")
    want = [dart_drop_set(p, it, it).tolist() for it in range(n)]
    check(any(want), "dart: no iteration dropped")
    check(drops == [w for w in want if w],
          f"dart: drops {drops} differ from dart_drop_set's {want}")
    final = valid_out[0].reshape(n_valid, -1)[:, 0].cpu().numpy()
    check(np.array_equal(final, predict_rows(booster, Xv, raw_score=True,
                                           device="cpu")),
          "dart: the trainer's final valid scores differ from CPU predict")
    check(booster.best_iteration == -1, "dart: a best iteration was kept")
    host = auc(yv, final)
    check(abs(curve[-1] - host) <= 1e-5,
          f"dart: last valid_auc {curve[-1]} vs host AUC {host}")
    check(curve[-1] > curve[0] and curve[-1] > 0.70,
          f"dart: AUC {curve[0]} -> {curve[-1]}")
    ts = booster.tree_seconds
    drop_its = [it for it in range(n) if want[it]]
    rest = [ts[it] for it in range(1, n) if not want[it]]
    rep = dict(mode_summary(booster, curve, launches),
               drop_iterations=drop_its,
               dropped_per_drop=[len(w) for w in want if w],
               drop_iteration_ms=[ts[it] * 1e3 for it in drop_its],
               other_iteration_ms_mean=(sum(rest) / len(rest) * 1e3
                                        if rest else None))
    print("dart: " + json.dumps(rep), flush=True)
    print("dart: drop sets = dart_drop_set's; final valid scores bitwise "
          "CPU predict; no best iteration", flush=True)
    report["dart"] = rep
    return launches


def phase_rf(dt, a, ds, dv, Xv, yv, dev, report) -> tuple:
    """Phase 27: rf at the headline config, validated."""
    import numpy as np

    from dryad_tpu_torch.engine.loop_state import sample_masks
    from dryad_tpu_torch.metrics import auc

    params = dict(RF, num_trees=MODE_TREES)
    bag = int(np.count_nonzero(sample_masks(
        dt.Params.from_dict(params), 0, ds.num_rows, ds.num_features)[0]))
    root, _ = root_and_move(dt, a, params, ds, dev, bag, "rf")
    booster, launches, curve = train_valid(dt, params, ds, dv, dev)
    n = booster.num_iterations
    check_launches(launches, {"hist": 9 * n, "perm": 8 * n}, "rf")
    raw = predict_rows(booster, Xv, raw_score=True, num_iteration=n,
                     device=dev)
    check(np.array_equal(raw, predict_rows(booster, Xv, raw_score=True,
                                         num_iteration=n, device="cpu")),
          "rf: card predict != CPU predict")
    host = auc(yv, raw)
    check(abs(curve[-1] - host) <= 1e-5,
          f"rf: last valid_auc {curve[-1]} vs the AUC of averaged predict "
          f"{host}")
    rep = dict(mode_summary(booster, curve, launches), bag_rows=bag,
               host_auc_last=host, hist_root=brief(root))
    print("rf: " + json.dumps(rep), flush=True)
    print("rf: the streamed metric scores the averaged model; card predict "
          "bitwise CPU", flush=True)
    report["rf"] = rep
    return launches, root


def phase_mode_fixtures(dt, a, dev, report) -> tuple:
    """Phase 28: GOSS, monotone, DART and rf on the 50k-row fixture."""
    import tempfile

    import numpy as np
    import torch

    from dryad_tpu_torch import datasets
    from dryad_tpu_torch.engine import (
        cuda_build,
        grower,
        hist,
        hist_nat,
        leafwise_fast,
    )
    from dryad_tpu_torch.engine.goss import goss_columns
    from dryad_tpu_torch.objectives import Binary

    X, y = datasets.higgs_like(50_000, seed=43)
    ds = dt.Dataset(X, y, max_bins=64)
    fix = {"objective": "binary", "num_trees": 4, "num_leaves": 128,
           "max_bins": 64, "growth": "depthwise", "max_depth": 8}
    mono = [0] * 6 + [1, -1, 1, -1]
    rep, launches, nat = {}, {}, None
    for what, params in (("goss", dict(fix, boosting="goss")),
                         ("monotone", dict(fix, monotone_constraints=mono))):
        b_w = dt.train(params, ds, device=dev)
        legacy = dict(params, deep_layout="legacy")
        calls = capture(dt, legacy, ds, dev,
                        {"rows": (hist, "hist_rows"),
                         "nat": (hist_nat, "build_hist_nat")})
        check(len(calls["nat"]) > 0 and len(calls["rows"]) > 0,
              f"{what} fixture: the legacy tree made no K3 or no K1 "
              "row-mode call")
        if nat is None:
            nat = check_nat(calls["nat"][-1], f"{what} fixture nat", a.reps)
            rows = check_rows(calls["rows"][-1][0], f"{what} fixture rows",
                              a.reps)
        del calls
        cuda_build.reset_counts()
        b_l = dt.train(legacy, ds, device=dev)
        launches[what] = dict(cuda_build.counts)
        for k in ("feature", "threshold", "left", "right", "default_left"):
            check(np.array_equal(b_w.arrays[k], b_l.arrays[k]),
                  f"{what} fixture, wired vs legacy: {k!r} differs")
        dv = float(np.abs(b_w.arrays["value"] - b_l.arrays["value"]).max())
        check(dv <= 1e-5, f"{what} fixture, wired vs legacy: values differ "
              f"by {dv}")
        # leaf-wise depth 8: batched = sequential on iteration 0's inputs
        p = dt.Params.from_dict(dict(params, growth="leafwise"))
        yt = torch.from_numpy(ds.y).to(dev)
        gh = [Binary().grad_hess(torch.full_like(
            yt, float(Binary().init_score(ds.y))), yt)]
        bag = torch.ones(ds.num_rows, dtype=torch.bool, device=dev)
        if p.boosting == "goss":
            gh, bag = goss_columns(p, 0, gh, bag)
        args = (p, ds.mapper.total_bins,
                torch.from_numpy(ds.X_binned).to(dev), *gh[0], bag,
                torch.ones(ds.num_features, dtype=torch.bool, device=dev))
        bat = leafwise_fast.grow_tree_leafwise_batched(*args)
        seq = grower.grow_tree(*args)
        for k in ("feature", "threshold", "left", "right", "default_left",
                  "row_leaf", "value", "cover"):
            check(torch.equal(bat[k], seq[k]),
                  f"{what} fixture, batched vs sequential: {k!r} differs")
        rep[what] = {"wired_vs_legacy_max_value_diff": dv,
                     "legacy_launches": launches[what],
                     "batched_vs_sequential": "bitwise equal"}

    class Crash(RuntimeError):
        pass

    def crash(it, info):
        if it == 7:
            raise Crash

    small = dict(fix, max_depth=6, num_leaves=40, num_trees=12)
    for what, params in (("dart", dict(small, boosting="dart", drop_rate=0.3,
                                       skip_drop=0.2)),
                         ("rf", dict(small, boosting="rf", subsample=0.7,
                                     colsample=0.8))):
        straight = dt.train(params, ds, device=dev)
        with tempfile.TemporaryDirectory(dir=OUT) as ckdir:
            try:
                dt.train(params, ds, device=dev, checkpoint_dir=ckdir,
                         checkpoint_every=3, callback=crash)
                fail(f"{what} resume: the crash did not stop the run")
            except Crash:
                pass
            resumed = dt.train(params, ds, device=dev, checkpoint_dir=ckdir,
                               checkpoint_every=3, resume=True)
        same_trees(straight, resumed, f"{what} resume")
        check(np.array_equal(
            dt.predict(straight, X, raw_score=True, device=dev),
            dt.predict(resumed, X, raw_score=True, device=dev)),
            f"{what} resume: predict differs")
        rep.setdefault(what, {})["resume"] = "bitwise equal (crash at 7)"
    # card = CPU trees for each mode
    card_cpu = {}
    for what, params in (("goss", dict(small, boosting="goss")),
                         ("monotone", dict(small, monotone_constraints=mono)),
                         ("dart", dict(small, boosting="dart",
                                       drop_rate=0.3, skip_drop=0.2)),
                         ("rf", dict(small, boosting="rf", subsample=0.7,
                                     colsample=0.8))):
        params = dict(params, num_trees=4)
        b_c = dt.train(params, ds, device=dev)
        b_h = dt.train(params, ds, device="cpu")
        for k in ("feature", "threshold", "left", "right", "default_left"):
            check(np.array_equal(b_c.arrays[k], b_h.arrays[k]),
                  f"{what} fixture, card vs CPU: {k!r} differs")
        dv = float(np.abs(b_c.arrays["value"] - b_h.arrays["value"]).max())
        check(dv <= 1e-4, f"{what} fixture, card vs CPU: values differ by "
              f"{dv}")
        card_cpu[what] = dv
    rep["card_vs_cpu_max_value_diff"] = card_cpu
    rep["nat_level"], rep["rows_level"] = brief(nat), brief(rows)
    print("mode fixtures: " + json.dumps(rep), flush=True)
    report["mode_fixtures"] = rep
    return launches, nat, rows


# the histogram kernels' launch shape and both bounds
# ---- phases 29-31: the rest of the user API (M16) --------------------------
CV = dict(MODE_BASE, num_trees=10)
CV_FOLDS = 3                     # of 5, for the script's time
CV_SHORT = 3
SOA_ROWS = 100_000
SOA_BASE = 4096          # first feature id past the packed words' 12 bits
SHAP_ROWS = 200                  # of 2,000, for the script's time
REFIT_ROWS = 250_000             # of the 1M held-out rows, for the time
EST_TREES = 10


def phase_cv(dt, ds, dev, report) -> dict:
    """Phase 29: ``cv`` at the headline config on the Higgs rows: 5
    stratified folds of 10 trees, AUC every iteration."""
    import numpy as np

    from dryad_tpu_torch.cv import _fold_indices
    from dryad_tpu_torch.engine import cuda_build
    from dryad_tpu_torch.metrics import auc

    folds = _fold_indices(ds.y, CV_FOLDS, True, True, 0)
    check(np.array_equal(np.sort(np.concatenate(folds)),
                         np.arange(ds.num_rows)),
          "cv: the folds do not partition the rows")
    cuda_build.reset_counts()
    t0 = time.perf_counter()
    res = dt.cv(CV, ds, nfold=CV_FOLDS, device=dev, return_boosters=True)
    seconds = time.perf_counter() - t0
    launches = dict(cuda_build.counts)
    n = CV["num_trees"] * CV_FOLDS
    check_launches(launches, {"hist": 9 * n, "perm": 8 * n}, "cv")
    mean = res["valid_auc-mean"]
    check(len(mean) == CV["num_trees"] and mean[-1] > mean[0],
          f"cv: the mean AUC curve {mean} does not rise")
    host_last, fold_train_s = [], []
    for b, hold in zip(res["boosters"], folds):
        curve = b.train_state["eval_history"]["valid_auc"]
        raw = b.predict_binned(ds.X_binned[hold], raw_score=True,
                               device=dev)
        host = auc(ds.y[hold], raw)
        check(abs(curve[-1][1] - host) <= 1e-5,
              f"cv: a fold's last AUC {curve[-1][1]} vs host {host}")
        host_last.append(host)
        fold_train_s.append(sum(b.tree_seconds))
    short = dt.cv(dict(CV, num_trees=CV_SHORT), ds, nfold=CV_FOLDS,
                  device=dev, return_boosters=True)
    check(short["valid_auc-mean"] == mean[:CV_SHORT]
          and short["valid_auc-stdv"] == res["valid_auc-stdv"][:CV_SHORT],
          "cv: 3 trees a fold differ from the first 3 iterations of 10")
    for bs, b in zip(short["boosters"], res["boosters"]):
        for k, v in bs.tree_arrays().items():
            check(np.array_equal(v, b.tree_arrays()[k][:CV_SHORT]),
                  f"cv: a 3-tree fold's {k!r} differs from the 10-tree's")
    rep = {"folds": CV_FOLDS, "trees": CV["num_trees"],
           "fold_rows": [int(len(h)) for h in folds],
           "seconds": seconds, "seconds_per_fold": seconds / CV_FOLDS,
           "fold_train_seconds": fold_train_s,
           "auc_mean": mean, "auc_stdv": res["valid_auc-stdv"],
           "host_auc_last": host_last, "launches": launches}
    print("cv: " + json.dumps(rep), flush=True)
    print("cv: folds partition the rows; last AUCs = host; 3-tree folds "
          "bitwise the first 3 of 10", flush=True)
    report["cv"] = rep
    return launches


def widened(booster, Xb):
    """``booster`` with every split feature moved to SOA_BASE + f (past
    the packed words), and ``Xb``'s columns placed there in a wider
    matrix."""
    import numpy as np

    ta = booster.tree_arrays()
    ta["feature"] = np.where(ta["feature"] >= 0, ta["feature"] + SOA_BASE,
                             -1)
    Xw = np.zeros((Xb.shape[0], SOA_BASE + Xb.shape[1]), Xb.dtype)
    Xw[:, SOA_BASE:] = Xb
    return type(booster)(booster.params, booster.mapper, ta,
                         booster.init_score, booster.max_depth_seen), Xw


def phase_model_api(dt, booster, Xv, yv, dev, report) -> None:
    """Phase 30: pred_leaf, the SoA arm, TreeSHAP, refit, the text model
    and feature importance on the headline booster."""
    import numpy as np
    import torch

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    Xb = booster.mapper.transform(Xv)
    rep: dict = {"bin_seconds": time.perf_counter() - t0}
    # pred_leaf of the held-out rows; the leaves' values add to the raw
    # scores in tree order
    t0 = time.perf_counter()
    leaves = booster.predict_binned(Xb, pred_leaf=True, device=dev)
    rep["pred_leaf_s"] = time.perf_counter() - t0
    check(leaves.shape == (Xb.shape[0], booster.num_total_trees)
          and leaves.dtype == np.int32, f"pred_leaf shape {leaves.shape}")
    check(np.array_equal(leaves, booster.predict_binned(
        Xb, pred_leaf=True, device=cpu)), "pred_leaf: card != CPU")
    raw = booster.predict_binned(Xb, raw_score=True, device=dev)
    score = np.full(Xb.shape[0], booster.init_score[0], np.float32)
    for t in range(leaves.shape[1]):
        score += booster.arrays["value"][t, leaves[:, t]]
    check(np.array_equal(score, raw), "pred_leaf: init + leaf values != "
          "the raw predict")
    # the SoA arm: features re-indexed past the packed words
    wide, Xw = widened(booster, Xb[:SOA_ROWS])
    t0 = time.perf_counter()
    soa = wide.predict_binned(Xw, raw_score=True, device=dev)
    rep["soa_predict_s"] = time.perf_counter() - t0
    check(np.array_equal(soa, raw[:SOA_ROWS]),
          "SoA arm: predict != the packed arm's")
    check(np.array_equal(wide.predict_binned(Xw, pred_leaf=True,
                                             device=dev),
                         leaves[:SOA_ROWS]),
          "SoA arm: pred_leaf != the packed arm's")
    del Xw
    # TreeSHAP on a few thousand rows, card against CPU
    Xs = Xb[:SHAP_ROWS]
    t0 = time.perf_counter()
    phi = booster.predict_binned(Xs, pred_contrib=True, device=dev)
    shap_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    phi_cpu = booster.predict_binned(Xs, pred_contrib=True, device=cpu)
    shap_cpu_s = time.perf_counter() - t0
    err = float(np.abs(phi - phi_cpu).max())
    check(err <= 1e-9, f"SHAP: card vs CPU differ by {err}")
    eff = float(np.abs(phi.sum(axis=1) - raw[:SHAP_ROWS]).max())
    check(eff <= 1e-5, f"SHAP: contributions + bias miss predict by {eff}")
    rep["shap"] = {"rows": SHAP_ROWS, "trees": booster.num_total_trees,
                   "seconds": shap_s, "rows_per_s": SHAP_ROWS / shap_s,
                   "cpu_seconds": shap_cpu_s, "card_vs_cpu": err,
                   "efficiency_err": eff}
    # refit of every tree on the held-out rows
    Xr, yr = Xv[:REFIT_ROWS], yv[:REFIT_ROWS]
    t0 = time.perf_counter()
    r1 = booster.refit(Xr, yr, decay_rate=0.9, device=dev)
    refit_s = time.perf_counter() - t0
    r2 = booster.refit(Xr, yr, decay_rate=0.9, device=dev)
    check(np.array_equal(r1.arrays["value"], r2.arrays["value"]),
          "refit: two card runs differ")
    t0 = time.perf_counter()
    rc = booster.refit(Xr, yr, decay_rate=0.9, device=cpu)
    refit_cpu_s = time.perf_counter() - t0
    for k, v in rc.tree_arrays().items():
        if k != "value":
            check(np.array_equal(v, r1.tree_arrays()[k]),
                  f"refit: card and CPU {k!r} differ")
    check(np.allclose(r1.arrays["value"], rc.arrays["value"], rtol=1e-5,
                      atol=1e-6), "refit: card vs CPU values")
    check(not np.array_equal(r1.arrays["value"], booster.arrays["value"]),
          "refit: no value moved")
    same = booster.refit(Xr, yr, decay_rate=1.0, device=dev)
    check(np.array_equal(same.arrays["value"], booster.arrays["value"]),
          "refit: decay 1.0 changed a value")
    rep["refit"] = {"rows": Xr.shape[0], "seconds": refit_s,
                    "cpu_seconds": refit_cpu_s,
                    "card_vs_cpu": float(np.abs(
                        r1.arrays["value"] - rc.arrays["value"]).max())}
    # the text model, and the split counts
    text = dt.Booster.from_text(booster.dump_text())
    check(np.array_equal(text.predict_binned(Xb, raw_score=True,
                                             device=dev), raw),
          "text model: the round trip predicts differently")
    split = booster.feature_importance("split")
    check(int(split.sum()) == int((booster.arrays["feature"] >= 0).sum()),
          "feature_importance: split counts != internal nodes")
    rep["gain_top3"] = [int(f) for f in np.argsort(
        -booster.feature_importance("gain"))[:3]]
    print("model api: " + json.dumps(rep), flush=True)
    print("model api: pred_leaf card = CPU and sums to predict; SoA = "
          "packed; SHAP card = CPU, efficient; refit card = CPU, "
          "repeatable; text round trip bitwise", flush=True)
    report["model_api"] = rep


def phase_estimator(dt, dev, report) -> dict:
    """Phase 31: ``DryadClassifier`` at its defaults on the raw Covertype
    rows, labels ``y * 10 + 3``."""
    import numpy as np

    from dryad_tpu_torch import datasets
    from dryad_tpu_torch.engine import cuda_build
    from dryad_tpu_torch.sklearn import DryadClassifier

    X, y = datasets.covertype_like(COV_ROWS + COV_HOLDOUT, COV_FEATURES,
                                   COV_CLASSES, seed=11)
    labels = y[:COV_ROWS] * 10 + 3
    clf = DryadClassifier(num_trees=EST_TREES, device=dev)
    cuda_build.reset_counts()
    t0 = time.perf_counter()
    clf.fit(X[:COV_ROWS], labels)
    fit_s = time.perf_counter() - t0
    launches = dict(cuda_build.counts)
    b = clf.booster_
    check(np.array_equal(clf.classes_, np.arange(COV_CLASSES) * 10 + 3),
          f"estimator: classes_ {clf.classes_}")
    check(b.params.max_depth == 9 and b.num_total_trees == EST_TREES * 7,
          f"estimator: depth {b.params.max_depth}, "
          f"{b.num_total_trees} trees")
    n = b.num_total_trees
    check_launches(launches, {"hist": 10 * n, "perm": 9 * n}, "estimator")
    Xh = X[COV_ROWS:]
    proba = clf.predict_proba(Xh)
    check(proba.shape == (COV_HOLDOUT, COV_CLASSES)
          and float(np.abs(proba.sum(axis=1) - 1).max()) <= 1e-5,
          "estimator: predict_proba rows do not sum to 1")
    check(np.array_equal(proba, dt.predict(b, Xh, device=dev)),
          "estimator: predict_proba != dryad_tpu_torch.predict")
    acc = float((clf.predict(Xh) == y[COV_ROWS:] * 10 + 3).mean())
    rep = dict(tree_summary(b), fit_seconds=fit_s, launches=launches,
               holdout_accuracy=acc)
    print("estimator: " + json.dumps(rep), flush=True)
    report["estimator"] = rep
    return launches


_SHAPE_KEYS = ("smem_bytes", "blocks", "features_per_block",
               "bytes_bound_ms", "update_bound_ms")


# 50 trees of the north star's 500, for the script's time
SERVE = dict(MODE_BASE, num_trees=50)
SERVE_SMALL = {"objective": "regression", "growth": "depthwise",
               "max_depth": 6, "num_leaves": 63, "max_bins": 256,
               "learning_rate": 0.1, "num_trees": 20}
SERVE_BUCKETS = (1, 8, 64, 512, 4096)    # latency is measured at these
SERVE_SHAPES = (1, 7, 8, 9, 63, 64, 100, 511, 512, 4095, 4096, 5000)
# sequential requests per bucket, and the bulk bench's windows: cut from
# 500 and 4 s, then to 150 and 100 requests, for the script's time
SERVE_LAT_REQS = 100
SERVE_BULK = dict(clients=4, sizes=(4096,), duration_s=2.5, arms=2)


def serve_launches(fn) -> int:
    """Device kernels (and copies) one call of ``fn`` launches, from
    torch.profiler; 0 when the profiler sees no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def device_table_bytes(entry, dev) -> int:
    """Bytes of one staged model's tables on the card."""
    state = entry.device_state(dev)      # staged already: no upload
    tensors = ([*state["table"].values()] if isinstance(state["table"], dict)
               else [state["table"]])
    tensors += [state["value"], state["init"]]
    if state["bitset"] is not None:
        tensors.append(state["bitset"])
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_serve(dt, a, ds, Xv, yv, dev, report) -> dict:
    """Phase 32: the serving stack on the headline model.  Trains it at
    ``serve_trees`` trees on phase 2's rows, saves it, serves it from the
    saved file beside a second, named model (a text file), and checks
    served = direct predict on the card bitwise at every request shape,
    = CPU predict on a 10k-row sample, no capture after warmup, /healthz
    200, an eviction's freed device memory and re-stage, and one HTTP
    round trip.  Prints the seconds of each step (``step_seconds``).
    Returns the training run's launches."""
    import tempfile
    import threading
    import urllib.request

    import numpy as np
    import torch

    from dryad_tpu_torch.engine import predict as P
    from dryad_tpu_torch.dataset import binned_to_device
    from dryad_tpu_torch.metrics import auc
    from dryad_tpu_torch.obs.health import healthz_payload
    from dryad_tpu_torch.serve import (PredictServer, bucket_rows,
                                       run_bench_compare)
    from dryad_tpu_torch.serve.http import make_http_server

    steps, clock = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        steps[name] = now - clock[0]
        clock[0] = now

    T = a.serve_trees
    booster, launches, peak = train_counted(dt, dict(SERVE, num_trees=T),
                                            ds, dev)
    lap("train")
    check_launches(launches, {"hist": 9 * T, "perm": 8 * T}, "serve train")
    Xvb = booster.mapper.transform(Xv)        # binned once for both AUCs
    auc10 = auc(yv, booster.predict_binned(Xvb, num_iteration=10,
                                           device=dev))
    auc_last = auc(yv, booster.predict_binned(Xvb, device=dev))
    del Xvb
    check(auc_last > auc10 and auc_last > 0.70,
          f"serve: held-out AUC {auc10} at 10 trees, {auc_last} at {T}")
    train = dict(tree_summary(booster), peak_bytes=peak, launches=launches,
                 auc={"tree_10": auc10, "last": auc_last},
                 train_seconds=sum(booster.tree_seconds))
    print("serve train: " + json.dumps(train), flush=True)
    small = dt.train(SERVE_SMALL, ds, device=dev)

    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "headline.dryad")
    small_path = os.path.join(tmp.name, "small.json")
    booster.save(path)
    small.save_text(small_path)
    rep: dict = {"trees": T, "train": train,
                 "model_file_bytes": os.path.getsize(path)}
    server = PredictServer(device=dev)
    v1 = server.load_model(path)
    v2 = server.load_model(small_path, name="small", activate=False)
    e1 = server.registry.get(v1)
    check(e1.booster.num_iterations == T, "serve: the saved model's trees")
    lap("auc_small_model_files")

    # launches of one bucket call of the tree-at-once program (eager) and
    # of the per-tree accumulate, and the two results, on the same 64 rows
    st = e1.device_state(dev)
    x64 = binned_to_device(booster.mapper.transform(Xv[:64]), dev)
    args = (st["table"], st["value"], x64, st["init"], e1.depth_bound,
            st["bitset"])
    rep["launches_per_bucket_call"] = serve_launches(
        lambda: P.forest_scores(*args))
    rep["accumulate_launches_per_call"] = serve_launches(
        lambda: P.accumulate(*args))
    check(torch.equal(P.forest_scores(*args), P.accumulate(*args)),
          "serve: forest_scores != accumulate")
    del st, x64, args
    lap("launch_counts")

    t0 = time.perf_counter()
    touched = server.warmup()
    rep["warmup_seconds"] = time.perf_counter() - t0
    nb = len(server.cache.buckets())
    check(touched == 2 * nb, f"serve: warmup touched {touched}")
    rep["capture_seconds"] = {
        f"v{k[0]}/{k[1]}": s for k, s in sorted(server.cache.capture_s.items())}
    compiles = server.stats()["cache_compiles"]
    check(compiles == 2 * nb, f"serve: {compiles} captures in warmup")
    rep["staged_device_bytes"] = {
        "headline": device_table_bytes(e1, dev),
        "small": device_table_bytes(server.registry.get(v2), dev)}
    rep["registry_memory"] = server.registry.memory()
    lap("warmup")
    # where a bucket call's time goes: the graph's replay (device ms, CUDA
    # events) and binning the raw rows on the host
    pool = Xv[:20_000]
    split = {}
    with server.cache._device_lock:
        for n in SERVE_BUCKETS:
            gs = server.cache._graphs.get((v1, bucket_rows(n), 1))
            check(gs is not None, f"serve: no graph of bucket {n}")
            g = gs[0]
            t0 = time.perf_counter()
            for _ in range(10):
                booster.mapper.transform(pool[:n])
            split[n] = {"bucket": bucket_rows(n),
                        "replay_ms": time_ms(g.graph.replay, 20),
                        "binning_ms": (time.perf_counter() - t0) / 10 * 1e3}
    del g, gs              # a graph holds its version's tables alive
    rep["bucket_call_split"] = split
    lap("bucket_call_split")

    n_max = max(SERVE_SHAPES)
    direct = {raw: booster.predict(Xv[:n_max], raw_score=raw, device=dev)
              for raw in (True, False)}
    direct_small = small.predict(Xv[:n_max], device=dev)
    with server:
        # each request shape against the direct predict of its rows (a
        # slice of one predict: predict is per row)
        for n in SERVE_SHAPES:
            for raw in (True, False):
                got = server.predict(Xv[:n], raw_score=raw, timeout=120)
                want = direct[raw][:n]
                check(got.dtype == want.dtype and np.array_equal(got, want),
                      f"serve: {n} rows (raw={raw}) != direct card predict")
            got = server.predict(Xv[:n], model="small", timeout=120)
            check(np.array_equal(got, direct_small[:n]),
                  f"serve: the small model's {n} rows != direct")
        got = server.predict(Xv[:10_000], raw_score=True, timeout=120)
        check(np.array_equal(got, booster.predict(
            Xv[:10_000], raw_score=True, device="cpu")),
            "serve: 10k rows served != CPU predict")
        # concurrent mixed requests: each answer a slice of one predict
        direct = booster.predict(pool, raw_score=True, device=dev)
        bad = []

        def client(ci):
            rng = np.random.default_rng(100 + ci)
            for _ in range(20):
                n = int(rng.choice((1, 9, 100, 700, 3000)))
                s0 = int(rng.integers(0, len(pool) - n))
                out = server.predict(pool[s0:s0 + n], raw_score=True,
                                     timeout=120)
                if not np.array_equal(out, direct[s0:s0 + n]):
                    bad.append((ci, n, s0))

        threads = [threading.Thread(target=client, args=(ci,), daemon=True)
                   for ci in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        check(not any(t.is_alive() for t in threads) and not bad,
              f"serve: concurrent answers differ: {bad[:3]}")
        lap("bitwise_checks")

        # latency by bucket, one client, sequential requests
        rng = np.random.default_rng(7)
        lat = {}
        for n in SERVE_BUCKETS:
            ms = []
            for _ in range(SERVE_LAT_REQS):
                s0 = int(rng.integers(0, len(pool) - n))
                t0 = time.perf_counter()
                server.predict(pool[s0:s0 + n], timeout=120)
                ms.append((time.perf_counter() - t0) * 1e3)
            lat[n] = {"p50_ms": float(np.percentile(ms, 50)),
                      "p99_ms": float(np.percentile(ms, 99)),
                      "requests": len(ms),
                      "rows_per_s": n / (float(np.mean(ms)) / 1e3)}
        rep["latency_by_bucket"] = lat
        lap("latency")
        stats = server.stats()
        check(stats["cache_compiles"] == compiles,
              f"serve: {stats['cache_compiles'] - compiles} captures after "
              "warmup_complete()")
        code, body = healthz_payload()
        check(code == 200, f"serve: /healthz {code} {body}")

        # one HTTP round trip
        httpd = make_http_server(server, port=0)
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        try:
            req = urllib.request.Request(
                base + "/predict",
                data=json.dumps({"rows": Xv[:5].tolist(),
                                 "raw": True}).encode(),
                headers={"Content-Type": "application/json"})
            out = json.loads(urllib.request.urlopen(req, timeout=60).read())
            health = urllib.request.urlopen(base + "/healthz", timeout=60)
            check(health.status == 200, "serve: HTTP /healthz")
        finally:
            httpd.shutdown()
            httpd.server_close()
            th.join(60)
        check(np.array_equal(np.asarray(out["predictions"], np.float32),
                             booster.predict(Xv[:5], raw_score=True,
                                             device=dev)),
              "serve: the HTTP answer != direct predict")

        # an eviction frees the headline model's tables and graphs
        sync()
        m0 = torch.cuda.memory_allocated()
        server.activate(v2)
        server.registry.budget_bytes = 1
        v3 = server.registry.add(small, activate=False)
        server.registry.get(v3).staged()       # a staging event: evicts v1
        sync()
        m1 = torch.cuda.memory_allocated()
        check(not e1.is_staged and not any(
            k[0] == v1 for k in server.cache._warm),
            "serve: the headline model was not evicted")
        check(m0 - m1 >= rep["staged_device_bytes"]["headline"],
              f"serve: eviction freed {m0 - m1} bytes, less than the "
              f"model's {rep['staged_device_bytes']['headline']} on the card")
        rep["evicted_bytes"] = m0 - m1
        server.activate(v1)
        for n in (9, 4096):
            got = server.predict(Xv[:n], raw_score=True, timeout=120)
            check(np.array_equal(got, booster.predict(
                Xv[:n], raw_score=True, device=dev)),
                f"serve: re-staged {n} rows != direct")
        server.registry.budget_bytes = None
        stats = server.stats()
        check(stats["evictions"] >= 1 and stats["restages"] >= 1,
              "serve: no eviction or re-stage counted")
        code, body = healthz_payload()
        check(code == 200, f"serve: /healthz after a re-stage {code} {body}")
    rep["stats"] = {k: stats[k] for k in (
        "requests", "rows", "batches", "batch_fill_ratio", "p50_ms",
        "p99_ms", "cache_hits", "cache_compiles", "evictions", "restages")}
    del server, e1
    tmp.cleanup()
    lap("http_eviction")

    # bulk rows/s with 4 clients of 4096-row requests, pipeline vs serial
    cmp = run_bench_compare(booster, device=dev, max_batch_rows=4096,
                            max_wait_ms=2.0, feature_pool=pool, seed=0,
                            **SERVE_BULK)
    check(cmp["recompiles_after_warmup"] == 0,
          "serve bench: captures after warmup")
    rep["bulk"] = {arm: {k: cmp[arm][k] for k in (
        "rows_per_s", "rows_per_s_arms", "requests_per_s",
        "bench_requests", "p50_ms", "p99_ms", "batch_fill_ratio",
        "spread_rows_per_s")}
        for arm in ("serial", "pipeline")}
    rep["pipeline_speedup"] = cmp["pipeline_speedup"]
    lap("bulk")
    rep["step_seconds"] = steps
    print("serve: " + json.dumps(rep), flush=True)
    print("serve: served = direct card predict at every shape, = CPU on "
          "10k rows; no capture after warmup; /healthz 200; eviction freed "
          "memory and the re-staged model answers bitwise; HTTP bitwise",
          flush=True)
    report["serve"] = rep
    gc.collect()
    torch.cuda.empty_cache()
    return launches, booster


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _dist_run_report(booster, group, launches, trees: int) -> dict:
    """One rank's run: trees/s, the histogram collectives' bytes, device
    ms and host ms per tree (the fixed-point shift's, the combine's and
    the set-up's beside them), launches."""
    stats = group.stats
    per_tree = {what: {k: v / trees for k, v in st.items() if k != "calls"}
                for what, st in stats.items()}
    return dict(tree_summary(booster), launches=launches,
                collective_bytes_per_tree=per_tree,
                collective_calls=stats,
                collective_ms_per_tree={
                    what: group.collective_ms(what) / trees
                    for what in stats},
                collective_host_ms_per_tree={
                    what: group.collective_host_ms(what) / trees
                    for what in stats},
                eval_history=booster.train_state.get("eval_history"))


def _nccl_vs_single(dt, dd, params, ds, dv, dev) -> dict:
    """One NCCL rank (the process group already joined) against one
    process, on the same config and valid set: trees/s of the two
    interleaved (one process, the rank, twice over), then one whole
    run of each at ``DIST_PROFILE_TREES`` trees under torch.profiler:
    device ms by kernel (set-up included), the tables in
    chiprun_out/profile_dist_{single,nccl}.txt, and the kernels whose
    device time differs most between the two."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dryad_tpu_torch.engine.distributed import RowGroup

    groups: list = []

    def rank(p):
        groups.append(RowGroup.build(ds.num_rows, device=dev))
        return dd.train_distributed(p, ds, dv, group=groups[-1], device=dev)

    def runs(p):
        return {"single": lambda: dt.train(p, ds, [dv], device=dev),
                "nccl": lambda: rank(p)}

    rates: dict = {"single": [], "nccl": []}
    for _ in range(2):                  # of 3, for the script's time
        for name, fn in runs(params).items():
            rates[name].append(tree_summary(fn())["trees_per_s"])
    # the host's time inside the rank's collectives, a tree, by purpose
    out: dict = {"trees_per_s": rates, "collective_host_ms_per_tree": [
        {w: g.collective_host_ms(w) / params["num_trees"] for w in g.stats}
        for g in groups]}
    if dev.type != "cuda":
        out["device_ms"] = "not measured"
        return out
    by: dict = {}
    short = dict(params, num_trees=DIST_PROFILE_TREES)
    for name, fn in runs(short).items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = prof.key_averages()
        by[name] = {e.key: (dev_us(e) / 1e3, e.count) for e in ev
                    if e.device_type == torch.autograd.DeviceType.CUDA}
        with open(os.path.join(OUT, f"profile_dist_{name}.txt"), "w") as f:
            f.write(ev.table(sort_by="self_cuda_time_total", row_limit=60))
    none = (0.0, 0)
    diff = sorted(((by["nccl"].get(k, none)[0] - by["single"].get(k, none)[0],
                    k) for k in set(by["single"]) | set(by["nccl"])),
                  key=lambda t: -abs(t[0]))
    out["profiled_trees"] = DIST_PROFILE_TREES
    out["device_ms_per_run"] = {n: sum(v[0] for v in k.values())
                                for n, k in by.items()}
    # [kernel, nccl - single ms, single (ms, calls), nccl (ms, calls)]
    out["largest_differences"] = [
        [k[:70], d, by["single"].get(k, none), by["nccl"].get(k, none)]
        for d, k in diff[:10]]
    return out


def write_set(d: str, ds, dv=None, split: str = "rows",
              csr=None) -> dict:
    """Write one training set for the rank processes into directory ``d``
    (the mapper, the labels, the binned rows or, with ``csr``, the CSR
    rows; the query offsets; the valid set's binned rows, labels and
    groups) and return its spec entry."""
    import numpy as np

    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "mapper.bin"), "wb") as f:
        f.write(ds.mapper.to_bytes())
    np.save(os.path.join(d, "y.npy"), ds.y)
    if csr is not None:
        np.savez(os.path.join(d, "csr.npz"), indptr=csr[0], indices=csr[1],
                 values=csr[2], F=np.int64(csr[3]))
    else:
        np.save(os.path.join(d, "X.npy"), ds.X_binned)
    if ds.group is not None:
        np.save(os.path.join(d, "offsets.npy"), ds.query_offsets)
    if dv is not None:
        np.save(os.path.join(d, "Xv.npy"), dv.X_binned)
        np.save(os.path.join(d, "yv.npy"), dv.y)
        if dv.group is not None:
            np.save(os.path.join(d, "vgroup.npy"), dv.group)
    return {"kind": "csr" if csr is not None else "binned", "split": split}


def read_set(d: str, meta: dict, rank: int, world: int) -> tuple:
    """This rank's Dataset of a set ``write_set`` wrote (its row block, or
    whole queries for ``split == "query"``), the whole valid set or None,
    and the block's [start, stop)."""
    import numpy as np

    import dryad_tpu_torch as dt
    from dryad_tpu_torch import distributed as dd
    from dryad_tpu_torch.data.sketch import BinMapper

    with open(os.path.join(d, "mapper.bin"), "rb") as f:
        mapper = BinMapper.from_bytes(f.read())
    y = np.load(os.path.join(d, "y.npy"))
    if meta["kind"] == "csr":
        z = np.load(os.path.join(d, "csr.npz"))
        csr = (z["indptr"], z["indices"], z["values"], int(z["F"]))
        lo, hi = dd.host_row_range(y.shape[0], rank, world)
        ds = dt.Dataset(None, y[lo:hi], csr=csr_rows(csr, lo, hi),
                        mapper=mapper)
    else:
        Xb = np.load(os.path.join(d, "X.npy"), mmap_mode="r")
        group = None
        if meta["split"] == "query":
            off = np.load(os.path.join(d, "offsets.npy"))
            lo, hi = dd.query_row_range(off, rank, world)
            group = dd.rank_queries(off, lo, hi)
        else:
            lo, hi = dd.host_row_range(Xb.shape[0], rank, world)
        ds = dt.Dataset.from_binned(np.ascontiguousarray(Xb[lo:hi]), mapper,
                                    y[lo:hi], group=group)
    dv = None
    if os.path.exists(os.path.join(d, "Xv.npy")):
        vg = os.path.join(d, "vgroup.npy")
        dv = dt.Dataset.from_binned(
            np.load(os.path.join(d, "Xv.npy")), mapper,
            np.load(os.path.join(d, "yv.npy")),
            group=np.load(vg) if os.path.exists(vg) else None)
    return ds, dv, (lo, hi)


def rank_main(spec_path: str, rank: int) -> int:
    """The rank process of phases 33 and 35: join the gloo group, read
    this rank's part of each set of the spec (phase 33: the one set in
    the spec's directory), train every run of the spec on its set
    through ``train_distributed`` on the card, and write each run's model
    file and report."""
    import torch

    from dryad_tpu_torch import distributed as dd
    from dryad_tpu_torch.engine import cuda_build
    from dryad_tpu_torch.engine.distributed import RowGroup

    torch.set_num_threads(DIST_RANK_THREADS)
    with open(spec_path) as f:
        spec = json.load(f)
    d, world = spec["dir"], spec["world"]
    dd.initialize(backend="gloo", init_method=f"file://{d}/store",
                  rank=rank, world_size=world, timeout_s=spec["timeout_s"])
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        cuda_build.build_all()
    sets = spec.get("sets", {"": {"kind": "binned", "split": "rows"}})
    out: dict = {}
    loaded: dict = {}
    for name, run in spec["runs"].items():
        sname, params = ((run["set"], run["params"]) if "set" in run
                         else ("", run))
        if sname not in loaded:
            loaded.clear()      # one set's rows held at a time
            loaded[sname] = read_set(os.path.join(d, sname), sets[sname],
                                     rank, world)
            out.setdefault("rows", {})[sname] = list(loaded[sname][2])
        ds, dv, _ = loaded[sname]
        group = RowGroup.build(ds.num_rows, device=dev,
                               time_collectives=True)
        cuda_build.reset_counts()
        booster = dd.train_distributed(params, ds, dv, group=group,
                                       device=dev)
        launches = dict(cuda_build.counts)
        booster.save(os.path.join(d, f"{name}.{rank}.dryad"))
        out[name] = _dist_run_report(booster, group, launches,
                                     params["num_trees"])
        out[name]["max_rank_rows"] = group.max_rank_rows
        out[name]["comm_stats"] = booster.comm_stats
    from dryad_tpu_torch.obs.registry import default_registry

    snap = default_registry().snapshot()
    out["prog"] = {name: dict(fam) for kind in ("counters", "gauges")
                   for name, fam in snap[kind].items()
                   if name.startswith("dryad_prog_")}
    with open(os.path.join(d, f"report.{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()
    return 0


def phase_distributed(dt, a, ds, Xv, yv, dev, report, headline_trees
                      ) -> dict:
    """Phase 33: data-parallel training over a process group (docstring);
    ``headline_trees`` are phase 4's tree arrays."""
    import numpy as np
    import torch

    from dryad_tpu_torch import distributed as dd
    from dryad_tpu_torch.engine import cuda_build

    t0 = time.perf_counter()
    head = {"objective": "binary", "growth": "depthwise", "max_depth": 8,
            "num_leaves": 255, "max_bins": 256, "learning_rate": 0.1,
            "num_trees": a.trees}
    runs = {"fused": head, "feature": dict(head, hist_reduce="feature"),
            "feature_bagged": dict(head, hist_reduce="feature",
                                   subsample=0.8, colsample=0.8)}
    dv = ds.bind(Xv, yv)
    # the yardsticks: one process, no group, the same valid set; the
    # unbagged one's trees are phase 4's (a valid set changes no tree)
    single = {"head": dt.train(head, ds, [dv], device=dev),
              "bagged": dt.train(runs["feature_bagged"], ds, [dv],
                                 device=dev)}
    for k, v in headline_trees.items():
        check(np.array_equal(single["head"].tree_arrays()[k], v),
              f"distributed: the validated single run's {k!r} differs "
              "from phase 4's")
    want = {"fused": single["head"], "feature": single["head"],
            "feature_bagged": single["bagged"]}
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    os.makedirs(DIST_DIR)
    np.save(os.path.join(DIST_DIR, "X.npy"), ds.X_binned)
    np.save(os.path.join(DIST_DIR, "y.npy"), ds.y)
    np.save(os.path.join(DIST_DIR, "Xv.npy"), dv.X_binned)
    np.save(os.path.join(DIST_DIR, "yv.npy"), dv.y)
    with open(os.path.join(DIST_DIR, "mapper.bin"), "wb") as f:
        f.write(ds.mapper.to_bytes())
    spec = os.path.join(DIST_DIR, "spec.json")
    with open(spec, "w") as f:
        json.dump({"dir": DIST_DIR, "world": DIST_RANKS,
                   "timeout_s": DIST_TIMEOUT_S, "runs": runs,
                   "device": (f"cuda:{torch.cuda.current_device()}"
                              if dev.type == "cuda" else "cpu")}, f)
    setup_s = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # (a), (a'), (b): two gloo ranks sharing the card
    t1 = time.perf_counter()
    logs = [open(os.path.join(DIST_DIR, f"rank{r}.log"), "w")
            for r in range(DIST_RANKS)]
    code = ("import sys, chip_smoke; "
            "sys.exit(chip_smoke.rank_main(sys.argv[1], int(sys.argv[2])))")
    procs = [subprocess.Popen([sys.executable, "-c", code, spec, str(r)],
                              cwd=ROOT, stdout=logs[r],
                              stderr=subprocess.STDOUT)
             for r in range(DIST_RANKS)]
    try:
        for p in procs:
            p.wait(timeout=DIST_TIMEOUT_S + 120)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(DIST_DIR, f"rank{r}.log")) as f:
                print(f.read()[-4000:], file=sys.stderr)
        check(p.returncode == 0, f"distributed: rank {r} exited "
              f"{p.returncode}")
    group_s = time.perf_counter() - t1
    ranks = []
    for r in range(DIST_RANKS):
        with open(os.path.join(DIST_DIR, f"report.{r}.json")) as f:
            ranks.append(json.load(f))
    want_launches = {"hist": 9 * a.trees, "perm": 8 * a.trees}
    res: dict = {"setup_s": setup_s, "gloo_group_s": group_s,
                 "rows": [rk["rows"][""] for rk in ranks],
                 "single_process": {k: tree_summary(b)
                                    for k, b in single.items()}}
    print("distributed: one process with the valid set: " + json.dumps(
        res["single_process"]), flush=True)

    def same_run(b, evals, name, who):
        for k, v in want[name].tree_arrays().items():
            check(np.array_equal(b.tree_arrays()[k], v),
                  f"distributed {name}: {who}'s {k!r} differs from the "
                  "single process's")
        check(evals == want[name].train_state.get("eval_history"),
              f"distributed {name}: {who}'s evals differ from the single "
              "process's")

    for name in runs:
        for r in range(DIST_RANKS):
            b = dt.Booster.load(os.path.join(DIST_DIR, f"{name}.{r}.dryad"))
            same_run(b, ranks[r][name]["eval_history"], name, f"rank {r}")
            check_launches(ranks[r][name]["launches"], want_launches,
                           f"distributed {name} rank {r}")
        res[f"gloo_{name}"] = [rk[name] for rk in ranks]
        print(f"distributed gloo x{DIST_RANKS} {name}: "
              + json.dumps({k: v for k, v in ranks[0][name].items()
                            if k != "eval_history"}), flush=True)
    # the ranks kept introspection on: each observed the first tree of
    # each of its runs (their trees are checked bitwise above)
    for r, rk in enumerate(ranks):
        steps = {k: v for k, v in rk["prog"].get(
            "dryad_prog_captures_total", {}).items() if "train.step" in k}
        check(sum(steps.values()) == len(runs),
              f"distributed: rank {r} observed {steps} first trees, not "
              f"{len(runs)}")
        check(any("train.step" in k for k in rk["prog"].get(
            "dryad_prog_wall_ms", {})),
              f"distributed: rank {r} has no dryad_prog_wall_ms")
    res["rank_prog"] = [rk["prog"] for rk in ranks]
    shutil.rmtree(DIST_DIR, ignore_errors=True)

    # (c): one NCCL rank in this process, through initialize() (gloo only
    # in a CPU rehearsal)
    from dryad_tpu_torch.engine.distributed import RowGroup

    dd.initialize(backend="nccl" if dev.type == "cuda" else "gloo",
                  init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                  world_size=1, timeout_s=DIST_TIMEOUT_S)
    try:
        for name in ("fused", "feature"):
            group = RowGroup.build(ds.num_rows, device=dev,
                                   time_collectives=True)
            cuda_build.reset_counts()
            b = dd.train_distributed(runs[name], ds, dv, group=group,
                                     device=dev)
            launches = dict(cuda_build.counts)
            same_run(b, b.train_state.get("eval_history"), name, "NCCL")
            check_launches(launches, want_launches, f"NCCL {name}")
            rep = _dist_run_report(b, group, launches, a.trees)
            res[f"nccl_{name}"] = rep
            print(f"distributed NCCL x1 {name}: " + json.dumps(
                {k: v for k, v in rep.items() if k != "eval_history"}),
                flush=True)
        # (d): where one NCCL rank's time goes against one process's
        res["nccl_vs_single"] = _nccl_vs_single(dt, dd, runs["fused"], ds,
                                                dv, dev)
        print("distributed NCCL x1 vs one process: "
              + json.dumps(res["nccl_vs_single"]), flush=True)
    finally:
        torch.distributed.destroy_process_group()
    res["seconds"] = time.perf_counter() - t0
    print("distributed: every rank's trees bitwise the single process's; "
          f"{res['seconds']:.1f} s", flush=True)
    report["distributed"] = res
    # every rank's launches on every run, the NCCL runs' included
    counted = [rk[n]["launches"] for rk in ranks for n in runs] + [
        res[f"nccl_{n}"]["launches"] for n in ("fused", "feature")]
    return {k: sum(c[k] for c in counted) for k in counted[0]}


# ---- phase 34: streamed training and the grower's reach ---------------------
# the spills of phase 34 (git-ignored; removed at the end of the phase)
STREAM_DIR = os.path.join(ROOT, "_stream_rows")
STREAM_RAGGED_ROWS = 999_983           # a chunking that divides nothing
STREAM_PAIRS = 2                       # interleaved resident/streamed runs
                                       # (of 3, for the script's time)
# (d) and (e) run on the first WIDE_ROWS rows of phase 2 (cut from 10M for
# the script's time)
WIDE_ROWS = 2_000_000
WIDE_BINS = 2048
WIDE_TREES = 5
DEEP_DEPTH = 16
DEEP_LEAVES = 65536
DEEP_TREES = 2
DEEP_PREDICT_ROWS = 200_000


def rss_kb() -> int:
    """VmRSS of this process, kB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    raise RuntimeError("no VmRSS in /proc/self/status")


def upload_cost(fn) -> tuple:
    """``fn()`` (an upload), its seconds (ending in
    ``torch.cuda.synchronize``) and the host's peak-RSS growth while it
    ran: a thread samples VmRSS every 0.5 ms (a container may refuse the
    VmHWM reset through /proc/self/clear_refs)."""
    import threading

    import torch

    gc.collect()
    base = rss_kb()
    peak = [base, 0]
    stop = threading.Event()

    def sample():
        while not stop.is_set():
            peak[0] = max(peak[0], rss_kb())
            peak[1] += 1
            stop.wait(0.0005)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        stop.set()
        sampler.join()
    return out, {"seconds": seconds, "rss_before_mb": base / 1024,
                 "peak_rss_growth_mb": (max(peak[0], rss_kb()) - base)
                 / 1024, "rss_samples": peak[1]}


def run_memory(dt, params, ds, dev) -> tuple:
    """``train_counted`` on ``ds``, with its peak device memory above what
    was allocated before the run (``ds``'s own upload, made in the run,
    included)."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    booster, launches, peak = train_counted(dt, params, ds, dev)
    return booster, launches, peak - before


def _stream_spills(dt, a, ds, Xv, dev, params, rep) -> dict:
    """(a) and (c): spill, upload, train from each spill against fresh
    resident sets; returns the launch counts of the streamed runs."""
    import numpy as np
    import torch

    from dryad_tpu_torch.data.stream_dataset import (
        DEFAULT_CHUNK_ROWS,
        StreamedDataset,
    )
    from dryad_tpu_torch.dataset import Dataset

    t0 = time.perf_counter()
    paths = {}
    for n in (DEFAULT_CHUNK_ROWS, STREAM_RAGGED_ROWS):
        paths[n] = os.path.join(STREAM_DIR, f"{n}.bins")
        StreamedDataset.from_dataset(ds, paths[n], chunk_rows=n)
    rep["spill_seconds"] = time.perf_counter() - t0

    # fresh sets for every run, so each uploads its own matrix and no
    # other set's memoized tensors sit in a run's peak
    def resident():
        return Dataset.from_binned(ds.X_binned, ds.mapper, ds.y)

    def streamed(n=DEFAULT_CHUNK_ROWS):
        return StreamedDataset(paths[n], ds.mapper, ds.y, chunk_rows=n)

    res, fresh = resident(), streamed()
    (xr, _, _), rep["upload_resident"] = upload_cost(
        lambda: res.device_arrays(dev))
    (xs, _, _), rep["upload_streamed"] = upload_cost(
        lambda: fresh.device_arrays(dev))
    check(torch.equal(xr, xs), "streamed: the chunk by chunk assembly "
          "differs from the resident upload")
    rep["host_matrix_mb"] = ds.X_binned.nbytes / 2 ** 20
    del res, fresh, xr, xs
    print("streamed uploads: " + json.dumps(
        {k: rep[k] for k in ("spill_seconds", "upload_resident",
                             "upload_streamed", "host_matrix_mb")}),
        flush=True)

    want = {"hist": 9 * a.trees, "perm": 8 * a.trees}
    ref, r_launches, r_peak = run_memory(dt, params, resident(), dev)
    check_launches(r_launches, want, "streamed yardstick")
    raw_cpu = predict_rows(ref, Xv, raw_score=True, device="cpu")
    launches = None
    for n in paths:
        sds = streamed(n)
        booster, got, peak = run_memory(dt, params, sds, dev)
        check_launches(got, want, f"streamed {n}-row chunks")
        same_trees(booster, ref, f"streamed {n}-row chunks vs resident")
        check(np.array_equal(predict_rows(booster, Xv, raw_score=True,
                                        device=dev), raw_cpu),
              f"streamed {n}-row chunks: card predict != CPU predict")
        launches = got if launches is None else {
            k: launches[k] + got[k] for k in got}
        rep[f"chunks_{n}"] = {"chunks": sds.num_chunks, "peak_bytes": peak}
        del sds
    rep["resident_peak_bytes"] = r_peak
    # trees/s in interleaved pairs
    pairs = []
    for _ in range(STREAM_PAIRS):
        r = dt.train(params, resident(), device=dev)
        s = dt.train(params, streamed(), device=dev)
        pairs.append({"resident": tree_summary(r)["trees_per_s"],
                      "streamed": tree_summary(s)["trees_per_s"]})
    rep["trees_per_s_pairs"] = pairs
    print("streamed runs: bitwise the resident run at chunks of "
          f"{DEFAULT_CHUNK_ROWS} and {STREAM_RAGGED_ROWS} rows; card "
          "predict bitwise CPU; " + json.dumps(
              {"pairs": pairs, "resident_peak_bytes": r_peak,
               **{k: rep[k] for k in rep if k.startswith("chunks_")}}),
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _stream_rebuild(ds, Xraw, rep) -> None:
    """(b): the chunk builder's bin pass over the raw rows, onto disk,
    bitwise ``ds.X_binned`` chunk by chunk."""
    import numpy as np

    from dryad_tpu_torch.data.streaming import dataset_from_chunks

    step = 1 << 20
    n = ds.num_rows

    def chunks():
        for lo in range(0, n, step):
            yield Xraw[lo:lo + step]

    t0 = time.perf_counter()
    sb = dataset_from_chunks(chunks, ds.y, n, ds.num_features,
                             mapper=ds.mapper,
                             spill=os.path.join(STREAM_DIR, "rebuilt.bins"))
    rep["rebuild_seconds"] = time.perf_counter() - t0
    for lo, hi, buf in sb.iter_chunks():
        check(np.array_equal(buf, ds.X_binned[lo:hi]),
              f"rebuilt spill differs from ds.X_binned in rows [{lo}, {hi})")
    print(f"rebuilt from {-(-n // step)} raw chunks onto disk in "
          f"{rep['rebuild_seconds']:.1f} s; bitwise ds.X_binned", flush=True)


def _wide_bins(dt, a, Xraw, y, Xv, yv, dev, params, reps, rep) -> tuple:
    """(d): 2048 bins on the legacy arm through arm A1; then 1024 bins,
    the wired kernels against ``hist_backend="xla"``.  Returns (launches
    of the 1024-bin kernel run, K1's level measurements)."""
    import numpy as np
    import torch

    from dryad_tpu_torch.engine import hist, histogram
    from dryad_tpu_torch.metrics import auc

    n = min(WIDE_ROWS, Xraw.shape[0])
    t0 = time.perf_counter()
    dw = dt.Dataset(Xraw[:n], y[:n], max_bins=WIDE_BINS)
    Xvb = dw.mapper.transform(Xv)
    rep["wide_bin_seconds"] = time.perf_counter() - t0
    check(dw.mapper.total_bins > hist.MAX_BINS
          and dw.X_binned.dtype == np.uint16,
          f"wide bins: {dw.mapper.total_bins} total bins")
    wp = dict(params, max_bins=WIDE_BINS, num_trees=WIDE_TREES)
    bw, launches, peak = run_memory(dt, wp, dw, dev)
    check_launches(launches, {}, "wide bins (arm A1, no kernel)")
    same_trees(bw, dt.train(wp, dw, device=dev), "wide bins")
    raw = bw.predict_binned(Xvb, raw_score=True, device=dev)
    check(np.array_equal(raw, bw.predict_binned(Xvb, raw_score=True,
                                                device="cpu")),
          "wide bins: card predict != CPU predict")
    a_last = auc(yv, raw)
    check(a_last > 0.70, f"wide bins: held-out AUC {a_last} <= 0.70")
    rep["wide"] = dict(tree_summary(bw), rows=n,
                       total_bins=int(dw.mapper.total_bins),
                       peak_bytes=peak, auc=a_last, launches=launches)
    print("wide bins: second run bitwise; card predict bitwise CPU; "
          + json.dumps(rep["wide"]), flush=True)
    del dw, Xvb, bw
    gc.collect()

    d10 = dt.Dataset(Xraw[:n], y[:n], max_bins=1024)
    check(256 < d10.mapper.total_bins <= hist.MAX_BINS,
          f"1024 bins: {d10.mapper.total_bins} total bins")
    p10 = dict(params, max_bins=1024, num_trees=1)
    bk, k_launches, _ = train_counted(dt, p10, d10, dev)
    check_launches(k_launches, {"hist": 9, "perm": 8}, "1024 bins, kernels")
    ba, a_launches, _ = train_counted(dt, dict(p10, hist_backend="xla"),
                                      d10, dev)
    check_launches(a_launches, {}, "1024 bins, arm A1")
    same_trees(ba, bk, "1024 bins: arm A1 vs the wired kernels")
    k1 = capture(dt, p10, d10, dev, {"hist": (hist, "hist_tiles")})["hist"]
    a1 = capture(dt, dict(p10, hist_backend="xla"), d10, dev,
                 {"a1": (histogram, "build_hist_a1")})["a1"]
    check(len(k1) == 9 and len(a1) == 9,
          f"1024 bins: {len(k1)} K1 and {len(a1)} arm A1 passes a tree")
    (k_args, _), (a_args, a_kw) = k1[-1], a1[-1]
    level = check_hist(k_args, "hist 1024-bin level", reps)
    out_a1 = histogram.build_hist_a1(*a_args, **a_kw)
    check(torch.equal(out_a1, hist.hist_tiles(*k_args)),
          "1024 bins: arm A1's level pass != K1's")
    level["a1_ms"] = time_ms(
        lambda: histogram.build_hist_a1(*a_args, **a_kw), reps)
    level["a1_rows_per_chunk"] = a_kw["rows_per_chunk"]
    rep["bins_1024_level"] = level
    print("1024 bins: arm A1 trees bitwise the wired kernels'; level pass "
          + json.dumps(brief(level) | {"a1_ms": level["a1_ms"]}),
          flush=True)
    del d10, k1, a1, k_args, a_args, out_a1
    gc.collect()
    torch.cuda.empty_cache()
    return k_launches, level


def _deep_leaves(dt, ds, Xv, dev, params, rep) -> dict:
    """(e): depth 16 and 65536 leaves on the first rows of phase 2's bins:
    the unpacked route."""
    import numpy as np
    import torch

    from dryad_tpu_torch.dataset import Dataset
    from dryad_tpu_torch.engine import levelwise, predict

    n = min(WIDE_ROWS, ds.num_rows)
    de = Dataset.from_binned(ds.X_binned[:n], ds.mapper, ds.y[:n])
    pe = dict(params, max_depth=DEEP_DEPTH, num_leaves=DEEP_LEAVES,
              num_trees=DEEP_TREES)
    routed = []
    real = levelwise.gather_left

    def spy(*args, **kw):
        routed.append(1)
        return real(*args, **kw)

    levelwise.gather_left = spy
    try:
        be, launches, peak = run_memory(dt, pe, de, dev)
    finally:
        levelwise.gather_left = real
    check(len(routed) == DEEP_DEPTH * DEEP_TREES,
          f"65536 leaves: the unpacked route ran {len(routed)} levels")
    n_nat, n_rows = legacy_calls(n, de.num_features, DEEP_DEPTH,
                                 DEEP_LEAVES)
    check_launches(launches, {"nat": n_nat * DEEP_TREES,
                              "hist_rows": n_rows * DEEP_TREES},
                   "65536 leaves")
    same_trees(be, dt.train(pe, de, device=dev), "65536 leaves")
    M = be.params.max_nodes
    check(not predict.packed_fits(de.num_features, M),
          "65536 leaves: the model should overflow the packed words")
    Xvb = ds.mapper.transform(Xv[:DEEP_PREDICT_ROWS])
    check(np.array_equal(be.predict_binned(Xvb, raw_score=True, device=dev),
                         be.predict_binned(Xvb, raw_score=True,
                                           device="cpu")),
          "65536 leaves: card predict (SoA) != CPU predict")
    P_full = levelwise.phase_plan(DEEP_DEPTH, DEEP_LEAVES, n_nat > 0)[2]
    rep["deep"] = dict(
        tree_summary(be), rows=n, peak_bytes=peak, launches=launches,
        leaves_per_tree=float((be.arrays["feature"] >= 0).sum(1).mean())
        + 1,
        widest_level_slots=P_full,
        widest_level_hist_bytes=P_full * 3 * de.num_features
        * de.mapper.total_bins * 8)
    print("65536 leaves: unpacked route; second run bitwise; card predict "
          "(SoA) bitwise CPU; " + json.dumps(rep["deep"]), flush=True)
    del de, be
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_stream(dt, a, ds, Xraw, Xv, yv, dev, report) -> tuple:
    """Phase 34: out-of-core streamed training and the grower's reach
    (docstring).  Returns (launches by path, K1's 1024-bin level)."""
    params = {"objective": "binary", "growth": "depthwise", "max_depth": 8,
              "num_leaves": 255, "max_bins": 256, "learning_rate": 0.1,
              "num_trees": a.trees}
    rep: dict = {}
    shutil.rmtree(STREAM_DIR, ignore_errors=True)
    os.makedirs(STREAM_DIR)
    try:
        s_launches = _stream_spills(dt, a, ds, Xv, dev, params, rep)
        _stream_rebuild(ds, Xraw, rep)
    finally:
        shutil.rmtree(STREAM_DIR, ignore_errors=True)
    k_launches, level = _wide_bins(dt, a, Xraw, ds.y, Xv, yv, dev, params,
                                   a.reps, rep)
    d_launches = _deep_leaves(dt, ds, Xv, dev, params, rep)
    report["stream"] = rep
    return ({"streamed": s_launches, "bins_1024": k_launches,
             "leaves_65536": d_launches}, level)


# ---- phase 35: the rest of distribution -------------------------------------
# the sets of phase 35's rank processes (git-ignored; removed after it)
REST_DIR = os.path.join(ROOT, "_dist_modes")
REST_GOSS = {"objective": "binary", "growth": "depthwise", "max_depth": 8,
             "num_leaves": 255, "max_bins": 256, "learning_rate": 0.1,
             "boosting": "goss", "goss_top_rate": 0.2,
             "goss_other_rate": 0.1, "num_trees": 5}
REST_RANK = dict(MSLR, num_trees=2)
REST_EPS_ROWS = 100_000          # cut from phase 16's 300k for the time
REST_ROBUST = {"growth": "depthwise", "max_depth": 6, "num_leaves": 63,
               "max_bins": 256, "learning_rate": 0.1, "num_trees": 2}
REST_CSR = {"objective": "binary", "num_trees": 5, "num_leaves": 63,
            "max_bins": 64, "growth": "depthwise", "max_depth": 6}
REST_BUCKET = 4096               # the sharded cache's bucket
REST_BUCKET_CALLS = 16           # timed bucket calls a path


def rest_runs(crit_cat) -> dict:
    """Phase 35's runs: name -> (set, params); ``crit_cat`` the Criteo
    fixture's categorical features."""
    return {
        "goss_fused": ("higgs", REST_GOSS),
        "goss_feature": ("higgs", dict(REST_GOSS, hist_reduce="feature")),
        "lambdarank": ("mslr", REST_RANK),
        "l1": ("epsilon", dict(REST_ROBUST, objective="l1")),
        "quantile": ("epsilon", dict(REST_ROBUST, objective="quantile",
                                     alpha=0.9)),
        "criteo_csr": ("criteo", dict(REST_CSR, categorical_features=list(
            crit_cat))),
        "efb_csr": ("efb", REST_CSR),
    }


def _rest_want(name: str, params: dict, F: int, rows: int) -> dict:
    """The launches a rank of ``rows`` rows (the group's largest) makes on
    run ``name``, per its path: wired 9 K1 + 8 K2 a tree at depth 8 (7 + 6
    at depth 6), MSLR's legacy leaf-wise arm and Epsilon's legacy arm by
    their gates."""
    T = params["num_trees"]
    if name == "lambdarank":
        n_nat, n_rows = leafwise_legacy_calls(rows, F, params["max_depth"])
        return {"nat": n_nat * T, "hist_rows": n_rows * T}
    if name in ("l1", "quantile"):
        n_nat, n_rows = legacy_calls(rows, F, params["max_depth"],
                                     params["num_leaves"])
        return {"nat": n_nat * T, "hist_rows": n_rows * T}
    D = params["max_depth"]
    return {"hist": (D + 1) * T, "perm": D * T}


def _rest_sharded(dt, booster, Xvb, dev, rep) -> dict:
    """(e): the serving model's predict of the held-out rows split over
    [cuda:0, cuda:0] and over every visible card, bitwise the
    single-device predict; a cache whose sharded family splits each
    4096-row bucket over [cuda:0, cuda:0] serves bitwise the unsharded
    cache; each path's ms and launches per call."""
    import numpy as np
    import torch

    from dryad_tpu_torch.engine import predict as P
    from dryad_tpu_torch.serve.cache import CompiledPredictCache
    from dryad_tpu_torch.serve.registry import ModelRegistry

    out: dict = {}
    two = [torch.device("cuda", dev.index or 0)] * 2 if dev.type == "cuda" \
        else [dev, dev]
    every = None if dev.type == "cuda" else [dev]

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        r = fn()
        sync()
        return r, (time.perf_counter() - t0) * 1e3

    single, out["single_ms"] = timed(
        lambda: P.predict_binned(booster, Xvb, device=dev))
    for label, devs in (("two_blocks", two), ("every_card", every)):
        got, ms = timed(lambda: P.predict_binned_sharded(booster, Xvb,
                                                          devices=devs))
        check(got.shape == single.shape and np.array_equal(got, single),
              f"rest (e): sharded predict over {label} differs from the "
              "single-device predict")
        out[f"{label}_ms"] = ms
    out["every_card_devices"] = (torch.cuda.device_count()
                                 if dev.type == "cuda" else 1)
    # one device's count for these 4096 rows is phase 32's (accumulate)
    out["two_blocks_launches"] = serve_launches(
        lambda: P.predict_binned_sharded(booster, Xvb[:REST_BUCKET],
                                         devices=two))
    reg = ModelRegistry()
    entry = reg.get(reg.add(booster))
    caches = {"unsharded": CompiledPredictCache(dev, max_bucket=REST_BUCKET),
              "sharded": CompiledPredictCache(
                  dev, max_bucket=REST_BUCKET, devices=two,
                  sharded_threshold=0)}
    rows = Xvb[:REST_BUCKET * REST_BUCKET_CALLS]
    answers = {}
    for label, cache in caches.items():
        t0 = time.perf_counter()
        cache.predict_raw(entry, rows[:REST_BUCKET])       # the capture
        out[f"{label}_capture_s"] = time.perf_counter() - t0
        answers[label], ms = timed(lambda: cache.predict_raw(entry, rows))
        out[f"{label}_bucket_call_ms"] = ms / REST_BUCKET_CALLS
        out[f"{label}_bucket_launches"] = serve_launches(
            lambda: cache.predict_raw(entry, rows[:REST_BUCKET]))
    check(np.array_equal(answers["sharded"], answers["unsharded"]),
          "rest (e): the sharded cache's answers differ from the unsharded "
          "cache's")
    check(np.array_equal(answers["unsharded"],
                         single[:rows.shape[0]].reshape(
                             answers["unsharded"].shape)),
          "rest (e): the cache differs from the direct predict")
    key = (entry.version, REST_BUCKET, 2)
    check(dev.type != "cuda" or len(caches["sharded"]._graphs[key]) == 2,
          "rest (e): the sharded bucket does not hold two graphs")
    check(caches["sharded"].num_entries == 1,
          "rest (e): warm traffic added a cache entry")
    rep["sharded_predict"] = out
    print("rest (e) sharded predict: " + json.dumps(out), flush=True)
    return out


def phase_rest(dt, a, ds, Xv, yv, dev, report, mslr, eps, serve_model
               ) -> dict:
    """Phase 35: the rest of distribution (docstring).  ``mslr`` is phase
    20's (train, valid) sets, ``eps`` phase 16's binned Epsilon rows cut
    to ``REST_EPS_ROWS`` (X, y, mapper, valid X, valid y),
    ``serve_model`` phase 32's serving booster."""
    import numpy as np
    import torch

    from dryad_tpu_torch import datasets
    from dryad_tpu_torch import distributed as dd
    from dryad_tpu_torch.engine import cuda_build
    from dryad_tpu_torch.engine.distributed import RowGroup

    t0 = time.perf_counter()
    rep: dict = {}
    dv = ds.bind(Xv, yv)
    eX, ey, emapper, eXv, eyv = eps
    eds = dt.Dataset.from_binned(eX, emapper, ey)
    edv = dt.Dataset.from_binned(eXv, emapper, eyv)
    ccsr, cy, ccat = datasets.criteo_like(50_000, seed=43)
    cds = dt.Dataset(None, cy, csr=ccsr, categorical_features=ccat,
                     max_bins=64)
    fcsr, fy, fcat = efb_csr()
    fds = dt.Dataset(None, fy, csr=fcsr, categorical_features=fcat,
                     max_bins=64)
    check(type(fds.mapper).__name__ == "BundledMapper",
          "rest (d): the EFB fixture did not bundle")
    sets = {"higgs": (ds, dv, "rows", None), "mslr": (*mslr, "query", None),
            "epsilon": (eds, edv, "rows", None),
            "criteo": (cds, None, "rows", ccsr),
            "efb": (fds, None, "rows", fcsr)}
    runs = rest_runs(ccat)
    shutil.rmtree(REST_DIR, ignore_errors=True)
    os.makedirs(REST_DIR)
    spec_sets = {n: write_set(os.path.join(REST_DIR, n), s, v, split, csr)
                 for n, (s, v, split, csr) in sets.items()}
    spec = os.path.join(REST_DIR, "spec.json")
    with open(spec, "w") as f:
        json.dump({"dir": REST_DIR, "world": DIST_RANKS,
                   "timeout_s": DIST_TIMEOUT_S, "sets": spec_sets,
                   "runs": {n: {"set": sn, "params": p}
                            for n, (sn, p) in runs.items()},
                   "device": (f"cuda:{torch.cuda.current_device()}"
                              if dev.type == "cuda" else "cpu")}, f)
    rep["setup_s"] = time.perf_counter() - t0

    # the yardsticks, one process on all the rows: the arms are one run
    t1 = time.perf_counter()
    single: dict = {}
    for name, (sn, p) in runs.items():
        key = (sn, json.dumps({k: v for k, v in p.items()
                               if k != "hist_reduce"}, sort_keys=True))
        if key not in single:
            s, v = sets[sn][0], sets[sn][1]
            single[key] = dt.train(p, s, None if v is None else [v],
                                   device=dev)
        single[name] = single[key]
    rep["single_s"] = time.perf_counter() - t1
    rep["single_process"] = {n: tree_summary(single[n]) for n in runs}
    print("rest: one process: " + json.dumps(rep["single_process"]),
          flush=True)
    # the rank processes hold their own copies of the sets
    for s in (ds, dv, eds, edv, mslr[0], mslr[1], cds, fds):
        s._device_cache.clear()
    torch.cuda.empty_cache()

    t2 = time.perf_counter()
    logs = [open(os.path.join(REST_DIR, f"rank{r}.log"), "w")
            for r in range(DIST_RANKS)]
    code = ("import sys, chip_smoke; "
            "sys.exit(chip_smoke.rank_main(sys.argv[1], int(sys.argv[2])))")
    procs = [subprocess.Popen([sys.executable, "-c", code, spec, str(r)],
                              cwd=ROOT, stdout=logs[r],
                              stderr=subprocess.STDOUT)
             for r in range(DIST_RANKS)]
    try:
        for p in procs:
            p.wait(timeout=DIST_TIMEOUT_S + 120)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(REST_DIR, f"rank{r}.log")) as f:
                print(f.read()[-4000:], file=sys.stderr)
        check(p.returncode == 0, f"rest: rank {r} exited {p.returncode}")
    rep["gloo_group_s"] = time.perf_counter() - t2
    ranks = []
    for r in range(DIST_RANKS):
        with open(os.path.join(REST_DIR, f"report.{r}.json")) as f:
            ranks.append(json.load(f))

    def same_run(b, evals, name, who):
        want = single[name]
        for k, v in want.tree_arrays().items():
            check(np.array_equal(b.tree_arrays()[k], v),
                  f"rest {name}: {who}'s {k!r} differs from the single "
                  "process's")
        check(evals == want.train_state.get("eval_history"),
              f"rest {name}: {who}'s evals {evals} differ from the single "
              f"process's {want.train_state.get('eval_history')}")
        check(b.best_iteration == want.best_iteration,
              f"rest {name}: {who}'s best iteration differs")

    def brief_run(rk, name) -> dict:
        keep = ("trees_per_s", "launches", "collective_bytes_per_tree",
                "collective_ms_per_tree", "collective_host_ms_per_tree")
        return {k: rk[name][k] for k in keep}

    counted = []
    for name, (sn, p) in runs.items():
        F = sets[sn][0].num_features
        for r in range(DIST_RANKS):
            b = dt.Booster.load(os.path.join(REST_DIR, f"{name}.{r}.dryad"))
            same_run(b, ranks[r][name]["eval_history"], name, f"rank {r}")
            check_launches(ranks[r][name]["launches"],
                           _rest_want(name, p, F,
                                      ranks[r][name]["max_rank_rows"]),
                           f"rest {name} rank {r}")
            counted.append(ranks[r][name]["launches"])
        res = {"rows": [rk["rows"][sn] for rk in ranks],
               "single_trees_per_s": rep["single_process"][name][
                   "trees_per_s"],
               "ranks": [brief_run(rk, name) for rk in ranks],
               "comm_stats": ranks[0][name]["comm_stats"]}
        rep[f"gloo_{name}"] = res
        print(f"rest gloo x{DIST_RANKS} {name}: " + json.dumps(res),
              flush=True)
    shutil.rmtree(REST_DIR, ignore_errors=True)

    # one NCCL rank in this process: GOSS and the renewal through NCCL's
    # all-reduce and all-gather of card tensors (gloo in a CPU rehearsal)
    t3 = time.perf_counter()
    dd.initialize(backend="nccl" if dev.type == "cuda" else "gloo",
                  init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                  world_size=1, timeout_s=DIST_TIMEOUT_S)
    try:
        for name in ("goss_fused", "l1"):
            sn, p = runs[name]
            s, v = sets[sn][0], sets[sn][1]
            group = RowGroup.build(s.num_rows, device=dev,
                                   time_collectives=True)
            cuda_build.reset_counts()
            b = dd.train_distributed(p, s, v, group=group, device=dev)
            launches = dict(cuda_build.counts)
            same_run(b, b.train_state.get("eval_history"), name, "NCCL")
            check_launches(launches, _rest_want(name, p, s.num_features,
                                                s.num_rows),
                           f"rest NCCL {name}")
            counted.append(launches)
            rr = _dist_run_report(b, group, launches, p["num_trees"])
            rep[f"nccl_{name}"] = {k: rr[k] for k in (
                "trees_per_s", "launches", "collective_bytes_per_tree",
                "collective_ms_per_tree")}
            print(f"rest NCCL x1 {name}: " + json.dumps(rep[f"nccl_{name}"]),
                  flush=True)
    finally:
        torch.distributed.destroy_process_group()
    rep["nccl_s"] = time.perf_counter() - t3

    # (e) sharded predict and the sharded cache
    t4 = time.perf_counter()
    _rest_sharded(dt, serve_model, dv.X_binned, dev, rep)
    rep["sharded_s"] = time.perf_counter() - t4
    rep["seconds"] = time.perf_counter() - t0
    print("rest: every rank's trees, evals and best iteration bitwise the "
          f"single process's; sharded predict bitwise; {rep['seconds']:.1f} "
          "s", flush=True)
    report["rest_of_distribution"] = rep
    return {k: sum(c.get(k, 0) for c in counted)
            for k in ("hist", "perm", "nat", "hist_rows")}


# ---- phase 36: measurement and the dispatch policy (M14b) -------------------
PROBE_ROWS = 1_000_000          # every probe's liveness proof and wall
PROBE_SLOTS = 128               # the 10M-row kernel probes' slot count
# the kernel probes also timed at the headline rows, and the kernel
# counter each launches once a step
PROBE_KERNELS = {"hist_masked": "hist_rows", "hist_segmented": "hist_rows",
                 "hist_from_layout": "hist", "permute_records": "perm"}
PROBE_K, PROBE_REPS = 3, 3
# (f): the predict_layout entry held on a wide and a multiclass model:
# (generator, its arguments, params), LAYOUT_ROWS rows to train on and
# LAYOUT_HOLDOUT to traverse
# (LAYOUT_HOLDOUT cut from 50k for the script's time)
LAYOUT_ROWS, LAYOUT_HOLDOUT, LAYOUT_REPS = 20_000, 20_000, 10
LAYOUT_MODELS = {
    "wide": ("epsilon_like", {"num_features": EPS_FEATURES, "seed": 13},
             {"objective": "regression", "growth": "depthwise",
              "max_depth": 6, "num_leaves": 63, "max_bins": 256,
              "num_trees": 20}),
    "multiclass": ("covertype_like", {"num_features": COV_FEATURES,
                                      "num_class": COV_CLASSES, "seed": 11},
                   dict(COVERTYPE, num_trees=5)),
}
# (g): introspection's cost on a new config's first tree and first
# predict, in the order of these DRYAD_PROG values
FIRST_RUN_ORDER = ("1", "0", "0", "1")


def layout_flip_check(dt, dev) -> dict:
    """Phase 36 (f): for each of ``LAYOUT_MODELS``, a model trained on the
    card, its ``LAYOUT_HOLDOUT`` held-out rows traversed by both
    ``predict_layout`` arms through serving's program (``forest_scores``)
    and direct predict's (``accumulate``): the four answers bitwise, and
    each arm's device ms (CUDA events, ``LAYOUT_REPS`` calls)."""
    import numpy as np
    import torch

    from dryad_tpu_torch import datasets
    from dryad_tpu_torch.dataset import binned_to_device
    from dryad_tpu_torch.engine.predict import (
        accumulate,
        forest_scores,
        stage_trees,
        table_to,
    )

    out: dict = {}
    for name, (gen, kw, params) in LAYOUT_MODELS.items():
        X, y = getattr(datasets, gen)(LAYOUT_ROWS + LAYOUT_HOLDOUT, **kw)
        ds = dt.Dataset(X[:LAYOUT_ROWS], y[:LAYOUT_ROWS], max_bins=256)
        dv = ds.bind(X[LAYOUT_ROWS:], y[LAYOUT_ROWS:])
        del X, y
        b = dt.train(params, ds, device=dev)
        Xd = binned_to_device(dv.X_binned, dev)
        depth = max(b.max_depth_seen, 1)
        res, answers = {"iterations": b.num_iterations,
                        "features": ds.num_features,
                        "outputs": b.num_outputs}, []
        for layout in ("packed", "legacy"):
            table, value, bitset, init, _ = stage_trees(b, layout=layout)
            args = (table_to(table, dev), torch.from_numpy(value).to(dev),
                    Xd, torch.from_numpy(init).to(dev), depth,
                    None if bitset is None else
                    torch.from_numpy(bitset).to(dev))
            for prog, fn in (("serve", forest_scores),
                             ("predict", accumulate)):
                answers.append(fn(*args).cpu().numpy())
                res[f"{prog}_{layout}_ms"] = time_ms(lambda: fn(*args),
                                                     LAYOUT_REPS)
            del args
        for x in answers[1:]:
            check(np.array_equal(answers[0], x), f"policy: the {name} "
                  "model's answers differ between predict layouts")
        res["faster"] = {prog: min(("packed", "legacy"),
                                   key=lambda la: res[f"{prog}_{la}_ms"])
                         for prog in ("serve", "predict")}
        out[name] = res
        del b, ds, dv, Xd, answers
        gc.collect()
        torch.cuda.empty_cache()
    return out


def first_run_seconds(dt, ds, Xv, dev, params) -> dict:
    """Host seconds to a new config's first tree (a 1-tree ``dt.train``)
    and to its booster's first predict of ``Xv`` (bins cached, so staging
    and traversal), then of the same again (warm).  The introspection
    memo is emptied first where the package has one, so a first run is
    observed whenever ``DRYAD_PROG`` leaves introspection on."""
    import torch

    try:
        from dryad_tpu_torch.engine import introspect
        introspect.reset_seen()
    except ImportError:             # a tree without introspection
        pass
    out = {}
    for when in ("first", "next"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = dt.train(dict(params, num_trees=1), ds, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        predict_rows(b, Xv, device=dev)
        t2 = time.perf_counter()
        out[f"{when}_tree_s"], out[f"{when}_predict_s"] = t1 - t0, t2 - t1
    return out


def phase_policy(dt, a, ds, Xv, yv, dev, report, serve_model) -> tuple:
    """Phase 36: the stage probes, the calibration sweep, the headline
    config under the committed table and the default one, serving's policy
    block and introspection gauges, the fetch watchdog's gauge.  Returns
    the launches of the probes (path "profile") and of the two headline
    runs (path "policy_headline")."""
    import tempfile

    import numpy as np
    import torch

    from dryad_tpu_torch.engine import cuda_build, introspect, probes
    from dryad_tpu_torch.obs.profiler import export_stages, profile_artifact
    from dryad_tpu_torch.obs.registry import default_registry
    from dryad_tpu_torch.policy import calibrate, gates
    from dryad_tpu_torch.policy import table as ptable
    from dryad_tpu_torch.policy.device import current_device_kind
    from dryad_tpu_torch.serve import PredictServer

    rep: dict = {}
    steps, clock = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        steps[name] = now - clock[0]
        clock[0] = now

    kind = torch.cuda.get_device_name(0)
    check(current_device_kind() == kind,
          f"policy: device kind {current_device_kind()!r} is not {kind!r}")

    # (a) every probe liveness-proven on the card, the kernel probes also
    # at the headline rows; each launches its kernel once a step
    cuda_build.reset_counts()
    runs = [(n, PROBE_ROWS, 64) for n in probes.PROBES]
    runs += [(n, a.rows, PROBE_SLOTS) for n in PROBE_KERNELS]
    results, want = [], {}
    for name, rows, slots in runs:
        r = probes.run_probe(name, rows=rows, K=PROBE_K, reps=PROBE_REPS,
                             num_slots=slots, device=dev)
        check(r["platform"] == "cuda", f"probe {name} ran on {r['platform']}")
        if rows != PROBE_ROWS:
            r["arm"] = f"{rows // 1_000_000}m_p{slots}"
        if name in PROBE_KERNELS:
            k = PROBE_KERNELS[name]
            want[k] = want.get(k, 0) + (2 + PROBE_REPS) * PROBE_K
        results.append(r)
        gc.collect()
        torch.cuda.empty_cache()
    launches = dict(cuda_build.counts)
    check_launches(launches, want, "profile probes")
    check(export_stages(results) == len(results), "stage gauges not set")
    art = profile_artifact(results, device_kind=kind, root=ROOT)
    with open(os.path.join(OUT, "profile_probes.json"), "w") as f:
        json.dump(art, f, indent=1)
    rep["probes"] = {(r["stage"] + (f"_{r['arm']}" if "arm" in r else "")):
                     {"ms": r["ms"], "spread": r["spread"],
                      "rows": r["rows"]} for r in results}
    big = {r["stage"]: r for r in results if "arm" in r}
    rep["beside_phases_3_8"] = {
        "hist_masked": (big["hist_masked"]["ms"],
                        report["hist_root"]["ms"]),
        "hist_from_layout": (big["hist_from_layout"]["ms"],
                             report["hist_level"]["ms"]),
        "hist_segmented": (big["hist_segmented"]["ms"],
                           report["rows_level"]["ms"]),
        "permute_records": (big["permute_records"]["ms"],
                            report["perm"]["ms"])}
    print("policy probes (ms, spread): " + json.dumps(rep["probes"]),
          flush=True)
    print("policy 10M-row probe walls beside phase 3's K1 root and level "
          "(P=128), phase 8's K1 rows level (P=128) and phase 3's K2 "
          "(probe stage ms, kernel ms): "
          + json.dumps(rep["beside_phases_3_8"]), flush=True)
    lap("probes")

    # (b) the card's own sweep (``profile --calibrate``), and the committed
    # table checked against the same walls (``profile --check-calib``)
    measured = calibrate.run_sweep(device=dev)
    devices, cal = calibrate.calibrated_devices(measured, kind, ROOT)
    ptable.save_table(devices, os.path.join(OUT, "calibration_p36.json"))
    committed = ptable.current_table()
    rep["derived_entry"] = devices[kind]
    rep["committed_entry"] = committed.devices.get(kind)
    check(rep["committed_entry"] is not None,
          f"policy: the committed table has no entry for {kind!r}")
    chk = calibrate.check_walls(measured, kind)
    rep["check_calib"] = chk
    print("policy calibration: derived " + json.dumps(devices[kind])
          + " check " + json.dumps(chk), flush=True)
    check(chk["ok"], "policy: --check-calib reports drift against the "
          "committed table")
    lap("calibrate")

    # (c) the headline config under the committed table and an explicit
    # _default-only table: trees and held-out predictions bitwise; (e)
    # their valid-set fetches run under the watchdog
    params = {"objective": "binary", "growth": "depthwise", "max_depth": 8,
              "num_leaves": 255, "max_bins": 256, "learning_rate": 0.1,
              "num_trees": a.trees}
    dv = ds.bind(Xv, yv)
    cuda_build.reset_counts()
    gates.reset_decisions()
    b_committed = dt.train(params, ds, [dv], device=dev)
    rep["decisions_committed"] = gates.decisions()
    with tempfile.TemporaryDirectory(dir=OUT) as tmp:
        path = os.path.join(tmp, "default_only.json")
        ptable.save_table({"_default": committed.devices["_default"]}, path)
        os.environ[ptable.TABLE_ENV] = path
        ptable.reset_cache()
        try:
            check(ptable.current_table().explicit,
                  "policy: the explicit table was not loaded")
            b_default = dt.train(params, ds, [dv], device=dev)
        finally:
            del os.environ[ptable.TABLE_ENV]
            ptable.reset_cache()
    head_launches = dict(cuda_build.counts)
    check_launches(head_launches, {"hist": 18 * a.trees,
                                   "perm": 16 * a.trees}, "policy headline")
    same_trees(b_committed, b_default, "policy: committed vs default table")
    pc, pd = (predict_rows(b, Xv, device=dev) for b in (b_committed,
                                                        b_default))
    check(np.array_equal(pc, pd), "policy: held-out predictions differ "
          "between the committed and the default table")
    gauges = default_registry().snapshot()["gauges"]
    check("dryad_fetch_inflight_age_seconds" in gauges,
          "policy: no dryad_fetch_inflight_age_seconds after a trained run")
    rep["fetch_inflight_age_s"] = gauges["dryad_fetch_inflight_age_seconds"]
    rep["headline_trees_per_s"] = {
        "committed": tree_summary(b_committed)["trees_per_s"],
        "default": tree_summary(b_default)["trees_per_s"]}
    del b_committed, b_default, dv
    lap("headline")

    # (d) phase 32's model served with introspection off and on: answers
    # bitwise, every captured bucket's gauges, the policy block
    answers = {}
    os.environ["DRYAD_PROG_TRACE"] = "1"        # launches and device ms
    for flag in ("0", "1"):
        os.environ["DRYAD_PROG"] = flag
        introspect.reset_seen()
        server = PredictServer(device=dev, max_batch_rows=4096)
        try:
            server.registry.add(serve_model)
            server.warmup()
            with server:
                answers[flag] = [server.predict(Xv[:n], timeout=120)
                                 for n in (1, 100, 4096, 5000)]
            if flag == "1":
                block = server.stats()["policy"]
                check(block["device_kind"] == kind,
                      f"policy: stats() names {block['device_kind']!r}")
                check(kind in block["device_keys"],
                      "policy: stats() lacks the card's table entry")
                rep["stats_policy"] = block
                g = default_registry().snapshot()["gauges"]
                for name in ("dryad_prog_launches", "dryad_prog_device_ms",
                             "dryad_prog_wall_ms"):
                    for bucket in server.cache.buckets():
                        check(any(f'bucket="{bucket}"' in k
                                  and "serve.predict" in k
                                  for k in g.get(name, {})),
                              f"policy: no {name} for bucket {bucket}")
                rep["introspection"] = {
                    name: {k: v for k, v in g.get(name, {}).items()
                           if "serve.predict" in k}
                    for name in ("dryad_prog_launches",
                                 "dryad_prog_device_ms")}
        finally:
            server.stop()
            del server
            os.environ.pop("DRYAD_PROG", None)
        gc.collect()
        torch.cuda.empty_cache()
    del os.environ["DRYAD_PROG_TRACE"]
    for x0, x1 in zip(answers["0"], answers["1"]):
        check(np.array_equal(x0, x1),
              "policy: served answers differ with DRYAD_PROG 0 and 1")
    lap("serve")

    # (f) the committed predict_layout entry on a wide and a multiclass
    # model: both arms bitwise, each timed
    rep["layout_models"] = layout_flip_check(dt, dev)
    print("policy: predict layouts on a wide and a multiclass model "
          "(device ms a call): " + json.dumps(rep["layout_models"]),
          flush=True)
    lap("layouts")

    # (g) introspection's cost: a new config's first tree and first
    # predict with DRYAD_PROG 1 and 0, alternated
    firsts: dict = {"0": [], "1": []}
    for i, flag in enumerate(FIRST_RUN_ORDER):
        os.environ["DRYAD_PROG"] = flag
        try:
            firsts[flag].append(first_run_seconds(
                dt, ds, Xv, dev, dict(params, learning_rate=0.05 + i / 100)))
        finally:
            os.environ.pop("DRYAD_PROG", None)
    rep["first_run_s"] = firsts
    print("policy: time to a new config's first tree and first predict, "
          "DRYAD_PROG 1 and 0 (s): " + json.dumps(firsts), flush=True)
    lap("first_runs")
    rep["step_seconds"] = steps
    print("policy: " + json.dumps(rep, default=str), flush=True)
    report["policy"] = rep
    return launches, head_launches


CLI_ROWS = 2_000_000        # cut from 10M for the script's time
CLI_VALID = 200_000
CLI_TREES = 20
CLI = {"objective": "binary", "growth": "depthwise", "max_depth": 8,
       "num_leaves": 255, "max_bins": 256, "learning_rate": 0.1,
       "num_trees": CLI_TREES}
CLI_DIR = os.path.join(ROOT, "_cli_rows")
CLI_HOLD_S = 3                   # DRYAD_METRICS_HOLD_S of the CLI run
DRIFT_WINDOW = 8192
DRIFT_SHIFT_FEATURE = 0
DRIFT_LAT_BUCKETS = (1, 4096)
DRIFT_BENCH = dict(clients=4, sizes=(1, 64, 4096), duration_s=1.0, arms=2)
# F2's reproducer (covertype_like(3000, seed=3), 7 classes, GOSS, 15
# leaves, 64 bins), depthwise depth 4: its CPU run takes seconds where the
# reference's leaf-wise default takes half a minute on the plain versions
F2_GOSS = {"objective": "multiclass", "num_class": 7, "boosting": "goss",
           "num_leaves": 15, "num_trees": 3, "max_bins": 64,
           "growth": "depthwise", "max_depth": 4}


def _scrape(url: str):
    import urllib.request

    return urllib.request.urlopen(url, timeout=30).read()


def _post(url: str, body: dict, headers=None):
    import urllib.request

    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    return urllib.request.urlopen(req, timeout=120)


def phase_cli(dt, a, ds, Xv, dev, report, serve_model) -> tuple:
    """Phase 37: the command line, drift, the HTTP routes and F2 on the
    card (module doc).  Returns the CLI training run's launches and the
    path of its model, copied for phase 39."""
    import threading

    import numpy as np
    import torch

    from dryad_tpu_torch import datasets
    from dryad_tpu_torch.__main__ import main as cli
    from dryad_tpu_torch.data.profile import (DEFAULT_MAX_ROWS,
                                              build_reference_profile)
    from dryad_tpu_torch.engine import cuda_build, goss
    from dryad_tpu_torch.objectives import get_objective, row_sum
    from dryad_tpu_torch.obs.registry import (Registry, default_registry,
                                              set_default_registry)
    from dryad_tpu_torch.obs.trace_export import (disable_tracing,
                                                  enable_tracing)
    from dryad_tpu_torch.serve import PredictServer, run_bench_drift
    from dryad_tpu_torch.serve.http import TRACE_HEADER, make_http_server

    steps, clock = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        steps[name] = now - clock[0]
        clock[0] = now

    rep: dict = {}
    # this phase's spans and gauges in a registry of their own
    old_registry = set_default_registry(Registry())
    os.makedirs(CLI_DIR, exist_ok=True)
    try:
        # (a) python -m dryad_tpu_torch train at the headline widths
        X, y = datasets.higgs_like(CLI_ROWS + CLI_VALID, seed=a.seed + 37)
        f = {k: os.path.join(CLI_DIR, k + ".npy")
             for k in ("X", "y", "Xv", "yv")}
        np.save(f["X"], X[:CLI_ROWS])
        np.save(f["y"], y[:CLI_ROWS])
        np.save(f["Xv"], X[CLI_ROWS:])
        np.save(f["yv"], y[CLI_ROWS:])
        cfg = os.path.join(CLI_DIR, "cfg.json")
        with open(cfg, "w") as fh:
            json.dump(CLI, fh)
        model = os.path.join(CLI_DIR, "m.dryad")
        trace = os.path.join(CLI_DIR, "trace.json")
        log = os.path.join(CLI_DIR, "log.jsonl")
        port = _free_port()
        base = f"http://127.0.0.1:{port}"
        lap("data")
        result: dict = {}

        def run():
            try:
                result["rc"] = cli([
                    "train", "--config", cfg, "--data", f["X"],
                    "--label", f["y"], "--valid", f["Xv"],
                    "--valid-label", f["yv"], "--model", model,
                    "--metrics-port", str(port), "--trace-out", trace,
                    "--log-jsonl", log, "--quiet"])
            except BaseException as e:  # noqa: BLE001 — checked below
                result["error"] = repr(e)

        os.environ["DRYAD_METRICS_HOLD_S"] = str(CLI_HOLD_S)
        cuda_build.reset_counts()
        th = threading.Thread(target=run, daemon=True)
        th.start()
        try:
            stats = None
            deadline = time.monotonic() + 600
            while th.is_alive() and time.monotonic() < deadline:
                try:
                    stats = json.loads(_scrape(base + "/stats"))
                except OSError:
                    stats = None
                if stats and "train.fetch.final" in stats["spans"]:
                    break
                time.sleep(0.05)
            check(stats is not None and "train.fetch.final"
                  in stats["spans"],
                  f"cli: /stats never showed the run's end ({result})")
            health = json.loads(_scrape(base + "/healthz"))
            metrics = _scrape(base + "/metrics").decode()
        finally:
            th.join(600)
            del os.environ["DRYAD_METRICS_HOLD_S"]
        launches = dict(cuda_build.counts)
        check(result == {"rc": 0}, f"cli: train returned {result}")
        check_launches(launches, {"hist": 9 * CLI_TREES,
                                  "perm": 8 * CLI_TREES}, "cli train")
        spans = stats["spans"]
        check(spans["train.iteration"]["count"] == CLI_TREES,
              f"cli: /stats counts {spans['train.iteration']} iterations")
        check(spans["train.fetch.eval"]["count"] == CLI_TREES,
              "cli: one eval fetch an iteration (the logger is a callback)")
        check(health == {"ok": True}, f"cli: /healthz {health}")
        check(f"dryad_train_iteration {CLI_TREES - 1}" in metrics
              and "dryad_span_count_total" in metrics,
              "cli: /metrics lacks the loop's series")
        rep["stats_spans"] = {k: v for k, v in spans.items()
                              if k.startswith("train.")}
        with open(trace) as fh:
            events = json.load(fh)["traceEvents"]
        xs = [e for e in events if e["ph"] == "X"]
        check(sum(e["name"] == "train.iteration" for e in xs) == CLI_TREES,
              "cli: the trace lacks the iterations' X events")
        rep["trace_x_events"] = len(xs)
        with open(log) as fh:
            lines = [json.loads(line) for line in fh]
        check(len(lines) == CLI_TREES and "valid_auc" in lines[-1],
              "cli: --log-jsonl")
        rep["valid_auc"] = [lines[0]["valid_auc"], lines[-1]["valid_auc"]]
        rep["iteration_s"] = [line["dispatch_s"] for line in lines]
        check(rep["valid_auc"][1] > rep["valid_auc"][0]
              and rep["valid_auc"][1] > 0.70,
              f"cli: valid AUC {rep['valid_auc']}")
        # phase 39's generation 0: this 20-tree model and its profile
        os.makedirs(FLEET_DIR, exist_ok=True)
        gen0_path = os.path.join(FLEET_DIR, "m-gen0.dryad")
        shutil.copyfile(model, gen0_path)
        lap("cli_train")

        # the model's profile against build_reference_profile on the CPU,
        # over the rows its stride sample reads (binned through the model's
        # mapper: binning is per row, so these are the run's bins, and at
        # most max_rows rows sample themselves whole)
        b = dt.Booster.load(model)
        check(b.profile is not None, "cli: the model carries no profile")
        st_t = -(-CLI_ROWS // DEFAULT_MAX_ROWS)
        st_v = -(-CLI_VALID // DEFAULT_MAX_ROWS)
        Xt, Xvs = X[:CLI_ROWS:st_t], X[CLI_ROWS::st_v]
        cds = dt.Dataset(Xt, y[:CLI_ROWS:st_t], mapper=b.mapper)
        cvd = dt.Dataset(Xvs, y[CLI_ROWS::st_v], mapper=b.mapper)
        t0 = time.perf_counter()
        cpu_profile = build_reference_profile(b, cds, [cvd], device="cpu")
        rep["profile_cpu_s"] = time.perf_counter() - t0
        check(cpu_profile.n_rows == len(Xt)
              and cpu_profile.to_json_dict() == b.profile.to_json_dict(),
              "cli: the card run's profile != the CPU profile")
        del cds, cvd, X, y, Xt, Xvs
        lap("profile_check")

        # predict on the card (its default), bitwise --device cpu
        p_card = os.path.join(CLI_DIR, "p_card.npy")
        p_cpu = os.path.join(CLI_DIR, "p_cpu.npy")
        check(cli(["predict", "--model", model, "--data", f["Xv"],
                   "--out", p_card]) == 0, "cli: predict on the card")
        check(cli(["predict", "--model", model, "--data", f["Xv"],
                   "--out", p_cpu, "--device", "cpu"]) == 0,
              "cli: predict --device cpu")
        pc, pp = np.load(p_card), np.load(p_cpu)
        check(pc.shape == (CLI_VALID,) and np.array_equal(pc, pp),
              "cli: predict on the card != --device cpu")
        txt = os.path.join(CLI_DIR, "m.txt")
        check(cli(["dump", "--model", model, "--text", "--out", txt]) == 0,
              "cli: dump --text")
        again = dt.Booster.load_any(txt)
        Xvc = np.load(f["Xv"])
        check(again.profile == b.profile and np.array_equal(
            again.predict(Xvc, raw_score=True, device=dev),
            b.predict(Xvc, raw_score=True, device=dev)),
            "cli: dump --text does not round-trip")
        del Xvc
        lap("cli_predict_dump")

        # (b) drift in serving on phase 32's model
        check(serve_model.profile is not None,
              "drift: phase 32's model carries no profile")
        sync()
        t0 = time.perf_counter()
        again_profile = build_reference_profile(serve_model, ds, device=dev)
        rep["profile_capture_s"] = time.perf_counter() - t0
        check(again_profile == serve_model.profile,
              "drift: phase 32's profile is not the capture's")
        sd = float(np.nanstd(Xv[:, DRIFT_SHIFT_FEATURE]))
        shifted = np.array(Xv[:2 * DRIFT_WINDOW], copy=True)
        shifted[:, DRIFT_SHIFT_FEATURE] += np.float32(2 * sd)
        answers, drift_rep = {}, {}
        pool = Xv[:20_000]
        servers = {arm: PredictServer(device=dev, drift_window=DRIFT_WINDOW,
                                      drift="auto" if arm == "on"
                                      else "off") for arm in ("on", "off")}
        try:
            for arm, server in servers.items():
                server.registry.add(serve_model)
                server.warmup()
                server.start()
                got = []
                for rows in (Xv, shifted):
                    for i in range(0, 2 * DRIFT_WINDOW, 4096):
                        got.append(server.predict(rows[i:i + 4096],
                                                  raw_score=True,
                                                  timeout=120))
                    if arm == "on":
                        drift_rep["in" if rows is Xv else "shifted"] = (
                            server.drift_report(0.2))
                answers[arm] = got
            drift_rep["stats"] = servers["on"].stats()["drift"]
            # latency with the arms interleaved request by request, the
            # first arm alternating, so host drift falls on both alike
            rng = np.random.default_rng(7)
            ms = {arm: {n: [] for n in DRIFT_LAT_BUCKETS} for arm in servers}
            for n in DRIFT_LAT_BUCKETS:
                for i in range(SERVE_LAT_REQS):
                    s0 = int(rng.integers(0, len(pool) - n))
                    for arm in (("on", "off") if i % 2 else ("off", "on")):
                        t0 = time.perf_counter()
                        servers[arm].predict(pool[s0:s0 + n], timeout=120)
                        ms[arm][n].append((time.perf_counter() - t0) * 1e3)
        finally:
            for server in servers.values():
                server.stop()
        del servers
        lat = {arm: {n: {"p50_ms": float(np.percentile(v, 50)),
                         "p99_ms": float(np.percentile(v, 99))}
                     for n, v in by_n.items()} for arm, by_n in ms.items()}
        r_in, r_sh = drift_rep["in"]["v1"], drift_rep["shifted"]["v1"]
        check(r_in["rows"] >= DRIFT_WINDOW // 2 and not r_in["breached"],
              f"drift: in-distribution traffic breached: {r_in}")
        check(r_sh["breached"] and r_sh["psi_max"] > 0.2
              and r_sh["top"][0]["feature"] == DRIFT_SHIFT_FEATURE,
              f"drift: a 2 sigma shift of feature {DRIFT_SHIFT_FEATURE} "
              f"did not breach: {r_sh}")
        gauges = default_registry().snapshot()["gauges"]
        check(gauges["dryad_drift_psi_max"]['model="v1"'] > 0.2
              and drift_rep["stats"]["v1"]["psi_max"] > 0.2,
              "drift: the gauges or stats() miss the breach")
        for x_on, x_off in zip(answers["on"], answers["off"]):
            check(np.array_equal(x_on, x_off),
                  "drift: served answers differ with drift on and off")
        check(np.array_equal(answers["on"][0], serve_model.predict(
            Xv[:4096], raw_score=True, device=dev)),
            "drift: served != direct predict")
        rep["drift"] = {"in": r_in, "shifted": r_sh,
                        "stats": drift_rep["stats"], "latency": lat,
                        "shift_sd": sd}
        lap("drift_serving")
        bench = run_bench_drift(serve_model, device=dev, max_batch_rows=4096,
                                max_wait_ms=2.0, feature_pool=pool, seed=0,
                                **DRIFT_BENCH)
        rep["drift_bench"] = {k: v for k, v in bench.items()
                              if k != "drift_windows"}
        lap("drift_bench")

        # (c) the HTTP routes on the card
        serve_path = os.path.join(CLI_DIR, "serve.dryad")
        serve_model.save(serve_path)
        server = PredictServer(device=dev)
        server.load_model(serve_path)
        httpd = make_http_server(server, port=0)
        hbase = f"http://127.0.0.1:{httpd.server_address[1]}"
        hth = threading.Thread(target=httpd.serve_forever, daemon=True)
        hth.start()
        boosters = {1: serve_model, 2: b}
        rows = Xv[:64]
        direct = {v: bo.predict(rows, raw_score=True, device=dev)
                  for v, bo in boosters.items()}
        admin = []
        buf = enable_tracing()
        buf.clear()
        try:
            def served(expect):
                out = json.loads(_post(hbase + "/predict",
                                       {"rows": rows.tolist(),
                                        "raw": True}).read())
                check(out["version"] == expect and np.array_equal(
                    np.asarray(out["predictions"], np.float32),
                    direct[expect]),
                    f"http: /predict after {admin[-1]} != version "
                    f"{expect}'s direct predict")

            admin.append(json.loads(_scrape(hbase + "/models")))
            check(admin[-1] == {"active": 1, "versions": [1],
                                "aliases": {}}, f"http: {admin[-1]}")
            admin.append(json.loads(_post(hbase + "/models/load",
                                          {"path": model,
                                           "name": "cli"}).read()))
            check(admin[-1] == {"version": 2}, f"http: load {admin[-1]}")
            served(2)
            admin.append(json.loads(_post(hbase + "/models/activate",
                                          {"version": 1}).read()))
            served(1)
            admin.append(json.loads(_post(hbase + "/models/rollback",
                                          {}).read()))
            check(admin[-1] == {"version": 2}, f"http: rollback {admin[-1]}")
            served(2)
            admin.append(json.loads(_scrape(hbase + "/models")))
            check(admin[-1]["active"] == 2
                  and admin[-1]["aliases"] == {"cli": 2},
                  f"http: {admin[-1]}")
            resp = _post(hbase + "/predict", {"rows": rows[:3].tolist()},
                         headers={TRACE_HEADER: "phase37"})
            check(resp.headers[TRACE_HEADER] == "phase37", "http: trace id")
            minted = _post(hbase + "/predict",
                           {"rows": rows[:2].tolist()}).headers[TRACE_HEADER]
            ev = json.loads(_scrape(hbase + "/trace/events"))
            tagged = {e[4] for e in ev["events"] if len(e) > 4}
            check({"phase37", minted} <= tagged,
                  f"http: /trace/events lacks the trace ids ({tagged})")
            rep["trace_events"] = len(ev["events"])
        finally:
            disable_tracing()
            buf.clear()
            httpd.shutdown()
            httpd.server_close()
            server.stop()
            hth.join(60)
        rep["admin"] = admin
        del server, b
        lap("http_routes")

        # (d) F2 on the card: GOSS's |g| and a 7-class GOSS run
        Xc, yc = datasets.covertype_like(3000, seed=3)
        p = dt.Params.from_dict(F2_GOSS)
        obj = get_objective(p)
        init = np.asarray(obj.init_score(yc, None), np.float32).reshape(-1)
        score = torch.from_numpy(np.tile(init, (len(yc), 1))).to(dev)
        g, h = obj.grad_hess(score, torch.from_numpy(
            yc.astype(np.float32)).to(dev))
        sums = row_sum(g * g)[:, 0]
        absg = goss.correct_sqrt(sums).cpu().numpy()
        check(np.array_equal(absg, np.sqrt(sums.cpu().numpy())),
              "f2: the card's |g| != numpy's correctly rounded root")
        rep["f2_distinct_sums"] = int(np.unique(sums.cpu().numpy()).size)
        cds = dt.Dataset(Xc, yc, max_bins=64)
        ta = dt.train(F2_GOSS, cds, device=dev).tree_arrays()
        tb = dt.train(F2_GOSS, cds, device="cpu").tree_arrays()
        for k in ("feature", "threshold", "left", "right", "default_left"):
            check(np.array_equal(ta[k], tb[k]),
                  f"f2: the card's 7-class GOSS trees differ in {k}")
        rep["f2_max_value_diff"] = float(np.max(np.abs(ta["value"]
                                                       - tb["value"])))
        check(np.allclose(ta["value"], tb["value"], rtol=1e-4, atol=1e-6),
              "f2: leaf values beyond 1e-4")
        lap("f2")
    finally:
        set_default_registry(old_registry)
        shutil.rmtree(CLI_DIR, ignore_errors=True)
    rep["step_seconds"] = steps
    print("cli/drift: " + json.dumps(rep, default=str), flush=True)
    print("cli/drift: CLI train at the headline widths (9 K1 + 8 K2 a "
          "tree), /stats and the trace show its spans, profile = CPU "
          "profile, card predict = CPU predict, dump --text round-trips; "
          "shifted traffic breaches, in-distribution does not, answers "
          "bitwise with drift on and off; /models and /trace/events; F2 "
          "card = numpy", flush=True)
    report["cli"] = rep
    return launches, gen0_path


SUP_DIR = os.path.join(ROOT, "_sup_rows")
# phase 37's draw and headline config, 20 trees, a checkpoint every 4;
# the rows cut from phase 37's 2M + 200k for the script's time
SUP_ROWS = 1_000_000
SUP_VALID = 100_000
SUP = dict(CLI)
SUP_EVERY = 4
SUP_POINTS = ((5, "device_unavailable", "dispatch"),
              (9, "oom", "dispatch"),
              (12, "fetch_death", "fetch"))
# trees grown under SUP_POINTS: 0-4, then 4-8 from checkpoint 4, 8-11
# from checkpoint 8, 8-19 from checkpoint 8 again
SUP_GROWN = 5 + 5 + 4 + 12
STICKY_AT = 6                    # the sticky child's faulting dispatch
STICKY_TREES = 12
CHILD_TIMEOUT_S = 240


def fault_child(kind: str, d: str, device: str = "cuda") -> int:
    """Phase 38 (c)'s fresh processes on the card, over ``d``'s rows.
    ``oom``: a ``torch.empty`` of twice the card's memory, classified,
    then one headline tree grown in the same process.  ``sticky``: a
    supervised run whose hook indexes a CUDA tensor out of range at
    dispatch ``STICKY_AT`` and synchronises; it must fail closed, and the
    process exits 3.  Prints one JSON line."""
    import numpy as np
    import torch

    import dryad_tpu_torch as dt
    from dryad_tpu_torch.engine import cuda_build
    from dryad_tpu_torch.resilience import (FaultError, RetryPolicy,
                                            classify_fault, is_sticky,
                                            supervise_train)

    dev = torch.device(device)
    if dev.type == "cuda":
        cuda_build.build_all()
    out: dict = {"kind": kind}
    if kind == "oom":
        total = (torch.cuda.get_device_properties(0).total_memory
                 if dev.type == "cuda" else 1 << 40)
        try:
            torch.empty(2 * total, dtype=torch.uint8, device=dev)
            out["class"] = "allocated"
        except Exception as e:  # noqa: BLE001 — classified and reported
            out.update({"class": classify_fault(e), "sticky": is_sticky(e),
                        "type": type(e).__name__, "message": str(e)[:160]})
    ds = dt.Dataset(np.load(os.path.join(d, "X.npy")),
                    np.load(os.path.join(d, "y.npy")), max_bins=256)
    if kind == "oom":
        cuda_build.reset_counts()
        b = dt.train(dict(SUP, num_trees=1), ds, device=dev)
        out["launches"] = dict(cuda_build.counts)
        out["splits"] = int((b.tree_arrays()["feature"] >= 0).sum())
        print(json.dumps(out), flush=True)
        return 0

    def out_of_range(site: str, it: int) -> None:
        if site == "dispatch" and it == STICKY_AT:
            x = torch.zeros(4, device=dev)
            x[torch.tensor([1 << 30], device=dev)].sum().item()
            torch.cuda.synchronize(dev)

    try:
        supervise_train(dict(SUP, num_trees=STICKY_TREES), ds, device=dev,
                        checkpoint_dir=os.path.join(d, "ck"),
                        checkpoint_every=SUP_EVERY,
                        journal=os.path.join(d, "journal.jsonl"),
                        fault_injector=out_of_range,
                        policy=RetryPolicy(backoff_base_s=0.0))
    except FaultError as e:
        out.update({"reason": e.reason, "class": e.kind,
                    "cause": type(e.__cause__).__name__})
        print(json.dumps(out), flush=True)
        # the context is poisoned: leave without tearing it down
        os._exit(3)
    out["reason"] = None
    print(json.dumps(out), flush=True)
    return 0


def _child(kind: str, dev) -> subprocess.Popen:
    code = ("import sys, chip_smoke; sys.exit(chip_smoke.fault_child("
            "sys.argv[1], sys.argv[2], sys.argv[3]))")
    return subprocess.Popen([sys.executable, "-c", code, kind, SUP_DIR,
                             dev.type],
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _child_out(proc: subprocess.Popen, what: str, t0: float) -> tuple:
    """(return code, the last stdout line's JSON, seconds since ``t0``,
    its launch) of a child, killed at ``CHILD_TIMEOUT_S``."""
    try:
        out, err = proc.communicate(timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"supervise: the {what} child passed {CHILD_TIMEOUT_S} s")
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    check(bool(lines), f"supervise: the {what} child printed no result "
          f"(rc {proc.returncode}):\n{err[-3000:]}")
    return proc.returncode, json.loads(lines[-1]), time.perf_counter() - t0


def phase_supervise(dt, a, Xv, dev, report) -> dict:
    """Phase 38: the native host layer on the card's host, a supervised
    run at the headline widths on the card, and real CUDA faults in fresh
    processes (module doc).  Returns the supervised run's launches."""
    import numpy as np

    from dryad_tpu_torch import datasets, native
    from dryad_tpu_torch.data.binning import bin_matrix
    from dryad_tpu_torch.data.sketch import sketch_features
    from dryad_tpu_torch.engine import cuda_build
    from dryad_tpu_torch.resilience import (FaultInjector, RetryPolicy,
                                            RunJournal, supervise_train)

    rep: dict = {}
    steps, clock = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        steps[name] = now - clock[0]
        clock[0] = now

    # (a) native sketch and bins of the 1M held-out rows = the numpy path
    check(native.available(), "native: the host layer is not available")
    rep["native_build_s"] = native.build_seconds
    timed = {}
    for arm in ("native", "numpy"):
        if arm == "numpy":
            os.environ["DRYAD_NATIVE"] = "0"
        try:
            native.reset_counts()
            t0 = time.perf_counter()
            mapper = sketch_features(Xv, max_bins=256)
            t1 = time.perf_counter()
            xb = bin_matrix(Xv, mapper)
            t2 = time.perf_counter()
        finally:
            os.environ.pop("DRYAD_NATIVE", None)
        timed[arm] = (mapper, xb, dict(native.counts))
        rep[f"{arm}_sketch_s"], rep[f"{arm}_bin_s"] = t1 - t0, t2 - t1
    (mn, xn, cn), (mp, xp, cp) = timed["native"], timed["numpy"]
    check(cn == {"sketch": Xv.shape[1], "bin": 1}
          and cp == {"sketch": 0, "bin": 0},
          f"native: counts {cn} native, {cp} numpy")
    check(all(np.array_equal(fn.edges, fp.edges)
              and fn.edges.dtype == fp.edges.dtype
              for fn, fp in zip(mn.features, mp.features))
          and mn.to_json_dict() == mp.to_json_dict(),
          "native: sketch edges != the numpy path's")
    check(xn.dtype == xp.dtype and np.array_equal(xn, xp),
          "native: bins != the numpy path's")
    del timed, mn, xn, mp, xp
    built = ("reused" if native.build_seconds is None
             else f"built in {native.build_seconds:.2f} s")
    print(f"native host layer: {built}; "
          f"{len(Xv)} x {Xv.shape[1]} sketch {rep['native_sketch_s']:.3f} s / "
          f"numpy {rep['numpy_sketch_s']:.3f} s, bins "
          f"{rep['native_bin_s']:.3f} s / numpy {rep['numpy_bin_s']:.3f} s "
          "(bit for bit); phase 2 binned natively in "
          f"{report['data_seconds']:.1f} s (17.3 s on the numpy path, "
          "measured in another call)", flush=True)
    lap("native")

    # (b) a supervised run at the headline widths = the straight run
    X, y = datasets.higgs_like(SUP_ROWS + SUP_VALID, seed=a.seed + 37)
    ds = dt.Dataset(X[:SUP_ROWS], y[:SUP_ROWS], max_bins=256)
    dv = ds.bind(X[SUP_ROWS:], y[SUP_ROWS:])
    Xs = X[SUP_ROWS:]
    os.makedirs(SUP_DIR, exist_ok=True)
    np.save(os.path.join(SUP_DIR, "X.npy"), X[:SUP_ROWS])
    np.save(os.path.join(SUP_DIR, "y.npy"), y[:SUP_ROWS])
    with open(os.path.join(SUP_DIR, "cfg.json"), "w") as fh:
        json.dump(dict(SUP, num_trees=STICKY_TREES), fh)
    del X, y
    ds.device_arrays(dev)        # the uploads, outside both walls
    dv.device_arrays(dev)
    lap("data")
    children: list = []
    try:
        # (c)'s first two children start now and run beside (b), for the
        # script's time (their set-up is host work; (b)'s walls are
        # noisier for it)
        t_children = time.perf_counter()
        oom, sticky = _child("oom", dev), _child("sticky", dev)
        children += [oom, sticky]
        t0 = time.perf_counter()
        straight = dt.train(SUP, ds, [dv], device=dev)
        sync()
        rep["straight_wall_s"] = time.perf_counter() - t0
        injector = FaultInjector(SUP_POINTS)
        journal = os.path.join(SUP_DIR, "supervised.jsonl")
        cuda_build.reset_counts()
        t0 = time.perf_counter()
        sup = supervise_train(SUP, ds, [dv], device=dev,
                              checkpoint_dir=os.path.join(SUP_DIR, "sck"),
                              checkpoint_every=SUP_EVERY, journal=journal,
                              fault_injector=injector,
                              policy=RetryPolicy(backoff_base_s=0.0))
        sync()
        rep["supervised_wall_s"] = time.perf_counter() - t0
        launches = dict(cuda_build.counts)
        check(injector.pending == 0, "supervise: a fault point never fired")
        check_launches(launches, {"hist": 9 * SUP_GROWN,
                                  "perm": 8 * SUP_GROWN},
                       "supervised run (replays included)")
        ta, tb = straight.tree_arrays(), sup.tree_arrays()
        for k in ta:
            check(np.array_equal(ta[k], tb[k]),
                  f"supervise: the supervised trees differ in {k}")
        check(sup.train_state.get("eval_history")
              == straight.train_state.get("eval_history"),
              "supervise: eval history != the straight run's")
        check(np.array_equal(predict_rows(sup, Xs, raw_score=True,
                                          device=dev),
                             predict_rows(straight, Xs, raw_score=True,
                                          device=dev)),
              "supervise: valid scores != the straight run's")
        kinds = [e["event"] for e in RunJournal.read(journal)]
        want = {"fault": 3, "resume": 3, "segment_start": 4, "complete": 1}
        rep["journal"] = {k: kinds.count(k) for k in want}
        check(rep["journal"] == want,
              f"supervise: journal holds {rep['journal']}, want {want}")
        rep["valid_auc_last"] = straight.train_state["eval_history"][
            "valid_auc"][-1][1]
        print(f"supervised: 3 faults, {SUP_GROWN} trees grown for "
              f"{SUP['num_trees']}, trees and valid scores bitwise the "
              f"straight run; wall {rep['supervised_wall_s']:.2f} s against "
              f"{rep['straight_wall_s']:.2f} s straight", flush=True)
        del sup, ds, dv
        lap("supervised")

        # (c) a real OOM and a real sticky fault in fresh processes, then
        # the sticky run's directory resumed by the command line
        rc, out, rep["oom_child_s"] = _child_out(oom, "oom", t_children)
        check(rc == 0 and out["class"] == "oom" and not out["sticky"],
              f"supervise: a 2x allocation did not classify as oom: {out}")
        check(out["launches"] == {"hist": 9, "hist_rows": 0, "perm": 8,
                                  "nat": 0} and out["splits"] > 0,
              f"supervise: no headline tree after the oom: {out}")
        rep["oom"] = out
        rc, out, rep["sticky_child_s"] = _child_out(sticky, "sticky",
                                                    t_children)
        check(rc != 0 and out["reason"] == "sticky_device_error"
              and out["class"] == "device_unavailable",
              f"supervise: the sticky child (rc {rc}) gave {out}")
        rep["sticky"] = dict(out, rc=rc)
        events = RunJournal.read(os.path.join(SUP_DIR, "journal.jsonl"))
        tail = [e for e in events if e["event"] in ("fault", "fail_closed")]
        check([e["event"] for e in tail] == ["fault", "fail_closed"]
              and tail[0]["kind"] == "device_unavailable"
              and tail[1]["reason"] == "sticky_device_error",
              f"supervise: the sticky journal ends {tail}")
        lap("children")
        model = os.path.join(SUP_DIR, "m.dryad")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "dryad_tpu_torch", "train", "--config",
             os.path.join(SUP_DIR, "cfg.json"), "--data",
             os.path.join(SUP_DIR, "X.npy"), "--label",
             os.path.join(SUP_DIR, "y.npy"), "--model", model,
             "--checkpoint-dir", os.path.join(SUP_DIR, "ck"),
             "--checkpoint-every", str(SUP_EVERY), "--supervise",
             "--resume", "--journal",
             os.path.join(SUP_DIR, "journal.jsonl"), "--device", dev.type,
             "--quiet"],
            cwd=ROOT, capture_output=True, text=True,
            timeout=CHILD_TIMEOUT_S)
        rep["resume_child_s"] = time.perf_counter() - t0
        check(res.returncode == 0,
              f"supervise: the fresh --resume failed:\n{res.stderr[-3000:]}")
        got = dt.Booster.load(model).tree_arrays()
        check(all(np.array_equal(got[k], v[:STICKY_TREES])
                  for k, v in ta.items()),
              "supervise: the fresh-process resume != the straight run")
        last = RunJournal.read_last_run(os.path.join(SUP_DIR,
                                                     "journal.jsonl"))
        check(last[1]["resume_iteration"] == 4
              and last[-1]["event"] == "complete",
              f"supervise: the resume's journal {last[:2]} ... {last[-1]}")
        lap("resume")
    finally:
        for proc in children:               # a failed check stops them too
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(SUP_DIR, ignore_errors=True)
    rep["step_seconds"] = steps
    print("supervise: " + json.dumps(rep, default=str), flush=True)
    print("supervise: native sketch and bins = numpy's bit for bit; a "
          "supervised run with 3 injected faults = the straight run (9 K1 "
          "+ 8 K2 a grown tree); a real OOM classified and survived; a "
          "real sticky fault failed closed; its directory resumed in a "
          "fresh process bitwise", flush=True)
    report["supervise"] = rep
    return launches


FLEET_DIR = os.path.join(ROOT, "_fleet")
FLEET_STARTUP_S = 120.0          # a replica's torch import, card and warmup
FLEET_TIMEOUT_S = 30.0           # every HTTP call of the phase
FLEET_DRIFT_WINDOW = 8192        # the replicas' drift window (serve default)
FLEET_PSI = 0.25                 # the router's PSI budget
FLEET_SHIFT = 3.0                # the covariate scale of the shifted traffic
FLEET_RETRAIN_ROWS = 300_000     # higgs_like(..., seed + 39), scaled
FLEET_RETRAIN_TREES = 10
FLEET_MAX_INFLIGHT = 8
FLEET_BENCH = dict(replica_counts=(1, 2), clients=4, duration_s=0.5,
                   sizes=(1, 64, 512), arms=1)


class _Pump:
    """Closed interactive loops through the router, one thread per
    client, each in 1 s legs of one client until ``halt``: the drift
    windows fill only while requests flow, so traffic spans the whole
    drill, and the clients' legs never end together, so the admission
    depth holds between legs."""

    def __init__(self, host, port, payloads, seed, clients=1):
        import threading

        from dryad_tpu_torch.fleet.bench import _closed_loop

        self.stats = {"requests": 0, "failures": 0, "trace_mismatches": 0}
        self._stop = threading.Event()
        lock = threading.Lock()

        def run(s):
            while not self._stop.is_set():
                s += clients
                r = _closed_loop(host, port, payloads, clients=1,
                                 duration_s=1.0, seed=s, trace=True)
                with lock:
                    for k in self.stats:
                        self.stats[k] += r[k]

        self._threads = [threading.Thread(target=run, args=(seed + i,),
                                          daemon=True)
                         for i in range(clients)]
        for t in self._threads:
            t.start()

    def halt(self) -> dict:
        self._stop.set()
        for t in self._threads:
            t.join(FLEET_TIMEOUT_S)
        return dict(self.stats)


def _journal_has(path: str, kind: str, **match) -> list:
    from dryad_tpu_torch.resilience.journal import RunJournal

    return [e for e in RunJournal.read(path) if e["event"] == kind
            and all(e.get(k) == v for k, v in match.items())]


def _wait(cond, timeout_s: float, what: str, interval_s: float = 0.1):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(interval_s)
    fail(f"fleet: {what} within {timeout_s:.0f} s")


def _http(host, port, method: str, path: str, body: bytes = b""):
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=FLEET_TIMEOUT_S)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def phase_fleet(dt, a, Xv, dev, report, gen0_path: str) -> dict:
    """Phase 39: the serving fleet and continual boosting (M15c, M15d) on
    the card (module doc).  Returns the in-process append's launches."""
    steps, clock = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        steps[name] = now - clock[0]
        clock[0] = now

    rep: dict = {}
    try:
        launches = _fleet_drills(dt, a, Xv, dev, rep, gen0_path, lap)
    finally:
        shutil.rmtree(FLEET_DIR, ignore_errors=True)
    rep["step_seconds"] = steps
    print("fleet: " + json.dumps(rep, default=str), flush=True)
    print("fleet: a replica crash under load dropped no request (journal "
          "crash -> respawn -> ready at generation 1, trace ids round-trip, "
          "one id holds both forwards, merged p99 gauges, answers = direct "
          "card predict); drift breach -> retrain on the card (its trees = "
          "the in-process append, 9 K1 + 8 K2 a tree) -> promoted; a bad "
          "generation rolled back; no recompile; a min-1 / max-3 ramp "
          "scaled up with zero shed and idle retired a replica", flush=True)
    report["fleet"] = rep
    return launches


def _fleet_drills(dt, a, Xv, dev, rep, gen0_path, lap) -> dict:
    """Phase 39's drills (a)-(c) and the bench; fills ``rep``."""
    import threading

    import numpy as np

    from dryad_tpu_torch import datasets
    from dryad_tpu_torch.continual import (JournalTailer, ProbationPublisher,
                                           RetrainScheduler,
                                           make_http_verdicts,
                                           make_subprocess_launcher,
                                           make_supervisor_push)
    from dryad_tpu_torch.engine import cuda_build
    from dryad_tpu_torch.fleet import (CapacityController, FleetRouter,
                                       FleetSupervisor, serve_argv)
    from dryad_tpu_torch.fleet.bench import _closed_loop, run_fleet_bench
    from dryad_tpu_torch.obs.registry import Registry
    from dryad_tpu_torch.obs.trace_export import (disable_tracing,
                                                  enable_tracing)
    from dryad_tpu_torch.resilience import faults as F
    from dryad_tpu_torch.resilience.journal import RunJournal
    from dryad_tpu_torch.resilience.policy import RetryPolicy

    gen0 = dt.Booster.load_any(gen0_path)
    check(gen0.profile is not None and gen0.num_iterations == CLI_TREES,
          "fleet: generation 0 is not phase 37's 20-tree profiled model")
    journal = os.path.join(FLEET_DIR, "fleet.jsonl")
    out_dir = os.path.join(FLEET_DIR, "continual")
    fresh = os.path.join(FLEET_DIR, "fresh.npz")
    Xr, yr = datasets.higgs_like(FLEET_RETRAIN_ROWS, seed=a.seed + 39)
    Xr = (Xr * np.float32(FLEET_SHIFT)).astype(np.float32)
    np.savez(fresh, X=Xr, y=yr)

    def payloads(sizes, scale=1.0, start=0):
        out, direct = {}, {}
        for n in sizes:
            rows = np.ascontiguousarray(Xv[start:start + n]
                                        * np.float32(scale))
            out[n] = json.dumps({"rows": rows.tolist()}).encode()
            direct[n] = gen0.predict(rows, device=dev)
            start += n
        return out, direct

    reg = Registry()
    buf = enable_tracing()            # the router's span ring (/trace)
    buf.clear()
    crash = F.encode_points([F.FaultPoint(site="request", iteration=2,
                                          kind=F.REPLICA_CRASH)])
    sup = FleetSupervisor(
        lambda i, pf: serve_argv([f"m={gen0_path}"], pf, device="cuda",
                                 warmup=True,
                                 drift_window=FLEET_DRIFT_WINDOW),
        1, policy=RetryPolicy(backoff_base_s=0.1, retry_budget=3),
        journal=journal, registry=reg, probe_interval_s=0.1,
        probe_timeout_s=5.0, startup_timeout_s=FLEET_STARTUP_S,
        fault_env={0: crash}, log_dir=FLEET_DIR)
    router = rs = ctrl = pump = None
    try:
        # r0 spawns in start(), r1 through add_slot() beside it, so the two
        # pay their torch import and the card's set-up at once
        with ThreadPoolExecutor(1) as pool:
            started = pool.submit(sup.start)
            _wait(lambda: sup.slots[0].proc is not None or started.done(),
                  FLEET_STARTUP_S, "r0 was never spawned", interval_s=0.01)
            r1 = sup.add_slot()
            started.result()
        check(r1 is not None and [s.name for s in sup.slots] == ["r0", "r1"]
              and all(s.routable for s in sup.slots),
              f"fleet: the two replicas did not start ({sup.states()})")
        # generous latency budgets: (c)'s pressure is admission depth, and
        # a breached window would hold its streak through the idle half
        router = FleetRouter(sup, registry=reg,
                             max_inflight=FLEET_MAX_INFLIGHT,
                             request_timeout_s=FLEET_TIMEOUT_S,
                             slo_budgets_ms={"interactive": 30000.0,
                                             "bulk": 30000.0},
                             drift_budget_psi=FLEET_PSI,
                             drift_breach_after=2).start()
        host, port = router.host, router.port
        lap("start")

        # (a) the crash drill: r0 dies at its second request under a
        # closed interactive loop; every answer is the direct predict's
        bodies, direct = payloads((1, 37, 211))
        base_bodies, base_direct = payloads((1024, 2048), start=1000)
        direct.update(base_direct)
        bad = []

        def on_response(status, body):
            if status == 200:
                got = np.asarray(json.loads(body)["predictions"],
                                 np.float32)
                if not np.array_equal(got, direct.get(len(got))):
                    bad.append(len(got))

        loop = _closed_loop(host, port, bodies, clients=3, duration_s=3.0,
                            seed=2, trace=True, on_response=on_response)
        st, body = _http(host, port, "GET", "/trace?k=0")
        trace_doc = json.loads(body)
        st_m, metrics = _http(host, port, "GET", "/metrics")
        metrics = metrics.decode()
        # while r0 respawns: the in-process append the retrain worker's
        # generation must equal (nothing else launches kernels here)
        cuda_build.reset_counts()
        want1 = dt.train(gen0.params.replace(num_trees=FLEET_RETRAIN_TREES),
                         dt.Dataset(Xr, yr, mapper=gen0.mapper), device=dev,
                         init_model=gen0)
        launches = dict(cuda_build.counts)
        check_launches(launches, {"hist": 9 * FLEET_RETRAIN_TREES,
                                  "perm": 8 * FLEET_RETRAIN_TREES},
                       "fleet append")
        del Xr, yr
        _wait(lambda: all(s.routable for s in sup.slots), FLEET_STARTUP_S,
              "replica 0 never respawned to routable")
        # the fleet whole again: baseline traffic (training's distribution)
        # through both replicas, answers bitwise, /drift green
        tail = _closed_loop(host, port, base_bodies, clients=2,
                            duration_s=0.5, seed=5, trace=True,
                            on_response=on_response)

        def drift():
            st, body = _http(host, port, "GET", "/drift")
            check(st == 200, f"fleet: GET /drift {st}")
            return json.loads(body)

        clean = drift()
        check(clean["models"].get("m", {}).get("rows")
              and not clean["models"]["m"]["breached"],
              f"fleet: baseline traffic breached: {clean['models']}")
        check(loop["failures"] == 0 and tail["failures"] == 0,
              f"fleet: {loop['failures']} + {tail['failures']} failed "
              "requests across the crash")
        check(loop["requests"] >= 20, f"fleet: {loop['requests']} requests")
        check(loop["trace_mismatches"] == 0 and tail["trace_mismatches"] == 0,
              "fleet: a trace id did not round-trip")
        check(not bad, f"fleet: {len(bad)} answers != the direct card "
              "predict")
        kinds = [(e["event"], e.get("replica"), e.get("generation"))
                 for e in RunJournal.read(journal)]
        seq = [k for k in kinds if k[1] == "r0" and k[0] in (
            "replica_crash", "replica_respawn", "replica_ready")]
        check(seq[:4] == [("replica_ready", "r0", 0),
                          ("replica_crash", "r0", 0),
                          ("replica_respawn", "r0", 0),
                          ("replica_ready", "r0", 1)],
              f"fleet: r0's journal runs {seq}")
        check(_journal_has(journal, "replica_crash")[0]["exit_code"]
              == F.REPLICA_CRASH_EXIT, "fleet: not the drill's exit code")
        forwards: dict = {}
        for ev in trace_doc["traceEvents"]:
            tid = ev.get("args", {}).get("trace") if ev["ph"] == "X" else None
            if tid and ev["args"]["path"].startswith("fleet.forward/"):
                forwards.setdefault(tid, set()).add(ev["args"]["path"])
        both = [t for t, p in forwards.items() if len(p) >= 2]
        check(st == 200 and both, "fleet: no trace id holds both forward "
              "attempts of the crashed request")
        check(st_m == 200 and "dryad_fleet_latency_ms{" in metrics
              and 'q="p99"' in metrics,
              "fleet: /metrics lacks the merged p99 gauges")
        rep["crash"] = {"requests": loop["requests"] + tail["requests"],
                        "retries": reg.counter("dryad_fleet_retry_total",
                                               "").value(),
                        "traces_with_both_forwards": len(both)}
        lap("crash")

        # (b) drift and continual boosting
        bad_gen = F.encode_points([F.FaultPoint(site="retrain", iteration=1,
                                                kind=F.BAD_GENERATION)])
        launch = make_subprocess_launcher(
            fresh, out_dir, trees=FLEET_RETRAIN_TREES, device="cuda",
            timeout_s=300.0, log_dir=out_dir,
            extra_env={F.CONTINUAL_FAULTS_ENV: bad_gen})
        publisher = ProbationPublisher(
            make_supervisor_push(sup), make_http_verdicts(host, port),
            journal=sup.journal, probation_polls=24, poll_interval_s=0.25,
            clear_after=2, registry=reg)
        rs = RetrainScheduler(
            {"m": gen0_path}, launch, journal=sup.journal,
            publisher=publisher,
            policy=RetryPolicy(backoff_base_s=0.5, retry_budget=3),
            cooldown_s=0.5, max_concurrent=1, poll_interval_s=0.1,
            source=JournalTailer(journal), registry=reg).start()
        shift_bodies, _ = payloads((1024, 2048), scale=FLEET_SHIFT,
                                   start=5000)
        pump = _Pump(host, port, shift_bodies, seed=100)

        def breached():
            drift()
            return _journal_has(journal, "drift_breach", model="m")

        _wait(breached, 60.0, "no drift_breach for the 3x shift",
              interval_s=0.3)
        lap("drift_breach")
        promoted = _wait(lambda: _journal_has(
            journal, "generation_promoted", model="m", generation=1), 240.0,
            "generation 1 was never promoted", interval_s=0.2)

        def green():
            v = drift()["models"].get("m") or {}
            return bool(v.get("rows")) and not v.get("breached")

        _wait(green, 60.0, "/drift never went green on generation 1",
              interval_s=0.3)
        lap("generation_1")
        _wait(lambda: rs.trigger("m", origin="forced") or _journal_has(
            journal, "retrain_triggered", model="m", generation=2), 30.0,
            "the forced retrain was never admitted", interval_s=0.1)
        _wait(lambda: _journal_has(journal, "generation_rolled_back",
                                   model="m", generation=2), 240.0,
              "the bad generation was never rolled back", interval_s=0.2)
        _wait(green, 60.0, "/drift never went green after the rollback",
              interval_s=0.3)
        lap("generation_2")
        drill = pump.halt()
        pump = None
        rs.stop(timeout_s=FLEET_TIMEOUT_S)
        state = rs.state()
        recompiles = {}
        for slot in sup.slots:
            s, text = slot.proc.request("GET", "/metrics",
                                        timeout_s=FLEET_TIMEOUT_S)
            check(s == 200, f"fleet: {slot.name} /metrics {s}")
            recompiles[slot.name] = sum(
                float(line.split()[-1]) for line in text.decode().splitlines()
                if line.startswith("dryad_recompile_unexpected_total"))
        check(all(v == 0 for v in recompiles.values()),
              f"fleet: unexpected recompiles {recompiles}")
        evs = RunJournal.read(journal)

        def n_of(kind, **m):
            return len([e for e in evs if e["event"] == kind and all(
                e.get(k) == v for k, v in m.items())])

        story = [(e["event"], e.get("generation"), e.get("job"),
                  e.get("reason"), e.get("verdict"))
                 for e in evs if e.get("model") == "m"]
        for kind, gen in (("retrain_triggered", 1), ("retrain_complete", 1),
                          ("push_probation", 1), ("generation_promoted", 1),
                          ("retrain_triggered", 2), ("retrain_complete", 2),
                          ("push_probation", 2),
                          ("generation_rolled_back", 2)):
            check(n_of(kind, model="m", generation=gen) == 1,
                  f"fleet: {n_of(kind, model='m', generation=gen)} {kind} "
                  f"of generation {gen}; the model's journal: {story}")
        rb = [e for e in evs if e["event"] == "generation_rolled_back"][0]
        check(rb["prior"] == promoted[0]["path"] and rb["restore_ok"],
              f"fleet: the rollback re-pushed {rb}")
        check(not n_of("generation_promoted", generation=2)
              and state["generation"].get("m") == 1 and not state["inflight"],
              f"fleet: scheduler state {state}")
        got1 = dt.Booster.load_any(promoted[0]["path"])
        for k, v in want1.tree_arrays().items():
            g = got1.tree_arrays()[k]
            diff = np.flatnonzero(np.asarray(g != v).ravel())
            check(g.shape == v.shape and diff.size == 0,
                  f"fleet: generation 1's {k} != the in-process append at "
                  f"{diff.size} entries, first {diff[:4].tolist()}: "
                  f"{np.asarray(g).ravel()[diff[:4]].tolist()} against "
                  f"{np.asarray(v).ravel()[diff[:4]].tolist()}")
        check(np.array_equal(got1.init_score, want1.init_score)
              and got1.num_iterations == CLI_TREES + FLEET_RETRAIN_TREES
              and got1.profile is not None,
              "fleet: generation 1 is not the appended, profiled model")
        fails = drill["failures"]
        check(fails == 0 and drill["trace_mismatches"] == 0
              and drill["requests"] >= 20,
              f"fleet: {fails} failed requests across the pushes "
              f"({drill})")
        rep["continual"] = {
            "drift_clean_psi_max": clean["models"]["m"]["psi_max"],
            "drift_breaches": n_of("drift_breach", model="m"),
            "retrain_wall_s": [e["wall_s"] for e in evs
                               if e["event"] == "retrain_complete"],
            "pushes": n_of("push_complete"),
            "requests": drill["requests"],
            "recompiles_unexpected": recompiles,
            "append_launches": launches}
        lap("continual_checks")

        # (c) elastic capacity: a min-1 / max-3 ramp, then idle.  The
        # pressure is admission depth (the latency budgets are generous),
        # so the ramp's requests are large: a replica's parse of them,
        # not this process's client and router threads, sets how long
        # each is in flight, and 7 clients hold the depth at or above
        # the controller's saturation (5 of 8) on any host.  The ramp
        # runs before the controller starts, so no poll sees the idle
        # gap before it, and stops once the scale-up's slot is
        # registered (its spawn begun); a one-client load, under the
        # idle bound, then runs through the spawn, the scale-up and the
        # retire that sustained headroom brings
        shed0 = reg.counter("dryad_fleet_shed_total", "").value()
        n0 = len(RunJournal.read(journal))
        ramp_bodies, _ = payloads((1024, 2048), start=20_000)
        ramp_pump = _Pump(host, port, ramp_bodies, seed=21, clients=7)
        try:
            ctrl = CapacityController(
                sup, router.state.capacity_signals, min_replicas=1,
                max_replicas=3, breach_after=2, idle_after=4,
                cooldown_up_s=120.0, cooldown_down_s=1.5, saturation=0.6,
                poll_interval_s=0.25, drain_timeout_s=FLEET_TIMEOUT_S,
                registry=reg).start()
            deadline = time.monotonic() + FLEET_TIMEOUT_S
            while time.monotonic() < deadline and len(sup.slots) < 3:
                time.sleep(0.02)
        finally:
            ramp = ramp_pump.halt()
        check(len(sup.slots) == 3, f"fleet: the ramp never started a "
              f"scale-up within {FLEET_TIMEOUT_S:.0f} s ({sup.states()}; "
              f"controller {ctrl.state()}; the journal's last lines "
              f"{RunJournal.read(journal)[n0:][-12:]})")
        idle, light = {}, threading.Event()

        def idle_loop():
            s = 60
            while not light.is_set():
                s += 1
                r = _closed_loop(host, port, bodies, clients=1,
                                 duration_s=0.5, seed=s)
                for k in ("requests", "failures"):
                    idle[k] = idle.get(k, 0) + r[k]

        th = threading.Thread(target=idle_loop, daemon=True)
        th.start()
        try:
            _wait(lambda: [e for e in RunJournal.read(journal)[n0:]
                           if e["event"] == "scale_up"], FLEET_STARTUP_S,
                  "the scale-up's replica never became ready")
            # the controller journals scale_down once the retire is done
            _wait(lambda: [e for e in RunJournal.read(journal)[n0:]
                           if e["event"] == "scale_down"], 60.0,
                  "sustained idle never retired a replica")
        finally:
            ctrl.stop(timeout_s=FLEET_TIMEOUT_S)
            light.set()
            th.join(FLEET_TIMEOUT_S)
        shed = reg.counter("dryad_fleet_shed_total", "").value() - shed0
        ek = [e["event"] for e in RunJournal.read(journal)[n0:]]
        check(ek.count("scale_up") == 1 and ek.count("scale_down") == 1
              and ek.index("scale_up") < ek.index("replica_retire")
              < ek.index("replica_retired") < ek.index("scale_down"),
              f"fleet: the capacity journal runs {ek}")
        check(shed == 0 and ramp["failures"] == 0
              and ramp["trace_mismatches"] == 0
              and idle.get("failures", 0) == 0,
              f"fleet: {shed} shed, {ramp['failures']} + "
              f"{idle.get('failures', 0)} failed across the ramp and drain")
        rep["elastic"] = {"ramp_requests": ramp["requests"],
                          "idle_requests": idle.get("requests", 0),
                          "slots_after": len(sup.slots)}
        lap("elastic")
    finally:
        if pump is not None:
            pump.halt()
        if rs is not None:
            rs.stop(timeout_s=FLEET_TIMEOUT_S)
        if ctrl is not None:
            ctrl.stop(timeout_s=FLEET_TIMEOUT_S)
        if router is not None:
            router.stop()
        sup.stop()
        disable_tracing()
        buf.clear()
    evs = RunJournal.read(journal)
    t_spawn, ready = {}, []
    for e in evs:
        key = (e.get("replica"), e.get("generation"))
        if e["event"] == "replica_spawn":
            t_spawn[key] = e["elapsed_s"]
        elif e["event"] == "replica_ready" and key in t_spawn:
            ready.append([f"{key[0]}g{key[1]}",
                          e["elapsed_s"] - t_spawn[key]])
    rep["seconds_to_ready"] = ready
    print("fleet: seconds to ready " + json.dumps(ready), flush=True)
    # the closed-loop bench at 1 and 2 replicas on the one card: routing
    # and shedding, not scale-out
    bench = run_fleet_bench(gen0_path, gen0.mapper.num_features,
                            device="cuda", swap_drill=False,
                            startup_timeout_s=FLEET_STARTUP_S, warmup=False,
                            seed=a.seed, **FLEET_BENCH)
    check(all(bench[f"fleet_failures_n{n}"] == 0
              for n in FLEET_BENCH["replica_counts"]),
          f"fleet bench: failed or shed requests {bench}")
    rep["bench"] = bench
    print("fleet bench (one card: routing and shedding, not scale-out): "
          + json.dumps({f"n{n}": {
              "rows_per_s": bench[f"fleet_rows_per_s_n{n}"],
              "failed_or_shed": bench[f"fleet_failures_n{n}"],
              **{f"{pr}_{q}_ms": bench[f"fleet_{pr}_{q}_ms_n{n}"]
                 for pr in ("interactive", "bulk") for q in ("p50", "p99")}}
              for n in FLEET_BENCH["replica_counts"]}), flush=True)
    lap("bench")
    return launches


def kernel_entry(name, source, replaces, launches, by_path, m, extra=None):
    e = {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches,
         "launches_by_path": by_path, "max_abs_err": m["max_abs_err"],
         "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
         "bound_by": m["bound_by"], "library_ms": m["library_ms"]}
    e.update({k: m[k] for k in _SHAPE_KEYS if k in m})
    if extra:
        e.update(extra)
    return e


def brief(m: dict) -> dict:
    return {k: m[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "max_abs_err", "P", *_SHAPE_KEYS)
            if k in m}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=HEADLINE_ROWS)
    ap.add_argument("--trees", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--eps-rows", type=int, default=EPS_ROWS)
    ap.add_argument("--eps-holdout", type=int, default=EPS_HOLDOUT)
    ap.add_argument("--eps-trees", type=int, default=8)
    ap.add_argument("--bag-trees", type=int, default=8)
    ap.add_argument("--bag-legacy-trees", type=int, default=5)
    ap.add_argument("--cov-default-trees", type=int, default=7)
    ap.add_argument("--serve-trees", type=int, default=SERVE["num_trees"])
    a = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import dryad_tpu_torch as dt
    from dryad_tpu_torch import datasets, native
    from dryad_tpu_torch.engine import cuda_build

    check(min(a.trees, a.eps_trees, a.bag_trees, a.bag_legacy_trees) >= 2,
          "--trees, --eps-trees, --bag-trees and --bag-legacy-trees must "
          "be >= 2 (metrics must move)")
    check(a.cov_default_trees >= 7, "--cov-default-trees must be >= 7 "
          "(the resume drill crashes at iteration 6)")
    check(a.serve_trees > 10, "--serve-trees must be > 10 (AUC must rise "
          "from tree 10)")
    t_start = time.perf_counter()
    # wall seconds of each group of phases, keyed by its phase numbers
    phase_seconds: dict = {}
    t_mark = [t_start]

    def mark(label: str) -> None:
        now = time.perf_counter()
        phase_seconds[label] = now - t_mark[0]
        t_mark[0] = now

    dev = torch.device("cuda")
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"card: {smi}", flush=True)
    report: dict = {"card": smi, "kind": kind, "rows": a.rows,
                    "trees": a.trees, "seed": a.seed, "eps_rows": a.eps_rows,
                    "eps_trees": a.eps_trees}

    # ---- 1. build (the native host layer's g++ beside the nvcc runs) ------
    gxx = ThreadPoolExecutor(1)
    native_build = gxx.submit(native.available)
    cuda_build.build_all()
    print(f"kernels built in {cuda_build.build_seconds:.2f} s", flush=True)
    report["build_seconds"] = cuda_build.build_seconds
    check(native_build.result(), "native: the host layer is not available")
    gxx.shutdown()
    print("native host layer " + ("reused" if native.build_seconds is None
                                  else f"built in {native.build_seconds:.2f} s"),
          flush=True)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "ptxas.txt"), "w") as f:
        for name, log in cuda_build.build_log.items():
            f.write(f"== {name}.cu\n{log}\n")
    report["sass_atomics"] = sass_atomics()
    print("SASS atomics: " + json.dumps(report["sass_atomics"]), flush=True)

    mark("1")
    # ---- 2. Higgs data ----------------------------------------------------
    if a.rows < HEADLINE_ROWS:
        print(f"rows cut to {a.rows} from the headline {HEADLINE_ROWS}",
              flush=True)
    t0 = time.perf_counter()
    X, y = datasets.higgs_like(a.rows + HOLDOUT_ROWS, seed=a.seed)
    native.reset_counts()
    ds = dt.Dataset(X[:a.rows], y[:a.rows], max_bins=256)
    report["native_counts_phase2"] = dict(native.counts)
    check(native.counts == {"sketch": 28, "bin": 1},
          f"data: the Dataset did not bin natively ({native.counts})")
    # the raw training rows stay for phase 34
    Xraw, Xv, yv = X[:a.rows], X[a.rows:], y[a.rows:]
    del X
    report["data_seconds"] = time.perf_counter() - t0
    check(ds.num_features == 28 and ds.mapper.total_bins == 256,
          f"data shape {ds.num_features} x {ds.mapper.total_bins} bins")
    print(f"data: {a.rows} x {ds.num_features}, "
          f"{ds.mapper.total_bins} bins, {report['data_seconds']:.1f} s",
          flush=True)

    # the later phases' raw rows, drawn meanwhile
    ahead = ThreadPoolExecutor(1)
    draw_ahead(ahead, "epsilon", datasets.epsilon_like,
               a.eps_rows + a.eps_holdout, num_features=EPS_FEATURES,
               seed=13)
    draw_ahead(ahead, "mslr", datasets.mslr_like,
               MSLR_TRAIN_QUERIES + MSLR_VALID_QUERIES,
               docs_per_query=MSLR_DOCS, num_features=MSLR_FEATURES,
               seed=17)
    draw_ahead(ahead, f"criteo{CRITEO_ROWS + CRITEO_HOLDOUT}",
               datasets.criteo_like, CRITEO_ROWS + CRITEO_HOLDOUT, seed=19)

    mark("2")
    # ---- 3-6. the wired path ----------------------------------------------
    w_params, w_booster, w_launches, w_level = phase_wired(
        dt, a, ds, Xv, yv, dev, report)
    # phase 33's yardstick
    w_trees = w_booster.tree_arrays()
    mark("3-6")
    # ---- 40. the audit: the op census on the card ------------------------
    audit_launches = phase_audit(ds, dev, w_params, w_trees, report)
    mark("40")
    # ---- 7. wired vs legacy, tie-free fixture -----------------------------
    phase_fixture(dt, dev, report)
    mark("7")
    # ---- 8-9. the legacy plan arm at the headline config ------------------
    l_launches, nat, rows = phase_legacy(dt, a, ds, Xv, yv, dev, w_params,
                                         w_booster, report)
    mark("8-9")
    # ---- 10-11. leaf-wise growth at Higgs-10M, wired and default depth ---
    lw_launches, lw_level, lw_perm = phase_leafwise_wired(
        dt, a, ds, Xv, yv, dev, report)
    ld_launches, ld_nat, ld_rows = phase_leafwise_default(
        dt, a, ds, Xv, yv, dev, report)
    mark("10-11")
    # ---- 12. the leaf-wise fixture ----------------------------------------
    phase_leafwise_fixture(dt, dev, report)
    mark("12")
    # ---- 13-15. the training loop: bagged and validated, resume, bagged
    # legacy arm -----------------------------------------------------------
    bag_params, dv, b_launches, b_root, b_perm = phase_bagged(
        dt, a, ds, Xv, yv, dev, report)
    r_launches = phase_resume(dt, ds, dv, Xv, dev, bag_params, report)
    bl_launches, bl_nat, bl_rows = phase_bagged_legacy(dt, a, ds, Xv, yv,
                                                       dev, report)
    mark("13-15")
    # ---- 24-27. GOSS, monotone constraints, DART and rf on the Higgs rows
    g_launches, g_root, g_perm = phase_goss(dt, a, ds, dv, Xv, yv, dev,
                                            report)
    mono_paths = phase_monotone(dt, a, ds, Xv, yv, dev, report)
    d_launches = phase_dart(dt, a, ds, dv, Xv, yv, dev, report)
    rf_launches, rf_root = phase_rf(dt, a, ds, dv, Xv, yv, dev, report)
    del dv
    mark("24-27")
    # ---- 28. the boosting modes' fixtures ---------------------------------
    mf_launches, mf_nat, mf_rows = phase_mode_fixtures(dt, a, dev, report)
    mark("28")
    # ---- 29-30. cv and the model API on the Higgs rows --------------------
    cv_launches = phase_cv(dt, ds, dev, report)
    phase_model_api(dt, w_booster, Xv, yv, dev, report)
    mark("29-30")
    # ---- 31. an estimator on the Covertype rows ---------------------------
    est_launches = phase_estimator(dt, dev, report)
    mark("31")
    # ---- 16. Epsilon-shaped regression, the Higgs tensors freed (the
    # Higgs rows stay on the host for phase 32) ----------------------------
    del w_booster
    gc.collect()
    torch.cuda.empty_cache()
    e_launches, e_root, e_level, eds, eXv_b, eyv = phase_epsilon(
        dt, a, dev, report)
    mark("16")
    # ---- 17-19. Covertype-shaped multiclass -------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    cds, cXv, cyv, cdv, report["covertype_data_seconds"] = covertype_data(dt)
    c_launches, c_root, c_level, c_perm = phase_covertype(
        dt, a, cds, cXv, cyv, cdv, dev, report)
    cd_launches, cr_launches = phase_covertype_defaults(
        dt, a, cds, cXv, cdv, dev, report)
    del cds, cXv, cyv, cdv
    cf_launches, cf_nat, cf_rows = phase_covertype_fixture(dt, a, dev,
                                                           report)
    mark("17-19")
    # ---- 20. MSLR-WEB30K LambdaMART --------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    m_launches, m_nat, m_root, m_rows, mslr_sets = phase_mslr(dt, a, dev,
                                                             report)
    mark("20")
    # ---- 21. the robust family on phase 16's Epsilon matrix --------------
    gc.collect()
    torch.cuda.empty_cache()
    rb_launches = phase_robust(dt, a, eds, eXv_b, eyv, dev, report)
    # phase 35's Epsilon rows, cut to REST_EPS_ROWS
    eps_cut = (np.ascontiguousarray(eds.X_binned[:REST_EPS_ROWS]),
               eds.y[:REST_EPS_ROWS].copy(), eds.mapper, eXv_b, eyv)
    del eds, eXv_b, eyv
    mark("21")
    # ---- 22-23. Criteo: CSR ingest, categorical splits, bundling --------
    gc.collect()
    torch.cuda.empty_cache()
    ct_launches, ct_root, ct_level, ct_perm = phase_criteo(dt, a, dev,
                                                           report)
    mark("22")
    gc.collect()
    torch.cuda.empty_cache()
    ctf_launches, ctf_nat, ctf_rows = phase_criteo_fixtures(dt, a, dev,
                                                            report)
    mark("23")
    # ---- 32. serving the headline model -----------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    sv_launches, serve_model = phase_serve(dt, a, ds, Xv, yv, dev, report)
    mark("32")
    # ---- 33. data-parallel training over a process group -----------------
    gc.collect()
    torch.cuda.empty_cache()
    dist_launches = phase_distributed(dt, a, ds, Xv, yv, dev, report,
                                      w_trees)
    mark("33")
    # ---- 34. streamed training, wide bins, 65536 leaves ------------------
    gc.collect()
    torch.cuda.empty_cache()
    st_paths, bins_1024 = phase_stream(dt, a, ds, Xraw, Xv, yv, dev, report)
    del Xraw
    mark("34")
    # ---- 35. the rest of distribution ------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    rest_launches = phase_rest(dt, a, ds, Xv, yv, dev, report, mslr_sets,
                               eps_cut, serve_model)
    del mslr_sets, eps_cut
    mark("35")
    # ---- 36. measurement and the dispatch policy -------------------------
    gc.collect()
    torch.cuda.empty_cache()
    pf_launches, ph_launches = phase_policy(dt, a, ds, Xv, yv, dev, report,
                                            serve_model)
    mark("36")
    # ---- 37. the command line, drift, the HTTP routes, F2 ---------------
    gc.collect()
    torch.cuda.empty_cache()
    cli_launches, gen0_path = phase_cli(dt, a, ds, Xv, dev, report,
                                        serve_model)
    del ds, serve_model
    mark("37")
    # ---- 38. the native host layer and supervised training --------------
    gc.collect()
    torch.cuda.empty_cache()
    sup_launches = phase_supervise(dt, a, Xv, dev, report)
    mark("38")
    # ---- 39. the serving fleet and continual boosting -------------------
    gc.collect()
    torch.cuda.empty_cache()
    fleet_launches = phase_fleet(dt, a, Xv, dev, report, gen0_path)
    del Xv, yv
    mark("39")
    ahead.shutdown()

    by_path = {"wired": w_launches, "legacy_higgs": l_launches,
               "leafwise_wired": lw_launches, "leafwise_default": ld_launches,
               "bagged_wired": b_launches, "resume": r_launches,
               "bagged_leafwise_default": bl_launches,
               "epsilon": e_launches, "covertype_depthwise": c_launches,
               "covertype_defaults": cd_launches,
               "covertype_resume": cr_launches,
               "covertype_fixture_legacy": cf_launches,
               "mslr": m_launches, "robust_epsilon": rb_launches,
               "criteo": ct_launches, "criteo_fixture_legacy": ctf_launches,
               "goss": g_launches, **mono_paths, "dart": d_launches,
               "rf": rf_launches,
               "goss_fixture_legacy": mf_launches["goss"],
               "monotone_fixture_legacy": mf_launches["monotone"],
               "cv": cv_launches, "estimator_covertype": est_launches,
               "serve_train": sv_launches, "distributed": dist_launches,
               **st_paths, "rest_of_distribution": rest_launches,
               "profile": pf_launches, "policy_headline": ph_launches,
               "cli_train": cli_launches, "supervised": sup_launches,
               "fleet_append": fleet_launches, "audit": audit_launches}

    def launches(k):
        return sum(p[k] for p in by_path.values())

    def paths(k):
        return {n: p[k] for n, p in by_path.items()}

    root = report["hist_root"]
    perm = report["perm"]
    kernels = [
        kernel_entry("hist", "dryad_tpu_torch/csrc/hist.cu",
                     "dryad_tpu/engine/pallas_hist.py:140", launches("hist"),
                     paths("hist"), w_level,
                     {"mode": "layout", "root": brief(root),
                      "leafwise_level": brief(lw_level),
                      "bagged_root": brief(b_root),
                      "covertype_root": brief(c_root),
                      "covertype_level": brief(c_level),
                      "criteo_root": brief(ct_root),
                      "criteo_level": brief(ct_level),
                      "goss_root": brief(g_root),
                      "rf_root": brief(rf_root),
                      "bins_1024_level": brief(bins_1024)
                      | {"a1_ms": bins_1024["a1_ms"]}}),
        kernel_entry("hist_rows", "dryad_tpu_torch/csrc/hist.cu",
                     "dryad_tpu/engine/pallas_hist.py:140",
                     launches("hist_rows"), paths("hist_rows"), rows,
                     {"mode": "rows", "leafwise_level": brief(ld_rows),
                      "bagged_leafwise_level": brief(bl_rows),
                      "epsilon_root": brief(e_root),
                      "epsilon_level": brief(e_level),
                      "covertype_fixture_level": brief(cf_rows),
                      "mslr_root": brief(m_root),
                      "mslr_level": brief(m_rows),
                      "criteo_fixture_level": brief(ctf_rows),
                      "mode_fixture_level": brief(mf_rows)}),
        kernel_entry("perm", "dryad_tpu_torch/csrc/perm.cu",
                     "dryad_tpu/engine/leafperm.py:94", launches("perm"),
                     paths("perm"), perm,
                     {"leafwise_level": brief(lw_perm),
                      "bagged_level0": brief(b_perm),
                      "covertype_level": brief(c_perm),
                      "criteo_level": brief(ct_perm),
                      "goss_level0": brief(g_perm)}),
        kernel_entry("nat", "dryad_tpu_torch/csrc/hist_nat.cu",
                     "dryad_tpu/engine/pallas_hist.py:719", launches("nat"),
                     paths("nat"), nat, {"leafwise_level": brief(ld_nat),
                                         "bagged_leafwise_level":
                                             brief(bl_nat),
                                         "covertype_fixture_level":
                                             brief(cf_nat),
                                         "mslr_level": brief(m_nat),
                                         "criteo_fixture_level":
                                             brief(ctf_nat),
                                         "mode_fixture_level":
                                             brief(mf_nat)}),
    ]
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    report["phase_seconds"] = phase_seconds
    print("phase seconds: " + json.dumps(phase_seconds), flush=True)
    with open(os.path.join(OUT, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"chip_smoke: all phases passed in {report['seconds']:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
