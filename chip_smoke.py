"""Start-up proof of deepof_tpu_torch on one CUDA GPU (built for an H100).

    python3 chip_smoke.py

1. Device: prints the card's name and power limit (nvidia-smi).
2. Kernels: builds csrc/*.cu with nvcc (one process per source, started
   together), prints each kernel's registers and spills, and holds each
   CUDA kernel against its plain PyTorch version on the card, at the
   serving path's shapes and at ragged ones, printing max|diff| beside the
   stated tolerance. The window kernel is checked as ``window_streams``
   (the serving block's node and edge tables from the serving layout, with
   mu = 0, sd = 1 and with a random affine; an odd row count at F = 117,
   whose row runs are misaligned; k = 2 with a repeated column; a block
   smaller than one CTA's chunk; 1-hour frames at F = 116 and 117, where
   every CTA walks several chunks; a single animal's tables, whose
   streams are no multiple of 4 floats) and in its (n, W, F) form,
   ``window_gather_standardize``, each with its launch plan; and the public
   path's block of the 158-column frame with the angle table as a third
   table (1, 42), generic k, held bit-equal. Then it is timed at the
   serving block against its bound, its plain version and the PyTorch
   chain it replaces (unfold, affine, index_select, stack, permute,
   contiguous) and the fill of the same output bytes, at a single-animal
   serving block and at the three-table block. The fused GRU layer is
   checked at both serving shapes (the second with its LayerNorm and final
   carries only, whose finals must equal those of the same launch with
   outputs), at the angle block's B = 4096 streams, at latent 4's widths,
   and on its L1 route: a misaligned x, a ragged B, H = 128 and long T;
   with its launch plan (weight route, streams per CTA, shared memory,
   CTAs per SM). Then it is timed, every step valid, at the two serving
   shapes, at the angle block's two and at H = 128 against its bound, its
   plain version and cuDNN.
3. Main path: a seeded synthetic 1-hour, 25 fps recording of two deepof_14
   animals (T = 90,000) through the port's entry points, timed on the
   process's first full-length run after the caching allocator was
   emptied (it pays the cudaMallocs) and on the second (the main path,
   whose buffers the allocator holds): fused preprocess,
   mm scaling + arena centring, the merged feature frame, device scaling and
   scanned_windowed_forward into a seeded VQ-VAE (recurrent + CensNet,
   latent 8, 10 components, window 25, block 4096). Checks the shapes,
   finiteness and soft-count sums, that both kernels launched during the
   run (the window kernel once per block, writing the node and the edge
   streams), and that the card agrees with the plain versions on the CPU
   over a 2,000-frame prefix.
4. Public path: a seeded DeepLabCut csv project (keys "test" and "test2",
   half an hour at 25 fps each, two deepof_14 animals) in a temporary
   directory, through ``Project(...).create(test=True)`` ->
   ``Coordinates.get_graph_dataset(window_size=25)`` ->
   ``embedding_per_video(batch_size=4096)`` into a seeded VQ-VAE (latent 8,
   10 components, no angle stream), timed by stage on a first pass after
   the caching allocator was emptied and on a second; then
   ``embedding_per_video`` once more with a bundle whose encoder has the
   angle stream. Checks the shapes, finiteness and soft-count sums, one
   window launch per block per recording and the GRU launches of each run,
   and card vs the CPU plain versions (float32) on a 2,000-frame copy of
   the project, with and without the angle stream.
5. Getters: the public project created with the test arenas and an ROI
   saved through ``save_arena_data`` and read back through
   ``create(arena_path=...)``; ``get_coords`` plain, arena-centred and
   aligned on Spine_1, polar, and at speed 1 for animal B;
   ``get_distances`` on the skeleton's edges, over all pairs and at speed
   1; ``get_angles`` in degrees; ``get_areas``; ``get_coords(roi_number=1)``.
   Each held card vs CPU (float32 both) on the 2,000-frame copy at 1e-4 of
   max(1, max |value|), then timed on the full project (the second of two
   calls), with the peak device memory.
6. Supervised: ``Coordinates.supervised_annotation(verbose=False,
   rng=np.random.RandomState(0))`` (the rule battery, the smoothing cascade
   and the immobility classifier, on the card) on the getters' projects:
   card vs CPU (float32 both) on the 2,000-frame copy, each column's count
   of differing frames printed, a binary column failing above 0.1% of its
   frames and a continuous one above 1e-4 of max(1, max |value|); then two
   calls on the full project, the second timed, with its peak device
   memory, its host reads and its 33 columns checked.
7. Training: the GRU layer's backward kernel (csrc/gru_scan_bwd.cu, through
   ``gru_scan_backward``: dx and the weight and bias gradients, formed in
   the kernel) held against ``gru_scan_backward_plain`` from the carries
   the forward kernel stores, at every GRU shape of a training step at
   batch 256 (the encoder's node and edge layers, the decoder's two under
   frame-validity masks), a ragged B, H = 128 and T = 120, two calls equal
   bit for bit, the launch plan logged; timed at the training shapes
   against its bound, its plain version and cuDNN's ``nn.GRU`` forward +
   backward; one train step card vs CPU (loss and every gradient) from the
   same weights and batch; the step's GRU launches (8 forward, 8 backward),
   time and peak memory; then ``Coordinates.deep_unsupervised_embedding``
   on the public project (one recording held out) for one epoch capped at
   50 train and 5 val batches, checking finite losses and the launches,
   and the saved bundle read back with ``ModelBundle.load`` and served with
   ``embedding_per_video``, its soft counts equal to the trained bundle's.
8. VaDE, the default model, on the training phase's project: one train
   step card vs CPU in pretrain and in main mode (loss and every gradient,
   same weights, batch and noise); the step's GRU launches (6 forward, 6
   backward), the time of each mode's step and the peak memory; then
   ``Coordinates.deep_unsupervised_embedding`` with no ``embedding_model``
   (pretrain, extract_latents + GMM init, main, each timed) for one
   pretrain and one main epoch of 50 + 5 batches, checking the history
   keys, finite losses and the launches; the saved bundle read back with
   ``ModelBundle.load``, both bundles served by ``embedding_per_video``
   (equal soft counts summing to 1, one window launch a block), and the
   trained bundle served card vs CPU on the 2,000-frame copy.
9. Cohort: deepof's unsupervised tutorial on three csv recordings of
   unequal length (45,000, 36,000 and 27,000 frames of two deepof_14
   animals, "test3" reading "test"'s arena from an arena file):
   ``get_graph_dataset(animal_id="B", center="Center", align="Spine_1",
   window_size=25, test_videos=1)`` (animal B's getter tables merged on the
   card and cut to the shortest recording: the float32 device route on the
   taken rows) -> ``deep_unsupervised_embedding`` at its default model (one
   pretrain and one main epoch of 50 + 5 batches) ->
   ``embedding_per_video``, each stage and the scaling pass timed, the
   kernels' launches counted from a reset (the window kernel one launch a
   block, on one animal's tables) and the peak memory read; then
   ``get_graph_dataset`` on the general route (robust scaling, groupwise
   sections, the second 600 s bin), its scaling pass timed; then card vs
   CPU on a prefix copy (2,000, 1,600 and 1,200 frames): the tutorial's
   scaled frames (float32 both, 1e-4 of max(1, max |value|)), the general
   route from the same merged values (float64, 1e-8) and the trained
   bundle's embeddings and soft counts (1e-4), with the count of hard
   labels that differ (reported, not checked). The cohort project reads
   its experimental conditions and start markers from csv files written
   beside its tables (a frame-integer and a time-string column), and ROI 1
   (left of the median x of B's Center) from its arena file.
10. Post-hoc, the group comparison on the cohort's VaDE outputs: the
   trained bundle served once more with the kernels' counts reset (21
   window and 84 GRU launches, no backward), ``supervised_annotation`` on
   the cohort, then the battery a user runs after embedding, each call
   twice on the card (the second timed) and once on the CPU from the same
   host inputs, held at 1e-10 relative (counts, frame indices and masks
   exactly): ``preprocess_time_bins(bin_size=600, bin_index=0,
   start_marker="frame_start")``, ``apply_rois_to_bin_info`` (ROI 1),
   ``get_time_on_cluster`` (share, counts in the bin, ``reduce_dim``, ROI),
   ``get_aggregated_embedding`` (mean, median in the bin, ``reduce_dim``),
   ``enrichment_across_conditions`` over the soft counts and over the
   tags, ``compute_transition_matrix_per_condition`` (aggregated with
   ``silence_diagonal``, per video, raw counts) -> ``compute_steady_state``
   (with and without the entropy), ``cluster_transition_matrix`` per
   recording and ``condition_distance_binning`` (growing window; AUC over
   time on cluster and over mean embeddings; Wasserstein). Then a seeded
   lab cohort (24 recordings x 45,000 frames, K = 10, D = 8, float64)
   through bench.py's post-hoc pass (time on cluster, mean embeddings,
   enrichment, per-condition transitions + steady states), three passes on
   the card and one on the CPU, frames/s and each stage's seconds, card vs
   CPU at 1e-10; and the card's VaDE on the reference file of the JAX
   package's outputs (tests/data/vade_reference.npz, written by
   scripts/make_torch_reference.py): embeddings and soft counts within
   1e-5, the count of differing hard labels reported.
11. Soft counts: the HMM recursion kernel (csrc/hmm_scan.cu, ``hmm_scan``,
   a chunked parallel-in-time scan) held against ``hmm_scan_plain`` on the
   card at K 2-32, N 1-24, T 1-1000, at T 5,000 (~100 chunks; against the
   plain version in float64) and at the cohort's (3, 26,976, 10) (the
   long-sequence rule: 1e-4 of max(1, |value|), gamma's difference
   reported), timed there and at the lab cohort's (24, 45,000, 10) against
   its bound, the chunk plans logged; then on the cohort,
   each call from a reset of the kernels' counts, ``embedding_per_video``
   with ``softcounts_extraction_method`` "gmm", "msm", "hmm" and
   "combined" at their defaults (shapes, rows summing to 1, hmm_scan
   launched only by "hmm"), ``recluster(states=10)`` and
   ``get_contrastive_soft_counts(states="bic")`` (2-25 states); card vs
   CPU on the prefix copy from the same host embeddings (distance-gate bins
   and hard labels differing on at most 0.1% of windows, soft counts where
   the bins agree within 1e-4 for the MSM decoders, 1e-2 for the GMM and
   2e-2 for the HMM, whose float32 posteriors are ill-conditioned; the
   "gmm" and "msm" fits on the card once more, equal bit for bit); and
   the 10-state HMM and the MSM on the seeded lab cohort, fit and decode
   timed, with launches and host reads.
12. Encoders: the TCN and transformer encoders and decoders, and
   Contrastive at its default TCN encoder, on the training phase's project
   (window 25, latent 8, 10 components). Serving: seeded VQ-VAE-TCN,
   VQ-VAE-transformer, VaDE-transformer and Contrastive-TCN bundles (seeded
   BatchNorm running statistics) through ``embedding_per_video(batch_size=
   4096)`` twice, the second timed from a reset of the kernels' counts (one
   window launch a block per recording, Contrastive's at half windows; no
   GRU or HMM launch); shapes, finiteness and row sums (Contrastive's "msm"
   soft counts); card vs CPU on a 500-frame copy of the recordings,
   embeddings and soft counts at 1e-4 of max(1, max |value|): the model on
   the card's scaled frames, and the whole path from each device's own
   project. Training: one step of VQ-VAE-TCN, VaDE-transformer and
   Contrastive-TCN on the card against the CPU's float64 step from the
   same weights, batch (the first 64 windows of the training batch) and
   draws with dropout at rate 0 (loss at 1e-5, each gradient at 2e-2 of
   max(1, its max |g_64|), the running statistics after it at 1e-4), then
   on the card at default dropout and batch 256: launches (none), 20 timed
   steps, peak memory. Fits: ``deep_unsupervised_embedding`` for one epoch
   of 20 + 2 batches (VaDE one pretrain epoch too) of each, finite losses,
   the saved bundle read back with ``ModelBundle.load`` serving equal
   outputs. Then the card's VQ-VAE-TCN and VaDE-transformer against the JAX
   package's outputs in tests/data/tcn_reference.npz and
   transformer_reference.npz within 1e-5.
13. Teacher: VaDE's TURTLE teacher and resumable checkpoints on the
   training phase's project. Card vs the CPU's plain versions from the same
   inputs and LeCun draws: the teacher on 2,048 training windows at 20 outer
   x 100 inner steps (tau_star and class weights at 1e-4 of max(1, |value|),
   float32), ``initialize_gmm_from_teacher`` (1e-6, float64) and one VaDE
   main step with distillation (loss and every gradient at the training
   phase's bars). Then ``deep_unsupervised_embedding`` at its default model
   with ``use_turtle_teacher=True`` at the teacher's defaults (500 outer x
   100 inner steps, a batch of 2,048), ``teacher_refresh_every=2``,
   ``reinit_gmm_on_refresh=True``, ``checkpoint_dir`` in a temporary
   directory, ``checkpoint_every=1`` and ``save_checkpoints=True``, for one
   pretrain and 4 main epochs of 50 + 5 batches, each stage and teacher fit
   timed and the kernels' launches counted from a reset; every fit's
   tau_star finite with rows summing to 1 within 1e-5, the alignment
   scores in [0, 1], the best-score bundle returned, saved, reloaded and
   served by ``embedding_per_video``; then the same call with ``epochs=5``,
   which resumes at epoch 4 from the saved state (model and optimiser equal
   bit for bit); checkpoint save and restore seconds and bytes; and the
   default teacher's outer step timed (ms, launches and device ms a step
   under the profiler).
14. Imputation: the Kalman/RTS kernel (csrc/kalman_rts.cu, ``kalman_rts``,
   a chunked parallel-in-time scan) held against ``kalman_rts_plain`` at
   one animal's block of a public recording (45,000, 28; the plain version
   on the card, timed) and both animals' (45,000, 56), a ragged (7, 33),
   one frame, tracks inside the covariances' transient (20, 29 frames) and
   around a chunk's length (64-66, 130 frames), and against a float64 serial
   chain at (45,000, 28) and a 2-hour animal (180,000, 28), all at 1e-5 of
   max(1, |value|), two calls equal bit for bit; timed at (45,000, 28 / 56)
   and (180,000, 28) with its chunk plan against the function's bytes bound
   and the algorithm's (its workspace traffic too), each launch's device
   time apart (the profiler); the public recordings with seeded occlusion
   runs of 4-60 frames on a third of their bodyparts and W absent for 150
   frames of "test", through
   ``Project(iterative_imputation="full").create(test=True)``
   -> ``get_graph_dataset(window_size=25)`` -> ``embedding_per_video
   (batch_size=4096)`` card vs CPU (float32 both) on the 2,000-frame copy at
   1e-4 of max(1, max |value|) (tables, scaled frames, embeddings, soft
   counts), then at full width from a reset of the kernels' counts (one
   ``kalman_rts`` launch an animal and recording, one window launch a
   block, four GRU launches a block), create timed by step (ridge, Kalman,
   constraints) beside a "partial" create of the same tables, every
   present animal's positions finite; then path B: the imputed project
   served in budget and with ``DEVICE_SCALE_BUDGET_BYTES`` and
   ``DEVICE_FRAMES_BYTES`` below one recording's scaled frame (restored in
   a finally), at the default settings (the general route in place of the
   device route, 1e-4) and with robust scaling (the general route both
   times, 1e-8), every frame kept on the host and uploaded to serve, the
   peak device memory of each run; then ``pca`` (linear, rbf),
   ``random_projection`` (1e-8) and ``scale_tables`` (exactly) card vs
   CPU.
15. Evaluation, on the cohort of phase 9 and the tags of phase 10: the
   trained bundle served with the kernels' counts reset (21 window and 84
   GRU launches); ``return_embedding_evaluation(window_size=25)`` in "any"
   and "center" (every behaviour timed on the card; card vs CPU over the
   first two), ``gmm_model_selection`` over the four covariance types
   (components 4 and 8, 2 runs of 1,000 rows, float64),
   ``chunk_summary_statistics`` of 4,000 chunks of animal B's kinematics,
   the normative KDE (``get_aggregated_embedding`` ->
   ``fit_normative_global_model`` on the controls ->
   ``score_against_normative``) of a seeded 24-experiment cohort, and
   ``kmeans_background`` + ``KernelExplainer`` on 10,000 chunk means
   through a seeded softmax-linear model, each twice on the card (the
   second timed) and once on the CPU from the same host inputs (float64
   parts at 1e-10, kNN fractions at 1e-4, settings exactly);
   ``chunk_cv_splitter`` and ``smooth_boolean_array`` on the host;
   ``align_deepof_kinematics_with_unsupervised_labels`` and
   ``annotate_time_chunks`` (by mean and by the summary statistics,
   10,000 chunks drawn) timed on the card, and card vs CPU over the raw
   distances, angles and areas on the prefix copy from each device's own
   project (labels and bin_info exactly, values at 1e-4 of max(1, max
   |value|)); then compactness, separability
   and kNN agreement on 24 x 45,000 seeded latent-8 windows with a ~10%
   behaviour, each timed card and CPU and held card vs CPU.
16. Paths mode, the configuration long-recordings-2mice-paths: two seeded
   SLEAP ``.npy`` recordings of two deepof_14 animals, 375,000 frames each
   (4 h 10 min at 25 fps; one past ``VERY_LARGE_VIDEO_FRAMES``, so
   ``create`` flags the project very large), through ``create(test=True)``
   -> ``get_graph_dataset(window_size=25, test_videos=1)`` (paths mode by
   default: the getters, ``merge`` and ``preprocess`` write ``.npy`` files,
   the windows are pointers to the scaled frames; its default samples_max
   takes 227,272 evenly spaced rows of each recording, as the JAX package
   does) -> the default VaDE fit
   (one pretrain and one main epoch of 50 + 5 batches) ->
   ``embedding_per_video(batch_size=4096)`` -> ``get_contrastive_soft_counts``
   at its defaults (the BIC scan over 2-25 states; pointers to
   ``{key}_soft_counts``) -> ``get_time_on_cluster`` over the first 600 s
   bin, read from the pointers. Every stored value is checked to be a
   pointer; the launches counted from a reset (a window launch a block, the
   GRU and GRU-backward launches of the fit and the serve, some
   ``hmm_scan``); shapes, finiteness and row sums; each stage's seconds, the
   bytes and seconds written and read, peak device memory and the process's
   peak RSS. Then the same project in memory: the default call (the fused
   lane) held to paths mode at 1e-4 of max(1, max |value|) (scaled frames,
   every 97th window, the trained bundle's embeddings, and the soft counts
   of paths mode's embeddings), its own embeddings decoded by paths mode's
   sticky HMM held by their hard labels (at most 0.1% differing of the
   windows whose posterior's largest entry is >= 0.75; a fit of their own
   only reported); the tutorial's call in both modes (the same route)
   equal bit for bit; and card vs CPU on a 2,000-frame copy in paths mode
   at 1e-4 (soft counts by confident hard labels, the CPU's embeddings
   decoded by the card's sticky HMM).
17. Detectors, DeepOF's cluster interpretation on phase 15's chunk
   statistics of the cohort (10,000 chunks of animal B's kinematics and
   tags drawn by ``annotate_time_chunks``, 11 statistics a column, those
   with under 20 values in the chunks or a fold's training chunks dropped;
   the served VaDE's labels; a fold a recording): from a reset of the
   kernels' counts, ``train_supervised_cluster_detectors`` (three
   leave-one-recording-out folds and the full fit of the scaler -> SMOTE ->
   gradient-boosted trees pipeline, max_iter 200, early stopping past
   10,000 resampled rows; the trees grown by csrc/gbm.cu's histogram and
   split kernels, predicted by its ensemble kernel),
   ``explain_clusters(samples=64)`` and ``compute_UMAP`` of the cohort's
   embeddings by their labels with a seeded torch projection as the
   reducer, each timed; the folds disjoint and covering every chunk, the
   AUCs in [0, 1] wherever sklearn's scorer forms one (as many labels in
   the fold's rows as its classifier has classes; NaN exactly elsewhere), predict_proba rows summing to 1, each row's Shapley values
   summing to f(x) - E f within 1e-6, the projection's shape; the full fit
   again from the numpy state it saw, equal bit for bit; the histogram and
   split kernels against their plain versions (bit for bit) at three
   seeded rounds of the full fit's rows, features and trees
   (``GBM_SHAPES``: the roots; a mid round whose smaller children hold
   ~10% of the rows and a deep one at ~1%, each with its siblings'
   subtraction, on a seeded partition) and at roots too few rows to split
   (the empty record, at the fit's features and at 37), the ensemble
   kernel over the chunk table, each timed against its bytes bound, its plain version and, for
   the roots' histograms, ``index_add_`` of the same sums; card vs CPU on a drawn
   copy (the three most frequent labels, 16 chunks a recording and label,
   16 columns with every value present): trees compared split by split (the count of differing
   trees printed), predict_proba and the AUCs within 1e-6 of max(1,
   |value|).
18. Prints a stage line of each path, a kernels line, and last
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failed check exits non-zero; without a CUDA device it exits 2 before
printing any result. Imports nothing of JAX or of deepof_tpu.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

T_FRAMES = 90_000
FPS = 25.0
WINDOW = 25
BLOCK = 4096
LATENT = 8
N_COMPONENTS = 10
TRAIN_BATCH = 256  # the JAX package's reference train-step batch (bench.py:368-424)
ANIMALS = ["B", "W"]
PREFIX = 2_000
MM_RATIO = 380.0 / 420.0
# The public path's project: two recordings of half an hour each.
PUBLIC_KEYS = ("test", "test2")
PUBLIC_FRAMES = T_FRAMES // 2

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and FP32 (no tensor core) FLOP/s.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
SPIN_CYCLES = 40_000_000  # ~20 ms at the H100's ~1.98 GHz boost clock

# The GRU layer at the serving path's two shapes, (B, F, H, D, norm,
# outputs): the first BiGRU of the edge streams, and the LayerNorm + second
# BiGRU of the node streams, which writes final carries only.
GRU_SERVING_SHAPES = [(4096 * 32, 16, 16, 2, False, True), (4096 * 28, 32, 8, 2, True, False)]
# The L1 weight route, not on the serving path: the first BiGRU of a
# latent-64 RecurrentBlock (d = 64, BiGRU(128, 128)) over the edge streams
# of one block of 4096 windows. Timed over 4096 streams: cuDNN's
# bidirectional GRU at 131,072 streams of width 128 fails (an illegal
# memory access, H100, PyTorch 2.11 + CUDA 12.8).
GRU_WIDE_SHAPE = (4096, 128, 128, 2, False, True)
# The angle stream's RecurrentBlock at latent 8 (conv 42 -> 16 channels): its
# two layers over one stream a window, B = 4096 a block.
GRU_ANGLE_SHAPES = [(4096, 16, 16, 2, False, True), (4096, 32, 8, 2, True, False)]

# The GRU layers of one training step at batch 256, two deepof_14 animals
# (28 nodes, 32 edges), latent 8, (B, F, H, outputs, mask): the encoder's
# node and edge gru1 and gru2 (gru2 behind F.layer_norm, final carries
# only) under prefix masks (zero-length prefixes among them), and the
# decoder's two BiGRUs under frame-validity masks (any frames).
GRU_TRAIN_SHAPES = [
    (TRAIN_BATCH * 28, 16, 16, True, "prefix"), (TRAIN_BATCH * 28, 32, 8, False, "prefix"),
    (TRAIN_BATCH * 32, 16, 16, True, "prefix"), (TRAIN_BATCH * 32, 32, 8, False, "prefix"),
    (TRAIN_BATCH, 8, 8, True, "random"), (TRAIN_BATCH, 16, 16, True, "random"),
]
# One epoch of the training phase, capped as ``limit_*_batches`` cap it.
TRAIN_BATCHES, VAL_BATCHES = 50, 5
TIMED_STEPS = 20

# Tolerances, card kernel vs the plain version on the card.
# Windows: the same float ops in the same order -> 1e-6 absolute.
# GRU: the F-term projection and H-term recurrent dot sums, and the
# LayerNorm's row sums, in another order (sequential FMAs vs blocked
# matmuls), carried over 25 steps -> 2e-5 absolute.
WINDOW_TOL = 1e-6
GRU_TOL = 2e-5
# GRU backward: the kernel recomputes the gates with the forward's SFU
# exponentials (~1e-7 off), sums its recurrent products in another order
# than the plain version's matmuls and carries dh over 25 steps; its weight
# gradients then sum up to B*T = 204,800 terms (each CTA's in its own
# order, then the CTAs' partials). Bar: max |diff| <= 1e-4 * max(1, max
# |plain|) for each gradient tensor.
GRU_BWD_RTOL = 1e-4
# One train step, card vs CPU (float32 both, same weights and batch): the
# loss at 1e-4 relative; each parameter's gradient at 1e-3 of its own max
# |g_cpu| (no floor, so a small gradient is held to its own size): the
# card's SFU gates and summation orders, through the encoder, the
# codebook's straight-through path and both decoder passes.
STEP_RTOL = 1e-4
STEP_GRAD_RTOL = 1e-3
# Whole path, card vs CPU plain versions (float32 both): reductions over T
# (outlier thresholds, scaler statistics) and matmuls sum in other orders,
# ~1e-7 relative per op; through the encoder that grows to ~1e-5 of the
# output's scale. Bar: 1e-4 relative to the largest |value| on the CPU.
PATH_RTOL = 1e-4

# The getters phase: each call on the public project, (name, method,
# keywords, columns of a table), checked card vs CPU (float32 both) on its 2,000-frame copy at
# PATH_RTOL, per getter. ROI 1 is the half-plane left of the median x of
# animal B's Center, saved with the test arenas through save_arena_data.
GETTER_CALLS = (
    ("coords", "get_coords", {}, 56),
    ("coords_arena_aligned", "get_coords", {"center": "arena", "align": "Spine_1"}, 56),
    ("coords_polar", "get_coords", {"polar": True}, 56),
    ("coords_speed_B", "get_coords", {"speed": 1, "selected_id": "B"}, 14),
    ("distances_graph", "get_distances", {"filter_on_graph": True}, 32),
    ("distances_all_pairs", "get_distances", {"filter_on_graph": False}, 378),
    ("distances_speed", "get_distances", {"speed": 1}, 32),
    ("angles_degrees", "get_angles", {"degrees": True}, 42),
    ("areas", "get_areas", {}, 8),
    ("coords_roi", "get_coords", {"roi_number": 1}, 56),
)


def _synthesize(t: int, nodes, seed: int = 0):
    """Smooth random-walk multi-animal trajectories in pixel space
    (the JAX package's bench.py:30-39 workload generator)."""
    rng = np.random.default_rng(seed)
    n = len(nodes)
    base = rng.normal(size=(t, 2)).cumsum(axis=0) * 0.5 + 300.0
    offsets = rng.normal(scale=15.0, size=(1, n, 2))
    jitter = rng.normal(scale=1.0, size=(t, n, 2))
    pos = base[:, None, :] + offsets + jitter
    lik = np.clip(rng.beta(20, 1, size=(t, n)), 0, 1)
    return pos.astype(np.float32), lik.astype(np.float32)


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def _log(msg: str) -> None:
    print(f"chip_smoke: {msg}", flush=True)


def _cuda_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Device ms per call of ``fn``. The card first spins for ~20 ms, so that
    the host has queued every call before the first starts: the events then
    time the device, not the wrapper's host work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _gru_inputs(torch, g, dev, b, t, f, h, d, with_norm, full=False):
    """Seeded GRU-layer inputs on the card: x with prefix lengths 0..T (0 and
    T always present; masked rows zero, as the encoder's are), or all T
    where ``full``, stacked weights of 1/sqrt(fan-in) scale, and an optional
    LayerNorm."""
    x = torch.randn(b, t, f, generator=g)
    lengths = torch.randint(0, t + 1, (b,), generator=g)
    lengths[0], lengths[1] = 0, t
    if full:
        lengths[:] = t
    mask = torch.arange(t)[None] < lengths[:, None]
    x[~mask] = 0.0
    w = (
        torch.randn(d, f, 3 * h, generator=g) / f ** 0.5,
        torch.randn(d, 3 * h, generator=g) * 0.1,
        torch.randn(d, h, 3 * h, generator=g) / h ** 0.5,
        torch.randn(d, h, generator=g) * 0.1,
    )
    norm = None
    if with_norm:
        norm = ((1.0 + 0.2 * torch.randn(f, generator=g)).to(dev), (0.2 * torch.randn(f, generator=g)).to(dev), 1e-3)
    return x.to(dev), mask.to(dev), tuple(v.to(dev) for v in w), norm


def _window_inputs(torch, g, dev, rows, f, affine):
    x = torch.randn(rows, f, generator=g).to(dev)
    mu = torch.randn(f, generator=g).to(dev) if affine else torch.zeros(f, device=dev)
    sd = (torch.rand(f, generator=g) + 0.5).to(dev) if affine else torch.ones(f, device=dev)
    return x, mu, sd


def _check_kernels(torch, layout):
    """Phase 2: each kernel against its plain version on the card."""
    from deepof_tpu_torch.ops.gru_kernels import gru_scan, gru_scan_config, gru_scan_plain
    from deepof_tpu_torch.ops.window_kernels import (
        window_gather_standardize,
        window_gather_standardize_plain,
        window_streams,
        window_streams_config,
        window_streams_plain,
    )
    from deepof_tpu_torch.train.inference import stream_tables

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    n_feat = 3 * 28 + 32
    serving = stream_tables(layout)
    _, single_cols, *_, single_layout = _frame_layout(ANIMALS[:1])
    _, public_cols, *_, public_layout = _frame_layout(ANIMALS, include_angles=True)
    public = stream_tables(public_layout)
    rng = np.random.default_rng(0)
    win_err = 0.0
    # (label, rows, F, tables, affine, the fewest chunks a CTA must walk)
    for label, rows, f, tables, affine, min_chunks in [
        ("serving block", BLOCK + WINDOW - 1, n_feat, serving, False, 1),
        ("serving block, affine", BLOCK + WINDOW - 1, n_feat, serving, True, 1),
        ("odd R, F = 117, misaligned row runs", 1001, 117,
         [rng.integers(0, 117, (5, 3)), rng.integers(0, 117, (7, 1))], True, 1),
        ("k = 2, a repeated column", 777, n_feat, [np.array([[3, 3], [10, 50], [115, 0], [7, 7]])], True, 1),
        ("a block smaller than one CTA's chunk", WINDOW + 2, n_feat, serving, True, 1),
        # Shares larger than a chunk: the mbarrier's parity flips, the
        # staged rows are overwritten by the next copy, the offset tables
        # are reused, and at F = 117 chunks switch between the bulk copy
        # and coalesced loads as their row runs' alignment varies.
        ("a 1-hour frame, serving tables, several chunks a CTA", T_FRAMES, n_feat, serving, True, 2),
        ("a 1-hour frame, F = 117, several chunks a CTA", T_FRAMES, 117,
         [rng.integers(0, 117, (28, 3)), rng.integers(0, 117, (32, 1))], True, 2),
        # One deepof_14 animal: P = 14 * 25 * 3 is not a multiple of 4, so
        # both tables take the scalar-head-and-tail stores.
        ("single-animal serving block", BLOCK + WINDOW - 1, len(single_cols),
         stream_tables(single_layout), True, 1),
        # The public path's block with the angle stream: a third table (1, 42),
        # generic k not a multiple of 4, from the 158-column frame.
        ("public block, node + edge + angle tables", BLOCK + WINDOW - 1, len(public_cols), public, False, 1),
        ("public block, node + edge + angle tables, affine", BLOCK + WINDOW - 1, len(public_cols), public, True, 1),
    ]:
        x, mu, sd = _window_inputs(torch, g, dev, rows, f, affine)
        got = window_streams(x, tables, mu, sd, WINDOW)
        want = window_streams_plain(x, tables, mu, sd, WINDOW)
        if [o.shape for o in got] != [o.shape for o in want]:
            _fail(f"window_streams shapes {[o.shape for o in got]} != {[o.shape for o in want]}")
        if len(tables) == 3 and not all(torch.equal(a, b) for a, b in zip(got, want)):
            _fail(f"window_streams case {label!r} is not bit-equal to its plain version")
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        del got, want
        plan = window_streams_config(rows, f, WINDOW, [t.shape for t in tables])
        share = -(-(rows - WINDOW + 1) // plan["grid"])
        chunks = -(-share // plan["windows_per_chunk"])
        _log(f"window_streams {label}: R={rows} F={f} tables {[t.shape for t in tables]} {plan}, "
             f"{share} windows and {chunks} chunks a CTA: max|diff| {err:.3e} (tol {WINDOW_TOL:.0e})")
        if chunks < min_chunks:
            _fail(f"window_streams case {label!r} walks {chunks} chunks a CTA, fewer than {min_chunks}")
        if not err <= WINDOW_TOL:
            _fail(f"window_streams disagrees with its plain version: {err}")
        win_err = max(win_err, err)
    for rows, f, window, affine in [
        (BLOCK + WINDOW - 1, n_feat, WINDOW, False),  # serving block, mu=0, sd=1
        (BLOCK + WINDOW - 1, n_feat, WINDOW, True),
        (1001, 117, WINDOW, True),                    # odd T, F not a multiple of 4
        (40, 3, 8, True),
    ]:
        x, mu, sd = _window_inputs(torch, g, dev, rows, f, affine)
        err = (window_gather_standardize(x, mu, sd, window)
               - window_gather_standardize_plain(x, mu, sd, window)).abs().max().item()
        plan = window_streams_config(rows, f, window, [(1, f)])
        _log(f"window_gather_standardize T={rows} F={f} window={window} affine={affine} {plan}: "
             f"max|diff| {err:.3e} (tol {WINDOW_TOL:.0e})")
        if not err <= WINDOW_TOL:
            _fail(f"window_gather_standardize disagrees with its plain version: {err}")
        win_err = max(win_err, err)

    gru_err = 0.0
    cases = [
        # (B, T, F, H, D, norm, outputs, x 16-byte aligned)
        (4096 * 32, WINDOW, 16, 16, 2, False, True, True),  # serving: edge streams, BiGRU(2d)
        (4096 * 28, WINDOW, 32, 8, 2, True, False, True),   # serving: node streams, LN + BiGRU(d), finals only
        (4096, WINDOW, 16, 16, 2, False, True, True),       # the angle block, one stream a window
        (4096, WINDOW, 32, 8, 2, True, False, True),
        (5000, WINDOW, 8, 8, 2, False, True, True),         # latent 4 (register route), both layers
        (5000, WINDOW, 16, 4, 2, True, False, True),
        (4001, WINDOW, 16, 16, 2, False, True, False),      # misaligned x: the L1 route
        (777, WINDOW, 13, 12, 1, False, True, True),        # L1 route, ragged B, F not a multiple of 4
        (777, WINDOW, 13, 12, 2, True, False, True),
        (3001, WINDOW, 32, 128, 2, False, True, True),      # widest H, L1 route, float4 rows
        (3001, WINDOW, 40, 128, 1, True, True, True),
        # Long T: latent 64's two layers, and latent 8's first, whose
        # register-route tiles do not fit in shared memory at T = 600.
        (300, 120, 128, 128, 2, False, True, True),
        (300, 120, 256, 64, 2, True, False, True),
        (301, 600, 16, 16, 2, False, True, True),
        # The L1 route's LayerNorm statistics per lane and step: a tile's do
        # not fit in shared memory at T = 4000.
        (16, 4000, 24, 8, 2, True, False, True),
    ]
    for b, t, f, h, d, with_norm, outputs, aligned in cases:
        x, mask, w, norm = _gru_inputs(torch, g, dev, b, t, f, h, d, with_norm)
        if not aligned:
            x = torch.empty(x.numel() + 1, device=dev)[1:].view_as(x).copy_(x)
        reverse = (False, True) if d == 2 else (True,)
        out, fin = gru_scan(x, mask, *w, reverse, norm, outputs)
        p_out, p_fin = gru_scan_plain(x, mask, *w, reverse, norm, outputs)
        err = (fin - p_fin).abs().max().item()
        if outputs:
            err = max(err, (out - p_out).abs().max().item())
        else:
            # Final-only mode: the same launch's finals, bit for bit.
            _, fin_with_out = gru_scan(x, mask, *w, reverse, norm, True)
            if not torch.equal(fin, fin_with_out):
                _fail("gru_scan finals differ between outputs=False and outputs=True")
        cfg = gru_scan_config(t, f, h, d, outputs, with_norm) if aligned else "x misaligned: L1 route"
        _log(f"gru_scan B={b} T={t} F={f} H={h} D={d} norm={with_norm} outputs={outputs} {cfg}: "
             f"max|diff| {err:.3e} (tol {GRU_TOL:.0e})")
        if not err <= GRU_TOL:
            _fail(f"gru_scan disagrees with its plain version: {err}")
        gru_err = max(gru_err, err)
    torch.cuda.synchronize()
    return win_err, gru_err


def _gru_layer_cost(b, t, f, h, d, with_norm, outputs, valid):
    """(bytes, FP32 FLOP) the fused GRU layer must move and do: x, mask,
    weights and norm read once, outputs (if written) and finals written
    once; for each of the ``valid`` (unmasked) stream-steps, the projections
    6H(F + H) and ~12H gate ops per direction, and ~7F for its LayerNorm."""
    n_bytes = 4 * (b * t * f + d * (f + h + 1) * 3 * h + d * h + b * d * h) + b * t
    n_bytes += 4 * (2 * f if with_norm else 0) + (4 * b * t * d * h if outputs else 0)
    flop = valid * (d * (6 * h * (f + h) + 12 * h) + (7 * f if with_norm else 0))
    return n_bytes, flop


def _time_gru(torch, g, dev, b, f, h, d, with_norm, outputs):
    """The fused GRU layer at one serving shape: kernel, plain version and
    cuDNN yardstick times, and the bound."""
    from deepof_tpu_torch.ops.gru_kernels import gru_scan, gru_scan_config, gru_scan_plain

    # Every step valid, as nearly every window of a recording is: the bound
    # then counts all the work the kernel does.
    x, mask, w, norm = _gru_inputs(torch, g, dev, b, WINDOW, f, h, d, with_norm, full=True)
    reverse = (False, True)
    cudnn = torch.nn.GRU(f, h, batch_first=True, bidirectional=True).to(dev)
    ln = torch.nn.LayerNorm(f, eps=1e-3).to(dev)
    with torch.inference_mode():
        res = {
            "shape": f"x ({b}, {WINDOW}, {f}) float32, H={h}, D={d}, "
                     f"norm={with_norm}, outputs={outputs}",
            "weights": gru_scan_config(WINDOW, f, h, d, outputs, with_norm)["route"],
            "ms": _cuda_ms(torch, lambda: gru_scan(x, mask, *w, reverse, norm, outputs)),
            "plain_ms": _cuda_ms(torch, lambda: gru_scan_plain(x, mask, *w, reverse, norm, outputs), reps=3, warmup=1),
            # Yardstick only, never called by the port: cuDNN's bidirectional
            # GRU on the same streams (it does the input projection too, and
            # knows no mask), behind PyTorch's LayerNorm where the layer has one.
            "library_ms": _cuda_ms(torch, (lambda: cudnn(ln(x))) if with_norm else (lambda: cudnn(x))),
        }
    n_bytes, flop = _gru_layer_cost(b, WINDOW, f, h, d, with_norm, outputs, int(mask.sum()))
    by_bytes, by_ops = n_bytes / PEAK_BYTES * 1e3, flop / PEAK_FP32 * 1e3
    res["bound_ms"] = max(by_bytes, by_ops)
    res["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
    return res


def _time_window_block(torch, g, layout, f, fill=False):
    """The window kernel at one serving block of a frame with ``f`` columns
    and this stream layout: kernel, plain version and yardstick times, and
    the bound."""
    from deepof_tpu_torch.ops.window_kernels import window_streams, window_streams_config, window_streams_plain
    from deepof_tpu_torch.train.inference import stream_tables

    dev = torch.device("cuda")
    rows = BLOCK + WINDOW - 1
    x = torch.randn(rows, f, generator=g).to(dev)
    mu, sd = torch.zeros(f, device=dev), torch.ones(f, device=dev)
    inv = 1.0 / sd
    tables = stream_tables(layout)
    (n_nodes, _), (n_edges, _) = (t.shape for t in tables[:2])
    n_angles = len(layout["angle"]) if layout["angle"] is not None else 0
    node_idx = torch.as_tensor(np.asarray(layout["node"]), device=dev)
    edge_idx = torch.as_tensor(np.asarray(layout["edge"]), device=dev)
    angle_idx = torch.as_tensor(np.asarray(layout["angle"] or []), device=dev, dtype=torch.long)

    def chain():
        # Yardstick only, never called by the port: the PyTorch ops the
        # kernel replaces, each result materialised.
        w = (x.unfold(0, WINDOW, 1).transpose(1, 2) - mu) * inv
        xf = w.index_select(2, node_idx)
        xw = torch.stack([xf[..., :n_nodes], xf[..., n_nodes:2 * n_nodes], xf[..., 2 * n_nodes:]], dim=-1)
        aw = w.index_select(2, edge_idx)[..., None]
        out = (xw.permute(0, 2, 1, 3).contiguous().view(-1, WINDOW, 3),
               aw.permute(0, 2, 1, 3).contiguous().view(-1, WINDOW, 1))
        return out + ((w.index_select(2, angle_idx),) if n_angles else ())

    for got, want in zip(chain(), window_streams(x, tables, mu, sd, WINDOW)):
        if not torch.equal(got, want):
            _fail("the yardstick chain computes another function than window_streams")
    res = {
        "shape": f"rows ({rows}, {f}) -> nodes ({BLOCK * n_nodes}, {WINDOW}, 3) + "
                 f"edges ({BLOCK * n_edges}, {WINDOW}, 1)"
                 + (f" + angles ({BLOCK}, {WINDOW}, {n_angles})" if n_angles else "") + " float32",
        "plan": window_streams_config(rows, f, WINDOW, [t.shape for t in tables]),
        "ms": _cuda_ms(torch, lambda: window_streams(x, tables, mu, sd, WINDOW), reps=50),
        "plain_ms": _cuda_ms(torch, lambda: window_streams_plain(x, tables, mu, sd, WINDOW)),
        "library_ms": _cuda_ms(torch, chain),
    }
    if fill:
        # The card's write floor for the same outputs: PyTorch's fill kernel
        # over the same bytes (timed only).
        outs = [torch.empty(n * WINDOW * k, device=dev) for n, k in ((BLOCK * n_nodes, 3), (BLOCK * n_edges, 1))]
        res["fill_ms"] = _cuda_ms(torch, lambda: [o.fill_(0.0) for o in outs], reps=50)
    res["bound_ms"] = 4 * (rows * f + 2 * f + BLOCK * WINDOW * (3 * n_nodes + n_edges + n_angles)) / PEAK_BYTES * 1e3
    res["bound_by"] = "bytes"
    return res


def _time_kernels(torch, layout):
    """Kernel, plain-version and yardstick times at the serving shapes."""
    from deepof_tpu_torch.ops.window_kernels import window_gather_standardize

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1)
    f = 3 * 28 + 32
    win = _time_window_block(torch, g, layout, f, fill=True)
    x = torch.randn(BLOCK + WINDOW - 1, f, generator=g).to(dev)
    mu, sd = torch.zeros(f, device=dev), torch.ones(f, device=dev)
    # The (n, W, F) form on the same kernel, for the earlier slices' times.
    win["gather_standardize_ms"] = _cuda_ms(torch, lambda: window_gather_standardize(x, mu, sd, WINDOW), reps=50)
    # One deepof_14 animal's serving block, whose tables take the scalar stores.
    _, single_cols, *_, single_layout = _frame_layout(ANIMALS[:1])
    win["single_animal"] = _time_window_block(torch, g, single_layout, len(single_cols))
    # The public path's block with the angle stream: three tables, F = 158.
    _, public_cols, *_, public_layout = _frame_layout(ANIMALS, include_angles=True)
    win["with_angle_table"] = _time_window_block(torch, g, public_layout, len(public_cols))

    gru = [_time_gru(torch, g, dev, *shape)
           for shape in GRU_SERVING_SHAPES + [GRU_WIDE_SHAPE] + GRU_ANGLE_SHAPES]
    return win, gru


def _frame_layout(animals, include_angles=False):
    """The body graph of deepof_14 ``animals``, their merged feature frame's
    columns, pairs, bridges and owners, and the encoder's stream layout
    (with the angle stream's columns where ``include_angles``)."""
    from deepof_tpu_torch.core.graph import build_body_graph, connect_mouse
    from deepof_tpu_torch.data import merged_feature_layout

    bodyparts = sorted(f"{a}_{bp}" for a in animals for bp in connect_mouse().nodes)
    graph = build_body_graph(bodyparts, animals)
    nodes = list(graph.nodes)
    columns, pairs, bridges, owner = merged_feature_layout(graph, animals, include_angles=include_angles)
    node_cols = [(bp, "x") for bp in nodes] + [(bp, "y") for bp in nodes] + nodes
    layout = {
        "node": [columns.index(c) for c in node_cols],
        "edge": [columns.index(c) for c in sorted(graph.edge_names)],
        "angle": [columns.index(tuple(b)) for b in graph.bridge_names] if include_angles else None,
    }
    return graph, columns, pairs, bridges, owner, layout


def _serving_setup(torch):
    from deepof_tpu_torch.models import build_model
    from deepof_tpu_torch.ops.scaling import scale_plan
    from deepof_tpu_torch.train.inference import ModelBundle

    graph, columns, pairs, bridges, owner, layout = _frame_layout(ANIMALS)
    nodes = list(graph.nodes)
    slices = []
    for aid in ANIMALS:
        cols = [i for i, bp in enumerate(nodes) if bp.startswith(f"{aid}_")]
        slices.append((min(cols), max(cols) + 1))
    n, e = graph.n_nodes, graph.n_edges
    model = build_model(
        "VQVAE", (WINDOW, n, 3), (WINDOW, e, 1), graph.adjacency,
        latent_dim=LATENT, n_components=N_COMPONENTS,
        generator=torch.Generator().manual_seed(0), device="cuda",
    )
    spec = {"model": "VQVAE", "input_shape": [WINDOW, n, 3], "edge_feature_shape": [WINDOW, e, 1]}
    return {
        "nodes": nodes, "slices": tuple(slices), "columns": columns, "pairs": pairs,
        "bridges": bridges, "owner": owner, "layout": layout,
        "plan": scale_plan(columns, ANIMALS), "bundle": ModelBundle(model, spec),
    }


def _run_path(torch, setup, pos, lik, device, stages=None):
    """The serving path through the port's entry points. Returns
    (scaled frame, embeddings, soft counts); fills ``stages`` with seconds
    per stage."""
    from deepof_tpu_torch.data import _merged_features_program, _preprocess_positions
    from deepof_tpu_torch.ops.scaling import scale_merged_frame
    from deepof_tpu_torch.ops.smoothing import savgol_edges_host
    from deepof_tpu_torch.train.inference import ModelBundle, scanned_windowed_forward

    stages = {} if stages is None else stages
    bundle = setup["bundle"]
    if device == "cpu":
        bundle = ModelBundle(copy.deepcopy(bundle.model).to("cpu"), bundle.rebuild_spec)

    def mark(name, t0):
        if device == "cuda":
            torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return time.perf_counter()

    t = pos.shape[0]
    t0 = time.perf_counter()
    edges = savgol_edges_host(pos.reshape(t, -1), 15, 14)
    clean, presence = _preprocess_positions(
        pos, lik, edges, True, 15, 14, True, 0.75, 3.0, 3, setup["slices"], device=device
    )
    t0 = mark("preprocess", t0)
    mm = clean * MM_RATIO
    center = np.array([300.0, 300.0], np.float32) * MM_RATIO
    frame = _merged_features_program(
        mm, presence.to(torch.float32), center, setup["owner"], setup["pairs"],
        setup["bridges"], FPS, False, device=device,
    )
    t0 = mark("features", t0)
    scaled = scale_merged_frame(frame, setup["plan"])
    t0 = mark("scaling", t0)
    emb, sc = scanned_windowed_forward(
        bundle, scaled, setup["layout"], WINDOW, "VQVAE", block=BLOCK, device=device
    )
    mark("embed", t0)
    return scaled, emb, sc


def _timed_run(torch, setup, pos, lik):
    """One full-length run on the card: seconds per stage, seconds, the
    caching allocator's cudaMalloc calls during it, embeddings, soft
    counts."""
    stages = {}
    mallocs = torch.cuda.memory_stats().get("segment.all.allocated", 0)
    t0 = time.perf_counter()
    _, emb, sc = _run_path(torch, setup, pos, lik, "cuda", stages)
    total_s = time.perf_counter() - t0
    mallocs = torch.cuda.memory_stats().get("segment.all.allocated", 0) - mallocs
    return stages, total_s, mallocs, emb, sc


def _public_tables(t: int, seed: int = 0, lengths=None):
    """{key: (values (t, C), DLC column tuples)} of the public path's two
    recordings: two deepof_14 animals' seeded random walks with jittered
    bodyparts and likelihoods (the JAX package's bench.py:624-644); with
    ``lengths`` ({key: frames}), those recordings instead."""
    from deepof_tpu_torch.core.graph import connect_mouse

    bodyparts = sorted(connect_mouse(graph_preset="deepof_14").nodes)
    rng = np.random.default_rng(seed)
    out = {}
    for key, t in (lengths or {k: t for k in PUBLIC_KEYS}).items():
        cols, data = [], []
        for aid in ANIMALS:
            base = rng.normal(size=(t, 2)).cumsum(axis=0) * 0.5 + 300.0
            for bp in bodyparts:
                xy = base + rng.normal(scale=15.0, size=(1, 2)) + rng.normal(scale=1.0, size=(t, 2))
                for ci, coord in enumerate(("x", "y")):
                    cols.append(("chip_smoke", aid, bp, coord))
                    data.append(xy[:, ci])
                cols.append(("chip_smoke", aid, bp, "likelihood"))
                data.append(np.clip(rng.beta(20, 1, size=t), 0, 1))
        out[key] = (np.stack(data, axis=1), cols)
    return out


def _write_public_project(root: str, tables, rows) -> str:
    """A DeepLabCut csv project of the first ``rows`` frames (an int, or
    {key: int}) of ``tables`` under ``root``: Tables/ with one csv a
    recording (the column levels as rows led by their names, then rows led
    by the frame index) and Videos/ with a placeholder video each."""
    os.makedirs(f"{root}/Tables")
    os.makedirs(f"{root}/Videos")
    names = ["scorer", "individuals", "bodyparts", "coords"]
    for key, (values, cols) in tables.items():
        header = "\n".join(",".join([names[lvl]] + [c[lvl] for c in cols]) for lvl in range(4))
        v = values[:rows if isinstance(rows, int) else rows[key]]
        np.savetxt(f"{root}/Tables/{key}DLC_chip_smoke.csv", np.column_stack([np.arange(len(v)), v]),
                   fmt=["%d"] + ["%.6f"] * v.shape[1], delimiter=",", header=header, comments="")
        with open(f"{root}/Videos/{key}DLC_video.mp4", "wb") as f:
            f.write(b"\x00" * 64)
    return root


def _public_bundles(torch):
    """The seeded VQ-VAE of the public path (latent 8, 10 components, the
    rebuild spec bench.py:674-679 gives it, no angle stream), and the same
    with the encoder's angle stream."""
    from deepof_tpu_torch.models import build_model
    from deepof_tpu_torch.train.inference import ModelBundle

    graph, columns, *_ = _frame_layout(ANIMALS, include_angles=True)
    n, e, a = graph.n_nodes, graph.n_edges, len(graph.bridge_names)
    bundles = []
    for use_angles in (False, True):
        angle_shape = [WINDOW, a] if use_angles else None
        model = build_model(
            "VQVAE", (WINDOW, n, 3), (WINDOW, e, 1), graph.adjacency, latent_dim=LATENT,
            n_components=N_COMPONENTS, generator=torch.Generator().manual_seed(0), device="cuda",
            angle_feature_shape=angle_shape,
        )
        spec = {"model": "VQVAE", "input_shape": [WINDOW, n, 3], "edge_feature_shape": [WINDOW, e, 1],
                "n_components": N_COMPONENTS, "use_angles": use_angles, "angle_feature_shape": angle_shape}
        bundles.append(ModelBundle(model, spec))
    return graph, len(columns), bundles


def _run_public(torch, root, bundles, device, stages=None, precision="auto"):
    """Project(...).create(test=True) -> get_graph_dataset(window_size=25)
    -> embedding_per_video(batch_size=4096) for each bundle. Returns
    (merged TableDict, metainfo, adjacency, [(embeddings, soft counts)]);
    fills ``stages`` with seconds per stage (the embed stage of each
    bundle as embed, embed_1, ...)."""
    from deepof_tpu_torch.data import Project
    from deepof_tpu_torch.train.inference import ModelBundle, embedding_per_video

    stages = {} if stages is None else stages
    if device == "cpu":
        bundles = [ModelBundle(copy.deepcopy(b.model).to("cpu"), b.rebuild_spec) for b in bundles]

    def mark(name, t0):
        if device == "cuda":
            torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return time.perf_counter()

    t0 = time.perf_counter()
    coords = Project(
        project_path=root, project_name="public", video_path=f"{root}/Videos",
        table_path=f"{root}/Tables", arena="circular-autodetect", video_scale="380 mm",
        table_format="csv", frame_rate=FPS, animal_ids=ANIMALS, precision=precision, device=device,
    ).create(force=True, test=True, verbose=False)
    t0 = mark("create", t0)
    _, meta, adjacency, tab_dict, scaler = coords.get_graph_dataset(window_size=WINDOW)
    t0 = mark("graph_dataset", t0)
    outs = []
    for i, bundle in enumerate(bundles):
        outs.append(embedding_per_video(coords, tab_dict, bundle, meta, global_scaler=scaler, batch_size=BLOCK))
        t0 = mark("embed" if i == 0 else f"embed_{i}", t0)
    return tab_dict, meta, adjacency, outs


def _check_public_outputs(outs, rows):
    """Shapes, finiteness and soft-count sums of each bundle's results."""
    n_windows = rows - WINDOW + 1
    for emb, sc in outs:
        if sorted(emb) != sorted(PUBLIC_KEYS) or sorted(sc) != sorted(PUBLIC_KEYS):
            _fail(f"public path: recordings {sorted(emb)}, {sorted(sc)}")
        for key in PUBLIC_KEYS:
            if emb[key].shape != (n_windows, LATENT) or sc[key].shape != (n_windows, N_COMPONENTS):
                _fail(f"public path {key}: shapes {emb[key].shape}, {sc[key].shape}")
            if not (np.isfinite(emb[key]).all() and np.isfinite(sc[key]).all()):
                _fail(f"public path {key}: non-finite embeddings or soft counts")
            sum_err = float(np.abs(sc[key].sum(axis=1) - 1.0).max())
            if not sum_err <= 1e-4:
                _fail(f"public path {key}: soft counts do not sum to 1 (max |sum - 1| {sum_err})")


def _public_phase(torch, card, tmp):
    """Phase 4: the public path on the card, its projects written under
    ``tmp``. Returns (stage line, launches of each run, the full project's
    root, the recordings' tables)."""
    from deepof_tpu_torch.core.storage import get_dt
    from deepof_tpu_torch.io.readers import load_table
    from deepof_tpu_torch.ops.gru_kernels import gru_scan, gru_scan_backward
    from deepof_tpu_torch.ops.window_kernels import window_streams

    t_write = time.perf_counter()
    tables = _public_tables(PUBLIC_FRAMES)
    full = _write_public_project(os.path.join(tmp, "full"), tables, PUBLIC_FRAMES)
    prefix = _write_public_project(os.path.join(tmp, "prefix"), tables, PREFIX)
    write_s = time.perf_counter() - t_write
    graph, n_feat, bundles = _public_bundles(torch)

    # Card vs the CPU plain versions (float32 both) on the 2,000-frame
    # copy, with and without the angle stream (also the warm-up).
    on_card = _run_public(torch, prefix, bundles, "cuda")
    cpu = _run_public(torch, prefix, bundles, "cpu", precision="float32")
    _check_public_outputs(on_card[3], PREFIX)
    if not np.array_equal(on_card[2], graph.adjacency) or len(on_card[1]["angle_columns"]) != 42:
        _fail("public path: the graph dataset's adjacency or angle columns differ from the body graph's")
    copy_err = 0.0
    for key in PUBLIC_KEYS:
        pairs = [("scaled frame", get_dt(on_card[0]._scaled_frames, key), get_dt(cpu[0]._scaled_frames, key))]
        for i, ((c_emb, c_sc), (p_emb, p_sc)) in enumerate(zip(on_card[3], cpu[3])):
            pairs += [(f"bundle {i} embeddings", c_emb[key], p_emb[key]),
                      (f"bundle {i} soft counts", c_sc[key], p_sc[key])]
        for name, got, want in pairs:
            err = float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))
            _log(f"public copy of {PREFIX} frames, {key}, {name}, card vs CPU plain: "
                 f"max|diff| / max(1, max|cpu|) {err:.3e} (tol {PATH_RTOL:.0e})")
            if not err <= PATH_RTOL:
                _fail(f"card and CPU disagree on the public copy's {key} {name}: {err}")
            copy_err = max(copy_err, err)

    # Two timed passes of the main bundle, then its angle-stream twin.
    n_blocks = len(PUBLIC_KEYS) * -(-(PUBLIC_FRAMES - WINDOW + 1) // BLOCK)
    torch.cuda.empty_cache()
    first_stages = {}
    t0 = time.perf_counter()
    _run_public(torch, full, bundles[:1], "cuda", first_stages)
    first_s = time.perf_counter() - t0
    runs = {}
    for name, pass_bundles, gru_per_block in (("public", bundles[:1], 4), ("public_angles", bundles[1:], 6)):
        window_streams.launches = gru_scan.launches = gru_scan_backward.launches = 0
        stages = {}
        t0 = time.perf_counter()
        _, _, _, outs = _run_public(torch, full, pass_bundles, "cuda", stages)
        total_s = time.perf_counter() - t0
        launches = {"window_streams": window_streams.launches, "gru_scan": gru_scan.launches,
                    "gru_scan_bwd": gru_scan_backward.launches}
        _check_public_outputs(outs, PUBLIC_FRAMES)
        if launches["gru_scan_bwd"] != 0:
            _fail(f"{name}: serving launched the GRU backward kernel {launches['gru_scan_bwd']} times")
        if launches["window_streams"] != n_blocks:
            _fail(f"{name}: the window kernel launched {launches['window_streams']} times for {n_blocks} blocks")
        if launches["gru_scan"] != gru_per_block * n_blocks:
            _fail(f"{name}: the GRU kernel launched {launches['gru_scan']} times, not "
                  f"{gru_per_block} a block for {n_blocks} blocks")
        runs[name] = {"stages_s": stages, "total_s": total_s, "launches": launches}
        _log(f"{name} path: launches {launches}, stages {stages}")
    # The share of the create stage that reads the csv tables (host only).
    t0 = time.perf_counter()
    for key in PUBLIC_KEYS:
        load_table(f"{key}DLC_chip_smoke.csv", f"{full}/Tables", "csv")
    read_s = time.perf_counter() - t0
    line = {
        "path": "public", "frames": len(PUBLIC_KEYS) * PUBLIC_FRAMES, "recordings": len(PUBLIC_KEYS),
        "frame_columns": n_feat, "first_stages_s": first_stages, "first_total_s": first_s,
        "first_frames_per_s": len(PUBLIC_KEYS) * PUBLIC_FRAMES / first_s,
        "stages_s": runs["public"]["stages_s"], "total_s": runs["public"]["total_s"],
        "frames_per_s": len(PUBLIC_KEYS) * PUBLIC_FRAMES / runs["public"]["total_s"],
        "angles_stages_s": runs["public_angles"]["stages_s"], "angles_total_s": runs["public_angles"]["total_s"],
        "csv_read_s": read_s, "write_csv_s": write_s, "copy_max_rel_err": copy_err, "card": card,
    }
    return line, {k: v["launches"] for k, v in runs.items()}, full, tables


def _getters_project(root, tables, rows, device, precision="auto"):
    """The csv project under ``root`` created with the test arenas and ROI 1
    (the half-plane left of the median x of B's Center over the first
    ``rows`` frames) read back from an arena file through ``arena_path``."""
    from deepof_tpu_torch.data import Project

    proj = Project(
        project_path=root, project_name="getters", video_path=f"{root}/Videos", table_path=f"{root}/Tables",
        arena="circular-autodetect", video_scale="380 mm", table_format="csv", frame_rate=FPS,
        animal_ids=ANIMALS, precision=precision, device=device,
    )
    scales, params, _, res = proj.get_arena(test=True)
    rois = {}
    for key, (values, cols) in tables.items():
        xm = float(np.median(values[:rows, cols.index(("chip_smoke", "B", "Center", "x"))]))
        xm *= scales[key][3] / scales[key][2]
        rois[key] = {1: np.array([[-1e4, -1e4], [xm, -1e4], [xm, 1e4], [-1e4, 1e4]])}
    arena = os.path.join(root, f"arena_{device}.pkl")
    proj.save_arena_data(arena, params, rois, scales, res)
    return proj.create(force=True, arena_path=arena, verbose=False)


def _call_getter(coords, method, kw):
    """{key: (values, columns)} of one getter call."""
    return {key: (tab.realize(), tab.columns) for key, tab in getattr(coords, method)(**kw).items()}


def _getters_phase(torch, card, full, prefix, tables):
    """Phase 5: the getters on the public project. Each call of
    GETTER_CALLS card vs CPU (float32 both) on the 2,000-frame copy, then
    timed on the full project (the second of two calls; the first pays the
    feature pass of each recording), with the peak device memory of the
    timed calls. Returns the getters line."""
    t_phase = time.perf_counter()
    on_card = _getters_project(prefix, tables, PREFIX, "cuda")
    on_cpu = _getters_project(prefix, tables, PREFIX, "cpu", precision="float32")
    errs = {}
    for name, method, kw, _ in GETTER_CALLS:
        got, want = _call_getter(on_card, method, kw), _call_getter(on_cpu, method, kw)
        err = 0.0
        for key in PUBLIC_KEYS:
            (a, ca), (b, cb) = got[key], want[key]
            if ca != cb or a.shape != b.shape or not np.array_equal(np.isnan(a), np.isnan(b)):
                _fail(f"getter {name} on {key}: columns, shape or NaNs differ between card and CPU")
            scale = max(1.0, float(np.nanmax(np.abs(b)))) if np.isfinite(b).any() else 1.0
            diff = float(np.nanmax(np.abs(a - b))) if np.isfinite(b).any() else 0.0
            err = max(err, diff / scale)
        _log(f"getter {name} {kw}: card vs CPU on the {PREFIX}-frame copy, max|diff| / max(1, max|cpu|) "
             f"{err:.3e} (tol {PATH_RTOL:.0e})")
        if not err <= PATH_RTOL:
            _fail(f"getter {name}: card and CPU disagree ({err})")
        errs[name] = err

    t0 = time.perf_counter()
    coords = _getters_project(full, tables, PUBLIC_FRAMES, "cuda")
    create_s = time.perf_counter() - t0
    frames = len(PUBLIC_KEYS) * PUBLIC_FRAMES
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = {}
    for name, method, kw, n_cols in GETTER_CALLS:
        secs = []
        for _ in range(2):
            t0 = time.perf_counter()
            out = _call_getter(coords, method, kw)
            secs.append(time.perf_counter() - t0)
        for key in PUBLIC_KEYS:
            values, columns = out[key]
            if values.shape != (PUBLIC_FRAMES, n_cols) or len(columns) != n_cols or not np.isfinite(values).any():
                _fail(f"getter {name} on the full {key}: shape {values.shape}, {len(columns)} columns, "
                      f"or no finite value")
        timed[name] = {"s": secs[1], "frames_per_s": frames / secs[1], "first_s": secs[0], "columns": n_cols,
                       "card_vs_cpu": errs[name]}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    _log(f"getters: {timed}")
    line = {
        "path": "getters", "frames": frames, "recordings": len(PUBLIC_KEYS), "getters": timed,
        "peak_mem_gib": peak_gib, "store_entries": len(coords._derived._cache), "create_s": create_s,
        "phase_s": time.perf_counter() - t_phase, "card": card,
    }
    return line, {"full": coords, "card": on_card, "cpu": on_cpu}


SUPERVISED_COLUMNS = 33
SUPERVISED_BINARY_SHARE = 1e-3


def _supervised(coords):
    """{key: (values, columns)} of one seeded supervised_annotation call."""
    tabs = coords.supervised_annotation(verbose=False, rng=np.random.RandomState(0))
    return {key: (tab.realize(), tab.columns) for key, tab in tabs.items()}


def _supervised_phase(torch, card, projects):
    """Phase 6: supervised annotation on the getters' projects. Card vs CPU
    (float32 both) on the 2,000-frame copy, each column's differing frames
    printed; then two calls on the full project, the second timed with its
    peak device memory and host reads. Returns the supervised line."""
    from deepof_tpu_torch.annotate import supervised_annotation

    t_phase = time.perf_counter()
    got, want = _supervised(projects["card"]), _supervised(projects["cpu"])
    differing, worst_share, cont_err = {}, 0.0, 0.0
    for key in PUBLIC_KEYS:
        (a, ca), (b, cb) = got[key], want[key]
        if ca != cb or a.shape != (PREFIX, SUPERVISED_COLUMNS):
            _fail(f"supervised {key}: columns or shape differ between card and CPU ({a.shape})")
        for j, col in enumerate(ca):
            if col.endswith(("distance", "speed")):
                err = float(np.abs(a[:, j] - b[:, j]).max()) / max(1.0, float(np.abs(b[:, j]).max()))
                _log(f"supervised {key} {col}: card vs CPU max|diff| / max(1, max|cpu|) {err:.3e} "
                     f"(tol {PATH_RTOL:.0e})")
                if not err <= PATH_RTOL:
                    _fail(f"supervised {key} {col}: card and CPU disagree ({err})")
                cont_err = max(cont_err, err)
                continue
            n = int((a[:, j] != b[:, j]).sum())
            differing[f"{key}/{col}"] = n
            if not set(np.unique(a[:, j])) <= {0.0, 1.0} or n > SUPERVISED_BINARY_SHARE * PREFIX:
                _fail(f"supervised {key} {col}: {n} of {PREFIX} frames differ between card and CPU, or not 0/1")
            worst_share = max(worst_share, n / PREFIX)
    _log(f"supervised card vs CPU on the {PREFIX}-frame copy, differing frames per binary column: {differing}")

    coords = projects["full"]
    secs = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        supervised_annotation.host_reads.clear()
        t0 = time.perf_counter()
        out = _supervised(coords)
        secs.append(time.perf_counter() - t0)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    reads = dict(supervised_annotation.host_reads)
    if reads != {"mouse_lens_rows": len(ANIMALS) * len(PUBLIC_KEYS), "tag_table": len(PUBLIC_KEYS)}:
        _fail(f"supervised: host reads {reads}")
    shares = {}
    for key in PUBLIC_KEYS:
        values, columns = out[key]
        if values.shape != (PUBLIC_FRAMES, SUPERVISED_COLUMNS) or not np.isfinite(values).all():
            _fail(f"supervised {key}: shape {values.shape} or non-finite tags")
        shares[key] = {c: float(values[:, j].mean()) for j, c in enumerate(columns)
                       if not c.endswith(("distance", "speed"))}
    frames = len(PUBLIC_KEYS) * PUBLIC_FRAMES
    _log(f"supervised: {secs[1]:.4f} s ({frames / secs[1]:.0f} frames/s), first {secs[0]:.4f} s, "
         f"peak {peak_gib:.3f} GiB, host reads {reads}, shares of frames tagged {shares}")
    return {
        "path": "supervised", "frames": frames, "recordings": len(PUBLIC_KEYS), "columns": SUPERVISED_COLUMNS,
        "s": secs[1], "frames_per_s": frames / secs[1], "first_s": secs[0], "peak_mem_gib": peak_gib,
        "host_reads": reads, "card_vs_cpu": {"binary_max_share": worst_share, "continuous_max_rel_err": cont_err,
                                             "differing_frames": differing},
        "phase_s": time.perf_counter() - t_phase, "card": card,
    }


def _gru_train_inputs(torch, g, dev, b, t, f, h, d, mask_kind, full=False):
    """GRU-layer inputs of a training shape: prefix masks as the encoder's
    (``_gru_inputs``; zero-length prefixes among them), or frame-validity
    masks as the decoder's (any frame valid with probability 0.8, the
    inputs unmasked)."""
    x, mask, w, _ = _gru_inputs(torch, g, dev, b, t, f, h, d, False, full=full and mask_kind == "prefix")
    if mask_kind == "random":
        mask = (torch.rand(b, t, generator=g) < 0.8).to(dev)
        x = torch.randn(b, t, f, generator=g).to(dev)
    return x, mask, w


def _check_backward(torch):
    """Phase 7a: the GRU backward kernel (through ``gru_scan_backward``: the
    kernel forms dx and the weight and bias gradients, no matrix product
    follows it) against ``gru_scan_backward_plain`` on the card, from the
    carries the forward kernel stored, at every training shape, a ragged B
    with one reverse direction, the widest H and a longer T; a second call
    equal bit for bit. Returns (max abs error, max error relative to each
    tensor's max(1, max |plain|))."""
    from deepof_tpu_torch.ops.gru_kernels import (
        gru_scan_backward, gru_scan_backward_plain, gru_scan_bwd_config, gru_scan_carries,
    )

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(2)
    cases = [(b, WINDOW, f, h, 2, outputs, kind) for b, f, h, outputs, kind in GRU_TRAIN_SHAPES] + [
        (777, WINDOW, 13, 12, 1, True, "prefix"),    # ragged B, one reverse direction, F % 4 != 0
        (3001, WINDOW, 128, 128, 2, True, "prefix"),  # widest H: a group spans warps, the weight
                                                      # gradients in global partials, dx partials
        (301, 120, 16, 16, 2, True, "random"),        # longer T: walks in chunks, dx partials
    ]
    names = ("dx", "dW_i", "db_i", "dW_h", "db_hn")
    abs_err = rel_err = 0.0
    for b, t, f, h, d, outputs, kind in cases:
        x, mask, w = _gru_train_inputs(torch, g, dev, b, t, f, h, d, kind)
        reverse = (False, True) if d == 2 else (True,)
        out, fin, hs = gru_scan_carries(x, mask, *w, reverse, outputs)
        _, p_fin, p_hs = gru_scan_carries(x.cpu(), mask.cpu(), *[v.cpu() for v in w], reverse, outputs)
        hs_err = max((hs.cpu() - p_hs).abs().max().item(), (fin.cpu() - p_fin).abs().max().item())
        if not hs_err <= GRU_TOL:
            _fail(f"the forward kernel's stored carries disagree with the plain loop's: {hs_err}")
        d_out = torch.randn(b, t, d * h, generator=g).to(dev) if outputs else None
        # The decoder's layers get no gradient of their final carries.
        d_fin = torch.randn(b, d * h, generator=g).to(dev) if kind == "prefix" else None
        got = gru_scan_backward(x, mask, *w, reverse, hs, d_out, d_fin)
        again = gru_scan_backward(x, mask, *w, reverse, hs, d_out, d_fin)
        want = gru_scan_backward_plain(x, mask, *w, reverse, hs, d_out, d_fin)
        if len(got) != len(names) or any(a.shape != p.shape for a, p in zip(got, want)):
            _fail(f"gru_scan_backward returned {[tuple(a.shape) for a in got]}, want "
                  f"{[tuple(p.shape) for p in want]}")
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            _fail(f"two gru_scan_backward calls on the same inputs differ at B={b} T={t} F={f} H={h} D={d}")
        errs = {}
        for name, a, p in zip(names, got, want):
            err = (a - p).abs().max().item()
            errs[name] = err / max(1.0, p.abs().max().item())
            abs_err = max(abs_err, err)
        plan = gru_scan_bwd_config(b, t, f, h, d)
        _log(f"gru_scan_backward B={b} T={t} F={f} H={h} D={d} outputs={outputs} mask={kind} plan {plan}: "
             f"carries max|diff| {hs_err:.3e}; max|diff| / max(1, max|plain|) "
             + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" (tol {GRU_BWD_RTOL:.0e}); equal bits twice")
        if not max(errs.values()) <= GRU_BWD_RTOL:
            _fail(f"gru_scan_backward disagrees with its plain version: {errs}")
        rel_err = max(rel_err, max(errs.values()))
    torch.cuda.synchronize()
    return abs_err, rel_err


def _gru_bwd_cost(b, t, f, h, d, outputs, with_dfin, valid):
    """(bytes, FP32 FLOP) of ``gru_scan_backward``: x, mask, the carries,
    the output and final-carry gradients and the weights read once; dx and
    the weight and bias gradients written once; per valid stream-step and
    direction the recomputed projections 6H(F + H), the carry gradient
    6H^2 and ~20H of gate algebra, and the products for dx and dW_i (6HF
    each) and dW_h (6H^2). The gate gradients dG and dHn stay in the
    kernel and are no output."""
    n_w = d * (f * 3 * h + 3 * h + h * 3 * h + h)
    n_in = b * t * f + b * t * d * h + (b * t * d * h if outputs else 0) + (b * d * h if with_dfin else 0) + n_w
    n_out = b * t * f + n_w
    flop = valid * d * (6 * h * (f + h) + 6 * h * h + 20 * h + 12 * h * f + 6 * h * h)
    return 4 * (n_in + n_out) + b * t, flop


def _time_backward(torch, g, b, f, h, outputs, kind):
    """The GRU layer's backward at one training shape: the wrapper (the W_h
    transpose, the kernel and its reduction), the plain version, the
    layer's forward + backward through autograd (the training launch, then
    the wrapper) and cuDNN's ``nn.GRU`` forward + backward (yardstick,
    never called by the port), and the wrapper's bound."""
    from deepof_tpu_torch.ops import gru_kernels as gk

    dev = torch.device("cuda")
    d, reverse = 2, (False, True)
    x, mask, w = _gru_train_inputs(torch, g, dev, b, WINDOW, f, h, d, kind, full=True)
    _, fin, hs = gk.gru_scan_carries(x, mask, *w, reverse, outputs)
    d_out = torch.randn(b, WINDOW, d * h, generator=g).to(dev) if outputs else None
    d_fin = torch.randn(b, d * h, generator=g).to(dev) if kind == "prefix" else None
    leaves = [x.clone().requires_grad_()] + [v.clone().requires_grad_() for v in w]

    def port_fwd_bwd():
        out, fn = gk.gru_scan(leaves[0], mask, *leaves[1:], reverse, None, outputs)
        pairs = [(o, go) for o, go in ((out, d_out), (fn, d_fin)) if go is not None]
        torch.autograd.grad([o for o, _ in pairs], leaves, [go for _, go in pairs])

    cudnn = torch.nn.GRU(f, h, batch_first=True, bidirectional=True).to(dev)
    c_leaves = [leaves[0]] + list(cudnn.parameters())

    def cudnn_fwd_bwd():
        out, hn = cudnn(leaves[0])
        pairs = [(out, d_out)] if outputs else []
        if d_fin is not None:
            pairs.append((hn, d_fin.view(b, d, h).transpose(0, 1)))
        torch.autograd.grad([o for o, _ in pairs], c_leaves, [go for _, go in pairs])

    res = {
        "shape": f"x ({b}, {WINDOW}, {f}) float32, H={h}, D={d}, outputs={outputs}, mask={kind}, "
                 f"final-carry gradient={d_fin is not None}",
        "plan": gk.gru_scan_bwd_config(b, WINDOW, f, h, d),
        "ms": _cuda_ms(torch, lambda: gk.gru_scan_backward(x, mask, *w, reverse, hs, d_out, d_fin)),
        "plain_ms": _cuda_ms(torch, lambda: gk.gru_scan_backward_plain(x, mask, *w, reverse, hs, d_out, d_fin),
                             reps=3, warmup=1),
        "fwd_bwd_ms": _cuda_ms(torch, port_fwd_bwd),
        "library_ms": _cuda_ms(torch, cudnn_fwd_bwd),
    }
    n_bytes, flop = _gru_bwd_cost(b, WINDOW, f, h, d, outputs, d_fin is not None, int(mask.sum()))
    by_bytes, by_ops = n_bytes / PEAK_BYTES * 1e3, flop / PEAK_FP32 * 1e3
    res["bound_ms"] = max(by_bytes, by_ops)
    res["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
    return res


def _training_data(root):
    """The training phases' data: the public project on the card (one
    recording held out), its graph dataset, the seconds both took, the
    first TRAIN_BATCH training windows (x, a) and the training windows'
    count."""
    from deepof_tpu_torch.core.storage import get_dt
    from deepof_tpu_torch.data import Project
    from deepof_tpu_torch.graph_dataset import reorder_and_reshape

    t0 = time.perf_counter()
    coords = Project(
        project_path=root, project_name="public", video_path=f"{root}/Videos", table_path=f"{root}/Tables",
        arena="circular-autodetect", video_scale="380 mm", table_format="csv", frame_rate=FPS,
        animal_ids=ANIMALS, device="cuda",
    ).create(force=True, test=True, verbose=False)
    ggd = coords.get_graph_dataset(window_size=WINDOW, test_videos=1)
    (train, test), *_ = ggd
    prep_s = time.perf_counter() - t0
    if len(train) != 1 or len(test) != 1:
        _fail(f"training split: {list(train)} / {list(test)}, not one recording each")
    nodes, edges, _ = get_dt(train, list(train)[0])
    x = reorder_and_reshape(np.asarray(nodes[:TRAIN_BATCH], np.float32))
    a = np.asarray(edges[:TRAIN_BATCH], np.float32)[..., None]
    return {"coords": coords, "ggd": ggd, "prep_s": prep_s, "x": x, "a": a, "n_train": int(nodes.shape[0])}


def _step_grads_vs_cpu(torch, loss_fn, cpu_model, card_model, label):
    """One step's loss and every parameter gradient, card vs CPU, from the
    same weights and inputs: ``loss_fn(model, device)`` -> total. Fails
    beyond STEP_RTOL / STEP_GRAD_RTOL. Returns (loss rel error, gradient
    rel error, smallest max |g_cpu|)."""
    loss = {}
    for dev, m in (("cpu", cpu_model), ("cuda", card_model)):
        m.zero_grad(set_to_none=True)
        total = loss_fn(m, dev)
        total.backward()
        loss[dev] = total.item()
    loss_err = abs(loss["cuda"] - loss["cpu"]) / max(1.0, abs(loss["cpu"]))
    grads = {}  # name -> (max |g_cpu|, max |g_card - g_cpu| / max |g_cpu|)
    for (name, pc), (_, pg) in zip(cpu_model.named_parameters(), card_model.named_parameters()):
        if pc.grad is None or pg.grad is None:
            _fail(f"{label} left {name} without a gradient")
        scale, diff = pc.grad.abs().max().item(), (pg.grad.cpu() - pc.grad).abs().max().item()
        grads[name] = (scale, diff / scale if scale > 0 else (0.0 if diff == 0 else np.inf))
    _log(f"{label}, per parameter max|g_cpu| and max|diff| / max|g_cpu|: "
         + ", ".join(f"{k} {v[0]:.2e} {v[1]:.1e}" for k, v in grads.items()))
    grad_err = max(v[1] for v in grads.values())
    worst = max(grads, key=lambda k: grads[k][1])
    smallest = min(grads, key=lambda k: grads[k][0])
    _log(f"{label}, card vs CPU: loss {loss['cuda']:.6f} vs {loss['cpu']:.6f}, rel {loss_err:.3e} "
         f"(tol {STEP_RTOL:.0e}); gradients max|diff| / max|g_cpu| {grad_err:.3e} at {worst} "
         f"(tol {STEP_GRAD_RTOL:.0e}); smallest max|g_cpu| {grads[smallest][0]:.3e} at {smallest}")
    if not (loss_err <= STEP_RTOL and grad_err <= STEP_GRAD_RTOL):
        _fail(f"{label}: card and CPU disagree (loss {loss_err}, gradients {grad_err} at {worst})")
    return loss_err, grad_err, grads[smallest][0]


def _training_phase(torch, card, data):
    """Phase 7: the training path on the card. The backward kernel against
    its plain version and timed at the training shapes; one train step card
    vs CPU from the same weights and batch; the steps' GRU launches, time
    and peak memory at batch 256; then ``deep_unsupervised_embedding`` on
    the public project (one recording held out) for one epoch capped at
    TRAIN_BATCHES train and VAL_BATCHES val batches, the saved bundle read
    back with ``ModelBundle.load`` and served with ``embedding_per_video``.
    Returns (stage line, backward errors, backward times, launches of the
    training path)."""
    from deepof_tpu_torch.models import build_model
    from deepof_tpu_torch.ops.gru_kernels import gru_scan, gru_scan_backward
    from deepof_tpu_torch.ops.window_kernels import window_streams
    from deepof_tpu_torch.train.harness import ClippedAdam, ModelBundle, make_vqvae_step, vqvae_loss
    from deepof_tpu_torch.train.inference import embedding_per_video

    t_phase = time.perf_counter()
    bwd_err = _check_backward(torch)
    g = torch.Generator().manual_seed(3)
    bwd_t = [_time_backward(torch, g, *shape) for shape in GRU_TRAIN_SHAPES]

    coords, ggd, prep_s, x, a = (data[k] for k in ("coords", "ggd", "prep_s", "x", "a"))
    _, meta, adjacency, tab_dict, scaler = ggd

    # Card vs CPU: one step's loss and every gradient, same weights, same batch.
    cpu_model = build_model("VQVAE", x.shape[1:], a.shape[1:], adjacency, LATENT, N_COMPONENTS,
                            generator=torch.Generator().manual_seed(0), device="cpu")
    card_model = copy.deepcopy(cpu_model).to("cuda")
    loss_err, grad_err, grad_min_scale = _step_grads_vs_cpu(
        torch, lambda m, dev: vqvae_loss(m, torch.as_tensor(x, device=dev), torch.as_tensor(a, device=dev))[0],
        cpu_model, card_model, "one train step")

    # The step on the card: its GRU launches, then TIMED_STEPS timed steps.
    model = build_model("VQVAE", x.shape[1:], a.shape[1:], adjacency, LATENT, N_COMPONENTS,
                        generator=torch.Generator().manual_seed(0), device="cuda")
    step = make_vqvae_step(model, ClippedAdam(model.parameters(), 3e-4))
    xb, ab = torch.as_tensor(x, device="cuda"), torch.as_tensor(a, device="cuda")
    step(xb, ab)
    gru_scan.launches = gru_scan_backward.launches = 0
    step(xb, ab)
    per_step = {"forward": gru_scan.launches, "backward": gru_scan_backward.launches}
    if per_step != {"forward": 8, "backward": 8}:
        _fail(f"one train step launched the GRU kernels {per_step} times, not 8 forward (4 encoder, "
              "4 decoder) and 8 backward")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        logs = step(xb, ab)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if not all(np.isfinite(v.item()) for v in logs.values()):
        _fail(f"non-finite losses after {TIMED_STEPS + 2} steps: {logs}")
    del model, step, card_model

    # One epoch through the entry point, then the saved bundle served.
    window_streams.launches = gru_scan.launches = gru_scan_backward.launches = 0
    t0 = time.perf_counter()
    bundle, _, _, summary = coords.deep_unsupervised_embedding(
        ggd[:3], adjacency_matrix=adjacency, embedding_model="VQVAE", batch_size=TRAIN_BATCH,
        latent_dim=LATENT, epochs=1, n_clusters=N_COMPONENTS, save_checkpoints=True, verbose=False,
        limit_train_batches=TRAIN_BATCHES, limit_val_batches=VAL_BATCHES,
    )
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = {"gru_scan": gru_scan.launches, "gru_scan_bwd": gru_scan_backward.launches}
    if fit_launches != {"gru_scan": 8 * (TRAIN_BATCHES + VAL_BATCHES), "gru_scan_bwd": 8 * TRAIN_BATCHES}:
        _fail(f"one epoch of {TRAIN_BATCHES} + {VAL_BATCHES} batches launched the GRU kernels {fit_launches} times")
    if not ({"total_loss", "val_total_loss"} <= set(summary) and all(np.isfinite(v) for v in summary.values())):
        _fail(f"training losses: {summary}")
    path = os.path.join(coords._project_path, coords._project_name, "Trained_models", "models",
                        f"VQVAE_recurrent_latent{LATENT}_k{N_COMPONENTS}_run0.ckpt")
    t0 = time.perf_counter()
    loaded = ModelBundle.load(path)
    outs = [embedding_per_video(coords, tab_dict, b, meta, global_scaler=scaler, batch_size=BLOCK)
            for b in (bundle, loaded)]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    _check_public_outputs(outs, PUBLIC_FRAMES)
    for key in PUBLIC_KEYS:
        if not np.array_equal(outs[0][1][key], outs[1][1][key]):
            _fail(f"the reloaded bundle's soft counts differ from the trained bundle's on {key}")
    launches = {"window_streams": window_streams.launches, "gru_scan": gru_scan.launches,
                "gru_scan_bwd": gru_scan_backward.launches}
    _log(f"training path: losses {summary}, launches {launches}")
    line = {
        "path": "training", "batch": TRAIN_BATCH, "latent": LATENT, "window": WINDOW,
        "ms_per_step": step_s * 1e3, "steps_per_s": 1.0 / step_s, "windows_per_s": TRAIN_BATCH / step_s,
        "gru_launches_per_step": per_step, "peak_mem_gib": peak_gib, "timed_steps": TIMED_STEPS,
        "prep_s": prep_s, "fit_s": fit_s, "fit_batches": [TRAIN_BATCHES, VAL_BATCHES], "serve_s": serve_s,
        "losses": summary, "step_loss_rel_err": loss_err, "step_grad_rel_err": grad_err,
        "step_grad_min_scale": grad_min_scale,
        "bwd_max_rel_err": bwd_err[1], "phase_s": time.perf_counter() - t_phase, "card": card,
    }
    return line, bwd_err, bwd_t, launches


VADE_LOSS_KEYS = {"total_loss", "reconstruct_loss", "kl_div", "kl_weight", "tf_clust_loss", "prior_loss",
                  "kmeans_loss", "activity_l1", "cat_clust_loss", "distill_loss", "nonempty_loss",
                  "temporal_loss", "scatter_loss", "repel_loss"}


def _vade_phase(torch, card, data, prefix):
    """Phase 8: VaDE, the default model, on the training phase's project.
    One train step card vs CPU in pretrain and in main mode (same weights,
    batch and noise); the step's GRU launches (6 forward: encoder 4,
    decoder 2; 6 backward), TIMED_STEPS timed steps of each mode and the
    peak memory; ``deep_unsupervised_embedding`` with no
    ``embedding_model`` for one pretrain and one main epoch, each capped at
    TRAIN_BATCHES + VAL_BATCHES batches, its phases timed (pretrain,
    extract_latents + GMM init, main); the saved bundle read back with
    ``ModelBundle.load`` and both bundles served by
    ``embedding_per_video``; the trained bundle served card vs CPU on the
    2,000-frame copy ``prefix``. Returns (stage line, launches of the
    training and the serving path)."""
    from deepof_tpu_torch.models import build_model
    from deepof_tpu_torch.ops.gru_kernels import gru_scan, gru_scan_backward
    from deepof_tpu_torch.ops.window_kernels import window_streams
    from deepof_tpu_torch.train import harness
    from deepof_tpu_torch.train.config import CommonFitCfg, TurtleTeacherCfg, VaDECfg
    from deepof_tpu_torch.train.inference import embedding_per_video
    from deepof_tpu_torch.train.losses import vade_params_from_cfg

    t_phase = time.perf_counter()
    coords, ggd, x, a = (data[k] for k in ("coords", "ggd", "x", "a"))
    _, meta, adjacency, tab_dict, scaler = ggd
    common = CommonFitCfg(n_components=N_COMPONENTS)
    loss_params = {mode: vade_params_from_cfg(common, VaDECfg(), TurtleTeacherCfg(), mode == "pretrain")
                   for mode in ("pretrain", "main")}

    # Card vs CPU: one step of each mode, same weights, batch and noise.
    g = torch.Generator().manual_seed(5)
    eps_z = torch.randn(TRAIN_BATCH, LATENT, generator=g)
    eps_kl = torch.randn(32, TRAIN_BATCH, LATENT, generator=g)
    cpu_model = build_model("VaDE", x.shape[1:], a.shape[1:], adjacency, LATENT, N_COMPONENTS,
                            generator=torch.Generator().manual_seed(0), device="cpu")
    card_model = copy.deepcopy(cpu_model).to("cuda")
    step_errs = {}
    for mode, params in loss_params.items():
        def loss_fn(m, dev, params=params):
            return harness.vade_step_loss(
                m, torch.as_tensor(x, device=dev), torch.as_tensor(a, device=dev), None, params, 0.5,
                eps_z.to(dev), eps_kl.to(dev))[0]
        step_errs[mode] = _step_grads_vs_cpu(torch, loss_fn, cpu_model, card_model, f"one VaDE {mode} step")
    del cpu_model, card_model

    # The steps on the card: GRU launches, then TIMED_STEPS timed steps a mode.
    xb, ab = torch.as_tensor(x, device="cuda"), torch.as_tensor(a, device="cuda")
    step_ms, per_step = {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mode, params in loss_params.items():
        model = build_model("VaDE", x.shape[1:], a.shape[1:], adjacency, LATENT, N_COMPONENTS,
                            generator=torch.Generator().manual_seed(0), device="cuda")
        opt = harness._make_optimizer(model.named_parameters(), 3e-4, gmm_lr=1e-3)
        step = harness.make_vade_step(model, opt, params, torch.Generator(device="cuda").manual_seed(0))
        step(xb, ab, kl_weight=0.5)
        gru_scan.launches = gru_scan_backward.launches = 0
        step(xb, ab, kl_weight=0.5)
        per_step[mode] = {"forward": gru_scan.launches, "backward": gru_scan_backward.launches}
        if per_step[mode] != {"forward": 6, "backward": 6}:
            _fail(f"one VaDE {mode} step launched the GRU kernels {per_step[mode]} times, not 6 forward "
                  "(4 encoder, 2 decoder) and 6 backward")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            logs = step(xb, ab, kl_weight=0.5)
        torch.cuda.synchronize()
        step_ms[mode] = (time.perf_counter() - t0) / TIMED_STEPS * 1e3
        if not all(np.isfinite(v.item()) for v in logs.values()):
            _fail(f"non-finite VaDE {mode} losses after {TIMED_STEPS + 2} steps: {logs}")
        del model, opt, step
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # The default call, its phases timed at the fit's calls of
    # extract_latents and fit_gmm_init.
    marks = {}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            marks[f"{name}_start"] = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            marks[f"{name}_end"] = time.perf_counter()
            return out
        return wrapper

    originals = harness.extract_latents, harness.fit_gmm_init
    harness.extract_latents = timed("latents", originals[0])
    harness.fit_gmm_init = timed("gmm", originals[1])
    window_streams.launches = gru_scan.launches = gru_scan_backward.launches = 0
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bundle, score, _, summary = coords.deep_unsupervised_embedding(
            ggd[:3], adjacency_matrix=adjacency, batch_size=TRAIN_BATCH, latent_dim=LATENT,
            n_clusters=N_COMPONENTS, epochs=1, pretrain_epochs=1, save_checkpoints=True, verbose=False,
            limit_train_batches=TRAIN_BATCHES, limit_val_batches=VAL_BATCHES,
        )
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    finally:
        harness.extract_latents, harness.fit_gmm_init = originals
    train_launches = {"window_streams": window_streams.launches, "gru_scan": gru_scan.launches,
                      "gru_scan_bwd": gru_scan_backward.launches}
    phases_s = {"pretrain": marks["latents_start"] - t0, "latents": marks["latents_end"] - marks["latents_start"],
                "gmm_init": marks["gmm_end"] - marks["gmm_start"], "main": t_end - marks["gmm_end"],
                "fit": t_end - t0}
    latent_batches = -(-data["n_train"] // TRAIN_BATCH)
    want = {"window_streams": 0, "gru_scan": 2 * 6 * (TRAIN_BATCHES + VAL_BATCHES) + 4 * latent_batches,
            "gru_scan_bwd": 2 * 6 * TRAIN_BATCHES}
    if train_launches != want:
        _fail(f"the default call launched {train_launches}, not {want} (two phases of {TRAIN_BATCHES} + "
              f"{VAL_BATCHES} batches, {latent_batches} latent batches)")
    if bundle.rebuild_spec["model"] != "VaDE" or score is not None:
        _fail(f"the default call trained a {bundle.rebuild_spec['model']} (score {score})")
    want_keys = {f"{ph}{val}{k}" for ph in ("pretrain/", "") for val in ("", "val_") for k in VADE_LOSS_KEYS}
    if set(summary) != want_keys or not all(np.isfinite(v) for v in summary.values()):
        _fail(f"VaDE history keys or losses: {summary}")
    _log(f"VaDE default call: phases {phases_s}, launches {train_launches}, losses {summary}")

    # Serving: the trained and the reloaded bundle, then card vs CPU.
    path = os.path.join(coords._project_path, coords._project_name, "Trained_models", "models",
                        f"VaDE_recurrent_latent{LATENT}_k{N_COMPONENTS}_run0.ckpt")
    loaded = harness.ModelBundle.load(path)
    window_streams.launches = gru_scan.launches = gru_scan_backward.launches = 0
    t0 = time.perf_counter()
    outs = [embedding_per_video(coords, tab_dict, b, meta, global_scaler=scaler, batch_size=BLOCK)
            for b in (bundle, loaded)]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_launches = {"window_streams": window_streams.launches, "gru_scan": gru_scan.launches,
                      "gru_scan_bwd": gru_scan_backward.launches}
    n_blocks = 2 * len(PUBLIC_KEYS) * -(-(PUBLIC_FRAMES - WINDOW + 1) // BLOCK)
    if serve_launches != {"window_streams": n_blocks, "gru_scan": 4 * n_blocks, "gru_scan_bwd": 0}:
        _fail(f"serving two VaDE bundles launched {serve_launches} for {n_blocks} blocks")
    _check_public_outputs(outs, PUBLIC_FRAMES)
    for key in PUBLIC_KEYS:
        if not np.array_equal(outs[0][1][key], outs[1][1][key]):
            _fail(f"the reloaded VaDE bundle's soft counts differ from the trained bundle's on {key}")
    on_card = _run_public(torch, prefix, [bundle], "cuda")[3][0]
    on_cpu = _run_public(torch, prefix, [bundle], "cpu", precision="float32")[3][0]
    serve_err = 0.0
    for key in PUBLIC_KEYS:
        for name, got, want_ in (("embeddings", on_card[0][key], on_cpu[0][key]),
                                 ("soft counts", on_card[1][key], on_cpu[1][key])):
            err = float(np.abs(got - want_).max()) / max(1.0, float(np.abs(want_).max()))
            _log(f"VaDE served on the {PREFIX}-frame copy, {key}, {name}, card vs CPU plain: "
                 f"max|diff| / max(1, max|cpu|) {err:.3e} (tol {PATH_RTOL:.0e})")
            if not err <= PATH_RTOL:
                _fail(f"card and CPU disagree on the VaDE {name} of {key}: {err}")
            serve_err = max(serve_err, err)
    line = {
        "path": "vade", "batch": TRAIN_BATCH, "latent": LATENT, "n_components": N_COMPONENTS, "window": WINDOW,
        "ms_per_step": step_ms["main"], "steps_per_s": 1e3 / step_ms["main"],
        "windows_per_s": TRAIN_BATCH * 1e3 / step_ms["main"], "pretrain_ms_per_step": step_ms["pretrain"],
        "gru_launches_per_step": per_step["main"], "peak_mem_gib": peak_gib, "timed_steps": TIMED_STEPS,
        "phases_s": phases_s, "fit_batches": [TRAIN_BATCHES, VAL_BATCHES], "latent_batches": latent_batches,
        "serve_s": serve_s, "losses": summary,
        "step_loss_rel_err": {m: e[0] for m, e in step_errs.items()},
        "step_grad_rel_err": {m: e[1] for m, e in step_errs.items()},
        "serve_max_rel_err": serve_err, "phase_s": time.perf_counter() - t_phase, "card": card,
    }
    return line, {"vade_training": train_launches, "vade_serving": serve_launches}


COHORT_KEYS = ("test", "test2", "test3")
COHORT_FRAMES = (45_000, 36_000, 27_000)  # 30, 24 and 18 minutes at 25 fps
COHORT_PREFIX = (2_000, 1_600, 1_200)
# deepof's unsupervised tutorial: one animal, aligned, one recording held out.
TUTORIAL = dict(animal_id="B", center="Center", align="Spine_1", window_size=WINDOW, window_step=1,
                test_videos=1, scale="standard")
# The general route: robust scaling, groupwise sections, the second 600 s bin.
GENERAL = dict(window_size=WINDOW, scale="robust", dist_standardize="groupwise",
               speed_standardize="groupwise", coord_standardize="groupwise", bin_size=600, bin_index=1)
GENERAL_RTOL = 1e-8
PREFIX_BIN_S = 16  # the general route's bin on the prefix copy: frames 400-799


# The cohort's experimental conditions and start markers, written beside its
# tables as csv (io/conditions.py reads them): a frame-integer column and a
# time-string column.
COHORT_CONDITIONS = {"test": ("case", "f"), "test2": ("control", "m"), "test3": ("case", "m")}
COHORT_MARKERS = {"test": (250, "00:00:10"), "test2": (500, "00:00:20.5"), "test3": (125, "00:00:05")}


def _cohort_csvs(root):
    """(conditions path, start-markers path) of the cohort under ``root``."""
    paths = os.path.join(root, "conditions.csv"), os.path.join(root, "start_markers.csv")
    for path, header, rows in ((paths[0], "experiment_id,condition,sex", COHORT_CONDITIONS),
                               (paths[1], "experiment_id,frame_start,light_on", COHORT_MARKERS)):
        with open(path, "w") as f:
            f.write(f",{header}\n" + "".join(f"{i},{k},{a},{b}\n" for i, (k, (a, b)) in enumerate(rows.items())))
    return paths


def _cohort_project(root, device, precision="auto", tables=None):
    """The cohort's csv project under ``root``, created with the test arenas
    ("test3" taking "test"'s) read back from an arena file, its conditions
    and start markers from csv; with ``tables``, ROI 1 is the half-plane
    left of the median x of B's Center in each recording."""
    from deepof_tpu_torch.data import Project

    conditions, markers = _cohort_csvs(root)
    proj = Project(
        project_path=root, project_name="cohort", video_path=f"{root}/Videos", table_path=f"{root}/Tables",
        arena="circular-autodetect", video_scale="380 mm", table_format="csv", frame_rate=FPS,
        animal_ids=ANIMALS, precision=precision, device=device, exp_conditions=conditions, start_markers=markers,
    )
    scales, params, rois, res = proj.get_arena(test=True)
    for table in (scales, params, rois, res):
        table["test3"] = table["test"]
    for key, (values, cols) in (tables or {}).items():
        xm = float(np.median(values[:, cols.index(("chip_smoke", "B", "Center", "x"))]))
        xm *= scales[key][3] / scales[key][2]
        rois[key] = {1: np.array([[-1e4, -1e4], [xm, -1e4], [xm, 1e4], [-1e4, 1e4]])}
    arena = os.path.join(root, f"arena_{device}.pkl")
    proj.save_arena_data(arena, params, rois, scales, res)
    return proj.create(force=True, arena_path=arena, verbose=False)


def _scaling_timed(torch, fn):
    """(fn(), [seconds of each TableDict.preprocess call inside it, synchronised])."""
    from deepof_tpu_torch.core.table_dict import TableDict

    secs = []
    original = TableDict.preprocess

    def timed(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = original(self, *args, **kwargs)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        return out

    TableDict.preprocess = timed
    try:
        return fn(), secs
    finally:
        TableDict.preprocess = original


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        _fail(f"shapes differ: {got.shape} vs {want.shape}")
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def _cohort_checks(torch, prefix, bundle):
    """Card vs CPU on the cohort's prefix copy, the scaling passes from the
    same merged values on both devices (the card's merged getter tables,
    copied to the host): the tutorial's device route (float32 both,
    PATH_RTOL), the general route (float64 both, GENERAL_RTOL), and
    ``bundle`` served from both, the CPU rescaling with the card's fitted
    scaler (PATH_RTOL). Also reports, unchecked, the tutorial's scaled
    frames of a CPU project in float32, getters included: the aligned
    bodypart's x is float32 rounding noise that the column's own tiny
    deviation scales up, so the two devices' getters part there. Returns
    {check: max relative error}."""
    from deepof_tpu_torch.core.storage import get_dt
    from deepof_tpu_torch.train.inference import ModelBundle, embedding_per_video

    on_card = _cohort_project(prefix, "cuda")
    card = on_card.get_graph_dataset(**TUTORIAL)
    merged, meta, scaler = card[3], card[1], card[4]
    on_host = merged.filter_videos(list(merged))
    on_host._device_frames = {k: v.cpu() for k, v in merged._device_frames.items()}

    def scaled(tab, **kw):
        parts, _, sc = tab.preprocess(coordinates=on_card, window_size=WINDOW, return_windows=False, **kw)
        return {k: get_dt(part, k) for part in parts for k in part}, sc

    device_kw = dict(scale="standard", test_videos=1, dist_standardize="per_column",
                     speed_standardize="per_column", coord_standardize="per_column")
    d_cpu, _ = scaled(on_host, **device_kw)
    errs = {"device_route": max(_rel_err(get_dt(merged._scaled_frames, k), d_cpu[k]) for k in COHORT_KEYS)}
    general_kw = {k: v for k, v in GENERAL.items() if k != "window_size"} | {"bin_size": PREFIX_BIN_S}
    (g_card, g_sc), (g_cpu, _) = scaled(merged, **general_kw), scaled(on_host, **general_kw)
    if g_sc["kind"] != "robust" or g_card[COHORT_KEYS[0]].dtype != np.float64:
        _fail("the cohort's robust groupwise scaling did not take the float64 general route")
    errs["general_route"] = max(_rel_err(g_card[k], g_cpu[k]) for k in COHORT_KEYS)
    cpu_bundle = ModelBundle(copy.deepcopy(bundle.model).to("cpu"), bundle.rebuild_spec)
    served = [embedding_per_video(on_card, tab, b, meta, animal_id="B", global_scaler=scaler, batch_size=BLOCK,
                                  device=dev)
              for tab, b, dev in ((merged, bundle, None), (on_host, cpu_bundle, "cpu"))]
    errs["embeddings"] = max(_rel_err(served[0][0][k], served[1][0][k]) for k in COHORT_KEYS)
    errs["soft_counts"] = max(_rel_err(served[0][1][k], served[1][1][k]) for k in COHORT_KEYS)
    hard_diff = sum(int((served[0][1][k].argmax(1) != served[1][1][k].argmax(1)).sum()) for k in COHORT_KEYS)
    for name, err in errs.items():
        tol = GENERAL_RTOL if name == "general_route" else PATH_RTOL
        _log(f"cohort copy ({COHORT_PREFIX} frames), {name}, card vs CPU: max|diff| / max(1, max|cpu|) "
             f"{err:.3e} (tol {tol:.0e})")
        if not err <= tol:
            _fail(f"card and CPU disagree on the cohort copy's {name}: {err}")

    own = _cohort_project(prefix, "cpu", precision="float32").get_graph_dataset(**TUTORIAL)[3]
    worst = (0.0, None)
    for k in COHORT_KEYS:
        got, want = get_dt(merged._scaled_frames, k), get_dt(own._scaled_frames, k)
        col = np.abs(got - want).max(axis=0)
        worst = max(worst, (float(col.max()) / max(1.0, float(np.abs(want).max())),
                            str(merged[k].columns[int(col.argmax())])), key=lambda w: w[0])
    errs["hard_labels_differing"] = hard_diff
    _log(f"cohort copy, hard labels of the served soft counts differing card vs CPU (not checked): {hard_diff} "
         f"of {sum(len(served[1][1][k]) for k in COHORT_KEYS)}")
    errs["device_route_own_getters"] = {"max_rel_err": worst[0], "column": worst[1]}
    _log(f"cohort copy, the tutorial's scaled frames from each device's own float32 getters (not checked): "
         f"{errs['device_route_own_getters']}")
    return errs


def _cohort_phase(torch, card, tmp):
    """Phase 9: deepof's unsupervised tutorial on a cohort of recordings of
    unequal length (COHORT_FRAMES of two deepof_14 animals, csv): create ->
    get_graph_dataset(**TUTORIAL) (animal B's getter tables merged on the
    card, cut to the shortest recording, the float32 device route on the
    taken rows) -> deep_unsupervised_embedding at its default model (one
    pretrain and one main epoch of TRAIN_BATCHES + VAL_BATCHES batches) ->
    embedding_per_video, each stage timed, the kernels' launches counted
    from a reset and the peak memory read; then get_graph_dataset(**GENERAL)
    (the float64 general route) timed on the same project; then the card
    against the CPU on a prefix copy (:func:`_cohort_checks`). Returns (the
    cohort line, the launches of the tutorial's pipeline, {"coords",
    "graph_dataset", "bundle"} for phase 10)."""
    from deepof_tpu_torch.ops.gru_kernels import gru_scan, gru_scan_backward
    from deepof_tpu_torch.ops.window_kernels import window_streams, window_streams_config
    from deepof_tpu_torch.train.inference import embedding_per_video, stream_tables

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    tables = _public_tables(0, seed=1, lengths=dict(zip(COHORT_KEYS, COHORT_FRAMES)))
    full = _write_public_project(os.path.join(tmp, "cohort"), tables, max(COHORT_FRAMES))
    prefix = _write_public_project(os.path.join(tmp, "cohort_prefix"), tables,
                                   dict(zip(COHORT_KEYS, COHORT_PREFIX)))
    write_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    window_streams.launches = gru_scan.launches = gru_scan_backward.launches = 0
    stages = {}
    t0 = time.perf_counter()
    coords = _cohort_project(full, "cuda", tables=tables)
    stages["create"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ggd, scaling = _scaling_timed(torch, lambda: coords.get_graph_dataset(**TUTORIAL))
    stages["graph_dataset"] = time.perf_counter() - t0
    stages["scaling"] = scaling[0]
    (train, test), meta, adjacency, tab_dict, scaler = ggd
    t0 = time.perf_counter()
    bundle, _, _, summary = coords.deep_unsupervised_embedding(
        ggd[:3], adjacency_matrix=adjacency, batch_size=TRAIN_BATCH, latent_dim=LATENT,
        n_clusters=N_COMPONENTS, epochs=1, pretrain_epochs=1, verbose=False,
        limit_train_batches=TRAIN_BATCHES, limit_val_batches=VAL_BATCHES,
    )
    torch.cuda.synchronize()
    stages["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    emb, counts = embedding_per_video(coords, tab_dict, bundle, meta, animal_id="B", global_scaler=scaler,
                                      batch_size=BLOCK)
    stages["embed"] = time.perf_counter() - t0
    launches = {"window_streams": window_streams.launches, "gru_scan": gru_scan.launches,
                "gru_scan_bwd": gru_scan_backward.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    rows = min(COHORT_FRAMES)  # every recording is cut to the shortest
    n_windows = rows - WINDOW + 1
    n_blocks = len(COHORT_KEYS) * -(-n_windows // BLOCK)
    n_train = sum(int(train[k].shapes[0][0]) for k in train)
    want = {"window_streams": n_blocks,
            "gru_scan": 2 * 6 * (TRAIN_BATCHES + VAL_BATCHES) + 4 * -(-n_train // TRAIN_BATCH) + 4 * n_blocks,
            "gru_scan_bwd": 2 * 6 * TRAIN_BATCHES}
    if len(test) != 1 or n_train != 2 * n_windows or launches != want:
        _fail(f"the cohort's tutorial pipeline: split {list(train)} / {list(test)}, {n_train} training "
              f"windows, launches {launches}, not {want}")
    for name, count in launches.items():
        if count <= 0:
            _fail(f"kernel {name} was not launched on the cohort's path")
    if len(meta["node_columns"]) != 3 * 14 or not all(c[0].startswith("B_") for c in meta["edge_columns"]):
        _fail(f"the tutorial's dataset is not animal B's: {meta['node_columns'][:3]}, {meta['edge_columns'][:3]}")
    for key in COHORT_KEYS:
        if emb[key].shape != (n_windows, LATENT) or counts[key].shape != (n_windows, N_COMPONENTS):
            _fail(f"cohort {key}: shapes {emb[key].shape}, {counts[key].shape}")
        if not (np.isfinite(emb[key]).all() and np.abs(counts[key].sum(axis=1) - 1.0).max() <= 1e-4):
            _fail(f"cohort {key}: non-finite embeddings or soft counts not summing to 1")
    if not all(np.isfinite(v) for v in summary.values()):
        _fail(f"cohort training losses: {summary}")
    f = len(tab_dict[COHORT_KEYS[0]].columns)
    use_angles = bundle.rebuild_spec.get("use_angles")
    layout_tables = stream_tables({name: list(range(len(meta[f"{name}_columns"])))
                                   for name in ("node", "edge")} | {
        "angle": list(range(len(meta["angle_columns"]))) if use_angles else None})
    mode = window_streams_config(BLOCK + WINDOW - 1, f, WINDOW, [t.shape for t in layout_tables])["mode"]
    _log(f"cohort tutorial pipeline: stages {stages}, launches {launches}, window_streams store mode {mode}")

    # The general route on the same project.
    t0 = time.perf_counter()
    gen, gen_scaling = _scaling_timed(torch, lambda: coords.get_graph_dataset(**GENERAL))
    general_s = time.perf_counter() - t0
    lo = GENERAL["bin_size"] * int(FPS) * GENERAL["bin_index"]
    gen_rows = min(min(n, lo + GENERAL["bin_size"] * int(FPS)) - lo for n in COHORT_FRAMES)
    for part in gen[0]:
        for key, frame in part._device_frames.items():
            holder = part._deferred_f32[key]
            if tuple(frame.shape) != (gen_rows, len(gen[3][key].columns)):
                _fail(f"general route {key}: frame {tuple(frame.shape)}, not {gen_rows} rows")
            if holder.dev64 is None or not bool(torch.isfinite(frame).all()):
                _fail(f"general route {key}: not a finite float64-route frame")
    if gen[4]["kind"] != "robust" or gen[4]["dist_inner"] is None:
        _fail(f"general route scaler: {gen[4]}")
    _log(f"cohort general route: {general_s:.3f} s, scaling {gen_scaling}")

    errs = _cohort_checks(torch, prefix, bundle)
    line = {
        "path": "cohort", "recordings": len(COHORT_KEYS), "frames": list(COHORT_FRAMES),
        "rows_per_recording": rows, "frame_columns": f, "stages_s": stages,
        "total_s": sum(stages.values()), "scaling_s": {"device_route": scaling[0], "general_route": gen_scaling[0]},
        "general_graph_dataset_s": general_s, "general_rows_per_recording": gen_rows,
        "launches": launches, "window_streams_mode": mode, "peak_mem_gib": peak_gib,
        "fit_batches": [TRAIN_BATCHES, VAL_BATCHES], "losses": summary, "card_vs_cpu": errs,
        "write_csv_s": write_s, "phase_s": time.perf_counter() - t_phase, "card": card,
    }
    return line, launches, {"coords": coords, "graph_dataset": ggd, "bundle": bundle, "prefix": prefix}


POSTHOC_RTOL = 1e-10  # card vs CPU from the same inputs; counts, labels and masks exactly
REFERENCE_TOL = 1e-5  # the card's VaDE outputs against the JAX package's (the north star's bar)
REFERENCE_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "vade_reference.npz")
# The synthetic cohort timed at a lab's size: recordings, frames each, clusters, embedding width.
POSTHOC_COHORT = (24, 45_000, N_COMPONENTS, LATENT)
POSTHOC_PASSES = 3
# Calls compared exactly card vs CPU: counts, frame indices and masks.
POSTHOC_EXACT = ("time_bins", "rois", "time_on_cluster_counts", "transition_counts")


def _unflatten(ref, collection):
    """The nested dict of a reference file's ``collection/<path>`` arrays,
    float32."""
    tree = {}
    for name, value in ref.items():
        if name.startswith(f"{collection}/"):
            *parents, leaf = name.split("/")[1:]
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = np.asarray(value, np.float32)
    return tree


def reference_bundle(path, device):
    """(ModelBundle of the VaDE in the reference file, its arrays): the flax
    parameters ``params/<path>`` carried by ``from_flax_params``."""
    from deepof_tpu_torch.models import build_model
    from deepof_tpu_torch.train.inference import ModelBundle
    from deepof_tpu_torch.weights import from_flax_params

    ref = dict(np.load(path))
    params = _unflatten(ref, "params")
    window, n, e = int(ref["window"]), len(ref["node"]) // 3, len(ref["edge"])
    model = build_model("VaDE", (window, n, 3), (window, e, 1), ref["adjacency"], int(ref["latent"]),
                        int(ref["n_components"]), device=device)
    model.load_state_dict(from_flax_params(params, kind="VaDE"))
    spec = {"model": "VaDE", "input_shape": [window, n, 3], "edge_feature_shape": [window, e, 1],
            "n_components": int(ref["n_components"]), "use_angles": False}
    return ModelBundle(model.eval(), spec), ref


ENCODER_KINDS = {"TCN": "TCNEncoder", "transformer": "TransformerEncoder"}
HEAD_KINDS = {"vq_layer": "VectorQuantizer", "latent_space": "GaussianMixtureLatent"}


def encoder_reference_bundle(path, device):
    """(ModelBundle, file arrays, frame, layout) of an encoder reference file
    (tests/data/tcn_reference.npz, transformer_reference.npz): the model the
    file names, its encoder and latent head carried by ``from_flax_params``
    with the batch stats, its decoder (which serving does not read) drawn
    from seed 0; the frame and the layout are the VaDE reference file's."""
    import torch

    from deepof_tpu_torch.models import build_model
    from deepof_tpu_torch.train.inference import ModelBundle
    from deepof_tpu_torch.weights import from_flax_params

    ref = dict(np.load(path))
    base = dict(np.load(REFERENCE_NPZ))
    params, stats = _unflatten(ref, "params"), _unflatten(ref, "batch_stats")
    model_name, encoder, head = str(ref["model"]), str(ref["encoder_type"]), str(ref["head"])
    window, n, e = int(ref["window"]), len(base["node"]) // 3, len(base["edge"])
    model = build_model(model_name, (window, n, 3), (window, e, 1), base["adjacency"], int(ref["latent"]),
                        int(ref["n_components"]), encoder_type=encoder, device=device,
                        generator=torch.Generator().manual_seed(0))
    model.encoder.load_state_dict(from_flax_params(params["encoder"], ENCODER_KINDS[encoder], stats["encoder"]))
    getattr(model, head).load_state_dict(from_flax_params(params[head], HEAD_KINDS[head]))
    spec = {"model": model_name, "input_shape": [window, n, 3], "edge_feature_shape": [window, e, 1],
            "n_components": int(ref["n_components"]), "encoder_type": encoder, "use_angles": False}
    layout = {"node": base["node"].tolist(), "edge": base["edge"].tolist(), "angle": None}
    return ModelBundle(model.eval(), spec), ref, base["frame"], layout


def _same(name, got, want):
    """Max relative error of a post-hoc result card vs CPU (0 when equal);
    fails on differing labels, shapes, or inexact counts where exactness
    is asked (POSTHOC_EXACT)."""
    from deepof_tpu_torch.posthoc import Labelled

    if isinstance(want, Labelled):
        if list(got.index) != list(want.index) or list(got.columns) != list(want.columns):
            _fail(f"post-hoc {name}: labels differ card vs CPU ({got.index}, {got.columns})")
        return _same(name, got.values, want.values)
    if isinstance(want, dict):
        if list(got) != list(want):
            _fail(f"post-hoc {name}: keys differ card vs CPU ({list(got)} vs {list(want)})")
        return max([_same(f"{name}[{k}]", got[k], want[k]) for k in want] + [0.0])
    if isinstance(want, (tuple, list)):
        return max([_same(name, g, w) for g, w in zip(got, want)] + [0.0])
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        _fail(f"post-hoc {name}: shapes {got.shape} vs {want.shape}")
    if want.dtype.kind in "fc":
        if not np.array_equal(np.isnan(got), np.isnan(want)):
            _fail(f"post-hoc {name}: NaNs differ card vs CPU")
        exact = any(name.startswith(e) for e in POSTHOC_EXACT)
        err = _rel_err(np.nan_to_num(got), np.nan_to_num(want)) if got.size else 0.0
        if exact and err != 0.0:
            _fail(f"post-hoc {name}: counts differ card vs CPU ({err})")
        return err
    if not np.array_equal(got, want):
        _fail(f"post-hoc {name}: differs card vs CPU")
    return 0.0


def _posthoc_battery(coords, emb, counts, tags, conds):
    """{name: fn(device)} of the post-hoc battery on the cohort's outputs,
    each a call a user makes after embedding (steady states from the
    CPU's per-condition transitions, ROIs from the CPU's masks, so that
    both devices get the same inputs)."""
    from deepof_tpu_torch import posthoc as ph
    from deepof_tpu_torch.core.table_dict import apply_rois_to_bin_info, preprocess_time_bins

    def bins(dev):
        return preprocess_time_bins(coords, bin_size=600, bin_index=0, start_marker="frame_start",
                                    tab_dict_for_binning=counts)

    host_bins = bins("cpu")
    host_rois = apply_rois_to_bin_info(coords, 1, host_bins, device="cpu")
    host_trans = ph.compute_transition_matrix_per_condition(counts, conds, silence_diagonal=True, device="cpu")
    n = min(len(v) for v in counts.values())
    grow = dict(start_bin=n // 4, end_bin=n, step_bin=n // 4, scan_mode="growing_window")
    return {
        "time_bins": bins,
        "rois": lambda dev: apply_rois_to_bin_info(coords, 1, host_bins, device=dev),
        "time_on_cluster": lambda dev: ph.get_time_on_cluster(counts, normalize=True, device=dev),
        "time_on_cluster_counts": lambda dev: ph.get_time_on_cluster(counts, normalize=False, bin_info=host_bins,
                                                                     device=dev),
        "time_on_cluster_reduced": lambda dev: ph.get_time_on_cluster(counts, reduce_dim=True, device=dev),
        "time_on_cluster_roi": lambda dev: ph.get_time_on_cluster(counts, bin_info=host_rois, roi_number=1,
                                                                  animals_in_roi=["B"], device=dev),
        "aggregated_mean": lambda dev: ph.get_aggregated_embedding(emb, agg="mean", device=dev),
        "aggregated_median": lambda dev: ph.get_aggregated_embedding(emb, agg="median", bin_info=host_bins,
                                                                     device=dev),
        "aggregated_mean_reduced": lambda dev: ph.get_aggregated_embedding(emb, agg="mean", reduce_dim=True,
                                                                           device=dev),
        "enrichment_soft_counts": lambda dev: ph.enrichment_across_conditions(
            soft_counts=counts, exp_conditions=conds, normalize=True, device=dev),
        "enrichment_tags": lambda dev: ph.enrichment_across_conditions(
            supervised_annotations=tags, exp_conditions=conds, normalize=True, bin_info=host_bins, device=dev),
        "transitions_aggregated": lambda dev: ph.compute_transition_matrix_per_condition(
            counts, conds, silence_diagonal=True, device=dev),
        "transitions_per_video": lambda dev: ph.compute_transition_matrix_per_condition(
            counts, conds, aggregate=False, bin_info=host_bins, device=dev),
        "transition_counts": lambda dev: ph.compute_transition_matrix_per_condition(
            counts, conds, aggregate=False, normalize=False, device=dev),
        "steady_state": lambda dev: ph.compute_steady_state(host_trans, device=dev),
        "steady_state_entropy": lambda dev: ph.compute_steady_state(host_trans, return_entropy=True, device=dev),
        "cluster_transition_matrix": lambda dev: {
            k: ph.cluster_transition_matrix(v.argmax(axis=1), N_COMPONENTS, device=dev) for k, v in counts.items()},
        "distance_auc_time_on_cluster": lambda dev: ph.condition_distance_binning(
            emb, counts, conds, agg="time_on_cluster", metric="auc", device=dev, **grow),
        "distance_auc_mean": lambda dev: ph.condition_distance_binning(
            emb, counts, conds, agg="mean", metric="auc", device=dev, **grow),
        "distance_wasserstein": lambda dev: ph.condition_distance_binning(
            emb, counts, conds, agg="mean", metric="wasserstein", device=dev, **grow),
    }


def synthetic_cohort(n_rec, frames, k, d, seed=0):
    """(soft counts, embeddings, conditions) of a seeded cohort: each
    recording a run-length cluster sequence (mean run 25 frames) whose
    softmaxed noisy one-hot rows are the float64 soft counts, embeddings
    the cluster's centre plus noise; half the recordings "case"."""
    from deepof_tpu_torch.core.table_dict import TableDict
    from deepof_tpu_torch.io.conditions import ConditionTable

    rng = np.random.default_rng(seed)
    centres = rng.normal(scale=2.0, size=(k, d))
    counts, emb, conds = {}, {}, {}
    for i in range(n_rec):
        key = f"rec{i:02d}"
        runs = rng.geometric(1 / 25, size=frames // 5)
        labels = np.repeat(rng.integers(0, k, size=len(runs)), runs)[:frames]
        logits = rng.normal(size=(frames, k)) + 3.0 * np.eye(k)[labels] + 0.3 * (i % 2) * np.arange(k) / k
        soft = np.exp(logits - logits.max(axis=1, keepdims=True))
        counts[key] = soft / soft.sum(axis=1, keepdims=True)
        emb[key] = centres[labels] + rng.normal(size=(frames, d)) + 0.2 * (i % 2)
        conds[key] = ConditionTable(condition=["case" if i % 2 == 0 else "control"])
    return (TableDict(counts, typ="unsupervised_counts", exp_conditions=conds),
            TableDict(emb, typ="unsupervised_embedding", exp_conditions=conds), conds)


def lab_cohort_pass(counts, emb, conds, device):
    """(seconds of each stage, results) of the post-hoc pass of bench.py:868
    ``_bench_posthoc``: time on cluster, mean embeddings, enrichment across
    conditions, per-condition transitions + steady states (each stage ends
    in its host copy)."""
    from deepof_tpu_torch import posthoc as ph

    stages, out = {}, {}
    for name, fn in (
        ("time_on_cluster", lambda: ph.get_time_on_cluster(counts, normalize=True, device=device)),
        ("aggregated_embedding", lambda: ph.get_aggregated_embedding(emb, agg="mean", device=device)),
        ("enrichment", lambda: ph.enrichment_across_conditions(
            soft_counts=counts, exp_conditions=conds, normalize=True, device=device)),
        ("transitions_steady_state", lambda: ph.compute_steady_state(
            ph.compute_transition_matrix_per_condition(counts, conds, device=device), device=device)),
    ):
        t = time.perf_counter()
        out[name] = fn()
        stages[name] = time.perf_counter() - t
    return stages, out


def _posthoc_lab_cohort(torch):
    """:func:`lab_cohort_pass` on the synthetic lab cohort: POSTHOC_PASSES
    passes on the card (median pass, the fastest pass's stages), one on the
    CPU, the card's results held against the CPU's."""
    n_rec, frames, k, d = POSTHOC_COHORT
    t0 = time.perf_counter()
    counts, emb, conds = synthetic_cohort(n_rec, frames, k, d)
    make_s = time.perf_counter() - t0
    passes = [lab_cohort_pass(counts, emb, conds, "cuda") for _ in range(POSTHOC_PASSES)]
    totals = [sum(st.values()) for st, _ in passes]
    cpu_stages, cpu_out = lab_cohort_pass(counts, emb, conds, "cpu")
    errs = {name: _same(f"lab cohort {name}", passes[-1][1][name], want) for name, want in cpu_out.items()}
    worst = max(errs.values())
    _log(f"lab cohort ({n_rec} x {frames} frames, K {k}, D {d}), card vs CPU: max rel err {worst:.3e} "
         f"(tol {POSTHOC_RTOL:.0e})")
    if not worst <= POSTHOC_RTOL:
        _fail(f"card and CPU disagree on the lab cohort's post-hoc statistics: {errs}")
    median = float(np.median(totals))
    return {
        "recordings": n_rec, "frames": n_rec * frames, "clusters": k, "embedding_dim": d,
        "soft_counts_mb": n_rec * frames * k * 8 / 1e6, "passes_s": totals, "median_pass_s": median,
        "frames_per_s": n_rec * frames / median, "stages_s": passes[int(np.argmin(totals))][0],
        "cpu_pass_s": sum(cpu_stages.values()), "cpu_stages_s": cpu_stages, "card_vs_cpu_max_rel_err": worst,
        "synthesize_s": make_s,
    }


def _posthoc_phase(torch, card, cohort):
    """Phase 10: the group comparison on the cohort's VaDE outputs. Serves
    the cohort's trained bundle once more with the kernels' counts reset
    (the path's launches), annotates the cohort with the supervised
    battery, then runs the post-hoc battery (:func:`_posthoc_battery`)
    twice on the card, timing the second call, and once on the CPU from the
    same host inputs, held at POSTHOC_RTOL (counts exactly); then the
    synthetic lab cohort (:func:`_posthoc_lab_cohort`), and the card's VaDE
    on the reference file of the JAX package's outputs at REFERENCE_TOL.
    Returns (the posthoc line, the launches of the serving call, the
    cohort's supervised tags for phase 15)."""
    from deepof_tpu_torch.ops.gru_kernels import gru_scan, gru_scan_backward
    from deepof_tpu_torch.ops.window_kernels import window_streams
    from deepof_tpu_torch.train.inference import embedding_per_video, scanned_windowed_forward

    t_phase = time.perf_counter()
    coords, (_, meta, _, tab_dict, scaler), bundle = (cohort["coords"], cohort["graph_dataset"],
                                                      cohort["bundle"])
    conds = coords.get_exp_conditions
    if sorted(conds) != sorted(COHORT_KEYS) or coords.get_condition_values("condition") != ["case", "control"]:
        _fail(f"the cohort's conditions from csv: {conds}")
    markers = coords.get_start_marker_values("frame_start")
    if markers != {k: v[0] for k, v in COHORT_MARKERS.items()}:
        _fail(f"the cohort's start markers from csv: {markers}")

    torch.cuda.synchronize()
    window_streams.launches = gru_scan.launches = gru_scan_backward.launches = 0
    t0 = time.perf_counter()
    emb, counts = embedding_per_video(coords, tab_dict, bundle, meta, animal_id="B", global_scaler=scaler,
                                      batch_size=BLOCK)
    embed_s = time.perf_counter() - t0
    launches = {"window_streams": window_streams.launches, "gru_scan": gru_scan.launches,
                "gru_scan_bwd": gru_scan_backward.launches}
    n_blocks = len(COHORT_KEYS) * -(-(min(COHORT_FRAMES) - WINDOW + 1) // BLOCK)
    want = {"window_streams": n_blocks, "gru_scan": 4 * n_blocks, "gru_scan_bwd": 0}
    if launches != want:
        _fail(f"serving the cohort for post-hoc launched {launches}, not {want}")
    t0 = time.perf_counter()
    tags = coords.supervised_annotation(verbose=False, rng=np.random.RandomState(0))
    tags_s = time.perf_counter() - t0

    battery = _posthoc_battery(coords, emb, counts, tags, conds)
    calls, errs = {}, {}
    for name, fn in battery.items():
        fn("cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn("cuda")
        torch.cuda.synchronize()
        calls[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        want_ = fn("cpu")
        calls[f"{name}_cpu"] = time.perf_counter() - t0
        errs[name] = _same(name, got, want_)
        if not errs[name] <= POSTHOC_RTOL:
            _fail(f"card and CPU disagree on post-hoc {name}: {errs[name]}")
        _log(f"post-hoc {name}: card {calls[name]:.4f} s, CPU {calls[name + '_cpu']:.4f} s, "
             f"max rel err {errs[name]:.3e}")
    toc = battery["time_on_cluster"]("cuda")
    if toc.values.shape[0] != len(COHORT_KEYS) or not np.allclose(toc.values.sum(axis=1), 1.0):
        _fail(f"time on cluster: {toc}")
    n = min(len(v) for v in counts.values())
    for name in ("distance_auc_time_on_cluster", "distance_auc_mean", "distance_wasserstein"):
        values = battery[name]("cuda")
        if not (len(values) == len(range(n // 4, n, n // 4)) and np.isfinite(values).all()):
            _fail(f"post-hoc {name}: {values}")

    lab = _posthoc_lab_cohort(torch)

    # The card's VaDE against the JAX package's outputs (reference file).
    ref_bundle, ref = reference_bundle(REFERENCE_NPZ, "cuda")
    layout = {"node": ref["node"].tolist(), "edge": ref["edge"].tolist(), "angle": None}
    columns = list(tab_dict[COHORT_KEYS[0]].columns)
    if [columns.index(c) for c in meta["node_columns"]] != layout["node"]:
        _fail("the reference file's layout is not the cohort tutorial's")
    ref_emb, ref_sc = scanned_windowed_forward(ref_bundle, ref["frame"], layout, int(ref["window"]), "VaDE",
                                               block=BLOCK)
    reference = {"embeddings_max_abs_err": float(np.abs(ref_emb - ref["embeddings"]).max()),
                 "soft_counts_max_abs_err": float(np.abs(ref_sc - ref["soft_counts"]).max()),
                 "hard_labels_differing": int((ref_sc.argmax(1) != ref["hard_labels"]).sum()),
                 "windows": int(len(ref_sc)), "tol": REFERENCE_TOL}
    _log(f"card VaDE vs the JAX package's reference: {reference}")
    if not max(reference["embeddings_max_abs_err"], reference["soft_counts_max_abs_err"]) <= REFERENCE_TOL:
        _fail(f"the card's VaDE outputs miss the JAX package's by more than {REFERENCE_TOL}: {reference}")

    line = {
        "path": "posthoc", "recordings": len(COHORT_KEYS), "windows": [len(v) for v in counts.values()],
        "embed_s": embed_s, "supervised_s": tags_s, "launches": launches, "calls_s": calls,
        "card_vs_cpu": errs, "card_vs_cpu_max_rel_err": max(errs.values()), "lab_cohort": lab,
        "jax_reference": reference, "phase_s": time.perf_counter() - t_phase, "card": card,
    }
    return line, launches, tags


# Phase 11: soft-count extraction on the cohort's VaDE embeddings.
# Columns of each method's counts at the defaults (K 10, M_gates 3; "combined"
# appends the chaotic half of the two-bin chaos gate's 20).
SOFTCOUNT_METHODS = {"gmm": 30, "msm": 30, "hmm": 10, "combined": 40}
# hmm_scan against hmm_scan_plain on the card, (K, N, T), each value within
# HMM_TOL of max(1, |value|): the same float32 recursions, the kernel's
# max and sum as trees, its expf / logf against PyTorch's.
HMM_CHECK = [(k, n, t) for k in (2, 10, 25, 32) for n in (1, 3, 24) for t in (1, 2, 1_000)]
# Lengths of ~100 chunks a sequence, held at HMM_TOL against hmm_scan_plain
# in float64: there the float32 sequential chain drifts past HMM_TOL from
# float64 itself (~3e-5 of |value| at K 2, where the scan stays within
# ~2e-6; tests/test_torch_hmm_chunks.py states the scan on the CPU); its
# difference from the float32 plain version is reported.
HMM_CHUNKED = [(k, n, 5_000) for k in (2, 10, 32) for n in (1, 24)]
HMM_TOL = 1e-5
# The cohort's shape, where |log alpha| reaches ~1e5 and one float32 ulp is
# ~0.008: the long-sequence rule, 1e-4 of max(1, |value|); gamma's
# difference and the share of frames whose argmax differs are reported.
HMM_LONG = (3, 26_976, 10)
HMM_LONG_TOL = 1e-4
HMM_TIMED = (HMM_LONG, (24, 45_000, 10))  # the cohort and the lab cohort
GATE_DIFF_MAX = 1e-3  # share of windows whose gate bin may differ card vs CPU
# Card vs CPU soft counts (float32 both) where the gate bins agree, of
# max(1, max |value|). The MSM decoders' labels come out equal, so their
# memberships agree to rounding (1e-4). The GMM's and the HMM's posteriors
# are exponentials of float32 log-likelihoods of magnitude ~1e3 (a full
# covariance's Mahalanobis terms) and ~1e5 (a sequence's forward
# variables), whose last-bit differences move a posterior near a boundary
# by ~1e-3, and the HMM's 50 EM iterations carry them on (seen 3.43e-4 to
# 1.81e-3 for the GMM and 1.79e-3 to 4.91e-3 for the HMM over three runs,
# no hard label differing; NVIDIA H100 80GB HBM3, 700.00 W): 1e-2 and
# 2e-2, with hard labels differing on at most GATE_DIFF_MAX of the windows.
SOFTCOUNT_RTOL = {"gmm": 1e-2, "msm": 1e-4, "hmm": 2e-2, "combined": 1e-4}
# The k-means decoders, fitted twice on the card from the same embeddings:
# equal bit for bit (cluster sums in row order, ``gmm.cluster_sums``).
REPEATED_METHODS = ("gmm", "msm")
CONTRASTIVE_MAX_STATES = 25


def _hmm_inputs(torch, g, n, t, k):
    """Seeded (log_b, log_pi, log_a) on the card: emissions of -5 +- 3 nats,
    a diagonal-heavy transition matrix."""
    log_b = torch.randn(n, t, k, generator=g) * 3 - 5
    a = torch.rand(k, k, generator=g) + torch.eye(k) * k
    pi = torch.rand(k, generator=g)
    return [v.to("cuda").contiguous() for v in (log_b, torch.log(pi / pi.sum()), torch.log(a / a.sum(1, keepdim=True)))]


def _hmm_errs(torch, got, want):
    """(max abs, max abs / max(1, |plain|)) over both recursions."""
    abs_err = max(float((a - b).abs().max()) for a, b in zip(got, want)) if want[0].numel() else 0.0
    rel_err = max(float(((a - b).abs() / b.abs().clamp(min=1.0)).max()) for a, b in zip(got, want)) \
        if want[0].numel() else 0.0
    return abs_err, rel_err


def _check_time_hmm(torch):
    """hmm_scan against hmm_scan_plain on the card at HMM_CHECK and at the
    cohort's length, then timed at HMM_TIMED against its bound (its plain
    version timed once, at the cohort's shape), each with its chunk plan.
    Returns (max abs err, max rel err, the long-sequence report, the timing
    of each shape)."""
    from deepof_tpu_torch.ops.hmm_kernels import hmm_scan, hmm_scan_config, hmm_scan_plain

    g = torch.Generator().manual_seed(0)
    worst = (0.0, 0.0)
    for k, n, t in HMM_CHECK:
        args = _hmm_inputs(torch, g, n, t, k)
        got = hmm_scan(*args)
        torch.cuda.synchronize()
        errs = _hmm_errs(torch, got, hmm_scan_plain(*args))
        worst = (max(worst[0], errs[0]), max(worst[1], errs[1]))
    for k, n, t in HMM_CHUNKED:
        args = _hmm_inputs(torch, g, n, t, k)
        got = hmm_scan(*args)
        torch.cuda.synchronize()
        errs = _hmm_errs(torch, [v.double() for v in got], hmm_scan_plain(*[v.double() for v in args]))
        errs32 = _hmm_errs(torch, got, hmm_scan_plain(*args))
        worst = (max(worst[0], errs[0]), max(worst[1], errs[1]))
        _log(f"hmm_scan vs plain (float64) at (K, N, T) = {(k, n, t)}, plan {hmm_scan_config(n, t, k)}: max|diff| "
             f"{errs[0]:.3e}, max|diff| / max(1, |plain|) {errs[1]:.3e}; vs plain (float32) {errs32[1]:.3e}")
    _log(f"hmm_scan vs plain at {len(HMM_CHECK) + len(HMM_CHUNKED)} shapes (K 2-32, N 1-24, T 1-5000): max|diff| "
         f"{worst[0]:.3e}, max|diff| / max(1, |plain|) {worst[1]:.3e} (tol {HMM_TOL:.0e})")
    if not worst[1] <= HMM_TOL:
        _fail(f"hmm_scan disagrees with its plain version: {worst}")

    n, t, k = HMM_LONG
    args = _hmm_inputs(torch, g, n, t, k)
    got = hmm_scan(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = hmm_scan_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    abs_err, rel_err = _hmm_errs(torch, got, want)

    def gamma(alpha, beta):
        ll = torch.logsumexp(alpha[:, -1], dim=-1)
        return torch.softmax(alpha + beta - ll[:, None, None], dim=-1)

    g_card, g_plain = gamma(*got), gamma(*want)
    long = {"shape": list(HMM_LONG), "plan": hmm_scan_config(n, t, k), "max_rel_err": rel_err, "max_abs_err": abs_err,
            "gamma_max_abs_diff": float((g_card - g_plain).abs().max()),
            "argmax_differing_share": float((g_card.argmax(-1) != g_plain.argmax(-1)).double().mean())}
    _log(f"hmm_scan vs plain at {HMM_LONG}: {long} (tol {HMM_LONG_TOL:.0e} on the recursions)")
    if not rel_err <= HMM_LONG_TOL:
        _fail(f"hmm_scan disagrees with its plain version at the cohort's length: {long}")

    timed = []
    for n, t, k in HMM_TIMED:
        args = _hmm_inputs(torch, g, n, t, k)
        ms = _cuda_ms(torch, lambda: hmm_scan(*args), reps=5, warmup=1)
        plan = hmm_scan_config(n, t, k)
        n_bytes = 4 * (3 * n * t * k + k + k * k)  # log_b, log_pi, log_a read; two outputs written
        # The function's own work, per state-step and recursion: K adds,
        # max, sub, exp, sum; log, add. The bound counts only that.
        flop = 2 * n * t * k * (5 * k + 2)
        # What the chunked scan adds: K rows of the forward recursion over
        # every chunk's frames (their max normalisation, ~2K more a
        # state-step) and the carry's C K-wide steps in each direction.
        extra = (n * (t - 1) * k * k * (7 * k + 2) + 2 * n * plan["chunks"] * k * (5 * k + 3)
                 if plan["chunks"] > 1 else 0)
        by_bytes, by_ops = n_bytes / PEAK_BYTES * 1e3, flop / PEAK_FP32 * 1e3
        timed.append({"shape": f"log_b ({n}, {t}, {k}) float32", "plan": plan, "ms": ms, "ns_per_step": ms * 1e6 / t,
                      "bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                      "algorithm_extra_flop": extra,
                      "algorithm_bound_ms": max(by_bytes, (flop + extra) / PEAK_FP32 * 1e3)})
    timed[0]["plain_ms"] = plain_ms
    _log(f"hmm_scan timed: {timed}")
    return worst[0], max(worst[1], rel_err), long, timed


def _kernel_counts(reset=False):
    """{kernel: launches since the last reset}, or set every count to 0."""
    from deepof_tpu_torch.ops.gru_kernels import gru_scan, gru_scan_backward
    from deepof_tpu_torch.ops.hmm_kernels import hmm_scan
    from deepof_tpu_torch.ops.kalman_kernels import kalman_rts
    from deepof_tpu_torch.ops.window_kernels import window_streams

    fns = {"window_streams": window_streams, "gru_scan": gru_scan, "gru_scan_bwd": gru_scan_backward,
           "hmm_scan": hmm_scan, "kalman_rts": kalman_rts}
    if reset:
        for fn in fns.values():
            fn.launches = 0
    return {name: fn.launches for name, fn in fns.items()}


def _gate_bins(masks, m_eff):
    """{(gate, key): (T,) bin index of each window (-1 in none)}."""
    out = {}
    for gate, bins in masks.items():
        for key in bins[0]:
            idx = np.full(len(bins[0][key]), -1)
            for b in range(m_eff):
                idx[np.asarray(bins[b][key], bool)] = b
            out[(gate, key)] = idx
    return out


def _softcounts_card_vs_cpu(torch, prefix, bundle):
    """The four methods card vs CPU (float32 both) on the cohort's prefix
    copy, from the same host embeddings (the card's served ones): the
    windows whose distance-gate bin differs (at most GATE_DIFF_MAX), the
    soft counts where the bins agree (every window for "hmm"; SOFTCOUNT_RTOL
    of max(1, max |value|)), and the hard labels that differ (at most
    GATE_DIFF_MAX of the windows)."""
    from deepof_tpu_torch import gating
    from deepof_tpu_torch.train.inference import _extract_soft_counts, embedding_per_video

    on_card = _cohort_project(prefix, "cuda")
    on_cpu = _cohort_project(prefix, "cpu", precision="float32")
    ggd = on_card.get_graph_dataset(**TUTORIAL)
    emb, _ = embedding_per_video(on_card, ggd[3], bundle, ggd[1], animal_id="B", global_scaler=ggd[4],
                                 batch_size=BLOCK)
    emb = {k: np.asarray(v) for k, v in emb.items()}
    bins = [_gate_bins(gating._preprocess_gates(c, emb, None, WINDOW, None, 3, "Center", None, dev)[2], 3)
            for c, dev in ((on_card, torch.device("cuda")), (on_cpu, torch.device("cpu")))]
    n_windows = sum(len(v) for v in bins[1].values())
    differ = sum(int((bins[0][gk] != bins[1][gk]).sum()) for gk in bins[1])
    agree = {key: bins[0][(gate, key)] == bins[1][(gate, key)] for gate, key in bins[1]}  # one gate: B-W
    out = {"windows": n_windows, "gate_bins_differing": differ}
    _log(f"softcounts copy: distance-gate bins differing card vs CPU: {differ} of {n_windows} windows "
         f"(at most {GATE_DIFF_MAX:.1%})")
    if differ > GATE_DIFF_MAX * n_windows:
        _fail(f"the card's gate bins differ from the CPU's on {differ} of {n_windows} windows")
    for method in SOFTCOUNT_METHODS:
        def extract(c, dev):
            return _extract_soft_counts(c, emb, method, N_COMPONENTS, N_COMPONENTS, WINDOW, None, None, "Center", 3,
                                        0.75, 0.5, 200, 3, dev)

        counts = [extract(c, dev) for c, dev in ((on_card, torch.device("cuda")), (on_cpu, torch.device("cpu")))]
        rows = {k: slice(None) if method == "hmm" else agree[k] for k in emb}
        err = max(_rel_err(counts[0][k][rows[k]], counts[1][k][rows[k]]) for k in emb)
        hard = sum(int((counts[0][k].argmax(1) != counts[1][k].argmax(1)).sum()) for k in emb)
        out[method] = {"max_rel_err": err, "hard_labels_differing": hard}
        tol = SOFTCOUNT_RTOL[method]
        _log(f"softcounts copy, {method}, card vs CPU where the bins agree: {err:.3e} (tol {tol:.0e}), "
             f"hard labels differing {hard} of {n_windows} (at most {GATE_DIFF_MAX:.1%})")
        if not (err <= tol and hard <= GATE_DIFF_MAX * n_windows):
            _fail(f"card and CPU disagree on the {method} soft counts of the cohort copy: {out[method]}")
        if method in REPEATED_METHODS:
            again = extract(on_card, torch.device("cuda"))
            if not all(np.array_equal(again[k], counts[0][k]) for k in emb):
                _fail(f"the card's {method} soft counts of the cohort copy differ from one fit to the next")
            _log(f"softcounts copy, {method}: a second fit on the card gave the same soft counts bit for bit")
    return out


def _softcounts_lab_cohort(torch):
    """The two ungated decoders at a lab's size (phase 10's seeded cohort,
    24 x 45,000 frames, D 8): a 10-state HMM and a 10-macrostate MSM, each
    fit and decode timed, with the kernel's launches and the fit's host
    reads."""
    from deepof_tpu_torch import msm

    n_rec, frames, k, d = POSTHOC_COHORT
    _, emb, _ = synthetic_cohort(n_rec, frames, k, d)
    seqs = {key: np.asarray(v, np.float32) for key, v in emb.items()}
    out = {"recordings": n_rec, "frames": n_rec * frames}
    torch.cuda.synchronize()
    _kernel_counts(reset=True)
    t0 = time.perf_counter()
    model = msm.GaussianHMM(N_COMPONENTS, device="cuda").fit(np.stack(list(seqs.values())))
    t1 = time.perf_counter()
    hmm = model._decode(list(seqs.values()), [None] * n_rec)
    t2 = time.perf_counter()
    out["hmm"] = {"fit_s": t1 - t0, "decode_s": t2 - t1, "frames_per_s": n_rec * frames / (t2 - t0),
                  "launches": _kernel_counts()["hmm_scan"], "host_reads": 2}
    t0 = time.perf_counter()
    fit = msm.fit_msm_pcca(seqs, n_macro=N_COMPONENTS, device="cuda")
    t1 = time.perf_counter()
    msm_counts = msm.decode_msm(fit, seqs)
    t2 = time.perf_counter()
    km = fit["kmeans"]
    out["msm"] = {"fit_s": t1 - t0, "decode_s": t2 - t1, "frames_per_s": n_rec * frames / (t2 - t0),
                  "minibatch_steps_and_host_reads": km.n_steps_,
                  "kmeanspp_host_copies": km.n_init * km.n_clusters, "reassigned": km.reassigned_}
    for name, counts, width in (("hmm", hmm, N_COMPONENTS), ("msm", list(msm_counts.values()), N_COMPONENTS)):
        for c in counts:
            if c.shape != (frames, width) or not np.isfinite(c).all() or np.abs(c.sum(1) - 1).max() > 1e-4:
                _fail(f"lab cohort {name} soft counts: {c.shape}, finite {np.isfinite(c).all()}")
    _log(f"softcounts lab cohort: {out}")
    return out


def _softcounts_phase(torch, card, cohort):
    """Phase 11: soft-count extraction. hmm_scan against its plain version
    and timed (:func:`_check_time_hmm`); then on the cohort, with the
    kernels' counts reset before each call, embedding_per_video with each
    method at its defaults (K 10, M_gates 3, n_micro 200, lagtime 3, the
    Center distance gate of the B-W pair), recluster(states=10) and
    get_contrastive_soft_counts(states="bic") on the served embeddings;
    card vs CPU on the prefix copy (:func:`_softcounts_card_vs_cpu`); and
    the lab cohort (:func:`_softcounts_lab_cohort`). Returns (the
    softcounts line, {path: launches}, the kernel's errors and times)."""
    from deepof_tpu_torch import posthoc as ph
    from deepof_tpu_torch.train.inference import embedding_per_video

    t_phase = time.perf_counter()
    hmm_abs, hmm_rel, long, timed = _check_time_hmm(torch)
    coords, (_, meta, _, tab_dict, scaler), bundle = (cohort["coords"], cohort["graph_dataset"], cohort["bundle"])
    n_windows = min(COHORT_FRAMES) - WINDOW + 1
    calls, launches, sums = {}, {}, {}
    emb = None
    for method, width in SOFTCOUNT_METHODS.items():
        torch.cuda.synchronize()
        _kernel_counts(reset=True)
        t0 = time.perf_counter()
        emb, counts = embedding_per_video(coords, tab_dict, bundle, meta, animal_id="B", global_scaler=scaler,
                                          batch_size=BLOCK, softcounts_extraction_method=method)
        calls[method] = time.perf_counter() - t0
        launches[method] = _kernel_counts()
        sums[method] = max(float(np.abs(counts[k].sum(1) - 1).max()) for k in COHORT_KEYS)
        for key in COHORT_KEYS:
            if counts[key].shape != (n_windows, width) or not np.isfinite(counts[key]).all():
                _fail(f"softcounts {method} {key}: shape {counts[key].shape}, not ({n_windows}, {width})")
        if method != "combined" and not sums[method] <= 1e-4:
            _fail(f"softcounts {method}: rows do not sum to 1 ({sums[method]})")
        _log(f"softcounts {method}: {calls[method]:.3f} s, launches {launches[method]}, shape "
             f"{counts[COHORT_KEYS[0]].shape} a recording, rows' max |sum - 1| {sums[method]:.2e}")
    if launches["hmm"]["hmm_scan"] <= 0 or any(launches[m]["hmm_scan"] for m in ("gmm", "msm", "combined")):
        _fail(f"hmm_scan launches on the softcounts path: {launches}")

    for name, fn in (("recluster", lambda: ph.recluster(coords, emb, states=N_COMPONENTS, save=False)),
                     ("contrastive_bic", lambda: ph.get_contrastive_soft_counts(
                         coords, emb, states="bic", max_states=CONTRASTIVE_MAX_STATES))):
        torch.cuda.synchronize()
        _kernel_counts(reset=True)
        t0 = time.perf_counter()
        out = fn()
        calls[name] = time.perf_counter() - t0
        launches[name] = _kernel_counts()
        k_out = out[COHORT_KEYS[0]].shape[1]
        for key in COHORT_KEYS:
            if out[key].shape != (n_windows, k_out) or np.abs(out[key].sum(1) - 1).max() > 1e-4:
                _fail(f"softcounts {name} {key}: shape {out[key].shape} or rows not summing to 1")
        _log(f"softcounts {name}: {calls[name]:.3f} s, {k_out} states, launches {launches[name]}")

    card_vs_cpu = _softcounts_card_vs_cpu(torch, cohort["prefix"], bundle)
    lab = _softcounts_lab_cohort(torch)
    launches["lab_hmm"] = {"hmm_scan": lab["hmm"]["launches"]}
    line = {
        "path": "softcounts", "recordings": len(COHORT_KEYS), "windows_per_recording": n_windows,
        "calls_s": calls, "launches": launches, "rows_max_abs_sum_err": sums,
        "contrastive_max_states": CONTRASTIVE_MAX_STATES, "hmm_scan_long": long, "hmm_scan_timed": timed,
        "card_vs_cpu": card_vs_cpu, "lab_cohort": lab, "phase_s": time.perf_counter() - t_phase, "card": card,
    }
    return line, launches, (hmm_abs, hmm_rel, timed)


# Phase 12: the TCN and transformer encoders and decoders, and Contrastive.
# The served bundles (model, encoder); Contrastive reads half windows and
# takes its soft counts from the "msm" decoder.
ENCODER_BUNDLES = (("VQVAE", "TCN"), ("VQVAE", "transformer"), ("VaDE", "transformer"), ("Contrastive", "TCN"))
# The models stepped card vs CPU and fitted through deep_unsupervised_embedding.
ENCODER_STEPS = (("VQVAE", "TCN"), ("VaDE", "transformer"), ("Contrastive", "TCN"))
ENCODER_REFERENCES = ("tcn_reference.npz", "transformer_reference.npz")
# The card against the JAX package's outputs in the reference files: float32
# convolutions and attention in other summation orders, ~1e-7 relative an
# operation, on outputs of magnitude ~1 (the VaDE file's 1.31e-6 on one H100).
ENCODER_REF_ATOL = 1e-5
# One step, the card (float32) against the CPU's plain PyTorch in float64
# (the same weights, batch and draws): a float32 CPU is no reference here.
# The TCN steps' BatchNorm gradients sum 384,000 terms a channel that
# cancel to a small residual, and on an H100 80GB HBM3 (700 W) the CPU's
# float32 gradients were 5.2e-2 (VQ-VAE-TCN) and 1.1e-2 (Contrastive-TCN)
# of max(1, max |g|) off the float64 ones where the card's were 5.4e-3 and
# 3.9e-3, cuDNN on or off (the transformer's: 4.2e-5 and 4.6e-5, measured
# on one H100). The loss at ENCODER_STEP_LOSS_RTOL relative, each
# gradient at ENCODER_STEP_GRAD_RTOL of max(1, its max |g_64|) (the floor
# for the conv biases a train-mode BatchNorm absorbs, whose exact gradient
# is 0), the running statistics after the step at STEP_RTOL of max(1,
# |value|).
ENCODER_STEP_LOSS_RTOL = 1e-5
ENCODER_STEP_GRAD_RTOL = 2e-2
# The depth of the phase's checks on the CPU: the card-vs-CPU serving on a
# copy of this many frames a recording, the card-vs-CPU float64 step on the
# first windows of the training batch, and the fits' batches (train, val).
# The served bundles, the timed steps at TRAIN_BATCH and every check stay.
ENCODER_CHECK_FRAMES = 500
ENCODER_CHECK_BATCH = 64
ENCODER_FIT_BATCHES = (20, 2)


def _seed_running_stats(torch, model, seed):
    """Seeded BatchNorm running statistics (means N(0, 0.2), variances
    0.5 + U(0, 1)), so that eval mode does not normalise by 0 and 1."""
    from deepof_tpu_torch.models.blocks import BatchNorm

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.2)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
    return model


def _encoder_model(torch, model, encoder, adjacency, n, e, device):
    from deepof_tpu_torch.models import build_model

    net = build_model(model, (WINDOW, n, 3), (WINDOW, e, 1), adjacency, LATENT, N_COMPONENTS,
                      encoder_type=encoder, generator=torch.Generator().manual_seed(0), device="cpu")
    return _seed_running_stats(torch, net, 1).to(device)


def _encoder_spec(model, encoder, n, e):
    spec = {"model": model, "input_shape": [WINDOW, n, 3], "edge_feature_shape": [WINDOW, e, 1],
            "encoder_type": encoder, "use_angles": False}
    if model != "Contrastive":
        spec["n_components"] = N_COMPONENTS
    return spec


def _check_encoder_outputs(name, outs, rows, window):
    """Shapes, finiteness and row sums of one bundle's served results."""
    emb, sc = outs
    n_windows = rows - window + 1
    for key in PUBLIC_KEYS:
        width = N_COMPONENTS if not name.startswith("Contrastive") else SOFTCOUNT_METHODS["msm"]
        if emb[key].shape != (n_windows, LATENT) or sc[key].shape != (n_windows, width):
            _fail(f"{name} served {key}: shapes {emb[key].shape}, {sc[key].shape}")
        if not (np.isfinite(emb[key]).all() and np.isfinite(sc[key]).all()):
            _fail(f"{name} served {key}: non-finite embeddings or soft counts")
        sum_err = float(np.abs(sc[key].sum(axis=1) - 1.0).max())
        if not sum_err <= 1e-4:
            _fail(f"{name} served {key}: soft counts do not sum to 1 (max |sum - 1| {sum_err})")


def _encoders_serving(torch, data, prefix, bundles):
    """Each bundle through ``embedding_per_video(batch_size=BLOCK)`` on the
    public project twice, the second timed from a reset of the kernels'
    counts (one window launch a block, no GRU or HMM launch); then card vs
    CPU (float32 both) on the ENCODER_CHECK_FRAMES copy ``prefix``, each at PATH_RTOL: the
    model on the card's scaled frames, and the whole path from each
    device's own project (the transformer magnifies the scaling pass's
    last-bit differences: 9.26e-5 of max(1, |value|) on an H100 80GB HBM3
    at 700 W)."""
    from deepof_tpu_torch.core.storage import get_dt
    from deepof_tpu_torch.train.inference import ModelBundle, embedding_per_video, scanned_windowed_forward

    coords, (_, meta, _, tab_dict, scaler) = data["coords"], data["ggd"]
    serving = {}
    for name, bundle in bundles.items():
        window = WINDOW // 2 if name.startswith("Contrastive") else WINDOW
        embedding_per_video(coords, tab_dict, bundle, meta, global_scaler=scaler, batch_size=BLOCK)
        torch.cuda.synchronize()
        _kernel_counts(reset=True)
        t0 = time.perf_counter()
        outs = embedding_per_video(coords, tab_dict, bundle, meta, global_scaler=scaler, batch_size=BLOCK)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        launches = _kernel_counts()
        n_blocks = len(PUBLIC_KEYS) * -(-(PUBLIC_FRAMES - window + 1) // BLOCK)
        want = {"window_streams": n_blocks, "gru_scan": 0, "gru_scan_bwd": 0, "hmm_scan": 0, "kalman_rts": 0}
        if launches != want:
            _fail(f"serving {name} launched {launches}, not {want}")
        _check_encoder_outputs(name, outs, PUBLIC_FRAMES, window)
        serving[name] = {"call_s": call_s, "window": window, "launches": launches,
                         "windows_per_s": len(PUBLIC_KEYS) * (PUBLIC_FRAMES - window + 1) / call_s}
        _log(f"served {name}: {call_s:.3f} s (second call), launches {launches}")

    card_tab, card_meta, _, on_card = _run_public(torch, prefix, list(bundles.values()), "cuda")
    on_cpu = _run_public(torch, prefix, list(bundles.values()), "cpu", precision="float32")[3]
    errs = {}
    for (name, bundle), got, want in zip(bundles.items(), on_card, on_cpu):
        window = WINDOW // 2 if name.startswith("Contrastive") else WINDOW
        _check_encoder_outputs(name, got, ENCODER_CHECK_FRAMES, window)
        cpu_bundle = ModelBundle(copy.deepcopy(bundle.model).to("cpu"), bundle.rebuild_spec)
        err = {"model_embeddings": 0.0, "model_soft_counts": 0.0, "path_embeddings": 0.0, "path_soft_counts": 0.0,
               "path_labels_differing": 0}
        for key in PUBLIC_KEYS:
            # The model alone: the CPU's plain path on the card's scaled frame.
            cols = list(get_dt(card_tab._scaled_frames, key, only_metainfo=True)["columns"])
            layout = {"node": [cols.index(c) for c in card_meta["node_columns"]],
                      "edge": [cols.index(c) for c in card_meta["edge_columns"]], "angle": None}
            emb, sc = scanned_windowed_forward(cpu_bundle, card_tab._scaled_device[key].cpu(), layout, window,
                                               bundle.rebuild_spec["model"], block=BLOCK, device="cpu")
            err["model_embeddings"] = max(err["model_embeddings"], _rel_err(got[0][key], emb))
            if sc is not None:
                err["model_soft_counts"] = max(err["model_soft_counts"], _rel_err(got[1][key], sc))
            # The whole path, each device from its own project.
            err["path_embeddings"] = max(err["path_embeddings"], _rel_err(got[0][key], want[0][key]))
            err["path_soft_counts"] = max(err["path_soft_counts"], _rel_err(got[1][key], want[1][key]))
            err["path_labels_differing"] += int((got[1][key].argmax(1) != want[1][key].argmax(1)).sum())
        _log(f"{name} on the {ENCODER_CHECK_FRAMES}-frame copy, card vs CPU plain: {err} (tol {PATH_RTOL:.0e})")
        if not max(err["model_embeddings"], err["model_soft_counts"]) <= PATH_RTOL:
            _fail(f"card and CPU disagree on {name}'s served outputs from the same frames: {err}")
        if not max(err["path_embeddings"], err["path_soft_counts"]) <= PATH_RTOL:
            _fail(f"card and CPU disagree on {name}'s served outputs over the whole path: {err}")
        errs[name] = err
    return serving, errs


def _bn_stats_err(cpu_model, card_model):
    """Max |card - CPU| / max(1, max |CPU|) over the BatchNorm buffers."""
    card = card_model.state_dict()
    return max(_rel_err(card[k].cpu().numpy(), v.numpy()) for k, v in cpu_model.state_dict().items()
               if "running" in k)


def _step_vs_float64(torch, loss_fn, cpu_model, card_model, label):
    """One step's loss and every parameter gradient on the card against the
    same step on the CPU in float64 (``loss_fn(model, device, dtype)`` ->
    total), and the running statistics after it. Fails beyond
    ENCODER_STEP_LOSS_RTOL / ENCODER_STEP_GRAD_RTOL / STEP_RTOL. Returns
    (loss rel error, worst and median gradient rel error, running
    statistics rel error)."""
    loss = {}
    for side, m, device, dtype in (("cpu64", cpu_model, "cpu", torch.float64),
                                   ("card", card_model, "cuda", torch.float32)):
        m.zero_grad(set_to_none=True)
        total = loss_fn(m, device, dtype)
        total.backward()
        loss[side] = total.item()
    loss_err = abs(loss["card"] - loss["cpu64"]) / max(1.0, abs(loss["cpu64"]))
    errs = {}
    for (name, pc), (_, pg) in zip(cpu_model.named_parameters(), card_model.named_parameters()):
        if pc.grad is None or pg.grad is None:
            _fail(f"{label} left {name} without a gradient")
        want = pc.grad.double()
        errs[name] = float((pg.grad.cpu().double() - want).abs().max()) / max(1.0, float(want.abs().max()))
    worst = max(errs, key=errs.get)
    median = float(np.median(list(errs.values())))
    stats_err = _bn_stats_err(cpu_model, card_model)
    _log(f"{label}, card (float32) vs CPU (float64): loss {loss['card']:.6f} vs {loss['cpu64']:.6f}, rel "
         f"{loss_err:.3e} (tol {ENCODER_STEP_LOSS_RTOL:.0e}); gradients of max(1, max|g_64|): worst {errs[worst]:.3e} "
         f"at {worst}, median {median:.3e} (tol {ENCODER_STEP_GRAD_RTOL:.0e}); running statistics after it "
         f"{stats_err:.3e} (tol {STEP_RTOL:.0e})")
    if not (loss_err <= ENCODER_STEP_LOSS_RTOL and errs[worst] <= ENCODER_STEP_GRAD_RTOL and stats_err <= STEP_RTOL):
        _fail(f"{label}: the card and the CPU's float64 step disagree (loss {loss_err}, gradients {errs[worst]} at "
              f"{worst}, running statistics {stats_err})")
    return loss_err, errs[worst], median, stats_err


def _encoders_steps(torch, data):
    """One train step of each ENCODER_STEPS model on the card against the
    CPU's float64 step from the same weights, batch (the first
    ENCODER_CHECK_BATCH windows) and draws, dropout at rate 0 on both
    sides: the loss, every gradient and the BatchNorm running statistics
    after it; then the step on the card at its default dropout and
    TRAIN_BATCH, its launches and TIMED_STEPS timed steps, with the peak
    memory."""
    import copy as _copy

    from deepof_tpu_torch.models.blocks import DropoutDraws, set_dropout_rate, use_dropout_draws
    from deepof_tpu_torch.train import harness
    from deepof_tpu_torch.train.augment import build_rotation_precomp, draw_augmentations
    from deepof_tpu_torch.train.config import CommonFitCfg, ContrastiveCfg, TurtleTeacherCfg, VaDECfg
    from deepof_tpu_torch.train.losses import vade_params_from_cfg

    x, a, adjacency = data["x"], data["a"], data["ggd"][2]
    n, e = x.shape[2], a.shape[2]
    xc, ac = x[:ENCODER_CHECK_BATCH], a[:ENCODER_CHECK_BATCH]
    edges = harness.graph_edges(adjacency)
    precomp = build_rotation_precomp(edges, n)
    ccfg = ContrastiveCfg()
    vade_params = vade_params_from_cfg(CommonFitCfg(n_components=N_COMPONENTS), VaDECfg(), TurtleTeacherCfg(), False)
    g = torch.Generator().manual_seed(5)
    eps_z = torch.randn(ENCODER_CHECK_BATCH, LATENT, generator=g)
    eps_kl = torch.randn(32, ENCODER_CHECK_BATCH, LATENT, generator=g)
    draws = draw_augmentations(torch.Generator().manual_seed(6), xc.shape, precomp, ccfg)

    def loss_fn(model_name):
        def fn(m, dev, dtype):
            def to(v):
                return v.to(dev, dtype) if v.is_floating_point() else v.to(dev)

            xb, ab = torch.as_tensor(xc, device=dev, dtype=dtype), torch.as_tensor(ac, device=dev, dtype=dtype)
            if model_name == "VQVAE":
                return harness.vqvae_loss(m, xb, ab)[0]
            if model_name == "VaDE":
                return harness.vade_step_loss(m, xb, ab, None, vade_params, 0.5, to(eps_z), to(eps_kl))[0]
            on_dev = {k: {kk: to(v) for kk, v in d.items()} for k, d in draws.items()}
            return harness.contrastive_step_loss(m, xb, edges, precomp, ccfg, draws=on_dev)[0]
        return fn

    steps = {}
    for model_name, encoder in ENCODER_STEPS:
        label = f"one {model_name}-{encoder} step"
        card_model = set_dropout_rate(_encoder_model(torch, model_name, encoder, adjacency, n, e, "cpu"), 0.0)
        cpu_model = _copy.deepcopy(card_model).double()
        card_model = card_model.to("cuda")
        loss_err, grad_err, grad_median, stats_err = _step_vs_float64(torch, loss_fn(model_name), cpu_model,
                                                                      card_model, label)
        del cpu_model, card_model

        model = _encoder_model(torch, model_name, encoder, adjacency, n, e, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        use_dropout_draws(model, DropoutDraws(gen))
        opt = harness._make_optimizer(model.named_parameters(), 3e-4)
        xb, ab = torch.as_tensor(x, device="cuda"), torch.as_tensor(a, device="cuda")
        if model_name == "VQVAE":
            step = harness.make_vqvae_step(model, opt)
            run = lambda: step(xb, ab)  # noqa: E731
        elif model_name == "VaDE":
            step = harness.make_vade_step(model, opt, vade_params, gen)
            run = lambda: step(xb, ab, kl_weight=0.5)  # noqa: E731
        else:
            step = harness.make_contrastive_step(model, opt, ccfg, edges, precomp, gen)
            run = lambda: step(xb)  # noqa: E731
        run()
        torch.cuda.synchronize()
        _kernel_counts(reset=True)
        run()
        launches = _kernel_counts()
        if any(launches.values()):
            _fail(f"{label} launched {launches}: a TCN or transformer step launches no kernel of the port")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            logs = run()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / TIMED_STEPS * 1e3
        if not all(np.isfinite(v.item()) for v in logs.values()):
            _fail(f"non-finite {model_name}-{encoder} losses after {TIMED_STEPS + 2} steps: {logs}")
        steps[f"{model_name}_{encoder}"] = {
            "ms_per_step": step_ms, "windows_per_s": TRAIN_BATCH * 1e3 / step_ms, "launches": launches,
            "check_batch": ENCODER_CHECK_BATCH,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "loss_rel_err_vs_cpu64": loss_err, "grad_rel_err_vs_cpu64": grad_err,
            "grad_median_rel_err_vs_cpu64": grad_median, "running_stats_rel_err_vs_cpu64": stats_err}
        del model, opt, step
    return steps


def _encoders_fits(torch, data):
    """``deep_unsupervised_embedding`` for one epoch of ENCODER_FIT_BATCHES
    batches (VaDE: one pretrain epoch too) at default dropout
    for each ENCODER_STEPS model: finite losses, no kernel of the port
    launched, and the saved bundle read back with ``ModelBundle.load``
    serving what the trained bundle serves."""
    from deepof_tpu_torch.train.harness import ModelBundle
    from deepof_tpu_torch.train.inference import embedding_per_video

    coords, ggd = data["coords"], data["ggd"]
    _, meta, adjacency, tab_dict, scaler = ggd
    fits = {}
    for model_name, encoder in ENCODER_STEPS:
        name = f"{model_name}_{encoder}"
        _kernel_counts(reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bundle, _, _, summary = coords.deep_unsupervised_embedding(
            ggd[:3], adjacency_matrix=adjacency, embedding_model=model_name, encoder_type=encoder,
            batch_size=TRAIN_BATCH, latent_dim=LATENT, n_clusters=N_COMPONENTS, epochs=1, pretrain_epochs=1,
            save_checkpoints=True, verbose=False, limit_train_batches=ENCODER_FIT_BATCHES[0],
            limit_val_batches=ENCODER_FIT_BATCHES[1])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = _kernel_counts()
        if launches["gru_scan"] or launches["gru_scan_bwd"]:
            _fail(f"fitting {name} launched the GRU kernels: {launches}")
        if not summary or not all(np.isfinite(v) for v in summary.values()):
            _fail(f"{name} training losses: {summary}")
        path = os.path.join(coords._project_path, coords._project_name, "Trained_models", "models",
                            f"{name}_latent{LATENT}_k{N_COMPONENTS}_run0.ckpt")
        loaded = ModelBundle.load(path)
        t0 = time.perf_counter()
        outs = [embedding_per_video(coords, tab_dict, b, meta, global_scaler=scaler, batch_size=BLOCK)
                for b in (bundle, loaded)]
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        _check_encoder_outputs(name, outs[0], PUBLIC_FRAMES, WINDOW // 2 if model_name == "Contrastive" else WINDOW)
        for key in PUBLIC_KEYS:
            if not (np.array_equal(outs[0][0][key], outs[1][0][key]) and np.array_equal(outs[0][1][key],
                                                                                       outs[1][1][key])):
                _fail(f"the reloaded {name} bundle serves other outputs than the trained one on {key}")
        fits[name] = {"fit_s": fit_s, "serve_two_bundles_s": serve_s, "launches": launches, "losses": summary}
        _log(f"fit {name}: {fit_s:.2f} s, launches {launches}, losses {summary}")
    return fits


def _encoders_references(torch):
    """The card's VQ-VAE-TCN and VaDE-transformer on the JAX package's
    outputs in the reference files (ENCODER_REF_ATOL), the count of
    differing hard labels reported."""
    from deepof_tpu_torch.train.inference import scanned_windowed_forward

    out = {}
    for name in ENCODER_REFERENCES:
        bundle, ref, frame, layout = encoder_reference_bundle(
            os.path.join(os.path.dirname(REFERENCE_NPZ), name), "cuda")
        emb, counts = scanned_windowed_forward(bundle, frame, layout, int(ref["window"]), str(ref["model"]),
                                               block=128, device="cuda")
        err = {"embeddings": float(np.abs(emb - ref["embeddings"]).max()),
               "soft_counts": float(np.abs(counts - ref["soft_counts"]).max()),
               "labels_differing": int((counts.argmax(1) != ref["hard_labels"]).sum())}
        _log(f"{name}: the card against the JAX package's outputs {err} (tol {ENCODER_REF_ATOL:.0e})")
        if not max(err["embeddings"], err["soft_counts"]) <= ENCODER_REF_ATOL:
            _fail(f"the card's {ref['model']}-{ref['encoder_type']} differs from the JAX package's outputs: {err}")
        out[name] = err
    return out


def _encoders_phase(torch, card, data, tmp, tables):
    """Phase 12: the TCN and transformer encoders and decoders, and
    Contrastive at its default TCN encoder: serving, one train step card vs
    CPU, the fits, and the card against the JAX package's reference files.
    The card-vs-CPU serving runs on an ENCODER_CHECK_FRAMES copy of the
    public recordings (``tables``) written under ``tmp``. Returns (stage
    line, launches of each served bundle's second call)."""
    t_phase = time.perf_counter()
    prefix = _write_public_project(os.path.join(tmp, "encoders_copy"), tables, ENCODER_CHECK_FRAMES)
    graph, *_ = _frame_layout(ANIMALS)
    n, e = graph.n_nodes, graph.n_edges
    bundles = {}
    from deepof_tpu_torch.train.inference import ModelBundle

    for model_name, encoder in ENCODER_BUNDLES:
        net = _encoder_model(torch, model_name, encoder, graph.adjacency, n, e, "cuda")
        bundles[f"{model_name}_{encoder}"] = ModelBundle(net.eval(), _encoder_spec(model_name, encoder, n, e))
    stage_s, t0 = {}, time.perf_counter()
    serving, serve_errs = _encoders_serving(torch, data, prefix, bundles)
    del bundles
    stage_s["serving_and_card_vs_cpu"], t0 = time.perf_counter() - t0, time.perf_counter()
    steps = _encoders_steps(torch, data)
    stage_s["steps_and_cpu_float64"], t0 = time.perf_counter() - t0, time.perf_counter()
    fits = _encoders_fits(torch, data)
    stage_s["fits"], t0 = time.perf_counter() - t0, time.perf_counter()
    references = _encoders_references(torch)
    stage_s["jax_reference"] = time.perf_counter() - t0
    line = {
        "path": "encoders", "latent": LATENT, "n_components": N_COMPONENTS, "window": WINDOW,
        "batch": TRAIN_BATCH, "serving": serving, "serving_card_vs_cpu": serve_errs,
        "card_vs_cpu_frames": ENCODER_CHECK_FRAMES, "steps": steps, "timed_steps": TIMED_STEPS, "fits": fits,
        "fit_batches": list(ENCODER_FIT_BATCHES),
        "jax_reference": references, "stages_s": stage_s, "phase_s": time.perf_counter() - t_phase, "card": card,
    }
    return line, {f"encoders_{k}": v["launches"] for k, v in serving.items()}


# Phase 15: embedding evaluation, chunk features, normative scores, Kernel
# SHAP and burst smoothing on the cohort's served VaDE embeddings and phase
# 10's supervised tags. The BIC scan's settings (the four covariance types,
# float64 rows):
EVAL_GMM = dict(n_components_range=(4, 8), part_size=1_000, n_runs=2)
# Card vs CPU from the same host inputs: float64 results (compactness, AP,
# BICs, chunk statistics, log densities, Shapley values) within EVAL_RTOL of
# max(1, |value|) entry by entry (compactness and AP of |value|); kNN
# fractions within EVAL_KNN_RTOL of their value (float32 products summed in
# other orders can move near ties); labels, bin_info and folds exactly.
EVAL_RTOL = 1e-10
EVAL_KNN_RTOL = 1e-4
# The evaluation table card vs CPU over this many behaviours (the first ones
# scored; the CPU's kNN search takes ~4 s a behaviour); the card's timed
# call scores every behaviour.
EVAL_CPU_BEHAVIOURS = 2
# The chunk features card vs CPU, each device from its own prefix project
# (float32 kinematics both, as the getters phase holds them), over the raw
# features (distances, angles, areas; kin_derivative 0): speeds are rounded
# to 0.025 (3 decimals x 25 fps), and a speed within float32 noise of a
# rounding boundary (the aligned coordinates' noise, see phase 9) rounds one
# unit apart on the two devices (2.9e-4 of a column's max on one H100).
# This many chunks drawn; tables and statistics within PATH_RTOL of max(1,
# max |value|) of a column, labels and bin_info exactly (they read only the
# soft counts and numpy's draw).
EVAL_CHUNK_SAMPLES = 2_000
EVAL_RAW_FEATURES = dict(kin_derivative=0, include_distances=True, include_angles=True, include_areas=True)
# Chunks drawn on the full cohort (annotate_time_chunks' default).
EVAL_CHUNKS = 10_000
# A lab's size for the three metrics: recordings, windows each, embedding
# width; the share of windows in a behaviour (runs of ~25 windows).
EVAL_LAB = (24, 45_000, LATENT)
EVAL_LAB_RATE = 0.1
# The normative KDE's cohort: seeded experiments (half controls), frames each.
EVAL_NORMATIVE = (24, 2_000)
EVAL_SHAP_ROWS = 16
EVAL_BACKGROUND = 10


def _eval_err(name, got, want) -> dict:
    """{part: max relative error} of one phase-15 result card vs CPU; fails
    on differing labels, shapes, NaNs, settings or exact parts."""
    from deepof_tpu_torch.posthoc import Labelled

    if isinstance(want, Labelled):
        if list(got.index) != list(want.index) or list(got.columns) != list(want.columns):
            _fail(f"evaluation {name}: labels differ card vs CPU ({got.index}, {got.columns})")
        if not name.startswith("evaluation"):
            return {"values": _rel_each(got.values, want.values)}
        if not np.array_equal(np.isnan(got.values), np.isnan(want.values)):
            _fail(f"evaluation {name}: NaNs differ card vs CPU")
        diff = np.abs(np.nan_to_num(got.values - want.values))
        rel = diff / np.maximum(np.abs(np.nan_to_num(want.values)), 1e-300)
        knn = np.array(["knn" in str(c) for c in want.columns])
        return {"float64": float(rel[:, ~knn].max(initial=0.0)), "knn": float(rel[:, knn].max(initial=0.0))}
    out = {}
    for part, w in want.items():
        g = got[part]
        if isinstance(w, Labelled):
            out.update({f"{part}_{k}": v for k, v in _eval_err(f"{name}.{part}", g, w).items()})
        elif isinstance(w, tuple):
            if g != w:
                _fail(f"evaluation {name}: {part} differs card vs CPU ({g} vs {w})")
        else:
            out[part] = _rel_each(g, w)
    return out


def _rel_each(got, want) -> float:
    """Max |got - want| / max(1, |want|) entry by entry; NaNs must match."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.array_equal(np.isnan(got), np.isnan(want)):
        _fail(f"shapes or NaNs differ: {got.shape} vs {want.shape}")
    diff = np.abs(np.nan_to_num(got - want))
    return float((diff / np.maximum(1.0, np.abs(np.nan_to_num(want)))).max(initial=0.0))


def _chunk_calls(coords, counts, tags, samples, kin_derivative=1, **include):
    """{name: fn(device)} of the chunk-feature calls on ``coords``: animal
    B's kinematics table, and its kinematics (by default its speeds) with
    the tags appended cut into WINDOW-frame chunks (numpy's draw seeded
    before each call), by mean and by the summary statistics."""
    from deepof_tpu_torch import posthoc as ph

    def annotate(aggregate):
        def fn(device):
            np.random.seed(0)
            return ph.annotate_time_chunks(coords, counts, tags, window_size=WINDOW, animal_id="B", samples=samples,
                                           aggregate=aggregate, kin_derivative=kin_derivative, device=device,
                                           **include)
        return fn

    return {"kinematics": lambda device: ph.align_deepof_kinematics_with_unsupervised_labels(
                coords, kin_derivative=kin_derivative, animal_id="B", device=device),
            "chunks_mean": annotate("mean"), "chunks_stats": annotate("stats")}


def _chunks_card_vs_cpu(prefix, counts, tags):
    """The chunk calls over EVAL_RAW_FEATURES on the cohort's prefix copy,
    each device from its own project (float32 both) with the same soft
    counts, tags and draw: labels and bin_info exactly, tables and
    statistics within PATH_RTOL of max(1, max |value|) of their column."""
    card = _chunk_calls(_cohort_project(prefix, "cuda"), counts, tags, EVAL_CHUNK_SAMPLES, **EVAL_RAW_FEATURES)
    cpu = _chunk_calls(_cohort_project(prefix, "cpu", precision="float32"), counts, tags, EVAL_CHUNK_SAMPLES,
                       **EVAL_RAW_FEATURES)
    errs = {}
    for name in card:
        got, want = card[name]("cuda"), cpu[name]("cpu")
        if name == "kinematics":
            pairs = [(got[k].realize(), want[k].realize(), got[k].columns == want[k].columns) for k in COHORT_KEYS]
        else:
            (g_stats, g_y, g_bins), (w_stats, w_y, w_bins) = got, want
            if not (np.array_equal(g_y, w_y) and list(g_bins) == list(w_bins)
                    and all(np.array_equal(g_bins[k], w_bins[k]) for k in w_bins)):
                _fail(f"{name} on the cohort copy: labels or bin_info differ card vs CPU")
            pairs = [(g_stats.values, w_stats.values, g_stats.columns == w_stats.columns)]
        err = 0.0
        for g, w, same_columns in pairs:
            if not same_columns or g.shape != w.shape or not np.array_equal(np.isnan(g), np.isnan(w)):
                _fail(f"{name} on the cohort copy: columns, shapes or NaNs differ card vs CPU")
            scale = np.maximum(1.0, np.nanmax(np.abs(w), axis=0, initial=0.0))
            err = max(err, float((np.abs(np.nan_to_num(g - w)) / scale).max(initial=0.0)))
        errs[name] = err
        _log(f"evaluation {name} on the cohort copy, card vs CPU (float32 raw features both): {err:.3e} "
             f"(tol {PATH_RTOL:.0e}); labels and bin_info equal")
        if not err <= PATH_RTOL:
            _fail(f"card and CPU disagree on {name} of the cohort copy: {err}")
    return errs


def _lab_embeddings(seed=0):
    """(z float32 (n, D), y bool) at EVAL_LAB's size: seeded embeddings, a
    behaviour in runs of ~25 windows over ~EVAL_LAB_RATE of them shifting
    the embedding, and 200 idle stretches of 50 identical windows."""
    n_rec, frames, d = EVAL_LAB
    n = n_rec * frames
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, d)).astype(np.float32)
    starts = rng.choice(n - 100, int(EVAL_LAB_RATE * n / 25), replace=False)
    delta = np.zeros(n + 1_000, np.int64)
    np.add.at(delta, starts, 1)
    np.add.at(delta, starts + np.minimum(rng.geometric(1 / 25, size=len(starts)), 900), -1)
    y = np.cumsum(delta)[:n] > 0
    z[y] += (0.8 * rng.normal(size=d)).astype(np.float32)
    for start in rng.choice(n - 50, 200, replace=False):
        z[start:start + 50] = z[start]
    return z, y


def _evaluation_lab(torch):
    """The three metrics at a lab's size (EVAL_LAB), each twice on the card
    (the second timed) and once on the CPU: compactness, separability
    (100,000 training rows, 5 folds) and kNN agreement (50,000 references,
    10,000 queries)."""
    from deepof_tpu_torch import evaluation as ev

    t0 = time.perf_counter()
    z, y = _lab_embeddings()
    out = {"windows": int(len(z)), "positive_rate": float(y.mean()), "synthesize_s": time.perf_counter() - t0}
    calls = {"compactness": lambda dev: ev.compute_compactness(z[y], z, device=dev),
             "separability": lambda dev: ev.compute_separability_logreg(z, y, device=dev),
             "knn_agreement": lambda dev: ev.compute_knn_agreement(z, y, device=dev)}
    for name, fn in calls.items():
        fn("cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn("cuda")
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = fn("cpu")
        cpu_s = time.perf_counter() - t0
        if list(got) != list(want):
            _fail(f"lab {name}: keys differ card vs CPU")
        diff = {k: abs(got[k] - want[k]) for k in want}
        tol = EVAL_KNN_RTOL if name == "knn_agreement" else EVAL_RTOL
        worst = max(diff[k] / max(abs(want[k]), 1e-300) for k in want)
        out[name] = {"card_s": card_s, "cpu_s": cpu_s, "card": got, "abs_diff": diff, "max_rel_err": worst,
                     "tol": tol}
        _log(f"evaluation lab {name}: card {card_s:.4f} s, CPU {cpu_s:.4f} s, {got}, card vs CPU max rel "
             f"{worst:.3e} (tol {tol:.0e})")
        if not worst <= tol:
            _fail(f"card and CPU disagree on the lab's {name}: {diff}")
    n, n_pos = len(y), int(y.sum())
    used = n if n <= 100_000 else sum(min(int(round(100_000 * c / n)), c) for c in (n - n_pos, n_pos))
    sizes = (out["separability"]["card"]["n_used"], out["knn_agreement"]["card"]["n_ref"],
             out["knn_agreement"]["card"]["n_pos_queries"])
    if sizes != (used, min(n, 50_000), min(n_pos, 10_000)):
        _fail(f"the lab metrics' rows, references and queries: {sizes}")
    return out


def _shap_model(torch, x, k, seed=0):
    """A seeded softmax-linear model of standardised features (x's column
    means and deviations), called with float64 tensors on any device."""
    rng = np.random.default_rng(seed)
    w, b = torch.as_tensor(rng.normal(size=(x.shape[1], k))), torch.as_tensor(rng.normal(size=k))
    mu, sd = torch.as_tensor(x.mean(axis=0)), torch.as_tensor(x.std(axis=0) + 1e-9)

    def model(v):
        dev = v.device
        return torch.softmax(((v - mu.to(dev)) / sd.to(dev)) @ w.to(dev) + b.to(dev), dim=1)

    return model


def _evaluation_calls(torch, coords, emb, counts, tags):
    """({name: fn(device)} of phase 15's calls compared card vs CPU,
    {name: fn()} of its host calls, the inputs' sizes). Host inputs made
    once: the cohort's embeddings in float64 (the BIC scan), the full
    cohort's chunk means (the SHAP background and rows, the folds) and
    4,000 chunks of the first recording's kinematics (the statistics)."""
    from deepof_tpu_torch import evaluation as ev
    from deepof_tpu_torch import posthoc as ph
    from deepof_tpu_torch import shap_kernel as shap
    from deepof_tpu_torch import visuals as vis
    from deepof_tpu_torch.ops.bursts import smooth_boolean_array

    z64 = np.concatenate([np.asarray(emb[k], np.float64) for k in COHORT_KEYS])
    np.random.seed(0)
    means, _, bin_info = ph.annotate_time_chunks(coords, counts, tags, window_size=WINDOW, animal_id="B",
                                                 device="cuda")
    features = np.nan_to_num(means.values)
    kin = ph.align_deepof_kinematics_with_unsupervised_labels(coords, animal_id="B", device="cuda")
    table = kin[COHORT_KEYS[0]].realize()
    starts = np.sort(np.random.default_rng(1).choice(len(table) - WINDOW, min(4_000, len(table) - WINDOW),
                                                     replace=False))
    chunks = table[starts[:, None] + np.arange(WINDOW)[None, :]]
    model = _shap_model(torch, features, N_COMPONENTS)
    rows = features[:EVAL_SHAP_ROWS]
    _, norm_emb, norm_conds = synthetic_cohort(EVAL_NORMATIVE[0], EVAL_NORMATIVE[1], N_COMPONENTS, LATENT, seed=3)
    tag_table = tags[COHORT_KEYS[0]].realize()
    binary = [j for j in range(tag_table.shape[1]) if np.nanmax(tag_table[:, j]) <= 1]
    tag_column = max(binary, key=lambda j: np.nansum(tag_table[:, j]))
    scored = vis.return_embedding_evaluation(coords, emb, tags, window_size=WINDOW, device="cuda").index
    picked = list(scored[:EVAL_CPU_BEHAVIOURS])

    def gmm(dev):
        np.random.seed(0)
        bic, m_bic, best = ev.gmm_model_selection(z64, cv_types=("spherical", "tied", "diag", "full"), device=dev,
                                                  **EVAL_GMM)
        return {"bic": np.asarray(bic), "median_bic": np.asarray(m_bic),
                "best": (best.covariance_type, best.n_components, best.n_iter_)}

    def normative(dev):
        agg = ph.get_aggregated_embedding(norm_emb, device=dev)
        controls = [i for i, k in enumerate(agg.index) if norm_conds[k]["condition"][0] == "control"]
        fitted = ph.fit_normative_global_model(agg.values[controls], device=dev)
        return {"bandwidth": (fitted.bandwidth,), "scores": ph.score_against_normative(fitted, agg)}

    def explain(dev):
        bg = shap.kmeans_background(features, EVAL_BACKGROUND, device=dev)
        ex = shap.KernelExplainer(model, bg, device=dev)
        return {"background": bg.data, "weights": bg.weights, "expected": ex.expected_value,
                "shap": np.stack(ex.shap_values(rows))}

    calls = {
        "evaluation_any": lambda dev: vis.return_embedding_evaluation(
            coords, emb, tags, include_behaviors=picked, window_size=WINDOW, device=dev),
        "evaluation_center": lambda dev: vis.return_embedding_evaluation(
            coords, emb, tags, include_behaviors=picked, window_size=WINDOW, alignment_mode="center", device=dev),
        "gmm_model_selection": gmm,
        "chunk_statistics": lambda dev: ph.chunk_summary_statistics(chunks, list(kin[COHORT_KEYS[0]].columns),
                                                                    device=dev),
        "normative": normative,
        "shap": explain,
    }
    host = {"chunk_cv_splitter": lambda: ph.chunk_cv_splitter(means, bin_info),
            "smooth_boolean_array": lambda: smooth_boolean_array(tag_table[:, tag_column] > 0.5)}
    sizes = {"embedding_rows": int(len(z64)), "behaviours_scored": list(scored), "cpu_behaviours": picked,
             "chunk_features": list(features.shape), "statistics_chunks": list(chunks.shape),
             "shap_rows": int(len(rows)), "normative_experiments": EVAL_NORMATIVE[0],
             "smoothed_tag": str(tags[COHORT_KEYS[0]].columns[tag_column])}
    return calls, host, sizes, (means, bin_info)


def _evaluation_phase(torch, card, cohort, tags):
    """Phase 15: evaluation on the cohort. Serves the cohort's trained
    bundle with the kernels' counts reset; then each call of
    :func:`_evaluation_calls` twice on the card (the second timed) and once
    on the CPU from the same host inputs, at EVAL_RTOL / EVAL_KNN_RTOL; the
    host calls (folds, burst smoothing) timed and checked; the chunk calls
    on the full cohort timed on the card (10,000 chunks drawn) and card vs
    CPU on the prefix copy (:func:`_chunks_card_vs_cpu`); the lab-size
    metrics (:func:`_evaluation_lab`). Returns (the evaluation line, the
    serving launches)."""
    from deepof_tpu_torch import visuals as vis
    from deepof_tpu_torch.train.inference import embedding_per_video

    t_phase = time.perf_counter()
    coords, (_, meta, _, tab_dict, scaler), bundle = (cohort["coords"], cohort["graph_dataset"], cohort["bundle"])
    torch.cuda.synchronize()
    _kernel_counts(reset=True)
    t0 = time.perf_counter()
    emb, counts = embedding_per_video(coords, tab_dict, bundle, meta, animal_id="B", global_scaler=scaler,
                                      batch_size=BLOCK)
    embed_s = time.perf_counter() - t0
    launches = _kernel_counts()
    n_blocks = len(COHORT_KEYS) * -(-(min(COHORT_FRAMES) - WINDOW + 1) // BLOCK)
    want = {"window_streams": n_blocks, "gru_scan": 4 * n_blocks, "gru_scan_bwd": 0, "hmm_scan": 0, "kalman_rts": 0}
    if launches != want:
        _fail(f"serving the cohort for evaluation launched {launches}, not {want}")

    calls, host, sizes, (means, bin_info) = _evaluation_calls(torch, coords, emb, counts, tags)
    card_s, cpu_s, errs = {}, {}, {}
    for name, fn in calls.items():
        fn("cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn("cuda")
        torch.cuda.synchronize()
        card_s[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        want_ = fn("cpu")
        cpu_s[name] = time.perf_counter() - t0
        errs[name] = _eval_err(name, got, want_)
        knn = errs[name].get("knn", 0.0)
        worst = max([v for k, v in errs[name].items() if k != "knn"] + [0.0])
        _log(f"evaluation {name}: card {card_s[name]:.4f} s, CPU {cpu_s[name]:.4f} s, card vs CPU {errs[name]} "
             f"(tol {EVAL_RTOL:.0e}, kNN {EVAL_KNN_RTOL:.0e})")
        if not (worst <= EVAL_RTOL and knn <= EVAL_KNN_RTOL):
            _fail(f"card and CPU disagree on evaluation {name}: {errs[name]}")
    for mode in ("any", "center"):
        vis.return_embedding_evaluation(coords, emb, tags, window_size=WINDOW, alignment_mode=mode, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        table = vis.return_embedding_evaluation(coords, emb, tags, window_size=WINDOW, alignment_mode=mode,
                                                device="cuda")
        torch.cuda.synchronize()
        card_s[f"evaluation_{mode}_all_behaviours"] = time.perf_counter() - t0
        if not (len(table.index) >= 1 and len(table.columns) == 10 and np.isfinite(table.values[:, :2]).all()):
            _fail(f"the cohort's evaluation table ({mode}): {table.index}, {table.columns}")

    outs = {}
    for name, fn in host.items():
        t0 = time.perf_counter()
        outs[name] = fn()
        card_s[name] = time.perf_counter() - t0
    folds = outs["chunk_cv_splitter"]
    n_chunks = len(means.values)
    tests = [np.sort(te) for _, te in folds]
    if len(folds) != len(COHORT_KEYS) or not np.array_equal(np.sort(np.concatenate(tests)), np.arange(n_chunks)):
        _fail(f"chunk_cv_splitter: {len(folds)} folds over {n_chunks} chunks")
    sizes["smoothed_frames"] = int(outs["smooth_boolean_array"].sum())

    drawn = min(EVAL_CHUNKS, sum(len(v) for v in counts.values()))
    for name, fn in _chunk_calls(coords, counts, tags, EVAL_CHUNKS).items():
        fn("cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn("cuda")
        torch.cuda.synchronize()
        card_s[name] = time.perf_counter() - t0
        if name == "chunks_stats":
            chunk_stats = out
        if name != "kinematics" and not len(out[1]) == len(out[0].values) == drawn:
            _fail(f"{name} on the cohort: {len(out[1])} labels, {len(out[0].values)} chunks, not {drawn}")
    chunk_errs = _chunks_card_vs_cpu(cohort["prefix"], counts, tags)
    lab = _evaluation_lab(torch)
    line = {
        "path": "evaluation", "recordings": len(COHORT_KEYS), "windows": [len(v) for v in counts.values()],
        "embed_s": embed_s, "launches": launches, "calls_s": card_s, "cpu_calls_s": cpu_s, "card_vs_cpu": errs,
        "chunks_card_vs_cpu": chunk_errs, "sizes": sizes, "gmm": EVAL_GMM, "lab": lab,
        "phase_s": time.perf_counter() - t_phase, "card": card,
    }
    z = np.concatenate([np.asarray(emb[k], np.float64) for k in COHORT_KEYS])
    hard = np.concatenate([np.asarray(counts[k]).argmax(axis=1) for k in COHORT_KEYS])
    return line, launches, (chunk_stats, z, hard)


# Phase 13: VaDE's TURTLE teacher and resumable checkpoints on the training
# phase's project, at the teacher's defaults (500 outer x 100 inner steps, a
# batch of 2,048, PCA views of 32 dimensions, K 10).
TEACHER_EPOCHS = 4  # main epochs of the first call; the second asks for one more and resumes
TEACHER_REFRESH_EVERY = 2
TEACHER_CHECK = (2_048, 20, 100)  # windows, outer and inner steps of the card-vs-CPU fit
TEACHER_RTOL = 1e-4  # tau_star and class weights card vs CPU, of max(1, |value|)
GMM_INIT_RTOL = 1e-6  # initialize_gmm_from_teacher card vs CPU (float64 both)
TEACHER_TIMED_STEPS = 20
TEACHER_PROFILED_STEPS = 2


def _rel(got, want) -> float:
    got, want = (v.detach().double().cpu() for v in (got, want))
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def _teacher_card_vs_cpu(torch, data):
    """The teacher fit on TEACHER_CHECK's subset of the training windows,
    ``initialize_gmm_from_teacher`` and one distilled VaDE main step, each
    on the card and on the CPU from the same inputs and draws (float32; the
    GMM init in float64 on both)."""
    from deepof_tpu_torch.models import build_model
    from deepof_tpu_torch.models.blocks import lecun_normal
    from deepof_tpu_torch.train import harness, teacher
    from deepof_tpu_torch.train.config import CommonFitCfg, TurtleTeacherCfg, VaDECfg
    from deepof_tpu_torch.train.dataset import WindowDataset
    from deepof_tpu_torch.train.losses import vade_params_from_cfg

    n, outer, inner = TEACHER_CHECK
    train_ds = harness._dataset_from_preprocessed(data["ggd"][0][0])
    sub = WindowDataset({"subset": (train_ds.x[:n], train_ds.a[:n], train_ds.angles[:n])})
    latents = np.random.default_rng(13).normal(size=(n, LATENT)).astype(np.float32)
    common = CommonFitCfg(n_components=N_COMPONENTS, seed=0)
    cfg = TurtleTeacherCfg(use_turtle_teacher=True, teacher_outer_steps=outer, teacher_inner_steps=inner)
    g = torch.Generator().manual_seed(13)
    dims = [32, 32, LATENT]
    draws = teacher.TeacherDraws(task=[lecun_normal((d, N_COMPONENTS), d, g) for d in dims],
                                 heads=[[lecun_normal((d, N_COMPONENTS), d, g) for d in dims] for _ in range(outer)])
    fits, secs = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        fits[dev] = teacher.fit_turtle_teacher(latents, sub, common, cfg, verbose=False, device=dev, draws=draws)
        torch.cuda.synchronize()
        secs[f"fit_{dev}_s"] = time.perf_counter() - t0
    errs = {"tau_star": _rel(fits["cuda"][0], fits["cpu"][0]), "class_weight": _rel(fits["cuda"][1], fits["cpu"][1])}
    gmm = {dev: teacher.initialize_gmm_from_teacher(torch.as_tensor(latents, device=dev), fits["cpu"][0].to(dev))
           for dev in ("cuda", "cpu")}
    errs["gmm_init"] = max(_rel(a, b) for a, b in zip(gmm["cuda"], gmm["cpu"]))
    _log(f"teacher on {n} windows at {outer} x {inner} steps, card vs CPU (float32): {errs} "
         f"(tol {TEACHER_RTOL:.0e}, GMM init {GMM_INIT_RTOL:.0e}); {secs}")
    if not (errs["tau_star"] <= TEACHER_RTOL and errs["class_weight"] <= TEACHER_RTOL):
        _fail(f"the teacher fit differs card vs CPU: {errs}")
    if not errs["gmm_init"] <= GMM_INIT_RTOL:
        _fail(f"initialize_gmm_from_teacher differs card vs CPU: {errs['gmm_init']}")

    x, a, adjacency = data["x"], data["a"], data["ggd"][2]
    params = vade_params_from_cfg(CommonFitCfg(n_components=N_COMPONENTS), VaDECfg(), cfg, False)
    gen = torch.Generator().manual_seed(14)
    eps_z, eps_kl = torch.randn(TRAIN_BATCH, LATENT, generator=gen), torch.randn(32, TRAIN_BATCH, LATENT, generator=gen)
    tau_b, cw = fits["cpu"][0][:TRAIN_BATCH], fits["cpu"][1]
    cpu_model = build_model("VaDE", x.shape[1:], a.shape[1:], adjacency, LATENT, N_COMPONENTS,
                            generator=torch.Generator().manual_seed(0), device="cpu")
    card_model = copy.deepcopy(cpu_model).to("cuda")

    def loss_fn(m, dev):
        total, logs = harness.vade_step_loss(
            m, torch.as_tensor(x, device=dev), torch.as_tensor(a, device=dev), None, params, 0.5, eps_z.to(dev),
            eps_kl.to(dev), tau_star_batch=tau_b.to(dev), lambda_distill=cfg.lambda_distill, class_weight=cw.to(dev))
        if not logs["distill_loss"].item() > 0:
            _fail(f"the distilled step's distillation term is {logs['distill_loss'].item()}")
        return total

    errs["step_loss"], errs["step_grads"], _ = _step_grads_vs_cpu(torch, loss_fn, cpu_model, card_model,
                                                                  "one distilled VaDE main step")
    return errs, secs


def _outer_step_cost(torch, data, bundle):
    """The default teacher's outer step on the card (the views of the
    training windows and the trained bundle's latents): ms over
    TEACHER_TIMED_STEPS steps, and kernel launches and device ms a step
    over TEACHER_PROFILED_STEPS profiled ones."""
    from torch.profiler import ProfilerActivity, profile

    from deepof_tpu_torch.train import harness, teacher
    from deepof_tpu_torch.train.config import TurtleTeacherCfg

    cfg = TurtleTeacherCfg()
    train_ds = harness._dataset_from_preprocessed(data["ggd"][0][0])
    views = teacher.build_views(train_ds.x, harness.extract_latents(bundle.model, train_ds, TRAIN_BATCH),
                                pca_nodes_dim=cfg.pca_nodes_dim, device="cuda")
    dims = [v.shape[1] for v in views]
    init_fn, step_fn = teacher.make_turtle_step(
        dims, N_COMPONENTS, outer_steps=cfg.teacher_outer_steps, inner_steps=cfg.teacher_inner_steps,
        head_temp=cfg.teacher_head_temp, task_temp=cfg.teacher_task_temp, gamma=cfg.teacher_gamma,
        alpha_sample_entropy=cfg.teacher_alpha_sample_entropy)
    draws = teacher.TeacherDraws(torch.Generator(device="cuda").manual_seed(0))
    task, opt = init_fn(draws.task_weights(dims, N_COMPONENTS, "cuda", torch.float32))
    batch = min(cfg.teacher_batch_size, len(train_ds))
    idx = torch.as_tensor(np.random.default_rng(0).choice(len(train_ds), batch, replace=False), device="cuda")

    def step(i):
        return step_fn(task, opt, [v[idx] for v in views], draws.head_weights(i, dims, N_COMPONENTS, "cuda",
                                                                              torch.float32), 0.1, bool(i % 2))

    step(0), step(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(TEACHER_TIMED_STEPS):
        loss = step(i)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / TEACHER_TIMED_STEPS * 1e3
    if not np.isfinite(loss.item()):
        _fail(f"the teacher's outer loss is {loss.item()}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(TEACHER_PROFILED_STEPS):
            step(i)
        torch.cuda.synchronize()
    kernels = [evt for evt in prof.key_averages() if evt.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(evt, "is_user_annotation", False)]
    device_us = sum(float(getattr(evt, "self_device_time_total", getattr(evt, "self_cuda_time_total", 0.0)))
                    for evt in kernels)
    return {"ms": ms, "launches": sum(evt.count for evt in kernels) / TEACHER_PROFILED_STEPS,
            "device_ms": device_us / 1e3 / TEACHER_PROFILED_STEPS, "dims": dims,
            "timed_steps": TEACHER_TIMED_STEPS}


def _teacher_phase(torch, card, data):
    """Phase 13: VaDE's TURTLE teacher and resumable checkpoints. Card vs
    CPU (``_teacher_card_vs_cpu``); then ``deep_unsupervised_embedding``
    at its default model with the teacher at its defaults, refreshed every
    TEACHER_REFRESH_EVERY epochs with the prior re-initialised, checkpoints
    every epoch and the bundles saved, for one pretrain and TEACHER_EPOCHS
    main epochs of TRAIN_BATCHES + VAL_BATCHES batches; then the same call
    for one epoch more, which resumes. Checks tau_star of every teacher fit
    (finite, rows summing to 1), the alignment scores, the best-score
    bundle reloaded and served, the resumed state equal to the saved one bit
    for bit, and the GRU kernels' launches. Returns (stage line, launches of
    the first call)."""
    from deepof_tpu_torch.train import diagnostics, harness
    from deepof_tpu_torch.train.checkpoint import TrainCheckpointer
    from deepof_tpu_torch.train.inference import embedding_per_video

    t_phase = time.perf_counter()
    errs, check_s = _teacher_card_vs_cpu(torch, data)
    coords, ggd = data["coords"], data["ggd"]
    _, meta, adjacency, tab_dict, scaler = ggd
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_checkpoints_")
    events, saves, resumes = [], {}, []

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            events.append((name, t0, time.perf_counter(), out if name == "teacher" else None))
            return out
        return wrapper

    def save(self, epoch, state, force=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = original_save(self, epoch, state, force)
        saves[epoch] = {"s": time.perf_counter() - t0, "bytes": os.path.getsize(self._path(epoch)),
                        "state": copy.deepcopy({k: v for k, v in state.items()})}
        return done

    def resume(checkpointer, model, optimizer):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start = original_resume(checkpointer, model, optimizer)
        torch.cuda.synchronize()
        if checkpointer is not None:
            resumes.append({"start": start, "s": time.perf_counter() - t0, "model": copy.deepcopy(model.state_dict()),
                            "optimizer": copy.deepcopy(optimizer.state_dict())})
        return start

    originals = {k: getattr(harness, k) for k in ("fit_turtle_teacher", "extract_latents",
                                                  "initialize_gmm_from_teacher", "_resume")}
    original_save, original_resume = TrainCheckpointer.save, originals["_resume"]
    harness.fit_turtle_teacher = timed("teacher", originals["fit_turtle_teacher"])
    harness.extract_latents = timed("latents", originals["extract_latents"])
    harness.initialize_gmm_from_teacher = timed("gmm_init", originals["initialize_gmm_from_teacher"])
    harness._resume = resume
    TrainCheckpointer.save = save
    kw = dict(adjacency_matrix=adjacency, batch_size=TRAIN_BATCH, latent_dim=LATENT, n_clusters=N_COMPONENTS,
              pretrain_epochs=1, save_checkpoints=True, verbose=False, limit_train_batches=TRAIN_BATCHES,
              limit_val_batches=VAL_BATCHES, use_turtle_teacher=True, teacher_refresh_every=TEACHER_REFRESH_EVERY,
              reinit_gmm_on_refresh=True, checkpoint_dir=ckdir, checkpoint_every=1)
    try:
        _kernel_counts(reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bundle, first_score, _, summary = coords.deep_unsupervised_embedding(ggd[:3], epochs=TEACHER_EPOCHS, **kw)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        launches = _kernel_counts()
        first_events = list(events)
        _kernel_counts(reset=True)
        t1 = time.perf_counter()
        resumed, score, _, resumed_summary = coords.deep_unsupervised_embedding(ggd[:3], epochs=TEACHER_EPOCHS + 1,
                                                                                **kw)
        torch.cuda.synchronize()
        resume_call_s = time.perf_counter() - t1
        resume_launches = _kernel_counts()
        files = sorted(os.listdir(ckdir))
    finally:
        for k, fn in originals.items():
            setattr(harness, k, fn)
        TrainCheckpointer.save = original_save
        shutil.rmtree(ckdir, ignore_errors=True)

    # Every teacher fit: tau_star finite, each row summing to 1; its
    # confidence and usage, and the served model's against the last one.
    fits = [e for e in events if e[0] == "teacher"]
    teacher_diag = [{k.split("/")[1]: v for k, v in diagnostics.compute_diagnostics(tau).items()}
                    | {"marginal": tau.double().mean(0).tolist()} for _, _, _, (tau, _) in fits]
    val_x, val_a, _, _ = next(harness._dataset_from_preprocessed(ggd[0][1]).batches(4 * TRAIN_BATCH, shuffle=False))
    q = resumed.group(val_x, val_a)
    served_diag = {**diagnostics.alignment_score(q, fits[-1][3][0]), "marginal": q.double().mean(0).tolist(),
                   **{k.split("/")[1]: v for k, v in diagnostics.compute_diagnostics(q).items()},
                   **{k.split("/")[1]: v for k, v in
                      diagnostics.compute_gmm_diagnostics(resumed.model.state_dict()).items()}}
    _log(f"teacher fits: {teacher_diag}; the resumed bundle on {4 * TRAIN_BATCH} validation windows: {served_diag}")
    n_first = sum(e[0] == "teacher" for e in first_events)
    want_fits = 1 + sum(1 for ep in range(1, TEACHER_EPOCHS) if (ep + 1) % TEACHER_REFRESH_EVERY == 0)
    if n_first != want_fits or len(fits) != want_fits + 1:
        _fail(f"{n_first} teacher fits in the first call (not {want_fits}), {len(fits)} in both")
    for _, _, _, (tau, cw) in fits:
        row_err = float((tau.double().sum(1) - 1.0).abs().max())
        if not (torch.isfinite(tau).all() and torch.isfinite(cw).all() and row_err <= 1e-5):
            _fail(f"tau_star: finite {bool(torch.isfinite(tau).all())}, max |row sum - 1| {row_err}")
    scores = bundle.history.get("val_alignment_score", []) + resumed.history.get("val_alignment_score", [])
    if len(scores) != TEACHER_EPOCHS + 1 or not all(0.0 <= s <= 1.0 for s in scores):
        _fail(f"alignment scores {scores}")
    for losses in (summary, resumed_summary):
        if not losses or not all(np.isfinite(v) for v in losses.values()) or not losses["distill_loss"] > 0:
            _fail(f"teacher-distilled VaDE losses: {losses}")
    for name in ("gru_scan", "gru_scan_bwd"):
        if launches[name] <= 0:
            _fail(f"kernel {name} was not launched on the teacher path: {launches}")

    # The best-score bundle: the rule takes epochs after max(3, ceil(0.1 *
    # epochs)), so the first call (epochs 0-3) keeps none and the resumed
    # one keeps epoch 4's; it is returned, saved, reloaded and served.
    if first_score is not None:
        _fail(f"the first call kept a best-score bundle at {first_score.best_score} before the rule's start")
    models = os.path.join(coords._project_path, coords._project_name, "Trained_models", "models")
    path = os.path.join(models, f"VaDE_recurrent_latent{LATENT}_k{N_COMPONENTS}_run0_best_score.ckpt")
    if score is None or not os.path.exists(path) or not 0.0 <= score.best_score <= 1.0:
        _fail(f"no best-score bundle (score {score}, file {os.path.exists(path)})")
    loaded = harness.ModelBundle.load(path)
    outs = [embedding_per_video(coords, tab_dict, b, meta, global_scaler=scaler, batch_size=BLOCK)
            for b in (score, loaded)]
    _check_public_outputs(outs, PUBLIC_FRAMES)
    for key in PUBLIC_KEYS:
        if not np.array_equal(outs[0][1][key], outs[1][1][key]):
            _fail(f"the reloaded best-score bundle serves other soft counts than the returned one on {key}")

    # The resumed call: it starts after the last saved epoch, from that
    # epoch's state, bit for bit.
    last = TEACHER_EPOCHS - 1
    if len(resumes) != 2 or resumes[1]["start"] != TEACHER_EPOCHS:
        _fail(f"resumes {[r['start'] for r in resumes]}, not [0, {TEACHER_EPOCHS}]")
    saved = saves[last]["state"]
    for part in ("model", "optimizer"):
        unequal = _unequal_leaves(resumes[1][part], saved[part])
        if unequal:
            _fail(f"the resumed {part} state differs from the saved one at {unequal[:5]}")
    main_keys = [k for k in resumed.history if not k.startswith("pretrain/")]
    if not main_keys or any(len(resumed.history[k]) != 1 for k in main_keys):
        _fail(f"the resumed call ran {[len(resumed.history[k]) for k in main_keys]} main epochs, not 1")
    if files != [f"epoch_{e}.pt" for e in range(TEACHER_EPOCHS - 2, TEACHER_EPOCHS + 1)] + ["teacher_init.pkl"]:
        _fail(f"checkpoint files {files}")

    def span(name, which=0):
        hits = [e for e in first_events if e[0] == name]
        return hits[which][1], hits[which][2]

    lat0, teach0, gmm0 = span("latents"), span("teacher"), span("gmm_init")
    phases_s = {"pretrain": lat0[0] - t0, "latents": lat0[1] - lat0[0], "teacher": teach0[1] - teach0[0],
                "gmm_init": gmm0[1] - gmm0[0], "main": t_end - gmm0[1],
                "refreshes": sum(e[2] - e[1] for e in first_events[first_events.index(
                    next(e for e in first_events if e[0] == "gmm_init")) + 1:]), "fit": t_end - t0}
    outer = _outer_step_cost(torch, data, bundle)
    _log(f"teacher path: phases {phases_s}, launches {launches}, resumed call {resume_call_s:.2f} s "
         f"{resume_launches}, outer step {outer}")
    line = {
        "path": "teacher", "batch": TRAIN_BATCH, "latent": LATENT, "n_components": N_COMPONENTS,
        "main_epochs": TEACHER_EPOCHS, "fit_batches": [TRAIN_BATCHES, VAL_BATCHES],
        "teacher_fit_s": phases_s["teacher"], "teacher_fits_s": [e[2] - e[1] for e in fits],
        "outer_steps": 500, "outer_step_ms": outer["ms"], "launches_per_outer_step": outer["launches"],
        "outer_step_device_ms": outer["device_ms"], "views": outer["dims"], "phases_s": phases_s,
        "resume_call_s": resume_call_s, "launches": launches, "resume_launches": resume_launches,
        "checkpoint": {"save_s": [saves[e]["s"] for e in sorted(saves)], "bytes": saves[last]["bytes"],
                       "restore_s": resumes[1]["s"]},
        "alignment_scores": scores, "best_score": score.best_score, "losses": summary,
        "resumed_losses": resumed_summary,
        "teacher_diagnostics": teacher_diag, "served_diagnostics": served_diag,
        "card_vs_cpu": errs, "card_vs_cpu_s": check_s, "phase_s": time.perf_counter() - t_phase, "card": card,
    }
    return line, launches


# --------------------------------------------------------------------------- #
# Phase 14: full imputation, and a project past the device residency budgets
# --------------------------------------------------------------------------- #

# (T, C) of kalman_rts against kalman_rts_plain: one animal's block of a
# public recording (the plain version on the card, timed), both animals',
# a ragged one, one frame, tracks inside the covariances' ~30-step
# transient, and a chunk - 1, a chunk and a chunk + 1 of steps (the chunk
# length is MIN_CHUNK = 64 up to 20,481 frames).
KALMAN_CHECK = ((PUBLIC_FRAMES, 28), (PUBLIC_FRAMES, 56), (7, 33), (1, 28), (20, 28), (29, 28), (64, 28),
                (65, 28), (66, 28), (130, 33))
KALMAN_LONG = (4 * PUBLIC_FRAMES, 28)  # a 2-hour recording's animal, held against a float64 serial chain
# Of max(1, |reference|). The kernel runs the serial chain's arithmetic, but
# every chunk past the first starts from a state carried over the chunks in
# another order, a few ulp off the serial chain's; the maps contract by
# 0.674 a step and damp that, so the outputs stay within float32's rounding
# of the chain (3.0e-7 at most seen over these shapes on an H100 80GB HBM3 at
# 700 W).
KALMAN_TOL = 1e-5
KALMAN_TIMED = ((PUBLIC_FRAMES, 28), (PUBLIC_FRAMES, 56), KALMAN_LONG)
OCCLUSION_RUNS = 40  # runs of 4-60 frames a bodypart, on a third of each recording's bodyparts
ABSENT = (1_200, 1_350)  # frames of "test" where W is absent (inside the prefix copy too)
PROJECTION_RTOL = 1e-8  # pca / random_projection card vs CPU (float64 both; other eigensolvers)
# The imputation copy's scaled frames card vs CPU, of max(1, |value|): the
# ridge sweep's float32 Gram matrices and solves run in other orders on the
# two devices (tables 3.7e-7 apart), and the scaling divides an imputed
# sample's last bits by the local deviation of its speeds and distances
# (3.9e-4-4.1e-4 seen on an H100 80GB HBM3 at 700 W). Solved in float64, the
# sweep leaves the JAX package's float32 one by more than
# tests/test_torch_imputation.py allows, so it stays float32. Tables,
# embeddings and soft counts keep PATH_RTOL.
IMPUTED_FRAME_RTOL = 1e-3


def _kalman_track(rng, t, c):
    return (rng.normal(size=(t, c)).cumsum(axis=0) * 2.0 + 300.0 + rng.normal(size=(t, c))).astype(np.float32)


def _kalman_f64(z):
    """The serial filter and smoother in float64 (numpy, batched over the
    channels) from the float32 gains: a reference for long tracks, where the
    float32 plain version on the card would take minutes."""
    from deepof_tpu_torch.ops.kalman_kernels import kalman_gains

    t_len = z.shape[0]
    g = kalman_gains(t_len).astype(np.float64)
    z = z.astype(np.float64)
    xf = np.empty(z.shape + (2,))
    x0 = x1 = z[0]
    xf[0, :, 0] = xf[0, :, 1] = x0
    for t in range(1, t_len):
        xp0 = x0 + x1
        innov = z[t] - xp0
        x0, x1 = xp0 + g[t, 4] * innov, x1 + g[t, 5] * innov
        xf[t, :, 0], xf[t, :, 1] = x0, x1
    out = np.empty_like(z)
    out[-1] = x0
    for t in range(t_len - 2, -1, -1):
        d0, d1 = x0 - (xf[t, :, 0] + xf[t, :, 1]), x1 - xf[t, :, 1]
        x0, x1 = xf[t, :, 0] + g[t, 0] * d0 + g[t, 1] * d1, xf[t, :, 1] + g[t, 2] * d0 + g[t, 3] * d1
        out[t] = x0
    return out


def _kalman_launch_ms(torch, z, calls=5):
    """Device ms of each of kalman_rts's launches (mean over ``calls`` calls,
    torch.profiler), by kernel name with its template argument (the names
    of ``kalman_rts_config``'s launches); None where the profiler saw no
    device time."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from deepof_tpu_torch.ops.kalman_kernels import kalman_rts

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            kalman_rts(z)
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        name = re.search(r"kalman_\w+(<\w+>)?", evt.key)
        if evt.device_type == torch.autograd.DeviceType.CUDA and name:
            us = float(getattr(evt, "self_device_time_total", getattr(evt, "self_cuda_time_total", 0.0)))
            out[name.group(0)] = out.get(name.group(0), 0.0) + us / 1e3 / calls
    return out or None


def _check_time_kalman(torch):
    """kalman_rts against kalman_rts_plain at KALMAN_CHECK (the plain
    version on the card at the first shape, timed there once; on the CPU,
    the same function, past it), against a float64 serial chain at
    KALMAN_LONG and at the first shape, two calls equal bit for bit, then
    timed at KALMAN_TIMED against the function's bytes bound and the
    algorithm's (its workspace traffic too), each launch timed apart.
    Returns (max abs err, max rel err, timing at the first shape with the
    others under "at_shapes")."""
    from deepof_tpu_torch.ops.kalman_kernels import kalman_rts, kalman_rts_config, kalman_rts_plain

    rng = np.random.default_rng(0)
    worst, inputs, plain_ms = (0.0, 0.0), {}, None
    for i, (t, c) in enumerate(KALMAN_CHECK + (KALMAN_LONG,)):
        z = _kalman_track(rng, t, c)
        inputs[(t, c)] = zc = torch.as_tensor(z, device="cuda")
        got = kalman_rts(zc)
        again = kalman_rts(zc)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            _fail(f"kalman_rts gave other bits on a second call at {(t, c)}")
        checks = {}
        if i == 0:
            t0 = time.perf_counter()
            want = kalman_rts_plain(zc)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            checks["plain (card)"] = want
        elif (t, c) != KALMAN_LONG:
            checks["plain (cpu)"] = kalman_rts_plain(torch.as_tensor(z)).to("cuda")
        if i == 0 or (t, c) == KALMAN_LONG:
            checks["float64 serial"] = torch.as_tensor(_kalman_f64(z), device="cuda")
        for name, want in checks.items():
            abs_err = float((got.double() - want.double()).abs().max())
            rel_err = abs_err / max(1.0, float(want.abs().max()))
            worst = (max(worst[0], abs_err), max(worst[1], rel_err))
            _log(f"kalman_rts vs {name} at {(t, c)}, plan chunk {kalman_rts_config(t, c)['chunk']} x "
                 f"{kalman_rts_config(t, c)['chunks']}: max|diff| {abs_err:.3e}, max|diff| / max(1, |ref|) "
                 f"{rel_err:.3e}, equal bits twice")
    _log(f"kalman_rts at {len(KALMAN_CHECK) + 1} shapes: max|diff| {worst[0]:.3e}, max|diff| / max(1, |ref|) "
         f"{worst[1]:.3e} (tol {KALMAN_TOL:.0e})")
    if not worst[1] <= KALMAN_TOL:
        _fail(f"kalman_rts disagrees with its plain version: {worst}")

    timed = []
    for t, c in KALMAN_TIMED:
        z = inputs[(t, c)]
        plan = kalman_rts_config(t, c)
        ms = _cuda_ms(torch, lambda: kalman_rts(z), reps=20, warmup=2)
        n_bytes = 2 * 4 * t * c  # the function: z read once, the output written once
        # The algorithm: z read twice (offsets, rerun), x_filt (8 bytes a
        # channel-step) written once and read twice, the output written; the
        # gains' 32 bytes a step written once and read by the four walks (8,
        # 8, 16, 16); the chunk offsets and starts written and read.
        algo_bytes = 36 * t * c + 80 * t + 2 * 4 * 8 * plan["chunks"] * c
        flop = 20 * t * c  # filter and smoother: ~20 FP32 operations a channel-step
        by_bytes, by_ops = n_bytes / PEAK_BYTES * 1e3, flop / PEAK_FP32 * 1e3
        timed.append({"shape": f"z ({t}, {c}) float32", "plan": {k: plan[k] for k in ("chunk", "chunks", "launches")},
                      "ms": ms, "ns_per_step": ms * 1e6 / t, "bound_ms": max(by_bytes, by_ops),
                      "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                      "algorithm_bytes": algo_bytes,
                      "algorithm_bound_ms": max(algo_bytes / PEAK_BYTES * 1e3, by_ops),
                      "launch_ms": _kalman_launch_ms(torch, z), "library_ms": None})
    timed[0]["plain_ms"] = plain_ms
    _log(f"kalman_rts timed: {timed}")
    return worst[0], worst[1], {**timed[0], "at_shapes": timed}


def _occluded_tables(tables, seed=0):
    """The public recordings with occlusions past the 3-frame linear limit:
    on a third of each recording's bodyparts, OCCLUSION_RUNS runs of 4-60
    frames at likelihood 0.05; W absent (every bodypart at 0.05) over
    ABSENT of "test"."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, (values, cols) in tables.items():
        values = values.copy()
        lik = [i for i, c in enumerate(cols) if c[3] == "likelihood"]
        for i in rng.choice(lik, len(lik) // 3, replace=False):
            for start, length in zip(rng.integers(0, len(values) - 60, OCCLUSION_RUNS),
                                     rng.integers(4, 61, OCCLUSION_RUNS)):
                values[start:start + length, i] = 0.05
        if key == "test":
            values[ABSENT[0]:ABSENT[1], [i for i in lik if cols[i][1] == "W"]] = 0.05
        out[key] = (values, cols)
    return out


def _imputation_project(root, device, iterative_imputation="full", precision="auto"):
    """(Project, Coordinates) of the csv project under ``root``."""
    from deepof_tpu_torch.data import Project

    proj = Project(
        project_path=root, project_name="imputation", video_path=f"{root}/Videos", table_path=f"{root}/Tables",
        arena="circular-autodetect", video_scale="380 mm", table_format="csv", frame_rate=FPS,
        animal_ids=ANIMALS, iterative_imputation=iterative_imputation, precision=precision, device=device,
    )
    return proj, proj.create(force=True, test=True, verbose=False)


class _StepTimer:
    """The three steps of full imputation timed (synchronised) while the
    block runs: seconds summed by step into ``stages``."""

    STEPS = {"iterative_ridge_impute": "ridge", "kalman_rts_smooth": "kalman",
             "enforce_skeleton_constraints": "constraints"}

    def __init__(self, torch, stages):
        from deepof_tpu_torch.ops import imputation

        self.torch, self.stages, self.module = torch, stages, imputation
        self.originals = {name: getattr(imputation, name) for name in self.STEPS}

    def __enter__(self):
        def wrap(fn, stage):
            def timed(*args, **kwargs):
                self.torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                self.torch.cuda.synchronize()
                self.stages[stage] = self.stages.get(stage, 0.0) + time.perf_counter() - t0
                return out
            return timed

        for name, stage in self.STEPS.items():
            setattr(self.module, name, wrap(self.originals[name], stage))
        return self

    def __exit__(self, *exc):
        for name, fn in self.originals.items():
            setattr(self.module, name, fn)


def _serve(torch, coords, bundle, device="cuda", **settings):
    """get_graph_dataset(window_size=25, **settings) -> embedding_per_video
    (batch 4096). Returns (graph dataset, embeddings, soft counts, seconds,
    peak device GiB)."""
    from deepof_tpu_torch.train.inference import embedding_per_video

    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ggd = coords.get_graph_dataset(window_size=WINDOW, **settings)
    emb, sc = embedding_per_video(coords, ggd[3], bundle, ggd[1], global_scaler=ggd[4], batch_size=BLOCK)
    if device != "cuda":
        return ggd, emb, sc, time.perf_counter() - t0, None
    torch.cuda.synchronize()
    return ggd, emb, sc, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30


def _imputation_budgets(torch, coords, bundle):
    """Path B: the imputed project served in budget and with both budgets
    below one recording's bytes (restored in a finally), at the default
    settings (the device route gives way to the general route) and with
    robust scaling (the general route both times). Returns ({case: report},
    {case: launches past the budgets})."""
    from deepof_tpu_torch.core import table_dict as ptd
    from deepof_tpu_torch.core.storage import get_dt

    n_blocks = len(PUBLIC_KEYS) * -(-(PUBLIC_FRAMES - WINDOW + 1) // BLOCK)
    reports, launches = {}, {}
    for case, settings, rtol in (("default", {}, PATH_RTOL), ("robust", {"scale": "robust"}, GENERAL_RTOL)):
        inb = _serve(torch, coords, bundle, **settings)
        one = min(f.numel() * 4 for f in inb[0][3]._scaled_device.values())  # a recording's float32 frame
        saved = (ptd.DEVICE_SCALE_BUDGET_BYTES, ptd.DEVICE_FRAMES_BYTES)
        try:
            ptd.DEVICE_SCALE_BUDGET_BYTES = ptd.DEVICE_FRAMES_BYTES = one // 2
            _kernel_counts(reset=True)
            past = _serve(torch, coords, bundle, **settings)
            launches[case] = _kernel_counts()
        finally:
            ptd.DEVICE_SCALE_BUDGET_BYTES, ptd.DEVICE_FRAMES_BYTES = saved
        tab = past[0][3]
        if sorted(tab._scaled_host) != sorted(PUBLIC_KEYS) or tab._scaled_device:
            _fail(f"past the budgets ({case}): frames on the host {sorted(tab._scaled_host)}, on the device "
                  f"{sorted(tab._scaled_device)}")
        if launches[case]["window_streams"] != n_blocks or launches[case]["gru_scan"] != 4 * n_blocks:
            _fail(f"past the budgets ({case}): launches {launches[case]} for {n_blocks} blocks")
        errs = {}
        for key in PUBLIC_KEYS:
            pairs = (("scaled frame", get_dt(tab._scaled_frames, key), get_dt(inb[0][3]._scaled_frames, key)),
                     ("embeddings", past[1][key], inb[1][key]), ("soft counts", past[2][key], inb[2][key]))
            for name, got, want in pairs:
                err = float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))
                errs[f"{key} {name}"] = err
                if not err <= rtol:
                    _fail(f"past the budgets ({case}) {key} {name} differs from the in-budget run: {err}")
        reports[case] = {"in_budget_s": inb[3], "past_budget_s": past[3], "in_budget_peak_gib": inb[4],
                         "past_budget_peak_gib": past[4], "frames_on_host": len(tab._scaled_host),
                         "budgets_bytes": one // 2, "max_rel_err": max(errs.values()), "tol": rtol}
        _log(f"budgets {case}: {reports[case]}, launches {launches[case]}")
    return reports, launches


def _item4_card_vs_cpu(torch, proj, coords, root):
    """pca (linear and rbf), random_projection and scale_tables on the card
    against the CPU, from the same inputs, each timed (second call)."""
    from deepof_tpu_torch.core import table_dict as ptd
    from deepof_tpu_torch.io.readers import load_table

    ggd = coords.get_graph_dataset(window_size=WINDOW)
    frames = ggd[3]._scaled_device
    card_td = ptd.TableDict(dict(ggd[3]._scaled_frames), typ="merged")
    card_td._device_frames = dict(frames)
    cpu_td = ptd.TableDict(dict(card_td), typ="merged")
    cpu_td._device_frames = {k: v.cpu() for k, v in frames.items()}
    raws = {key: load_table(f"{key}DLC_chip_smoke.csv", f"{root}/Tables", "csv").positions for key in PUBLIC_KEYS}
    cpu_proj = copy.copy(proj)
    cpu_proj.device = "cpu"
    calls = {
        "pca": lambda td: td.pca()[0],
        "pca_rbf": lambda td: td.pca(kernel="rbf")[0],
        "random_projection": lambda td: (np.random.seed(0), td.random_projection()[0])[1],
    }
    report = {}
    for name, fn in calls.items():
        fn(card_td)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(card_td)
        s = time.perf_counter() - t0
        want = fn(cpu_td)
        err = float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))
        report[name] = {"s": s, "max_rel_err": err}
        if not err <= PROJECTION_RTOL:
            _fail(f"{name} card vs CPU: {err}")
    proj.scale_tables(raws)
    t0 = time.perf_counter()
    got = proj.scale_tables(raws)
    s = time.perf_counter() - t0
    want = cpu_proj.scale_tables(raws)
    if any(not np.array_equal(got[k], want[k], equal_nan=True) for k in PUBLIC_KEYS):
        _fail("scale_tables differs card vs CPU")
    report["scale_tables"] = {"s": s, "max_rel_err": 0.0}
    _log(f"item 4 card vs CPU: {report} (tol {PROJECTION_RTOL:.0e}; scale_tables exactly)")
    return report


def _imputation_phase(torch, card, tmp, tables):
    """Phase 14: full imputation and a project past the device budgets. The
    Kalman/RTS kernel against its plain version and timed; the public
    recordings with occlusion runs (``_occluded_tables``) through
    ``Project(iterative_imputation="full").create(test=True)`` ->
    ``get_graph_dataset(window_size=25)`` -> ``embedding_per_video`` card
    vs CPU on the 2,000-frame copy (float32 both), then at full width from a
    reset of the kernels' counts, create timed by step beside a "partial"
    create of the same tables; then path B (``_imputation_budgets``) and the
    rest of item 4 (``_item4_card_vs_cpu``). Returns (stage line, launches
    by path, the kernel's (abs, rel) error, kernel timing)."""
    from deepof_tpu_torch.core.storage import get_dt
    from deepof_tpu_torch.train.inference import ModelBundle

    t_phase = time.perf_counter()
    kernel_err, kernel_rel, kernel_t = _check_time_kalman(torch)
    occluded = _occluded_tables(tables)
    full_root = _write_public_project(os.path.join(tmp, "occluded"), occluded, PUBLIC_FRAMES)
    prefix_root = _write_public_project(os.path.join(tmp, "occluded_prefix"), occluded, PREFIX)
    _, _, bundles = _public_bundles(torch)
    bundle = bundles[0]

    # Card vs the CPU plain versions (float32 both) on the prefix copy.
    t0 = time.perf_counter()
    sides = {}
    for dev in ("cuda", "cpu"):
        b = bundle if dev == "cuda" else ModelBundle(copy.deepcopy(bundle.model).to("cpu"), bundle.rebuild_spec)
        _, coords = _imputation_project(prefix_root, dev, precision="float32")
        ggd, emb, sc, _, _ = _serve(torch, coords, b, device=dev)
        sides[dev] = (coords, ggd, emb, sc)
    copy_err = {}
    for key in PUBLIC_KEYS:
        (c_co, c_ggd, c_emb, c_sc), (p_co, p_ggd, p_emb, p_sc) = sides["cuda"], sides["cpu"]
        pairs = (("table", c_co._tables[key], p_co._tables[key]),
                 ("scaled frame", get_dt(c_ggd[3]._scaled_frames, key), get_dt(p_ggd[3]._scaled_frames, key)),
                 ("embeddings", c_emb[key], p_emb[key]), ("soft counts", c_sc[key], p_sc[key]))
        for name, got, want in pairs:
            if not np.array_equal(np.isnan(got), np.isnan(want)):
                _fail(f"imputation copy {key} {name}: NaN patterns differ card vs CPU")
            ok = ~np.isnan(want)
            copy_err[f"{key} {name}"] = float(np.abs(got[ok] - want[ok]).max()) / max(
                1.0, float(np.abs(want[ok]).max()))
    copy_s = time.perf_counter() - t0
    _log(f"imputation copy of {PREFIX} frames, card vs CPU plain: {copy_err} (tol {PATH_RTOL:.0e}, scaled "
         f"frames {IMPUTED_FRAME_RTOL:.0e})")
    if any(not err <= (IMPUTED_FRAME_RTOL if "scaled" in name else PATH_RTOL) for name, err in copy_err.items()):
        _fail(f"card and CPU disagree on the imputation copy: {copy_err}")

    # Path A at full width: the partial create of the same tables, then the
    # full path from a reset of the counts.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, partial = _imputation_project(full_root, "cuda", iterative_imputation="partial")
    partial_s = time.perf_counter() - t0
    _kernel_counts(reset=True)
    steps = {}
    t0 = time.perf_counter()
    with _StepTimer(torch, steps):
        proj, coords = _imputation_project(full_root, "cuda")
    torch.cuda.synchronize()
    create_s = time.perf_counter() - t0
    ggd, emb, sc, serve_s, peak = _serve(torch, coords, bundle)
    launches = {"imputation": _kernel_counts()}
    n_blocks = len(PUBLIC_KEYS) * -(-(PUBLIC_FRAMES - WINDOW + 1) // BLOCK)
    n_animal_blocks = len(PUBLIC_KEYS) * len(ANIMALS)
    want = {"kalman_rts": n_animal_blocks, "window_streams": n_blocks, "gru_scan": 4 * n_blocks,
            "gru_scan_bwd": 0, "hmm_scan": 0}
    if launches["imputation"] != want:
        _fail(f"the imputation path launched {launches['imputation']}, not {want}")
    _check_public_outputs([(emb, sc)], PUBLIC_FRAMES)
    filled = {}
    for key in PUBLIC_KEYS:
        tab, part, pres = coords._tables[key], partial._tables[key], coords._presence[key]
        if tab.shape != (PUBLIC_FRAMES, 28, 2):
            _fail(f"imputed table {key}: shape {tab.shape}")
        for ai, (lo, hi) in enumerate(((0, 14), (14, 28))):
            present = np.asarray(pres[:, ai], bool)
            if not np.isfinite(tab[present, lo:hi]).all() or not np.isnan(tab[~present, lo:hi]).all():
                _fail(f"imputed table {key}, animal {ANIMALS[ai]}: NaN where present or values where absent")
        filled[key] = int(np.isnan(part).sum() - np.isnan(tab).sum())
        if filled[key] <= 0:
            _fail(f"full imputation filled nothing in {key}")
    _log(f"imputation path: create {create_s:.3f} s ({steps}), partial create {partial_s:.3f} s, serve "
         f"{serve_s:.3f} s, launches {launches['imputation']}, samples filled {filled}")

    budgets, budget_launches = _imputation_budgets(torch, coords, bundle)
    launches.update({f"imputation_budgets_{k}": v for k, v in budget_launches.items()})
    item4 = _item4_card_vs_cpu(torch, proj, coords, full_root)
    line = {
        "path": "imputation", "frames": len(PUBLIC_KEYS) * PUBLIC_FRAMES, "recordings": len(PUBLIC_KEYS),
        "create_s": create_s, "imputation_steps_s": steps,
        "imputation_s": sum(steps.values()), "partial_create_s": partial_s, "serve_s": serve_s,
        "peak_mem_gib": peak, "samples_filled": filled, "launches": launches["imputation"],
        "copy_max_rel_err": max(copy_err.values()), "copy_s": copy_s, "kalman": kernel_t,
        "budgets": budgets, "item4": item4, "phase_s": time.perf_counter() - t_phase, "card": card,
    }
    return line, launches, (kernel_err, kernel_rel), kernel_t


# Phase 16: paths mode at a lab's size. Two seeded SLEAP recordings of two
# deepof_14 animals, 375,000 frames each (4 h 10 min at 25 fps): one is past
# config.VERY_LARGE_VIDEO_FRAMES, so create() flags the project very large and
# every table of the main path is stored in files and passed as a pointer.
LONG_KEYS = ("test", "test2")
LONG_FRAMES = 375_000
# get_graph_dataset's default samples_max: each recording's rows are taken
# evenly down to it (the JAX package's and deepof's time-bin rule), so the
# windows trained on and served are those of 227,272 rows a recording.
LONG_ROWS = 227_272
LONG_BIN = dict(bin_size=600, bin_index=0)  # get_time_on_cluster's bin: the first 10 minutes
LONG_WINDOW_STRIDE = 97  # windows compared between modes: every 97th
LONG_NAN_RATE = 0.002  # tracks lost (NaN, likelihood 0) per frame, animal and bodypart
# A window's sticky-HMM label is held where the reference posterior's largest
# entry is at least this (get_contrastive_soft_counts' min_confidence, below
# which it treats a prior row as uniform): another label there needs an entry
# to move by 0.25 or more.
SOFT_CONFIDENT = 0.75


def _long_tracks(frames, seed=3):
    """{key: (frames, 2, 14, 2) float64} SLEAP tracks: each animal a seeded
    random walk, its bodyparts at fixed offsets with 1 px jitter, a few
    tracks lost (NaN) inside the recording."""
    rng = np.random.default_rng(seed)
    out = {}
    for key in LONG_KEYS:
        walk = rng.normal(size=(frames, 2, 1, 2)).cumsum(axis=0) * 0.5 + 300.0
        tracks = walk + rng.normal(scale=15.0, size=(1, 2, 14, 2)) + rng.normal(size=(frames, 2, 14, 2))
        lost = rng.random((frames, 2, 14)) < LONG_NAN_RATE
        # the smoothing's edge fits need tracked first and last frames, in the prefix copy too
        lost[:WINDOW] = lost[PREFIX - WINDOW:PREFIX] = lost[-WINDOW:] = False
        tracks[lost] = np.nan
        out[key] = tracks
    return out


def _write_sleap_project(root, tracks, rows=None):
    """Tables/{key}.npy (the first ``rows`` frames of each recording's
    tracks) and a placeholder video each, under ``root``."""
    os.makedirs(f"{root}/Tables")
    os.makedirs(f"{root}/Videos")
    for key, t in tracks.items():
        np.save(f"{root}/Tables/{key}.npy", t[:rows])
        with open(f"{root}/Videos/{key}.mp4", "wb") as f:
            f.write(b"\x00" * 64)
    return root


def _long_project(root, device, precision="auto"):
    from deepof_tpu_torch.core.graph import connect_mouse
    from deepof_tpu_torch.data import Project

    bodyparts = sorted(connect_mouse(graph_preset="deepof_14").nodes)
    return Project(
        project_path=root, project_name="long", video_path=f"{root}/Videos", table_path=f"{root}/Tables",
        arena="circular-autodetect", video_scale="380 mm", table_format="npy", frame_rate=FPS,
        animal_ids=ANIMALS, rename_bodyparts=bodyparts, precision=precision, device=device,
    ).create(force=True, test=True, verbose=False)


class _StorageIO:
    """Bytes and seconds of paths mode's table writes (``_write_npy``) and
    reads (``_read_pointer``: a pointer's rows read from its maps) while the
    block runs."""

    def __init__(self):
        from deepof_tpu_torch.core import storage

        self.storage, self.originals = storage, (storage._write_npy, storage._read_pointer)
        self.stats = {"written_bytes": 0, "write_s": 0.0, "files_written": 0, "read_bytes": 0, "read_s": 0.0}

    def __enter__(self):
        write, read = self.originals

        def timed_write(path, arr, stamp):
            t0 = time.perf_counter()
            write(path, arr, stamp)
            self.stats["write_s"] += time.perf_counter() - t0
            self.stats["written_bytes"] += int(np.asarray(arr).nbytes)
            self.stats["files_written"] += 1

        def timed_read(entry, rows=None):
            t0 = time.perf_counter()
            out = read(entry, rows)
            self.stats["read_s"] += time.perf_counter() - t0
            if entry["kind"] == "windows":  # its frame read once; the windows are views of it
                self.stats["read_bytes"] += int(self.storage.pointer_map(entry).nbytes)
            else:
                self.stats["read_bytes"] += sum(int(p.nbytes) for p in (out if isinstance(out, tuple) else (out,)))
            return out

        self.storage._write_npy, self.storage._read_pointer = timed_write, timed_read
        return self

    def __exit__(self, *exc):
        self.storage._write_npy, self.storage._read_pointer = self.originals


def _windows_frame(pointer):
    """The scaled frame behind a windows pointer, from the map the pointer
    read it through (its file may have been written again since)."""
    from deepof_tpu_torch.core.storage import pointer_map

    return np.asarray(pointer_map(pointer), np.float64)


def _sampled_windows(part, key):
    from deepof_tpu_torch.core.storage import get_dt, get_dt_rows

    n = int(get_dt(part, key, only_metainfo=True)["num_rows"])
    return get_dt_rows(part, key, np.arange(0, n, LONG_WINDOW_STRIDE))


def _soft_count_parts(soft, other, name) -> dict:
    """How far the sticky-HMM soft counts of slightly different embeddings
    part: the largest and the mean |difference| of their entries (over
    max(1, max |value|)), the windows whose hard label differs, and those
    among the windows where ``soft`` is confident (SOFT_CONFIDENT)."""
    from deepof_tpu_torch.core.storage import get_dt

    got = {k: np.asarray(get_dt(soft, k), np.float64) for k in LONG_KEYS}
    want = {k: np.asarray(get_dt(other, k), np.float64) for k in LONG_KEYS}
    differ = {k: got[k].argmax(1) != want[k].argmax(1) for k in LONG_KEYS}
    sure = {k: got[k].max(1) >= SOFT_CONFIDENT for k in LONG_KEYS}
    return {f"soft_counts_{name}_max": max(_rel_err(got[k], want[k]) for k in LONG_KEYS),
            f"soft_counts_{name}_mean": float(np.mean([np.abs(got[k] - want[k]).mean() for k in LONG_KEYS])),
            f"hard_labels_differing_{name}": sum(int(differ[k].sum()) for k in LONG_KEYS),
            f"windows_{name}": sum(len(want[k]) for k in LONG_KEYS),
            f"hard_labels_differing_{name}_confident": sum(int((differ[k] & sure[k]).sum()) for k in LONG_KEYS),
            f"windows_{name}_confident": sum(int(sure[k].sum()) for k in LONG_KEYS)}


def _check_soft_count_parts(errs, name, what) -> None:
    """Of the windows where the reference posterior is confident
    (SOFT_CONFIDENT), the hard labels of :func:`_soft_count_parts` differ on
    at most GATE_DIFF_MAX. Used where two sets of embeddings about 1e-6
    apart are decoded by one fitted sticky HMM. The labels of all windows
    and the entries are only reported: an HMM posterior is a function of
    the whole sequence, so where two states nearly tie over a stretch,
    such embeddings flip the stretch's label and move its posteriors by
    O(0.1) (0.03-0.11% of 454,496 labels over four fits, paths vs
    in-memory; NVIDIA H100 80GB HBM3, 700.00 W)."""
    differ, n = errs[f"hard_labels_differing_{name}"], errs[f"windows_{name}"]
    c_differ, c_n = errs[f"hard_labels_differing_{name}_confident"], errs[f"windows_{name}_confident"]
    _log(f"{what}: hard labels differing {c_differ} of the {c_n} confident windows (max >= {SOFT_CONFIDENT}, at "
         f"most {GATE_DIFF_MAX:.0e}); all windows {differ} of {n}, entries max {errs[f'soft_counts_{name}_max']:.3e}, "
         f"mean {errs[f'soft_counts_{name}_mean']:.3e} (reported)")
    if not c_differ <= GATE_DIFF_MAX * c_n:
        _fail(f"{what}: {c_differ} of {c_n} confident hard labels differ")


def _report_refit(errs, name, what) -> None:
    """Logs how far two sticky HMMs fitted on embeddings about 1e-6 apart
    decode apart. Not checked: the fit's k-means start and the GMM's EM are
    discontinuous in their rows, so two such fits may settle on different
    states (paths vs in-memory, 454,496 windows: 222-281 hard labels
    differing on some runs, up to 397,563 on others; NVIDIA H100 80GB HBM3,
    700.00 W)."""
    _log(f"{what}, each side's own fit (not checked): hard labels differing {errs[f'hard_labels_differing_{name}']} "
         f"of {errs[f'windows_{name}']}; entries max {errs[f'soft_counts_{name}_max']:.3e}")


def _paths_modes(torch, coords, ggd, bundle, emb, soft):
    """The same project's in-memory mode against paths mode: the default
    call (in memory the fused lane, whose frames, cut to samples_max rows,
    take the float64 general route; in paths mode the getters' lane on the
    float32 device route: scaled
    frames, every LONG_WINDOW_STRIDE-th window, the embeddings of the one
    trained bundle at PATH_RTOL); the sticky-HMM soft counts of paths mode's
    embeddings computed in memory at PATH_RTOL (the pointers' storage); the
    in-memory embeddings decoded by the sticky HMM that paths mode fitted,
    with hard labels differing on at most GATE_DIFF_MAX of the confident
    windows (:func:`_check_soft_count_parts`), and by a fit of their own (only
    reported, :func:`_report_refit`); the tutorial's
    call in both modes (the getters' lane both times): merged tables, scaled
    frames and the sampled windows equal bit for bit. Returns ({check: max
    relative error or count}, {stage: seconds})."""
    from deepof_tpu_torch import posthoc as ph
    from deepof_tpu_torch.core.storage import get_dt
    from deepof_tpu_torch.msm import fit_sticky_hmm, sticky_hmm_posteriors
    from deepof_tpu_torch.train.inference import embedding_per_video

    errs, secs = {}, {}
    t0 = time.perf_counter()
    mem = coords.get_graph_dataset(window_size=WINDOW, test_videos=1, return_as_paths=False)
    secs["memory_graph_dataset"] = time.perf_counter() - t0
    errs["scaled_frames"] = max(_rel_err(_windows_frame(p[k]), get_dt(mem[3]._scaled_frames, k))
                                for p in ggd[0] for k in p)
    errs["windows"] = max(_rel_err(g, w) for p, m in zip(ggd[0], mem[0]) for k in p
                          for g, w in zip(_sampled_windows(p, k), _sampled_windows(m, k)))
    t0 = time.perf_counter()
    m_emb, _ = embedding_per_video(coords, mem[3], bundle, mem[1], global_scaler=mem[4], batch_size=BLOCK)
    secs["memory_embed"] = time.perf_counter() - t0
    errs["embeddings"] = max(_rel_err(emb[k], m_emb[k]) for k in LONG_KEYS)
    del mem
    k_best = get_dt(soft, LONG_KEYS[0], only_metainfo=True)["shape"][1]
    coords._very_large_project = False
    try:
        t0 = time.perf_counter()
        same = ph.get_contrastive_soft_counts(coords, emb, states=k_best)
        refit = ph.get_contrastive_soft_counts(coords, m_emb, states=k_best)
        secs["memory_soft_counts"] = time.perf_counter() - t0
    finally:
        coords._very_large_project = True
    other = sticky_hmm_posteriors(fit_sticky_hmm(emb, states=k_best), m_emb)
    errs["soft_counts_same_embeddings"] = max(_rel_err(get_dt(soft, k), same[k]) for k in LONG_KEYS)
    errs.update(_soft_count_parts(soft, other, "memory_embeddings"))
    errs.update(_soft_count_parts(soft, refit, "memory_embeddings_refit"))

    t0 = time.perf_counter()
    tut_paths = coords.get_graph_dataset(**TUTORIAL)
    secs["tutorial_paths_graph_dataset"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tut_mem = coords.get_graph_dataset(return_as_paths=False, **TUTORIAL)
    secs["tutorial_memory_graph_dataset"] = time.perf_counter() - t0
    unequal = []
    for k in LONG_KEYS:
        if not np.array_equal(get_dt(tut_paths[3], k), get_dt(tut_mem[3], k), equal_nan=True):
            unequal.append(f"merged {k}")
    for p, m in zip(tut_paths[0], tut_mem[0]):
        for k in p:
            if not np.array_equal(_windows_frame(p[k]), get_dt(tut_mem[3]._scaled_frames, k), equal_nan=True):
                unequal.append(f"scaled frame {k}")
            if not all(np.array_equal(g, w, equal_nan=True) and g.dtype == w.dtype
                       for g, w in zip(_sampled_windows(p, k), _sampled_windows(m, k))):
                unequal.append(f"windows {k}")
    errs["tutorial_unequal"] = unequal

    for name in ("scaled_frames", "windows", "embeddings", "soft_counts_same_embeddings"):
        _log(f"paths vs in-memory, {name}: max|diff| / max(1, max|memory|) {errs[name]:.3e} (tol {PATH_RTOL:.0e})")
        if not errs[name] <= PATH_RTOL:
            _fail(f"paths mode and the in-memory mode disagree on {name}: {errs[name]}")
    _check_soft_count_parts(errs, "memory_embeddings", "paths vs in-memory soft counts, each mode's embeddings "
                            "decoded by paths mode's sticky HMM")
    _report_refit(errs, "memory_embeddings_refit", "paths vs in-memory soft counts")
    if unequal:
        _fail(f"the tutorial's call differs between paths mode and the in-memory mode: {unequal}")
    _log(f"tutorial call, paths vs in-memory: merged tables, scaled frames and windows equal bit for bit")
    return errs, secs


def _paths_card_vs_cpu(torch, prefix, bundle, k_best):
    """Card vs CPU (float32 both) on the prefix copy in paths mode
    (``return_as_paths=True``; the copy is not very large): scaled frames,
    the sampled windows and the trained bundle's embeddings at PATH_RTOL;
    the card's soft counts of states=k_best against the CPU's embeddings
    decoded on the CPU by the card's sticky HMM (:func:`_check_soft_count_parts`),
    and against the CPU's own fit (only reported)."""
    from deepof_tpu_torch import posthoc as ph
    from deepof_tpu_torch.core.storage import get_dt
    from deepof_tpu_torch.msm import fit_sticky_hmm, sticky_hmm_posteriors
    from deepof_tpu_torch.train.inference import ModelBundle, embedding_per_video

    sides = {}
    for dev in ("cuda", "cpu"):
        coords = _long_project(prefix, dev, precision="float32")
        ggd = coords.get_graph_dataset(window_size=WINDOW, test_videos=1, return_as_paths=True)
        b = bundle if dev == "cuda" else ModelBundle(copy.deepcopy(bundle.model).to("cpu"), bundle.rebuild_spec)
        emb, _ = embedding_per_video(coords, ggd[3], b, ggd[1], global_scaler=ggd[4], batch_size=BLOCK)
        soft = ph.get_contrastive_soft_counts(coords, emb, states=k_best, device=dev)
        frames = {k: _windows_frame(p[k]) for p in ggd[0] for k in p}
        windows = {k: _sampled_windows(p, k) for p in ggd[0] for k in p}
        sides[dev] = (frames, windows, emb, {k: get_dt(soft, k) for k in soft})
    (cf, cw, ce, cs), (pf, pw, pe, ps) = sides["cuda"], sides["cpu"]
    errs = {"scaled_frames": max(_rel_err(cf[k], pf[k]) for k in LONG_KEYS),
            "windows": max(_rel_err(g, w) for k in LONG_KEYS for g, w in zip(cw[k], pw[k])),
            "embeddings": max(_rel_err(ce[k], pe[k]) for k in LONG_KEYS)}
    for name, err in errs.items():
        _log(f"paths copy ({PREFIX} frames), {name}, card vs CPU: max|diff| / max(1, max|cpu|) {err:.3e} "
             f"(tol {PATH_RTOL:.0e})")
        if not err <= PATH_RTOL:
            _fail(f"card and CPU disagree on the paths copy's {name}: {err}")
    decoded = sticky_hmm_posteriors(fit_sticky_hmm(ce, states=k_best), pe, device="cpu")
    errs.update(_soft_count_parts(cs, decoded, "card_vs_cpu"))
    errs.update(_soft_count_parts(cs, ps, "card_vs_cpu_refit"))
    _check_soft_count_parts(errs, "card_vs_cpu", f"paths copy ({PREFIX} frames) soft counts, card vs the CPU's "
                            "embeddings decoded on the CPU by the card's sticky HMM")
    _report_refit(errs, "card_vs_cpu_refit", f"paths copy ({PREFIX} frames) soft counts, card vs CPU")
    return errs


def _paths_phase(torch, card, tmp, seed=None):
    """Phase 16: a very large project through the main path in paths mode:
    two LONG_FRAMES-frame SLEAP recordings -> create (flags it very large) ->
    get_graph_dataset(window_size=25, test_videos=1) (paths mode by
    default: the getters, merge and preprocess write files, the windows are
    pointers to the scaled frames) -> deep_unsupervised_embedding at its
    default model (one pretrain and one main epoch of TRAIN_BATCHES +
    VAL_BATCHES batches; the windows read into RAM) -> embedding_per_video
    (scaled again, frames written to files, served through the window and
    GRU kernels) -> get_contrastive_soft_counts (the BIC scan, hmm_scan;
    pointers) -> get_time_on_cluster over the first 600 s bin, read from
    the pointers. Each stage timed, the launches counted from a reset, the
    bytes and seconds of the tables written and read, peak device memory and
    the process's peak RSS; then the modes against each other
    (:func:`_paths_modes`) and card vs CPU on the prefix copy. ``seed`` is
    the fit's (default: its own default). Returns (the paths line,
    {"paths": launches})."""
    import resource

    from deepof_tpu_torch import posthoc as ph
    from deepof_tpu_torch.core.storage import TablePointer, get_dt
    from deepof_tpu_torch.core.table_dict import preprocess_time_bins
    from deepof_tpu_torch.train.inference import embedding_per_video

    t_phase = time.perf_counter()
    rss_before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    t0 = time.perf_counter()
    tracks = _long_tracks(LONG_FRAMES)
    full = _write_sleap_project(os.path.join(tmp, "long"), tracks)
    prefix = _write_sleap_project(os.path.join(tmp, "long_prefix"), tracks, PREFIX)
    del tracks
    write_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _kernel_counts(reset=True)
    stages, io = {}, {}
    t0 = time.perf_counter()
    coords = _long_project(full, "cuda")
    stages["create"] = time.perf_counter() - t0
    if not coords._very_large_project:
        _fail("create did not flag two 375,000-frame recordings as a very large project")
    with _StorageIO() as rec:
        t0 = time.perf_counter()
        ggd = coords.get_graph_dataset(window_size=WINDOW, test_videos=1)
        torch.cuda.synchronize()
        stages["graph_dataset"] = time.perf_counter() - t0
    io["graph_dataset"] = rec.stats
    (train, test), meta, adjacency, tab_dict, scaler = ggd
    stored = [v for part in (train, test, tab_dict) for v in part.values()]
    if len(test) != 1 or not all(isinstance(v, TablePointer) for v in stored):
        _fail(f"paths mode stored values that are not pointers: {[type(v).__name__ for v in stored]}")
    with _StorageIO() as rec:
        t0 = time.perf_counter()
        bundle, _, _, summary = coords.deep_unsupervised_embedding(
            ggd[:3], adjacency_matrix=adjacency, batch_size=TRAIN_BATCH, latent_dim=LATENT,
            n_clusters=N_COMPONENTS, epochs=1, pretrain_epochs=1, verbose=False,
            limit_train_batches=TRAIN_BATCHES, limit_val_batches=VAL_BATCHES, seed=seed,
        )
        torch.cuda.synchronize()
        stages["train"] = time.perf_counter() - t0
    io["train"] = rec.stats
    with _StorageIO() as rec:
        t0 = time.perf_counter()
        emb, counts = embedding_per_video(coords, tab_dict, bundle, meta, global_scaler=scaler, batch_size=BLOCK)
        stages["embed"] = time.perf_counter() - t0
    io["embed"] = rec.stats
    launches = _kernel_counts()
    _kernel_counts(reset=True)
    with _StorageIO() as rec:
        t0 = time.perf_counter()
        soft = ph.get_contrastive_soft_counts(coords, emb)
        stages["soft_counts"] = time.perf_counter() - t0
    io["soft_counts"] = rec.stats
    launches["hmm_scan"] = _kernel_counts()["hmm_scan"]
    with _StorageIO() as rec:
        t0 = time.perf_counter()
        bins = preprocess_time_bins(coords, **LONG_BIN)
        toc = ph.get_time_on_cluster(soft, bin_info=bins)
        stages["time_on_cluster"] = time.perf_counter() - t0
    io["time_on_cluster"] = rec.stats
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    rss_after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    _log(f"paths path: stages {stages}, launches {launches}, io {io}, peak {peak_gib:.2f} GiB, peak RSS "
         f"{rss_after:.2f} GiB")

    n_windows = LONG_ROWS - WINDOW + 1
    n_blocks = len(LONG_KEYS) * -(-n_windows // BLOCK)
    want = {"window_streams": n_blocks,
            "gru_scan": 2 * 6 * (TRAIN_BATCHES + VAL_BATCHES) + 4 * -(-n_windows // TRAIN_BATCH) + 4 * n_blocks,
            "gru_scan_bwd": 2 * 6 * TRAIN_BATCHES, "kalman_rts": 0}
    if {k: launches[k] for k in want} != want or launches["hmm_scan"] <= 0:
        _fail(f"the paths path launched {launches}, not {want} and some hmm_scan")
    k_best = get_dt(soft, LONG_KEYS[0], only_metainfo=True)["shape"][1]
    for key in LONG_KEYS:
        sc = get_dt(soft, key)
        if not isinstance(soft[key], TablePointer) or soft[key]["npy_table"] != os.path.join(
                coords._table_path, key, f"{key}_soft_counts"):
            _fail(f"paths soft counts {key}: not a pointer to its table ({soft[key]})")
        if emb[key].shape != (n_windows, LATENT) or counts[key].shape != (n_windows, N_COMPONENTS) or \
                sc.shape != (n_windows, k_best):
            _fail(f"paths {key}: shapes {emb[key].shape}, {counts[key].shape}, {sc.shape}")
        for name, x in (("embeddings", emb[key]), ("soft counts", counts[key]), ("sticky-HMM soft counts", sc)):
            if not np.isfinite(x).all():
                _fail(f"paths {key}: non-finite {name}")
        for name, x in (("soft counts", counts[key]), ("sticky-HMM soft counts", sc)):
            if not np.abs(x.sum(axis=1) - 1.0).max() <= 1e-4:
                _fail(f"paths {key}: {name} rows do not sum to 1")
    bin_rows = LONG_BIN["bin_size"] * int(FPS)
    # time on cluster has a column for each cluster that the bin's frames visit
    if toc.values.shape[0] != len(LONG_KEYS) or not set(toc.columns) <= set(range(k_best)) or not np.allclose(
            toc.values.sum(axis=1), 1.0):
        _fail(f"time on cluster over the paths soft counts: {toc.values.shape}, columns {toc.columns}, rows "
              f"{toc.values.sum(axis=1)}")
    if not all(len(bins[k]) == bin_rows for k in LONG_KEYS):
        _fail(f"the {LONG_BIN} bin holds {[len(bins[k]) for k in LONG_KEYS]} frames, not {bin_rows}")
    if not all(np.isfinite(v) for v in summary.values()):
        _fail(f"paths training losses: {summary}")
    _log(f"paths path: checked; sticky-HMM states {k_best}")

    modes_errs, modes_s = _paths_modes(torch, coords, ggd, bundle, emb, soft)
    del ggd, train, test, tab_dict
    t0 = time.perf_counter()
    copy_errs = _paths_card_vs_cpu(torch, prefix, bundle, k_best)
    copy_s = time.perf_counter() - t0
    table_bytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(coords._table_path) for f in fs)
    line = {
        "path": "paths", "configuration": "long-recordings-2mice-paths", "recordings": len(LONG_KEYS),
        "frames": [LONG_FRAMES] * len(LONG_KEYS), "rows_per_recording": LONG_ROWS,
        "windows_per_recording": n_windows, "very_large_project": True, "stages_s": stages,
        "total_s": sum(stages.values()), "io": io,
        "written_bytes": sum(s["written_bytes"] for s in io.values()),
        "write_s": sum(s["write_s"] for s in io.values()), "read_s": sum(s["read_s"] for s in io.values()),
        "table_dir_bytes": table_bytes, "launches": launches, "sticky_hmm_states": k_best,
        "peak_mem_gib": peak_gib, "peak_rss_gib_before": rss_before, "peak_rss_gib_after": rss_after,
        "fit_batches": [TRAIN_BATCHES, VAL_BATCHES], "losses": summary, "modes": modes_errs,
        "modes_s": modes_s, "card_vs_cpu": copy_errs, "card_vs_cpu_s": copy_s, "write_npy_s": write_s,
        "fit_seed": seed, "phase_s": time.perf_counter() - t_phase, "card": card,
    }
    return line, {"paths": launches}



# Phase 17: the cluster detectors (train_supervised_cluster_detectors ->
# explain_clusters) and the LDA projection (compute_UMAP) on phase 15's
# chunk statistics of the cohort: 10,000 chunks of animal B's kinematics and
# tags, 11 statistics a column, labelled by the served VaDE (K = 10), with
# their bin_info (a fold a recording). numpy's global state is seeded before
# each call that draws from it.
DETECTOR_SEED = 0
# Rows explained by explain_clusters (and its coalition budget, nsamples =
# samples, as the JAX package passes it): the coalition values of
# samples^2 (row, coalition) pairs over a 10-centre background go through
# every tree, so the call's time grows with its square.
DETECTOR_EXPLAIN_SAMPLES = 64
# Card vs CPU from the same host inputs and numpy state, on a drawn copy:
# the chunks of the DETECTOR_COPY_LABELS most frequent labels, at most
# DETECTOR_COPY_PER_GROUP of each (recording, label), and DETECTOR_COPY_COLUMNS
# columns drawn from the statistics (the CPU's plain versions take ~0.1 s a
# round at the full width). predict_proba and the AUCs within DETECTOR_RTOL
# of max(1, |value|); the trees' splits are expected equal (a near tie of
# gains can part them; the count of differing trees is printed).
DETECTOR_COPY_LABELS = 3
DETECTOR_COPY_PER_GROUP = 16
DETECTOR_COPY_COLUMNS = 16
DETECTOR_RTOL = 1e-6
SHAP_SUM_TOL = 1e-6  # each row's Shapley values against f(x) - E f
DETECTOR_MIN_VALUES = 20  # non-NaN values a statistic needs in every fit's chunks
GBM_KERNELS = ("gbm_histograms", "gbm_best_split", "gbm_predict")
# The tree fit's rounds timed by kernel: the share of the rows each task's
# node holds (root: every row; mid and deep: the smaller child of a split
# of 2.5x as many rows, 40 / 60, with the larger sibling's subtraction).
GBM_SHAPES = {"root": 1.0, "mid": 0.10, "deep": 0.01}


def _gbm_counts(reset=False):
    """{kernel: launches since the last reset} of the tree-fit kernels, or
    set their counts to 0."""
    from deepof_tpu_torch.ops import gbm_kernels as gk

    fns = {name: getattr(gk, name) for name in GBM_KERNELS}
    if reset:
        for fn in fns.values():
            fn.launches = 0
    return {name: fn.launches for name, fn in fns.items()}


class _SeededProjection:
    """compute_UMAP's reducer on the card (umap-learn is not installed
    there): rows projected on two seeded Gaussian directions in torch."""

    def __init__(self, torch, seed=0):
        self.torch, self.seed = torch, seed

    def fit_transform(self, x):
        torch = self.torch
        x = torch.as_tensor(np.asarray(x, np.float64), device="cuda")
        g = torch.Generator(device="cuda").manual_seed(self.seed)
        w = torch.randn((x.shape[1], 2), generator=g, device="cuda", dtype=torch.float64)
        return (x @ w).cpu().numpy()


def _gbm_of(pipeline):
    return pipeline.named_steps["classifier"].estimator_


def _splits_of(est):
    """Each tree's (feature, bin, missing side) of its inner nodes, and its
    leaf count."""
    a = est.predictors_
    roots = list(a["roots"]) + [len(a["feature"])]
    out = []
    for lo, hi in zip(roots[:-1], roots[1:]):
        inner = a["is_leaf"][lo:hi] == 0
        out.append((tuple(a["feature"][lo:hi][inner]), tuple(a["bin_threshold"][lo:hi][inner]),
                    tuple(a["missing_left"][lo:hi][inner]), int((~inner).sum())))
    return out


def _detector_checks(name, full, perf, groups, x, y):
    """Folds disjoint and covering every chunk; AUCs in [0, 1] wherever
    sklearn's scorer forms one (a fold's rows hold as many labels as its
    classifier has columns, two for a binary one), NaN exactly elsewhere;
    predict_proba rows summing to 1. Returns the AUC table."""
    n = len(y)
    tests = [np.sort(te) for _, te in groups]
    if not np.array_equal(np.sort(np.concatenate(tests)), np.arange(n)):
        _fail(f"{name}: the folds' test rows do not cover the {n} chunks once")
    for tr, te in groups:
        if np.intersect1d(tr, te).size:
            _fail(f"{name}: a fold shares rows between train and test")
    aucs = {k: [float(v) for v in perf[k]] for k in perf if k.startswith(("test_", "train_"))}
    for i, ((tr, te), est) in enumerate(zip(groups, perf["estimator"])):
        for part, rows in (("test", te), ("train", tr)):
            k_est, k_true = len(est.classes_), len(np.unique(y[rows]))
            defined = k_true == 2 if k_est == 2 else k_true == k_est
            for scorer in ("roc_auc_ovo_weighted", "roc_auc_ovr_weighted"):
                v = aucs[f"{part}_{scorer}"][i]
                if defined != np.isfinite(v) or (defined and not 0.0 <= v <= 1.0):
                    _fail(f"{name}: fold {i} {part} {scorer} = {v} ({k_true} labels in the rows, {k_est} "
                          f"classes fitted)")
    proba = full.predict_proba(x)
    proba = proba.cpu().numpy() if hasattr(proba, "cpu") else proba
    sum_err = float(np.abs(proba.sum(axis=1) - 1.0).max())
    if proba.shape != (n, len(full.classes_)) or not sum_err <= 1e-12:
        _fail(f"{name}: predict_proba {proba.shape}, rows off 1 by {sum_err}")
    return aucs, proba


def _detectors_copy(stats, y, bin_info):
    """The card-vs-CPU copy: the chunks of the most frequent labels, at most
    DETECTOR_COPY_PER_GROUP of each (recording, label) (the first ones), and
    DETECTOR_COPY_COLUMNS seeded columns among those with a value in every
    one of those chunks. Returns (the statistics, labels, bin_info)."""
    from deepof_tpu_torch.posthoc import Labelled

    labels, counts = np.unique(y, return_counts=True)
    keep_labels = labels[np.argsort(-counts, kind="stable")[:DETECTOR_COPY_LABELS]]
    rows, info, start = [], {}, 0
    for key, chunk_ids in bin_info.items():
        idx = np.arange(start, start + len(chunk_ids))
        start += len(chunk_ids)
        picked = np.sort(np.concatenate([idx[y[idx] == lab][:DETECTOR_COPY_PER_GROUP] for lab in keep_labels]))
        if len(picked):  # a recording without those labels is no fold
            rows.append(picked)
            info[key] = np.asarray(chunk_ids)[picked - idx[0]]
    rows = np.concatenate(rows)
    full_columns = np.flatnonzero(~np.isnan(stats.values[rows]).any(axis=0))  # no fold of the copy lacks them
    cols = np.sort(np.random.default_rng(DETECTOR_SEED).choice(
        full_columns, min(DETECTOR_COPY_COLUMNS, len(full_columns)), replace=False))
    values = stats.values[np.ix_(rows, cols)]
    return Labelled(values, list(range(len(rows))), [stats.columns[c] for c in cols]), y[rows], info


def _detectors_card_vs_cpu(stats, y, bin_info):
    """train_supervised_cluster_detectors on the copy, card and CPU (plain
    versions), numpy seeded alike: trees, predict_proba, AUCs."""
    from deepof_tpu_torch import posthoc as ph

    copy, y_copy, info = _detectors_copy(stats, y, bin_info)
    out, secs = {}, {}
    for dev in ("cuda", "cpu"):
        np.random.seed(DETECTOR_SEED)
        t0 = time.perf_counter()
        out[dev] = ph.train_supervised_cluster_detectors(copy, y_copy, info, verbose=0, device=dev)
        secs[dev] = time.perf_counter() - t0
    (c_full, c_perf, _), (p_full, p_perf, _) = out["cuda"], out["cpu"]
    trees = differing = 0
    for c_est, p_est in zip([c_full] + c_perf["estimator"], [p_full] + p_perf["estimator"]):
        a, b = _splits_of(_gbm_of(c_est)), _splits_of(_gbm_of(p_est))
        trees += max(len(a), len(b))
        differing += sum(1 for s, t in zip(a, b) if s != t) + abs(len(a) - len(b))
    rel = 0.0
    for k in c_perf:
        if k.startswith(("test_", "train_")):
            g, w = np.asarray(c_perf[k]), np.asarray(p_perf[k])
            if not np.array_equal(np.isnan(g), np.isnan(w)):
                _fail(f"detectors card vs CPU: {k} NaN on one side only ({g} vs {w})")
            rel = max(rel, float((np.abs(np.nan_to_num(g - w)) / np.maximum(1.0, np.abs(np.nan_to_num(w)))).max()))
    x = copy.values
    for c_est, p_est in zip([c_full] + c_perf["estimator"], [p_full] + p_perf["estimator"]):
        g, w = c_est.predict_proba(x), p_est.predict_proba(x)
        rel = max(rel, float((np.abs(g - w) / np.maximum(1.0, np.abs(w))).max()))
    report = {"chunks": int(len(y_copy)), "columns": int(x.shape[1]), "labels": int(len(np.unique(y_copy))),
              "card_s": secs["cuda"], "cpu_s": secs["cpu"], "trees": trees, "differing_trees": differing,
              "max_rel_err": rel}
    _log(f"detectors card vs CPU on a copy: {report} (tol {DETECTOR_RTOL:.0e})")
    if not rel <= DETECTOR_RTOL:
        _fail(f"card and CPU disagree on the detectors' copy: {report}")
    return report


def _gbm_round(n, f, k, share, seed=DETECTOR_SEED):
    """A seeded round of the tree fit on the host (numpy) at n rows, f
    features and k trees: bins (f, n) uint8 (each feature's count of
    non-missing bins ``nbnm``, 255 but a twelfth few-valued; 2% missing
    values in half the features, ``has_missing``), g / h (k, n) float32, and
    ``rounds``: [(node ids (k, n) int32, tasks (k, 4) int32)] to run in
    order, the last one the round timed. At share 1, the roots (slot t);
    else, in tree t, a parent node of 2.5 x share of the rows (slot k + t)
    first, then its 40 / 60 split: the smaller child's task (slot t) with
    the parent's slot, which becomes the larger child's."""
    rng = np.random.default_rng(seed)
    nbnm = np.full(f, 255, np.int32)
    few = rng.random(f) < 1 / 12
    nbnm[few] = rng.integers(2, 12, int(few.sum()))
    has_missing = rng.random(f) < 0.5
    bins = (rng.random((f, n)) * nbnm[:, None]).astype(np.uint8)
    bins[has_missing[:, None] & (rng.random((f, n)) < 0.02)] = 255
    g = rng.normal(size=(k, n)).astype(np.float32)
    h = rng.uniform(0.01, 0.25, size=(k, n)).astype(np.float32)
    t = np.arange(k)
    tasks = lambda node, slot, parent: np.stack([t, np.full(k, node), slot, parent], 1).astype(np.int32)
    if share >= 1.0:
        rounds = [(np.zeros((k, n), np.int32), tasks(0, t, np.full(k, -1)))]
    else:
        u = rng.random((k, n))
        parent, small = u < 2.5 * share, u < share
        rounds = [(np.where(parent, 1, 2).astype(np.int32), tasks(1, k + t, np.full(k, -1))),
                  (np.where(small, 3, np.where(parent, 4, 2)).astype(np.int32), tasks(3, t, k + t))]
    return {"bins": bins, "g": g, "h": h, "nbnm": nbnm, "has_missing": has_missing, "rounds": rounds}


def _gbm_split_jobs(pool, ids, tasks, n):
    """The split search's jobs after a round (torch CPU tensors): each
    task's node and, with a parent slot, the larger sibling in that slot;
    a root's sums left to the search. Returns (slots, nodes)."""
    import torch

    slots, nodes = [], []
    for tree, node, slot, parent in tasks.tolist():
        if node == 0:
            slots.append(slot)
            nodes.append([n, 0.0, 0.0, 0.0, 1.0])
            continue
        for s_, rows in ((slot, int((ids[tree] == node).sum())), (parent, -1)):
            if s_ < 0:
                continue
            hist = pool[s_, 0]
            rows = rows if rows >= 0 else int(hist[:, 2].sum())
            sg, sh = float(hist[:, 0].sum()), float(hist[:, 1].sum())
            slots.append(s_)
            nodes.append([rows, sg, sh, -sg / (sh + 1e-15), 0.0])
    return torch.tensor(slots, dtype=torch.int32), torch.tensor(nodes, dtype=torch.float64)


def _check_time_gbm_rounds(torch, n, f, k):
    """gbm_histograms and gbm_best_split against their plain versions (the
    CPU's, bit for bit) at each of GBM_SHAPES' seeded rounds of n rows, f
    features and k trees, and timed there: the kernel (CUDA events over 5
    calls; the timed calls subtract from the parents again, the same work),
    its plain version on the card (once) and, for the roots' histograms,
    index_add_ of the same sums; bounds: the tasks' union of rows' bins,
    each task's rows' g and h, the histograms written, a parent's read and
    written (bytes). Returns {kernel: [entry a shape]}."""
    from deepof_tpu_torch.ops import gbm_kernels as gk

    dev = torch.device("cuda")
    out = {"gbm_histograms": [], "gbm_best_split": []}
    for shape, share in GBM_SHAPES.items():
        r = _gbm_round(n, f, k, share)
        bins = torch.zeros((n, gk.padded_width(f)), dtype=torch.uint8, device=dev)
        bins[:, :f] = torch.as_tensor(r["bins"], device=dev).T
        g, h = (torch.as_tensor(r[c], device=dev) for c in ("g", "h"))
        pool = torch.zeros((2 * k, f, gk.N_BINS, 3), dtype=torch.float64, device=dev)
        *setup, (ids_np, tasks_np) = r["rounds"]
        for ids_s, tasks_s in setup:
            gk.gbm_histograms(bins, g, h, torch.as_tensor(ids_s, device=dev), torch.as_tensor(tasks_s, device=dev),
                              pool)
        ids, tasks = torch.as_tensor(ids_np, device=dev), torch.as_tensor(tasks_np, device=dev)
        before = pool.to("cpu", copy=True)
        gk.gbm_histograms(bins, g, h, ids, tasks, pool)
        torch.cuda.synchronize()
        want = gk.gbm_histograms_plain(bins.cpu(), g.cpu(), h.cpu(), ids.cpu(), tasks.cpu(), before.clone())
        equal = torch.equal(pool.cpu(), want)
        err = float((pool.cpu() - want).abs().max())
        ms = _cuda_ms(torch, lambda: gk.gbm_histograms(bins, g, h, ids, tasks, pool), reps=5, warmup=1)
        plain_pool = before.to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gk.gbm_histograms_plain(bins, g, h, ids, tasks, plain_pool)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        member = ids_np == tasks_np[:, 1:2]
        has_parent = tasks_np[:, 3] >= 0
        n_bytes = (int(member.any(0).sum()) * f + int(member.sum()) * 8
                   + int(k + 2 * has_parent.sum()) * f * gk.N_BINS * 24)
        library_ms = None
        if shape == "root":
            flat = (torch.arange(f, device=dev)[:, None] * gk.N_BINS + bins[:, :f].T.long()).flatten()
            target = torch.zeros((f * gk.N_BINS, 3), dtype=torch.float64, device=dev)
            src = torch.stack([g[0].double(), h[0].double(), torch.ones(n, dtype=torch.float64, device=dev)], 1)
            src = src.expand(f, n, 3).reshape(-1, 3)
            library_ms = _cuda_ms(torch, lambda: target.index_add_(0, flat, src), reps=5, warmup=1) * k
            del flat, target, src
        out["gbm_histograms"].append({
            "shape": f"{shape}: bins ({n}, {f}) uint8, g/h ({k}, {n}) float32, {k} tasks of "
                     f"{int(member.sum(1).mean())} rows{', with subtractions' if has_parent.any() else ''}",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": n_bytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
            "library_ms": library_ms, "max_abs_err": 0.0 if equal else max(err, 1e-300)})

        pool = want.to(dev, copy=True)  # the checked state, before the timed calls' subtractions
        slots, nodes = _gbm_split_jobs(want, ids_np, tasks_np, n)
        nbnm = torch.as_tensor(r["nbnm"], device=dev)
        miss = torch.as_tensor(r["has_missing"].astype(np.uint8), device=dev)
        slots_d, nodes_d = slots.to(dev), nodes.to(dev)
        got = gk.gbm_best_split(pool, slots_d, nodes_d, nbnm, miss)
        torch.cuda.synchronize()
        want_s = gk.gbm_best_split_plain(want, slots, nodes, nbnm.cpu(), miss.cpu())
        equal = torch.equal(got.cpu(), want_s)
        err = float((got.cpu() - want_s).abs().max())
        ms = _cuda_ms(torch, lambda: gk.gbm_best_split(pool, slots_d, nodes_d, nbnm, miss), reps=5, warmup=1)
        t0 = time.perf_counter()
        gk.gbm_best_split_plain(pool, slots_d, nodes_d, nbnm, miss)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        n_bytes = len(slots) * (f * gk.N_BINS * 24 + gk.RECORD_WIDTH * 8)
        out["gbm_best_split"].append({
            "shape": f"{shape}: {len(slots)} tasks of ({f}, 256, 3) float64 histograms",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": n_bytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
            "library_ms": None, "max_abs_err": 0.0 if equal else max(err, 1e-300),
            "splits_found": int((want_s[:, 0] > 0).sum())})
        del bins, g, h, pool, plain_pool, ids, tasks
    return out


def _check_gbm_no_split(torch, f, n=30, k=3):
    """Both kernels against their plain versions, bit for bit, at k roots of
    n seeded rows too few to split (under 2 x MIN_SAMPLES_LEAF) over f
    features: every record must be the empty one (gain -1, feature 0, bin 0,
    sums 0), whichever CTA or lane holds no feature."""
    from deepof_tpu_torch.ops import gbm_kernels as gk

    dev = torch.device("cuda")
    r = _gbm_round(n, f, k, 1.0)
    (ids_np, tasks_np), = r["rounds"]
    bins = torch.zeros((n, gk.padded_width(f)), dtype=torch.uint8, device=dev)
    bins[:, :f] = torch.as_tensor(r["bins"], device=dev).T
    g, h = (torch.as_tensor(r[c], device=dev) for c in ("g", "h"))
    ids, tasks = torch.as_tensor(ids_np, device=dev), torch.as_tensor(tasks_np, device=dev)
    pool = torch.zeros((k, f, gk.N_BINS, 3), dtype=torch.float64, device=dev)
    gk.gbm_histograms(bins, g, h, ids, tasks, pool)
    want = gk.gbm_histograms_plain(bins.cpu(), g.cpu(), h.cpu(), ids.cpu(), tasks.cpu(),
                                   torch.zeros(pool.shape, dtype=torch.float64))
    slots, nodes = _gbm_split_jobs(want, ids_np, tasks_np, n)
    nbnm = torch.as_tensor(r["nbnm"], device=dev)
    miss = torch.as_tensor(r["has_missing"].astype(np.uint8), device=dev)
    got = gk.gbm_best_split(pool, slots.to(dev), nodes.to(dev), nbnm, miss).cpu()
    want_s = gk.gbm_best_split_plain(want, slots, nodes, nbnm.cpu(), miss.cpu())
    report = {"features": f, "tasks": k, "rows": n, "histograms_equal": torch.equal(pool.cpu(), want),
              "records_equal": torch.equal(got, want_s), "records": got[:, :4].tolist()}
    _log(f"tree-fit kernels at roots with no split: {report}")
    if not (report["histograms_equal"] and report["records_equal"]) \
            or not bool((want_s[:, 0] == -1).all() and (want_s[:, 1:4] == 0).all()):
        _fail(f"the tree-fit kernels differ from their plain versions where no feature splits: {report}")
    return report


def _check_time_gbm(torch, est, x):
    """Each tree-fit kernel against its plain version, bit for bit, and
    timed: the histograms and the split search at GBM_SHAPES' seeded rounds
    of the full fit's rows, features and trees (``_check_time_gbm_rounds``;
    the line's own numbers are the roots'), the whole ensemble over the
    chunk table (the plain version on the card). Returns ({kernel: line
    entry})."""
    from deepof_tpu_torch.ops import gbm_kernels as gk

    dev = torch.device("cuda")
    n, f, k = est.n_train_, est.n_features_in_, est.n_trees_per_iteration_
    rounds = _check_time_gbm_rounds(torch, n, f, k)
    for width in sorted({f, 37}):  # the fit's features, and fewer than 32 split CTAs
        _check_gbm_no_split(torch, width)
    out = {name: {**entries[0], "at_shapes": entries} for name, entries in rounds.items()}
    out["gbm_histograms"]["library"] = "index_add_ of (g, h, 1) a tree, times K"

    xt = torch.as_tensor(np.asarray(x, np.float64), device=dev).contiguous()
    arrays = est._ensemble.device_arrays(dev)
    base = torch.as_tensor(est._baseline_prediction, device=dev)
    raw = base[None, :].expand(len(xt), k).contiguous()
    got = gk.gbm_predict(xt, *arrays, raw.clone())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = gk.gbm_predict_plain(xt, *arrays, raw.clone())
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    pred_err = float((got - want).abs().max())
    ms = _cuda_ms(torch, lambda: gk.gbm_predict(xt, *arrays, raw.clone()), reps=5, warmup=1)
    n_nodes = int(arrays[0].numel())
    n_bytes = xt.numel() * 8 + 2 * raw.numel() * 8 + n_nodes * 30
    out["gbm_predict"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": n_bytes / PEAK_BYTES * 1e3,
                          "bound_by": "bytes", "library_ms": None, "max_abs_err": pred_err,
                          "shape": f"x {tuple(xt.shape)} float64 through {len(est._ensemble.roots)} trees "
                                   f"({n_nodes} nodes)"}
    _log(f"tree-fit kernels at the full fit's shapes: {out}")
    for name, entry in out.items():
        for at in entry.get("at_shapes", [entry]):
            if at["max_abs_err"] != 0.0:
                _fail(f"{name} differs from its plain version at {at['shape']}: {at['max_abs_err']}")
    return out


def _detectors_phase(torch, card, chunks, emb, labels):
    """Phase 17: the cluster detectors on phase 15's chunk statistics
    (``chunks``: statistics, VaDE labels, bin_info) and the LDA projection
    of the cohort's embeddings ``emb`` by their labels. From a reset of the
    kernels' counts: ``train_supervised_cluster_detectors`` (3 folds and
    the full fit, max_iter 200, early stopping past 10,000 resampled rows),
    ``explain_clusters(samples=DETECTOR_EXPLAIN_SAMPLES)`` and
    ``compute_UMAP`` with a seeded projection; then the full fit again from
    the same numpy state (equal bit for bit), the kernels checked and timed
    at its shapes, and card vs CPU on a drawn copy. Returns (the detectors
    line, the launches)."""
    from deepof_tpu_torch import posthoc as ph

    t_phase = time.perf_counter()
    stats, y, bin_info = chunks
    # A statistic with no value in a fit's rows (the skew of a tag that
    # never fires in a recording) cannot be binned: sklearn raises on it, as
    # the port does, so a user drops it first: every statistic with fewer
    # than DETECTOR_MIN_VALUES values in the chunks or in a fold's training
    # chunks (the fit's stratified 10% validation split could take a
    # sparser one's every value).
    values = np.asarray(stats.values, np.float64)
    present = ~np.isnan(values)
    kept = present.sum(axis=0) >= DETECTOR_MIN_VALUES
    for train, _ in ph.chunk_cv_splitter(values, bin_info):
        kept &= present[train].sum(axis=0) >= DETECTOR_MIN_VALUES
    stats = ph.Labelled(np.ascontiguousarray(values[:, kept]), list(stats.index),
                        [c for c, k in zip(stats.columns, kept) if k])
    x = stats.values
    _log(f"detectors: {len(y)} chunks, {x.shape[1]} of {values.shape[1]} statistics kept, labels "
         f"{np.unique(y, return_counts=True)[1].tolist()}")
    calls_s = {}
    torch.cuda.synchronize()
    _kernel_counts(reset=True)
    _gbm_counts(reset=True)
    np.random.seed(DETECTOR_SEED)
    t0 = time.perf_counter()
    full, perf, groups = ph.train_supervised_cluster_detectors(stats, y, bin_info, verbose=0)
    torch.cuda.synchronize()
    calls_s["train_supervised_cluster_detectors"] = time.perf_counter() - t0
    fit_launches = _gbm_counts()
    _log(f"detectors: train_supervised_cluster_detectors {calls_s['train_supervised_cluster_detectors']:.1f} s, "
         f"fits (rows, iterations) {[(e.n_train_, e.n_iter_) for e in map(_gbm_of, perf['estimator'] + [full])]}")
    fits = [_gbm_of(e) for e in perf["estimator"]] + [_gbm_of(full)]
    n_trees = sum(len(f._ensemble.roots) for f in fits)
    if len(groups) != len(bin_info):
        _fail(f"detectors: {len(groups)} folds for {len(bin_info)} recordings")
    aucs, proba = _detector_checks("detectors", full, perf, groups, x, y)

    np.random.seed(DETECTOR_SEED)
    t0 = time.perf_counter()
    shap_values, explainer, explained = ph.explain_clusters(stats, y, full, samples=DETECTOR_EXPLAIN_SAMPLES)
    torch.cuda.synchronize()
    calls_s["explain_clusters"] = time.perf_counter() - t0
    k = len(full.classes_)
    fx = full.named_steps["classifier"].predict_proba(explained.values)
    if len(shap_values) != k or any(v.shape != explained.values.shape for v in shap_values):
        _fail(f"explain_clusters: {len(shap_values)} arrays of {[v.shape for v in shap_values]}")
    sums = np.stack([v.sum(axis=1) for v in shap_values], 1)
    shap_sum_err = float(np.abs(sums - (fx - np.asarray(explainer.expected_value)[None, :])).max())
    if not shap_sum_err <= SHAP_SUM_TOL:
        _fail(f"explain_clusters: Shapley values off f(x) - E f by {shap_sum_err}")

    t0 = time.perf_counter()
    projected = ph.compute_UMAP(emb, labels, reducer=_SeededProjection(torch))
    torch.cuda.synchronize()
    calls_s["compute_UMAP"] = time.perf_counter() - t0
    if projected.shape != (len(emb), 2) or not np.isfinite(projected).all():
        _fail(f"compute_UMAP: {projected.shape}, finite {np.isfinite(projected).all()}")
    launches = {**_kernel_counts(), **_gbm_counts()}
    for name in GBM_KERNELS:
        if launches[name] <= 0:
            _fail(f"the detectors phase did not launch {name}")

    # The full fit again from the numpy state it saw (the folds' fits drew
    # two seeds each before it): equal trees and probabilities, bit for bit.
    np.random.seed(DETECTOR_SEED)
    for _ in range(2 * len(groups)):
        np.random.randint(np.iinfo(np.uint32).max, dtype="u8")
    again = ph._make_cluster_detector(0)
    t0 = time.perf_counter()
    again.fit(x, y)
    torch.cuda.synchronize()
    calls_s["full_fit_again"] = time.perf_counter() - t0
    _log(f"detectors: calls {calls_s}")
    a, b = _gbm_of(again).predictors_, _gbm_of(full).predictors_
    same = all(np.array_equal(a[f], b[f]) for f in a) and np.array_equal(again.predict_proba(x), proba)
    if not same:
        _fail("two card fits of the full detector differ")
    kernels = _check_time_gbm(torch, _gbm_of(full), x)
    copy = _detectors_card_vs_cpu(stats, y, bin_info)
    n_iter = sum(f.n_iter_ for f in fits)
    line = {
        "path": "detectors", "chunks": int(len(y)), "statistics": int(x.shape[1]),
        "sparse_statistics_dropped": int((~kept).sum()), "labels": int(len(np.unique(y))), "folds": len(groups),
        "fits": [{"rows_resampled": int(f.n_rows_), "train_rows": int(f.n_train_), "n_iter": int(f.n_iter_),
                  "early_stopping": bool(f.do_early_stopping_), "trees": len(f._ensemble.roots),
                  "host_reads": int(f.host_reads_)} for f in fits],
        "aucs": aucs, "calls_s": calls_s, "launches": launches, "fit_launches": fit_launches,
        "launches_per_tree": {name: fit_launches[name] / max(n_trees, 1) for name in GBM_KERNELS},
        "launches_per_iteration": {name: fit_launches[name] / max(n_iter, 1) for name in GBM_KERNELS},
        "host_reads_per_iteration": sum(f.host_reads_ for f in fits) / max(n_iter, 1),
        "explain_samples": DETECTOR_EXPLAIN_SAMPLES, "shap_sum_err": shap_sum_err,
        "umap_rows": int(len(emb)), "two_fits_equal": same, "kernels": kernels, "card_vs_cpu": copy,
        "phase_s": time.perf_counter() - t_phase, "card": card,
    }
    _log(f"detectors: {line}")
    return line, launches


def _unequal_leaves(got, want, where=""):
    """The paths where two nested states (dicts, lists, tensors, numbers)
    differ, tensors compared bit for bit on the CPU."""
    if isinstance(want, dict):
        if set(got) != set(want):
            return [where + "/keys"]
        return [p for k in want for p in _unequal_leaves(got[k], want[k], f"{where}/{k}")]
    if isinstance(want, (list, tuple)):
        if len(got) != len(want):
            return [where + "/len"]
        return [p for i, (g, w) in enumerate(zip(got, want)) for p in _unequal_leaves(g, w, f"{where}/{i}")]
    if hasattr(want, "dtype") and hasattr(want, "cpu"):
        return [] if got.dtype == want.dtype and got.cpu().equal(want.cpu()) else [where]
    return [] if got == want else [where]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from deepof_tpu_torch.ops import cuda_build
    from deepof_tpu_torch.ops.gru_kernels import gru_scan, gru_scan_backward
    from deepof_tpu_torch.ops.window_kernels import window_streams

    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    _log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # Phase 2: build and check the kernels.
    t0 = time.perf_counter()
    logs = cuda_build.build()
    build_s = time.perf_counter() - t0
    _log(f"built {sorted(logs)} in {build_s:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                _log(f"  {name}: {line.strip()}")
    setup = _serving_setup(torch)
    win_err, gru_err = _check_kernels(torch, setup["layout"])
    win_t, gru_t = _time_kernels(torch, setup["layout"])

    # Phase 3: the serving path.
    pos, lik = _synthesize(T_FRAMES, setup["nodes"])

    # Card vs the plain versions on the CPU over a prefix (also the warm-up).
    card_out = _run_path(torch, setup, pos[:PREFIX], lik[:PREFIX], "cuda")
    cpu_out = _run_path(torch, setup, pos[:PREFIX], lik[:PREFIX], "cpu")
    prefix_err = 0.0
    for name, got, want in zip(("scaled frame", "embeddings", "soft counts"), card_out, cpu_out):
        got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
        want = want.numpy() if isinstance(want, torch.Tensor) else want
        err = float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))
        _log(f"prefix of {PREFIX} frames, {name}, card vs CPU plain: max|diff| / max(1, max|cpu|) {err:.3e} (tol {PATH_RTOL:.0e})")
        if not err <= PATH_RTOL:
            _fail(f"card and CPU disagree on the prefix {name}: {err}")
        prefix_err = max(prefix_err, err)

    # Two timed full-length runs. The caching allocator is emptied first, so
    # that what phase 2 left there does not serve the first run: that run
    # pays the cudaMallocs of the path's full-size buffers, as a process
    # embedding one recording does; the second reuses them, as every later
    # recording of a process does. The main path is the second run.
    torch.cuda.empty_cache()
    first_stages, first_run_s, first_mallocs, _, _ = _timed_run(torch, setup, pos, lik)
    torch.cuda.reset_peak_memory_stats()
    window_streams.launches = gru_scan.launches = gru_scan_backward.launches = 0
    stages, total_s, mallocs, emb, sc = _timed_run(torch, setup, pos, lik)
    launches = {"window_streams": window_streams.launches, "gru_scan": gru_scan.launches}
    bwd_launches = gru_scan_backward.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    n_windows = T_FRAMES - WINDOW + 1
    n_blocks = -(-n_windows // BLOCK)
    if launches["window_streams"] != n_blocks:
        _fail(f"the window kernel launched {launches['window_streams']} times for {n_blocks} blocks")
    if emb.shape != (n_windows, LATENT) or sc.shape != (n_windows, N_COMPONENTS):
        _fail(f"shapes {emb.shape}, {sc.shape}")
    if not (np.isfinite(emb).all() and np.isfinite(sc).all()):
        _fail("non-finite embeddings or soft counts")
    sum_err = float(np.abs(sc.sum(axis=1) - 1.0).max())
    if not sum_err <= 1e-4:
        _fail(f"soft counts do not sum to 1 (max |sum - 1| {sum_err})")
    for name, count in launches.items():
        if count <= 0:
            _fail(f"kernel {name} was not launched on the main path")
    if bwd_launches != 0:
        _fail(f"serving launched the GRU backward kernel {bwd_launches} times")
    launches["gru_scan_bwd"] = bwd_launches
    _log(f"main path: embeddings {emb.shape}, soft counts {sc.shape}, launches {launches}")

    # Phases 4-17: the public path, the getters, supervised annotation,
    # training and VaDE on its project, then the cohort, its group
    # comparison, its soft counts and its evaluation (phase 15, run while
    # the cohort is held), the other encoders, VaDE's teacher and
    # checkpoints, full imputation with a project past the device budgets,
    # a very large project in paths mode, and the cluster detectors on
    # phase 15's chunk statistics.
    tmp = tempfile.mkdtemp(prefix="chip_smoke_public_")
    try:
        public_line, public_launches, full, tables = _public_phase(torch, card, tmp)
        getters_line, projects = _getters_phase(torch, card, full, os.path.join(tmp, "prefix"), tables)
        supervised_line = _supervised_phase(torch, card, projects)
        del projects
        data = _training_data(full)
        train_line, bwd_err, bwd_t, train_launches = _training_phase(torch, card, data)
        vade_line, vade_launches = _vade_phase(torch, card, data, os.path.join(tmp, "prefix"))
        cohort_line, cohort_launches, cohort = _cohort_phase(torch, card, tmp)
        posthoc_line, posthoc_launches, tags = _posthoc_phase(torch, card, cohort)
        softcounts_line, softcounts_launches, hmm_res = _softcounts_phase(torch, card, cohort)
        evaluation_line, evaluation_launches, detector_inputs = _evaluation_phase(torch, card, cohort, tags)
        del cohort, tags
        encoders_line, encoders_launches = _encoders_phase(torch, card, data, tmp, tables)
        teacher_line, teacher_launches = _teacher_phase(torch, card, data)
        del data
        imputation_line, imputation_launches, kalman_err, kalman_t = _imputation_phase(torch, card, tmp, tables)
        paths_line, paths_launches = _paths_phase(torch, card, tmp)
        detectors_line, detectors_launches = _detectors_phase(torch, card, *detector_inputs)
        del detector_inputs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    print(card, flush=True)
    print(json.dumps(public_line), flush=True)
    print(json.dumps(getters_line), flush=True)
    print(json.dumps(supervised_line), flush=True)
    print(json.dumps(train_line), flush=True)
    print(json.dumps(vade_line), flush=True)
    print(json.dumps(cohort_line), flush=True)
    print(json.dumps(posthoc_line), flush=True)
    print(json.dumps(softcounts_line), flush=True)
    print(json.dumps(encoders_line), flush=True)
    print(json.dumps(teacher_line), flush=True)
    print(json.dumps(imputation_line), flush=True)
    print(json.dumps(evaluation_line), flush=True)
    print(json.dumps(paths_line), flush=True)
    print(json.dumps(detectors_line), flush=True)
    print(json.dumps({
        "stages_s": stages, "total_s": total_s, "frames_per_s": T_FRAMES / total_s, "cuda_mallocs": mallocs,
        "first_stages_s": first_stages, "first_run_s": first_run_s,
        "first_frames_per_s": T_FRAMES / first_run_s, "first_cuda_mallocs": first_mallocs,
        "frames": T_FRAMES, "peak_mem_gib": peak_gib, "build_s": build_s,
        "prefix_max_rel_err": prefix_err, "card": card,
        "wall_s": time.perf_counter() - t_start,
    }), flush=True)
    # "launches" is the public path's second pass for the serving kernels and
    # the training path for the backward kernel; every path's count is
    # beside it.
    by_path = {name: {"raw_keypoints": launches[name], **{p: c[name] for p, c in public_launches.items()},
                      "training": train_launches[name], **{p: c[name] for p, c in vade_launches.items()},
                      "cohort": cohort_launches[name], "posthoc": posthoc_launches[name],
                      **{f"softcounts_{p}": c[name] for p, c in softcounts_launches.items() if name in c},
                      **{p: c[name] for p, c in encoders_launches.items()}, "teacher": teacher_launches[name],
                      **{p: c[name] for p, c in imputation_launches.items()},
                      "evaluation": evaluation_launches[name], "paths": paths_launches["paths"][name],
                      "detectors": detectors_launches[name]}
               for name in ("window_streams", "gru_scan", "gru_scan_bwd")}
    hmm_abs, hmm_rel, hmm_timed = hmm_res
    kernels = [
        {"name": "window_streams", "route": "cuda",
         "source": "deepof_tpu_torch/csrc/window_gather.cu",
         "replaces": "deepof_tpu/ops/pallas_kernels.py:111",
         "launches": public_launches["public"]["window_streams"], "launches_by_path": by_path["window_streams"],
         "max_abs_err": win_err, **win_t},
        {"name": "gru_scan", "route": "cuda",
         "source": "deepof_tpu_torch/csrc/gru_scan.cu",
         "replaces": "deepof_tpu/ops/pallas_gru.py:100",
         "launches": public_launches["public"]["gru_scan"], "launches_by_path": by_path["gru_scan"],
         "max_abs_err": gru_err, **gru_t[0], "at_shapes": gru_t},
        {"name": "gru_scan_bwd", "route": "cuda",
         "source": "deepof_tpu_torch/csrc/gru_scan_bwd.cu",
         "replaces": "deepof_tpu/models/blocks.py:78 (no TPU kernel: XLA's derivative of flax nn.scan)",
         "launches": train_launches["gru_scan_bwd"], "launches_by_path": by_path["gru_scan_bwd"],
         "max_abs_err": bwd_err[0], "max_rel_err": bwd_err[1], **bwd_t[0], "at_shapes": bwd_t},
        {"name": "hmm_scan", "route": "cuda",
         "source": "deepof_tpu_torch/csrc/hmm_scan.cu",
         "replaces": "deepof_tpu/msm.py:39 (no TPU kernel: XLA's lax.scan of _forward_backward)",
         "launches": softcounts_launches["hmm"]["hmm_scan"],
         "launches_by_path": {**{f"softcounts_{p}": c["hmm_scan"] for p, c in softcounts_launches.items()},
                              "teacher": teacher_launches["hmm_scan"],
                              **{p: c["hmm_scan"] for p, c in imputation_launches.items()},
                              "evaluation": evaluation_launches["hmm_scan"],
                              "paths": paths_launches["paths"]["hmm_scan"],
                              "detectors": detectors_launches["hmm_scan"]},
         "max_abs_err": hmm_abs, "max_rel_err": hmm_rel, **hmm_timed[0], "library_ms": None,
         "at_shapes": hmm_timed},
        {"name": "kalman_rts", "route": "cuda",
         "source": "deepof_tpu_torch/csrc/kalman_rts.cu",
         "replaces": "deepof_tpu/ops/imputation.py:44 (no TPU kernel: XLA's lax.scan of _kalman_rts_1d)",
         "launches": imputation_launches["imputation"]["kalman_rts"],
         "launches_by_path": {**{f"softcounts_{p}": c["kalman_rts"] for p, c in softcounts_launches.items()
                                 if "kalman_rts" in c},
                              **{p: c["kalman_rts"] for p, c in encoders_launches.items()},
                              "teacher": teacher_launches["kalman_rts"],
                              **{p: c["kalman_rts"] for p, c in imputation_launches.items()},
                              "evaluation": evaluation_launches["kalman_rts"],
                              "paths": paths_launches["paths"]["kalman_rts"],
                              "detectors": detectors_launches["kalman_rts"]},
         "max_abs_err": kalman_err[0], "max_rel_err": kalman_err[1], **kalman_t},
    ]
    for name in GBM_KERNELS:
        timed = detectors_line["kernels"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": "deepof_tpu_torch/csrc/gbm.cu",
            "replaces": "deepof_tpu/posthoc.py:932 (no TPU kernel: sklearn's HistGradientBoostingClassifier on "
                        "the host)",
            "launches": detectors_launches[name], "launches_by_path": {"detectors": detectors_launches[name]},
            **timed})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
