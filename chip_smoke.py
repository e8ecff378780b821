#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its seconds; any failure raises and the script
exits non-zero without printing a result:

  1. build    nvcc builds every kernel source under
              src/repro_torch/kernels/csrc for sm_90a (one nvcc per source,
              started together); prints ptxas' report of each kernel
              (registers, stack frame, spills; an embedding_bag_fwd
              kernel with a stack frame fails) and the card's name and
              power limit.
  2. kernels  each CUDA kernel against its plain PyTorch version on the
              card, at the main path's shapes (DLRM-Criteo: 26 tables of
              2^20 x 128 f32, batch 2048, bag 4; interaction (2048, 27,
              128)) and at ragged ones (batch 37, bag 1, mean, D not a
              multiple of 4; embedding_bag_fwd at D 1, 2, 3, 5, 8, 32,
              33, 128 and 132, B 1 and 37, bags 1, 3, 4, 16 and 17, f32
              and bf16 tables 16-, 2- and 4-byte aligned, ids of -1 and
              V; the scatter at D 1, 2, 3, 5, 8, 32, 128 and
              132 over 5 features, walked in groups of 2, at B 1 and 300
              and bags of 1, 4 and 17, with bags whose ids all repeat,
              bags padded by repeating their head id and ids of -1 and V;
              the interaction's backward at B 1, 37 and 2051, (F, D) (2,
              4), (27, 128), (27, 10) and (60, 32), and a feats 4- but not
              16-byte aligned); the forwards also with bf16 inputs (the
              TPU kernels' other dtype): embedding_bag_fwd at the main
              shape, dot_interact_fwd at F 2, 5, 27 and 60, B 1, 37 and
              2051, D 4, 7, 10, 32 and 128, feats 16-, 2- and 4-byte
              aligned. Tolerances: embedding_bag_fwd bitwise (f32 and
              bf16 tables); embedding_bag_bwd rtol 1e-5 / atol 1e-6
              (atomic order varies); dot_interact_fwd/bwd rtol 1e-5 / atol
              1e-4 against f32 cuBLAS with TF32 off, a bf16 out within 2
              bf16 ulps (rtol 2^-7, atol 1e-4). Times each kernel, its
              plain version and one PyTorch library call (device time
              from torch.profiler, from a window that holds every launch
              of the kernel and whose clock reads its reference spins
              within 8% of their CUDA-event time: see time_ms;
              launch-to-launch time from CUDA events), in f32 and, for
              the forwards, in bf16.
  3. model    DLRM forward + loss + backward through the kernels against
              the same model through the plain versions (2^16 rows, same
              parameters and batch): loss rtol 1e-5, each gradient within
              1e-4 of its L2 norm over the samples whose ReLUs agree on
              both paths (see phase_model).
  4. loop     the closed loop at the slice configuration
              (repro_torch.launch.train_dlrm_criteo.run_proc: ProcessPipeline
              + make_train_feed + FeedBackend + InTune, 30 steps, tune every
              2): loss finite, every kernel launched at least once a step.
  5. profile  one train step at the slice configuration under
              torch.profiler: device time by kernel.

The closed loop scored and resumed (slice 11), at the same widths:

  4a. idle_tail  run_proc held by a FrozenPolicy at the allocation the
              tuner served in an earlier run's tail, [2, 1, 1, 7, 1], for
              30 steps: loss finite, the allocation held, every kernel
              launched; each window's produced, consumed, batches, wall,
              settling flag, output queue and idle reading printed (the
              loop phase prints its own beside them).
  5a. train_feed  benchmarks/torch_fig_train_feed.py --model
              dlrm-criteo-1m --smoke --steps 32: the even, static_best
              and intune arms, 32 steps each from the same seeded
              weights; each arm's losses finite and at least one scored
              window, every DLRM kernel launched; prints each arm's tail idle, step
              time, final workers, windows and idle series, and the idle
              reduction against even (report-only at smoke size). The
              intune arm's agent is pretrained (60 episodes of 300 ticks)
              in a process started before the build, on the last core;
              the 7-stage agent the fleet phases need beside it, in a
              process of its own on the core before.
  5b. checkpoint  run_proc with rows cut to 2^16 a table saves at step
              3; a second run_proc resumes with no step left, and its
              parameters, adagrad state and tuner (Q-network, agent steps,
              allocation) are bitwise the first's; a third trains 2 steps
              on, loss finite. The free disk is printed first.

The fleet plane and the public tuning API (slice 13), on the host (the
fleet's trainers are threads and processes, its DQNs run on the CPU;
nothing here touches the card):

  5c. fleet_sim  benchmarks/torch_fig7_fleet.run: FleetSim over
              demo_cluster (4 trainers, pool 80, a join, a shrink and a
              leave) for 1200 ticks under the five fleet policies; fails
              unless the coordinator (fleet_intune) reaches 90% of the
              fleet oracle and 1.3x fleet_even with no OOM at all.
  5d. fleet_live  run_live: LiveFleet over live_demo_cluster (3 trainers
              of real threads, 100 windows of 0.12 s) under fleet_even
              and the coordinator; fails on a coordinator OOM, a dropped
              batch, a thread not joined or left running, or a measured
              intune_vs_even not above 1.0 (fleet_even's OOMs are the
              cluster's designed crash loop, printed).
  5e. api_tune  tune(live_linear_pipeline(), MachineSpec(n_cpus=the
              host's cores), optimizer="oracle", backend="proc") over 8
              windows of 0.3 s, then fleet_even on ProcFleetBackend over
              live_demo_cluster(14) (its churn, at ticks 3, 7, 9 and
              11, paid by relaunch windows),
              ballast off; fails on an OOM, a crash-lost batch, a
              process not joined or left running.

The examples on the card (slice 14):

  5f. quickstart  examples/torch_quickstart.py: the four DLRM kernels
              against their plain versions at the example's shapes (ids
              (256, 8, 1) from the example's own stage functions into
              (8, 4096, 16) f32 tables; the interaction at (256, 9, 16);
              tolerances as in `kernels`) and timed there; parts 1 and 2
              as the example runs them (host only); then part 3: 30
              train steps of the example's DLRM on the card off a live
              ThreadedPipeline while a background Session tunes it for 20
              windows of 0.2 s. Fails on a non-finite loss, a step that
              did not go through each of the four kernels, a thread or
              process not joined or left running, an OOM, or a tuner that
              never moved the pools; prints part 3's seconds, steps/s
              and the workers of every tick.

GraphSAGE minibatch training (slice 2), graphsage-reddit at the
minibatch_lg widths: 1024 seed nodes, fanout 15-10, 602 features,
hidden 128, 47 classes, adam:

  2. kernels  (also) sage_aggregate_fwd and _bwd against their plain
              versions at the three shapes a train step gives them
              (neigh2 (15360, 10, 602) x (602, 128), neigh1 (1024, 15,
              602) x (602, 128), h1 (1024, 15, 128) x (128, 47)) and at
              ragged ones (B 37, F 1, D 5, H 7; H 130 over two column
              tiles; B 4225 with D 33: 32-row tiles, 4-byte copies; B
              1023 at F 15, D 602; F 43; D 300 at H 130; F 44 and 25
              at D 602; a neigh 8- or 4- but not 16-byte aligned, a
              slice of a larger buffer).
              The forward also with neigh and w bf16, or either alone, at
              every load width (16-, 4- and 2-byte loads of bf16) and at
              neigh2, timed there (a bf16 w's widening, sage_widen_w,
              beside w.float() and its bound). Tolerances: the f32
              aggregate (rows padded to a multiple of 4 floats) bitwise;
              out and d_neigh
              rtol 1e-5 / atol 1e-5 against f32 cuBLAS with TF32 off, a
              bf16 out within 2 bf16 ulps; d_w within 1e-5 of max
              |d_w| (a sum over up to 15360 rows in another order); a
              second run, out without the saved aggregate and d_w
              without d_neigh bitwise equal; d_neigh's F copies of a row
              bitwise equal, and d_neigh from d_out and w 4 bytes off a
              16-byte boundary bitwise the same. Timed as above, each shape
              with its share of the bound and its ratio to the library
              call: torch.einsum("bfd,dh->bh") (the sum without the 1/F)
              for the forward and torch.mm(agg^T, d_out) for d_w (at h1,
              where the kernel writes d_neigh too, with (d_out w^T / F)
              broadcast over F and written out beside it;
              sage_dneigh_kernel alone there, read by name, with the
              tile that its plan chose and its store path).
  6. graph    the synthetic graph of minibatch_lg (232,965 nodes,
              114,615,892 edges, 602 random features a node), built once
              from seed 0 and shared by the phases below.
  7. gnn_model  the GraphSAGE loss and every gradient through the
              kernels against the same model through the plain versions,
              same parameters and batch: loss rtol 1e-5, each gradient
              within 1e-4 of its L2 norm over the seeds whose ReLU inputs
              and L2-norm clamps agree on both paths (phase_gnn_model).
  8. gnn_loop  the port's generic driver (repro_torch.launch.train.run)
              for 20 steps with InTune ticking: loss finite,
              sage_aggregate_fwd and _bwd launched at least 3 times a
              step; prints seed nodes/s, the loop step's time split into
              sampling + copy and the train step (host clock,
              synchronised; gnn_profile reads device time) and peak device
              memory.
  9. gnn_profile  one GNN train step under torch.profiler: device time
              by kernel.

wide-deep training (slice 3) at its published widths: 40 sparse features,
embed_dim 32, MLP 1024-512-256, 2^20 rows a table, bags of 4, row-wise
adagrad; the deep tables (40, 2^20, 32) go through embedding_bag_fwd and
the wide arm (40, 2^20) viewed as (40, 2^20, 1) through
embedding_bag_fused_fwd, both with embedding_bag_bwd as their backward:

 10. recsys_kernels  embedding_bag_fused_fwd bit-equal to
              embedding_bag_fwd and to the plain version at the wide
              arm's train shape (ids (65536, 40, 4) of the synthetic Criteo
              stream over (40, 2^20, 1), f32 and bf16), at serve_p99
              (batch 512), at reduced tables (8, 512, 8) and others with
              f32 and bf16 tables (bf16 also 2- and 4-byte aligned), with
              bag 1, bag 16 and mean, and with one out-of-range id (its
              row NaN in both kernels, the rest equal); embedding_bag_fwd
              bitwise and embedding_bag_bwd per feature at rtol 1e-5 /
              atol 1e-6 against their plain
              versions with the train shape's ids, on the wide arm (D = 1)
              and on the deep tables (40, 2^20, 32). Times at the train
              shape: the fused kernel, embedding_bag_fwd, the plain version
              and F.embedding_bag over the flattened (F*V, 1) table with
              offset ids, f32 and bf16, with the bound by 32-byte sectors
              (`sector_bound_ms`: the distinct sectors the gathers touch,
              counted on the card); embedding_bag_bwd at D = 1 (library:
              index_add_);
              and on the deep tables (D = 32) embedding_bag_fwd (library:
              F.embedding_bag over the flattened (F*V, 32) table) and
              embedding_bag_bwd (library: index_add_ into a (F*V, 32)
              gradient), each with its plain version and bound; the
              forward also with bf16 tables.
 11. recsys_model  wide-deep's loss and every gradient at the published
              widths (batch 4096) through the kernels against the plain
              versions, same parameters and batch: loss rtol 1e-5, each
              gradient within 1e-4 of its L2 norm over the samples whose
              ReLU inputs agree on both paths (as phase_model).
 12. recsys_loop  the generic driver (repro_torch.launch.train.run,
              --full --shape train_batch) for 20 steps: loss finite,
              embedding_bag_fused_fwd, embedding_bag_fwd and
              embedding_bag_bwd each launched at least 20 times; prints
              samples/s, the loop step split into batch + copy and the
              train step, peak device memory, the first and last loss.
 13. recsys_profile  one wide-deep train step under torch.profiler:
              device time by kernel, and each embedding kernel's time in
              the step (the forwards' go into their records).

The paper's DLRM at the reference's configuration, dlrm-criteo (slice
8): 26 x 2^22 x 128 bf16 tables, bf16 MLPs, row-wise adagrad, batch
65536, through the generic driver; the two DLRM backward kernels write
bf16 gradients:

 14. dlrm_bf16_bwd  embedding_bag_bwd into a bf16 gradient and
              dot_interact_bwd with bf16 d_out, feats and d_feats against
              their plain versions, at the training shapes (ids (65536,
              26, 1) of the Criteo stream into (26, 2^22, 128); (65536,
              27, 128)) and ragged ones (odd B, D 5, 7, 10 and 12, a
              29-row table whose ids repeat, bags padded by their head
              id, d_out and feats off a 16- or 4-byte boundary). The
              scatter bitwise on rows one bag slot names, else within 2
              bf16 ulps of the sum of its terms' magnitudes a slot plus
              2; the interaction within 2 bf16 ulps (rtol 2^-7, atol
              1e-5); the max ulp errors and the tolerance printed. Timed
              at the training shapes beside the plain version, the bound
              (2-byte gradients) and index_add_ into the bf16 gradient /
              bmm in bf16. The two bf16 forwards at the same training
              shapes: embedding_bag_fwd on a (26, 2^22, 128) bf16 table
              bitwise, dot_interact_fwd within 2 bf16 ulps (rtol 2^-7,
              atol 1e-4); each timed beside its plain version, bound and
              library call (F.embedding_bag; bmm and the triangle's
              gather).
 15. dlrm_model_bf16  the bf16 DLRM (2^16 rows, batch 4096) through the
              kernels against the plain versions: loss rtol 2^-8, each
              bf16 gradient within 2^-6 of its L2 norm over the samples
              whose ReLUs agree (at most 5% flip).
 16. dlrm_driver  repro_torch.launch.train.run("dlrm-criteo", full=True,
              shape=train_batch, steps=10, lr=0.02): loss finite and
              falling, peak device memory under 80 GB, every DLRM kernel
              launched at least 10 times; samples/s and the loop step
              split into batch + copy and the train step; its first five
              losses kept for dist_dlrm.
 17. dlrm_driver_profile  one dlrm-criteo train step under
              torch.profiler: device time by kernel, the four DLRM
              kernels' bf16 launches and time in the step.
 18. dlrm_retrieval  score_candidates at retrieval_cand (1,000,000
              candidates in 25 chunks) on that model, through the kernels
              and the plain versions: within 4 bf16 ulps of the largest
              score; host-clock seconds of each.

The explicit collectives on torch.distributed (slice 16), after the
unsharded model is freed. NCCL takes one rank a device, so the card runs
a world of one rank: every collective call, the process group on CUDA
and the kernel's local-rows mode at full width; a world above one runs
on gloo in the CPU tests:

 18a. dist_kernels  the local-rows mode of embedding_bag_fwd and
              embedding_bag_bwd (launched under embedding_bag_fwd_local
              and embedding_bag_bwd_local) against their plain versions,
              f32 and bf16, at dlrm-criteo's ids (65536, 26, 1): the whole
              (26, 2^22, 128) table as one shard, and its second quarter
              (2^20 rows at row 2^20, about three quarters of the ids
              outside): the forward bitwise (an id outside reads 0), the
              scatter over the in-shard rows by queue 3's atomics notes,
              nothing written elsewhere; the bf16 ones timed beside their
              plain versions, bound and library call.
 18b. dist_collectives  an NCCL process group of one rank (a file
              rendezvous) and psum_tree over it in its three modes on
              tensors of dlrm-criteo's MLP parameters: none bitwise, bf16
              one bf16 rounding, int8 within half a step; each timed.
 18c. dist_dlrm  the driver as --arch dlrm-criteo --full --shape
              train_batch --dist --mesh 1,1 runs it, 5 steps at lr 0.02
              through tp_multifeature_bag: the first loss bitwise the
              dlrm_driver phase's, the others within rtol 1e-3; the
              local-rows kernels and dot_interact's launched each step,
              the unsharded embedding kernels never; samples/s and peak
              memory. Then, before the group ends, the placed retrieval
              (slice 20): score_candidates(mesh=) of 1,000,000
              candidates in 25 chunks through the row-sharded lookup,
              against the unplaced scores of the same model within
              dlrm_retrieval's 4 bf16 ulps of the largest score.

xDeepFM, DIEN and BERT4Rec (slice 9) at their published widths through
the generic driver at train_batch (65536), with the gradients of
SEQ_MICROBATCHES microbatches accumulated before each optimizer step:
xDeepFM's 39 tables (39, 2^20, 10) through embedding_bag_fwd and its
linear arm (39, 2^20) viewed as (39, 2^20, 1) through
embedding_bag_fused_fwd; DIEN's (2^20, 18) and BERT4Rec's (1048592, 64)
item tables gathered as bags of one through embedding_bag_fwd; the
scatter embedding_bag_bwd as the backward of each:

 19. recsys_seq_kernels  at a microbatch's lookups (xDeepFM's tables and
              linear arm, DIEN's history, BERT4Rec's sequence and its
              sampled-softmax candidates, 20 x 128 a sequence):
              embedding_bag_fwd bitwise to its plain version,
              embedding_bag_fused_fwd bitwise to it and to the row
              kernel, embedding_bag_bwd with non-negative d_out within
              rtol max(1e-5, 2 n 2^-24) / atol 1e-6 of its plain version
              on each row n ids name (BERT4Rec's MASK row takes 20 a
              sequence); each timed beside its plain version, its bound
              and its library call (F.embedding_bag over the flattened
              table; index_add_ into the flattened gradient).
 20. <arch>_model  (for each of the three) the loss and every gradient at
              the published widths (batch SEQ_MODEL_BATCH) through the
              kernels against the plain versions: loss rtol 1e-5, each
              gradient within 1e-4 of its L2 norm over the samples whose
              ReLU inputs agree on both paths (as phase_model).
 21. <arch>_driver  repro_torch.launch.train.run(arch, full=True,
              shape=train_batch, microbatches=k) for SEQ_STEPS steps:
              losses finite, peak device memory under the card's, each
              of the path's kernels launched as often as a microbatch
              needs; samples/s, the loop step split into batch + copy and
              the train step.
 22. <arch>_profile  one train step under torch.profiler: device time by
              kernel, the embedding kernels' time in the step.
 23. recsys_retrieval  score_candidates at retrieval_cand (1,000,000
              candidates in 25 chunks) for wide-deep, xDeepFM, DIEN and
              BERT4Rec at their published widths (random weights from a
              seed), through the kernels and through the plain versions:
              the scores finite and within rtol 1e-5 / atol 1e-5 of each
              other; host-clock seconds of each and peak memory.

GraphSAGE's full-graph and batched-small-graph regimes (slice 12) at the
published widths (2 layers, hidden 128, 47 classes, mean, adam): the
aggregate is the reference's gather and segment sum, in plain PyTorch
(models/segment.py, chunked), as the JAX package computes it in XLA;
no kernel of the port runs on these paths:

 9a. gnn_full_model  full_graph_sm (the whole Cora-sized graph, 2,708
              nodes, 1,433 features) and a molecule batch (128 graphs of
              up to 30 nodes): loss and every gradient on the card
              against the same model on the CPU, same parameters and
              numpy batch: loss rtol 1e-5, each gradient within 1e-4 of
              its L2 norm over the rows no ReLU or norm-clamp flip
              reaches (_check_full_model); the max aggregator's forward
              at full_graph_sm within rtol 1e-5 / atol 1e-6, NaN and inf
              in the same places.
 9b. gnn_full_graph  ogb_products (2,449,029 nodes, 61,859,140 edges, 100
              features): the graph's host build time; layer 1's chunked
              aggregate against one index_add_ over every edge at once
              (rtol 1e-5 / atol 1e-6); 10 full-batch steps of the generic
              driver: loss finite and falling, labelled nodes/s, the
              step's seconds, peak device memory under one (E, 128) f32
              message tensor (31.67 GB); one train step profiled.
 9c. gnn_molecule  the generic driver at molecule for 20 steps: loss
              finite, graphs/s, peak memory.

The LLM family (slice 15), the kernel benchmark and the roofline, last
(no kernel of the `kernels` line lies on the LM path, which runs in
plain PyTorch as the JAX package's runs in jnp):

 10. lm_attention  chunked_attention's forward and dq, dk, dv against
              naive S x S attention on the card in f32 with TF32 off
              (GQA 8/2 with a window of 700 and softcap 50 at S 2000,
              MHA at S 3000; KV tails of 464 and 184 past whole chunks),
              decode_attention against the naive rows: each within 1e-4
              of its max |value|; the attention's forward and backward
              ms at gemma2-2b's train shape in bf16.
 11. lm_train_<arch>  the generic driver at --full --shape train_4k:
              smollm-135m at batch 8, gemma2-2b at batch 4 in 4
              microbatches (LM_TRAIN), a few steps: losses finite, the
              last two's mean under the first, tokens/s, peak memory; the
              warm step recorded for the roofline. Then lm_profile_<arch>:
              one train step under torch.profiler.
 12. lm_serve_<arch>  gemma2-2b: a timed prefill of 8192 tokens (past its
              4096 window), 16 decode steps at positions 8192-8207, each
              step's logits against the full forward's within a bf16
              tolerance (LM_SERVE); qwen2-moe-a2.7b: a timed prefill of
              4096, 16 decode steps at batch 4, each decode position's
              routing flips against the forward counted over all 24
              layers (a token whose set of top-4 experts differs on some
              layer) and printed, the positions with none held to
              gemma2-2b's bf16 tolerance (failing if no position is free
              of flips), and its decode held to its forward in f32 at its
              published widths, 4 layers deep (LM_SERVE_F32). Tokens/s of
              prefill and decode, and the cuts of prefill_32k and
              decode_32k.
 13. kernels_bench  benchmarks/torch_kernels_bench.py on the card: each
              kernel against its plain version, timed beside it and the
              reference's oracle, with its bound.
 14. roofline  benchmarks/torch_roofline.py over the steps the LM train
              phases and dlrm_driver recorded (build/bench/
              torch_steps.json), at the H100's ceilings.

The LM family on a mesh (slices 17 and 18), before kernels_bench:

 13a. lm_dist  gemma2-2b's placed driver (NCCL, a world of one, --mesh
              1,1) against the unplaced run: losses, peak, tokens/s, a
              profiled step; qwen2-moe-a2.7b's placed prefill and decode
              against the unplaced path. The vocab-sharded lookup,
              `local_rows_take`, launches the take pair,
              embedding_take_fwd_local and embedding_take_bwd_local
              (csrc/embedding_take.cu), each microbatch and each serving
              step, and the bag's local-rows mode never. Then both pairs
              at the LM embedding shapes (LM_EMBED_SHAPES, bf16, the
              whole vocab as one shard): the take's forward bitwise its
              plain version, its scatter with non-negative d_out bitwise
              on rows one slot names, within 1 bf16 ulp plus 2 n 2^-24 of
              a row's sum on a row n slots name, zero elsewhere, and
              bitwise the same over two runs (`_check_take`); each of the
              four timed beside its plain version, its bound and
              F.embedding or index_add_. The take pair also at a
              BERT4Rec-shaped f32 shard (B4R_TAKE: D 64, a rank of a (1,
              4) mesh, a fifth of a microbatch's candidates with the MASK
              id at a tenth of the slots), checked at ranks 1 and 3 (the
              MASK row's), timed at rank 1. Last the byte plan of the
              training runs one card cannot hold on (16, 16).
 13b. dryrun  (slice 20) the dry run's plan against the card: `python -m
              repro_torch.launch.dryrun --mesh 1,1` in two subprocesses
              (fresh interpreters, each with its fake process group,
              started after the last timed LM phase, so that no measured
              phase shares the host's cores with them),
              planning dist_dlrm's run (dlrm-criteo train_batch) and
              lm_dist's (gemma2-2b train_4k, batch 4 in 4 microbatches)
              on meta tensors, while the card, on an NCCL group of one,
              builds the same placed programs (launch/programs.
              build_program) and runs one step of each under the same
              counters (launch/step_analysis). Held: the plan's parameter
              and optimizer-state bytes equal to the sum of numel x
              element_size over the card's placed model and optimizer
              state, its dot FLOPs and kernel launches equal to the
              card's step's, and its peak within DRYRUN_PEAK_BAND of the
              step's torch.cuda.max_memory_allocated.

Launch counts are set to 0 just before each main path (the DLRM loop,
the held loop, the train-feed arms, the checkpoint round trip, the
quickstart's part 3, the GNN loop, the wide-deep loop, the dlrm-criteo
driver, its sharded run, the xDeepFM, DIEN and BERT4Rec drivers) and
read just after it; the `kernels` line
reports each kernel's count from its own path (the DLRM kernels from
the DLRM loop, with `idle_tail_launches`, `train_feed_launches` and
`checkpoint_launches` beside, and a `quickstart` sub-record at the
example's shapes with part 3's launches; embedding_bag_fwd and _bwd with
their
wide-deep counts beside too, the DLRM kernels' dlrm-criteo counts in their `dlrm_criteo` sub-records, and the
embedding kernels' counts on each of the three drivers in the
sub-records of that model's lookups: `xdeepfm_tables`,
`xdeepfm_linear`, `dien_hist`, `bert4rec_seq`, `bert4rec_cand`; the
local-rows mode's records, `embedding_bag_fwd_local` and
`embedding_bag_bwd_local`, with dist_dlrm's launches and the quarter
shard's record under `quarter`, and their LM-shape records under `lm`
with lm_dist's launches, 0; the take pair's, `embedding_take_fwd_local`
and `embedding_take_bwd_local`, from lm_dist's placed driver, their
records at gemma2-2b's shape, with qwen2-moe-a2.7b's and BERT4Rec's
under `lm`).

It prints a `kernels` JSON line (each record with the profiler events it
was read from; the forwards with a `bf16` sub-record at the 2048-row
shape, the four DLRM kernels with a `dlrm_criteo` one: bf16 at
dlrm-criteo's training shapes, with the driver's launches and each
kernel's time in its step), the card's name
and power limit, and as its last line `{"ok": true, "device": {...}}`.
It needs one CUDA card and exits 2 when there is none. It runs from the
root of the repository, whose kernel sources it builds: a copy of the
script elsewhere prints that src/repro_torch is missing and exits 2.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import threading
import time
from types import SimpleNamespace
from typing import NamedTuple

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# NVIDIA H100 SXM data sheet: HBM3 rate and f32 (non-tensor-core) peak
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# a bf16 output (dot_interact_fwd, sage_aggregate_fwd) against its plain
# version: within 2 bf16 ulps (two roundings of f32 sums taken in another
# order), with the atol of the f32 check for sums that cancel
BF16_RTOL = 2.0 ** -7

# the closed loop's steps: 30 (15 tuning windows), cut from 40 to make
# room for the distribution phases
STEPS = 30
TUNE_EVERY = 2
# the closed loop held at the allocation InTune served in the tail of an
# earlier run, where its windows read idle 1.0 (PERF.md §5)
IDLE_TAIL_WORKERS = (2, 1, 1, 7, 1)
IDLE_TAIL_STEPS = 30
# the checkpoint round trip: the slice configuration's widths with its
# rows cut to 2^16 a table (0.87 GB of tables, as much adagrad state)
CKPT_ROWS = 1 << 16
CKPT_STEPS = 4
GNN_STEPS = 20

RECSYS_STEPS = 20

# the reference DLRM through the generic driver: 10 steps at lr 0.02 (the
# rate of the closed loop's adagrad: at the driver's default 1e-3 under its
# 100-step warmup, 20 steps move the bf16 weights by less than their
# rounding, and the loss does not leave the batch-to-batch noise); its peak
# device memory stays under one H100's 80 GB. 10 steps, cut from 20 to
# make room for the distribution phases: a run on an NVIDIA H100 80GB
# HBM3 at 700.00 W read the first five losses' mean at 0.6596 and steps
# 5-9's at 0.6343
DRIVER_STEPS = 10
DRIVER_LR = 0.02
CARD_BYTES = 80e9
RETRIEVAL_CHUNKS = 25

# xDeepFM, DIEN and BERT4Rec through the generic driver at train_batch:
# SEQ_STEPS steps each, with the fewest microbatches (gradient
# accumulation) whose peak stays under 60 GB, three quarters of the card
# (PERF.md, on an NVIDIA H100 80GB HBM3 at 700.00 W: xDeepFM at 1 does not
# fit, at 2 peaks at 47.6 GB; DIEN at 1 at 53.4 GB; BERT4Rec at 4 at 71.5
# GB, at 8 at 36.7 GB); the model checks at a small batch. 3 steps, cut
# from 5 to make room for the distribution phases: BERT4Rec's host batch
# making takes about 3 s a step (PERF.md)
SEQ_STEPS = 3
SEQ_MICROBATCHES = {"xdeepfm": 2, "dien": 1, "bert4rec": 8}
SEQ_MODEL_BATCH = {"xdeepfm": 2048, "dien": 2048, "bert4rec": 512}

DLRM_KERNELS = ("embedding_bag_fwd", "embedding_bag_bwd", "dot_interact_fwd",
                "dot_interact_bwd")
GNN_KERNELS = ("sage_aggregate_fwd", "sage_aggregate_bwd")
RECSYS_KERNELS = ("embedding_bag_fused_fwd", "embedding_bag_fwd",
                  "embedding_bag_bwd")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def bound_ms(n_bytes: float, flops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cost_bound(kernel: str, *args, **kw):
    """bound_ms of a kernel's work by its formula in
    repro_torch.kernels.costs (`kernel` names it), the one the dry run's
    plans and step_analysis report: its bytes and its operations."""
    from repro_torch.kernels import costs
    c = getattr(costs, kernel)(*args, **kw)
    return bound_ms(c.bytes, c.ops)


# Late in a long process torch.profiler has recorded only 15 of 20
# launches of a kernel in a window, the missing ones at one end of it,
# whatever the window's length or a wait before and after it (H100, this
# script's recsys phase). So each window opens and closes with a few
# launches of a short spin kernel of PyTorch's (torch.cuda._sleep), left
# out of every sum, and a window that still holds too few events of the
# kernel under test is taken again.
SENTINEL = "spin_kernel"

# A window can also hold every launch and read every one short: one
# window of xDeepFM's embedding_bag_fwd read all 20 launches at 34.5-35.2
# us where the other windows of the same call read 72.0-74.7 us, and its
# short sentinels by the same factor, 0.47 (10.38 us for 16 against
# 21.73-21.93); another read both at 0.88 (H100; PERF.md §6). The window's
# timestamps ran at a wrong rate, not the kernel: CUDA events around the
# same calls read 0.077 ms. So each window also opens and closes with one
# reference spin of REF_CYCLES, timed beforehand by CUDA events
# (`spin_ms`), and a window that reads either of them more than CLOCK_TOL
# off that time is refused as a short window is. Windows that read right
# put the spin at 0.942-1.033 of its CUDA-event time, median 0.981 (the
# events' own cost), over 320 windows with and without 12 busy host
# processes (kernel_probes.py profiler); the tolerance takes them and
# refuses the 0.47 and 0.88 windows. Each window also waits PAD_S on the
# host at either end: without the wait, three windows in a row once lost
# 3, 10 and all 20 launches; with it, a window that lost launches lost 2
# or 3, at one end, and the next held all. Taking up to WINDOW_TRIES
# windows, not 3, leaves room for the windows the clock refuses; each one
# taken meets every check.
REF_CYCLES = 400_000        # about 0.2 ms at the H100's clock
CLOCK_TOL = 0.08
PAD_S = 0.05
WINDOW_TRIES = 5


def settle(attempt: int = 0):
    """The sentinel launches at either end of a profiled window, on an
    idle card, after PAD_S of host time: the reference spin, then the
    short ones."""
    import torch
    torch.cuda.synchronize()
    time.sleep(PAD_S)
    torch.cuda._sleep(REF_CYCLES)
    for _ in range(8 * (1 + attempt)):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def spin_ms() -> float:
    """The device time of one reference spin, torch.cuda._sleep(
    REF_CYCLES), from CUDA events around it while a spin twice as long
    holds the card (the spin is queued before the first event fires, so
    the events bracket it and not its launch): the least of 3."""
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    best = math.inf
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda._sleep(2 * REF_CYCLES)
        start.record()
        torch.cuda._sleep(REF_CYCLES)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def window_clock(prof, ref_ms: float):
    """The window's reading of its reference spins over their CUDA-event
    time (`spin_ms`): (least, largest) ratio of the two, or None if the
    profiler recorded neither."""
    spins = sorted(((e.time_range.end - e.time_range.start) / 1e3
                    for e in prof.events()
                    if SENTINEL in e.name and e.device_type.name == "CUDA"),
                   reverse=True)[:2]
    # the reference spins are the window's two longest; a short sentinel
    # is 1000 cycles
    spins = [ms for ms in spins if ms > ref_ms / 4]
    return (min(spins) / ref_ms, max(spins) / ref_ms) if spins else None


def clock_ok(clock) -> bool:
    return clock is not None and 1 - CLOCK_TOL <= clock[0] \
        and clock[1] <= 1 + CLOCK_TOL


class Timing(NamedTuple):
    ms: float         # device time a call (torch.profiler)
    wall: float       # launch to launch a call (CUDA events)
    events: int       # device events of the kernel under test (or of the
                      # call) in the profiled window
    clock: tuple = None   # the window's reading of its reference spins
                          # over their CUDA-event time (least, largest)


def _profiled(fn, args_list, calls: int, attempt: int):
    """(profile, {name: events}, summed device us, clock) of `calls` calls
    cycling through `args_list`, in one torch.profiler window opened and
    closed by the sentinel launches (left out); `clock` is
    `window_clock`'s."""
    from torch.profiler import ProfilerActivity, profile
    ref_ms = spin_ms()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        settle(attempt)
        for i in range(calls):
            fn(*args_list[i % len(args_list)])
        settle(attempt)
    device = [e for e in prof.key_averages()
              if e.self_device_time_total > 0 and SENTINEL not in e.key]
    return (prof, {e.key: e.count for e in device},
            sum(e.self_device_time_total for e in device),
            window_clock(prof, ref_ms))


def time_ms(fn, args_list, iters: int = 20, kernel: str = None) -> Timing:
    """Times `iters` calls, cycling through `args_list` (several input
    sets, so small inputs do not sit in the 50 MB L2). Device ms is the
    summed duration of every kernel, memset and copy the calls put on the
    card (torch.profiler, CUPTI), over `iters`; wall ms is CUDA events
    around the whole run, which for a call shorter than its host-side
    launch cost measures the launch, not the card. The profiled window
    must hold its full count of device events: at least `iters` named
    `kernel`, or, where `kernel` is None (a plain version or a library
    call, which may launch several kernels a call), `iters` times the
    events of one call, counted in windows of one call each (the larger
    count of two, or of up to five while they come back empty). The
    profiler has lost events (a window with none, or with 14 of 20
    launches, whose sum then read low; see SENTINEL), and a short window
    is profiled again; WINDOW_TRIES short ones in a row fail. So is a
    window whose clock reads its reference spins more than CLOCK_TOL off
    their CUDA-event time (`window_clock`)."""
    import torch
    for a in args_list[:2]:
        fn(*a)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    wall = start.elapsed_time(end) / iters
    if kernel is None:
        # at least two windows; more (up to 5, each settled longer) while
        # none has recorded an event: a whole window can come back empty
        per_call = 0
        for attempt in range(5):
            per_call = max(per_call, sum(
                _profiled(fn, args_list, 1, attempt)[1].values()))
            if per_call and attempt:
                break
        if per_call < 1:
            raise RuntimeError("torch.profiler recorded no device event of "
                               "one call in 5 tries")
        need, what = iters * per_call, f"the call ({per_call} a call)"
    else:
        need, what = iters, kernel
    for attempt in range(WINDOW_TRIES):
        prof, counts, device_us, clock = _profiled(fn, args_list, iters,
                                                   attempt)
        events = sum(n for k, n in counts.items()
                     if kernel is None or kernel in k)
        if events >= need and clock_ok(clock):
            return Timing(device_us / 1e3 / iters, wall, events, clock)
        if events >= need:
            print(f"  torch.profiler read {device_us / 1e3 / iters:.4f} ms "
                  f"a call of {what} from a window with all {events} events "
                  f"whose clock read its reference spins at {clock} of "
                  f"their CUDA-event time; profiling again", flush=True)
            continue
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if kernel is not None and kernel in e.name
                       and e.device_type.name == "CUDA")
        span = (f"; the recorded ones span {spans[-1][1] - spans[0][0]:.1f}"
                f" us, {sum(b - a for a, b in spans) / len(spans):.1f} us "
                f"each" if spans else "")
        sentinels = sum(1 for e in prof.events() if SENTINEL in e.name
                        and e.device_type.name == "CUDA")
        print(f"  torch.profiler recorded {events} of {need} events of "
              f"{what} in {iters} calls{span}, {sentinels} of "
              f"{2 * (1 + 8 * (1 + attempt))} sentinels, window clock "
              f"{clock}; profiling again", flush=True)
    raise RuntimeError(f"torch.profiler gave no full window of {what} in "
                       f"{WINDOW_TRIES} tries: each held fewer than {need} "
                       f"events or read its reference spins off")


def named_kernel_ms(fn, args_list, kernel: str, iters: int = 20):
    """(device ms a call, events) of the kernels named `kernel` alone in
    a profiler window of `iters` calls (each call may launch others);
    the window must hold `iters` of them and a clock that reads its
    reference spins right, as `time_ms`'s."""
    for a in args_list[:2]:
        fn(*a)
    for attempt in range(WINDOW_TRIES):
        prof, _, _, clock = _profiled(fn, args_list, iters, attempt)
        ev = [e for e in prof.key_averages()
              if kernel in e.key and e.self_device_time_total > 0]
        n = sum(e.count for e in ev)
        if n >= iters and clock_ok(clock):
            return sum(e.self_device_time_total for e in ev) / 1e3 / iters, n
        print(f"  torch.profiler recorded {n} of {iters} {kernel} events, "
              f"window clock {clock}; profiling again", flush=True)
    raise RuntimeError(f"torch.profiler gave no full window of {kernel} in "
                       f"{WINDOW_TRIES} tries")


def kernel_record(tag, t: Timing, plain: Timing, lib, bound, err,
                  **extra) -> dict:
    """A kernel's record for the `kernels` line, printed: its device time
    and the events it was read from, launch to launch, its plain version's
    and library call's (a Timing, or None) times and the events each was
    read from, its bound, its max abs error."""
    bms, by = bound
    lib_s = "none" if lib is None else f"{lib.ms:.4f}"
    print(f"  {tag}: {t.ms:.4f} ms on the card ({t.events} events, window "
          f"clock {t.clock[0]:.3f}-{t.clock[1]:.3f}), "
          f"{t.wall:.4f} ms launch to launch (plain {plain.ms:.4f}, library "
          f"{lib_s}, bound {bms:.4f} by {by}; {bms / t.ms:.0%} of the "
          f"bound), max abs err {err:.3e}", flush=True)
    return {"ms": t.ms, "wall_ms": t.wall, "events": t.events,
            "window_clock": t.clock,
            "plain_ms": plain.ms, "plain_events": plain.events,
            "library_ms": None if lib is None else lib.ms,
            "library_events": None if lib is None else lib.events,
            "bound_ms": bms, "bound_by": by, "max_abs_err": err, **extra}


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.monotonic()
        print(f"== phase {self.name}", flush=True)

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"== phase {self.name}: {time.monotonic() - self.t0:.1f} s",
                  flush=True)


def ptxas_report(log: str) -> dict:
    """{kernel: (registers, stack frame bytes, spill store bytes, spill
    load bytes)} from nvcc's `-Xptxas -v` output, each kernel by its
    mangled name."""
    import re
    rep, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            rep[name] = [0, 0, 0, 0]
        elif name is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                rep[name][1:] = [int(x) for x in m.groups()]
            m = re.search(r"Used (\d+) registers", line)
            if m:
                rep[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in rep.items()}


def phase_build(strict: bool = True):
    """Builds every kernel source and prints ptxas' report of each kernel
    built; if `strict`, fails if an instantiation of
    embedding_bag_fwd_kernel has a stack frame (its bag's words and sums
    are meant to stay in registers)."""
    from repro_torch.kernels import build
    logs = build.build_all()
    for name, out in sorted(logs.items()):
        for kernel, (regs, stack, st, ld) in ptxas_report(out).items():
            print(f"  [{name}] {kernel}: {regs} registers, {stack} bytes "
                  f"stack frame, {st}/{ld} bytes spill stores/loads")
            if strict and "embedding_bag_fwd_kernel" in kernel and stack:
                raise AssertionError(f"{kernel}: {stack} bytes stack frame")
    print(f"  built {sorted(build.SOURCES)} into {build.build_dir()}")
    print(f"  card: {card_line()}")


def _allclose(name, got, want, rtol, atol) -> float:
    import torch
    got, want = got.detach(), want.detach()
    err = (got.double() - want.double()).abs()
    bad = err > atol + rtol * want.double().abs()
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements off, max "
                             f"abs err {float(err.max()):.3e}")
    return float(err.max()) if err.numel() else 0.0


def _check_bag(tables, ids, combiner, tag) -> dict:
    """Kernel vs plain, forward bitwise and backward allclose, sliced per
    feature so no full-size temporary is made. Returns max abs errors."""
    import torch
    from repro_torch.kernels import embedding_bag as eb, ref
    got = eb.embedding_bag_fwd(tables, ids, combiner)
    want = ref.embedding_bag_ref(tables, ids, combiner=combiner)
    if not torch.equal(got, want):
        raise AssertionError(f"embedding_bag_fwd {tag} {combiner}: not "
                             f"bitwise equal to the plain version")
    d_out = torch.randn_like(got)
    f, v, _ = tables.shape
    g_k = eb.embedding_bag_bwd(d_out, ids, v, combiner)
    g_p = ref.embedding_bag_bwd_ref(d_out, ids, v, combiner=combiner)
    err = max(_allclose(f"embedding_bag_bwd {tag} {combiner} f={i}",
                        g_k[i], g_p[i], 1e-5, 1e-6) for i in range(f))
    return {"embedding_bag_fwd": 0.0, "embedding_bag_bwd": err}


def _ragged_bags(gen):
    """embedding_bag_fwd bitwise against its plain version at D 1, 2, 3,
    5, 6, 8, 10, 18, 32, 33, 34, 128 and 132, B 1 and 37, bags 1, 3, 4,
    16 and 17, sum and mean, f32 tables 16- and 4-byte aligned and bf16
    ones 16-, 2- and 4-byte aligned (a slice 0, 1 or 2 elements into a
    buffer): every load width (the f32 table at +1 element on 4-byte
    words), both walks, lanes from 1 to 32, both unroll bounds and a bag
    walked in chunks. Ids of -1 and V make exactly their own rows NaN,
    the rest equal. Prints the plan of each f32 narrow row (the flat
    walk)."""
    import torch
    from repro_torch.kernels import embedding_bag as eb, ref
    n = 0
    for d in (1, 2, 3, 5, 6, 8, 10, 18, 32, 33, 34, 128, 132):
        f, v = 3, 1000
        buf = torch.randn(f * v * d + 2, device="cuda", generator=gen)
        for dtype, shift in ((torch.float32, 0), (torch.float32, 1),
                             (torch.bfloat16, 0), (torch.bfloat16, 1),
                             (torch.bfloat16, 2)):
            tables = buf.to(dtype)[shift:shift + f * v * d].view(f, v, d)
            plan = eb.fwd_plan(37, f, d, tables.element_size(),
                               tables.data_ptr() % 16)
            if dtype == torch.float32 and plan.lanes == 0:
                print(f"  embedding_bag_fwd ({f},{v},{d}) f32 +{shift} b37: "
                      f"plan {plan}")
            for b in (1, 37):
                for bag in (1, 3, 4, 16, 17):
                    ids = torch.randint(0, v, (b, f, bag), device="cuda",
                                        generator=gen, dtype=torch.int32)
                    tag = (f"({f},{v},{d}) {str(dtype)[6:]} +{shift} b{b} "
                           f"bag{bag}")
                    for combiner in ("sum", "mean"):
                        if not torch.equal(
                                eb.embedding_bag_fwd(tables, ids, combiner),
                                ref.embedding_bag_ref(tables, ids,
                                                      combiner=combiner)):
                            raise AssertionError(f"embedding_bag_fwd {tag} "
                                                 f"{combiner}: not bitwise "
                                                 f"equal to the plain version")
                        n += 1
                    bad = ids.clone()
                    bad[0, 0, 0] = -1
                    bad[b - 1, f - 1, bag - 1] = v
                    got = eb.embedding_bag_fwd(tables, bad)
                    nan = torch.isnan(got).any(-1)
                    want = ref.embedding_bag_ref(tables, ids)
                    if not (bool(torch.isnan(got[nan]).all())
                            and int(nan.sum()) == 2 and nan[0, 0]
                            and nan[b - 1, f - 1]
                            and torch.equal(got[~nan], want[~nan])):
                        raise AssertionError(f"embedding_bag_fwd {tag}: ids "
                                             f"-1 and V must poison exactly "
                                             f"their own rows")
    print(f"  embedding_bag_fwd bitwise to the plain version at {n} ragged "
          f"calls (D 1-132, B 1 and 37, bags 1-17, f32 at 16- and 4-byte "
          f"alignment, bf16 at 16-, 2- and 4-byte); ids -1 and V poison "
          f"their rows")


def _check_dot(feats, tag) -> dict:
    import torch
    from repro_torch.kernels import dot_interact as di, ref
    e_f = _allclose(f"dot_interact_fwd {tag}", di.dot_interact_fwd(feats),
                    ref.dot_interact_ref(feats), 1e-5, 1e-4)
    d_out = torch.randn((feats.shape[0], feats.shape[1]
                         * (feats.shape[1] - 1) // 2), device=feats.device)
    e_b = _allclose(f"dot_interact_bwd {tag}",
                    di.dot_interact_bwd(d_out, feats),
                    ref.dot_interact_bwd_ref(d_out, feats), 1e-5, 1e-4)
    return {"dot_interact_fwd": e_f, "dot_interact_bwd": e_b}


def _ragged_dots_bf16(gen) -> float:
    """dot_interact_fwd with bf16 feats against its plain version (within
    2 bf16 ulps) at F 2, 5, 27 and 60, B 1, 37 and 2051, D odd, 10, 32 and
    128, and feats at an offset of 0, 1 and 2 elements into a larger buffer
    (16-, 2- and 4-byte aligned: 16-byte copies, loads lane by lane,
    4-byte copies). Returns the max abs error."""
    import torch
    from repro_torch.kernels import dot_interact as di, ref
    err = 0.0
    for b, f, d in ((37, 5, 10), (1, 2, 4), (3, 60, 32), (37, 27, 128),
                    (2048 + 3, 27, 128), (37, 27, 7)):
        buf = torch.randn(b * f * d + 2, device="cuda", generator=gen) \
            .to(torch.bfloat16)
        for shift in (0, 1, 2):
            x = buf[shift:shift + b * f * d].view(b, f, d)
            got = di.dot_interact_fwd(x)
            if got.dtype != torch.bfloat16:
                raise AssertionError(f"dot_interact_fwd bf16: out {got.dtype}")
            err = max(err, _allclose(
                f"dot_interact_fwd bf16 ({b},{f},{d}) offset {2 * shift} B",
                got, ref.dot_interact_ref(x), BF16_RTOL, 1e-4))
    return err


def _check_scatter(d_out, ids, v, combiner, tag) -> float:
    """embedding_bag_bwd against its plain version feature by feature at
    rtol 1e-5 / atol 1e-6, any id out of [0, V) adding nothing (the plain
    version sends it to one of two rows past V, which are dropped).
    Returns the max abs error."""
    import torch
    from repro_torch.kernels import embedding_bag as eb, ref
    got = eb.embedding_bag_bwd(d_out, ids, v, combiner)
    ext = torch.where(ids < 0, v + 1, torch.where(ids >= v, v, ids))
    want = ref.embedding_bag_bwd_ref(d_out, ext, v + 2,
                                     combiner=combiner)[:, :v]
    return max(_allclose(f"embedding_bag_bwd {tag} {combiner} f={i}",
                         got[i], want[i], 1e-5, 1e-6)
               for i in range(got.shape[0]))


def _ragged_scatters(gen) -> float:
    """The scatter at every D the models use and around it (the even
    widths 6, 10, 18 and 34 on the flat walk's float2 atomics), over 5
    features (its walk's groups of 2 leave one over), at B 1 and 300 and
    bags of 1, 4 and 17: random ids (with the forward, bitwise), bags
    whose ids all repeat, bags padded by repeating their head id (the
    DLRM featurizer's padding), and ids of -1 and V; at the even widths
    also into a gradient 4-byte aligned (a slice 1 element into a buffer:
    one column a word), whose buffer outside the slice stays 0. The
    repeated ids get non-negative gradients: a row then sums many of
    them, and with signs a nearly cancelling row differs between any two
    orders of f32 atomics by more than atol. Prints the plan of each
    narrow row. Returns the max abs error."""
    import torch
    from repro_torch.kernels import embedding_bag as eb
    dev = torch.device("cuda")
    err = 0.0
    for d in (1, 2, 3, 5, 6, 8, 10, 18, 32, 34, 128, 132):
        f, v = 5, 2 ** 20 // d
        tables = torch.randn((f, v, d), device=dev, generator=gen)
        for b in (1, 300):
            for bag in (1, 4, 17):
                ids = torch.randint(0, v, (b, f, bag), device=dev,
                                    generator=gen, dtype=torch.int32)
                tag = f"({f},{v},{d}) b{b} bag{bag}"
                for combiner in ("sum", "mean"):
                    err = max(err, _check_bag(tables, ids, combiner,
                                              tag)["embedding_bag_bwd"])
                d_out = torch.randn((b, f, d), device=dev,
                                    generator=gen).abs()
                lengths = torch.randint(1, bag + 1, (b, f, 1), device=dev,
                                        generator=gen)
                bad = ids.clone()
                bad[0, f - 1, 0] = -1
                bad[b - 1, 0, bag - 1] = v
                for name, i in (
                        ("repeated", ids[..., :1].expand(b, f, bag)
                         .contiguous()),
                        ("head-padded", torch.where(
                            torch.arange(bag, device=dev) < lengths, ids,
                            ids[..., :1])),
                        ("out of range", bad)):
                    for combiner in ("sum", "mean"):
                        err = max(err, _check_scatter(d_out, i, v, combiner,
                                                      f"{tag} {name}"))
                if d % 4 == 2:
                    err = max(err, _check_scatter_shifted(d_out, bad, v,
                                                          tag))
        if d % 4:
            print(f"  embedding_bag_bwd ({f},{v},{d}) f32 b300: plan "
                  f"{eb.bwd_plan(300, f, v, d)}; +1 element: "
                  f"{eb.bwd_plan(300, f, v, d, 4)}")
    return err


def _check_scatter_shifted(d_out, ids, v, tag) -> float:
    """embedding_bag_scatter (sum and mean) into an f32 gradient 1
    element into a zeroed buffer (4-byte aligned: one column a word on
    the flat walk), ids of -1 and V adding nothing, against the plain
    version at rtol 1e-5 / atol 1e-6; the buffer outside the slice stays
    0. Returns the max abs error."""
    import torch
    from repro_torch.kernels import embedding_bag as eb, ref
    b, f, _ = ids.shape
    d = d_out.shape[-1]
    ext = torch.where(ids < 0, v + 1, torch.where(ids >= v, v, ids))
    err = 0.0
    for combiner in ("sum", "mean"):
        buf = torch.zeros(f * v * d + 1, device=d_out.device)
        grad = buf[1:].view(f, v, d)
        if eb.bwd_plan(b, f, v, d, grad.data_ptr() % 16).vec != 1:
            raise AssertionError(f"embedding_bag_bwd {tag}: a 4-byte aligned "
                                 f"gradient must take one column a word")
        eb.embedding_bag_scatter(d_out, ids, grad, combiner)
        if bool(buf[0] != 0):
            raise AssertionError(f"embedding_bag_bwd {tag} +1 element: "
                                 f"writes outside its gradient")
        want = ref.embedding_bag_bwd_ref(d_out, ext, v + 2,
                                         combiner=combiner)[:, :v]
        err = max(err, max(_allclose(
            f"embedding_bag_bwd {tag} +1 element {combiner} f={i}", grad[i],
            want[i], 1e-5, 1e-6) for i in range(f)))
    return err


def phase_kernels(cfg) -> dict:
    """Every kernel against its plain version, then timed, at the main
    path's shapes. Returns one record per kernel."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.data.featurize import (RecordSpec, featurize_block,
                                            raw_block)
    from repro_torch.kernels import dot_interact as di
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {k: 0.0 for k in ("embedding_bag_fwd", "embedding_bag_bwd",
                             "dot_interact_fwd", "dot_interact_bwd")}

    def note(e):
        for k, v in e.items():
            errs[k] = max(errs[k], v)

    # ragged shapes: batch 37, bag 1 and 3, mean, D not a multiple of 4
    for f, v, d, b, bag in ((3, 1000, 128, 37, 1), (3, 1000, 10, 37, 3),
                            (26, 4096, 128, 37, 4)):
        tables = torch.randn((f, v, d), device=dev, generator=gen)
        ids = torch.randint(0, v, (b, f, bag), device=dev, generator=gen,
                            dtype=torch.int32)
        for combiner in ("sum", "mean"):
            note(_check_bag(tables, ids, combiner, f"({f},{v},{d}) b{b}"))
    _ragged_bags(gen)
    note({"embedding_bag_bwd": _ragged_scatters(gen)})
    for b, f, d in ((37, 5, 10), (37, 27, 128), (1, 2, 4), (3, 60, 32)):
        note(_check_dot(torch.randn((b, f, d), device=dev, generator=gen),
                        f"({b},{f},{d})"))
    # the backward's persistent CTAs at B 1, 37 and 2051, and 4-byte copies
    # from a feats at a 4-byte offset
    for b in (1, 37, 2048 + 3):
        for f, d in ((2, 4), (27, 128), (27, 10), (60, 32)):
            buf = torch.randn(b * f * d + 1, device=dev, generator=gen)
            for shift in (0, 1):
                note(_check_dot(buf[shift:shift + b * f * d].view(b, f, d),
                                f"({b},{f},{d}) offset {4 * shift} B"))
    dot16_err = _ragged_dots_bf16(gen)

    # the main path's shapes: batch from the featurizer, full tables
    n_f, rows, dim = cfg.n_sparse, cfg.vocab_sizes[0], cfg.embed_dim
    rec = RecordSpec(batch=2048, n_sparse=n_f, n_dense=cfg.n_dense,
                     vocab=rows)
    host = featurize_block(raw_block(np.random.RandomState(1), rec), rec)
    ids = torch.as_tensor(host["sparse_ids"]).to(dev)
    b, _, bag = ids.shape
    tables = torch.empty((n_f, rows, dim), device=dev)
    tables.normal_(generator=gen).mul_(dim ** -0.5)
    note(_check_bag(tables, ids, "sum", "main"))
    feats = torch.randn((b, n_f + 1, dim), device=dev, generator=gen)
    note(_check_dot(feats, "main"))
    torch.cuda.empty_cache()

    out = {}
    ids_l = ids.long()
    flat = (ids_l + (torch.arange(n_f, device=dev) * rows)
            .view(1, n_f, 1)).reshape(b * n_f, bag)
    uniq = int(torch.unique(flat).numel())
    table_flat = tables.view(n_f * rows, dim)

    # embedding_bag_fwd
    print(f"  embedding_bag_fwd plan: {eb.fwd_plan(b, n_f, dim)} (f32), "
          f"{eb.fwd_plan(b, n_f, dim, 2)} (bf16)")
    t = time_ms(lambda: eb.embedding_bag_fwd(tables, ids), [()],
                kernel="embedding_bag_fwd_kernel")
    plain = time_ms(lambda: ref.embedding_bag_ref(tables, ids), [()])
    lib = time_ms(lambda: F.embedding_bag(flat, table_flat, mode="sum"),
                  [()])
    out["embedding_bag_fwd"] = kernel_record(
        "embedding_bag_fwd", t, plain, lib,
        cost_bound("bag_fwd", b, n_f, bag, rows, dim, 4, uniq),
        errs["embedding_bag_fwd"])

    # embedding_bag_bwd: the kernel scatter-adds into a zeroed gradient;
    # the zero fill belongs to the gradient's allocation and is timed
    # apart
    d_out = torch.randn((b, n_f, dim), device=dev, generator=gen)
    grad = torch.zeros_like(tables)
    t = time_ms(lambda: eb.embedding_bag_scatter(d_out, ids, grad), [()],
                kernel="embedding_bag_bwd_kernel")
    zero_ms = time_ms(lambda: grad.zero_(), [()], iters=5).ms
    del grad
    plain = time_ms(lambda: ref.embedding_bag_bwd_ref(d_out, ids, rows),
                    [()], iters=5)
    torch.cuda.empty_cache()
    upd = d_out[:, :, None, :].expand(b, n_f, bag, dim).reshape(-1, dim) \
        .contiguous()
    flat1 = flat.reshape(-1)
    grad_flat = torch.zeros((n_f * rows, dim), device=dev)
    lib = time_ms(lambda: grad_flat.index_add_(0, flat1, upd), [()])
    del grad_flat, upd
    out["embedding_bag_bwd"] = kernel_record(
        "embedding_bag_bwd", t, plain, lib,
        cost_bound("bag_bwd", b, n_f, bag, rows, dim, 4, uniq),
        errs["embedding_bag_bwd"], zero_fill_ms=zero_ms)
    del d_out
    torch.cuda.empty_cache()

    # embedding_bag_fwd at the reference's bf16 tables (the same values,
    # rounded): bitwise to the plain version; bound at 2-byte elements
    tables16 = tables.to(torch.bfloat16)
    del tables, table_flat
    torch.cuda.empty_cache()
    if not torch.equal(eb.embedding_bag_fwd(tables16, ids),
                       ref.embedding_bag_ref(tables16, ids)):
        raise AssertionError("embedding_bag_fwd bf16 main: not bitwise "
                             "equal to the plain version")
    flat16 = tables16.view(n_f * rows, dim)
    out["embedding_bag_fwd"]["bf16"] = kernel_record(
        "embedding_bag_fwd bf16",
        time_ms(lambda: eb.embedding_bag_fwd(tables16, ids), [()],
                kernel="embedding_bag_fwd_kernel"),
        time_ms(lambda: ref.embedding_bag_ref(tables16, ids), [()]),
        time_ms(lambda: F.embedding_bag(flat, flat16, mode="sum"), [()]),
        cost_bound("bag_fwd", b, n_f, bag, rows, dim, 2, uniq), 0.0)
    del tables16, flat16
    torch.cuda.empty_cache()

    # dot_interact: three input sets (85 MB) so the feats do not stay in L2
    fs = [(torch.randn((b, n_f + 1, dim), device=dev, generator=gen),)
          for _ in range(3)]
    n_pairs = (n_f + 1) * n_f // 2
    ii, jj = ref.tril_pairs(n_f + 1, dev)
    print(f"  dot_interact_fwd plan: {di.fwd_plan(b, n_f + 1, dim)}")
    out["dot_interact_fwd"] = kernel_record(
        "dot_interact_fwd",
        time_ms(di.dot_interact_fwd, fs, kernel="dot_interact_fwd_kernel"),
        time_ms(ref.dot_interact_ref, fs),
        time_ms(lambda x: torch.bmm(x, x.transpose(1, 2))[:, ii, jj],
                fs),
        cost_bound("dot_fwd", b, n_f + 1, dim, 4), errs["dot_interact_fwd"])
    # bf16 feats: bf16 out within 2 ulps of the plain version's
    fs16 = [(x.to(torch.bfloat16),) for (x,) in fs]
    err16 = max(_allclose("dot_interact_fwd bf16 main",
                          di.dot_interact_fwd(x), ref.dot_interact_ref(x),
                          BF16_RTOL, 1e-4) for (x,) in fs16)
    print(f"  dot_interact_fwd bf16 plan: "
          f"{di.fwd_plan(b, n_f + 1, dim, 2)}")
    out["dot_interact_fwd"]["bf16"] = kernel_record(
        "dot_interact_fwd bf16",
        time_ms(di.dot_interact_fwd, fs16, kernel="dot_interact_fwd_kernel"),
        time_ms(ref.dot_interact_ref, fs16),
        time_ms(lambda x: torch.bmm(x, x.transpose(1, 2))[:, ii, jj],
                fs16),
        cost_bound("dot_fwd", b, n_f + 1, dim, 2), err16)
    out["dot_interact_fwd"]["bf16"]["max_abs_err"] = max(err16, dot16_err)
    del fs16

    gs = [(torch.randn((b, n_pairs), device=dev, generator=gen), x)
          for (x,) in fs]
    sym = []
    for g, x in gs:
        s = torch.zeros((b, n_f + 1, n_f + 1), device=dev)
        s[:, ii, jj] = g
        sym.append((s + s.transpose(1, 2), x))
    out["dot_interact_bwd"] = kernel_record(
        "dot_interact_bwd",
        time_ms(di.dot_interact_bwd, gs, kernel="dot_interact_bwd_kernel"),
        time_ms(ref.dot_interact_bwd_ref, gs),
        time_ms(torch.bmm, sym),
        cost_bound("dot_bwd", b, n_f + 1, dim, 4), errs["dot_interact_bwd"])
    return out


def phase_model(cfg):
    """DLRM loss and gradients through the kernels vs the plain versions
    on the card, same parameters and batch (2^16 rows per table).

    The two paths' activations differ in the last bits (the interaction's
    f32 sums run in another order), so a pre-activation within rounding
    of 0 can take the other side of its ReLU on one path, which moves
    every gradient of that sample by its full size. Such samples are
    found from the recorded pre-activations and given loss weight 0;
    every gradient of the remaining samples' loss must then agree within
    1e-4 of its L2 norm, and the full-batch loss within rtol 1e-5."""
    import numpy as np
    import torch
    from repro_torch.data.featurize import (RecordSpec, featurize_block,
                                            raw_block)
    from repro_torch.kernels import ops, ref
    from repro_torch.models import dlrm as dlrm_lib

    cfg = cfg.replace(vocab_sizes=(1 << 16,) * cfg.n_sparse)
    model = dlrm_lib.init_params(cfg, seed=0, device="cuda")
    rec = RecordSpec(batch=2048, n_sparse=cfg.n_sparse, n_dense=cfg.n_dense,
                     vocab=cfg.vocab_sizes[0])
    batch = {k: torch.as_tensor(v).cuda() for k, v in featurize_block(
        raw_block(np.random.RandomState(2), rec), rec).items()}
    names, params = zip(*model.named_parameters())
    preacts = []
    for lin in list(model.bottom) + list(model.top)[:-1]:
        lin.register_forward_hook(lambda m, i, o: preacts.append(o.detach()))

    def per_sample_loss(**kw):
        z = model(batch, **kw)
        y = batch["label"].float()
        return torch.clamp(z, min=0) - z * y \
            + torch.log1p(torch.exp(-torch.abs(z)))

    ops.reset_launch_counts()
    loss_k = per_sample_loss()
    n_hooked = len(preacts)
    loss_p = per_sample_loss(bag_fn=ref.embedding_bag_ref,
                             interact_fn=ref.dot_interact_ref)
    flips = torch.zeros_like(loss_k, dtype=torch.bool)
    for a, b in zip(preacts[:n_hooked], preacts[n_hooked:]):
        flips |= ((a > 0) != (b > 0)).any(dim=1)
    n_flip = int(flips.sum())
    if n_flip > loss_k.numel() // 100:
        raise AssertionError(f"{n_flip} samples flip a ReLU between the "
                             f"two paths")
    if not bool(torch.isfinite(loss_k).all()):
        raise AssertionError("model loss not finite")
    _allclose("model loss", loss_k.mean(), loss_p.mean(), 1e-5, 0.0)
    keep = (~flips).float() / float((~flips).sum())
    grads_k = torch.autograd.grad((loss_k * keep).sum(), params)
    counts = {k: ops.launch_counts()[k] for k in DLRM_KERNELS}
    if min(counts.values()) < 1:
        raise AssertionError(f"model pass skipped a kernel: {counts}")
    grads_p = torch.autograd.grad((loss_p * keep).sum(), params)
    worst = 0.0
    for n, gk, gp in zip(names, grads_k, grads_p):
        rel = float(torch.linalg.vector_norm(gk - gp)
                    / torch.linalg.vector_norm(gp))
        if not rel <= 1e-4:
            raise AssertionError(f"grad {n}: relative L2 error {rel:.3e}")
        worst = max(worst, rel)
    print(f"  loss kernels {float(loss_k.detach().mean()):.7f} plain "
          f"{float(loss_p.detach().mean()):.7f}; {n_flip} of {loss_k.numel()} "
          f"samples flip a ReLU and are left out of the gradients; "
          f"{len(names)} gradients agree (worst relative L2 error "
          f"{worst:.3e}); launches {counts}")


def phase_loop(cfg) -> dict:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.train_dlrm_criteo import run_proc

    # no checkpoint: one of the slice configuration is about 28 GB
    args = SimpleNamespace(steps=STEPS, batch=2048, tune_every=TUNE_EVERY,
                           finetune_ticks=90, device="cuda", seed=0,
                           ckpt_dir=None, ckpt_every=0)
    ops.reset_launch_counts()
    res = run_proc(args, cfg)
    counts = {k: ops.launch_counts()[k] for k in DLRM_KERNELS}
    if not all(math.isfinite(x) for x in res["losses"]):
        raise AssertionError(f"loss not finite: {res['losses']}")
    short = {k: n for k, n in counts.items() if n < STEPS}
    if short:
        raise AssertionError(f"kernels launched fewer than {STEPS} times "
                             f"on the main path: {short}")
    summary = {k: res[k] for k in ("samples_per_s", "loop_step_s",
                                   "device_step_s", "device_idle_frac",
                                   "workers", "max_memory_allocated",
                                   "teardown")}
    summary["loss_first"], summary["loss_last"] = res["losses"][0], \
        res["losses"][-1]
    summary["device_idle_trace"] = res["device_idle_trace"]
    summary["launches"] = counts
    print("  loop " + json.dumps(summary))
    print_windows("loop", res["windows"])
    torch.cuda.synchronize()
    return counts


def print_windows(tag, windows):
    """Each tuning window's raw readings (FeedBackend): idle is
    1 - min(batches, produced) * device step / wall, so it reads 1.0
    exactly when the pipe delivered nothing in the window."""
    for w in windows:
        print(f"  {tag} window " + json.dumps(w))
    ones = [w for w in windows if w["idle"] >= 1.0]
    print(f"  {tag}: {len(ones)} of {len(windows)} windows read idle 1.0; "
          f"produced in them {[w['produced'] for w in ones]}, batches "
          f"{[w['batches'] for w in ones]}, out queue "
          f"{[w['out_queue'] for w in ones]} at prefetch MB "
          f"{[w['prefetch_mb'] for w in ones]}, settling "
          f"{[w['settling'] for w in ones]}", flush=True)


def phase_idle_tail(cfg) -> dict:
    """The closed loop held by a FrozenPolicy at IDLE_TAIL_WORKERS, the
    tuner's served allocation in the tail of an earlier run (run_proc at
    the slice configuration, IDLE_TAIL_STEPS steps, tune every 2, the
    launch prefetch of 32 MB): loss finite, every DLRM kernel launched;
    prints each window's readings beside the tuned loop's."""
    import numpy as np
    import torch
    from repro_torch.api import FrozenPolicy
    from repro_torch.data.simulator import Allocation
    from repro_torch.kernels import ops
    from repro_torch.launch.train_dlrm_criteo import run_proc

    args = SimpleNamespace(steps=IDLE_TAIL_STEPS, batch=2048,
                           tune_every=TUNE_EVERY, finetune_ticks=90,
                           device="cuda", seed=0, ckpt_dir=None,
                           ckpt_every=0)
    policy = FrozenPolicy(Allocation(np.array(IDLE_TAIL_WORKERS), 32.0))
    ops.reset_launch_counts()
    res = run_proc(args, cfg, policy=policy)
    counts = {k: ops.launch_counts()[k] for k in DLRM_KERNELS}
    if not all(math.isfinite(x) for x in res["losses"]):
        raise AssertionError(f"loss not finite: {res['losses']}")
    short = {k: n for k, n in counts.items() if n < IDLE_TAIL_STEPS}
    if short:
        raise AssertionError(f"kernels launched fewer than "
                             f"{IDLE_TAIL_STEPS} times: {short}")
    held = [w["workers"] for w in res["windows"][1:]]
    if any(w != list(IDLE_TAIL_WORKERS) for w in held):
        raise AssertionError(f"the frozen allocation moved: {held}")
    print(f"  idle_tail at {list(IDLE_TAIL_WORKERS)}: "
          f"{res['samples_per_s']:.1f} samples/s, "
          f"{res['loop_step_s'] * 1e3:.1f} ms a loop step against a "
          f"{res['device_step_s'] * 1e3:.2f} ms device step; launches "
          f"{counts}", flush=True)
    print_windows("idle_tail", res["windows"])
    torch.cuda.synchronize()
    return counts


AGENT_LENGTHS = (5, 7)


def start_agent_pretrain():
    """Pretrains the agents the host phases need
    (benchmarks/torch_common.get_agent_state: 60 episodes of 300 ticks on
    the analytic simulator each, cached under build/agents), one process
    a pipeline length, each on a core of its own at the host's end and
    one thread, while the card runs the phases before train_feed: the
    5-stage agent (train_feed's intune arm, the fleets' linear chains)
    and the 7-stage one (demo_cluster's multi-source DAG), side by side,
    so that neither still runs when train_feed measures the host. Each
    prints the seconds it took. Returns {length: process}."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]))
    procs = {}
    for i, n in enumerate(AGENT_LENGTHS):
        core = max((os.cpu_count() or 1) - 1 - i, 0)
        procs[n] = subprocess.Popen(
            [sys.executable, "-c", "import time\n"
             "from benchmarks import torch_common\n"
             "t0 = time.monotonic()\n"
             f"torch_common.get_agent_state({n})\n"
             f"print(f'  r{n} agent cached after "
             "{time.monotonic() - t0:.1f} s', flush=True)"],
            cwd=ROOT, env=env,
            preexec_fn=lambda core=core: os.sched_setaffinity(0, {core}))
    return procs


def wait_agent(procs, n: int, timeout: float = 600.0) -> float:
    """Blocks until the process pretraining the agent for n-stage
    pipelines has cached it; returns the seconds waited."""
    t0 = time.monotonic()
    rc = procs[n].wait(timeout=timeout)
    if rc != 0:
        raise RuntimeError(f"the r{n} agent's pretraining exited {rc}")
    return time.monotonic() - t0


# 32 steps (16 warm, 8 tuning windows), not the benchmark's smoke 80:
# the script's time goes to the dist_* phases; the arms' idle stays
# report-only at smoke size
TRAIN_FEED_STEPS = 32


def phase_train_feed(agent_procs) -> dict:
    """benchmarks/torch_fig_train_feed.py at --model dlrm-criteo-1m
    --smoke --steps TRAIN_FEED_STEPS: the three arms (even, static_best,
    intune) of TRAIN_FEED_STEPS steps each, from the same seeded weights, on the card: every arm's
    loss finite and at least one scored tick, every DLRM kernel launched;
    prints each arm's tail idle, step time, final workers, ticks and idle
    series, and the idle reduction against even (report-only at smoke
    size, as in the reference)."""
    import torch
    from benchmarks import torch_fig_train_feed as tff
    from repro_torch.kernels import ops

    waited = wait_agent(agent_procs, 5)
    print(f"  agent pretrained (waited {waited:.1f} s)", flush=True)
    losses = {}
    ops.reset_launch_counts()
    payload = tff.main(["--model", "dlrm-criteo-1m", "--smoke", "--steps",
                        str(TRAIN_FEED_STEPS)], losses=losses)
    counts = {k: ops.launch_counts()[k] for k in DLRM_KERNELS}
    summary = {k: payload[k] for k in (
        "model", "device", "batch", "steps", "device_step_time_s",
        "idle_reduction_vs_even", "step_time_reduction_vs_even",
        "pass_20pct_bar")}
    summary["arms"] = {}
    for name, arm in payload["arms"].items():
        loss = torch.stack(losses[name]).float().cpu()
        if len(loss) != payload["steps"] or not torch.isfinite(loss).all():
            raise AssertionError(f"train_feed {name}: {len(loss)} losses, "
                                 f"not all finite: {loss.tolist()}")
        if arm["ticks"] < 1:
            raise AssertionError(f"train_feed {name}: no scored tick")
        summary["arms"][name] = dict(
            {k: arm[k] for k in ("idle_frac", "step_time_s", "workers_final",
                                 "ticks", "idle_series", "teardown")},
            loss_first=float(loss[0]), loss_last=float(loss[-1]))
    missing = [k for k, n in counts.items() if n < 1]
    if missing:
        raise AssertionError(f"kernels never launched on the train_feed "
                             f"path: {missing}")
    summary["launches"] = counts
    print("  train_feed " + json.dumps(summary), flush=True)
    return counts


def phase_checkpoint(cfg) -> dict:
    """The launcher's checkpoint round trip on the card, at the slice
    configuration's widths with CKPT_ROWS rows a table (a full-width
    checkpoint is about 28 GB): run_proc saves at step CKPT_STEPS - 1; a
    second run_proc with the same directory and no step left to run
    resumes, and its parameters, adagrad state and tuner state (the
    Q-network's weights, its step count and the allocation) are held
    bitwise against the first run's; a third trains 2 steps on from the
    checkpoint, loss finite."""
    import dataclasses
    import shutil

    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.train_dlrm_criteo import run_proc

    cut = dataclasses.replace(cfg, name=f"{cfg.name}-rows-2^16",
                              vocab_sizes=(CKPT_ROWS,) * cfg.n_sparse)
    d = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    state_gb = 2 * cfg.n_sparse * CKPT_ROWS * cfg.embed_dim * 4 / 1e9
    free_gb = shutil.disk_usage(d).free / 1e9
    print(f"  {cut.name}: rows cut 2^20 -> 2^16 a table, so a checkpoint "
          f"holds about {state_gb:.2f} GB of tables and adagrad state; "
          f"{free_gb:.1f} GB free on the disk of {d}", flush=True)
    if free_gb < 4 * state_gb:
        raise RuntimeError(f"{free_gb:.1f} GB free, under the "
                           f"{4 * state_gb:.1f} GB the round trip writes")
    args = dict(batch=2048, tune_every=TUNE_EVERY, finetune_ticks=90,
                device="cuda", seed=0, ckpt_dir=d, ckpt_every=CKPT_STEPS)
    try:
        ops.reset_launch_counts()
        t0 = time.monotonic()
        first = run_proc(SimpleNamespace(steps=CKPT_STEPS, **args), cut)
        save_s = time.monotonic() - t0
        counts = {k: ops.launch_counts()[k] for k in DLRM_KERNELS}
        short = {k: n for k, n in counts.items() if n < CKPT_STEPS}
        if short:
            raise AssertionError(f"kernels launched fewer than {CKPT_STEPS} "
                                 f"times: {short}")
        t0 = time.monotonic()
        again = run_proc(SimpleNamespace(steps=CKPT_STEPS, **args), cut)
        restore_s = time.monotonic() - t0
        if again["start"] != CKPT_STEPS or again["losses"]:
            raise AssertionError(f"resumed at {again['start']}, not "
                                 f"{CKPT_STEPS}")
        named = dict(again["model"].named_parameters())
        bad = [k for k, p in first["model"].named_parameters()
               if not torch.equal(p, named[k])]
        bad += [f"acc/{k}" for k, a in first["opt_state"]["acc"].items()
                if not torch.equal(a, again["opt_state"]["acc"][k])]
        st1, st2 = first["tuner"].state_dict(), again["tuner"].state_dict()
        bad += [f"qnet/{layer}/{k}" for layer, p in st1["agent"]["qnet"].items()
                for k, v in p.items()
                if not np.array_equal(v, st2["agent"]["qnet"][layer][k])]
        bad += [k for k in ("workers", "prefetch_mb") if st1[k] != st2[k]]
        if st1["agent"]["steps"] != st2["agent"]["steps"]:
            bad.append("agent steps")
        if bad:
            raise AssertionError(f"restored state differs: {bad}")
        n_params = len(named)
        del first, again, named
        torch.cuda.empty_cache()
        on = run_proc(SimpleNamespace(steps=CKPT_STEPS + 2, **args), cut)
        if on["start"] != CKPT_STEPS or len(on["losses"]) != 2 or \
                not all(math.isfinite(x) for x in on["losses"]):
            raise AssertionError(f"resumed run: start {on['start']}, "
                                 f"losses {on['losses']}")
        ckpt_gb = sum(os.path.getsize(os.path.join(r, f))
                      for r, _, fs in os.walk(d) for f in fs) / 1e9
        print(f"  checkpoint: saved at step {CKPT_STEPS - 1} (run "
              f"{save_s:.1f} s), resumed with {n_params} parameters, "
              f"{n_params} adagrad accumulators and the tuner (agent steps "
              f"{st1['agent']['steps']}, workers {st1['workers']}, prefetch "
              f"{st1['prefetch_mb']} MB) bitwise (run {restore_s:.1f} s); "
              f"2 more steps from step {on['start']}, losses "
              f"{on['losses']}; {ckpt_gb:.2f} GB on disk; launches "
              f"{counts}", flush=True)
        del on
    finally:
        shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    return counts


FLEET_SIM_TICKS = 1200
# 100 windows, not the benchmark's default 160: the script's time goes to
# the quickstart phase instead (live_demo_cluster scales its churn to the
# run, so every churn kind still lands)
FLEET_LIVE_TICKS = 100
PROC_TUNE_WINDOWS = 8
# 14 ticks, not 20: the script's time goes to the quickstart
# phase; live_demo_cluster(14) still lands its four churn events, at
# ticks 3, 7, 9 and 11, each with its own relaunch window
PROC_FLEET_TICKS = 14


def _leftovers(threads, children, timeout: float = 8.0):
    """Threads and child processes started since the snapshots `threads`
    and `children` and still alive after up to `timeout` seconds."""
    import multiprocessing as mp
    deadline = time.monotonic() + timeout
    while True:
        extra_t = [t.name for t in threading.enumerate() if t not in threads]
        extra_p = [p.pid for p in mp.active_children() if p not in children]
        if not (extra_t or extra_p) or time.monotonic() > deadline:
            return extra_t, extra_p
        time.sleep(0.05)


def _host_snapshot():
    import multiprocessing as mp
    return set(threading.enumerate()), list(mp.active_children())


def phase_fleet_sim(agent_procs):
    """benchmarks/torch_fig7_fleet.run at 1200 ticks: the five fleet
    policies over demo_cluster on FleetSim, the coordinator from the
    cached 5- and 7-stage agents; the reference's bars (tests/
    test_fleet.py::test_fig7_fleet_acceptance): pct_of_oracle >= 90,
    intune_vs_even >= 1.3, no OOM. Prints each policy's aggregate
    throughput, share of the oracle, OOMs and CPU utilization."""
    import torch
    from benchmarks import torch_fig7_fleet as f7
    waited = wait_agent(agent_procs, 7)
    print(f"  agents pretrained (waited {waited:.1f} s); host cores "
          f"{os.cpu_count()}", flush=True)
    # the coordinator's DQN is a few small matmuls a tick: one thread
    # runs them faster than eight and no busy core can stall it
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        summary = f7.run(ticks=FLEET_SIM_TICKS, seed=0, quiet=False)
    finally:
        torch.set_num_threads(threads)
    coord, sp = summary["fleet_intune"], summary["_speedups"]
    print("  fleet_sim " + json.dumps(summary), flush=True)
    if coord["pct_of_oracle"] < 90.0 or sp["intune_vs_even"] < 1.3 or \
            coord["oom_count"] != 0 or coord["ooms_steady"] != 0:
        raise AssertionError(f"fleet_sim under the reference's bars: "
                             f"{coord}, {sp}")


def phase_fleet_live():
    """benchmarks/torch_fig7_fleet.run_live at 100 windows of 0.12 s:
    fleet_even and the coordinator on LiveFleet (real threads) over
    live_demo_cluster; the reference's bars (tests/test_live_fleet.py::
    test_fig7_fleet_live_acceptance): the coordinator without an OOM, no
    dropped batch, every thread joined, measured intune_vs_even above
    1.0; and no thread of either run left running."""
    from benchmarks import torch_fig7_fleet as f7
    threads, children = _host_snapshot()
    summary = f7.run_live(ticks=FLEET_LIVE_TICKS, seed=0, quiet=False)
    left_t, left_p = _leftovers(threads, children)
    coord, sp = summary["fleet_intune"], summary["_speedups"]
    print("  fleet_live " + json.dumps(summary), flush=True)
    bad = [f"{name}: {k} {s[k]}" for name, s in summary.items()
           if name != "_speedups"
           for k, ok in (("dropped_batches", 0), ("all_joined", True))
           if s[k] != ok]
    if coord["oom_count"] != 0:
        bad.append(f"fleet_intune: oom_count {coord['oom_count']}")
    if not sp["intune_vs_even"] > 1.0:
        bad.append(f"intune_vs_even {sp['intune_vs_even']}")
    if left_t or left_p:
        bad.append(f"left running: threads {left_t}, processes {left_p}")
    if bad:
        raise AssertionError(f"fleet_live: {bad}")


def phase_api_tune():
    """The public one-liner on the process plane, as
    examples/process_pipeline.py runs it: tune(live_linear_pipeline(),
    MachineSpec(n_cpus=host cores), optimizer="oracle", backend="proc")
    over 0.3 s windows (ms-scale stage costs, per-worker ballast on);
    then fleet_even on ProcFleetBackend over live_demo_cluster(14), its
    churn (a join, a resize, a pool re-cap, a leave) paid by relaunch
    windows, with ballast off. Each run without an OOM or a crash-lost
    batch, every process joined, none left running. (The H100's 8-core
    host forks slowly: 40 ticks of fleet_even took 33.1 s there, most of
    it in relaunches, and the coordinator, which re-places workers nearly
    every tick while it explores, 102.6 s; PERF.md §6. The coordinator
    runs on threads in fleet_live.)"""
    import numpy as np
    from repro_torch.api import tune
    from repro_torch.data.live_fleet import (live_demo_cluster,
                                             live_linear_pipeline)
    from repro_torch.data.simulator import MachineSpec

    out = {}
    threads, children = _host_snapshot()
    t0 = time.monotonic()
    machine = MachineSpec(n_cpus=os.cpu_count(), mem_mb=16384.0)
    res = tune(live_linear_pipeline(), machine, optimizer="oracle",
               backend="proc", ticks=PROC_TUNE_WINDOWS, seed=0,
               backend_kw={"window_s": 0.3})
    out["proc"] = {"n_cpus": machine.n_cpus, "windows": res.ticks,
                   "throughput": res.throughput,
                   "mean_tput_after_2": float(np.mean(res.throughput[2:])),
                   "used_cpus": res.used_cpus, "mem_mb": res.mem_mb,
                   "oom_count": res.oom_count, "live": res.extras["live"],
                   "s": time.monotonic() - t0}
    t0 = time.monotonic()
    cluster = live_demo_cluster(PROC_FLEET_TICKS)
    res = tune(cluster, optimizer="fleet_even", backend="proc",
               ticks=PROC_FLEET_TICKS, seed=0, relaunch_dead=2,
               backend_kw={"window_s": 0.1, "ballast": False})
    out["proc_fleet"] = {"cluster": cluster.name, "ticks": res.ticks,
                         "mean_tput": float(np.mean(res.throughput)),
                         "oom_count": res.oom_count,
                         "live": res.extras["live"],
                         "s": time.monotonic() - t0}
    left_t, left_p = _leftovers(threads, children)
    print("  api_tune " + json.dumps(out, default=float), flush=True)
    bad = [f"{k}: {r['oom_count']} OOMs, {r['live']}" for k, r in out.items()
           if r["oom_count"] or not r["live"]["all_joined"]
           or r["live"].get("crash_lost", 0)]
    if min(out["proc"]["throughput"][2:]) <= 0.0:
        bad.append(f"proc: a window without a batch {out['proc']}")
    if left_t or left_p:
        bad.append(f"left running: threads {left_t}, processes {left_p}")
    if bad:
        raise AssertionError(f"api_tune: {bad}")


def _quickstart_kernels(cfg, batch: int) -> dict:
    """The four DLRM kernels at the quickstart's shapes (ids (batch, 8,
    1) of the example's own pipeline stages into (8, 4096, 16) f32
    tables; the interaction at (batch, 9, 16)): each against its plain
    version (embedding_bag_fwd bitwise, the scatter rtol 1e-5 / atol
    1e-6, the interaction rtol 1e-5 / atol 1e-4), then timed beside its
    plain version, its library call and its bound. Returns a record per
    kernel."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.data.synthetic import CriteoStream
    from repro_torch.kernels import dot_interact as di
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(24)
    n_f, rows, dim = cfg.n_sparse, cfg.vocab_sizes[0], cfg.embed_dim
    stream = CriteoStream(n_sparse=n_f, n_dense=cfg.n_dense, vocab=rows)
    host = CriteoStream.batch_udf(stream.feature_udf(CriteoStream.shuffle_udf(
        stream.raw_block(batch), np.random.RandomState(0))))
    ids = torch.as_tensor(host["sparse_ids"]).to(dev)
    b, _, bag = ids.shape
    tables = torch.empty((n_f, rows, dim), device=dev)
    tables.normal_(generator=gen).mul_(dim ** -0.5)
    errs = _check_bag(tables, ids, "sum", "quickstart")
    feats = torch.randn((b, n_f + 1, dim), device=dev, generator=gen)
    errs.update(_check_dot(feats, "quickstart"))

    flat = (ids.long() + (torch.arange(n_f, device=dev) * rows)
            .view(1, n_f, 1)).reshape(b * n_f, bag)
    uniq = int(torch.unique(flat).numel())
    table_flat = tables.view(n_f * rows, dim)
    shape = f"({b}, {n_f}, {bag}) x ({n_f}, {rows}, {dim})"
    out = {}
    out["embedding_bag_fwd"] = kernel_record(
        "embedding_bag_fwd quickstart",
        time_ms(lambda: eb.embedding_bag_fwd(tables, ids), [()],
                kernel="embedding_bag_fwd_kernel"),
        time_ms(lambda: ref.embedding_bag_ref(tables, ids), [()]),
        time_ms(lambda: F.embedding_bag(flat, table_flat, mode="sum"),
                [()]),
        cost_bound("bag_fwd", b, n_f, bag, rows, dim, 4, uniq),
        errs["embedding_bag_fwd"], shape=shape)
    d_out = torch.randn((b, n_f, dim), device=dev, generator=gen)
    grad = torch.zeros_like(tables)
    upd = d_out[:, :, None, :].expand(b, n_f, bag, dim).reshape(-1, dim) \
        .contiguous()
    grad_flat = torch.zeros((n_f * rows, dim), device=dev)
    out["embedding_bag_bwd"] = kernel_record(
        "embedding_bag_bwd quickstart",
        time_ms(lambda: eb.embedding_bag_scatter(d_out, ids, grad), [()],
                kernel="embedding_bag_bwd_kernel"),
        time_ms(lambda: ref.embedding_bag_bwd_ref(d_out, ids, rows), [()]),
        time_ms(lambda: grad_flat.index_add_(0, flat.reshape(-1), upd),
                [()]),
        cost_bound("bag_bwd", b, n_f, bag, rows, dim, 4, uniq),
        errs["embedding_bag_bwd"], shape=shape, zero_fill_ms=time_ms(lambda: grad.zero_(), [()]).ms)
    n_pairs = (n_f + 1) * n_f // 2
    ii, jj = ref.tril_pairs(n_f + 1, dev)
    fs = [(feats,)]
    shape = f"({b}, {n_f + 1}, {dim})"
    out["dot_interact_fwd"] = kernel_record(
        "dot_interact_fwd quickstart",
        time_ms(di.dot_interact_fwd, fs, kernel="dot_interact_fwd_kernel"),
        time_ms(ref.dot_interact_ref, fs),
        time_ms(lambda x: torch.bmm(x, x.transpose(1, 2))[:, ii, jj], fs),
        cost_bound("dot_fwd", b, n_f + 1, dim, 4), errs["dot_interact_fwd"],
        shape=shape)
    g = torch.randn((b, n_pairs), device=dev, generator=gen)
    s = torch.zeros((b, n_f + 1, n_f + 1), device=dev)
    s[:, ii, jj] = g
    out["dot_interact_bwd"] = kernel_record(
        "dot_interact_bwd quickstart",
        time_ms(di.dot_interact_bwd, [(g, feats)],
                kernel="dot_interact_bwd_kernel"),
        time_ms(ref.dot_interact_bwd_ref, [(g, feats)]),
        time_ms(torch.bmm, [(s + s.transpose(1, 2), feats)]),
        cost_bound("dot_bwd", b, n_f + 1, dim, 4), errs["dot_interact_bwd"],
        shape=shape)
    return out


def phase_quickstart() -> dict:
    """examples/torch_quickstart.py's three parts, part 3 on the card:
    the four DLRM kernels against their plain versions at the example's
    shapes and timed (_quickstart_kernels); part 1 (tune on the analytic
    simulator, 250 ticks) and part 2 (the same call on real threads, 12
    windows) as the example runs them; then part 3 as the example runs
    it: its 30 train steps of the example's DLRM on the card off the live
    ThreadedPipeline while the tuning Session runs 20 windows of 0.2 s in
    its background thread. Fails on a non-finite loss, a train step that did not go
    through each of the four kernels (the launch counts, set to 0 just
    before part 3), a thread or process not joined or left running, an
    OOM, or a tuner that never moved the pools. Prints part 3's seconds,
    steps/s and final workers. Returns each kernel's record with its
    launches."""
    from examples import torch_quickstart as qs
    from repro_torch.kernels import ops

    recs = _quickstart_kernels(qs.QS_CONFIG, qs.QS_BATCH)
    threads, children = _host_snapshot()
    t0 = time.monotonic()
    one = qs.part1_one_liner()
    two = qs.part2_live_backend()
    parts_s = time.monotonic() - t0
    ops.reset_launch_counts()
    t0 = time.monotonic()
    three = qs.part3_drop_in("cuda")
    part3_s = time.monotonic() - t0
    counts = {k: ops.launch_counts()[k] for k in DLRM_KERNELS}
    left_t, left_p = _leftovers(threads, children)
    moved = len({tuple(w) for w in three["workers_seen"]}) > 1
    print(f"  quickstart part 1: InTune steady {one['steady']:.2f} b/s vs "
          f"AUTOTUNE-like {one['autotune']:.2f}, {one['oom_count']} OOMs; "
          f"part 2: {two['live']}; parts 1-2 {parts_s:.1f} s", flush=True)
    print(f"  quickstart part 3: {qs.QS_STEPS} steps in "
          f"{three['train_s']:.2f} s ({three['steps_per_s']:.1f} steps/s), "
          f"the part {part3_s:.1f} s; loss {three['losses'][0]:.4f} -> "
          f"{three['losses'][-1]:.4f}; workers "
          f"{three['workers_seen'][0]} -> {three['workers_final']} (each "
          f"tick: {three['workers_seen']}); teardown {three['teardown']}; "
          f"launches {counts}", flush=True)
    bad = []
    if len(three["losses"]) != qs.QS_STEPS or \
            not all(math.isfinite(x) for x in three["losses"]):
        bad.append(f"losses {three['losses']}")
    short = {k: n for k, n in counts.items() if n < qs.QS_STEPS}
    if short:
        bad.append(f"kernels launched fewer than {qs.QS_STEPS} times: "
                   f"{short}")
    for name, acct in (("part 2", two["live"]), ("part 3", three["teardown"])):
        if not acct["all_joined"] or acct["oom_count"] or \
                acct.get("dropped_batches", 0):
            bad.append(f"{name}: {acct}")
    if one["oom_count"]:
        bad.append(f"part 1: {one['oom_count']} OOMs")
    if not moved:
        bad.append(f"the tuner never moved the pools: "
                   f"{three['workers_seen']}")
    if left_t or left_p:
        bad.append(f"left running: threads {left_t}, processes {left_p}")
    if bad:
        raise AssertionError(f"quickstart: {bad}")
    for name, n in counts.items():
        recs[name]["launches"] = n
    return recs


def profile_steps(step, steps: int, kernels=()):
    """Device time by kernel of `steps` calls of step(k), k = 0, 1, ...:
    torch.profiler over a window that opens and closes with the sentinel
    launches (as time_ms's), taken again (up to WINDOW_TRIES times) until it holds
    `steps` events of each name in `kernels` and its clock reads its
    reference spins right (`window_clock`). Returns ([(kernel, device ms
    a step)] by time, host-clock ms a step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(WINDOW_TRIES):
        ref_ms = spin_ms()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            settle(attempt)
            t0 = time.monotonic()
            for k in range(steps):
                step(k)
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3 / steps
            settle(attempt)
        events = prof.key_averages()
        short = {k: n for k in kernels
                 for n in [sum(e.count for e in events if k in e.key)]
                 if n < steps}
        clock = window_clock(prof, ref_ms)
        if not clock_ok(clock):
            short["window clock"] = clock
        if not short:
            rows = sorted(((e.key, e.self_device_time_total / 1e3 / steps)
                           for e in events if SENTINEL not in e.key),
                          key=lambda r: -r[1])
            return rows, wall_ms
        print(f"  torch.profiler recorded {short} events in {steps} steps; "
              f"profiling again", flush=True)
    raise RuntimeError(f"torch.profiler recorded too few events in {steps} "
                       f"steps in {WINDOW_TRIES} tries: {short}")


def phase_profile(cfg):
    """Where one train step's device time goes at the slice configuration:
    torch.profiler over 3 steps on one featurized batch (after 2 warm-up
    steps), device time summed by kernel, against the host-clock step."""
    import numpy as np
    import torch
    from repro_torch.data.featurize import (RecordSpec, featurize_block,
                                            raw_block)
    from repro_torch.launch.train_dlrm_criteo import build_model

    dev = torch.device("cuda")
    model, opt, step_fn = build_model(cfg, seed=0, device=dev)
    state = opt.init(dict(model.named_parameters()))
    rec = RecordSpec(batch=2048, n_sparse=cfg.n_sparse, n_dense=cfg.n_dense,
                     vocab=cfg.vocab_sizes[0])
    batch = {k: torch.as_tensor(v).to(dev) for k, v in featurize_block(
        raw_block(np.random.RandomState(3), rec), rec).items()}
    for k in range(2):
        step_fn(model, state, k, batch)
    torch.cuda.synchronize()
    rows, wall_ms = profile_steps(
        lambda k: step_fn(model, state, 2 + k, batch), 3,
        ("embedding_bag_fwd_kernel", "dot_interact_fwd_kernel"))
    device_ms = sum(ms for _, ms in rows)
    print(f"  train step: {device_ms:.3f} ms of device time in "
          f"{wall_ms:.3f} ms of host-clock time (profiled)")
    for name, ms in rows[:10]:
        print(f"    {ms:9.4f} ms  {100 * ms / device_ms:5.1f}%  {name[:90]}")

def _gnn_path_shapes(shape, cfg):
    """(tag, B, F, D, H, d_neigh needed) of the three sage_aggregate calls
    of one GraphSAGE train step (repro_torch.models.gnn)."""
    b, (f1, f2), d = shape.batch_nodes, shape.fanout, shape.d_feat
    return (("neigh2", b * f1, f2, d, cfg.d_hidden, False),
            ("neigh1", b, f1, d, cfg.d_hidden, False),
            ("h1", b, f1, cfg.d_hidden, cfg.n_classes, True))


def _check_sage(neigh, w, tag) -> dict:
    """Kernel vs plain on one input: the aggregate (its rows padded to a
    multiple of 4 floats) bitwise, out and d_neigh allclose, d_w within
    1e-5 of max |d_w|; out without the saved aggregate, d_w without
    d_neigh and a second run of each bitwise equal; d_neigh's F copies of
    a row bitwise equal, and d_neigh bitwise the same from d_out and w
    copied 4 bytes off a 16-byte boundary."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import sage_aggregate as sa
    b, f, d = neigh.shape
    out, agg = sa.sage_aggregate_fwd(neigh, w, save_agg=True)
    agg_p = ref.sage_mean_ref(neigh)
    if b > 1 and agg.stride(0) != sa.agg_stride(d):
        raise AssertionError(f"sage_aggregate_fwd {tag}: aggregate rows "
                             f"{agg.stride(0)} floats apart, not "
                             f"{sa.agg_stride(d)}")
    if not torch.equal(agg, agg_p):
        raise AssertionError(f"sage_aggregate_fwd {tag}: aggregate not "
                             f"bitwise equal to the plain version")
    out_only, none = sa.sage_aggregate_fwd(neigh, w)
    if none is not None or not torch.equal(out_only, out):
        raise AssertionError(f"sage_aggregate_fwd {tag}: out differs "
                             f"without the saved aggregate")
    if not torch.equal(sa.sage_aggregate_fwd(neigh, w, save_agg=True)[0],
                       out):
        raise AssertionError(f"sage_aggregate_fwd {tag}: two runs differ")
    e_f = _allclose(f"sage_aggregate_fwd {tag}", out,
                    ref.sage_aggregate_ref(neigh, w), 1e-5, 1e-5)
    d_out = torch.randn_like(out)
    d_neigh, d_w = sa.sage_aggregate_bwd(d_out, w, agg, f, True)
    want_n, want_w = ref.sage_aggregate_bwd_ref(d_out, w, agg_p, f)
    e_n = _allclose(f"sage_aggregate_bwd d_neigh {tag}", d_neigh, want_n,
                    1e-5, 1e-5)
    if not torch.equal(d_neigh, d_neigh[:, :1].expand_as(d_neigh)):
        raise AssertionError(f"sage_aggregate_bwd {tag}: the F copies of a "
                             f"row of d_neigh differ")
    # the same d_out and w 4 bytes off a 16-byte boundary: the same bits
    shifted = [torch.empty(x.numel() + 1, device=x.device)[1:].view(x.shape)
               .copy_(x) for x in (d_out, w)]
    if not torch.equal(sa.sage_aggregate_bwd(*shifted, None, f, True)[0],
                       d_neigh):
        raise AssertionError(f"sage_aggregate_bwd {tag}: d_neigh differs "
                             f"with d_out and w off 16-byte alignment")
    e_w = _allclose(f"sage_aggregate_bwd d_w {tag}", d_w, want_w, 0.0,
                    1e-5 * float(want_w.abs().max()))
    only_w = sa.sage_aggregate_bwd(d_out, w, agg, f, False)
    if only_w[0] is not None or not torch.equal(only_w[1], d_w):
        raise AssertionError(f"sage_aggregate_bwd {tag}: d_w differs "
                             f"without d_neigh")
    again = sa.sage_aggregate_bwd(d_out, w, agg, f, True)
    if not (torch.equal(again[0], d_neigh) and torch.equal(again[1], d_w)):
        raise AssertionError(f"sage_aggregate_bwd {tag}: two runs differ")
    return {"sage_aggregate_fwd": e_f, "sage_aggregate_bwd": max(e_n, e_w)}


def _check_sage_bf16(neigh, w, tag) -> float:
    """sage_aggregate_fwd with neigh or w (or both) bf16 against its plain
    version: the f32 aggregate bitwise, out (neigh's dtype) within 2 bf16
    ulps where it is bf16, rtol 1e-5 / atol 1e-5 where it is f32 (a bf16 w
    keeps the f32 tolerance of phase_sage_kernels); a bf16 w's widening
    kernel bitwise to w.float(). Returns the max abs error of out."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import sage_aggregate as sa
    if w.dtype == torch.bfloat16 and not torch.equal(sa.widen_w(w),
                                                     w.float()):
        raise AssertionError(f"widen_w {tag}: not w.float() bit for bit")
    out, agg = sa.sage_aggregate_fwd(neigh, w, save_agg=True)
    if out.dtype != neigh.dtype or agg.dtype != torch.float32:
        raise AssertionError(f"sage_aggregate_fwd {tag}: out {out.dtype}, "
                             f"aggregate {agg.dtype}")
    if not torch.equal(agg, ref.sage_mean_ref(neigh)):
        raise AssertionError(f"sage_aggregate_fwd {tag}: aggregate not "
                             f"bitwise equal to the plain version")
    if not torch.equal(sa.sage_aggregate_fwd(neigh, w)[0], out):
        raise AssertionError(f"sage_aggregate_fwd {tag}: out differs "
                             f"without the saved aggregate")
    rtol, atol = ((BF16_RTOL, 1e-5) if out.dtype == torch.bfloat16
                  else (1e-5, 1e-5))
    return _allclose(f"sage_aggregate_fwd {tag}", out,
                     ref.sage_aggregate_ref(neigh, w), rtol, atol)


def _ragged_sage_bf16(gen) -> float:
    """_check_sage_bf16 at every load width of a bf16 neigh (D 602: 4-byte
    loads; D 128: 16-byte; D 5 and a neigh 2-byte aligned: one element),
    w whole (H <= 128, rows 16-byte aligned or not) and in column tiles
    (H 130), tiles of 8 and 32 rows, and neigh or w alone in bf16."""
    import torch
    dev = torch.device("cuda")
    err = 0.0
    for tag, b, f, d, h, shift, dtypes in (
            ("ragged", 37, 1, 5, 7, 0, "bb"),
            ("ragged-h", 37, 3, 33, 130, 0, "bb"),
            ("ragged-b", 1023, 15, 602, 128, 0, "bb"),
            ("ragged-wide", 4225, 2, 34, 7, 0, "bb"),
            ("h1", 1024, 15, 128, 47, 0, "bb"),
            ("ragged-2b", 300, 10, 602, 128, 1, "bb"),
            ("ragged-4b", 300, 15, 128, 47, 2, "bb"),
            ("neigh only", 300, 10, 602, 128, 0, "bf"),
            ("w only", 300, 10, 602, 128, 0, "fb")):
        buf = torch.randn(b * f * d + shift, device=dev, generator=gen)
        neigh = buf.to(torch.bfloat16 if dtypes[0] == "b"
                       else torch.float32)[shift:].view(b, f, d)
        w = (torch.randn((d, h), device=dev, generator=gen) * d ** -0.5).to(
            torch.bfloat16 if dtypes[1] == "b" else torch.float32)
        err = max(err, _check_sage_bf16(neigh, w, f"{tag} {dtypes}"))
    return err


def phase_sage_kernels(shape, cfg) -> dict:
    """sage_aggregate_fwd and _bwd against their plain versions at the
    GNN path's three shapes and at ragged ones, then timed at the path's
    shapes. Returns one record per kernel: the top-level numbers are those
    of the main shape (neigh2); `per_shape` lists all three."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import sage_aggregate as sa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    errs = {k: 0.0 for k in GNN_KERNELS}

    def inputs(b, f, d, h, shift=0):
        # shift > 0: neigh is a slice `shift` floats into a larger buffer
        buf = torch.randn(b * f * d + shift, device=dev, generator=gen)
        neigh = buf[shift:].view(b, f, d)
        w = torch.randn((d, h), device=dev, generator=gen) * d ** -0.5
        return neigh, w

    path = _gnn_path_shapes(shape, cfg)
    # ragged shapes reach every variant of the forward: tiles of 8 or 32
    # rows, 4-, 8- or 16-byte loads of neigh (D odd, a base 4- or 8- but
    # not 16-byte aligned), w's rows 16-byte aligned or not (H 47, 7,
    # 130), one or two column tiles, B not a multiple of 4, F D = 2 mod 4
    # (neigh1's 15 x 602), many neighbours (F 44; the sampler's default
    # fanout 25), several tiles a CTA; and d_w's clusters of 2 and 8 with
    # one or more clusters a tile
    for tag, b, f, d, h, shift in (
            ("ragged", 37, 1, 5, 7, 0),
            ("ragged-h", 37, 3, 33, 130, 0),
            ("ragged-wide", 4225, 2, 33, 7, 0),
            ("ragged-b", 1023, 15, 602, 128, 0),
            ("ragged-f", 5, 43, 6, 47, 0),
            ("ragged-h2", 600, 10, 300, 130, 0),
            ("ragged-fc", 300, 44, 602, 128, 0),
            ("fanout25", 1024, 25, 602, 128, 0),
            ("ragged-8b", 300, 15, 128, 47, 2),
            ("ragged-4b", 300, 10, 602, 128, 1),
            ("ragged-8b-wide", 5000, 10, 602, 128, 2),
            *[(t, b, f, d, h, 0) for t, b, f, d, h, _ in path]):
        for k, v in _check_sage(*inputs(b, f, d, h, shift), tag).items():
            errs[k] = max(errs[k], v)
        torch.cuda.empty_cache()
    sage16_err = _ragged_sage_bf16(gen)

    per = {k: [] for k in GNN_KERNELS}
    print(f"  d_w clusters that fit the card at once, by size: "
          f"{ {c: sa.dw_active_clusters(dev, c) for c in (1, 2, 4, 8)} }")
    for tag, b, f, d, h, need_neigh in path:
        print(f"  {tag}: {sa.fwd_plan(b, f, d, h)}, "
              f"{sa.dw_plan(b, d, h, lambda c: sa.dw_active_clusters(dev, c))}")
        # enough input sets to cycle through more than the 50 MB L2
        n_sets = max(1, min(8, -(-64 * 2 ** 20 // (4 * b * f * d))))
        sets = [inputs(b, f, d, h) for _ in range(n_sets)]
        t = time_ms(lambda n, w: sa.sage_aggregate_fwd(n, w, True), sets,
                    kernel="sage_fwd_kernel")
        plain = time_ms(ref.sage_aggregate_ref, sets)
        lib = time_ms(lambda n, w: torch.einsum("bfd,dh->bh", n, w), sets)
        bms, by = cost_bound("sage_fwd", b, f, d, h, 4, True)
        per["sage_aggregate_fwd"].append(
            {"shape": tag, "B": b, "F": f, "D": d, "H": h, "ms": t.ms,
             "wall_ms": t.wall, "events": t.events, "plain_ms": plain.ms,
             "plain_events": plain.events, "library_ms": lib.ms,
             "library_events": lib.events, "bound_ms": bms, "bound_by": by})
        if tag == path[0][0]:
            # bf16 neigh and w at the main shape: the aggregate bitwise,
            # out within 2 bf16 ulps; bound at 2-byte inputs and outputs
            sets16 = [(n.to(torch.bfloat16), w.to(torch.bfloat16))
                      for n, w in sets]
            err16 = max(_check_sage_bf16(n, w, f"{tag} bf16")
                        for n, w in sets16[:1])
            bf16 = kernel_record(
                f"sage_aggregate_fwd {tag} bf16",
                time_ms(lambda n, w: sa.sage_aggregate_fwd(n, w, True),
                        sets16, kernel="sage_fwd_kernel"),
                time_ms(ref.sage_aggregate_ref, sets16),
                time_ms(lambda n, w: torch.einsum("bfd,dh->bh", n, w),
                        sets16),
                cost_bound("sage_fwd", b, f, d, h, 2, True, w_elem=2),
                err16)
            # the bf16 w's widening, a kernel of its own that the call
            # above launches first (its time is in the call's)
            wsets = [(w,) for _, w in sets16]
            wt = time_ms(sa.widen_w, wsets, kernel="widen_w_kernel")
            wl = time_ms(lambda x: x.float(), wsets)
            wb, wby = cost_bound("widen", d, h)
            bf16["widen_w"] = {"ms": wt.ms, "wall_ms": wt.wall,
                               "events": wt.events, "library_ms": wl.ms,
                               "library_events": wl.events, "bound_ms": wb,
                               "bound_by": wby}
            print(f"    widen_w ({d}, {h}) bf16: {wt.ms:.4f} ms on the card "
                  f"({wt.events} events), {wt.wall:.4f} launch to launch "
                  f"(w.float() {wl.ms:.4f}, bound {wb:.4f} by {wby})")
            del sets16
        bsets = [(torch.randn((b, h), device=dev, generator=gen), w,
                  sa.sage_aggregate_fwd(n, w, True)[1]) for n, w in sets]
        del sets
        t = time_ms(
            lambda g, w, a: sa.sage_aggregate_bwd(g, w, a, f, need_neigh),
            bsets, kernel="sage_dw_kernel")
        dneigh = None
        if need_neigh:
            # sage_dneigh_kernel alone, read by name from a window of the
            # same backward (the row's ms holds it and sage_dw_kernel)
            dn_ms, dn_events = named_kernel_ms(
                lambda g, w, a: sa.sage_aggregate_bwd(g, w, a, f, True),
                bsets, "sage_dneigh_kernel")
            dn_bound = cost_bound("sage_bwd", b, f, d, h, False, True)
            # its function alone: the plain version's d_neigh (no agg, so
            # no d_w) and one library expression, (d_out @ w^T / F)
            # expanded over the F neighbours and written out
            dn_plain = time_ms(lambda g, w, a: ref.sage_aggregate_bwd_ref(
                g, w, None, f, need_neigh=True), bsets)
            dn_lib = time_ms(lambda g, w, a: (g @ w.t() / f)[:, None, :]
                             .expand(b, f, d).contiguous(), bsets)
            dn_plan = sa.dneigh_plan(b, f, d, h)
            dneigh = {"ms": dn_ms, "events": dn_events,
                      "plan": {"rows": dn_plan.rows, "cols": 32,
                               "ctas": dn_plan.ctas(b, d),
                               "store": "registers"},
                      "plain_ms": dn_plain.ms,
                      "plain_events": dn_plain.events,
                      "library_ms": dn_lib.ms,
                      "library_events": dn_lib.events,
                      "bound_ms": dn_bound[0], "bound_by": dn_bound[1]}
            print(f"    sage_dneigh_kernel {tag} ({b}, {f}, {d}) from "
                  f"({b}, {h}) x ({d}, {h})^T, {dn_plan.ctas(b, d)} CTAs of "
                  f"{dn_plan.rows} x 32, 4-byte stores from registers: "
                  f"{dn_ms:.4f} ms on the card "
                  f"({dn_events} events), plain {dn_plain.ms:.4f}, "
                  f"library {dn_lib.ms:.4f}, bound {dn_bound[0]:.4f} by "
                  f"{dn_bound[1]} ({dn_bound[0] / dn_ms:.0%} of it)",
                  flush=True)
        plain = time_ms(lambda g, w, a: ref.sage_aggregate_bwd_ref(
            g, w, a, f, need_neigh=need_neigh), bsets)
        # one library call computes d_w alone (mm); with d_neigh, the
        # library's calls are that mm and (d_out @ w^T / F) broadcast over
        # the F neighbours, written out as the kernel writes d_neigh
        if need_neigh:
            lib = time_ms(lambda g, w, a: (
                torch.mm(a.t(), g), (g @ w.t() / f)[:, None, :]
                .expand(b, f, d).contiguous()), bsets)
        else:
            lib = time_ms(lambda g, w, a: torch.mm(a.t(), g), bsets)
        bms, by = cost_bound("sage_bwd", b, f, d, h, True, need_neigh)
        per["sage_aggregate_bwd"].append(
            {"shape": tag, "B": b, "F": f, "D": d, "H": h,
             "d_neigh": need_neigh, "ms": t.ms, "wall_ms": t.wall,
             "events": t.events, "plain_ms": plain.ms,
             "plain_events": plain.events,
             "library_ms": None if lib is None else lib.ms,
             "library_events": None if lib is None else lib.events,
             "bound_ms": bms, "bound_by": by,
             **({"sage_dneigh_kernel": dneigh} if dneigh else {})})
        del bsets
        torch.cuda.empty_cache()

    out = {}
    for name in GNN_KERNELS:
        main = per[name][0]
        out[name] = {k: main[k] for k in ("ms", "plain_ms", "library_ms",
                                          "bound_ms", "bound_by", "wall_ms",
                                          "events", "plain_events",
                                          "library_events")}
        out[name]["max_abs_err"] = errs[name]
        out[name]["per_step_ms"] = sum(r["ms"] for r in per[name])
        out[name]["per_step_bound_ms"] = sum(r["bound_ms"] for r in per[name])
        out[name]["per_shape"] = per[name]
        for r in per[name]:
            lib = "none" if r["library_ms"] is None \
                else f"{r['library_ms']:.4f}"
            vs_lib = "" if r["library_ms"] is None \
                else f", {r['ms'] / r['library_ms']:.2f}x the library's"
            print(f"  {name} {r['shape']} ({r['B']}, {r['F']}, {r['D']}) x "
                  f"({r['D']}, {r['H']}): {r['ms']:.4f} ms on the card, "
                  f"{r['wall_ms']:.4f} ms launch to launch (plain "
                  f"{r['plain_ms']:.4f}, library {lib}, bound "
                  f"{r['bound_ms']:.4f} by {r['bound_by']}; "
                  f"{r['bound_ms'] / r['ms']:.0%} of the bound{vs_lib})")
        print(f"  {name}: {out[name]['per_step_ms']:.4f} ms a train step "
              f"(bound {out[name]['per_step_bound_ms']:.4f}), max abs err "
              f"{errs[name]:.3e}")
    bf16["max_abs_err"] = max(bf16["max_abs_err"], sage16_err)
    out["sage_aggregate_fwd"]["bf16"] = bf16
    return out


def build_graph(shape, cfg):
    """The synthetic graph of `shape` and its sampler, as the port's
    driver builds it (repro_torch.launch.train.make_sampler)."""
    import numpy as np
    from repro_torch.launch.train import make_sampler
    t0 = time.monotonic()
    sampler = make_sampler(cfg, shape, np.random.RandomState(0))
    print(f"  {shape.n_nodes} nodes, {len(sampler.g.nbr)} edges, features "
          f"{sampler.x.shape} {sampler.x.dtype} "
          f"({sampler.x.nbytes / 1e6:.1f} MB) in "
          f"{time.monotonic() - t0:.1f} s")
    return sampler


def _gnn_batch(sampler, shape, dev):
    import torch
    return {k: torch.from_numpy(v).to(dev)
            for k, v in sampler.sample(shape.batch_nodes).items()}


@contextlib.contextmanager
def recording_combine(gnn, rec):
    """Within the block, each hidden layer's combine of `gnn` also appends
    its pre-activation and its norm to `rec` (recomputed by the same
    operations on the same inputs, so with the same bits)."""
    import torch
    combine = gnn._sage_combine

    def wrapped(h_self, proj, layer, *, final):
        if not final:
            with torch.no_grad():
                pre = torch.matmul(h_self, layer.w_self) + proj + layer.b
                rec.append(pre)
                rec.append(torch.linalg.vector_norm(torch.relu(pre), dim=-1,
                                                    keepdim=True))
        return combine(h_self, proj, layer, final=final)
    gnn._sage_combine = wrapped
    try:
        yield
    finally:
        gnn._sage_combine = combine


def phase_gnn_model(shape, cfg, sampler):
    """GraphSAGE loss and gradients through the kernels vs the plain
    versions on the card, same parameters and batch, full width.

    As in phase_model, a ReLU input within rounding of 0 (or an L2 norm
    within rounding of its 1e-6 clamp) can fall on the other side on one
    path, which moves that seed's gradients by their full size. Such seeds
    are found from the recorded pre-activations and norms and given loss
    weight 0; every gradient of the remaining seeds' loss must then agree
    within 1e-4 of its L2 norm, and the full-batch loss within rtol
    1e-5."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import gnn

    dev = torch.device("cuda")
    model = gnn.init_params(cfg, shape.d_feat, seed=0, device=dev)
    batch = _gnn_batch(sampler, shape, dev)
    names, params = zip(*model.named_parameters())
    rec_k, rec_p = [], []
    ops.reset_launch_counts()
    with recording_combine(gnn, rec_k):
        nll_k = gnn.minibatch_nll(model, batch)
    with recording_combine(gnn, rec_p):
        nll_p = gnn.minibatch_nll(model, batch,
                                  agg_fn=ref.sage_aggregate_ref)
    b = nll_k.shape[0]
    flips = torch.zeros(b, dtype=torch.bool, device=dev)
    # rec alternates pre-activation (threshold 0) and norm (1e-6)
    for i, (a, p) in enumerate(zip(rec_k, rec_p)):
        t = 0.0 if i % 2 == 0 else 1e-6
        flips |= ((a > t) != (p > t)).reshape(b, -1).any(dim=1)
    n_flip = int(flips.sum())
    if n_flip > b // 100:
        raise AssertionError(f"{n_flip} seeds flip a ReLU or a norm clamp "
                             f"between the two paths")
    if not bool(torch.isfinite(nll_k).all()):
        raise AssertionError("GNN loss not finite")
    _allclose("GNN loss", nll_k.mean(), nll_p.mean(), 1e-5, 0.0)
    keep = (~flips).float() / float((~flips).sum())
    grads_k = torch.autograd.grad((nll_k * keep).sum(), params)
    counts = {k: ops.launch_counts()[k] for k in GNN_KERNELS}
    if min(counts.values()) < 3:
        raise AssertionError(f"GNN pass skipped a kernel call: {counts}")
    grads_p = torch.autograd.grad((nll_p * keep).sum(), params)
    worst = 0.0
    for n, gk, gp in zip(names, grads_k, grads_p):
        rel = float(torch.linalg.vector_norm(gk - gp)
                    / torch.linalg.vector_norm(gp))
        if not rel <= 1e-4:
            raise AssertionError(f"GNN grad {n}: relative L2 error "
                                 f"{rel:.3e}")
        worst = max(worst, rel)
    print(f"  loss kernels {float(nll_k.detach().mean()):.7f} plain "
          f"{float(nll_p.detach().mean()):.7f}; {n_flip} of {b} seeds flip "
          f"a ReLU or norm clamp and are left out of the gradients; "
          f"{len(names)} gradients agree (worst relative L2 error "
          f"{worst:.3e}); launches {counts}")


def phase_gnn_loop(shape, sampler) -> dict:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    ops.reset_launch_counts()
    res = train.run("graphsage-reddit", steps=GNN_STEPS, shape=shape,
                    full=True, device="cuda", sampler=sampler, log_every=5)
    counts = {k: ops.launch_counts()[k] for k in GNN_KERNELS}
    if not all(math.isfinite(x) for x in res["losses"]):
        raise AssertionError(f"GNN loss not finite: {res['losses']}")
    short = {k: n for k, n in counts.items() if n < 3 * GNN_STEPS}
    if short:
        raise AssertionError(f"kernels launched fewer than {3 * GNN_STEPS} "
                             f"times on the GNN path: {short}")
    summary = {k: res[k] for k in ("seed_nodes_per_s", "loop_step_s",
                                   "fetch_step_s", "train_step_s",
                                   "max_memory_allocated")}
    summary["loss_first"], summary["loss_last"] = res["losses"][0], \
        res["losses"][-1]
    summary["launches"] = counts
    print("  gnn_loop " + json.dumps(summary))
    torch.cuda.synchronize()
    return counts


def phase_gnn_profile(shape, cfg, sampler):
    """Where one GNN train step's device time goes: torch.profiler over 3
    steps on one sampled block already on the card (after 2 warm-up
    steps), device time summed by kernel, against the host-clock step."""
    import torch
    from repro_torch.models import gnn
    from repro_torch.train.optim import make_optimizer
    from repro_torch.train.train_step import make_train_step

    dev = torch.device("cuda")
    model = gnn.init_params(cfg, shape.d_feat, seed=0, device=dev)
    opt = make_optimizer("adam", lr=1e-3)
    state = opt.init(dict(model.named_parameters()))
    step_fn = make_train_step(gnn.minibatch_loss, opt)
    batch = _gnn_batch(sampler, shape, dev)
    for k in range(2):
        step_fn(model, state, k, batch)
    torch.cuda.synchronize()
    rows, wall_ms = profile_steps(
        lambda k: step_fn(model, state, 2 + k, batch), 3,
        ("sage_fwd_kernel",))
    device_ms = sum(ms for _, ms in rows)
    sage_ms = sum(ms for name, ms in rows if "sage_" in name)
    print(f"  GNN train step: {device_ms:.3f} ms of device time in "
          f"{wall_ms:.3f} ms of host-clock time (profiled); sage_aggregate "
          f"kernels {sage_ms:.3f} ms ({100 * sage_ms / device_ms:.1f}%)")
    for name, ms in rows[:12]:
        print(f"    {ms:9.4f} ms  {100 * ms / device_ms:5.1f}%  {name[:90]}")


# ----------------------------------------- GraphSAGE's other regimes ---
# the ogb_products driver run: its peak device memory must stay under one
# (E, 128) f32 message tensor, 61,859,140 x 128 x 4 bytes
GNN_FULL_STEPS = 10
MOLECULE_STEPS = 20
MESSAGE_BYTES = 61_859_140 * 128 * 4


def _combine_flips(rec_a, rec_b):
    """(rows,) bool: rows of any recorded layer whose ReLU input (records
    0, 2, ...: threshold 0) or norm (1, 3, ...: its 1e-6 clamp) falls on
    the other side on the two paths."""
    import torch
    flips = None
    for i, (a, b) in enumerate(zip(rec_a, rec_b)):
        t = 0.0 if i % 2 == 0 else 1e-6
        f = ((a > t) != (b.to(a.device) > t)).reshape(a.shape[0], -1) \
            .any(dim=1)
        flips = f if flips is None else flips | f
    return flips if flips is not None else torch.zeros(0, dtype=torch.bool)


def _nll_on(gnn, model, batch, kind):
    """(per-row nll, per-row weight) of a full graph (nodes, the label
    mask) or a batch of small graphs (graphs, 1), with the hidden layers'
    ReLU inputs and norms recorded."""
    import torch
    rec = []
    with recording_combine(gnn, rec):
        if kind == "full_graph":
            nll, mask = gnn.full_graph_nll(model, batch)
        else:
            nll = gnn.batched_graphs_nll(model, batch)
            mask = torch.ones_like(nll)
    return nll, mask, rec


def _check_full_model(gnn, cfg, shape, batch_np):
    """The port's model of a full-graph or batched-small shape on the card
    against the same model on the CPU, same parameters and numpy batch:
    loss rtol 1e-5, each gradient within 1e-4 of its L2 norm.

    A ReLU input or norm within rounding of its threshold can fall on the
    other side on one device, which moves its node's gradients by their
    full size; such nodes are found from the recorded pre-activations,
    and the rows whose loss they reach get weight 0: in a full graph the
    node and every node it sends a message to (layer 2 aggregates layer
    1's output), in a batch of small graphs the node's graph."""
    import torch
    runs = []
    for dev in ("cpu", "cuda"):
        model = gnn.init_params(cfg, shape.d_feat, seed=0, device="cpu") \
            .to(dev)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        runs.append((model,) + _nll_on(gnn, model, batch, shape.kind))
    (m_c, nll_c, mask_c, rec_c), (m_g, nll_g, mask_g, rec_g) = runs
    flips = _combine_flips(rec_c, rec_g)
    n_flip = int(flips.sum())
    if shape.kind == "full_graph":
        src = torch.from_numpy(batch_np["edge_src"]).long()
        dst = torch.from_numpy(batch_np["edge_dst"]).long()
        real = dst < shape.n_nodes
        hit = flips.clone()
        hit[dst[real][flips[src[real]]]] = True
    else:
        hit = flips.reshape(batch_np["x"].shape[0], -1).any(dim=1)
    if n_flip > flips.numel() // 100:
        raise AssertionError(f"{n_flip} rows flip a ReLU or a norm clamp "
                             f"between the CPU and the card")
    loss_c = (nll_c * mask_c).sum() / mask_c.sum().clamp(min=1.0)
    loss_g = (nll_g * mask_g).sum() / mask_g.sum().clamp(min=1.0)
    if not bool(torch.isfinite(loss_g)):
        raise AssertionError(f"{shape.name} loss not finite on the card")
    _allclose(f"{shape.name} loss", loss_g.cpu(), loss_c, 1e-5, 0.0)
    keep_c = mask_c * (~hit).float()
    keep_g = mask_g * (~hit).float().to(mask_g.device)
    names, params_c = zip(*m_c.named_parameters())
    grads_c = torch.autograd.grad((nll_c * keep_c).sum() / keep_c.sum(),
                                  params_c)
    grads_g = torch.autograd.grad((nll_g * keep_g).sum() / keep_g.sum(),
                                  list(m_g.parameters()))
    worst = 0.0
    for n, gc, gg in zip(names, grads_c, grads_g):
        rel = float(torch.linalg.vector_norm(gg.cpu() - gc)
                    / torch.linalg.vector_norm(gc))
        if not rel <= 1e-4:
            raise AssertionError(f"{shape.name} grad {n}: relative L2 "
                                 f"error {rel:.3e}")
        worst = max(worst, rel)
    print(f"  {shape.name}: loss card {float(loss_g.detach()):.7f} cpu "
          f"{float(loss_c.detach()):.7f}; {n_flip} rows flip a ReLU or "
          f"norm clamp, {int(hit.sum())} of {hit.numel()} left out of the "
          f"gradients; "
          f"{len(names)} gradients agree (worst relative L2 error "
          f"{worst:.3e})")


def phase_gnn_full_model(arch):
    """graphsage-reddit at its published widths on full_graph_sm (the
    whole Cora-sized graph, 1,433 features) and on a molecule batch
    (128 graphs): loss and gradients on the card against the CPU
    (_check_full_model); and the max aggregator's forward at
    full_graph_sm, where isolated nodes send -inf and then NaN on, within
    rtol 1e-5 / atol 1e-6 with NaN and inf in the same places. None of
    the port's kernels runs on these paths."""
    import numpy as np
    import torch
    from repro_torch.data.graphs import full_graph_batch, molecule_batch
    from repro_torch.kernels import ops
    from repro_torch.models import gnn

    cfg = arch.model
    full = arch.shape("full_graph_sm")
    mol = arch.shape("molecule")
    full_np = full_graph_batch(full, cfg.n_classes, np.random.RandomState(0))
    ops.reset_launch_counts()
    _check_full_model(gnn, cfg, full, full_np)
    _check_full_model(gnn, cfg, mol, molecule_batch(
        mol, cfg.n_classes, np.random.RandomState(0)))
    max_cfg = cfg.replace(aggregator="max")
    outs = []
    for dev in ("cpu", "cuda"):
        model = gnn.init_params(max_cfg, full.d_feat, seed=0,
                                device="cpu").to(dev)
        b = {k: torch.from_numpy(v).to(dev) for k, v in full_np.items()}
        with torch.no_grad():
            outs.append(gnn.full_graph_forward(
                model, b["x"], gnn.graph_plan(b["edge_src"], b["edge_dst"],
                                              full.n_nodes)).cpu())
    want, got = outs
    for name, f in (("NaN", torch.isnan), ("inf", torch.isinf)):
        if not torch.equal(f(got), f(want)):
            raise AssertionError(f"max forward: {name} in other places "
                                 f"on the card")
    ok = torch.isfinite(want)
    err = _allclose("max forward", got[ok], want[ok], 1e-5, 1e-6)
    counts = ops.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"a kernel ran on the full-graph path: "
                             f"{counts}")
    print(f"  max aggregator at {full.name}: logits agree (max abs err "
          f"{err:.3e}); {int(torch.isnan(want).any(dim=1).sum())} of "
          f"{full.n_nodes} nodes NaN on both (isolated nodes' -inf sent "
          f"on)")


def phase_gnn_full_graph(arch) -> dict:
    """graphsage-reddit at ogb_products (2,449,029 nodes, 61,859,140
    edges, 100 features) at its published widths: builds the graph (host
    seconds printed); holds layer 1's chunked aggregate against one
    index_add_ over every edge at once on the card (a 24.7 GB message
    tensor, freed after) within rtol 1e-5 / atol 1e-6, atomics adding in
    another order; runs the generic driver for GNN_FULL_STEPS full-batch
    steps (loss finite and falling, peak device memory under one (E, 128)
    f32 message tensor, no kernel launched); profiles one train step."""
    import numpy as np
    import torch
    from repro_torch.data.graphs import full_graph_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import gnn, segment
    from repro_torch.train.optim import make_optimizer
    from repro_torch.train.train_step import make_train_step

    cfg, shape = arch.model, arch.shape("ogb_products")
    n, e = shape.n_nodes, shape.n_edges
    t0 = time.monotonic()
    graph = full_graph_batch(shape, cfg.n_classes, np.random.RandomState(0))
    print(f"  graph: {n} nodes, {e} edges padded to "
          f"{graph['edge_src'].shape[0]}, x {graph['x'].shape} "
          f"({graph['x'].nbytes / 1e9:.2f} GB) built in "
          f"{time.monotonic() - t0:.1f} s on the host")

    dev = torch.device("cuda")
    x = torch.from_numpy(graph["x"]).to(dev)
    src = torch.from_numpy(graph["edge_src"]).to(dev)
    dst = torch.from_numpy(graph["edge_dst"]).to(dev)
    plan = gnn.graph_plan(src, dst, n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    chunked = segment.segment_sum(x, plan) \
        / torch.clamp(plan.count, min=1.0)[:, None]
    torch.cuda.synchronize()
    t_chunked = time.monotonic() - t0
    t0 = time.monotonic()
    msg = x.index_select(0, src[:e])
    one_shot = torch.zeros_like(x).index_add_(0, dst[:e], msg)
    del msg
    deg = torch.bincount(dst[:e], minlength=n).clamp(min=1)
    one_shot /= deg[:, None].float()
    torch.cuda.synchronize()
    t_once = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    err = _allclose("ogb_products layer-1 aggregate", chunked, one_shot,
                    1e-5, 1e-6)
    print(f"  layer-1 mean aggregate, chunked ({segment.CHUNK_PAIRS} pairs "
          f"a chunk) against one index_add_: max abs err {err:.3e}; "
          f"{t_chunked * 1e3:.1f} ms against {t_once * 1e3:.1f} ms (host "
          f"clock, synchronised); the check's peak "
          f"{peak / 1e9:.2f} GB")
    del x, src, dst, plan, chunked, one_shot, deg
    torch.cuda.empty_cache()

    ops.reset_launch_counts()
    res = train.run("graphsage-reddit", steps=GNN_FULL_STEPS, shape=shape,
                    full=True, device="cuda", graph=graph, log_every=1)
    counts = ops.launch_counts()
    losses = res["losses"]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"ogb_products loss not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"ogb_products loss did not fall: {losses}")
    if res["max_memory_allocated"] >= MESSAGE_BYTES:
        raise AssertionError(
            f"ogb_products peak {res['max_memory_allocated'] / 1e9:.2f} GB "
            f"reaches one (E, 128) f32 message tensor, "
            f"{MESSAGE_BYTES / 1e9:.2f} GB")
    if any(counts.values()):
        raise AssertionError(f"a kernel ran on the full-graph path: "
                             f"{counts}")
    summary = {k: res[k] for k in ("nodes_per_s", "loop_step_s",
                                   "train_step_s", "max_memory_allocated")}
    summary.update(loss_first=losses[0], loss_last=losses[-1],
                   peak_gb=res["max_memory_allocated"] / 1e9)
    print("  gnn_full_graph " + json.dumps(summary))
    torch.cuda.empty_cache()

    model = gnn.init_params(cfg, shape.d_feat, seed=0, device=dev)
    opt = make_optimizer("adam", lr=1e-3)
    state = opt.init(dict(model.named_parameters()))
    step_fn = make_train_step(gnn.full_graph_loss, opt)
    batch = {k: torch.from_numpy(graph[k]).to(dev) for k in ("x", "labels")}
    batch["plan"] = gnn.graph_plan(
        torch.from_numpy(graph["edge_src"]).to(dev),
        torch.from_numpy(graph["edge_dst"]).to(dev), n)
    del graph
    step_fn(model, state, 0, batch)
    torch.cuda.synchronize()
    rows, wall_ms = profile_steps(
        lambda k: step_fn(model, state, 1 + k, batch), 1)
    device_ms = sum(ms for _, ms in rows)
    print(f"  ogb_products train step: {device_ms:.3f} ms of device time in "
          f"{wall_ms:.3f} ms of host-clock time (profiled)")
    for name, ms in rows[:12]:
        print(f"    {ms:9.4f} ms  {100 * ms / device_ms:5.1f}%  {name[:90]}")
    return summary


def phase_gnn_molecule(arch) -> dict:
    """The generic driver at molecule (128 graphs of up to 30 nodes and 64
    edges a batch, published widths) for MOLECULE_STEPS steps: loss
    finite, no kernel launched; graphs/s and peak memory."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    ops.reset_launch_counts()
    res = train.run("graphsage-reddit", steps=MOLECULE_STEPS,
                    shape=arch.shape("molecule"), full=True, device="cuda",
                    log_every=5)
    counts = ops.launch_counts()
    if not all(math.isfinite(v) for v in res["losses"]):
        raise AssertionError(f"molecule loss not finite: {res['losses']}")
    if any(counts.values()):
        raise AssertionError(f"a kernel ran on the molecule path: {counts}")
    summary = {k: res[k] for k in ("graphs_per_s", "loop_step_s",
                                   "fetch_step_s", "train_step_s",
                                   "max_memory_allocated")}
    summary.update(loss_first=res["losses"][0], loss_last=res["losses"][-1])
    print("  gnn_molecule " + json.dumps(summary))
    torch.cuda.synchronize()
    return summary


def _criteo_batch(cfg, n, seed):
    """n synthetic Criteo records of the wide-deep widths through the
    driver's online feature work (numpy, on the host)."""
    from repro_torch.data.synthetic import CriteoStream
    stream = CriteoStream(n_sparse=cfg.n_sparse, n_dense=cfg.n_dense,
                          vocab=cfg.vocab_sizes[0], multi_hot=cfg.multi_hot,
                          seed=seed)
    return stream.feature_udf(stream.raw_block(n))


def _check_fused(tables, ids, combiner, tag):
    """embedding_bag_fused_fwd, embedding_bag_fwd and the plain version:
    all bit-equal (or, with an out-of-range id, NaN in the same rows and
    bit-equal elsewhere)."""
    import torch
    from repro_torch.kernels import embedding_bag as eb, ref
    row = eb.embedding_bag_fwd(tables, ids, combiner)
    nan = torch.isnan(row)
    if not nan.any() and not torch.equal(
            row, ref.embedding_bag_fused_ref(tables, ids, combiner=combiner)):
        raise AssertionError(f"embedding_bag_fwd {tag} {combiner}: not "
                             f"bitwise equal to the plain version")
    got = eb.embedding_bag_fused_fwd(tables, ids, combiner)
    if not (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan], row[~nan])):
        raise AssertionError(f"embedding_bag_fused_fwd {tag} {combiner}: "
                             f"not bitwise equal to embedding_bag_fwd")
    return int(nan.any(dim=-1).sum())


def phase_recsys_kernels(cfg) -> dict:
    """embedding_bag_fused_fwd against embedding_bag_fwd and the plain
    version (bitwise) at the wide arm's shapes and at ragged ones;
    embedding_bag_fwd/_bwd against their plain versions at the train
    shape on the wide arm and the deep tables; then the fused kernel
    timed at the wide arm's train shape beside the row kernel, the plain
    version and F.embedding_bag, and embedding_bag_bwd timed at D = 1.
    Returns the fused kernel's record and the row kernels' errors on
    this path."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import embedding_bag as eb, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    n_f, rows = cfg.n_sparse, cfg.vocab_sizes[0]
    # the wide arm: (F, V) viewed as (F, V, 1), weights ~ 0.01 N(0, 1)
    wide = torch.empty((n_f, rows, 1), device=dev)
    wide.normal_(generator=gen).mul_(0.01)
    main = torch.as_tensor(_criteo_batch(cfg, 65536, 1)["sparse_ids"]) \
        .to(dev)
    serve = torch.as_tensor(_criteo_batch(cfg, 512, 2)["sparse_ids"]).to(dev)
    for combiner in ("sum", "mean"):
        _check_fused(wide, main, combiner, "train_batch (65536, 40, 4)")
        _check_fused(wide, serve, combiner, "serve_p99 (512, 40, 4)")
    for combiner in ("sum", "mean"):
        _check_fused(wide.to(torch.bfloat16), main, combiner,
                     "train_batch bf16")
    # ragged shapes, f32 and bf16 tables; the bf16 ones also 2- and 4-byte
    # aligned (a slice 1 or 2 elements into a larger buffer): every load
    # width of both kernels
    for f, v, d, b, bag in ((8, 512, 8, 4096, 4), (8, 512, 8, 37, 1),
                            (3, 1000, 5, 37, 16), (40, 4096, 1, 300, 16),
                            (6, 256, 32, 33, 3), (3, 1000, 10, 37, 3),
                            (26, 4096, 128, 37, 4)):
        buf = torch.randn(f * v * d + 2, device=dev, generator=gen)
        ids = torch.randint(0, v, (b, f, bag), device=dev, generator=gen,
                            dtype=torch.int32)
        for dtype, shift in ((torch.float32, 0), (torch.bfloat16, 0),
                             (torch.bfloat16, 1), (torch.bfloat16, 2)):
            tables = buf.to(dtype)[shift:shift + f * v * d].view(f, v, d)
            tag = f"({f},{v},{d}) b{b} bag{bag} {str(dtype)[6:]} +{shift}"
            for combiner in ("sum", "mean"):
                _check_fused(tables, ids, combiner, tag)
            bad = ids.clone()
            bad[b // 2, f - 1, 0] = v
            if _check_fused(tables, bad, "sum", f"{tag} out of range") != 1:
                raise AssertionError("an out-of-range id must poison "
                                     "exactly its own row")
    bad = serve.clone()
    bad[7, 3, 2] = -1
    if _check_fused(wide, bad, "sum", "serve_p99 out of range") != 1:
        raise AssertionError("an out-of-range id must poison exactly its "
                             "own row")
    print("  embedding_bag_fused_fwd bit-equal to embedding_bag_fwd and "
          "the plain version at every shape, f32 and bf16")

    # the row kernels at the path's train shape: the wide arm's D = 1
    # (262,144 ids a feature scattered over 2^20 rows) and the deep tables
    path_errs = _check_bag(wide, main, "sum", "wide arm train_batch")
    dim = cfg.embed_dim
    deep = torch.empty((n_f, rows, dim), device=dev)
    deep.normal_(generator=gen).mul_(0.01)
    for name, err in _check_bag(deep, main, "sum",
                                "deep tables train_batch").items():
        path_errs[name] = max(path_errs[name], err)
    torch.cuda.empty_cache()
    print(f"  embedding_bag_fwd/_bwd at (65536, 40, 4) x (40, 2^20, 1) and "
          f"x (40, 2^20, {cfg.embed_dim}): forward bit-equal, backward max "
          f"abs err {path_errs['embedding_bag_bwd']:.3e}")

    # timed at the train shape, cycling two id sets (84 MB) so the ids do
    # not sit in the 50 MB L2 from one launch to the next
    b, _, bag = main.shape
    sets = [(main,), (torch.as_tensor(_criteo_batch(cfg, 65536, 3)
                                      ["sparse_ids"]).to(dev),)]
    offs = (torch.arange(n_f, device=dev) * rows).view(1, n_f, 1)
    flat_sets = [((i.long() + offs).reshape(b * n_f, bag),) for (i,) in sets]
    uniq = int(torch.unique(flat_sets[0][0]).numel())
    print(f"  embedding_bag_fused_fwd plan: "
          f"{eb.fused_plan(b, n_f, rows, 1, bag)} (f32), "
          f"{eb.fused_plan(b, n_f, rows, 1, bag, 2)} (bf16); {uniq} "
          f"distinct rows of "
          f"{n_f * rows}")
    rec = None
    for dtype in (torch.float32, torch.bfloat16):
        table = wide.to(dtype)
        elem = table.element_size()
        # the 32-byte sectors the gathers touch (8 rows of f32, 16 of bf16)
        sectors = int(torch.unique(flat_sets[0][0] // (32 // elem)).numel())
        r = kernel_record(
            f"embedding_bag_fused_fwd (65536, 40, 4) x (40, 2^20, 1) "
            f"{str(dtype)[6:]}",
            time_ms(lambda i: eb.embedding_bag_fused_fwd(table, i), sets,
                    kernel="embedding_bag_fused_fwd_kernel"),
            time_ms(lambda i: ref.embedding_bag_fused_ref(table, i), sets),
            time_ms(lambda x: F.embedding_bag(x, table.view(n_f * rows, 1),
                                              mode="sum"), flat_sets),
            cost_bound("bag_fwd", b, n_f, bag, rows, 1, elem, uniq), 0.0,
            embedding_bag_fwd_ms=time_ms(
                lambda i: eb.embedding_bag_fwd(table, i), sets,
                kernel="embedding_bag_fwd_kernel").ms,
            distinct_rows=uniq, sectors=sectors,
            sector_bound_ms=bound_ms(main.numel() * 4 + sectors * 32
                                     + b * n_f * 4, 0)[0])
        print(f"    {sectors} sectors of 32 B touched: sector bound "
              f"{r['sector_bound_ms']:.4f} ms; embedding_bag_fwd "
              f"{r['embedding_bag_fwd_ms']:.4f} ms")
        if rec is None:
            rec = r
        else:
            rec["bf16"] = r
        del table

    # embedding_bag_bwd at the wide arm's D = 1 (checked above; here grad
    # piles up over the timed calls, which changes no memory traffic)
    d_out = torch.randn((b, n_f, 1), device=dev, generator=gen)
    grad = torch.zeros_like(wide)
    t = time_ms(lambda: eb.embedding_bag_scatter(d_out, main, grad), [()],
                kernel="embedding_bag_bwd_kernel")
    plain = time_ms(lambda: ref.embedding_bag_bwd_ref(d_out, main, rows),
                    [()])
    upd = d_out.expand(b, n_f, bag).reshape(-1, 1).contiguous()
    idx = flat_sets[0][0].reshape(-1)
    lib = time_ms(lambda: grad.view(n_f * rows, 1).index_add_(0, idx, upd),
                  [()])
    rec["embedding_bag_bwd_d1"] = kernel_record(
        "embedding_bag_bwd at D = 1 (wide arm)", t, plain, lib,
        cost_bound("bag_bwd", b, n_f, bag, rows, 1, 4, uniq),
        path_errs["embedding_bag_bwd"])
    del grad, upd
    torch.cuda.empty_cache()

    # the deep tables (D = 32) with the same ids: embedding_bag_fwd against
    # F.embedding_bag over the flattened (F*V, 32) table, embedding_bag_bwd
    # against index_add_ into a (F*V, 32) gradient
    deep_flat = deep.view(n_f * rows, dim)
    print(f"  embedding_bag_fwd plan: {eb.fwd_plan(b, n_f, dim)} (f32), "
          f"{eb.fwd_plan(b, n_f, dim, 2)} (bf16)")
    rec["embedding_bag_fwd_d32"] = kernel_record(
        "embedding_bag_fwd at D = 32 (deep tables)",
        time_ms(lambda i: eb.embedding_bag_fwd(deep, i), sets,
                kernel="embedding_bag_fwd_kernel"),
        time_ms(lambda i: ref.embedding_bag_ref(deep, i), sets, iters=5),
        time_ms(lambda x: F.embedding_bag(x, deep_flat, mode="sum"),
                flat_sets),
        cost_bound("bag_fwd", b, n_f, bag, rows, dim, 4, uniq), 0.0)
    # the deep tables in bf16 (the same values, rounded): bitwise to the
    # plain version; bound at 2-byte elements
    deep16 = deep.to(torch.bfloat16)
    if not torch.equal(eb.embedding_bag_fwd(deep16, main),
                       ref.embedding_bag_ref(deep16, main)):
        raise AssertionError("embedding_bag_fwd bf16 deep arm: not bitwise "
                             "equal to the plain version")
    deep16_flat = deep16.view(n_f * rows, dim)
    rec["embedding_bag_fwd_d32"]["bf16"] = kernel_record(
        "embedding_bag_fwd at D = 32 (deep tables) bf16",
        time_ms(lambda i: eb.embedding_bag_fwd(deep16, i), sets,
                kernel="embedding_bag_fwd_kernel"),
        time_ms(lambda i: ref.embedding_bag_ref(deep16, i), sets, iters=5),
        time_ms(lambda x: F.embedding_bag(x, deep16_flat, mode="sum"),
                flat_sets),
        cost_bound("bag_fwd", b, n_f, bag, rows, dim, 2, uniq), 0.0)
    del deep16, deep16_flat
    d_out = torch.randn((b, n_f, dim), device=dev, generator=gen)
    grad = torch.zeros_like(deep)
    del deep, deep_flat
    t = time_ms(lambda: eb.embedding_bag_scatter(d_out, main, grad), [()],
                kernel="embedding_bag_bwd_kernel")
    plain = time_ms(lambda: ref.embedding_bag_bwd_ref(d_out, main, rows),
                    [()], iters=3)
    torch.cuda.empty_cache()
    upd = d_out[:, :, None, :].expand(b, n_f, bag, dim).reshape(-1, dim) \
        .contiguous()
    lib = time_ms(lambda: grad.view(n_f * rows, dim).index_add_(
        0, idx, upd), [()])
    rec["embedding_bag_bwd_d32"] = kernel_record(
        "embedding_bag_bwd at D = 32 (deep tables)", t, plain, lib,
        cost_bound("bag_bwd", b, n_f, bag, rows, dim, 4, uniq),
        path_errs["embedding_bag_bwd"])
    del grad, upd, d_out
    torch.cuda.empty_cache()
    return {"embedding_bag_fused_fwd": rec}, path_errs


def phase_recsys_model(cfg):
    """wide-deep's loss and gradients through the kernels vs the plain
    versions on the card, same parameters and batch, published widths,
    batch 4096. As in phase_model, samples whose MLP pre-activations take
    the other side of a ReLU on one path are given loss weight 0; every
    gradient of the others' loss must agree within 1e-4 of its L2 norm,
    and the full-batch loss within rtol 1e-5."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import recsys

    dev = torch.device("cuda")
    model = recsys.init_model(cfg, seed=0, device=dev)
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in _criteo_batch(cfg, 4096, 4).items()}
    names, params = zip(*model.named_parameters())
    preacts = []
    for lin in list(model.mlp)[:-1]:
        lin.register_forward_hook(lambda m, i, o: preacts.append(o.detach()))

    def per_sample_loss(**kw):
        z = model(batch, **kw)
        y = batch["label"].float()
        return torch.clamp(z, min=0) - z * y \
            + torch.log1p(torch.exp(-torch.abs(z)))

    ops.reset_launch_counts()
    loss_k = per_sample_loss()
    n_hooked = len(preacts)
    loss_p = per_sample_loss(bag_fn=ref.embedding_bag_fused_ref)
    flips = torch.zeros_like(loss_k, dtype=torch.bool)
    for a, b in zip(preacts[:n_hooked], preacts[n_hooked:]):
        flips |= ((a > 0) != (b > 0)).any(dim=1)
    n_flip = int(flips.sum())
    if n_flip > loss_k.numel() // 100:
        raise AssertionError(f"{n_flip} samples flip a ReLU between the "
                             f"two paths")
    if not bool(torch.isfinite(loss_k).all()):
        raise AssertionError("wide-deep loss not finite")
    _allclose("wide-deep loss", loss_k.mean(), loss_p.mean(), 1e-5, 0.0)
    keep = (~flips).float() / float((~flips).sum())
    grads_k = torch.autograd.grad((loss_k * keep).sum(), params)
    counts = {k: ops.launch_counts()[k] for k in RECSYS_KERNELS}
    if counts["embedding_bag_fused_fwd"] < 1 or \
            counts["embedding_bag_fwd"] < 1 or counts["embedding_bag_bwd"] < 2:
        raise AssertionError(f"wide-deep pass skipped a kernel: {counts}")
    worst = 0.0
    for n, gk, gp in zip(names, grads_k, torch.autograd.grad(
            (loss_p * keep).sum(), params)):
        rel = float(torch.linalg.vector_norm(gk - gp)
                    / torch.linalg.vector_norm(gp))
        if not rel <= 1e-4:
            raise AssertionError(f"wide-deep grad {n}: relative L2 error "
                                 f"{rel:.3e}")
        worst = max(worst, rel)
    print(f"  loss kernels {float(loss_k.detach().mean()):.7f} plain "
          f"{float(loss_p.detach().mean()):.7f}; {n_flip} of {loss_k.numel()} "
          f"samples flip a ReLU and are left out of the gradients; "
          f"{len(names)} gradients agree (worst relative L2 error "
          f"{worst:.3e}); launches {counts}")


def phase_recsys_loop(arch) -> dict:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    ops.reset_launch_counts()
    res = train.run("wide-deep", steps=RECSYS_STEPS, full=True,
                    shape=arch.shape("train_batch"), device="cuda",
                    log_every=5)
    counts = {k: ops.launch_counts()[k] for k in RECSYS_KERNELS}
    if not all(math.isfinite(x) for x in res["losses"]):
        raise AssertionError(f"wide-deep loss not finite: {res['losses']}")
    short = {k: n for k, n in counts.items() if n < RECSYS_STEPS}
    if short:
        raise AssertionError(f"kernels launched fewer than {RECSYS_STEPS} "
                             f"times on the wide-deep path: {short}")
    summary = {k: res[k] for k in ("samples_per_s", "loop_step_s",
                                   "fetch_step_s", "train_step_s",
                                   "max_memory_allocated")}
    summary["loss_first"], summary["loss_last"] = res["losses"][0], \
        res["losses"][-1]
    summary["launches"] = counts
    print("  recsys_loop " + json.dumps(summary))
    torch.cuda.synchronize()
    return counts


def phase_recsys_profile(arch):
    """Where one wide-deep train step's device time goes: torch.profiler
    over 3 steps on one batch already on the card (after 2 warm-up
    steps), device time summed by kernel, against the host-clock step.
    Returns each embedding kernel's device ms a step."""
    import torch
    from repro_torch.models import recsys
    from repro_torch.train.optim import make_optimizer
    from repro_torch.train.train_step import make_train_step

    dev = torch.device("cuda")
    cfg = arch.model
    model = recsys.init_model(cfg, seed=0, device=dev)
    opt = make_optimizer(arch.optimizer, lr=1e-3)
    state = opt.init(dict(model.named_parameters()))
    step_fn = make_train_step(recsys.ctr_loss, opt)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in _criteo_batch(
        cfg, arch.shape("train_batch").batch, 6).items()}
    for k in range(2):
        step_fn(model, state, k, batch)
    torch.cuda.synchronize()
    rows, wall_ms = profile_steps(
        lambda k: step_fn(model, state, 2 + k, batch), 3,
        ("embedding_bag_fused_fwd_kernel", "embedding_bag_fwd_kernel",
         "embedding_bag_bwd_kernel"))
    device_ms = sum(ms for _, ms in rows)
    bag_ms = sum(ms for name, ms in rows if "embedding_bag" in name)
    print(f"  wide-deep train step: {device_ms:.3f} ms of device time in "
          f"{wall_ms:.3f} ms of host-clock time (profiled); embedding_bag "
          f"kernels {bag_ms:.3f} ms ({100 * bag_ms / device_ms:.1f}%)")
    for name, ms in rows[:14]:
        print(f"    {ms:9.4f} ms  {100 * ms / device_ms:5.1f}%  {name[:90]}")
    # the embedding kernels in the step: the scatter's <false, 4> is the
    # wide arm's D = 1, <true, 4> the deep tables' D = 32 (float4
    # atomics); the fused forward is the wide arm's
    in_step = {}
    for name, ms in rows:
        for kernel in ("embedding_bag_bwd_kernel",
                       "embedding_bag_fused_fwd_kernel",
                       "embedding_bag_fwd_kernel"):
            if kernel in name:
                print(f"  {kernel[:-7]} in the step: {ms:.4f} ms  "
                      f"{name[:70]}")
                in_step[kernel[:-7]] = in_step.get(kernel[:-7], 0.0) + ms
    return in_step


# ---- slice 8: the reference DLRM (bf16, row-wise adagrad) -------------

def _bf16_ulp(x):
    """One bf16 ulp at |x| (2^-7 of its power of two), elementwise; the
    smallest normal's at 0."""
    import torch
    x = x.abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(x)) - 7)


def _check_scatter_bf16(d_out, ids, v, combiner, tag) -> tuple:
    """embedding_bag_bwd into a bf16 gradient against its plain version
    (f32 sums rounded once), over the rows the ids touch (no f32
    temporary of the table's size): bitwise on every row that one bag
    slot names; a row that n slots name within 2 bf16 ulps of the sum of
    its terms' magnitudes a slot, plus 2 (each bf16 atomic rounds the
    row's running sum, in an order that varies between runs); every
    other row 0. Returns (max error in bf16 ulps of that sum, the largest
    tolerance used in the same unit, rows touched once, rows touched
    more than once)."""
    import torch
    from repro_torch.kernels import embedding_bag as eb, ref
    b, f, bag = ids.shape
    d = d_out.shape[-1]
    got = eb.embedding_bag_bwd(d_out, ids, v, combiner,
                               dtype=torch.bfloat16)
    if got.dtype != torch.bfloat16:
        raise AssertionError(f"embedding_bag_bwd bf16 {tag}: {got.dtype}")
    flat = (torch.arange(f, device=ids.device).view(1, f, 1) * v
            + ids.long()).reshape(-1)
    rows, slot, touches = torch.unique(flat, return_inverse=True,
                                       return_counts=True)
    g = d_out.float()
    if combiner == "mean":
        g = g / torch.full((), bag, dtype=g.dtype, device=g.device)
    mag = torch.zeros((rows.numel(), d), device=g.device)
    mag.index_add_(0, slot, g.abs()[:, :, None, :].expand(b, f, bag, d)
                   .reshape(-1, d))
    nonzero = sum(int(torch.count_nonzero(got[i])) for i in range(f))
    got_rows = got.view(-1, d)[rows]
    del got
    want = ref.embedding_bag_bwd_ref(d_out, ids, v, combiner=combiner,
                                     dtype=torch.bfloat16).view(-1, d)[rows]
    once = touches == 1
    if not torch.equal(got_rows[once], want[once]):
        raise AssertionError(f"embedding_bag_bwd bf16 {tag} {combiner}: a "
                             f"row touched once is not bitwise the plain "
                             f"version")
    if nonzero != int(torch.count_nonzero(got_rows)):
        raise AssertionError(f"embedding_bag_bwd bf16 {tag} {combiner}: "
                             f"writes outside the rows its ids name")
    ulps = (got_rows.float() - want.float()).abs() / _bf16_ulp(mag)
    tol = 2.0 * (touches + 1).view(-1, 1).float()
    if bool((ulps > tol).any()):
        raise AssertionError(f"embedding_bag_bwd bf16 {tag} {combiner}: "
                             f"{int((ulps > tol).sum())} elements off, max "
                             f"{float(ulps.max()):.2f} ulps")
    return (float(ulps.max()) if ulps.numel() else 0.0,
            float(tol.max()) if tol.numel() else 0.0, int(once.sum()),
            int((~once).sum()))


def _check_dot_bf16(d_out, feats, tag) -> tuple:
    """dot_interact_bwd with bf16 d_out and feats against its plain
    version (f32 sums rounded once) within 2 bf16 ulps (rtol 2^-7, atol
    1e-5). Returns (max abs error, max error in bf16 ulps of the plain
    value)."""
    from repro_torch.kernels import dot_interact as di, ref
    got = di.dot_interact_bwd(d_out, feats)
    want = ref.dot_interact_bwd_ref(d_out, feats)
    err = _allclose(f"dot_interact_bwd bf16 {tag}", got.float(),
                    want.float(), BF16_RTOL, 1e-5)
    ulps = float(((got.float() - want.float()).abs()
                  / _bf16_ulp(want.float())).max())
    return err, ulps


def phase_dlrm_bf16_bwd(arch) -> dict:
    """The two DLRM backward kernels with bf16 gradients against their
    plain versions on the card, at the training shapes of dlrm-criteo
    (ids (65536, 26, 1) of the synthetic Criteo stream into (26, 2^22,
    128) bf16 tables; the interaction at (65536, 27, 128)) and at ragged
    ones (odd B, D % 8 != 0, a table of 29 rows so that ids repeat, bags
    of 4 padded by their head id, d_out or feats off a 16- or 4-byte
    boundary); and the two bf16 forwards at the same training shapes
    (embedding_bag_fwd bitwise, dot_interact_fwd within 2 bf16 ulps).
    Each of the four is timed at the training shapes beside its plain
    version, its bound and one PyTorch call (F.embedding_bag on the bf16
    table; index_add_ into the bf16 gradient; bmm in bf16, and for the
    forward its lower triangle gathered). Returns the four bf16 records
    at the training shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import dot_interact as di
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(8)
    cfg = arch.model
    worst = {"scatter": [0.0, 0.0], "dot": [0.0, 0.0]}

    def note(kind, e):
        worst[kind] = [max(a, b) for a, b in zip(worst[kind], e)]

    # ragged
    for b, f, v, d, bag in ((301, 3, 29, 5, 1), (301, 3, 29, 128, 4),
                            (37, 5, 4096, 12, 4), (1, 2, 29, 8, 17)):
        ids = torch.randint(0, v, (b, f, bag), device=dev, generator=gen)
        ids[..., bag // 2:] = ids[..., :1]
        ids = ids.to(torch.int32)
        buf = torch.randn(b * f * d + 1, device=dev, generator=gen)
        for shift in (0, 1):
            d_out = buf[shift:shift + b * f * d].view(b, f, d)
            for combiner in ("sum", "mean"):
                note("scatter", _check_scatter_bf16(
                    d_out, ids, v, combiner,
                    f"({b},{f},{v},{d}) bag{bag} +{4 * shift} B")[:2])
    for b, f, d in ((2051, 27, 10), (37, 27, 7), (301, 5, 12), (1, 2, 4),
                    (2051, 27, 128), (3, 60, 32)):
        p = f * (f - 1) // 2
        xb = torch.randn(b * f * d + 2, device=dev, generator=gen).to(bf16)
        gb = torch.randn(b * p + 1, device=dev, generator=gen).to(bf16)
        for shift in (0, 1, 2):
            for gshift in (0, 1):
                note("dot", _check_dot_bf16(
                    gb[gshift:gshift + b * p].view(b, p),
                    xb[shift:shift + b * f * d].view(b, f, d),
                    f"({b},{f},{d}) feats +{2 * shift} B d_out "
                    f"+{2 * gshift} B"))
    print(f"  ragged: scatter max {worst['scatter'][0]:.2f} bf16 ulps "
          f"(tolerance up to {worst['scatter'][1]:.0f}), interaction max "
          f"abs err {worst['dot'][0]:.3e}, {worst['dot'][1]:.2f} ulps")

    # the training shapes
    n_f, rows, dim = cfg.n_sparse, cfg.vocab_sizes[0], cfg.embed_dim
    batch = arch.shape("train_batch").batch
    ids = torch.as_tensor(_criteo_batch(cfg, batch, 9)["sparse_ids"]) \
        .to(dev)
    b, _, bag = ids.shape
    d_out = torch.randn((b, n_f, dim), device=dev, generator=gen) \
        .to(bf16).float()
    e_ulps, tol, once, more = _check_scatter_bf16(d_out, ids, rows, "sum",
                                                  "main")
    print(f"  embedding_bag_bwd bf16 at ({b}, {n_f}, {bag}) into ({n_f}, "
          f"{rows}, {dim}): {once} rows touched once (bitwise), {more} "
          f"more than once; max {e_ulps:.2f} bf16 ulps (tolerance up to "
          f"{tol:.0f}); ragged max {worst['scatter'][0]:.2f}")
    torch.cuda.empty_cache()
    flat = (ids.long() + (torch.arange(n_f, device=dev) * rows)
            .view(1, n_f, 1)).reshape(-1)
    uniq = int(torch.unique(flat).numel())

    # embedding_bag_fwd on a bf16 table of the reference's size, bitwise
    # to its plain version; the same 27.9 GB then holds the scatter's
    # gradient
    tables = torch.empty((n_f, rows, dim), dtype=bf16, device=dev)
    tables.normal_(generator=gen).mul_(dim ** -0.5)
    if not torch.equal(eb.embedding_bag_fwd(tables, ids),
                       ref.embedding_bag_ref(tables, ids)):
        raise AssertionError(f"embedding_bag_fwd bf16 at ({b}, {n_f}, {bag}) "
                             f"into ({n_f}, {rows}, {dim}): not bitwise "
                             f"equal to the plain version")
    print(f"  embedding_bag_fwd bf16 at ({b}, {n_f}, {bag}) into ({n_f}, "
          f"{rows}, {dim}): bitwise to the plain version; plan "
          f"{eb.fwd_plan(b, n_f, dim, 2)}")
    bags, table_flat = flat.view(b * n_f, bag), tables.view(n_f * rows, dim)
    recs = {"embedding_bag_fwd": kernel_record(
        "embedding_bag_fwd bf16",
        time_ms(lambda: eb.embedding_bag_fwd(tables, ids), [()],
                kernel="embedding_bag_fwd_kernel"),
        time_ms(lambda: ref.embedding_bag_ref(tables, ids), [()]),
        time_ms(lambda: F.embedding_bag(bags, table_flat, mode="sum"),
                [()]),
        cost_bound("bag_fwd", b, n_f, bag, rows, dim, 2, uniq), 0.0,
        shape=[b, n_f, bag, rows, dim])}
    del table_flat
    grad = tables.zero_()
    del tables
    plan = eb.bwd_plan(b, n_f, rows, dim, 0, 2)
    print(f"  embedding_bag_bwd bf16 plan: {plan}")
    t = time_ms(lambda: eb.embedding_bag_scatter(d_out, ids, grad), [()],
                kernel="embedding_bag_bwd_kernel")
    zero_ms = time_ms(lambda: grad.zero_(), [()], iters=5).ms
    plain = time_ms(lambda: ref.embedding_bag_bwd_ref(
        d_out, ids, rows, dtype=bf16), [()], iters=3)
    upd = d_out.to(bf16)[:, :, None, :].expand(b, n_f, bag, dim) \
        .reshape(-1, dim).contiguous()
    grad_flat = grad.view(n_f * rows, dim)
    lib = time_ms(lambda: grad_flat.index_add_(0, flat, upd), [()])
    del grad, grad_flat, upd
    torch.cuda.empty_cache()
    recs["embedding_bag_bwd"] = kernel_record(
        "embedding_bag_bwd bf16", t, plain, lib,
        cost_bound("bag_bwd", b, n_f, bag, rows, dim, 2, uniq), 0.0,
        max_ulps=max(e_ulps, worst["scatter"][0]), zero_fill_ms=zero_ms,
        shape=[b, n_f, bag, rows, dim])
    del d_out, ids

    fs = [(torch.randn((b, n_f + 1, dim), device=dev, generator=gen)
           .to(bf16),) for _ in range(3)]
    n_pairs = (n_f + 1) * n_f // 2
    ii, jj = ref.tril_pairs(n_f + 1, dev)
    err = max(_allclose("dot_interact_fwd bf16 main", di.dot_interact_fwd(x),
                        ref.dot_interact_ref(x), BF16_RTOL, 1e-4)
              for (x,) in fs)
    print(f"  dot_interact_fwd bf16 at ({b}, {n_f + 1}, {dim}): max abs err "
          f"{err:.3e}; plan {di.fwd_plan(b, n_f + 1, dim, 2)}")
    recs["dot_interact_fwd"] = kernel_record(
        "dot_interact_fwd bf16",
        time_ms(di.dot_interact_fwd, fs, kernel="dot_interact_fwd_kernel"),
        time_ms(ref.dot_interact_ref, fs),
        time_ms(lambda x: torch.bmm(x, x.transpose(1, 2))[:, ii, jj], fs),
        cost_bound("dot_fwd", b, n_f + 1, dim, 2), err,
        shape=[b, n_f + 1, dim])
    gs = [(torch.randn((b, n_pairs), device=dev, generator=gen).to(bf16), x)
          for (x,) in fs]
    err, ulps = _check_dot_bf16(*gs[0], "main")
    print(f"  dot_interact_bwd bf16 at ({b}, {n_f + 1}, {dim}): max abs err "
          f"{err:.3e}, {ulps:.2f} bf16 ulps; plan "
          f"{di.bwd_plan(b, n_f + 1, dim, 0, 2)}")
    sym = []
    for g, x in gs:
        s = torch.zeros((b, n_f + 1, n_f + 1), device=dev, dtype=bf16)
        s[:, ii, jj] = g
        sym.append((s + s.transpose(1, 2), x))
    recs["dot_interact_bwd"] = kernel_record(
        "dot_interact_bwd bf16",
        time_ms(di.dot_interact_bwd, gs, kernel="dot_interact_bwd_kernel"),
        time_ms(ref.dot_interact_bwd_ref, gs),
        time_ms(torch.bmm, sym),
        cost_bound("dot_bwd", b, n_f + 1, dim, 2),
        max(err, worst["dot"][0]), max_ulps=max(ulps, worst["dot"][1]),
        shape=[b, n_f + 1, dim])
    # the f32 kernel at the same shape, the path a bf16 input took before
    # the kernel took bf16 (its casts aside)
    del sym
    fs32 = [(g.float(), x.float()) for g, x in gs]
    f32 = time_ms(di.dot_interact_bwd, fs32, kernel="dot_interact_bwd_kernel")
    recs["dot_interact_bwd"]["f32_ms"] = f32.ms
    f32_bound = cost_bound("dot_bwd", b, n_f + 1, dim, 4)[0]
    print(f"  dot_interact_bwd f32 at ({b}, {n_f + 1}, {dim}): {f32.ms:.4f} "
          f"ms on the card ({f32.events} events), bound {f32_bound:.4f} ms")
    return recs


def phase_dlrm_model_bf16(arch):
    """The bf16 DLRM (the reference configuration at 2^16 rows a table,
    batch 4096 of the Criteo stream) through the kernels against the same
    model through the plain versions: as in phase_model, samples whose
    MLP pre-activations take the other side of a ReLU on one path (at
    most 5%: the two paths' bf16 activations differ by an ulp here and
    there) get loss weight 0; the loss within rtol 2^-8 (one bf16 ulp)
    and each gradient, bf16 on both paths, within 2^-6 of its L2 norm
    (four bf16 ulps)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import dlrm as dlrm_lib

    cfg = arch.model.replace(vocab_sizes=(1 << 16,) * arch.model.n_sparse)
    model = dlrm_lib.init_params(cfg, seed=0, device="cuda")
    batch = {k: torch.as_tensor(v).cuda()
             for k, v in _criteo_batch(cfg, 4096, 10).items()}
    names, params = zip(*model.named_parameters())
    preacts = []
    for lin in list(model.bottom) + list(model.top)[:-1]:
        lin.register_forward_hook(lambda m, i, o: preacts.append(o.detach()))

    def per_sample_loss(**kw):
        z = model(batch, **kw).float()
        y = batch["label"].float()
        return torch.clamp(z, min=0) - z * y \
            + torch.log1p(torch.exp(-torch.abs(z)))

    ops.reset_launch_counts()
    loss_k = per_sample_loss()
    n_hooked = len(preacts)
    loss_p = per_sample_loss(bag_fn=ref.embedding_bag_ref,
                             interact_fn=ref.dot_interact_ref)
    flips = torch.zeros_like(loss_k, dtype=torch.bool)
    for a, b in zip(preacts[:n_hooked], preacts[n_hooked:]):
        flips |= ((a > 0) != (b > 0)).any(dim=1)
    n_flip = int(flips.sum())
    if n_flip > loss_k.numel() // 20:
        raise AssertionError(f"{n_flip} samples flip a ReLU between the "
                             f"two bf16 paths")
    if not bool(torch.isfinite(loss_k).all()):
        raise AssertionError("bf16 model loss not finite")
    _allclose("bf16 model loss", loss_k.mean(), loss_p.mean(), 2.0 ** -8,
              0.0)
    keep = (~flips).float() / float((~flips).sum())
    grads_k = torch.autograd.grad((loss_k * keep).sum(), params)
    counts = {k: ops.launch_counts()[k] for k in DLRM_KERNELS}
    if min(counts.values()) < 1:
        raise AssertionError(f"bf16 model pass skipped a kernel: {counts}")
    worst = 0.0
    for n, gk, gp in zip(names, grads_k, torch.autograd.grad(
            (loss_p * keep).sum(), params)):
        if gk.dtype != torch.bfloat16 or gp.dtype != torch.bfloat16:
            raise AssertionError(f"grad {n}: {gk.dtype} / {gp.dtype}")
        rel = float(torch.linalg.vector_norm(gk.float() - gp.float())
                    / torch.linalg.vector_norm(gp.float()))
        if not rel <= 2.0 ** -6:
            raise AssertionError(f"bf16 grad {n}: relative L2 error "
                                 f"{rel:.3e}")
        worst = max(worst, rel)
    print(f"  bf16 loss kernels {float(loss_k.detach().mean()):.7f} plain "
          f"{float(loss_p.detach().mean()):.7f}; {n_flip} of "
          f"{loss_k.numel()} samples flip a ReLU and are left out of the "
          f"gradients; {len(names)} bf16 gradients agree (worst relative "
          f"L2 error {worst:.3e}); launches {counts}")


def phase_dlrm_driver(arch) -> dict:
    """The generic driver on the reference configuration: --arch
    dlrm-criteo --full --shape train_batch (26 x 2^22 x 128 bf16 tables,
    bf16 MLPs, row-wise adagrad, batch 65536) for DRIVER_STEPS steps at lr
    DRIVER_LR: the loss finite and falling (the last 5 steps' mean under
    the first 5's), peak device memory under the card's, each DLRM
    kernel launched at least once a step. Returns (the launch counts, the
    losses)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    ops.reset_launch_counts()
    res = train.run(arch.arch_id, steps=DRIVER_STEPS, full=True,
                    shape=arch.shape("train_batch"), device="cuda",
                    lr=DRIVER_LR, log_every=5, steps_json=STEPS_JSON)
    counts = {k: ops.launch_counts()[k] for k in DLRM_KERNELS}
    losses = res["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"dlrm-criteo loss not finite: {losses}")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    if not last < first:
        raise AssertionError(f"dlrm-criteo loss not falling: {losses}")
    peak = res["max_memory_allocated"]
    card = torch.cuda.get_device_properties(0).total_memory
    if not peak < min(card, CARD_BYTES):
        raise AssertionError(f"dlrm-criteo peak {peak / 1e9:.2f} GB")
    short = {k: n for k, n in counts.items() if n < DRIVER_STEPS}
    if short:
        raise AssertionError(f"kernels launched fewer than {DRIVER_STEPS} "
                             f"times on the dlrm-criteo path: {short}")
    summary = {k: res[k] for k in ("samples_per_s", "loop_step_s",
                                   "fetch_step_s", "train_step_s",
                                   "max_memory_allocated")}
    summary.update(loss_first5=first, loss_last5=last, losses=losses,
                   launches=counts)
    print("  dlrm_driver " + json.dumps(summary))
    torch.cuda.synchronize()
    return counts, losses


def phase_dlrm_driver_profile(arch):
    """One train step of the reference configuration under
    torch.profiler (3 steps on one batch on the card, after 2 warm-up
    steps): device time by kernel, the four DLRM kernels' launches in
    the window and their time in the step. Returns (the model, after the
    5 steps, for the retrieval phase; each DLRM kernel's device ms a
    step)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.train.optim import make_optimizer
    from repro_torch.train.train_step import make_train_step

    dev = torch.device("cuda")
    cfg = arch.model
    model = train.init_params_for(arch, cfg, 0, device=dev)
    opt = make_optimizer(arch.optimizer, lr=DRIVER_LR)
    state = opt.init(dict(model.named_parameters()))
    step_fn = make_train_step(train.make_loss_fn(arch, cfg), opt)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in _criteo_batch(
        cfg, arch.shape("train_batch").batch, 11).items()}
    for k in range(2):
        step_fn(model, state, k, batch)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    kernels = tuple(k + "_kernel" for k in DLRM_KERNELS)
    rows, wall_ms = profile_steps(
        lambda k: step_fn(model, state, 2 + k, batch), 3, kernels)
    launches = {k: ops.launch_counts()[k] for k in DLRM_KERNELS}
    device_ms = sum(ms for _, ms in rows)
    print(f"  dlrm-criteo train step: {device_ms:.3f} ms of device time in "
          f"{wall_ms:.3f} ms of host-clock time (profiled); launches in the "
          f"window (3 steps, each window taken at most {WINDOW_TRIES} "
          f"times) "
          f"{launches}")
    for name, ms in rows[:14]:
        print(f"    {ms:9.4f} ms  {100 * ms / device_ms:5.1f}%  {name[:90]}")
    in_step = {}
    for name, ms in rows:
        for k in kernels:
            if k + "<" in name or name.endswith(k):
                print(f"  {k[:-7]} in the step: {ms:.4f} ms  {name[:80]}")
                in_step[k[:-7]] = in_step.get(k[:-7], 0.0) + ms
    if set(in_step) != set(DLRM_KERNELS):
        raise AssertionError(f"profile misses a DLRM kernel: {in_step}")
    del state, opt
    return model, in_step


def phase_dlrm_retrieval(model, arch) -> dict:
    """score_candidates at retrieval_cand (one user, 1,000,000 candidates
    in 25 chunks) on the driver's bf16 model, through the kernels and
    through the plain versions: the scores finite, the two within 4 bf16
    ulps of the largest score; host-clock seconds of each (synchronised,
    after a warm-up call)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import dlrm as dlrm_lib

    cfg = model.cfg
    shape = arch.shape("retrieval_cand")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    user = {k: torch.as_tensor(v).to(dev)
            for k, v in _criteo_batch(cfg, shape.batch, 12).items()}
    cand = torch.randint(0, 2 ** 31 - 1, (shape.n_candidates,), device=dev,
                         generator=gen, dtype=torch.int32)
    plain_fns = dict(bag_fn=ref.embedding_bag_ref,
                     interact_fn=ref.dot_interact_ref)
    out = {}
    for tag, kw in (("kernels", {}), ("plain", plain_fns)):
        dlrm_lib.score_candidates(model, user, cand,
                                  chunks=RETRIEVAL_CHUNKS, **kw)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.monotonic()
        scores = dlrm_lib.score_candidates(model, user, cand,
                                           chunks=RETRIEVAL_CHUNKS, **kw)
        torch.cuda.synchronize()
        out[tag] = (scores, time.monotonic() - t0,
                    {k: n for k, n in ops.launch_counts().items() if n})
    (sk, tk, lk), (sp, tp, _) = out["kernels"], out["plain"]
    if sk.shape != (shape.n_candidates,) or sk.dtype != torch.bfloat16 \
            or not bool(torch.isfinite(sk).all()):
        raise AssertionError(f"retrieval scores {sk.shape} {sk.dtype}")
    if lk.get("dot_interact_fwd") != RETRIEVAL_CHUNKS \
            or lk.get("embedding_bag_fwd") != 1:
        raise AssertionError(f"retrieval launches {lk}")
    err = float((sk.float() - sp.float()).abs().max())
    ulp = float(_bf16_ulp(sp.float().abs().max()))
    if not err <= 4 * ulp:
        raise AssertionError(f"retrieval scores off by {err:.3e} "
                             f"({err / ulp:.1f} bf16 ulps)")
    res = {"candidates": shape.n_candidates, "chunks": RETRIEVAL_CHUNKS,
           "kernels_s": tk, "plain_s": tp, "max_abs_err": err,
           "max_ulps": err / ulp, "launches": lk}
    print("  dlrm_retrieval " + json.dumps(res))
    return res


# ---- slice 16: the explicit collectives on torch.distributed -----------

# dlrm-criteo through the driver on a process group of one rank (NCCL on
# the card, world size 1: NCCL takes one rank a device), through the
# row-sharded lookup and the kernel's local-rows mode, DIST_STEPS steps at
# DRIVER_LR; its losses against the dlrm_driver phase's first DIST_STEPS
# at the same seed (stated before the first run): the first bit for bit
# (the same parameters, batch and forward: the local-rows mode at row0 0
# sums as the unsharded kernel does, and a sum over one rank is a copy),
# the others within rtol 1e-3 (the bf16 scatter's atomics round in
# another order on every run: ROADMAP queue 3)
DIST_STEPS = 5
DIST_LOSS_RTOL = 1e-3
DIST_PG_FILE = os.path.join(ROOT, "build", "chip_smoke_pg")
# the local-rows mode's shards: dlrm-criteo's whole table as one shard,
# and its second quarter (rows [2^20, 2^21) of 2^22), as a rank of a (1,
# 4) mesh holds it, the ids over all 2^22 rows
DIST_SHARDS = (("shard1", 0, 1 << 22), ("quarter", 1 << 20, 1 << 20))
DIST_KERNELS = ("embedding_bag_fwd_local", "embedding_bag_bwd_local")


def _scatter_rows_local(d_out, ids, row0, v_loc, dtype):
    """The local-rows scatter's plain sums over the rows the in-shard ids
    touch: (flat row ids, the sums rounded once to `dtype`, touches a
    row, the sum of its terms' magnitudes), the plain version's
    arithmetic (ref.embedding_bag_local_bwd_ref) without its dense
    gradient (55.8 GB in f32 at dlrm-criteo's table)."""
    import torch
    b, f, bag = ids.shape
    d = d_out.shape[-1]
    lid = ids.long() - row0
    ok = (lid >= 0) & (lid < v_loc)
    feat = torch.arange(f, device=ids.device).view(1, f, 1)
    flat = (feat * v_loc + lid)[ok]
    upd = d_out.float()[:, :, None, :].expand(b, f, bag, d)[ok]
    rows, slot, touches = torch.unique(flat, return_inverse=True,
                                       return_counts=True)
    sums = torch.zeros((rows.numel(), d), device=ids.device)
    sums.index_add_(0, slot, upd)
    mag = torch.zeros((rows.numel(), d), device=ids.device)
    mag.index_add_(0, slot, upd.abs())
    return rows, sums.to(dtype), touches, mag


def _check_local(tables, ids, row0, tag) -> dict:
    """The local-rows mode against its plain versions on the shard
    `tables` (rows [row0, row0 + V) of each feature): the forward bitwise
    (ids outside read 0); the scatter, with non-negative d_out, over the
    rows the in-shard ids touch: an f32 gradient within rtol max(1e-5,
    2 n 2^-24) of a row n ids name, a bf16 one bitwise on rows one slot
    names and within 2 (n + 1) bf16 ulps of its terms' magnitudes
    elsewhere (queue 3's notes); nothing written outside those rows. The
    gradient reuses the tables' memory. Returns the counts and errors."""
    import torch
    from repro_torch.kernels import embedding_bag as eb, ref
    f, v_loc, d = tables.shape
    dtype = tables.dtype
    got = eb.embedding_bag_fwd(tables, ids, "sum", row0=row0)
    want = ref.embedding_bag_local_ref(tables, ids, row0)
    if not torch.equal(got, want):
        raise AssertionError(f"embedding_bag_fwd local {tag} {dtype}: not "
                             f"bitwise equal to the plain version")
    lid = ids.long() - row0
    ok = (lid >= 0) & (lid < v_loc)
    inside = int(ok.sum())
    if ids.shape[-1] == 1 and bool((want[~ok[..., 0]] != 0).any()):
        raise AssertionError(f"local {tag}: an id outside the shard read "
                             f"a row")
    d_out = got.abs_()              # non-negative, the forward's shape
    del want
    grad = tables.zero_()
    eb.embedding_bag_scatter(d_out, ids, grad, "sum", row0=row0)
    rows, sums, touches, mag = _scatter_rows_local(d_out, ids, row0, v_loc,
                                                   dtype)
    got_rows = grad.view(-1, d)[rows]
    nonzero = sum(int(torch.count_nonzero(grad[i])) for i in range(f))
    if nonzero != int(torch.count_nonzero(got_rows)):
        raise AssertionError(f"embedding_bag_bwd local {tag} {dtype}: "
                             f"writes outside the rows its in-shard ids "
                             f"name")
    err = (got_rows.float() - sums.float()).abs()
    if dtype == torch.float32:
        rtol = torch.clamp(2 * touches.float() * 2.0 ** -24, min=1e-5)
        bad = err > 1e-6 + rtol[:, None] * sums.abs()
        worst = float(err.max()) if err.numel() else 0.0
    else:
        once = touches == 1
        if not torch.equal(got_rows[once], sums[once]):
            raise AssertionError(f"embedding_bag_bwd local {tag} bf16: a "
                                 f"row touched once is not bitwise the "
                                 f"plain version")
        ulps = err / _bf16_ulp(mag)
        bad = ulps > 2.0 * (touches + 1).view(-1, 1).float()
        worst = float(ulps.max()) if ulps.numel() else 0.0
    if bool(bad.any()):
        raise AssertionError(f"embedding_bag_bwd local {tag} {dtype}: "
                             f"{int(bad.sum())} elements off")
    res = {"in_shard_slots": inside, "slots": ids.numel(),
           "rows_touched": int(rows.numel()),
           "rows_touched_more_than_once": int((touches > 1).sum()),
           "bwd_max_err" if dtype == torch.float32 else "bwd_max_ulps":
           worst}
    print(f"  local rows {tag} {str(dtype)[6:]}: forward bitwise, scatter "
          + json.dumps(res), flush=True)
    return res


def phase_dist_kernels(arch) -> dict:
    """The local-rows mode of embedding_bag_fwd and embedding_bag_bwd (the
    row-sharded lookup's kernels) against their plain versions at
    dlrm-criteo's ids (65536, 26, 1) of the Criteo stream, in f32 and
    bf16, on DIST_SHARDS: the whole (26, 2^22, 128) table as one shard,
    and its second quarter (v_loc 2^20, about three quarters of the ids
    outside it); the bf16 ones (the main path's) timed beside their plain
    versions, the bound (the in-shard slots' bytes and adds: the ids,
    the d_out rows of bags with a slot in the shard, the rows they touch)
    and one PyTorch call of the same function (F.embedding_bag over the
    shard with a 0/1 weight a slot; index_add_ of the masked updates; and
    for the whole table F.embedding of the bag-of-one rows). Returns the two
    kernels' records, the whole-table shard's at the top and the
    quarter's under `quarter`."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import embedding_bag as eb, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    cfg = arch.model
    n_f, rows, dim = cfg.n_sparse, cfg.vocab_sizes[0], cfg.embed_dim
    batch = arch.shape("train_batch").batch
    ids = torch.as_tensor(_criteo_batch(cfg, batch, 16)["sparse_ids"]) \
        .to(dev)
    b, _, bag = ids.shape
    recs = {}
    for tag, row0, v_loc in DIST_SHARDS:
        for dtype in (torch.float32, torch.bfloat16):
            tables = torch.empty((n_f, v_loc, dim), dtype=dtype, device=dev)
            tables.normal_(generator=gen).mul_(dim ** -0.5)
            chk = _check_local(tables, ids, row0, f"{tag} ({b}, {n_f}, "
                               f"{bag}) into ({n_f}, {v_loc}, {dim}) at "
                               f"row {row0}")
            del tables
            torch.cuda.empty_cache()
        # timed in bf16, the main path's dtype
        tables = torch.empty((n_f, v_loc, dim), dtype=torch.bfloat16,
                             device=dev)
        tables.normal_(generator=gen).mul_(dim ** -0.5)
        lid = ids.long() - row0
        ok = (lid >= 0) & (lid < v_loc)
        flat = (lid.clamp(0, v_loc - 1) + (torch.arange(
            n_f, device=dev) * v_loc).view(1, n_f, 1)).view(b * n_f, bag)
        weight = ok.view(b * n_f, bag).to(torch.bfloat16)
        slots = int(ok.sum())
        # the (b, f) rows of d_out that a slot in the shard reads
        bags_in = int(ok.any(-1).sum())
        uniq = int(torch.unique(flat[ok.view(b * n_f, bag)]).numel())
        table_flat = tables.view(n_f * v_loc, dim)
        fwd = kernel_record(
            f"embedding_bag_fwd local bf16 {tag}",
            time_ms(lambda: eb.embedding_bag_fwd(tables, ids, row0=row0),
                    [()], kernel="embedding_bag_fwd_kernel"),
            time_ms(lambda: ref.embedding_bag_local_ref(tables, ids, row0),
                    [()]),
            time_ms(lambda: F.embedding_bag(flat, table_flat, mode="sum",
                                            per_sample_weights=weight),
                    [()]),
            cost_bound("bag_fwd", b, n_f, bag, v_loc, dim, 2, uniq,
                       inside=slots), 0.0, shape=[b, n_f, bag, v_loc, dim],
            row0=row0, in_shard_slots=slots, checks=chk)
        if tag == "shard1":
            # F.embedding of the same bag-of-one rows, the unsharded
            # lookup's other PyTorch call (PERF.md §6's last column)
            fwd["f_embedding_ms"] = time_ms(
                lambda: F.embedding(flat.view(b, n_f * bag), table_flat),
                [()]).ms
            print(f"  F.embedding at ({b}, {n_f}, {bag}) into ({n_f}, "
                  f"{v_loc}, {dim}) bf16: {fwd['f_embedding_ms']:.4f} ms",
                  flush=True)
        del table_flat
        d_out = torch.randn((b, n_f, dim), device=dev, generator=gen) \
            .to(torch.bfloat16).float()
        grad = tables.zero_()
        del tables
        t = time_ms(lambda: eb.embedding_bag_scatter(d_out, ids, grad,
                                                     row0=row0), [()],
                    kernel="embedding_bag_bwd_kernel")
        plain = time_ms(lambda: ref.embedding_bag_local_bwd_ref(
            d_out, ids, row0, v_loc, dtype=torch.bfloat16), [()], iters=3)
        upd = (d_out.to(torch.bfloat16)[:, :, None, :].expand(
            b, n_f, bag, dim) * ok[..., None].to(torch.bfloat16)) \
            .reshape(-1, dim).contiguous()
        grad_flat = grad.view(n_f * v_loc, dim)
        lib = time_ms(lambda: grad_flat.index_add_(0, flat.view(-1), upd),
                      [()])
        bwd = kernel_record(
            f"embedding_bag_bwd local bf16 {tag}", t, plain, lib,
            cost_bound("bag_bwd", b, n_f, bag, v_loc, dim, 2, uniq,
                       inside=slots, bags_in=bags_in), 0.0,
            shape=[b, n_f, bag, v_loc, dim], row0=row0,
            in_shard_slots=slots, in_shard_bags=bags_in)
        del grad, grad_flat, upd, d_out
        torch.cuda.empty_cache()
        if tag == "shard1":
            recs = {"embedding_bag_fwd_local": fwd,
                    "embedding_bag_bwd_local": bwd}
        else:
            recs["embedding_bag_fwd_local"][tag] = fwd
            recs["embedding_bag_bwd_local"][tag] = bwd
    return recs


def _dlrm_dense_tree(cfg, dev, gen):
    """Random f32 tensors of the shapes of dlrm-criteo's replicated (MLP)
    parameters, the tree the driver's psum_tree reduces."""
    import torch
    n_f = cfg.n_sparse + 1
    dims = {"bottom": (cfg.n_dense,) + cfg.bottom_mlp,
            "top": (n_f * (n_f - 1) // 2 + cfg.bottom_mlp[-1],)
            + cfg.top_mlp}
    tree = {}
    for name, ds in dims.items():
        for k, (i, o) in enumerate(zip(ds[:-1], ds[1:])):
            tree[f"{name}.{k}.weight"] = torch.randn((o, i), device=dev,
                                                     generator=gen)
            tree[f"{name}.{k}.bias"] = torch.randn((o,), device=dev,
                                                   generator=gen)
    return tree


def phase_dist_collectives(arch) -> dict:
    """A process group of one rank on the card (NCCL, a file rendezvous;
    NCCL takes one rank a device, so a world above one is not measured
    here), then psum_tree over its (1, 1) mesh's data group on tensors of
    dlrm-criteo's replicated parameters (2.2 M f32 values) in its three
    modes: "none" bitwise the input, "bf16" bitwise the input rounded to
    bf16 (one rounding: a sum of one term), "int8" within half a
    quantization step (scale / 2) an element, plus the two f32 roundings
    of the quotient and the product (amax 2^-23). Times each (CUDA
    events, 20 calls) and leaves the group up for dist_dlrm."""
    import torch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.train import collectives as coll

    if os.path.exists(DIST_PG_FILE):
        os.remove(DIST_PG_FILE)
    t0 = time.monotonic()
    dev = mesh_lib.init_distributed("cuda", rank=0, world_size=1,
                                    init_method=f"file://{DIST_PG_FILE}")
    mesh = mesh_lib.make_mesh(1, 1, dev)
    init_s = time.monotonic() - t0
    gen = torch.Generator(device=dev).manual_seed(17)
    tree = _dlrm_dense_tree(arch.model, dev, gen)
    n = sum(t.numel() for t in tree.values())
    res = {"backend": torch.distributed.get_backend(), "init_s": init_s,
           "values": n}
    for mode in ("none", "bf16", "int8"):
        out = coll.psum_tree(tree, mesh.data_group, compress=mode)
        for k, x in tree.items():
            r = out[k]
            if r.device != x.device or r.dtype != torch.float32:
                raise AssertionError(f"psum_tree {mode} {k}: {r.dtype} on "
                                     f"{r.device}")
            if mode == "none" and not torch.equal(r, x):
                raise AssertionError(f"psum_tree none {k}: not the input")
            if mode == "bf16" and not torch.equal(
                    r, x.to(torch.bfloat16).float()):
                raise AssertionError(f"psum_tree bf16 {k}: not one bf16 "
                                     f"rounding of the input")
            if mode == "int8":
                amax = x.abs().max()
                scale = (amax + 1e-12) / 127.0
                if not bool(((r - x).abs()
                             <= scale / 2 + amax * 2.0 ** -23).all()):
                    raise AssertionError(f"psum_tree int8 {k}: off by more "
                                         f"than half a step")
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(20):
            coll.psum_tree(tree, mesh.data_group, compress=mode)
        end.record()
        torch.cuda.synchronize()
        res[f"{mode}_ms"] = start.elapsed_time(end) / 20
    print("  dist_collectives " + json.dumps(res), flush=True)
    return res


def phase_dist_dlrm(arch, first_losses) -> dict:
    """The driver as `--arch dlrm-criteo --full --shape train_batch --dist
    --mesh 1,1` runs it, in dist_collectives' process group: DIST_STEPS
    steps at DRIVER_LR through tp_multifeature_bag and the kernel's
    local-rows mode (its forward and scatter launched each step, with
    dot_interact's two), each of the losses against the dlrm_driver
    phase's at the same seed (DIST_LOSS_RTOL); samples/s and peak memory.
    Ends the process group. Returns the launch counts."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    try:
        ops.reset_launch_counts()
        res = train.run(arch.arch_id, steps=DIST_STEPS, full=True,
                        shape=arch.shape("train_batch"), device="cuda",
                        lr=DRIVER_LR, log_every=DIST_STEPS, dist_run=True,
                        mesh_shape=(1, 1))
        counts = {k: ops.launch_counts()[k] for k in DIST_KERNELS + (
            "dot_interact_fwd", "dot_interact_bwd", "embedding_bag_fwd",
            "embedding_bag_bwd")}
        torch.cuda.empty_cache()
        placed_retrieval(arch)
    finally:
        torch.distributed.destroy_process_group()
    losses, want = res["losses"], first_losses[:DIST_STEPS]
    summary = {k: res[k] for k in ("samples_per_s", "loop_step_s",
                                   "fetch_step_s", "train_step_s",
                                   "max_memory_allocated", "mesh")}
    summary.update(losses=losses, unsharded_losses=want, launches=counts)
    print("  dist_dlrm " + json.dumps(summary), flush=True)
    if losses[0] != want[0]:
        raise AssertionError(f"dist_dlrm first loss {losses[0]} is not the "
                             f"unsharded driver's {want[0]}")
    off = [(a, b) for a, b in zip(losses, want)
           if not abs(a - b) <= DIST_LOSS_RTOL * abs(b)]
    if off or len(losses) != DIST_STEPS:
        raise AssertionError(f"dist_dlrm losses {losses} off the unsharded "
                             f"driver's {want}")
    short = {k: n for k, n in counts.items()
             if (k.startswith("dot") or k in DIST_KERNELS)
             and n < DIST_STEPS}
    if short or counts["embedding_bag_fwd"] or counts["embedding_bag_bwd"]:
        raise AssertionError(f"dist_dlrm launches {counts}: the sharded "
                             f"path takes the local-rows mode each step")
    peak = res["max_memory_allocated"]
    if not peak < min(torch.cuda.get_device_properties(0).total_memory,
                      CARD_BYTES):
        raise AssertionError(f"dist_dlrm peak {peak / 1e9:.2f} GB")
    return counts


def placed_retrieval(arch) -> dict:
    """Slice 20: dlrm-criteo's placed retrieval program (launch/programs.
    build_program at retrieval_cand on the (1, 1) mesh of the process
    group the caller holds: 1,000,000 candidates in 25 chunks, the item
    rows and the user's bags through tp_multifeature_bag), against the
    unplaced score_candidates of the same model, user and candidates:
    within 4 bf16 ulps of the largest score (dlrm_retrieval's), scores
    finite, the local-rows forward launched for the user and each
    chunk; host-clock seconds of each after a warm-up call."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.programs import build_program
    from repro_torch.models import dlrm as dlrm_lib

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = mesh_lib.make_mesh(1, 1, dev, exchange_one_shard=True)
    prog = build_program(arch, arch.shape("retrieval_cand"), mesh, dev)
    user, cand = prog.inputs["user"], prog.inputs["cand_ids"]
    prog.fn(*prog.args)                       # a warm-up call of each
    dlrm_lib.score_candidates(prog.model, user, cand,
                              chunks=RETRIEVAL_CHUNKS)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    placed = prog.fn(*prog.args)
    torch.cuda.synchronize()
    placed_s = time.monotonic() - t0
    counts = {k: n for k, n in ops.launch_counts().items() if n}
    t0 = time.monotonic()
    plain = dlrm_lib.score_candidates(prog.model, user, cand,
                                      chunks=RETRIEVAL_CHUNKS)
    torch.cuda.synchronize()
    plain_s = time.monotonic() - t0
    err = float((placed.float() - plain.float()).abs().max())
    ulp = float(_bf16_ulp(plain.float().abs().max()))
    res = {"candidates": int(cand.numel()), "chunks": RETRIEVAL_CHUNKS,
           "placed_s": placed_s, "unplaced_s": plain_s,
           "max_abs_err": err, "max_ulps": err / ulp,
           "bitwise": bool(torch.equal(placed, plain)), "launches": counts}
    print("  dist_dlrm placed retrieval " + json.dumps(res), flush=True)
    if placed.shape != plain.shape or placed.dtype != plain.dtype \
            or not bool(torch.isfinite(placed).all()):
        raise AssertionError(f"placed retrieval {placed.shape} "
                             f"{placed.dtype} against {plain.shape}")
    if not err <= 4 * ulp:
        raise AssertionError(f"placed retrieval off the unplaced scores by "
                             f"{err:.3e} ({err / ulp:.1f} bf16 ulps)")
    if counts.get("embedding_bag_fwd_local") != 1 + RETRIEVAL_CHUNKS \
            or counts.get("dot_interact_fwd") != RETRIEVAL_CHUNKS:
        raise AssertionError(f"placed retrieval launches {counts}")
    return res


# ---- slice 9: xDeepFM, DIEN and BERT4Rec through the driver -----------

def _seq_batch(cfg, n, seed):
    """n synthetic records of cfg's arch as the driver makes them (numpy,
    on the host): Criteo records for xDeepFM, `dien_batch` and
    `bert4rec_batch` from a RandomState of `seed` for the others."""
    import numpy as np
    from repro_torch.data.synthetic import bert4rec_batch, dien_batch
    rng = np.random.RandomState(seed)
    if cfg.name == "dien":
        return dien_batch(rng, n, cfg.seq_len, cfg.vocab_sizes[0],
                          cfg.n_dense)
    if cfg.name == "bert4rec":
        return bert4rec_batch(rng, n, cfg.seq_len, cfg.n_items, cfg.n_mask,
                              cfg.n_negatives)
    return _criteo_batch(cfg, n, seed)


def _seq_lookups(cfg, n, seed) -> dict:
    """The lookups a microbatch of n gives the embedding kernels on cfg's
    path: {tag: (table shape (F, V, D), ids (B, F, 1) int32 on the card,
    fused)}; the item gathers of DIEN and BERT4Rec are bags of one of a
    (1, V, D) table, ids in memory order."""
    import numpy as np
    import torch
    dev = torch.device("cuda")
    b = _seq_batch(cfg, n, seed)
    col = lambda a: torch.as_tensor(a).to(dev).reshape(-1, 1, 1)
    if cfg.name == "xdeepfm":
        ids = torch.as_tensor(b["sparse_ids"]).to(dev)
        rows = cfg.vocab_sizes[0]
        return {"xdeepfm_tables": ((cfg.n_sparse, rows, cfg.embed_dim), ids,
                                   False),
                "xdeepfm_linear": ((cfg.n_sparse, rows, 1), ids, True)}
    if cfg.name == "dien":
        return {"dien_hist": ((1, cfg.vocab_sizes[0], cfg.embed_dim),
                              col(b["hist_ids"]), False)}
    vocab = -(-(cfg.n_items + 2) // 16) * 16
    cand = np.concatenate([b["mask_labels"][..., None], b["neg_ids"]], -1)
    return {"bert4rec_seq": ((1, vocab, cfg.embed_dim), col(b["item_seq"]),
                             False),
            "bert4rec_cand": ((1, vocab, cfg.embed_dim), col(cand), False)}


def _check_scatter_counted(d_out, ids, v, tag) -> float:
    """embedding_bag_bwd (sum) against its plain version where a row may
    be named many times (BERT4Rec's MASK id, 20 times a sequence): every
    d_out non-negative, each row within rtol max(1e-5, 2 n 2^-24) / atol
    1e-6 of the plain version, n the times the ids name it (two orders of
    n non-negative f32 adds each lie within (n - 1) 2^-24 of the exact
    sum, relative); the rows no id names exactly 0. Feature by feature,
    over the touched rows only. Returns the max abs error."""
    import torch
    from repro_torch.kernels import embedding_bag as eb, ref
    got = eb.embedding_bag_bwd(d_out, ids, v)
    want = ref.embedding_bag_bwd_ref(d_out, ids, v)
    err = 0.0
    for f in range(ids.shape[1]):
        count = torch.bincount(ids[:, f].reshape(-1).long(), minlength=v)
        hit = count > 0
        if bool(got[f][~hit].any()):
            raise AssertionError(f"embedding_bag_bwd {tag} f={f}: writes "
                                 f"rows no id names")
        g, w = got[f][hit].double(), want[f][hit].double()
        rtol = torch.clamp(2.0 * count[hit].double() * 2.0 ** -24,
                           min=1e-5)[:, None]
        diff = (g - w).abs()
        bad = diff > 1e-6 + rtol * w.abs()
        if bool(bad.any()):
            raise AssertionError(f"embedding_bag_bwd {tag} f={f}: "
                                 f"{int(bad.sum())} elements off, max abs "
                                 f"err {float(diff.max()):.3e}")
        err = max(err, float(diff.max()))
    return err


def phase_recsys_seq_kernels(archs, microbatches) -> dict:
    """The embedding kernels at the lookups of xDeepFM, DIEN and BERT4Rec
    at a driver microbatch (train_batch / microbatches of the arch): the
    forwards bitwise against their plain versions (the fused kernel at
    xDeepFM's linear arm against the row kernel too); the scatter with
    non-negative d_out against its plain version (`_check_scatter_counted`).
    Then each timed beside its plain version, its bound (bytes over 3.35
    TB/s: ids, the distinct rows, the output; the scatter reads and
    writes each touched row) and its library calls (F.embedding_bag and,
    for these bags of one, F.embedding over the flattened table;
    index_add_ into the flattened gradient). Returns {kernel: {lookup
    tag: record}}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import embedding_bag as eb, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    out = {"embedding_bag_fwd": {}, "embedding_bag_bwd": {},
           "embedding_bag_fused_fwd": {}}
    for arch in archs:
        cfg = arch.model
        n = arch.shape("train_batch").batch // microbatches[arch.arch_id]
        sets = [_seq_lookups(cfg, n, seed) for seed in (1, 2)]
        for tag, (shape, ids, fused) in sets[0].items():
            f, v, d = shape
            table = torch.empty(shape, device=dev)
            table.normal_(generator=gen).mul_(d ** -0.5)
            id_sets = [(s[tag][1],) for s in sets]
            b = ids.shape[0]
            offs = (torch.arange(f, device=dev) * v).view(1, f, 1)
            flat = [((i.long() + offs).reshape(b * f, 1),)
                    for (i,) in id_sets]
            uniq = int(torch.unique(flat[0][0]).numel())
            kind = "fused" if fused else "row"
            kname = "embedding_bag_fused_fwd" if fused else \
                "embedding_bag_fwd"
            fn = getattr(eb, kname)
            if fused:
                _check_fused(table, ids, "sum", tag)
            elif not torch.equal(eb.embedding_bag_fwd(table, ids),
                                 ref.embedding_bag_ref(table, ids)):
                raise AssertionError(f"embedding_bag_fwd {tag}: not "
                                     f"bitwise the plain version")
            plan = eb.fused_plan(b, f, v, d, 1) if fused else \
                eb.fwd_plan(b, f, d)
            print(f"  {tag}: ids {tuple(ids.shape)} into {shape} f32, "
                  f"{uniq} distinct rows; {kind} kernel bitwise the plain "
                  f"version; plan {plan}", flush=True)
            flat_table = table.view(f * v, d)
            # bags of one: F.embedding computes the same function too
            gather = time_ms(lambda x: F.embedding(x, flat_table), flat)
            print(f"  {kname} {tag}: F.embedding {gather.ms:.4f} ms "
                  f"({gather.events} events), {gather.wall:.4f} ms launch "
                  f"to launch", flush=True)
            out[kname][tag] = kernel_record(
                f"{kname} {tag}",
                time_ms(lambda i: fn(table, i), id_sets,
                        kernel=kname + "_kernel"),
                time_ms(lambda i: ref.embedding_bag_ref(table, i), id_sets,
                        iters=5),
                time_ms(lambda x: F.embedding_bag(x, flat_table, mode="sum"),
                        flat),
                cost_bound("bag_fwd", *ids.shape, v, d, 4, uniq), 0.0,
                ids=list(ids.shape),
                table=list(shape), distinct_rows=uniq,
                embedding_library_ms=gather.ms,
                embedding_library_events=gather.events)
            # the scatter (the lookup's backward), non-negative d_out
            d_out = torch.rand((b, f, d), device=dev, generator=gen)
            err = _check_scatter_counted(d_out, ids, v, tag)
            print(f"  embedding_bag_bwd {tag}: plan {eb.bwd_plan(b, f, v, d)}"
                  f"; max abs err {err:.3e}", flush=True)
            grad = torch.zeros_like(table)
            del table, flat_table
            torch.cuda.empty_cache()
            t = time_ms(lambda: eb.embedding_bag_scatter(d_out, ids, grad),
                        [()], kernel="embedding_bag_bwd_kernel")
            plain = time_ms(lambda: ref.embedding_bag_bwd_ref(d_out, ids, v),
                            [()], iters=3)
            idx = flat[0][0].reshape(-1)
            lib = time_ms(lambda: grad.view(f * v, d).index_add_(
                0, idx, d_out.view(b * f, d)), [()])
            out["embedding_bag_bwd"][tag] = kernel_record(
                f"embedding_bag_bwd {tag}", t, plain, lib,
                cost_bound("bag_bwd", *ids.shape, v, d, 4, uniq), err,
                ids=list(ids.shape), table=list(shape), distinct_rows=uniq)
            del grad, d_out, id_sets, flat, idx
            torch.cuda.empty_cache()
    return out


def _relu_flips(layers, run_k, run_p):
    """Runs run_k() and run_p() (each a per-sample loss), recording the
    pre-activations of `layers` (the hidden nn.Linear layers of an MLP)
    on each; returns (loss_k, loss_p, samples whose ReLU inputs take
    another side on the two paths)."""
    import torch
    pre = []
    hooks = [lin.register_forward_hook(
        lambda m, i, o: pre.append(o.detach())) for lin in layers]
    loss_k = run_k()
    n = len(pre)
    loss_p = run_p()
    for h in hooks:
        h.remove()
    flips = torch.zeros_like(loss_k, dtype=torch.bool)
    for a, b in zip(pre[:n], pre[n:]):
        flips |= ((a > 0) != (b > 0)).any(dim=1)
    return loss_k, loss_p, flips


def phase_seq_model(arch, n: int):
    """The arch's loss and every gradient at its published widths (batch
    n) through the kernels against the plain versions, same parameters
    and batch: the loss rtol 1e-5, each gradient within 1e-4 of its L2
    norm, over the samples whose MLP ReLU inputs agree on both paths
    (xDeepFM's DNN, DIEN's MLP; BERT4Rec has no ReLU), at most 1% left
    out; each of the path's kernels launched."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import recsys

    dev = torch.device("cuda")
    cfg = arch.model
    model = recsys.init_model(cfg, seed=0, device=dev)
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in _seq_batch(cfg, n, 7).items()}
    names, params = zip(*model.named_parameters())

    def per_sample(**kw):
        if cfg.name == "bert4rec":
            logp = torch.log_softmax(
                model.sampled_logits(batch, **kw).float(), dim=-1)
            mask = (batch["mask_labels"] >= 0).float()
            return -(logp[..., 0] * mask).sum(1) / mask.sum(1)
        z = model(batch, **kw)
        y = batch["label"].float()
        return torch.clamp(z, min=0) - z * y \
            + torch.log1p(torch.exp(-torch.abs(z)))

    mlp = {"xdeepfm": "dnn", "dien": "mlp"}.get(cfg.name)
    layers = list(getattr(model, mlp))[:-1] if mlp else []
    ops.reset_launch_counts()
    loss_k, loss_p, flips = _relu_flips(
        layers, per_sample, lambda: per_sample(bag_fn=ref.embedding_bag_ref))
    n_flip = int(flips.sum())
    if n_flip > loss_k.numel() // 100:
        raise AssertionError(f"{cfg.name}: {n_flip} samples flip a ReLU "
                             f"between the two paths")
    if not bool(torch.isfinite(loss_k).all()):
        raise AssertionError(f"{cfg.name} loss not finite")
    _allclose(f"{cfg.name} loss", loss_k.mean(), loss_p.mean(), 1e-5, 0.0)
    keep = (~flips).float() / float((~flips).sum())
    grads_k = torch.autograd.grad((loss_k * keep).sum(), params)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    need = {"embedding_bag_fwd", "embedding_bag_bwd"}
    if cfg.name == "xdeepfm":
        need.add("embedding_bag_fused_fwd")
    if not need <= set(counts):
        raise AssertionError(f"{cfg.name} pass skipped a kernel: {counts}")
    worst = 0.0
    for name, gk, gp in zip(names, grads_k, torch.autograd.grad(
            (loss_p * keep).sum(), params)):
        rel = float(torch.linalg.vector_norm(gk - gp)
                    / torch.linalg.vector_norm(gp))
        if not rel <= 1e-4:
            raise AssertionError(f"{cfg.name} grad {name}: relative L2 "
                                 f"error {rel:.3e}")
        worst = max(worst, rel)
    print(f"  {cfg.name} at batch {n}: loss kernels "
          f"{float(loss_k.detach().mean()):.7f} plain "
          f"{float(loss_p.detach().mean()):.7f}; {n_flip} of "
          f"{loss_k.numel()} samples flip a ReLU and are left out; "
          f"{len(names)} gradients agree (worst relative L2 error "
          f"{worst:.3e}); launches {counts}")


def _seq_kernels(cfg) -> dict:
    """{kernel: launches a microbatch} on cfg's training path: xDeepFM's
    tables, its linear arm and both scatters; DIEN's history and target
    lookups, or BERT4Rec's sequence and candidate ones, and theirs."""
    if cfg.name == "xdeepfm":
        return {"embedding_bag_fwd": 1, "embedding_bag_fused_fwd": 1,
                "embedding_bag_bwd": 2}
    return {"embedding_bag_fwd": 2, "embedding_bag_bwd": 2}


def phase_seq_driver(arch, microbatches: int) -> dict:
    """The generic driver at the arch's published widths: --full --shape
    train_batch --microbatches k for SEQ_STEPS steps: losses finite, peak
    device memory under the card's, each of the path's kernels launched
    as often as `_seq_kernels` says a microbatch; samples/s, the loop
    step split into batch + copy and the train step. Returns the launch
    counts."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    ops.reset_launch_counts()
    res = train.run(arch.arch_id, steps=SEQ_STEPS, full=True,
                    shape=arch.shape("train_batch"), device="cuda",
                    microbatches=microbatches, log_every=1)
    counts = {k: ops.launch_counts()[k] for k in _seq_kernels(arch.model)}
    if not all(math.isfinite(x) for x in res["losses"]):
        raise AssertionError(f"{arch.arch_id} loss not finite: "
                             f"{res['losses']}")
    peak = res["max_memory_allocated"]
    card = torch.cuda.get_device_properties(0).total_memory
    if not peak < min(card, CARD_BYTES):
        raise AssertionError(f"{arch.arch_id} peak {peak / 1e9:.2f} GB")
    need = {k: SEQ_STEPS * microbatches * n
            for k, n in _seq_kernels(arch.model).items()}
    short = {k: n for k, n in counts.items() if n < need[k]}
    if short:
        raise AssertionError(f"kernels launched fewer than {need} times on "
                             f"the {arch.arch_id} path: {short}")
    summary = {k: res[k] for k in ("samples_per_s", "loop_step_s",
                                   "fetch_step_s", "train_step_s",
                                   "max_memory_allocated", "microbatches")}
    summary.update(losses=res["losses"], launches=counts)
    print(f"  {arch.arch_id}_driver " + json.dumps(summary))
    torch.cuda.synchronize()
    return counts


def phase_seq_profile(arch, microbatches: int) -> dict:
    """Where one train step's device time goes (torch.profiler over one
    step on a batch already on the card, after one warm-up step), against
    the host-clock step. Returns each embedding kernel's device ms a
    step."""
    import numpy as np
    import torch
    from repro_torch.launch import train
    from repro_torch.train.optim import make_optimizer
    from repro_torch.train.train_step import make_train_step

    dev = torch.device("cuda")
    cfg = arch.model
    model = train.init_params_for(arch, cfg, 0, device=dev)
    opt = make_optimizer(arch.optimizer, lr=1e-3)
    state = opt.init(dict(model.named_parameters()))
    step_fn = make_train_step(train.make_loss_fn(arch, cfg), opt,
                              microbatches)
    batch = train.make_batch_fn(arch, cfg, arch.shape("train_batch").batch,
                                np.random.RandomState(13), device=dev)()
    step_fn(model, state, 0, batch)
    torch.cuda.synchronize()
    kernels = tuple(k + "_kernel" for k in _seq_kernels(cfg))
    rows, wall_ms = profile_steps(
        lambda k: step_fn(model, state, 1 + k, batch), 1, kernels)
    device_ms = sum(ms for _, ms in rows)
    print(f"  {arch.arch_id} train step ({microbatches} microbatches): "
          f"{device_ms:.3f} ms of device time in {wall_ms:.3f} ms of "
          f"host-clock time (profiled)")
    for name, ms in rows[:12]:
        print(f"    {ms:9.4f} ms  {100 * ms / device_ms:5.1f}%  {name[:90]}")
    in_step = {}
    for name, ms in rows:
        for k in kernels:
            if k + "<" in name or name.endswith(k):
                in_step[k[:-7]] = in_step.get(k[:-7], 0.0) + ms
    print(f"  embedding kernels in the step: {json.dumps(in_step)}")
    del model, state, opt, batch
    return in_step


def phase_recsys_retrieval(archs) -> dict:
    """score_candidates at retrieval_cand (one user, 1,000,000 candidates
    in RETRIEVAL_CHUNKS chunks) for wide-deep, xDeepFM, DIEN and BERT4Rec
    at their published widths (random weights from seed 0), through the
    kernels and through the plain versions: the scores finite, the two
    within rtol 1e-5 / atol 1e-5 (the lookups are bitwise; everything
    after them the same operations); host-clock seconds of each
    (synchronised, after a warm-up call)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import recsys

    dev = torch.device("cuda")
    res = {}
    for arch in archs:
        torch.cuda.reset_peak_memory_stats()
        cfg = arch.model
        shape = arch.shape("retrieval_cand")
        model = recsys.init_model(cfg, seed=0, device=dev)
        gen = torch.Generator(device=dev).manual_seed(14)
        user = {k: torch.as_tensor(v).to(dev)
                for k, v in _seq_batch(cfg, shape.batch, 14).items()
                if k not in ("label", "mask_pos", "mask_labels", "neg_ids")}
        high = {"dien": cfg.vocab_sizes[0], "bert4rec": cfg.n_items}.get(
            cfg.name, 2 ** 31 - 1)
        cand = torch.randint(0, high, (shape.n_candidates,), device=dev,
                             generator=gen, dtype=torch.int32)
        out = {}
        for tag, kw in (("kernels", {}),
                        ("plain", {"bag_fn": ref.embedding_bag_ref})):
            recsys.score_candidates(model, user, cand,
                                    chunks=RETRIEVAL_CHUNKS, **kw)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.monotonic()
            scores = recsys.score_candidates(model, user, cand,
                                             chunks=RETRIEVAL_CHUNKS, **kw)
            torch.cuda.synchronize()
            out[tag] = (scores, time.monotonic() - t0,
                        {k: n for k, n in ops.launch_counts().items() if n})
        (sk, tk, lk), (sp, tp, lp) = out["kernels"], out["plain"]
        if sk.shape != (shape.n_candidates,) or \
                not bool(torch.isfinite(sk).all()):
            raise AssertionError(f"{cfg.name} retrieval scores {sk.shape}")
        if not lk or lp:
            raise AssertionError(f"{cfg.name} retrieval launches: kernels "
                                 f"{lk}, plain {lp}")
        err = _allclose(f"{cfg.name} retrieval", sk, sp, 1e-5, 1e-5)
        res[cfg.name] = {"candidates": shape.n_candidates,
                         "chunks": RETRIEVAL_CHUNKS, "kernels_s": tk,
                         "plain_s": tp, "max_abs_err": err,
                         "bitwise": bool(torch.equal(sk, sp)),
                         "launches": lk,
                         "peak_bytes": torch.cuda.max_memory_allocated()}
        print(f"  {cfg.name}_retrieval " + json.dumps(res[cfg.name]),
              flush=True)
        del model, out, sk, sp, scores
        torch.cuda.empty_cache()
    return res


# ------------------------------------------------ slice 15: the LM family ---
# the driver phases record their warm train step seconds here for the
# roofline (benchmarks/torch_roofline.py); emptied at the start of a run
STEPS_JSON = os.path.join(ROOT, "build", "bench", "torch_steps.json")
# train_4k (sequences of 4096) at its published widths, the batch cut
# from 256 to what one card holds in a few seconds a step; lr above the
# driver's 1e-3, so that a few steps under the 100-step warmup (step 0's
# lr is 0) move the bf16 weights by more than their rounding, and for
# gemma2-2b low enough that its early adam steps do not overshoot (at
# 0.01 and 0.03 its fourth loss read 16.08 and 14.06 against a first of
# 12.65; NVIDIA H100 80GB HBM3, 700.00 W)
# The profiled step: smollm-135m's at its driver batch; gemma2-2b's at
# one of its four microbatches (batch 1; the profiler's reading of a whole
# step's 120,000-odd launches took 20 s), whose forward and backward are
# a quarter of its step's, with one adam update instead of one in four
LM_TRAIN = {"smollm-135m": dict(batch=8, microbatches=1, steps=4, lr=0.03,
                                profile_batch=8),
            "gemma2-2b": dict(batch=4, microbatches=4, steps=4, lr=0.003,
                              profile_batch=1)}
# serving: a timed prefill of batch 1 (gemma2-2b past its 4096 window, so
# that the local layers mask), then `decode` steps at `batch` over a cache
# of prompt + decode entries, each step's logits against the full forward's
# softcapped logits at its position. gemma2-2b's bf16 tolerance (stated
# before the first run, from CPU runs at reduced widths, 3x their
# largest): max |diff| 0.25 and mean 0.04 a position (1-2 bf16 ulps of
# logits of 2-8 after 26 layers whose GEMMs sum in other orders) and a
# cosine of at least 0.99 between the two logit vectors of each position
# (a wrong position, cache entry or mask reads far below it).
# qwen2-moe-a2.7b's bf16 router takes another expert for a near tie on
# one path and not the other now and then (a first run read max
# 0.81, mean up to 0.1395, cosine down to 0.9848, bimodal by position,
# against the 1.0, 0.1 and 0.99 stated for it). So each decode position's
# routing is compared with the forward's over every layer (a flip: a
# token whose set of top-k experts differs), the flips are counted and
# printed, and the positions with none are held to gemma2-2b's stated
# tolerance (`flips`); the phase fails if no position is free of flips.
# Its decode is also held in f32 (LM_SERVE_F32).
LM_SERVE = {"gemma2-2b": dict(prompt=8192, batch=1, decode=16,
                              max_abs=0.25, mean_abs=0.04, cos=0.99),
            "qwen2-moe-a2.7b": dict(prompt=4096, batch=4, decode=16,
                                    max_abs=0.25, mean_abs=0.04, cos=0.99,
                                    flips=True)}
# the MoE's decode against its forward in f32 (TF32 off) at its published
# widths with the depth cut to 4 layers (f32 parameters of all 24 would
# take 60 GB), drop-free: prompt 1024, batch 4, 8 steps; tolerance
# (stated before its first run): max |diff| 1e-3 and a cosine of at least
# 0.99999 a position (f32 sums in other orders, ~1e-6 relative)
LM_SERVE_F32 = dict(layers=4, prompt=1024, batch=4, decode=8, max_abs=1e-3,
                    cos=0.99999)
# chunked_attention against naive S x S attention on the card, f32 with
# TF32 off: (B, S, H, K, hd, window, cap, chunk); GQA, a window shorter
# than S, softcap 50, KV tails of 464 and 184 past whole chunks; each of
# out, dq, dk, dv and the decode rows within ATTN_TOL of its max |value|
LM_ATTN_CASES = ((1, 2000, 8, 2, 64, 700, 50.0, 512),
                 (2, 3000, 4, 4, 128, 0, 0.0, 256))
ATTN_TOL = 1e-4


def _naive_attention(q, k, v, window: int, cap: float):
    """Causal attention with the whole (S, S) score matrix, f32."""
    import torch
    from repro_torch.models.layers import NEG_INF, softcap
    b, s, h, hd = q.shape
    n_kv = k.shape[2]
    qg = q.view(b, s, n_kv, h // n_kv, hd)
    sc = softcap(torch.einsum("bskgh,btkh->bkgst", qg, k) * hd ** -0.5, cap)
    i = torch.arange(s, device=q.device)
    valid = i[None, :] <= i[:, None]
    if window:
        valid = valid & (i[:, None] - i[None, :] < window)
    p = torch.softmax(sc.masked_fill(~valid, NEG_INF), dim=-1)
    return torch.einsum("bkgst,btkh->bskgh", p, v).reshape(b, s, h, hd)


def _within(name: str, got, want, tol: float = ATTN_TOL) -> float:
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.abs().max())
    if not err <= tol * scale:
        raise AssertionError(f"{name}: max abs err {err:.3e} over "
                             f"{tol} x max |want| {scale:.3e}")
    return err / scale


def phase_lm_attention() -> dict:
    """chunked_attention's forward and dq, dk, dv against naive S x S
    attention (autograd) on the card in f32, TF32 off, at LM_ATTN_CASES,
    and decode_attention against the naive output's rows; then the
    attention's time at gemma2-2b's train shape in bf16 ((1, 4096, 8,
    256) over 4 kv heads, chunks of 512, cap 50), for a local (4096)
    and a global layer: forward ms and forward + backward ms (CUDA
    events). Returns those times."""
    import torch
    from benchmarks.torch_kernels_bench import time_ms as events_ms
    from repro_torch.models.layers import chunked_attention, decode_attention
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the f32 check needs it off")
    for b, s, h, n_kv, hd, window, cap, chunk in LM_ATTN_CASES:
        tag = f"(B {b}, S {s}, H {h}/{n_kv}, hd {hd}, window {window}, " \
              f"cap {cap}, chunk {chunk})"
        q = torch.randn((b, s, h, hd), device=dev, generator=gen)
        k = torch.randn((b, s, n_kv, hd), device=dev, generator=gen)
        v = torch.randn((b, s, n_kv, hd), device=dev, generator=gen)
        d_out = torch.randn((b, s, h, hd), device=dev, generator=gen)
        errs = {}
        for name, fn in (("chunked", lambda q, k, v: chunked_attention(
                q, k, v, window=window, logit_cap=cap, chunk=chunk)),
                         ("naive", lambda q, k, v: _naive_attention(
                             q, k, v, window, cap))):
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            out = fn(*leaves)
            out.backward(d_out)
            errs[name] = [out.detach()] + [x.grad for x in leaves]
            del out, leaves
        rel = {n: _within(f"chunked_attention {n} {tag}", got, want)
               for n, got, want in zip(("out", "dq", "dk", "dv"),
                                       errs["chunked"], errs["naive"])}
        want = errs["naive"][0]
        for pos in (s // 2, s - 1):
            row = decode_attention(q[:, pos:pos + 1], k, v, pos=pos,
                                   window=window, logit_cap=cap)
            rel[f"decode {pos}"] = _within(f"decode_attention {tag} at "
                                           f"{pos}", row[:, 0], want[:, pos])
        print(f"  {tag}: max abs err / max |want|: "
              + ", ".join(f"{n} {e:.2e}" for n, e in rel.items()),
              flush=True)
        del errs, q, k, v, d_out
        torch.cuda.empty_cache()
    q = torch.randn((1, 4096, 8, 256), device=dev, generator=gen,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((1, 4096, 4, 256), device=dev, generator=gen,
                        dtype=torch.bfloat16) for _ in range(2))
    d_out = torch.randn_like(q)
    out = {}
    for window in (4096, 0):
        attn = lambda: chunked_attention(q, k, v, window=window,
                                         logit_cap=50.0, chunk=512)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        fwd = events_ms(attn, dev, iters=3, warmup=1)
        both = events_ms(lambda: chunked_attention(
            *leaves, window=window, logit_cap=50.0,
            chunk=512).backward(d_out), dev, iters=3, warmup=1)
        out[window] = {"fwd_ms": fwd, "fwd_bwd_ms": both}
        print(f"  gemma2-2b train shape, window {window}: forward "
              f"{fwd:.3f} ms, forward + backward {both:.3f} ms", flush=True)
    return out


def phase_lm_train(arch_id: str) -> dict:
    """The generic driver at --full --shape train_4k (LM_TRAIN's batch,
    microbatches, steps and lr), its warm step recorded in STEPS_JSON:
    every loss finite, the mean of the last two under the first, peak
    device memory under the card's. Returns the driver's result."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import train
    spec = LM_TRAIN[arch_id]
    res = train.run(arch_id, steps=spec["steps"], batch=spec["batch"],
                    shape=get_arch(arch_id).shape("train_4k"), full=True,
                    lr=spec["lr"], microbatches=spec["microbatches"],
                    device="cuda", log_every=1, steps_json=STEPS_JSON)
    losses = res["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{arch_id} loss not finite: {losses}")
    if not sum(losses[-2:]) / 2 < losses[0]:
        raise AssertionError(f"{arch_id} loss not falling: {losses}")
    peak = res["max_memory_allocated"]
    if not peak < min(torch.cuda.get_device_properties(0).total_memory,
                      CARD_BYTES):
        raise AssertionError(f"{arch_id} peak {peak / 1e9:.2f} GB")
    print(f"  {arch_id} train_4k " + json.dumps(
        {k: res[k] for k in ("batch", "microbatches", "tokens_per_s",
                             "loop_step_s", "train_step_s", "warm_step_s",
                             "max_memory_allocated", "losses", "reduced")}),
          flush=True)
    torch.cuda.empty_cache()
    return res


def phase_lm_profile(arch_id: str, mesh=None) -> float:
    """One train step at LM_TRAIN's profile_batch, in one microbatch,
    under torch.profiler (the driver's shapes already warm in this
    process): device time by kernel, the GEMMs' share, against the
    host-clock step; on `mesh` the placed step (LMPlacement, as the
    driver's --dist builds it). Returns the step's device ms."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import train
    from repro_torch.launch.programs import LMPlacement
    from repro_torch.models import transformer as tfm
    from repro_torch.train.optim import make_optimizer
    from repro_torch.train.train_step import make_train_step
    dev = torch.device("cuda")
    spec = LM_TRAIN[arch_id]
    arch = get_arch(arch_id)
    shape = arch.shape("train_4k")
    pl, opt_kw, grad_fn = None, {}, None
    if mesh is None:
        model = train.init_params_for(arch, arch.model, 0, device=dev)
    else:
        pl = LMPlacement(mesh, arch.model, optimizer=arch.optimizer)
        model = tfm.init_params(arch.model, seed=0, device=dev,
                                blocks=pl.blocks())
        opt_kw["norm_groups"] = pl.norm_groups()
        grad_fn = pl.reduce_grads
    opt = make_optimizer(arch.optimizer, lr=spec["lr"], **opt_kw)
    state = opt.init(dict(model.named_parameters()))
    step_fn = make_train_step(
        train.make_loss_fn(arch, arch.model, placement=pl), opt,
        grad_fn=grad_fn)
    batch = train.make_batch_fn(arch, arch.model, spec["profile_batch"],
                                np.random.RandomState(13), shape=shape,
                                device=dev, mesh=mesh)()
    rows, wall_ms = profile_steps(
        lambda k: step_fn(model, state, 1 + k, batch), 1)
    device_ms = sum(ms for _, ms in rows)
    # cuBLAS's and CUTLASS's GEMMs (nvjet: cuBLAS's bf16 kernels)
    gemm = sum(ms for name, ms in rows
               if any(k in name.lower() for k in ("gemm", "nvjet", "cutlass",
                                                  "xmma")))
    print(f"  {arch_id} {'placed ' if pl else ''}train step (batch "
          f"{spec['profile_batch']}, one microbatch): {device_ms:.3f} ms of "
          f"device time in {wall_ms:.3f} ms of host-clock time "
          f"(profiled); GEMM kernels {gemm:.3f} ms "
          f"({100 * gemm / device_ms:.1f}%)", flush=True)
    for name, ms in rows[:12]:
        print(f"    {ms:9.4f} ms  {100 * ms / device_ms:5.1f}%  {name[:90]}")
    del model, state, opt, batch
    torch.cuda.empty_cache()
    return device_ms


def _decode_vs_forward(model, toks, p_len: int, n_dec: int) -> dict:
    """A timed prefill of batch 1 over toks[:1, :p_len] (after a short
    warm-up prefill); a prefill of the whole batch (a MoE model's with no
    token-choice dropped, `moe.drop_free`, as its decode steps of a few
    tokens drop none) moved into a cache of p_len + n_dec entries;
    n_dec timed decode steps; each step's logits against the full
    forward's softcapped logits at its position. Returns the times and,
    by position, max |diff|, mean |diff| and the cosine; for a MoE model
    also `flips` (B, n_dec) bool, a decode position whose set of top-k
    experts differs from the forward's at that position on some layer,
    and `prompt_flips`, the prompt positions where the whole batch's
    prefill and the forward differ so."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import softcap
    cfg = model.cfg
    b = toks.shape[0]
    tfm.prefill(model, toks[:1, :min(512, p_len)])     # warm-up
    torch.cuda.synchronize()
    t0 = time.monotonic()
    tfm.prefill(model, toks[:1, :p_len])
    torch.cuda.synchronize()
    prefill_s = time.monotonic() - t0
    route = {"prefill": [], "forward": []} if cfg.is_moe else None
    dec_route = [[] for _ in range(n_dec)] if cfg.is_moe else None
    if cfg.is_moe:
        model.cfg = moe.drop_free(cfg)
    try:
        _, cache = tfm.prefill(model, toks[:, :p_len],
                               routing=route and route["prefill"])
        big = tfm.init_cache(cfg, b, p_len + n_dec, dtype=cache["k"].dtype,
                             device=toks.device)
        for n in ("k", "v"):
            big[n][:, :, :p_len] = cache[n]
        del cache
        torch.cuda.synchronize()
        got = []
        t0 = time.monotonic()
        for i, pos in enumerate(range(p_len, p_len + n_dec)):
            logits, big = tfm.decode_step(
                model, big, toks[:, pos], pos,
                routing=dec_route[i] if dec_route else None)
            got.append(logits)
        torch.cuda.synchronize()
        decode_s = time.monotonic() - t0
        del big
        with torch.no_grad():
            full, _ = tfm.forward(model, toks,
                                  routing=route and route["forward"])
    finally:
        model.cfg = cfg
    want = softcap(full[:, p_len:].float(), cfg.final_logit_softcap)
    del full
    got = torch.stack(got, dim=1)                      # (B, n_dec, V)
    diff = (got - want).abs()
    out = {"prefill_tokens_per_s": p_len / prefill_s, "prefill_s": prefill_s,
           "decode_tokens_per_s": n_dec * b / decode_s,
           "decode_step_s": decode_s / n_dec,
           "max_abs": diff.amax(-1), "mean_abs": diff.mean(-1),
           "cos": torch.nn.functional.cosine_similarity(got, want, dim=-1)}
    if cfg.is_moe:
        # a token's set of experts: its top-k indices sorted
        fwd = [r.sort(-1).values.view(b, p_len + n_dec, -1)
               for r in route["forward"]]
        pre = [r.sort(-1).values.view(b, p_len, -1)
               for r in route["prefill"]]
        flips = torch.zeros((b, n_dec), dtype=torch.bool, device=toks.device)
        for i in range(n_dec):
            for f, d in zip(fwd, dec_route[i]):
                flips[:, i] |= (f[:, p_len + i] != d.sort(-1).values).any(-1)
        prompt_flips = torch.zeros((b, p_len), dtype=torch.bool,
                                   device=toks.device)
        for f, p in zip(fwd, pre):
            prompt_flips |= (f[:, :p_len] != p).any(-1)
        out.update(flips=flips, prompt_flips=prompt_flips,
                   layers_routed=len(fwd))
    return out


def phase_lm_serve(arch_id: str) -> dict:
    """Prefill and decode at the published widths in bf16 (LM_SERVE,
    `_decode_vs_forward`): tokens/s, the cuts of prefill_32k and
    decode_32k, and the decode held to the forward: gemma2-2b's at every
    position, a MoE arch's at the positions no routing flip reaches (the
    flips counted and printed); a MoE arch's decode is also held in f32
    at LM_SERVE_F32's cut depth."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    dev = torch.device("cuda")
    spec = LM_SERVE[arch_id]
    cfg = get_arch(arch_id).model
    p_len, b, n_dec = spec["prompt"], spec["batch"], spec["decode"]
    torch.cuda.reset_peak_memory_stats(dev)
    toks = torch.from_numpy(TokenStream(cfg.vocab_size, p_len + n_dec)
                            .batch(b)["tokens"]).to(dev)
    model = tfm.init_params(cfg, seed=0, device=dev)
    r = _decode_vs_forward(model, toks, p_len, n_dec)
    del model
    torch.cuda.empty_cache()
    res = {k: r[k] for k in ("prefill_tokens_per_s", "prefill_s",
                             "decode_tokens_per_s", "decode_step_s")}
    held = torch.ones_like(r["cos"], dtype=torch.bool)
    if spec.get("flips"):
        flips = r["flips"]
        if r["layers_routed"] != cfg.n_layers:
            raise AssertionError(f"{arch_id}: routing of "
                                 f"{r['layers_routed']} layers recorded")
        held = ~flips
        res.update(flips=int(flips.sum()), positions=flips.numel(),
                   flipped=[[int(b_), p_len + int(i)] for b_, i in
                            flips.nonzero().tolist()],
                   prompt_flips=int(r["prompt_flips"].sum()),
                   prompt_positions=r["prompt_flips"].numel(),
                   all_max_abs=float(r["max_abs"].max()),
                   all_mean_abs=float(r["mean_abs"].max()),
                   all_min_cos=float(r["cos"].min()))
        if not bool(held.any()):
            raise AssertionError(f"{arch_id}: every decode position flips "
                                 f"an expert against the forward: no "
                                 f"position to hold")
    res.update(max_abs=float(r["max_abs"][held].max()),
               mean_abs=float(r["mean_abs"][held].max()),
               min_cos=float(r["cos"][held].min()),
               max_memory_allocated=torch.cuda.max_memory_allocated(dev),
               reduced=[f"prefill_32k: batch 32 -> 1, sequence 32768 -> "
                        f"{p_len}, for the phase's time",
                        f"decode_32k: batch 128 -> {b}, cache 32768 -> "
                        f"{p_len + n_dec} entries, {n_dec} steps, for the "
                        f"phase's time"])
    print(f"  {arch_id} bf16 " + json.dumps(res), flush=True)
    if not (res["max_abs"] <= spec["max_abs"]
            and res["mean_abs"] <= spec["mean_abs"]
            and res["min_cos"] >= spec["cos"]):
        raise AssertionError(f"{arch_id} decode logits off the forward's "
                             f"at the positions held: max "
                             f"{r['max_abs'].tolist()}, mean "
                             f"{r['mean_abs'].tolist()}, cos "
                             f"{r['cos'].tolist()}, held "
                             f"{held.tolist()}")
    if cfg.is_moe:
        f32 = LM_SERVE_F32
        cut = cfg.replace(n_layers=f32["layers"], param_dtype="float32")
        model = tfm.init_params(cut, seed=0, device=dev)
        r = _decode_vs_forward(model, toks[:f32["batch"], :f32["prompt"]
                                           + f32["decode"]],
                               f32["prompt"], f32["decode"])
        del model
        torch.cuda.empty_cache()
        check = {"max_abs": float(r["max_abs"].max()),
                 "mean_abs": float(r["mean_abs"].max()),
                 "min_cos": float(r["cos"].min()),
                 "reduced": [f"the f32 decode check: depth {cfg.n_layers} "
                             f"-> {f32['layers']} (f32 parameters), prompt "
                             f"{f32['prompt']}, batch {f32['batch']}, "
                             f"{f32['decode']} steps; its prefill and "
                             f"forward at capacity factor E / top_k (no "
                             f"drop), {moe.drop_free(cfg).capacity_factor}"]}
        print(f"  {arch_id} f32 check " + json.dumps(check), flush=True)
        if not (check["max_abs"] <= f32["max_abs"]
                and check["min_cos"] >= f32["cos"]):
            raise AssertionError(f"{arch_id} f32 decode logits off the "
                                 f"forward's: max {r['max_abs'].tolist()}, "
                                 f"cos {r['cos'].tolist()}")
        res["f32_check"] = check
    return res


# ---- slice 17: the LM family on a mesh (LMPlacement), a world of one ----
# The placed driver (`run(dist_run=True, mesh_shape=(1, 1))`, NCCL) at
# gemma2-2b's train_4k with lm_train's batch and microbatches, 3 steps,
# against the unplaced lm_train_gemma2-2b run of the same call. Stated
# before the first run: the first loss bitwise (at one rank the placed
# forward is the unplaced one's arithmetic: the lookup's take kernel
# copies the same bf16 rows); the next two within LM_DIST_LOSS_RTOL (the
# tied table's gradient from the take's scatter sums a repeated token's
# rows in f32 in a fixed tree, F.embedding's backward in f32 in its own
# order, each rounded once; until slice 18 the bag's local-rows scatter
# added them in bf16 atomics: 2e-4 is about 4x the largest of five
# readings then, 1.03e-6, 1.04e-5, 2.73e-5, 1.9e-7 and 4.53e-5, NVIDIA
# H100 80GB HBM3, 700.00 W); the peak within
# LM_DIST_PEAK_TOL of the unplaced run's. Then
# one placed train step profiled at lm_profile's batch, its device time
# printed beside the unplaced step's of the same call. Then
# qwen2-moe-a2.7b's placed prefill and decode against the unplaced ones
# on the same weights (LM_DIST_SERVE: the prefill's last logits and the
# decode steps' held at LM_SERVE's bf16 tolerance at the rows and
# positions whose experts agree, as lm_serve holds its decode; the
# unplaced path against itself beside
# it, since the MoE's combine sums bf16 rows with atomics in no fixed
# order on the card, so that neither is bitwise), the bag's local-rows
# pair and the take pair at the two LM embedding shapes and the take pair
# at a BERT4Rec-shaped shard, and the byte plan of the training runs one
# card cannot hold on the (16, 16) production mesh.
LM_DIST = dict(arch="gemma2-2b", steps=3)
LM_DIST_LOSS_RTOL = 2e-4
LM_DIST_PEAK_TOL = 0.05
LM_DIST_SERVE = dict(arch="qwen2-moe-a2.7b", prompt=1024, batch=4, decode=8)
# (arch, tokens (batch, seq) of its main-path lookup): gemma2-2b's train
# batch at train_4k, qwen2-moe-a2.7b's serving prefill
LM_EMBED_SHAPES = (("gemma2-2b", 4, 4096), ("qwen2-moe-a2.7b", 4, 4096))
LM_PLAN_ARCHS = ("qwen2-moe-a2.7b", "qwen2.5-32b", "kimi-k2-1t-a32b")


TAKE_KERNELS = ("embedding_take_fwd_local", "embedding_take_bwd_local")
# BERT4Rec's item table (1,048,592 rows, D 64, f32) cut over a (1, 4)
# mesh's model axis: rank 1's rows and rank 3's (which hold the MASK id,
# n_items); the ids a fifth of a driver microbatch's candidates (8192 / 5
# sequences of 20 x 128, bert4rec_batch's draw), the MASK id at a tenth
# of the slots, as the sequence holds it (20 of 200)
B4R_TAKE = dict(tp=4, ranks=(1, 3), timed=1, sequences=8192 // 5,
                mask_share=0.1)


def _check_take(table, ids, row0, tag) -> dict:
    """The take pair against its plain versions on the shard `table`
    (rows [row0, row0 + v_loc)), ids (N,): the forward bitwise (zeros for
    an id outside); the scatter, with non-negative d_out in the table's
    dtype, over the rows the in-shard ids touch: bitwise the plain
    version on a row one slot names, within 1 ulp of the dtype (0 in f32)
    plus 2 n 2^-24 of the exact sum on a row n slots name (the plain sums
    add in index_add_'s atomic order, the kernel's in a fixed tree; each
    lies within (n - 1) 2^-24 of it), nothing written elsewhere, and
    bitwise the same over two runs. Returns the counts and errors."""
    import torch
    from repro_torch.kernels import embedding_bag as eb, ref
    v_loc, d = table.shape
    got = eb.embedding_take_fwd_local(table, ids, row0)
    if not torch.equal(got, ref.embedding_take_local_ref(table, ids, row0)):
        raise AssertionError(f"embedding_take_fwd_local {tag}: not bitwise "
                             f"the plain version")
    d_out = got.abs_()
    lid = ids.long() - row0
    ok = (lid >= 0) & (lid < v_loc)
    rows, inv, touches = torch.unique(lid[ok], return_inverse=True,
                                      return_counts=True)
    exact = torch.zeros((rows.numel(), d), dtype=torch.float64,
                        device=ids.device)
    exact.index_add_(0, inv, d_out[ok].double())
    grad = eb.embedding_take_bwd_local(d_out, ids, row0, v_loc)
    again = eb.embedding_take_bwd_local(d_out, ids, row0, v_loc)
    if not torch.equal(grad, again):
        raise AssertionError(f"embedding_take_bwd_local {tag}: two runs "
                             f"differ")
    del again
    want = ref.embedding_take_local_bwd_ref(d_out, ids, row0, v_loc)[rows]
    got_rows = grad[rows]
    if int(torch.count_nonzero(grad)) != int(torch.count_nonzero(got_rows)):
        raise AssertionError(f"embedding_take_bwd_local {tag}: writes rows "
                             f"no in-shard id names")
    once = touches == 1
    if not torch.equal(got_rows[once], want[once]):
        raise AssertionError(f"embedding_take_bwd_local {tag}: a row one "
                             f"slot names is not bitwise the plain version")
    ulp = 0.0
    if table.dtype == torch.bfloat16:
        ulp = _bf16_ulp(exact)
    err = (got_rows.double() - want.double()).abs()
    lim = ulp + 2 * touches.double()[:, None] * 2.0 ** -24 * exact
    if bool((err > lim).any()):
        raise AssertionError(f"embedding_take_bwd_local {tag}: "
                             f"{int((err > lim).sum())} elements off")
    res = {"in_shard_slots": int(ok.sum()), "slots": ids.numel(),
           "rows_touched": int(rows.numel()),
           "rows_touched_more_than_once": int((touches > 1).sum()),
           "most_touches": int(touches.max()) if touches.numel() else 0,
           "bwd_max_err": float(err.max()) if err.numel() else 0.0,
           "bwd_max_err_over_limit": float((err / lim.clamp(min=1e-300))
                                           .max()) if err.numel() else 0.0,
           "two_runs_bitwise": True}
    print(f"  take {tag} {str(table.dtype)[6:]}: forward bitwise, scatter "
          + json.dumps(res), flush=True)
    del grad, want, got_rows, exact, d_out, got
    return res


def _take_records(table, ids, row0, tag, chk) -> tuple:
    """The take pair timed on the shard `table` at ids (N,): each beside
    its plain version, its bound (forward: the ids, each distinct row
    read once, the output written once; scatter: d_out read once, the
    ids, each distinct gradient row written once) and the unsharded
    lookup's PyTorch call (F.embedding; index_add_ of the masked d_out
    rows into the gradient). Returns (forward, scatter) records."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import embedding_bag as eb, ref
    v_loc, d = table.shape
    e = table.element_size()
    n = ids.numel()
    lid = ids.long() - row0
    ok = (lid >= 0) & (lid < v_loc)
    flat = lid.clamp(0, v_loc - 1)
    uniq = int(torch.unique(flat[ok]).numel())
    inside = int(ok.sum())
    fwd = kernel_record(
        f"embedding_take_fwd_local {tag}",
        time_ms(lambda: eb.embedding_take_fwd_local(table, ids, row0), [()],
                kernel="embedding_take_fwd_kernel"),
        time_ms(lambda: ref.embedding_take_local_ref(table, ids, row0),
                [()]),
        time_ms(lambda: F.embedding(flat, table), [()]),
        cost_bound("take_fwd", n, v_loc, d, e, uniq), 0.0,
        shape=[n, v_loc, d], row0=row0, dtype=str(table.dtype)[6:],
        unique_rows=uniq, in_shard_slots=inside, checks=chk)
    d_out = torch.rand((n, d), device=ids.device).to(table.dtype)
    grad = torch.zeros_like(table)
    t = time_ms(lambda: eb.embedding_take_scatter(d_out, ids, grad, row0),
                [()], kernel="embedding_take_bwd")
    plain = time_ms(lambda: ref.embedding_take_local_bwd_ref(
        d_out, ids, row0, v_loc), [()], iters=3)
    upd = d_out * ok[:, None].to(d_out.dtype)
    lib = time_ms(lambda: grad.index_add_(0, flat, upd), [()])
    bwd = kernel_record(
        f"embedding_take_bwd_local {tag}", t, plain, lib,
        cost_bound("take_bwd", n, v_loc, d, e, uniq, inside), 0.0,
        shape=[n, v_loc, d], row0=row0, dtype=str(table.dtype)[6:],
        unique_rows=uniq, in_shard_slots=inside,
        plan=dict(vars(eb.take_bwd_plan(n, v_loc, d, e))))
    del grad, d_out, upd
    torch.cuda.empty_cache()
    return fwd, bwd


def _lm_local_kernels(arch_id: str, b: int, seq: int) -> dict:
    """Both local-rows pairs at an LM's whole vocab as one shard (the
    lookup of a world of one rank), bf16, ids of b x seq TokenStream
    tokens: the bag's local-rows mode as it ran before the take pair
    (`_check_local`, then each timed beside its plain version, its bound
    and the unplaced lookup's own PyTorch call: F.embedding forward;
    index_add_ of the rows for the scatter), then the take pair, the
    lookup's now (`_check_take`, `_take_records`)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import embedding_bag as eb, ref
    dev = torch.device("cuda")
    cfg = get_arch(arch_id).model
    v, d = cfg.vocab_size, cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(27)
    toks = torch.from_numpy(TokenStream(v, seq).batch(b)["tokens"]).to(dev)
    ids = toks.reshape(-1, 1, 1).to(torch.int32)
    n = ids.shape[0]
    tag = f"{arch_id} ({n}, 1, 1) into (1, {v}, {d})"
    tables = torch.empty((1, v, d), dtype=torch.bfloat16, device=dev)
    tables.normal_(generator=gen)
    chk = _check_local(tables, ids, 0, tag)
    tables.normal_(generator=gen)
    uniq = int(torch.unique(ids).numel())
    flat = ids.view(-1).long()
    fwd = kernel_record(
        f"embedding_bag_fwd local bf16 {tag}",
        time_ms(lambda: eb.embedding_bag_fwd(tables, ids, row0=0), [()],
                kernel="embedding_bag_fwd_kernel"),
        time_ms(lambda: ref.embedding_bag_local_ref(tables, ids, 0), [()]),
        time_ms(lambda: F.embedding(flat, tables[0]), [()]),
        cost_bound("bag_fwd", n, 1, 1, v, d, 2, uniq), 0.0,
        shape=[n, 1, 1, v, d], unique_rows=uniq, checks=chk)
    d_out = torch.randn((n, 1, d), device=dev, generator=gen) \
        .to(torch.bfloat16).float()
    grad = tables.zero_()
    t = time_ms(lambda: eb.embedding_bag_scatter(d_out, ids, grad, row0=0),
                [()], kernel="embedding_bag_bwd_kernel")
    plain = time_ms(lambda: ref.embedding_bag_local_bwd_ref(
        d_out, ids, 0, v, dtype=torch.bfloat16), [()], iters=3)
    upd = d_out.view(n, d).to(torch.bfloat16)
    lib = time_ms(lambda: grad[0].index_add_(0, flat, upd), [()])
    bwd = kernel_record(
        f"embedding_bag_bwd local bf16 {tag}", t, plain, lib,
        cost_bound("bag_bwd", n, 1, 1, v, d, 2, uniq), 0.0,
        shape=[n, 1, 1, v, d], unique_rows=uniq)
    del grad, d_out, upd
    table = tables.view(v, d)
    table.normal_(generator=gen)
    ids1 = ids.view(-1)
    take_tag = f"bf16 {arch_id} ({n},) into ({v}, {d})"
    chk = _check_take(table, ids1, 0, take_tag)
    table.normal_(generator=gen)
    take_fwd, take_bwd = _take_records(table, ids1, 0, take_tag, chk)
    del tables, table
    torch.cuda.empty_cache()
    return {"fwd": fwd, "bwd": bwd, "take_fwd": take_fwd,
            "take_bwd": take_bwd}


def _b4r_take_kernels() -> dict:
    """The take pair at B4R_TAKE's BERT4Rec-shaped f32 shards: checked at
    each rank (`_check_take`), timed at rank `timed`. Returns {"fwd":
    {tag: record}, "bwd": {tag: record}}."""
    import numpy as np
    import torch
    from repro_torch.configs.bert4rec import MODEL as B4R
    from repro_torch.data.synthetic import bert4rec_batch
    dev = torch.device("cuda")
    rng = np.random.RandomState(28)
    batch = bert4rec_batch(rng, B4R_TAKE["sequences"], B4R.seq_len,
                           B4R.n_items, B4R.n_mask, B4R.n_negatives)
    cand = np.concatenate([batch["mask_labels"][..., None],
                           batch["neg_ids"]], -1).reshape(-1)
    cand[rng.rand(cand.size) < B4R_TAKE["mask_share"]] = B4R.n_items
    ids = torch.from_numpy(cand.astype(np.int32)).to(dev)
    vocab = -(-(B4R.n_items + 2) // 16) * 16
    v_loc, d = vocab // B4R_TAKE["tp"], B4R.embed_dim
    gen = torch.Generator(device=dev).manual_seed(28)
    out = {"fwd": {}, "bwd": {}}
    for rank in B4R_TAKE["ranks"]:
        row0 = rank * v_loc
        table = torch.empty((v_loc, d), device=dev)
        table.normal_(generator=gen).mul_(d ** -0.5)
        tag = (f"f32 bert4rec rank {rank} of {B4R_TAKE['tp']}: "
               f"({ids.numel()},) into ({v_loc}, {d}) at row {row0}")
        chk = _check_take(table, ids, row0, tag)
        if rank == B4R_TAKE["timed"]:
            key = f"bert4rec_rank{rank}"
            out["fwd"][key], out["bwd"][key] = _take_records(
                table, ids, row0, tag, chk)
        del table
        torch.cuda.empty_cache()
    return out


def _serve_run(model, toks, p_len: int, n_dec: int, placement=None):
    """Prefill of toks[:, :p_len] and n_dec decode steps (unplaced into a
    cache of p_len + n_dec entries, or through `placement`, whose cache
    has them): (last prefill logits, each step's logits, each step's
    routing, seconds of prefill and of decode, the prefill's routing of
    each row's last position)."""
    import torch
    from repro_torch.models import transformer as tfm
    cfg = model.cfg
    if toks.is_cuda:
        torch.cuda.synchronize()
    t0 = time.monotonic()
    pre_route = []
    last, cache = tfm.prefill(model, toks[:, :p_len], routing=pre_route,
                              placement=placement)
    pre_route = [r.view(toks.shape[0], p_len, -1)[:, -1].sort(-1).values
                 for r in pre_route]
    if placement is None:
        big = tfm.init_cache(cfg, toks.shape[0], p_len + n_dec,
                             dtype=cache["k"].dtype, device=toks.device)
        for n in ("k", "v"):
            big[n][:, :, :p_len] = cache[n]
        cache = big
    if toks.is_cuda:
        torch.cuda.synchronize()
    t1 = time.monotonic()
    logits, routes = [], []
    for pos in range(p_len, p_len + n_dec):
        route = []
        lg, cache = tfm.decode_step(model, cache, toks[:, pos], pos,
                                    routing=route, placement=placement)
        logits.append(lg)
        routes.append([r.sort(-1).values for r in route])
    if toks.is_cuda:
        torch.cuda.synchronize()
    return last, logits, routes, t1 - t0, time.monotonic() - t1, pre_route


def phase_lm_dist(unplaced: dict, unplaced_device_ms: float) -> dict:
    """Slice 17 (see LM_DIST above): the placed gemma2-2b driver against
    `unplaced` (lm_train_gemma2-2b's result) and a profiled placed step
    against `unplaced_device_ms` (lm_profile_gemma2-2b's), the placed
    qwen2-moe serve path against the unplaced one, the local-rows kernels
    at the LM embedding shapes and the byte plan. Returns {kernel name:
    {"launches": the placed driver's, "serve_launches": the placed serve
    path's, "<arch>": the kernel's record at that shape}}."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train
    from repro_torch.launch.programs import LMPlacement, rank_bytes
    from repro_torch.models import transformer as tfm

    out = {k: {} for k in DIST_KERNELS + TAKE_KERNELS}
    if os.path.exists(DIST_PG_FILE):
        os.remove(DIST_PG_FILE)
    dev = mesh_lib.init_distributed("cuda", rank=0, world_size=1,
                                    init_method=f"file://{DIST_PG_FILE}")
    try:
        arch_id, spec = LM_DIST["arch"], LM_TRAIN[LM_DIST["arch"]]
        ops.reset_launch_counts()
        res = train.run(arch_id, steps=LM_DIST["steps"], batch=spec["batch"],
                        shape=get_arch(arch_id).shape("train_4k"), full=True,
                        lr=spec["lr"], microbatches=spec["microbatches"],
                        device="cuda", log_every=1, dist_run=True,
                        mesh_shape=(1, 1))
        counts = ops.launch_counts()
        for k in DIST_KERNELS + TAKE_KERNELS:
            out[k]["launches"] = counts[k]
        losses = res["losses"]
        want = unplaced["losses"][:len(losses)]
        peak, peak0 = res["max_memory_allocated"], \
            unplaced["max_memory_allocated"]
        summary = {"losses": losses, "unplaced_losses": want,
                   "bitwise": losses == want,
                   "max_rel_diff": max(abs(a - b) / abs(b)
                                       for a, b in zip(losses, want)),
                   "tokens_per_s": res["tokens_per_s"],
                   "unplaced_tokens_per_s": unplaced["tokens_per_s"],
                   "warm_step_s": res["warm_step_s"],
                   "unplaced_warm_step_s": unplaced["warm_step_s"],
                   "max_memory_allocated": peak,
                   "unplaced_max_memory_allocated": peak0,
                   "peak_ratio": peak / peak0, "mesh": res["mesh"],
                   "launches": {k: counts[k]
                                for k in DIST_KERNELS + TAKE_KERNELS}}
        print(f"  lm_dist {arch_id} train_4k " + json.dumps(summary),
              flush=True)
        if losses[0] != want[0]:
            raise AssertionError(f"lm_dist first loss {losses[0]} is not "
                                 f"the unplaced driver's {want[0]}")
        if not all(abs(a - b) <= LM_DIST_LOSS_RTOL * abs(b)
                   for a, b in zip(losses, want)):
            raise AssertionError(f"lm_dist losses {losses} off the "
                                 f"unplaced {want}")
        if not peak <= (1 + LM_DIST_PEAK_TOL) * peak0:
            raise AssertionError(f"lm_dist peak {peak} over {peak0}")
        n_mb = LM_DIST["steps"] * spec["microbatches"]
        if min(counts[k] for k in TAKE_KERNELS) < n_mb \
                or any(counts[k] for k in DIST_KERNELS):
            raise AssertionError(f"lm_dist launches {counts}: the lookup "
                                 f"takes the take pair each microbatch, "
                                 f"and the bag's local-rows mode never")
        torch.cuda.empty_cache()
        placed_ms = phase_lm_profile(arch_id, mesh=mesh_lib.make_mesh(
            1, 1, dev, exchange_one_shard=True))
        print(f"  lm_dist {arch_id} profiled train step (batch "
              f"{spec['profile_batch']}): placed {placed_ms:.3f} ms, "
              f"unplaced {unplaced_device_ms:.3f} ms of device time "
              f"(ratio {placed_ms / unplaced_device_ms:.4f})", flush=True)
        torch.cuda.empty_cache()

        sv = LM_DIST_SERVE
        cfg = get_arch(sv["arch"]).model
        p_len, b, n_dec = sv["prompt"], sv["batch"], sv["decode"]
        toks = torch.from_numpy(TokenStream(cfg.vocab_size, p_len + n_dec)
                                .batch(b)["tokens"]).to(dev)
        model = tfm.init_params(cfg, seed=0, device=dev)
        base = _serve_run(model, toks, p_len, n_dec)
        # the unplaced path against itself: the MoE's combine (index_add
        # of bf16 rows, atomics on the card) sums in no fixed order
        again = _serve_run(model, toks, p_len, n_dec)
        mesh = mesh_lib.make_mesh(1, 1, dev, exchange_one_shard=True)
        pl = LMPlacement(mesh, cfg, kind="decode", batch=b,
                         cache_len=p_len + n_dec)
        pl.shard_model(model)
        ops.reset_launch_counts()
        got = _serve_run(model, toks, p_len, n_dec, placement=pl)
        counts = ops.launch_counts()
        for k in DIST_KERNELS + TAKE_KERNELS:
            out[k]["serve_launches"] = counts[k]
        del model
        torch.cuda.empty_cache()

        def held_to(run):
            """(positions whose experts agree with `base`'s, the logits'
            max and mean |diff| and min cosine there, bitwise), the
            prefill's last position first, then each decode step."""
            flips = torch.zeros((b, 1 + n_dec), dtype=torch.bool,
                                device=dev)
            for r0, r1 in zip(base[5], run[5]):
                flips[:, 0] |= (r0 != r1).any(-1)
            for i in range(n_dec):
                for r0, r1 in zip(base[2][i], run[2][i]):
                    flips[:, 1 + i] |= (r0 != r1).any(-1)
            held = ~flips
            a = torch.cat([run[0].float()[:, None],
                           torch.stack(run[1], 1)], 1)
            w = torch.cat([base[0].float()[:, None],
                           torch.stack(base[1], 1)], 1)
            diff = (a - w).abs()
            cos = torch.nn.functional.cosine_similarity(a, w, dim=-1)
            return held, {
                "prefill_bitwise": bool(torch.equal(run[0], base[0])),
                "decode_bitwise": bool(torch.equal(a[:, 1:], w[:, 1:])),
                "prefill_flips": int(flips[:, 0].sum()),
                "flips": int(flips[:, 1:].sum()),
                "positions": flips[:, 1:].numel(),
                "max_abs": float(diff.amax(-1)[held].max()) if bool(
                    held.any()) else None,
                "mean_abs": float(diff.mean(-1)[held].max()) if bool(
                    held.any()) else None,
                "min_cos": float(cos[held].min()) if bool(held.any())
                else None,
                "prefill_max_abs": float(diff[:, 0].amax(-1)[held[:, 0]]
                                         .max()) if bool(held[:, 0].any())
                else None}

        held, res_s = held_to(got)
        res_s.update(unplaced_twice=held_to(again)[1],
                     prefill_s=got[3], unplaced_prefill_s=base[3],
                     decode_step_s=got[4] / n_dec,
                     unplaced_decode_step_s=base[4] / n_dec,
                     launches={k: counts[k]
                               for k in DIST_KERNELS + TAKE_KERNELS},
                     reduced=[f"prompt {p_len}, batch {b}, {n_dec} decode "
                              f"steps, for the phase's time"])
        lim = LM_SERVE[sv["arch"]]
        print(f"  lm_dist {sv['arch']} serve " + json.dumps(res_s),
              flush=True)
        if not bool(held.any()) or not (
                res_s["max_abs"] <= lim["max_abs"]
                and res_s["mean_abs"] <= lim["mean_abs"]
                and res_s["min_cos"] >= lim["cos"]):
            raise AssertionError(f"lm_dist serve off the unplaced path: "
                                 f"{res_s}")
        if counts["embedding_take_fwd_local"] < 1 + n_dec \
                or any(counts[k] for k in DIST_KERNELS):
            raise AssertionError(f"lm_dist serve launches {counts}")
    finally:
        torch.distributed.destroy_process_group()

    for arch_id, b, seq in LM_EMBED_SHAPES:
        recs = _lm_local_kernels(arch_id, b, seq)
        out["embedding_bag_fwd_local"][arch_id] = recs["fwd"]
        out["embedding_bag_bwd_local"][arch_id] = recs["bwd"]
        out["embedding_take_fwd_local"][arch_id] = recs["take_fwd"]
        out["embedding_take_bwd_local"][arch_id] = recs["take_bwd"]
    recs = _b4r_take_kernels()
    out["embedding_take_fwd_local"].update(recs["fwd"])
    out["embedding_take_bwd_local"].update(recs["bwd"])

    for arch_id in LM_PLAN_ARCHS:
        arch = get_arch(arch_id)
        plan = rank_bytes(arch_id, "train_4k", (16, 16))
        print(f"  byte plan {arch_id} train_4k on (16, 16): " + json.dumps(
            {"one_device_bytes": train.lm_state_bytes(arch.model,
                                                      arch.optimizer),
             **plan}), flush=True)
    return out


# slice 20: the dry run's plans of dist_dlrm's and lm_dist's runs (a world
# of one rank, --mesh 1,1) against the card. The peak band is stated in
# PERF.md before the run that tests it: the plan's peak within 2% of the
# card step's torch.cuda.max_memory_allocated, where both plans have read
# within 0.12% (the plan counts each storage in 512-byte blocks as the
# caching allocator does, but not the allocator's segments, cuBLAS'
# workspaces or NCCL's buffers)
DRYRUN_CELLS = {"dlrm-criteo": dict(shape="train_batch", batch=None,
                                    microbatches=1),
                "gemma2-2b": dict(shape="train_4k",
                                  batch=LM_TRAIN["gemma2-2b"]["batch"],
                                  microbatches=LM_TRAIN["gemma2-2b"]
                                  ["microbatches"])}
DRYRUN_PEAK_BAND = 0.02
DRYRUN_DIR = os.path.join(ROOT, "build", "chip_smoke_dryrun")


def start_dryrun_plans() -> dict:
    """One `python -m repro_torch.launch.dryrun --mesh 1,1` a cell of
    DRYRUN_CELLS, each a fresh interpreter with a fake process group of
    its own, started together; their records go under DRYRUN_DIR."""
    import importlib.util
    import shutil
    if importlib.util.find_spec(
            "torch.testing._internal.distributed.fake_pg") is None:
        raise AssertionError("this torch has no fake process group "
                             "(torch.testing._internal.distributed.fake_pg)"
                             ": the dry run cannot plan on it")
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    os.makedirs(DRYRUN_DIR)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = {}
    for arch_id, c in DRYRUN_CELLS.items():
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch_id, "--shape", c["shape"], "--mesh", "1,1",
               "--microbatches", str(c["microbatches"]), "--out",
               DRYRUN_DIR]
        if c["batch"]:
            cmd += ["--batch", str(c["batch"])]
        with open(os.path.join(DRYRUN_DIR, f"{arch_id}.log"), "w") as log:
            procs[arch_id] = subprocess.Popen(cmd, cwd=ROOT, env=env,
                                              stdout=log,
                                              stderr=subprocess.STDOUT)
    return procs


def _card_step(arch, c, mesh, dev) -> dict:
    """The placed program of a DRYRUN_CELLS cell built on the card and one
    step of it under launch/step_analysis: its resident bytes by the sum
    of numel x element_size, the counters, and the step's
    max_memory_allocated from the program's own bytes on."""
    import torch
    from repro_torch.launch.programs import build_program
    from repro_torch.launch.step_analysis import analyze, tensors_of
    prog = build_program(arch, arch.shape(c["shape"]), mesh, dev,
                         batch=c["batch"], microbatches=c["microbatches"])
    params = sum(p.numel() * p.element_size()
                 for p in prog.model.parameters())
    opt = sum(t.numel() * t.element_size()
              for t in tensors_of(prog.opt_state))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    res = analyze(prog.fn, *prog.args)
    torch.cuda.synchronize()
    out = {"params": params, "opt_state": opt,
           "resident_bytes": res["resident_bytes"],
           "dot_flops": res["dot_flops"], "launches": res["launches"],
           "collective_bytes": res["collective_bytes"],
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "step_s": time.monotonic() - t0,
           "loss": float(res["out"][2]["loss"])}
    del prog, res
    torch.cuda.empty_cache()
    return out


def phase_dryrun() -> dict:
    """Slice 20 (see DRYRUN_CELLS): the plans of start_dryrun_plans, which
    run while the card takes its steps of the same programs, on an NCCL
    group of one rank, held against those steps. Fails on a plan that
    erred or was not written, resident or FLOP or launch counts that
    differ, or a peak outside the band."""
    procs = start_dryrun_plans()
    try:
        return _dryrun_against_card(procs)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def _dryrun_against_card(procs) -> dict:
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import mesh as mesh_lib

    if os.path.exists(DIST_PG_FILE):
        os.remove(DIST_PG_FILE)
    dev = mesh_lib.init_distributed("cuda", rank=0, world_size=1,
                                    init_method=f"file://{DIST_PG_FILE}")
    card = {}
    try:
        mesh = mesh_lib.make_mesh(1, 1, dev, exchange_one_shard=True)
        for arch_id, c in DRYRUN_CELLS.items():
            card[arch_id] = _card_step(get_arch(arch_id), c, mesh, dev)
    finally:
        torch.distributed.destroy_process_group()
    out, bad = {"card": card_line()}, []
    for arch_id, c in DRYRUN_CELLS.items():
        procs[arch_id].wait(timeout=300)
        path = os.path.join(DRYRUN_DIR, "mesh1x1",
                            f"{arch_id}__{c['shape']}.json")
        if procs[arch_id].returncode != 0 or not os.path.exists(path):
            with open(os.path.join(DRYRUN_DIR, f"{arch_id}.log")) as f:
                log = f.read()
            raise AssertionError(f"dryrun plan of {arch_id} failed "
                                 f"({procs[arch_id].returncode}):\n"
                                 f"{log[-3000:]}")
        with open(path) as f:
            plan = json.load(f)
        mem, got = plan["memory"], card[arch_id]
        row = {"plan_s": plan["plan_s"], "plan_params": mem["params"],
               "card_params": got["params"],
               "plan_opt_state": mem["opt_state"],
               "card_opt_state": got["opt_state"],
               "plan_resident": mem["resident_bytes"],
               "card_resident": got["resident_bytes"],
               "plan_dot_flops": plan["dot_flops"],
               "card_dot_flops": got["dot_flops"],
               "plan_launches": plan["launches"],
               "card_launches": got["launches"],
               "plan_collective_bytes": plan["collective_bytes"],
               "card_collective_bytes": got["collective_bytes"],
               "plan_peak": mem["peak_bytes"],
               "card_max_memory_allocated": got["max_memory_allocated"],
               "peak_ratio": mem["peak_bytes"] / got["max_memory_allocated"],
               "card_step_s": got["step_s"], "card_loss": got["loss"]}
        out[arch_id] = row
        if (row["plan_params"], row["plan_opt_state"]) != \
                (row["card_params"], row["card_opt_state"]):
            bad.append(f"{arch_id} resident bytes")
        if row["plan_dot_flops"] != row["card_dot_flops"] \
                or row["plan_launches"] != row["card_launches"]:
            bad.append(f"{arch_id} dot FLOPs or launches")
        if not abs(row["peak_ratio"] - 1.0) <= DRYRUN_PEAK_BAND:
            bad.append(f"{arch_id} peak ratio {row['peak_ratio']:.4f}")
        if not math.isfinite(row["card_loss"]):
            bad.append(f"{arch_id} loss {row['card_loss']}")
    print("  dryrun " + json.dumps(out), flush=True)
    if bad:
        raise AssertionError(f"dryrun plan against the card: {bad}")
    return out


def phase_kernels_bench() -> list:
    """benchmarks/torch_kernels_bench.py on the card: each kernel against
    its plain version (as the `kernels` phase holds it; the bench raises
    on a disagreement), its plain version and the reference's oracle
    timed, with its bound."""
    from benchmarks import torch_kernels_bench
    rows = torch_kernels_bench.run("cuda")
    if {r["kernel"] for r in rows} != {"embedding_bag", "embedding_bag_fused",
                                       "dot_interact", "sage_aggregate"}:
        raise AssertionError(f"kernel bench rows: {rows}")
    return rows


def phase_roofline() -> list:
    """benchmarks/torch_roofline.py over STEPS_JSON: the LM train cells
    and the dlrm-criteo driver cell, each with both terms."""
    from benchmarks import torch_roofline
    rows = torch_roofline.run(STEPS_JSON)
    cells = {(r["arch"], r["shape"]) for r in rows}
    want = {("smollm-135m", "train_4k"), ("gemma2-2b", "train_4k"),
            ("dlrm-criteo", "train_batch")}
    if not want <= cells:
        raise AssertionError(f"roofline covers {cells}, not {want}")
    return rows


SOURCES = {
    "embedding_bag_fwd": ("src/repro_torch/kernels/csrc/embedding_bag.cu",
                          "src/repro/kernels/embedding_bag.py:75"),
    "embedding_bag_bwd": ("src/repro_torch/kernels/csrc/embedding_bag.cu",
                          "src/repro/kernels/embedding_bag.py:75"),
    # the row kernels' local-rows mode (slice 16): the row-sharded lookup
    # of repro/models/embedding.py:137-251 runs the TPU kernel's function
    # on each rank's rows
    "embedding_bag_fwd_local": (
        "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "src/repro/kernels/embedding_bag.py:75"),
    "embedding_bag_bwd_local": (
        "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "src/repro/kernels/embedding_bag.py:75"),
    # the take pair (slice 18): the vocab-sharded lookup's masked take of
    # repro/models/embedding.py:72-78, the TPU kernel's bag of one on one
    # rank's rows
    "embedding_take_fwd_local": (
        "src/repro_torch/kernels/csrc/embedding_take.cu",
        "src/repro/kernels/embedding_bag.py:75"),
    "embedding_take_bwd_local": (
        "src/repro_torch/kernels/csrc/embedding_take.cu",
        "src/repro/kernels/embedding_bag.py:75"),
    "embedding_bag_fused_fwd": (
        "src/repro_torch/kernels/csrc/embedding_bag_fused.cu",
        "src/repro/kernels/embedding_bag.py:135"),
    "dot_interact_fwd": ("src/repro_torch/kernels/csrc/dot_interact.cu",
                         "src/repro/kernels/dot_interact.py:51"),
    "dot_interact_bwd": ("src/repro_torch/kernels/csrc/dot_interact.cu",
                         "src/repro/kernels/dot_interact.py:51"),
    "sage_aggregate_fwd": ("src/repro_torch/kernels/csrc/sage_aggregate.cu",
                           "src/repro/kernels/sage_aggregate.py:32"),
    "sage_aggregate_bwd": ("src/repro_torch/kernels/csrc/sage_aggregate.cu",
                           "src/repro/kernels/sage_aggregate.py:32"),
}


def main() -> int:
    # the kernels are built from the checkout's sources: a copy of this
    # script elsewhere has none to build and exits as without a card
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print(f"chip_smoke: {os.path.join(ROOT, 'src', 'repro_torch')} is "
              f"missing; run this script from the root of the repository",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs one GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    agent_procs = start_agent_pretrain()
    try:
        return run_phases(agent_procs)
    finally:
        for proc in agent_procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def run_phases(agent_procs) -> int:
    import torch
    from repro_torch.configs.dlrm_criteo import ARCH as DLRM_ARCH
    from repro_torch.configs.dlrm_criteo import MODEL
    from repro_torch.configs.bert4rec import ARCH as B4R_ARCH
    from repro_torch.configs.dien import ARCH as DIEN_ARCH
    from repro_torch.configs.graphsage_reddit import ARCH as GNN_ARCH
    from repro_torch.configs.wide_deep import ARCH as WD_ARCH
    from repro_torch.configs.xdeepfm import ARCH as XD_ARCH
    gnn_shape = GNN_ARCH.shape("minibatch_lg")
    gnn_cfg = GNN_ARCH.model

    if os.path.exists(STEPS_JSON):
        os.remove(STEPS_JSON)
    with Phase("build"):
        phase_build()
    with Phase("kernels"):
        recs = phase_kernels(MODEL)
        torch.cuda.empty_cache()
        recs.update(phase_sage_kernels(gnn_shape, gnn_cfg))
    torch.cuda.empty_cache()
    with Phase("model"):
        phase_model(MODEL)
    torch.cuda.empty_cache()
    with Phase("loop"):
        launches = phase_loop(MODEL)
    torch.cuda.empty_cache()
    with Phase("idle_tail"):
        tail_launches = phase_idle_tail(MODEL)
    torch.cuda.empty_cache()
    with Phase("profile"):
        phase_profile(MODEL)
    torch.cuda.empty_cache()
    with Phase("train_feed"):
        feed_launches = phase_train_feed(agent_procs)
    torch.cuda.empty_cache()
    with Phase("checkpoint"):
        ckpt_launches = phase_checkpoint(MODEL)
    for name in DLRM_KERNELS:
        recs[name].update(idle_tail_launches=tail_launches[name],
                          train_feed_launches=feed_launches[name],
                          checkpoint_launches=ckpt_launches[name])
    torch.cuda.empty_cache()
    with Phase("fleet_sim"):
        phase_fleet_sim(agent_procs)
    with Phase("fleet_live"):
        phase_fleet_live()
    with Phase("api_tune"):
        phase_api_tune()
    with Phase("quickstart"):
        qs_recs = phase_quickstart()
    for name in DLRM_KERNELS:
        recs[name]["quickstart"] = qs_recs[name]
    torch.cuda.empty_cache()
    with Phase("graph"):
        sampler = build_graph(gnn_shape, gnn_cfg)
    with Phase("gnn_model"):
        phase_gnn_model(gnn_shape, gnn_cfg, sampler)
    torch.cuda.empty_cache()
    with Phase("gnn_loop"):
        launches.update(phase_gnn_loop(gnn_shape, sampler))
    torch.cuda.empty_cache()
    with Phase("gnn_profile"):
        phase_gnn_profile(gnn_shape, gnn_cfg, sampler)
    del sampler
    torch.cuda.empty_cache()
    with Phase("gnn_full_model"):
        phase_gnn_full_model(GNN_ARCH)
    torch.cuda.empty_cache()
    with Phase("gnn_full_graph"):
        phase_gnn_full_graph(GNN_ARCH)
    torch.cuda.empty_cache()
    with Phase("gnn_molecule"):
        phase_gnn_molecule(GNN_ARCH)
    torch.cuda.empty_cache()
    with Phase("recsys_kernels"):
        fused_rec, wd_errs = phase_recsys_kernels(WD_ARCH.model)
        recs.update(fused_rec)
    torch.cuda.empty_cache()
    with Phase("recsys_model"):
        phase_recsys_model(WD_ARCH.model)
    torch.cuda.empty_cache()
    with Phase("recsys_loop"):
        wd_launches = phase_recsys_loop(WD_ARCH)
    launches["embedding_bag_fused_fwd"] = wd_launches.pop(
        "embedding_bag_fused_fwd")
    for name, n in wd_launches.items():
        recs[name]["wide_deep_launches"] = n
        recs[name]["wide_deep_max_abs_err"] = wd_errs[name]
    torch.cuda.empty_cache()
    with Phase("recsys_profile"):
        in_step = phase_recsys_profile(WD_ARCH)
    recs["embedding_bag_fused_fwd"]["in_step_ms"] = \
        in_step["embedding_bag_fused_fwd"]
    recs["embedding_bag_fused_fwd"]["embedding_bag_fwd_d32"]["in_step_ms"] \
        = in_step["embedding_bag_fwd"]
    torch.cuda.empty_cache()
    with Phase("dlrm_bf16_bwd"):
        bf16_recs = phase_dlrm_bf16_bwd(DLRM_ARCH)
    torch.cuda.empty_cache()
    with Phase("dlrm_model_bf16"):
        phase_dlrm_model_bf16(DLRM_ARCH)
    torch.cuda.empty_cache()
    with Phase("dlrm_driver"):
        drv_launches, drv_losses = phase_dlrm_driver(DLRM_ARCH)
    torch.cuda.empty_cache()
    with Phase("dlrm_driver_profile"):
        model, drv_in_step = phase_dlrm_driver_profile(DLRM_ARCH)
    with Phase("dlrm_retrieval"):
        phase_dlrm_retrieval(model, DLRM_ARCH)
    del model
    torch.cuda.empty_cache()
    # slice 16: the row-sharded lookup's kernels, the collectives on NCCL
    # and dlrm-criteo through them, after the unsharded model is freed
    with Phase("dist_kernels"):
        recs.update(phase_dist_kernels(DLRM_ARCH))
    torch.cuda.empty_cache()
    with Phase("dist_collectives"):
        phase_dist_collectives(DLRM_ARCH)
    with Phase("dist_dlrm"):
        dist_launches = phase_dist_dlrm(DLRM_ARCH, drv_losses)
    for name in DIST_KERNELS:
        launches[name] = dist_launches[name]
    torch.cuda.empty_cache()
    # each DLRM kernel in bf16 at dlrm-criteo's training shapes, with its
    # launches and time in the step on the driver's path
    for name in DLRM_KERNELS:
        recs[name]["dlrm_criteo"] = dict(
            bf16_recs[name], launches=drv_launches[name],
            in_step_ms=drv_in_step[name])
    seq_archs = (XD_ARCH, DIEN_ARCH, B4R_ARCH)
    with Phase("recsys_seq_kernels"):
        seq_recs = phase_recsys_seq_kernels(seq_archs, SEQ_MICROBATCHES)
    torch.cuda.empty_cache()
    seq_launches, seq_in_step = {}, {}
    for arch in seq_archs:
        k = SEQ_MICROBATCHES[arch.arch_id]
        with Phase(f"{arch.arch_id}_model"):
            phase_seq_model(arch, SEQ_MODEL_BATCH[arch.arch_id])
        torch.cuda.empty_cache()
        with Phase(f"{arch.arch_id}_driver"):
            seq_launches[arch.arch_id] = phase_seq_driver(arch, k)
        torch.cuda.empty_cache()
        with Phase(f"{arch.arch_id}_profile"):
            seq_in_step[arch.arch_id] = phase_seq_profile(arch, k)
        torch.cuda.empty_cache()
    with Phase("recsys_retrieval"):
        phase_recsys_retrieval((WD_ARCH,) + seq_archs)
    torch.cuda.empty_cache()
    # each embedding kernel at each lookup of the three models, with its
    # launches and time in the step on that model's driver path
    for name, by_lookup in seq_recs.items():
        for tag, rec in by_lookup.items():
            arch_id = tag.split("_")[0]
            recs[name][tag] = dict(
                rec, launches=seq_launches[arch_id][name],
                in_step_ms=seq_in_step[arch_id].get(name))
    for name, by in run_lm_phases().items():
        lm_launches, serve = by.pop("launches"), by.pop("serve_launches")
        if name in TAKE_KERNELS:
            # the take pair's main path is the placed LM's lookup: its
            # record is gemma2-2b's shape, the others under `lm`
            recs[name] = dict(by.pop(LM_DIST["arch"]), lm=by,
                              lm_serve_launches=serve)
            launches[name] = lm_launches
        else:
            recs[name].update(lm_dist_launches=lm_launches,
                              lm_serve_launches=serve, lm=by)
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": tpu, "launches": launches[name], **recs[name]}
               for name, (src, tpu) in SOURCES.items()]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_lm_phases() -> dict:
    """Slice 15's phases: the LM family unplaced (no kernel of the
    `kernels` line lies on its path), then slice 17's `lm_dist` (the
    placed LM, whose lookup runs the take pair of slice 18), slice 20's
    `dryrun`, the kernel benchmark and the roofline. Returns lm_dist's
    records."""
    import torch
    with Phase("lm_attention"):
        phase_lm_attention()
    torch.cuda.empty_cache()
    trained, device_ms = {}, {}
    for arch_id in LM_TRAIN:
        with Phase(f"lm_train_{arch_id}"):
            trained[arch_id] = phase_lm_train(arch_id)
        with Phase(f"lm_profile_{arch_id}"):
            device_ms[arch_id] = phase_lm_profile(arch_id)
    for arch_id in LM_SERVE:
        with Phase(f"lm_serve_{arch_id}"):
            phase_lm_serve(arch_id)
    torch.cuda.empty_cache()
    with Phase("lm_dist"):
        dist_recs = phase_lm_dist(trained[LM_DIST["arch"]],
                                  device_ms[LM_DIST["arch"]])
    torch.cuda.empty_cache()
    with Phase("dryrun"):
        phase_dryrun()
    torch.cuda.empty_cache()
    with Phase("kernels_bench"):
        phase_kernels_bench()
    with Phase("roofline"):
        phase_roofline()
    return dist_recs


if __name__ == "__main__":
    sys.exit(main())
