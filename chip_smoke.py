#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any mismatch raises and the run exits non-zero; the profiled
federation dispatches of every phase but main trace the device alone,
without the host's op events, which no printed number reads):

1. build   — compile every CUDA source of the paths with nvcc (all started
             at once: dp_clip_noise.cu, bank_codec.cu, tree_noise.cu,
             flash_attention.cu and ssm_scan.cu) into build/repro_torch/,
             print the seconds and, per kernel and template
             instantiation, ptxas' registers, stack and spills.
2. kernels — hold each kernel, through the wrappers the paths call,
             against its plain PyTorch version on the card at the main
             path's width (P = 152,783,616) and at a ragged P: dp_round
             bit for bit (also with acc = theta_bar = 0, which leaves only
             the in-kernel Laplace draw), sqnorm (also two launches, which
             must be bit-identical), absmax (two launches, bit-identical),
             encode (int8 and fp8, stochastic and deterministic) and
             decode, all bit for bit; all 256 fp8 patterns decode exactly;
             tree_delta at depth 4 for counts 0, 1, 2, 3, 6, 7 and 14
             (r = 0 to 3 retired levels), granted and refused, bit for bit
             on delta and the whole node tensor, and two launches on copies
             of one input give the same bits; the member axis of the
             grouped driver, one launch each: dp_round_rows and
             fused_sqnorm_rows over 8 rows of P = 152,783,616 and 3 of P
             = 1,000,003, tree_delta_rows_ over 3 owners at depth 4, row m
             bit for bit the single launch on row m; the column offset of
             a rank's slice on a device mesh: dp_round, encode (int8, fp8)
             and tree_delta over P = 152,783,616 cut in two and in three
             uneven parts, each part launched with col0 = its first column
             equal to the full launch's columns bit for bit, and the
             parts' absmax partials reduced to the row's scale; scale_noise through
             fused_scale_noise_tree and dp_privatize_tree on the 12
             DENSE_124M leaves and on one leaf of P = 1,000,003, bit for
             bit on every leaf; flash_attention, causal, at zamba2's shape
             (B 2, S 4096, H = Kv = 32, hd 80), yi-6b's (B 1, S 4096, H 32,
             Kv 4, hd 128), the same with window 1024, a ragged S 1000 at
             hd 64, internvl2-2b's prefill (B 2, S 4096, H 16, Kv 8, hd 128),
             whisper-medium's decoder (B 4, S 448, H = Kv = 16, hd 64) and
             granite-20b's MQA (B 1, S 4096, H 48, Kv 1, hd 128), each in
             f32 (within 1e-4) and bf16 (one bf16 step plus 1e-4), two
             launches bit-identical, and the backend and device
             kernel that scaled_dot_product_attention runs on zamba2's f32
             shape (one profiled call); ssd_chunk_scan at zamba2's
             shape (B 2, S 4096, H 80, N = P = 64, chunk 256, B and C
             broadcast over the heads), a ragged S 4000 from a random
             initial state, per-head k and q at N = P = 128, log-decays
             20x stronger (|cum| in the thousands within a chunk), and the
             mLSTM's own heads (the wide-head variant: per-head k and q, v
             with a ones column; xlstm-125m's N 384 / P 385 at B 2 x S
             4096, the reduced N 128 / P 129, a ragged S 1000): the
             kernel's four outputs against their plain
             version, finite, then y and the final state of
             ops.ssd_chunked against the plain scan, within 1e-4 + 5e-5 of
             the largest value; ssd_chunk_scan_bwd at phase train's
             microbatch (B 2, S 1024), zamba2's prefill shape, a ragged S
             1000, per-head k and q at N = P = 128, the strong log-decays
             and the mLSTM's heads (N 384 / P 385 at phase xlstm's
             microbatch B 2 x S 1024, N 128 / P 129, a ragged S): its five
             outputs, finite, against ssd_chunk_scan_bwd_ref, and the
             gradient of ops.ssd_chunked (both kernels and autograd
             through the torch recurrence) against autograd through the
             plain scan, each within the same bound, two launches
             bit-identical; the hybrid's loss gradient on one microbatch,
             kernels against the plain scan, both on the card, for the
             reduced zamba2 and zamba2 at full width cut to 6 layers (S
             1024), each leaf within 1e-3 of its largest |gradient|.
3. main    — the user's path at full width: DENSE_124M f32, 16 owners x
             10,000 records, eps = 1, batch 4 x seq 128, G = 2 microbatches,
             f32 bank; four run_rounds dispatches of K = 8 timed with the
             host clock (the first warms cuBLAS and the allocator), a fifth
             under torch.profiler (launches per round, device busy time by
             kernel group, the device's idle share), two step() calls,
             reconcile. Launch counts must be K*G sqnorm and K dp_round per
             dispatch, and no bank codec or tree_delta launch.
   grouped — main's path under the owner-parallel grouped driver,
             run_rounds(owner_parallel=True): main's model, 16 owners, f32
             bank, fused, with K = 32 rounds a dispatch drawn from the
             uniform schedule under fixed keys; for max_group="auto" and
             8, two timed dispatches (the first warms up; cut from
             four to make room for phases mesh, sanitize and examples) and one
             profiled, each with exactly one dp_round and G sqnorm
             launches per group and no other kernel; ms, device ms,
             device kernels, idle share, mean group size and peak memory
             per round beside main's. Then the sequential driver on the
             first sequence, batches and key from a fresh state: refusals,
             device ledger and step equal the grouped run's, the largest
             theta_L difference printed, the reconciled ledger equal to
             the host's count.
   mesh    — the federation engine on a device mesh: a world of one over
             NCCL in this process (an in-memory store, no network) and the
             1x1 (data, model) mesh of launch.mesh.make_host_mesh; main's
             model, 16 owners, batch, G, K = 16 rounds a dispatch, one
             dispatch each on a meshed state and its unmeshed twin (the
             same sequence, batches and key): f32 and bf16 banks on the
             sequential fused driver and on the grouped driver, an int8
             bank and the tree at depth 2 on the sequential one. Each
             meshed run equals its twin bit for bit (theta_L, the bank,
             nodes and counts, the ledger's columns, the metrics, the
             reconciled ledger) with the same launches; ms a round of both
             (the host clock; they alternate which runs first), then each
             FlatLayout collective timed alone on the one-rank groups (the
             row pick and theta_bar's gather at P, the scalar reductions);
             the process group is destroyed at the end.
   example — per-example clipping on the fused flat engine
             (PrivatizerConfig(granularity="example", fused_kernel=True)):
             main's model and batch, 4 owners, K = 8 rounds a dispatch. A
             warm, a timed and a profiled sequential dispatch, each with K
             sqnorm (one row-axis launch over the 4 per-example gradients a
             round) and K dp_round and nothing else; the warm dispatch's
             rounds again as a step() loop from a fresh state: bit for bit;
             a grouped dispatch at main's 16 owners, max_group "auto", over
             8 distinct owners (groups as long as the free device memory
             allows), with one sqnorm (g x 4 rows) and one dp_round a
             group, and its peak; one dispatch of the model cast to bf16
             (params_of in bf16) and one on an f16 bank; then on the 1x1
             mesh of a fresh world of one, a meshed state's save_session
             under build/ adds at most one piece (PIECE_BYTES) to the
             device's peak and holds its unmeshed twin's arrays bit for bit
             (keys, dtypes, every array), and the checkpoint restored on
             the mesh runs the next dispatch as the uninterrupted session
             does, bit for bit. Device ms a round,
             launches and peak GB beside main's; fused_sqnorm_rows at (4,
             P) timed beside fused_sqnorm at (P,).
   faults  — main's path with the fault layer and the asynchronous runtime
             armed: FaultPlan(drop, stale, nonfinite, corrupt = 0.05 each),
             FaultPolicy(max_faults 3, window 16), StalenessPolicy(deadline
             1, max_retries 2, backoff_cap 4, decay 0.9), LatencyPlan(16
             per-owner bases in 0.2 to 0.9, jitter 0.3); K = 32 rounds a
             dispatch. The codes and latencies drawn on the card equal the
             CPU draw bit for bit. The sequential driver, then the grouped
             one (max_group 8), each from a fresh state: one timed
             dispatch (three before phase mesh, two before phases sanitize
             and examples) and one profiled on the
             same sequences and keys,
             each with K dp_round and K*G sqnorm (one dp_round and G sqnorm
             per group) and no other kernel, its seven ledger columns,
             FaultState and StalenessState equal to a plain host replay of
             the outcome algebra (`_Replay`), and bank_checksums over the
             9.78 GB bank equal to the stored checksums; the two drivers'
             counters equal each other and the reconciled tallies the
             device columns. ms, device ms by kernel group, device kernels,
             idle share and peak memory per round beside main's. Then one
             dispatch of an explicit code trace on a horizon-4 session hits
             every ledger column, quarantine included.
   paged   — the paged owner bank (Federation.init_paged_state, OwnerPager,
             TraceRing) at full width, main's batch, sequence and G, K =
             16: (a) parity, 16 owners with n_hot 16 on an f32 bank, one
             dispatch on a paged and on a flat state with the same key,
             one of 8 rounds profiled on each (the lookup's kernels and
             device time), then one under run_rounds(owner_parallel=True,
             max_group=8): theta_L, the bank rows, the ledger and the
             metrics bit for bit, the same launches; (b) scale, 4,096 owners (a flat f32
             bank would be 2.50 TB, never allocated) with n_hot 16 (9.78
             GB): five dispatches stream from a TraceRing over a recorded
             trace of windows A, B, C, D, A of 8 distinct owners each, so
             dispatches 3 to 5 each write 8 dirty rows back (4.89 GB D2H)
             and load 8 (4.89 GB H2D), dispatch 5 reading written cold rows
             back; per dispatch the prefetch's seconds, bytes and GB/s each
             way, ms per round beside main's, the pager's stats, then one
             profiled dispatch with its window resident; resident bytes
             against the flat bank's, peak memory, K dp_round and K*G
             sqnorm per dispatch, the reconciled ledger == the host's count
             of the trace; (c) the same five dispatches on an int8 bank
             with n_hot 64 (9.8 GB of codes): K absmax, encode and decode
             per dispatch too.
   checkpoint — crash-resume at full width: main's model on an 8-owner
             f32 bank (5.5 GB) after one dispatch and a reconcile is saved with
             save_session under build/ (free disk checked first, the
             directory removed after), the session runs K = 8 more rounds;
             a fresh Federation restores into a fresh state and runs the
             same 8 rounds: theta_L, the bank and the reconciled ledger bit
             for bit; save and restore seconds and GB/s. Then a paged
             crash-resume at a reduced size (int8, n_hot 2 of 4, faults and
             the runtime armed): save, run, drop the session, restore, run:
             equal to the uninterrupted run bit for bit.
   quant   — the quantized bank at full width: the same model and rounds
             (three dispatches and one profiled, one fewer than main's)
             with 128 owners x 10,000 records on an int8 bank (78.2 GB in
             f32, which would not fit); launch counts per dispatch must be
             also K decode, K encode and K absmax. Prints the bank's
             resident bytes, peak memory, ms per round and the idle share.
             Then one fp8 dispatch on a fresh state at the same size.
   tree    — the tree mechanism (DP-FTRL) at full width: main's model,
             owners and rounds (three dispatches and one profiled) with mechanism="tree", tree_depth=4
             (capacity 15 leaves per owner; the nodes are 16 x 4 x P x 4 B
             = 39.1 GB beside the 9.78 GB bank). Launch counts per dispatch
             must be K tree_delta, K*G sqnorm and 0 dp_round; the leaf
             counts and the ledger's "tree" view must equal what the host
             computes from the drawn owners. Prints the node bytes, peak
             memory, ms per round, the idle share, and the device time per
             round against main's, by kernel group.
   pytree  — the reference's default path at full width: main's model,
             owners and rounds (three dispatches and one profiled) on a PYTREE state (make_step's default
             pack_params=False: theta_L the model tree, a 9.78 GB bank of
             (16, *leaf.shape) leaves) with the fused privatizer. Launch
             counts per dispatch must be K*G*12 sqnorm, K*12 scale_noise
             and 0 dp_round; the ledger must equal the host's. Prints ms
             per round, the device time per round by kernel group,
             launches per round, peak memory and the idle share beside
             main's; then two dispatches of the repo's example
             configuration (fused_kernel=False, the jnp-equivalent draw:
             no kernel launch) on a fresh pytree state, the second's ms
             per round.
   serve   — zamba2-2.7b at full width (2,343,741,088 parameters, f32,
             random weights from a seed, drawn on the card): prefill of B 2 x S 4096 with
             attn_backend="pallas", three timed (the first warms up) and
             one under torch.profiler, with the launch counters set to 0
             just before and read just after: 9 flash_attention and 54
             ssd_chunk_scan launches per prefill and none of the seven
             federation kernels. Prints ms per prefill, prefill tokens/s,
             device time by kernel group (GEMM, flash, SSD, other), the
             idle share and peak memory. Then the same prefill with
             attn_backend="jnp" (blockwise attention; 0 flash launches) and
             a ragged prefill of S 4000 with both backends, their
             last-position logits within 1e-3 of each other; decode against
             the forward at full width and 6 layers (one shared-attention
             application) over S 320 (a chunk of 256 and a ragged one),
             every position within 5e-3 (the reference test's bound);
             greedy_decode at full depth, B 2, prompt 16, gen 32: ms per
             step, 0 kernel launches (decode reaches no kernel, as in the
             reference) and one profiled step's device kernels.
   train   — training the hybrid on the card: main's flat fused engine
             (batch 4, G = 2, K = 8, eps = 1, horizon 1000) over
             zamba2-2.7b at full width cut to its first 12 of 54 Mamba2
             layers (P = 668,655,424; the one cut, for memory), 4 owners
             on a 10.7 GB f32 bank, S 1024 (four SSD chunks); phase
             main's dispatches (three timed),
             profile, steps and reconcile. Launch
             counts per dispatch must be K*G*12 ssd_chunk_scan and
             ssd_chunk_scan_bwd, K*G sqnorm, K dp_round and 0
             flash_attention (one kv chunk: plain attention).
   xlstm   — xlstm-125m (arXiv:2405.04517) at full width and depth,
             199,584,812 f32 parameters (11 mLSTM blocks with scan heads N
             384 / P 385, the sLSTM at block 6): launch.steps.
             build_train_step, 4 owners, batch 4 x S 1024, G = 2
             pre-grouped microbatches: two timed rounds (the first warms
             up; three before phases sanitize and examples) and one
             profiled, each with 22 ssd_chunk_scan and 22
             ssd_chunk_scan_bwd launches (11 mLSTM layers x G) and no
             other kernel; ms a round, device time, idle share, peak GB.
             The loss gradient (B 2) through the kernels against the plain
             scan on the card, each leaf within 1e-3 of its largest
             |gradient|: the whole model at S 256, its 12 blocks all mLSTM
             at S 1024 (four chunks); at S 1024 the whole model's gradient
             is ill-conditioned in f32 through the sLSTM's recurrence, so
             kernels against the plain scan and the plain scan at chunk
             128 against 256 are printed there, not checked. The main path's flat fused engine over the
             xLSTM at main's S 128 (phase main's dispatches at K = 8, one
             timed, two before phases sanitize and examples, and one profiled: K dp_round, K*G sqnorm and K*G*11 of
             each SSD kernel a dispatch). Decode against the forward over S 300, within
             5e-3. launch.train.main at its reduced default size on the
             card (--steps 5, per-example granularity: vmap of the
             gradient through the wide kernels), its checkpoint loaded
             back bit for bit.
   moe     — qwen3-moe-30b-a3b (hf:Qwen/Qwen3-30B-A3B) at full width, the
             depth cut to fit one card: 4 of 48 layers (3.11 B parameters,
             drawn on the card from a seed) for a prefill of B 2 x S 4096
             through build_prefill_step with attn_backend "pallas" (4
             flash_attention launches), three timed and one profiled,
             against "jnp" (logits within two bf16 steps of the largest:
             the onehot dispatch's bf16 casts); one layer's onehot dispatch
             with a capacity that drops nothing against the ragged one;
             then 1 of 48 layers (1.25 B parameters: 2 layers ran out
             of memory) for two build_train_step rounds at microbatch
             granularity (2 owners, batch 4 x S 1024, the ragged
             dispatch) and one profiled, with peak GB.
   vlm     — internvl2-2b (arXiv:2404.16821) at full width and depth
             (1,893,341,184 f32 parameters drawn on the card from a seed):
             a prefill of B 2 x S 4096 (256 projected patches, drawn from a
             seed, and 3,840 text tokens) through build_prefill_step with
             attn_backend "pallas", three timed and one profiled, each with
             24 flash_attention launches and no other kernel, against
             "jnp" (logits within 1e-3); decode on the first 6 layers over
             S 256 against the text-only forward of the same weights (the
             dense path over `blocks`: the vlm's decode sees no patches, as
             the reference's), within 5e-3; greedy_decode at full depth, B
             2, prompt 16, gen 32, and one profiled decode step.
   audio   — whisper-medium (arXiv:2212.04356) at full width and depth (24
             encoder and 24 decoder layers, 812,523,520 parameters; 1,500
             frames of the stub frontend drawn from a seed): a prefill of B
             4 x 448 decoder tokens, three timed and one profiled with 24
             flash launches each (the encoder and the cross-attention are
             plain torch, as in the reference), against "jnp"; the encoder
             alone, timed; prime_cross_cache, then decode on the first 6
             decoder layers over S 128 against the forward, within 5e-3;
             greedy serving at full depth; two build_train_step rounds at
             microbatch granularity (4 owners, batch 4 x 448, G = 2, the
             frames in the batch, "jnp" attention: no kernel) and one
             profiled, at full depth.
   zoo     — granite-20b (MQA), command-r-35b (tied embedding, RoPE theta
             8e6) and qwen1.5-110b (qkv bias) at full width, each cut to 2
             layers (qwen1.5: 5.21 B parameters): a prefill of B 2 x S
             4096, two timed and one profiled with 2 flash launches each,
             against "jnp" within 1e-3; each model freed before the next.
   meshzoo — the model zoo's steps on a device mesh: a world of one over
             NCCL and its 1x1 mesh (launch.mesh.make_host_mesh). yi-6b at
             full width and depth, f32, attn_backend "pallas" (flash at hd
             128): a B 2 x S 4096 prefill through build_prefill_step
             unmeshed, twice (the first warms up), once under
             analysis.op_cost's counter (logits bit for bit; the counted
             FLOPs within 0.5% of 2 x the matmul parameters x tokens plus
             the unembedding of the last positions plus flash's formula;
             the achieved TFLOP/s and its share of the f32 peak printed),
             then the same prefill with mesh= on DTensors placed by the
             bundle's in_shardings, twice: logits bit for bit and 32 flash
             launches a prefill; 8 greedy decode steps (prompt 4, gen 5)
             unmeshed and through a meshed build_serve_step: tokens and
             every step's logits bit for bit. Then zamba2-2.7b at full
             width and depth (flash at hd 80, the SSD forward) the same
             way: the prefill meshed against unmeshed bit for bit with 9
             flash and 54 ssd_chunk_scan launches, and 8 decode steps. The
             process group is destroyed at the end.
   meshfed — every driver on a pytree state on that mesh (after
             meshtrain): DENSE_124M at full width and depth, batch 4 x
             128, G = 2, remat off, `deep.init_state(..., mesh=, specs=)`
             against unmeshed twins from the same params, batches, owners,
             keys and fault codes: (a) the fused privatizer on 16 owners,
             one make_fused_rounds and one make_group_rounds dispatch of K
             = 4 bit for bit (G x 12 sqnorm and 12 scale_noise a round),
             then twin and meshed dispatches timed in turns and one meshed
             dispatch profiled; (b) the tree at depth 2 (random.laplace, 4
             owners, 4.89 GB of nodes a state) bit for bit, no kernel; (c)
             faults + staleness (fused, 4 owners, 8 rounds whose codes hold
             every code), both drivers bit for bit, the counters equal to
             the host replay, the checksums to bank_checksums; (d) example
             granularity (fused, 4 owners, 2 rounds) within rtol 1e-4 plus
             1e-5 of each array's largest magnitude, the integer state
             exact. The process group is destroyed at the end.
   convex  — the paper's Section 5 at its own size through Federation.run:
             lending and health, p = 10, 10,000 records per owner, T =
             1000, rho 1, sigma 2e-5, reg 1e-5, theta_max 2; for N in (2,
             5, 10, 25, 50) x eps in (1, 2.5, 10) one timed session of 100
             replicas (host clock around a synchronize) and one profiled
             (device kernels per step, idle share); psi's median at k =
             10, 500 and 1000 and collab_wins against owner 0's isolated
             model; the fitted (c1bar, c2bar) of eq. (11) and
             min_owners_for_benefit (Fig. 6's forecast). The N = 50 cell on
             the card and on the CPU under the uniform, Poisson and
             availability-trace schedules, sampled and replayed: owner
             sequences bit for bit, theta_L, bank and psi within 1e-5 +
             1e-4 x. A ledgered run's ledger equals the bincount of its
             owners; under per_owner_rounds (cap_slack 1) no owner passes
             its cap and each refused step of 100 replicas leaves theta_L
             and the bank bit-equal; run_sync under per_owner_rounds, both
             engines under the tree and a second ledgered run raise; strict
             scales equal paper x sqrt(10). run_sync (lr 0.4) at N = 5,
             50,000 records, T = 800 charges every owner T and is timed
             beside run and the capped run (10 replicas each).
   sync    — the deep synchronous baseline at full width: DENSE_124M, 16
             owners x 10,000 records, eps 1, batch 4 x seq 128, G = 2, the
             fused privatizer, through Federation(strategy="sync").make_step
             and sync_round: two timed rounds and one profiled (ms per
             round, device time, idle share, peak memory), each with N*G*12
             = 384 sqnorm and N*12 = 192 scale_noise launches and no other
             kernel; the profiled round's params, batches and key through
             both privatizers at noise scale 0 agree within rtol 1e-4, atol
             1e-6; params stay finite; the ledger charges each owner once a
             round; with a horizon of one round, the second round refuses
             every owner and returns its input params, launching nothing.
4. refusal — a reduced model with schedule-drawn owners, on an f32 and an
             int8 bank, under the paper mechanism (horizon 2) and the tree
             (depth 2, horizon 8, capacity 3), and on pytree states under
             the paper mechanism (fused) and the tree (depth 2,
             fused_kernel=False): the refused mask and
             reconciled ledger (with its tree view) must equal what the host
             computes from the drawn sequence and what the port computes on
             the CPU, and so must the leaf counts; theta_L, the bank and the
             nodes must agree with the CPU run (int8: within one
             quantization step), a step() loop must equal run_rounds bit
             for bit (nodes and counts included), a refused round leaves the
             state untouched (codes, scales, residual, nodes, counts), and a
             depth-0 tree equals the paper mechanism bit for bit. On the
             card, `spec.pack` of a pytree run equals the flat engine's
             reference mode (fused_kernel=False) bit for bit, under the
             paper mechanism and the tree. On the f32 bank (paper and
             tree) the same run again under the grouped driver on the card
             (unbounded groups): refusals and the ledger equal the
             sequential run's, and the leaf counts and nodes bit for bit;
             one dp_round (tree: tree_delta) and 2 sqnorm per group.
   fault refusal — the fault-armed dispatch (a FaultPlan and a LatencyPlan,
             staleness with decay) at phase refusal's reduced size on the
             f32 and int8 banks, the depth-2 tree and the pytree state, on
             the card and on the CPU: owners, ledger columns, fault and
             runtime counters, outcome masks and the reconciled ledger
             equal; theta_L, the bank and the nodes within phase refusal's
             tolerances; the stored checksums equal bank_checksums; on flat
             states the grouped driver's counters equal the sequential
             run's (under the tree, nodes and counts bit for bit), with two
             tree_delta launches a round and a group; and a zero FaultPlan
             under the default StalenessPolicy equals the fault-off engine
             bit for bit on the card.
   paged refusal — a paged session (4 owners, n_hot 3: rows evict and
             come back) against its flat twin on the card at the reduced
             size, sequentially and grouped: the tree at depth 2 (with the
             refusal phase) and the fault-armed f32 and int8 banks (with the
             fault refusal phase): theta_L, every row, the nodes, the
             counters, the refusals and the ledger bit for bit, the same
             launches. The launches on the paged paths are printed as one
             JSON line.
   sanitize — dpcheck's key-reuse sanitizer on the card: one dispatch of
             main's configuration (DENSE_124M, 16 owners, the fused flat
             engine, K = 4), a grouped one, a tree one (depth 2) and an
             int8 one (4 owners each), each unsanitized and then under
             `sanitize()` (both timed): no raise, every draw the kernels'
             own report (by drawer: dp_round_flat, dp_round_rows,
             tree_delta_, encode_row), nothing skipped; two seeded reuses
             (two dp_round_flat launches on one key, a dp_round_rows
             whose member keys repeat) must raise KeyReuseError.
   examples — the example twins' `main` on the card: the LLM driver 50
             steps at full width (and 4 rounds reduced with --fused), the
             eq. (11) forecast, greedy zamba2 decode; their lines printed.
5. timing  — each kernel (through the wrapper the main path calls), its
             plain version and the one PyTorch call computing the same
             function where there is one (torch.dot for sqnorm,
             torch.linalg.vector_norm(x, inf) for absmax, codes * scale
             for the int8 decode), at the main-path shapes, with CUDA
             events, beside the bound; encode and decode on an int8 row
             for the `kernels` line, and again on an fp8 row, printed;
             tree_delta at depth 4 for r = 0 (the `kernels` row), 1 and 2;
             scale_noise over the 12 DENSE_124M leaves (12 launches);
             flash_attention at zamba2's prefill shape beside
             torch's scaled_dot_product_attention (timed only), ssd_chunk_scan at
             zamba2's prefill shape and ssd_chunk_scan_bwd at phase
             train's microbatch (no library call), each beside its bound;
             flash_attention also at internvl2-2b's prefill shape beside
             its bound and SDPA (printed, not a row):
             operations over 67 TFLOP/s of f32 against bytes over 3.35
             TB/s, whichever is larger; both SSD kernels also at the
             mLSTM's shapes (xlstm-125m's prefill and training microbatch,
             the reduced head; printed, not rows); the forward's TFLOP/s also at phase
             train's microbatch (printed, not a row); the member axis
             (dp_round and sqnorm over 8 rows, tree_delta over 4 owners at
             r = 0, at P = 152,783,616) beside as many single launches and
             its byte bound (printed, not rows).

Prints a `kernels` JSON line, the card's name and power limit, and as the
last line {"ok": true, "device": {...}}. Without CUDA, or without the
repository beside it, it exits non-zero and prints no result.

Lines marked `# dpcheck: ignore[...]` draw one key twice on purpose: a
kernel held against its plain version on the same key, two runs held
against each other, or phase sanitize's seeded reuse (`python -m
repro_torch.analysis.dpcheck` scans this file).
"""
import collections
import json
import math
import os
import statistics
import subprocess
import sys
import time
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
P_FULL = 152_783_616                 # DENSE_124M
P_RAGGED = 1_000_003
F32_FLOP_PER_S = 67e12              # H100 SXM data sheet, f32 outside the tensor cores
ROUND = dict(sigma=1e-2, lr_own=0.3, lr_l=0.2, n_owners=16, theta_max=2.0)
FMTS = ("int8", "fp8")
# the federation kernels, which the serve path must not launch, and the two
# model kernels, which the federation paths must not launch
FED_KERNELS = ("dp_round", "sqnorm", "scale_noise", "absmax", "encode", "decode", "tree_delta")
# the kernels of a hybrid forward (serve), and with the scan's backward those
# of a hybrid training step (train)
SERVE_KERNELS = ("flash_attention", "ssd_chunk_scan")
MODEL_KERNELS = SERVE_KERNELS + ("ssd_chunk_scan_bwd",)
# zamba2-2.7b's prefill in phase serve: batch 2 x 4096 tokens
PREFILL_B, PREFILL_S = 2, 4096


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(torch, fn, iters):
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


def _steady_ms(torch, what, fn, iters, repeats=5):
    """The median of `repeats` cuda_ms readings, each printed."""
    reps = [cuda_ms(torch, fn, iters) for _ in range(repeats)]
    print(f"[timing] {what}: {repeats} readings of {iters} launches each "
          f"{', '.join(f'{ms:.4f}' for ms in reps)} ms, median {statistics.median(reps):.4f}")
    return statistics.median(reps)


def _kernel_modules():
    from repro_torch.kernels.bank_codec import kernel as bank_codec
    from repro_torch.kernels.dp_clip_noise import kernel as dp_clip_noise
    from repro_torch.kernels.flash_attention import kernel as flash_attention
    from repro_torch.kernels.ssm_scan import kernel as ssm_scan
    from repro_torch.kernels.tree_noise import kernel as tree_noise
    return dp_clip_noise, bank_codec, tree_noise, flash_attention, ssm_scan


def _reset_launches():
    for mod in _kernel_modules():
        mod.reset_launches()


def _launches():
    """Every kernel wrapper's launch count, in one dict."""
    out = {}
    for mod in _kernel_modules():
        out.update(mod.launches)
    return out


def _diff(after, before):
    return {k: after[k] - before[k] for k in after}


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build_all({mod.NAME: mod.SOURCE for mod in _kernel_modules()})
    print(f"[build] {time.perf_counter() - t0:.2f} s for {sorted(built) or 'nothing'}")
    for name, (sec, out) in built.items():
        print(f"[build] {name}: nvcc {sec:.2f} s")
        for kern, regs, spill in _ptxas_report(out):
            print(f"[build]   {kern}: {regs} registers, {spill}")


def _ptxas_report(out):
    """(kernel, registers, its stack and spill line) for each entry function
    in ptxas' -v output (template instantiations by their mangled names)."""
    rows, kern, spill = [], "?", ""
    for ln in out.splitlines():
        if "Compiling entry function" in ln:
            kern = ln.split("'")[1] if "'" in ln else ln.strip()
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln:
            rows.append((kern, int(ln.split("Used")[1].split()[0]), spill))
    return rows


def phase_kernels(torch, dev):
    from repro_torch import random
    from repro_torch.kernels.dp_clip_noise import kernel, ops, ref
    err = {"dp_round": 0.0, "sqnorm": 0.0}
    before = dict(kernel.launches)
    gen = torch.Generator(device=dev).manual_seed(1)
    scal = [torch.tensor(v, device=dev) for v in (0.5, 0.9, 0.0625)]
    for p in (P_FULL, P_RAGGED):
        key = random.PRNGKey(p, device=dev)
        tb = torch.randn(p, device=dev, generator=gen)
        acc = torch.randn(p, device=dev, generator=gen)
        for a, b, tag in ((tb, acc, "random"), (torch.zeros_like(tb), torch.zeros_like(tb),
                                                 "zero")):
            out = ops.dp_round_flat(a, b, key, *scal, **ROUND)  # dpcheck: ignore[DPC101]
            plain = ref.dp_round_ref(a, b, random.bits(key, (p,)), *scal, **ROUND)  # dpcheck: ignore[DPC101]
            for o, r in zip(out, plain):
                err["dp_round"] = max(err["dp_round"], float((o - r).abs().max()))
                check(torch.equal(o, r), f"dp_round ({tag}, P={p}) differs from its plain "
                      f"version by up to {err['dp_round']:.3e}")
            if tag == "zero":
                check(float(out[1].abs().max()) > 0, "zero input gave no noise")
            del out, plain
        s1, s2 = ops.fused_sqnorm(tb), ops.fused_sqnorm(tb)
        check(torch.equal(s1, s2), "two sqnorm launches differ")
        plain = ref.sqnorm_ref(tb)
        torch.testing.assert_close(s1, plain, rtol=1e-5, atol=0.0)
        err["sqnorm"] = max(err["sqnorm"], float((s1 - plain).abs()))
        print(f"[kernels] P={p}: dp_round equals its plain version bit for bit, sqnorm "
              f"agrees ({float(s1):.6e} vs {float(plain):.6e})")
        del tb, acc
    got = {k: kernel.launches[k] - before[k] for k in before}
    check(got == {"dp_round": 4, "scale_noise": 0, "sqnorm": 4}, f"the wrappers launched {got}")
    err.update(_check_bank_codec(torch, dev))
    err.update(_check_tree_delta(torch, dev))
    _check_rows(torch, dev)
    _check_col0(torch, dev)
    err.update(_check_scale_noise(torch, dev))
    err.update(_check_flash(torch, dev))
    err.update(_check_ssd(torch, dev))
    err.update(_check_ssd_bwd(torch, dev))
    _check_hybrid_grad(torch, dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return err


# (what, B, S, H, Kv, hd, window): zamba2's shared block at prefill, yi-6b's
# attention with and without a window, a ragged S, and the prefills of phases
# vlm, audio and zoo: internvl2-2b's (256 patches + 3,840 tokens), whisper-
# medium's decoder (its 448-token context) and granite-20b's MQA (one kv head
# for 48 query heads)
FLASH_CASES = (("zamba2-2.7b", 2, 4096, 32, 32, 80, None),
               ("yi-6b", 1, 4096, 32, 4, 128, None),
               ("yi-6b, window 1024", 1, 4096, 32, 4, 128, 1024),
               ("ragged", 1, 1000, 8, 2, 64, None),
               ("internvl2-2b", 2, 4096, 16, 8, 128, None),
               ("whisper-medium", 4, 448, 16, 16, 64, None),
               ("granite-20b MQA", 1, 4096, 48, 1, 128, None))


def _bf16_close(torch, out, plain, what):
    """bf16 outputs against the plain version of the same bf16 inputs: both
    sides compute in f32 and round to bf16, so they may sit one bf16 step
    apart (at most 2^-7 of the value) where the f32 values straddle a
    rounding boundary; plus the f32 bound of 1e-4 for the differences
    beneath, which matters only for outputs near 0."""
    torch.testing.assert_close(out.float(), plain.float(), rtol=2 ** -7, atol=1e-4,
                               msg=lambda m: f"{what} (bf16) differs from its plain version: {m}")


def _check_flash(torch, dev):
    """flash attention through its entry point against its plain version
    (the whole (S, Skv) score matrix in f32, GQA heads repeated) on the same
    CUDA tensors, causal, at every FLASH_CASES shape in f32 and bf16. f32
    within 1e-4: softmax sums of up to 4096 terms in other orders (about
    1e-5 seen), outputs up to about 4. bf16: `_bf16_close`. Two launches on
    one input give the same bits."""
    from repro_torch.kernels.flash_attention import kernel, ops, ref
    err = 0.0
    before = dict(kernel.launches)
    gen = torch.Generator(device=dev).manual_seed(12)
    for what, B, S, H, Kv, hd, win in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, device=dev, generator=gen).to(dtype)
                       for shape in ((B, S, H, hd), (B, S, Kv, hd), (B, S, Kv, hd)))
            out = ops.flash_attention(q, k, v, causal=True, window=win)
            again = ops.flash_attention(q, k, v, causal=True, window=win)
            check(torch.equal(out, again), f"two flash_attention launches differ ({what})")
            plain = ref.flash_attention_ref(q, k, v, causal=True, window=win)
            e = float((out.float() - plain.float()).abs().max())
            if dtype == torch.float32:
                err = max(err, e)
                check(e <= 1e-4, f"flash_attention ({what}, f32) differs from its plain "
                      f"version by {e:.3e}")
            else:
                _bf16_close(torch, out, plain, f"flash_attention ({what})")
            print(f"[kernels] flash_attention {what} (B {B}, S {S}, H {H}, Kv {Kv}, hd {hd}, "
                  f"window {win}) {str(dtype)[6:]}: max |kernel - plain| {e:.3e}; two launches "
                  f"give the same bits")
            del q, k, v, out, again, plain
            torch.cuda.empty_cache()
    got = _diff(dict(kernel.launches), before)
    check(got == {"flash_attention": 2 * 2 * len(FLASH_CASES)}, f"flash_attention launched {got}")
    if dev.type == "cuda":
        _sdpa_kernels(torch, dev)
    return {"flash_attention": err}


def _sdpa_kernels(torch, dev):
    """Which backend and device kernels torch's scaled_dot_product_attention
    runs on f32 inputs of zamba2's prefill shape (the library yardstick of
    the flash row): printed, from one profiled call. Profiled here, in the
    run's first profiler session: a late session in a long run has come
    back without device events."""
    from torch.nn.attention import SDPBackend
    qt, kt, vt = (torch.randn((PREFILL_B, 32, PREFILL_S, 80), device=dev) for _ in range(3))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa(qt, kt, vt, is_causal=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        sdpa(qt, kt, vt, is_causal=True)
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA})
    backend = SDPBackend(torch._fused_sdp_choice(qt, kt, vt, is_causal=True)).name
    print(f"[kernels] scaled_dot_product_attention on f32 (B {PREFILL_B}, H 32, S {PREFILL_S}, "
          f"hd 80, causal; TF32 matmul allowed: {torch.backends.cuda.matmul.allow_tf32}): "
          f"backend {backend}, device kernels {[n[:90] for n in names]}")


# (what, B, S, H, N, P, chunk, k and q broadcast over the heads, decay):
# zamba2's Mamba2 layers at prefill (B and C shared by the 80 heads), a ragged S, per-head
# keys and queries at the resident-tile variants' widest N = P = 128, and log-decays 20x
# stronger (|cum| in the thousands within a chunk)
SSD_CASES = (("zamba2-2.7b", 2, 4096, 80, 64, 64, 256, True, 1.0),
             ("zamba2-2.7b, ragged S", 2, 4000, 80, 64, 64, 256, True, 1.0),
             ("per-head k/q, N = P = 128", 2, 2048, 8, 128, 128, 256, False, 1.0),
             ("zamba2-2.7b, strong decay", 2, 1024, 80, 64, 64, 256, True, 20.0))
# (what, B, S, H, N, P, chunk): the mLSTM's own scan (the wide-head variant):
# per-head k and q, N = dm / H and P = N + 1, v's last column the normalizer's
# ones; xlstm-125m at full width (N 384, P 385) at prefill, the reduced
# xLSTM's head (N 128, P 129) at the training microbatch, and a ragged S
MLSTM_SSD_CASES = (("mLSTM xlstm-125m prefill", 2, 4096, 4, 384, 385, 256),
                   ("mLSTM reduced xlstm-125m", 2, 1024, 4, 128, 129, 256),
                   ("mLSTM xlstm-125m, ragged S", 2, 1000, 4, 384, 385, 256))


def _ssd_inputs(torch, dev, B, S, H, N, P, bcast, gen, decay=1.0, ones=False):
    """Mamba2-like scan inputs on the card: k and q as stride-0 views over
    the heads when `bcast`, ld = -decay * softplus(x) and g = sigmoid(x)
    for normal x (decay 1 is the reference's test distribution). `ones`:
    the mLSTM's v, whose last of P columns is ones (the normalizer)."""
    v = torch.randn((B, S, H, P - ones), device=dev, generator=gen)
    if ones:
        v = torch.cat([v, torch.ones((B, S, H, 1), device=dev)], dim=-1)
    if bcast:
        k, q = (torch.randn((B, S, 1, N), device=dev, generator=gen).expand(B, S, H, N)
                for _ in range(2))
    else:
        k, q = (torch.randn((B, S, H, N), device=dev, generator=gen) for _ in range(2))
    ld = -decay * torch.nn.functional.softplus(torch.randn((B, S, H), device=dev, generator=gen))
    g = torch.sigmoid(torch.randn((B, S, H), device=dev, generator=gen))
    return v, ld, k, q, g


def _scan_err(out, plain):
    """The largest |out - plain| and its bound, 1e-4 + 5e-5 * max |plain|:
    the kernels add each output's f32 products (up to a chunk's 256 rows
    times a depth of up to 128) in another order than the plain version's
    einsums, and dld is a reverse cumsum of such sums over the chunk; cum
    itself is equal bit for bit."""
    e = float((out - plain).abs().max())
    return e, 1e-4 + 5e-5 * float(plain.abs().max())


def _check_ssd(torch, dev):
    """The SSD scan on the card at every SSD_CASES shape (f32, the path's
    dtype): the kernel's four outputs (y_intra, h_add, cum, tot) against
    their plain version, then ops.ssd_chunked (the kernel and the torch
    recurrence between chunks) against the plain scan, y and the final
    state, from zero and (ragged case) from a random initial state; two
    launches give the same bits. Tolerance: `_scan_err`."""
    from repro_torch.kernels.ssm_scan import kernel, ops, ref
    err = 0.0
    before = dict(kernel.launches)
    gen = torch.Generator(device=dev).manual_seed(13)
    n = 0
    cases = [(c, False) for c in SSD_CASES] + [(c + (False, 1.0), True) for c in MLSTM_SSD_CASES]
    for (what, B, S, H, N, P, Q, bcast, decay), ones in cases:
        v, ld, k, q, g = _ssd_inputs(torch, dev, B, S, H, N, P, bcast, gen, decay, ones)
        h0 = (torch.randn((B, H, N, P), device=dev, generator=gen) if "ragged" in what
              else None)
        parts = kernel.ssd_chunk_scan_cuda(v, ld, k, q, g, Q)
        plain_parts = ref.ssd_chunk_scan_ref(v, ld, k, q, g, Q)
        worst = []
        for name, a, b in zip(("y_intra", "h_add", "cum", "tot"), parts, plain_parts):
            e, tol = _scan_err(a, b)
            check(bool(torch.isfinite(a).all()), f"ssd_chunk_scan {name} ({what}) is not finite")
            check(e <= tol, f"ssd_chunk_scan {name} ({what}) differs from its plain version by "
                  f"{e:.3e} (bound {tol:.3e})")
            worst.append(f"{name} {e:.2e}")
        y, h = ops.ssd_chunked(v, ld, k, q, g, chunk=Q, h0=h0)
        y2, h2 = ops.ssd_chunked(v, ld, k, q, g, chunk=Q, h0=h0)
        n += 3
        check(torch.equal(y, y2) and torch.equal(h, h2), f"two ssd_chunked calls differ ({what})")
        py, ph = ref.ssd_chunked(v, ld, k, q, g, chunk=Q, h0=h0)
        for name, a, b in (("y", y, py), ("h_final", h, ph)):
            e, tol = _scan_err(a, b)
            check(e <= tol, f"ssd_chunked {name} ({what}) differs from the plain scan by "
                  f"{e:.3e} (bound {tol:.3e})")
            worst.append(f"{name} {e:.2e} (bound {tol:.2e})")
            err = max(err, e)
        print(f"[kernels] ssd_chunk_scan {what} (B {B}, S {S}, H {H}, N {N}, P {P}, chunk {Q}, "
              f"{'B/C broadcast' if bcast else 'per-head k/q'}{', v with a ones column' * ones}"
              f"{', h0' if h0 is not None else ''}): max |kernel - plain| " + ", ".join(worst)
              + "; two launches give the same bits")
        del v, ld, k, q, g, parts, plain_parts, y, y2, py, h, h2, ph
        torch.cuda.empty_cache()
    got = _diff(dict(kernel.launches), before)
    check(got == {"ssd_chunk_scan": n, "ssd_chunk_scan_bwd": 0}, f"ssd_chunk_scan launched {got}")
    return {"ssd_chunk_scan": err}


# as SSD_CASES: phase train's microbatch (four chunks), zamba2's prefill
# shape, a ragged S, per-head k and q at N = P = 128, and the strong
# log-decays
SSD_BWD_CASES = (("train microbatch", 2, 1024, 80, 64, 64, 256, True, 1.0),
                 ("zamba2-2.7b prefill", 2, 4096, 80, 64, 64, 256, True, 1.0),
                 ("ragged S", 2, 1000, 80, 64, 64, 256, True, 1.0),
                 ("per-head k/q, N = P = 128", 1, 1024, 8, 128, 128, 256, False, 1.0),
                 ("strong decay", 2, 1024, 80, 64, 64, 256, True, 20.0))
# as MLSTM_SSD_CASES: phase xlstm's training microbatch at full width (N
# 384, P 385), the reduced head (N 128, P 129) and a ragged S
MLSTM_SSD_BWD_CASES = (("mLSTM xlstm-125m train microbatch", 2, 1024, 4, 384, 385, 256),
                       ("mLSTM reduced xlstm-125m", 2, 1024, 4, 128, 129, 256),
                       ("mLSTM xlstm-125m, ragged S", 2, 1000, 4, 384, 385, 256))


def _grad_leaves(torch, k, q, bcast):
    """Leaves for k and q: their (B, S, 1, N) bases when they broadcast over
    the heads (so that expand's backward sums dk and dq), else copies."""
    if bcast:
        return k[:, :, :1].clone().requires_grad_(), q[:, :, :1].clone().requires_grad_()
    return k.clone().requires_grad_(), q.clone().requires_grad_()


def _check_ssd_bwd(torch, dev):
    """The backward of the SSD scan on the card at every SSD_BWD_CASES shape
    (f32, the training path's dtype). The kernel's five outputs (dv, dld, dk,
    dq, dg) against ssd_chunk_scan_bwd_ref on the same inputs and random
    cotangents, two launches bit-identical; then the whole gradient of
    ops.ssd_chunked (the forward kernel, the torch recurrence between
    chunks and the backward kernel, through SSDChunkScan and autograd) from
    a random initial state, against autograd through the plain scan. Each
    within `_scan_err`'s bound: the cotangents of the decays carry the same
    rounding of the f32 prefix sums as the forward."""
    from repro_torch.kernels.ssm_scan import kernel, ops, ref
    err = 0.0
    before = dict(kernel.launches)
    gen = torch.Generator(device=dev).manual_seed(16)
    cases = ([(c, False) for c in SSD_BWD_CASES]
             + [(c + (False, 1.0), True) for c in MLSTM_SSD_BWD_CASES])
    for (what, B, S, H, N, P, Q, bcast, decay), ones in cases:
        v, ld, k, q, g = _ssd_inputs(torch, dev, B, S, H, N, P, bcast, gen, decay, ones)
        nc = -(-S // Q)
        cots = [torch.randn(shape, device=dev, generator=gen)
                for shape in ((B, S, H, P), (B, nc, H, N, P), (B, S, H), (B, nc, H))]
        got = kernel.ssd_chunk_scan_bwd_cuda(*cots, v, ld, k, q, g, Q)
        again = kernel.ssd_chunk_scan_bwd_cuda(*cots, v, ld, k, q, g, Q)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"two ssd_chunk_scan_bwd launches differ ({what})")
        plain = ref.ssd_chunk_scan_bwd_ref(*cots, v, ld, k, q, g, Q)
        worst = []
        for name, a, b in zip(("dv", "dld", "dk", "dq", "dg"), got, plain):
            e, tol = _scan_err(a, b)
            check(bool(torch.isfinite(a).all()), f"ssd_chunk_scan_bwd {name} ({what}) is not "
                  "finite")
            check(a.shape == b.shape and e <= tol, f"ssd_chunk_scan_bwd {name} ({what}) differs "
                  f"from its plain version by {e:.3e} (bound {tol:.3e})")
            worst.append(f"{name} {e:.2e}")
            err = max(err, e)
        del got, again, plain, cots
        # the scan's gradient through SSDChunkScan against the plain scan's
        h0 = torch.randn((B, H, N, P), device=dev, generator=gen)
        ry = torch.randn((B, S, H, P), device=dev, generator=gen)
        rh = torch.randn((B, H, N, P), device=dev, generator=gen)
        grads = []
        for scan in (ops.ssd_chunked, ref.ssd_chunked):
            leaves = [t.clone().requires_grad_() for t in (v, ld, g, h0)]
            kl, ql = _grad_leaves(torch, k, q, bcast)
            kk, qq = (x.expand(B, S, H, N) for x in (kl, ql))
            y, h = scan(leaves[0], leaves[1], kk, qq, leaves[2], chunk=Q, h0=leaves[3])
            loss = (y * ry).sum() + (h * rh).sum()
            grads.append(torch.autograd.grad(loss, leaves + [kl, ql]))
        for name, a, b in zip(("v", "ld", "g", "h0", "k", "q"), *grads):
            e, tol = _scan_err(a, b)
            check(e <= tol, f"the gradient of ssd_chunked wrt {name} ({what}) differs from "
                  f"the plain scan's by {e:.3e} (bound {tol:.3e})")
            worst.append(f"grad {name} {e:.2e} (bound {tol:.2e})")
        print(f"[kernels] ssd_chunk_scan_bwd {what} (B {B}, S {S}, H {H}, N {N}, P {P}, chunk "
              f"{Q}, {'B/C broadcast' if bcast else 'per-head k/q'}"
              f"{', v with a ones column' * ones}): max |kernel - plain| "
              + ", ".join(worst) + "; two launches give the same bits")
        del v, ld, k, q, g, h0, ry, rh, grads
        torch.cuda.empty_cache()
    got = _diff(dict(kernel.launches), before)
    n = len(cases)
    check(got == {"ssd_chunk_scan": n, "ssd_chunk_scan_bwd": 3 * n},
          f"the SSD backward checks launched {got}")
    return {"ssd_chunk_scan_bwd": err}


def _dense_leaves(torch, dev, seed):
    """The 12 leaves of DENSE_124M's params (random weights from `seed`), in
    jax's leaf order, on the card."""
    from repro_torch.configs import DENSE_124M
    from repro_torch.models import LM
    from repro_torch.tree_util import tree_flatten
    return tree_flatten(LM(DENSE_124M, remat=False).init(seed=seed, device=dev))[0]


def _check_scale_noise(torch, dev):
    """scale_noise through the tree entry points the pytree privatizer
    calls, against its plain version on the same CUDA tensors, bit for bit:
    fused_scale_noise_tree and dp_privatize_tree on the 12 DENSE_124M
    leaves, then on a single leaf of P_RAGGED. dp_privatize_tree's clip
    factor comes from the deterministic sqnorm kernel (held against its
    plain version above), so the plain side rebuilds it from the same
    norm; that norm must agree with the plain sqnorm to rtol 1e-5."""
    from repro_torch import random
    from repro_torch.kernels.dp_clip_noise import kernel, ops, ref
    err = 0.0
    before = dict(kernel.launches)
    cs = torch.tensor([0.5], device=dev)
    ns = torch.tensor(0.37, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    trees = (("the 12 DENSE_124M leaves", lambda: _dense_leaves(torch, dev, seed=3)),
             (f"one leaf of {P_RAGGED}",
              lambda: [torch.randn(P_RAGGED, device=dev, generator=gen)]))
    for what, make in trees:
        leaves = make()
        key = random.PRNGKey(len(leaves) + 12, device=dev)
        keys = random.split(key, len(leaves))
        norm = torch.sqrt(ops.fused_sqnorm_tree(leaves))
        plain_norm = torch.sqrt(sum(ref.sqnorm_ref(x) for x in leaves))
        torch.testing.assert_close(norm, plain_norm, rtol=1e-5, atol=0.0)
        clip = torch.clamp(torch.full_like(norm, 0.25) / torch.clamp(norm, min=1e-12), max=1.0)
        for name, outs, scale in (
                ("fused_scale_noise_tree", ops.fused_scale_noise_tree(leaves, key, cs, ns), cs),  # dpcheck: ignore[DPC102]
                ("dp_privatize_tree", ops.dp_privatize_tree(leaves, key, 0.25, ns), clip)):  # dpcheck: ignore[DPC101]
            for leaf, k, out in zip(leaves, keys, outs):
                plain = ref.scale_noise_ref(leaf, random.bits(k, leaf.shape), scale.reshape(()),
                                            ns)
                err = max(err, float((out - plain).abs().max()))
                check(out.shape == leaf.shape and torch.equal(out, plain),
                      f"scale_noise ({name}, {tuple(leaf.shape)}) differs from its plain "
                      f"version by up to {err:.3e}")
                del plain
            del outs
        print(f"[kernels] {what}: scale_noise (fused_scale_noise_tree and dp_privatize_tree, "
              f"clip {float(clip):.4e}) equals its plain version bit for bit on every leaf")
        del leaves
    err = max(err, _check_block_scale_noise(torch, dev))
    got = _diff(dict(kernel.launches), before)
    # per tree: its sqnorm for the check, then dp_privatize_tree's; two
    # scale_noise per leaf; then the whole and four blocks of each of the
    # BLOCK_LEAVES
    check(got == {"dp_round": 0, "scale_noise": 2 * 13 + 5 * len(BLOCK_LEAVES),
                  "sqnorm": 2 * 13}, f"the wrappers launched {got}")
    torch.cuda.empty_cache()
    return {"scale_noise": err}


# full-width f32 leaves whose 2 x 2 blocks (the last two dims cut in two)
# go through the block scale_noise: DENSE_124M's embedding and its stacked
# (layer, d, d_ff) MLP weight (a layer dim in front: (A, R, C) blocks)
BLOCK_LEAVES = ((50304, 768), (12, 768, 2048))


def _two_by_two(shape):
    """(offsets, local shape) of the four blocks of a leaf cut in two on
    its last two dims."""
    *lead, r, c = shape
    for i in (0, 1):
        for j in (0, 1):
            yield (0,) * len(lead) + (i * r // 2, j * c // 2), tuple(lead) + (r // 2, c // 2)


def _check_block_scale_noise(torch, dev):
    """The block scale_noise (a rank's block of a leaf on a device mesh) on
    the four 2 x 2 blocks of each BLOCK_LEAVES leaf: each block equal to
    its plain version on its bits (random.bits_block) and the four tiling
    the whole-leaf launch, bit for bit. Returns the largest difference."""
    from repro_torch import random
    from repro_torch.kernels.dp_clip_noise import ops, ref
    gen = torch.Generator(device=dev).manual_seed(17)
    cs, ns = torch.tensor([0.5], device=dev), torch.tensor(0.37, device=dev)
    err = 0.0
    for shape in BLOCK_LEAVES:
        g = torch.randn(shape, device=dev, generator=gen)
        key = random.PRNGKey(sum(shape), device=dev)
        whole = ops.scale_noise(g, key, cs, ns)
        tiled = torch.empty_like(g)
        for offsets, local in _two_by_two(shape):
            sl = tuple(slice(o, o + n) for o, n in zip(offsets, local))
            block = g[sl].contiguous()
            out = ops.scale_noise(block, key, cs, ns, (shape, offsets))  # dpcheck: ignore[DPC101]
            plain = ref.scale_noise_ref(block, random.bits_block(key, shape, offsets, local),  # dpcheck: ignore[DPC101]
                                        cs.reshape(()), ns)
            err = max(err, float((out - plain).abs().max()))
            check(torch.equal(out, plain), f"the block scale_noise of {shape} at {offsets} "
                  f"differs from its plain version by {err:.3e}")
            tiled[sl] = out
            del block, out, plain
        check(torch.equal(tiled, whole), f"the 2 x 2 blocks of {shape} do not tile the "
              "whole-leaf launch")
        print(f"[kernels] block scale_noise: the four 2 x 2 blocks of a {shape} leaf (block "
              f"layout {ops._block_layout(shape, *next(iter(_two_by_two(shape))))}) each equal "
              f"their plain version and tile the whole-leaf launch, bit for bit")
        del g, whole, tiled
    return err


TREE_DEPTH = 4
TREE_COUNTS = (0, 1, 2, 3, 6, 7, 14)        # trailing ones r = 0, 1, 0, 2, 0, 3, 0


def _check_tree_delta(torch, dev):
    """tree_delta through the wrapper the engine calls against its plain
    version on the same CUDA tensors, bit for bit (delta and the whole
    (2, depth, P) node tensor after the call), at depth 4 for every count
    of TREE_COUNTS, granted and refused; a second launch on a copy of the
    same input gives the same bits."""
    from repro_torch import random
    from repro_torch.kernels.tree_noise import kernel, ops, ref
    err = 0.0
    before = dict(kernel.launches)
    gen = torch.Generator(device=dev).manual_seed(5)
    owner = torch.tensor([1], dtype=torch.int64, device=dev)
    ns = torch.tensor([0.37], device=dev)
    for p in (P_FULL, P_RAGGED):
        nodes = torch.randn((2, TREE_DEPTH, p), device=dev, generator=gen)
        key = random.PRNGKey(p + 2, device=dev)
        bits = random.bits(key, (p,))
        for count in TREE_COUNTS:
            counts = torch.tensor([5, count], dtype=torch.int32, device=dev)
            for g in (1, 0):
                grant = torch.tensor(g, dtype=torch.int32, device=dev)
                out, again, plain = nodes.clone(), nodes.clone(), nodes.clone()
                delta = ops.tree_delta_(out, counts, owner, key, ns, grant)  # dpcheck: ignore[DPC101]
                delta2 = ops.tree_delta_(again, counts, owner, key, ns, grant)  # dpcheck: ignore[DPC101]
                p_delta = ref.tree_delta_inplace_ref(plain, counts, owner, bits, ns, grant)
                err = max(err, float((delta - p_delta).abs().max()),
                          float((out - plain).abs().max()))
                check(torch.equal(delta, p_delta) and torch.equal(out, plain),
                      f"tree_delta (P={p}, count {count}, grant {g}) differs from its plain "
                      f"version by up to {err:.3e}")
                check(torch.equal(delta, delta2) and torch.equal(out, again),
                      f"two tree_delta launches differ (P={p}, count {count}, grant {g})")
                if not g:
                    check(torch.equal(out, nodes), "a refused tree_delta changed the nodes")
                del out, again, plain, delta, delta2, p_delta
        print(f"[kernels] P={p}: tree_delta (depth {TREE_DEPTH}, counts {list(TREE_COUNTS)}, "
              f"granted and refused) equals its plain version bit for bit, delta and nodes; "
              f"two launches give the same bits")
        del nodes, bits
    got = _diff(dict(kernel.launches), before)
    check(got == {"tree_delta": 2 * 2 * 2 * len(TREE_COUNTS)}, f"tree_delta launched {got}")
    return {"tree_delta": err}


ROWS_G = 8          # members per batched launch: the grouped phase's max_group=8


def _check_rows(torch, dev):
    """The member axis of the grouped driver, through the wrappers it calls:
    dp_round_rows and fused_sqnorm_rows over ROWS_G rows of P_FULL and 3 rows
    of P_RAGGED (whose rows past the first are not 16-byte aligned), and
    tree_delta_rows_ over 3 distinct owners of 4 at depth 4 (r = 0, 1, 3,
    the last refused), each ONE launch whose row m equals the single launch
    on row m bit for bit (sqnorm on the same view)."""
    from repro_torch import random
    from repro_torch.kernels.dp_clip_noise import ops as dops
    from repro_torch.kernels.tree_noise import ops as nops
    gen = torch.Generator(device=dev).manual_seed(11)

    def one_launch_each(got, names):
        check(got == {k: int(k in names) for k in got},
              f"the batched wrappers launched {got}, expected one each of {names}")

    for g, p in ((ROWS_G, P_FULL), (3, P_RAGGED)):
        tb = torch.randn((g, p), device=dev, generator=gen)
        acc = torch.randn((g, p), device=dev, generator=gen)
        keys = random.split(random.PRNGKey(p + g, device=dev), g)
        gain, ns, w = (torch.rand(g, device=dev, generator=gen) for _ in range(3))
        before = _launches()
        new_l, new_i = dops.dp_round_rows(tb, acc, keys, gain, ns, w, **ROUND)
        sq = dops.fused_sqnorm_rows(acc)
        one_launch_each(_diff(_launches(), before), ("dp_round", "sqnorm"))
        for m in range(g):
            one_l, one_i = dops.dp_round_flat(tb[m], acc[m], keys[m], gain[m:m + 1],
                                              ns[m:m + 1], w[m:m + 1], **ROUND)
            one_sq = dops.fused_sqnorm(acc[m])
            check(torch.equal(new_l[m], one_l) and torch.equal(new_i[m], one_i)
                  and torch.equal(sq[m], one_sq),
                  f"row {m} of the batched dp_round/sqnorm (g={g}, P={p}) differs from a "
                  f"single launch on it")
            del one_l, one_i
        print(f"[kernels] g={g} x P={p}: dp_round_rows and fused_sqnorm_rows, one launch "
              f"each, equal {g} single launches row by row, bit for bit")
        del tb, acc, new_l, new_i
        nodes = torch.randn((4, TREE_DEPTH, p), device=dev, generator=gen)
        counts = torch.tensor([0, 1, 5, 3], dtype=torch.int32, device=dev)
        owners = torch.tensor([3, 0, 1], dtype=torch.int64, device=dev)
        grant = torch.tensor([1, 1, 0], dtype=torch.int32, device=dev)
        batched, single = nodes.clone(), nodes.clone()
        before = _launches()
        delta = nops.tree_delta_rows_(batched, counts, owners, keys[:3], ns[:3], grant)
        one_launch_each(_diff(_launches(), before), ("tree_delta",))
        for m in range(3):
            one = nops.tree_delta_(single, counts, owners[m:m + 1], keys[m], ns[m:m + 1],
                                   grant[m:m + 1])
            check(torch.equal(delta[m], one), f"member {m} of the batched tree_delta (P={p}) "
                  "differs from a single launch")
        check(torch.equal(batched, single), f"the batched tree_delta's nodes (P={p}) differ "
              "from three single launches'")
        print(f"[kernels] 3 owners x depth {TREE_DEPTH} x P={p}: tree_delta_rows_ (r = 3, 0, "
              f"1; one refused), one launch, equals 3 single launches bit for bit, delta and "
              f"nodes")
        del nodes, batched, single, delta


# a rank's columns on a device mesh: P_FULL cut in two and in three uneven parts
COL0_SPLITS = ((0, 50_000_017, P_FULL), (0, 40_000_001, 97_000_003, P_FULL))


def _check_col0(torch, dev):
    """The column offset of rows 1, 5 and 7 (dp_round, encode, tree_delta):
    a launch over columns [c0, c1) of a P_FULL row with col0 = c0 equals
    the full launch's columns bit for bit, for each part of COL0_SPLITS;
    the parts' row_absmax partials reduce to the full row's scale."""
    from repro_torch import random
    from repro_torch.kernels.bank_codec import ops as cops
    from repro_torch.kernels.dp_clip_noise import ops as dops
    from repro_torch.kernels.tree_noise import ops as nops
    gen = torch.Generator(device=dev).manual_seed(13)
    p = P_FULL
    key = random.PRNGKey(31, device=dev)
    scal = [torch.tensor(v, device=dev) for v in (0.5, 0.9, 0.0625)]
    tb = torch.randn(p, device=dev, generator=gen)
    acc = torch.randn(p, device=dev, generator=gen)
    n_parts = sum(len(c) - 1 for c in COL0_SPLITS)
    before = _launches()
    full = dops.dp_round_flat(tb, acc, key, *scal, **ROUND)
    for cuts in COL0_SPLITS:
        for c0, c1 in zip(cuts[:-1], cuts[1:]):
            part = dops.dp_round_flat(tb[c0:c1], acc[c0:c1], key, *scal, col0=c0, **ROUND)  # dpcheck: ignore[DPC101]
            check(all(torch.equal(a, b[c0:c1]) for a, b in zip(part, full)),
                  f"dp_round at col0 {c0} differs from the full launch's columns")
            del part
    del full, tb, acc
    x = torch.randn(p, device=dev, generator=gen) * 0.05
    for fmt in FMTS:
        codes, scale, err = cops.encode_row(x, key, fmt)  # dpcheck: ignore[DPC101]
        for cuts in COL0_SPLITS:
            parts = []
            for c0, c1 in zip(cuts[:-1], cuts[1:]):
                parts.append(cops.row_absmax(x[c0:c1]))
                pc, _, pe = cops.encode_row(x[c0:c1], key, fmt, col0=c0, scale=scale)  # dpcheck: ignore[DPC101]
                check(torch.equal(pc, codes[c0:c1]) and torch.equal(pe, err[c0:c1]),
                      f"encode {fmt} at col0 {c0} differs from the full launch's columns")
            check(torch.equal(cops.scale_from_absmax(torch.stack(parts), fmt), scale),
                  f"the {fmt} scale from the parts' absmax differs from the row's")
        del codes, err
    del x
    nodes = torch.randn((2, TREE_DEPTH, p), device=dev, generator=gen)
    counts = torch.tensor([5, 7], dtype=torch.int32, device=dev)     # owner 1: r = 3 retired
    owner = torch.tensor([1], dtype=torch.int64, device=dev)
    ns = torch.tensor([0.37], device=dev)
    whole = nodes.clone()
    delta = nops.tree_delta_(whole, counts, owner, key, ns)  # dpcheck: ignore[DPC101]
    for cuts in COL0_SPLITS:
        for c0, c1 in zip(cuts[:-1], cuts[1:]):
            part = nodes[:, :, c0:c1].contiguous()
            d = nops.tree_delta_(part, counts, owner, key, ns, col0=c0)  # dpcheck: ignore[DPC101]
            check(torch.equal(d, delta[c0:c1]) and torch.equal(part, whole[:, :, c0:c1]),
                  f"tree_delta at col0 {c0} differs from the full launch's columns")
            del part, d
    del nodes, whole, delta
    got = _diff(_launches(), before)
    want = dict(dp_round=1 + n_parts, tree_delta=1 + n_parts,
                absmax=len(FMTS) * (1 + n_parts), encode=len(FMTS) * (1 + n_parts))
    check({k: got[k] for k in want} == want and not any(
        v for k, v in got.items() if k not in want), f"the col0 checks launched {got}")
    print(f"[kernels] col0: dp_round, encode (int8, fp8) and tree_delta (depth {TREE_DEPTH}, "
          f"r = 3) over P={p} cut at {[list(c[1:-1]) for c in COL0_SPLITS]}: every part "
          f"equals the full launch's columns bit for bit; the parts' absmax give the row's "
          f"scale")


def _check_bank_codec(torch, dev):
    """absmax, encode and decode through their wrappers against the plain
    versions on the same CUDA tensors, bit for bit."""
    from repro_torch import random
    from repro_torch.kernels.bank_codec import kernel, ops, ref
    err = {"absmax": 0.0, "encode": 0.0, "decode": 0.0}
    before = dict(kernel.launches)
    gen = torch.Generator(device=dev).manual_seed(3)
    for p in (P_FULL, P_RAGGED):
        x = torch.randn(p, device=dev, generator=gen) * 0.05
        x[:4] = torch.tensor([0.0, -0.0, 1e-9, -3e-12], device=dev)
        key = random.PRNGKey(p + 1, device=dev)
        for fmt in FMTS:
            s1, s2 = ops.row_scale(x, fmt), ops.row_scale(x, fmt)
            check(torch.equal(s1, s2), "two absmax launches differ")
            plain = ref.row_scales_ref(x.reshape(1, -1), ref.QMAX[fmt])
            check(torch.equal(s1, plain), f"absmax {fmt}: {float(s1)} vs {float(plain)}")
            for det in (False, True):
                codes, scales, e = ops.encode_row(x, key, fmt, deterministic=det)  # dpcheck: ignore[DPC101]
                p_codes, p_scales, p_e = ref.encode_row_ref(x, key, fmt, deterministic=det)
                check(torch.equal(scales, p_scales), f"encode {fmt} det={det}: scales differ")
                bad = int((codes != p_codes).sum())
                check(bad == 0, f"encode {fmt} det={det}: {bad} of {p} codes differ")
                err["encode"] = max(err["encode"], float((e - p_e).abs().max()))
                check(torch.equal(e, p_e), f"encode {fmt} det={det}: err rows differ "
                      f"by up to {err['encode']:.3e}")
                out = ops.decode_row(codes, scales, fmt)
                p_out = ref.decode_row_ref(codes, scales, fmt)
                err["decode"] = max(err["decode"], float((out - p_out).abs().max()))
                check(torch.equal(out, p_out), f"decode {fmt}: differs from its plain version")
                del codes, e, p_codes, p_e, out, p_out
        print(f"[kernels] P={p}: absmax, encode (int8, fp8; stochastic and deterministic) "
              f"and decode equal their plain versions bit for bit")
        del x
    pats = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    out = ops.decode_row(pats.to(dev), torch.ones(1, device=dev), "fp8").cpu()
    check(torch.equal(out, ref.fp8_to_f32(pats)), "fp8 patterns decode differently")
    print("[kernels] all 256 fp8 patterns decode exactly as ref.fp8_to_f32")
    got = _diff(dict(kernel.launches), before)
    # per P and format: 2 row_scale + 2 encode_row (absmax + encode) + 2 decode
    check(got == {"absmax": 16, "encode": 8, "decode": 9}, f"the wrappers launched {got}")
    return err


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _peak_gb(torch, dev):
    return torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else float("nan")


def _allocator_work(torch, dev):
    """The caching allocator's device calls since its accumulated counters
    were last reset (retries after a failed cudaMalloc, cudaMalloc and
    cudaFree calls: each one a device synchronisation or worse), and the
    bytes it holds."""
    if dev.type != "cuda":
        return "the allocator is not measured on the CPU"
    st = torch.cuda.memory_stats()
    return (f"the allocator made {st.get('num_alloc_retries', -1)} retries, "
            f"{st.get('num_device_alloc', -1)} cudaMalloc and "
            f"{st.get('num_device_free', -1)} cudaFree calls, and holds "
            f"{torch.cuda.memory_reserved() / 1e9:.2f} GB")


def _torch_batches(torch, batches):
    return {k: torch.from_numpy(v) for k, v in batches.items()}


def _kernel_group(name):
    low = name.lower()
    if "scale_noise" in low:
        return "scale_noise kernel"
    if "dp_round" in low:
        return "dp_round kernel"
    if "sqnorm" in low:
        return "sqnorm kernels"
    if any(k in low for k in ("absmax_", "encode_kernel", "decode_kernel")):
        return "bank codec kernels"
    if "tree_delta" in low:
        return "tree_delta kernel"
    if "flash_attention" in low:
        return "flash kernel"
    if "ssd_chunk" in low:
        return "SSD kernel"
    if "gemm" in low or "cutlass" in low or "xmma" in low:
        return "GEMM"
    return "other"


def _device_profile(torch, dev, run, cpu_ops=True):
    """run() once under torch.profiler; returns (its result, wall ms with the
    profiler on, {device kernel name: ms}, {device kernel name: launches}).
    cpu_ops=False traces the device alone (no host op events: a run of tens
    of thousands of launches then takes seconds less to read back)."""
    acts = [torch.profiler.ProfilerActivity.CPU] if cpu_ops or dev.type != "cuda" else []
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = run()
        _sync(torch, dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_name, calls = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_name[e.name] += e.time_range.elapsed_us() / 1e3
            calls[e.name] += 1
    return out, wall_ms, per_name, calls


def _profiled(torch, dev, run, rounds, top=12, cpu_ops=True):
    """run() once under torch.profiler; prints where the device time went
    and returns (run()'s result, device busy ms per round, {kernel group:
    ms per round}, device kernels per round). cpu_ops as _device_profile."""
    out, wall_ms, per_name, calls = _device_profile(torch, dev, run, cpu_ops=cpu_ops)
    busy_ms = sum(per_name.values())
    n_launch = sum(calls.values())
    print(f"[profile] {rounds} rounds: wall {wall_ms:.1f} ms with the profiler on, "
          f"device busy {busy_ms:.2f} ms ({busy_ms / rounds:.2f} ms/round), "
          f"{n_launch} device kernels ({n_launch / rounds:.0f}/round)")
    groups = collections.Counter()
    for name, ms in per_name.items():
        groups[_kernel_group(name)] += ms
    for g, ms in groups.most_common():
        print(f"[profile]   {g:16s} {ms / rounds:8.3f} ms/round  {ms / max(busy_ms, 1e-9):6.1%}")
    for name, ms in per_name.most_common(top):
        print(f"[profile]   {ms / rounds:8.3f} ms/round {calls[name] / rounds:6.1f}x/round  "
              f"{name[:100]}")
    return out, busy_ms / rounds, {g: ms / rounds for g, ms in groups.items()}, n_launch / rounds


def _leaves(tree):
    from repro_torch.tree_util import tree_flatten
    return tree_flatten(tree)[0]


def _model_size(theta_L):
    """P of a ParamFlat or of a model tree."""
    from repro_torch.federation import ParamFlat
    if isinstance(theta_L, ParamFlat):
        return theta_L.size
    return sum(leaf.numel() for leaf in _leaves(theta_L))


def _bank_summary(torch, bank, n_owners, P):
    """One line on the bank's storage and resident bytes."""
    from repro_torch.federation import QuantBank
    f32 = n_owners * P * 4 / 1e9
    if isinstance(bank, QuantBank):
        return (f"bank {bank.codec.fmt} codes {tuple(bank.codes.shape)} + scales + residual = "
                f"{bank.nbytes / 1e9:.3f} GB resident (f32: {f32:.3f} GB)")
    leaves = _leaves(bank)
    gb = sum(leaf.numel() * leaf.element_size() for leaf in leaves) / 1e9
    if len(leaves) == 1:
        return f"bank {tuple(bank.shape)} {bank.dtype} = {gb:.3f} GB"
    return f"pytree bank of {len(leaves)} (N, *shape) leaves = {gb:.3f} GB"


def _finite(torch, t):
    """isfinite(t).all(), one row (of the leading axis) at a time where t is
    large: isfinite over a whole bank or node tensor would allocate as much
    again and more (it set main's peak memory before it went row-wise)."""
    if t.dim() > 1 and t.numel() > 1 << 26:
        return all(_finite(torch, row) for row in t)
    return bool(torch.isfinite(t).all())


def _state_finite(torch, state):
    from repro_torch.federation import PagedBank, ParamFlat, QuantBank
    bank = state.bank.hot if isinstance(state.bank, PagedBank) else state.bank
    parts = (bank.scales, bank.residual) if isinstance(bank, QuantBank) else tuple(_leaves(bank))
    if state.tree is not None:
        parts += tuple(_leaves(state.tree.nodes))
    theta = state.theta_L
    theta = (theta.buf,) if isinstance(theta, ParamFlat) else tuple(_leaves(theta))
    return all(_finite(torch, t) for t in (*theta, *parts))


def _tree_view(counts, depth, eps, cap):
    """The ledger's "tree" view of each owner, as the host computes it from
    the responses it granted."""
    return {i: {"depth": depth, "capacity": (1 << depth) - 1,
                "nodes_completed_per_level": [int(c) >> lvl for lvl in range(depth)],
                "eps_per_node": eps / (depth * cap)} for i, c in enumerate(counts)}


def phase_main(torch, dev, cfg=None, n_owners=16, records=10_000, seq=128, dispatches=4,
               bank_dtype=None, tree_depth=None, pack_params=True, tag="main", cpu_ops=True):
    """One full-width path: `dispatches` timed run_rounds calls of K = 8, one
    profiled, two step() calls and reconcile, with the launch counters set
    to 0 just before and read just after. `tree_depth` runs the tree
    mechanism at that depth; `pack_params=False` the pytree state (with the
    fused privatizer: per leaf sqnorm and scale_noise); `cpu_ops` as
    `_device_profile`'s, for the profiled dispatch. Returns (launches,
    fed, pipe, lm, profile) with profile = {"busy": device ms per round,
    "median": ms per round, "groups": {kernel group: ms per round},
    "launches": device kernels per round, "peak": peak GB}."""
    from repro_torch import random
    from repro_torch.configs import DENSE_124M
    from repro_torch.data import OwnerDataPipeline, synthetic_owner_shards
    from repro_torch.federation import (DataOwner, Federation, FederationConfig,
                                        PrivatizerConfig, as_bank_codec)
    from repro_torch.models import LM
    cfg = DENSE_124M if cfg is None else cfg
    batch, G, K = 4, 2, 8
    quant = as_bank_codec(bank_dtype) is not None
    tree = bool(tree_depth)
    mech = {} if tree_depth is None else dict(mechanism="tree", tree_depth=tree_depth)
    lm = LM(cfg, remat=False)   # as examples/async_dp_llm.py builds it

    def loss_fn(p, b):
        return lm.loss(p, b)[0]

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    shards = synthetic_owner_shards(n_owners, records, seq, cfg.vocab, seed=0)
    pipe = OwnerDataPipeline(shards, batch, seed=0)
    owners = [DataOwner(n=s, epsilon=1.0, xi=1.0) for s in pipe.owner_sizes]
    fed = Federation(owners, FederationConfig.from_target_lr(
        0.05, n_owners=n_owners, horizon=1000, sigma=1e-2, theta_max=100.0), device=dev, **mech)
    fed.make_step(loss_fn, pack_params=pack_params, bank_dtype=bank_dtype,
                  privatizer=PrivatizerConfig(xi=1.0, granularity="microbatch",
                                              n_microbatches=G, fused_kernel=True))
    state = fed.init_state(lm.init(seed=0, device=dev))
    P = _model_size(state.theta_L)
    check(P == cfg.param_count(), f"P = {P}")
    # a hybrid model's microbatch runs one SSD scan forward and backward per
    # Mamba2 layer (its attention, one kv chunk at these lengths, no flash),
    # an xLSTM's per mLSTM layer
    scans = K * G * _scan_layers(cfg)
    model = {"flash_attention": 0, "ssd_chunk_scan": scans, "ssd_chunk_scan_bwd": scans}
    if pack_params:
        per_dispatch = {"sqnorm": K * G, "dp_round": K * (not tree), "scale_noise": 0,
                        "absmax": K * quant, "encode": K * quant, "decode": K * quant,
                        "tree_delta": K * tree, **model}
    else:
        # the pytree privatizer: a clip norm per leaf and group, one
        # scale_noise pass per leaf
        n_leaves = len(_leaves(state.theta_L))
        per_dispatch = {"sqnorm": K * G * n_leaves, "dp_round": 0, "scale_noise": K * n_leaves,
                        "absmax": 0, "encode": 0, "decode": 0, "tree_delta": 0, **model}
    held_out = np.random.default_rng(99).integers(0, cfg.vocab, (batch, seq),
                                                  dtype=np.int32)
    eval_batch = _torch_batches(torch, {"tokens": held_out,
                                        "labels": np.roll(held_out, -1, axis=1)})
    eval_batch = {k: v.to(dev) for k, v in eval_batch.items()}
    with torch.no_grad():
        loss0 = float(loss_fn(fed.params_of(state), eval_batch))
    _sync(torch, dev)
    print(f"[{tag}] {cfg.name}: P={P}, {n_owners} owners, "
          f"{_bank_summary(torch, state.bank, n_owners, P)}, "
          f"set-up {time.perf_counter() - t0:.1f} s, central loss before {loss0:.4f}")
    if state.tree is not None:
        nodes = state.tree.nodes       # the flat engine's (N, depth, P) tensor
        print(f"[{tag}] noise trees: nodes {tuple(nodes.shape)} f32 = "
              f"{nodes.numel() * 4 / 1e9:.3f} GB (N x depth x P x 4 B), capacity "
              f"{fed.mechanism.capacity} leaves per owner, per-node scale "
              f"{float(fed.mechanism.scales(device=dev)[0]):.6e}")
    granted = collections.Counter()

    key = random.PRNGKey(0, device=dev)
    _reset_launches()

    def dispatch(state, sub):
        owner_seq = pipe.schedule(K)
        batches = _torch_batches(torch, pipe.batches_for(owner_seq))
        before = _launches()
        state, ms = fed.run_rounds(state, batches, owner_seq, key=sub)
        got = _diff(_launches(), before)
        check(got == per_dispatch, f"launches {got} in one dispatch, expected {per_dispatch}")
        check(not bool(ms["refused"].any()), "a round was refused under a long horizon")
        granted.update(int(o) for o in owner_seq)
        return state, ms, owner_seq, got

    per_round = []
    for d in range(dispatches):
        key, sub = random.split(key)
        _sync(torch, dev)
        if d == 1 and dev.type == "cuda":
            torch.cuda.reset_accumulated_memory_stats()
        t0 = time.perf_counter()
        state, ms, owner_seq, got = dispatch(state, sub)
        _sync(torch, dev)
        dt = (time.perf_counter() - t0) * 1e3
        per_round.append(dt / K)
        print(f"[{tag}] dispatch {d}: K={K} rounds in {dt:.1f} ms ({dt / K:.1f} ms/round), "
              f"owners {owner_seq.tolist()}, launches {got}, "
              f"clip_frac {ms['clip_frac'].mean().item():.2f}")
    # dispatch 0 warms cuBLAS and the allocator
    median = statistics.median(per_round[1:] or per_round)
    print(f"[{tag}] median of dispatches 1..{dispatches - 1}: {median:.2f} ms/round; in "
          f"those dispatches {_allocator_work(torch, dev)}")
    key, sub = random.split(key)
    (state, _, _, _), busy, groups, per_round_launches = _profiled(
        torch, dev, lambda: dispatch(state, sub), K, cpu_ops=cpu_ops)
    print(f"[profile] {tag}: device busy {busy:.2f} of the unprofiled median {median:.2f} "
          f"ms/round: the device idles {1 - busy / median:.1%} of a round")
    it = iter(pipe)
    for j in range(2):
        owner, b = next(it)
        key, sub = random.split(key)
        state, m = fed.step(state, b, owner, sub)
        check(not m["refused"], "step refused under a long horizon")
        granted[int(owner)] += 1
    launches = _launches()
    rounds = (dispatches + 1) * K + 2
    ledger = fed.reconcile(state)
    counts = [granted[i] for i in range(n_owners)]
    check([r["responses"] for r in ledger.values()] == counts and sum(counts) == rounds,
          "ledger responses differ from the host's count of the drawn owners")
    check(sum(r["refused"] for r in ledger.values()) == 0, "ledger refusals")
    if tree:
        cap = fed.mechanism.cap
        view = _tree_view(counts, tree_depth, 1.0, cap)
        check({i: r["tree"] for i, r in ledger.items()} == view,
              "the ledger's tree view differs from the host's")
        check(state.tree.counts.cpu().tolist() == counts, "leaf counts differ from the host's")
        print(f"[{tag}] leaf counts {counts} == host; ledger tree view == host "
              f"(capacity {cap}, eps per node {view[0]['eps_per_node']:.6f})")
    check(_state_finite(torch, state), "non-finite state")
    check(int(state.step) == rounds, "step counter")
    with torch.no_grad():
        loss1 = float(loss_fn(fed.params_of(state), eval_batch))
    check(math.isfinite(loss0) and math.isfinite(loss1), "non-finite loss")
    print(f"[{tag}] central loss {loss0:.4f} -> {loss1:.4f} after {rounds} rounds; "
          f"launches {launches}; peak memory {_peak_gb(torch, dev):.2f} GB")
    print(f"[{tag}] ledger " + json.dumps(
        {i: [r["responses"], r["refused"], round(r["spent"], 6)]
         for i, r in ledger.items()}))
    peak = _peak_gb(torch, dev)
    del state
    return launches, fed, pipe, lm, dict(busy=busy, median=median, groups=groups,
                                         launches=per_round_launches, peak=peak)


MESH_K = 16                      # rounds a dispatch in phase mesh
# phase mesh's runs: (tag, bank_dtype, tree depth, owner_parallel)
MESH_RUNS = (("f32", None, None, False), ("f32", None, None, True),
             ("bf16", "bfloat16", None, False), ("bf16", "bfloat16", None, True),
             ("int8", "int8", None, False), ("tree", None, 2, False))


def _time_collectives(torch, dev, lay, p):
    """ms of each FlatLayout collective a round issues, on its groups, with
    CUDA events (median of five readings): the row pick of one (1, P) f32
    row, theta_bar's gather over the columns, and the scalar reductions."""
    row = torch.randn((1, p), device=dev)
    idx = torch.zeros(1, dtype=torch.int64, device=dev)
    flag = torch.ones((), dtype=torch.bool, device=dev)
    part = torch.ones(1, device=dev)
    isum = torch.ones((), dtype=torch.int64, device=dev)
    out = {}
    for name, fn, iters in (("pick (1, P) f32", lambda: lay.pick(row, idx), 20),
                            ("gather_cols (P,) f32", lambda: lay.gather_cols(row[0]), 20),
                            ("max_cols (1,)", lambda: lay.max_cols(part), 50),
                            ("sum_cols int64", lambda: lay.sum_cols(isum), 50),
                            ("all_cols bool", lambda: lay.all_cols(flag), 50)):
        out[name] = _steady_ms(torch, f"mesh {name}", fn, iters)
    del row
    return out


def phase_mesh(torch, dev, cfg=None, n_owners=16, records=10_000, seq=128, K=MESH_K,
               runs=MESH_RUNS):
    """The federation engine on a device mesh: a world of one over NCCL
    (gloo on the CPU) in this process and the 1x1 (data, model) mesh of
    launch.mesh.make_host_mesh, at main's model, owners, batch and G. Each
    run of `runs` is one dispatch of K rounds on a fresh meshed state and
    one on a fresh unmeshed twin, with the same sequence, batches and key,
    the launch counters read around each: theta_L, the bank (rows, or
    codes, scales and residual), the tree's nodes and counts, the ledger's
    columns, the metrics and the reconciled ledger bit for bit, and the
    same launches. Prints each side's ms a round (the host clock around a
    synchronize; the two alternate which runs first) and the collectives'
    own ms on the one-rank groups, then tears the process group down.
    Returns {tag: (meshed ms, unmeshed ms)}."""
    import torch.distributed as dist

    from repro_torch import random
    from repro_torch.configs import DENSE_124M
    from repro_torch.data import OwnerDataPipeline, synthetic_owner_shards
    from repro_torch.federation import (DataOwner, Federation, FederationConfig,
                                        PrivatizerConfig, QuantBank)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import LM
    from repro_torch.sharding.flat import layout_for
    cfg = DENSE_124M if cfg is None else cfg
    batch, G = 4, 2
    lm = LM(cfg, remat=False)   # as examples/async_dp_llm.py builds it
    t0 = time.perf_counter()
    check(not dist.is_initialized(), "a process group exists before phase mesh")
    mesh = make_host_mesh(device_type=dev.type)
    shards = synthetic_owner_shards(n_owners, records, seq, cfg.vocab, seed=0)
    pipe = OwnerDataPipeline(shards, batch, seed=0)
    params = lm.init(seed=0, device=dev)
    owner_seq = pipe.schedule(K)
    batches = _torch_batches(torch, pipe.batches_for(owner_seq))
    key = random.PRNGKey(7, device=dev)
    print(f"[mesh] {cfg.name}: world of {dist.get_world_size()} over "
          f"{dist.get_backend()}, mesh {tuple(mesh.mesh.shape)} {mesh.mesh_dim_names}, "
          f"{n_owners} owners, K={K}, set-up {time.perf_counter() - t0:.1f} s")

    def one(tag, bank_dtype, depth, grouped, meshed):
        mech = {} if depth is None else dict(mechanism="tree", tree_depth=depth)
        fed = Federation([DataOwner(n=s, epsilon=1.0, xi=1.0) for s in pipe.owner_sizes],
                         FederationConfig.from_target_lr(0.05, n_owners=n_owners, horizon=1000,
                                                         sigma=1e-2, theta_max=100.0),
                         device=dev, **mech)
        dt = getattr(torch, bank_dtype) if bank_dtype == "bfloat16" else bank_dtype
        fed.make_step(lambda p, b: lm.loss(p, b)[0], pack_params=True, bank_dtype=dt,
                      mesh=mesh if meshed else None,
                      privatizer=PrivatizerConfig(xi=1.0, granularity="microbatch",
                                                  n_microbatches=G, fused_kernel=True))
        state = fed.init_state(params)
        check((state.theta_L.layout is not None) == meshed, "the state's layout")
        _sync(torch, dev)
        before = _launches()
        t1 = time.perf_counter()
        state, ms = fed.run_rounds(state, batches, owner_seq, key=key, owner_parallel=grouped)
        _sync(torch, dev)
        wall = (time.perf_counter() - t1) * 1e3 / K
        got = _diff(_launches(), before)
        check(_state_finite(torch, state), f"{tag}: non-finite state")
        # the state's own tensors, compared on the card (a host copy of
        # the bank and the nodes would take most of the phase)
        bank = state.bank
        parts = {"theta": (state.theta_L.buf,),
                 "bank": ((bank.codes, bank.scales, bank.residual)
                          if isinstance(bank, QuantBank) else (bank,)),
                 "ledger": tuple(getattr(state.ledger, c) for c in state.ledger.COLUMNS),
                 "metrics": tuple(ms[k] for k in sorted(ms))}
        if state.tree is not None:
            parts["nodes"] = (state.tree.nodes, state.tree.counts)
        return parts, got, wall, fed.reconcile(state)

    out = {}
    for i, (tag, bank_dtype, depth, grouped) in enumerate(runs):
        name = f"{tag} {'grouped' if grouped else 'sequential'}"
        order = (True, False) if i % 2 else (False, True)
        res = {m: one(tag, bank_dtype, depth, grouped, m) for m in order}
        (pm, gm, wm, led_m), (pu, gu, wu, led_u) = res[True], res[False]
        for part in pu:
            check(_bit_equal(torch, pm[part], pu[part]),
                  f"{name}: the 1x1 mesh's {part} differs from the unmeshed twin's")
        check(gm == gu, f"{name}: launches {gm} on the mesh, {gu} unmeshed")
        check(led_m == led_u, f"{name}: the reconciled ledgers differ")
        check(gm["sqnorm"] > 0, f"{name}: no sqnorm launched")
        compared = ", ".join(sorted(pu))
        del res, pm, pu
        out[name] = (wm, wu)
        print(f"[mesh] {name}: 1x1 mesh == unmeshed bit for bit "
              f"({compared}); {wm:.2f} ms/round meshed, {wu:.2f} unmeshed "
              f"({wm - wu:+.2f}); launches per dispatch "
              + json.dumps({k: v for k, v in gm.items() if v}))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if dev.type == "cuda":
        lay = layout_for(mesh, n_owners, _model_size(params))
        coll = _time_collectives(torch, dev, lay, lay.p)
        print("[mesh] collectives on the one-rank groups (ms): " + json.dumps(
            {k: round(v, 4) for k, v in coll.items()}))
    dist.destroy_process_group()
    check(not dist.is_initialized(), "the process group outlived phase mesh")
    return out


EXAMPLE_K = 8                    # rounds a dispatch in phase example
EXAMPLE_OWNERS = 4               # owners of every dispatch but the grouped one (main's 16)


def _example_fed(torch, dev, lm, n_owners, bank_dtype=None, mesh=None):
    from repro_torch.federation import (DataOwner, Federation, FederationConfig,
                                        PrivatizerConfig)
    fed = Federation([DataOwner(n=10_000, epsilon=1.0, xi=1.0)] * n_owners,
                     FederationConfig.from_target_lr(0.05, n_owners=n_owners, horizon=1000,
                                                     sigma=1e-2, theta_max=100.0), device=dev)
    fed.make_step(lambda p, b: lm.loss(p, b)[0], pack_params=True, bank_dtype=bank_dtype,
                  mesh=mesh, privatizer=PrivatizerConfig(xi=1.0, granularity="example",
                                                         fused_kernel=True))
    return fed


def _checkpoint_arrays(directory):
    """(manifest, {npz key: array}) of the newest checkpoint under it."""
    from repro_torch.checkpoint import latest_step, load_manifest
    step = latest_step(directory)
    with np.load(os.path.join(directory, f"step_{step:08d}", "arrays.npz")) as z:
        return load_manifest(directory, step), {k: z[k] for k in z.files}


def phase_example(torch, dev, cfg=None, n_owners=EXAMPLE_OWNERS, group_owners=16, seq=128,
                  K=EXAMPLE_K, root=None):
    """Per-example clipping on the fused flat engine
    (`PrivatizerConfig(granularity="example", fused_kernel=True)`) at main's
    model and batch (4 x seq), `n_owners` owners, K rounds a dispatch:

    - sequential: a warm dispatch, a timed one and a profiled one, each
      with K sqnorm (ONE row-axis launch over the B per-example gradients a
      round) and K dp_round and no other kernel; then the first dispatch's
      rounds as a `step()` loop from a fresh state under the same keys:
      theta_L, the bank and the reconciled ledger bit for bit;
    - grouped (`owner_parallel=True`) at `group_owners` owners (main's)
      and the default max_group over K distinct owners: the groups are as
      long as the free device memory allows (`deep.example_group_cap`),
      with one sqnorm (g * B rows) and one dp_round a group; its peak;
    - the model cast to bf16 (its leaves bf16, the buffer f32): one
      dispatch, `params_of` in bf16, finite;
    - an f16 bank: one dispatch, finite;
    - a world of one and the 1x1 mesh: a meshed state and its unmeshed twin
      run one dispatch; the meshed one's `save_session` under build/ holds
      the twin state's arrays (keys, dtypes, every array) bit for bit; a
      fresh session restores the checkpoint on the mesh and runs the next
      dispatch as the uninterrupted meshed session does, bit for bit.

    Then `fused_sqnorm_rows` at (B, P) is timed beside `fused_sqnorm` at
    (P,) (row 2's single row). Returns (the sequential dispatches'
    launches, the profile as phase_main's)."""
    import shutil

    import torch.distributed as dist

    from repro_torch import random
    from repro_torch.checkpoint import flatten_with_paths
    from repro_torch.checkpoint.store import PIECE_BYTES, to_storage
    from repro_torch.configs import DENSE_124M
    from repro_torch.kernels.dp_clip_noise import ops as dops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import LM
    from repro_torch.tree_util import tree_map
    cfg = DENSE_124M if cfg is None else cfg
    batch = 4
    lm = LM(cfg, remat=False)   # as examples/async_dp_llm.py builds it
    t0 = time.perf_counter()
    params = lm.init(seed=0, device=dev)
    P = _model_size(params)
    rng = np.random.default_rng(25)
    drawn = {}
    seqs = [rng.integers(0, n_owners, K) for _ in range(5)]
    data = [_owner_batches(torch, cfg, s, drawn, batch=batch, seq=seq) for s in seqs]
    keys = [random.PRNGKey(2500 + i, device=dev) for i in range(5)]
    quiet = {k: 0 for k in _launches()}
    print(f"[example] {cfg.name}: P={P}, {n_owners} owners, batch {batch} x {seq}, K={K}, "
          f"xi 1.0 per example, set-up {time.perf_counter() - t0:.1f} s")

    def dispatch(fed, state, i, expect, **kw):
        before = _launches()
        state, ms = fed.run_rounds(state, data[i], seqs[i], key=keys[i], **kw)
        got = _diff(_launches(), before)
        check(got == dict(quiet, **expect), f"example: launches {got}, expected {expect}")
        check(not bool(ms["refused"].any()), "example: a round was refused")
        return state, ms, got

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    seq_expect = {"sqnorm": K, "dp_round": K}
    fed = _example_fed(torch, dev, lm, n_owners)
    state = fed.init_state(params)
    state, ms0, _ = dispatch(fed, state, 0, seq_expect)          # warms up
    after0 = _state_tensors(state)
    led0 = fed.reconcile(state)
    _sync(torch, dev)
    t1 = time.perf_counter()
    state, ms, seq_got = dispatch(fed, state, 1, seq_expect)
    _sync(torch, dev)
    wall = (time.perf_counter() - t1) * 1e3 / K
    print(f"[example] sequential dispatch: {wall:.2f} ms/round, launches "
          + json.dumps({k: v for k, v in seq_got.items() if v})
          + f" (one sqnorm over {batch} rows a round), clip_frac "
          f"{ms['clip_frac'].mean().item():.2f}, max_grad_norm "
          f"{ms['max_grad_norm'].max().item():.3f}")
    (state, _, _), busy, groups, per_round = _profiled(
        torch, dev, lambda: dispatch(fed, state, 2, seq_expect), K, cpu_ops=False)
    print(f"[profile] example: device busy {busy:.2f} of {wall:.2f} ms/round: the device "
          f"idles {1 - busy / wall:.1%} of a round")
    peak = _peak_gb(torch, dev)
    check(_state_finite(torch, state), "example: non-finite state")
    del state
    # the step loop over dispatch 0's rounds, from a fresh state
    loop = _example_fed(torch, dev, lm, n_owners)
    ls = loop.init_state(params)
    for k, kk in enumerate(random.split(keys[0], K)):
        ls, m = loop.step(ls, {n: v[k] for n, v in data[0].items()}, int(seqs[0][k]), kk)
        check(not m["refused"], "example: step refused")
    check(_bit_equal(torch, _state_tensors(ls), after0) and loop.reconcile(ls) == led0,
          "example: the step loop differs from run_rounds")
    del ls, loop, after0
    print(f"[example] the step loop over dispatch 0's {K} rounds == run_rounds bit for bit "
          f"(theta_L, bank, reconciled ledger); peak {peak:.2f} GB")

    # the grouped driver at main's owners and the default max_group ("auto"):
    # K distinct owners make one conflict-free run, so the group cap is the
    # one the free device memory gives (deep.example_group_cap); one sqnorm
    # over g * B rows and one dp_round a group
    from repro_torch.federation import auto_max_group, partition_conflict_free
    from repro_torch.federation import session as fsession
    gseq = rng.permutation(group_owners)[:K]
    gdata = _owner_batches(torch, cfg, gseq, drawn, batch=batch, seq=seq)
    gfed = _example_fed(torch, dev, lm, group_owners)
    gstate = gfed.init_state(params)
    caps, cap_fn = [], fsession.example_group_cap
    fsession.example_group_cap = lambda *a: caps.append(cap_fn(*a)) or caps[-1]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 1e9 if dev.type == "cuda" else float("nan")
    try:
        _sync(torch, dev)
        t1 = time.perf_counter()
        before = _launches()
        gstate, gms = gfed.run_rounds(gstate, gdata, gseq, key=keys[3], owner_parallel=True)
        got = _diff(_launches(), before)
        _sync(torch, dev)
    finally:
        fsession.example_group_cap = cap_fn
    gwall = (time.perf_counter() - t1) * 1e3 / K
    gpeak = _peak_gb(torch, dev)
    cap = min(auto_max_group(gseq), caps[0]) if caps else auto_max_group(gseq)
    check(dev.type != "cuda" or len(caps) == 1, "example grouped: no memory cap on the card")
    groups_of = partition_conflict_free(gseq, cap)
    check(got == dict(quiet, sqnorm=len(groups_of), dp_round=len(groups_of)),
          f"example grouped: launches {got}, expected one sqnorm and one dp_round a group "
          f"of {[n for _, n in groups_of]}")
    check(not bool(gms["refused"].any()), "example grouped: a round was refused")
    check(_state_finite(torch, gstate), "example grouped: non-finite state")
    print(f"[example] grouped dispatch at {group_owners} owners, max_group auto: "
          f"{auto_max_group(gseq)} from the sequence, memory cap "
          f"{caps[0] if caps else 'none (host)'}: {len(groups_of)} groups of "
          f"{[n for _, n in groups_of]} rounds, {gwall:.2f} ms/round (first call), launches "
          + json.dumps({k: v for k, v in got.items() if v})
          + f", peak {gpeak:.2f} GB over {base:.2f} GB resident "
          f"({(gpeak - base) / max(n for _, n in groups_of):.2f} GB a member)")
    del gstate, gfed, gdata, gms

    # the model cast to bf16, and an f16 bank
    for tag, p_in, bank_dtype in (("bf16 model", tree_map(lambda x: x.to(torch.bfloat16),
                                                          params), None),
                                  ("f16 bank", params, torch.float16)):
        ofed = _example_fed(torch, dev, lm, n_owners, bank_dtype=bank_dtype)
        ostate = ofed.init_state(p_in)
        _sync(torch, dev)
        t1 = time.perf_counter()
        ostate, oms, got = dispatch(ofed, ostate, 4, seq_expect)
        _sync(torch, dev)
        owall = (time.perf_counter() - t1) * 1e3 / K
        dtypes = sorted({str(leaf.dtype) for leaf in _leaves(ofed.params_of(ostate))})
        check(_state_finite(torch, ostate), f"example {tag}: non-finite state")
        check(dtypes == sorted({str(leaf.dtype) for leaf in _leaves(p_in)}),
              f"example {tag}: params_of gives {dtypes}")
        print(f"[example] {tag}: one dispatch {owall:.2f} ms/round (first call), bank "
              f"{ostate.bank.dtype}, leaves {dtypes}, clip_frac "
              f"{oms['clip_frac'].mean().item():.2f}")
        del ostate, ofed

    # checkpoints on the 1x1 mesh: the unmeshed twin's files, and a resume
    check(not dist.is_initialized(), "a process group exists before phase example's mesh")
    mesh = make_host_mesh(device_type=dev.type)
    root = os.path.join(ROOT, "build", "chip_smoke_example") if root is None else root
    shutil.rmtree(root, ignore_errors=True)
    try:
        saved = {}
        for tag, m in (("mesh", mesh), ("twin", None)):
            f = _example_fed(torch, dev, lm, n_owners, mesh=m)
            st = f.init_state(params)
            st, _, _ = dispatch(f, st, 0, seq_expect)
            f.reconcile(st)
            save_s = save_gb = 0.0
            if m is not None:
                _sync(torch, dev)
                if dev.type == "cuda":
                    torch.cuda.reset_peak_memory_stats()
                    held = torch.cuda.memory_allocated()
                t1 = time.perf_counter()
                f.save_session(os.path.join(root, tag), st)
                save_s = time.perf_counter() - t1
                if dev.type == "cuda":
                    # the pieces reach the host a few rows at a time: the
                    # save adds at most one piece to the device
                    save_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
                    check(save_gb * 1e9 <= PIECE_BYTES, f"example: the meshed save took "
                          f"{save_gb:.3f} GB of device memory beyond the state")
            saved[tag] = (f, st, (save_s, save_gb))
        # the meshed files hold the unmeshed twin's arrays, key for key
        manifest, arrays = _checkpoint_arrays(os.path.join(root, "mesh"))
        twin = {k: to_storage(v) for k, v in flatten_with_paths(saved.pop("twin")[1]).items()}
        check(manifest["keys"] == list(twin)
              and manifest["dtypes"] == {k: name for k, (_, name) in twin.items()}
              and all(np.array_equal(arrays[k.replace("/", "__SL__")], a)
                      and arrays[k.replace("/", "__SL__")].dtype == a.dtype
                      for k, (a, _) in twin.items()),
              "example: the 1x1 mesh's checkpoint differs from the unmeshed twin's state")
        del manifest, arrays, twin
        f, st, (save_s, save_gb) = saved.pop("mesh")
        st, _, _ = dispatch(f, st, 1, seq_expect)                 # uninterrupted
        whole, led_whole = _state_tensors(st), f.reconcile(st)
        del st, f
        f = _example_fed(torch, dev, lm, n_owners, mesh=mesh)
        _sync(torch, dev)
        t1 = time.perf_counter()
        st = f.restore_session(os.path.join(root, "mesh"), f.init_state(params))
        _sync(torch, dev)
        restore_s = time.perf_counter() - t1
        check(st.theta_L.layout is not None, "example: the restored state is not on the mesh")
        st, _, _ = dispatch(f, st, 1, seq_expect)
        check(_bit_equal(torch, _state_tensors(st), whole) and f.reconcile(st) == led_whole,
              "example: the resumed meshed session differs from the uninterrupted one")
        del st, f, whole
        print(f"[example] 1x1 mesh: save_session {save_s:.2f} s ({save_gb:.3f} GB of device "
              f"memory beyond the state), its arrays == the unmeshed "
              f"twin's state bit for bit (keys, dtypes, every array); restore_session "
              f"{restore_s:.2f} s and {K} rounds == the uninterrupted meshed run bit for bit")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        dist.destroy_process_group()
    check(not dist.is_initialized(), "the process group outlived phase example")

    if dev.type == "cuda":
        gen = torch.Generator(device=dev).manual_seed(26)
        x = torch.randn((batch, P), device=dev, generator=gen)
        rows_ms = _steady_ms(torch, f"fused_sqnorm_rows ({batch}, P)",
                             lambda: dops.fused_sqnorm_rows(x), 20)
        one_ms = _steady_ms(torch, "fused_sqnorm (P,)", lambda: dops.fused_sqnorm(x[0]), 20)
        bound = batch * P * 4 / HBM_BYTES_PER_S * 1e3
        print(f"[timing] sqnorm at phase example's ({batch}, P = {P}): one row-axis launch "
              f"{rows_ms:.4f} ms ({bound / rows_ms:.1%} of its bound {bound:.4f} ms); row 2's "
              f"single row {one_ms:.4f} ms")
        del x
    return seq_got, dict(busy=busy, median=wall, groups=groups, launches=per_round, peak=peak)


def phase_quant(torch, dev, cfg=None, n_owners=128, records=10_000, seq=128):
    """The int8 bank at full width (phase_main), then one fp8 dispatch on a
    fresh state after the int8 one is freed. Returns the int8 run's launches."""
    from repro_torch import random
    K, G = 8, 2
    launches, fed, pipe, lm, _ = phase_main(torch, dev, cfg=cfg, n_owners=n_owners,
                                            records=records, seq=seq, bank_dtype="int8",
                                            dispatches=3, tag="quant", cpu_ops=False)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    state = fed.init_state(lm.init(seed=0, device=dev), bank_dtype="fp8")
    owner_seq = pipe.schedule(K)
    batches = _torch_batches(torch, pipe.batches_for(owner_seq))
    _reset_launches()
    _sync(torch, dev)
    t0 = time.perf_counter()
    state, ms = fed.run_rounds(state, batches, owner_seq, key=random.PRNGKey(1, device=dev))
    _sync(torch, dev)
    dt = (time.perf_counter() - t0) * 1e3
    got = _launches()
    check(got == {"sqnorm": K * G, "dp_round": K, "scale_noise": 0, "absmax": K, "encode": K,
                  "decode": K, "tree_delta": 0, "flash_attention": 0, "ssd_chunk_scan": 0,
                  "ssd_chunk_scan_bwd": 0},
          f"fp8 dispatch launched {got}")
    check(not bool(ms["refused"].any()) and _state_finite(torch, state), "fp8 dispatch")
    print(f"[quant] fp8: one dispatch of K={K} on a fresh state, {dt:.1f} ms "
          f"({dt / K:.1f} ms/round, the first dispatch of its state), launches {got}, "
          f"{_bank_summary(torch, state.bank, n_owners, state.theta_L.size)}, "
          f"peak memory {_peak_gb(torch, dev):.2f} GB")
    del state, fed
    return launches


def phase_pytree(torch, dev, cfg=None, n_owners=16, records=10_000, seq=128):
    """The reference's default path at full width: phase_main on a pytree
    state with the fused privatizer, then two K = 8 dispatches of the repo's
    example configuration (fused_kernel=False, the jnp-equivalent Laplace
    draw per leaf, no kernel) on a fresh pytree state. Returns (launches,
    profile, ms per round of the second unfused dispatch)."""
    from repro_torch import random
    from repro_torch.federation import PrivatizerConfig
    K, G = 8, 2
    launches, fed, pipe, lm, prof = phase_main(torch, dev, cfg=cfg, n_owners=n_owners,
                                               records=records, seq=seq, pack_params=False,
                                               dispatches=3, tag="pytree", cpu_ops=False)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    fed.make_step(lambda p, b: lm.loss(p, b)[0],
                  privatizer=PrivatizerConfig(xi=1.0, granularity="microbatch", n_microbatches=G))
    state = fed.init_state(lm.init(seed=0, device=dev))
    _reset_launches()
    per_round = []
    for d in range(2):
        owner_seq = pipe.schedule(K)
        batches = _torch_batches(torch, pipe.batches_for(owner_seq))
        _sync(torch, dev)
        t0 = time.perf_counter()
        state, ms = fed.run_rounds(state, batches, owner_seq,
                                   key=random.PRNGKey(2 + d, device=dev))
        _sync(torch, dev)
        per_round.append((time.perf_counter() - t0) * 1e3 / K)
        check(not bool(ms["refused"].any()), "a round of the unfused dispatch was refused")
    got = _launches()
    check(not any(got.values()), f"the unfused pytree dispatches launched kernels: {got}")
    check(_state_finite(torch, state), "non-finite state after the unfused dispatches")
    print(f"[pytree] fused_kernel=False (the example's configuration): two dispatches of "
          f"K={K} on a fresh state, {per_round[0]:.1f} and {per_round[1]:.1f} ms/round (the "
          f"second is kept), launches {got}, peak memory {_peak_gb(torch, dev):.2f} GB")
    del state, fed
    return launches, prof, per_round[1]


GROUPED_K = 32                   # rounds a dispatch in phase grouped
GROUPED_CAPS = ("auto", ROWS_G)  # max_group of its two settings


def phase_grouped(torch, dev, main_prof, cfg=None, n_owners=16, records=10_000, seq=128,
                  K=GROUPED_K, dispatches=2, caps=GROUPED_CAPS):
    """Main's path (flat f32 bank, fused, batch 4 x seq 128, G = 2) under
    the owner-parallel grouped driver, run_rounds(owner_parallel=True), with
    K = 32 rounds a dispatch. The owner sequences are the uniform schedule's
    under fixed keys (the same for every setting). For each max_group in
    `caps`: `dispatches` timed dispatches (the first warms up) and one
    profiled, each launching exactly one dp_round and G sqnorm per group;
    ms, device ms, device kernels, idle share, mean group size and peak
    memory per round, beside main's. Then the sequential driver on the
    first dispatch's sequence, batches and key from a fresh state: its
    refusals, device ledger and step counter must equal the grouped run's,
    and the largest theta_L difference is printed. Returns (the launches of
    the timed grouped dispatches, {cap: profile})."""
    from repro_torch import random
    from repro_torch.configs import DENSE_124M
    from repro_torch.data import OwnerDataPipeline, synthetic_owner_shards
    from repro_torch.federation import (DataOwner, Federation, FederationConfig,
                                        PrivatizerConfig, UniformSchedule, auto_max_group,
                                        partition_conflict_free)
    from repro_torch.models import LM
    cfg = DENSE_124M if cfg is None else cfg
    batch, G = 4, 2
    lm = LM(cfg, remat=False)   # as examples/async_dp_llm.py builds it
    t0 = time.perf_counter()
    shards = synthetic_owner_shards(n_owners, records, seq, cfg.vocab, seed=0)
    pipe = OwnerDataPipeline(shards, batch, seed=0)
    fed = Federation([DataOwner(n=s, epsilon=1.0, xi=1.0) for s in pipe.owner_sizes],
                     FederationConfig.from_target_lr(0.05, n_owners=n_owners, horizon=1000,
                                                     sigma=1e-2, theta_max=100.0), device=dev)
    fed.make_step(lambda p, b: lm.loss(p, b)[0], pack_params=True,
                  privatizer=PrivatizerConfig(xi=1.0, granularity="microbatch",
                                              n_microbatches=G, fused_kernel=True))
    params = lm.init(seed=0, device=dev)
    # drawn on the device, one copy each to the host for the batches
    seqs = [UniformSchedule().draw(random.PRNGKey(1000 + d, device=dev), n_owners, K)
            .cpu().numpy() for d in range(dispatches + 1)]
    data = [_torch_batches(torch, pipe.batches_for(o)) for o in seqs]
    keys = [random.PRNGKey(2000 + d, device=dev) for d in range(dispatches + 1)]
    print(f"[grouped] {cfg.name}: {n_owners} owners, K={K} rounds a dispatch, set-up "
          f"{time.perf_counter() - t0:.1f} s; conflict-free runs of the sequences "
          f"{[[n for _, n in partition_conflict_free(o)] for o in seqs]}")

    def dispatch(state, d, cap):
        """One dispatch of sequence d: grouped under max_group=cap, or the
        sequential driver when cap is False. Checks its launches."""
        before = _launches()
        state, ms = fed.run_rounds(state, data[d], seqs[d], key=keys[d],
                                   owner_parallel=cap is not False,
                                   max_group=None if cap is False else cap)
        got = _diff(_launches(), before)
        if cap is False:
            n_groups = K
        else:
            n_groups = len(partition_conflict_free(
                seqs[d], auto_max_group(seqs[d]) if cap == "auto" else cap))
        want = {k: 0 for k in got}
        want.update(sqnorm=G * n_groups, dp_round=n_groups)
        check(got == want, f"launches {got} in one dispatch of {n_groups} groups, "
              f"expected {want}")
        check(not bool(ms["refused"].any()), "a round was refused under a long horizon")
        return state, ms, n_groups, got

    stats, launches, first = {}, None, None
    for cap in caps:
        state = fed.init_state(params)
        _sync(torch, dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        per_round, sizes = [], []
        for d in range(dispatches):
            _sync(torch, dev)
            t1 = time.perf_counter()
            state, ms, n_groups, got = dispatch(state, d, cap)
            _sync(torch, dev)
            dt = (time.perf_counter() - t1) * 1e3
            per_round.append(dt / K)
            sizes.append(K / n_groups)
            launches = got if launches is None else {k: launches[k] + got[k] for k in got}
            print(f"[grouped] max_group={cap}, dispatch {d}: {n_groups} groups (mean "
                  f"{K / n_groups:.2f} members), {dt:.1f} ms ({dt / K:.2f} ms/round), "
                  f"launches {got}")
            if first is None:
                first = (ms["refused"].cpu(), state.ledger.spent.clone(),
                         state.ledger.refused.clone(), int(state.step),
                         state.theta_L.buf.clone())
        median = statistics.median(per_round[1:] or per_round)
        (state, _, n_groups, _), busy, groups, per_round_launches = _profiled(
            torch, dev, lambda: dispatch(state, dispatches, cap), K, cpu_ops=False)
        sizes.append(K / n_groups)
        check(_state_finite(torch, state), "non-finite state")
        peak = _peak_gb(torch, dev)
        stats[cap] = dict(busy=busy, median=median, groups=groups,
                          launches=per_round_launches, peak=peak,
                          mean_group=statistics.mean(sizes))
        print(f"[grouped] max_group={cap} against main (K=8, sequential) in this call, per "
              f"round: wall (median) {median:.2f} vs {main_prof['median']:.2f} ms; device "
              f"busy {busy:.3f} vs {main_prof['busy']:.3f} ms; device kernels "
              f"{per_round_launches:.0f} vs {main_prof['launches']:.0f}; idle share "
              f"{1 - busy / median:.1%} vs {1 - main_prof['busy'] / main_prof['median']:.1%}; "
              f"mean group {statistics.mean(sizes):.2f} members; peak memory {peak:.2f} vs "
              f"{main_prof['peak']:.2f} GB")
        del state
    # the sequential driver on dispatch 0's sequence, batches and key
    state = fed.init_state(params)
    _sync(torch, dev)
    t1 = time.perf_counter()
    state, ms, _, _ = dispatch(state, 0, False)
    _sync(torch, dev)
    seq_ms = (time.perf_counter() - t1) * 1e3 / K
    refused, spent, refused_led, step, theta = first
    check(torch.equal(ms["refused"].cpu(), refused) and torch.equal(state.ledger.spent, spent)
          and torch.equal(state.ledger.refused, refused_led) and int(state.step) == step,
          "the grouped dispatch's refusals or device ledger differ from the sequential one's")
    dtheta = float((state.theta_L.buf - theta).abs().max())
    ledger = fed.reconcile(state)
    counts = np.bincount(seqs[0], minlength=n_owners).tolist()
    check([r["responses"] for r in ledger.values()] == counts,
          "reconciled ledger differs from the host's count of the drawn owners")
    print(f"[grouped] sequential driver on dispatch 0 ({seq_ms:.2f} ms/round, warm): refused, "
          f"ledger spent/refused and step == the grouped run's (max_group={caps[0]}); "
          f"max |theta_L grouped - sequential| {dtheta:.3e} (theta_L max "
          f"{float(theta.abs().max()):.3e}); reconciled responses {counts}")
    del state, theta, first
    return launches, stats


FAULTS_K = 32                    # rounds a dispatch in phase faults
FAULTS_PLAN = dict(drop=0.05, stale=0.05, nonfinite=0.05, corrupt=0.05)
FAULTS_POLICY = dict(max_faults=3, window=16)
FAULTS_RUNTIME = dict(deadline=1.0, max_retries=2, backoff_cap=4, decay=0.9)
FAULTS_JITTER = 0.3
FAULT_COLUMNS = ("spent", "refused", "dropped", "faulted", "quarantined", "timed_out",
                 "retried")
# fault codes, as the port numbers them
F_OK, F_DROP, F_STALE, F_NONFINITE, F_CORRUPT, F_TIMEOUT = range(6)


class _Replay:
    """The outcome algebra of the fault-armed drivers replayed on the host in
    plain Python, from the owner sequence, the fault codes (timeouts
    merged) and the caps, for a finite model whose resident rows are
    intact: the seven ledger columns, the fault windows and the runtime
    counters, and each round's outcome."""

    def __init__(self, caps, policy, runtime):
        n = len(caps)
        self.cap = list(caps)
        self.policy, self.runtime = policy, runtime
        self.cols = {c: [0] * n for c in FAULT_COLUMNS}
        self.win, self.contacts, self.quar = [0] * n, [0] * n, [False] * n
        self.clock, self.step = 0, 0
        self.last, self.cool, self.back = [0] * n, [0] * n, [0] * n
        self.left = [runtime["max_retries"]] * n

    def run(self, owners, codes):
        """Replay rounds; returns {outcome: [bool per round]} (the ledger
        columns' outcomes, and "applied")."""
        out = collections.defaultdict(list)
        for i, c in zip((int(o) for o in owners), (int(c) for c in codes)):
            q, inb = self.quar[i], self.cool[i] > 0
            retry, avail = (not q) and inb, (not q) and not inb
            auth = self.cols["spent"][i] < self.cap[i]
            drop = auth and avail and c == F_DROP
            ans = auth and avail and not drop
            guard = c not in (F_STALE, F_NONFINITE, F_CORRUPT)
            apply = ans and guard and c != F_TIMEOUT
            timed = ans and c == F_TIMEOUT
            rej = ans and c != F_TIMEOUT and not guard
            for col, v in (("spent", ans), ("refused", avail and not auth), ("dropped", drop),
                           ("faulted", rej), ("quarantined", q), ("timed_out", timed),
                           ("retried", retry)):
                self.cols[col][i] += int(v)
                out[col].append(bool(v))
            out["applied"].append(apply)
            if avail:                              # the fault window
                base = 0 if self.contacts[i] % self.policy["window"] == 0 else self.win[i]
                self.win[i] = base + int(rej or drop)
                self.contacts[i] += 1
                self.quar[i] = self.win[i] >= self.policy["max_faults"]
            sched = timed and self.left[i] > 0     # the runtime
            bo = self.back[i]
            if sched:
                self.cool[i] = 1 << min(bo, self.runtime["backoff_cap"])
                self.back[i], self.left[i] = bo + 1, self.left[i] - 1
            else:
                self.cool[i] -= int(retry)
                if apply:
                    self.back[i], self.left[i] = 0, self.runtime["max_retries"]
            if apply:
                self.last[i] = self.clock
            self.clock += 1
            self.step += int(apply)
        return out

    def counters(self):
        """{name: list} in the device state's terms."""
        out = {f"ledger.{c}": v for c, v in self.cols.items()}
        out.update({"faults.win_faults": self.win, "faults.contacts": self.contacts,
                    "faults.quarantined": self.quar, "stale.clock": self.clock,
                    "stale.last_grant": self.last, "stale.cooldown": self.cool,
                    "stale.backoff": self.back, "stale.retry_left": self.left,
                    "step": self.step})
        return out


def _device_counters(torch, state):
    """The fault-armed state's counters, read back in one copy, as
    _Replay.counters names them."""
    led, fs, ss = state.ledger, state.faults, state.stale
    cols = torch.stack([getattr(led, c) for c in FAULT_COLUMNS]
                       + [fs.win_faults, fs.contacts, fs.quarantined.to(torch.int32),
                          ss.last_grant, ss.cooldown, ss.backoff, ss.retry_left]).cpu().tolist()
    names = ([f"ledger.{c}" for c in FAULT_COLUMNS]
             + ["faults.win_faults", "faults.contacts", "faults.quarantined", "stale.last_grant",
                "stale.cooldown", "stale.backoff", "stale.retry_left"])
    out = dict(zip(names, cols))
    out["faults.quarantined"] = [bool(v) for v in out["faults.quarantined"]]
    out["stale.clock"], out["step"] = int(ss.clock), int(state.step)
    return out


def _check_replay(torch, state, ms, replay, outcomes, what):
    got, want = _device_counters(torch, state), replay.counters()
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    check(not bad, f"{what}: device counters differ from the host replay: {bad}")
    for col, metric in (("refused", "refused"), ("dropped", "dropped"), ("faulted", "faulted"),
                        ("quarantined", "quarantined"), ("timed_out", "timed_out"),
                        ("retried", "retried")):
        check(ms[metric].cpu().tolist() == outcomes[col],
              f"{what}: the {metric} mask differs from the host replay")


def _trace(n_owners, K):
    """An explicit (owners, codes) trace of K rounds that reaches every
    ledger column under FAULTS_POLICY, FAULTS_RUNTIME and a cap of 4:
    owner 0 faults three times (quarantined) and comes back twice; owner 1
    drops, times out (a backoff of one round), is retried and then
    applies; owner 2 answers five times (the fifth refused); the other
    owners answer once or twice."""
    queues = {0: [F_NONFINITE, F_STALE, F_CORRUPT, F_OK, F_OK],
              1: [F_DROP, F_TIMEOUT, F_OK, F_OK], 2: [F_OK] * 5}
    rest = K - sum(len(q) for q in queues.values())
    for j in range(rest):
        queues.setdefault(3 + j % (n_owners - 3), []).append(F_OK)
    owners, codes = [], []
    while any(queues.values()):
        for i in sorted(queues):
            if queues[i]:
                owners.append(i)
                codes.append(queues[i].pop(0))
    return np.asarray(owners, np.int32), np.asarray(codes, np.int8)


def phase_faults(torch, dev, main_prof, cfg=None, n_owners=16, records=10_000, seq=128,
                 K=FAULTS_K, dispatches=1, max_group=ROWS_G):
    """Main's path (DENSE_124M, flat f32 bank, fused, batch 4 x seq 128, G =
    2, 16 owners) with the fault layer and the runtime armed:
    FaultPlan(FAULTS_PLAN), FaultPolicy(FAULTS_POLICY),
    StalenessPolicy(FAULTS_RUNTIME) and a LatencyPlan of 16 per-owner bases
    in 0.2 to 0.9 with jitter 0.3, K = 32 rounds a dispatch. The fault codes
    and latencies drawn on the card equal the port's CPU draw bit for bit.
    Each driver (sequential, then grouped with max_group=8) runs from a
    fresh state `dispatches` timed dispatches and one profiled, on the same
    sequences, batches and keys; after each: launches (K dp_round and K*G
    sqnorm; one dp_round and G sqnorm per group), the seven ledger columns,
    the FaultState and the StalenessState against the host replay, the
    outcome masks, and bank_checksums(bank) == the stored checksums over
    the whole bank. The two drivers' counters equal each other, and the
    reconciled tallies the device columns. Then one dispatch of an explicit
    code trace (`_trace`) on a fresh horizon-4 session reaches every ledger
    column. Returns {driver: profile}."""
    from repro_torch import random
    from repro_torch.configs import DENSE_124M
    from repro_torch.data import OwnerDataPipeline, synthetic_owner_shards
    from repro_torch.federation import (DataOwner, FaultPlan, FaultPolicy, Federation,
                                        FederationConfig, LatencyPlan, PrivatizerConfig,
                                        StalenessPolicy, bank_checksums, merge_timeout_codes,
                                        partition_conflict_free)
    from repro_torch.federation.faults import row_checksum
    from repro_torch.models import LM
    cfg = DENSE_124M if cfg is None else cfg
    batch, G = 4, 2
    lm = LM(cfg, remat=False)   # as examples/async_dp_llm.py builds it
    t0 = time.perf_counter()
    shards = synthetic_owner_shards(n_owners, records, seq, cfg.vocab, seed=0)
    pipe = OwnerDataPipeline(shards, batch, seed=0)
    base = np.random.default_rng(5).permutation(np.linspace(0.2, 0.9, n_owners)).tolist()
    plan, latency = FaultPlan(**FAULTS_PLAN), LatencyPlan(base=base, jitter=FAULTS_JITTER)
    policy, runtime = FaultPolicy(**FAULTS_POLICY), StalenessPolicy(**FAULTS_RUNTIME)

    def session(horizon=1000):
        fed = Federation([DataOwner(n=s, epsilon=1.0, xi=1.0) for s in pipe.owner_sizes],
                         FederationConfig.from_target_lr(0.05, n_owners=n_owners,
                                                         horizon=horizon, sigma=1e-2,
                                                         theta_max=100.0),
                         fault_policy=policy, staleness=runtime, device=dev)
        fed.make_step(lambda p, b: lm.loss(p, b)[0], pack_params=True,
                      privatizer=PrivatizerConfig(xi=1.0, granularity="microbatch",
                                                  n_microbatches=G, fused_kernel=True))
        return fed

    params = lm.init(seed=0, device=dev)
    n_disp = dispatches + 1                       # the last one profiled
    seqs = [pipe.schedule(K) for _ in range(n_disp)]
    data = [_torch_batches(torch, pipe.batches_for(o)) for o in seqs]
    keys = [random.PRNGKey(3000 + d, device=dev) for d in range(n_disp)]
    codes = []
    for d in range(n_disp):
        owners = torch.from_numpy(np.asarray(seqs[d]))
        c_dev, l_dev = plan.draw(keys[d], K), latency.draw(keys[d], owners.to(dev))
        kc = keys[d].cpu()
        c_cpu, l_cpu = plan.draw(kc, K), latency.draw(kc, owners)
        check(torch.equal(c_dev.cpu(), c_cpu) and torch.equal(l_dev.cpu(), l_cpu),
              f"dispatch {d}: the fault codes or latencies drawn on the card differ from "
              "the CPU draw")
        codes.append(merge_timeout_codes(c_dev, l_dev, runtime.deadline).cpu().numpy())
    tally = collections.Counter(int(c) for cs in codes for c in cs)
    print(f"[faults] {cfg.name}: {n_owners} owners, K={K} rounds a dispatch, set-up "
          f"{time.perf_counter() - t0:.1f} s; codes drawn on the card == the CPU draw bit for "
          f"bit (codes and latencies, {n_disp} dispatches); merged codes by value "
          f"{dict(sorted(tally.items()))}")

    def dispatch(fed, state, d, grouped, seq_d=None, data_d=None, codes_d=None):
        seq_d = seqs[d] if seq_d is None else seq_d
        before = _launches()
        if codes_d is None:
            state, ms = fed.run_rounds(state, data[d], seq_d, key=keys[d], faults=plan,
                                       latency=latency, owner_parallel=grouped,
                                       max_group=max_group)
        else:
            state, ms = fed.run_rounds(state, data_d, seq_d, key=keys[0], faults=codes_d)
        got = _diff(_launches(), before)
        n_groups = len(partition_conflict_free(seq_d, max_group)) if grouped else len(seq_d)
        want = {k: 0 for k in got}
        want.update(sqnorm=G * n_groups, dp_round=n_groups)
        check(got == want, f"launches {got} in one fault-armed dispatch of {n_groups} "
              f"groups, expected {want}")
        return state, ms, n_groups, got

    stats, final = {}, {}
    for driver in ("sequential", "grouped"):
        grouped = driver == "grouped"
        fed = session()
        state = fed.init_state(params)
        replay = _Replay([1000] * n_owners, FAULTS_POLICY, FAULTS_RUNTIME)
        _sync(torch, dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        per_round, sizes = [], []
        for d in range(n_disp):
            if d < dispatches:
                _sync(torch, dev)
                t1 = time.perf_counter()
                state, ms, n_groups, got = dispatch(fed, state, d, grouped)
                _sync(torch, dev)
                dt = (time.perf_counter() - t1) * 1e3
                per_round.append(dt / K)
                print(f"[faults] {driver}, dispatch {d}: {n_groups} groups, {dt:.1f} ms "
                      f"({dt / K:.2f} ms/round), launches {got}")
            else:
                # the device alone: 32 sequential rounds are 137k kernels
                (state, ms, n_groups, got), busy, groups, per_round_launches = _profiled(
                    torch, dev, lambda: dispatch(fed, state, d, grouped), K, cpu_ops=False)
            sizes.append(K / n_groups)
            outcomes = replay.run(seqs[d], codes[d])
            _check_replay(torch, state, ms, replay, outcomes, f"{driver} dispatch {d}")
            check(torch.equal(bank_checksums(state.bank), state.faults.checksum),
                  f"{driver} dispatch {d}: the stored checksums differ from the bank's")
        check(_state_finite(torch, state), f"{driver}: non-finite state")
        final[driver] = _device_counters(torch, state)
        ledger = fed.reconcile(state)
        check(all([r[c] for r in ledger.values()] == final[driver][f"ledger.{c}"]
                  for c in FAULT_COLUMNS[1:])
              and [r["responses"] for r in ledger.values()] == final[driver]["ledger.spent"],
              f"{driver}: the reconciled tallies differ from the device columns")
        median = statistics.median(per_round[1:] or per_round)
        peak = _peak_gb(torch, dev)
        stats[driver] = dict(busy=busy, median=median, groups=groups,
                             launches=per_round_launches, peak=peak,
                             mean_group=statistics.mean(sizes))
        totals = {c: sum(final[driver][f"ledger.{c}"]) for c in FAULT_COLUMNS}
        print(f"[faults] {driver}: ledger totals {totals}, quarantined owners "
              f"{[i for i, q in enumerate(final[driver]['faults.quarantined']) if q]}, "
              f"step {final[driver]['step']} of {n_disp * K} rounds == the host replay; "
              f"bank_checksums == stored after every dispatch; reconcile == device columns")
        print(f"[faults] {driver} against main (K=8, fault-free) in this call, per round: "
              f"wall (median) {median:.2f} vs {main_prof['median']:.2f} ms; device busy "
              f"{busy:.3f} vs {main_prof['busy']:.3f} ms; device kernels "
              f"{per_round_launches:.0f} vs {main_prof['launches']:.0f}; idle share "
              f"{1 - busy / median:.1%} vs {1 - main_prof['busy'] / main_prof['median']:.1%}; "
              f"mean group {statistics.mean(sizes):.2f} members; peak memory {peak:.2f} vs "
              f"{main_prof['peak']:.2f} GB; by group, faults minus main: "
              + ", ".join(f"{g} {groups.get(g, 0.0) - main_prof['groups'].get(g, 0.0):+.3f}"
                          for g in sorted(set(groups) | set(main_prof["groups"]))))
        if dev.type == "cuda" and driver == "sequential":
            # a fault-armed round takes two row checksums (before and after
            # its write): one beside the time to read the row once
            row = torch.zeros(1, dtype=torch.int64, device=dev)
            cs_ms = _steady_ms(torch, "row_checksum of one f32 bank row",
                               lambda: row_checksum(state.bank, row), 5)
            print(f"[faults] row_checksum {cs_ms:.4f} ms a row against "
                  f"{4 * state.bank.shape[1] / HBM_BYTES_PER_S * 1e3:.4f} ms to read it once")
        del state, fed
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    check(final["sequential"] == final["grouped"],
          "the grouped driver's counters differ from the sequential driver's")
    # every ledger column from an explicit trace, on a fresh horizon-4 session
    fed = session(horizon=4)
    state = fed.init_state(params)
    t_owners, t_codes = _trace(n_owners, K)
    state, ms, _, got = dispatch(fed, state, 0, False, seq_d=t_owners,
                                 data_d=_torch_batches(torch, pipe.batches_for(t_owners)),
                                 codes_d=t_codes)
    replay = _Replay([4] * n_owners, FAULTS_POLICY, FAULTS_RUNTIME)
    _check_replay(torch, state, ms, replay, replay.run(t_owners, t_codes), "the code trace")
    check(torch.equal(bank_checksums(state.bank), state.faults.checksum),
          "the code trace: the stored checksums differ from the bank's")
    totals = {c: sum(replay.cols[c]) for c in FAULT_COLUMNS}
    check(all(totals.values()), f"the code trace left a ledger column at 0: {totals}")
    ledger = fed.reconcile(state)
    check({c: sum(r[c] for r in ledger.values()) for c in FAULT_COLUMNS[1:]}
          == {c: totals[c] for c in FAULT_COLUMNS[1:]}, "the code trace's reconciled ledger")
    print(f"[faults] explicit code trace (horizon 4): every column hit {totals}, quarantined "
          f"owners {[i for i, q in enumerate(replay.quar) if q]}; == host replay, launches "
          f"{got}; the phase took {time.perf_counter() - t0:.1f} s")
    del state, fed
    return stats


def _first_layers(tree, n):
    """The first n layers of a tree of stacked (L, ...) leaves, as views."""
    if isinstance(tree, dict):
        return {k: _first_layers(v, n) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(None if t is None else t[:n] for t in tree))
    return tree[:n]


# prefill logits of the two attention backends: f32 throughout, and the two
# paths differ only in summation order (about 1e-6 relative per attention
# application); 1e-3 on logits of about 1 leaves room for 54 layers to grow
# that, while a wrong mask or a skipped tile moves them by far more
PREFILL_TOL = 1e-3
# decode against the forward, the bound of the reference's own test
# (tests/test_arch_smoke.py:100)
DECODE_TOL = 5e-3


def phase_serve(torch, dev, cfg=None, batch=PREFILL_B, seq=PREFILL_S, ragged=4000,
                decode_layers=6, decode_seq=320, serve_batch=2, prompt_len=16, gen=32):
    """zamba2-2.7b served at full width (f32, random weights from a seed):
    prefill with the flash kernel (attn_backend "pallas") and the SSD scan
    kernel, three timed (the first warms up) and one profiled, with the
    launch counters set to 0 just before and read just after; the same
    prefill with attn_backend "jnp" and a ragged one, each against the
    kernel path's logits; decode against the forward on the first
    `decode_layers` layers; greedy serving at full depth. Returns the
    launches of the four kernel prefills."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import prefill_logits
    from repro_torch.models import LM
    cfg = get_config("zamba2-2.7b") if cfg is None else cfg
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = LM(cfg, attn_backend="pallas")
    # drawn on the card: on the host the draw takes tens of seconds
    params = lm.init(seed=0, device=dev, generator_device=dev if on_card else None)
    n_params = sum(leaf.numel() for leaf in _leaves(params))
    check(n_params == cfg.param_count(), f"{n_params} parameters, expected {cfg.param_count()}")
    _sync(torch, dev)
    print(f"[serve] {cfg.name}: {n_params:,} parameters ({n_params * 4 / 1e9:.2f} GB f32), "
          f"{cfg.n_layers} Mamba2 layers, the shared attention block after every "
          f"{cfg.attn_every}; random weights from seed 0, drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    n_apps = cfg.n_layers // cfg.attn_every
    gen_t = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (batch, seq), generator=gen_t, dtype=torch.int32).to(dev)
    zero = {k: 0 for k in FED_KERNELS + MODEL_KERNELS}
    per_prefill = dict(zero, flash_attention=n_apps, ssd_chunk_scan=cfg.n_layers)

    def prefill(model, tokens):
        with torch.no_grad():
            return prefill_logits(model, params, {"tokens": tokens})

    # the main path: kernel prefills, counted from 0
    logits, _, launches = _prefill_runs(
        torch, dev, "serve", lambda p, b: prefill_logits(lm, p, b), params, {"tokens": toks},
        per_prefill, top=12)
    check(tuple(logits.shape) == (batch, cfg.vocab), "prefill logits are not (B, V)")

    # the same prefill through the blockwise attention (no flash launch)
    _reset_launches()
    plain_logits = prefill(LM(cfg, attn_backend="jnp"), toks)
    got = _launches()
    check(got == dict(per_prefill, flash_attention=0), f"the 'jnp' prefill launched {got}")
    e = float((logits - plain_logits).abs().max())
    check(e <= PREFILL_TOL, f"prefill logits: 'pallas' and 'jnp' differ by {e:.3e}")
    print(f"[serve] prefill logits, 'pallas' against 'jnp': max difference {e:.3e} (bound "
          f"{PREFILL_TOL}; max |logit| {float(logits.abs().max()):.3f})")
    del plain_logits

    # a ragged prefill, both backends
    short = toks[:, :ragged]
    _reset_launches()
    ragged_k = prefill(lm, short)
    ragged_j = prefill(LM(cfg, attn_backend="jnp"), short)
    got = _launches()
    check(got == dict(per_prefill, flash_attention=n_apps, ssd_chunk_scan=2 * cfg.n_layers),
          f"the ragged prefills launched {got}")
    e = float((ragged_k - ragged_j).abs().max())
    check(e <= PREFILL_TOL and bool(torch.isfinite(ragged_k).all()),
          f"ragged prefill logits: 'pallas' and 'jnp' differ by {e:.3e}")
    print(f"[serve] ragged prefill S {ragged}: 'pallas' against 'jnp' max difference {e:.3e}")
    del ragged_k, ragged_j

    # decode against the forward at full width, `decode_layers` deep
    cut = dataclasses.replace(cfg, n_layers=decode_layers)
    lm_cut = LM(cut, attn_backend="pallas")
    p_cut = dict(params, blocks=_first_layers(params["blocks"], decode_layers))
    dtoks = toks[:, :decode_seq]
    _reset_launches()
    with torch.no_grad():
        full = torch.einsum("bsd,dv->bsv", lm_cut.forward(p_cut, {"tokens": dtoks}),
                            lm_cut._unembed(p_cut))
        got = _launches()
        cache = lm_cut.init_cache(batch, decode_seq, dtype=torch.float32, device=dev)
        err = 0.0
        for t in range(decode_seq):
            lg, cache = lm_cut.decode_step(p_cut, cache, dtoks[:, t:t + 1], t)
            err = max(err, float((lg[:, 0] - full[:, t]).abs().max()))
    check(got == dict(zero, flash_attention=decode_layers // cfg.attn_every,
                      ssd_chunk_scan=decode_layers), f"the {decode_layers}-layer forward "
          f"launched {got}")
    check(_launches() == got, "decode launched a kernel")
    check(err <= DECODE_TOL, f"decode differs from the forward by {err:.3e}")
    print(f"[serve] decode against the forward, {decode_layers} layers at full width, S "
          f"{decode_seq} ({-(-decode_seq // cfg.ssm.chunk)} chunks, the last ragged): max "
          f"|logit difference| {err:.3e} over every position (bound {DECODE_TOL})")
    del full, cache, p_cut

    # greedy serving at full depth; the decode path reaches no kernel
    prompt = torch.randint(0, cfg.vocab, (serve_batch, prompt_len), generator=gen_t,
                           dtype=torch.int32).to(dev)
    _greedy(torch, dev, "serve", lm, params,
            lm.init_cache(serve_batch, prompt_len + gen, dtype=torch.float32, device=dev),
            prompt, gen)
    del params, logits
    if on_card:
        torch.cuda.empty_cache()
    return launches


# phase train: zamba2-2.7b at full width cut to the first 12 of its 54
# Mamba2 layers (two applications of the shared block): P = 668,655,424
TRAIN_LAYERS = 12


def phase_train(torch, dev, cfg=None, n_owners=4, seq=1024, **kw):
    """Training the hybrid on the card: phase_main's flat fused engine (batch
    4, G = 2 microbatches, K = 8) over zamba2-2.7b at full width and
    TRAIN_LAYERS deep, 4 owners on an f32 bank, S 1024 (four SSD chunks, so
    the backward runs through the recurrence between chunks). Each
    microbatch runs one ssd_chunk_scan and one ssd_chunk_scan_bwd per layer
    and no flash_attention (one kv chunk: plain attention). Returns
    phase_main's result."""
    import dataclasses
    from repro_torch.configs import get_config
    if cfg is None:
        cfg = dataclasses.replace(get_config("zamba2-2.7b"), n_layers=TRAIN_LAYERS)
    kw.setdefault("cpu_ops", False)
    return phase_main(torch, dev, cfg=cfg, n_owners=n_owners, seq=seq, tag="train", **kw)


# the paper's Section 5 at its own size (benchmarks/bench_collaboration.py's
# grid): p = 10, 10,000 records per owner, T = 1000, 100 replicas a session
CONVEX_NS = (2, 5, 10, 25, 50)
CONVEX_EPS = (1.0, 2.5, 10.0)
CONVEX_CFG = dict(horizon=1000, rho=1.0, sigma=2e-5)
CONVEX_PROBLEM = dict(reg=1e-5, theta_max=2.0)
# the card against the port's CPU run on the same keys: owner sequences bit
# for bit; theta_L, the bank and psi through T steps of f32 products summed
# in other orders (cuBLAS against the CPU's) and Laplace draws whose log1p
# may differ by an ulp
CONVEX_RTOL, CONVEX_ATOL = 1e-4, 1e-5


def _convex_problem(dataset, n_owners, n_per, dev, seed=2, heterogeneity=0.3):
    from repro_torch.data import owner_shards
    from repro_torch.federation import federate_problem
    shards = owner_shards(dataset, [n_per] * n_owners, seed=seed, heterogeneity=heterogeneity)
    prob, owners = federate_problem(shards, 1.0, device=dev, **CONVEX_PROBLEM)
    return shards, prob, owners


def _isolated_psi(torch, prob, shards):
    """psi, on the global problem, of owner 0's exact non-private model
    trained alone (benchmarks/bench_collaboration.py's psi_iso)."""
    from repro_torch.federation import relative_fitness
    X0, y0 = shards[0]
    n, p = X0.shape
    theta = np.linalg.solve(X0.T @ X0 / n + CONVEX_PROBLEM["reg"] * np.eye(p), X0.T @ y0 / n)
    return float(relative_fitness(prob, torch.tensor(theta, dtype=torch.float32,
                                                     device=prob.G.device)))


def _convex_session(torch, dev, fed, key, prob, runs):
    """One session of `runs` replicas timed by the host clock around a
    synchronize; returns (trace, ms)."""
    _sync(torch, dev)
    t0 = time.perf_counter()
    trace = fed.run(key, prob, n_runs=runs)
    _sync(torch, dev)
    return trace, (time.perf_counter() - t0) * 1e3


def _convex_cross_device(torch, dev, n_owners, n_per, runs):
    """The N = n_owners cell on the card and on the CPU, same keys, under
    every schedule: owner sequences bit for bit, theta_L, bank and psi
    within CONVEX_RTOL and CONVEX_ATOL."""
    from repro_torch import random
    from repro_torch.data import owner_shards
    from repro_torch.federation import (AvailabilityTraceSchedule, Federation,
                                        FederationConfig, PoissonSchedule, UniformSchedule,
                                        federate_problem)
    cpu = torch.device("cpu")
    shards = owner_shards("lending", [n_per] * n_owners, seed=2)
    # windows of 0.2 of a 12-hour period, staggered over [0.5, 1.2): some wrap
    # round the period's end, and phases in [0.4, 0.5) find nobody (the
    # everyone-available fallback)
    windows = tuple(((0.7 * i / n_owners + 0.5) % 1.0, (0.7 * i / n_owners + 0.7) % 1.0)
                    for i in range(n_owners))
    trace = tuple(np.random.default_rng(5).integers(0, n_owners, 777).tolist())
    schedules = {"uniform": UniformSchedule(), "poisson": PoissonSchedule(rate=0.5),
                 "availability": AvailabilityTraceSchedule(windows=windows, period=12.0),
                 "replay": AvailabilityTraceSchedule(windows=windows, period=12.0,
                                                     trace=trace)}
    sides = {d: federate_problem(shards, 1.0, device=d, **CONVEX_PROBLEM) for d in (dev, cpu)}
    for name, sched in schedules.items():
        out = {}
        for d, (prob, owners) in sides.items():
            fed = Federation(owners, FederationConfig(**CONVEX_CFG), schedule=sched, device=d)
            t0 = time.perf_counter()
            out[d.type] = fed.run(random.PRNGKey(0, device=d), prob, n_runs=runs)
            _sync(torch, d)
            out[d.type + "_ms"] = (time.perf_counter() - t0) * 1e3
        card, host = out[dev.type], out["cpu"]
        check(torch.equal(card.owners_seq.cpu(), host.owners_seq),
              f"{name}: the card's owner sequences differ from the CPU's")
        errs = {}
        for f in ("theta_L", "theta_bank", "psi"):
            a, b = getattr(card, f).cpu(), getattr(host, f)
            errs[f] = float((a - b).abs().max())
            check(torch.allclose(a, b, rtol=CONVEX_RTOL, atol=CONVEX_ATOL),
                  f"{name}: {f} on the card differs from the CPU's by {errs[f]}")
        seq = host.owners_seq.numpy()
        print(f"[convex] card == CPU, {name} schedule, N={n_owners}, {runs} replicas: "
              f"owner sequences equal bit for bit ({seq.size} draws, owner counts "
              f"{np.bincount(seq.reshape(-1), minlength=n_owners).min()} to "
              f"{np.bincount(seq.reshape(-1), minlength=n_owners).max()}); max |diff| "
              + ", ".join(f"{f} {e:.3e}" for f, e in errs.items())
              + f" (bound {CONVEX_ATOL} + {CONVEX_RTOL} x); CPU {out['cpu_ms']:.0f} ms, card "
              f"{out[dev.type + '_ms']:.0f} ms")


def _convex_accounting(torch, dev, n_owners=5, n_per=10_000, runs=100, cap_slack=1.0):
    """The ledger, the cap, the refused step and the raising cases."""
    from repro_torch import random
    from repro_torch.federation import (Federation, FederationConfig, PaperMechanism,
                                        StrictMechanism, convex, stack_gram)
    T = CONVEX_CFG["horizon"]
    _, prob, owners = _convex_problem("lending", n_owners, n_per, dev)
    cfg = FederationConfig(**CONVEX_CFG)
    key = random.PRNGKey(1, device=dev)
    fed = Federation(owners, cfg, device=dev)
    trace = fed.run(key, prob)
    counts = np.bincount(trace.owners_seq.cpu().numpy(), minlength=n_owners)
    led = fed.ledger()
    check([led[i]["responses"] for i in range(n_owners)] == counts.tolist()
          and all(r["refused"] == 0 for r in led.values()),
          "the ledgered run's ledger differs from the bincount of its owners")
    try:
        fed.run(key, prob)  # dpcheck: ignore[DPC105]
        check(False, "a second ledgered run did not raise")
    except RuntimeError:
        pass
    # per_owner_rounds at a cap that bites: no owner passes it
    capped = Federation(owners, cfg, mechanism="per_owner_rounds", cap_slack=cap_slack,
                        device=dev)
    cap = capped.mechanism.cap
    trace = capped.run(key, prob)  # dpcheck: ignore[DPC105]
    counts = np.bincount(trace.owners_seq.cpu().numpy(), minlength=n_owners)
    led = capped.ledger()
    check([led[i]["responses"] for i in range(n_owners)] == np.minimum(counts, cap).tolist()
          and [led[i]["refused"] for i in range(n_owners)]
          == np.maximum(counts - cap, 0).tolist() and max(counts) > cap,
          f"per_owner_rounds ledger {led} for counts {counts.tolist()} and cap {cap}")
    # every refused step of `runs` capped replicas leaves theta_L and the bank
    # bit-equal (one read back, after the loop)
    A, b, n_i = stack_gram([o.gram for o in owners])
    keys = random.split(random.PRNGKey(2, device=dev), runs)
    seq_dev, noise = convex._draws(keys, n_owners, A.shape[1], T,
                                   capped.mechanism.scales(p=A.shape[1], device=dev), None)
    seq = seq_dev.cpu().numpy()
    refused, seen, rows = np.zeros(seq.shape, bool), np.zeros((runs, n_owners), int), \
        np.arange(runs)
    for k in range(T):
        refused[:, k] = seen[rows, seq[:, k]] >= cap
        seen[rows, seq[:, k]] += 1
    refused_dev = torch.from_numpy(refused).to(dev)
    theta_L = torch.zeros((runs, A.shape[1]), device=dev)
    bank = torch.zeros((runs, n_owners, A.shape[1]), device=dev)
    cnt = torch.zeros((runs, n_owners), dtype=torch.int32, device=dev)
    bad = torch.zeros((), dtype=torch.bool, device=dev)
    prev_L, prev_bank = theta_L, bank.clone()
    for k, (theta_L, bank) in enumerate(convex._steps(
            prob, A, b, n_i, seq_dev, noise, theta_L, bank, cnt, rho=cfg.rho,
            sigma=cfg.sigma, lr_scale=1.0, cap=cap)):
        same = (theta_L == prev_L).all(-1) & (bank == prev_bank).flatten(1).all(-1)
        bad |= (refused_dev[:, k] & ~same).any()
        prev_L, prev_bank = theta_L, bank.clone()
    check(not bool(bad), "a refused step changed theta_L or the bank")
    check(cnt.cpu().numpy().tolist() == np.minimum(seen, cap).tolist(),
          "the engine's response counts differ from the host's")
    print(f"[convex] per_owner_rounds (cap {cap} of T={T}, N={n_owners}): ledger == host "
          f"({counts.tolist()} drawn); {int(refused.sum())} refused steps over {runs} "
          f"replicas, each leaving theta_L and the bank bit-equal")
    for what, call in (
            ("run_sync under per_owner_rounds",
             lambda: Federation(owners, cfg, mechanism="per_owner_rounds", strategy="sync",  # dpcheck: ignore[DPC105]
                                device=dev).run_sync(key, prob, lr=0.4)),
            ("run under the tree",
             lambda: Federation(owners, cfg, mechanism="tree", tree_depth=4,  # dpcheck: ignore[DPC105]
                                device=dev).run(key, prob)),
            ("run_sync under the tree",
             lambda: Federation(owners, cfg, mechanism="tree", strategy="sync",  # dpcheck: ignore[DPC105]
                                device=dev).run_sync(key, prob, lr=0.4))):
        try:
            call()
            check(False, f"{what} did not raise")
        except ValueError:
            pass
    paper = PaperMechanism(owners, cfg).scales(device=dev)
    strict = StrictMechanism(owners, cfg).scales(p=10, device=dev)
    check(torch.allclose(strict, paper * math.sqrt(10), rtol=1e-6, atol=0),
          "strict scales differ from paper x sqrt(10)")
    print("[convex] a second ledgered run, run_sync under per_owner_rounds and both engines "
          "under the tree raise; strict scales == paper x sqrt(10)")


def _convex_sync_timing(torch, dev, n_owners=5, n_per=50_000, horizon=800, runs=10):
    """benchmarks/bench_async_vs_sync.py's setting: the ledgered run_sync
    charges every owner T; then run, the capped run and run_sync, `runs`
    replicas each, timed in turns (host clock around a synchronize)."""
    import dataclasses
    from repro_torch import random
    from repro_torch.federation import Federation, FederationConfig
    _, prob, owners = _convex_problem("lending", n_owners, n_per, dev, seed=4,
                                      heterogeneity=0.0)
    cfg = FederationConfig(**dict(CONVEX_CFG, horizon=horizon))
    fed = Federation(owners, cfg, strategy="sync", device=dev)
    trace = fed.run_sync(random.PRNGKey(100, device=dev), prob, lr=0.4)
    led = fed.ledger()
    check(all(r["responses"] == horizon and r["refused"] == 0 for r in led.values()),
          f"run_sync charged {led}")
    check(bool(torch.isfinite(trace.psi).all()), "run_sync: non-finite psi")
    out = {}
    for name, make, call in (
            ("async", lambda: Federation(owners, cfg, device=dev),
             lambda f: f.run(random.PRNGKey(0, device=dev), prob, n_runs=runs)),
            ("async capped", lambda: Federation(owners, cfg, mechanism="per_owner_rounds",
                                                device=dev),
             lambda f: f.run(random.PRNGKey(0, device=dev), prob, n_runs=runs)),
            ("sync", lambda: Federation(owners, cfg, strategy="sync", device=dev),
             lambda f: f.run_sync(random.PRNGKey(100, device=dev), prob, lr=0.4,
                                  n_runs=runs))):
        f = make()
        _sync(torch, dev)
        t0 = time.perf_counter()
        tr = call(f)
        _sync(torch, dev)
        out[name] = ((time.perf_counter() - t0) * 1e3, float(tr.psi[:, -1].mean()))
    print(f"[convex] async vs sync (N={n_owners} x {n_per} records, eps 1, T={horizon}, "
          f"{runs} replicas, lr 0.4): ledgered run_sync charged every owner {horizon}; "
          + "; ".join(f"{k} {ms:.1f} ms per session, mean final psi {psi:.5f}"
                      for k, (ms, psi) in out.items()))
    return out


def phase_convex(torch, dev, ns=CONVEX_NS, eps_grid=CONVEX_EPS, n_per=10_000, runs=100,
                 datasets=("lending", "health"), **sub):
    """Algorithm 1 at the paper's size through Federation.run on the card:
    for each dataset, one profiled session (N = ns[-1], eps_grid[0]: device
    kernels per step and device busy time, which depend on R, T and p, not
    on N or eps), then N owners x eps, one timed session of `runs`
    replicas per cell, its idle share against the profiled busy time;
    psi's median at k = 10, 500 and T; collab_wins against the isolated
    owner-0 model; then the fitted (c1bar, c2bar) of eq. (11) and
    min_owners_for_benefit (Fig. 6's forecast). Then the card against the
    CPU at N = ns[-1], the accounting checks and async vs sync. `sub`
    passes sizes to the last two (for a rehearsal on the CPU)."""
    from repro_torch import random
    from repro_torch.core import budget_sum, fit_constants, min_owners_for_benefit
    from repro_torch.federation import Federation, FederationConfig, with_budgets
    T = CONVEX_CFG["horizon"]
    at = [k for k in (10, 500, T) if k <= T]
    cfg = FederationConfig(**CONVEX_CFG)
    # one session first warms the allocator and cuBLAS's small products
    _, prob, owners = _convex_problem("lending", ns[0], n_per, dev)
    Federation(owners, cfg, device=dev).run(random.PRNGKey(0, device=dev), prob, n_runs=runs)
    cells = []
    for dataset in datasets:
        obs, iso = [], {}
        _, prob, owners = _convex_problem(dataset, ns[-1], n_per, dev)
        fed = Federation(with_budgets(owners, eps_grid[0]), cfg, device=dev)
        _, wall, per_name, calls = _device_profile(
            torch, dev, lambda: fed.run(random.PRNGKey(0, device=dev), prob, n_runs=runs),
            cpu_ops=False)
        busy, kernels = sum(per_name.values()), sum(calls.values())
        print(f"[convex] {dataset}: one profiled session (N={ns[-1]}, eps {eps_grid[0]}, "
              f"{runs} replicas x T={T}): {kernels} device kernels ({kernels / T:.1f} per "
              f"step), device busy {busy:.2f} ms, wall {wall:.1f} ms with the profiler on; "
              f"the kernels " + ", ".join(f"{n[:40]} {calls[n]}x {ms:.2f} ms"
                                          for n, ms in per_name.most_common(4)))
        for N in ns:
            shards, prob, owners = _convex_problem(dataset, N, n_per, dev)
            iso[N] = _isolated_psi(torch, prob, shards)
            for eps in eps_grid:
                fed = Federation(with_budgets(owners, eps), cfg, device=dev)
                trace, ms = _convex_session(torch, dev, fed, random.PRNGKey(0, device=dev),
                                            prob, runs)
                psi = trace.psi.cpu().numpy()
                check(psi.shape == (runs, T) and np.isfinite(psi).all() and psi.min() > -1e-4,
                      f"{dataset} N={N} eps={eps}: psi out of range")
                check(float(trace.theta_bank.abs().max()) <= np.float32(prob.theta_max),
                      "a model left Theta")
                med = np.median(psi, axis=0)
                final = float(psi[:, -1].mean())
                wins = final < iso[N]
                obs.append((N, eps, final))
                cells.append(dict(dataset=dataset, N=N, eps=eps, ms=ms, busy=busy,
                                  kernels_per_step=kernels / T, final=final, wins=wins))
                print(f"[convex] {dataset} N={N:2d} eps={eps:4.1f}: {ms:8.1f} ms per session "
                      f"({runs} replicas x T={T}; idle {1 - busy / ms:.1%} against the "
                      f"profiled {busy:.1f} ms); psi median "
                      + " ".join(f"k={k} {med[k - 1]:.5f}" for k in at)
                      + f"; mean final psi {final:.5f} vs isolated owner-0 "
                      f"{iso[N]:.5f}: collab_wins={int(wins)}")
        ns_arr = np.array([N * n_per for N, _, _ in obs], float)
        sums = np.array([budget_sum([e] * N) for N, e, _ in obs])
        c1, c2 = fit_constants(ns_arr, sums, np.array([o for *_, o in obs]))
        pilot = ns[min(1, len(ns) - 1)]
        forecast = {e: min_owners_for_benefit(iso[pilot], n_per, e, c1, c2) for e in eps_grid}
        print(f"[convex] {dataset}: eq. (11) fitted to the {len(obs)} cells: c1bar {c1:.6g}, "
              f"c2bar {c2:.6g}; Fig. 6's forecast against the isolated owner-0 psi "
              f"{iso[pilot]:.5f} of the N={pilot} problem, min owners for collaboration to "
              f"win: " + ", ".join(f"eps {e}: {n}" for e, n in forecast.items()))
    ms = [c["ms"] for c in cells]
    print(f"[convex] {len(cells)} cells: {statistics.median(ms):.1f} ms per session "
          f"(median; {min(ms):.1f} to {max(ms):.1f}), "
          f"{statistics.median(c['kernels_per_step'] for c in cells):.1f} device kernels per "
          f"step, idle {statistics.median(1 - c['busy'] / c['ms'] for c in cells):.1%} "
          f"(median); the headline, N > 10 at eps >= 1 beats the isolated model: "
          f"{sum(c['wins'] for c in cells if c['N'] > 10)} of "
          f"{sum(c['N'] > 10 for c in cells)} such cells")
    _convex_cross_device(torch, dev, ns[-1], n_per, runs)
    _convex_accounting(torch, dev, **sub.get("accounting", {}))
    _convex_sync_timing(torch, dev, **sub.get("sync", {}))
    return cells


SYNC_LR = 0.05


def phase_sync(torch, dev, cfg=None, n_owners=16, records=10_000, seq=128, rounds=2):
    """The deep synchronous baseline at full width: DENSE_124M, every owner
    privatizing its batch (4 x seq, G = 2 microbatches) each round with the
    fused privatizer, through Federation(strategy="sync").make_step and
    sync_round; `rounds` timed and one profiled, with the launch counters
    set to 0 just before and read just after each. Then the profiled round
    again with fused_kernel=False from the same params, batches and key; and
    a horizon-1 federation whose second round refuses every owner. Returns
    the launches of the fused rounds."""
    from repro_torch import random
    from repro_torch.configs import DENSE_124M
    from repro_torch.data import OwnerDataPipeline, synthetic_owner_shards
    from repro_torch.federation import (DataOwner, Federation, FederationConfig,
                                        PrivatizerConfig)
    from repro_torch.models import LM
    cfg = DENSE_124M if cfg is None else cfg
    batch, G = 4, 2
    lm = LM(cfg, remat=False)   # as examples/async_dp_llm.py builds it

    def loss_fn(p, b):
        return lm.loss(p, b)[0]

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    shards = synthetic_owner_shards(n_owners, records, seq, cfg.vocab, seed=0)
    pipe = OwnerDataPipeline(shards, batch, seed=0)
    owners = [DataOwner(n=s, epsilon=1.0, xi=1.0) for s in pipe.owner_sizes]
    everyone = np.arange(n_owners)

    def federation(fused, horizon=1000, noiseless=False):
        fed = Federation(owners, FederationConfig(horizon=horizon, sigma=1e-2, theta_max=100.0,
                                                  noiseless=noiseless),
                         strategy="sync", device=dev)
        fed.make_step(loss_fn, lr=SYNC_LR, privatizer=PrivatizerConfig(
            xi=1.0, granularity="microbatch", n_microbatches=G, fused_kernel=fused))
        return fed

    fed = federation(True)
    params = lm.init(seed=0, device=dev)
    n_leaves = len(_leaves(params))
    expected = dict.fromkeys(_launches(), 0)
    expected.update(sqnorm=n_owners * G * n_leaves, scale_noise=n_owners * n_leaves)
    held_out = np.random.default_rng(99).integers(0, cfg.vocab, (batch, seq), dtype=np.int32)
    eval_batch = {k: v.to(dev) for k, v in _torch_batches(
        torch, {"tokens": held_out, "labels": np.roll(held_out, -1, axis=1)}).items()}
    with torch.no_grad():
        loss0 = float(loss_fn(params, eval_batch))
    _reset_launches()
    total = dict.fromkeys(expected, 0)

    def one_round(fed, params, batches, key, want):
        before = _launches()
        out = fed.sync_round(params, batches, key)
        got = _diff(_launches(), before)
        check(got == want, f"one sync round launched {got}, expected {want}")
        for k, v in got.items():
            total[k] += v
        return out

    key = random.PRNGKey(0, device=dev)
    per_round = []
    for r in range(rounds):
        key, sub = random.split(key)
        batches = _torch_batches(torch, pipe.batches_for(everyone))
        _sync(torch, dev)
        t0 = time.perf_counter()
        params = one_round(fed, params, batches, sub, expected)
        _sync(torch, dev)
        per_round.append((time.perf_counter() - t0) * 1e3)
    median = statistics.median(per_round)
    key, sub = random.split(key)
    batches = _torch_batches(torch, pipe.batches_for(everyone))
    before_prof = params
    params, wall, per_name, calls = _device_profile(
        torch, dev, lambda: one_round(fed, before_prof, batches, sub, expected), cpu_ops=False)
    busy, kernels = sum(per_name.values()), sum(calls.values())
    groups = collections.Counter()
    for name, ms in per_name.items():
        groups[_kernel_group(name)] += ms
    print(f"[sync] {cfg.name}: {n_owners} owners x {records} records, batch {batch} x seq "
          f"{seq}, G={G}, fused privatizer: {rounds} rounds "
          f"{', '.join(f'{m:.1f}' for m in per_round)} ms (median {median:.1f} ms per round); profiled round: device busy {busy:.2f} ms, "
          f"{kernels} device kernels, idle {1 - busy / median:.1%} of the median round; by "
          f"group " + ", ".join(f"{g} {ms:.2f}" for g, ms in groups.most_common())
          + f"; launches per round {expected['sqnorm']} sqnorm, {expected['scale_noise']} "
          f"scale_noise; peak memory {_peak_gb(torch, dev):.2f} GB")
    check(all(_finite(torch, leaf) for leaf in _leaves(params)), "non-finite params")
    led = fed.ledger()
    check(all(r["responses"] == rounds + 1 and r["refused"] == 0 for r in led.values()),
          f"the sync ledger {led} after {rounds + 1} rounds")
    # the profiled round's params, batches and key through both privatizers
    # at noise scale 0: the two map the same bits to Laplace draws by other
    # inverse CDFs (the kernels' on the top 24 bits, random.laplace jax's),
    # so with noise they are two lawful draws; without it both compute the
    # same clipped mean, the clip norms summed in other orders
    quiet = dict.fromkeys(expected, 0)
    fused = one_round(federation(True, noiseless=True), before_prof, batches, sub, expected)  # dpcheck: ignore[DPC105]
    unfused = one_round(federation(False, noiseless=True), before_prof, batches, sub, quiet)  # dpcheck: ignore[DPC105]
    worst = 0.0
    for a, b in zip(_leaves(fused), _leaves(unfused)):
        worst = max(worst, float((a - b).abs().max()))
        check(torch.allclose(a, b, rtol=1e-4, atol=1e-6),
              "the fused and unfused sync rounds disagree")
    del fused
    # a horizon of one round: the second round refuses every owner
    short = federation(True, horizon=1)
    p1 = one_round(short, params, batches, sub, expected)  # dpcheck: ignore[DPC105]
    p2 = one_round(short, p1, batches, sub, quiet)  # dpcheck: ignore[DPC105]
    check(p2 is p1 and all(r["responses"] == 1 and r["refused"] == 1
                           for r in short.ledger().values()),
          "a fully refused sync round changed the params or the ledger")
    with torch.no_grad():
        loss1 = float(loss_fn(params, eval_batch))
    check(math.isfinite(loss1), "non-finite loss after the sync rounds")
    print(f"[sync] at noise scale 0, fused == unfused within rtol 1e-4, atol 1e-6 (max "
          f"|diff| {worst:.3e}); "
          f"ledger {rounds + 1} responses per owner; a fully refused round returns its "
          f"params and launches nothing; central loss {loss0:.4f} -> {loss1:.4f}")
    del params, unfused, p1, p2, before_prof
    return total, dict(median=median, busy=busy, kernels=kernels)


# one microbatch's loss gradient, scan kernels against the plain scan on
# the card: f32 in both, the scan's outputs 5e-5 of their largest value
# apart (`_scan_err`), and that relative difference carried through the
# layers' backward; each leaf within HYBRID_GRAD_RTOL of its largest |grad|
HYBRID_GRAD_RTOL = 1e-3


def _scan_layers(cfg):
    """The layers of `cfg` that run the SSD scan: every Mamba2 layer of a
    hybrid, every mLSTM layer of an xLSTM."""
    if cfg.family == "hybrid":
        return cfg.n_layers
    if cfg.family == "ssm":
        return cfg.n_layers - len(cfg.xlstm.slstm_indices)
    return 0


def _check_hybrid_grad(torch, dev, cases=None, generator_device=None):
    """The hybrid's loss gradient on one microbatch (B 2), through the SSD
    kernels (ops.ssd_chunked on the card: forward and backward kernel)
    against the same gradient with ops.ssd_chunked pointed at the plain scan
    for the comparison, both on the card, attn_backend "jnp" (the training
    path). `cases`: (what, config, S); by default the reduced zamba2 at S 80
    and zamba2 at full width cut to 6 layers (one application of the shared
    block) at S 1024. Kernel launches: one scan forward and backward per
    layer on the kernel side, none on the plain side."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssm_scan import kernel, ops, ref
    from repro_torch.models import LM
    from repro_torch.tree_util import tree_flatten, tree_unflatten
    full = get_config("zamba2-2.7b")
    if cases is None:
        cases = (("reduced zamba2", full.reduced(), 80),
                 ("zamba2 at full width, 6 layers", dataclasses.replace(full, n_layers=6), 1024))
    worst_all = 0.0
    for what, cfg, S in cases:
        lm = LM(cfg, remat=False, attn_backend="jnp")
        leaves, treedef = tree_flatten(lm.init(seed=3, device=dev,
                                               generator_device=generator_device))
        toks = torch.randint(0, cfg.vocab, (2, S), generator=torch.Generator().manual_seed(S),
                             dtype=torch.int32)
        batch = {"tokens": toks.to(dev), "labels": torch.roll(toks, -1, dims=1).to(dev)}
        grads, counts = [], []
        for scan in (ops.ssd_chunked, ref.ssd_chunked):
            live = [x.detach().requires_grad_(True) for x in leaves]
            before = dict(kernel.launches)
            kernel_scan, ops.ssd_chunked = ops.ssd_chunked, scan
            try:
                loss = lm.loss(tree_unflatten(treedef, live), batch)[0]
                grads.append(torch.autograd.grad(loss, live))
            finally:
                ops.ssd_chunked = kernel_scan
            _sync(torch, dev)
            counts.append(_diff(dict(kernel.launches), before))
        n = _scan_layers(cfg)
        check(counts == [{"ssd_chunk_scan": n, "ssd_chunk_scan_bwd": n},
                         {"ssd_chunk_scan": 0, "ssd_chunk_scan_bwd": 0}],
              f"the hybrid gradients launched {counts}")
        worst = 0.0
        for a, b in zip(*grads):
            scale = float(b.abs().max())
            e = float((a - b).abs().max())
            check(bool(torch.isfinite(a).all()) and e <= HYBRID_GRAD_RTOL * scale + 1e-12,
                  f"{what}: a gradient leaf {tuple(b.shape)} differs by {e:.3e} (largest "
                  f"|grad| {scale:.3e})")
            worst = max(worst, e / max(scale, 1e-30))
        worst_all = max(worst_all, worst)
        print(f"[kernels] loss gradient, {what} (P = {sum(x.numel() for x in leaves):,}, "
              f"B 2, S {S}): kernels against the plain scan on the card, every leaf within "
              f"{worst:.2e} of its largest |grad| (bound {HYBRID_GRAD_RTOL}); launches "
              f"{counts[0]}")
        del leaves, grads, lm
        torch.cuda.empty_cache()
    return worst_all


def _host(t):
    """A copy on the CPU (also of a CPU tensor: the drivers update in place)."""
    return t.detach().to("cpu", copy=True)


def _bank_tensors(bank):
    """Copies on the CPU of the bank's tensors: (codes, scales, residual) of
    a quantized bank, or the dense rows: one (N, P) tensor, or every (N,
    *shape) leaf of a pytree bank."""
    from repro_torch.federation import QuantBank
    parts = ((bank.codes, bank.scales, bank.residual) if isinstance(bank, QuantBank)
             else tuple(_leaves(bank)))
    return tuple(_host(t) for t in parts)


def _state_parts(state):
    """{"theta", "bank", and under the tree "nodes" and "counts"}: tuples of
    copies of the state's tensors on the CPU, in jax's leaf order."""
    from repro_torch.federation import ParamFlat
    theta = state.theta_L
    theta = (theta.buf,) if isinstance(theta, ParamFlat) else tuple(_leaves(theta))
    parts = {"theta": tuple(_host(t) for t in theta), "bank": _bank_tensors(state.bank)}
    if state.tree is not None:
        parts["nodes"] = tuple(_host(t) for t in _leaves(state.tree.nodes))
        parts["counts"] = (_host(state.tree.counts),)
    return parts


def _state_tensors(state):
    """Every tensor of the state, on the CPU."""
    parts = _state_parts(state)
    return tuple(t for name in sorted(parts) for t in parts[name])


def _bit_equal(torch, a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _max_diff(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def _packed(torch, tensors, lead):
    """Pytree leaves packed as the flat engine packs them, `lead` leading
    axes (owners, levels) kept."""
    return torch.cat([t.reshape(t.shape[:lead] + (-1,)) for t in tensors], dim=lead)


def phase_refusal(torch, dev, bank_dtype=None, tree_depth=None, pack_params=True, fused=True):
    """Refusals at a reduced size, card against CPU. The paper mechanism
    runs with horizon 2; `tree_depth` = 2 runs the tree mechanism with
    horizon 8 and capacity 3, and adds: exact leaf counts, the ledger's
    tree view, nodes within the f32 tolerance, and (flat states) depth 0 ==
    "paper" bit for bit on the card. `pack_params=False` runs a pytree
    state (`fused` picks the privatizer) and adds, on the card, `spec.pack`
    of the pytree run == the flat reference mode bit for bit."""
    from repro_torch import random
    from repro_torch.configs import DENSE_124M
    from repro_torch.federation import (DataOwner, Federation, FederationConfig,
                                        PrivatizerConfig)
    from repro_torch.models import LM
    n_owners, K = 4, 12
    horizon = 2 if tree_depth is None else 8
    cap = horizon if tree_depth is None else min(horizon, (1 << tree_depth) - 1)
    cfg = DENSE_124M.reduced()
    lm = LM(cfg, remat=False)   # as examples/async_dp_llm.py builds it
    params = lm.init(seed=1, device="cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (K, 4, 16), dtype=np.int32)
    data = {"tokens": toks, "labels": np.roll(toks, -1, axis=2)}
    tag = (("f32" if bank_dtype is None else str(bank_dtype))
           + ("" if pack_params else f" pytree ({'fused' if fused else 'unfused'})")
           + ("" if tree_depth is None else f", tree depth {tree_depth}"))

    def session(device, depth=tree_depth, pack=pack_params, fuse=fused):
        mech = {} if depth is None else dict(mechanism="tree", tree_depth=depth)
        fed = Federation([DataOwner(n=100 * (i + 1), epsilon=1.0, xi=1.0)
                          for i in range(n_owners)],
                         FederationConfig.from_target_lr(0.05, n_owners=n_owners,
                                                         horizon=horizon, sigma=1e-2),
                         device=device, **mech)
        fed.make_step(lambda p, b: lm.loss(p, b)[0], pack_params=pack,
                      bank_dtype=bank_dtype if pack else None,
                      privatizer=PrivatizerConfig(xi=1.0, n_microbatches=2, fused_kernel=fuse))
        return fed, fed.init_state(params)

    runs, sessions = [], []
    for device in (dev, torch.device("cpu")):
        fed, state = session(device)
        state, ms = fed.run_rounds(state, _torch_batches(torch, data),
                                   key=random.PRNGKey(21, device=device))
        runs.append((ms["owner"].cpu().numpy(), ms["refused"].cpu().numpy(),
                     fed.reconcile(state), _state_parts(state)))
        sessions.append((fed, state))
    owners, refused, ledger, parts = runs[0]
    counts = np.zeros(n_owners, np.int64)
    expect = []
    for o in owners:
        expect.append(counts[o] >= cap)
        counts[o] += 1
    check(refused.tolist() == expect, f"refused {refused.tolist()} != host {expect}")
    check(any(expect), f"a cap of {cap} over {K} rounds refused nothing")
    granted = np.minimum(counts, cap)
    check({i: (r["responses"], r["refused"]) for i, r in ledger.items()}
          == {i: (int(g), int(c - g)) for i, (g, c) in enumerate(zip(granted, counts))},
          "reconciled ledger")
    if tree_depth is not None:
        check({i: r["tree"] for i, r in ledger.items()}
              == _tree_view(granted, tree_depth, 1.0, cap), "the ledger's tree view")
        check(parts["counts"][0].tolist() == granted.tolist(),
              "leaf counts differ from the host's")
    c_owners, c_refused, c_ledger, c_parts = runs[1]
    check(np.array_equal(owners, c_owners) and np.array_equal(refused, c_refused)
          and ledger == c_ledger, "cuda and cpu runs disagree on owners/refusals/ledger")
    theta, bank, c_theta, c_bank = parts["theta"], parts["bank"], c_parts["theta"], c_parts["bank"]
    if tree_depth is not None:
        check(torch.equal(parts["counts"][0], c_parts["counts"][0]),
              "cuda and cpu leaf counts differ")
        # the nodes are Laplace draws: log1pf on the card, log1p on the CPU
        for a, b in zip(parts["nodes"], c_parts["nodes"]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    if bank_dtype is None:
        # f32 sums in other orders (cuBLAS vs the CPU BLAS) around the same keys
        for a, b in zip(theta + bank, c_theta + c_bank):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    else:
        # a last-ulp difference may flip a rounding decision: codes within one
        # step, and theta_L within 1e-5 but half a step where such a copy was
        # gathered again
        step = float(c_bank[1].max())
        dcode = (bank[0].to(torch.int32) - c_bank[0].to(torch.int32)).abs()
        check(int(dcode.max()) <= 1 and float((dcode > 0).float().mean()) <= 1e-4,
              f"codes differ by up to {int(dcode.max())} at {int((dcode > 0).sum())} elements")
        dtheta = (theta[0] - c_theta[0]).abs()
        check(float((dtheta > 1e-5).float().mean()) <= 1e-4
              and float(dtheta.max()) <= step / 2 + 1e-5,
              f"theta_L differs by up to {float(dtheta.max()):.3e} (step {step:.3e})")
        torch.testing.assert_close(bank[1], c_bank[1], rtol=1e-6, atol=0.0)
        torch.testing.assert_close(bank[2], c_bank[2], rtol=0.0, atol=step)

    if pack_params and bank_dtype is None:
        _grouped_refusal(torch, dev, session, data, owners, runs[0], tag, tree_depth)

    # the host-authorized step loop under the same keys, bit for bit
    tensors = _state_tensors(sessions[0][1])
    fed, state = session(dev)
    round_keys = random.split(random.split(random.PRNGKey(21, device=dev))[1], K)
    for k in range(K):
        state, _ = fed.step(state, {n: torch.from_numpy(v[k]) for n, v in data.items()},
                            int(owners[k]), round_keys[k])  # dpcheck: ignore[DPC204]
    check(_bit_equal(torch, _state_tensors(state), tensors),
          "step loop differs from run_rounds on the card")
    # on the run_rounds state, a round of an exhausted owner is refused on
    # the device and changes nothing
    fed, state = sessions[0]
    exhausted = int(np.flatnonzero(counts >= cap)[0])
    state, ms = fed.run_rounds(state, _torch_batches(torch, {n: v[:1] for n, v in data.items()}),
                               [exhausted], key=random.PRNGKey(22, device=dev))
    check(bool(ms["refused"][0]), "an exhausted owner was granted")
    check(_bit_equal(torch, _state_tensors(state), tensors), "a refused round changed the state")
    what = "theta_L and the bank" if tree_depth is None else "theta_L, the bank and the tree"
    print(f"[refusal] {tag}: owners {owners.tolist()} refused "
          f"{refused.astype(int).tolist()}; ledger == host == cpu run; step loop == "
          f"run_rounds bit for bit; a refused round leaves {what} bit-exact; "
          f"max |cuda - cpu| theta {_max_diff(theta, c_theta):.3e}")
    if tree_depth is not None:
        print(f"[refusal] {tag}: leaf counts {granted.tolist()} == host == cpu run; "
              f"max |cuda - cpu| nodes {_max_diff(parts['nodes'], c_parts['nodes']):.3e}")
    if tree_depth is not None and pack_params:
        # the degenerate tree is the paper mechanism, bit for bit, on the card
        out = []
        for depth in (0, None):
            fed, state = session(dev, depth=depth)
            state, ms = fed.run_rounds(state, _torch_batches(torch, data),
                                       key=random.PRNGKey(23, device=dev))
            p = _state_parts(state)
            out.append((p["theta"] + p["bank"], ms["refused"].cpu(), fed.reconcile(state)))
        check(_bit_equal(torch, out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
              and out[0][2] == out[1][2], "a depth-0 tree differs from the paper mechanism")
        print(f"[refusal] {tag.split(',')[0]}: a depth-0 tree equals the paper "
              f"mechanism bit for bit (theta_L, bank, refusals, ledger)")
    if not pack_params:
        # the flat engine's reference mode runs the pytree path's round on
        # views of its buffers: spec.pack of the pytree run, bit for bit
        out = []
        for pack in (False, True):
            fed, state = session(dev, pack=pack, fuse=False)
            state, ms = fed.run_rounds(state, _torch_batches(torch, data),
                                       key=random.PRNGKey(24, device=dev))
            out.append((_state_parts(state), ms["refused"].cpu(), fed.reconcile(state)))
        (tp, t_ref, t_led), (fp, f_ref, f_led) = out
        same = (torch.equal(_packed(torch, tp["theta"], 0), fp["theta"][0])
                and torch.equal(_packed(torch, tp["bank"], 1), fp["bank"][0])
                and torch.equal(t_ref, f_ref) and t_led == f_led)
        if tree_depth is not None:
            same = (same and torch.equal(_packed(torch, tp["nodes"], 2), fp["nodes"][0])
                    and torch.equal(tp["counts"][0], fp["counts"][0]))
        check(same, "spec.pack of the pytree run differs from the flat reference mode")
        print(f"[refusal] {tag.split(' (')[0]}: spec.pack of the pytree run equals the flat "
              f"engine's reference mode bit for bit on the card (theta_L, bank"
              f"{', nodes, counts' if tree_depth is not None else ''}, refusals, ledger)")


def _grouped_refusal(torch, dev, session, data, owners, sequential, tag, tree_depth):
    """phase_refusal's run again under the grouped driver on the card
    (owner_parallel=True, unbounded groups; the same key draws the same
    owners): refusals and the reconciled ledger equal the sequential run's,
    and under the tree the leaf counts and the nodes too, bit for bit; one
    dp_round (tree: one tree_delta) and G = 2 sqnorm launches per group."""
    from repro_torch import random
    from repro_torch.federation import partition_conflict_free
    s_owners, s_refused, s_ledger, s_parts = sequential
    groups = partition_conflict_free(owners)
    check(max(n for _, n in groups) > 1, f"no group of two or more in {owners.tolist()}")
    fed, state = session(dev)
    before = _launches()
    state, ms = fed.run_rounds(state, _torch_batches(torch, data),
                               key=random.PRNGKey(21, device=dev), owner_parallel=True,
                               max_group=None)
    got = _diff(_launches(), before)
    tree = tree_depth is not None
    want = {k: 0 for k in got}
    want.update(sqnorm=2 * len(groups), dp_round=0 if tree else len(groups),
                tree_delta=len(groups) if tree else 0)
    check(got == want, f"grouped launches {got}, expected {want}")
    parts = _state_parts(state)
    check(np.array_equal(ms["owner"].cpu().numpy(), s_owners)
          and np.array_equal(ms["refused"].cpu().numpy(), s_refused)
          and fed.reconcile(state) == s_ledger,
          "the grouped run's owners, refusals or ledger differ from the sequential run's")
    if tree:
        check(torch.equal(parts["counts"][0], s_parts["counts"][0])
              and _bit_equal(torch, parts["nodes"], s_parts["nodes"]),
              "the grouped run's leaf counts or nodes differ from the sequential run's")
    print(f"[refusal] {tag}, grouped: groups {[n for _, n in groups]}, launches {got}; "
          f"refused and ledger == the sequential run's"
          + ("; leaf counts and nodes bit for bit" if tree else "")
          + f"; max |theta_L grouped - sequential| "
          f"{_max_diff(parts['theta'], s_parts['theta']):.3e}")


def phase_fault_refusal(torch, dev, bank_dtype=None, tree_depth=None, pack_params=True):
    """The fault-armed dispatch at a reduced size, card against CPU, in the
    manner of phase_refusal: schedule-drawn owners, a FaultPlan and a
    LatencyPlan on the f32 or int8 bank, the depth-2 tree (capacity 3) or
    the pytree state. Card == CPU exactly on owners, the seven ledger
    columns, the fault and runtime counters and the reconciled ledger (and
    the leaf counts); theta_L, the bank and the nodes within phase_refusal's
    tolerances. On the card: the stored checksums == bank_checksums; a
    zero plan under the default StalenessPolicy equals the fault-off engine
    bit for bit; on flat states the grouped driver's counters equal the
    sequential run's and, under the tree, its nodes and counts bit for bit;
    tree_delta launches twice a round (twice a group)."""
    from repro_torch import random
    from repro_torch.configs import DENSE_124M
    from repro_torch.federation import (DataOwner, FaultPlan, FaultPolicy, Federation,
                                        FederationConfig, LatencyPlan, PrivatizerConfig,
                                        StalenessPolicy, bank_checksums,
                                        partition_conflict_free)
    from repro_torch.models import LM
    n_owners, K = 4, 12
    horizon = 8
    cfg = DENSE_124M.reduced()
    lm = LM(cfg, remat=False)   # as examples/async_dp_llm.py builds it
    params = lm.init(seed=1, device="cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (K, 4, 16), dtype=np.int32)
    data = {"tokens": toks, "labels": np.roll(toks, -1, axis=2)}
    tag = (("f32" if bank_dtype is None else str(bank_dtype))
           + ("" if pack_params else " pytree")
           + ("" if tree_depth is None else f", tree depth {tree_depth}"))
    plan = FaultPlan(drop=0.1, stale=0.1, nonfinite=0.1, corrupt=0.1)
    latency = LatencyPlan(base=[0.2, 0.5, 0.7, 0.9], jitter=0.3)

    def session(device, armed=True, policy=None):
        mech = {} if tree_depth is None else dict(mechanism="tree", tree_depth=tree_depth)
        if armed:
            mech.update(fault_policy=FaultPolicy(max_faults=2, window=8),
                        staleness=StalenessPolicy(deadline=1.0, max_retries=2, backoff_cap=2,
                                                  decay=0.9) if policy is None else policy)
        fed = Federation([DataOwner(n=100 * (i + 1), epsilon=1.0, xi=1.0)
                          for i in range(n_owners)],
                         FederationConfig.from_target_lr(0.05, n_owners=n_owners,
                                                         horizon=horizon, sigma=1e-2),
                         device=device, **mech)
        fed.make_step(lambda p, b: lm.loss(p, b)[0], pack_params=pack_params,
                      bank_dtype=bank_dtype if pack_params else None,
                      privatizer=PrivatizerConfig(xi=1.0, n_microbatches=2, fused_kernel=True))
        return fed, fed.init_state(params)

    runs = []
    for device in (dev, torch.device("cpu")):
        fed, state = session(device)
        before = _launches()
        state, ms = fed.run_rounds(state, _torch_batches(torch, data), faults=plan,
                                   latency=latency, key=random.PRNGKey(31, device=device))
        got = _diff(_launches(), before)
        check(torch.equal(bank_checksums(state.bank), state.faults.checksum),
              f"{tag} on {device}: the stored checksums differ from the bank's")
        runs.append((ms["owner"].cpu().numpy(), _device_counters(torch, state),
                     fed.reconcile(state), _state_parts(state), got,
                     {k: ms[k].cpu().numpy() for k in ("dropped", "faulted", "timed_out",
                                                       "retried", "quarantined")}))
    (owners, counters, ledger, parts, got, masks), (c_owners, c_counters, c_ledger,
                                                     c_parts, _, c_masks) = runs
    check(np.array_equal(owners, c_owners) and counters == c_counters and ledger == c_ledger
          and all(np.array_equal(masks[k], c_masks[k]) for k in masks),
          f"{tag}: card and CPU disagree on owners, counters, outcomes or the ledger")
    if dev.type == "cuda" and pack_params:
        tree = tree_depth is not None
        want = {k: 0 for k in got}
        want.update(sqnorm=2 * K, dp_round=0 if tree else K, tree_delta=2 * K if tree else 0)
        if bank_dtype is not None:
            want.update(absmax=K, encode=K, decode=K)
        check(got == want, f"{tag}: fault-armed launches {got}, expected {want}")
    theta, bank, c_theta, c_bank = parts["theta"], parts["bank"], c_parts["theta"], c_parts["bank"]
    if tree_depth is not None:
        check(torch.equal(parts["counts"][0], c_parts["counts"][0]), "leaf counts differ")
        for a, b in zip(parts["nodes"], c_parts["nodes"]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    if bank_dtype is None:
        for a, b in zip(theta + bank, c_theta + c_bank):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    else:
        step = float(c_bank[1].max())
        dcode = (bank[0].to(torch.int32) - c_bank[0].to(torch.int32)).abs()
        check(int(dcode.max()) <= 1 and float((dcode > 0).float().mean()) <= 1e-4,
              f"codes differ by up to {int(dcode.max())} at {int((dcode > 0).sum())} elements")
        dtheta = (theta[0] - c_theta[0]).abs()
        check(float((dtheta > 1e-5).float().mean()) <= 1e-4
              and float(dtheta.max()) <= step / 2 + 1e-5,
              f"theta_L differs by up to {float(dtheta.max()):.3e} (step {step:.3e})")
        torch.testing.assert_close(bank[1], c_bank[1], rtol=1e-6, atol=0.0)
        torch.testing.assert_close(bank[2], c_bank[2], rtol=0.0, atol=step)
    totals = {c: sum(counters[f"ledger.{c}"]) for c in FAULT_COLUMNS}
    print(f"[fault refusal] {tag}: owners {owners.tolist()}, ledger totals {totals}; card == "
          f"CPU on the counters, the outcomes and the ledger; launches {got}; max |cuda - cpu| "
          f"theta {_max_diff(theta, c_theta):.3e}")
    if pack_params:
        # the grouped driver on the card: counters equal, nodes bit for bit
        groups = partition_conflict_free(owners)
        fed, state = session(dev)
        before = _launches()
        state, ms = fed.run_rounds(state, _torch_batches(torch, data), faults=plan,
                                   latency=latency, key=random.PRNGKey(31, device=dev),
                                   owner_parallel=True, max_group=None)
        g_got = _diff(_launches(), before)
        g_parts = _state_parts(state)
        check(_device_counters(torch, state) == counters,
              f"{tag}: the grouped run's counters differ from the sequential run's")
        if tree_depth is not None:
            check(torch.equal(g_parts["counts"][0], parts["counts"][0])
                  and _bit_equal(torch, g_parts["nodes"], parts["nodes"]),
                  f"{tag}: the grouped run's nodes differ from the sequential run's")
            if dev.type == "cuda":
                check(g_got["tree_delta"] == 2 * len(groups),
                      f"{tag}: grouped tree_delta launches {g_got['tree_delta']}, expected "
                      f"{2 * len(groups)}")
        print(f"[fault refusal] {tag}, grouped: groups {[n for _, n in groups]}, launches "
              f"{g_got}; counters == the sequential run's"
              + ("; leaf counts and nodes bit for bit" if tree_depth is not None else ""))
    # a zero plan under the default runtime is the fault-off engine, bit for bit
    out = []
    for armed in (False, True):
        fed, state = session(dev, armed=armed, policy=StalenessPolicy())
        extra = dict(faults=FaultPlan(), latency=LatencyPlan()) if armed else {}
        state, ms = fed.run_rounds(state, _torch_batches(torch, data),
                                   key=random.PRNGKey(32, device=dev), **extra)
        out.append((_state_parts(state), ms["refused"].cpu(), fed.reconcile(state)))
    (p0, r0, l0), (p1, r1, l1) = out
    check(all(_bit_equal(torch, p0[k], p1[k]) for k in p0) and torch.equal(r0, r1) and l0 == l1,
          f"{tag}: a zero plan under the default StalenessPolicy differs from the fault-off "
          "engine")
    print(f"[fault refusal] {tag}: FaultPlan() + StalenessPolicy() == the fault-off engine "
          "bit for bit on the card")


PAGED_K = 16                     # rounds a dispatch in phase paged
PAGED_OWNERS = 4096              # the scale run's federation (a flat f32 bank: 2.50 TB)
PAGED_HOT = {None: 16, "int8": 64}    # hot rows: about 9.8 GB on either bank
PAGED_WINDOW = 8                 # distinct owners a window of the recorded trace
# rounds of the profiled parity dispatch: main's K (a 32-round profile of
# 130k kernels takes about 25 s to read back)
PARITY_PROFILED_K = 8


def _owner_batches(torch, cfg, owner_seq, drawn, batch=4, seq=128, seed=0):
    """(K, batch, seq) token batches for a (K,) owner sequence, each owner's
    records drawn on demand from (seed, owner, how many it gave before):
    the federation's users each hold 10,000 records, which a run of a few
    rounds never needs all of (4,096 owners would be 21 GB of tokens)."""
    toks = np.empty((len(owner_seq), batch, seq), np.int32)
    for k, o in enumerate(owner_seq):
        o = int(o)
        rng = np.random.default_rng((seed, o, drawn.get(o, 0)))
        drawn[o] = drawn.get(o, 0) + 1
        toks[k] = rng.integers(0, cfg.vocab, (batch, seq), dtype=np.int32)
    return {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(np.roll(toks, -1, 2))}


def _paged_fed(torch, dev, lm, n_owners, bank_dtype=None, G=2, records=10_000, horizon=1000,
               **kw):
    from repro_torch.federation import (DataOwner, Federation, FederationConfig,
                                        PrivatizerConfig)
    fed = Federation([DataOwner(n=records, epsilon=1.0, xi=1.0)] * n_owners,
                     FederationConfig.from_target_lr(0.05, n_owners=n_owners, horizon=horizon,
                                                     sigma=1e-2, theta_max=100.0),
                     device=dev, **kw)
    fed.make_step(lambda p, b: lm.loss(p, b)[0], pack_params=True, bank_dtype=bank_dtype,
                  privatizer=PrivatizerConfig(xi=1.0, granularity="microbatch",
                                              n_microbatches=G, fused_kernel=True))
    return fed


def _ledger_equal(torch, a, b):
    return all(torch.equal(getattr(a, c), getattr(b, c)) for c in a.COLUMNS)


def _paged_trace(n_owners, K, window, n_hot, seed=7):
    """The recorded trace of the scale run: windows A, B, C, D, A of K
    rounds, each over `window` distinct owners (each named K / window
    times, shuffled), A to D disjoint and outside the initial residents
    0..n_hot-1. With n_hot = 2 x window, dispatches 3 to 5 each evict the
    window before last (dirty) and dispatch 5 loads A back from the cold
    tier."""
    rng = np.random.default_rng(seed)
    owners = rng.choice(np.arange(n_hot, n_owners), 4 * window, replace=False)
    wins = [owners[i * window:(i + 1) * window] for i in range(4)] + [owners[:window]]
    return np.concatenate([rng.permutation(np.repeat(w, K // window)) for w in wins]), wins


def _paged_parity(torch, dev, lm, cfg, params, K, n_owners, G, seq):
    """Phase paged (a): K-round dispatches on a flat and on a paged state
    (n_hot = n_owners) with the same keys and batches: one timed, one of
    PARITY_PROFILED_K rounds profiled (device time and kernels a round: the
    page-table lookup's cost) and one grouped (max_group 8), timed; each bit
    for bit. Returns the paged launches."""
    from repro_torch import random
    from repro_torch.federation import partition_conflict_free
    t0 = time.perf_counter()
    feds = [_paged_fed(torch, dev, lm, n_owners) for _ in range(2)]
    states = [feds[0].init_state(params), feds[1].init_paged_state(params, n_hot=n_owners)]
    rng = np.random.default_rng(11)
    out = {}
    for d, mode in enumerate(("sequential", "profiled", "grouped")):
        owner_seq = rng.integers(0, n_owners, PARITY_PROFILED_K if mode == "profiled" else K)
        batches = _owner_batches(torch, cfg, owner_seq, {}, seq=seq)
        key = random.PRNGKey(3100 + d, device=dev)
        kw = dict(owner_parallel=True, max_group=ROWS_G) if mode == "grouped" else {}
        res = []
        for i, fed in enumerate(feds):
            before = _launches()
            _sync(torch, dev)
            t1 = time.perf_counter()
            if mode == "profiled":
                (states[i], ms), busy, _, kernels = _profiled(
                    torch, dev, lambda: fed.run_rounds(states[i], batches, owner_seq, key=key),  # dpcheck: ignore[DPC105]
                    len(owner_seq), cpu_ops=False)
                cost = f"{busy:.3f} ms of device time and {kernels:.1f} kernels a round"
            else:
                states[i], ms = fed.run_rounds(states[i], batches, owner_seq, key=key, **kw)  # dpcheck: ignore[DPC105]
                _sync(torch, dev)
                cost = f"{(time.perf_counter() - t1) * 1e3 / len(owner_seq):.2f} ms a round"
            res.append((ms, _diff(_launches(), before), cost))
        (mf, lf, cf), (mp, lp, cp) = res
        sf, sp = states
        n_groups = len(partition_conflict_free(owner_seq, ROWS_G)) if kw else len(owner_seq)
        want = {k: 0 for k in lf}
        want.update(dp_round=n_groups, sqnorm=G * n_groups)
        check(lf == want and lp == want, f"parity launches {lf} flat, {lp} paged, expected {want}")
        same = (torch.equal(sf.theta_L.buf, sp.theta_L.buf) and torch.equal(sf.bank, sp.bank.hot)
                and _ledger_equal(torch, sf.ledger, sp.ledger) and int(sf.step) == int(sp.step)
                and mf.keys() == mp.keys() and all(torch.equal(mf[k], mp[k]) for k in mf))
        check(same, f"the paged dispatch differs from the flat one ({mode})")
        out["parity " + mode] = lp
        print(f"[paged] parity, {mode}{' (max_group 8)' if kw else ''}: {n_owners} owners, "
              f"n_hot {n_owners}, K={len(owner_seq)}: theta_L, the bank rows, the ledger and the metrics of "
              f"the paged dispatch == the flat one's bit for bit; launches {lp} ({n_groups} "
              f"rounds or groups); paged {cp}, flat {cf}")
    check(feds[0].reconcile(states[0]) == feds[1].reconcile(states[1]),
          "reconciled ledgers differ")
    print(f"[paged] parity took {time.perf_counter() - t0:.1f} s; reconciled ledgers equal")
    return out


def phase_paged(torch, dev, main_prof, cfg=None, K=PAGED_K, n_owners=PAGED_OWNERS,
                parity_owners=16, hot=PAGED_HOT, window=PAGED_WINDOW, seq=128,
                int8=True):
    """The paged owner bank at full width (`Federation.init_paged_state`,
    `TraceRing`, `OwnerPager`). (a) Parity: main's model, batch, sequence
    and G, `parity_owners` owners, n_hot = parity_owners, f32: a K-round
    dispatch on a paged state and on a flat state with the same key, one
    profiled, then one under run_rounds(owner_parallel=True, max_group=8)
    (`_paged_parity`): theta_L, the bank rows, the ledger and the metrics
    bit for bit, with the same launches. (b) Scale: `n_owners` owners (a flat f32 bank would be
    n_owners x P x 4 B, never allocated), n_hot = hot[None]: five
    dispatches stream from a TraceRing over the recorded trace of
    `_paged_trace`; per dispatch the prefetch's seconds, bytes and GB/s
    each way, ms per round beside main's, the pager's stats and resident
    bytes; then one profiled dispatch (the window resident: no paging),
    and the reconciled ledger against the host's count of the trace.
    (c) The same five dispatches once on an int8 bank, n_hot = hot["int8"]:
    the bank codec's launches. Returns {path: launches a dispatch}."""
    from repro_torch import random
    from repro_torch.configs import DENSE_124M
    from repro_torch.federation import AvailabilityTraceSchedule
    from repro_torch.models import LM
    cfg = DENSE_124M if cfg is None else cfg
    G = 2
    lm = LM(cfg, remat=False)   # as examples/async_dp_llm.py builds it
    params = lm.init(seed=0, device=dev)
    P = cfg.param_count()
    row = P * 4
    out = {}

    out.update(_paged_parity(torch, dev, lm, cfg, params, K, parity_owners, G, seq))
    torch.cuda.empty_cache()

    # ------------------------------ (b), (c) scale -----------------------------------
    trace, wins = _paged_trace(n_owners, K, window, hot[None])
    schedule = AvailabilityTraceSchedule(((0.0, 1.0),) * n_owners, trace=tuple(trace.tolist()))
    for bank_dtype in ((None, "int8") if int8 else (None,)):
        n_hot = hot[bank_dtype]
        tag = "f32" if bank_dtype is None else bank_dtype
        t0 = time.perf_counter()
        fed = _paged_fed(torch, dev, lm, n_owners, bank_dtype=bank_dtype)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        state = fed.init_paged_state(params, n_hot=n_hot)
        pager = fed.pager
        ring = schedule.trace_ring(chunk=2 * K, device=dev)
        resident = state.bank.nbytes
        flat = n_owners * P * 4
        print(f"[paged] scale, {tag}: {n_owners} owners, n_hot {n_hot}: resident "
              f"{resident / 1e9:.3f} GB (hot tier + page table; {n_hot} rows) against "
              f"{flat / 1e12:.3f} TB for a flat f32 bank, never allocated; set-up "
              f"{time.perf_counter() - t0:.1f} s; windows "
              f"{[sorted(int(o) for o in w) for w in wins]}")
        check(resident == (state.bank.hot.nbytes if bank_dtype else n_hot * row) + 4 * n_hot,
              f"resident bytes {resident}")
        drawn = {}
        want = {k: 0 for k in _launches()}
        want.update(dp_round=K, sqnorm=G * K)
        if bank_dtype is not None:
            want.update(absmax=K, encode=K, decode=K)
        per_round, dispatches = [], len(wins)
        for d in range(dispatches + (bank_dtype is None)):
            window_ids = ring.window(K)
            batches = _owner_batches(torch, cfg, window_ids, drawn, seq=seq)
            io0, st0 = dict(pager.io), dict(pager.stats)
            key = random.PRNGKey(3200 + d, device=dev)
            before = _launches()
            if d == dispatches:
                # the window is resident (A again): one profiled dispatch, no paging
                # the device alone: 32 sequential rounds are 130k kernels
                (state, ms), busy, groups, kernels = _profiled(
                    torch, dev, lambda: fed.run_rounds(state, batches, ring, key=key), K,
                    cpu_ops=False)
                check(pager.io == io0, "the profiled dispatch paged")
                print(f"[paged] scale, {tag}: profiled dispatch (no paging): device "
                      f"{busy:.3f} ms and {kernels:.0f} kernels a round against main's "
                      f"{main_prof['busy']:.3f} and {main_prof['launches']:.0f}")
                out[f"profile {tag}"] = dict(busy=busy, launches=kernels)
                got = _diff(_launches(), before)
                check(got == want, f"launches {got}, expected {want}")
                continue
            _sync(torch, dev)
            t1 = time.perf_counter()
            state, ms = fed.run_rounds(state, batches, ring, key=key)
            _sync(torch, dev)
            dt = time.perf_counter() - t1
            got = _diff(_launches(), before)
            check(got == want, f"scale {tag} dispatch {d}: launches {got}, expected {want}")
            check(not bool(ms["refused"].any()), "a round was refused (a page miss?)")
            check(np.array_equal(ms["owner"].cpu().numpy(), window_ids),
                  "the dispatch ran another sequence than the ring's window")
            io = {k: pager.io[k] - io0[k] for k in io0}
            st = {k: pager.stats[k] - st0[k] for k in st0}
            rows_moved = st["writebacks"], st["loads"]
            if d >= 2 and bank_dtype is None:
                check(rows_moved == (window, window),
                      f"dispatch {d} wrote back and loaded {rows_moved} rows")
            page_s = io["d2h_s"] + io["h2d_s"]
            per_round.append((dt - page_s) * 1e3 / K)
            out[f"scale {tag}"] = got
            print(f"[paged] scale, {tag}, dispatch {d}: {dt * 1e3:.1f} ms; prefetch "
                  f"{page_s:.3f} s: D2H {io['d2h_bytes'] / 1e9:.3f} GB in {io['d2h_s']:.3f} s "
                  f"({io['d2h_bytes'] / 1e9 / max(io['d2h_s'], 1e-9):.2f} GB/s), H2D "
                  f"{io['h2d_bytes'] / 1e9:.3f} GB in {io['h2d_s']:.3f} s "
                  f"({io['h2d_bytes'] / 1e9 / max(io['h2d_s'], 1e-9):.2f} GB/s); rounds "
                  f"{(dt - page_s) * 1e3 / K:.2f} ms/round without it, "
                  f"{dt * 1e3 / K:.2f} with it (main {main_prof['median']:.2f}); stats {st}; "
                  f"peak memory {_peak_gb(torch, dev):.2f} GB; launches {got}")
        stats = dict(pager.stats)
        want_stats = ({"prefetches": dispatches + 1, "loads": dispatches * window,
                       "evictions": dispatches * window, "writebacks": 3 * window}
                      if bank_dtype is None else None)
        if want_stats is not None:
            check(stats == want_stats, f"pager stats {stats}, expected {want_stats}")
        cold = {n: s.written for n, s in pager.stores.items()}
        ledger = fed.reconcile(state)
        ran = trace[:K * dispatches].tolist() + (trace[:K].tolist() if bank_dtype is None
                                                   else [])
        counts = np.bincount(ran, minlength=n_owners)
        check([r["responses"] for r in ledger.values()] == counts.tolist()
              and sum(r["refused"] for r in ledger.values()) == 0,
              "the reconciled ledger differs from the host's count of the trace")
        check(_state_finite(torch, state), "non-finite paged state")
        peak = _peak_gb(torch, dev)
        print(f"[paged] scale, {tag}: median {statistics.median(per_round[1:]):.2f} ms/round "
              f"without paging over dispatches 1..{dispatches - 1} (main "
              f"{main_prof['median']:.2f}); "
              f"pager stats {stats}; io {dict((k, round(v, 3)) for k, v in pager.io.items())}; "
              f"cold tier written rows {cold}; ring resident {ring.resident_bytes} B; peak "
              f"memory {peak:.2f} GB; ledger == host count of the trace "
              f"({int(counts.sum())} responses over {int((counts > 0).sum())} owners)")
        del state, fed, pager
        torch.cuda.empty_cache()
    return out


def phase_paged_refusal(torch, dev, bank_dtype=None, tree_depth=None, faults=False):
    """A paged session against its flat twin on the card, at a reduced size:
    4 owners, n_hot 3 (rows evict to the cold tier and come back), explicit
    dispatches of 4 rounds over at most 3 owners, under the paper mechanism
    (horizon 2: refusals) or the tree (depth 2, horizon 8, capacity 3), with
    or without the fault layer (phase_fault_refusal's plan, policy, runtime
    and latencies); each sequentially and under the grouped driver. theta_L,
    every owner's row (the pager's snapshot), the nodes and counts, the
    ledger, the fault and runtime counters and the refused mask bit for bit;
    the same launches. Returns the paged run's launches by driver."""
    from repro_torch import random
    from repro_torch.configs import DENSE_124M
    from repro_torch.federation import (FaultPlan, FaultPolicy, LatencyPlan, QuantBank,
                                        StalenessPolicy)
    from repro_torch.models import LM
    n_owners, n_hot = 4, 3
    cfg = DENSE_124M.reduced()
    lm = LM(cfg, remat=False)   # as examples/async_dp_llm.py builds it
    params = lm.init(seed=1, device="cpu")
    chunks = ([0, 1, 0, 2], [3, 1, 3, 3], [2, 0, 0, 2], [1, 3, 1, 0])
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (16, 4, 16), dtype=np.int32)
    data = {"tokens": toks, "labels": np.roll(toks, -1, axis=2)}
    tag = (("f32" if bank_dtype is None else bank_dtype)
           + ("" if tree_depth is None else f", tree depth {tree_depth}")
           + (", faults" if faults else ""))
    kw = {} if tree_depth is None else dict(mechanism="tree", tree_depth=tree_depth)
    if faults:
        kw.update(fault_policy=FaultPolicy(max_faults=2, window=8),
                  staleness=StalenessPolicy(deadline=1.0, max_retries=2, backoff_cap=2,
                                            decay=0.9))
    horizon = 8 if (tree_depth or faults) else 2
    out = {}
    for grouped in (False, True):
        runs = []
        for paged in (False, True):
            fed = _paged_fed(torch, dev, lm, n_owners, bank_dtype=bank_dtype, records=100,
                             horizon=horizon, **kw)
            state = (fed.init_paged_state(params, n_hot=n_hot) if paged
                     else fed.init_state(params))
            before = _launches()
            refused = []
            for c, owners in enumerate(chunks):
                extra = {}
                if faults:
                    extra = dict(faults=FaultPlan(drop=0.1, stale=0.1, nonfinite=0.1,
                                                  corrupt=0.1),
                                 latency=LatencyPlan(base=[0.2, 0.5, 0.7, 0.9], jitter=0.3))
                if grouped:
                    extra.update(owner_parallel=True, max_group=None)
                state, ms = fed.run_rounds(
                    state, _torch_batches(torch, {k: v[4 * c:4 * c + 4] for k, v in data.items()}),
                    owners, key=random.PRNGKey(40 + c, device=dev), **extra)
                refused.append(ms["refused"].cpu())
            got = _diff(_launches(), before)
            if paged:
                check(fed.pager.stats["evictions"] > 0 and fed.pager.stats["writebacks"] > 0,
                      f"{tag}: the paged run evicted nothing")
                snap = fed.pager.snapshot(state)
                rows = tuple(torch.from_numpy(snap[k]) for k in sorted(snap) if k != "tree")
                nodes = torch.from_numpy(snap["tree"]) if "tree" in snap else None
                hot = state.bank.hot
                resid = (_host(hot.residual),) if isinstance(hot, QuantBank) else ()
            else:
                bank = state.bank
                rows = ((_host(bank.codes), _host(bank.scales)) if isinstance(bank, QuantBank)
                        else (_host(bank),))
                resid = (_host(bank.residual),) if isinstance(bank, QuantBank) else ()
                nodes = _host(state.tree.nodes) if state.tree is not None else None
            counters = _device_counters(torch, state) if faults else None
            runs.append(dict(theta=_host(state.theta_L.buf), rows=rows, resid=resid,
                             nodes=nodes, refused=torch.cat(refused),
                             counts=None if state.tree is None else _host(state.tree.counts),
                             ledger=fed.reconcile(state), counters=counters, launches=got,
                             stats=dict(fed.pager.stats) if paged else None))
        f, p = runs
        check(torch.equal(f["theta"], p["theta"]) and _bit_equal(torch, f["rows"], p["rows"])
              and _bit_equal(torch, f["resid"], p["resid"])
              and torch.equal(f["refused"], p["refused"]) and f["ledger"] == p["ledger"]
              and f["counters"] == p["counters"] and f["launches"] == p["launches"],
              f"{tag}{', grouped' if grouped else ''}: the paged run differs from its flat twin")
        if tree_depth is not None:
            check(torch.equal(f["nodes"], p["nodes"]) and torch.equal(f["counts"], p["counts"]),
                  f"{tag}: the paged tree differs from its flat twin")
        check(bool(f["refused"].any()) or faults, f"{tag}: nothing was refused")
        kernel = "tree_delta" if tree_depth else "dp_round"
        check(p["launches"][kernel] > 0 and p["launches"]["sqnorm"] > 0
              and (bank_dtype is None or all(p["launches"][k] > 0
                                             for k in ("absmax", "encode", "decode"))),
              f"{tag}: launches {p['launches']}")
        out["grouped" if grouped else "sequential"] = p["launches"]
        print(f"[paged refusal] {tag}{', grouped' if grouped else ''}: n_hot {n_hot} of "
              f"{n_owners}, pager stats {p['stats']}; theta_L, the rows"
              + (", the nodes and counts" if tree_depth is not None else "")
              + (", the fault and runtime counters" if faults else "")
              + f", refusals ({int(p['refused'].sum())}) and the ledger == the flat twin's "
              f"bit for bit; launches {p['launches']}")
    return out


def phase_checkpoint(torch, dev, cfg=None, n_owners=16, K=8, seq=128, root=None):
    """Crash-resume at full width: main's state (`n_owners` owners, f32
    bank) after one K-round dispatch and a reconcile is saved with
    `Federation.save_session` into a directory under the checkout's build/
    (the free disk is checked first, the directory removed afterwards),
    then the session runs K more rounds, uninterrupted; a fresh Federation
    restores the checkpoint into a fresh `like` state (`restore_session`)
    and runs the same K rounds: theta_L, the bank and the reconciled ledger
    bit for bit. Save and restore seconds and GB/s. Then a paged crash-
    resume at a reduced size: save, run, crash (the session is dropped),
    restore, run: equal to the uninterrupted run."""
    import shutil
    from repro_torch import random
    from repro_torch.checkpoint import flatten_with_paths
    from repro_torch.configs import DENSE_124M
    from repro_torch.models import LM
    cfg = DENSE_124M if cfg is None else cfg
    lm = LM(cfg, remat=False)   # as examples/async_dp_llm.py builds it
    params = lm.init(seed=0, device=dev)
    root = os.path.join(ROOT, "build", "chip_smoke_checkpoint") if root is None else root
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        fed_a = _paged_fed(torch, dev, lm, n_owners)
        state = fed_a.init_state(params)
        nbytes = sum(t.numel() * t.element_size() for t in flatten_with_paths(state).values())
        free = shutil.disk_usage(root).free
        print(f"[checkpoint] {cfg.name}: {n_owners} owners, f32 bank; state "
              f"{nbytes / 1e9:.3f} GB; free disk under build/ {free / 1e9:.1f} GB")
        check(free > 2 * nbytes, f"{free / 1e9:.1f} GB free on disk for a {nbytes / 1e9:.1f} "
              "GB checkpoint")
        rng = np.random.default_rng(21)
        drawn = {}
        seqs = [rng.integers(0, n_owners, K) for _ in range(2)]
        data = [_owner_batches(torch, cfg, s, drawn, seq=seq) for s in seqs]
        keys = [random.PRNGKey(3300 + i, device=dev) for i in range(2)]
        state, _ = fed_a.run_rounds(state, data[0], seqs[0], key=keys[0])
        fed_a.reconcile(state)
        _sync(torch, dev)
        t0 = time.perf_counter()
        step = fed_a.save_session(root, state)
        save_s = time.perf_counter() - t0
        on_disk = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root)
                      for f in fs)
        state, _ = fed_a.run_rounds(state, data[1], seqs[1], key=keys[1])   # uninterrupted
        led_a = fed_a.reconcile(state)
        theta_a, bank_a = state.theta_L.buf, state.bank
        del state
        fed_b = _paged_fed(torch, dev, lm, n_owners)
        like = fed_b.init_state(params)
        _sync(torch, dev)
        t0 = time.perf_counter()
        restored = fed_b.restore_session(root, like)
        _sync(torch, dev)
        restore_s = time.perf_counter() - t0
        del like
        check(int(restored.step) == step, "restored step")
        restored, _ = fed_b.run_rounds(restored, data[1], seqs[1], key=keys[1])
        check(torch.equal(restored.theta_L.buf, theta_a) and torch.equal(restored.bank, bank_a)
              and fed_b.reconcile(restored) == led_a,
              "the restored session's K rounds differ from the uninterrupted run's")
        print(f"[checkpoint] save_session {save_s:.2f} s ({on_disk / 1e9:.3f} GB on disk, "
              f"{on_disk / 1e9 / save_s:.2f} GB/s), restore_session {restore_s:.2f} s "
              f"({on_disk / 1e9 / restore_s:.2f} GB/s); the restored session's {K} rounds == "
              f"the uninterrupted run's bit for bit (theta_L, bank, reconciled ledger)")
        # where the time goes, on one bank row: its pageable copies each way,
        # and the CRC-32 that np.savez and np.load each compute over it
        _sync(torch, dev)
        t0 = time.perf_counter()
        host = restored.bank[0].cpu()
        d2h_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        zlib.crc32(host.numpy())
        crc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        host.to(dev)
        _sync(torch, dev)
        h2d_s = time.perf_counter() - t0
        gb = host.numel() * 4 / 1e9
        print(f"[checkpoint] one bank row of {gb:.3f} GB: pageable D2H {d2h_s:.2f} s "
              f"({gb / d2h_s:.2f} GB/s), zlib.crc32 {crc_s:.2f} s ({gb / crc_s:.2f} GB/s), "
              f"pageable H2D {h2d_s:.2f} s ({gb / h2d_s:.2f} GB/s)")
        del host
        del restored, theta_a, bank_a, fed_a, fed_b
        torch.cuda.empty_cache()
        _paged_crash_resume(torch, dev, os.path.join(root, "paged"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(save_s=save_s, restore_s=restore_s, bytes=on_disk)


def _paged_crash_resume(torch, dev, directory):
    """Reduced: a paged int8 session (4 owners, n_hot 2, faults and the
    runtime armed) saves after two dispatches, runs two more and "crashes"
    (is dropped); a fresh session restores and runs the two again: theta_L,
    every row, the counters and the reconciled ledger equal the
    uninterrupted run's."""
    from repro_torch import random
    from repro_torch.configs import DENSE_124M
    from repro_torch.federation import (FaultPlan, FaultPolicy, LatencyPlan, StalenessPolicy)
    from repro_torch.models import LM
    cfg = DENSE_124M.reduced()
    lm = LM(cfg, remat=False)   # as examples/async_dp_llm.py builds it
    params = lm.init(seed=1, device="cpu")
    chunks = ([0, 1, 0], [1, 2, 2], [0, 0, 1], [2, 3, 2])     # at most n_hot = 2 owners each
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (12, 4, 16), dtype=np.int32)
    data = {"tokens": toks, "labels": np.roll(toks, -1, axis=2)}
    plan = FaultPlan(drop=0.2, stale=0.2)
    lat = LatencyPlan(base=[0.2, 2.0, 0.2, 0.5], jitter=0.5)

    def make():
        fed = _paged_fed(torch, dev, lm, 4, bank_dtype="int8", records=200, horizon=16,
                         fault_policy=FaultPolicy(max_faults=4, window=8),
                         staleness=StalenessPolicy(deadline=1.0, max_retries=2, decay=0.9))
        return fed, fed.init_paged_state(params, n_hot=2)

    def run(fed, state, cs):
        for c in cs:
            state, _ = fed.run_rounds(
                state, _torch_batches(torch, {k: v[3 * c:3 * c + 3] for k, v in data.items()}),
                chunks[c], key=random.PRNGKey(60 + c, device=dev), faults=plan, latency=lat)
        return state

    fed_a, s_a = make()
    s_a = run(fed_a, s_a, range(4))
    led_a = fed_a.reconcile(s_a)
    fed_b, s_b = make()
    s_b = run(fed_b, s_b, range(2))
    fed_b.reconcile(s_b)
    fed_b.save_session(directory, s_b)
    run(fed_b, s_b, range(2, 4))
    del fed_b, s_b                                  # the crash
    fed_c, like = make()
    s_c = run(fed_c, fed_c.restore_session(directory, like), range(2, 4))
    snap_a, snap_c = fed_a.pager.snapshot(s_a), fed_c.pager.snapshot(s_c)
    check(torch.equal(s_a.theta_L.buf, s_c.theta_L.buf)
          and all(np.array_equal(snap_a[k], snap_c[k]) for k in snap_a)
          and torch.equal(s_a.bank.hot.residual, s_c.bank.hot.residual)
          and _device_counters(torch, s_a) == _device_counters(torch, s_c)
          and fed_c.reconcile(s_c) == led_a,
          "the paged crash-resume differs from the uninterrupted run")
    print(f"[checkpoint] paged crash-resume (reduced, int8, n_hot 2 of 4, faults and "
          f"runtime): restored after 2 of 4 dispatches == the uninterrupted run bit for bit "
          f"(theta_L, every row, residual, counters, ledger); pager stats "
          f"{fed_c.pager.stats}")


# phase xlstm: xlstm-125m at full width and depth (12 blocks, the sLSTM at 6),
# f32; build_train_step's rounds at batch 4 x S 1024, G = 2, 4 owners
XLSTM_SEQ = 1024
XLSTM_DECODE_SEQ = 300           # a chunk of 256 and a ragged one
XLSTM_TRAIN_STEPS = 5            # launch.train.main at its reduced default size
# the whole model's gradient check runs at one chunk: over S 1024 the sLSTM's
# recurrence (recurrent weights at std 0.3 over hd 192, a gain of about 4 a
# position) amplifies f32 rounding differences until two plain scans that
# differ only in their chunk length disagree on gradient leaves by percents
# (`_xlstm_grad_conditioning` prints it); the mLSTM blocks alone are checked
# at S 1024
XLSTM_GRAD_SEQ = 256
# phase moe: qwen3-moe-30b-a3b at full width, depth cut to fit one card: 4 of
# 48 layers for the prefill (3.11 B leaves, 12.4 GB f32), 1 for the train
# round (1.25 B leaves: theta_L and a bank of 2 owners, 15 GB, then the
# round's theta_bar, gradients, mean and noise tree, 5 GB each, and the
# Laplace draw's int64 words over the 311 M-element embedding tables; 2
# layers ran out of the card's 80 GB)
MOE_PREFILL_LAYERS = 4
MOE_TRAIN_LAYERS = 1
# the onehot dispatch rounds x and the combine weights to bf16 (the
# reference's casts), each a relative error of up to 2^-8 (a bf16 step):
# logits of the two attention backends, where the two f32 paths leave an
# element on either side of a rounding boundary, and onehot (no capacity
# drop) against the f32 ragged dispatch at one layer, are held within two
# such steps of the largest value
MOE_PREFILL_REL = 2.0 ** -7


def _round_batches(torch, cfg, n, batch, seq, G, dev, seed, extra=None):
    """n microbatch-major (G, batch / G, seq) token batches on `dev`, each
    also holding the tensors of `extra` (a stub frontend's output)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab, (G, batch // G, seq), dtype=np.int32)
        out.append({**{k: torch.from_numpy(v).to(dev)
                       for k, v in (("tokens", toks), ("labels", np.roll(toks, -1, axis=2)))},
                    **(extra or {})})
    return out


def _xlstm_grad_conditioning(torch, dev, cfg, S, gen_dev=None):
    """Printed, not checked: the whole xLSTM's loss gradient at S (B 2)
    through the kernels against the plain scan, and the plain scan at chunk
    128 against itself at chunk 256 (the same function, other rounding):
    the largest leaf difference over that leaf's largest |gradient|, for
    each pair. Where both pairs disagree alike, the gradient is
    ill-conditioned in f32 and no scan implementation can meet a tight
    bound there."""
    from repro_torch.kernels.ssm_scan import ops, ref
    from repro_torch.models import LM
    from repro_torch.tree_util import tree_flatten, tree_unflatten
    lm = LM(cfg)
    leaves, treedef = tree_flatten(lm.init(seed=3, device=dev, generator_device=gen_dev))
    toks = torch.randint(0, cfg.vocab, (2, S), generator=torch.Generator().manual_seed(S),
                         dtype=torch.int32)
    batch = {"tokens": toks.to(dev), "labels": torch.roll(toks, -1, dims=1).to(dev)}

    def chunk128(v, ld, k, q, g, *, chunk, h0=None):
        return ref.ssd_chunked(v, ld, k, q, g, chunk=min(chunk, 128), h0=h0)

    grads, losses = [], []
    for scan in (ops.ssd_chunked, ref.ssd_chunked, chunk128):
        live = [x.detach().requires_grad_(True) for x in leaves]
        kernel_scan, ops.ssd_chunked = ops.ssd_chunked, scan
        try:
            loss = lm.loss(tree_unflatten(treedef, live), batch)[0]
            grads.append(torch.autograd.grad(loss, live))
            losses.append(float(loss))
        finally:
            ops.ssd_chunked = kernel_scan

    def worst(a, b):
        return max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
                   for x, y in zip(a, b))

    print(f"[xlstm] gradient conditioning at full width and depth, B 2 x S {S}: kernels "
          f"against the plain scan, worst leaf {worst(grads[0], grads[1]):.2e} of its largest "
          f"|gradient| (loss {losses[0]:.7f} vs {losses[1]:.7f}); the plain scan at chunk 128 "
          f"against chunk 256, worst leaf {worst(grads[2], grads[1]):.2e} (loss "
          f"{losses[2]:.7f})")
    del leaves, grads


def _train_step_rounds(torch, dev, tag, cfg, lm, holder, n_owners, batch, seq, G, rounds,
                       per_round, extra=None):
    """launch.steps.build_train_step's step (the pytree state, G pre-grouped
    microbatches, the reference privatizer) for `rounds` timed rounds (the
    first warms up) and one profiled, each with exactly `per_round`
    launches. `holder` is a list holding the initial params: they are taken
    out of it once the state holds its copies, so that no third copy stays
    on the card. `extra`: tensors added to every batch (the audio family's
    frames). Returns (ms per round, device busy ms, device kernels, peak
    GB)."""
    from repro_torch import random
    from repro_torch.configs import ShapeConfig
    from repro_torch.federation.deep import init_state
    from repro_torch.launch.steps import build_train_step, default_async_cfg
    acfg = default_async_cfg(n_owners=n_owners, n_microbatches=G)
    bundle = build_train_step(cfg, ShapeConfig(tag, seq, batch, "train"), None, model=lm,
                              async_cfg=acfg, dtype=torch.float32, device=dev)
    check(bundle.kind == "train" and tuple(bundle.args[1]["tokens"].shape)
          == (G, batch // G, seq), f"the {tag} bundle's batch spec")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    state = init_state(holder.pop(), acfg, device=dev)
    batches = _round_batches(torch, cfg, rounds + 1, batch, seq, G, dev, seed=5, extra=extra)
    key = random.PRNGKey(11, device=dev)

    def one(state, r, sub):
        owner = torch.tensor([r % n_owners], dtype=torch.int32, device=dev)
        before = _launches()
        state, m = bundle.step(state, batches[r], owner, sub)
        got = _diff(_launches(), before)
        check(got == per_round, f"a {tag} round launched {got}, expected {per_round}")
        return state, m

    times = []
    for r in range(rounds):
        key, sub = random.split(key)
        _sync(torch, dev)
        t0 = time.perf_counter()
        state, m = one(state, r, sub)
        _sync(torch, dev)
        times.append((time.perf_counter() - t0) * 1e3)
    key, sub = random.split(key)
    (state, m), busy, groups, kernels = _profiled(torch, dev, lambda: one(state, rounds, sub), 1,
                                                  top=6, cpu_ops=False)
    # every leaf at once (`_state_finite` goes row by row through large
    # leaves: 151,936 rows and host reads of the MoE's embedding bank)
    check(int(state.step) == rounds + 1
          and all(bool(torch.isfinite(leaf).all())
                  for leaf in _leaves(state.theta_L) + _leaves(state.bank)),
          f"the {tag} state after {rounds + 1} rounds")
    ms = statistics.median(times[1:])
    peak = _peak_gb(torch, dev)
    print(f"[{tag}] build_train_step: {n_owners} owners, batch {batch} x S {seq}, G = {G}: "
          f"rounds {', '.join(f'{t:.1f}' for t in times)} ms (the first warms up), median "
          f"{ms:.1f} ms; per round {per_round}; device busy {busy:.2f} ms, the device idles "
          f"{1 - busy / ms:.1%}, {kernels:.0f} device kernels a round; peak memory "
          f"{peak:.2f} GB; clip_frac {float(m['clip_frac']):.2f}")
    del state, batches
    return ms, busy, kernels, peak


def phase_xlstm(torch, dev, cfg=None, n_owners=4, batch=4, seq=XLSTM_SEQ, G=2, rounds=2,
                fused_seq=128, fused_dispatches=1, decode_seq=XLSTM_DECODE_SEQ,
                train_steps=XLSTM_TRAIN_STEPS, ckpt_root=None):
    """xlstm-125m at full width and depth on the card (random weights from a
    seed, f32): (1) build_train_step rounds, one SSD scan forward and
    backward (the wide-head kernels, N 384 / P 385) per mLSTM layer and
    microbatch; (2) the loss gradient through the kernels against the plain
    scan, both on the card; (3) the main path's flat fused engine over the
    xLSTM (phase_main: K = 8, dp_round and sqnorm on the xLSTM's flat row,
    at main's sequence length, `fused_seq`: the sLSTM's per-position host
    loop makes a round at S 1024 take seconds);
    (4) decode against the forward; (5) launch.train.main at its reduced
    default size on the card, its checkpoint loaded back bit for bit.
    Returns the launches per round of (1)."""
    import dataclasses
    import shutil
    from repro_torch.checkpoint import flatten_with_paths, load_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import LM
    cfg = get_config("xlstm-125m") if cfg is None else cfg
    n_scan = _scan_layers(cfg)
    lm = LM(cfg)
    t0 = time.perf_counter()
    # weights drawn on the card (seconds at full width on the host)
    gen_dev = dev if dev.type == "cuda" else None
    params = lm.init(seed=0, device=dev, generator_device=gen_dev)
    n_params = sum(leaf.numel() for leaf in _leaves(params))
    check(n_params == cfg.param_count(), f"{n_params} parameters, expected {cfg.param_count()}")
    _sync(torch, dev)
    print(f"[xlstm] {cfg.name}: {n_params:,} parameters, {cfg.n_layers} blocks ({n_scan} mLSTM "
          f"with scan heads N {cfg.d_model * 2 // cfg.n_heads}, P "
          f"{cfg.d_model * 2 // cfg.n_heads + 1}; the sLSTM at {cfg.xlstm.slstm_indices}); "
          f"drawn in {time.perf_counter() - t0:.1f} s")
    zero = {k: 0 for k in FED_KERNELS + MODEL_KERNELS}
    per_round = dict(zero, ssd_chunk_scan=G * n_scan, ssd_chunk_scan_bwd=G * n_scan)
    _reset_launches()
    _train_step_rounds(torch, dev, "xlstm", cfg, lm, [params], n_owners, batch, seq, G, rounds,
                       per_round)
    # the loss gradient through the kernels against the plain scan: the whole
    # model at one chunk, and its mLSTM blocks alone over four chunks
    mlstm_only = dataclasses.replace(cfg, xlstm=dataclasses.replace(cfg.xlstm,
                                                                    slstm_indices=()))
    _check_hybrid_grad(torch, dev, cases=(
        (f"{cfg.name} at full width and depth", cfg, XLSTM_GRAD_SEQ),
        (f"{cfg.name} at full width, its {cfg.n_layers} blocks all mLSTM", mlstm_only, seq)),
        generator_device=gen_dev)
    _xlstm_grad_conditioning(torch, dev, cfg, seq, gen_dev)
    print(f"[xlstm] {time.perf_counter() - t0:.1f} s into the phase")
    # the profiled dispatch traces the device alone: its ~190 K kernels with
    # their host ops took about a minute to read back
    fused_launches, _, _, _, _ = phase_main(torch, dev, cfg=cfg, n_owners=n_owners,
                                            seq=fused_seq, dispatches=fused_dispatches,
                                            tag="xlstm fused", cpu_ops=False)
    check(fused_launches["dp_round"] > 0 and fused_launches["sqnorm"] > 0
          and fused_launches["ssd_chunk_scan_bwd"] > 0, "the fused xLSTM path launched "
          f"{fused_launches}")
    print(f"[xlstm] {time.perf_counter() - t0:.1f} s into the phase")
    # decode against the forward at full width and depth
    toks = torch.randint(0, cfg.vocab, (2, decode_seq), generator=torch.Generator().manual_seed(3),
                         dtype=torch.int32).to(dev)
    _reset_launches()
    with torch.no_grad():
        full = torch.einsum("bsd,dv->bsv", lm.forward(params, {"tokens": toks}),
                            lm._unembed(params))
        got = _launches()
        cache = lm.init_cache(2, decode_seq, dtype=torch.float32, device=dev)
        err = 0.0
        for t in range(decode_seq):
            lg, cache = lm.decode_step(params, cache, toks[:, t:t + 1], t)
            err = max(err, float((lg[:, 0] - full[:, t]).abs().max()))
    check(got == dict(zero, ssd_chunk_scan=n_scan), f"the xLSTM forward launched {got}")
    check(_launches() == got, "xLSTM decode launched a kernel")
    check(err <= DECODE_TOL and math.isfinite(err), f"xLSTM decode differs from the forward by "
          f"{err:.3e}")
    print(f"[xlstm] decode against the forward at full width, S {decode_seq}: max |logit "
          f"difference| {err:.3e} over every position (bound {DECODE_TOL}; max |logit| "
          f"{float(full.abs().max()):.3f}); the forward launched {n_scan} ssd_chunk_scan, "
          f"decode none; {time.perf_counter() - t0:.1f} s into the phase")
    del full, cache, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # the training launcher at its default (reduced) size on the card
    root = ckpt_root or os.path.join(ROOT, "build", "chip_smoke_xlstm_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    _reset_launches()
    t0 = time.perf_counter()
    state = train_main(["--arch", "xlstm-125m", "--steps", str(train_steps), "--device",
                        dev.type, "--ckpt-dir", root])
    _sync(torch, dev)
    dt = time.perf_counter() - t0
    got = _launches()
    check(int(state.step) == train_steps and _state_finite(torch, state),
          "launch.train.main's state")
    check(got["ssd_chunk_scan"] > 0 and got["ssd_chunk_scan_bwd"] > 0,
          f"launch.train.main launched {got}")
    back = load_checkpoint(root, train_steps, state)
    mine, loaded = flatten_with_paths(state), flatten_with_paths(back)
    check(list(mine) == list(loaded) and all(torch.equal(mine[k], loaded[k]) for k in mine),
          "the launcher's checkpoint does not load back bit for bit")
    print(f"[xlstm] launch.train.main --arch xlstm-125m (reduced: N 128, P 129) --steps "
          f"{train_steps} --device {dev.type}: {dt:.1f} s, launches "
          f"{ {k: v for k, v in got.items() if v} }; its checkpoint ({len(mine)} leaves, "
          f"e.g. {next(k for k in mine if 'mlstm' in k)}) loads back bit for bit")
    shutil.rmtree(root, ignore_errors=True)
    return per_round


def phase_moe(torch, dev, cfg=None, prefill_layers=MOE_PREFILL_LAYERS, batch=PREFILL_B,
              seq=PREFILL_S, layer_seq=1024, train_layers=MOE_TRAIN_LAYERS, n_owners=2,
              train_batch=4, train_seq=1024, G=2, rounds=2):
    """qwen3-moe-30b-a3b at full width on the card (random weights drawn on
    the card from a seed, f32), depth cut to `prefill_layers`: the prefill
    through build_prefill_step with attn_backend "pallas" (flash on every
    layer) against "jnp"; one full-width MoE layer's onehot dispatch with a
    capacity that drops nothing against the ragged one; then one
    build_train_step round at microbatch granularity (the ragged dispatch,
    the launcher's) on the first `train_layers` layers. Returns the
    prefill's launches."""
    import dataclasses
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import LM
    from repro_torch.models import moe as moe_mod
    full = get_config("qwen3-moe-30b-a3b") if cfg is None else cfg
    cut = dataclasses.replace(full, n_layers=prefill_layers)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    lm = LM(cut, attn_backend="pallas")
    t0 = time.perf_counter()
    params = lm.init(seed=0, device=dev, generator_device=dev if dev.type == "cuda" else None)
    n_params = sum(leaf.numel() for leaf in _leaves(params))
    check(n_params == cut.param_count(), f"{n_params} parameters, expected {cut.param_count()}")
    _sync(torch, dev)
    m = cut.moe
    print(f"[moe] {full.name} at full width, {prefill_layers} of {full.n_layers} layers: "
          f"{n_params:,} parameters ({n_params * 4 / 1e9:.2f} GB f32; all {full.n_layers} layers: "
          f"{full.param_count():,}, {full.active_param_count():,} active a token), "
          f"{m.n_experts} experts top-{m.top_k}, d_expert {m.d_expert}; drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    shape = ShapeConfig("moe_prefill", seq, batch, "prefill")
    bundle = build_prefill_step(cut, shape, None, model=lm, dtype=torch.float32)
    toks = torch.randint(0, cut.vocab, (batch, seq), generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32).to(dev)
    zero = {k: 0 for k in FED_KERNELS + MODEL_KERNELS}
    per_prefill = dict(zero, flash_attention=prefill_layers)
    print(f"[moe] the onehot dispatch in groups of {lm.moe_group_tokens} tokens")
    logits, _, launches = _prefill_runs(torch, dev, "moe", bundle.step, params,
                                        {"tokens": toks}, per_prefill)
    check(tuple(logits.shape) == (batch, cut.vocab), "MoE prefill logits are not (B, V)")
    _reset_launches()
    with torch.no_grad():
        plain = build_prefill_step(cut, shape, None, model=LM(cut, attn_backend="jnp"),
                                   dtype=torch.float32).step(params, {"tokens": toks})
    check(_launches() == zero, "the 'jnp' MoE prefill launched a kernel")
    e = float((logits - plain).abs().max())
    bound = MOE_PREFILL_REL * float(plain.abs().max())
    check(e <= bound, f"MoE prefill logits: 'pallas' and 'jnp' differ by {e:.3e} (bound "
          f"{bound:.3e})")
    print(f"[moe] prefill logits, 'pallas' against 'jnp': max difference {e:.3e} (bound "
          f"{bound:.3e}: two bf16 steps of the largest logit, {float(plain.abs().max()):.3f}); "
          f"{time.perf_counter() - t0:.1f} s into the phase")
    del logits, plain
    # one full-width MoE layer: onehot with a capacity of every choice of its
    # group (nothing drops) against the ragged dispatch
    p0 = moe_mod.MoEParams(*(t[0] for t in params["blocks"]["ffn"]))
    x = torch.randn((batch, layer_seq, cut.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(4))
    with torch.no_grad():
        y1, a1 = moe_mod.moe_forward(p0, x, m, mode="onehot", group_tokens=512,
                                     capacity_factor=m.n_experts / m.top_k)
        y2, a2 = moe_mod.moe_forward(p0, x, m, mode="ragged")
    e = float((y1 - y2).abs().max())
    bound = MOE_PREFILL_REL * float(y2.abs().max())
    check(e <= bound and abs(float(a1) - float(a2)) <= 1e-6 and bool(torch.isfinite(y1).all()),
          f"onehot (no drops) and ragged differ by {e:.3e} (bound {bound:.3e}), aux "
          f"{float(a1)} vs {float(a2)}")
    print(f"[moe] one layer, B {batch} x S {layer_seq}: onehot (capacity {512 * m.top_k}: no "
          f"drops) against ragged: max difference {e:.3e} (bound {bound:.3e}, two bf16 steps), "
          f"aux {float(a1):.6f} and {float(a2):.6f}; {time.perf_counter() - t0:.1f} s into the "
          f"phase")
    del x, y1, y2
    # one train round at microbatch granularity on the first layers: their
    # blocks copied out and the prefill's weights dropped, so the card holds
    # theta_L, the bank and the round's transients
    cut2 = dataclasses.replace(full, n_layers=train_layers)
    p2 = dict(params, blocks=_first_layers(params["blocks"], train_layers))
    p2["blocks"] = {k: (type(v)(*(None if t is None else t.clone() for t in v))
                        if isinstance(v, tuple) else v.clone())
                    for k, v in p2["blocks"].items()}
    del params, bundle, lm
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    n2 = sum(leaf.numel() for leaf in _leaves(p2))
    check(n2 == cut2.param_count(), f"{n2} train parameters")
    print(f"[moe] train: {train_layers} of {full.n_layers} layers, {n2:,} parameters; the ragged "
          f"dispatch (the launcher's)")
    holder = [p2]
    del p2
    _train_step_rounds(torch, dev, "moe", cut2, LM(cut2, moe_mode="ragged"), holder, n_owners,
                       train_batch, train_seq, G, rounds, zero)
    print(f"[moe] {time.perf_counter() - t0:.1f} s into the phase")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return launches


def _prefill_runs(torch, dev, tag, step, params, batch, per_prefill, timed=3, top=6):
    """`timed` prefills step(params, batch) (the first warms up) and one
    under torch.profiler, with the launch counters set to 0 just before and
    read just after: each prefill must launch exactly `per_prefill`.
    Returns (the last logits, ms per prefill (median after the warm-up),
    the launches of all of them)."""
    _reset_launches()
    times = []
    with torch.no_grad():
        for _ in range(timed):
            _sync(torch, dev)
            t1 = time.perf_counter()
            logits = step(params, batch)
            _sync(torch, dev)
            times.append((time.perf_counter() - t1) * 1e3)
        _, busy, groups, kernels = _profiled(torch, dev, lambda: step(params, batch), 1, top=top)
    launches = _launches()
    n = timed + 1
    check(launches == {k: n * v for k, v in per_prefill.items()},
          f"{n} {tag} prefills launched {launches}, expected {n} x {per_prefill}")
    check(bool(torch.isfinite(logits).all()), f"{tag} prefill logits are not finite")
    ms = statistics.median(times[1:])
    B, S = batch["tokens"].shape
    print(f"[{tag}] prefill B {B} x S {S} tokens (attn_backend 'pallas'): "
          f"{', '.join(f'{t:.1f}' for t in times)} ms (the first warms up); "
          f"{B * S / ms * 1e3:,.0f} prefill tokens/s; per prefill "
          + " and ".join(f"{v} {k}" for k, v in per_prefill.items() if v)
          + " launches and no other kernel")
    print(f"[profile] {tag} prefill: device busy {busy:.2f} of {ms:.2f} ms: the device idles "
          f"{1 - busy / ms:.1%}; {kernels:.0f} device kernels; peak memory "
          f"{_peak_gb(torch, dev):.2f} GB; by group "
          + ", ".join(f"{g} {t:.2f} ms" for g, t in sorted(groups.items())))
    return logits, ms, launches


def _against_plain(torch, tag, cfg, shape, params, batch, logits):
    """The same prefill through attn_backend "jnp" (no kernel launch):
    last-position logits within PREFILL_TOL of the kernel path's."""
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import LM
    _reset_launches()
    with torch.no_grad():
        plain = build_prefill_step(cfg, shape, None, model=LM(cfg, attn_backend="jnp"),
                                   dtype=torch.float32).step(params, batch)
    got = _launches()
    check(not any(got.values()), f"the 'jnp' {tag} prefill launched {got}")
    e = float((logits - plain).abs().max())
    check(e <= PREFILL_TOL, f"{tag} prefill logits: 'pallas' and 'jnp' differ by {e:.3e}")
    print(f"[{tag}] prefill logits, 'pallas' against 'jnp': max difference {e:.3e} (bound "
          f"{PREFILL_TOL}; max |logit| {float(plain.abs().max()):.3f})")


def _greedy(torch, dev, tag, lm, params, cache, prompt, gen):
    """launch.serve.greedy_decode at full depth (no kernel launch: the decode
    path reaches none), then one profiled decode step at position 0 of the
    same cache."""
    from repro_torch.launch.serve import greedy_decode
    B, plen = prompt.shape
    _reset_launches()
    _sync(torch, dev)
    t1 = time.perf_counter()
    with torch.no_grad():
        seqs, step_logits = greedy_decode(lm, params, cache, prompt, gen)
    _sync(torch, dev)
    dt = time.perf_counter() - t1
    got = _launches()
    check(not any(got.values()), f"{tag} serving launched {got}")
    check(tuple(seqs.shape) == (B, plen + gen) and torch.equal(seqs[:, :plen], prompt)
          and bool(torch.isfinite(step_logits).all()), f"{tag} greedy decode output")
    steps = plen + gen - 1
    with torch.no_grad():
        _, step_busy, _, step_kernels = _profiled(
            torch, dev, lambda: lm.decode_step(params, cache, prompt[:, :1], 0), 1, top=3)
    ms = dt * 1e3 / steps
    print(f"[{tag}] greedy decode B {B}, prompt {plen}, gen {gen}: {steps} steps in "
          f"{dt * 1e3:.1f} ms, {ms:.2f} ms per step ({B * steps / dt:.1f} tokens/s), no kernel "
          f"launch; one profiled step: {step_kernels:.0f} device kernels, device busy "
          f"{step_busy:.2f} ms (the device idles {1 - step_busy / ms:.1%} of a step)")


# phase vlm: internvl2-2b's prefill of 256 patches and 3,840 text tokens
VLM_DECODE_LAYERS = 6
VLM_DECODE_SEQ = 256


def phase_vlm(torch, dev, cfg=None, batch=PREFILL_B, seq=PREFILL_S,
              decode_layers=VLM_DECODE_LAYERS, decode_seq=VLM_DECODE_SEQ, serve_batch=2,
              prompt_len=16, gen=32):
    """internvl2-2b at full width and depth (random f32 weights drawn on the
    card from a seed): the prefill of `seq` positions (n_patches projected
    patches and seq - n_patches text tokens) through build_prefill_step
    with attn_backend "pallas" (flash on every layer), against "jnp";
    decode on the first `decode_layers` layers against the text-only
    forward of the same weights (the vlm's decode sees no patches, as the
    reference's); greedy serving at full depth. Returns the launches of the
    kernel prefills."""
    import dataclasses
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import LM
    cfg = get_config("internvl2-2b") if cfg is None else cfg
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = LM(cfg, attn_backend="pallas")
    params = lm.init(seed=0, device=dev, generator_device=dev if dev.type == "cuda" else None)
    n_params = sum(leaf.numel() for leaf in _leaves(params))
    check(n_params == cfg.param_count(), f"{n_params} parameters, expected {cfg.param_count()}")
    _sync(torch, dev)
    print(f"[vlm] {cfg.name} ({cfg.source}): {n_params:,} parameters ({n_params * 4 / 1e9:.2f} "
          f"GB f32), {cfg.n_layers} layers, H {cfg.n_heads}, Kv {cfg.n_kv_heads}, hd "
          f"{cfg.head_dim}, {cfg.n_patches} patches; drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    shape = ShapeConfig("vlm_prefill", seq, batch, "prefill")
    bundle = build_prefill_step(cfg, shape, None, model=lm, dtype=torch.float32)
    s_txt = seq - cfg.n_patches
    check({k: tuple(t.shape) for k, t in bundle.args[1].items()}
          == {"tokens": (batch, s_txt), "patches": (batch, cfg.n_patches, cfg.d_model)},
          f"the vlm prefill bundle's batch spec {bundle.args[1]}")
    gen_t = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (batch, s_txt), generator=gen_t, dtype=torch.int32).to(dev)
    patches = torch.randn((batch, cfg.n_patches, cfg.d_model), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(3))
    inputs = {"tokens": toks, "patches": patches}
    zero = {k: 0 for k in FED_KERNELS + MODEL_KERNELS}
    per_prefill = dict(zero, flash_attention=cfg.n_layers)
    logits, _, launches = _prefill_runs(torch, dev, "vlm", bundle.step, params, inputs,
                                        per_prefill)
    check(tuple(logits.shape) == (batch, cfg.vocab), "vlm prefill logits (B, V)")
    _against_plain(torch, "vlm", cfg, shape, params, inputs, logits)
    del logits

    # decode on the first layers against the text-only forward: the dense
    # path over the same blocks, without patch_proj
    cut = dataclasses.replace(cfg, n_layers=decode_layers)
    text = LM(dataclasses.replace(cut, family="dense", n_patches=0), attn_backend="pallas")
    p_text = {k: v for k, v in params.items() if k != "patch_proj"}
    p_text["blocks"] = _first_layers(params["blocks"], decode_layers)
    lm_cut = LM(cut)
    dtoks = toks[:, :decode_seq]
    _reset_launches()
    with torch.no_grad():
        full = torch.einsum("bsd,dv->bsv", text.forward(p_text, {"tokens": dtoks}),
                            text._unembed(p_text))
        got = _launches()
        cache = lm_cut.init_cache(batch, decode_seq, dtype=torch.float32, device=dev)
        err = 0.0
        for t in range(decode_seq):
            lg, cache = lm_cut.decode_step(dict(p_text, patch_proj=params["patch_proj"]), cache,
                                           dtoks[:, t:t + 1], t)
            err = max(err, float((lg[:, 0] - full[:, t]).abs().max()))
    check(got == dict(zero, flash_attention=decode_layers), f"the text forward launched {got}")
    check(_launches() == got, "vlm decode launched a kernel")
    check(err <= DECODE_TOL, f"vlm decode differs from the text forward by {err:.3e}")
    print(f"[vlm] decode against the text-only forward, {decode_layers} layers at full width, "
          f"S {decode_seq}: max |logit difference| {err:.3e} over every position (bound "
          f"{DECODE_TOL})")
    del full, cache, p_text

    total = prompt_len + gen
    prompt = torch.randint(0, cfg.vocab, (serve_batch, prompt_len), generator=gen_t,
                           dtype=torch.int32).to(dev)
    _greedy(torch, dev, "vlm", lm, params,
            lm.init_cache(serve_batch, total, dtype=torch.float32, device=dev), prompt, gen)
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(f"[vlm] {time.perf_counter() - t0:.1f} s into the phase")
    return launches


# phase audio: whisper-medium's decoder context (448 tokens) against its
# 1,500 encoder frames
AUDIO_SEQ = 448
AUDIO_DECODE_LAYERS = 6
AUDIO_DECODE_SEQ = 128


def phase_audio(torch, dev, cfg=None, batch=4, seq=AUDIO_SEQ,
                decode_layers=AUDIO_DECODE_LAYERS, decode_seq=AUDIO_DECODE_SEQ, serve_batch=2,
                prompt_len=16, gen=32, n_owners=4,
                train_batch=4, G=2, rounds=2):
    """whisper-medium at full width and depth (random f32 weights drawn on
    the card from a seed, frames from the stub frontend drawn from a seed):
    the prefill through build_prefill_step with attn_backend "pallas" (flash
    on every decoder self-attention; the encoder and the cross-attention
    are plain torch, as in the reference) against "jnp"; the encoder alone,
    timed; prime_cross_cache, then decode on the first `decode_layers`
    decoder layers against the forward; greedy serving at full depth; one
    build_train_step round at microbatch granularity (G pre-grouped
    microbatches, the frames in the batch). Returns the launches of the
    kernel prefills."""
    import dataclasses
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import LM
    cfg = get_config("whisper-medium") if cfg is None else cfg
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = LM(cfg, attn_backend="pallas")
    params = lm.init(seed=0, device=dev, generator_device=dev if dev.type == "cuda" else None)
    n_params = sum(leaf.numel() for leaf in _leaves(params))
    check(n_params == cfg.param_count(), f"{n_params} parameters, expected {cfg.param_count()}")
    _sync(torch, dev)
    print(f"[audio] {cfg.name} ({cfg.source}): {n_params:,} parameters ({n_params * 4 / 1e9:.2f} "
          f"GB f32), {cfg.enc_layers} encoder and {cfg.n_layers} decoder layers, H = Kv = "
          f"{cfg.n_heads}, hd {cfg.head_dim}, {cfg.enc_seq} frames; drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    shape = ShapeConfig("audio_prefill", seq, batch, "prefill")
    bundle = build_prefill_step(cfg, shape, None, model=lm, dtype=torch.float32)
    check({k: tuple(t.shape) for k, t in bundle.args[1].items()}
          == {"tokens": (batch, seq), "frames": (batch, cfg.enc_seq, cfg.d_model)},
          f"the audio prefill bundle's batch spec {bundle.args[1]}")
    gen_t = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab, (batch, seq), generator=gen_t, dtype=torch.int32).to(dev)
    frames = torch.randn((batch, cfg.enc_seq, cfg.d_model), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(4))
    inputs = {"tokens": toks, "frames": frames}
    zero = {k: 0 for k in FED_KERNELS + MODEL_KERNELS}
    per_prefill = dict(zero, flash_attention=cfg.n_layers)
    logits, ms, launches = _prefill_runs(torch, dev, "audio", bundle.step, params, inputs,
                                         per_prefill)
    check(tuple(logits.shape) == (batch, cfg.vocab), "audio prefill logits (B, V)")
    _against_plain(torch, "audio", cfg, shape, params, inputs, logits)
    del logits
    times = []
    with torch.no_grad():
        for _ in range(3):
            _sync(torch, dev)
            t1 = time.perf_counter()
            enc = lm._encode(params, frames)
            _sync(torch, dev)
            times.append((time.perf_counter() - t1) * 1e3)
    enc_ms = statistics.median(times[1:])
    print(f"[audio] the encoder alone (B {batch} x {cfg.enc_seq} frames, {cfg.enc_layers} layers "
          f"of plain bidirectional attention and GELU MLPs): {enc_ms:.1f} ms, "
          f"{enc_ms / ms:.1%} of a prefill")
    del enc

    # prime the cross cache, then decode the first layers against the forward
    cut = dataclasses.replace(cfg, n_layers=decode_layers)
    lm_cut = LM(cut, attn_backend="pallas")
    p_cut = dict(params, blocks=_first_layers(params["blocks"], decode_layers))
    dtoks = toks[:, :decode_seq]
    _reset_launches()
    with torch.no_grad():
        full = torch.einsum("bsd,dv->bsv", lm_cut.forward(p_cut, {"tokens": dtoks,
                                                                  "frames": frames}),
                            lm_cut._unembed(p_cut))
        got = _launches()
        cache = lm_cut.prime_cross_cache(
            p_cut, lm_cut.init_cache(batch, decode_seq, dtype=torch.float32, device=dev), frames)
        err = 0.0
        for t in range(decode_seq):
            lg, cache = lm_cut.decode_step(p_cut, cache, dtoks[:, t:t + 1], t)
            err = max(err, float((lg[:, 0] - full[:, t]).abs().max()))
    check(got == dict(zero, flash_attention=decode_layers), f"the audio forward launched {got}")
    check(_launches() == got, "prime_cross_cache or decode launched a kernel")
    check(err <= DECODE_TOL, f"audio decode differs from the forward by {err:.3e}")
    print(f"[audio] prime_cross_cache, then decode against the forward, {decode_layers} decoder "
          f"layers at full width, S {decode_seq}: max |logit difference| {err:.3e} over every "
          f"position (bound {DECODE_TOL})")
    del full, cache, p_cut

    total = prompt_len + gen
    prompt = torch.randint(0, cfg.vocab, (serve_batch, prompt_len), generator=gen_t,
                           dtype=torch.int32).to(dev)
    with torch.no_grad():
        cache = lm.prime_cross_cache(
            params, lm.init_cache(serve_batch, total, dtype=torch.float32, device=dev),
            frames[:serve_batch])
    _greedy(torch, dev, "audio", lm, params, cache, prompt, gen)
    del cache, bundle

    # one train round at microbatch granularity ("jnp" attention: flash has
    # no backward, as in the reference)
    print(f"[audio] train: full depth, {cfg.n_layers} decoder and {cfg.enc_layers} encoder "
          f"layers, {n_params:,} parameters")
    mb_frames = torch.randn((G, train_batch // G, cfg.enc_seq, cfg.d_model), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(5))
    holder = [params]
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    _train_step_rounds(torch, dev, "audio", cfg, LM(cfg), holder, n_owners, train_batch, seq,
                       G, rounds, zero, extra={"frames": mb_frames})
    del mb_frames
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(f"[audio] {time.perf_counter() - t0:.1f} s into the phase")
    return launches


# phase zoo: the three dense archs registered last, at full width, each cut
# to 2 layers to fit one card beside its embedding (qwen1.5-110b: 5.21 B
# leaves, 20.8 GB f32)
ZOO_ARCHS = ("granite-20b", "command-r-35b", "qwen1.5-110b")
ZOO_LAYERS = 2


def phase_zoo(torch, dev, cfgs=None, layers=ZOO_LAYERS, batch=PREFILL_B, seq=PREFILL_S):
    """Each of ZOO_ARCHS (or `cfgs`) at full width cut to `layers` layers (random f32
    weights drawn on the card from a seed): a prefill through
    build_prefill_step with attn_backend "pallas" (one flash launch a
    layer; granite's MQA, command-r's tied embedding and RoPE theta 8e6,
    qwen1.5's qkv bias) twice (the first warms up) and once profiled,
    against "jnp"; each model freed before the next is drawn. Returns the
    launches."""
    import dataclasses
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import LM
    zero = {k: 0 for k in FED_KERNELS + MODEL_KERNELS}
    total = dict(zero)
    for full in cfgs or [get_config(a) for a in ZOO_ARCHS]:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        arch = full.name
        cut = dataclasses.replace(full, n_layers=layers)
        lm = LM(cut, attn_backend="pallas")
        params = lm.init(seed=0, device=dev, generator_device=dev if dev.type == "cuda" else None)
        n_params = sum(leaf.numel() for leaf in _leaves(params))
        check(n_params == cut.param_count(), f"{arch}: {n_params} parameters, expected "
              f"{cut.param_count()}")
        shape = ShapeConfig("zoo_prefill", seq, batch, "prefill")
        bundle = build_prefill_step(cut, shape, None, model=lm, dtype=torch.float32)
        toks = torch.randint(0, cut.vocab, (batch, seq), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(6)).to(dev)
        _sync(torch, dev)
        print(f"[zoo] {arch} ({full.source}) at full width, {layers} of {full.n_layers} layers: "
              f"{n_params:,} parameters ({n_params * 4 / 1e9:.2f} GB f32; all layers "
              f"{full.param_count():,}), H {cut.n_heads}, Kv {cut.n_kv_heads}, hd "
              f"{cut.head_dim}, qkv_bias {cut.qkv_bias}, tied {cut.tie_embeddings}, theta "
              f"{cut.rope_theta:g}; drawn on the card in {time.perf_counter() - t0:.1f} s")
        per_prefill = dict(zero, flash_attention=layers)
        logits, _, launches = _prefill_runs(torch, dev, f"zoo {arch}", bundle.step, params,
                                            {"tokens": toks}, per_prefill, timed=2)
        check(tuple(logits.shape) == (batch, cut.vocab), f"{arch} prefill logits (B, V)")
        for k, v in launches.items():
            total[k] += v
        _against_plain(torch, f"zoo {arch}", cut, shape, params, {"tokens": toks}, logits)
        del params, logits, bundle, lm
        print(f"[zoo] {arch}: {time.perf_counter() - t0:.1f} s, peak memory "
              f"{_peak_gb(torch, dev):.2f} GB")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return total


# phase meshzoo: the archs served on the 1x1 mesh at full width, with their
# flash and SSD launches per prefill (yi-6b: 32 layers; zamba2: 9 shared
# attention blocks, 54 Mamba2 layers), and the greedy decode's prompt and gen
MESHZOO_ARCHS = (("yi-6b", {"flash_attention": 32}),
                 ("zamba2-2.7b", {"flash_attention": 9, "ssd_chunk_scan": 54}))
MESHZOO_PROMPT, MESHZOO_GEN = 4, 5


def _analytic_prefill_flops(cfg, B, S):
    """A dense LM's prefill: 2 x its matmul parameters x tokens, the
    unembedding of the B last positions, and flash's causal work."""
    d, H, Kv, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    per_layer = d * H * hd + 2 * d * Kv * hd + H * hd * d + 3 * d * f
    return (2 * cfg.n_layers * per_layer * B * S + 2 * B * d * cfg.vocab
            + cfg.n_layers * 4 * B * H * hd * S * (S + 1) // 2)


def phase_meshzoo(torch, dev, cfgs=None, batch=PREFILL_B, seq=PREFILL_S,
                  prompt_len=MESHZOO_PROMPT, gen=MESHZOO_GEN):
    """The model zoo's prefill and decode on the 1x1 mesh of a world of one
    (NCCL on the card, gloo on the CPU) against their unmeshed twins, bit
    for bit, at full width (the module docstring); `cfgs` overrides the
    configs (a CPU rehearsal passes reduced ones, with their launches).
    Returns the launches of the meshed prefills."""
    import torch.distributed as dist
    from repro_torch.analysis.op_cost import OpCost
    from repro_torch.analysis.roofline import PEAK_FLOPS
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import greedy_decode
    from repro_torch.launch.steps import build_prefill_step, build_serve_step, place
    from repro_torch.models import LM
    on_card = dev.type == "cuda"
    mesh = make_host_mesh(device_type=dev.type)
    zero = {k: 0 for k in FED_KERNELS + MODEL_KERNELS}
    total = dict(zero)
    try:
        for cfg, per_prefill in cfgs or [(get_config(a), k) for a, k in MESHZOO_ARCHS]:
            per_prefill = dict(zero, **per_prefill) if on_card else dict(zero)
            t0 = time.perf_counter()
            if on_card:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            lm = LM(cfg, attn_backend="pallas")
            params = lm.init(seed=0, device=dev, generator_device=dev if on_card else None)
            shape = ShapeConfig("meshzoo_prefill", seq, batch, "prefill")
            plain = build_prefill_step(cfg, shape, None, model=lm, dtype=torch.float32)
            meshed = build_prefill_step(cfg, shape, mesh, model=lm, dtype=torch.float32)
            toks = torch.randint(0, cfg.vocab, (batch, seq), dtype=torch.int32,
                                 generator=torch.Generator().manual_seed(8)).to(dev)
            batch_in = {"tokens": toks}
            print(f"[meshzoo] {cfg.name} at full width and depth ({cfg.param_count():,} "
                  f"parameters, f32, H {cfg.n_heads}, Kv {cfg.n_kv_heads}, hd {cfg.head_dim}) "
                  f"on the mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}; drawn in "
                  f"{time.perf_counter() - t0:.1f} s")
            with torch.no_grad():
                times, logits = [], None
                for _ in range(2):
                    _sync(torch, dev)
                    t1 = time.perf_counter()
                    logits = plain.step(params, batch_in)
                    _sync(torch, dev)
                    times.append((time.perf_counter() - t1) * 1e3)
                if cfg.family == "dense":
                    with OpCost() as counter:
                        counted = plain.step(params, batch_in)
                    check(torch.equal(counted, logits),
                          f"{cfg.name}: the counter changed the prefill's logits")
                    flops = counter.summary()["flops"]
                    want = _analytic_prefill_flops(cfg, batch, seq)
                    # (on the CPU the plain attention multiplies the whole S x S)
                    check(abs(flops / want - 1) < 5e-3 or not on_card, f"{cfg.name}: counted "
                          f"{flops:.6e} FLOPs against the analytic {want:.6e}")
                    rate = flops / (times[-1] / 1e3)
                    print(f"[meshzoo] {cfg.name} prefill under the counter: {flops:.6e} FLOPs "
                          f"counted (analytic {want:.6e}, {flops / want - 1:+.4%}), logits bit "
                          f"for bit without it; the prefill took {times[-1]:.1f} ms unmeshed: "
                          f"{rate / 1e12:.2f} TFLOP/s achieved, {rate / PEAK_FLOPS['float32']:.1%} "
                          f"of the f32 peak (67 TFLOP/s)")
                args = place(meshed.in_shardings, params, batch_in)
                m_times = []
                _reset_launches()
                for _ in range(2):
                    _sync(torch, dev)
                    t1 = time.perf_counter()
                    m_logits = meshed.step(*args)
                    _sync(torch, dev)
                    m_times.append((time.perf_counter() - t1) * 1e3)
                launches = _launches()
            check(launches == {k: 2 * v for k, v in per_prefill.items()},
                  f"{cfg.name}: 2 meshed prefills launched {launches}, expected 2 x {per_prefill}")
            for k, v in launches.items():
                total[k] += v
            check(torch.equal(m_logits.full_tensor(), logits),
                  f"{cfg.name}: the meshed prefill's logits differ from the unmeshed twin's")
            print(f"[meshzoo] {cfg.name} prefill B {batch} x S {seq}: unmeshed "
                  f"{', '.join(f'{t:.1f}' for t in times)} ms, meshed (DTensors, "
                  f"{type(m_logits).__name__} logits {tuple(m_logits.placements)}) "
                  f"{', '.join(f'{t:.1f}' for t in m_times)} ms (the first of each warms up); "
                  f"logits bit for bit; per meshed prefill "
                  + " and ".join(f"{v} {k}" for k, v in per_prefill.items() if v)
                  + " launches and no other kernel")
            del logits, m_logits
            dshape = ShapeConfig("meshzoo_decode", prompt_len + gen, batch, "decode")
            prompt = toks[:, :prompt_len]
            serve = build_serve_step(cfg, dshape, mesh, model=lm, dtype=torch.float32)

            def decode(step, p, cache):
                _sync(torch, dev)
                t1 = time.perf_counter()
                with torch.no_grad():
                    seqs, step_logits = greedy_decode(lm, p, cache, prompt, gen, step=step)
                _sync(torch, dev)
                return seqs, step_logits, (time.perf_counter() - t1) * 1e3

            def cache():
                return lm.init_cache(batch, dshape.seq_len, dtype=torch.float32, device=dev)
            out = [decode(None, params, cache()),
                   decode(serve.step, args[0], place(serve.in_shardings[1:2], cache())[0])]
            (s0, l0, ms0), (s1, l1, ms1) = out
            steps = prompt_len + gen - 1
            check(torch.equal(s0, s1) and torch.equal(l0, l1),
                  f"{cfg.name}: the meshed greedy decode differs from the unmeshed twin's")
            print(f"[meshzoo] {cfg.name} greedy decode B {batch}, prompt {prompt_len}, gen {gen}: "
                  f"{steps} steps, unmeshed {ms0 / steps:.2f} ms a step, meshed {ms1 / steps:.2f} "
                  f"ms a step; tokens and every step's logits bit for bit")
            del params, args, plain, meshed, serve, lm, out
            print(f"[meshzoo] {cfg.name}: {time.perf_counter() - t0:.1f} s, peak memory "
                  f"{_peak_gb(torch, dev):.2f} GB")
    finally:
        dist.destroy_process_group()
    if on_card:
        torch.cuda.empty_cache()
    return total


# phase meshtrain: phase train's model (zamba2-2.7b at full width, its first
# TRAIN_LAYERS Mamba2 layers) under launch.steps.build_train_step on the 1x1
# mesh, at the reference's default bf16 leaves
MESHTRAIN_ROUNDS = 3             # timed rounds a setting, after one warm-up


def _meshtrain_bundle(torch, dev, cfg, mesh, acfg, n_owners, batch, seq, remat):
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import LM
    return build_train_step(cfg, ShapeConfig("meshtrain", seq, batch, "train"), mesh,
                            model=LM(cfg, remat=remat), async_cfg=acfg, dtype=torch.bfloat16,
                            device=dev)


def _meshtrain_state(torch, dev, cfg, mesh, acfg, params):
    from repro_torch.federation.deep import init_state
    from repro_torch.sharding import rules
    specs = None if mesh is None else rules.param_specs(params, cfg, mesh)
    return init_state(params, acfg, device=dev, mesh=mesh, specs=specs)


def phase_meshtrain(torch, dev, cfg=None, n_owners=4, batch=4, seq=1024, G=2,
                    rounds=MESHTRAIN_ROUNDS):
    """The launcher's training round on the 1x1 mesh of a world of one
    (NCCL on the card, gloo on the CPU): build_train_step(mesh=) over
    zamba2-2.7b at full width and TRAIN_LAYERS deep, bf16 leaves (the
    reference's default), 4 owners, batch 4 x S 1024 in G = 2 pre-grouped
    microbatches, attn_backend "jnp" (flash has no backward).

    Parity: with fused_kernel False (the reference's random.laplace draw)
    and True (sqnorm and the block scale_noise), one meshed round against
    its unmeshed twin: theta_L, the owner's bank row, step and the metrics
    bit for bit, and each rank's bank piece (N, *block). Launches a round:
    remat on, 2 x G x layers ssd_chunk_scan (the forward and the
    backward's recompute) and G x layers ssd_chunk_scan_bwd; remat off, G
    x layers of each; fused, G x leaves sqnorm and leaves scale_noise.
    Then, fused, remat on and off, `rounds` timed rounds after a warm-up
    and one profiled (device busy, idle share, peak memory). Returns the
    launches of the meshed rounds (the counters set to 0 before the first
    one). `cfg` overrides the config (a CPU rehearsal passes a reduced
    one; launches are then not checked)."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch import random
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import default_async_cfg, place
    from repro_torch.models import LM
    from repro_torch.sharding import spmd
    if cfg is None:
        cfg = dataclasses.replace(get_config("zamba2-2.7b"), n_layers=TRAIN_LAYERS)
    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    mesh = make_host_mesh(device_type=dev.type)
    total = {k: 0 for k in FED_KERNELS + MODEL_KERNELS}
    try:
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        params = LM(cfg).init(seed=0, device=dev, dtype=torch.bfloat16,
                              generator_device=dev if on_card else None)
        n_leaves = len(_leaves(params))
        n_params = sum(x.numel() for x in _leaves(params))
        layers = _scan_layers(cfg)
        batches = _round_batches(torch, cfg, rounds + 2, batch, seq, G, dev, seed=9)
        key = random.PRNGKey(13, device=dev)
        print(f"[meshtrain] {cfg.name} at full width, {cfg.n_layers} layers ({n_params:,} "
              f"bf16 parameters, {n_leaves} leaves) on the mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}; {n_owners} owners, batch "
              f"{batch} x S {seq}, G = {G}; drawn in {time.perf_counter() - t0:.1f} s")

        def want(remat, fused):
            per = dict.fromkeys(total, 0)
            per["ssd_chunk_scan"] = (2 if remat else 1) * G * layers
            per["ssd_chunk_scan_bwd"] = G * layers
            if fused:
                per["sqnorm"], per["scale_noise"] = G * n_leaves, n_leaves
            return per

        def counted(tag, per, run):
            before = _launches()
            out = run()
            _sync(torch, dev)
            got = _diff(_launches(), before)
            check(got == per or not on_card, f"a {tag} round launched {got}, expected {per}")
            return out, got

        # parity: one round of each privatizer, meshed against the unmeshed twin
        _reset_launches()
        for fused in (False, True):
            a = default_async_cfg(n_owners=n_owners, n_microbatches=G)
            acfg = dataclasses.replace(a, privatizer=dataclasses.replace(
                a.privatizer, fused_kernel=fused))
            owner = torch.tensor([1], dtype=torch.int32, device=dev)
            out = {}
            for m in (None, mesh):
                bundle = _meshtrain_bundle(torch, dev, cfg, m, acfg, n_owners, batch, seq,
                                           True)
                state = _meshtrain_state(torch, dev, cfg, m, acfg, params)
                b = batches[0] if m is None else place(bundle.in_shardings[1:2], batches[0])[0]
                (state, met), got = counted(f"{'meshed' if m else 'unmeshed'} parity",
                                            want(True, fused),
                                            lambda: bundle.step(state, b, owner, key))  # dpcheck: ignore[DPC105]
                if m is not None:
                    for k in total:
                        total[k] += got[k]
                out[m is not None] = (
                    [spmd.plain(x) if not spmd.is_dtensor(x) else x.to_local()
                     for x in _leaves(state.theta_L)],
                    [(x.to_local() if spmd.is_dtensor(x) else x)[1] for x in _leaves(state.bank)],
                    spmd.plain(state.step), {k: spmd.plain(v) for k, v in met.items()},
                    [tuple(x.to_local().shape) if spmd.is_dtensor(x) else tuple(x.shape)
                     for x in _leaves(state.bank)])
                del state, bundle, b
            (tl, rows, step, met, shapes), (tl2, rows2, step2, met2, shapes2) = out[False], out[True]
            check(all(torch.equal(x, y) for x, y in zip(tl, tl2)) and len(tl) == len(tl2),
                  f"fused={fused}: the meshed theta_L differs from the unmeshed twin's")
            check(all(torch.equal(x, y) for x, y in zip(rows, rows2)),
                  f"fused={fused}: the meshed owner's bank row differs from the twin's")
            check(int(step) == int(step2) == 1 and sorted(met) == sorted(met2)
                  and all(torch.equal(met[k], met2[k]) for k in met),
                  f"fused={fused}: the meshed step or metrics differ from the twin's")
            check(shapes == shapes2, "a rank's bank piece is not (N, *block)")
            print(f"[meshtrain] fused_kernel={fused}: one meshed round == its unmeshed twin bit "
                  f"for bit (theta_L, the owner's bank row, step, metrics; clip_frac "
                  f"{float(met['clip_frac']):.2f}, max_grad_norm "
                  f"{float(met['max_grad_norm']):.4e}); launches "
                  + json.dumps({k: v for k, v in want(True, fused).items() if v}))
            del out, tl, tl2, rows, rows2
            if on_card:
                torch.cuda.empty_cache()

        # timing: the fused round with remat on and off, and the unmeshed
        # twin's with remat on
        a = default_async_cfg(n_owners=n_owners, n_microbatches=G)
        acfg = dataclasses.replace(a, privatizer=dataclasses.replace(a.privatizer,
                                                                     fused_kernel=True))
        twin = _meshtrain_bundle(torch, dev, cfg, None, acfg, n_owners, batch, seq, True)
        holder = [_meshtrain_state(torch, dev, cfg, None, acfg, params)]
        twin_ms = []
        for r in range(rounds + 1):
            owner = torch.tensor([r % n_owners], dtype=torch.int32, device=dev)
            _sync(torch, dev)
            t1 = time.perf_counter()
            (new, _), _ = counted("unmeshed timed", want(True, True), lambda: twin.step(
                holder.pop(), batches[1 + r], owner, random.fold_in(key, r)))
            twin_ms.append((time.perf_counter() - t1) * 1e3)
            holder.append(new)
            del new
        del holder, twin
        print(f"[meshtrain] the unmeshed twin, remat=True, fused: rounds "
              f"{', '.join(f'{t:.1f}' for t in twin_ms)} ms (the first warms up), median "
              f"{statistics.median(twin_ms[1:]):.1f} ms")
        for remat in (True, False):
            if on_card:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            bundle = _meshtrain_bundle(torch, dev, cfg, mesh, acfg, n_owners, batch, seq, remat)
            holder = [_meshtrain_state(torch, dev, cfg, mesh, acfg, params)]
            placed = [place(bundle.in_shardings[1:2], b)[0] for b in batches[1:]]
            per = want(remat, True)
            times, k = [], key
            for r in range(rounds + 1):
                k, sub = random.split(k)
                owner = torch.tensor([r % n_owners], dtype=torch.int32, device=dev)
                _sync(torch, dev)
                t1 = time.perf_counter()
                # the step consumes the state: only the new one stays referenced
                (new, met), got = counted(
                    "timed", per, lambda: bundle.step(holder.pop(), placed[r], owner, sub))
                times.append((time.perf_counter() - t1) * 1e3)
                holder.append(new)
                del new
                for name in total:
                    total[name] += got[name]
            k, sub = random.split(k)
            owner = torch.tensor([0], dtype=torch.int32, device=dev)
            (res, got), busy, groups, kernels = _profiled(
                torch, dev, lambda: counted("profiled", per, lambda: bundle.step(
                    holder.pop(), placed[rounds], owner, sub)), 1, top=6, cpu_ops=False)
            for name in total:
                total[name] += got[name]
            state = res[0]
            check(int(spmd.plain(state.step)) == rounds + 2
                  and all(bool(torch.isfinite(x.to_local()).all())
                          for x in _leaves(state.theta_L)),
                  f"the meshed state after {rounds + 2} rounds (remat={remat})")
            ms = statistics.median(times[1:])
            print(f"[meshtrain] remat={remat}, fused: rounds "
                  f"{', '.join(f'{t:.1f}' for t in times)} ms (the first warms up), median "
                  f"{ms:.1f} ms; device busy {busy:.2f} ms, the device idles "
                  f"{1 - busy / ms:.1%}, {kernels:.0f} device kernels a round; peak memory "
                  f"{_peak_gb(torch, dev):.2f} GB")
            del state, res, bundle, placed
        del params, batches
    finally:
        dist.destroy_process_group()
    if on_card:
        torch.cuda.empty_cache()
    print(f"[meshtrain] launches of the meshed rounds: "
          + json.dumps({k: v for k, v in total.items() if v})
          + f"; the phase took {time.perf_counter() - t0:.1f} s")
    return total


# phase meshfed: DENSE_124M at full width and depth on the 1x1 mesh, as
# phases main and pytree run it: 16 owners for the fused privatizer's
# dispatches, 4 for the tree, the fault-armed and the per-example ones
MESHFED_K = 4                    # rounds a dispatch (the fault-armed ones: 2 x)
# timed dispatches of each of twin and meshed, in turns (twin first); one
# keeps the phase near its 60 s (68.4 s with two on a slow host)
MESHFED_TIMED = 1


def _meshfed_tensors(state, metrics):
    """{name: tensor} of every tensor of a pytree state (a DTensor as this
    rank's block) and of its metrics."""
    from repro_torch.sharding import spmd

    def loc(t):
        return t.to_local() if spmd.is_dtensor(t) else t
    out = {f"theta{i}": loc(x) for i, x in enumerate(_leaves(state.theta_L))}
    out.update({f"bank{i}": loc(x) for i, x in enumerate(_leaves(state.bank))})
    out["step"] = state.step
    out.update({f"ledger.{c}": getattr(state.ledger, c) for c in FAULT_COLUMNS + ("cap",)})
    if state.tree is not None:
        out.update({f"nodes{i}": loc(x) for i, x in enumerate(_leaves(state.tree.nodes))})
        out["counts"] = state.tree.counts
    for part in ("faults", "stale"):
        sub = getattr(state, part)
        if sub is not None:
            out.update({f"{part}.{k}": v for k, v in sub._asdict().items()})
    out.update({f"metric.{k}": loc(v) for k, v in metrics.items()})
    return out


def _same_bits(torch, a, b):
    """a and b hold the same bits (NaN payloads included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def _example_close(torch, a, b):
    """PR 25's bound for per-example clipping: the floats within rtol 1e-4
    plus 1e-5 of the array's largest magnitude, the rest exact."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return bool(torch.equal(a, b))
    if a.numel() == 0:
        return True
    big = float(b.abs().max())
    return bool(((a - b).abs() <= 1e-4 * b.abs() + 1e-5 * big).all())


def phase_meshfed(torch, dev, cfg=None, n_owners=16, small_owners=4, batch=4, seq=128, G=2,
                  K=MESHFED_K, timed=MESHFED_TIMED):
    """Every driver on a pytree state on the 1x1 mesh of a world of one
    (NCCL on the card, gloo on the CPU): DENSE_124M at full width and depth
    (P = 152,783,616 f32, 12 leaves), main's batch 4 x 128 in G = 2
    pre-grouped microbatches, remat off, the state built by
    `deep.init_state(..., mesh=, specs=)` (theta_L, the bank and the nodes
    DTensors; each rank holds (N, *block) of the bank and (N, d, *block)
    of the nodes) against its unmeshed twin from the same params, batches,
    owners, keys and fault codes:

      (a) the fused privatizer, `n_owners` owners (a 9.78 GB bank at 16):
          one make_fused_rounds and one make_group_rounds dispatch of K
          rounds, each bit for bit against its twin (theta_L, every bank
          leaf, step, the ledger, the metrics), with G x 12 sqnorm and 12
          scale_noise launches a round; then `timed` dispatches of each
          timed in turns (twin, meshed, then meshed, twin: wall ms a round)
          and one meshed dispatch profiled (device ms, idle share, peak
          memory);
      (b) the tree at depth 2 with the reference's random.laplace
          privatizer, `small_owners` owners (nodes 4 x 2 x P x 4 B = 4.89 GB
          a state), one fused-driver dispatch: bit for bit (the nodes and
          counts too), no kernel launched;
      (c) FaultPolicy(FAULTS_POLICY) + StalenessPolicy(FAULTS_RUNTIME)
          with the fused privatizer, `small_owners` owners, 2K rounds whose
          fault codes hold every code: the sequential and the grouped
          driver each bit for bit against its twin (the fault and runtime
          columns too), the ledger's fault columns and the counters equal
          to the host replay (`_Replay`), the stored checksums equal to
          `bank_checksums` of the meshed bank;
      (d) example granularity with the fused privatizer, `small_owners`
          owners, K / 2 rounds of the sequential driver: the meshed
          per-example gradients are batch-of-one backward passes (vmap
          does not pass through DTensors), held to PR 25's bound (rtol
          1e-4 plus 1e-5 of each array's largest magnitude; the integer
          state and clip_frac exact), 12 scale_noise launches a round.

    Returns the launches of the meshed dispatches alone (each counted from
    0 before it; the twins' launches are checked but not added). The twin
    and the meshed dispatch of a parity pair each re-derive their round
    keys from one seed on purpose, so the same key material is drawn twice;
    dpcheck's DPC1xx rules do not follow a key re-derived from a seed, so
    this reuse is declared here rather than marked. `cfg` overrides the config (a CPU rehearsal passes a
    reduced one; launches are then not checked)."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch import random
    from repro_torch.configs.base import DENSE_124M
    from repro_torch.federation import faults as F
    from repro_torch.federation import schedules
    from repro_torch.federation.deep import (init_state, make_fused_rounds,
                                             make_group_rounds)
    from repro_torch.federation.staleness import StalenessPolicy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import default_async_cfg
    from repro_torch.models import LM
    from repro_torch.sharding import rules, spmd
    cfg = DENSE_124M if cfg is None else cfg
    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    mesh = make_host_mesh(device_type=dev.type)
    total = dict.fromkeys(FED_KERNELS + MODEL_KERNELS, 0)
    try:
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        lm = LM(cfg, remat=False)
        # drawn on the card (the twin and the meshed state share them)
        params = lm.init(seed=0, device=dev, generator_device=dev if on_card else None)
        n_leaves = len(_leaves(params))
        P = sum(x.numel() for x in _leaves(params))
        specs = rules.param_specs(params, cfg, mesh)

        def loss_fn(p, b):
            return lm.loss(p, b)[0]

        def acfg(n, fused, example=False, **kw):
            a = default_async_cfg(n_owners=n, n_microbatches=G)
            priv = dataclasses.replace(a.privatizer, fused_kernel=fused)
            if example:
                priv = dataclasses.replace(priv, granularity="example", pre_grouped=False)
            return dataclasses.replace(a, privatizer=priv, **kw)

        def fresh(a, meshed):
            return init_state(params, a, device=dev, mesh=mesh if meshed else None,
                              specs=specs if meshed else None)

        def batches_of(k, seed, example=False):
            rng = np.random.default_rng(seed)
            shape = (k, batch, seq) if example else (k, G, batch // G, seq)
            toks = rng.integers(0, cfg.vocab, shape, dtype=np.int32)
            return {"tokens": torch.from_numpy(toks).to(dev),
                    "labels": torch.from_numpy(np.roll(toks, -1, axis=-1)).to(dev)}

        def dispatch(driver, a, state, b, owners, seed, codes=None):
            """One dispatch under the round keys split from PRNGKey(seed):
            the twin and the meshed state each derive the same keys."""
            run = (make_fused_rounds if driver == "fused" else make_group_rounds)(
                loss_fn, a, device=dev)
            args = (state, b, owners, random.split(random.PRNGKey(seed, device=dev),
                                                   owners.numel()))
            if driver == "group":
                args += schedules.pack_groups(schedules.partition_conflict_free(
                    owners.cpu().numpy()))
            return run(*args, fault_codes=codes)

        def counted(tag, per, run, tally=True):
            """run(), its launches checked against `per`; added to the
            phase's total only where `tally` (a meshed dispatch)."""
            before = _launches()
            out = run()
            _sync(torch, dev)
            got = _diff(_launches(), before)
            check(got == per or not on_card, f"meshfed: {tag} launched {got}, expected {per}")
            for name in total:
                total[name] += got[name] if tally else 0
            return out

        def want(k, fused, example=False):
            per = dict.fromkeys(total, 0)
            if fused:
                per["sqnorm"] = 0 if example else k * G * n_leaves
                per["scale_noise"] = k * n_leaves
            return per

        def parity(tag, a, driver, b, owners, seed, codes=None, close=None):
            """The twin's dispatch, then the meshed one, from the same seed;
            their tensors compared (bit for bit, or by `close`). Returns the
            meshed (state, metrics) and the twin's."""
            twin = dispatch(driver, a, fresh(a, False), b, owners, seed, codes)
            _sync(torch, dev)
            meshed = counted(f"the meshed {tag}", want(len(owners), a.privatizer.fused_kernel,
                                                       a.privatizer.granularity == "example"),
                             lambda: dispatch(driver, a, fresh(a, True), b, owners, seed,
                                              codes))
            got, ref = _meshfed_tensors(*meshed), _meshfed_tensors(*twin)
            same = close or (lambda x, y: _same_bits(torch, x, y))
            bad = sorted(k for k in ref if k not in got or not same(got[k], ref[k]))
            check(not bad and sorted(got) == sorted(ref),
                  f"meshfed: {tag} differs from its unmeshed twin in {bad[:8]}")
            shapes = [tuple(x.to_local().shape) for x in _leaves(meshed[0].bank)]
            check(shapes == [(a.n_owners,) + tuple(x.to_local().shape)
                             for x in _leaves(meshed[0].theta_L)],
                  "meshfed: a rank's bank piece is not (N, *block)")
            return meshed, twin

        print(f"[meshfed] {cfg.name} ({P:,} f32 parameters, {n_leaves} leaves) on the mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}; batch {batch} x S {seq}, "
              f"G = {G}; drawn in {time.perf_counter() - t0:.1f} s")
        key = random.PRNGKey(21, device=dev)

        # (a) the fused privatizer, both K-round drivers, then timing
        a = acfg(n_owners, True)
        owners = torch.tensor([(3 * k + 1) % n_owners for k in range(K)], dtype=torch.int32,
                              device=dev)
        b = batches_of(K, 31)
        for driver in ("fused", "group"):
            t1 = time.perf_counter()
            (ms_state, _), twin = parity(f"{driver} dispatch (fused privatizer, {n_owners} "
                                         f"owners)", a, driver, b, owners, 41)
            check(int(ms_state.step) == K, f"meshfed: the {driver} dispatch granted "
                  f"{int(ms_state.step)} of {K} rounds")
            print(f"[meshfed] (a) {driver}: one dispatch of K = {K} on {n_owners} owners "
                  f"(a {_bank_summary(torch, ms_state.bank, n_owners, P)}) == its unmeshed "
                  f"twin bit for bit (theta_L, the bank, step, ledger, metrics); launches a "
                  f"dispatch "
                  + json.dumps({k: v for k, v in want(K, True).items() if v})
                  + f"; twin and meshed {time.perf_counter() - t1:.1f} s")
            del ms_state, twin
        states = {False: fresh(a, False), True: fresh(a, True)}
        times = {False: [], True: []}
        run_fused = make_fused_rounds(loss_fn, a, device=dev)
        for i, meshed in enumerate([False, True, True, False][:2 * timed]):
            sub = random.split(random.fold_in(key, 100 + i), K)
            _sync(torch, dev)
            t1 = time.perf_counter()
            states[meshed], _ = counted("a timed dispatch", want(K, True),
                                        lambda: run_fused(states[meshed], b, owners, sub),
                                        tally=meshed)
            times[meshed].append((time.perf_counter() - t1) * 1e3 / K)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        sub = random.split(random.fold_in(key, 200), K)
        (res, busy, groups, kernels) = _profiled(
            torch, dev, lambda: counted("the profiled dispatch", want(K, True),
                                        lambda: run_fused(states[True], b, owners, sub)),
            K, top=6, cpu_ops=False)
        ms_round = statistics.median(times[True])
        check(int(res[0].step) == (timed + 1) * K, "meshfed: the timed meshed state's step")
        print(f"[meshfed] (a) ms a round, timed in turns: twin "
              f"{', '.join(f'{t:.1f}' for t in times[False])}, meshed "
              f"{', '.join(f'{t:.1f}' for t in times[True])} (median {ms_round:.1f}, "
              f"{ms_round / statistics.median(times[False]):.2f}x the twin); the profiled "
              f"meshed dispatch: device busy {busy:.2f} ms a round, the device idles "
              f"{max(0.0, 1 - busy / ms_round):.1%}, {kernels:.0f} device kernels a round; "
              f"peak memory {_peak_gb(torch, dev):.2f} GB (both states resident)")
        del states, res, run_fused
        if on_card:
            torch.cuda.empty_cache()

        # (b) the tree at depth 2, random.laplace, the fused driver
        a = acfg(small_owners, False, tree_depth=2, caps=(3,) * small_owners)
        owners = torch.tensor([1, 0, 2, 1][:K], dtype=torch.int32, device=dev)
        t1 = time.perf_counter()
        (ms_state, _), _ = parity(f"tree dispatch (depth 2, {small_owners} owners)", a,
                                  "fused", batches_of(K, 32), owners, 42)
        nodes = _leaves(ms_state.tree.nodes)
        check(all(tuple(x.to_local().shape) == (small_owners, 2) + tuple(t.to_local().shape)
                  for x, t in zip(nodes, _leaves(ms_state.theta_L))),
              "meshfed: a rank's node piece is not (N, d, *block)")
        node_gb = sum(x.to_local().numel() * 4 for x in nodes) / 1e9
        print(f"[meshfed] (b) tree: one fused-driver dispatch of K = {K}, {small_owners} owners, "
              f"nodes {node_gb:.2f} GB a state, counts "
              f"{ms_state.tree.counts.cpu().tolist()} == its twin bit for bit (nodes and counts "
              f"too); no kernel launched; {time.perf_counter() - t1:.1f} s")
        del ms_state, nodes
        if on_card:
            torch.cuda.empty_cache()

        # (c) faults + staleness, fused, both drivers, against the host replay
        a = acfg(small_owners, True, fault_policy=F.FaultPolicy(**FAULTS_POLICY),
                 staleness=StalenessPolicy(**FAULTS_RUNTIME))
        k2 = 2 * K
        owners_np = np.arange(k2, dtype=np.int32) % small_owners
        codes_np = np.array(([F_OK, F_DROP, F_STALE, F_NONFINITE, F_CORRUPT, F_TIMEOUT]
                             + [F_OK] * k2)[:k2], np.int8)
        owners = torch.from_numpy(owners_np).to(dev)
        codes = torch.from_numpy(codes_np).to(dev)
        b = batches_of(k2, 33)
        for driver in ("fused", "group"):
            t1 = time.perf_counter()
            (ms_state, mets), _ = parity(f"fault-armed {driver} dispatch", a, driver, b, owners,
                                         43, codes)
            replay = _Replay(a.effective_caps, FAULTS_POLICY, FAULTS_RUNTIME)
            outcomes = replay.run(owners_np, codes_np)
            _check_replay(torch, ms_state, mets, replay, outcomes, f"meshfed {driver}")
            check(torch.equal(ms_state.faults.checksum, F.bank_checksums(ms_state.bank)),
                  "meshfed: the stored checksums differ from the meshed bank's")
            print(f"[meshfed] (c) faults + staleness, {driver}: {k2} rounds, codes "
                  f"{codes_np.tolist()} == its twin bit for bit, the counters == the host "
                  f"replay, the checksums == bank_checksums; {time.perf_counter() - t1:.1f} s")
            del ms_state, mets

        # (d) example granularity, fused
        a = acfg(small_owners, True, example=True)
        k_ex = max(1, K // 2)
        t1 = time.perf_counter()
        (ms_state, mets), twin = parity(
            "example-granularity dispatch", a, "fused", batches_of(k_ex, 34, example=True),
            torch.tensor([2, 0, 1, 3][:k_ex], dtype=torch.int32, device=dev),
            44, close=lambda x, y: _example_close(torch, x, y))
        check(torch.equal(spmd.plain(mets["clip_frac"]), twin[1]["clip_frac"]),
              "meshfed: example clip_frac differs from the twin's")
        print(f"[meshfed] (d) example granularity: {k_ex} rounds of {batch} examples within "
              f"rtol 1e-4 + 1e-5 max of the twin (clip_frac "
              f"{spmd.plain(mets['clip_frac']).cpu().tolist()}, the integer state exact); "
              f"{time.perf_counter() - t1:.1f} s")
        del ms_state, mets, twin, params
    finally:
        dist.destroy_process_group()
    if on_card:
        torch.cuda.empty_cache()
    print(f"[meshfed] launches of the meshed dispatches: "
          + json.dumps({k: v for k, v in total.items() if v})
          + f"; the phase took {time.perf_counter() - t0:.1f} s")
    return total


def _time_mlstm_ssd(torch, dev):
    """Both SSD kernels at the mLSTM's shapes (the wide-head variant: per-head
    k and q, v with a ones column), each beside its plain version and its
    bound (as `_time_ssd`, `_time_ssd_bwd`): the forward at xlstm-125m's
    prefill (B 2, S 4096, H 4, N 384, P 385), both at phase xlstm's training
    microbatch (B 2, S 1024) and at the reduced head (N 128, P 129).
    Printed, not `kernels` rows."""
    from repro_torch.kernels.ssm_scan import kernel, ref
    out = {}
    for what, B, S, H, N, P, bwd in (("prefill", 2, 4096, 4, 384, 385, False),
                                     ("train microbatch", 2, 1024, 4, 384, 385, True),
                                     ("reduced head", 2, 1024, 4, 128, 129, True)):
        Q = 256
        gen = torch.Generator(device=dev).manual_seed(N + S)
        v, ld, k, q, g = _ssd_inputs(torch, dev, B, S, H, N, P, False, gen, ones=True)
        rows = [min(Q, S - c) for c in range(0, S, Q)]
        nc = len(rows)
        fwd_flops = B * H * sum(r * (r + 1) / 2 * (N + P) * 2 + r * N * P * 2 for r in rows)
        outs = kernel.ssd_chunk_scan_cuda(v, ld, k, q, g, Q)
        moved = sum(_bytes(x) for x in (v, ld, k, q, g, *outs))
        bound = max(fwd_flops / F32_FLOP_PER_S, moved / HBM_BYTES_PER_S) * 1e3
        ms = cuda_ms(torch, lambda: kernel.ssd_chunk_scan_cuda(v, ld, k, q, g, Q), 10)
        plain = cuda_ms(torch, lambda: ref.ssd_chunk_scan_ref(v, ld, k, q, g, Q), 3)
        out[f"ssd_chunk_scan {what}"] = (ms, bound, plain)
        print(f"[timing] ssd_chunk_scan, mLSTM {what} (B {B}, S {S}, H {H}, N {N}, P {P}, "
              f"chunk {Q}): {ms:.4f} ms, bound {bound:.4f} ms ({fwd_flops / 1e9:.2f} GFLOP; "
              f"{bound / ms:.1%} of it, {fwd_flops / ms / 1e9:.2f} TFLOP/s), plain {plain:.4f} ms")
        if bwd:
            cots = [torch.randn(shape, device=dev, generator=gen)
                    for shape in ((B, S, H, P), (B, nc, H, N, P), (B, S, H), (B, nc, H))]
            grads = kernel.ssd_chunk_scan_bwd_cuda(*cots, v, ld, k, q, g, Q)
            flops = B * H * sum(r * (r + 1) / 2 * (3 * N + 2 * P) * 2 + 2 * r * N * P * 2
                                for r in rows)
            moved = sum(_bytes(x) for x in (*cots, v, ld, k, q, g, *grads))
            bound = max(flops / F32_FLOP_PER_S, moved / HBM_BYTES_PER_S) * 1e3
            ms = cuda_ms(torch, lambda: kernel.ssd_chunk_scan_bwd_cuda(*cots, v, ld, k, q, g, Q),
                         10)
            plain = cuda_ms(torch, lambda: ref.ssd_chunk_scan_bwd_ref(*cots, v, ld, k, q, g, Q),
                            3)
            out[f"ssd_chunk_scan_bwd {what}"] = (ms, bound, plain)
            print(f"[timing] ssd_chunk_scan_bwd, mLSTM {what} (B {B}, S {S}, H {H}, N {N}, P "
                  f"{P}, chunk {Q}): {ms:.4f} ms, bound {bound:.4f} ms ({flops / 1e9:.2f} GFLOP; "
                  f"{bound / ms:.1%} of it, {flops / ms / 1e9:.2f} TFLOP/s), plain {plain:.4f} ms")
            del cots, grads
        del v, ld, k, q, g, outs
        torch.cuda.empty_cache()
    return out


SANITIZE_K = 4                   # rounds of each sanitized dispatch


def phase_sanitize(torch, dev, cfg=None, n_owners=16, small_owners=4, records=10_000,
                   seq=128, K=SANITIZE_K, p_reuse=P_RAGGED):
    """The key-reuse sanitizer on the card: one dispatch of K rounds of
    phase main's configuration (16 owners, the fused flat engine), then a
    grouped dispatch, a tree dispatch (depth 2) and an int8 dispatch at
    `small_owners`, each first unsanitized (timed), then the same owners
    and batches under `dpcheck.sanitize()`, in turns: no raise, every draw
    is the kernels' own (on the card the kernels hash their keys in-kernel
    and report each launch's draw; no sampler runs for it), so `by_what`
    names the entry points, `draws` equals their launches and `skipped`
    is 0. Then two seeded reuses must raise KeyReuseError on the card: two
    `dp_round_flat` launches on one key, and a `dp_round_rows` whose
    member keys repeat. Returns {case: (ms unsanitized, ms sanitized)}, two
    readings each, taken in turns after a warm-up dispatch."""
    from repro_torch import random
    from repro_torch.analysis.dpcheck import KeyReuseError, sanitize
    from repro_torch.configs import DENSE_124M
    from repro_torch.data import OwnerDataPipeline, synthetic_owner_shards
    from repro_torch.federation import (DataOwner, Federation, FederationConfig,
                                        PrivatizerConfig)
    from repro_torch.kernels.dp_clip_noise import ops as dops
    from repro_torch.models import LM
    cfg = DENSE_124M if cfg is None else cfg
    batch, G = 4, 2
    lm = LM(cfg, remat=False)

    def loss_fn(p, b):
        return lm.loss(p, b)[0]

    t0 = time.perf_counter()
    params = lm.init(seed=0, device=dev, generator_device=dev if dev.type == "cuda" else None)
    cuda = dev.type == "cuda"
    # case: (owners, Federation kwargs, make_step kwargs, run_rounds kwargs,
    # the expected draws by drawer on the card, the kernel launches)
    cases = (
        ("main", n_owners, {}, {}, {}, {"dp_round_flat": K}, {"dp_round": K}),
        ("grouped", small_owners, {}, {}, dict(owner_parallel=True, max_group=small_owners),
         {"dp_round_rows": K}, {}),
        ("tree", small_owners, dict(mechanism="tree", tree_depth=2), {}, {},
         {"tree_delta_": K}, {"tree_delta": K, "dp_round": 0}),
        ("int8", small_owners, {}, dict(bank_dtype="int8"), {},
         {"dp_round_flat": K, "encode_row": K}, {"dp_round": K, "encode": K}),
    )
    key = random.PRNGKey(31, device=dev)
    out = {}
    for name, n, fed_kw, step_kw, run_kw, want, want_launches in cases:
        shards = synthetic_owner_shards(n, records, seq, cfg.vocab, seed=0)
        pipe = OwnerDataPipeline(shards, batch, seed=0)
        owners = [DataOwner(n=sz, epsilon=1.0, xi=1.0) for sz in pipe.owner_sizes]
        fed = Federation(owners, FederationConfig.from_target_lr(
            0.05, n_owners=n, horizon=1000, sigma=1e-2, theta_max=100.0), device=dev,
            **fed_kw)
        fed.make_step(loss_fn, pack_params=True, privatizer=PrivatizerConfig(
            xi=1.0, granularity="microbatch", n_microbatches=G, fused_kernel=True), **step_kw)
        # distinct owners in turn: the grouped dispatch packs them into groups
        owner_seq = np.arange(K, dtype=np.int32) % n
        batches = _torch_batches(torch, pipe.batches_for(owner_seq))
        times = {False: [], True: []}
        # a warm-up dispatch, then unsanitized and sanitized in turns, each
        # from a fresh state (the tree's capacity of 3 leaves an owner)
        state = None
        for sanitized in (None, False, True, False, True):
            state = None
            state = fed.init_state(params)
            key, sub = random.split(key)
            _sync(torch, dev)
            before = _launches()
            t1 = time.perf_counter()
            if sanitized:
                with sanitize() as rec:
                    state, ms = fed.run_rounds(state, batches, owner_seq, key=sub, **run_kw)
            else:
                state, ms = fed.run_rounds(state, batches, owner_seq, key=sub, **run_kw)
            _sync(torch, dev)
            if sanitized is not None:
                times[sanitized].append((time.perf_counter() - t1) * 1e3)
            got = _diff(_launches(), before)
            check(not bool(ms["refused"].any()), f"sanitize {name}: a round was refused")
        by_what = dict(rec.by_what)
        expect = (want if cuda else {"random.bits_range": sum(
            v for k, v in want.items() if k != "encode_row"),
            **({"random.bits": want["encode_row"]} if "encode_row" in want else {})})
        check(rec.draws > 0 and rec.skipped == 0 and rec.splits == 1 and by_what == expect,
              f"sanitize {name}: draws {rec.draws}, splits {rec.splits}, skipped "
              f"{rec.skipped}, by drawer {by_what}; expected {expect}")
        if cuda:
            check(all(got[k] == v for k, v in want_launches.items()) and got["sqnorm"] > 0,
                  f"sanitize {name}: launches {got}, expected {want_launches}")
        plain, san = times[False], times[True]
        out[name] = (plain, san)
        print(f"[sanitize] {name}: {n} owners, K={K}: {rec.draws} draws ({by_what}), "
              f"{rec.splits} split, {rec.skipped} skipped, no reuse; launches {got}; "
              f"in turns, ms a dispatch unsanitized {plain[0]:.1f}, {plain[1]:.1f}, "
              f"sanitized {san[0]:.1f}, {san[1]:.1f} ({sum(san) / sum(plain):.2f}x)")
        del fed, state, batches, ms
        if cuda:
            torch.cuda.empty_cache()
    # seeded reuse on the card: both must raise
    one = torch.ones((), device=dev)
    tb = torch.zeros(p_reuse, device=dev)
    k = random.PRNGKey(37, device=dev)
    kk = random.split(random.fold_in(k, 1), 2)
    kw = dict(sigma=1e-2, lr_own=0.3, lr_l=0.2, n_owners=16, theta_max=2.0)
    raised = []
    for what, call in (
            ("two dp_round_flat launches on one key",
             lambda: [dops.dp_round_flat(tb, tb, k, one, one, one, **kw) for _ in range(2)]),
            ("a dp_round_rows whose member keys repeat",
             lambda: dops.dp_round_rows(  # dpcheck: ignore[DPC104]
                 torch.zeros((3, p_reuse), device=dev), torch.zeros((3, p_reuse), device=dev),
                 torch.stack([kk[0], kk[1], kk[0]]),
                 torch.ones(3, device=dev), torch.ones(3, device=dev), torch.ones(3, device=dev),
                 **kw))):
        try:
            with sanitize():
                call()
                _sync(torch, dev)
        except KeyReuseError as e:
            raised.append(what)
            print(f"[sanitize] seeded reuse caught on {dev.type}: {what}: {e}")
        check(what in raised, f"sanitize: {what} did not raise KeyReuseError")
    print(f"[sanitize] the phase took {time.perf_counter() - t0:.1f} s")
    return out


def _example_module(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples(torch, dev, llm_argv=("--steps", "50")):
    """Each example twin's `main` on `dev`: the LLM twin with `llm_argv`
    (50 steps at full width: DENSE_124M, 4 owners, the reference's pytree
    state) and for 4 rounds of the reduced model on the fused flat engine
    (--fused: sqnorm and dp_round launched), the forecast twin (pilot,
    fitted constants, isolated baseline, eq. (11)'s forecast and its
    check) and the serving twin (greedy decode from the reduced zamba2).
    Each one's printed lines are kept and shown, its seconds printed."""
    import contextlib
    import io
    dev_arg = [] if dev.type == "cuda" else ["--device", dev.type]
    runs = (
        ("async_dp_llm_torch", lambda m: m.main(list(llm_argv) + dev_arg)),
        ("async_dp_llm_torch --fused",
         lambda m: m.main(["--tiny", "--fused", "--steps", "4", "--rounds-per-dispatch", "2"]
                          + dev_arg)),
        ("collaboration_forecast_torch", lambda m: m.main(None if dev.type == "cuda"
                                                          else dev.type)),
        ("serve_hybrid_torch", lambda m: m.main(None if dev.type == "cuda" else dev.type)),
    )
    for name, run in runs:
        mod = _example_module(name.split()[0])
        buf = io.StringIO()
        before = _launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            result = run(mod)
        _sync(torch, dev)
        dt = time.perf_counter() - t0
        got = {k: v for k, v in _diff(_launches(), before).items() if v}
        lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
        for ln in lines:
            print(f"[examples] {name}: {ln}")
        print(f"[examples] {name} took {dt:.1f} s; kernel launches {got}")
        if name.startswith("async_dp_llm_torch"):
            check(len(result) >= 2 and all(math.isfinite(x) for x in result)
                  and lines[-1].startswith("loss "), f"{name}: losses {result}")
            if "--fused" in name and dev.type == "cuda":
                check(got.get("dp_round", 0) == 4 and got.get("sqnorm", 0) == 8,
                      f"{name}: launches {got}")
        elif name == "collaboration_forecast_torch":
            pilot, consts, psi_iso = result
            check(all(math.isfinite(v) for v in list(pilot.values()) + list(consts) + [psi_iso])
                  and any(ln.startswith("  eps=") for ln in lines),
                  f"{name}: pilot {pilot}, constants {consts}, psi {psi_iso}")
        else:
            check(result.shape == (4, 56) and (result >= 0).all()
                  and any(ln.startswith("sample:") for ln in lines),
                  f"{name}: tokens {result.shape}")


def phase_timing(torch, dev, launches, errs):
    from repro_torch import random
    from repro_torch.kernels.dp_clip_noise import ops, ref
    P = P_FULL
    gen = torch.Generator(device=dev).manual_seed(2)
    tb = torch.randn(P, device=dev, generator=gen)
    acc = torch.randn(P, device=dev, generator=gen)
    key = random.PRNGKey(7, device=dev)
    scal = [torch.tensor(v, device=dev) for v in (0.5, 0.9, 0.0625)]
    rows = []
    dp_ms = cuda_ms(torch, lambda: ops.dp_round_flat(tb, acc, key, *scal, **ROUND), 20)
    dp_plain = cuda_ms(torch, lambda: ref.dp_round_ref(
        tb, acc, random.bits(key, (P,)), *scal, **ROUND), 3)  # dpcheck: ignore[DPC101]
    rows.append(dict(
        name="dp_round", route="cuda",
        source="src/repro_torch/kernels/dp_clip_noise/csrc/dp_clip_noise.cu",
        replaces="src/repro/kernels/dp_clip_noise/kernel.py:129",
        launches=launches["dp_round"], max_abs_err=errs["dp_round"], ms=dp_ms,
        plain_ms=dp_plain, bound_ms=16 * tb.numel() / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None))
    sq_ms = cuda_ms(torch, lambda: ops.fused_sqnorm(tb), 50)
    sq_plain = cuda_ms(torch, lambda: ref.sqnorm_ref(tb), 20)
    sq_lib = cuda_ms(torch, lambda: torch.dot(tb, tb), 50)
    rows.append(dict(
        name="sqnorm", route="cuda",
        source="src/repro_torch/kernels/dp_clip_noise/csrc/dp_clip_noise.cu",
        replaces="src/repro/kernels/dp_clip_noise/kernel.py:146",
        launches=launches["sqnorm"], max_abs_err=errs["sqnorm"], ms=sq_ms,
        plain_ms=sq_plain, bound_ms=4 * tb.numel() / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=sq_lib))
    rows += _time_scale_noise(torch, dev, launches, errs)
    rows += _time_bank_codec(torch, dev, launches, errs)
    rows += _time_tree_delta(torch, dev, launches, errs)
    _time_rows(torch, dev)
    rows.append(_time_flash(torch, dev, launches, errs))
    # internvl2-2b's shape (GQA, hd 128) is printed; the row stays zamba2's
    _time_flash(torch, dev, launches, errs, "internvl2-2b", H=16, Kv=8, hd=128, seed=15)
    rows += _time_ssd(torch, dev, launches, errs)
    rows += _time_ssd_bwd(torch, dev, launches, errs)
    _time_mlstm_ssd(torch, dev)
    for r in rows:
        print(f"[timing] {r['name']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms, "
              f"{r['bound_ms'] / r['ms']:.1%} of it), plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']}")
    return rows


def _time_scale_noise(torch, dev, launches, errs):
    """scale_noise over the 12 DENSE_124M leaves, one launch each through
    the wrapper the pytree privatizer calls (the leaf keys split
    beforehand), beside its bound of 8 B per element (read g, write the
    result) and its plain version; no single PyTorch call computes it."""
    from repro_torch import random
    from repro_torch.kernels.dp_clip_noise import ops, ref
    leaves = _dense_leaves(torch, dev, seed=5)
    P = sum(x.numel() for x in leaves)
    check(P == P_FULL, f"the DENSE_124M leaves hold {P} elements")
    keys = random.split(random.PRNGKey(10, device=dev), len(leaves))
    cs, ns = torch.tensor([0.5], device=dev), torch.tensor(0.37, device=dev)

    def kernel_pass():
        return [ops.scale_noise(x, k, cs, ns) for x, k in zip(leaves, keys)]

    def plain_pass():
        return [ref.scale_noise_ref(x, random.bits(k, x.shape), cs.reshape(()), ns)
                for x, k in zip(leaves, keys)]

    row = dict(
        name="scale_noise", route="cuda",
        source="src/repro_torch/kernels/dp_clip_noise/csrc/dp_clip_noise.cu",
        replaces="src/repro/kernels/dp_clip_noise/kernel.py:94",
        launches=launches["scale_noise"], max_abs_err=errs["scale_noise"],
        ms=_steady_ms(torch, "scale_noise", kernel_pass, 20),
        plain_ms=cuda_ms(torch, plain_pass, 3),
        bound_ms=8 * P / HBM_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None)
    big = max(leaves, key=lambda x: x.numel())
    big_ms = cuda_ms(torch, lambda: ops.scale_noise(big, keys[0], cs, ns), 20)
    print(f"[timing] scale_noise on its largest leaf {tuple(big.shape)} alone: {big_ms:.4f} ms "
          f"(bound {8 * big.numel() / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    # the block form: every leaf as its 2 x 2 blocks (a 1-D leaf as four
    # ranges), 48 launches over the same P elements
    blocks = []
    for x, k in zip(leaves, keys):
        shape = tuple(x.shape) if x.dim() >= 2 else (4, x.numel() // 4)
        for offsets, local in _two_by_two(shape):
            sl = tuple(slice(o, o + n) for o, n in zip(offsets, local))
            blocks.append((x.reshape(shape)[sl].contiguous(), k, shape, offsets))

    def block_pass():
        return [ops.scale_noise(b, k, cs, ns, (shape, off)) for b, k, shape, off in blocks]
    block_ms = _steady_ms(torch, "scale_noise, 2 x 2 blocks", block_pass, 20)
    # the host's Python around 48 launches outlasts their device time, so
    # the two passes are also timed queued behind a device sleep
    queued = {what: statistics.median(_queued_ms(torch, run, 20) for _ in range(5))
              for what, run in (("whole", kernel_pass), ("blocks", block_pass))}
    print(f"[timing] scale_noise over the 12 DENSE_124M leaves as 2 x 2 blocks (48 launches, the "
          f"block offset): {block_ms:.4f} ms against the whole leaves' {row['ms']:.4f} ms on "
          f"CUDA events; queued (the host ahead of the device, median of 5) "
          f"{queued['blocks']:.4f} ms against {queued['whole']:.4f} ms (bound "
          f"{row['bound_ms']:.4f} ms: {row['bound_ms'] / queued['blocks']:.1%} and "
          f"{row['bound_ms'] / queued['whole']:.1%} of it)")
    del leaves, big, blocks
    return [row]


def _queued_ms(torch, fn, iters, sleep_cycles=400_000_000):
    """ms per call of fn() on CUDA events, with the calls queued behind a
    device sleep (about 0.2 s), so the host's time to issue them hides
    behind it and the events time the device alone."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _time_bank_codec(torch, dev, launches, errs):
    """absmax, encode and decode on an int8 row at the main path's width,
    each through the wrapper the main path calls, as `kernels` rows; then
    encode and decode on an fp8 row, printed."""
    from repro_torch import random
    from repro_torch.kernels.bank_codec import kernel, ops, ref
    x = torch.randn(P_FULL, device=dev, generator=torch.Generator(device=dev).manual_seed(4))
    key = random.PRNGKey(8, device=dev)
    seed = ref.sr_seed(key)
    src = "src/repro_torch/kernels/bank_codec/csrc/bank_codec.cu"
    replaces = "src/repro/kernels/bank_codec/kernel.py:"
    rows = []
    for fmt in FMTS:
        scale = ops.row_scale(x, fmt)
        codes, _ = kernel.encode_cuda(x, scale, key, fmt)  # dpcheck: ignore[DPC105]
        if fmt == "int8":
            # codes * scale casts int8 -> f32 (exact) inside one multiply:
            # the library call for the int8 decode, held to the kernel
            check(torch.equal(codes * scale, ops.decode_row(codes, scale, fmt)),
                  "codes * scale differs from the decode kernel")
        timed = {
            "absmax": (lambda: ops.row_scale(x, fmt),
                       lambda: ref.row_scales_ref(x.reshape(1, -1), ref.QMAX[fmt]),
                       lambda: torch.linalg.vector_norm(x, float("inf")), 4, "65"),
            "encode": (lambda: kernel.encode_cuda(x, scale, key, fmt),  # dpcheck: ignore[DPC105]
                       lambda: ref.ENCODERS[fmt](x, ref.counter_bits(seed, P_FULL), scale),
                       None, 9, "97"),
            "decode": (lambda: ops.decode_row(codes, scale, fmt),
                       lambda: ref.DECODERS[fmt](codes, scale),
                       (lambda: codes * scale) if fmt == "int8" else None, 5, "116"),
        }
        for name, (fn, plain, lib, bytes_per, line) in timed.items():
            if fmt == "fp8" and name == "absmax":
                continue                    # the same kernel as int8's, another qmax
            row = dict(
                name=name, route="cuda", source=src, replaces=replaces + line,
                launches=launches[name], max_abs_err=errs[name], ms=cuda_ms(torch, fn, 50),
                plain_ms=cuda_ms(torch, plain, 5),
                bound_ms=bytes_per * P_FULL / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                library_ms=None if lib is None else cuda_ms(torch, lib, 50))
            if fmt == "int8":
                rows.append(row)
            else:
                print(f"[timing] {name} (fp8): {row['ms']:.4f} ms (bound "
                      f"{row['bound_ms']:.4f} ms, {row['bound_ms'] / row['ms']:.1%} of it), "
                      f"plain {row['plain_ms']:.4f} ms")
        del codes
    return rows


def _time_tree_delta(torch, dev, launches, errs):
    """tree_delta through the wrapper the engine calls (granted, in place on
    one owner's row of a (1, 4, P) node tensor) at the main path's width,
    for r = 0, 1 and 2 retired levels (counts 0, 1, 3; the counter is not
    bumped, so every launch moves the same bytes), beside its bound of
    (8r + 8) B per element and its plain version. The r = 0 case, the one
    of every other leaf, is the `kernels` row; r = 1 and 2 are printed."""
    from repro_torch import random
    from repro_torch.kernels.tree_noise import ops, ref
    nodes = torch.randn((1, TREE_DEPTH, P_FULL), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(6))
    owner = torch.zeros(1, dtype=torch.int64, device=dev)
    key = random.PRNGKey(9, device=dev)
    ns = torch.tensor([0.37], device=dev)
    grant = torch.ones((), dtype=torch.int32, device=dev)
    rows = []
    for r, count in ((0, 0), (1, 1), (2, 3)):
        counts = torch.tensor([count], dtype=torch.int32, device=dev)

        def launch():
            return ops.tree_delta_(nodes, counts, owner, key, ns, grant)

        row = dict(
            name="tree_delta", route="cuda",
            source="src/repro_torch/kernels/tree_noise/csrc/tree_noise.cu",
            replaces="src/repro/kernels/tree_noise/kernel.py:64",
            launches=launches["tree_delta"], max_abs_err=errs["tree_delta"],
            ms=(_steady_ms(torch, "tree_delta (r = 0)", launch, 20) if r == 0
                else cuda_ms(torch, launch, 20)),
            plain_ms=cuda_ms(torch, lambda: ref.tree_delta_inplace_ref(
                nodes, counts, owner, random.bits(key, (P_FULL,)), ns, grant), 3),  # dpcheck: ignore[DPC101]
            bound_ms=(8 * r + 8) * P_FULL / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=None)
        if r == 0:
            rows.append(row)
        else:
            print(f"[timing] tree_delta (r = {r}): {row['ms']:.4f} ms (bound "
                  f"{row['bound_ms']:.4f} ms, {row['bound_ms'] / row['ms']:.1%} of it), "
                  f"plain {row['plain_ms']:.4f} ms")
    del nodes
    return rows


def _time_rows(torch, dev):
    """[timing] lines for the member axis at full width: dp_round_rows and
    fused_sqnorm_rows over g = ROWS_G rows of P_FULL, and tree_delta_rows_
    over 4 owners at depth 4 (r = 0), one launch each, beside g single
    launches on the same rows and the byte bound (16, 4 and 8 B per
    element and member)."""
    from repro_torch import random
    from repro_torch.kernels.dp_clip_noise import ops as dops
    from repro_torch.kernels.tree_noise import ops as nops
    g, P = ROWS_G, P_FULL
    gen = torch.Generator(device=dev).manual_seed(12)
    tb = torch.randn((g, P), device=dev, generator=gen)
    acc = torch.randn((g, P), device=dev, generator=gen)
    keys = random.split(random.PRNGKey(13, device=dev), g)
    gain, ns, w = (torch.rand(g, device=dev, generator=gen) for _ in range(3))

    def line(what, batched, single, bytes_per):
        bound = bytes_per * g_of[what] * P / HBM_BYTES_PER_S * 1e3
        print(f"[timing] {what} over g = {g_of[what]} members x P = {P}: one batched launch "
              f"{batched:.4f} ms ({bound / batched:.1%} of its bound {bound:.4f} ms), "
              f"{g_of[what]} single launches {single:.4f} ms")

    g_of = {"dp_round": g, "sqnorm": g, "tree_delta": 4}
    line("dp_round",
         _steady_ms(torch, f"dp_round_rows (g = {g})",
                    lambda: dops.dp_round_rows(tb, acc, keys, gain, ns, w, **ROUND), 10),
         cuda_ms(torch, lambda: [dops.dp_round_flat(tb[m], acc[m], keys[m], gain[m:m + 1],
                                                    ns[m:m + 1], w[m:m + 1], **ROUND)
                                 for m in range(g)], 5), 16)
    line("sqnorm",
         _steady_ms(torch, f"fused_sqnorm_rows (g = {g})", lambda: dops.fused_sqnorm_rows(acc),
                    20),
         cuda_ms(torch, lambda: [dops.fused_sqnorm(acc[m]) for m in range(g)], 10), 4)
    del tb, acc
    nodes = torch.randn((4, TREE_DEPTH, P), device=dev, generator=gen)
    counts = torch.zeros(4, dtype=torch.int32, device=dev)      # r = 0: no level retires
    owners = torch.arange(4, dtype=torch.int64, device=dev)
    grant = torch.ones(4, dtype=torch.int32, device=dev)
    line("tree_delta",
         _steady_ms(torch, "tree_delta_rows_ (g = 4, r = 0)",
                    lambda: nops.tree_delta_rows_(nodes, counts, owners, keys[:4], ns[:4],
                                                  grant), 10),
         cuda_ms(torch, lambda: [nops.tree_delta_(nodes, counts, owners[m:m + 1], keys[m],
                                                  ns[m:m + 1], grant[m:m + 1])
                                 for m in range(4)], 5), 8)
    del nodes


def _bytes(t):
    """The bytes a function must move for `t`: each distinct element once
    (a stride-0 broadcast axis counts once)."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else 1
    return n


def _time_flash(torch, dev, launches, errs, name="zamba2", H=32, Kv=32, hd=80, seed=14):
    """flash attention at a model's prefill shape (B 2, S 4096, causal, f32;
    zamba2's H = Kv = 32, hd 80 by default) through its entry point, its
    plain version, and torch's scaled_dot_product_attention on the same
    inputs in the (B, H, S, hd) layout it takes, k and v repeated to H heads
    beforehand (not timed; the library yardstick, timed only). Bound: the
    causal work 4 B H hd S (S + 1) / 2 over the f32 rate (no tensor cores),
    against q, k, v and o once over the memory rate. Returns the kernels
    line's row."""
    from repro_torch.kernels.flash_attention import ops, ref
    B, S = PREFILL_B, PREFILL_S
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, S, H, hd), device=dev, generator=gen)
    k, v = (torch.randn((B, S, Kv, hd), device=dev, generator=gen) for _ in range(2))
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x.transpose(1, 2).repeat_interleave(H // Kv, dim=1).contiguous() for x in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flops = 4 * B * H * hd * S * (S + 1) / 2
    moved = sum(_bytes(x) for x in (q, k, v, q))
    row = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:103",
        launches=launches["flash_attention"], max_abs_err=errs["flash_attention"],
        ms=cuda_ms(torch, lambda: ops.flash_attention(q, k, v), 10),
        plain_ms=cuda_ms(torch, lambda: ref.flash_attention_ref(q, k, v), 3),
        bound_ms=max(flops / F32_FLOP_PER_S, moved / HBM_BYTES_PER_S) * 1e3,
        bound_by="operations" if flops / F32_FLOP_PER_S > moved / HBM_BYTES_PER_S else "bytes",
        library_ms=cuda_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True), 10))
    print(f"[timing] flash_attention at {name}'s prefill (B {B}, S {S}, H {H}, Kv {Kv}, hd {hd}, "
          f"causal, f32): {row['ms']:.4f} ms; bound {row['bound_ms']:.4f} ms "
          f"({flops / 1e9:.1f} GFLOP, {moved / 1e6:.1f} MB), {row['bound_ms'] / row['ms']:.1%} "
          f"of it, {flops / row['ms'] / 1e9:.1f} TFLOP/s; plain {row['plain_ms']:.4f} ms; "
          f"scaled_dot_product_attention {row['library_ms']:.4f} ms "
          f"({row['library_ms'] / row['ms']:.3f}x the kernel's time)")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return row


def _time_ssd(torch, dev, launches, errs):
    """The SSD chunk kernel at zamba2's prefill shape (B 2, S 4096, H 80,
    N = P = 64, chunk 256, B and C broadcast over the heads, f32) through
    its wrapper, beside its plain version (ssd_chunk_scan_ref); the whole
    entry point (the kernel and the torch recurrence between chunks) and
    the plain scan are printed. No single PyTorch call computes it. Bound:
    per chunk of Qv valid rows, Qv (Qv + 1) / 2 (N + P) 2 + Qv N P 2
    operations with the upper triangle skipped, over the f32 rate, against
    the inputs (each distinct element once) and the four outputs over the
    memory rate."""
    from repro_torch.kernels.ssm_scan import kernel, ops, ref
    B, S, H, N, P, Q = PREFILL_B, PREFILL_S, 80, 64, 64, 256
    v, ld, k, q, g = _ssd_inputs(torch, dev, B, S, H, N, P, True,
                                 torch.Generator(device=dev).manual_seed(15))
    outs = kernel.ssd_chunk_scan_cuda(v, ld, k, q, g, Q)
    rows = [min(Q, S - c) for c in range(0, S, Q)]
    flops = B * H * sum(r * (r + 1) / 2 * (N + P) * 2 + r * N * P * 2 for r in rows)
    moved = sum(_bytes(x) for x in (v, ld, k, q, g, *outs))
    row = dict(
        name="ssd_chunk_scan", route="cuda",
        source="src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
        replaces="src/repro/kernels/ssm_scan/kernel.py:63",
        launches=launches["ssd_chunk_scan"], max_abs_err=errs["ssd_chunk_scan"],
        ms=cuda_ms(torch, lambda: kernel.ssd_chunk_scan_cuda(v, ld, k, q, g, Q), 20),
        plain_ms=cuda_ms(torch, lambda: ref.ssd_chunk_scan_ref(v, ld, k, q, g, Q), 3),
        bound_ms=max(flops / F32_FLOP_PER_S, moved / HBM_BYTES_PER_S) * 1e3,
        bound_by="operations" if flops / F32_FLOP_PER_S > moved / HBM_BYTES_PER_S else "bytes",
        library_ms=None)
    whole = cuda_ms(torch, lambda: ops.ssd_chunked(v, ld, k, q, g, chunk=Q), 10)
    whole_plain = cuda_ms(torch, lambda: ref.ssd_chunked(v, ld, k, q, g, chunk=Q), 3)
    print(f"[timing] ssd_chunk_scan at B {B}, S {S}, H {H}, N {N}, P {P}, chunk {Q}: "
          f"{flops / 1e9:.2f} GFLOP and {moved / 1e6:.1f} MB; "
          f"{flops / row['ms'] / 1e9:.2f} TFLOP/s achieved; the whole ops.ssd_chunked "
          f"(kernel + torch recurrence) {whole:.4f} ms, the plain scan {whole_plain:.4f} ms")
    del v, ld, k, q, g, outs
    # the same kernel at phase train's microbatch (B 2, S 1024), for the
    # training path's share: printed, not a `kernels` row
    S = 1024
    v, ld, k, q, g = _ssd_inputs(torch, dev, B, S, H, N, P, True,
                                 torch.Generator(device=dev).manual_seed(18))
    flops = B * H * sum(r * (r + 1) / 2 * (N + P) * 2 + r * N * P * 2
                        for r in (min(Q, S - c) for c in range(0, S, Q)))
    ms = cuda_ms(torch, lambda: kernel.ssd_chunk_scan_cuda(v, ld, k, q, g, Q), 20)
    print(f"[timing] ssd_chunk_scan at phase train's microbatch (B {B}, S {S}): {ms:.4f} ms, "
          f"{flops / 1e9:.2f} GFLOP, {flops / ms / 1e9:.2f} TFLOP/s achieved, "
          f"{flops / F32_FLOP_PER_S * 1e3 / ms:.1%} of its bound")
    del v, ld, k, q, g
    torch.cuda.empty_cache()
    return [row]


def _time_ssd_bwd(torch, dev, launches, errs):
    """The SSD backward kernel at phase train's microbatch (B 2, S 1024, H
    80, N = P = 64, chunk 256, B and C broadcast over the heads, f32)
    through its wrapper, beside its plain version (ssd_chunk_scan_bwd_ref);
    no single PyTorch call computes it. Bound: per chunk of Qv valid rows
    the five triangle products, Qv (Qv + 1) / 2 (3 N + 2 P) 2, and the h_add
    terms, 2 Qv N P 2, over the f32 rate, against the inputs (each distinct
    element once), the cotangents and the five outputs over the memory
    rate."""
    from repro_torch.kernels.ssm_scan import kernel, ref
    B, S, H, N, P, Q = 2, 1024, 80, 64, 64, 256
    gen = torch.Generator(device=dev).manual_seed(17)
    v, ld, k, q, g = _ssd_inputs(torch, dev, B, S, H, N, P, True, gen)
    nc = -(-S // Q)
    cots = [torch.randn(shape, device=dev, generator=gen)
            for shape in ((B, S, H, P), (B, nc, H, N, P), (B, S, H), (B, nc, H))]
    outs = kernel.ssd_chunk_scan_bwd_cuda(*cots, v, ld, k, q, g, Q)
    rows = [min(Q, S - c) for c in range(0, S, Q)]
    flops = B * H * sum(r * (r + 1) / 2 * (3 * N + 2 * P) * 2 + 2 * r * N * P * 2 for r in rows)
    moved = sum(_bytes(x) for x in (*cots, v, ld, k, q, g, *outs))
    row = dict(
        name="ssd_chunk_scan_bwd", route="cuda",
        source="src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
        replaces="none (the port's own backward of src/repro/kernels/ssm_scan/kernel.py:63)",
        launches=launches["ssd_chunk_scan_bwd"], max_abs_err=errs["ssd_chunk_scan_bwd"],
        ms=cuda_ms(torch, lambda: kernel.ssd_chunk_scan_bwd_cuda(*cots, v, ld, k, q, g, Q), 20),
        plain_ms=cuda_ms(torch, lambda: ref.ssd_chunk_scan_bwd_ref(*cots, v, ld, k, q, g, Q), 3),
        bound_ms=max(flops / F32_FLOP_PER_S, moved / HBM_BYTES_PER_S) * 1e3,
        bound_by="operations" if flops / F32_FLOP_PER_S > moved / HBM_BYTES_PER_S else "bytes",
        library_ms=None)
    print(f"[timing] ssd_chunk_scan_bwd at B {B}, S {S}, H {H}, N {N}, P {P}, chunk {Q}: "
          f"{flops / 1e9:.2f} GFLOP and {moved / 1e6:.1f} MB; "
          f"{flops / row['ms'] / 1e9:.2f} TFLOP/s achieved")
    del v, ld, k, q, g, cots, outs
    torch.cuda.empty_cache()
    return [row]


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run needs a "
              "CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repository)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    t_lap = [t_start]

    def lap(name):
        now = time.perf_counter()
        print(f"[env] {name} took {now - t_lap[0]:.1f} s")
        t_lap[0] = now

    phase_build()
    lap("build")
    errs = phase_kernels(torch, dev)
    lap("kernels")
    main_launches, _, _, _, main_prof = phase_main(torch, dev)
    torch.cuda.empty_cache()
    check(main_launches["sqnorm"] > 0 and main_launches["dp_round"] > 0,
          "main path launched no kernel")
    lap("main")
    grouped_launches, _ = phase_grouped(torch, dev, main_prof)
    torch.cuda.empty_cache()
    check(grouped_launches["sqnorm"] > 0 and grouped_launches["dp_round"] > 0,
          "the grouped path launched no sqnorm or dp_round")
    lap("grouped")
    phase_mesh(torch, dev)
    torch.cuda.empty_cache()
    lap("mesh")
    example_launches, example_prof = phase_example(torch, dev)
    torch.cuda.empty_cache()
    print(f"[example] against main in this call, per round: device busy "
          f"{example_prof['busy']:.3f} vs {main_prof['busy']:.3f} ms "
          f"({example_prof['busy'] - main_prof['busy']:+.3f}); device kernels "
          f"{example_prof['launches']:.0f} vs {main_prof['launches']:.0f}; peak "
          f"{example_prof['peak']:.2f} vs {main_prof['peak']:.2f} GB")
    lap("example")
    phase_faults(torch, dev, main_prof)
    torch.cuda.empty_cache()
    lap("faults")
    paged_launches = phase_paged(torch, dev, main_prof)
    torch.cuda.empty_cache()
    lap("paged")
    phase_checkpoint(torch, dev, n_owners=8)
    torch.cuda.empty_cache()
    lap("checkpoint")
    quant_launches = phase_quant(torch, dev)
    torch.cuda.empty_cache()
    check(all(quant_launches[k] > 0 for k in ("absmax", "encode", "decode")),
          "quant path launched no bank codec kernel")
    lap("quant")
    tree_launches, _, _, _, tree_prof = phase_main(torch, dev, tree_depth=TREE_DEPTH,
                                                   dispatches=3, tag="tree", cpu_ops=False)
    torch.cuda.empty_cache()
    check(tree_launches["tree_delta"] > 0 and tree_launches["dp_round"] == 0,
          "tree path launched no tree_delta, or a dp_round")
    extra = {g: tree_prof["groups"].get(g, 0.0) - main_prof["groups"].get(g, 0.0)
             for g in set(tree_prof["groups"]) | set(main_prof["groups"])}
    print(f"[tree] device time per round {tree_prof['busy']:.3f} ms against main's "
          f"{main_prof['busy']:.3f} (+{tree_prof['busy'] - main_prof['busy']:.3f}); by group, "
          f"tree minus main: " + ", ".join(f"{g} {ms:+.3f}" for g, ms in sorted(extra.items()))
          + f"; ms per round (median) {tree_prof['median']:.2f} against main's "
          f"{main_prof['median']:.2f}")
    lap("tree")
    py_launches, py_prof, unfused_ms = phase_pytree(torch, dev)
    torch.cuda.empty_cache()
    check(py_launches["scale_noise"] > 0 and py_launches["sqnorm"] > 0
          and py_launches["dp_round"] == 0,
          "pytree path launched no scale_noise or sqnorm, or a dp_round")
    extra = {g: py_prof["groups"].get(g, 0.0) - main_prof["groups"].get(g, 0.0)
             for g in set(py_prof["groups"]) | set(main_prof["groups"])}
    print(f"[pytree] against main in this call, per round: wall (median) "
          f"{py_prof['median']:.2f} vs {main_prof['median']:.2f} ms; device busy "
          f"{py_prof['busy']:.3f} vs {main_prof['busy']:.3f} ms; device kernels "
          f"{py_prof['launches']:.0f} vs {main_prof['launches']:.0f}; idle share "
          f"{1 - py_prof['busy'] / py_prof['median']:.1%} vs "
          f"{1 - main_prof['busy'] / main_prof['median']:.1%}; peak memory "
          f"{py_prof['peak']:.2f} vs {main_prof['peak']:.2f} GB; by group, pytree minus "
          f"main: " + ", ".join(f"{g} {ms:+.3f}" for g, ms in sorted(extra.items()))
          + f"; fused_kernel=False {unfused_ms:.2f} ms/round")
    lap("pytree")
    serve_launches = phase_serve(torch, dev)
    check(all(serve_launches[k] > 0 for k in SERVE_KERNELS)
          and not any(serve_launches[k] for k in FED_KERNELS + ("ssd_chunk_scan_bwd",)),
          "the serve path launched no flash or SSD kernel, or a federation kernel or a backward")
    lap("serve")
    train_launches, _, _, _, _ = phase_train(torch, dev, dispatches=3)
    torch.cuda.empty_cache()
    check(train_launches["ssd_chunk_scan_bwd"] > 0 and train_launches["dp_round"] > 0
          and train_launches["flash_attention"] == 0,
          "the train path launched no SSD backward or dp_round, or a flash_attention")
    lap("train")
    xlstm_round = phase_xlstm(torch, dev)
    torch.cuda.empty_cache()
    lap("xlstm")
    moe_launches = phase_moe(torch, dev)
    torch.cuda.empty_cache()
    check(moe_launches["flash_attention"] > 0, "the MoE prefill launched no flash_attention")
    lap("moe")
    family_launches = {}
    for name, phase in (("vlm", phase_vlm), ("audio", phase_audio), ("zoo", phase_zoo)):
        family_launches[name] = phase(torch, dev)
        torch.cuda.empty_cache()
        check(family_launches[name]["flash_attention"] > 0
              and not any(v for k, v in family_launches[name].items() if k != "flash_attention"),
              f"the {name} prefills launched no flash_attention, or another kernel")
        lap(name)
    meshzoo_launches = phase_meshzoo(torch, dev)
    check(all(meshzoo_launches[k] > 0 for k in SERVE_KERNELS),
          "the meshed prefills launched no flash or SSD kernel")
    lap("meshzoo")
    meshtrain_launches = phase_meshtrain(torch, dev)
    check(all(meshtrain_launches[k] > 0 for k in ("ssd_chunk_scan", "ssd_chunk_scan_bwd",
                                                   "sqnorm", "scale_noise"))
          and not any(meshtrain_launches[k] for k in ("dp_round", "flash_attention")),
          "the meshed training rounds launched no SSD, sqnorm or scale_noise kernel, or a "
          "dp_round or flash_attention")
    lap("meshtrain")
    meshfed_launches = phase_meshfed(torch, dev)
    check(meshfed_launches["sqnorm"] > 0 and meshfed_launches["scale_noise"] > 0
          and not any(v for k, v in meshfed_launches.items()
                      if k not in ("sqnorm", "scale_noise")),
          "the meshed pytree dispatches launched no sqnorm or scale_noise, or another kernel")
    lap("meshfed")
    phase_convex(torch, dev)
    torch.cuda.empty_cache()
    lap("convex")
    sync_launches, _ = phase_sync(torch, dev)
    torch.cuda.empty_cache()
    check(sync_launches["sqnorm"] > 0 and sync_launches["scale_noise"] > 0
          and not any(sync_launches[k] for k in sync_launches
                      if k not in ("sqnorm", "scale_noise")),
          "the sync path launched no sqnorm or scale_noise, or another kernel")
    lap("sync")
    for bank_dtype in (None, "int8"):
        phase_refusal(torch, dev, bank_dtype=bank_dtype)
        phase_refusal(torch, dev, bank_dtype=bank_dtype, tree_depth=2)
    phase_refusal(torch, dev, pack_params=False)
    phase_refusal(torch, dev, pack_params=False, tree_depth=2, fused=False)
    paged_launches["refusal tree"] = phase_paged_refusal(torch, dev, tree_depth=2)
    lap("refusal")
    for bank_dtype in (None, "int8"):
        phase_fault_refusal(torch, dev, bank_dtype=bank_dtype)
    phase_fault_refusal(torch, dev, tree_depth=2)
    phase_fault_refusal(torch, dev, pack_params=False)
    for bank_dtype in (None, "int8"):
        paged_launches[f"fault refusal {bank_dtype or 'f32'}"] = phase_paged_refusal(
            torch, dev, bank_dtype=bank_dtype, faults=True)
    lap("fault refusal")
    phase_sanitize(torch, dev)
    torch.cuda.empty_cache()
    lap("sanitize")
    phase_examples(torch, dev)
    torch.cuda.empty_cache()
    lap("examples")
    # the kernels' launches on the paged paths (PERF.md section 6's rows)
    print("[paged] launches on the paged paths: " + json.dumps(paged_launches))
    print("[xlstm] launches a build_train_step round: " + json.dumps(xlstm_round)
          + "; [moe] launches over the four prefills: " + json.dumps(moe_launches))
    print("[vlm, audio, zoo] flash_attention launches over each phase's kernel prefills: "
          + json.dumps({k: v["flash_attention"] for k, v in family_launches.items()}))
    # each kernel's launches on its own path: rows 1-2 from main, 3 from
    # pytree, 4-6 from quant, 7 from tree, 8-9 from serve, the SSD
    # backward from train
    launches = dict(main_launches, tree_delta=tree_launches["tree_delta"],
                    scale_noise=py_launches["scale_noise"],
                    **{k: quant_launches[k] for k in ("absmax", "encode", "decode")},
                    **{k: serve_launches[k] for k in SERVE_KERNELS},
                    ssd_chunk_scan_bwd=train_launches["ssd_chunk_scan_bwd"])
    rows = phase_timing(torch, dev, launches, errs)
    lap("timing")
    print(f"[env] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    print(smi.stdout.strip())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
