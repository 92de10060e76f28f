#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

1. Environment: full float32 matmuls (no TF32), versions, the card's
   name and power limit.  Exits non-zero at once without a CUDA device.
2. Build: compiles every kernel source of the port with nvcc, one
   process per source, all started together, and prints each build log
   (registers, shared memory, spills).
3. Kernels: each kernel against its plain PyTorch version on the card.
   Consensus: the test shapes, the main-path shape and one large shape,
   each with a symmetric and a random non-symmetric mixing matrix; then
   both consensus kernels on their edges (1 to 17 agents, rows of 1 to
   4096 values in both dtypes, every stream also one element into its
   storage: the 16-byte path and the element path, each staging of the
   step and one and two passes of the mix).  Flash
   attention: the JAX package's test cases, q_offset cases, the two
   cases where its wrapper's padding shows, rows that see no key and
   strided views, each in float32 (the split pass and the split-operand
   tensor-core kernel, 2e-5) and in bfloat16 (the bf16 tensor-core
   kernel, a per-row relative gate), a float32 view misaligned for
   16-byte loads, a windowed case of 8 query heads a kv head at head
   size 128, the gemma2-2b serving shapes (global and local) and phase
   4i's attention shapes (jamba's 64 / 8 heads of 128 over 2048 tokens;
   mixtral's 32 / 8 heads of 128, a 4096-token window, 2 x 4608 tokens)
   and phase 4j's (paligemma-3b's 8 / 1 heads of 256 over 4 x 512
   positions; musicgen-medium's 24 / 24 heads of 64 over 4 x 1564),
   each in both dtypes, and the LM training phases' eval steps (4h, 4k,
   4l: 4 x 256 tokens of smollm-360m's 15 / 5 heads of 64, mixtral's 32 /
   8 of 128 under its window, jamba's 64 / 8 of 128, gemma2-2b's 8 / 4 of
   256 with its softcap and paligemma-3b's 8 / 1 of 256) in bfloat16, the
   dtype they train in; each call must add one launch to the count of
   each kernel its dtype takes; the float32 split pass is bit-equal to its
   plain version at the serving shape and on the strided views.
   WKV6: the JAX package's test cases, every head size at a length that
   is not a multiple of its 16-token chunk, a strong-decay draw (w
   exactly 0, below 1e-4, above 0.999) and the rwkv6-3b serving shape,
   with and without an incoming state, and phase 4l's eval shape (4 x 256
   tokens).  Consensus times in bfloat16 too, at the main-path and the
   large shape.  Times (median of warmed
   CUDA-event timings), bounds and library yardsticks at the main-path
   shapes (SDPA: is_causal where there is no window or the window spans
   every key, the window as a boolean mask where it does not; without
   gemma2's softcap, which it cannot apply; at phase 4i's, 4j's and the
   eval steps' shapes it computes the same function).
   ``attention_blockwise`` (plain PyTorch, the JAX package's streaming
   softmax over kv blocks of 1024) against the plain attention at phase
   4j's two shapes in float32: its output and its gradients with respect
   to q, k and v (one backward of a random cotangent), each within
   ``BLOCKWISE_RTOL`` (1e-4) of the plain tensor's scale, with each
   route's peak device memory and times, forward alone and with the
   backward (a ``blockwise`` line).  The
   batched consensus kernels (a sweep group's form: B experiments in one
   launch): B in ``BATCH_B`` (1, 3, 4, 8: the
   Figure-2 groups' 4 among them), m in {4, 5, 16}, one
   matrix shared by the batch or one each, a distinct alpha each, both
   dtypes, rows aligned and one element into their storage (the 16-byte
   and the element path), against the batched plain versions, each call
   one launch on its wrapper's count; timed at the Figure-2 groups'
   shape ``SWEEP_SHAPE`` (4, 5, 760) float32, beside the ``baddbmm``
   pair (``bmm`` for the mix) and the plain version.  The row-block forms of both
   consensus kernels (one process's rows of the ``allgather`` backend:
   the gathered (m, D) tables, the block's (rows, D) p, p_prev and
   outputs): one row of 5 at D = 760 and 4 rows of 16 at D = 4M, both
   dtypes, against their plain versions, each call one launch on
   ``ROW_LAUNCHES``, the block of all m rows bit for bit the square
   launch; timed in float32 beside the ``addmm`` pair (``matmul``) on
   the block's rows.
4. INTERACT path: ``solve`` on the Section-6 instance at full size, 40
   steps, with the ``cuda`` backend and then ``dense`` (both step through
   captured CUDA graphs); checks that both eq.-11 traces fall and agree
   and that the ``cuda`` run went through both consensus kernels: the
   wrapper counts (set to 0 just before it) count the warm-up steps, the
   capture and the round-latency mixes, and ``torch.profiler``'s kernel
   events over the run, which see graph replays, must show
   ``consensus_step`` once in each of the 40 replayed steps and the 2
   warm-up steps.  (The profiler loses a few kernel records in some
   windows and never adds one, so a count that falls short is taken
   again from a repeat of the same run, led by more spins, three windows
   at most, and each kernel's count is its largest:
   ``counted_launches``.)
4b. The four Section-6 algorithms (INTERACT, SVR-INTERACT, GT-DSGD,
   D-SGD) on the same instance, nothing cut (m = 5, n = 600, 2 x 20 tanh
   backbone, ER(0.5) Laplacian, ``cg`` at 32 trips, alpha = beta = 0.3,
   q = |S| = ceil(sqrt(n)) = 25), each run twice on the ``cuda`` backend
   through ``run_recorded``: ``scan=True`` (replayed CUDA graphs), 40
   steps recording every 10, and ``scan=False`` (the eager loop), the
   first 10 steps of the same run (``ALGO_EAGER_STEPS``).  Here and in
   4c-4d the records a host call takes (``run_recorded``'s, a finished
   run's M_40) replay one captured graph of the eq.-11 metric
   (``host_metric``): the eager metric's value bit for bit, in tens of
   milliseconds instead of 1.2-2.5 s of host time.  The
   warm-up step, or the warm-up steps and the captures, come first, so
   the counted run is the 40 steps alone.  Checks: every trace finite and
   falling; captured and eager traces within ``TRACE_RTOL`` where both
   recorded;
   ``consensus_step`` launched exactly once on every step of INTERACT,
   SVR-INTERACT and GT-DSGD and ``consensus_mix`` on every step of
   D-SGD, the other kernel never: an eager run's launches are its wrapper
   counts, a captured run's are the kernel events under
   ``torch.profiler`` (its wrappers must count none: nothing is launched
   from the host between replays), and a second, unprofiled captured run
   gives its ``us_per_step``.  Then INTERACT's ``run_traced`` (steps and
   metric both replayed) twice from one state, the first call capturing:
   its trace against the eager one, and its host-clock time.  Prints the
   Figure-2 ordering of the final metrics (not gated: the port draws
   other random numbers than the JAX benchmark).  Then 3 eager INTERACT
   steps, whose kernel events (``counted_launches``) must equal their
   wrapper counts (the check on the profiler count), and profiles of 3 eager and 3 captured steps
   (consensus_step once a replay).
   Phases 4c-4h, 4k and 4l share the card: the main process runs 4c and
   then 4d, while three worker processes of this script
   (``--phase-worker``, the groups of ``PHASE_GROUPS``) run 4e; 4g and
   then 4f; and the LM training phases 4l, 4h and then 4k, one training
   run at a time.  The workers start after phase 3 and import (the first
   LM run's processes too) beside 4 and 4b; they start their phases once
   4b's profiles are taken.  Each worker's output goes to a log that the
   main process prints
   once the worker has ended; its consensus counts are set to 0 just
   before each of its phases.  Host-clock figures of 4c-4h (us per step,
   walls, ``vmap_speedup``) are taken with the other phases running
   beside them; the kernel times of 3 and the profiles of 4b are taken
   alone.
4c. The compressed wire and the time-varying topologies (``WIRE_ROWS``),
   on the same instance: INTERACT with sign1bit and error feedback, 5
   warm-up steps and a round every 2 steps; INTERACT with top-5% and
   gamma = 0.5; SVR-INTERACT and D-SGD with int8; GT-DSGD over
   link-failure (p = 0.3, a 40-step stream); INTERACT over the adaptive
   process (tau = 1).  Each row: ``solve`` on ``cuda``, ``ROW_STEPS`` =
   26 captured steps (40 before phase 4i joined, cut for the script's
   time limit; 26 keeps SVR-INTERACT's refresh step; each row's checks
   at that depth: ``ROW_RTOL`` is 26 times the one-step bound,
   ``WIRE_RTOL`` likewise scaled)
   (counts set to 0 just before it, read just after: the wrappers count
   its graphs' warm-up steps and captures and the 6 round-latency mixes);
   its measured wire bytes must equal the port's priced
   ``cumulative_wire_bytes`` exactly.  Then the same 26 steps by
   ``run_traced`` in two calls (8 and 18 steps, step and eq.-11 metric
   replayed: M_0, M_8, M_26), whose state must equal ``solve``'s bit for
   bit and whose trace must fall; then 26 replays of those graphs
   (``replays``) alone under ``torch.profiler``, whose consensus
   kernel events (``counted_launches``, as in 4) must be the row's, with
   nothing launched from the host; 8 eager steps on ``cuda``, whose M_0,
   M_8 and state must equal the captured ones bit for bit; and ``solve`` on
   ``dense`` (it launches no kernel), whose bytes must equal the priced
   ones and whose M_26 must be within ``ROW_RTOL`` of cuda's
   (``WIRE_RTOL`` for the compressed rows).  Stream rows also print the
   per-link ``stream_wire_bytes`` and the mean spectral gap, and hold
   both kernels on the last round matrix against their plain versions.
4d. The Byzantine layer (``BYZANTINE_ROWS``), on the same instance: one
   sign-flip attacker (scale 25) under the weighted rule, zero attackers,
   trimmed-mean (f = 1), INTERACT on the complete graph; GT-DSGD with the
   coordinate median on the ER(0.5) graph (supports of 4, 2, 3, 4 and 2
   agents); SVR-INTERACT with two gaussian attackers under krum-like; the
   weighted sign-flip row under a NaN and norm (1e3) guard.  Clean
   INTERACT on the complete graph, captured on ``cuda`` and ``dense``,
   gives the baselines.  Each row runs as a wire row (captured ``solve``,
   ``run_traced`` in two calls, 26 profiled replays, 8 eager steps,
   ``dense``), with states compared bit for bit (NaN where NaN: the
   weighted rows overflow) and measured bytes equal to priced ones
   (attacks do not change the wire).  Row gates: weighted M_26 at least
   10x the clean one or non-finite on both backends; zero attackers
   bit for bit the clean ``dense`` run, and ``cuda`` within
   ``ROW_RTOL`` of the clean ``cuda`` M_26; trimmed-mean contains the
   attacker (a finite M_26 below M_0 on both backends; its factor over
   the same rule with no attacker, the reference's 3x gate, is
   reported); ``cuda`` and ``dense`` traces within ``ROW_RTOL``
   where finite and non-finite together (the median's honest agents
   finite); the guard's counters equal across captured, eager and
   ``dense``, with a finite final state.
4e. The batched sweeps (``sweep``), on the same instance, nothing cut:
   the Figure-2 grid (the four algorithms x 4 seeds on ``cuda``; 8
   before phase 4h joined, cut for the script's time limit;
   ``benchmarks/bench_convergence.py``'s) with ``compare_sequential``:
   4 groups; every trace finite and falling and within ``TRACE_RTOL`` of
   the same config's sequential replay; then each group's 40 replays
   under ``torch.profiler`` (``counted_launches``): 40 ``consensus_step``
   kernel events (``consensus_mix`` for D-SGD), one launch a step for
   all 4 experiments, the other kernel never, no wrapper count between
   replays.  Prints each group's us per experiment-step batched and
   sequential, ``vmap_speedup``, seconds and captures, and M_40 mean and
   spread.  Then a seed x alpha grid (2 x {0.3, 0.1}): one group, each
   row within ``TRACE_RTOL`` of its own config's ``run_traced`` (alpha
   reaches the kernel per experiment).  Then INTERACT on ``dense`` over
   4 and 8 agents x ring and ER(0.5) x 3 seeds
   (``benchmarks/bench_connectivity.py``'s grid) with ``pad_agents``:
   one group against the four of the unpadded sweeps of each size,
   every padded row within ``TRACE_RTOL`` of its unpadded row (bit for
   bit reported, not gated).  These two checks record eq. 11 at
   ``CHECK_INNER_STEPS`` = 30 inner steps, for time.
4f. Resilience (``repro_torch.resilience``, ``repro_torch.checkpoint``),
   on the same instance, INTERACT on ``cuda``, captured, 40 steps, eq. 11
   (at ``CHECK_INNER_STEPS``) every 10, a snapshot every 7: the chunked
   ``run_traced`` bit for bit the unchunked one (trace and state), with
   its host-clock us per step beside the unchunked one's and the time and
   bytes of a snapshot; a run killed at 18 (the boundary at 21 lost) and
   resumed in a fresh solver (``resume_run``: new graphs captured from
   t = 14) bit for bit the uninterrupted run, whose kernel events from
   start to end (``counted_launches``) are ``consensus_step`` once in
   each replay, the 7 lost ones included, and in each capture's warm-up
   steps, with no wrapper count between replays; the same kill resumed
   eagerly, bit for bit too; a chaos campaign of SVR-INTERACT with every
   fault kind (``CHAOS_FAULTS``): its counters as planned, its trace and
   state bit for bit the uninterrupted run's, and the host generator
   restored from its last snapshot (35) equal to the uninterrupted run's
   there; the guarded sign-flip row (``BYZANTINE_ROWS``) under
   ``chaos_run``: guard trips rolled back, then accepted, the guard's
   counters and state those of the uncheckpointed captured run; and a
   Figure-2 INTERACT group of 2 seeds swept with ``resume_dir`` twice,
   the second call loading the group, bit for bit.
4g. Across processes (``repro_torch.launch.distributed``), on the same
   instance, nothing cut but the run's length: INTERACT, 20 steps (40
   before phase 4h joined, cut for the script's time limit), eq. 11 (300
   inner steps)
   every 10 (rank 0's graph of the metric, ``eq11_metric``, as in the
   reference), through ``python -m repro_torch.launch.launch_local`` in
   three layouts (``DIST_LAYOUTS``): ``allgather`` on 5 processes of one
   agent, each on the one card, over gloo staged through host memory;
   ``ppermute`` the same way; ``allgather`` on 1 process of 5 agents over
   NCCL.  Each against the single-process ``cuda`` eager run of the same
   instance: the trace within ``TRACE_RTOL`` (the NCCL layout, whose
   row-block launches cover rows 0 .. 4, bit for bit, its final x's
   digest too); measured bytes equal to the broadcast price
   (``allgather``) or the per-link price (``ppermute``, whose
   ``rounds_per_mix`` must be the ER(0.5) schedule's); one digest on every
   rank; each worker's row-block launches (its counts start at 0 with
   the process): ``consensus_step`` once a step a rank on ``allgather``,
   none on ``ppermute``.  Prints each layout's eager ``us_per_step`` and
   ``round_latency_us`` beside its wire.
4h. LM training (``repro_torch.train``; ``LM_RUNS``, the runs of
   ``LM_PHASE_RUNS["lm"]``): smollm-360m at its published config (32
   layers, d_model 960, 15 / 5 heads of 64, d_ff 2560, vocab 49152,
   bfloat16, random weights from a seed), 4 agents, one process each
   (this script's ``--lm-worker`` mode), all on the one card over gloo
   staged through host memory, the ring topology with self-weight 1/3 and
   the JAX driver's settings (alpha 0.02, beta 0.5, mu_g 0.1, K = 3, L_g
   = 2.0, 4 x 256 tokens an agent from ``TokenTaskStream``, ``ce_chunk``
   256, ``remat`` on).  First the reduced float32 config of
   tests/test_torch_train.py, 2 INTERACT steps on the card and on the
   CPU in the same group: x and u within ``LM_CARD_CPU_TOL`` of each
   leaf's scale.  Then (a) INTERACT, 2 steps (the first a warm-up; 4
   before phase 4l joined, cut for the script's time limit):
   s/step and the staged mixes' seconds in it (each mix timed between
   two synchronises), tokens/s an agent, ``outer_ce`` and ``grad_norm``
   finite and equal on every rank, no kernel launched (the gradient path
   runs plain attention), each process's peak device memory, the ranks'
   state digests; (c) ``make_eval_step`` at the trained state with
   ``attn_impl="reference"`` and twice with ``"cuda"``: each ``cuda``
   call launches the bf16 flash kernel exactly once an attention layer
   (32; counts set to 0 just before each call), its outer CE within
   ``LM_EVAL_RTOL`` of the reference's; (b) SVR-INTERACT, 2 steps with q
   = 2 (recursive, refresh; 3 before phase 4l joined, cut for the
   script's time limit), finite and equal on every rank.
   Prints each run's ``lm training`` line and the phase's seconds.
4k. LM training of the MoE and hybrid models (``LM_PHASE_RUNS
   ["lm_moe_mamba"]``), after 4h in its worker, each run as 4h's with
   its own cut and steps: mixtral-8x7b at its published widths (d_model
   4096, 32 / 8 heads of 128, its 4096-token window, 8 experts of d_ff
   14336, top 2, vocab 32000) cut to 1 of its 32 layers, 2 agents, 2
   INTERACT steps and 2 SVR-INTERACT steps with q = 2 (recursive,
   refresh); then jamba-1.5-large at its published widths (d_model 8192,
   64 / 8 heads of 128, d_inner 16384, d_state 16, d_ff 24576, top 2,
   vocab 65536) cut to one 2-layer period (attention with a dense ffn,
   then mamba with a moe ffn) and 4 of its 16 experts, 1 agent, 2
   INTERACT steps and no SVR-INTERACT (``LM_RUNS`` says why); each with
   its reduced float32 config on the card against the CPU (4k runs
   after 4l and 4h in their worker).  Besides 4h's
   checks: in the warm-up step each moe layer's capacity route is taken
   5 times (the outer loss's forward and its recompute in the backward
   pass, the inner features, the cross term's forward and its
   recompute), and each recompute routes every token to the same slots
   as its forward (a digest of the route); the dropped-slot share of
   each call is printed.  The eval step launches the bf16 flash kernel
   once (one attention layer in each cut).  Prints each run's ``lm
   training`` line and the phase's seconds.
4l. LM training at full size (``LM_PHASE_RUNS["lm_dense_ssm_vlm"]``),
   first in the LM worker, each run as 4h's, 1 agent, nothing cut:
   gemma2-2b (26 layers, d_model 2304, 8 / 4 heads of 256, d_ff 9216,
   vocab 256,000, softcaps 50 and 30, local and global layers with a
   4096-token window) and rwkv6-3b (32 layers, d_model 2560, 40 heads of
   64, d_ff 8960, vocab 65,536), each 2 INTERACT and 2 SVR-INTERACT steps
   with q = 2 (recursive, refresh); paligemma-3b (18 layers, d_model 2048,
   8 / 1 heads of 256, d_ff 16384, vocab 257,216) with its 256 prefix
   embeddings of width 1152 (``PREFIX_SCALE`` * N(0, 1) from a seed, each
   step's (1, 4, 256, 1152) batch split inner and outer as the tokens),
   2 INTERACT steps through ``make_train_step(..., with_prefix=True)``,
   no SVR-INTERACT (neither package's SVR step takes a prefix); the
   reduced float32 config on the card against the CPU (paligemma's with
   its prefix; rwkv6's within its own ``card_cpu_tol``).  The eval step
   (no prefix in either package) launches the bf16 flash kernel once an
   attention layer (26 and 18 a call) and WKV6 once an rwkv layer (32),
   nothing else; no train step launches a kernel (the gradient paths run
   plain attention and the plain WKV6 token loop).  rwkv6's line also
   gives the token loop (``wkv6_ref``) timed alone at a split's shape
   and its estimated share of an INTERACT step.  In 4h, 4k, 4l and 4m
   each run's processes import (``torch._dynamo`` too) while the run
   before it trains, across the phases.
4m. LM training in the pods layout (``LM_PHASE_RUNS["lm_pods"]``, after
   4h in the LM worker): ``make_train_step(..., agent_mode="pods")``, an
   agent a pod of processes, its state sharded over the pod
   (``repro_torch.sharding.partition``), on a (2, 2, 1) process mesh
   (``launch.mesh.make_production_mesh``, ``distributed.pods_mesh``): 2
   agents x pods of 2, 4 processes on the card over gloo staged.  (a) The
   float32 gate: reduced mixtral-8x7b (``LM_REDUCED``) at capacity factor
   1.0, 2 INTERACT steps as pods and, from the same state and tokens, in
   the rows layout on each rank's ring (2 processes, whole states): each
   rank's shards within ``PODS_XY_TOL`` (x, y) and ``PODS_UV_TOL`` (u, v,
   p_prev) of the rows state's slices, relative to each whole leaf's
   scale; the pod's dropped slots, a moe call at a time, equal to the
   rows agent's, and some dropped.  (b) smollm-360m at its published
   config, nothing cut, bf16, 4h's settings: each process's state bytes
   exactly the partition rule's (bf16 throughout), 2 INTERACT steps (the
   first a warm-up) and 2 SVR-INTERACT steps with q = 2, metrics finite
   and equal on every rank, no kernel launched; s/step with the pod's
   collectives' seconds (gathers, reduce-scatters, all-reduces) and the
   ring mixes' seconds in it, each timed between two synchronises;
   SVR-INTERACT's recursive and refresh steps apart; tokens/s an agent;
   peak memory beside 4h's rows peaks in the same call; digests.  (c) The state gathered over each pod,
   the rows ``make_eval_step`` on each pod's data-0 rank (their ring) as
   4h's: 32 bf16 flash launches a cuda call, CE within ``LM_EVAL_RTOL``
   of plain attention.
4i. Mamba and MoE serving (``MOE_MAMBA_RUNS``, the cuts printed on the
   phase's first line): mixtral-8x7b at its published widths (d_model
   4096, d_ff 14336, 8 experts top 2, 32 / 8 heads of 128, a 4096-token
   window, vocab 32000) cut to 8 of its 32 layers, batch 2, prompts of
   4608 tokens; jamba-1.5-large at its published widths (d_model 8192,
   d_inner 16384, d_state 16, d_conv 4, d_ff 24576, 64 / 8 heads of 128,
   vocab 65536, top 2) cut to one period (8 of its 72 layers: attention,
   then 7 mamba layers, moe on every other) and 8 of its 16 experts,
   batch 1, prompts of 2048 tokens; 16 greedy decode steps each, random
   weights from a seed.  (a) bfloat16, the flow of phase 5 (kernel
   prefill, plain cached prefill, decode, kernel prefill of the prompt
   and the fed tokens), gated on finite logits and on the flash launches
   (8 a prefill for mixtral, 1 for jamba), with the same timings and
   profiles, the peak memory and each moe layer's share of dropped token
   slots on the kernel prefill's capacity route (``moe_drop_shares``).
   (b) float32 at depth 2 (``MOE_MAMBA_GATE_CUTS``: mixtral's first two
   layers; jamba's attention layer with its dense ffn and a mamba layer
   with its moe ffn at 8 experts), the float32 flash path, gated at
   ``SERVE_RTOL`` like with like: ``gap_a_b`` the kernel prefill against
   the capacity route's plain prefill (``make_prefill_step(attn_impl=
   "reference")``), ``gap_c_d`` the last decode step against the exact
   route's cached prefill of the prompt and the fed tokens (the mamba
   state, the conv tail and the window ring carried); the capacity
   against exact gaps are reported beside them.  (c) the reduced float32
   configs of tests/test_torch_lm.py on the card and on the CPU from the
   same parameters (``CARD_CPU_RUN``: the kernel prefill, the cached
   prefill and 4 decode steps), within ``CARD_CPU_RTOL`` of each
   logit's scale.  Between (a) and (b), ``moe_mamba_breakdown`` times one
   moe ffn and its expert products, and one mamba layer's scan and whole
   block, alone at the bfloat16 prefill shapes: the dispatch's and the
   scan's shares of a prefill.  Prints the phase's seconds.
4j. Frontend serving (``FRONTEND_RUNS``): paligemma-3b (18 layers,
   d_model 2048, d_ff 16384, 8 / 1 heads of 256, vocab 257,216, 256
   prefix embeddings of width 1152) and musicgen-medium (48 layers,
   d_model 1536, d_ff 6144, 24 / 24 heads of 64, vocab 2048, 64 prefix
   embeddings of width 768) at their published configs, nothing cut,
   random weights from a seed, batch 4, 256 text and 1500 audio tokens
   after the prefix, 16 greedy decode steps; the stub frontends'
   embeddings are ``PREFIX_SCALE`` (0.1) * N(0, 1).  (a) bfloat16, the
   flow of phase 5 with the prefix on the kernel prefill: the kernel
   prefill with the prefix (and its plain counterpart, reported), the
   plain cached prefill of the tokens and the decode steps (neither
   package's cached path takes a prefix), the kernel prefill of the
   prompt and the fed tokens; gated on finite logits and on exactly 18
   and 48 bf16 flash launches a kernel prefill (counts set to 0 just
   before each model's run), with the same timings and profiles and the
   peak memory.  (b) float32, the same flow, gated at ``SERVE_RTOL``
   like with like: ``gap_a_b`` the kernel prefill with the prefix
   against ``make_prefill_step(attn_impl="reference")`` with it,
   ``gap_blockwise`` the ``"blockwise"`` prefill with the prefix against
   the same, ``gap_c_d`` the last decode step against the kernel prefill
   of the prompt and the fed tokens and ``gap_c_e`` against their
   cached prefill; the float32 path's launches (split pass and kernel,
   18 and 48 each a prefill).  Prints the phase's seconds.
5. Serving path: gemma2-2b and rwkv6-3b at full size (published config,
   random weights from a seed), batch 4, prompts of 4608 and 1024 random
   tokens, 16 greedy decode steps.  In float32: the kernel prefill (a)
   and the plain cached prefill (b) agree, the last decode step's logits
   (c) agree with a kernel prefill of the prompt plus the fed tokens
   (d), and each kernel prefill launched the kernel once per layer
   (counts set to 0 just before each model's run; for gemma2-2b the
   float32 split pass and kernel, never the bf16 one).  Then the same flow
   in bfloat16, the configs' published dtype, gated on finite logits
   only (each gemma2-2b prefill makes its 26 flash launches on the
   bf16 kernel), with a profile of one prefill and one decode
   step.  In both
   dtypes the gated calls are the warm-up of the timing that follows
   them: three kernel prefills, three plain cached prefills and three
   runs of 16 decode steps, each time reported as the median and the
   three runs.
6. Prints each phase's host-clock seconds, then a ``{"kernels": [...]}``
   line (with the registers and spills nvcc reports for each
   instantiation of the redesigned kernels, the consensus kernels'
   bfloat16 times, the row-block forms with phase 4g's launches, the bf16
   flash kernel with phases 4h's, 4k's and 4l's launches and its times at
   their eval steps' shapes, WKV6 with phase 4l's launches and its time
   at its eval shape, and the flash kernels with
   phase 4i's and 4j's launches and their times at their shapes), the
   card's name and power limit, then the last line
   ``{"ok": true, "device": {...}}``.  Any failed
   check raises, so the script exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 FLOP/s
# outside the tensor cores, dense bf16 tensor-core FLOP/s.  All assume
# the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

ALPHA = 0.3
F32_TOL, BF16_TOL = 1e-5, 3e-2
MAIN_SHAPE = (5, 760)          # m agents x D = 760 backbone parameters
LARGE_SHAPE = (16, 4194304)    # large enough that the kernel, not the launch, sets the time
# the consensus kernels' edges: agents (1, 3 and 5 take the step's
# kBothStreams staging, 16 kEachStream, 17 its kPasses and the mix's two
# passes of 16 rows) and row lengths (760 and 4096 take the 16-byte path
# in both dtypes, 1, 3, 123 and 761 in neither), each aligned and one
# element into its storage (a misaligned base: the element path)
MIX_EDGE_M = (1, 3, 5, 16, 17)
MIX_EDGE_D = (1, 3, 123, 760, 761, 4096)
NUM_STEPS, RECORD_EVERY = 40, 5
# The algorithms phase (4b) records eq. 11 every 10 steps and runs the
# eager loop for the first 10 (an eager record takes 1-2 s of host time,
# an eager step 0.2-0.4 s): the captured run's first records are the
# eager run's
ALGO_EAGER_STEPS, ALGO_RECORD_EVERY = 10, 10
ALGORITHMS = ("interact", "svr-interact", "gt-dsgd", "d-sgd")
# the consensus kernel each algorithm's step launches once
STEP_KERNEL = {"interact": "consensus_step", "svr-interact": "consensus_step",
               "gt-dsgd": "consensus_step", "d-sgd": "consensus_mix"}
# each consensus kernel's symbol, which names its torch.profiler events
KERNEL_SYMBOL = {"consensus_step": "consensus_step_kernel",
                 "consensus_mix": "consensus_mix_kernel"}
PRIMER_LAUNCHES = 32    # see ``profiled``
LAUNCH_WINDOWS = 3      # profiled runs at most, see ``counted_launches``
LAUNCH_SHIFT = 97       # more leading spins in each later window
PRIMER_SYMBOL = "spin_kernel"    # what torch.cuda._sleep launches
# The cuda and dense runs differ only in how the mix is summed (the
# kernel's sequential FMAs vs cuBLAS), a float32 rounding difference.
# The port's one-step state gap against the JAX package is below 2e-6
# of each field's scale (tests/test_torch_interact.py); over 40 steps
# that allows 40 * 2e-6 = 8e-5 relative between the two traces.  The
# same bound holds a captured trace to its eager one (the graphs hold
# the eager step's kernels in its order: the gap is expected to be 0).
TRACE_RTOL = NUM_STEPS * 2e-6

# The wire (4c) and Byzantine (4d) rows run ROW_STEPS steps (40 before
# phase 4i joined, cut for the script's time limit; 26 is the least that
# keeps SVR-INTERACT's refresh step, q = 25, in its rows), each checked
# at that depth: ROW_RTOL is ROW_STEPS times the 2e-6 one-step bound.
ROW_STEPS = 26
ROW_RTOL = ROW_STEPS * 2e-6
# The wire phase (4c): chip_smoke's rows of the compressed wire and the
# time-varying topologies, each (algorithm, options, the consensus
# kernels the ROW_STEPS replayed steps of its captured ``solve`` launch).  A
# mixing step of the wire path is two consensus_mix launches (x and u;
# one for D-SGD), a silent step none; a topology stream without a wire
# is one consensus_step a step, fed a fresh matrix.
WIRE_ROWS = {
    "sign1bit-ef-warm5-k2": ("interact", dict(
        compression=dict(kind="sign1bit", compress_after=5),
        communication_interval=2), dict(consensus_mix=26, consensus_step=0)),
    "topk-gamma0.5": ("interact", dict(
        compression=dict(kind="topk", topk_frac=0.05, gamma=0.5)),
        dict(consensus_mix=52, consensus_step=0)),
    "int8-ef svr-interact": ("svr-interact", dict(
        compression=dict(kind="int8")),
        dict(consensus_mix=52, consensus_step=0)),
    "int8-ef d-sgd": ("d-sgd", dict(compression=dict(kind="int8")),
                      dict(consensus_mix=26, consensus_step=0)),
    "link-failure-0.3": ("gt-dsgd", dict(topology_process=dict(
        kind="link-failure", p=0.3, period=40)),
        dict(consensus_mix=0, consensus_step=26)),
    "adaptive": ("interact", dict(topology_process=dict(
        kind="adaptive", tau=1.0)), dict(consensus_mix=0, consensus_step=26)),
}
# The short eager run each wire row is held to, captured against eager,
# bit for bit: 8 steps take sign1bit-ef-warm5-k2 through warm-up, silent
# and compressed rounds.
WIRE_EAGER_STEPS = 8
# consensus_mix launches of solve's round-latency timing (time_round_us:
# one warm call and 5 timed ones)
ROUND_LATENCY_MIXES = 6
# cuda against dense, the last M relative: the uncompressed topology rows
# take ROW_RTOL; the compressed rows WIRE_RTOL, the 6.4e-7 largest
# one-step gap of the six rows against the JAX package
# (tests/test_torch_wire.py) times ROW_STEPS times a margin of 4 for the
# compressors' discontinuities (an int8 rounding, a top-k near tie or a
# sign that a rounding difference flips): 6.7e-5 (1e-4 at 40 steps).
WIRE_RTOL = 6.4e-7 * ROW_STEPS * 4

# The Byzantine phase (4d): chip_smoke's rows of the Byzantine layer on
# the Section-6 instance, each (algorithm, ER edge probability (1.0: the
# complete graph of benchmarks/bench_byzantine.py), ByzantineConfig
# options, GuardConfig options, the consensus kernels the ROW_STEPS
# replayed steps of its captured ``solve`` launch).  An attack or a robust rule
# puts the step on the wire path: a weighted round is two consensus_mix
# launches, a robust rule's combine launches no consensus kernel (plain
# PyTorch, as the reference's is jnp outside any Pallas kernel).
SIGN_FLIP1 = dict(kind="sign-flip", num_byzantine=1, scale=25.0)
BYZANTINE_ROWS = {
    "signflip1-weighted": ("interact", 1.0, SIGN_FLIP1, None,
                           dict(consensus_mix=52, consensus_step=0)),
    "signflip0-weighted": ("interact", 1.0, dict(SIGN_FLIP1,
                                                 num_byzantine=0), None,
                           dict(consensus_mix=52, consensus_step=0)),
    "signflip1-trimmed1": ("interact", 1.0, dict(
        SIGN_FLIP1, combine="trimmed-mean", trim=1), None,
        dict(consensus_mix=0, consensus_step=0)),
    "signflip1-median-gt-dsgd": ("gt-dsgd", 0.5, dict(
        SIGN_FLIP1, combine="coordinate-median"), None,
        dict(consensus_mix=0, consensus_step=0)),
    "gaussian2-krum-svr": ("svr-interact", 1.0, dict(
        kind="gaussian", num_byzantine=2, scale=25.0, combine="krum-like"),
        None, dict(consensus_mix=0, consensus_step=0)),
    "signflip1-weighted-guard": ("interact", 1.0, SIGN_FLIP1, dict(
        nan=True, max_norm=1e3), dict(consensus_mix=52, consensus_step=0)),
}
# benchmarks/bench_byzantine.py's gates: one sign-flip attacker under the
# weighted rule ends beyond 10x the clean run's M (or non-finite), gated
# here; trimmed-mean with f = 1 within 3x of the same rule with no
# attacker, reported here and not gated: on this instance the JAX
# package's own runs end far beyond it too (ROADMAP Queue C), so the
# trimmed row is gated on containment (a finite last M below M_0)
WEIGHTED_DIVERGE_FACTOR = 10.0
TRIMMED_GATE_FACTOR = 3.0

# The sweep phase (4e): seeds of the Figure-2 grid, the step-size grid's
# seeds and alphas, and the padded grid's network sizes, topologies and
# seeds
SWEEP_SEEDS = 4       # was 8: cut for the script's time limit
# The batched consensus kernels' cases (experiments, agents; rows of 760
# values take the 16-byte path aligned and the element path one element
# into their storage), the Figure-2 groups' B among them, and those
# groups' shape of SWEEP_SEEDS seeds x 5 agents x 760 backbone parameters.
BATCH_B = tuple(sorted({1, 3, 8, SWEEP_SEEDS}))
BATCH_M = (4, 5, 16)
BATCH_D = 760
SWEEP_SHAPE = (SWEEP_SEEDS, 5, BATCH_D)
ALPHA_GRID = dict(seed=range(2), alpha=(0.3, 0.1))
PADDED_GRID = dict(num_agents=(4, 8), topology=("ring", "erdos-renyi"),
                   seed=range(3))
# The step-size and padded checks hold two runs of the same steps to each
# other, so they record the eq.-11 metric at 30 inner steps (not 300):
# its graphs and eager warm-ups cost a tenth
CHECK_INNER_STEPS = 30
# The resilience phase (4f): a run of NUM_STEPS steps recording every 10,
# snapshotted every 7 steps (boundaries fall between the records), killed
# at step 18 (the boundary after it, 21, is lost: 7 steps back to 14);
# its checks compare runs of the same steps, so eq. 11 at
# CHECK_INNER_STEPS.  The SVR-INTERACT campaign fires every fault kind:
# two transient write failures at 7, garbage in the snapshot at 14, a
# kill at 18 (lost back to 7), NaN at 24 (caught at 28, back to 21), a
# truncated snapshot at 35, a kill at 38 (lost back to 28), the final
# snapshot deleted; so 3 restarts, 2 kills, 1 caught NaN, and 61 wasted
# steps (``ChaosReport``'s count: the steps each failed attempt took from
# where it started, 21 + 21 + 19).
RESILIENCE_RECORD_EVERY = 10
CHECKPOINT_EVERY = 7
KILL_AT = 18
SNAPSHOT_REPS = 5
CHAOS_FAULTS = (("write-failure", dict(step=7, count=2)),
                ("corrupt-checkpoint", dict(step=14, mode="garbage")),
                ("kill", dict(step=18)), ("nan-payload", dict(step=24)),
                ("corrupt-checkpoint", dict(step=33, mode="truncate")),
                ("kill", dict(step=38)), ("stale-checkpoint", dict(step=36)))
CHAOS_WANT = dict(completed=True, restarts=3, kills=2, nonfinite_faults=1,
                  write_retries=2, wasted_steps=61, guard_rollbacks=0,
                  guard_accepted=0)
CHAOS_COUNTERS = tuple(CHAOS_WANT)

# The distributed phase (4g): the Section-6 instance at full width through
# ``python -m repro_torch.launch.launch_local``, INTERACT, DIST_STEPS steps
# (was 40: cut for the script's time limit), eq. 11
# (300 inner steps, phase 4b's) every 10, each layout (backend, processes,
# wire) against the single-process cuda eager run
DIST_LAYOUTS = (("allgather", 5, "gloo"), ("ppermute", 5, "gloo"),
                ("allgather", 1, "nccl"))
DIST_STEPS, DIST_RECORD_EVERY, DIST_INNER_STEPS = 20, 10, 300
DIST_TIMEOUT = 300
# The LM training phases (4h, 4k, 4l): each run trains an arch at its
# published widths (bfloat16, random weights from a seed) with the cut
# stated, one agent a process, all on the one card over gloo staged through
# host memory, with the JAX training driver's settings
# (src/repro/launch/train.py): the ring topology, LM_BATCH x LM_SEQ tokens
# an agent a step, LM_HYPER, LM_ALPHA, LM_BETA.  A run's INTERACT steps
# (the first a warm-up) and its SVR-INTERACT steps with refresh period q
# (none where svr_steps is 0).  A config with a frontend takes its prefix
# embeddings in every INTERACT step (``make_train_step(...,
# with_prefix=True)``).
LM_RUNS = {
    # 4h: smollm-360m at its published config, nothing cut; 2 INTERACT
    # and 2 SVR-INTERACT steps (4 and 3 before phase 4l joined, cut for
    # the script's time limit)
    "smollm-360m": dict(cut={}, agents=4, interact_steps=2, svr_steps=2,
                        q=2),
    # 4k: mixtral-8x7b (arXiv:2401.04088) cut to 1 of its 32 layers, all 8
    # experts: a 1.58 B-parameter backbone (3.16 GB); 2 agents, whose ring
    # of 2 is one permute round a mix (weight 2/3 on the one peer)
    "mixtral-8x7b": dict(cut=dict(num_layers=1), agents=2, interact_steps=2,
                         svr_steps=2, q=2),
    # 4k: jamba-1.5-large (arXiv:2403.19887) cut to one period of 2 layers
    # (attention with a dense ffn, then mamba with a moe ffn), as phase 4i's
    # float32 gate cuts it, and to 4 of its 16 experts, the most that fit:
    # a 4.11 B-parameter backbone (7.66 GiB), of which an INTERACT step
    # holds about 7 at its peak (the state's 3, the mixes' 2, the new
    # hypergradient and tracked gradient) beside the float32 copies the
    # update makes of the largest leaf (4 x 805 M values): 68.2 GiB
    # allocated, 70.7 reserved, of the 74.1 an H100 80GB had free at its
    # start; the scan whole (no ``mamba_seq_chunk``: chunks leave the peak
    # as it is); a fifth expert adds 1.13 GiB to the backbone and about 9
    # to the peak; 1 agent; no SVR-INTERACT, whose recursive step holds 2
    # backbones more
    "jamba-1.5-large-398b": dict(
        cut=dict(num_layers=2, attn_every=2, num_experts=4), agents=1,
        interact_steps=2, svr_steps=0, q=2),
    # 4l: gemma2-2b (arXiv:2408.00118) and rwkv6-3b (arXiv:2404.05892) at
    # their published configs, nothing cut, 1 agent each
    "gemma2-2b": dict(cut={}, agents=1, interact_steps=2, svr_steps=2, q=2),
    # rwkv6-3b: its reduced float32 config on the card within 2e-4 of the
    # CPU (see LM_CARD_CPU_TOL)
    "rwkv6-3b": dict(cut={}, agents=1, interact_steps=2, svr_steps=2, q=2,
                     card_cpu_tol=2e-4),
    # 4l: paligemma-3b (arXiv:2407.07726) at its published config, nothing
    # cut, with its 256 prefix embeddings; 1 agent; no SVR-INTERACT:
    # neither package's SVR step takes a prefix
    "paligemma-3b": dict(cut={}, agents=1, interact_steps=2, svr_steps=0,
                         q=2),
    # 4m: the pods layout (agent_mode="pods"): smollm-360m at its published
    # config, nothing cut, as 2 agents each a pod of 2 processes (4 on the
    # card over gloo staged), each agent's state sharded over its pod; 4h's
    # settings.  Its float32 gate first: reduced mixtral-8x7b at capacity
    # factor 1.0 (slots drop) as pods against the rows layout's 2 processes
    "smollm-360m-pods": dict(arch="smollm-360m", cut={}, agents=2, pod=2,
                             interact_steps=2, svr_steps=2, q=2,
                             gate="mixtral-8x7b",
                             gate_cut=dict(capacity_factor=1.0)),
}
# the runs of each LM training phase, in order: no two runs' processes
# use the card at once (a run's processes start, and import, while the run
# before it trains, and join their group once it has ended)
LM_PHASE_RUNS = {"lm": ("smollm-360m",),
                 "lm_pods": ("smollm-360m-pods",),
                 "lm_moe_mamba": ("mixtral-8x7b", "jamba-1.5-large-398b"),
                 "lm_dense_ssm_vlm": ("gemma2-2b", "rwkv6-3b",
                                      "paligemma-3b")}
LM_BATCH, LM_SEQ = 4, 256
LM_HYPER = dict(mu_g=0.1, neumann_k=3, lipschitz_g=2.0, ce_chunk=256,
                remat=True)
LM_ALPHA, LM_BETA = 0.02, 0.5
LM_TIMEOUT = 600
# the card against the CPU at tests/test_torch_train.py's reduced float32
# settings (each run's arch reduced), 2 INTERACT steps: cuBLAS against the
# CPU's BLAS, float32 rounding (the port's gaps to the JAX package there
# are about 3e-6)
LM_REDUCED = dict(vocab_size=128, num_layers=2, dtype="float32")
LM_REDUCED_HYPER = dict(mu_g=0.5, neumann_k=2, lipschitz_g=4.0, ce_chunk=16,
                        remat=False)
LM_CARD_CPU_TOL = 1e-5
# except where a run states its own ``card_cpu_tol``: rwkv6-3b's (2e-4).
# Its reduced problem is ill-conditioned in exact arithmetic: in float64
# on the CPU a relative 1e-6 change of x moves the hypergradient of layer
# 1's bonus u by 4.2e-4 of its scale, so float32 rounding alone puts the
# CPU's float32 steps 1.7e-5 (u) and 8.6e-6 (x) from float64 ones, and the
# card's were 3.9e-5 from the CPU's on an H100 (every route in float32:
# the model casts to it throughout, so a float64 run is no cure)
# the eval step's outer CE with the bf16 flash kernel against plain
# attention in bfloat16, relative: about 3 times the largest gap measured
# on an H100 (3.0e-5, smollm-360m after 4 steps; 4.7e-6 and 1.1e-5 at
# 4k's cuts); the random head keeps the CE near ln(vocab), so a looser
# bound would pass a wrong attention output
LM_EVAL_RTOL = 1e-4
# phase 4m's float32 gate, the pods layout against the rows layout on the
# card, relative to each whole leaf's scale (tests/test_torch_pods.py's
# bounds against the JAX package)
PODS_XY_TOL, PODS_UV_TOL = 1e-5, 1e-4
# Phases 4e-4h, 4k and 4l run in worker processes of this script
# (``--phase-worker``), one group of phases each, beside the main process's
# 4c-4d: all are bound by the host, not the card, and no group takes
# longer than the LM training phases, which share one worker so that no
# two training runs' memory meets on the card; 4k comes last, so that
# jamba's 70.7 GiB reserved, the most of any run, come after the other
# groups' phases (an H100 host ran those in 168-250 s, the LM phases in
# 274).  A worker's consensus counts start at 0 with each of its phases;
# the main process waits for them at most PHASE_WORKER_TIMEOUT seconds
# from their start
PHASE_GROUPS = (("sweep",), ("distributed", "resilience"),
                ("lm_dense_ssm_vlm", "lm", "lm_pods", "lm_moe_mamba"))
PHASE_WORKER_TIMEOUT = 800
# the row-block kernels' shapes, (rows, m, D) and the block's first row:
# one agent of the main path's 5, and 4 rows of the large shape's 16
ROW_SHAPES = {"main": (1, 5, 760, 2), "large": (4, 16, 4194304, 6)}

SOURCE = "src/repro_torch/kernels/consensus_step/csrc/consensus_step.cu"
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
WKV_SOURCE = "src/repro_torch/kernels/rwkv6/csrc/wkv6.cu"
REPLACES = {
    "consensus_step": "src/repro/kernels/consensus_step/kernel.py:83",
    "consensus_mix": "src/repro/kernels/consensus_step/kernel.py:52",
}
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:100"
WKV_REPLACES = "src/repro/kernels/rwkv6/kernel.py:89"

# Flash attention shapes: (b, sq, skv, nh, nkv, hd, causal, window, softcap,
# q_offset).  The first seven are tests/test_kernels.py's FLASH_CASES
# (sq = skv, q_offset 0); each runs in float32 (the split pass and the
# split-operand kernel) and in bfloat16 (the bf16 tensor-core kernel).
FLASH_SHAPES = [
    (2, 256, 256, 4, 2, 64, True, None, None, 0),
    (1, 256, 256, 8, 1, 128, True, None, None, 0),   # MQA
    (1, 256, 256, 4, 4, 64, True, 128, None, 0),     # SWA
    (1, 192, 192, 4, 2, 64, True, None, 50.0, 0),    # softcap
    (1, 256, 256, 4, 2, 64, True, 64, 30.0, 0),      # SWA+softcap
    (2, 128, 128, 4, 2, 64, False, None, None, 0),   # bidirectional
    (1, 200, 200, 4, 2, 64, True, None, None, 0),    # ragged
    (1, 1, 256, 4, 2, 64, True, None, None, 255),    # decode
    (2, 7, 300, 8, 4, 256, True, 64, 50.0, 293),     # suffix, SWA
    (1, 100, 100, 4, 2, 64, False, None, None, 0),   # non-causal ragged
    (1, 100, 100, 4, 2, 64, True, None, None, 110),  # offset past keys
    (1, 8, 16, 2, 1, 32, True, 6, None, 16),         # rows that see no key
]
# gemma2-2b's two layer kinds at the serving shape
GEMMA_GLOBAL = (4, 4608, 4608, 8, 4, 256, True, None, 50.0, 0)
GEMMA_LOCAL = (4, 4608, 4608, 8, 4, 256, True, 4096, 50.0, 0)
# phase 4i's attention layers: jamba's (64 q heads over 8 kv heads, no
# window) and mixtral's (32 over 8, a 4096-token window on every layer),
# head size 128, no softcap, at their prefill shapes
JAMBA_ATTN = (1, 2048, 2048, 64, 8, 128, True, None, None, 0)
MIXTRAL_ATTN = (2, 4608, 4608, 32, 8, 128, True, 4096, None, 0)
# phase 4j's attention layers: paligemma-3b's (8 query heads over one kv
# head of 256, over 256 prefix and 256 text positions) and
# musicgen-medium's (24 over 24 heads of 64, over 64 prefix and 1500 audio
# positions), causal, no window, no softcap, at their prefill shapes
PALIGEMMA_ATTN = (4, 512, 512, 8, 1, 256, True, None, None, 0)
MUSICGEN_ATTN = (4, 1564, 1564, 24, 24, 64, True, None, None, 0)
FLASH_CASES = (
    [c + ("float32",) for c in FLASH_SHAPES]
    + [c + ("bfloat16",) for c in FLASH_SHAPES]
    + [(1, 256, 256, 2, 2, 256, True, None, None, 0, "bfloat16"),
       (1, 128, 128, 4, 2, 32, True, None, None, 0, "bfloat16"),
       # smollm-360m's eval step (phase 4h) in float32 (bfloat16: in
       # FLASH_MAIN)
       (4, 256, 256, 15, 5, 64, True, None, None, 0, "float32"),
       (1, 600, 600, 8, 4, 256, True, 4096, 50.0, 0, "float32"),
       (2, 520, 520, 8, 4, 256, True, 200, 50.0, 0, "float32")]
    # 8 q heads a kv head at head size 128, windowed and ragged
    + [(1, 300, 300, 16, 2, 128, True, 100, None, 0, dt)
       for dt in ("float32", "bfloat16")])
# the LM training phases' eval steps (4h, 4k), bfloat16 at LM_BATCH x
# LM_SEQ tokens: smollm-360m's 15 q and 5 kv heads of 64; mixtral's 32
# over 8 of 128 with its 4096-token window, wider than the sequence;
# jamba's 64 over 8 of 128
SMOLLM_TRAIN = (4, 256, 256, 15, 5, 64, True, None, None, 0)
MIXTRAL_TRAIN = (4, 256, 256, 32, 8, 128, True, 4096, None, 0)
JAMBA_TRAIN = (4, 256, 256, 64, 8, 128, True, None, None, 0)
# phase 4l's eval steps: gemma2-2b's 8 over 4 heads of 256 with its
# attention softcap (its local layers' 4096-token window spans the 256
# keys, so both layer kinds compute this); paligemma-3b's 8 over 1 of 256
# on the tokens alone (neither package's eval step takes a prefix)
GEMMA2_TRAIN = (4, 256, 256, 8, 4, 256, True, 4096, 50.0, 0)
PALIGEMMA_TRAIN = (4, 256, 256, 8, 1, 256, True, None, None, 0)
# Checked and timed: both dtypes at gemma2's global and local shapes and
# at phase 4i's and 4j's two; bfloat16 at the eval steps' five.
FLASH_MAIN = {
    "global": GEMMA_GLOBAL + ("bfloat16",),
    "local": GEMMA_LOCAL + ("bfloat16",),
    "global_f32": GEMMA_GLOBAL + ("float32",),
    "local_f32": GEMMA_LOCAL + ("float32",),
    "jamba": JAMBA_ATTN + ("bfloat16",),
    "jamba_f32": JAMBA_ATTN + ("float32",),
    "mixtral": MIXTRAL_ATTN + ("bfloat16",),
    "mixtral_f32": MIXTRAL_ATTN + ("float32",),
    "paligemma": PALIGEMMA_ATTN + ("bfloat16",),
    "paligemma_f32": PALIGEMMA_ATTN + ("float32",),
    "musicgen": MUSICGEN_ATTN + ("bfloat16",),
    "musicgen_f32": MUSICGEN_ATTN + ("float32",),
    "smollm_train": SMOLLM_TRAIN + ("bfloat16",),
    "mixtral_train": MIXTRAL_TRAIN + ("bfloat16",),
    "jamba_train": JAMBA_TRAIN + ("bfloat16",),
    "gemma2_train": GEMMA2_TRAIN + ("bfloat16",),
    "paligemma_train": PALIGEMMA_TRAIN + ("bfloat16",),
}
# attention_blockwise (plain PyTorch: the JAX package's streaming softmax
# over kv blocks) against the plain attention at phase 4j's two shapes in
# float32, its output and its gradients with respect to q, k and v (of one
# random cotangent): every difference within BLOCKWISE_RTOL of the plain
# tensor's max-abs scale (the same float32 arithmetic in another order:
# tests/test_torch_blockwise.py measures a few 1e-7 against the JAX one)
BLOCKWISE_SHAPES = {"paligemma": PALIGEMMA_ATTN, "musicgen": MUSICGEN_ATTN}
BLOCKWISE_RTOL = 1e-4
# float32: as tests/test_kernels.py (tests/test_torch_flash_attention.py
# emulates the split-operand kernel's arithmetic at under a third of it).
# bfloat16: the wrapper module's per-row gate, ops.row_errors
# at most ops.TC_ROW_RTOL (1e-2) against the plain version in float32 on
# the same bf16 inputs, rows that see no key exactly 0 (the emulation in
# tests/test_torch_flash_attention.py puts the largest row error at
# 2.4e-3, the bf16 output's own rounding).
FLASH_TOL = 2e-5

# WKV6 cases: (b, s, h, N, with_state, dtype), tests/test_kernels.py's
# WKV_CASES (without their TPU chunk sizes), then rwkv6-3b's serving shape.
WKV_CASES = [
    (2, 128, 2, 16, False, "float32"),
    (1, 96, 4, 32, False, "float32"),
    (2, 64, 2, 16, True, "float32"),
    (1, 100, 2, 16, False, "float32"),
    (1, 1, 2, 16, True, "float32"),
    (1, 128, 2, 64, False, "float32"),
    (1, 64, 2, 16, False, "bfloat16"),
    (4, 1024, 40, 64, True, "float32"),
    (4, 1024, 40, 64, True, "bfloat16"),
] + [(2, 37, 3, n, st, dt) for n in (8, 16, 32, 64) for st in (False, True)
     for dt in ("float32", "bfloat16")]
# the strong-decay draw: a quarter of w each exactly 0, in (0, 1e-4) and
# in (0.999, 1); the rest as above
WKV_STRONG = [(2, 37, 3, n, st, dt) for n in (8, 16, 32, 64)
              for st in (False, True) for dt in ("float32", "bfloat16")] + [
    (4, 1024, 40, 64, True, "float32"),
    (4, 1024, 40, 64, True, "bfloat16")]
# kernels whose nvcc report (registers, spills) the kernels line carries
PTXAS_KERNELS = ("consensus_step_kernel", "consensus_mix_kernel",
                 "wkv6_kernel",
                 "flash_attention_f32_kernel", "flash_split_f32_kernel")
# timed: rwkv6-3b's serving shape and phase 4l's eval step (4 x 256
# tokens), both in bfloat16
WKV_MAIN = (4, 1024, 40, 64, False, "bfloat16")
WKV_TRAIN = (4, 256, 40, 64, False, "bfloat16")
WKV_TIMED = {"main": WKV_MAIN, "rwkv6_train": WKV_TRAIN}
WKV_TOL = {"float32": 2e-3, "bfloat16": 5e-2}

# Serving runs: batch, prompt tokens, greedy decode steps.
SERVE_RUNS = {"gemma2-2b": (4, 4608, 16), "rwkv6-3b": (4, 1024, 16)}
# Timed repetitions after the gated runs, which serve as the warm-up:
# prefills, and runs of the same number of decode steps.
SERVE_REPS = 3
# Float32 gate on the logits, relative to their max-abs scale: the
# tolerance of the JAX package's tests/test_prefill_cache.py.
SERVE_RTOL = 1e-3
# Phase 4i, mamba and MoE serving: each model at its published widths,
# cut in depth (and jamba in experts) to fit the one card; (cuts, batch,
# prompt tokens, greedy decode steps) in bfloat16, then the float32 gate
# at depth 2 (mixtral's first two layers; jamba's attention layer with
# its dense ffn and a mamba layer with its moe ffn).
MOE_MAMBA_RUNS = {
    "mixtral-8x7b": (dict(num_layers=8), 2, 4608, 16),
    "jamba-1.5-large-398b": (dict(num_layers=8, num_experts=8), 1, 2048, 16),
}
MOE_MAMBA_GATE_CUTS = {
    "mixtral-8x7b": dict(num_layers=2),
    "jamba-1.5-large-398b": dict(num_layers=2, attn_every=2, num_experts=8),
}
# Phase 4i's card-against-CPU run: tests/test_torch_lm.py's reduced
# float32 configs (four layers), its batch and prompt, 4 decode steps;
# the logits within CARD_CPU_RTOL of their max-abs scale.
CARD_CPU_RUN = (2, 72, 4)
CARD_CPU_RTOL = 1e-4
# Phase 4j, frontend serving: paligemma-3b and musicgen-medium at their
# published configs, nothing cut; (batch, text or audio tokens after the
# prefix, greedy decode steps): paligemma's 256 text tokens after its 256
# image patches, musicgen's 1500 audio tokens (30 s at 50 Hz) after its 64
# conditioning frames.  The stub frontends' embeddings are PREFIX_SCALE *
# N(0, 1) from a seed, as tests/test_arch_smoke.py draws them.
FRONTEND_RUNS = {"paligemma-3b": (4, 256, 16),
                 "musicgen-medium": (4, 1500, 16)}
PREFIX_SCALE = 0.1


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, inner: int, reps: int = 7, graph: bool = False
            ) -> float:
    """Median over ``reps`` CUDA-event timings of ``inner`` back-to-back
    calls, per call, after a warm run.

    Eager calls are issued from Python, so for a small kernel the events
    measure the host's issue rate.  ``graph=True`` captures the ``inner``
    calls in a CUDA graph once and times its replays: the device's own
    time per call, launch gaps inside the graph included.
    """
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        gc.collect()    # see GraphStepper: no graph freed mid-capture
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(inner):
                fn()
        run = g.replay
    else:
        def run():
            for _ in range(inner):
                fn()
    run()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def roofline_ms(nbytes: float, flops: float, peak_flops: float
                ) -> tuple[float, str]:
    """The least time for the work: the larger of the bytes over the HBM
    rate and the flops over ``peak_flops``, and which one it is."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / peak_flops
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_ms(kernel: str, m: int, d: int, itemsize: int) -> tuple[float, str]:
    """Consensus kernels: each input read once, each output written once;
    the flops at the float32 peak."""
    if kernel == "consensus_step":
        nbytes = 6 * m * d * itemsize + m * m * 4
        flops = 4 * m * m * d + 4 * m * d
    else:
        nbytes = 2 * m * d * itemsize + m * m * 4
        flops = 2 * m * m * d
    return roofline_ms(nbytes, flops, FP32_FLOP_PER_S)


def row_bound_ms(kernel: str, rows: int, m: int, d: int, itemsize: int
                 ) -> tuple[float, str]:
    """``bound_ms`` of a row block: the (m, D) tables (x and u, or x),
    the block's (rows, D) p and p_prev and M read once, the block's
    outputs written once; the block's flops."""
    if kernel == "consensus_step":
        nbytes = (2 * m * d + 4 * rows * d) * itemsize + m * m * 4
        flops = 4 * rows * m * d + 4 * rows * d
    else:
        nbytes = (m * d + rows * d) * itemsize + m * m * 4
        flops = 2 * rows * m * d
    return roofline_ms(nbytes, flops, FP32_FLOP_PER_S)


def check_row_kernels(torch, ops, ref):
    """The row-block forms of both consensus kernels (``row0=``) against
    their plain versions at ``ROW_SHAPES``, in both dtypes, each call one
    launch on ``ops.ROW_LAUNCHES``; a block of all m rows bit for bit the
    square launch; times, bounds and the ``addmm`` / ``matmul`` yardsticks
    on the block's rows, float32."""
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(2)
    f32, bf16 = torch.float32, torch.bfloat16
    err = {k: {"float32": 0.0, "bfloat16": 0.0} for k in REPLACES}
    timings = {k: {} for k in REPLACES}
    for where, (rows, m, d, row0) in ROW_SHAPES.items():
        M = torch.rand(m, m, generator=gen, device=dev) + 0.05
        M = (M / M.sum(dim=1, keepdim=True)).contiguous()
        for dtype in (f32, bf16):
            kind = "float32" if dtype == f32 else "bfloat16"
            tol = F32_TOL if dtype == f32 else BF16_TOL
            X, U = (torch.randn(m, d, generator=gen, device=dev).to(dtype)
                    for _ in range(2))
            P, PP = (torch.randn(rows, d, generator=gen, device=dev)
                     .to(dtype) for _ in range(2))
            before = dict(ops.ROW_LAUNCHES)
            got = {"consensus_step": ops.consensus_step_kernel(
                       M, X, U, P, PP, alpha=ALPHA, row0=row0),
                   "consensus_mix": (ops.consensus_mix_kernel(
                       M, X, row0=row0, rows=rows),)}
            torch.cuda.synchronize()
            want = {"consensus_step": ref.consensus_step_rows_ref(
                        M, X, U, P, PP, row0=row0, alpha=ALPHA),
                    "consensus_mix": (ref.consensus_mix_rows_ref(
                        M, X, row0=row0, rows=rows),)}
            for name in REPLACES:
                check(ops.ROW_LAUNCHES[name] == before[name] + 1,
                      f"row-block {name}: a call did not add one launch")
                for g, w in zip(got[name], want[name]):
                    check(g.dtype == dtype and g.shape == (rows, d),
                          f"row-block {name}: dtype/shape")
                    check(torch.allclose(g.float(), w.float(), atol=tol,
                                         rtol=tol),
                          f"row-block {name} ({rows}, {m}, {d}) {kind} "
                          f"disagrees with its plain version beyond {tol}")
                    err[name][kind] = max(err[name][kind], float(
                        (g.float() - w.float()).abs().max()))
            # the block of all m rows is the square launch, bit for bit
            full = ops.consensus_step_kernel(M, X, U, X, U, alpha=ALPHA,
                                             row0=0)
            square = ops.consensus_step_kernel(M, X, U, X, U, alpha=ALPHA)
            check(all(torch.equal(a, b) for a, b in zip(full, square))
                  and torch.equal(ops.consensus_mix_kernel(M, X, row0=0,
                                                           rows=m),
                                  ops.consensus_mix_kernel(M, X)),
                  f"row block 0 .. {m - 1} is not the square launch bit "
                  f"for bit ({kind})")
        print(f"row-block case rows={rows} of m={m} from row {row0}, "
              f"D={d} (float32 and bfloat16): max abs err step "
              f"{err['consensus_step']['float32']:.3e} / "
              f"{err['consensus_step']['bfloat16']:.3e}, mix "
              f"{err['consensus_mix']['float32']:.3e} / "
              f"{err['consensus_mix']['bfloat16']:.3e}; rows 0 .. {m - 1} "
              "bit for bit the square launch", flush=True)
        X, U = (torch.randn(m, d, generator=gen, device=dev)
                for _ in range(2))
        P, PP = (torch.randn(rows, d, generator=gen, device=dev)
                 for _ in range(2))
        Mr = M[row0:row0 + rows].contiguous()
        Ur = U[row0:row0 + rows].contiguous()
        fns = {
            "consensus_step": (
                lambda: ops.consensus_step_kernel(M, X, U, P, PP,
                                                  alpha=ALPHA, row0=row0),
                lambda: ref.consensus_step_rows_ref(M, X, U, P, PP,
                                                    row0=row0, alpha=ALPHA),
                lambda: (torch.addmm(Ur, Mr, X, beta=-ALPHA),
                         torch.addmm(P - PP, Mr, U))),
            "consensus_mix": (
                lambda: ops.consensus_mix_kernel(M, X, row0=row0,
                                                 rows=rows),
                lambda: ref.consensus_mix_rows_ref(M, X, row0=row0,
                                                   rows=rows),
                lambda: torch.matmul(Mr, X))}
        graph, inner = (True, 200) if where == "main" else (False, 5)
        for name, (fn, plain, lib) in fns.items():
            b, by = row_bound_ms(name, rows, m, d, X.element_size())
            timings[name][where] = dict(
                shape=[rows, m, d], row0=row0,
                ms=time_ms(torch, fn, inner, graph=graph),
                plain_ms=time_ms(torch, plain, inner, graph=graph),
                library_ms=time_ms(torch, lib, inner, graph=graph),
                bound_ms=b, bound_by=by)
            print(f"row-block {name} {where}: "
                  + json.dumps(timings[name][where]), flush=True)
    return err, timings


def check_kernels(torch, ops, ref, main_matrix):
    """Every kernel against its plain version; times at two shapes."""
    from repro_torch.core import ring_mixing
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = ([(m, d, f32) for m in (4, 5, 8, 16)
              for d in (123, 512, 700, 2048)]
             + [(8, 512, bf16)]
             + [shape + (dt,) for dt in (f32, bf16)
                for shape in (MAIN_SHAPE, LARGE_SHAPE)])
    err = {k: {"float32": 0.0, "bfloat16": 0.0} for k in REPLACES}
    timings = {k: {} for k in REPLACES}
    for m, d, dtype in cases:
        # the path's own (symmetric) matrix, and a random row-normalised
        # one that is not symmetric: a kernel reading M transposed or with
        # the wrong stride agrees on the first and fails on the second
        if (m, d) == MAIN_SHAPE:
            sym = main_matrix
        else:
            sym = torch.tensor(ring_mixing(m).matrix, dtype=f32, device=dev)
        skew = torch.rand(m, m, generator=gen, device=dev) + 0.05
        skew = (skew / skew.sum(dim=1, keepdim=True)).contiguous()
        check(not torch.allclose(skew, skew.T), "random matrix is symmetric")
        X, U, P, PP = (torch.randn(m, d, generator=gen, device=dev).to(dtype)
                       for _ in range(4))
        tol = F32_TOL if dtype == f32 else BF16_TOL
        kind = "float32" if dtype == f32 else "bfloat16"
        case_err = {name: 0.0 for name in REPLACES}
        for M in (sym, skew):
            got = {"consensus_step": ops.consensus_step_kernel(
                       M, X, U, P, PP, alpha=ALPHA),
                   "consensus_mix": (ops.consensus_mix_kernel(M, X),)}
            want = {"consensus_step": ref.consensus_step_ref(
                        M, X, U, P, PP, alpha=ALPHA),
                    "consensus_mix": (ref.consensus_mix_ref(M, X),)}
            torch.cuda.synchronize()
            for name in REPLACES:
                for g, w in zip(got[name], want[name]):
                    check(g.dtype == dtype and g.shape == w.shape,
                          f"{name} {m}x{d}: dtype/shape")
                    check(torch.allclose(g.float(), w.float(), atol=tol,
                                         rtol=tol),
                          f"{name} {m}x{d} {kind} disagrees with its plain "
                          f"version beyond {tol}")
                    case_err[name] = max(
                        case_err[name],
                        float((g.float() - w.float()).abs().max()))
        for name in REPLACES:
            err[name][kind] = max(err[name][kind], case_err[name])
        print(f"case m={m} D={d} {kind} (symmetric and random M): max abs "
              f"err step {case_err['consensus_step']:.3e} mix "
              f"{case_err['consensus_mix']:.3e} (tol {tol})", flush=True)
        if (m, d) not in (MAIN_SHAPE, LARGE_SHAPE):
            continue
        M = sym
        # the library calls take M in the streams' dtype
        ML = M.to(dtype)
        step = lambda: ops.consensus_step_kernel(M, X, U, P, PP, alpha=ALPHA)
        mix = lambda: ops.consensus_mix_kernel(M, X)
        plain_step = lambda: ref.consensus_step_ref(M, X, U, P, PP,
                                                    alpha=ALPHA)
        plain_mix = lambda: ref.consensus_mix_ref(M, X)
        lib_step = lambda: (torch.addmm(U, ML, X, beta=-ALPHA),
                            torch.addmm(P - PP, ML, U))
        lib_mix = lambda: torch.matmul(ML, X)
        suffix = "" if dtype == f32 else "_bf16"
        for name, fn, plain, lib in (
                ("consensus_step", step, plain_step, lib_step),
                ("consensus_mix", mix, plain_mix, lib_mix)):
            b, by = bound_ms(name, m, d, X.element_size())
            if (m, d) == MAIN_SHAPE:
                # device time from graph replays, and the eager issue rate
                timings[name]["main" + suffix] = dict(
                    shape=[m, d], ms=time_ms(torch, fn, 200, graph=True),
                    plain_ms=time_ms(torch, plain, 200, graph=True),
                    library_ms=time_ms(torch, lib, 200, graph=True),
                    eager_ms=time_ms(torch, fn, 200),
                    eager_plain_ms=time_ms(torch, plain, 200),
                    eager_library_ms=time_ms(torch, lib, 200),
                    bound_ms=b, bound_by=by)
            else:
                timings[name]["large" + suffix] = dict(
                    shape=[m, d], ms=time_ms(torch, fn, 5),
                    plain_ms=time_ms(torch, plain, 5),
                    library_ms=time_ms(torch, lib, 5),
                    bound_ms=b, bound_by=by)
    for m in MIX_EDGE_M:
        for d in MIX_EDGE_D:
            for dtype in (f32, bf16):
                sym = torch.full((m, m), 1.0 / m, device=dev)
                skew = torch.rand(m, m, generator=gen, device=dev) + 0.05
                skew = (skew / skew.sum(dim=1, keepdim=True)).contiguous()
                tol = F32_TOL if dtype == f32 else BF16_TOL
                kind = "float32" if dtype == f32 else "bfloat16"
                paths = {name: [] for name in REPLACES}
                case_err = {name: 0.0 for name in REPLACES}
                for offset in (0, 1):
                    X, U, P, PP = (torch.randn(
                        m * d + offset, generator=gen, device=dev).to(dtype)[
                            offset:].view(m, d) for _ in range(4))
                    for name, operands in (("consensus_step", (X, U, P, PP)),
                                           ("consensus_mix", (X,))):
                        paths[name].append(
                            "16-byte" if ops.takes_16_byte_path(
                                *operands, torch.empty_like(X))
                            else "element")
                    check(paths["consensus_step"] == paths["consensus_mix"],
                          f"edge {m}x{d}: the step's operands and x take "
                          "different paths")
                    for M in (sym, skew):
                        got = {"consensus_step": ops.consensus_step_kernel(
                                   M, X, U, P, PP, alpha=ALPHA),
                               "consensus_mix": (
                                   ops.consensus_mix_kernel(M, X),)}
                        want = {"consensus_step": ref.consensus_step_ref(
                                    M, X, U, P, PP, alpha=ALPHA),
                                "consensus_mix": (
                                    ref.consensus_mix_ref(M, X),)}
                        torch.cuda.synchronize()
                        for name in REPLACES:
                            for g, w in zip(got[name], want[name]):
                                check(g.dtype == dtype and g.shape == w.shape,
                                      f"{name} {m}x{d}: dtype/shape")
                                check(torch.allclose(g.float(), w.float(),
                                                     atol=tol, rtol=tol),
                                      f"{name} {m}x{d} {kind} offset "
                                      f"{offset} disagrees with its plain "
                                      f"version beyond {tol}")
                                case_err[name] = max(case_err[name], float(
                                    (g.float() - w.float()).abs().max()))
                for name in REPLACES:
                    err[name][kind] = max(err[name][kind], case_err[name])
                paths = paths["consensus_step"]
                print(f"edge m={m} D={d} {kind} (storage offset 0: "
                      f"{paths[0]} path, 1: {paths[1]} path, both kernels; "
                      f"symmetric and random M): max abs err step "
                      f"{case_err['consensus_step']:.3e} mix "
                      f"{case_err['consensus_mix']:.3e} (tol {tol})",
                      flush=True)
    return err, timings


def batched_bound_ms(kernel: str, b: int, mats: int, m: int, d: int,
                     itemsize: int) -> tuple[float, str]:
    """``bound_ms`` of B experiments in one launch: each experiment's
    streams, ``mats`` matrices and (the step) B alphas read once."""
    if kernel == "consensus_step":
        nbytes = b * 6 * m * d * itemsize + mats * m * m * 4 + b * 4
        flops = b * (4 * m * m * d + 4 * m * d)
    else:
        nbytes = b * 2 * m * d * itemsize + mats * m * m * 4
        flops = b * 2 * m * m * d
    return roofline_ms(nbytes, flops, FP32_FLOP_PER_S)


def check_batched_kernels(torch, ops, ref, main_matrix):
    """The batched consensus kernels against their batched plain
    versions (see the module docstring); times at ``SWEEP_SHAPE``."""
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(1)
    f32, bf16 = torch.float32, torch.bfloat16
    err = {k: {"float32": 0.0, "bfloat16": 0.0} for k in REPLACES}
    for b in BATCH_B:
        for m in BATCH_M:
            case_err = {k: 0.0 for k in REPLACES}
            paths = set()
            for shared in (True, False):
                M = torch.rand(1 if shared else b, m, m, generator=gen,
                               device=dev) + 0.05
                M = (M / M.sum(dim=-1, keepdim=True)).contiguous()
                alpha = torch.linspace(0.05, 0.4, b, device=dev)
                for dtype in (f32, bf16):
                    kind = "float32" if dtype == f32 else "bfloat16"
                    tol = F32_TOL if dtype == f32 else BF16_TOL
                    for offset in (0, 1):
                        streams = []
                        for _ in range(4):
                            buf = torch.randn(b * m * BATCH_D + offset,
                                              generator=gen, device=dev)
                            streams.append(buf.to(dtype)[offset:].view(
                                b, m, BATCH_D))
                        X, U, P, PP = streams
                        paths.add("16-byte" if ops.takes_16_byte_path(
                            X, U, P, PP, torch.empty_like(X)) else "element")
                        before = dict(ops.LAUNCHES)
                        got = {"consensus_step":
                               ops.consensus_step_batched_kernel(
                                   M, X, U, P, PP, alpha),
                               "consensus_mix": (
                                   ops.consensus_mix_batched_kernel(M, X),)}
                        torch.cuda.synchronize()
                        for name in REPLACES:
                            check(ops.LAUNCHES[name] == before[name] + 1,
                                  f"batched {name}: a call did not add "
                                  "one launch to its count")
                        want = {"consensus_step":
                                ref.consensus_step_batched_ref(
                                    M, X, U, P, PP, alpha),
                                "consensus_mix": (
                                    ref.consensus_mix_batched_ref(M, X),)}
                        for name in REPLACES:
                            for g, w in zip(got[name], want[name]):
                                check(g.dtype == dtype and g.shape == w.shape,
                                      f"batched {name}: dtype/shape")
                                check(torch.allclose(g.float(), w.float(),
                                                     atol=tol, rtol=tol),
                                      f"batched {name} B={b} m={m} {kind} "
                                      f"shared={shared} offset {offset} "
                                      "disagrees with its plain version "
                                      f"beyond {tol}")
                                e = float((g.float() - w.float()).abs().max())
                                case_err[name] = max(case_err[name], e)
                                err[name][kind] = max(err[name][kind], e)
            print(f"batched case B={b} m={m} D={BATCH_D} (shared and "
                  f"per-experiment M, distinct alphas, float32 and "
                  f"bfloat16, {' and '.join(sorted(paths))} paths): max abs "
                  f"err step {case_err['consensus_step']:.3e} mix "
                  f"{case_err['consensus_mix']:.3e}", flush=True)
    b, m, d = SWEEP_SHAPE
    M = main_matrix[None].contiguous()
    Mb = main_matrix.expand(b, m, m)
    X, U, P, PP = (torch.randn(b, m, d, generator=gen, device=dev)
                   for _ in range(4))
    alpha = torch.full((b,), ALPHA, device=dev)
    fns = {
        "consensus_step": (
            lambda: ops.consensus_step_batched_kernel(M, X, U, P, PP, alpha),
            lambda: ref.consensus_step_batched_ref(M, X, U, P, PP, alpha),
            lambda: (torch.baddbmm(U, Mb, X, beta=-ALPHA),
                     torch.baddbmm(P - PP, Mb, U))),
        "consensus_mix": (
            lambda: ops.consensus_mix_batched_kernel(M, X),
            lambda: ref.consensus_mix_batched_ref(M, X),
            lambda: torch.bmm(Mb, X))}
    timings = {}
    for name, (fn, plain, lib) in fns.items():
        bound, by = batched_bound_ms(name, b, 1, m, d, X.element_size())
        timings[name] = dict(
            shape=[b, m, d], ms=time_ms(torch, fn, 200, graph=True),
            plain_ms=time_ms(torch, plain, 200, graph=True),
            library_ms=time_ms(torch, lib, 200, graph=True),
            eager_ms=time_ms(torch, fn, 200),
            bound_ms=bound, bound_by=by)
        print(f"batched {name} at {SWEEP_SHAPE} float32, one shared M: "
              + json.dumps(timings[name]), flush=True)
    return err, timings


def ptxas_report(log: str) -> dict:
    """{kernel instantiation: registers and spill bytes} of the kernels
    in ``PTXAS_KERNELS`` from an ``nvcc -Xptxas -v`` log."""
    report, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line and name:
            nums = [int(t) for t in line.replace(",", " ").split()
                    if t.isdigit()]
            report.setdefault(name, {}).update(
                spill_store_bytes=nums[1], spill_load_bytes=nums[2])
        elif "Used" in line and "registers" in line and name:
            words = line.split()
            report.setdefault(name, {})["registers"] = int(
                words[words.index("Used") + 1])
    try:
        names = subprocess.run(["c++filt"], input="\n".join(report),
                               capture_output=True, text=True, timeout=60,
                               check=True).stdout.split("\n")
    except (OSError, subprocess.SubprocessError):
        names = list(report)
    return {short_name(readable): info
            for readable, info in zip(names, report.values())
            if any(k in readable for k in PTXAS_KERNELS)}


def short_name(readable: str) -> str:
    """A demangled instantiation without its argument list, the consensus
    kernels' ``Form`` and ``Staging`` written by name: ``void
    consensus_mix_kernel<float, 4, true, kSquare>``."""
    readable = readable.replace("(anonymous namespace)::", "")
    for i, form in enumerate(("kSquare", "kBatch", "kBlock")):
        readable = readable.replace(f"(Form){i}", form)
    for i, staging in enumerate(("kBothStreams", "kEachStream", "kPasses")):
        readable = readable.replace(f"(Staging){i}", staging)
    depth = 0
    for i, c in enumerate(readable):
        depth += (c == "<") - (c == ">")
        if c == "(" and depth == 0:
            return readable[:i]
    return readable


def visible_pairs(sq: int, skv: int, causal: bool, window, q_offset: int
                  ) -> int:
    """(query, key) pairs the mask leaves visible, per batch row and head."""
    total = 0
    for i in range(sq):
        pos = i + q_offset
        hi = min(skv - 1, pos) if causal else skv - 1
        lo = max(0, pos - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def flash_bound_ms(b, sq, skv, nh, nkv, hd, causal, window, q_offset,
                   itemsize, flops_per_pair=4, peak=None
                   ) -> tuple[float, str]:
    """``flops_per_pair`` hd flops per visible pair and head (4: the two
    products) at ``peak``, by default the bf16 tensor-core peak for bf16
    inputs and the float32 peak of the CUDA cores for float32 ones; q, k,
    v read once and out written once, ``itemsize`` bytes an element."""
    flops = (flops_per_pair * hd * b * nh
             * visible_pairs(sq, skv, causal, window, q_offset))
    if peak is None:
        peak = BF16_FLOP_PER_S if itemsize == 2 else FP32_FLOP_PER_S
    nbytes = itemsize * hd * b * (2 * sq * nh + 2 * skv * nkv)
    return roofline_ms(nbytes, flops, peak)


def split_bound_ms(b, sq, skv, nh, nkv, hd) -> tuple[float, str]:
    """The float32 split pass: q, k, v read once as float32 and written
    once as two float16 terms (8 bytes an element), no flops to speak of;
    the tile exponents are a few kB."""
    return roofline_ms(8 * hd * b * (sq * nh + 2 * skv * nkv), 0,
                       FP32_FLOP_PER_S)


def wkv_bound_ms(b, s, h, n, with_state, itemsize) -> tuple[float, str]:
    """5 N^2 float32 flops per token and head (o_t: N^2 FMAs; the state
    update: N^2 products and N^2 FMAs); r, k, v, w, u and the incoming
    state read once, out and the final state written once."""
    flops = 5 * n * n * b * s * h
    nbytes = (5 * b * s * h * n * itemsize + h * n * 4
              + (2 if with_state else 1) * b * h * n * n * 4)
    return roofline_ms(nbytes, flops, FP32_FLOP_PER_S)


def check_flash_case(torch, ops, ref, q, k, v, kw, what: str
                     ) -> tuple[float, float | None]:
    """One call of the wrapper against the plain version in float32 on the
    same inputs; returns the max abs error and, for bf16, the largest row
    error."""
    tc = q.dtype == torch.bfloat16
    before = dict(ops.LAUNCHES)
    got = ops.flash_attention(q, k, v, **kw)
    want = ref.attention_ref(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    check(ops.LAUNCHES == {
        "flash_attention": before["flash_attention"] + 1,
        "flash_attention_tc": before["flash_attention_tc"] + int(tc),
        "flash_attention_f32_split":
            before["flash_attention_f32_split"] + int(not tc),
        "flash_attention_f32": before["flash_attention_f32"] + int(not tc)},
        f"flash {what}: launches {ops.LAUNCHES} after {before}")
    check(got.dtype == q.dtype and got.shape == want.shape,
          f"flash {what}: dtype/shape")
    e = float((got.float() - want).abs().max())
    if not tc:
        print(f"flash case {what}: max abs err {e:.3e} (tol {FLASH_TOL})",
              flush=True)
        check(torch.allclose(got, want, atol=FLASH_TOL, rtol=FLASH_TOL),
              f"flash {what} disagrees with its plain version beyond "
              f"{FLASH_TOL}")
        return e, None
    row = float(ops.row_errors(got, want).max())
    print(f"flash case {what}: largest row error {row:.3e} (gate "
          f"{ops.TC_ROW_RTOL}), max abs err {e:.3e}", flush=True)
    check(row <= ops.TC_ROW_RTOL,
          f"flash {what}: row error {row:.3e} > {ops.TC_ROW_RTOL} (inf: a "
          "row that sees no key is not 0)")
    return e, row


def check_split(torch, ops, ref, q, k, v, what: str) -> float:
    """The float32 split pass on q, k, v against its plain version: hi, lo
    and the tile exponents bit for bit; returns the largest |got - want|
    over them (0 when bit-equal)."""
    lib = ops.load()
    halves, exps = scratch = ops.f32_scratch(lib, q, k)
    ops.launch_split_f32(lib, q, k, v, scratch)
    torch.cuda.synchronize()
    q_rows, kv_rows = ops.f32_tiles(lib, q.shape[3])
    err = 0.0
    for name, x, rows in (("q", q, q_rows), ("k", k, kv_rows),
                          ("v", v, kv_rows)):
        hi, lo, e = ref.split_f32_ref(x, rows)
        n = hi.numel()
        got = (halves[:n].view(hi.shape), halves[n:2 * n].view(hi.shape),
               exps[:e.numel()].view(e.shape))
        for g, w in zip(got, (hi, lo, e)):
            err = max(err, float((g.double() - w.double()).abs().max()))
        check(all(torch.equal(g, w) for g, w in zip(got, (hi, lo, e))),
              f"flash split pass {what}: {name} differs from its plain "
              f"version (largest difference {err:.3e})")
        halves, exps = halves[2 * n:], exps[e.numel():]
    check(halves.numel() == 0 and exps.numel() == 0,
          f"flash split pass {what}: scratch size")
    print(f"flash split pass {what}: bit-equal to its plain version",
          flush=True)
    return err


def time_flash_f32(torch, ops, ref, q, k, v, kw) -> dict:
    """The float32 path's kernels timed alone at one shape (split pass,
    main kernel on its output) and as one wrapper call, their plain
    versions, and the main kernel's bounds."""
    b, sq, nh, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    lib = ops.load()
    scratch = ops.f32_scratch(lib, q, k)
    out = torch.empty_like(q)
    ops.launch_split_f32(lib, q, k, v, scratch)
    shape = (b, sq, skv, nh, nkv, hd, kw["causal"], kw["window"],
             kw["q_offset"], 4)
    # the function's bound: float32 attention's 4 hd flops a visible pair
    # at the tensor cores' peak, the rate at which the kernel does them;
    # beside it the split arithmetic's own work (12 hd: 3 products of 2 hd
    # each for S and for P . V) at that peak, and the 4 hd at the CUDA
    # cores' float32 rate
    bound, by = flash_bound_ms(*shape, peak=BF16_FLOP_PER_S)
    split_arith, _ = flash_bound_ms(*shape, flops_per_pair=12,
                                    peak=BF16_FLOP_PER_S)
    fma_bound, _ = flash_bound_ms(*shape)
    split_bound, split_by = split_bound_ms(b, sq, skv, nh, nkv, hd)
    q_rows, kv_rows = ops.f32_tiles(lib, hd)
    return dict(
        ms=time_ms(torch, lambda: ops.launch_f32(
            lib, scratch, out, skv=skv, nkv=nkv, **kw), 3, reps=5),
        call_ms=time_ms(torch, lambda: ops.flash_attention(q, k, v, **kw),
                        3, reps=5),
        plain_ms=time_ms(torch, lambda: ref.attention_ref(q, k, v, **kw),
                         1, reps=3),
        bound_ms=bound, bound_by=by, bound_split_arith_ms=split_arith,
        bound_f32_fma_ms=fma_bound,
        split=dict(
            ms=time_ms(torch, lambda: ops.launch_split_f32(
                lib, q, k, v, scratch), 10, reps=5),
            plain_ms=time_ms(torch, lambda: [
                ref.split_f32_ref(x, r)
                for x, r in ((q, q_rows), (k, kv_rows), (v, kv_rows))],
                1, reps=3),
            bound_ms=split_bound, bound_by=split_by))


def check_flash(torch) -> dict:
    """Every flash kernel against its plain version on every case; times,
    bounds and SDPA (no softcap: it has none) at the serving shapes."""
    from repro_torch.kernels.flash_attention import ops, ref
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(1)
    err = {"float32": 0.0, "bfloat16": 0.0, "bfloat16_row": 0.0,
           "split": 0.0}
    timings = {}
    cases = [(c, None) for c in FLASH_CASES] + [
        (c, name) for name, c in FLASH_MAIN.items()]
    for case, main_name in cases:
        b, sq, skv, nh, nkv, hd, causal, window, cap, q_off, dt = case
        dtype = getattr(torch, dt)
        q = torch.randn(b, sq, nh, hd, generator=gen, device=dev).to(dtype)
        k = torch.randn(b, skv, nkv, hd, generator=gen, device=dev).to(dtype)
        v = torch.randn(b, skv, nkv, hd, generator=gen, device=dev).to(dtype)
        kw = dict(causal=causal, window=window, logit_softcap=cap,
                  q_offset=q_off)
        e, row = check_flash_case(torch, ops, ref, q, k, v, kw, str(case))
        err[dt] = max(err[dt], e)
        if row is not None:
            err["bfloat16_row"] = max(err["bfloat16_row"], row)
        if main_name is None:
            continue
        # SDPA in its own (b, h, s, hd) layout, made beforehand
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        # a window no narrower than the keys masks nothing causal does not
        windowed = window is not None and window < skv
        library_call = (
            "scaled_dot_product_attention(enable_gqa=True), "
            + ("the causal window as a boolean attn_mask" if windowed else
               "is_causal=True")
            + (": the same function" if cap is None else
               ", without the softcap, which it cannot apply"))
        if not windowed:
            lib = lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)
        else:
            pos = torch.arange(sq, device=dev)
            mask = ((pos[:, None] >= pos[None, :])
                    & (pos[:, None] - pos[None, :] < window))
            lib = lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)
        try:
            library_ms = time_ms(torch, lib, 3, reps=3)
        except RuntimeError as exc:   # no SDPA kernel for these inputs
            print(f"SDPA {main_name}: {exc}", flush=True)
            library_ms = None
        timings[main_name] = dict(
            shape=[b, sq, skv, nh, nkv, hd], window=window, softcap=cap,
            dtype=dt, library_ms=library_ms, library_call=library_call)
        if dt == "bfloat16":
            bound, by = flash_bound_ms(b, sq, skv, nh, nkv, hd, causal,
                                       window, q_off, q.element_size())
            timings[main_name].update(
                ms=time_ms(torch, lambda: ops.flash_attention(q, k, v, **kw),
                           10, reps=5),
                plain_ms=time_ms(torch,
                                 lambda: ref.attention_ref(q, k, v, **kw),
                                 1, reps=3),
                bound_ms=bound, bound_by=by)
        else:
            err["split"] = max(err["split"], check_split(
                torch, ops, ref, q, k, v, main_name))
            timings[main_name].update(time_flash_f32(torch, ops, ref, q, k,
                                                     v, kw))
        print(f"flash {main_name}: {json.dumps(timings[main_name])}",
              flush=True)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    # strided views: every other query head, keys and values cut from
    # wider rows (the kernels read the strides they are given)
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        q = torch.randn(2, 130, 8, 64, generator=gen, device=dev)[:, :, ::2]
        k, v = (torch.randn(2, 130, 2, 128, generator=gen,
                            device=dev)[..., :64] for _ in range(2))
        q, k, v = (t.to(dtype) for t in (q, k, v))
        kw = dict(causal=True, window=50, logit_softcap=30.0)
        e, row = check_flash_case(torch, ops, ref, q, k, v, kw,
                                  f"strided views {dt}")
        err[dt] = max(err[dt], e)
        if row is not None:
            err["bfloat16_row"] = max(err["bfloat16_row"], row)
        else:
            err["split"] = max(err["split"], check_split(
                torch, ops, ref, q, k, v, "strided views"))
    # float32 views that no 16-byte load could read (pointers 4 bytes in,
    # a head stride of 276 bytes): the split pass takes them as they are
    q = torch.randn(1, 130, 4, 64, generator=gen, device=dev)
    k = torch.randn(1, 130, 2, 69, generator=gen, device=dev)[..., 1:65]
    v = torch.randn(130 * 2 * 64 + 1, generator=gen,
                    device=dev)[1:].view(1, 130, 2, 64)
    check(k.data_ptr() % 16 != 0 and v.data_ptr() % 16 != 0,
          "flash: the misaligned float32 views are aligned")
    e, _ = check_flash_case(torch, ops, ref, q, k, v,
                            dict(causal=True, window=50, logit_softcap=30.0),
                            "misaligned float32 views")
    err["float32"] = max(err["float32"], e)
    # the tensor-core kernel refuses a view it cannot load 16 bytes at a time
    q = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16, device=dev)
    k = torch.zeros(1, 8, 2, 80, dtype=torch.bfloat16, device=dev)[..., 4:68]
    before = dict(ops.LAUNCHES)
    try:
        ops.flash_attention(q, k, k)
        raise SmokeFailure("flash: a misaligned bf16 view was not refused")
    except ValueError as exc:
        print(f"flash case misaligned bf16 view: refused ({exc})", flush=True)
    check(ops.LAUNCHES == before, "flash: a refused call launched")
    return dict(err=err, timings=timings)


def check_blockwise(torch) -> dict:
    """``attention_blockwise`` against ``attention_ref`` at
    ``BLOCKWISE_SHAPES`` in float32: the output, and the gradients with
    respect to q, k and v of one backward of a fixed random cotangent,
    each within ``BLOCKWISE_RTOL`` of the plain tensor's scale; each
    route's peak device memory beyond its inputs, forward alone (no
    autograd) and forward with backward, and their times."""
    from repro_torch.models import layers as L
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(3)
    routes = {"plain": L.attention_ref, "blockwise": L.attention_blockwise}
    out = {}
    for model, (b, sq, skv, nh, nkv, hd, *_) in BLOCKWISE_SHAPES.items():
        q = torch.randn(b, sq, nh, hd, generator=gen, device=dev)
        k, v = (torch.randn(b, skv, nkv, hd, generator=gen, device=dev)
                for _ in range(2))
        cot = torch.randn(b, sq, nh, hd, generator=gen, device=dev)
        pos = torch.arange(sq, device=dev)
        rec = dict(shape=[b, sq, skv, nh, nkv, hd])
        results = {}
        for name, fn in routes.items():
            def forward():
                with torch.no_grad():
                    return fn(q, k, v, pos, pos)

            def with_backward():
                leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
                o = fn(*leaves, pos, pos)
                return (o.detach(), *torch.autograd.grad(
                    torch.sum(o * cot), leaves))

            peaks = {}
            for what, run in (("forward", forward),
                              ("with_backward", with_backward)):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                res = run()
                torch.cuda.synchronize()
                peaks[what] = (torch.cuda.max_memory_allocated() - base) / 1e9
                if what == "with_backward":
                    results[name] = res
                del res
            rec[name] = dict(
                peak_gb=peaks["forward"],
                peak_gb_with_backward=peaks["with_backward"],
                ms=time_ms(torch, forward, 1, reps=3),
                ms_with_backward=time_ms(torch, with_backward, 1, reps=3))
        gaps = {}
        for i, name in enumerate(("out", "dq", "dk", "dv")):
            got, want = results["blockwise"][i], results["plain"][i]
            gaps[name] = float((got - want).abs().max()
                               / want.abs().max())
        rec["gaps"] = gaps
        print(f"blockwise {model}: {json.dumps(rec)}", flush=True)
        check(all(g <= BLOCKWISE_RTOL for g in gaps.values()),
              f"blockwise {model}: gaps {gaps} beyond {BLOCKWISE_RTOL} of "
              "the plain attention's scale")
        out[model] = rec
        del q, k, v, cot, results
        torch.cuda.empty_cache()
    return out


def check_wkv6(torch) -> dict:
    """The WKV6 kernel against its plain version on every case; times
    and bounds at ``WKV_TIMED``'s shapes (no library call computes
    WKV6)."""
    from repro_torch.kernels.rwkv6 import ops, ref
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(2)
    err = {"float32": 0.0, "bfloat16": 0.0}
    timings = {}
    timed = {case: name for name, case in WKV_TIMED.items()}
    cases = ([(c, False) for c in WKV_CASES] + [(c, True) for c in WKV_STRONG]
             + [(c, False) for c in WKV_TIMED.values()])
    for case, strong in cases:
        b, s, h, n, with_state, dt = case
        dtype = getattr(torch, dt)
        randn = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
        rand = lambda *shape: torch.rand(*shape, generator=gen, device=dev)
        r, k, v = (randn(b, s, h, n).to(dtype) for _ in range(3))
        w = torch.sigmoid(randn(b, s, h, n) * 2.0 - 1.0) * 0.6 + 0.35
        if strong:
            pick = torch.randint(0, 4, w.shape, generator=gen, device=dev)
            w = torch.where(pick == 0, 0.0, w)
            w = torch.where(pick == 1, 1e-4 * rand(*w.shape), w)
            w = torch.where(pick == 2, 0.999 + 1e-3 * rand(*w.shape), w)
        w = w.to(dtype)
        u = (0.3 * randn(h, n)).to(dtype)
        state = 0.5 * randn(b, h, n, n) if with_state else None
        got, got_state = ops.wkv6(r, k, v, w, u, state)
        want, want_state = ref.wkv6_ref(r, k, v, w, u, state)
        torch.cuda.synchronize()
        tol = WKV_TOL[dt]
        check(got.dtype == dtype and got.shape == want.shape
              and got_state.shape == want_state.shape,
              f"wkv6 {case}: dtype/shape")
        e = max(float((got.float() - want.float()).abs().max()),
                float((got_state - want_state).abs().max()))
        print(f"wkv6 case {case}{' strong decay' if strong else ''}: max "
              f"abs err {e:.3e} (tol {tol})", flush=True)
        check(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
              and torch.allclose(got_state, want_state, atol=tol, rtol=tol),
              f"wkv6 {case} disagrees with its plain version beyond {tol}")
        err[dt] = max(err[dt], e)
        if case in timed and not strong:
            bound, by = wkv_bound_ms(b, s, h, n, with_state, r.element_size())
            timings[timed[case]] = timing = dict(
                shape=[b, s, h, n], dtype=dt,
                ms=time_ms(torch, lambda: ops.wkv6(r, k, v, w, u, state), 10,
                           reps=5),
                plain_ms=time_ms(torch,
                                 lambda: ref.wkv6_ref(r, k, v, w, u, state),
                                 1, reps=3),
                bound_ms=bound, bound_by=by, library_ms=None)
            print(f"wkv6 {timed[case]}: {json.dumps(timing)}", flush=True)
    return dict(err=err, timings=timings)


def moe_drop_shares(torch, run, routes: list | None = None,
                    counts: list | None = None):
    """``(run(), shares)``: the share of token slots each call of the moe
    ffn's capacity route dropped during ``run()``, in call order (one a
    moe layer in a forward; a recompute in the backward pass calls again),
    from ``capacity_routing`` on the ffn's own input (on a pod: the pod's
    route, this rank's share of the slots).  ``routes``, where given,
    gets each call's route: a digest of its experts, positions and kept
    slots; ``counts`` each call's dropped slots."""
    import hashlib

    from repro_torch.models import moe as Moe
    ffn, shares = Moe.moe_ffn, []

    def recording(params, x, *, num_experts, top_k, capacity_factor=1.25,
                  token_chunk=None, expert_parallel=False, pod=None):
        check(token_chunk is None, "moe_drop_shares: chunked routing")
        with torch.no_grad():
            r = Moe.capacity_routing(params, x.reshape(-1, x.shape[-1]),
                                     num_experts=num_experts, top_k=top_k,
                                     capacity_factor=capacity_factor,
                                     pod=pod)
        shares.append(1.0 - float(r.keep.float().mean()))
        if counts is not None:
            counts.append(int(r.keep.numel() - r.keep.sum()))
        if routes is not None:
            kept = torch.cat([r.experts, r.positions, r.keep.long()])
            routes.append(hashlib.sha256(
                kept.cpu().numpy().tobytes()).hexdigest()[:16])
        return ffn(params, x, num_experts=num_experts, top_k=top_k,
                   capacity_factor=capacity_factor,
                   expert_parallel=expert_parallel, pod=pod)

    Moe.moe_ffn = recording
    try:
        out = run()
    finally:
        Moe.moe_ffn = ffn
    return out, shares


def serve_model(torch, cfg, batch: int, prompt_len: int, steps: int
                ) -> dict:
    """One model's serving flow (see the module docstring, phases 4i, 4j
    and 5) for ``cfg`` in its dtype: float32 gated, bfloat16 profiled.

    Returns the kernel launches of the run, the logit gaps, and the
    prefill and decode times.  A moe ffn's kernel prefill routes by
    capacity and the cached path exactly, so for a moe config ``gap_a_b``
    holds the kernel prefill against the capacity route's plain prefill
    and ``gap_c_d`` the last decode step against the cached prefill of
    the prompt and the fed tokens; the capacity-against-exact gaps and
    each moe layer's dropped share stand beside them, ungated.  A config
    with a frontend's prefix tokens prefills with ``PREFIX_SCALE *
    N(0, 1)`` prefix embeddings (the kernel prefill, timed with them);
    ``gap_a_b`` holds it against the plain prefill with the same prefix
    and ``gap_blockwise`` the blockwise one against that too; the cached
    path takes no prefix, so ``gap_c_d`` holds the last decode step
    against the kernel prefill of the prompt and the fed tokens and
    ``gap_c_e`` against their cached prefill."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.launch.serving import make_prefill_step, make_serve_step
    from repro_torch.models import model as M

    dev = torch.device("cuda", torch.cuda.current_device())
    arch, dtype, moe = cfg.name, cfg.dtype, cfg.num_experts > 0
    frontend = cfg.frontend != "none" and cfg.num_prefix_tokens > 0
    specs = cfg.layer_pattern() * cfg.num_periods()
    n_attn = sum(s.mixer == "attn" for s in specs)
    # flash_attention counts the flash calls of either dtype; every bf16
    # prefill layer launches the bf16 kernel, every float32 one the split
    # pass and the float32 kernel
    f32 = dtype == "float32"
    per_prefill = {
        "flash_attention": n_attn,
        "flash_attention_tc": 0 if f32 else n_attn,
        "flash_attention_f32_split": n_attn if f32 else 0,
        "flash_attention_f32": n_attn if f32 else 0,
        "wkv6": sum(s.mixer == "rwkv" for s in specs)}
    counters = {name: fa_ops.LAUNCHES for name in fa_ops.LAUNCHES}
    counters["wkv6"] = wkv_ops.LAUNCHES

    def launches():
        return {name: c[name] for name, c in counters.items()}

    def gap(x, y):
        return float((x.float() - y.float()).abs().max()
                     / y.float().abs().max())

    def cached_prefill(toks, max_len):
        return M.prefill(cfg, params, None, toks,
                         M.init_cache(cfg, batch, max_len, device=dev))

    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        t0 = time.perf_counter()
        params = M.init_params(cfg, seed=0, with_head=True, device=dev)
        torch.cuda.synchronize()
        print(f"serve {arch} {dtype}: {M.param_count(params):,} parameters "
              f"made in {time.perf_counter() - t0:.1f} s", flush=True)
        gen = torch.Generator(device=dev).manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                               device=dev, generator=gen)
        prefix = None
        if frontend:   # the stub frontend's embeddings
            prefix = PREFIX_SCALE * torch.randn(
                batch, cfg.num_prefix_tokens, cfg.frontend_dim, device=dev,
                generator=gen)
        prefill = make_prefill_step(cfg, attn_impl="cuda", device=dev)
        serve = make_serve_step(cfg, device=dev)

        for c in counters.values():
            for name in c:
                c[name] = 0
        # (a) the kernel prefill, with the prefix where there is one
        logits_a, drop_shares = moe_drop_shares(
            torch, lambda: prefill(params, tokens, prefix))
        torch.cuda.synchronize()
        check(launches() == per_prefill,
              f"{arch}: a prefill launched {launches()}, expected "
              f"{per_prefill}")
        gaps = {}
        if moe or frontend:   # the plain prefill of the same inputs
            gaps["gap_a_b"] = gap(logits_a, make_prefill_step(
                cfg, attn_impl="reference", device=dev)(params, tokens,
                                                        prefix))
        if frontend and dtype == "float32":
            gaps["gap_blockwise"] = gap(make_prefill_step(
                cfg, attn_impl="blockwise", device=dev)(params, tokens,
                                                        prefix),
                make_prefill_step(cfg, attn_impl="reference", device=dev)(
                    params, tokens, prefix))
        # (b) the plain prefill into a fresh cache, with room for the
        # gated decode steps, SERVE_REPS timed runs of them and the
        # profiled step
        cache = M.init_cache(cfg, batch,
                             prompt_len + steps * (1 + SERVE_REPS) + 1,
                             device=dev)
        logits_b, cache = M.prefill(cfg, params, None, tokens, cache)
        torch.cuda.synchronize()
        check(launches() == per_prefill, f"{arch}: the plain prefills "
              "launched a kernel")
        # (c) greedy decode, one token per request a step
        fed = []
        tok = torch.argmax(logits_b, dim=-1, keepdim=True)
        position = prompt_len
        for _ in range(steps):
            fed.append(tok)
            logits_c, cache = serve(params, tok, cache, position)
            tok = torch.argmax(logits_c, dim=-1, keepdim=True)
            position += 1
        # (d) the kernel prefill of the prompt and every fed token
        logits_d = prefill(params, torch.cat([tokens] + fed, dim=1))
        torch.cuda.synchronize()
        counts = launches()
        check(counts == {k: 2 * n for k, n in per_prefill.items()},
              f"{arch}: launches {counts}, expected two prefills' worth")
        finite = all(bool(torch.isfinite(x).all())
                     for x in (logits_a, logits_b, logits_c, logits_d))
        if moe:
            # the exact route's cached prefill of the same tokens
            logits_e = cached_prefill(torch.cat([tokens] + fed, dim=1),
                                      prompt_len + steps)[0]
            finite = finite and bool(torch.isfinite(logits_e).all())
            gaps.update(gap_c_d=gap(logits_c, logits_e),
                        gap_capacity_exact_prefill=gap(logits_a, logits_b),
                        gap_capacity_exact_decode=gap(logits_c, logits_d),
                        drop_shares=drop_shares)
            del logits_e
        elif frontend:
            # the cached prefill of the prompt and the fed tokens
            logits_e = cached_prefill(torch.cat([tokens] + fed, dim=1),
                                      prompt_len + steps)[0]
            finite = finite and bool(torch.isfinite(logits_e).all())
            gaps.update(gap_c_d=gap(logits_c, logits_d),
                        gap_c_e=gap(logits_c, logits_e))
            del logits_e
        else:
            gaps.update(gap_a_b=gap(logits_a, logits_b),
                        gap_c_d=gap(logits_c, logits_d))

        # -- timing, after the counts were read; (a)-(d) were the warm-up
        prefill_runs = wall_ms(torch, lambda: prefill(params, tokens, prefix),
                               SERVE_REPS)
        plain_prefill_runs = wall_ms(
            torch, lambda: cached_prefill(tokens, prompt_len), SERVE_REPS)
        decode_runs = []
        for _ in range(SERVE_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                logits, cache = serve(params, tok, cache, position)
                tok = torch.argmax(logits, dim=-1, keepdim=True)
                position += 1
            torch.cuda.synchronize()
            decode_runs.append(1e3 * (time.perf_counter() - t0) / steps)
        profiles = {}
        if dtype == "bfloat16":   # where a served token's time goes
            profiles["prefill"] = device_profile(
                torch, lambda: prefill(params, tokens, prefix), 1)
            profiles["decode_step"] = device_profile(
                torch, lambda: serve(params, tok, cache, position), 1)
        decode_ms = statistics.median(decode_runs)
        result = dict(
            arch=arch, dtype=dtype, layers=cfg.num_layers,
            experts=cfg.num_experts, batch=batch, prompt_len=prompt_len,
            prefix_len=cfg.num_prefix_tokens if frontend else 0,
            decode_steps=steps, launches=counts, **gaps,
            logits_scale=float(logits_b.float().abs().max()),
            prefill_ms=statistics.median(prefill_runs),
            prefill_ms_runs=prefill_runs,
            plain_prefill_ms=statistics.median(plain_prefill_runs),
            plain_prefill_ms_runs=plain_prefill_runs,
            decode_ms_per_step=decode_ms,
            decode_ms_per_step_runs=decode_runs,
            decode_tokens_per_s=1e3 * batch / decode_ms,
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
            profiles=profiles)
    del params, cache, logits, logits_a, logits_b, logits_c, logits_d, prefix
    torch.cuda.empty_cache()
    print(f"serve: {json.dumps(result)}", flush=True)
    check(finite, f"{arch} {dtype}: non-finite logits")
    if dtype == "float32":
        what = ("the capacity route's plain prefill" if moe
                else "the plain prefill with the prefix" if frontend
                else "plain cached prefill")
        check(result["gap_a_b"] <= SERVE_RTOL,
              f"{arch}: kernel prefill vs {what} gap "
              f"{result['gap_a_b']:.3e} > {SERVE_RTOL}")
        what = "cached prefill" if moe else "kernel prefill"
        check(result["gap_c_d"] <= SERVE_RTOL,
              f"{arch}: last decode step vs {what} gap "
              f"{result['gap_c_d']:.3e} > {SERVE_RTOL}")
        if frontend:
            check(result["gap_blockwise"] <= SERVE_RTOL,
                  f"{arch}: blockwise prefill vs the plain one gap "
                  f"{result['gap_blockwise']:.3e} > {SERVE_RTOL}")
            check(result["gap_c_e"] <= SERVE_RTOL,
                  f"{arch}: last decode step vs cached prefill gap "
                  f"{result['gap_c_e']:.3e} > {SERVE_RTOL}")
    return result


def serve_card_vs_cpu(torch, arch: str) -> dict:
    """Phase 4i (c): tests/test_torch_lm.py's reduced float32 ``arch`` on
    the card and on the CPU from the same parameters: the kernel prefill
    of the prompt, the cached prefill and ``CARD_CPU_RUN``'s decode
    steps; the largest logit gap over them, relative to each one's scale,
    and the card's flash launches (one kernel prefill's)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.serving import make_prefill_step, make_serve_step
    from repro_torch.models import model as M

    dev = torch.device("cuda", torch.cuda.current_device())
    cpu = torch.device("cpu")
    cfg = get_config(arch).reduced(num_prefix_tokens=0, frontend="none",
                                   num_layers=4)
    batch, prompt, steps = CARD_CPU_RUN
    params = {cpu: M.init_params(cfg, seed=0, with_head=True, device=cpu)}
    params[dev] = torch.utils._pytree.tree_map(lambda t: t.to(dev),
                                               params[cpu])
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt + steps),
                           generator=torch.Generator().manual_seed(1))

    def run(device):
        p, toks = params[device], tokens.to(device)
        serve = make_serve_step(cfg, device=device)
        outs = [make_prefill_step(cfg, attn_impl="cuda", device=device)(
            p, toks[:, :prompt])]
        logits, cache = M.prefill(cfg, p, None, toks[:, :prompt],
                                  M.init_cache(cfg, batch, prompt + steps,
                                               device=device))
        outs.append(logits)
        for t in range(prompt, prompt + steps):
            logits, cache = serve(p, toks[:, t:t + 1], cache, t)
            outs.append(logits)
        return [o.float().cpu() for o in outs]

    with torch.inference_mode():
        for name in fa_ops.LAUNCHES:
            fa_ops.LAUNCHES[name] = 0
        card = run(dev)
        launches = dict(fa_ops.LAUNCHES)
        host = run(cpu)
    gaps = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(card, host)]
    n_attn = sum(s.mixer == "attn"
                 for s in cfg.layer_pattern() * cfg.num_periods())
    result = dict(arch=arch, layers=cfg.num_layers, batch=batch,
                  prompt_len=prompt, decode_steps=steps, gaps=gaps,
                  launches=launches)
    print(f"serve card vs cpu: {json.dumps(result)}", flush=True)
    check(all(bool(torch.isfinite(x).all()) for x in card + host),
          f"{arch} reduced: non-finite logits")
    check(max(gaps) <= CARD_CPU_RTOL,
          f"{arch} reduced: card vs CPU logit gap {max(gaps):.3e} > "
          f"{CARD_CPU_RTOL}")
    check(launches["flash_attention_f32"] == n_attn
          and launches["flash_attention_tc"] == 0,
          f"{arch} reduced: flash launches {launches}, expected {n_attn} "
          "float32 ones")
    return result


def moe_mamba_breakdown(torch, runs: dict) -> dict:
    """Where phase 4i's bfloat16 kernel prefills spend their time: one moe
    ffn (capacity route) and its three expert products alone, and one
    mamba layer's scan (``_ssm_apply``) and whole block alone, each at
    its model's prefill shape on random inputs (median CUDA-event times),
    and their shares of the measured ``prefill_ms`` counted over the
    model's layers.  The dispatch is the moe ffn less its expert
    products: routing, the copy into the expert buffers, the gather back
    and the aux."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.models import mamba as Mb
    from repro_torch.models import moe as Moe

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(2)
    bf16 = torch.bfloat16
    out = {}
    with torch.inference_mode():
        for arch, (cut, batch, prompt, _) in MOE_MAMBA_RUNS.items():
            cfg = dataclasses.replace(get_config(arch), dtype="bfloat16",
                                      **cut)
            specs = cfg.layer_pattern() * cfg.num_periods()
            n_moe = sum(s.ffn == "moe" for s in specs)
            n_mamba = sum(s.mixer == "mamba" for s in specs)
            prefill_ms = runs[arch, "bfloat16"]["prefill_ms"]
            x = torch.randn(batch, prompt, cfg.d_model, generator=gen,
                            device=dev).to(bf16)
            rec = dict(prefill_ms=prefill_ms, moe_layers=n_moe,
                       mamba_layers=n_mamba)
            if n_moe:
                p = Moe.init_moe(gen, cfg.d_model, cfg.d_ff,
                                 cfg.num_experts, bf16, dev)
                kw = dict(num_experts=cfg.num_experts,
                          top_k=cfg.experts_per_token,
                          capacity_factor=cfg.capacity_factor)
                capacity = Moe.capacity_routing(
                    p, x.reshape(-1, cfg.d_model), **kw).capacity
                xe = torch.randn(cfg.num_experts, capacity, cfg.d_model,
                                 generator=gen, device=dev).to(bf16)
                moe_ms = time_ms(torch, lambda: Moe.moe_ffn(p, x, **kw), 3,
                                 reps=5)
                experts_ms = time_ms(torch, lambda: torch.bmm(
                    F.silu(torch.bmm(xe, p["w_gate"]))
                    * torch.bmm(xe, p["w_up"]), p["w_down"]), 3, reps=5)
                rec.update(moe_ffn_ms=moe_ms, experts_ms=experts_ms,
                           dispatch_ms=moe_ms - experts_ms,
                           moe_share=n_moe * moe_ms / prefill_ms,
                           dispatch_share=(n_moe * (moe_ms - experts_ms)
                                           / prefill_ms))
                del p, xe
            if n_mamba:
                p = Mb.init_mamba(gen, cfg.d_model, cfg.mamba_d_state,
                                  cfg.mamba_d_conv, cfg.mamba_expand, bf16,
                                  dev)
                u = torch.randn(batch, prompt, cfg.mamba_expand * cfg.d_model,
                                generator=gen, device=dev).to(bf16)
                dt, B, C, A = Mb._ssm_params(p, u)
                scan_ms = time_ms(torch, lambda: Mb._ssm_apply(
                    p, u, dt, B, C, A), 1, reps=3)
                block_ms = time_ms(torch, lambda: Mb.mamba_block(p, x), 1,
                                   reps=3)
                rec.update(scan_ms=scan_ms, mamba_block_ms=block_ms,
                           scan_share=n_mamba * scan_ms / prefill_ms,
                           mamba_share=n_mamba * block_ms / prefill_ms)
                del p, u, dt, B, C
            out[arch] = rec
            del x
    torch.cuda.empty_cache()
    print(f"mamba and moe prefill breakdown: {json.dumps(out)}", flush=True)
    return out


def run_moe_mamba_serving(torch) -> dict:
    """Phase 4i (see the module docstring): mixtral-8x7b and jamba-1.5-large
    served at their published widths in bfloat16, the float32 gate at
    depth 2, and the reduced configs on the card against the CPU."""
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    print("mamba and moe serving: cuts " + json.dumps(
        {arch: dict(bfloat16=cut, float32=MOE_MAMBA_GATE_CUTS[arch])
         for arch, (cut, *_) in MOE_MAMBA_RUNS.items()}), flush=True)
    runs = {}
    for dtype in ("bfloat16", "float32"):
        for arch, (cut, batch, prompt, steps) in MOE_MAMBA_RUNS.items():
            if dtype == "float32":
                cut = MOE_MAMBA_GATE_CUTS[arch]
            cfg = dataclasses.replace(get_config(arch), dtype=dtype, **cut)
            runs[arch, dtype] = serve_model(torch, cfg, batch, prompt, steps)
        if dtype == "bfloat16":
            breakdown = moe_mamba_breakdown(torch, runs)
    card_vs_cpu = {arch: serve_card_vs_cpu(torch, arch)
                   for arch in MOE_MAMBA_RUNS}
    took = time.perf_counter() - t_phase
    print(f"mamba and moe serving phase: {took:.1f} s", flush=True)
    return dict(runs=runs, breakdown=breakdown, card_vs_cpu=card_vs_cpu,
                seconds=took)


def run_frontend_serving(torch) -> dict:
    """Phase 4j (see the module docstring): paligemma-3b and
    musicgen-medium served at their published configs with their stub
    frontends' prefix embeddings, bfloat16 and float32."""
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    runs = {}
    for dtype in ("bfloat16", "float32"):
        for arch, (batch, prompt, steps) in FRONTEND_RUNS.items():
            cfg = dataclasses.replace(get_config(arch), dtype=dtype)
            runs[arch, dtype] = serve_model(torch, cfg, batch, prompt, steps)
    took = time.perf_counter() - t_phase
    print(f"frontend serving phase: {took:.1f} s", flush=True)
    return dict(runs=runs, seconds=took)


def wall_ms(torch, fn, reps: int) -> list[float]:
    """Host-clock ms of each of ``reps`` calls of ``fn``, each ending in a
    synchronise: the time a caller waits for the result."""
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append(1e3 * (time.perf_counter() - t0))
    return runs


def profiled(torch, run, cpu: bool = True, lead: int = PRIMER_LAUNCHES):
    """``(run(), prof)``: ``run()`` under ``torch.profiler`` (CUDA
    activity, and CPU activity with ``cpu``).  The profiler can miss the
    first few kernels launched after it starts, and those that start on
    a card gone idle (in some process states; a diagnostic in PR 19 found
    the lost record at the first replay's start, after a synchronise), and
    the last few before it stops.  So ``lead`` spin kernels of about 60 us
    each (``torch.cuda._sleep``) come first, not synchronised, so that the
    card is still busy when ``run()`` starts, and ``PRIMER_LAUNCHES``
    synchronised ones come last; the readers below leave their events
    out."""
    activities = [torch.profiler.ProfilerActivity.CUDA]
    if cpu:
        activities.append(torch.profiler.ProfilerActivity.CPU)

    def spin(count: int):
        for _ in range(count):
            torch.cuda._sleep(100_000)

    with torch.profiler.profile(activities=activities) as prof:
        spin(lead)
        out = run()
        torch.cuda.synchronize()
        spin(PRIMER_LAUNCHES)
        torch.cuda.synchronize()
    return out, prof


def device_profile(torch, run, units: int) -> dict:
    """Device time, kernel launches and the top kernels per unit of work
    under ``torch.profiler``, where ``run()`` does ``units`` units (kernel
    events only: their durations summed), and the consensus kernels'
    launches in the whole run.  ``wall_us`` is the host clock around
    ``run()``, profiler overhead included."""

    def timed() -> float:
        torch.cuda.synchronize()        # the leading spins
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    torch.cuda.synchronize()
    took, prof = profiled(torch, timed)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and PRIMER_SYMBOL not in e.key]
    check(bool(kernels), "torch.profiler recorded no kernel events")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    device_us = sum(e.self_device_time_total for e in kernels) / units
    return dict(
        units=units, device_us=device_us, wall_us=1e6 * took / units,
        kernels=sum(e.count for e in kernels) / units,
        consensus=consensus_launches([(e.key, e.count) for e in kernels]),
        top=[dict(name=e.key[:80], us=e.self_device_time_total / units,
                  count=e.count / units) for e in top])


def consensus_launches(kernels) -> dict:
    """How many times the card ran each consensus kernel, from
    ``(kernel name, count)`` pairs."""
    return {name: sum(count for key, count in kernels if symbol in key)
            for name, symbol in KERNEL_SYMBOL.items()}


def device_launches(torch, run, lead: int = PRIMER_LAUNCHES):
    """``(run(), counts)``: ``consensus_launches`` during ``run()``, from
    the device events of ``torch.profiler`` (CUDA activity only).  A
    graph replay's kernels are events like any other, so this counts the
    launches no wrapper sees.  The events are read from the profiler's
    raw results (``kineto_results.events()``): building its Python events
    for the 190,000 kernels of 40 captured steps takes over a minute, and
    writing and parsing its Chrome trace (170 MB) took 8-9 s a window on
    an H100 80GB HBM3 at 700 W, reading the raw events 1.6-2.1 s."""
    out, prof = profiled(torch, run, cpu=False, lead=lead)
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [(e.name(), 1) for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda and PRIMER_SYMBOL not in e.name()]
    check(bool(kernels), "torch.profiler recorded no kernel events")
    return out, consensus_launches(kernels)


def replays(stepper, state, num_steps: int):
    """``num_steps`` replays of a ``GraphStepper``'s graphs (all captured
    already) from ``state``: ``run_recorded(scan=True)``'s steps without
    its synchronise and clock before them (see ``profiled``)."""
    stepper.load(state)
    stepper.advance(num_steps)


def counted_launches(torch, ops, run, expected):
    """``(run(), counts, windows)``: the consensus kernels the card ran
    during ``run()`` (``device_launches``), with the wrapper counts set to
    0 just before it and read just after.  The profiler loses a few kernel
    records in some windows and never adds one (one deterministic
    ``solve`` profiled six times on an H100 gave 192,601 to 192,606
    kernel records), so while some count falls short of
    ``expected(wrapper counts)`` and none exceeds it, ``run()`` (which
    must repeat the same work) is profiled again, ``LAUNCH_WINDOWS``
    times in all at most; each kernel's count is its largest over the
    windows, all of which are returned.  A loss can repeat in windows of
    the same work (PR 19: one record short in all three windows of one
    count), so window i leads with ``i * LAUNCH_SHIFT`` more spins."""
    windows = []
    for i in range(LAUNCH_WINDOWS):
        for name in ops.LAUNCHES:
            ops.LAUNCHES[name] = 0
        out, ran = device_launches(torch, run,
                                   PRIMER_LAUNCHES + i * LAUNCH_SHIFT)
        windows.append(ran)
        want = expected(dict(ops.LAUNCHES))
        if ran == want or any(ran[k] > want[k] for k in KERNEL_SYMBOL):
            break
    counts = {k: max(w[k] for w in windows) for k in KERNEL_SYMBOL}
    return out, counts, windows


def run_algorithms(torch, ops) -> dict:
    """Phase 4b (see the module docstring): each algorithm eager and
    captured.  Returns each run's record, keyed (algo, mode), and the
    captured INTERACT solver and data for the profile."""
    from repro_torch.core import convergence_metric_fn
    from repro_torch.hypergrad import measure_problem_counts
    from repro_torch.solvers import (SolverConfig, default_setup,
                                     make_solver, run_recorded)
    problem, x0, y0, data = default_setup(0)
    n = data.inner_x.shape[1] + data.outer_x.shape[1]
    runs, keep = {}, {}
    for algo in ALGORITHMS:
        config = SolverConfig(algo=algo, backend="cuda", alpha=0.3, beta=0.3)
        for mode in ("eager", "captured"):
            scan = mode == "captured"
            solver = make_solver(config)
            state0 = solver.init(problem, None, x0, y0, data)
            metric = host_metric(solver._problem, solver._hg_cfg,
                                 data, state0)
            # the warm-up step, or the warm-up steps and the captures,
            # before the counted run (run_recorded then finds them done)
            for name in ops.LAUNCHES:
                ops.LAUNCHES[name] = 0
            steps = NUM_STEPS if scan else ALGO_EAGER_STEPS
            stepper = solver.stepper_for(state0, data, scan)
            stepper.prepare(steps)
            prepared = dict(ops.LAUNCHES)
            for name in ops.LAUNCHES:
                ops.LAUNCHES[name] = 0
            run = lambda: run_recorded(solver, state0, data, steps,
                                       ALGO_RECORD_EVERY, metric, scan=scan)
            t0 = time.perf_counter()
            if scan:
                (state, trace, took), ran = device_launches(torch, run)
            else:
                state, trace, took = run()
            wall = time.perf_counter() - t0
            launches = dict(ops.LAUNCHES)
            replays = stepper.replays if scan else 0
            rec = dict(
                algo=algo, mode=mode, trace=trace,
                samples_per_step=solver.samples_per_step(n),
                communications_per_step=solver.communications_per_step,
                launches_prepare=prepared, launches_wrapper=launches,
                launches_run=ran if scan else launches, graph_replays=replays,
                graphs=len(stepper.graphs) if scan else 0, wall_s=wall)
            if scan:
                # the same 40 steps again from the same state, unprofiled
                # and unrecorded, for the time a step takes (the draws
                # are the generator's next ones)
                rec["us_per_step_profiled"] = 1e6 * took / NUM_STEPS
                _, _, took = run_recorded(solver, state0, data, NUM_STEPS,
                                          ALGO_RECORD_EVERY, None, scan=True)
            rec["us_per_step"] = 1e6 * took / steps
            stats = measure_problem_counts(problem, solver._hg_cfg, x0, y0,
                                           data)
            calls = solver.hypergrad_calls_per_step(n)
            rec.update(hvp_per_step=stats.hvp_count * calls,
                       grad_per_step=stats.grad_count * calls,
                       hess_per_step=stats.hess_count * calls)
            runs[algo, mode] = rec
            if scan:
                keep[algo] = (solver, state, data)
            print(f"algorithms {algo} {mode}: eq.-11 trace {trace}",
                  flush=True)
            print(f"algorithms {algo} {mode}: " + json.dumps(
                {k: v for k, v in rec.items() if k != "trace"})
                + " (launches_prepare: wrapper counts of the warm-up steps "
                "and captures before the run; launches_wrapper: wrapper "
                "counts in the run; launches_run: the kernels the run "
                "launched, eager: the wrapper counts, captured: the card's "
                "kernel events under torch.profiler, graph replays "
                "included; us_per_step of a captured run: a second, "
                "unprofiled run of the same steps)", flush=True)
            check(len(trace) == steps // ALGO_RECORD_EVERY + 1,
                  f"{algo} {mode}: trace length")
            check(all(math.isfinite(v) for v in trace),
                  f"{algo} {mode}: non-finite eq.-11 trace")
            check(trace[-1] < trace[0], f"{algo} {mode}: M_40 = {trace[-1]} "
                  f"is not below M_0 = {trace[0]}")
            kernel = STEP_KERNEL[algo]
            for name in KERNEL_SYMBOL:
                want = steps if name == kernel else 0
                got = rec["launches_run"][name]
                check(got == want, f"{algo} {mode}: {name} launched {got} "
                      f"times in {steps} steps, not {want}")
            if scan:
                check(replays == NUM_STEPS, f"{algo}: {replays} replays")
                check(all(launches[name] == 0 for name in KERNEL_SYMBOL),
                      f"{algo} captured: a consensus kernel was launched "
                      f"from the host between replays: {launches}")
                check(prepared[kernel] == stepper.eager_steps
                      + len(stepper.graphs),
                      f"{algo} captured: {kernel} not launched once in each "
                      "warm-up step and capture")
            else:
                check(prepared[kernel] == 1,
                      f"{algo} eager: the warm-up step launched "
                      f"{prepared[kernel]} {kernel}")
        eager, captured = runs[algo, "eager"], runs[algo, "captured"]
        # the eager run's records are the captured run's first ones
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(captured["trace"], eager["trace"]))
        runs[algo, "captured"]["trace_gap_to_eager"] = rel
        print(f"algorithms {algo}: captured vs eager trace max relative "
              f"gap {rel:.3e} (tolerance {TRACE_RTOL:.1e}); us_per_step "
              f"eager {eager['us_per_step']:.1f} captured "
              f"{captured['us_per_step']:.1f}", flush=True)
        check(rel <= TRACE_RTOL, f"{algo}: captured and eager traces "
              "disagree")
    # the whole recorded INTERACT experiment as graphs: run_traced
    # replays the eq.-11 metric's graph too; the first call captures, the
    # second (from the same initial state) replays only
    solver = make_solver(SolverConfig(algo="interact", backend="cuda",
                                      alpha=0.3, beta=0.3))
    state0 = solver.init(problem, None, x0, y0, data)
    eq11 = convergence_metric_fn(solver._problem, solver._hg_cfg, data)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, trace = solver.run_traced(state0, data, NUM_STEPS,
                                     ALGO_RECORD_EVERY, eq11)
        trace = trace.tolist()
        walls.append(time.perf_counter() - t0)
    eager = runs["interact", "eager"]["trace"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(trace, eager))
    traced = dict(trace=trace, wall_s_first=walls[0], wall_s_replay=walls[1],
                  eager_recorded_wall_s=runs["interact", "eager"]["wall_s"],
                  trace_gap_to_eager=rel)
    print(f"run_traced interact: {json.dumps(traced)} (wall: host clock "
          f"around the call, {NUM_STEPS} steps and "
          f"{NUM_STEPS // ALGO_RECORD_EVERY + 1} records; the first call "
          "captures the step and the metric)", flush=True)
    check(len(trace) == NUM_STEPS // ALGO_RECORD_EVERY + 1
          and all(math.isfinite(v) for v in trace) and trace[-1] < trace[0],
          "run_traced: trace length, finite and falling")
    check(rel <= TRACE_RTOL, "run_traced and eager traces disagree")

    finals = {a: runs[a, "captured"]["trace"][-1] for a in ALGORITHMS}
    holds = (finals["interact"] < finals["gt-dsgd"]
             and finals["interact"] < finals["d-sgd"]
             and finals["svr-interact"] < finals["gt-dsgd"])
    print(f"figure 2 ordering (benchmarks/bench_convergence.py, not gated): "
          f"final M_40 {json.dumps(finals)}; INTERACT below GT-DSGD and "
          f"D-SGD, SVR-INTERACT below GT-DSGD: {holds}", flush=True)
    return dict(runs=runs, keep=keep, traced=traced,
                figure2=dict(finals=finals, holds=holds))


def wire_config(algo: str, opts: dict, backend: str):
    """A ``SolverConfig`` of one wire row on ``backend``."""
    from repro_torch.consensus import CompressionConfig
    from repro_torch.solvers import SolverConfig
    from repro_torch.topology import TopologyProcessConfig
    kw = dict(algo=algo, backend=backend, alpha=ALPHA, beta=ALPHA,
              communication_interval=opts.get("communication_interval", 1))
    if "compression" in opts:
        kw["compression"] = CompressionConfig(**opts["compression"])
    if "topology_process" in opts:
        kw["topology_process"] = TopologyProcessConfig(
            **opts["topology_process"])
    return SolverConfig(**kw)


def run_wire_row(torch, ops, name: str, problem, x0, y0, data) -> dict:
    """Phase 4c for one row (see the module docstring)."""
    from repro_torch.consensus import cumulative_wire_bytes
    from repro_torch.kernels.consensus_step import ref
    from repro_torch.core import convergence_metric_fn
    from repro_torch.solvers import GraphStepper, make_solver, run_recorded
    from repro_torch.solvers import solve
    from repro_torch.topology import stream_of, stream_wire_bytes
    algo, opts, want = WIRE_ROWS[name]
    setup = dict(problem=problem, x0=x0, y0=y0, data=data)
    # solve, captured, on cuda: counts to 0 just before, read just after.
    # The wrappers count every launch from the host: each graph's warm-up
    # steps and its capture (one pass through the step) and the
    # round-latency mixes, and nothing between replays
    latency = dict(consensus_mix=ROUND_LATENCY_MIXES, consensus_step=0)
    warm = GraphStepper.WARMUP_STEPS
    for kernel in ops.LAUNCHES:
        ops.LAUNCHES[kernel] = 0
    t0 = time.perf_counter()
    res = solve(wire_config(algo, opts, "cuda"), ROW_STEPS, **setup)
    solve_wall = time.perf_counter() - t0
    wrapper = dict(ops.LAUNCHES)
    captures = {}
    for kernel in KERNEL_SYMBOL:
        eager_side = wrapper[kernel] - latency[kernel]
        check(eager_side >= 0 and eager_side % (warm + 1) == 0,
              f"wire {name}: {kernel} wrapper count {wrapper[kernel]} is not "
              f"the warm-up steps and captures plus {latency[kernel]}")
        captures[kernel] = eager_side // (warm + 1)

    # the same run as graphs of the step and the eq.-11 metric, in two
    # calls (8 steps, then 32)
    solver = make_solver(wire_config(algo, opts, "cuda"))
    state0 = solver.init(problem, None, x0, y0, data)
    eq11 = convergence_metric_fn(solver._problem, solver._hg_cfg, data)
    state8, head = solver.run_traced(state0, data, WIRE_EAGER_STEPS,
                                     WIRE_EAGER_STEPS, eq11)
    state_end, tail = solver.run_traced(state8, data,
                                      ROW_STEPS - WIRE_EAGER_STEPS,
                                      ROW_STEPS - WIRE_EAGER_STEPS, eq11)
    trace = head.tolist() + tail.tolist()[1:]
    graphs = sorted(str(key) for key in solver.stepper.graphs)
    # the consensus kernels the card ran in ROW_STEPS replays of those graphs,
    # alone in the profiled window (every graph is captured already)
    _, replayed, windows = counted_launches(
        torch, ops, lambda: replays(solver.stepper, state0, ROW_STEPS),
        lambda wrapper: want)
    check(all(v == 0 for v in ops.LAUNCHES.values()),
          f"wire {name}: a kernel was launched from the host between "
          f"replays: {ops.LAUNCHES}")

    # the short eager run on cuda: metric and state bit for bit
    eager = make_solver(wire_config(algo, opts, "cuda"))
    state_e = eager.init(problem, None, x0, y0, data)
    for kernel in ops.LAUNCHES:
        ops.LAUNCHES[kernel] = 0
    host = host_metric(solver._problem, solver._hg_cfg, data, state0)
    state_e, trace_e, took = run_recorded(
        eager, state_e, data, WIRE_EAGER_STEPS, WIRE_EAGER_STEPS, host,
        scan=False)
    eager_launches = dict(ops.LAUNCHES)
    us_eager = 1e6 * took / WIRE_EAGER_STEPS
    eager_gap = max(
        float((a - b).abs().max()) for a, b in zip(
            torch.utils._pytree.tree_leaves(state_e),
            torch.utils._pytree.tree_leaves(state8))
        if isinstance(a, torch.Tensor))
    solve_gap = max(
        float((a - b).abs().max()) for a, b in zip(
            torch.utils._pytree.tree_leaves(res.state),
            torch.utils._pytree.tree_leaves(state_end))
        if isinstance(a, torch.Tensor))

    # dense, captured through solve, and its last M by the eager metric
    for kernel in ops.LAUNCHES:
        ops.LAUNCHES[kernel] = 0
    res_d = solve(wire_config(algo, opts, "dense"), ROW_STEPS, **setup)
    check(all(v == 0 for v in ops.LAUNCHES.values()),
          f"wire {name}: the dense run launched a kernel: {ops.LAUNCHES}")
    m_end_dense = host(res_d.state)
    rel_dense = abs(trace[-1] - m_end_dense) / abs(m_end_dense)
    tol = WIRE_RTOL if "compression" in opts else ROW_RTOL

    config = wire_config(algo, opts, "cuda")
    comms = solver.communications_per_step
    entries = sum(leaf[0].numel() for leaf in
                  torch.utils._pytree.tree_leaves(res.state.x))
    priced = cumulative_wire_bytes(config.compression, entries, ROW_STEPS,
                                   comms, config.communication_interval)[-1]
    rec = dict(
        row=name, algo=algo, steps=ROW_STEPS, trace_captured=trace,
        trace_eager=trace_e, m_end_dense=m_end_dense,
        us_per_step_captured=res.us_per_step, us_per_step_eager=us_eager,
        eager_steps=WIRE_EAGER_STEPS, graphs=graphs,
        launches_replayed=replayed, launches_replay_windows=windows,
        launches_captures=captures,
        launches_warmup_steps={k: warm * v for k, v in captures.items()},
        launches_round_latency=latency, launches_solve_wrapper=wrapper,
        launches_eager_wrapper=eager_launches,
        measured_wire_bytes=res.measured_wire_bytes,
        measured_wire_bytes_dense=res_d.measured_wire_bytes,
        priced_wire_bytes=priced, bytes_per_round=res.bytes_per_round,
        entries=entries, comms_per_step=comms,
        solve_wall_s=solve_wall,
        eager_state_gap=eager_gap, solve_vs_traced_state_gap=solve_gap,
        cuda_vs_dense_rel=rel_dense, cuda_vs_dense_rtol=tol)
    stream = stream_of(solver._engine)
    if stream is not None:
        rec.update(stream_wire_bytes=stream_wire_bytes(
            stream, config.compression, entries, ROW_STEPS, comms,
            config.communication_interval)[-1],
            mean_spectral_gap=stream.mean_spectral_gap,
            period=stream.num_steps)
        # both kernels on this row's last round matrix, against their
        # plain versions (after the counts were read)
        M = solver._engine.topology.round
        gen = torch.Generator(device=M.device).manual_seed(1)
        X, U, P, PP = (torch.randn(M.shape[0], 760, generator=gen,
                                   device=M.device) for _ in range(4))
        pairs = list(zip(
            ops.consensus_step_kernel(M, X, U, P, PP, alpha=ALPHA),
            ref.consensus_step_ref(M, X, U, P, PP, alpha=ALPHA)))
        pairs.append((ops.consensus_mix_kernel(M, X),
                       ref.consensus_mix_ref(M, X)))
        rec["round_matrix_kernel_err"] = max(
            float((g - w).abs().max()) for g, w in pairs)
        check(rec["round_matrix_kernel_err"] <= F32_TOL,
              f"wire {name}: the kernels disagree on the round matrix")
    print(f"wire {name}: " + json.dumps(rec) + " (launches_replayed: the "
          f"card's kernel events in {ROW_STEPS} replays of the row's graphs; "
          "launches_solve_wrapper: solve's wrapper counts, its graphs' "
          "warm-up steps and captures and the round-latency mixes; "
          f"trace_captured: run_traced's M_0, M_8, M_{ROW_STEPS}; "
          "trace_eager: the eager run's M_0, M_8; us_per_step_captured: "
          "solve's)", flush=True)
    check(len(trace) == 3 and all(math.isfinite(v) for v in trace),
          f"wire {name}: trace {trace}")
    check(trace[-1] < trace[0], f"wire {name}: M_{ROW_STEPS} = {trace[-1]} "
          f"is not below M_0 = {trace[0]}")
    check(trace_e == trace[:2] and eager_gap == 0.0,
          f"wire {name}: captured and eager runs differ: {trace[:2]} against "
          f"{trace_e}, state gap {eager_gap}")
    check(solve_gap == 0.0, f"wire {name}: solve and run_traced differ "
          f"({solve_gap})")
    check(rel_dense <= tol, f"wire {name}: cuda M_{ROW_STEPS} {trace[-1]} "
          f"and dense {m_end_dense} differ by {rel_dense:.3e} (tolerance "
          f"{tol:.1e})")
    check(res.measured_wire_bytes == priced
          and res_d.measured_wire_bytes == priced,
          f"wire {name}: measured {res.measured_wire_bytes} / "
          f"{res_d.measured_wire_bytes} bytes, priced {priced}")
    check(replayed == want, f"wire {name}: the {ROW_STEPS} replayed steps "
          f"launched {replayed}, not {want}")
    return rec


def run_wire(torch, ops) -> dict:
    """Phase 4c: every wire row on the Section-6 instance."""
    from repro_torch.solvers import default_setup
    problem, x0, y0, data = default_setup(0)
    t0 = time.perf_counter()
    rows = {name: run_wire_row(torch, ops, name, problem, x0, y0, data)
            for name in WIRE_ROWS}
    print(f"wire phase: {len(rows)} rows in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return rows


def bits_equal(torch, a, b) -> bool:
    """Two states (or lists of floats) equal bit for bit: every tensor's
    bytes (NaN and inf included), every other leaf by value (NaN equal to
    NaN)."""
    for x, y in zip(torch.utils._pytree.tree_leaves(a),
                    torch.utils._pytree.tree_leaves(b), strict=True):
        if not isinstance(x, torch.Tensor):
            if x != y and not (x != x and y != y):
                return False
        elif x.dtype != y.dtype or x.shape != y.shape or not torch.equal(
                x.reshape(-1).view(torch.uint8),
                y.reshape(-1).view(torch.uint8)):
            return False
    return True


def traces_agree(a: list, b: list, rtol: float) -> bool:
    """Both non-finite, or both finite within ``rtol`` of ``b``, at every
    record."""
    return all((not math.isfinite(x) and not math.isfinite(y))
               or (math.isfinite(x) and math.isfinite(y)
                   and abs(x - y) <= rtol * abs(y)) for x, y in zip(a, b))


def json_value(v):
    """A float as itself when finite, else its name (strict JSON)."""
    return v if not isinstance(v, float) or math.isfinite(v) else str(v)


def byzantine_config(name: str, backend: str, clean: bool = False):
    """A ``SolverConfig`` of one Byzantine row on ``backend`` (without its
    attack, rule and guard with ``clean``)."""
    from repro_torch.solvers import (ByzantineConfig, GuardConfig,
                                     SolverConfig)
    from repro_torch.solvers.config import TopologyConfig
    algo, p, byz, guard, _ = BYZANTINE_ROWS[name]
    kw = dict(algo=algo, backend=backend, alpha=ALPHA, beta=ALPHA,
              topology=TopologyConfig(p_connect=p))
    if not clean:
        kw.update(byzantine=ByzantineConfig(**byz),
                  guard=GuardConfig(**(guard or {})))
    return SolverConfig(**kw)


def run_byzantine_row(torch, ops, name: str, setup: dict, eq11, host,
                      clean: dict) -> dict:
    """Phase 4d for one row (see the module docstring)."""
    from repro_torch.consensus import cumulative_wire_bytes
    from repro_torch.solvers import GraphStepper, make_solver, run_recorded
    from repro_torch.solvers import solve
    algo, _, byz, guard, want = BYZANTINE_ROWS[name]
    data = setup["data"]
    config = byzantine_config(name, "cuda")
    latency = dict(consensus_mix=ROUND_LATENCY_MIXES, consensus_step=0)
    warm = GraphStepper.WARMUP_STEPS
    for kernel in ops.LAUNCHES:
        ops.LAUNCHES[kernel] = 0
    t0 = time.perf_counter()
    res = solve(config, ROW_STEPS, **setup)
    solve_wall = time.perf_counter() - t0
    wrapper = dict(ops.LAUNCHES)
    captures = {}
    for kernel in KERNEL_SYMBOL:
        eager_side = wrapper[kernel] - latency[kernel]
        check(eager_side >= 0 and eager_side % (warm + 1) == 0,
              f"byzantine {name}: {kernel} wrapper count {wrapper[kernel]} "
              f"is not the warm-up steps and captures plus "
              f"{latency[kernel]}")
        captures[kernel] = eager_side // (warm + 1)

    walls = dict(solve=solve_wall)
    # the same run as graphs of the step and the eq.-11 metric, 8 + 18
    t0 = time.perf_counter()
    solver = make_solver(config)
    state0 = solver.init(setup["problem"], None, setup["x0"], setup["y0"],
                         data)
    state8, head = solver.run_traced(state0, data, WIRE_EAGER_STEPS,
                                     WIRE_EAGER_STEPS, eq11)
    state_end, tail = solver.run_traced(state8, data,
                                      ROW_STEPS - WIRE_EAGER_STEPS,
                                      ROW_STEPS - WIRE_EAGER_STEPS, eq11)
    trace = head.tolist() + tail.tolist()[1:]
    graphs = sorted(str(key) for key in solver.stepper.graphs)
    walls["run_traced"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, replayed, windows = counted_launches(
        torch, ops, lambda: replays(solver.stepper, state0, ROW_STEPS),
        lambda wrapper: want)
    walls["profiled_replays"] = time.perf_counter() - t0
    check(all(v == 0 for v in ops.LAUNCHES.values()),
          f"byzantine {name}: a kernel was launched from the host between "
          f"replays: {ops.LAUNCHES}")

    # 8 eager steps on cuda: metric and state (guard counters included)
    # bit for bit the captured ones
    t0 = time.perf_counter()
    eager = make_solver(config)
    state_e = eager.init(setup["problem"], None, setup["x0"], setup["y0"],
                         data)
    for kernel in ops.LAUNCHES:
        ops.LAUNCHES[kernel] = 0
    state_e, trace_e, took = run_recorded(
        eager, state_e, data, WIRE_EAGER_STEPS, WIRE_EAGER_STEPS, host,
        scan=False)
    eager_launches = dict(ops.LAUNCHES)
    eager_equal = bits_equal(torch, state_e, state8) and bits_equal(
        torch, trace_e, trace[:2])
    solve_equal = bits_equal(torch, res.state, state_end)
    walls["eager"] = time.perf_counter() - t0

    # dense, captured through solve: no consensus kernel
    t0 = time.perf_counter()
    for kernel in ops.LAUNCHES:
        ops.LAUNCHES[kernel] = 0
    res_d = solve(byzantine_config(name, "dense"), ROW_STEPS, **setup)
    check(all(v == 0 for v in ops.LAUNCHES.values()),
          f"byzantine {name}: the dense run launched a kernel: "
          f"{ops.LAUNCHES}")
    m_end_dense = host(res_d.state)
    walls["dense"] = time.perf_counter() - t0
    comms = solver.communications_per_step
    entries = sum(leaf[0].numel() for leaf in
                  torch.utils._pytree.tree_leaves(res.state.x))
    priced = cumulative_wire_bytes(config.compression, entries, ROW_STEPS,
                                   comms, config.communication_interval)[-1]
    mask = solver._engine.attack_schedule.mask.tolist()
    honest_finite = [
        bool(torch.isfinite(leaf[i]).all()) for i in range(len(mask))
        if not mask[i] for st in (res.state, res_d.state)
        for leaf in torch.utils._pytree.tree_leaves(st.x)]
    rec = dict(
        row=name, algo=algo, byzantine=byz, guard=guard, steps=ROW_STEPS,
        byzantine_slots=[i for i, bad in enumerate(mask) if bad],
        trace_captured=[json_value(v) for v in trace],
        trace_eager=[json_value(v) for v in trace_e],
        m_end_dense=json_value(m_end_dense),
        m_end_clean=clean["m_end_cuda"],
        m_end_clean_dense=clean["m_end_dense"],
        us_per_step_captured=res.us_per_step,
        us_per_step_eager=1e6 * took / WIRE_EAGER_STEPS,
        eager_steps=WIRE_EAGER_STEPS, graphs=graphs,
        launches_replayed=replayed, launches_replay_windows=windows,
        launches_captures=captures,
        launches_warmup_steps={k: warm * v for k, v in captures.items()},
        launches_round_latency=latency, launches_solve_wrapper=wrapper,
        launches_eager_wrapper=eager_launches,
        measured_wire_bytes=res.measured_wire_bytes,
        measured_wire_bytes_dense=res_d.measured_wire_bytes,
        priced_wire_bytes=priced, entries=entries, comms_per_step=comms,
        wall_s=walls, eager_equal_bitwise=eager_equal,
        solve_equal_traced_bitwise=solve_equal,
        cuda_equal_dense_bitwise=bits_equal(torch, res.state, res_d.state),
        honest_x_finite=all(honest_finite),
        tripped_steps=[res.tripped_steps, res_d.tripped_steps],
        last_good_step=[res.last_good_step, res_d.last_good_step])
    print(f"byzantine {name}: " + json.dumps(rec) + " (launches_replayed: "
          f"the card's kernel events in {ROW_STEPS} replays of the row's "
          f"graphs; trace_captured: run_traced's M_0, M_8, M_{ROW_STEPS}; "
          "trace_eager: the eager run's M_0, M_8; m_end_clean: clean "
          "INTERACT on the complete "
          "graph, captured; tripped_steps, last_good_step: captured solve, "
          "dense solve; wall_s: host clock of each part of the row)",
          flush=True)

    check(len(trace) == 3 and math.isfinite(trace[0]),
          f"byzantine {name}: trace {trace}")
    check(eager_equal, f"byzantine {name}: captured and eager runs differ: "
          f"{trace[:2]} against {trace_e}")
    check(solve_equal, f"byzantine {name}: solve and run_traced differ")
    check(res.measured_wire_bytes == priced
          and res_d.measured_wire_bytes == priced,
          f"byzantine {name}: measured {res.measured_wire_bytes} / "
          f"{res_d.measured_wire_bytes} bytes, priced {priced}")
    check(replayed == want, f"byzantine {name}: the {ROW_STEPS} replayed "
          f"steps launched {replayed}, not {want}")
    m_end = trace[-1]
    if name == "signflip1-weighted":
        for v in (m_end, m_end_dense):
            check(not math.isfinite(v)
                  or v >= WEIGHTED_DIVERGE_FACTOR * clean["m_end_cuda"],
                  f"byzantine {name}: M_{ROW_STEPS} {v} is finite and below "
                  f"{WEIGHTED_DIVERGE_FACTOR}x the clean "
                  f"{clean['m_end_cuda']}")
    elif name == "signflip0-weighted":
        check(bits_equal(torch, res_d.state, clean["dense_state"]),
              f"byzantine {name}: dense is not the clean dense run")
        rel = abs(m_end - clean["m_end_cuda"]) / abs(clean["m_end_cuda"])
        rec["cuda_vs_clean_cuda_rel"] = rel
        check(rel <= ROW_RTOL, f"byzantine {name}: cuda M_{ROW_STEPS} "
              f"{m_end} and clean cuda {clean['m_end_cuda']} differ by "
              f"{rel:.3e}")
    elif name == "signflip1-trimmed1":
        # the same rule with no attacker, the reference's baseline
        zero = solve(dataclasses.replace(config, byzantine=dataclasses.replace(
            config.byzantine, num_byzantine=0)), ROW_STEPS, **setup)
        m_end_zero = host(zero.state)
        rec.update(m_end_zero_attackers=m_end_zero,
                   factor_vs_zero_attackers=m_end / m_end_zero,
                   factor_vs_clean=m_end / clean["m_end_cuda"],
                   reference_gate_factor=TRIMMED_GATE_FACTOR)
        print(f"byzantine {name}: M_{ROW_STEPS} {m_end} against "
              f"{m_end_zero} with no attacker ({m_end / m_end_zero:.2f}x; "
              f"the reference's gate, {TRIMMED_GATE_FACTOR}x, not gated) and "
              f"{clean['m_end_cuda']} clean", flush=True)
        for v in (m_end, m_end_dense):
            check(math.isfinite(v) and v < trace[0],
                  f"byzantine {name}: M_{ROW_STEPS} {v} is not finite and "
                  f"below M_0 {trace[0]}")
    elif name == "signflip1-median-gt-dsgd":
        check(traces_agree([m_end], [m_end_dense], ROW_RTOL),
              f"byzantine {name}: cuda M_{ROW_STEPS} {m_end} and dense "
              f"{m_end_dense} disagree")
        check(all(honest_finite), f"byzantine {name}: an honest agent's x "
              "is not finite")
    elif name == "gaussian2-krum-svr":
        check(len(graphs) == 2, f"byzantine {name}: graphs {graphs}")
        check(traces_agree([m_end], [m_end_dense], ROW_RTOL),
              f"byzantine {name}: cuda M_{ROW_STEPS} {m_end} and dense "
              f"{m_end_dense} disagree")
    elif name == "signflip1-weighted-guard":
        check(res.tripped_steps == res_d.tripped_steps > 0
              and res.last_good_step == res_d.last_good_step,
              f"byzantine {name}: guard counters {rec['tripped_steps']}, "
              f"{rec['last_good_step']} (captured, dense)")
        check(all(bool(torch.isfinite(leaf).all()) for leaf in
                  torch.utils._pytree.tree_leaves(res.state)
                  if isinstance(leaf, torch.Tensor)),
              f"byzantine {name}: the guarded final state is not finite")
    return rec


def run_byzantine(torch, ops) -> dict:
    """Phase 4d: the clean baselines, then every Byzantine row on the
    Section-6 instance."""
    from repro_torch.core import convergence_metric_fn
    from repro_torch.solvers import default_setup, make_solver, solve
    problem, x0, y0, data = default_setup(0)
    setup = dict(problem=problem, x0=x0, y0=y0, data=data)
    t0 = time.perf_counter()
    solver = make_solver(byzantine_config("signflip1-weighted", "cuda"))
    solver.init(problem, None, x0, y0, data)
    eq11 = convergence_metric_fn(solver._problem, solver._hg_cfg, data)
    base = {b: solve(byzantine_config("signflip1-weighted", b, clean=True),
                     ROW_STEPS, **setup) for b in ("cuda", "dense")}
    host = host_metric(solver._problem, solver._hg_cfg, data,
                       base["cuda"].state)
    clean = dict(m_end_cuda=host(base["cuda"].state),
                 m_end_dense=host(base["dense"].state),
                 dense_state=base["dense"].state)
    print(f"byzantine clean: M_{ROW_STEPS} cuda {clean['m_end_cuda']} dense "
          f"{clean['m_end_dense']} (INTERACT on the complete graph, captured "
          f"solve; us_per_step cuda {base['cuda'].us_per_step:.1f})",
          flush=True)
    check(math.isfinite(clean["m_end_cuda"]) and traces_agree(
        [clean["m_end_cuda"]], [clean["m_end_dense"]], ROW_RTOL),
        f"byzantine clean: cuda and dense M_{ROW_STEPS} disagree")
    rows = {name: run_byzantine_row(torch, ops, name, setup, eq11, host,
                                    clean)
            for name in BYZANTINE_ROWS}
    print(f"byzantine phase: {len(rows)} rows and the clean baselines in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return rows


# host_metric's graphs, keyed by (problem, hypergradient config, data);
# each entry holds the problem and the data, so their ids stay theirs
_HOST_METRICS: dict = {}


def host_metric(problem, hg_cfg, data, like):
    """The eq.-11 metric of ``(problem, hg_cfg, data)`` as a host call
    ``state -> float``, for the records of ``run_recorded`` and the M_40
    of a finished run: the port's ``eq11_metric`` (one CUDA graph of the
    metric, replayed with the state's x and y copied in: the eager value
    bit for bit, in tens of milliseconds against 1.2-2.5 s of host time
    for the eager metric's 300 inner steps), at ``convergence_metric_fn``'s
    300 inner steps of 0.5.  The graph is captured here, on ``like``'s x
    and y, so that no timed run pays for the capture."""
    from repro_torch.launch.distributed import eq11_metric
    key = (id(problem), hg_cfg, id(data))
    held = _HOST_METRICS.get(key)
    if held is None:
        eq11 = eq11_metric(problem, hg_cfg, data, 300, 0.5)
        eq11(like.x, like.y)
        held = _HOST_METRICS[key] = (problem, data,
                                     lambda state: eq11(state.x, state.y))
    return held[2]


def rel_gap(a, b) -> float:
    """Largest |a - b| / |b| over two equal-shaped arrays."""
    import numpy as np
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def run_sweep(torch, ops) -> dict:
    """Phase 4e (see the module docstring): the batched sweeps.  Returns
    each group's record and the kernel events of the Figure-2 groups'
    profiled replays."""
    import numpy as np
    from repro_torch.core import (convergence_metric_fn,
                                  masked_convergence_metric_fn)
    from repro_torch.solvers import (SolverConfig, default_setup,
                                     expand_grid, make_solver, sweep)
    from repro_torch.solvers.config import TopologyConfig
    problem, x0, y0, data = default_setup(0)
    setup = dict(problem=problem, x0=x0, y0=y0, data=data)
    t_phase = time.perf_counter()

    # -- the Figure-2 grid: 4 algorithms x SWEEP_SEEDS seeds, 4 groups
    t0 = time.perf_counter()
    grid = expand_grid(SolverConfig(backend="cuda"), algo=ALGORITHMS,
                       seed=range(SWEEP_SEEDS))
    fig2 = sweep(grid, NUM_STEPS, RECORD_EVERY, compare_sequential=True,
                 **setup)
    fig2_wall = time.perf_counter() - t0
    check(fig2.num_dispatches == len(ALGORITHMS),
          f"Figure-2 grid: {fig2.num_dispatches} groups, not "
          f"{len(ALGORITHMS)}")
    traces = fig2.traces
    check(traces.shape == (len(grid), NUM_STEPS // RECORD_EVERY + 1)
          and bool(np.all(np.isfinite(traces)))
          and bool(np.all(traces[:, -1] < traces[:, 0])),
          "Figure-2 grid: traces not finite and falling")
    seq_gap = rel_gap(fig2.traces_sequential, traces)
    check(seq_gap <= TRACE_RTOL, f"Figure-2 grid: batched and sequential "
          f"rows {seq_gap:.3e} apart, beyond {TRACE_RTOL:.1e}")
    ran = {name: 0 for name in KERNEL_SYMBOL}
    groups = []
    for g in fig2.groups:
        algo, size = g.config.algo, len(g.indices)
        kernel = STEP_KERNEL[algo]
        stepper = g.stepper
        group_solver = stepper.solver

        def run():
            group_solver.rewind()
            replays(stepper, group_solver.initial_state(), NUM_STEPS)

        held = dict(ops.LAUNCHES)    # the phase's, which the windows reset
        _, counts, windows = counted_launches(
            torch, ops, run, lambda wrapper: {
                k: NUM_STEPS if k == kernel else 0 for k in KERNEL_SYMBOL})
        check(all(ops.LAUNCHES[k] == 0 for k in KERNEL_SYMBOL),
              f"sweep {algo}: a consensus kernel was launched from the "
              f"host between replays: {ops.LAUNCHES}")
        ops.LAUNCHES.update(held)
        check(counts == {k: NUM_STEPS if k == kernel else 0
                         for k in KERNEL_SYMBOL},
              f"sweep {algo}: the card ran {counts} in {NUM_STEPS} replays "
              f"of the {size}-experiment group (windows {windows}), not "
              f"{kernel} once a step")
        for k in KERNEL_SYMBOL:
            ran[k] += counts[k]
        finals = fig2.group_traces(g)[:, -1]
        rec = dict(
            algo=algo, experiments=size, seconds=g.seconds,
            seconds_sequential=g.seconds_sequential,
            us_per_experiment_step=1e6 * g.seconds / (size * NUM_STEPS),
            us_per_experiment_step_sequential=(
                1e6 * g.seconds_sequential / (size * NUM_STEPS)),
            vmap_speedup=g.seconds_sequential / g.seconds,
            graphs=g.graphs, eager_steps=g.eager_steps,
            launches_replayed=counts, windows=windows,
            m40_mean=float(finals.mean()), m40_std=float(finals.std()),
            seq_gap=rel_gap(fig2.traces_sequential[g.indices],
                            traces[g.indices]))
        groups.append(rec)
        print(f"sweep figure-2 {algo}: " + json.dumps(rec) + " (seconds: "
              f"the warmed group run, {NUM_STEPS} steps and "
              f"{NUM_STEPS // RECORD_EVERY + 1} records of {size} "
              "experiments; sequential: the same experiments one at a time "
              "through the single-experiment step's graphs; "
              "launches_replayed: torch.profiler kernel events in "
              f"{NUM_STEPS} replays of the group)", flush=True)
    print(f"sweep figure-2: {fig2.num_dispatches} groups, vmap_speedup "
          f"{fig2.vmap_speedup:.3f}, batched {fig2.seconds:.3f} s, "
          f"sequential {fig2.seconds_sequential:.3f} s, rows against "
          f"sequential max relative gap {seq_gap:.3e}; the call "
          f"{fig2_wall:.1f} s", flush=True)

    # -- the step-size axis: one group, alpha per experiment
    t0 = time.perf_counter()
    hg = SolverConfig().hypergrad
    eq11 = convergence_metric_fn(problem, hg, data,
                                 inner_steps=CHECK_INNER_STEPS)
    alpha_grid = expand_grid(SolverConfig(backend="cuda"), **ALPHA_GRID)
    alphas = sweep(alpha_grid, NUM_STEPS, RECORD_EVERY, metric_fn=eq11,
                   **setup)
    check(alphas.num_dispatches == 1,
          f"seed x alpha grid: {alphas.num_dispatches} groups, not 1")
    alpha_gap = 0.0
    for i, cfg in enumerate(alpha_grid):
        solver = make_solver(cfg)
        state0 = solver.init(problem, None, x0, y0, data)
        _, solo = solver.run_traced(state0, data, NUM_STEPS, RECORD_EVERY,
                                    eq11)
        alpha_gap = max(alpha_gap, rel_gap(alphas.traces[i], solo.tolist()))
    by_alpha = {a: float(np.mean([alphas.traces[i][-1]
                                  for i, c in enumerate(alpha_grid)
                                  if c.alpha == a]))
                for a in ALPHA_GRID["alpha"]}
    print(f"sweep seed x alpha: 1 group of {len(alpha_grid)}, rows against "
          f"their configs' run_traced max relative gap {alpha_gap:.3e} "
          f"(tolerance {TRACE_RTOL:.1e}); M_40 by alpha "
          f"{json.dumps(by_alpha)}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    check(alpha_gap <= TRACE_RTOL, "seed x alpha grid: a row disagrees "
          "with its config's run_traced")
    check(by_alpha[0.3] != by_alpha[0.1], "seed x alpha grid: alpha did "
          "not reach the step")

    # -- the padded grid: INTERACT on dense over 4 and 8 agents, against
    # one unpadded sweep a network size (each with its data's metric)
    t0 = time.perf_counter()
    sizes = PADDED_GRID["num_agents"]
    datas = {m: default_setup(0, num_agents=m)[3] for m in sizes}
    padded_grid = expand_grid(
        SolverConfig(algo="interact", backend="dense"), num_agents=sizes,
        topology=tuple(TopologyConfig(kind=k)
                       for k in PADDED_GRID["topology"]),
        seed=PADDED_GRID["seed"])
    padded = sweep(padded_grid, NUM_STEPS, RECORD_EVERY, problem=problem,
                   x0=x0, y0=y0, data=datas, pad_agents=True,
                   metric_fn=masked_convergence_metric_fn(
                       problem, hg, inner_steps=CHECK_INNER_STEPS))
    t_padded = time.perf_counter() - t0
    unpadded_traces = np.zeros_like(padded.traces)
    unpadded_groups = 0
    for m in sizes:
        rows = [i for i, c in enumerate(padded_grid) if c.num_agents == m]
        res = sweep([padded_grid[i] for i in rows], NUM_STEPS,
                    RECORD_EVERY, problem=problem, x0=x0, y0=y0,
                    data=datas[m], metric_fn=convergence_metric_fn(
                        problem, hg, datas[m],
                        inner_steps=CHECK_INNER_STEPS))
        unpadded_traces[rows] = res.traces
        unpadded_groups += res.num_dispatches
    t_unpadded = time.perf_counter() - t0 - t_padded
    pad_gap = rel_gap(padded.traces, unpadded_traces)
    bitwise = int(np.sum(np.all(padded.traces == unpadded_traces, axis=1)))
    print(f"sweep padded: {padded.num_dispatches} group (pad_to "
          f"{padded.pad_to}) against {unpadded_groups} unpadded; "
          f"rows max relative gap {pad_gap:.3e} (tolerance "
          f"{TRACE_RTOL:.1e}); rows equal bit for bit: {bitwise} of "
          f"{len(padded_grid)} (reported, not gated); padded "
          f"{t_padded:.1f} s, unpadded {t_unpadded:.1f} s", flush=True)
    check(padded.num_dispatches == 1 and unpadded_groups == 4,
          f"padded grid: {padded.num_dispatches} padded and "
          f"{unpadded_groups} unpadded groups, not 1 and 4")
    check(bool(np.all(np.isfinite(padded.traces))),
          "padded grid: non-finite trace")
    check(pad_gap <= TRACE_RTOL, "padded grid: a padded row disagrees with "
          "its unpadded row")
    took = time.perf_counter() - t_phase
    print(f"sweep phase: {took:.1f} s", flush=True)
    return dict(groups=groups, launches=ran, seq_gap=seq_gap,
                alpha_gap=alpha_gap, pad_gap=pad_gap, bitwise=bitwise,
                vmap_speedup=fig2.vmap_speedup, seconds=took)


def run_resilience(torch, ops) -> dict:
    """Phase 4f (see the module docstring): checkpointed runs, kill and
    resume, chaos campaigns and sweep resume, captured on the card.
    Returns the phase's record, with the consensus kernels' events in the
    profiled kill-and-resume run."""
    import shutil

    import numpy as np
    from repro_torch.checkpoint import latest_step
    from repro_torch.core import convergence_metric_fn
    from repro_torch.resilience import (FaultPlan, SimulatedKill, chaos_run,
                                        make_fault, resume, resume_run,
                                        run_resumable, snapshot)
    from repro_torch.resilience.snapshot import snapshot_meta_path
    from repro_torch.solvers import (SolverConfig, default_setup,
                                     expand_grid, make_solver, sweep)
    t_phase = time.perf_counter()
    root = ROOT / "build" / "resilience"
    shutil.rmtree(root, ignore_errors=True)

    def fresh_dir(name: str) -> Path:
        shutil.rmtree(root / name, ignore_errors=True)
        return root / name

    problem, x0, y0, data = default_setup(0)
    setup = dict(problem=problem, x0=x0, y0=y0, data=data)
    eq11 = convergence_metric_fn(problem, SolverConfig().hypergrad, data,
                                 inner_steps=CHECK_INNER_STEPS)
    steps, rec, every = NUM_STEPS, RESILIENCE_RECORD_EVERY, CHECKPOINT_EVERY
    config = SolverConfig(algo="interact", backend="cuda", alpha=ALPHA,
                          beta=ALPHA)

    def us_per_step(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e6 * (time.perf_counter() - t0) / steps

    # -- chunked against unchunked: run_traced, captured
    t0 = time.perf_counter()
    solver_u = make_solver(config)
    state0 = solver_u.init(problem, None, x0, y0, data)
    state_u, trace_u = solver_u.run_traced(state0, data, steps, rec, eq11)
    trace_u = trace_u.tolist()
    solver_c = make_solver(config)
    state0_c = solver_c.init(problem, None, x0, y0, data)
    state_c, trace_c = solver_c.run_traced(
        state0_c, data, steps, rec, eq11, checkpoint_every=every,
        ckpt_dir=fresh_dir("chunked"))
    chunked_equal = (bits_equal(torch, trace_c.tolist(), trace_u)
                     and bits_equal(torch, state_c, state_u))
    snapshots = sorted(p.name for p in (root / "chunked").glob("*.npz"))
    us_unchunked = us_per_step(lambda: solver_u.run_traced(
        state0, data, steps, rec, eq11)[1].tolist())
    us_chunked = us_per_step(lambda: solver_c.run_traced(
        state0_c, data, steps, rec, eq11, checkpoint_every=every,
        ckpt_dir=fresh_dir("chunked-timed"))[1].tolist())
    # a snapshot: device-to-host copy, npz with CRCs, sidecar, atomically
    snap_dir, snap_ms = fresh_dir("snapshots"), []
    column = np.full((steps,), np.nan, np.float32)
    for i in range(SNAPSHOT_REPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        path = snapshot(solver_u, state_u, steps + i, snap_dir,
                        padded=column, total_steps=steps, record_every=rec)
        snap_ms.append(1e3 * (time.perf_counter() - t1))
    snap_bytes = (path.stat().st_size
                  + snapshot_meta_path(snap_dir, steps + i).stat().st_size)
    walls = dict(chunked=time.perf_counter() - t0)
    print(f"resilience chunked: run_traced with checkpoint_every={every} "
          f"against unchunked, trace and state bit for bit: {chunked_equal}; "
          f"snapshots {snapshots}; captured us/step (records and snapshots "
          f"included) chunked {us_chunked:.1f}, unchunked {us_unchunked:.1f}; "
          f"snapshot ms {[round(v, 3) for v in snap_ms]}, {snap_bytes} bytes",
          flush=True)
    check(chunked_equal, "resilience: the chunked run_traced is not the "
          "unchunked one bit for bit")
    check(snapshots == [f"step_{k:08d}.npz" for k in (7, 14, 21, 28, 35,
                                                        40)],
          f"resilience: snapshots {snapshots}")

    # -- kill at 18 (the boundary at 21 is lost), resume in a fresh solver;
    # the card's consensus kernel events over the whole of it
    t0 = time.perf_counter()
    kill_dir, stats = root / "kill", {}

    def kill_and_resume():
        shutil.rmtree(kill_dir, ignore_errors=True)
        shutil.rmtree(root / "kill-eager", ignore_errors=True)
        plan = FaultPlan([make_fault("kill", step=KILL_AT)], seed=0)
        solver = make_solver(config)
        state = solver.init(problem, None, x0, y0, data)
        try:
            run_resumable(solver, state, data, steps, rec, eq11,
                          checkpoint_every=every, ckpt_dir=kill_dir,
                          hooks=plan)
        except SimulatedKill as exc:
            stats["killed_at"] = exc.step
        else:
            raise SmokeFailure("resilience: the kill never fired")
        stats["resumed_from"] = latest_step(kill_dir)
        shutil.copytree(kill_dir, root / "kill-eager")
        resumed, state, trace = resume_run(config, kill_dir,
                                           checkpoint_every=every,
                                           metric_fn=eq11, **setup)
        steppers = (solver.stepper, resumed.stepper)
        stats.update(replays=sum(st.replays for st in steppers),
                     eager_steps=sum(st.eager_steps for st in steppers),
                     graphs=sum(len(st.graphs) for st in steppers))
        return state, trace.tolist()

    (state_k, trace_k), ran, windows = counted_launches(
        torch, ops, kill_and_resume, lambda wrapper: dict(
            consensus_step=stats["replays"] + stats["eager_steps"],
            consensus_mix=0))
    wrapper_k = dict(ops.LAUNCHES)
    wasted = stats["killed_at"] - stats["resumed_from"]
    killed_equal = (bits_equal(torch, trace_k, trace_u)
                    and bits_equal(torch, state_k, state_u))
    # the same kill resumed eagerly, from a copy of the directory
    t1 = time.perf_counter()
    _, state_e, trace_e = resume_run(config, root / "kill-eager",
                                     checkpoint_every=every, metric_fn=eq11,
                                     scan=False, **setup)
    eager_equal = (bits_equal(torch, trace_e.tolist(), trace_u)
                   and bits_equal(torch, state_e, state_u))
    walls.update(kill=t1 - t0, eager_resume=time.perf_counter() - t1)
    kill = dict(stats, wasted=wasted, launches=ran, windows=windows,
                wrapper=wrapper_k, captured_equal=killed_equal,
                eager_resume_equal=eager_equal)
    print(f"resilience kill: {json.dumps(kill)} (launches: the card's "
          "kernel events from the kill through the resumed run's end: "
          "the replays, lost ones included, and the warm-up steps of its "
          "two captures; wrapper: the warm-up steps and the captures, "
          "nothing between replays)", flush=True)
    check(stats["killed_at"] == 21 and stats["resumed_from"] == 14,
          f"resilience: killed at {stats['killed_at']}, resumed from "
          f"{stats['resumed_from']}, not 21 and 14")
    check(stats["replays"] == steps + wasted,
          f"resilience: {stats['replays']} replays, not {steps} + {wasted}")
    check(ran == dict(consensus_step=stats["replays"] + stats["eager_steps"],
                      consensus_mix=0),
          f"resilience: the card ran {ran} (windows {windows}), not "
          f"consensus_step once in each of {stats['replays']} replays and "
          f"{stats['eager_steps']} warm-up steps")
    check(wrapper_k == dict(consensus_step=stats["eager_steps"]
                            + stats["graphs"], consensus_mix=0),
          f"resilience: wrapper counts {wrapper_k}: a kernel was launched "
          "from the host between replays")
    check(killed_equal, "resilience: the killed and resumed run is not the "
          "uninterrupted one bit for bit")
    check(eager_equal, "resilience: the run killed captured and resumed "
          "eagerly is not the uninterrupted one bit for bit")

    # -- chaos, SVR-INTERACT: every fault kind; the reference run is cut at
    # 35, the last snapshot the campaign leaves, to read its generator
    t0 = time.perf_counter()
    svr = dataclasses.replace(config, algo="svr-interact")
    ref = make_solver(svr)
    state35, head = ref.run_traced(ref.init(problem, None, x0, y0, data),
                                   data, 35, rec, eq11)
    gen35 = ref._sampler.generator.get_state().clone()
    state40, tail = ref.run_traced(state35, data, steps - 35, rec, eq11)
    ref_trace = head.tolist()[:-1] + tail.tolist()[-1:]
    chaos_dir = fresh_dir("chaos-svr")
    plan = FaultPlan([make_fault(k, **kw) for k, kw in CHAOS_FAULTS], seed=1)
    rep = chaos_run(svr, plan, steps, rec, checkpoint_every=every,
                    ckpt_dir=chaos_dir, metric_fn=eq11, backoff=0.001,
                    **setup)
    last = resume(svr, chaos_dir, **setup)
    gen_equal = (last is not None and last.step == 35
                 and torch.equal(last.solver._sampler.generator.get_state(),
                                 gen35)
                 and bits_equal(torch, last.state, state35))
    svr_rec = {k: getattr(rep, k) for k in CHAOS_COUNTERS}
    svr_rec.update(wall_time_s=rep.wall_time_s, events=len(rep.events),
                   trace_equal=bits_equal(torch, rep.trace.tolist(),
                                          ref_trace),
                   state_equal=bits_equal(torch, rep.state, state40),
                   generator_round_trip=gen_equal,
                   kinds=sorted({e["kind"] for e in rep.events}))
    walls["chaos_svr"] = time.perf_counter() - t0
    print(f"resilience chaos svr-interact: {json.dumps(svr_rec)}", flush=True)
    check(svr_rec["trace_equal"] and svr_rec["state_equal"],
          "resilience: the SVR-INTERACT campaign's trace or state is not the "
          "uninterrupted run's bit for bit")
    check(gen_equal, "resilience: the generator did not round-trip at 35")
    check({k: svr_rec[k] for k in CHAOS_COUNTERS} == CHAOS_WANT,
          f"resilience: campaign counters {svr_rec}, not {CHAOS_WANT}")

    # -- chaos, the guarded sign-flip row: guard trips roll back, then the
    # guard's containment is accepted; counters as the uncheckpointed run's
    t0 = time.perf_counter()
    guarded = byzantine_config("signflip1-weighted-guard", "cuda")
    gsolver = make_solver(guarded)
    gstate, _ = gsolver.run_traced(
        gsolver.init(problem, None, x0, y0, data), data, steps)
    rep_g = chaos_run(guarded, FaultPlan(seed=0), steps,
                      checkpoint_every=every,
                      ckpt_dir=fresh_dir("chaos-guard"), backoff=0.001,
                      **setup)
    guard_rec = {k: getattr(rep_g, k) for k in CHAOS_COUNTERS}
    guard_rec.update(
        wall_time_s=rep_g.wall_time_s, tripped_steps=rep_g.tripped_steps,
        last_good_step=rep_g.last_good_step,
        tripped_steps_uncheckpointed=int(gstate.guard["tripped"]),
        last_good_step_uncheckpointed=int(gstate.guard["last_good"]),
        state_equal=bits_equal(torch, rep_g.state, gstate))
    walls["chaos_guard"] = time.perf_counter() - t0
    print(f"resilience chaos signflip1-weighted-guard: "
          f"{json.dumps(guard_rec)}", flush=True)
    check(rep_g.completed and rep_g.guard_rollbacks > 0
          and rep_g.guard_accepted > 0,
          f"resilience: the guarded campaign {guard_rec}")
    check(guard_rec["tripped_steps"] == guard_rec[
        "tripped_steps_uncheckpointed"] > 0 and guard_rec[
        "last_good_step"] == guard_rec["last_good_step_uncheckpointed"],
          f"resilience: guard counters {guard_rec}")
    check(guard_rec["state_equal"], "resilience: the guarded campaign's "
          "state is not the uncheckpointed run's bit for bit")

    # -- sweep resume: a Figure-2 INTERACT group of 2 seeds
    t0 = time.perf_counter()
    grid = expand_grid(SolverConfig(backend="cuda"), seed=range(2))
    sweep_dir = fresh_dir("sweep")
    first = sweep(grid, steps, rec, metric_fn=eq11, resume_dir=sweep_dir,
                  **setup)
    second = sweep(grid, steps, rec, metric_fn=eq11, resume_dir=sweep_dir,
                   **setup)
    loaded = ([g.loaded for g in first.groups],
              [g.loaded for g in second.groups])
    sweep_equal = first.traces.tobytes() == second.traces.tobytes()
    walls["sweep"] = time.perf_counter() - t0
    print(f"resilience sweep: loaded {loaded}, traces bit for bit "
          f"{sweep_equal}; {walls['sweep']:.1f} s", flush=True)
    check(loaded == ([False], [True]) and sweep_equal,
          f"resilience: sweep resume loaded {loaded}, equal {sweep_equal}")
    took = time.perf_counter() - t_phase
    print(f"resilience phase: {took:.1f} s ({json.dumps(walls)})",
          flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return dict(launches=ran, kill=kill, chaos_svr=svr_rec,
                chaos_guard=guard_rec, us_chunked=us_chunked,
                us_unchunked=us_unchunked, snapshot_ms=snap_ms,
                snapshot_bytes=snap_bytes, seconds=took)


def run_distributed(torch) -> dict:
    """Phase 4g (see the module docstring): INTERACT across processes in
    ``DIST_LAYOUTS`` against the single-process ``cuda`` eager run."""
    import hashlib
    import os
    import shutil

    from repro_torch.launch.distributed import eq11_metric
    from repro_torch.sharding.collectives import permute_schedule
    from repro_torch.solvers import (SolverConfig, default_setup,
                                     make_solver, run_recorded)
    from repro_torch.solvers.config import TopologyConfig
    tree = torch.utils._pytree
    t_phase = time.perf_counter()
    root = ROOT / "build" / "distributed"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)

    # the reference: the single-process cuda run, eager, recorded as
    # run_section6 records (its graph of the metric, on contiguous
    # iterates, as the gathered ones are)
    t0 = time.perf_counter()
    problem, x0, y0, data = default_setup(0)
    solver = make_solver(SolverConfig(backend="cuda", alpha=ALPHA,
                                      beta=ALPHA))
    state0 = solver.init(problem, None, x0, y0, data)
    contiguous = lambda t: tree.tree_map(lambda l: l.contiguous(), t)
    eq11 = eq11_metric(problem, solver._hg_cfg, data, DIST_INNER_STEPS, 0.5)
    metric = lambda st: eq11(contiguous(st.x), contiguous(st.y))
    state, ref_trace, took = run_recorded(solver, state0, data, DIST_STEPS,
                                          DIST_RECORD_EVERY, metric,
                                          scan=False)
    digest = hashlib.sha256()
    for leaf in tree.tree_leaves(state.x):
        digest.update(leaf.contiguous().cpu().numpy().tobytes())
    ref = dict(trace=ref_trace, digest=digest.hexdigest(),
               us_per_step=1e6 * took / DIST_STEPS,
               seconds=time.perf_counter() - t0)
    print(f"distributed reference (single process, cuda, eager): "
          f"{json.dumps(ref)}", flush=True)
    rounds = permute_schedule(TopologyConfig().mixing_spec(5)).rounds_per_mix

    layouts = {}
    for backend, procs, wire in DIST_LAYOUTS:
        name = f"{backend}-{procs}x{5 // procs}-{wire}"
        out = root / f"{name}.json"
        cmd = [sys.executable, "-m", "repro_torch.launch.launch_local",
               "--device", "cuda", "--wire", wire, "--processes", str(procs),
               "--agents", "5", "--backend", backend, "--steps",
               str(DIST_STEPS), "--record-every", str(DIST_RECORD_EVERY),
               "--n-per-agent", "600", "--d-in", "16", "--hidden", "20",
               "--classes", "5", "--alpha", str(ALPHA), "--beta", str(ALPHA),
               "--metric-inner-steps", str(DIST_INNER_STEPS),
               "--timeout", str(DIST_TIMEOUT), "--out", str(out)]
        t0 = time.perf_counter()
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=DIST_TIMEOUT + 60,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"distributed {name}: the launcher "
              f"exited {proc.returncode}:\n{proc.stderr[-3000:]}")
        res = json.loads(out.read_text())
        gap = rel_gap(res["trace"], ref_trace)
        launches = res["kernel_launches"]
        rec = dict(
            backend=backend, processes=procs, agents_per_process=res[
                "agents_per_process"], wire=res["wire"], trace=res["trace"],
            trace_rel_gap=gap, bitwise=(res["trace"] == ref_trace
                                        and res["digest"] == ref["digest"]),
            digests_equal=len(set(res["rank_digests"])) == 1,
            measured_wire_bytes=res["measured_wire_bytes"],
            priced_wire_bytes=res["priced_wire_bytes"],
            per_link_priced_bytes=res["per_link_priced_bytes"],
            rounds_per_mix=res["rounds_per_mix"],
            row_launches_per_rank=[
                {k: n[f"{k}_rows"] for k in REPLACES} for n in launches],
            us_per_step=res["us_per_step"],
            round_latency_us=res["round_latency_us"],
            worker_setup_s=res["setup_s"], worker_wall_s=res["wall_s"],
            wall_s=wall)
        layouts[name] = rec
        print(f"distributed {name} (wire={rec['wire']}): "
              f"{json.dumps(rec)}", flush=True)
        check(gap <= TRACE_RTOL, f"distributed {name}: trace {gap:.3e} from "
              f"the single-process cuda run, beyond {TRACE_RTOL:.1e}")
        check(rec["digests_equal"], f"distributed {name}: the ranks' "
              f"digests differ: {res['rank_digests']}")
        price = ("priced_wire_bytes" if backend == "allgather"
                 else "per_link_priced_bytes")
        check(res["measured_wire_bytes"] == res[price],
              f"distributed {name}: measured {res['measured_wire_bytes']} "
              f"bytes, priced {res[price]}")
        steps_rows = {n["consensus_step"] for n in rec[
            "row_launches_per_rank"]}
        want = DIST_STEPS if backend == "allgather" else 0
        check(steps_rows == {want} and all(
            n["consensus_step"] == n["consensus_step_rows"]
            and n["consensus_mix"] == n["consensus_mix_rows"]
            for n in launches),
              f"distributed {name}: row-block consensus_step launches a "
              f"rank {steps_rows}, not {want} (1 a step on allgather, none "
              f"on ppermute); {launches}")
        check(backend == "ppermute" or all(
            n["consensus_mix"] >= 1 for n in rec["row_launches_per_rank"]),
              f"distributed {name}: the row-block consensus_mix never ran "
              f"(the round-latency mixes): {launches}")
        if backend == "ppermute":
            check(res["rounds_per_mix"] == rounds <= 4,
                  f"distributed {name}: {res['rounds_per_mix']} rounds a "
                  f"mix, not the schedule's {rounds}")
        if wire == "nccl":
            check(rec["bitwise"], f"distributed {name}: not bit for bit the "
                  "single-process cuda eager run")
    took = time.perf_counter() - t_phase
    print(f"distributed phase: {took:.1f} s", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return dict(reference=ref, layouts=layouts, rounds_per_mix=rounds,
                seconds=took)


def _rel_leaf_gap(torch, got, want) -> float:
    """Largest gap over the leaves of two like trees, relative to each
    leaf of ``want``'s max-abs scale."""
    tree = torch.utils._pytree
    return max(float((a.float() - b.float()).abs().max())
               / max(float(b.float().abs().max()), 1e-30)
               for a, b in zip(tree.tree_leaves(got), tree.tree_leaves(want),
                               strict=True))


def state_digest(torch, state) -> str:
    """A digest of a train state's tensors: each one's float64 sum and
    2-norm, taken on its device (a host copy of a full-width state would
    take seconds)."""
    import hashlib
    leaves = [l for l in torch.utils._pytree.tree_leaves(state)
              if isinstance(l, torch.Tensor)]
    sums = torch.stack([v for l in leaves for v in (
        torch.sum(l, dtype=torch.float64),
        torch.linalg.vector_norm(l, dtype=torch.float64))])
    return hashlib.sha256(repr(sums.tolist()).encode()).hexdigest()[:16]


def timed_mixes(torch, dev, run):
    """``(run(), seconds)``: ``run()`` with each consensus mix of the
    ``ppermute`` engine (the staged permute rounds) timed on the host
    clock between two synchronises: the seconds of each mix in it."""
    from repro_torch.consensus.ppermute import PermuteEngine
    mix, seconds = PermuteEngine.mix, []

    def timed(self, tree, **kw):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = mix(self, tree, **kw)
        torch.cuda.synchronize(dev)
        seconds.append(time.perf_counter() - t0)
        return out

    PermuteEngine.mix = timed
    try:
        out = run()
    finally:
        PermuteEngine.mix = mix
    return out, seconds


def lm_prefix(cfg, agents: int, rows, t: int, batch: int):
    """A frontend's prefix embeddings for step ``t`` of the agents
    ``rows``: (len(rows), batch, num_prefix_tokens, frontend_dim) float32,
    ``PREFIX_SCALE`` * N(0, 1) from numpy, seeded by the agent and the
    step (the same on the card and the CPU); None without a frontend."""
    import numpy as np
    if not cfg.num_prefix_tokens:
        return None
    return np.stack([PREFIX_SCALE * np.random.default_rng(
        (agents, row, t)).standard_normal(
            (batch, cfg.num_prefix_tokens, cfg.frontend_dim),
            dtype=np.float32) for row in rows])


def rwkv_loop_seconds(torch, cfg, dev) -> dict:
    """The plain WKV6 token loop (``wkv6_ref``, what the gradient path
    runs) timed alone at a training split's shape, (LM_BATCH / 2, LM_SEQ,
    heads, N) in the config's dtype: a forward recording autograd, and a
    forward with its backward, each the median of 3 on the host clock
    between synchronises."""
    from repro_torch.models.rwkv import wkv6_ref
    gen = torch.Generator(device=dev).manual_seed(5)
    n, dt = cfg.rwkv_head_size, getattr(torch, cfg.dtype)
    shape = (LM_BATCH // 2, LM_SEQ, cfg.d_model // n, n)
    r, k, v = (torch.randn(*shape, generator=gen, device=dev).to(dt)
               .requires_grad_(True) for _ in range(3))
    w = (0.35 + 0.6 * torch.rand(*shape, generator=gen, device=dev)).to(dt)
    u = (0.5 * torch.randn(shape[2], n, generator=gen, device=dev)).to(dt)

    def timed(backward: bool) -> float:
        samples = []
        for _ in range(4):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out, _ = wkv6_ref(r, k, v, w, u)
            if backward:
                torch.autograd.grad(out.float().sum(), (r, k, v))
            torch.cuda.synchronize(dev)
            samples.append(time.perf_counter() - t0)
        return statistics.median(samples[1:])
    return dict(shape=list(shape), dtype=cfg.dtype,
                forward_s=timed(False), forward_backward_s=timed(True))


def lm_launches(counts, zero: bool = False) -> dict:
    """The launch counts of the wrappers' ``LAUNCHES`` dicts in ``counts``
    (the flash and WKV6 ops'), each set to 0 first where ``zero``."""
    if zero:
        for launches in counts:
            for name in launches:
                launches[name] = 0
    return {name: n for launches in counts for name, n in launches.items()}


def lm_worker(argv) -> int:
    """One agent of an LM training run (phases 4h, 4k and 4l):
    ``chip_smoke.py --lm-worker --run ARCH`` (a key of ``LM_RUNS``) with
    the worker arguments ``launch_local.launch_workers`` gives (``--out
    DIR/result.json --worker --process-id RANK --coordinator HOST:PORT
    --go FILE``).

    Imports what its steps need (``torch._dynamo`` too, which the first
    ``torch.utils.checkpoint`` call would import) before the go file, so
    that the imports overlap the run before it; then joins the gloo group
    of the run's processes on the card, runs the phase's checks on its
    agent (the module docstring, 4h, 4k and 4l) and writes its record to
    ``DIR/rank<RANK>.json``; the parent gates on them."""
    import argparse
    import os

    # jamba's cut runs its step within about 11 GiB of the card's 79: the
    # allocator maps its blocks into growing segments rather than keeping
    # differently sized ones apart (read when torch first allocates)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    t_import = time.perf_counter()
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import TokenTaskStream
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.launch import distributed as D
    from repro_torch.launch.launch_local import _await_go
    from repro_torch.sharding.collectives import AgentMesh
    from repro_torch.train.bilevel_lm import BilevelHyper
    from repro_torch.train.step import (InteractConfig, init_train_state,
                                        make_eval_step, make_train_step)
    from repro_torch.train.svr_step import (init_svr_train_state,
                                            make_svr_train_step)
    import_s = time.perf_counter() - t_import
    t_import = time.perf_counter()
    import torch._dynamo  # noqa: F401
    dynamo_import_s = time.perf_counter() - t_import
    ap = argparse.ArgumentParser()
    for flag in ("--out", "--coordinator", "--go"):
        ap.add_argument(flag, required=True)
    ap.add_argument("--run", required=True, choices=sorted(LM_RUNS))
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args(argv)
    rank, out_dir = args.process_id, Path(args.out).parent
    arch, run = args.run, LM_RUNS[args.run]
    agents = run["agents"]
    _await_go(args.go, LM_TIMEOUT)
    # the processes share the host's cores (the CPU run, the staging)
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // (agents * run.get("pod", 1))))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counts = (fa_ops.LAUNCHES, wkv_ops.LAUNCHES)
    if "pod" in run:
        return lm_pods_worker(torch, args, counts, dict(
            import_seconds=import_s, dynamo_import_seconds=dynamo_import_s))
    tree = torch.utils._pytree
    t_phase = time.perf_counter()
    D.initialize(D.DistributedConfig(
        coordinator=args.coordinator, num_processes=agents,
        process_id=rank, wire="gloo", device="cuda", timeout_s=LM_TIMEOUT))
    mesh = D.agent_mesh(agents)
    dev = mesh.device
    sync = lambda: torch.cuda.synchronize(dev)
    rec = dict(rank=rank, wire=mesh.wire, device=str(dev),
               import_seconds=import_s, dynamo_import_seconds=dynamo_import_s,
               card_free_gb_at_start=torch.cuda.mem_get_info(dev)[0] / 2**30)

    # -- the reduced float32 config on the card and on the CPU -------------
    t0 = time.perf_counter()
    rcfg = get_config(arch).reduced(**LM_REDUCED)
    ricfg = InteractConfig(alpha=0.05, beta=0.3,
                           hyper=BilevelHyper(**LM_REDUCED_HYPER))
    rtokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, rcfg.vocab_size, (agents, 4, 32)))
    rprefix = lm_prefix(rcfg, agents, range(agents), 0, 4)
    host0 = init_train_state(rcfg, 0, device="cpu")
    finals = {}
    for where in ("cuda", "cpu"):
        on = (mesh if where == "cuda" else
              AgentMesh(agents, mesh.world_size, mesh.rank,
                        torch.device("cpu"), "gloo"))
        state = tree.tree_map(lambda l: l.to(on.device) if isinstance(
            l, torch.Tensor) else l, host0)
        step = make_train_step(rcfg, on, ricfg,
                               with_prefix=rprefix is not None)
        for _ in range(2):
            state, _ = step(state, rtokens, None if rprefix is None
                            else torch.as_tensor(rprefix))
        finals[where] = tree.tree_map(lambda l: l.cpu(), (state.x, state.u))
    rec["card_vs_cpu"] = dict(
        x_gap=_rel_leaf_gap(torch, finals["cuda"][0], finals["cpu"][0]),
        u_gap=_rel_leaf_gap(torch, finals["cuda"][1], finals["cpu"][1]),
        prefix=rprefix is not None, seconds=time.perf_counter() - t0)

    # -- (a) INTERACT at the published widths, cut as stated -------------
    cfg = dataclasses.replace(get_config(arch), **run["cut"])
    specs = cfg.layer_pattern() * (cfg.num_layers
                                   // len(cfg.layer_pattern()))
    rec["attn_layers"] = sum(s.mixer == "attn" for s in specs)
    rec["rwkv_layers"] = sum(s.mixer == "rwkv" for s in specs)
    rec["moe_layers"] = sum(s.ffn == "moe" for s in specs)
    icfg = InteractConfig(alpha=LM_ALPHA, beta=LM_BETA,
                          hyper=BilevelHyper(**LM_HYPER))
    stream = TokenTaskStream(cfg.vocab_size, agents, seed=7)
    batch = lambda t: stream.agent_batch(rank, t, LM_BATCH, LM_SEQ,
                                         device=dev)[None]
    with_prefix = bool(cfg.num_prefix_tokens)
    prefix = lambda t: (torch.as_tensor(lm_prefix(
        cfg, agents, [rank], t, LM_BATCH), device=dev) if with_prefix
        else None)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = init_train_state(cfg, 0, device=dev)
    step = make_train_step(cfg, mesh, icfg, with_prefix=with_prefix)
    sync()
    init_s = time.perf_counter() - t0
    lm_launches(counts, zero=True)
    steps, routes, dropped = [], [], []
    for t in range(run["interact_steps"]):
        t0 = time.perf_counter()
        call = lambda: step(state, batch(t), prefix(t))
        if t == 0:
            # the warm-up step's moe calls: each layer's forward, its
            # recompute in the backward pass, the inner features, the cross
            # term's forward and its recompute
            call = lambda: moe_drop_shares(torch, lambda: step(
                state, batch(0), prefix(0)), routes)
        out, mixes = timed_mixes(torch, dev, call)
        if t == 0:
            out, dropped = out
        state, metrics = out
        del out    # the state's only holder is ``state``: freed below
        row = {k: float(v) for k, v in metrics.items()}
        sync()
        steps.append(dict(row, seconds=time.perf_counter() - t0,
                          mix_seconds=sum(mixes), mixes=len(mixes)))
    rec["interact"] = dict(
        steps=steps, init_seconds=init_s, launches=lm_launches(counts),
        prefix=with_prefix,
        peak_bytes=torch.cuda.max_memory_allocated(dev),
        peak_reserved_bytes=torch.cuda.max_memory_reserved(dev),
        params=sum(l.numel() for l in tree.tree_leaves(state.x)),
        head=state.y[0].numel(), digest=state_digest(torch, state),
        moe_routes=routes, moe_dropped=dropped)

    # -- (c) the eval step, the plain versions and the kernels -----------
    evals = []
    for impl in ("reference", "cuda", "cuda"):
        ev = make_eval_step(cfg, mesh, dataclasses.replace(
            icfg, hyper=BilevelHyper(**LM_HYPER, attn_impl=impl)))
        lm_launches(counts, zero=True)
        t0 = time.perf_counter()
        ce = float(ev(state, batch(run["interact_steps"])))
        sync()
        evals.append(dict(impl=impl, outer_ce=ce,
                          seconds=time.perf_counter() - t0,
                          launches=lm_launches(counts)))
    rec["eval"] = evals
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    if rec["rwkv_layers"]:
        rec["rwkv_loop"] = rwkv_loop_seconds(torch, cfg, dev)

    # -- (b) SVR-INTERACT from the initial state ---------------------------
    if run["svr_steps"]:
        torch.cuda.reset_peak_memory_stats(dev)
        state = init_svr_train_state(cfg, 0, device=dev)
        step = make_svr_train_step(cfg, mesh, icfg, q=run["q"])
        lm_launches(counts, zero=True)
        steps = []
        for t in range(run["svr_steps"]):
            t0 = time.perf_counter()
            (state, metrics), mixes = timed_mixes(
                torch, dev, lambda: step(state, batch(t)))
            row = {k: float(v) for k, v in metrics.items()}
            sync()
            steps.append(dict(row, seconds=time.perf_counter() - t0,
                              mix_seconds=sum(mixes)))
        finite = all(bool(torch.isfinite(l).all())
                     for l in tree.tree_leaves((state.x, state.y, state.u)))
        rec["svr"] = dict(steps=steps, state_finite=finite,
                          launches=lm_launches(counts),
                          peak_bytes=torch.cuda.max_memory_allocated(dev),
                          peak_reserved_bytes=torch.cuda.max_memory_reserved(
                              dev),
                          digest=state_digest(torch, state))
    rec["seconds"] = time.perf_counter() - t_phase
    (out_dir / f"rank{rank}.json").write_text(json.dumps(rec))
    D.shutdown()
    return 0


def timed_pod_collectives(torch, dev, pod, run):
    """``(run(), calls)``: ``run()`` with each collective of the pod's
    ``AgentMesh`` (its gathers, reduce-scatters and all-reduces: the pods
    layout's) timed on the host clock between two synchronises: a
    (method name, seconds) pair for each call in it."""
    from repro_torch.sharding.collectives import AgentMesh
    names = ("all_gather", "all_reduce", "reduce_scatter_mean")
    plain = {name: getattr(AgentMesh, name) for name in names}
    seconds = []    # (name, seconds) a call

    def timed(name):
        def call(self, *a, **kw):
            if self is not pod:
                return plain[name](self, *a, **kw)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = plain[name](self, *a, **kw)
            torch.cuda.synchronize(dev)
            seconds.append((name, time.perf_counter() - t0))
            return out
        return call

    for name in names:
        setattr(AgentMesh, name, timed(name))
    try:
        out = run()
    finally:
        for name in names:
            setattr(AgentMesh, name, plain[name])
    return out, seconds


def pods_state_bytes_want(cfg, pod_size: int) -> dict:
    """A process's state bytes in the pods layout by the partition rule
    (x, u, p_prev in x's dtype, y and v in y's) beside the rows layout's,
    and the backbone and head values a process holds."""
    from torch.utils import _pytree as tree

    from repro_torch.sharding import partition as P
    x, y = P.x_shapes(cfg)
    leaves = tree.tree_leaves(x)
    dims = P.x_shard_dims(x, pod_size)
    per_x = sum(l.numel() // (pod_size if d is not None else 1)
                for l, d in zip(leaves, dims))
    per_y = y.numel() // (pod_size if P.head_shard_dim(y, pod_size)
                          is not None else 1)
    item = leaves[0].element_size()
    whole_x = sum(l.numel() for l in leaves)
    return dict(backbone_values=per_x, head_values=per_y,
                bytes=item * (3 * per_x + 2 * per_y),
                rows_bytes=item * (3 * whole_x + 2 * y.numel()))


def lm_pods_worker(torch, args, counts, rec: dict) -> int:
    """One process of phase 4m (the module docstring): rank ``RANK`` of
    the run's (agents, pod, 1) process mesh, on the card over gloo staged.
    (a) the float32 gate, the pods layout against the rows layout on this
    rank's ring; (b) INTERACT at full size, timed, with its collectives;
    (c) the eval step on the state gathered to each pod's data-0 rank;
    then SVR-INTERACT.  ``counts``: the kernels' launch counts
    (``lm_launches``).  Writes ``DIR/rank<RANK>.json``."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import TokenTaskStream
    from repro_torch.launch import distributed as D
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding import partition as P
    from repro_torch.train.bilevel_lm import BilevelHyper
    from repro_torch.train.step import (InteractConfig, PodLayout,
                                        init_train_state, make_eval_step,
                                        make_train_step)
    from repro_torch.train.svr_step import (init_svr_train_state,
                                            make_svr_train_step)
    rank, out_dir = args.process_id, Path(args.out).parent
    run = LM_RUNS[args.run]
    agents, k = run["agents"], run["pod"]
    tree = torch.utils._pytree
    t_phase = time.perf_counter()
    D.initialize(D.DistributedConfig(
        coordinator=args.coordinator, num_processes=agents * k,
        process_id=rank, wire="gloo", device="cuda", timeout_s=LM_TIMEOUT))
    pm = D.pods_mesh(make_production_mesh(shape=(agents, k, 1)))
    dev = pm.device
    sync = lambda: torch.cuda.synchronize(dev)
    rec.update(rank=rank, agent=pm.agent, data=pm.data_index, wire=pm.wire,
               device=str(dev),
               card_free_gb_at_start=torch.cuda.mem_get_info(dev)[0] / 2**30)

    # -- (a) the float32 gate: pods against rows on the same state ---------
    t0 = time.perf_counter()
    gcfg = dataclasses.replace(get_config(run["gate"]).reduced(**LM_REDUCED),
                               **run["gate_cut"])
    gicfg = InteractConfig(alpha=0.05, beta=0.3,
                           hyper=BilevelHyper(**LM_REDUCED_HYPER))
    gtokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, gcfg.vocab_size, (agents, 4, 32)))
    finals, dropped = {}, {}
    for layout in ("rows", "pods"):
        pods = layout == "pods"
        state = init_train_state(gcfg, 0, device=dev,
                                 mesh=pm if pods else None)
        step = (make_train_step(gcfg, pm, gicfg, agent_mode="pods") if pods
                else make_train_step(gcfg, pm.ring, gicfg))
        drops = []
        for _ in range(2):
            (state, _), _ = moe_drop_shares(
                torch, lambda: step(state, gtokens), counts=drops)
        finals[layout] = state
        dropped[layout] = drops
    # the pod's dropped slots, a call at a time, against the rows agent's
    pod_drops = pm.pod.all_reduce(torch.tensor(dropped["pods"],
                                               device=dev)).tolist()
    rows = P.train_state_shards(finals["rows"], k, pm.data_index)
    gaps = {}
    for field in ("x", "y", "u", "v", "p_prev"):
        gaps[field] = max(
            float((a.float() - b.float()).abs().max())
            / max(float(w.float().abs().max()), 1e-30)
            for a, b, w in zip(tree.tree_leaves(getattr(finals["pods"],
                                                        field)),
                               tree.tree_leaves(getattr(rows, field)),
                               tree.tree_leaves(getattr(finals["rows"],
                                                        field)),
                               strict=True))
    rec["gate"] = dict(arch=gcfg.name, cut=run["gate_cut"], gaps=gaps,
                       rows_dropped=dropped["rows"], pods_dropped=pod_drops,
                       seconds=time.perf_counter() - t0)
    del finals, rows, state, step
    gc.collect()
    torch.cuda.empty_cache()

    # -- (b) INTERACT at full size ----------------------------------------
    cfg = dataclasses.replace(get_config(run["arch"]), **run["cut"])
    specs = cfg.layer_pattern() * (cfg.num_layers
                                   // len(cfg.layer_pattern()))
    rec["attn_layers"] = sum(s.mixer == "attn" for s in specs)
    rec["rwkv_layers"] = sum(s.mixer == "rwkv" for s in specs)
    icfg = InteractConfig(alpha=LM_ALPHA, beta=LM_BETA,
                          hyper=BilevelHyper(**LM_HYPER))
    stream = TokenTaskStream(cfg.vocab_size, agents, seed=7)
    batch = lambda t: stream.agent_batch(pm.agent, t, LM_BATCH, LM_SEQ,
                                         device=dev)[None]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = init_train_state(cfg, 0, mesh=pm)
    step = make_train_step(cfg, pm, icfg, agent_mode="pods")
    sync()
    init_s = time.perf_counter() - t0
    fields = ("x", "y", "u", "v", "p_prev")
    state_bytes = P.state_bytes([getattr(state, f) for f in fields])
    dtypes = sorted({str(l.dtype) for f in fields
                     for l in tree.tree_leaves(getattr(state, f))})

    def timed_step(call):
        t0 = time.perf_counter()
        (out, pod_s), mixes = timed_mixes(
            torch, dev, lambda: timed_pod_collectives(torch, dev, pm.pod,
                                                      call))
        sync()
        by_kind = {}
        for name, sec in pod_s:
            by_kind[name] = by_kind.get(name, 0.0) + sec
        return out, dict(seconds=time.perf_counter() - t0,
                         mix_seconds=sum(mixes), mixes=len(mixes),
                         pod_seconds=sum(by_kind.values()),
                         pod_collectives=len(pod_s), pod_by_kind=by_kind)

    lm_launches(counts, zero=True)
    steps = []
    for t in range(run["interact_steps"]):
        (state, metrics), row = timed_step(lambda: step(state, batch(t)))
        steps.append(dict({k: float(v) for k, v in metrics.items()}, **row))
    rec["interact"] = dict(
        steps=steps, init_seconds=init_s, launches=lm_launches(counts),
        peak_bytes=torch.cuda.max_memory_allocated(dev),
        peak_reserved_bytes=torch.cuda.max_memory_reserved(dev),
        state_bytes=state_bytes, dtypes=dtypes,
        digest=state_digest(torch, state))

    # -- (c) eval on the state gathered to each pod's data-0 rank ----------
    x, y = PodLayout(cfg, pm).gather(state.x, state.y)
    evals = []
    if pm.data_index == 0:
        whole = state._replace(x=x, y=y)
        for impl in ("reference", "cuda", "cuda"):
            ev = make_eval_step(cfg, pm.ring, dataclasses.replace(
                icfg, hyper=BilevelHyper(**LM_HYPER, attn_impl=impl)))
            lm_launches(counts, zero=True)
            t0 = time.perf_counter()
            ce = float(ev(whole, batch(run["interact_steps"])))
            sync()
            evals.append(dict(impl=impl, outer_ce=ce,
                              seconds=time.perf_counter() - t0,
                              launches=lm_launches(counts)))
        del whole
    rec["eval"] = evals
    del x, y, state, step
    pm.pod.all_reduce(torch.zeros(1, device=dev))  # the pod starts together
    gc.collect()
    torch.cuda.empty_cache()

    # -- SVR-INTERACT from the initial state -------------------------------
    if run["svr_steps"]:
        torch.cuda.reset_peak_memory_stats(dev)
        state = init_svr_train_state(cfg, 0, mesh=pm)
        step = make_svr_train_step(cfg, pm, icfg, q=run["q"],
                                   agent_mode="pods")
        lm_launches(counts, zero=True)
        steps = []
        for t in range(run["svr_steps"]):
            (state, metrics), row = timed_step(lambda: step(state, batch(t)))
            steps.append(dict({k: float(v) for k, v in metrics.items()},
                              **row))
        rec["svr"] = dict(
            steps=steps, launches=lm_launches(counts),
            state_finite=all(bool(torch.isfinite(l).all())
                             for l in tree.tree_leaves((state.x, state.y,
                                                        state.u))),
            peak_bytes=torch.cuda.max_memory_allocated(dev),
            peak_reserved_bytes=torch.cuda.max_memory_reserved(dev),
            digest=state_digest(torch, state))
    rec["seconds"] = time.perf_counter() - t_phase
    (out_dir / f"rank{rank}.json").write_text(json.dumps(rec))
    D.shutdown()
    return 0


def lm_per_step(ranks: list, name: str, key: str, refresh=None) -> float:
    """The slowest rank's median of ``key`` over run ``name``'s steps: the
    timed ones (the warm-up, the first, left out where there are more),
    or, where ``refresh`` is given (SVR-INTERACT), every step of that
    kind, 1.0 a refresh step and 0.0 a recursive one (the INTERACT steps
    before have warmed the run up)."""
    def timed(steps: list) -> list:
        if refresh is not None:
            return [s for s in steps if s["refresh"] == refresh]
        return steps[1:] or steps
    return max(statistics.median([s[key] for s in timed(rec[name]["steps"])])
               for rec in ranks)


def lm_gate_ranks(what: str, run: dict, ranks: list, evaluated: list
                  ) -> None:
    """The gates that the rows runs (``lm_run_summary``) and the pods run
    (``lm_pods_summary``) share, on their ranks' records: each step's
    metrics (its counts too, not its seconds) equal on every rank and
    finite, no kernel launched in a train step, the SVR-INTERACT state
    finite and its refresh flags every q-th step; on each rank of
    ``evaluated``, each cuda eval call launching the bf16 flash kernel
    once an attention layer, WKV6 once an rwkv layer and nothing else,
    its outer CE within ``LM_EVAL_RTOL`` of the plain call's, and the CE
    equal on those ranks."""
    names = ("interact", "svr") if run["svr_steps"] else ("interact",)
    for name in names:
        rows = [[{k: v for k, v in s.items()
                  if "seconds" not in k and not isinstance(v, dict)}
                 for s in rec[name]["steps"]] for rec in ranks]
        check(all(r == rows[0] for r in rows), f"{what} {name}: the "
              f"ranks' metrics differ: {rows}")
        check(all(math.isfinite(v) for s in rows[0] for v in s.values()),
              f"{what} {name}: non-finite metrics {rows[0]}")
        check(all(sum(rec[name]["launches"].values()) == 0 for rec in ranks),
              f"{what} {name}: the gradient path launched a kernel: "
              f"{[rec[name]['launches'] for rec in ranks]}")
    if run["svr_steps"]:
        check(all(rec["svr"]["state_finite"] for rec in ranks),
              f"{what} svr: non-finite state")
        want = [float((t + 1) % run["q"] == 0)
                for t in range(run["svr_steps"])]
        check([s["refresh"] for s in ranks[0]["svr"]["steps"]] == want,
              f"{what} svr: refresh flags {ranks[0]['svr']['steps']}")
    for rec in evaluated:
        ref, *kernel = rec["eval"]
        check(sum(ref["launches"].values()) == 0, f"{what} eval reference "
              f"launched {ref['launches']}")
        n = rec["attn_layers"]
        want = dict(flash_attention=n, flash_attention_tc=n,
                    flash_attention_f32_split=0, flash_attention_f32=0,
                    wkv6=rec["rwkv_layers"])
        for call in kernel:
            check(call["launches"] == want, f"{what} eval rank "
                  f"{rec['rank']}: the cuda call launched "
                  f"{call['launches']}, not {want}")
            rel = abs(call["outer_ce"] - ref["outer_ce"]) / abs(
                ref["outer_ce"])
            check(rel <= LM_EVAL_RTOL, f"{what} eval rank {rec['rank']}: "
                  f"outer CE {call['outer_ce']} with the flash kernel, "
                  f"{ref['outer_ce']} plain ({rel:.3e} > {LM_EVAL_RTOL})")
    check(len({json.dumps([e["outer_ce"] for e in rec["eval"]])
               for rec in evaluated}) == 1,
          f"{what} eval: the evaluating ranks' CE differ")


def lm_summary(run: dict, ranks: list, evaluated: list, card: str) -> dict:
    """The summary keys that the rows and the pods runs share: s/step,
    the ring mixes' seconds and tokens/s an agent (``lm_per_step``), the
    digests, the eval calls of ``evaluated``'s first rank and the launches
    of all of them, and each rank's import, init and worker seconds, free
    card memory at its start and peaks."""
    s_per_step = lm_per_step(ranks, "interact", "seconds")
    ev = evaluated[0]["eval"]
    digests = dict(interact=[rec["interact"]["digest"] for rec in ranks])
    if run["svr_steps"]:
        digests["svr"] = [rec["svr"]["digest"] for rec in ranks]
    eval_launches = {name: sum(e["launches"][name] for rec in evaluated
                               for e in rec["eval"])
                     for name in ev[0]["launches"]}
    return dict(
        wire=ranks[0]["wire"], card=card,
        tokens_per_agent_step=LM_BATCH * LM_SEQ,
        interact_s_per_step=s_per_step,
        interact_mix_s_per_step=lm_per_step(ranks, "interact",
                                            "mix_seconds"),
        tokens_per_s_per_agent=LM_BATCH * LM_SEQ / s_per_step,
        digests=digests,
        eval={e["impl"] + str(i): dict(outer_ce=e["outer_ce"],
                                       seconds=e["seconds"],
                                       launches=e["launches"])
              for i, e in enumerate(ev)},
        eval_rel_gap=max(abs(e["outer_ce"] - ev[0]["outer_ce"])
                         / abs(ev[0]["outer_ce"]) for e in ev[1:]),
        eval_launches={k: n for k, n in eval_launches.items() if n},
        import_seconds=[rec["import_seconds"] for rec in ranks],
        dynamo_import_seconds=[rec["dynamo_import_seconds"]
                               for rec in ranks],
        init_seconds=[rec["interact"]["init_seconds"] for rec in ranks],
        card_free_gb_at_start=[rec["card_free_gb_at_start"]
                               for rec in ranks],
        peak_gb=[dict(interact=rec["interact"]["peak_bytes"] / 2**30,
                      interact_reserved=(rec["interact"]["peak_reserved_bytes"]
                                         / 2**30),
                      **({"svr": rec["svr"]["peak_bytes"] / 2**30,
                          "svr_reserved": (rec["svr"]["peak_reserved_bytes"]
                                           / 2**30)}
                         if run["svr_steps"] else {}))
                 for rec in ranks],
        worker_seconds=[rec["seconds"] for rec in ranks])


def lm_pods_summary(name: str, root: Path, card: str,
                    rows: dict | None = None) -> dict:
    """Gates phase 4m on its ranks' records (``lm_pods_worker``'s) and
    returns its summary; ``rows``: the rows layout's summary of the same
    arch in this call (4h's), whose peaks it prints beside its own."""
    from repro_torch.configs import get_config
    run = LM_RUNS[name]
    agents, k = run["agents"], run["pod"]
    ranks = [json.loads((root / f"rank{r}.json").read_text())
             for r in range(agents * k)]
    what = f"lm training {name}"
    # (a) the float32 gate
    for rec in ranks:
        g = rec["gate"]
        check(g["gaps"]["x"] <= PODS_XY_TOL and g["gaps"]["y"] <= PODS_XY_TOL
              and max(g["gaps"][f] for f in ("u", "v", "p_prev"))
              <= PODS_UV_TOL, f"{what} gate rank {rec['rank']}: pods "
              f"against rows on the card {g['gaps']}, beyond {PODS_XY_TOL} "
              f"(x, y) / {PODS_UV_TOL} (u, v, p_prev)")
        check(g["pods_dropped"] == g["rows_dropped"], f"{what} gate rank "
              f"{rec['rank']}: the pod dropped {g['pods_dropped']} slots a "
              f"moe call, the rows agent {g['rows_dropped']}")
        check(sum(g["rows_dropped"]) > 0, f"{what} gate: no slot dropped")
    # (b) the state bytes at full size; (c) eval on each pod's data-0 rank
    cfg = dataclasses.replace(get_config(run["arch"]), **run["cut"])
    want = pods_state_bytes_want(cfg, k)
    for rec in ranks:
        check(rec["interact"]["state_bytes"] == want["bytes"],
              f"{what} rank {rec['rank']}: {rec['interact']['state_bytes']} "
              f"state bytes, the rule gives {want['bytes']}")
        check(rec["interact"]["dtypes"] == [f"torch.{cfg.dtype}"],
              f"{what}: state dtypes {rec['interact']['dtypes']}")
    evaluated = [rec for rec in ranks if rec["data"] == 0]
    check(len(evaluated) == agents and all(
        not rec["eval"] for rec in ranks if rec["data"] != 0),
        f"{what} eval: not one data-0 rank an agent")
    lm_gate_ranks(what, run, ranks, evaluated)
    summary = dict(
        arch=run["arch"], layout=f"{agents} agents x pods of {k}",
        cut=run["cut"], agents=agents, pod=k, processes=agents * k,
        gate=dict(arch=ranks[0]["gate"]["arch"], cut=run["gate_cut"],
                  gaps={f: max(rec["gate"]["gaps"][f] for rec in ranks)
                        for f in ranks[0]["gate"]["gaps"]},
                  bounds=[PODS_XY_TOL, PODS_UV_TOL],
                  dropped_per_call=[ranks[0]["gate"]["rows_dropped"]],
                  seconds=max(rec["gate"]["seconds"] for rec in ranks)),
        state_bytes_per_process=ranks[0]["interact"]["state_bytes"],
        state_bytes_rule=want, state_dtypes=ranks[0]["interact"]["dtypes"],
        interact_steps=[rec["interact"]["steps"] for rec in ranks],
        interact_pod_s_per_step=lm_per_step(ranks, "interact",
                                            "pod_seconds"),
        interact_pod_by_kind=ranks[0]["interact"]["steps"][-1]["pod_by_kind"],
        rows_peak_gb=None if rows is None else {
            key: max(p[key] for p in rows["peak_gb"])
            for key in rows["peak_gb"][0]},
        **lm_summary(run, ranks, evaluated, card))
    if run["svr_steps"]:
        summary.update(
            svr_steps=[rec["svr"]["steps"] for rec in ranks],
            **{f"svr_{kind}_{name}_per_step": lm_per_step(
                ranks, "svr", key, refresh=flag)
               for kind, flag in (("recursive", 0.0), ("refresh", 1.0))
               for name, key in (("s", "seconds"), ("pod_s", "pod_seconds"))})
    return summary


def lm_run_summary(arch: str, root: Path, card: str) -> dict:
    """Gates one LM training run on its ranks' records (``lm_worker``'s)
    and returns its summary."""
    run = LM_RUNS[arch]
    ranks = [json.loads((root / f"rank{r}.json").read_text())
             for r in range(run["agents"])]
    what = f"lm training {arch}"
    tol = run.get("card_cpu_tol", LM_CARD_CPU_TOL)
    for rec in ranks:
        gap = max(rec["card_vs_cpu"]["x_gap"], rec["card_vs_cpu"]["u_gap"])
        check(gap <= tol, f"{what} rank {rec['rank']}: the card is "
              f"{gap:.3e} from the CPU (x and u, reduced config), beyond "
              f"{tol}")
    lm_gate_ranks(what, run, ranks, ranks)
    moe = ranks[0]["moe_layers"]
    for rec in ranks:
        # in call order: the outer loss's forward and its recompute (the
        # layers in reverse), the inner features, the cross term's forward
        # and its recompute; each recompute routes as its forward did
        r = rec["interact"]["moe_routes"]
        check(len(r) == 5 * moe, f"{what} rank {rec['rank']}: {len(r)} moe "
              f"calls in the warm-up step, not 5 x {moe}")
        passes = [r[i * moe:(i + 1) * moe] for i in range(5)]
        check(passes[1] == passes[0][::-1] and passes[4] == passes[3][::-1],
              f"{what} rank {rec['rank']}: a recompute in the backward "
              f"pass routed otherwise than its forward: {passes}")
    summary = dict(
        arch=arch, cut=run["cut"], agents=run["agents"],
        params=ranks[0]["interact"]["params"],
        head=ranks[0]["interact"]["head"],
        attn_layers=ranks[0]["attn_layers"], moe_layers=moe,
        interact_steps=ranks[0]["interact"]["steps"],
        interact_step_seconds=[[s["seconds"] for s in rec["interact"]["steps"]]
                               for rec in ranks],
        moe_dropped_warmup=ranks[0]["interact"]["moe_dropped"],
        card_vs_cpu=[rec["card_vs_cpu"] for rec in ranks],
        card_vs_cpu_tol=tol, prefix=ranks[0]["interact"]["prefix"],
        **lm_summary(run, ranks, ranks, card))
    if "rwkv_loop" in ranks[0]:
        # an INTERACT step runs the loop 5 times a layer: the outer loss's
        # checkpointed forward and its recompute with the backward, the
        # inner features (no autograd), the cross term's forward and its
        # recompute with the backward
        loop = dict(ranks[0]["rwkv_loop"])
        loop["interact_step_s"] = ranks[0]["rwkv_layers"] * (
            3 * loop["forward_s"] + 2 * loop["forward_backward_s"])
        loop["interact_share"] = (loop["interact_step_s"]
                                  / summary["interact_s_per_step"])
        summary["rwkv_loop"] = loop
    if run["svr_steps"]:
        summary.update(
            svr_steps=ranks[0]["svr"]["steps"],
            svr_step_seconds=[[s["seconds"] for s in rec["svr"]["steps"]]
                              for rec in ranks])
    return summary


def run_lm_training(torch, *phases: str, gate=None) -> dict:
    """Phases 4h, 4k and 4l (see the module docstring; ``phases`` keys
    of ``LM_PHASE_RUNS``, every one when none is given): the runs of each
    phase in turn, each run's worker processes of this script on the card,
    started through the localhost launcher's ``launch_workers`` (their
    errors go to this script's), gated here on their records.  A run's
    processes start while the run before it trains, import meanwhile, and
    join their group only once that run has ended and passed its gates
    (``launch_workers``' ``prepare``), so that no two runs use the card at
    once; the first run's join only once ``gate()`` has returned.  Returns
    each phase's runs, seconds (its runs' walls, each from the end of the
    run before it or from the gate) and eval launches."""
    import shutil
    import threading

    from repro_torch.launch.launch_local import launch_workers

    card = gpu_name_and_power_limit()
    phases = phases or tuple(LM_PHASE_RUNS)
    root = ROOT / "build" / "lm_training"
    shutil.rmtree(root, ignore_errors=True)
    order = [(phase, arch) for phase in phases
             for arch in LM_PHASE_RUNS[phase]]
    # set when a run has ended, with whether it passed
    ended = [threading.Event() for _ in order]
    passed = [False] * len(order)

    t_go = []

    def first() -> None:
        if gate is not None:
            gate()
        t_go.append(time.perf_counter())

    def after(i: int) -> None:
        ended[i].wait()
        check(passed[i], f"lm training {order[i][1]} failed: "
              f"{order[i + 1][1]} does not start")

    def launch(i: int, arch: str) -> list:
        run = LM_RUNS[arch]
        pod = run.get("pod")
        return launch_workers(
            str(ROOT / "chip_smoke.py"), ["--lm-worker", "--run", arch],
            run["agents"] * (pod or 1), str(root / arch / "result.json"),
            LM_TIMEOUT, prepare=(lambda: after(i - 1)) if i else first)

    out = {phase: dict(runs={}, seconds=0.0) for phase in phases}
    with ThreadPoolExecutor(2) as pool:
        futures = [pool.submit(launch, i, arch)
                   for i, (_, arch) in enumerate(order)]
        try:
            for i, (phase, arch) in enumerate(order):
                failed = futures[i].result()
                check(not failed, f"lm training {arch}: failed workers "
                      f"(rank, exit code) {failed}; their errors are above")
                run = LM_RUNS[arch]
                if "pod" in run:    # beside the rows run of its arch
                    rows = [r["runs"][run["arch"]] for r in out.values()
                            if run["arch"] in r["runs"]]
                    summary = lm_pods_summary(arch, root / arch, card,
                                              rows[0] if rows else None)
                else:
                    summary = lm_run_summary(arch, root / arch, card)
                t_end = time.perf_counter()
                summary["wall_seconds"] = t_end - (t_go[0] if i == 0
                                                   else t_last)
                t_last = t_end
                out[phase]["runs"][arch] = summary
                out[phase]["seconds"] += summary["wall_seconds"]
                print(f"lm training {arch}: {json.dumps(summary)}",
                      flush=True)
                passed[i] = True
                ended[i].set()
        finally:
            for future in futures:    # the runs not yet started
                future.cancel()
            for event in ended:
                event.set()
    for phase, rec in out.items():
        rec["eval_launches"] = {a: r["eval_launches"]
                                for a, r in rec["runs"].items()}
        print(f"lm training phase {phase}: {rec['seconds']:.1f} s",
              flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return out


def profile_steps(torch, solver, state, data, steps: int = 3) -> dict:
    """``device_profile`` of eager INTERACT steps (warmed up before)."""
    return device_profile(torch, lambda: solver.run(state, data, steps),
                          steps)


def profile_captured_steps(torch, solver, state, data, steps: int = 3
                           ) -> dict:
    """``device_profile`` of replayed INTERACT steps (graphs captured
    beforehand).  The profiler loses a kernel record now and then and
    never adds one (``counted_launches``), so a profile whose
    ``consensus_step`` count falls short of one a step is taken again
    from the next steps, ``LAUNCH_WINDOWS`` profiles at most; the last
    is returned with every window's count."""
    stepper = solver.stepper_for(state, data, scan=True)
    stepper.prepare(steps)
    counts = []
    for _ in range(LAUNCH_WINDOWS):
        profile = device_profile(torch, lambda: stepper.advance(steps), steps)
        counts.append(profile["consensus"]["consensus_step"])
        if counts[-1] >= steps:
            break
    profile["consensus_step_windows"] = counts
    return profile


def sweep_phase(torch, ops) -> dict:
    """Phase 4e and the wrapper counts it made (the warm-up steps and
    captures of every graph it captured)."""
    sweeps = run_sweep(torch, ops)
    wrapper = dict(ops.LAUNCHES)
    print(f"sweep phase: wrapper launches {wrapper} (the warm-up "
          f"steps and captures of every graph the phase captured); kernel "
          f"events in the "
          f"Figure-2 groups' profiled replays {sweeps['launches']}",
          flush=True)
    for name in KERNEL_SYMBOL:
        check(sweeps["launches"][name] >= 1, f"sweep: batched {name} never "
              "ran in the profiled replays")
    return dict(launches=sweeps["launches"], wrapper=wrapper,
                seconds=sweeps["seconds"])


# what the main process reads of each phase a worker runs
WORKER_PHASES = {
    "sweep": sweep_phase,
    "resilience": lambda torch, ops: {
        k: v for k, v in run_resilience(torch, ops).items()
        if k in ("launches", "seconds")},
    "distributed": lambda torch, ops: {
        k: v for k, v in run_distributed(torch).items()
        if k in ("layouts", "seconds")},
}


def phase_worker(argv) -> int:
    """``--phase-worker OUT PHASE...``: imports what it needs, waits for
    the main process's go file (``OUT.go``), then runs the named phases of
    ``WORKER_PHASES`` in turn, the consensus counts set to 0 just before
    each, or the LM training phases (keys of ``LM_PHASE_RUNS``, which
    launch no consensus kernel) as one ``run_lm_training``, whose first
    run's processes import before the go, and writes what the main
    process reads of them to OUT as JSON.  The kernel libraries are the
    ones the main process built."""
    out, *names = argv
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels.consensus_step import ops
    from repro_torch.launch.launch_local import _await_go
    gate = lambda: _await_go(out + ".go", PHASE_WORKER_TIMEOUT)
    results = {}
    lm = [name for name in names if name in LM_PHASE_RUNS]
    if lm:
        results.update({phase: {k: rec[k] for k in ("eval_launches",
                                                     "seconds")}
                        for phase, rec in run_lm_training(
                            torch, *lm, gate=gate).items()})
    else:
        gate()
    for name in names:
        if name in lm:
            continue
        for kernel in ops.LAUNCHES:
            ops.LAUNCHES[kernel] = 0
        results[name] = WORKER_PHASES[name](torch, ops)
    Path(out).write_text(json.dumps(results))
    return 0


def start_phase_workers() -> list:
    """One ``--phase-worker`` process for each group of ``PHASE_GROUPS``,
    each in a session of its own (so that ``stop_phase_workers`` stops the
    processes it starts too, at the latest when this process exits), its
    output to a log under the git-ignored ``build/phase_workers/``.  They
    import, and wait for ``release_phase_workers``."""
    import atexit
    import shutil
    root = ROOT / "build" / "phase_workers"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    workers = []
    for i, names in enumerate(PHASE_GROUPS):
        log, out = root / f"worker{i}.log", root / f"worker{i}.json"
        with log.open("w") as f:
            proc = subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"),
                 "--phase-worker", str(out), *names],
                stdout=f, stderr=subprocess.STDOUT, start_new_session=True)
        workers.append(dict(names=names, proc=proc, log=log, out=out))
    atexit.register(stop_phase_workers, workers)
    return workers


def release_phase_workers(workers: list) -> None:
    """Lets the workers run their phases (their go files)."""
    for w in workers:
        Path(f"{w['out']}.go").touch()


def finish_phase_workers(workers: list, started: float) -> dict:
    """Waits for every worker (until ``PHASE_WORKER_TIMEOUT`` seconds after
    ``started``), prints its output, and returns its phases' records;
    fails on a worker that exited non-zero or did not end in time."""
    results = {}
    for w in workers:
        left = started + PHASE_WORKER_TIMEOUT - time.perf_counter()
        try:
            rc = w["proc"].wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            rc = None
        text = w["log"].read_text()
        print(f"phase worker {'+'.join(w['names'])}: exit code {rc}; its "
              f"output follows\n{text.rstrip()}", flush=True)
        if rc != 0:
            print(text[-4000:], file=sys.stderr, flush=True)
        check(rc == 0, f"phase worker {'+'.join(w['names'])}: " + (
            f"still running {PHASE_WORKER_TIMEOUT} s after its start"
            if rc is None else f"exit code {rc}"))
        results.update(json.loads(w["out"].read_text()))
    return results


def stop_phase_workers(workers: list) -> None:
    """Kills what is left of each worker's session (the worker and the
    processes it started)."""
    import os
    import signal
    for w in workers:
        try:
            os.killpg(w["proc"].pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        w["proc"].wait()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on an NVIDIA GPU only", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_name_and_power_limit()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    from repro_torch.kernels import build
    from repro_torch.kernels.consensus_step import ops, ref
    from repro_torch.solvers import (GraphStepper, SolverConfig,
                                     default_setup, make_solver, solve)
    from repro_torch.solvers.config import TopologyConfig

    # one nvcc per source, all started together
    phase_seconds = {}    # host clock, printed before the kernels line
    t0 = time.perf_counter()
    sources = [ROOT / src for src in (SOURCE, FLASH_SOURCE, WKV_SOURCE)]
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(build.build, sources))
    phase_seconds["build"] = time.perf_counter() - t0
    print(f"built {len(libs)} kernel sources for sm_90a in "
          f"{phase_seconds['build']:.2f} s", flush=True)
    ptxas = {}
    for src, lib in zip(sources, libs):
        log = lib.with_suffix(".log").read_text()
        print(f"{src.relative_to(ROOT)} -> {lib.relative_to(ROOT)}:\n"
              + log.strip(), flush=True)
        ptxas.update(ptxas_report(log))
    print(f"ptxas: {json.dumps(ptxas)}", flush=True)

    t0 = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    main_matrix = torch.tensor(TopologyConfig().mixing_spec(5).matrix,
                               dtype=torch.float32, device=dev)
    err, timings = check_kernels(torch, ops, ref, main_matrix)
    batched_err, batched_timings = check_batched_kernels(torch, ops, ref,
                                                         main_matrix)
    row_err, row_timings = check_row_kernels(torch, ops, ref)
    flash = check_flash(torch)
    blockwise = check_blockwise(torch)
    wkv = check_wkv6(torch)
    phase_seconds["kernels"] = time.perf_counter() - t0
    t_main = time.perf_counter()
    # the phase workers (4e-4h, 4k, 4l) import beside 4 and 4b, and start
    # their phases once 4b's profiles are taken
    workers = start_phase_workers()

    # -- the INTERACT path: counts to 0 just before, read just after -------
    cfg = dict(algo="interact", alpha=0.3, beta=0.3)
    t0 = time.perf_counter()
    res_cuda, main_ran, main_windows = counted_launches(
        torch, ops, lambda: solve(SolverConfig(backend="cuda", **cfg),
                                  NUM_STEPS, RECORD_EVERY),
        lambda wrapper: dict(
            consensus_step=NUM_STEPS + GraphStepper.WARMUP_STEPS,
            consensus_mix=wrapper["consensus_mix"]))
    launches = dict(ops.LAUNCHES)
    t_cuda = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_dense = solve(SolverConfig(backend="dense", **cfg), NUM_STEPS,
                      RECORD_EVERY)
    t_dense = time.perf_counter() - t0
    check(ops.LAUNCHES == launches, "the dense run launched a kernel")

    for name, res, took in (("cuda", res_cuda, t_cuda),
                            ("dense", res_dense, t_dense)):
        print(f"main path {name}: eq.-11 trace {res.trace}", flush=True)
        print(f"main path {name}: us_per_step {res.us_per_step:.1f} "
              f"round_latency_us {res.round_latency_us:.1f} "
              f"hvp/step {res.hvp_per_step} grad/step {res.grad_per_step} "
              f"wall {took:.1f} s", flush=True)
        check(len(res.trace) == NUM_STEPS // RECORD_EVERY + 1,
              f"{name}: trace length")
        check(all(math.isfinite(v) for v in res.trace),
              f"{name}: non-finite eq.-11 trace")
        check(res.trace[-1] < res.trace[0],
              f"{name}: M_40 = {res.trace[-1]} is not below M_0 = "
              f"{res.trace[0]}")
        check((res.hvp_per_step, res.grad_per_step) == (33, 1),
              f"{name}: hypergradient counts")
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(res_cuda.trace, res_dense.trace))
    print(f"main path: wrapper launches {launches} (the warm-up steps, the "
          f"capture and the round-latency mixes); the card ran {main_ran} "
          f"(profiled windows: {main_windows}) "
          f"(torch.profiler's kernel events: {NUM_STEPS} replays and "
          f"{GraphStepper.WARMUP_STEPS} warm-up steps of consensus_step; "
          f"the cuda run's us_per_step is under the profiler); cuda vs "
          f"dense trace max relative gap {rel:.3e} (tolerance "
          f"{TRACE_RTOL:.1e})", flush=True)
    check(rel <= TRACE_RTOL, "cuda and dense traces disagree")
    check(launches["consensus_step"] >= 1, "consensus_step never launched")
    check(launches["consensus_mix"] >= 1, "consensus_mix never launched")
    want = NUM_STEPS + GraphStepper.WARMUP_STEPS
    check(main_ran["consensus_step"] == want,
          f"solve: the card ran consensus_step {main_ran['consensus_step']} "
          f"times, not once in each of {NUM_STEPS} replayed steps and "
          f"{GraphStepper.WARMUP_STEPS} warm-up steps")
    check(main_ran["consensus_mix"] >= 1, "solve: consensus_mix never ran")

    # -- the four algorithms, eager and captured: counts to 0 before each --
    algos = run_algorithms(torch, ops)
    runs = algos["runs"]

    # -- where an INTERACT step's time goes (after the counts were read) --
    solver, state, data = algos["keep"]["interact"]
    eager_solver = make_solver(SolverConfig(backend="cuda", **cfg))
    problem, x0, y0, _ = default_setup(0)
    eager_state = eager_solver.init(problem, None, x0, y0, data)
    eager_solver.warmup(eager_state, data)
    # where both can see the launches (3 eager steps), the profiler's
    # kernel events count what the wrappers count
    _, ran, windows = counted_launches(
        torch, ops, lambda: eager_solver.run(eager_state, data, 3),
        lambda wrapper: wrapper)
    check(ran == ops.LAUNCHES, f"3 eager steps: kernel events {ran} "
          f"(windows {windows}) against wrapper counts {ops.LAUNCHES}")
    print(f"3 eager INTERACT steps: kernel events {ran} (profiled windows "
          f"{windows}), wrapper counts {ops.LAUNCHES}", flush=True)
    profiles = {
        "eager": profile_steps(torch, eager_solver, eager_state, data),
        "captured": profile_captured_steps(torch, solver, state, data)}
    check(profiles["captured"]["consensus"]["consensus_step"]
          == profiles["captured"]["units"],
          "captured profile: consensus_step not run once a replayed step "
          f"(kernel events in each window: "
          f"{profiles['captured']['consensus_step_windows']})")
    for mode, profile in profiles.items():
        profile["mode"] = mode
        if profile["device_us"] > 0:
            profile["device_busy_share"] = (
                profile["device_us"] / runs["interact", mode]["us_per_step"])
        else:
            profile["device_busy_share"] = "not measured: no device events"
        print(json.dumps({"profile": profile}), flush=True)

    phase_seconds["main_path_algorithms_profiles"] = (
        time.perf_counter() - t_main)

    # -- phases 4e-4h, 4k and 4l in worker processes (sweeps; resilience;
    # across processes; LM training), each worker's counts set to 0 just
    # before each of its phases and read just after, beside 4c-4d here
    t0 = time.perf_counter()
    release_phase_workers(workers)
    try:
        # -- the compressed wire and the time-varying topologies ----------
        wire = run_wire(torch, ops)

        # -- the Byzantine layer: attacks, robust combines, guards --------
        byzantine = run_byzantine(torch, ops)
        phase_seconds["wire_byzantine"] = time.perf_counter() - t0

        # what this process keeps cached leaves the card to the LM phases
        torch.cuda.empty_cache()
        done = finish_phase_workers(workers, t0)
    finally:
        stop_phase_workers(workers)
    phase_seconds["with_workers"] = time.perf_counter() - t0
    phase_seconds.update({f"worker {name}": rec["seconds"]
                          for name, rec in done.items()})
    sweeps, resilience = done["sweep"], done["resilience"]
    sweep_wrapper = sweeps["wrapper"]
    distributed = done["distributed"]
    lm_eval_launches = {arch: n for phase in LM_PHASE_RUNS
                        for arch, n in done[phase]["eval_launches"].items()}

    # -- mamba and moe serving: counts to 0 just before each model's run --
    t0 = time.perf_counter()
    moe_mamba = run_moe_mamba_serving(torch)
    phase_seconds["moe_mamba_serving"] = time.perf_counter() - t0

    # -- frontend serving: counts to 0 just before each model's run -------
    t0 = time.perf_counter()
    frontends = run_frontend_serving(torch)
    phase_seconds["frontend_serving"] = time.perf_counter() - t0

    # -- the serving path: counts to 0 just before each model's run --------
    t0 = time.perf_counter()
    from repro_torch.configs import get_config
    serving = {(arch, dtype): serve_model(
        torch, dataclasses.replace(get_config(arch), dtype=dtype),
        *SERVE_RUNS[arch])
        for arch in SERVE_RUNS for dtype in ("float32", "bfloat16")}
    print(json.dumps({"serving": list(serving.values())}), flush=True)
    phase_seconds["serving"] = time.perf_counter() - t0
    print(f"phase seconds (host clock; the workers' beside "
          f"wire_byzantine): {json.dumps(phase_seconds)}", flush=True)

    kernels = []
    # launches: the main path's (solve's) run, from the kernel events;
    # beside them the captured and eager runs of the algorithm whose every
    # step launches the kernel (INTERACT for consensus_step, D-SGD for
    # consensus_mix)
    launch_runs = {"consensus_step": "interact", "consensus_mix": "d-sgd"}
    for name in REPLACES:
        main = timings[name]["main"]
        run_of = launch_runs[name]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=main_ran[name],
            launches_from=(f"solve, interact, {NUM_STEPS} captured steps: "
                           "torch.profiler kernel events"),
            launches_wrapper=launches[name],
            launches_captured_run=runs[run_of, "captured"]["launches_run"][
                name],
            launches_eager_run=runs[run_of, "eager"]["launches_run"][name],
            launches_runs_of=run_of,
            launches_wire={row: rec["launches_replayed"][name]
                           for row, rec in wire.items()},
            launches_byzantine={row: rec["launches_replayed"][name]
                                for row, rec in byzantine.items()},
            launches_resilience=resilience["launches"][name],
            launches_resilience_from=(
                f"INTERACT killed at {KILL_AT} and resumed in a fresh "
                f"solver, snapshots every {CHECKPOINT_EVERY}: "
                "torch.profiler kernel events from the start to the "
                "resumed run's end (replays, lost ones included, and "
                "warm-up steps)"),
            max_abs_err=err[name]["float32"],
            max_abs_err_bf16=err[name]["bfloat16"],
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], eager_ms=main["eager_ms"],
            eager_plain_ms=main["eager_plain_ms"],
            eager_library_ms=main["eager_library_ms"],
            library_call=("addmm(u, M, x, beta=-alpha) + addmm(p - p_prev, "
                          "M, u)" if name == "consensus_step"
                          else "matmul(M, x)"),
            shape=main["shape"], large=timings[name]["large"],
            bfloat16={shape: timings[name][shape + "_bf16"]
                      for shape in ("main", "large")},
            ptxas={k: v for k, v in ptxas.items() if name in k}))
    for name in REPLACES:
        main = batched_timings[name]
        kernels.append(dict(
            name=f"{name}_batched", route="cuda", source=SOURCE,
            replaces=REPLACES[name], launches=sweeps["launches"][name],
            launches_from=(f"sweep, the Figure-2 grid's groups of "
                           f"{SWEEP_SEEDS} experiments, {NUM_STEPS} profiled "
                           "replays each: torch.profiler kernel events, one "
                           "launch a step for the group"),
            launches_wrapper=sweep_wrapper[name],
            max_abs_err=batched_err[name]["float32"],
            max_abs_err_bf16=batched_err[name]["bfloat16"],
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], eager_ms=main["eager_ms"],
            library_call=(
                "baddbmm(u, M, x, beta=-alpha) + baddbmm(p - p_prev, M, u), "
                "M expanded over the batch" if name == "consensus_step"
                else "bmm(M, x), M expanded over the batch"),
            shape=main["shape"]))
    for name in REPLACES:
        main = row_timings[name]["main"]
        kernels.append(dict(
            name=f"{name}_rows", route="cuda", source=SOURCE,
            replaces=REPLACES[name],
            launches=sum(n[name] for rec in distributed["layouts"].values()
                         for n in rec["row_launches_per_rank"]),
            launches_from=(
                "phase 4g: the row-block launches of every rank of the "
                f"three layouts' run_section6 ({DIST_STEPS} steps; allgather "
                "consensus_step once a step a rank, consensus_mix in the 6 "
                "round-latency mixes; ppermute none)"),
            launches_per_layout={
                layout: [n[name] for n in rec["row_launches_per_rank"]]
                for layout, rec in distributed["layouts"].items()},
            max_abs_err=row_err[name]["float32"],
            max_abs_err_bf16=row_err[name]["bfloat16"],
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"],
            library_call=(
                "addmm(u[rows], M[rows], x, beta=-alpha) + addmm(p - p_prev, "
                "M[rows], u)" if name == "consensus_step"
                else "matmul(M[rows], x)"),
            shape=main["shape"], row0=main["row0"],
            large=row_timings[name]["large"]))
    sdpa = ("scaled_dot_product_attention(is_causal=True, enable_gqa=True) "
            "without the softcap, which it cannot apply")
    f32_run = serving[("gemma2-2b", "float32")]["launches"]
    main = flash["timings"]["global_f32"]
    local = flash["timings"]["local_f32"]

    def moe_mamba_launches(name: str, dtype: str) -> dict:
        """Phase 4i's launches of a flash kernel: each run's (two kernel
        prefills) and the card-against-CPU runs' (one each)."""
        out = {f"{arch} {dtype}": rec["launches"][name]
               for (arch, dt), rec in moe_mamba["runs"].items()
               if dt == dtype}
        if dtype == "float32":
            out.update({f"{arch} reduced": rec["launches"][name]
                        for arch, rec in moe_mamba["card_vs_cpu"].items()})
        return out

    def frontend_launches(name: str, dtype: str) -> dict:
        """Phase 4j's launches of a flash kernel: each run's two kernel
        prefills (one with the prefix, one of the prompt and the fed
        tokens)."""
        return {f"{arch} {dtype}": rec["launches"][name]
                for (arch, dt), rec in frontends["runs"].items()
                if dt == dtype}

    def at_shapes(suffix: str, keys, models=("jamba", "mixtral",
                                              "paligemma", "musicgen")
                  ) -> dict:
        return {f"at_{model}": {key: flash["timings"][model + suffix][key]
                                for key in keys}
                for model in models}
    kernels.append(dict(
        name="flash_attention_f32_split", route="cuda", source=FLASH_SOURCE,
        replaces=FLASH_REPLACES, dtype="float32",
        launches=f32_run["flash_attention_f32_split"],
        max_abs_err=flash["err"]["split"],
        ms=main["split"]["ms"], plain_ms=main["split"]["plain_ms"],
        bound_ms=main["split"]["bound_ms"],
        bound_by=main["split"]["bound_by"], library_ms=None,
        library_call="none: no PyTorch call computes the scaled split",
        shape=main["shape"], local=local["split"],
        launches_moe_mamba_serving=moe_mamba_launches(
            "flash_attention_f32_split", "float32"),
        launches_frontend_serving=frontend_launches(
            "flash_attention_f32_split", "float32"),
        **{f"at_{model}": flash["timings"][model + "_f32"]["split"]
           for model in ("jamba", "mixtral", "paligemma", "musicgen")},
        ptxas={k: v for k, v in ptxas.items()
               if "flash_split_f32_kernel" in k}))
    kernels.append(dict(
        name="flash_attention_f32", route="cuda", source=FLASH_SOURCE,
        replaces=FLASH_REPLACES, dtype="float32",
        launches=f32_run["flash_attention_f32"],
        max_abs_err=flash["err"]["float32"],
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"],
        bound_split_arith_ms=main["bound_split_arith_ms"],
        bound_f32_fma_ms=main["bound_f32_fma_ms"], call_ms=main["call_ms"], library_ms=main["library_ms"],
        library_call=sdpa, shape=main["shape"], softcap=main["softcap"],
        local={key: local[key] for key in (
            "ms", "call_ms", "plain_ms", "bound_ms", "bound_split_arith_ms",
            "bound_f32_fma_ms", "library_ms")},
        launches_moe_mamba_serving=moe_mamba_launches("flash_attention_f32",
                                                      "float32"),
        launches_frontend_serving=frontend_launches("flash_attention_f32",
                                                    "float32"),
        **at_shapes("_f32", ("shape", "window", "ms", "call_ms", "plain_ms",
                             "bound_ms", "bound_by", "bound_split_arith_ms",
                             "bound_f32_fma_ms", "library_ms",
                             "library_call")),
        ptxas={k: v for k, v in ptxas.items()
               if "flash_attention_f32_kernel" in k}))
    main = flash["timings"]["global"]
    kernels.append(dict(
        name="flash_attention_tc", route="cuda", source=FLASH_SOURCE,
        replaces=FLASH_REPLACES, dtype="bfloat16",
        launches=serving[("gemma2-2b", "bfloat16")]["launches"][
            "flash_attention_tc"],
        launches_lm_eval={arch: n["flash_attention_tc"]
                          for arch, n in lm_eval_launches.items()
                          if "flash_attention_tc" in n},
        launches_lm_eval_from=(
            "phases 4h, 4k, 4l and 4m: make_eval_step(attn_impl='cuda'), "
            "2 calls on each agent's process of each run (4m: on each "
            "pod's data-0 rank; agents: "
            f"{ {arch: run['agents'] for arch, run in LM_RUNS.items()} }), "
            "one launch an attention layer each"),
        max_abs_err=flash["err"]["bfloat16"],
        max_row_rel_err=flash["err"]["bfloat16_row"],
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=main["library_ms"],
        library_call=sdpa, shape=main["shape"], softcap=main["softcap"],
        local=flash["timings"]["local"],
        launches_moe_mamba_serving=moe_mamba_launches("flash_attention_tc",
                                                      "bfloat16"),
        launches_frontend_serving=frontend_launches("flash_attention_tc",
                                                    "bfloat16"),
        **at_shapes("", ("shape", "window", "ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms", "library_call"),
                    ("jamba", "mixtral", "paligemma", "musicgen",
                     "smollm_train", "mixtral_train", "jamba_train",
                     "gemma2_train", "paligemma_train"))))
    main = wkv["timings"]["main"]
    kernels.append(dict(
        name="wkv6", route="cuda", source=WKV_SOURCE, replaces=WKV_REPLACES,
        launches=serving[("rwkv6-3b", "float32")]["launches"]["wkv6"],
        launches_lm_eval={arch: n["wkv6"]
                          for arch, n in lm_eval_launches.items()
                          if "wkv6" in n},
        launches_lm_eval_from=(
            "phase 4l: make_eval_step(attn_impl='cuda'), 2 calls, one "
            "launch an rwkv layer each"),
        at_rwkv6_train=wkv["timings"]["rwkv6_train"],
        max_abs_err=wkv["err"]["float32"],
        max_abs_err_bf16=wkv["err"]["bfloat16"],
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=None,
        library_call="none: no PyTorch call computes WKV6",
        shape=main["shape"], dtype=main["dtype"],
        ptxas={k: v for k, v in ptxas.items() if "wkv6_kernel" in k}))
    print(json.dumps({"blockwise": blockwise}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--lm-worker"]:
        sys.exit(lm_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--phase-worker"]:
        sys.exit(phase_worker(sys.argv[2:]))
    sys.exit(main())
