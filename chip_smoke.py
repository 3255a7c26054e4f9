"""Smoke run of the PyTorch/CUDA port (ompi_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches its own failure):

1. The card: ``nvidia-smi --query-gpu=name,power.limit``.
2. Every kernel of the main path against its plain PyTorch version, on the
   card, bit for bit (the fold order of each is fixed):
   K2 ``combine2`` (Triton) — every op on float32, int32, int8 and bool;
   K1 ``reduce_stack`` (Triton) — k = 8, 16 MB slices, the same ops;
   K3 fused ring all-reduce (CUDA C++) — float32 sum/max/min/prod, 4 MB per
   rank; K4 segmented ring all-reduce (CUDA C++) — the same at 16 MB per rank;
   K5 fused ring reduce-scatter (CUDA C++) — the same four ops on
   ``(8, 8, 131072)``, 4 MB per rank; K6 segmented ring reduce-scatter —
   the same on ``(8, 8, 524288)``, 16 MB per rank; K5 and K6 on ragged
   blocks ``S = (3, 5)`` and ``(1001,)``, float32 and float16; K10 ring
   all-gather (CUDA C++) — 16 MB per rank float32, an odd int8 length and an
   unaligned pointer; K12 ring bcast (CUDA C++) — roots 0, 3 and 7 at 16 MB
   per rank float32 (root 3's row holding -0.0 and NaN), int32, an int8
   payload of odd byte length, bool and bfloat16; K13 ring right permute
   (CUDA C++) — 16 MB per rank float32, an odd float16 length, an unaligned
   pointer; K14 all-to-all (CUDA C++) — ``(8, 8, 524288)`` float32 (16 MB per
   rank), int8 blocks of odd byte length, bool; K15 ragged all-to-all (CUDA
   C++) — the MoE dispatch slab below with its routing, then counts 0, R,
   R + 5 and -3, an R of 1001 (not a whole number of chunk_rows), and the
   slab as int32; K16 ragged all-gather (CUDA C++) — ``(8, 1280, 4096)``
   float32 with the routing's counts, with counts 0 and R, and bfloat16.
   The copies (K10, K12, K13–K16) are compared byte for byte, the ragged
   ones over their valid rows.  The int8 codec (Triton): K17
   ``encode_int8``, K19 ``decode_int8`` and K18 ``dequant_accumulate`` at
   k = 2 and 8, on 8 × 16 MB float32 and on 8 × 70001 elements, each holding
   an all-zero block, a block of exact .5 ties, a NaN block and a ±inf block
   (bit for bit; NaN compared as NaN at the same places).  The bf16 wire
   (CUDA C++): K7 ``all_reduce`` wire16 with sum/max/min/prod at 4 MB per
   rank and 23 and 1000 elements per rank, K5's wire16 form on ``(8, 8,
   131072)`` and ragged blocks ``S = (23,)`` and ``(5, 200)``.  K21, the
   flash-attention block update (CUDA C++), within 1e-6 (float32) and 2^-7
   (bfloat16) of the plain version's largest magnitude, NaN at the same
   places: both dtypes at the training step's shape (32 rows, 256 x 256,
   head dim 256), unbiased and with ring attention's per-rank causal bias,
   from m = -inf and chained (a fully masked block leaves the state); a
   fully masked row at m = -inf (NaN); a ragged sq = 200; the JAX bench's
   shape ``(4, 8, 2048, 2048, 128)`` in bfloat16; and at its edges
   (``check_flash_edges``), in the second-pass form the C entry picks for
   each shape: head dims 30, 32, 64, 66, 100, 128, 130, 200 and 256 at sq =
   200 with 100 keys (the scores kept on chip) and 1055 (recomputed, the
   last tile ragged), key counts 1, 31, 64, 255, 256, 257, 320, 321, 1024
   and 1055 at d = 256, each with and without a per-rank causal bias, a
   fully masked block chained (the state bit-equal) and a fully masked row
   from m = -inf at 256 and 1055 keys, and q, k, v from storage offset 1
   (the element path) at both; the edges of the bfloat16 body's m16n8k16
   fragments, sq 15, 16 and 17 against skv 7, 8, 9, 15 and 17 at d = 8,
   16, 24, 136 and 248, with and without the causal bias, and at d = 64 and
   256 with 64 and 1055 keys a bias masking one 8-key column of every
   fragment and one leaving each row a single finite score (one lane of a
   quad), from a running state and from m = -inf (no NaN); and the float32
   body's outputs on ``chip_flash_bodies.py``'s cases bit-equal to the
   digests recorded there (the body is the one it was before the bfloat16
   body was split from it).  The duplex ring (CUDA
   C++): K8 ``all_reduce`` bidi at 4 MB per rank and K9 seg_bidi at 16 MB
   per rank (float32, every op), both on 23, 407 and 999 elements per rank
   in float16/32/64 with every op, from an aligned and an unaligned pointer;
   K11 all-gather bidi on 16 MB per rank float32, an odd int8 length, an
   unaligned view and n = 5 (byte for byte).  The byte mover that K10, K11
   and K13–K16 launch (``csrc/pair_copy.cuh``) at the edges of its design
   (``check_mover_edges``): payloads off 16 bytes, bool, n = 1, 2, 3, 5, 8,
   an empty payload, a view at storage offset 1, totals of 1, 15, 16 and 17
   bytes and one 16 KB slot ± 16 bytes (the bytes around the range
   untouched), K13 and K14 at odd sizes, K15 and K16 with all-zero, all-R,
   one-expert and ragged tables (byte for byte).  The torus schedules, each
   phase one sub-ring launch of K3/K5, on grids (2, 4) and (4, 2) against
   their plain composition: ``all_reduce_torus`` (float32 and float16, every
   op), ``reduce_scatter_torus`` (sum, max) and ``all_gather_torus``.  K20,
   the collective matmul (CUDA C++), both forms (``matmul_allreduce``,
   ``matmul_reduce_scatter``) at Mixtral-8x7B's expert down projection
   (``w2``, 14336 → 4096, split over the 8 ranks along its hidden units,
   on the capacity buffer of 8 × 1280 rows: a ``(8, 10240, 1792)``, b
   ``(8, 1792, 4096)``), at M = 10237 (a padded last block), float32 and
   bfloat16, and at the edge shapes (n, M, K/n, N) of ``K20_EDGES``: (8,
   1001, 200, 520) (a 128-row tile crossing the block boundary on the TMA
   path), n = 2 and n = 5, and (8, 1001, 37, 203) (K/n and N off the
   multiples of 8): bit for bit on integer inputs in [-4, 4], within 1e-5
   (float32) and 2^-7 (bfloat16) of the largest Σ|a||b| on normal ones, and
   bfloat16 within (n + 1)·2^-8 of max|C| (half an ulp for each of the n
   partials' roundings and of the folds').  Each launch must take the body
   its shape picks (``ops.overlap.bodies``): ffma for float32, wgmma for
   bfloat16 at the Mixtral shapes and the first three edge shapes, mma_sync
   at the last.
3. The main path, with every launch count set to 0 before and read after:
   ``ompi_tpu_torch.init()`` (8 virtual ranks on ``cuda:0``), then at
   default priorities ``COMM_WORLD.allreduce_array`` — SUM to coll/builtin,
   PROD and BAND to coll/builtin's stack fold (K1) — ``bcast_array(root=3)``
   and ``allgather_array`` at 16 MB per rank and ``reduce_scatter_array``
   SUM and PROD (K1) at 4 MB per rank, all through coll/builtin, and
   ``ompi_tpu_torch.reduce_local`` (MPI_Reduce_local, K2); then re-init with
   ``OTPU_MCA_coll_ring_priority=95``: allreduce SUM at 4 MB per rank (K3)
   and at 16 MB per rank, the headline cell (K4), ``bcast_array`` (K12) and
   ``allgather_array`` (K10) at 16 MB per rank, ``reduce_scatter_array``
   SUM at 4 MB (K5) and 16 MB per rank (K6).  The exchange tier, both
   ways: ``alltoall_array`` on ``(8, 8, 524288)`` float32 (K14),
   ``alltoallv_array`` on the MoE dispatch slab (K15), ``allgatherv_array``
   on ``(8, 1280, 4096)`` float32 (K16), ``ppermute_array`` with the +1
   rotation at 16 MB per rank (K13) and with a general perm that leaves
   rank 1 without a source (coll/builtin both ways: K13's count must not
   move).  The compressed collectives: in the first init, ``COMM_WORLD.dup()``
   with the accuracy budget 0.01 (info key ``otpu_quant_budget``) runs
   allreduce SUM and allgather at 16 MB per rank through coll/builtin's
   int8 codec (K17 twice, K18 once, K19 once, exactly); a dup with budget
   0.005 (bf16 codec, plain torch) and MAX on the 0.01 dup launch no codec
   kernel; a third init adds ``OTPU_MCA_coll_ring_wire16=1`` to the raised
   ring: allreduce SUM at 4 MB per rank (K7 once), at 16 MB per rank (K4,
   no K7) and reduce_scatter SUM at 4 MB per rank (K5's wire16 form once); a
   fourth init has the raised ring with
   ``OTPU_MCA_coll_ring_bidirectional=1``: allreduce SUM at 4 MB per rank
   (K8 once) and at 16 MB per rank (K9 once), reduce_scatter SUM at 4 and 16
   MB per rank (K5, K6: no duplex kernel), allgather at 16 MB per rank (K11
   once), and ``allreduce_array_init`` at 4 MB per rank (K8 once to bind it)
   called twice (K8 twice, bit-equal to the one-shot call).
   Each result is held against the plain version (bit-exact; the ragged
   calls' views over their valid rows) and, for SUM, against
   ``torch.sum(x, 0)`` (tolerance below; the codecs within their band of
   ``torch.sum(x.double(), 0)`` relative to its largest magnitude, the
   wire within n·2^-8·Σ|x_i|).

   The MoE dispatch slab is Mixtral-8x7B's expert layer at full width
   (hidden 4096, 8 experts, top-2; the model card's published widths): 4096
   tokens per rank route 8192 rows over the 8 experts, one expert a rank,
   with skewed popularity (Zipf, exponent 0.7, sampled without replacement
   by Gumbel top-2 from SEED); capacity factor 1.25 gives R = ceil(1.25 ·
   4096 · 2 / 8) = 1280 rows per (rank, expert) pair, and each count is
   clamped to R, as a capacity-factor MoE drops the overflow.  x is
   ``(8, 8, 1280, 4096)`` float32: 160 MB per rank.

   Then the device-world communicator's path (``comm_path``), with the
   counts set to 0 before and read after, on a world with coll/ring raised
   (one-way, no wire16): coll/builtin's rooted and prefix slots at 8 x 16 MB
   and 8 x 1 MB float32 per rank -- ``reduce_array`` SUM, PROD and MAX at
   root 3 (its binomial tree launches K2 once a round, 3 a call, exactly),
   ``gather_array``, ``scatter_array`` (an ``(8, 8, S)`` input),
   ``scan_array`` and ``exscan_array`` -- and ``barrier``; sub-comms,
   ``create`` over ranks 0, 2, 4, 6 and a split into sizes 3, 3 and 2, each
   running allreduce (K3 at 4 MB per rank, K4 at 16 MB), reduce_scatter (K5,
   K6), allgather (K10) and bcast (K12) once with its own n; a size-1 split
   through coll/self_coll; ``world.allreduce`` of a tensor through
   coll/conductor to K3 and K4.  After the counts are read, and so not
   counted, the mover under CUDA graph capture (``check_captured_movers``,
   the cases of ``tests/mover_capture.py``: K10, K11 and K15, a captured
   launch replayed 1040 times, each replay started together with an eager
   launch of its library, and two graphs captured 1024 launches apart
   replayed together 16 times on two streams).  Results: reduce_array
   bit-exact with its tree on K2's plain version, gather and scatter byte
   for byte, scan within the cumsum band, the sub-comms bit-exact with the
   plain versions on their member rows, the captured movers byte-exact,
   and at 8 x 1 MB every new slot bit-exact with the same call on the CPU
   lane (a second init with ``device="cpu"``).  The ``comm_slots_ms`` line
   times each new slot at 8 x 16 MB (device ms beside its bound, the bytes
   read and written over 3.35 TB/s, the nearest torch call, and host µs per
   call of both, over 20 calls: 200 would fill the card's launch queue).

   Then the training path, with the counts set to 0 before and read after:
   ``parallel.dryrun.run_training_step`` at ``OTPU_MODEL_SCALE=64`` (the
   JAX package's bench width: d 512, head dim 256, sequence 512; lr 1e-5),
   two descending steps on the default mesh (dp=2, sp=2, tp=2) and two on
   dp=1, pp=2, sp=2, tp=2; K21 exactly (M + pp - 1) x layers_local x sp
   times a step (4 and 6), twice that under remat; the step with
   ``use_flash=False`` within 1e-5 of the K21 step's loss and 1e-4 of each
   leaf's update.  Then the same with ``otpu_parallel_compute_dtype=
   bfloat16`` (restored after; every K21 launch runs the mma.sync body),
   with the counts set to 0 before and read after: two descending steps on
   each mesh, K21 exactly 4 and 6 times a step, and the loss within 1e-3 of
   the bfloat16 step with ``use_flash=False``.

   Then the MoE path, with the counts set to 0 before and read after: a
   world with coll/ring raised; ``parallel.moe.expert_ffn_fused`` on K20's
   Mixtral shape in float32 through coll/tuned's device cell (K20's
   all-reduce form once); with ``otpu_coll_tuned_fused_cells`` forcing
   ``matmul_reduce_scatter``, ``expert_ffn_fused`` again (its unfused
   einsum: no K20) and that cell itself (K20's reduce-scatter form once);
   ``dispatch_tokens`` on the MoE dispatch slab (K15 once) and on a dup
   with ``otpu_quant_budget`` 0.02 (the int8 packing, an int32 slab ``(8,
   8, 1280, 1152)``, K15 once); ``run_moe_training_step`` on (dp=2, ep=4)
   (descending, bit-stable across two builds, within 1e-5 of a CPU run).
   The counts must be exactly those, both K20 launches on the ffma body;
   K20 within its band of the plain
   version, the dispatch byte-exact (int8: bit-exact with the plain
   exchange of the packed slab, within half a step of each row's max).
4. Times: CUDA events around single calls, cold L2 (a 256 MB buffer is
   zeroed before each call), median of 25 after 3 warm-up calls, for each
   kernel, its plain version and one PyTorch library call computing the same
   function; the card spins first while the host enqueues every timed call,
   so host dispatch is never timed.  ``bound_ms`` is the bytes the function
   must move (inputs read once, output written once) over 3.35 TB/s, the
   H100 SXM's memory rate; the ragged kernels count their valid rows only.
   A collective kernel's ``launches`` is the sum of its counts in the main
   path and in the communicator's path (the capture cases are not
   counted).  K7 and K5's wire16 form
   are timed
   beside K3 and K5 on the same inputs (the same bytes), K8 and K9 beside
   K3 and K4, the ``torus_ms`` line times the three torus functions at 8 ×
   16 MB on the (2, 4) grid beside ``torch.sum`` and ``clone``, and the
   ``codec_path_ms`` line times the whole int8 allreduce (K17 then K18) and
   the bf16 codec's plain torch beside ``torch.sum`` at 8 × 16 MB.
   The ``host_us_per_call`` line is the host's time to
   enqueue one call of each kernel's wrapper and of its library call
   (200 calls while the card spins; K15's and K16's include the counts
   table each call makes and sends to the card).  K21 is timed at the
   step's shape in float32 (its FFMA body, the kernels-line row
   ``flash_block``, launched by the training path) and in bfloat16 (its
   mma.sync body, the row ``flash_block_mma``, launched by the bfloat16
   training path), and at the bench shape (bfloat16, the
   ``flash_block_bench`` line, beside ``scaled_dot_product_attention`` as
   a yardstick); its bound is the
   larger of 4·rows·sq·skv·d operations over the peak of the input dtype
   (67 TFLOP/s float32, 989 TFLOP/s bfloat16) and its bytes over 3.35
   TB/s.  The ``step_ms`` line is the host time of one training step
   ending in a sync (median and quartiles of 12 steps each), with K21 and
   with ``use_flash=False``, in float32 and in bfloat16, in turns;
   ``step_profile`` traces one step of each with ``torch.profiler``
   (device time by kernel, idle share).
   K20's rows (float32, the MoE path's dtype, in the kernels line; bfloat16
   in a ``fused_matmul_bf16`` line, each row with its phase-2 band), at
   the Mixtral shape, beside
   ``torch.einsum("nmk,nko->mo")``, median of 25 calls or of 5 where one
   call takes over 50 ms; bound by operations, 2·M·K·N over the peak of
   the dtype.  The ``earlier_ms`` line repeats, as constants from PERF.md's
   table and not measured here, the times of K4, K6, K9, K20 and K21 (in
   float32 at the step's shape, in bfloat16 at the bench's and the step's)
   before their redesign, and of K10, K11, K13–K16 and the torus
   all-gather before the byte mover.  The ``k1_compiled`` line gives K1's compiled kernel at
   its row's shape: registers, spills, shared memory and persistent grid.
5. The host tier (no kernel runs here): in the device world,
   ``as_rank(0).send`` of a 16 MB float32 tensor on the card to
   ``as_rank(5).recv`` into numpy (bytes equal to ``t.cpu()``), with the
   staging time (``torch_acc.to_host``, median of 11) and the host µs per
   8-byte message; then three jobs of the port's tpurun (each must exit
   0): ``-n 4`` of ``ompi_tpu_torch.examples.ring`` (rank 0's lines the
   token countdown), a ``-n 2`` ping-pong over btl/sm (one-way latency at
   8 B, eager; bandwidth at 4 MB, rendezvous), a ``-n 4`` coll/basic
   allreduce (``--mca coll basic,self_coll``) of a 16 MB float32 tensor a
   rank on the card, bit for bit against a numpy fold in coll/basic's order
   on every rank; a ``-n 4`` job under default selection (``TUNED``):
   coll/tuned's allreduce of 16 MB of integer-valued float32 a rank on the
   card (its ladder's ``ring_segmented``, then every ``ALLREDUCE`` entry
   forced through ``otpu_coll_tuned_allreduce_algorithm``, median ms of 5
   by rank), the staging pool's hit and miss counts after the 16 MB loop,
   libnbc's ``iallreduce`` (16 MB) and ``iallgather`` (1 MB) of card
   tensors, every exact result bit for bit against numpy on every rank, and
   the int8 ``allreduce_blockq`` on a dup with ``otpu_quant_budget`` 0.02
   (within 1/127 of the exact sum, five encodes a rank, the same bytes on
   every rank); a ``-n 4 --fake-nodes 2`` job (``HAN``): coll/han's
   allreduce and bcast (root 1, not its node's leader) of card tensors,
   exact; and coll/han's device half (``HierarchicalColl(2, 4)``) on the
   card: ``allreduce`` of an 8 x 16 MB float32 world tensor and
   ``reduce_scatter`` of an (8, 8, 512 K) one within 8 · 2^-24 of the
   largest sum of magnitudes of the float64 sum over the rank axis,
   timed beside ``torch.sum(x, 0)``.  All
   on one ``{"host_tier": {...}}`` line that carries the card's name and
   power limit.  With the native core built, the default-selection job's
   allreduce slot is coll/sm's, which hands 16 MB on to coll/tuned, and
   the han job's ranks must reach their node over btl/sm and the other
   node over btl/tcp.
6. The host transports (no kernel runs here): the native core
   (``ompi_tpu_torch/native``, built with g++ at first use) must be
   available and its epoll reactor must engage, or the phase fails; then
   the ``-n 2`` ping-pong over btl/sm and over btl/tcp (``--mca btl
   tcp,self``), each with the core and with ``OTPU_NATIVE_DISABLE=1`` (each
   job reports the btl and lane it ran on, checked), one-way latency at 8 B
   and bandwidth at 4 MB; coll/sm's allreduce and bcast (root 2) of 1 MB
   integer-valued float32 card tensors at ``-n 4``, bit for bit, beside
   coll/tuned (``--mca coll ^sm_coll``), median of 11 by rank; the quantized
   wire (``--fake-nodes 2 --mca otpu_coll_quant_wire 1``): coll/han's
   allreduce of 4 MB of float32 a rank, error within 1/127 of the largest
   exact sum, the ranks of a node equal, orig/enc bytes from
   ``quant.wire_stats()``; the convertor's pack of a 16 MB strided vector,
   native (over the worker pool) beside numpy, bytes equal first.  One
   ``{"host_transports": {...}}`` line with the card's name and power
   limit.
7. The one-sided rung (no kernel runs here): osc/device's window in the
   device world at full width, 8 ranks x 16 MB of float32 a row on the
   card, through a round of puts, SUM and MAX accumulates, get_accumulate
   and compare_and_swap (a match and a miss), bit for bit against the same
   updates made by plain torch on a copy, host µs a call; the ``-n 2``
   ping-pong of card tensors at 4 and 16 MB in four lanes: btl/sm with
   RGET (the default) and with ``pml_ob1_rget_limit 0``, btl/tcp
   (``--mca btl tcp,self``) with ``pml_ob1_rget_emulate 1`` and without,
   each rank asserting the payload and ``rget_msgs`` non-zero exactly in
   the RGET lanes; a ``-n 4`` osc/rdma window of 16 MB of float32 a rank
   (one fence epoch of puts to the right neighbour, 50 SUM accumulates a
   rank into rank 0, a ``fetch_and_op`` ticket, an exclusive-lock CAS loop
   and one PSCW epoch, every window bit for bit against numpy) and the same
   job at 1 MB across ``--fake-nodes 2``, where osc/pt2pt serves (the
   module of each rank asserted).  One ``{"one_sided": {...}}`` line with
   the card's name and power limit, ms per epoch by rank and each job's
   wall seconds.
8. The observability runtime (``observability``): the main path and the
   communicator's path again with tracing on (``otpu_trace_enable``), each
   with the counts set to 0 before and read after: the same launches as
   with tracing off, the captured movers passing, and device (``xla_*``)
   and coll spans recorded; the host µs a call of ``allreduce_array`` at 8
   x 2 KB three ways in turns (through the trace wrapper with tracing off,
   on the wrapper's ``__wrapped__`` slot, and with tracing on); a ``-n 2``
   ping-pong of card tensors at 8 B, 64 KB and 4 MB with ``otpu_trace_enable``
   and ``otpu_profile_stages`` over btl/sm and over btl/tcp, each job's
   merged timeline written and every ``pml_msg`` flow start finished, rank
   0's one-way µs at 8 B, the stage table of its 400 timed 8 B round
   trips and of the whole job; a ``-n 4`` job with monitoring on, the
   telemetry sampler at 100 ms and the sampling profiler at 10 ms: each
   rank's p2p bytes of card tensors and its coll bytes equal to the bytes
   it sent (a tensor's own count, no host copy), the launcher's merged
   matrix printed, the sampler's and the profiler's sample counts.  One
   ``{"observability": {...}}`` line with the card's name and power limit.
9. Process topologies and ULFM (``topology_ft``), with coll/ring raised and
   the counts set to 0 before and read after: ``cart_create((2, 4),
   periods=(True, False))`` over the world, ``cart_sub((False, True))``
   from ranks 0 and 4; on each row (n = 4) ``allreduce_array`` at 4 and
   16 MB a rank launches K3 or K4 once, bit for bit with the plain
   versions; neighbor allgather and alltoall of every rank over card
   tensor tables (1 MB rows), in CUDA's sync-debug "error" mode (a host
   copy would raise), byte for byte and on the card; world rank 7 marked
   failed, ``shrink``: on the 7-rank comm the allreduces (K3, K4) and a
   16 MB ``bcast_array`` (K12) once each, bit for bit; a revoked dup's
   ``allreduce_array`` raises ``RevokedError`` and launches nothing, and
   the world's own ``allreduce_array`` launches what it did before the
   failure; the captured movers again, after the shrink; the host µs a
   call of ``allreduce_array`` with the revocation probe, of the parent's
   body without it and of its slot, in turns, and ``is_revoked``'s own
   cost (at most 1 µs or the phase fails).  Then three ``tpurun -n 4
   --enable-recovery`` jobs of card tensors where rank 1 stops: over sm
   (rank 0 first posts a 16 MB card-tensor send to it, which completes in
   error with its RGET exposure released, and rank 0's next 16 MB send
   works), across ``--fake-nodes 2`` (tcp between the nodes), and with the
   heartbeat detector (``ft_detector_period`` 0.2, ``ft_detector_timeout``
   1.5; rank 1 goes silent instead of exiting).  The survivors detect it,
   ``agree`` (``ProcFailedError``, then agreement after ``ack_failed``),
   shrink and allreduce a 1 MB card tensor with equal digests.  One
   ``{"topology_ft": {...}}`` line with the card's name and power limit,
   each job's detection latency, agree and shrink times by rank.
10. Sessions, process sets and dynamic processes (``sessions_dpm``), with
   coll/ring raised and the counts set to 0 before and read after: in the
   device world with no ``init``, ``Session.init()`` (its host ms with a
   cold and a warm instance), ``group_from_pset("mpi://WORLD")`` and
   ``Comm.create_from_group`` (host ms, a local CID), then on that comm
   and on a 4-row ``incl`` group's comm ``allreduce_array`` at 16 and 4 MB
   a rank launches K4 or K3 once each, bit for bit with the plain
   versions; ``create_intercomm_from_groups`` of the two halves
   (``is_inter``, the sizes, coll/inter's slot, ``free``); ``init()``
   joins the instance (refcount 2) and COMM_WORLD's allreduces launch the
   same kernels with the same bits (K3 ×3 and K4 ×3 in all); ``finalize``
   and the session's ``finalize`` in both orders, then a fresh boot.  Then
   four jobs of card tensors: ``tpurun -n 4 --pset app:0-1 --pset io:2-3
   --fake-nodes 2``, each rank on a Session with no ``init``: its pset list
   (names, members, sources; the CPU tests hold it against the JAX
   package's), ``create_from_group`` over the coordination service (host
   ms), a 16 MB allreduce on the ``app`` and ``io`` comms and on their
   intercomm (each side gets the other's sum; host ms), exact; a ``-n 2``
   parent spawning 2 children (spawn to join ms), a 4 MB parent-child
   ping-pong, the intercomm's 16 MB allreduce, ``merge`` (ms) and a 16 MB
   allreduce on the 4-rank merged comm with equal digests; ``-n 4``
   ``publish_name``/``lookup_name``, ``accept``/``connect``, a 4 MB send
   across, the intercomm's allreduce and ``merge``; a ``--enable-recovery``
   ``-n 3`` job whose rank 1 dies: revoke, shrink, spawn a replacement,
   merge (shrink, spawn and merge ms), a 1 MB allreduce with equal digests,
   and ``mpi://surviving``, ``mpi://shrunk/<cid>`` and ``mpi://job/job1``
   in the pset list.  One ``{"sessions_dpm": {...}}`` line with the card's
   name and power limit.
11. Train through failure (``train_through_failure``; no kernel is added):
   (a) the training path's checkpoint in the device world, on the
   training path's mesh and scale with the counts set to 0 before and
   read after: 2 steps, ``parallel.checkpoint.save`` of the parameters,
   ``load`` back onto the card (each leaf byte-equal to the saved one), 2
   more steps, beside 4 uninterrupted steps from the same start: the same
   launches (K21 ×16 each) and the losses within 1e-5; save and load ms.
   (b) ``tpurun -n 4 --enable-recovery --mca otpu_chaos_spec
   'kill:rank=2,step=7'`` of ``ElasticTrainer`` in respawn mode, its 2^20
   float64 parameters on the card, ``ELASTIC_STEPS`` (10) steps, a
   checkpoint every 5 through MPI-IO, a global batch of 24: width 4 at the
   end, the parameters bit for bit against ``reference_run`` from zeros
   over every step and from the restored checkpoint, the
   ``elastic_*`` phases in the merged trace, the killed rank's
   ``chaos-kill`` dump in the flight bundle; the recovery's phase ms.  (c)
   the same job across ``--fake-nodes 2`` with wire faults, seed ``SEED``:
   under ``drop:p=0.02;delay:ms=2,p=0.05;corrupt:p=0.01`` it finishes bit
   for bit with exit 0, or it fails loudly with an attributed crc error —
   never with other parameters; under ``drop:p=0.02;delay:ms=2,p=0.05``
   it must finish, exit 0, width 4, bit for bit, with (b)'s checks.  (d)
   a ``-n 4`` MPI-IO job of card tensors: a 64 MB dense float32 file
   written by ``write_at_all`` through 2 x 2 subarray views, read back
   collectively (bytes equal, and the dense file checked by rank 0), under
   ``io_ompio_fcoll`` static and then dynamic in one job, with two
   aggregators; write and read MB/s.  One ``{"train_through_failure": {...}}`` line with the
   card's name and power limit.
12. Message logging, partitioned communication and the MoE host trainer
   (``partitioned_logging``; no kernel is added): (a) in the device world
   ``Comm.pallreduce_init`` over gradient buckets of float32, 8 ranks wide,
   16, 16, 4 and 4 MB a rank, released late-first by ``pready``, two
   epochs (the second rebinding fresh buckets), on the default components
   and again with coll/ring raised, the counts set to 0 before and read
   after each: ``partitioned_coll`` is coll/builtin's both times and no
   ring kernel is launched; each bucket's result bit-equal to coll/builtin's
   one-shot ``allreduce_array`` and within the band of the float64 sum;
   ``parrived`` read (in CUDA's sync-debug "error" mode: it must not
   synchronize) before and after a ``torch.cuda.synchronize()``: False
   before it (the card still spins, so a ``parrived`` that did not query
   its bucket's event would show), True after it; the host µs of each ``pready`` beside its bucket's device ms
   (CUDA events, the card spinning while the host releases them).  (b)
   ``tpurun -n 3 --fake-nodes 2``: partitioned transfers of a 16 MB numpy
   buffer in 64 partitions from rank 0 over sm (to rank 1) and over tcp
   (to rank 2, the other node), with ``otpu_part_persist_min_partitions``
   1 and 8 in turns: MB/s and ``part_msgs``, every transfer bit for bit.
   (c) a ``tpurun -n 3`` job logging card tensors (256 KB each) with
   payloads over two communicators, rank 1 killed between its two
   receives of round 2, then every rank replayed from the logs: every
   rank's pml is ``ReplayPml`` and it consumed exactly the sends and
   receives of its log, and the final states are bit for bit against the
   recurrence.  (d) ``python -m
   ompi_tpu_torch.parallel.moe`` under ``tpurun -n 3 --enable-recovery
   --mca otpu_chaos_spec 'kill:rank=2,step=5'``, its expert table on the
   card: the two survivors re-shard the experts and end bit for bit on
   ``reference_moe_run`` from zeros over all 12 steps, and on it from the
   restored checkpoint.  One ``{"partitioned_logging": {...}}`` line
   with the card's name and power limit.
13. The multi-process device world and the launcher (``device_world_mp``;
   no kernel is added): (a) ``tpurun -n 2 --device-world --local-devices
   4`` on the card, every rank booting ``torch.distributed`` (gloo)
   through the instance.  In each rank, ``Session.init`` with no
   ``init()``, ``Group.from_session_pset(s, "mpi://WORLD")`` and
   ``Comm.create_from_group``, whose ``allreduce_array`` slot must be
   coll/builtin's cross-process module; then, on a 16 MB float32 card
   tensor a rank (16 MB of int32 for BAND), allreduce SUM, an allreduce
   through the gather-and-fold path (BAND on int32), ``bcast_array`` from
   root 1, ``allgather_array``, ``reduce_scatter_array`` and
   ``device_barrier``: each result on the card and bit for bit against the
   rank-order fold of both ranks' inputs, which every rank rebuilds from
   the seed, and each slot's ms (CUDA events around the call, median of
   10).  After the session's finalize, ``init()`` boots again (reusing the
   live process group) and each rank runs two steps of the flagship step
   at ``OTPU_MODEL_SCALE=64``, lr 1e-5, over the global mesh of 2 x 4
   ranks (dp spans the processes), with the launch counts set to 0 before
   and read after: K21 exactly 4 a step in each process, the losses
   descending and within 1e-5 relative of the single-process 8-rank
   step's (run here before the job, whose host ms are printed beside the
   job's), the free card memory before the step; then ``finalize``,
   ``init`` again (the same group) and an allreduce.  (b) ``tpurun
   --hostfile H --launch-agent local -n 4 --bind-to core --mca
   hook_comm_method_display 1`` over two emulated hosts of two slots
   each: an allreduce of a card tensor over the host tier, each rank's
   ``OTPU_NODE_ID`` and ``os.sched_getaffinity(0)`` (the ranks of a host
   must hold disjoint sets), and the ``[comm_method]`` matrix.  One
   ``{"device_world_mp": {...}}`` line with the card's name and power
   limit and the phase's wall seconds.
14. The serving engine (``serving``; no kernel is added, and none is
   launched: the toy model and the KV slabs are host numpy, as in the
   reference).  (a) In the card's device world (``ompi_tpu_torch.init()``),
   the router and its workers on threads over ``as_rank`` views, each run a
   seeded Poisson stream through ``PoissonDriver``: a colocated engine of 2
   workers; a staged prefill → decode pair, the receiver partitioned twice
   as finely as the sender, with ``kv_codec="int8"`` (the decode stage
   verifies every block within the codec's band and the phase counts the
   blocks it verified); and ``spec_k`` 0 then 4 on one seeded stream.  The
   launch counts set to 0 before and read after: none.  Every request
   delivered, every token ``toy_token``'s; requests, tokens/s, p50 and p99
   ms (the trace's log2 histograms) beside the exact p99, and the
   speculative accepted and rejected counts.  (b) ``tpurun -n 3
   --router-ranks 0 --worker-ranks 1,2`` running
   ``ompi_tpu_torch.examples.serving_demo`` on the card: its OK line, and
   every rank's ``roles()`` the flags' placement.  (c) ``tpurun -n 4
   --enable-recovery --mca otpu_chaos_spec
   'kill:rank=2,site=serve_work,count=2'``: rank 2 dies at its third
   micro-batch, the router shrinks, requeues and delivers all 24 requests
   (none dropped, none twice, every token exact), requeued > 0; the
   requeued count and the job's wall seconds.  One ``{"serving": {...}}``
   line with the card's name and power limit and the phase's wall seconds.
15. The serving fleet and the PGAS/tool surfaces (``fleet_pgas``; no kernel
   is added: the fleet, the symmetric heap, MPI_T and the debugger views
   compute on the host, as in the reference).  (a) In the card's device
   world, a ``FleetController`` with the colocated pools ``m_a`` = [1, 2]
   and ``m_b`` = [3, 4], its four workers on threads over ``as_rank``
   views: idle ticks retire a rank of each pool into the reserve, then two
   tenants weighted 2:1 send 48 requests under ``MixedPoissonDriver`` with
   prompts that share prefix templates, and a p99 SLO of 1e-4 ms
   re-enlists from the reserve.  Every request delivered with
   ``toy_token``'s tokens, worker-verified prefix hits > 0, a histogram
   family per tenant with its p50/p99, ``fleet_scale`` instants for the
   idle retirements and the enlists, the ``fleet`` telemetry source
   registered; the launch counts set to 0 before and read after: none.
   (d) Still in process: an MPI_T cvar write read back (source
   ``MPI_T``); a pvar session on ``otpu_runtime_spc_device_collectives``
   whose delta over 5 ``allreduce_array`` calls of card tensors is 5 (those
   calls launch the ring kernels; the line reports their launches apart);
   ``debugger.dump()`` listing the world and a dup, with a proc table of
   every rank naming the card.  (b) ``tpurun -n 5 --enable-recovery --pool
   m_a:1,2 --pool m_b:3,4 --mca otpu_telemetry_interval_ms 50``: rank 2
   chaos-killed at its third micro-batch under 24 + 16 requests, and the
   fleet ticked for 1 s after the last completion (the autoscaler's
   telemetry sample closes up to one interval after the completions it
   counts); none dropped, every token exact, requeued > 0, prefix hits > 0,
   and a p99-driven scale-up spawning ``python -m
   ompi_tpu_torch.serving.worker cuda`` into its pool, whose rank's
   ``device`` modex key names the card.
   (c) ``tpurun -n 4`` of a shmem job: put/get, the atomics, the
   collectives, a lock and a context checked on every PE against numpy,
   the heap a host ``uint8`` byte-addressed window, and the smoke readings
   µs of an 8 B ``p`` and ``g`` to the right neighbour and MB/s of a 4 MB
   ``put``.  One ``{"fleet_pgas": {...}}`` line with the card's name and
   power limit and the phase's wall seconds.
16. The operator tools against a live job (``tools``): one traced
   ``tpurun -n 3`` job of card tensors (``ompi_tpu_torch.examples.
   otpu_top_demo``'s worker for 4 s: each step folds the rank's 8 local
   1 MB shards with the ring all-reduce, K3, then allreduces 4 KB of the
   fold across the processes and swaps it with its ring neighbours; K4
   once, on 16 MB shards; telemetry every 150 ms; rank 2 paced 8 ms late
   a step by the chaos delay ``delay:ms=8,p=1,rank=2,site=step``), each
   rank's fold bit-equal to ``torch.sum`` and its K3/K4 launches counted;
   ``otpu_top --json --count 1`` attached from outside, polled until every
   rank shows a sample with a new sequence number; after the job
   ``otpu_analyze --critical-path --suggest-ladder`` over the merged
   timeline (rank 2 must be named as bound, and the draft rules must load
   through coll/tuned's ``_load_rules``); ``otpu_info --all --parsable``
   and ``otpu_perf --check`` over a history the phase writes from this
   run's kernel times (exit 0 each).  One ``{"tools": {...}}`` line.
17. The examples (``examples``, last): first ``init()`` on the card, where
   ``api.env.query_accelerator_support()`` must be true, and false after
   ``finalize()``; then all 16 of ``ompi_tpu_torch/examples/`` on the card
   as a user runs them, each to its success line, with coll/ring's vars at
   their defaults first.  In
   this process through ``main(argv)``, every count set to 0 before each
   and read after: ``hello``, ``connectivity``, ``ring``, ``serving_demo``
   and ``fleet_demo`` (no kernel), ``ragged_dispatch`` (K15 exactly twice),
   ``device_collectives`` (exactly K3, K12, K20 on its float32 ``ffma``
   body, K11 and K10 once and K5 twice, the torus's two phases),
   ``train_sharded --lr 1e-5`` (K21 exactly 2 x 4 + 2 x 6 on the FFMA body)
   and ``train_tour --lr 1e-5`` at ``OTPU_MODEL_SCALE=64`` on ``dp=2,pp=2,
   sp=2,tp=1`` (each of its six configurations two descending steps, K21
   exactly 12 a configuration, 24 under remat, on the FFMA body, or on
   the bfloat16 ``mma.sync`` body under bf16 and the works, as the C entry
   reports; after it, outside the counted run, each configuration's losses
   within 1e-5, bfloat16 1e-3, of the same steps with ``use_flash=False``,
   zero1's equal to the baseline's, and zero1 and the works a third step,
   where momentum reaches the loss, held also against the heavy ball added
   to the plain SGD step).  Beside them,
   three at a time as processes: ``ring`` and ``pgas_ring`` under
   ``tpurun -n 4``, ``partitioned_pingpong`` under ``-n 2``, ``trace_demo``
   under ``-n 4`` with tracing on, and the self-launching
   ``profile_demo``, ``moe_train_demo`` (rank 2 blamed),
   ``elastic_train_demo`` (bit-exact through a kill; the ranks on
   ``cuda:0``) and ``otpu_top_demo``.  One ``example <name>: <s> s`` line
   each and one ``{"examples": {...}}`` line.

The compile gate, ``python -m ompi_tpu_torch.tools.cuda_aot``, starts beside
the build and is waited for after the kernel checks (phase 2), before the
paths, whose host timings its compilers would disturb.  It compiles every
kernel instance of the five CUDA C++ libraries (``nvcc`` for sm_90a into a
temporary directory) and every Triton instance the port launches (each op
and dtype of K1 and K2, K17-K19).  Its ``cuda_aot`` line carries each CUDA C++ instance's
registers, shared memory, stack, spills and SASS counts, and the Triton
instances summed by kernel; the run fails unless every instance compiled,
K20's wgmma body has ``HGMMA``/``UTMALDG``, each of the byte mover's four
``mover_kernel`` instances has ``UBLKCP`` and no copy kernel spills, and
K21 has exactly four instances of each body: each float32
``flash_block_kernel`` has ``FFMA``, ``LDS.128`` and ``LDGSTS`` (the
``cp.async`` copies), each bfloat16 ``flash_block_mma_kernel`` has ``HMMA``
(``mma.sync``) and ``LDSM`` (``ldmatrix``), and none spills or touches
local memory.

The static analyzer (``analysis``; host only, no kernel) starts right after
the build, beside the gate, and is waited for with it: three subprocesses
at once, ``python -m ompi_tpu_torch.tools.otpu_lint ompi_tpu_torch/
--timings`` (exit 0, 8 passes, 0 findings, 0 unused baseline entries),
``python -m ompi_tpu_torch.analysis.scenarios`` (exit 0: each reverted race
fails with its replay string, each fixed twin passes in 14, 14 and 287
schedules) and ``python -m ompi_tpu_torch.tools.otpu_info --lint
--parsable`` (8 pass rows).  One ``{"analysis": {...}}`` line: the
findings, the suppressed count, the schedules, each pass's ms and each
subprocess's wall seconds.

Prints one JSON line per kernel, a ``{"phase_s": {...}}`` line with the
wall seconds of each part of the run, the ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``.  Needs one card; with none it exits 1
before printing anything.
"""
from __future__ import annotations

import concurrent.futures
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

MB = 1 << 20
N = 8                      # virtual ranks
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate
REPS, WARMUP = 25, 3
SPIN_CYCLES = 100_000_000  # ~50 ms of device spin before timed calls
HOST_CALLS = 200
SEED = 1234

#: per kernel: route, source, the TPU kernel it replaces (def line)
KERNELS = {
    "reduce_stack": ("triton", "ompi_tpu_torch/ops/reduce.py",
                     "ompi_tpu/ops/pallas_reduce.py:111"),
    "combine2": ("triton", "ompi_tpu_torch/ops/reduce.py",
                 "ompi_tpu/ops/pallas_reduce.py:82"),
    "all_reduce_fused": ("cuda", "ompi_tpu_torch/csrc/ring_fused.cu",
                         "ompi_tpu/ops/pallas_collectives.py:361"),
    "all_reduce_seg": ("cuda", "ompi_tpu_torch/csrc/ring_fused.cu",
                       "ompi_tpu/ops/pallas_collectives.py:674"),
    "reduce_scatter_fused": ("cuda", "ompi_tpu_torch/csrc/ring_fused.cu",
                             "ompi_tpu/ops/pallas_collectives.py:502"),
    "reduce_scatter_seg": ("cuda", "ompi_tpu_torch/csrc/ring_fused.cu",
                           "ompi_tpu/ops/pallas_collectives.py:744"),
    "all_gather": ("cuda", "ompi_tpu_torch/csrc/pair_copy.cuh",
                   "ompi_tpu/ops/pallas_collectives.py:177"),
    "bcast": ("cuda", "ompi_tpu_torch/csrc/ring_copy.cu",
              "ompi_tpu/ops/pallas_collectives.py:1294"),
    "right_permute": ("cuda", "ompi_tpu_torch/csrc/pair_copy.cuh",
                      "ompi_tpu/ops/pallas_collectives.py:141"),
    "all_to_all": ("cuda", "ompi_tpu_torch/csrc/pair_copy.cuh",
                   "ompi_tpu/ops/pallas_collectives.py:1050"),
    "all_to_all_v": ("cuda", "ompi_tpu_torch/csrc/pair_copy.cuh",
                     "ompi_tpu/ops/pallas_collectives.py:1105"),
    "all_gather_v": ("cuda", "ompi_tpu_torch/csrc/pair_copy.cuh",
                     "ompi_tpu/ops/pallas_collectives.py:1204"),
    "encode_int8": ("triton", "ompi_tpu_torch/ops/quant.py",
                    "ompi_tpu/ops/pallas_quant.py:77"),
    "dequant_accumulate": ("triton", "ompi_tpu_torch/ops/quant.py",
                           "ompi_tpu/ops/pallas_quant.py:106"),
    "decode_int8": ("triton", "ompi_tpu_torch/ops/quant.py",
                    "ompi_tpu/ops/pallas_quant.py:139"),
    "all_reduce_wire16": ("cuda", "ompi_tpu_torch/csrc/ring_fused.cu",
                          "ompi_tpu/ops/pallas_collectives.py:425"),
    "reduce_scatter_wire16": ("cuda", "ompi_tpu_torch/csrc/ring_fused.cu",
                              "ompi_tpu/ops/pallas_collectives.py:502"),
    "flash_block": ("cuda", "ompi_tpu_torch/csrc/flash_block.cu",
                    "ompi_tpu/ops/flash_attention.py:135"),
    "all_reduce_bidi": ("cuda", "ompi_tpu_torch/csrc/ring_fused.cu",
                        "ompi_tpu/ops/pallas_collectives.py:961"),
    "all_reduce_seg_bidi": ("cuda", "ompi_tpu_torch/csrc/ring_fused.cu",
                            "ompi_tpu/ops/pallas_collectives.py:850"),
    "all_gather_bidi": ("cuda", "ompi_tpu_torch/csrc/pair_copy.cuh",
                        "ompi_tpu/ops/pallas_collectives.py:226"),
    "matmul_allreduce": ("cuda", "ompi_tpu_torch/csrc/fused_matmul.cu",
                         "ompi_tpu/ops/pallas_overlap.py:57"),
    "matmul_reduce_scatter": ("cuda", "ompi_tpu_torch/csrc/fused_matmul.cu",
                              "ompi_tpu/ops/pallas_overlap.py:57"),
}
#: the kernels of the training path and of the MoE path; every other one
#: is on the collectives'
TRAINING_KERNELS = ("flash_block",)
MOE_KERNELS = ("matmul_allreduce", "matmul_reduce_scatter")
SEG = 512 * 1024 // 4      # seg_bytes (512k) in float32 elements

# the MoE dispatch slab: Mixtral-8x7B's expert layer (hidden 4096, 8
# experts, top-2), 4096 tokens per rank, capacity factor 1.25
HIDDEN, EXPERTS, TOP_K, TOKENS = 4096, 8, 2, 4096
CAPACITY = -(-5 * TOKENS * TOP_K // (4 * EXPERTS))    # ceil(1.25·T·k/E) = 1280
# K20 at Mixtral-8x7B's expert down projection: w2 (14336 -> 4096) split
# over the 8 ranks along its hidden units, applied to the expert's capacity
# buffer of 8 source ranks x CAPACITY rows: a (8, 10240, 1792), b (8, 1792,
# 4096); and 3 rows fewer, so the last block is padded
FFN = 14336
K20_M, K20_K = N * CAPACITY, FFN // N
K20_BANDS = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
# bfloat16 also within the schedule's roundings: each of the n partials and
# each fold rounds once, half an ulp (2^-8 relative) of at most max|C| each
K20_BF16_FOLD_BAND = (N + 1) * 2.0 ** -8
MOE_BUDGET = "0.02"
#: the redesigned kernels' times before the redesign: constants from
#: PERF.md's table (an H100 80GB HBM3 at 700 W), not measured by this script,
#: printed on their own ``earlier_ms`` line; K4, K6, K9 at 8 x 16 MB float32,
#: K20 at the Mixtral shape; the byte mover's kernels at their rows' shapes
#: and the torus all-gather, before the mover; K1, and K21 in float32 at
#: the step's shape before its re-blocked FFMA body and in bfloat16 at the
#: bench's and the step's shapes before its mma.sync body
EARLIER_MS = {"all_reduce_seg": 0.0792, "reduce_scatter_seg": 0.0793,
              "all_reduce_seg_bidi": 0.0812, "matmul_allreduce": 60.98,
              "matmul_reduce_scatter": 60.98, "matmul_allreduce_bf16": 7.604,
              "matmul_reduce_scatter_bf16": 7.605, "all_gather": 0.0996,
              "all_gather_bidi": 0.0995, "right_permute": 0.0990,
              "all_to_all": 0.1006, "all_to_all_v": 0.6780,
              "all_gather_v": 0.0922, "all_gather_torus": 0.0984,
              "reduce_stack": 0.0638, "flash_block": 0.2688,
              "flash_block_mma": 0.1139, "flash_block_bench": 4.260}
MOVER_SLOT, MOVER_SPAN = 16384, 32768   # the mover's slot and span, bytes
ROT = tuple((i, (i + 1) % N) for i in range(N))       # the +1 rotation
GENERAL = tuple((i, (i + 2) % N) for i in range(N - 1))   # rank 1: no source


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def launch_tables() -> tuple:
    from ompi_tpu_torch.ops import (flash_attention, overlap, quant, reduce,
                                    ring_collectives)

    return (reduce.launches, ring_collectives.launches, quant.launches,
            flash_attention.launches, overlap.launches)


def counts():
    return {k: v for table in launch_tables() for k, v in table.items()}


def reset_counts() -> None:
    for table in launch_tables():
        for k in table:
            table[k] = 0


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    if got.dtype == torch.bool:
        return float((got != want).sum().item())
    return float((got.double() - want.double()).abs().max().item())


def same_bits(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{what}: {tuple(got.shape)} {got.dtype} vs "
            f"{tuple(want.shape)} {want.dtype}")
    require(torch.equal(got, want),
            f"{what}: kernel differs from plain version, max abs err "
            f"{max_abs_err(got, want)}")


def same_bits_nan(got: torch.Tensor, want: torch.Tensor, what: str) -> bool:
    """Bit for bit outside NaN, and NaN at the same places (a NaN's payload
    carries no value); returns whether the NaN bits agree as well."""
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{what}: {tuple(got.shape)} {got.dtype} vs "
            f"{tuple(want.shape)} {want.dtype}")
    if not got.is_floating_point():
        same_bits(got, want, what)
        return True
    nan = torch.isnan(want)
    require(torch.equal(torch.isnan(got), nan), f"{what}: NaN at other places")
    same_bits(got[~nan], want[~nan], what)
    return torch.equal(got[nan].view(torch.int32), want[nan].view(torch.int32))


def same_bytes(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    """Byte-for-byte equality (NaN and -0.0 included): the copies' check."""
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{what}: {tuple(got.shape)} {got.dtype} vs "
            f"{tuple(want.shape)} {want.dtype}")
    require(torch.equal(got.view(torch.uint8), want.view(torch.uint8)),
            f"{what}: bytes differ from the plain version")


def valid_rows(out: torch.Tensor, counts) -> list:
    """The valid rows of a ragged result, pair by pair: ``out[j, i,
    :c[i, j]]`` for an (n, n) table, ``out[i, :c[i]]`` for an (n,) one, the
    counts clamped to [0, R]."""
    c = np.clip(np.asarray(counts), 0, out.shape[-2])
    if c.ndim == 2:
        return [out[j, i, :c[i, j]] for i in range(N) for j in range(N)]
    return [out[i, :c[i]] for i in range(N)]


def same_valid_bytes(got: torch.Tensor, want: torch.Tensor, counts,
                     what: str) -> None:
    """Byte-for-byte equality over the valid rows (the rest is
    unspecified)."""
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{what}: {tuple(got.shape)} {got.dtype} vs "
            f"{tuple(want.shape)} {want.dtype}")
    for g, w in zip(valid_rows(got, counts), valid_rows(want, counts)):
        require(torch.equal(g.view(torch.uint8), w.view(torch.uint8)),
                f"{what}: bytes of the valid rows differ")


def ragged_err(got: torch.Tensor, want: torch.Tensor, counts) -> float:
    return max((max_abs_err(g, w) for g, w in
                zip(valid_rows(got, counts), valid_rows(want, counts))
                if g.numel()), default=0.0)


def moe_counts() -> np.ndarray:
    """(n, n) rows rank i sends expert j (on rank j): each rank routes
    TOKENS tokens to TOP_K distinct experts, popularity skewed (Zipf,
    exponent 0.7) and sampled without replacement by Gumbel top-k; each
    count clamped to CAPACITY."""
    rng = np.random.default_rng(SEED)
    scores = (-0.7 * np.log(np.arange(1, EXPERTS + 1))
              + rng.gumbel(size=(N, TOKENS, EXPERTS)))
    top = np.argsort(-scores, axis=-1)[..., :TOP_K]
    sent = np.stack([np.bincount(t.ravel(), minlength=EXPERTS) for t in top])
    return np.minimum(sent, CAPACITY)


def moe_slab(gen) -> torch.Tensor:
    """The (8, 8, R, HIDDEN) float32 dispatch slab, 160 MB per rank."""
    return operands(torch.float32, (N, N, CAPACITY, HIDDEN), gen)


def permuted(x: torch.Tensor, perm) -> torch.Tensor:
    """lax.ppermute's result: out[d] = x[s], zeros where no pair lands."""
    want = torch.zeros_like(x)
    for s, d in perm:
        want[d] = x[s]
    return want


def rs_operands(per_rank: int, gen) -> torch.Tensor:
    """(n, n, S) float32 reduce-scatter input of ``per_rank`` bytes a rank."""
    return operands(torch.float32, (N, N, per_rank // 4 // N), gen)


def operands(dtype, shape, gen) -> torch.Tensor:
    if dtype == torch.bool:
        return torch.randint(0, 2, shape, device="cuda", generator=gen).bool()
    if not dtype.is_floating_point:
        return torch.randint(-40, 41, shape, device="cuda", generator=gen).to(dtype)
    # near 1, so PROD over 8 ranks stays finite and normal
    return 1.0 + 0.05 * torch.randn(shape, device="cuda", generator=gen, dtype=dtype)


# -- phase 2: kernels against their plain versions ----------------------

def check_kernels(gen) -> dict:
    from ompi_tpu_torch.ops import reduce
    from ompi_tpu_torch.ops import ring_collectives as rc

    err = {}
    elems = 16 * MB // 4
    for dtype in (torch.float32, torch.int32, torch.int8, torch.bool):
        a = operands(dtype, (elems,), gen)
        b = operands(dtype, (elems,), gen)
        x = operands(dtype, (N, elems), gen)
        for op in reduce.supported_ops():
            if reduce.device_fold(op, dtype) is None:
                continue
            same_bits(reduce.combine2(op, a, b), reduce.combine2_plain(op, a, b),
                      f"K2 combine2 {op} {dtype}")
            same_bits(reduce.reduce_stack(op, x), reduce.reduce_stack_plain(op, x),
                      f"K1 reduce_stack {op} {dtype}")
        del a, b, x
    log("K2 combine2: every op on float32/int32/int8/bool, 16 MB: bit-exact")
    log("K1 reduce_stack: k=8, every op on float32/int32/int8/bool, 16 MB "
        "slices: bit-exact")
    err["combine2"] = err["reduce_stack"] = 0.0
    for name, variant, per_rank in (("all_reduce_fused", "fused", 4 * MB),
                                    ("all_reduce_seg", "seg", 16 * MB)):
        x = operands(torch.float32, (N, per_rank // 4), gen)
        seg = SEG if variant == "seg" else None
        for op in ("sum", "max", "min", "prod"):
            plain = (rc.all_reduce_seg_plain(x, N, op, seg) if variant == "seg"
                     else rc.all_reduce_fused_plain(x, N, op))
            same_bits(rc.all_reduce(x, N, op, variant, seg), plain,
                      f"{name} {op} float32 {per_rank // MB} MB/rank")
        err[name] = 0.0
        log(f"{name}: float32 sum/max/min/prod at {per_rank // MB} MB per "
            "rank: bit-exact")
        del x
    for name, variant, per_rank in (("reduce_scatter_fused", "fused", 4 * MB),
                                    ("reduce_scatter_seg", "seg", 16 * MB)):
        x = rs_operands(per_rank, gen)
        seg = SEG if variant == "seg" else None
        for op in ("sum", "max", "min", "prod"):
            same_bits(rc.reduce_scatter(x, N, op, variant, seg),
                      rc.reduce_scatter_plain(x, N, op),
                      f"{name} {op} float32 {per_rank // MB} MB/rank")
        err[name] = 0.0
        log(f"{name}: float32 sum/max/min/prod on {tuple(x.shape)}, "
            f"{per_rank // MB} MB per rank: bit-exact")
        del x
    # ragged ring blocks: a 16-byte pack would straddle two blocks, so the
    # wrapper must take the element path (and the packed one for blocks of
    # whole packs)
    for dtype in (torch.float32, torch.float16):
        for payload in ((3, 5), (1001,), (1024,)):
            x = operands(dtype, (N, N, *payload), gen)
            for variant in ("fused", "seg"):
                for op in ("sum", "max", "min", "prod"):
                    same_bits(rc.reduce_scatter(x, N, op, variant),
                              rc.reduce_scatter_plain(x, N, op),
                              f"reduce_scatter {variant} {op} {dtype} S={payload}")
    log("reduce_scatter_fused/seg: ragged blocks S=(3, 5), (1001,) and "
        "(1024,), float32 and float16, every op: bit-exact")

    x = operands(torch.float32, (N, 16 * MB // 4), gen)
    same_bytes(rc.all_gather(x, N), rc.all_gather_plain(x, N),
               "all_gather float32 16 MB/rank")
    odd = operands(torch.int8, (N, 1001), gen)
    same_bytes(rc.all_gather(odd, N), rc.all_gather_plain(odd, N),
               "all_gather int8 1001 B/rank")
    skew = operands(torch.int8, (N * 1001 + 1,), gen)[1:].view(N, 1001)
    require(skew.data_ptr() % 16 != 0, "the skewed view is aligned")
    same_bytes(rc.all_gather(skew, N), rc.all_gather_plain(skew, N),
               "all_gather int8 unaligned")
    err["all_gather"] = 0.0
    log("all_gather: float32 16 MB per rank, int8 1001 B per rank, an "
        "unaligned int8 view: byte-exact")

    x[3, :4] = torch.tensor([-0.0, float("nan"), -0.0, float("-inf")],
                            device="cuda")
    for root in (0, 3, 7):
        same_bytes(rc.bcast(x, N, root), rc.bcast_plain(x, N, root),
                   f"bcast float32 16 MB/rank root {root}")
    require(bool(torch.signbit(rc.bcast(x, N, 3)[:, 0]).all()),
            "bcast lost root's -0.0")
    for dtype, per in ((torch.int32, 1000), (torch.int8, 1001),
                       (torch.bool, 37), (torch.bfloat16, 24)):
        y = operands(dtype, (N, per), gen)
        same_bytes(rc.bcast(y, N, 5), rc.bcast_plain(y, N, 5),
                   f"bcast {dtype} {per}")
    err["bcast"] = 0.0
    log("bcast: roots 0/3/7 float32 16 MB per rank (-0.0, NaN in root 3's "
        "row), int32, int8 of odd length, bool, bfloat16: byte-exact")

    same_bytes(rc.right_permute(x, N), rc.right_permute_plain(x, N),
               "right_permute float32 16 MB/rank")
    odd = operands(torch.float16, (N, 1001), gen)
    same_bytes(rc.right_permute(odd, N), rc.right_permute_plain(odd, N),
               "right_permute float16 1001/rank")
    skew = operands(torch.float16, (N * 1001 + 1,), gen)[1:].view(N, 1001)
    require(skew.data_ptr() % 16 != 0, "the skewed view is aligned")
    same_bytes(rc.right_permute(skew, N), rc.right_permute_plain(skew, N),
               "right_permute float16 unaligned")
    err["right_permute"] = 0.0
    log("right_permute: float32 16 MB per rank, float16 1001 per rank, an "
        "unaligned float16 view: byte-exact")
    del x

    for dtype, shape in ((torch.float32, (N, N, 524288)),
                         (torch.int8, (N, N, 1001)), (torch.bool, (N, N, 37))):
        a = operands(dtype, shape, gen)
        same_bytes(rc.all_to_all(a, N), rc.all_to_all_plain(a, N),
                   f"all_to_all {dtype} {shape}")
    err["all_to_all"] = 0.0
    log("all_to_all: (8, 8, 524288) float32 (16 MB per rank), int8 blocks of "
        "1001 bytes, bool: byte-exact")
    del a

    moe, routed = moe_slab(gen), moe_counts()
    edge = routed.copy()
    edge[0, :4] = (0, CAPACITY, CAPACITY + 5, -3)
    for what, x, table in (("MoE routing", moe, routed),
                           ("counts 0/R/R+5/-3", moe, edge),
                           ("int32 slab", moe.view(torch.int32), routed)):
        same_valid_bytes(rc.all_to_all_v(x, table, N),
                         rc.all_to_all_v_plain(x, table, N), table,
                         f"all_to_all_v {what}")
    del moe
    odd_r = operands(torch.float32, (N, N, 1001, 128), gen)
    table = np.minimum(routed, 1001)
    same_valid_bytes(rc.all_to_all_v(odd_r, table, N),
                     rc.all_to_all_v_plain(odd_r, table, N), table,
                     "all_to_all_v R = 1001")
    err["all_to_all_v"] = 0.0
    log(f"all_to_all_v: the MoE slab (8, 8, {CAPACITY}, {HIDDEN}) float32 with "
        f"its routing (valid share {routed.sum() / (N * N * CAPACITY):.3f}), "
        "counts 0/R/R+5/-3, the slab as int32, R = 1001: byte-exact over the "
        "valid rows")
    del odd_r

    y = operands(torch.float32, (N, CAPACITY, HIDDEN), gen)
    for what, x, table in (("routing", y, routed[0]),
                           ("counts 0 and R", y, [0, CAPACITY] * (N // 2)),
                           ("bfloat16", y.bfloat16(), routed[1])):
        same_valid_bytes(rc.all_gather_v(x, table, N),
                         rc.all_gather_v_plain(x, table, N), table,
                         f"all_gather_v {what}")
    err["all_gather_v"] = 0.0
    log(f"all_gather_v: (8, {CAPACITY}, {HIDDEN}) float32 with ragged counts, "
        "counts 0 and R, bfloat16: byte-exact over the valid rows")
    del y
    check_codec_kernels(gen, err)
    check_wire16_kernels(gen, err)
    check_flash_kernel(gen, err)
    check_duplex_kernels(gen, err)
    check_mover_edges(gen)
    check_torus(gen)
    check_fused_matmul(gen, err)
    torch.cuda.synchronize()
    return err


def codec_operands(k: int, size: int, gen) -> torch.Tensor:
    """(k, size) float32 on the card: normal values, and on ranks 0-3 an
    all-zero block, a block of exact .5 ties (amax 127, so 127/amax is 1),
    a block holding NaN and one holding +inf and -inf."""
    x = torch.randn((k, size), device="cuda", generator=gen)
    ties = torch.arange(128, device="cuda", dtype=torch.float32) - 63.5
    ties[0] = 127.0
    x[0, :128] = 0.0
    x[1 % k, 128:256] = ties
    x[2 % k, 256 + 17] = float("nan")
    x[3 % k, 384 + 3], x[3 % k, 384 + 90] = float("inf"), float("-inf")
    return x


def check_codec_kernels(gen, err: dict) -> None:
    """K17, K18 and K19 against their plain versions, bit for bit (NaN as
    NaN), with the special blocks of ``codec_operands``."""
    from ompi_tpu_torch.ops import quant as qo

    nan_bits = True
    for size in (16 * MB // 4, 70001):
        x = codec_operands(N, size, gen)
        q, s = qo.encode_int8(x)
        pq, ps = qo.encode_int8_plain(x)
        same_bits(q, pq, f"encode_int8 q, 8 x {size}")
        nan_bits &= same_bits_nan(s, ps, f"encode_int8 s, 8 x {size}")
        require(bool(torch.isnan(s[2, 2])) and bool(torch.isinf(s[3, 3]))
                and not bool(q[2, 2].any() or q[3, 3].any() or q[0, 0].any()),
                "encode_int8: the NaN, inf and zero blocks")
        require(q[1, 1, 60:68].tolist() == [-4, -2, -2, 0, 0, 2, 2, 4],
                "encode_int8: .5 ties are not rounded to even")
        nan_bits &= same_bits_nan(qo.decode_int8(q, s),
                                  qo.decode_int8_plain(q, s),
                                  f"decode_int8, 8 x {size}")
        for k in (2, 8):
            nan_bits &= same_bits_nan(
                qo.dequant_accumulate(q[:k], s[:k]),
                qo.dequant_accumulate_plain(q[:k], s[:k]),
                f"dequant_accumulate k={k}, {size}")
        del x, q, s, pq, ps
    err["encode_int8"] = err["dequant_accumulate"] = err["decode_int8"] = 0.0
    log("encode_int8/decode_int8/dequant_accumulate (k = 2, 8): 8 x 16 MB and "
        "8 x 70001 float32 with zero, .5-tie, NaN and inf blocks: bit-exact "
        f"(NaN at the same places; NaN bits {'equal' if nan_bits else 'differ'})")


def check_wire16_kernels(gen, err: dict) -> None:
    """K7 and K5's wire16 form against their plain versions, bit for bit."""
    from ompi_tpu_torch.ops import ring_collectives as rc

    for per in (4 * MB // 4, 23, 1000):
        x = operands(torch.float32, (N, per), gen)
        for op in ("sum", "max", "min", "prod"):
            same_bits(rc.all_reduce(x, N, op, "wire16"),
                      rc.all_reduce_wire16_plain(x, N, op),
                      f"all_reduce wire16 {op} 8 x {per}")
    for payload in ((131072,), (23,), (5, 200)):
        x = operands(torch.float32, (N, N, *payload), gen)
        for op in ("sum", "max"):
            same_bits(rc.reduce_scatter(x, N, op, "wire16"),
                      rc.reduce_scatter_wire16_plain(x, N, op),
                      f"reduce_scatter wire16 {op} S={payload}")
    err["all_reduce_wire16"] = err["reduce_scatter_wire16"] = 0.0
    log("all_reduce wire16 (K7): sum/max/min/prod at 4 MB, 23 and 1000 "
        "elements per rank; reduce_scatter wire16: sum/max on (8, 8, 131072), "
        "S = (23,) and (5, 200): bit-exact")


def check_duplex_kernels(gen, err: dict) -> None:
    """K8, K9 and K11 against their plain versions, bit for bit (K11 byte
    for byte)."""
    from ompi_tpu_torch.ops import ring_collectives as rc

    plain = {"bidi": rc.all_reduce_bidi_plain,
             "seg_bidi": rc.all_reduce_seg_bidi_plain}
    for variant, per_rank, seg in (("bidi", 4 * MB, None),
                                   ("seg_bidi", 16 * MB, SEG)):
        x = operands(torch.float32, (N, per_rank // 4), gen)
        for op in ("sum", "max", "min", "prod"):
            same_bits(rc.all_reduce(x, N, op, variant, seg),
                      plain[variant](x, N, op, *([seg] if seg else [])),
                      f"all_reduce {variant} {op} float32 {per_rank // MB} MB/rank")
        del x
    for dtype in (torch.float16, torch.float32, torch.float64):
        for per in (23, 407, 999):
            base = operands(dtype, (N * per + 1,), gen)
            for x in (base[:-1].view(N, per), base[1:].view(N, per)):
                for op in ("sum", "max", "min", "prod"):
                    for variant, seg in (("bidi", None), ("seg_bidi", 32)):
                        same_bits(rc.all_reduce(x, N, op, variant, seg),
                                  plain[variant](x, N, op, *([seg] if seg else [])),
                                  f"all_reduce {variant} {op} {dtype} 8 x {per} "
                                  f"(pointer % 16 = {x.data_ptr() % 16})")
    err["all_reduce_bidi"] = err["all_reduce_seg_bidi"] = 0.0
    log("all_reduce bidi (K8) at 4 MB and seg_bidi (K9) at 16 MB per rank, "
        "float32, every op; both on 23, 407 and 999 elements per rank, "
        "float16/32/64, every op, aligned and unaligned: bit-exact")
    x = operands(torch.float32, (N, 16 * MB // 4), gen)
    odd = operands(torch.int8, (N * 1001 + 1,), gen)
    five = operands(torch.float32, (5, 1001), gen)
    for what, t, n in (("float32 16 MB/rank", x, N),
                       ("int8 1001 B/rank", odd[:-1].view(N, 1001), N),
                       ("int8 unaligned", odd[1:].view(N, 1001), N),
                       ("n = 5 float32 1001/rank", five, 5)):
        same_bytes(rc.all_gather(t, n, "bidi"), rc.all_gather_plain(t, n),
                   f"all_gather bidi {what}")
    err["all_gather_bidi"] = 0.0
    log("all_gather bidi (K11): float32 16 MB per rank, int8 1001 B per rank "
        "aligned and not, n = 5: byte-exact")


def check_mover_edges(gen) -> None:
    """The byte mover (K10, K11, K13-K16) at the edges of its design against
    the plain versions, byte for byte (the ragged pair over its valid rows):
    K10 and K11 on payloads off 16 bytes, bool, n = 1, 2, 3, 5, 8, an empty
    payload and a stream of two spans a SM, each from a view at
    storage offset 1 too (the byte path); K10's entry on totals of 1, 15,
    16, 17 bytes, one slot and 16 bytes either side, aligned and at offset
    1, the bytes either side of the range untouched; K13 and K14 at odd
    sizes and 16-byte ones; K15 and K16 on the MoE slab with an all-zero
    table, an all-R one and one routing every row to expert 3, and at R = 5
    with a ragged table (counts 0, R, R + 3 and -1 forced in)."""
    from ompi_tpu_torch.ops import _build
    from ompi_tpu_torch.ops import ring_collectives as rc

    def offset_one(x):
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
        view = flat[1:].view(x.shape)
        view.copy_(x)
        return view

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype, shape in ((torch.float16, (N, 1001)), (torch.bool, (N, 37)),
                         (torch.float32, (1, 6)), (torch.int8, (2, 17)),
                         (torch.float32, (3, 1001)), (torch.int8, (5, 3)),
                         (torch.int8, (N, 2)), (torch.float32, (N, 0)),
                         (torch.float32, (N, sms * MOVER_SPAN // 16 + 12))):
        x = operands(dtype, shape, gen)
        for t in (x, offset_one(x)):
            for variant in ("ring", "bidi"):
                same_bytes(rc.all_gather(t, shape[0], variant),
                           rc.all_gather_plain(t, shape[0]),
                           f"all_gather {variant} {dtype} {shape} at offset "
                           f"{t.storage_offset()}")
    entry = _build.load("ring_copy").otpu_ring_all_gather
    stream = torch.cuda.current_stream().cuda_stream
    for nbytes in (1, 15, 16, 17, MOVER_SLOT - 16, MOVER_SLOT, MOVER_SLOT + 16):
        src = torch.randint(0, 256, (nbytes + 64,), dtype=torch.uint8,
                            device="cuda", generator=gen)
        for vec, at in ((16, 0), (1, 1)):
            out = torch.full_like(src, 0xAB)
            require(entry(src[at:].data_ptr(), out[at:].data_ptr(), nbytes, vec,
                          None, stream) == 0,
                    f"otpu_ring_all_gather {nbytes} B vec {vec}")
            require(torch.equal(out[at:at + nbytes], src[at:at + nbytes])
                    and bool((out[:at] == 0xAB).all())
                    and bool((out[at + nbytes:] == 0xAB).all()),
                    f"otpu_ring_all_gather {nbytes} B vec {vec}: bytes differ")
    for dtype, n, per in ((torch.float16, N, 1001), (torch.int8, 3, 17),
                          (torch.bool, 5, 3), (torch.float32, 2, 1),
                          (torch.int8, N, 4099), (torch.float32, N, 1024),
                          (torch.int8, 5, 48)):
        x = operands(dtype, (n, per), gen)
        same_bytes(rc.right_permute(x, n), rc.right_permute_plain(x, n),
                   f"right_permute {dtype} ({n}, {per})")
        y = operands(dtype, (n, n, per), gen)
        same_bytes(rc.all_to_all(y, n), rc.all_to_all_plain(y, n),
                   f"all_to_all {dtype} ({n}, {n}, {per})")
    one = np.zeros((N, N), np.int64)
    one[:, 3] = CAPACITY
    moe = moe_slab(gen)
    for what, table in (("all zero", np.zeros((N, N), np.int64)),
                        ("all R", np.full((N, N), CAPACITY)), ("one expert", one)):
        same_valid_bytes(rc.all_to_all_v(moe, table, N),
                         rc.all_to_all_v_plain(moe, table, N), table,
                         f"all_to_all_v MoE slab, {what}")
        same_valid_bytes(rc.all_gather_v(moe[0], table[0], N),
                         rc.all_gather_v_plain(moe[0], table[0], N), table[0],
                         f"all_gather_v MoE slab, {what}")
    del moe
    small = operands(torch.float32, (N, N, 5, 128), gen)
    table = np.random.default_rng(SEED).integers(-2, 9, (N, N))
    table.flat[:4] = (0, 5, 8, -1)
    same_valid_bytes(rc.all_to_all_v(small, table, N),
                     rc.all_to_all_v_plain(small, table, N), table,
                     "all_to_all_v R = 5, ragged")
    same_valid_bytes(rc.all_gather_v(small[0], table[0], N),
                     rc.all_gather_v_plain(small[0], table[0], N), table[0],
                     "all_gather_v R = 5, ragged")
    log("mover edges: K10/K11 on float16 (8, 1001), bool, n = 1, 2, 3, 5, 8, "
        "an empty payload and a stream over every SM, aligned and at offset 1; "
        "K10's entry on 1, 15, 16, 17 bytes and one slot +-16; K13/K14 at odd "
        "and 16-byte sizes; K15/K16 with all-zero, all-R, one-expert and ragged "
        "tables: byte-exact")


def check_torus(gen) -> None:
    """The torus schedules (a sub-ring launch of K5, then one of K3 or K5)
    against their plain composition, bit for bit, on (2, 4) and (4, 2)."""
    from ompi_tpu_torch.ops import ring_collectives as rc

    for n0, n1 in ((2, 4), (4, 2)):
        for dtype, per in ((torch.float32, 1000), (torch.float16, 1000),
                           (torch.float32, 4 * MB // 4)):
            x = operands(dtype, (n0, n1, per), gen)
            for op in ("sum", "max", "min", "prod"):
                same_bits(rc.all_reduce_torus(x, n0, n1, op),
                          rc.all_reduce_torus_plain(x, n0, n1, op),
                          f"all_reduce_torus ({n0}, {n1}) {op} {dtype} {per}")
            same_bytes(rc.all_gather_torus(x.view(N, per), n0, n1),
                       x.view(N, per), f"all_gather_torus ({n0}, {n1})")
        for dtype, per in ((torch.float32, 200), (torch.float16, 200),
                           (torch.float32, 131072)):
            y = operands(dtype, (N, N, per), gen)
            for op in ("sum", "max"):
                same_bits(rc.reduce_scatter_torus(y, n0, n1, op),
                          rc.reduce_scatter_torus_plain(y, n0, n1, op),
                          f"reduce_scatter_torus ({n0}, {n1}) {op} {dtype} {per}")
    log("torus schedules on (2, 4) and (4, 2): all_reduce_torus (float32 and "
        "float16 1000 per rank, float32 4 MB per rank, every op), "
        "reduce_scatter_torus (200 and 131072 per block, sum and max), "
        "all_gather_torus: bit-exact with the plain composition")


def k20_operands(dtype, m: int, kind: str, gen) -> tuple:
    """a (8, m, 1792) and b (8, 1792, 4096) on the card: integers in [-4, 4]
    (every float32 partial exact, |partial| <= 1792·16; past 256, so the
    bfloat16 partials and folds round), or normal values."""
    if kind == "int":
        a = torch.randint(-4, 5, (N, m, K20_K), device="cuda", generator=gen)
        b = torch.randint(-4, 5, (N, K20_K, HIDDEN), device="cuda", generator=gen)
    else:
        a = torch.randn((N, m, K20_K), device="cuda", generator=gen)
        b = torch.randn((N, K20_K, HIDDEN), device="cuda", generator=gen)
    return a.to(dtype), b.to(dtype)


def k20_scale(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest Σ|a||b| of an output element: the bands' unit."""
    return torch.einsum("nmk,nko->mo", a.abs().float(),
                        b.abs().float()).max().item()


def k20_band(want: torch.Tensor, scale: float, n: int = N) -> float:
    """K20's band around ``want`` over n ranks: K20_BANDS[dtype]·scale, and
    in bfloat16 no more than (n + 1)·2^-8·max|want| (K20_BF16_FOLD_BAND at
    n = 8)."""
    band = K20_BANDS[want.dtype] * scale
    if want.dtype == torch.bfloat16:
        fold = K20_BF16_FOLD_BAND * (n + 1) / (N + 1)
        band = min(band, fold * want.float().abs().max().item())
    return band


def check_k20_band(got, want, scale: float, what: str, n: int = N) -> tuple:
    """``got`` within :func:`k20_band` of ``want``, finite; returns the max
    abs error and the band."""
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{what}: {tuple(got.shape)} {got.dtype} vs "
            f"{tuple(want.shape)} {want.dtype}")
    require(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    e, band = max_abs_err(got, want), k20_band(want, scale, n)
    require(e <= band, f"{what}: max abs err {e} above the band {band}")
    return e, band


def body_delta(fn) -> tuple:
    """(fn's result, what it added to each of K20's body counts)."""
    from ompi_tpu_torch.ops import overlap

    before = dict(overlap.bodies)
    out = fn()
    return out, {k: v - before[k] for k, v in overlap.bodies.items()
                 if v != before[k]}


def k20_body(dtype) -> str:
    """The body K20 takes at the Mixtral shape."""
    return "ffma" if dtype == torch.float32 else "wgmma"


#: K20's edge shapes, (n, M, K/n, N) and the body bfloat16 takes there: a
#: 128-row tile crossing the block boundary on the TMA path (m_blk 126, K/n
#: not a multiple of the 64-deep k-tile, N not of the 256-wide tile), n = 2
#: and n = 5, and K/n, N off the multiples of 8
K20_EDGES = ((8, 1001, 200, 520, "wgmma"), (2, 777, 96, 264, "wgmma"),
             (5, 1001, 200, 520, "wgmma"), (8, 1001, 37, 203, "mma_sync"))


def check_fused_matmul(gen, err: dict) -> None:
    """K20 (both forms) against its plain version at the Mixtral expert
    shape and at M = 10237 (a padded last block), float32 and bfloat16:
    bit for bit on integer-valued inputs, on normal ones within 1e-5
    (float32) and 2^-7 (bfloat16) of the largest Σ|a||b|, and bfloat16
    within (n + 1)·2^-8 of max|C| as well; every launch at those shapes
    takes the ffma body (float32) or the wgmma body (bfloat16).  The same
    at the edge shapes of ``K20_EDGES``, each on the body it names.
    ``err`` gets each form's max abs error and, for bfloat16, its band
    (``<key>_band``)."""
    from ompi_tpu_torch.ops import overlap

    forms = {"matmul_allreduce": (overlap.matmul_allreduce,
                                  overlap.matmul_allreduce_plain),
             "matmul_reduce_scatter": (overlap.matmul_reduce_scatter,
                                       overlap.matmul_reduce_scatter_plain)}
    rel = {}
    for dtype in (torch.float32, torch.bfloat16):
        for m in (K20_M, K20_M - 3):
            for kind in ("int", "random"):
                a, b = k20_operands(dtype, m, kind, gen)
                scale = k20_scale(a, b) if kind == "random" else 0.0
                for name, (kernel, plain) in forms.items():
                    got, took = body_delta(lambda: kernel(a, b, N))
                    want = plain(a, b, N)
                    what = f"{name} {dtype} M={m} {kind}"
                    require(took == {k20_body(dtype): 1},
                            f"{what}: bodies {took}, want {k20_body(dtype)}")
                    if kind == "int":
                        same_bits(got, want, what)
                        continue
                    e, band = check_k20_band(got, want, scale, what)
                    key = name if dtype == torch.float32 else f"{name}_bf16"
                    err[key] = max(err.get(key, 0.0), e)
                    rel[key] = max(rel.get(key, 0.0), e / band)
                    if dtype == torch.bfloat16:
                        err[f"{key}_band"] = min(
                            err.get(f"{key}_band", math.inf), band)
                    del got, want
                del a, b
    edge_rel = {}
    for dtype in (torch.float32, torch.bfloat16):
        for n, m, k, nc, bf16_body in K20_EDGES:
            body = "ffma" if dtype == torch.float32 else bf16_body
            for kind in ("int", "random"):
                if kind == "int":
                    a, b = (torch.randint(-4, 5, shape, device="cuda",
                                          generator=gen).to(dtype)
                            for shape in ((n, m, k), (n, k, nc)))
                else:
                    a, b = (torch.randn(shape, device="cuda",
                                        generator=gen).to(dtype)
                            for shape in ((n, m, k), (n, k, nc)))
                for name, (kernel, plain) in forms.items():
                    got, took = body_delta(lambda: kernel(a, b, n))
                    want = plain(a, b, n)
                    what = (f"{name} {dtype} n={n} a ({n}, {m}, {k}) b ({n}, "
                            f"{k}, {nc}) {kind}")
                    require(took == {body: 1},
                            f"{what}: bodies {took}, want {body}")
                    if kind == "int":
                        same_bits(got, want, what)
                        continue
                    e, band = check_k20_band(got, want, k20_scale(a, b), what, n)
                    edge_rel[body] = max(edge_rel.get(body, 0.0), e / band)
    log(f"K20 matmul_allreduce/matmul_reduce_scatter: a (8, {K20_M}, {K20_K}) "
        f"and (8, {K20_M - 3}, {K20_K}), b (8, {K20_K}, {HIDDEN}), float32 "
        "(ffma) and bfloat16 (wgmma): bit-exact on integer inputs; on normal "
        "inputs max abs err over its band (float32: 1e-5 x the largest "
        "Σ|a||b|; bfloat16: the smaller of 2^-7 x that and (n + 1) x 2^-8 x "
        "max|C|) " + json.dumps(rel) + "; edge shapes (n, M, K/n, N) "
        + ", ".join(f"{e[:4]} {e[4]}" for e in K20_EDGES)
        + ": bit-exact on integers, by body " + json.dumps(edge_rel))


#: K21's bands against its plain version, relative to the largest finite
#: magnitude of each output (the tests' bands)
FLASH_BANDS = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -7}
#: the step's per-rank layout at OTPU_MODEL_SCALE=64 on the default mesh:
#: (dp, pp, sp, tp, b, h_local) = 32 rows, s_local 256, head dim 256
STEP_LEAD, STEP_S, STEP_D = (2, 1, 2, 2, 2, 2), 256, 256
#: the JAX package's bench shape of the flash block (bench.py:347):
#: (b, h, sq, skv, d) in bfloat16
BENCH_FLASH = (4, 8, 2048, 2048, 128)


def flash_close(got: tuple, want: tuple, dtype, what: str) -> tuple:
    """K21's (m, num, den) within its band of the plain version's: NaN at
    the same places, infinities equal; returns the largest absolute error
    over the finite values and the largest error relative to max |plain|
    of its output (what the band holds)."""
    worst = rel = 0.0
    for g, w, name in zip(got, want, ("m", "num", "den")):
        require(g.shape == w.shape and g.dtype == w.dtype,
                f"{what} {name}: {tuple(g.shape)} {g.dtype} vs "
                f"{tuple(w.shape)} {w.dtype}")
        g, w = g.float(), w.float()
        require(torch.equal(torch.isnan(g), torch.isnan(w)),
                f"{what} {name}: NaN at other places")
        inf = torch.isinf(w)
        require(torch.equal(g[inf], w[inf]), f"{what} {name}: infinities differ")
        fin = torch.isfinite(w)
        if not bool(fin.any()):
            continue
        err = (g[fin] - w[fin]).abs().max().item()
        scale = w[fin].abs().max().item()
        require(err <= FLASH_BANDS[dtype] * scale,
                f"{what} {name}: {err / scale:.3e} of max |plain| above the "
                f"band {FLASH_BANDS[dtype]:g}")
        worst, rel = max(worst, err), max(rel, err / scale)
    return worst, rel


def flash_state(lead, sq, d, dtype, m_inf: bool, gen):
    """(m, num, den): the first ring step's (-inf, 0, 0), or a running
    state (den > 0)."""
    if m_inf:
        return (torch.full((*lead, sq), -float("inf"), device="cuda",
                           dtype=dtype),
                torch.zeros((*lead, sq, d), device="cuda", dtype=dtype),
                torch.zeros((*lead, sq), device="cuda", dtype=dtype))
    return (torch.randn((*lead, sq), device="cuda", generator=gen).to(dtype),
            torch.randn((*lead, sq, d), device="cuda", generator=gen).to(dtype),
            torch.rand((*lead, sq), device="cuda", generator=gen).to(dtype) + 1)


def ring_bias(t: int, dtype) -> torch.Tensor:
    """Ring attention's causal bias at step t on the step's mesh: one
    (s_local, s_local) block per sp rank, prefix (1, 1, sp, 1) — step 0
    the diagonal, step 1 fully masked on sp rank 0 and fully visible on
    rank 1 (as ``parallel/model.py`` builds it)."""
    sp = STEP_LEAD[2]
    my = torch.arange(sp, device="cuda").reshape(1, 1, sp, 1, 1, 1)
    rows = torch.arange(STEP_S, device="cuda")
    src = torch.remainder(my - t + sp, sp)
    keep = my * STEP_S + rows[:, None] >= src * STEP_S + rows[None, :]
    return torch.where(keep, 0.0, -float("inf")).to(dtype)


def check_flash_kernel(gen, err: dict) -> None:
    """K21 against update_plain on the card: float32 and bfloat16, at the
    step's shape unbiased and with the per-rank causal bias, from m = -inf
    and chained; a fully masked block (K21 leaves the state as it was); a
    fully masked row at m = -inf (NaN); a ragged sq = 200; the JAX bench's
    shape in bfloat16.  Records (abs, rel) errors for the kernels-line row
    (float32 at the step's shape) and for the bench line."""
    from ompi_tpu_torch.ops import flash_attention as fa

    def rnd(*shape, dtype):
        return torch.randn(shape, device="cuda", generator=gen).to(dtype)

    def worse(a, b):
        return max(a[0], b[0]), max(a[1], b[1])

    step, step16, rest = (0.0, 0.0), (0.0, 0.0), (0.0, 0.0)
    for dtype in (torch.float32, torch.bfloat16):
        q = rnd(*STEP_LEAD, STEP_S, STEP_D, dtype=dtype)
        kv = [rnd(*STEP_LEAD, STEP_S, STEP_D, dtype=dtype) for _ in range(4)]
        for causal in (False, True):
            state = flash_state(STEP_LEAD, STEP_S, STEP_D, dtype, True, gen)
            for t in range(2):        # the two ring steps of sp = 2
                bias = ring_bias(t, dtype) if causal else None
                args = (q, kv[2 * t], kv[2 * t + 1], *state, bias)
                got = fa.update(*args)
                e = flash_close(got, fa.update_plain(*args), dtype,
                                f"K21 step shape {dtype} causal={causal} "
                                f"step {t}")
                if dtype == torch.float32:
                    step = worse(step, e)
                else:
                    step16 = worse(step16, e)
                if causal and t == 1:  # sp rank 0's second block: all masked
                    require(all(torch.equal(g[:, :, 0], s[:, :, 0])
                                for g, s in zip(got, state)),
                            f"K21 {dtype}: a fully masked block moved the "
                            f"state")
                state = fa.update_plain(*args)
        lead, sq = (2, 2), 64
        q, k, v = (rnd(*lead, sq, 32, dtype=dtype) for _ in range(3))
        masked = torch.zeros((sq, sq), device="cuda", dtype=dtype)
        masked[:16] = -float("inf")                 # rows 0-15 see nothing
        args = (q, k, v, *flash_state(lead, sq, 32, dtype, True, gen), masked)
        got = fa.update(*args)
        rest = worse(rest, flash_close(got, fa.update_plain(*args), dtype,
                                       f"K21 masked {dtype}"))
        require(bool(torch.isnan(got[1][..., :16, :]).all())
                and not bool(torch.isnan(got[1][..., 16:, :]).any()),
                "K21: a fully masked row at m = -inf must give NaN, others not")
        q = rnd(2, 2, 200, 64, dtype=dtype)
        k, v = (rnd(2, 2, 200, 64, dtype=dtype) for _ in range(2))
        args = (q, k, v, *flash_state((2, 2), 200, 64, dtype, False, gen))
        rest = worse(rest, flash_close(fa.update(*args), fa.update_plain(*args),
                                       dtype, f"K21 ragged sq=200 {dtype}"))
    b, h, sq, skv, d = BENCH_FLASH
    q = rnd(b, h, sq, d, dtype=torch.bfloat16)
    k, v = (rnd(b, h, skv, d, dtype=torch.bfloat16) for _ in range(2))
    args = (q, k, v, *flash_state((b, h), sq, d, torch.bfloat16, True, gen))
    bench = flash_close(fa.update(*args), fa.update_plain(*args),
                        torch.bfloat16, "K21 bench shape")
    rest = worse(rest, check_flash_edges(gen))
    err["flash_block"], err["flash_block_mma"] = step, step16
    err["flash_block_bench"] = bench
    log("flash_block (K21): float32 and bfloat16 at the step's shape (32 "
        "rows, 256 x 256, d 256) unbiased and per-rank causal, from m = -inf "
        "and chained (a fully masked block leaves K21's state bit-equal), a "
        "fully masked row at m = -inf (NaN at the same places), ragged sq = "
        f"200, the bench shape {BENCH_FLASH} bfloat16: within 1e-6 (f32) / "
        f"2^-7 (bf16) of max |plain|; (abs, rel) err float32 step shape "
        f"{step[0]:.3e}, {step[1]:.3e}, bfloat16 {step16[0]:.3e}, "
        f"{step16[1]:.3e}; bench {bench[0]:.3e}, "
        f"{bench[1]:.3e}; other cases {rest[0]:.3e}, {rest[1]:.3e}")


#: K21's edge shapes: head dims (off 4 elements: 30, 66, 130; off 16 bytes
#: in bfloat16: 100, 200; one and two column groups) at sq = 200 with 100
#: keys and with 1055; key counts at d = 256 around a 64-key tile, at and
#: past the scores-on-chip cap (320 keys at d = 256 in float32) and past
#: every cap.  Up to 320 keys the block's scores stay on chip at every d and
#: dtype; at 1024 and more they fit at none (64 x skv floats alone are above
#: the 227 KB a CTA may have), so q k^T is recomputed
FLASH_EDGE_D = (30, 32, 64, 66, 100, 128, 130, 200, 256)
FLASH_EDGE_SKV = (1, 31, 64, 255, 256, 257, 320, 321, 1024, 1055)
FLASH_SCORES_SKV, FLASH_RECOMPUTE_SKV = 256, 1055
#: the edges of the bfloat16 body's m16n8k16 fragments: queries one short
#: of, at and one past a 16-row m-tile; keys about an 8-key n-tile and a
#: 16-key k-step; head dims of one, two and three k-steps (8 and 24 not a
#: multiple of 16: the fragment's tail zero-filled) and past d = 128 (two
#: warps a row group: 136, 248 off a k-step)
FLASH_FRAG_SQ, FLASH_FRAG_SKV = (15, 16, 17), (7, 8, 9, 15, 17)
FLASH_FRAG_D = (8, 16, 24, 136, 248)


def check_flash_edges(gen) -> tuple:
    """K21 at its edges, float32 and bfloat16, with and without a per-rank
    causal bias, in the second-pass form each shape takes; a fully masked
    block chained (the state bit-equal) and a fully masked row from m =
    -inf (NaN), and q, k, v from storage offset 1 (the element path), each
    with the scores on chip and recomputed.  Returns the worst (abs, rel)
    error."""
    from ompi_tpu_torch.ops import flash_attention as fa

    worst = (0.0, 0.0)

    def run(args, what):
        nonlocal worst
        got = fa.update(*args)
        e = flash_close(got, fa.update_plain(*args), args[0].dtype,
                        f"K21 {what}")
        worst = max(worst[0], e[0]), max(worst[1], e[1])
        return got

    def rnd(*shape, dtype):
        return torch.randn(shape, device="cuda", generator=gen).to(dtype)

    def causal(lead0, sq, skv, dtype):
        keep = (torch.arange(sq, device="cuda")[:, None] + 4 *
                torch.arange(lead0, device="cuda")[:, None, None]
                >= torch.arange(skv, device="cuda")[None, :])
        return torch.where(keep, 0.0, -float("inf")).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        cases = [(d, 200, skv) for d in FLASH_EDGE_D
                 for skv in (100, FLASH_RECOMPUTE_SKV)] + \
                [(256, 64, skv) for skv in FLASH_EDGE_SKV]
        for d, sq, skv in cases:
            q = rnd(2, 2, sq, d, dtype=dtype)
            k, v = (rnd(2, 2, skv, d, dtype=dtype) for _ in range(2))
            state = flash_state((2, 2), sq, d, dtype, False, gen)
            for bias in (None, causal(2, sq, skv, dtype)):
                run((q, k, v, *state, bias), f"{dtype} d={d} sq={sq} "
                    f"skv={skv} bias={bias is not None}")
        d, sq = 256, 64
        for skv in (FLASH_SCORES_SKV, FLASH_RECOMPUTE_SKV):
            q = rnd(2, 2, sq, d, dtype=dtype)
            k, v = (rnd(2, 2, skv, d, dtype=dtype) for _ in range(2))
            masked = torch.full((sq, skv), -float("inf"), device="cuda",
                                dtype=dtype)
            half = torch.zeros((sq, skv), device="cuda", dtype=dtype)
            half[:16] = -float("inf")
            state = flash_state((2, 2), sq, d, dtype, False, gen)
            got = run((q, k, v, *state, masked), f"{dtype} skv={skv} masked "
                      "block")
            require(all(torch.equal(g, w) for g, w in zip(got, state)),
                    f"K21 {dtype} skv={skv}: a fully masked block moved the "
                    "state")
            got = run((q, k, v, *flash_state((2, 2), sq, d, dtype, True, gen),
                       half), f"{dtype} skv={skv} masked rows")
            require(bool(torch.isnan(got[1][..., :16, :]).all())
                    and not bool(torch.isnan(got[1][..., 16:, :]).any()),
                    f"K21 {dtype} skv={skv}: a fully masked row at m = -inf "
                    "must give NaN, others not")
        for d in (256, 100):
            for skv in (FLASH_SCORES_SKV, FLASH_RECOMPUTE_SKV):
                views = []
                for n in (sq, skv, skv):
                    buf = torch.randn(2 * 2 * n * d + 1, device="cuda",
                                      generator=gen).to(dtype)
                    views.append(buf[1:].view(2, 2, n, d))
                state = flash_state((2, 2), sq, d, dtype, False, gen)
                run((*views, *state, None), f"{dtype} d={d} skv={skv} "
                    "offset 1")
        for d in FLASH_FRAG_D:
            for sq in FLASH_FRAG_SQ:
                for skv in FLASH_FRAG_SKV:
                    q = rnd(2, 2, sq, d, dtype=dtype)
                    k, v = (rnd(2, 2, skv, d, dtype=dtype) for _ in range(2))
                    state = flash_state((2, 2), sq, d, dtype, False, gen)
                    for bias in (None, causal(2, sq, skv, dtype)):
                        run((q, k, v, *state, bias), f"{dtype} fragment d={d} "
                            f"sq={sq} skv={skv} bias={bias is not None}")
        for d in (64, 256):
            for skv in (64, FLASH_RECOMPUTE_SKV):
                q = rnd(2, 2, 64, d, dtype=dtype)
                k, v = (rnd(2, 2, skv, d, dtype=dtype) for _ in range(2))
                for bias in fragment_masks(64, skv, dtype):
                    for m_inf in (False, True):
                        state = flash_state((2, 2), 64, d, dtype, m_inf, gen)
                        got = run((q, k, v, *state, bias), f"{dtype} fragment "
                                  f"mask d={d} skv={skv} m_inf={m_inf}")
                        require(not any(bool(torch.isnan(g).any()) for g in got),
                                f"K21 {dtype} d={d} skv={skv}: a row with a "
                                "finite score gave NaN")
    f32_digests_equal()
    log(f"flash_block (K21) edges: d {FLASH_EDGE_D} (sq 200, skv 100 and "
        f"{FLASH_RECOMPUTE_SKV}), skv {FLASH_EDGE_SKV} (d 256), with and "
        "without a per-rank causal bias; masked blocks and rows and offset-1 "
        f"views at skv {FLASH_SCORES_SKV} and {FLASH_RECOMPUTE_SKV}; the "
        f"fragment edges sq {FLASH_FRAG_SQ} x skv {FLASH_FRAG_SKV} x d "
        f"{FLASH_FRAG_D} with and without the causal bias, and at d 64 and "
        f"256, skv 64 and {FLASH_RECOMPUTE_SKV}, a bias masking one 8-key "
        "column of every fragment and one leaving each row a single finite "
        "score, from a running state and from m = -inf: float32 and bfloat16 "
        "within their bands; the float32 body's outputs bit-equal to its "
        "recorded digests")
    return worst


def fragment_masks(sq: int, skv: int, dtype) -> list:
    """Biases aimed at the bfloat16 body's fragments: -inf over one 8-key
    column (keys 8 to 15 of every 64-key tile: one lane quad's n-tile), and
    -inf over every key but one a row, that key chosen so that one lane of
    its quad holds the row's only finite score (key 2 (i % 4) + 8 (i % 8)
    of the tile 64 (i % n) for query i, over the n tiles)."""
    keys = torch.arange(skv, device="cuda")
    column = torch.zeros((sq, skv), device="cuda")
    column[:, (keys % 64 >= 8) & (keys % 64 < 16)] = -float("inf")
    rows = torch.arange(sq, device="cuda")
    tiles = (skv + 63) // 64
    one = (2 * (rows % 4) + 8 * (rows % 8) + 64 * (rows % tiles)).clamp(max=skv - 1)
    single = torch.full((sq, skv), -float("inf"), device="cuda")
    single[rows, one] = 0.0
    return [column.to(dtype), single.to(dtype)]


def f32_digests_equal() -> None:
    """K21's float32 outputs bit-equal to the float32 body's recorded ones
    (``chip_flash_bodies.FLOAT32_DIGESTS``)."""
    import chip_flash_bodies as bodies
    from ompi_tpu_torch.ops import flash_attention as fa

    got = bodies.float32_digests(fa)
    require(got == bodies.FLOAT32_DIGESTS, f"K21 float32 outputs moved: {got}")


# -- phase 3: the main path ---------------------------------------------

def sum_tolerance(x: torch.Tensor) -> torch.Tensor:
    """|a - b| allowed between two float32 sums of the n rank rows taken in
    different orders: each order is within (n-1)·u·Σ|x_i| of the exact sum
    (u = 2**-24), so they differ by at most 2(n-1)·u·Σ|x_i|."""
    return 2 * (N - 1) * 2.0 ** -24 * x.abs().sum(0)


def check_sum(out, x, plain, what):
    same_bits(out, plain, f"{what} vs plain version")
    lib = torch.sum(x, 0)
    bad = ((out - lib).abs() > sum_tolerance(x)).sum().item()
    require(bad == 0, f"{what}: {bad} elements outside the torch.sum band")
    require(bool(torch.isfinite(out).all()), f"{what}: non-finite values")


def owner(world, slot: str) -> str:
    return type(world.c_coll[slot].__self__).__name__


def main_path(gen) -> dict:
    import ompi_tpu_torch
    from ompi_tpu_torch.ops import reduce
    from ompi_tpu_torch.ops import ring_collectives as rc
    from ompi_tpu_torch.runtime import init as rt

    big = operands(torch.float32, (N, 16 * MB // 4), gen)       # 16 MB/rank
    mid = operands(torch.float32, (N, 4 * MB // 4), gen)        # 4 MB/rank
    ints = operands(torch.int32, (N, 16 * MB // 4), gen)
    inbuf = operands(torch.float32, (16 * MB // 4,), gen)
    inout = operands(torch.float32, (16 * MB // 4,), gen)
    inout_plain = reduce.combine2_plain("SUM", inbuf, inout)
    rs_mid = rs_operands(4 * MB, gen)                            # 4 MB/rank
    rs_big = rs_operands(16 * MB, gen)                           # 16 MB/rank
    a2a = operands(torch.float32, (N, N, 524288), gen)            # 16 MB/rank
    moe, routed = moe_slab(gen), moe_counts()
    agv = operands(torch.float32, (N, CAPACITY, HIDDEN), gen)
    agv_counts = routed[0]
    new_slots = ("bcast_array", "allgather_array", "reduce_scatter_array",
                 "alltoall_array", "alltoallv_array", "allgatherv_array",
                 "ppermute_array")
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    world = ompi_tpu_torch.init()
    require(world.size == N and world.rte.device.type == "cuda",
            f"world of {world.size} on {world.rte.device}")
    for slot in ("allreduce_array", *new_slots):
        require(owner(world, slot) == "BuiltinCollModule",
                f"default owner of {slot} is not coll/builtin")
    s_builtin = world.allreduce_array(big, ompi_tpu_torch.SUM)
    p_prod = world.allreduce_array(big, ompi_tpu_torch.PROD)
    p_band = world.allreduce_array(ints, ompi_tpu_torch.BAND)
    b_builtin = world.bcast_array(big, 3)
    g_builtin = world.allgather_array(big)
    rs_builtin = world.reduce_scatter_array(rs_mid, ompi_tpu_torch.SUM)
    k1_before = reduce.launches["reduce_stack"]
    rs_prod = world.reduce_scatter_array(rs_mid, ompi_tpu_torch.PROD)
    k1_rs = reduce.launches["reduce_stack"] - k1_before
    ompi_tpu_torch.reduce_local(inbuf, inout, ompi_tpu_torch.SUM)
    exchange = {"builtin": exchange_calls(world, big, a2a, moe, routed, agv,
                                          agv_counts)}
    codec = codec_calls(world, big)
    rt.finalize()

    os.environ["OTPU_MCA_coll_ring_priority"] = "95"
    world = ompi_tpu_torch.init()
    for slot in ("allreduce_array", *new_slots):
        require(owner(world, slot) == "RingCollModule",
                f"raised owner of {slot} is not coll/ring")
    s_fused = world.allreduce_array(mid, ompi_tpu_torch.SUM)
    s_seg = world.allreduce_array(big, ompi_tpu_torch.SUM)
    b_ring = world.bcast_array(big, 3)
    g_ring = world.allgather_array(big)
    rs_fused = world.reduce_scatter_array(rs_mid, ompi_tpu_torch.SUM)
    rs_seg = world.reduce_scatter_array(rs_big, ompi_tpu_torch.SUM)
    exchange["ring"] = exchange_calls(world, big, a2a, moe, routed, agv,
                                      agv_counts)
    rt.finalize()

    os.environ["OTPU_MCA_coll_ring_wire16"] = "1"
    world = ompi_tpu_torch.init()
    wire = wire16_calls(world, mid, big, rs_mid)
    rt.finalize()

    # an unset variable leaves a var as it was: wire16 is turned off by value
    os.environ["OTPU_MCA_coll_ring_wire16"] = "0"
    os.environ["OTPU_MCA_coll_ring_bidirectional"] = "1"
    world = ompi_tpu_torch.init()
    duplex = duplex_calls(world, mid, big, rs_mid, rs_big)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    rt.finalize()
    for name in ("priority", "wire16", "bidirectional"):
        del os.environ[f"OTPU_MCA_coll_ring_{name}"]

    log(f"main path: 4 x init, 2 x dup, 12 allreduce_array, 2 bcast_array, "
        f"5 allgather_array, 7 reduce_scatter_array, reduce_local, 2 x "
        f"(alltoall_array, alltoallv_array, allgatherv_array, 2 "
        f"ppermute_array), allreduce_array_init and 2 calls of its handle in "
        f"{wall:.3f} s (host clock, includes the first-call builds); "
        f"launches {launched}")
    for name in KERNELS:
        if name not in TRAINING_KERNELS + MOE_KERNELS:
            require(launched[name] > 0, f"{name} was not launched on the main path")
    require(k1_rs > 0, "reduce_scatter_array PROD did not launch K1")

    require(torch.equal(s_builtin, torch.sum(big, 0)), "builtin SUM")
    same_bits(p_prod, reduce.reduce_stack_plain("PROD", big), "PROD (K1)")
    same_bits(p_band, reduce.reduce_stack_plain("BAND", ints), "BAND (K1)")
    same_bits(inout, inout_plain, "reduce_local SUM (K2)")
    check_sum(s_fused, mid, rc.all_reduce_fused_plain(mid, N, "sum"),
              "ring SUM 4 MB/rank (K3)")
    check_sum(s_seg, big, rc.all_reduce_seg_plain(big, N, "sum", SEG),
              "ring SUM 16 MB/rank (K4)")
    row3 = rc.bcast_plain(big, N, 3)
    same_bytes(b_builtin, row3, "builtin bcast root 3")
    same_bytes(g_builtin, big, "builtin allgather")
    require(torch.equal(rs_builtin, torch.sum(rs_mid, 0)),
            "builtin reduce_scatter SUM")
    same_bits(rs_prod, reduce.reduce_stack_plain("PROD", rs_mid),
              "builtin reduce_scatter PROD (K1)")
    same_bytes(b_ring, row3, "ring bcast root 3 (K12)")
    same_bytes(g_ring, big, "ring allgather (K10)")
    check_sum(rs_fused, rs_mid, rc.reduce_scatter_plain(rs_mid, N, "sum"),
              "ring reduce_scatter SUM 4 MB/rank (K5)")
    check_sum(rs_seg, rs_big, rc.reduce_scatter_plain(rs_big, N, "sum"),
              "ring reduce_scatter SUM 16 MB/rank (K6)")
    require(exchange["ring"]["k13_general"] == 0,
            "the general perm launched K13 (it must go to coll/builtin)")
    plain = {"alltoall": rc.all_to_all_plain(a2a, N),
             "rotation": rc.right_permute_plain(big, N),
             "general": permuted(big, GENERAL)}
    require(not bool(plain["general"][1].any()), "rank 1 received data")
    want_v = rc.all_to_all_v_plain(moe, routed, N)
    for module, got in exchange.items():
        for name, want in plain.items():
            same_bytes(got[name], want, f"{module} {name}")
        for i in range(N):
            require(got["allgatherv"][i].shape[0] == agv_counts[i],
                    f"{module} allgatherv view {i}")
            same_bytes(got["allgatherv"][i], agv[i, :agv_counts[i]],
                       f"{module} allgatherv view {i}")
            for j in range(N):
                require(got["alltoallv"][i][j].shape[0] == routed[j, i],
                        f"{module} alltoallv view ({i}, {j})")
                same_bytes(got["alltoallv"][i][j], want_v[i, j, :routed[j, i]],
                           f"{module} alltoallv view ({i}, {j})")
    log("main path results: bit-exact with the plain versions (copies byte "
        "for byte, the ragged calls' views over their valid rows); ring SUM "
        "within 2(n-1)·2^-24·Σ|x| of torch.sum; the general perm's rank 1 "
        "holds zeros and left K13's count unchanged")
    check_codec_results(codec, big)
    check_wire16_results(wire, mid, big, rs_mid)
    check_duplex_results(duplex, mid, big, rs_mid, rs_big)
    return launched


# -- phase 3b: the device-world communicator ------------------------------

COMM_ROOT = 3
#: the split of the sub-comm cases: sizes 3, 3 and 2
SUB_SPLIT = [0, 0, 0, 1, 1, 1, 2, 2]
#: rounds of the capture cases past the pool's 1024 slots, and paired replays
CAPTURE_ROUNDS = 16
CAPTURE_PAIRS = 16
#: calls of a new slot in its host time: a scan launches ~20 kernels, and
#: more calls than the card's launch queue holds (~1024 launches) would
#: make the host wait for the card, so that the host time became its time
HOST_SLOT_CALLS = 20


def slot_calls(world, x, z) -> dict:
    """The new device slots on the world: reduce_array (SUM, PROD, MAX at
    root COMM_ROOT) on ``x``, gather_array, scan_array and exscan_array
    on ``x`` and scatter_array on ``z``; each reduce's launch delta."""
    import ompi_tpu_torch

    got, deltas = {}, {}
    for op in ("SUM", "PROD", "MAX"):
        got[f"reduce_{op}"], deltas[op] = launch_delta(
            lambda: world.reduce_array(x, getattr(ompi_tpu_torch, op),
                                       COMM_ROOT))
    got["gather"] = world.gather_array(x, COMM_ROOT)
    got["scatter"] = world.scatter_array(z, COMM_ROOT)
    got["scan"] = world.scan_array(x)
    got["exscan"] = world.exscan_array(x)
    return got, deltas


def tree_plain(op: str, x: torch.Tensor, root: int) -> torch.Tensor:
    """reduce_array's binomial tree with K2's plain version for the fold."""
    from ompi_tpu_torch.mca.coll.builtin import tree_rounds
    from ompi_tpu_torch.ops import reduce

    n = x.shape[0]
    buf = x.roll(-root, 0)
    for k in tree_rounds(n):
        m = buf.shape[0] - k
        head = reduce.combine2_plain(op, buf[:m], buf[k:k + m])
        buf = head if m == k else torch.cat([head, buf[m:k]])
    out = torch.zeros_like(x)
    out[root] = buf[0]
    return out


def check_slots(got: dict, x, z, what: str) -> None:
    """The new slots' results on the card: reduce against the tree with
    K2's plain version (bit for bit; SUM also within the torch.sum band,
    MAX equal to amax), gather and scatter byte for byte, scan within the
    cumsum band and exscan its shift, every row outside root's zero."""
    others = torch.arange(N, device=x.device) != COMM_ROOT
    for op in ("SUM", "PROD", "MAX"):
        out = got[f"reduce_{op}"]
        same_bits(out, tree_plain(op, x, COMM_ROOT), f"{what} reduce {op}")
        require(not bool(out[others].any()), f"{what} reduce {op}: rows")
        require(bool(torch.isfinite(out).all()), f"{what} reduce {op}: finite")
    lib = torch.sum(x, 0)
    require(bool(((got["reduce_SUM"][COMM_ROOT] - lib).abs()
                  <= sum_tolerance(x)).all()), f"{what} reduce SUM band")
    same_bits(got["reduce_MAX"][COMM_ROOT], x.amax(0), f"{what} reduce MAX")
    gather = got["gather"]
    require(tuple(gather.shape) == (N, *x.shape), f"{what} gather shape")
    same_bytes(gather[COMM_ROOT], x, f"{what} gather root row")
    require(not bool(gather[others].any()), f"{what} gather: rows")
    same_bytes(got["scatter"], z[COMM_ROOT], f"{what} scatter")
    band = 2 * (N - 1) * 2.0 ** -24 * x.abs().cumsum(0)
    require(bool(((got["scan"] - torch.cumsum(x, 0)).abs() <= band).all()),
            f"{what} scan: outside the cumsum band")
    ex = got["exscan"]
    require(not bool(ex[0].any()), f"{what} exscan row 0")
    same_bits(ex[1:], got["scan"][:-1], f"{what} exscan")


def subcomm_calls(world, gen) -> list:
    """coll/ring raised: allreduce, reduce_scatter, allgather and bcast at 4
    and 16 MB per rank on create([0, 2, 4, 6]) and on the split into sizes
    3, 3 and 2, each launching its kernel once with the sub-comm's n and
    bit-exact (copies byte for byte) with the plain version on the member
    rows."""
    from ompi_tpu_torch.ops import ring_collectives as rc

    subs = {"create [0, 2, 4, 6]": world.create(world.group.incl([0, 2, 4, 6]))}
    for first in (0, 3, 6):
        sub = world.as_rank(first).split(SUB_SPLIT)
        subs[f"split {list(sub.group.world_ranks)}"] = sub
    done = []
    for name, sub in subs.items():
        n = sub.size
        require(owner(sub, "allreduce_array") == "RingCollModule",
                f"{name}: ring not raised")
        for mb, regime in ((4, "fused"), (16, "seg")):
            x = operands(torch.float32, (n, mb * MB // 4), gen)
            z = operands(torch.float32, (n, n, mb * MB // 4 // n), gen)
            plain = {"allreduce": (rc.all_reduce_fused_plain(x, n, "sum")
                                   if regime == "fused" else
                                   rc.all_reduce_seg_plain(x, n, "sum", SEG)),
                     "reduce_scatter": rc.reduce_scatter_plain(z, n, "sum"),
                     "bcast": rc.bcast_plain(x, n, n - 1)}
            for call, key, fn in (
                    ("allreduce", f"all_reduce_{regime}",
                     lambda: sub.allreduce_array(x)),
                    ("reduce_scatter", f"reduce_scatter_{regime}",
                     lambda: sub.reduce_scatter_array(z)),
                    ("allgather", "all_gather", lambda: sub.allgather_array(x)),
                    ("bcast", "bcast", lambda: sub.bcast_array(x, n - 1))):
                out, d = launch_delta(fn)
                what = f"{name} (n = {n}) {call} {mb} MB/rank"
                require(d == {key: 1}, f"{what} launched {d}, want {key} once")
                if call == "allgather":
                    same_bytes(out, x, what)
                elif call == "bcast":
                    same_bytes(out, plain["bcast"], what)
                else:
                    same_bits(out, plain[call], what)
                    require(bool(torch.isfinite(out).all()), f"{what}: finite")
                done.append(f"{name} {call} {mb} MB: {key}")
    return done


def check_captured_movers(gen) -> dict:
    """The mover's counter pair under CUDA graph capture, for K10, K11 and
    K15, through ``tests/mover_capture.py`` (the ``cuda`` tests of
    ``tests/test_torch_mover.py`` run the same cases with more launches):
    (1) a captured launch replayed CAPTURE_ROUNDS times, each replay
    started together with an eager launch of the same library, so that one
    of them draws the slot the capture would have held; (2) two graphs
    captured a pool's length of launches apart, replayed CAPTURE_PAIRS
    times together on two streams.  Every result byte-exact, and the
    capture drew no slot."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import mover_capture as mc

    done = {}
    for kernel in ("all_gather", "all_gather_bidi", "all_to_all_v"):
        rounds = mc.TICKET_SLOTS + CAPTURE_ROUNDS
        beside = mc.beside_eager(kernel, rounds, gen)
        apart = mc.two_apart(kernel, CAPTURE_PAIRS, gen)
        require(beside == (0, 0, 0) and apart == (0, 0),
                f"{kernel} under capture: (wrong elements of the replays, of "
                f"the eager launches, slots the capture drew) {beside}; wrong "
                f"elements of two captures a pool apart {apart}")
        done[kernel] = {"replays beside eager launches": rounds,
                        "paired replays": 2 * CAPTURE_PAIRS}
    return done


def slot_rows(world, big, zbig) -> list:
    """Times of the new slots at 8 x 16 MB float32 beside their bound (the
    bytes read and written over 3.35 TB/s), the nearest torch call and the
    host's time per call."""
    import ompi_tpu_torch

    nbytes = big.numel() * 4
    root = COMM_ROOT
    cases = {
        "reduce_array SUM": (lambda: world.reduce_array(big, ompi_tpu_torch.SUM, root),
                             "t.sum(0)", lambda: big.sum(0), 2 * nbytes),
        "reduce_array PROD": (lambda: world.reduce_array(big, ompi_tpu_torch.PROD, root),
                              "t.prod(0)", lambda: big.prod(0), 2 * nbytes),
        "reduce_array MAX": (lambda: world.reduce_array(big, ompi_tpu_torch.MAX, root),
                             "t.amax(0)", lambda: big.amax(0), 2 * nbytes),
        "gather_array": (lambda: world.gather_array(big, root),
                         "t.expand(n, *t.shape).clone()",
                         lambda: big.expand(N, *big.shape).clone(),
                         nbytes + N * nbytes),
        # only root's row is read: (n, S/n) in, (n, S/n) out
        "scatter_array": (lambda: world.scatter_array(zbig, root),
                          "z[root].clone()", lambda: zbig[root].clone(),
                          2 * zbig[root].numel() * 4),
        "scan_array": (lambda: world.scan_array(big), "torch.cumsum(t, 0)",
                       lambda: torch.cumsum(big, 0), 2 * nbytes),
        "exscan_array": (lambda: world.exscan_array(big), "torch.cumsum(t, 0)",
                         lambda: torch.cumsum(big, 0), 2 * nbytes),
    }
    rows = []
    for name, (fn, lib_name, lib, moved) in cases.items():
        rows.append({"slot": name, "ms": time_ms(fn),
                     "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                     "torch_call": lib_name, "torch_ms": time_ms(lib),
                     "host_us": host_us(fn, HOST_SLOT_CALLS),
                     "torch_host_us": host_us(lib, HOST_SLOT_CALLS)})
    return rows


def comm_path(gen, timed: bool = True) -> tuple:
    """The device-world communicator on the card, with every count set to 0
    before and read after: a world with coll/ring raised (one-way, no
    wire16); the new slots at 8 x 16 MB and 8 x 1 MB (reduce_array's tree
    launches K2 once a round: 3 rounds a call); the sub-comms
    (``subcomm_calls``); a size-1 split through coll/self_coll; the
    conductor (``world.allreduce`` of a tensor reaches K3 and K4, and
    ``world.scan`` of a tensor stays on the card).  Then, uncounted, the
    mover under graph capture (``check_captured_movers``), and the same
    slots on the CPU lane at 8 x 1 MB, bit for bit with the card's.
    Returns (the launch counts, the slots' time rows); ``timed=False``
    skips the time rows (the observability phase's second run)."""
    import ompi_tpu_torch
    from ompi_tpu_torch.ops import ring_collectives as rc
    from ompi_tpu_torch.runtime import init as rt

    big = operands(torch.float32, (N, 16 * MB // 4), gen)
    zbig = operands(torch.float32, (N, N, 16 * MB // 4 // N), gen)
    small = operands(torch.float32, (N, MB // 4), gen)
    zsmall = operands(torch.float32, (N, N, MB // 4 // N), gen)
    mid = operands(torch.float32, (N, 4 * MB // 4), gen)
    torch.cuda.synchronize()

    settings = {"priority": "95", "bidirectional": "0", "wire16": "0"}
    for name, value in settings.items():
        os.environ[f"OTPU_MCA_coll_ring_{name}"] = value
    reset_counts()
    t0 = time.perf_counter()
    world = ompi_tpu_torch.init()
    for slot in ("reduce_array", "gather_array", "scatter_array", "scan_array",
                 "exscan_array", "barrier"):
        require(owner(world, slot) == "BuiltinCollModule",
                f"owner of {slot} is not coll/builtin")
    require(owner(world, "allreduce") == "ConductorModule",
            "owner of allreduce is not coll/conductor")
    got, deltas = slot_calls(world, big, zbig)
    got_small, deltas_small = slot_calls(world, small, zsmall)
    world.barrier()
    subs = subcomm_calls(world, gen)
    one = world.split([0] + [1] * (N - 1))
    require(one.size == 1 and owner(one, "allreduce") == "SelfCollModule",
            "the size-1 split does not take coll/self_coll")
    host_one = one.allreduce(np.arange(4.0))
    one_row, d_one = launch_delta(lambda: one.allreduce_array(mid[:1]))
    conducted = {}
    for what, x, key in (("4 MB", mid, "all_reduce_fused"),
                         ("16 MB", big, "all_reduce_seg")):
        out, d = launch_delta(lambda: world.allreduce(x))
        require(d == {key: 1}, f"world.allreduce(tensor) {what} launched {d}")
        same_bits(out, rc.all_reduce_fused_plain(x, N, "sum") if key.endswith(
            "fused") else rc.all_reduce_seg_plain(x, N, "sum", SEG),
            f"world.allreduce(tensor) {what}")
        conducted[what] = d
    scanned = world.scan(small)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    captured = check_captured_movers(gen)
    rows = slot_rows(world, big, zbig) if timed else []
    rt.finalize()

    cpu = ompi_tpu_torch.init(device="cpu")
    got_cpu, _ = slot_calls(cpu, small.cpu(), zsmall.cpu())
    rt.finalize()
    for name in settings:
        del os.environ[f"OTPU_MCA_coll_ring_{name}"]

    log(f"comm path: init (coll/ring raised), reduce_array x 6, gather_array, "
        f"scatter_array, scan_array, exscan_array x 2 each, barrier, "
        f"{len(subs)} sub-comm calls, a size-1 split, 2 x world.allreduce "
        f"(tensor) in {wall:.3f} s (host clock); launches "
        f"{dict((k, v) for k, v in launched.items() if v)}; then, uncounted, "
        f"the mover under capture ({captured})")
    for size, per_call in (("16 MB", deltas), ("1 MB", deltas_small)):
        require(all(d == {"combine2": 3} for d in per_call.values()),
                f"reduce_array's tree at {size} launched {per_call}, want K2 "
                f"once a round (3)")
    require(launched["combine2"] == 18, f"K2 launched {launched['combine2']}")
    for key in ("all_reduce_fused", "all_reduce_seg", "reduce_scatter_fused",
                "reduce_scatter_seg", "all_gather", "bcast"):
        require(launched[key] > 0, f"{key} was not launched on the comm path")
    require(d_one == {}, f"the size-1 comm's allreduce_array launched {d_one}")
    same_bits(one_row, mid[0], "the size-1 comm's allreduce_array")
    require(host_one.tolist() == [0.0, 1.0, 2.0, 3.0], "the size-1 allreduce")
    check_slots(got, big, zbig, "8 x 16 MB")
    check_slots(got_small, small, zsmall, "8 x 1 MB")
    for name, want in got_cpu.items():
        same_bits(got_small[name].cpu(), want, f"{name} card vs CPU lane, 8 x 1 MB")
    require(scanned.device == small.device, "world.scan(tensor) left the card")
    same_bits(scanned, got_small["scan"], "world.scan(tensor) vs scan_array")
    log("comm path results: reduce_array bit-exact with its tree on K2's plain "
        "version (SUM within the torch.sum band, MAX equal to amax), gather "
        "and scatter byte for byte, scan within the cumsum band, exscan its "
        "shift; at 8 x 1 MB every slot bit-exact with the CPU lane; "
        f"sub-comms bit-exact with the plain versions ({len(subs)} calls); "
        f"world.allreduce(tensor) {conducted}; world.scan(tensor) on the "
        "card, equal to scan_array; the captured movers byte-exact")
    if timed:
        log(json.dumps({"comm_slots_ms": rows}))
    return launched, rows


#: the meshes of ``run_training_step`` on 8 ranks
STEP_MESHES = {"default": dict(dp=2, pp=1, sp=2, tp=2),
               "pp2": dict(dp=1, pp=2, sp=2, tp=2)}
#: at OTPU_MODEL_SCALE=64 the reference's lr (1e-4) overshoots: the first
#: loss is 1.07e6 (0.5·Σy² grows with the width, and so does its gradient)
#: and the second step's is higher; 1e-5 descends
STEP_LR = 1e-5


def k21_per_step(sizes: dict) -> int:
    """K21 launches of one step: one per ring step, (M + pp - 1)
    pipeline steps x layers_local blocks x sp ring steps; the backward
    recomputes through plain torch and launches none."""
    from ompi_tpu_torch.parallel import train
    from ompi_tpu_torch.parallel.mesh import MeshSpec

    dims = train.model_dims(MeshSpec(**sizes))
    return (dims["M"] + sizes["pp"] - 1) * dims["layers_local"] * sizes["sp"]


def training_path() -> dict:
    """The flagship training step at OTPU_MODEL_SCALE=64 on the card:
    ``run_training_step`` (two descending steps on the default mesh, two on
    the pp = 2 mesh) with every count set to 0 before and read after; then
    the exact K21 count of one step on each mesh and under remat, and the
    step with ``use_flash=False`` against the K21 step."""
    from ompi_tpu_torch.base.var import registry
    from ompi_tpu_torch.parallel import dryrun, train
    from ompi_tpu_torch.parallel.mesh import MeshSpec

    per_step = {name: k21_per_step(s) for name, s in STEP_MESHES.items()}
    reset_counts()
    t0 = time.perf_counter()
    loss = dryrun.run_training_step(lr=STEP_LR)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    want = 2 * per_step["default"] + 2 * per_step["pp2"]
    require(launched["flash_block"] == want,
            f"training path launched K21 {launched['flash_block']} times, "
            f"want {want}")
    require(np.isfinite(loss), f"training loss {loss}")
    scale = os.environ.get("OTPU_MODEL_SCALE", "1")
    log(f"training path: run_training_step(lr={STEP_LR}) at "
        f"OTPU_MODEL_SCALE={scale}, 2 steps "
        f"on {STEP_MESHES['default']} and 2 on {STEP_MESHES['pp2']}, loss "
        f"descending on both, in {wall:.3f} s (host clock, includes the "
        f"first-step set-up); K21 launches {launched['flash_block']} = 2 x "
        f"{per_step['default']} + 2 x {per_step['pp2']}")

    for name, sizes in STEP_MESHES.items():
        step, state, _ = dryrun.make_step_and_args(spec=MeshSpec(**sizes),
                                                   lr=STEP_LR)
        _, delta = launch_delta(lambda: step(*state))
        require(delta == {"flash_block": per_step[name]},
                f"one step on {name}: launches {delta}, want "
                f"{per_step[name]} of K21")
    remat = registry.lookup("otpu_parallel_remat")
    remat.set(True)
    try:
        step, state, _ = dryrun.make_step_and_args(lr=STEP_LR)
        _, delta = launch_delta(lambda: step(*state))
    finally:
        remat.set(False)
    require(delta == {"flash_block": 2 * per_step["default"]},
            f"one remat step: launches {delta}, want 2 x {per_step['default']}")

    step, state, _ = dryrun.make_step_and_args(lr=STEP_LR)
    plain_step, plain_state, _ = dryrun.make_step_and_args(use_flash=False,
                                                           lr=STEP_LR)
    (new, loss), (new_p, loss_p) = step(*state), plain_step(*plain_state)
    rel_loss = abs(float(loss) - float(loss_p)) / abs(float(loss_p))
    require(rel_loss <= 1e-5, f"use_flash=False loss differs by {rel_loss:.3e}")
    params = state[0]
    worst = 0.0
    for k in params:
        upd, upd_p = params[k] - new[k], params[k] - new_p[k]
        rel = ((upd - upd_p).abs().max() / upd_p.abs().max()).item()
        worst = max(worst, rel)
        require(rel <= 1e-4, f"use_flash=False update of {k} differs by {rel:.3e}")
    log(f"training step with use_flash=False on the card: loss within "
        f"{rel_loss:.3e} (band 1e-5), each leaf's update within {worst:.3e} "
        f"of its largest magnitude (band 1e-4) of the K21 step; K21 per step "
        f"{per_step['default']} (default mesh), {per_step['pp2']} (pp = 2), "
        f"{2 * per_step['default']} under remat: exact")
    bf16_launched, bf16_variants = bfloat16_training(per_step)
    variants = {"K21": (step, state),
                "use_flash=False": (plain_step, plain_state), **bf16_variants}
    times = step_ms(variants)
    log(json.dumps({"step_ms": {**times, "mesh": STEP_MESHES["default"],
                                "scale": int(scale), "layers": 1}}))
    log(json.dumps({"step_profile": {what: step_profile(*v)
                                     for what, v in variants.items()}}))
    return {"flash_block": launched["flash_block"],
            "flash_block_bf16": bf16_launched, "step_ms": times}


#: the loss of the bfloat16 step against the same step with
#: ``use_flash=False`` (tests/test_torch_parallel.py's bfloat16 band)
BF16_STEP_BAND = 1e-3


def bfloat16_training(per_step: dict) -> tuple:
    """The training step with ``otpu_parallel_compute_dtype=bfloat16``
    (restored after): every K21 launch is bfloat16 and so runs its mma.sync
    body.  ``run_training_step`` with every count set to 0 before and read
    after (two descending steps on each mesh), the exact K21 count of one
    step on each mesh, and the loss within ``BF16_STEP_BAND`` of the same
    step with ``use_flash=False``.  Returns the K21 launches of that run
    and the two steps for ``step_ms`` and ``step_profile``."""
    from ompi_tpu_torch.base.var import registry
    from ompi_tpu_torch.parallel import dryrun
    from ompi_tpu_torch.parallel.mesh import MeshSpec

    var = registry.lookup("otpu_parallel_compute_dtype")
    old = var.value
    var.set("bfloat16")
    try:
        reset_counts()
        t0 = time.perf_counter()
        loss = dryrun.run_training_step(lr=STEP_LR)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()["flash_block"]
        want = 2 * per_step["default"] + 2 * per_step["pp2"]
        require(launched == want, f"the bfloat16 training path launched K21 "
                f"{launched} times, want {want}")
        require(np.isfinite(loss), f"bfloat16 training loss {loss}")
        for name, sizes in STEP_MESHES.items():
            step, state, _ = dryrun.make_step_and_args(spec=MeshSpec(**sizes),
                                                       lr=STEP_LR)
            _, delta = launch_delta(lambda: step(*state))
            require(delta == {"flash_block": per_step[name]},
                    f"one bfloat16 step on {name}: launches {delta}, want "
                    f"{per_step[name]} of K21")
        step, state, _ = dryrun.make_step_and_args(lr=STEP_LR)
        plain_step, plain_state, _ = dryrun.make_step_and_args(
            use_flash=False, lr=STEP_LR)
        (_, got), (_, want_loss) = step(*state), plain_step(*plain_state)
    finally:
        var.set(old)
    got, want_loss = float(got), float(want_loss)
    rel = abs(got - want_loss) / abs(want_loss)
    require(np.isfinite(got) and rel <= BF16_STEP_BAND,
            f"bfloat16 step loss {got} against use_flash=False {want_loss}: "
            f"{rel:.3e} above {BF16_STEP_BAND:g}")
    log(f"bfloat16 training path: run_training_step(lr={STEP_LR}) with "
        f"otpu_parallel_compute_dtype=bfloat16, loss {loss:.6g} descending on "
        f"both meshes, in {wall:.3f} s (host clock, includes the first-step "
        f"set-up); K21 launches {launched} = 2 x {per_step['default']} + 2 x "
        f"{per_step['pp2']}, one step exactly {per_step['default']} / "
        f"{per_step['pp2']}; loss {got:.9g} within {rel:.3e} of the "
        f"use_flash=False step's {want_loss:.9g} (band {BF16_STEP_BAND:g})")
    return launched, {"K21 bf16": (step, state),
                      "use_flash=False bf16": (plain_step, plain_state)}


def moe_path(gen) -> dict:
    """The MoE device tier on the card, with every count set to 0 before
    and read after: on a world with coll/ring raised, ``expert_ffn_fused``
    at the Mixtral expert shape (float32) through coll/tuned's cell (K20's
    all-reduce form once); with ``otpu_coll_tuned_fused_cells`` forcing the
    reduce-scatter cell, ``expert_ffn_fused`` takes its unfused einsum (no
    K20) and that cell itself (K20's reduce-scatter form once);
    ``dispatch_tokens`` on the MoE dispatch slab without a budget and on a
    dup with ``otpu_quant_budget`` 0.02 (the int32 slab; K15 once each);
    ``run_moe_training_step`` on (dp=2, ep=4).  Exact counts; results held
    against the plain versions and, for the step, a CPU run."""
    import ompi_tpu_torch
    from ompi_tpu_torch.base.var import registry
    from ompi_tpu_torch.mca.coll import tuned
    from ompi_tpu_torch.ops import overlap
    from ompi_tpu_torch.ops import ring_collectives as rc
    from ompi_tpu_torch.parallel import moe
    from ompi_tpu_torch.runtime import init as rt

    a, b = k20_operands(torch.float32, K20_M, "random", gen)
    x, routed = moe_slab(gen), moe_counts()
    torch.cuda.synchronize()

    reset_counts()
    bodies_before = dict(overlap.bodies)
    t0 = time.perf_counter()
    os.environ["OTPU_MCA_coll_ring_priority"] = "95"
    world = ompi_tpu_torch.init()
    require(owner(world, "alltoallv_array") == "RingCollModule",
            "raised owner of alltoallv_array is not coll/ring")
    fused, d_fused = launch_delta(lambda: moe.expert_ffn_fused(a, b))
    var = registry.lookup("otpu_coll_tuned_fused_cells")
    var.set("matmul_reduce_scatter")
    try:
        unfused, d_unfused = launch_delta(lambda: moe.expert_ffn_fused(a, b))
        cell = tuned.device_cell("matmul_reduce_scatter")
        rs, d_rs = launch_delta(lambda: cell(a, b, N))
    finally:
        var.set("")
    (raw, codec_raw), d_raw = launch_delta(
        lambda: moe.dispatch_tokens(world, x, routed))
    budgeted = world.dup()
    budgeted.info.set("otpu_quant_budget", MOE_BUDGET)
    (packed, codec_packed), d_packed = launch_delta(
        lambda: moe.dispatch_tokens(budgeted, x, routed))
    losses = moe.run_moe_training_step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    bodies = {k: v - bodies_before[k] for k, v in overlap.bodies.items()
              if v != bodies_before[k]}
    rt.finalize()
    del os.environ["OTPU_MCA_coll_ring_priority"]

    log(f"MoE path: init (coll/ring raised), expert_ffn_fused twice, the "
        f"reduce-scatter cell, dispatch_tokens twice, run_moe_training_step "
        f"in {wall:.3f} s (host clock, includes the first-call set-up); "
        f"launches {dict((k, v) for k, v in launched.items() if v)}; K20 "
        f"bodies {bodies}")
    require(d_fused == {"matmul_allreduce": 1},
            f"expert_ffn_fused launched {d_fused}, want K20 (allreduce) once")
    require(d_unfused == {}, f"forced to the reduce-scatter cell, "
            f"expert_ffn_fused launched {d_unfused}, want nothing")
    require(d_rs == {"matmul_reduce_scatter": 1},
            f"the reduce-scatter cell launched {d_rs}, want K20 once")
    require(d_raw == {"all_to_all_v": 1} and d_packed == {"all_to_all_v": 1},
            f"dispatch_tokens launched {d_raw} and {d_packed}, want K15 once each")
    require({k: v for k, v in launched.items() if v} ==
            {"matmul_allreduce": 1, "matmul_reduce_scatter": 1,
             "all_to_all_v": 2}, f"MoE path launches {launched}")
    require(bodies == {"ffma": 2},
            f"MoE path K20 bodies {bodies}, want the ffma body twice")

    scale = k20_scale(a, b)
    plain = overlap.matmul_allreduce_plain(a, b, N)
    e_fused, _ = check_k20_band(fused, plain, scale,
                                "expert_ffn_fused vs plain")
    check_k20_band(unfused, plain, scale,
                   "unfused einsum vs K20's plain version")
    check_k20_band(rs, overlap.matmul_reduce_scatter_plain(a, b, N),
                   scale, "reduce-scatter cell vs plain")
    del plain
    require(codec_raw is None and codec_packed == "int8",
            f"codecs {codec_raw}, {codec_packed}")
    want_raw = rc.all_to_all_v_plain(x, routed, N)
    want_packed = moe.decode_dispatch_int8(rc.all_to_all_v_plain(
        moe.encode_dispatch_int8(x), routed, N), HIDDEN)
    worst = 0.0
    for i in range(N):
        for j in range(N):
            c = int(routed[j, i])
            same_bytes(raw[i][j], want_raw[i, j, :c], f"dispatch ({i}, {j})")
            same_bits(packed[i][j], want_packed[i, j, :c],
                      f"int8 dispatch ({i}, {j})")
            if c:
                amax = x[j, i, :c].abs().amax(-1, keepdim=True)
                worst = max(worst, ((packed[i][j] - x[j, i, :c]).abs()
                                    / amax).max().item())
    require(worst <= 0.5 / 127 + 1e-6,
            f"int8 dispatch error {worst} above half a step of the row max")
    cpu = moe.run_moe_training_step(device="cpu")
    rel = max(abs(g - c) / abs(c) for g, c in zip(losses, cpu))
    require(rel <= 1e-5, f"MoE step on the card vs the CPU: {rel:.3e}")
    log(f"MoE path results: expert_ffn_fused (K20) within {e_fused:.3e} "
        f"(band {K20_BANDS[torch.float32]} x {scale:.1f}) of its plain "
        "version, the unfused einsum and the reduce-scatter cell within the "
        "band; dispatch_tokens byte-exact with the plain exchange over the "
        "valid rows, the int8 path bit-exact with the plain exchange of the "
        f"packed slab and within {worst:.3e} of each row's max; the MoE step "
        f"{losses} (descending, bit-stable across two builds), within "
        f"{rel:.3e} of the CPU run")
    return launched


def step_ms(variants: dict, rounds: int = 4, steps: int = 3) -> dict:
    """Host time (ms) of one training step ending in a sync, each variant
    ``(step, state)`` in turns (a b, b a, ...): after two warm-up steps
    each, ``rounds`` rounds of ``steps`` steps from the same state; the
    median and the quartiles of each variant's samples."""
    for step, state in variants.values():
        for _ in range(2):
            step(*state)
    torch.cuda.synchronize()
    samples = {what: [] for what in variants}
    order = list(variants)
    for r in range(rounds):
        for what in order if r % 2 == 0 else order[::-1]:
            step, state = variants[what]
            for _ in range(steps):
                t0 = time.perf_counter()
                step(*state)
                torch.cuda.synchronize()
                samples[what].append((time.perf_counter() - t0) * 1e3)
    return {what: {"median": statistics.median(s),
                   "quartiles": statistics.quantiles(s, n=4)[::2]}
            for what, s in samples.items()}


def step_profile(step, state, top: int = 8) -> dict:
    """One training step (after a warm-up step) under ``torch.profiler``:
    its host time (ms, profiler on), the device time of its kernels (ms;
    one stream, so their sum is the busy time), the device's idle share of
    the step, and the ``top`` kernels by device time with their counts.
    A trace with no device time says so instead."""
    from torch.profiler import ProfilerActivity, profile

    step(*state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(*state)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [(ev.key, ev.self_device_time_total / 1e3, ev.count)
               for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and ev.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in kernels)
    if not kernels:
        return {"host_ms": wall, "device_ms": "not measured"}
    kernels.sort(key=lambda k: -k[1])
    return {"host_ms": wall, "device_ms": busy, "idle_share": 1 - busy / wall,
            "kernel_launches": sum(n for _, _, n in kernels),
            "top": [{"kernel": name[:80], "ms": ms, "count": n}
                    for name, ms, n in kernels[:top]]}


def launch_delta(fn) -> tuple:
    """(fn's result, what it added to each launch count)."""
    before = counts()
    out = fn()
    return out, {k: v - before[k] for k, v in counts().items() if v != before[k]}


def codec_calls(world, big) -> dict:
    """The compressed collectives through coll/builtin on dups of
    ``world`` with a budget: their results and their launch deltas."""
    import ompi_tpu_torch

    int8 = world.dup()
    int8.info.set("otpu_quant_budget", "0.01")
    bf16 = world.dup_with_info(int8.get_info())
    bf16.info.set("otpu_quant_budget", "0.005")
    got = {}
    for name, fn in (
            ("int8_allreduce", lambda: int8.allreduce_array(big)),
            ("int8_allgather", lambda: int8.allgather_array(big)),
            ("bf16_allreduce", lambda: bf16.allreduce_array(big)),
            ("bf16_allgather", lambda: bf16.allgather_array(big)),
            ("max", lambda: int8.allreduce_array(big, ompi_tpu_torch.MAX))):
        got[name] = launch_delta(fn)
    return got


def wire16_calls(world, mid, big, rs_mid) -> dict:
    import ompi_tpu_torch

    require(world.c_coll["allreduce_array"].__self__.wire16,
            "OTPU_MCA_coll_ring_wire16=1 did not reach coll/ring")
    return {"ar_mid": launch_delta(lambda: world.allreduce_array(mid)),
            "ar_big": launch_delta(lambda: world.allreduce_array(big)),
            "rs_mid": launch_delta(lambda: world.reduce_scatter_array(
                rs_mid, ompi_tpu_torch.SUM))}


def duplex_calls(world, mid, big, rs_mid, rs_big) -> dict:
    """The raised ring with the duplex var: each call's result and launch
    delta; ``init`` binds the persistent allreduce (one validating call),
    ``persistent`` calls its handle twice."""
    import ompi_tpu_torch

    ring = world.c_coll["allreduce_array"].__self__
    require(ring.bidirectional and not ring.wire16,
            "OTPU_MCA_coll_ring_bidirectional=1 (wire16 off) did not reach "
            "coll/ring")
    got = {"ar_mid": launch_delta(lambda: world.allreduce_array(mid)),
           "ar_big": launch_delta(lambda: world.allreduce_array(big)),
           "rs_mid": launch_delta(lambda: world.reduce_scatter_array(
               rs_mid, ompi_tpu_torch.SUM)),
           "rs_big": launch_delta(lambda: world.reduce_scatter_array(
               rs_big, ompi_tpu_torch.SUM)),
           "ag": launch_delta(lambda: world.allgather_array(big)),
           "init": launch_delta(lambda: world.allreduce_array_init(mid))}
    handle = got["init"][0]
    got["persistent"] = launch_delta(lambda: [handle(mid), handle(mid)])
    return got


def check_duplex_results(duplex: dict, mid, big, rs_mid, rs_big) -> None:
    from ompi_tpu_torch.ops import ring_collectives as rc

    want = {"ar_mid": {"all_reduce_bidi": 1},
            "ar_big": {"all_reduce_seg_bidi": 1},
            "rs_mid": {"reduce_scatter_fused": 1},
            "rs_big": {"reduce_scatter_seg": 1},
            "ag": {"all_gather_bidi": 1},
            "init": {"all_reduce_bidi": 1},
            "persistent": {"all_reduce_bidi": 2}}
    for name, (_, delta) in duplex.items():
        require(delta == want[name], f"duplex {name}: launches {delta}, want "
                f"{want[name]}")
    check_sum(duplex["ar_mid"][0], mid, rc.all_reduce_bidi_plain(mid, N, "sum"),
              "duplex allreduce 4 MB/rank (K8)")
    check_sum(duplex["ar_big"][0], big,
              rc.all_reduce_seg_bidi_plain(big, N, "sum", SEG),
              "duplex allreduce 16 MB/rank (K9)")
    for name, x in (("rs_mid", rs_mid), ("rs_big", rs_big)):
        check_sum(duplex[name][0], x, rc.reduce_scatter_plain(x, N, "sum"),
                  f"duplex on, reduce_scatter {name} (K5/K6)")
    same_bytes(duplex["ag"][0], big, "duplex allgather 16 MB/rank (K11)")
    for out in duplex["persistent"][0]:
        same_bits(out, duplex["ar_mid"][0],
                  "allreduce_array_init handle vs the one-shot call (K8)")
    log("duplex path: 4 MB/rank allreduce -> K8, 16 MB/rank -> K9, "
        "reduce_scatter -> K5/K6 (no duplex key), allgather -> K11, each "
        "once; allreduce_array_init binds with one K8 and its two calls "
        "launch K8 twice, bit-equal to the one-shot call; all bit-exact with "
        "the plain versions and within 2(n-1)·2^-24·Σ|x| of torch.sum")


def codec_band(out, x, codec: str, what: str) -> float:
    """Max |out - exact| over max |exact|, exact = the float64 sum; fails
    above the codec's band."""
    from ompi_tpu_torch.mca.coll.quant import CODEC_BANDS

    exact = torch.sum(x.double(), 0)
    rel = float((out.double() - exact).abs().max() / exact.abs().max())
    require(rel <= CODEC_BANDS[codec], f"{what}: relative error {rel} above "
            f"the {codec} band {CODEC_BANDS[codec]}")
    return rel


def check_codec_results(codec: dict, big) -> None:
    from ompi_tpu_torch.ops import quant as qo

    want = {"int8_allreduce": {"encode_int8": 1, "dequant_accumulate": 1},
            "int8_allgather": {"encode_int8": 1, "decode_int8": 1},
            "bf16_allreduce": {}, "bf16_allgather": {}, "max": {}}
    for name, (_, delta) in codec.items():
        require(delta == want[name], f"{name}: launches {delta}, want "
                f"{want[name]}")
    q, s = qo.encode_int8_plain(big)
    same_bits(codec["int8_allreduce"][0],
              qo.dequant_accumulate_plain(q, s).reshape(big.shape[1:]),
              "int8 allreduce (K17, K18)")
    same_bits(codec["int8_allgather"][0],
              qo.decode_int8_plain(q, s).reshape(big.shape),
              "int8 allgather (K17, K19)")
    wire = big.to(torch.bfloat16).to(torch.float32)
    same_bits(codec["bf16_allreduce"][0], wire.sum(0), "bf16 allreduce")
    same_bits(codec["bf16_allgather"][0], wire, "bf16 allgather")
    require(torch.equal(codec["max"][0], torch.amax(big, 0)),
            "MAX on the budgeted comm is not exact")
    rel8 = codec_band(codec["int8_allreduce"][0], big, "int8", "int8 allreduce")
    rel16 = codec_band(codec["bf16_allreduce"][0], big, "bf16", "bf16 allreduce")
    log(f"codec path: budget 0.01 -> int8 (K17 x2, K18, K19 exactly), "
        f"budget 0.005 -> bf16 and MAX launched no codec kernel; bit-exact "
        f"with the plain versions; relative error vs the float64 sum: int8 "
        f"{rel8:.3e} (band {1 / 127:.3e}), bf16 {rel16:.3e} (band "
        f"{2 ** -8:.3e})")


def check_wire16_results(wire: dict, mid, big, rs_mid) -> None:
    from ompi_tpu_torch.ops import ring_collectives as rc

    want = {"ar_mid": {"all_reduce_wire16": 1},
            "ar_big": {"all_reduce_seg": 1},
            "rs_mid": {"reduce_scatter_wire16": 1}}
    for name, (_, delta) in wire.items():
        require(delta == want[name], f"wire16 {name}: launches {delta}, want "
                f"{want[name]}")
    same_bits(wire["ar_mid"][0], rc.all_reduce_wire16_plain(mid, N, "sum"),
              "wire16 allreduce 4 MB/rank (K7)")
    check_sum(wire["ar_big"][0], big, rc.all_reduce_seg_plain(big, N, "sum", SEG),
              "wire16 on, allreduce 16 MB/rank (K4)")
    same_bits(wire["rs_mid"][0], rc.reduce_scatter_wire16_plain(rs_mid, N, "sum"),
              "wire16 reduce_scatter 4 MB/rank (K5w)")
    for out, x, what in ((wire["ar_mid"][0], mid, "K7"),
                         (wire["rs_mid"][0], rs_mid, "K5w")):
        bound = N * 2.0 ** -8 * x.abs().sum(0)
        bad = ((out - torch.sum(x, 0)).abs() > bound).sum().item()
        require(bad == 0, f"{what}: {bad} elements outside n·2^-8·Σ|x|")
    log("wire16 path: 4 MB/rank allreduce -> K7, 16 MB/rank -> K4 (no K7), "
        "4 MB/rank reduce_scatter -> K5w, each once; bit-exact with the plain "
        "versions and within n·2^-8·Σ|x| of torch.sum")


def exchange_calls(world, big, a2a, moe, routed, agv, agv_counts) -> dict:
    """The exchange tier through ``world``: alltoall, alltoallv (the MoE
    dispatch), allgatherv and ppermute with the rotation and with GENERAL;
    ``k13_general`` is what the general perm added to K13's count."""
    from ompi_tpu_torch.ops import ring_collectives as rc

    got = {"alltoall": world.alltoall_array(a2a),
           "alltoallv": world.alltoallv_array(moe, routed),
           "allgatherv": world.allgatherv_array(agv, agv_counts),
           "rotation": world.ppermute_array(big, ROT)}
    before = rc.launches["right_permute"]
    got["general"] = world.ppermute_array(big, GENERAL)
    got["k13_general"] = rc.launches["right_permute"] - before
    return got


# -- phase 4: times ------------------------------------------------------

def time_ms(fn, reps: int = REPS) -> float:
    """Median device time of ``reps`` single calls with a cold L2: a 256 MB
    zero fill runs before each call.  The card spins first while the host
    enqueues every timed call: a wrapper's host dispatch can take longer
    than the fill, and would otherwise land between a call's events."""
    flush = torch.empty(256 * MB // 4, device="cuda")
    for _ in range(WARMUP):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host time per call (µs) to enqueue ``fn``, while the card spins, so
    that no device time is in it."""
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    per_call = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return per_call


def measure(gen, launched: dict, err: dict) -> list:
    from ompi_tpu_torch.ops import quant as qo
    from ompi_tpu_torch.ops import reduce
    from ompi_tpu_torch.ops import ring_collectives as rc

    big = operands(torch.float32, (N, 16 * MB // 4), gen)
    mid = operands(torch.float32, (N, 4 * MB // 4), gen)
    a = operands(torch.float32, (16 * MB // 4,), gen)
    b = operands(torch.float32, (16 * MB // 4,), gen)
    rs_mid = rs_operands(4 * MB, gen)
    rs_big = rs_operands(16 * MB, gen)
    a2a = operands(torch.float32, (N, N, 524288), gen)
    moe, routed = moe_slab(gen), moe_counts()
    agv = operands(torch.float32, (N, CAPACITY, HIDDEN), gen)
    row = HIDDEN * 4
    seg = SEG
    q, s = qo.encode_int8(big)                  # (8, 32768, 128), (8, 32768)
    q_bytes, s_bytes = q.numel(), s.numel() * 4
    cases = {
        # name: (kernel, plain, library, inputs+output bytes, what[, counts
        # of a ragged kernel, whose error is taken over its valid rows])
        "reduce_stack": (lambda: reduce.reduce_stack("PROD", big),
                         lambda: reduce.reduce_stack_plain("PROD", big),
                         lambda: torch.prod(big, 0),
                         (N + 1) * 16 * MB, "PROD f32 k=8, 16 MB slices"),
        "combine2": (lambda: reduce.combine2("SUM", a, b),
                     lambda: reduce.combine2_plain("SUM", a, b),
                     lambda: torch.add(a, b),
                     3 * 16 * MB, "SUM f32, 16 MB operands"),
        "all_reduce_fused": (lambda: rc.all_reduce(mid, N, "sum", "fused"),
                             lambda: rc.all_reduce_fused_plain(mid, N, "sum"),
                             lambda: torch.sum(mid, 0),
                             (N + 1) * 4 * MB, "SUM f32, 8 ranks x 4 MB"),
        "all_reduce_seg": (lambda: rc.all_reduce(big, N, "sum", "seg", seg),
                           lambda: rc.all_reduce_seg_plain(big, N, "sum", seg),
                           lambda: torch.sum(big, 0),
                           (N + 1) * 16 * MB, "SUM f32, 8 ranks x 16 MB"),
        "reduce_scatter_fused": (
            lambda: rc.reduce_scatter(rs_mid, N, "sum", "fused"),
            lambda: rc.reduce_scatter_plain(rs_mid, N, "sum"),
            lambda: torch.sum(rs_mid, 0),
            (N + 1) * 4 * MB, "SUM f32, (8, 8, 131072): 8 ranks x 4 MB"),
        "reduce_scatter_seg": (
            lambda: rc.reduce_scatter(rs_big, N, "sum", "seg", seg),
            lambda: rc.reduce_scatter_plain(rs_big, N, "sum"),
            lambda: torch.sum(rs_big, 0),
            (N + 1) * 16 * MB, "SUM f32, (8, 8, 524288): 8 ranks x 16 MB"),
        "all_gather": (lambda: rc.all_gather(big, N),
                       lambda: rc.all_gather_plain(big, N),
                       lambda: big.clone(),
                       2 * N * 16 * MB, "f32, 8 ranks x 16 MB"),
        "bcast": (lambda: rc.bcast(big, N, 3),
                  lambda: rc.bcast_plain(big, N, 3),
                  lambda: big[3].expand(N, -1).clone(),
                  (N + 1) * 16 * MB, "f32, root 3, 8 ranks x 16 MB"),
        "right_permute": (lambda: rc.right_permute(big, N),
                          lambda: rc.right_permute_plain(big, N),
                          lambda: torch.roll(big, 1, 0),
                          2 * N * 16 * MB, "f32, 8 ranks x 16 MB"),
        "all_to_all": (lambda: rc.all_to_all(a2a, N),
                       lambda: rc.all_to_all_plain(a2a, N),
                       lambda: a2a.transpose(0, 1).contiguous(),
                       2 * N * 16 * MB, "f32, (8, 8, 524288): 8 ranks x 16 MB"),
        "all_to_all_v": (lambda: rc.all_to_all_v(moe, routed, N),
                         lambda: rc.all_to_all_v_plain(moe, routed, N),
                         lambda: moe.transpose(0, 1).contiguous(),
                         2 * int(routed.sum()) * row,
                         f"f32 MoE dispatch (8, 8, {CAPACITY}, {HIDDEN}), "
                         f"{int(routed.sum())} of {N * N * CAPACITY} rows valid",
                         routed),
        "all_gather_v": (lambda: rc.all_gather_v(agv, routed[0], N),
                         lambda: rc.all_gather_v_plain(agv, routed[0], N),
                         lambda: agv.clone(),
                         2 * int(routed[0].sum()) * row,
                         f"f32 (8, {CAPACITY}, {HIDDEN}), "
                         f"{int(routed[0].sum())} of {N * CAPACITY} rows valid",
                         routed[0]),
        # no one PyTorch call computes the encode or the dequant-accumulate
        "encode_int8": (lambda: qo.encode_int8(big),
                        lambda: qo.encode_int8_plain(big), None,
                        N * 16 * MB + q_bytes + s_bytes,
                        "f32 8 x 16 MB -> int8 (8, 32768, 128) + f32 scales"),
        "dequant_accumulate": (lambda: qo.dequant_accumulate(q, s),
                               lambda: qo.dequant_accumulate_plain(q, s), None,
                               q_bytes + s_bytes + 16 * MB,
                               "k = 8, int8 (8, 32768, 128) -> f32 16 MB"),
        "decode_int8": (lambda: qo.decode_int8(q, s),
                        lambda: qo.decode_int8_plain(q, s),
                        lambda: torch.mul(q, s[..., None]),
                        q_bytes + s_bytes + N * 16 * MB,
                        "int8 (8, 32768, 128) -> f32 8 x 16 MB"),
        # no library call rounds each hop to bf16: K3 and K5 on the same
        # inputs (the same bytes) are timed beside them instead
        "all_reduce_wire16": (lambda: rc.all_reduce(mid, N, "sum", "wire16"),
                              lambda: rc.all_reduce_wire16_plain(mid, N, "sum"),
                              None, (N + 1) * 4 * MB,
                              "SUM f32, 8 ranks x 4 MB, bf16 wire"),
        "reduce_scatter_wire16": (
            lambda: rc.reduce_scatter(rs_mid, N, "sum", "wire16"),
            lambda: rc.reduce_scatter_wire16_plain(rs_mid, N, "sum"), None,
            (N + 1) * 4 * MB, "SUM f32, (8, 8, 131072): 8 ranks x 4 MB, bf16 wire"),
        "all_reduce_bidi": (lambda: rc.all_reduce(mid, N, "sum", "bidi"),
                            lambda: rc.all_reduce_bidi_plain(mid, N, "sum"),
                            lambda: torch.sum(mid, 0), (N + 1) * 4 * MB,
                            "SUM f32, 8 ranks x 4 MB, duplex blocks"),
        "all_reduce_seg_bidi": (
            lambda: rc.all_reduce(big, N, "sum", "seg_bidi", seg),
            lambda: rc.all_reduce_seg_bidi_plain(big, N, "sum", seg),
            lambda: torch.sum(big, 0), (N + 1) * 16 * MB,
            "SUM f32, 8 ranks x 16 MB, duplex blocks, 512 KB window"),
        "all_gather_bidi": (lambda: rc.all_gather(big, N, "bidi"),
                            lambda: rc.all_gather_plain(big, N),
                            lambda: big.clone(), 2 * N * 16 * MB,
                            "f32, 8 ranks x 16 MB"),
    }
    # the same bytes through the one-way kernel, on the same inputs
    beside = {
        "all_reduce_wire16": ("fused (K3/K5)",
                              lambda: rc.all_reduce(mid, N, "sum", "fused")),
        "reduce_scatter_wire16": ("fused (K3/K5)", lambda: rc.reduce_scatter(
            rs_mid, N, "sum", "fused")),
        "all_reduce_bidi": ("fused (K3)",
                            lambda: rc.all_reduce(mid, N, "sum", "fused")),
        "all_reduce_seg_bidi": ("seg (K4)", lambda: rc.all_reduce(
            big, N, "sum", "seg", seg)),
        "all_gather_bidi": ("ring (K10)", lambda: rc.all_gather(big, N))}
    rows, host = [], {}
    for name, (kernel, plain, library, nbytes, what, *ragged) in cases.items():
        route, source, replaces = KERNELS[name]
        ms = time_ms(kernel)
        got_err = (ragged_err(kernel(), plain(), ragged[0]) if ragged
                   else max(max_abs_err(g, w) for g, w in
                            zip(outputs(kernel()), outputs(plain()))))
        row = {
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launched[name],
            "max_abs_err": max(err[name], got_err),
            "ms": ms, "plain_ms": time_ms(plain),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": time_ms(library) if library else None,
        }
        extra = {"shape": what}
        if name in beside:
            label, fn = beside[name]
            extra["beside_ms"] = {label: time_ms(fn)}
        log(json.dumps({**row, **extra}))
        rows.append(row)
        host[name] = {"kernel": host_us(kernel)}
        if library:
            host[name]["library"] = host_us(library)
    # the whole int8 allreduce against the exact sum: on one card no link
    # carries the encoded bytes, so the codec is a pass more, not a saving
    codec_bytes = N * 16 * MB + 2 * (q_bytes + s_bytes) + 16 * MB
    log(json.dumps({"codec_path_ms": {
        "int8 allreduce (K17 + K18)": time_ms(
            lambda: qo.dequant_accumulate(*qo.encode_int8(big))),
        "bf16 allreduce (plain torch)": time_ms(
            lambda: big.to(torch.bfloat16).to(torch.float32).sum(0)),
        "torch.sum": time_ms(lambda: torch.sum(big, 0)),
        "int8 bound": codec_bytes / HBM_BYTES_PER_S * 1e3,
        "torch.sum bound": (N + 1) * 16 * MB / HBM_BYTES_PER_S * 1e3,
        "shape": "f32 8 ranks x 16 MB"}}))
    log(json.dumps({"host_us_per_call": host}))
    # the torus schedules at 8 x 16 MB on the (2, 4) grid, each phase one
    # sub-ring launch: against the library call of the same function
    grid = big.view(2, 4, -1)
    log(json.dumps({"torus_ms": {
        "grid": [2, 4], "shape": "f32, 8 ranks x 16 MB",
        "all_reduce_torus": time_ms(lambda: rc.all_reduce_torus(grid, 2, 4)),
        "all_reduce_torus library (torch.sum over both axes)":
            time_ms(lambda: grid.sum((0, 1))),
        "all_reduce_torus bound": (N + 1) * 16 * MB / HBM_BYTES_PER_S * 1e3,
        "reduce_scatter_torus": time_ms(
            lambda: rc.reduce_scatter_torus(rs_big, 2, 4)),
        "reduce_scatter_torus library (torch.sum)":
            time_ms(lambda: torch.sum(rs_big, 0)),
        "reduce_scatter_torus bound": (N + 1) * 16 * MB / HBM_BYTES_PER_S * 1e3,
        "all_gather_torus": time_ms(lambda: rc.all_gather_torus(big, 2, 4)),
        "all_gather_torus library (clone)": time_ms(lambda: big.clone()),
        "all_gather_torus bound": 2 * N * 16 * MB / HBM_BYTES_PER_S * 1e3,
        "launches per call": {
            "all_reduce_torus": launch_delta(
                lambda: rc.all_reduce_torus(grid, 2, 4))[1],
            "reduce_scatter_torus": launch_delta(
                lambda: rc.reduce_scatter_torus(rs_big, 2, 4))[1],
            "all_gather_torus": launch_delta(
                lambda: rc.all_gather_torus(big, 2, 4))[1]}}}))
    from ompi_tpu_torch.tools import cuda_aot

    log(json.dumps({"k1_compiled": cuda_aot.stack_compiled(big)}))
    return rows


#: peak rates of one H100 SXM (data sheet, dense): float32 on the CUDA
#: cores (K21 uses no TF32) and bfloat16 on the tensor cores
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}


def flash_row(gen, launches: int, err: tuple, lead, sq, skv, d,
              dtype) -> tuple:
    """K21's kernels-line row at one shape: its time, its plain version's,
    and the bound, the larger of 4·B·sq·skv·d operations over the peak of
    the input dtype and the bytes (q, k, v, num, m, den read once; num, m,
    den written once) over the memory rate.  No PyTorch call returns the
    block update's carries, so library_ms is null.  ``err`` is the (abs,
    rel) error of K21 at this shape and dtype; returns the row and the
    relative error."""
    from ompi_tpu_torch.ops import flash_attention as fa

    q = torch.randn((*lead, sq, d), device="cuda", generator=gen).to(dtype)
    k, v = (torch.randn((*lead, skv, d), device="cuda", generator=gen).to(dtype)
            for _ in range(2))
    state = flash_state(lead, sq, d, dtype, False, gen)
    rows = int(np.prod(lead))
    ops = 4 * rows * sq * skv * d
    nbytes = (rows * (sq + 2 * skv + 2 * sq) * d + 4 * rows * sq) * \
        q.element_size()
    by_ops, by_bytes = ops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    route, source, replaces = KERNELS["flash_block"]
    kernel = lambda: fa.update(q, k, v, *state)
    return {"name": "flash_block", "route": route, "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err[0],
            "ms": time_ms(kernel),
            "plain_ms": time_ms(lambda: fa.update_plain(q, k, v, *state)),
            "bound_ms": max(by_ops, by_bytes) * 1e3,
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "library_ms": None}, err[1]


def measure_flash(gen, trained: dict, err: dict) -> list:
    """K21's kernels-line rows at the step's shape: float32 (its FFMA body,
    launched by the training path) and bfloat16 (its mma.sync body,
    ``flash_block_mma``, launched by the bfloat16 training path); and the
    bfloat16 body at the JAX bench's shape (a line of its own), with
    scaled_dot_product_attention at the bench shape as a yardstick (it does
    not return the carries, and the port never calls it)."""
    row, rel = flash_row(gen, trained["flash_block"], err["flash_block"],
                         STEP_LEAD, STEP_S, STEP_S, STEP_D, torch.float32)
    log(json.dumps({**row, "max_rel_err": rel, "shape": f"float32 q "
                    f"{(*STEP_LEAD, STEP_S, STEP_D)} (the step's, 32 rows), "
                    "unbiased"}))
    mma, rel = flash_row(gen, trained["flash_block_bf16"],
                         err["flash_block_mma"], STEP_LEAD, STEP_S, STEP_S,
                         STEP_D, torch.bfloat16)
    mma["name"] = "flash_block_mma"
    log(json.dumps({**mma, "max_rel_err": rel, "shape": f"bfloat16 q "
                    f"{(*STEP_LEAD, STEP_S, STEP_D)} (the step's, 32 rows), "
                    "unbiased", "launches_per_step": k21_per_step(
                        STEP_MESHES["default"])}))
    b, h, sq, skv, d = BENCH_FLASH
    bench, rel = flash_row(gen, trained["flash_block_bf16"],
                           err["flash_block_bench"], (b, h), sq, skv, d,
                           torch.bfloat16)
    q, k, v = (torch.randn((b, h, n, d), device="cuda", generator=gen,
                           dtype=torch.bfloat16) for n in (sq, skv, skv))
    sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v))
    log(json.dumps({"flash_block_bench": {**bench, "name": "flash_block_mma",
                                          "max_rel_err": rel, "shape": f"bfloat16 "
                    f"(b, h, sq, skv, d) = {BENCH_FLASH}, unbiased"},
                    "sdpa_ms_yardstick": sdpa}))
    return [row, mma]


def slow_ms(fn) -> float:
    """``time_ms`` over 25 calls, or over 5 where one call takes above
    50 ms (K20 and its yardsticks in float32)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time_ms(fn, 5 if time.perf_counter() - t0 > 0.05 else REPS)


def k20_row(name: str, a: torch.Tensor, b: torch.Tensor, launches: int,
            err: float) -> dict:
    """K20's row at one shape: its time, its plain version's and
    ``torch.einsum("nmk,nko->mo")``'s (the same product, the reduce-scatter's
    unpadded), and the bound, the larger of 2·M·K·N operations over the
    dtype's peak and the bytes (a, b read once, the output written once)
    over the memory rate."""
    from ompi_tpu_torch.ops import overlap

    kernel, plain = getattr(overlap, name), getattr(overlap, f"{name}_plain")
    m, k_loc = a.shape[1], a.shape[2]
    out_rows = m if name == "matmul_allreduce" else N * -(-m // N)
    ops = 2 * m * N * k_loc * HIDDEN
    nbytes = (a.numel() + b.numel() + out_rows * HIDDEN) * a.element_size()
    by_ops, by_bytes = ops / PEAK_FLOPS[a.dtype], nbytes / HBM_BYTES_PER_S
    route, source, replaces = KERNELS[name]
    return {"name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": slow_ms(lambda: kernel(a, b, N)),
            "plain_ms": slow_ms(lambda: plain(a, b, N)),
            "bound_ms": max(by_ops, by_bytes) * 1e3,
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "library_ms": slow_ms(lambda: torch.einsum("nmk,nko->mo", a, b))}


def measure_fused_matmul(gen, launched: dict, err: dict) -> list:
    """K20's rows at the Mixtral expert shape: float32 (the MoE path's
    dtype) in the kernels line, bfloat16 in a ``fused_matmul_bf16`` line."""
    rows, bf16 = [], []
    for dtype in (torch.float32, torch.bfloat16):
        a, b = k20_operands(dtype, K20_M, "random", gen)
        for name in MOE_KERNELS:
            key = name if dtype == torch.float32 else f"{name}_bf16"
            row = k20_row(name, a, b, launched[name], err[key])
            shape = (f"{str(dtype)[6:]} a (8, {K20_M}, {K20_K}), b (8, "
                     f"{K20_K}, {HIDDEN}): Mixtral-8x7B w2 over 8 ranks")
            if dtype == torch.float32:
                rows.append(row)
                log(json.dumps({**row, "shape": shape}))
            else:
                bf16.append({**row, "band": err[f"{key}_band"],
                             "shape": shape})
        del a, b
    log(json.dumps({"fused_matmul_bf16": bf16}))
    return rows


# -- phase 5: the host tier ----------------------------------------------

#: a -n 2 ping-pong over btl/sm: one-way latency at 8 B (eager) and the
#: bandwidth at 4 MB (above sm's 512 KB eager limit: RNDV), osu_latency's
#: shape (warm-up rounds, then timed round trips, half a round trip each)
PINGPONG = r"""
import json, sys, time
import numpy as np
import ompi_tpu_torch
from ompi_tpu_torch import native
from ompi_tpu_torch.api import request
from ompi_tpu_torch.runtime import reactor
w = ompi_tpu_torch.init()
peer = 1 - w.rank
res = {}
# how a wait idled: each poll that found nothing counts; polls past
# _YIELD_AFTER yield the core, past _SLEEP_AFTER block in a select on the
# doorbell (woken by the peer)
idle = {"polls": 0, "yields": 0, "blocks": 0}
backoff = request._idle_backoff


def counted_backoff(spins):
    idle["polls"] += 1
    if spins >= request._SLEEP_AFTER:
        idle["blocks"] += 1
    elif spins >= request._YIELD_AFTER:
        idle["yields"] += 1
    backoff(spins)


request._idle_backoff = counted_backoff
per_round_trip = {}
for size, rounds in ((8, 2000), (4 << 20, 40)):
    a = np.full(size // 4, w.rank + 1, np.float32)
    b = np.empty_like(a)
    warm = rounds // 10
    for i in range(warm + rounds):
        if i == warm:
            assert np.all(b == peer + 1), "ping-pong payload after warm-up"
            w.barrier()
            t0 = time.perf_counter()
            idle0 = dict(idle)
        if w.rank == 0:
            w.send(a, 1, 7)
            w.recv(b, 1, 7)
        else:
            w.recv(b, 0, 7)
            w.send(a, 0, 7)
    one_way = (time.perf_counter() - t0) / rounds / 2
    per_round_trip[size] = {k: (idle[k] - idle0[k]) / rounds for k in idle}
    assert np.all(b == peer + 1), "ping-pong payload"
    res[size] = one_way
if w.rank == 0:
    print(json.dumps({"latency_us_8B": res[8] * 1e6,
                      "bandwidth_MBps_4MB": (4 << 20) / res[4 << 20] / 1e6,
                      "one_way_ms_4MB": res[4 << 20] * 1e3,
                      "rank0_idle_polls_per_round_trip_8B":
                          per_round_trip[8]["polls"],
                      "rank0_yields_per_round_trip_8B":
                          per_round_trip[8]["yields"],
                      "rank0_blocks_per_round_trip_8B":
                          per_round_trip[8]["blocks"],
                      "btl": w.pml.bml.endpoint(peer).btl.name,
                      "native": native.available(),
                      "reactor": reactor.active()}),
          flush=True)
ompi_tpu_torch.finalize()
"""

#: a -n 4 coll/basic allreduce of 16 MB of float32 a rank, each rank's
#: buffer a tensor on the card; every rank checks the result bit for bit
#: against a numpy fold in coll/basic's order (root folds right to left:
#: acc = x[n-1], then acc = x[i] + acc for i = n-2 .. 0)
ALLREDUCE = r"""
import json, sys, time
import numpy as np, torch
import ompi_tpu_torch
w = ompi_tpu_torch.init()
n, r = w.size, w.rank
assert w.rte.device.type == "cuda" and type(
    w.c_coll["allreduce"].__self__).__name__ == "BasicCollModule"
host = [np.random.default_rng(int(sys.argv[1]) + i).standard_normal(
    4 << 20).astype(np.float32) for i in range(n)]
x = torch.from_numpy(host[r]).to(w.rte.device)
want = host[n - 1].copy()
for i in range(n - 2, -1, -1):
    np.add(host[i], want, out=want)
times = []
for _ in range(5):
    w.barrier()
    t0 = time.perf_counter()
    got = w.allreduce(x)
    times.append(time.perf_counter() - t0)
ok = isinstance(got, np.ndarray) and got.tobytes() == want.tobytes()
print(json.dumps({"rank": r, "bit_exact": ok,
                  "ms": sorted(times)[len(times) // 2] * 1e3}), flush=True)
ompi_tpu_torch.finalize()
"""


#: a -n 4 job under default selection: coll/tuned's allreduce of 16 MB of
#: integer-valued float32 a rank (a tensor on the card; any order of the
#: sum is exact), its ladder's pick (ring_segmented) and every menu entry
#: forced through the var, the staging pool's counts after the 16 MB loop,
#: libnbc's iallreduce and iallgather of card tensors, and the int8 blockq
#: allreduce on a dup with an accuracy budget, within the codec's band
TUNED = r"""
import hashlib, json, sys, time
import numpy as np, torch
import ompi_tpu_torch
from ompi_tpu_torch.base.var import registry
from ompi_tpu_torch.mca.accelerator import torch_acc
from ompi_tpu_torch.mca.coll import algorithms as algs, quant
from ompi_tpu_torch.runtime import spc
w = ompi_tpu_torch.init()
n, r = w.size, w.rank
owner = {k: type(w.c_coll[k].__self__).__name__
         for k in ("allreduce", "iallreduce", "iallgather")}
fallback = getattr(w.c_coll["allreduce"].__self__, "_fallback", None)
if fallback is not None:
    owner["allreduce above the slot"] = type(fallback).__name__
assert w.rte.device.type == "cuda", w.rte.device
host = [np.random.default_rng(int(sys.argv[1]) + i).integers(
    -1000, 1001, 4 << 20).astype(np.float32) for i in range(n)]
x = torch.from_numpy(host[r]).to(w.rte.device)
want = np.sum(host, axis=0, dtype=np.float32)


def timed(fn, reps=5):
    times = []
    for _ in range(reps):
        w.barrier()
        t0 = time.perf_counter()
        got = fn()
        times.append(time.perf_counter() - t0)
    return got, sorted(times)[len(times) // 2] * 1e3


def exact(got, ref=want):
    return isinstance(got, np.ndarray) and got.tobytes() == ref.tobytes()


def waited(q):
    q.wait()
    return q.result


res = {"rank": r, "owner": owner}
torch_acc.staging.clear()
s0 = {k: spc.read(k) for k in ("fastpath_staging_hits",
                               "fastpath_staging_misses")}
got, ms = timed(lambda: w.allreduce(x))
res["ladder"] = {"alg": "ring_segmented", "ms": ms, "bit_exact": exact(got)}
res["staging"] = {"hits": torch_acc.staging.hits,
                  "misses": torch_acc.staging.misses,
                  **{k: spc.read(k) - v for k, v in s0.items()}}
forced = {}
for alg in sorted(algs.ALLREDUCE):
    registry.set("otpu_coll_tuned_allreduce_algorithm", alg)
    got, ms = timed(lambda: w.allreduce(x))
    forced[alg] = {"ms": ms, "bit_exact": exact(got)}
registry.set("otpu_coll_tuned_allreduce_algorithm", "")
res["forced"] = forced
got, ms = timed(lambda: waited(w.iallreduce(x)))
res["iallreduce"] = {"ms": ms, "bit_exact": exact(got)}
part = x[:1 << 18]                          # 1 MB a rank
got, ms = timed(lambda: waited(w.iallgather(part)))
res["iallgather_1MB"] = {"ms": ms, "bit_exact": exact(
    got, np.stack([h[:1 << 18] for h in host]))}
c = w.dup()
c.info.set("otpu_quant_budget", "0.02")
e0 = spc.read("quant_encodes")
got, ms = timed(lambda: c.allreduce(x))
res["blockq_int8"] = {
    "ms": ms, "band": quant.CODEC_BANDS["int8"],
    "rel_err": float(np.abs(got.astype(np.float64) - want).max()
                     / np.abs(want).max()),
    "encodes": spc.read("quant_encodes") - e0,
    "digest": hashlib.sha256(got.tobytes()).hexdigest()[:16]}
print(json.dumps(res), flush=True)
ompi_tpu_torch.finalize()
"""

#: the owners of the default-selection job's slots with the native core:
#: coll/sm holds the allreduce and hands 16 MB on to coll/tuned
TUNED_OWNERS = {"allreduce": "SmCollModule", "iallreduce": "LibnbcModule",
                "iallgather": "LibnbcModule",
                "allreduce above the slot": "TunedModule"}

#: a -n 4 --fake-nodes 2 job: coll/han's allreduce (the symmetric fast
#: path: reduce_scatter on the node, allreduce across, allgather on the
#: node) and bcast from a root that is not its node's leader, of tensors on
#: the card, exact against numpy on every rank
HAN = r"""
import json, sys, time
import numpy as np, torch
import ompi_tpu_torch
w = ompi_tpu_torch.init()
n, r = w.size, w.rank
assert w.rte.device.type == "cuda" and type(
    w.c_coll["allreduce"].__self__).__name__ == "HanModule"
host = [np.random.default_rng(int(sys.argv[1]) + i).integers(
    -1000, 1001, 4 << 20).astype(np.float32) for i in range(n)]
x = torch.from_numpy(host[r]).to(w.rte.device)
want = np.sum(host, axis=0, dtype=np.float32)
b = x if r == 1 else torch.zeros_like(x)
res = {"rank": r}
for name, fn, ref in (("allreduce", lambda: w.allreduce(x), want),
                      ("bcast_root1", lambda: w.bcast(b, root=1), host[1])):
    times = []
    for _ in range(5):
        w.barrier()
        t0 = time.perf_counter()
        got = fn()
        times.append(time.perf_counter() - t0)
    res[name] = {"ms": sorted(times)[2] * 1e3,
                 "bit_exact": isinstance(got, np.ndarray)
                 and got.tobytes() == ref.tobytes()}
mod = w.c_coll["allreduce"].__self__
res["sub_sizes"] = [c.size for c in (mod._low, mod._up, mod._leaders)
                    if c is not None]
res["eps"] = {p: w.pml.bml.endpoint(p).btl.name for p in range(n) if p != r}
print(json.dumps(res), flush=True)
ompi_tpu_torch.finalize()
"""

#: a -n 4 job: coll/sm's allreduce and bcast (root 2) of 1 MB float32 card
#: tensors a rank (integer-valued: any order of the sum is exact), checked
#: bit for bit on every rank before they are timed; the owner of each slot
#: is printed, so the same script runs under ``--mca coll ^sm_coll``
SMCOLL = r"""
import json, sys, time
import numpy as np, torch
import ompi_tpu_torch
w = ompi_tpu_torch.init()
n, r = w.size, w.rank
host = [np.random.default_rng(int(sys.argv[1]) + i).integers(
    -1000, 1001, 1 << 18).astype(np.float32) for i in range(n)]
x = torch.from_numpy(host[r]).to(w.rte.device)
want = np.sum(host, axis=0, dtype=np.float32)
b = x if r == 2 else torch.zeros_like(x)
res = {"rank": r, "owner": {k: type(w.c_coll[k].__self__).__name__
                            for k in ("allreduce", "bcast")}}
for name, fn, ref in (("allreduce", lambda: w.allreduce(x), want),
                      ("bcast_root2", lambda: w.bcast(b, root=2), host[2])):
    got = fn()
    assert got.tobytes() == ref.tobytes(), name
    times = []
    for _ in range(11):
        w.barrier()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    res[name] = {"ms": sorted(times)[5] * 1e3, "bit_exact": True}
print(json.dumps(res), flush=True)
ompi_tpu_torch.finalize()
"""

#: a -n 4 --fake-nodes 2 job with ``otpu_coll_quant_wire`` set: coll/han's
#: allreduce of 4 MB of float32 a rank (a card tensor), the traffic between
#: the nodes int8-encoded on btl/tcp; its error against the float64 sum,
#: the same bytes on the ranks of a node, and ``quant.wire_stats()``
QUANTWIRE = r"""
import hashlib, json, sys, time
import numpy as np, torch
import ompi_tpu_torch
from ompi_tpu_torch.mca.coll import quant
w = ompi_tpu_torch.init()
n, r = w.size, w.rank
assert quant.wire_enabled
host = [np.random.default_rng(int(sys.argv[1]) + i).standard_normal(
    1 << 20).astype(np.float32) for i in range(n)]
x = torch.from_numpy(host[r]).to(w.rte.device)
exact = np.sum(np.array(host, np.float64), axis=0)
got = w.allreduce(x)
err = float(np.abs(got - exact).max() / np.abs(exact).max())
times = []
for _ in range(5):
    w.barrier()
    t0 = time.perf_counter()
    w.allreduce(x)
    times.append(time.perf_counter() - t0)
print(json.dumps({"rank": r, "ms": sorted(times)[2] * 1e3, "rel_err": err,
                  "digest": hashlib.sha256(got.tobytes()).hexdigest()[:16],
                  "wire": quant.wire_stats(),
                  "eps": {p: w.pml.bml.endpoint(p).btl.name
                          for p in range(n) if p != r}}), flush=True)
ompi_tpu_torch.finalize()
"""

#: float32 band of a sum of 8 rows against the exact (float64) sum: 8
#: roundings of the largest sum of magnitudes
HAN_BAND = 8 * 2.0 ** -24


def han_device(gen) -> dict:
    """coll/han's device half (``HierarchicalColl``, (n_up, n_low) = (2,
    4)) on the card: ``allreduce`` of an 8 x 16 MB float32 world tensor and
    ``reduce_scatter`` of an (8, 8, 16 MB / 8) one, each within the float32
    band of the float64 sum over the rank axis of the same input computed
    on the CPU (the plain answer of both), timed beside ``torch.sum(x, 0)``
    on the same tensor; ``bound_ms`` is the input read once and the output
    written once over 3.35 TB/s."""
    from ompi_tpu_torch.mca.coll.han import HierarchicalColl

    h = HierarchicalColl(2, 4)
    x = operands(torch.float32, (N, 16 * MB // 4), gen)
    z = operands(torch.float32, (N, N, 16 * MB // 4 // N), gen)
    out = {}
    for name, fn, arg in (("allreduce", h.allreduce, x),
                          ("reduce_scatter", h.reduce_scatter, z)):
        got = fn(arg)
        ref = arg.cpu().double().sum(0)
        require(tuple(got.shape) == tuple(ref.shape),
                f"han device {name}: shape {tuple(got.shape)}")
        err = (got.cpu().double() - ref).abs().max().item()
        band = HAN_BAND * arg.abs().sum(0).max().item()
        require(err <= band, f"han device {name}: error {err} above {band}")
        nbytes = arg.numel() * 4 + got.numel() * 4
        out[name] = {"shape": list(arg.shape), "max_abs_err": err,
                     "band": band, "ms": time_ms(lambda: fn(arg)),
                     "torch_sum_ms": time_ms(lambda: torch.sum(arg, 0)),
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    return out


def tpurun(n: int, argv: list, timeout: int = 240, env: dict = None) -> tuple:
    """Run ``argv`` under the port's tpurun (``env`` added to this
    process's environment); ({rank: lines}, wall seconds).  The job's own
    failure fails the phase."""
    lines, _, wall = tpurun_job(n, argv, timeout, env)
    return lines, wall


def tpurun_job(n: int, argv: list, timeout: int = 240,
               env: dict = None) -> tuple:
    """:func:`tpurun` that also returns the launcher's standard error:
    ({rank: lines}, stderr, wall seconds)."""
    r, lines, wall = tpurun_any(n, argv, timeout, env)
    require(r.returncode == 0, f"tpurun -n {n} {argv} exited {r.returncode}:"
            f"\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    return lines, r.stderr, wall


def tpurun_any(n: int, argv: list, timeout: int = 240,
               env: dict = None) -> tuple:
    """Run a job under the port's tpurun whatever its exit code:
    (CompletedProcess, {rank: lines}, wall seconds)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "ompi_tpu_torch.tools.tpurun",
                        "-n", str(n), *argv], capture_output=True, text=True,
                       timeout=timeout, env={**os.environ, **(env or {})})
    wall = time.perf_counter() - t0
    lines = {}
    for line in r.stdout.splitlines():
        if line.startswith("["):
            rank, _, rest = line.partition("] ")
            lines.setdefault(int(rank[1:]), []).append(rest)
    return r, lines, wall


def job_result(lines: dict, rank: int) -> dict:
    """The JSON object a rank printed last; other lines (a library's
    warnings) are logged."""
    objs = [x for x in lines.get(rank, []) if x.startswith("{")]
    other = [x for x in lines.get(rank, []) if not x.startswith("{")]
    if other:
        log(f"rank {rank} also printed: {other[-5:]}")
    require(bool(objs), f"rank {rank} printed no result: {lines.get(rank)}")
    return json.loads(objs[-1])


def host_tier(gen, smi: str) -> dict:
    """The host tier on the card's machine: point-to-point in the device
    world with a tensor on the card as the send buffer (staged through
    ``torch_acc.to_host``), then three multi-process jobs of the port's
    tpurun — the ring example, a ping-pong over btl/sm, and a coll/basic
    allreduce of tensors on the card.  No kernel runs here."""
    import tempfile

    import ompi_tpu_torch
    from ompi_tpu_torch.mca.accelerator import torch_acc
    from ompi_tpu_torch.runtime import init as rt

    # glibc's allocator settings, which decide whether a freed 16 MB block
    # goes back to the kernel (and its next use faults its pages in again)
    out = {"card": smi, "malloc_env": {k: v for k, v in os.environ.items()
                                       if k.startswith("MALLOC_")}}
    world = ompi_tpu_torch.init()
    t = operands(torch.float32, (16 * MB // 4,), gen)
    want = t.cpu().numpy()
    buf = np.empty(16 * MB // 4, np.float32)
    world.as_rank(0).send(t, dest=5, tag=1)
    st = world.as_rank(5).recv(buf, source=0, tag=1)
    require(buf.tobytes() == want.tobytes() and st._nbytes == 16 * MB
            and st.source == 0, "device world: 16 MB tensor send/recv bytes")

    def med_ms(fn, reps: int = 11) -> float:
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def send_recv():
        world.as_rank(0).send(t, dest=5, tag=2)
        world.as_rank(5).recv(buf, source=0, tag=2)

    small, sbuf = np.arange(2, dtype=np.float32), np.empty(2, np.float32)
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS * 10):
        world.as_rank(0).send(small, dest=5, tag=3)
        world.as_rank(5).recv(sbuf, source=0, tag=3)
    per_msg_us = (time.perf_counter() - t0) / (HOST_CALLS * 10) * 1e6
    out["device_world"] = {
        "send_16MB_bytes_equal": True,
        "staging_ms_16MB": med_ms(lambda: torch_acc.to_host(t)),
        "send_recv_ms_16MB": med_ms(send_recv),
        "host_us_per_msg_8B": per_msg_us}
    rt.finalize()

    lines, wall = tpurun(4, [sys.executable, "-m",
                             "ompi_tpu_torch.examples.ring"])
    ring = [f"rank 0: token now {k}" for k in range(9, -1, -1)] + \
        ["rank 0 exiting"]
    require(lines.get(0) == ring, f"ring: rank 0 printed {lines.get(0)}")
    require(all(lines.get(r) == [f"rank {r} exiting"] for r in (1, 2, 3)),
            f"ring: ranks 1-3 printed {lines}")
    out["ring_4"] = {"rank0_lines": len(ring), "wall_s": wall}

    with tempfile.TemporaryDirectory() as tmp:
        ping, coll = Path(tmp, "pingpong.py"), Path(tmp, "allreduce.py")
        tuned, han = Path(tmp, "tuned.py"), Path(tmp, "han.py")
        ping.write_text(PINGPONG)
        coll.write_text(ALLREDUCE)
        tuned.write_text(TUNED)
        han.write_text(HAN)
        lines, wall = tpurun(2, [sys.executable, str(ping)])
        out["pingpong_2"] = {**job_result(lines, 0), "wall_s": wall}
        # coll/basic alone, the figure before coll/tuned took the slot
        lines, wall = tpurun(4, ["--mca", "coll", "basic,self_coll",
                                 sys.executable, str(coll), str(SEED)])
        ranks = [job_result(lines, r) for r in range(4)]
        require(all(x["bit_exact"] for x in ranks),
                f"coll/basic allreduce of card tensors not bit-exact: {ranks}")
        out["allreduce_4_16MB"] = {"coll": "basic", "bit_exact": True,
                                   "ms_by_rank": [x["ms"] for x in ranks],
                                   "wall_s": wall}
        lines, wall = tpurun(4, [sys.executable, str(tuned), str(SEED)])
        ranks = [job_result(lines, r) for r in range(4)]
        require(all(x["owner"] == TUNED_OWNERS for x in ranks),
                f"default selection with the native core: {ranks}")
        exact = [x[k]["bit_exact"] for x in ranks
                 for k in ("ladder", "iallreduce", "iallgather_1MB")] + \
            [v["bit_exact"] for x in ranks for v in x["forced"].values()]
        require(all(exact), f"tuned/libnbc results not bit-exact: {ranks}")
        q = [x["blockq_int8"] for x in ranks]
        require(all(0 < v["rel_err"] <= v["band"] and v["encodes"] == 5
                    for v in q) and len({v["digest"] for v in q}) == 1,
                f"blockq int8 outside its band or ranks disagree: {q}")
        out["tuned_4_16MB"] = {
            "bit_exact": True, "wall_s": wall,
            "ms_by_rank": {k: [x[k]["ms"] for x in ranks]
                           for k in ("ladder", "iallreduce",
                                     "iallgather_1MB", "blockq_int8")},
            "forced_ms_by_rank": {a: [x["forced"][a]["ms"] for x in ranks]
                                  for a in ranks[0]["forced"]},
            "blockq_int8_rel_err": max(v["rel_err"] for v in q),
            "staging_by_rank": [x["staging"] for x in ranks]}
        lines, wall = tpurun(4, ["--fake-nodes", "2", sys.executable,
                                 str(han), str(SEED)])
        ranks = [job_result(lines, r) for r in range(4)]
        require(all(x[k]["bit_exact"] for x in ranks
                    for k in ("allreduce", "bcast_root1")),
                f"coll/han results not bit-exact: {ranks}")
        require(all(x["eps"] == HAN_EPS[x["rank"]] for x in ranks),
                f"han job: not sm within a node and tcp between: {ranks}")
        out["han_4_fake2_16MB"] = {
            "bit_exact": True, "wall_s": wall,
            "ms_by_rank": {k: [x[k]["ms"] for x in ranks]
                           for k in ("allreduce", "bcast_root1")},
            "sub_sizes_by_rank": [x["sub_sizes"] for x in ranks]}
    out["han_device"] = han_device(gen)
    log(json.dumps({"host_tier": out}))
    return out


#: -n 4 --fake-nodes 2: each rank's transport to every peer (nodes 0-1, 2-3)
HAN_EPS = {0: {"1": "sm", "2": "tcp", "3": "tcp"},
           1: {"0": "sm", "2": "tcp", "3": "tcp"},
           2: {"0": "tcp", "1": "tcp", "3": "sm"},
           3: {"0": "tcp", "1": "tcp", "2": "sm"}}


def strided_type():
    """``pack_figure``'s datatype, every other float32 of 32 MB, with the
    convertor's description of it built (the datatype engine's Python
    takes ~30 s of host time for these 4M elements; ``main`` builds it in
    a thread while nvcc runs, and nothing is timed until it is done)."""
    from ompi_tpu_torch.datatype import convertor as cv
    from ompi_tpu_torch.datatype import core

    dt = core.vector(4 * MB, 1, 2, core.FLOAT32)
    cv.Convertor(dt, 1)
    return dt


def pack_figure(dt) -> dict:
    """The convertor's pack of a 16 MB strided float32 vector (``dt``, every
    other element of 32 MB), through the native core (a whole-element job
    above ``_POOL_PACK_MIN`` fans out over ``threads/native``'s workers)
    beside the numpy lane, bytes equal before either is timed; median ms
    of 5."""
    from ompi_tpu_torch.datatype import convertor as cv

    mem = np.random.default_rng(SEED).standard_normal(
        8 * MB).astype(np.float32).view(np.uint8)

    def pack(use_native: bool) -> np.ndarray:
        c = cv.Convertor(dt, 1)
        c.prepare(mem)
        c._native = use_native
        return c.pack()

    want = mem.view(np.float32)[::2].tobytes()
    require(pack(True).tobytes() == want and pack(False).tobytes() == want,
            "convertor pack of the strided vector: bytes differ")
    out = {"packed_bytes": len(want)}
    for lane, flag in (("native", True), ("numpy", False)):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            pack(flag)
            times.append((time.perf_counter() - t0) * 1e3)
        out[f"{lane}_ms"] = statistics.median(times)
    return out


def host_transports(smi: str, strided, sm_native: dict) -> dict:
    """The host transports on the card's machine: the native core and its
    reactor must be there (a job that falls back to the pure-Python lane is
    a failure, not a quieter row); the ``-n 2`` ping-pong over btl/sm and
    over btl/tcp (``--mca btl tcp,self``), each with the native core on
    and with ``OTPU_NATIVE_DISABLE=1``, in this run; coll/sm's allreduce
    and bcast of 1 MB card tensors at ``-n 4`` beside coll/tuned (``--mca
    coll ^sm_coll``); the quantized wire's 4 MB allreduce across ``--fake-
    nodes 2``; the convertor's pack of a 16 MB strided vector (the datatype
    ``strided``).  The sm ping-pong with the native core on is
    ``host_tier``'s job, the same command: ``sm_native`` is its result.  One
    ``host_transports`` line."""
    import tempfile

    from ompi_tpu_torch import native
    from ompi_tpu_torch.runtime import reactor

    require(native.available(), "the native core is not available: "
            + native.unavailable_reason())
    require(reactor.engage() and reactor.active(),
            "the native progress reactor did not engage")
    reactor.shutdown()
    out = {"card": smi, "native_core": native.library_path().name}
    pure = {"OTPU_NATIVE_DISABLE": "1"}
    with tempfile.TemporaryDirectory() as tmp:
        ping, smcoll = Path(tmp, "pingpong.py"), Path(tmp, "smcoll.py")
        qwire = Path(tmp, "quantwire.py")
        ping.write_text(PINGPONG)
        smcoll.write_text(SMCOLL)
        qwire.write_text(QUANTWIRE)
        lanes = {}
        for name, btl, args, env in (
                ("sm_native", "sm", [], {}), ("sm_pure", "sm", [], pure),
                ("tcp_native", "tcp", ["--mca", "btl", "tcp,self"], {}),
                ("tcp_pure", "tcp", ["--mca", "btl", "tcp,self"], pure)):
            if name == "sm_native":
                res, wall = sm_native, sm_native["wall_s"]
            else:
                lines, wall = tpurun(2, [*args, sys.executable, str(ping)],
                                     env=env)
                res = job_result(lines, 0)
            on = not env
            require(res["btl"] == btl and res["native"] is on
                    and res["reactor"] is on,
                    f"ping-pong {name}: lane {res['btl']}, native "
                    f"{res['native']}, reactor {res['reactor']}")
            lanes[name] = {k: res[k] for k in (
                "latency_us_8B", "bandwidth_MBps_4MB", "one_way_ms_4MB")}
            lanes[name]["wall_s"] = wall
        out["pingpong_2"] = lanes
        for name, args, owner in (
                ("sm_coll", [], "SmCollModule"),
                ("tuned", ["--mca", "coll", "^sm_coll"], "TunedModule")):
            lines, wall = tpurun(4, [*args, sys.executable, str(smcoll),
                                     str(SEED)])
            ranks = [job_result(lines, r) for r in range(4)]
            require(all(x["owner"] == {"allreduce": owner, "bcast": owner}
                        and x["allreduce"]["bit_exact"]
                        and x["bcast_root2"]["bit_exact"] for x in ranks),
                    f"1 MB collectives under {name}: {ranks}")
            out[f"coll_1MB_{name}"] = {
                "ms_by_rank": {k: [x[k]["ms"] for x in ranks]
                               for k in ("allreduce", "bcast_root2")},
                "wall_s": wall}
        lines, wall = tpurun(4, ["--fake-nodes", "2", "--mca",
                                 "otpu_coll_quant_wire", "1", sys.executable,
                                 str(qwire), str(SEED)])
        ranks = [job_result(lines, r) for r in range(4)]
        orig = sum(x["wire"]["orig"] for x in ranks)
        enc = sum(x["wire"]["enc"] for x in ranks)
        # each node's ranks agree; the nodes differ, as in the JAX package
        # (each leader adds its own exact part to the other's decoded one)
        require(all(x["rel_err"] <= 1 / 127 for x in ranks)
                and ranks[0]["digest"] == ranks[1]["digest"]
                and ranks[2]["digest"] == ranks[3]["digest"] and enc > 0
                and all(x["eps"] == HAN_EPS[x["rank"]] for x in ranks),
                f"the quantized wire's allreduce: {ranks}")
        out["quant_wire_4_fake2_4MB"] = {
            "ms_by_rank": [x["ms"] for x in ranks],
            "orig_over_enc": orig / enc,
            "rel_err": max(x["rel_err"] for x in ranks),
            "wire_bytes_by_rank": [x["wire"] for x in ranks],
            "wall_s": wall}
    out["pack_16MB_strided"] = pack_figure(strided)
    log(json.dumps({"host_transports": out}))
    return out


#: the RGET ping-pong: ``-n 2``, card tensors as the send buffers (staged to
#: the host), numpy receive buffers, at 4 and 16 MB; the lanes in turns,
#: twice: ``argv[1]`` set to ``argv[2]`` (the job's lane) and to ``argv[3]``
#: (ob1 reads its RGET vars at every send).  The first pass warms the
#: host's allocator and the segment pool for both; each rank asserts the
#: payload and reports each lane's btl and ``rget_msgs`` in both passes
RGET_PINGPONG = r"""
import json, sys, time
import numpy as np, torch
import ompi_tpu_torch
from ompi_tpu_torch.base.var import registry
from ompi_tpu_torch.runtime import spc
w = ompi_tpu_torch.init()
peer = 1 - w.rank
for npass, lane in ((1, "job"), (1, "set"), (2, "job"), (2, "set")):
    registry.set(sys.argv[1], sys.argv[2] if lane == "job" else sys.argv[3])
    rgets = spc.read("rget_msgs")
    one_way = {}
    for size, rounds in ((4 << 20, 20), (16 << 20, 10)):
        t = torch.arange(size // 4, dtype=torch.float32, device=w.rte.device)
        t += w.rank
        b = np.empty(size // 4, np.float32)
        want = np.arange(size // 4, dtype=np.float32) + peer
        for i in range(2 + rounds):
            if i == 2:
                w.barrier()
                t0 = time.perf_counter()
            if w.rank == 0:
                w.send(t, 1, 7)
                w.recv(b, 1, 7)
            else:
                w.recv(b, 0, 7)
                w.send(t, 0, 7)
            assert b.tobytes() == want.tobytes(), f"{size} B payload"
        one_way[size] = (time.perf_counter() - t0) / rounds / 2
    print(json.dumps({"pass": npass, "lane": lane, "rank": w.rank,
                      "btl": w.pml.bml.endpoint(peer).btl.name,
                      "rget_msgs": spc.read("rget_msgs") - rgets,
                      "one_way_ms": {str(k): v * 1e3
                                     for k, v in one_way.items()},
                      "MBps": {str(k): k / v / 1e6
                               for k, v in one_way.items()}}), flush=True)
ompi_tpu_torch.finalize()
"""

#: a ``-n 4`` window of ``argv[1]`` bytes of float32 a rank (``argv[2]`` the
#: seed): one fence
#: epoch of puts to the right neighbour, 50 SUM accumulates a rank into
#: rank 0, a fetch_and_op ticket, an exclusive-lock CAS loop and one PSCW
#: epoch (left exposes, right accesses); integer-valued data, so every
#: order of the accumulates gives the same bits; each rank holds its window
#: bit for bit against numpy
RMA = r"""
import json, sys, time
import numpy as np
import ompi_tpu_torch
from ompi_tpu_torch.api.group import Group
w = ompi_tpu_torch.init()
r, n = w.rank, w.size
count = int(sys.argv[1]) // 4
rng = np.random.default_rng(int(sys.argv[2]))
rows = rng.integers(-1000, 1000, (n, count)).astype(np.float32)
acc = rng.integers(-8, 8, (n, 4096)).astype(np.float32)
left, right = (r - 1) % n, (r + 1) % n
win = ompi_tpu_torch.Win.create(w, size=count, dtype=np.float32)
ms = {}


def epoch(name, fn):
    w.barrier()
    t0 = time.perf_counter()
    fn()
    ms[name] = (time.perf_counter() - t0) * 1e3


def puts():
    win.fence()
    win.put(rows[r], right)
    win.fence()


def accumulates():
    for _ in range(50):
        win.accumulate(acc[r], 0, offset=0)
    win.fence()


def ticket():
    ms["ticket"] = int(win.fetch_and_op(1, 0, offset=count - 1))
    win.fence()


def cas_loop():
    for _ in range(10):
        win.lock(0, win.LOCK_EXCLUSIVE)
        while True:
            cur = win.get(1, 0, offset=count - 2)[0]
            if win.compare_and_swap(cur + 1, cur, 0, offset=count - 2) == cur:
                break
        win.unlock(0)
    w.barrier()


def pscw():
    win.post(Group([w.group.world_rank(left)]))
    win.start(Group([w.group.world_rank(right)]))
    win.put(np.full(8, 5000 + r, np.float32), right, offset=8192)
    win.complete()
    win.wait()


for name, fn in (("put_fence", puts), ("acc50_fence", accumulates),
                 ("fetch_and_op", ticket), ("cas_loop_x10", cas_loop),
                 ("pscw", pscw)):
    epoch(name, fn)
tickets = sorted(int(np.ravel(x)[0]) for x in np.asarray(
    w.allgather(np.array([ms.pop("ticket")], np.int64))))
want = rows[left].copy()
want[8192:8200] = 5000 + left
if r == 0:
    want[:4096] += 50 * acc.sum(0)
    want[count - 1] += n
    want[count - 2] += 10 * n
base = int(rows[n - 1][count - 1])
print(json.dumps({"rank": r, "module": type(win.module).__name__,
                  "bit_exact": win.local.tobytes() == want.tobytes(),
                  "tickets": tickets == list(range(base, base + n)),
                  "ms": ms}), flush=True)
win.free()
ompi_tpu_torch.finalize()
"""


def device_window() -> dict:
    """osc/device at full width: the device world's window, 8 ranks x 16 MB
    of float32 a row, on the card.  A round of puts, SUM and MAX
    accumulates, get_accumulate and compare_and_swap (a match and a miss),
    held bit for bit against the same updates made by plain torch on a copy
    of the window; host µs per call (20 calls, ending in a sync)."""
    import ompi_tpu_torch

    world = ompi_tpu_torch.init()
    dev = world.rte.device
    count = 16 * MB // 4
    win = ompi_tpu_torch.Win.create(world, size=count, dtype=np.float32,
                                    device=True)
    require(type(win.module).__name__ == "DeviceModule"
            and isinstance(win.device_array, torch.Tensor)
            and win.device_array.device == dev
            and tuple(win.device_array.shape) == (N, count),
            f"device window: {win.module}, {type(win.device_array)}")
    plain = win.device_array.clone()
    k = MB // 4                                       # 1 MB an update
    rng = np.random.default_rng(SEED)
    vals = [rng.standard_normal(k).astype(np.float32) for _ in range(3)]
    dvals = [torch.from_numpy(v).to(dev) for v in vals]
    for r in range(N):
        off = r * 4096
        win.put(vals[0], r, offset=off)
        plain[r, off:off + k] = dvals[0]
        win.accumulate(vals[1], r, offset=off + 7)
        plain[r, off + 7:off + 7 + k] += dvals[1]
        win.accumulate(vals[2], r, offset=off + 100, op=ompi_tpu_torch.MAX)
        sl = plain[r, off + 100:off + 100 + k]
        sl.copy_(torch.maximum(sl, dvals[2]))
        old = win.get_accumulate(vals[2], (r + 1) % N, offset=off)
        want_old = plain[(r + 1) % N, off:off + k].cpu().numpy().copy()
        plain[(r + 1) % N, off:off + k] += dvals[2]
        require(old.tobytes() == want_old.tobytes(),
                f"device window: get_accumulate's old values, rank {r}")
        cur = float(plain[r, count - 1])
        hit = win.compare_and_swap(float(r + 1), cur, r, offset=count - 1)
        miss = win.compare_and_swap(99.0, cur - 1, r, offset=count - 1)
        plain[r, count - 1] = float(r + 1)
        require(hit == cur and miss == r + 1,
                f"device window: compare_and_swap at rank {r}")
    torch.cuda.synchronize()
    require(torch.equal(win.device_array, plain),
            "device window: the window differs from the plain updates")
    us = {}
    for name, fn in (
            ("put_1MB", lambda: win.put(vals[0], 3, offset=0)),
            ("accumulate_sum_1MB", lambda: win.accumulate(vals[1], 3)),
            ("accumulate_max_1MB", lambda: win.accumulate(
                vals[2], 3, op=ompi_tpu_torch.MAX)),
            ("get_1MB", lambda: win.get(k, 3)),
            ("get_accumulate_1MB", lambda: win.get_accumulate(vals[1], 3)),
            ("compare_and_swap", lambda: win.compare_and_swap(1.0, 0.0, 3))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        us[name] = (time.perf_counter() - t0) / 20 * 1e6
    win.free()
    from ompi_tpu_torch.runtime import init as rt

    rt.finalize()
    return {"ranks": N, "row_bytes": count * 4, "bit_exact": True,
            "host_us_per_call": us}


def one_sided(smi: str) -> dict:
    """The one-sided rung on the card's machine: osc/device's window at full
    width (``device_window``); the ``-n 2`` ping-pong of card tensors at 4
    and 16 MB in four lanes (btl/sm with RGET, the default; btl/sm with
    ``pml_ob1_rget_limit 0``; btl/tcp with ``pml_ob1_rget_emulate 1``;
    btl/tcp without it), each lane's ``rget_msgs`` non-zero exactly where it
    is named for RGET; a ``-n 4`` osc/rdma window of 16 MB of float32 a
    rank (``RMA``); the same job at 1 MB across ``--fake-nodes 2``, where
    osc/pt2pt serves.  The module of each rank is asserted, each window
    bit for bit.  One ``one_sided`` line with the card's name and power
    limit, ms per epoch by rank and each job's wall seconds."""
    import tempfile

    out = {"card": smi, "device_window_8x16MB": device_window()}
    with tempfile.TemporaryDirectory() as tmp:
        ping, rma = Path(tmp, "rget.py"), Path(tmp, "rma.py")
        ping.write_text(RGET_PINGPONG)
        rma.write_text(RMA)
        lanes = {}
        for btl, args, var, values, names in (
                ("sm", [], "otpu_pml_ob1_rget_limit", ("512k", "0"),
                 ("sm_rget", "sm_rget_off")),
                ("tcp", ["--mca", "btl", "tcp,self"],
                 "otpu_pml_ob1_rget_emulate", ("0", "1"),
                 ("tcp_frag", "tcp_emulated_pull"))):
            lines, wall = tpurun(2, [*args, sys.executable, str(ping), var,
                                     *values])
            results = [json.loads(y) for r in range(2)
                       for y in lines.get(r, []) if y.startswith("{")]
            for lane, name in zip(("job", "set"), names):
                rget = name.endswith(("_rget", "_pull"))
                both = [x for x in results if x["lane"] == lane]
                require(len(both) == 4 and all(
                            x["btl"] == btl and (x["rget_msgs"] > 0) is rget
                            for x in both),
                        f"RGET lane {name} ran another protocol: {both}")
                ranks = sorted((x for x in both if x["pass"] == 2),
                               key=lambda x: x["rank"])
                lanes[name] = {"rget_msgs": [x["rget_msgs"] for x in ranks],
                               "one_way_ms_rank0": ranks[0]["one_way_ms"],
                               "MBps_rank0": ranks[0]["MBps"]}
            lanes[f"{btl}_job_wall_s"] = wall
        out["pingpong_2"] = lanes
        for name, args, nbytes, module in (
                ("rdma_4_16MB", [], 16 * MB, "RdmaModule"),
                ("pt2pt_4_fake2_1MB", ["--fake-nodes", "2"], MB,
                 "Pt2ptModule")):
            lines, wall = tpurun(4, [*args, sys.executable, str(rma),
                                     str(nbytes), str(SEED)])
            ranks = [job_result(lines, r) for r in range(4)]
            require(all(x["module"] == module and x["bit_exact"]
                        and x["tickets"] for x in ranks),
                    f"window job {name}: {ranks}")
            out[name] = {"module": module,
                         "ms_by_rank": [x["ms"] for x in ranks],
                         "wall_s": wall}
    log(json.dumps({"one_sided": out}))
    return out


#: the observability phase's -n 2 ping-pong of card tensors: 8 B (eager;
#: 40 warm-up round trips, then 400 timed, whose stage clocks are taken
#: apart from the rest), then 64 KB (rendezvous) and 4 MB (RGET over
#: btl/sm); rank 0 prints the 8 B one-way µs, the 8 B stage table and the
#: whole run's
OBS_PINGPONG = r"""
import json, sys, time
import numpy as np, torch
import ompi_tpu_torch
from ompi_tpu_torch.runtime import profile, trace
w = ompi_tpu_torch.init()
peer = 1 - w.rank
assert trace.enabled and profile.enabled


def rounds(size, count):
    a = torch.full((size // 4,), float(w.rank + 1), device="cuda")
    b = np.empty(size // 4, np.float32)
    for _ in range(count):
        if w.rank == 0:
            w.send(a, 1, 7)
            w.recv(b, 1, 7)
        else:
            w.recv(b, 0, 7)
            w.send(a, 0, 7)
    assert np.all(b == peer + 1), "ping-pong payload"


def delta(old, new):
    # the timed rounds' stage populations (min/max clamps: the run's)
    out = {}
    for k, (n, total, lo, hi, bins) in new.items():
        n0, total0, _, _, bins0 = old.get(k, (0, 0, 0, 0, {}))
        if n > n0:
            out[k] = (n - n0, total - total0, lo, hi,
                      {d: c - bins0.get(d, 0) for d, c in bins.items()
                       if c > bins0.get(d, 0)})
    return out


rounds(8, 40)
before = profile.stage_snapshot()
t0 = time.perf_counter()
rounds(8, 400)
one_way_us = (time.perf_counter() - t0) / 400 / 2 * 1e6
stages_8 = profile.stage_stats(delta(before, profile.stage_snapshot()))
rounds(64 << 10, 40)
rounds(4 << 20, 10)
print(json.dumps({"btl": w.pml.bml.endpoint(peer).btl.name,
                  "one_way_us_8B": one_way_us, "stages_8B": stages_8,
                  "stages": profile.stage_stats()}), flush=True)
ompi_tpu_torch.finalize()
"""

#: the observability phase's -n 4 job with monitoring, the telemetry
#: sampler and the sampling profiler on: each rank sends card tensors of
#: (r + 1) * 1000 float32 to its right neighbour and 8 float32 to its left,
#: then allreduces a card tensor of 256 K float32 five times; it prints how
#: much its row of the p2p matrix grew over the sends, the bytes it sent,
#: its coll counters and its sample counts
OBS_MONITOR = r"""
import json, sys, time
import numpy as np, torch
import ompi_tpu_torch
from ompi_tpu_torch.runtime import monitoring, profile, spc, telemetry
w = ompi_tpu_torch.init()
r, n = w.rank, w.size
assert monitoring.enabled() and telemetry.enabled
right, left = (r + 1) % n, (r - 1) % n
# init's own coordination messages are in the matrix already: the row's
# growth over the sends is what they added
_, before = monitoring.p2p_matrix(n)
big = torch.arange((r + 1) * 1000, dtype=torch.float32, device="cuda")
small = torch.full((8,), float(r), device="cuda")
reqs = [w.isend(big, right, 1), w.isend(small, left, 2)]
got_big = np.empty(((left + 1) * 1000,), np.float32)
got_small = np.empty(8, np.float32)
w.recv(got_big, left, 1)
w.recv(got_small, right, 2)
for q in reqs:
    q.wait()
assert got_big.tolist() == list(range((left + 1) * 1000)), "big payload"
assert np.all(got_small == right), "small payload"
msgs, byts = monitoring.p2p_matrix(n)
grew = (byts[r] - before[r]).tolist()
sent = {right: big.nbytes, left: small.nbytes}
x = torch.ones(256 * 1024, dtype=torch.float32, device="cuda")
for _ in range(5):
    out = w.allreduce(x)
# the sampler publishes every 100 ms and the profiler ticks every 10 ms on
# their own threads: wait (no traffic, so the ranks stay in step) for both
deadline = time.perf_counter() + 20
while (spc.read("telemetry_samples") < 3 or spc.read("profile_samples") < 10) \
        and time.perf_counter() < deadline:
    time.sleep(0.05)
coll = monitoring.coll_counters()
print(json.dumps({
    "p2p_row_grew": grew, "p2p_msgs_row": msgs[r].tolist(),
    "sent": {str(k): v for k, v in sent.items()},
    "allreduce": list(coll["allreduce"]), "x_nbytes": x.nbytes,
    "result_ok": bool(np.all(np.asarray(out) == n)),
    "telemetry_samples": spc.read("telemetry_samples"),
    "profile_samples": spc.read("profile_samples")}), flush=True)
ompi_tpu_torch.finalize()
"""

#: calls a round of the host-µs comparison of the trace wrapper
OBS_HOST_CALLS = 500
OBS_ROUNDS = 5


def ring_defaults() -> None:
    """Re-apply coll/ring's defaults through the environment: a value an
    earlier phase put there stays in the registry after it is deleted (an
    absent variable changes nothing), and the main path's first world must
    run at the default priorities."""
    from ompi_tpu_torch.base.var import registry

    for name in ("priority", "bidirectional", "wire16"):
        var = registry.lookup(f"otpu_coll_ring_{name}")
        os.environ[f"OTPU_MCA_coll_ring_{name}"] = str(int(var.default))


def observability(smi: str, gen, main_launched: dict,
                  comm_launched: dict) -> dict:
    """The observability runtime on the card's machine (see phase 8 of the
    module docstring).  Returns the ``observability`` line's object."""
    import tempfile

    import ompi_tpu_torch
    from ompi_tpu_torch.base.var import registry
    from ompi_tpu_torch.runtime import init as rt
    from ompi_tpu_torch.runtime import trace

    t_phase = time.perf_counter()
    out = {"card": smi}
    with tempfile.TemporaryDirectory() as tmp:
        registry.set("otpu_trace_dir", str(Path(tmp, "device")))
        registry.set("otpu_trace_enable", True)
        trace.reset_for_testing()
        try:
            log("observability: the main path and the comm path again, with "
                "tracing on")
            ring_defaults()
            traced_main = main_path(gen)
            traced_comm, _ = comm_path(gen, timed=False)
            cats = {}
            for ev in trace.chrome_events():
                cats[ev["cat"]] = cats.get(ev["cat"], 0) + 1
        finally:
            registry.set("otpu_trace_enable", False)
            trace.reset_for_testing()
        for what, got, want in (("main", traced_main, main_launched),
                                ("comm", traced_comm, comm_launched)):
            require(got == want, f"the {what} path with tracing on launched "
                    f"{got}, with it off {want}")
        require(cats.get("device", 0) > 0 and cats.get("coll", 0) > 0,
                f"tracing recorded no device or coll span: {cats}")
        out["traced_paths"] = {"same_launches": True, "spans_by_category":
                               cats, "captured_movers": "passed"}

        # host µs a call of allreduce_array: through the wrapper (tracing
        # off), on the wrapped slot, and with tracing on, in turns
        ring_defaults()
        world = ompi_tpu_torch.init()
        require(owner(world, "allreduce_array") == "BuiltinCollModule",
                "the default owner of allreduce_array is not coll/builtin")
        x = operands(torch.float32, (N, 512), gen)
        wrapped = world.c_coll["allreduce_array"]
        inner = wrapped.__wrapped__
        require(wrapped.__self__ is inner.__self__,
                "the trace wrapper lost its slot's __self__")
        ways = {"wrapper_off": lambda: world.allreduce_array(x),
                "direct": lambda: inner(world, x),
                "wrapper_on": lambda: world.allreduce_array(x)}
        per = {k: [] for k in ways}
        for _ in range(OBS_ROUNDS):
            for name, fn in ways.items():
                on = name == "wrapper_on"
                registry.set("otpu_trace_enable", on)
                trace.reset_for_testing()
                per[name].append(host_us(fn, OBS_HOST_CALLS))
        registry.set("otpu_trace_enable", False)
        trace.reset_for_testing()
        rt.finalize()
        for name in ("priority", "bidirectional", "wire16"):
            del os.environ[f"OTPU_MCA_coll_ring_{name}"]
        med = {k: statistics.median(v) for k, v in per.items()}
        out["allreduce_array_host_us"] = {
            "median": med, "rounds": per,
            "wrapper_off_minus_direct": med["wrapper_off"] - med["direct"],
            "wrapper_on_minus_direct": med["wrapper_on"] - med["direct"],
            "shape": [N, 512], "calls_a_round": OBS_HOST_CALLS}

        # -n 2 ping-pongs of card tensors with tracing and the stage clocks
        ping = Path(tmp, "obs_ping.py")
        ping.write_text(OBS_PINGPONG)
        lanes = {}
        for btl, args in (("sm", []), ("tcp", ["--mca", "btl", "tcp,self"])):
            tdir = Path(tmp, f"trace_{btl}")
            lines, stderr, wall = tpurun_job(2, [
                *args, "--mca", "otpu_trace_enable", "1",
                "--mca", "otpu_profile_stages", "1",
                "--mca", "otpu_trace_dir", str(tdir),
                sys.executable, str(ping)])
            res = job_result(lines, 0)
            require(res["btl"] == btl, f"ping-pong ran over {res['btl']}")
            merged_path = tdir / "trace_merged.json"
            require(merged_path.exists() and (tdir / "trace_skew.txt")
                    .exists(), f"no merged timeline over {btl}: {stderr}")
            merged = json.loads(merged_path.read_text())["traceEvents"]
            starts = sorted(e["id"] for e in merged
                            if e["ph"] == "s" and e["name"] == "pml_msg")
            finishes = sorted(e["id"] for e in merged
                              if e["ph"] == "f" and e["name"] == "pml_msg")
            require(starts and starts == finishes,
                    f"unmatched pml_msg flows over {btl}: {len(starts)} "
                    f"starts, {len(finishes)} finishes")
            lanes[btl] = {
                "one_way_us_8B_rank0": res["one_way_us_8B"],
                "stages_8B_rank0": res["stages_8B"],
                "stages_rank0": {k: {"n": v["n"],
                                     "p50_us": v.get("p50_us"),
                                     "mean_us": v["mean_us"]}
                                 for k, v in res["stages"].items()},
                "merged_timeline": str(merged_path.relative_to(tmp)),
                "flows_matched": len(starts), "events": len(merged),
                "wall_s": wall}
        out["pingpong_2"] = lanes

        # -n 4 with monitoring, the sampler and the profiler
        mon = Path(tmp, "obs_monitor.py")
        mon.write_text(OBS_MONITOR)
        lines, stderr, wall = tpurun_job(4, [
            "--mca", "otpu_monitoring_enable", "1",
            "--mca", "otpu_telemetry_interval_ms", "100",
            "--mca", "otpu_profile_interval_ms", "10",
            sys.executable, str(mon)])
        ranks = [job_result(lines, r) for r in range(4)]
        for r, res in enumerate(ranks):
            want_row = [res["sent"].get(str(d), 0) for d in range(4)]
            require(res["p2p_row_grew"] == want_row,
                    f"rank {r}'s monitored p2p bytes {res['p2p_row_grew']}, "
                    f"sent {want_row}")
            calls = res["allreduce"][0]
            require(res["allreduce"][1] == calls * res["x_nbytes"]
                    and calls >= 5 and res["result_ok"],
                    f"rank {r}'s monitored allreduce {res['allreduce']}")
            require(res["telemetry_samples"] > 0
                    and res["profile_samples"] > 0,
                    f"rank {r} took no telemetry or profile sample: {res}")
        merged = [x for x in stderr.splitlines() if x.startswith(
            ("tpurun: monitoring: job-wide", "  "))]
        require(merged and merged[0].startswith(
            "tpurun: monitoring: job-wide p2p matrix (4 ranks, 4 reporting"),
            f"the launcher printed no merged matrix: {stderr[-2000:]}")
        out["monitor_4"] = {
            "p2p_rows_grew": [x["p2p_row_grew"] for x in ranks],
            "allreduce": [x["allreduce"] for x in ranks],
            "telemetry_samples": [x["telemetry_samples"] for x in ranks],
            "profile_samples": [x["profile_samples"] for x in ranks],
            "merged": merged, "wall_s": wall}
    out["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"observability": out}))
    return out


FT_JOB = r"""
import hashlib, json, os, sys, time
import numpy as np, torch
import ompi_tpu_torch
from ompi_tpu_torch.api.errhandler import ERRORS_RETURN
from ompi_tpu_torch.api.errors import ProcFailedError
from ompi_tpu_torch.ft import propagator
from ompi_tpu_torch.ft import state as ft_state

w = ompi_tpu_torch.init()
w.set_errhandler(ERRORS_RETURN)
mode = sys.argv[1]
big = torch.arange(4 << 20, dtype=torch.float32, device="cuda")   # 16 MB
w.barrier()
out = {"rank": w.rank}
if w.rank == 0 and mode == "sm":
    # the 16 MB card tensor to the rank about to die: its request holds the
    # staged copy and, over sm, an RGET exposure no one will pull
    req = w.isend(big, dest=1, tag=3)
    w.send(np.zeros(1), dest=1, tag=4)
if w.rank == 1:
    if mode == "sm":
        w.recv(np.zeros(1), source=0, tag=4)
    if mode == "detector":
        # a hang: alive, but the emitter stops without its tombstone
        w.rte.modex_put("t_gone", time.time())
        propagator._detector._stop.set()
        time.sleep(5)
        os._exit(0)
    w.rte.modex_put("t_gone", time.time())
    os._exit(9)
deadline = time.time() + 60
while not ft_state.is_failed(1):
    assert time.time() < deadline, "the failure of rank 1 was never detected"
    time.sleep(0.002)
out["detect_s"] = time.time() - w.rte.modex_get(1, "t_gone")
if w.rank == 0 and mode == "sm":
    try:
        req.wait()
        raise AssertionError("the send to the dead rank completed")
    except ProcFailedError:
        pass
    bml = w.pml.bml
    out["exposed_after"] = sum(len(getattr(b, "_exposed", {}))
                               for b in bml.btls)
    w.send(big, dest=2, tag=5)          # the next card send works
if w.rank == 2 and mode == "sm":
    got = np.empty(4 << 20, np.float32)
    w.recv(got, source=0, tag=5)
    out["next_send_ok"] = bool(np.array_equal(got, np.arange(4 << 20,
                                                           dtype=np.float32)))
t0 = time.perf_counter()
try:
    w.agree(1)
    raise AssertionError("agree did not raise ProcFailedError")
except ProcFailedError as e:
    out["agree_failed_flag"] = e.flag
out["agree_raise_s"] = time.perf_counter() - t0
w.ack_failed()
t0 = time.perf_counter()
out["agree_flag"] = w.agree(0b11 if w.rank else 0b01)
out["agree_s"] = time.perf_counter() - t0
t0 = time.perf_counter()
s = w.shrink()
out["shrink_s"] = time.perf_counter() - t0
out["shrunk"] = [s.size, s.epoch, list(s.group.world_ranks)]
x = torch.full((256 * 1024,), float(s.rank + 1), device="cuda")  # 1 MB
r = np.asarray(s.allreduce(x))
out["first"] = float(r[0])
out["digest"] = hashlib.sha256(np.ascontiguousarray(r).tobytes()).hexdigest()
print(json.dumps(out), flush=True)
ompi_tpu_torch.finalize()
"""


def parent_allreduce_array(comm, x, op):
    """``Comm.allreduce_array``'s body before the revocation probe (the
    comm's own flag only), to time the probe's share of the call."""
    if comm.freed or comm.revoked:
        comm._check_state()
    fn = comm.c_coll.get("allreduce_array")
    return fn(comm, x, op)


def topology_ft(smi: str, gen) -> dict:
    """Process topologies and ULFM on the card (phase 9 of the module
    docstring).  Returns the ``topology_ft`` line's object."""
    import tempfile

    import ompi_tpu_torch
    from ompi_tpu_torch.api.errhandler import ERRORS_RETURN
    from ompi_tpu_torch.api.errors import RevokedError
    from ompi_tpu_torch.api.status import PROC_NULL
    from ompi_tpu_torch.ft import state as ft_state
    from ompi_tpu_torch.ops import ring_collectives as rc
    from ompi_tpu_torch.runtime import init as rt

    t_phase = time.perf_counter()
    out = {"card": smi}
    settings = {"priority": "95", "bidirectional": "0", "wire16": "0"}
    for name, value in settings.items():
        os.environ[f"OTPU_MCA_coll_ring_{name}"] = value
    x4 = operands(torch.float32, (N, 4 * MB // 4), gen)
    torch.cuda.synchronize()
    reset_counts()
    world = ompi_tpu_torch.init()
    world.set_errhandler(ERRORS_RETURN)
    _, world_before = launch_delta(lambda: world.allreduce_array(x4))

    # the 2 x 4 grid and its rows (n = 4) from ranks 0 and 4
    cart = world.cart_create((2, 4), periods=(True, False))
    require(cart.cart_get() == ([2, 4], [True, False], [0, 0]),
            f"cart_get {cart.cart_get()}")
    rows = {0: cart.cart_sub((False, True)),
            4: cart.as_rank(4).cart_sub((False, True))}
    done = []
    for first, row in rows.items():
        require(list(row.group.world_ranks) == list(range(first, first + 4))
                and row.topo.dims == [4]
                and owner(row, "allreduce_array") == "RingCollModule",
                f"row of rank {first}: {row.group.world_ranks}")
        for mb, regime in ((4, "fused"), (16, "seg")):
            x = operands(torch.float32, (4, mb * MB // 4), gen)
            plain = (rc.all_reduce_fused_plain(x, 4, "sum") if regime == "fused"
                     else rc.all_reduce_seg_plain(x, 4, "sum", SEG))
            got, d = launch_delta(lambda: row.allreduce_array(x))
            what = f"cart row {first} allreduce {mb} MB/rank"
            require(d == {f"all_reduce_{regime}": 1}, f"{what} launched {d}")
            same_bits(got, plain, what)
            done.append(f"{what}: all_reduce_{regime}")

    # neighbor collectives over a card tensor table: clones on the card,
    # no host copy (any synchronizing copy raises in this mode)
    table = operands(torch.float32, (N, MB // 4), gen)
    blocks = operands(torch.float32, (N, 4, MB // 16), gen)
    torch.cuda.synchronize()
    gathered, exchanged = {}, {}
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, d = launch_delta(lambda: [
            (gathered.__setitem__(r, cart.as_rank(r).neighbor_allgather(table)),
             exchanged.__setitem__(r, cart.as_rank(r).neighbor_alltoall(blocks)))
            for r in range(N)])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    require(d == {}, f"the neighbor collectives launched {d}")
    chan = {}
    for r in range(N):
        for k, dst in enumerate(cart.topo.neighbors(r)[1]):
            chan.setdefault((r, dst), []).append(k)
    for r in range(N):
        srcs = cart.topo.neighbors(r)[0]
        for j, src in enumerate(srcs):
            g, e = gathered[r][j], exchanged[r][j]
            if src == PROC_NULL:
                require(g is None and e is None, f"rank {r} slot {j}: not None")
                continue
            require(g.is_cuda and e.is_cuda, f"rank {r} slot {j} left the card")
            same_bytes(g, table[src], f"neighbor_allgather rank {r} slot {j}")
            same_bytes(e, blocks[src][chan[(src, r)].pop(0)],
                       f"neighbor_alltoall rank {r} slot {j}")
    out["neighbor"] = {"table": [N, MB // 4], "blocks": [N, 4, MB // 16],
                       "d2h_copies": 0, "launches": d}

    # world rank 7 fails: the 7-rank comm's allreduces and bcast
    ft_state.mark_failed(7)
    shrunk = world.shrink()
    require(shrunk.size == 7 and shrunk.epoch == 1
            and owner(shrunk, "allreduce_array") == "RingCollModule",
            f"shrink gave {shrunk}")
    for mb, regime in ((4, "fused"), (16, "seg")):
        x = operands(torch.float32, (7, mb * MB // 4), gen)
        plain = (rc.all_reduce_fused_plain(x, 7, "sum") if regime == "fused"
                 else rc.all_reduce_seg_plain(x, 7, "sum", SEG))
        got, d = launch_delta(lambda: shrunk.allreduce_array(x))
        what = f"shrunken comm (n = 7) allreduce {mb} MB/rank"
        require(d == {f"all_reduce_{regime}": 1}, f"{what} launched {d}")
        same_bits(got, plain, what)
        done.append(f"{what}: all_reduce_{regime}")
    x = operands(torch.float32, (7, 16 * MB // 4), gen)
    got, d = launch_delta(lambda: shrunk.bcast_array(x, 6))
    require(d == {"bcast": 1}, f"shrunken bcast launched {d}")
    same_bytes(got, rc.bcast_plain(x, 7, 6), "shrunken comm bcast")
    done.append("shrunken comm (n = 7) bcast 16 MB/rank: bcast")
    # a revoked dup turns allreduce_array away, launching nothing; the
    # world's own calls launch what they did before the failure
    dup = world.dup()
    dup.revoke()
    try:
        dup.allreduce_array(x4)
        raise AssertionError("a revoked dup's allreduce_array ran")
    except RevokedError:
        pass
    _, world_after = launch_delta(lambda: world.allreduce_array(x4))
    require(world_after == world_before == {"all_reduce_fused": 1},
            f"the world's allreduce_array launched {world_before} before and "
            f"{world_after} after the failure")
    torch.cuda.synchronize()
    launched = counts()
    for key in ("all_reduce_fused", "all_reduce_seg", "bcast"):
        require(launched[key] > 0, f"{key} never launched in this phase")
    out["launches"] = {k: v for k, v in launched.items() if v}
    out["done"] = done

    out["captured_movers_after_shrink"] = check_captured_movers(gen)
    rt.finalize()
    ft_state.reset_for_testing()

    # the probe's host cost on the default world (coll/builtin's slot, as
    # the observability phase measures it): allreduce_array with the probe,
    # the parent's body without it, and the slot itself, in turns (the card
    # spins meanwhile), then is_revoked alone
    ring_defaults()
    world = ompi_tpu_torch.init()
    require(owner(world, "allreduce_array") == "BuiltinCollModule",
            "the default owner of allreduce_array is not coll/builtin")
    small = operands(torch.float32, (N, 512), gen)
    slot = world.c_coll["allreduce_array"]
    ways = {"method": lambda: world.allreduce_array(small),
            "parent_body": lambda: parent_allreduce_array(
                world, small, ompi_tpu_torch.SUM),
            "slot": lambda: slot(world, small, ompi_tpu_torch.SUM)}
    per = {k: [] for k in ways}
    for _ in range(2 * OBS_ROUNDS + 1):
        for name, fn in ways.items():
            per[name].append(host_us(fn, OBS_HOST_CALLS))
    calls = 200_000
    t0 = time.perf_counter()
    for _ in range(calls):
        world.is_revoked()
    probe_us = (time.perf_counter() - t0) / calls * 1e6
    med = {k: statistics.median(v) for k, v in per.items()}
    out["allreduce_array_host_us"] = {
        "median": med, "rounds": per, "is_revoked_us": probe_us,
        "probe_us": med["method"] - med["parent_body"],
        "method_minus_slot": med["method"] - med["slot"],
        "shape": [N, 512], "calls_a_round": OBS_HOST_CALLS}
    require(probe_us <= 1.0, f"is_revoked costs {probe_us:.3f} us a call")
    rt.finalize()
    for name in settings:
        del os.environ[f"OTPU_MCA_coll_ring_{name}"]

    # tpurun -n 4 --enable-recovery jobs of card tensors: rank 1 dies
    detector = ["--mca", "ft_detector", "1", "--mca", "ft_detector_period",
                "0.2", "--mca", "ft_detector_timeout", "1.5"]
    with tempfile.TemporaryDirectory() as tmp:
        script = Path(tmp, "ft_job.py")
        script.write_text(FT_JOB)
        jobs = {}
        for mode, args in (("sm", []), ("tcp", ["--fake-nodes", "2"]),
                           ("detector", detector)):
            lines, stderr, wall = tpurun_job(4, [
                "--enable-recovery", *args, sys.executable, str(script),
                mode], timeout=180)
            res = [job_result(lines, r) for r in (0, 2, 3)]
            digests = {x["digest"] for x in res}
            require(len(digests) == 1, f"{mode}: survivors' digests differ")
            for x in res:
                require(x["agree_failed_flag"] == 1 and x["agree_flag"] == 1
                        and x["shrunk"] == [3, 1, [0, 2, 3]]
                        and x["first"] == 6.0, f"{mode} rank {x['rank']}: {x}")
            if mode == "sm":
                require(res[0]["exposed_after"] == 0,
                        f"the dead puller's RGET exposure stayed: {res[0]}")
                require(res[1]["next_send_ok"], "rank 0's next send failed")
            if mode != "detector":
                require("rank 1 failed (exit 9)" in stderr,
                        f"{mode}: the launcher reported no failure: {stderr}")
            jobs[mode] = {
                "detect_s": [x["detect_s"] for x in res],
                "agree_raise_s": [x["agree_raise_s"] for x in res],
                "agree_s": [x["agree_s"] for x in res],
                "shrink_s": [x["shrink_s"] for x in res],
                "digest": digests.pop()[:16], "wall_s": wall}
        out["jobs_4"] = jobs
    out["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"topology_ft": out}))
    return out


# -- phase 10: sessions, process sets and dynamic processes ---------------

#: the multi-process jobs of ``sessions_dpm``.  Every rank prints one JSON
#: object; the tensors live on the card.  Integer-valued float32, so every
#: sum is exact.
SESSION_JOB = r"""
import hashlib, json, time
import numpy as np, torch
import ompi_tpu_torch as m

t0 = time.perf_counter()
s = m.Session.init()                        # boots the instance: cold
cold_ms = (time.perf_counter() - t0) * 1e3
t0 = time.perf_counter()
s2 = m.Session.init()                       # a refcount bump: warm
warm_ms = (time.perf_counter() - t0) * 1e3
s2.finalize()
psets = []
for name in s.psets():
    info = s.get_pset_info(name)
    psets.append([name, info.get("otpu_members"), info.get("otpu_source")])
world = s.group_from_pset("mpi://WORLD")
app, io = s.group_from_pset("app"), s.group_from_pset("io")
t0 = time.perf_counter()
wc = m.Comm.create_from_group(world, "all")
agreed_ms = (time.perf_counter() - t0) * 1e3
r = wc.rank
ca = m.Comm.create_from_group(app, "app")
ci = m.Comm.create_from_group(io, "io")
mine, mg, og = (ca, app, io) if ca is not None else (ci, io, app)
n = 4 << 20                                 # 16 MB of float32
base = torch.arange(n, device="cuda", dtype=torch.float32).remainder_(1024)
x = base + r
want = lambda ranks: sum(np.arange(n, dtype=np.float32) % 1024 + q
                         for q in ranks)
got = np.asarray(mine.allreduce(x))
ok = bool(np.array_equal(got, want(mg.world_ranks)))
inter = m.Comm.create_intercomm_from_groups(mg, 0, og, 0, "ai")
inter.allreduce(x)                           # warm
times = []
for _ in range(3):
    t0 = time.perf_counter()
    red = np.asarray(inter.allreduce(x))
    times.append((time.perf_counter() - t0) * 1e3)
ok_inter = bool(np.array_equal(red, want(og.world_ranks)))
print(json.dumps({
    "rank": r, "psets": psets, "cold_ms": cold_ms, "warm_ms": warm_ms,
    "agreed_ms": agreed_ms, "comm": [mine.size, mine.rank, ok,
                                     hashlib.sha256(got.tobytes()).hexdigest()],
    "inter": [inter.is_inter, inter.remote_size, ok_inter,
              hashlib.sha256(red.tobytes()).hexdigest()],
    "inter_allreduce_ms": times, "card": x.is_cuda}), flush=True)
for c in (inter, ca, ci, wc):
    if c is not None:
        c.free()
s.finalize()
"""

SPAWN_CHILD = r"""
import hashlib, json
import numpy as np, torch
import ompi_tpu_torch as m

w = m.init()
parent = m.get_parent()
n = 4 << 20
if w.rank == 0:
    buf = np.empty(n // 4, np.float32)      # 4 MB
    parent.recv(buf, 0, tag=5)
    parent.send(torch.from_numpy(buf * 2).cuda(), 0, tag=6)
x = torch.arange(n, device="cuda", dtype=torch.float32).remainder_(512) \
    + w.group.world_ranks[w.rank]
red = np.asarray(parent.allreduce(x))
full = parent.merge(high=True)
tot = np.asarray(full.allreduce(x))
print(json.dumps({"rank": full.rank, "world": list(w.group.world_ranks),
                  "red": hashlib.sha256(red.tobytes()).hexdigest(),
                  "red_head": red[:2].tolist(),
                  "merged": [full.size, full.rank],
                  "digest": hashlib.sha256(tot.tobytes()).hexdigest(),
                  "card": x.is_cuda}), flush=True)
m.finalize()
"""

SPAWN_JOB = r"""
import hashlib, json, sys, time
import numpy as np, torch
import ompi_tpu_torch as m

w = m.init()
t0 = time.perf_counter()
inter = w.spawn([sys.executable, sys.argv[1]], 2)
spawn_ms = (time.perf_counter() - t0) * 1e3
n = 4 << 20
ping = None
if w.rank == 0:
    y = torch.arange(n // 4, device="cuda", dtype=torch.float32)  # 4 MB
    back = np.empty(n // 4, np.float32)
    t0 = time.perf_counter()
    inter.send(y, 0, tag=5)
    inter.recv(back, 0, tag=6)
    ping = [(time.perf_counter() - t0) * 1e3,
            bool(np.array_equal(back, 2 * np.arange(n // 4,
                                                    dtype=np.float32)))]
x = torch.arange(n, device="cuda", dtype=torch.float32).remainder_(512) \
    + w.group.world_ranks[w.rank]
t0 = time.perf_counter()
red = np.asarray(inter.allreduce(x))
inter_ms = (time.perf_counter() - t0) * 1e3
t0 = time.perf_counter()
full = inter.merge(high=False)
merge_ms = (time.perf_counter() - t0) * 1e3
tot = np.asarray(full.allreduce(x))
print(json.dumps({"rank": full.rank, "spawn_ms": spawn_ms, "ping": ping,
                  "remote": list(inter.remote_group.world_ranks),
                  "job": inter.spawn_job,
                  "red": hashlib.sha256(red.tobytes()).hexdigest(),
                  "red_head": red[:2].tolist(),
                  "inter_allreduce_ms": inter_ms, "merge_ms": merge_ms,
                  "merged": [full.size, full.rank],
                  "digest": hashlib.sha256(tot.tobytes()).hexdigest(),
                  "card": x.is_cuda}), flush=True)
m.finalize()
"""

CONNECT_JOB = r"""
import hashlib, json
import numpy as np, torch
import ompi_tpu_torch as m
from ompi_tpu_torch import dpm

w = m.init()
side = w.split(0 if w.rank < 2 else 1)
if w.rank < 2:
    port = dpm.open_port(w)
    if side.rank == 0:
        dpm.publish_name("smoke-svc", port, w)
    inter = side.accept(port)
else:
    port = dpm.lookup_name("smoke-svc", w, wait=True)
    inter = side.connect(port)
n = 1 << 20                                  # 4 MB
got = None
if side.rank == 0:
    if w.rank < 2:
        buf = np.empty(n, np.float32)
        inter.recv(buf, 0, tag=1)
        got = bool(np.array_equal(buf, np.arange(n, dtype=np.float32) + 2))
    else:
        inter.send(torch.arange(n, device="cuda", dtype=torch.float32) + 2,
                   0, tag=1)
x = torch.full((n,), float(w.rank + 1), device="cuda")
red = np.asarray(inter.allreduce(x))
full = inter.merge(high=w.rank >= 2)
tot = np.asarray(full.allreduce(x))
w.barrier()
if w.rank == 0:
    dpm.unpublish_name("smoke-svc", w)
print(json.dumps({"rank": w.rank, "got": got, "red": float(red[0]),
                  "merged": [full.size, full.rank],
                  "digest": hashlib.sha256(tot.tobytes()).hexdigest(),
                  "card": x.is_cuda}), flush=True)
m.finalize()
"""

RECOVER_CHILD = r"""
import hashlib, json
import numpy as np, torch
import ompi_tpu_torch as m

w = m.init()
full = m.get_parent().merge(high=True)
x = torch.full((1 << 18,), float(full.rank + 1), device="cuda")   # 1 MB
tot = np.asarray(full.allreduce(x))
print(json.dumps({"rank": full.rank, "merged": [full.size, full.rank],
                  "first": float(tot[0]), "card": x.is_cuda,
                  "digest": hashlib.sha256(tot.tobytes()).hexdigest()}),
      flush=True)
m.finalize()
"""

RECOVER_JOB = r"""
import hashlib, json, os, sys, time
import numpy as np, torch
import ompi_tpu_torch as m

w = m.init()
w.barrier()
if w.rank == 1:
    os._exit(9)
deadline = time.time() + 60
while not w.get_failed().size:
    assert time.time() < deadline, "the failure of rank 1 was never detected"
    time.sleep(0.002)
w.revoke()
t0 = time.perf_counter()
survivors = w.shrink()
shrink_ms = (time.perf_counter() - t0) * 1e3
t0 = time.perf_counter()
inter = survivors.spawn([sys.executable, sys.argv[1]], 1)
spawn_ms = (time.perf_counter() - t0) * 1e3
t0 = time.perf_counter()
full = inter.merge(high=False)
merge_ms = (time.perf_counter() - t0) * 1e3
x = torch.full((1 << 18,), float(full.rank + 1), device="cuda")
tot = np.asarray(full.allreduce(x))
s = m.Session.init()
psets = {n: s.get_pset_info(n).get("otpu_members") for n in s.psets()}
s.finalize()
print(json.dumps({"rank": full.rank, "survivors": survivors.size,
                  "shrunk_cid": survivors.cid,
                  "merged": [full.size, full.rank,
                             list(full.group.world_ranks)],
                  "first": float(tot[0]), "psets": psets,
                  "shrink_ms": shrink_ms, "spawn_ms": spawn_ms,
                  "merge_ms": merge_ms, "card": x.is_cuda,
                  "digest": hashlib.sha256(tot.tobytes()).hexdigest()}),
      flush=True)
m.finalize()
"""

#: the pset list every rank of the sessions job must see: the launcher's
#: world, its two fake nodes and the two --pset sets (a rank's own
#: mpi://SELF aside)
SESSION_PSETS = [["mpi://WORLD", "0,1,2,3", "builtin"],
                 ["app", "0,1", "user"], ["io", "2,3", "user"],
                 ["mpi://host/node0", "0,1", "host"],
                 ["mpi://host/node1", "2,3", "host"]]


def session_world(gen) -> dict:
    """The device world built from a Session, with no ``init``: comms from
    ``mpi://WORLD`` and a 4-row group on the raised ring, an intercomm of
    the two halves, COMM_WORLD joining the instance, both finalize orders.
    Returns the line's ``device_world`` object."""
    import ompi_tpu_torch
    from ompi_tpu_torch import instance
    from ompi_tpu_torch.ops import ring_collectives as rc
    from ompi_tpu_torch.runtime import init as rt

    out = {}
    x16 = operands(torch.float32, (N, 16 * MB // 4), gen)
    x4 = operands(torch.float32, (N, 4 * MB // 4), gen)
    rows = [0, 2, 4, 6]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    s = ompi_tpu_torch.Session.init()
    out["session_init_cold_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    s2 = ompi_tpu_torch.Session.init()
    out["session_init_warm_ms"] = (time.perf_counter() - t0) * 1e3
    require(not ompi_tpu_torch.initialized() and instance.refcount() == 2,
            f"a session initialized the world (refcount {instance.refcount()})")
    s2.finalize()
    world_g = s.group_from_pset("mpi://WORLD")
    t0 = time.perf_counter()
    app = ompi_tpu_torch.Comm.create_from_group(world_g, "app")
    out["create_from_group_local_ms"] = (time.perf_counter() - t0) * 1e3
    four = ompi_tpu_torch.Comm.create_from_group(world_g.incl(rows), "four")
    require(app.cid >= 2 and four.cid >= 2 and app.size == N
            and four.size == 4
            and owner(app, "allreduce_array") == "RingCollModule"
            and owner(four, "allreduce_array") == "RingCollModule",
            f"session comms {app} {four}")
    got = {}
    for comm, name, width in ((app, "app", N), (four, "four", 4)):
        for x, mb, regime in ((x16, 16, "seg"), (x4, 4, "fused")):
            xin = x if width == N else x[rows]
            plain = (rc.all_reduce_seg_plain(xin, width, "sum", SEG)
                     if regime == "seg"
                     else rc.all_reduce_fused_plain(xin, width, "sum"))
            res, d = launch_delta(lambda: comm.allreduce_array(xin))
            what = f"session comm {name} (n = {width}) allreduce {mb} MB/rank"
            require(d == {f"all_reduce_{regime}": 1}, f"{what} launched {d}")
            same_bits(res, plain, what)
            got[(name, mb)] = res
    lo, hi = world_g.incl(range(N // 2)), world_g.incl(range(N // 2, N))
    inter = ompi_tpu_torch.Comm.create_intercomm_from_groups(lo, 0, hi, 0,
                                                            "halves")
    require(inter.is_inter and inter.size == inter.remote_size == N // 2
            and inter.local_comm.size == N // 2
            and type(inter.c_coll["allreduce"].__self__).__name__
            == "InterCollModule", f"intercomm of the halves: {inter}")
    inter.free()
    require(inter.freed, "the intercomm was not freed")
    # COMM_WORLD joins the session's instance: the same bits
    w = ompi_tpu_torch.init()
    require(instance.refcount() == 2 and w.rte is instance.current().rte,
            f"init did not join the session (refcount {instance.refcount()})")
    for x, mb, regime in ((x16, 16, "seg"), (x4, 4, "fused")):
        res, d = launch_delta(lambda: w.allreduce_array(x))
        require(d == {f"all_reduce_{regime}": 1},
                f"COMM_WORLD allreduce {mb} MB/rank launched {d}")
        same_bits(res, got[("app", mb)],
                  f"session comm against COMM_WORLD at {mb} MB/rank")
    torch.cuda.synchronize()
    launched = counts()
    out["launches"] = {k: v for k, v in launched.items() if v}
    require(out["launches"] == {"all_reduce_seg": 3, "all_reduce_fused": 3},
            f"the session world launched {out['launches']}")
    app.free()
    four.free()
    # both finalize orders, then a fresh boot
    ompi_tpu_torch.finalize()
    require(instance.refcount() == 1 and instance.current() is not None,
            "finalize with a session open tore the runtime down")
    s.finalize()
    require(instance.current() is None, "the last release left an instance")
    s = ompi_tpu_torch.Session.init()
    ompi_tpu_torch.init()
    s.finalize()
    require(instance.refcount() == 1, "session finalize under the world")
    ompi_tpu_torch.finalize()
    require(instance.current() is None and rt.finalized(),
            "the world's finalize after the session's left an instance")
    t0 = time.perf_counter()
    s = ompi_tpu_torch.Session.init()
    out["session_reboot_ms"] = (time.perf_counter() - t0) * 1e3
    c = ompi_tpu_torch.Comm.create_from_group(
        s.group_from_pset("mpi://WORLD"), "again")
    res = c.allreduce_array(x4)
    same_bits(res, got[("app", 4)], "the re-booted instance's allreduce")
    c.free()
    s.finalize()
    return out


def sessions_dpm(smi: str, gen) -> dict:
    """Sessions, process sets and dynamic processes (phase 10 of the module
    docstring).  Returns the ``sessions_dpm`` line's object."""
    t_phase = time.perf_counter()
    out = {"card": smi}
    settings = {"priority": "95", "bidirectional": "0", "wire16": "0"}
    for name, value in settings.items():
        os.environ[f"OTPU_MCA_coll_ring_{name}"] = value
    out["device_world"] = session_world(gen)
    ring_defaults()
    for name in settings:
        del os.environ[f"OTPU_MCA_coll_ring_{name}"]
    out.update(dpm_jobs())
    out["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"sessions_dpm": out}))
    return out


def dpm_jobs() -> dict:
    """The phase's four ``tpurun`` jobs, their tensors on the card: the
    sessions job's psets, comms and intercomm, spawn and merge,
    connect/accept, and the recovery loop.  Returns their part of the
    line's object."""
    import tempfile

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, body in (("session", SESSION_JOB), ("spawn", SPAWN_JOB),
                           ("child", SPAWN_CHILD), ("connect", CONNECT_JOB),
                           ("recover", RECOVER_JOB),
                           ("replacement", RECOVER_CHILD)):
            paths[name] = Path(tmp, f"{name}.py")
            paths[name].write_text(body)
        py = sys.executable

        lines, wall = tpurun(4, ["--pset", "app:0-1", "--pset", "io:2-3",
                                 "--fake-nodes", "2", py,
                                 str(paths["session"])], timeout=240)
        res = [job_result(lines, r) for r in range(4)]
        for x in res:
            table = [row for row in x["psets"] if row[0] != "mpi://SELF"]
            require(sorted(table) == sorted(SESSION_PSETS)
                    and ["mpi://SELF", str(x["rank"]), "builtin"]
                    in x["psets"], f"rank {x['rank']} psets {x['psets']}")
            require(x["comm"][:3] == [2, x["rank"] % 2, True]
                    and x["inter"][:3] == [True, 2, True]
                    and x["card"], f"rank {x['rank']}: {x}")
        for pair in ((0, 1), (2, 3)):
            require(res[pair[0]]["comm"][3] == res[pair[1]]["comm"][3]
                    and res[pair[0]]["inter"][3] == res[pair[1]]["inter"][3],
                    f"ranks {pair}: digests differ")
        out["sessions_4"] = {
            "psets": res[0]["psets"],
            "session_init_cold_ms": [x["cold_ms"] for x in res],
            "session_init_warm_ms": [x["warm_ms"] for x in res],
            "create_from_group_agreed_ms": [x["agreed_ms"] for x in res],
            "inter_allreduce_16MB_ms": [x["inter_allreduce_ms"] for x in res],
            "digests": [res[0]["comm"][3][:16], res[2]["comm"][3][:16]],
            "wall_s": wall}

        lines, wall = tpurun(2, [py, str(paths["spawn"]),
                                 str(paths["child"])], timeout=240)
        res = [job_result(lines, r) for r in range(4)]
        require(len({x["digest"] for x in res}) == 1,
                f"spawn: the merged comm's digests differ: {res}")
        parents, kids = res[:2], res[2:]
        require(parents[0]["ping"][1] and all(
                    x["merged"][:2] == [4, x["rank"]] and x["card"]
                    for x in res)
                and all(x["remote"] == [2, 3] and x["job"] == "job1"
                        for x in parents)
                and all(x["world"] == [2, 3] for x in kids)
                and parents[0]["red"] == parents[1]["red"]
                and kids[0]["red"] == kids[1]["red"]
                and parents[0]["red_head"] == [2 + 3, 1 + 1 + 2 + 3]
                and kids[0]["red_head"] == [0 + 1, (1 + 0) + (1 + 1)],
                f"spawn job: {res}")
        out["spawn_2x2"] = {
            "spawn_to_join_ms": [x["spawn_ms"] for x in parents],
            "pingpong_4MB_ms": parents[0]["ping"][0],
            "inter_allreduce_16MB_ms": [x["inter_allreduce_ms"]
                                        for x in parents],
            "merge_ms": [x["merge_ms"] for x in parents],
            "digest": res[0]["digest"][:16], "wall_s": wall}

        lines, wall = tpurun(4, [py, str(paths["connect"])], timeout=240)
        res = [job_result(lines, r) for r in range(4)]
        require(len({x["digest"] for x in res}) == 1
                and res[0]["got"] is True
                and [x["red"] for x in res] == [7.0, 7.0, 3.0, 3.0]
                and all(x["merged"] == [4, x["rank"]] for x in res),
                f"connect/accept job: {res}")
        out["connect_4"] = {"digest": res[0]["digest"][:16], "wall_s": wall}

        lines, stderr, wall = tpurun_job(
            3, ["--enable-recovery", py, str(paths["recover"]),
                str(paths["replacement"])], timeout=240)
        merged = {}
        for rank, rows in lines.items():
            objs = [json.loads(x) for x in rows if x.startswith("{")]
            for obj in objs:
                merged[obj["rank"]] = obj
        require(sorted(merged) == [0, 1, 2] and len(
                    {x["digest"] for x in merged.values()}) == 1
                and all(x["first"] == 6.0 and x["card"]
                        for x in merged.values()),
                f"recovery job: {lines}")
        for x in (merged[0], merged[1]):
            require(x["survivors"] == 2
                    and x["merged"] == [3, x["rank"], [0, 2, 3]]
                    and x["psets"].get("mpi://surviving") == "0,2"
                    and x["psets"].get(f"mpi://shrunk/{x['shrunk_cid']}")
                    == "0,2" and x["psets"].get("mpi://job/job1") == "3",
                    f"recovery rank {x['rank']}: {x}")
        require("rank 1 failed (exit 9)" in stderr,
                f"the launcher reported no failure: {stderr}")
        out["recover_3"] = {
            "psets": merged[0]["psets"],
            "shrink_ms": [merged[r]["shrink_ms"] for r in (0, 1)],
            "spawn_to_join_ms": [merged[r]["spawn_ms"] for r in (0, 1)],
            "merge_ms": [merged[r]["merge_ms"] for r in (0, 1)],
            "digest": merged[0]["digest"][:16], "wall_s": wall}
    return out


ELASTIC_JOB = r"""
import json, sys, time
import numpy as np
import ompi_tpu_torch as m
from ompi_tpu_torch.parallel.elastic import ElasticTrainer

w = m.init()
tr = ElasticTrainer(w, ckpt_dir=sys.argv[1], model_size=int(sys.argv[2]),
                    global_batch=24, ckpt_every=5, respawn=True)
t0 = time.perf_counter()
tr.train(int(sys.argv[3]))
train_s = time.perf_counter() - t0
if tr.comm.rank == 0:
    np.save(sys.argv[1] + "/final.npy", tr.w.cpu().numpy())
    print(json.dumps({"rank": 0, "step": tr.step,
                      "world_size": tr.comm.size, "card": tr.w.is_cuda,
                      "recoveries": tr.recoveries, "train_s": train_s}),
          flush=True)
m.finalize()
"""

IO_JOB = r"""
import hashlib, json, sys, time
import numpy as np, torch
import ompi_tpu_torch as m
from ompi_tpu_torch.api.file import File
from ompi_tpu_torch.base.var import registry
from ompi_tpu_torch.datatype import core

G, B = 4096, 2048       # a 4096 x 4096 float32 array (64 MB), 2 x 2 blocks


def block_of(rank):
    gen = torch.Generator(device="cuda").manual_seed(1234 + rank)
    return torch.randn((B, B), generator=gen, device="cuda")


w = m.init()
r = w.rank
gi, gj = divmod(r, 2)
block = block_of(r)
f32 = core.from_numpy_dtype(np.float32)
ft = core.subarray([G, G], [B, B], [gi * B, gj * B], core.ORDER_C, f32)
for fcoll in sys.argv[2:]:
    path = f"{sys.argv[1]}_{fcoll}.dat"
    f = File.open(w, path, "c+")
    registry.set("otpu_io_ompio_fcoll", fcoll)     # read at each collective
    f.set_view(0, f32, ft)
    torch.cuda.synchronize()
    w.barrier()
    t0 = time.perf_counter()
    wrote = f.write_at_all(0, block)
    write_s = time.perf_counter() - t0
    back = np.zeros((B, B), np.float32)
    w.barrier()
    t0 = time.perf_counter()
    f.read_at_all(0, back)
    read_s = time.perf_counter() - t0
    alg = f.io_module.last_fcoll_alg
    f.close()
    same = back.tobytes() == block.cpu().numpy().tobytes()
    dense = None
    if r == 0:
        whole = np.fromfile(path, np.float32).reshape(G, G)
        dense = all(whole[i * B:(i + 1) * B, j * B:(j + 1) * B].tobytes()
                    == block_of(2 * i + j).cpu().numpy().tobytes()
                    for i in range(2) for j in range(2))
    print(json.dumps({"rank": r, "fcoll": fcoll, "wrote": wrote,
                      "same": same, "dense": dense, "card": block.is_cuda,
                      "alg": alg, "write_s": write_s, "read_s": read_s}),
          flush=True)
m.finalize()
"""

#: the trainer's parameter vector in the phase's jobs: 2^20 float64 (8 MB
#: of state, an 8 MB allreduce a step)
ELASTIC_MODEL = 1 << 20
#: the elastic jobs' steps: the kill at step 7 resumes from step 5's
#: checkpoint, and 5 steps after it finish the run
ELASTIC_STEPS = 10
#: the wire faults of the fake-node job, with the kill, under one seed
WIRE_SPEC = "drop:p=0.02;delay:ms=2,p=0.05;corrupt:p=0.01"
#: the same without corruption: the job must finish, bit for bit
WIRE_LOSS_SPEC = "drop:p=0.02;delay:ms=2,p=0.05"
ELASTIC_PHASES = ("elastic_detect", "elastic_revoke", "elastic_agree",
                  "elastic_shrink", "elastic_respawn", "elastic_restore",
                  "elastic_resume")


def checkpoint_step(tmp: str) -> dict:
    """Part (a): the training step's device-world checkpoint.  On the
    training path's mesh and scale, with the counts set to 0 before and
    read after: 2 steps, ``checkpoint.save`` of the parameters, ``load``
    back onto the card (byte-equal), 2 more steps; then 4 uninterrupted
    steps from the same start, which must launch the same K21 count and
    reach the same losses within the step's band."""
    from ompi_tpu_torch.parallel import checkpoint, dryrun

    per_step = k21_per_step(STEP_MESHES["default"])
    step, (params, x), _ = dryrun.make_step_and_args(lr=STEP_LR)
    torch.cuda.synchronize()
    reset_counts()
    p, losses = params, []
    for _ in range(2):
        p, loss = step(p, x)
        losses.append(float(loss))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save(tmp, p)
    save_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    back = checkpoint.load(tmp)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    require(sorted(back) == sorted(p), f"loaded leaves {sorted(back)}")
    for k in p:
        require(back[k].is_cuda, f"leaf {k} loaded on {back[k].device}")
        same_bits(back[k], p[k], f"checkpoint leaf {k}")
    q = back
    for _ in range(2):
        q, loss = step(q, x)
        losses.append(float(loss))
    torch.cuda.synchronize()
    resumed = counts()
    reset_counts()
    r, straight_losses = params, []
    for _ in range(4):
        r, loss = step(r, x)
        straight_losses.append(float(loss))
    torch.cuda.synchronize()
    straight = counts()
    require(resumed == straight and resumed["flash_block"] == 4 * per_step,
            f"resumed run launched {resumed}, uninterrupted {straight}, "
            f"want {4 * per_step} of K21")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, straight_losses))
    require(rel <= 1e-5 and all(np.isfinite(losses)),
            f"resumed losses {losses} vs {straight_losses} ({rel:.3e})")
    for k in q:
        same_bits(q[k], r[k], f"resumed parameter {k}")
    nbytes = sum(t.numel() * t.element_size() for t in p.values())
    return {"leaves": len(p), "state_MB": nbytes / MB, "save_ms": save_ms,
            "load_ms": load_ms,
            "launches": {k: v for k, v in resumed.items() if v},
            "losses": losses, "loss_rel_diff": rel, "params_bit_equal": True}


@functools.lru_cache(maxsize=None)
def elastic_reference(step: int) -> bytes:
    """The bytes of ``reference_run`` from zeros (where the trainer starts)
    to ``step``."""
    from ompi_tpu_torch.parallel import elastic

    return elastic.reference_run(np.zeros(ELASTIC_MODEL), 0, step,
                                 24).tobytes()


def same_as_reference(tmp: Path, resume_step: int) -> bool:
    """Whether the job's final parameters equal ``reference_run`` from zeros
    over every step, and the checkpoint the recovery restored equals it at
    that step, bit for bit (so the run from the checkpoint is held too)."""
    from ompi_tpu_torch.parallel import checkpoint

    tree = checkpoint.load(str(tmp / "ckpt" / f"step{resume_step:06d}"),
                           device="cpu")
    got = np.load(tmp / "ckpt" / "final.npy")
    return (got.dtype == np.float64
            and tree["w"].numpy().tobytes() == elastic_reference(resume_step)
            and got.tobytes() == elastic_reference(ELASTIC_STEPS))


def elastic_result(tmp: Path, r, lines: dict, wall: float) -> dict:
    """The respawn job's checks: width 4, the final parameters bit for bit
    against ``reference_run`` from zeros and from the restored checkpoint,
    the recovery's
    phase spans in the merged trace, the killed rank's flight dump."""
    tail = (r.stdout + r.stderr)[-4000:]
    res = job_result(lines, 0)
    require(res["step"] == ELASTIC_STEPS and res["world_size"] == 4
            and res["card"],
            f"elastic job: {res}\n{tail}")
    rec = res["recoveries"][0]
    require(rec["detect_step"] == 7 and rec["resume_step"] == 5
            and set(rec["failed"]) <= {2} and "respawn_ms" in rec,
            f"elastic recovery: {rec}\n{tail}")
    require(same_as_reference(tmp, rec["resume_step"]),
            "the elastic run's parameters differ from reference_run")
    names = {e.get("name") for e in json.loads(
        (tmp / "trace" / "trace_merged.json").read_text())["traceEvents"]}
    missing = [n for n in ELASTIC_PHASES if n not in names]
    require(not missing, f"merged trace lacks {missing}")
    bundle = json.loads((tmp / "crash" / "bundle.json").read_text())
    require(bundle["dumps"]["2"]["reason"] == "chaos-kill"
            and "rank 2 failed (exit 7)" in r.stderr,
            f"flight bundle: {sorted((r, d['reason']) for r, d in bundle['dumps'].items())}")
    out = {k: v for k, v in rec.items() if k.endswith("_ms")}
    out.update({"detect_to_resume_ms": rec["total_ms"],
                "bundle_reasons": {r: d["reason"]
                                   for r, d in bundle["dumps"].items()},
                "train_s": res["train_s"], "wall_s": wall})
    return out


def train_through_failure(smi: str, gen) -> dict:
    """Train through failure (phase 11 of the module docstring).  Returns
    the ``train_through_failure`` line's object."""
    import tempfile

    t_phase = time.perf_counter()
    out = {"card": smi}
    py = sys.executable
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        out["checkpoint_step"] = checkpoint_step(str(tmp / "step"))
        paths = {}
        for name, body in (("elastic", ELASTIC_JOB), ("io", IO_JOB)):
            paths[name] = tmp / f"{name}.py"
            paths[name].write_text(body)

        job = tmp / "respawn"
        r, lines, wall = tpurun_any(
            4, ["--enable-recovery",
                "--mca", "otpu_chaos_spec", "kill:rank=2,step=7",
                "--mca", "otpu_trace_enable", "1",
                "--mca", "otpu_trace_dir", str(job / "trace"),
                "--mca", "otpu_flight_dir", str(job / "crash"),
                py, str(paths["elastic"]), str(job / "ckpt"),
                str(ELASTIC_MODEL), str(ELASTIC_STEPS)], timeout=300)
        require(r.returncode == 0, f"the respawn job exited {r.returncode}:"
                f"\n{(r.stdout + r.stderr)[-4000:]}")
        out["elastic_respawn_4"] = elastic_result(job, r, lines, wall)

        # (c) across two emulated nodes with wire faults, one seed: c1 adds
        # corruption (finishes bit for bit, or fails on an attributed crc
        # error, never with other parameters); c2 has drop and delay only,
        # and must finish bit for bit at width 4
        for name, spec in (("elastic_wire_chaos_4", WIRE_SPEC),
                           ("elastic_wire_loss_4", WIRE_LOSS_SPEC)):
            job = tmp / name
            spec = f"kill:rank=2,step=7;{spec}"
            r, lines, wall = tpurun_any(
                4, ["--fake-nodes", "2", "--enable-recovery",
                    "--mca", "otpu_chaos_spec", spec,
                    "--mca", "otpu_chaos_seed", str(SEED),
                    "--mca", "otpu_trace_enable", "1",
                    "--mca", "otpu_trace_dir", str(job / "trace"),
                    "--mca", "otpu_flight_dir", str(job / "crash"),
                    py, str(paths["elastic"]), str(job / "ckpt"),
                    str(ELASTIC_MODEL), str(ELASTIC_STEPS)], timeout=300)
            text = r.stdout + r.stderr
            if r.returncode == 0 or "corrupt" not in spec:
                require(r.returncode == 0, f"the {name} job exited "
                        f"{r.returncode}:\n{text[-4000:]}")
                wire = elastic_result(job, r, lines, wall)
                wire["outcome"] = "finished bit-exact"
            else:
                require("failed its crc32" in text
                        and "corrupted on the wire" in text,
                        f"the {name} job failed without an attributed crc "
                        f"error (exit {r.returncode}):\n{text[-3000:]}")
                printed = [json.loads(x) for x in lines.get(0, [])
                           if x.startswith("{")]
                if printed:
                    # a result printed before the trip: never other
                    # parameters than the reference's
                    rec = printed[0]["recoveries"][0]
                    require(same_as_reference(job, rec["resume_step"]),
                            f"the {name} job printed parameters that "
                            f"differ from reference_run")
                wire = {"outcome": "failed loudly: crc32",
                        "exit": r.returncode, "wall_s": wall,
                        "printed_a_result": bool(printed),
                        "crc_errors": text.count("failed its crc32")}
            wire["spec"] = spec
            wire["seed"] = SEED
            out[name] = wire

        # (d) both fcolls in turns in one job (the var is read at each
        # collective call)
        fcolls = ("static", "dynamic")
        lines, wall = tpurun(
            4, ["--mca", "io_ompio_num_aggregators", "2", py,
                str(paths["io"]), str(tmp / "dense"), *fcolls], timeout=240)
        out["mpiio_job_wall_s"] = wall
        for fcoll in fcolls:
            res = [next((json.loads(x) for x in lines.get(r, [])
                         if x.startswith("{") and json.loads(x).get(
                             "fcoll") == fcoll), None) for r in range(4)]
            require(None not in res, f"MPI-IO job ({fcoll}): {lines}")
            require(all(x["same"] and x["card"] and x["alg"] == fcoll
                        and x["wrote"] == 16 * MB for x in res)
                    and res[0]["dense"] is True,
                    f"MPI-IO job ({fcoll}): {res}")
            write_s = max(x["write_s"] for x in res)
            read_s = max(x["read_s"] for x in res)
            out[f"mpiio_64MB_{fcoll}"] = {
                "write_MB_s": 64 / write_s, "read_MB_s": 64 / read_s,
                "write_s_by_rank": [x["write_s"] for x in res],
                "read_s_by_rank": [x["read_s"] for x in res]}
    out["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"train_through_failure": out}))
    return out


#: the partitioned allreduce's gradient buckets, MB a rank (float32, 8
#: ranks wide), in production order; ``pready`` releases them late-first
PART_BUCKETS_MB = (16, 16, 4, 4)


def pallreduce_epochs(world, gen) -> dict:
    """Two epochs of ``world.pallreduce_init`` over ``PART_BUCKETS_MB``
    (the second rebinding fresh buckets), the counts set to 0 before and
    read after; each bucket checked against coll/builtin's one-shot
    ``allreduce_array`` (bit for bit) and the float64 sum (the band)."""
    from ompi_tpu_torch.ops import ring_collectives as rc

    builtin = world.c_coll["partitioned_coll"].__self__
    epochs = [[operands(torch.float32, (N, mb * MB // 4), gen)
               for mb in PART_BUCKETS_MB] for _ in range(2)]
    torch.cuda.synchronize()
    reset_counts()
    req = world.pallreduce_init(epochs[0])
    rows, results = [], []
    for e, buckets in enumerate(epochs):
        req.start(buckets if e else None)
        timed = []
        # the card spins while the host releases the buckets: the host µs
        # of a pready holds no device time, and the events bracket the
        # bucket's reduction alone
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        for i in reversed(range(len(buckets))):
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            t0 = time.perf_counter()
            req.pready(i)
            host = (time.perf_counter() - t0) * 1e6
            ev1.record()
            timed.append((i, host, ev0, ev1))
        # parrived queries the bucket's event: a synchronizing call raises
        torch.cuda.set_sync_debug_mode("error")
        try:
            before = [req.parrived(i) for i in range(len(buckets))]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        # the card still spins (~50 ms against the host's few preadys), so
        # every bucket is pending: a parrived that ignored its event shows
        require(not any(before), f"epoch {e}: parrived before the spin "
                f"ended {before}")
        torch.cuda.synchronize()
        after = [req.parrived(i) for i in range(len(buckets))]
        require(all(after) and req.complete_flag,
                f"epoch {e}: parrived after a synchronize {after}")
        req.wait()
        results.append(list(req.result))
        rows.append({"parrived_before_sync": before,
                     "parrived_after_sync": after,
                     "buckets": [{"bucket": i, "MB": PART_BUCKETS_MB[i],
                                  "pready_host_us": host,
                                  "device_ms": a.elapsed_time(b)}
                                 for i, host, a, b in timed]})
    launched = {k: v for k, v in counts().items() if v}
    ring = {k: v for k, v in launched.items() if k in rc.launches}
    require(not ring, f"pready launched ring kernels {ring}")
    for e, (buckets, got) in enumerate(zip(epochs, results)):
        for i, (b, r) in enumerate(zip(buckets, got)):
            what = f"epoch {e} bucket {i}"
            require(isinstance(r, torch.Tensor) and r.is_cuda,
                    f"{what}: result {type(r)}")
            same_bits(r, builtin.allreduce_array(world, b),
                      f"{what} against coll/builtin's allreduce_array")
            exact = b.double().sum(0)
            bad = ((r.double() - exact).abs()
                   > sum_tolerance(b).double()).sum()
            require(int(bad) == 0 and bool(torch.isfinite(r).all()),
                    f"{what}: {int(bad)} elements outside the float64 band")
    return {"partitioned_coll": owner(world, "partitioned_coll"),
            "allreduce_array": owner(world, "allreduce_array"),
            "launches": launched, "ring_launches_from_pready": sum(
                ring.values()), "epochs": rows}


#: the partitioned transfers: ``-n 3 --fake-nodes 2``, rank 0 sends 16 MB of
#: float64 in 64 partitions to rank 1 (its node: btl/sm) and to rank 2 (the
#: other node: btl/tcp), readied in production order; ``min_partitions`` 1
#: and 8 in turns (the sender reads the var at each start), five rounds;
#: every transfer bit for bit
PART_XFER = r"""
import json, sys, time
import numpy as np
import ompi_tpu_torch as m
from ompi_tpu_torch.base.var import registry
from ompi_tpu_torch.runtime import spc

w = m.init()
P, n = 64, 16 * (1 << 20) // 8
x = np.zeros(n)
y = np.zeros(n)
if w.rank == 0:
    reqs = {p: w.psend_init(x, P, dest=p, tag=5) for p in (1, 2)}
else:
    reqs = {0: w.precv_init(y, P, source=0, tag=5)}
btl = {p: w.pml.bml.endpoint(p).btl.name for p in range(3) if p != w.rank}
out = {"rank": w.rank, "btl": btl}
for rnd in range(5):
    for peer in (1, 2):
        for minp in (1, 8):
            registry.set("otpu_part_persist_min_partitions", minp)
            x[:] = np.arange(n, dtype=np.float64) * (rnd + 1) + minp + peer
            w.barrier()
            if w.rank in (0, peer):
                req = reqs[peer if w.rank == 0 else 0]
                m0 = spc.read("part_msgs")
                t0 = time.perf_counter()
                req.start()
                if w.rank == 0:
                    for p in range(P):
                        req.pready(p)
                req.wait()
                dt = time.perf_counter() - t0
                row = out.setdefault(f"{btl[peer if w.rank == 0 else 0]}"
                                     f"_min_{minp}", {"s": [], "msgs": [],
                                                      "exact": True})
                row["s"].append(dt)
                row["msgs"].append(spc.read("part_msgs") - m0)
                if w.rank != 0:
                    row["exact"] = row["exact"] and bool(np.array_equal(y, x))
            w.barrier()
print(json.dumps(out), flush=True)
m.finalize()
"""

#: the replay job: a ring over ``w`` and its dup ``d``, card-tensor
#: payloads of 256 KB; the even ranks emit w then d, the odd ones d then
#: w, and each consumes in the other order, so every pairing crosses
#: channels; rank 1 dies between its two receives of round 2
VP_JOB = r"""
import os
import numpy as np
import torch
import ompi_tpu_torch

niter = int(os.environ["VP_NITER"])
die = os.environ.get("VP_DIE", "") == "1"
w = ompi_tpu_torch.init()
d = w.dup()
n, r = w.size, w.rank
nxt, prv = (r + 1) % n, (r - 1) % n
k = 32768
state = torch.arange(k, dtype=torch.float64, device="cuda") * 1e-3 + r + 1
for it in range(niter):
    a = 0.5 * state + float(it)
    b = 0.25 * state - float(it)
    if r % 2 == 0:
        q1 = w.isend(a, dest=nxt, tag=7)
        q2 = d.isend(b, dest=nxt, tag=7)
    else:
        q2 = d.isend(b, dest=nxt, tag=7)
        q1 = w.isend(a, dest=nxt, tag=7)
    in_a, in_b = np.empty(k), np.empty(k)
    if prv % 2 == 0:
        d.recv(in_b, source=prv, tag=7)
        if die and r == 1 and it == 2:
            os._exit(9)
        w.recv(in_a, source=prv, tag=7)
    else:
        w.recv(in_a, source=prv, tag=7)
        d.recv(in_b, source=prv, tag=7)
    q1.wait()
    q2.wait()
    state = (0.3 * state + 0.6 * torch.from_numpy(in_a).cuda()
             - 0.2 * torch.from_numpy(in_b).cuda() + float(it))
np.save(os.environ["VP_OUT"] + f".{r}.npy", state.cpu().numpy())
pml = w.pml
print(f"PML {type(pml).__name__} {getattr(pml, '_si', -1)} "
      f"{getattr(pml, '_ri', -1)}", flush=True)
print(f"DONE {r} {state.is_cuda}", flush=True)
ompi_tpu_torch.finalize()
"""


def pml_line(lines: dict, rank: int) -> tuple:
    """``VP_JOB``'s ``PML`` line of a rank: (the pml's class, sends verified
    against the log, receives replayed from it), -1 where it keeps none."""
    line = next((x for x in lines.get(rank, []) if x.startswith("PML ")), "")
    require(bool(line), f"rank {rank} printed no PML line: {lines.get(rank)}")
    name, si, ri = line.split()[1:]
    return name, int(si), int(ri)


def vp_expected(niter: int, n: int = 3) -> list:
    """``VP_JOB``'s recurrence on the CPU: the same float64 operations."""
    k = 32768
    states = [torch.arange(k, dtype=torch.float64) * 1e-3 + r + 1
              for r in range(n)]
    for it in range(niter):
        prev = list(states)
        for r in range(n):
            p = prev[(r - 1) % n]
            states[r] = (0.3 * prev[r] + 0.6 * (0.5 * p + float(it))
                         - 0.2 * (0.25 * p - float(it)) + float(it))
    return [s.numpy() for s in states]


#: the MoE trainer's job: 8 experts of 1024 float64 weights, 512 tokens a
#: step, top-2, 12 steps, a checkpoint every 4
MOE_CONF = {"steps": 12, "n_experts": 8, "expert_dim": 1024,
            "tokens_per_step": 512, "ckpt_every": 4, "seed": SEED}


def partitioned_logging(smi: str, gen) -> dict:
    """Message logging, partitioned communication and the MoE host trainer
    (phase 12 of the module docstring).  Returns the
    ``partitioned_logging`` line's object."""
    import tempfile

    import ompi_tpu_torch
    from ompi_tpu_torch.mca.coll.base import coll_framework
    from ompi_tpu_torch.mca.pml.vprotocol import read_log
    from ompi_tpu_torch.parallel import checkpoint, moe
    from ompi_tpu_torch.runtime import init as rt

    t_phase = time.perf_counter()
    out = {"card": smi}
    py = sys.executable
    coll_framework().open()              # coll/ring's vars, for its defaults
    # (a) the device path, default components and coll/ring raised
    for name, prio in (("default", None), ("ring_raised", "95")):
        ring_defaults()
        if prio is not None:
            os.environ["OTPU_MCA_coll_ring_priority"] = prio
        world = ompi_tpu_torch.init()
        res = pallreduce_epochs(world, gen)
        require(res["partitioned_coll"] == "BuiltinCollModule"
                and res["allreduce_array"] == ("RingCollModule" if prio
                                               else "BuiltinCollModule"),
                f"{name}: partitioned_coll {res['partitioned_coll']}, "
                f"allreduce_array {res['allreduce_array']}")
        rt.finalize()
        out[f"pallreduce_8x40MB_{name}"] = res
    ring_defaults()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # (b) the partitioned transfers over sm and over tcp, one job
        xfer = tmp / "part_xfer.py"
        xfer.write_text(PART_XFER)
        lines, wall = tpurun(3, ["--fake-nodes", "2", py, str(xfer)],
                             timeout=120)
        res = [job_result(lines, r) for r in range(3)]
        require(res[0]["btl"] == {"1": "sm", "2": "tcp"}
                and res[1]["btl"]["0"] == "sm"
                and res[2]["btl"]["0"] == "tcp",
                f"the partitioned transfers' links: {[x['btl'] for x in res]}")
        for name, recv in (("sm", res[1]), ("tcp", res[2])):
            row = {}
            for minp in (1, 8):
                key = f"{name}_min_{minp}"
                sent = res[0][key]["msgs"]
                require(recv[key]["exact"] and all(
                    m == 64 // minp for m in sent),
                    f"{name} min_partitions {minp}: exact "
                    f"{recv[key]['exact']}, part_msgs {sent}")
                row[f"min_partitions_{minp}"] = {
                    "MB_s_by_round": [16 / t for t in recv[key]["s"]],
                    "MB_s_median": 16 / statistics.median(recv[key]["s"]),
                    "part_msgs": sent[0]}
            out[f"part_xfer_16MB_{name}"] = row
        out["part_xfer_wall_s"] = wall
        # (c) vprotocol: log card tensors, kill rank 1 mid-round, replay
        vp = tmp / "vp_job.py"
        vp.write_text(VP_JOB)
        logdir = tmp / "vp_logs"
        r, lines, wall_a = tpurun_any(
            3, ["--enable-recovery",
                "--mca", "vprotocol_pessimist_log", str(logdir),
                "--mca", "vprotocol_pessimist_log_payloads", "1",
                "--mca", "ft_detector", "true",
                "--mca", "ft_detector_period", "0.2",
                "--mca", "ft_detector_timeout", "1.5", py, str(vp)],
            timeout=120, env={"VP_NITER": "3", "VP_DIE": "1",
                              "VP_OUT": str(tmp / "vp_a")})
        done = [ln for rank in lines.values() for ln in rank
                if ln.startswith("DONE")]
        require(sorted(done) == ["DONE 0 True", "DONE 2 True"]
                and not (tmp / "vp_a.1.npy").exists(),
                f"the logging job: {done}\n{r.stderr[-3000:]}")
        logging = {rank: pml_line(lines, rank) for rank in (0, 2)}
        require(all(v[0] == "PessimistPml" for v in logging.values()),
                f"the logging job's pml: {logging}")
        log_bytes = sum(f.stat().st_size for f in logdir.iterdir())
        lines, wall_b = tpurun(
            3, ["--enable-recovery", "--mca", "vprotocol_pessimist_replay",
                str(logdir), py, str(vp)], timeout=120,
            env={"VP_NITER": "5", "VP_DIE": "0", "VP_OUT": str(tmp / "vp_b")})
        # every rank ran under ReplayPml and consumed its whole log: a live
        # rerun of the (deterministic) job would end in the same states
        replayed = {}
        for rank in range(3):
            events = read_log(str(logdir), rank)
            logged = (sum(e["kind"] == "send" for e in events),
                      sum(e["kind"] == "recv" for e in events))
            replayed[rank] = pml_line(lines, rank)
            require(all(logged) and replayed[rank] == ("ReplayPml", *logged),
                    f"rank {rank} replayed {replayed[rank]}, its log holds "
                    f"{logged} sends and receives")
        want = vp_expected(5)
        for rank in range(3):
            got = np.load(tmp / f"vp_b.{rank}.npy")
            require(got.tobytes() == want[rank].tobytes(),
                    f"rank {rank}'s state after the replay differs")
        out["vprotocol_3_replay"] = {
            "log_MB": log_bytes / MB, "log_wall_s": wall_a,
            "replay_wall_s": wall_b, "final_states_bit_exact": True,
            "replayed_sends_recvs_by_rank": {
                r: list(v[1:]) for r, v in replayed.items()}}
        # (d) MoeTrainer: chaos kill at step 5, re-shard over the survivors
        conf = dict(MOE_CONF, ckpt_dir=str(tmp / "moe_ckpt"))
        r, lines, wall = tpurun_any(
            3, ["--enable-recovery", "--mca", "otpu_chaos_spec",
                "kill:rank=2,step=5", py, "-m", "ompi_tpu_torch.parallel.moe",
                json.dumps(conf)], timeout=120)
        text = r.stdout + r.stderr
        rep = next((json.loads(ln.split("MOE ", 1)[1])
                    for ln in lines.get(0, []) if ln.startswith("MOE ")), None)
        require(r.returncode == 0 and rep is not None,
                f"the MoE job exited {r.returncode}:\n{text[-3000:]}")
        rec = rep["recoveries"][0] if rep["recoveries"] else {}
        require(rep["world_size"] == 2 and rep["step"] == 12
                and rec.get("failed") == [2] and rep["experts"] == [0, 4],
                f"the MoE job's report: world {rep['world_size']}, "
                f"experts {rep['experts']}, recoveries {rep['recoveries']}")
        tree = checkpoint.load(str(tmp / "moe_ckpt" /
                                   f"step{rec['resume_step']:06d}"),
                               device="cpu")
        E, D = MOE_CONF["n_experts"], MOE_CONF["expert_dim"]
        got = np.array(rep["w"], np.float64).tobytes()
        # from zeros over every step, as the trainer starts (so the saved
        # and restored slabs are held too), and from the checkpoint
        for w0, start in ((np.zeros(E * D), 0),
                          (tree["w"].numpy(), rec["resume_step"])):
            ref = moe.reference_moe_run(
                w0, start, MOE_CONF["steps"],
                tokens=MOE_CONF["tokens_per_step"], n_experts=E,
                expert_dim=D, seed=SEED)
            require(got == ref.tobytes(), f"the MoE job's experts differ "
                    f"from reference_moe_run from step {start}")
        out["moe_3_kill"] = {
            "experts_after": rep["experts"], "dispatched": rep["dispatched"],
            "dropped": rep["dropped"], "imbalance_max": rep["imbalance_max"],
            **{k: v for k, v in rec.items() if k.endswith("_ms")},
            "bit_exact": True, "wall_s": wall}
    out["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"partitioned_logging": out}))
    return out


DW_ELEMS = 16 * MB // 4        # 16 MB of float32 (or int32) a rank
DW_REPS = 10

DW_JOB = r"""
import hashlib, json, os, statistics, sys, time
import torch
import torch.distributed as dist
import ompi_tpu_torch as m
from ompi_tpu_torch.api.errhandler import ERRORS_RETURN
from ompi_tpu_torch.ops import flash_attention as fa
from ompi_tpu_torch.parallel import dryrun

SEED, ELEMS, REPS, LR = (int(sys.argv[1]), int(sys.argv[2]),
                         int(sys.argv[3]), float(sys.argv[4]))


def out(**kv):
    print(json.dumps(kv), flush=True)


def inputs(rank):
    gen = torch.Generator(device="cuda").manual_seed(SEED + rank)
    f = torch.randint(-64, 64, (ELEMS,), generator=gen, device="cuda") / 4.0
    i = torch.randint(1, 1 << 20, (ELEMS,), generator=gen, device="cuda",
                      dtype=torch.int32)
    rs = torch.randint(-64, 64, (2, ELEMS // 2), generator=gen,
                       device="cuda") / 8.0
    return {"f": f.float(), "i": i, "rs": rs.float()}


def same(got, want, what):
    # on the card, and bit for bit (float32 compared as its bits)
    assert got.device.type == "cuda", (what, got.device)
    assert got.dtype == want.dtype and got.shape == want.shape, (
        what, got.dtype, got.shape, want.dtype, want.shape)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), what


def ms(fn):
    for _ in range(2):
        fn()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        dist.barrier()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# (a) the cross-process module, sessions model only
s = m.Session.init(errhandler=ERRORS_RETURN)
assert not m.initialized()
g = m.Group.from_session_pset(s, "mpi://WORLD")
comm = m.Comm.create_from_group(g, "dw-card")
slot = comm.c_coll["allreduce_array"]
while hasattr(slot, "__wrapped__"):
    slot = slot.__wrapped__
module = type(slot.__self__).__name__
assert module == "MpCollModule", module
me = comm.rank
x = [inputs(r) for r in range(2)]
mine = x[me]
want = {"allreduce_sum": x[1]["f"] + x[0]["f"],
        "allreduce_band": x[1]["i"] & x[0]["i"],
        "bcast_root1": x[1]["f"].clone(),
        "allgather": torch.stack([x[0]["f"], x[1]["f"]]),
        "reduce_scatter": (x[1]["rs"] + x[0]["rs"])[me:me + 1]}
calls = {"allreduce_sum": lambda: comm.allreduce_array(mine["f"]),
         "allreduce_band": lambda: comm.allreduce_array(mine["i"], m.BAND),
         "bcast_root1": lambda: comm.bcast_array(mine["f"], root=1),
         "allgather": lambda: comm.allgather_array(mine["f"]),
         "reduce_scatter": lambda: comm.reduce_scatter_array(mine["rs"])}
slots_ms = {}
for name, fn in calls.items():
    same(fn(), want[name], name)
    slots_ms[name] = ms(fn)
barrier = comm.c_coll["device_barrier"]
barrier(comm)
slots_ms["device_barrier"] = ms(lambda: barrier(comm))
out(module=module, slots_ms=slots_ms, bit_exact=True,
    local_ranks=comm.rte.local_ranks)
comm.free()
s.finalize()

# (b) the step over the global mesh, after a fresh boot of the world
w = m.init()
group = w.rte.process_group
free, total = torch.cuda.mem_get_info()
procs = (dist.get_world_size(), dist.get_rank())
step, (p, xd), ms_spec = dryrun.make_step_and_args(
    w.rte.device, None, ranks=len(w.rte.global_ranks), lr=LR, procs=procs)
for k in fa.launches:
    fa.launches[k] = 0
p2, l1 = step(p, xd)
torch.cuda.synchronize()
first = dict(fa.launches)
_, l2 = step(p2, xd)
torch.cuda.synchronize()
second = {k: v - first.get(k, 0) for k, v in fa.launches.items()}
times = []
for _ in range(6):
    dist.barrier()
    t0 = time.perf_counter()
    step(p, xd)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
out(loss=[float(l1), float(l2)], k21=[first, second], mesh=ms_spec.sizes(),
    block=list(w.rte.local_ranks), free_MB_before_step=free / 2 ** 20,
    total_MB=total / 2 ** 20, step_ms_median=statistics.median(times),
    step_ms=times)
m.finalize()

# (c) init, finalize, init: the live group serves the re-boot
w = m.init()
assert w.rte.device_world_booted and w.rte.process_group is group
y = w.allreduce_array(torch.full((4,), float(w.rank + 1), device="cuda"))
assert y.device.type == "cuda" and y.tolist() == [3.0] * 4, y
out(reinit_same_group=True)
m.finalize()
"""

DW_HOST_JOB = r"""
import json, os
import numpy as np
import torch
import ompi_tpu_torch as m

w = m.init()
x = torch.full((1 << 18,), float(w.rank + 1), device="cuda")
got = np.asarray(w.allreduce(x))
want = float(sum(range(1, w.size + 1)))
print(json.dumps({"node": os.environ.get("OTPU_NODE_ID"),
                  "cpus": sorted(os.sched_getaffinity(0)),
                  "allreduce_exact": bool((got == want).all())}), flush=True)
m.finalize()
"""


def device_world_mp(smi: str) -> dict:
    """The multi-process device world and the launcher (phase 13 of the
    module docstring).  Returns the ``device_world_mp`` line's object."""
    import tempfile

    from ompi_tpu_torch.parallel import dryrun

    t_phase = time.perf_counter()
    out = {"card": smi}
    py = sys.executable
    # the single-process 8-rank step of the same spec and seed, first,
    # while the card is this process's alone
    step, state, _ = dryrun.make_step_and_args(lr=STEP_LR)
    new, l1 = step(*state)
    _, l2 = step(new, state[1])
    single = [float(l1), float(l2)]
    single_ms = step_ms({"single_process": (step, state)})["single_process"]
    del step, state, new
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        job = tmp / "dw_job.py"
        job.write_text(DW_JOB)
        lines, wall = tpurun(2, ["--device-world", "--local-devices", "4",
                                 py, str(job), str(SEED), str(DW_ELEMS),
                                 str(DW_REPS), str(STEP_LR)], timeout=400)
        res = {}
        for rank in range(2):
            objs = [json.loads(x) for x in lines.get(rank, [])
                    if x.startswith("{")]
            res[rank] = {k: v for o in objs for k, v in o.items()}
            require(res[rank].get("reinit_same_group") is True,
                    f"rank {rank} did not finish: {lines.get(rank)}")
        per_step = k21_per_step(STEP_MESHES["default"])
        for rank, r in res.items():
            require(r["k21"] == [{"flash_block": per_step}] * 2,
                    f"rank {rank} launched K21 {r['k21']} in its two steps, "
                    f"want {per_step} each")
            a, b = r["loss"]
            require(math.isfinite(a) and b < a,
                    f"rank {rank}'s steps do not descend: {r['loss']}")
            rel = max(abs(g - w) / abs(w) for g, w in zip(r["loss"], single))
            require(rel <= 1e-5, f"rank {rank}'s losses {r['loss']} differ "
                    f"from the single-process step's {single} by {rel:.3e}")
        out["job_2x4"] = {
            "module": res[0]["module"], "slots_16MB_ms_by_rank": {
                r: v["slots_ms"] for r, v in res.items()},
            "slots_bit_exact": all(v["bit_exact"] for v in res.values()),
            "mesh": res[0]["mesh"], "loss_mp": res[0]["loss"],
            "loss_single_process": single,
            "loss_bit_equal": all(v["loss"] == single for v in res.values()),
            "k21_per_step_by_rank": {r: v["k21"][1]["flash_block"]
                                     for r, v in res.items()},
            "step_ms_median_by_rank": {r: v["step_ms_median"]
                                       for r, v in res.items()},
            "step_ms_by_rank": {r: v["step_ms"] for r, v in res.items()},
            "single_process_step_ms": single_ms,
            "free_MB_before_step_by_rank": {
                r: v["free_MB_before_step"] for r, v in res.items()},
            "reinit_same_group": True, "wall_s": wall}
        # (b) the hostfile job: two emulated hosts, bound ranks, the matrix
        hosts = tmp / "hosts.txt"
        hosts.write_text("hostA slots=2\nhostB slots=2\n")
        host_job = tmp / "dw_host.py"
        host_job.write_text(DW_HOST_JOB)
        lines, wall = tpurun(4, ["--hostfile", str(hosts), "--launch-agent",
                                 "local", "--bind-to", "core", "--mca",
                                 "hook_comm_method_display", "1", py,
                                 str(host_job)], timeout=200)
        ranks = {r: job_result(lines, r) for r in range(4)}
        matrix = sorted(x for rank in lines.values() for x in rank
                        if x.startswith("[comm_method]"))
        require(len(matrix) == 4, f"the comm_method matrix: {matrix}")
        for host, pair in (("hostA", (0, 1)), ("hostB", (2, 3))):
            a, b = (ranks[r] for r in pair)
            require(a["node"] == b["node"] == host
                    and not set(a["cpus"]) & set(b["cpus"]),
                    f"{host}'s ranks: {a}, {b}")
        require(all(v["allreduce_exact"] for v in ranks.values()),
                f"the host-tier allreduce: {ranks}")
        out["hostfile_4"] = {"affinity_by_rank": {
            r: v["cpus"] for r, v in ranks.items()},
            "nodes": {r: v["node"] for r, v in ranks.items()},
            "comm_method": matrix, "wall_s": wall}
    out["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"device_world_mp": out}))
    return out


SERVE_FAIL_JOB = """
import json
import ompi_tpu_torch
from ompi_tpu_torch.serving import ContinuousBatchScheduler, Router, ShardWorker
from ompi_tpu_torch.serving.worker import toy_token

w = ompi_tpu_torch.init()
if w.rank == 0:
    r = Router(w, scheduler=ContinuousBatchScheduler(
                   max_batch=6, max_batch_tokens=1 << 14), decode_chunk=2)
    subs = [r.submit(8 + (i % 5), 6 + (i % 7)) for i in range(24)]
    done = r.serve_until_drained(max_ticks=20000)
    exact = all(q.tokens == [toy_token(q.rid, i)
                             for i in range(q.max_new_tokens)] for q in subs)
    s = ompi_tpu_torch.Session.init()
    surviving = list(s.group_from_pset("mpi://surviving").world_ranks)
    s.finalize()
    r.shutdown()
    print(json.dumps({"submitted": len(subs), "done": len(done),
                      "unique": len({q.rid for q in done}), "exact": exact,
                      "requeued": r.lost_and_requeued,
                      "workers": r.workers, "surviving": surviving,
                      "device": str(w.rte.device)}), flush=True)
else:
    ShardWorker(w, router=0).serve()
    print(json.dumps({"worker": w.rank, "ok": True}), flush=True)
"""


def serve_engine(world, name: str, workers: list, router_kw: dict,
                 driver_kw: dict) -> dict:
    """One in-process engine run: the workers' serve loops on threads, the
    router and the Poisson driver on a thread of their own, so a hung tick
    fails the phase at its time limit instead of holding the card."""
    from ompi_tpu_torch.runtime import spc
    from ompi_tpu_torch.serving import (ContinuousBatchScheduler,
                                        PoissonDriver, Router)
    from ompi_tpu_torch.serving.worker import toy_token

    loops = [threading.Thread(target=w.serve, daemon=True) for w in workers]
    for t in loops:
        t.start()
    result = {}

    def drive():
        try:
            sched = ContinuousBatchScheduler(max_batch=8,
                                             max_batch_tokens=1 << 14, slots=8)
            r = Router(world.as_rank(0), scheduler=sched,
                       workers=[w.comm.rank for w in workers], **router_kw)
            drv = PoissonDriver(**driver_kw)
            a0 = spc.read("serve_spec_accepts")
            r0 = spc.read("serve_spec_rejects")
            rep = drv.run(r, max_wall_s=90)
            r.shutdown()
            done = r.completed()
            result.update(rep, exact=all(
                q.tokens == [toy_token(q.rid, i)
                             for i in range(q.max_new_tokens)]
                for q in done), submitted=drv.n_requests,
                spec_accepted=spc.read("serve_spec_accepts") - a0,
                spec_rejected=spc.read("serve_spec_rejects") - r0)
        except Exception as e:         # reported by the require below
            result["error"] = repr(e)

    driver = threading.Thread(target=drive, daemon=True)
    driver.start()
    driver.join(timeout=150)
    require(not driver.is_alive(), f"serving {name}: the engine hung")
    for t in loops:
        t.join(timeout=10)
    require(not any(t.is_alive() for t in loops),
            f"serving {name}: a worker's serve loop did not stop")
    require("error" not in result
            and result.get("requests") == result.get("submitted")
            == driver_kw["n_requests"] and result["exact"],
            f"serving {name}: {result}")
    return result


def serving(smi: str) -> dict:
    """The serving engine (phase 14 of the module docstring).  Returns the
    ``serving`` line's object."""
    import tempfile

    import ompi_tpu_torch
    from ompi_tpu_torch.mca.part import part_framework
    from ompi_tpu_torch.runtime import init as rt
    from ompi_tpu_torch.runtime import spc
    from ompi_tpu_torch.serving import ShardWorker

    t_phase = time.perf_counter()
    out = {"card": smi}
    py = sys.executable
    # (a) in process, on the card's device world
    world = ompi_tpu_torch.init()
    require(world.rte.device.type == "cuda",
            f"the device world is on {world.rte.device}")
    part_framework().open()
    reset_counts()
    stream = dict(rate_rps=400.0, n_requests=48, prompt_lens=(8, 64),
                  decode_lens=(4, 24), seed=SEED)
    out["colocated_2w"] = serve_engine(
        world, "colocated", [ShardWorker(world.as_rank(r), router=0)
                             for r in (1, 2)],
        dict(decode_chunk=4), stream)
    verified = []
    pre = ShardWorker(world.as_rank(1), router=0, role="prefill", peer=2,
                      slots=8, kv_elems=1024, kv_codec="int8")
    dec = ShardWorker(world.as_rank(2), router=0, role="decode", peer=1,
                      slots=8, kv_elems=1024, kv_partitions=16,
                      kv_codec="int8")
    on_kv = dec._on_kv

    def counted(epoch, batch):
        on_kv(epoch, batch)            # raises on a block outside the band
        verified.extend(rid for rid, _ in batch)

    dec._on_kv = counted
    epochs0 = spc.read("serve_kv_epochs")
    staged = serve_engine(world, "staged", [pre, dec],
                          dict(stages=True, decode_chunk=4, kv_elems=1024),
                          {**stream, "n_requests": 32})
    require(sorted(verified) == sorted(set(verified))
            and len(verified) == staged["requests"],
            f"staged: {len(verified)} KV blocks verified for "
            f"{staged['requests']} requests")
    staged.update(kv_blocks_verified=len(verified), kv_codec="int8",
                  slots=8, receiver_partitions=16,
                  kv_epochs=spc.read("serve_kv_epochs") - epochs0)
    out["staged_int8"] = staged
    ab = {}
    for k in (0, 4):
        ab[f"spec_k_{k}"] = serve_engine(
            world, f"spec_k {k}", [ShardWorker(world.as_rank(1), router=0,
                                               spec_k=k)],
            dict(decode_chunk=4), {**stream, "n_requests": 24,
                                   "seed": SEED + 1})
    require(ab["spec_k_0"]["tokens"] == ab["spec_k_4"]["tokens"]
            and ab["spec_k_0"]["spec_accepted"] == 0
            and ab["spec_k_4"]["spec_accepted"] > 0
            and ab["spec_k_4"]["spec_rejected"] > 0,
            f"the speculative A/B: {ab}")
    out["spec_ab"] = ab
    launched = {k: v for k, v in counts().items() if v}
    require(not launched, f"the serving engine launched kernels: {launched}")
    out["kernel_launches"] = 0
    rt.finalize()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # (b) the demo across three processes, roles from the flags
        lines, wall = tpurun(3, ["--router-ranks", "0", "--worker-ranks",
                                 "1,2", py, "-m",
                                 "ompi_tpu_torch.examples.serving_demo"],
                             timeout=200)
        roles = {r: [json.loads(x.split("ROLES ", 1)[1]) for x in lines.get(
            r, []) if x.startswith("ROLES ")] for r in range(3)}
        require(all(v == [{"rank": r, "router": 0, "workers": [1, 2]}]
                    for r, v in roles.items()), f"the demo's roles: {roles}")
        ok = [json.loads(x.split("SERVING DEMO OK ", 1)[1])
              for x in lines.get(0, []) if x.startswith("SERVING DEMO OK ")]
        require(len(ok) == 1 and ok[0]["requests"] == 32,
                f"the demo's OK line: {lines.get(0)}")
        out["demo_3proc"] = {"report": ok[0], "roles": roles[0][0],
                             "wall_s": wall}
        # (c) serve through failure: rank 2 killed at its third micro-batch
        job = tmp / "serve_fail.py"
        job.write_text(SERVE_FAIL_JOB)
        r, lines, wall = tpurun_any(
            4, ["--enable-recovery", "--mca", "otpu_chaos_spec",
                "kill:rank=2,site=serve_work,count=2", py, str(job)],
            timeout=200)
        res = job_result(lines, 0)
        require(res["done"] == res["unique"] == res["submitted"] == 24
                and res["exact"] and res["requeued"] > 0
                and res["workers"] == [1, 2] and 2 not in res["surviving"]
                and res["device"].startswith("cuda"),
                f"serve through failure: {res}\n{r.stderr[-3000:]}")
        require(all(job_result(lines, w)["ok"] for w in (1, 3)),
                f"the surviving workers: {lines}")
        out["serve_through_failure_4"] = {
            "dropped": res["submitted"] - res["done"],
            "requeued": res["requeued"], "exit_code": r.returncode,
            "wall_s": wall}
    out["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"serving": out}))
    return out


FLEET_SOAK_JOB = """
import json
import sys
import time

import ompi_tpu_torch
from ompi_tpu_torch.base.var import registry
from ompi_tpu_torch.runtime import trace
from ompi_tpu_torch.serving import (FleetController, MixedPoissonDriver,
                                    ShardWorker)
from ompi_tpu_torch.serving.worker import toy_token

N_A, N_B = 24, 16
SETTLE_S = float(sys.argv[1]) if len(sys.argv) > 1 else 1.0
w = ompi_tpu_torch.init()
if w.rank == 0:
    # pools from the --pool psets; an autoscaled worker names the card
    fleet = FleetController(
        w, tenants={"ten_a": 2, "ten_b": 1},
        spawn_argv=[sys.executable, "-m", "ompi_tpu_torch.serving.worker",
                    "cuda"],
        autoscale=dict(poll_ticks=2, depth_high=None, cooldown=25,
                       slo_p99_ms=2.0, max_workers=3, idle_patience=10**9))
    pools0 = fleet.pool_workers()
    registry.set("otpu_trace_enable", True)   # the ring outlives the run
    rep = MixedPoissonDriver({
        "ten_a": dict(model="m_a", rate_rps=300, n_requests=N_A,
                      prompt_lens=(4, 16), decode_lens=(4, 10),
                      prefixes=2, prefix_len=32),
        "ten_b": dict(model="m_b", rate_rps=200, n_requests=N_B,
                      prompt_lens=(4, 16), decode_lens=(4, 10),
                      prefixes=1, prefix_len=16),
    }, seed=3).run(fleet, max_wall_s=150)
    ups_during_load = fleet.stats()["autoscale"]["ups"]
    # the control loop outlives the burst, as a deployed fleet's does: the
    # autoscaler reads the router's telemetry sample, which closes up to
    # one sampler interval (50 ms here) after the last completion
    t_end = time.monotonic() + SETTLE_S
    while time.monotonic() < t_end:
        fleet.tick()
        time.sleep(0.001)
    done = fleet.completed()
    ring = [e[6] for e in trace._ring if e is not None
            and e[1] == "fleet_scale"]
    ups = [d for d in ring if d.get("dir") == "up"
           and d.get("signal") in ("p99", "stale_rank")]
    spawned = [(d["pool"], d["rank"]) for d in ups if d.get("how") == "spawn"]
    pools = fleet.pool_workers()
    devices = [w.rte.modex_get(fleet.comm.group.world_rank(r), "device")
               for _, r in spawned]
    st = fleet.stats()
    fleet.shutdown()
    print(json.dumps({
        "submitted": N_A + N_B, "done": len(done),
        "unique": len({q.rid for q in done}),
        "exact": all(q.tokens == [toy_token(q.rid, i)
                                  for i in range(q.max_new_tokens)]
                     for q in done),
        "requeued": rep["requeued"], "prefix_hits": rep["prefix_hits"],
        "prefills": rep["prefills"], "ups": ups, "spawned": spawned,
        "ups_during_load": ups_during_load,
        "spawned_in_pool": all(r in pools[p] for p, r in spawned),
        "spawned_devices": devices, "pools_before": pools0,
        "pools_after": pools, "autoscale": st["autoscale"],
        "device": str(w.rte.device)}), flush=True)
else:
    if w.rank == 2:
        # permit 2 micro-batches, die on the 3rd: mid-load, results unsent
        from ompi_tpu_torch.ft import chaos
        chaos.install_spec("kill:rank=2,site=serve_work,count=2")
    ShardWorker(w, router=0).serve()
    print(json.dumps({"worker": w.rank, "ok": True}), flush=True)
"""

SHMEM_JOB = """
import json
import math
import time

import numpy as np

import ompi_tpu_torch.shmem as shmem

ctx = shmem.init()
me, n = shmem.my_pe(), shmem.n_pes()
right, left = (me + 1) % n, (me - 1) % n
checks = {}

x = shmem.array(4, np.float64)
x.local[:] = me * 10.0
shmem.barrier_all()
checks["get"] = shmem.get(x, 4, right).tolist() == [right * 10.0] * 4
shmem.barrier_all()
shmem.p(x, 500.0 + me, left, index=1)
shmem.barrier_all()
checks["put"] = x.local[1] == 500.0 + right

c = shmem.calloc(1, np.int64)
shmem.barrier_all()
old = shmem.atomic_fetch_add(c, me + 1, 0)
e = shmem.array(1, np.int64)
e.local[0] = -1
shmem.barrier_all()
prev = shmem.atomic_compare_swap(e, -1, me, 0)
shmem.barrier_all()
wins = np.asarray(ctx.world.allgather(
    np.array([1 if prev == -1 else 0], np.int64)))
checks["atomics"] = bool(0 <= old <= n * (n + 1) // 2 and wins.sum() == 1
                         and (me != 0 or c.local[0] == n * (n + 1) // 2))

y = shmem.array(3, np.float64)
y.local[:] = [me + 1.0, me * 2.0, -me]
shmem.sum_to_all(y)
z = shmem.array(1, np.int64)
z.local[0] = me * me
col = shmem.collect(z)
b = shmem.array(3, np.float64)
b.local[:] = me
shmem.broadcast(b, root=n - 1)
pr = shmem.array(1, np.int64)
pr.local[0] = me + 1
shmem.prod_to_all(pr)
checks["collectives"] = bool(
    np.array_equal(y.local, np.array([n * (n + 1) / 2, n * (n - 1),
                                      -n * (n - 1) / 2]))
    and col.tolist() == [i * i for i in range(n)]
    and b.local.tolist() == [n - 1.0] * 3
    and pr.local[0] == math.factorial(n))

lock = shmem.calloc(1, np.int64)
tot = shmem.calloc(1, np.int64)
shmem.barrier_all()
for _ in range(3):
    shmem.set_lock(lock)
    v = int(shmem.g(tot, 0))
    shmem.p(tot, v + 1, 0)
    shmem.quiet()
    shmem.clear_lock(lock)
shmem.barrier_all()
checks["locks"] = me != 0 or int(tot.local[0]) == 3 * n

flags = shmem.calloc(1, np.int64)
shmem.barrier_all()
cx = shmem.ctx_create(shmem.Ctx.PRIVATE)
cx.atomic_add(flags, 1, pe=0)
cx.quiet()
shmem.ctx_destroy(cx)
shmem.barrier_all()
checks["context"] = me != 0 or int(flags.local[0]) == n

# smoke readings: an 8 B p and g to the right neighbour, a 4 MB put
w8 = shmem.array(1, np.int64)
big = shmem.array(1 << 19, np.float64)
payload = np.random.default_rng(me).standard_normal(1 << 19)
shmem.barrier_all()
reps = 200
t0 = time.perf_counter()
for i in range(reps):
    shmem.p(w8, i, right)
shmem.quiet()
p_us = (time.perf_counter() - t0) / reps * 1e6
t0 = time.perf_counter()
for _ in range(reps):
    shmem.g(w8, right)
g_us = (time.perf_counter() - t0) / reps * 1e6
shmem.barrier_all()
t0 = time.perf_counter()
for _ in range(5):
    shmem.put(big, payload, right)
shmem.quiet()
put_s = (time.perf_counter() - t0) / 5
shmem.barrier_all()
checks["put_4mb"] = bool(np.array_equal(
    big.local, np.random.default_rng(left).standard_normal(1 << 19)))
print(json.dumps({"pe": me, "n": n,
                  "checks": {k: bool(v) for k, v in checks.items()},
                  "heap_window": [type(ctx.win.local).__name__,
                                  str(ctx.win.local.dtype),
                                  bool(ctx.win.byte_addressed)],
                  "device": str(ctx.world.rte.device),
                  "p_8B_us": p_us, "g_8B_us": g_us,
                  "put_4MB_MBps": (8 << 19) / put_s / 1e6}), flush=True)
shmem.barrier_all()
shmem.finalize()
"""


def fleet_in_process(world) -> dict:
    """(a): the fleet over the card's device world; the router and its four
    workers on threads over ``as_rank`` views."""
    from ompi_tpu_torch.base.var import registry
    from ompi_tpu_torch.runtime import telemetry, trace
    from ompi_tpu_torch.serving import (FleetController, MixedPoissonDriver,
                                        PoolSpec, ShardWorker)
    from ompi_tpu_torch.serving.router import TENANT_HIST_PREFIX
    from ompi_tpu_torch.serving.worker import toy_token

    workers = [ShardWorker(world.as_rank(r), router=0) for r in (1, 2, 3, 4)]
    loops = [threading.Thread(target=w.serve, daemon=True) for w in workers]
    for t in loops:
        t.start()
    result = {}
    registry.set("otpu_trace_enable", True)

    def drive():
        try:
            fleet = FleetController(
                world.as_rank(0),
                pools=[PoolSpec("m_a", [1, 2], max_batch=6,
                                max_batch_tokens=1 << 13),
                       PoolSpec("m_b", [3, 4], max_batch=6,
                                max_batch_tokens=1 << 13)],
                tenants={"ten_a": 2, "ten_b": 1},
                autoscale=dict(poll_ticks=2, idle_patience=3, cooldown=4,
                               slo_p99_ms=1e-4, min_workers=1,
                               watch_stale=False))
            for _ in range(30):          # idle: each pool parks a rank
                fleet.tick()
            parked = fleet.stats()["reserve"]
            rep = MixedPoissonDriver({
                "ten_a": dict(model="m_a", rate_rps=400.0, n_requests=30,
                              prompt_lens=(8, 48), decode_lens=(4, 16),
                              prefixes=3, prefix_len=32),
                "ten_b": dict(model="m_b", rate_rps=250.0, n_requests=18,
                              prompt_lens=(8, 48), decode_lens=(4, 16),
                              prefixes=2, prefix_len=16),
            }, seed=SEED).run(fleet, max_wall_s=120, check_invariants=True)
            done = fleet.completed()
            ring = [e[6] for e in trace._ring if e is not None
                    and e[1] == "fleet_scale"]
            hists = sorted({k[0] for k, v in trace.hist_snapshot().items()
                            if k[0].startswith(TENANT_HIST_PREFIX) and v[0]})
            source = telemetry._sources.get("fleet") is not None
            st = fleet.stats()
            fleet.shutdown()
            result.update(
                requests=rep["requests"], done=len(done),
                exact=all(q.tokens == [toy_token(q.rid, i)
                                       for i in range(q.max_new_tokens)]
                          for q in done),
                prefix_hits=rep["prefix_hits"], prefills=rep["prefills"],
                tenants={k: {m: v[m] for m in ("requests", "p50_ms", "p99_ms",
                                                "p99_exact_ms",
                                                "tokens_per_s")}
                         for k, v in rep["tenants"].items()},
                tokens_per_s=rep["tokens_per_s"], tenant_hists=hists,
                parked_after_idle=parked,
                retires=[d for d in ring if d["dir"] == "down"
                         and d["signal"] == "idle"],
                enlists=[d for d in ring if d["dir"] == "up"
                         and d.get("how") == "enlist"],
                pools_after=fleet.pool_workers(), fleet_source=source,
                autoscale=st["autoscale"])
        except Exception as e:          # reported by the require below
            result["error"] = repr(e)

    driver = threading.Thread(target=drive, daemon=True)
    driver.start()
    driver.join(timeout=150)
    registry.set("otpu_trace_enable", False)
    require(not driver.is_alive(), "fleet_pgas (a): the fleet hung")
    for t in loops:
        t.join(timeout=10)
    require(not any(t.is_alive() for t in loops),
            "fleet_pgas (a): a worker's serve loop did not stop")
    require("error" not in result and result["requests"] == result["done"]
            == 48 and result["exact"] and result["prefix_hits"] > 0
            and result["tenant_hists"] == [TENANT_HIST_PREFIX + "ten_a",
                                           TENANT_HIST_PREFIX + "ten_b"]
            and all(t["p99_ms"] > 0 for t in result["tenants"].values())
            and result["retires"] and result["enlists"]
            and result["fleet_source"], f"fleet_pgas (a): {result}")
    return result


def tool_and_debugger(world) -> dict:
    """(d): MPI_T and the debugger views in the card's device world."""
    from ompi_tpu_torch.api import tool
    from ompi_tpu_torch.runtime import debugger

    tool.init_thread()
    try:
        i = tool.cvar_get_index("otpu_coll_tuned_allreduce_algorithm")
        old = tool.cvar_read(i)
        tool.cvar_write(i, "ring")
        written = (tool.cvar_read(i), tool.cvar_get_info(i).source_detail)
        tool.cvar_write(i, old or "")
        p = tool.pvar_get_index("otpu_runtime_spc_device_collectives")
        session = tool.pvar_session_create()
        h = session.handle_alloc(p)
        x = torch.ones((world.size, 1024), device=world.rte.device)
        reset_counts()
        h.start()
        calls = 5
        for _ in range(calls):
            world.allreduce_array(x)
        torch.cuda.synchronize()
        delta = h.read()
        h.stop()
        allreduce_launches = {k: v for k, v in counts().items() if v}
        tool.pvar_session_free(session)
        cats = [tool.category_get_info(k)[0]
                for k in range(tool.category_get_num())]
    finally:
        tool.finalize()
    dup = world.dup()
    dup.set_name("fleet_pgas_dup")
    dump = debugger.dump()
    names = [r["name"] for r in dump["comms"]]
    devices = sorted({r["device"] for r in dump["procs"]})
    dup.free()
    out = {"cvar_written": list(written), "pvar_calls": calls,
           "pvar_delta": delta, "allreduce_launches": allreduce_launches,
           "categories": len(cats), "comms": names,
           "procs": len(dump["procs"]), "proc_devices": devices,
           "queue_rows": len(dump["message_queues"])}
    require(written == ("ring", "MPI_T") and delta == calls
            and "coll" in cats and "COMM_WORLD" in names
            and "fleet_pgas_dup" in names and len(dump["procs"]) == world.size
            and devices and all(d.startswith("cuda") for d in devices),
            f"fleet_pgas (d): {out}")
    return out


def fleet_pgas(smi: str) -> dict:
    """The serving fleet and the PGAS/tool surfaces (phase 15 of the module
    docstring).  Returns the ``fleet_pgas`` line's object."""
    import ompi_tpu_torch
    from ompi_tpu_torch.mca.part import part_framework
    from ompi_tpu_torch.runtime import init as rt

    t_phase = time.perf_counter()
    out = {"card": smi}
    py = sys.executable
    world = ompi_tpu_torch.init()
    require(world.rte.device.type == "cuda",
            f"the device world is on {world.rte.device}")
    part_framework().open()
    reset_counts()
    t = time.perf_counter()
    out["fleet_in_process"] = fleet_in_process(world)
    out["fleet_in_process"]["wall_s"] = time.perf_counter() - t
    launched = {k: v for k, v in counts().items() if v}
    require(not launched, f"the fleet launched kernels: {launched}")
    out["tool_debugger"] = tool_and_debugger(world)
    rt.finalize()
    reset_counts()
    # (b) across processes: the bounded chaos soak
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        job = Path(tmp, "fleet_soak.py")
        job.write_text(FLEET_SOAK_JOB)
        r, lines, wall = tpurun_any(
            5, ["--enable-recovery", "--pool", "m_a:1,2", "--pool", "m_b:3,4",
                "--mca", "otpu_telemetry_interval_ms", "50", py, str(job)],
            timeout=240)
        res = job_result(lines, 0)
        require(res["done"] == res["unique"] == res["submitted"] == 40
                and res["exact"] and res["requeued"] > 0
                and res["prefix_hits"] > 0
                and any(d["signal"] == "p99" for d in res["ups"])
                and res["spawned"] and res["spawned_in_pool"]
                and all(d.startswith("cuda") for d in res["spawned_devices"])
                and res["device"].startswith("cuda"),
                f"fleet_pgas (b): {res}\n{r.stderr[-3000:]}")
        out["fleet_soak_5"] = dict(res, dropped=res["submitted"] - res["done"],
                                   exit_code=r.returncode, wall_s=wall)
        # (c) shmem across four processes
        job = Path(tmp, "shmem_job.py")
        job.write_text(SHMEM_JOB)
        lines, wall = tpurun(4, [py, str(job)], timeout=180)
        pes = [job_result(lines, pe) for pe in range(4)]
        require(all(all(p["checks"].values()) and p["n"] == 4
                    and p["heap_window"] == ["ndarray", "uint8", True]
                    and p["device"].startswith("cuda") for p in pes),
                f"fleet_pgas (c): {pes}")
        out["shmem_4"] = {
            "checks": sorted(pes[0]["checks"]),
            "p_8B_us": [p["p_8B_us"] for p in pes],
            "g_8B_us": [p["g_8B_us"] for p in pes],
            "put_4MB_MBps": [p["put_4MB_MBps"] for p in pes],
            "wall_s": wall}
    launched = {k: v for k, v in counts().items() if v}
    require(not launched, f"the fleet/shmem jobs launched kernels in this "
            f"process: {launched}")
    out["kernel_launches_outside_d"] = 0
    out["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"fleet_pgas": out}))
    return out


# -- the compile gate and phase 16: the operator tools ----------------------

def start_gate(gate_dir: str) -> subprocess.Popen:
    """Start ``tools/cuda_aot`` (every kernel compiled for sm_90a into
    ``gate_dir``, never the build cache) beside the build."""
    return subprocess.Popen(
        [sys.executable, "-m", "ompi_tpu_torch.tools.cuda_aot", "--out",
         os.path.join(gate_dir, "cuda_aot.json")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_gate(gate: subprocess.Popen, gate_dir: str) -> dict:
    """Wait for the gate and print its ``cuda_aot`` line: every CUDA C++
    kernel instance's row, the Triton instances summed by kernel.  Fails
    unless every instance compiled and the gate's requirements hold (K20's
    wgmma body issues HGMMA and UTMALDG; the mover's four ``mover_kernel``
    instances issue UBLKCP and no copy kernel spills; K21's eight instances
    issue FFMA, LDS.128 and LDGSTS and none spills)."""
    import shutil

    out, err = gate.communicate(timeout=900)
    path = Path(gate_dir, "cuda_aot.json")
    require(path.exists(), f"cuda_aot wrote no report (exit {gate.returncode})"
            f":\n{out[-2000:]}\n{err[-3000:]}")
    report = json.loads(path.read_text())
    shutil.rmtree(gate_dir, ignore_errors=True)
    triton = {}
    for r in report["rows"]:
        if r["route"] != "triton":
            continue
        name = r["kernel"].split("[")[0]
        t = triton.setdefault(name, {"instances": 0, "compiled": 0,
                                     "registers": [], "shared_bytes": [],
                                     "spill_bytes": [], "compile_s": 0.0})
        t["instances"] += 1
        t["compiled"] += int(r["compiled"])
        t["compile_s"] += r.get("compile_s", 0.0)
        for key in ("registers", "shared_bytes", "spill_bytes"):
            if r.get(key) is not None:
                t[key].append(r[key])
    for t in triton.values():
        for key in ("registers", "shared_bytes", "spill_bytes"):
            vals = t.pop(key)
            t[key] = [min(vals), max(vals)] if vals else None
    cuda = [{k: v for k, v in r.items() if k != "route"}
            | {"sass": {op: n for op, n in r.get("sass", {}).items() if n}}
            for r in report["rows"] if r["route"] == "cuda"]
    log(json.dumps({"cuda_aot": {
        k: report[k] for k in ("target", "ok", "n_kernels", "n_compiled",
                               "elapsed_s", "missing", "problems")}
        | {"exit_code": gate.returncode, "cuda": cuda, "triton": triton}}))
    bad = [r for r in report["rows"] if not r["compiled"]]
    require(report["ok"] and gate.returncode == 0 and not bad,
            f"cuda_aot: {report['n_compiled']} of {report['n_kernels']} "
            f"compiled, missing {report['missing']}: {bad[:3]}\n{err[-2000:]}")
    require(not report["problems"], f"cuda_aot: {report['problems']}")
    return report


#: the analysis phase's subprocesses (run from the checkout's root)
ANALYSIS_JOBS = {
    "otpu_lint": ["-m", "ompi_tpu_torch.tools.otpu_lint", "ompi_tpu_torch/",
                  "--timings"],
    "scenarios": ["-m", "ompi_tpu_torch.analysis.scenarios"],
    "otpu_info": ["-m", "ompi_tpu_torch.tools.otpu_info", "--lint",
                  "--parsable"],
}
#: the scenarios' expected outcome: a reverted race's replay string, a
#: fixed twin's number of schedules (the reference's)
ANALYSIS_FAILS = {"staging-checkout": "staging-checkout@pb2:0.0.0.1.1.1.0",
                  "tcp-conns": "tcp-conns@pb2:0.0.1.1.1.0",
                  "coord-fence": "coord-fence@pb1:0.0.1.2"}
ANALYSIS_PASSES = {"staging-checkout-fixed": 14, "tcp-conns-fixed": 14,
                   "coord-fence-fixed": 287}


def start_analysis(work_dir: str) -> dict:
    """Start the analysis phase's three subprocesses at once, their output
    to files under ``work_dir``; a thread a process notes when it ends."""
    import threading

    root = str(Path(__file__).resolve().parent)
    jobs = {}
    for name, argv in ANALYSIS_JOBS.items():
        out = open(os.path.join(work_dir, f"{name}.out"), "w")
        err = open(os.path.join(work_dir, f"{name}.err"), "w")
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, *argv], stdout=out,
                                stderr=err, cwd=root)
        out.close()
        err.close()
        job = {"proc": proc, "t0": t0, "t1": None}

        def note_end(job=job):
            job["proc"].wait()
            job["t1"] = time.perf_counter()

        job["thread"] = threading.Thread(target=note_end, daemon=True)
        job["thread"].start()
        jobs[name] = job
    return jobs


def finish_analysis(jobs: dict, work_dir: str, smi: str) -> dict:
    """Wait for the analysis subprocesses and print the ``analysis`` line.
    Fails unless the lint is clean over 8 passes with no unused baseline
    entry, every scenario ends as expected and ``otpu_info`` lists 8
    passes."""
    import re
    import shutil

    said, errs, wall = {}, {}, {}
    try:
        for name, job in jobs.items():
            rc = job["proc"].wait(timeout=600)
            job["thread"].join(timeout=60)
            wall[name] = job["t1"] - job["t0"]
            said[name] = Path(work_dir, f"{name}.out").read_text()
            errs[name] = Path(work_dir, f"{name}.err").read_text()
            require(rc == 0, f"analysis: {name} exited {rc}:\n"
                    f"{said[name][-3000:]}\n{errs[name][-3000:]}")
    finally:
        for job in jobs.values():
            if job["proc"].poll() is None:
                job["proc"].kill()
                job["proc"].wait()
        shutil.rmtree(work_dir, ignore_errors=True)
    m = re.search(r"otpu-lint: (\d+) finding\(s\), (\d+) suppressed, "
                  r"(\d+) parse error\(s\), (\d+) unused suppression\(s\) "
                  r"\[(\d+) passes over (\d+) files\]", said["otpu_lint"])
    require(m is not None, f"otpu_lint printed no summary:\n"
            f"{said['otpu_lint'][-2000:]}{errs['otpu_lint'][-2000:]}")
    findings, suppressed, errors, unused, passes, files = map(int, m.groups())
    require((findings, errors, unused, passes) == (0, 0, 0, 8),
            f"otpu_lint: {m.group(0)}")
    pass_ms = {k: float(v) for k, v in re.findall(
        r"^\s+([\w-]+):\s+([\d.]+) ms$", said["otpu_lint"], re.M)}
    total_ms = pass_ms.pop("total", None)
    require(len(pass_ms) == 8, f"otpu_lint --timings: {pass_ms}")
    schedules = {k: int(v) for k, v in re.findall(
        r"weave\[([\w-]+)\]: PASS — (\d+) schedule", said["scenarios"])}
    replays = dict(re.findall(r"weave\[([\w-]+)\]: FAIL .*\n\s+replay: (\S+)",
                              said["scenarios"]))
    require(schedules == ANALYSIS_PASSES and replays == ANALYSIS_FAILS
            and said["scenarios"].count("ok   ") == 6,
            f"scenarios: {schedules} {replays}\n{said['scenarios']}")
    rows = [ln for ln in said["otpu_info"].splitlines()
            if ln.startswith("lint pass ")]
    require(len(rows) == 8, f"otpu_info --lint: {rows}")
    out = {"card": smi, "findings": findings, "suppressed": suppressed,
           "parse_errors": errors, "unused_suppressions": unused,
           "passes": passes, "files": files, "pass_ms": pass_ms,
           "lint_total_ms": total_ms, "schedules": schedules,
           "failing_replays": replays, "otpu_info_rows": len(rows),
           "wall_s": wall}
    log(json.dumps({"analysis": out}))
    return out


#: the tools phase's job: 3 ranks of card tensors for TOOLS_SECS seconds
TOOLS_SECS = 4.0
TOOLS_NPROCS = 3


def top_polls(port: int, nprocs: int, deadline: float, job) -> list:
    """``otpu_top --json --count 1`` attached from outside the job, once a
    poll, until every rank showed a sample whose sequence number advanced
    past an earlier poll's (the sampler closes one sample an interval, so a
    single read can predate it), the job ended, or ``deadline``."""
    polls, seen, fresh = [], {}, set()
    while time.perf_counter() < deadline and job.poll() is None:
        r = subprocess.run(
            [sys.executable, "-m", "ompi_tpu_torch.tools.otpu_top", "--coord",
             f"127.0.0.1:{port}", "--json", "--count", "1"],
            capture_output=True, text=True, timeout=60)
        if r.returncode == 2 and not polls:
            time.sleep(0.3)            # the job's coordination service is
            continue                   # not listening yet
        require(r.returncode == 0, f"otpu_top exited {r.returncode}: "
                f"{r.stderr[-2000:]}")
        if not r.stdout.strip():
            break                      # the job ended between two polls
        poll = json.loads(r.stdout.strip().splitlines()[-1])
        polls.append(poll)
        for rank, sample in poll["ranks"].items():
            if sample is None:
                continue
            if rank in seen and sample["seq"] > seen[rank]:
                fresh.add(rank)
            seen.setdefault(rank, sample["seq"])
        if len(fresh) == nprocs:
            break
        time.sleep(0.3)
    require(len(fresh) == nprocs,
            f"otpu_top saw a new sample from ranks {sorted(fresh)} of "
            f"{nprocs} in {len(polls)} polls: {polls[-1:] or 'none'}")
    return polls


def tools(smi: str, kernel_rows: list) -> dict:
    """The operator tools against a live job and its outputs (phase 16 of
    the module docstring).  Returns the ``tools`` line's object."""
    import shutil

    from ompi_tpu_torch.examples import otpu_top_demo as demo
    from ompi_tpu_torch.mca.coll import tuned
    from ompi_tpu_torch.tools.tpurun import _free_port

    t_phase = time.perf_counter()
    out = {"card": smi}
    py = sys.executable
    tmp = Path(tempfile.mkdtemp(prefix="otpu-tools-"))
    side = {}
    try:
        port = _free_port()
        trace_dir = tmp / "trace"
        env = {k: v for k, v in os.environ.items()
               if k not in ("OTPU_RANK", "OTPU_NPROCS", "OTPU_COORD")}
        # otpu_info and otpu_perf --check (over a history written from this
        # run's kernel times) run beside the job
        history = tmp / "history.jsonl"
        now = time.time()
        history.write_text("".join(
            json.dumps({"v": 1, "kind": "bench", "run": f"smoke-{os.getpid()}",
                        "t": now, "key": row["name"],
                        "lat_us": row["ms"] * 1e3, "k": REPS}) + "\n"
            for row in kernel_rows))
        for name, argv in (("otpu_info", ["--all", "--parsable"]),
                           ("otpu_perf", [str(history), "--check"])):
            with open(tmp / f"{name}.out", "w") as so, \
                    open(tmp / f"{name}.err", "w") as se:
                side[name] = subprocess.Popen(
                    [py, "-m", f"ompi_tpu_torch.tools.{name}", *argv],
                    stdout=so, stderr=se)
        t = time.perf_counter()
        with open(tmp / "job.out", "w") as jo, open(tmp / "job.err", "w") as je:
            job = subprocess.Popen(
                demo.job_argv(port, str(trace_dir), "cuda", TOOLS_SECS,
                              nprocs=TOOLS_NPROCS),
                stdout=jo, stderr=je, env=env)
            try:
                polls = top_polls(port, TOOLS_NPROCS, t + 90, job)
                rc = job.wait(timeout=120)
            finally:
                if job.poll() is None:
                    job.kill()
                    job.wait()
        job_wall = time.perf_counter() - t
        stdout = (tmp / "job.out").read_text()
        require(rc == 0, f"the tools job exited {rc}:\n{stdout[-3000:]}\n"
                f"{(tmp / 'job.err').read_text()[-3000:]}")
        ranks = [json.loads(ln.split("OTPU TOP DEMO WORKER ", 1)[1])
                 for ln in stdout.splitlines() if "OTPU TOP DEMO WORKER " in ln]
        require(sorted(r["rank"] for r in ranks) == list(range(TOOLS_NPROCS))
                and all(r["exact"] and r["device"].startswith("cuda")
                        and r["launches"].get("all_reduce_fused") == r["steps"]
                        and r["launches"].get("all_reduce_seg") == 1
                        for r in ranks),
                f"the tools job's ranks: {ranks}")
        last = polls[-1]
        out["job_3"] = {"wall_s": job_wall, "ranks": ranks}
        out["otpu_top"] = {
            "polls": len(polls),
            "seq_by_rank": {k: v["seq"] for k, v in last["ranks"].items()
                            if v is not None},
            "stale": last["stale"],
            "hist_keys": sorted({h for v in last["ranks"].values()
                                 if v is not None for h in v.get("hist") or {}}),
            "allreduce_p50_p99_us": {
                k: [v["hist"]["allreduce"]["p50_us"],
                    v["hist"]["allreduce"]["p99_us"]]
                for k, v in last["ranks"].items()
                if v is not None and "allreduce" in (v.get("hist") or {})}}
        # the straggler report over the merged timeline, and its draft
        ladder, report = tmp / "draft.rules", tmp / "report.json"
        t = time.perf_counter()
        r = subprocess.run(
            [py, "-m", "ompi_tpu_torch.tools.otpu_analyze", str(trace_dir),
             "--critical-path", "--suggest-ladder", str(ladder), "--json",
             str(report)], capture_output=True, text=True, timeout=120)
        require(r.returncode == 0, f"otpu_analyze exited {r.returncode}: "
                f"{r.stderr[-3000:]}")
        rep = json.loads(report.read_text())
        cp = rep["critical_path"]
        rules = tuned._load_rules(str(ladder))
        require(cp["bound_by"]["rank"] == demo.SLOW_RANK and rules,
                f"otpu_analyze: bound by {cp['bound_by']}, straggler "
                f"{rep.get('straggler')}, {len(rules)} draft rules")
        out["otpu_analyze"] = {
            "wall_s": time.perf_counter() - t, "steps": len(cp["steps"]),
            "bound_by": cp["bound_by"], "straggler": rep.get("straggler"),
            "critical_exposed_comm": cp.get("critical_exposed_comm"),
            "draft_rules_loaded": len(rules)}
        for name, proc in side.items():
            rc = proc.wait(timeout=120)
            said = (tmp / f"{name}.out").read_text()
            require(rc == 0, f"{name} exited {rc}: "
                    f"{(tmp / f'{name}.err').read_text()[-3000:]}")
            out[name] = {"exit_code": rc, "rows": len(said.splitlines())}
        out["otpu_perf"]["said"] = said.strip()
        out["otpu_perf"]["history_rows"] = len(kernel_rows)
    finally:
        for proc in side.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"tools": out}))
    return out


#: the examples run in this process (the device world on the card), in
#: order: {name: (argv, the line that says it succeeded)}
EXAMPLES_IN_PROCESS = {
    "hello": ([], "Hello, world, I am 0 of 8 "),
    "connectivity": ([], "connectivity OK: 8 ranks fully connected "
                         "(56 messages)"),
    "ring": ([], "ring done: 80 hops on 8 ranks"),
    "ragged_dispatch": ([], "dispatch verified on 8 ranks: ideal 2213 KiB, "
                            "ragged wire 2424 KiB"),
    "device_collectives": ([], "DEVICE COLLECTIVES OK"),
    "train_sharded": (["--lr", str(STEP_LR)], "done; initial loss "),
    "train_tour": (["--lr", str(STEP_LR)], "TRAIN TOUR OK"),
    "serving_demo": ([], "SERVING DEMO OK "),
    "fleet_demo": ([], "FLEET DEMO OK "),
}
#: the launches each in-process example must make, exactly (the tour's are
#: checked by configuration); ring reductions at 4 KB a rank run the fused
#: body, the torus reduce-scatter is two sub-ring launches of it and the
#: torus all-gather one K10 launch
EXAMPLE_LAUNCHES = {
    "ragged_dispatch": {"all_to_all_v": 2},
    "device_collectives": {"all_reduce_fused": 1, "bcast": 1,
                           "matmul_allreduce": 1, "all_gather_bidi": 1,
                           "reduce_scatter_fused": 2, "all_gather": 1},
}
#: the examples that start their own jobs, or run under tpurun, as
#: processes: {name: (argv after the interpreter, the start of the line that
#: says it succeeded)}
EXAMPLE_JOBS = {
    "ring_4": (["-m", "ompi_tpu_torch.tools.tpurun", "-n", "4", sys.executable,
                "-m", "ompi_tpu_torch.examples.ring"], "[3] rank 3 exiting"),
    "pgas_ring_4": (["-m", "ompi_tpu_torch.tools.tpurun", "-n", "4",
                     sys.executable, "-m", "ompi_tpu_torch.examples.pgas_ring"],
                    "[0] pgas ring OK: 4 PEs"),
    "partitioned_pingpong_2": (["-m", "ompi_tpu_torch.tools.tpurun", "-n", "2",
                                sys.executable, "-m",
                                "ompi_tpu_torch.examples.partitioned_pingpong"],
                               "[1] [rank 1] complete"),
    "trace_demo_4": (["-m", "ompi_tpu_torch.tools.tpurun", "-n", "4",
                      "--mca", "trace_enable", "1", "--mca", "trace_dir",
                      "{tmp}", sys.executable, "-m",
                      "ompi_tpu_torch.examples.trace_demo"],
                     "[0] live pvar histograms (otpu_info --pvars):"),
    "profile_demo": (["-m", "ompi_tpu_torch.examples.profile_demo"],
                     "otpu_perf --diff exit code: 3"),
    "moe_train_demo": (["-m", "ompi_tpu_torch.examples.moe_train_demo"],
                       "hot-expert rank blamed: YES"),
    "elastic_train_demo": (["-m", "ompi_tpu_torch.examples.elastic_train_demo"],
                           "bit-exact vs failure-free restore: YES"),
    "otpu_top_demo": (["-m", "ompi_tpu_torch.examples.otpu_top_demo"],
                      "job ended; otpu_analyze over the merged timeline:"),
}
EXAMPLE_JOB_TIMEOUT = 300
EXAMPLE_JOBS_AT_ONCE = 3


def example_job(name: str, tmp: str) -> dict:
    """One of ``EXAMPLE_JOBS`` as a process of its own, its output to files
    under ``tmp``; on its timeout its whole process group is killed.  Fails
    unless it exits 0 with its success line."""
    import signal

    argv, line = EXAMPLE_JOBS[name]
    work = os.path.join(tmp, name)
    os.makedirs(work)
    argv = [a.replace("{tmp}", work) for a in argv]
    env = {k: v for k, v in os.environ.items()
           if k not in ("OTPU_RANK", "OTPU_NPROCS", "OTPU_COORD")}
    t0 = time.perf_counter()
    with open(os.path.join(work, "out"), "w") as so, \
            open(os.path.join(work, "err"), "w") as se:
        proc = subprocess.Popen([sys.executable, *argv], stdout=so, stderr=se,
                                env=env, cwd=Path(__file__).resolve().parent,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=EXAMPLE_JOB_TIMEOUT)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    wall = time.perf_counter() - t0
    said = Path(work, "out").read_text()
    require(rc == 0 and any(ln.startswith(line) for ln in said.splitlines()),
            f"example {name} exited {rc} without {line!r}:\n{said[-3000:]}\n"
            f"{Path(work, 'err').read_text()[-3000:]}")
    out = {"wall_s": wall, "exit_code": rc}
    if name == "elastic_train_demo":
        report = json.loads(next(ln for ln in said.splitlines()
                                 if "ELASTIC " in ln).split("ELASTIC ", 1)[1])
        require(report["device"] == "cuda:0",
                f"the elastic ranks bound {report['device']}")
        out["recoveries"] = len(report["recoveries"])
    if name == "moe_train_demo":
        out["said"] = [ln for ln in said.splitlines()
                       if ln.startswith(("dispatched ", "critical path: "))]
    return out


def run_example(name: str, argv: list) -> tuple:
    """``ompi_tpu_torch.examples.<name>.main(argv)`` in this process, every
    count set to 0 before and read after: (its return value, its stdout,
    the launches, K20's and K21's launches by body, wall seconds)."""
    import contextlib
    import importlib
    import io

    from ompi_tpu_torch.ops import flash_attention, overlap

    module = importlib.import_module(f"ompi_tpu_torch.examples.{name}")
    tables = {"k20": overlap.bodies, "k21": flash_attention.bodies}
    reset_counts()
    before = {k: dict(t) for k, t in tables.items()}
    said = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(said):
        result = module.main(list(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: v for k, v in counts().items() if v}
    bodies = {k: {b: v - before[k][b] for b, v in t.items()
                  if v != before[k][b]} for k, t in tables.items()}
    return result, said.getvalue(), launched, bodies, wall


#: the training phase's bands for a step against its ``use_flash=False``
#: twin, relative on the loss, by compute dtype
TOUR_BANDS = {"float32": 1e-5, "bfloat16": BF16_STEP_BAND}


def tour_losses(over: dict, steps: int, use_flash=None, momentum=None,
                device=None, lr=STEP_LR) -> list:
    """``steps`` losses of the tour's step from its seeded parameters, the
    knobs at the tour's defaults but ``over`` (restored after).  With
    ``momentum`` the step is plain SGD (ZeRO-1 and momentum off) and the
    heavy ball is added to its parameters here, ``p' = sgd(p) + mu (p -
    p_prev)``, the update ZeRO-1's sharded state must make."""
    from ompi_tpu_torch.base.var import registry
    from ompi_tpu_torch.examples import train_tour
    from ompi_tpu_torch.parallel import dryrun
    from ompi_tpu_torch.parallel import train  # noqa: F401  (the knobs)

    if momentum is not None:
        over = dict(over, otpu_parallel_zero1=False,
                    otpu_parallel_momentum=0.0)
    saved = {k: registry.lookup(k).value for k in train_tour.KNOBS}
    try:
        for k, dv in train_tour.KNOBS.items():
            registry.lookup(k).set(over.get(k, dv))
        step, (state, x), _ = dryrun.make_step_and_args(
            device, dryrun.parse_spec(train_tour.SPEC), lr=lr,
            use_flash=use_flash)
        losses, prev = [], None
        for _ in range(steps):
            new, loss = step(state, x)
            losses.append(float(loss))
            if momentum is not None:
                if prev is not None:
                    new = {k: v + momentum * (state[k] - prev[k])
                           for k, v in new.items()}
                prev = state
            state = new
    finally:
        for k, v in saved.items():
            registry.lookup(k).set(v)
    return losses


def check_tour(result: dict, said: str) -> dict:
    """The tour's six configurations at OTPU_MODEL_SCALE=64: each loss
    descends (two steps), K21 runs 2 steps' launches (4 under remat) on
    the float32 FFMA body, or on the bfloat16 mma.sync body under bf16 and
    the works.  Then, outside the example's counted run: each
    configuration's two losses within ``TOUR_BANDS`` of the same steps with
    ``use_flash=False``; zero1's pair equal to the baseline's (its first
    step is plain SGD); and zero1 and the works run a third step, where
    momentum reaches the loss, held against ``use_flash=False`` and against
    the heavy ball added to the plain SGD step (``tour_losses``)."""
    import re

    from ompi_tpu_torch.examples import train_tour
    from ompi_tpu_torch.parallel.dryrun import parse_spec

    per_step = k21_per_step(parse_spec(train_tour.SPEC).sizes())
    pairs = [tuple(map(float, m)) for m in re.findall(
        r"^dryrun ok: mesh=.* loss ([-\d.e+]+) -> ([-\d.e+]+)$", said, re.M)]
    require(list(result) == list(train_tour.CONFIGS) and len(pairs) == 6,
            f"train_tour ran {list(result)}, {len(pairs)} descending runs")
    out = {}
    for (tag, got), (first, second) in zip(result.items(), pairs):
        over = train_tour.CONFIGS[tag]
        steps = 4 if over.get("otpu_parallel_remat") else 2
        dtype = over.get("otpu_parallel_compute_dtype", "float32")
        body = "mma_sync" if dtype == "bfloat16" else "ffma"
        want = steps * per_step
        require(np.isfinite(first) and second < first
                and got["launches"] == want and got["bodies"] == {
                    "ffma": want if body == "ffma" else 0,
                    "mma_sync": want if body == "mma_sync" else 0},
                f"train_tour {tag}: loss {first} -> {second}, K21 "
                f"{got['launches']} {got['bodies']}, want {want} on {body}")
        out[tag] = {"loss": [first, second], "k21": want, "body": body}
    for tag, row in out.items():
        over = train_tour.CONFIGS[tag]
        band = TOUR_BANDS[over.get("otpu_parallel_compute_dtype", "float32")]
        mu = over.get("otpu_parallel_momentum")
        losses = tour_losses(over, 3) if mu else row["loss"]
        plain = tour_losses(over, len(losses), use_flash=False)
        checks = {"use_flash=False": plain}
        if mu:
            printed = [float(f"{v:.6f}") for v in losses[:2]]  # as dryrun's
            require(printed == row["loss"], f"train_tour {tag}: a rerun "
                    f"gave {losses[:2]}, the tour {row['loss']}")
            checks["sgd + heavy ball"] = tour_losses(over, 3, momentum=mu)
        for what, ref in checks.items():
            rel = max(abs(g - w) / abs(w) for g, w in zip(losses, ref))
            require(np.isfinite(losses).all() and rel <= band,
                    f"train_tour {tag}: losses {losses} against {what}'s "
                    f"{ref}: {rel:.3e} above {band:g}")
            row[what] = {"loss": ref, "rel": rel, "band": band}
        row["loss"] = losses
    printed = dict(zip(out, pairs))
    require(printed["zero1"] == printed["baseline"],
            f"zero1's losses {printed['zero1']} are not the baseline's "
            f"{printed['baseline']}")
    return out


def examples(smi: str) -> dict:
    """Every example of the port on the card, as a user runs it (phase 17
    of the module docstring).  Returns the ``examples`` line's object."""
    import shutil

    import ompi_tpu_torch
    from ompi_tpu_torch.api import env

    t_phase = time.perf_counter()
    ring_defaults()              # as in a fresh process: coll/builtin owns
    # MPIX_Query_cuda_support's analog: true for a device world on the card
    world = ompi_tpu_torch.init()
    require(env.query_accelerator_support() and world.rte.device.type == "cuda",
            f"query_accelerator_support() is false in a world on "
            f"{world.rte.device}")
    ompi_tpu_torch.finalize()
    require(not env.query_accelerator_support(),
            "query_accelerator_support() is true after finalize")
    tmp = tempfile.mkdtemp(prefix="otpu-examples-")
    pool = concurrent.futures.ThreadPoolExecutor(EXAMPLE_JOBS_AT_ONCE)
    jobs = {name: pool.submit(example_job, name, tmp) for name in EXAMPLE_JOBS}
    out = {"card": smi, "accelerator_support": True, "in_process": {},
           "jobs": {}}
    try:
        for name, (argv, line) in EXAMPLES_IN_PROCESS.items():
            result, said, launched, bodies, wall = run_example(name, argv)
            require(any(ln.startswith(line) for ln in said.splitlines()),
                    f"example {name} printed no {line!r}:\n{said[-3000:]}")
            row = {"wall_s": wall, "launches": launched, "bodies": bodies}
            if name in EXAMPLE_LAUNCHES:
                require(launched == EXAMPLE_LAUNCHES[name],
                        f"example {name} launched {launched}, want "
                        f"{EXAMPLE_LAUNCHES[name]}")
            elif name == "train_sharded":
                per_step = {k: k21_per_step(v) for k, v in STEP_MESHES.items()}
                want = 2 * per_step["default"] + 2 * per_step["pp2"]
                require(launched == {"flash_block": want}
                        and bodies["k21"] == {"ffma": want},
                        f"train_sharded launched {launched} {bodies}, want "
                        f"{want} of K21 on its FFMA body")
            elif name == "train_tour":
                row["configs"] = check_tour(result, said)
            else:
                require(launched == {}, f"example {name} launched {launched}")
            if name == "device_collectives":
                require(bodies["k20"] == {"ffma": 1},
                        f"device_collectives ran K20 on {bodies['k20']}, "
                        "want its float32 FFMA body once")
            out["in_process"][name] = row
            log(f"example {name}: {wall:.2f} s, {line.strip()}, "
                f"launches {launched}")
        for name, job in jobs.items():
            out["jobs"][name] = job.result()
            log(f"example {name}: {out['jobs'][name]['wall_s']:.2f} s, "
                f"{EXAMPLE_JOBS[name][1]}")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(tmp, ignore_errors=True)
    tour = out["in_process"]["train_tour"]["configs"]
    log(f"train_tour at OTPU_MODEL_SCALE={os.environ.get('OTPU_MODEL_SCALE')}"
        f", lr {STEP_LR}: " + ", ".join(
            f"{tag} " + " -> ".join(f"{v:.4f}" for v in row["loss"])
            + " (" + ", ".join(f"{what} {c['rel']:.3e}" for what, c in
                               row.items() if isinstance(c, dict)) + ")"
            for tag, row in tour.items()))
    out["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"examples": out}))
    return out


def outputs(result) -> tuple:
    """A kernel's outputs as a tuple (the encode returns two)."""
    return result if isinstance(result, tuple) else (result,)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import ompi_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from ompi_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    pool = concurrent.futures.ThreadPoolExecutor(1)
    strided = pool.submit(strided_type)       # host Python beside the nvccs
    gate_dir = tempfile.mkdtemp(prefix="cuda-aot-")
    gate = start_gate(gate_dir)                # the compile gate beside them
    _build.build_all()
    log(f"nvcc build of {', '.join(_build.LIBRARIES)}: "
        f"{time.perf_counter() - t0:.1f} s")
    analysis_dir = tempfile.mkdtemp(prefix="analysis-")
    analysis = start_analysis(analysis_dir)    # host only, beside the gate

    # full float32 products in the plain versions (both are the defaults)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    phase_s = {"build": time.perf_counter() - t0}

    def timed(name, fn, *args):
        t = time.perf_counter()
        result = fn(*args)
        phase_s[name] = time.perf_counter() - t
        return result

    err = timed("check_kernels", check_kernels, gen)
    # the gate ran beside the build and the checks; it is waited for before
    # the paths, whose host timings its compilers would disturb
    timed("cuda_aot_wait", finish_gate, gate, gate_dir)
    timed("analysis_wait", finish_analysis, analysis, analysis_dir, smi)
    main_launched = timed("main_path", main_path, gen)
    comm_launched, _ = timed("comm_path", comm_path, gen)
    launched = {k: v + comm_launched.get(k, 0)
                for k, v in main_launched.items()}
    os.environ["OTPU_MODEL_SCALE"] = "64"
    trained = timed("training_path", training_path)
    moe_launched = timed("moe_path", moe_path, gen)
    strided = timed("strided_type_wait", strided.result)
    pool.shutdown()
    rows = timed("measure", measure, gen, launched, err)
    rows += timed("measure_flash", measure_flash, gen, trained, err)
    rows += timed("measure_fused_matmul", measure_fused_matmul, gen,
                  moe_launched, err)
    tier = timed("host_tier", host_tier, gen, smi)
    timed("host_transports", host_transports, smi, strided,
          tier["pingpong_2"])
    timed("one_sided", one_sided, smi)
    timed("observability", observability, smi, gen, main_launched,
          comm_launched)
    timed("topology_ft", topology_ft, smi, gen)
    timed("sessions_dpm", sessions_dpm, smi, gen)
    timed("train_through_failure", train_through_failure, smi, gen)
    timed("partitioned_logging", partitioned_logging, smi, gen)
    timed("device_world_mp", device_world_mp, smi)
    timed("serving", serving, smi)
    timed("fleet_pgas", fleet_pgas, smi)
    timed("tools", tools, smi, rows)
    timed("examples", examples, smi)
    log(json.dumps({"phase_s": {"card": smi, **phase_s}}))
    log(json.dumps({"earlier_ms": {"source": "PERF.md constants, not measured "
                                             "in this run", **EARLIER_MS}}))
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
