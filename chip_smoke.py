#!/usr/bin/env python3
"""Run the PyTorch port's baidu-ctr serving and training paths, on the
gather and the cached placements and on the SSD tier, its dlrm-mlperf
serving and training paths, its qwen3-14b prefill, decode and training,
its mixtral-8x7b and llama4-scout serving (MoE, windowed and chunked
attention), its mixtral-8x7b training, its DIN, DIEN and two-tower
retrieval training and serving, its GIN training at the gin-tu cells,
its checkpoints' save, resume and replay, and its pull prefetch and input
pipeline, on one NVIDIA GPU (H100).

    python3 chip_smoke.py        # from the root of a checkout

Phases (any failure raises and the script exits non-zero):
  1. kernels: builds the CUDA kernels from ``src/repro_torch/kernels/csrc``
     (into ``build/torch_kernels/``; the first line gives the build's wall
     and each source's compile time from ``.ninja_log``), then holds each
     kernel against its plain PyTorch version on the card.
     - The bag: at the serving path's shapes (working set 65537 x 64,
       102400 ids, 40960 bags), at small odd shapes with empty bags, with
       the sum/mean/sqrtn combiners and their gradients.  Forward within
       rtol = atol = 1e-5 and bit-equal to the CPU plain version; two runs
       bit-equal; its index streams (``forward_streams``) equal to
       ``csr_from_segments``'s stable sort and the walk alone on them equal
       to the wrapper.  Timed: the wrapper, the streams alone, the walk
       alone, the device alone (CUDA graph replays) and the host per call,
       beside ``F.embedding_bag`` on the same CSR and ``index_add_``, at
       the slice's batch and at four times it; no sync and no host-to-device
       copy in the wrapper; registers, stack and local-memory stores and
       loads of the walk's, the index streams' and the probe's
       instantiations (``cuobjdump``).
     - The bag's backward: at the training path's per-pod shapes (51200
       ids, 20480 bags, a hot working row of 4130 entries) and the small
       odd shapes.  Working-row gradients bit-equal to the CPU plain vjp,
       weight gradients within rtol = atol = 1e-5, two runs bit-equal.
       Its wrapper makes no sync and no host-to-device copy (the sync
       debug mode "error" and the profiler); the wrapper and its library
       call are also timed on the device alone (CUDA graph replays) and on
       the host; its index streams alone, the wrapper and the streams
       without the hot row's entries, beside the order floor (the hot
       row's dependent adds) and the bytes bound; the wrapper, the streams
       and ``index_add_`` at four times the batch (the long rows' ordered
       placement reads all of inv once per long row); registers, stack and
       local-memory stores and loads of its and kernel 8's
       instantiations (``cuobjdump`` of the built extension).
     - The push (the row math in the kernel): the slice's uid layout (one
       batch deduplicated at capacity 65536, with its pads), D 3, 16 and
       100, an overflowed batch (no pads), and the slice batch on a 50
       M-row table (uids above 2^31 / 64).  Bit-equal to the plain version
       (``adagrad_row_updates``, then ``index_add_``), the wrapper and
       ``ops`` bit-equal, untouched rows unchanged; ``ops`` launches one
       kernel and nothing else (the profiler).  Timed on the 4 M-row table
       and on the 50 M-row table: the kernel and the ops-level push, each
       cold and warm, on the device alone (graph) and on the host per
       call, beside the plain version, the scatter alone (two
       ``index_add_``) and the bound (5 x 4 x D bytes a real row).
     - The cache tier's probe, cached gather and cached push (after phase
       7, on its trained cache): at the inputs of a real pull of the next
       batch (65536 uids, C = 262144, H = 2^20, D 64), a 64-bucket map
       with long chains, ids near 2^31 - 1, D 3, 16 and 100, an overflowed
       batch.  Bit-equal to the plain versions, two runs bit-equal,
       untouched cache slots unchanged; the gather with its drop row
       bit-equal to ``index_select`` + ``cat``.  The probe is also timed on
       the device alone and on the host per call, beside its latency floor
       (four dependent trips to HBM, each timed by a pointer chase,
       ``tools/pointer_chase.cu``), and at four times the batch; the
       gather with and without its drop row, beside ``index_select`` +
       ``cat`` and an empty kernel's launch; the cached push as the push.
     - The k-step local Adam step (kernel 6) at the slice's leaves
       (baidu-ctr's dense tower, 2 pods, 2,910,210 elements): warm-up on
       before and after the first merge and off, bias correction on and
       off, weight decay 0 and 1e-4, lr a float and a 0-dim tensor.
       Params and moments bit-equal to the plain version, two runs
       bit-equal.
     - The staged push (kernel 7) at the staged slice's (65536, 64) rows
       with a real batch's pads, an overflowed batch, D 16, 100 and 3.
       Bit-equal to the plain version and, at every real position, to the
       host push; pads unchanged.
     Times each kernel, its plain version and one PyTorch library call,
     each call after a 256 MB write that evicts the L2 (the kernel also
     L2-warm, back to back: ``ms_l2_warm`` in the kernels line).
  2. serving: ``build_trainer`` at the full width of baidu-ctr (embed 64, 40
     fields, 100 ids per instance, MLP 512-256-1, f32) with the table cut to
     50 M rows, capacity 65536, then ``build_ctr_server(max_batch=1024)``:
     4 full batches and a 300-request tail.  The launch counts show that
     the bag ran as the CUDA kernel and never as the plain version; the
     table and accumulator checksums show that serving wrote nothing.
  3. training: ``fit_online`` for 40 steps at the same width (n_pod 2,
     k 20, two_phase, sparse lr 0.5, initial accumulator 0.01), batch 1024.
     Finite losses, no overflow, launch counts per step (bag 1 + n_pod,
     backward n_pod, push 1, the local Adam step 1 per local step, plain
     versions 0), rows outside every batch unchanged; the step's device
     time by part, its local k-step Adam steps under the sync debug mode
     "error" and one under the profiler (no host-to-device copy, no sync).
  4. co-located serving changes nothing: 10 full-width steps twice, the
     second with a ``CTRServer`` draining between steps; per-step losses
     and the final state's checksums bit-equal.
  5. quickstart: ``examples/quickstart.py``'s configuration through the
     port, online AUC > 0.72.
  6. agreement: serving (3 request batches) and 6 training steps at smoke
     size on the card and on the CPU from one state; scores within
     rtol = atol = 1e-5, losses and final parameters within rtol = 1e-4,
     atol = 1e-6 (the CPU parity tests' tolerance).
  7. cached: 40 ``fit_online`` steps at full width on the cached placement
     (cache_rows 262144; the 25.6 GB table and accumulator in host memory,
     the cache on the card) with a server scoring 256 requests between
     steps.  Losses bit-equal to phase 3's; evictions, spills and launch
     counts per step (probe 4, cached gather 3, cached push 1, bag
     2 + n_pod, backward n_pod, plain versions 0); serving changes neither
     the cache state nor the host table; hit rates, byte meters, the
     step's device time by part and a host profile of the pull.
  8. cached at smoke size: the full mirror bit-identical to gather on the
     card; card vs CPU from one warm state (the cache's integer state
     equal, losses and parameters within phase 6's tolerance; the small
     cache evicts and rebuilds its hash map).
  9. the SSD tier at full width with the table cut to 4 M rows (977 pages
     of 4096 rows, 2.05 GB written and fsynced at (b)'s init and
     hard-linked for (c), in ``build/phase9_spill``, which it checks has
     3x that free and deletes at the end): 20 steps each, with a
     256-request drain between steps,
     of (a) gather on the host store, (b) gather on the DiskStore with an
     unbounded page cache, (c) cached (262144 rows) on the DiskStore with
     a 256-page cache.  Losses and every drain's scores of (b) and (c)
     bit-equal to (a)'s; launch counts per step (staged push 1 on (b),
     cached push 1 on (c), the local Adam step per local step, plain
     versions 0); store meters; 3 more steps split into parts (host dedup,
     read-ahead, absorb, gather, upload, pull, forward, backward, k-step
     Adam, push), losses bit-equal to (a)'s same steps; after ``close``, a
     fresh DiskStore on the directory reads (a)'s rows and accumulators at
     every touched uid.
 10. dlrm-mlperf serving at full width (embed 128, bottom MLP
     13-512-256-128, top MLP 479-1024-1024-512-256-1, f32), each of the
     26 tables cut to at most 8 M rows (44,063,992 rows; table and
     accumulator 45.1 GB on the card), capacity 16384:
     (a) the dot interaction (kernel 8) against its plain version at
     (512, 27, 128) and (16384, 27, 128) f32, (33, 13, 17) f32,
     (512, 27, 128) bf16, F = 2 and F = 1; f32 within atol 1e-5 D and
     rtol 4e-5, bf16 within atol 2e-2 D and rtol 8e-2 (the reference's
     kernel test); two runs bit-equal; timed as in phase 1, with
     ``bmm`` + the triangle's ``index_select`` as the library call;
     (b) a ``CTRServer`` (max_batch 512, serve_p99) scores 2048 requests:
     QPS, p50/p99, one kernel launch per predict and no plain version,
     2048 served, every score finite in (0, 1), no id dropped;
     (c) one predict of 16384: its wall and the stream time of its parts;
     (d) smoke size, card vs CPU from one state: scores within
     rtol = atol = 1e-5;
     (e) the interaction's call under the sync debug mode "error" and the
     profiler: one kernel launch, no sync, no host-to-device copy.
 12. (run after phase 10, before phase 11) dlrm-mlperf training at full
     width, phase 10's model and 8 M-row cap, batch 65536 (train_batch),
     capacity 65536, the launcher's training settings (n_pod 2, k 20,
     two_phase, lr 1e-3, initial accumulator 0.01) but sparse lr 0.1 (at
     this batch the launcher's 0.5 turns the losses non-finite after the
     first merge, in the reference too: ROADMAP.md §C), after phase 10's
     memory is released:
     (a) the interaction's backward (kernel 8b) against its plain version
     at (32768, 27, 128), one pod's shape, and (512, 27, 128), f32 and
     bf16, and at (33, 13, 17), F = 2 and F = 1; f32 within atol 1e-5 F
     and rtol 4e-5, bf16 within atol 2e-2 F and rtol 8e-2 (the forward's,
     with the sum's length F for D); two runs bit-equal; timed as in
     phase 1, with ``bmm`` of the symmetrised (B, F, F) matrix as the
     library call and the scatter that builds it beside; its
     instantiations' registers and spills (``cuobjdump``);
     (b) smoke size on the card, 6 steps: a second run and the cached full
     mirror bit-equal to gather (losses, tables, accumulators, dense);
     (c) smoke size, card vs CPU from one state: losses, tables,
     accumulators and dense within rtol 1e-4, atol 1e-6 (phase 6's);
     then 40 ``fit_online`` steps at full width: finite losses, no
     dropped id, launch counts per step (kernel 8b n_pod, kernel 8
     n_pod + 1 predict, the takes as bags of one id: kernel 1 26 (n_pod
     + 1), kernel 1b 26 n_pod, the push 26, the local Adam step per local
     step, plain versions 0), online AUC, peak device memory; one step's
     forward and backward make no host-to-device copy (the profiler);
     the step's stream time by part, the train_step wall and the device
     busy share, as in phase 3.
 11. qwen3-14b prefill at full width (40 layers, d 5120, 40 heads over 8
     KV heads, hd 128, d_ff 17408, vocab 151936, bf16; 29.5 GB of random
     weights drawn on the card from a seed), after phase 12's memory is
     released:
     (a) flash attention (kernel 9: bf16 runs its mma kernel on the
     tensor cores, f32 its fma kernel; a CUDA graph captured around each
     call names the kernel it launched) against its plain version at
     (B, S, H, Kv, hd) = (4, 4096, 40, 8, 128) bf16 (the path's),
     (1, 4096, 40, 8, 128) bf16 and f32, (2, 64, 8, 2, 16) f32 causal and
     not, (1, 1000, 40, 8, 128) bf16 (ragged) and (2, 96, 4, 2, 32) f32;
     f32 within atol = rtol = 1e-5, bf16 within atol 4e-3, rtol 8e-3 and
     every element within one bf16 ulp (``bf16_ulps``); two runs
     bit-equal; timed as in phase 1 at the first three shapes, with
     ``F.scaled_dot_product_attention(is_causal, enable_gqa)`` as the
     library call; each instantiation's registers, stack, spill stores
     and HMMA count (``cuobjdump`` of the built extension);
     (b) ``prefill`` of 4 x 4096 tokens: a warm-up and 3 timed prefills
     (wall, tokens/s, peak memory), 40 kernel launches per prefill and no
     plain version, finite logits, the same bits each time; one prefill's
     stream time by part; one under the sync debug mode "error" and one
     under the profiler (no sync, no host-to-device copy); a CUDA graph
     captured around one holds 40 mma kernels and no fma kernel;
     (c) one prefill of 1 x 32768 (prefill_32k's sequence, its batch cut
     from 32 to 1), whose hidden states at positions < 4096 agree with a
     1 x 4096 run bit for bit (the kernel's KV tiles have fixed edges in
     absolute positions, so a row's sums do not depend on S);
     (d) smoke size (f32, 2 layers), card vs CPU from one state: logits
     within atol 5e-5, rtol 1e-5.
 13. qwen3-14b decode at full width (after phase 11, on its weights):
     (a) a ``BatchedServer`` of 8 slots of 32768 positions (decode_32k,
     its batch cut from 128 to 8; the cache 42.95 GB) serves 16 requests,
     prompts of 8 to 32 tokens from a seeded generator, 32 new tokens
     each: every request gets its tokens, every call's logits finite, peak
     memory at most the weights + one cache + 2 GB; the tokens decoded,
     the fill and decode steps, the wall, tokens/s and ``stats["wall"]``
     per decode step; a second run decodes the same tokens;
     (b) ``decode_step`` on a full cache (K and V random bf16 at every
     position, ``pos`` 0..32767, ``t`` 32767): 10 steps' walls and
     tokens/s beside the step's bound (its bytes at 3.35 TB/s); one step's
     stream time by part (CUDA events; its logits bit-equal to
     ``decode_step``'s from the same state); one step under the sync debug
     mode "error" and one under the profiler: no sync, at most one
     host-to-device copy (the token ids, pinned), no copy as large as a
     layer's K, the launches and the device busy share;
     (c) a first request alone in a 1-slot server equals a manual
     ``decode_step`` loop bit for bit (full width); a 64-token prompt
     decoded token by token against ``prefill`` (kernel 9) at its last
     position: published widths, 4 layers, f32, full vocab, within atol
     3e-4, and full depth in bf16, reported; smoke size (f32), card vs CPU
     from one state, 20 decode steps within atol 5e-5, rtol 1e-5.
 14. qwen3-14b training (after phase 13 has released its weights and
     cache):
     (a) kernel 9b, flash attention's backward, against the plain vjp
     (autograd through ``ref.flash_attention_ref``) at (1, 4096, 40, 8,
     128) bf16 and f32 causal (the cell's), (1, 129, 40, 8, 128) bf16
     causal, (1, 200, 8, 8, 256) bf16 full, (2, 64, 8, 2, 16) f32 causal
     and full, (1, 1000, 40, 8, 128) bf16 causal, (1, 333, 8, 2, 64) bf16
     full, (2, 97, 4, 2, 64) f32 causal and (1, 257, 4, 4, 128) f32 full:
     every gradient within 1e-5 (f32) or 2e-2 (bf16) of its largest
     magnitude, two runs bit-equal, the forward's log-sum-exp within 1e-5
     of the plain one and its output bit-equal to the output without it,
     a CUDA graph of a call holding its dtype's three kernels (bf16: D,
     then the mma dK/dV and dQ kernels); timed cold and warm at the cell's
     shape in both dtypes beside the plain vjp, the backward of
     ``F.scaled_dot_product_attention(is_causal, enable_gqa)`` and the
     bound; its instantiations' registers, stack, spill stores and HMMA
     count (``cuobjdump``): every bf16 one with HMMA, none at HDP 64 or 128
     with a spill store.
     Kernel 6 on bf16 params and gradients (f32 moments) at one podded
     layer of the cell (660.6 M elements): bit-equal to its plain version
     before and after the first merge, timed beside it and its bound (26 B
     an element);
     (b) ``build_trainer("qwen3-14b", ...)`` at the published widths (d
     5120, 40/8 heads, hd 128, d_ff 17408, vocab 151936, untied head,
     bf16) under the launcher's k-step settings (n_pod 2, two_phase, lr
     1e-3) with k 10, **cut from 40 layers to 2** (the trainer holds 16 B
     a podded parameter: 2 layers are 70.9 GB) and **train_4k's batch 256
     to 2** (one 4096-token sequence a pod, from ``lm_batches``): 20
     ``train_step`` calls (merges at 10 and 20; steps 3-20 under the sync
     debug mode "error"): finite losses, walls, tokens/s, peak memory,
     launches (kernel 9 2 x layers x pods a step, 9b layers x pods, kernel
     6 per local step, plain versions 0); one more step by part (CUDA
     events) and under the profiler (kernels 9, 9b, 6, busy share); kernel
     6 timed at the cell's 4.43e9 podded elements beside its bound;
     (c) the first step's loss against the same weights widened to f32 on
     the card (a CPU run at these widths would take minutes); smoke size
     (f32), card vs CPU from one state, 4 steps with merge_delay 0 and 6
     with merge_delay 1 (k 2, lr 1e-4): losses, parameters, m and v_hat
     within rtol 1e-4, atol 1e-6.
 15. MoE and the windowed and chunked masks (after phase 14 has released
     its memory):
     (a) kernel 9 with the window and chunk terms against its plain
     version at (1, 8192, 32, 8, 128) window 4096 and (1, 8192, 40, 8,
     128) chunk 2048, bf16 and f32, at the prefill's (4, 4096, 32, 8,
     128) window 4096, and at S 1000 (not a multiple of a tile) with
     window 100, window 17 (below a tile), chunk 300 (not dividing S)
     and window 200 with chunk 256; the causal kernel's tolerance (bf16:
     every element within one bf16 ulp); two runs bit-equal; windows and
     chunks of S or more give the causal kernel's bits (output and lse);
     timed at 1 x 32768 (mixtral: H 32, window 4096; llama4: H 40, chunk
     8192) cold and warm, beside the causal kernel at the same shape and
     SDPA with the boolean mask (memory-efficient kernel; held to the
     kernel within 2e-2), and the bound from the visible pairs;
     (b) mixtral-8x7b at the published widths (d 4096, 32/8 heads, 8
     experts top-2 of d_ff 14336, window 4096, bf16), **cut from 32
     layers to 20** (58.6 GB of random weights on the card): prefill 4 x
     4096 and 1 x 32768, two timed each (wall, tokens/s, peak memory,
     launches: kernel 9 with the window once a layer, plain versions 0,
     the same logits), one of each by part (``_qkv``, kernel 9, o-proj,
     router + dispatch + combine, the expert products); a prefill under
     the profiler makes no sync and no host-to-device copy; the
     ``BatchedServer`` at decode_32k (8 slots of a 4096-slot ring, 16
     seeded requests); long_500k: ``decode_step`` at batch 1 from a ring
     filled as at t = 524288 - 32, 64 steps across the wrap (the ring's
     positions checked), ms a step against its bound (every expert's
     weights each step), one step under the sync debug mode "error" and
     one under the profiler (launches, busy share);
     (c) llama4-scout-17b-16e at the published widths (d 5120, 40/8
     heads, 16 experts top-1 of d_ff 8192 and a shared expert, chunk 8192,
     every 4th layer global, vocab 202048, bf16), **cut from 48 layers to
     12** (57.0 GB; three global layers): (b)'s prefills, parts and
     server (8 slots of a full 32768-slot cache);
     (d) both smoke configs (f32), card vs CPU from one state: prefill
     logits and 3 x window (or chunk) decode steps across the ring's wrap
     within atol 5e-5, rtol 1e-5, and the server's tokens, token for
     token.
 16. A10d training (after phase 15 has released its memory):
     (a) kernel 9b with the window and chunk terms against the plain vjp
     (autograd through ``ref.flash_attention_ref`` with the same terms)
     at (1, 8192, 32, 8, 128) with window 4096 (mixtral's) and chunk
     2048, bf16 and f32, and at S 1000 (not a multiple of any tile) with
     window 100 (H 40 over Kv 8 in bf16), window 17 (below a tile),
     chunk 300 (not dividing S; H 40 in bf16) and window 200 with chunk
     256: the causal backward's tolerance (every gradient within 1e-5
     f32, 2e-2 bf16, of its largest magnitude), two runs bit-equal, a
     graph of a call holding its dtype's three kernels; windows and
     chunks of S or more give the causal backward's bits; timed at 1 x
     32768 (window 4096 at H 32, chunk 8192 at H 40) cold and warm,
     beside causal 9b at the same shape, the backward of SDPA with the
     boolean mask (held to the kernel within 5 % of the largest
     gradient) and the bound from the visible pairs (10 hd FLOP a pair
     and head); the local instantiations' registers join phase 14 (a)'s
     SASS report;
     (b) ``build_trainer("mixtral-8x7b", ...)`` at the published widths
     (bf16) under the launcher's k-step settings (n_pod 2, two_phase) with
     k 10 and lr 1e-4 (the CPU tests' value: at the launcher's 1e-3 the
     runs part after step 14, the embedding's bf16 backward adding in no
     fixed order, and one went non-finite at step 19), **cut from 32
     layers to 1** (32 B a podded
     parameter: 54.8 GB; two layers would be 101 GB) and **train_4k's
     256 x 4096 tokens to 2 x 8192** (one sequence a pod; at 4096 the
     window masks nothing): 20 ``train_step`` calls (merges at 10 and
     20; steps 3-20 under the sync debug mode "error"): finite losses,
     walls, tokens/s, peak memory, exact launches (kernel 9 with the
     window 80, 9b with the window 40, kernel 6 18, everything else 0);
     the first step's loss within 1e-2 of float32 on the same weights;
     one more step by part and under the profiler (kernels 9, 9b, 6, the
     products, the index kernels, busy share); one pod's MoE FFN by part;
     (c) llama4-scout-17b-16e: no full-width training cell (its
     embedding and head alone take 66 GB podded), stated on its line;
     (d) both MoE smoke configs (f32, S 64: the window 16 and chunk 16
     bind, llama4's layer 3 is global), card vs CPU from one state, 4
     steps at n_pod 2, k 2, lr 1e-4: losses, parameters, m and v_hat
     within rtol 1e-4, atol 1e-6; one ``moe_ffn`` backward twice on the
     card, bit-equal.
 17. A9, DIN, DIEN and two-tower retrieval (after phase 16 has released
     its memory; each arch's 20 training batches drawn in background
     threads meanwhile):
     (a) kernels 1, 1b and 2 at DIN's width 18 (not a multiple of 4: the
     bag's scalar walk and the push's scalar branch) and two-tower's 256
     (the top of the bag's range), on one pod's inputs from each stream's
     first batch of 65536, deduplicated at capacity 2^20: DIN's 3,309,568
     takes as bags of one id, two-tower's mask-weighted history bag of 50
     (1,638,400 entries, 32768 bags) and its 32768 item takes; kernel 2
     on the whole 2 M- and 5 M-row tables at the batch's ~821 k and ~701
     k real uids with the pull's pads.  Bit-equal to the CPU plain
     versions (the push to its plain version on the card), two runs
     equal; timed cold and warm beside the plain version, the bound, and
     ``F.embedding_bag`` on the same CSR and ``index_select`` (a take) or
     ``index_add_`` (a bag; 1b), the scatter alone (2);
     (b) ``build_trainer`` at the published widths (din: embed 18, seq
     100, attention 80-40, MLP 200-80, 2 M items; dien: the same with GRU
     108; two-tower: embed 256, towers 1024-512-256, history 50, 5 M
     items, pool 4096), the launcher's k-step settings (n_pod 2, k 20,
     two_phase, lr 1e-3, sparse lr 0.5), gather placement, capacity 2^20,
     batch 65536, **DIEN's cut to 32768** (1.05 MB of autograd state an
     instance): 20 ``fit_online`` steps (one merge): finite losses, no
     dropped id, exact launches (kernel 1 n_pod + 1 a step for DIN and
     DIEN, 2 n_pod for two-tower; 1b n_pod (2 n_pod); 2 one; 6 per local
     step; every other 0), online AUC (DIN, DIEN), peak memory; a step's
     stream time by part, the ``train_step`` wall, the busy share;
     (c) a ``CTRServer`` (max_batch 512, serve_p99) over each trained
     trainer, 2048 requests: QPS, p50/p99, scores finite in (0, 1) (u·v
     in [-1, 1] for two-tower), no id dropped; two-tower's retrieval_cand:
     one user against 1,000,000 candidates on the card's table, the wall,
     the first 1000 scores against a CPU run;
     (d) each arch at smoke size, 6 steps on the gather and the cached
     placement (kernels 3, 4 and 5), card against CPU from one state:
     losses, tables, accumulators and dense within rtol 1e-4, atol 1e-6
     (two-tower 1e-5: its logits are divided by the temperature 0.05).
 18. GIN (gin-tu), its four cells' graphs made in background threads
     during phase 17 (``community_graph`` takes an integer degree:
     ogb_products' 61,859,140 edges -> 61,225,725, minibatch_lg's
     114,615,892 -> 11,648,250, full_graph_sm's 10,556 -> 10,832):
     (a) kernels 1 and 1b at ogb_products' widths 100 and 64 (2,449,029
     rows, bit-equal to the CPU plain version on 4096 sampled bags and
     working rows), the minibatch_lg block (169,984 nodes, 168,960
     masked edges) at 602 and 64, full_graph_sm at 1433, the molecule
     readout (3840 nodes into 128 graphs) and odd widths 257, 300, 513
     (a very long and a long working row); past 256 columns column tiles
     of 256.  Bit-equal to the CPU plain versions, two runs bit-equal;
     timed cold and warm beside the plain version, ``index_select`` +
     ``index_add_``, ``F.embedding_bag`` on the CSR and
     ``torch.sparse.mm`` (cuSPARSE SpMM), two bounds (distinct rows; a
     row an entry), the long rows of each direction;
     (b) ogb_products full batch at gin-tu's MODEL with width 100 and 47
     classes, n_pod 2 on one expanded copy of the graph, the launcher's
     k 20, two_phase, lr 1e-3, 20 steps: finite losses, exact launches (kernel
     1 n_layers a pod a step, 1b n_layers - 1, 6 per local step, every
     other 0), walls, peak memory, a step's stream time by part, device
     time by kernel class and the busy share; a second run saves at
     step 10 and is dropped after 13, a fresh trainer resumes it: every
     loss and the final state bit-equal to the first run (phase 19 (b));
     (c) minibatch_lg: 20 steps through the ported ``NeighborSampler``
     (1024 seeds, fanouts 15 and 10), x gathered on the host, n_pod 1, k
     1; (d) full_graph_sm at MODEL and the molecule cell (graph readout,
     per-worker streams podded), 20 steps each; (e) the smoke config,
     card against CPU from one state, node and graph readout, 6 steps,
     within rtol 1e-4, atol 1e-6; (f) ``examples/train_gin.py``'s two
     regimes from its initial weights (``tests/fixtures``): accuracy
     above 0.5 (full graph) and 0.4 (minibatch).
 19. checkpoints, under ``build/phase19_ckpt`` (deleted at the end):
     (a) DIN at the published widths (2 M items, gather, capacity 2^20,
     the launcher's settings, phase 17's batches), 10 steps, ckpt_every
     5 with the async writer: a run dropped after step 7 and resumed in
     a fresh trainer replays steps 6-10 with losses, tables,
     accumulators, dense and moments bit-equal to an uninterrupted run;
     the save's blocking wall, its wall until the writer lands it and
     its bytes; (b) the same at smoke size on the cached placement (its
     cache saved unflushed) and on the DiskStore (its pages in the
     checkpoint), and for ogb_products in phase 18 (b).
 20. the pull prefetch (A5): baidu-ctr at full width with rows cut to 1 M
     (245 pages of 4096 rows on disk, under ``build/phase20_spill``,
     written once and hard-linked for each later store, deleted at the
     end), capacity 65536, batch 1024, the launcher's settings; each run
     23 steps (through the merge at step 20) in ``fit``'s one-ahead loop
     with a 256-request drain after each step's prefetch, so the server
     scores with a pull in flight: (a) gather on the host store,
     synchronous; (b) gather, prefetched, fed by ``PrefetchPipeline`` with
     ``CudaStager`` (each batch pinned and copied on its own stream); (c)
     cached (262144 rows) on the host store, (d) gather and (e) cached on
     the DiskStore with an unbounded page cache, prefetched; (f) cached
     on the DiskStore with a 64-page cache, 3 steps synchronous and 3
     prefetched, each from a fresh store; (g) dlrm-mlperf at the published
     widths, tables capped at 1 M rows, batch 65536, sparse lr 0.1, 23
     steps synchronous, then prefetched.  Losses and every drain's scores
     of (b)-(e) bit-equal to (a)'s, (f)'s and (g)'s pairs bit-equal; launch
     counts those of the synchronous runs; after ``close`` a fresh
     DiskStore reads (a)'s rows at every touched uid.  Each run prints its
     step wall and device busy share (a CUDA profiler trace over its last
     5 steps),
     the pipeline's read and wait seconds, the page meters after the
     read-ahead drained, and the steps whose ``prefetch`` returned before
     the step's end event had completed.

TF32 is off for matmuls and convolutions.  Prints the card (``nvidia-smi``
name and power limit), a ``kernels`` JSON line, and as its last line
``{"ok": true, "device": {...}}``.  Without CUDA, or outside a checkout, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ROWS = 50_000_000          # baidu-ctr's 2e9 rows cut to fit one card
CAPACITY = 65536           # > the ~34 k distinct ids of a 1024 x 100 batch
BATCH = 1024               # SHAPES["serve_online"]
TAIL = 300
TOL = dict(rtol=1e-5, atol=1e-5)
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 without tensor
# cores.  They assume the 700 W limit; the printed power limit says more.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 34e12     # float64 without tensor cores
BF16_FLOP_PER_S = 989e12   # dense, on the tensor cores


def _time_ms(fn, iters=100, warmup=10, cold_l2=True, scrub_read=False):
    """Mean device time of one ``fn`` call (CUDA events).

    ``cold_l2``: a 256 MB write before each call evicts the L2 and an event
    pair brackets the call alone, so a kernel repeated on the same rows
    reads them from HBM each time, as its bound assumes.  Otherwise the
    calls run back to back between two events and find the rows the last
    call left in L2.  ``scrub_read``: the 256 MB are read instead of
    written, so the L2 the call finds holds clean lines, not the write's
    dirty ones that its misses must write back.  The 256 MB is freed on
    return, so it adds nothing to a later phase's peak memory."""
    import torch

    for _ in range(warmup):
        fn()
    if cold_l2:
        scrub = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
        scrub.zero_()
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
                 for _ in range(iters)]
        for start, end in pairs:
            if scrub_read:
                scrub.amax()
            else:
                scrub.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, iters=40, cold_l2=True):
    """Device time of one ``fn`` call with no host in it: ``fn`` captured in
    a CUDA graph, each replay after the 256 MB write that evicts the L2
    (``cold_l2``; else after a spin of the device that reads nothing, so
    the replay finds the L2 as the one before left it), an event pair
    around the replay alone."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    scrub = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in pairs:
        if cold_l2:
            scrub.zero_()
        else:
            torch.cuda._sleep(100_000)   # ~50 us: the host enqueues meanwhile
        start.record()
        graph.replay()
        end.record()
    torch.cuda.synchronize()
    del graph
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def _host_us(fn, calls=50):
    """Host time of one ``fn`` call, back to back (the device's time hidden
    behind the enqueue while the queue has room)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def _bag_case(gen, C, D, nnz, num_bags, weighted, device):
    """Working set (C + 1, D) with a zero drop row, unsorted seg that leaves
    about a third of the bags empty, a few ids on the drop row."""
    import torch

    working = torch.randn((C + 1, D), generator=gen, device=device)
    working[C] = 0
    inv = torch.randint(0, C, (nnz,), generator=gen, device=device,
                        dtype=torch.int32)
    inv[torch.rand(nnz, generator=gen, device=device) < 0.05] = C
    used = torch.randperm(num_bags, generator=gen, device=device)
    used = used[:max(1, 2 * num_bags // 3)]
    pick = torch.randint(0, used.numel(), (nnz,), generator=gen, device=device)
    seg = used[pick].to(torch.int32)
    w = None
    if weighted:
        w = (torch.rand(nnz, generator=gen, device=device) < 0.9).float()
    return working, inv, seg, w


def _kernel_times(fn, calls=20):
    """{kernel name: device ms per ``fn`` call} from the profiler over
    ``calls`` calls, each after the 256 MB write that evicts the L2 (whose
    own kernel is left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    scrub = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            scrub.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = e.self_device_time_total
        if us > 0 and "FillFunctor" not in e.key:
            out[e.key] = out.get(e.key, 0.0) + us / calls / 1e3
    return out


def _print_kernel_times(what, times):
    print(f"  {what}, device time by kernel (profiler, L2 cold, ms per call):"
          f" " + "; ".join(f"{k[:60]} {v:.4f}" for k, v in sorted(
              times.items(), key=lambda kv: -kv[1])))


def _slice_case(device, scale=1):
    """The serving path's bag inputs for the first request batch: ids
    deduplicated at capacity 65536, seg as recsys builds it
    (instance * n_fields + field), mask weights, and 1 % of the ids moved
    to the drop row.  ``scale`` multiplies the batch and the capacity (the
    same stream's first batch of ``scale`` times the instances)."""
    import torch

    from repro_torch.configs import baidu_ctr
    from repro_torch.core.embedding_backend import _dedup
    from repro_torch.data.synthetic import ctr_batches

    cfg = baidu_ctr.MODEL
    batch, capacity = BATCH * scale, CAPACITY * scale
    b = next(ctr_batches(seed=2, batch=batch, rows=ROWS))
    ids = torch.from_numpy(b["ids"]).to(device).reshape(-1)
    _, inv, _ = _dedup(ids, capacity)
    gen = torch.Generator(device).manual_seed(11)
    inv[torch.rand(inv.numel(), generator=gen, device=device) < 0.01] = capacity
    inst = torch.arange(batch, dtype=torch.int32, device=device)[:, None]
    seg = (inst * cfg.n_fields
           + torch.from_numpy(b["field_ids"]).to(device)).reshape(-1)
    w = torch.from_numpy(b["mask"]).to(device).reshape(-1)
    working = torch.randn((capacity + 1, cfg.embed_dim), generator=gen,
                          device=device)
    working[capacity] = 0
    return working, inv, seg.contiguous(), w, batch * cfg.n_fields


def _pointer_chase_lib():
    """``tools/pointer_chase.cu`` built by ``nvcc`` into
    ``build/pointer_chase.so`` (a plain C interface, seconds to build; not
    rebuilt while the source is older) and loaded with ctypes."""
    import ctypes

    from torch.utils.cpp_extension import CUDA_HOME

    src = ROOT / "tools" / "pointer_chase.cu"
    lib = ROOT / "build" / "pointer_chase.so"
    if not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime:
        lib.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([str(pathlib.Path(CUDA_HOME) / "bin" / "nvcc"), "-O3",
                        "-shared", "-Xcompiler", "-fPIC",
                        "-gencode=arch=compute_90a,code=sm_90a", "-o",
                        str(lib), str(src)], check=True, capture_output=True,
                       text=True, timeout=300)
    handle = ctypes.CDLL(str(lib))
    handle.pointer_chase.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p]
    handle.random_reads.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int64, ctypes.c_int32,
                                    ctypes.c_void_p, ctypes.c_void_p]
    handle.pointer_chase.restype = handle.random_reads.restype = ctypes.c_int
    return handle


def _random_reads_ms(words, idx):
    """Device time (CUDA graph replays, L2 cold) of reading ``idx``'s words
    of a fresh table of ``words`` int32, each load independent of the
    others (``tools/pointer_chase.cu``'s random_reads)."""
    import torch

    lib = _pointer_chase_lib()
    table = torch.zeros(words, dtype=torch.int32, device="cuda")
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    idx = idx.to(torch.int64).contiguous()

    def run():
        rc = lib.random_reads(table.data_ptr(), idx.data_ptr(), idx.numel(),
                              1, sink.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"random_reads: CUDA error {rc}")

    return _graph_ms(run)


def _hbm_trip(steps=2048, lines=1 << 19):
    """(us of one dependent trip to HBM, ms of an empty launch on the device
    alone): one thread follows ``steps`` dependent loads through a random
    cycle over ``lines`` 128-byte lines (64 MB, more than the 50 MB L2,
    which is also scrubbed before each call); a trip is the difference to
    a call of no loads over ``steps``.  The empty launch is that call of no
    loads as a CUDA graph replay (``_graph_ms``)."""
    import torch

    lib = _pointer_chase_lib()
    gen = torch.Generator("cuda").manual_seed(7)
    perm = torch.randperm(lines, generator=gen, device="cuda") * 16
    nxt = torch.zeros(lines * 16, dtype=torch.int64, device="cuda")
    nxt[perm] = torch.roll(perm, -1)
    sink = torch.zeros(1, dtype=torch.int64, device="cuda")
    start = int(perm[0])

    def run(n):
        rc = lib.pointer_chase(nxt.data_ptr(), start, n, sink.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"pointer_chase: CUDA error {rc}")

    chase_ms = _time_ms(lambda: run(steps), iters=10, warmup=2)
    if int(sink) != int(perm[steps % lines]):
        raise AssertionError("pointer_chase ended on the wrong line")
    empty_ms = _time_ms(lambda: run(0), iters=10, warmup=2)
    return (chase_ms - empty_ms) / steps * 1e3, _graph_ms(lambda: run(0))


def _compile_times(build_dir) -> str:
    """Each object's compile time from the build's ``.ninja_log`` (its
    last record per output: start and end in ms), longest first."""
    last = {}
    log = pathlib.Path(build_dir) / ".ninja_log"
    for line in log.read_text().splitlines()[1:] if log.exists() else []:
        start, end, _, out, _ = line.split("\t")
        last[out] = (int(end) - int(start)) / 1e3
    return ", ".join(f"{o} {s:.1f} s" for o, s in
                     sorted(last.items(), key=lambda kv: -kv[1])) or "n/a"


def phase_kernels(device):
    """Each kernel against its plain version; returns the kernels-line entry
    (without ``launches``, which the slice phase fills)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels import embedding_bag as kb
    from repro_torch.kernels import ops, ref

    max_err = 0.0

    def check(name, got, want):
        nonlocal max_err
        torch.cuda.synchronize()
        err = (got - want).abs().max().item() if got.numel() else 0.0
        max_err = max(max_err, err)
        if not torch.allclose(got, want, **TOL):
            raise AssertionError(f"{name}: kernel and plain version differ, "
                                 f"max |diff| {err}")
        return err

    def bag_checks(name, working, inv, seg, w, num_bags):
        out = kb.embedding_bag_cuda(working, inv, seg, w, num_bags)
        torch.cuda.synchronize()
        again = kb.embedding_bag_cuda(working, inv, seg, w, num_bags)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"{name}: two runs differ")
        err = check(name, out, ref.embedding_bag_ref(working, inv, seg, w,
                                                     num_bags))
        cpu = ref.embedding_bag_ref(working.cpu(), inv.cpu(), seg.cpu(),
                                    None if w is None else w.cpu(), num_bags)
        same = torch.equal(out.cpu(), cpu)
        print(f"  {name}: max|kernel - plain| {err:.3g}, "
              f"bit-equal to the CPU plain version: {same}")

    t0 = time.perf_counter()
    build.extension()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(build.SOURCES)} into "
          f"{build.BUILD_DIR.relative_to(ROOT)}; each source's compile, "
          f"side by side: {_compile_times(build.BUILD_DIR)})")

    working, inv, seg, w, num_bags = _slice_case(device)
    print(f"phase 1: embedding_bag against its plain version "
          f"(working {tuple(working.shape)}, nnz {inv.numel()}, "
          f"bags {num_bags})")
    bag_checks("slice shape, mask weights", working, inv, seg, w, num_bags)
    bag_checks("slice shape, unweighted", working, inv, seg, None, num_bags)

    gen = torch.Generator(device).manual_seed(5)
    for C, D, nnz, nb in [(37, 24, 101, 53), (200, 16, 333, 97),
                          (90, 100, 257, 40), (64, 200, 150, 31)]:
        for weighted in (True, False):
            case = _bag_case(gen, C, D, nnz, nb, weighted, device)
            bag_checks(f"C={C} D={D} nnz={nnz} bags={nb} "
                       f"weighted={weighted}", *case, nb)

    for combiner in ("sum", "mean", "sqrtn"):
        wk, inv_c, seg_c, w_c = _bag_case(gen, 500, 64, 2000, 300, True,
                                          device)
        g = torch.randn((300, 64), generator=gen, device=device)
        grads = []
        for fn in (ops.embedding_bag_working, ref.embedding_bag_combiner_ref):
            x = wk.clone().requires_grad_(True)
            y = w_c.clone().requires_grad_(True)
            out = fn(x, inv_c, seg_c, y, 300, combiner)
            (out * g).sum().backward()
            grads.append((out.detach(), x.grad, y.grad))
        for what, a, b in zip(("forward", "grad working", "grad weights"),
                              *grads):
            check(f"{combiner} {what}", a, b)
        print(f"  combiner {combiner}: forward and gradients agree")

    # ---- the index streams against their plain version (a stable sort)
    streams = kb.forward_streams(working, inv, seg, w, num_bags)
    order, offsets = kb.csr_from_segments(seg, num_bags)
    lo, hi = int(offsets[0]), int(offsets[-1])
    if not (torch.equal(streams[2], offsets - lo)
            and torch.equal(streams[0][:hi - lo], inv[order[lo:hi]])
            and torch.equal(streams[1][:hi - lo], w[order[lo:hi]])):
        raise AssertionError("forward_streams differ from csr_from_segments")
    walk_out = kb.walk(working, *streams[:3])
    if not torch.equal(walk_out, kb.embedding_bag_cuda(working, inv, seg, w,
                                                       num_bags)):
        raise AssertionError("the walk alone differs from the wrapper")
    print("  forward_streams equal csr_from_segments (a stable sort); the "
          "walk alone on them equals the wrapper")

    # ---- times at the slice's shapes
    def kernel():
        return kb.embedding_bag_cuda(working, inv, seg, w, num_bags)

    def bag_times(working, inv, seg, w, num_bags):
        """Wrapper, its parts and two library calls on one input (ms)."""
        streams = kb.forward_streams(working, inv, seg, w, num_bags)
        order, offsets = kb.csr_from_segments(seg, num_bags)
        lo, hi = int(offsets[0]), int(offsets[-1])
        inv_s = inv[order[lo:hi]].long()
        w_s = w[order[lo:hi]].contiguous()
        off_s = (offsets - lo).contiguous()
        seg64 = seg.long()

        def embedding_bag():
            return F.embedding_bag(inv_s, working, off_s, mode="sum",
                                   per_sample_weights=w_s,
                                   include_last_offset=True)

        def index_add():
            return torch.zeros((num_bags, working.shape[1]),
                               device=device).index_add_(
                0, seg64, working[inv.long()] * w[:, None])

        for name, fn in (("F.embedding_bag", embedding_bag),
                         ("index_add_", index_add)):
            check(f"library call {name}", fn(), ref.embedding_bag_ref(
                working, inv, seg, w, num_bags))

        def wrapper():
            return kb.embedding_bag_cuda(working, inv, seg, w, num_bags)

        def streams_alone():
            return kb.forward_streams(working, inv, seg, w, num_bags)

        def walk_alone():
            return kb.walk(working, *streams[:3])

        return {
            "ms": _time_ms(wrapper),
            "prep_ms": _time_ms(streams_alone),
            "walk_ms": _time_ms(walk_alone),
            "graph_ms": _graph_ms(wrapper),
            "prep_graph_ms": _graph_ms(streams_alone),
            "walk_graph_ms": _graph_ms(walk_alone),
            "embedding_bag_ms": _time_ms(embedding_bag),
            "embedding_bag_graph_ms": _graph_ms(embedding_bag),
            "library_ms": _time_ms(index_add),
        }

    ms, warm_ms = _time_ms(kernel), _time_ms(kernel, cold_l2=False)
    parts = bag_times(working, inv, seg, w, num_bags)
    prep_ms, walk_ms = parts["prep_ms"], parts["walk_ms"]
    library_ms, emb_ms = parts["library_ms"], parts["embedding_bag_ms"]
    plain_ms = _time_ms(lambda: ref.embedding_bag_ref(working, inv, seg, w,
                                                      num_bags))
    graph_ms, host_us = parts["graph_ms"], _host_us(kernel)

    D = working.shape[1]
    rows_read = torch.unique(inv).numel()
    nbytes = (rows_read * D * 4 + inv.numel() * (4 + 4 + 4)
              + num_bags * D * 4)
    flops = 2 * inv.numel() * D
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) * 1e3
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                >= flops / F32_FLOP_PER_S else "operations")
    print(f"  times (ms, L2 cold): wrapper {ms:.4f} (L2 warm {warm_ms:.4f}; "
          f"index streams alone {prep_ms:.4f}, the walk alone {walk_ms:.4f})"
          f", plain {plain_ms:.4f}, library calls: F.embedding_bag on the "
          f"same CSR {emb_ms:.4f}, index_add_ {library_ms:.4f}; bound "
          f"{bound_ms:.4f} ({nbytes / 1e6:.2f} MB: {rows_read} distinct rows "
          f"read, {flops / 1e6:.1f} MFLOP)")
    print(f"  the device's time alone (CUDA graph replays, L2 cold): wrapper "
          f"{graph_ms:.4f} ms, index streams {parts['prep_graph_ms']:.4f}, "
          f"the walk {parts['walk_graph_ms']:.4f}, F.embedding_bag "
          f"{parts['embedding_bag_graph_ms']:.4f}; the host's time per "
          f"call: {host_us:.1f} us")
    # a programmatic dependent launch's time includes its wait for the
    # kernel before it
    _print_kernel_times("the wrapper", _kernel_times(kernel))
    # the same stream's first batch at four times the instances (and
    # capacity)
    big = _slice_case(device, scale=4)
    scaled = {"nnz": big[1].numel(), "bags": big[4], **bag_times(*big)}
    print(f"  at four times the batch (nnz {scaled['nnz']}, {big[4]} bags): "
          f"wrapper {scaled['ms']:.4f} ms, index streams alone "
          f"{scaled['prep_ms']:.4f}, the walk alone {scaled['walk_ms']:.4f}, "
          f"F.embedding_bag {scaled['embedding_bag_ms']:.4f}, index_add_ "
          f"{scaled['library_ms']:.4f}; on the device alone: wrapper "
          f"{scaled['graph_ms']:.4f}, streams {scaled['prep_graph_ms']:.4f}, "
          f"walk {scaled['walk_graph_ms']:.4f}, F.embedding_bag "
          f"{scaled['embedding_bag_graph_ms']:.4f}")
    del big
    # no sync, no host-to-device copy: the index streams are built on the
    # card
    torch.cuda.set_sync_debug_mode("error")
    try:
        kernel()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    h2d, syncs, launched = _transfers(kernel)
    if h2d or syncs:
        raise AssertionError(f"bag wrapper: {h2d} host-to-device copies, "
                             f"{syncs} syncs")
    print(f"  the wrapper under the sync debug mode \"error\" and the "
          f"profiler: {h2d} host-to-device copies, {syncs} syncs, "
          f"{launched} kernel launches")
    sass = _bag_probe_sass_report()
    return {
        "name": "embedding_bag",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag.py:102",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "ms_l2_warm": warm_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "embedding_bag_ms": emb_ms,
        "graph_ms": graph_ms,
        "host_us": host_us,
        "prep_ms": prep_ms,
        "walk_ms": walk_ms,
        "at_four_times_the_batch": scaled,
        "sass": sass,
    }


def phase_slice(device):
    """The serving path at full width; returns the launch counts of the
    timed run."""
    import torch

    from repro_torch.configs import baidu_ctr
    from repro_torch.data.synthetic import ctr_batches
    from repro_torch.kernels import ops
    from repro_torch.runtime.factory import build_ctr_server, build_trainer
    from repro_torch.runtime.metrics import auc
    from repro_torch.runtime.trainer import TrainerConfig

    mcfg = dataclasses.replace(baidu_ctr.MODEL, rows=ROWS)
    t0 = time.perf_counter()
    tr = build_trainer(
        "baidu-ctr",
        TrainerConfig(placement="gather", store="host", capacity=CAPACITY),
        smoke=False, model_cfg=mcfg, seed=0, device=device)
    torch.cuda.synchronize()
    state_gb = sum(t.numel() * t.element_size() for t in
                   list(tr.tables.values())
                   + list(tr.sparse_state.accum.values())) / 1e9
    print(f"phase 2: baidu-ctr serving, rows {ROWS}, capacity "
          f"{tr.engine.capacity}, batch {BATCH}; trainer built in "
          f"{time.perf_counter() - t0:.1f} s, table + accumulator "
          f"{state_gb:.1f} GB on the card")
    if tr.engine.capacity != CAPACITY:
        raise AssertionError(f"capacity {tr.engine.capacity}, not {CAPACITY}")

    warm = build_ctr_server(tr, max_batch=BATCH)
    warm.submit_batch(next(ctr_batches(seed=1, batch=BATCH, rows=ROWS)))
    warm.drain()

    stream = ctr_batches(seed=2, batch=BATCH, rows=ROWS)
    batches = [next(stream) for _ in range(5)]
    batches[-1] = {k: v[:TAIL] for k, v in batches[-1].items()}
    distinct = [int(np.unique(b["ids"]).size) for b in batches]
    before = tr.serve_metrics()
    sums = _checksum(tr)
    server = build_ctr_server(tr, max_batch=BATCH)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    for b in batches:
        server.submit_batch(b)
    reqs = list(server.pending)
    server.drain()
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    after = tr.serve_metrics()
    summ = server.summary()
    scores = np.array([r.score for r in reqs])
    labels = np.concatenate([b["label"] for b in batches])
    n_sub = 4 * BATCH + TAIL
    scored = after["serve_requests"] - before["serve_requests"]
    slots = scored * baidu_ctr.MODEL.nnz_per_instance
    dropped = slots - (after["serve_lookups"] - before["serve_lookups"])
    if len(reqs) != n_sub or summ["served"] != n_sub:
        raise AssertionError(f"served {summ['served']} of {n_sub} requests")
    if scored != 5 * BATCH:       # predict counts tail pads, as the reference
        raise AssertionError(f"serve_requests moved by {scored}, "
                             f"expected {5 * BATCH}")
    if not (np.isfinite(scores).all() and ((scores > 0) & (scores < 1)).all()):
        raise AssertionError("a score is not a finite value in (0, 1)")
    if launches["embedding_bag"] < 1 or launches["embedding_bag_ref"] != 0:
        raise AssertionError(f"the bag did not run as its kernel: {launches}")
    if _checksum(tr) != sums:
        raise AssertionError("serving changed the table or the accumulator")
    print(f"  requests {n_sub} in {int(summ['steps'])} predicts; qps "
          f"{summ['qps']:.1f}, p50 {summ['p50'] * 1e3:.2f} ms, p99 "
          f"{summ['p99'] * 1e3:.2f} ms, predict wall "
          f"{summ['wall_s'] / summ['steps'] * 1e3:.2f} ms each")
    print(f"  AUC on the labels {auc(labels, scores):.4f} (random weights); "
          f"ids dropped by capacity {dropped:.0f}; distinct ids per batch "
          f"{distinct}; peak device memory {peak_gb:.2f} GB")
    print(f"  launches during the run: {launches}")
    _breakdown(tr, batches[0])
    return launches


def _checksum(tr):
    """Integer sums of the bits of the table and the accumulator, in chunks
    of 2^20 rows (a lookup must leave both untouched)."""
    import torch

    return [sum(int(c.view(torch.int32).sum(dtype=torch.int64))
                for c in t.split(1 << 20))
            for t in list(tr.tables.values())
            + list(tr.sparse_state.accum.values())]


def _breakdown(tr, batch):
    """Device time of one predict's parts (CUDA events; outside the counted
    run)."""
    import torch

    from repro_torch.runtime.trainer import pod_slice

    b = tr._stage(batch)
    eng = tr.engine
    with torch.inference_mode():
        wss, _ = eng.lookup_batch(tr.tables, tr.sparse_state.accum,
                                  tr.backend_state, b)
        workings = {n: ws.rows for n, ws in wss.items()}
        invs = {n: ws.inverse for n, ws in wss.items()}
        emb = tr._embed(workings, invs, b)
        dense0 = pod_slice(tr.dense, 0)
        parts = {
            "stage batch": lambda: tr._stage(batch),
            "lookup (dedup + gather)": lambda: eng.lookup_batch(
                tr.tables, tr.sparse_state.accum, tr.backend_state, b),
            "bags (CUDA kernel + index prep)": lambda: tr._embed(
                workings, invs, b),
            "attention + MLP + sigmoid": lambda: tr._loss(
                dense0, emb, b, predict=True),
            "whole predict": lambda: tr.predict(batch),
        }
        times = {k: _time_ms(fn, iters=20, warmup=3, cold_l2=False)
                 for k, fn in parts.items()}
    print("  one predict, device time by part (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in times.items()))


def phase_agreement(device):
    """The port on the card and on the CPU, one state, same requests."""
    import torch

    from repro_torch import tree_map
    from repro_torch.configs import baidu_ctr
    from repro_torch.data.synthetic import ctr_batches
    from repro_torch.interop import ReferenceState
    from repro_torch.models import recsys as R
    from repro_torch.runtime.factory import (
        build_ctr_engine,
        build_ctr_server,
        build_trainer,
    )
    from repro_torch.runtime.trainer import HybridTrainer, TrainerConfig

    smoke = baidu_ctr.SMOKE
    tcfg = TrainerConfig(placement="gather", capacity=256)
    gpu = build_trainer("baidu-ctr", tcfg, seed=3, device=device)
    state = ReferenceState(
        dense=tree_map(lambda x: x.cpu(), gpu.dense),
        tables={n: t.cpu() for n, t in gpu.tables.items()},
        accum={n: a.cpu() for n, a in gpu.sparse_state.accum.items()})
    cpu = HybridTrainer(None, build_ctr_engine(smoke, tcfg, device="cpu"),
                        R.ctr_embed_from_workings(smoke),
                        R.ctr_hybrid_loss(smoke), tcfg, state=state,
                        device="cpu")
    stream = ctr_batches(seed=4, batch=64, rows=smoke.rows,
                         n_fields=smoke.n_fields,
                         nnz=smoke.nnz_per_instance)
    batches = [next(stream) for _ in range(3)]
    got = []
    for tr in (gpu, cpu):
        server = build_ctr_server(tr, max_batch=64)
        for b in batches:
            server.submit_batch(b)
        reqs = list(server.pending)
        server.drain()
        got.append(np.array([r.score for r in reqs]))
    np.testing.assert_allclose(got[0], got[1], **TOL)
    print(f"phase 6: smoke-size serving, card vs CPU from one state: "
          f"{got[0].size} scores, max |diff| "
          f"{np.abs(got[0] - got[1]).max():.3g}")


def _train_batches(n, seed=1, batch=None, rows=ROWS):
    """The first ``n`` batches of the training stream (50 M-row ids unless
    ``rows`` says otherwise)."""
    from repro_torch.data.synthetic import ctr_batches

    stream = ctr_batches(seed=seed, batch=batch or BATCH, rows=rows)
    return [next(stream) for _ in range(n)]


def _backward_slice_case(device, scale=1):
    """The bag backward's inputs on the training path, pod 0 of n_pod 2:
    the first training batch deduplicated at capacity 65536, its first 512
    instances (51200 ids, 20480 bags), mask weights, a random cotangent.
    ``scale`` multiplies the batch and the capacity (the same stream's
    first batch of ``scale`` times the instances)."""
    import torch

    from repro_torch.configs import baidu_ctr
    from repro_torch.core.embedding_backend import _dedup

    cfg = baidu_ctr.MODEL
    b = _train_batches(1, batch=BATCH * scale)[0]
    ids = torch.from_numpy(b["ids"]).to(device).reshape(-1)
    capacity = CAPACITY * scale
    _, inv, _ = _dedup(ids, capacity)
    half = BATCH * scale // 2
    nnz = half * cfg.nnz_per_instance
    inv = inv[:nnz].contiguous()
    inst = torch.arange(half, dtype=torch.int32, device=device)[:, None]
    seg = (inst * cfg.n_fields + torch.from_numpy(
        b["field_ids"][:half]).to(device)).reshape(-1).contiguous()
    w = torch.from_numpy(b["mask"][:half]).to(device).reshape(-1)
    gen = torch.Generator(device).manual_seed(21)
    working = torch.randn((capacity + 1, cfg.embed_dim), generator=gen,
                          device=device)
    working[capacity] = 0
    g = torch.randn((half * cfg.n_fields, cfg.embed_dim), generator=gen,
                    device=device) * 1e-3
    return g, working, inv, seg, w


def phase_backward(device):
    """The bag backward kernel against the plain vjp; returns its
    kernels-line entry (without ``launches``)."""
    import torch

    from repro_torch.kernels import embedding_bag as kb
    from repro_torch.kernels import ref

    max_err = 0.0

    def checks(name, g, working, inv, seg, w):
        nonlocal max_err
        need_w = w is not None
        got = kb.embedding_bag_backward_cuda(g, working, inv, seg, w, True,
                                             need_w)
        again = kb.embedding_bag_backward_cuda(g, working, inv, seg, w, True,
                                               need_w)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)
                   if a is not None):
            raise AssertionError(f"backward {name}: two runs differ")
        cpu = ref.embedding_bag_backward_ref(
            g.cpu(), working.cpu(), inv.cpu(), seg.cpu(),
            None if w is None else w.cpu(), True, need_w)
        if not torch.equal(got[0].cpu(), cpu[0]):
            err = (got[0].cpu() - cpu[0]).abs().max().item()
            raise AssertionError(f"backward {name}: working-row gradient "
                                 f"not bit-equal to the CPU plain vjp "
                                 f"(max |diff| {err})")
        card = ref.embedding_bag_backward_ref(g, working, inv, seg, w, True,
                                              need_w)
        err = (got[0] - card[0]).abs().max().item()
        max_err = max(max_err, err)
        msg = f"  {name}: g_work bit-equal to the CPU plain vjp"
        if need_w:
            err_w = (got[1].cpu() - cpu[1]).abs().max().item()
            max_err = max(max_err, err_w)
            if not torch.allclose(got[1].cpu(), cpu[1], **TOL):
                raise AssertionError(f"backward {name}: weight gradient "
                                     f"differs, max |diff| {err_w}")
            msg += f", g_w max |diff| {err_w:.3g}"
        print(msg + f"; vs the plain vjp on the card max |diff| {err:.3g}")

    def long_rows(inv, rows):
        per_row = torch.bincount(inv.long(), minlength=rows)
        return (per_row, int((per_row > kb.LONG_ROW).sum()),
                int((per_row > kb.VERY_LONG).sum()))

    g, working, inv, seg, w = _backward_slice_case(device)
    per_row, n_long, n_very = long_rows(inv, working.shape[0])
    print(f"phase 1: embedding_bag backward against the plain vjp "
          f"(g {tuple(g.shape)}, working {tuple(working.shape)}, nnz "
          f"{inv.numel()}; the hottest working row holds "
          f"{int(per_row.max())} entries, {n_long} rows hold more than "
          f"{kb.LONG_ROW}, {n_very} more than {kb.VERY_LONG})")
    checks("slice shape, mask weights", g, working, inv, seg, w)
    gen = torch.Generator(device).manual_seed(6)
    for C, D, nnz, nb in [(37, 24, 101, 53), (200, 16, 333, 97),
                          (90, 100, 257, 40), (64, 200, 150, 31)]:
        for weighted in (True, False):
            wk, iv, sg, ww = _bag_case(gen, C, D, nnz, nb, weighted, device)
            gg = torch.randn((nb, D), generator=gen, device=device)
            checks(f"C={C} D={D} nnz={nnz} bags={nb} weighted={weighted}",
                   gg, wk, iv, sg, ww)

    # ---- times at the training path's shapes (the CTR mask needs no grad)

    def kernel():
        return kb.embedding_bag_backward_cuda(g, working, inv, seg, w, True,
                                              False)

    ms, warm_ms = _time_ms(kernel), _time_ms(kernel, cold_l2=False)
    rows = working.shape[0]
    # the index streams alone (the call's first part); the kernels' time
    # is the wrapper's less theirs
    prep_ms = _time_ms(lambda: kb.backward_streams(g, inv, seg, w, rows))
    # the same inputs without the hottest row's entries: what the one long
    # row costs
    hot = int(per_row.argmax())
    keep = inv != hot
    cool = [x[keep].contiguous() for x in (inv, seg, w)]
    no_hot_ms = _time_ms(lambda: kb.embedding_bag_backward_cuda(
        g, working, cool[0], cool[1], cool[2], True, False))
    no_hot_prep_ms = _time_ms(lambda: kb.backward_streams(g, *cool, rows))
    # the fixed order's floor: the hot row's dependent float32 adds, one
    # per entry and column chain, at an FADD latency of 4 cycles at the
    # card's maximum SM clock
    hot_n = int(per_row[hot])
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True, timeout=60).stdout.split()[0])
    order_ms = hot_n * 4 / (mhz * 1e6) * 1e3
    plain_ms = _time_ms(lambda: ref.embedding_bag_backward_ref(
        g, working, inv, seg, w, True, False))
    inv64, seg64 = inv.long(), seg.long()

    def library():
        return torch.zeros_like(working).index_add_(
            0, inv64, g[seg64] * w[:, None])

    library_ms = _time_ms(library)
    D = working.shape[1]
    g_rows = torch.unique(seg).numel()
    nbytes = (g_rows * D * 4 + inv.numel() * (4 + 4 + 4)
              + working.shape[0] * D * 4)
    flops = 2 * inv.numel() * D
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) * 1e3
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                >= flops / F32_FLOP_PER_S else "operations")
    print(f"  times (ms, L2 cold): wrapper {ms:.4f} (L2 warm "
          f"{warm_ms:.4f}), plain vjp {plain_ms:.4f}, index_add_ library "
          f"call {library_ms:.4f}; bound {bound_ms:.4f} "
          f"({nbytes / 1e6:.2f} MB: {g_rows} cotangent rows read, "
          f"{working.shape[0]} working rows written)")
    graph_ms, graph_lib_ms = _graph_ms(kernel), _graph_ms(library)
    host_us, host_lib_us = _host_us(kernel), _host_us(library)
    print(f"  the device's time alone (CUDA graph replays, L2 cold): wrapper "
          f"{graph_ms:.4f}, index_add_ library call {graph_lib_ms:.4f}; the "
          f"host's time per call: wrapper {host_us:.1f} us, library call "
          f"{host_lib_us:.1f} us")
    print(f"  index streams alone {prep_ms:.4f} ms, so the kernels "
          f"{ms - prep_ms:.4f} (the wrapper less the streams); without the "
          f"hottest row's {hot_n} entries: wrapper {no_hot_ms:.4f}, streams "
          f"{no_hot_prep_ms:.4f}, kernels {no_hot_ms - no_hot_prep_ms:.4f}; "
          f"the order floor (the hot row's {hot_n} dependent adds at 4 "
          f"cycles, {mhz:.0f} MHz) {order_ms:.4f} ms beside the bytes bound "
          f"{bound_ms:.4f}")
    # the placement reads all of inv once per long row: the same stream's
    # first batch at four times the instances (and capacity)
    big = _backward_slice_case(device, scale=4)
    _, big_long, big_very = long_rows(big[2], big[1].shape[0])
    big_inv64, big_seg64 = big[2].long(), big[3].long()
    scaled = {
        "nnz": big[2].numel(), "long_rows": big_long,
        "very_long_rows": big_very,
        "ms": _time_ms(lambda: kb.embedding_bag_backward_cuda(
            *big, True, False)),
        "prep_ms": _time_ms(lambda: kb.backward_streams(
            big[0], big[2], big[3], big[4], big[1].shape[0])),
        "library_ms": _time_ms(lambda: torch.zeros_like(big[1]).index_add_(
            0, big_inv64, big[0][big_seg64] * big[4][:, None]))}
    print(f"  at four times the pod's batch (nnz {scaled['nnz']}, "
          f"{big_long} rows of more than {kb.LONG_ROW} entries, {big_very} "
          f"of more than {kb.VERY_LONG}; phase 1's: {n_long}, {n_very}): "
          f"wrapper {scaled['ms']:.4f} ms, index streams alone "
          f"{scaled['prep_ms']:.4f}, index_add_ library call "
          f"{scaled['library_ms']:.4f}")
    del big, big_inv64, big_seg64
    # the wrapper as the training path calls it: no sync, no host-to-device
    # copy (the index streams' sort and the long rows' discovery run on the
    # card)
    torch.cuda.set_sync_debug_mode("error")
    try:
        kernel()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    h2d, syncs, launched = _transfers(kernel)
    if h2d or syncs:
        raise AssertionError(f"backward wrapper: {h2d} host-to-device "
                             f"copies, {syncs} syncs")
    print(f"  the wrapper under the sync debug mode \"error\" and the "
          f"profiler: {h2d} host-to-device copies, {syncs} syncs, "
          f"{launched} kernel launches")
    sass = _bag_dot_sass_report()
    return {
        "name": "embedding_bag_backward",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/ops.py:113 (XLA vjp, no Pallas "
                    "kernel)",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "ms_l2_warm": warm_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "graph_ms": graph_ms,
        "library_graph_ms": graph_lib_ms,
        "host_us": host_us,
        "library_host_us": host_lib_us,
        "prep_ms": prep_ms,
        "ms_without_hot_row": no_hot_ms,
        "prep_ms_without_hot_row": no_hot_prep_ms,
        "long_rows": n_long,
        "at_four_times_the_batch": scaled,
        "order_floor_ms": order_ms,
        "sass": sass,
    }


def _slice_uids(device, capacity=CAPACITY, fit_rows=None):
    """uids as the training pull lays them out for the first training
    batch (strictly ascending real ids, then pads repeating uids[0]).
    With ``fit_rows`` the ids at or above ``fit_rows - n_real`` are
    renumbered in order from there, so the layout fits a table of
    ``fit_rows`` rows with every id below that line unchanged."""
    import torch

    from repro_torch.core.embedding_backend import pull_working_set

    b = _train_batches(1)[0]
    ids = torch.from_numpy(b["ids"]).to(device).reshape(-1)
    uids, _ = pull_working_set(ids, capacity)
    n_real = min(int(torch.unique(ids).numel()), capacity)
    if fit_rows is not None:
        real = uids[:n_real].long()
        line = fit_rows - n_real
        high = real >= line
        rank = torch.cumsum(high.long(), 0) - 1
        real = torch.where(high, line + rank, real)
        uids = torch.cat([real, real[:1].expand(capacity - n_real)]).to(
            torch.int32)
    return uids.contiguous(), n_real


def _push_inputs(gen, uids, n_real, table_rows, D, device):
    """A table, its accumulator, gradient rows whose pads are zero, and the
    plain version's ``(delta, g2)`` for them."""
    import torch

    from repro_torch.kernels.sparse_adagrad import adagrad_row_updates

    table = torch.randn((table_rows, D), generator=gen, device=device) * 0.05
    accum = torch.rand((table_rows, D), generator=gen, device=device) + 0.01
    grads = torch.randn((uids.numel(), D), generator=gen, device=device)
    grads[n_real:] = 0.0               # no id slot maps to a pad
    delta, g2 = adagrad_row_updates(accum[uids.long()], grads, table.dtype,
                                    lr=0.5, eps=1e-10)
    return table, accum, grads, delta, g2


PUSH_ROWS = 4_000_000       # phase 1's smaller push table


def _push_bound(n_real, n_pos, D, streams=1):
    """(ms, what bounds it, bytes) of a push of ``n_real`` real rows of
    ``D`` at ``n_pos`` positions: each real row's table, accumulator and
    gradient rows read and the two rows written (5 x 4 x D bytes) plus
    ``streams`` int32 index streams; per element the row math's float32
    operations (g*g, -lr*g, + eps, the division, two adds) at the float32
    peak and its float64 ones (a multiply, an add, the root) at the
    float64 peak."""
    nbytes = n_real * D * 4 * 5 + n_pos * 4 * streams
    t_b = nbytes / HBM_BYTES_PER_S
    t_f = n_real * D * (6 / F32_FLOP_PER_S + 3 / F64_FLOP_PER_S)
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations",
            nbytes)


def _call_times(fn, plain=None):
    """Times of one ``fn`` call (ms unless said): cold and warm L2, the
    device alone (graph) and the host per call; ``plain`` cold."""
    out = {"ms": _time_ms(fn), "ms_l2_warm": _time_ms(fn, cold_l2=False),
           "graph_ms": _graph_ms(fn), "host_us": _host_us(fn)}
    if plain is not None:
        out["plain_ms"] = _time_ms(plain)
    return out


def _one_launch(fn, what):
    """``fn()`` under the profiler launches one kernel, with no
    host-to-device copy and no sync: one extension call."""
    h2d, syncs, kernels = _transfers(fn)
    if (h2d, syncs, kernels) != (0, 0, 1):
        raise AssertionError(f"{what}: {kernels} kernel launches, {h2d} "
                             f"host-to-device copies, {syncs} syncs; "
                             f"expected one launch and nothing else")
    print(f"  {what} (profiler): 1 kernel launch, 0 host-to-device copies, "
          f"0 synchronizing calls")


def phase_push(device):
    """The push kernel (the row math in it) against its plain version
    (``adagrad_row_updates``, then ``index_add_``); returns its kernels-line
    entry (without ``launches``)."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.sparse_adagrad import (
        adagrad_row_updates,
        sparse_adagrad_apply_cuda,
    )

    gen = torch.Generator(device).manual_seed(31)
    max_err = 0.0
    lr, eps = 0.5, 1e-10

    def err(a, b):
        return (a - b).abs().max().item() if a.numel() else 0.0

    def checks(name, uids, n_real, table_rows, D):
        nonlocal max_err
        table, accum, grads, delta, g2 = _push_inputs(
            gen, uids, n_real, table_rows, D, device)
        want = ref.sparse_adagrad_apply_ref(table.clone(), accum.clone(),
                                            uids, delta, g2)
        runs = []
        for via_ops in (False, True):
            t, a = table.clone(), accum.clone()
            if via_ops:
                out = ops.sparse_adagrad_apply(t, a, uids, grads, lr=lr,
                                               eps=eps)
            else:
                out = sparse_adagrad_apply_cuda(t, a, uids, grads, lr=lr,
                                                eps=eps)
            torch.cuda.synchronize()
            if out[0] is not t or out[1] is not a:
                raise AssertionError(f"push {name}: not in place")
            runs.append((t, a))
        for t, a in runs:
            max_err = max(max_err, err(t, want[0]), err(a, want[1]))
            if not (torch.equal(t, want[0]) and torch.equal(a, want[1])):
                raise AssertionError(f"push {name}: kernel and plain "
                                     "version differ")
        touched = torch.zeros(table_rows, dtype=torch.bool, device=device)
        touched[uids.long()] = True
        if not torch.equal(runs[0][0][~touched], table[~touched]):
            raise AssertionError(f"push {name}: an untouched row changed")
        n_pads = int((uids[1:] <= uids[:-1]).sum())
        print(f"  {name}: bit-equal to the plain version (row math, then "
              f"index_add_), two runs (the wrapper, ops) bit-equal, "
              f"untouched rows unchanged ({n_real} real rows, {n_pads} "
              f"pads)")
        return table, accum, grads, delta, g2

    small_rows = PUSH_ROWS
    uids, n_real = _slice_uids(device, fit_rows=small_rows)
    print(f"phase 1: sparse_adagrad_apply (the row math in the kernel) "
          f"against its plain version (uids {uids.numel()}, table "
          f"{small_rows} x 64)")
    table, accum, grads, delta, g2 = checks("slice layout, D=64", uids,
                                            n_real, small_rows, 64)
    over, n_over = _slice_uids(device, capacity=16384, fit_rows=small_rows)
    checks("overflowed batch (capacity 16384), D=64", over, 16384,
           small_rows, 64)
    from repro_torch.core.embedding_backend import pull_working_set

    for D in (3, 16, 100):
        ids = torch.randint(0, 30000, (5000,), generator=gen, device=device,
                            dtype=torch.int32)
        u, _ = pull_working_set(ids, 8192)
        checks(f"random batch, D={D}", u, int(torch.unique(ids).numel()),
               30000, D)
    _one_launch(lambda: ops.sparse_adagrad_apply(table, accum, uids, grads,
                                                 lr=lr, eps=eps),
                "ops.sparse_adagrad_apply on CUDA tensors")

    # ---- times at the slice's layout, in place on the 4 M-row table
    idx = uids.long()

    def ref_push(t, a, u, g):
        """The plain version on the card: the row math, then index_add_."""
        d, s2 = adagrad_row_updates(a.index_select(0, u.long()), g, t.dtype,
                                    lr=lr, eps=eps)
        return ref.sparse_adagrad_apply_ref(t, a, u, d, s2)

    small = _call_times(
        lambda: sparse_adagrad_apply_cuda(table, accum, uids, grads, lr=lr,
                                          eps=eps),
        lambda: ref_push(table, accum, uids, grads))
    small["ops"] = _call_times(
        lambda: ops.sparse_adagrad_apply(table, accum, uids, grads, lr=lr,
                                         eps=eps))

    def library():
        table.index_add_(0, idx, delta)
        accum.index_add_(0, idx, g2)

    small["index_add_ms"] = _time_ms(library)
    D = table.shape[1]
    bound_ms, bound_by, nbytes = _push_bound(n_real, uids.numel(), D)
    print(f"  times at the slice layout on the {small_rows}-row table (ms, "
          f"L2 cold): kernel {small['ms']:.4f} (L2 warm "
          f"{small['ms_l2_warm']:.4f}; the device alone, graph, "
          f"{small['graph_ms']:.4f}; the host {small['host_us']:.1f} us a "
          f"call); ops-level push {small['ops']['ms']:.4f} (graph "
          f"{small['ops']['graph_ms']:.4f}, host "
          f"{small['ops']['host_us']:.1f} us); plain version (row math + "
          f"two index_add_) {small['plain_ms']:.4f}; the scatter alone (two "
          f"index_add_ of precomputed rows) {small['index_add_ms']:.4f}; no "
          f"single library call; bound {bound_ms:.4f} ({nbytes / 1e6:.2f} "
          f"MB: {n_real} real rows x 5 x {D * 4} B + the uid stream)")
    del table, accum, grads, delta, g2

    # ---- the slice batch on the 50 M-row table: its real uids, offsets
    # beyond int32
    big_uids, big_real = _slice_uids(device)
    n_high = int((big_uids.long() * 64 >= (1 << 31)).sum())
    big_t = torch.randn((ROWS, 64), generator=gen, device=device).mul_(0.05)
    big_a = torch.full((ROWS, 64), 0.01, device=device)
    grads = torch.randn((CAPACITY, 64), generator=gen, device=device)
    grads[big_real:] = 0.0
    uniq, pos = torch.unique(big_uids, return_inverse=True)
    want_t, want_a = ref.sparse_adagrad_ref(
        big_t[uniq.long()].clone(), big_a[uniq.long()].clone(),
        grads[torch.cat([torch.ones(1, dtype=torch.bool, device=device),
                         big_uids[1:] > big_uids[:-1]])], lr, eps)
    sample = torch.randint(0, ROWS, (1 << 16,), generator=gen, device=device)
    sample = sample[~torch.isin(sample, uniq)]
    before = big_t[sample].clone(), big_a[sample].clone()
    sparse_adagrad_apply_cuda(big_t, big_a, big_uids, grads, lr=lr, eps=eps)
    torch.cuda.synchronize()
    max_err = max(max_err, err(big_t[uniq.long()], want_t),
                  err(big_a[uniq.long()], want_a))
    if not (torch.equal(big_t[uniq.long()], want_t)
            and torch.equal(big_a[uniq.long()], want_a)):
        raise AssertionError("push on the 50 M-row table: rows differ from "
                             "the plain version")
    if not (torch.equal(big_t[sample], before[0])
            and torch.equal(big_a[sample], before[1])):
        raise AssertionError("push on the 50 M-row table: an untouched row "
                             "changed")
    print(f"  slice batch on the {ROWS}-row table: touched rows bit-equal "
          f"to the plain version ({n_high} uids with uid * 64 >= 2^31), "
          f"{sample.numel()} sampled untouched rows unchanged")
    big = _call_times(
        lambda: sparse_adagrad_apply_cuda(big_t, big_a, big_uids, grads,
                                          lr=lr, eps=eps),
        lambda: ref_push(big_t, big_a, big_uids, grads))
    big["ops"] = _call_times(
        lambda: ops.sparse_adagrad_apply(big_t, big_a, big_uids, grads,
                                         lr=lr, eps=eps))
    big["bound_ms"], _, big_bytes = _push_bound(big_real, CAPACITY, 64)
    print(f"  times on the {ROWS}-row table (ms, L2 cold): kernel "
          f"{big['ms']:.4f} (L2 warm {big['ms_l2_warm']:.4f}; graph "
          f"{big['graph_ms']:.4f}; host {big['host_us']:.1f} us); ops-level "
          f"push {big['ops']['ms']:.4f} (graph {big['ops']['graph_ms']:.4f}, "
          f"host {big['ops']['host_us']:.1f} us); plain version "
          f"{big['plain_ms']:.4f}; bound {big['bound_ms']:.4f} "
          f"({big_bytes / 1e6:.2f} MB, {big_real} real rows)")
    del big_t, big_a, grads
    torch.cuda.empty_cache()
    return {
        "name": "sparse_adagrad_apply",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sparse_adagrad.cu",
        "replaces": "src/repro/kernels/sparse_adagrad.py:127",
        "launches": None,
        "max_abs_err": max_err,
        "ms": small["ms"],
        "ms_l2_warm": small["ms_l2_warm"],
        "plain_ms": small["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "graph_ms": small["graph_ms"],
        "host_us": small["host_us"],
        "ops": small["ops"],
        "index_add_ms": small["index_add_ms"],
        "on_the_50m_row_table": big,
    }


def _full_width_trainer(device, n_pod=2, seed=0, placement="gather",
                        cache_rows=None, rows=ROWS, **store):
    """baidu-ctr at full width, 50 M rows (or ``rows``), with the
    launcher's defaults; ``store``: the TrainerConfig's store fields."""
    from repro_torch.configs import baidu_ctr
    from repro_torch.core.kstep import KStepConfig
    from repro_torch.core.sparse_optim import SparseAdagradConfig
    from repro_torch.runtime.factory import build_trainer
    from repro_torch.runtime.trainer import TrainerConfig

    mcfg = dataclasses.replace(baidu_ctr.MODEL, rows=rows)
    tcfg = TrainerConfig(
        n_pod=n_pod, kstep=KStepConfig(lr=1e-3, k=20, merge="two_phase"),
        sparse=SparseAdagradConfig(lr=0.5, initial_accumulator=0.01),
        placement=placement, capacity=CAPACITY, cache_rows=cache_rows,
        log_every=10, **store)
    return build_trainer("baidu-ctr", tcfg, smoke=False, model_cfg=mcfg,
                         seed=seed, device=device)


def _release():
    """Return the memory of dropped trainers to the card."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


TRAIN_STEPS = 40


def phase_train(device):
    """40 training steps at full width; returns the launch counts of the
    run and its per-step losses."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.runtime.online import fit_online

    t0 = time.perf_counter()
    tr = _full_width_trainer(device)
    torch.cuda.synchronize()
    print(f"phase 3: baidu-ctr training, rows {ROWS}, capacity "
          f"{tr.engine.capacity}, batch {BATCH}, n_pod {tr.n_pod}, k "
          f"{tr.cfg.kstep.k}, merge {tr.cfg.kstep.merge}; trainer built in "
          f"{time.perf_counter() - t0:.1f} s")
    batches = _train_batches(TRAIN_STEPS + 12)   # + 12 for the breakdown
    run, extra = batches[:TRAIN_STEPS], batches[TRAIN_STEPS:]
    seen = np.unique(np.concatenate([b["ids"].reshape(-1) for b in run]))
    rng = np.random.default_rng(0)
    sample = rng.integers(0, ROWS, 1 << 14)
    sample = torch.from_numpy(sample[~np.isin(sample, seen)]).to(device)
    before = [t[sample].clone() for t in (tr.tables["sparse"],
                                          tr.sparse_state.accum["sparse"])]
    # every step's loss, kept on the device until the run ends
    step_losses = []
    train_step = tr.train_step

    def recorded(b):
        loss = train_step(b)
        step_losses.append(loss)
        return loss

    tr.train_step = recorded
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist, online_auc = fit_online(tr, iter(run), TRAIN_STEPS, window=20)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del tr.train_step

    losses = [r["loss"] for r in hist]
    every = torch.stack(step_losses).cpu().numpy()
    if [r["step"] for r in hist] != [10, 20, 30, 40]:
        raise AssertionError(f"history steps {[r['step'] for r in hist]}")
    if every.shape != (TRAIN_STEPS,) or not np.isfinite(every).all():
        raise AssertionError(f"a loss is not finite: {every}")
    if not np.array_equal(every[9::10], np.float32(losses)):
        raise AssertionError("history losses are not the steps' losses")
    if tr.overflow_dropped != 0:
        raise AssertionError(f"overflow_dropped {tr.overflow_dropped}")
    n = TRAIN_STEPS
    want = dict.fromkeys(ops.launches, 0)
    want.update({"embedding_bag": n * (1 + tr.n_pod),
                 "embedding_bag_backward": n * tr.n_pod,
                 "sparse_adagrad_apply": n,
                 "fused_adam": n - n // tr.cfg.kstep.k})   # local steps
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    after = [t[sample] for t in (tr.tables["sparse"],
                                 tr.sparse_state.accum["sparse"])]
    if not all(torch.equal(a, b) for a, b in zip(before, after)):
        raise AssertionError("a row outside every batch changed")
    print(f"  losses at steps 10/20/30/40: "
          f"{', '.join(f'{x:.6f}' for x in losses)} (all {TRAIN_STEPS} "
          f"finite, {every.min():.4f} to {every.max():.4f}); online AUC "
          f"{online_auc:.4f}; overflow_dropped 0; {sample.numel()} rows "
          f"outside every batch unchanged")
    print(f"  predict + train per step (fit_online wall / {n}): "
          f"{wall / n * 1e3:.2f} ms ({n / wall:.2f} steps/s); peak device "
          f"memory {peak_gb:.2f} GB")
    print(f"  launches during the run: {launches}")
    _train_breakdown(tr, extra)
    del tr
    _release()
    return launches, every


def _train_breakdown(tr, batches, names=(
        "pull (stage + dedup + gather)", "forward (bags + tower)",
        "backward (bag kernel + autograd)", "k-step Adam", "push")):
    """Device time of one training step by its five parts, ``names``
    (CUDA events between the parts of ``train_step``), and the train step's
    wall time; outside the counted run."""
    import torch

    sums = dict.fromkeys(names, 0.0)
    steps = batches[:6]
    for b in steps:
        tr.step_num += 1
        merge = tr.step_num % tr.cfg.kstep.k == 0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        staged = tr._stage(b)
        wss, tables, accum, bstate = tr.engine.pull_batch(
            tr.tables, tr.sparse_state.accum, tr.backend_state, staged)
        ev[1].record()
        dense, workings, losses = tr._forward(wss, tr.pod_batch(staged))
        ev[2].record()
        dense_g, work_g = tr._backward(dense, workings, losses)
        ev[3].record()
        _adam_step_no_sync(tr, dense_g, merge)
        ev[4].record()
        tr.engine.push(tables, accum, bstate, wss, work_g)
        ev[5].record()
        torch.cuda.synchronize()
        for i, k in enumerate(names):
            sums[k] += ev[i].elapsed_time(ev[i + 1])
    parts = {k: v / len(steps) for k, v in sums.items()}
    _adam_transfers(tr, dense_g)
    walls = []
    for b in batches[6:9]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_step(b)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print("  one train step, stream time by part (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items())
        + f"; sum {sum(parts.values()):.3f}")
    print(f"  train_step wall (synchronized, {len(walls)} steps): mean "
          f"{np.mean(walls) * 1e3:.2f} ms, min {np.min(walls) * 1e3:.2f} ms")
    _busy_share(tr, batches[9:12])


def _adam_step_no_sync(tr, dense_g, merge):
    """``tr.opt.step``; a local step runs under the sync debug mode
    "error", which raises on any synchronizing call."""
    import torch

    if merge:
        tr.opt.step(tr.dense, dense_g, tr.opt_state, merge=True)
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        tr.opt.step(tr.dense, dense_g, tr.opt_state, merge=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _transfers(fn):
    """``fn()`` under the profiler: its host-to-device copies, synchronizing
    calls and CUDA kernel launches, beyond what the profiler itself
    records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def traced(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
        torch.cuda.synchronize()
        ev = prof.key_averages()
        count = lambda pred: sum(e.count for e in ev if pred(e.key))
        return (count(lambda k: "HtoD" in k),
                count(lambda k: "Synchronize" in k or k == "cudaMemcpy"),
                count(lambda k: k in ("cudaLaunchKernel", "cuLaunchKernel",
                                      "cudaLaunchKernelExC")))

    base = traced(lambda: None)
    return tuple(a - b for a, b in zip(traced(fn), base))


def _graph_kernels(fn, names):
    """For each name in ``names``, the kernel nodes of that name in a CUDA
    graph captured around ``fn()`` (never replayed): the kernels ``fn``
    launches, as ``cudaGraphDebugDotPrint`` names them.  The profiler's
    trace is not used for this: on the card it drops the device events of
    short calls at random."""
    import torch

    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        fn()
    path = ROOT / "build" / "captured_graph.dot"
    path.parent.mkdir(parents=True, exist_ok=True)
    graph.debug_dump(str(path))
    dot = path.read_text()
    path.unlink()
    del graph
    return [dot.count(name) for name in names]


def _adam_transfers(tr, dense_g):
    """One more local k-step Adam step under the profiler: its CUDA kernels,
    host-to-device copies and synchronizing calls (none is allowed)."""
    h2d, syncs, kernels = _transfers(
        lambda: tr.opt.step(tr.dense, dense_g, tr.opt_state, merge=False))
    if h2d or syncs:
        raise AssertionError(f"a local k-step Adam step made {h2d} "
                             f"host-to-device copies and {syncs} syncs")
    print(f"  a local k-step Adam step (profiler): {kernels} kernel "
          f"launches, 0 host-to-device copies, 0 synchronizing calls; the "
          f"timed local steps ran under the sync debug mode 'error'")


def _busy_share(tr, batches):
    """The device's busy share over a few train steps: the kernels' device
    time in a ``torch.profiler`` trace over the steps' wall time, and the
    kernels that took most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            tr.train_step(b)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        print("  device busy share: not measured (the trace holds no device "
              "time)")
        return
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    print(f"  device busy share over {len(batches)} train steps (profiler): "
          f"{busy_us / wall_us:.3f} ({busy_us / len(batches) / 1e3:.3f} ms "
          f"of device time per step of {wall_us / len(batches) / 1e3:.3f} ms "
          f"wall, profiler on); top kernels (ms per step): " + "; ".join(
              f"{e.key[:48]} {e.self_device_time_total / len(batches) / 1e3:.3f}"
              for e in top))


def phase_colocated(device):
    """10 full-width steps twice from one seed, the second with a server
    draining between steps: the same bits."""
    import torch

    from repro_torch.core.kstep import leaves
    from repro_torch.runtime.factory import build_ctr_server

    batches = _train_batches(10)
    requests = _train_batches(10, seed=2, batch=256)
    results = []
    for serve in (False, True):
        tr = _full_width_trainer(device)
        srv = build_ctr_server(tr, max_batch=256) if serve else None
        losses = []
        for b, r in zip(batches, requests):
            if srv is not None:
                srv.submit_batch(r)
            losses.append(tr.train_step(b))
            if srv is not None and srv.drain() != 256:
                raise AssertionError("the server did not drain its batch")
        losses = torch.stack(losses).cpu()
        dense = torch.cat([x.reshape(-1) for x in leaves(tr.dense)]).cpu()
        results.append((losses, _checksum(tr), dense))
        served = 0 if srv is None else int(srv.summary()["served"])
        del tr, srv
        _release()
    (la, ca, da), (lb, cb, db) = results
    if not torch.equal(la, lb):
        raise AssertionError(f"losses differ with the server: {la} vs {lb}")
    if ca != cb or not torch.equal(da, db):
        raise AssertionError("final state differs with the server")
    print(f"phase 4: 10 full-width steps without and with a co-located "
          f"server ({served} requests served): per-step losses, table and "
          f"accumulator checksums and dense parameters bit-equal; losses "
          f"{la[0]:.6f} ... {la[-1]:.6f}")


def phase_quickstart(device):
    """``examples/quickstart.py``'s configuration through the port."""
    from repro_torch.core.kstep import KStepConfig
    from repro_torch.core.sparse_optim import SparseAdagradConfig
    from repro_torch.data.synthetic import ctr_batches
    from repro_torch.models.recsys import CTRConfig
    from repro_torch.runtime.factory import build_trainer
    from repro_torch.runtime.online import fit_online
    from repro_torch.runtime.trainer import TrainerConfig

    cfg = CTRConfig(rows=20_000, n_fields=8, nnz_per_instance=20,
                    mlp=(64, 1), attn_heads=2)
    tr = build_trainer(
        "baidu-ctr",
        TrainerConfig(
            n_pod=4, kstep=KStepConfig(lr=1e-3, k=10, b1=0.0, merge="flat"),
            sparse=SparseAdagradConfig(lr=0.5, initial_accumulator=0.01),
            placement="gather", capacity=16384),
        model_cfg=cfg, device=device)
    gen = ctr_batches(seed=1, batch=512, rows=cfg.rows,
                      n_fields=cfg.n_fields, nnz=cfg.nnz_per_instance)
    t0 = time.perf_counter()
    _, online_auc = fit_online(tr, gen, 150, window=20)
    wall = time.perf_counter() - t0
    print(f"phase 5: quickstart configuration (4 pods, k 10, 150 steps): "
          f"online AUC {online_auc:.4f} (bar 0.72), {150 / wall:.1f} "
          f"steps/s")
    if not online_auc > 0.72:
        raise AssertionError(f"quickstart AUC {online_auc} <= 0.72")


def phase_agreement_train(device):
    """6 training steps at smoke size on the card and on the CPU from one
    state."""
    import torch

    from repro_torch import tree_map
    from repro_torch.configs import baidu_ctr
    from repro_torch.core.kstep import KStepAdamState, KStepConfig, leaves
    from repro_torch.data.synthetic import recsys_batches
    from repro_torch.interop import ReferenceState
    from repro_torch.models import recsys as R
    from repro_torch.runtime.factory import build_ctr_engine, build_trainer
    from repro_torch.runtime.online import fit_online
    from repro_torch.runtime.trainer import HybridTrainer, TrainerConfig

    smoke = baidu_ctr.SMOKE
    tcfg = TrainerConfig(n_pod=2, kstep=KStepConfig(k=2), capacity=256,
                         log_every=1)
    gpu = build_trainer("baidu-ctr", tcfg, seed=3, device=device)
    cpu_of = lambda x: x.cpu().clone()    # the trainers update in place
    s = gpu.opt_state
    state = ReferenceState(
        dense=tree_map(cpu_of, gpu.dense),
        tables={n: cpu_of(t) for n, t in gpu.tables.items()},
        accum={n: cpu_of(a) for n, a in gpu.sparse_state.accum.items()},
        opt_state=KStepAdamState(cpu_of(s.step), tree_map(cpu_of, s.m),
                                 tree_map(cpu_of, s.v_local),
                                 tree_map(cpu_of, s.v_hat), None))
    cpu = HybridTrainer(None, build_ctr_engine(smoke, tcfg, device="cpu"),
                        R.ctr_embed_from_workings(smoke),
                        R.ctr_hybrid_loss(smoke), tcfg, state=state,
                        device="cpu")
    out = []
    for tr in (gpu, cpu):
        hist, _ = fit_online(tr, recsys_batches(smoke, batch=32, seed=5), 6,
                             window=5)
        out.append(([r["loss"] for r in hist],
                    torch.cat([x.reshape(-1).cpu()
                               for x in leaves(tr.dense)]).numpy(),
                    tr.tables["sparse"].cpu().numpy()))
    tol = dict(rtol=1e-4, atol=1e-6)
    for what, a, b in zip(("losses", "dense", "table"), *out):
        np.testing.assert_allclose(a, b, err_msg=what, **tol)
    print(f"phase 6: 6 smoke-size training steps, card vs CPU from one "
          f"state: losses max |diff| "
          f"{np.abs(np.subtract(out[0][0], out[1][0])).max():.3g}, dense "
          f"max |diff| {np.abs(out[0][1] - out[1][1]).max():.3g}, table max "
          f"|diff| {np.abs(out[0][2] - out[1][2]).max():.3g}")


# ---------------------------------------------------------------- the cache
CACHE_ROWS = 262144        # 4 x the capacity, 0.5 % of the 50 M rows
SERVE_BATCH = 256          # requests the co-located server scores per step


def _bound(nbytes, flops=0, flop_per_s=F32_FLOP_PER_S):
    """(ms, what bounds it) for the card's peaks (``flop_per_s``: the peak
    of the operands' type; float32 without tensor cores by default)."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def _state_sums(state):
    """Integer sums of the bits of every field of a cache state (on the
    card: one small reduction per field)."""
    import torch

    out = []
    for t in state:
        x = t.reshape(-1)
        if x.dtype in (torch.float32, torch.int32):
            x = x.view(torch.int32)
        out.append(int(x.to(torch.int64).sum()))
    return out


def phase_cached(device, gather_losses):
    """The cached placement at full width: 40 ``fit_online`` steps with a
    co-located server draining between steps.  Returns the launch counts
    of the run and the three cache kernels' kernels-line entries."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.runtime.factory import build_ctr_server
    from repro_torch.runtime.online import fit_online

    t0 = time.perf_counter()
    tr = _full_width_trainer(device, placement="cached",
                             cache_rows=CACHE_ROWS)
    torch.cuda.synchronize()
    st = tr.backend_state["sparse"]
    table, accum = tr.tables["sparse"], tr.sparse_state.accum["sparse"]
    if (table.device.type != "cpu" or accum.device.type != "cpu"
            or st.rows.device.type != tr.device.type):
        raise AssertionError("the cold tier must be in host memory and the "
                             "cache on the card")
    host_gb = (table.numel() + accum.numel()) * 4 / 1e9
    cache_gb = sum(t.numel() * t.element_size() for t in st) / 1e9
    print(f"phase 7: baidu-ctr training on the cached placement, rows {ROWS}"
          f", capacity {CAPACITY}, cache_rows {CACHE_ROWS} (H = "
          f"{tr.engine.backend.hash_buckets}), batch {BATCH}, n_pod "
          f"{tr.n_pod}, serving {SERVE_BATCH} requests between steps; "
          f"trainer built in {time.perf_counter() - t0:.1f} s; table + "
          f"accumulator {host_gb:.1f} GB in host memory, cache state "
          f"{cache_gb:.3f} GB on the card")
    batches = _train_batches(TRAIN_STEPS + 15)
    run, extra = batches[:TRAIN_STEPS], batches[TRAIN_STEPS:]
    requests = iter(_train_batches(TRAIN_STEPS + 1, seed=2,
                                   batch=SERVE_BATCH))
    server = build_ctr_server(tr, max_batch=SERVE_BATCH)
    step_losses, serving_wrote = [], []
    train_step = tr.train_step

    def step_and_serve(b):
        loss = train_step(b)
        step_losses.append(loss)
        server.submit_batch(next(requests))
        before = _state_sums(tr.backend_state["sparse"])
        if server.drain() != SERVE_BATCH:
            raise AssertionError("the server did not drain its batch")
        serving_wrote.append(before != _state_sums(tr.backend_state["sparse"]))
        return loss

    tr.train_step = step_and_serve
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist, online_auc = fit_online(tr, iter(run), TRAIN_STEPS, window=20)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del tr.train_step

    every = torch.stack(step_losses).cpu().numpy()
    if every.shape != (TRAIN_STEPS,) or not np.isfinite(every).all():
        raise AssertionError(f"a loss is not finite: {every}")
    if tr.overflow_dropped != 0:
        raise AssertionError(f"overflow_dropped {tr.overflow_dropped}")
    if any(serving_wrote):
        raise AssertionError("serving changed the cache state")
    n = TRAIN_STEPS
    # per step: the predict and the server's predict (a lookup each: probe
    # + cached gather, one bag), the pull (probe + cached gather) and the
    # push (probe + cached push, which reads the accumulator rows itself)
    want = dict.fromkeys(launches, 0)
    want.update({"hash_lookup": 4 * n, "gather_rows_cached": 3 * n,
                 "sparse_adagrad_cached_apply": n,
                 "embedding_bag": n * (2 + tr.n_pod),
                 "embedding_bag_backward": n * tr.n_pod,
                 "fused_adam": n - n // tr.cfg.kstep.k})
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    stats = tr.sparse_metrics()
    counters = tr.engine.cache_counters(tr.backend_state)
    serve = server.summary()
    if not (stats["evictions_total"] > 0
            and stats["cache_bytes_d2h_total"] > 0):
        raise AssertionError(f"no evictions or no spills: {stats}")
    same = bool(np.array_equal(every, gather_losses))
    if not same:
        raise AssertionError(
            f"cached losses differ from the gather placement's (phase 3): "
            f"max |diff| {np.abs(every - gather_losses).max()}")
    sums = _checksum(tr), _state_sums(tr.backend_state["sparse"])
    server.submit_batch(next(requests))
    server.drain()
    if (_checksum(tr), _state_sums(tr.backend_state["sparse"])) != sums:
        raise AssertionError("serving changed the host table or the cache")
    losses = [r["loss"] for r in hist]
    print(f"  losses at steps 10/20/30/40: "
          f"{', '.join(f'{x:.6f}' for x in losses)}; all {n} per-step losses "
          f"bit-equal to the gather placement's (phase 3); online AUC "
          f"{online_auc:.4f}; overflow_dropped 0")
    print(f"  cache: hit rate {stats['cache_hit_rate_total']:.4f} (steps "
          f"31-40 {hist[-1]['cache_hit_rate']:.4f}), evictions "
          f"{stats['evictions_total']}, rebuilds {counters['rebuilds']:.0f}, "
          f"host->device {counters['bytes_h2d'] / 1e6:.1f} MB, "
          f"device->host {counters['bytes_d2h'] / 1e6:.1f} MB, lookups "
          f"{counters['lookups']:.0f}, rows fetched "
          f"{counters['fetched']:.0f}")
    print(f"  serving: {int(serve['served'])} requests, serve_hit_rate "
          f"{serve['serve_hit_rate']:.4f}, qps {serve['qps']:.1f}; the cache "
          f"state unchanged by every drain, and the host table and "
          f"accumulator checksums unchanged by a drain")
    print(f"  predict + train + serve per step (fit_online wall / {n}): "
          f"{wall / n * 1e3:.2f} ms ({n / wall:.2f} steps/s); peak device "
          f"memory {peak_gb:.2f} GB")
    print(f"  launches during the run: {launches}")
    _train_breakdown(tr, extra[:12])
    _pull_profile(tr, extra[12:14])
    entries = phase_cache_kernels(tr, extra[14])
    rebuilds = tr.engine.cache_counters(tr.backend_state)["rebuilds"]
    del tr, server
    _release()
    return launches, entries, rebuilds


def _pull_profile(tr, batches):
    """Where a cached pull's time goes: the host time of its operators
    (``torch.profiler``, self CPU time, the largest first) over a few pulls
    on the trained cache, and the pull's synchronized wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    eng = tr.engine
    staged = [tr._stage(b) for b in batches]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in staged:
            _, _, _, bs = eng.pull_batch(tr.tables, tr.sparse_state.accum,
                                         tr.backend_state, b)
            tr.backend_state = bs
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / len(staged)
    ops_ = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    n = len(staged)
    print(f"  one cached pull: {wall_ms:.2f} ms wall (profiler on); host "
          f"time by operator (ms per pull): " + "; ".join(
              f"{e.key} {e.self_cpu_time_total / n / 1e3:.3f} "
              f"(x{e.count // n})" for e in ops_[:8]))


def _probe_reads(key_tab, uids):
    """(key_tab reads, ids found) of the linear probe for ``uids``: the
    bytes the probe must read depend on the chains this map holds."""
    from repro_torch.kernels.hash_map import EMPTY, hash_bucket

    H = key_tab.numel()
    b = hash_bucket(uids, H).long()
    u = uids
    reads = found = 0
    while u.numel():
        kb = key_tab[b]
        reads += u.numel()
        hit = kb == u
        found += int(hit.sum())
        more = ~hit & (kb != EMPTY)
        u, b = u[more], (b[more] + 1) & (H - 1)
    return reads, found


def _small_map(gen, C, n_ids, id_hi, H, device):
    """A map over C slots after two rounds of admissions (stale entries from
    the second), built by the port's map maintenance on the card; probe
    ids that hit, miss and hit stale entries."""
    import torch

    from repro_torch.kernels import hash_map as hm

    key_tab = torch.full((H,), hm.EMPTY, dtype=torch.int32, device=device)
    slot_tab = torch.zeros((H,), dtype=torch.int32, device=device)
    n_occ = torch.zeros((), dtype=torch.int32, device=device)
    slot_uid = torch.full((C,), -1, dtype=torch.int32, device=device)
    ids = torch.unique(torch.randint(0, id_hi, (2 * n_ids,), generator=gen,
                                     device=device))
    ids = ids[torch.randperm(ids.numel(), generator=gen,
                             device=device)][:n_ids]
    ids = (id_hi - 1 - ids).to(torch.int32)       # the top of the range
    first, second = ids[:C], ids[C:C + C // 2]
    for batch, slots in ((first, torch.arange(C, device=device)),
                         (second, torch.randperm(C, generator=gen,
                                                 device=device)[:C // 2])):
        slots = slots.to(torch.int32)
        slot_uid[slots.long()] = batch
        key_tab, slot_tab, n_occ = hm.hash_insert(
            key_tab, slot_tab, n_occ, batch, slots,
            torch.ones(batch.shape, dtype=torch.bool, device=device))
    probe = ids[torch.randint(0, n_ids, (2 * n_ids,), generator=gen,
                              device=device)]
    return key_tab, slot_tab, slot_uid, probe.contiguous()


def phase_cache_kernels(tr, batch):
    """The probe, the cached gather and the cached push against their plain
    versions, at the inputs of a real cached pull of the next batch on the
    trained full-width cache (outside the counted run); returns their
    kernels-line entries."""
    import torch

    from repro_torch.core.embedding_backend import (
        _dedup,
        _with_drop_row,
        pull_working_set,
    )
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.hash_map import hash_bucket, hash_lookup_cuda
    from repro_torch.kernels.sparse_adagrad import (
        adagrad_row_updates,
        gather_rows_cached_cuda,
        sparse_adagrad_cached_apply_cuda,
    )

    device = tr.device
    cb = tr.engine.backend
    st = tr.backend_state["sparse"]
    table, accum = tr.tables["sparse"], tr.sparse_state.accum["sparse"]
    ids = tr.engine.ids_from_batch(tr._stage(batch))["sparse"]
    gen = torch.Generator(device).manual_seed(41)
    errs = {"probe": 0.0, "gather": 0.0, "push": 0.0}

    # ---- the probe, on the map as the pull finds it (hits and misses)
    def probe_checks(name, key_tab, slot_tab, slot_uid, uids):
        args = (key_tab, slot_tab, slot_uid, uids)
        got, again = hash_lookup_cuda(*args), hash_lookup_cuda(*args)
        cpu = ref.hash_lookup_ref(*[a.cpu() for a in args])
        torch.cuda.synchronize()
        if not (torch.equal(got, again) and torch.equal(got.cpu(), cpu)
                and torch.equal(got, ref.hash_lookup_ref(*args))):
            raise AssertionError(f"probe {name}: kernel and plain version "
                                 "differ")
        print(f"  probe, {name}: bit-equal to the plain version (card and "
              f"CPU), two runs bit-equal; {int((got >= 0).sum())} hits, "
              f"{int((got < 0).sum())} misses")

    uids, _, _ = _dedup(ids, CAPACITY)
    pargs = (st.key_tab, st.slot_tab, st.slot_uid, uids)
    print(f"phase 1 (on phase 7's cache): hash_lookup against its plain "
          f"version (uids {uids.numel()}, H {st.key_tab.numel()}, C "
          f"{st.slot_uid.numel()}, occupied buckets {int(st.n_occupied)})")
    probe_checks("slice batch on the trained cache", *pargs)
    for C, n_ids, id_hi, H in ((32, 60, 1 << 20, 64),
                               (4096, 7000, 2**31 - 1, 1 << 14)):
        probe_checks(f"C={C} H={H}, ids below {id_hi}",
                     *_small_map(gen, C, n_ids, id_hi, H, device))
    reads, found = _probe_reads(st.key_tab, uids)
    n = uids.numel()
    nbytes = n * 4 + reads * 4 + found * 8 + n * 4

    def probe():
        return hash_lookup_cuda(*pargs)

    p_ms, p_warm = _time_ms(probe), _time_ms(probe, cold_l2=False)
    p_graph, p_host = _graph_ms(probe), _host_us(probe)
    p_graph_warm = _graph_ms(probe, cold_l2=False)
    p_plain = _time_ms(lambda: ref.hash_lookup_ref(*pargs), iters=5,
                       warmup=1)
    p_bound, p_by = _bound(nbytes)
    # the dependent-load floor: the plain chain id -> key_tab -> slot_tab
    # -> slot_uid -> the store is four trips to HBM from a cold L2
    trip_us, empty_ms = _hbm_trip()
    floor_ms = 4 * trip_us / 1e3
    # the loads without their chain: each id's home group of keys and of
    # slots and each hit's slot_uid word, read at once from a fresh table
    # of the map's size
    H, C = st.key_tab.numel(), st.slot_uid.numel()
    home = hash_bucket(uids, H).long() & ~3
    hits = ref.hash_lookup_ref(*pargs)
    idx = torch.cat([home, H + home, 2 * H + hits[hits >= 0].long()])
    reads_ms = _random_reads_ms(2 * H + C, idx)
    print(f"  times (ms, L2 cold): kernel {p_ms:.4f} (L2 warm "
          f"{p_warm:.4f}), plain version {p_plain:.4f}, "
          f"no library call; bound {p_bound:.4f} ({nbytes / 1e6:.2f} MB: "
          f"{reads} bucket reads, {found} found, {reads / n:.2f} per id)")
    print(f"  the device's time alone (CUDA graph replays, L2 cold): "
          f"{p_graph:.4f} ms (L2 warm {p_graph_warm:.4f}); the host's time "
          f"per call: {p_host:.1f} us; latency floor (4 dependent trips to "
          f"HBM at {trip_us:.3f} us, tools/pointer_chase.cu) "
          f"{floor_ms:.4f} ms; an empty kernel's launch on the device alone "
          f"{empty_ms:.4f} ms; the same loads without their chain "
          f"({idx.numel()} words: each id's home group of keys and of "
          f"slots, each hit's slot_uid) {reads_ms:.4f} ms")
    # four times the batch: a first batch of 4096 instances (another seed),
    # deduplicated at four times the capacity
    big_ids = tr.engine.ids_from_batch(tr._stage(
        _train_batches(1, seed=3, batch=4 * BATCH)[0]))["sparse"]
    big_uids, _, _ = _dedup(big_ids, 4 * CAPACITY)
    probe_checks("four times the batch on the trained cache", st.key_tab,
                 st.slot_tab, st.slot_uid, big_uids)
    bargs = (st.key_tab, st.slot_tab, st.slot_uid, big_uids)
    p_scaled = {"ids": big_uids.numel(),
                "ms": _time_ms(lambda: hash_lookup_cuda(*bargs)),
                "graph_ms": _graph_ms(lambda: hash_lookup_cuda(*bargs))}
    print(f"  at four times the batch ({p_scaled['ids']} uids): kernel "
          f"{p_scaled['ms']:.4f} ms, the device alone "
          f"{p_scaled['graph_ms']:.4f}")

    # ---- the pull admits the misses; its slots feed the gather and push
    ws, table, accum, st = cb.pull(table, accum, st, ids, CAPACITY)
    tr.backend_state["sparse"] = st
    slots = hash_lookup_cuda(st.key_tab, st.slot_tab, st.slot_uid, ws.uids)
    if bool((slots < 0).any()):
        raise AssertionError("a pulled id is not live in the map")
    n_real = 1 + int((ws.uids[1:] > ws.uids[:-1]).sum())

    def gather_checks(name, rows, sl):
        got, again = gather_rows_cached_cuda(rows, sl), \
            gather_rows_cached_cuda(rows, sl)
        drop = gather_rows_cached_cuda(rows, sl, drop_row=True)
        via_ops = ops.gather_rows_cached(rows, sl, drop_row=True)
        torch.cuda.synchronize()
        want = ref.gather_rows_cached_ref(rows, sl)
        if not (torch.equal(got, again) and torch.equal(got, want)
                and torch.equal(got.cpu(), ref.gather_rows_cached_ref(
                    rows.cpu(), sl.cpu()))):
            raise AssertionError(f"cached gather {name}: kernel and plain "
                                 "version differ")
        if not (torch.equal(drop, _with_drop_row(want))
                and torch.equal(drop, via_ops) and torch.equal(
                    drop.cpu(), ref.gather_rows_cached_ref(
                        rows.cpu(), sl.cpu(), drop_row=True))):
            raise AssertionError(f"cached gather {name}: the drop-row "
                                 "gather differs from index_select + cat")
        print(f"  cached gather, {name}: bit-equal to the plain version "
              f"(card and CPU), two runs bit-equal; with its drop row "
              f"bit-equal to index_select + cat")

    print(f"phase 1 (on phase 7's cache): gather_rows_cached against its "
          f"plain version (slots {slots.numel()} of a real pull, {n_real} "
          f"real ids, cache {tuple(st.rows.shape)})")
    gather_checks("slice pull, D=64", st.rows, slots)
    for C, D, cap in ((777, 16, 3001), (513, 100, 1200), (50, 3, 77)):
        gather_checks(f"C={C} D={D} cap={cap}",
                      torch.randn((C, D), generator=gen, device=device),
                      torch.randint(0, C, (cap,), generator=gen,
                                    device=device, dtype=torch.int32))
    _one_launch(lambda: ops.gather_rows_cached(st.rows, slots, drop_row=True),
                "ops.gather_rows_cached(drop_row=True) on CUDA tensors")
    D = st.rows.shape[1]

    def gather_drop():
        return gather_rows_cached_cuda(st.rows, slots, drop_row=True)

    sl64 = slots.long()
    g = _call_times(gather_drop,
                    lambda: ref.gather_rows_cached_ref(st.rows, slots, True))
    g["without_drop_row"] = _call_times(
        lambda: gather_rows_cached_cuda(st.rows, slots))
    g["index_select_ms"] = _time_ms(
        lambda: torch.index_select(st.rows, 0, sl64))
    g["index_select_cat_ms"] = _time_ms(
        lambda: _with_drop_row(torch.index_select(st.rows, 0, sl64)))
    g["index_select_cat_graph_ms"] = _graph_ms(
        lambda: _with_drop_row(torch.index_select(st.rows, 0, sl64)))
    g["empty_launch_graph_ms"] = empty_ms
    distinct = torch.unique(slots).numel()
    nbytes = distinct * D * 4 + slots.numel() * 4 + (slots.numel() + 1) * D * 4
    g_bound, g_by = _bound(nbytes)
    print(f"  times with the drop row (ms, L2 cold): kernel {g['ms']:.4f} "
          f"(L2 warm {g['ms_l2_warm']:.4f}; the device alone, graph, "
          f"{g['graph_ms']:.4f}; the host {g['host_us']:.1f} us a call), "
          f"plain version (index_select + cat) {g['plain_ms']:.4f}; "
          f"without the drop row {g['without_drop_row']['ms']:.4f} (graph "
          f"{g['without_drop_row']['graph_ms']:.4f}); index_select "
          f"{g['index_select_ms']:.4f}, index_select + cat "
          f"{g['index_select_cat_ms']:.4f} (graph "
          f"{g['index_select_cat_graph_ms']:.4f}); an empty kernel's launch "
          f"on the device alone {empty_ms:.4f}; bound {g_bound:.4f} "
          f"({nbytes / 1e6:.2f} MB: {distinct} distinct rows read, "
          f"{slots.numel() + 1} written)")

    # ---- the cached push (the row math in it), on copies of the cache
    def push_inputs(rows_like, u, sl, real):
        grads = torch.randn((u.numel(), rows_like.shape[1]), generator=gen,
                            device=device)
        grads[real:] = 0.0                 # no id slot maps to a pad
        acc = torch.rand(rows_like.shape, generator=gen, device=device) + 0.01
        delta, g2 = adagrad_row_updates(acc[sl.long()], grads, torch.float32,
                                        lr=0.5, eps=1e-10)
        return acc, grads, delta, g2

    def push_checks(name, rows, acc, sl, u, grads, delta, g2):
        want = ref.sparse_adagrad_apply_ref(rows.clone(), acc.clone(), sl,
                                            delta, g2)
        runs = []
        for via_ops in (False, True):
            r, a = rows.clone(), acc.clone()
            if via_ops:
                out = ops.sparse_adagrad_cached_apply(
                    r, a, sl, grads, lr=0.5, eps=1e-10, uids=u)
            else:
                out = sparse_adagrad_cached_apply_cuda(r, a, sl, u, grads,
                                                       lr=0.5, eps=1e-10)
            torch.cuda.synchronize()
            if out[0] is not r or out[1] is not a:
                raise AssertionError(f"cached push {name}: not in place")
            runs.append((r, a))
        for r, a in runs:
            errs["push"] = max(errs["push"], (r - want[0]).abs().max().item())
            if not (torch.equal(r, want[0]) and torch.equal(a, want[1])):
                raise AssertionError(f"cached push {name}: kernel and plain "
                                     "version differ")
        touched = torch.zeros(rows.shape[0], dtype=torch.bool, device=device)
        touched[sl.long()] = True
        if not (torch.equal(runs[0][0][~touched], rows[~touched])
                and torch.equal(runs[0][1][~touched], acc[~touched])):
            raise AssertionError(f"cached push {name}: an untouched slot "
                                 "changed")
        pads = int((u[1:] <= u[:-1]).sum())
        print(f"  cached push, {name}: bit-equal to the plain version (row "
              f"math, then index_add_), two runs (the wrapper, ops) "
              f"bit-equal, untouched slots unchanged ({pads} pads)")

    print("phase 1 (on phase 7's cache): sparse_adagrad_cached_apply (the "
          "row math in the kernel) against its plain version")
    acc, grads, delta, g2 = push_inputs(st.rows, ws.uids, slots, n_real)
    push_checks("slice pull, D=64", st.rows, acc, slots, ws.uids, grads,
                delta, g2)
    over, _ = pull_working_set(ids, 16384)
    over_sl = hash_lookup_cuda(st.key_tab, st.slot_tab, st.slot_uid, over)
    oa, og, od, og2 = push_inputs(st.rows, over, over_sl, over.numel())
    push_checks("overflowed batch (capacity 16384, no pads), D=64", st.rows,
                oa, over_sl, over, og, od, og2)
    for C, Dx, n_ids, cap in ((3000, 16, 2500, 2048), (1500, 100, 2000, 1024),
                              (900, 3, 700, 512)):
        rid = torch.randint(0, 40_000, (n_ids,), generator=gen,
                            device=device, dtype=torch.int32)
        u, _ = pull_working_set(rid, cap)
        real = min(int(torch.unique(rid).numel()), cap)
        perm = torch.randperm(C, generator=gen, device=device)[:real]
        sl = torch.cat([perm, perm[:1].expand(cap - real)]).to(torch.int32)
        rows = torch.randn((C, Dx), generator=gen, device=device)
        a2, g2s, d2, s2 = push_inputs(rows, u, sl, real)
        push_checks(f"C={C} D={Dx} ({real} real ids)", rows, a2, sl, u, g2s,
                    d2, s2)
    r, a = st.rows.clone(), acc.clone()
    _one_launch(lambda: ops.sparse_adagrad_cached_apply(
        r, a, slots, grads, lr=0.5, eps=1e-10, uids=ws.uids),
        "ops.sparse_adagrad_cached_apply on CUDA tensors")

    def ref_cached_push():
        d, s2 = adagrad_row_updates(a.index_select(0, sl64), grads,
                                    torch.float32, lr=0.5, eps=1e-10)
        return ref.sparse_adagrad_apply_ref(r, a, slots, d, s2)

    c = _call_times(lambda: sparse_adagrad_cached_apply_cuda(
        r, a, slots, ws.uids, grads, lr=0.5, eps=1e-10), ref_cached_push)
    c["ops"] = _call_times(lambda: ops.sparse_adagrad_cached_apply(
        r, a, slots, grads, lr=0.5, eps=1e-10, uids=ws.uids))

    def library():
        r.index_add_(0, sl64, delta)
        a.index_add_(0, sl64, g2)

    c["index_add_ms"] = _time_ms(library)
    c_bound, c_by, nbytes = _push_bound(n_real, slots.numel(), D, streams=2)
    print(f"  times (ms, L2 cold): kernel {c['ms']:.4f} (L2 warm "
          f"{c['ms_l2_warm']:.4f}; graph {c['graph_ms']:.4f}; host "
          f"{c['host_us']:.1f} us), ops-level cached push "
          f"{c['ops']['ms']:.4f} (graph {c['ops']['graph_ms']:.4f}, host "
          f"{c['ops']['host_us']:.1f} us), plain version (row math + two "
          f"index_add_) {c['plain_ms']:.4f}, the scatter alone (two "
          f"index_add_) {c['index_add_ms']:.4f}, no single library call; "
          f"bound {c_bound:.4f} ({nbytes / 1e6:.2f} MB: {n_real} real rows "
          f"x 5 x {D * 4} B + the uid and slot streams)")
    del r, a, acc

    def entry(name, source, replaces, ms, warm, plain, bound, by, lib,
              err=0.0):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": None, "max_abs_err": err,
                "ms": ms, "ms_l2_warm": warm, "plain_ms": plain,
                "bound_ms": bound,
                "bound_by": by, "library_ms": lib}

    src = "src/repro_torch/kernels/csrc/"
    probe_entry = entry("hash_lookup", src + "hash_map.cu",
                        "src/repro/kernels/hash_map.py:197", p_ms, p_warm,
                        p_plain, p_bound, p_by, None)
    probe_entry.update(graph_ms=p_graph, graph_ms_l2_warm=p_graph_warm,
                       host_us=p_host, latency_floor_ms=floor_ms,
                       hbm_trip_us=trip_us, empty_launch_graph_ms=empty_ms,
                       unchained_reads_graph_ms=reads_ms,
                       at_four_times_the_batch=p_scaled)
    gather_entry = entry("gather_rows_cached", src + "sparse_adagrad.cu",
                         "src/repro/kernels/sparse_adagrad.py:194", g["ms"],
                         g["ms_l2_warm"], g["plain_ms"], g_bound, g_by,
                         g["index_select_ms"])
    gather_entry.update({k: v for k, v in g.items() if k not in gather_entry})
    push_entry = entry("sparse_adagrad_cached_apply",
                       src + "sparse_adagrad.cu",
                       "src/repro/kernels/sparse_adagrad.py:166", c["ms"],
                       c["ms_l2_warm"], c["plain_ms"], c_bound, c_by, None,
                       errs["push"])
    push_entry.update({k: v for k, v in c.items() if k not in push_entry})
    return [probe_entry, gather_entry, push_entry]


def phase_cached_smoke(device):
    """The cached placement at smoke size on the card: the full mirror
    bit-identical to gather; the card against the CPU from one warm state
    (the small cache evicts and rebuilds its map).  Returns the rebuilds
    of the card's run."""
    import torch

    from repro_torch import tree_map
    from repro_torch.configs import baidu_ctr
    from repro_torch.core.cache_tier import CacheState
    from repro_torch.core.kstep import KStepAdamState, KStepConfig, leaves
    from repro_torch.data.synthetic import recsys_batches
    from repro_torch.interop import ReferenceState
    from repro_torch.models import recsys as R
    from repro_torch.runtime.factory import build_ctr_engine, build_trainer
    from repro_torch.runtime.online import fit_online
    from repro_torch.runtime.trainer import HybridTrainer, TrainerConfig

    smoke = baidu_ctr.SMOKE

    def cfg(placement, cache_rows=None):
        return TrainerConfig(n_pod=2, kstep=KStepConfig(k=2), capacity=256,
                             placement=placement, cache_rows=cache_rows,
                             log_every=1)

    def losses_of(tr, steps, seed=5):
        out = []
        step = tr.train_step
        tr.train_step = lambda b: out.append(step(b)) or out[-1]
        fit_online(tr, recsys_batches(smoke, batch=32, seed=seed), steps,
                   window=5)
        del tr.train_step
        return torch.stack(out).cpu()

    # ---- the full mirror is the gather placement, bit for bit
    g = build_trainer("baidu-ctr", cfg("gather"), seed=3, device=device)
    c = build_trainer("baidu-ctr", cfg("cached", smoke.rows), seed=3,
                      device=device)
    lg, lc = losses_of(g, 6), losses_of(c, 6)
    tables, accum, states = c.engine.flush(c.tables, c.sparse_state.accum,
                                           c.backend_state)
    dense_eq = all(torch.equal(x, y) for x, y in zip(leaves(g.dense),
                                                     leaves(c.dense)))
    if not (torch.equal(lg, lc) and dense_eq
            and torch.equal(g.tables["sparse"].cpu(), tables["sparse"])
            and torch.equal(g.sparse_state.accum["sparse"].cpu(),
                            accum["sparse"])):
        raise AssertionError("the cached full mirror differs from gather")
    if float(states["sparse"].evictions) != 0:
        raise AssertionError("the full mirror evicted")
    print(f"phase 8: smoke size, cached full mirror (cache_rows {smoke.rows})"
          f" vs gather on the card, 6 steps: losses, dense, flushed table and"
          f" accumulator bit-equal")

    # ---- card against CPU from one warm state
    gpu = build_trainer("baidu-ctr", cfg("cached", 300), seed=3,
                        device=device)
    losses_of(gpu, 3, seed=6)                         # warm, dirty cache
    cpu_of = lambda x: x.cpu().clone()    # the trainers update in place
    s = gpu.opt_state
    state = ReferenceState(
        dense=tree_map(cpu_of, gpu.dense),
        tables={n: cpu_of(t) for n, t in gpu.tables.items()},
        accum={n: cpu_of(a) for n, a in gpu.sparse_state.accum.items()},
        opt_state=KStepAdamState(cpu_of(s.step), tree_map(cpu_of, s.m),
                                 tree_map(cpu_of, s.v_local),
                                 tree_map(cpu_of, s.v_hat), None),
        backend_state={n: CacheState(*[cpu_of(x) for x in bs])
                       for n, bs in gpu.backend_state.items()})
    tcfg = cfg("cached", 300)
    cpu = HybridTrainer(None, build_ctr_engine(smoke, tcfg, device="cpu"),
                        R.ctr_embed_from_workings(smoke),
                        R.ctr_hybrid_loss(smoke), tcfg, state=state,
                        device="cpu")
    out = []
    for tr in (gpu, cpu):
        ls = losses_of(tr, 12)
        t, _, _ = tr.engine.flush(tr.tables, tr.sparse_state.accum,
                                  {n: CacheState(*[y.clone() for y in x])
                                   for n, x in tr.backend_state.items()})
        out.append((ls.numpy(), torch.cat([x.reshape(-1).cpu() for x in
                                           leaves(tr.dense)]).numpy(),
                    t["sparse"].numpy(), tr.backend_state["sparse"]))
    sg, sc = out[0][3], out[1][3]
    for f in ("slot_uid", "key_tab", "slot_tab", "n_occupied", "dirty",
              "freq", "lookups", "fetched", "evictions", "rebuilds"):
        if not torch.equal(getattr(sg, f).cpu(), getattr(sc, f)):
            raise AssertionError(f"cache state {f} differs card vs CPU")
    tol = dict(rtol=1e-4, atol=1e-6)
    for what, x, y in zip(("losses", "dense", "flushed table"), out[0],
                          out[1]):
        np.testing.assert_allclose(x, y, err_msg=what, **tol)
    rebuilds = float(sg.rebuilds)
    print(f"phase 8: smoke size, cached (cache_rows 300, capacity 256) card "
          f"vs CPU from one warm state, 12 steps: slot_uid, key_tab, "
          f"slot_tab, n_occupied, dirty, freq and counters equal "
          f"(evictions {float(sg.evictions):.0f}, rebuilds {rebuilds:.0f}); "
          f"losses max |diff| {np.abs(out[0][0] - out[1][0]).max():.3g}, "
          f"dense {np.abs(out[0][1] - out[1][1]).max():.3g}, table "
          f"{np.abs(out[0][2] - out[1][2]).max():.3g}")
    return rebuilds


# ------------------------------------------ the dense slice and the SSD tier
def _adam_kwargs(t, device, warmup, bias, wd, lr_tensor, k=20):
    """The local step's arguments as ``KStepAdam.step`` passes them: ``t``
    and a tensor lr on the card, the bias-correction factors computed by
    the same PyTorch ops."""
    import torch

    tt = torch.tensor(t, dtype=torch.int32, device=device)
    lr = (torch.tensor(1e-3, dtype=torch.float32, device=device)
          if lr_tensor else 1e-3)
    mhat = vhat = None
    b1 = 0.9 if bias else 0.0
    if bias:
        tf = tt.to(torch.float32)
        mhat = 1.0 / (1.0 - b1 ** tf)
        vhat = 1.0 / (1.0 - 0.999 ** tf)
    return dict(t=tt, lr=lr, b1=b1, b2=0.999, k=k, local_v_warmup=warmup,
                mhat_s=mhat, vhat_s=vhat, weight_decay=wd)


def phase_fused_adam(device):
    """Kernel 6, the k-step local Adam step, against its plain version at
    the slice's leaves (baidu-ctr's dense tower, 2 pods); returns its
    kernels-line entry (without ``launches``)."""
    import torch

    from repro_torch.configs import baidu_ctr
    from repro_torch.core.kstep import leaves, pod_replicate
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_adam import AdamTable, fused_adam_cuda
    from repro_torch.models import recsys as R

    gen = torch.Generator(device).manual_seed(41)
    P = leaves(pod_replicate(R.ctr_init_dense(gen, baidu_ctr.MODEL,
                                              device=device), 2))
    n = sum(x.numel() for x in P)

    def like(scale, positive=False):
        out = []
        for x in P:
            y = torch.randn(x.shape, generator=gen, device=device) * scale
            out.append(y.abs_() + 1e-3 * scale if positive else y)
        return out

    leaves5 = (P, like(0.01), like(0.01), like(1e-4, True),
               like(1e-4, True))
    print(f"phase 1: fused_adam (kernel 6, the k-step local step) against "
          f"its plain version ({len(P)} leaves, {n} elements)")
    max_err, cases = 0.0, 0
    for warmup, t in ((True, 3), (True, 25), (False, 3)):
        for bias in (False, True):
            for wd in (0.0, 1e-4):
                for lr_tensor in (False, True):
                    kw = _adam_kwargs(t, device, warmup, bias, wd,
                                      lr_tensor)
                    want = [[x.clone() for x in g] for g in leaves5]
                    ref.fused_adam_ref(*want, **kw)
                    for run in range(2):
                        got = [[x.clone() for x in g] for g in leaves5]
                        fused_adam_cuda(*got, **kw)
                        torch.cuda.synchronize()
                        for i in (0, 2, 3):
                            for a, b in zip(got[i], want[i]):
                                max_err = max(max_err, (a - b).abs().max()
                                              .item())
                                if not torch.equal(a, b):
                                    raise AssertionError(
                                        f"fused_adam warmup={warmup} t={t} "
                                        f"bias={bias} wd={wd} lr_tensor="
                                        f"{lr_tensor} run {run}: kernel and "
                                        "plain version differ")
                    cases += 1
    print(f"  {cases} cases (warm-up on before and after the first merge "
          f"and off, bias correction on/off, weight decay 0 and 1e-4, lr "
          f"a float and a 0-dim tensor): params, m and v_local bit-equal "
          f"to the plain version, two runs bit-equal")

    # ---- times: the local step after the first merge (v_hat read)
    kw = _adam_kwargs(25, device, True, False, 0.0, False)
    table = AdamTable()

    def kernel():
        return fused_adam_cuda(*leaves5, table=table, **kw)

    ms, warm_ms = _time_ms(kernel), _time_ms(kernel, cold_l2=False)
    plain_ms = _time_ms(lambda: ref.fused_adam_ref(*leaves5, **kw))
    nbytes = 8 * 4 * n
    bound_ms, bound_by = _bound(nbytes, 12 * n)
    print(f"  times (ms, L2 cold): kernel {ms:.4f} (L2 warm {warm_ms:.4f}), "
          f"plain version {plain_ms:.4f}, no single PyTorch call computes "
          f"it; bound {bound_ms:.4f} ({nbytes / 1e6:.1f} MB: 8 streams x "
          f"4 B x {n})")
    return {
        "name": "fused_adam",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_adam.cu",
        "replaces": "src/repro/kernels/fused_adam.py:44",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "ms_l2_warm": warm_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def phase_staged_push(device):
    """Kernel 7, the SSD tier's staged push, against its plain version and
    the host push at the staged slice's shapes; returns its kernels-line
    entry (without ``launches``)."""
    import torch

    from repro_torch.core.embedding_backend import pull_working_set
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.sparse_adagrad import sparse_adagrad_staged_cuda

    gen = torch.Generator(device).manual_seed(43)
    max_err = 0.0

    def checks(name, uids, n_real, table_rows, D):
        nonlocal max_err
        table = torch.randn((table_rows, D), generator=gen,
                            device=device) * 0.05
        accum = torch.rand((table_rows, D), generator=gen,
                           device=device) + 0.01
        rows, acc = table[uids.long()], accum[uids.long()]
        grads = torch.randn((uids.numel(), D), generator=gen, device=device)
        grads[n_real:] = 0.0                 # no id slot maps to a pad
        want = ref.sparse_adagrad_ref(rows.clone(), acc.clone(), grads, 0.5,
                                      1e-10)
        runs = []
        for _ in range(2):
            r, a = rows.clone(), acc.clone()
            sparse_adagrad_staged_cuda(r, a, grads, lr=0.5, eps=1e-10)
            torch.cuda.synchronize()
            runs.append((r, a))
        for r, a in runs:
            max_err = max(max_err, (r - want[0]).abs().max().item(),
                          (a - want[1]).abs().max().item())
            if not (torch.equal(r, want[0]) and torch.equal(a, want[1])):
                raise AssertionError(f"staged push {name}: kernel and plain "
                                     "version differ")
        t, a = table.clone(), accum.clone()
        ops.sparse_adagrad_apply(t, a, uids, grads, lr=0.5, eps=1e-10)
        valid = torch.cat([torch.ones(1, dtype=torch.bool, device=device),
                           uids[1:] > uids[:-1]])
        vu = uids[valid].long()
        if not (torch.equal(runs[0][0][valid], t[vu])
                and torch.equal(runs[0][1][valid], a[vu])
                and torch.equal(runs[0][0][~valid], rows[~valid])):
            raise AssertionError(f"staged push {name}: rows differ from the "
                                 "host push, or a pad changed")
        print(f"  {name}: bit-equal to the plain version and, at every "
              f"real position, to the host push; pads unchanged; two runs "
              f"bit-equal ({n_real} real rows, {uids.numel() - n_real} pads)")
        return rows, acc, grads

    small_rows = 4_000_000
    uids, n_real = _slice_uids(device, fit_rows=small_rows)
    print(f"phase 1: sparse_adagrad (kernel 7, the staged push) against its "
          f"plain version (staged rows {uids.numel()} x 64)")
    rows, acc, grads = checks("slice layout, D=64", uids, n_real,
                              small_rows, 64)
    over, _ = _slice_uids(device, capacity=16384, fit_rows=small_rows)
    checks("overflowed batch (capacity 16384), D=64", over, 16384,
           small_rows, 64)
    for cap, D in ((8192, 16), (8192, 100), (333, 3)):
        ids = torch.randint(0, 30000, (min(5000, cap + cap // 2),),
                            generator=gen, device=device, dtype=torch.int32)
        u, _ = pull_working_set(ids, cap)
        checks(f"random batch, capacity {cap}, D={D}", u,
               min(cap, int(torch.unique(ids).numel())), 30000, D)

    def kernel():
        return sparse_adagrad_staged_cuda(rows, acc, grads, lr=0.5,
                                          eps=1e-10)

    ms, warm_ms = _time_ms(kernel), _time_ms(kernel, cold_l2=False)
    plain_ms = _time_ms(lambda: ref.sparse_adagrad_ref(rows, acc, grads, 0.5,
                                                       1e-10))
    C, D = rows.shape
    nbytes = 5 * 4 * C * D
    bound_ms, bound_by = _bound(nbytes, 6 * C * D)
    print(f"  times (ms, L2 cold): kernel {ms:.4f} (L2 warm {warm_ms:.4f}), "
          f"plain version {plain_ms:.4f}, no single PyTorch call computes "
          f"it; bound {bound_ms:.4f} ({nbytes / 1e6:.1f} MB: 5 streams x "
          f"4 B x {C} x {D})")
    return {
        "name": "sparse_adagrad",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sparse_adagrad.cu",
        "replaces": "src/repro/kernels/sparse_adagrad.py:88",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "ms_l2_warm": warm_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


DISK_ROWS = 4_000_000      # the one reduction of phase 9: 50 M -> 4 M rows
PAGE_ROWS = 4096
PAGE_CACHE_PAGES = 256     # of 977: pages evict and write behind
DISK_STEPS = 20
DISK_EXTRA = 3             # steps of the stream-time breakdown


def _serve_scores(server, batch):
    """Score one request batch through the server; the scores, in order."""
    from repro_torch.runtime.serve_ctr import requests_from_batch

    reqs = requests_from_batch(batch)
    for r in reqs:
        server.submit(r)
    if server.drain() != len(reqs):
        raise AssertionError("the server did not drain its batch")
    return np.array([r.score for r in reqs], np.float32)


def _disk_counted_run(tr, batches, requests):
    """``DISK_STEPS`` train steps, each followed by a 256-request drain:
    (losses, every drain's scores, launches, wall seconds)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.runtime.factory import build_ctr_server

    server = build_ctr_server(tr, max_batch=SERVE_BATCH)
    losses, scores = [], []
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b, r in zip(batches, requests):
        losses.append(tr.train_step(b))
        scores.append(_serve_scores(server, r))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (torch.stack(losses).cpu().numpy(), scores, dict(ops.launches),
            wall)


def _disk_breakdown(tr, batches):
    """``train_step`` on the DiskStore split into its parts, with CUDA
    events between them (stream time, the host's gaps included); returns
    the steps' losses."""
    import torch

    names = ("host dedup (stage batch, ids to host, np.unique)",
             "read-ahead", "absorb (previous push to the store)",
             "gather (store to pinned)", "upload", "pull (device dedup)",
             "forward", "backward", "k-step Adam", "push")
    eng = tr.engine
    sums = dict.fromkeys(names, 0.0)
    losses = []
    for b in batches:
        tr.step_num += 1
        merge = tr.step_num % tr.cfg.kstep.k == 0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(11)]
        ev[0].record()
        staged = tr._stage(b)
        flat = eng.ids_from_batch(staged)
        ded = {n: eng.host_dedup(x)
               for n, x in eng._ids_to_host(flat).items()}
        ev[1].record()
        for n, (uids, valid) in ded.items():
            eng.store.readahead(n, uids[valid])
        ev[2].record()
        eng.absorb_staged(tr.tables, tr.sparse_state.accum, tr.backend_state)
        ev[3].record()
        host = eng.read_staged(ded)
        ev[4].record()
        st_t, st_a = eng.upload_staged(host)
        ev[5].record()
        eng._staged_pending = ded
        wss, tables, accum, bstate = eng.pull(st_t, st_a, tr.backend_state,
                                              flat)
        ev[6].record()
        dense, workings, step_losses = tr._forward(wss, tr.pod_batch(staged))
        ev[7].record()
        dense_g, work_g = tr._backward(dense, workings, step_losses)
        ev[8].record()
        tr.opt.step(tr.dense, dense_g, tr.opt_state, merge=merge)
        ev[9].record()
        tr.tables, accum, tr.backend_state = eng.push(tables, accum, bstate,
                                                      wss, work_g)
        tr.sparse_state = tr.sparse_state._replace(accum=accum)
        tr._overflow += eng.overflow(wss)
        ev[10].record()
        losses.append(step_losses.detach().sum() / tr.n_pod)
        torch.cuda.synchronize()
        for i, k in enumerate(names):
            sums[k] += ev[i].elapsed_time(ev[i + 1])
    parts = {k: v / len(batches) for k, v in sums.items()}
    print("  one train step on the DiskStore, stream time by part (ms, "
          f"{len(batches)} steps): " + ", ".join(
              f"{k} {v:.3f}" for k, v in parts.items())
          + f"; sum {sum(parts.values()):.3f}")
    return torch.stack(losses).cpu().numpy()


def phase_disk(device):
    """The SSD tier at full width, the table cut to 4 M rows: (a) gather on
    the host store, (b) gather on the DiskStore with an unbounded page
    cache, (c) cached on the DiskStore with a 256-page cache; 20 steps
    each with a 256-request drain between steps, then 3 steps split into
    parts.  Losses and scores of (b) and (c) bit-equal to (a)'s; after
    ``close``, a fresh DiskStore on the spill directory reads (a)'s rows
    and accumulators at every touched uid.  Returns (b)'s launch counts."""
    import shutil

    import torch

    from repro_torch.core import row_store

    spill_root = ROOT / "build" / "phase9_spill"
    page_bytes = DISK_ROWS * 64 * 4 * 2
    n_pages = -(-DISK_ROWS // PAGE_ROWS)
    shutil.rmtree(spill_root, ignore_errors=True)
    spill_root.mkdir(parents=True)
    free = shutil.disk_usage(spill_root).free
    print(f"phase 9: the SSD tier, rows {DISK_ROWS} (pages of {PAGE_ROWS} "
          f"rows: {n_pages} pages, {page_bytes / 1e9:.2f} GB of rows and "
          f"accumulators), capacity {CAPACITY}, batch {BATCH}, n_pod 2, k "
          f"20, two_phase, {DISK_STEPS} steps with a {SERVE_BATCH}-request "
          f"drain between steps; free space in {spill_root.relative_to(ROOT)}"
          f": {free / 1e9:.1f} GB")
    if free < 3 * page_bytes:
        raise AssertionError(f"phase 9 needs {3 * page_bytes / 1e9:.1f} GB "
                             f"free for its pages, the disk has "
                             f"{free / 1e9:.1f} GB")
    batches = _train_batches(DISK_STEPS + DISK_EXTRA, rows=DISK_ROWS)
    run, extra = batches[:DISK_STEPS], batches[DISK_STEPS:]
    requests = _train_batches(DISK_STEPS, seed=2, batch=SERVE_BATCH,
                              rows=DISK_ROWS)
    touched = np.unique(np.concatenate([b["ids"].reshape(-1)
                                        for b in batches])).astype(np.int64)
    create_s = []
    create_table = row_store.DiskStore.create_table

    def timed_create(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = create_table(self, *args, **kwargs)
        create_s.append(time.perf_counter() - t0)
        return out

    try:
        # ---- (a) gather on the host store: the reference run
        tr = _full_width_trainer(device, rows=DISK_ROWS)
        losses_a, scores_a, launches_a, wall = _disk_counted_run(
            tr, run, requests)
        extra_a = np.float32([float(tr.train_step(b)) for b in extra])
        idx = torch.from_numpy(touched).to(device)
        rows_a = (tr.tables["sparse"][idx].cpu().numpy(),
                  tr.sparse_state.accum["sparse"][idx].cpu().numpy())
        print(f"  (a) gather, host store: {wall / DISK_STEPS * 1e3:.2f} ms "
              f"per step + drain; losses {losses_a[0]:.6f} ... "
              f"{losses_a[-1]:.6f}; {touched.size} uids touched")
        del tr
        _release()

        results = {}
        # (c) starts from a hard-linked clone of (b)'s initial pages (the
        # same seed draws the same rows; a page is replaced, never
        # rewritten in place), so only (b) writes them
        pristine = spill_root / "pristine"
        for tag, placement, cache_rows, pages in (
                ("b", "gather", None, None),
                ("c", "cached", CACHE_ROWS, PAGE_CACHE_PAGES)):
            spill = spill_root / tag
            t0 = time.perf_counter()
            cloned = pristine.exists()
            if cloned:
                _clone_pages(pristine, spill)
            row_store.DiskStore.create_table = timed_create
            try:
                tr = _full_width_trainer(
                    device, placement=placement, cache_rows=cache_rows,
                    rows=DISK_ROWS, store="disk", spill_dir=str(spill),
                    page_rows=PAGE_ROWS, page_cache_pages=pages)
            finally:
                row_store.DiskStore.create_table = create_table
            torch.cuda.synchronize()
            if not cloned:
                _clone_pages(spill, pristine)
            what = (f"({tag}) {placement} on the DiskStore, page cache "
                    f"{'unbounded' if pages is None else f'{pages} pages'}")
            how = ("adopted from the clone" if cloned
                   else "written and fsynced")
            print(f"  {what}: trainer built in {time.perf_counter() - t0:.1f}"
                  f" s, of which create_table {create_s[-1]:.1f} s "
                  f"({n_pages} pages {how})")
            torch.cuda.reset_peak_memory_stats()
            losses, scores, launches, wall = _disk_counted_run(tr, run,
                                                               requests)
            if not np.array_equal(losses, losses_a):
                raise AssertionError(
                    f"({tag}) losses differ from (a)'s: max |diff| "
                    f"{np.abs(losses - losses_a).max()}")
            for i, (x, y) in enumerate(zip(scores, scores_a)):
                if not np.array_equal(x, y):
                    raise AssertionError(f"({tag}) drain {i}: scores differ "
                                         "from (a)'s")
            n, local = DISK_STEPS, DISK_STEPS - DISK_STEPS // 20
            want = dict.fromkeys(launches, 0)
            want.update({"embedding_bag": 3 * n,
                         "embedding_bag_backward": 2 * n,
                         "fused_adam": local})
            if placement == "gather":
                want["sparse_adagrad"] = n
            else:
                want.update({"hash_lookup": 3 * n,
                             "gather_rows_cached": 2 * n,
                             "sparse_adagrad_cached_apply": n})
            if launches != want:
                raise AssertionError(f"({tag}) launches {launches}, "
                                     f"expected {want}")
            st = tr.engine.store.stats()
            sv = tr.engine.store.serve_stats()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            print(f"  {what}: {wall / n * 1e3:.2f} ms per step + drain "
                  f"({n / wall:.2f} steps/s), peak device memory "
                  f"{peak_gb:.2f} GB; losses and all {n} drains' scores "
                  f"bit-equal to (a)'s; launches {launches}")
            print(f"  {what}, store meters over {n} steps: training page "
                  f"hits {st['page_hits']:.0f}, misses "
                  f"{st['page_misses']:.0f}, evictions "
                  f"{st['pages_evicted']:.0f}, disk read "
                  f"{st['disk_bytes_read'] / 1e9:.3f} GB, written "
                  f"{st['disk_bytes_written'] / 1e9:.3f} GB (create_table "
                  f"included); serving page hits {sv['page_hits']:.0f}, "
                  f"misses {sv['page_misses']:.0f}, evictions "
                  f"{sv['pages_evicted']:.0f}, read "
                  f"{sv['disk_bytes_read'] / 1e9:.3f} GB")
            if placement == "cached":
                m = tr.sparse_metrics()
                print(f"  {what}: cache hit rate "
                      f"{m['cache_hit_rate_total']:.4f}, evictions "
                      f"{m['evictions_total']}")
            losses_x = _disk_breakdown(tr, extra)
            if not np.array_equal(losses_x, extra_a):
                raise AssertionError(f"({tag}) the breakdown's losses differ "
                                     "from (a)'s")
            t0 = time.perf_counter()
            tr.close()
            close_s = time.perf_counter() - t0
            fresh = row_store.DiskStore(str(spill), page_rows=PAGE_ROWS)
            fresh.create_table("sparse", DISK_ROWS, 64, np.float32)
            got = fresh.gather("sparse", touched)
            fresh.close()
            if not (np.array_equal(got[0], rows_a[0])
                    and np.array_equal(got[1], rows_a[1])):
                raise AssertionError(f"({tag}) the reopened store's rows "
                                     "differ from (a)'s table")
            print(f"  {what}: close (sync_store + flush + stop) "
                  f"{close_s:.1f} s; a fresh DiskStore on the directory "
                  f"reads (a)'s rows and accumulators at all "
                  f"{touched.size} touched uids, bit-equal")
            results[tag] = launches
            del tr
            _release()
            shutil.rmtree(spill)
    finally:
        row_store.DiskStore.create_table = create_table
        shutil.rmtree(spill_root, ignore_errors=True)
    return results["b"]


DLRM_ROW_CAP = 8_000_000   # the one reduction of phase 10: rows per table
DLRM_SERVE_BATCH = 512     # recsys_shapes()["serve_p99"]
DLRM_REQUESTS = 2048
DLRM_BULK = 16384          # one bulk predict; the pull capacity, 16384, holds
                           # its <= 16384 distinct ids per table


def _dot_times(feats):
    """Kernel 8's times (cold and warm L2), its plain version's, the library
    call's (``bmm`` then the triangle's ``index_select``) and its bound at
    ``feats``."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.dot_interaction import dot_interaction_cuda

    B, F, D = feats.shape
    P = F * (F - 1) // 2
    li, lj = torch.tril_indices(F, F, offset=-1, device=feats.device)
    flat = li * F + lj

    def library():
        return torch.bmm(feats, feats.transpose(1, 2)).reshape(
            B, F * F).index_select(1, flat)

    def kernel():
        return dot_interaction_cuda(feats)

    lib = library()
    tol = 1e-5 if feats.dtype == torch.float32 else 2e-2
    if not torch.allclose(lib.float(), kernel().float(), atol=tol * D,
                          rtol=4 * tol):
        raise AssertionError(f"dot_interaction {tuple(feats.shape)}: the "
                             "library call and the kernel differ")
    elem = feats.element_size()
    nbytes = (B * F * D + B * P) * elem
    bound_ms, bound_by = _bound(nbytes, 2 * B * P * D)
    return {
        "shape": [B, F, D], "dtype": str(feats.dtype).split(".")[-1],
        "ms": _time_ms(kernel), "ms_l2_warm": _time_ms(kernel, cold_l2=False),
        "plain_ms": _time_ms(lambda: ref.dot_interaction_ref(feats)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": _time_ms(library), "mb": nbytes / 1e6,
    }


def phase_dot_interaction(device):
    """Phase 10 (a): kernel 8 against its plain version, and timed, at
    phase 10's shapes; returns its kernels-line entry (without
    ``launches``): the serve_p99 shape, with the bulk shape under
    ``bulk``."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.dot_interaction import dot_interaction_cuda

    gen = torch.Generator(device).manual_seed(47)
    cases = [((DLRM_SERVE_BATCH, 27, 128), torch.float32),
             ((DLRM_BULK, 27, 128), torch.float32),
             ((33, 13, 17), torch.float32),
             ((DLRM_SERVE_BATCH, 27, 128), torch.bfloat16),
             ((DLRM_SERVE_BATCH, 2, 128), torch.float32),
             ((DLRM_SERVE_BATCH, 1, 128), torch.float32)]
    print("phase 10 (a): dot_interaction (kernel 8) against its plain "
          "version (tolerance: f32 atol 1e-5 D, rtol 4e-5; bf16 atol "
          "2e-2 D, rtol 8e-2)")
    max_err, max_err_bf16, times = 0.0, 0.0, []
    for (B, F, D), dtype in cases:
        feats = torch.randn((B, F, D), generator=gen, device=device).to(dtype)
        got = dot_interaction_cuda(feats)
        again = dot_interaction_cuda(feats)
        torch.cuda.synchronize()
        want = ref.dot_interaction_ref(feats)
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        err = ((got.float() - want.float()).abs().max().item()
               if got.numel() else 0.0)
        if (got.shape != want.shape or got.dtype != dtype
                or not torch.equal(got, again)
                or not torch.allclose(got.float(), want.float(),
                                      atol=tol * D, rtol=4 * tol)):
            raise AssertionError(f"dot_interaction {(B, F, D)} {dtype}: "
                                 f"kernel and plain version differ (max "
                                 f"|diff| {err}) or two runs differ")
        if dtype == torch.float32:
            max_err = max(max_err, err)
        else:
            max_err_bf16 = max(max_err_bf16, err)
        print(f"  {(B, F, D)} {str(dtype).split('.')[-1]}: output "
              f"{tuple(got.shape)}, max |kernel - plain| {err:.3g}, two runs "
              f"bit-equal")
        if got.numel():
            times.append(_dot_times(feats))
    for t in times:
        print(f"  times {tuple(t['shape'])} {t['dtype']} (ms): kernel "
              f"{t['ms']:.4f} cold, {t['ms_l2_warm']:.4f} warm; plain "
              f"{t['plain_ms']:.4f}; library (bmm + index_select) "
              f"{t['library_ms']:.4f}; bound {t['bound_ms']:.4f} "
              f"({t['mb']:.2f} MB, {t['bound_by']})")
    serve, bulk = times[0], times[1]
    return {
        "name": "dot_interaction",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dot_interaction.cu",
        "replaces": "src/repro/kernels/dot_interaction.py:44",
        "launches": None,
        "max_abs_err": max_err,
        "max_abs_err_bf16": max_err_bf16,
        "shape": serve["shape"],
        "ms": serve["ms"],
        "ms_l2_warm": serve["ms_l2_warm"],
        "plain_ms": serve["plain_ms"],
        "bound_ms": serve["bound_ms"],
        "bound_by": serve["bound_by"],
        "library_ms": serve["library_ms"],
        "bulk": {k: bulk[k] for k in ("shape", "ms", "ms_l2_warm",
                                      "plain_ms", "bound_ms", "bound_by",
                                      "library_ms")},
    }


def _dlrm_breakdown(tr, batch):
    """Phase 10 (c) and (e): one predict's parts in stream time (CUDA
    events), then the interaction's call under the sync debug mode "error"
    and under the profiler (no sync, no host-to-device copy allowed)."""
    import torch

    from repro_torch.models import recsys as R
    from repro_torch.models.common import mlp_apply
    from repro_torch.runtime.trainer import pod_slice

    eng = tr.engine
    with torch.inference_mode():
        b = tr._stage(batch)
        wss, _ = eng.lookup_batch(tr.tables, tr.sparse_state.accum,
                                  tr.backend_state, b)
        workings = {n: ws.rows for n, ws in wss.items()}
        invs = {n: ws.inverse for n, ws in wss.items()}
        emb = tr._embed(workings, invs, b)
        dense0 = pod_slice(tr.dense, 0)
        x = mlp_apply(dense0["bot"], b["dense"], act=torch.relu)
        feats = torch.cat([x[:, None, :], emb], dim=1)
        inter = R.dot_interaction(feats)
        parts = {
            "stage batch": lambda: tr._stage(batch),
            "lookup (26 dedups + gathers)": lambda: eng.lookup_batch(
                tr.tables, tr.sparse_state.accum, tr.backend_state, b),
            "embed (26 takes, kernel 1)": lambda: tr._embed(workings, invs, b),
            "bottom MLP": lambda: mlp_apply(dense0["bot"], b["dense"],
                                            act=torch.relu),
            "interaction (kernel 8)": lambda: R.dot_interaction(feats),
            "top MLP + sigmoid": lambda: torch.sigmoid(mlp_apply(
                dense0["top"], torch.cat([x, inter], dim=-1),
                act=torch.relu)[:, 0]),
            "whole predict": lambda: tr.predict(batch),
        }
        times = {k: _time_ms(fn, iters=10, warmup=2, cold_l2=False)
                 for k, fn in parts.items()}
        print(f"  one predict of {b['dense'].shape[0]}, stream time by part "
              "(ms): " + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            R.dot_interaction(feats)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        h2d, syncs, kernels = _transfers(lambda: R.dot_interaction(feats))
    if h2d or syncs or kernels != 1:
        raise AssertionError(f"the interaction's call made {h2d} host-to-"
                             f"device copies, {syncs} syncs and {kernels} "
                             "kernel launches")
    print(f"  phase 10 (e): the interaction's call on {tuple(feats.shape)} "
          f"ran under the sync debug mode 'error'; profiler: 1 kernel "
          f"launch, 0 host-to-device copies, 0 synchronizing calls")


def phase_dlrm(device):
    """Phase 10 (b), (c), (e): dlrm-mlperf served at full width through the
    CTRServer, and one bulk predict; returns the launch counts of the
    serving run."""
    import torch

    from repro_torch.configs import dlrm_mlperf
    from repro_torch.data.synthetic import dlrm_batches
    from repro_torch.kernels import ops
    from repro_torch.runtime.factory import build_ctr_server, build_trainer
    from repro_torch.runtime.trainer import TrainerConfig

    mcfg = dataclasses.replace(dlrm_mlperf.MODEL, rows=tuple(
        min(r, DLRM_ROW_CAP) for r in dlrm_mlperf.MODEL.rows))
    t0 = time.perf_counter()
    tr = build_trainer("dlrm-mlperf", TrainerConfig(placement="gather"),
                       smoke=False, model_cfg=mcfg, seed=0, device=device)
    torch.cuda.synchronize()
    state_gb = sum(t.numel() * t.element_size() for t in
                   list(tr.tables.values())
                   + list(tr.sparse_state.accum.values())) / 1e9
    print(f"phase 10: dlrm-mlperf serving at full width (embed 128, bottom "
          f"MLP 13-512-256-128, top MLP {mcfg.interact_dim}-1024-1024-512-"
          f"256-1, f32), 26 tables of {sum(mcfg.rows)} rows (each capped "
          f"at {DLRM_ROW_CAP}), capacity {tr.engine.capacity}; trainer "
          f"built in {time.perf_counter() - t0:.1f} s, table + accumulator "
          f"{state_gb:.2f} GB on the card")
    if tr.engine.capacity != DLRM_BULK:
        raise AssertionError(f"capacity {tr.engine.capacity}, not "
                             f"{DLRM_BULK}")

    warm = build_ctr_server(tr, max_batch=DLRM_SERVE_BATCH)
    warm.submit_batch(next(dlrm_batches(seed=1, batch=DLRM_SERVE_BATCH,
                                        rows=mcfg.rows)))
    warm.drain()

    # ---- (b) the server: 2048 requests in dynamic batches of 512
    batch = next(dlrm_batches(seed=2, batch=DLRM_REQUESTS, rows=mcfg.rows))
    before = tr.serve_metrics()
    server = build_ctr_server(tr, max_batch=DLRM_SERVE_BATCH)
    server.submit_batch(batch)
    reqs = list(server.pending)
    torch.cuda.synchronize()
    ops.reset_launches()
    server.drain()
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    summ = server.summary()
    scores = np.array([r.score for r in reqs])
    steps = int(summ["steps"])
    looked = tr.serve_metrics()["serve_lookups"] - before["serve_lookups"]
    if summ["served"] != DLRM_REQUESTS or steps != (
            DLRM_REQUESTS // DLRM_SERVE_BATCH):
        raise AssertionError(f"served {summ['served']} of {DLRM_REQUESTS} "
                             f"requests in {steps} predicts")
    if launches["dot_interaction"] != steps or any(
            v for k, v in launches.items() if k.endswith("_ref")):
        raise AssertionError(f"the interaction did not run as its kernel "
                             f"once per predict: {launches}")
    if not (np.isfinite(scores).all() and ((scores > 0) & (scores < 1)).all()):
        raise AssertionError("a score is not a finite value in (0, 1)")
    if looked != DLRM_REQUESTS * mcfg.n_sparse:
        raise AssertionError(f"{DLRM_REQUESTS * mcfg.n_sparse - looked:.0f} "
                             "ids dropped by the capacity")
    print(f"  phase 10 (b): {DLRM_REQUESTS} requests in {steps} predicts of "
          f"{DLRM_SERVE_BATCH}: qps {summ['qps']:.1f}, p50 "
          f"{summ['p50'] * 1e3:.2f} ms, p99 {summ['p99'] * 1e3:.2f} ms, "
          f"predict wall {summ['wall_s'] / steps * 1e3:.2f} ms each; served "
          f"{summ['served']:.0f}; all scores finite in (0, 1), from "
          f"{scores.min():.4f} to {scores.max():.4f}; no id dropped")
    print(f"  launches during the run: dot_interaction "
          f"{launches['dot_interaction']} (= {steps} predicts), "
          f"dot_interaction_ref {launches['dot_interaction_ref']}: {launches}")

    # ---- (c) one bulk predict, and its parts
    bulk = {k: v for k, v in next(dlrm_batches(
        seed=3, batch=DLRM_BULK, rows=mcfg.rows)).items() if k != "label"}
    tr.predict(bulk)                      # the first call at this shape
    before = tr.serve_metrics()["serve_lookups"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tr.predict(bulk)                # ends in the scores' copy to host
    wall_ms = (time.perf_counter() - t0) * 1e3
    looked = tr.serve_metrics()["serve_lookups"] - before
    if out.shape != (DLRM_BULK,) or not (
            np.isfinite(out).all() and ((out > 0) & (out < 1)).all()):
        raise AssertionError("a bulk score is not a finite value in (0, 1)")
    if looked != DLRM_BULK * mcfg.n_sparse:
        raise AssertionError("the bulk predict dropped ids")
    print(f"  phase 10 (c): one predict of {DLRM_BULK}: wall {wall_ms:.2f} "
          f"ms ({DLRM_BULK / wall_ms * 1e3:.1f} instances/s), no id "
          "dropped")
    _dlrm_breakdown(tr, bulk)
    del tr, warm, server
    _release()
    return launches


def phase_dlrm_agreement(device):
    """Phase 10 (d): DLRM served at smoke size on the card and on the CPU
    from one state, the same requests; scores within phase 6's
    tolerance."""
    from repro_torch import tree_map
    from repro_torch.configs import dlrm_mlperf
    from repro_torch.data.synthetic import dlrm_batches
    from repro_torch.interop import ReferenceState
    from repro_torch.models import recsys as R
    from repro_torch.runtime.factory import (
        build_ctr_server,
        build_dlrm_engine,
        build_trainer,
    )
    from repro_torch.runtime.trainer import HybridTrainer, TrainerConfig

    smoke = dlrm_mlperf.SMOKE
    tcfg = TrainerConfig(placement="gather", capacity=32)
    gpu = build_trainer("dlrm-mlperf", tcfg, seed=3, device=device)
    state = ReferenceState(
        dense=tree_map(lambda x: x.cpu(), gpu.dense),
        tables={n: t.cpu() for n, t in gpu.tables.items()},
        accum={n: a.cpu() for n, a in gpu.sparse_state.accum.items()})
    cpu = HybridTrainer(None, build_dlrm_engine(smoke, tcfg, device="cpu"),
                        R.dlrm_embed_from_workings(smoke),
                        R.dlrm_hybrid_loss(smoke), tcfg, state=state,
                        device="cpu")
    stream = dlrm_batches(seed=4, batch=64, rows=smoke.rows)
    batches = [next(stream) for _ in range(3)]
    batches[-1] = {k: v[:10] for k, v in batches[-1].items()}
    got = []
    for tr in (gpu, cpu):
        server = build_ctr_server(tr, max_batch=64)
        for b in batches:
            server.submit_batch(b)
        reqs = list(server.pending)
        server.drain()
        got.append(np.array([r.score for r in reqs]))
    np.testing.assert_allclose(got[0], got[1], **TOL)
    print(f"phase 10 (d): dlrm-mlperf at smoke size, card vs CPU from one "
          f"state (capacity 32: some ids drop, a padded tail): "
          f"{got[0].size} scores, max |diff| "
          f"{np.abs(got[0] - got[1]).max():.3g} (rtol = atol = 1e-5)")


# ------------------------------------------------------- DLRM training
DLRM_TRAIN_BATCH = 65536   # recsys_shapes()["train_batch"]
DLRM_TRAIN_STEPS = 40      # two merges at k 20
DLRM_BWD_SHAPES = ((32768, 27, 128), (512, 27, 128))   # one pod's; serve_p99


def _dot_backward_times(g, feats):
    """Kernel 8b's times (cold and warm L2), its plain version's, the
    library call's (``bmm`` of the symmetrised (B, F, F) matrix with
    ``feats``) with the scatter that builds the matrix beside it, and its
    bound at ``(g, feats)``."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.dot_interaction import (
        dot_interaction_backward_cuda,
    )

    B, F, D = feats.shape
    P = F * (F - 1) // 2
    li, lj = torch.tril_indices(F, F, offset=-1, device=feats.device)
    lower, upper = li * F + lj, lj * F + li

    def scatter():
        m = torch.zeros((B, F * F), dtype=feats.dtype, device=feats.device)
        m.index_copy_(1, lower, g)
        m.index_copy_(1, upper, g)
        return m.reshape(B, F, F)

    m = scatter()

    def library():
        return torch.bmm(m, feats)

    def kernel():
        return dot_interaction_backward_cuda(g, feats)

    tol = 1e-5 if feats.dtype == torch.float32 else 2e-2
    if not torch.allclose(library().float(), kernel().float(), atol=tol * F,
                          rtol=4 * tol):
        raise AssertionError(f"dot_interaction_backward {tuple(feats.shape)}"
                             ": the library call and the kernel differ")
    elem = feats.element_size()
    nbytes = (2 * B * F * D + B * P) * elem
    bound_ms, bound_by = _bound(nbytes, 2 * B * F * (F - 1) * D)
    return {
        "shape": [B, F, D], "dtype": str(feats.dtype).split(".")[-1],
        "ms": _time_ms(kernel), "ms_l2_warm": _time_ms(kernel, cold_l2=False),
        "plain_ms": _time_ms(
            lambda: ref.dot_interaction_backward_ref(g, feats)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": _time_ms(library), "library_scatter_ms":
            _time_ms(scatter), "mb": nbytes / 1e6,
    }


def _dot_backward_sass_report():
    """Phase 12 (a): kernel 8b's kernels in the extension that ran
    (``_sass_report``): the four instantiations of the general one, keyed
    "dot_interaction_backward<T, M>" (T the element type, M whether M =
    G + G^T is staged in shared memory), and DLRM's persistent one,
    "dot_interaction_backward_pipe"."""
    import re

    def short(mangled):
        if "dot_interaction_backward_pipe_kernel" in mangled:
            return "dot_interaction_backward_pipe"
        m = re.search(r"dot_interaction_backward_kernelI(f|13__nv_bfloat16)"
                      r"Lb([01])E", mangled)
        return m and (f"dot_interaction_backward<"
                      f"{'float' if m.group(1) == 'f' else 'bf16'}, "
                      f"{'staged' if m.group(2) == '1' else 'global'}>")

    report, usage = _sass_report(short)
    if len(report) != 5:
        raise AssertionError(f"kernel 8b instantiations: {sorted(report)}; "
                             f"cuobjdump -res-usage began:\n{usage[:3000]}")
    return report


def phase_dot_backward(device):
    """Phase 12 (a): kernel 8b against its plain version, and timed, at one
    pod's training shape and the serving shape; returns its kernels-line
    entry (without ``launches``): the training shape, with the serving
    shape under ``small``."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.dot_interaction import (
        dot_interaction_backward_cuda,
    )

    gen = torch.Generator(device).manual_seed(53)
    cases = [(shape, dtype) for dtype in (torch.float32, torch.bfloat16)
             for shape in DLRM_BWD_SHAPES]
    cases += [((33, 13, 17), torch.float32), ((512, 2, 128), torch.float32),
              ((512, 1, 128), torch.float32)]
    print("phase 12 (a): dot_interaction_backward (kernel 8b) against its "
          "plain version (tolerance: f32 atol 1e-5 F, rtol 4e-5; bf16 atol "
          "2e-2 F, rtol 8e-2)")
    max_err, max_err_bf16, times = 0.0, 0.0, []
    for (B, F, D), dtype in cases:
        feats = torch.randn((B, F, D), generator=gen, device=device).to(dtype)
        g = torch.randn((B, F * (F - 1) // 2), generator=gen,
                        device=device).to(dtype)
        got = dot_interaction_backward_cuda(g, feats)
        again = dot_interaction_backward_cuda(g, feats)
        torch.cuda.synchronize()
        want = ref.dot_interaction_backward_ref(g, feats)
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        err = (got.float() - want.float()).abs().max().item()
        if (got.shape != want.shape or got.dtype != dtype
                or not torch.equal(got, again)
                or not torch.allclose(got.float(), want.float(),
                                      atol=tol * F, rtol=4 * tol)):
            raise AssertionError(f"dot_interaction_backward {(B, F, D)} "
                                 f"{dtype}: kernel and plain version differ "
                                 f"(max |diff| {err}) or two runs differ")
        if dtype == torch.float32:
            max_err = max(max_err, err)
        else:
            max_err_bf16 = max(max_err_bf16, err)
        print(f"  {(B, F, D)} {str(dtype).split('.')[-1]}: output "
              f"{tuple(got.shape)}, max |kernel - plain| {err:.3g}, two runs "
              f"bit-equal")
        if (B, F, D) in DLRM_BWD_SHAPES:
            times.append(_dot_backward_times(g, feats))
    for t in times:
        print(f"  times {tuple(t['shape'])} {t['dtype']} (ms): kernel "
              f"{t['ms']:.4f} cold, {t['ms_l2_warm']:.4f} warm; plain "
              f"{t['plain_ms']:.4f}; library (bmm) {t['library_ms']:.4f}, "
              f"the scatter that builds its matrix "
              f"{t['library_scatter_ms']:.4f}; bound {t['bound_ms']:.4f} "
              f"({t['mb']:.2f} MB, {t['bound_by']})")
    sass = _dot_backward_sass_report()
    _print_sass(sass)
    train, serve = times[0], times[1]
    keys = ("shape", "dtype", "ms", "ms_l2_warm", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_scatter_ms")
    return {
        "name": "dot_interaction_backward",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dot_interaction.cu",
        "replaces": "src/repro/kernels/ops.py:128 (XLA vjp of "
                    "src/repro/models/recsys.py:79, no Pallas kernel)",
        "launches": None,
        "max_abs_err": max_err,
        "max_abs_err_bf16": max_err_bf16,
        **{k: train[k] for k in keys},
        "small": {k: serve[k] for k in keys},
        "bf16": {k: times[2][k] for k in keys},
        "sass": sass,
    }


def _dlrm_train_config(**kw):
    """The launcher's training settings (n_pod 2, k 20, two_phase, lr 1e-3,
    initial accumulator 0.01) with sparse lr 0.1, the value of the
    reference's own DLRM training tests (``tests/test_smoke_archs.py``):
    at batch 65536 the launcher's 0.5 makes the losses non-finite after
    the first merge, in the reference as in the port (ROADMAP.md §C)."""
    from repro_torch.core.kstep import KStepConfig
    from repro_torch.core.sparse_optim import SparseAdagradConfig
    from repro_torch.runtime.trainer import TrainerConfig

    return TrainerConfig(
        n_pod=2, kstep=KStepConfig(lr=1e-3, k=20, merge="two_phase"),
        sparse=SparseAdagradConfig(lr=0.1, initial_accumulator=0.01),
        log_every=10, **kw)


DLRM_PARTS = ("pull (stage + 26 dedups + gathers)",
              "forward (26 takes by kernel 1 + tower, kernel 8)",
              "backward (kernels 8b, 1b + autograd)", "k-step Adam",
              "push (26 pushes)")


def phase_dlrm_train(device):
    """Phase 12: dlrm-mlperf trained at full width, 40 ``fit_online`` steps
    of 65536 on the gather placement; returns the launch counts of the
    run."""
    import torch

    from repro_torch.configs import dlrm_mlperf
    from repro_torch.data.synthetic import dlrm_batches
    from repro_torch.kernels import ops
    from repro_torch.runtime.factory import build_trainer
    from repro_torch.runtime.online import fit_online

    mcfg = dataclasses.replace(dlrm_mlperf.MODEL, rows=tuple(
        min(r, DLRM_ROW_CAP) for r in dlrm_mlperf.MODEL.rows))
    t0 = time.perf_counter()
    tr = build_trainer("dlrm-mlperf", _dlrm_train_config(
        placement="gather", capacity=DLRM_TRAIN_BATCH), smoke=False,
        model_cfg=mcfg, seed=0, device=device)
    torch.cuda.synchronize()
    state_gb = sum(t.numel() * t.element_size() for t in
                   list(tr.tables.values())
                   + list(tr.sparse_state.accum.values())) / 1e9
    print(f"phase 12: dlrm-mlperf training at full width (embed 128, bottom "
          f"MLP 13-512-256-128, top MLP {mcfg.interact_dim}-1024-1024-512-"
          f"256-1, f32), 26 tables of {sum(mcfg.rows)} rows (each capped at "
          f"{DLRM_ROW_CAP}), batch {DLRM_TRAIN_BATCH}, capacity "
          f"{tr.engine.capacity}, n_pod {tr.n_pod}, k {tr.cfg.kstep.k}, "
          f"merge {tr.cfg.kstep.merge}, sparse lr {tr.cfg.sparse.lr}; "
          f"trainer built in "
          f"{time.perf_counter() - t0:.1f} s, table + accumulator "
          f"{state_gb:.2f} GB on the card")
    stream = dlrm_batches(seed=1, batch=DLRM_TRAIN_BATCH, rows=mcfg.rows)
    batches = [next(stream) for _ in range(DLRM_TRAIN_STEPS + 12)]
    run, extra = batches[:DLRM_TRAIN_STEPS], batches[DLRM_TRAIN_STEPS:]
    step_losses = []
    train_step = tr.train_step

    def recorded(b):
        loss = train_step(b)
        step_losses.append(loss)
        return loss

    tr.train_step = recorded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    hist, online_auc = fit_online(tr, iter(run), DLRM_TRAIN_STEPS, window=20)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del tr.train_step
    every = torch.stack(step_losses).cpu().numpy()
    n = DLRM_TRAIN_STEPS
    if every.shape != (n,) or not np.isfinite(every).all():
        raise AssertionError(f"a loss is not finite: {every}")
    if tr.overflow_dropped != 0:
        raise AssertionError(f"overflow_dropped {tr.overflow_dropped}")
    want = dict.fromkeys(ops.launches, 0)
    want.update({"dot_interaction": n * (tr.n_pod + 1),   # + the predicts
                 "dot_interaction_backward": n * tr.n_pod,
                 "embedding_bag": n * (tr.n_pod + 1) * mcfg.n_sparse,
                 "embedding_bag_backward": n * tr.n_pod * mcfg.n_sparse,
                 "sparse_adagrad_apply": n * mcfg.n_sparse,
                 "fused_adam": n - n // tr.cfg.kstep.k})   # local steps
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    print(f"  losses at steps 1/2/10/20/30/40: "
          f"{', '.join(f'{every[i]:.6f}' for i in (0, 1, 9, 19, 29, 39))} "
          f"(all {n} finite, {every.min():.4f} to {every.max():.4f}); online "
          f"AUC {online_auc:.4f}; overflow_dropped 0")
    print(f"  predict + train per step (fit_online wall / {n}): "
          f"{wall / n * 1e3:.2f} ms ({n * DLRM_TRAIN_BATCH / wall:.1f} "
          f"instances/s trained); peak device memory {peak_gb:.2f} GB")
    print(f"  launches during the run: dot_interaction_backward "
          f"{launches['dot_interaction_backward']} (= n_pod x {n}), "
          f"dot_interaction {launches['dot_interaction']} (+ {n} predicts), "
          f"every _ref 0: {launches}")
    # the PR 15 lesson: no host-to-device copy in the forward or backward
    b = tr._stage(extra[0])
    wss, _, _, _ = tr.engine.pull_batch(tr.tables, tr.sparse_state.accum,
                                        tr.backend_state, b)

    def fwd_bwd():
        dense, workings, losses = tr._forward(wss, tr.pod_batch(b))
        tr._backward(dense, workings, losses)

    h2d, syncs, kernels = _transfers(fwd_bwd)
    if h2d:
        raise AssertionError(f"a step's forward and backward made {h2d} "
                             "host-to-device copies")
    print(f"  one step's forward and backward (profiler): {kernels} kernel "
          f"launches, 0 host-to-device copies, {syncs} synchronizing calls")
    del wss, b
    _train_breakdown(tr, extra, names=DLRM_PARTS)
    del tr, batches, run, extra
    _release()
    return launches


def phase_dlrm_train_smoke(device):
    """Phase 12 (b) and (c): DLRM training at smoke size on the card: two
    runs and the cached full mirror bit-equal to gather; card against CPU
    from one state."""
    import torch

    from repro_torch import tree_map
    from repro_torch.configs import dlrm_mlperf
    from repro_torch.core.kstep import KStepAdamState, KStepConfig, leaves
    from repro_torch.data.synthetic import dlrm_batches
    from repro_torch.interop import ReferenceState
    from repro_torch.models import recsys as R
    from repro_torch.runtime.factory import build_dlrm_engine, build_trainer
    from repro_torch.runtime.online import fit_online
    from repro_torch.runtime.trainer import HybridTrainer, TrainerConfig

    smoke = dlrm_mlperf.SMOKE

    def cfg(placement="gather", cache_rows=None):
        return TrainerConfig(n_pod=2, kstep=KStepConfig(k=2), log_every=1,
                             placement=placement, cache_rows=cache_rows)

    def run(tr, steps=6):
        losses = []
        step = tr.train_step
        tr.train_step = lambda b: losses.append(step(b)) or losses[-1]
        fit_online(tr, dlrm_batches(seed=5, batch=64, rows=smoke.rows),
                   steps, window=5)
        del tr.train_step
        tables, accum, _ = tr.engine.flush(tr.tables, tr.sparse_state.accum,
                                           tr.backend_state)
        return (torch.stack(losses).cpu(),
                torch.cat([t.reshape(-1).cpu() for t in
                           tr.engine.export(tables).values()]),
                torch.cat([a.reshape(-1).cpu() for a in accum.values()]),
                torch.cat([x.reshape(-1).cpu() for x in leaves(tr.dense)]))

    # ---- (b) two runs, and the cached full mirror, bit-equal to gather
    first = run(build_trainer("dlrm-mlperf", cfg(), seed=3, device=device))
    second = run(build_trainer("dlrm-mlperf", cfg(), seed=3, device=device))
    mirror = run(build_trainer("dlrm-mlperf", cfg("cached", 256), seed=3,
                               device=device))
    for what, other in (("a second run", second), ("cached", mirror)):
        if not all(torch.equal(a, b) for a, b in zip(first, other)):
            raise AssertionError(f"DLRM training: {what} differs from gather")
    print(f"phase 12 (b): dlrm-mlperf at smoke size on the card, 6 steps: "
          f"a second run and the cached full mirror (cache_rows 256) "
          f"bit-equal to gather (losses, tables, accumulators, dense); "
          f"losses {first[0][0]:.6f} ... {first[0][-1]:.6f}")

    # ---- (c) card against CPU from one state
    gpu = build_trainer("dlrm-mlperf", cfg(), seed=4, device=device)
    cpu_of = lambda x: x.cpu().clone()    # the trainers update in place
    s = gpu.opt_state
    state = ReferenceState(
        dense=tree_map(cpu_of, gpu.dense),
        tables={n: cpu_of(t) for n, t in gpu.tables.items()},
        accum={n: cpu_of(a) for n, a in gpu.sparse_state.accum.items()},
        opt_state=KStepAdamState(cpu_of(s.step), tree_map(cpu_of, s.m),
                                 tree_map(cpu_of, s.v_local),
                                 tree_map(cpu_of, s.v_hat), None))
    cpu = HybridTrainer(None, build_dlrm_engine(smoke, cfg(), device="cpu"),
                        R.dlrm_embed_from_workings(smoke),
                        R.dlrm_hybrid_loss(smoke), cfg(), state=state,
                        device="cpu")
    out = [run(tr) for tr in (gpu, cpu)]
    tol = dict(rtol=1e-4, atol=1e-6)
    for what, a, b in zip(("losses", "tables", "accumulators", "dense"),
                          *out):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=what,
                                   **tol)
    print("phase 12 (c): dlrm-mlperf at smoke size, 6 steps, card vs CPU "
          "from one state: max |diff| " + ", ".join(
              f"{w} {np.abs(a.numpy() - b.numpy()).max():.3g}" for w, a, b in
              zip(("losses", "tables", "accumulators", "dense"), *out))
          + " (rtol 1e-4, atol 1e-6)")


# --------------------------------------------------------- the LM prefill
LM_BATCH, LM_SEQ = 4, 4096  # the path's prefill: 4 x 4096 tokens
LM_LONG = 32768            # lm_shapes()["prefill_32k"]'s seq, batch 32 -> 1
LM_PREFIX = 4096           # the causal check's prefix of the long run
LM_PREFILLS = 3            # timed prefills
LM_SEED = 0
# kernel 9's two kernels (bf16, f32), as their mangled names hold them
FLASH_KERNELS = ("flash_attention_mma_kernel", "flash_attention_kernel")
FLASH_TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
             "bfloat16": dict(atol=4e-3, rtol=8e-3)}


def _flash_times(q, k, v, causal=True, iters=10):
    """Kernel 9's times (cold and warm L2), its plain version's,
    ``F.scaled_dot_product_attention``'s (timed only: the port never calls
    it) and its bound at ``q, k, v``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    B, S, H, hd = q.shape
    dtype = str(q.dtype).split(".")[-1]

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, enable_gqa=True)

    def kernel():
        return flash_attention_cuda(q, k, v, causal)

    got = kernel()
    lib = library().transpose(1, 2)
    if not torch.allclose(lib.float(), got.float(),
                          atol=2e-2 if dtype == "bfloat16" else 1e-3):
        raise AssertionError(f"flash_attention {tuple(q.shape)} {dtype}: "
                             "SDPA and the kernel differ")
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * B * H * hd * pairs
    bound_ms, bound_by = _bound(nbytes, flops, BF16_FLOP_PER_S
                                if dtype == "bfloat16" else F32_FLOP_PER_S)
    return {
        "shape": [B, S, H, k.shape[2], hd], "dtype": dtype,
        "ms": _time_ms(kernel, iters=iters, warmup=2),
        "ms_l2_warm": _time_ms(kernel, iters=iters, warmup=2, cold_l2=False),
        "plain_ms": _time_ms(lambda: ref.flash_attention_ref(q, k, v, causal),
                             iters=max(2, iters // 2), warmup=1),
        "library_ms": _time_ms(library, iters=iters, warmup=2),
        "bound_ms": bound_ms, "bound_by": bound_by, "gflop": flops / 1e9,
        "mb": nbytes / 1e6,
    }


def _sass_report(short):
    """Each kernel of the extension that ran whose mangled name ``short``
    maps to a short name, from ``cuobjdump -res-usage`` and ``cuobjdump
    -sass`` of its shared library: registers, stack frame bytes,
    local-memory stores and loads (``STL``, ``LDL``: spills or an array in
    local memory) and tensor-core instructions (``HMMA``)."""
    import re

    from torch.utils.cpp_extension import CUDA_HOME

    from repro_torch.kernels.build import extension

    tool = str(pathlib.Path(CUDA_HOME) / "bin" / "cuobjdump")
    lib = extension().__file__

    def dump(flag):
        return subprocess.run([tool, flag, lib], check=True,
                              capture_output=True, text=True,
                              timeout=300).stdout

    usage = dump("-res-usage")
    report = {}
    for m in re.finditer(r"Function (\w+):\s+REG:(\d+)\s+STACK:(\d+)",
                         usage):
        name = short(m.group(1))
        if name:
            report[name] = {"registers": int(m.group(2)),
                            "stack_bytes": int(m.group(3))}
    for chunk in dump("-sass").split("Function : ")[1:]:
        name = short(chunk.split(None, 1)[0])
        if name in report:
            report[name].update(stl=len(re.findall(r"\bSTL\b", chunk)),
                                ldl=len(re.findall(r"\bLDL\b", chunk)),
                                hmma=len(re.findall(r"\bHMMA\b", chunk)))
    return report, usage


def _print_sass(report):
    for name, r in sorted(report.items()):
        print(f"  cuobjdump {name}: {r['registers']} registers, stack "
              f"{r['stack_bytes']} B, {r['stl']} STL, {r['ldl']} LDL "
              f"(local-memory stores and loads), {r['hmma']} HMMA in its "
              f"SASS")


def _bag_dot_sass_report():
    """Phase 1: the bag backward's and kernel 8's instantiations in the
    extension that ran (``_sass_report``).  Keys: "bag_backward<C>" (the
    short rows' kernel, C columns a lane), "bag_backward_long" (the long
    rows' kernel) and "dot_interaction<T>" (T the element type)."""
    import re

    def short(mangled):
        if "embedding_bag_backward_long_kernel" in mangled:
            return "bag_backward_long"
        m = re.search(r"embedding_bag_backward_kernelILi(\d+)E", mangled)
        if m:
            return f"bag_backward<{m.group(1)}>"
        m = re.search(r"dot_interaction_kernelI(f|13__nv_bfloat16)E",
                      mangled)
        return m and ("dot_interaction<float>" if m.group(1) == "f"
                      else "dot_interaction<bf16>")

    report, usage = _sass_report(short)
    want = {f"bag_backward<{c}>" for c in (1, 2, 4, 8)} | {
        "bag_backward_long", "dot_interaction<float>",
        "dot_interaction<bf16>"}
    if set(report) != want:
        raise AssertionError(f"bag backward and kernel 8 instantiations: "
                             f"{sorted(report)}; cuobjdump -res-usage "
                             f"began:\n{usage[:3000]}")
    _print_sass(report)
    return report


def _bag_probe_sass_report():
    """Phase 1: the bag forward's walk, the index streams' kernels (shared
    with the backward) and the probe's instantiations in the extension
    that ran (``_sass_report``).  Keys: "bag_walk<L,V,W>" (L lanes a bag, V
    loads a lane of W floats), "streams_<count|scan|place|rank>" and
    "hash_lookup<G>" (G buckets a load)."""
    import re

    def short(mangled):
        m = re.search(r"embedding_bag_walk_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
                      mangled)
        if m:
            return f"bag_walk<{m.group(1)},{m.group(2)},{m.group(3)}>"
        m = re.search(r"stream_(count|scan|place|rank)_kernel", mangled)
        if m:
            return f"streams_{m.group(1)}"
        m = re.search(r"hash_lookup_kernelILi(\d+)E", mangled)
        return m and f"hash_lookup<{m.group(1)}>"

    report, usage = _sass_report(short)
    want = ({f"bag_walk<{l},1,4>" for l in (4, 8, 16, 32)}
            | {"bag_walk<32,2,4>"}
            | {f"bag_walk<32,{v},1>" for v in (1, 2, 4, 8)}
            | {f"streams_{k}" for k in ("count", "scan", "place", "rank")}
            | {"hash_lookup<4>", "hash_lookup<1>"})
    if set(report) != want:
        raise AssertionError(f"bag forward, streams and probe "
                             f"instantiations: {sorted(report)}; cuobjdump "
                             f"-res-usage began:\n{usage[:3000]}")
    _print_sass(report)
    return report


def _flash_sass_report():
    """Phase 11 (a): each instantiation of kernel 9 (``_sass_report``).
    Keys: "mma<HDP>" (bf16) and "fma<HDP>" (float32), HDP the padded head
    width, and "mma<HDP,local>", "fma<HDP,local>" for the kernels with the
    window and chunk terms."""
    import re

    def short(mangled):
        m = re.search(r"flash_attention_(mma_)?kernelI(?:f)?Li(\d+)ELb([01])E",
                      mangled)
        return m and (f"{'mma' if m.group(1) else 'fma'}<{m.group(2)}"
                      f"{',local' if m.group(3) == '1' else ''}>")

    report, usage = _sass_report(short)
    if sorted(report) != sorted(f"{k}<{w}{local}>" for k in ("fma", "mma")
                                for w in (64, 128, 256)
                                for local in ("", ",local")):
        raise AssertionError(f"kernel 9's instantiations: "
                             f"{sorted(report)}; cuobjdump -res-usage "
                             f"began:\n{usage[:3000]}")
    for name, r in sorted(report.items()):
        if "hmma" not in r or (r["hmma"] > 0) != name.startswith("mma"):
            raise AssertionError(f"kernel 9 {name}: SASS report {r}")
    _print_sass(report)
    return report


def phase_flash_attention(device):
    """Phase 11 (a): kernel 9 against its plain version on the card, and
    timed; returns its kernels-line entry (without ``launches``): the
    path's shape (4, 4096) bf16, with (1, 4096) in bf16 and f32 under
    ``one_sequence``."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (bf16_ulps,
                                                     flash_attention_cuda)

    gen = torch.Generator(device).manual_seed(53)
    # (B, S, H, Kv, hd), dtype, causal, timed
    cases = [((LM_BATCH, LM_SEQ, 40, 8, 128), torch.bfloat16, True, True),
             ((1, LM_SEQ, 40, 8, 128), torch.bfloat16, True, True),
             ((1, LM_SEQ, 40, 8, 128), torch.float32, True, True),
             ((2, 64, 8, 2, 16), torch.float32, True, False),
             ((2, 64, 8, 2, 16), torch.float32, False, False),
             ((1, 1000, 40, 8, 128), torch.bfloat16, True, False),
             ((2, 96, 4, 2, 32), torch.float32, True, False)]
    print("phase 11 (a): flash_attention (kernel 9) against its plain "
          "version (tolerance: f32 atol = rtol = 1e-5; bf16 atol 4e-3, "
          "rtol 8e-3, one bf16 rounding of the same float32 math, and every "
          "element within one bf16 ulp, as flash_attention.bf16_ulps "
          "measures it)")
    sass = _flash_sass_report()
    max_err, max_err_bf16, max_ulps, times = 0.0, 0.0, 0.0, []
    for (B, S, H, Kv, hd), dtype, causal, timed in cases:
        q = torch.randn((B, S, H, hd), generator=gen, device=device).to(dtype)
        k, v = [torch.randn((B, S, Kv, hd), generator=gen,
                            device=device).to(dtype) for _ in range(2)]
        got = flash_attention_cuda(q, k, v, causal)
        again = flash_attention_cuda(q, k, v, causal)
        torch.cuda.synchronize()
        want = ref.flash_attention_ref(q, k, v, causal)
        name = str(dtype).split(".")[-1]
        err = (got.float() - want.float()).abs().max().item()
        if (got.shape != want.shape or got.dtype != dtype
                or not torch.equal(got, again)
                or not torch.allclose(got.float(), want.float(),
                                      **FLASH_TOL[name])):
            raise AssertionError(f"flash_attention {(B, S, H, Kv, hd)} "
                                 f"{name} causal {causal}: kernel and plain "
                                 f"version differ (max |diff| {err}) or two "
                                 "runs differ")
        ran = _graph_kernels(lambda: flash_attention_cuda(q, k, v, causal),
                             FLASH_KERNELS)
        if ran != ([1, 0] if dtype == torch.bfloat16 else [0, 1]):
            raise AssertionError(f"flash_attention {name}: its graph holds "
                                 f"{ran[0]} {FLASH_KERNELS[0]} and {ran[1]} "
                                 f"{FLASH_KERNELS[1]}")
        ran = FLASH_KERNELS[ran.index(1)]
        ulps = ""
        if dtype == torch.bfloat16:
            u = bf16_ulps(got, want)
            # the same in the element's own ulp, for the record: elements
            # far below their row's scale differ by more (bf16_ulps' doc)
            w = want.float()
            own = ((got.float() - w).abs() / torch.ldexp(
                torch.ones_like(w),
                torch.frexp(w.abs().clamp_min(2.0 ** -126))[1] - 8))
            n_off = int((u > 1).sum().item())
            ulps = (f", max {u.max().item():.3g} bf16 ulps, {n_off} elements "
                    f"more than one ulp off (in the element's own ulp: max "
                    f"{own.max().item():.4g}, {int((own > 1).sum().item())} "
                    f"of {w.numel()})")
            max_ulps = max(max_ulps, u.max().item())
            del u, w, own
            if n_off:
                raise AssertionError(f"flash_attention {(B, S, H, Kv, hd)} "
                                     f"bf16: {n_off} elements more than one "
                                     "bf16 ulp from the plain version")
        del want
        if dtype == torch.float32:
            max_err = max(max_err, err)
        else:
            max_err_bf16 = max(max_err_bf16, err)
        print(f"  {(B, S, H, Kv, hd)} {name} causal {causal}, {ran} (its "
              f"graph): max |kernel - plain| {err:.3g}{ulps}, two runs "
              "bit-equal")
        if timed:
            times.append(_flash_times(q, k, v, causal))
        del q, k, v, got, again
        _release()
    for t in times:
        print(f"  times {tuple(t['shape'])} {t['dtype']} causal (ms): kernel "
              f"{t['ms']:.4f} cold, {t['ms_l2_warm']:.4f} warm "
              f"({t['gflop'] / t['ms']:.2f} TFLOP/s cold); plain "
              f"{t['plain_ms']:.4f}; library (SDPA, is_causal, enable_gqa) "
              f"{t['library_ms']:.4f}; bound {t['bound_ms']:.4f} "
              f"({t['gflop']:.1f} GFLOP, {t['mb']:.1f} MB, {t['bound_by']})")
    path = times[0]
    keys = ("shape", "dtype", "ms", "ms_l2_warm", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:79",
        "launches": None,
        "max_abs_err": max_err,
        "max_abs_err_bf16": max_err_bf16,
        "max_ulps_bf16": max_ulps,
        "sass": sass,
        **{k: path[k] for k in keys},
        "one_sequence": [{k: t[k] for k in keys} for t in times[1:]],
    }


def _lm_breakdown(params, tokens, cfg, want):
    """Phase 11 (b): one prefill's stream time by part (CUDA events around
    each part of each layer, summed over the layers); its logits must be
    ``want``'s bits (the same calls as ``prefill``)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.models.common import rms_norm

    events = []

    def timed(part, fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        events.append((part, start, end))
        return out

    B, S = tokens.shape
    x = timed("embed", lambda: params["embed"].index_select(
        0, tokens.reshape(-1)).reshape(B, S, -1))
    q_pos = torch.arange(S, dtype=torch.int32, device=tokens.device)
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in params["layers"].items()}
        q, k, v = timed("norms + QKV + qk-norm + rope",
                        lambda: T._qkv(cfg, lp, x, q_pos))
        o = timed("attention (kernel 9)",
                  lambda: ops.flash_attention(q, k, v, causal=True))
        x = timed("o-proj", lambda: x + o.reshape(B, S, -1) @ lp["wo"])
        x = timed("FFN", lambda: T._ffn_block(cfg, lp, x)[0])
    logits = timed("final norm + head", lambda: rms_norm(
        x, params["final_norm"], cfg.norm_eps)[:, -1] @ T._head(params, cfg))
    torch.cuda.synchronize()
    if not torch.equal(logits, want):
        raise AssertionError("the timed parts' logits differ from prefill's")
    parts = {}
    for part, start, end in events:
        parts[part] = parts.get(part, 0.0) + start.elapsed_time(end)
    return parts


def phase_lm(device, cfg=None):
    """Phase 11 (b) and (c): qwen3-14b prefill at full width through
    ``prefill`` (4 x 4096 tokens), then one 32768-token prefill held
    causally against a 4096-token run; returns the launch counts of the
    timed prefills and the weights (phase 13 decodes with them)."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    cfg = cfg or configs.get("qwen3-14b").model_cfg
    t0 = time.perf_counter()
    params = T.init_params(torch.Generator(device).manual_seed(LM_SEED), cfg,
                           device=device)
    torch.cuda.synchronize()
    leaves = [params["embed"], params["final_norm"], params.get("head")]
    leaves += list(params["layers"].values())
    weights_gb = sum(t.numel() * t.element_size() for t in leaves
                     if t is not None) / 1e9
    print(f"phase 11: {cfg.name} prefill at full width ({cfg.n_layers} "
          f"layers, d {cfg.d_model}, {cfg.n_heads} heads over "
          f"{cfg.n_kv_heads} KV heads, hd {cfg.hd}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}, {str(cfg.dtype).split('.')[-1]}), random weights "
          f"from seed {LM_SEED}: {weights_gb:.2f} GB drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(LM_SEED)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (LM_BATCH, LM_SEQ))).to(device)
    n_tok = LM_BATCH * LM_SEQ
    with torch.inference_mode():
        want = T.prefill(params, tokens, cfg)          # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        walls = []
        for _ in range(LM_PREFILLS):
            t0 = time.perf_counter()
            logits = T.prefill(params, tokens, cfg)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        launches = dict(ops.launches)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want_launches = dict.fromkeys(launches, 0)
        want_launches["flash_attention"] = LM_PREFILLS * cfg.n_layers
        if launches != want_launches:
            raise AssertionError(f"launches {launches}, expected "
                                 f"{want_launches}")
        if (logits.shape != (LM_BATCH, cfg.vocab)
                or not torch.isfinite(logits).all().item()):
            raise AssertionError("prefill logits are not finite of shape "
                                 f"{(LM_BATCH, cfg.vocab)}")
        if not torch.equal(logits, want):
            raise AssertionError("two prefills of the same tokens differ")
        wall = float(np.mean(walls))
        print(f"  phase 11 (b): {LM_PREFILLS} prefills of {LM_BATCH} x "
              f"{LM_SEQ} tokens: wall {', '.join(f'{w:.4f}' for w in walls)}"
              f" s (mean {wall:.4f} s, {n_tok / wall:.1f} tokens/s), peak "
              f"memory {peak_gb:.2f} GB; logits {tuple(logits.shape)} "
              f"finite, from {logits.min().item():.4f} to "
              f"{logits.max().item():.4f}, bit-equal across the prefills; "
              f"next tokens {logits.argmax(-1).tolist()}")
        print(f"  launches during the timed prefills: flash_attention "
              f"{launches['flash_attention']} (= {cfg.n_layers} layers x "
              f"{LM_PREFILLS}), flash_attention_ref "
              f"{launches['flash_attention_ref']}, every other counter 0")
        parts = _lm_breakdown(params, tokens, cfg, want)
        total = sum(parts.values())
        print(f"  one prefill, stream time by part (ms, CUDA events, summed "
              f"over {cfg.n_layers} layers): " + ", ".join(
                  f"{k} {v:.3f}" for k, v in parts.items())
              + f"; all parts {total:.3f}")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            again = T.prefill(params, tokens, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if not torch.equal(again, want):
            raise AssertionError("the prefill under the sync debug mode "
                                 "differs")
        h2d, syncs, kernels = _transfers(lambda: T.prefill(params, tokens,
                                                           cfg))
        if h2d or syncs:
            raise AssertionError(f"a prefill made {h2d} host-to-device "
                                 f"copies and {syncs} syncs")
        n_mma, n_fma = _graph_kernels(lambda: T.prefill(params, tokens, cfg),
                                      FLASH_KERNELS)
        if (n_mma, n_fma) != (cfg.n_layers, 0):
            raise AssertionError(f"a prefill's graph holds {n_mma} "
                                 f"{FLASH_KERNELS[0]} and {n_fma} "
                                 f"{FLASH_KERNELS[1]}")
        print(f"  a prefill ran under the sync debug mode 'error'; profiler: "
              f"{kernels} kernel launches, 0 host-to-device copies, 0 "
              f"synchronizing calls; a CUDA graph of a prefill holds {n_mma} "
              f"{FLASH_KERNELS[0]} and {n_fma} {FLASH_KERNELS[1]}")
        del logits, again, want

        # ---- (c) one long prefill, held causally against its prefix
        long_tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab, (1, LM_LONG))).to(device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        x_long, _ = T.trunk(params, long_tokens, cfg)
        torch.cuda.synchronize()
        long_s = time.perf_counter() - t0
        long_peak = torch.cuda.max_memory_allocated() / 1e9
        x_short, _ = T.trunk(params, long_tokens[:, :LM_PREFIX], cfg)
        head = x_long[:, :LM_PREFIX]
        bit_equal = torch.equal(head, x_short)
        diff = (head.float() - x_short.float()).abs().max().item()
        rel = ((head.float() - x_short.float()).norm()
               / x_short.float().norm()).item()
        finite = torch.isfinite(x_long).all().item()
        print(f"  phase 11 (c): one prefill of 1 x {LM_LONG} (prefill_32k's "
              f"sequence, its batch cut from 32 to 1: the FFN activations "
              f"of 32 x {LM_LONG} tokens do not fit one card): trunk in "
              f"{long_s:.2f} s ({LM_LONG / long_s:.1f} tokens/s), peak "
              f"memory {long_peak:.2f} GB, finite {finite}; positions < "
              f"{LM_PREFIX} against a 1 x {LM_PREFIX} run: bit-equal "
              f"{bit_equal} (required), max |diff| {diff:.3g}, relative "
              f"norm {rel:.3g}")
        if not finite or not bit_equal:
            raise AssertionError("the long prefill is not finite or its "
                                 "prefix is not bit-equal to the short run")
    del x_long, x_short, head
    _release()
    return launches, params


def phase_lm_agreement(device):
    """Phase 11 (d): qwen3-14b SMOKE (float32, 2 layers) on the card and on
    the CPU from one state drawn on the CPU; prefill logits within
    atol 5e-5, rtol 1e-5 (float32 products summed in other orders)."""
    import torch

    from repro_torch import configs, tree_map
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    cfg = configs.get("qwen3-14b").smoke_cfg
    cpu = T.init_params(torch.Generator("cpu").manual_seed(7), cfg,
                        device="cpu")
    gpu = tree_map(lambda t: t.to(device), cpu)
    tokens = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab, (2, 300)))
    ops.reset_launches()
    got = T.prefill(gpu, tokens.to(device), cfg)
    torch.cuda.synchronize()
    if ops.launches["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"launches {ops.launches}")
    want = T.prefill(cpu, tokens, cfg)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=5e-5,
                               rtol=1e-5)
    print(f"phase 11 (d): {cfg.name} ({cfg.n_layers} layers, f32), 2 x 300 "
          f"tokens, card vs CPU from one state: logits max |diff| "
          f"{(got.cpu() - want).abs().max().item():.3g} (atol 5e-5, rtol "
          f"1e-5); {cfg.n_layers} kernel launches on the card")


# ------------------------------------------------------ the LM's decode
DECODE_SLOTS = 8           # decode_32k's batch, 128 -> 8 (8 caches fit)
DECODE_LEN = 32768         # lm_shapes()["decode_32k"]'s seq
DECODE_REQUESTS = 16
DECODE_PROMPT = (8, 32)    # prompt lengths, inclusive
DECODE_NEW = 32            # max_new_tokens
DECODE_STEPS = 10          # (b): timed steps on a full cache
DECODE_AGREE = 64          # (c): the prompt decoded against prefill
DECODE_SEED = 0


def _stamp(clock):
    print(f"    [{time.perf_counter() - clock:.1f} s into the phase]",
          flush=True)


def _param_bytes(params):
    leaves = [params["embed"], params["final_norm"], params.get("head")]
    leaves += list(params["layers"].values())
    return sum(t.numel() * t.element_size() for t in leaves if t is not None)


def _cache_bytes(cache):
    return sum(t.numel() * t.element_size() for t in cache.values())


def _decode_bound(params, cache, cfg, batch):
    """(ms, bytes, FLOP): the least time of one ``decode_step`` of
    ``batch`` tokens over the whole cache (its attention masks the empty
    slots but reads them all): every weight it reads once (the embedding
    only its ``batch`` rows), K and V once, the new K and V, ``pos`` and
    the logits written once; its FLOP (2 per multiply-add of every matrix
    it multiplies) at the bf16 peak."""
    Skv, hd = cache["k"].shape[3], cfg.hd
    d, H = cfg.d_model, cfg.n_heads
    emb = params["embed"]
    weights = _param_bytes(params) - emb.numel() * emb.element_size()
    if cfg.tie_embeddings:
        weights += emb.numel() * emb.element_size()
    nbytes = (weights + batch * d * emb.element_size() + _cache_bytes(cache)
              + batch * cfg.vocab * emb.element_size())
    per_layer = (d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
                 + H * hd * d + 3 * d * cfg.d_ff)
    flop = 2 * batch * (cfg.n_layers * per_layer + d * cfg.vocab)
    flop += 4 * batch * cfg.n_layers * H * Skv * hd
    ms = max(nbytes / HBM_BYTES_PER_S, flop / BF16_FLOP_PER_S) * 1e3
    return ms, nbytes, flop


def _counted_server(params, cfg, slots, max_len, record=None):
    """A ``BatchedServer`` whose decode calls are counted (fill steps are
    the calls less ``stats["steps"]``) and whose logits are checked finite
    on the device (a flag, read once at the end); with ``record`` (a list)
    each call's logits are kept."""
    import torch

    from repro_torch.runtime.serve import BatchedServer

    srv = BatchedServer(params, cfg, slots=slots, max_len=max_len)
    decode = srv._decode
    srv.calls = 0
    srv.finite = torch.ones((), dtype=torch.bool,
                            device=params["embed"].device)

    def counted(p, c, t):
        srv.calls += 1
        logits, c = decode(p, c, t)
        srv.finite.logical_and_(torch.isfinite(logits).all())
        if record is not None:
            record.append(logits)
        return logits, c

    srv._decode = counted
    return srv


def _decode_requests(cfg, rng):
    from repro_torch.runtime.serve import Request

    lo, hi = DECODE_PROMPT
    return [Request(prompt=rng.integers(0, cfg.vocab, int(rng.integers(
        lo, hi + 1))).astype(np.int32), max_new_tokens=DECODE_NEW)
        for _ in range(DECODE_REQUESTS)]


def _decode_profile(fn):
    """``fn()`` (one decode step) under the profiler, shapes recorded:
    (host-to-device copies, synchronizing calls, kernel launches, beyond
    what an empty trace records; the largest ``aten::copy_``, in elements
    of its destination: every copy, one inside ``bmm`` or ``contiguous``
    too, ends in one; the device busy share, device ms and wall ms, the
    profiler on; the top kernels, ms each), or the share None when the
    trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def traced(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        return prof.key_averages(group_by_input_shape=True), wall_us

    def counts(ev):
        count = lambda pred: sum(e.count for e in ev if pred(e.key))
        return (count(lambda k: "HtoD" in k),
                count(lambda k: "Synchronize" in k or k == "cudaMemcpy"),
                count(lambda k: k in ("cudaLaunchKernel", "cuLaunchKernel",
                                      "cudaLaunchKernelExC")))

    base, _ = traced(lambda: None)
    ev, wall_us = traced(fn)
    h2d, syncs, launches = (a - b for a, b in zip(counts(ev), counts(base)))
    largest = max([int(np.prod(e.input_shapes[0])) for e in ev
                   if e.key == "aten::copy_" and e.input_shapes
                   and e.input_shapes[0]] or [0])
    kernels = [e for e in ev
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.key] = by_name.get(e.key, 0.0) + e.self_device_time_total
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    share = busy_us / wall_us if busy_us > 0 else None
    return (h2d, syncs, launches, largest, share, busy_us / 1e3,
            wall_us / 1e3, [(k[:48], v / 1e3) for k, v in top])


def _decode_breakdown(params, cache, tokens, cfg):
    """Phase 13 (b): one decode step's stream time by part (CUDA events
    around each part of each layer, summed over the layers), the same
    calls as ``decode_step``; returns (parts, logits)."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.models.common import rms_norm

    events = []

    def timed(part, fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        events.append((part, start, end))
        return out

    embed = params["embed"]
    tokens = tokens.to(embed.device, non_blocking=True)
    B = tokens.shape[0]
    ck_all, cv_all, pos, t = cache["k"], cache["v"], cache["pos"], cache["t"]
    Skv = ck_all.shape[3]

    def prep():
        write_idx = torch.remainder(t, Skv).to(torch.int64)
        pos.index_copy_(0, write_idx.reshape(1), t.reshape(1))
        x = embed.index_select(0, tokens.reshape(-1)).reshape(B, 1, -1)
        return write_idx, pos >= 0, x

    write_idx, kv_valid, x = timed("embed + pos", prep)
    q_pos = t.reshape(1)
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in params["layers"].items()}
        q, kx, vx = timed("norms + QKV + qk-norm + rope",
                          lambda: T._qkv(cfg, lp, x, q_pos))

        def attend():
            T._write_kv(ck_all[i], cv_all[i], kx, vx, write_idx)
            return T._sdpa_dense(cfg, i, q, ck_all[i], cv_all[i], q_pos, pos,
                                 kv_valid)

        o = timed("KV write + attention", attend)
        x = timed("o-proj", lambda: x + o.reshape(B, 1, -1) @ lp["wo"])
        x = timed("FFN", lambda: T._ffn_block(cfg, lp, x)[0])
    logits = timed("final norm + head", lambda: (rms_norm(
        x, params["final_norm"], cfg.norm_eps) @ T._head(params, cfg))[:, 0])
    t.add_(1)
    torch.cuda.synchronize()
    parts = {}
    for part, start, end in events:
        parts[part] = parts.get(part, 0.0) + start.elapsed_time(end)
    return parts, logits


def phase_decode(device, params, cfg=None):
    """Phase 13 (a) and (b): the ``BatchedServer`` at full width over
    ``DECODE_SLOTS`` slots of ``DECODE_LEN`` positions, twice, then
    ``decode_step`` on a full cache; ``params`` are phase 11's weights."""
    import torch

    from repro_torch import configs
    from repro_torch.models import transformer as T

    cfg = cfg or configs.get("qwen3-14b").model_cfg
    clock = time.perf_counter()
    weights = _param_bytes(params)
    print(f"phase 13: {cfg.name} decode at full width through the "
          f"BatchedServer ({DECODE_SLOTS} slots of {DECODE_LEN} positions: "
          f"decode_32k, its batch cut from 128 to {DECODE_SLOTS}), phase "
          f"11's {weights / 1e9:.2f} GB of weights; "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated at the "
          f"start")
    runs = []
    for run in range(2):
        requests = _decode_requests(cfg, np.random.default_rng(DECODE_SEED))
        srv = _counted_server(params, cfg, DECODE_SLOTS, DECODE_LEN)
        cache_b = _cache_bytes(srv.cache)
        for r in requests:
            srv.submit(r)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        stats = srv.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        runs.append([r.out for r in requests])
        n_tok = stats["decoded_tokens"]
        if (any(len(o) != DECODE_NEW for o in runs[-1])
                or n_tok != DECODE_REQUESTS * DECODE_NEW):
            raise AssertionError(f"decoded {[len(o) for o in runs[-1]]}")
        if not srv.finite.item():
            raise AssertionError("a decode step's logits are not finite")
        if peak > weights + cache_b + 2e9:
            raise AssertionError(f"peak memory {peak / 1e9:.2f} GB > the "
                                 f"weights {weights / 1e9:.2f} + one cache "
                                 f"{cache_b / 1e9:.2f} + 2 GB")
        fill = srv.calls - stats["steps"]
        lens = [len(r.prompt) for r in requests]
        print(f"  phase 13 (a) run {run + 1}: {DECODE_REQUESTS} requests "
              f"(prompts of {min(lens)}-{max(lens)} tokens, "
              f"{DECODE_NEW} new each) over {DECODE_SLOTS} slots of "
              f"{DECODE_LEN} positions: {n_tok} tokens decoded in "
              f"{srv.calls} decode_step calls ({fill} fill steps, "
              f"{stats['steps']} decode steps); wall {wall:.4f} s "
              f"({n_tok / wall:.2f} tokens/s, {wall / srv.calls * 1e3:.3f} "
              f"ms a call), stats['wall'] {stats['wall']:.4f} s "
              f"({stats['wall'] / stats['steps'] * 1e3:.3f} ms a decode "
              f"step); peak memory {peak / 1e9:.2f} GB (weights "
              f"{weights / 1e9:.2f} + cache {cache_b / 1e9:.2f} GB); every "
              f"logit finite")
        _stamp(clock)
        if run == 0:
            del srv
            _release()
    if runs[0] != runs[1]:
        raise AssertionError("two server runs decoded different tokens")
    print(f"  the second run decoded the same {DECODE_REQUESTS} x "
          f"{DECODE_NEW} tokens; first request's: {runs[0][0][:8]}...")

    # ---- (b) decode_step over a full cache
    cache = srv.cache
    tokens = torch.from_numpy(np.random.default_rng(DECODE_SEED + 1).integers(
        0, cfg.vocab, DECODE_SLOTS).astype(np.int32)).pin_memory()
    gen = torch.Generator(device).manual_seed(DECODE_SEED + 2)
    cache["k"].normal_(generator=gen)
    cache["v"].normal_(generator=gen)
    Skv = cache["k"].shape[3]
    cache["pos"].copy_(torch.arange(Skv, dtype=torch.int32, device=device))
    cache["t"].fill_(Skv - 1)
    walls = []
    for _ in range(DECODE_STEPS):
        t0 = time.perf_counter()
        logits, _ = T.decode_step(params, cache, tokens, cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    if not torch.isfinite(logits).all().item():
        raise AssertionError("logits over the full cache are not finite")
    bound_ms, nbytes, flop = _decode_bound(params, cache, cfg, DECODE_SLOTS)
    step_ms = float(np.mean(walls)) * 1e3
    print(f"  phase 13 (b): {DECODE_STEPS} decode steps of {DECODE_SLOTS} "
          f"tokens over a full cache ({Skv} positions a slot, random bf16 "
          f"K and V, t from {Skv - 1}): wall per step "
          + ", ".join(f"{w * 1e3:.3f}" for w in walls)
          + f" ms (mean {step_ms:.3f} ms, {DECODE_SLOTS / step_ms * 1e3:.2f} "
          f"tokens/s); bound {bound_ms:.3f} ms ({nbytes / 1e9:.2f} GB at "
          f"3.35 TB/s; {flop / 1e9:.1f} GFLOP take "
          f"{flop / BF16_FLOP_PER_S * 1e3:.3f} ms at the bf16 peak): "
          f"{step_ms / bound_ms:.2f}x it")
    _stamp(clock)
    # the parts: the same step twice from one state (the overwritten slot,
    # pos and t restored), through decode_step and through the timed parts
    w = int(cache["t"].item()) % Skv
    saved = [cache[n][:, :, :, w].clone() for n in ("k", "v")]
    pos0, t0_ = cache["pos"].clone(), cache["t"].clone()
    want, _ = T.decode_step(params, cache, tokens, cfg)
    for n, keep in zip(("k", "v"), saved):
        cache[n][:, :, :, w] = keep
    cache["pos"].copy_(pos0)
    cache["t"].copy_(t0_)
    parts, got = _decode_breakdown(params, cache, tokens, cfg)
    if not torch.equal(got, want):
        raise AssertionError("the timed parts' logits differ from "
                             "decode_step's")
    total = sum(parts.values())
    print(f"  one decode step, stream time by part (ms, CUDA events, summed "
          f"over {cfg.n_layers} layers, host gaps included): " + ", ".join(
              f"{k} {v:.3f}" for k, v in parts.items())
          + f"; all parts {total:.3f}; logits bit-equal to decode_step's")
    _stamp(clock)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        T.decode_step(params, cache, tokens, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    layer_numel = cache["k"][0].numel()
    h2d, syncs, launches, largest, share, dev_ms, wall_ms, top = (
        _decode_profile(lambda: T.decode_step(params, cache, tokens, cfg)))
    if h2d > 1 or syncs:
        raise AssertionError(f"a decode step made {h2d} host-to-device "
                             f"copies (1: its token ids) and {syncs} syncs")
    if largest >= layer_numel:
        raise AssertionError(f"a decode step copied {largest} elements, a "
                             f"layer's K holds {layer_numel}")
    print(f"  a decode step ran under the sync debug mode 'error'; one "
          f"under the profiler: {launches} kernel launches, {h2d} "
          f"host-to-device copies (at most 1: its {DECODE_SLOTS} token ids, "
          f"pinned), 0 synchronizing calls, largest copy {largest} "
          f"elements (a layer's K: {layer_numel}); " + (
              "device busy share not measured (the trace holds no device "
              "time)" if share is None else
              f"device busy share {share:.3f} ({dev_ms:.3f} ms of device "
              f"time in {wall_ms:.3f} ms wall, profiler on); top kernels "
              f"(ms): " + "; ".join(f"{k} {v:.3f}" for k, v in top)))
    _stamp(clock)
    del cache, srv, logits, want, got, saved
    _release()


def phase_decode_agreement(device, params, cfg=None):
    """Phase 13 (c): the 1-slot server against a manual ``decode_step``
    loop (full width, bit for bit); decode against ``prefill`` on one
    prompt at the published widths in f32 (4 layers, gated) and at full
    depth in bf16 (reported); card against CPU at smoke size."""
    import dataclasses as dc

    import torch

    from repro_torch import configs, tree_map
    from repro_torch.models import transformer as T
    from repro_torch.runtime.serve import Request

    cfg = cfg or configs.get("qwen3-14b").model_cfg
    clock = time.perf_counter()
    rng = np.random.default_rng(DECODE_SEED + 3)
    prompt = rng.integers(0, cfg.vocab, 12).astype(np.int32)
    served = []
    srv = _counted_server(params, cfg, 1, 64, record=served)
    req = Request(prompt=prompt, max_new_tokens=8)
    srv.submit(req)
    srv.run_to_completion()
    cache = T.init_cache(cfg, 1, 64, device=device)
    manual, outs = [], []
    for tok in prompt:
        logits, cache = T.decode_step(params, cache, torch.tensor([tok]), cfg)
        manual.append(logits)
    for _ in range(8):
        nxt = int(torch.argmax(logits[0]))
        outs.append(nxt)
        logits, cache = T.decode_step(params, cache, torch.tensor([nxt]), cfg)
        manual.append(logits)
    manual = manual[:len(served)]
    if req.out != outs or not all(torch.equal(a, b) for a, b in
                                  zip(served, manual)):
        raise AssertionError(f"the 1-slot server {req.out} differs from the "
                             f"manual loop {outs}")
    print(f"phase 13 (c): {cfg.name}, one request alone in a 1-slot server "
          f"= a manual decode_step loop, bit for bit ({len(served)} calls' "
          f"logits; tokens {outs})")
    _stamp(clock)
    del srv, cache, served, manual
    _release()

    def decode_vs_prefill(p, c):
        toks = np.random.default_rng(DECODE_SEED + 4).integers(
            0, c.vocab, DECODE_AGREE)
        cache = T.init_cache(c, 1, DECODE_AGREE, device=device)
        for tok in toks:
            dec, cache = T.decode_step(p, cache, torch.tensor([tok]), c)
        pre = T.prefill(p, torch.from_numpy(toks)[None].to(device), c)
        torch.cuda.synchronize()
        diff = (dec.float() - pre.float()).abs()
        return diff.max().item(), diff.mean().item(), torch.isfinite(
            dec).all().item()

    full_max, full_mean, finite = decode_vs_prefill(params, cfg)
    if not finite:
        raise AssertionError("bf16 decode logits are not finite")
    c4 = dc.replace(cfg, n_layers=4, dtype=torch.float32)
    p4 = T.init_params(torch.Generator(device).manual_seed(DECODE_SEED + 5),
                       c4, device=device)
    f32_max, f32_mean, finite = decode_vs_prefill(p4, c4)
    gb4 = _param_bytes(p4) / 1e9
    del p4
    _release()
    if not finite or f32_max > 3e-4:
        raise AssertionError(f"f32 decode vs prefill: max |diff| {f32_max}")
    print(f"  decode of a {DECODE_AGREE}-token prompt token by token vs "
          f"prefill (kernel 9) at its last position: published widths, 4 "
          f"layers, f32, vocab {c4.vocab} ({gb4:.2f} GB): max |diff| "
          f"{f32_max:.3g}, mean {f32_mean:.3g} (atol 3e-4); full depth, "
          f"bf16 (phase 11's weights): max {full_max:.4g}, mean "
          f"{full_mean:.4g} (no gate: decode rounds p to bf16, kernel 9 "
          f"keeps it in float32)")
    _stamp(clock)

    smoke = configs.get("qwen3-14b").smoke_cfg
    cpu = T.init_params(torch.Generator("cpu").manual_seed(7), smoke,
                        device="cpu")
    gpu = tree_map(lambda t: t.to(device), cpu)
    ccache = T.init_cache(smoke, 3, 32, device="cpu")
    gcache = T.init_cache(smoke, 3, 32, device=device)
    worst = 0.0
    for tok in torch.from_numpy(np.random.default_rng(9).integers(
            0, smoke.vocab, (20, 3))):
        want, ccache = T.decode_step(cpu, ccache, tok, smoke)
        got, gcache = T.decode_step(gpu, gcache, tok, smoke)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   atol=5e-5, rtol=1e-5)
        worst = max(worst, (got.cpu() - want).abs().max().item())
    print(f"  {smoke.name} ({smoke.n_layers} layers, f32), 20 decode steps "
          f"of 3 slots, card vs CPU from one state: logits max |diff| "
          f"{worst:.3g} (atol 5e-5, rtol 1e-5)")
    _stamp(clock)


# ------------------------------------------------ the LM's training (14)
LM_TRAIN_LAYERS = 2        # qwen3-14b's 40 layers cut to 2 (PERF.md §4)
LM_TRAIN_SEQ = 4096        # lm_shapes()["train_4k"]'s sequence
LM_TRAIN_BATCH = 2         # train_4k's batch 256 cut to 2: 1 sequence a pod
LM_TRAIN_STEPS = 20        # two merges at k 10
LM_TRAIN_K = 10
# kernel 9b's three launches a backward, by dtype: D, then dK and dV, then
# dQ (bf16 on the tensor cores, f32 on the CUDA cores)
FLASH_BWD_KERNELS = {
    "bfloat16": ("flash_attention_bwd_delta_kernel",
                 "flash_attention_bwd_kv_mma_kernel",
                 "flash_attention_bwd_q_mma_kernel"),
    "float32": ("flash_attention_bwd_delta_kernel",
                "flash_attention_bwd_kv_kernel",
                "flash_attention_bwd_q_kernel")}
# kernel 9b against the plain vjp: every gradient within this share of its
# largest magnitude (f32: float32 sums in another order; bf16: one bf16
# rounding of each gradient, and D from the bf16 output)
FLASH_BWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _flash_bwd_times(q, k, v, dout, causal=True, iters=5):
    """Kernel 9b's times (cold and warm L2), its plain vjp's, the backward
    of ``F.scaled_dot_product_attention`` (timed only: the port never
    calls it) and its bound at ``q, k, v``; the device time of its three
    kernels (D, dK/dV, dQ) per call under the profiler (``_kernel_times``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_cuda, flash_attention_cuda)

    B, S, H, hd = q.shape
    dtype = str(q.dtype).split(".")[-1]
    out, lse = flash_attention_cuda(q, k, v, causal, return_lse=True)
    xs = [x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*xs, is_causal=causal,
                                             enable_gqa=True)
    g = dout.transpose(1, 2)

    def library():
        return torch.autograd.grad(lib_out, xs, g, retain_graph=True)

    def kernel():
        return flash_attention_backward_cuda(q, k, v, out, lse, dout, causal)

    got, lib = kernel(), library()
    for a, b in zip(got, lib):
        b = b.transpose(1, 2)
        if not torch.allclose(a.float(), b.float(), rtol=0.05,
                              atol=0.05 * b.float().abs().max().item()):
            raise AssertionError(f"flash_attention_backward {tuple(q.shape)} "
                                 f"{dtype}: SDPA's backward and the kernel "
                                 "differ")
    del got, lib
    elt = q.element_size()
    nbytes = (4 * q.numel() + 4 * k.numel()) * elt + 4 * B * H * S
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 10 * B * H * hd * pairs           # five products of 2 hd a pair
    bound_ms, bound_by = _bound(nbytes, flops, BF16_FLOP_PER_S
                                if dtype == "bfloat16" else F32_FLOP_PER_S)
    res = {
        "shape": [B, S, H, k.shape[2], hd], "dtype": dtype,
        "ms": _time_ms(kernel, iters=iters, warmup=1),
        "ms_l2_warm": _time_ms(kernel, iters=iters, warmup=1, cold_l2=False),
        "plain_ms": _time_ms(lambda: ref.flash_attention_backward_ref(
            q, k, v, dout, causal), iters=2, warmup=1),
        "library_ms": _time_ms(library, iters=iters, warmup=1),
        "bound_ms": bound_ms, "bound_by": bound_by, "gflop": flops / 1e9,
        "mb": nbytes / 1e6,
    }
    per_kernel = _kernel_times(kernel, calls=iters)
    res["kernels_ms"] = {
        part: sum(ms for key, ms in per_kernel.items() if name in key)
        for part, name in zip(("D", "dK/dV", "dQ"),
                              FLASH_BWD_KERNELS[dtype])}
    del lib_out, xs
    return res


def _flash_bwd_sass_report():
    """Phase 14 (a): each instantiation of kernel 9b's dK/dV and dQ kernels
    (``_sass_report``): "kv<T,HDP>", "q<T,HDP>", T "bf16" (the mma
    kernels) or "f32" (the fma kernels), and "kv<T,HDP,local>",
    "q<T,HDP,local>" with the window and chunk terms.  Fails on a bf16 one
    without HMMA, or a causal bf16 one with a spill store (STL) at HDP 64
    or 128, and on an f32 one with HMMA."""
    import re

    def short(mangled):
        m = re.search(r"flash_attention_bwd_(kv|q)_(mma_)?kernelILi(\d+)E"
                      r"Lb([01])E", mangled)
        return m and (f"{m.group(1)}<{'bf16' if m.group(2) else 'f32'},"
                      f"{m.group(3)}{',local' if m.group(4) == '1' else ''}>")

    report, usage = _sass_report(short)
    want = sorted(f"{n}<{t},{w}{local}>" for n in ("kv", "q")
                  for t in ("bf16", "f32") for w in (64, 128, 256)
                  for local in ("", ",local"))
    if sorted(report) != want:
        raise AssertionError(f"kernel 9b's instantiations: {sorted(report)}"
                             f"; cuobjdump -res-usage began:\n"
                             f"{usage[:3000]}")
    _print_sass(report)
    for name, r in sorted(report.items()):
        bf16 = "bf16" in name
        if ("hmma" not in r or (r["hmma"] > 0) != bf16
                or (bf16 and name.endswith((",64>", ",128>")) and r["stl"])):
            raise AssertionError(f"kernel 9b {name}: SASS report {r}")
    return report


def phase_flash_backward(device):
    """Phase 14 (a): kernel 9b against the plain vjp on the card, and
    timed; returns its kernels-line entry (without ``launches``): the
    cell's shape (1, 4096, 40, 8, 128) bf16, with the same in f32 under
    ``float32``."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_cuda, flash_attention_cuda)

    gen = torch.Generator(device).manual_seed(59)
    S = LM_TRAIN_SEQ
    # (B, S, H, Kv, hd), dtype, causal, timed
    cases = [((1, S, 40, 8, 128), torch.bfloat16, True, True),
             ((1, S, 40, 8, 128), torch.float32, True, True),
             ((1, 129, 40, 8, 128), torch.bfloat16, True, False),
             ((1, 200, 8, 8, 256), torch.bfloat16, False, False),
             ((2, 64, 8, 2, 16), torch.float32, True, False),
             ((2, 64, 8, 2, 16), torch.float32, False, False),
             ((1, 1000, 40, 8, 128), torch.bfloat16, True, False),
             ((1, 333, 8, 2, 64), torch.bfloat16, False, False),
             ((2, 97, 4, 2, 64), torch.float32, True, False),
             ((1, 257, 4, 4, 128), torch.float32, False, False)]
    print("phase 14 (a): flash_attention_backward (kernel 9b) against the "
          "plain vjp (autograd through ref.flash_attention_ref); tolerance: "
          "every gradient within 1e-5 (f32) or 2e-2 (bf16) of its largest "
          "magnitude; the forward's log-sum-exp within atol = rtol = 1e-5 of "
          "ref.flash_attention_lse_ref and its output bit-equal to the "
          "output without it")
    sass = _flash_bwd_sass_report()
    max_err, max_err_bf16, times = 0.0, 0.0, []
    for (B, Sq, H, Kv, hd), dtype, causal, timed in cases:
        name = str(dtype).split(".")[-1]
        q = torch.randn((B, Sq, H, hd), generator=gen, device=device).to(dtype)
        k, v = [torch.randn((B, Sq, Kv, hd), generator=gen,
                            device=device).to(dtype) for _ in range(2)]
        dout = torch.randn(q.shape, generator=gen, device=device).to(dtype)
        out, lse = flash_attention_cuda(q, k, v, causal, return_lse=True)
        if not torch.equal(out, flash_attention_cuda(q, k, v, causal)):
            raise AssertionError(f"flash_attention {(B, Sq, H, Kv, hd)} "
                                 f"{name}: the output with the log-sum-exp "
                                 "differs from the output without it")
        lse_err = (lse - ref.flash_attention_lse_ref(q, k, causal)).abs()
        if lse_err.max().item() > 1e-5 * (1 + lse.abs().max().item()):
            raise AssertionError(f"flash_attention {(B, Sq, H, Kv, hd)} "
                                 f"{name}: log-sum-exp off by "
                                 f"{lse_err.max().item()}")
        got = flash_attention_backward_cuda(q, k, v, out, lse, dout, causal)
        again = flash_attention_backward_cuda(q, k, v, out, lse, dout,
                                              causal)
        torch.cuda.synchronize()
        want = ref.flash_attention_backward_ref(q, k, v, dout, causal)
        errs = []
        for which, a, b, c in zip(("dq", "dk", "dv"), got, again, want):
            scale = c.float().abs().max().item()
            err = (a.float() - c.float()).abs().max().item()
            errs.append(err / scale)
            if (a.dtype != dtype or a.shape != c.shape
                    or not torch.equal(a, b)
                    or err > FLASH_BWD_TOL[name] * scale):
                raise AssertionError(f"flash_attention_backward "
                                     f"{(B, Sq, H, Kv, hd)} {name} causal "
                                     f"{causal} {which}: max |kernel - "
                                     f"plain| {err} of {scale}, or two runs "
                                     "differ")
            if dtype == torch.float32:
                max_err = max(max_err, err)
            else:
                max_err_bf16 = max(max_err_bf16, err)
        names = sorted(set(sum(FLASH_BWD_KERNELS.values(), ())))
        ran = _graph_kernels(lambda: flash_attention_backward_cuda(
            q, k, v, out, lse, dout, causal), names)
        if ran != [int(n in FLASH_BWD_KERNELS[name]) for n in names]:
            raise AssertionError(f"kernel 9b's graph holds {ran} of {names}"
                                 f"; {name} launches "
                                 f"{FLASH_BWD_KERNELS[name]} once each")
        print(f"  {(B, Sq, H, Kv, hd)} {name} causal {causal}: max |kernel "
              f"- plain| / max |plain| dq {errs[0]:.3g}, dk {errs[1]:.3g}, "
              f"dv {errs[2]:.3g}; log-sum-exp max |diff| "
              f"{lse_err.max().item():.3g}; two runs bit-equal; its graph "
              f"holds its dtype's three kernels")
        del want, got, again, lse_err
        if timed:
            times.append(_flash_bwd_times(q, k, v, dout, causal))
        del q, k, v, dout, out, lse
        _release()
    for t in times:
        print(f"  times {tuple(t['shape'])} {t['dtype']} causal (ms): kernel "
              f"{t['ms']:.4f} cold, {t['ms_l2_warm']:.4f} warm "
              f"({t['gflop'] / t['ms']:.2f} TFLOP/s cold); plain vjp "
              f"{t['plain_ms']:.4f}; library (SDPA's backward, is_causal, "
              f"enable_gqa) {t['library_ms']:.4f}; bound {t['bound_ms']:.4f} "
              f"({t['gflop']:.1f} GFLOP, {t['mb']:.1f} MB, {t['bound_by']});"
              f" its kernels (profiler, L2 cold, ms a call): "
              + ", ".join(f"{part} {ms:.4f}"
                          for part, ms in t["kernels_ms"].items()))
    keys = ("shape", "dtype", "ms", "ms_l2_warm", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "kernels_ms")
    return {
        "name": "flash_attention_backward",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_backward.cu",
        "replaces": "src/repro/models/transformer.py:183, :239 (XLA vjp "
                    "of the training attention, no Pallas kernel)",
        "launches": None,
        "max_abs_err": max_err,
        "max_abs_err_bf16": max_err_bf16,
        "sass": sass,
        **{k: times[0][k] for k in keys},
        "float32": {k: times[1][k] for k in keys},
    }


def phase_adam_bf16(device):
    """Phase 14 (a): kernel 6 on bfloat16 leaves (float32 moments) against
    its plain version at one layer of the cell (the podded qwen3-14b layer
    leaves, 2 x 330.3e6 elements), bit for bit, and timed; returns the
    numbers."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.core.kstep import leaves, pod_replicate
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_adam import AdamTable, fused_adam_cuda
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(configs.get("qwen3-14b").model_cfg, n_layers=1)
    gen = torch.Generator(device).manual_seed(61)
    P = leaves(pod_replicate(T.init_params(gen, cfg, device=device)[
        "layers"], 2))
    n = sum(x.numel() for x in P)

    def like(scale, positive=False, dtype=torch.float32):
        out = []
        for x in P:
            y = torch.randn(x.shape, generator=gen, device=device) * scale
            out.append((y.abs_() + 1e-3 * scale if positive else y).to(dtype))
        return out

    leaves5 = (P, like(0.01, dtype=torch.bfloat16), like(0.01),
               like(1e-4, True), like(1e-4, True))
    print(f"phase 14 (a): fused_adam (kernel 6) on bfloat16 params and "
          f"gradients with float32 moments, at one podded layer of the cell "
          f"({len(P)} leaves, {n} elements): against its plain version")
    for t in (3, 25):
        kw = _adam_kwargs(t, device, True, False, 0.0, False, k=LM_TRAIN_K)
        want = [[x.clone() for x in g] for g in leaves5[:1] + leaves5[2:4]]
        ref.fused_adam_ref(want[0], leaves5[1], want[1], want[2],
                           leaves5[4], **kw)
        got = [[x.clone() for x in g] for g in leaves5[:1] + leaves5[2:4]]
        fused_adam_cuda(got[0], leaves5[1], got[1], got[2], leaves5[4], **kw)
        torch.cuda.synchronize()
        for a_g, w_g in zip(got, want):
            for a, b in zip(a_g, w_g):
                if a.dtype != b.dtype or not torch.equal(a, b):
                    raise AssertionError(f"fused_adam bf16 t={t}: kernel and "
                                         "plain version differ")
        del want, got
    print("  before (t 3, v_local) and after the first merge (t 25, v_hat): "
          "params (bf16), m and v_local bit-equal to the plain version")
    kw = _adam_kwargs(25, device, True, False, 0.0, False, k=LM_TRAIN_K)
    table = AdamTable()

    def kernel():
        return fused_adam_cuda(*leaves5, table=table, **kw)

    ms = _time_ms(kernel, iters=10, warmup=2)
    warm_ms = _time_ms(kernel, iters=10, warmup=2, cold_l2=False)
    plain_ms = _time_ms(lambda: ref.fused_adam_ref(*leaves5, **kw), iters=3,
                        warmup=1)
    nbytes = 26 * n
    bound_ms, bound_by = _bound(nbytes, 12 * n)
    print(f"  times at one podded layer (ms): kernel {ms:.4f} cold, "
          f"{warm_ms:.4f} warm; plain version {plain_ms:.4f}; bound "
          f"{bound_ms:.4f} ({nbytes / 1e9:.2f} GB: 26 B an element, "
          f"{bound_by})")
    del leaves5, P
    _release()
    return {"layer_elements": n, "layer_ms": ms, "layer_ms_l2_warm": warm_ms,
            "layer_plain_ms": plain_ms, "layer_bound_ms": bound_ms}


def _lm_train_cfg():
    import dataclasses

    from repro_torch import configs

    return dataclasses.replace(configs.get("qwen3-14b").model_cfg,
                               n_layers=LM_TRAIN_LAYERS)


def _f32_first_loss(device, cfg, batch):
    """The mean over pods of ``loss_fn`` at the trainer's initial weights
    (``build_trainer``'s seed 0), widened to float32, on the card (no
    grad): the first step's loss as float32 computes it."""
    import dataclasses

    import torch

    from repro_torch import tree_map
    from repro_torch.models import transformer as T

    params = T.init_params(torch.Generator(device).manual_seed(0), cfg,
                           device=device)
    params = tree_map(lambda t: t.float(), params)
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    toks = torch.from_numpy(batch["tokens"]).to(device)
    labs = torch.from_numpy(batch["labels"]).to(device)
    per = len(batch["tokens"]) // 2
    with torch.no_grad():
        losses = [T.loss_fn(params, {"tokens": toks[i * per:(i + 1) * per],
                                     "labels": labs[i * per:(i + 1) * per]},
                            c32).item() for i in range(2)]
    del params
    _release()
    return float(np.mean(losses))


def _lm_train_breakdown(tr, batch, cfg, groups=None):
    """Phase 14 (b): one more local step split into parts by CUDA events
    (forward, backward, the local Adam step), a merge step's optimizer
    part, and one pod's head + cross-entropy forward and backward alone;
    then one step under the profiler: the device time of kernels 9, 9b and
    6 (or of ``groups``: {label: kernel name parts}) and the busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as T
    from repro_torch.data.pipeline import stage_batch

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    pb = tr.pod_batch(stage_batch(batch, tr.params["embed"].device))
    torch.cuda.synchronize()
    e0 = event()
    fwd = tr._forward(pb)
    e1 = event()
    tr._backward(*fwd)
    e2 = event()
    tr.opt.step(tr.params, tr.grads, tr.opt_state, merge=False)
    e3 = event()
    tr.opt.step(tr.params, tr.grads, tr.opt_state, merge=True)
    e4 = event()
    del fwd
    # one pod's head + cross-entropy, forward and backward, alone
    p0 = {k: v[0] for k, v in tr.params.items() if k != "layers"}
    with torch.no_grad():
        x, _ = T.trunk({**p0, "layers": {k: v[0] for k, v in
                                         tr.params["layers"].items()}},
                       pb["tokens"][0], cfg)
    xc = x.detach().requires_grad_(True)
    head = p0["head"].detach().requires_grad_(True)
    torch.cuda.synchronize()
    e5 = event()
    T._chunk_ce(xc, head, pb["labels"][0]).backward()
    e6 = event()
    torch.cuda.synchronize()
    parts = {"forward (2 pods)": e0.elapsed_time(e1),
             "backward (2 pods, with the recompute)": e1.elapsed_time(e2),
             "local Adam (kernel 6)": e2.elapsed_time(e3),
             "merge step (optimizer part)": e3.elapsed_time(e4),
             "head + cross-entropy fwd+bwd (1 pod, alone)":
                 e5.elapsed_time(e6)}
    del x, xc, head
    _release()
    groups = groups or {
        "kernel 9 (flash_attention_mma_kernel)":
            ("flash_attention_mma_kernel",),
        "kernel 9b (flash_attention_bwd_*)": FLASH_BWD_KERNELS["bfloat16"],
        "kernel 6 (fused_adam_kernel)": ("fused_adam_kernel",)}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    by_group = {g: sum(e.self_device_time_total for e in kernels
                       if any(n in e.key for n in names)) / 1e3
                for g, names in groups.items()}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return parts, by_group, busy, wall_ms, top


def phase_lm_train(device):
    """Phase 14 (b) and (c) at full width: ``build_trainer`` of qwen3-14b
    cut to 2 layers, 20 ``train_step`` calls (two merges), their launches,
    walls, peak memory and parts; kernel 6 timed at the cell's leaves;
    the first step's loss against float32 on the same weights.  Returns
    the launch counts of the 20 steps and kernel 6's cell numbers."""
    import torch

    from repro_torch.core.kstep import KStepConfig, leaves
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_adam import fused_adam_cuda
    from repro_torch.runtime.factory import build_trainer
    from repro_torch.runtime.trainer import TrainerConfig

    cfg = _lm_train_cfg()
    gen = lm_batches(seed=0, batch=LM_TRAIN_BATCH, seq_len=LM_TRAIN_SEQ,
                     vocab=cfg.vocab)
    t0 = time.perf_counter()
    batches = [next(gen) for _ in range(LM_TRAIN_STEPS + 2)]
    data_s = time.perf_counter() - t0
    f32_loss = _f32_first_loss(device, cfg, batches[0])
    t0 = time.perf_counter()
    tr = build_trainer("qwen3-14b", TrainerConfig(
        n_pod=2, kstep=KStepConfig(lr=1e-3, k=LM_TRAIN_K, merge="two_phase")),
        model_cfg=cfg, device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n = sum(x.numel() for x in leaves(tr.params))
    state_gb = torch.cuda.memory_allocated() / 1e9
    print(f"phase 14 (b): qwen3-14b training at full width (d "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} KV "
          f"heads, hd {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, untied "
          f"head, bf16), cut to {cfg.n_layers} of 40 layers and train_4k's "
          f"batch 256 to {LM_TRAIN_BATCH} sequences of {LM_TRAIN_SEQ} "
          f"tokens (one a pod); DenseTrainer, n_pod 2, two_phase, lr 1e-3, "
          f"k {LM_TRAIN_K}: {n} podded parameters, {state_gb:.2f} GB "
          f"allocated after the build ({build_s:.1f} s; batches from "
          f"lm_batches in {data_s:.1f} s)")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    losses, walls = [], []
    for i, b in enumerate(batches[:LM_TRAIN_STEPS]):
        t0 = time.perf_counter()
        if i >= 2:          # the first two build and warm up, then no sync
            torch.cuda.set_sync_debug_mode("error")
        try:
            loss = tr.train_step(b)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = dict(ops.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    L, P_ = cfg.n_layers, 2
    want = dict.fromkeys(launches, 0)
    want["flash_attention"] = 2 * LM_TRAIN_STEPS * L * P_
    want["flash_attention_backward"] = LM_TRAIN_STEPS * L * P_
    want["fused_adam"] = LM_TRAIN_STEPS - LM_TRAIN_STEPS // LM_TRAIN_K
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    if not all(np.isfinite(losses)) or int(tr.opt_state.step) != \
            LM_TRAIN_STEPS:
        raise AssertionError(f"losses {losses}, step "
                             f"{int(tr.opt_state.step)}")
    rel = abs(losses[0] - f32_loss) / abs(f32_loss)
    steady = float(np.mean(walls[2:]))
    merge_walls = [walls[i] for i in range(LM_TRAIN_K - 1, LM_TRAIN_STEPS,
                                           LM_TRAIN_K)]
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    print(f"  {LM_TRAIN_STEPS} train_step calls, merges at steps "
          f"{LM_TRAIN_K} and {2 * LM_TRAIN_K}: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)} (finite); walls (s) "
          f"{', '.join(f'{w:.4f}' for w in walls)}; steps 3-{LM_TRAIN_STEPS} mean "
          f"{steady:.4f} s, {tokens / steady:.1f} tokens/s; merge steps "
          f"{', '.join(f'{w:.4f}' for w in merge_walls)} s; peak memory "
          f"{peak_gb:.2f} GB; steps 3-{LM_TRAIN_STEPS} ran under the sync "
          f"debug mode "
          f"'error'")
    print(f"  launches in the {LM_TRAIN_STEPS} steps: flash_attention "
          f"{launches['flash_attention']} (= 2 x {L} layers x {P_} pods x "
          f"{LM_TRAIN_STEPS}: the forward and the "
          f"checkpoint's recompute), flash_attention_backward "
          f"{launches['flash_attention_backward']} (= {L} x {P_} x "
          f"{LM_TRAIN_STEPS}), "
          f"fused_adam {launches['fused_adam']} (the local steps); every "
          f"plain version 0")
    print(f"  phase 14 (c): the first step's loss {losses[0]:.6f} against "
          f"{f32_loss:.6f} from the same weights widened to float32 on the "
          f"card (no grad): relative difference {rel:.3g} (bf16 against "
          f"float32 through {L} layers; required below 1e-2).  A CPU run of "
          f"the port at these widths (1 layer, f32) is not made: one step "
          f"is ~4.6e13 float32 operations, minutes on 8 CPU cores")
    if rel > 1e-2:
        raise AssertionError("the first step's loss is off the float32 one")
    parts, by_group, busy, wall_ms, top = _lm_train_breakdown(
        tr, batches[LM_TRAIN_STEPS], cfg)
    print("  one more step by part (stream ms, CUDA events): " + "; ".join(
        f"{k} {v:.3f}" for k, v in parts.items()))
    print(f"  one more step under the profiler: wall {wall_ms:.3f} ms, "
          f"device busy {busy:.3f} ms (share {busy / wall_ms:.3f}, profiler "
          f"on); " + "; ".join(f"{k} {v:.3f} ms" for k, v in
                               by_group.items())
          + "; top kernels (ms): " + "; ".join(
              f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f}"
              for e in top))
    # kernel 6 at the cell's leaves: the trainer's own (the run is over)
    P, M = leaves(tr.params), leaves(tr.opt_state.m)
    VL, VH = leaves(tr.opt_state.v_local), leaves(tr.opt_state.v_hat)
    G = leaves(tr.grads)
    kw = _adam_kwargs(25, device, True, False, 0.0, False, k=LM_TRAIN_K)

    def kernel():
        return fused_adam_cuda(P, G, M, VL, VH, table=tr.opt._adam_table,
                               **kw)

    ms = _time_ms(kernel, iters=5, warmup=1)
    warm_ms = _time_ms(kernel, iters=5, warmup=1, cold_l2=False)
    bound_ms, bound_by = _bound(26 * n, 12 * n)
    print(f"  kernel 6 at the cell's {len(P)} podded leaves ({n} elements, "
          f"bf16 params and gradients): {ms:.4f} ms cold, {warm_ms:.4f} "
          f"warm; bound {bound_ms:.4f} ({26 * n / 1e9:.1f} GB, {bound_by})")
    del tr, P, M, VL, VH, G
    _release()
    return launches, {"cell_elements": n, "cell_ms": ms,
                      "cell_ms_l2_warm": warm_ms, "cell_bound_ms": bound_ms,
                      "train_step_s": steady, "tokens_per_s": tokens / steady,
                      "peak_gb": peak_gb}


def phase_lm_train_smoke(device):
    """Phase 14 (b) and (c) at smoke size (qwen3-14b's smoke config,
    float32, from one state drawn on the CPU), card against CPU: 4 steps,
    n_pod 2, k 2, lr 1e-4 (two merges), and 6 steps with merge_delay 1;
    losses each step and the final parameters and moments within phase
    6's tolerance (rtol 1e-4, atol 1e-6)."""
    import torch

    from repro_torch import configs, tree_map
    from repro_torch.core.kstep import KStepConfig, leaves
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.runtime.trainer import DenseTrainer, TrainerConfig

    cfg = configs.get("qwen3-14b").smoke_cfg
    state = T.init_params(torch.Generator("cpu").manual_seed(5), cfg,
                          device="cpu")
    for delay, steps in ((0, 4), (1, 6)):
        tcfg = TrainerConfig(n_pod=2, kstep=KStepConfig(lr=1e-4, k=2),
                             merge_delay=delay)
        trs = [DenseTrainer(lambda p, b: T.loss_fn(p, b, cfg),
                            tree_map(lambda t: t.clone().to(d), state), tcfg,
                            device=d) for d in (device, "cpu")]
        gen = lm_batches(seed=1, batch=4, seq_len=128, vocab=cfg.vocab)
        ops.reset_launches()
        worst = 0.0
        for _ in range(steps):
            b = next(gen)
            got, want = (tr.train_step(b).item() for tr in trs)
            worst = max(worst, abs(got - want) / abs(want))
            if not np.isfinite(got) or not np.isclose(got, want, rtol=1e-4,
                                                      atol=1e-6):
                raise AssertionError(f"merge_delay {delay}: card loss {got}"
                                     f", CPU {want}")
        n = steps * 2 * cfg.n_layers
        if (ops.launches["flash_attention"] != 2 * n
                or ops.launches["flash_attention_backward"] != n):
            raise AssertionError(f"launches {ops.launches}")
        for a, b in zip(leaves(trs[0].params) + leaves(trs[0].opt_state.m)
                        + leaves(trs[0].opt_state.v_hat),
                        leaves(trs[1].params) + leaves(trs[1].opt_state.m)
                        + leaves(trs[1].opt_state.v_hat)):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                       rtol=1e-4, atol=1e-6)
        print(f"phase 14 (c): {cfg.name} smoke (f32), n_pod 2, k 2, lr 1e-4, "
              f"merge_delay {delay}, {steps} steps on the card and on the CPU "
              f"from one state: losses (largest relative difference "
              f"{worst:.3g}), parameters, m and v_hat within rtol 1e-4, atol "
              f"1e-6; on the card kernel 9 {ops.launches['flash_attention']}"
              f" and 9b {ops.launches['flash_attention_backward']} launches")
        del trs
    _release()


# ------------------------------ MoE and the windowed and chunked masks (15)
# the one reduction of each model: its layers (PERF.md section 4)
MOE_LAYERS = {"mixtral-8x7b": 20, "llama4-scout-17b-16e": 12}
MOE_PREFILL = ((4, 4096), (1, 32768))   # LM_BATCH x LM_SEQ, prefill_32k's seq
MOE_PREFILLS = 2           # timed prefills a shape
MOE_SEED = 0
LONG_T = 524288 - 32       # long_500k: t of the first step, 32 before a wrap
LONG_STEPS = 64            # steps across the wrap
LOCAL_LONG = 32768         # (a)'s timed shape: prefill_32k's sequence
LOCAL_CHECK = 8192         # (a)'s checked shape (the plain version fits)
LOCAL_EDGE = 1000          # (a)'s edge cases: S not a multiple of a tile


def _visible_keys(S, window=None, chunk=None):
    """The (query, key) pairs ``ref.attention_mask(S, True, window, chunk)``
    keeps: row r sees keys [lo(r), r], lo(r) = max(r - window + 1,
    r - r % chunk, 0)."""
    r = np.arange(S, dtype=np.int64)
    lo = np.zeros(S, dtype=np.int64)
    if window is not None:
        lo = np.maximum(lo, r - window + 1)
    if chunk is not None:
        lo = np.maximum(lo, r - r % chunk)
    return int((r - lo + 1).sum())


def _local_flash_times(q, k, v, window, chunk, iters=10):
    """Kernel 9 under ``window``/``chunk`` at q, k, v: cold and warm L2,
    the causal kernel at the same shape, SDPA with the boolean mask (the
    library call, K and V repeated to H heads; timed only, and held to the
    kernel within 2e-2), and the bound from the visible pairs."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    B, S, H, hd = q.shape
    G = H // k.shape[2]

    def kernel():
        return flash_attention_cuda(q, k, v, True, window=window, chunk=chunk)

    got = kernel()
    mask = ref.attention_mask(S, True, window, chunk, q.device)
    kk, vv = (x.repeat_interleave(G, dim=2).transpose(1, 2) for x in (k, v))

    def library():
        # the memory-efficient kernel: the math one would hold the
        # (B, H, S, S) scores
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION
                         if q.is_cuda else SDPBackend.MATH):
            return F.scaled_dot_product_attention(q.transpose(1, 2), kk, vv,
                                                  attn_mask=mask)

    lib = library().transpose(1, 2)
    lib_err = (lib.float() - got.float()).abs().max().item()
    if not lib_err <= 2e-2:
        raise AssertionError(f"flash_attention {tuple(q.shape)} window "
                             f"{window} chunk {chunk}: SDPA with the mask "
                             f"and the kernel differ by {lib_err}")
    del lib, got
    pairs = _visible_keys(S, window, chunk)
    flops = 4 * B * H * hd * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound_ms, bound_by = _bound(nbytes, flops, BF16_FLOP_PER_S)
    out = {
        "shape": [B, S, H, k.shape[2], hd], "window": window, "chunk": chunk,
        "dtype": str(q.dtype).split(".")[-1],
        "ms": _time_ms(kernel, iters=iters, warmup=2),
        "ms_l2_warm": _time_ms(kernel, iters=iters, warmup=2, cold_l2=False),
        "causal_ms": _time_ms(lambda: flash_attention_cuda(q, k, v, True),
                              iters=iters, warmup=2),
        "library_ms": _time_ms(library, iters=max(2, iters // 2), warmup=1),
        "library_max_abs_diff": lib_err,
        "bound_ms": bound_ms, "bound_by": bound_by, "gflop": flops / 1e9,
        "causal_bound_ms": _bound(nbytes, 4 * B * H * hd * S * (S + 1) // 2,
                                  BF16_FLOP_PER_S)[0],
    }
    del kk, vv, mask
    _release()
    return out


def phase_flash_local(device):
    """Phase 15 (a): kernel 9 with the window and chunk terms against its
    plain version on the card (bf16 and f32; the edge cases), the terms
    that do not bind against the causal kernel's bits, and the windowed
    and chunked kernels timed at prefill_32k's shapes; returns the kernels
    line's ``window`` and ``chunk`` entries (without ``launches``)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (bf16_ulps,
                                                     flash_attention_cuda)

    gen = torch.Generator(device).manual_seed(57)
    S = LOCAL_CHECK
    # (B, S, H, Kv, hd), dtype, window, chunk
    cases = [((1, S, 32, 8, 128), torch.bfloat16, 4096, None),
             ((1, S, 32, 8, 128), torch.float32, 4096, None),
             ((1, S, 40, 8, 128), torch.bfloat16, None, 2048),
             ((1, S, 40, 8, 128), torch.float32, None, 2048),
             ((LM_BATCH, LM_SEQ, 32, 8, 128), torch.bfloat16, 4096, None),
             ((1, LOCAL_EDGE, 8, 2, 128), torch.bfloat16, 100, None),
             ((1, LOCAL_EDGE, 8, 2, 128), torch.float32, 100, None),
             ((2, LOCAL_EDGE, 8, 2, 128), torch.bfloat16, 17, None),
             ((2, LOCAL_EDGE, 8, 2, 128), torch.float32, 17, None),
             ((1, LOCAL_EDGE, 8, 2, 128), torch.bfloat16, None, 300),
             ((1, LOCAL_EDGE, 8, 2, 128), torch.float32, None, 300),
             ((1, LOCAL_EDGE, 8, 2, 128), torch.bfloat16, 200, 256)]
    print("phase 15 (a): flash_attention (kernel 9) with the window and "
          "chunk terms against its plain version (the causal kernel's "
          "tolerance: f32 atol = rtol = 1e-5; bf16 atol 4e-3, rtol 8e-3 and "
          "every element within one bf16 ulp, flash_attention.bf16_ulps)")
    plain = {}
    max_err, max_err_bf16, max_ulps = 0.0, 0.0, 0.0
    for (B, S_, H, Kv, hd), dtype, window, chunk in cases:
        q = torch.randn((B, S_, H, hd), generator=gen, device=device).to(dtype)
        k, v = [torch.randn((B, S_, Kv, hd), generator=gen,
                            device=device).to(dtype) for _ in range(2)]
        got = flash_attention_cuda(q, k, v, True, window=window, chunk=chunk)
        again = flash_attention_cuda(q, k, v, True, window=window,
                                     chunk=chunk)
        torch.cuda.synchronize()
        want = ref.flash_attention_ref(q, k, v, True, window, chunk)
        name = str(dtype).split(".")[-1]
        err = (got.float() - want.float()).abs().max().item()
        ulps = ""
        if (not torch.equal(got, again) or not torch.allclose(
                got.float(), want.float(), **FLASH_TOL[name])):
            raise AssertionError(f"flash_attention {(B, S_, H, Kv, hd)} "
                                 f"{name} window {window} chunk {chunk}: "
                                 f"kernel and plain version differ (max "
                                 f"|diff| {err}) or two runs differ")
        if dtype == torch.bfloat16:
            u = bf16_ulps(got, want)
            n_off = int((u > 1).sum().item())
            max_ulps = max(max_ulps, u.max().item())
            ulps = f", max {u.max().item():.3g} bf16 ulps"
            if n_off:
                raise AssertionError(f"flash_attention {(B, S_, H, Kv, hd)} "
                                     f"window {window} chunk {chunk}: "
                                     f"{n_off} elements more than one bf16 "
                                     "ulp from the plain version")
            max_err_bf16 = max(max_err_bf16, err)
        else:
            max_err = max(max_err, err)
        ran = _graph_kernels(lambda: flash_attention_cuda(
            q, k, v, True, window=window, chunk=chunk), FLASH_KERNELS)
        if ran != ([1, 0] if dtype == torch.bfloat16 else [0, 1]):
            raise AssertionError(f"flash_attention {name} local: its graph "
                                 f"holds {ran}")
        if S_ == S and B == 1:
            key = "window" if window is not None else "chunk"
            if key not in plain:
                plain[key] = {"plain_shape": [B, S_, H, Kv, hd],
                              "plain_dtype": name,
                              "plain_ms": _time_ms(
                                  lambda: ref.flash_attention_ref(
                                      q, k, v, True, window, chunk),
                                  iters=3, warmup=1)}
        print(f"  {(B, S_, H, Kv, hd)} {name} window {window} chunk "
              f"{chunk}: max |kernel - plain| {err:.3g}{ulps}, two runs "
              f"bit-equal, {FLASH_KERNELS[ran.index(1)]} (its graph)")
        del q, k, v, got, again, want
        _release()
    # terms of S or more: the causal kernel's bits
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((1, S, 32, 128), generator=gen, device=device).to(
            dtype)
        k, v = [torch.randn((1, S, 8, 128), generator=gen,
                            device=device).to(dtype) for _ in range(2)]
        want, want_lse = flash_attention_cuda(q, k, v, True, return_lse=True)
        for kw in (dict(window=S), dict(window=4 * S), dict(chunk=S),
                   dict(window=2 * S, chunk=S)):
            got, lse = flash_attention_cuda(q, k, v, True, return_lse=True,
                                            **kw)
            if not (torch.equal(got, want) and torch.equal(lse, want_lse)):
                raise AssertionError(f"flash_attention {kw} at S {S}: not "
                                     "the causal kernel's bits")
        print(f"  (1, {S}, 32, 8, 128) "
              f"{str(dtype).split('.')[-1]}: window {S}, {4 * S}, chunk "
              f"{S} and both: output and lse bit-equal to the causal "
              "kernel's")
        del q, k, v, want, want_lse, got, lse
        _release()

    entries = {}
    for key, H, window, chunk in (("window", 32, 4096, None),
                                  ("chunk", 40, None, 8192)):
        q = torch.randn((1, LOCAL_LONG, H, 128), generator=gen,
                        device=device).to(torch.bfloat16)
        k, v = [torch.randn((1, LOCAL_LONG, 8, 128), generator=gen,
                            device=device).to(torch.bfloat16)
                for _ in range(2)]
        t = _local_flash_times(q, k, v, window, chunk)
        t.update(plain[key], launches=None)
        entries[key] = t
        print(f"  times {tuple(t['shape'])} bf16 {key} "
              f"{window or chunk} (ms): kernel {t['ms']:.4f} cold, "
              f"{t['ms_l2_warm']:.4f} warm ({t['gflop'] / t['ms']:.2f} "
              f"TFLOP/s cold, {t['ms'] / t['causal_ms']:.3f} of the causal "
              f"kernel's {t['causal_ms']:.4f}); bound {t['bound_ms']:.4f} "
              f"({t['gflop']:.1f} GFLOP, {t['bound_by']}; causal "
              f"{t['causal_bound_ms']:.4f}); library (SDPA with the boolean "
              f"mask, K and V repeated) {t['library_ms']:.4f}, max |SDPA - "
              f"kernel| {t['library_max_abs_diff']:.3g}; plain "
              f"{t['plain_ms']:.4f} at {tuple(t['plain_shape'])} "
              f"{t['plain_dtype']}")
        del q, k, v
        _release()
    entries["window"]["max_abs_err"] = max_err
    entries["window"]["max_abs_err_bf16"] = max_err_bf16
    entries["window"]["max_ulps_bf16"] = max_ulps
    return entries


def _moe_cfg(arch):
    """The arch's published config with its one reduction, its layers."""
    import dataclasses as dc

    from repro_torch import configs

    full = configs.get(arch).model_cfg
    return full, dc.replace(full, n_layers=MOE_LAYERS[arch])


def _moe_breakdown(params, tokens, cfg, want):
    """Phase 15 (b), (c): one prefill's stream time by part (CUDA events
    around each part of each layer, summed over the layers), the same
    calls as ``prefill``; its logits must be ``want``'s bits."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.models.common import rms_norm

    events = []

    def timed(part, fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        events.append((part, start, end))
        return out

    B, S = tokens.shape
    D, E, top_k = cfg.d_model, cfg.n_experts, cfg.top_k
    gsz, G = moe.groups(B * S, cfg.moe_group_size)
    cap = moe.capacity(gsz, E, top_k, cfg.capacity_factor)
    x = timed("embed", lambda: params["embed"].index_select(
        0, tokens.reshape(-1)).reshape(B, S, -1))
    q_pos = torch.arange(S, dtype=torch.int32, device=tokens.device)
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in params["layers"].items()}
        q, k, v = timed("norms + QKV + rope",
                        lambda: T._qkv(cfg, lp, x, q_pos))
        o = timed("attention (kernel 9)", lambda: ops.flash_attention(
            q, k, v, causal=True, **T._local_terms(cfg, i)))
        x = timed("o-proj", lambda: x + o.reshape(B, S, -1) @ lp["wo"])

        def route():
            h = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
            xg = h.reshape(G, gsz, D)
            plan, _ = moe.route(xg, lp["router"], E, top_k, cap, True)
            return h, plan, moe.dispatch(xg, plan, E, cap)

        h, plan, xe = timed("ffn norm + router + dispatch + combine", route)
        ye = timed("expert products", lambda: moe.experts(xe, lp))
        y = timed("ffn norm + router + dispatch + combine",
                  lambda: moe.combine(ye, plan, gsz).reshape(B, S, D))
        if cfg.shared_expert:
            def shared():
                ht = h.reshape(B * S, D)
                sg = torch.nn.functional.silu(ht @ lp["ws_gate"]) * (
                    ht @ lp["ws_up"])
                return y + (sg @ lp["ws_down"]).reshape(B, S, D)

            y = timed("shared expert", shared)
        x = timed("ffn norm + router + dispatch + combine", lambda: x + y)
    logits = timed("final norm + head", lambda: rms_norm(
        x, params["final_norm"], cfg.norm_eps)[:, -1] @ T._head(params, cfg))
    torch.cuda.synchronize()
    if not torch.equal(logits, want):
        raise AssertionError("the timed parts' logits differ from prefill's")
    parts = {}
    for part, start, end in events:
        parts[part] = parts.get(part, 0.0) + start.elapsed_time(end)
    return parts


def _moe_decode_bound(params, cache, cfg, batch):
    """(ms, bytes, FLOP) of one MoE ``decode_step`` of ``batch`` tokens:
    every weight read once (every expert's: the capacity dispatch runs
    each expert over its slots; the embedding only its ``batch`` rows),
    the whole cache once, the logits written once; its FLOP (the experts
    over every capacity slot) at the bf16 peak."""
    from repro_torch.models import moe

    Skv, hd = cache["k"].shape[3], cfg.hd
    d, H, F, E = cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.n_experts
    emb = params["embed"]
    weights = _param_bytes(params) - emb.numel() * emb.element_size()
    nbytes = (weights + batch * d * emb.element_size() + _cache_bytes(cache)
              + batch * cfg.vocab * emb.element_size())
    cap = moe.capacity(batch, E, cfg.top_k, cfg.capacity_factor)
    per_layer = (batch * (d * (H + 2 * cfg.n_kv_heads) * hd + H * hd * d
                          + d * E + (3 * d * F if cfg.shared_expert else 0))
                 + E * cap * 3 * d * F)
    flop = 2 * (cfg.n_layers * per_layer + batch * d * cfg.vocab)
    flop += 4 * batch * cfg.n_layers * H * Skv * hd
    ms = max(nbytes / HBM_BYTES_PER_S, flop / BF16_FLOP_PER_S) * 1e3
    return ms, nbytes, flop


def _moe_long(device, params, cfg):
    """Phase 15 (b) long_500k: ``decode_step`` at batch 1 from a ring of
    ``attn_window`` slots filled as at t = LONG_T (random K and V, ``pos``
    the last window positions in ring order), LONG_STEPS steps across the
    wrap; ms a step against its bound, launches and busy share."""
    import torch

    from repro_torch.models import transformer as T

    W = cfg.attn_window
    cache = T.init_cache(cfg, 1, 524288, device=device)
    Skv = cache["k"].shape[3]
    gen = torch.Generator(device).manual_seed(MOE_SEED + 7)
    cache["k"].normal_(generator=gen)
    cache["v"].normal_(generator=gen)
    first = LONG_T - Skv
    ring = torch.arange(first, LONG_T, dtype=torch.int32, device=device)
    cache["pos"][ring % Skv] = ring
    cache["t"].fill_(LONG_T)
    toks = np.random.default_rng(MOE_SEED + 8).integers(
        0, cfg.vocab, (LONG_STEPS + 2, 1)).astype(np.int32)
    walls, finite = [], torch.ones((), dtype=torch.bool, device=device)
    for tok in toks[:LONG_STEPS]:
        t0 = time.perf_counter()
        logits, _ = T.decode_step(params, cache,
                                  torch.from_numpy(tok).pin_memory(), cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        finite &= torch.isfinite(logits).all()
    t_end = LONG_T + LONG_STEPS
    want_pos = torch.arange(t_end - Skv, t_end, dtype=torch.int32)
    pos = cache["pos"].cpu()
    if (int(cache["t"].item()) != t_end or not finite.item()
            or not torch.equal(pos[want_pos % Skv], want_pos)):
        raise AssertionError("long_500k: the ring does not hold the last "
                             f"{Skv} positions at t {t_end}, or a logit is "
                             "not finite")
    bound_ms, nbytes, flop = _moe_decode_bound(params, cache, cfg, 1)
    step_ms = float(np.mean(walls[2:])) * 1e3
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        T.decode_step(params, cache, torch.from_numpy(
            toks[LONG_STEPS]).pin_memory(), cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    h2d, syncs, launches, largest, share, dev_ms, wall_ms, top = (
        _decode_profile(lambda: T.decode_step(params, cache, torch.from_numpy(
            toks[LONG_STEPS + 1]).pin_memory(), cfg)))
    if h2d > 1 or syncs:
        raise AssertionError(f"a long_500k step made {h2d} host-to-device "
                             f"copies and {syncs} syncs")
    print(f"  long_500k: {LONG_STEPS} decode_step calls at batch 1 from t "
          f"{LONG_T} over a ring of {Skv} slots (window {W}; random bf16 K "
          f"and V, pos the last {Skv} positions), across the wrap at "
          f"524288: ring holds positions {t_end - Skv}..{t_end - 1} at the "
          f"end, every logit finite; wall per step mean {step_ms:.3f} ms "
          f"(steps 3-{LONG_STEPS}; first two "
          f"{walls[0] * 1e3:.3f}, {walls[1] * 1e3:.3f}), min "
          f"{min(walls) * 1e3:.3f}, max {max(walls) * 1e3:.3f}; bound "
          f"{bound_ms:.3f} ms ({nbytes / 1e9:.2f} GB at 3.35 TB/s: every "
          f"expert's weights each step; {flop / 1e9:.1f} GFLOP): "
          f"{step_ms / bound_ms:.2f}x it; a step under the sync debug mode "
          f"'error'; profiler: {launches} kernel launches, {h2d} "
          f"host-to-device copies, 0 syncs, " + (
              "busy share not measured (no device time in the trace)"
              if share is None else
              f"device busy share {share:.3f} ({dev_ms:.3f} ms device in "
              f"{wall_ms:.3f} ms wall, profiler on); top kernels (ms): "
              + "; ".join(f"{k} {v:.3f}" for k, v in top)))
    del cache, logits
    _release()
    return {"step_ms": step_ms, "bound_ms": bound_ms, "launches": launches,
            "busy_share": share}


def phase_moe_lm(device, arch):
    """Phase 15 (b) mixtral-8x7b, (c) llama4-scout-17b-16e at the published
    widths with their layers cut (``MOE_LAYERS``), random bf16 weights
    drawn on the card: prefill at MOE_PREFILL with its launches, walls,
    peak memory and parts; the ``BatchedServer`` at decode_32k over
    DECODE_SLOTS slots; mixtral's long_500k.  Returns the launch counts
    of the timed prefills."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    full, cfg = _moe_cfg(arch)
    clock = time.perf_counter()
    layer_gb = (full.total_params() - 2 * full.d_model * full.vocab) * 2 / (
        full.n_layers * 1e9)
    print(f"phase 15 ({'b' if arch == 'mixtral-8x7b' else 'c'}): {arch} at "
          f"the published widths (d {cfg.d_model}, {cfg.n_heads} heads over "
          f"{cfg.n_kv_heads} KV heads, hd {cfg.hd}, {cfg.n_experts} experts "
          f"top-{cfg.top_k} of d_ff {cfg.d_ff}"
          + (" + a shared expert" if cfg.shared_expert else "")
          + f", vocab {cfg.vocab}, "
          + (f"window {cfg.attn_window}" if cfg.attn_window else
             f"chunk {cfg.attn_chunk}, every {cfg.global_every}th layer "
             "global") + ", bf16)")
    print(f"  reduction: {arch} n_layers {full.n_layers} -> {cfg.n_layers} "
          f"({layer_gb:.2f} GB a layer; all {full.n_layers} would be "
          f"{full.total_params() * 2 / 1e9:.1f} GB of bf16 weights, the card "
          "holds 80 GB)")
    params = T.init_params(torch.Generator(device).manual_seed(MOE_SEED),
                           cfg, device=device)
    torch.cuda.synchronize()
    weights = _param_bytes(params)
    print(f"  random weights from seed {MOE_SEED}: {weights / 1e9:.2f} GB "
          f"drawn on the card in {time.perf_counter() - clock:.1f} s")
    n_local = sum(1 for i in range(cfg.n_layers)
                  if T._local_terms(cfg, i) != {"window": None,
                                                "chunk": None})
    key = ("flash_attention_window" if cfg.attn_window else
           "flash_attention_chunk")
    rng = np.random.default_rng(MOE_SEED)
    total = dict.fromkeys(ops.launches, 0)
    with torch.inference_mode():
        for B, S in MOE_PREFILL:
            tokens = torch.from_numpy(rng.integers(
                0, cfg.vocab, (B, S))).to(device)
            want = T.prefill(params, tokens, cfg)       # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            walls = []
            for _ in range(MOE_PREFILLS):
                t0 = time.perf_counter()
                logits = T.prefill(params, tokens, cfg)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            launches = dict(ops.launches)
            peak = torch.cuda.max_memory_allocated() / 1e9
            expect = dict.fromkeys(launches, 0)
            expect[key] = MOE_PREFILLS * n_local
            expect["flash_attention"] = MOE_PREFILLS * (cfg.n_layers
                                                        - n_local)
            if launches != expect:
                raise AssertionError(f"launches {launches}, expected "
                                     f"{expect}")
            for k_, n in launches.items():
                total[k_] += n
            if (logits.shape != (B, cfg.vocab)
                    or not torch.isfinite(logits).all().item()
                    or not torch.equal(logits, want)):
                raise AssertionError("prefill logits are not finite of "
                                     f"shape {(B, cfg.vocab)} or differ "
                                     "between two prefills")
            wall = float(np.mean(walls))
            print(f"  prefill {B} x {S}: wall "
                  + ", ".join(f"{w:.4f}" for w in walls)
                  + f" s (mean {wall:.4f} s, {B * S / wall:.1f} tokens/s), "
                  f"peak memory {peak:.2f} GB; logits finite, bit-equal "
                  f"across the prefills; launches {key} {launches[key]}, "
                  f"flash_attention {launches['flash_attention']}, every "
                  "other counter 0")
            parts = _moe_breakdown(params, tokens, cfg, want)
            print(f"  one prefill {B} x {S}, stream time by part (ms, CUDA "
                  f"events, summed over {cfg.n_layers} layers): "
                  + ", ".join(f"{k_} {v:.3f}" for k_, v in parts.items())
                  + f"; all parts {sum(parts.values()):.3f}")
            del tokens, want, logits
            _release()
        _stamp(clock)
        h2d, syncs, _ = _transfers(lambda: T.prefill(
            params, torch.zeros((1, 4096), dtype=torch.int64,
                                device=device), cfg))
        if h2d or syncs:
            raise AssertionError(f"a prefill made {h2d} host-to-device "
                                 f"copies and {syncs} syncs")

        # ---- the server at decode_32k
        requests = _decode_requests(cfg, np.random.default_rng(DECODE_SEED))
        srv = _counted_server(params, cfg, DECODE_SLOTS, DECODE_LEN)
        cache_b = _cache_bytes(srv.cache)
        Skv = srv.cache["k"].shape[3]
        for r in requests:
            srv.submit(r)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        stats = srv.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        n_tok = stats["decoded_tokens"]
        if (n_tok != DECODE_REQUESTS * DECODE_NEW
                or any(len(r.out) != DECODE_NEW for r in requests)
                or not srv.finite.item()):
            raise AssertionError("the server decoded "
                                 f"{[len(r.out) for r in requests]} tokens "
                                 "or a logit is not finite")
        t_end = int(srv.cache["t"].item())
        bound_ms = _moe_decode_bound(params, srv.cache, cfg,
                                     DECODE_SLOTS)[0]
        print(f"  BatchedServer at decode_32k ({DECODE_SLOTS} slots of "
              f"{DECODE_LEN} positions, a {Skv}-slot "
              + ("ring" if Skv < DECODE_LEN else "cache")
              + f", {cache_b / 1e9:.2f} GB): {DECODE_REQUESTS} requests, "
              f"{n_tok} tokens in {srv.calls} decode_step calls "
              f"({srv.calls - stats['steps']} fill, {stats['steps']} decode)"
              f", t {t_end} at the end; wall {wall:.4f} s "
              f"({n_tok / wall:.2f} tokens/s, {wall / srv.calls * 1e3:.3f} "
              f"ms a call; a call's bound {bound_ms:.3f} ms), peak memory "
              f"{peak / 1e9:.2f} GB; every logit finite; first request's "
              f"tokens {requests[0].out[:8]}...")
        del srv, requests
        _release()
        _stamp(clock)
        if cfg.attn_window:
            _moe_long(device, params, cfg)
            _stamp(clock)
    del params
    _release()
    return total


def phase_moe_agreement(device):
    """Phase 15 (d): both MoE smoke configs (f32) on the card and on the
    CPU from one state drawn on the CPU: prefill logits, 3 x window (or
    chunk) decode steps across the ring's wrap (atol 5e-5, rtol 1e-5:
    float32 products summed in other orders), and the server's tokens,
    token for token."""
    import torch

    from repro_torch import configs, tree_map
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.runtime.serve import BatchedServer, Request

    for arch in MOE_LAYERS:
        cfg = configs.get(arch).smoke_cfg
        cpu = T.init_params(torch.Generator("cpu").manual_seed(7), cfg,
                            device="cpu")
        gpu = tree_map(lambda t: t.to(device), cpu)
        tokens = torch.from_numpy(np.random.default_rng(8).integers(
            0, cfg.vocab, (2, 256)))
        ops.reset_launches()
        got = T.prefill(gpu, tokens.to(device), cfg)
        torch.cuda.synchronize()
        launched = (ops.launches["flash_attention_window"]
                    + ops.launches["flash_attention_chunk"]
                    + ops.launches["flash_attention"])
        if launched != cfg.n_layers or ops.launches["flash_attention_ref"]:
            raise AssertionError(f"launches {ops.launches}")
        want = T.prefill(cpu, tokens, cfg)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   atol=5e-5, rtol=1e-5)
        pre = (got.cpu() - want).abs().max().item()
        span = cfg.attn_window or cfg.attn_chunk
        ccache = T.init_cache(cfg, 3, 64, device="cpu")
        gcache = T.init_cache(cfg, 3, 64, device=device)
        worst = 0.0
        for tok in torch.from_numpy(np.random.default_rng(9).integers(
                0, cfg.vocab, (3 * span, 3))):
            want, ccache = T.decode_step(cpu, ccache, tok, cfg)
            got, gcache = T.decode_step(gpu, gcache, tok, cfg)
            np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                       atol=5e-5, rtol=1e-5)
            worst = max(worst, (got.cpu() - want).abs().max().item())
        if not torch.equal(gcache["pos"].cpu(), ccache["pos"]):
            raise AssertionError("the card's and the CPU's ring differ")
        outs = []
        for params in (gpu, cpu):
            srv = BatchedServer(params, cfg, slots=3, max_len=256)
            rng = np.random.default_rng(12)
            reqs = [Request(prompt=rng.integers(0, cfg.vocab, rng.integers(
                2, 10)), max_new_tokens=int(rng.integers(3, 9)))
                for _ in range(12)]
            for r in reqs:
                srv.submit(r)
            srv.run_to_completion()
            outs.append([r.out for r in reqs])
        if outs[0] != outs[1]:
            raise AssertionError(f"{arch}: the card's server decoded other "
                                 "tokens than the CPU's")
        print(f"phase 15 (d): {cfg.name} ({cfg.n_layers} layers, f32), card "
              f"vs CPU from one state: prefill 2 x 256 logits max |diff| "
              f"{pre:.3g}; {3 * span} decode steps of 3 slots (a "
              f"{gcache['k'].shape[3]}-slot cache; positions equal) max "
              f"|diff| {worst:.3g} (atol 5e-5, rtol 1e-5); the server's "
              f"{sum(len(o) for o in outs[0])} tokens of 12 requests equal, "
              "token for token")


# -------------------------------------- A10d training: MoE and 9b's terms (16)
MOE_TRAIN_LAYERS = 1       # mixtral-8x7b's 32 layers cut to 1 (PERF.md §4)
MOE_TRAIN_SEQ = 8192       # train_4k's 4096 doubled, so the window binds
MOE_TRAIN_BATCH = 2        # train_4k's batch 256 cut to 2: 1 sequence a pod
MOE_TRAIN_STEPS = 20       # two merges at k 10
MOE_TRAIN_K = 10
# the CPU tests' lr: at the launcher's 1e-3 mixtral's runs part after step
# 14 (the embedding's bf16 backward adds a repeated token's rows in no
# fixed order on the card), and one run went non-finite at step 19
# (PERF.md §7)
MOE_TRAIN_LR = 1e-4
LOCAL_BWD_LONG = 32768     # (a)'s timed shape: prefill_32k's sequence
# (d)'s trainer state, card against CPU: phase 14's rtol 1e-4 with atol
# 1e-5, not 1e-6.  The MoE archs' gradients carry more float32 noise than
# the dense model's (the CPU against the reference: up to 5.2e-6 of a
# leaf's largest gradient, 1.4e-6 for qwen3), and k-step Adam's local
# step divides each by sqrt(v_hat) of the last merge, a gain of ~400 for
# an embedding row seen since (tests/test_torch_moe_train.py, TRAIN_MOE).
# On the card a few elements in a million of the smoke states so part
# from the CPU's by up to ~5e-6 after 4 steps, while every loss holds
# phase 14's tolerance.
MOE_STATE_TOL = dict(rtol=1e-4, atol=1e-5)


def _local_flash_bwd_times(q, k, v, dout, window, chunk, iters=5):
    """Kernel 9b under ``window``/``chunk`` at q, k, v: cold and warm L2,
    the causal 9b at the same shape, the backward of SDPA with the boolean
    mask (the library call, K and V repeated to H heads; timed only, and
    held to the kernel within 5 % of the largest gradient) where it fits,
    and the bound from the visible pairs (10 hd FLOP a pair and head: five
    products of 2 hd)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_cuda, flash_attention_cuda)

    B, S, H, hd = q.shape
    G = H // k.shape[2]
    out, lse = flash_attention_cuda(q, k, v, True, return_lse=True,
                                    window=window, chunk=chunk)
    c_out, c_lse = flash_attention_cuda(q, k, v, True, return_lse=True)

    def kernel():
        return flash_attention_backward_cuda(q, k, v, out, lse, dout, True,
                                             window=window, chunk=chunk)

    def causal():
        return flash_attention_backward_cuda(q, k, v, c_out, c_lse, dout,
                                             True)

    got = kernel()
    res = {"shape": [B, S, H, k.shape[2], hd], "window": window,
           "chunk": chunk, "dtype": str(q.dtype).split(".")[-1]}
    try:
        mask = ref.attention_mask(S, True, window, chunk, q.device)
        xs = [x.transpose(1, 2).detach().requires_grad_(True) for x in (
            q, k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2))]
        # the memory-efficient kernel: the math one would hold the
        # (B, H, S, S) scores
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION
                         if q.is_cuda else SDPBackend.MATH):
            lib_out = F.scaled_dot_product_attention(*xs, attn_mask=mask)
        g = dout.transpose(1, 2)

        def library():
            return torch.autograd.grad(lib_out, xs, g, retain_graph=True)

        lib = library()
        worst = 0.0
        for a, b in zip(got, (lib[0], lib[1].unflatten(1, (-1, G)).sum(2),
                              lib[2].unflatten(1, (-1, G)).sum(2))):
            b = b.transpose(1, 2).float()
            worst = max(worst, (a.float() - b).abs().max().item()
                        / b.abs().max().item())
        if not worst <= 0.05:
            raise AssertionError(f"flash_attention_backward {tuple(q.shape)}"
                                 f" window {window} chunk {chunk}: SDPA's "
                                 f"backward and the kernel differ by {worst}"
                                 " of the largest gradient")
        del lib
        res["library_ms"] = _time_ms(library, iters=2, warmup=1)
        res["library_rel_diff"] = worst
        del lib_out, xs, mask
    except torch.cuda.OutOfMemoryError:
        res["library_ms"] = None
    _release()
    del got
    pairs = _visible_keys(S, window, chunk)
    flops = 10 * B * H * hd * pairs
    elt = q.element_size()
    nbytes = (4 * q.numel() + 4 * k.numel()) * elt + 4 * B * H * S
    peak = BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else F32_FLOP_PER_S
    bound_ms, bound_by = _bound(nbytes, flops, peak)
    res.update(
        ms=_time_ms(kernel, iters=iters, warmup=1),
        ms_l2_warm=_time_ms(kernel, iters=iters, warmup=1, cold_l2=False),
        causal_ms=_time_ms(causal, iters=iters, warmup=1),
        bound_ms=bound_ms, bound_by=bound_by, gflop=flops / 1e9,
        causal_bound_ms=_bound(nbytes, 10 * B * H * hd * S * (S + 1) // 2,
                               peak)[0])
    del out, lse, c_out, c_lse
    _release()
    return res


def phase_flash_local_backward(device):
    """Phase 16 (a): kernel 9b with the window and chunk terms against the
    plain vjp on the card (bf16 and f32; the edge cases), terms of S or
    more against the causal backward's bits, and the windowed and chunked
    backward timed at prefill_32k's shapes; returns the kernels line's
    ``window`` and ``chunk`` entries (without ``launches``)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_cuda, flash_attention_cuda)

    gen = torch.Generator(device).manual_seed(63)
    S = LOCAL_CHECK
    # (B, S, H, Kv, hd), dtype, window, chunk
    cases = [((1, S, 32, 8, 128), torch.bfloat16, 4096, None),
             ((1, S, 32, 8, 128), torch.float32, 4096, None),
             ((1, S, 32, 8, 128), torch.bfloat16, None, 2048),
             ((1, S, 32, 8, 128), torch.float32, None, 2048),
             ((1, LOCAL_EDGE, 40, 8, 128), torch.bfloat16, 100, None),
             ((1, LOCAL_EDGE, 8, 2, 128), torch.float32, 100, None),
             ((2, LOCAL_EDGE, 8, 2, 128), torch.bfloat16, 17, None),
             ((2, LOCAL_EDGE, 8, 2, 128), torch.float32, 17, None),
             ((1, LOCAL_EDGE, 40, 8, 128), torch.bfloat16, None, 300),
             ((1, LOCAL_EDGE, 8, 2, 128), torch.float32, None, 300),
             ((1, LOCAL_EDGE, 8, 2, 128), torch.bfloat16, 200, 256)]
    print("phase 16 (a): flash_attention_backward (kernel 9b) with the "
          "window and chunk terms against the plain vjp (autograd through "
          "ref.flash_attention_ref with the same terms); tolerance: the "
          "causal backward's, every gradient within 1e-5 (f32) or 2e-2 "
          "(bf16) of its largest magnitude")
    names = sorted(set(sum(FLASH_BWD_KERNELS.values(), ())))
    plain, max_err, max_err_bf16 = {}, 0.0, 0.0
    for (B, S_, H, Kv, hd), dtype, window, chunk in cases:
        name = str(dtype).split(".")[-1]
        q = torch.randn((B, S_, H, hd), generator=gen, device=device).to(
            dtype)
        k, v = [torch.randn((B, S_, Kv, hd), generator=gen,
                            device=device).to(dtype) for _ in range(2)]
        dout = torch.randn(q.shape, generator=gen, device=device).to(dtype)
        kw = dict(window=window, chunk=chunk)
        out, lse = flash_attention_cuda(q, k, v, True, return_lse=True, **kw)
        got = flash_attention_backward_cuda(q, k, v, out, lse, dout, True,
                                            **kw)
        again = flash_attention_backward_cuda(q, k, v, out, lse, dout, True,
                                              **kw)
        torch.cuda.synchronize()
        want = ref.flash_attention_backward_ref(q, k, v, dout, True, window,
                                                chunk)
        errs = []
        for which, a, b, c in zip(("dq", "dk", "dv"), got, again, want):
            scale = c.float().abs().max().item()
            err = (a.float() - c.float()).abs().max().item()
            errs.append(err / scale)
            if (a.dtype != dtype or a.shape != c.shape
                    or not torch.equal(a, b)
                    or err > FLASH_BWD_TOL[name] * scale):
                raise AssertionError(f"flash_attention_backward "
                                     f"{(B, S_, H, Kv, hd)} {name} window "
                                     f"{window} chunk {chunk} {which}: max "
                                     f"|kernel - plain| {err} of {scale}, "
                                     "or two runs differ")
            if dtype == torch.float32:
                max_err = max(max_err, err)
            else:
                max_err_bf16 = max(max_err_bf16, err)
        ran = _graph_kernels(lambda: flash_attention_backward_cuda(
            q, k, v, out, lse, dout, True, **kw), names)
        if ran != [int(n in FLASH_BWD_KERNELS[name]) for n in names]:
            raise AssertionError(f"kernel 9b's graph holds {ran} of {names}")
        key = "window" if window is not None else "chunk"
        if S_ == S and B == 1 and key not in plain:
            plain[key] = {
                "plain_shape": [B, S_, H, Kv, hd], "plain_dtype": name,
                "plain_ms": _time_ms(lambda: ref.flash_attention_backward_ref(
                    q, k, v, dout, True, window, chunk), iters=2, warmup=1)}
        print(f"  {(B, S_, H, Kv, hd)} {name} window {window} chunk {chunk}:"
              f" max |kernel - plain| / max |plain| dq {errs[0]:.3g}, dk "
              f"{errs[1]:.3g}, dv {errs[2]:.3g}; two runs bit-equal; its "
              "graph holds its dtype's three kernels")
        del q, k, v, dout, out, lse, got, again, want
        _release()
    # terms of S or more: the causal backward's bits
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((1, S, 32, 128), generator=gen, device=device).to(
            dtype)
        k, v = [torch.randn((1, S, 8, 128), generator=gen,
                            device=device).to(dtype) for _ in range(2)]
        dout = torch.randn(q.shape, generator=gen, device=device).to(dtype)
        out, lse = flash_attention_cuda(q, k, v, True, return_lse=True)
        want = flash_attention_backward_cuda(q, k, v, out, lse, dout, True)
        for kw in (dict(window=S), dict(window=4 * S), dict(chunk=S),
                   dict(window=2 * S, chunk=S)):
            got = flash_attention_backward_cuda(q, k, v, out, lse, dout,
                                                True, **kw)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"flash_attention_backward {kw} at S "
                                     f"{S}: not the causal backward's bits")
        print(f"  (1, {S}, 32, 8, 128) {str(dtype).split('.')[-1]}: window "
              f"{S}, {4 * S}, chunk {S} and both: dq, dk, dv bit-equal to the"
              " causal backward's")
        del q, k, v, dout, out, lse, want, got
        _release()

    entries = {}
    for key, H, window, chunk in (("window", 32, 4096, None),
                                  ("chunk", 40, None, 8192)):
        q = torch.randn((1, LOCAL_BWD_LONG, H, 128), generator=gen,
                        device=device).to(torch.bfloat16)
        k, v = [torch.randn((1, LOCAL_BWD_LONG, 8, 128), generator=gen,
                            device=device).to(torch.bfloat16)
                for _ in range(2)]
        dout = torch.randn(q.shape, generator=gen, device=device).to(
            torch.bfloat16)
        t = _local_flash_bwd_times(q, k, v, dout, window, chunk)
        t.update(plain[key], launches=None)
        entries[key] = t
        lib = ("did not fit" if t["library_ms"] is None else
               f"{t['library_ms']:.4f} (max |SDPA - kernel| / max |SDPA| "
               f"{t['library_rel_diff']:.3g})")
        print(f"  times {tuple(t['shape'])} bf16 {key} {window or chunk} "
              f"(ms): kernel {t['ms']:.4f} cold, {t['ms_l2_warm']:.4f} warm "
              f"({t['gflop'] / t['ms']:.2f} TFLOP/s cold, "
              f"{t['ms'] / t['causal_ms']:.3f} of the causal backward's "
              f"{t['causal_ms']:.4f}); bound {t['bound_ms']:.4f} "
              f"({t['gflop']:.1f} GFLOP, {t['bound_by']}; causal "
              f"{t['causal_bound_ms']:.4f}); library (SDPA's backward with the"
              f" boolean mask, K and V repeated) {lib}; plain "
              f"{t['plain_ms']:.4f} at {tuple(t['plain_shape'])} "
              f"{t['plain_dtype']}")
        del q, k, v, dout
        _release()
    entries["window"]["max_abs_err"] = max_err
    entries["window"]["max_abs_err_bf16"] = max_err_bf16
    return entries


def _moe_train_cfg():
    import dataclasses as dc

    from repro_torch import configs

    return dc.replace(configs.get("mixtral-8x7b").model_cfg,
                      n_layers=MOE_TRAIN_LAYERS)


def _moe_ffn_parts(tr, batch, cfg):
    """Phase 16 (b): one pod's MoE FFN at the cell's shape (its 8192
    tokens through layer 0's MoE leaves, on random activations), forward by
    part and backward, by CUDA events: route (with the aux), dispatch, the
    expert products, combine, then the backward of all of it."""
    import torch

    from repro_torch.models import moe

    E, top_k, D = cfg.n_experts, cfg.top_k, cfg.d_model
    gsz, G = moe.groups(MOE_TRAIN_SEQ, cfg.moe_group_size)
    cap = moe.capacity(gsz, E, top_k, cfg.capacity_factor)
    lp = {k: v[0, 0].detach().requires_grad_(True)
          for k, v in tr.params["layers"].items()
          if k in ("router", "we_gate", "we_up", "we_down")}
    x = torch.randn((G, gsz, D), device=lp["router"].device,
                    dtype=cfg.dtype).requires_grad_(True)
    events = []

    def mark():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.append(e)

    torch.cuda.synchronize()
    mark()
    plan, aux = moe.route(x, lp["router"], E, top_k, cap, True)
    mark()
    xe = moe.dispatch(x, plan, E, cap)
    mark()
    ye = moe.experts(xe, lp)
    mark()
    y = moe.combine(ye, plan, gsz)
    mark()
    (y.float().square().mean() + 0.01 * aux.mean()).backward()
    mark()
    torch.cuda.synchronize()
    parts = ("route + aux", "dispatch", "expert products", "combine",
             "backward of all")
    out = {p: a.elapsed_time(b) for p, a, b in zip(parts, events,
                                                    events[1:])}
    del x, lp, plan, aux, xe, ye, y
    _release()
    return out, G, cap


def phase_moe_train(device):
    """Phase 16 (b) at full width: ``build_trainer`` of mixtral-8x7b cut to
    1 layer, 20 ``train_step`` calls of 2 x 8192 tokens (two merges), their
    launches, walls, peak memory and parts; the first step's loss against
    float32 on the same weights.  Returns the launch counts."""
    import torch

    from repro_torch.core.kstep import KStepConfig, leaves
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.kernels import ops
    from repro_torch.runtime.factory import build_trainer
    from repro_torch.runtime.trainer import TrainerConfig

    cfg = _moe_train_cfg()
    full = _moe_cfg("mixtral-8x7b")[0]
    gen = lm_batches(seed=0, batch=MOE_TRAIN_BATCH, seq_len=MOE_TRAIN_SEQ,
                     vocab=cfg.vocab)
    t0 = time.perf_counter()
    batches = [next(gen) for _ in range(MOE_TRAIN_STEPS + 2)]
    data_s = time.perf_counter() - t0
    f32_loss = _f32_first_loss(device, cfg, batches[0])
    t0 = time.perf_counter()
    tr = build_trainer("mixtral-8x7b", TrainerConfig(
        n_pod=2, kstep=KStepConfig(lr=MOE_TRAIN_LR, k=MOE_TRAIN_K,
                                   merge="two_phase")),
        model_cfg=cfg, device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n = sum(x.numel() for x in leaves(tr.params))
    state_gb = torch.cuda.memory_allocated() / 1e9
    print(f"phase 16 (b): mixtral-8x7b training at full width (d "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} KV "
          f"heads, hd {cfg.hd}, {cfg.n_experts} experts top-{cfg.top_k} of "
          f"d_ff {cfg.d_ff}, window {cfg.attn_window}, vocab {cfg.vocab}, "
          f"bf16); DenseTrainer, n_pod 2, two_phase, lr {MOE_TRAIN_LR:g}, k "
          f"{MOE_TRAIN_K}: {n} podded parameters ({n // 2} a pod), "
          f"{state_gb:.2f} GB allocated after the build ({build_s:.1f} s; "
          f"batches from lm_batches in {data_s:.1f} s)")
    print(f"  reduction: mixtral-8x7b n_layers {full.n_layers} -> "
          f"{cfg.n_layers} (32 B a podded parameter at n_pod 2: one layer "
          f"and the embedding and head are {n // 2 * 32 / 1e9:.1f} GB, two "
          f"layers would be ~101 GB)")
    print(f"  reduction: train_4k's 256 x 4096 tokens -> {MOE_TRAIN_BATCH} x"
          f" {MOE_TRAIN_SEQ} (one sequence a pod; at 4096 the window of "
          f"{cfg.attn_window} masks nothing, at {MOE_TRAIN_SEQ} it hides up "
          f"to half the keys; the MoE group stays {cfg.moe_group_size})")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    losses, walls = [], []
    for i, b in enumerate(batches[:MOE_TRAIN_STEPS]):
        t0 = time.perf_counter()
        if i >= 2:          # the first two build and warm up, then no sync
            torch.cuda.set_sync_debug_mode("error")
        try:
            loss = tr.train_step(b)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = dict(ops.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    L, P_ = cfg.n_layers, 2
    want = dict.fromkeys(launches, 0)
    want["flash_attention_window"] = 2 * MOE_TRAIN_STEPS * L * P_
    want["flash_attention_backward_window"] = MOE_TRAIN_STEPS * L * P_
    want["fused_adam"] = MOE_TRAIN_STEPS - MOE_TRAIN_STEPS // MOE_TRAIN_K
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    if not all(np.isfinite(losses)) or int(tr.opt_state.step) != \
            MOE_TRAIN_STEPS:
        raise AssertionError(f"losses {losses}, step "
                             f"{int(tr.opt_state.step)}")
    rel = abs(losses[0] - f32_loss) / abs(f32_loss)
    steady = float(np.mean(walls[2:]))
    merge_walls = [walls[i] for i in range(MOE_TRAIN_K - 1, MOE_TRAIN_STEPS,
                                           MOE_TRAIN_K)]
    tokens = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ
    print(f"  {MOE_TRAIN_STEPS} train_step calls, merges at steps "
          f"{MOE_TRAIN_K} and {2 * MOE_TRAIN_K}: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)} (finite); walls (s) "
          f"{', '.join(f'{w:.4f}' for w in walls)}; steps 3-"
          f"{MOE_TRAIN_STEPS} mean {steady:.4f} s, {tokens / steady:.1f} "
          f"tokens/s; merge steps "
          f"{', '.join(f'{w:.4f}' for w in merge_walls)} s; peak memory "
          f"{peak_gb:.2f} GB; steps 3-{MOE_TRAIN_STEPS} ran under the sync "
          "debug mode 'error'")
    print(f"  launches in the {MOE_TRAIN_STEPS} steps: "
          f"flash_attention_window {launches['flash_attention_window']} (= "
          f"2 x {L} layer x {P_} pods x {MOE_TRAIN_STEPS}: the forward and "
          f"the checkpoint's recompute), flash_attention_backward_window "
          f"{launches['flash_attention_backward_window']} (= {L} x {P_} x "
          f"{MOE_TRAIN_STEPS}), fused_adam {launches['fused_adam']} (the "
          "local steps); every other counter, every plain version, 0")
    print(f"  phase 16 (b): the first step's loss {losses[0]:.6f} against "
          f"{f32_loss:.6f} from the same weights widened to float32 on the "
          f"card (no grad): relative difference {rel:.3g} (required below "
          "1e-2)")
    if rel > 1e-2:
        raise AssertionError("the first step's loss is off the float32 one")
    parts, by_group, busy, wall_ms, top = _lm_train_breakdown(
        tr, batches[MOE_TRAIN_STEPS], cfg, groups={
            "kernel 9 (flash_attention_mma_kernel)":
                ("flash_attention_mma_kernel",),
            "kernel 9b (flash_attention_bwd_*)":
                FLASH_BWD_KERNELS["bfloat16"],
            "kernel 6 (fused_adam_kernel)": ("fused_adam_kernel",),
            "products (cuBLAS: QKV, o-proj, router, experts, head)":
                ("nvjet", "gemm", "Kernel2", "cutlass", "xmma", "sm90"),
            "index kernels (dispatch, combine, embedding)": ("index",)})
    print("  one more step by part (stream ms, CUDA events): " + "; ".join(
        f"{k} {v:.3f}" for k, v in parts.items()))
    print(f"  one more step under the profiler: wall {wall_ms:.3f} ms, "
          f"device busy {busy:.3f} ms (share {busy / wall_ms:.3f}, profiler "
          f"on); " + "; ".join(f"{k} {v:.3f} ms" for k, v in
                               by_group.items())
          + "; top kernels (ms): " + "; ".join(
              f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f}"
              for e in top))
    moe_parts, G, cap = _moe_ffn_parts(tr, batches[0], cfg)
    print(f"  one pod's MoE FFN alone ({G} groups of {cfg.moe_group_size} "
          f"tokens, capacity {cap} a group and expert; stream ms, CUDA "
          f"events): " + "; ".join(f"{k} {v:.3f}"
                                   for k, v in moe_parts.items()))
    del tr
    _release()
    return launches, {"train_step_s": steady, "tokens_per_s": tokens / steady,
                      "peak_gb": peak_gb, "busy_share": busy / wall_ms}


def phase_moe_train_smoke(device):
    """Phase 16 (c) and (d): llama4-scout-17b-16e has no full-width
    training cell (stated); both MoE smoke configs (f32, from one state
    drawn on the CPU) train on the card and on the CPU at S 64, where the
    window 16 and chunk 16 bind and llama4's layer 3 is global: 4 steps,
    n_pod 2, k 2, lr 1e-4 (two merges); the losses within phase 14's
    smoke tolerance (rtol 1e-4, atol 1e-6), the final parameters and
    moments within rtol 1e-4, atol 1e-5 (``MOE_STATE_TOL``); one
    ``moe_ffn`` backward twice on the card, bit-equal.  Returns the card's
    launch counts."""
    import torch

    from repro_torch import configs, tree_map
    from repro_torch.core.kstep import KStepConfig, leaves
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.runtime.trainer import DenseTrainer, TrainerConfig

    full = configs.get("llama4-scout-17b-16e").model_cfg
    emb_gb = 2 * full.d_model * full.vocab * 32 / 1e9
    layer_gb = (full.total_params() - 2 * full.d_model * full.vocab) * 32 / (
        full.n_layers * 1e9)
    print(f"phase 16 (c): llama4-scout-17b-16e has no full-width training "
          f"cell: at n_pod 2 (32 B a podded parameter) its embedding and "
          f"head alone take {emb_gb:.1f} GB and one layer {layer_gb:.1f} GB "
          f"more, past the card's 80 GB; its chunk term on the card is held "
          f"by (a) at (1, 32768, 40, 8, 128) chunk 8192 and by (d)")
    total = dict.fromkeys(ops.launches, 0)
    for arch in MOE_LAYERS:
        cfg = configs.get(arch).smoke_cfg
        state = T.init_params(torch.Generator("cpu").manual_seed(5), cfg,
                              device="cpu")
        tcfg = TrainerConfig(n_pod=2, kstep=KStepConfig(lr=1e-4, k=2))
        trs = [DenseTrainer(lambda p, b: T.loss_fn(p, b, cfg),
                            tree_map(lambda t: t.clone().to(d), state), tcfg,
                            device=d) for d in (device, "cpu")]
        gen = lm_batches(seed=1, batch=4, seq_len=64, vocab=cfg.vocab)
        worst = 0.0
        card = dict.fromkeys(ops.launches, 0)
        for _ in range(4):
            b = next(gen)
            ops.reset_launches()
            got = trs[0].train_step(b).item()
            for k_, n in ops.launches.items():
                card[k_] += n
            want = trs[1].train_step(b).item()
            worst = max(worst, abs(got - want) / abs(want))
            if not np.isfinite(got) or not np.isclose(got, want, rtol=1e-4,
                                                      atol=1e-6):
                raise AssertionError(f"{arch}: card loss {got}, CPU {want}")
        n_local = sum(1 for i in range(cfg.n_layers)
                      if T._local_terms(cfg, i) != {"window": None,
                                                    "chunk": None})
        key = "window" if cfg.attn_window else "chunk"
        n = 4 * 2
        if (card[f"flash_attention_backward_{key}"] != n * n_local
                or card["flash_attention_backward"] != n * (cfg.n_layers
                                                            - n_local)
                or any(v for k_, v in card.items() if k_.endswith("_ref"))):
            raise AssertionError(f"{arch}: the card's launches {card}")
        for k_, v in card.items():
            total[k_] += v
        pairs = list(zip(leaves(trs[0].params) + leaves(trs[0].opt_state.m)
                         + leaves(trs[0].opt_state.v_hat),
                         leaves(trs[1].params) + leaves(trs[1].opt_state.m)
                         + leaves(trs[1].opt_state.v_hat)))
        diff = max((a.cpu() - b).abs().max().item() for a, b in pairs)
        past = sum(int((~torch.isclose(a.cpu(), b, rtol=1e-4,
                                       atol=1e-6)).sum()) for a, b in pairs)
        for a, b in pairs:
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                       **MOE_STATE_TOL)
        # one moe_ffn backward, twice on the card
        lp = {k_: v[0, 0].detach() for k_, v in trs[0].params[
            "layers"].items()}
        x = torch.randn((4, 64, cfg.d_model), device=device,
                        generator=torch.Generator(device).manual_seed(9))
        runs = []
        for _ in range(2):
            xs = x.clone().requires_grad_(True)
            ps = {k_: v.clone().requires_grad_(True) for k_, v in lp.items()
                  if k_ in ("router", "we_gate", "we_up", "we_down",
                            "ws_gate", "ws_up", "ws_down")}
            y, aux = moe.moe_ffn(xs, ps, cfg)
            (y.square().mean() + 0.01 * aux).backward()
            runs.append([xs.grad] + [ps[k_].grad for k_ in sorted(ps)])
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            raise AssertionError(f"{arch}: two moe_ffn backwards differ")
        print(f"phase 16 (d): {cfg.name} smoke (f32, {cfg.n_layers} layers, "
              f"{key} {cfg.attn_window or cfg.attn_chunk}), n_pod 2, k 2, lr"
              f" 1e-4, 4 steps of 4 x 64 tokens on the card and on the CPU "
              f"from one state: losses (largest relative difference "
              f"{worst:.3g}) within rtol 1e-4, atol 1e-6; parameters, m and "
              f"v_hat (max |diff| {diff:.3g}; {past} of "
              f"{sum(a.numel() for a, _ in pairs)} elements past atol 1e-6) "
              f"within rtol 1e-4, atol 1e-5; on the card kernel "
              f"9 {card['flash_attention'] + card['flash_attention_' + key]}"
              f" and 9b {card['flash_attention_backward'] + card['flash_attention_backward_' + key]}"
              f" launches ({card['flash_attention_backward_' + key]} with "
              f"the {key}), no plain version; one moe_ffn backward twice on "
              "the card: the gradients of x and every MoE leaf bit-equal")
        del trs, runs
        _release()
    return total


# --------------------------------------------------- A9: DIN, DIEN, two-tower
A9_ARCHS = ("din", "dien", "two-tower-retrieval")
A9_BATCH = 65536           # recsys_shapes()["train_batch"]
# DIEN's train_batch halved: autograd keeps 1,050,839 bytes an instance
# (both GRUs' 100 steps and the attention in the GRU's space, counted on
# the CPU with saved_tensors_hooks), and every pod's forward runs before the
# one backward: 68.9 GB at 65536, 34.4 GB at 32768 (PERF.md §4)
A9_DIEN_BATCH = 32768
A9_STEPS = 20              # one merge at k 20
A9_CAPACITY = 1 << 20      # > the ~821 k distinct ids of a DIN batch
A9_SERVE_BATCH = 512       # recsys_shapes()["serve_p99"]
A9_REQUESTS = 2048
A9_CANDIDATES = 1_000_000  # recsys_shapes()["retrieval_cand"]
A9_PARTS = ("pull (stage + dedup + gather)",
            "forward (takes/bags by kernel 1 + tower)",
            "backward (kernel 1b + autograd)", "k-step Adam",
            "push (kernel 2)")


def _a9_cfg(arch):
    """The arch's published config (a rehearsal on the CPU cuts its
    table)."""
    from repro_torch import configs

    return configs.get(arch).model_cfg


def _a9_batches(mcfg, n, batch, seed=1):
    from repro_torch.data.synthetic import recsys_batches

    stream = recsys_batches(mcfg, batch=batch, seed=seed)
    return [next(stream) for _ in range(n)]


def _a9_stream_ahead():
    """Each A9 arch's ``A9_STEPS`` training batches, drawn in background
    threads (numpy's bulk draws release the GIL) while the card runs (a):
    {arch: future of the batches}."""
    import concurrent.futures

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=len(A9_ARCHS))
    futures = {arch: pool.submit(
        _a9_batches, _a9_cfg(arch), A9_STEPS,
        A9_DIEN_BATCH if arch == "dien" else A9_BATCH) for arch in A9_ARCHS}
    pool.shutdown(wait=False)
    return futures


def _a9_ids(mcfg, b):
    """A batch's item ids, instance-major (history, then the target or
    the positive item), as the engine joins them."""
    if "hist_ids" in b:
        return np.concatenate([b["hist_ids"], b["target_id"][:, None]], 1)
    return np.concatenate([b["user_ids"], b["item_id"][:, None]], 1)


def _a9_bag_case(device, mcfg, D, b):
    """One pod's bag inputs at the slice's width ``D`` from the training
    batch ``b`` (deduplicated at the capacity, pod 0 of n_pod 2):
    ``(working, [(name, inv, seg, w, num_bags)])``; DIN's B x 101 takes as
    bags of one id; two-tower's mask-weighted history bag of 50 and its
    item take."""
    import torch

    from repro_torch.core.embedding_backend import _dedup

    ids = torch.from_numpy(_a9_ids(mcfg, b)).to(device)
    _, inv, _ = _dedup(ids.reshape(-1), A9_CAPACITY)
    half = A9_BATCH // 2
    inv = inv.reshape(A9_BATCH, -1)[:half]
    gen = torch.Generator(device).manual_seed(17)
    working = torch.randn((A9_CAPACITY + 1, D), generator=gen, device=device)
    working[A9_CAPACITY] = 0
    arange = lambda n: torch.arange(n, dtype=torch.int32,      # noqa: E731
                                    device=device)
    if "hist_ids" in b:
        flat = inv.reshape(-1).contiguous()
        return working, [("takes (DIN pod)", flat, arange(flat.numel()),
                          None, flat.numel())]
    H = mcfg.user_hist_len
    hist = inv[:, :H].reshape(-1).contiguous()
    mask = torch.from_numpy(b["user_mask"][:half]).to(device).reshape(-1)
    item = inv[:, H].contiguous()
    return working, [
        ("history bag (two-tower pod)", hist,
         arange(half).repeat_interleave(H), mask, half),
        ("item takes (two-tower pod)", item, arange(half), None, half)]


def _a9_bag_times(working, inv, seg, w, num_bags):
    """Kernel 1 (the wrapper), its plain version and two library calls
    (``F.embedding_bag`` on the same CSR, ``index_select`` for a take or
    ``index_add_`` for a bag) on one input, and its bound (ms)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import embedding_bag as kb
    from repro_torch.kernels import ref

    order, offsets = kb.csr_from_segments(seg, num_bags)
    inv_s, w_s = inv[order].long(), None if w is None else w[order]
    inv64, seg64 = inv.long(), seg.long()
    take = num_bags == inv.numel()

    def wrapper():
        return kb.embedding_bag_cuda(working, inv, seg, w, num_bags)

    def embedding_bag():
        return F.embedding_bag(inv_s, working, offsets, mode="sum",
                               per_sample_weights=w_s,
                               include_last_offset=True)

    def library():
        if take:
            return working.index_select(0, inv64)
        return torch.zeros((num_bags, working.shape[1]),
                           device=working.device).index_add_(
            0, seg64, working[inv64] * w[:, None])

    want = ref.embedding_bag_ref(working, inv, seg, w, num_bags)
    for fn in (embedding_bag, library):
        if not torch.allclose(fn(), want, **TOL):
            raise AssertionError("a library call differs from the plain bag")
    D = working.shape[1]
    nbytes = (torch.unique(inv).numel() * D * 4
              + inv.numel() * (8 if w is None else 12) + num_bags * D * 4)
    bound_ms, bound_by = _bound(nbytes, 2 * inv.numel() * D)
    iters = 20
    return {"ms": _time_ms(wrapper, iters=iters),
            "ms_l2_warm": _time_ms(wrapper, iters=iters, cold_l2=False),
            "plain_ms": _time_ms(lambda: ref.embedding_bag_ref(
                working, inv, seg, w, num_bags), iters=iters),
            "embedding_bag_ms": _time_ms(embedding_bag, iters=iters),
            "library_ms": _time_ms(library, iters=iters),
            "library": "index_select" if take else "index_add_",
            "bound_ms": bound_ms, "bound_by": bound_by,
            "nnz": inv.numel(), "num_bags": num_bags}


def _a9_backward_times(g, working, inv, seg, w):
    """Kernel 1b (the working rows' gradient), its plain vjp, the
    ``index_add_`` library call and the bound (ms) on one input."""
    import torch

    from repro_torch.kernels import embedding_bag as kb
    from repro_torch.kernels import ref

    inv64, seg64 = inv.long(), seg.long()

    def wrapper():
        return kb.embedding_bag_backward_cuda(g, working, inv, seg, w, True,
                                              False)

    def library():
        rows = g[seg64] if w is None else g[seg64] * w[:, None]
        return torch.zeros_like(working).index_add_(0, inv64, rows)

    D = working.shape[1]
    nbytes = (torch.unique(seg).numel() * D * 4
              + inv.numel() * (8 if w is None else 12)
              + working.shape[0] * D * 4)
    bound_ms, bound_by = _bound(nbytes, 2 * inv.numel() * D)
    iters = 20
    return {"ms": _time_ms(wrapper, iters=iters),
            "ms_l2_warm": _time_ms(wrapper, iters=iters, cold_l2=False),
            "plain_ms": _time_ms(lambda: ref.embedding_bag_backward_ref(
                g, working, inv, seg, w, True, False), iters=iters),
            "library_ms": _time_ms(library, iters=iters),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "hot_row_entries": int(torch.bincount(
                inv64, minlength=working.shape[0]).max())}


def phase_a9_kernels(device):
    """Phase 17 (a): kernels 1, 1b and 2 at DIN's width 18 and two-tower's
    256 on the slice's inputs, against their plain versions; returns
    ``{kernel: {"dim18": ..., "dim256": ...}}`` for the kernels line."""
    import torch

    from repro_torch.core.embedding_backend import pull_working_set
    from repro_torch.kernels import embedding_bag as kb
    from repro_torch.kernels import ref
    from repro_torch.kernels.sparse_adagrad import sparse_adagrad_apply_cuda

    t0 = time.perf_counter()
    out = {"embedding_bag": {}, "embedding_bag_backward": {},
           "sparse_adagrad_apply": {}}
    for arch, D in (("din", 18), ("two-tower-retrieval", 256)):
        mcfg = _a9_cfg(arch)
        key = f"dim{D}"
        first = _a9_batches(mcfg, 1, A9_BATCH)[0]   # the stream's first
        working, cases = _a9_bag_case(device, mcfg, D, first)
        fwd, bwd, err_f, err_b = [], [], 0.0, 0.0
        for name, inv, seg, w, nb in cases:
            got = kb.embedding_bag_cuda(working, inv, seg, w, nb)
            again = kb.embedding_bag_cuda(working, inv, seg, w, nb)
            want = ref.embedding_bag_ref(working, inv, seg, w, nb)
            cpu = ref.embedding_bag_ref(working.cpu(), inv.cpu(), seg.cpu(),
                                        None if w is None else w.cpu(), nb)
            if not (torch.equal(got, again) and torch.equal(got.cpu(), cpu)
                    and torch.allclose(got, want, **TOL)):
                raise AssertionError(f"kernel 1 at {D}, {name}: differs from "
                                     "its plain version or between runs")
            err_f = max(err_f, (got - want).abs().max().item())
            g = torch.randn((nb, D), device=device,
                            generator=torch.Generator(device).manual_seed(D))
            gk, _ = kb.embedding_bag_backward_cuda(g, working, inv, seg, w,
                                                   True, False)
            gk2, _ = kb.embedding_bag_backward_cuda(g, working, inv, seg, w,
                                                    True, False)
            gw, _ = ref.embedding_bag_backward_ref(
                g.cpu(), working.cpu(), inv.cpu(), seg.cpu(),
                None if w is None else w.cpu(), True, False)
            if not (torch.equal(gk, gk2) and torch.equal(gk.cpu(), gw)):
                raise AssertionError(f"kernel 1b at {D}, {name}: differs from"
                                     " the CPU plain vjp or between runs")
            err_b = max(err_b, (gk.cpu() - gw).abs().max().item())
            f, bk = (_a9_bag_times(working, inv, seg, w, nb),
                     _a9_backward_times(g, working, inv, seg, w))
            fwd.append({"case": name, **f})
            bwd.append({"case": name, **bk})
            print(f"phase 17 (a): kernel 1 at dim {D}, {name} (nnz "
                  f"{inv.numel()}, {nb} bags, working {tuple(working.shape)}"
                  f"): bit-equal to the CPU plain version, two runs equal; "
                  f"ms: kernel {f['ms']:.4f} cold, {f['ms_l2_warm']:.4f} "
                  f"warm, plain {f['plain_ms']:.4f}, F.embedding_bag "
                  f"{f['embedding_bag_ms']:.4f}, {f['library']} "
                  f"{f['library_ms']:.4f}, bound {f['bound_ms']:.4f} "
                  f"({f['bound_by']})")
            print(f"phase 17 (a): kernel 1b at dim {D}, {name} (hottest "
                  f"working row {bk['hot_row_entries']} entries): bit-equal "
                  f"to the CPU plain vjp, two runs equal; ms: kernel "
                  f"{bk['ms']:.4f} cold, {bk['ms_l2_warm']:.4f} warm, plain "
                  f"vjp {bk['plain_ms']:.4f}, index_add_ "
                  f"{bk['library_ms']:.4f}, bound {bk['bound_ms']:.4f} "
                  f"({bk['bound_by']})")
        out["embedding_bag"][key] = {"max_abs_err": err_f, "cases": fwd,
                                     **{k: fwd[0][k] for k in (
                                         "ms", "ms_l2_warm", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms")}}
        out["embedding_bag_backward"][key] = {
            "max_abs_err": err_b, "cases": bwd,
            **{k: bwd[0][k] for k in ("ms", "ms_l2_warm", "plain_ms",
                                      "bound_ms", "bound_by",
                                      "library_ms")}}
        del working, cases
        # ---- kernel 2 at D: the batch's uids laid out as the pull lays
        # them out (ascending real ids, then pads), on the whole table
        ids = torch.from_numpy(_a9_ids(mcfg, first)).to(device).reshape(-1)
        uids, _ = pull_working_set(ids, A9_CAPACITY)
        n_real = int(torch.unique(ids).numel())
        gen = torch.Generator(device).manual_seed(D + 1)
        table, accum, grads, delta, g2 = _push_inputs(
            gen, uids, n_real, mcfg.item_vocab, D, device)
        want = ref.sparse_adagrad_apply_ref(table.clone(), accum.clone(),
                                            uids, delta, g2)
        for _ in range(2):      # two runs, each bit-equal to the plain one
            t, a = table.clone(), accum.clone()
            sparse_adagrad_apply_cuda(t, a, uids, grads, lr=0.5, eps=1e-10)
            if not (torch.equal(t, want[0]) and torch.equal(a, want[1])):
                raise AssertionError(f"kernel 2 at {D}: differs from its "
                                     "plain version")
            del t, a
        del want
        uids64 = uids.long()

        def kernel():
            sparse_adagrad_apply_cuda(table, accum, uids, grads, lr=0.5,
                                      eps=1e-10)

        def plain():
            ref.sparse_adagrad_apply_ref(table, accum, uids, delta, g2)

        def scatter():
            table.index_add_(0, uids64, delta)
            accum.index_add_(0, uids64, g2)

        bound_ms, bound_by, _ = _push_bound(n_real, uids.numel(), D)
        p = {"ms": _time_ms(kernel, iters=20),
             "ms_l2_warm": _time_ms(kernel, iters=20, cold_l2=False),
             "plain_ms": _time_ms(plain, iters=20),
             "scatter_ms": _time_ms(scatter, iters=20),
             "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
             "max_abs_err": 0.0, "rows": mcfg.item_vocab, "n_real": n_real}
        out["sparse_adagrad_apply"][key] = p
        print(f"phase 17 (a): kernel 2 at dim {D} ({mcfg.item_vocab} rows, "
              f"{n_real} real of {uids.numel()} uids): bit-equal to its "
              f"plain version, two runs equal; ms: kernel {p['ms']:.4f} "
              f"cold, {p['ms_l2_warm']:.4f} warm, plain {p['plain_ms']:.4f},"
              f" the scatter alone (two index_add_) {p['scatter_ms']:.4f}, "
              f"bound {bound_ms:.4f} ({bound_by})")
        del table, accum, grads, delta, g2
        _release()
    print(f"phase 17 (a) took {time.perf_counter() - t0:.1f} s")
    return out


def _a9_train_config(**kw):
    """The launcher's training settings: n_pod 2, k 20, two_phase, lr 1e-3,
    sparse lr 0.5, initial accumulator 0.01."""
    from repro_torch.core.kstep import KStepConfig
    from repro_torch.core.sparse_optim import SparseAdagradConfig
    from repro_torch.runtime.trainer import TrainerConfig

    return TrainerConfig(
        n_pod=2, kstep=KStepConfig(lr=1e-3, k=20, merge="two_phase"),
        sparse=SparseAdagradConfig(lr=0.5, initial_accumulator=0.01),
        log_every=10, **kw)


def phase_a9_train(device, arch, batches=None):
    """Phase 17 (b) and (c) for ``arch``: ``A9_STEPS`` ``fit_online`` steps
    (over ``batches``, by default drawn here) at the published widths on
    the gather placement, then a ``CTRServer`` over the trained trainer
    (and for two-tower the 1 M-candidate retrieval); returns the launch
    counts of the training run."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.runtime.factory import build_ctr_server, build_trainer
    from repro_torch.runtime.online import fit_online
    from repro_torch.runtime.serve_ctr import requests_from_batch

    mcfg = _a9_cfg(arch)
    batch = A9_DIEN_BATCH if arch == "dien" else A9_BATCH
    t_arch = t0 = time.perf_counter()
    tr = build_trainer(arch, _a9_train_config(placement="gather",
                                              capacity=A9_CAPACITY),
                       smoke=False, model_cfg=mcfg, seed=0, device=device)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    state_gb = sum(t.numel() * t.element_size() for t in
                   list(tr.tables.values())
                   + list(tr.sparse_state.accum.values())) / 1e9
    t0 = time.perf_counter()
    run = batches if batches is not None else _a9_batches(mcfg, A9_STEPS,
                                                          batch)
    data_s = time.perf_counter() - t0
    distinct = np.unique(_a9_ids(mcfg, run[0])).size
    print(f"phase 17 (b): {arch} at the published widths ({mcfg}), batch "
          f"{batch}, capacity {tr.engine.capacity}, n_pod {tr.n_pod}, k "
          f"{tr.cfg.kstep.k}, {tr.cfg.kstep.merge}, sparse lr "
          f"{tr.cfg.sparse.lr}; table + accumulator {state_gb:.2f} GB on the "
          f"card, built in {built:.1f} s; {A9_STEPS} batches ready after "
          f"{data_s:.1f} s more ({_a9_ids(mcfg, run[0]).size} ids a batch, "
          f"{distinct} distinct in the first)")
    step_losses = []
    train_step = tr.train_step

    def recorded(b):
        loss = train_step(b)
        step_losses.append(loss)
        return loss

    tr.train_step = recorded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    _, online_auc = fit_online(tr, iter(run), A9_STEPS, window=20)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del tr.train_step
    every = torch.stack(step_losses).cpu().numpy()
    n = A9_STEPS
    if every.shape != (n,) or not np.isfinite(every).all():
        raise AssertionError(f"{arch}: a loss is not finite: {every}")
    if tr.overflow_dropped != 0:
        raise AssertionError(f"{arch}: overflow_dropped "
                             f"{tr.overflow_dropped}")
    labeled = "label" in run[0]
    bags = 1 if labeled else 2      # two-tower: the history bag, the item
    want = dict.fromkeys(ops.launches, 0)
    want.update({"embedding_bag": n * (tr.n_pod + labeled) * bags,
                 "embedding_bag_backward": n * tr.n_pod * bags,
                 "sparse_adagrad_apply": n,
                 "fused_adam": n - n // tr.cfg.kstep.k})
    if launches != want:
        raise AssertionError(f"{arch}: launches {launches}, expected {want}")
    auc = f"online AUC {online_auc:.4f}" if labeled else "no labels: no AUC"
    at = (0, 1, n // 2 - 1, n - 2, n - 1)
    print(f"  losses at steps {'/'.join(str(i + 1) for i in at)}: "
          f"{', '.join(f'{every[i]:.6f}' for i in at)} (all "
          f"{n} finite, {every.min():.4f} to {every.max():.4f}); {auc}; "
          f"overflow_dropped 0")
    print(f"  {'predict + train' if labeled else 'train'} per step "
          f"(fit_online wall / {n}): {wall / n * 1e3:.2f} ms "
          f"({n * batch / wall:.1f} instances/s trained); peak device memory"
          f" {peak_gb:.2f} GB; launches: kernel 1 "
          f"{launches['embedding_bag']}, 1b "
          f"{launches['embedding_bag_backward']}, 2 "
          f"{launches['sparse_adagrad_apply']}, 6 {launches['fused_adam']}, "
          f"every other 0")
    _a9_breakdown(tr, run[:2])
    # one step under the profiler: DIEN's makes ~25 k launches
    _busy_share(tr, run[2:3])
    # ---- (c) serving over the trained trainer
    requests = _a9_batches(mcfg, 1, A9_REQUESTS, seed=2)[0]
    ids = _a9_ids(mcfg, requests)
    for i in range(0, A9_REQUESTS, A9_SERVE_BATCH):
        if np.unique(ids[i:i + A9_SERVE_BATCH]).size > tr.engine.capacity:
            raise AssertionError("a served batch would drop ids")
    srv = build_ctr_server(tr, max_batch=A9_SERVE_BATCH)
    reqs = requests_from_batch(requests)
    ops.reset_launches()
    for r in reqs:
        srv.submit(r)
    srv.drain()
    s = srv.summary()
    scores = np.asarray([r.score for r in reqs])
    ok = (np.abs(scores) <= 1 + 1e-6) if not labeled else (
        (scores > 0) & (scores < 1))
    if not (np.isfinite(scores).all() and ok.all()):
        raise AssertionError(f"{arch}: a served score is out of range")
    if int(s["served"]) != A9_REQUESTS:
        raise AssertionError(f"{arch}: served {s['served']}")
    print(f"phase 17 (c): {arch} CTRServer (max_batch {A9_SERVE_BATCH}) over"
          f" the trained trainer, {A9_REQUESTS} requests: {s['qps']:.1f} QPS,"
          f" p50 {s['p50'] * 1e3:.2f} ms, p99 {s['p99'] * 1e3:.2f} ms; "
          f"scores finite, {scores.min():.4f} to {scores.max():.4f} "
          f"({'u.v in [-1, 1]' if not labeled else 'in (0, 1)'}); no id "
          f"dropped; kernel 1 launches {ops.launches['embedding_bag']}")
    if arch == "two-tower-retrieval":
        _a9_retrieval(tr, mcfg, requests, device)
    del tr, run, srv, reqs
    _release()
    print(f"phase 17 (b)-(c): {arch} took {time.perf_counter() - t_arch:.1f}"
          " s")
    return launches


def _a9_breakdown(tr, batches):
    """Stream time of a training step by part (CUDA events between the
    parts of ``train_step``) and the synchronized ``train_step`` wall."""
    import torch

    sums = dict.fromkeys(A9_PARTS, 0.0)
    for b in batches:
        tr.step_num += 1
        merge = tr.step_num % tr.cfg.kstep.k == 0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        staged = tr._stage(b)
        wss, tables, accum, bstate = tr.engine.pull_batch(
            tr.tables, tr.sparse_state.accum, tr.backend_state, staged)
        ev[1].record()
        dense, workings, losses = tr._forward(wss, tr.pod_batch(staged))
        ev[2].record()
        dense_g, work_g = tr._backward(dense, workings, losses)
        ev[3].record()
        _adam_step_no_sync(tr, dense_g, merge)
        ev[4].record()
        tr.engine.push(tables, accum, bstate, wss, work_g)
        ev[5].record()
        torch.cuda.synchronize()
        for i, k in enumerate(A9_PARTS):
            sums[k] += ev[i].elapsed_time(ev[i + 1])
    parts = {k: v / len(batches) for k, v in sums.items()}
    walls = []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_step(b)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print("  one train step, stream time by part (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items())
        + f"; sum {sum(parts.values()):.3f}; train_step wall "
          f"(synchronized, {len(walls)} steps): mean "
          f"{np.mean(walls) * 1e3:.2f} ms, min {np.min(walls) * 1e3:.2f} ms")


def _a9_retrieval(tr, mcfg, requests, device):
    """Phase 17 (c): one user against ``A9_CANDIDATES`` items through
    ``two_tower_score_candidates`` on the card's table: the wall, scores
    in [-1, 1], and the first 1000 equal to a CPU run."""
    import torch

    from repro_torch import tree_map
    from repro_torch.core.kstep import pod_slice
    from repro_torch.models import recsys as R

    dense = pod_slice(tr.dense, 0)
    H = mcfg.user_hist_len
    ids = torch.from_numpy(requests["user_ids"][:1]).to(device)
    mask = torch.from_numpy(requests["user_mask"][:1]).to(device)
    table = tr.tables["items"]
    user = (table[ids.long()] * mask[..., None]).sum(1) / H   # the mean bag
    gen = torch.Generator(device).manual_seed(23)
    cand = torch.randperm(mcfg.item_vocab, generator=gen,
                          device=device)[:A9_CANDIDATES].to(torch.int32)
    score = lambda: R.two_tower_score_candidates(        # noqa: E731
        dense, {"items": table}, user, cand, mcfg)
    with torch.inference_mode():
        got = score()
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            score()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        cpu = R.two_tower_score_candidates(
            tree_map(lambda x: x.cpu(), dense),
            {"items": table[cand[:1000].long()].cpu()}, user.cpu(),
            torch.arange(1000, dtype=torch.int32), mcfg)
    got = got.float()
    if got.shape != (1, A9_CANDIDATES) or not torch.isfinite(got).all() \
            or got.abs().max() > 1 + 1e-6:
        raise AssertionError("retrieval scores are not finite in [-1, 1]")
    err = (got[:, :1000].cpu() - cpu).abs().max().item()
    if err > 1e-5:
        raise AssertionError(f"retrieval: card and CPU differ by {err}")
    top = torch.topk(got[0], 5)
    print(f"phase 17 (c): two-tower retrieval_cand, one user against "
          f"{A9_CANDIDATES} candidates on the card's {tuple(table.shape)} "
          f"table: wall {np.mean(walls) * 1e3:.2f} ms (mean of 3, min "
          f"{np.min(walls) * 1e3:.2f}); scores finite in [-1, 1], the first "
          f"1000 within {err:.3g} of a CPU run; top 5 "
          f"{[round(float(x), 4) for x in top.values]}")


def phase_a9_smoke(device):
    """Phase 17 (d): each A9 arch at smoke size, 6 ``fit_online`` steps on
    the gather and the cached placement, card against CPU from one state;
    returns the card's launch counts summed."""
    import torch

    from repro_torch import configs, tree_map
    from repro_torch.core.kstep import KStepAdamState, KStepConfig, leaves
    from repro_torch.data.synthetic import recsys_batches
    from repro_torch.interop import ReferenceState
    from repro_torch.kernels import ops
    from repro_torch.runtime import factory
    from repro_torch.runtime.online import fit_online
    from repro_torch.runtime.trainer import HybridTrainer, TrainerConfig

    total = dict.fromkeys(ops.launches, 0)
    for arch in A9_ARCHS:
        smoke = configs.get(arch).smoke_cfg
        # two-tower's logits are divided by its temperature 0.05: 20 times
        # the float32 noise of the others (tests/test_torch_recsys_a9.py)
        tol = dict(rtol=1e-4, atol=1e-5 if arch == "two-tower-retrieval"
                   else 1e-6)
        _, build_engine, embed_of, loss_of = factory._recsys_wiring(smoke)
        for placement in ("gather", "cached"):
            cfg = TrainerConfig(n_pod=2, kstep=KStepConfig(k=2), log_every=1,
                                placement=placement)
            src = factory.build_trainer(arch, cfg, seed=4, device=device)
            cpu_of = lambda x: x.detach().cpu().clone()      # noqa: E731
            s = src.opt_state
            tables = src.engine.export(src.tables)
            state = ReferenceState(
                dense=tree_map(cpu_of, src.dense),
                tables={n: cpu_of(t) for n, t in tables.items()},
                accum={n: cpu_of(a) for n, a in
                       src.sparse_state.accum.items()},
                opt_state=KStepAdamState(cpu_of(s.step), tree_map(cpu_of, s.m),
                                         tree_map(cpu_of, s.v_local),
                                         tree_map(cpu_of, s.v_hat), None))
            to = lambda x: x.to(device, copy=True)           # noqa: E731
            card_state = ReferenceState(
                tree_map(to, state.dense), tree_map(to, state.tables),
                tree_map(to, state.accum), KStepAdamState(
                    *(tree_map(to, f) for f in state.opt_state[:4]), None))
            out, launched = [], None
            for dev, st in ((device, card_state), ("cpu", state)):
                tr = HybridTrainer(None, build_engine(smoke, cfg, device=dev),
                                   embed_of(smoke), loss_of(smoke), cfg,
                                   state=st, device=dev)
                losses = []
                step = tr.train_step
                tr.train_step = lambda b: losses.append(step(b)) or losses[-1]
                ops.reset_launches()
                fit_online(tr, recsys_batches(smoke, batch=64, seed=5), 6,
                           window=5)
                if launched is None:
                    launched = dict(ops.launches)
                del tr.train_step
                tabs, acc, _ = tr.engine.flush(tr.tables,
                                               tr.sparse_state.accum,
                                               tr.backend_state)
                out.append([torch.stack(losses).cpu()] + [
                    torch.cat([x.reshape(-1).cpu() for x in xs]) for xs in (
                        list(tr.engine.export(tabs).values()),
                        list(acc.values()), leaves(tr.dense))])
            if any(v for k, v in launched.items() if k.endswith("_ref")):
                raise AssertionError(f"{arch} {placement}: a plain version "
                                     f"ran on the card: {launched}")
            cached = ("hash_lookup", "gather_rows_cached",
                      "sparse_adagrad_cached_apply")
            if placement == "cached" and not all(launched[k] for k in cached):
                raise AssertionError(f"{arch}: a cached kernel ran no time: "
                                     f"{launched}")
            for k, v in launched.items():
                total[k] += v
            diffs = []
            for what, a, b in zip(("losses", "tables", "accumulators",
                                   "dense"), *out):
                np.testing.assert_allclose(a.numpy(), b.numpy(),
                                           err_msg=f"{arch} {what}", **tol)
                diffs.append(f"{what} {np.abs(a.numpy() - b.numpy()).max():.3g}")
            print(f"phase 17 (d): {arch} smoke, {placement}, 6 steps, card vs"
                  f" CPU from one state: max |diff| {', '.join(diffs)} "
                  f"(rtol 1e-4, atol {tol['atol']:g}); card launches " +
                  ", ".join(f"{k} {v}" for k, v in launched.items() if v))
            del src, out
    return total


# ------------------------------------------------------------ phase 18: GIN
# gin-tu's cells (configs/gin_tu.py SHAPES), each a community_graph at the
# spec's nodes, width and classes.  community_graph takes an integer
# average degree, so the edges are cut (PERF.md §4): ogb_products
# 61,859,140 -> 61,225,725 (25 a node), minibatch_lg 114,615,892 ->
# 11,648,250 (50 a node: the sampled block's shape does not depend on it
# once every node has a neighbour), full_graph_sm 10,556 -> 10,832 (4).
GIN_DEGREE = {"ogb_products": 25, "minibatch_lg": 50, "full_graph_sm": 4}
GIN_SEED = {"ogb_products": 0, "minibatch_lg": 1, "full_graph_sm": 2}
GIN_STEPS = 20
# the launcher's k 20: at k 10 every gin-tu MODEL cell goes to NaN two
# steps after the first merge, the reference too (ROADMAP.md §C;
# tools/gin_merge_divergence.py).  So each cell's last checked step is
# the first merge, every timed step comes before it, and the steps after
# it are only reported.
GIN_K = 20
GIN_RESUME = (10, 13)      # phase 19 (b): saved at step 10, dropped at 13
GIN_ODD_WIDTHS = (257, 300, 513)
GIN_SMOKE_STEPS = 6
GIN_TOL = dict(rtol=1e-4, atol=1e-6)
GIN_EXAMPLE_STEPS = (60, 80)   # examples/train_gin.py: full graph, minibatch
GIN_FIXTURE = ROOT / "tests" / "fixtures" / "gin_example_init.npz"
GIN_PARTS = ("forward (kernel 1 + MLPs)", "backward (kernel 1b + autograd)",
             "k-step Adam")


def _gin_dims(name):
    from repro_torch import configs

    return configs.get("gin-tu").shapes[name].dims


def _gin_graph(name):
    """The cell's ``community_graph`` (host numpy)."""
    from repro_torch.data.synthetic import community_graph

    d = _gin_dims(name)
    return community_graph(GIN_SEED[name], d["n_nodes"], GIN_DEGREE[name],
                           d["d_feat"], d["n_classes"])


def _gin_blocks():
    """minibatch_lg's graph and ``GIN_STEPS`` blocks of its sampler (1024
    seeds from ``default_rng(0)``, fanouts 15 and 10)."""
    from repro_torch.data.graph_sampler import NeighborSampler

    d = _gin_dims("minibatch_lg")
    g = _gin_graph("minibatch_lg")
    sampler = NeighborSampler(d["n_nodes"], g.edge_src.astype(np.int64),
                              g.edge_dst.astype(np.int64))
    rng = np.random.default_rng(0)
    blocks = []
    for _ in range(GIN_STEPS):
        seeds = rng.choice(d["n_nodes"], d["batch_nodes"], replace=False)
        blocks.append(sampler.sample_block(rng, seeds,
                                           (d["fanout0"], d["fanout1"])))
    return g, blocks


def _gin_stream_ahead():
    """The GIN cells' graphs (and minibatch_lg's blocks), made in
    background threads while the card runs phase 17: {cell: future}."""
    import concurrent.futures

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=3)
    futures = {"ogb_products": pool.submit(_gin_graph, "ogb_products"),
               "minibatch_lg": pool.submit(_gin_blocks),
               "full_graph_sm": pool.submit(_gin_graph, "full_graph_sm")}
    pool.shutdown(wait=False)
    return futures


def _gin_model(**kw):
    from repro_torch import configs

    return dataclasses.replace(configs.get("gin-tu").model_cfg, **kw)


def _gin_train_config(**kw):
    """The launcher's k-step settings (n_pod 2, two_phase, lr 1e-3), k
    ``GIN_K``."""
    from repro_torch.core.kstep import KStepConfig
    from repro_torch.runtime.trainer import TrainerConfig

    kw.setdefault("n_pod", 2)
    kstep = KStepConfig(lr=1e-3, k=kw.pop("k", GIN_K), merge="two_phase")
    return TrainerConfig(kstep=kstep, **kw)


def _gin_subset_check(working, inv, seg, w, num_bags, out, g, g_work,
                      n=4096):
    """Kernel 1's and 1b's rows against the CPU plain version on ``n``
    sampled bags and ``n`` sampled working rows (the whole input does not
    fit the CPU's time): each sampled bag's entries, in their original
    order (picked on the card), through ``embedding_bag_ref``, and each
    sampled working row's through ``embedding_bag_backward_ref`` (their
    order is the plain version's).  Bit-equal."""
    import torch

    from repro_torch.kernels import ref

    gen = torch.Generator(working.device).manual_seed(5)
    n = min(n, num_bags, working.shape[0])

    def entries(keys, count):
        """(sorted sample, its entries' positions in original order, each
        entry's index in the sample), on the CPU."""
        pick = torch.randperm(count, generator=gen,
                              device=working.device)[:n].sort().values
        pos = torch.nonzero(torch.isin(keys, pick.to(keys.dtype))).squeeze(1)
        sub = torch.searchsorted(pick, keys[pos].long()).to(torch.int32)
        return pick, pos, sub.cpu()

    def at(t, pos):
        return None if t is None else t[pos].cpu()

    bags, pos, sub = entries(seg, num_bags)
    want = ref.embedding_bag_ref(working.cpu(), at(inv, pos), sub,
                                 at(w, pos), n)
    if not torch.equal(out[bags].cpu(), want):
        raise AssertionError("kernel 1 differs from the CPU plain version")
    rows, pos, sub = entries(inv, working.shape[0])
    want, _ = ref.embedding_bag_backward_ref(
        g.cpu(), torch.empty((n, working.shape[1])), sub, at(seg, pos),
        at(w, pos), True, False)
    if not torch.equal(g_work[rows].cpu(), want):
        raise AssertionError("kernel 1b differs from the CPU plain vjp")


def _gin_kernel_case(label, working, inv, seg, w, num_bags, full_cpu=True):
    """Kernels 1 and 1b on one input of a GIN cell: bit-equal to the CPU
    plain version (whole, or on sampled rows where the CPU would take too
    long), two runs bit-equal; timed cold and warm beside the plain
    version on the card, ``index_select`` + ``index_add_``,
    ``F.embedding_bag`` on the CSR and ``torch.sparse.mm`` (cuSPARSE SpMM)
    with a CSR adjacency; two bounds (the distinct rows read, and a row
    read per entry); the long rows (> 128 entries) of either direction.
    Returns {"forward": ..., "backward": ...}."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import embedding_bag as kb
    from repro_torch.kernels import ref

    D, nnz = working.shape[1], inv.numel()
    rows = working.shape[0]
    gen = torch.Generator(working.device).manual_seed(31)
    g = torch.randn((num_bags, D), generator=gen, device=working.device)
    out = kb.embedding_bag_cuda(working, inv, seg, w, num_bags)
    g_work, _ = kb.embedding_bag_backward_cuda(g, working, inv, seg, w)
    again = kb.embedding_bag_cuda(working, inv, seg, w, num_bags)
    g_again, _ = kb.embedding_bag_backward_cuda(g, working, inv, seg, w)
    if not (torch.equal(out, again) and torch.equal(g_work, g_again)):
        raise AssertionError(f"{label}: two runs differ")
    del again, g_again
    if full_cpu:
        cpu = [None if t is None else t.cpu() for t in (working, inv, seg, w)]
        if not torch.equal(out.cpu(), ref.embedding_bag_ref(*cpu, num_bags)):
            raise AssertionError(f"{label}: kernel 1 differs from the CPU "
                                 "plain version")
        want, _ = ref.embedding_bag_backward_ref(g.cpu(), *cpu, True, False)
        if not torch.equal(g_work.cpu(), want):
            raise AssertionError(f"{label}: kernel 1b differs from the CPU "
                                 "plain vjp")
        del cpu, want
    else:
        _gin_subset_check(working, inv, seg, w, num_bags, out, g, g_work)
    # library calls on the same input
    order, offsets = kb.csr_from_segments(seg, num_bags)
    lo, hi = int(offsets[0]), int(offsets[-1])
    inv_s = inv[order[lo:hi]].long()
    w_s = None if w is None else w[order[lo:hi]].contiguous()
    csr = torch.sparse_csr_tensor(
        (offsets - lo), inv_s, torch.ones(hi - lo, device=working.device)
        if w_s is None else w_s, size=(num_bags, rows))
    inv64, seg64 = inv.long(), seg.long()

    def index_add():
        rows_ = working.index_select(0, inv64)
        if w is not None:
            rows_ = rows_ * w[:, None]
        return torch.zeros((num_bags, D), device=working.device).index_add_(
            0, seg64, rows_)

    def index_add_bwd():
        rows_ = g.index_select(0, seg64)
        if w is not None:
            rows_ = rows_ * w[:, None]
        return torch.zeros_like(working).index_add_(0, inv64, rows_)

    lib = {"F.embedding_bag": lambda: F.embedding_bag(
               inv_s, working, offsets - lo, mode="sum",
               per_sample_weights=w_s, include_last_offset=True),
           "torch.sparse.mm": lambda: torch.sparse.mm(csr, working),
           "index_select + index_add_": index_add}
    for name, fn in lib.items():
        if not torch.allclose(fn(), out, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"{label}: {name} differs from kernel 1")
    big = nnz * D > 1 << 30
    it = dict(iters=3, warmup=1) if big else dict(iters=20)
    per_entry = 12 if w is not None else 8
    distinct_in = int(torch.unique(inv).numel())
    fwd = {"ms": _time_ms(lambda: kb.embedding_bag_cuda(
               working, inv, seg, w, num_bags), **it),
           "ms_l2_warm": _time_ms(lambda: kb.embedding_bag_cuda(
               working, inv, seg, w, num_bags), cold_l2=False, **it),
           "plain_ms": _time_ms(lambda: ref.embedding_bag_ref(
               working, inv, seg, w, num_bags), **it)}
    for name, fn in lib.items():
        fwd[f"{name}_ms"] = _time_ms(fn, **it)
    fwd["bound_ms"], fwd["bound_by"] = _bound(
        distinct_in * D * 4 + nnz * per_entry + num_bags * D * 4,
        2 * nnz * D)
    fwd["bound_per_entry_ms"], _ = _bound(
        nnz * D * 4 + nnz * per_entry + num_bags * D * 4, 2 * nnz * D)
    distinct_g = int(torch.unique(seg).numel())
    bwd = {"ms": _time_ms(lambda: kb.embedding_bag_backward_cuda(
               g, working, inv, seg, w), **it),
           "ms_l2_warm": _time_ms(lambda: kb.embedding_bag_backward_cuda(
               g, working, inv, seg, w), cold_l2=False, **it),
           "plain_ms": _time_ms(lambda: ref.embedding_bag_backward_ref(
               g, working, inv, seg, w, True, False), **it),
           "index_select + index_add__ms": _time_ms(index_add_bwd, **it)}
    bwd["bound_ms"], bwd["bound_by"] = _bound(
        distinct_g * D * 4 + nnz * per_entry + rows * D * 4, 2 * nnz * D)
    bwd["bound_per_entry_ms"], _ = _bound(
        nnz * D * 4 + nnz * per_entry + rows * D * 4, 2 * nnz * D)
    per_row = torch.bincount(inv64, minlength=rows)
    per_bag = torch.bincount(seg64[(seg64 >= 0) & (seg64 < num_bags)],
                             minlength=num_bags)
    bwd["long_rows"] = int((per_row > kb.LONG_ROW).sum())
    bwd["very_long_rows"] = int((per_row > kb.VERY_LONG).sum())
    bwd["longest_row"] = int(per_row.max())
    fwd["long_bags"] = int((per_bag > kb.LONG_ROW).sum())
    fwd["longest_bag"] = int(per_bag.max())
    shape = {"rows": rows, "dim": D, "nnz": nnz, "bags": num_bags,
             "weighted": w is not None}
    print(f"phase 18 (a): {label} {shape}: kernel 1 {fwd['ms']:.4f} ms cold, "
          f"{fwd['ms_l2_warm']:.4f} warm (bounds {fwd['bound_ms']:.4f} "
          f"distinct rows, {fwd['bound_per_entry_ms']:.4f} a row an entry; "
          f"plain {fwd['plain_ms']:.4f}; " + ", ".join(
              f"{k} {fwd[k + '_ms']:.4f}" for k in lib)
          + f"); kernel 1b {bwd['ms']:.4f} cold, {bwd['ms_l2_warm']:.4f} warm"
          f" (bounds {bwd['bound_ms']:.4f}, {bwd['bound_per_entry_ms']:.4f};"
          f" plain vjp {bwd['plain_ms']:.4f}; index_select + index_add_ "
          f"{bwd['index_select + index_add__ms']:.4f}); long bags "
          f"{fwd['long_bags']} (longest {fwd['longest_bag']}), long rows "
          f"{bwd['long_rows']} ({bwd['very_long_rows']} very long, longest "
          f"{bwd['longest_row']}); bit-equal to the CPU plain version"
          f"{'' if full_cpu else ' on 4096 sampled bags and rows'}, two runs "
          "bit-equal")
    return {"forward": dict(fwd, **shape), "backward": dict(bwd, **shape)}


def phase_gin_kernels(device, graphs):
    """Phase 18 (a): kernels 1 and 1b at the GIN cells' shapes and at the
    odd widths 257, 300 and 513; returns {"embedding_bag": {shape: ...},
    "embedding_bag_backward": {shape: ...}}."""
    import torch

    from repro_torch.data.synthetic import molecule_batches

    t0 = time.perf_counter()
    out = {"embedding_bag": {}, "embedding_bag_backward": {}}

    def record(key, res):
        out["embedding_bag"][key] = res["forward"]
        out["embedding_bag_backward"][key] = res["backward"]

    def on(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return t if dtype is None else t.to(dtype)

    gen = torch.Generator(device).manual_seed(7)
    g = graphs["ogb_products"]
    src, dst, n = on(g.edge_src), on(g.edge_dst), g.x.shape[0]
    record("ogb_products_100", _gin_kernel_case(
        "ogb_products at 100", on(g.x), src, dst, None, n, full_cpu=False))
    _release()
    h = torch.randn((n, 64), generator=gen, device=device)
    record("ogb_products_64", _gin_kernel_case(
        "ogb_products at 64 (a hidden layer)", h, src, dst, None, n,
        full_cpu=False))
    del h, src, dst
    _release()
    lg, blocks = graphs["minibatch_lg"]
    blk = blocks[0]
    n_blk = blk["nodes"].shape[0]
    args = (on(blk["edge_src"]), on(blk["edge_dst"]), on(blk["edge_mask"]),
            n_blk)
    record("minibatch_lg_602", _gin_kernel_case(
        "minibatch_lg block at 602", on(lg.x[blk["nodes"]]), *args))
    record("minibatch_lg_64", _gin_kernel_case(
        "minibatch_lg block at 64", torch.randn(
            (n_blk, 64), generator=gen, device=device), *args))
    cora = graphs["full_graph_sm"]
    record("full_graph_sm_1433", _gin_kernel_case(
        "full_graph_sm at 1433", on(cora.x), on(cora.edge_src),
        on(cora.edge_dst), None, cora.x.shape[0]))
    d = _gin_dims("molecule")
    mol = next(molecule_batches(0, d["batch"], d["n_nodes"], d["n_edges"],
                                d["d_feat"], d["n_classes"]))
    nodes = mol["x"].shape[0]
    record("molecule_readout_64", _gin_kernel_case(
        "molecule readout at 64", torch.randn(
            (nodes, 64), generator=gen, device=device),
        torch.arange(nodes, dtype=torch.int32, device=device),
        on(mol["graph_ids"]), None, d["batch"]))
    for D in GIN_ODD_WIDTHS:
        rng = np.random.default_rng(D)
        C, nnz = 50_000, 400_000
        inv = rng.integers(0, C, nnz).astype(np.int32)
        inv[rng.permutation(nnz)[:3000]] = np.repeat([5, 7], [2600, 400])
        record(f"odd_{D}", _gin_kernel_case(
            f"odd width {D}", torch.randn((C, D), generator=gen,
                                          device=device), on(inv),
            on(rng.integers(0, 30_000, nnz).astype(np.int32)),
            on(rng.standard_normal(nnz).astype(np.float32)), 30_000))
    _release()
    print(f"phase 18 (a) took {time.perf_counter() - t0:.1f} s")
    return out


def _podded_draws(streams):
    """One batch from each worker's stream, stacked along a pod dim: the
    podded batch of per-worker molecule streams (a global batch split by
    ``pod_batch`` would give pod 1 graph ids past its graph count)."""
    draws = [next(s) for s in streams]
    return {k: np.stack([d[k] for d in draws]) for k in draws[0]}


def _gin_loss_check(what, losses, n):
    if losses.shape != (n,) or not np.isfinite(losses).all():
        raise AssertionError(f"{what}: a loss is not finite: {losses}")


def _gin_launches_check(what, launches, want):
    expect = dict.fromkeys(launches, 0)
    expect.update(want)
    if launches != expect:
        raise AssertionError(f"{what}: launches {launches}, expected "
                             f"{expect}")


def _gin_want(cfg, n_pod, steps, k, readout=False):
    """The launches of ``steps`` GIN steps: kernel 1 a layer a pod (and
    one for the graph readout), 1b a layer but the first (x needs no
    gradient; and one for the readout), 6 per local step."""
    extra = 1 if readout else 0
    return {"embedding_bag": steps * n_pod * (cfg.n_layers + extra),
            "embedding_bag_backward": steps * n_pod * (cfg.n_layers - 1
                                                       + extra),
            "fused_adam": 0 if k == 1 else steps - steps // k}


def _gin_category(name):
    n = name.lower()
    if "embedding_bag_backward" in n:
        return "kernel 1b"
    if "walk" in n:
        return "kernel 1 walk"
    if "stream_" in n:
        return "index streams (1, 1b)"
    if "fused_adam" in n:
        return "kernel 6"
    if "gemm" in n or "cutlass" in n or "xmma" in n or "sm90_" in n:
        return "products (cuBLAS)"
    return "elementwise and other"


def _gin_breakdown(tr, batch):
    """One DenseTrainer step's stream time by part (CUDA events), then one
    step under the profiler: device time by kernel class and the busy
    share.  Returns (the parts' times, the two steps' losses as a device
    tensor)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    tr.step_num += 1
    merge = tr.step_num % tr.cfg.kstep.k == 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    fwd = tr._forward(batch)
    ev[1].record()
    losses = [tr._backward(*fwd).mean()]
    ev[2].record()
    tr.opt.step(tr.params, tr.grads, tr.opt_state, merge=merge)
    ev[3].record()
    torch.cuda.synchronize()
    parts = {k: ev[i].elapsed_time(ev[i + 1]) for i, k in
             enumerate(GIN_PARTS)}
    del fwd
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        losses.append(tr.train_step(batch, podded=True))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                e.self_device_time_total > 0:
            c = _gin_category(e.key)
            by[c] = by.get(c, 0.0) + e.self_device_time_total / 1e3
    busy = sum(by.values())
    print("  one train step, stream time by part (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items())
        + f"; sum {sum(parts.values()):.3f}; under the profiler, device time "
          f"by kernel class (ms): " + ", ".join(
              f"{k} {v:.3f}" for k, v in sorted(by.items(),
                                               key=lambda kv: -kv[1]))
        + (f"; busy share {busy / wall_ms:.3f} ({busy:.3f} ms of device time"
           f" in a {wall_ms:.3f} ms step, profiler on)" if busy > 0 else
           "; busy share not measured (the trace holds no device time)"))
    return parts, torch.stack(losses)


def _gin_ogb_run(device, batch, cfg, steps, ckpt_dir=None, seed=0,
                 resume=False):
    """A ``build_trainer("gin-tu")`` run over ``steps`` steps of the podded
    ogb_products ``batch``: (trainer, losses as a device tensor)."""
    import torch

    from repro_torch.runtime.factory import build_trainer

    tr = build_trainer("gin-tu", _gin_train_config(
        ckpt_dir=ckpt_dir, ckpt_every=GIN_RESUME[0]), model_cfg=cfg,
        seed=seed, device=device)
    if resume and not tr.resume():
        raise AssertionError("ogb_products: no checkpoint to resume")
    losses = [tr.train_step(batch, podded=True) for _ in range(steps)]
    return tr, torch.stack(losses) if losses else None


def _gin_state(tr):
    from repro_torch import tree_map

    s = tr.opt_state
    return tree_map(lambda x: x.detach().clone(), {
        "params": tr.params, "m": s.m, "v_local": s.v_local,
        "v_hat": s.v_hat})


def _trees_equal(a, b):
    import torch

    from repro_torch.checkpoint.ckpt import _flatten_with_names

    fa, fb = _flatten_with_names(a), _flatten_with_names(b)
    return fa.keys() == fb.keys() and all(
        torch.equal(fa[k], fb[k]) for k in fa)


def phase_gin_ogb(device, g):
    """Phase 18 (b) and 19 (b)'s ogb_products part: ``GIN_STEPS`` full-batch
    steps at gin-tu's MODEL with ogb_products' width 100 and 47 classes,
    the graph staged on the card once and passed to both pods as expanded
    views.  The last four are timed: two by wall, one by part and one
    under the profiler; the last of all is the first merge, so every timed
    step is one whose loss is checked.  Three steps after the merge are
    reported, not checked (``GIN_K``).  Then a second run that saves at
    step 10, is dropped after step 13 and is resumed in a fresh trainer:
    every loss and the state after step ``GIN_STEPS`` bit-equal to the
    first run.  Returns (launches, cell)."""
    import torch

    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    cfg = _gin_model(d_in=100, n_classes=47)
    on = lambda a: torch.from_numpy(a).to(device)      # noqa: E731
    one = {"x": on(g.x), "edge_src": on(g.edge_src),
           "edge_dst": on(g.edge_dst), "labels": on(g.labels)}
    batch = {k: v.expand((2,) + tuple(v.shape)) for k, v in one.items()}
    staged = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t1 = time.perf_counter()
    n_run = GIN_STEPS - 4
    tr, losses = _gin_ogb_run(device, batch, cfg, n_run)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() / 1e9
    walls, timed = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        timed.append(tr.train_step(batch, podded=True))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    parts, last = _gin_breakdown(tr, batch)
    launches = dict(ops.launches)
    every = torch.cat([losses, torch.stack(timed), last]).cpu().numpy()
    _gin_loss_check("ogb_products", every, GIN_STEPS)
    _gin_launches_check("ogb_products", launches,
                        _gin_want(cfg, 2, GIN_STEPS, GIN_K))
    final = _gin_state(tr)
    after = torch.stack([tr.train_step(batch, podded=True)
                         for _ in range(3)]).cpu().numpy()
    print(f"phase 18 (b): ogb_products, gin-tu MODEL at width 100, 47 "
          f"classes, {g.x.shape[0]} nodes, {g.edge_src.size} edges, n_pod 2 "
          f"(one copy of the graph, expanded), k {GIN_K}, two_phase, lr 1e-3:"
          f" steps 1-{n_run} in {wall:.2f} s ({wall / n_run * 1e3:.1f} ms a "
          f"step, the graph staged in {staged:.2f} s), steps {n_run + 1}-"
          f"{GIN_STEPS} timed as below; losses {every[0]:.6f} -> "
          f"{every[-1]:.6f} (all {GIN_STEPS} finite); peak device memory "
          f"{peak:.2f} GB; launches in the {GIN_STEPS} steps: kernel 1 "
          f"{launches['embedding_bag']}, 1b "
          f"{launches['embedding_bag_backward']}, 6 {launches['fused_adam']},"
          " every other 0")
    print(f"  train_step wall (synchronized, steps {n_run + 1}-{n_run + 2}): "
          f"{np.mean(walls) * 1e3:.2f} ms mean; after the first merge (step "
          f"{GIN_STEPS}, not gated), steps {GIN_STEPS + 1}-{GIN_STEPS + 3}'s "
          f"losses: " + ", ".join(f"{x:.6g}" for x in after))
    del tr
    _release()
    # ---- phase 19 (b), DenseTrainer at full width: the second run
    ckpt = PHASE19_CKPT / "ogb_products"
    save_at, stop = GIN_RESUME
    t1 = time.perf_counter()
    tr, first = _gin_ogb_run(device, batch, cfg, stop, ckpt_dir=str(ckpt))
    tr.ckpt.wait()
    del tr
    _release()
    tr, rest = _gin_ogb_run(device, batch, cfg, GIN_STEPS - save_at,
                            ckpt_dir=str(ckpt), seed=1, resume=True)
    tr.ckpt.wait()
    again = torch.cat([first, rest]).cpu().numpy()
    if not (np.array_equal(again[:stop], every[:stop])
            and np.array_equal(again[stop:], every[save_at:])):
        raise AssertionError("ogb_products: the second run or the resumed "
                             "one differs from the first")
    if not _trees_equal(_gin_state(tr), final):
        raise AssertionError("ogb_products: the resumed state differs")
    print(f"phase 19 (b): ogb_products DenseTrainer, a second run saved at "
          f"step {save_at}, dropped after step {stop}, resumed in a fresh "
          f"trainer (another seed) and run to step {GIN_STEPS}: steps 1-"
          f"{stop} and {save_at + 1}-{GIN_STEPS} bit-equal to the first run, "
          f"params, m, v_local and v_hat too ({time.perf_counter() - t1:.1f}"
          " s)")
    del tr, batch, one
    _release()
    print(f"phase 18 (b) took {time.perf_counter() - t0:.1f} s")
    return launches, {"ms_a_step": wall / n_run * 1e3, "peak_gb": peak,
                      "parts_ms": parts}


def phase_gin_minibatch(device, lg, blocks):
    """Phase 18 (c): ``GIN_STEPS`` steps of minibatch_lg through the
    ported sampler's blocks (1024 seeds, fanouts 15 and 10; x gathered on
    the host), n_pod 1, k 1; returns the launches."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.runtime.factory import build_trainer

    t0 = time.perf_counter()
    d = _gin_dims("minibatch_lg")
    cfg = _gin_model(d_in=d["d_feat"], n_classes=d["n_classes"])
    tr = build_trainer("gin-tu", _gin_train_config(n_pod=1, k=1),
                       model_cfg=cfg, device=device)
    x = torch.from_numpy(lg.x)
    labels = torch.from_numpy(lg.labels)
    ops.reset_launches()
    losses, host = [], 0.0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for blk in blocks:
        th = time.perf_counter()
        nodes = torch.from_numpy(blk["nodes"]).long()
        batch = {"x": x.index_select(0, nodes),
                 "edge_src": blk["edge_src"], "edge_dst": blk["edge_dst"],
                 "edge_mask": blk["edge_mask"],
                 "labels": labels.index_select(0, nodes),
                 "node_mask": blk["seed_mask"]}
        host += time.perf_counter() - th
        losses.append(tr.train_step(batch))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(ops.launches)
    every = torch.stack(losses).cpu().numpy()
    _gin_loss_check("minibatch_lg", every, GIN_STEPS)
    _gin_launches_check("minibatch_lg", launches,
                        _gin_want(cfg, 1, GIN_STEPS, 1))
    real = [int(b["n_real_nodes"]) for b in blocks]
    pads = [int(b["edge_mask"].size - b["edge_mask"].sum()) for b in blocks]
    print(f"phase 18 (c): minibatch_lg, gin-tu MODEL at width 602, 41 "
          f"classes, {lg.x.shape[0]} nodes, {lg.edge_src.size} edges; blocks "
          f"of {blocks[0]['nodes'].size} nodes (real {min(real)}-{max(real)})"
          f" and {blocks[0]['edge_src'].size} edges ({min(pads)}-{max(pads)} "
          f"padded, all on node 0); n_pod 1, k 1: {GIN_STEPS} steps in "
          f"{wall:.2f} s ({wall / GIN_STEPS * 1e3:.1f} ms a step, of which "
          f"{host / GIN_STEPS * 1e3:.1f} ms the host's x[nodes] gather); "
          f"losses {every[0]:.6f} -> {every[-1]:.6f} (all finite); launches:"
          f" kernel 1 {launches['embedding_bag']}, 1b "
          f"{launches['embedding_bag_backward']}, every other 0 "
          f"({time.perf_counter() - t0:.1f} s)")
    del tr
    _release()
    return launches


def phase_gin_small(device, cora):
    """Phase 18 (d): full_graph_sm at gin-tu's own MODEL (width 1433, 7
    classes) and the molecule cell with graph readout (podded batches from
    per-worker streams), ``GIN_STEPS`` steps each at the launcher's
    settings; returns {cell: launches}."""
    import torch

    from repro_torch.data.synthetic import molecule_batches
    from repro_torch.kernels import ops
    from repro_torch.runtime.factory import build_trainer

    t0 = time.perf_counter()
    out = {}
    cfg = _gin_model()
    on = lambda a: torch.from_numpy(a).to(device)      # noqa: E731
    batch = {k: on(v).expand((2,) + v.shape) for k, v in (
        ("x", cora.x), ("edge_src", cora.edge_src),
        ("edge_dst", cora.edge_dst), ("labels", cora.labels))}
    d = _gin_dims("molecule")
    mcfg = _gin_model(d_in=d["d_feat"], n_classes=d["n_classes"],
                      readout="graph")
    streams = [molecule_batches(0, d["batch"], d["n_nodes"], d["n_edges"],
                                d["d_feat"], d["n_classes"], worker=i)
               for i in range(2)]
    mol = [_podded_draws(streams) for _ in range(GIN_STEPS)]
    for name, c, batches, readout in (
            ("full_graph_sm", cfg, [batch] * GIN_STEPS, False),
            ("molecule", mcfg, mol, True)):
        tr = build_trainer("gin-tu", _gin_train_config(), model_cfg=c,
                           device=device)
        ops.reset_launches()
        t1 = time.perf_counter()
        losses = torch.stack([tr.train_step(b, podded=True)
                              for b in batches])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = dict(ops.launches)
        every = losses.cpu().numpy()
        _gin_loss_check(name, every, GIN_STEPS)
        _gin_launches_check(name, launches,
                            _gin_want(c, 2, GIN_STEPS, GIN_K, readout))
        print(f"phase 18 (d): {name} (width {c.d_in}, {c.n_classes} classes,"
              f" {c.readout} readout), n_pod 2, k {GIN_K}: {GIN_STEPS} steps,"
              f" {wall / GIN_STEPS * 1e3:.2f} ms a step; losses "
              f"{every[0]:.6f} -> {every[-1]:.6f} (all finite); launches: "
              f"kernel 1 {launches['embedding_bag']}, 1b "
              f"{launches['embedding_bag_backward']}, 6 "
              f"{launches['fused_adam']}, every other 0")
        out[name] = launches
        del tr
    print(f"phase 18 (d) took {time.perf_counter() - t0:.1f} s")
    return out


def phase_gin_smoke(device):
    """Phase 18 (e): gin-tu's smoke config, card against CPU from one
    state, ``GIN_SMOKE_STEPS`` steps at n_pod 2, k 2, lr 1e-4, node readout
    on a community graph and graph readout on molecule batches: losses
    and parameters within rtol 1e-4, atol 1e-6."""
    import torch

    from repro_torch import configs, tree_map
    from repro_torch.core.kstep import KStepConfig, leaves
    from repro_torch.data.synthetic import community_graph, molecule_batches
    from repro_torch.models import gin as G
    from repro_torch.runtime.trainer import DenseTrainer, TrainerConfig

    smoke = configs.get("gin-tu").smoke_cfg
    g = community_graph(7, 500, 6, smoke.d_in, smoke.n_classes)
    node = {k: np.stack([v] * 2) for k, v in (
        ("x", g.x), ("edge_src", g.edge_src), ("edge_dst", g.edge_dst),
        ("labels", g.labels))}
    streams = [molecule_batches(3, 16, 10, 20, smoke.d_in, smoke.n_classes,
                                worker=i) for i in range(2)]
    mol = [_podded_draws(streams) for _ in range(GIN_SMOKE_STEPS)]
    for name, cfg, batches in (
            ("node readout", smoke, [node] * GIN_SMOKE_STEPS),
            ("graph readout", dataclasses.replace(smoke, readout="graph"),
             mol)):
        params = G.init_params(torch.Generator().manual_seed(3), cfg,
                               device="cpu")
        out = []
        for dev in (device, "cpu"):
            tr = DenseTrainer(
                lambda p, b, c=cfg: G.loss_fn(p, b, c),
                tree_map(lambda x: x.to(dev, copy=True), params),
                TrainerConfig(n_pod=2, kstep=KStepConfig(lr=1e-4, k=2)),
                device=dev)
            losses = torch.stack([tr.train_step(b, podded=True)
                                  for b in batches]).cpu()
            out.append((losses, torch.cat([x.reshape(-1).cpu()
                                           for x in leaves(tr.params)])))
        diffs = []
        for what, a, b in zip(("losses", "params"), *out):
            np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name,
                                       **GIN_TOL)
            diffs.append(f"{what} {np.abs(a.numpy() - b.numpy()).max():.3g}")
        print(f"phase 18 (e): gin-tu smoke, {name}, {GIN_SMOKE_STEPS} steps "
              f"card vs CPU from one state: max |diff| {', '.join(diffs)} "
              "(rtol 1e-4, atol 1e-6)")


def phase_gin_example(device):
    """Phase 18 (f): ``examples/train_gin.py``'s two regimes on the card
    from its initial weights (``GIN_FIXTURE``): full-graph accuracy above
    0.5 after 60 steps, minibatch above 0.4 after 80 (the example's
    bars)."""
    import torch

    from repro_torch import configs
    from repro_torch.checkpoint.ckpt import map_with_names
    from repro_torch.core.kstep import KStepConfig, pod_slice
    from repro_torch.data.graph_sampler import NeighborSampler
    from repro_torch.data.synthetic import community_graph
    from repro_torch.models import gin as G
    from repro_torch.runtime.trainer import DenseTrainer, TrainerConfig

    t0 = time.perf_counter()
    cfg = dataclasses.replace(configs.get("gin-tu").smoke_cfg, d_in=32,
                              n_classes=5)
    like = G.init_params(torch.Generator(device).manual_seed(0), cfg,
                         device=device)
    with np.load(GIN_FIXTURE) as data:
        init = map_with_names(
            lambda n, _: torch.from_numpy(data[n]).to(device), like)

    def accuracy(tr, g):
        with torch.no_grad():
            logits = G.forward(pod_slice(tr.params, 0),
                               *(torch.from_numpy(a).to(device) for a in (
                                   g.x, g.edge_src, g.edge_dst)), cfg)
        return float((logits.argmax(-1).cpu().numpy() == g.labels).mean())

    loss_fn = lambda p, b: G.loss_fn(p, b, cfg)        # noqa: E731
    full_steps, mb_steps = GIN_EXAMPLE_STEPS
    g = community_graph(0, 2000, 8, 32, 5)
    tr = DenseTrainer(loss_fn, init, TrainerConfig(n_pod=2, kstep=KStepConfig(
        lr=3e-3, k=5, b1=0.9)), device=device)
    batch = {k: np.stack([v] * 2) for k, v in (
        ("x", g.x), ("edge_src", g.edge_src), ("edge_dst", g.edge_dst),
        ("labels", g.labels))}
    for _ in range(full_steps):
        tr.train_step(batch, podded=True)
    full = accuracy(tr, g)
    g = community_graph(1, 5000, 10, 32, 5)
    sampler = NeighborSampler(5000, g.edge_src.astype(np.int64),
                              g.edge_dst.astype(np.int64))
    rng = np.random.default_rng(0)
    tr = DenseTrainer(loss_fn, init, TrainerConfig(n_pod=1, kstep=KStepConfig(
        lr=3e-3, k=1, b1=0.9)), device=device)
    for _ in range(mb_steps):
        seeds = rng.choice(5000, 128, replace=False)
        blk = sampler.sample_block(rng, seeds, fanouts=(8, 5))
        tr.train_step({"x": g.x[blk["nodes"]], "edge_src": blk["edge_src"],
                       "edge_dst": blk["edge_dst"],
                       "edge_mask": blk["edge_mask"],
                       "labels": g.labels[blk["nodes"]],
                       "node_mask": blk["seed_mask"]})
    mb = accuracy(tr, g)
    if not (full > 0.5 and mb > 0.4):
        raise AssertionError(f"the example's bars: full graph {full}, "
                             f"minibatch {mb}")
    print(f"phase 18 (f): examples/train_gin.py on the card from its "
          f"initial weights: full-graph accuracy {full:.4f} after "
          f"{full_steps} steps (bar 0.5), minibatch {mb:.4f} after {mb_steps}"
          f" (bar 0.4) ({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------- phase 19: checkpoints
PHASE19_CKPT = ROOT / "build" / "phase19_ckpt"
CKPT_STEPS = 10            # phase 19 (a): DIN steps
CKPT_EVERY = 5
CKPT_STOP = 7              # the run dropped after this step


def _hybrid_state(tr):
    """A HybridTrainer's trained state, cloned (the DiskStore synced and
    its rows read back)."""
    import torch

    from repro_torch import tree_map

    eng = tr.engine
    s = tr.opt_state
    out = {"dense": tr.dense, "m": s.m, "v_local": s.v_local,
           "v_hat": s.v_hat, "bstate": {n: tuple(v) for n, v in
                                        tr.backend_state.items()}}
    if eng.store.kind == "disk":
        eng.sync_store(tr.tables, tr.sparse_state.accum, tr.backend_state)
        for n, spec in eng.specs.items():
            rows, acc = eng.store.gather(n, np.arange(spec.rows,
                                                      dtype=np.int64))
            out[f"rows_{n}"] = torch.from_numpy(rows)
            out[f"accum_{n}"] = torch.from_numpy(acc)
    else:
        out["tables"], out["accum"] = tr.tables, tr.sparse_state.accum
    return tree_map(lambda x: x.detach().clone(), out)


def _crash_resume(make, batches, save_at, stop, ckpt, timed=False):
    """An uninterrupted run over ``batches``; a run with checkpoints every
    ``save_at`` steps in ``ckpt``, dropped after step ``stop``; a fresh
    trainer that resumes and replays the rest.  Raises unless every
    replayed loss and the final state are bit-equal to the uninterrupted
    run's.  Returns the save's timing when ``timed``."""
    import torch

    ref = make(None)
    want = torch.stack([ref.train_step(b) for b in batches]).cpu().numpy()
    state = _hybrid_state(ref)
    ref.close()
    del ref
    _release()
    tr = make(ckpt)
    saves = []
    if timed:
        save = tr.save

        def timed_save():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save()
            t1 = time.perf_counter()
            tr.ckpt.wait()
            saves.append((t1 - t0, time.perf_counter() - t0))

        tr.save = timed_save
    for b in batches[:stop]:
        tr.train_step(b)
    tr.ckpt.wait()
    tr.close()
    del tr
    _release()
    tr = make(ckpt, seed=9)
    if not tr.resume() or tr.step_num != save_at:
        raise AssertionError(f"no resume at step {save_at}")
    got = torch.stack([tr.train_step(b) for b in batches[save_at:]])
    got = got.cpu().numpy()
    if not np.array_equal(got, want[save_at:]):
        raise AssertionError(f"replayed losses {got} differ from {want}")
    if not _trees_equal(_hybrid_state(tr), state):
        raise AssertionError("the resumed state differs")
    tr.close()
    del tr
    _release()
    return want, saves


def phase_checkpoints(device, din_batches):
    """Phase 19 (a): DIN at the published widths (2 M items, gather,
    capacity 2^20, the launcher's settings) for ``CKPT_STEPS`` steps with
    ``ckpt_every`` ``CKPT_EVERY`` and the async writer: dropped after step
    ``CKPT_STOP``, resumed in a fresh trainer and replayed; losses,
    tables, accumulators, dense and moments bit-equal to an uninterrupted
    run.  (b) the same at smoke size on the cached placement and on the
    DiskStore.  Checkpoints under ``PHASE19_CKPT``, deleted at the end."""
    import shutil

    from repro_torch import configs
    from repro_torch.core.kstep import KStepConfig
    from repro_torch.core.sparse_optim import SparseAdagradConfig
    from repro_torch.data.synthetic import recsys_batches
    from repro_torch.runtime.factory import build_trainer
    from repro_torch.runtime.trainer import TrainerConfig

    t0 = time.perf_counter()
    mcfg = _a9_cfg("din")

    def din(ckpt, seed=0):
        return build_trainer("din", _a9_train_config(
            placement="gather", capacity=A9_CAPACITY,
            ckpt_dir=None if ckpt is None else str(ckpt),
            ckpt_every=CKPT_EVERY), smoke=False, model_cfg=mcfg, seed=seed,
            device=device)

    ckpt = PHASE19_CKPT / "din"
    losses, saves = _crash_resume(din, din_batches[:CKPT_STEPS], CKPT_EVERY,
                                  CKPT_STOP, ckpt, timed=True)
    npz = ckpt / f"step_{CKPT_EVERY:010d}" / "arrays_proc0.npz"
    nbytes = npz.stat().st_size
    print(f"phase 19 (a): din at the published widths ({mcfg}), batch "
          f"{A9_BATCH}, gather, capacity {A9_CAPACITY}: {CKPT_STEPS} steps "
          f"uninterrupted (losses {losses[0]:.6f} -> {losses[-1]:.6f}); a run"
          f" with ckpt_every {CKPT_EVERY} (async writer) dropped after step "
          f"{CKPT_STOP}, resumed in a fresh trainer (another seed) at step "
          f"{CKPT_EVERY} and replayed to {CKPT_STEPS}: losses, tables, "
          f"accumulators, dense and moments bit-equal; a save: "
          f"{saves[0][0] * 1e3:.1f} ms blocking (the host copy), "
          f"{saves[0][1] * 1e3:.1f} ms until the writer landed it, "
          f"{nbytes / 1e9:.3f} GB of arrays ({time.perf_counter() - t0:.1f} "
          "s)")
    smoke = configs.get("baidu-ctr").smoke_cfg
    batches = [b for b, _ in zip(recsys_batches(smoke, batch=48, seed=1),
                                 range(6))]
    for placement, store in (("cached", "host"), ("gather", "disk")):
        spill = PHASE19_CKPT / f"spill_{placement}"

        def ctr(ckpt, seed=4, placement=placement, store=store):
            return build_trainer("baidu-ctr", TrainerConfig(
                n_pod=2, kstep=KStepConfig(lr=1e-3, k=2, merge="two_phase"),
                sparse=SparseAdagradConfig(lr=0.5, initial_accumulator=0.01),
                placement=placement, capacity=1024,
                cache_rows=1024 if placement == "cached" else None,
                store=store,
                spill_dir=(str(spill / ("run" if ckpt else "ref"))
                           if store == "disk" else None),
                page_rows=256 if store == "disk" else None,
                ckpt_dir=None if ckpt is None else str(ckpt), ckpt_every=3),
                seed=seed, device=device)

        _crash_resume(ctr, batches, 3, 4, PHASE19_CKPT / f"{placement}_"
                      f"{store}")
        print(f"phase 19 (b): baidu-ctr smoke, {placement} placement, {store}"
              " store: saved at step 3, dropped after 4, resumed and "
              "replayed to 6: losses and state bit-equal")
    shutil.rmtree(PHASE19_CKPT, ignore_errors=True)


PF_ROWS = 1_000_000        # the one reduction of phase 20: 2e9 -> 1 M rows
PF_STEPS = 23              # 20 + 3: through the k-step merge at step 20
PF_PAGE_CACHE = 64         # (f): a quarter of the 245 pages
PF_TIMED = 3               # (f)'s steps a run
PF_DLRM_ROW_CAP = 1_000_000
PF_PROFILED = 5            # a run's last steps traced for the busy share


def _clone_pages(src, dst):
    """Hard-link every page file under ``src`` into ``dst``: a DiskStore
    replaces a page by ``os.replace`` and never writes one in place, so
    the clone keeps the pages as they were, whatever ``src``'s store does
    next, and costs no page write."""
    import os

    for dirpath, _, files in os.walk(src):
        out = pathlib.Path(dst) / pathlib.Path(dirpath).relative_to(src)
        out.mkdir(parents=True, exist_ok=True)
        for fn in files:
            if not fn.endswith(".tmp"):
                os.link(pathlib.Path(dirpath) / fn, out / fn)


def _pf_run(tr, batches, requests=None, pipe=None):
    """``fit``'s one-ahead loop (``runtime.trainer._fit_loop``): train on
    batch t, draw batch t+1 and ``prefetch`` it (a no-op when the trainer
    does not prefetch), then drain ``requests[t]`` through a ``CTRServer``
    with that pull in flight.  Returns a dict of the losses, every drain's
    scores, the launch counts, the wall, the device busy share in a CUDA
    profiler trace over the last ``PF_PROFILED`` steps (None where it
    holds no device time) and the steps whose ``prefetch`` returned
    before the step's end event had completed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.runtime.factory import build_ctr_server

    server = (build_ctr_server(tr, max_batch=SERVE_BATCH)
              if requests is not None else None)
    src = iter(batches) if pipe is None else pipe
    n = len(batches)
    first_profiled = max(n - PF_PROFILED, 0)
    prof = profile(activities=[ProfilerActivity.CUDA])
    losses, scores = [], []
    ahead = 0
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b = next(src)
    tr.prefetch(b)
    for i in range(n):
        if i == first_profiled:
            prof.start()
            t_prof = time.perf_counter()
        losses.append(tr.train_step(b))
        end = torch.cuda.Event()
        end.record()
        b = next(src) if i + 1 < n else None
        if tr.prefetch(b):
            ahead += not end.query()
        if server is not None:
            scores.append(_serve_scores(server, requests[i]))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    prof.stop()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"losses": torch.stack(losses).cpu().numpy(), "scores": scores,
            "launches": dict(ops.launches), "wall": t1 - t0,
            "busy": busy_us / ((t1 - t_prof) * 1e6) if busy_us else None,
            "profiled": n - first_profiled, "ahead": ahead}


def _pf_report(what, run, pipe=None, store=None, prefetched=True):
    n = len(run["losses"])
    busy = ("not measured (no device time in the trace)"
            if run["busy"] is None else f"{run['busy']:.3f}")
    parts = "train + prefetch" + (" + drain" if run["scores"] else "")
    line = (f"  {what}: {run['wall'] / n * 1e3:.2f} ms a step ({parts}, "
            f"the profiler on for the last {run['profiled']}), device busy "
            f"share over those {busy}; "
            f"losses {run['losses'][0]:.6f} ... {run['losses'][-1]:.6f}")
    if prefetched:
        line += (f"; prefetch returned before the step's end event had "
                 f"completed in {run['ahead']} of {n - 1} steps")
    if pipe is not None:
        line += (f"; pipeline read {pipe.read_seconds:.3f} s, wait "
                 f"{pipe.wait_seconds:.3f} s over {pipe.batches} batches")
    print(line)
    if store is not None:
        store._read_q.join()       # the read-ahead lands before the meters
        st, sv = store.stats(), store.serve_stats()
        if not all(np.isfinite(v) and v >= 0 for v in
                   list(st.values()) + list(sv.values())):
            raise AssertionError(f"{what}: a page meter is not finite and "
                                 f"non-negative: {st} {sv}")
        print(f"  {what}, page meters after the read-ahead drained: "
              f"training hits {st['page_hits']:.0f}, misses "
              f"{st['page_misses']:.0f}, evictions {st['pages_evicted']:.0f}"
              f", disk read {st['disk_bytes_read'] / 1e9:.3f} GB, written "
              f"{st['disk_bytes_written'] / 1e9:.3f} GB; serving hits "
              f"{sv['page_hits']:.0f}, misses {sv['page_misses']:.0f}")


def _pf_want(placement, store, n, k=20):
    """Phase 20's launch counts for ``n`` steps, each with one drain."""
    from repro_torch.kernels import ops

    want = dict.fromkeys(ops.launches, 0)
    want.update({"embedding_bag": 3 * n, "embedding_bag_backward": 2 * n,
                 "fused_adam": n - n // k})
    if placement == "cached":
        want.update({"hash_lookup": 3 * n, "gather_rows_cached": 2 * n,
                     "sparse_adagrad_cached_apply": n})
    elif store == "disk":
        want["sparse_adagrad"] = n
    else:
        want["sparse_adagrad_apply"] = n
    return want


def phase_prefetch(device):
    """Phase 20, the pull prefetch (A5), baidu-ctr at full width with 1 M
    rows, 23 steps a run with a 256-request drain after each step's
    prefetch: (a) gather, host store, synchronous; (b) gather, host store,
    prefetched, fed by ``PrefetchPipeline`` with ``CudaStager``; (c) cached
    on the host store, (d) gather and (e) cached on the DiskStore
    (unbounded page cache), prefetched; (f) cached on the DiskStore with a
    64-page cache, 3 steps synchronous and 3 prefetched from fresh stores;
    (g) dlrm-mlperf at the published widths, tables capped at 1 M rows,
    batch 65536, 23 steps synchronous and prefetched.  Returns the launch
    counts of (b), (c), (d), (e) and (g)."""
    import shutil

    import torch

    from repro_torch.configs import dlrm_mlperf
    from repro_torch.core import row_store
    from repro_torch.data.pipeline import CudaStager, PrefetchPipeline
    from repro_torch.data.synthetic import dlrm_batches
    from repro_torch.runtime.factory import build_trainer

    t_phase = time.perf_counter()
    spill_root = ROOT / "build" / "phase20_spill"
    shutil.rmtree(spill_root, ignore_errors=True)
    spill_root.mkdir(parents=True)
    n_pages = -(-PF_ROWS // PAGE_ROWS)
    print(f"phase 20: the pull prefetch, baidu-ctr at full width, rows "
          f"{PF_ROWS} ({n_pages} pages of {PAGE_ROWS} rows on disk), "
          f"capacity {CAPACITY}, batch {BATCH}, n_pod 2, k 20, two_phase, "
          f"{PF_STEPS} steps a run with a {SERVE_BATCH}-request drain after "
          "each step's prefetch")
    batches = _train_batches(PF_STEPS, rows=PF_ROWS)
    requests = _train_batches(PF_STEPS, seed=2, batch=SERVE_BATCH,
                              rows=PF_ROWS)
    touched = np.unique(np.concatenate([b["ids"].reshape(-1)
                                        for b in batches])).astype(np.int64)
    results = {}
    spent, last = {}, [time.perf_counter()]

    def lap(tag):
        """Seconds since the last lap, builds and closes included."""
        now = time.perf_counter()
        spent[tag] = now - last[0]
        last[0] = now

    lap("data")
    try:
        # ---- (a) gather on the host store, synchronous: the reference run
        tr = _full_width_trainer(device, rows=PF_ROWS)
        a = _pf_run(tr, batches, requests)
        idx = torch.from_numpy(touched).to(device)
        rows_a = (tr.tables["sparse"][idx].cpu().numpy(),
                  tr.sparse_state.accum["sparse"][idx].cpu().numpy())
        if not np.isfinite(a["losses"]).all():
            raise AssertionError(f"(a) a loss is not finite: {a['losses']}")
        if a["launches"] != _pf_want("gather", "host", PF_STEPS):
            raise AssertionError(f"(a) launches {a['launches']}")
        _pf_report("(a) gather, host store, synchronous", a,
                   prefetched=False)
        del tr
        _release()
        lap("a")

        def check(tag, run, placement, store):
            if not np.array_equal(run["losses"], a["losses"]):
                raise AssertionError(
                    f"({tag}) losses differ from (a)'s: max |diff| "
                    f"{np.abs(run['losses'] - a['losses']).max()}")
            for i, (x, y) in enumerate(zip(run["scores"], a["scores"])):
                if not np.array_equal(x, y):
                    raise AssertionError(f"({tag}) drain {i}: scores differ "
                                         "from (a)'s")
            want = _pf_want(placement, store, PF_STEPS)
            if run["launches"] != want:
                raise AssertionError(f"({tag}) launches {run['launches']}, "
                                     f"the synchronous run's {want}")

        def prefetched(placement, store="host", pages=None, spill=None,
                       prefetch=True):
            kw = {}
            if store == "disk":
                kw = dict(store="disk", spill_dir=str(spill),
                          page_rows=PAGE_ROWS, page_cache_pages=pages)
            return _full_width_trainer(
                device, rows=PF_ROWS, placement=placement,
                cache_rows=CACHE_ROWS if placement == "cached" else None,
                prefetch=prefetch, **kw)

        # ---- (b) gather, host store, prefetched, fed by the pipeline
        tr = prefetched("gather")
        pipe = PrefetchPipeline(iter(batches), depth=2,
                                stage_fn=CudaStager(device))
        b = _pf_run(tr, batches, requests, pipe=pipe)
        pipe.close()
        check("b", b, "gather", "host")
        if b["launches"] != a["launches"]:
            raise AssertionError("(b) launches differ from (a)'s")
        _pf_report("(b) gather, host store, prefetched, pipeline with "
                   "CudaStager", b, pipe)
        results["b"] = b["launches"]
        del tr
        _release()
        lap("b")

        # ---- (c) cached on the host store, prefetched
        tr = prefetched("cached")
        pipe = PrefetchPipeline(iter(batches), depth=2)
        c = _pf_run(tr, batches, requests, pipe=pipe)
        pipe.close()
        check("c", c, "cached", "host")
        _pf_report(f"(c) cached ({CACHE_ROWS} rows), host store, "
                   "prefetched", c, pipe)
        results["c"] = c["launches"]
        del tr
        _release()
        lap("c")

        # ---- (d), (e): the DiskStore, unbounded page cache, prefetched
        pristine = spill_root / "pristine"
        for tag, placement in (("d", "gather"), ("e", "cached")):
            spill = spill_root / tag
            t0 = time.perf_counter()
            if pristine.exists():
                _clone_pages(pristine, spill)
            tr = prefetched(placement, "disk", None, spill)
            torch.cuda.synchronize()
            built = time.perf_counter() - t0
            if not pristine.exists():
                _clone_pages(spill, pristine)
            pipe = PrefetchPipeline(iter(batches), depth=2)
            run = _pf_run(tr, batches, requests, pipe=pipe)
            pipe.close()
            check(tag, run, placement, "disk")
            what = (f"({tag}) {placement} on the DiskStore (unbounded page "
                    "cache), prefetched")
            print(f"  {what}: trainer built in {built:.1f} s "
                  f"({'pages cloned' if tag != 'd' else 'pages written'})")
            _pf_report(what, run, pipe, tr.engine.store)
            results[tag] = run["launches"]
            tr.close()
            fresh = row_store.DiskStore(str(spill), page_rows=PAGE_ROWS)
            fresh.create_table("sparse", PF_ROWS, 64, np.float32)
            got = fresh.gather("sparse", touched)
            fresh.close()
            if not (np.array_equal(got[0], rows_a[0])
                    and np.array_equal(got[1], rows_a[1])):
                raise AssertionError(f"({tag}) the reopened store's rows "
                                     "differ from (a)'s table")
            print(f"  {what}: a fresh DiskStore on the directory reads (a)'s "
                  f"rows and accumulators at all {touched.size} touched "
                  "uids, bit-equal")
            del tr
            _release()
            shutil.rmtree(spill)
            lap(tag)

        # ---- (f) the timing pair on a 64-page cache, fresh stores
        walls, runs = [], []
        for pf in (False, True):
            spill = spill_root / f"f{int(pf)}"
            _clone_pages(pristine, spill)
            tr = prefetched("cached", "disk", PF_PAGE_CACHE, spill, pf)
            run = _pf_run(tr, batches[:PF_TIMED], requests[:PF_TIMED])
            what = (f"(f) cached on the DiskStore, {PF_PAGE_CACHE}-page "
                    f"cache, {'prefetched' if pf else 'synchronous'}")
            _pf_report(what, run, store=tr.engine.store, prefetched=pf)
            runs.append(run)
            # the store is deleted next: its threads stop, nothing is
            # synced into it (a sync through a 64-page cache rewrites
            # pages for seconds)
            tr.engine.store.close()
            del tr
            _release()
            shutil.rmtree(spill)
            lap(f"f {'prefetched' if pf else 'sync'}")
        if not (np.array_equal(runs[0]["losses"], runs[1]["losses"])
                and np.array_equal(runs[0]["losses"],
                                   a["losses"][:PF_TIMED])
                and all(np.array_equal(x, y) for x, y in
                        zip(runs[0]["scores"], runs[1]["scores"]))):
            raise AssertionError("(f) the prefetched run's losses or scores "
                                 "differ from the synchronous run's")
        want = _pf_want("cached", "disk", PF_TIMED)
        if not runs[0]["launches"] == runs[1]["launches"] == want:
            raise AssertionError("(f) launches differ: "
                                 f"{runs[0]['launches']} {runs[1]['launches']}"
                                 f", expected {want}")
        print(f"  (f) prefetched / synchronous step wall: "
              f"{runs[1]['wall'] / runs[0]['wall']:.4f}; losses, scores and "
              "launches equal")
    finally:
        shutil.rmtree(spill_root, ignore_errors=True)

    # ---- (g) dlrm-mlperf at the published widths, 1 M rows a table
    mcfg = dataclasses.replace(dlrm_mlperf.MODEL, rows=tuple(
        min(r, PF_DLRM_ROW_CAP) for r in dlrm_mlperf.MODEL.rows))
    stream = dlrm_batches(seed=1, batch=DLRM_TRAIN_BATCH, rows=mcfg.rows)
    dlrm = [next(stream) for _ in range(PF_STEPS)]
    lap("g data")
    runs = []
    for pf in (False, True):
        tr = build_trainer("dlrm-mlperf", _dlrm_train_config(
            placement="gather", capacity=DLRM_TRAIN_BATCH, prefetch=pf),
            smoke=False, model_cfg=mcfg, seed=0, device=device)
        run = _pf_run(tr, dlrm)
        if not np.isfinite(run["losses"]).all():
            raise AssertionError(f"(g) a loss is not finite: {run['losses']}")
        _pf_report(f"(g) dlrm-mlperf, {sum(mcfg.rows)} rows in 26 tables, "
                   f"batch {DLRM_TRAIN_BATCH}, "
                   f"{'prefetched' if pf else 'synchronous'}", run,
                   prefetched=pf)
        runs.append(run)
        del tr
        _release()
        lap(f"g {'prefetched' if pf else 'sync'}")
    if not np.array_equal(runs[0]["losses"], runs[1]["losses"]):
        raise AssertionError("(g) prefetched losses differ from the "
                             "synchronous run's")
    if runs[0]["launches"] != runs[1]["launches"]:
        raise AssertionError(f"(g) launches differ: {runs[0]['launches']} "
                             f"{runs[1]['launches']}")
    used = {k: v for k, v in runs[1]["launches"].items() if v}
    print(f"  (g) losses bit-equal, launches equal ({used}, every other 0); "
          f"prefetched / synchronous step wall "
          f"{runs[1]['wall'] / runs[0]['wall']:.4f}")
    results["g"] = runs[1]["launches"]
    print("phase 20 by run, seconds (builds and closes included): "
          + ", ".join(f"{k} {v:.1f}" for k, v in spent.items()))
    print(f"phase 20 took {time.perf_counter() - t_phase:.1f} s")
    return results


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from repro_torch.kernels import embedding_bag  # noqa: F401 (a checkout?)

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}, capability "
          f"{torch.cuda.get_device_capability(0)}, tf32 off")

    bag = phase_kernels(device)
    backward = phase_backward(device)
    push = phase_push(device)
    adam = phase_fused_adam(device)
    staged = phase_staged_push(device)
    phase_slice(device)
    _release()
    launches, gather_losses = phase_train(device)
    for entry in (bag, backward, push, adam):
        entry["launches"] = launches[entry["name"]]
    phase_colocated(device)
    phase_quickstart(device)
    phase_agreement(device)
    phase_agreement_train(device)
    _release()
    launches, cache_entries, rebuilds = phase_cached(device, gather_losses)
    for entry in cache_entries:
        entry["launches"] = launches[entry["name"]]
    rebuilds += phase_cached_smoke(device)
    if rebuilds < 1:
        raise AssertionError("no hash-map rebuild on the card")
    staged["launches"] = phase_disk(device)["sparse_adagrad"]
    _release()
    dot = phase_dot_interaction(device)
    dot["launches"] = phase_dlrm(device)["dot_interaction"]
    phase_dlrm_agreement(device)
    _release()
    t12 = time.perf_counter()
    dot_bwd = phase_dot_backward(device)
    dot_bwd["launches"] = phase_dlrm_train(device)["dot_interaction_backward"]
    phase_dlrm_train_smoke(device)
    print(f"phase 12 took {time.perf_counter() - t12:.1f} s")
    _release()
    t11 = time.perf_counter()
    flash = phase_flash_attention(device)
    launches, params = phase_lm(device)
    flash["launches"] = launches["flash_attention"]
    phase_lm_agreement(device)
    print(f"phase 11 took {time.perf_counter() - t11:.1f} s")
    t13 = time.perf_counter()
    phase_decode(device, params)
    phase_decode_agreement(device, params)
    del params
    _release()
    print(f"phase 13 took {time.perf_counter() - t13:.1f} s")
    t14 = time.perf_counter()
    flash_bwd = phase_flash_backward(device)
    adam["bf16"] = phase_adam_bf16(device)
    launches, cell = phase_lm_train(device)
    flash_bwd["launches"] = launches["flash_attention_backward"]
    flash["launches_train"] = launches["flash_attention"]
    adam["bf16"].update(cell, launches=launches["fused_adam"])
    phase_lm_train_smoke(device)
    print(f"phase 14 took {time.perf_counter() - t14:.1f} s")
    _release()
    t15 = time.perf_counter()
    local = phase_flash_local(device)
    launches = phase_moe_lm(device, "mixtral-8x7b")
    local["window"]["launches"] = launches["flash_attention_window"]
    launches = phase_moe_lm(device, "llama4-scout-17b-16e")
    local["chunk"]["launches"] = launches["flash_attention_chunk"]
    if not all(local[k]["launches"] for k in local):
        raise AssertionError(f"a local kernel 9 ran no time: {local}")
    flash.update(local)
    phase_moe_agreement(device)
    print(f"phase 15 took {time.perf_counter() - t15:.1f} s")
    _release()
    t16 = time.perf_counter()
    local_bwd = phase_flash_local_backward(device)
    launches, cell = phase_moe_train(device)
    local_bwd["window"]["launches"] = launches[
        "flash_attention_backward_window"]
    local_bwd["window"]["moe_train"] = cell
    flash["window"]["launches_train"] = launches["flash_attention_window"]
    adam["bf16"]["launches_moe_train"] = launches["fused_adam"]
    launches = phase_moe_train_smoke(device)
    local_bwd["chunk"]["launches"] = launches[
        "flash_attention_backward_chunk"]
    if not all(local_bwd[k]["launches"] for k in local_bwd):
        raise AssertionError(f"a local kernel 9b ran no time: {local_bwd}")
    flash_bwd.update(local_bwd)
    print(f"phase 16 took {time.perf_counter() - t16:.1f} s")
    _release()
    t17 = time.perf_counter()
    streams = _a9_stream_ahead()
    gin = _gin_stream_ahead()
    a9 = phase_a9_kernels(device)
    for entry in (bag, backward, push):
        entry.update(a9[entry["name"]])
        entry["launches_a9"] = {}
    for arch in A9_ARCHS:
        launches = phase_a9_train(device, arch, streams[arch].result())
        for entry in (bag, backward, push):
            entry["launches_a9"][arch] = launches[entry["name"]]
        adam.setdefault("launches_a9", {})[arch] = launches["fused_adam"]
    launches = phase_a9_smoke(device)
    for entry in cache_entries:
        entry["launches_a9_smoke"] = launches[entry["name"]]
    if not all(e["launches_a9"][a] for e in (bag, backward, push)
               for a in A9_ARCHS):
        raise AssertionError("a kernel of the A9 path ran no time")
    print(f"phase 17 took {time.perf_counter() - t17:.1f} s")
    _release()
    t18 = time.perf_counter()
    graphs = {k: f.result() for k, f in gin.items()}
    print(f"phase 18: the GIN graphs ready {time.perf_counter() - t18:.1f} s "
          "after phase 17")
    kernels18 = phase_gin_kernels(device, graphs)
    for entry in (bag, backward):
        entry["gin"] = kernels18[entry["name"]]
    cells = {}
    cells["ogb_products"], cell = phase_gin_ogb(device,
                                                graphs["ogb_products"])
    adam["gin_ogb_products"] = cell
    cells["minibatch_lg"] = phase_gin_minibatch(device,
                                                *graphs["minibatch_lg"])
    cells.update(phase_gin_small(device, graphs["full_graph_sm"]))
    for entry in (bag, backward, adam):
        entry["launches_gin"] = {c: n[entry["name"]] for c, n in cells.items()}
    if not all(e["launches_gin"][c] for e in (bag, backward) for c in cells):
        raise AssertionError("a kernel of the GIN path ran no time")
    phase_gin_smoke(device)
    phase_gin_example(device)
    del graphs
    _release()
    print(f"phase 18 took {time.perf_counter() - t18:.1f} s")
    t19 = time.perf_counter()
    phase_checkpoints(device, streams["din"].result())
    del streams
    _release()
    print(f"phase 19 took {time.perf_counter() - t19:.1f} s; phases 18 and 19"
          f" {time.perf_counter() - t18:.1f} s")
    pf = phase_prefetch(device)
    for entry in (bag, backward, push, adam):
        entry["launches_prefetch"] = pf["b"][entry["name"]]
    for entry in cache_entries:
        entry["launches_prefetch"] = pf["c"][entry["name"]]
    staged["launches_prefetch"] = pf["d"][staged["name"]]
    for entry in (dot, dot_bwd):
        entry["launches_prefetch"] = pf["g"][entry["name"]]
    if not all(e["launches_prefetch"] for e in
               [bag, backward, push, adam, staged, dot, dot_bwd]
               + cache_entries):
        raise AssertionError("a kernel of the prefetch path ran no time")
    _release()
    print(json.dumps({"kernels": [bag, backward, push] + cache_entries
                      + [staged, adam, dot, dot_bwd, flash, flash_bwd]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
