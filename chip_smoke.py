#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits
non-zero:

1. build    -- compile the hand-written kernels from ``src/repro_torch/csrc``
2. k1       -- the serving probe step against its plain PyTorch version
               over 12 chained steps at B=8 and at the serving shape B=4
               (f=960); the same chain with zk the same tensor as zq (the
               served no-QK view, one row read) and with another tensor
               at f 128, 130, 960, 2048 and 5120, and K1(zq, zq) equal to
               K1(zq, zq.clone()) bit for bit at each; the Timer's floor
               (``floor_ms``: one launch of ``torch.empty(1).zero_()``);
               timed at B=4 in both views; the same chain and timing at
               the RWKV fleet's probe width (B 4, f 2048); 30 steps with a
               smoothing window of 17, wider than the registers hold (the
               window in shared memory), in both views; each timed row
               names its instance (threads, features a thread, registers);
               chained and timed at serve-llama's width (f 3072), both
               views, and at serve-stablelm's (f 2560), serve-granite's
               (f 1024), serve-phi's (f 4096) and serve-llava's (f 7168,
               the widest band), each the top of a band, and at
               serve-hymba's (f 1600) and serve-whisper's (f 384)
3. k2       -- paged flash decode against its plain version, bf16, int8
               and f32 pages, the serving shape and nb in {8, 64, 256}
               (past 256 positions split over blocks and merged); timed
               beside scaled_dot_product_attention over the gathered
               pages, with per_step_ms (32 layers); untimed at nb 256,
               rows with holes (bf16, int8) and rows whose valid positions
               fall in one split, in the end splits only, or in none
               (the empty-row contract); each row names its splits; then
               d 128 at G 3 (llama3.2-3b) and G 1 (qwen1.5-32b): the
               served steps of serve-llama (bf16) and serve-qwen (int8),
               the other page dtypes there, 4,096 positions split, holes
               and the one-split rows; then d 80 at G 1 (stablelm-3b):
               serve-stablelm's step in bf16, int8 and f32, 4,096
               positions split (the d-80 merge), holes, one split; then
               (64, 2) and (128, 4), serve-granite's and serve-phi's step
               in bf16, int8 and f32, 4,096 positions split, holes, one
               split; then (128, 7), serve-llava's step (4 slots on 184
               pages, split) in bf16 and f32, int8, holes, one split
4. k3       -- paged chunk attention against its plain versions, B4
               (packed chunks: 1 to 4 segments, an empty cache, padding
               and zero-length segments, nb 256) and B3 (chunks of B
               requests), bf16, int8 and f32 pages, at the served chunk of
               64 tokens; timed beside scaled_dot_product_attention over
               the gathered pages with the same mask; untimed, validity
               rows with holes (nb 16, and nb 256 split over 16 blocks)
               and a split-KV case whose last split holds no valid
               position; each row names its split count, and timed rows
               carry bound_tc_ms (the products at the tensor cores' bf16
               rate) beside bound_ms; then d 128 at G 3 and G 1, bf16,
               int8 and f32: serve-qwen's chunk, 4 segments, B3 chunks,
               4,000 positions split, holes; then the tree verify shape
               (4 slots x 10 nodes of a 3.3 tree, caches 37, 112, 200 and
               64), bf16 and int8, d 64 and d 128 at G 3, the merge under
               the ancestor mask, timed beside SDPA; then d 80 at G 1:
               serve-stablelm's chunk in bf16, int8 and f32, 4 segments,
               4,000 positions split, B3 chunks, holes, a last split
               empty, the tree verify shape; then (64, 2) and (128, 4):
               serve-granite's and serve-phi's chunk in bf16, int8 and
               f32, 4 segments, 4,000 positions split, B3 chunks, holes,
               a last split empty; then (128, 7): serve-llava's text
               chunk on its 184-page table in bf16 and f32, int8, 4,000
               positions split, a B3 chunk, holes, a last split empty
5. k4       -- the masked multi-token probe step against its plain version
               and against T masked K1 launches on copies of the same
               state, bit for bit in every case: B 1, 4, 8; T 1, 2, 4, 8;
               f 128, 960, 5120; accepted lengths 0, 1, T-1, T and mixed;
               a stop mid-chain, a slot stopped on entry, the burn-in not
               reached; zk the same tensor as zq and another tensor at f
               128, 130, 960, 2048 and 5120; smoothing windows of 17 (a
               chain of 24 tokens, so the window wraps) and 40, in shared
               memory; the Timer's floor; timed at the served shape (4
               slots, k 4, f 960) and three wider ones, at the served
               shape with a window of 40, and over T 1, 2, 4, 8 at (4, T,
               960) in both views with the slope per token; f 7168
               (serve-llava's width) in both views at T 1, 4 and 8, and
               timed at (4, 4, 7168); then K3 timed at the verify shape
               (k3-verify: 4 segments of 4 tokens)
6. k5       -- the offline TTT scan against its plain version and against
               its own L-step form (``ttt_probe_lookahead_plain`` at the
               kernel's L for the width): f 128, 960, 5120, 2048 (the
               RWKV fleet's no-QK view), 3072 (the llama fleet's), 1024,
               4096 and 7168 (the granite, phi and llava fleets', each the
               top of a band), N 1
               and 170, T 1, 37 and 120, c = 0 and c = labels, a
               per-trajectory and a shared init
               (120 cases on the synthetic corpus's step embeddings and
               masks); timed at N 170, T 120 for each f, with the L-step
               form's error at L 1, 2, 4 and 8; every instance of the
               kernel (L, threads, registers, shared memory); a width
               above 7168 and a tensor that requires grad refused
7. k6       -- dense flash decode against its plain version, partials and
               normalised output: B 1, 4, 24; S 16, 112, 113, 4096; bf16
               and f32 caches; full, ragged, window-band and empty rows;
               S 1024 and 4096 split over blocks (f32 too) and merged;
               timed at (4, 112), (24, 112), (8, 4096), (24, 4096) and
               (4, 1024) beside scaled_dot_product_attention over the same
               cache and mask, with per_step_ms; each row names its splits;
               then d 128 at G 3 and G 1: the harvests of serve-llama (8,
               64) and serve-qwen (8, 208), dense steps, f32, 4,096
               positions split; then d 80 at G 1: serve-stablelm's
               harvest (8, 208), a dense step, f32, 4,096 positions split;
               then (64, 2) and (128, 4): serve-granite's and serve-phi's
               harvests (8, 208), dense steps, f32, 4,096 positions split;
               then (128, 7): serve-llava's harvest batch (4, 2,944), f32,
               an admission-sized cache; then (64, 5): serve-hymba's ring
               of 1,024 (4 and 8 rows, wrapped, split over 4 blocks), f32,
               and (64, 1): whisper's cross rows over 1,500 frames (4 and
               24 rows, split over 6 blocks) and its self cache (96, 112)
8. k7       -- flash prefill attention against its plain version: (B, S)
               (1, 16), (24, 16), (1, 160), (24, 160), (4, 2048); window
               64; Sq < Sk; a window past the keys; bf16 and f32; timed
               (all but the window cases) beside SDPA with is_causal, with
               bound_ms and bound_tc_ms; then d 128 at G 3 and G 1: an
               admission (1, 16), the harvests' prefills (8, 16) and
               (8, 160), 2,048 tokens, f32, a window, Sq < Sk; then d 80:
               serve-stablelm's harvest prefill (8, 160), (1, 160),
               (1, 16), 2,048 tokens, f32, a window, Sq < Sk, a window
               past the keys (bf16 and f32); then at G 2 (d 64) and G 4
               (d 128): serve-granite's and serve-phi's harvest prefills
               (8, 160), an admission, Sq < Sk, a window past the keys;
               then at G 7 (d 128): an image admission (1, 2,896), the
               harvest's batch (4, 2,896), the admission in f32, Sq < Sk,
               a window past the keys; then hymba's admission (1, 1,128)
               and harvest (8, 1,128) with the window of 1,024 (SDPA with
               the window's mask), f32, 2,100 rows; whisper's encoder
               non-causal over 1,500 frames (1 and 24 rows; SDPA with no
               mask), f32, Sq < Sk and Sq > Sk
9. model    -- full-width smollm-360m (bf16, random weights from a seed,
               then the same weights in f32): prefill 16 tokens, 16
               teacher-forced paged decode steps through K2 (every call
               held against the plain version's formula in float64 on its
               inputs) and through
               the plain paged attention; then the dense path, the prompt
               through K7 and 16 dense decode steps through K6, every call
               checked, against the plain versions (f32: every argmax
               equal)
10. model-chunked -- the same model: a 160-token prompt through
               ``Model.prefill_chunk`` on a paged state in 64-token chunks
               (B3), then one ``prefill_packed`` chunk of two requests
               (B4), every K3 call held against its plain version; pages
               and next-step logits against one-shot prefill, bf16 and f32
11. model-spec -- the same model: ``verify_packed_chunk`` on 4 slots x k 4
               against 4 sequential paged ``decode_step``s, bf16 and f32
               (f32: every argmax equal)
12. serve   -- ``repro_torch.launch.serve`` end to end on the card:
               harvest, meta-train, calibrate, serve 8 requests on 4 slots;
               K1, K2, and K6 and K7 (the harvest and every admission)
13. trace   -- a profiler window over 4 engine steps of the same fleet:
               the card's busy share and the kernels that take it, and the
               split-KV merges a step (none at the served shapes)
14. harvest -- the driver's harvest (24 trajectories, 48 dense decode
               steps, ``HARVEST_NEW``) timed through K6 and K7 and through
               their plain versions in turns; K7 once a layer, K6 once a
               layer a step
15. serve-dense, trace-dense, trace-dense-plain -- the driver without
               ``--paged``: K1 and K6 every step (K6 32 times), K7 at the
               harvest and each admission, K2 never; the fleet line beside
               serve's and its bf16 tokens against serve's (not asserted);
               profiled windows through the kernels and through the plain
               versions
16. serve-dense-f32 -- the serve fleet in f32 at 4 of its 32 layers
               (``SPEC_F32_LAYERS``) through ``OrcaScheduler``, dense and
               paged, at a lambda* between its scores: stops and tokens
               equal
17. serve-chunked -- the driver with ``--chunk-tokens 64`` on 160-token
               prompts, the model at 8 of 32 layers (``CUT_LAYERS``; so
               are 18's, serve-spec-chunked's and 22's): the third chunk of
               each prompt packs with the head of the next; K1, K2, K3, K6
               and K7 launch
18. trace-chunked -- a 24-step window over the chunked fleet, launches and
               busy share split into steps with a chunk and without one
19. serve-spec, trace-spec, serve-spec-chunked -- the fleets of 12 and 17
               again with ``--spec-tokens 4``, the model at 8 of its 32
               layers (``CutDepth``): K4 launches once per engine
               step, its first 16 calls held against the plain version;
               requests compared with the one-token fleets (tokens and
               stops); a 4-step profiled window of the spec fleet
20. serve-spec-f32 -- the serve fleet in f32 at 4 of its 32 layers
               through ``OrcaScheduler`` at a lambda* between its scores:
               the spec fleet's stops
               and tokens equal the one-token fleet's, with the default
               draft cache and with one primed by the one-token tokens
               (drafts accepted, several tokens per step, its first 16
               K4 calls held against the plain version)
20b. serve-tree, trace-tree, tree-stops-f32 -- the serve fleet with
               ``--spec-tree 3.3`` at 8 of its 32 layers: K4 once an
               engine step and K3 8 times (once a layer), its first 16 K4
               calls held against the
               plain version, node and path stats, draft-cache hits, its
               requests beside the one-token fleet's; a 4-step profiled
               window; then the serve fleet in f32 at 4 of its 32 layers
               (``TREE_F32_LAYERS``),
               paged and chunked (4 requests, 64-token chunks) at a
               lambda* between the free fleet's scores: the
               3.3 fleet with a primed draft cache stops and emits every
               token as the one-token fleet does, with accepted paths
               longer than the root, every K3 call and its first 16 K4
               calls held against the plain versions; 1.3 equals
               ``--spec-tokens 4`` step for step
20c. preempt-roundtrip, serve-preempt, preempt-stops-f32 -- spill to host
               RAM and restore.  Engine level on serve's weights, probe and
               lambda* (4 slots; paged bf16, paged int8, dense bf16): a
               RUNNING slot and a mid-prefill one (160 tokens in 64-token
               chunks, 128 in) spilled and restored into the same slot on
               other pages, or the same lane: the round trip bitwise
               (pages with scales, lane, probe row, token, pos), the next
               9 steps bitwise against an undisturbed engine (K2 and K3
               through the rewritten rows, K1 on the restored probe rows,
               K6 on the dense lane), a restore into slot 3 with the same
               tokens and stops, every launch counted; spill and restore
               ms and bytes.  serve-preempt: serve's weights (their first
               8 of 32 layers, ``CUT_LAYERS``, through ``f32_cut`` with
               their own dtype), probe and lambda*, paged, 160-token
               prompts in 64-token chunks, ``policy="priority"``, a pool of 1 + 3 requests' pages: 4
               batch requests, then 4 interactive ones in a burst while a
               batch request is mid-prefill; RUNNING and mid-prefill
               victims, restores equal to spills, the pool drained, K1,
               K2, K3 and K7 counted exactly.  preempt-stops-f32: the
               serve weights in f32 at 4 layers, the same traffic
               abundant, preempted, and preempted under ``--spec-tree
               3.3`` with a primed draft cache: stops and tokens equal
20d. serve-group, group-stops-f32 -- self-consistency groups and the
               consensus stop.  serve-group: the driver with
               ``--group-size 4 --requests 2`` (serve's fleet otherwise at
               8 of its 32 layers through ``CutDepth``, its own harvest,
               fit and consensus calibration g*): every
               group decides, every sample its own stop did not stop is
               cancelled at the group's consensus step, the pages freed at
               cancel, 6 prefill skips (siblings share the first sample's
               prompt pages), the pool drained; K1 once a step, K2 32
               times, K7 once a layer for the harvest and each group's
               first sample only.  group-stops-f32: serve's weights in f32
               at 8 of 32 layers with serve's probe, serve-dense-f32's 8
               distinct prompts as 2 groups of 4, per-sample stops off: a
               consensus threshold far from every agreement of the
               ungrouped fleet's offline vote; served grouped through the
               kernels and through the plain attention, each group decides
               where ``consensus_stop_times`` says, both runs cancel alike
20e. serve-fleet, fleet-stops-f32 -- the fleet (FleetRouter) of simulated
               hosts, each stepping in its own thread on its own CUDA
               stream.  serve-fleet: the driver with ``--hosts 2
               --placement pressure`` (serve's traffic, 4 slots a host,
               the model at 8 of its 32 layers through ``CutDepth``):
               every request ends, both hosts serve, each host's pool
               checks and drains, the ``[serve] fleet:`` and ``[serve]
               routing:`` lines printed, K1 once a host step and K2 once a
               layer a host step, K6 and K7 counted exactly; then the same
               prompts through ``api.fleet`` stepping serially (tokens and
               stops equal the driver's parallel run, bf16): both runs'
               fleet step wall p50/p99, the serial run's peak memory above
               its start (``tools/fleet_overlap.py`` measures one host,
               the busy share and the other peaks).
               fleet-stops-f32: its weights in f32 at 2 layers on
               f32 pages, 8 distinct prompts at a lambda* between their
               scores through one scheduler and fleets of 2 (pressure,
               parallel), 2 (roundrobin, serial) and 3 (pressure,
               parallel) hosts: stops and tokens equal; 4 requests of one
               prompt land on one host under pressure (3 affine
               placements, 3 prefill skips, K7 for 1 cold prefill) and on
               two under roundrobin (2 skips, K7 for 2); a group of 4
               lands on one host, a group of 5 is refused
21. offline  -- the paper's procedure on the synthetic corpus at d_phi 960
               (``corpus_splits(500, 170, 170)``): ``orca.fit`` of the TTT
               probe (no-QK, QK d_h 128; 6 epochs, ``OFFLINE_EPOCHS``,
               of the benchmark's 35) and the static probe, then
               ``orca.evaluate`` at every delta; K5 launches in fit and in
               evaluate, and its plain version's scores give the same
               lambda*, savings and error
22. serve-static -- the driver with ``--static-baseline`` on 4 requests
               at 8 of 32 layers:
               the static-batch engine's stops equal the fleet's (its
               prefill runs K7, its dense decode K6); then the static probe
               (``api.fit(method="static")``) served through
               ``api.engine``: K1 runs and leaves every W at W0 (eta = 0)
23. k8       -- the RWKV6 WKV scan against its plain version, H 32, d 64:
               (B, T) (4, 1) served decode, (1, 16) admission, (24, 16)
               and (24, 1) the harvest's prefill and decode, (1, 100),
               (1, 512), (1, 2048), T 31, 32 and 33 around the staged
               chunk; bf16 r, k and v at (4, 1) and (1, 16); s0 zero and
               random; w near 0, mid and near 1; relative f32 error under
               1e-5 of max |plain|; T 100 in two calls carrying the state,
               in place at 4 column blocks, one call in place at 2; d 32
               refused; timed at (4, 1), (1, 16), (24, 16), (1, 512) and
               (1, 2048), and in bf16, with its bound; each row names its
               column split, staged chunk, registers and shared memory
24. model-rwkv -- full-width rwkv6-1.6b (bf16, then the same weights in
               f32): prefill 16 tokens, 32 teacher-forced decode steps
               through K8, every K8 call held against the plain version;
               each step's logits against one prefill over the whole
               sequence (f32: every argmax equal; bf16: gap and argmax
               agreement held to the same run through the plain scan)
25. serve-rwkv -- ``launch.serve --arch rwkv6-1.6b``, the serve fleet on
               the recurrent state at 8 of its 24 layers (``CutDepth``): K8
               launches 8 x (1 harvest prefill + 96 harvest steps + 8
               admissions + the engine steps); K1 and K5 run; K2, K3, K4,
               K6 and K7 never
26. trace-rwkv, harvest-rwkv -- a 4-step profiled window of the RWKV
               fleet; its harvest (48 steps) timed through K8 and through
               the plain scan in turns (K8 once a layer a prefill or
               decode step)
27. serve-rwkv-f32 -- rwkv6-1.6b's full-depth draw in f32 at its first 4
               of 24 layers (``RWKV_F32_LAYERS``) through ``OrcaScheduler``
               at a lambda* between its scores, through K8 and through the
               plain scan: stops and tokens equal
27b. model-hymba, serve-hymba, trace-hymba, serve-hymba-f32 -- hymba-1.5b
               at full width and depth (32 layers, d 1600, 25 heads on 5 KV
               heads of 64, a window of 1,024, 128 meta tokens, Mamba
               heads of state 16).  model-hymba: 2 prompts of 1,000 tokens
               (1,128 positions) and 4 teacher-forced decode steps through
               K7 (causal, windowed) and K6 (the ring, wrapped), every
               call checked, against the plain path; the bf16 floor (the
               plain path in bf16 against f32) bounds the logits and the
               state (ring, conv, SSM); the first 4 layers in f32 through
               the kernels, the plain and the reversed plain versions;
               the share of one admission in the plain Mamba loop.
               serve-hymba: the driver (4 requests of 1,000 tokens on 4
               slots, 48 new tokens, a harvest of 8) on the dense state
               at 8 of the 32 layers: K7 8 x 5, K6 8 x (48 + engine
               steps), K1 once a step, K5 once, K2, K3, K4 and K8 never;
               step ms, TTFT, peak memory.  trace-hymba: a 4-step window.
               serve-hymba-f32: the first 4 layers of a full-depth draw
               in f32, kernels against plain: stops and tokens equal
27c. model-whisper, serve-whisper, trace-whisper, serve-whisper-f32 --
               whisper-tiny at full width and depth (4 encoder and 4
               decoder layers, d 384, 6 heads of 64, 1,500 stub frames).
               model-whisper: 4 requests, 16 decode steps from position 0
               through K7 (non-causal, the encoder) and K6 (the self cache
               and the 1,500 frames' cross K/V), as model-hymba, its f32
               evaluation at full depth.  serve-whisper: the driver (8
               requests on 4 slots, 96 new tokens, a harvest of 24): K7 4 x
               9, K6 8 x (96 + engine steps), K1 once a step, K5 once.
               trace-whisper: a 4-step window.  serve-whisper-f32: the
               fleet in f32 at its first 2 encoder and 2 decoder layers
               (``WHISPER_F32_LAYERS``), kernels against plain: stops and
               tokens equal
27d. train, train-check -- training (``repro_torch.launch.train``), the
               path no kernel is on: launch counts zeroed before each and
               read after, every count 0 (the kernels refuse inputs that
               require grad).  train: the CLI at smollm-360m's full width
               and depth, batch 8 x seq 128, 30 steps (warmup 5) from
               float32 masters into a temporary checkpoint directory, the
               loss falling (the CLI's exit 0); s/step (median past the
               first), tokens/s, peak memory, model FLOP/s
               (``roofline.analytic``) against 989 TFLOP/s; the checkpoint
               restored bitwise, then the CLI resumed from it for 4
               steps.  train-check: smollm-360m, rwkv6-1.6b,
               granite-moe-1b-a400m, hymba-1.5b and whisper-tiny at full
               width in f32 at 2 layers (whisper 2 + 2), one step's loss
               and every gradient leaf on the card against the port on
               the CPU (the MoE routing teacher-forced) within the
               family's bound, beside the card's own rounding spread and
               a TF32 control; then 3 bf16 steps each at 4 layers
               (whisper whole): finite losses, s/step, peak memory
27e. dist-decode, dist-moe, dist-train, dist-serve, dist-nccl -- the
               multi-device port (``parallel``, ``launch.shardings``):
               one spawn of 4 ranks sharing cuda:0 over gloo (a
               FileStore, mesh (2, 2) data x model; one H100, and NCCL
               refuses two ranks on one device), every one-process
               reference computed once in this process.  dist-decode:
               K6 on each rank's half of a bf16 cache (B 4, S 4,096) at
               (64, 3) and (64, 2), merged over model, against one-process
               K6 and its plain version, rows empty on one rank and on
               both.  dist-moe: granite-moe-1b's MoE block at full width
               in f32 (32 experts, 16 a rank, top-8) through ``moe_ep``:
               at capacity 8.0 against ``moe_dense``, at 1.25 (drops)
               against the same ranks on CPU tensors.  dist-train: two
               f32 steps (TF32 off) of smollm-360m at full width and
               depth (batch 8 x 1,024, dp_tp rules) and granite at 4
               layers (FSDP over data, EP, blockwise with remat), every
               gradient on each rank's shards against the one-process
               card step within train-check's bound.  dist-serve:
               smollm-360m at full width and depth, 4 slots, 48 steps
               after a sharded prefill (tensor-parallel weights, the
               cache sequence-sharded): K7, K6 and K1 launch on every
               rank; the f32 tokens and stops equal the one-process
               step's; the bf16 run's K6 calls each within phase k6's
               bounds of the plain version.  Each phase's seconds, the
               collectives a step by axis (calls, bytes, host seconds:
               gloo stages CUDA tensors through host memory, not a
               multi-card figure) and each rank's peak memory.
               dist-nccl: one rank on NCCL, mesh (1, 1), a train step and
               a serve step of smollm-360m at 4 layers against the same
               rank without a context
28. model-llama, model-qwen -- llama3.2-3b (28 layers) and qwen1.5-32b
               (64 layers, int8 KV pages) at full width and depth, random
               bf16 weights drawn on the card: prefill 16 tokens, 8
               teacher-forced paged decode steps through K2 within phase
               model's measured floor, every K2 call checked; the dense
               path through K7 and K6 (qwen's int8 cache dequantised to
               bf16), every call checked; peak memory
29. serve-llama, trace-llama -- ``launch.serve --arch llama3.2-3b
               --paged``: 4 requests on 4 slots, 48 new tokens, 8
               harvested trajectories; K1 at f 3072, K2, K6 (harvest, G 3)
               and K7 counted exactly; a 4-step profiled window;
               serve-llama-tree: ``--spec-tree 2.3`` on its weights and
               probe (no second harvest), K4 once a step and K3 at d 128,
               G 3 once a layer a step
30. serve-llama-f32 -- the llama fleet in f32 at 4 of its 28 layers,
               through the kernels and through the plain attention: stops
               and tokens equal
30b. model-stablelm, serve-stablelm, trace-stablelm, serve-stablelm-f32
               -- stablelm-3b (32 layers, 32 heads of 80 on 32 KV heads,
               LayerNorm, QKV bias, a quarter of each head rotary) at full
               width and depth as model-llama; ``launch.serve --arch
               stablelm-3b --paged --chunk-tokens 64 --prompt-len 160``:
               K2 and K3 at (80, 1) on bf16 pages, the harvest through K7
               and K6 at d 80, K1 and K5 at f 2560, every K1, K2, K3, K6
               and K7 launch counted exactly, a packed chunk; a 16-step
               profiled window; in f32 at 4 of its 32 layers on f32 pages
               in 64-token chunks, through the kernels and through the
               plain attention: stops and tokens equal
30c. model-granite, serve-granite, trace-granite, serve-granite-f32 --
               granite-moe-1b-a400m (24 layers, 16 heads of 64 on 8 KV
               heads, 32 experts of d_ff 512, top-8, tied embeddings) at
               full width and depth as model-llama, then its first 4
               layers in f32 with teacher-forced routing
               (``f32_evaluation``): K2 against the plain paged attention
               within 2^-10 of the largest logit, the dense path's argmax
               equal, and the bf16 floor measured against f32;
               ``launch.serve --arch
               granite-moe-1b-a400m --paged --chunk-tokens 64
               --prompt-len 160``: K2 and K3 at (64, 2) on bf16 pages, the
               harvest through K7 and K6, K1 and K5 at f 1024, every K1,
               K2, K3, K6 and K7 launch counted exactly, a packed chunk;
               a 4-step profiled window of decode steps (16-token
               prompts); in f32 at 4 of its 24 layers on
               f32 pages in 64-token chunks, through the kernels and
               through the plain attention: stops and tokens equal, with
               the smallest top-k router margin of each run
30d. model-phi, serve-phi, trace-phi, serve-phi-f32 -- phi3.5-moe-42b
               (32 heads of 128 on 8 KV heads, 16 experts of d_ff 6400,
               top-2, LayerNorm) at full width, cut to 24 of its 32 layers
               (``PHI_LAYERS``: 58.6 GiB of bf16 weights; the whole
               model's 78.0 GiB leaves no room for a cache), as
               serve-granite: K2 and K3 at (128, 4); peak memory; an
               4-step profiled window of decode steps; in f32 at 4 layers
               (weights drawn anew on the card once the bf16 fleet is
               gone) as serve-granite-f32; model-phi's f32 evaluation
               keeps a copy of the first 4 bf16 layers and frees the rest
               first, so that their f32 copy fits
30e. model-llava, serve-llava, trace-llava, serve-llava-f32 -- the VLM,
               llava-next-34b (60 layers, d_model 7168, 56 heads of 128 on
               8 KV heads: G 7, d_ff 20480, a two-layer gelu projector
               over 2,880 patch embeddings of width 1024; 34.39 B
               parameters, 64.05 GiB in bf16) at full width and depth,
               patches drawn N(0, 1) from the seed (the driver's zero
               patches project to exact zeros).  model-llava: one image
               request (2,880 patches and 16 tokens) prefilled through K7
               and 4 teacher-forced paged decode steps through K2 as
               model-llama, every K7 call of the dense path held to
               float64; then its first 4 layers in f32 (``f32_evaluation``).
               serve-llava, at 16 of the 60 layers (trace-llava on its
               fleet): a harvest of 8 image trajectories in batches
               of 4 (K7 over 2,896 rows, K6 at (128, 7)), ``orca.fit``
               (K5 at f 7168), then through ``api.engine`` 2 image
               requests admitted in one shot beside 2 text requests of
               160 tokens in 64-token chunks (K3-B4 at (128, 7)), 48 new
               tokens each, K2 at (128, 7) and K1 at f 7168; every K1, K2,
               K3, K6 and K7 launch counted exactly, each request's stop
               and tokens, TTFT by class, peak memory.  trace-llava: an
               4-step profiled window of 2 image and 2 text requests.
               serve-llava-f32: serve-llava's traffic in f32 at 4 of 60
               layers on f32 pages with its probe, through K2, K3 and K7
               and through the plain attention: stops and tokens equal
31. serve-qwen, trace-qwen -- ``launch.serve --arch qwen1.5-32b --paged
               --chunk-tokens 64 --prompt-len 160`` at 16 of its 64 layers
               (``QWEN_LAYERS``): int8 pages through K2 and K3 (G 1), the
               harvest through K7 and K6 (G 1), K1 and K5 at f 5120; a
               16-step profiled window; peak memory
32. serve-qwen-f32 -- qwen1.5-32b in f32 at 4 of its 64 layers (full
               width, weights drawn on the card), int8 KV pages, 160-token
               prompts in 64-token chunks, served with serve-qwen's probe
               through the kernels (K2 and K3 at G 1 on int8 pages) and
               through the plain attention: stops and tokens equal
33. kernels  -- one entry per kernel: launches on its path (phase 12 for
               K1, K2 and K7, 10 for K3-B3, 17 for K3-B4, 19 for K4, 21
               for K5, 15 for K6, 25 for K8), error against its plain
               version, kernel / plain / library / bound ms; then one entry
               per d-128 instance on the new fleets' paths (K2, K6 and K7
               at G 3 from serve-llama, at G 1 from serve-qwen, K3 at G 1
               int8 from serve-qwen) and K1 at f 3072, and one per d-80
               instance on serve-stablelm's (K2, K3-B4, K6, K7), and one
               per (64, 2) and (128, 4) instance on serve-granite's and
               serve-phi's (K2, K3-B4, K6, K7) and K1 and K5 at f 1024 and
               4096 (launches from serve-granite and serve-phi), and one
               per (128, 7) instance on serve-llava's (K2, K3-B4, K6, K7
               timed at an image admission's 2,896 rows) and K1 and K5 at
               f 7168 (launches from serve-llava's harvest, fit and
               fleet), and one per (64, 5) and (64, 1) instance of K6 and
               K7 windowed at G 5 and non-causal at G 1 (serve-hymba's and
               serve-whisper's) and K1 and K5 at f 1600 and 384; the tree
               path's
               K3 (d 64 from serve-tree, d 128 G 3 from serve-llama-tree,
               timed at phase k3's tree cases) and K4 (serve-tree); K3's
               and K7's bound_ms is their rows' bound_tc_ms, the products
               priced at the tensor cores' bf16 rate; then K6, K7 and K1
               inside the ranks (dist-serve's launches summed over the
               four, timed at their served rows)

The line before the last is ``nvidia-smi``'s card name and power limit;
the last line is ``{"ok": true, "device": {...}}``.  Exits non-zero with no
result when there is no CUDA device or the package is missing.
"""
from __future__ import annotations

import bisect
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the
# float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# dense bf16 on the tensor cores (the same data sheet)
TC_FLOPS_PER_S = 989e12
SEED = 0
# the card; a CPU rehearsal of the phases at a reduced size may set "cpu"
DEV = "cuda"


def sync(torch) -> None:
    if DEV == "cuda":
        torch.cuda.synchronize()


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries t_s, the seconds since the
    script started."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - T0)
    print(json.dumps(obj), flush=True)


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_tc_ms(n_bytes: float, tc_flops: float, f32_flops: float):
    """The bound with the products on the tensor cores: the products'
    operations at the bf16 rate, the rest at the f32 rate, against the
    same bytes."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (tc_flops / TC_FLOPS_PER_S + f32_flops / F32_FLOPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


class Timer:
    """Per-call CUDA-event timing of the device work, after a few warm-up
    calls.  Before every call a 1 GiB buffer is zeroed: that flushes the
    50 MB L2 (a served layer finds its pages cold) and keeps the card busy
    for about 0.3 ms while the host enqueues the call, so the events time
    the kernels and not the host's Python in front of them."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(2 ** 30, dtype=torch.uint8, device=DEV)

    def __call__(self, fn, reps: int = 30, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(reps):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        sync(torch)
        return sum(a.elapsed_time(b) for a, b in pairs) / reps


# ---------------------------------------------------------------------------
# phase k1

def probe_state(torch, gen, B, f, win):
    """Slots spread over scores far from lambda* = 0.6: a few climb past it
    after the burn-in (a stop inside the run), the others stay below."""
    dev = DEV
    W = (torch.randn(B, f, generator=gen) / f ** 0.5).to(dev)
    b = torch.linspace(-3.0, 4.0, B).to(dev)
    ring = torch.zeros(B, win, device=dev)
    n = torch.zeros(B, dtype=torch.int32, device=dev)
    stopped = torch.zeros(B, dtype=torch.bool, device=dev)
    stopped[1] = True                      # a slot parked from the start
    stop_step = torch.full((B,), -1, dtype=torch.int32, device=dev)
    return [W, b, ring, n, stopped, stop_step]


def k1_chain(torch, K1, gen, B, f, win, steps, eta, lam, burn_in,
             same=False):
    """K1 and its plain version over ``steps`` chained steps from the same
    state, with mixed boundaries and a stop inside the run; ``same``: zk
    is zq, one tensor (the served no-QK view).  Returns the largest
    differences of s, W, b and smoothed, the smallest distance of a
    smoothed score from lambda*, and the stop steps."""
    zs = [(torch.randn(B, f, generator=gen) / f ** 0.5).to(DEV)
          for _ in range(2 * steps)]
    bnd = (torch.rand(steps, B, generator=gen) < 0.7).to(DEV)
    bnd[:, 0] = True
    kern = probe_state(torch, gen, B, f, win)
    plain = [t.clone() for t in kern]
    err = {"s": 0.0, "W": 0.0, "b": 0.0, "smoothed": 0.0}
    margin = float("inf")
    for t in range(steps):
        zq, zk = zs[2 * t], zs[2 * t + (0 if same else 1)]
        ko = K1.serving_probe_step(zq, zk, bnd[t], *kern, eta, lam,
                                   burn_in=burn_in)
        po = K1.serving_probe_step_plain(zq, zk, bnd[t], *plain, eta, lam,
                                         burn_in=burn_in)
        sync(torch)
        for name in ("n_scores", "stopped", "stop_step"):
            a, b_ = getattr(ko, name), getattr(po, name)
            if not torch.equal(a, b_):
                raise AssertionError(f"K1 B={B} f={f} step {t}: {name} "
                                     f"differs: {a.tolist()} vs "
                                     f"{b_.tolist()}")
        for name in err:
            err[name] = max(err[name], float(
                (getattr(ko, name) - getattr(po, name)).abs().max()))
        scored = po.n_scores > 0
        if scored.any():
            margin = min(margin, float((po.smoothed[scored] - lam).abs()
                                       .min()))
    if margin < 1e-3:
        raise AssertionError(f"K1 B={B} f={f}: inputs came within {margin} "
                             "of lambda*")
    if int(kern[5].max()) < 0:
        raise AssertionError(f"K1 B={B} f={f}: no slot stopped")
    tol = 1e-5      # f32, another reduction order than the plain version
    if max(err.values()) > tol:
        raise AssertionError(f"K1 B={B} f={f} off its plain version: {err}")
    return err, margin, kern[5].tolist()


# K1's outputs and state
PROBE_FIELDS = ("s", "W", "b", "ring", "n_scores", "smoothed", "stopped",
                "stop_step")


def k1_shared_bitwise(torch, K1, gen, B, f, win, eta, lam, burn_in):
    """K1(zq, zq) -- one tensor, one row read -- against K1(zq, zq.clone())
    -- two rows -- from copies of one state, every slot at a boundary:
    every output and every state tensor equal bit for bit."""
    zq = (torch.randn(B, f, generator=gen) / f ** 0.5).to(DEV)
    bnd = torch.ones(B, dtype=torch.bool, device=DEV)
    st = probe_state(torch, gen, B, f, win)
    one, two = [t.clone() for t in st], [t.clone() for t in st]
    a = K1.serving_probe_step(zq, zq, bnd, *one, eta, lam, burn_in=burn_in)
    b = K1.serving_probe_step(zq, zq.clone(), bnd, *two, eta, lam,
                              burn_in=burn_in)
    sync(torch)
    for name in PROBE_FIELDS:
        if not torch.equal(getattr(a, name), getattr(b, name)):
            raise AssertionError(f"K1 f={f}: zk is zq and zk a clone of zq "
                                 f"differ in {name}")
    return True


def floor_ms(torch, timer) -> float:
    """The Timer around one launch of the smallest kernel: what a call
    that does nothing costs in the Timer's window."""
    return timer(lambda: torch.empty(1, device=DEV).zero_(), reps=200)


def chain_config(K1, f, same, win):
    """The K1/K4 instance of width f, view and window, with its registers
    (on the card; figures only on the CPU)."""
    if DEV != "cuda":
        fig = K1.instance(f, same, win)
        return dict(threads=fig[0], features_per_thread=fig[1], same=fig[2],
                    smem_window=fig[3])
    return K1.kernel_config(f, same, win)


def k1_timed(torch, timer, K1, gen, Bs, f, win, eta, burn_in, same=False):
    """K1 and its plain version timed at (Bs, f), every slot at a
    boundary; ``same``: zk is zq.  lambda* above 1 is out of reach of any
    smoothed score, so no slot stops and every timed call updates every
    slot's W, b and ring (a stopped slot would skip them) -- the work the
    bound counts."""
    lam_t = 1.5
    zq = (torch.randn(Bs, f, generator=gen) / f ** 0.5).to(DEV)
    zk = zq if same else (torch.randn(Bs, f, generator=gen)
                          / f ** 0.5).to(DEV)
    bnd_all = torch.ones(Bs, dtype=torch.bool, device=DEV)
    st = probe_state(torch, gen, Bs, f, win)
    st[4].zero_()
    ms = timer(lambda: K1.serving_probe_step(zq, zk, bnd_all, *st, eta,
                                             lam_t, burn_in=burn_in),
               reps=200)
    plain_ms = timer(lambda: K1.serving_probe_step_plain(
        zq, zk, bnd_all, *st, eta, lam_t, burn_in=burn_in), reps=200)
    if bool(st[4].any()):
        raise AssertionError("K1 timing: a slot stopped")
    # read zq (and zk), boundary and the whole state once; write W, b,
    # ring, n_scores and stopped (stop_step is untouched without a stop)
    # and the two outputs (s, smoothed); ~7 f32 operations per feature
    # (two dots, the update; 5 where zk is zq)
    W, b, ring, n, stopped, stop_step = st
    rows = (zq,) if same else (zq, zk)
    moved = (nbytes(*rows, bnd_all, *st) + nbytes(W, b, ring, n, stopped)
             + 2 * 4 * Bs)
    bms, by = bound_ms(moved, (5 if same else 7) * Bs * f)
    return dict(timed_shape=dict(B=Bs, f=f, window=win, lam=lam_t,
                                 view="same" if same else "distinct"),
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                bytes=moved, **chain_config(K1, f, same, win))


# a smoothing window wider than the kernel's registers hold (its window
# then lies in shared memory), and the K1 chain's length that makes
# scores leave it
WIDE_WINDOW, WIDE_STEPS = 17, 30

# the widths of the view cases: QK d_h 128, a width that is no multiple of
# 4, smollm-360m's 960, rwkv6-1.6b's 2048, qwen1.5-32b's 5120
VIEW_WIDTHS = (128, 130, 960, 2048, 5120)


def phase_k1(torch, timer):
    from repro_torch.kernels import probe_step as K1
    gen = torch.Generator().manual_seed(SEED)
    f, win, steps = 960, 4, 12
    eta, lam, burn_in = 0.05, 0.6, 2
    floor = floor_ms(torch, timer)
    # the 12-step chain at B = 8 and at the serving shape, B = 4 slots
    chains = {}
    for B in (8, 4):
        err, margin, stops = k1_chain(torch, K1, gen, B, f, win, steps, eta,
                                      lam, burn_in)
        chains[B] = dict(max_abs_err=err, lambda_margin=margin,
                         stopped_at=stops)
    # zk the same tensor as zq and a different one, at every view width
    views = []
    for fv in VIEW_WIDTHS:
        for same in (True, False):
            err_v, margin_v, stops_v = k1_chain(
                torch, K1, gen, 4, fv, win, steps, eta, lam, burn_in,
                same=same)
            views.append(dict(f=fv, view="same" if same else "distinct",
                              max_abs_err=err_v, lambda_margin=margin_v,
                              stopped_at=stops_v))
        k1_shared_bitwise(torch, K1, gen, 4, fv, win, eta, lam, burn_in)
    timed = k1_timed(torch, timer, K1, gen, 4, f, win, eta, burn_in)
    served = k1_timed(torch, timer, K1, gen, 4, f, win, eta, burn_in,
                      same=True)
    f_rwkv = RWKV_PROBE_F
    err_r, margin_r, stops_r = k1_chain(torch, K1, gen, 4, f_rwkv, win,
                                        steps, eta, lam, burn_in)
    rwkv = dict(f=f_rwkv, B=4, max_abs_err=err_r, lambda_margin=margin_r,
                stopped_at=stops_r,
                **k1_timed(torch, timer, K1, gen, 4, f_rwkv, win, eta,
                           burn_in))
    rwkv_served = k1_timed(torch, timer, K1, gen, 4, f_rwkv, win, eta,
                           burn_in, same=True)
    def served_width(fw):
        """A fleet's probe width (its d_model), both views, chained and
        timed at 4 slots."""
        rows = []
        for same in (True, False):
            err_w, margin_w, stops_w = k1_chain(
                torch, K1, gen, 4, fw, win, steps, eta, lam, burn_in,
                same=same)
            rows.append(dict(f=fw, B=4, view="same" if same else "distinct",
                             max_abs_err=err_w, lambda_margin=margin_w,
                             stopped_at=stops_w,
                             **k1_timed(torch, timer, K1, gen, 4, fw, win,
                                        eta, burn_in, same=same)))
        return rows

    # serve-llama's probe width, d_model 3072 (serve-qwen's 5120 is among
    # the views above)
    llama = served_width(LLAMA_PROBE_F)
    wide = []
    for same in (True, False):
        err_w, margin_w, stops_w = k1_chain(
            torch, K1, gen, 4, f, WIDE_WINDOW, WIDE_STEPS, eta, lam,
            burn_in, same=same)
        wide.append(dict(window=WIDE_WINDOW, steps=WIDE_STEPS,
                         view="same" if same else "distinct",
                         max_abs_err=err_w, lambda_margin=margin_w,
                         stopped_at=stops_w))
    # serve-stablelm's probe width, d_model 2560, then serve-granite's and
    # serve-phi's, 1024 and 4096, each the top of its band (after the cases
    # above, whose draws stay as they were)
    stablelm = served_width(STABLELM_PROBE_F)
    granite = served_width(GRANITE_PROBE_F)
    phi = served_width(PHI_PROBE_F)
    # serve-llava's, d_model 7168: the top of the widest band
    llava = served_width(LLAVA_PROBE_F)
    # serve-hymba's and serve-whisper's, d_model 1600 and 384
    hymba = served_width(HYMBA_PROBE_F)
    whisper = served_width(WHISPER_PROBE_F)
    err = {k: max([c["max_abs_err"][k] for c in chains.values()]
                  + [v["max_abs_err"][k] for v in views + wide + llama
                     + stablelm + granite + phi + llava + hymba + whisper]
                  + [err_r[k]])
           for k in chains[8]["max_abs_err"]}
    # the kernels line's K1 time: two rows (zk another tensor) at 4 slots,
    # as every slice has reported it; the served view (zk is zq) beside it
    res = dict(phase="k1", steps=steps, f=f, window=win, floor_ms=floor,
               chains={str(B): c for B, c in chains.items()},
               views=views, shared_bitwise=len(VIEW_WIDTHS),
               wide_window=wide, max_abs_err=err, ms=timed["ms"],
               plain_ms=timed["plain_ms"], bound_ms=timed["bound_ms"],
               bound_by=timed["bound_by"], library_ms=None,
               served_ms=served["ms"], served_plain_ms=served["plain_ms"],
               served_bound_ms=served["bound_ms"], served=served,
               distinct=timed, rwkv_width=rwkv, rwkv_served=rwkv_served,
               llama_width=llama, stablelm_width=stablelm,
               granite_width=granite, phi_width=phi, llava_width=llava,
               hymba_width=hymba, whisper_width=whisper)
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phase k2

def paged_case(torch, gen, B, nb, dtype, H=15, KV=5, d=64, bs=16):
    """A pool of B*nb+1 pages (page 0 NULL), shuffled tables, partly valid
    rows (ragged tails; one row behind a NULL entry)."""
    P = B * nb + 1
    q = torch.randn(B, H, d, generator=gen).to(DEV)
    if dtype == "int8":
        k = torch.randint(-127, 128, (P, KV, bs, d), generator=gen,
                          dtype=torch.int8).to(DEV)
        v = torch.randint(-127, 128, (P, KV, bs, d), generator=gen,
                          dtype=torch.int8).to(DEV)
        ks = (torch.rand(P, KV, bs, 1, generator=gen) * 0.02 + 1e-3).to(DEV)
        vs = (torch.rand(P, KV, bs, 1, generator=gen) * 0.02 + 1e-3).to(DEV)
    else:
        dt = torch.bfloat16 if dtype == "bf16" else torch.float32
        k = torch.randn(P, KV, bs, d, generator=gen).to(dt).to(DEV)
        v = torch.randn(P, KV, bs, d, generator=gen).to(dt).to(DEV)
        ks = vs = None
    tables = (1 + torch.randperm(B * nb, generator=gen)).reshape(B, nb)
    lens = torch.randint(1, nb * bs + 1, (B,), generator=gen)
    lens[0] = nb * bs
    valid = torch.arange(nb * bs)[None, :] < lens[:, None]
    if B > 2 and nb > 1:
        tables[2, 0] = 0                    # NULL entry, masked off
        valid[2, :bs] = False
    return (q, k, v, tables.to(torch.int32).to(DEV), valid.to(DEV), ks, vs)


# bf16 / int8 inputs upcast exactly; f32 accumulation in another order
# (per-warp online softmax, then a cross-warp merge) than the plain one-shot
# softmax: m to 1e-4, normalised output to 2e-3
K2_M_TOL, K2_OUT_TOL = 1e-4, 2e-3


def partial_errors(kern, plain, valid, m_relative=False):
    """Largest m and normalised-output differences between two (o, l, m)
    partials, over the rows with a valid position.  ``m_relative`` divides
    each m difference by max(1, |m|): f32 rounding of a score grows with
    the score, and a random-weight model's scores reach tens.  With no
    live row both are 0."""
    (o, l, m), (po, pl_, pm) = kern, plain
    live = valid.any(1)
    if not bool(live.any()):
        # no valid position in any row (whisper's first decode step, its
        # self cache still empty): nothing to compare
        return 0.0, 0.0
    dm = (m - pm)[live].abs()
    if m_relative:
        dm = dm / pm[live].abs().clamp_min(1.0)
    out = (o / l.clamp_min(1e-30)[..., None])[live]
    pout = (po / pl_.clamp_min(1e-30)[..., None])[live]
    return float(dm.max()), float((out - pout).abs().max())


def k2_shape_rows(torch, gen, valid, case):
    """Phase k2's untimed split cases, on a (B >= 8, nb 256) validity row
    set.  "holes": every row keeps about 30% of its valid positions (its
    first and last kept), so each split's share has holes.  "one split":
    row 5 keeps one valid position, which lands in one split of 8 (the
    others empty), row 6 only its first 8 and last 8 positions (the middle
    splits empty), row 7 none (the empty-row contract after the merge)."""
    n_pos = valid.shape[1]
    if case == "holes":
        keep = (torch.rand(valid.shape, generator=gen) < 0.3).to(DEV)
        ends = torch.zeros_like(valid)
        for b in range(valid.shape[0]):
            idx = torch.nonzero(valid[b]).flatten()
            if idx.numel():
                ends[b, idx[0]] = ends[b, idx[-1]] = True
        return valid & (keep | ends)
    valid = valid.clone()
    valid[5] = False
    valid[5, 2345] = True
    valid[6] = False
    valid[6, :8] = True
    valid[6, n_pos - 8:] = True
    valid[7] = False
    return valid


def empty_rows_hold(o, l, m, valid) -> bool:
    """Rows with no valid position return exactly o = 0, l = 0 and
    m = -1e30."""
    empty = ~valid.any(1)
    return not empty.any() or (float(o[empty].abs().max()) == 0.0
                                and float(l[empty].abs().max()) == 0.0
                                and bool((m[empty] == -1e30).all()))


SPLIT_SWEEP = (4, 8, 12, 16)


def split_sweep(torch, timer, name, launch, outs, n_pos):
    """Time one K2 or K6 call through its launcher at each split count of
    SPLIT_SWEEP (the wrapper takes split.split_count): what the cap of
    split.DECODE_MAX_SPLITS rests on.  ``launch(n_split, parts)`` runs
    the launcher with the scratch ``parts``; no launch count moves."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import split as SP

    def call(n_split):
        parts = SP.split_scratch(n_split, *outs)
        err = launch(n_split, [_build.opt_ptr(t) for t in parts])
        _build.check(err, f"{name} split sweep")
    ms = {str(n): timer(lambda: call(n)) for n in SPLIT_SWEEP}
    emit(dict(phase=f"{name}-splits", positions=n_pos, ms_by_splits=ms,
              chosen=SP.split_count(n_pos, SP.DECODE_MAX_SPLITS)))


# (heads, KV heads, d_head, layers) of the served configs
SMOLLM = (15, 5, 64, 32)
LLAMA = (24, 8, 128, 28)
QWEN = (40, 40, 128, 64)
STABLELM = (32, 32, 80, 32)
# the MoE fleets' attention: granite-moe-1b's d 64 on 16 heads over 8 (G 2)
# at its 24 layers, phi3.5-moe's d 128 on 32 over 8 (G 4) at the 24 of its
# 32 layers served
GRANITE = (16, 8, 64, 24)
PHI = (32, 8, 128, 24)
# the VLM's: llava-next-34b's d 128 on 56 heads over 8 (G 7, the first odd
# group above 3) at its 60 layers.  An image request's cache holds the
# 2,880 patch positions, 16 of text and 48 decoded: 2,944 positions, 184
# pages of 16, the table width of serve-llava's pool
LLAVA = (56, 8, 128, 60)
LLAVA_PAGES = 184
# hymba-1.5b's attention: d 64 on 25 heads over 5 (G 5) at its 32 layers,
# a window of 1,024 (its decode ring); whisper-tiny's: d 64 on 6 heads over
# 6 (G 1), its 4 decoder layers (self and cross: 2 K6 launches a layer a
# step) and 4 encoder layers over 1,500 frames
HYMBA = (25, 5, 64, 32)
WHISPER = (6, 6, 64, 4)
HYMBA_WINDOW, WHISPER_FRAMES = 1024, 1500
# K2 at d 128: (B, nb, pages, timed, case, shape).  First the served
# decode steps of serve-llama (4 slots, 16 + 48 positions: 4 pages) and
# serve-qwen (160 + 48: 13 pages, int8), then the other page dtypes at
# those shapes (f32: serve-llama-f32), 4,096 positions split over 8
# blocks, and the untimed split cases
K2_D128_CASES = [(4, 4, "bf16", True, None, LLAMA),
                 (4, 13, "int8", True, None, QWEN),
                 (4, 4, "int8", True, None, LLAMA),
                 (4, 13, "bf16", True, None, QWEN),
                 (4, 4, "f32", True, None, LLAMA),
                 (4, 13, "f32", False, None, QWEN),
                 (8, 256, "bf16", True, None, LLAMA),
                 (8, 256, "int8", True, None, QWEN),
                 (8, 256, "int8", False, "holes", LLAMA),
                 (8, 256, "bf16", False, "one split", QWEN)]
# K2 at d 80, G 1 (stablelm-3b): serve-stablelm's decode step (4 slots,
# 160 + 48 positions: 13 pages) in each page dtype (f32: serve-stablelm-
# f32), 4,096 positions split over 8 blocks (the d-80 merge), and the
# untimed split cases
K2_D80_CASES = [(4, 13, "bf16", True, None, STABLELM),
                (4, 13, "int8", True, None, STABLELM),
                (4, 13, "f32", True, None, STABLELM),
                (8, 256, "bf16", True, None, STABLELM),
                (8, 256, "int8", False, "holes", STABLELM),
                (8, 256, "f32", False, "one split", STABLELM)]
# K2 at (64, 2) and (128, 4), the MoE fleets': serve-granite's and
# serve-phi's decode step (4 slots, 160 + 48 positions: 13 pages) in each
# page dtype (f32: their f32 fleets), 4,096 positions split over 8 blocks,
# and the untimed split cases
K2_MOE_CASES = [(4, 13, dtype, True, None, shape)
                for shape in (GRANITE, PHI)
                for dtype in ("bf16", "int8", "f32")] + [
    (8, 256, "bf16", True, None, GRANITE),
    (8, 256, "bf16", True, None, PHI),
    (8, 256, "int8", False, "holes", GRANITE),
    (8, 256, "f32", False, "one split", PHI)]
# K2 at (128, 7): serve-llava's decode step (4 slots on 184 pages: rows
# from a text request's 160 + 48 positions to an image request's 2,944,
# split over blocks), its f32 pages (serve-llava-f32), int8 pages (the
# instance's third page dtype, not served), and the untimed split cases
K2_LLAVA_CASES = [(4, LLAVA_PAGES, "bf16", True, None, LLAVA),
                  (4, LLAVA_PAGES, "f32", True, None, LLAVA),
                  (4, 13, "int8", False, None, LLAVA),
                  (8, 256, "bf16", False, "holes", LLAVA),
                  (8, 256, "f32", False, "one split", LLAVA)]


def phase_k2(torch, timer):
    import torch.nn.functional as F
    from repro_torch.kernels import paged_decode as K2
    from repro_torch.kernels import split as SP
    gen = torch.Generator().manual_seed(SEED + 1)
    # (B, nb, dtype, timed, case): the serving shape of phase serve first (4
    # slots, 7 pages of 16 for 16 + 96 positions), then the wider cases;
    # f32 pages (the float32 model of phase model) at the serving shape;
    # then nb 64 (1,024 positions, 4 splits) and the untimed split cases
    cases = [(4, 7, "bf16", True, None), (8, 8, "bf16", True, None),
             (8, 256, "bf16", True, None), (8, 8, "int8", True, None),
             (8, 256, "int8", True, None), (4, 7, "f32", True, None),
             (8, 64, "bf16", True, None), (8, 256, "bf16", False, "holes"),
             (8, 256, "int8", False, "holes"),
             (8, 256, "bf16", False, "one split")]
    cases = ([c + (SMOLLM,) for c in cases] + K2_D128_CASES + K2_D80_CASES
             + K2_MOE_CASES + K2_LLAVA_CASES)
    rows = []
    for B, nb, dtype, timed, case, shape in cases:
        H, KV, d, layers = shape
        q, k, v, tables, valid, ks, vs = paged_case(torch, gen, B, nb, dtype,
                                                    H, KV, d)
        if case is not None:
            valid = k2_shape_rows(torch, gen, valid, case)
        o, l, m = K2.paged_flash_decode(q, k, v, tables, valid, ks, vs,
                                        return_partials=True)
        po, pl_, pm = K2.paged_decode_plain(q, k, v, tables, valid, ks, vs,
                                            return_partials=True)
        m_err, o_err = partial_errors((o, l, m), (po, pl_, pm), valid)
        if not (m_err <= K2_M_TOL and o_err <= K2_OUT_TOL):
            raise AssertionError(f"K2 {B}x{nb} {dtype} {case}: m err "
                                 f"{m_err}, output err {o_err}")
        if not empty_rows_hold(o, l, m, valid):
            raise AssertionError(f"K2 {B}x{nb} {dtype} {case}: an empty row "
                                 "is not (o, l, m) = (0, 0, -1e30)")
        n_split = SP.split_count(nb * 16, SP.DECODE_MAX_SPLITS)
        row = dict(B=B, nb=nb, pages=dtype, case=case, H=q.shape[1],
                   KV=k.shape[1], d=q.shape[2], bs=16,
                   valid_positions=int(valid.sum()),
                   empty_rows=int((~valid.any(1)).sum()), splits=n_split,
                   merge=n_split > 1, m_err=m_err, out_err=o_err)
        if not timed:
            emit(dict(phase="k2", **row))
            rows.append(row)
            continue
        ms = timer(lambda: K2.paged_flash_decode(
            q, k, v, tables, valid, ks, vs, return_partials=True))
        plain_ms = timer(lambda: K2.paged_decode_plain(
            q, k, v, tables, valid, ks, vs, return_partials=True))
        # yardstick: SDPA over the pages gathered (outside the timing) into
        # per-row caches, KV heads repeated to the query heads; bf16, or
        # f32 for f32 pages
        H, KV, d = q.shape[1], k.shape[1], q.shape[2]
        lib_dt = torch.float32 if dtype == "f32" else torch.bfloat16
        kg = K2._gather(k, ks, tables).to(lib_dt)
        vg = K2._gather(v, vs, tables).to(lib_dt)
        kg = kg.repeat_interleave(H // KV, dim=1)
        vg = vg.repeat_interleave(H // KV, dim=1)
        qg = q.to(lib_dt)[:, :, None, :]
        mask = valid[:, None, None, :]
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            qg, kg, vg, attn_mask=mask))
        # bytes this data needs: K and V (and int8 scales) of the valid
        # positions, q, tables, valid, and the (o, l, m) written
        n_valid = int(valid.sum())
        per_pos = KV * d * k.element_size() * 2
        if ks is not None:
            per_pos += KV * 4 * 2
        moved = (n_valid * per_pos + nbytes(q, tables, valid)
                 + nbytes(o, l, m))
        # per valid position and query head: q.k and p.v (2 d each) + softmax
        bms, by = bound_ms(moved, n_valid * H * (4 * d + 4))
        # per_step_ms: the kernel's share of one decode step, a launch a
        # layer
        row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=bms, bound_by=by, bytes=moved, layers=layers,
                   per_step_ms=layers * ms)
        emit(dict(phase="k2", **row))
        rows.append(row)
        if (nb, dtype, shape) == (256, "bf16", SMOLLM):
            from repro_torch.kernels import _build
            p = _build.ptr
            qg = q.reshape(B, KV, H // KV, d)
            split_sweep(torch, timer, "k2", lambda n, parts: (
                _build.library().paged_decode_launch(
                    p(qg), p(k), p(v), None, None, p(tables), p(valid),
                    p(o), p(l), p(m), *parts, B, KV, H // KV, d, 16, nb, n,
                    K2._DTYPE_CODE[k.dtype], float(1.0 / d ** 0.5),
                    _build.stream_of(q))), (o, l, m), nb * 16)
    return rows


# ---------------------------------------------------------------------------
# phase k3

def chunk_partial_errors(kern, plain, m_relative=False):
    """Largest m and normalised-output differences between two chunk
    partials (o, l, m) over the rows the plain version finds a valid
    position for (l > 0); every other row must hold the empty-row contract
    exactly: m = -1e30, l = 0, o = 0."""
    (o, l, m), (po, pl_, pm) = kern, plain
    o, po = o.reshape(-1, o.shape[-1]), po.reshape(-1, po.shape[-1])
    l, pl_, m, pm = l.reshape(-1), pl_.reshape(-1), m.reshape(-1), \
        pm.reshape(-1)
    live = pl_ > 0
    dead = ~live
    if dead.any():
        if not (bool((l[dead] == 0).all()) and bool((o[dead] == 0).all())
                and bool((m[dead] == -1e30).all())):
            raise AssertionError("K3: a row with no valid position broke "
                                 "the m = -1e30, l = 0, o = 0 contract")
    if not live.any():
        return 0.0, 0.0
    dm = (m - pm)[live].abs()
    if m_relative:
        dm = dm / pm[live].abs().clamp_min(1.0)
    out = o[live] / l[live, None]
    pout = po[live] / pl_[live, None]
    return float(dm.max()), float((out - pout).abs().max())


def chunk_pool(torch, gen, n_seg, nb, dtype, KV=5, d=64, bs=16):
    """A pool of n_seg*nb+1 pages (page 0 NULL) and shuffled tables."""
    P = n_seg * nb + 1
    if dtype == "int8":
        k = torch.randint(-127, 128, (P, KV, bs, d), generator=gen,
                          dtype=torch.int8).to(DEV)
        v = torch.randint(-127, 128, (P, KV, bs, d), generator=gen,
                          dtype=torch.int8).to(DEV)
        ks = (torch.rand(P, KV, bs, 1, generator=gen) * 0.02 + 1e-3).to(DEV)
        vs = (torch.rand(P, KV, bs, 1, generator=gen) * 0.02 + 1e-3).to(DEV)
    else:
        dt = torch.bfloat16 if dtype == "bf16" else torch.float32
        k = torch.randn(P, KV, bs, d, generator=gen).to(dt).to(DEV)
        v = torch.randn(P, KV, bs, d, generator=gen).to(dt).to(DEV)
        ks = vs = None
    tables = (1 + torch.randperm(n_seg * nb, generator=gen)).reshape(
        n_seg, nb).to(torch.int32)
    return k, v, ks, vs, tables


def k3_bytes_ops(k, ks, n_valid_by_seg, tok_valid, H, d, inputs, outputs):
    """Bytes the call must move (the valid K and V of every segment with a
    token, read once, the small inputs read once, the partials written
    once), the f32 operations it must do (per query head and valid
    position of its segment: q.k and p.v, 2 d each, and the softmax), and
    the share of them that are products."""
    KV = k.shape[1]
    per_pos = KV * d * k.element_size() * 2
    if ks is not None:
        per_pos += KV * 4 * 2
    moved = sum(n_valid_by_seg) * per_pos + nbytes(*inputs) + nbytes(
        *outputs)
    return moved, tok_valid * H * (4 * d + 4), tok_valid * H * 4 * d


# B4 cases at the served chunk of 64 tokens, R = 4 segments (pack_max):
# (name, nb, pages, [(tokens, cached positions) per segment]); the rest of
# the 64 tokens are padding with the last real segment's id, and the rest
# of the 4 segments are zero-length.  The first is the serving shape of
# phase serve-chunked: a prompt's third chunk (32 tokens, 128 cached) packed with the
# head of the next prompt (32 tokens, no cache yet).
K3_B4_CASES = [
    ("served", 16, "bf16", [(32, 128), (32, 0)]),
    ("served", 16, "int8", [(32, 128), (32, 0)]),
    ("served", 16, "f32", [(32, 128), (32, 0)]),
    ("one segment", 16, "bf16", [(64, 128)]),
    ("four segments", 16, "bf16", [(16, 200), (16, 0), (16, 37), (8, 255)]),
    ("padding", 16, "bf16", [(30, 64), (20, 129)]),
    ("nb 256", 256, "bf16", [(64, 4000)]),
    ("nb 256", 256, "int8", [(40, 4000), (24, 1500)]),
]
# B3 cases: (B, C, nb, pages, cached positions per request); the first is
# the shape of phase model-chunked's last chunk
K3_B3_CASES = [
    (1, 64, 16, "bf16", [128]),
    (1, 64, 16, "int8", [128]),
    (1, 64, 16, "f32", [128]),
    (4, 64, 256, "bf16", [0, 64, 1000, 4000]),
    (4, 64, 256, "int8", [0, 64, 1000, 4000]),
]
# untimed B4 cases of the split-KV and holed-row paths: validity rows with
# holes inside the valid range (every other position, at random, of the
# cached ones; the first and last kept), at the served width and split
# over 16 blocks; and one segment over 64 pages (4 splits) whose 130
# cached positions fill 3 tiles, so the last split holds no valid position
K3_B4_UNTIMED = [
    ("holes", 16, "bf16", [(32, 200), (32, 100)], True),
    ("holes, split", 256, "int8", [(40, 4000), (24, 1500)], True),
    ("split, last split empty", 64, "bf16", [(64, 130)], False),
]
# K3 at d 128, (G 3 and G 1): the served chunk of serve-qwen (int8 pages,
# a 160-token prompt's third chunk packed with the next one's head), the
# same at bf16 and f32 and at llama's shape, one segment on the tensor
# cores with one warp a block (G 1), and 4,000 cached positions split over
# 16 blocks
K3_D128_B4_CASES = [
    ("served", 16, "int8", [(32, 128), (32, 0)], QWEN),
    ("served", 16, "bf16", [(32, 128), (32, 0)], QWEN),
    ("served", 16, "bf16", [(32, 128), (32, 0)], LLAMA),
    ("served", 16, "int8", [(32, 128), (32, 0)], LLAMA),
    ("served", 16, "f32", [(32, 128), (32, 0)], LLAMA),
    ("served", 16, "f32", [(32, 128), (32, 0)], QWEN),
    ("four segments", 16, "int8", [(16, 200), (16, 0), (16, 37), (8, 255)],
     QWEN),
    ("nb 256", 256, "bf16", [(64, 4000)], LLAMA),
    ("nb 256", 256, "int8", [(40, 4000), (24, 1500)], QWEN),
]
# B3 at d 128: one request's 64-token chunk over 128 cached positions
K3_D128_B3_CASES = [(1, 64, 16, "int8", [128], QWEN),
                    (1, 64, 16, "bf16", [128], LLAMA),
                    (4, 64, 256, "int8", [0, 64, 1000, 4000], LLAMA)]
K3_D128_UNTIMED = [
    ("holes", 16, "int8", [(32, 200), (32, 100)], True, QWEN),
    ("holes, split", 256, "bf16", [(40, 4000), (24, 1500)], True, LLAMA),
    ("split, last split empty", 64, "int8", [(64, 130)], False, QWEN),
]
# K3 at the tree verify shape: 4 slots x 10 nodes (a 3.3 tree, serve-tree's
# step), unequal cache prefixes, bf16 and int8 pages, at d 64 and at d 128
# (G 3); K3 never sees the tree (each token reads its segment's prefix),
# the merge folds the nodes' own keys under the ancestor mask
K3_TREE = (3, 3)
K3_TREE_CASES = [("tree 3.3", 16, dtype, [(10, 37), (10, 112), (10, 200),
                                          (10, 64)], shape)
                 for shape in (SMOLLM, LLAMA) for dtype in ("bf16", "int8")]
# K3 at d 80, G 1 (stablelm-3b): serve-stablelm's chunk (a 160-token
# prompt's third chunk packed with the next one's head) in each page dtype,
# four segments, 4,000 cached positions split over 16 blocks (the d-80
# merge), B3 chunks, the untimed holed and split rows, and the tree verify
# shape
K3_D80_B4_CASES = [
    ("served", 16, "bf16", [(32, 128), (32, 0)], STABLELM),
    ("served", 16, "int8", [(32, 128), (32, 0)], STABLELM),
    ("served", 16, "f32", [(32, 128), (32, 0)], STABLELM),
    ("four segments", 16, "bf16", [(16, 200), (16, 0), (16, 37), (8, 255)],
     STABLELM),
    ("nb 256", 256, "bf16", [(64, 4000)], STABLELM),
    ("nb 256", 256, "int8", [(40, 4000), (24, 1500)], STABLELM),
]
K3_D80_B3_CASES = [(1, 64, 16, "bf16", [128], STABLELM),
                   (1, 64, 16, "int8", [128], STABLELM),
                   (1, 64, 16, "f32", [128], STABLELM),
                   (4, 64, 256, "int8", [0, 64, 1000, 4000], STABLELM)]
K3_D80_UNTIMED = [
    ("holes", 16, "bf16", [(32, 200), (32, 100)], True, STABLELM),
    ("holes, split", 256, "int8", [(40, 4000), (24, 1500)], True, STABLELM),
    ("split, last split empty", 64, "bf16", [(64, 130)], False, STABLELM),
]
K3_D80_TREE_CASES = [("tree 3.3", 16, dtype, [(10, 37), (10, 112), (10, 200),
                                              (10, 64)], STABLELM)
                     for dtype in ("bf16", "int8")]
# K3 at (64, 2) and (128, 4), the MoE fleets': serve-granite's and
# serve-phi's chunk (a 160-token prompt's third chunk packed with the next
# one's head) in each page dtype, four segments, 4,000 cached positions
# split over 16 blocks, a B3 chunk, the untimed holed and split rows
K3_MOE_B4_CASES = [("served", 16, dtype, [(32, 128), (32, 0)], shape)
                   for shape in (GRANITE, PHI)
                   for dtype in ("bf16", "int8", "f32")] + [
    ("four segments", 16, "bf16", [(16, 200), (16, 0), (16, 37), (8, 255)],
     GRANITE),
    ("nb 256", 256, "bf16", [(64, 4000)], PHI),
    ("nb 256", 256, "int8", [(40, 4000), (24, 1500)], GRANITE)]
K3_MOE_B3_CASES = [(1, 64, 16, "bf16", [128], GRANITE),
                   (1, 64, 16, "bf16", [128], PHI),
                   (4, 64, 256, "int8", [0, 64, 1000, 4000], PHI)]
K3_MOE_UNTIMED = [
    ("holes", 16, "bf16", [(32, 200), (32, 100)], True, PHI),
    ("holes, split", 256, "int8", [(40, 4000), (24, 1500)], True, PHI),
    ("split, last split empty", 64, "bf16", [(64, 130)], False, GRANITE),
]
# K3 at (128, 7), serve-llava's: a text request's 160-token prompt in its
# third chunk packed with the next one's head, on the pool's 184-page
# table (2,944 virtual positions: split over blocks in bf16), in bf16 and
# f32 (serve-llava-f32) pages, int8 pages (not served), 4,000 cached
# positions, a B3 chunk (the instance's other entry, not served), the
# untimed holed and split rows
K3_LLAVA_B4_CASES = [
    ("served", LLAVA_PAGES, "bf16", [(32, 128), (32, 0)], LLAVA),
    ("served", LLAVA_PAGES, "f32", [(32, 128), (32, 0)], LLAVA),
    ("served", 16, "int8", [(32, 128), (32, 0)], LLAVA),
    ("nb 256", 256, "bf16", [(64, 4000)], LLAVA)]
K3_LLAVA_B3_CASES = [(1, 64, 16, "bf16", [128], LLAVA)]
K3_LLAVA_UNTIMED = [
    ("holes", LLAVA_PAGES, "bf16", [(32, 2900), (32, 100)], True, LLAVA),
    ("holes, split", 256, "int8", [(40, 4000), (24, 1500)], True, LLAVA),
    ("split, last split empty", 64, "f32", [(64, 130)], False, LLAVA),
]
# bf16 / int8 inputs upcast exactly; f32 sums in another order than the
# plain one-shot softmax: K2's tolerances
K3_M_TOL, K3_OUT_TOL = 1e-4, 2e-3


def _sdpa_ms(torch, timer, q4, k, v, ks, vs, tables, mask, dtype):
    """SDPA over the pages gathered (outside the timing) per segment, KV
    heads repeated to the query heads: the yardstick, never the port's."""
    import torch.nn.functional as F
    from repro_torch.models import attention as A
    H, KV = q4.shape[1], k.shape[1]
    lib_dt = torch.float32 if dtype == "f32" else torch.bfloat16
    pages = {"k": k, "v": v}
    if ks is not None:
        pages.update(k_scale=ks, v_scale=vs)
    kg, vg = (x.to(lib_dt).repeat_interleave(H // KV, 1)
              for x in A.gather_page_rows(pages, tables))
    qg = q4.to(lib_dt)
    return timer(lambda: F.scaled_dot_product_attention(qg, kg, vg,
                                                        attn_mask=mask))


def k3_b4_case(torch, timer, gen, name, nb, dtype, segs, C=64, R=4,
               holes=False, timed=True, shape=None, tree=None):
    """One packed chunk of C tokens in R segments ((tokens, cached
    positions) each) through K3 and its plain version: errors, the merged
    output, times beside SDPA and the bounds.  ``holes`` drops about half
    of each segment's cached positions (not its first and last); ``shape``
    the (heads, KV heads, d_head, layers) of a served config (smollm-360m's
    by default).  ``tree`` (W, D): each segment is a tree verify block of
    1 + W*D nodes in the engine's BFS comb, and the merge folds the
    chunk's own keys under the ancestor mask."""
    from repro_torch.kernels import paged_chunk as K3
    from repro_torch.models import attention as A
    H, KV, d, _ = shape or SMOLLM
    bs = 16
    k, v, ks, vs, tables = chunk_pool(torch, gen, R, nb, dtype, KV, d)
    n_tok = sum(t for t, _ in segs)
    seg = torch.full((C,), len(segs) - 1, dtype=torch.int32)
    lengths = torch.zeros(R, dtype=torch.int32)
    starts = torch.zeros(R, dtype=torch.int32)
    off = 0
    for i, (t, cached) in enumerate(segs):
        seg[off:off + t] = i
        lengths[i], starts[i] = t, cached
        off += t
    valid = torch.arange(nb * bs)[None, :] < starts[:, None]
    if holes:
        valid &= torch.rand(R, nb * bs, generator=gen) < 0.5
        for i, (_, cached) in enumerate(segs):
            if cached:
                valid[i, [0, cached - 1]] = True
    q = torch.randn(C, H, d, generator=gen)
    q, seg, tables, valid = (t.to(DEV) for t in (q, seg, tables, valid))
    got = K3.paged_flash_packed_chunk(q, k, v, seg, tables, valid, ks, vs)
    want = K3.paged_packed_chunk_plain(q, k, v, seg, tables, valid, ks, vs)
    m_err, o_err = chunk_partial_errors(got, want)
    # the merged output every token sees, the chunk's own keys folded in
    # under the block-diagonal mask: holds the empty-cache segment
    offsets = torch.cumsum(lengths, 0) - lengths
    sl = seg.long().cpu()
    tpos = torch.arange(C) - offsets[sl]
    vt = ((tpos >= 0) & (tpos < lengths[sl])).to(DEV)
    anc = None
    if tree is not None:
        w, dep = tree
        anc = torch.arange(C)
        for i in range(len(segs)):
            o = int(offsets[i])
            for node in range(1, 1 + w * dep):
                anc[o + node] = o + (node - w if node > w else 0)
        anc = anc.to(DEV)
    mask = A.packed_chunk_mask(seg, vt, anc)
    kn = torch.randn(C, KV, d, generator=gen).to(DEV)
    vn = torch.randn(C, KV, d, generator=gen).to(DEV)
    qg = q.reshape(C, KV, H // KV, d)
    merged = []
    for o_, l_, m_ in (got, want):
        o2, l2 = A._merge_packed_block(qg, o_, l_, m_, kn, vn, mask)
        merged.append(o2 / l2[..., None])
    merged_err = float((merged[0] - merged[1]).abs().max())
    if not (m_err <= K3_M_TOL and o_err <= K3_OUT_TOL
            and merged_err <= K3_OUT_TOL):
        raise AssertionError(f"K3-B4 {name} {dtype} d {d} G {H // KV}: m "
                             f"err {m_err}, "
                             f"output err {o_err}, merged {merged_err}")
    row = dict(fn="B4", case=name, nb=nb, pages=dtype, C=C, R=R,
               segments=segs, padding=C - n_tok, holes=holes,
               tree=None if tree is None else f"{tree[0]}.{tree[1]}", H=H,
               KV=KV,
               d=d, bs=bs, split=K3.split_count(nb * bs, k.dtype),
               m_err=m_err, out_err=o_err, merged_err=merged_err)
    if not timed:
        return row
    ms = timer(lambda: K3.paged_flash_packed_chunk(
        q, k, v, seg, tables, valid, ks, vs))
    plain_ms = timer(lambda: K3.paged_packed_chunk_plain(
        q, k, v, seg, tables, valid, ks, vs))
    # SDPA: every segment's queries (all C tokens, masked to the segment's
    # own) against its gathered pages
    smask = (valid[:, None, :] & (seg[None, :, None] == torch.arange(
        R, device=DEV)[:, None, None]))[:, None]
    q4 = q.permute(1, 0, 2)[None].expand(R, H, C, d)
    lib_ms = _sdpa_ms(torch, timer, q4, k, v, ks, vs, tables, smask, dtype)
    per_seg = valid.sum(1).cpu()
    n_valid = [int(per_seg[i]) if t else 0 for i, (t, _) in enumerate(segs)]
    tok_valid = int(per_seg[seg.long().cpu()].sum())
    moved, ops, tc_ops = k3_bytes_ops(k, ks, n_valid, tok_valid, H, d,
                                      (q, seg, tables, valid), got)
    bms, by = bound_ms(moved, ops)
    tc_ms, tc_by = bound_tc_ms(moved, tc_ops, ops - tc_ops)
    row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
               bound_by=by, bound_tc_ms=tc_ms, bound_tc_by=tc_by,
               bytes=moved)
    return row


def k3_b3_case(torch, timer, gen, B, Cb, nb, dtype, cached, shape=None):
    """B requests of Cb chunk tokens each (``cached`` positions apiece)
    through K3's B3 entry and its plain version, timed beside SDPA."""
    from repro_torch.kernels import paged_chunk as K3
    H, KV, d, _ = shape or SMOLLM
    bs = 16
    k, v, ks, vs, tables = chunk_pool(torch, gen, B, nb, dtype, KV, d)
    valid = torch.arange(nb * bs)[None, :] < torch.tensor(cached)[:, None]
    q = torch.randn(B, Cb, H, d, generator=gen)
    q, tables, valid = (t.to(DEV) for t in (q, tables, valid))
    got = K3.paged_flash_prefill_chunk(q, k, v, tables, valid, ks, vs)
    want = K3.paged_prefill_chunk_plain(q, k, v, tables, valid, ks, vs)
    m_err, o_err = chunk_partial_errors(got, want)
    if not (m_err <= K3_M_TOL and o_err <= K3_OUT_TOL):
        raise AssertionError(f"K3-B3 {B}x{Cb} nb {nb} {dtype} d {d}: m err "
                             f"{m_err}, output err {o_err}")
    ms = timer(lambda: K3.paged_flash_prefill_chunk(
        q, k, v, tables, valid, ks, vs))
    plain_ms = timer(lambda: K3.paged_prefill_chunk_plain(
        q, k, v, tables, valid, ks, vs))
    lib_ms = _sdpa_ms(torch, timer, q.permute(0, 2, 1, 3), k, v, ks, vs,
                      tables, valid[:, None, None, :], dtype)
    moved, ops, tc_ops = k3_bytes_ops(k, ks, cached, Cb * sum(cached),
                                      H, d, (q, tables, valid), got)
    bms, by = bound_ms(moved, ops)
    tc_ms, tc_by = bound_tc_ms(moved, tc_ops, ops - tc_ops)
    return dict(fn="B3", B=B, C=Cb, nb=nb, pages=dtype, cached=cached,
                H=H, KV=KV, d=d, bs=bs,
                split=K3.split_count(nb * bs, k.dtype), m_err=m_err,
                out_err=o_err, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bms, bound_by=by,
                bound_tc_ms=tc_ms, bound_tc_by=tc_by, bytes=moved)


def phase_k3(torch, timer):
    """smollm-360m's cases first (their draws as in every earlier run),
    then the d-128 ones and the tree verify cases, then d 80's, then the
    MoE fleets' (64, 2) and (128, 4), then the VLM's (128, 7)."""
    gen = torch.Generator().manual_seed(SEED + 3)
    rows = []
    for b4, b3, untimed, tree in (
            (K3_B4_CASES, K3_B3_CASES, K3_B4_UNTIMED, []),
            (K3_D128_B4_CASES, K3_D128_B3_CASES, K3_D128_UNTIMED,
             K3_TREE_CASES),
            (K3_D80_B4_CASES, K3_D80_B3_CASES, K3_D80_UNTIMED,
             K3_D80_TREE_CASES),
            (K3_MOE_B4_CASES, K3_MOE_B3_CASES, K3_MOE_UNTIMED, []),
            (K3_LLAVA_B4_CASES, K3_LLAVA_B3_CASES, K3_LLAVA_UNTIMED, [])):
        for name, nb, dtype, segs, *shape in b4:
            rows.append(k3_b4_case(torch, timer, gen, name, nb, dtype, segs,
                                   shape=shape[0] if shape else None))
            emit(dict(phase="k3", **rows[-1]))
        for B, Cb, nb, dtype, cached, *shape in b3:
            rows.append(k3_b3_case(torch, timer, gen, B, Cb, nb, dtype,
                                   cached, shape[0] if shape else None))
            emit(dict(phase="k3", **rows[-1]))
        for name, nb, dtype, segs, holes, *shape in untimed:
            rows.append(k3_b4_case(torch, timer, gen, name, nb, dtype, segs,
                                   holes=holes, timed=False,
                                   shape=shape[0] if shape else None))
            emit(dict(phase="k3", **rows[-1]))
        for name, nb, dtype, segs, shape in tree:
            rows.append(k3_b4_case(torch, timer, gen, name, nb, dtype, segs,
                                   C=40, shape=shape, tree=K3_TREE))
            emit(dict(phase="k3", **rows[-1]))
    return rows


# ---------------------------------------------------------------------------
# phase k4: the masked multi-token probe step of speculative decode

# f32, another reduction order than the plain version: K1's tolerance
K4_TOL = 1e-5
# per-slot biases whose scores (.05, .95, .27, .98, .92, .12, .97, .38)
# keep every smoothed score at least about 0.2 from lambda* = 0.6
K4_BIASES = (-3.0, 3.0, -1.0, 4.0, 2.5, -2.0, 3.5, -0.5)
K4_MODES = ("zero", "one", "T-1", "T", "mixed")


def k4_accept(torch, mode, B, T):
    if mode == "mixed":
        acc = [(i * 3) % (T + 1) for i in range(B)]
    else:
        acc = [{"zero": 0, "one": 1, "T-1": T - 1, "T": T}[mode]] * B
    return torch.tensor(acc, dtype=torch.int32, device=DEV)


def k4_state(torch, gen, B, f, win, burn_in, warm):
    """``warm``: every slot at the burn-in with its ring holding its own
    score, so a high-bias slot stops on its first boundary token and the
    rest of its chain is frozen, and slot 1 stopped on entry; otherwise a
    fresh state, where the burn-in holds every stop for burn_in scores."""
    W = (torch.randn(B, f, generator=gen) / f ** 0.5).to(DEV)
    b = torch.tensor(K4_BIASES[:B] if B > 1 else (3.0,)).to(DEV)
    ring = torch.zeros(B, win, device=DEV)
    n = torch.zeros(B, dtype=torch.int32, device=DEV)
    stopped = torch.zeros(B, dtype=torch.bool, device=DEV)
    stop_step = torch.full((B,), -1, dtype=torch.int32, device=DEV)
    if warm:
        ring[:, -burn_in:] = torch.sigmoid(b)[:, None]
        n.fill_(burn_in)
        if B > 1:
            stopped[1], stop_step[1] = True, burn_in
    return [W, b, ring, n, stopped, stop_step]


def k4_case(torch, K1, K4, gen, B, T, f, mode, warm, win=4, burn_in=2,
            eta=0.05, lam=0.6, same=False):
    """K4, its plain version and ``accept[i]`` K1 launches (T masked K1
    launches) from copies of one CUDA state: the integer and boolean state
    must be equal, the floats within K4_TOL, and K4 must equal the chained
    K1 launches bit for bit.  ``same``: zk is zq, one tensor, in K4 and in
    every K1 launch (the served no-QK view)."""
    zq = (torch.randn(B, T, f, generator=gen) / f ** 0.5).to(DEV)
    zk = zq if same else (torch.randn(B, T, f, generator=gen)
                          / f ** 0.5).to(DEV)
    bnd = torch.rand(B, T, generator=gen) < 0.7
    bnd[:, 0] = True
    bnd = bnd.to(DEV)
    acc = k4_accept(torch, mode, B, T)
    st = k4_state(torch, gen, B, f, win, burn_in, warm)
    kern, plain, chain = ([t.clone() for t in st] for _ in range(3))
    ko = K4.serving_probe_spec_step(zq, zk, bnd, acc, *kern, eta, lam,
                                    burn_in=burn_in)
    po = K4.serving_probe_spec_step_plain(zq, zk, bnd, acc, *plain, eta, lam,
                                          burn_in=burn_in)
    k1_n, k1_s, k1_sm = [], [], []
    for t in range(T):
        zq_t = zq[:, t].contiguous()
        zk_t = zq_t if same else zk[:, t].contiguous()
        o = K1.serving_probe_step(zq_t, zk_t,
                                  (bnd[:, t] & (t < acc)).contiguous(),
                                  *chain, eta, lam, burn_in=burn_in)
        k1_n.append(chain[3].clone())
        k1_s.append(o.s)
        k1_sm.append(o.smoothed)
    sync(torch)
    k1 = dict(n_seq=torch.stack(k1_n, 1), s=torch.stack(k1_s, 1),
              smoothed_seq=torch.stack(k1_sm, 1), W=chain[0], b=chain[1],
              ring=chain[2], n_scores=chain[3], stopped=chain[4],
              stop_step=chain[5])
    case = dict(B=B, T=T, f=f, accept=mode, warm=warm,
                view="same" if same else "distinct", window=win)
    for name in ("n_seq", "n_scores", "stopped", "stop_step"):
        a = getattr(ko, name)
        for other, want in (("plain", getattr(po, name)),
                            ("chained K1", k1[name])):
            if not torch.equal(a, want):
                raise AssertionError(f"K4 {case}: {name} differs from "
                                     f"{other}: {a.tolist()} vs "
                                     f"{want.tolist()}")
    err = {name: float((getattr(ko, name) - getattr(po, name)).abs().max())
           for name in ("s", "smoothed_seq", "W", "b", "ring")}
    k1_err = {name: float((getattr(ko, name) - k1[name]).abs().max())
              for name in ("s", "smoothed_seq", "W", "b", "ring")}
    if max(err.values()) > K4_TOL or max(k1_err.values()) > K4_TOL:
        raise AssertionError(f"K4 {case}: off its plain version {err} or "
                             f"chained K1 {k1_err}")
    # the spec-decode invariant: accept[i] = a is a sequential K1 launches,
    # bit for bit
    bitwise = all(torch.equal(getattr(ko, name), k1[name])
                  for name in ("s", "smoothed_seq", "W", "b", "ring"))
    if DEV == "cuda" and not bitwise:
        raise AssertionError(f"K4 {case}: not bit-equal to chained K1: "
                             f"{k1_err}")
    if mode == "zero" and not all(torch.equal(a, b)
                                  for a, b in zip(kern, st)):
        raise AssertionError(f"K4 {case}: accept = 0 moved the state")
    emitted = po.n_seq > torch.cat([st[3][:, None], po.n_seq[:, :-1]], 1)
    margin = (float((po.smoothed_seq[emitted] - lam).abs().min())
              if emitted.any() else float("inf"))
    # a stop that fired on token t < accept - 1: the rest of the chain was
    # accepted but frozen
    fired = (ko.stop_step != st[5]) & (ko.stop_step >= 0)
    fired_at = (po.n_seq == ko.stop_step[:, None]).int().argmax(1)
    mid_chain = bool((fired & (fired_at < acc - 1)).any())
    return dict(case, max_abs_err=err, chained_k1_err=k1_err,
                chained_k1_bitwise=bitwise, lambda_margin=margin,
                stops=int(fired.sum()), mid_chain_stop=mid_chain)


# timed shapes (B slots, T verify tokens, f): the served shape first (4
# slots, k = 4, smollm-360m's f 960), then more slots, a longer block, and
# both at qwen1.5-32b's width; zq and zk two tensors
K4_TIMED = ((4, 4, 960), (8, 4, 960), (4, 8, 960), (8, 8, 5120))
# the slope over the chain's length at the served width, in both views
K4_SLOPE_T = (1, 2, 4, 8)


def k4_timed(torch, timer, K1, K4, gen, B, T, f, win=4, eta=0.05, lam=1.5,
             same=False):
    """K4 and its plain version timed with every token accepted and at a
    boundary; lambda* above 1 is out of reach, so every timed call updates
    every slot's W, b and ring for all T tokens: the work the bound
    counts.  ``same``: zk is zq."""
    zq = (torch.randn(B, T, f, generator=gen) / f ** 0.5).to(DEV)
    zk = zq if same else (torch.randn(B, T, f, generator=gen)
                          / f ** 0.5).to(DEV)
    bnd = torch.ones(B, T, dtype=torch.bool, device=DEV)
    acc = k4_accept(torch, "T", B, T)
    st = k4_state(torch, gen, B, f, win, 2, False)
    ms = timer(lambda: K4.serving_probe_spec_step(zq, zk, bnd, acc, *st, eta,
                                                  lam, burn_in=2), reps=200)
    plain_ms = timer(lambda: K4.serving_probe_spec_step_plain(
        zq, zk, bnd, acc, *st, eta, lam, burn_in=2), reps=200)
    if bool(st[4].any()):
        raise AssertionError("K4 timing: a slot stopped")
    # read the inputs and the whole state once; write W, b, ring, n_scores
    # and stopped (stop_step is untouched without a stop) and the three
    # (B, T) outputs; ~7 f32 operations per feature and token (5 where zk
    # is zq: one dot)
    W, b, ring, n, stopped, _ = st
    rows = (zq,) if same else (zq, zk)
    moved = (nbytes(*rows, bnd, acc, *st) + nbytes(W, b, ring, n, stopped)
             + 3 * 4 * B * T)
    bms, by = bound_ms(moved, (5 if same else 7) * B * T * f)
    return dict(B=B, T=T, f=f, window=win, lam=lam,
                view="same" if same else "distinct", ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by, bytes=moved,
                **chain_config(K1, f, same, win))


def slope(rows) -> float:
    """Least-squares ms per token over the rows' T."""
    ts = [r["T"] for r in rows]
    ms = [r["ms"] for r in rows]
    tm, mm = sum(ts) / len(ts), sum(ms) / len(ms)
    return (sum((t - tm) * (m - mm) for t, m in zip(ts, ms))
            / sum((t - tm) ** 2 for t in ts))


def phase_k4(torch, timer):
    from repro_torch.kernels import probe_spec as K4
    from repro_torch.kernels import probe_step as K1
    gen = torch.Generator().manual_seed(SEED + 7)
    floor = floor_ms(torch, timer)
    rows = []
    for B in (1, 4, 8):
        for T in (1, 2, 4, 8):
            for f in (128, 960, 5120):
                for mode in K4_MODES:
                    rows.append(k4_case(torch, K1, K4, gen, B, T, f, mode,
                                        warm=True))
    # burn-in not reached: fresh slots at the served shape
    for T in (1, 2, 4, 8):
        row = k4_case(torch, K1, K4, gen, 4, T, 960, "T", warm=False)
        if T <= 2 and row["stops"]:
            raise AssertionError(f"K4 stopped before the burn-in: {row}")
        rows.append(row)
    # zk the same tensor as zq (one row read) and a different one, at every
    # view width, f 130 (no multiple of 4: rows move as floats) among them
    for f in VIEW_WIDTHS:
        for same in (True, False):
            for T in (1, 4, 8):
                for mode in ("T", "mixed"):
                    rows.append(k4_case(torch, K1, K4, gen, 4, T, f, mode,
                                        warm=True, same=same))
    # a smoothing window wider than the registers hold (in shared memory):
    # 24 tokens wrap a window of 17
    for win, T in ((WIDE_WINDOW, 24), (40, 8)):
        for same in (True, False):
            for mode in ("T", "mixed"):
                rows.append(k4_case(torch, K1, K4, gen, 4, T, 960, mode,
                                    warm=True, win=win, same=same))
    # serve-llava's probe width, 7168 (K4 is not on its path: its kernel
    # is K1's, which runs there at T 1), both views, from its own generator
    gen_llava = torch.Generator().manual_seed(SEED + 71)
    for same in (True, False):
        for T in (1, 4, 8):
            for mode in ("T", "mixed"):
                rows.append(k4_case(torch, K1, K4, gen_llava, 4, T,
                                    LLAVA_PROBE_F, mode, warm=True,
                                    same=same))
    if not any(r["mid_chain_stop"] for r in rows):
        raise AssertionError("K4: no case stopped mid-chain")
    if min(r["lambda_margin"] for r in rows) < 1e-3:
        raise AssertionError("K4: inputs came within 1e-3 of lambda*")
    # a width above the widest config is refused
    wide = K4.MAX_F + 1
    try:
        z = torch.zeros(1, 1, wide, device=DEV)
        K4.serving_probe_spec_step(
            z, z, torch.ones(1, 1, dtype=torch.bool, device=DEV),
            torch.ones(1, dtype=torch.int32, device=DEV),
            *k4_state(torch, gen, 1, wide, 4, 2, False), 0.05, 0.6,
            burn_in=2)
    except ValueError:
        pass
    else:
        if DEV == "cuda":
            raise AssertionError(f"K4 accepted f = {wide}")

    timed = [k4_timed(torch, timer, K1, K4, gen, *shape)
             for shape in K4_TIMED]
    slopes = {}
    for same in (True, False):
        view = "same" if same else "distinct"
        slopes[view] = [k4_timed(torch, timer, K1, K4, gen, 4, T, 960,
                                 same=same) for T in K4_SLOPE_T]
    # the served shape with its window in shared memory
    wide_timed = k4_timed(torch, timer, K1, K4, gen, 4, 4, 960, win=40)
    llava_timed = k4_timed(torch, timer, K1, K4, gen_llava, 4, 4,
                           LLAVA_PROBE_F)
    # the kernels line's K4 time: two rows (zk another tensor) at the
    # served shape, as every slice has reported it; the served view (zk is
    # zq) beside it
    main = timed[0]
    served = next(r for r in slopes["same"] if r["T"] == 4)
    worst = max(max(r["max_abs_err"].values()) for r in rows)
    worst_k1 = max(max(r["chained_k1_err"].values()) for r in rows)
    res = dict(phase="k4", cases=len(rows), max_abs_err=worst, tol=K4_TOL,
               chained_k1_max_abs_err=worst_k1,
               chained_k1_bitwise=sum(r["chained_k1_bitwise"] for r in rows),
               mid_chain_stops=sum(r["mid_chain_stop"] for r in rows),
               lambda_margin=min(r["lambda_margin"] for r in rows),
               floor_ms=floor, timed=timed, wide_window_timed=wide_timed,
               llava_timed=llava_timed,
               slope_rows=slopes,
               slope_ms_per_token={v: slope(r) for v, r in slopes.items()},
               ms=main["ms"], plain_ms=main["plain_ms"],
               bound_ms=main["bound_ms"], bound_by=main["bound_by"],
               library_ms=None, served_ms=served["ms"],
               served_plain_ms=served["plain_ms"],
               served_bound_ms=served["bound_ms"], served=served,
               per_case=[(r["B"], r["T"], r["f"], r["accept"], r["warm"],
                          r["view"], r["window"],
                          max(r["max_abs_err"].values()), r["stops"])
                         for r in rows])
    emit(res)
    # K3 at the verify shape of a spec step: 4 slots x k = 4 tokens, each
    # segment with its own cache (16 to 112 positions over 7 pages)
    k3v = k3_b4_case(torch, timer, torch.Generator().manual_seed(SEED + 8),
                     "verify", 7, "bf16", [(4, 20), (4, 45), (4, 70),
                                           (4, 100)], C=16)
    emit(dict(phase="k3-verify", **k3v))
    return res


# ---------------------------------------------------------------------------
# phase k5: the offline TTT scan

# the offline split of benchmarks/common.py at smollm-360m's width
N_TRAIN, N_CAL, N_TEST, D_PHI = 500, 170, 170, 960
# the RWKV fleet's probe width: rwkv6-1.6b's d_model
RWKV_PROBE_F = 2048
# serve-llama's probe width (llama3.2-3b's d_model)
LLAMA_PROBE_F = 3072
# and serve-stablelm's, stablelm-3b's d_model
STABLELM_PROBE_F = 2560
# and serve-granite's and serve-phi's (granite-moe-1b's and phi3.5-moe's
# d_model), each the top of a band of K1's and K5's instances
GRANITE_PROBE_F, PHI_PROBE_F = 1024, 4096
# and serve-llava's, llava-next-34b's d_model: the widest band's top,
# MAX_F
LLAVA_PROBE_F = 7168
# and serve-hymba's and serve-whisper's (hymba-1.5b's and whisper-tiny's
# d_model)
HYMBA_PROBE_F, WHISPER_PROBE_F = 1600, 384
K5_TOL = 1e-5


def corpus():
    from repro_torch.trajectories import corpus_splits
    return corpus_splits(N_TRAIN, N_CAL, N_TEST, d_phi=D_PHI, seed=SEED)


def k5_bytes_ops(zq, zk, c, m, w0, b0, eta, outs):
    """Each distinct input read once (the served no-QK view passes one
    tensor as both zq and zk), each output written once; about 7 f32
    operations per feature and step (two dots, the update)."""
    ins = {id(t): t for t in (zq, zk, c, m, w0, b0, eta)}
    n, T, f = zq.shape
    return nbytes(*ins.values(), *outs), 7 * n * T * f


def k5_cases(torch, test):
    """Phase k5's inputs on the card: f 128 (a QK view, d_h 128), D_PHI
    960 (the served no-QK view: the corpus's step embeddings as both zq and
    zk), 5120 (N(0, 1) features at qwen1.5-32b's width) and 2048 (the
    no-QK view at rwkv6-1.6b's d_model, as serve-rwkv fits its probe: the
    embeddings projected to 2048, one tensor as zq and zk) and 3072 (the
    no-QK view at llama3.2-3b's d_model: N(0, 1) features, one tensor); N
    1 and 170; T 1, 37 and 120; masks from the corpus's ragged lengths; c
    = 0 (deployed) or c = the supervised labels (the "true" inner-label
    mode); W0 per trajectory (``ttt_probe_batched``) or shared
    (``ttt_probe_scan``); and 1024 and 4096 (the no-QK views at
    granite-moe-1b's and phi3.5-moe's d_model: N(0, 1) features, one
    tensor), the top of the bands 960 and 3072 run in, and 7168
    (llava-next-34b's, alike), the top of the widest band, and 1600 and
    384 (hymba-1.5b's and whisper-tiny's, alike), inside the bands of 2048
    and 1024.  The ten widths run six of the kernel's instances, those of
    every width a phase of this script fits at."""
    from repro_torch.core.labels import supervised_labels
    gen = torch.Generator().manual_seed(SEED + 5)
    phis = torch.as_tensor(test.phis).to(DEV)
    mask = torch.as_tensor(test.mask).float().to(DEV)
    labels = torch.as_tensor(supervised_labels(test.correct, test.mask)
                             ).float().to(DEV)
    theta_qk = [(torch.randn(D_PHI, 128, generator=gen) / D_PHI ** 0.5)
                .to(DEV) for _ in range(2)]
    # its own generator, so that the other widths' draws stay as they were
    theta_up = (torch.randn(D_PHI, RWKV_PROBE_F, generator=torch.Generator(
        ).manual_seed(SEED + 52)) / RWKV_PROBE_F ** 0.5).to(DEV)
    z_up = phis @ theta_up
    # serve-llama's view: N(0, 1) features at 3072, one tensor as zq and zk
    z_llama = torch.randn(len(test), phis.shape[1], LLAMA_PROBE_F,
                          generator=torch.Generator().manual_seed(
                              SEED + 53)).to(DEV)
    feats = {128: (phis @ theta_qk[0], phis @ theta_qk[1]),
             D_PHI: (phis, phis),
             5120: tuple(torch.randn(len(test), phis.shape[1], 5120,
                                     generator=gen).to(DEV)
                         for _ in range(2)),
             RWKV_PROBE_F: (z_up, z_up),
             LLAMA_PROBE_F: (z_llama, z_llama)}
    # serve-granite's and serve-phi's views, each from its own generator
    for fw, seed in ((GRANITE_PROBE_F, SEED + 54), (PHI_PROBE_F, SEED + 55),
                     (LLAVA_PROBE_F, SEED + 56), (HYMBA_PROBE_F, SEED + 57),
                     (WHISPER_PROBE_F, SEED + 58)):
        z = torch.randn(len(test), phis.shape[1], fw,
                        generator=torch.Generator().manual_seed(seed)).to(DEV)
        feats[fw] = (z, z)
    for f, (zq_all, zk_all) in feats.items():
        w0 = (torch.randn(f, generator=gen) / f ** 0.5).to(DEV)
        w0_rows = w0 + 0.1 * (torch.randn(len(test), f, generator=gen)
                              / f ** 0.5).to(DEV)
        b0_rows = torch.linspace(-1.0, 1.0, len(test)).to(DEV)
        # hymba's and whisper's widths (the last two) skip T 37: their
        # bands run at other widths already
        for n in (1, len(test)):
            for T in ((1, 120) if f in (HYMBA_PROBE_F, WHISPER_PROBE_F)
                      else (1, 37, 120)):
                zq = zq_all[:n, :T].contiguous()
                zk = zq if zk_all is zq_all else zk_all[:n, :T].contiguous()
                for labelled in (False, True):
                    c = (labels[:n, :T].contiguous() if labelled
                         else torch.zeros(n, T, device=DEV))
                    for shared in (True, False):
                        init = ((w0, torch.tensor(0.3, device=DEV)) if shared
                                else (w0_rows[:n].contiguous(),
                                      b0_rows[:n].contiguous()))
                        yield (dict(f=f, N=n, T=T, c="labels" if labelled
                                    else "zero", w0="shared" if shared
                                    else "per-trajectory"),
                               (zq, zk, c, mask[:n, :T].contiguous(), *init,
                                torch.tensor(0.01, device=DEV)), shared)


def k5_instances(K5):
    """Every instance of the kernel (each band of ``BANDS`` in both views):
    its figures, and on the card the library's registers, shared bytes and
    spill bytes (the query fails for an instance the library does not
    build)."""
    out = []
    for band in K5.BANDS:
        for same in (True, False):
            row = dict(f_max=band.f_max, same=same,
                       L=K5.lookahead_steps(band.f_max, same))
            if DEV == "cuda":
                row.update(K5.kernel_config(band.f_max, same))
            out.append(row)
    return out


def phase_k5(torch, timer, test):
    from repro_torch.kernels import ttt_scan as K5
    rows, worst, worst_mirror = [], 0.0, 0.0
    for case, args, shared in k5_cases(torch, test):
        zq, zk, c, m, w0, b0, eta = args
        fn = K5.ttt_probe_scan if shared else K5.ttt_probe_batched
        got = fn(*args)
        n, _, f = zq.shape
        w0_rows = w0.expand(n, f) if shared else w0
        b0_rows = b0.expand(n) if shared else b0
        want = K5.ttt_probe_batched_plain(zq, zk, c, m, w0_rows, b0_rows,
                                          eta)
        # the kernel's own L-step form, at its L for this width
        L = K5.lookahead_steps(f, zq is zk)
        mirror = K5.ttt_probe_lookahead_plain(zq, zk, c, m, w0_rows,
                                              b0_rows, eta, L)
        sync(torch)
        err = {k: float((a - b).abs().max()) if a.numel() else 0.0
               for k, a, b in zip(("scores", "W_f", "b_f"), got, want)}
        mirror_err = max(float((a - b).abs().max()) if a.numel() else 0.0
                         for a, b in zip(got, mirror))
        if not all(torch.isfinite(t).all() for t in got):
            raise AssertionError(f"K5 {case}: non-finite output")
        # f32, another summation order than the plain version's; on these
        # inputs the plain version's own f32 vs f64 spread is below 1e-6
        if max(err.values()) > K5_TOL:
            raise AssertionError(f"K5 {case} off its plain version: {err}")
        if mirror_err > K5_TOL:
            raise AssertionError(f"K5 {case} off its L = {L} form: "
                                 f"{mirror_err}")
        worst = max(worst, *err.values())
        worst_mirror = max(worst_mirror, mirror_err)
        timed = case["N"] > 1 and case["T"] == 120 and case["c"] == "zero" \
            and case["w0"] == "shared"
        if timed:
            outs = got
            case["ms"] = timer(lambda: fn(*args))
            case["plain_ms"] = timer(lambda: K5.ttt_probe_batched_plain(
                zq, zk, c, m, w0_rows, b0_rows, eta))
            moved, ops = k5_bytes_ops(*args, outs)
            case["bound_ms"], case["bound_by"] = bound_ms(moved, ops)
            case["bytes"] = moved
            # what L costs in f32: the L-step form at every L, against the
            # plain version
            case["mirror_err_by_L"] = {
                Ls: max(float((a - b).abs().max()) for a, b in zip(
                    K5.ttt_probe_lookahead_plain(zq, zk, c, m, w0_rows,
                                                 b0_rows, eta, Ls), want))
                for Ls in (1, 2, 4, 8)}
        rows.append(dict(case, L=L, max_abs_err=err, mirror_err=mirror_err))
    # the kernel's refusals: a width above the widest config (the plain
    # version has no such limit), and grad
    wide = torch.zeros(1, 1, K5.MAX_F + 1, device=DEV)
    one = torch.ones(1, 1, device=DEV)
    try:
        K5.ttt_probe_batched(wide, wide, one, one,
                             torch.zeros(1, K5.MAX_F + 1, device=DEV),
                             torch.zeros(1, device=DEV),
                             torch.tensor(0.01, device=DEV))
    except ValueError:
        pass
    else:
        if DEV == "cuda":
            raise AssertionError(f"K5 accepted f = {K5.MAX_F + 1}")
    zq, zk, c, m, w0, b0, eta = args
    try:
        K5.ttt_probe_batched(zq, zk, c, m, w0.clone().requires_grad_(True),
                             b0, eta)
    except RuntimeError:
        pass
    else:
        raise AssertionError("K5 accepted a tensor that requires grad")
    served = next(r for r in rows if r.get("ms") is not None and
                  r["f"] == D_PHI)
    res = dict(phase="k5", cases=len(rows), max_abs_err=worst, tol=K5_TOL,
               max_mirror_err=worst_mirror,
               instances=k5_instances(K5),
               served=served, timed=[r for r in rows if "ms" in r],
               per_case=[(r["f"], r["N"], r["T"], r["c"], r["w0"], r["L"],
                          max(r["max_abs_err"].values()), r["mirror_err"])
                         for r in rows])
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phase k6: dense flash decode (B7)

# bf16 / f32 caches upcast exactly; f32 sums in another order (per-warp
# online softmax, then a cross-warp merge) than the plain one-shot
# softmax, and p rounded to the cache dtype against a running instead of
# the row's maximum: K2's tolerances, m to 1e-4, normalised output to 2e-3
# of max(1, max|v|), the scale of an attention output (a random-weight
# model's values are not unit-sized)
K6_M_TOL, K6_OUT_TOL = 1e-4, 2e-3


def v_scale(v) -> float:
    return max(1.0, float(v.float().abs().max()))
# (B, S, cache dtype, timed): the served dense shape (4 slots, 16 + 96
# positions), the harvest's (24 trajectories), a long cache, then S 16 and
# 113 (no multiple of the warps' 64-position stride) and f32 caches; long
# caches split over blocks past 256 positions: (24, 4096), (4, 1024) and
# f32 at 4096 (B > 2: a window band in row 1, an empty row 2)
K6_CASES = [(4, 112, "bf16", True), (24, 112, "bf16", True),
            (8, 4096, "bf16", True), (1, 16, "bf16", False),
            (1, 113, "f32", False), (4, 113, "bf16", False),
            (24, 16, "f32", False), (4, 112, "f32", False),
            (24, 4096, "bf16", True), (4, 1024, "bf16", True),
            (4, 4096, "f32", False)]


# K6 at d 128: (B, S, cache dtype, timed, shape).  The harvests of
# serve-llama (8 trajectories, 16 + 48 positions) and serve-qwen (8 of
# 160 + 48, its int8 cache dequantised to bf16), a dense fleet's step at
# each width, f32 (serve-llama-f32's harvest), 4,096 positions split
K6_D128_CASES = [(8, 64, "bf16", True, LLAMA), (8, 208, "bf16", True, QWEN),
                 (4, 64, "bf16", True, LLAMA), (4, 208, "bf16", True, QWEN),
                 (8, 64, "f32", True, LLAMA), (4, 113, "f32", False, QWEN),
                 (1, 16, "bf16", False, QWEN),
                 (8, 4096, "bf16", True, LLAMA),
                 (4, 4096, "bf16", True, QWEN),
                 (4, 4096, "f32", False, LLAMA)]
# K6 at d 80, G 1: serve-stablelm's harvest (8 trajectories of 160 + 48
# positions), a dense fleet's step, f32, 4,096 positions split (the d-80
# merge, bf16 and f32)
K6_D80_CASES = [(8, 208, "bf16", True, STABLELM),
                (4, 208, "bf16", True, STABLELM),
                (8, 208, "f32", True, STABLELM),
                (4, 113, "f32", False, STABLELM),
                (1, 16, "bf16", False, STABLELM),
                (8, 4096, "bf16", True, STABLELM),
                (4, 4096, "f32", False, STABLELM)]


# K6 at (64, 2) and (128, 4): the harvests of serve-granite and serve-phi
# (8 trajectories of 160 + 48 positions), a dense fleet's step, f32,
# 4,096 positions split
K6_MOE_CASES = [(8, 208, "bf16", True, GRANITE), (8, 208, "bf16", True, PHI),
                (4, 208, "bf16", True, GRANITE), (4, 208, "bf16", True, PHI),
                (8, 208, "f32", True, GRANITE), (4, 113, "f32", False, PHI),
                (1, 16, "bf16", False, GRANITE),
                (8, 4096, "bf16", True, GRANITE),
                (4, 4096, "bf16", True, PHI)]
# K6 at (128, 7): serve-llava's harvest (a batch of 4 image trajectories,
# 2,880 + 16 + 48 positions, split over blocks), f32, an admission-sized
# cache
K6_LLAVA_CASES = [(4, 2944, "bf16", True, LLAVA),
                  (4, 2944, "f32", False, LLAVA),
                  (1, 16, "bf16", False, LLAVA)]
# K6 at (64, 5), hymba's ring of 1,024 (split over 4 blocks): serve-hymba's
# step (4 slots) and its harvest (8 rows), rows wrapped at several
# positions and one not yet full ("ring"), f32 (serve-hymba-f32), a short
# cache.  At (64, 1), whisper's: the cross-attention over all 1,500 frames
# ("full", split over 6 blocks) at 4 slots and the harvest's 24 rows, the
# self cache (serve-whisper's 96 positions, the harvest's 16 + 96), f32
K6_FAMILY_CASES = [(4, HYMBA_WINDOW, "bf16", True, HYMBA, "ring"),
                   (8, HYMBA_WINDOW, "bf16", True, HYMBA, "ring"),
                   (4, HYMBA_WINDOW, "f32", False, HYMBA, "ring"),
                   (1, 16, "bf16", False, HYMBA),
                   (4, WHISPER_FRAMES, "bf16", True, WHISPER, "full"),
                   (24, WHISPER_FRAMES, "bf16", True, WHISPER, "full"),
                   (4, 96, "bf16", True, WHISPER),
                   (24, 112, "bf16", True, WHISPER),
                   (4, WHISPER_FRAMES, "f32", False, WHISPER, "full"),
                   (4, 96, "f32", False, WHISPER)]


def dense_case(torch, gen, B, S, dtype, H=15, KV=5, d=64, mask=None):
    """A dense cache with row 0 fully valid, ragged tails, and for B > 2 a
    sliding-window band (row 1) and a row with no valid position (row
    2).  ``mask="full"``: every position valid (cross-attention over the
    frames); ``mask="ring"``: a ring of S positions (``decode_valid_mask``
    with window S) at positions past it, wrapped, and row 1 short of
    full."""
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    q = torch.randn(B, H, d, generator=gen).to(dt).to(DEV)
    k = torch.randn(B, KV, S, d, generator=gen).to(dt).to(DEV)
    v = torch.randn(B, KV, S, d, generator=gen).to(dt).to(DEV)
    if mask == "full":
        return q, k, v, torch.ones((B, S), dtype=torch.bool, device=DEV)
    if mask == "ring":
        from repro_torch.models.attention import decode_valid_mask
        pos = S + torch.randint(0, 3 * S, (B,), generator=gen)
        pos[0] = S + 104                      # serve-hymba's first step
        if B > 1:
            pos[1] = S // 2 + 17
        _, valid = decode_valid_mask(pos.to(torch.int32), B, S, S)
        return q, k, v, valid.to(DEV)
    lens = torch.randint(1, S + 1, (B,), generator=gen)
    lens[0] = S
    pos = torch.arange(S)[None, :]
    valid = pos < lens[:, None]
    if B > 2:
        valid[1] = (pos[0] >= S // 4) & (pos[0] < S // 4 + max(S // 3, 1))
        valid[2] = False
    return q, k, v, valid.to(DEV)


def phase_k6(torch, timer):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as K6
    from repro_torch.kernels import split as SP
    gen = torch.Generator().manual_seed(SEED + 6)
    rows = []
    for B, S, dtype, timed, *shape in (K6_CASES + K6_D128_CASES
                                       + K6_D80_CASES + K6_MOE_CASES
                                       + K6_LLAVA_CASES + K6_FAMILY_CASES):
        H, KV, d, layers = shape[0] if shape else SMOLLM
        mask = shape[1] if len(shape) > 1 else None
        q, k, v, valid = dense_case(torch, gen, B, S, dtype, H, KV, d, mask)
        o, l, m = K6.flash_decode(q, k, v, valid, return_partials=True)
        want = K6.flash_decode_plain(q, k, v, valid, return_partials=True)
        m_err, o_err = partial_errors((o, l, m), want, valid)
        empty = ~valid.any(1)
        if not (m_err <= K6_M_TOL and o_err <= K6_OUT_TOL * v_scale(v)):
            raise AssertionError(f"K6 {B}x{S} {dtype} d {d} G {H // KV}: "
                                 f"m err {m_err}, output err {o_err}")
        if empty.any() and not (float(o[empty].abs().max()) == 0.0
                                and float(l[empty].abs().max()) == 0.0
                                and bool((m[empty] == -1e30).all())):
            raise AssertionError(f"K6 {B}x{S} {dtype}: an empty row is not "
                                 "(o, l, m) = (0, 0, -1e30)")
        # the normalised output as well (B7's function), in q's dtype
        out = K6.flash_decode(q, k, v, valid)
        pout = K6.flash_decode_plain(q, k, v, valid)
        live = valid.any(1)
        n_err = float((out.float() - pout.float())[live].abs().max())
        if n_err > (K6_OUT_TOL * v_scale(v)
                    + (2.0 ** -7 if dtype == "bf16" else 0.0)):
            raise AssertionError(f"K6 {B}x{S} {dtype}: normalised output "
                                 f"err {n_err}")
        n_split = SP.split_count(S, SP.DECODE_MAX_SPLITS)
        row = dict(B=B, S=S, cache=dtype, H=H, KV=KV, d=d, mask=mask,
                   valid_positions=int(valid.sum()),
                   empty_rows=int(empty.sum()), splits=n_split,
                   merge=n_split > 1, m_err=m_err, out_err=o_err,
                   normalised_err=n_err)
        if timed:
            row["ms"] = timer(lambda: K6.flash_decode(
                q, k, v, valid, return_partials=True))
            row["plain_ms"] = timer(lambda: K6.flash_decode_plain(
                q, k, v, valid, return_partials=True))
            # yardstick: SDPA over the same cache and mask, KV heads
            # repeated to the query heads (outside the timing)
            kr = k.repeat_interleave(H // KV, dim=1)
            vr = v.repeat_interleave(H // KV, dim=1)
            mask = valid[:, None, None, :]
            row["library_ms"] = timer(lambda: F.scaled_dot_product_attention(
                q[:, :, None, :], kr, vr, attn_mask=mask))
            # bytes this data needs: K and V of the valid positions, q,
            # valid, and the (o, l, m) written
            n_valid = row["valid_positions"]
            moved = (n_valid * KV * d * k.element_size() * 2
                     + nbytes(q, valid, o, l, m))
            row["bound_ms"], row["bound_by"] = bound_ms(
                moved, n_valid * H * (4 * d + 4))
            row["bytes"] = moved
            # the kernel's share of one decode step, a launch a layer
            row["layers"] = layers
            row["per_step_ms"] = layers * row["ms"]
            if (B, S, d, H) == (8, 4096, 64, SMOLLM[0]):
                from repro_torch.kernels import _build
                p = _build.ptr
                qg = q.reshape(B, KV, H // KV, d)
                split_sweep(torch, timer, "k6", lambda n, parts: (
                    _build.library().flash_decode_launch(
                        p(qg), p(k), p(v), p(valid), p(o), p(l), p(m),
                        *parts, B, KV, H // KV, d, S, n,
                        K6._DTYPE_CODE[k.dtype], float(1.0 / d ** 0.5),
                        _build.stream_of(q))), (o, l, m), S)
        emit(dict(phase="k6", **row))
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phase k7: flash prefill attention (B8)

# f32: another summation order than the einsum (online softmax over 64-key
# tiles), 2e-5 of max(1, max|v|); bf16 inputs: the same f32 values, then
# the bf16 cast of the output, which may land one bf16 ulp (2^-7 of the
# value) apart
K7_F32_TOL = 2e-5
K7_BF16_RTOL = 2.0 ** -7
# (B, Sq, Sk, window, dtype, timed): the harvest's and an admission's
# prefill (16 tokens), the chunked fleets' 160-token prompts, a long
# prompt; f32 (phase model's float32 model); a window of 64, Sq < Sk, and
# a window past the keys (rows 23 on see no key)
K7_CASES = [(1, 16, 16, None, "bf16", True), (24, 16, 16, None, "bf16", True),
            (1, 160, 160, None, "bf16", True),
            (24, 160, 160, None, "bf16", True),
            (4, 2048, 2048, None, "bf16", True),
            (24, 16, 16, None, "f32", True),
            (24, 160, 160, None, "f32", True),
            (24, 160, 160, 64, "bf16", False),
            (4, 2048, 2048, 64, "f32", False),
            (4, 64, 160, None, "bf16", False),
            (1, 48, 16, 8, "f32", False)]


# K7 at d 128: an admission's prefill (1, 16) and the harvest's (8, 16) of
# serve-llama, serve-qwen's harvest prefill (8 prompts of 160), long
# prompts at both groups, f32 (serve-llama-f32), a window, Sq < Sk and a
# window past the keys
K7_D128_CASES = [(1, 16, 16, None, "bf16", True, LLAMA),
                 (8, 16, 16, None, "bf16", True, LLAMA),
                 (8, 160, 160, None, "bf16", True, QWEN),
                 (1, 160, 160, None, "bf16", True, QWEN),
                 (4, 2048, 2048, None, "bf16", True, LLAMA),
                 (1, 2048, 2048, None, "bf16", True, QWEN),
                 (8, 16, 16, None, "f32", True, LLAMA),
                 (1, 160, 160, None, "f32", False, QWEN),
                 (4, 160, 160, 64, "bf16", False, QWEN),
                 (4, 64, 160, None, "bf16", False, LLAMA),
                 (1, 48, 16, 8, "f32", False, LLAMA)]
# K7 at d 80 (G 1): serve-stablelm's harvest prefill (8 prompts of 160),
# one prompt, an admission of 16, 2,048 tokens, f32 (the f32 kernel's
# lanes at d 80), a window, Sq < Sk, and a window past the keys in both
# dtypes
K7_D80_CASES = [(8, 160, 160, None, "bf16", True, STABLELM),
                (1, 160, 160, None, "bf16", True, STABLELM),
                (1, 16, 16, None, "bf16", True, STABLELM),
                (4, 2048, 2048, None, "bf16", True, STABLELM),
                (8, 160, 160, None, "f32", True, STABLELM),
                (4, 160, 160, 64, "bf16", False, STABLELM),
                (4, 64, 160, None, "bf16", False, STABLELM),
                (1, 48, 16, 8, "f32", False, STABLELM),
                (1, 48, 16, 8, "bf16", False, STABLELM)]


# K7 at the MoE fleets' groups (its instance is d's alone): serve-granite's
# and serve-phi's harvest prefill (8 prompts of 160), an admission of 16,
# Sq < Sk, a window past the keys in f32
K7_MOE_CASES = [(8, 160, 160, None, "bf16", True, GRANITE),
                (8, 160, 160, None, "bf16", True, PHI),
                (1, 16, 16, None, "bf16", False, PHI),
                (4, 64, 160, None, "bf16", False, GRANITE),
                (1, 48, 16, 8, "f32", False, PHI)]
# K7 at llava-next-34b's G 7: an image request's admission prefill (the
# 2,880 patches and 16 tokens, 56 heads), the harvest's batch of 4 such,
# the same admission in f32 (serve-llava-f32), Sq < Sk, a window past the
# keys
K7_LLAVA_CASES = [(1, 2896, 2896, None, "bf16", True, LLAVA),
                  (4, 2896, 2896, None, "bf16", True, LLAVA),
                  (1, 2896, 2896, None, "f32", True, LLAVA),
                  (4, 64, 160, None, "bf16", False, LLAVA),
                  (1, 48, 16, 8, "f32", False, LLAVA)]
# K7 at hymba's G 5, causal with its window of 1,024, which masks past
# 1,024 rows: an admission's prefill (128 meta tokens and 1,000 of
# prompt), the harvest's 8 such, f32 (serve-hymba-f32), 2,100 rows (two
# windows).  Non-causal (the 8th field False) at whisper's G 1: the
# encoder over 1,500 frames for an admission and the harvest's 24, f32,
# Sq < Sk and Sq > Sk
K7_FAMILY_CASES = [(1, 1128, 1128, HYMBA_WINDOW, "bf16", True, HYMBA),
                   (8, 1128, 1128, HYMBA_WINDOW, "bf16", True, HYMBA),
                   (1, 1128, 1128, HYMBA_WINDOW, "f32", True, HYMBA),
                   (2, 2100, 2100, HYMBA_WINDOW, "bf16", False, HYMBA),
                   (1, WHISPER_FRAMES, WHISPER_FRAMES, None, "bf16", True,
                    WHISPER, False),
                   (24, WHISPER_FRAMES, WHISPER_FRAMES, None, "bf16", True,
                    WHISPER, False),
                   (1, WHISPER_FRAMES, WHISPER_FRAMES, None, "f32", True,
                    WHISPER, False),
                   (2, 100, WHISPER_FRAMES, None, "bf16", False, WHISPER,
                    False),
                   (1, 64, 16, None, "f32", False, WHISPER, False)]


def visible_pairs(sq, sk, window, causal=True):
    """(query, key) pairs the causal / window mask leaves, per head."""
    if not causal:
        return sq * sk
    n = 0
    for i in range(sq):
        hi = min(i, sk - 1)
        lo = max(0, i - window + 1) if window else 0
        n += max(0, hi - lo + 1)
    return n


def k7_error(out, want, v):
    """Largest |kernel - plain|, and whether it is within K7's tolerance
    (f32: K7_F32_TOL of the value scale; bf16: that plus one ulp of the
    plain value)."""
    diff = (out.float() - want.float()).abs()
    lim = K7_F32_TOL * v_scale(v)
    if out.dtype.itemsize == 2:                     # bf16
        lim = K7_BF16_RTOL * want.float().abs() + lim
    return float(diff.max()), bool((diff <= lim).all())


def phase_k7(torch, timer):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as K7
    gen = torch.Generator().manual_seed(SEED + 7)
    rows = []
    for B, sq, sk, window, dtype, timed, *shape in (K7_CASES + K7_D128_CASES
                                                    + K7_D80_CASES
                                                    + K7_MOE_CASES
                                                    + K7_LLAVA_CASES
                                                    + K7_FAMILY_CASES):
        H, KV, d, _ = shape[0] if shape else SMOLLM
        causal = shape[1] if len(shape) > 1 else True
        dt = torch.bfloat16 if dtype == "bf16" else torch.float32
        q = torch.randn(B, sq, H, d, generator=gen).to(dt).to(DEV)
        k = torch.randn(B, sk, KV, d, generator=gen).to(dt).to(DEV)
        v = torch.randn(B, sk, KV, d, generator=gen).to(dt).to(DEV)
        out = K7.flash_attention(q, k, v, causal=causal, window=window)
        want = K7.attn_prefill_einsum(q, k, v, causal=causal, window=window)
        err, ok = k7_error(out, want, v)
        if not ok or not torch.isfinite(out.float()).all():
            raise AssertionError(f"K7 {B}x{sq}x{sk} causal {causal} window "
                                 f"{window} {dtype} d {d} G {H // KV}: err "
                                 f"{err}")
        row = dict(B=B, Sq=sq, Sk=sk, window=window, causal=causal,
                   dtype=dtype, H=H, KV=KV, d=d, max_abs_err=err)
        if timed:
            row["ms"] = timer(lambda: K7.flash_attention(
                q, k, v, causal=causal, window=window))
            row["plain_ms"] = timer(lambda: K7.attn_prefill_einsum(
                q, k, v, causal=causal, window=window))
            # yardstick: SDPA on (B, H, S, d), KV heads repeated, with
            # is_causal, or the window's boolean mask, or none
            # (bidirectional); built outside the timing
            qt = q.transpose(1, 2).contiguous()
            kt = k.transpose(1, 2).repeat_interleave(H // KV, 1).contiguous()
            vt = v.transpose(1, 2).repeat_interleave(H // KV, 1).contiguous()
            sdpa = dict(is_causal=causal)
            if window is not None:
                qp = torch.arange(sq, device=DEV)[:, None]
                kp = torch.arange(sk, device=DEV)[None, :]
                sdpa = dict(attn_mask=(kp <= qp) & (kp > qp - window))
            row["library_ms"] = timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, **sdpa))
            pairs = visible_pairs(sq, sk, window, causal)
            moved = nbytes(q, k, v, out)
            row["bound_ms"], row["bound_by"] = bound_ms(
                moved, B * H * pairs * (4 * d + 4))
            row["bound_tc_ms"], row["bound_tc_by"] = bound_tc_ms(
                moved, B * H * pairs * 4 * d, B * H * pairs * 4)
            row["bytes"] = moved
            row["visible_pairs_per_head"] = pairs
        emit(dict(phase="k7", **row))
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phase model: full-width model, teacher-forced

def _positions_reversed(K2):
    """The plain paged attention with each row's positions in reverse
    order (its pages reversed, and the slots within each page): the same
    softmax over the same positions, summed in another order from the
    first step on, also while the prompt fits in one page."""
    def flip(t):
        return None if t is None else t.flip(2)

    def fn(q, k, v, tables, valid, ks=None, vs=None, *,
           return_partials=False):
        return K2.paged_decode_plain(q, flip(k), flip(v), tables.flip(1),
                                     valid.flip(1), flip(ks), flip(vs),
                                     return_partials=return_partials)
    return fn


def paged_decode_exact(q, k, v, tables, valid, ks=None, vs=None):
    """The plain version's formula in float64 on the same inputs: the
    partials (o, l, m) of K2 without rounding."""
    import torch
    bt = tables.long()

    def cache(pages, scales):
        x = pages[bt].double()                  # (B, nb, KV, bs, d)
        if scales is not None:
            x = x * scales[bt].double()
        b, nb, kv, bs, d = x.shape
        return x.permute(0, 2, 1, 3, 4).reshape(b, kv, nb * bs, d)

    kc, vc = cache(k, ks), cache(v, vs)
    b, h, d = q.shape
    qg = q.double().reshape(b, kc.shape[1], h // kc.shape[1], d)
    masked = ~valid[:, None, None, :]
    s = (torch.einsum("bkrd,bksd->bkrs", qg, kc) / math.sqrt(d)).masked_fill(
        masked, -math.inf)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None]).masked_fill(masked, 0.0)
    return torch.einsum("bkrs,bksd->bkrd", p, vc), p.sum(-1), m


class CheckedK2:
    """K2 on the inputs the model gives it, each call held with phase k2's
    tolerances (m relative to max(1, |m|)) against the plain version's
    formula evaluated in float64 on the same inputs: a dropped page or a
    wrong scale fails on the call that makes it.  The exact reference and
    not the float32 plain version, because at the d-128 models' scores
    (up to about 600 with random weights) the plain version's own f32
    rounding reaches 2.3e-3 of llama3.2-3b's output, K2's 5.8e-4; its
    distance to the plain version is kept as ``plain_out_err``."""

    def __init__(self, K2):
        self.K2 = K2
        self.calls, self.m_err, self.out_err = 0, 0.0, 0.0
        self.plain_out_err = 0.0

    def __call__(self, q, k, v, tables, valid, ks=None, vs=None, *,
                 return_partials=False):
        assert return_partials, "the model folds in the current token"
        got = self.K2.paged_flash_decode(q, k, v, tables, valid, ks, vs,
                                         return_partials=True)
        want = paged_decode_exact(q, k, v, tables, valid, ks, vs)
        m_err, o_err = partial_errors(got, want, valid, m_relative=True)
        if not (m_err <= K2_M_TOL and o_err <= K2_OUT_TOL):
            raise AssertionError(f"K2 in the model, call {self.calls}: "
                                 f"relative m err {m_err}, output err "
                                 f"{o_err}")
        plain = self.K2.paged_decode_plain(q, k, v, tables, valid, ks, vs,
                                           return_partials=True)
        self.calls += 1
        self.m_err = max(self.m_err, m_err)
        self.out_err = max(self.out_err, o_err)
        self.plain_out_err = max(self.plain_out_err,
                                 partial_errors(got, plain, valid)[1])
        return got


def prefix_of(cfg, extra) -> int:
    """Positions a prefill puts in front of the prompt: a VLM's patches
    when ``extra`` carries them."""
    return (cfg.frontend.n_tokens if extra and "patch_embeds" in extra
            else 0)


def teacher_forced(torch, model, params, prompt, feed, impls, bs=16,
                   route=None, extra=None):
    """Prefill, copy the prompt K/V into one page pool per paged attention
    implementation, then decode the same fed tokens through each (the
    model's ``paged_flash_decode`` swapped for it).  ``impls`` holds
    (paged decode, prefill attention) pairs; a prefill attention of None
    is the served one (K7 on the card), any other is swapped in for the
    prefill of its pool.  ``route`` (a ``ForcedRouting``) is told which
    pair and pass each model call belongs to.  ``extra``: the prefill's
    other inputs (a VLM's ``patch_embeds``), whose prefix the decode
    resumes after.  Returns the max |logit - logit of impls[0]| per step
    for each other pair, and the largest |logit|."""
    from repro_torch.models import attention as A
    cfg = model.cfg
    B = prompt.shape[0]
    S = prompt.shape[1] + prefix_of(cfg, extra)
    steps = feed.shape[0]
    nb = -(-(S + steps) // bs)
    served_prefill = A.flash_attention
    prefilled = {}
    try:
        for i, (_, pre_impl) in enumerate(impls):
            if pre_impl not in prefilled:
                if route is not None:
                    route.select(i, "prefill")
                A.flash_attention = pre_impl or served_prefill
                prefilled[pre_impl], _, _ = model.prefill(
                    cfg, params, {"tokens": prompt, **(extra or {})},
                    nb * bs)
    finally:
        A.flash_attention = served_prefill
    table = (1 + torch.arange(B * nb)).reshape(B, nb).to(torch.int32).to(DEV)
    states = []
    for _, pre_impl in impls:
        pre = prefilled[pre_impl]
        st = model.init_paged_state(B, B * nb + 1, bs, nb, device=DEV)
        pages = {k: v for k, v in st.items() if k != "block_tables"}
        for i in range(B):
            A.prefill_to_pages(pages, {k: v[:, i:i + 1] for k, v in
                                       pre.items()}, table[i], -(-S // bs))
        st["block_tables"].copy_(table)
        states.append(st)
    diffs = [[] for _ in impls[1:]]
    scale = 0.0
    served = A.paged_flash_decode
    try:
        for t in range(steps):
            pos = torch.full((B,), S + t, dtype=torch.int32, device=DEV)
            logits = []
            for i, ((impl, _), st) in enumerate(zip(impls, states)):
                A.paged_flash_decode = impl
                if route is not None:
                    route.select(i, t)
                lg, _, _ = model.decode_step(cfg, params, feed[t], st, pos)
                lg = lg[:, :cfg.vocab_size].float()
                if not torch.isfinite(lg).all():
                    raise AssertionError(f"non-finite logits at step {t}")
                logits.append(lg)
            scale = max(scale, float(logits[0].abs().max()))
            for d, lg in zip(diffs, logits[1:]):
                d.append(float((lg - logits[0]).abs().max()))
    finally:
        A.paged_flash_decode = served
    return diffs, scale


class CheckedK6:
    """K6 on the inputs the model gives it, each call held against the
    plain version on the same inputs with phase k6's tolerances (m relative
    to max(1, |m|), the model's scores reach tens)."""

    def __init__(self, K6):
        self.K6 = K6
        self.calls, self.m_err, self.out_err = 0, 0.0, 0.0

    def __call__(self, q, k, v, valid, *, return_partials=False):
        assert return_partials, "the model folds in the current token"
        got = self.K6.flash_decode(q, k, v, valid, return_partials=True)
        want = self.K6.flash_decode_plain(q, k, v, valid,
                                          return_partials=True)
        m_err, o_err = partial_errors(got, want, valid, m_relative=True)
        if not (m_err <= K6_M_TOL and o_err <= K6_OUT_TOL * v_scale(v)):
            raise AssertionError(f"K6 in the model, call {self.calls}: "
                                 f"relative m err {m_err}, output err "
                                 f"{o_err}")
        self.calls += 1
        self.m_err = max(self.m_err, m_err)
        self.out_err = max(self.out_err, o_err)
        return got


def prefill_exact(q, k, v, causal=True, window=None):
    """The plain version's formula (``attn_prefill_einsum``) in float64,
    one KV head at a time (llava-next-34b's admission of 2,896 rows would
    take 3.8 GB of float64 scores a tensor at once)."""
    import torch
    b, sq, h, d = q.shape
    n_kv = k.shape[2]
    qg = q.double().reshape(b, sq, n_kv, h // n_kv, d)
    qpos = torch.arange(sq, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    out = torch.empty_like(qg)
    for j in range(n_kv):
        s = torch.einsum("bqgd,bsd->bgqs", qg[:, :, j],
                         k[:, :, j].double()) / d ** 0.5
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out[:, :, j] = torch.einsum("bgqs,bsd->bqgd", p, v[:, :, j].double())
    return out.reshape(b, sq, h, d)


class CheckedK7:
    """K7 on the inputs the model gives it, each call held against the
    plain version on the same inputs with phase k7's tolerances.  With
    ``exact`` (float32 inputs whose scores run to hundreds, where the plain
    version's own rounding passes those tolerances) each call is held
    instead to the plain formula in float64: K7 within twice the plain
    version's distance from it plus phase k7's f32 tolerance."""

    def __init__(self, K7, exact: bool = False):
        self.K7, self.exact = K7, exact
        self.calls, self.err = 0, 0.0
        self.exact_err, self.plain_exact_err = 0.0, 0.0

    def __call__(self, q, k, v, *, causal=True, window=None):
        got = self.K7.flash_attention(q, k, v, causal=causal, window=window)
        want = self.K7.attn_prefill_einsum(q, k, v, causal=causal,
                                             window=window)
        err, ok = k7_error(got, want, v)
        if self.exact:
            ex = prefill_exact(q, k, v, causal, window)
            e_k = float((got.double() - ex).abs().max())
            e_p = float((want.double() - ex).abs().max())
            ok = e_k <= 2 * e_p + K7_F32_TOL * v_scale(v)
            self.exact_err = max(self.exact_err, e_k)
            self.plain_exact_err = max(self.plain_exact_err, e_p)
            err_text = f"{e_k} from float64 (plain version {e_p})"
        else:
            err_text = str(err)
        if not ok:
            raise AssertionError(f"K7 in the model, call {self.calls}: err "
                                 f"{err_text}")
        self.calls += 1
        self.err = max(self.err, err)
        return got


def dense_teacher_forced(torch, model, params, prompt, feed, impls,
                         route=None, extra=None):
    """Prefill the prompt into a dense cache and decode the same fed
    tokens, once per (decode, prefill) attention pair in ``impls`` (the
    model's ``flash_decode`` and ``flash_attention`` swapped for it);
    ``route`` and ``extra`` as in ``teacher_forced``.  Returns each pair's
    logits per step."""
    from repro_torch.models import attention as A
    cfg = model.cfg
    B = prompt.shape[0]
    S = prompt.shape[1] + prefix_of(cfg, extra)
    served = A.flash_decode, A.flash_attention
    runs = []
    try:
        for i, (dec, pre) in enumerate(impls):
            A.flash_decode, A.flash_attention = dec, pre
            if route is not None:
                route.select(i, "prefill")
            cache, _, _ = model.prefill(cfg, params,
                                        {"tokens": prompt, **(extra or {})},
                                        S + feed.shape[0])
            logits = []
            for t in range(feed.shape[0]):
                pos = torch.full((B,), S + t, dtype=torch.int32, device=DEV)
                if route is not None:
                    route.select(i, t)
                lg, _, _ = model.decode_step(cfg, params, feed[t], cache, pos)
                lg = lg[:, :cfg.vocab_size].float()
                if not torch.isfinite(lg).all():
                    raise AssertionError(f"dense: non-finite logits at step "
                                         f"{t}")
                logits.append(lg)
            runs.append(logits)
    finally:
        A.flash_decode, A.flash_attention = served
    return runs


def dense_path(torch, model, params, prompt, feed, exact_argmax,
               keep=None, route=None, k7_exact=False, extra=None):
    """The dense path of one model: K7's prefill and K6's decode steps,
    every call checked, against the plain versions.  With
    ``exact_argmax`` (f32) every step's argmax must equal the plain
    path's and the logits sit within 2^-10 of the largest.  ``keep``, a
    list, receives the plain path's logits of every step; ``route`` and
    ``extra`` as in ``teacher_forced``; ``k7_exact``: K7 held to float64
    (``CheckedK7``)."""
    from repro_torch.kernels import flash_attention as K7
    from repro_torch.kernels import flash_decode as K6
    k6, k7 = CheckedK6(K6), CheckedK7(K7, exact=k7_exact)
    kern, plain = dense_teacher_forced(
        torch, model, params, prompt, feed,
        [(k6, k7), (K6.flash_decode_plain, K7.attn_prefill_einsum)],
        route=route, extra=extra)
    if keep is not None:
        keep.extend(plain)
    diffs = [float((a - b).abs().max()) for a, b in zip(kern, plain)]
    agree = [float((a.argmax(-1) == b.argmax(-1)).float().mean())
             for a, b in zip(kern, plain)]
    scale = max(float(b.abs().max()) for b in plain)
    res = dict(k6_calls=k6.calls, k6_m_rel_err=k6.m_err,
               k6_out_err=k6.out_err, k7_calls=k7.calls, k7_err=k7.err,
               **(dict(k7_exact_err=k7.exact_err,
                       k7_plain_exact_err=k7.plain_exact_err)
                  if k7_exact else {}),
               max_logit_diff_per_step=diffs, argmax_agree_per_step=agree,
               max_abs_logit=scale)
    if exact_argmax:
        res["bound"] = scale * 2.0 ** -10
        if min(agree) < 1.0:
            raise AssertionError(f"dense f32: argmax differs from the plain "
                                 f"path at step {agree.index(min(agree))}")
        if max(diffs) > res["bound"]:
            raise AssertionError(f"dense f32: logits {max(diffs)} from the "
                                 f"plain path > {res['bound']}")
    return res


def paged_within_floor(torch, model, params, prompt, feed, extra=None):
    """The bf16 paged decode of phase model: the prompt prefilled and the
    fed tokens decoded through K2 (every call held against the plain
    version's formula in float64 on its own inputs, ``CheckedK2``) and
    through the plain paged
    attention, the logits of K2 held to a floor measured in the same run
    (below); ``extra`` as in ``teacher_forced``.  Returns the record of
    it."""
    from repro_torch.kernels import flash_attention as K7
    from repro_torch.kernels import paged_decode as K2
    plain = K2.paged_decode_plain
    checked = CheckedK2(K2)
    (k2, rev, pre_spread), scale = teacher_forced(
        torch, model, params, prompt, feed,
        [(plain, None), (checked, None), (_positions_reversed(K2), None),
         (plain, K7.attn_prefill_einsum)], extra=extra)
    # bf16 logits: K2, the position-reversed plain version and the prompt
    # prefilled through the einsum in place of K7 all compute the same
    # functions with their f32 sums in another order.  The bf16 cast of
    # each attention output turns such a reordering into one-ulp flips,
    # which a random-weight stack amplifies on the way to the logits.  The
    # floor at step t is the larger difference the two reference
    # reorderings show there; the logits of K2 are held to 8x the largest
    # floor up to step t, plus one bf16 ulp of the largest logit.  The
    # prefill's reordering gives the floor a value from step 0, where
    # reversing the positions of a prompt in one page can flip nothing.
    # The kernel itself is held per call by CheckedK2 above.
    steps = feed.shape[0]
    floor = [max(a, b) for a, b in zip(rev, pre_spread)]
    ulp = scale * 2.0 ** -8
    bound = [8 * max(floor[:t + 1]) + ulp for t in range(steps)]
    over = [t for t in range(steps) if k2[t] > bound[t]]
    if over:
        t = over[0]
        raise AssertionError(f"{model.cfg.name} bf16 step {t}: K2 vs plain "
                             f"paged logits {k2[t]} > {bound[t]} "
                             f"(reordering spread {max(floor[:t + 1])})")
    return dict(k2_calls=checked.calls, k2_m_rel_err=checked.m_err,
                k2_out_err=checked.out_err,
                k2_plain_out_err=checked.plain_out_err,
                max_logit_diff_per_step=k2,
                reversed_plain_diff_per_step=rev,
                einsum_prefill_diff_per_step=pre_spread,
                max_abs_logit=scale, bound_per_step=bound)


def phase_model(torch, reduced: bool = False):
    """Full-width smollm-360m, teacher-forced: K2 against the plain paged
    attention, in bf16 (as served) and with the same weights in float32.
    Every K2 call is also held against the plain version's formula in
    float64 on its own inputs (``CheckedK2``).  Then the dense path: the prompt through K7,
    the fed tokens through K6 on a dense cache, every call checked, against
    the plain versions (``dense_path``)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_decode as K2
    from repro_torch.models import build
    cfg = get_config("smollm-360m")
    if reduced:
        cfg = cfg.reduced()
    model = build(cfg)
    gen = torch.Generator().manual_seed(SEED)
    params = model.init(gen, DEV)
    n_params = sum(t.numel() for t in _leaves(params))
    B, S, steps = 4, 16, 16
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           dtype=torch.int32).to(DEV)
    feed = torch.randint(0, cfg.vocab_size, (steps, B), generator=gen,
                         dtype=torch.int32).to(DEV)
    bf16 = paged_within_floor(torch, model, params, prompt, feed)
    # float32, the same weights: no bf16 cast between layers, so the two
    # orders differ by f32 rounding (~1e-7) times the same amplification
    # (~20x, from 2^-8 to ~8% in bf16); 2^-10 of the largest logit leaves
    # two orders of magnitude of room
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                kv_cache_dtype="float32")
    params32 = _tree(params, lambda t: t.float())
    checked32 = CheckedK2(K2)
    (k2_32,), scale32 = teacher_forced(torch, build(cfg32), params32,
                                       prompt, feed,
                                       [(K2.paged_decode_plain, None),
                                        (checked32, None)])
    bound32 = scale32 * 2.0 ** -10
    if max(k2_32) > bound32:
        raise AssertionError(f"f32: K2 vs plain paged logits {max(k2_32)} "
                             f"> {bound32}")
    dense = dense_path(torch, model, params, prompt, feed, False)
    dense32 = dense_path(torch, build(cfg32), params32, prompt, feed, True)
    res = dict(phase="model", arch=cfg.name, layers=cfg.n_layers,
               d_model=cfg.d_model, heads=cfg.n_heads,
               kv_heads=cfg.n_kv_heads, d_head=cfg.d_head, d_ff=cfg.d_ff,
               vocab=cfg.vocab_size, params=n_params, dtype=cfg.dtype,
               batch=B, prompt=S, decode_steps=steps, bf16=bf16,
               f32=dict(k2_calls=checked32.calls,
                        k2_m_rel_err=checked32.m_err,
                        k2_out_err=checked32.out_err,
                       k2_plain_out_err=checked32.plain_out_err,
                        max_logit_diff_per_step=k2_32,
                        max_abs_logit=scale32, bound=bound32),
               dense=dict(bf16=dense, f32=dense32))
    emit(res)
    return res


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# phase model-chunked: full-width model, chunked and packed prefill

class CheckedK3:
    """One K3 entry point (B3 or B4) on the inputs the model gives it, each
    call held against its plain version on the same inputs with phase k3's
    tolerances (m relative to max(1, |m|), the model's scores reach tens).
    Returns the kernel's partials."""

    def __init__(self, kernel, plain):
        self.kernel, self.plain = kernel, plain
        self.calls, self.m_err, self.out_err = 0, 0.0, 0.0

    def __call__(self, *args):
        got = self.kernel(*args)
        m_err, o_err = chunk_partial_errors(got, self.plain(*args),
                                            m_relative=True)
        if not (m_err <= K3_M_TOL and o_err <= K3_OUT_TOL):
            raise AssertionError(f"K3 in the model, call {self.calls}: "
                                 f"relative m err {m_err}, output err "
                                 f"{o_err}")
        self.calls += 1
        self.m_err = max(self.m_err, m_err)
        self.out_err = max(self.out_err, o_err)
        return got


CHUNK, BS = 64, 16


def prefill_three(torch, model, params, prompts, impls):
    """Three requests into one page pool: A through ``Model.prefill_chunk``
    in 64-token chunks (B3); B's first 64 tokens through a one-segment
    ``prefill_packed`` chunk, then B's remaining tokens packed with all of
    C in one chunk (B4).  ``impls`` (B3, B4) replace the model's K3 entry
    points for the run; None prefills each request in one shot instead.
    Returns the state, with every row's block table set."""
    from repro_torch.models import attention as A
    cfg = model.cfg
    lens = [len(p) for p in prompts]
    nb = -(-(max(lens) + 1) // BS)
    table = (1 + torch.arange(3 * nb)).reshape(3, nb).to(torch.int32).to(DEV)
    st = model.init_paged_state(3, 3 * nb + 1, BS, nb, device=DEV)
    pages = {k: v for k, v in st.items() if k != "block_tables"}
    if impls is None:
        for i, p in enumerate(prompts):
            n = -(-len(p) // BS)
            pre, _, _ = model.prefill(cfg, params, {"tokens": p[None]}, n * BS)
            A.prefill_to_pages(pages, pre, table[i], n)
    else:
        served = A.paged_flash_prefill_chunk, A.paged_flash_packed_chunk
        A.paged_flash_prefill_chunk, A.paged_flash_packed_chunk = impls
        try:
            a, b, c = prompts
            zero = torch.zeros(1, dtype=torch.long, device=DEV)
            for start in range(0, len(a), CHUNK):
                n = min(CHUNK, len(a) - start)
                buf = torch.zeros(1, CHUNK, dtype=torch.int32, device=DEV)
                buf[0, :n] = a[start:start + n]
                model.prefill_chunk(cfg, params, buf, st, zero, start, n,
                                    block_rows=table[0:1])
            i32 = dict(dtype=torch.int32, device=DEV)
            slots = torch.tensor([1, 2], **i32)
            model.prefill_packed(cfg, params, b[:CHUNK], st,
                                 torch.zeros(CHUNK, **i32), slots,
                                 torch.tensor([0, 0], **i32),
                                 torch.tensor([CHUNK, 0], **i32),
                                 table[1:3])
            tail = len(b) - CHUNK
            assert tail + len(c) == CHUNK, "B's tail and C fill one chunk"
            model.prefill_packed(cfg, params, torch.cat([b[CHUNK:], c]), st,
                                 torch.tensor([0] * tail + [1] * len(c),
                                              **i32), slots,
                                 torch.tensor([CHUNK, 0], **i32),
                                 torch.tensor([tail, len(c)], **i32),
                                 table[1:3])
        finally:
            A.paged_flash_prefill_chunk, A.paged_flash_packed_chunk = served
    st["block_tables"].copy_(table)
    return st, table


def prompt_pages(torch, state, table, lens):
    """Each request's prompt K/V read back from the pool, concatenated:
    (L, KV, sum(lens), dh) f32 for "k" and "v"."""
    out = {}
    for key in ("k", "v"):
        parts = []
        for i, n in enumerate(lens):
            pg = state[key][:, table[i].long()]      # (L, nb, KV, bs, dh)
            L, nb, kv, bs, dh = pg.shape
            parts.append(pg.permute(0, 2, 1, 3, 4).reshape(
                L, kv, nb * bs, dh)[:, :, :n].float())
        out[key] = torch.cat(parts, dim=2)
    return out


def chunked_vs_one_shot(torch, model, params, prompts, feed):
    """Prefill the three requests one shot, chunked through K3 (every call
    checked) and chunked through K3's plain versions; then one decode step
    of the same fed token on each.  Returns the max page and next-step
    logit differences from one shot, of the K3 run and of the plain run,
    the scales, and the checked calls."""
    from repro_torch.kernels import paged_chunk as K3
    cfg = model.cfg
    lens = [len(p) for p in prompts]
    b3 = CheckedK3(K3.paged_flash_prefill_chunk, K3.paged_prefill_chunk_plain)
    b4 = CheckedK3(K3.paged_flash_packed_chunk, K3.paged_packed_chunk_plain)
    runs = {"one_shot": None, "k3": (b3, b4),
            "plain": (K3.paged_prefill_chunk_plain,
                      K3.paged_packed_chunk_plain)}
    pages, logits = {}, {}
    pos = torch.tensor(lens, dtype=torch.int32, device=DEV)
    for name, impls in runs.items():
        st, table = prefill_three(torch, model, params, prompts, impls)
        pages[name] = prompt_pages(torch, st, table, lens)
        lg, _, _ = model.decode_step(cfg, params, feed, st, pos)
        lg = lg[:, :cfg.vocab_size].float()
        if not torch.isfinite(lg).all():
            raise AssertionError(f"{name}: non-finite logits")
        logits[name] = lg
    res = {}
    for name in ("k3", "plain"):
        res[f"{name}_page_diff"] = max(
            float((pages[name][k] - pages["one_shot"][k]).abs().max())
            for k in ("k", "v"))
        res[f"{name}_logit_diff"] = float(
            (logits[name] - logits["one_shot"]).abs().max())
    res["page_scale"] = max(float(pages["one_shot"][k].abs().max())
                            for k in ("k", "v"))
    res["logit_scale"] = float(logits["one_shot"].abs().max())
    res.update(b3_calls=b3.calls, b4_calls=b4.calls,
               k3_m_rel_err=max(b3.m_err, b4.m_err),
               k3_out_err=max(b3.out_err, b4.out_err))
    return res


def phase_model_chunked(torch, reduced: bool = False):
    """Full-width smollm-360m: chunked and packed prefill through K3 held
    to one-shot prefill, in bf16 (as served) and with the same weights in
    float32."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build
    cfg = get_config("smollm-360m")
    if reduced:
        cfg = cfg.reduced()
    model = build(cfg)
    gen = torch.Generator().manual_seed(SEED + 4)
    params = model.init(gen, DEV)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                             dtype=torch.int32).to(DEV)
               for n in (160, 100, 28)]
    feed = torch.randint(0, cfg.vocab_size, (3,), generator=gen,
                         dtype=torch.int32).to(DEV)
    bf16 = chunked_vs_one_shot(torch, model, params, prompts, feed)
    # bf16: chunked prefill and one shot sum the same attention in another
    # order (online softmax over pages, then the chunk's own keys, against
    # one softmax), and every layer's bf16 cast turns that into one-ulp
    # flips the random-weight stack amplifies; K3 and its plain version are
    # two such orders.  So K3's distance from one shot is held to 8x the
    # plain version's own distance plus one bf16 ulp of the largest value,
    # as phase model holds K2 (the kernel itself is held per call above)
    for what in ("page", "logit"):
        bound = 8 * bf16[f"plain_{what}_diff"] + bf16[f"{what}_scale"] * 2**-8
        bf16[f"{what}_bound"] = bound
        if bf16[f"k3_{what}_diff"] > bound:
            raise AssertionError(f"bf16 chunked vs one-shot {what}s: "
                                 f"{bf16[f'k3_{what}_diff']} > {bound}")
    # float32, the same weights: no bf16 cast between layers, so the orders
    # differ by f32 rounding times the same amplification; 2^-10 of the
    # largest value, phase model's f32 bound
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                kv_cache_dtype="float32")
    f32 = chunked_vs_one_shot(torch, build(cfg32), _tree(params, lambda t:
                                                         t.float()),
                              prompts, feed)
    for what in ("page", "logit"):
        bound = f32[f"{what}_scale"] * 2**-10
        f32[f"{what}_bound"] = bound
        for run in ("k3", "plain"):
            if f32[f"{run}_{what}_diff"] > bound:
                raise AssertionError(f"f32 chunked ({run}) vs one-shot "
                                     f"{what}s: {f32[f'{run}_{what}_diff']}"
                                     f" > {bound}")
    res = dict(phase="model-chunked", arch=cfg.name, layers=cfg.n_layers,
               prompts=[len(p) for p in prompts], chunk=CHUNK, bf16=bf16,
               f32=f32)
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phase model-spec: the verify pass against sequential decode

def verify_vs_decode(torch, model, params, prompt, feed, bs=16):
    """Prefill once into two page pools; feed the same k tokens per slot
    through k sequential ``decode_step``s (K2) on one and through one
    ``verify_packed`` chunk (4 slots x k tokens, K3 held per call against
    its plain version) on the other.  Returns the largest logit, hidden and
    page differences, the scales, and the share of equal argmaxes."""
    from repro_torch.kernels import paged_chunk as K3
    from repro_torch.models import attention as A
    cfg = model.cfg
    B, S = prompt.shape
    k = feed.shape[0]
    nb = -(-(S + k) // bs)
    pre, _, _ = model.prefill(cfg, params, {"tokens": prompt}, nb * bs)
    table = (1 + torch.arange(B * nb)).reshape(B, nb).to(torch.int32).to(DEV)
    states = []
    for _ in range(2):
        st = model.init_paged_state(B, B * nb + 1, bs, nb, device=DEV)
        pages = {key: v for key, v in st.items() if key != "block_tables"}
        for i in range(B):
            A.prefill_to_pages(pages, {key: v[:, i:i + 1]
                                       for key, v in pre.items()},
                               table[i], -(-S // bs))
        st["block_tables"].copy_(table)
        states.append(st)
    dec_l, dec_h = [], []
    for t in range(k):
        pos = torch.full((B,), S + t, dtype=torch.int32, device=DEV)
        lg, h, _ = model.decode_step(cfg, params, feed[t], states[0], pos)
        dec_l.append(lg[:, :cfg.vocab_size].float())
        dec_h.append(h.float())
    dec_l, dec_h = torch.stack(dec_l, 1), torch.stack(dec_h, 1)
    i32 = dict(dtype=torch.int32, device=DEV)
    checked = CheckedK3(K3.paged_flash_packed_chunk,
                        K3.paged_packed_chunk_plain)
    served = A.paged_flash_packed_chunk
    A.paged_flash_packed_chunk = checked
    try:
        lg, h, _ = model.verify_packed(
            cfg, params, feed.T.reshape(-1).contiguous(), states[1],
            torch.arange(B, **i32).repeat_interleave(k), torch.arange(B, **i32),
            torch.full((B,), S, **i32), torch.full((B,), k, **i32),
            states[1]["block_tables"])
    finally:
        A.paged_flash_packed_chunk = served
    ver_l = lg[:, :cfg.vocab_size].float().reshape(B, k, -1)
    ver_h = h.float().reshape(B, k, -1)
    if not (torch.isfinite(ver_l).all() and torch.isfinite(dec_l).all()):
        raise AssertionError("non-finite logits")
    page_diff = 0.0
    for key in ("k", "v"):
        a, b = (st[key][:, table.long()].float() for st in states)
        page_diff = max(page_diff, float((a - b).abs().max()))
    return dict(max_logit_diff=float((ver_l - dec_l).abs().max()),
                max_hidden_diff=float((ver_h - dec_h).abs().max()),
                max_page_diff=page_diff,
                max_abs_logit=float(dec_l.abs().max()),
                argmax_equal_share=float((ver_l.argmax(-1)
                                          == dec_l.argmax(-1)).float()
                                         .mean()),
                k3_calls=checked.calls, k3_m_rel_err=checked.m_err,
                k3_out_err=checked.out_err)


def phase_model_spec(torch, reduced: bool = False):
    """Full-width smollm-360m, teacher-forced: ``verify_packed_chunk`` on 4
    slots x k = 4 against 4 sequential ``decode_step``s on paged KV, in
    bf16 (as served) and with the same weights in float32."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build
    cfg = get_config("smollm-360m")
    if reduced:
        cfg = cfg.reduced()
    model = build(cfg)
    gen = torch.Generator().manual_seed(SEED + 6)
    params = model.init(gen, DEV)
    B, S, k = 4, 16, 4
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           dtype=torch.int32).to(DEV)
    feed = torch.randint(0, cfg.vocab_size, (k, B), generator=gen,
                         dtype=torch.int32).to(DEV)
    bf16 = verify_vs_decode(torch, model, params, prompt, feed)
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                kv_cache_dtype="float32")
    f32 = verify_vs_decode(torch, build(cfg32),
                           _tree(params, lambda t: t.float()), prompt, feed)
    # float32: the verify pass and decode sum the same attention in
    # another order (K3 over pages then the block's own keys, against K2
    # with the current token folded in); phase model's f32 bound, 2^-10 of
    # the largest logit, and every argmax equal
    f32["bound"] = f32["max_abs_logit"] * 2.0 ** -10
    if f32["max_logit_diff"] > f32["bound"] \
            or f32["argmax_equal_share"] != 1.0:
        raise AssertionError(f"f32 verify vs decode: {f32}")
    res = dict(phase="model-spec", arch=cfg.name, layers=cfg.n_layers,
               batch=B, prompt=S, k=k, bf16=bf16, f32=f32)
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phases serve and serve-chunked: the driver on the card; trace and
# trace-chunked: its profiled windows

# engine steps of a profiled window, cut to keep the script within its
# time.  trace-chunked's 24 and trace-stablelm's and trace-qwen's
# CHUNKED_TRACE_STEPS hold their prompts' chunk steps and the decode after
# them: 4 prompts of 160 tokens take 9 chunked steps, so a window of 8
# holds chunk steps alone
TRACE_STEPS = 4
CHUNKED_TRACE_STEPS = 16

def kernel_counters():
    """Every kernel wrapper of the port, by name: each counts its launches."""
    from repro_torch.kernels import flash_attention as K7
    from repro_torch.kernels import flash_decode as K6
    from repro_torch.kernels import paged_chunk as K3
    from repro_torch.kernels import paged_decode as K2
    from repro_torch.kernels import probe_step as K1
    from repro_torch.kernels import probe_spec as K4
    from repro_torch.kernels import rwkv6_scan as K8
    from repro_torch.kernels import ttt_scan as K5
    return {"serving_probe_step": K1.serving_probe_step,
            "serving_probe_spec_step": K4.serving_probe_spec_step,
            "paged_flash_decode": K2.paged_flash_decode,
            "paged_flash_prefill_chunk": K3.paged_flash_prefill_chunk,
            "paged_flash_packed_chunk": K3.paged_flash_packed_chunk,
            "ttt_probe_batched": K5.ttt_probe_batched,
            "flash_decode": K6.flash_decode,
            "flash_attention": K7.flash_attention,
            "wkv_scan": K8.wkv_scan}


def zero_launches() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in kernel_counters().items()}


def serve_fleet(torch, extra_argv=(), *, phase, requests, need, paged=True,
                arch="smollm-360m", max_new=96, group_size=1,
                cancelled=False):
    """The serving driver end to end, on a paged fleet or (``paged=False``)
    a dense one; every kernel in ``need`` must have launched during it
    (counts zeroed just before, read just after).  ``group_size`` above 1
    serves each request as a group of that many samples
    (``--group-size``); every sample must end stopped or finished, or,
    with ``cancelled``, cancelled by its group's consensus.  Returns the
    phase's record and the driver's ``ServeResult``."""
    from repro_torch.launch import serve
    argv = ["--arch", arch, *(["--paged"] if paged else []),
            "--requests", str(requests), "--slots", "4", "--max-new-tokens",
            str(max_new), "--seed", str(SEED),
            *(["--group-size", str(group_size)] if group_size > 1 else []),
            *extra_argv]
    zero_launches()
    t0 = time.perf_counter()
    out = serve.serve(argv)
    sync(torch)
    wall = time.perf_counter() - t0
    launches = read_launches()
    states = [r.state.value for r in out.requests]
    terminal = {"stopped", "finished"} | ({"cancelled"} if cancelled
                                          else set())
    if len(states) != requests * group_size or not set(states) <= terminal:
        raise AssertionError(f"requests did not all end: {states}")
    # a FleetRouter's pools are its hosts'
    for host in getattr(out.scheduler, "hosts", [out.scheduler]):
        pool = host.pool
        if paged:
            pool.check()
            if pool.blocks_in_use:
                raise AssertionError(f"{pool.blocks_in_use} pages still in "
                                     "use")
        elif pool is not None:
            raise AssertionError("a dense fleet holds a page pool")
    missing = [k for k in need if launches[k] < 1]
    if missing:
        raise AssertionError(f"{missing} never ran on the main path: "
                             f"{launches}")
    fleet = out.fleet
    res = dict(phase=phase, argv=argv, lam=out.lam, states=states,
               stop_steps=[r.stop_step for r in out.requests],
               tokens=[len(r.tokens) for r in out.requests],
               engine_steps=fleet.engine_steps,
               requests_per_s=fleet.requests_per_s,
               tokens_per_s=fleet.tokens_per_s,
               serve_wall_s=fleet.wall_time_s, driver_wall_s=wall,
               prefill_chunks=fleet.prefill_chunks,
               packed_chunks=fleet.packed_chunks,
               peak_step_tokens=fleet.peak_step_tokens,
               stall_ms_p50=fleet.stall_ms_p50,
               stall_ms_p99=fleet.stall_ms_p99,
               ttft_ms_p50=fleet.ttft_ms_p50, ttft_ms_p99=fleet.ttft_ms_p99,
               launches=launches)
    if out.static is not None:
        # the assertion of benchmarks/serving_throughput.py: eviction does
        # not move a single stop decision
        if out.static.stop_step.tolist() != res["stop_steps"]:
            raise AssertionError(f"static-batch stops "
                                 f"{out.static.stop_step.tolist()} differ "
                                 f"from the fleet's {res['stop_steps']}")
        res["static_batch"] = dict(
            stop_steps=out.static.stop_step.tolist(),
            engine_steps=out.static.engine_steps,
            wall_s=out.static.wall_time_s,
            requests_per_s=requests / out.static.wall_time_s,
            slot_utilization=(out.static.active_slot_steps
                              / max(out.static.total_slot_steps, 1)))
    return res, out


# the depth of the driver's chunked and static-baseline fleets (full
# width), cut from 32 to keep the script within its time; serve-preempt,
# serve-group and the RWKV fleet (of 24) too since the hymba and whisper
# phases
CUT_LAYERS = 8
# decode steps of phase harvest's and harvest-rwkv's turns (the driver's
# harvest takes 96), cut to pay for the hymba and whisper phases
HARVEST_NEW = 48


def full_depth(torch, arch):
    """``arch`` at full width and depth with the driver's weights (drawn
    from the seed as ``launch.serve`` draws them): ``.model`` and
    ``.params``, what ``f32_cut`` takes."""
    import types
    from repro_torch.configs import get_config
    from repro_torch.models import build
    model = build(get_config(arch))
    return types.SimpleNamespace(model=model, params=model.init(
        torch.Generator().manual_seed(SEED), DEV))


class CutDepth:
    """Within the block, the serving driver builds its model cut to the
    config's first ``layers`` layers (full width)."""

    def __init__(self, layers: int):
        self.layers = layers

    def __enter__(self):
        import dataclasses
        from repro_torch.launch import serve
        self.serve, self.get_config = serve, serve.get_config

        def get_config(name):
            cfg = self.get_config(name)
            return dataclasses.replace(
                cfg, n_layers=min(self.layers, cfg.n_layers))
        serve.get_config = get_config
        return self

    def __exit__(self, *exc):
        self.serve.get_config = self.get_config

# the harvest and every admission run K7 and K6 in every fleet
SERVE_NEED = ("serving_probe_step", "paged_flash_decode", "flash_decode",
              "flash_attention")


def phase_serve(torch, extra_argv=(), *, phase="serve", requests=8,
                need=SERVE_NEED):
    res, out = serve_fleet(torch, extra_argv, phase=phase, requests=requests,
                           need=need)
    emit(res)
    return res, out


def profiled_events(prof):
    """Every event of a finished torch.profiler window as (name, device
    type, start us, end us), from its raw kineto results."""
    out = []
    for e in prof.profiler.kineto_results.events():
        t0_us = e.start_ns() / 1e3
        out.append((e.name(), e.device_type(), t0_us,
                    t0_us + e.duration_ns() / 1e3))
    return out


def phase_trace(torch, sched, steps: int = TRACE_STEPS,
                prompt_len: int = 16, phase: str = "trace", requests=None):
    """A profiler window over ``steps`` engine steps of the served fleet,
    refilled with fresh requests of ``prompt_len`` tokens (``steps`` + 8
    new tokens each: the warm steps and the window at one token a step,
    then a short drain): the card's busy
    share of the window's wall time and the kernels that take it, and the
    device kernels and busy share per step, split into steps that ran a
    prefill chunk and steps that did not.  A device kernel belongs to the
    step whose host span it starts in (every step ends in a sync).
    ``requests``, a function of the new-token budget, makes the fleet's
    requests in place of the random prompts (serve-llava's image
    requests)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.serving import make_request
    if requests is not None:
        sched.submit(requests(steps + 8))
    else:
        gen = torch.Generator().manual_seed(SEED + 2)
        vocab = sched.model.cfg.vocab_size
        prompts = torch.randint(0, vocab, (sched.n_slots, prompt_len),
                                generator=gen, dtype=torch.int32)
        sched.submit([make_request(t.numpy(), max_new_tokens=steps + 8)
                      for t in prompts])
    eng = sched.engine
    had_chunk = []
    served_step = eng.step

    def step(chunk=None, **spec):
        had_chunk.append(chunk is not None)
        return served_step(chunk, **spec)

    # admission, then warm steps; a chunked fleet's window starts after
    # one, so that it holds the prompts' chunk steps and the decode after
    for _ in range(4 if prompt_len <= CHUNK else 1):
        sched.step()
    sync(torch)
    eng.step = step
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                with record_function(f"engine_step_{i}"):
                    sched.step()
            sync(torch)
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        del eng.step
    while sched.step():
        pass
    # the window's events, read from the profiler's raw results (building
    # torch's FunctionEvents for prof.events() or key_averages() took most
    # of a trace phase's time on the card), each (name, device, start, end)
    # in us
    events = profiled_events(prof)
    # device-side events only (an operator's row on the host also carries
    # the device time of the kernels it launched), without the device-side
    # copies of the step annotations
    device = [e for e in events if e[1] == DeviceType.CUDA
              and not e[0].startswith("engine_step_")]
    # device time and calls by kernel name
    by_key = {}
    for name, _, t0_us, t1_us in device:
        acc = by_key.setdefault(name, [0.0, 0])
        acc[0] += t1_us - t0_us
        acc[1] += 1
    rows = sorted(((us, key, n) for key, (us, n) in by_key.items()),
                  reverse=True)
    busy_us = sum(r[0] for r in rows)
    # per-step split: host spans of the steps, device events by start
    spans = {int(name.rsplit("_", 1)[1]): (t0_us, t1_us)
             for name, dev, t0_us, t1_us in events
             if dev == DeviceType.CPU and name.startswith("engine_step_")}
    order = sorted(spans)
    starts = [spans[i][0] for i in order]
    per_step = {i: [0, 0.0] for i in order}
    unassigned = 0
    for _, _, t0_us, t1_us in device:
        j = bisect.bisect_right(starts, t0_us) - 1
        if j < 0:
            unassigned += 1
            continue
        per_step[order[j]][0] += 1
        per_step[order[j]][1] += t1_us - t0_us
    split = {}
    for label, flag in (("with_chunk", True), ("without_chunk", False)):
        ids = [i for i in order if had_chunk[i] == flag]
        if not ids:
            split[label] = None
            continue
        span_us = sum(spans[i][1] - spans[i][0] for i in ids)
        split[label] = dict(
            steps=len(ids),
            kernels_per_step=sum(per_step[i][0] for i in ids) / len(ids),
            device_busy_ms_per_step=sum(per_step[i][1] for i in ids)
            / len(ids) / 1e3,
            wall_ms_per_step=span_us / len(ids) / 1e3,
            device_busy_share=(sum(per_step[i][1] for i in ids) / span_us
                               if span_us else None))
    # the split-KV merge (K2, K3 and K6 past 256 positions), by its name
    merges = sum(r[2] for r in rows if "merge_splits" in r[1])
    res = dict(phase=phase, steps=steps, prompt_len=prompt_len,
               merge_kernels_per_step=merges / steps,
               wall_ms_per_step=wall_us / steps / 1e3,
               device_busy_ms_per_step=busy_us / steps / 1e3,
               device_busy_share=busy_us / wall_us if busy_us else None,
               kernels_per_step=sum(r[2] for r in rows) / steps,
               split=split, unassigned_device_events=unassigned,
               top=[dict(kernel=k[:90], ms_per_step=us / steps / 1e3,
                         calls_per_step=c / steps)
                    for us, k, c in rows[:8]])
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phase serve-spec: linear speculative decode through the driver

class CheckedK4:
    """K4 on the inputs the engine gives it; the first ``limit`` calls are
    each held against the plain version on copies of the same state (the
    integer and boolean state equal, floats within K4_TOL).  ``max_accept``
    is the longest accepted length among the checked calls."""

    def __init__(self, K4, limit: int):
        self.K4, self.limit = K4, limit
        self.calls, self.err, self.max_accept = 0, 0.0, 0

    def __call__(self, zq, zk, bnd, acc, *state, burn_in):
        check = self.calls < self.limit
        if check:
            plain = [t.clone() for t in state[:6]]
            want = self.K4.serving_probe_spec_step_plain(
                zq, zk, bnd, acc, *plain, *state[6:], burn_in=burn_in)
        got = self.K4.serving_probe_spec_step(zq, zk, bnd, acc, *state,
                                              burn_in=burn_in)
        if check:
            for name in ("n_seq", "n_scores", "stopped", "stop_step"):
                if not getattr(got, name).equal(getattr(want, name)):
                    raise AssertionError(f"K4 in the fleet, call "
                                         f"{self.calls}: {name} differs")
            err = max(float((getattr(got, n) - getattr(want, n)).abs().max())
                      for n in ("s", "smoothed_seq", "W", "b", "ring"))
            if err > K4_TOL:
                raise AssertionError(f"K4 in the fleet, call {self.calls}: "
                                     f"err {err}")
            self.err = max(self.err, err)
            self.max_accept = max(self.max_accept, int(acc.max()))
        self.calls += 1
        return got


def first_divergence(torch, model, params, req, ref,
                     names=("spec", "one_token")):
    """The first token where a request left the reference fleet's (by
    default the one-token fleet's) sequence, and the reference run's top-2
    logit margin there: the model consumed prompt + [0] + tokens[:j] (a
    slot starts decoding from token 0) before choosing tokens[j]."""
    from repro_torch.models import transformer
    j = next(i for i, (a, b) in enumerate(zip(req.tokens, ref.tokens))
             if a != b)
    seq = list(req.inputs["tokens"][0]) + [0] + ref.tokens[:j]
    toks = torch.tensor([seq], dtype=torch.int32, device=DEV)
    with torch.no_grad():
        _, h, _ = model.prefill(model.cfg, params, {"tokens": toks},
                                len(seq))
        lg = transformer.logits_from_hidden(model.cfg, params, h)
    top = lg[0, :model.cfg.vocab_size].float().topk(2).values
    return {"req_id": req.req_id, "token": j, names[0]: req.tokens[j],
            names[1]: ref.tokens[j], "logit_margin": float(top[0] - top[1])}


def phase_serve_spec(torch, base, extra_argv=(), *, phase="serve-spec",
                     spec=("--spec-tokens", "4"), k3_per_step=None):
    """The driver with ``spec`` (``--spec-tokens 4``, or ``--spec-tree
    W.D``) on ``base``'s fleet: K4 must launch once per engine step (each
    is a verify step), and with ``k3_per_step`` K3 that many times a step
    (once a layer: a fleet with no chunk verifies every step through K3
    and nothing else); the first 16 K4 calls are held against the plain
    version, and each request is held against the one-token fleet
    ``base`` served (tokens and stops)."""
    from repro_torch.kernels import probe_spec as K4
    from repro_torch.serving import engine as E
    checked = CheckedK4(K4, limit=16)
    served = E.serving_probe_spec_step
    E.serving_probe_spec_step = checked
    try:
        res, out = serve_fleet(
            torch, (*spec, *extra_argv), phase=phase,
            requests=len(base.requests),
            need=("serving_probe_spec_step", "paged_flash_packed_chunk"))
    finally:
        E.serving_probe_spec_step = served
    fleet = out.fleet
    k4 = res["launches"]["serving_probe_spec_step"]
    if k4 != fleet.engine_steps:
        raise AssertionError(f"K4 launched {k4} times in "
                             f"{fleet.engine_steps} spec steps")
    k3 = res["launches"]["paged_flash_packed_chunk"]
    if k3_per_step is not None and k3 != k3_per_step * fleet.engine_steps:
        raise AssertionError(f"K3 launched {k3} times in "
                             f"{fleet.engine_steps} steps, not "
                             f"{k3_per_step} a step")
    agree = [r.tokens == b.tokens and r.stop_step == b.stop_step
             for r, b in zip(out.requests, base.requests)]
    bad = [(r, b) for r, b in zip(out.requests, base.requests)
           if r.tokens != b.tokens]
    res.update(
        step_ms=fleet.wall_time_s / fleet.engine_steps * 1e3,
        drafts_proposed=fleet.spec_tokens_proposed,
        drafts_accepted=fleet.spec_tokens_accepted,
        acceptance_rate=fleet.acceptance_rate,
        accepted_len_p50=fleet.accepted_len_p50,
        accepted_len_p99=fleet.accepted_len_p99,
        draft_cache_hits=fleet.draft_cache_hits,
        draft_cache_misses=fleet.draft_cache_misses,
        k4_checked_calls=min(checked.calls, checked.limit),
        k4_checked_err=checked.err,
        one_token=dict(engine_steps=base.fleet.engine_steps,
                       tokens_per_s=base.fleet.tokens_per_s,
                       step_ms=base.fleet.wall_time_s
                       / base.fleet.engine_steps * 1e3),
        agree_with_one_token=f"{sum(agree)}/{len(agree)}",
        first_divergence=(first_divergence(torch, out.scheduler.model,
                                           out.scheduler.params, *bad[0])
                          if bad else None))
    if out.scheduler.spec_tree:
        res.update(tree=out.scheduler.spec_tree,
                   tree_nodes_proposed=fleet.tree_nodes_proposed,
                   tree_path_accepted_p50=fleet.tree_path_accepted_p50,
                   tree_path_accepted_p99=fleet.tree_path_accepted_p99)
    emit(res)
    return res, out


def choose_lambda(scores, burn_in):
    """A threshold between the served smoothed scores that stops some
    requests and not others, as far as it can get from every score the
    threshold test reads (those after the burn-in); splits that stop a
    quarter to three quarters of the requests first.  Returns (lambda*,
    its distance to the nearest such score)."""
    tested = sorted({s for sc in scores for s in sc[burn_in:]})
    n = len(scores)
    best = None
    for lo, hi in zip(tested, tested[1:]):
        lam = (lo + hi) / 2
        stops = sum(any(s >= lam for s in sc[burn_in:]) for sc in scores)
        if 0 < stops < n:
            key = (n / 4 <= stops <= 3 * n / 4 and hi - lo > 2e-3, hi - lo)
            if best is None or key > best[0]:
                best = (key, lam, (hi - lo) / 2)
    if best is None:
        raise AssertionError(f"no threshold splits the scores {scores}")
    return best[1], best[2]


# serve-spec-f32's and serve-dense-f32's depth, 4 of smollm-360m's 32
# layers, and group-stops-f32's, 8 (full width), cut to keep the script
# within its time
SPEC_F32_LAYERS = 4
DENSE_F32_LAYERS = 8


def phase_spec_stops(torch, sched, requests: int = 8, prompt_len: int = 16):
    """The stop-invariance of ``benchmarks/serving_throughput.py`` and the
    JAX suite's ``test_spec_stops_match_one_token_matrix``, in float32 on
    the serve fleet cut to its first ``SPEC_F32_LAYERS`` layers (full
    width): the driver's weights and calibrated probe, served
    through ``OrcaScheduler`` one token at a time with nothing stopping
    (every request's full score trajectory), then at a lambda* between
    those scores, one-token and with spec_tokens 4: every stop step, and
    every token up to it, equal.  With random weights the default draft
    cache proposes nothing the verifier accepts, so a second spec fleet
    gets a cache that has observed the free fleet's tokens: its drafts are
    the one-token continuations, several tokens land per step (``pos``
    advancing by gen > 1, K4 chaining accepted tokens, the collection
    truncating at a stop), and its first 16 K4 calls are held against the
    plain version, at least one of them with an accepted length above 1."""
    from repro_torch.kernels import probe_spec as K4
    from repro_torch.launch import serve
    from repro_torch.serving import (DraftCache, OrcaScheduler, ServeConfig,
                                     make_request)
    from repro_torch.serving import engine as E
    model32, params32 = f32_cut(sched, SPEC_F32_LAYERS,
                                kv_cache_dtype="float32")
    batch = serve.model_inputs(model32.cfg,
                               torch.Generator().manual_seed(SEED + 1),
                               requests, prompt_len)
    base = dict(n_slots=4, paged=True, tokens_per_step=8, max_new_tokens=96,
                burn_in=2)

    def fleet(lam, spec, cache=None):
        t0 = time.perf_counter()
        done, fl = OrcaScheduler(model32, params32, sched.pc, sched.theta,
                                 ServeConfig(lam=lam, spec_tokens=spec,
                                             **base),
                                 draft_cache=cache).run(
            [make_request(t) for t in batch["tokens"]])
        sync(torch)
        return done, fl, time.perf_counter() - t0

    free, _, _ = fleet(2.0, None)
    lam, margin = choose_lambda([r.scores for r in free], base["burn_in"])
    # f32 scores of the two paths differ by about 1e-6
    if margin < 1e-4:
        raise AssertionError(f"every threshold lies within {margin} of a "
                             "score: the check would hang on a tie")
    one, one_fl, one_s = fleet(lam, None)
    spec, spec_fl, spec_s = fleet(lam, 4)
    primed = DraftCache()
    for r in free:
        primed.observe(r.inputs["tokens"][0].tolist(), r.tokens)
    checked = CheckedK4(K4, limit=16)
    served = E.serving_probe_spec_step
    E.serving_probe_spec_step = checked
    try:
        hit, hit_fl, hit_s = fleet(lam, 4, primed)
    finally:
        E.serving_probe_spec_step = served
    stops = [r.stop_step for r in one]
    for name, done in (("spec", spec), ("primed spec", hit)):
        if [r.stop_step for r in done] != stops:
            raise AssertionError(f"f32 {name} stops "
                                 f"{[r.stop_step for r in done]} differ "
                                 f"from one-token stops {stops}")
        if [r.tokens for r in done] != [r.tokens for r in one]:
            raise AssertionError(f"f32 {name} tokens differ from one-token "
                                 "tokens")
    longest = max(g for r in hit for g in r.accepted_lens)
    if hit_fl.spec_tokens_accepted < 1 or longest < 2:
        raise AssertionError(f"the primed cache's drafts were not accepted: "
                             f"{hit_fl.spec_tokens_accepted} accepted, "
                             f"longest block {longest}")
    if checked.max_accept < 2:
        raise AssertionError("no checked K4 call chained more than one "
                             "accepted token")

    def spec_res(fl, wall_s):
        return dict(engine_steps=fl.engine_steps, wall_s=wall_s,
                    tokens_per_s=fl.tokens_per_s,
                    drafts_accepted=fl.spec_tokens_accepted,
                    drafts_proposed=fl.spec_tokens_proposed,
                    accepted_len_p50=fl.accepted_len_p50,
                    draft_cache_hits=fl.draft_cache_hits,
                    draft_cache_misses=fl.draft_cache_misses)

    res = dict(phase="serve-spec-f32", layers=model32.cfg.n_layers, lam=lam,
               lambda_margin=margin,
               stop_steps=stops, stopped=sum(s >= 0 for s in stops),
               one_token=dict(engine_steps=one_fl.engine_steps, wall_s=one_s,
                              tokens_per_s=one_fl.tokens_per_s),
               spec=spec_res(spec_fl, spec_s),
               spec_primed=dict(spec_res(hit_fl, hit_s),
                                longest_block=longest,
                                k4_checked_calls=min(checked.calls,
                                                     checked.limit),
                                k4_checked_max_accept=checked.max_accept,
                                k4_checked_err=checked.err))
    emit(res)
    return res


def recorded_fleet(sched, requests):
    """Serve ``requests`` through ``sched``, recording every engine step's
    view: (done, fleet, views)."""
    sched.prepare(requests)
    views, served = [], sched.engine.step

    def step(*args, **kw):
        views.append(served(*args, **kw))
        return views[-1]
    sched.engine.step = step
    done, fl = sched.run(requests)
    return done, fl, views


def same_steps(a_views, b_views) -> bool:
    """Two fleets' engine steps commit alike: per step, the next tokens,
    the stop state, the scores and every slot's committed sequence with
    its scores (its first ``gen`` entries), bit for bit."""
    import numpy as np
    if len(a_views) != len(b_views):
        return False
    for a, b in zip(a_views, b_views):
        for fld in ("tokens", "stopped", "stop_step", "n_scores", "smoothed",
                    "gen"):
            if not np.array_equal(getattr(a, fld), getattr(b, fld)):
                return False
        for slot, g in enumerate(a.gen):
            for fld in ("seq", "seq_scores", "seq_n"):
                if not np.array_equal(getattr(a, fld)[slot, :g],
                                      getattr(b, fld)[slot, :g]):
                    return False
    return True


# tree-stops-f32's depth: 4 of the serve-tree fleet's 32 layers (full
# width; 8 until the training phases), cut to make room for the fleet and
# training phases within the script's time
TREE_F32_LAYERS = 4


def phase_tree_stops(torch, sched, requests: int = 4, prompt_len: int = 16):
    """``phase_spec_stops`` for tree speculative decode, in float32 on the
    serve fleet's weights (those the serve-tree fleet draws at full depth)
    cut to ``TREE_F32_LAYERS`` layers and its calibrated probe, paged and
    chunked
    (64-token chunks): a free one-token fleet with nothing stopping, then
    lambda* between its scores.  At lambda*, with a draft cache primed by
    the free fleet's tokens (so drafts are accepted): the 3.3 fleet's
    every stop step and token equal the one-token fleet's, some accepted
    path is longer than the root, every K3 call is held against its plain
    version and the first 16 K4 calls against theirs; and ``1.3`` equals
    ``--spec-tokens 4`` step for step (each fleet with its own primed
    cache)."""
    import dataclasses
    from repro_torch.kernels import paged_chunk as K3
    from repro_torch.kernels import probe_spec as K4
    from repro_torch.launch import serve
    from repro_torch.models import attention as A
    from repro_torch.models import build
    from repro_torch.serving import (DraftCache, OrcaScheduler, ServeConfig,
                                     make_request)
    from repro_torch.serving import engine as E
    model32, params32 = f32_cut(sched, TREE_F32_LAYERS,
                                kv_cache_dtype="float32")
    batch = serve.model_inputs(model32.cfg,
                               torch.Generator().manual_seed(SEED + 1),
                               requests, prompt_len)
    base = dict(n_slots=4, paged=True, chunk_tokens=CHUNK, tokens_per_step=8,
                max_new_tokens=96, burn_in=2)

    def scheduler(lam, cache=None, **spec):
        return OrcaScheduler(model32, params32, sched.pc, sched.theta,
                             ServeConfig(lam=lam, **base, **spec),
                             draft_cache=cache)

    def reqs():
        return [make_request(t) for t in batch["tokens"]]

    def fleet(lam, cache=None, **spec):
        zero_launches()
        t0 = time.perf_counter()
        done, fl = scheduler(lam, cache, **spec).run(reqs())
        sync(torch)
        return done, fl, time.perf_counter() - t0, read_launches()

    free, _, _, _ = fleet(2.0)
    lam, margin = choose_lambda([r.scores for r in free], base["burn_in"])
    if margin < 1e-4:
        raise AssertionError(f"every threshold lies within {margin} of a "
                             "score: the check would hang on a tie")

    def primed():
        cache = DraftCache()
        for r in free:
            cache.observe(r.inputs["tokens"][0].tolist(), r.tokens)
        return cache

    one, one_fl, one_s, _ = fleet(lam)
    k4 = CheckedK4(K4, limit=16)
    k3 = CheckedK3(K3.paged_flash_packed_chunk, K3.paged_packed_chunk_plain)
    served = E.serving_probe_spec_step, A.paged_flash_packed_chunk
    E.serving_probe_spec_step, A.paged_flash_packed_chunk = k4, k3
    try:
        tree, tree_fl, tree_s, tree_l = fleet(lam, primed(), spec_tree="3.3")
    finally:
        E.serving_probe_spec_step, A.paged_flash_packed_chunk = served
    stops = [r.stop_step for r in one]
    if [r.stop_step for r in tree] != stops:
        raise AssertionError(f"f32 tree stops {[r.stop_step for r in tree]} "
                             f"differ from one-token stops {stops}")
    if [r.tokens for r in tree] != [r.tokens for r in one]:
        raise AssertionError("f32 tree tokens differ from one-token tokens")
    longest = max(g for r in tree for g in r.tree_path_lens)
    if longest < 2 or k4.max_accept < 2:
        raise AssertionError(f"the primed tree accepted no path past the "
                             f"root: longest {longest}, longest checked K4 "
                             f"chain {k4.max_accept}")
    if tree_l["serving_probe_spec_step"] != tree_fl.engine_steps \
            or k3.calls != tree_l["paged_flash_packed_chunk"] \
            or not tree_fl.packed_chunks:
        raise AssertionError(f"tree fleet launches {tree_l} in "
                             f"{tree_fl.engine_steps} steps, {k3.calls} K3 "
                             f"calls checked, {tree_fl.packed_chunks} "
                             "packed chunks")
    lin, lin_fl, lin_views = recorded_fleet(
        scheduler(lam, primed(), spec_tokens=4), reqs())
    w1, w1_fl, w1_views = recorded_fleet(
        scheduler(lam, primed(), spec_tree="1.3"), reqs())
    if not same_steps(lin_views, w1_views):
        raise AssertionError(f"1.3 ({w1_fl.engine_steps} steps) and "
                             f"spec_tokens 4 ({lin_fl.engine_steps}) differ")
    if [r.tokens for r in w1] != [r.tokens for r in one] \
            or [r.stop_step for r in w1] != stops:
        raise AssertionError("f32 1.3 tokens or stops differ from "
                             "one-token decode")
    res = dict(phase="tree-stops-f32", requests=requests, lam=lam,
               lambda_margin=margin, stop_steps=stops,
               stopped=sum(s >= 0 for s in stops),
               one_token=dict(engine_steps=one_fl.engine_steps, wall_s=one_s,
                              tokens_per_s=one_fl.tokens_per_s),
               tree_primed=dict(
                   tree="3.3", engine_steps=tree_fl.engine_steps,
                   wall_s=tree_s, tokens_per_s=tree_fl.tokens_per_s,
                   nodes_proposed=tree_fl.tree_nodes_proposed,
                   path_p50=tree_fl.tree_path_accepted_p50,
                   path_p99=tree_fl.tree_path_accepted_p99,
                   longest_path=longest,
                   packed_chunks=tree_fl.packed_chunks,
                   draft_cache_hits=tree_fl.draft_cache_hits,
                   draft_cache_misses=tree_fl.draft_cache_misses,
                   launches=tree_l, k3_checked_calls=k3.calls,
                   k3_m_rel_err=k3.m_err, k3_out_err=k3.out_err,
                   k4_checked_calls=min(k4.calls, k4.limit),
                   k4_checked_max_accept=k4.max_accept,
                   k4_checked_err=k4.err),
               width_one=dict(engine_steps=w1_fl.engine_steps,
                              linear_engine_steps=lin_fl.engine_steps,
                              steps_equal=True,
                              drafts_accepted=w1_fl.spec_tokens_accepted))
    emit(res)
    return res


def phase_llama_tree(torch, served, out, tree: str = "2.3"):
    """``--spec-tree 2.3`` on serve-llama's weights and calibrated probe,
    through ``OrcaScheduler`` (no second harvest): serve-llama's requests
    and fleet shape; K4 once a step and K3 (d 128, G 3) once a layer a
    step; the requests beside serve-llama's one-token ones (printed)."""
    from repro_torch.launch import serve
    from repro_torch.serving import OrcaScheduler, ServeConfig, make_request
    sched = out.scheduler
    cfg = sched.model.cfg
    batch = serve.model_inputs(cfg, torch.Generator().manual_seed(SEED + 1),
                               WIDE_REQUESTS, 16)
    zero_launches()
    t0 = time.perf_counter()
    done, fl = OrcaScheduler(
        sched.model, sched.params, sched.pc, sched.theta,
        ServeConfig(lam=out.lam, n_slots=4, paged=True, tokens_per_step=8,
                    max_new_tokens=WIDE_NEW, burn_in=2, spec_tree=tree)).run(
        [make_request(t) for t in batch["tokens"]])
    sync(torch)
    wall = time.perf_counter() - t0
    lc = read_launches()
    want = dict(serving_probe_spec_step=fl.engine_steps,
                paged_flash_packed_chunk=cfg.n_layers * fl.engine_steps)
    got = {k: lc[k] for k in want}
    if got != want:
        raise AssertionError(f"serve-llama-tree launches {got}, expected "
                             f"{want}")
    agree = [r.tokens == b.tokens and r.stop_step == b.stop_step
             for r, b in zip(done, out.requests)]
    res = dict(phase="serve-llama-tree", arch=cfg.name, tree=tree,
               layers=cfg.n_layers, d_head=cfg.d_head,
               G=cfg.n_heads // cfg.n_kv_heads, lam=out.lam,
               states=[r.state.value for r in done],
               stop_steps=[r.stop_step for r in done],
               tokens=[len(r.tokens) for r in done],
               engine_steps=fl.engine_steps, wall_s=wall,
               step_ms=fl.wall_time_s / fl.engine_steps * 1e3,
               tokens_per_s=fl.tokens_per_s,
               nodes_proposed=fl.tree_nodes_proposed,
               path_p50=fl.tree_path_accepted_p50,
               path_p99=fl.tree_path_accepted_p99,
               draft_cache_hits=fl.draft_cache_hits,
               draft_cache_misses=fl.draft_cache_misses,
               one_token=dict(engine_steps=served["engine_steps"],
                              step_ms=served["step_ms"]),
               agree_with_one_token=f"{sum(agree)}/{len(agree)}",
               launches=lc)
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phases preempt-roundtrip, serve-preempt and preempt-stops-f32: spill to
# host RAM and restore, on other pages and in other slots

PREEMPT_STEPS = 8         # decode steps held bitwise after a restore
PREEMPT_BATCH = 4         # priority-1 requests, submitted first


def _row(first: int, n: int, reverse: bool = False):
    row = list(range(first, first + n))
    return row[::-1] if reverse else row


def timed_cycles(torch, eng, slot, rows, armed, prompt_len=0, cycles=5):
    """``cycles`` spills of ``slot`` and restores into it, alternating
    between ``rows`` (paged; None for a dense lane): per cycle the host
    milliseconds of ``preempt`` and of ``restore``, each ending in a
    synchronise (the spill's copy to host is synchronous already)."""
    out = dict(spill_ms=[], restore_ms=[])
    for i in range(cycles):
        old, new = (rows[i % 2], rows[(i + 1) % 2]) if rows else (None, None)
        sync(torch)
        t0 = time.perf_counter()
        spill = eng.preempt(slot, block_row=old, armed=armed,
                            prompt_len=prompt_len)
        sync(torch)
        t1 = time.perf_counter()
        eng.restore(slot, spill, block_row=new)
        sync(torch)
        out["spill_ms"].append((t1 - t0) * 1e3)
        out["restore_ms"].append((time.perf_counter() - t1) * 1e3)
    for key in ("spill_ms", "restore_ms"):
        out[key + "_median"] = sorted(out[key])[len(out[key]) // 2]
    out.update(nbytes=spill.nbytes, n_blocks=spill.n_blocks,
               spill_gb_per_s=spill.nbytes / out["spill_ms_median"] / 1e6,
               restore_gb_per_s=spill.nbytes / out["restore_ms_median"] / 1e6)
    return out


def roundtrip_variant(torch, sched, model, paged, prompts, lam):
    """One engine layout of phase preempt-roundtrip: engines A, B and C
    on the same weights, slots 0 and 1 admitted (16-token prompts), slot 2
    prefilling a 160-token prompt in 64-token chunks.  After two steps A
    spills slot 0 (RUNNING) and slot 2 (mid-prefill, 128 tokens in) and
    restores each into the same slot index on other pages (paged) or into
    the same lane (dense); C restores slot 0's spill into slot 3.  The
    round trip must be a copy: pages (with their scales) or lane, probe
    rows, token and pos bitwise.  Then 8 more steps: A's views equal the
    undisturbed B's bitwise (tokens, smoothed scores, stop state); C's
    slot 3 takes B's slot 0's tokens and stops.  Every kernel launch of
    the variant is counted and held to its expected number."""
    from repro_torch.serving import (ChunkSeg, ChunkWork,
                                     ContinuousServingEngine, ServeConfig)
    layers = model.cfg.n_layers
    short, long_ = prompts[0][:16], prompts[2]
    new = len(long_) + 96
    nb_short, nb_long = -(-(16 + 96) // BS), -(-new // BS)
    rows = {0: _row(1, nb_short), 1: _row(1 + nb_short, nb_short),
            2: _row(1 + 2 * nb_short, nb_long)}
    base = 1 + 2 * nb_short + nb_long
    moved = {0: _row(base, nb_short, True),
             2: _row(base + nb_short, nb_long, True)}
    num_blocks = base + nb_short + nb_long
    cfg = ServeConfig(tokens_per_step=8, max_new_tokens=96, lam=lam,
                      burn_in=2)

    def engine():
        return ContinuousServingEngine(
            model, sched.params, sched.pc, sched.theta, cfg, 4, new,
            paged=paged, block_size=BS,
            num_blocks=num_blocks if paged else None, chunk_tokens=CHUNK)

    def chunk(start, row):
        n = min(CHUNK, len(long_) - start)
        return ChunkWork(segs=(ChunkSeg(
            slot=2, tokens=long_, start=start, length=n,
            row=None if row is None else np_i32(row)),))

    zero_launches()
    engs = dict(A=engine(), B=engine(), C=engine())
    for eng in engs.values():
        for slot, p in ((0, short), (1, prompts[1][:16])):
            eng.admit(slot, {"tokens": p[None]}, 16,
                      block_row=rows[slot] if paged else None)
        eng.begin_prefill(2)
        for start in (0, CHUNK):
            eng.step(chunk(start, rows[2] if paged else None))
    A, B, C = engs["A"], engs["B"], engs["C"]

    def identity(eng, slot, row):
        lay = ({k: v[:, row].clone() for k, v in eng._pages().items()}
               if paged else {k: v[:, slot].clone()
                              for k, v in eng.state.items()})
        return (lay, [leaf[slot].clone() for leaf in eng.st],
                int(eng.token[slot]), int(eng.pos[slot]))

    def same(a, b):
        return (a[2:] == b[2:] and all(torch.equal(a[0][k], b[0][k])
                                       for k in a[0])
                and all(torch.equal(x, y) for x, y in zip(a[1], b[1])))

    spills = {}
    for slot, armed, prog in ((0, True, 0), (2, False, 2 * CHUNK)):
        before = identity(A, slot, rows[slot])
        spill = A.preempt(slot, block_row=rows[slot] if paged else None,
                          armed=armed, prompt_len=prog)
        if any(t.device.type != "cpu" for t in
               list((spill.pages or spill.lane).values()) + list(spill.probe)):
            raise AssertionError("a spill holds device memory")
        A.restore(slot, spill, block_row=moved[slot] if paged else None)
        if not same(identity(A, slot, moved[slot]), before):
            raise AssertionError(f"slot {slot}'s round trip is not a copy")
        spills[slot] = dict(armed=armed, nbytes=spill.nbytes,
                            n_blocks=spill.n_blocks)
    C.restore(3, C.preempt(0, block_row=rows[0] if paged else None),
              block_row=moved[0] if paged else None)
    for i in range(1 + PREEMPT_STEPS):
        views = {}
        for name, eng in engs.items():
            row = moved[2] if name == "A" else rows[2]
            views[name] = eng.step(chunk(2 * CHUNK, row if paged else None)
                                   if i == 0 else None)
            if i == 0:
                eng.finish_prefill(2, {"tokens": long_[None]}, len(long_),
                                   block_row=row if paged else None)
        for f in ("tokens", "smoothed", "n_scores", "stopped", "stop_step"):
            a, b, c = (getattr(views[n], f) for n in "ABC")
            if not (a == b).all():
                raise AssertionError(f"step {i}: {f} of the restored engine "
                                     f"{a} differ from the undisturbed {b}")
            if f in ("tokens", "stopped", "stop_step") \
                    and not (c[[3, 1, 2]] == b[[0, 1, 2]]).all():
                raise AssertionError(f"step {i}: {f} of slot 3 {c} differ "
                                     f"from the undisturbed slot 0 {b}")
    sync(torch)
    lc = read_launches()
    steps = 3 * (3 + PREEMPT_STEPS)
    want = dict(serving_probe_step=steps, flash_attention=layers * 2 * 3,
                paged_flash_decode=layers * steps if paged else 0,
                paged_flash_packed_chunk=layers * 3 * 3 if paged else 0,
                flash_decode=0 if paged else layers * steps)
    got = {k: lc[k] for k in want}
    if got != want:
        raise AssertionError(f"preempt-roundtrip launches {got}, expected "
                             f"{want}")
    # one request's spill and restore: 16 + 96 tokens (slot 0) and
    # 160 + 96 (slot 2); a dense lane is the whole cache length either way
    timed = {f"slot {slot}": timed_cycles(
        torch, A, slot, [moved[slot], rows[slot]] if paged else None, True)
        for slot in (0, 2)}
    return dict(spills=spills, launches=lc,
                stop_steps=views["B"].stop_step[:3].tolist(), timed=timed)


def np_i32(row):
    import numpy as np
    return np.asarray(row, np.int32)


def phase_preempt_roundtrip(torch, sched, lam):
    """Engine-level spill and restore at full width and depth (the serve
    fleet's smollm-360m, 4 slots, its probe and lambda*) on paged bf16,
    paged int8 and dense bf16 (``roundtrip_variant``); the spill and
    restore milliseconds and bytes of one request at this width."""
    import dataclasses
    from repro_torch.launch import serve
    from repro_torch.models import build
    cfg = sched.model.cfg
    prompts = serve.model_inputs(cfg, torch.Generator().manual_seed(SEED + 2),
                                 3, QWEN_PROMPT)["tokens"]
    t0 = time.perf_counter()
    res = dict(phase="preempt-roundtrip", arch=cfg.name, layers=cfg.n_layers,
               lam=lam, steps_held=PREEMPT_STEPS, variants={})
    for name, model, paged in (
            ("paged bf16", sched.model, True),
            ("paged int8", build(dataclasses.replace(
                cfg, kv_cache_dtype="int8")), True),
            ("dense bf16", sched.model, False)):
        res["variants"][name] = roundtrip_variant(torch, sched, model, paged,
                                                  prompts, lam)
    res["seconds"] = time.perf_counter() - t0
    emit(res)
    return res


def burst_fleet(torch, sched, prompts):
    """``prompts`` through ``sched`` (sized for all of them first): the
    first ``PREEMPT_BATCH`` as priority 1 (batch) at step 0, the rest as
    priority 0 (interactive) in one burst on the first step after which a
    batch request decodes while another is still mid-prefill.  Each spill
    is recorded (RUNNING or mid-prefill, pages, host ms) and each
    restore's host ms.  Returns (done, fleet, record)."""
    from repro_torch.serving import make_request
    reqs = [make_request(t, priority=int(i < PREEMPT_BATCH))
            for i, t in enumerate(prompts)]
    sched.prepare(reqs)
    eng = sched.engine
    rec = dict(victims=[], spill_ms=[], restore_ms=[], nbytes=[])
    preempt, restore = eng.preempt, eng.restore

    def spy_preempt(*a, **kw):
        sync(torch)
        t0 = time.perf_counter()
        spill = preempt(*a, **kw)
        rec["spill_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["victims"].append("running" if spill.armed else "prefill")
        rec["nbytes"].append(spill.nbytes)
        return spill

    def spy_restore(*a, **kw):
        sync(torch)
        t0 = time.perf_counter()
        restore(*a, **kw)
        sync(torch)
        rec["restore_ms"].append((time.perf_counter() - t0) * 1e3)

    eng.preempt, eng.restore = spy_preempt, spy_restore
    sched.submit(reqs[:PREEMPT_BATCH])
    rec["burst_step"] = None
    while sched.step():
        states = {r.state.value for r in reqs[:PREEMPT_BATCH]}
        if rec["burst_step"] is None and {"running", "prefill"} <= states:
            sched.submit(reqs[PREEMPT_BATCH:])
            rec["burst_step"] = sched._steps
    done, fleet = sched.drain()
    sync(torch)
    if rec["burst_step"] is None:
        raise AssertionError("no step had a batch request decoding beside "
                             "one mid-prefill: the burst never came")
    return done, fleet, rec


def phase_serve_preempt(torch, out, requests: int = 8, layers=None):
    """The serve fleet's smollm-360m (bf16, full width; with ``layers``
    its first ``layers`` layers, on the same weights) with its
    harvested probe and lambda* (no second harvest), paged, 160-token
    prompts in 64-token chunks, ``policy="priority"``, 4 slots, a pool of
    1 + 3 x a request's pages: 4 batch requests, then 4 interactive ones
    in a burst (``burst_fleet``).  Urgent admissions spill batch residents,
    RUNNING and mid-prefill, which restore later on other pages: every
    request ends, the pool drains and checks, restores equal spills, and
    K1, K2, K3 and K7 launch exactly as the steps and chunks say."""
    from repro_torch.launch import serve
    from repro_torch.serving import OrcaScheduler, ServeConfig
    base = out.scheduler
    model, params = f32_cut(base, layers, dtype=None)
    cfg = model.cfg
    blocks = -(-(QWEN_PROMPT + WIDE_NEW) // BS)
    prompts = serve.model_inputs(cfg, torch.Generator().manual_seed(SEED + 3),
                                 requests, QWEN_PROMPT)["tokens"]
    sched = OrcaScheduler(model, params, base.pc, base.theta,
                          ServeConfig(lam=out.lam, n_slots=4, paged=True,
                                      block_size=BS, num_blocks=1 + 3 * blocks,
                                      chunk_tokens=CHUNK, tokens_per_step=8,
                                      max_new_tokens=WIDE_NEW, burn_in=2,
                                      policy="priority"))
    zero_launches()
    t0 = time.perf_counter()
    done, fl, rec = burst_fleet(torch, sched, prompts)
    wall = time.perf_counter() - t0
    lc = read_launches()
    states = [r.state.value for r in done]
    if not set(states) <= {"stopped", "finished"}:
        raise AssertionError(f"serve-preempt requests did not all end: "
                             f"{states}")
    if not (fl.preemptions > 0 and fl.restores == fl.preemptions
            and fl.spilled_blocks > 0
            and {"running", "prefill"} <= set(rec["victims"])):
        raise AssertionError(f"serve-preempt: {fl.preemptions} spills "
                             f"({rec['victims']}), {fl.restores} restores, "
                             f"{fl.spilled_blocks} pages")
    sched.pool.check()
    if sched.pool.blocks_in_use:
        raise AssertionError(f"{sched.pool.blocks_in_use} pages in use")
    layers = cfg.n_layers
    want = dict(serving_probe_step=fl.engine_steps,
                paged_flash_decode=layers * fl.engine_steps,
                paged_flash_packed_chunk=layers * fl.prefill_chunks,
                flash_attention=0)
    got = {k: lc[k] for k in want}
    if got != want:
        raise AssertionError(f"serve-preempt launches {got}, expected {want}")
    print(f"[serve-preempt] fleet: {fl.n_requests} requests / {fl.n_slots} "
          f"slots in {fl.engine_steps} engine steps "
          f"({fl.wall_time_s:.2f}s) — {fl.tokens_per_s:.1f} tok/s; "
          f"preemptions {fl.preemptions}, restores {fl.restores}, "
          f"spilled_blocks {fl.spilled_blocks}", flush=True)
    res = dict(phase="serve-preempt", arch=cfg.name, layers=layers,
               lam=out.lam, pool_blocks=fl.pool_blocks,
               blocks_per_request=blocks, burst_step=rec["burst_step"],
               states=states, stop_steps=[r.stop_step for r in done],
               priorities=[r.priority for r in done],
               n_preempted=[r.n_preempted for r in done],
               admitted_step=[r.admitted_step for r in done],
               restored_step=[r.restored_step for r in done],
               preemptions=fl.preemptions, restores=fl.restores,
               spilled_blocks=fl.spilled_blocks, victims=rec["victims"],
               spill_nbytes=rec["nbytes"], spill_ms=rec["spill_ms"],
               restore_ms=rec["restore_ms"],
               engine_steps=fl.engine_steps, prefill_chunks=fl.prefill_chunks,
               packed_chunks=fl.packed_chunks, wall_s=wall,
               step_ms=fl.wall_time_s / fl.engine_steps * 1e3,
               tokens_per_s=fl.tokens_per_s,
               stall_ms_p50=fl.stall_ms_p50, stall_ms_p99=fl.stall_ms_p99,
               per_class=fl.per_class, launches=lc)
    emit(res)
    return res


def phase_preempt_stops(torch, sched, requests: int = 8):
    """The serve fleet's weights in float32 at ``F32_LAYERS`` layers
    (full width) on f32 pages, 160-token prompts in 64-token chunks, with
    its harvested probe at a lambda* between the free fleet's scores
    (``choose_lambda``: decisive, no score near it).  The same requests
    served three ways: abundant (one class, every page: nothing contends),
    under forced preemption (``burst_fleet``: 4 slots, a pool of 1 + 3 x a
    request's pages, ``policy="priority"``), and the same under
    ``spec_tree="3.3"`` with a draft cache primed by the abundant tokens
    (paths past the root accepted; K3 verifies, K4 commits).  Every stop
    step and every token equal across the three."""
    from repro_torch.launch import serve
    from repro_torch.serving import (DraftCache, OrcaScheduler, ServeConfig,
                                     make_request)
    model32, params32 = f32_cut(sched, F32_LAYERS, kv_cache_dtype="float32")
    prompts = serve.model_inputs(model32.cfg,
                                 torch.Generator().manual_seed(SEED + 3),
                                 requests, QWEN_PROMPT)["tokens"]
    blocks = -(-(QWEN_PROMPT + 96) // BS)
    base = dict(paged=True, block_size=BS, chunk_tokens=CHUNK,
                tokens_per_step=8, max_new_tokens=96, burn_in=2)

    def scheduler(lam, cache=None, **kw):
        return OrcaScheduler(model32, params32, sched.pc, sched.theta,
                             ServeConfig(lam=lam, **base, **kw),
                             draft_cache=cache)

    def abundant(lam):
        # one class, every page: nothing contends (4 slots, as below, so
        # every fleet runs the same batch shapes)
        return scheduler(lam, n_slots=4).run(
            [make_request(t) for t in prompts])

    t0 = time.perf_counter()
    free, _ = abundant(2.0)
    lam, margin = choose_lambda([r.scores for r in free], base["burn_in"])
    if margin < 1e-4:
        raise AssertionError(f"every threshold lies within {margin} of a "
                             "score: the check would hang on a tie")
    ref, ref_fl = abundant(lam)
    if ref_fl.preemptions:
        raise AssertionError("the abundant fleet preempted")
    cache = DraftCache()
    for r in ref:
        cache.observe(r.inputs["tokens"][0].tolist(), r.tokens)
    tight = dict(n_slots=4, num_blocks=1 + 3 * blocks, policy="priority")
    runs = {}
    for name, kw, dc in (("preempted", {}, None),
                         ("preempted tree 3.3", dict(spec_tree="3.3"),
                          cache)):
        zero_launches()
        done, fl, rec = burst_fleet(torch, scheduler(lam, dc, **tight, **kw),
                                    prompts)
        lc = read_launches()
        stops = [r.stop_step for r in done]
        if stops != [r.stop_step for r in ref] \
                or [r.tokens for r in done] != [r.tokens for r in ref]:
            raise AssertionError(f"{name}: stops {stops} or tokens differ "
                                 f"from the abundant fleet's "
                                 f"{[r.stop_step for r in ref]}")
        if not (fl.preemptions > 0 and fl.restores == fl.preemptions):
            raise AssertionError(f"{name}: {fl.preemptions} spills, "
                                 f"{fl.restores} restores")
        runs[name] = dict(engine_steps=fl.engine_steps,
                          preemptions=fl.preemptions, restores=fl.restores,
                          spilled_blocks=fl.spilled_blocks,
                          victims=rec["victims"],
                          burst_step=rec["burst_step"],
                          n_preempted=[r.n_preempted for r in done],
                          launches=lc)
        if kw:
            longest = max(g for r in done for g in r.tree_path_lens)
            if longest < 2 or not lc["serving_probe_spec_step"] \
                    or not lc["paged_flash_packed_chunk"]:
                raise AssertionError(f"{name}: longest accepted path "
                                     f"{longest}, launches {lc}")
            runs[name].update(longest_path=longest,
                              nodes_proposed=fl.tree_nodes_proposed)
    res = dict(phase="preempt-stops-f32", layers=model32.cfg.n_layers,
               requests=requests, prompt=QWEN_PROMPT, lam=lam,
               lambda_margin=margin, stop_steps=[r.stop_step for r in ref],
               stopped=sum(r.stop_step >= 0 for r in ref),
               abundant_engine_steps=ref_fl.engine_steps, runs=runs,
               seconds=time.perf_counter() - t0)
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phases harvest, serve-dense, trace-dense and serve-dense-f32: the dense
# side of the path (K6 and K7)

class PlainDenseAttention:
    """Within the block, the model's dense attention runs the plain
    versions of K6 and K7 (what the port ran before them)."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as K7
        from repro_torch.kernels import flash_decode as K6
        from repro_torch.models import attention as A
        self.served = A.flash_decode, A.flash_attention
        A.flash_decode, A.flash_attention = (K6.flash_decode_plain,
                                             K7.attn_prefill_einsum)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention as A
        A.flash_decode, A.flash_attention = self.served
        return False


def harvest_turns(torch, sched, plain, expect, n, prompt_len, max_new):
    """The driver's harvest (``trajectories_from_model``: one prefill of
    ``n`` prompts, then ``max_new`` decode steps) timed through the
    kernels and, inside the ``plain`` context, through their plain
    versions, in turns (plain, then kernels); each run through
    the kernels must launch them as ``expect`` says.  Returns the wall
    seconds of each turn and the harvested trajectories."""
    import numpy as np
    from repro_torch.launch import serve
    model, params = sched.model, sched.params

    def run():
        sync(torch)
        t0 = time.perf_counter()
        ts = serve.trajectories_from_model(model, params, n, prompt_len,
                                           max_new, 8, SEED)
        sync(torch)
        return time.perf_counter() - t0, ts

    walls = {"kernels": [], "plain": []}
    for turn in ("plain", "kernels"):
        zero_launches()
        if turn == "plain":
            with plain():
                wall, _ = run()
        else:
            wall, ts = run()
            launches = read_launches()
            got = {k: launches[k] for k in expect}
            if got != expect:
                raise AssertionError(f"harvest launches {launches}, "
                                     f"expected {expect}")
        walls[turn].append(wall)
    if not np.isfinite(ts.phis).all():
        raise AssertionError("harvested step embeddings are not finite")
    return walls, ts


def phase_harvest(torch, sched, n: int = 24, prompt_len: int = 16,
                  max_new: int = 96):
    """The driver's harvest timed through K7 and K6, then through their
    plain versions, in turns: K7 launches once a layer, K6 once a layer a
    step."""
    layers = sched.model.cfg.n_layers
    walls, ts = harvest_turns(
        torch, sched, PlainDenseAttention,
        {"flash_attention": layers, "flash_decode": layers * max_new}, n,
        prompt_len, max_new)
    res = dict(phase="harvest", trajectories=n, prompt=prompt_len,
               decode_steps=max_new, wall_s=walls,
               k6_launches=layers * max_new, k7_launches=layers,
               phis_shape=list(ts.phis.shape))
    emit(res)
    return res


def phase_serve_dense(torch, paged, paged_out, requests: int = 8):
    """The driver without ``--paged``: a dense fleet of ``requests`` on 4
    slots.  K1 and K6 launch every engine step (K6 once a layer), K7 once
    a layer for the harvest and for each admission, K2 never; the fleet
    line beside the paged fleet's (``paged``, phase serve's record, and
    ``paged_out``, its driver result) and, in bf16, how far the two
    fleets' tokens agree (not asserted: the two attention kernels sum in
    other orders and bf16 flips near-ties)."""
    res, out = serve_fleet(
        torch, phase="serve-dense", requests=requests, paged=False,
        need=("serving_probe_step", "flash_decode", "flash_attention"))
    layers = out.scheduler.model.cfg.n_layers
    fleet = out.fleet
    lc = res["launches"]
    harvest_steps = 96
    want = dict(paged_flash_decode=0,
                flash_decode=layers * (harvest_steps + fleet.engine_steps),
                flash_attention=layers * (1 + requests))
    got = {k: lc[k] for k in want}
    if got != want:
        raise AssertionError(f"dense fleet launches {got}, expected {want} "
                             f"(K6 once a layer in each of the harvest's "
                             f"{harvest_steps} steps and the fleet's "
                             f"{fleet.engine_steps}; K7 once a layer for "
                             f"the harvest and each admission; K2 never)")
    ref = paged_out.requests
    bad = [(r, b) for r, b in zip(out.requests, ref) if r.tokens != b.tokens]
    res.update(
        step_ms=fleet.wall_time_s / fleet.engine_steps * 1e3,
        k6_launches_per_step=layers,
        paged_fleet=dict(engine_steps=paged["engine_steps"],
                         tokens_per_s=paged["tokens_per_s"],
                         step_ms=paged["serve_wall_s"]
                         / paged["engine_steps"] * 1e3,
                         stop_steps=paged["stop_steps"]),
        tokens_agree_with_paged=f"{len(ref) - len(bad)}/{len(ref)}",
        first_divergence=(first_divergence(
            torch, out.scheduler.model, out.scheduler.params, *bad[0],
            names=("dense", "paged")) if bad else None))
    emit(res)
    return res, out


def phase_dense_stops(torch, sched, requests: int = 8, prompt_len: int = 16):
    """The serve fleet in float32, cut to its first ``SPEC_F32_LAYERS``
    layers (full width), through ``OrcaScheduler``, dense and paged, at a
    lambda* between its scores (phase serve-spec-f32's machinery): the
    dense fleet (K6 and K7) stops every request where the paged fleet (K2
    and K7) does, with the same tokens."""
    from repro_torch.launch import serve
    from repro_torch.serving import OrcaScheduler, ServeConfig, make_request
    model32, params32 = f32_cut(sched, SPEC_F32_LAYERS,
                                kv_cache_dtype="float32")
    batch = serve.model_inputs(model32.cfg,
                               torch.Generator().manual_seed(SEED + 1),
                               requests, prompt_len)
    base = dict(n_slots=4, tokens_per_step=8, max_new_tokens=96, burn_in=2)

    def fleet(lam, paged):
        zero_launches()
        t0 = time.perf_counter()
        done, fl = OrcaScheduler(model32, params32, sched.pc, sched.theta,
                                 ServeConfig(lam=lam, paged=paged, **base)
                                 ).run([make_request(t)
                                        for t in batch["tokens"]])
        sync(torch)
        return done, fl, time.perf_counter() - t0, read_launches()

    free, _, _, _ = fleet(2.0, True)
    lam, margin = choose_lambda([r.scores for r in free], base["burn_in"])
    if margin < 1e-4:
        raise AssertionError(f"every threshold lies within {margin} of a "
                             "score: the check would hang on a tie")
    paged, paged_fl, paged_s, paged_l = fleet(lam, True)
    dense, dense_fl, dense_s, dense_l = fleet(lam, False)
    stops = [r.stop_step for r in paged]
    if [r.stop_step for r in dense] != stops:
        raise AssertionError(f"f32 dense stops {[r.stop_step for r in dense]}"
                             f" differ from paged stops {stops}")
    if [r.tokens for r in dense] != [r.tokens for r in paged]:
        raise AssertionError("f32 dense tokens differ from paged tokens")
    if dense_l["paged_flash_decode"] or not (dense_l["flash_decode"]
                                             and dense_l["flash_attention"]):
        raise AssertionError(f"f32 dense fleet launches {dense_l}")
    res = dict(phase="serve-dense-f32", layers=model32.cfg.n_layers, lam=lam,
               lambda_margin=margin,
               stop_steps=stops, stopped=sum(s >= 0 for s in stops),
               paged=dict(engine_steps=paged_fl.engine_steps, wall_s=paged_s,
                          tokens_per_s=paged_fl.tokens_per_s,
                          launches=paged_l),
               dense=dict(engine_steps=dense_fl.engine_steps, wall_s=dense_s,
                          tokens_per_s=dense_fl.tokens_per_s,
                          launches=dense_l))
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phases serve-group and group-stops-f32: self-consistency groups and the
# consensus stop (K1, K2 and K7 on cancelled state)

GROUP_SIZE = 4
GROUP_REQUESTS = 2


def phase_serve_group(torch):
    """The driver with ``--group-size 4 --requests 2``: phase serve's
    fleet otherwise (smollm-360m, bf16, full width and depth, paged, 4
    slots, 96 new tokens, 8 tokens a step, burn-in 2), with its own
    harvest, fit, lambda* and the consensus calibration (g*).  Every sample
    ends; each group decides, and each sample its own ORCA stop did not
    stop is CANCELLED at the group's consensus step; the cancelled count,
    the pages freed at cancel and the 6 prefill skips (siblings share the
    first sample's prompt pages); the pool drains; K1 once an engine step,
    K2 once a layer a step, K6 once a layer a harvest step, and K7 once a
    layer for the harvest and once for each group's first sample only."""
    res, out = serve_fleet(torch, phase="serve-group",
                           requests=GROUP_REQUESTS, need=SERVE_NEED,
                           group_size=GROUP_SIZE, cancelled=True)
    sched, fleet = out.scheduler, out.fleet
    layers = sched.model.cfg.n_layers
    harvest_steps = 96
    groups = out.groups
    if len(groups) != GROUP_REQUESTS:
        raise AssertionError(f"{len(groups)} groups served")
    for g in groups:
        if not g.decided:
            raise AssertionError(f"group {g.group_id} never decided")
        for r in g.requests:
            if r.state.value == "stopped":
                continue
            if r.state.value != "cancelled" \
                    or r.completed_step != g.consensus_step:
                raise AssertionError(
                    f"group {g.group_id} sample {r.sample_idx}: "
                    f"{r.state.value} at {r.completed_step}, consensus at "
                    f"{g.consensus_step}")
    n_cancelled = sum(r.state.value == "cancelled" for r in out.requests)
    if fleet.samples_cancelled != n_cancelled:
        raise AssertionError(f"samples_cancelled {fleet.samples_cancelled}, "
                             f"{n_cancelled} cancelled")
    if fleet.cancel_freed_blocks < 1 or fleet.prefill_skips != \
            GROUP_REQUESTS * (GROUP_SIZE - 1):
        raise AssertionError(f"{fleet.cancel_freed_blocks} pages freed at "
                             f"cancel, {fleet.prefill_skips} prefill skips")
    lc = res["launches"]
    want = dict(serving_probe_step=fleet.engine_steps,
                paged_flash_decode=layers * fleet.engine_steps,
                flash_decode=layers * harvest_steps,
                flash_attention=layers * (1 + GROUP_REQUESTS))
    got = {k: lc[k] for k in want}
    if got != want:
        raise AssertionError(f"serve-group launches {got}, expected {want} "
                             "(K7 once a layer for the harvest and for each "
                             "group's first sample: siblings never prefill)")
    res.update(
        g_star=sched.consensus.lam, group_size=GROUP_SIZE,
        groups=[dict(group_id=g.group_id, consensus_step=g.consensus_step,
                     consensus_index=g.consensus_index,
                     consensus_answer=g.consensus_answer,
                     consensus_agreement=g.consensus_agreement,
                     n_cancelled=g.n_cancelled) for g in groups],
        samples_cancelled=fleet.samples_cancelled,
        consensus_groups=fleet.consensus_groups,
        consensus_steps=fleet.consensus_steps,
        group_savings=fleet.group_savings,
        group_savings_mean=fleet.group_savings_mean,
        cancel_freed_blocks=fleet.cancel_freed_blocks,
        prefill_skips=fleet.prefill_skips,
        peak_blocks_in_use=fleet.peak_blocks_in_use,
        step_ms=fleet.wall_time_s / fleet.engine_steps * 1e3)
    emit(res)
    return res, out


def consensus_traces(scores, answers, group_size):
    """Each group's offline vote (``consensus_trace``) over the ungrouped
    fleet's per-request scores and answers, consecutive requests forming a
    group: [(answer_t, agreement_t, lengths)] per group."""
    import numpy as np
    from repro_torch.core import stopping as S
    out = []
    for g0 in range(0, len(scores), group_size):
        rows = range(g0, g0 + group_size)
        lengths = np.array([len(scores[i]) for i in rows])
        t = int(lengths.max())
        sc = np.zeros((group_size, t))
        an = np.zeros((group_size, t), np.int64)
        for j, i in enumerate(rows):
            sc[j, :lengths[j]] = scores[i]
            an[j, :lengths[j]] = answers[i]
        ans_t, agr_t = S.consensus_trace(sc, an, lengths)
        out.append((ans_t, agr_t, lengths))
    return out


def choose_consensus(traces, burn_in):
    """A consensus threshold between the agreements the served check reads
    (every step from the burn-in on), as far as it can get from each;
    thresholds that fire some groups and not others first (``choose_lambda``'s
    pattern).  Returns (threshold, its distance to the nearest agreement,
    whether it splits the groups)."""
    tested = sorted({float(a) for _, agr, _ in traces
                     for a in agr[burn_in:]})
    best = None
    for lo, hi in zip(tested, tested[1:]):
        thr = (lo + hi) / 2
        fired = sum(bool((agr[burn_in:] >= thr).any())
                    for _, agr, _ in traces)
        key = (0 < fired < len(traces), fired > 0, hi - lo)
        if best is None or key > best[0]:
            best = (key, thr, (hi - lo) / 2)
    if best is None:
        raise AssertionError(f"one agreement only: {tested}")
    return best[1], best[2], best[0][0]


def phase_group_stops(torch, sched, requests: int = 8, prompt_len: int = 16):
    """The consensus decisions on the card.  Serve's weights in float32,
    cut to ``DENSE_F32_LAYERS`` layers (full width), on f32 pages, with
    serve's probe; serve-dense-f32's 8 distinct 16-token prompts, grouped
    2 x 4 by ``group_id``/``sample_idx`` (distinct prompts: no pages
    shared, the votes differ).  Per-sample stopping off (lambda 2.0) and
    prefill at admission, so a group's samples advance in lockstep.  The
    fleet served ungrouped gives each group's offline vote
    (``consensus_trace``) and a threshold far from every agreement read
    (``choose_consensus``); the grouped fleet, served through the kernels
    and under ``PlainAttention``, decides each group where
    ``consensus_stop_times`` says (the contract of the JAX suite's
    ``test_served_consensus_matches_offline_trace``), and both runs cancel
    the same samples, emit the same tokens and free the same pages; K2
    launches only in the kernel run."""
    from repro_torch.core import stopping as S
    from repro_torch.core.calibrator import GroupCalibrator
    from repro_torch.launch import serve
    from repro_torch.serving import OrcaScheduler, ServeConfig, make_request
    t0 = time.perf_counter()
    model32, params32 = f32_cut(sched, DENSE_F32_LAYERS,
                                kv_cache_dtype="float32")
    batch = serve.model_inputs(model32.cfg,
                               torch.Generator().manual_seed(SEED + 1),
                               requests, prompt_len)
    base = dict(n_slots=4, paged=True, tokens_per_step=8, max_new_tokens=96,
                burn_in=2, lam=2.0)

    def fleet(grouped, consensus=None):
        zero_launches()
        t1 = time.perf_counter()
        reqs = [make_request(tok, group_id=(i // GROUP_SIZE if grouped
                                            else None),
                             sample_idx=(i % GROUP_SIZE if grouped else 0))
                for i, tok in enumerate(batch["tokens"])]
        s = OrcaScheduler(model32, params32, sched.pc, sched.theta,
                          ServeConfig(group_size=GROUP_SIZE if grouped
                                      else 1, **base), consensus=consensus)
        done, fl = s.run(reqs)
        sync(torch)
        s.pool.check()
        if s.pool.blocks_in_use:
            raise AssertionError(f"{s.pool.blocks_in_use} pages in use")
        return s, done, fl, time.perf_counter() - t1, read_launches()

    _, free, free_fl, free_s, _ = fleet(False)
    traces = consensus_traces([r.scores for r in free],
                              [r.answers for r in free], GROUP_SIZE)
    thr, margin, split = choose_consensus(traces, base["burn_in"])
    if margin < 1e-4:
        raise AssertionError(f"every threshold lies within {margin} of an "
                             "agreement: the check would hang on a tie")
    runs = {}
    for name in ("kernels", "plain"):
        gc = GroupCalibrator(min_votes=2, burn_in=base["burn_in"], lam=thr)
        if name == "plain":
            with PlainAttention():
                runs[name] = fleet(True, gc)
        else:
            runs[name] = fleet(True, gc)
    decisions = []
    for name, (s, done, fl, _, lc) in runs.items():
        for g, (ans_t, agr_t, lengths) in zip(s.groups, traces):
            tau = int(S.consensus_stop_times(agr_t, [thr],
                                             burn_in=base["burn_in"])[0])
            fires = tau < int(lengths.max())
            got = (g.decided, g.consensus_index, g.consensus_answer)
            want = (fires, tau if fires else -1,
                    int(ans_t[tau]) if fires else -1)
            if got != want:
                raise AssertionError(f"{name}: group {g.group_id} decided "
                                     f"{got}, offline {want}")
            if name == "kernels":
                decisions.append(dict(
                    group_id=g.group_id, decided=g.decided,
                    consensus_step=g.consensus_step,
                    consensus_index=g.consensus_index,
                    consensus_answer=g.consensus_answer,
                    consensus_agreement=g.consensus_agreement,
                    agreements=[float(a) for a in agr_t]))
        if (lc["paged_flash_decode"] > 0) != (name == "kernels"):
            raise AssertionError(f"{name} run K2 launches: {lc}")
    (_, k_done, k_fl, k_s, k_lc), (_, p_done, p_fl, p_s, _) = \
        runs["kernels"], runs["plain"]
    if [r.state for r in k_done] != [r.state for r in p_done] \
            or [r.tokens for r in k_done] != [r.tokens for r in p_done] \
            or k_fl.cancel_freed_blocks != p_fl.cancel_freed_blocks:
        raise AssertionError("the kernel and plain grouped fleets differ in "
                             "cancellations, tokens or pages freed")
    res = dict(phase="group-stops-f32", layers=model32.cfg.n_layers,
               threshold=thr, threshold_margin=margin, split=split,
               fired=sum(d["decided"] for d in decisions),
               groups=decisions,
               states=[r.state.value for r in k_done],
               samples_cancelled=k_fl.samples_cancelled,
               cancel_freed_blocks=k_fl.cancel_freed_blocks,
               group_savings=k_fl.group_savings,
               ungrouped=dict(engine_steps=free_fl.engine_steps,
                              wall_s=free_s),
               kernels=dict(engine_steps=k_fl.engine_steps, wall_s=k_s,
                            launches=k_lc),
               plain=dict(engine_steps=p_fl.engine_steps, wall_s=p_s),
               seconds=time.perf_counter() - t0)
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phases serve-fleet and fleet-stops-f32: the FleetRouter's simulated hosts,
# each stepping on its own CUDA stream from its own thread

FLEET_HOSTS = 2
FLEET_REQUESTS = 8
# fleet-stops-f32's layers (F32_LAYERS, 4, until the training phases):
# its placements and hosts do not depend on depth
FLEET_F32_LAYERS = 2


class Tee:
    """Within the block, what is printed to stdout is also kept (``text``)."""

    def __enter__(self):
        self.out, self.parts = sys.stdout, []
        sys.stdout = self
        return self

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def __exit__(self, *exc):
        sys.stdout = self.out

    @property
    def text(self) -> str:
        return "".join(self.parts)


def percentiles(ms):
    import numpy as np
    a = np.asarray(ms, np.float64)
    return dict(steps=int(a.size), mean=float(a.mean()),
                p50=float(np.percentile(a, 50)),
                p99=float(np.percentile(a, 99)))


def phase_serve_fleet(torch):
    """The driver with ``--hosts 2 --placement pressure``: serve's traffic
    (smollm-360m, bf16, full width, paged, 8 requests, 4 slots a host, 96
    new tokens; ``main`` runs it at 8 of its 32 layers) through a
    FleetRouter whose two hosts step in parallel, each on its own CUDA
    stream.  Every request ends, both hosts
    serve, each host's pool checks and drains, the driver prints its
    ``[serve] fleet:`` and ``[serve] routing:`` lines, and the launches
    are exact: K1 once a host step, K2 once a layer a host step, K6 once a
    layer a harvest step, K7 once a layer for the harvest and each
    admission.  Then the same prompts on the driver's weights, probe and
    lambda* through ``api.fleet`` stepping serially: its tokens and stops
    equal the parallel run's bit for bit (bf16), its launches are exact,
    and the record holds both runs' fleet step wall (p50, p99) and the
    serial run's peak memory above what was allocated before it.
    ``tools/fleet_overlap.py`` measures the threads' overlap, the busy
    share and one host with all the slots."""
    import numpy as np
    from repro_torch import api as orca
    from repro_torch.serving import FleetRouter
    with Tee() as tee:
        res, out = serve_fleet(torch, ("--hosts", str(FLEET_HOSTS),
                                       "--placement", "pressure"),
                               phase="serve-fleet", requests=FLEET_REQUESTS,
                               need=SERVE_NEED)
    router, fleet = out.scheduler, out.fleet
    if not isinstance(router, FleetRouter) or router.n_hosts != FLEET_HOSTS \
            or not router.parallel_hosts:
        raise AssertionError(f"the driver served through {router!r}")
    streams = [s.cuda_stream for s in router._streams] if DEV == "cuda" \
        else []
    if DEV == "cuda" and (len(set(streams)) != FLEET_HOSTS
                          or torch.cuda.current_stream().cuda_stream
                          in streams):
        raise AssertionError(f"host streams {streams}: not one a host")
    lines = tee.text.splitlines()
    for prefix in (f"[serve] fleet: {FLEET_HOSTS} hosts x 4 slots, "
                   "placement=pressure",
                   f"[serve] routing: {FLEET_HOSTS} hosts, "):
        if not any(ln.startswith(prefix) for ln in lines):
            raise AssertionError(f"the driver printed no {prefix!r} line")
    if sorted({r.host for r in out.requests}) != list(range(FLEET_HOSTS)):
        raise AssertionError(f"hosts {[r.host for r in out.requests]}")
    host_steps = [m.engine_steps for m in router.host_metrics]
    layers = router.model.cfg.n_layers
    want = dict(serving_probe_step=sum(host_steps),
                paged_flash_decode=layers * sum(host_steps),
                flash_decode=layers * 96,
                flash_attention=layers * (1 + FLEET_REQUESTS))
    got = {k: res["launches"][k] for k in want}
    if got != want:
        raise AssertionError(f"serve-fleet launches {got}, expected {want} "
                             f"(host steps {host_steps})")
    params = router.hosts[0].params
    prompts = np.stack([r.inputs["tokens"][0] for r in out.requests])
    weights_gib = sum(t.numel() * t.element_size()
                      for t in _leaves(params)) / 2 ** 30
    router.close()

    # the same prompts served serially on the driver's weights, probe and
    # lambda*: the same hosts run the same batches, so bit for bit in bf16
    zero_launches()
    start = 0
    if DEV == "cuda":
        sync(torch)
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    server = orca.fleet(router.model, params, out.calibrator,
                        config=router.cfg, n_hosts=FLEET_HOSTS,
                        parallel_hosts=False)
    done, fl = orca.serve_requests(server, prompts)
    sync(torch)
    secs = time.perf_counter() - t0
    lc = read_launches()
    steps = sum(m.engine_steps for m in server.host_metrics)
    if lc["serving_probe_step"] != steps \
            or lc["paged_flash_decode"] != layers * steps:
        raise AssertionError(f"serial fleet: launches {lc}, {steps} host "
                             "steps")
    if [r.stop_step for r in done] != res["stop_steps"] \
            or [r.tokens for r in done] != [r.tokens for r in out.requests]:
        raise AssertionError("the serial fleet's stops or tokens differ "
                             "from the parallel driver's")
    serial = dict(
        hosts=FLEET_HOSTS, parallel=False, slots_per_host=server.n_slots,
        wall_s=secs, engine_steps=fl.engine_steps, host_steps=steps,
        step_ms=percentiles(server.step_ms), tokens_per_s=fl.tokens_per_s,
        requests_per_s=fl.requests_per_s, same_as_driver=True,
        peak_over_start_gib=((torch.cuda.max_memory_allocated() - start)
                             / 2 ** 30 if DEV == "cuda" else 0.0),
        per_host=[dict(engine_steps=m.engine_steps,
                       stall_ms_p50=m.stall_ms_p50,
                       stall_ms_p99=m.stall_ms_p99,
                       requests=sum(r.host == i for r in done))
                  for i, m in enumerate(server.host_metrics)])
    driver_step = percentiles(router.step_ms)
    res.update(host_steps=host_steps, routed_affine=fleet.routed_affine,
               streams=len(set(streams)), weights_gib=weights_gib,
               driver_step_ms=driver_step,
               driver_per_host=[dict(engine_steps=m.engine_steps,
                                     stall_ms_p50=m.stall_ms_p50,
                                     stall_ms_p99=m.stall_ms_p99)
                                for m in router.host_metrics],
               serial=serial,
               serial_over_parallel_p50=(serial["step_ms"]["p50"]
                                         / driver_step["p50"]))
    emit(res)
    return res, out


def phase_fleet_stops(torch, sched, requests: int = FLEET_REQUESTS,
                      prompt_len: int = 16):
    """serve-fleet's weights in f32, its first ``FLEET_F32_LAYERS`` layers
    (full width) on f32 pages, with its probe: 8 distinct prompts at a lambda*
    between the free fleet's scores, served by one 4-slot OrcaScheduler,
    by 2 hosts (pressure, parallel), 2 hosts (roundrobin, serial) and 3
    hosts (pressure, parallel): stops and tokens equal, K1 once a host
    step, every pool drained.  Prefix affinity: 4 requests of one prompt
    on 2 hosts of 4 slots land on one host under pressure (3 affine
    placements, 3 prefill skips, K7 for one cold prefill) and spread under
    roundrobin (2 skips, K7 for two), stops equal.  Gangs: a group of 4
    lands on one host, a group of 5 is refused."""
    from repro_torch.launch import serve
    from repro_torch.serving import (FleetRouter, OrcaScheduler, ServeConfig,
                                     make_group, make_request)
    t_start = time.perf_counter()
    model32, params32 = f32_cut(sched, FLEET_F32_LAYERS,
                                kv_cache_dtype="float32")
    layers = model32.cfg.n_layers
    pc, theta = sched.pc, sched.theta
    batch = serve.model_inputs(model32.cfg,
                               torch.Generator().manual_seed(SEED + 1),
                               requests, prompt_len)
    base = dict(n_slots=4, paged=True, tokens_per_step=8, max_new_tokens=96,
                burn_in=2)

    def serve_once(lam, reqs, n_hosts=1, placement=None, parallel=True):
        zero_launches()
        t0 = time.perf_counter()
        cfg = ServeConfig(lam=lam, **base)
        server = (OrcaScheduler(model32, params32, pc, theta, cfg)
                  if n_hosts == 1 else
                  FleetRouter(model32, params32, pc, theta, cfg,
                              n_hosts=n_hosts, placement=placement,
                              parallel_hosts=parallel))
        done, fl = server.run(reqs)
        sync(torch)
        hosts = getattr(server, "hosts", [server])
        for h in hosts:
            h.pool.check()
            if h.pool.blocks_in_use:
                raise AssertionError(f"{h.pool.blocks_in_use} pages in use")
        lc = read_launches()
        steps = (sum(m.engine_steps for m in server.host_metrics)
                 if n_hosts > 1 else fl.engine_steps)
        if lc["serving_probe_step"] != steps:
            raise AssertionError(f"K1 {lc['serving_probe_step']} launches, "
                                 f"{steps} host steps")
        if n_hosts > 1:
            server.close()
        return done, fl, dict(hosts=n_hosts, placement=placement,
                              parallel=parallel and n_hosts > 1,
                              engine_steps=fl.engine_steps, host_steps=steps,
                              wall_s=time.perf_counter() - t0,
                              served_by=[r.host for r in done],
                              routed_affine=fl.routed_affine,
                              prefill_skips=fl.prefill_skips, launches=lc)

    def distinct():
        return [make_request(t) for t in batch["tokens"]]

    free, _, _ = serve_once(2.0, distinct())
    lam, margin = choose_lambda([r.scores for r in free], base["burn_in"])
    if margin < 1e-4:
        raise AssertionError(f"every threshold lies within {margin} of a "
                             "score: the check would hang on a tie")
    one, _, one_rec = serve_once(lam, distinct())
    stops = [r.stop_step for r in one]
    ways = {}
    for name, n_hosts, placement, parallel in (
            ("2_pressure_parallel", 2, "pressure", True),
            ("2_roundrobin_serial", 2, "roundrobin", False),
            ("3_pressure_parallel", 3, "pressure", True)):
        done, _, rec = serve_once(lam, distinct(), n_hosts, placement,
                                  parallel)
        if [r.stop_step for r in done] != stops \
                or [r.tokens for r in done] != [r.tokens for r in one]:
            raise AssertionError(f"fleet-stops-f32 {name}: stops "
                                 f"{[r.stop_step for r in done]} or tokens "
                                 f"differ from one host's {stops}")
        if sorted(set(rec["served_by"])) != list(range(n_hosts)):
            raise AssertionError(f"{name}: hosts {rec['served_by']}")
        ways[name] = rec
    prompt = batch["tokens"][0]
    affinity = {}
    for placement in ("pressure", "roundrobin"):
        done, fl, rec = serve_once(lam, [make_request(prompt)
                                         for _ in range(4)], 2, placement)
        affinity[placement] = (done, rec)
    (p_done, p_rec), (r_done, r_rec) = affinity["pressure"], \
        affinity["roundrobin"]
    if len(set(p_rec["served_by"])) != 1 or p_rec["routed_affine"] != 3 \
            or p_rec["prefill_skips"] != 3 \
            or p_rec["launches"]["flash_attention"] != layers:
        raise AssertionError(f"pressure affinity: {p_rec}")
    if len(set(r_rec["served_by"])) != 2 or r_rec["prefill_skips"] != 2 \
            or r_rec["launches"]["flash_attention"] != 2 * layers:
        raise AssertionError(f"roundrobin affinity: {r_rec}")
    if [r.stop_step for r in p_done] != [r.stop_step for r in r_done] \
            or [r.tokens for r in p_done] != [r.tokens for r in r_done]:
        raise AssertionError("affinity: stops or tokens differ by placement")
    gang, _, gang_rec = serve_once(lam, make_group(prompt, 4, group_id=0), 2,
                                   "pressure")
    if len(set(gang_rec["served_by"])) != 1:
        raise AssertionError(f"a gang split: {gang_rec['served_by']}")
    router = FleetRouter(model32, params32, pc, theta,
                         ServeConfig(lam=lam, **base), n_hosts=2)
    try:
        router.submit(make_group(prompt, 5, group_id=1))
    except ValueError as err:
        if "never split across hosts" not in str(err):
            raise
        refused = str(err)
    else:
        raise AssertionError("a group of 5 on hosts of 4 slots was placed")
    finally:
        router.close()
    res = dict(phase="fleet-stops-f32", layers=layers, lam=lam,
               lambda_margin=margin, stop_steps=stops,
               stopped=sum(s >= 0 for s in stops), one_host=one_rec,
               fleets=ways,
               affinity={k: v[1] for k, v in affinity.items()},
               affinity_stop_steps=[r.stop_step for r in p_done],
               gang=gang_rec, gang_of_5_refused=refused,
               seconds=time.perf_counter() - t_start)
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phase offline: the paper's procedure, fit -> evaluate

# benchmarks/common.py EPOCHS at the full corpus
EPOCHS = 35
# phase offline's epochs, cut from EPOCHS to keep the script within its
# time (10 until the hymba and whisper phases, 8 until the training
# phases); the epoch selection keeps the best of them (the no-QK probe's
# validation savings peaked at epoch 4 of 35 on the card)
OFFLINE_EPOCHS = 6


def plain_scores(torch, probe, ts):
    """``TrainedProbe.scores`` with K5's plain version in place of K5, on
    the same CUDA tensors: the same features, mask and smoothing."""
    import numpy as np
    from repro_torch.core import probe as P
    from repro_torch.kernels import ttt_scan as K5
    pc, theta = probe.pc, probe.theta
    with torch.no_grad():
        phis = torch.as_tensor(ts.phis, device=DEV)
        zq, zk = P.features(pc, theta, phis)
        n, T, f = zq.shape
        raw, _, _ = K5.ttt_probe_batched_plain(
            zq, zk, torch.zeros(n, T, device=DEV),
            torch.as_tensor(ts.mask, device=DEV).float(),
            theta["W0"].expand(n, f), theta["b0"].expand(n),
            P.inner_lr(pc, theta))
        s = P.smooth_scores(raw, pc.smooth_window)
    return s.cpu().numpy() * np.asarray(ts.mask)


def phase_offline(torch, splits, epochs: int = EPOCHS):
    """Table 2's supervised half on the synthetic corpus at d_phi 960: fit
    the TTT probe (no-QK and QK d_h 128, with the paper's epoch selection)
    and the static probe, then ``orca.evaluate`` at every delta.  K5 must
    launch in fit (epoch selection scores the validation slice each epoch)
    and in evaluate; evaluate rerun on scores from K5's plain version must
    give the same lambda*, savings and error."""
    import numpy as np
    from repro_torch import api as orca
    from repro_torch.core.pipeline import evaluate_probe
    from repro_torch.core.probe import ProbeConfig
    train, cal, test = splits
    methods = [
        ("ttt-noqk", "ttt", dict(pc=ProbeConfig(d_phi=D_PHI), epochs=epochs,
                                 epoch_select=True, seed=SEED)),
        ("ttt-qk128", "ttt", dict(pc=ProbeConfig(d_phi=D_PHI, variant="qk",
                                                 d_h=128), epochs=epochs,
                                  epoch_select=True, seed=SEED)),
        ("static", "static", {}),
    ]
    out = {}
    for name, method, kw in methods:
        zero_launches()
        t0 = time.perf_counter()
        calib = orca.fit(train, mode="supervised", method=method,
                         device=DEV, **kw)
        sync(torch)
        fit_s = time.perf_counter() - t0
        fit_launches = read_launches()["ttt_probe_batched"]
        zero_launches()
        t0 = time.perf_counter()
        ev = orca.evaluate(calib, cal, test, deltas=orca.DELTAS)
        eval_s = time.perf_counter() - t0
        eval_launches = read_launches()["ttt_probe_batched"]
        # lam None: LTT certified no threshold at this delta (never stop)
        rows = [dict(delta=r.delta, lam=r.lam if math.isfinite(r.lam)
                     else None, savings=r.savings, error=r.error)
                for r in ev.results]
        rec = dict(fit_s=fit_s, evaluate_s=eval_s, k5_launches_fit=
                   fit_launches, k5_launches_evaluate=eval_launches,
                   rows=rows)
        if method == "ttt":
            if fit_launches < epochs or eval_launches != 2:
                raise AssertionError(f"{name}: K5 launched {fit_launches} "
                                     f"times in fit, {eval_launches} in "
                                     "evaluate")
            kern = [calib.scores(ts) for ts in (cal, test)]
            plain = [plain_scores(torch, calib.probe, ts)
                     for ts in (cal, test)]
            rec["scores_max_abs_err"] = max(float(np.abs(a - b).max())
                                            for a, b in zip(kern, plain))
            rec["val_savings_by_epoch"] = [h["val_savings"]
                                           for h in calib.probe.history]
            ref = evaluate_probe(plain[0], cal, plain[1], test, calib.mode,
                                 orca.DELTAS, method=method)
            for a, b in zip(ev.results, ref.results):
                if (a.lam, a.savings, a.error) != (b.lam, b.savings,
                                                   b.error):
                    raise AssertionError(
                        f"{name} at delta {a.delta}: K5 gives ({a.lam}, "
                        f"{a.savings}, {a.error}), its plain version "
                        f"({b.lam}, {b.savings}, {b.error})")
        for r in rows:
            if not all(math.isfinite(r[k]) for k in ("savings", "error")):
                raise AssertionError(f"{name}: non-finite metrics {r}")
        out[name] = rec
    res = dict(phase="offline", data="synthetic corpus_splits(500, 170, "
               "170, d_phi=960), not the paper's data", epochs=epochs,
               epochs_cut=epochs < EPOCHS, mode="supervised", methods=out)
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phase serve-static: the static-batch baseline and the static probe

def phase_static_fleet(torch, sched, requests: int = 4):
    """The static baseline deployed: PCA + logreg fitted through
    ``api.fit(method="static")`` on trajectories harvested from the served
    model, flattened into a frozen no-QK probe (eta = 0) and served through
    ``api.engine`` on the same fused step: K1 must launch, and every slot's
    W must still equal W0 after every step."""
    import numpy as np
    from repro_torch import api as orca
    from repro_torch.launch import serve
    from repro_torch.serving import ServeConfig, make_request
    model, params = sched.model, sched.params
    ts = serve.trajectories_from_model(model, params, 8, 16, 96, 8,
                                       SEED + 3)
    half = len(ts) // 2
    train = ts.subset(np.arange(half))
    cal = ts.subset(np.arange(half, len(ts)))
    scal = orca.fit(train, mode="consistent", method="static", device=DEV)
    lam = orca.calibrated_lambda(scal, cal, 0.2, fallback=0.99)
    cfg = ServeConfig(n_slots=4, paged=True, tokens_per_step=8,
                      max_new_tokens=96, burn_in=2, lam=lam)
    fleet_sched = orca.engine(model, params, scal, config=cfg)
    gen = torch.Generator().manual_seed(SEED + 4)
    prompts = torch.randint(0, model.cfg.vocab_size, (requests, 16),
                            generator=gen, dtype=torch.int32)
    zero_launches()
    fleet_sched.submit([make_request(p.numpy()) for p in prompts])
    w0 = fleet_sched.theta["W0"]
    steps = 0
    while fleet_sched.step():
        steps += 1
        W = fleet_sched.engine.st.W
        if not torch.equal(W, w0.expand_as(W)):
            raise AssertionError(f"static fleet step {steps}: K1 moved a "
                                 "slot's W with eta = 0")
    done, fleet = fleet_sched.drain()
    launches = read_launches()
    if launches["serving_probe_step"] < 1:
        raise AssertionError(f"K1 never ran in the static fleet: "
                             f"{launches}")
    states = [r.state.value for r in done]
    if len(states) != requests or not set(states) <= {"stopped",
                                                      "finished"}:
        raise AssertionError(f"static fleet requests did not all end: "
                             f"{states}")
    res = dict(phase="serve-static-probe", lam=lam, eta=fleet_sched.pc.eta,
               steps_checked=steps, engine_steps=fleet.engine_steps,
               stop_steps=[r.stop_step for r in done],
               requests_per_s=fleet.requests_per_s,
               tokens_per_s=fleet.tokens_per_s, launches=launches)
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phases k8, model-rwkv, serve-rwkv, trace-rwkv and serve-rwkv-f32: RWKV6
# served through K8 (the WKV scan), K1 at f 2048 and K5

# K8 against its plain version: f32, the same per-element state recurrence
# with another summation order for out's dot over the 64 key channels;
# each within this share of the plain version's largest |value|
K8_RTOL = 1e-5
# (B, T): the served decode step, an admission, the harvest's prefill and
# decode steps, T not a multiple of the Pallas chunk (64), a long prefill;
# the timed ones
K8_CASES = ((4, 1, True), (1, 16, True), (24, 16, True), (24, 1, False),
            (1, 100, False), (1, 2048, True), (1, 512, True))
# T one below, at and one above the staged chunk (kernels/rwkv6_scan.py
# CHUNK_STEPS), at 4 column blocks (B 1) and at 1 (B 4)
K8_CHUNK_CASES = ((1, 31), (1, 32), (1, 33), (4, 33))
# r, k and v in bf16 (the served dtype, widened on load), timed beside
# the f32 rows of the same shape
K8_BF16_CASES = ((4, 1), (1, 16))
RWKV_ARCH = "rwkv6-1.6b"
# model-rwkv's bf16 check against the same run through the plain scan: the
# logit gap to the one-shot prefill within this multiple of the plain
# run's (plus one bf16 ulp), the mean argmax agreement (over 64 steps x 4
# rows) within this share of the plain run's
RWKV_BF16_FLOOR_MULT = 2.0
RWKV_BF16_AGREE_SLACK = 0.1


def k8_inputs(torch, gen, B, T, H, d, decay, s0_zero, rkv_dtype=None):
    """r, k, v ~ N(0, 1) (in ``rkv_dtype``, f32 by default); u small; w =
    exp(-exp(x)) with x around 2 ("near 0", w ~ 6e-4), 0 ("mid", w ~ 0.37)
    or -6 ("near 1", w ~ 0.9975); s0 zero or ~ N(0, 1)."""
    mean = {"near 0": 2.0, "mid": 0.0, "near 1": -6.0}[decay]
    r, k, v = (torch.randn(B, T, H, d, generator=gen).to(DEV, rkv_dtype)
               for _ in range(3))
    w = torch.exp(-torch.exp(mean + 0.5 * torch.randn(
        B, T, H, d, generator=gen))).to(DEV)
    u = (0.5 * torch.randn(H, d, generator=gen)).to(DEV)
    s0 = (torch.zeros(B, H, d, d) if s0_zero
          else torch.randn(B, H, d, d, generator=gen)).to(DEV)
    return r, k, v, w, u, s0


def k8_errs(got, want):
    """(max |got - want| / max |want|, max |got - want|) over out and
    state."""
    diffs = [(float((a - b).abs().max()), float(b.abs().max()))
             for a, b in zip(got, want)]
    return (max(d / max(m, 1e-30) for d, m in diffs),
            max(d for d, _ in diffs))


def k8_bytes_ops(B, T, H, d, rkv_bytes=4):
    """Each input read once (r, k, v at ``rkv_bytes`` an element, w, u,
    s0), each output written once (out, state); 7 f32 operations per state
    element a step (k v, u kv, + S, r att and its sum, w S + kv)."""
    n = B * T * H * d
    moved = 3 * rkv_bytes * n + 4 * (n + H * d + 2 * B * H * d * d + n)
    return moved, 7 * B * T * H * d * d


def k8_schedule(K8, B, T, H, rkv_dtype):
    """The launch's column split and staged chunk, and the instance's
    registers and shared memory as the library reports them."""
    n_col, chunk = K8.col_split(B, H), K8.chunk_steps(T)
    row = dict(n_col=n_col, chunk=chunk)
    if DEV == "cuda":
        cfg = K8.kernel_config(rkv_dtype, n_col, chunk)
        row.update(registers=cfg["registers"], local_bytes=cfg["local_bytes"],
                   smem_bytes=cfg["ring_bytes"] if T > chunk
                   else cfg["ring_bytes"] // 2)
    return row


def plain_wkv(K8):
    """K8's plain version behind the wrapper's signature."""
    def fn(r, k, v, w, u, s0, *, state_out=None):
        out, S = K8.wkv_scan_plain(r, k, v, w, u, s0)
        return (out, S) if state_out is None else (out, state_out.copy_(S))
    return fn


class CheckedK8:
    """K8 on the inputs the model gives it, each call held against the
    plain version on the same inputs (K8_RTOL), the state compared before
    the kernel overwrites it in place."""

    def __init__(self, K8):
        self.K8 = K8
        self.calls, self.err, self.abs_err, self.max_T = 0, 0.0, 0.0, 0

    def __call__(self, r, k, v, w, u, s0, *, state_out=None):
        want = self.K8.wkv_scan_plain(r, k, v, w, u, s0)
        got = self.K8.wkv_scan(r, k, v, w, u, s0, state_out=state_out)
        err, abs_err = k8_errs(got, want)
        if not err <= K8_RTOL:
            raise AssertionError(f"K8 in the model, call {self.calls} (B, T "
                                 f"= {tuple(r.shape[:2])}): relative err "
                                 f"{err}")
        self.calls += 1
        self.err = max(self.err, err)
        self.abs_err = max(self.abs_err, abs_err)
        self.max_T = max(self.max_T, r.shape[1])
        return got


class SwapWKV:
    """Within the block, the RWKV6 model's WKV scan runs ``impl`` instead
    of K8: by default K8's plain version (what the model computes without
    the kernel)."""

    def __init__(self, impl=None):
        self.impl = impl

    def __enter__(self):
        from repro_torch.kernels import rwkv6_scan as K8
        from repro_torch.models import rwkv6 as R
        self.served = R.wkv_kernel
        R.wkv_kernel = self.impl or plain_wkv(K8)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import rwkv6 as R
        R.wkv_kernel = self.served
        return False


def phase_k8(torch, timer):
    """K8 against its plain version at the path's shapes (H 32, d 64), with
    s0 zero and nonzero, w near 0, mid and near 1; T around the staged
    chunk; bf16 r, k and v; T = 100 split in two calls carrying the state,
    in place at 4 column blocks, and one call in place at 2; d = 32
    refused; timed beside the plain version with the byte/operation bound.
    Each row names its column split (n_col) and staged chunk."""
    from repro_torch.kernels import rwkv6_scan as K8
    gen = torch.Generator().manual_seed(SEED + 8)
    H, d = 32, 64
    rows, worst, worst_abs = [], 0.0, 0.0
    cases = ([(B, T, timed, torch.float32) for B, T, timed in K8_CASES]
             + [(B, T, False, torch.float32) for B, T in K8_CHUNK_CASES]
             + [(B, T, True, torch.bfloat16) for B, T in K8_BF16_CASES])
    for B, T, timed, dtype in cases:
        errs = {}
        for decay, s0_zero in (("mid", True), ("near 0", False),
                               ("near 1", False)):
            args = k8_inputs(torch, gen, B, T, H, d, decay, s0_zero, dtype)
            got = K8.wkv_scan(*args)
            want = K8.wkv_scan_plain(*args)
            sync(torch)
            if not all(torch.isfinite(t).all() for t in got):
                raise AssertionError(f"K8 ({B}, {T}) {decay}: not finite")
            rel, abs_err = k8_errs(got, want)
            errs[f"{decay}, s0 {'zero' if s0_zero else 'random'}"] = rel
            worst_abs = max(worst_abs, abs_err)
        row = dict(B=B, T=T, H=H, d=d, rkv=str(dtype).split(".")[-1],
                   **k8_schedule(K8, B, T, H, dtype), rel_err=errs,
                   tol=K8_RTOL)
        if max(errs.values()) > K8_RTOL:
            raise AssertionError(f"K8 ({B}, {T}) {row['rkv']} off its plain "
                                 f"version: {errs}")
        worst = max(worst, max(errs.values()))
        if timed:
            r, k, v, w, u, s0 = args
            row["ms"] = timer(lambda: K8.wkv_scan(r, k, v, w, u, s0))
            row["plain_ms"] = timer(lambda: K8.wkv_scan_plain(
                r, k, v, w, u, s0), reps=30 if T < 1000 else 3, warmup=1)
            moved, ops = k8_bytes_ops(B, T, H, d, r.element_size())
            row["bound_ms"], row["bound_by"] = bound_ms(moved, ops)
            row["bytes"], row["operations"] = moved, ops
            row["library_ms"] = None
        emit(dict(phase="k8", **row))
        rows.append(row)
    # the state carried across two calls equals one call's; and in place
    r, k, v, w, u, s0 = k8_inputs(torch, gen, 1, 100, H, d, "near 1", False)
    one = K8.wkv_scan(r, k, v, w, u, s0)
    cut = 37
    st = s0.clone()
    a, _ = K8.wkv_scan(r[:, :cut].contiguous(), k[:, :cut].contiguous(),
                       v[:, :cut].contiguous(), w[:, :cut].contiguous(), u,
                       st, state_out=st)
    b, _ = K8.wkv_scan(r[:, cut:].contiguous(), k[:, cut:].contiguous(),
                       v[:, cut:].contiguous(), w[:, cut:].contiguous(), u,
                       st, state_out=st)
    split = (torch.cat([a, b], dim=1), st)
    split_err, _ = k8_errs(split, one)
    if split_err > K8_RTOL:
        raise AssertionError(f"K8: two calls off one call by {split_err}")
    split_bitwise = all(torch.equal(x, y) for x, y in zip(split, one))
    # in place at 2 column blocks (B 2: 64 (row, head) pairs)
    r, k, v, w, u, s0 = k8_inputs(torch, gen, 2, 40, H, d, "mid", False)
    want = K8.wkv_scan_plain(r, k, v, w, u, s0)
    st = s0.clone()
    got = (K8.wkv_scan(r, k, v, w, u, st, state_out=st)[0], st)
    in_place_err, _ = k8_errs(got, want)
    if in_place_err > K8_RTOL:
        raise AssertionError(f"K8 in place at n_col {K8.col_split(2, H)}: "
                             f"{in_place_err}")
    try:
        K8.wkv_scan(*k8_inputs(torch, gen, 1, 2, 2, 32, "mid", False))
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("K8 took d = 32 on the card")
    res = dict(phase="k8-checks", split_at=cut, split_rel_err=split_err,
               split_bitwise=split_bitwise,
               split_n_col=K8.col_split(1, H),
               in_place_n_col=K8.col_split(2, H),
               in_place_rel_err=in_place_err, d32_refused=refused,
               max_rel_err=max(worst, split_err, in_place_err),
               max_abs_err=worst_abs)
    emit(res)
    return rows, res


def rwkv_teacher_forced(torch, model, params, prompt, feed, wkv):
    """Prefill the prompt, then decode the fed tokens one step at a time,
    with the model's WKV scan swapped for ``wkv``; then one prefill of
    prompt + feed, whose logits at the fed positions the decode steps
    must give.  Returns (decode logits per step, one-shot logits per
    step)."""
    cfg = model.cfg
    B, S = prompt.shape
    V = cfg.vocab_size
    with SwapWKV(wkv):
        state, _, _ = model.prefill(cfg, params, {"tokens": prompt}, 0)
        steps = []
        for t in range(feed.shape[0]):
            pos = torch.full((B,), S + t, dtype=torch.int32, device=DEV)
            lg, _, state = model.decode_step(cfg, params, feed[t], state, pos)
            steps.append(lg[:, :V].float())
        seq = torch.cat([prompt, feed.T], dim=1)
        _, _, h = model.prefill(cfg, params, {"tokens": seq}, 0)
        one = (h[:, S:] @ params["lm_head"].to(h.dtype))[..., :V].float()
    for t, lg in enumerate(steps):
        if not torch.isfinite(lg).all():
            raise AssertionError(f"rwkv: non-finite logits at step {t}")
    return steps, [one[:, t] for t in range(feed.shape[0])]


def phase_model_rwkv(torch, reduced: bool = False):
    """Full-width rwkv6-1.6b (bf16, random weights from a seed, then the
    same weights in f32): prefill 16 tokens, 32 teacher-forced decode
    steps through K8, every K8 call held against the plain version on its
    inputs; each step's logits against one prefill over the whole sequence
    (the JAX suite's ``test_model_consistency``).  In f32 every argmax is
    equal and the logits sit within 2^-10 of the largest.  In bf16 the
    same run through the plain scan gives the floor that K8's logit gap
    and argmax agreement are held to."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import rwkv6_scan as K8
    from repro_torch.models import build
    cfg = get_config(RWKV_ARCH)
    if reduced:
        cfg = cfg.reduced()
    model = build(cfg)
    gen = torch.Generator().manual_seed(SEED)
    params = model.init(gen, DEV)
    n_params = sum(t.numel() for t in _leaves(params))
    B, S, steps = 4, 16, 32
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           dtype=torch.int32).to(DEV)
    feed = torch.randint(0, cfg.vocab_size, (steps, B), generator=gen,
                         dtype=torch.int32).to(DEV)
    out = {}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    for name, mdl, prm in (("bf16", model, params),
                           ("f32", build(cfg32),
                            _tree(params, lambda t: t.float()))):
        checked = CheckedK8(K8)
        t0 = time.perf_counter()
        dec, one = rwkv_teacher_forced(torch, mdl, prm, prompt, feed,
                                          checked)
        sync(torch)
        diffs = [float((a - b).abs().max()) for a, b in zip(dec, one)]
        agree = [float((a.argmax(-1) == b.argmax(-1)).float().mean())
                 for a, b in zip(dec, one)]
        scale = max(float(b.abs().max()) for b in one)
        out[name] = dict(k8_calls=checked.calls, k8_rel_err=checked.err,
                         k8_abs_err=checked.abs_err,
                         k8_max_T=checked.max_T,
                         max_logit_diff_per_step=diffs,
                         argmax_agree_per_step=agree, max_abs_logit=scale,
                         wall_s=time.perf_counter() - t0)
    # bf16: decode (M = 4) and the one-shot prefill (M = 320) round their
    # matrix products to bf16 at other places, which a random-weight
    # 24-layer stack amplifies to a logit gap of ~0.2 from step 0 whatever
    # the scan.  The floor is that gap with both runs through the plain
    # scan; K8's gap at step t is held to RWKV_BF16_FLOOR_MULT x the
    # largest floor up to step t plus one bf16 ulp of the largest logit,
    # and its mean argmax agreement to the plain run's less
    # RWKV_BF16_AGREE_SLACK.  K8 itself is held per call by CheckedK8.
    dec, one = rwkv_teacher_forced(torch, model, params, prompt, feed,
                                   plain_wkv(K8))
    bf16 = out["bf16"]
    floor = [float((a - b).abs().max()) for a, b in zip(dec, one)]
    plain_agree = [float((a.argmax(-1) == b.argmax(-1)).float().mean())
                   for a, b in zip(dec, one)]
    ulp = bf16["max_abs_logit"] * 2.0 ** -8
    bound = [RWKV_BF16_FLOOR_MULT * max(floor[:t + 1]) + ulp
             for t in range(steps)]
    bf16.update(plain_logit_diff_per_step=floor,
                plain_argmax_agree_per_step=plain_agree, bound_per_step=bound)
    over = [t for t in range(steps)
            if bf16["max_logit_diff_per_step"][t] > bound[t]]
    if over:
        t = over[0]
        raise AssertionError(f"rwkv bf16 step {t}: K8's logits "
                             f"{bf16['max_logit_diff_per_step'][t]} from "
                             f"the one-shot prefill > {bound[t]} (plain "
                             f"scan's gap {max(floor[:t + 1])})")
    k8_mean = sum(bf16["argmax_agree_per_step"]) / steps
    plain_mean = sum(plain_agree) / steps
    if k8_mean < plain_mean - RWKV_BF16_AGREE_SLACK:
        raise AssertionError(f"rwkv bf16: K8's argmax agreement {k8_mean} "
                             f"< the plain scan's {plain_mean} less "
                             f"{RWKV_BF16_AGREE_SLACK}")
    # f32: the decode steps and the one-shot prefill run the same
    # recurrence with other matrix shapes (M = 4 against M = 320), so they
    # differ by f32 rounding amplified through 24 random-weight layers;
    # 2^-10 of the largest logit leaves orders of magnitude of room
    f32 = out["f32"]
    f32["bound"] = f32["max_abs_logit"] * 2.0 ** -10
    if min(f32["argmax_agree_per_step"]) < 1.0:
        raise AssertionError("rwkv f32: a decode step's argmax differs from "
                             "the one-shot prefill's")
    if max(f32["max_logit_diff_per_step"]) > f32["bound"]:
        raise AssertionError(f"rwkv f32: logits "
                             f"{max(f32['max_logit_diff_per_step'])} from "
                             f"the one-shot prefill > {f32['bound']}")
    calls = cfg.n_layers * (2 + steps)
    for name in out:
        if out[name]["k8_calls"] != calls:
            raise AssertionError(f"rwkv {name}: {out[name]['k8_calls']} K8 "
                                 f"calls, expected {calls}")
    res = dict(phase="model-rwkv", arch=cfg.name, layers=cfg.n_layers,
               d_model=cfg.d_model, heads=cfg.n_heads,
               head_dim=cfg.ssm.head_dim, d_ff=cfg.d_ff,
               vocab=cfg.vocab_size, params=n_params, batch=B, prompt=S,
               decode_steps=steps, **out)
    emit(res)
    return res


RWKV_NEED = ("serving_probe_step", "wkv_scan", "ttt_probe_batched")
# serve-rwkv-f32's depth: 4 of rwkv6-1.6b's 24 layers (full width), cut to
# keep the script within its time
RWKV_F32_LAYERS = 4
RWKV_NEVER = ("paged_flash_decode", "paged_flash_prefill_chunk",
              "paged_flash_packed_chunk", "serving_probe_spec_step",
              "flash_decode", "flash_attention")


def phase_serve_rwkv(torch, requests: int = 8, harvest: int = 24,
                     harvest_steps: int = 96):
    """``launch.serve --arch rwkv6-1.6b``: the serve fleet (8 requests on
    4 slots, 16-token prompts, 96 new tokens, 24 harvested trajectories) on
    the recurrent state.  K1, K8 and K5 launch; K8 once a layer for the
    harvest's prefill, each of its decode steps, each admission and each
    engine step; no attention kernel and no K4."""
    res, out = serve_fleet(torch, phase="serve-rwkv", requests=requests,
                           need=RWKV_NEED, paged=False, arch=RWKV_ARCH)
    layers = out.scheduler.model.cfg.n_layers
    fleet = out.fleet
    lc = res["launches"]
    want = layers * (1 + harvest_steps + requests + fleet.engine_steps)
    if lc["wkv_scan"] != want:
        raise AssertionError(f"K8 launched {lc['wkv_scan']} times, expected "
                             f"{want} = {layers} x (1 harvest prefill + "
                             f"{harvest_steps} harvest steps + {requests} "
                             f"admissions + {fleet.engine_steps} engine "
                             f"steps)")
    ran = [k for k in RWKV_NEVER if lc[k]]
    if ran:
        raise AssertionError(f"{ran} launched in the RWKV fleet: {lc}")
    res.update(step_ms=fleet.wall_time_s / fleet.engine_steps * 1e3,
               k8_launches_expected=want, k8_launches_per_step=layers,
               params=sum(t.numel() for t in _leaves(out.scheduler.params)))
    emit(res)
    return res, out


def phase_harvest_rwkv(torch, sched, n: int = 24, prompt_len: int = 16,
                       max_new: int = 96):
    """The RWKV driver's harvest timed through K8 and through the plain
    scan, in turns: K8 once a layer for the prefill and once a layer a
    decode step."""
    layers = sched.model.cfg.n_layers
    walls, ts = harvest_turns(torch, sched, SwapWKV,
                              {"wkv_scan": layers * (1 + max_new)}, n,
                              prompt_len, max_new)
    res = dict(phase="harvest-rwkv", trajectories=n, prompt=prompt_len,
               decode_steps=max_new, wall_s=walls,
               k8_launches=layers * (1 + max_new),
               phis_shape=list(ts.phis.shape))
    emit(res)
    return res


# ---------------------------------------------------------------------------
# hymba-1.5b and whisper-tiny: no page layout, chunk or verify path (as in
# the JAX registry); their attention is K7's prefill and K6's decode

HYMBA_ARCH, WHISPER_ARCH = "hymba-1.5b", "whisper-tiny"
# serve-hymba's traffic: 1,000-token prompts (1,128 positions with the meta
# tokens: K7's window masks and the decode ring wraps), 4 requests on 4
# slots, 48 new tokens, a harvest of 8; serve-whisper's: 8 requests of
# 1,500 seeded frames, 96 new tokens, a harvest of 24
HYMBA_PROMPT, HYMBA_REQUESTS, HYMBA_NEW, HYMBA_HARVEST = 1000, 4, 48, 8
WHISPER_REQUESTS, WHISPER_NEW, WHISPER_HARVEST = 8, 96, 24
# serve-whisper-f32's depth: the first 2 of its 4 encoder and 2 of its 4
# decoder layers.  At full depth the random weights' std of 1/sqrt(4) (the
# fan-in rule reads the stacked layer axis) make the f32 model chaotic:
# replayed against float64 (tools/whisper_f32_witness.py), the kernels'
# and the plain path's logits both sit up to 0.45 from it (0.035 median;
# the top logits near 1.5), and each of the 4 requests the two fleets
# parted on parted at a near-tie of float64 (its two tokens 0.029 to 0.114
# apart), float64 siding with the plain path twice, the kernels once and
# neither once, while each K6 and K7 call sat within 1.13x of its plain
# version's distance from float64; at 2 and 2 no request parts (PERF.md
# §6, PR 32)
WHISPER_F32_LAYERS = 2
# the f32 evaluation's logits bound in units of the reversal's spread: on
# the card whisper's kernels sat at up to 2.7x the spread and the plain
# path in bf16 at 46x or more (PERF.md §6, PR 32), so 8 tells the two apart
F32_SPREAD_FACTOR = 8
# trace-hymba's window: 4 engine steps (a step runs some 5,700 kernels,
# and the profiler's events of 8 took most of the phase's 28.7 s)
HYMBA_TRACE_STEPS = 4
# the kernels these fleets launch, and those they never may
FAMILY_NEED = ("serving_probe_step", "flash_decode", "flash_attention",
               "ttt_probe_batched")
FAMILY_NEVER = ("paged_flash_decode", "paged_flash_prefill_chunk",
                "paged_flash_packed_chunk", "serving_probe_spec_step",
                "wkv_scan")


def family_inputs(torch, cfg, B, prompt_len, seed):
    """The driver's inputs on the card: prompt tokens, and whisper's
    frames (N(0, 1) x 0.02)."""
    from repro_torch.launch import serve
    batch = serve.model_inputs(cfg, torch.Generator().manual_seed(seed), B,
                               prompt_len)
    return {k: torch.as_tensor(v).to(DEV) for k, v in batch.items()}


def family_teacher_forced(torch, model, params, batch, feed, impls):
    """Prefill ``batch`` and decode the fed tokens from the request's
    decode start (past the meta tokens for hymba, 0 for whisper), once per
    (decode, prefill) attention pair in ``impls`` (the model's
    ``flash_decode`` and ``flash_attention`` swapped for it).  Returns
    each pair's (logits per step, final state)."""
    from repro_torch.models import attention as A
    from repro_torch.serving.engine import decode_start, prefix_len
    cfg = model.cfg
    B, P = batch["tokens"].shape
    pos0 = decode_start(cfg, batch, P)
    cache_len = prefix_len(cfg, batch, P) + feed.shape[0]
    served = A.flash_decode, A.flash_attention
    runs = []
    try:
        for dec, pre in impls:
            A.flash_decode, A.flash_attention = dec, pre
            state, _, _ = model.prefill(cfg, params, batch, cache_len)
            logits = []
            for t in range(feed.shape[0]):
                pos = torch.full((B,), pos0 + t, dtype=torch.int32,
                                 device=DEV)
                lg, _, state = model.decode_step(cfg, params, feed[t], state,
                                                 pos)
                lg = lg[:, :cfg.vocab_size].float()
                if not torch.isfinite(lg).all():
                    raise AssertionError(f"{cfg.name}: non-finite logits at "
                                         f"step {t}")
                logits.append(lg)
            runs.append((logits, state))
    finally:
        A.flash_decode, A.flash_attention = served
    return runs


def decode_reversed(q, k, v, valid, *, return_partials=False):
    """K6's plain version over the cache positions in reverse order: the
    same function, its sums in another order."""
    from repro_torch.kernels import flash_decode as K6
    return K6.flash_decode_plain(q, k.flip(2), v.flip(2), valid.flip(1),
                                 return_partials=return_partials)


def prefill_reversed(q, k, v, *, causal=True, window=None):
    """K7's plain version (``attn_prefill_einsum``) over the keys in reverse
    order, the mask taken on their own positions: the same function, its
    sums in another order."""
    import torch
    b, sq, h, d = q.shape
    sk, n_kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, n_kv, h // n_kv, d).float()
    kf, vf = k.flip(1).float(), v.flip(1).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, kf) / d ** 0.5
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = sk - 1 - torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    p = torch.softmax(torch.where(mask, s, torch.full_like(s, -1e30)), -1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, vf)
    return out.reshape(b, sq, h, d).to(q.dtype)


def state_errors(a, b):
    """Per leaf: the largest |a - b| over max(1, the largest |b|)."""
    return {k: float((a[k].float() - b[k].float()).abs().max())
            / max(1.0, float(b[k].float().abs().max())) for k in b}


def mamba_share(torch, model, params, batch, cache_len):
    """One admission's prefill (batch 1) timed whole, with the plain Mamba
    recurrence (``hymba.selective_scan``) timed call by call, each call
    between two syncs (32 syncs in a prefill of over a second): the
    recurrence's seconds and their share of that admission."""
    from repro_torch.models import hymba
    one = {k: v[:1] for k, v in batch.items()}
    scan, spent = hymba.selective_scan, [0.0]

    def timed(*args):
        sync(torch)
        t1 = time.perf_counter()
        out = scan(*args)
        sync(torch)
        spent[0] += time.perf_counter() - t1
        return out
    hymba.selective_scan = timed
    try:
        sync(torch)
        t0 = time.perf_counter()
        model.prefill(model.cfg, params, one, cache_len)
        sync(torch)
        timed_whole = time.perf_counter() - t0
    finally:
        hymba.selective_scan = scan
    return dict(admission_s=timed_whole, scan_s=spent[0],
                scan_share=spent[0] / timed_whole,
                scan_calls=model.cfg.n_layers)


def phase_model_family(torch, arch, phase, B, prompt_len, steps,
                       f32_layers=None, reduced: bool = False):
    """hymba-1.5b or whisper-tiny at full width and depth (random bf16
    weights drawn on the card): a prefill of ``prompt_len`` tokens (hymba:
    with its 128 meta tokens; whisper: 1,500 seeded frames through the
    encoder) and ``steps`` teacher-forced decode steps, through K7 and K6
    (every call held against the plain version on its inputs, CheckedK6
    and CheckedK7) and through the plain versions.  The bf16 floor is
    measured in the same run: the plain path in bf16 against the same
    weights in float32; the kernels' logits at step t are held to the
    largest floor up to t plus one bf16 ulp of the largest logit, and each
    leaf of their final state (KV ring or cache, conv and SSM states,
    cross K/V) to that leaf's floor or 2^-8, relative to its largest.
    Then the f32 evaluation: the weights in float32 at ``f32_layers``
    layers (None: all) through the kernels (K7 held to float64), the plain
    versions, and the plain versions with their sums in reverse order
    (``decode_reversed``, ``prefill_reversed``: the same functions).  Every
    argmax equal; the logits within 2^-10 of the largest or
    ``F32_SPREAD_FACTOR`` x the reversal's gap up to that step, every
    state leaf within 2^-10 or that factor x its reversal gap (relative to
    its largest).  The random weights' fan-in rule reads the stacked layer
    axis (std 1/sqrt(4) for whisper's 4 layers), so attention scores reach
    hundreds and a reordering moves whisper's f32 logits by 1e-2 of the
    largest: the reversal measures that.  The bound must stay below the
    upper reading, the plain path in bf16 at the same depth against the
    f32 one, at every step: a bound that a bf16 error would pass does not
    discriminate.  hymba also reports the share of one admission spent in
    the plain Mamba recurrence."""
    import dataclasses
    import types
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as K7
    from repro_torch.kernels import flash_decode as K6
    from repro_torch.models import build
    from repro_torch.serving.engine import prefix_len
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model = build(cfg)
    gen = torch.Generator().manual_seed(SEED)
    t0 = time.perf_counter()
    params = model.init(gen, DEV)
    sync(torch)
    init_s = time.perf_counter() - t0
    batch = family_inputs(torch, cfg, B, prompt_len, SEED + 4)
    feed = torch.randint(0, cfg.vocab_size, (steps, B), generator=gen,
                         dtype=torch.int32).to(DEV)
    plain = (K6.flash_decode_plain, K7.attn_prefill_einsum)
    k6, k7 = CheckedK6(K6), CheckedK7(K7)
    t0 = time.perf_counter()
    (kern, kst), (pl, pst) = family_teacher_forced(
        torch, model, params, batch, feed, [(k6, k7), plain])
    sync(torch)
    run_s = time.perf_counter() - t0
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = _tree(params, lambda t: t.float())
    ((p32, p32st),) = family_teacher_forced(torch, build(cfg32), params32,
                                            batch, feed, [plain])
    del params32
    diffs = [float((a - b).abs().max()) for a, b in zip(kern, pl)]
    floor = [float((a - b).abs().max()) for a, b in zip(pl, p32)]
    agree = [float((a.argmax(-1) == b.argmax(-1)).float().mean())
             for a, b in zip(kern, pl)]
    floor_agree = [float((a.argmax(-1) == b.argmax(-1)).float().mean())
                   for a, b in zip(pl, p32)]
    scale = max(float(b.abs().max()) for b in pl)
    bound = [max(floor[:t + 1]) + scale * 2.0 ** -8 for t in range(steps)]
    over = [t for t in range(steps) if diffs[t] > bound[t]]
    if over:
        t = over[0]
        raise AssertionError(f"{cfg.name} bf16 step {t}: kernels' logits "
                             f"{diffs[t]} from the plain path > {bound[t]} "
                             f"(bf16 floor {max(floor[:t + 1])})")
    st_err, st_floor = state_errors(kst, pst), state_errors(pst, p32st)
    bad = {k: (st_err[k], st_floor[k]) for k in st_err
           if st_err[k] > max(st_floor[k], 2.0 ** -8)}
    if bad:
        raise AssertionError(f"{cfg.name} bf16 state (kernels, floor): {bad}")
    bf16 = dict(k6_calls=k6.calls, k6_m_rel_err=k6.m_err,
                k6_out_err=k6.out_err, k7_calls=k7.calls, k7_err=k7.err,
                max_logit_diff_per_step=diffs, argmax_agree_per_step=agree,
                floor_per_step=floor, floor_argmax_agree_per_step=floor_agree,
                bound_per_step=bound, max_abs_logit=scale,
                state_rel_err=st_err, state_floor=st_floor, wall_s=run_s)
    res = dict(phase=phase, arch=cfg.name, layers=cfg.n_layers,
               encoder_layers=cfg.n_encoder_layers, d_model=cfg.d_model,
               heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
               d_head=cfg.d_head, vocab=cfg.vocab_size,
               params=sum(t.numel() for t in _leaves(params)),
               init_s=init_s, batch=B, prompt=prompt_len,
               positions=prefix_len(cfg, batch, prompt_len),
               decode_steps=steps, bf16=bf16, peak_gib=peak_gib(torch))
    if cfg.arch_type == "hybrid":
        res["mamba"] = mamba_share(torch, model, params, batch,
                                   prefix_len(cfg, batch, prompt_len)
                                   + HYMBA_NEW)
    # the f32 evaluation, its layers copied first; the upper reading is
    # the plain path in bf16 at the same depth
    drawn = types.SimpleNamespace(model=model, params=params)
    model16, params16 = f32_cut(drawn, f32_layers, dtype=None)
    ((up, _),) = family_teacher_forced(torch, model16, params16, batch,
                                       feed, [plain])
    model32, params32 = f32_cut(drawn, f32_layers)
    layers = model32.cfg.n_layers
    del params, params16, drawn
    free_card(torch)
    k6, k7 = CheckedK6(K6), CheckedK7(K7, exact=True)
    (kern, kst), (pl, pst), (rev, rst) = family_teacher_forced(
        torch, model32, params32, batch, feed,
        [(k6, k7), plain, (decode_reversed, prefill_reversed)])
    diffs = [float((a - b).abs().max()) for a, b in zip(kern, pl)]
    spread = [float((a - b).abs().max()) for a, b in zip(rev, pl)]
    upper = [float((a - b).abs().max()) for a, b in zip(up, pl)]
    agree = [float((a.argmax(-1) == b.argmax(-1)).float().mean())
             for a, b in zip(kern, pl)]
    scale = max(float(b.abs().max()) for b in pl)
    bound = [max(scale * 2.0 ** -10, F32_SPREAD_FACTOR * max(spread[:t + 1]))
             for t in range(steps)]
    loose = [t for t in range(steps) if bound[t] >= upper[t]]
    if loose:
        raise AssertionError(f"{cfg.name} f32: the bound {bound} would pass "
                             f"the plain path in bf16 ({upper}) at steps "
                             f"{loose}: it does not tell a bf16 error from "
                             "an f32 one")
    st_err, st_spread = state_errors(kst, pst), state_errors(rst, pst)
    st_bound = {k: max(2.0 ** -10, F32_SPREAD_FACTOR * st_spread[k])
                for k in st_err}
    f32 = dict(layers=layers, k6_calls=k6.calls, k6_out_err=k6.out_err,
               k7_calls=k7.calls, k7_err=k7.err, k7_exact_err=k7.exact_err,
               k7_plain_exact_err=k7.plain_exact_err,
               max_logit_diff_per_step=diffs, reversed_diff_per_step=spread,
               bf16_plain_diff_per_step=upper,
               argmax_agree_per_step=agree, max_abs_logit=scale,
               bound_per_step=bound, state_rel_err=st_err,
               state_reversed_err=st_spread)
    over = [t for t in range(steps) if diffs[t] > bound[t]]
    bad = {k: (st_err[k], st_bound[k]) for k in st_err
           if st_err[k] > st_bound[k]}
    if min(agree) < 1.0 or over or bad:
        raise AssertionError(f"{cfg.name} f32: argmax agreement {agree}, "
                             f"logits over the bound at steps {over} "
                             f"({diffs} against {bound}), state {bad}")
    res.update(f32=f32, peak_gib_with_f32=peak_gib(torch))
    emit(res)
    return res


def phase_serve_family(torch, arch, phase, extra, requests, max_new,
                       k7_per_prefill, k6_per_step):
    """``launch.serve --arch <arch>`` on the dense state (no page layout),
    4 slots: the harvest (one prefill of every trajectory, then ``max_new``
    dense decode steps), the fit (K5 once, scoring the calibration half for
    lambda*) and the fleet (one prefill an admission, then a decode step
    an engine step).  Exact launches: K7 ``k7_per_prefill`` times a
    prefill (a layer's attention, or an encoder layer's), K6
    ``k6_per_step`` times a decode step (a layer's ring, or a decoder
    layer's self and cross attention), K1 once an engine step, K5 once;
    no K2, K3, K4 or K8.  Reports the step ms, TTFT and the card's peak
    memory."""
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    res, out = serve_fleet(torch, extra, phase=phase, requests=requests,
                           need=FAMILY_NEED, paged=False, arch=arch,
                           max_new=max_new)
    fleet, lc = out.fleet, res["launches"]
    want = dict(flash_attention=k7_per_prefill * (1 + requests),
                flash_decode=k6_per_step * (max_new + fleet.engine_steps),
                serving_probe_step=fleet.engine_steps, ttt_probe_batched=1,
                **{k: 0 for k in FAMILY_NEVER})
    got = {k: lc[k] for k in want}
    if got != want:
        raise AssertionError(f"{phase} launches {got}, expected {want} (K7 "
                             f"{k7_per_prefill} a prefill: the harvest's "
                             f"and {requests} admissions; K6 {k6_per_step} "
                             f"a step: {max_new} harvest and "
                             f"{fleet.engine_steps} engine steps)")
    res.update(layers=out.scheduler.model.cfg.n_layers,
               step_ms=fleet.wall_time_s / fleet.engine_steps * 1e3,
               params=sum(t.numel() for t in _leaves(out.scheduler.params)),
               state_leaves={k: list(v.shape) for k, v in
                             out.scheduler.engine.state.items()},
               preemptions=fleet.preemptions, peak_gib=peak_gib(torch))
    emit(res)
    return res, out


def whisper_requests(torch, cfg, n, max_new, seed=SEED + 2):
    """``n`` requests of 16 random tokens and 1,500 seeded frames each, as
    the driver makes them."""
    from repro_torch.launch import serve
    from repro_torch.serving import make_request
    batch = serve.model_inputs(cfg, torch.Generator().manual_seed(seed), n,
                               16)
    return [make_request(batch["tokens"][i],
                         extra={"frames": batch["frames"][i:i + 1]},
                         max_new_tokens=max_new) for i in range(n)]


def phase_families(torch):
    """The hymba and whisper phases: model, serve, trace and the f32 stops
    of each.  Returns the records the kernels line reads."""
    hy_model = phase_model_family(torch, HYMBA_ARCH, "model-hymba", B=2,
                                  prompt_len=HYMBA_PROMPT, steps=4,
                                  f32_layers=F32_LAYERS)
    free_card(torch)
    # the fleet, its harvest and its trace at 8 of 32 layers (paid for the
    # dist phases; model-hymba keeps all 32); its f32 check on the first
    # layers of a full-depth draw, as serve-rwkv-f32's
    layers = CUT_LAYERS
    with CutDepth(layers):
        hy, out = phase_serve_family(
            torch, HYMBA_ARCH, "serve-hymba",
            ("--train-trajectories", str(HYMBA_HARVEST), "--prompt-len",
             str(HYMBA_PROMPT)), HYMBA_REQUESTS, HYMBA_NEW, layers, layers)
    sched = out.scheduler
    phase_trace(torch, sched, steps=HYMBA_TRACE_STEPS, prompt_len=HYMBA_PROMPT,
                phase="trace-hymba")
    f32_stops(torch, "serve-hymba-f32",
              *f32_cut(full_depth(torch, HYMBA_ARCH), F32_LAYERS),
              sched.pc, sched.theta, PlainDenseAttention(),
              ("flash_decode", "flash_attention"), requests=HYMBA_REQUESTS,
              prompt_len=HYMBA_PROMPT, max_new_tokens=HYMBA_NEW)
    del out, sched
    free_card(torch)
    wh_model = phase_model_family(torch, WHISPER_ARCH, "model-whisper", B=4,
                                  prompt_len=16, steps=16)
    wh, out = phase_serve_family(
        torch, WHISPER_ARCH, "serve-whisper",
        ("--train-trajectories", str(WHISPER_HARVEST)), WHISPER_REQUESTS,
        WHISPER_NEW, WHISPER[3], 2 * WHISPER[3])
    sched = out.scheduler
    phase_trace(torch, sched, phase="trace-whisper",
                requests=lambda n: whisper_requests(torch, sched.model.cfg,
                                                    sched.n_slots, n))
    f32_stops(torch, "serve-whisper-f32",
              *f32_cut(sched, WHISPER_F32_LAYERS), sched.pc,
              sched.theta, PlainDenseAttention(),
              ("flash_decode", "flash_attention"),
              requests=WHISPER_REQUESTS, prompt_len=16,
              max_new_tokens=WHISPER_NEW)
    del out, sched
    free_card(torch)
    return dict(hymba_model=hy_model, hymba=hy, whisper_model=wh_model,
                whisper=wh)


# ---------------------------------------------------------------------------
# the d-128 fleets: llama3.2-3b (G 3) and qwen1.5-32b (G 1, int8 KV)

LLAMA_ARCH, QWEN_ARCH = "llama3.2-3b", "qwen1.5-32b"
STABLELM_ARCH = "stablelm-3b"
GRANITE_ARCH, PHI_ARCH = "granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b"
# phi3.5-moe's depth on the card: 24 of its 32 layers, 58.6 GiB of bf16
# weights (the whole model's 78.0 GiB leaves no room for a cache)
PHI_LAYERS = 24
# the new fleets: 4 requests on 4 slots, 48 new tokens, 8 harvested
# trajectories; serve-qwen's and serve-stablelm's prompts of 160 tokens go
# in 64-token chunks
WIDE_REQUESTS, WIDE_NEW, WIDE_HARVEST = 4, 48, 8
QWEN_PROMPT = 160
# serve-llama-f32's depth: the float32 check fleets' stops, kept short
F32_LAYERS = 4
# serve-qwen's depth (and trace-qwen's, on its fleet): 16 of its 64
# layers, cut to pay for the llava phases' seconds (llava-next-34b is the
# 30B-class dense model served at full depth on one card now).
# model-qwen keeps all 64: drawn at 16 (the fan-in rule reads the stacked
# layer axis, so fewer layers draw larger weights) K2's outputs in the
# model came 2.05e-3 from float64, past its absolute 2e-3, as
# phi3.5-moe's did at 8
QWEN_LAYERS = 16


def free_card(torch) -> None:
    """Return what the dropped fleets held to the card."""
    import gc
    gc.collect()
    if DEV == "cuda":
        torch.cuda.empty_cache()


def peak_gib(torch) -> float:
    return torch.cuda.max_memory_allocated() / 2 ** 30 if DEV == "cuda" \
        else 0.0


def f32_evaluation(torch, model, params, prompt, feed,
                   layers: int = F32_LAYERS, extra=None):
    """The model's first ``layers`` layers (full width) with their weights
    cast to float32, on f32 pages, with teacher-forced routing
    (``ForcedRouting``: each path compared takes the experts its
    reference run chose): K2 against the plain paged attention within
    2^-10 of the largest logit, every K2 call checked, and the dense path
    through K7 and K6 with every argmax equal and within 2^-10 (phase
    model's float32 bounds, which the bf16 floor of a random-weight MoE
    stack, as large as its logits, cannot give), each K7 call held to
    float64 (phi3.5-moe's scores reach hundreds; there the plain f32
    version is 2e-3 from float64, past phase k7's f32 tolerance).  The
    depth is cut as the
    f32 fleets' is: through granite-moe-1b's 24 layers a float32
    reordering alone moves the logits by 8% of their largest, routing
    forced (PERF.md §7).  The bf16 floor measured against it: the
    plain dense path's logits of the same cut in bf16 against those in
    float32 (each routed freely), step by step.  Reports the routings
    whose own choice the forcing overrode and the smallest top-k router
    margin of the float32 runs, and names them in a failure.  ``extra``:
    a VLM's patches, as in ``teacher_forced``."""
    import dataclasses
    from repro_torch.kernels import flash_attention as K7
    from repro_torch.kernels import flash_decode as K6
    from repro_torch.kernels import paged_decode as K2
    from repro_torch.models import build
    cfg = dataclasses.replace(model.cfg,
                              n_layers=min(layers, model.cfg.n_layers))
    cut = {k: _tree(v, (lambda t: t[:cfg.n_layers]) if k == "layers"
                    else (lambda t: t)) for k, v in params.items()}
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                kv_cache_dtype="float32")
    model32 = build(cfg32)
    params32 = _tree(cut, lambda t: t.float())
    (bf16,) = dense_teacher_forced(
        torch, build(cfg), cut, prompt, feed,
        [(K6.flash_decode_plain, K7.attn_prefill_einsum)], extra=extra)
    checked = CheckedK2(K2)
    plain32 = []
    paged, dense = ForcedRouting(), ForcedRouting()
    try:
        with paged:
            (k2_32,), scale32 = teacher_forced(
                torch, model32, params32, prompt, feed,
                [(K2.paged_decode_plain, None), (checked, None)],
                route=paged, extra=extra)
        bound32 = scale32 * 2.0 ** -10
        if max(k2_32) > bound32:
            raise AssertionError(f"K2 vs plain paged logits {max(k2_32)} "
                                 f"> {bound32}")
        with dense:
            dense32 = dense_path(torch, model32, params32, prompt, feed,
                                 True, keep=plain32, route=dense,
                                 k7_exact=True, extra=extra)
    except AssertionError as e:
        raise AssertionError(
            f"{cfg32.name} f32: {e} (routings forced from another choice: "
            f"paged {paged.flips}, dense {dense.flips}; smallest top-k "
            f"router margins {paged.margin}, {dense.margin})") from e
    floor = [float((a - b).abs().max()) for a, b in zip(bf16, plain32)]
    return dict(layers=cfg.n_layers, k2_calls=checked.calls,
                k2_m_rel_err=checked.m_err, k2_out_err=checked.out_err,
                k2_plain_out_err=checked.plain_out_err,
                max_logit_diff_per_step=k2_32, max_abs_logit=scale32,
                bound=bound32, dense=dense32,
                routing_flips=dict(paged=paged.flips, dense=dense.flips),
                router_margin_min=min((m for m in (paged.margin,
                                                   dense.margin)
                                       if m is not None), default=None),
                bf16_vs_f32_logit_diff_per_step=floor,
                bf16_max_abs_logit=max(float(b.abs().max()) for b in bf16))


def phase_model_wide(torch, arch, phase, steps: int = 8,
                     reduced: bool = False, layers=None):
    """A d-128 config at full width and depth (random bf16 weights drawn
    on the card; qwen1.5-32b's KV in int8 pages as served): one prefill of
    16 tokens and ``steps`` teacher-forced paged decode steps through K2,
    its logits within the floor phase model measures
    (``paged_within_floor``, every K2 call held against the plain
    version's formula in float64 too); then the dense path, the prompt through K7 and the fed tokens
    through K6 (qwen's int8 cache dequantised to bf16, K6 at G 1), every
    call held against the plain version (``dense_path``).  Reports the
    card's peak memory.  An MoE config also runs ``f32_evaluation`` on
    the same weights and reports the smallest top-k router margin of the
    bf16 runs.  ``layers`` cuts the depth."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=min(layers, cfg.n_layers))
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model = build(cfg)
    gen = torch.Generator().manual_seed(SEED)
    t0 = time.perf_counter()
    params = model.init(gen, DEV)
    sync(torch)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    B, S = 4, 16
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           dtype=torch.int32).to(DEV)
    feed = torch.randint(0, cfg.vocab_size, (steps, B), generator=gen,
                         dtype=torch.int32).to(DEV)
    with RouterMargin(cfg.moe is not None) as rm:
        paged = paged_within_floor(torch, model, params, prompt, feed)
        dense = dense_path(torch, model, params, prompt, feed, False)
    res = dict(phase=phase, arch=arch, layers=cfg.n_layers, d_model=cfg.d_model, heads=cfg.n_heads,
               kv_heads=cfg.n_kv_heads, d_head=cfg.d_head, d_ff=cfg.d_ff,
               vocab=cfg.vocab_size, params=n_params, dtype=cfg.dtype,
               kv_cache=cfg.kv_cache_dtype, init_s=init_s, batch=B,
               prompt=S, decode_steps=steps, bf16=paged, dense=dense,
               peak_gib=peak_gib(torch))
    if cfg.moe is not None:
        # the f32 evaluation's layers copied, the rest freed before their
        # float32 copy is made (phi's 24 bf16 layers and 4 in f32 would
        # not fit the card together)
        params = {k: _tree(v, lambda t: t[:F32_LAYERS].clone())
                  if k == "layers" else v for k, v in params.items()}
        free_card(torch)
        res.update(experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
                   router_margin_min=rm.margin,
                   f32=f32_evaluation(torch, model, params, prompt, feed),
                   peak_gib_with_f32=peak_gib(torch))
    emit(res)
    del params
    return res


def wide_fleet(torch, arch, phase, extra=(), need=SERVE_NEED):
    """``launch.serve --arch <arch> --paged``: 4 requests on 4 slots, 48
    new tokens, 8 harvested trajectories.  The harvest runs K7 once a
    layer for its prefill and K6 once a layer a decode step, every
    admission K7 (or, chunked, K3 once a layer in each step that carries
    a chunk) and every engine step K2 once a layer and K1 once."""
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    res, out = serve_fleet(
        torch, ("--train-trajectories", str(WIDE_HARVEST), *extra),
        phase=phase, requests=WIDE_REQUESTS, need=need, arch=arch,
        max_new=WIDE_NEW)
    layers = out.scheduler.model.cfg.n_layers
    lc = res["launches"]
    chunked = "--chunk-tokens" in extra
    want = dict(flash_decode=layers * WIDE_NEW,
                flash_attention=layers * (1 + (0 if chunked
                                               else WIDE_REQUESTS)),
                paged_flash_decode=layers * res["engine_steps"],
                serving_probe_step=res["engine_steps"])
    if chunked:
        want["paged_flash_packed_chunk"] = layers * res["prefill_chunks"]
    got = {k: lc[k] for k in want}
    if got != want:
        raise AssertionError(f"{phase} launches {got}, expected {want} (K6 "
                             f"once a layer in each of the harvest's "
                             f"{WIDE_NEW} steps; K7 once a layer for the "
                             "harvest and each admission prefilled at "
                             "once; K2 once a layer an engine step, K1 "
                             "once; K3 once a layer a step with a chunk)")
    res.update(layers=layers, step_ms=res["serve_wall_s"]
               / res["engine_steps"] * 1e3,
               params=sum(t.numel() for t in _leaves(out.scheduler.params)),
               peak_gib=peak_gib(torch))
    emit(res)
    return res, out


class PlainAttention:
    """Within the block, every attention kernel of the dense model runs
    its plain version: K2, K3 (both entries), K6 and K7."""

    def __enter__(self):
        from repro_torch.kernels import paged_chunk as K3
        from repro_torch.kernels import paged_decode as K2
        from repro_torch.models import attention as A
        self.dense = PlainDenseAttention().__enter__()
        self.served = (A.paged_flash_decode, A.paged_flash_prefill_chunk,
                       A.paged_flash_packed_chunk)
        A.paged_flash_decode = K2.paged_decode_plain
        A.paged_flash_prefill_chunk = K3.paged_prefill_chunk_plain
        A.paged_flash_packed_chunk = K3.paged_packed_chunk_plain
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention as A
        (A.paged_flash_decode, A.paged_flash_prefill_chunk,
         A.paged_flash_packed_chunk) = self.served
        return self.dense.__exit__(*exc)


class RouterMargin:
    """Within the block (when ``active``), every routing of the MoE block
    records its smallest top-k margin: the k-th largest router probability
    minus the (k+1)-th, over every token.  A margin near 0 is a routing
    another summation order may flip, swapping a whole expert, which tells
    such a divergence apart from a kernel fault.  The minimum stays on the
    card until ``margin`` reads it."""

    def __init__(self, active: bool = True):
        self.active, self.min = active, None

    def route(self, logits, probs, gates, idx):
        """What the block routes by, given the router's own choice."""
        return logits, probs, gates, idx

    def __enter__(self):
        if not self.active:
            return self
        import torch
        from repro_torch.models import moe
        self.moe, self.router = moe, moe._router

        def router(params, x, cfg):
            out = self.router(params, x, cfg)
            k = cfg.moe.top_k
            top = torch.topk(out[1], k + 1, dim=-1).values
            gap = (top[:, k - 1] - top[:, k]).min()
            self.min = gap if self.min is None else torch.minimum(self.min,
                                                                  gap)
            return self.route(*out)
        moe._router = router
        return self

    def __exit__(self, *exc):
        if self.active:
            self.moe._router = self.router

    @property
    def margin(self):
        return None if self.min is None else float(self.min)


class ForcedRouting(RouterMargin):
    """Teacher-forced routing, as the fed tokens are teacher-forced: within
    the block, each routing of the MoE block in a run other than the first
    (``select(run, pass)``, called before every model call) takes the
    experts the first run chose at the same call of the same pass, and
    its gates are its own probabilities there, renormalised.  Two
    attention paths compared in float32 then differ continuously: a
    routing within rounding of a top-k tie cannot swap a whole expert in
    one of them.  Counts the routings whose own top-k differed from the
    forced one (``flips``); keeps the smallest top-k margin as
    ``RouterMargin`` does."""

    def __init__(self):
        super().__init__()
        self.run, self.key, self.n = 0, None, 0
        self.chosen, self.flips = {}, 0

    def select(self, run, key) -> None:
        self.run, self.key, self.n = run, key, 0

    def route(self, logits, probs, gates, idx):
        import torch
        call = (self.key, self.n)
        self.n += 1
        if self.run == 0:
            self.chosen[call] = idx
            return logits, probs, gates, idx
        forced = self.chosen[call].to(idx.device)
        self.flips += int((idx.sort(-1).values
                           != forced.sort(-1).values).any(-1).sum())
        gates = probs.gather(-1, forced)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        return logits, probs, gates, forced


def f32_cut(sched, layers=None, dtype="float32", **changes):
    """The fleet's model and its weights cut to its first ``layers``
    layers (all by default; full width), an encoder-decoder's encoder to
    as many, and cast to ``dtype`` (float32 by default; None keeps the
    weights' own dtype, on views of the same tensors: what the full-depth
    draw gives those layers)."""
    import dataclasses
    from repro_torch.models import build
    cfg = sched.model.cfg
    layers = min(layers or cfg.n_layers, cfg.n_layers)
    enc = min(layers, cfg.n_encoder_layers)
    if dtype is not None:
        changes["dtype"] = dtype
    cut = dataclasses.replace(cfg, n_layers=layers, n_encoder_layers=enc,
                              **changes)
    depth = {"layers": layers, "dec_layers": layers, "enc_layers": enc}
    cast = (lambda t: t) if dtype is None else (lambda t: t.float())

    def leaf(key):
        if key in depth:
            return lambda t: cast(t[:depth[key]])
        return cast
    return build(cut), {k: _tree(v, leaf(k)) for k, v in sched.params.items()}


def f32_fleets(torch, phase, model32, params32, pc, theta, swap, *,
               requests, prompt_len, make_requests=None, **serve_cfg):
    """A float32 fleet through ``OrcaScheduler`` at a lambda* between its
    scores, served once through the kernels and once within ``swap``.
    ``serve_cfg``: the fleet's ``ServeConfig`` beyond lambda.
    ``make_requests()`` makes each run's requests in place of the driver's
    random prompts (serve-llava-f32's image and text traffic); without it
    each request carries the driver's other inputs (whisper's frames).
    Returns (lambda*, its margin, the smallest top-k router margins of
    the free, kernel and plain runs (``RouterMargin``; None without MoE),
    the kernel run, the plain run), each run (requests, fleet, wall s,
    launches)."""
    from repro_torch.launch import serve
    from repro_torch.serving import OrcaScheduler, ServeConfig, make_request
    batch = serve.model_inputs(model32.cfg,
                               torch.Generator().manual_seed(SEED + 1),
                               requests, prompt_len)
    base = dict(n_slots=4, tokens_per_step=8, burn_in=2, **serve_cfg)
    moe = model32.cfg.moe is not None
    margins = []

    def fleet(lam):
        zero_launches()
        t0 = time.perf_counter()
        extra = [k for k in batch if k != "tokens"]
        reqs = (make_requests() if make_requests is not None
                else [make_request(t, extra={k: batch[k][i:i + 1]
                                             for k in extra})
                      for i, t in enumerate(batch["tokens"])])
        with RouterMargin(moe) as rm:
            done, fl = OrcaScheduler(model32, params32, pc, theta,
                                     ServeConfig(lam=lam, **base)).run(reqs)
        sync(torch)
        margins.append(rm.margin)
        return done, fl, time.perf_counter() - t0, read_launches()

    free, _, _, _ = fleet(2.0)
    lam, margin = choose_lambda([r.scores for r in free], base["burn_in"])
    if margin < 1e-4:
        raise AssertionError(f"{phase}: every threshold lies within "
                             f"{margin} of a score: the check would hang on "
                             "a tie")
    kern = fleet(lam)
    with swap:
        plain = fleet(lam)
    return lam, margin, margins if moe else None, kern, plain


def f32_stops(torch, phase, model32, params32, pc, theta, swap, kernels, *,
              requests, prompt_len, make_requests=None, **serve_cfg):
    """The float32 fleet of ``f32_fleets`` (phase serve-spec-f32's
    machinery), served through the kernels and within ``swap``, which puts
    each kernel named in ``kernels`` on its plain version: every stop step
    and every token equal, each of ``kernels`` launched in the first run
    and none in the second.  An MoE model's runs record their smallest
    top-k router margins, reported beside the stops and in a failure."""
    lam, margin, margins, kern_run, plain_run = f32_fleets(
        torch, phase, model32, params32, pc, theta, swap, requests=requests,
        prompt_len=prompt_len, make_requests=make_requests, **serve_cfg)
    (kern, kern_fl, kern_s, kern_l), (plain, plain_fl, plain_s, plain_l) = \
        kern_run, plain_run
    moe = margins is not None
    stops = [r.stop_step for r in kern]
    routed = (f" (smallest top-k router margins of the free, kernel and "
              f"plain runs: {margins})" if moe else "")
    if [r.stop_step for r in plain] != stops:
        raise AssertionError(f"{phase}: stops through the plain versions "
                             f"{[r.stop_step for r in plain]} differ from "
                             f"the kernels' {stops}{routed}")
    if [r.tokens for r in plain] != [r.tokens for r in kern]:
        raise AssertionError(f"{phase}: tokens through the plain versions "
                             f"differ from the kernels'{routed}")
    if not all(kern_l[k] for k in kernels) or any(plain_l[k]
                                                  for k in kernels):
        raise AssertionError(f"{phase} launches: {kern_l} through the "
                             f"kernels, {plain_l} plain")
    res = dict(phase=phase, layers=model32.cfg.n_layers,
               kv_cache=model32.cfg.kv_cache_dtype, requests=requests,
               prompt=prompt_len, serve=serve_cfg, lam=lam,
               lambda_margin=margin, stop_steps=stops,
               stopped=sum(s >= 0 for s in stops),
               kernel=dict(engine_steps=kern_fl.engine_steps, wall_s=kern_s,
                           tokens_per_s=kern_fl.tokens_per_s,
                           packed_chunks=kern_fl.packed_chunks,
                           launches=kern_l),
               plain=dict(engine_steps=plain_fl.engine_steps, wall_s=plain_s,
                          tokens_per_s=plain_fl.tokens_per_s,
                          launches=plain_l))
    if moe:
        res["router_margin_min"] = dict(zip(("free", "kernel", "plain"),
                                            margins))
    emit(res)
    return res


def fresh_f32_stops(torch, arch, phase, pc, theta, layers: int = F32_LAYERS,
                    **changes):
    """A chunked fleet's served path in float32 at ``layers`` of its
    layers (full width, weights drawn on the card: the bf16 fleet's are
    gone, two copies do not fit), on its KV pages (``changes``) in 64-token
    chunks of 160-token prompts, with the bf16 fleet's fitted probe:
    through K2 and K3 and through the plain attention.  serve-qwen-f32
    keeps qwen's int8 pages and their scale pools; serve-phi-f32 takes f32
    pages."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build
    cfg = dataclasses.replace(get_config(arch), dtype="float32",
                              n_layers=layers, **changes)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(SEED), DEV)
    return f32_stops(torch, phase, model, params, pc, theta,
                     PlainAttention(), ("paged_flash_decode",
                                        "paged_flash_packed_chunk"),
                     requests=WIDE_REQUESTS, prompt_len=QWEN_PROMPT,
                     paged=True, chunk_tokens=CHUNK,
                     max_new_tokens=WIDE_NEW)


# ---------------------------------------------------------------------------
# the VLM: llava-next-34b at full width and depth

LLAVA_ARCH = "llava-next-34b"
# model-llava's teacher-forced decode steps (8 until the training phases)
LLAVA_MODEL_STEPS = 4
# an image request's text after its 2,880 patches; serve-llava's text
# requests take serve-qwen's 160-token prompts, in 64-token chunks
LLAVA_TEXT = 16
# the harvest: 8 image trajectories, 4 at a time (8 of 2,944 positions in
# one dense cache and the prefill's activations would pass 76 GiB beside
# the 64.05 GiB of weights)
LLAVA_HARVEST, LLAVA_HARVEST_BATCH = 8, 4
# serve-llava's and trace-llava's depth: 16 of its 60 layers (paid for
# the dist phases); model-llava keeps all 60
LLAVA_SERVE_LAYERS = 16


def llava_patches(torch, cfg, n: int, seed: int):
    """(n, 2,880, 1,024) float32 patch embeddings drawn N(0, 1) from
    ``seed`` on the host: the vision tower is a stub, and the driver's zero
    patches would project to exact zeros (the projector's biases start at
    zero and gelu(0) = 0), leaving the prefix inert."""
    return torch.randn(n, cfg.frontend.n_tokens, cfg.frontend.embed_dim,
                       generator=torch.Generator().manual_seed(seed))


def llava_requests(torch, cfg, max_new: int, text_len: int = QWEN_PROMPT,
                   seed: int = SEED + 1):
    """serve-llava's traffic, image and text turns in one batch: image,
    text, image, text.  An image request is its seeded patches and
    ``LLAVA_TEXT`` tokens, prefilled in one shot at admission (K7 over
    2,896 rows); a text request is ``text_len`` tokens, prefilled in
    64-token chunks (K3-B4) when the fleet chunks."""
    from repro_torch.serving import make_request
    gen = torch.Generator().manual_seed(seed)
    reqs = []
    for i in range(WIDE_REQUESTS):
        image = i % 2 == 0
        toks = torch.randint(0, cfg.vocab_size,
                             (LLAVA_TEXT if image else text_len,),
                             generator=gen, dtype=torch.int32).numpy()
        extra = ({"patch_embeds": llava_patches(torch, cfg, 1,
                                                seed + 10 + i).numpy()}
                 if image else None)
        reqs.append(make_request(toks, extra=extra, max_new_tokens=max_new))
    return reqs


def llava_config(reduced: bool = False, layers=None, **changes):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(LLAVA_ARCH)
    if reduced:
        cfg = cfg.reduced()
    if layers:
        changes["n_layers"] = min(layers, cfg.n_layers)
    return dataclasses.replace(cfg, **changes)


def phase_model_llava(torch, reduced: bool = False, steps: int = 8):
    """llava-next-34b at full width and depth (random bf16 weights drawn on
    the card): one image request, its 2,880 patches drawn N(0, 1) from the
    seed, 16 tokens of text, prefilled through K7 (2,896 rows, 56 heads on
    8) and ``steps`` teacher-forced paged decode steps through K2 at
    (128, 7), every K2 call held against the plain formula in float64 and
    the logits within the floor ``paged_within_floor`` measures; the dense
    path, the prefill through K7 with every call held to the plain formula
    in float64 (``CheckedK7(exact=True)``) and the decode through K6;
    then the first 4 layers in f32 (``f32_evaluation``, as model-phi), the
    rest freed first.  Reports the card's peak memory."""
    from repro_torch.models import build
    cfg = llava_config(reduced)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model = build(cfg)
    gen = torch.Generator().manual_seed(SEED)
    t0 = time.perf_counter()
    params = model.init(gen, DEV)
    sync(torch)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    B = 1
    prompt = torch.randint(0, cfg.vocab_size, (B, LLAVA_TEXT), generator=gen,
                           dtype=torch.int32).to(DEV)
    feed = torch.randint(0, cfg.vocab_size, (steps, B), generator=gen,
                         dtype=torch.int32).to(DEV)
    extra = {"patch_embeds": llava_patches(torch, cfg, B, SEED + 9).to(DEV)}
    paged = paged_within_floor(torch, model, params, prompt, feed,
                               extra=extra)
    dense = dense_path(torch, model, params, prompt, feed, False,
                       k7_exact=True, extra=extra)
    res = dict(phase="model-llava", arch=LLAVA_ARCH, layers=cfg.n_layers,
               d_model=cfg.d_model, heads=cfg.n_heads,
               kv_heads=cfg.n_kv_heads, d_head=cfg.d_head, d_ff=cfg.d_ff,
               vocab=cfg.vocab_size, params=n_params, dtype=cfg.dtype,
               init_s=init_s, batch=B, patches=cfg.frontend.n_tokens,
               prompt=LLAVA_TEXT, decode_steps=steps, bf16=paged,
               dense=dense, peak_gib=peak_gib(torch))
    # the f32 evaluation's layers copied, the rest freed before their
    # float32 copy is made
    params = {k: _tree(v, lambda t: t[:F32_LAYERS].clone())
              if k == "layers" else v for k, v in params.items()}
    free_card(torch)
    res.update(f32=f32_evaluation(torch, model, params, prompt, feed,
                                  extra=extra),
               peak_gib_with_f32=peak_gib(torch))
    emit(res)
    del params
    return res


def ttft_by_class(done):
    """TTFT p50 and max (ms) of the image and of the text requests."""
    out = {}
    for cls in ("image", "text"):
        ms = sorted(r.ttft_s * 1e3 for r in done
                    if ("patch_embeds" in r.inputs) == (cls == "image")
                    and r.ttft_s >= 0)
        out[cls] = dict(n=len(ms), p50=ms[len(ms) // 2] if ms else None,
                        max=ms[-1] if ms else None)
    return out


def phase_serve_llava(torch, reduced: bool = False, layers=None):
    """The VLM served as a multimodal deployment sees it, at full width
    (``layers`` of its 60 layers; all by default) on paged bf16 pages, 4
    slots: a harvest of 8 image trajectories
    (seeded patches, 16 tokens, 48 dense decode steps; K7 over 2,896 rows
    and K6 at (128, 7)), in batches of 4; ``orca.fit`` of the TTT probe at
    f 7168 (K5) and the LTT lambda* at delta 0.2 (the driver's fallback
    0.99); then through ``api.engine`` (``OrcaScheduler``) 2 image
    requests, admitted in one shot (K7 over 2,896 rows), beside 2 text
    requests of 160 tokens in 64-token chunks (K3-B4 at (128, 7)), 48 new
    tokens each, every step K2 at (128, 7) and K1 at f 7168.  The driver's
    ``model_inputs`` gives zero patches, so the traffic is built here.
    Every K1, K2, K3, K6 and K7 launch of the harvest, fit and fleet is
    counted exactly; reports each request's stop and tokens, TTFT by
    class and the card's peak memory.  Returns the record and the
    scheduler."""
    from repro_torch import api as orca
    from repro_torch.core.probe import ProbeConfig
    from repro_torch.launch import serve
    from repro_torch.models import build
    from repro_torch.serving import ServeConfig, extract_trajectories
    import numpy as np
    cfg = llava_config(reduced, layers=layers)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(SEED), DEV)
    sync(torch)
    L, tps = cfg.n_layers, 8
    zero_launches()
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 3)
    phis, toks = [], []
    for lo in range(0, LLAVA_HARVEST, LLAVA_HARVEST_BATCH):
        n = min(LLAVA_HARVEST_BATCH, LLAVA_HARVEST - lo)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (n, LLAVA_TEXT),
                                         generator=gen,
                                         dtype=torch.int32).numpy(),
                 "patch_embeds": llava_patches(torch, cfg, n,
                                               SEED + 20 + lo).numpy()}
        p, t = extract_trajectories(model, params, batch, LLAVA_TEXT,
                                    WIDE_NEW, tps)
        phis.append(p)
        toks.append(t)
    sync(torch)
    harvest_s = time.perf_counter() - t0
    harvest_peak = peak_gib(torch)
    batches = -(-LLAVA_HARVEST // LLAVA_HARVEST_BATCH)
    ts = serve.trajectory_set(np.concatenate(phis), np.concatenate(toks), tps)
    half = len(ts) // 2
    train = ts.subset(np.arange(half))
    cal = ts.subset(np.arange(half, len(ts)))
    t0 = time.perf_counter()
    calib = orca.fit(train, mode="consistent", method="ttt",
                     pc=ProbeConfig(d_phi=cfg.d_model, smooth_window=4),
                     epochs=10, epoch_select=False, seed=SEED, device=DEV)
    lam = orca.calibrated_lambda(calib, cal, 0.2, fallback=0.99)
    sync(torch)
    fit_s = time.perf_counter() - t0
    sched = orca.engine(model, params, calib, config=ServeConfig(
        n_slots=4, tokens_per_step=tps, max_new_tokens=WIDE_NEW,
        lam=float(lam), burn_in=2, paged=True, chunk_tokens=CHUNK))
    done, fleet = sched.run(llava_requests(torch, cfg, WIDE_NEW))
    sync(torch)
    launches = read_launches()
    states = [r.state.value for r in done]
    if len(done) != WIDE_REQUESTS or not set(states) <= {"stopped",
                                                          "finished"}:
        raise AssertionError(f"serve-llava: requests did not all end: "
                             f"{states}")
    sched.pool.check()
    if sched.pool.blocks_in_use:
        raise AssertionError(f"serve-llava: {sched.pool.blocks_in_use} "
                             "pages still in use")
    images = sum("patch_embeds" in r.inputs for r in done)
    want = dict(flash_decode=L * WIDE_NEW * batches,
                flash_attention=L * (batches + images),
                paged_flash_decode=L * fleet.engine_steps,
                paged_flash_packed_chunk=L * fleet.prefill_chunks,
                serving_probe_step=fleet.engine_steps,
                paged_flash_prefill_chunk=0, serving_probe_spec_step=0)
    got = {k: launches[k] for k in want}
    if got != want or launches["ttt_probe_batched"] < 1 \
            or fleet.prefill_chunks < 1:
        raise AssertionError(
            f"serve-llava launches {launches}, expected {want} and K5 in "
            f"the fit (K6 once a layer a harvest step, K7 once a layer a "
            f"harvest batch and an image admission, K2 once a layer an "
            f"engine step, K1 once, K3 once a layer a step with a chunk; "
            f"{fleet.prefill_chunks} chunks)")
    res = dict(phase="serve-llava", arch=LLAVA_ARCH, layers=L,
               params=sum(t.numel() for t in _leaves(params)), lam=lam,
               harvest=dict(trajectories=LLAVA_HARVEST, batches=batches,
                            steps=WIDE_NEW, wall_s=harvest_s,
                            peak_gib=harvest_peak),
               fit_s=fit_s,
               requests=[dict(kind="image" if "patch_embeds" in r.inputs
                              else "text", prompt=r.prompt_len,
                              state=r.state.value, stop_step=r.stop_step,
                              tokens=len(r.tokens),
                              ttft_ms=r.ttft_s * 1e3) for r in done],
               ttft_ms_by_class=ttft_by_class(done),
               engine_steps=fleet.engine_steps,
               serve_wall_s=fleet.wall_time_s,
               step_ms=fleet.wall_time_s / fleet.engine_steps * 1e3,
               requests_per_s=fleet.requests_per_s,
               tokens_per_s=fleet.tokens_per_s,
               prefill_chunks=fleet.prefill_chunks,
               packed_chunks=fleet.packed_chunks,
               stall_ms_p50=fleet.stall_ms_p50,
               stall_ms_p99=fleet.stall_ms_p99,
               pool_blocks=fleet.pool_blocks,
               peak_blocks_in_use=fleet.peak_blocks_in_use,
               launches=launches, peak_gib=peak_gib(torch))
    emit(res)
    return res, sched


def phase_llava_f32_stops(torch, pc, theta, layers: int = F32_LAYERS,
                          reduced: bool = False):
    """serve-llava's traffic (2 image requests beside 2 chunked text
    requests, seeded patches) in float32 at ``layers`` of its 60 layers
    (full width, weights drawn anew on the card: the bf16 fleet's are
    gone, two copies do not fit) on f32 pages, with serve-llava's fitted
    probe: through K2, K3 and K7 and through the plain attention, stops and
    tokens equal; ``f32_stops`` reports the smallest distance of a tested
    score to lambda* (``lambda_margin``)."""
    from repro_torch.models import build
    cfg = llava_config(reduced, layers, dtype="float32",
                       kv_cache_dtype="float32")
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(SEED), DEV)
    return f32_stops(torch, "serve-llava-f32", model, params, pc, theta,
                     PlainAttention(), ("paged_flash_decode",
                                        "paged_flash_packed_chunk",
                                        "flash_attention"),
                     requests=WIDE_REQUESTS, prompt_len=QWEN_PROMPT,
                     make_requests=lambda: llava_requests(torch, cfg,
                                                          WIDE_NEW),
                     paged=True, chunk_tokens=CHUNK, max_new_tokens=WIDE_NEW)


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# training (A8a): the trainer's CLI at full width and depth, and every
# family's gradients on the card against the port on the CPU

TRAIN_ARCH = "smollm-360m"
TRAIN_STEPS = 30
TRAIN_WARMUP = 5
TRAIN_RESUME = 4          # steps after resuming from the checkpoint
TRAIN_CHECK_ARCHS = ("smollm-360m", "rwkv6-1.6b", "granite-moe-1b-a400m",
                     "hymba-1.5b", "whisper-tiny")
# the card against the CPU in f32: 2 layers (whisper 2 + 2) at full
# width, a batch of 2 x 64 text tokens; every leaf of two or more axes
# scaled by TRAIN_CHECK_SCALE, as tests/test_torch_train.py scales JAX's
# draw: at the init's own scale attention saturates and f32 rounding is
# amplified (there JAX's own jitted and eager gradients part by 1.3e-4
# of a leaf's largest)
TRAIN_CHECK_LAYERS = 2
TRAIN_CHECK_SCALE = 0.25
TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 2, 64
# the loss within 1e-5 relative; each gradient leaf within its family's
# bound of the leaf's largest magnitude, plus 1e-8 for a leaf whose
# gradient is zero in exact arithmetic (whisper's key biases hold rounding
# alone).  Each bound sits between the family's f32 reading and its
# control, the same card step with TF32 products (``tf32_worst_rel_err``),
# which the check must refuse.  On an H100 (700 W), worst leaf, the card
# against the CPU and the control: smollm 3.3e-6 and 2.8e-3, granite
# 3.6e-6 and 3.0e-3, hymba 7.5e-6 and 7.3e-3, whisper 1.8e-5 and 2.5e-3,
# rwkv6-1.6b 6.2e-4 (the same in every run) and 1.0.  rwkv6's gap is f32
# rounding through its 64-step WKV recurrence: against the port in
# float64 on the CPU (``tools/train_f64_witness.py``) the card sits 4.8e-4
# and the CPU 5.6e-4 at their worst leaves.  ``card_spread_rel`` is how
# far the card's own gradients move when its parameters move by 1e-7 of
# themselves
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = {"smollm-360m": 1e-4, "rwkv6-1.6b": 2e-3,
                  "granite-moe-1b-a400m": 1e-4, "hymba-1.5b": 1e-4,
                  "whisper-tiny": 1e-4}
TRAIN_GRAD_FLOOR = 1e-8
# then 3 bf16 steps on the card at 4 layers (whisper whole) from float32
# masters, as the trainer takes them: a batch of 4 x 128 text tokens
TRAIN_BF16_LAYERS, TRAIN_BF16_STEPS = 4, 3
TRAIN_BF16_BATCH, TRAIN_BF16_SEQ = 4, 128


def nvidia_smi() -> str:
    """The card's name and power limit, as the last-but-one line."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def phase_train(torch):
    """The trainer's CLI (``repro_torch.launch.train``) at smollm-360m's
    full width and depth, batch 8 x seq 128, into a temporary checkpoint
    directory; the loss must fall (the CLI's exit rule), no kernel may
    launch; s/step (median past the first), tokens/s, peak memory and
    model FLOP/s against the bf16 peak.  Then the checkpoint restored
    bitwise and the CLI resumed from it for a few steps."""
    import shutil
    import statistics
    import tempfile
    from repro_torch.checkpoint import latest_step, restore
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import train as T
    from repro_torch.optim.adam import tree_leaves
    from repro_torch.roofline import analytic, constants
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_train_")

    def argv(steps):
        out = ["--arch", TRAIN_ARCH, "--steps", str(steps), "--warmup",
               str(TRAIN_WARMUP), "--batch", "8", "--seq", "128",
               "--ckpt-dir", ckpt, "--log-every", "10", "--seed", str(SEED)]
        return out + (["--reduced", "--device", "cpu"] if DEV != "cuda"
                      else [])
    try:
        if DEV == "cuda":
            torch.cuda.reset_peak_memory_stats()
        zero_launches()
        res = T.train(T.parse(argv(TRAIN_STEPS)))
        launches = read_launches()
        peak = peak_gib(torch)
        if any(launches.values()):
            raise AssertionError(f"the training path launched kernels: "
                                 f"{launches}")
        rc = T.exit_code(res.losses)
        if rc != 0 or not all(math.isfinite(x) for x in res.losses):
            raise AssertionError(f"train exit {rc}: losses {res.losses}")
        step = latest_step(ckpt)
        if step != TRAIN_STEPS:
            raise AssertionError(f"checkpoint at step {step}")
        saved = restore(res.params, os.path.join(ckpt, f"step_{step}"),
                        device=DEV)
        bitwise = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(saved), tree_leaves(res.params)))
        if not bitwise:
            raise AssertionError("restored parameters differ from the "
                                 "saved ones")
        del saved
        resumed = T.train(T.parse(argv(TRAIN_STEPS + TRAIN_RESUME)))
        launches_resumed = read_launches()
        if (resumed.start != TRAIN_STEPS
                or len(resumed.losses) != TRAIN_RESUME
                or not all(math.isfinite(x) for x in resumed.losses)
                or any(launches_resumed.values())):
            raise AssertionError(f"resume: start {resumed.start}, losses "
                                 f"{resumed.losses}, {launches_resumed}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    cfg = get_config(TRAIN_ARCH)
    if DEV != "cuda":
        cfg = cfg.reduced()
    step_s = statistics.median(res.step_s[1:])
    est = analytic.estimate(cfg, InputShape("train", 128, 8, "train"))
    flops_s = est.model_flops / step_s
    out = dict(phase="train", arch=TRAIN_ARCH, steps=TRAIN_STEPS,
               batch=8, seq=128, layers=cfg.n_layers,
               params=sum(p.numel() for p in tree_leaves(res.params)),
               loss_first=res.losses[0], loss_last=res.losses[-1],
               losses=res.losses, exit_code=rc, first_step_s=res.step_s[0],
               s_per_step=step_s, tokens_per_s=res.tokens_per_step / step_s,
               peak_gib=peak, model_flops_per_step=est.model_flops,
               model_flops_per_s=flops_s,
               mfu=flops_s / constants.PEAK_FLOPS_BF16,
               launches=launches, restored_bitwise=bitwise,
               resumed_from=resumed.start, resumed_losses=resumed.losses,
               resumed_s_per_step=statistics.median(resumed.step_s),
               card=nvidia_smi() if DEV == "cuda" else None)
    emit(out)
    return out


def _scaled(tree, scale):
    from repro_torch.optim.adam import tree_map
    return tree_map(lambda p: p * scale if p.dim() >= 2 else p, tree)


def train_check_batch(torch, cfg, B, S, seed):
    """A training batch of B x S text tokens (+ whisper's frames, drawn
    N(0, 1) from ``seed``), on the CPU."""
    g = torch.Generator().manual_seed(seed)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                   dtype=torch.int32),
           "targets": torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                    dtype=torch.int32)}
    if cfg.arch_type == "audio":
        out["frames"] = torch.randn((B, cfg.frontend.n_tokens, cfg.d_model),
                                    generator=g)
    return out


def loss_and_grads(torch, model, params, batch):
    from repro_torch.optim.adam import tree_leaves
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, met = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return (float(loss.detach()), float(met["xent"].detach()),
            float(met["aux"].detach()), [g.detach() for g in grads])


def float64_loss_and_grads(torch, model, params, batch):
    """``loss_and_grads`` of the port on the CPU in float64 throughout: the
    config's dtype float64, the parameters widened, and ``Tensor.float``
    widening to float64 while it runs (every f32 cast of the model's
    contract included).  The witness the f32 gradients are held to."""
    import dataclasses
    from repro_torch.models import build
    from repro_torch.optim.adam import tree_map
    model64 = build(dataclasses.replace(model.cfg, dtype="float64"))
    params64 = tree_map(lambda p: p.double(), params)
    cast = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        return loss_and_grads(torch, model64, params64, batch)
    finally:
        torch.Tensor.float = cast


def _gaps(got, want):
    """Each leaf's largest |got - want| and ``want``'s largest magnitude,
    on ``got``'s device in its dtype (``want`` moved there): the gradients
    are compared where they lie, not copied to the host."""
    out = []
    for g, w in zip(got, want):
        w = w.to(g.device, g.dtype)
        out.append((float((g - w).abs().max()), float(w.abs().max())))
    return out


def _rel(names, gaps):
    """The gaps over their leaves' largest magnitudes (leaves above 1e-6)."""
    return {n: e / s for n, (e, s) in zip(names, gaps) if s > 1e-6}


def _key_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [k for name, v in tree.items()
                for k in _key_paths(v, f"{prefix}{name}/")]
    return [prefix[:-1]]


def phase_train_check(torch, archs=TRAIN_CHECK_ARCHS, f64=()):
    """Every family's first training step on the card against the port on
    the CPU, f32 at full width and 2 layers (whisper 2 + 2): the same
    parameters and batch, the loss, xent and aux and every gradient leaf
    (TRAIN_LOSS_RTOL, the family's TRAIN_GRAD_TOL), beside the card's own
    rounding spread, the same step with TF32 products (the control each
    bound must sit below) and, for the families in ``f64``, the port on
    the CPU in float64; the MoE routing teacher-forced to
    the CPU's (``ForcedRouting``: a routing within rounding of a top-k tie
    would swap an expert).  Then TRAIN_BF16_STEPS bf16 steps on the card
    at 4 layers (whisper whole) from float32 masters through
    ``make_train_step`` on the token pipeline: finite losses, s/step,
    peak memory.  No kernel may launch."""
    import dataclasses
    import statistics
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline, TokenPipelineConfig
    from repro_torch.data import device_batch
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import build
    from repro_torch.models.common import cdtype
    from repro_torch.optim import Adam, cosine_schedule
    from repro_torch.optim.adam import tree_leaves, tree_map
    rows, fails = [], []
    zero_launches()
    for arch in archs:
        i = TRAIN_CHECK_ARCHS.index(arch)     # its draw's seed
        t0 = time.perf_counter()
        full = get_config(arch)
        if DEV != "cuda":
            full = full.reduced()
        cfg = dataclasses.replace(
            full, n_layers=min(TRAIN_CHECK_LAYERS, full.n_layers),
            n_encoder_layers=min(TRAIN_CHECK_LAYERS, full.n_encoder_layers),
            dtype="float32")
        model = build(cfg)
        cpu = tree_map(lambda p: p.cpu(), _scaled(model.init(
            torch.Generator().manual_seed(SEED + i), DEV, dtype="float32"),
            TRAIN_CHECK_SCALE))
        batch = train_check_batch(torch, cfg, TRAIN_CHECK_BATCH,
                                  TRAIN_CHECK_SEQ, SEED + 10 + i)
        routing = ForcedRouting()
        on_card = lambda params: loss_and_grads(
            torch, model, params, {k: v.to(DEV) for k, v in batch.items()})
        with routing:
            routing.select(0, "step")
            want = loss_and_grads(torch, model, cpu, batch)
            card = tree_map(lambda p: p.to(DEV), cpu)
            routing.select(1, "step")
            got = on_card(card)
            # the card's own rounding spread: its gradients again from
            # the parameters moved by 1e-7 of themselves
            g = torch.Generator(device=DEV).manual_seed(SEED)
            moved = tree_map(lambda p: p * (1 + 1e-7 * torch.randn(
                p.shape, generator=g, device=DEV)), card)
            routing.select(2, "step")
            spread = on_card(moved)
            # the control: the same step with TF32 products
            routing.select(3, "step")
            if DEV == "cuda":
                torch.backends.cuda.matmul.allow_tf32 = True
            try:
                control = on_card(card)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            if arch in f64:
                routing.select(4, "step")
                witness = float64_loss_and_grads(torch, model, cpu, batch)
        names = _key_paths(cpu)
        tol = TRAIN_GRAD_TOL[arch]
        want_card = [w.to(DEV) for w in want[3]]
        gaps = _gaps(got[3], want_card)
        for name, (err, scale) in zip(names, gaps):
            if err > tol * scale + TRAIN_GRAD_FLOOR:
                fails.append((arch, name, err, scale))
        for j, what in enumerate(("loss", "xent", "aux")):
            if abs(got[j] - want[j]) > TRAIN_LOSS_RTOL * abs(want[j]):
                fails.append((arch, what, got[j], want[j]))
        rel = _rel(names, gaps)
        spread_rels = _rel(names, _gaps(spread[3], got[3]))
        tf32 = _rel(names, _gaps(control[3], want_card))
        worst = max(rel, key=rel.get)
        tf32_worst = max(tf32, key=tf32.get)
        row = dict(arch=arch, f32_layers=cfg.n_layers,
                   f32_encoder_layers=cfg.n_encoder_layers,
                   loss_cpu=want[0], loss_card=got[0], xent_cpu=want[1],
                   aux_cpu=want[2], aux_card=got[2],
                   loss_rel_err=abs(got[0] - want[0]) / abs(want[0]),
                   grad_tol=tol, grad_leaves=len(names), worst_leaf=worst,
                   worst_rel_err=rel[worst],
                   card_spread_rel=max(spread_rels.values()),
                   tf32_worst_leaf=tf32_worst,
                   tf32_worst_rel_err=tf32[tf32_worst],
                   tf32_above_bound=tf32[tf32_worst] > tol,
                   rel_errs=rel,
                   router_flips=routing.flips,
                   router_margin=routing.margin)
        if arch in f64:
            f64_card = _rel(names, _gaps(got[3], witness[3]))
            f64_cpu = _rel(names, _gaps(want[3], witness[3]))
            row.update(
                loss_f64=witness[0], spread_rels=spread_rels,
                f64_card_rel=f64_card, f64_cpu_rel=f64_cpu,
                f64_card_worst_rel_err=max(f64_card.values()),
                f64_cpu_worst_rel_err=max(f64_cpu.values()))
            del witness
        row["f32_s"] = time.perf_counter() - t0
        del card, moved, cpu, want, want_card, got, spread, control
        free_card(torch)
        # bf16 steps at 4 layers (whisper whole) from float32 masters
        cfg16 = dataclasses.replace(
            full, n_layers=min(TRAIN_BF16_LAYERS, full.n_layers))
        model16 = build(cfg16)
        params = model16.init(torch.Generator().manual_seed(SEED + i), DEV,
                              dtype="float32")
        if DEV == "cuda":
            torch.cuda.reset_peak_memory_stats()
        opt = Adam(lr=cosine_schedule(3e-4, 1, TRAIN_BF16_STEPS),
                   clip_norm=1.0)
        state, step = opt.init(params), make_train_step(model16, opt)
        pipe = TokenPipeline(TokenPipelineConfig(
            vocab_size=cfg16.vocab_size, seq_len=TRAIN_BF16_SEQ,
            global_batch=TRAIN_BF16_BATCH, seed=SEED))
        extra = {}
        if cfg16.arch_type == "audio":
            extra["frames"] = torch.randn(
                (TRAIN_BF16_BATCH, cfg16.frontend.n_tokens, cfg16.d_model),
                generator=torch.Generator().manual_seed(SEED)).to(
                DEV, cdtype(cfg16))
        losses, secs = [], []
        for n in range(TRAIN_BF16_STEPS):
            tb = time.perf_counter()
            params, state, loss, _ = step(
                params, state, {**device_batch(pipe.batch(n), DEV), **extra})
            losses.append(float(loss))
            secs.append(time.perf_counter() - tb)
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"train-check {arch} bf16: {losses}")
        row.update(bf16_layers=cfg16.n_layers,
                   bf16_encoder_layers=cfg16.n_encoder_layers,
                   bf16_losses=losses, bf16_first_step_s=secs[0],
                   bf16_s_per_step=statistics.median(secs[1:]),
                   bf16_peak_gib=peak_gib(torch),
                   bf16_params=sum(p.numel() for p in tree_leaves(params)))
        rows.append(row)
        del params, state
        free_card(torch)
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"the training path launched kernels: "
                             f"{launches}")
    out = dict(phase="train-check", rows=rows, launches=launches,
               loss_rtol=TRAIN_LOSS_RTOL, grad_tol=TRAIN_GRAD_TOL,
               grad_floor=TRAIN_GRAD_FLOOR, weight_scale=TRAIN_CHECK_SCALE,
               card=nvidia_smi() if DEV == "cuda" else None)
    emit(out)
    if fails:
        raise AssertionError(f"train-check: the card against the CPU: "
                             f"{fails}")
    return out


# ---------------------------------------------------------------------------
# phases dist-*: the multi-device port on four ranks that share the card

# One H100 and NCCL refuses two ranks on one device, so the sharded paths
# run as 4 processes on cuda:0 over a gloo group (a FileStore in a
# temporary directory, GLOO_SOCKET_IFNAME=lo in the ranks), mesh (2, 2)
# data x model; gloo copies CUDA tensors through host memory, so their
# collective times are host-staged, not a multi-card figure.  Every
# one-process reference is computed once, here in the parent, before or
# after the spawn (the ranks share the card's SMs).
DIST_MESH = (2, 2)
DIST_TIMEOUT_S = 600
# dist-decode: K6 on each rank's half of a 4,096-position bf16 cache
DIST_DECODE_B, DIST_DECODE_S = 4, 4096
# dist-moe: granite-moe-1b-a400m's MoE block at full width in f32, 4 x 256
# tokens leaning to expert 0 (drops at a capacity factor of 1.25)
DIST_MOE_SHAPE = (4, 256)
DIST_MOE_LEAN = 8.0
# outputs within 1e-5 of the largest magnitude (f32 sums in another order)
DIST_MOE_TOL = 1e-5
# dist-train: (arch, layers (None: all), batch, seq), two steps in f32
DIST_TRAIN = (("smollm-360m", None, 8, 1024),
              ("granite-moe-1b-a400m", 4, 8, 1024))
DIST_TRAIN_LR = 1e-5
# dist-serve: smollm-360m at full width and depth, 4 slots, 16-token
# prompts, a cache of 96 (48 positions a model rank: the second rank's
# slice is empty until step 32), 48 steps
DIST_SERVE = dict(slots=4, prompt=16, cache=96, steps=48, tokens_per_step=4,
                  burn_in=2)
DIST_SERVE_F = 960
# dist-nccl: one rank, NCCL, mesh (1, 1): smollm-360m at 4 layers
DIST_NCCL_LAYERS, DIST_NCCL_BATCH, DIST_NCCL_SEQ = 4, 8, 128
# (a CPU rehearsal of the phases, DEV "cpu", runs this rank on gloo)
DIST_NCCL_BACKEND = "nccl"
DIST_NEED = ("flash_decode", "flash_attention", "serving_probe_step")


# dist-train's MoE: top-k routing is a step function of the router's
# probabilities, and at 8 x 1,024 tokens x 4 layers some tokens' k-th and
# (k+1)-th probabilities lie within f32 rounding of each other, so the
# sharded forward (its sums in another order) may route a token to
# another expert than the one-process forward does, which moves an
# expert's gradient by that token's whole share.  The check therefore
# fixes the discrete choice: the reference records each call's top-k
# experts and the ranks run with them (gates from their own
# probabilities), and every token whose own top-k differs must be such a
# near-tie: the best expert left out within DIST_ROUTE_TIE of the worst
# one taken, in probability.
DIST_ROUTE_TIE = 1e-6


class RouteTape:
    """``moe._router`` recording each call's top-k experts (``routes`` None)
    or replaying ``routes``, a list by step of lists by data half of
    lists by layer; in the replay, call c of a step is layer c on the way
    forward and layer 2L - 1 - c in remat's recomputation on the way back.
    Counts the tokens whose own top-k differs from the replayed one and
    their widest gap."""

    def __init__(self, moe, layers, routes=None, half=0, remat=True):
        self.moe, self.orig = moe, moe._router
        self.layers, self.routes, self.half = layers, routes, half
        self.per_step = 2 * layers if remat else layers
        self.calls, self.taped = 0, []
        self.flips, self.flip_gap = 0, 0.0

    def __enter__(self):
        self.moe._router = self
        return self

    def __exit__(self, *exc):
        self.moe._router = self.orig

    def __call__(self, params, x, cfg):
        import torch
        logits, probs, gates, idx = self.orig(params, x, cfg)
        c, self.calls = self.calls, self.calls + 1
        if self.routes is None:
            self.taped.append(idx.detach().clone())
            return logits, probs, gates, idx
        step, c = divmod(c, self.per_step)
        layer = c if c < self.layers else 2 * self.layers - 1 - c
        forced = self.routes[step][self.half][layer].to(idx.device)
        # the expert set, or the first expert (the load-balance term's)
        differ = ((idx.sort(-1).values != forced.sort(-1).values).any(-1)
                  | (idx[:, 0] != forced[:, 0]))
        if bool(differ.any()):
            p, f, n = probs.detach()[differ], forced[differ], idx[differ]
            left = p.scatter(-1, f, -1.0).max(-1).values
            gap = torch.maximum(left - p.gather(-1, f).min(-1).values,
                                p.gather(-1, n[:, :1])[:, 0]
                                - p.gather(-1, f[:, :1])[:, 0])
            self.flips += int(differ.sum())
            self.flip_gap = max(self.flip_gap, float(gap.max()))
        gates = probs.gather(-1, forced)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        return logits, probs, gates, forced


def dist_decode_inputs(torch, H, KV, d):
    """A bf16 cache of DIST_DECODE_S positions, rows: 0 valid at random
    (70%), 1 empty on the second model rank's half, 2 empty on the first's,
    3 empty everywhere."""
    g = torch.Generator().manual_seed(SEED + 34 + H)
    B, S = DIST_DECODE_B, DIST_DECODE_S
    q = torch.randn(B, H, d, generator=g).to(torch.bfloat16).to(DEV)
    k = torch.randn(B, KV, S, d, generator=g).to(torch.bfloat16).to(DEV)
    v = torch.randn(B, KV, S, d, generator=g).to(torch.bfloat16).to(DEV)
    valid = torch.rand(B, S, generator=g) > 0.3
    valid[:, 0] = True
    valid[1, S // 2:] = False
    valid[2, :S // 2] = False
    valid[3] = False
    return q, k, v, valid.to(DEV)


def dist_moe_inputs(torch, capacity):
    """granite-moe-1b-a400m's MoE leaves (one layer, f32) and tokens."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.common import init_params
    cfg = get_config(GRANITE_ARCH)
    cfg = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity))
    params = init_params(moe.moe_decls(cfg),
                         torch.Generator().manual_seed(SEED + 35))
    g = torch.Generator().manual_seed(SEED + 36)
    x = torch.randn(*DIST_MOE_SHAPE, cfg.d_model, generator=g)
    u = params["router"][:, 0] / params["router"][:, 0].norm()
    return cfg, params, x + DIST_MOE_LEAN * u


def dist_train_model(torch, arch, layers, dev):
    """(model, f32 parameters at TRAIN_CHECK_SCALE) drawn on ``dev`` from
    the seed; the MoE at a capacity factor of 8.0 (nothing dropped)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, dtype="float32",
                              n_layers=layers or cfg.n_layers)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(SEED + 37), dev,
                        dtype="float32")
    return model, _scaled(params, TRAIN_CHECK_SCALE)


def dist_serve_model(torch, dtype, layers=None):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.probe import ProbeConfig, init_outer
    from repro_torch.models import build
    cfg = get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(cfg, dtype=dtype,
                              n_layers=layers or cfg.n_layers)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(SEED + 38), DEV)
    pc = ProbeConfig(d_phi=cfg.d_model)
    theta = init_outer(pc, torch.Generator().manual_seed(SEED + 39),
                       device=DEV)
    toks = torch.randint(0, cfg.vocab_size, (DIST_SERVE["slots"],
                                             DIST_SERVE["prompt"]),
                         generator=torch.Generator().manual_seed(SEED + 40),
                         dtype=torch.int32).to(DEV)
    return model, params, pc, theta, toks


def dist_serve_run(torch, model, params, pc, theta, toks, lam, steps=None):
    """Prefill ``toks`` and run the one-token serve step: per step the
    tokens, smoothed scores and stops (steps x rows), and the collectives
    of the steps (``parallel.collective_stats``; those of the prefill
    apart)."""
    from repro_torch import parallel
    from repro_torch.serving import ServeConfig
    from repro_torch.serving.engine import init_probe_state, make_serve_step
    cfg = model.cfg
    steps = steps or DIST_SERVE["steps"]
    parallel.reset_collectives()
    cache, _, _ = model.prefill(cfg, params, {"tokens": toks},
                                DIST_SERVE["cache"])
    prefill = parallel.collective_stats()
    parallel.reset_collectives()
    st = init_probe_state(pc, theta, toks.shape[0], cfg.d_model)
    step = make_serve_step(model, pc, theta, ServeConfig(
        tokens_per_step=DIST_SERVE["tokens_per_step"], lam=lam,
        burn_in=DIST_SERVE["burn_in"]))
    tok = toks[:, -1].clone()
    pos = torch.full((toks.shape[0],), toks.shape[1], dtype=torch.int32,
                     device=toks.device)
    out = []
    t0 = time.perf_counter()
    for _ in range(steps):
        tok, cache, st = step(params, tok, cache, pos, st)
        pos = pos + 1
        out.append((tok.clone(), st.smoothed.clone(), st.stopped.clone()))
    sync(torch)
    return ([torch.stack(x) for x in zip(*out)],
            dict(step_ms=(time.perf_counter() - t0) / steps * 1e3,
                 prefill=prefill, steps=parallel.collective_stats()))


def _per_step(stats, n):
    """Collective stats over n steps -> calls, bytes and seconds a step."""
    return {k: {f: v / n for f, v in rec.items()} for k, rec in stats.items()}


def _rank_setup(torch):
    """A rank on the card: TF32 off, cuda:0 current, the kernels' library
    (built by phase build) loaded."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if DEV == "cuda":
        torch.cuda.set_device(0)
        torch.zeros(1, device=DEV)
        from repro_torch.kernels import _build
        _build.library()


def _peak_gib(torch, reset=False) -> float:
    if DEV != "cuda":
        return 0.0
    if reset:
        torch.cuda.reset_peak_memory_stats()
    return torch.cuda.max_memory_allocated() / 2 ** 30


def dist_rank(rank, world, ref_dir, lam):
    """The four ranks' side of phases dist-decode, dist-moe, dist-train
    and dist-serve (a spawned process: everything imported here)."""
    import torch
    from repro_torch import parallel
    from repro_torch.configs import InputShape
    from repro_torch.launch import shardings as SH
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import attention as A
    from repro_torch.models import moe
    from repro_torch.models.common import param_specs
    from repro_torch.optim import Adam
    from repro_torch.optim.adam import tree_leaves
    _rank_setup(torch)
    mesh = make_test_mesh(DIST_MESH, device_type=DEV)
    dr, mr = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    out = {"rank": rank, "data_rank": dr, "model_rank": mr}

    def timed(name, fn):
        _peak_gib(torch, reset=True)
        sync(torch)
        t0 = time.perf_counter()
        res = fn()
        sync(torch)
        res["seconds"] = time.perf_counter() - t0
        res["peak_gib"] = _peak_gib(torch)
        out[name] = res

    def decode():
        res = {}
        ctx = parallel.ParallelContext(
            mesh=mesh, rules={"batch": "data", "kv_seq": "model"},
            flash_decode=True)
        half = DIST_DECODE_B // 2
        rows = slice(dr * half, (dr + 1) * half)
        s_loc = DIST_DECODE_S // 2
        seq = slice(mr * s_loc, (mr + 1) * s_loc)
        for H, KV, d, _ in (SMOLLM, GRANITE):
            q, k, v, valid = dist_decode_inputs(torch, H, KV, d)
            parallel.reset_collectives()
            with parallel.use_parallel(ctx):
                o, l, m = A._flash_decode_sharded(
                    ctx, q[rows], k[rows, :, seq].contiguous(),
                    v[rows, :, seq].contiguous(),
                    valid[rows, seq].contiguous())
            res[f"{d}-{H // KV}"] = dict(
                o=o, l=l, m=m, collectives=parallel.collective_stats())
        return res

    def moe_block():
        res = {}
        for capacity in (8.0, 1.25):
            cfg, params, x = dist_moe_inputs(torch, capacity)
            ctx = SH.make_context(cfg, mesh, InputShape(
                "t", DIST_MOE_SHAPE[1], DIST_MOE_SHAPE[0], "train"),
                multi_pod=False)
            decls = moe.moe_decls(cfg)
            specs = param_specs(decls, ctx.rules)
            half = DIST_MOE_SHAPE[0] // 2
            xl = x[dr * half:(dr + 1) * half]
            ys = {}
            for dev in (DEV, "cpu"):
                local = SH.with_shardings({k: t.to(dev) for k, t in
                                           params.items()}, specs, mesh)
                parallel.reset_collectives()
                with parallel.use_parallel(ctx), torch.no_grad():
                    y, aux = moe.moe_ep(SH.compute_params(decls, local, ctx),
                                        xl.to(dev), cfg, ctx)
                ys[dev] = y.float().cpu()
                if dev == DEV:
                    res[f"{capacity}/collectives"] = \
                        parallel.collective_stats()
                if capacity == 8.0:
                    break
            res[f"{capacity}/y"] = ys[DEV]
            if capacity != 8.0:
                res[f"{capacity}/cuda_vs_cpu"] = float(
                    (ys[DEV] - ys["cpu"]).abs().max()
                    / ys["cpu"].abs().max())
        return res

    def train():
        res = {}
        for arch, layers, B, S in DIST_TRAIN:
            model, params = dist_train_model(torch, arch, layers, DEV)
            shape = InputShape("t", S, B, "train")
            ctx = SH.make_context(model.cfg, mesh, shape, multi_pod=False)
            specs = model.specs(ctx.rules)
            local = SH.with_shardings(params, specs, mesh)
            del params
            batch = {k: t.to(DEV) for k, t in train_check_batch(
                torch, model.cfg, B, S, SEED + 41).items()}
            lb = SH.with_shardings(batch, SH.batch_spec_tree(
                batch, ctx.rules), mesh)
            ref = torch.load(os.path.join(ref_dir, f"{arch}.pt"),
                             mmap=True)
            opt = Adam(lr=DIST_TRAIN_LR, clip_norm=1.0)
            state = opt.init(local)
            row = dict(rules={k: v for k, v in ctx.rules.items()},
                       ep_moe=ctx.ep_moe, attn_impl=ctx.attn_impl,
                       remat=ctx.remat, losses=[], worst_rel=[], steps_s=[])
            tape = RouteTape(moe, model.cfg.n_layers, ref["routes"], dr,
                             remat=ctx.remat)
            for i in range(2):
                parallel.reset_collectives()
                t0 = time.perf_counter()
                with parallel.use_parallel(ctx), tape:
                    loss, _, grads = T.loss_and_grads(model, local, lb)
                    state = T.apply_update(model, opt, local, grads, state)
                sync(torch)
                row["steps_s"].append(time.perf_counter() - t0)
                row["collectives_a_step"] = parallel.collective_stats()
                row["losses"].append(float(loss))
                worst = 0.0
                for g, r, spec in zip(tree_leaves(grads),
                                      ref[f"grads{i}"],
                                      tree_leaves(specs)):
                    r = r.to(DEV)
                    gap = float((g - SH.local_shard(r, spec, mesh))
                                .abs().max())
                    worst = max(worst, gap / max(float(r.abs().max()),
                                                 1e-30))
                row["worst_rel"].append(worst)
            row.update(route_flips=tape.flips, route_flip_gap=tape.flip_gap)
            del local, state, grads, lb, ref
            free_card(torch)
            res[arch] = row
        return res

    def serve():
        from repro_torch.kernels import flash_decode as K6
        res = {}
        for dtype in ("float32", "bfloat16"):
            model, params, pc, theta, toks = dist_serve_model(torch, dtype)
            ctx = SH.make_context(model.cfg, mesh, InputShape(
                "d", DIST_SERVE["cache"], DIST_SERVE["slots"], "decode"),
                multi_pod=False)
            local = SH.with_shardings(params, model.specs(ctx.rules), mesh)
            del params
            half = DIST_SERVE["slots"] // 2
            rows = toks[dr * half:(dr + 1) * half]
            served = A.flash_decode
            checked = CheckedK6(K6)
            if dtype == "bfloat16":
                A.flash_decode = checked
            if dtype == "float32":
                zero_launches()
            try:
                with parallel.use_parallel(ctx):
                    (tk, sm, sp), stats = dist_serve_run(
                        torch, model, local, pc, theta, rows, lam)
            finally:
                A.flash_decode = served
            row = dict(tokens=tk, smoothed=sm, stopped=sp,
                       step_ms=stats["step_ms"],
                       prefill_collectives=stats["prefill"],
                       collectives_a_step=_per_step(stats["steps"],
                                                    DIST_SERVE["steps"]))
            if dtype == "float32":
                row["launches"] = read_launches()
            else:
                row.update(k6_checked_calls=checked.calls,
                           k6_m_rel_err=checked.m_err,
                           k6_out_err=checked.out_err)
            res[dtype] = row
            del local
            free_card(torch)
        return res

    timed("dist-decode", decode)
    timed("dist-moe", moe_block)
    timed("dist-train", train)
    timed("dist-serve", serve)
    return out


def dist_nccl_rank(rank, world):
    """Phase dist-nccl's rank: the same step functions on an NCCL group
    of one rank, mesh (1, 1), against the same rank without a context."""
    import torch
    from repro_torch import parallel
    from repro_torch.configs import InputShape
    from repro_torch.launch import shardings as SH
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim.adam import tree_leaves
    _rank_setup(torch)
    mesh = make_test_mesh((1, 1), device_type=DEV)
    out = {"backend": torch.distributed.get_backend()}
    model, params = dist_train_model(torch, TRAIN_ARCH, DIST_NCCL_LAYERS,
                                     DEV)
    shape = InputShape("t", DIST_NCCL_SEQ, DIST_NCCL_BATCH, "train")
    batch = {k: t.to(DEV) for k, t in train_check_batch(
        torch, model.cfg, DIST_NCCL_BATCH, DIST_NCCL_SEQ, SEED + 42).items()}
    ctx = SH.make_context(model.cfg, mesh, shape, multi_pod=False)
    loss0, _, grads0 = T.loss_and_grads(model, params, batch)
    local = SH.with_shardings(params, model.specs(ctx.rules), mesh)
    with parallel.use_parallel(ctx):
        loss1, _, grads1 = T.loss_and_grads(model, local, batch)
    out["train_loss"] = (float(loss0), float(loss1))
    out["train_worst_rel"] = max(
        float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        for a, b in zip(tree_leaves(grads1), tree_leaves(grads0)))
    del params, local, grads0, grads1
    model, params, pc, theta, toks = dist_serve_model(torch, "float32",
                                                      DIST_NCCL_LAYERS)
    dctx = SH.make_context(model.cfg, mesh, InputShape(
        "d", DIST_SERVE["cache"], DIST_SERVE["slots"], "decode"),
        multi_pod=False)
    (tk0, _, sp0), _ = dist_serve_run(torch, model, params, pc, theta, toks,
                                      1e9, steps=1)
    with parallel.use_parallel(dctx):
        (tk1, _, sp1), _ = dist_serve_run(torch, model, params, pc, theta,
                                          toks, 1e9, steps=1)
    out["serve_tokens_equal"] = bool(torch.equal(tk0, tk1)
                                     and torch.equal(sp0, sp1))
    out["peak_gib"] = _peak_gib(torch)
    return out


def dist_references(torch, ref_dir):
    """The one-process references, on the card: each dist-train model's two
    steps (the mean over the two data halves of the loss and of the
    gradients, as the ranks average the MoE aux over the data ranks; Adam
    on them) saved for the ranks, and the dist-serve lambda (between the
    rows' peak f32 scores past the burn-in, so some rows stop)."""
    from repro_torch.launch import train as T
    from repro_torch.models import moe
    from repro_torch.optim import Adam
    from repro_torch.optim.adam import tree_leaves, tree_map
    out = {}
    free_card(torch)
    for arch, layers, B, S in DIST_TRAIN:
        model, params = dist_train_model(torch, arch, layers, DEV)
        batch = {k: t.to(DEV) for k, t in train_check_batch(
            torch, model.cfg, B, S, SEED + 41).items()}
        opt = Adam(lr=DIST_TRAIN_LR, clip_norm=1.0)
        state = opt.init(params)
        ref, losses = {}, []
        n_layers = model.cfg.n_layers
        t0 = time.perf_counter()
        with RouteTape(moe, n_layers) as tape:
            for i in range(2):
                loss, grads = 0.0, None
                for h in range(2):
                    half = {k: t[h * B // 2:(h + 1) * B // 2]
                            for k, t in batch.items()}
                    l, _, g = T.loss_and_grads(model, params, half)
                    loss += float(l) / 2
                    grads = g if grads is None else tree_map(
                        lambda a, b: (a + b) / 2, grads, g)
                losses.append(loss)
                ref[f"grads{i}"] = [g.cpu() for g in tree_leaves(grads)]
                state = T.apply_update(model, opt, params, grads, state)
        sync(torch)
        # by step, data half and layer (empty without experts)
        ref["routes"] = [[[tape.taped[(2 * i + h) * n_layers + l].cpu()
                           for l in range(n_layers)] for h in range(2)]
                         for i in range(len(tape.taped) // (2 * n_layers))]
        torch.save(ref, os.path.join(ref_dir, f"{arch}.pt"))
        out[arch] = dict(losses=losses, seconds=time.perf_counter() - t0)
        del params, state, grads, ref
        free_card(torch)
    model, params, pc, theta, toks = dist_serve_model(torch, "float32")
    (_, sm, _), _ = dist_serve_run(torch, model, params, pc, theta, toks,
                                   1e9)
    peak = sm[DIST_SERVE["burn_in"] * DIST_SERVE["tokens_per_step"]:].max(
        0).values
    lam = float((peak.min() + peak.max()) / 2)
    (tk, sm, sp), stats = dist_serve_run(torch, model, params, pc, theta,
                                         toks, lam)
    out["serve"] = dict(lam=lam, tokens=tk.cpu(), smoothed=sm.cpu(),
                        stopped=sp.cpu(), step_ms=stats["step_ms"])
    out["decode"] = {}
    from repro_torch.kernels import flash_decode as K6
    for H, KV, d, _ in (SMOLLM, GRANITE):
        q, k, v, valid = dist_decode_inputs(torch, H, KV, d)
        out["decode"][f"{d}-{H // KV}"] = dict(
            kernel=[t.cpu() for t in K6.flash_decode(
                q, k, v, valid, return_partials=True)],
            plain=[t.cpu() for t in K6.flash_decode_plain(
                q, k, v, valid, return_partials=True)],
            v_scale=v_scale(v), valid=valid.cpu())
    cfg, params, x = dist_moe_inputs(torch, 8.0)
    with torch.no_grad():
        out["moe_dense"] = moe.moe_dense(
            {k: t.to(DEV) for k, t in params.items()}, x.to(DEV),
            cfg).float().cpu()
    del model, params
    free_card(torch)
    return out


def _normalised(o, l):
    return o / l.clamp(min=1e-30)[..., None]


def phase_dist(torch):
    """Phases dist-decode, dist-moe, dist-train and dist-serve: one spawn
    of four ranks on the card (``dist_rank``), held to the references of
    ``dist_references``; each phase's seconds, collectives by axis (calls,
    bytes and host seconds a step), each rank's peak memory."""
    import tempfile

    import numpy as np
    from repro_torch.launch.mesh import spawn_ranks
    with tempfile.TemporaryDirectory() as ref_dir:
        t0 = time.perf_counter()
        ref = dist_references(torch, ref_dir)
        ref_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = spawn_ranks(dist_rank, 4, (ref_dir, ref["serve"]["lam"]),
                            backend="gloo", device=DEV,
                            timeout_s=DIST_TIMEOUT_S, threads=2)
        spawn_s = time.perf_counter() - t0
    by_pos = {(int(r["data_rank"]), int(r["model_rank"])): r for r in ranks}
    peaks = lambda name: [float(r[name]["peak_gib"]) for r in ranks]
    secs = lambda name: max(float(r[name]["seconds"]) for r in ranks)
    # dist-decode: the rows of each data rank (model ranks agree) against
    # one-process K6 and its plain version; two slices' errors add
    dec = {}
    for key, rr in ref["decode"].items():
        want_k = [torch.as_tensor(t) for t in rr["kernel"]]
        want_p = [torch.as_tensor(t) for t in rr["plain"]]
        got = [torch.cat([torch.as_tensor(by_pos[(d, 0)]["dist-decode"][key][f])
                          for d in (0, 1)]) for f in ("o", "l", "m")]
        for d in (0, 1):
            for f in ("o", "l", "m"):
                if not np.array_equal(by_pos[(d, 0)]["dist-decode"][key][f],
                                      by_pos[(d, 1)]["dist-decode"][key][f]):
                    raise AssertionError(f"dist-decode {key}: the model ranks"
                                         f" of data rank {d} disagree on {f}")
        live = rr["valid"].any(1)
        out_g = _normalised(got[0], got[1])
        errs = {}
        for name, want in (("kernel", want_k), ("plain", want_p)):
            out_w = _normalised(want[0], want[1])
            errs[f"out_err_vs_{name}"] = float(
                (out_g - out_w)[live].abs().max())
            errs[f"m_rel_err_vs_{name}"] = float(
                ((got[2] - want[2]).abs() / want[2].abs().clamp(min=1.0))
                [live].max())
        tol = 2 * K6_OUT_TOL * rr["v_scale"]
        if not (max(errs[k] for k in errs if k.startswith("out"))
                <= tol and max(errs[k] for k in errs if k.startswith("m"))
                <= K6_M_TOL):
            raise AssertionError(f"dist-decode {key}: {errs}, tol {tol}")
        if not (float(got[0][~live].abs().max()) == 0.0
                and float(got[1][~live].abs().max()) == 0.0):
            raise AssertionError(f"dist-decode {key}: an empty row is not "
                                 "(o, l) = (0, 0)")
        dec[key] = dict(errs, tol=tol, collectives=by_pos[(0, 0)][
            "dist-decode"][key]["collectives"])
    emit(dict(phase="dist-decode", B=DIST_DECODE_B, S=DIST_DECODE_S,
              S_a_rank=DIST_DECODE_S // 2, cache="bf16", cases=dec,
              seconds=secs("dist-decode"), peak_gib=peaks("dist-decode")))
    # dist-moe
    y8 = torch.cat([torch.as_tensor(by_pos[(d, 0)]["dist-moe"]["8.0/y"])
                    for d in (0, 1)])
    rel8 = float((y8 - ref["moe_dense"]).abs().max()
                 / ref["moe_dense"].abs().max())
    y125 = torch.cat([torch.as_tensor(by_pos[(d, 0)]["dist-moe"]["1.25/y"])
                      for d in (0, 1)])
    dropped = float((y125 - ref["moe_dense"]).abs().max()
                    / ref["moe_dense"].abs().max())
    cpu_rel = max(float(r["dist-moe"]["1.25/cuda_vs_cpu"]) for r in ranks)
    if not (rel8 <= DIST_MOE_TOL and cpu_rel <= DIST_MOE_TOL
            and dropped > DIST_MOE_TOL):
        raise AssertionError(f"dist-moe: capacity 8.0 against moe_dense "
                             f"{rel8}, 1.25 on the card against the CPU "
                             f"{cpu_rel}, 1.25 against dense {dropped}")
    n_experts = dist_moe_inputs(torch, 8.0)[0].moe.n_experts
    emit(dict(phase="dist-moe", arch=GRANITE_ARCH, tokens=DIST_MOE_SHAPE,
              experts=n_experts, experts_a_rank=n_experts // DIST_MESH[1],
              rel_err_vs_dense_cap8=rel8,
              rel_err_card_vs_cpu_cap1_25=cpu_rel,
              rel_gap_vs_dense_cap1_25=dropped, tol=DIST_MOE_TOL,
              collectives=by_pos[(0, 0)]["dist-moe"]["8.0/collectives"],
              seconds=secs("dist-moe"), peak_gib=peaks("dist-moe")))
    # dist-train
    train = {}
    for arch, layers, B, S in DIST_TRAIN:
        rows = [r["dist-train"][arch] for r in ranks]
        worst = [max(float(w) for w in r["worst_rel"]) for r in rows]
        losses = [float(l) for l in rows[0]["losses"]]
        loss_err = max(abs(a - b) / abs(b) for a, b in
                       zip(losses, ref[arch]["losses"]))
        tol = TRAIN_GRAD_TOL[arch]
        flip_gap = max(float(r["route_flip_gap"]) for r in rows)
        if not (max(worst) <= tol and loss_err <= TRAIN_LOSS_RTOL
                and flip_gap <= DIST_ROUTE_TIE):
            raise AssertionError(f"dist-train {arch}: gradients {worst} "
                                 f"(bound {tol}), loss {loss_err}, a token "
                                 f"routed apart by {flip_gap}")
        r0 = rows[0]
        train[arch] = dict(
            layers=layers, batch=B, seq=S, rules=r0["rules"],
            ep_moe=bool(r0["ep_moe"]), attn_impl=str(r0["attn_impl"]),
            remat=bool(r0["remat"]), losses=losses,
            one_process_losses=ref[arch]["losses"], loss_rel_err=loss_err,
            worst_grad_rel=max(worst), bound=tol,
            route_flips=[int(r["route_flips"]) for r in rows],
            route_flip_gap=flip_gap, route_tie=DIST_ROUTE_TIE,
            step_s=[float(s) for s in r0["steps_s"]],
            one_process_s=ref[arch]["seconds"],
            collectives_a_step=r0["collectives_a_step"])
    emit(dict(phase="dist-train", runs=train, seconds=secs("dist-train"),
              peak_gib=peaks("dist-train")))
    # dist-serve
    rs = ref["serve"]
    got = {f: torch.cat([torch.as_tensor(by_pos[(d, 0)]["dist-serve"]
                                          ["float32"][f]) for d in (0, 1)],
                        dim=1) for f in ("tokens", "smoothed", "stopped")}
    if not (torch.equal(got["tokens"], rs["tokens"])
            and torch.equal(got["stopped"], rs["stopped"])):
        raise AssertionError("dist-serve f32: tokens or stops differ from "
                             "the one-process serve step")
    stops = rs["stopped"][-1]
    if not (bool(stops.any()) and not bool(stops.all())):
        raise AssertionError("dist-serve f32: every row or none stopped")
    launches = [r["dist-serve"]["float32"]["launches"] for r in ranks]
    for r, la in enumerate(launches):
        # (CPU tensors take the plain versions: a rehearsal counts none)
        missing = [k for k in DIST_NEED if int(la[k]) < 1]
        if missing and DEV == "cuda":
            raise AssertionError(f"dist-serve: rank {r} never launched "
                                 f"{missing}")
    bf = [r["dist-serve"]["bfloat16"] for r in ranks]
    emit(dict(phase="dist-serve", arch=TRAIN_ARCH, **DIST_SERVE,
              lam=rs["lam"], stops=int(stops.sum()),
              smoothed_max_abs_err=float((got["smoothed"]
                                          - rs["smoothed"]).abs().max()),
              launches_by_rank=[{k: int(la[k]) for k in DIST_NEED}
                                for la in launches],
              step_ms_f32=[float(r["dist-serve"]["float32"]["step_ms"])
                           for r in ranks],
              step_ms_bf16=[float(b["step_ms"]) for b in bf],
              one_process_step_ms_f32=rs["step_ms"],
              bf16_k6_checked_calls=[int(b["k6_checked_calls"]) for b in bf],
              bf16_k6_m_rel_err=max(float(b["k6_m_rel_err"]) for b in bf),
              bf16_k6_out_err=max(float(b["k6_out_err"]) for b in bf),
              collectives_a_step=by_pos[(0, 0)]["dist-serve"]["float32"][
                  "collectives_a_step"],
              prefill_collectives=by_pos[(0, 0)]["dist-serve"]["float32"][
                  "prefill_collectives"],
              references_s=ref_s, spawn_s=spawn_s,
              seconds=secs("dist-serve"), peak_gib=peaks("dist-serve")))
    return dict(decode=dec, launches=launches, bf16=bf, k6_err=max(
        [max(v["out_err_vs_kernel"], v["out_err_vs_plain"])
         for v in dec.values()] + [float(b["k6_out_err"]) for b in bf]))


def phase_dist_nccl(torch):
    from repro_torch.launch.mesh import spawn_ranks
    t0 = time.perf_counter()
    res = spawn_ranks(dist_nccl_rank, 1, (), backend=DIST_NCCL_BACKEND,
                      device="cuda:0" if DEV == "cuda" else DEV,
                      timeout_s=DIST_TIMEOUT_S, threads=2)[0]
    loss0, loss1 = (float(x) for x in res["train_loss"])
    worst = float(res["train_worst_rel"])
    if not (str(res["backend"]) == DIST_NCCL_BACKEND
            and abs(loss1 - loss0) <= TRAIN_LOSS_RTOL * abs(loss0)
            and worst <= TRAIN_GRAD_TOL[TRAIN_ARCH]
            and bool(res["serve_tokens_equal"])):
        raise AssertionError(f"dist-nccl: {res}")
    emit(dict(phase="dist-nccl", backend=str(res["backend"]), mesh=(1, 1),
              layers=DIST_NCCL_LAYERS, batch=DIST_NCCL_BATCH,
              seq=DIST_NCCL_SEQ, losses=(loss0, loss1),
              worst_grad_rel=worst, serve_tokens_equal=True,
              peak_gib=float(res["peak_gib"]),
              seconds=time.perf_counter() - t0))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build      # needs the repo's src/
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    lib = _build.build()
    build_s = time.perf_counter() - t0
    log = (lib.parent / "build.log").read_text()
    emit(dict(phase="build", seconds=build_s, library=os.path.relpath(
        lib, ROOT), sources=[ln[3:] for ln in log.splitlines()
                             if ln.startswith("== ")],
        ptxas=[ln.strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln
               or "Compiling entry" in ln]))
    _build.library()
    timer = Timer(torch)
    k1 = phase_k1(torch, timer)
    k2 = phase_k2(torch, timer)
    k3 = phase_k3(torch, timer)
    k4 = phase_k4(torch, timer)
    splits = corpus()
    k5 = phase_k5(torch, timer, splits[2])
    k6 = phase_k6(torch, timer)
    k7 = phase_k7(torch, timer)
    model = phase_model(torch)
    zero_launches()
    chunked = phase_model_chunked(torch)
    b3_launches = read_launches()["paged_flash_prefill_chunk"]
    if b3_launches < 1:
        raise AssertionError("K3-B3 never ran in the chunked model phase")
    phase_model_spec(torch)
    served, out = phase_serve(torch)
    phase_trace(torch, out.scheduler)
    phase_harvest(torch, out.scheduler, max_new=HARVEST_NEW)
    served_d, out_d = phase_serve_dense(torch, served, out)
    phase_trace(torch, out_d.scheduler, phase="trace-dense")
    with PlainDenseAttention():
        phase_trace(torch, out_d.scheduler, phase="trace-dense-plain")
    phase_dense_stops(torch, out_d.scheduler)
    with CutDepth(CUT_LAYERS):
        served_c, out_c = phase_serve(
            torch, ("--chunk-tokens", str(CHUNK), "--prompt-len", "160"),
            phase="serve-chunked",
            need=SERVE_NEED + ("paged_flash_packed_chunk",))
    if served_c["packed_chunks"] < 1:
        raise AssertionError("the chunked fleet packed no chunk")
    phase_trace(torch, out_c.scheduler, steps=24, prompt_len=160,
                phase="trace-chunked")
    # the spec and tree fleets at 8 of 32 layers, as the chunked ones (in
    # bf16 their tokens part from the one-token fleet's at full depth
    # too); their f32 checks take serve's weights and probe, what the
    # full-depth spec and tree fleets drew from the same seed
    with CutDepth(CUT_LAYERS):
        spec, out_s = phase_serve_spec(torch, out)
    phase_trace(torch, out_s.scheduler, phase="trace-spec")
    with CutDepth(CUT_LAYERS):
        phase_serve_spec(torch, out_c, ("--chunk-tokens", str(CHUNK),
                                        "--prompt-len", "160"),
                         phase="serve-spec-chunked")
    spec_f32 = phase_spec_stops(torch, out.scheduler)
    with CutDepth(CUT_LAYERS):
        tree, out_t = phase_serve_spec(torch, out, phase="serve-tree",
                                       spec=("--spec-tree", "3.3"),
                                       k3_per_step=CUT_LAYERS)
    phase_trace(torch, out_t.scheduler, phase="trace-tree")
    tree_f32 = phase_tree_stops(torch, out.scheduler)
    phase_preempt_roundtrip(torch, out.scheduler, out.lam)
    # serve-preempt takes serve's probe and lambda* (no harvest of its
    # own), so it runs serve's first 8 layers (the 32-layer draw's
    # scale); serve-group runs the driver (its own harvest and fit) on an
    # 8-layer draw (CutDepth): the fan-in rule reads the stacked layer
    # axis, so that draw's weights are 2x larger
    phase_serve_preempt(torch, out, layers=CUT_LAYERS)
    phase_preempt_stops(torch, out.scheduler)
    with CutDepth(CUT_LAYERS):
        phase_serve_group(torch)
    phase_group_stops(torch, out.scheduler)
    # the fleet's hosts at 8 of 32 layers (its threads, streams and
    # routing do not depend on depth), cut to pay for the llava phases
    with CutDepth(CUT_LAYERS):
        _, out_f = phase_serve_fleet(torch)
    phase_fleet_stops(torch, out_f.scheduler.hosts[0])
    del out_f
    offline = phase_offline(torch, splits, OFFLINE_EPOCHS)
    with CutDepth(CUT_LAYERS):
        _, out_st = phase_serve(
            torch, ("--static-baseline",), phase="serve-static", requests=4,
            need=SERVE_NEED + ("ttt_probe_batched",))
    phase_static_fleet(torch, out_st.scheduler)
    k8, k8_checks = phase_k8(torch, timer)
    rwkv_model = phase_model_rwkv(torch)
    # the RWKV fleet, its trace and its harvest at 8 of 24 layers; its f32
    # check on the first layers of a full-depth draw (full_depth), what
    # the fleet drew before the cut: the 8-layer draw's weights are
    # sqrt(3) larger (the fan-in rule reads the stacked layer axis), and
    # f32 checks on such cut draws have parted before (PERF.md §7)
    with CutDepth(CUT_LAYERS):
        served_r, out_r = phase_serve_rwkv(torch)
    phase_trace(torch, out_r.scheduler, phase="trace-rwkv")
    phase_harvest_rwkv(torch, out_r.scheduler, max_new=HARVEST_NEW)
    sched = out_r.scheduler
    f32_stops(torch, "serve-rwkv-f32",
              *f32_cut(full_depth(torch, RWKV_ARCH), RWKV_F32_LAYERS),
              sched.pc, sched.theta, SwapWKV(), ("wkv_scan",), requests=8,
              prompt_len=16, max_new_tokens=96)
    # the d-128 fleets: qwen1.5-32b's weights take 65.6 GiB of the card, so
    # nothing of the earlier fleets stays on it
    del out, out_d, out_c, out_s, out_t, out_st, out_r, sched
    free_card(torch)
    # training: the trainer at smollm-360m's full width and depth, every
    # family's gradients on the card against the CPU; no kernel launches
    phase_train(torch)
    free_card(torch)
    phase_train_check(torch)
    free_card(torch)
    # the multi-device port: four ranks on the card over gloo, then one
    # rank on NCCL
    dist = phase_dist(torch)
    free_card(torch)
    phase_dist_nccl(torch)
    # hymba-1.5b and whisper-tiny at full width and depth: K6 at (64, 5)
    # and (64, 1), K7 windowed at G 5 and non-causal at G 1
    families = phase_families(torch)
    llama_model = phase_model_wide(torch, LLAMA_ARCH, "model-llama")
    served_l, out_l = wide_fleet(torch, LLAMA_ARCH, "serve-llama")
    phase_trace(torch, out_l.scheduler, phase="trace-llama")
    llama_tree = phase_llama_tree(torch, served_l, out_l)
    sched = out_l.scheduler
    f32_stops(torch, "serve-llama-f32",
              *f32_cut(sched, F32_LAYERS, kv_cache_dtype="float32"),
              sched.pc, sched.theta, PlainAttention(),
              ("paged_flash_decode", "flash_attention"),
              requests=WIDE_REQUESTS, prompt_len=16, paged=True,
              max_new_tokens=WIDE_NEW)
    del out_l, sched
    free_card(torch)
    # the d-80 fleet: stablelm-3b (G 1), serve-qwen's chunked 160-token
    # prompts on bf16 pages
    stablelm_model = phase_model_wide(torch, STABLELM_ARCH, "model-stablelm")
    served_sl, out_sl = wide_fleet(
        torch, STABLELM_ARCH, "serve-stablelm",
        ("--chunk-tokens", str(CHUNK), "--prompt-len", str(QWEN_PROMPT)),
        need=SERVE_NEED + ("paged_flash_packed_chunk", "ttt_probe_batched"))
    if served_sl["packed_chunks"] < 1:
        raise AssertionError("the stablelm fleet packed no chunk")
    phase_trace(torch, out_sl.scheduler, steps=CHUNKED_TRACE_STEPS,
                prompt_len=QWEN_PROMPT, phase="trace-stablelm")
    sched = out_sl.scheduler
    f32_stops(torch, "serve-stablelm-f32",
              *f32_cut(sched, F32_LAYERS, kv_cache_dtype="float32"),
              sched.pc, sched.theta, PlainAttention(),
              ("paged_flash_decode", "paged_flash_packed_chunk"),
              requests=WIDE_REQUESTS, prompt_len=QWEN_PROMPT, paged=True,
              chunk_tokens=CHUNK, max_new_tokens=WIDE_NEW)
    del out_sl, sched
    free_card(torch)
    # the MoE fleets, serve-stablelm's chunked 160-token prompts on bf16
    # pages: granite-moe-1b (d 64, G 2) at full width and depth, then
    # phi3.5-moe (d 128, G 4) at full width and 24 of its 32 layers
    moe_need = SERVE_NEED + ("paged_flash_packed_chunk", "ttt_probe_batched")
    chunk_flags = ("--chunk-tokens", str(CHUNK), "--prompt-len",
                   str(QWEN_PROMPT))
    granite_model = phase_model_wide(torch, GRANITE_ARCH, "model-granite")
    served_gr, out_gr = wide_fleet(torch, GRANITE_ARCH, "serve-granite",
                                   chunk_flags, need=moe_need)
    if served_gr["packed_chunks"] < 1:
        raise AssertionError("the granite fleet packed no chunk")
    phase_trace(torch, out_gr.scheduler, phase="trace-granite")
    sched = out_gr.scheduler
    f32_stops(torch, "serve-granite-f32",
              *f32_cut(sched, F32_LAYERS, kv_cache_dtype="float32"),
              sched.pc, sched.theta, PlainAttention(),
              ("paged_flash_decode", "paged_flash_packed_chunk"),
              requests=WIDE_REQUESTS, prompt_len=QWEN_PROMPT, paged=True,
              chunk_tokens=CHUNK, max_new_tokens=WIDE_NEW)
    del out_gr, sched
    free_card(torch)
    phi_model = phase_model_wide(torch, PHI_ARCH, "model-phi",
                                 layers=PHI_LAYERS)
    free_card(torch)
    with CutDepth(PHI_LAYERS):
        served_phi, out_phi = wide_fleet(torch, PHI_ARCH, "serve-phi",
                                         chunk_flags, need=moe_need)
    if served_phi["packed_chunks"] < 1:
        raise AssertionError("the phi fleet packed no chunk")
    phase_trace(torch, out_phi.scheduler, phase="trace-phi")
    pc, theta = out_phi.scheduler.pc, out_phi.scheduler.theta
    del out_phi
    free_card(torch)
    fresh_f32_stops(torch, PHI_ARCH, "serve-phi-f32", pc, theta,
                    kv_cache_dtype="float32")
    free_card(torch)
    # the VLM: llava-next-34b (d 128, G 7) at full width and depth, 64.05
    # GiB of bf16 weights (model-llava; its fleet at 16 layers); image
    # requests with the 2,880-token patch prefix beside chunked text
    # requests
    llava_model = phase_model_llava(torch, steps=LLAVA_MODEL_STEPS)
    free_card(torch)
    served_lv, sched_lv = phase_serve_llava(torch, layers=LLAVA_SERVE_LAYERS)
    phase_trace(torch, sched_lv, phase="trace-llava",
                requests=lambda n: llava_requests(
                    torch, sched_lv.model.cfg, n, LLAVA_TEXT, SEED + 2))
    pc, theta = sched_lv.pc, sched_lv.theta
    del sched_lv
    free_card(torch)
    phase_llava_f32_stops(torch, pc, theta)
    free_card(torch)
    qwen_model = phase_model_wide(torch, QWEN_ARCH, "model-qwen")
    free_card(torch)
    # serve-qwen cut in depth (llava carries the 30B-class dense model at
    # full depth on one card now): its int8 pages, (128, 1) instances and
    # chunked traffic as before
    with CutDepth(QWEN_LAYERS):
        served_q, out_q = wide_fleet(
            torch, QWEN_ARCH, "serve-qwen",
            ("--chunk-tokens", str(CHUNK), "--prompt-len", str(QWEN_PROMPT)),
            need=SERVE_NEED + ("paged_flash_packed_chunk",))
    if served_q["packed_chunks"] < 1:
        raise AssertionError("the qwen fleet packed no chunk")
    phase_trace(torch, out_q.scheduler, steps=CHUNKED_TRACE_STEPS,
                prompt_len=QWEN_PROMPT, phase="trace-qwen")
    pc, theta = out_q.scheduler.pc, out_q.scheduler.theta
    del out_q
    free_card(torch)
    fresh_f32_stops(torch, QWEN_ARCH, "serve-qwen-f32", pc, theta)
    k2_main = k2[0]
    # absolute errors: phase k2's m and outputs, the model's outputs
    k2_err = max([max(r["m_err"], r["out_err"]) for r in k2]
                 + [model[p]["k2_out_err"] for p in ("bf16", "f32")])
    b3_rows = [r for r in k3 if r["fn"] == "B3"]
    b4_rows = [r for r in k3 if r["fn"] == "B4"]
    k3_model_err = max(chunked[p]["k3_out_err"] for p in ("bf16", "f32"))
    b3_err = max([max(r["m_err"], r["out_err"]) for r in b3_rows]
                 + [k3_model_err])
    b4_err = max([max(r["m_err"], r["out_err"], r["merged_err"])
                  for r in b4_rows] + [k3_model_err])

    k6_main = k6[0]
    k6_err = max([max(r["m_err"], r["out_err"], r["normalised_err"])
                  for r in k6]
                 + [model["dense"][p]["k6_out_err"] for p in ("bf16", "f32")])
    k7_main = k7[0]
    k7_err = max([r["max_abs_err"] for r in k7]
                 + [model["dense"][p]["k7_err"] for p in ("bf16", "f32")])

    def k3_entry(name, line, launches, err, row):
        return dict(name=name, route="cuda",
                    source="src/repro_torch/csrc/paged_chunk.cu",
                    replaces=f"src/repro/kernels/decode_attention.py:{line}",
                    launches=launches, max_abs_err=err, ms=row["ms"],
                    plain_ms=row["plain_ms"], bound_ms=row["bound_tc_ms"],
                    bound_by=row["bound_tc_by"],
                    library_ms=row["library_ms"])

    def g_of(r):
        return r["H"] // r["KV"]

    def pick(rows, **kw):
        return next(r for r in rows if all(r.get(k) == v
                                           for k, v in kw.items()))

    def d128_err(rows, g, keys, d=128):
        return max(max(r[k] for k in keys if k in r) for r in rows
                   if r["d"] == d and g_of(r) == g)

    def d128_entry(name, source, replaces, launches, err, row):
        # K3 and K7 run their products on the tensor cores: their bound
        # prices them at the bf16 rate
        tc = "bound_tc_ms" in row
        return dict(name=name, route="cuda",
                    source=f"src/repro_torch/csrc/{source}",
                    replaces=f"src/repro/kernels/{replaces}",
                    launches=launches, max_abs_err=err, ms=row["ms"],
                    plain_ms=row["plain_ms"],
                    bound_ms=row["bound_tc_ms" if tc else "bound_ms"],
                    bound_by=row["bound_tc_by" if tc else "bound_by"],
                    library_ms=row["library_ms"])

    k2_keys, k3_keys = ("m_err", "out_err"), ("m_err", "out_err",
                                                "merged_err")
    k6_keys = ("m_err", "out_err", "normalised_err")
    models_wide = {3: llama_model, 1: qwen_model}
    fleets_wide = {3: served_l, 1: served_q}
    d128_rows = []
    for g, tag in ((3, "d 128, G 3"), (1, "d 128, G 1")):
        mw, fl = models_wide[g], fleets_wide[g]["launches"]
        pages = "bf16" if g == 3 else "int8"
        d128_rows += [
            d128_entry(f"paged_flash_decode ({tag}, {pages})",
                       "paged_decode.cu", "decode_attention.py:231",
                       fl["paged_flash_decode"],
                       max(d128_err(k2, g, k2_keys),
                           mw["bf16"]["k2_out_err"]),
                       pick(k2, d=128, H=24 if g == 3 else 40, pages=pages,
                            B=4, case=None)),
            d128_entry(f"flash_decode ({tag}, bf16)", "flash_decode.cu",
                       "decode_attention.py:78", fl["flash_decode"],
                       max(d128_err(k6, g, k6_keys),
                           mw["dense"]["k6_out_err"]),
                       pick(k6, d=128, B=8, cache="bf16",
                            H=24 if g == 3 else 40)),
            d128_entry(f"flash_attention ({tag}, bf16)",
                       "flash_attention.cu", "flash_attention.py:64",
                       fl["flash_attention"],
                       max(max(r["max_abs_err"] for r in k7
                               if r["d"] == 128 and g_of(r) == g),
                           mw["dense"]["k7_err"]),
                       pick(k7, d=128, dtype="bf16",
                            **(dict(B=1, Sq=16) if g == 3
                               else dict(B=8, Sq=160))))]
    d128_rows.append(d128_entry(
        "paged_flash_packed_chunk (d 128, G 1, int8)", "paged_chunk.cu",
        "decode_attention.py:298",
        served_q["launches"]["paged_flash_packed_chunk"],
        d128_err([r for r in k3 if r["fn"] == "B4"], 1, k3_keys),
        pick(k3, fn="B4", d=128, H=40, pages="int8", case="served")))
    # the tree verify's K3: serve-tree's (d 64) and serve-llama-tree's
    # (d 128, G 3: that instance's first launches in a fleet), timed at
    # phase k3's tree cases
    tree_rows = [r for r in k3 if r.get("tree")]
    for d, fleet_res in ((64, tree), (128, llama_tree)):
        d128_rows.append(k3_entry(
            f"paged_flash_packed_chunk (tree verify, d {d}, G 3, bf16)", 298,
            fleet_res["launches"]["paged_flash_packed_chunk"],
            max(max(r[k] for k in k3_keys) for r in tree_rows
                if r["d"] == d),
            pick(tree_rows, d=d, pages="bf16")))
    d128_rows.append(dict(
        name="serving_probe_spec_step (tree 3.3)", route="cuda",
        source="src/repro_torch/csrc/probe_spec.cu",
        replaces="src/repro/kernels/ttt_probe.py:304",
        launches=tree["launches"]["serving_probe_spec_step"],
        max_abs_err=max(k4["max_abs_err"], tree["k4_checked_err"],
                        tree_f32["tree_primed"]["k4_checked_err"]),
        ms=k4["ms"], plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"],
        bound_by=k4["bound_by"], library_ms=None))
    # the d-80 instances (G 1) on serve-stablelm's path, bf16 pages,
    # through the d-128 rows' helpers
    fl, mw = served_sl["launches"], stablelm_model
    d80_rows = [
        d128_entry("paged_flash_decode (d 80, G 1, bf16)", "paged_decode.cu",
                   "decode_attention.py:231", fl["paged_flash_decode"],
                   max(d128_err(k2, 1, k2_keys, d=80),
                       mw["bf16"]["k2_out_err"]),
                   pick(k2, d=80, pages="bf16", B=4, case=None)),
        d128_entry("paged_flash_packed_chunk (d 80, G 1, bf16)",
                   "paged_chunk.cu", "decode_attention.py:298",
                   fl["paged_flash_packed_chunk"],
                   d128_err([r for r in k3 if r["fn"] == "B4"], 1, k3_keys,
                            d=80),
                   pick(k3, fn="B4", d=80, pages="bf16", case="served")),
        d128_entry("flash_decode (d 80, G 1, bf16)", "flash_decode.cu",
                   "decode_attention.py:78", fl["flash_decode"],
                   max(d128_err(k6, 1, k6_keys, d=80),
                       mw["dense"]["k6_out_err"]),
                   pick(k6, d=80, B=8, S=208, cache="bf16")),
        d128_entry("flash_attention (d 80, G 1, bf16)", "flash_attention.cu",
                   "flash_attention.py:64", fl["flash_attention"],
                   max(max(r["max_abs_err"] for r in k7 if r["d"] == 80),
                       mw["dense"]["k7_err"]),
                   pick(k7, d=80, dtype="bf16", B=8, Sq=160))]
    # the MoE fleets' instances, (64, 2) on serve-granite's path and
    # (128, 4) on serve-phi's, bf16 pages
    moe_rows = []
    for (H, KV, d, _), fleet_res, mw in ((GRANITE, served_gr, granite_model),
                                         (PHI, served_phi, phi_model)):
        g, fl = H // KV, fleet_res["launches"]
        tag = f"d {d}, G {g}, bf16"
        moe_rows += [
            d128_entry(f"paged_flash_decode ({tag})", "paged_decode.cu",
                       "decode_attention.py:231", fl["paged_flash_decode"],
                       max(d128_err(k2, g, k2_keys, d=d),
                           mw["bf16"]["k2_out_err"]),
                       pick(k2, d=d, H=H, pages="bf16", B=4, case=None)),
            d128_entry(f"paged_flash_packed_chunk ({tag})", "paged_chunk.cu",
                       "decode_attention.py:298",
                       fl["paged_flash_packed_chunk"],
                       d128_err([r for r in k3 if r["fn"] == "B4"], g,
                                k3_keys, d=d),
                       pick(k3, fn="B4", d=d, H=H, pages="bf16",
                            case="served")),
            d128_entry(f"flash_decode ({tag})", "flash_decode.cu",
                       "decode_attention.py:78", fl["flash_decode"],
                       max(d128_err(k6, g, k6_keys, d=d),
                           mw["dense"]["k6_out_err"]),
                       pick(k6, d=d, H=H, B=8, S=208, cache="bf16")),
            d128_entry(f"flash_attention ({tag})", "flash_attention.cu",
                       "flash_attention.py:64", fl["flash_attention"],
                       max(max(r["max_abs_err"] for r in k7
                               if r["d"] == d and g_of(r) == g),
                           mw["dense"]["k7_err"]),
                       pick(k7, d=d, H=H, dtype="bf16", B=8, Sq=160))]
    # K1 and K5 at the MoE fleets' probe widths, each the top of its band:
    # K1 every engine step, K5 in the calibration fit
    for fw, fleet_res, k1_rows in (
            (GRANITE_PROBE_F, served_gr, k1["granite_width"]),
            (PHI_PROBE_F, served_phi, k1["phi_width"])):
        row = pick(k1_rows, view="distinct")
        k5_row = pick(k5["timed"], f=fw)
        moe_rows += [
            dict(name=f"serving_probe_step (f {fw})", route="cuda",
                 source="src/repro_torch/csrc/probe_spec.cu",
                 replaces="src/repro/kernels/ttt_probe.py:368",
                 launches=fleet_res["launches"]["serving_probe_step"],
                 max_abs_err=max(max(r["max_abs_err"].values())
                                 for r in k1_rows),
                 ms=row["ms"], plain_ms=row["plain_ms"],
                 bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                 library_ms=None,
                 served_ms=pick(k1_rows, view="same")["ms"]),
            dict(name=f"ttt_probe_batched (f {fw})", route="cuda",
                 source="src/repro_torch/csrc/ttt_scan.cu",
                 replaces="src/repro/kernels/ttt_probe.py:80",
                 launches=fleet_res["launches"]["ttt_probe_batched"],
                 max_abs_err=max(c[6] for c in k5["per_case"] if c[0] == fw),
                 ms=k5_row["ms"], plain_ms=k5_row["plain_ms"],
                 bound_ms=k5_row["bound_ms"], bound_by=k5_row["bound_by"],
                 library_ms=None)]
    # the VLM's (128, 7) instances on serve-llava's path (bf16 pages; K7
    # timed at an image admission's 2,896 rows), K1 and K5 at f 7168
    fl, mw = served_lv["launches"], llava_model
    g7 = LLAVA[0] // LLAVA[1]
    tag = f"d 128, G {g7}, bf16"
    llava_rows = [
        d128_entry(f"paged_flash_decode ({tag})", "paged_decode.cu",
                   "decode_attention.py:231", fl["paged_flash_decode"],
                   max(d128_err(k2, g7, k2_keys), mw["bf16"]["k2_out_err"]),
                   pick(k2, d=128, H=LLAVA[0], pages="bf16", B=4, case=None)),
        d128_entry(f"paged_flash_packed_chunk ({tag})", "paged_chunk.cu",
                   "decode_attention.py:298",
                   fl["paged_flash_packed_chunk"],
                   d128_err([r for r in k3 if r["fn"] == "B4"], g7, k3_keys),
                   pick(k3, fn="B4", d=128, H=LLAVA[0], pages="bf16",
                        case="served")),
        d128_entry(f"flash_decode ({tag})", "flash_decode.cu",
                   "decode_attention.py:78", fl["flash_decode"],
                   max(d128_err(k6, g7, k6_keys), mw["dense"]["k6_out_err"]),
                   pick(k6, d=128, H=LLAVA[0], B=4, cache="bf16")),
        d128_entry(f"flash_attention ({tag})", "flash_attention.cu",
                   "flash_attention.py:64", fl["flash_attention"],
                   max(max(r["max_abs_err"] for r in k7
                           if r["d"] == 128 and g_of(r) == g7),
                       mw["dense"]["k7_err"]),
                   pick(k7, d=128, H=LLAVA[0], dtype="bf16", B=1,
                        Sq=2896))]
    k1_rows = k1["llava_width"]
    row = pick(k1_rows, view="distinct")
    k5_row = pick(k5["timed"], f=LLAVA_PROBE_F)
    llava_rows += [
        dict(name=f"serving_probe_step (f {LLAVA_PROBE_F})", route="cuda",
             source="src/repro_torch/csrc/probe_spec.cu",
             replaces="src/repro/kernels/ttt_probe.py:368",
             launches=fl["serving_probe_step"],
             max_abs_err=max(max(r["max_abs_err"].values())
                             for r in k1_rows),
             ms=row["ms"], plain_ms=row["plain_ms"],
             bound_ms=row["bound_ms"], bound_by=row["bound_by"],
             library_ms=None,
             served_ms=pick(k1_rows, view="same")["ms"]),
        dict(name=f"ttt_probe_batched (f {LLAVA_PROBE_F})", route="cuda",
             source="src/repro_torch/csrc/ttt_scan.cu",
             replaces="src/repro/kernels/ttt_probe.py:80",
             launches=fl["ttt_probe_batched"],
             max_abs_err=max(c[6] for c in k5["per_case"]
                             if c[0] == LLAVA_PROBE_F),
             ms=k5_row["ms"], plain_ms=k5_row["plain_ms"],
             bound_ms=k5_row["bound_ms"], bound_by=k5_row["bound_by"],
             library_ms=None)]
    # hymba's (64, 5) and whisper's (64, 1) K6 instances and K7 windowed at
    # G 5 and non-causal at G 1, on serve-hymba's and serve-whisper's
    # paths; K1 and K5 at their probe widths, 1600 and 384
    family_rows = []
    for tag, shape, fleet_key, model_key, k6_row, k7_row, fw, k1_key in (
            ("d 64, G 5, bf16, ring of 1,024", HYMBA, "hymba",
             "hymba_model", dict(B=4, S=HYMBA_WINDOW, cache="bf16"),
             dict(B=1, Sq=1128, dtype="bf16"), HYMBA_PROBE_F,
             "hymba_width"),
            ("d 64, G 1, bf16, 1,500 frames", WHISPER, "whisper",
             "whisper_model", dict(B=4, S=WHISPER_FRAMES, cache="bf16"),
             dict(B=1, Sq=WHISPER_FRAMES, dtype="bf16"), WHISPER_PROBE_F,
             "whisper_width")):
        H, KV, d, _ = shape
        fl = families[fleet_key]["launches"]
        mw = families[model_key]["bf16"]
        k7_tag = ("causal, window 1,024" if shape is HYMBA
                  else "non-causal")
        family_rows += [
            d128_entry(f"flash_decode ({tag})", "flash_decode.cu",
                       "decode_attention.py:78", fl["flash_decode"],
                       max([max(r[k] for k in k6_keys) for r in k6
                            if r["d"] == d and r["H"] == H]
                           + [mw["k6_out_err"]]),
                       pick(k6, d=d, H=H, **k6_row)),
            d128_entry(f"flash_attention (d 64, G {H // KV}, {k7_tag}, "
                       "bf16)", "flash_attention.cu",
                       "flash_attention.py:64", fl["flash_attention"],
                       max([r["max_abs_err"] for r in k7
                            if r["d"] == d and r["H"] == H]
                           + [mw["k7_err"]]),
                       pick(k7, d=d, H=H, **k7_row))]
        k1_rows = k1[k1_key]
        row = pick(k1_rows, view="distinct")
        k5_row = pick(k5["timed"], f=fw)
        family_rows += [
            dict(name=f"serving_probe_step (f {fw})", route="cuda",
                 source="src/repro_torch/csrc/probe_spec.cu",
                 replaces="src/repro/kernels/ttt_probe.py:368",
                 launches=fl["serving_probe_step"],
                 max_abs_err=max(max(r["max_abs_err"].values())
                                 for r in k1_rows),
                 ms=row["ms"], plain_ms=row["plain_ms"],
                 bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                 library_ms=None,
                 served_ms=pick(k1_rows, view="same")["ms"]),
            dict(name=f"ttt_probe_batched (f {fw})", route="cuda",
                 source="src/repro_torch/csrc/ttt_scan.cu",
                 replaces="src/repro/kernels/ttt_probe.py:80",
                 launches=fl["ttt_probe_batched"],
                 max_abs_err=max(c[6] for c in k5["per_case"] if c[0] == fw),
                 ms=k5_row["ms"], plain_ms=k5_row["plain_ms"],
                 bound_ms=k5_row["bound_ms"], bound_by=k5_row["bound_by"],
                 library_ms=None)]
    # the multi-device port's launches: K6 on each rank's slice of the
    # sequence-sharded cache, K7 in each data rank's prefill, K1 on each
    # data rank's probe rows (dist-serve's f32 run, summed over the four
    # ranks); timed in the one-process phases at the served shapes
    dist_launch = {k: sum(int(la[k]) for la in dist["launches"])
                   for k in DIST_NEED}
    dist_rows = [
        dict(name="flash_decode (dist: sequence-sharded, 4 ranks)",
             route="cuda", source="src/repro_torch/csrc/flash_decode.cu",
             replaces="src/repro/kernels/decode_attention.py:78",
             launches=dist_launch["flash_decode"],
             max_abs_err=max(dist["k6_err"], k6_err), ms=k6_main["ms"],
             plain_ms=k6_main["plain_ms"], bound_ms=k6_main["bound_ms"],
             bound_by=k6_main["bound_by"],
             library_ms=k6_main["library_ms"]),
        dict(name="flash_attention (dist: each data rank's prefill)",
             route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:64",
             launches=dist_launch["flash_attention"], max_abs_err=k7_err,
             ms=k7_main["ms"], plain_ms=k7_main["plain_ms"],
             bound_ms=k7_main["bound_tc_ms"],
             bound_by=k7_main["bound_tc_by"],
             library_ms=k7_main["library_ms"]),
        dict(name="serving_probe_step (dist: each data rank's rows)",
             route="cuda", source="src/repro_torch/csrc/probe_spec.cu",
             replaces="src/repro/kernels/ttt_probe.py:368",
             launches=dist_launch["serving_probe_step"],
             max_abs_err=max(k1["max_abs_err"].values()), ms=k1["ms"],
             plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None)]
    llama_k1 = pick(k1["llama_width"], view="distinct")
    d128_rows.append(dict(
        name=f"serving_probe_step (f {LLAMA_PROBE_F})", route="cuda",
        source="src/repro_torch/csrc/probe_spec.cu",
        replaces="src/repro/kernels/ttt_probe.py:368",
        launches=served_l["launches"]["serving_probe_step"],
        max_abs_err=max(max(r["max_abs_err"].values())
                        for r in k1["llama_width"]),
        ms=llama_k1["ms"], plain_ms=llama_k1["plain_ms"],
        bound_ms=llama_k1["bound_ms"], bound_by=llama_k1["bound_by"],
        library_ms=None))
    emit({"kernels": [
        dict(name="serving_probe_step", route="cuda",
             source="src/repro_torch/csrc/probe_spec.cu",
             replaces="src/repro/kernels/ttt_probe.py:368",
             launches=served["launches"]["serving_probe_step"],
             max_abs_err=max(k1["max_abs_err"].values()), ms=k1["ms"],
             plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None,
             served_ms=k1["served_ms"],
             served_plain_ms=k1["served_plain_ms"],
             served_bound_ms=k1["served_bound_ms"]),
        dict(name="paged_flash_decode", route="cuda",
             source="src/repro_torch/csrc/paged_decode.cu",
             replaces="src/repro/kernels/decode_attention.py:231",
             launches=served["launches"]["paged_flash_decode"],
             max_abs_err=k2_err, ms=k2_main["ms"],
             plain_ms=k2_main["plain_ms"], bound_ms=k2_main["bound_ms"],
             bound_by=k2_main["bound_by"],
             library_ms=k2_main["library_ms"]),
        k3_entry("paged_flash_prefill_chunk", 265, b3_launches, b3_err,
                 b3_rows[0]),
        k3_entry("paged_flash_packed_chunk", 298,
                 served_c["launches"]["paged_flash_packed_chunk"], b4_err,
                 b4_rows[0]),
        dict(name="ttt_probe_batched", route="cuda",
             source="src/repro_torch/csrc/ttt_scan.cu",
             replaces="src/repro/kernels/ttt_probe.py:80",
             launches=sum(m["k5_launches_fit"] + m["k5_launches_evaluate"]
                          for m in offline["methods"].values()),
             max_abs_err=max([k5["max_abs_err"]] + [
                 m["scores_max_abs_err"] for m in offline["methods"].values()
                 if "scores_max_abs_err" in m]),
             ms=k5["served"]["ms"], plain_ms=k5["served"]["plain_ms"],
             bound_ms=k5["served"]["bound_ms"],
             bound_by=k5["served"]["bound_by"], library_ms=None),
        dict(name="serving_probe_spec_step", route="cuda",
             source="src/repro_torch/csrc/probe_spec.cu",
             replaces="src/repro/kernels/ttt_probe.py:304",
             launches=spec["launches"]["serving_probe_spec_step"],
             max_abs_err=max(k4["max_abs_err"], spec["k4_checked_err"],
                             spec_f32["spec_primed"]["k4_checked_err"]),
             ms=k4["ms"], plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"],
             bound_by=k4["bound_by"], library_ms=None,
             served_ms=k4["served_ms"],
             served_plain_ms=k4["served_plain_ms"],
             served_bound_ms=k4["served_bound_ms"]),
        dict(name="flash_decode", route="cuda",
             source="src/repro_torch/csrc/flash_decode.cu",
             replaces="src/repro/kernels/decode_attention.py:78",
             launches=served_d["launches"]["flash_decode"],
             max_abs_err=k6_err, ms=k6_main["ms"],
             plain_ms=k6_main["plain_ms"], bound_ms=k6_main["bound_ms"],
             bound_by=k6_main["bound_by"],
             library_ms=k6_main["library_ms"]),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:64",
             launches=served["launches"]["flash_attention"],
             max_abs_err=k7_err, ms=k7_main["ms"],
             plain_ms=k7_main["plain_ms"], bound_ms=k7_main["bound_tc_ms"],
             bound_by=k7_main["bound_tc_by"],
             library_ms=k7_main["library_ms"]),
        dict(name="wkv_scan", route="cuda",
             source="src/repro_torch/csrc/rwkv6_scan.cu",
             replaces="src/repro/kernels/rwkv6_scan.py:53",
             launches=served_r["launches"]["wkv_scan"],
             max_abs_err=max([k8_checks["max_abs_err"]]
                             + [rwkv_model[p]["k8_abs_err"]
                                for p in ("bf16", "f32")]),
             ms=k8[0]["ms"], plain_ms=k8[0]["plain_ms"],
             bound_ms=k8[0]["bound_ms"], bound_by=k8[0]["bound_by"],
             library_ms=None),
    ] + d128_rows + d80_rows + moe_rows + llava_rows + family_rows
        + dist_rows})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
