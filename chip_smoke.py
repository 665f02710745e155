#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line or more each:
  1. the card (nvidia-smi) and the build of the CUDA kernels from the
     sources in this checkout (flash.cu, and bitonic.cu as 11 translation
     units: one nvcc each, all started together), with its time and the
     ptxas report; it fails if ptxas reports spills in the wgmma flash
     kernel, or says that it ignored setmaxnreg or serialized the wgmma
     instructions, or if the flash kernels at MLA's (192, 128) (wgmma and
     FMA) are missing or have a stack frame or spills, or if any of the
     520 instantiations of the row-sort kernel or of the merge kernel
     (32- and 64-bit) is missing or has a stack frame or spills;
  2. each of the four bitonic kernels against its plain PyTorch twin on the
     card, bit for bit: the two row sorts at every row length 2..8192
     (1, 3 and a number of rows that is not a multiple of a CTA's) and at
     (4096, 1024), (64, 2048), (32, 4096) and (16, 8192), every key/value
     type pair, stable on and off, uniform keys and heavy duplicates with
     +-0.0, +-inf and NaN (the integer types' extremes among integers);
     the two merges into every row length 2..8192 with the same row
     counts, and at the main path's shapes (2048, 1024), (1024, 2048) and
     (512, 4096), over the same types and keys, from contiguous operands
     and from the merge tree's strided views. Each kernel's time
     (``time_ms``: CUDA events around a batch of 10 calls, median of 20
     batches) beside its bound, the twin's time and one torch.sort call on
     the same rows; the row sorts at (4096, 1024) and at (131072, 1024),
     the launch of a 2^27 sort, each also held to its twin bit for bit on
     the tensors it is timed on; the merges at the main path's shapes two
     ways, straight through ``bitonic._launch`` into outputs allocated once
     and through the wrapper, both on the merge tree's strided views, the
     kernel held to its twin on them. Then the same checks at 8 bytes: the
     int64, float64 and uint64 (by its lane) keys with every value type
     (int32, uint32, float32, int64, uint64, float64), every row length,
     stable on and off, uniform and special keys, contiguous and strided;
     and the times at a 2^22 int64 sort's shapes with int64 values;
  3. ``repro_torch.sort`` through its entry point (the sort's main path),
     checked against torch.sort on the card: n = 2^22 float32 keys at the
     default limits, n = 2^22 int32 keys with 4 distinct values (imbalance
     below 1.01), want="order", order="desc", a float32 payload, and
     n = 2^27 float32 keys on p = 8 with stream_threshold=None. Every
     bitonic kernel's launch count is set to 0 before this path and read
     after it; each of the four must have launched. Then the multi-key
     slice at n = 2^22, p = 8, its counts set to 0 before it and read after
     it (each of the four kernels must launch under it): a packed pair
     (int32 ids in [0, 1000) ascending, int32 times in [0, 2^20)
     descending, 30 bits), keys-only and want="order"; an LSD pair
     (float32 uniform, int32 full range: over the 31-bit budget) with a
     float32 payload; a duplicate-heavy packed pair (4 x 16 values,
     imbalance below 1.01); the packed pair with decode="host"; each
     against stable torch.sort passes in LSD order, bit for bit. Last, a
     keys-only float32 sort of 2^20 keys with 5% NaN against the same call
     with device="cpu", bit for bit;
  4. the flash-attention kernel against its twins on the card, causal and
     full, bf16 and float32, at (B, S, H, KV, dh) = (1, 256, 4, 2, 16),
     (2, 1000, 4, 1, 64), (2, 1000, 8, 2, 128), (1, 77, 8, 8, 128),
     (1, 8192, 32, 8, 128) and the qwen3-4b prefill shape
     (2, 8192, 32, 8, 128), and at MLA's (dqk, dv) = (192, 128) with
     (B, S, H = KV) = (1, 300, 2), (2, 1000, 4), (1, 77, 8) and
     deepseek-v3's (1, 8192, 128), each line naming the route it took (wgmma,
     mma.sync or fma): max abs err <= 2e-2 (bf16) and <= 1e-4
     (float32) against the Pallas-faithful twin, and in bf16 within
     ``flash.bf16_error``'s limit (one bf16 ulp of each output plus 2^-6
     of its row's rms, mean error <= 1e-3 rms) of the twin that rounds
     where the kernel does; its median time at the prefill shape in bf16, causal,
     beside its bound, that twin's time and one
     scaled_dot_product_attention call on the same tensors; the same four
     numbers at deepseek-v3's MLA prefill (1, 8192, 128, 192/128);
  5. serving (the model tier's main path): qwen3-4b at full width with
     seeded random bf16 weights answers 2 prompts of 8192 seeded tokens
     with 16 new tokens each through ``engine.generate``; the flash launch
     count is set to 0 before it and must read 36 (one per layer) after
     it. Then prefill and decode again with times, tokens/s and peak
     memory, and the prefill's last-position logits against the same
     weights with flash_attention=False (max abs diff <= 5e-2 x max|logit|
     and the same greedy first token);
  6. the out-of-core stream backend through ``repro_torch.sort`` with its
     input on the host, the launch counts set to 0 before it and read
     after it (each of the four kernels must launch under it): 2^27
     float32 keys at the default limits (2048 chunks of 2^16) and with
     chunk_elems = 2^22, against torch.sort on the card; at 2^23,
     want="order" descending (against stable torch.sort) and a float32
     payload, int32 keys with 4 distinct values (the traced splitter span's
     bucket sizes equal the CPU's partition of the same keys, and the
     partition without the investigator is more than twice as
     imbalanced), a packed pair (against stable
     torch.sort passes), the keys as an iterator of 300000-key pieces
     (equal to the array's result); 2^21 float32 keys with 5% NaN against
     the same call on the CPU. Each case prints its wall time and launches,
     then (unless it took over 120 s) runs again with
     SortLimits(trace=True) and prints its split into pass 1 / 2 / 3
     (the traced output must equal the untraced one). Last, traced sim
     (2^22) and stream (2^23) sorts: the span names of tests/test_obs.py,
     coverage >= 0.95, output equal to the untraced call;
  7. x64 mode through ``repro_torch.sort`` with SortLimits(x64=True), the
     launch counts set to 0 before it and read after it (each of the four
     kernels must launch with 8-byte keys or values): 2^27 int64 keys in
     core against torch.sort; at 2^22, float64 keys with +-0.0 and +-inf
     ascending and descending, uint64 over the full range, int64 with 4
     distinct values (imbalance below 1.01), want="order" on a (8, 2^19)
     int64 grid, int64 keys with a float64 payload, a packed (int64 id,
     int32 time) pair of 60 bits (one int64 sort) and a 96-bit pair (LSD),
     each exact; 2^21 float64 keys with 5% NaN against the same call on the
     CPU, bit for bit; 2^23 int64 keys streamed from the host; the views
     (topk against torch.topk, searchsorted of 4096 queries against
     np.searchsorted, provenance() against the numpy decode of order());
     a 2^22 argsort with PROVENANCE_INT32_CAP lowered, so its index is
     int64. Each case prints its wall time and launches;
  8. the serve tier (``repro_torch.serve.sortd``, ``stream.service``,
     ``tune``, ``obs.flight``); every run's launch counts are set to 0
     just before it and read just after, and each of the four kernels
     must launch in the serving runs (the invariance flushes and the two
     server bursts, summed): ``SortService.sort_many`` at
     one bucket (float32, p = 8, per = 2^13) with B = 1, 4 and 16 host
     requests of 2^16 keys, each flush launching every kernel as often as
     the others (counts read and set to 0 around each flush), each result
     equal to torch.sort; ``SortServer(max_batch=16, max_delay_ms=2)``
     with two tenants (one at 4x the other's rate) and four submitting
     threads: 256 requests of keys-only float32 (log-uniform 2^10-2^16,
     25% descending), packed (int32, int32) pairs with declared widths,
     argsorts, float32 payloads, one 2^23 host stream request and 16 each
     of topk / searchsorted / percentile, every answer exact (torch.sort,
     stable passes, torch.topk, np.searchsorted, np.percentile), stats()
     and both tenants' p50 / p99 printed, every flush record linked to its
     requests; 16 x 2^14 float32 as one flush and as 16 sort calls (wall
     and device time under torch.profiler, launches), and as one flush
     in which one member holds a NaN (the NaN-safe searches for all 16,
     each equal to the same flush on the CPU bit for bit, the NaN-free
     ones to torch.sort too); a cold tune store
     warmed by the card's own sim (2^14-2^22) and stream (2^20-2^23)
     sorts until both predictions at 2^23 clear the confidence bar, whose
     plan of 2^23 must read cost_source "model", then run; the chunk size
     the model picks after streams at three chunk sizes; the store saved,
     loaded back and held to tests/tune_schema.json's shape; 2^22 int32
     keys of 4 values at capacity_factor 0.25: at least 2 ladder retries
     without a tuner, exactly 1 with one, both exact; a QueueFullError
     burst through a one-slot queue, whose incident snapshot must be in
     tests/flight_schema.json's shape and read by ``python -m
     repro_torch.obsctl`` (slow, export) with rc 0;
  9. the mesh backend (``repro_torch.sort(x_local, where=(mesh, axis))``),
     every launch count set to 0 just before each run and read just after,
     summed over the phase's ranks (each of the four kernels must launch):
     a one-rank NCCL group in this process sorting 2^24 float32 keys,
     keys-only and want="order", each equal to the sim (n_procs=1) and to
     stable torch.sort; then four ranks, four processes of this script
     (``--mesh-rank``) sharing cuda:0 through gloo, which stages the
     collectives through the host, each sorting its pad_grid slice of
     2^24 seeded keys (2^22 a rank): float32 uniform, int32 of 4 values
     (imbalance below 1.01), want="order" descending, a float32 payload
     descending, keys-only descending, 2^21 float32 with 5% NaN, int64 of
     4 values in x64 mode, and a traced keys-only sort (coverage at least
     0.95); the ranks' blocks, counts and send counts equal the sim
     (n_procs=4) over the same global grid on the card (NaN: on the CPU)
     and torch.sort. Each case prints rank 0's wall between barriers, the
     exchange span's share and the launches per rank. Then tuples over
     the mesh: the one NCCL rank sorts a packed pair (4 values x 2^16) of
     2^24 rows, and the four gloo ranks (2^22 rows a rank) a packed pair
     keys-only and want="order", an LSD pair (4 int32 values asc, float32
     normals desc) with a float32 payload, and an int64 pair packed into
     63 bits in x64 mode; the blocks concatenated equal np.lexsort of the
     global columns bit for bit, the imbalance is at most 1.01, each of
     the four kernels launches under them, and each prints the indexed
     exchanges per sort (``SortOutput.meta.exchanges``);
 10. MoE (``repro_torch.models.moe``): deepseek-moe-16b at full width and
     depth (28 layers, 27 of them MoE with 64 routed experts of 1408, 2
     shared, top-6; about 16.4B parameters) in bf16 with
     flash_attention=True and seeded weights answers 2 prompts of 8192
     seeded tokens (flash serves prompts of 8192 and more) with 16 new
     tokens each through ``engine.generate``; every launch count set to 0
     just before it and read just after, which must equal those derived
     from the config and shapes (per MoE layer one kv row sort and three
     kv merges of ``stable_argsort``; flash once per layer); then prefill
     and decode timed, and one decode step under torch.profiler (device
     time by kernel, idle share); the prefill's last-position logits
     against the same weights with flash_attention=False, which must
     launch no flash kernel: the flash prefill with the plain one's
     routing replayed layer by layer within 5e-2 x max|logit| (a MoE
     layer's top-6 is a discrete choice that bf16 rounding can flip), the
     logits as routed on their own and the share of tokens routed to
     other experts printed beside it. The first MoE layer's expert ids from
     the prefill: ``stable_argsort`` on the card (kernels) equal to the
     twin on the CPU and to torch.sort bit for bit, ``moe_forward`` with
     both sort paths the same bits, and its time split into the sort, the
     expert GEMMs and the router, and by kernel under torch.profiler. One
     full-width layer in float32 (TF32 off) at capacity factor 8: 256
     tokens within 1e-4 x max|ref| of ``moe_ref``; a one-rank NCCL group's
     exchange equal to the identity bit for bit; four gloo ranks on a
     (data, model) = (2, 2) mesh (processes of this script sharing the
     card), 2 x 2048 tokens, experts over "model", over ("data", "model")
     and that exchange factored: the blocks within 1e-4 x max|out| of one
     rank's output, the per-expert and send counts equal, each rank's
     launches as derived, and the exchange's share of the layer's wall;
     then over ("data", "model") at the config's capacity factor 1.25,
     where tokens drop and the received buckets (C = 1921) merge on the
     kernels: counts and launches as before, and each rank's output equal
     to its own use_pallas=False run bit for bit (every case holds that);
 11. training (``repro_torch.train``, ``optim``, ``data``, ``checkpoint``,
     ``ft``, the launcher's pieces): deepseek-moe-16b at full width (d_model
     2048, 16 MHA heads of 128, 64 routed experts of 1408 and 2 shared,
     top-6, capacity factor 1.25, vocabulary 102,400, bf16) cut to one
     dense and three MoE layers, remat on, AdamW (peak lr 3e-4, warmup 2,
     8 steps) with float32 states, trains 4 steps on one batch of 2 x 4096
     tokens at grad_accum 2 made by ``PackedLoader`` on the card, through
     ``RestartManager.run``, the launch counts set to 0 just before and
     read just after. Checks: (1) the first loss finite and within 0.5 of
     ln V + 1/2 (unit-variance logits), and the loss on the same batch
     after the four steps lower; (2) the data round's launches (one kv
     row sort, three kv merges) and each step's (per MoE layer and
     micro-step one dispatch, ``moe_dispatch_launches``, twice with
     remat; the keys-only kernels and flash 0) as derived; (3) one
     full-width MoE layer's forward and backward in float32 on 4096
     tokens with the kernel sort and with ``torch.sort``: routing and
     output equal bit for bit, gradients within 1e-5 x max; (4) two
     train steps of the smoke config in float32 on the card and on the
     CPU: metrics, m and v within 1e-5 x max, parameters within 1e-5 x
     max + 1% of the summed lr; (5) ``bucket_by_length`` on the card
     equal to the CPU and to the stable argsort for 4096 lengths (sim)
     and 2^20 (stream), both timed; (6) ``save_async``, a step, ``wait``:
     the checkpoint holds the state from before the step and restores
     into a fresh model bit for bit, and a ``RestartManager`` whose step
     raises once recovers (the smoke config on the card). Prints the step
     wall (median after the first), tokens/s, peak memory, one step under
     torch.profiler (idle share, top kernels, the backward's autograd
     nodes), the optimizer update's time and the dispatch sort's share of
     one MoE layer's forward;
 12. continuous batching (``repro_torch.serve.batching``): qwen3-4b at full
     width and depth (bf16, flash_attention=True, seeded weights) through
     ``ContinuousBatcher(n_slots=4, s_max=8256)``: 8 requests, 2 prompts of
     8192 tokens (flash, 36 launches each) and 6 of 512-4096, 8-32 new
     tokens each, so slots are re-used; every launch count set to 0 just
     before the run and read just after. Each request is then held to
     itself alone (``make_prefill`` + ``make_serve_step``, teacher-forced
     with the batcher's tokens): the first-token logits equal bit for bit,
     each decode step's logits within 5e-2 x max |logit|, the tokens equal
     wherever the top-2 margin exceeds that (the others counted). A float32
     cut (2 layers, TF32 off) through 2 slots gives ``generate``'s tokens
     per request. deepseek-moe-16b at full width and depth through 2 slots,
     4 requests of 512-2048 tokens and 8 new: its kv sort and merge
     launches as derived per prefill, each request held to itself alone
     with the batcher's routing replayed at each decode step. Prints
     requests/s, tokens/s, decode ms a step, peak memory and one decode
     step's idle share under torch.profiler, with the card's name and
     power limit.
 13. MLA: deepseek-v3-671b (``configs/deepseek_v3_671b.py``, bf16, seeded,
     flash) cut in depth to its 3 dense MLA layers and 1 MLA + MoE layer,
     every width as published (15,111,101,440 parameters, equal to the
     config's count on the meta device), answers 2 prompts of 8192 tokens
     with 16 new through ``engine.generate``: every launch count set to 0
     just before and read just after; flash at (192, 128) once per layer,
     the dispatch's kv sort and merges (2 x 8192 x 8 expert ids over 256
     keys) as ``moe_dispatch_launches`` derives. Then prefill and decode
     (absorbed products over the compressed caches) timed, one decode
     step under torch.profiler, peak memory, flash's time at (1, 8192,
     128, 192/128) beside its bound and one scaled_dot_product_attention
     call, and checks: (1) one MLA layer
     in float32 at full width, S = 8192, card (flash's FMA route) against
     CPU within 1e-5 x max; (2) the prefill's logits against
     flash_attention=False (no flash launch) with the routing replayed,
     within 5e-2 x max |logit|; (3) each decode step's logits against
     the teacher-forced forward (its last, MoE, layer gathering the
     compared positions' experts as decode does, the routing replayed),
     within the same, and the served prefill's capacity drops counted;
     (4) is phase 4's; (5) 4 requests of 512-2048 tokens and 8 new
     through ``ContinuousBatcher(n_slots=2)``, launches as derived, each
     request held to itself alone (``hold_batch``, routing replayed);
 14. recurrent and sliding-window serving: falcon-mamba-7b (its first 16
     of 64 Mamba layers, cut so that phase 18 fits the run's time;
     2,217,545,728 parameters at full width) answers 2 prompts of 4096
     tokens
     and recurrentgemma-9b ((RG-LRU, RG-LRU, local attention) x 12 + 2
     RG-LRU, window 2048, flash_attention=True, 8,578,199,552 parameters)
     2 prompts of 8192, each with 16 new through ``engine.generate`` at
     full width and depth (bf16, seeded; each count equal to the config's
     on the meta device), every launch count set to 0 just before and read
     just after: all five kernels at 0 (the scan is plain PyTorch, a
     window keeps flash off, no experts). Each prints prefill ms, decode
     ms a step, one decode step's idle share under torch.profiler, peak
     memory and its first layer's prefill split by the profiler into
     scan, GEMMs and the rest. Checks: (1) one Mamba and one RG-LRU layer
     at full width, S = 1024, and one local-attention layer at S = 4096
     (its keys banded), float32 (TF32 off), card against CPU within 1e-5
     x max; (2) each decode step's logits against the teacher-forced
     forward (padded to a multiple of 512: every mixer is causal) within
     5e-2 x max |logit|: recurrentgemma's served bf16 run, falcon-mamba's
     served weights converted to float32 (TF32 off; its 64 bf16 layers
     drift past the limit by rounding, printed); (3) recurrentgemma's third request of 1024 tokens
     (shorter than the window: ``extend_caches`` re-slots its ring) and
     16 decode steps: each ring slot s holds the position pos[s] with
     pos[s] % W == s, its k and v within 5e-2 x max of the teacher-forced
     forward's; the 8192-token run's rolled rings hold every position at
     its slot.
 15. cross-attention, whisper's encoder and vision memory: whisper-base
     (6 encoder and 6 decoder layers, vocab 51,865 padded to 51,968,
     97,346,560 parameters) answers 8 requests of 1536 seeded stub frames
     (whisper's 1500 are refused past one query chunk, in ``repro`` too)
     and a 4-token prompt with 64 new, and llama-3.2-vision-11b (40
     layers, 8 with cross-attention, 10,110,734,344 parameters,
     flash_attention=True, its cross gates, zero at init, seeded nonzero)
     2 prompts of 8192 tokens with 1600 seeded stub vision tokens each
     and 16 new, through ``engine.generate`` at full width and depth
     (bf16, seeded; each count equal to the config's on the meta
     device), every launch count set to 0 just before and read just
     after: flash 40 per VLM prefill, every other kernel 0 (whisper's
     encoder and decoder lie under FLASH_MIN_SEQ, its flash off). Each
     prints prefill ms (whisper: and its encoder's), decode ms a step,
     one decode step's idle share under torch.profiler and peak memory;
     the VLM its first cross block's prefill split by the profiler into
     flash, cross-attention (the unchunked ``_grouped_attn`` over the
     memory), GEMMs and the rest. Checks: (1) one VLM cross block at full
     width (S = 2048, M = 1600) and one whisper encoder layer (S_enc =
     1536), float32 (TF32 off), card against CPU within 1e-5 x max; (2)
     each decode step's logits against the teacher-forced forward (the
     same memory, padded at the end to a multiple of 512) within 5e-2 x
     max |logit|, both models; (3) the VLM's prefill logits against
     flash_attention=False (no flash launch) within 5e-2 x max |logit|;
     (4) each cross cache after prefill equals its memory's K/V
     projections bit for bit, and holds the same bits after the last
     decode step; (5) the VLM's prefill logits with every gate at 0
     differ from the seeded gates' by more than 1e-3 x max |logit|.
 16. sharded training: deepseek-moe-16b at full width on four ranks
     sharing the card through gloo (``run_ranks``, ``--mesh-phase 16``;
     every group with a 300 s timeout), on (data, model) = (1, 4) and
     (2, 2) with experts over both axes and ZeRO-1 over "data", one mesh
     after the other, each rank its blocks of the one-rank model the
     same seed draws. Checks: (1) a 1 dense + 1 MoE cut in float32
     (capacity 8, the aux loss off: over a mesh it is the mean of the
     blocks' aux), one step on 4 x 1024 tokens, the loss, grad norm and
     every parameter block within 1e-5 x max of the one-rank step's
     (TF32 off; an entry whose gradient is at the noise floor, m under
     1e-6 of max |m|, within lr); (2) 1 dense + 1 MoE layer (phase 11's
     settings: bf16, capacity 1.25, remat; cut from phase 11's 1 + 3 at
     4096 a row so that phase 18 fits the run's time) for 2 steps of 2 x
     2048 x accum 2
     through ``RestartManager.run`` on ``PackedLoader``'s blocks, every
     loss finite and within 5% of the one-rank run's on the same batch,
     every replicated leaf the same bits on its replicas after each
     step; logged: step wall, tokens/s, each rank's peak and the card's
     (nvidia-smi), the last step's collectives timed (the exchange's and
     the all-reduces' shares), the MoE drops per rank
     and layer; (3) each rank's kv sort and kv merge launches (counts set
     to 0 just before the run, read just after) equal to the data round
     plus 2 steps of ``moe_dispatch_launches`` at the rank's 1024 tokens
     and 4 shards, and nonzero; (4) ``python -m repro_torch.launch.train
     --arch deepseek-moe-16b --full-config --layers 2 --seq-len 1024
     --global-batch 4 --steps 3 --save-every 2 --dist-backend gloo`` on
     four ranks as torchrun starts them, then, its step-3 checkpoint
     removed as if the run had died after step 2's, again with
     ``--resume``: every rank resumes at step 2 (each saves step 3), and
     the third step's line (step 2) equals the uninterrupted run's.
 17. sharded serving: deepseek-moe-16b served at full width on four ranks
     sharing the card through gloo (``run_ranks``, ``--mesh-phase 17``;
     every group with a 300 s timeout) through ``serve.engine``'s
     prefill, ``extend_caches``, decode steps and ``generate`` on a
     sharded ``Model``, against the one-rank port of the same seed, run
     in this process before the ranks start (its MoE ``grouped_ffn``
     with the assignments the ranks' dispatch keeps, ``dispatch_keep``:
     EP x TP decode's expert capacity at one token a data rank is 1
     whatever the factor). Checks: (1) a 1 dense + 1 MoE cut in float32
     (TF32 off, capacity 16: nothing drops at prefill), 2 prompts of 1024
     + 8 steps fed the reference's tokens, on (data, model) = (1, 4) with
     expert-TP decode, (2, 2) with ``decode_moe_ep`` and (1, 4) with
     ``seq_shard``: the prefill and every step's logits and the caches
     gathered after prefill and after the last step within 1e-5 x max of
     the reference's, replicated logits the same bits; (2) phase 11's
     cut (1 dense + 3 MoE, bf16, flash) on (2, 2) with ``decode_moe_ep``, 2
     prompts of 8192 + 16 new: with the reference's routing replayed and
     its tokens fed, the prefill logits and every step's within 5e-2 x
     max |logit|, and the drops summed over the ranks equal to the
     reference's rule, layer by layer; then the served run at capacity
     1.25 (``generate``), its pieces timed from inside: the experts' re-lay
     each way, prefill (its all-reduces', all-gathers' and exchange's
     shares), the decode steps, tokens/s; then a step's shares, each
     rank's peak and the card's (nvidia-smi), the drops per rank and
     layer, a decode step's idle share on rank 0; every rank's tokens
     the same; (3) each rank's launches in ``generate`` (counts set to 0
     just before, read just after) equal to 3 MoE layers x
     ``moe_dispatch_launches`` (prefill: 4096 tokens, 4 shards; each of
     15 steps: 1 token, 2 shards) and flash one a layer, each nonzero.
 18. the other mixers across ranks: four gloo ranks sharing the card
     (``run_ranks``, ``--mesh-phase 18``; every group with a 300 s
     timeout), each holding its blocks of the one-rank model the same
     seed draws, against the one-rank port run in this process and freed
     before the ranks start. Checks: (1) in float32 with TF32 off, each
     error within 1e-5 x max of the reference's: deepseek-v3's first
     dense MLA layer (flash on), 1 x 8192 + 4 steps on (1, 4) and on
     (1, 4) with ``seq_shard`` (flash's float32 MLA route once a prefill
     on each rank), and one Adafactor step with ZeRO-1 and float32 states
     on (2, 2) at 2 x 1024 (loss, grad norm, every ``vr`` / ``vc`` / ``v``
     block by its square root, the RMS the update divides by, every
     parameter block); recurrentgemma-9b's first (rec, rec,
     local) period, 2 x 2560 + 8 steps (the ring rolls past the 2048
     window) and one request of 1024 (the re-slot), on (1, 4), (2, 2) and
     (1, 4) with ``seq_shard``; falcon-mamba-7b's first 2 layers, 2 x
     1024 + 8 on (1, 4) and (2, 2); whisper-base whole (2 x (1536 frames
     + 4 tokens) + 8) and the VLM's first period (2 x 1024 + 8 over 1600
     vision tokens, gates seeded nonzero) on the three; the prefill and
     every step's logits (the decode fed the reference's tokens), the
     caches gathered after prefill, after ``extend_caches`` and after the
     last step; one AdamW step on (2, 2) at 2 x 512 of the recurrent,
     Mamba and whisper cuts and of the VLM period's last two layers
     (cross + self, self: four ranks' float32 AdamW states of the whole
     period exceed the card); (2) deepseek-v3's 3 dense + 1 MoE cut (phase
     13's, 15,111,101,440 parameters, bf16, flash) on (2, 2) with
     ``decode_moe_ep`` and ``seq_shard``, 2 prompts of 8192 + 16 new, held
     and served as phase 17's check 2 (``serve_bf16_rank``,
     ``hold_served``); (3) deepseek-v3's 3 dense MLA layers trained in
     bf16 on (2, 2): Adafactor with bfloat16 states, ZeRO-1, remat, steps 1
     and 2 of 2 x 4096 x accum 2, every loss within 5% of the one-rank
     run's on the same batch, replicated leaves the same bits after each
     step, the step wall and each collective's share of a third; (4) each
     run's launches (counts set to 0 just before, read just after): flash
     once a prefill a rank in (1)'s MLA runs, phase 17's derivation in
     (2), none elsewhere. Phase 17's check 2 runs on phase 11's cut (1
     dense + 3 MoE), so that this phase fits the run's time.
Last, one JSON line {"kernels": [...]} with each kernel's numbers (the
bitonic kernels' ``launches`` are phase 3's, phase 8's serving runs'
as ``launches_serve``, phase 9's ranks' as ``launches_mesh``, phase 10's
served run's as ``launches_moe``, phase 11's training run's as
``launches_train``, phase 12's two batcher runs' as ``launches_batch``,
phase 13's served run's as ``launches_mla``, flash's too, with flash's
numbers at MLA's shape as ``*_mla``, phase 14's two served models' as
``launches_rec``, all 0, phase 15's two served models' as
``launches_cross`` (flash 40, the rest 0), phase 16's check-2 runs
summed over the ranks and both meshes as ``launches_sharded``, phase
17's served runs summed over the ranks as ``launches_sharded_serve``,
phase 18's counted runs summed over the ranks as ``launches_tp``; their
64-bit ones as ``*_x64``: times at a 2^22 int64 sort's shapes,
``launches_x64`` the 8-byte launches of phase 7), the card's name and
power limit, and, last, {"ok": true, "device": {...}}.

    python3 chip_smoke.py --phases 2,7   # a development run: 1, 2 and 7 only
    python3 chip_smoke.py --phases 8     # phases 1, 2 and 8
    python3 chip_smoke.py --phases 9     # phases 1, 2 and 9
    python3 chip_smoke.py --phases 10    # phases 1, 2 and 10
    python3 chip_smoke.py --phases 11    # phases 1, 2 and 11
    python3 chip_smoke.py --phases 9,12  # phases 1, 2, 9 and 12
    python3 chip_smoke.py --phases 13    # phases 1, 2 and 13
    python3 chip_smoke.py --phases 14    # phases 1, 2 and 14
    python3 chip_smoke.py --phases 15    # phases 1, 2 and 15
    python3 chip_smoke.py --phases 16    # phases 1, 2 and 16
    python3 chip_smoke.py --phases 17    # phases 1, 2 and 17
    python3 chip_smoke.py --phases 18    # phases 1, 2 and 18

Any failure raises and exits non-zero before the last line. Without a CUDA
device, or without the port beside this script, it exits 2 and prints no
result. It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12     # H100 SXM non-tensor float32 rate (NVIDIA data sheet)
BF16_OPS_PER_S = 989e12    # H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet)
SOURCE = "src/repro_torch/kernels/csrc/bitonic.cu"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash.cu"
FLASH_REPLACES = "src/repro/kernels/flash.py:41"
REPLACES = {
    "bitonic_sort_rows": "src/repro/kernels/bitonic.py:123",
    "bitonic_sort_rows_kv": "src/repro/kernels/bitonic.py:128",
    "bitonic_merge_rows": "src/repro/kernels/bitonic.py:134",
    "bitonic_merge_rows_kv": "src/repro/kernels/bitonic.py:140",
}


def log(*parts) -> None:
    print(*parts, flush=True)


def max_abs_err(a, b) -> float:
    """0.0 when the pair agrees bit for bit (NaN included); raises with the
    largest |a - b| otherwise."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype differ: {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    if torch.equal(a.view(torch.int32), b.view(torch.int32)):
        return 0.0
    if a.dtype == torch.uint64:
        a, b = a.view(torch.int64), b.view(torch.int64)
    wide = torch.float64 if a.dtype.is_floating_point else torch.int64
    err = float((a.to(wide) - b.to(wide)).abs().nan_to_num(float("inf")).max())
    raise AssertionError(f"kernel and twin differ (max abs err {err})")


def time_ms(fn, reps: int = 20, batch: int = 10) -> float:
    """Time of one ``fn`` on the card: the median over ``reps`` samples of a
    batch of ``batch`` calls between two CUDA events, divided by ``batch``
    (a batch keeps the card busy while the host launches the next call, so a
    short kernel's time is not the host's)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def network_ops(rows: int, n: int, merge: bool) -> int:
    """Compare-exchanges of the network: one comparison per pair per stage."""
    k = n.bit_length() - 1
    stages = k if merge else k * (k + 1) // 2
    return rows * (n // 2) * stages


def bound(bytes_moved: int, ops: int, ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_entries(report: str) -> dict:
    """Each kernel of a ``ptxas -v`` report (by mangled name): registers,
    stack frame and spill bytes."""
    out, name = {}, None
    for line in report.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name = m[1]
            out[name] = {}
        elif name and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                                      r"(\d+) bytes spill loads", line)):
            out[name].update(stack=int(m[1]), spills=int(m[2]) + int(m[3]))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m[1])
    return out


# sort_rows_kernel<LOG_N, HAS_V, TB, K, V> and merge_rows_kernel<LOG_N2, HAS_V,
# TB, K, V>; i = int32, j = uint32, f = float, l = int64, m = uint64, d = double
ENTRY = r"{}_rows_kernelILi(\d+)ELb([01])ELb([01])E([ijfld])([ijfldm])E"
SORT_ENTRY = re.compile(ENTRY.format("sort"))
MERGE_ENTRY = re.compile(ENTRY.format("merge"))


def check_ptxas(report: str) -> None:
    """Phase 1's check of flash.cu's ptxas report: the wgmma kernel spills
    nothing, and ptxas neither ignored setmaxnreg (C7508) nor serialized
    the wgmma instructions (either would cost the kernel its design); both
    instantiations at MLA's (192, 128), wgmma and FMA, are there with no
    stack frame and no spills."""
    bad = [line.strip() for line in report.splitlines()
           if "setmaxnreg" in line or ("wgmma" in line and "serialized" in line)]
    entries = ptxas_entries(report)
    mla = ("flash_fwd_wgmmaILi192ELi128E", "flash_fwd_f32_mla")
    for name, e in entries.items():
        if "flash_fwd_wgmma" in name and e.get("spills"):
            bad.append(f"{name}: {e['spills']} bytes spilled")
        if any(kernel in name for kernel in mla) and (e.get("spills") or e.get("stack")):
            bad.append(f"{name}: {e.get('stack')} bytes stack, {e.get('spills')} spilled")
    for kernel in mla:
        if not any(kernel in name for name in entries):
            bad.append(f"{kernel} at (192, 128) is missing")
    if bad:
        raise AssertionError("ptxas report of flash.cu: " + "; ".join(bad))


def check_sort_ptxas(report: str) -> None:
    """Phase 1's check of bitonic.cu's ptxas report: every instantiation of
    the row-sort and of the merge kernel is there and keeps its registers
    in registers (no stack frame, no spills: a register array indexed at
    run time would show there). Logs the registers per row length, the
    most over the 4-byte and over the 8-byte key types."""
    from repro_torch.kernels import bitonic

    log_max, types = bitonic.MAX_ROW.bit_length() - 1, len(bitonic._TYPE_CODES)
    # log N x (keys, kv with the values' bits in 4 or 8 bytes, kv stable) types
    want = log_max * (types + 2 * types + types * types)
    entries = ptxas_entries(report)
    for kernel, pattern in (("sort_rows_kernel", SORT_ENTRY), ("merge_rows_kernel", MERGE_ENTRY)):
        found = {tuple(m.groups()): e for name, e in entries.items()
                 if (m := pattern.search(name))}
        bad = [f"{key}: {e}" for key, e in found.items()
               if e.get("stack", 1) or e.get("spills", 1) or "registers" not in e]
        if len(found) != want or bad:
            raise AssertionError(f"ptxas report of bitonic.cu: {len(found)} {kernel} "
                                 f"instantiations (want {want}); " + "; ".join(bad))
        for log_n in range(1, log_max + 1):
            regs = {f"{kind} {width}": max(e["registers"] for (ln, v, tb, k, _), e in found.items()
                                           if int(ln) == log_n and (v, tb) == flags
                                           and (k in "ld") == (width == "64"))
                    for width in ("32", "64")
                    for kind, flags in (("keys", ("0", "0")), ("kv", ("1", "0")),
                                        ("kv stable", ("1", "1")))}
            log(f"phase 1: ptxas: {kernel} N={1 << log_n}: registers (most over the "
                f"key/value types, by key bits) {regs}, no stack frame, no spills")


# ------------------------------------------------------------------ phase 2


# unsigned dtype -> (its signed lane, the top bit), as keyenc.to_lane
LANES = {"uint32": ("int32", -(1 << 31)), "uint64": ("int64", -(1 << 63))}


def rows_of(gen, rows, n, dtype, kind, device):
    """Seeded (rows, n) keys: "uniform" over 2^21 values (4-byte types) or
    2^63 (8-byte types), "dup" over 5 (with +-0.0 ties among floats),
    "special" over 7: heavy duplicates with +-0.0, +-inf and NaN among
    floats, the type's extremes among integers. Unsigned types are drawn
    as their signed lane."""
    import torch

    name = str(dtype).removeprefix("torch.")
    lane = getattr(torch, LANES[name][0]) if name in LANES else dtype
    wide = dtype.itemsize == 8
    if kind == "special":
        x = torch.randint(-3, 4, (rows, n), generator=gen, device=device)
        coin = torch.rand(x.shape, generator=gen, device=device) < 0.5
        if dtype.is_floating_point:
            f = x.to(dtype)
            f = torch.where((x == 0) & coin, torch.full_like(f, -0.0), f)
            f = torch.where(x == 3, torch.full_like(f, float("inf")), f)
            f = torch.where(x == -3, torch.full_like(f, float("-inf")), f)
            return torch.where((x == 2) & coin, torch.full_like(f, float("nan")), f)
        x = x.to(lane)
        x = torch.where(x == 3, torch.full_like(x, torch.iinfo(lane).max), x)
        x = torch.where(x == -3, torch.full_like(x, torch.iinfo(lane).min), x)
    else:
        if kind == "dup":
            x = torch.randint(0, 5, (rows, n), generator=gen, device=device)
        else:
            top = 1 << (62 if wide else 20)
            x = torch.randint(-top, top, (rows, n), generator=gen, device=device)
        if dtype.is_floating_point:
            x = x.to(dtype) / 7
            if kind == "dup":
                x = torch.where(torch.rand(x.shape, generator=gen, device=device) < 0.5, x, -x)
            return x  # duplicates include +0.0 and -0.0
        x = x.to(lane)
    return (x ^ LANES[name][1]).view(dtype) if name in LANES else x


def type_matrix(x64: bool):
    """(key types, value types) of phase 2: the 32-bit kernels' (3 x 3),
    or the 8-byte keys (int64, float64, and uint64 by its lane) with every
    value type."""
    import torch

    narrow = (torch.int32, torch.uint32, torch.float32)
    if not x64:
        return narrow, narrow
    return (torch.int64, torch.float64, torch.uint64), (*narrow, torch.int64, torch.uint64,
                                                        torch.float64)


def check_sorts(gen, device, errs: dict, x64: bool = False) -> None:
    """Both row sorts equal their twin bit for bit at every row length
    (row counts 1, 3 and one that leaves the last CTA short) and at the
    main path's and the widest rows' shapes (4096, 1024), (64, 2048),
    (32, 4096) and (16, 8192): every key/value type pair of
    ``type_matrix(x64)``, stable on and off, uniform and special keys."""
    import torch
    from repro_torch.kernels import bitonic

    key_types, value_types = type_matrix(x64)

    def check(rows, n):
        for kd in key_types:
            for kind in ("uniform", "special"):
                k = rows_of(gen, rows, n, kd, kind, device)
                e = max_abs_err(bitonic.bitonic_sort_rows(k), bitonic.sort_rows_twin(k))
                errs["bitonic_sort_rows"] = max(errs["bitonic_sort_rows"], e)
                for vd in value_types:
                    v = rows_of(gen, rows, n, vd, "special", device)
                    for stable in (True, False):
                        ok, ov = bitonic.bitonic_sort_rows_kv(k, v, stable=stable)
                        tk, tv = bitonic.sort_rows_twin(k, v, stable=stable)
                        e = max(max_abs_err(ok, tk), max_abs_err(ov, tv))
                        errs["bitonic_sort_rows_kv"] = max(errs["bitonic_sort_rows_kv"], e)

    what = (f"{len(key_types)} x {len(value_types)} types{' (8-byte keys)' if x64 else ''}, "
            f"stable on/off, uniform and special")
    for log_n in range(1, bitonic.MAX_ROW.bit_length()):
        n = 1 << log_n
        per_cta = bitonic.sort_rows_per_cta(n)
        counts = sorted({1, 3, 2 * per_cta + 1 if per_cta > 1 else 5})
        for rows in counts:
            check(rows, n)
        log(f"phase 2: row sorts of {n}, rows {counts}, {per_cta} rows a CTA: both kernels "
            f"equal their twin bit for bit ({what})")
    for rows, n in [(4096, 1024), (64, 2048), (32, 4096), (16, 8192)]:
        check(rows, n)
        log(f"phase 2: row sorts of ({rows}, {n}): both kernels equal their twin bit for bit "
            f"({what})")
    torch.cuda.synchronize()


def time_sorts(gen, rows: int, device, kd=None, vd=None) -> dict:
    """Both row sorts on (rows, 1024) keys of ``kd`` (float32), the kv sort
    with provenance values of ``vd`` (int32), stable: each kernel's output
    against its twin's, bit for bit, on the tensors it is timed on;
    kernel, twin and torch.sort times and the bound."""
    import torch
    from repro_torch.kernels import bitonic

    kd, vd = kd or torch.float32, vd or torch.int32
    keys = rows_of(gen, rows, 1024, kd, "uniform", device)
    vals = torch.arange(keys.numel(), dtype=vd, device=device).reshape(keys.shape)
    numbers = {}
    for name, kern, twin, lib, moved in (
            ("bitonic_sort_rows", lambda: bitonic.bitonic_sort_rows(keys),
             lambda: bitonic.sort_rows_twin(keys), lambda: torch.sort(keys, dim=-1),
             2 * kd.itemsize),
            ("bitonic_sort_rows_kv", lambda: bitonic.bitonic_sort_rows_kv(keys, vals),
             lambda: bitonic.sort_rows_twin(keys, vals),
             lambda: torch.sort(keys, dim=-1, stable=True), 2 * (kd.itemsize + vd.itemsize))):
        got, want = kern(), twin()
        if name == "bitonic_sort_rows":
            got, want = (got,), (want,)
        err = max(max_abs_err(g, w) for g, w in zip(got, want))
        del got, want
        b_ms, b_by = bound(moved * keys.numel(), network_ops(rows, 1024, merge=False))
        numbers[name] = dict(ms=time_ms(kern), plain_ms=time_ms(twin, reps=3, batch=1),
                             library_ms=time_ms(lib), bound_ms=b_ms, bound_by=b_by,
                             max_abs_err=err, shapes=f"({rows}, 1024)")
    return numbers


def merge_operands(gen, rows, n, dtype, kind, device, strided: bool):
    """Two (rows, n) operands of a merge: sorted keys by the row-sort
    twin, or values (``kind`` "values": "special" rows, unsorted). Strided:
    the even and odd rows of one (2 rows, n) tensor, as the merge tree
    passes them (row stride 2n); else two contiguous tensors."""
    from repro_torch.kernels import bitonic

    def make(r):
        x = rows_of(gen, r, n, dtype, "special" if kind == "values" else kind, device)
        return x if kind == "values" else bitonic.sort_rows_twin(x)

    if strided:
        x = make(2 * rows)
        return x[0::2], x[1::2]
    return make(rows), make(rows)


def check_merges(gen, device, errs: dict, x64: bool = False) -> None:
    """Both merges equal their twin bit for bit into every row length 2n
    (row counts 1, 3 and one that leaves the last CTA short) and at the
    main path's shapes: every key/value type pair of ``type_matrix(x64)``,
    stable on and off, uniform and special keys, contiguous operands and
    strided views."""
    import torch
    from repro_torch.kernels import bitonic

    key_types, value_types = type_matrix(x64)

    def check(rows, n):
        for strided in (False, True):
            for kd in key_types:
                for kind in ("uniform", "special"):
                    a, b = merge_operands(gen, rows, n, kd, kind, device, strided)
                    e = max_abs_err(bitonic.bitonic_merge_rows(a, b), bitonic.merge_rows_twin(a, b))
                    errs["bitonic_merge_rows"] = max(errs["bitonic_merge_rows"], e)
                    for vd in value_types:
                        av, bv = merge_operands(gen, rows, n, vd, "values", device, strided)
                        for stable in (True, False):
                            ok, ov = bitonic.bitonic_merge_rows_kv(a, av, b, bv, stable=stable)
                            tk, tv = bitonic.merge_rows_twin(a, b, av, bv, stable=stable)
                            e = max(max_abs_err(ok, tk), max_abs_err(ov, tv))
                            errs["bitonic_merge_rows_kv"] = max(errs["bitonic_merge_rows_kv"], e)

    what = (f"{len(key_types)} x {len(value_types)} types{' (8-byte keys)' if x64 else ''}, "
            f"stable on/off, uniform and special, contiguous and strided")
    for log_n2 in range(1, bitonic.MAX_ROW.bit_length()):
        n2 = 1 << log_n2
        per_cta = bitonic.sort_rows_per_cta(n2)
        counts = sorted({1, 3, 2 * per_cta + 1 if per_cta > 1 else 5})
        for rows in counts:
            check(rows, n2 // 2)
        log(f"phase 2: merges into {n2}, rows {counts}, {per_cta} rows a CTA: both kernels "
            f"equal their twin bit for bit ({what})")
    for rows, n in MERGE_SHAPES:
        check(rows, n)
        log(f"phase 2: merges of ({rows}, {n}) + ({rows}, {n}): both kernels equal their twin "
            f"bit for bit ({what})")
    torch.cuda.synchronize()


# The merges one sort of n = 2^22 float32 keys gives the kernels (p = 8,
# tile = 1024): three rounds, into rows of 2048, 4096 and 8192.
MERGE_SHAPES = ((2048, 1024), (1024, 2048), (512, 4096))


def time_merges(gen, device, kd=None, vd=None) -> dict:
    """Both merges at MERGE_SHAPES on keys of ``kd`` (float32), the kv merge
    with provenance values of ``vd`` (int32), stable, on the merge tree's
    strided views: the kernel straight through ``bitonic._launch`` into
    outputs allocated once, held to its twin bit for bit on the tensors it
    is timed on, and the whole wrapper call; the twin, torch.sort on the
    same rows and the bound. Sums over the three shapes."""
    import torch
    from repro_torch.kernels import bitonic

    kd, vd = kd or torch.float32, vd or torch.int32
    kc, vc = bitonic._TYPE_CODES[kd], bitonic._TYPE_CODES[vd]
    numbers = {}
    for name, kv in (("bitonic_merge_rows", False), ("bitonic_merge_rows_kv", True)):
        tot = dict(ms=0.0, wrapper_ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
        for rows, n in MERGE_SHAPES:
            a, b = merge_operands(gen, rows, n, kd, "uniform", device, True)
            ids = torch.arange(2 * rows * n, dtype=vd, device=device).view(2 * rows, n)
            av, bv = ids[0::2], ids[1::2]
            ok = torch.empty((rows, 2 * n), dtype=kd, device=device)
            ov = torch.empty((rows, 2 * n), dtype=vd, device=device)
            both = torch.cat([a, b], dim=-1)
            stream = bitonic._stream(a)
            if kv:
                args = (a.data_ptr(), a.stride(0), av.data_ptr(), av.stride(0), b.data_ptr(),
                        b.stride(0), bv.data_ptr(), bv.stride(0), ok.data_ptr(), ov.data_ptr(),
                        rows, n, kc, vc, 1, stream)
                wrapper = lambda: bitonic.bitonic_merge_rows_kv(a, av, b, bv)
                twin = lambda: bitonic.merge_rows_twin(a, b, av, bv)
                lib = lambda: torch.sort(both, dim=-1, stable=True)
            else:
                args = (a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0), ok.data_ptr(),
                        rows, n, kc, stream)
                wrapper = lambda: bitonic.bitonic_merge_rows(a, b)
                twin = lambda: bitonic.merge_rows_twin(a, b)
                lib = lambda: torch.sort(both, dim=-1)
            kern = lambda: bitonic._launch(name, *args)
            kern()
            want = twin()
            err = max_abs_err(ok, want[0]) if kv else max_abs_err(ok, want)
            if kv:
                err = max(err, max_abs_err(ov, want[1]))
            del want
            moved = 2 * both.numel() * (kd.itemsize + (vd.itemsize if kv else 0))
            b_ms, b_by = bound(moved, network_ops(rows, 2 * n, merge=True))
            t = dict(ms=time_ms(kern), wrapper_ms=time_ms(wrapper),
                     plain_ms=time_ms(twin, reps=3, batch=1), library_ms=time_ms(lib),
                     bound_ms=b_ms)
            log(f"phase 2: {name} {dtype_name(kd)} ({rows}, {n}) -> {2 * n}, strided views: "
                f"kernel through "
                f"_launch {t['ms']:.4f} ms, through the wrapper {t['wrapper_ms']:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}), twin {t['plain_ms']:.4f} ms, torch.sort "
                f"{t['library_ms']:.4f} ms, max abs err {err}")
            for k in tot:
                tot[k] += t[k]
        numbers[name] = dict(tot, bound_by=b_by, shapes="(2048|1024|512, 1024|2048|4096)")
    return numbers


def dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def check_kernels(device) -> dict:
    """Phase 2: every kernel equals its twin exactly, the 32-bit and the
    8-byte instantiations; times at main-path shapes, 32- and 64-bit.
    Returns per-kernel numbers for the final JSON line (the 64-bit ones
    under ``*_x64``)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(0)
    errs = {name: 0.0 for name in REPLACES}
    check_sorts(gen, device, errs)
    check_merges(gen, device, errs)
    t0 = time.perf_counter()
    check_sorts(gen, device, errs, x64=True)
    check_merges(gen, device, errs, x64=True)
    log(f"phase 2: the 8-byte instantiations checked in {time.perf_counter() - t0:.2f} s")

    # Timing at the shapes one sort of n = 2^22 float32 keys (p = 8,
    # tile = 1024) gives each kernel: one sort launch on (4096, 1024), and
    # the merges of MERGE_SHAPES; the row sorts also at (131072, 1024),
    # the launch of a 2^27 sort (logged only).
    for name, num in time_sorts(gen, 131072, device).items():
        log(f"phase 2: {name} {num['shapes']}: kernel {num['ms']:.4f} ms, bound "
            f"{num['bound_ms']:.4f} ms ({num['bound_by']}), twin {num['plain_ms']:.4f} ms, "
            f"torch.sort {num['library_ms']:.4f} ms, max abs err {num['max_abs_err']}")
    numbers = time_sorts(gen, 4096, device)
    for name, num in time_merges(gen, device).items():
        numbers[name] = dict(num, max_abs_err=errs[name])
    # the 8-byte instantiations at the shapes of a 2^22 int64 sort, with
    # int64 values (the kv kernels' widest case)
    wide = time_sorts(gen, 4096, device, torch.int64, torch.int64)
    wide.update(time_merges(gen, device, torch.int64, torch.int64))
    for name, num in wide.items():
        numbers[name].update({f"{k}_x64": v for k, v in num.items()
                              if k in ("ms", "plain_ms", "library_ms", "bound_ms", "wrapper_ms")})
    for name, num in numbers.items():
        for sfx, what in (("", "float32 keys, int32 values"), ("_x64", "int64 keys and values")):
            via = (f"through _launch {num['ms' + sfx]:.4f} ms, through the wrapper "
                   f"{num['wrapper_ms' + sfx]:.4f} ms" if "wrapper_ms" in num
                   else f"through the wrapper {num['ms' + sfx]:.4f} ms")
            log(f"phase 2: {name} {num['shapes']} ({what}): kernel {via}, bound "
                f"{num['bound_ms' + sfx]:.4f} ms ({num['bound_by']}), twin "
                f"{num['plain_ms' + sfx]:.4f} ms, torch.sort {num['library_ms' + sfx]:.4f} ms, "
                f"max abs err {num['max_abs_err']}")
    return numbers


# ------------------------------------------------------------------ phase 4

# the last two: qwen3-4b's prefill (GQA 32 / 8) and deepseek-moe-16b's (MHA 16)
FLASH_SHAPES = [(1, 256, 4, 2, 16), (2, 1000, 4, 1, 64), (2, 1000, 8, 2, 128),
                (1, 77, 8, 8, 128), (1, 8192, 32, 8, 128), (2, 8192, 32, 8, 128),
                (2, 8192, 16, 16, 128)]
# MLA's (dqk, dv) = (192, 128), heads not grouped (H = KV); the last two are
# deepseek-v3's prefill of one sequence and phase 13's of two
FLASH_MLA_SHAPES = [(1, 300, 2, 2, 192, 128), (2, 1000, 4, 4, 192, 128),
                    (1, 77, 8, 8, 192, 128), (1, 8192, 128, 128, 192, 128),
                    (2, 8192, 128, 128, 192, 128)]
FLASH_MLA_TIMED = FLASH_MLA_SHAPES[-2]  # flash's MLA time (the kernels line's *_mla)
# max abs err against flash_attention_twin; bf16: tests/test_flash_kernel.py's
FLASH_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
FLASH_MLA_F32_REL = 1e-5  # float32 at (192, 128): also within this x max |twin|


def flash_inputs(gen, B, S, H, KV, dh, dtype, device, dv=None):
    """q (B, S, H, dh), k (B, S, KV, dh), v (B, S, KV, dv), dv = dh unless
    given."""
    import torch

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    return randn(B, S, H, dh), randn(B, S, KV, dh), randn(B, S, KV, dh if dv is None else dv)


def flash_work(B, S, H, KV, dh, causal: bool, itemsize: int, dv=None) -> tuple[int, int]:
    """Bytes (q, k, v read once, o written once) and the useful products'
    operations: 2 * (dqk + dv) per (query, key) pair that the mask keeps
    (dv = dh unless given)."""
    dv = dh if dv is None else dv
    pairs = S * (S + 1) // 2 if causal else S * S
    moved = (B * S * H * (dh + dv) + B * S * KV * (dh + dv)) * itemsize
    return moved, 2 * B * H * (dh + dv) * pairs


def check_flash(device) -> dict:
    """Phase 4: the flash kernel against its twins on the card (causal and
    full, bf16 and f32, the ragged S = 1000 and the prefill shapes
    included, MLA's (192, 128) widths among them); times at the qwen3-4b
    prefill shape and at deepseek-v3's MLA prefill (``*_mla``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash

    torch.backends.cuda.matmul.allow_tf32 = False  # the twin's f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(2)
    worst, worst_mla = 0.0, 0.0
    shapes = [(*shape, shape[-1]) for shape in FLASH_SHAPES] + FLASH_MLA_SHAPES
    for B, S, H, KV, dh, dv in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            for causal in (True, False):
                q, k, v = flash_inputs(gen, B, S, H, KV, dh, dtype, device, dv)
                got = flash.flash_attention(q, k, v, causal=causal)
                want = flash.flash_attention_twin(q, k, v, causal=causal)
                torch.cuda.synchronize()
                name = str(dtype).removeprefix("torch.")
                route = flash.ROUTES[(dtype, dh, dv)]
                dims = (B, S, H, KV, dh) if dh == dv else (B, S, H, KV, f"{dh}/{dv}")
                label = f"flash {dims} {name} causal={causal} route={route}"
                err = float((got.float() - want.float()).abs().max())
                if not (err <= FLASH_TOL[name]) or got.shape != want.shape:
                    raise AssertionError(f"{label}: max abs err {err} > {FLASH_TOL[name]}")
                line = f"max abs err {err:.3e} (tolerance {FLASH_TOL[name]})"
                if dtype == torch.float32 and dh != dv:
                    limit = FLASH_MLA_F32_REL * float(want.abs().max())
                    if not err <= limit:
                        raise AssertionError(f"{label}: max abs err {err} > {limit} "
                                             f"({FLASH_MLA_F32_REL} x max |twin|)")
                    line += f"; within {limit:.3e} ({FLASH_MLA_F32_REL} x max |twin|)"
                if dtype == torch.bfloat16:
                    tight = flash.bf16_error(got, flash.kernel_twin(q, k, v, causal=causal))
                    line += (f"; against kernel_twin: max abs err {tight['max_abs']:.3e}, "
                             f"limit use {tight['limit_use']:.4f} (limit 1; floor needed "
                             f"{tight['floor_needed']:.3e} x rms_row), mean err / rms "
                             f"{tight['mean_rel']:.3e} (limit {flash.BF16_MEAN_REL})")
                    if not tight["ok"]:
                        raise AssertionError(f"{label}: outside bf16_error's limit: {tight}")
                    if dh == dv:
                        worst = max(worst, tight["max_abs"])
                    else:
                        worst_mla = max(worst_mla, tight["max_abs"])
                log(f"phase 4: {label}: {line}")
                del q, k, v, got, want

    B, S, H, KV, dh = 2, 8192, 32, 8, 128  # qwen3-4b prefill at B = 2
    q, k, v = flash_inputs(gen, B, S, H, KV, dh, torch.bfloat16, device)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    moved, ops = flash_work(B, S, H, KV, dh, True, 2)
    b_ms, b_by = bound(moved, ops, BF16_OPS_PER_S)
    num = dict(
        ms=time_ms(lambda: flash.flash_attention(q, k, v, causal=True)),
        plain_ms=time_ms(lambda: flash.kernel_twin(q, k, v, causal=True), reps=3, batch=1),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by, max_abs_err=worst)
    log(f"phase 4: flash_attention {(B, S, H, KV, dh)} bf16 causal: kernel {num['ms']:.4f} ms "
        f"({ops / num['ms'] / 1e9:.1f} TFLOP/s useful), bound {b_ms:.4f} ms ({b_by}), "
        f"kernel_twin {num['plain_ms']:.4f} ms, scaled_dot_product_attention "
        f"{num['library_ms']:.4f} ms")
    del q, k, v, qt, kt, vt

    num.update(mla_flash_times("phase 4", gen, device), max_abs_err_mla=worst_mla)
    return num


_MLA_FLASH_TIMES: dict = {}  # mla_flash_times' numbers, once a run


def mla_flash_times(label: str, gen, device) -> dict:
    """Flash at deepseek-v3's MLA prefill of one sequence
    (``FLASH_MLA_TIMED``), bf16, causal: the kernel's time, its bound,
    ``kernel_twin``'s and one scaled_dot_product_attention call's time on
    the same tensors; logged under ``label`` with the card. Keys end in
    ``_mla`` (the kernels line's). Timed once a run: a later call logs the
    first one's numbers again."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash

    B, S, H, KV, dh, dv = FLASH_MLA_TIMED
    if _MLA_FLASH_TIMES:
        num = _MLA_FLASH_TIMES
        log(f"{label}: flash_attention {(B, S, H, KV, f'{dh}/{dv}')} bf16 causal (MLA), as "
            f"timed in this run: kernel {num['ms_mla']:.4f} ms, bound "
            f"{num['bound_ms_mla']:.4f} ms, kernel_twin {num['plain_ms_mla']:.4f} ms, scaled_dot_product_attention "
            f"{num['library_ms_mla']:.4f} ms")
        return num
    q, k, v = flash_inputs(gen, B, S, H, KV, dh, torch.bfloat16, device, dv)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    moved, ops = flash_work(B, S, H, KV, dh, True, 2, dv)
    b_ms, b_by = bound(moved, ops, BF16_OPS_PER_S)
    num = dict(
        ms_mla=time_ms(lambda: flash.flash_attention(q, k, v, causal=True)),
        library_ms_mla=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=dh ** -0.5)),
        plain_ms_mla=time_ms(lambda: flash.kernel_twin(q, k, v, causal=True), reps=3, batch=1),
        bound_ms_mla=b_ms, bound_by_mla=b_by)
    log(f"{label}: flash_attention {(B, S, H, KV, f'{dh}/{dv}')} bf16 causal (MLA): kernel "
        f"{num['ms_mla']:.4f} ms ({ops / num['ms_mla'] / 1e9:.1f} TFLOP/s useful), bound "
        f"{b_ms:.4f} ms ({b_by}), kernel_twin {num['plain_ms_mla']:.4f} ms, "
        f"scaled_dot_product_attention {num['library_ms_mla']:.4f} ms; card {card_line()}")
    _MLA_FLASH_TIMES.update(num)
    return num


# ------------------------------------------------------------------ phase 3


def canon_pairs(keys, vals):
    """(key, value) pairs in lexicographic order, for tie-aware checks."""
    import torch

    by_val = torch.sort(vals, stable=True).indices
    order = by_val[torch.sort(keys[by_val], stable=True).indices]
    return keys[order], vals[order]


def run_main_path(device) -> dict:
    """Phase 3: repro_torch.sort through its entry point; returns the
    launch count of every kernel over this phase."""
    import torch
    import repro_torch
    from repro_torch.kernels import bitonic

    gen = torch.Generator(device=device).manual_seed(1)
    n = 1 << 22

    def timed(label, *args, expect=None, **kwargs):
        """One sort through the entry point, logged. ``expect``: the exact
        launches of (sort_rows, sort_rows_kv, merge_rows, merge_rows_kv)
        this sort must make on each try of the capacity ladder."""
        before = {fn.__name__: fn.launches for fn in bitonic.KERNELS}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = repro_torch.sort(*args, device=device, **kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches - before[fn.__name__] for fn in bitonic.KERNELS}
        log(f"phase 3: {label}: {wall * 1e3:.3f} ms wall, counts {out.counts.tolist()}, "
            f"imbalance {out.imbalance():.6f}, retries {out.meta.retries}, "
            f"launches {launches}")
        if expect is not None:
            expect = tuple(c * (1 + out.meta.retries) for c in expect)
            if tuple(launches.values()) != expect:
                raise AssertionError(f"{label}: launches {launches}, expected {expect}")
        return out

    bitonic.reset_launches()

    x = torch.rand(n, generator=gen, device=device)
    ref = torch.sort(x).values
    for i in range(3):
        out = timed(f"n=2^22 float32 uniform, run {i + 1}", x)
    assert out.meta.backend == "sim" and out.meta.plan.n_procs == 8
    assert torch.equal(out.keys, ref), "float32 keys not sorted"

    dup = torch.randint(0, 4, (n,), generator=gen, device=device, dtype=torch.int32)
    out = timed("n=2^22 int32, 4 distinct values", dup)
    assert torch.equal(out.keys, torch.sort(dup).values), "int32 keys not sorted"
    assert out.imbalance() < 1.01, f"imbalance {out.imbalance()} on duplicate keys"

    out = timed('n=2^22 float32 want="order"', x, want="order")
    assert torch.equal(out.order(), torch.sort(x, stable=True).indices.to(torch.int32))
    assert torch.equal(out.keys, ref)

    out = timed('n=2^22 float32 order="desc"', x, order="desc")
    assert torch.equal(out.keys, ref.flip(0)), "descending keys wrong"

    vals = torch.rand(n, generator=gen, device=device)
    out = timed("n=2^22 float32 keys + float32 values", x, vals)
    assert torch.equal(out.keys, ref)
    got_k, got_v = canon_pairs(out.keys, out.values)
    want_k, want_v = canon_pairs(x, vals)
    assert torch.equal(got_k, want_k) and torch.equal(got_v, want_v), "payload wrong"

    big = torch.rand(1 << 27, generator=gen, device=device)
    out = timed("n=2^27 float32, p=8, stream_threshold=None", big,
                limits=repro_torch.SortLimits(stream_threshold=None))
    assert torch.equal(out.keys, torch.sort(big).values), "2^27 keys not sorted"
    del big, out

    launches = {fn.__name__: fn.launches for fn in bitonic.KERNELS}
    log(f"phase 3: launches over the main path: {launches}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    bitonic.reset_launches()
    run_multikey(gen, device, timed)
    multi = {fn.__name__: fn.launches for fn in bitonic.KERNELS}
    log(f"phase 3: launches over the multi-key path: {multi}")
    missing = [k for k, v in multi.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the multi-key path: {missing}")
    check_nan_keys(gen, device, timed)
    return launches


def lex_order(cols, descending):
    """The stable lexicographic permutation of a key tuple: stable
    torch.sort passes from the last key to the first."""
    import torch

    perm = torch.arange(cols[0].numel(), device=cols[0].device)
    for col, desc in zip(cols[::-1], descending[::-1]):
        perm = perm[torch.sort(col[perm], stable=True, descending=desc).indices]
    return perm


def check_lex(label, out, cols, descending, values=None, want="values") -> None:
    """``out`` is the lexicographic sort of ``cols``: every key column, the
    permutation or the payload, bit for bit against ``lex_order``."""
    import torch

    perm = lex_order(cols, descending)
    dev = out.keys[0].device
    for i, (got, col) in enumerate(zip(out.keys, cols, strict=True)):
        if not torch.equal(got, col[perm].to(dev)):
            raise AssertionError(f"{label}: key column {i} differs from the torch.sort passes")
    if want == "order" and not torch.equal(out.order(), perm.to(device=dev, dtype=torch.int32)):
        raise AssertionError(f"{label}: permutation differs from the torch.sort passes")
    if values is not None and not torch.equal(out.values, values[perm].to(dev)):
        raise AssertionError(f"{label}: payload differs from the torch.sort passes")


# Launches of (sort_rows, sort_rows_kv, merge_rows, merge_rows_kv) for one
# sort pass at p = 8 with 2^17 or 2^19 keys a processor: one tile sort and
# the merge rounds into 2048, 4096 and 8192; wider merges are rank merges.
KEYS_ONLY = (1, 0, 3, 0)
KEY_VALUE = (0, 1, 0, 3)


def run_multikey(gen, device, timed, n: int = 1 << 22) -> None:
    """Phase 3, the multi-key slice at n = 2^22 (p = 8): packed and LSD
    pairs, keys-only, want="order" and a payload, both decodes. A packed
    keys-only sort runs the keys-only kernels; a packed sort with a
    payload, and each LSD pass, their key/value twins."""
    import torch
    import repro_torch

    ids = torch.randint(0, 1000, (n,), generator=gen, device=device, dtype=torch.int32)
    times = torch.randint(0, 1 << 20, (n,), generator=gen, device=device, dtype=torch.int32)
    pair, orders = (ids, times), ("asc", "desc")
    for i in range(2):
        out = timed(f"packed (ids asc, times desc), keys-only, run {i + 1}", pair, order=orders,
                    expect=KEYS_ONLY)
    if out.meta.multikey != "packed" or out.meta.plan.packspec.total_bits != 30:
        raise AssertionError(f"the ids/times pair did not pack into 30 bits: {out.meta.plan.explain()}")
    check_lex("packed keys-only", out, pair, (False, True))
    out = timed('packed (ids asc, times desc), want="order"', pair, order=orders, want="order",
                expect=KEY_VALUE)
    check_lex("packed order", out, pair, (False, True), want="order")

    f = torch.rand(n, generator=gen, device=device)
    wide = torch.randint(-(1 << 31), (1 << 31) - 1, (n,), generator=gen, device=device,
                         dtype=torch.int32)
    vals = torch.rand(n, generator=gen, device=device)
    out = timed("LSD (float32 asc, int32 full range desc) + float32 payload", (f, wide), vals,
                order=("asc", "desc"), expect=tuple(2 * c for c in KEY_VALUE))
    if out.meta.multikey != "lsd":
        raise AssertionError("the float32/int32 pair did not fall back to LSD")
    check_lex("LSD payload", out, (f, wide), (False, True), values=vals)

    d1 = torch.randint(0, 4, (n,), generator=gen, device=device, dtype=torch.int32)
    d2 = torch.randint(0, 16, (n,), generator=gen, device=device, dtype=torch.int32)
    out = timed("packed, 4 x 16 distinct values", (d1, d2), expect=KEYS_ONLY)
    check_lex("packed duplicates", out, (d1, d2), (False, False))
    if out.meta.multikey != "packed" or not out.imbalance() < 1.01:
        raise AssertionError(f"duplicate-heavy pair: {out.meta.multikey}, imbalance {out.imbalance()}")

    out = timed('packed (ids asc, times desc), want="order", decode="host"', pair, order=orders,
                want="order", limits=repro_torch.SortLimits(decode="host"), expect=KEY_VALUE)
    if out.keys[0].device.type != "cpu":
        raise AssertionError("decode='host' did not return CPU tensors")
    check_lex("packed order, host decode", out, pair, (False, True), want="order")


def check_nan_keys(gen, device, timed, n: int = 1 << 20) -> None:
    """Phase 3: keys-only float32 keys with 5% NaN sort on the card as they
    do on the CPU (the searches follow jax's probes on both)."""
    import torch
    import repro_torch

    x = torch.rand(n, generator=gen, device=device)
    x[torch.rand(x.shape, generator=gen, device=device) < 0.05] = float("nan")
    got = timed("n=2^20 float32, 5% NaN, keys-only", x, expect=KEYS_ONLY)
    t0 = time.perf_counter()
    want = repro_torch.sort(x.cpu(), device="cpu")
    log(f"phase 3: the same sort on the CPU: {(time.perf_counter() - t0) * 1e3:.3f} ms wall")
    if not (torch.equal(got.keys.cpu().view(torch.int32), want.keys.view(torch.int32))
            and (got.counts == want.counts).all()):
        raise AssertionError("NaN keys: the card's sort differs from the CPU's")
    log(f"phase 3: NaN keys: card equals CPU bit for bit ({int(want.keys.isnan().sum())} NaN "
        f"kept of {int(x.isnan().sum())})")


# ------------------------------------------------------------------ phase 5

SERVE_B, SERVE_S, SERVE_NEW = 2, 8192, 16


def run_serve(device) -> dict:
    """Phase 5: qwen3-4b at full width (flash_attention=True, bf16, seeded
    random weights) answers B = 2 prompts of 8192 seeded tokens with 16 new
    tokens each, through ``engine.generate`` (the main path; the flash
    launch count is set to 0 before it and read after it), then again
    through ``make_prefill`` / ``make_serve_step`` with times. The prefill's
    last-position logits are held against the same weights with
    flash_attention=False (``repro``'s other prefill path, plain torch)."""
    import copy
    import dataclasses

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash
    from repro_torch.models.model import Model
    from repro_torch.serve import engine

    cfg = dataclasses.replace(get_config("qwen3-4b"), flash_attention=True, dtype="bfloat16")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device=device, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 5: qwen3-4b built on the card in {time.perf_counter() - t0:.2f} s: "
        f"{n_params} parameters, {torch.cuda.memory_allocated() / 1e9:.3f} GB")
    B, S, n_new, vocab = SERVE_B, SERVE_S, SERVE_NEW, cfg.vocab
    gen = torch.Generator(device=device).manual_seed(3)
    batch = {"tokens": torch.randint(0, vocab, (B, S), generator=gen, device=device,
                                     dtype=torch.int32)}

    flash.flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.generate(model, batch, n_new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = flash.flash_attention.launches
    log(f"phase 5: generate {B} x {S} prompt tokens + {n_new} new: {gen_s * 1e3:.3f} ms wall "
        f"(first call), flash launches {launches}, tokens {out.tolist()}")
    if launches != cfg.n_layers:
        raise AssertionError(f"flash launches {launches} per prefill, want {cfg.n_layers}")
    if out.shape != (B, n_new) or not bool(((out >= 0) & (out < vocab)).all()):
        raise AssertionError(f"generated tokens out of [0, {vocab}) or of shape {out.shape}")

    prefill, step = engine.make_prefill(model), engine.make_serve_step(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = prefill(batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    if flash.flash_attention.launches != 2 * cfg.n_layers:
        raise AssertionError("the timed prefill did not launch the flash kernel once per layer")
    caches = engine.extend_caches(model, caches, S, S + n_new)
    tok = logits[..., :vocab].argmax(-1).to(torch.int32)
    steps, step_ms = [tok], []
    for i in range(n_new - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, caches = step(caches, tok, S + i)
        tok = lg[..., :vocab].argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        steps.append(tok)
    if not torch.equal(torch.cat(steps, dim=1), out):
        raise AssertionError("the timed prefill and steps gave other tokens than generate")
    del caches
    decode_ms = statistics.median(step_ms)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    plain = copy.copy(model)  # the same parameters, read with another config
    plain.cfg = dataclasses.replace(cfg, flash_attention=False)
    before = flash.flash_attention.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref, _ = engine.make_prefill(plain)(batch)
    torch.cuda.synchronize()
    plain_prefill_ms = (time.perf_counter() - t0) * 1e3
    if flash.flash_attention.launches != before:
        raise AssertionError("the flash_attention=False prefill launched the flash kernel")
    got, ref = logits.float(), ref.float()
    diff, scale = float((got - ref).abs().max()), float(ref.abs().max())
    same_first = torch.equal(got[..., :vocab].argmax(-1), ref[..., :vocab].argmax(-1))
    log(f"phase 5: prefill logits vs flash_attention=False: max abs diff {diff:.4f}, "
        f"max |logit| {scale:.4f}, same greedy first token {same_first}")
    if not (torch.isfinite(got).all() and diff <= 5e-2 * scale and same_first):
        raise AssertionError("the flash prefill disagrees with the plain prefill")
    num = dict(prefill_ms=prefill_ms, plain_prefill_ms=plain_prefill_ms,
               decode_ms_per_step=decode_ms, decode_tokens_per_s=B / decode_ms * 1e3,
               generate_ms=gen_s * 1e3, peak_gb=peak_gb, flash_launches=launches)
    log("phase 5: " + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                                for k, v in num.items()))
    return num


# ------------------------------------------------------------------ phase 6

# The span names a traced sort must record (tests/test_obs.py's lists).
SIM_SPANS = ("plan", "encode", "stage", "local_sort", "splitter", "exchange", "merge",
             "decode", "d2h")
STREAM_SPANS = ("plan", "encode", "local_sort", "splitter", "merge")
SLOW_S = 120.0  # a case slower than this runs once, untraced


def run_stream(device) -> dict:
    """Phase 6: the out-of-core stream backend through ``repro_torch.sort``,
    with its input on the host (CPU tensors) and its output there. Each
    case runs once untraced (wall time, launches per kernel, exactness)
    and once with ``SortLimits(trace=True)`` for its split into pass 1
    (``local_sort``), pass 2 (``splitter``) and pass 3 (``merge`` spans);
    returns the launches per kernel summed over the untraced stream runs
    alone (the counts set to 0 just before each and read just after),
    which must include every bitonic kernel; the traced reruns and
    ``check_traces`` are not counted."""
    import dataclasses

    import torch
    import repro_torch
    from repro_torch import stream
    from repro_torch.kernels import bitonic

    gen = torch.Generator(device=device).manual_seed(6)
    base = repro_torch.SortLimits()
    total = {fn.__name__: 0 for fn in bitonic.KERNELS}  # the untraced stream runs'

    def run(label, keys, values=None, limits=base, **kw):
        """(output, trace or None); ``keys`` may be a function that makes
        them (an iterator is used up by one call)."""
        make = keys if callable(keys) else lambda: keys
        bitonic.reset_launches()  # read again right after the call
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = repro_torch.sort(make(), values, device=device, limits=limits, **kw)
        out.keys, out.values  # the stream's passes run here
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in bitonic.KERNELS}
        for k, v in launches.items():
            total[k] += v
        if out.meta.backend != "stream":
            raise AssertionError(f"{label}: ran on {out.meta.backend!r}, not the stream")
        log(f"phase 6: {label}: {wall * 1e3:.3f} ms wall, {len(out.meta.chunk_retries)} chunks, "
            f"retries {out.meta.retries}, launches {launches}")
        tr = None
        if wall <= SLOW_S:
            traced = repro_torch.sort(make(), values, device=device,
                                      limits=dataclasses.replace(limits, trace=True), **kw)
            same = [torch.equal(a.view(torch.uint8), b.view(torch.uint8))  # NaN-safe
                    for a, b in zip(flat(traced), flat(out), strict=True)]
            tr = traced.meta.trace
            tot = tr.phase_totals()
            if not all(same) or [s for s in STREAM_SPANS if s not in tot]:
                raise AssertionError(f"{label}: traced call differs ({same}) or misses spans "
                                     f"({list(tot)})")
            log(f"phase 6: {label}, traced: pass 1 {tot['local_sort'] * 1e3:.3f} ms, pass 2 "
                f"{tot['splitter'] * 1e3:.3f} ms, pass 3 {tot['merge'] * 1e3:.3f} ms "
                f"({sum(s.name == 'merge' for s in tr.spans)} buckets), plan+encode "
                f"{(tot['plan'] + tot['encode']) * 1e3:.3f} ms, coverage {tr.coverage():.4f}")
        return out, tr

    def flat(out):
        keys = out.keys if isinstance(out.keys, tuple) else (out.keys,)
        return (*keys, *(() if out.values is None else (out.values,)))

    def exact(label, ok):
        if not ok:
            raise AssertionError(f"{label}: differs from torch.sort on the card")

    big = torch.rand(1 << 27, generator=gen, device=device)
    ref = torch.sort(big).values.cpu()
    x = big.cpu()
    del big
    out, _ = run("n=2^27 float32 uniform, default limits (chunks of 2^16)", x)
    exact("2^27 default", torch.equal(out.keys, ref))
    out, _ = run("n=2^27 float32, chunk_elems=2^22", x,
              limits=dataclasses.replace(base, chunk_elems=1 << 22))
    exact("2^27 chunk 2^22", torch.equal(out.keys, ref))
    del x, ref, out

    n = 1 << 23
    xd = torch.rand(n, generator=gen, device=device)
    x = xd.cpu()
    out, _ = run('n=2^23 float32 want="order" order="desc"', x, want="order", order="desc")
    perm = torch.sort(xd, descending=True, stable=True).indices.to(torch.int32).cpu()
    exact("2^23 order", torch.equal(out.order(), perm) and torch.equal(out.keys, x[perm.long()]))
    vals = torch.rand(n, generator=gen, device=device)
    out, _ = run("n=2^23 float32 keys + float32 values, desc", x, vals.cpu(), order="desc")
    got_k, got_v = canon_pairs(out.keys.to(device), out.values.to(device))
    want_k, want_v = canon_pairs(xd, vals)
    exact("2^23 payload", torch.equal(got_k, want_k) and torch.equal(got_v, want_v)
          and torch.equal(out.keys, torch.sort(xd, descending=True).values.cpu()))
    del vals

    dup = torch.randint(0, 4, (n,), generator=gen, device=device, dtype=torch.int32)
    out, tr = run("n=2^23 int32, 4 distinct values", dup.cpu())
    exact("2^23 duplicates", torch.equal(out.keys, torch.sort(dup).values.cpu()))
    # the card's buckets against the CPU's partition of the same keys, with
    # and without the investigator: repro's own partition of such keys reads
    # 1.10-1.11 at 128 buckets, above 1.05, and the port's equals it
    # (tests/test_torch_stream.py::test_partition_of_four_values_at_the_smoke_
    # shape_matches_repro), so the card is held to that partition
    split = next(s for s in tr.spans if s.name == "splitter")
    scfg = stream.StreamConfig()
    runs = stream.generate_runs(dup.cpu(), scfg, device="cpu")
    cpu, naive = (stream.partition_runs(runs, scfg, investigator=inv, device="cpu")
                  for inv in (True, False))
    log(f"phase 6: 4 distinct values: bucket imbalance {split.attrs['imbalance']:.6f} over "
        f"{len(split.attrs['per_proc'])} buckets; the CPU's {cpu.load_imbalance():.6f}, "
        f"without the investigator {naive.load_imbalance():.6f}")
    if split.attrs["per_proc"] != cpu.bucket_sizes.tolist():
        raise AssertionError("4 distinct values: the card's buckets differ from the CPU's")
    if not naive.load_imbalance() > 2 * cpu.load_imbalance():
        raise AssertionError("4 distinct values: the investigator did not balance the buckets")

    ids = torch.randint(0, 1000, (n,), generator=gen, device=device, dtype=torch.int32)
    times = torch.randint(0, 1 << 20, (n,), generator=gen, device=device, dtype=torch.int32)
    pair = (ids.cpu(), times.cpu())
    out, _ = run("n=2^23 packed (ids asc, times desc), keys-only", pair, order=("asc", "desc"))
    if out.meta.multikey != "packed":
        raise AssertionError("the ids/times pair did not pack")
    check_lex("stream packed", out, (ids, times), (False, True))
    del ids, times, pair

    it, _ = run("n=2^23 float32 as an iterator of pieces of 300000",
                lambda: iter(torch.split(x, 300_000)))
    arr, _ = run("n=2^23 float32 as one array", x)
    exact("2^23 iterator", torch.equal(it.keys, arr.keys)
          and torch.equal(arr.keys, torch.sort(xd).values.cpu()))

    nan = torch.rand(1 << 21, generator=gen, device=device)
    nan[torch.rand(nan.shape, generator=gen, device=device) < 0.05] = float("nan")
    nan = nan.cpu()
    out, _ = run("n=2^21 float32, 5% NaN, keys-only", nan, where="stream")
    t0 = time.perf_counter()
    want = repro_torch.sort(nan, where="stream", device="cpu", limits=base)
    if not torch.equal(out.keys.view(torch.int32), want.keys.view(torch.int32)):
        raise AssertionError("NaN keys: the card's stream differs from the CPU's")
    log(f"phase 6: NaN keys: card equals CPU bit for bit ({int(want.keys.isnan().sum())} NaN "
        f"kept of {int(nan.isnan().sum())}; the CPU took {time.perf_counter() - t0:.3f} s)")

    log(f"phase 6: launches over the untraced stream runs: {total}")
    missing = [k for k, v in total.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the stream path: {missing}")
    check_traces(device, xd)
    return total


# ------------------------------------------------------------------ phase 7


def run_x64(device) -> dict:
    """Phase 7: x64 mode through ``repro_torch.sort`` with
    ``SortLimits(x64=True)`` (p = 8, tile = 1024), and the result's views.
    The launch counts are set to 0 before it and read after it: each of the
    four bitonic kernels must have launched with 8-byte keys or values
    (``wide_launches``). Returns those 8-byte launches per kernel."""
    import dataclasses

    import numpy as np
    import torch
    import repro_torch
    from repro_torch.core import keyenc
    from repro_torch.kernels import bitonic

    gen = torch.Generator(device=device).manual_seed(7)
    lim = repro_torch.SortLimits(x64=True)
    n = 1 << 22
    i64 = dict(dtype=torch.int64, generator=gen, device=device)

    def timed(label, *args, **kwargs):
        before = {fn.__name__: (fn.launches, fn.wide_launches) for fn in bitonic.KERNELS}
        kwargs.setdefault("limits", lim)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = repro_torch.sort(*args, device=device, **kwargs)
        out.keys  # a stream result materializes here
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {fn.__name__: (fn.launches - before[fn.__name__][0],
                             fn.wide_launches - before[fn.__name__][1]) for fn in bitonic.KERNELS}
        log(f"phase 7: {label}: {wall * 1e3:.3f} ms wall, backend {out.meta.backend}, "
            f"imbalance {out.imbalance():.6f}, retries {out.meta.retries}, launches (all, 8-byte) "
            f"{got}")
        return out

    def exact(label, ok):
        if not ok:
            raise AssertionError(f"phase 7: {label}: differs from torch.sort on the card")

    def same_bits(a, b):
        return a.shape == b.shape and torch.equal(a.view(torch.int64), b.view(torch.int64))

    bitonic.reset_launches()

    big = torch.randint(-(1 << 62), 1 << 62, (1 << 27,), **i64)
    out = timed("n=2^27 int64 (1 GiB), stream_threshold=None", big,
                limits=dataclasses.replace(lim, stream_threshold=None))
    t0 = time.perf_counter()
    ref = torch.sort(big).values
    torch.cuda.synchronize()
    log(f"phase 7: torch.sort of the same keys: {(time.perf_counter() - t0) * 1e3:.3f} ms wall")
    exact("2^27 int64", out.meta.backend == "sim" and torch.equal(out.keys, ref))
    del big, out, ref

    f = torch.randn(n, dtype=torch.float64, generator=gen, device=device) * 1e100
    f[::7], f[::11], f[::65537], f[::65539] = 0.0, -0.0, float("inf"), float("-inf")
    ref = torch.sort(f).values
    asc = timed("n=2^22 float64 with +-0.0 and +-inf, asc", f)
    desc = timed("n=2^22 float64 with +-0.0 and +-inf, desc", f, order="desc")
    exact("float64 asc", torch.equal(asc.keys, ref))
    exact("float64 desc", torch.equal(desc.keys, ref.flip(0)))

    lane = torch.randint(-(1 << 63), (1 << 63) - 1, (n,), **i64)
    u = (lane ^ (-(1 << 63))).view(torch.uint64)
    out = timed("n=2^22 uint64 over the full range", u)
    want = (torch.sort(lane).values ^ (-(1 << 63))).view(torch.uint64)
    exact("uint64", out.keys.dtype == torch.uint64 and same_bits(out.keys, want))

    dup = torch.randint(0, 4, (n,), **i64)
    out = timed("n=2^22 int64, 4 distinct values", dup)
    exact("int64 duplicates", torch.equal(out.keys, torch.sort(dup).values))
    if not out.imbalance() < 1.01:
        raise AssertionError(f"phase 7: imbalance {out.imbalance()} on 4 int64 values")

    keys = torch.randint(-(1 << 62), 1 << 62, (n,), **i64)
    grid = keys.view(8, n // 8)
    order = timed('n=2^22 int64 want="order", a (8, 2^19) grid', grid, want="order")
    perm = torch.sort(keys, stable=True).indices
    exact("int64 order", torch.equal(order.order(), perm.to(torch.int32))
          and torch.equal(order.keys, keys[perm]))

    vals = torch.rand(n, dtype=torch.float64, generator=gen, device=device)
    out = timed("n=2^22 int64 keys + float64 payload", keys, vals)
    got_k, got_v = canon_pairs(out.keys, out.values)
    want_k, want_v = canon_pairs(keys, vals)
    exact("int64 + float64 payload", torch.equal(got_k, want_k) and torch.equal(got_v, want_v))
    del vals, out

    ids = torch.randint(0, 1 << 40, (n,), **i64)
    times = torch.randint(0, 1 << 20, (n,), dtype=torch.int32, generator=gen, device=device)
    for i in range(2):  # the first call of a shape loads its kernels
        out = timed(f"packed (int64 ids in [0, 2^40) asc, int32 times desc), want=order, "
                    f"run {i + 1}", (ids, times), order=("asc", "desc"), want="order")
    spec = out.meta.plan.packspec
    if out.meta.multikey != "packed" or spec.total_bits != 60 or spec.pack_dtype != torch.int64:
        raise AssertionError(f"phase 7: the ids/times pair did not pack into one int64 sort: "
                             f"{out.meta.plan.explain()}")
    check_lex("x64 packed order", out, (ids, times), (False, True), want="order")
    wide = torch.randint(-(1 << 63), (1 << 63) - 1, (n,), **i64)
    full = torch.randint(-(1 << 31), (1 << 31) - 1, (n,), dtype=torch.int32, generator=gen,
                         device=device)
    out = timed("LSD (int64 full range asc, int32 full range asc): 96 bits", (wide, full))
    if out.meta.multikey != "lsd":
        raise AssertionError("phase 7: a tuple over 63 bits did not take the LSD passes")
    check_lex("x64 LSD", out, (wide, full), (False, False))
    del ids, times, wide, full, out

    nan = torch.randn(1 << 21, dtype=torch.float64, generator=gen, device=device)
    nan[torch.rand(nan.shape, generator=gen, device=device) < 0.05] = float("nan")
    got = timed("n=2^21 float64, 5% NaN, keys-only", nan)
    t0 = time.perf_counter()
    want = repro_torch.sort(nan.cpu(), device="cpu", limits=lim)
    if not (same_bits(got.keys.cpu(), want.keys) and (got.counts == want.counts).all()):
        raise AssertionError("phase 7: NaN keys: the card's float64 sort differs from the CPU's")
    log(f"phase 7: NaN keys: card equals CPU bit for bit ({int(want.keys.isnan().sum())} NaN "
        f"kept of {int(nan.isnan().sum())}; the CPU took {time.perf_counter() - t0:.3f} s)")

    host = torch.randint(-(1 << 62), 1 << 62, (1 << 23,), **i64)
    out = timed("n=2^23 int64 streamed from the host, default limits", host.cpu())
    exact("2^23 int64 stream", out.meta.backend == "stream"
          and torch.equal(out.keys, torch.sort(host).values.cpu()))
    del host, out

    # the views on the 2^22 results
    topk = asc.topk(1000)
    exact("topk", topk.device == f.device and torch.equal(topk, torch.topk(f, 1000).values))
    exact("topk smallest", torch.equal(desc.topk(1000, largest=False),
                                       torch.topk(f, 1000, largest=False).values))
    q = f[torch.randint(0, n, (4096,), generator=gen, device=device)]
    q[:6] = torch.tensor([0.0, -0.0, float("nan"), float("inf"), float("-inf"), 1e-300])
    ka, kd, qn = asc.keys.cpu().numpy(), desc.keys.cpu().numpy(), q.cpu().numpy()
    for side, other in (("left", "right"), ("right", "left")):
        got_a, got_d = asc.searchsorted(q, side), desc.searchsorted(q, side)
        want_a = np.searchsorted(ka, qn, side=side)
        want_d = n - np.searchsorted(kd[::-1], qn, side=other)
        if got_a.device != f.device or not (np.array_equal(got_a.cpu().numpy(), want_a)
                                            and np.array_equal(got_d.cpu().numpy(), want_d)):
            raise AssertionError(f"phase 7: searchsorted side={side} differs from numpy's")
    proc, idx = order.provenance()
    o = order.order().cpu().numpy()
    if not (np.array_equal(proc.cpu().numpy(), o // (n // 8))
            and np.array_equal(idx.cpu().numpy(), o % (n // 8))):
        raise AssertionError("phase 7: provenance() differs from the numpy decode of order()")
    log("phase 7: views: topk = torch.topk, searchsorted of 4096 queries (ties, +-0.0, NaN, "
        "+-inf) = np.searchsorted in both orders and sides, provenance() of the (8, 2^19) "
        "grid = the numpy decode of order(), all on the card")
    del f, asc, desc, order

    # past PROVENANCE_INT32_CAP the argsort's index is int64: the cap is
    # lowered here to reach that on a 2^22 sort (the int64-value kv kernels)
    cap = keyenc.PROVENANCE_INT32_CAP
    keyenc.PROVENANCE_INT32_CAP = 1 << 20
    try:
        out = timed("n=2^22 int64 want=order, provenance cap lowered to 2^20", keys, want="order")
    finally:
        keyenc.PROVENANCE_INT32_CAP = cap
    exact("int64 provenance", out.order().dtype == torch.int64 and torch.equal(out.order(), perm))

    launches = {fn.__name__: fn.launches for fn in bitonic.KERNELS}
    wide = {fn.__name__: fn.wide_launches for fn in bitonic.KERNELS}
    log(f"phase 7: launches over the x64 phase: {launches}; with 8-byte keys or values: {wide}")
    missing = [k for k, v in wide.items() if v == 0]
    if missing:
        raise AssertionError(f"phase 7: kernels never launched at 8 bytes: {missing}")
    return wide


# ------------------------------------------------------------------ phase 8


def device_ms(fn) -> tuple[float, float]:
    """(wall ms, device ms) of one ``fn()`` under ``torch.profiler``: the
    wall on the host clock, synchronised; device time the sum of the
    device-side events (kernels and copies)."""
    wall, dev, _ = device_breakdown(fn)
    return wall, dev


def device_breakdown(fn, nodes: bool = False) -> tuple:
    """``device_ms`` and the device-side events by name, largest first:
    [(name, ms), ...]. With ``nodes``, a fourth item: the backward's
    autograd nodes by the device time of the kernels they launched,
    largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3

    def dev_us(e) -> float:  # renamed from self_cuda_time_total in newer torch
        v = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if v is None else v

    events = sorted(((e.key, dev_us(e) / 1e3) for e in prof.key_averages()
                     if str(e.device_type).endswith("CUDA") and dev_us(e) > 0),
                    key=lambda kv: -kv[1])
    dev = sum(ms for _, ms in events)
    if dev == 0:
        raise AssertionError("the profiler recorded no device time")
    if not nodes:
        return wall, dev, events

    def total_us(e) -> float:  # renamed from cuda_time_total in newer torch
        v = getattr(e, "device_time_total", None)
        return e.cuda_time_total if v is None else v

    node = "autograd::engine::evaluate_function: "
    backward = sorted(((e.key[len(node):], total_us(e) / 1e3) for e in prof.key_averages()
                       if e.key.startswith(node) and total_us(e) > 0), key=lambda kv: -kv[1])
    return wall, dev, events, backward


def schema_shape_ok(label: str, got: dict, path: pathlib.Path) -> None:
    """``got`` (a shape description, as the repo's schema checkers build
    it) equals the pinned file's."""
    want = json.loads(path.read_text())
    bad = {k: (want.get(k), got.get(k)) for k in set(want) | set(got) if want.get(k) != got.get(k)}
    if bad:
        raise AssertionError(f"phase 8: {label} drifted from {path.name}: {bad}")


def run_serving(device) -> dict:
    """Phase 8: the serve tier on the card. The launch counts are set to 0
    just before each run and read just after it. The serving runs (the
    invariance flushes, the ``SortServer`` burst, the ``QueueFullError``
    burst) are summed, and each of the four bitonic kernels must launch in
    them; the other runs (single calls, the NaN flush, tune, the ladder)
    print theirs on their own lines. Returns the serving runs' launches
    per kernel."""
    import contextlib
    import os
    import shutil
    import threading

    import numpy as np
    import torch
    import repro_torch
    from repro_torch import tune
    from repro_torch.kernels import bitonic
    from repro_torch.obs import flight, slo
    from repro_torch.serve import sortd
    from repro_torch.stream.service import SortService

    gen = torch.Generator(device=device).manual_seed(8)
    serving = {fn.__name__: 0 for fn in bitonic.KERNELS}  # the serving runs' sum

    def take(serve: bool = False) -> dict:
        """The counts since the last reset, set to 0 again; a serving run's
        are added to ``serving``."""
        got = {fn.__name__: fn.launches for fn in bitonic.KERNELS}
        bitonic.reset_launches()
        if serve:
            for k, v in got.items():
                serving[k] += v
        return got

    t_phase = time.perf_counter()
    scratch = ROOT / "build" / "phase8"  # files of this phase, removed at its end
    shutil.rmtree(scratch, ignore_errors=True)
    scratch.mkdir(parents=True)

    # launch invariance: one bucket (float32, p = 8, per = 2^13), B = 1, 4, 16
    svc = SortService(n_procs=8, device=device)
    per_b = {}
    for b in (1, 4, 16):
        xs = [torch.rand(1 << 16, generator=gen, device=device).cpu() for _ in range(b)]
        torch.cuda.synchronize()
        bitonic.reset_launches()
        t0 = time.perf_counter()
        outs = svc.sort_many(xs)
        wall = (time.perf_counter() - t0) * 1e3
        per_b[b] = take(serve=True)
        for x, out in zip(xs, outs):
            if not torch.equal(out, torch.sort(x.to(device)).values.cpu()):
                raise AssertionError(f"phase 8: a flush of B={b} differs from torch.sort")
        log(f"phase 8: SortService flush of B={b} x 2^16 float32 (p=8, per=2^13): "
            f"{wall:.3f} ms wall, launches {per_b[b]}")
    if len({tuple(v.values()) for v in per_b.values()}) != 1:
        raise AssertionError(f"phase 8: launches grow with the batch: {per_b}")
    if not (per_b[1]["bitonic_sort_rows"] and per_b[1]["bitonic_merge_rows"]):
        raise AssertionError(f"phase 8: a flush launched no bitonic kernel: {per_b[1]}")
    log(f"phase 8: program cache {svc.stats}")

    # mixed traffic through SortServer: two tenants (one floods at 4x),
    # four submitting threads, keys-only (25% descending), packed pairs,
    # argsorts and payloads, one 2^23 host stream request, 16 each of
    # topk / searchsorted / percentile
    flight.RECORDER.reset()
    rng = np.random.default_rng(8)
    specs = []
    for i in range(256 - 48 - 1 - 32 - 16):
        n = int(2 ** rng.uniform(10, 16))
        specs.append(("keys", n, "desc" if rng.random() < 0.25 else "asc"))
    specs += [("pair", int(2 ** rng.uniform(10, 16)), None) for _ in range(16)]
    specs += [("order", int(2 ** rng.uniform(10, 16)), None) for _ in range(16)]
    specs += [("payload", int(2 ** rng.uniform(10, 16)), None) for _ in range(16)]
    specs += [(kind, int(2 ** rng.uniform(10, 16)), None)
              for kind in ("topk", "searchsorted", "percentile") for _ in range(16)]
    specs.append(("stream", 1 << 23, None))
    rng.shuffle(specs)
    pair_limits = repro_torch.SortLimits(key_bits=(10, 20))
    queries = np.array([-1.0, 0.0, 0.25, 0.5, 0.75, 1.0, 2.0], np.float32)
    pct = np.array([0.0, 1.0, 50.0, 99.0, 100.0])
    lat = {"flood": [], "light": []}
    errors, lock = [], threading.Lock()

    def check(kind, n, order, inputs, out):
        x = inputs[0]
        xd = torch.from_numpy(x).to(device) if isinstance(x, np.ndarray) else None
        if kind in ("keys", "stream"):
            want = torch.sort(xd).values
            want = want.flip(0) if order == "desc" else want
            return torch.equal(out.keys.cpu(), want.cpu())
        if kind == "pair":
            cols = [torch.from_numpy(c).to(device) for c in x]
            perm = lex_order(cols, (False, True))
            return all(torch.equal(g.cpu(), c[perm].cpu()) for g, c in zip(out.keys, cols))
        if kind == "order":
            want = torch.sort(xd, stable=True).indices.to(torch.int32)
            return torch.equal(out.order().cpu(), want.cpu())
        if kind == "payload":
            gk, gv = canon_pairs(out.keys.to(device), out.values.to(device))
            wk, wv = canon_pairs(xd, torch.from_numpy(inputs[1]).to(device))
            return torch.equal(gk, wk) and torch.equal(gv, wv)
        srt = np.sort(x)
        if kind == "topk":
            return torch.equal(out.keys.cpu(), torch.topk(xd, 9).values.cpu())
        if kind == "searchsorted":
            return np.array_equal(out.keys.cpu().numpy(), np.searchsorted(srt, queries))
        return np.array_equal(out.keys.cpu().numpy(), np.percentile(srt, pct))

    def client(part):
        local = np.random.default_rng(100 + part)
        for kind, n, order in part_specs[part]:
            tenant = "flood" if local.random() < 0.8 else "light"
            if kind == "pair":
                x = (local.integers(0, 1 << 10, n).astype(np.int32),
                     local.integers(0, 1 << 20, n).astype(np.int32))
            else:
                x = local.random(n, dtype=np.float32)
            inputs = (x, local.integers(-1000, 1000, n).astype(np.int32))
            t_sub = time.perf_counter()
            if kind in ("keys", "stream"):
                fut = srv.submit(x, order=order or "asc", tenant=tenant)
            elif kind == "pair":
                fut = srv.submit(x, order=("asc", "desc"), limits=pair_limits, tenant=tenant)
            elif kind == "order":
                fut = srv.submit(x, want="order", tenant=tenant)
            elif kind == "payload":
                fut = srv.submit(x, inputs[1], tenant=tenant)
            elif kind == "topk":
                fut = srv.submit_topk(x, 9, tenant=tenant)
            elif kind == "searchsorted":
                fut = srv.submit_searchsorted(x, queries, tenant=tenant)
            else:
                fut = srv.submit_percentile(x, pct, tenant=tenant)
            fut.add_done_callback(
                lambda _f, t=tenant, t0=t_sub: lat[t].append((time.perf_counter() - t0) * 1e3))
            pending.append((kind, n, order, inputs, fut, tenant))

    part_specs = [specs[i::4] for i in range(4)]
    pending = []
    slo_cfg = slo.SLOConfig(name="phase8", threshold_ms=50.0)
    outs = []
    bitonic.reset_launches()
    t0 = time.perf_counter()
    with sortd.SortServer(max_batch=16, max_delay_ms=2, device=device, slo=slo_cfg,
                          tenants={"flood": 1.0, "light": 1.0}) as srv:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
            if th.is_alive():
                raise AssertionError("phase 8: a submitting thread did not finish")
        for kind, n, order, inputs, fut, tenant in pending:
            try:
                outs.append(fut.result(timeout=300))
            except Exception as e:  # noqa: BLE001 — every failed future fails the run
                outs.append(None)
                errors.append(f"{kind} n={n}: {e!r}")
        stats = srv.stats()
    wall = (time.perf_counter() - t0) * 1e3
    srv_launch = take(serve=True)
    for (kind, n, order, inputs, _fut, _ten), out in zip(pending, outs):
        if out is not None and not check(kind, n, order, inputs, out):
            errors.append(f"{kind} n={n} order={order}: differs from its reference")
    if errors:
        raise AssertionError(f"phase 8: {len(errors)} of {len(pending)} requests failed: "
                             f"{errors[:5]}")
    served = {}
    for kind, *_ in pending:
        served[kind] = served.get(kind, 0) + 1
    log(f"phase 8: SortServer, {len(pending)} requests from 4 threads ({served}), all exact, "
        f"{wall:.3f} ms wall (submit to close), launches {srv_launch}")
    log("phase 8: stats: " + ", ".join(
        f"{k} {stats[k]}" for k in ("latency_ms_p50", "latency_ms_p99", "occupancy_mean",
                                    "flushes", "flushed_requests", "direct_dispatches",
                                    "programs", "hits", "retries")))
    log(f"phase 8: slo {stats['slo']}")
    for ten, ms in lat.items():  # submit to resolve, seen by the clients; printed only
        log(f"phase 8: tenant {ten}: {len(ms)} requests, p50 {float(np.percentile(ms, 50)):.3f}"
            f" ms, p99 {float(np.percentile(ms, 99)):.3f} ms")
    snap = flight.RECORDER.snapshot()
    ids = {q["trace_id"] for q in snap["requests"]}
    for f in snap["flushes"]:
        if not f["requests"] or not set(f["requests"]) <= ids:
            raise AssertionError(f"phase 8: flush {f['flush_id']} links to unrecorded requests")
    log(f"phase 8: flight recorder: {len(snap['flushes'])} flushes, each linked to its "
        f"{sum(len(f['requests']) for f in snap['flushes'])} requests")

    # coalescing against single calls: 16 x 2^14 float32
    xs = [torch.rand(1 << 14, generator=gen, device=device).cpu() for _ in range(16)]
    svc.sort_many(xs)
    for x in xs[:2]:
        repro_torch.sort(x, device=device).keys
    bitonic.reset_launches()
    f_wall, f_dev = device_ms(lambda: svc.sort_many(xs))
    f_launch = take()
    s_wall, s_dev = device_ms(lambda: [repro_torch.sort(x, device=device).keys for x in xs])
    s_launch = take()
    log(f"phase 8: 16 x 2^14 float32 as one flush: {f_wall:.3f} ms wall, {f_dev:.3f} ms device, "
        f"launches {f_launch}; as 16 sort calls: {s_wall:.3f} ms wall, {s_dev:.3f} ms device, "
        f"launches {s_launch}")
    # what one NaN costs the requests coalesced with it: the whole flush
    # takes the NaN-safe searches
    xs_nan = [x.clone() for x in xs]
    xs_nan[0][123] = float("nan")
    bitonic.reset_launches()
    nan_outs = []
    q_wall, q_dev = device_ms(lambda: nan_outs.extend(svc.sort_many(xs_nan)))
    q_launch = take()
    # NaN keys take repro's bits, which torch.sort does not give: the NaN
    # member is held to the same flush on the CPU, bit for bit, as phase 7
    # holds NaN sorts; the others to torch.sort as well
    on_cpu = SortService(n_procs=8, device="cpu").sort_many(xs_nan)
    for i, (x, out, ref) in enumerate(zip(xs_nan, nan_outs, on_cpu)):
        if not torch.equal(out.view(torch.int32), ref.view(torch.int32)) or (
                i > 0 and not torch.equal(out, torch.sort(x.to(device)).values.cpu())):
            raise AssertionError(f"phase 8: member {i} of the NaN flush is not exact")
    log(f"phase 8: 16 x 2^14 float32 as one flush, one member with one NaN: {q_wall:.3f} ms "
        f"wall, {q_dev:.3f} ms device, launches {q_launch} (all 16 equal the flush on the "
        f"CPU, the 15 NaN-free also torch.sort)")
    # what the power-of-two batch padding costs: 9 requests run as 16
    n_wall, n_dev = device_ms(lambda: svc.sort_many(xs[:9]))
    e_wall, e_dev = device_ms(lambda: svc.sort_many(xs[:8]))
    log(f"phase 8: batch padding: 9 x 2^14 (padded to 16): {n_wall:.3f} ms wall, {n_dev:.3f} ms "
        f"device; 8 x 2^14 (no padding): {e_wall:.3f} ms wall, {e_dev:.3f} ms device")

    # the cost model, warmed on the card (a cold store; no BENCH_*.json)
    bitonic.reset_launches()
    t0 = time.perf_counter()
    with tune.active(tune.TuneStore()) as tuner:
        def warm_round():
            for e in range(14, 23, 2):
                x = torch.rand(1 << e, generator=gen, device=device)
                repro_torch.sort(x, where="sim", device=device).keys
            for e in range(20, 24):
                x = torch.rand(1 << e, generator=gen, device=device).cpu()
                repro_torch.sort(x, where="stream", device=device).keys

        big = torch.rand(1 << 23, generator=gen, device=device).cpu()
        for rounds in range(1, 6):
            warm_round()
            _, preds = tuner.model.choose("sort", ("sim", "stream"), "float32", 1 << 23)
            if all(p is not None and p.confidence >= tuner.min_confidence
                   for p in preds.values()):
                break
        plan = repro_torch.plan(big, device=device)
        log(f"phase 8: tune: {tuner.store.total_count} observations in {rounds} rounds "
            f"({(time.perf_counter() - t0) * 1e3:.3f} ms wall, launches {take()}); plan "
            f"of 2^23 float32: backend {plan.backend}, cost_source {plan.cost_source}, "
            + ", ".join(f"{b} predicted {d['us']:.1f} us (confidence {d['confidence']:.2f})"
                        for b, d in sorted((plan.cost_predicted or {}).items())))
        if plan.cost_source != "model":
            raise AssertionError(f"phase 8: the warmed plan's cost_source is "
                                 f"{plan.cost_source!r}")
        torch.cuda.synchronize()
        bitonic.reset_launches()
        t0 = time.perf_counter()
        out = repro_torch.sort(big, device=device)
        out.keys
        torch.cuda.synchronize()
        log(f"phase 8: tune: the 2^23 sort ran on {out.meta.backend} in "
            f"{(time.perf_counter() - t0) * 1e3:.3f} ms wall, launches {take()}")
        if not torch.equal(out.keys.cpu(), torch.sort(big.to(device)).values.cpu()):
            raise AssertionError("phase 8: the tuned 2^23 sort is not exact")
        x = torch.rand(1 << 20, generator=gen, device=device).cpu()
        bitonic.reset_launches()
        t0 = time.perf_counter()
        for chunk in (1 << 15, 1 << 16, 1 << 17):
            for _ in range(3):
                repro_torch.sort(x, where="stream", device=device,
                                 limits=repro_torch.SortLimits(chunk_elems=chunk)).keys
        splan = repro_torch.plan(big, where="stream", device=device)
        log(f"phase 8: tune: 9 streams of 2^20 at 3 chunk sizes, "
            f"{(time.perf_counter() - t0) * 1e3:.3f} ms wall, launches {take()}; "
            f"_pick_chunk_elems after chunk-sort observations: "
            f"{splan.chunk_elems} ({[r for r in splan.reasons if 'chunk' in r] or 'static'})")
        path = tuner.save(str(scratch / "tune.json"))
        back = tune.TuneStore.load(path)
        if back.to_json() != tuner.store.to_json():
            raise AssertionError("phase 8: the saved tune store does not load back equal")
        one = tune.TuneStore()
        one.observe("sort", "sim", "float32", 4096, 100.0)
        doc = one.to_json()
        (key, bins), = doc["keys"].items()
        (_, fields), = bins.items()
        schema_shape_ok("the tune store", {
            "schema_version": doc["schema"], "cost_model_version": tune.COST_MODEL_VERSION,
            "top_level_fields": sorted(doc), "key_separator": "|",
            "key_parts": ["op", "backend", "dtype"], "canonical_key": key,
            "bin_fields": sorted(fields), "bins_per_octave": tune.store.BINS_PER_OCTAVE,
        }, ROOT / "tests" / "tune_schema.json")
        if sorted(back.to_json()) != sorted(doc) or any(
                sorted(c) != sorted(fields) for b in back.keys.values() for c in b.values()):
            raise AssertionError("phase 8: the card's store is not in the pinned shape")
        log(f"phase 8: tune: store saved, loaded back equal, in tests/tune_schema.json's shape "
            f"({len(back)} bins)")

    # the measured ladder start: 4 distinct int32 values, capacity_factor 0.25
    dup = torch.randint(0, 4, (1 << 22,), generator=gen, device=device, dtype=torch.int32)
    cfg = repro_torch.SortConfig(capacity_factor=0.25)
    ref = torch.sort(dup).values
    walls = []
    for tuner in (None, tune.TuneStore()):
        torch.cuda.synchronize()
        bitonic.reset_launches()
        t0 = time.perf_counter()
        with tune.active(tuner) if tuner is not None else contextlib.nullcontext():
            out = repro_torch.sort(dup, config=cfg, device=device)
        torch.cuda.synchronize()
        walls.append(((time.perf_counter() - t0) * 1e3, take(), out))
    (p_ms, p_launch, plain), (t_ms, t_launch, tuned) = walls
    if not (torch.equal(plain.keys, ref) and torch.equal(tuned.keys, ref)):
        raise AssertionError("phase 8: a laddered sort is not exact")
    log(f"phase 8: ladder at capacity_factor 0.25: {plain.meta.retries} retries without a "
        f"tuner (to {plain.meta.config.capacity_factor}; {p_ms:.3f} ms wall, launches "
        f"{p_launch}), {tuned.meta.retries} with one (to "
        f"{tuned.meta.config.capacity_factor:.6f}; {t_ms:.3f} ms wall, launches {t_launch})")
    if plain.meta.retries < 2 or tuned.meta.retries != 1:
        raise AssertionError("phase 8: the measured ladder start did not take 1 retry")

    # a QueueFullError burst: the incident snapshot, its schema, obsctl
    d = str(scratch / "flight")
    t0 = time.perf_counter()
    os.environ["REPRO_FLIGHT_DIR"] = d
    try:
        flight.RECORDER.reset()
        x = np.random.default_rng(9).random(1024, dtype=np.float32)
        bitonic.reset_launches()
        with sortd.SortServer(max_queue=1, max_batch=10_000, max_delay_ms=600_000,
                              device=device) as srv:
            for kw in ({}, {}, {"want": "order"}):  # fill the rings first
                fut = srv.submit(x, **kw)
                srv.flush(timeout=60)
                fut.result(0)
            srv.submit(x)
            rejected = 0
            for _ in range(flight.RECORDER.burst_threshold):
                try:
                    srv.submit(x)
                except sortd.QueueFullError:
                    rejected += 1
            srv.flush(timeout=60)
        burst_launch = take(serve=True)
    finally:
        del os.environ["REPRO_FLIGHT_DIR"]
    files = sorted(pathlib.Path(d).glob("incident_queue_full_burst_*.json"))
    if rejected != flight.RECORDER.burst_threshold or not files:
        raise AssertionError(f"phase 8: {rejected} rejections, incident files {files}")
    snap = json.loads(files[-1].read_text())
    filled = {k for k in ("requests", "flushes", "traces", "predictions") if snap[k]}
    want = json.loads((ROOT / "tests" / "flight_schema.json").read_text())
    if (sorted(snap) != want["top_level_fields"] or snap["kind"] not in want["anomaly_kinds"]
            or any(sorted(q) != want["request_fields"] for q in snap["requests"])
            or any(sorted(f) != want["flush_fields"] for f in snap["flushes"])
            or snap["schema"] != want["schema_version"]):
        raise AssertionError("phase 8: the incident snapshot is not in the pinned shape")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for cmd in (["slow", d], ["export", str(files[-1]), "--out",
                              os.path.join(d, "trace.json")]):
        rc = subprocess.run([sys.executable, "-m", "repro_torch.obsctl", *cmd], env=env,
                            capture_output=True, text=True, timeout=120)
        if rc.returncode != 0:
            raise AssertionError(f"phase 8: obsctl {cmd[0]} failed: {rc.stderr[-2000:]}")
    log(f"phase 8: QueueFullError burst ({(time.perf_counter() - t0) * 1e3:.3f} ms wall, "
        f"launches {burst_launch}): {rejected} rejections, incident "
        f"{files[-1].name} ({sorted(filled)} filled) in tests/flight_schema.json's shape; "
        f"obsctl slow and export read it with rc 0")

    shutil.rmtree(scratch, ignore_errors=True)
    log(f"phase 8: launches over the serving runs (invariance flushes, SortServer burst, "
        f"QueueFullError burst): {serving}; {time.perf_counter() - t_phase:.1f} s")
    missing = [k for k, v in serving.items() if v == 0]
    if missing:
        raise AssertionError(f"phase 8: kernels never launched on the serving path: {missing}")
    return serving


def check_traces(device, x) -> None:
    """Phase 6: SortLimits(trace=True) on a 2^22 sim sort and a 2^23 stream
    sort on the card: the spans of tests/test_obs.py, coverage >= 0.95
    (repro's gate), the same output as the untraced call."""
    import torch
    import repro_torch

    for label, keys, where, names in (("2^22 sim", x[: 1 << 22], "sim", SIM_SPANS),
                                      ("2^23 stream", x.cpu(), "stream", STREAM_SPANS)):
        plain = repro_torch.sort(keys, where=where, device=device)
        plain.keys
        traced = repro_torch.sort(keys, where=where, device=device,
                                  limits=repro_torch.SortLimits(trace=True))
        traced.keys
        tr = traced.meta.trace
        spans = [s.name for s in tr.spans]
        log(f"phase 6: traced {label}: coverage {tr.coverage():.4f}, phases (ms) "
            + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in tr.phase_totals().items()))
        if [s for s in names if s not in spans] or not tr.coverage() >= 0.95:
            raise AssertionError(f"traced {label}: spans {sorted(set(spans))}, coverage "
                                 f"{tr.coverage()}")
        if not torch.equal(plain.keys, traced.keys):
            raise AssertionError(f"traced {label}: output differs from the untraced call")


# ------------------------------------------------------------------ phase 9

MESH_WORLD = 4
MESH_PER_RANK = 1 << 22
MESH_DUPLICATES = ("int32, 4 distinct values", "int64, 4 values, x64")  # imbalance < 1.01


def mesh_cases(gen, device, n: int = MESH_WORLD * MESH_PER_RANK) -> dict:
    """Phase 9's four-rank cases: the global keys (and payload) made on the
    card from ``gen``, which every rank and the parent seed alike, and the
    call's keywords."""
    import torch
    import repro_torch

    x = torch.rand(n, generator=gen, device=device)
    four = torch.randint(0, 4, (n,), generator=gen, device=device, dtype=torch.int32)
    vals = torch.rand(n, generator=gen, device=device)
    nan = torch.rand(1 << 21, generator=gen, device=device) * 2 - 1
    nan[torch.rand(1 << 21, generator=gen, device=device) < 0.05] = float("nan")
    wide = torch.randint(0, 4, (n,), generator=gen, device=device, dtype=torch.int64) << 40
    return {
        "float32 uniform": (x, None, {}),
        "int32, 4 distinct values": (four, None, {}),
        'want="order" descending': (x, None, {"want": "order", "order": "desc"}),
        "float32 payload descending": (x, vals, {"order": "desc"}),
        "keys-only descending": (x, None, {"order": "desc"}),
        "2^21 float32, 5% NaN": (nan, None, {}),
        "int64, 4 values, x64": (wide, None, {"limits": repro_torch.SortLimits(x64=True)}),
        "traced keys-only": (x, None, {"limits": repro_torch.SortLimits(trace=True)}),
    }


# phase 9's tuple cases (imbalance < 1.01 for each)
MESH_MK = ("packed pair (4 values x 2^16), keys-only", 'packed pair, want="order"',
           "LSD pair (4 values asc, float32 desc) + float32 payload",
           "int64 pair in 63 bits, x64")


def mesh_mk_cases(gen, device, n: int = MESH_WORLD * MESH_PER_RANK) -> dict:
    """Phase 9's four-rank tuple cases: label -> (global key columns, payload
    or None, the call's keywords), made on the card from ``gen``."""
    import torch
    import repro_torch

    four = torch.randint(0, 4, (n,), generator=gen, device=device, dtype=torch.int32)
    low = torch.randint(0, 1 << 16, (n,), generator=gen, device=device, dtype=torch.int32)
    f = torch.randn(n, generator=gen, device=device)
    vals = torch.rand(n, generator=gen, device=device)
    ids = torch.randint(0, 1 << 40, (n,), generator=gen, device=device, dtype=torch.int64)
    times = torch.randint(0, 1 << 16, (n,), generator=gen, device=device, dtype=torch.int64)
    return {
        MESH_MK[0]: ((four, low), None, {}),
        MESH_MK[1]: ((four, low), None, {"want": "order"}),
        MESH_MK[2]: ((four, f), vals, {"order": ("asc", "desc")}),
        MESH_MK[3]: ((ids, times), None, {"order": ("desc", "asc"),
                                          "limits": repro_torch.SortLimits(x64=True)}),
    }


def np_lex_order(cols, descending):
    """``np.lexsort`` of key columns (CPU tensors of ints or NaN-free
    floats), primary key first, with per-key orders: the CPU's stable
    lexicographic permutation."""
    import numpy as np

    keys = [c.numpy() for c in cols]
    keys = [(-k if k.dtype.kind == "f" else ~k) if d else k for k, d in zip(keys, descending)]
    return np.lexsort(keys[::-1])


def check_mesh_tuple(label, blocks, cols, values, kw) -> None:
    """A tuple sort over the mesh, its blocks concatenated (``blocks``: the
    key columns, and the order or payload or None), against the CPU's
    lexsort of the global columns, bit for bit."""
    import torch

    orders = kw.get("order", "asc")
    orders = orders if isinstance(orders, tuple) else (orders,) * len(cols)
    cpu = [c.cpu() for c in cols]
    perm = torch.from_numpy(np_lex_order(cpu, [o == "desc" for o in orders]))
    keys, vals = blocks
    for j, (got, col) in enumerate(zip(keys, cpu, strict=True)):
        if not torch.equal(got, col[perm]):
            raise AssertionError(f"phase 9: {label}: key column {j} differs from np.lexsort")
    if kw.get("want") == "order" and not torch.equal(vals.long(), perm):
        raise AssertionError(f"phase 9: {label}: the order differs from np.lexsort")
    if values is not None and not torch.equal(vals, values.cpu()[perm]):
        raise AssertionError(f"phase 9: {label}: the payload differs from np.lexsort's")


def shard_of(x, p: int, r: int):
    """Row r of ``planner.pad_grid``'s split of ``x`` over p rows."""
    base, extra = divmod(x.shape[0], p)
    start = r * base + min(r, extra)
    return x[start:start + base + (1 if r < extra else 0)]


def exchange_share(trace) -> float | None:
    """The exchange span's share of a traced sort's wall window."""
    tot = trace.phase_totals()
    return tot["exchange"] / trace.duration() if "exchange" in tot else None


def mesh_rank(rank: int, world: int, out_dir: str) -> None:
    """One of phase 9's ranks (``--mesh-rank``): a gloo group through a
    file store, every tensor on cuda:0, each case sorted through
    ``repro_torch.sort(x_local, where=(mesh, "data"))``; its block, the
    global counts, its launches and rank 0's wall between barriers go to
    ``rank<r>.pt``."""
    import dataclasses
    import datetime

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    from repro_torch.kernels import bitonic

    torch.cuda.set_device(0)
    device = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    mesh = DeviceMesh("cuda", torch.arange(world), mesh_dim_names=("data",))
    gen = torch.Generator(device=device).manual_seed(9)
    results = {}
    for label, (x, vals, kw) in mesh_cases(gen, device).items():
        keys = shard_of(x, world, rank)
        values = None if vals is None else shard_of(vals, world, rank)
        repro_torch.sort(keys, values, where=(mesh, "data"), **kw)  # warm
        torch.cuda.synchronize()
        dist.barrier()
        bitonic.reset_launches()
        t0 = time.perf_counter()
        out = repro_torch.sort(keys, values, where=(mesh, "data"), **kw)
        torch.cuda.synchronize()
        dist.barrier()
        wall = time.perf_counter() - t0
        tr = out.meta.trace
        results[label] = dict(
            keys=out.keys.cpu(), values=None if out.values is None else out.values.cpu(),
            counts=out.counts, send_counts=out.send_counts, block=tuple(out.block),
            retries=out.meta.retries, wall_ms=wall * 1e3, imbalance=out.imbalance(),
            launches={fn.__name__: fn.launches for fn in bitonic.KERNELS},
            coverage=None if tr is None else tr.coverage(),
            exchange=None if tr is None else exchange_share(tr),
            reasons=out.meta.plan.reasons)
        if tr is None and "want" not in kw and vals is None:
            # the same call traced, for the exchange span's share
            limits = dataclasses.replace(kw.get("limits", repro_torch.SortLimits()), trace=True)
            traced = repro_torch.sort(keys, where=(mesh, "data"), **{**kw, "limits": limits})
            results[label]["exchange"] = exchange_share(traced.meta.trace)
    # the tuples: packed (keys-only, argsort, 63 bits) and LSD with a payload
    gen = torch.Generator(device=device).manual_seed(10)
    tuples = {}
    for label, (cols, vals, kw) in mesh_mk_cases(gen, device).items():
        keys = tuple(shard_of(c, world, rank) for c in cols)
        values = None if vals is None else shard_of(vals, world, rank)
        repro_torch.sort(keys, values, where=(mesh, "data"), **kw)  # warm
        torch.cuda.synchronize()
        dist.barrier()
        bitonic.reset_launches()
        t0 = time.perf_counter()
        out = repro_torch.sort(keys, values, where=(mesh, "data"), **kw)
        torch.cuda.synchronize()
        dist.barrier()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in bitonic.KERNELS}
        exchanges = out.meta.exchanges
        limits = dataclasses.replace(kw.get("limits", repro_torch.SortLimits()), trace=True)
        traced = repro_torch.sort(keys, values, where=(mesh, "data"), **{**kw, "limits": limits})
        tuples[label] = dict(
            keys=[c.cpu() for c in out.keys],
            values=None if out.values is None else out.values.cpu(), counts=out.counts,
            block=tuple(out.block), retries=out.meta.retries, wall_ms=wall * 1e3,
            imbalance=out.imbalance(), launches=launches, exchanges=exchanges,
            multikey=out.meta.multikey, exchange=exchange_share(traced.meta.trace))
    results["tuples"] = tuples
    torch.save(results, pathlib.Path(out_dir) / f"rank{rank}.pt")
    dist.destroy_process_group()


def run_ranks(scratch: pathlib.Path, phase: int, **env_extra) -> list:
    """Start MESH_WORLD processes of this script (``--mesh-rank r``), one
    rank each of a gloo group through a file store in ``scratch``, with
    ``env_extra`` in their environment, wait for them (killed past 600
    s), and return each rank's ``rank<r>.pt``."""
    import torch

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **env_extra)
    logs = [open(scratch / f"rank{r}.log", "w") for r in range(MESH_WORLD)]
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank",
                               str(r), "--mesh-dir", str(scratch), "--mesh-phase", str(phase)],
                              env=env, stdout=f, stderr=subprocess.STDOUT)
             for r, f in enumerate(logs)]
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.wait(timeout=max(1.0, 600 - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(f"phase {phase}: mesh ranks failed:\n" + "\n".join(
            (scratch / f"rank{r}.log").read_text()[-3000:] for r in bad))
    return [torch.load(scratch / f"rank{r}.pt", weights_only=False) for r in range(MESH_WORLD)]


def run_mesh(device) -> dict:
    """Phase 9: the mesh backend. A one-rank NCCL group in this process,
    then four ranks in four processes sharing the card through gloo; each
    result held to the port's sim over the same global grid on the card
    and to torch.sort (NaN: the sim on the CPU). Returns the launches of
    every kernel summed over the phase's ranks."""
    import datetime
    import shutil

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    import repro_torch
    from repro_torch.kernels import bitonic

    t_phase = time.perf_counter()
    scratch = ROOT / "build" / "phase9"
    shutil.rmtree(scratch, ignore_errors=True)
    scratch.mkdir(parents=True)
    total = {fn.__name__: 0 for fn in bitonic.KERNELS}
    mk_total = dict(total)  # the tuple sorts' share

    def add(launches) -> None:
        for k, v in launches.items():
            total[k] += v

    # one rank: an NCCL group of one process, 2^24 keys
    dist.init_process_group("nccl", init_method=f"file://{scratch}/nccl_store", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = DeviceMesh("cuda", torch.arange(1), mesh_dim_names=("data",))
        gen = torch.Generator(device=device).manual_seed(8)
        x = torch.rand(1 << 24, generator=gen, device=device)
        sim1 = repro_torch.SortLimits(n_procs=1, stream_threshold=None)
        for label, kw in (("2^24 float32", {}), ('2^24 float32 want="order"', {"want": "order"})):
            repro_torch.sort(x, where=mesh, **kw)  # warm
            torch.cuda.synchronize()
            bitonic.reset_launches()
            t0 = time.perf_counter()
            out = repro_torch.sort(x, where=mesh, **kw)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            launches = {fn.__name__: fn.launches for fn in bitonic.KERNELS}
            add(launches)
            sim = repro_torch.sort(x, where="sim", limits=sim1, **kw)
            ref = torch.sort(x, stable=True)
            if not (torch.equal(out.keys, sim.keys) and torch.equal(out.keys, ref.values)
                    and (out.counts == sim.counts).all()
                    and (out.send_counts == sim.send_counts).all()):
                raise AssertionError(f"phase 9: one-rank NCCL {label} differs from the sim")
            if "want" in kw and not (torch.equal(out.order(), sim.order()) and torch.equal(
                    out.order(), ref.indices.to(torch.int32))):
                raise AssertionError(f"phase 9: one-rank NCCL {label}: order differs")
            traced = repro_torch.sort(x, where=mesh, **kw,
                                      limits=repro_torch.SortLimits(trace=True))
            share = exchange_share(traced.meta.trace)
            log(f"phase 9: one-rank NCCL mesh, {label}: {wall:.3f} ms wall, exchange share "
                + (f"{share:.4f}" if share is not None else "- (kv: one fused sort span)")
                + f", launches {launches}; equals the sim (n_procs=1) and torch.sort")
        # a packed pair (4 values x 2^16) at 2^24
        pair = (torch.randint(0, 4, (1 << 24,), generator=gen, device=device,
                              dtype=torch.int32),
                torch.randint(0, 1 << 16, (1 << 24,), generator=gen, device=device,
                              dtype=torch.int32))
        label = "2^24 packed pair (4 values x 2^16)"
        repro_torch.sort(pair, where=mesh)  # warm
        torch.cuda.synchronize()
        bitonic.reset_launches()
        t0 = time.perf_counter()
        out = repro_torch.sort(pair, where=mesh)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = {fn.__name__: fn.launches for fn in bitonic.KERNELS}
        add(launches)
        mk_total.update({k: mk_total[k] + v for k, v in launches.items()})
        if out.meta.multikey != "packed" or not out.imbalance() <= 1.01:
            raise AssertionError(f"phase 9: one-rank NCCL {label}: {out.meta.multikey}, "
                                 f"imbalance {out.imbalance()}")
        check_mesh_tuple(f"one-rank NCCL {label}", ([c.cpu() for c in out.keys], None), pair,
                         None, {})
        share = exchange_share(repro_torch.sort(
            pair, where=mesh, limits=repro_torch.SortLimits(trace=True)).meta.trace)
        log(f"phase 9: one-rank NCCL mesh, {label}: {wall:.3f} ms wall, exchange share "
            + (f"{share:.4f}" if share is not None else "-")
            + f", indexed exchanges {out.meta.exchanges}, imbalance {out.imbalance():.6f}, "
            f"launches {launches}; equals np.lexsort")
    finally:
        dist.destroy_process_group()

    # four ranks on the one card: gloo, the tensors on cuda:0
    ranks = run_ranks(scratch, 9)
    staged = [r for r in ranks[0]["float32 uniform"]["reasons"] if "staged" in r]
    if not staged:
        raise AssertionError("phase 9: gloo on the card did not stage through the host")
    log(f"phase 9: {MESH_WORLD} ranks on one card through gloo ({staged[0]}): the exchange "
        f"times below are gloo's, staged through the host, not NCCL's")
    gen = torch.Generator(device=device).manual_seed(9)
    sim4 = repro_torch.SortLimits(n_procs=MESH_WORLD, stream_threshold=None)
    for label, (x, vals, kw) in mesh_cases(gen, device).items():
        kw = dict(kw)
        limits = kw.pop("limits", repro_torch.SortLimits())
        on_cpu = "NaN" in label
        want = repro_torch.sort(x.cpu() if on_cpu else x, None if vals is None else vals,
                                where="sim", device="cpu" if on_cpu else device, **kw,
                                limits=repro_torch.SortLimits(n_procs=MESH_WORLD,
                                                              stream_threshold=None,
                                                              x64=limits.x64))
        got = [rk[label] for rk in ranks]
        keys = torch.cat([g["keys"] for g in got])
        if not torch.equal(keys.view(torch.uint8), want.keys.cpu().view(torch.uint8)):
            raise AssertionError(f"phase 9: {label}: the blocks differ from the sim")
        if not on_cpu:
            ref = torch.sort(x, stable=True, descending=kw.get("order") == "desc").values
            if not torch.equal(keys, ref.cpu()):
                raise AssertionError(f"phase 9: {label}: the keys differ from torch.sort")
        if want.values is not None and not torch.equal(torch.cat([g["values"] for g in got]),
                                                       want.values.cpu()):
            raise AssertionError(f"phase 9: {label}: the payload differs from the sim")
        for g in got:
            if not ((g["counts"] == want.counts).all()
                    and (g["send_counts"] == want.send_counts).all()):
                raise AssertionError(f"phase 9: {label}: counts differ from the sim")
        for g in got:
            add(g["launches"])
        extra = ""
        if label in MESH_DUPLICATES:
            extra = f", imbalance {got[0]['imbalance']:.6f}"
            if got[0]["imbalance"] >= 1.01:
                raise AssertionError(f"phase 9: {label}: imbalance {got[0]['imbalance']}")
        if got[0]["coverage"] is not None:
            extra += f", coverage {got[0]['coverage']:.4f}"
            if not got[0]["coverage"] >= 0.95:
                raise AssertionError(f"phase 9: {label}: coverage {got[0]['coverage']}")
        share = got[0]["exchange"]
        log(f"phase 9: 4 ranks, {label} ({x.shape[0]} keys): {got[0]['wall_ms']:.3f} ms wall "
            f"on rank 0, exchange share "
            + (f"{share:.4f}" if share is not None else "- (kv: one fused sort span)")
            + f", retries {got[0]['retries']}{extra}, launches per rank "
            + str([tuple(g["launches"].values()) for g in got])
            + ("; equals the sim on the CPU" if on_cpu else "; equals the sim and torch.sort"))
    gen = torch.Generator(device=device).manual_seed(10)
    for label, (cols, vals, kw) in mesh_mk_cases(gen, device).items():
        got = [rk["tuples"][label] for rk in ranks]
        keys = [torch.cat([g["keys"][j] for g in got]) for j in range(len(cols))]
        blocks = None if got[0]["values"] is None else torch.cat([g["values"] for g in got])
        check_mesh_tuple(label, (keys, blocks), cols, vals, kw)
        for g in got:
            if not (g["counts"] == got[0]["counts"]).all():
                raise AssertionError(f"phase 9: {label}: the ranks' counts differ")
            add(g["launches"])
            mk_total.update({k: mk_total[k] + v for k, v in g["launches"].items()})
        route = "lsd" if label == MESH_MK[2] else "packed"
        if {g["multikey"] for g in got} != {route} or not got[0]["imbalance"] <= 1.01:
            raise AssertionError(f"phase 9: {label}: {[g['multikey'] for g in got]}, "
                                 f"imbalance {got[0]['imbalance']}")
        share = got[0]["exchange"]
        log(f"phase 9: 4 ranks, {label} ({cols[0].shape[0]} rows): {got[0]['wall_ms']:.3f} ms "
            f"wall on rank 0, {route}, exchange share (the sort's all-to-alls where traced "
            f"apart, and the indexed exchanges) "
            + (f"{share:.4f}" if share is not None else "-")
            + f", indexed exchanges per sort {got[0]['exchanges']}, retries "
            f"{got[0]['retries']}, imbalance {got[0]['imbalance']:.6f}, launches per rank "
            + str([tuple(g["launches"].values()) for g in got]) + "; equals np.lexsort")
    shutil.rmtree(scratch, ignore_errors=True)
    log(f"phase 9: launches over the phase's ranks: {total} (of them the tuple sorts' "
        f"{mk_total}); {time.perf_counter() - t_phase:.1f} s")
    if any(v == 0 for v in mk_total.values()):
        raise AssertionError(f"phase 9: the tuple sorts left kernels unlaunched: {mk_total}")
    missing = [k for k, v in total.items() if v == 0]
    if missing:
        raise AssertionError(f"phase 9: kernels never launched on the mesh: {missing}")
    return total


# ------------------------------------------------------------------ phase 10

MOE_B, MOE_S, MOE_NEW = 2, 8192, 16  # prompts of 8192: flash serves S >= 8192
MOE_EP_B, MOE_EP_S = 2, 2048
MOE_EP_MESH = (2, 2)
# label: (expert_2d, hierarchical_a2a, capacity factor); at 8 nothing drops,
# so the ranks must equal one rank; at the config's 1.25 tokens drop and the
# received buckets (C = 1921, padded to 2048) merge on the kernels
MOE_EP_CASES = {"experts over model": (False, False, 8.0),
                "experts over (data, model)": (True, False, 8.0),
                "experts over (data, model), hierarchical": (True, True, 8.0),
                "experts over (data, model), capacity 1.25": (True, False, 1.25)}
MAX_KERNEL_ROW = 8192  # kernels.ops.MAX_PALLAS_ROW


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def moe_dispatch_launches(T: int, K: int, n_shards: int, C: int, tile: int = 1024) -> dict:
    """The bitonic launches of one MoE dispatch of T tokens: the kv tile
    sort of ``stable_argsort`` over T * K assignments (one launch), its
    merge rounds into rows of at most 8192 (one launch each; wider rounds
    are rank merges), and the merge tree over the n_shards received
    buckets of C (one launch per round into at most 8192)."""
    np2 = _pow2(T * K)
    width, merges = min(tile, np2), 0
    while width < np2:
        merges += int(2 * width <= MAX_KERNEL_ROW)
        width *= 2
    runs, width = _pow2(n_shards), C
    while runs > 1:
        merges += int(2 * _pow2(width) <= MAX_KERNEL_ROW)
        runs, width = runs // 2, 2 * width
    return {"bitonic_sort_rows": 0, "bitonic_sort_rows_kv": 1, "bitonic_merge_rows": 0,
            "bitonic_merge_rows_kv": merges}


def moe_capacity(A: int, n_shards: int, cf: float) -> int:
    """The bucket capacity C of ``moe._dispatch_body``."""
    return max(1, int((A + n_shards - 1) // n_shards * cf) + 1)


def moe_ep_layer(device):
    """Phase 10's expert-parallel cell: (float32 config at capacity factor
    8, one full-width MoE layer, the global (2, 2048, d) tokens), the same
    on every rank and the parent (seeded generators on the card)."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), dtype="float32",
                              moe_capacity_factor=8.0)
    layer = moe.init_moe(cfg, torch.Generator(device=device).manual_seed(12), device)
    x = torch.randn(MOE_EP_B, MOE_EP_S, cfg.d_model, device=device,
                    generator=torch.Generator(device=device).manual_seed(13))
    return cfg, layer, x


def moe_rank(rank: int, world: int, out_dir: str, device) -> None:
    """One of phase 10's ranks (``--mesh-rank r --mesh-phase 10``): a gloo
    group through a file store, a (data, model) = (2, 2) ``DeviceMesh``;
    for each case of MOE_EP_CASES ``moe_forward`` on this rank's block of
    the tokens and its slice of the 64 experts (warmed once, then timed
    between barriers with its launches), once with use_pallas=False, and
    once more through ``_dispatch_body`` with each exchange timed; its
    output, block, send counts, routed counts, launches and times go to
    ``rank<r>.pt``."""
    import dataclasses
    import datetime

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import bitonic
    from repro_torch.models import moe
    from repro_torch.sharding import spec

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    mesh = DeviceMesh(device.type, torch.arange(world).reshape(MOE_EP_MESH),
                      mesh_dim_names=("data", "model"))
    cfg, layer, x = moe_ep_layer(device)
    B, S, d = x.shape
    pos = torch.arange(B * S).reshape(B, S, 1)
    results = {}
    for label, (expert_2d, hierarchical, cf) in MOE_EP_CASES.items():
        c = dataclasses.replace(cfg, hierarchical_a2a=hierarchical, moe_capacity_factor=cf)
        axes = spec.from_mesh(mesh, expert_2d=expert_2d)
        xl, local = moe.local_tokens(x, axes), moe.shard_params(layer, axes)
        moe.moe_forward(xl, local, c, axes)  # warm
        sync()
        dist.barrier()
        bitonic.reset_launches()
        t0 = time.perf_counter()
        out, aux = moe.moe_forward(xl, local, c, axes)
        sync()
        dist.barrier()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in bitonic.KERNELS}
        plain, plain_aux = moe.moe_forward(xl, local, c, axes, use_pallas=False)

        group = spec.axis_group(mesh, axes.expert)
        a2a, spent = moe._make_a2a(mesh, axes.expert, hierarchical), []

        def timed(t, a2a=a2a, spent=spent):
            sync()
            t1 = time.perf_counter()
            r = a2a(t)
            sync()
            spent.append(time.perf_counter() - t1)
            return r

        dist.barrier()
        t0 = time.perf_counter()
        again, _, send = moe._dispatch_body(xl.reshape(-1, d), local, c, n_shards=group.size,
                                            shard_id=group.index, a2a=timed)
        sync()
        body_wall = time.perf_counter() - t0
        _, ids, _ = moe._router(xl.reshape(-1, d), layer.router, c)
        results[label] = dict(
            out=out.cpu(), aux=float(aux), pos=moe.local_tokens(pos, axes).reshape(-1),
            same=torch.equal(again.reshape(out.shape), out),
            same_plain=torch.equal(plain, out) and torch.equal(plain_aux, aux), send=send.cpu(),
            routed=torch.bincount(ids.reshape(-1).long(), minlength=cfg.n_experts).cpu(),
            launches=launches, wall_ms=wall * 1e3, n_shards=group.size,
            tokens=xl.shape[0] * xl.shape[1], exchange_share=sum(spent) / body_wall,
            exchanges=len(spent))
    torch.save(results, pathlib.Path(out_dir) / f"rank{rank}.pt")
    dist.destroy_process_group()


def run_moe(device) -> dict:
    """Phase 10: deepseek-moe-16b served on the card at full width and
    depth, the dispatch's kernels against their twins, the dense oracle,
    and expert parallelism over four gloo ranks and a one-rank NCCL group.
    Returns the launches of every kernel over the served run."""
    import copy
    import dataclasses
    import datetime
    import shutil

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs.registry import get_config
    from repro_torch.core import keyenc
    from repro_torch.kernels import bitonic, flash
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.serve import engine
    from repro_torch.sharding import spec

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), flash_attention=True,
                              dtype="bfloat16")
    n_moe = sum(s.ffn == "moe" for s in cfg.layer_list())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device=device, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 10: deepseek-moe-16b built on the card in {time.perf_counter() - t0:.2f} s: "
        f"{cfg.n_layers} layers ({n_moe} MoE: {cfg.n_experts} experts of {cfg.d_expert} + "
        f"{cfg.n_shared_experts} shared, top-{cfg.moe_topk}), {n_params} parameters, "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    if n_params != cfg.param_count():
        raise AssertionError(f"phase 10: {n_params} parameters, the config counts "
                             f"{cfg.param_count()}")
    B, S, n_new, vocab, K = MOE_B, MOE_S, MOE_NEW, cfg.vocab, cfg.moe_topk
    gen = torch.Generator(device=device).manual_seed(14)
    batch = {"tokens": torch.randint(0, vocab, (B, S), generator=gen, device=device,
                                     dtype=torch.int32)}

    # the main path: generate, counts set to 0 just before and read just after
    torch.cuda.synchronize()
    bitonic.reset_launches()
    flash.flash_attention.launches = 0
    t0 = time.perf_counter()
    out = engine.generate(model, batch, n_new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in bitonic.KERNELS}
    launches["flash_attention"] = flash.flash_attention.launches
    per_layer = moe_dispatch_launches(B * S, K, 1, moe_capacity(B * S * K, 1,
                                                                cfg.moe_capacity_factor))
    want = {k: v * n_moe for k, v in per_layer.items()}
    want["flash_attention"] = cfg.n_layers
    log(f"phase 10: generate {B} x {S} prompt tokens + {n_new} new: {gen_s * 1e3:.3f} ms wall "
        f"(first call), launches {launches} (derived {want}: per MoE layer {per_layer}, "
        f"{B * S * K} assignments padded to {_pow2(B * S * K)}, "
        f"{max(0, (_pow2(B * S * K) // MAX_KERNEL_ROW).bit_length() - 1)} rank-merge rounds), "
        f"tokens {out.tolist()}")
    if launches != want:
        raise AssertionError(f"phase 10: launches {launches}, derived {want}")
    if out.shape != (B, n_new) or not bool(((out >= 0) & (out < vocab)).all()):
        raise AssertionError(f"phase 10: tokens out of [0, {vocab}) or of shape {out.shape}")

    # prefill and decode timed; the first MoE layer's router input captured,
    # and every MoE layer's expert ids
    captured, flash_ids = [], []
    router = moe._router

    def capture(xf, w, c):
        r = router(xf, w, c)
        if not captured:
            captured.append((xf, r[1]))
        flash_ids.append(r[1])
        return r

    prefill, step = engine.make_prefill(model), engine.make_serve_step(model)
    moe._router = capture
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill(batch)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
    finally:
        moe._router = router
    caches = engine.extend_caches(model, caches, S, S + n_new)
    tok = logits[..., :vocab].argmax(-1).to(torch.int32)
    steps, step_ms = [tok], []
    for i in range(n_new - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, caches = step(caches, tok, S + i)
        tok = lg[..., :vocab].argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        steps.append(tok)
    if not torch.equal(torch.cat(steps, dim=1), out):
        raise AssertionError("phase 10: the timed prefill and steps gave other tokens")
    wall, dev, events = device_breakdown(lambda: step(caches, tok, S + n_new - 1))
    log(f"phase 10: one decode step under torch.profiler: {wall:.3f} ms wall, {dev:.3f} ms "
        f"device (idle {1 - dev / wall:.3f}); largest device events: " + "; ".join(
            f"{name[:60]} {ms:.3f} ms ({ms / dev:.3f})" for name, ms in events[:8]))
    del caches
    decode_ms = statistics.median(step_ms)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"phase 10: prefill {prefill_ms:.3f} ms, decode {decode_ms:.3f} ms a step (median of "
        f"{len(step_ms)}), {B / decode_ms * 1e3:.3f} tokens/s, peak {peak_gb:.3f} GB")

    # the prefill against the same weights read with flash_attention=False.
    # Each MoE layer's top-6 of 64 is a discrete choice that the attention's
    # bf16 rounding can flip, and a flip moves which tokens the capacity
    # drops; so the flash prefill runs once more with the plain prefill's
    # routing (ids, weights, aux) replayed layer by layer, and that run is
    # held to the plain one
    plain = copy.copy(model)
    plain.cfg = dataclasses.replace(cfg, flash_attention=False)
    routes = []

    def record(xf, w, c):
        routes.append(router(xf, w, c))
        return routes[-1]

    before = flash.flash_attention.launches
    moe._router = record
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref, _ = engine.make_prefill(plain)(batch)
        torch.cuda.synchronize()
        plain_prefill_ms = (time.perf_counter() - t0) * 1e3
    finally:
        moe._router = router
    if flash.flash_attention.launches != before:
        raise AssertionError("phase 10: the flash_attention=False prefill launched flash")
    replay = iter(routes)
    moe._router = lambda xf, w, c: next(replay)
    try:
        pinned, _ = prefill(batch)
    finally:
        moe._router = router
    if flash.flash_attention.launches != before + cfg.n_layers or next(replay, None):
        raise AssertionError("phase 10: the replayed flash prefill ran another path")
    moved = [float((a.sort(-1).values != r[1].sort(-1).values).any(-1).float().mean())
             for a, r in zip(flash_ids, routes, strict=True)]
    got, pinned, ref = logits.float(), pinned.float(), ref.float()
    diff, scale = float((got - ref).abs().max()), float(ref.abs().max())
    pin_diff = float((pinned - ref).abs().max())
    same_first = torch.equal(got[..., :vocab].argmax(-1), ref[..., :vocab].argmax(-1))
    log(f"phase 10: prefill logits vs flash_attention=False ({plain_prefill_ms:.3f} ms), max "
        f"|logit| {scale:.4f}: with the plain prefill's routing replayed max abs diff "
        f"{pin_diff:.4f}; routed on its own max abs diff {diff:.4f} (same greedy first token "
        f"{same_first}; share of tokens routed to another set of experts: first MoE layer "
        f"{moved[0]:.5f}, last {moved[-1]:.5f}, max {max(moved):.5f})")
    if not (torch.isfinite(got).all() and torch.isfinite(pinned).all()
            and pin_diff <= 5e-2 * scale):
        raise AssertionError("phase 10: the flash prefill disagrees with the plain prefill")
    del plain, logits, ref, got, pinned, routes, flash_ids

    # the dispatch's kernels against their twins, on the first MoE layer's ids
    xf, ids = captured[0]
    keys = ids.reshape(-1)
    card = keyenc.stable_argsort(keys, use_pallas=True)
    twin = keyenc.stable_argsort(keys.cpu(), use_pallas=True)
    plain = keyenc.stable_argsort(keys, use_pallas=False)
    for got in (card, plain):
        if not all(torch.equal(a.cpu(), b) for a, b in zip(got, twin)):
            raise AssertionError("phase 10: stable_argsort on the card differs from its twin")
    layer = next(b for b, s in zip(model.layers, cfg.layer_list()) if s.ffn == "moe")
    h = xf.reshape(B, S, -1)
    a = moe.moe_forward(h, layer.moe, cfg, use_pallas=True)
    b = moe.moe_forward(h, layer.moe, cfg, use_pallas=False)
    if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
        raise AssertionError("phase 10: moe_forward's two sort paths differ on the card")
    counts = torch.bincount(keys.long(), minlength=cfg.n_experts)
    log(f"phase 10: first MoE layer, {keys.numel()} assignments: stable_argsort (kernels) "
        f"equals its twin on the CPU and torch.sort bit for bit; moe_forward with "
        f"use_pallas True and False give the same bits; tokens per expert min "
        f"{int(counts.min())} / max {int(counts.max())} (mean {keys.numel() / cfg.n_experts:.1f})")

    # where a MoE layer's time goes: the sort against the expert GEMMs
    C_e = max(1, int(B * S * K // cfg.n_experts * cfg.moe_capacity_factor) + 1)
    xe = torch.randn(cfg.n_experts, C_e, cfg.d_model, device=device, dtype=torch.bfloat16)
    layer_ms = time_ms(lambda: moe.moe_forward(h, layer.moe, cfg), reps=5, batch=2)
    sort_ms = time_ms(lambda: keyenc.stable_argsort(keys, use_pallas=True), reps=10, batch=5)
    plain_sort_ms = time_ms(lambda: keyenc.stable_argsort(keys, use_pallas=False), reps=10,
                            batch=5)
    ffn_ms = time_ms(lambda: moe._expert_ffn(xe, layer.moe, cfg), reps=5, batch=2)
    router_ms = time_ms(lambda: router(xf, layer.moe.router, cfg), reps=10, batch=5)
    wall, dev, events = device_breakdown(lambda: moe.moe_forward(h, layer.moe, cfg))
    log(f"phase 10: one MoE layer under torch.profiler: {wall:.3f} ms wall, {dev:.3f} ms "
        f"device (idle {1 - dev / wall:.3f}); largest device events: " + "; ".join(
            f"{name[:60]} {ms:.3f} ms ({ms / dev:.3f})" for name, ms in events[:10]))
    log(f"phase 10: one MoE layer of {B * S} tokens: {layer_ms:.4f} ms; its sort "
        f"(stable_argsort: tile sort, 3 kernel merges, rank merges) {sort_ms:.4f} ms "
        f"({sort_ms / layer_ms:.4f} of the layer; torch.sort path {plain_sort_ms:.4f} ms), "
        f"expert GEMMs ({cfg.n_experts} x {C_e} rows) {ffn_ms:.4f} ms "
        f"({ffn_ms / layer_ms:.4f}), router {router_ms:.4f} ms ({router_ms / layer_ms:.4f})")
    del model, layer, h, xf, xe, a, b, out, batch, captured
    torch.cuda.empty_cache()

    # the dense oracle: one full-width layer in float32, TF32 off, 256 tokens
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        cfg32, layer32, x = moe_ep_layer(device)
        got, aux = moe.moe_forward(x[:1, :256], layer32, cfg32)
        ref, aux_ref = moe.moe_ref(x[:1, :256], layer32, cfg32)
        err, scale = float((got - ref).abs().max()), float(ref.abs().max())
        log(f"phase 10: dense oracle, 256 tokens in float32: max abs err {err:.3e} against "
            f"max |ref| {scale:.4f}; aux {float(aux):.6f} / {float(aux_ref):.6f}")
        if not (err <= 1e-4 * scale and abs(float(aux) - float(aux_ref)) <= 1e-5):
            raise AssertionError("phase 10: moe_forward is off the dense oracle")

        # one rank on the whole batch: the reference of the expert-parallel runs
        one, aux_one = moe.moe_forward(x, layer32, cfg32)
        _, ids, _ = moe._router(x.reshape(-1, cfg32.d_model), layer32.router, cfg32)
        routed = torch.bincount(ids.reshape(-1).long(), minlength=cfg32.n_experts).cpu()

        # a one-rank NCCL group: the exchange through NCCL's all_to_all
        scratch = ROOT / "build" / "phase10"
        shutil.rmtree(scratch, ignore_errors=True)
        scratch.mkdir(parents=True)
        dist.init_process_group("nccl", init_method=f"file://{scratch}/nccl_store", rank=0,
                                world_size=1, timeout=datetime.timedelta(seconds=300))
        try:
            mesh = DeviceMesh("cuda", torch.arange(1).reshape(1, 1),
                              mesh_dim_names=("data", "model"))
            group = spec.axis_group(mesh, "model")
            via, aux_via, send = moe._dispatch_body(
                x.reshape(-1, cfg32.d_model), layer32, cfg32, n_shards=1, shard_id=0,
                a2a=group.all_to_all)
            mean = spec.axis_group(mesh, ("data", "model")).all_mean(aux_via)
        finally:
            dist.destroy_process_group()
        if not (torch.equal(via.reshape(one.shape), one) and torch.equal(mean, aux_one)):
            raise AssertionError("phase 10: the one-rank NCCL exchange changed the output")
        log(f"phase 10: one-rank NCCL group: the dispatch through NCCL's all_to_all and mean "
            f"equals the identity exchange bit for bit (send counts {send.tolist()})")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    # four gloo ranks on the card, (data, model) = (2, 2)
    ranks = run_ranks(scratch, 10)
    flat = one.reshape(-1, cfg32.d_model).cpu()
    scale = float(flat.abs().max())
    for label, (_, _, cf) in MOE_EP_CASES.items():
        got = [rk[label] for rk in ranks]
        whole = torch.zeros_like(flat)
        seen = torch.zeros(flat.shape[0], dtype=torch.bool)
        for g in got:
            whole[g["pos"]] = g["out"].reshape(-1, cfg32.d_model)
            seen[g["pos"]] = True
        err = float((whole - flat).abs().max())
        n_shards = got[0]["n_shards"]
        if not (seen.all() and all(g["same"] and g["same_plain"] for g in got)):
            raise AssertionError(f"phase 10: {label}: a rank's output differs from its own "
                                 f"use_pallas=False or _dispatch_body run")
        # assignments past an expert's capacity or a bucket's drop; where none
        # does (always at capacity factor 8) the ranks must equal one rank
        T = got[0]["tokens"]
        C = moe_capacity(T * K, n_shards, cf)
        cap_e = max(1, int(T * K * n_shards // cfg32.n_experts * cf) + 1)
        over = int((routed - cap_e).clamp(min=0).sum()) + sum(
            int((g["send"].long() - C).clamp(min=0).sum()) for g in got)
        if (over == 0 or cf == cfg32.moe_capacity_factor) and not err <= 1e-4 * scale:
            raise AssertionError(f"phase 10: {label}: the ranks' blocks are off the one-rank "
                                 f"output (max abs err {err}, {over} assignments over a "
                                 f"capacity)")
        # aux: the mean over the ranks of each block's own aux loss
        blocks = x.reshape(-1, cfg32.d_model)
        aux_mean = statistics.fmean(float(moe._router(blocks[g["pos"].to(device)],
                                                      layer32.router, cfg32)[2]) for g in got)
        if not all(abs(g["aux"] - aux_mean) <= 1e-5 for g in got):
            raise AssertionError(f"phase 10: {label}: aux {[g['aux'] for g in got]}, the "
                                 f"blocks' mean {aux_mean}")
        if not torch.equal(sum(g["routed"] for g in got), routed):
            raise AssertionError(f"phase 10: {label}: per-expert counts differ from one rank's")
        sent = sum(g["send"].long() for g in got)
        if not torch.equal(sent, routed.reshape(n_shards, -1).sum(1)):
            raise AssertionError(f"phase 10: {label}: send counts differ from one rank's")
        want_rank = moe_dispatch_launches(T, K, n_shards, C)
        if any(g["launches"] != want_rank for g in got):
            raise AssertionError(f"phase 10: {label}: launches {[g['launches'] for g in got]}, "
                                 f"derived {want_rank}")
        log(f"phase 10: 4 gloo ranks, {label} ({n_shards} shards, {T} tokens a rank): "
            f"{got[0]['wall_ms']:.3f} ms wall on rank 0, exchange share "
            f"{statistics.median(g['exchange_share'] for g in got):.4f} (median over ranks, "
            f"{got[0]['exchanges']} exchanges staged through the host), capacity factor {cf} "
            f"(C {C}, {cap_e} an expert; {over} assignments over a capacity), max abs err "
            f"{err:.3e} against one rank at capacity factor 8 (max |out| {scale:.4f}), "
            f"per-expert and send counts equal, each rank's output equal to its "
            f"use_pallas=False run, launches per rank {tuple(got[0]['launches'].values())}")
    shutil.rmtree(scratch, ignore_errors=True)
    log(f"phase 10: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ----------------------------------------------------------------- phase 11
TRAIN_S, TRAIN_B, TRAIN_ACCUM = 4096, 2, 2  # 16,384 tokens a step
TRAIN_STEPS = 4  # on one repeated batch


def train_config():
    """Phase 11's cut of deepseek-moe-16b: full width, one dense layer and
    three MoE layers (``repro``'s example intends "1 dense + 3 MoE"; its
    ``--layers`` flag would give dense layers only), bf16, remat on."""
    import dataclasses

    from repro_torch.configs.registry import get_config

    full = get_config("deepseek-moe-16b")
    (dense, _), (moe_period, _) = full.segments
    return dataclasses.replace(full, segments=((dense, 1), (moe_period, 3)), n_layers=4,
                               dtype="bfloat16")


def launch_counts() -> dict:
    from repro_torch.kernels import bitonic, flash

    out = {fn.__name__: fn.launches for fn in bitonic.KERNELS}
    out["flash_attention"] = flash.flash_attention.launches
    return out


def reset_counts() -> None:
    from repro_torch.kernels import bitonic, flash

    bitonic.reset_launches()
    flash.flash_attention.launches = 0


def counts_minus(a: dict, b: dict) -> dict:
    return {k: a[k] - b[k] for k in a}


def run_train(device) -> dict:
    """Phase 11, with autograd on (``main`` turns it off for the others)."""
    import torch

    with torch.enable_grad():
        return train_phase(device)


def train_phase(device) -> dict:
    """Phase 11: deepseek-moe-16b trained at full width (1 dense + 3 MoE
    layers) through the launcher's pieces, and its six checks. Returns the
    launches of every kernel over the training run."""
    import argparse
    import dataclasses
    import math
    import shutil

    import numpy as np
    import torch
    from repro_torch.checkpoint.ckpt import CheckpointManager, _flatten
    from repro_torch.configs.registry import smoke_config
    from repro_torch.core import keyenc
    from repro_torch.data import pipeline
    from repro_torch.ft.manager import RestartManager
    from repro_torch.launch import train as launcher
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train.step import (
        TrainConfig, init_train_state, make_loss_fn, make_train_step,
    )

    t_phase = time.perf_counter()
    cfg = train_config()
    n_moe = sum(s.ffn == "moe" for s in cfg.layer_list())
    args = argparse.Namespace(seq_len=TRAIN_S, global_batch=TRAIN_B, grad_accum=TRAIN_ACCUM)
    tcfg = TrainConfig(opt=adamw.OptConfig(name=cfg.optimizer, peak_lr=3e-4, warmup_steps=2,
                                           total_steps=8, state_dtype=cfg.opt_state_dtype))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device=device, seed=0)
    params, ost = init_train_state(model, tcfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.values())
    if n_params != cfg.param_count():
        raise AssertionError(f"phase 11: {n_params} parameters, the config counts "
                             f"{cfg.param_count()}")
    log(f"phase 11: deepseek-moe-16b cut to {cfg.n_layers} layers (1 dense, {n_moe} MoE: "
        f"{cfg.n_experts} experts of {cfg.d_expert} + {cfg.n_shared_experts} shared, "
        f"top-{cfg.moe_topk}, capacity factor {cfg.moe_capacity_factor}), d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}, {cfg.dtype}, remat {cfg.remat}: param_count "
        f"{n_params}, built with AdamW states in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    step_fn = make_train_step(model, tcfg)
    loader = pipeline.PackedLoader(launcher.data_config(cfg, args), cfg, device=device)
    it = iter(loader)

    # the derived launches: the data round's argsort of bucket_docs lengths on
    # the sim (a payload sort: one kv row sort, three kv merges) and, per MoE
    # layer and micro-step, one dispatch, twice with remat
    T, K = TRAIN_B * TRAIN_S, cfg.moe_topk
    per_layer = moe_dispatch_launches(T, K, 1, moe_capacity(T * K, 1, cfg.moe_capacity_factor))
    want_step = {k: v * n_moe * TRAIN_ACCUM * (2 if cfg.remat else 1)
                 for k, v in per_layer.items()}
    want_step["flash_attention"] = 0
    want_data = dict(zip(per_layer, KEY_VALUE), flash_attention=0)

    # the main path: RestartManager.run over TRAIN_STEPS steps on one batch
    # that the loader makes at the first step; counts set to 0 just before
    batches, data_launches, step_launches, step_ms, losses = [], [], [], [], []

    def make_batch(step):
        if not batches:
            before = launch_counts()
            batches.append(next(it))
            data_launches.append(counts_minus(launch_counts(), before))
        return batches[0]

    def wrapped_step(state, step, batch):
        before = launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        p, o, metrics = step_fn(*state, step, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        step_launches.append(counts_minus(launch_counts(), before))
        losses.append({k: float(v) for k, v in metrics.items()})
        return (p, o), metrics

    scratch = ROOT / "build" / "phase11"
    shutil.rmtree(scratch, ignore_errors=True)
    mgr = RestartManager(CheckpointManager(str(scratch / "run"), keep=1),
                         save_every=10 ** 9)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    (params, ost), final = mgr.run((params, ost), 0, TRAIN_STEPS, wrapped_step, make_batch)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tokens = TRAIN_B * TRAIN_S * TRAIN_ACCUM
    med = statistics.median(step_ms[1:])
    log(f"phase 11: {final} steps through RestartManager.run in {run_s:.3f} s: step wall ms "
        + ", ".join(f"{t:.3f}" for t in step_ms) + f"; median after the first {med:.3f} ms, "
        f"{tokens / med * 1e3:.1f} tokens/s ({tokens} tokens a step: {TRAIN_B} x {TRAIN_S} x "
        f"accum {TRAIN_ACCUM}), peak {peak_gb:.3f} GB")
    for i, m in enumerate(losses):
        log(f"phase 11: step {i}: " + ", ".join(f"{k} {v:.6f}" for k, v in m.items()))

    # check 1: the loss. Unit-variance logits (the final rmsnorm's rms-1
    # states against the head's N(0, 1/d) weights) give nll = ln V + 1/2.
    # lr(0) == 0, so step 1 sees the first loss again; AdamW's first updates
    # move every parameter by about lr (m / sqrt(v) is the gradient's sign),
    # so on one repeated batch the loss may overshoot between steps. The
    # loss on the batch after the four steps (the micro-batches' mean, as
    # the step's metrics) must be below the first
    loss_fn = make_loss_fn(model, tcfg)
    with torch.no_grad():
        after = statistics.fmean(
            float(loss_fn({k: torch.as_tensor(v[a], device=device)
                           for k, v in batches[0].items()})[0]) for a in range(TRAIN_ACCUM))
    expect = math.log(cfg.vocab) + 0.5
    first = losses[0]["loss"]
    log(f"phase 11: check 1: first loss {first:.6f} (ln V {math.log(cfg.vocab):.6f}, "
        f"ln V + 1/2 {expect:.6f}); on the same batch at steps 1-{TRAIN_STEPS - 1} "
        + ", ".join(f"{m['loss']:.6f}" for m in losses[1:])
        + f", after the {TRAIN_STEPS} steps {after:.6f}")
    if not (math.isfinite(first) and abs(first - expect) <= 0.5 and after < first):
        raise AssertionError("phase 11: check 1: the loss is off")

    # check 2: the launches of the data round and of every step, as derived
    log(f"phase 11: check 2: launches over the run {launches}; the data round "
        f"{data_launches[0]} (derived {want_data}); each step {step_launches[0]} (derived "
        f"{want_step}: per MoE layer and micro-step {per_layer}, {T * K} assignments, x "
        f"{n_moe} layers x {TRAIN_ACCUM} micro-steps x 2 for remat)")
    if data_launches != [want_data] or any(s != want_step for s in step_launches):
        raise AssertionError("phase 11: check 2: launches differ from the derived ones")
    total = {k: want_data[k] + TRAIN_STEPS * want_step[k] for k in want_step}
    if launches != total:
        raise AssertionError(f"phase 11: check 2: run launches {launches}, derived {total}")

    # where a step's device time goes
    batch = batches[0]
    wall, dev, events, nodes = device_breakdown(
        lambda: step_fn(params, ost, TRAIN_STEPS, batch), nodes=True)
    log(f"phase 11: one step under torch.profiler: {wall:.3f} ms wall, {dev:.3f} ms device "
        f"(idle {1 - dev / wall:.3f}); largest device events: " + "; ".join(
            f"{name[:60]} {ms:.3f} ms ({ms / dev:.3f})" for name, ms in events[:10]))
    log("phase 11: the backward's autograd nodes by the device time they launched: " + "; ".join(
        f"{name[:40]} {ms:.3f} ms ({ms / dev:.3f})" for name, ms in nodes[:10]))
    grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=device)
             for k, p in params.items()}
    groups = adamw.segment_groups(cfg, params)
    opt_ms = time_ms(lambda: adamw.apply_updates(params, grads, ost, TRAIN_STEPS + 1, tcfg.opt,
                                                 groups), reps=3, batch=1)
    log(f"phase 11: the optimizer update (clip + AdamW over {len(params)} leaves, "
        f"{n_params} parameters): {opt_ms:.3f} ms ({opt_ms / med:.4f} of a step)")
    del grads

    # the dispatch sort's share of one MoE layer's forward (bf16, 8192 tokens)
    layer = next(b for b, s in zip(model.layers, cfg.layer_list()) if s.ffn == "moe")
    h = torch.randn(TRAIN_B, TRAIN_S, cfg.d_model, device=device, dtype=torch.bfloat16,
                    generator=torch.Generator(device=device).manual_seed(21))
    with torch.no_grad():
        _, ids, _ = moe._router(h.reshape(-1, cfg.d_model), layer.moe.router, cfg)
        layer_ms = time_ms(lambda: moe.moe_forward(h, layer.moe, cfg), reps=5, batch=2)
    sort_ms = time_ms(lambda: keyenc.stable_argsort(ids.reshape(-1), use_pallas=True), reps=10,
                      batch=5)
    log(f"phase 11: one MoE layer's forward on {T} tokens: {layer_ms:.4f} ms; its dispatch "
        f"sort (stable_argsort of {T * K} expert ids) {sort_ms:.4f} ms ({sort_ms / layer_ms:.4f}"
        f" of the layer)")
    del model, params, ost, step_fn, layer, h, ids, batches, mgr
    torch.cuda.empty_cache()

    # check 3: one full-width MoE layer, forward and backward in float32,
    # kernels against the plain sort
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        c32 = dataclasses.replace(cfg, dtype="float32")
        layer = moe.init_moe(c32, torch.Generator(device=device).manual_seed(22), device)
        x = torch.randn(1, 4096, c32.d_model, device=device,
                        generator=torch.Generator(device=device).manual_seed(23))
        runs = []
        for path in (True, False):
            xg = x.clone().requires_grad_(True)
            _, ids, _ = moe._router(x.reshape(-1, c32.d_model), layer.router, c32)
            o, aux = moe.moe_forward(xg, layer, c32, use_pallas=path)
            g = torch.autograd.grad((o.float() ** 2).mean() + 0.01 * aux,
                                    [xg, *layer.parameters()])
            runs.append((ids, o.detach(), aux.detach(), g))
        (i1, o1, a1, g1), (i2, o2, a2, g2) = runs
        errs = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(g1, g2)]
        log(f"phase 11: check 3: a full-width MoE layer on 4096 tokens in float32: routing "
            f"and output equal bit for bit across the two sort paths "
            f"{torch.equal(i1, i2) and torch.equal(o1, o2) and torch.equal(a1, a2)}; gradient "
            f"errors of x, router, wi, wg, wo over their max: "
            + ", ".join(f"{e:.3e}" for e in errs))
        if not (torch.equal(i1, i2) and torch.equal(o1, o2) and torch.equal(a1, a2)
                and max(errs) <= 1e-5):
            raise AssertionError("phase 11: check 3: the kernel sort path differs")
        del layer, x, runs, g1, g2

        # check 4: the train step on the smoke config, card against CPU
        small = dataclasses.replace(smoke_config("deepseek-moe-16b"), dtype="float32",
                                    remat=True)
        stcfg = TrainConfig(opt=adamw.OptConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10))
        sdata = pipeline.DataConfig(seq_len=128, global_batch=2, grad_accum=2,
                                    vocab=small.vocab, bucket_docs=256)
        sb = [b for _, b in zip(range(2), pipeline.PackedLoader(sdata, device=device))]
        sides = []
        for dev in (device, torch.device("cpu")):
            m = Model(small, device=dev, seed=6)
            if sides:
                m.load_state_dict({k: v.cpu() for k, v in sides[0][0].items()})
            sp, so = init_train_state(m, stcfg)
            start = {k: v.detach().clone() for k, v in sp.items()}
            sstep = make_train_step(m, stcfg)
            sm = [sstep(sp, so, i, b)[2] for i, b in zip((1, 2), sb)]
            sides.append((start, sp, so, sm))
        (_, gp, gs, gm), (_, cp, cs, cm) = sides
        lr_sum = sum(float(m["lr"]) for m in cm)
        m_err = max(abs(float(a[k]) - float(b[k])) / max(abs(float(b[k])), 1e-7)
                    for a, b in zip(gm, cm) for k in b)
        top = max(float(t.detach().abs().max()) for t in cp.values())
        p_err = max(float((gp[k].detach().cpu() - cp[k].detach()).abs().max()) for k in cp)
        s_err = {kind: max(float((gs[kind][k].cpu() - cs[kind][k]).abs().max()) for k in cp)
                 / max(float(t.abs().max()) for t in cs[kind].values()) for kind in ("m", "v")}
        log(f"phase 11: check 4: two train steps of the deepseek-moe-16b smoke config in "
            f"float32, card against CPU: metrics max relative error {m_err:.3e}; parameters "
            f"max abs error {p_err:.3e} (limit 1e-5 x {top:.4f} + 1e-2 x summed lr "
            f"{lr_sum:.2e}); m {s_err['m']:.3e}, v {s_err['v']:.3e} of their max")
        if not (m_err <= 1e-5 and p_err <= 1e-5 * top + 1e-2 * lr_sum
                and max(s_err.values()) <= 1e-5):
            raise AssertionError("phase 11: check 4: the card's train step is off the CPU's")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32

    # check 5: the data pipeline's length sort, card against CPU
    dcfg = pipeline.DataConfig(seq_len=TRAIN_S)
    rng = np.random.default_rng(24)
    for label, lens in (("4096 documents (sim)", pipeline.doc_lengths(rng, 4096, dcfg)),
                        ("2^20 lengths (stream)", pipeline.doc_lengths(rng, 1 << 20, dcfg))):
        got, times = [], []
        for dev in (device, "cpu"):
            pipeline.bucket_by_length(lens, dcfg.bucket_procs,
                                      external_threshold=dcfg.bucket_external_docs, device=dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            got.append(pipeline.bucket_by_length(
                lens, dcfg.bucket_procs, external_threshold=dcfg.bucket_external_docs,
                device=dev))
            times.append((time.perf_counter() - t1) * 1e3)
        same = (np.array_equal(got[0], got[1])
                and np.array_equal(got[1], np.argsort(lens, kind="stable")))
        log(f"phase 11: check 5: bucket_by_length of {label}, {len(np.unique(lens))} distinct: "
            f"card {times[0]:.3f} ms, CPU {times[1]:.3f} ms wall (second call each); card "
            f"equals CPU and the stable argsort bit for bit: {same}")
        if not same:
            raise AssertionError(f"phase 11: check 5: {label}: the card's order differs")

    # check 6: checkpoint and restart on the card (the smoke config in bf16)
    small = smoke_config("deepseek-moe-16b")
    sdata = pipeline.DataConfig(seq_len=128, global_batch=2, grad_accum=2, vocab=small.vocab,
                                bucket_docs=256)
    sb = [b for _, b in zip(range(4), pipeline.PackedLoader(sdata, device=device))]

    def small_state(seed):
        m = Model(small, device=device, seed=seed)
        return m, *init_train_state(m, stcfg)

    def bits(state):
        return {n: t.detach().clone() for n, t in _flatten(state)}

    m, sp, so = small_state(0)
    sstep = make_train_step(m, stcfg)
    sstep(sp, so, 1, sb[0])
    ck = CheckpointManager(str(scratch / "ckpt"), keep=2)
    before = bits((sp, so))
    ck.save_async(2, (sp, so))
    sstep(sp, so, 2, sb[1])
    ck.wait()
    moved = any(not torch.equal(before[n], t) for n, t in bits((sp, so)).items())
    _, fp, fo = small_state(9)
    (rp, ro), s = ck.restore_latest((fp, fo))
    back = bits((rp, ro))
    same = s == 2 and all(torch.equal(before[n], back[n]) for n in before)
    fails = []

    def flaky(state, step, batch):
        if step == 3 and not fails:
            fails.append(step)
            raise RuntimeError("simulated device error")
        p, o, metrics = sstep(*state, step, batch)
        return (p, o), metrics

    rm = RestartManager(CheckpointManager(str(scratch / "restart"), keep=2), save_every=2)
    _, end = rm.run((sp, so), 0, 5, flaky, lambda s: sb[s % 4])
    log(f"phase 11: check 6: save_async, a step ({'moved' if moved else 'did not move'} the "
        f"state), wait: the checkpoint equals the state before the step and restores into a "
        f"fresh model bit for bit: {same}; RestartManager with one failing step: ended at "
        f"step {end}, recoveries {rm.recoveries}")
    if not (moved and same and end == 5 and rm.recoveries == 1):
        raise AssertionError("phase 11: check 6: checkpoint or restart failed")
    shutil.rmtree(scratch, ignore_errors=True)
    log(f"phase 11: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ------------------------------------------------------------------ phase 12

BATCH_SLOTS, BATCH_SMAX = 4, 8192 + 64
# (prompt tokens, new tokens): 2 prompts of 8192 (flash serves them) and 6
# of 512-4096; 148 new tokens over 4 slots, so slots are re-used. A prompt
# past 512 tokens is a multiple of 512 (the chunked prefill's query chunk,
# attention.Q_CHUNK, as in repro)
BATCH_REQS = ((8192, 24), (1024, 8), (512, 32), (4096, 16), (8192, 12), (2048, 20),
              (1536, 8), (3072, 28))
BATCH_F32 = ((300, 12), (1024, 9), (128, 16), (512, 10))  # the float32 cut, 2 slots
BATCH_MOE = ((512, 8), (2048, 8), (1024, 8), (1536, 8))  # deepseek-moe-16b, 2 slots
BATCH_TOL = 5e-2  # of max |logit|


def batch_requests(gen, vocab: int, spec, device, first_rid: int = 0) -> list:
    """Seeded ``serve.batching.Request``s, one per (prompt, new) of ``spec``,
    numbered from ``first_rid``."""
    import torch
    from repro_torch.serve.batching import Request

    return [Request(first_rid + i, torch.randint(0, vocab, (L,), generator=gen, device=device,
                                     dtype=torch.int32).cpu().numpy(), n)
            for i, (L, n) in enumerate(spec)]


class BatchRecorder:
    """Wraps a ``ContinuousBatcher``'s prefill and decode step: each
    request's first-token logits (prefills run in submission order), each
    decode step's logits row of every slot that takes a token, by request,
    the step's wall (synchronised), and with ``routes`` every MoE layer's
    routing of each step (``moe._router``'s outputs), for the replay."""

    def __init__(self, b, routes: bool = False):
        import torch
        from repro_torch.models import moe

        self.first, self.rows, self.step_ms, self.steps = [], {}, [], []
        vocab, prefill, step = b.model.cfg.vocab, b._prefill, b._step

        def rec_prefill(batch):
            logits, caches = prefill(batch)
            self.first.append(logits[0, 0, :vocab].float().cpu())
            return logits, caches

        def rec_step(caches, tokens, pos):
            takes = [(int(b.rids[s]), s) for s in range(b.n_slots)
                     if b.positions[s] >= 0 and b.budget[s] > 0]
            router, layers = moe._router, []
            if routes:
                moe._router = lambda xf, w, c: layers.append(router(xf, w, c)) or layers[-1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                logits, caches = step(caches, tokens, pos)
                torch.cuda.synchronize()
            finally:
                moe._router = router
            self.step_ms.append((time.perf_counter() - t0) * 1e3)
            self.steps.append(layers)
            for rid, slot in takes:
                self.rows.setdefault(rid, []).append(
                    (logits[slot, 0, :vocab].float().cpu(), len(self.steps) - 1, slot))
            return logits, caches

        b._prefill, b._step = rec_prefill, rec_step


def hold_batch(label, model, reqs, got, rec, replay: bool = False) -> dict:
    """Each request alone through ``make_prefill`` + ``make_serve_step``,
    teacher-forced with the batcher's tokens: its first-token logits equal
    the batcher's bit for bit (the same (1, L) prefill); each decode
    step's logits within BATCH_TOL x max |logit| of the batcher's row; its
    token the batcher's wherever the top-2 margin exceeds that tolerance
    (the others counted). ``replay``: each decode step runs the MoE
    routing the batcher's step gave that slot (bf16 rounding in a batch of
    4 can flip a top-6 choice)."""
    import torch
    from repro_torch.models import moe
    from repro_torch.serve import engine

    prefill, step = engine.make_prefill(model), engine.make_serve_step(model)
    vocab, dev = model.cfg.vocab, model.device
    worst, flips, compared = 0.0, 0, 0
    router = moe._router
    for k, req in enumerate(reqs):
        toks, L = got[req.rid], len(req.prompt)
        if len(toks) != req.max_new_tokens or len(rec.rows.get(req.rid, [])) != len(toks) - 1:
            raise AssertionError(f"{label}: request {req.rid}: {len(toks)} tokens")
        logits, caches = prefill({"tokens": torch.as_tensor(req.prompt[None], device=dev)})
        if not torch.equal(logits[0, 0, :vocab].float().cpu(), rec.first[k]):
            raise AssertionError(f"{label}: request {req.rid}: first-token logits differ from "
                                 f"the same prefill alone")
        if int(rec.first[k].argmax()) != toks[0]:
            raise AssertionError(f"{label}: request {req.rid}: first token")
        caches = engine.extend_caches(model, caches, L, L + len(toks))
        for j, (row, s_idx, slot) in enumerate(rec.rows[req.rid]):
            if replay:
                layers = iter(rec.steps[s_idx])
                moe._router = lambda xf, w, c, it=layers, sl=slot: tuple(
                    t[sl:sl + 1] if t.dim() else t for t in next(it))
            try:
                lg, caches = step(caches, torch.tensor([[toks[j]]], dtype=torch.int32,
                                                       device=dev), L + j)
            finally:
                moe._router = router
            ref = lg[0, 0, :vocab].float().cpu()
            tol = BATCH_TOL * float(ref.abs().max())
            err = float((row - ref).abs().max())
            worst = max(worst, err / float(ref.abs().max()))
            if not (torch.isfinite(row).all() and err <= tol):
                raise AssertionError(f"{label}: request {req.rid} token {j + 1}: max abs diff "
                                     f"{err} > {tol}")
            top2 = ref.topk(2).values
            compared += 1
            if int(ref.argmax()) != toks[j + 1]:
                if float(top2[0] - top2[1]) > tol:
                    raise AssertionError(f"{label}: request {req.rid} token {j + 1} differs "
                                         f"past the tolerance")
                flips += 1
        del caches
    return dict(worst=worst, flips=flips, compared=compared)


def run_batch(device) -> dict:
    """Phase 12: continuous batching (``repro_torch.serve.batching``) on the
    card. qwen3-4b at full width and depth (bf16, flash) and
    deepseek-moe-16b (bf16) through ``ContinuousBatcher``, each run with
    every launch count set to 0 just before and read just after, each
    request held to itself alone (``hold_batch``); a float32 cut (2 layers,
    TF32 off) whose token streams must equal ``generate``'s. Returns the
    launches of every kernel summed over the two batcher runs."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import bitonic, flash
    from repro_torch.models import attention
    from repro_torch.models.model import Model
    from repro_torch.serve import engine
    from repro_torch.serve.batching import ContinuousBatcher

    t_phase = time.perf_counter()
    total = {fn.__name__: 0 for fn in (*bitonic.KERNELS, flash.flash_attention)}

    def batcher_run(label, model, reqs, n_slots, s_max, routes=False):
        """The main path: counts set to 0 just before, read just after."""
        b = ContinuousBatcher(model, n_slots=n_slots, s_max=s_max)
        rec = BatchRecorder(b, routes=routes)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        bitonic.reset_launches()
        flash.flash_attention.launches = 0
        t0 = time.perf_counter()
        got = b.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in bitonic.KERNELS}
        launches["flash_attention"] = flash.flash_attention.launches
        for k, v in launches.items():
            total[k] += v
        peak = torch.cuda.max_memory_allocated() / 1e9
        n_tok = sum(len(t) for t in got.values())
        step_ms = statistics.median(rec.step_ms)
        log(f"phase 12: {label}: {len(reqs)} requests ({sum(len(r.prompt) for r in reqs)} "
            f"prompt tokens, {n_tok} new) through {n_slots} slots of {s_max} in "
            f"{wall * 1e3:.3f} ms: {len(reqs) / wall:.4f} requests/s, {n_tok / wall:.2f} "
            f"tokens/s; {len(rec.step_ms)} decode steps, median {step_ms:.3f} ms "
            f"({n_slots / step_ms * 1e3:.2f} tokens/s at {n_slots} slots); peak "
            f"{peak:.3f} GB; launches {launches}")
        if sorted(got) != [r.rid for r in reqs]:
            raise AssertionError(f"phase 12: {label}: finished {sorted(got)}")
        return b, rec, got, launches

    def idle_share(label, b, vocab, gen):
        """One decode step of 4 busy slots under torch.profiler."""
        for r in batch_requests(gen, vocab, ((64, 8),) * b.n_slots, device, first_rid=1000):
            b.submit(r)
        b.step()  # admits them, one step
        wall, dev, events = device_breakdown(b.step)
        log(f"phase 12: {label}: one decode step of {b.n_slots} slots under torch.profiler: "
            f"{wall:.3f} ms wall, {dev:.3f} ms device (idle {1 - dev / wall:.3f}); largest "
            "device events: " + "; ".join(f"{n[:50]} {ms:.3f} ms" for n, ms in events[:5]))

    # qwen3-4b at full width and depth
    cfg = dataclasses.replace(get_config("qwen3-4b"), flash_attention=True, dtype="bfloat16")
    torch.cuda.empty_cache()
    model = Model(cfg, device=device, seed=0)
    gen = torch.Generator(device=device).manual_seed(12)
    reqs = batch_requests(gen, cfg.vocab, BATCH_REQS, device)
    b, rec, got, launches = batcher_run("qwen3-4b, bf16", model, reqs, BATCH_SLOTS, BATCH_SMAX)
    n_flash = cfg.n_layers * sum(len(r.prompt) >= attention.FLASH_MIN_SEQ for r in reqs)
    if launches["flash_attention"] != n_flash or n_flash < 2:
        raise AssertionError(f"phase 12: flash launches {launches['flash_attention']}, "
                             f"want {n_flash}")
    idle_share("qwen3-4b", b, cfg.vocab, gen)
    del b
    held = hold_batch("phase 12: qwen3-4b", model, reqs, got, rec)
    log(f"phase 12: qwen3-4b: each request alone, teacher-forced: first-token logits equal "
        f"bit for bit; decode logits within {held['worst']:.5f} x max |logit| (limit "
        f"{BATCH_TOL}); {held['flips']} of {held['compared']} tokens differ from the "
        f"single request's argmax within the tolerance, none beyond it")
    del model, rec
    torch.cuda.empty_cache()

    # the float32 cut: 2 layers at full width, TF32 off, tokens exact
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cut = dataclasses.replace(cfg, dtype="float32", n_layers=2,
                                  segments=((cfg.segments[0][0], 2),))
        model = Model(cut, device=device, seed=1)
        reqs = batch_requests(gen, cut.vocab, BATCH_F32, device)
        got = ContinuousBatcher(model, n_slots=2, s_max=1024 + 64).run(reqs)
        for r in reqs:
            alone = engine.generate(model, {"tokens": torch.as_tensor(r.prompt[None],
                                                                      device=device)},
                                    r.max_new_tokens)[0].tolist()
            if got[r.rid] != alone:
                raise AssertionError(f"phase 12: float32 cut, request {r.rid}: "
                                     f"{got[r.rid]} against generate's {alone}")
        log(f"phase 12: qwen3-4b cut to 2 layers in float32 (TF32 off), {len(reqs)} requests "
            f"through 2 slots: every token stream equals generate's")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    del model
    torch.cuda.empty_cache()

    # deepseek-moe-16b at full width and depth
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), flash_attention=True,
                              dtype="bfloat16")
    model = Model(cfg, device=device, seed=0)
    reqs = batch_requests(gen, cfg.vocab, BATCH_MOE, device)
    b, rec, got, launches = batcher_run("deepseek-moe-16b, bf16", model, reqs, 2,
                                        max(L for L, _ in BATCH_MOE) + 16, routes=True)
    n_moe = sum(sp.ffn == "moe" for sp in cfg.layer_list())
    want = {k: 0 for k in launches}
    for r in reqs:  # one sorted dispatch per MoE layer and prefill; decode gathers
        T = len(r.prompt)
        per = moe_dispatch_launches(T, cfg.moe_topk, 1, moe_capacity(
            T * cfg.moe_topk, 1, cfg.moe_capacity_factor))
        for k, v in per.items():
            want[k] += v * n_moe
    if launches != want or not launches["bitonic_sort_rows_kv"] > 0:
        raise AssertionError(f"phase 12: deepseek-moe-16b launches {launches}, derived {want}")
    idle_share("deepseek-moe-16b", b, cfg.vocab, gen)
    del b
    held = hold_batch("phase 12: deepseek-moe-16b", model, reqs, got, rec, replay=True)
    log(f"phase 12: deepseek-moe-16b: launches as derived ({n_moe} MoE layers a prefill); "
        f"each request alone with the batcher's routing replayed: first-token logits equal "
        f"bit for bit; decode logits within {held['worst']:.5f} x max |logit|; "
        f"{held['flips']} of {held['compared']} tokens differ within the tolerance")
    del model, rec
    torch.cuda.empty_cache()
    log(f"phase 12: launches over the two batcher runs: {total}; "
        f"{time.perf_counter() - t_phase:.1f} s; card {card_line()}")
    return total



# ----------------------------------------------------------------- phase 13

MLA_B, MLA_S, MLA_NEW = 2, 8192, 16  # prompts of 8192: flash serves S >= 8192
MLA_PARAMS = 15_111_101_440  # the 3 dense + 1 MoE cut (repro's param_count())
MLA_BATCH = ((512, 8), (2048, 8), (1024, 8), (1536, 8))  # 4 requests, 2 slots
MLA_LAYER_TOL = 1e-5  # check 1: card against CPU, of max |out|
MLA_TOL = 5e-2  # checks 2 and 3: of max |logit|, as phases 5, 10 and 12


def mla_config(dtype: str = "bfloat16"):
    """deepseek-v3-671b (``configs/deepseek_v3_671b.py``) cut in depth to
    its 3 dense MLA layers and 1 MLA + MoE layer, every width as published,
    flash on."""
    import dataclasses

    from repro_torch.configs.base import MLA_DENSE, MLA_MOE
    from repro_torch.configs.registry import get_config

    return dataclasses.replace(get_config("deepseek-v3-671b"), dtype=dtype,
                               flash_attention=True, n_layers=4,
                               segments=(((MLA_DENSE,), 3), ((MLA_MOE,), 1)))


PENDING = []  # checks whose CPU side runs in a thread while later phases use the card


def finish_pending() -> None:
    """Wait for every deferred CPU check (``PENDING``); raise if one failed."""
    while PENDING:
        PENDING.pop(0).result()


def mla_layer_on_both(device) -> None:
    """Phase 13's check 1: one MLA layer at full width in float32 (TF32
    off), a prefill of S = 8192 on the card (the FMA route of the flash
    kernel at (192, 128)) against the same layer and input on the CPU (the
    kernel's twin): the output and c_kv within MLA_LAYER_TOL x max |want|.
    k_pe is rope'd: the two devices' float32 rope tables (a ``pow`` and a
    ``cos`` / ``sin`` of angles up to 8191 rad) differ by up to ``rope``,
    which moves each rotated value by at most 2 x rope x max |k_pe before
    rope|; k_pe is held to MLA_LAYER_TOL x max plus that. The CPU side (40
    s and more) runs in a thread (``PENDING``) while the next phases use
    the card; ``main`` waits for it after phase 15."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from repro_torch.kernels import flash
    from repro_torch.models import attention
    from repro_torch.models.layers import rope_table

    cfg = mla_config("float32")
    gen = torch.Generator(device=device).manual_seed(31)
    layer = attention.MLA(cfg, gen, device)
    x = torch.randn((1, MLA_S, cfg.d_model), generator=gen, device=device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        before = flash.flash_attention.launches
        t0 = time.perf_counter()
        out, cache = attention.mla_forward(x, layer, cfg, cache={})
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
        if flash.flash_attention.launches != before + 1:
            raise AssertionError("phase 13: check 1: the float32 layer did not launch flash once")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    pos = torch.arange(MLA_S)
    rope = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        rope_table(pos.to(device), cfg.qk_rope_dim, cfg.rope_theta),
        rope_table(pos, cfg.qk_rope_dim, cfg.rope_theta)))
    got = {"out": out.cpu(), "c_kv": cache["c_kv"].cpu(), "k_pe": cache["k_pe"].cpu()}
    weights = {k: v.detach().cpu() for k, v in layer.state_dict().items()}
    x_cpu = x.cpu()
    del layer, out, cache, x

    def cpu_side():
        with torch.no_grad():
            layer_cpu = attention.MLA(cfg, None, "meta").to_empty(device="cpu")
            layer_cpu.load_state_dict(weights)
            t0 = time.perf_counter()
            want, want_cache = attention.mla_forward(x_cpu, layer_cpu, cfg, cache={})
            cpu_ms = (time.perf_counter() - t0) * 1e3
            raw = float((x_cpu @ layer_cpu.wkv_a)[..., cfg.kv_lora_rank:].abs().max())
        wants = {"out": want, "c_kv": want_cache["c_kv"], "k_pe": want_cache["k_pe"]}
        scales = {k: float(b.abs().max()) for k, b in wants.items()}
        errs = {k: float((got[k] - b).abs().max()) for k, b in wants.items()}
        limits = {k: MLA_LAYER_TOL * v for k, v in scales.items()}
        limits["k_pe"] += 2 * rope * raw
        log(f"phase 13: check 1: one MLA layer in float32 at full width, S = {MLA_S}: card "
            f"{card_ms:.3f} ms (flash's FMA route at (192, 128)), CPU {cpu_ms:.3f} ms (in a "
            "thread beside the next phases); max abs diff (limit): "
            + ", ".join(f"{k} {errs[k]:.3e} ({limits[k]:.3e}; max |want| {scales[k]:.3f})"
                        for k in errs)
            + f"; the rope tables differ by up to {rope:.3e}, k_pe before rope up to {raw:.3f}")
        if not all(errs[k] <= limits[k] for k in errs):
            raise AssertionError(f"phase 13: check 1: the card's float32 MLA layer is off the "
                                 f"CPU's: {errs}, limits {limits}")

    pool = ThreadPoolExecutor(1)
    PENDING.append(pool.submit(cpu_side))
    pool.shutdown(wait=False)


def run_mla(device) -> dict:
    """Phase 13: deepseek-v3-671b served on the card, cut to 3 dense MLA
    layers and 1 MLA + MoE layer at full width (bf16, seeded, flash):
    ``engine.generate`` of 2 prompts of 8192 tokens and 16 new is the main
    path (every count set to 0 just before, read just after; flash at
    (192, 128) once per layer, the dispatch's kv kernels as derived), then
    timed prefill and decode steps, and checks 1-5: a float32 layer card
    against CPU; the prefill against flash_attention=False with the routing
    replayed; each decode step against the teacher-forced forward, whose
    MoE layer takes the compared positions as decode does; (check 4, flash
    at MLA's shape against
    ``kernel_twin``, is phase 4's); the continuous batcher, each request
    held to itself alone. Returns the launches of every kernel over the
    main path."""
    import copy
    import dataclasses
    import gc

    import torch
    from repro_torch.kernels import bitonic, flash
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.serve import engine
    from repro_torch.serve.batching import ContinuousBatcher

    t_phase = time.perf_counter()
    cfg = mla_config()
    n_moe = sum(s.ffn == "moe" for s in cfg.layer_list())
    counted = Model(cfg, device="meta")  # the config's count, no allocation
    meta_params = sum(p.numel() for p in counted.parameters())
    del counted
    # phase 12's batchers and their recorders hold each other's closures:
    # a cycle, which keeps its model on the card until the collector runs
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device=device, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 13: deepseek-v3-671b cut to {cfg.n_layers} layers (3 dense MLA, {n_moe} MLA + "
        f"MoE: {cfg.n_experts} experts of {cfg.d_expert} + {cfg.n_shared_experts} shared, "
        f"top-{cfg.moe_topk}; d_model {cfg.d_model}, {cfg.n_heads} heads, q/kv LoRA ranks "
        f"{cfg.q_lora_rank}/{cfg.kv_lora_rank}, vocab {cfg.vocab}) built on the card in "
        f"{time.perf_counter() - t0:.2f} s: {n_params} parameters (the config counts "
        f"{meta_params} on the meta device), {torch.cuda.memory_allocated() / 1e9:.3f} GB")
    if not n_params == meta_params == cfg.param_count() == MLA_PARAMS:
        raise AssertionError(f"phase 13: {n_params} parameters, the config counts "
                             f"{cfg.param_count()}, want {MLA_PARAMS}")
    B, S, n_new, vocab, K = MLA_B, MLA_S, MLA_NEW, cfg.vocab, cfg.moe_topk
    gen = torch.Generator(device=device).manual_seed(15)
    batch = {"tokens": torch.randint(0, vocab, (B, S), generator=gen, device=device,
                                     dtype=torch.int32)}

    # the main path: generate, counts set to 0 just before and read just after
    torch.cuda.synchronize()
    bitonic.reset_launches()
    flash.flash_attention.launches = 0
    t0 = time.perf_counter()
    out = engine.generate(model, batch, n_new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in bitonic.KERNELS}
    launches["flash_attention"] = flash.flash_attention.launches
    per_layer = moe_dispatch_launches(B * S, K, 1, moe_capacity(B * S * K, 1,
                                                                cfg.moe_capacity_factor))
    want = {k: v * n_moe for k, v in per_layer.items()}
    want["flash_attention"] = cfg.n_layers
    log(f"phase 13: generate {B} x {S} prompt tokens + {n_new} new: {gen_s * 1e3:.3f} ms wall "
        f"(first call), launches {launches} (derived {want}: flash at (192, 128) once per "
        f"layer; per MoE layer {per_layer}, {B * S * K} assignments over {cfg.n_experts} "
        f"keys padded to {_pow2(B * S * K)}), tokens {out.tolist()}")
    if launches != want:
        raise AssertionError(f"phase 13: launches {launches}, derived {want}")
    if out.shape != (B, n_new) or not bool(((out >= 0) & (out < vocab)).all()):
        raise AssertionError(f"phase 13: tokens out of [0, {vocab}) or of shape {out.shape}")

    # prefill and decode timed; the prefill's and each decode step's
    # routing recorded (check 3)
    prefill, step = engine.make_prefill(model), engine.make_serve_step(model)
    router, pre_routes = moe._router, []
    moe._router = lambda xf, w, c: pre_routes.append(router(xf, w, c)) or pre_routes[-1]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill(batch)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
    finally:
        moe._router = router
    caches = engine.extend_caches(model, caches, S, S + n_new)
    if caches[0]["mix"]["c_kv"].shape != (B, S + n_new, cfg.kv_lora_rank):
        raise AssertionError("phase 13: the compressed caches were not extended")
    tok = logits[..., :vocab].argmax(-1).to(torch.int32)
    steps, step_ms, step_logits, step_routes = [tok], [], [], []
    for i in range(n_new - 1):
        routes = []
        moe._router = lambda xf, w, c, rs=routes: rs.append(router(xf, w, c)) or rs[-1]
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, caches = step(caches, tok, S + i)
            tok = lg[..., :vocab].argmax(-1).to(torch.int32)
            torch.cuda.synchronize()
        finally:
            moe._router = router
        step_ms.append((time.perf_counter() - t0) * 1e3)
        steps.append(tok)
        step_logits.append(lg[:, 0, :vocab].float())
        step_routes.append(routes)
    if not torch.equal(torch.cat(steps, dim=1), out):
        raise AssertionError("phase 13: the timed prefill and steps gave other tokens")
    wall, dev, events = device_breakdown(lambda: step(caches, tok, S + n_new - 1))
    log(f"phase 13: one decode step under torch.profiler: {wall:.3f} ms wall, {dev:.3f} ms "
        f"device (idle {1 - dev / wall:.3f}); largest device events: " + "; ".join(
            f"{name[:60]} {ms:.3f} ms ({ms / dev:.3f})" for name, ms in events[:8]))
    del caches
    decode_ms = statistics.median(step_ms)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"phase 13: prefill {prefill_ms:.3f} ms, decode {decode_ms:.3f} ms a step (median of "
        f"{len(step_ms)}), {B / decode_ms * 1e3:.3f} tokens/s, peak {peak_gb:.3f} GB; card "
        f"{card_line()}")
    mla_flash_times("phase 13", gen, device)

    # check 2: the prefill against the same weights read with
    # flash_attention=False (the chunked path, no flash), the plain
    # prefill's routing replayed into the flash prefill (phase 10's way)
    plain = copy.copy(model)
    plain.cfg = dataclasses.replace(cfg, flash_attention=False)
    routes = []
    before = flash.flash_attention.launches
    moe._router = lambda xf, w, c: routes.append(router(xf, w, c)) or routes[-1]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref, _ = engine.make_prefill(plain)(batch)
        torch.cuda.synchronize()
        plain_prefill_ms = (time.perf_counter() - t0) * 1e3
    finally:
        moe._router = router
    if flash.flash_attention.launches != before:
        raise AssertionError("phase 13: check 2: the flash_attention=False prefill launched "
                             "flash")
    replay = iter(routes)
    moe._router = lambda xf, w, c: next(replay)
    try:
        pinned, _ = prefill(batch)
    finally:
        moe._router = router
    if flash.flash_attention.launches != before + cfg.n_layers or next(replay, None):
        raise AssertionError("phase 13: check 2: the replayed flash prefill ran another path")
    got, pinned, ref = logits.float(), pinned.float(), ref.float()
    scale = float(ref.abs().max())
    diff, pin_diff = float((got - ref).abs().max()), float((pinned - ref).abs().max())
    log(f"phase 13: check 2: prefill logits vs flash_attention=False ({plain_prefill_ms:.3f} "
        f"ms), max |logit| {scale:.4f}: with the plain prefill's routing replayed max abs diff "
        f"{pin_diff:.4f} ({pin_diff / scale:.5f} of it, limit {MLA_TOL}); routed on its own "
        f"{diff:.4f}")
    if not (torch.isfinite(got).all() and torch.isfinite(pinned).all()
            and pin_diff <= MLA_TOL * scale):
        raise AssertionError("phase 13: check 2: the flash prefill disagrees with the plain one")
    del plain, ref, pinned, routes

    # check 3: each decode step against the teacher-forced forward of the
    # prompt and the generated tokens (a prefill of S + n_new - 1). The MoE
    # layer is the last one, so a position's expert output reaches only its
    # own logits; at the compared positions it is taken as decode takes it
    # (``moe_forward_decode``, each token's top-k experts gathered, with
    # the decode step's routing replayed) on the forward's own hidden
    # states. The sorted dispatch would drop what passes an expert's
    # capacity, and the batch's last tokens are the first it drops; decode
    # drops nothing. The served prefill's drops at the config's capacity
    # factor are counted
    full = torch.cat([batch["tokens"], out[:, :-1]], dim=1)
    Sf = full.shape[1]
    (_, pi, _), = pre_routes  # one MoE layer
    cap = int(B * S * K // cfg.n_experts * cfg.moe_capacity_factor) + 1  # cap_e, one rank
    load = torch.bincount(pi.reshape(-1).long(), minlength=cfg.n_experts)
    dropped = int((load - cap).clamp_min(0).sum())
    dispatch = moe.moe_forward

    def decode_rows(h, layer, c, **kw):
        mo, aux = dispatch(h, layer, c, **kw)
        for i, routes in enumerate(step_routes):
            (route,) = routes  # one MoE layer
            moe._router = lambda xf, w, cc, r=route: r
            try:
                mo[:, S + i:S + i + 1] = moe.moe_forward_decode(h[:, S + i:S + i + 1], layer, c)[0]
            finally:
                moe._router = router
        return mo, aux

    moe.moe_forward = decode_rows
    try:
        tf, _, _ = model({"tokens": full}, caches=model.init_caches(B, Sf))
    finally:
        moe.moe_forward = dispatch
    worst = 0.0
    for i, lg in enumerate(step_logits):
        ref = tf[:, S + i, :vocab].float()
        err = float((lg - ref).abs().max()) / float(ref.abs().max())
        worst = max(worst, err)
        if not (torch.isfinite(lg).all() and err <= MLA_TOL):
            raise AssertionError(f"phase 13: check 3: decode step {i} is {err} x max |logit| "
                                 f"off the teacher-forced forward")
    log(f"phase 13: check 3: {len(step_logits)} decode steps (absorbed products over the "
        f"compressed caches) against the teacher-forced forward of {Sf} tokens (expanded k "
        f"and v, flash; the compared positions' experts gathered as decode gathers them, "
        f"routing replayed): within {worst:.5f} x max |logit| (limit {MLA_TOL}). The served "
        f"prefill at capacity factor {cfg.moe_capacity_factor}: busiest expert "
        f"{int(load.max())} assignments (mean {B * S * K / cfg.n_experts:.0f}) against a "
        f"capacity of {cap}; {dropped} of {B * S * K} assignments dropped")
    del tf, logits, got, step_logits, step_routes, pre_routes
    torch.cuda.empty_cache()

    mla_layer_on_both(device)  # check 1
    torch.cuda.empty_cache()

    # check 5: continuous batching, each request held to itself alone with
    # the batcher's routing replayed
    reqs = batch_requests(gen, vocab, MLA_BATCH, device, first_rid=0)
    b = ContinuousBatcher(model, n_slots=2, s_max=max(L for L, _ in MLA_BATCH) + 16)
    rec = BatchRecorder(b, routes=True)
    torch.cuda.synchronize()
    bitonic.reset_launches()
    flash.flash_attention.launches = 0
    t0 = time.perf_counter()
    got = b.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    batch_launches = {fn.__name__: fn.launches for fn in bitonic.KERNELS}
    batch_launches["flash_attention"] = flash.flash_attention.launches
    want = {k: 0 for k in batch_launches}
    for r in reqs:  # one sorted dispatch per MoE layer and prefill; no flash below 8192
        T = len(r.prompt)
        per = moe_dispatch_launches(T, K, 1, moe_capacity(T * K, 1, cfg.moe_capacity_factor))
        for k, v in per.items():
            want[k] += v * n_moe
    if sorted(got) != [r.rid for r in reqs] or batch_launches != want:
        raise AssertionError(f"phase 13: check 5: finished {sorted(got)}, launches "
                             f"{batch_launches}, derived {want}")
    del b
    held = hold_batch("phase 13: check 5", model, reqs, got, rec, replay=True)
    n_tok = sum(len(t) for t in got.values())
    log(f"phase 13: check 5: {len(reqs)} requests ({sum(len(r.prompt) for r in reqs)} prompt "
        f"tokens, {n_tok} new) through ContinuousBatcher(n_slots=2) in {wall * 1e3:.3f} ms "
        f"({len(reqs) / wall:.4f} requests/s, median decode step "
        f"{statistics.median(rec.step_ms):.3f} ms), launches as derived {batch_launches}; "
        f"each request alone with the batcher's routing replayed: first-token logits equal "
        f"bit for bit, decode logits within {held['worst']:.5f} x max |logit|, "
        f"{held['flips']} of {held['compared']} tokens differ within the tolerance")
    del model, rec
    torch.cuda.empty_cache()
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ----------------------------------------------------------------- phase 14

# (arch, prompts, prompt length, new tokens, parameters as repro's
# param_count() counts them at full width and depth, the dtype check 2
# holds). In bf16 falcon-mamba's decode drifts from its teacher-forced
# forward with depth, past REC_TOL at its 64 layers, and a float32 cut
# does not drift (tools/rec_decode_drift.py; PERF.md §6): bf16 rounding
# of the decode's and the prefill's GEMMs, which differ in shape,
# compounds over the depth. Its check 2 runs on the served weights in
# float32, where the path, not the rounding, is held; its bf16 errors are
# printed.
REC_RUNS = (("falcon-mamba-7b", 2, 4096, 16, 2_217_545_728, "float32"),
            ("recurrentgemma-9b", 2, 8192, 16, 8_578_199_552, "bfloat16"))
REC_MAMBA_LAYERS = 16  # falcon-mamba-7b's first 16 of its 64 layers: the smoke's time
REC_RESLOT = 1024  # recurrentgemma's third request: shorter than its window
REC_LAYER_TOL = 1e-5  # check 1: card against CPU, of max |CPU|
REC_TOL = 5e-2  # checks 2 and 3: of max |logit| and of max |k|, |v|, as phase 13
REC_PAD = 512  # the teacher-forced forward's length: a multiple of SCAN_CHUNK and Q_CHUNK


def rec_config(arch: str, dtype: str = "bfloat16"):
    """The published config at full width; recurrentgemma at full depth
    with flash_attention=True, so that its window alone keeps flash off;
    falcon-mamba cut to its first REC_MAMBA_LAYERS of 64 layers, so that
    phase 18 fits the run's time."""
    import dataclasses

    from repro_torch.configs.registry import get_config

    cfg = dataclasses.replace(get_config(arch), dtype=dtype)
    if cfg.sliding_window:
        cfg = dataclasses.replace(cfg, flash_attention=True)
    if arch == "falcon-mamba-7b":
        period = cfg.segments[0][0]
        cfg = dataclasses.replace(cfg, segments=((period, REC_MAMBA_LAYERS),),
                                  n_layers=REC_MAMBA_LAYERS)
    return cfg


def rec_layers_on_both(device) -> None:
    """Phase 14's check 1: one Mamba and one RG-LRU layer at full width, S
    = 1024 (four scan chunks), and one local-attention layer at full width,
    S = 4096 (band 2560 < 4096: the keys sliced), each in float32 (TF32
    off) on the card and on the CPU, the same weights and input: output and
    cache within REC_LAYER_TOL x max |CPU|. The local layer's cache is its
    ring of the last 2048 keys and values; the two devices' float32 rope
    tables differ by up to ``rope``, which moves each rotated key by at most
    2 x rope x its largest magnitude before rope, added to k's limit."""
    import torch
    from repro_torch.models import attention, recurrent
    from repro_torch.models.layers import rope_table

    cases = (("mamba", "falcon-mamba-7b", 1024, recurrent.Mamba, recurrent.mamba_forward,
              lambda c: recurrent.init_mamba_cache(c, 1, device)),
             ("rglru", "recurrentgemma-9b", 1024, recurrent.RGLRU, recurrent.rglru_forward,
              lambda c: recurrent.init_rglru_cache(c, 1, device)),
             ("local_attn", "recurrentgemma-9b", 4096, attention.Attention,
              lambda x, p, c, cache: attention.gqa_forward(x, p, c, window=c.sliding_window,
                                                           cache=cache),
              lambda c: attention.init_gqa_cache(c, 1, 4096, c.sliding_window, device)))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name, arch, S, cls, fwd, init_cache in cases:
            cfg = rec_config(arch, "float32")
            gen = torch.Generator(device=device).manual_seed(41)
            layer = cls(cfg, gen, device)
            x = torch.randn((1, S, cfg.d_model), generator=gen, device=device)
            t0 = time.perf_counter()
            out, cache = fwd(x, layer, cfg, cache=init_cache(cfg))
            torch.cuda.synchronize()
            card_ms = (time.perf_counter() - t0) * 1e3
            layer_cpu = cls(cfg, None, "meta").to_empty(device="cpu")
            layer_cpu.load_state_dict({k: v.cpu() for k, v in layer.state_dict().items()})
            cache_cpu = {k: v.cpu() for k, v in init_cache(cfg).items()}
            t0 = time.perf_counter()
            want, want_cache = fwd(x.cpu(), layer_cpu, cfg, cache=cache_cpu)
            cpu_ms = (time.perf_counter() - t0) * 1e3
            pairs = {"out": (out, want), **{k: (cache[k], want_cache[k]) for k in want_cache
                                            if k != "pos"}}
            scales = {k: float(b.float().abs().max()) for k, (a, b) in pairs.items()}
            errs = {k: float((a.cpu().float() - b.float()).abs().max())
                    for k, (a, b) in pairs.items()}
            limits = {k: REC_LAYER_TOL * v for k, v in scales.items()}
            extra = ""
            if "pos" in want_cache:
                if not torch.equal(cache["pos"].cpu(), want_cache["pos"]):
                    raise AssertionError("phase 14: check 1: the ring's positions differ")
                pos = torch.arange(S)
                rope = max(float((a.cpu() - b).abs().max()) for a, b in zip(
                    rope_table(pos.to(device), cfg.head_dim, cfg.rope_theta),
                    rope_table(pos, cfg.head_dim, cfg.rope_theta)))
                raw = float((x.cpu() @ layer_cpu.wk).abs().max())
                limits["k"] += 2 * rope * raw
                extra = (f"; the rope tables differ by up to {rope:.3e}, k before rope up to "
                         f"{raw:.3f}")
            log(f"phase 14: check 1: one {name} layer of {arch} in float32 at full width, S = "
                f"{S}: card {card_ms:.3f} ms, CPU {cpu_ms:.3f} ms; max abs diff (limit): "
                + ", ".join(f"{k} {errs[k]:.3e} ({limits[k]:.3e}; max |CPU| {scales[k]:.3f})"
                            for k in errs) + extra)
            if not all(errs[k] <= limits[k] for k in errs):
                raise AssertionError(f"phase 14: check 1: the card's float32 {name} layer is "
                                     f"off the CPU's: {errs}, limits {limits}")
            del layer, layer_cpu, out, cache, want, want_cache, x
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def layer_split(fn, ranges: dict, gemms=("aten::mm", "aten::bmm"), kernels=None) -> tuple:
    """One ``fn()`` (a layer's prefill) under ``torch.profiler``: (wall ms,
    device ms, {range: ms, ..., kernel: ms, ..., "gemm": ms, "rest": ms}).
    ``ranges`` maps a name to (module, function name): every call of that
    function is wrapped in a ``record_function`` range of that name for
    this run only, and the range's time is the device time of the kernels
    it launched. ``kernels`` maps a name to a part of device kernels'
    names, for the port's own kernels: launched through ctypes, they are
    traced on the device but tied to no op or range on the host. "gemm" is
    the device time of the ops named in ``gemms`` outside every range, and
    "rest" the remaining device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(name, fn):
        def call(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return call

    saved = {name: getattr(mod, attr) for name, (mod, attr) in ranges.items()}
    for name, (mod, attr) in ranges.items():
        setattr(mod, attr, ranged(name, saved[name]))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        for name, (mod, attr) in ranges.items():
            setattr(mod, attr, saved[name])

    def self_us(e) -> float:
        v = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if v is None else v

    def total_us(e) -> float:
        v = getattr(e, "device_time_total", None)
        return e.cuda_time_total if v is None else v

    def within(e) -> bool:
        p = e.cpu_parent
        while p is not None:
            if p.name in ranges:
                return True
            p = p.cpu_parent
        return False

    # each range also appears as a device-side annotation spanning its
    # kernels: left out of the device sum, and a range's time is the
    # host-side range's (the kernels it launched)
    events = prof.events()
    on_host = [e for e in events if not str(e.device_type).endswith("CUDA")]
    dev = sum(self_us(e) for e in events
              if str(e.device_type).endswith("CUDA") and e.name not in ranges) / 1e3
    if dev == 0:
        raise AssertionError("the profiler recorded no device time")
    split = {name: sum(total_us(e) for e in on_host if e.name == name) / 1e3 for name in ranges}
    for name, part in (kernels or {}).items():
        split[name] = sum(self_us(e) for e in events
                          if str(e.device_type).endswith("CUDA") and part in e.name) / 1e3
    split["gemm"] = sum(total_us(e) for e in on_host
                        if e.name in gemms and not within(e)) / 1e3
    split["rest"] = dev - sum(split.values())
    return wall, dev, split


def teacher_forced(model, tokens, memory=None):
    """The logits and caches of one forward over ``tokens`` padded at the
    end to a multiple of REC_PAD (the scan's and the query chunks'
    lengths), with ``memory`` (a dict of ``frames`` or ``vision``) beside
    them: every decoder mixer is causal, so the padding changes no earlier
    position."""
    import torch

    memory = memory or {}
    B, S = tokens.shape
    pad = -S % REC_PAD
    full = torch.cat([tokens, tokens.new_zeros((B, pad))], dim=1)
    M = next((v.shape[1] for v in memory.values()), 0)
    logits, caches, _ = model({"tokens": full, **memory},
                              caches=model.init_caches(B, S + pad, memory_len=M))
    return logits[:, :S], caches


def ring_check(label, model, cfg, caches, teacher_caches, n_filled: int) -> float:
    """Check 3: in each local-attention layer's ring, every slot s that
    holds a position (pos[s] >= 0) holds it at s = pos[s] % W, and its k
    and v equal the teacher-forced forward's at that position (its ring,
    a prefill of at most the window, holds every position densely) within
    REC_TOL x max; ``n_filled`` slots hold one. Returns the worst
    relative difference."""
    import torch

    worst = 0.0
    for spec, c, t in zip(cfg.layer_list(), caches, teacher_caches, strict=True):
        if spec.mixer != "local_attn":
            continue
        ring, full = c["mix"], t["mix"]
        W = ring["k"].shape[1]
        pos = ring["pos"].long()
        held = pos >= 0
        slots = torch.arange(W, device=pos.device)
        if int(held.sum()) != n_filled or not bool((pos[held] % W == slots[held]).all()):
            raise AssertionError(f"{label}: check 3: the ring's positions {pos.tolist()[:8]}... "
                                 f"are not at their slots")
        if not bool((full["pos"].long() == torch.arange(full["pos"].shape[0],
                                                        device=pos.device)).all()):
            raise AssertionError(f"{label}: check 3: the teacher-forced ring is not dense")
        for name in ("k", "v"):
            got = ring[name][:, held].float()
            want = full[name][:, pos[held]].float()
            err = float((got - want).abs().max()) / float(want.abs().max())
            worst = max(worst, err)
            if err > REC_TOL:
                raise AssertionError(f"{label}: check 3: ring {name} is {err} x max off the "
                                     f"teacher-forced forward's")
    return worst


def rec_step_errors(step_logits, tf, S: int, vocab: int) -> list:
    """Each decode step's largest |logit - teacher-forced logit|, as a
    fraction of the teacher-forced step's largest |logit| (inf where the
    step's logits are not finite)."""
    import torch

    errs = []
    for i, lg in enumerate(step_logits):
        ref = tf[:, S + i, :vocab].float()
        err = float((lg - ref).abs().max()) / float(ref.abs().max())
        errs.append(err if bool(torch.isfinite(lg).all()) else float("inf"))
    return errs


def decode_against_teacher(model, batch, n_new: int) -> tuple:
    """Greedy prefill and n_new - 1 decode steps, then each step's logits
    against the teacher-forced forward of the prompt and the tokens fed
    (``rec_step_errors``). Returns (errors, the forward's length)."""
    import torch
    from repro_torch.serve import engine

    vocab = model.cfg.vocab
    S = batch["tokens"].shape[1]
    prefill, step = engine.make_prefill(model), engine.make_serve_step(model)
    logits, caches = prefill(batch)
    caches = engine.extend_caches(model, caches, S, S + n_new)
    tok = logits[..., :vocab].argmax(-1).to(torch.int32)
    fed, step_logits = [], []
    for i in range(n_new - 1):
        fed.append(tok)
        lg, caches = step(caches, tok, S + i)
        tok = lg[..., :vocab].argmax(-1).to(torch.int32)
        step_logits.append(lg[:, 0, :vocab].float())
    del caches, logits
    full = torch.cat([batch["tokens"], *fed], dim=1)
    tf, _ = teacher_forced(model, full)
    return rec_step_errors(step_logits, tf, S, vocab), full.shape[1]


def serve_rec(device, arch, B, S, n_new, want_params, check_dtype) -> dict:
    """One model of phase 14: built on the card, ``engine.generate`` of B
    prompts of S tokens and n_new new (every count set to 0 just before and
    read just after: no kernel of the port runs on this path), then timed
    prefill and decode steps, one decode step under torch.profiler, one
    recurrent layer's prefill split, peak memory, check 2 (each decode
    step's logits against the teacher-forced forward; in ``check_dtype``:
    float32 converts the served weights, TF32 off) and, with a window,
    check 3. Returns the launches of the main path."""
    import dataclasses
    import gc

    import torch
    from repro_torch.models import recurrent
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model import Model
    from repro_torch.serve import engine

    t_model = time.perf_counter()
    cfg = rec_config(arch)
    counted = Model(cfg, device="meta")
    meta_params = sum(p.numel() for p in counted.parameters())
    del counted
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device=device, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    kinds = sorted({s.mixer for s in cfg.layer_list()})
    log(f"phase 14: {arch} ({cfg.n_layers} layers: {', '.join(kinds)}; d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}) built on the card in {time.perf_counter() - t0:.2f} "
        f"s: {n_params} parameters (the config counts {meta_params} on the meta device), "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    if not n_params == meta_params == cfg.param_count() == want_params:
        raise AssertionError(f"phase 14: {arch}: {n_params} parameters, the config counts "
                             f"{cfg.param_count()}, want {want_params}")
    vocab = cfg.vocab
    gen = torch.Generator(device=device).manual_seed(23)
    batch = {"tokens": torch.randint(0, vocab, (B, S), generator=gen, device=device,
                                     dtype=torch.int32)}

    # the main path: generate, counts set to 0 just before and read just after
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = engine.generate(model, batch, n_new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = launch_counts()
    log(f"phase 14: {arch}: generate {B} x {S} prompt tokens + {n_new} new: "
        f"{gen_s * 1e3:.3f} ms wall (first call), launches {launches}, tokens {out.tolist()}")
    if any(launches.values()):
        raise AssertionError(f"phase 14: {arch}: a kernel launched on the recurrent path: "
                             f"{launches}")
    if out.shape != (B, n_new) or not bool(((out >= 0) & (out < vocab)).all()):
        raise AssertionError(f"phase 14: {arch}: tokens out of [0, {vocab}) or of shape "
                             f"{out.shape}")

    prefill, step = engine.make_prefill(model), engine.make_serve_step(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = prefill(batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    caches = engine.extend_caches(model, caches, S, S + n_new)
    tok = logits[..., :vocab].argmax(-1).to(torch.int32)
    steps, step_ms, step_logits = [tok], [], []
    for i in range(n_new - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, caches = step(caches, tok, S + i)
        tok = lg[..., :vocab].argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        steps.append(tok)
        step_logits.append(lg[:, 0, :vocab].float())
    if not torch.equal(torch.cat(steps, dim=1), out):
        raise AssertionError(f"phase 14: {arch}: the timed prefill and steps gave other tokens")
    if cfg.sliding_window:  # the roll branch: every slot at pos % W
        for spec, c in zip(cfg.layer_list(), caches, strict=True):
            if spec.mixer == "local_attn":
                pos = c["mix"]["pos"].long()
                if not bool((pos % pos.numel() == torch.arange(pos.numel(),
                                                               device=pos.device)).all()):
                    raise AssertionError(f"phase 14: {arch}: a rolled ring is out of place")
    wall, dev, events = device_breakdown(lambda: step(caches, tok, S + n_new - 1))
    log(f"phase 14: {arch}: one decode step under torch.profiler: {wall:.3f} ms wall, "
        f"{dev:.3f} ms device (idle {1 - dev / wall:.3f}); largest device events: " + "; ".join(
            f"{name[:60]} {ms:.3f} ms ({ms / dev:.3f})" for name, ms in events[:6]))
    del caches
    decode_ms = statistics.median(step_ms)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"phase 14: {arch}: prefill {prefill_ms:.3f} ms ({B * S / prefill_ms * 1e3:.1f} "
        f"tokens/s), decode {decode_ms:.3f} ms a step (median of {len(step_ms)}), "
        f"{B / decode_ms * 1e3:.3f} tokens/s, peak {peak_gb:.3f} GB; card {card_line()}")

    # one recurrent layer's prefill (the first), split by the profiler,
    # on the first layer's input
    first = cfg.layer_list()[0]
    h = model.embed.table[batch["tokens"]]
    if cfg.name.startswith("recurrentgemma"):
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype, device=h.device)
    cache0 = tfm.init_block_cache(first, cfg, B, S, device)
    fn = lambda: tfm.apply_block(h, model.layers[0], first, cfg,  # noqa: E731
                                 positions=torch.arange(S, device=device), cache=cache0)
    fn()
    wall, dev, split = layer_split(fn, {"scan": (recurrent, "_assoc_scan")})
    log(f"phase 14: {arch}: one {first.mixer} layer's prefill ({B} x {S}, its block with "
        f"{first.ffn} FFN) under torch.profiler: {wall:.3f} ms wall, {dev:.3f} ms device; "
        + ", ".join(f"{k} {v:.3f} ms ({v / dev:.3f})" for k, v in split.items()))
    del h, cache0

    # check 2: each decode step against the teacher-forced forward of the
    # prompt and the generated tokens
    full = torch.cat([batch["tokens"], out[:, :-1]], dim=1)
    tf, tf_caches = teacher_forced(model, full)
    del tf_caches
    errs = rec_step_errors(step_logits, tf, S, vocab)
    held = check_dtype == cfg.dtype
    log(f"phase 14: {arch}: {'check 2' if held else 'bf16 decode'}: {len(step_logits)} decode "
        f"steps (one recurrence step from the carried state"
        f"{', the rings' if cfg.sliding_window else ''}) against the teacher-forced forward of "
        f"{full.shape[1]} tokens (padded to {full.shape[1] + (-full.shape[1] % REC_PAD)}): x "
        f"max |logit| by step {[round(e, 5) for e in errs]}, worst {max(errs):.5f}"
        + (f" (limit {REC_TOL})" if held else " (held in float32 below)"))
    if held and max(errs) > REC_TOL:
        raise AssertionError(f"phase 14: {arch}: check 2: a decode step is {max(errs)} x max "
                             f"|logit| off the teacher-forced forward")
    del tf, logits, step_logits

    if cfg.sliding_window:
        # check 3: a request shorter than the window: extend_caches
        # re-slots its ring, 16 steps fill it; each slot against the
        # teacher-forced k/v of the position it names
        L = REC_RESLOT
        one = {"tokens": torch.randint(0, vocab, (1, L), generator=gen, device=device,
                                       dtype=torch.int32)}
        logits, caches = prefill(one)
        W = next(c["mix"]["k"].shape[1] for s, c in zip(cfg.layer_list(), caches, strict=True)
                 if s.mixer == "local_attn")
        caches = engine.extend_caches(model, caches, L, L + n_new)
        tok = logits[..., :vocab].argmax(-1).to(torch.int32)
        fed = []
        for i in range(n_new):
            fed.append(tok)
            lg, caches = step(caches, tok, L + i)
            tok = lg[..., :vocab].argmax(-1).to(torch.int32)
        _, tf_caches = teacher_forced(model, torch.cat([one["tokens"], *fed], dim=1))
        worst = ring_check(f"phase 14: {arch}", model, cfg, caches, tf_caches, L + n_new)
        log(f"phase 14: {arch}: check 3: a request of {L} tokens (ring of {W} after prefill, "
            f"re-slotted to {min(cfg.sliding_window, L + n_new)} by extend_caches) and "
            f"{n_new} decode steps: every slot s holds pos[s] with pos[s] % W == s, its k and "
            f"v within {worst:.5f} x max of the teacher-forced forward's (limit {REC_TOL})")
        del caches, tf_caches
    if check_dtype == "float32" and cfg.dtype != "float32":
        # check 2 on the served weights in float32, TF32 off
        t0 = time.perf_counter()
        model.float()
        model.cfg = dataclasses.replace(cfg, dtype="float32")
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            errs, n_tf = decode_against_teacher(model, batch, n_new)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        log(f"phase 14: {arch}: check 2: the served weights in float32 (TF32 off), "
            f"{len(errs)} decode steps against the teacher-forced forward of {n_tf} tokens: x "
            f"max |logit| by step {[f'{e:.2e}' for e in errs]}, worst {max(errs):.3e} (limit "
            f"{REC_TOL}); {time.perf_counter() - t0:.1f} s")
        if max(errs) > REC_TOL:
            raise AssertionError(f"phase 14: {arch}: check 2: a float32 decode step is "
                                 f"{max(errs)} x max |logit| off the teacher-forced forward")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 14: {arch}: {time.perf_counter() - t_model:.1f} s")
    return launches


def run_recurrent(device) -> dict:
    """Phase 14: falcon-mamba-7b (16 Mamba layers) and recurrentgemma-9b
    (RG-LRU and local attention, window 2048) at full width and depth
    (bf16, seeded), each served through ``engine.generate`` and checked
    (``serve_rec``: checks 2 and 3), then check 1 (``rec_layers_on_both``). No kernel of the port lies on
    these paths (the scan is plain PyTorch, as ``repro``'s is plain jnp;
    flash never serves a window; neither model has experts). Returns the
    launches over both main paths, all 0."""
    import torch

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    total = None
    for arch, B, S, n_new, want_params, check_dtype in REC_RUNS:
        launches = serve_rec(device, arch, B, S, n_new, want_params, check_dtype)
        total = launches if total is None else {k: total[k] + v for k, v in launches.items()}
    rec_layers_on_both(device)
    torch.cuda.empty_cache()
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s")
    return total


# ----------------------------------------------------------------- phase 15

# (arch, prompts, prompt length, memory length, new tokens, parameters as
# repro's param_count() counts them at full width and depth). whisper's
# real 1500 frames are refused past one query chunk (a multiple of
# Q_CHUNK = 512, in repro too): it serves 1536 stub frames.
CROSS_RUNS = (("whisper-base", 8, 4, 1536, 64, 97_346_560),
              ("llama-3.2-vision-11b", 2, 8192, 1600, 16, 10_110_734_344))
CROSS_LAYER_TOL = 1e-5  # check 1: card against CPU, of max |CPU|
CROSS_TOL = 5e-2  # checks 2 and 3: of max |logit|
CROSS_LIVE = 1e-3  # check 5: the gates at 0 move the logits by more, of max |logit|


def cross_config(arch: str, dtype: str = "bfloat16"):
    """The published config at full width and depth; the VLM with
    flash_attention=True, so that its 8192-token prefill takes the kernel."""
    import dataclasses

    from repro_torch.configs.registry import get_config

    cfg = dataclasses.replace(get_config(arch), dtype=dtype)
    if cfg.n_vision_tokens:
        cfg = dataclasses.replace(cfg, flash_attention=True)
    return cfg


def seed_gates(blocks, gen) -> list:
    """Each cross gate of ``blocks`` (zero at init, which would hide the
    cross path) set to a seeded value uniform in +-[0.5, 1.5]. Returns the
    gates."""
    import torch

    gates = [b.cross.gate for b in blocks
             if getattr(b, "cross", None) is not None and b.cross.gate is not None]
    for g in gates:
        u = torch.rand((2,), generator=gen, device=g.device)
        g.copy_((0.5 + u[0]) * torch.where(u[1] < 0.5, -1.0, 1.0))
    return gates


def cross_projections(model, memory) -> list:
    """Each cross block's k and v projections of ``memory``, as its cache
    holds them."""
    from repro_torch.models import attention

    out = []
    for block, spec in zip(model.layers, model.cfg.layer_list(), strict=True):
        if spec.cross:
            p, (B, M, _) = block.cross, memory.shape
            shape = (B, M, model.cfg.n_kv_heads, model.cfg.head_dim)
            out.append({"ck": attention._proj(memory, p.wk, p.bk).reshape(shape),
                        "cv": attention._proj(memory, p.wv, p.bv).reshape(shape)})
    return out


def cross_caches(model, caches) -> list:
    return [c["cross"] for spec, c in zip(model.cfg.layer_list(), caches, strict=True)
            if spec.cross]


def cross_layers_on_both(device) -> None:
    """Phase 15's check 1: one VLM cross block (self-attention, then
    cross-attention over 1600 memory tokens, then the MLP) at full width, S
    = 2048, as a prefill with its caches, and one whisper encoder layer at
    S_enc = 1536 (three query chunks, non-causal, no rope), each in float32
    (TF32 off) on the card and on the CPU, the same weights and input:
    output and caches within CROSS_LAYER_TOL x max |CPU|. The two devices'
    float32 rope tables differ by up to ``rope``, which moves each rotated
    self-attention key by at most 2 x rope x its largest magnitude before
    rope, added to k's limit, as phase 14's check 1 adds it."""
    import torch
    from repro_torch.models import attention
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import apply_norm, rope_table

    cases = (("llama-3.2-vision-11b", 2048, 1600), ("whisper-base", 1536, 0))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for arch, S, M in cases:
            cfg = cross_config(arch, "float32")
            spec = (next(s for s in cfg.layer_list() if s.cross) if M
                    else tfm.segment_specs(cfg.encoder_segments)[0])
            gen = torch.Generator(device=device).manual_seed(43)
            block = tfm.Block(spec, cfg, gen, device)
            seed_gates([block], gen)
            x = torch.randn((1, S, cfg.d_model), generator=gen, device=device)
            mem = torch.randn((1, M, cfg.d_model), generator=gen, device=device) if M else None
            pos = torch.arange(S, device=device)

            def run(b, x, mem, pos, dev):
                cache = (tfm.init_block_cache(spec, cfg, 1, S, dev, memory_len=M) if M
                         else None)
                out, cache, _ = tfm.apply_block(x, b, spec, cfg, positions=pos, cache=cache,
                                                memory=mem)
                return {"out": out, **({f"{part}.{k}": t for part, c in cache.items()
                                        for k, t in c.items()} if cache else {})}

            t0 = time.perf_counter()
            got = run(block, x, mem, pos, device)
            torch.cuda.synchronize()
            card_ms = (time.perf_counter() - t0) * 1e3
            block_cpu = tfm.Block(spec, cfg, None, "meta").to_empty(device="cpu")
            block_cpu.load_state_dict({k: v.cpu() for k, v in block.state_dict().items()})
            t0 = time.perf_counter()
            want = run(block_cpu, x.cpu(), None if mem is None else mem.cpu(), pos.cpu(), "cpu")
            cpu_ms = (time.perf_counter() - t0) * 1e3
            scales = {k: float(v.abs().max()) for k, v in want.items()}
            errs = {k: float((got[k].cpu() - want[k]).abs().max()) for k in want}
            limits = {k: CROSS_LAYER_TOL * v for k, v in scales.items()}
            extra = ""
            if "mix.k" in want and cfg.pos_embedding == "rope":
                rope = max(float((a.cpu() - b).abs().max()) for a, b in zip(
                    rope_table(pos, cfg.head_dim, cfg.rope_theta),
                    rope_table(pos.cpu(), cfg.head_dim, cfg.rope_theta)))
                raw = float(attention._proj(apply_norm(x.cpu(), block_cpu.ln1, cfg),
                                            block_cpu.mix.wk).abs().max())
                limits["mix.k"] += 2 * rope * raw
                extra = (f"; the rope tables differ by up to {rope:.3e}, k before rope up to "
                         f"{raw:.3f}")
            what = (f"cross block (self, cross over {M} memory tokens, MLP), S = {S}" if M
                    else f"encoder layer, S_enc = {S}")
            log(f"phase 15: check 1: one {arch} {what}, float32 at full width: card "
                f"{card_ms:.3f} ms, CPU {cpu_ms:.3f} ms; max abs diff (limit): "
                + ", ".join(f"{k} {errs[k]:.3e} ({limits[k]:.3e}; max |CPU| {scales[k]:.3f})"
                            for k in errs) + extra)
            if not all(errs[k] <= limits[k] for k in errs):
                raise AssertionError(f"phase 15: check 1: the card's float32 {arch} layer is "
                                     f"off the CPU's: {errs}, limits {limits}")
            del block, block_cpu, got, want, x, mem
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def serve_cross(device, arch, B, S, M, n_new, want_params) -> dict:
    """One model of phase 15: built on the card (the VLM's gates seeded),
    ``engine.generate`` of B prompts of S tokens with M memory positions
    each and n_new new (every count set to 0 just before and read just
    after: flash once per self-attention layer for the VLM's prefill, which
    flash serves at 8192; nothing for whisper, under FLASH_MIN_SEQ with
    flash off), then timed prefill and decode steps with check 4 (each
    cross cache after prefill equal to the K/V projections of its memory
    bit for bit, and holding the same bits after the last decode step),
    one decode step under torch.profiler, peak memory, the encoder's time
    (whisper) or the first cross block's prefill split (the VLM), check 2
    (each decode step against the teacher-forced forward) and for the VLM
    checks 3 (flash_attention=False) and 5 (the gates at 0). Returns the
    launches of the main path."""
    import copy
    import dataclasses
    import gc

    import torch
    from repro_torch.models import attention
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model import Model
    from repro_torch.serve import engine

    t_model = time.perf_counter()
    cfg = cross_config(arch)
    counted = Model(cfg, device="meta")
    meta_params = sum(p.numel() for p in counted.parameters())
    del counted
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device=device, seed=0)
    gen = torch.Generator(device=device).manual_seed(29)
    gates = seed_gates(model.layers, gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_cross = sum(s.cross for s in cfg.layer_list())
    enc = f", encoder {len(model.encoder.layers)} layers" if model.encoder is not None else ""
    log(f"phase 15: {arch} ({cfg.n_layers} decoder layers, {n_cross} with cross-attention"
        f"{enc}; d_model {cfg.d_model}, vocab {cfg.vocab} padded to {model.vocab_padded}) built "
        f"on the card in {time.perf_counter() - t0:.2f} s: {n_params} parameters (the config "
        f"counts {meta_params} on the meta device), {torch.cuda.memory_allocated() / 1e9:.3f} "
        f"GB; gates {[round(float(g), 4) for g in gates]}")
    if not n_params == meta_params == cfg.param_count() == want_params:
        raise AssertionError(f"phase 15: {arch}: {n_params} parameters, the config counts "
                             f"{cfg.param_count()}, want {want_params}")
    vocab = cfg.vocab
    mem_key = "frames" if cfg.encoder_segments else "vision"
    memory = {mem_key: torch.randn((B, M, cfg.d_model), generator=gen, device=device)
              .to(torch.bfloat16)}
    batch = {"tokens": torch.randint(0, vocab, (B, S), generator=gen, device=device,
                                     dtype=torch.int32), **memory}
    n_self_flash = sum(s.mixer == "attn" for s in cfg.layer_list()) if (
        cfg.flash_attention and S >= attention.FLASH_MIN_SEQ) else 0

    # the main path: generate, counts set to 0 just before and read just after
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = engine.generate(model, batch, n_new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = launch_counts()
    log(f"phase 15: {arch}: generate {B} x {S} prompt tokens ({M} memory positions) + {n_new} "
        f"new: {gen_s * 1e3:.3f} ms wall (first call), launches {launches}, tokens "
        f"{out.tolist()}")
    want = {k: 0 for k in launches}
    want["flash_attention"] = n_self_flash
    if launches != want:
        raise AssertionError(f"phase 15: {arch}: launches {launches}, want {want}")
    if out.shape != (B, n_new) or not bool(((out >= 0) & (out < vocab)).all()):
        raise AssertionError(f"phase 15: {arch}: tokens out of [0, {vocab}) or of shape "
                             f"{out.shape}")

    prefill, step = engine.make_prefill(model), engine.make_serve_step(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = prefill(batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    # check 4: each cross cache holds its memory's projections, bit for bit
    proj = cross_projections(model, model._memory(batch))
    held = cross_caches(model, caches)
    if len(held) != n_cross or not all(torch.equal(h[k], p[k]) for h, p in zip(held, proj)
                                       for k in ("ck", "cv")):
        raise AssertionError(f"phase 15: {arch}: check 4: a cross cache after prefill is not "
                             f"its memory's K/V projection")
    held = [{k: t.clone() for k, t in h.items()} for h in held]
    del proj
    caches = engine.extend_caches(model, caches, S, S + n_new)
    tok = logits[..., :vocab].argmax(-1).to(torch.int32)
    steps, step_ms, step_logits = [tok], [], []
    for i in range(n_new - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, caches = step(caches, tok, S + i)
        tok = lg[..., :vocab].argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        steps.append(tok)
        step_logits.append(lg[:, 0, :vocab].float())
    if not torch.equal(torch.cat(steps, dim=1), out):
        raise AssertionError(f"phase 15: {arch}: the timed prefill and steps gave other tokens")
    wall, dev, events = device_breakdown(lambda: step(caches, tok, S + n_new - 1))
    log(f"phase 15: {arch}: one decode step under torch.profiler: {wall:.3f} ms wall, "
        f"{dev:.3f} ms device (idle {1 - dev / wall:.3f}); largest device events: " + "; ".join(
            f"{name[:60]} {ms:.3f} ms ({ms / dev:.3f})" for name, ms in events[:6]))
    if not all(torch.equal(c[k], h[k]) for c, h in zip(cross_caches(model, caches), held)
               for k in ("ck", "cv")):
        raise AssertionError(f"phase 15: {arch}: check 4: decode wrote into a cross cache")
    log(f"phase 15: {arch}: check 4: {n_cross} cross caches of ({B}, {M}, {cfg.n_kv_heads}, "
        f"{cfg.head_dim}) equal their memory's K/V projections bit for bit after prefill, "
        f"and hold the same bits after {n_new} decode steps")
    del caches
    decode_ms = statistics.median(step_ms)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"phase 15: {arch}: prefill {prefill_ms:.3f} ms ({B * S / prefill_ms * 1e3:.1f} "
        f"tokens/s), decode {decode_ms:.3f} ms a step (median of {len(step_ms)}), "
        f"{B / decode_ms * 1e3:.3f} tokens/s, peak {peak_gb:.3f} GB; card {card_line()}")

    if cfg.encoder_segments:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model._memory(batch)
        torch.cuda.synchronize()
        log(f"phase 15: {arch}: the encoder ({len(model.encoder.layers)} layers, {B} x {M} "
            f"frames) alone: {(time.perf_counter() - t0) * 1e3:.3f} ms of the prefill")
    else:
        # the first cross block's prefill, split by the profiler, on the
        # embeddings of the prompt
        i = next(i for i, s in enumerate(cfg.layer_list()) if s.cross)
        spec = cfg.layer_list()[i]
        h = model.embed.table[batch["tokens"]]
        cache = tfm.init_block_cache(spec, cfg, B, S, device, memory_len=M)
        pos = torch.arange(S, device=device)
        fn = lambda: tfm.apply_block(h, model.layers[i], spec, cfg,  # noqa: E731
                                     positions=pos, cache=cache, memory=memory[mem_key])
        fn()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        block_peak = (torch.cuda.max_memory_allocated() - before) / 1e9
        wall, dev, split = layer_split(fn, {"cross": (attention, "_grouped_attn")},
                                       gemms=("aten::mm",), kernels={"flash": "flash_fwd"})
        log(f"phase 15: {arch}: cross block {i}'s prefill ({B} x {S}, {M} memory tokens) "
            f"under torch.profiler: {wall:.3f} ms wall, {dev:.3f} ms device; "
            + ", ".join(f"{k} {v:.3f} ms ({v / dev:.3f})" for k, v in split.items())
            + f"; the block's transient peak {block_peak:.3f} GB over what it holds (the "
            f"cross scores, ({B}, {cfg.n_kv_heads}, {cfg.n_heads // cfg.n_kv_heads}, {S}, "
            f"{M}) float32, are {B * cfg.n_heads * S * M * 4 / 1e9:.3f} GB)")
        del h, cache

    # check 2: each decode step against the teacher-forced forward of the
    # prompt and the generated tokens, the same memory
    full = torch.cat([batch["tokens"], out[:, :-1]], dim=1)
    tf, _ = teacher_forced(model, full, memory)
    errs = rec_step_errors(step_logits, tf, S, vocab)
    log(f"phase 15: {arch}: check 2: {len(step_logits)} decode steps against the "
        f"teacher-forced forward of {full.shape[1]} tokens (padded to "
        f"{full.shape[1] + (-full.shape[1] % REC_PAD)}), the same memory: x max |logit| by "
        f"step {[round(e, 5) for e in errs]}, worst {max(errs):.5f} (limit {CROSS_TOL})")
    if max(errs) > CROSS_TOL:
        raise AssertionError(f"phase 15: {arch}: check 2: a decode step is {max(errs)} x max "
                             f"|logit| off the teacher-forced forward")
    del tf, step_logits

    if cfg.n_vision_tokens:
        # check 3: the flash prefill against flash_attention=False, which
        # launches no flash kernel
        plain = copy.copy(model)  # the same parameters, read with another config
        plain.cfg = dataclasses.replace(cfg, flash_attention=False)
        before = launch_counts()["flash_attention"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref, _ = engine.make_prefill(plain)(batch)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if launch_counts()["flash_attention"] != before:
            raise AssertionError(f"phase 15: {arch}: the flash_attention=False prefill "
                                 f"launched the flash kernel")
        got, ref = logits.float(), ref.float()
        diff, scale = float((got - ref).abs().max()), float(ref.abs().max())
        log(f"phase 15: {arch}: check 3: prefill logits against flash_attention=False "
            f"({plain_ms:.3f} ms, chunked): max abs diff {diff:.4f}, max |logit| {scale:.4f} "
            f"({diff / scale:.5f}, limit {CROSS_TOL})")
        if not (bool(torch.isfinite(got).all()) and diff <= CROSS_TOL * scale):
            raise AssertionError(f"phase 15: {arch}: check 3: the flash prefill disagrees "
                                 f"with the plain one")
        # check 5: the gates at 0 (as at init) take the cross path out
        seeded = [g.clone() for g in gates]
        for g in gates:
            g.zero_()
        zero, _ = prefill(batch)
        for g, v in zip(gates, seeded):
            g.copy_(v)
        moved = float((zero.float() - got).abs().max())
        log(f"phase 15: {arch}: check 5: prefill logits with every gate at 0 differ from the "
            f"seeded gates' by {moved:.4f} ({moved / scale:.5f} x max |logit|, must exceed "
            f"{CROSS_LIVE})")
        if not moved > CROSS_LIVE * scale:
            raise AssertionError(f"phase 15: {arch}: check 5: the cross path moves the logits "
                                 f"by {moved / scale} x max |logit| only")
        del plain, ref, zero, got
    del model, logits, batch, memory
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 15: {arch}: {time.perf_counter() - t_model:.1f} s")
    return launches


def run_cross(device) -> dict:
    """Phase 15: whisper-base (8 requests of 1536 stub frames, a 4-token
    prompt, 64 new) and llama-3.2-vision-11b (2 prompts of 8192 tokens with
    1600 stub vision tokens each, 16 new, flash) at full width and depth
    (bf16, seeded, the VLM's gates seeded nonzero), each served through
    ``engine.generate`` and checked (``serve_cross``: checks 2-5), then
    check 1 (``cross_layers_on_both``). Returns the launches over both
    main paths: flash once per VLM self-attention layer, nothing else."""
    import torch

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    total = None
    for arch, B, S, M, n_new, want_params in CROSS_RUNS:
        launches = serve_cross(device, arch, B, S, M, n_new, want_params)
        total = launches if total is None else {k: total[k] + v for k, v in launches.items()}
    cross_layers_on_both(device)
    torch.cuda.empty_cache()
    log(f"phase 15: {time.perf_counter() - t_phase:.1f} s")
    return total


# ------------------------------------------------------------------ phase 16

# label: ((data, model), experts over ("data", "model")), run one after the other
SHARD_MESHES = (("(1, 4)", (1, 4), False), ("(2, 2), 2-D experts", (2, 2), True))
SHARD_F32_B, SHARD_F32_S = 4, 1024  # check 1: one step, one micro-batch
SHARD_F32_TOL = 1e-5  # of max |m| and of max |parameter|
# Adam divides by sqrt(v) + 1e-8: under this |m| (a gradient of 1e-6) an
# entry's step stops following its gradient's sign, and the gradient's
# float32 rounding (about 1e-8 at full width) moves it by up to lr
SHARD_ADAM_FLOOR = 1e-7
SHARD_LOSS_TOL = 0.05  # check 2: tests/test_distributed.py's limit
SHARD_TIMEOUT_S = 300  # every gloo group of the phase
SHARD_STEPS = 2  # check 2's steps a mesh (phase 11 takes 4; cut so phase 17 fits the run)
SHARD_S = 2048  # check 2's tokens a row (phase 11's 4096, cut so that phase 18 fits)
SHARD_LAUNCH = ("--arch", "deepseek-moe-16b", "--full-config", "--layers", "2", "--seq-len",
                "1024", "--global-batch", "4", "--save-every", "2", "--dist-backend", "gloo",
                "--log-every", "1")  # check 4


def shard_config():
    """Check 2's cut: phase 11's settings (bf16, capacity 1.25, remat) on 1
    dense + 1 MoE layer at full width (cut from phase 11's 1 + 3 so that
    phase 18 fits the run's time)."""
    import dataclasses

    cfg = train_config()
    (dense, _), (moe_period, _) = cfg.segments
    return dataclasses.replace(cfg, segments=((dense, 1), (moe_period, 1)), n_layers=2)


def shard_f32_config():
    """Check 1's cut: deepseek-moe-16b at full width, 1 dense + 1 MoE layer,
    float32, capacity factor 8 (nothing drops)."""
    import dataclasses

    cfg = train_config()
    (dense, _), (moe_period, _) = cfg.segments
    return dataclasses.replace(cfg, segments=((dense, 1), (moe_period, 1)), n_layers=2,
                               dtype="float32", moe_capacity_factor=8.0)


def shard_tcfg(cfg, aux_coef: float = 0.01):
    """Phase 11's train settings (AdamW, lr warming up over 2 steps).
    Check 1 turns the MoE aux loss off: over a mesh it is the mean of each
    rank's block's aux (``repro``'s ``pmean``), another function than one
    rank's aux over all tokens."""
    from repro_torch.optim import adamw
    from repro_torch.train.step import TrainConfig

    return TrainConfig(opt=adamw.OptConfig(name=cfg.optimizer, peak_lr=3e-4, warmup_steps=2,
                                           total_steps=8, state_dtype=cfg.opt_state_dtype),
                       aux_coef=aux_coef)


def shard_f32_batch(vocab: int) -> dict:
    """Check 1's global batch: (1, 4, 1024) seeded tokens and labels, a few
    labels ignored."""
    import numpy as np

    rng = np.random.default_rng(31)
    shape = (1, SHARD_F32_B, SHARD_F32_S)
    batch = {"tokens": rng.integers(0, vocab, shape).astype(np.int32),
             "labels": rng.integers(0, vocab, shape).astype(np.int32)}
    batch["labels"][0, 0, :64] = -1
    return batch


def shard_loader(cfg, device, axes=None):
    """Phase 11's loader at SHARD_S tokens a row (2 x 2048 x accum 2), this
    rank's block with ``axes``."""
    import argparse

    from repro_torch.data import pipeline
    from repro_torch.launch import train as launcher

    args = argparse.Namespace(seq_len=SHARD_S, global_batch=TRAIN_B, grad_accum=TRAIN_ACCUM)
    return pipeline.PackedLoader(launcher.data_config(cfg, args), cfg, device=device, axes=axes)


def checksums(params: dict, specs: dict, axes) -> dict:
    """Per leaf, two sums of its bits (plain and weighted by position mod
    251), gathered over the ranks that hold the same block (the mesh axes
    its spec does not use): {name: (ranks, 2) int64}."""
    import torch
    from repro_torch.sharding import parallel as par
    from repro_torch.sharding.rules import spec_axes

    groups: dict = {}
    step = 1 << 24  # elements a piece: a leaf's int64 copies stay small
    for name, t in params.items():
        used = spec_axes(specs[name])
        names = tuple(a for a in axes.mesh.mesh_dim_names if a not in used)
        flat = t.detach().reshape(-1).view(torch.int16 if t.element_size() == 2 else torch.int32)
        total = torch.zeros(2, dtype=torch.long, device=flat.device)
        for lo in range(0, flat.numel(), step):
            bits = flat[lo:lo + step].long()
            w = torch.arange(lo, lo + bits.numel(), device=bits.device) % 251 + 1
            total += torch.stack([bits.sum(), (bits * w).sum()])
        groups.setdefault(names, []).append((name, total))
    out = {}
    for names, sums in groups.items():
        g = par.group(axes, names)
        stacked = torch.stack([s for _, s in sums])
        every = stacked[None] if g is None else g.all_gather(stacked)
        out.update((name, every[:, i].cpu()) for i, (name, _) in enumerate(sums))
    return out


def shard_f32_rank(axes, device, ref) -> dict:
    """Check 1 on one rank: the f32 cut's step on this rank's block of the
    batch; each block of AdamW's m (0.1 x the clipped gradient, ZeRO's
    block of it on (2, 2)) and of the parameters against the one-rank
    step's (``ref``), the parameters apart for the entries under
    SHARD_ADAM_FLOOR. Each error with its leaf's name."""
    import torch
    from repro_torch.data.pipeline import batch_block
    from repro_torch.models.model import Model
    from repro_torch.sharding import parallel as par
    from repro_torch.train.step import init_train_state, make_train_step, state_specs

    cfg = shard_f32_config()
    tcfg = shard_tcfg(cfg, aux_coef=0.0)
    model = Model(cfg, axes=axes, device=device, seed=0)
    params, ost = init_train_state(model, tcfg)
    batch = batch_block(shard_f32_batch(cfg.vocab), axes)
    _, _, metrics = make_train_step(model, tcfg)(params, ost, 1, batch)
    zspecs = state_specs(model, tcfg)["m"]
    m_err, live_err, dead_err, dead = (0.0, ""), (0.0, ""), (0.0, ""), 0
    for name, p in params.items():
        m = par.shard_leaf(ref["m"][name], zspecs[name], axes).to(device)
        m_err = max(m_err, (float((ost["m"][name] - m).abs().max()), name))
        want = par.shard_leaf(ref["params"][name], model.specs[name], axes).to(device)
        live = par.shard_leaf(ref["m"][name], model.specs[name], axes).to(device).abs()
        live = live >= SHARD_ADAM_FLOOR
        diff = (p.detach() - want).abs()
        if live.any():
            live_err = max(live_err, (float(diff[live].max()), name))
        if not live.all():
            dead_err = max(dead_err, (float(diff[~live].max()), name))
            dead += int((~live).sum())
    out = dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
               m_err=m_err, live_err=live_err, dead_err=dead_err, dead=dead,
               block_params=sum(p.numel() for p in params.values()))
    del model, params, ost
    torch.cuda.empty_cache()
    return out


def shard_bf16_rank(axes, device, rank: int, scratch) -> dict:
    """Check 2 on one rank: phase 11's cut trained over the mesh through
    ``RestartManager.run`` (counts set to 0 just before, read just after),
    its replicas' bits compared after each step, the last step's
    collectives timed; then one forward recording the MoE drops."""
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.ft.manager import RestartManager
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.train.step import init_train_state, make_loss_fn, make_train_step

    cfg = shard_config()
    tcfg = shard_tcfg(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, axes=axes, device=device, seed=0)
    params, ost = init_train_state(model, tcfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    it = iter(shard_loader(cfg, device, axes))
    step_fn = make_train_step(model, tcfg)
    batches, data_launches, step_launches, step_ms, losses, same = [], [], [], [], [], []

    def make_batch(step):
        if not batches:
            before = launch_counts()
            batches.append(next(it))
            data_launches.append(counts_minus(launch_counts(), before))
        return batches[0]

    spent = {"all_to_all": 0.0, "all_sum": 0.0, "all_gather": 0.0}

    def wrapped_step(state, step, batch):
        before = launch_counts()
        torch.cuda.synchronize()
        dist.barrier()
        real = timed_collectives(spent) if step == SHARD_STEPS - 1 else None  # the last
        try:
            t1 = time.perf_counter()
            p, o, metrics = step_fn(*state, step, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
        finally:
            if real is not None:
                restore_collectives(real)
        step_launches.append(counts_minus(launch_counts(), before))
        losses.append({k: float(v) for k, v in metrics.items()})
        sums = checksums(p, model.specs, axes)
        same.append(all(bool((s == s[0]).all()) for s in sums.values()))
        return (p, o), metrics

    mgr = RestartManager(CheckpointManager(str(scratch / f"run{rank}"), keep=1),
                         save_every=10 ** 9)
    torch.cuda.synchronize()
    dist.barrier()
    reset_counts()
    (params, ost), _ = mgr.run((params, ost), 0, SHARD_STEPS, wrapped_step, make_batch)
    torch.cuda.synchronize()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    timed_ms = step_ms[-1]  # the last step, its collectives timed (synchronised)

    # the MoE drops of one forward over the first micro-batch
    micro = {k: torch.as_tensor(v[0], device=device) for k, v in batches[0].items()}
    with torch.no_grad(), moe.recording_drops() as drops:
        make_loss_fn(model, tcfg)(micro)
    out = dict(build_s=build_s, step_ms=step_ms, losses=losses, same=same,
               launches=launches, data_launches=data_launches[0], step_launches=step_launches,
               peak_gb=peak / 1e9, timed_ms=timed_ms,
               spent_ms={k: v * 1e3 for k, v in spent.items()},
               drops=drops, block_params=sum(p.numel() for p in params.values()))
    del model, params, ost, step_fn, mgr, batches
    torch.cuda.empty_cache()
    return out


def shard_rank(rank: int, world: int, out_dir: str, device) -> None:
    """One of phase 16's ranks (``--mesh-rank r --mesh-phase 16``): a gloo
    group through a file store (SHARD_TIMEOUT_S on it and on every group
    made from it), then for each mesh of SHARD_MESHES check 1 and check
    2 (``shard_f32_rank``, ``shard_bf16_rank``); results to ``rank<r>.pt``."""
    import datetime

    import torch
    import torch.distributed as dist
    from torch.distributed import distributed_c10d
    from torch.distributed.device_mesh import DeviceMesh

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.sharding import spec

    timeout = datetime.timedelta(seconds=SHARD_TIMEOUT_S)
    distributed_c10d.default_pg_timeout = timeout  # the mesh's and the tuples' groups
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store", rank=rank,
                            world_size=world, timeout=timeout)
    scratch = pathlib.Path(out_dir)
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = torch.load(scratch / "f32_ref.pt", mmap=True, weights_only=False)
    results = {}
    with torch.enable_grad():
        for label, shape, expert_2d in SHARD_MESHES:
            mesh = DeviceMesh(device.type, torch.arange(world).reshape(shape),
                              mesh_dim_names=("data", "model"))
            axes = spec.from_mesh(mesh, expert_2d=expert_2d)
            results[label] = {"f32": shard_f32_rank(axes, device, ref),
                              "bf16": shard_bf16_rank(axes, device, rank, scratch)}
            dist.barrier()
    torch.save(results, scratch / f"rank{rank}.pt")
    dist.destroy_process_group()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(scratch, tag: str, *argv) -> list:
    """``python -m repro_torch.launch.train`` on MESH_WORLD ranks as
    ``torchrun`` starts them (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT), sharing the card; killed past SHARD_TIMEOUT_S. Returns
    each rank's output lines."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), WORLD_SIZE=str(MESH_WORLD))
    outs = [(scratch / f"{tag}{r}.out", scratch / f"{tag}{r}.err") for r in range(MESH_WORLD)]
    files = [(open(o, "w"), open(e, "w")) for o, e in outs]
    procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train", *argv],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=f, stderr=e,
                              cwd=ROOT) for r, (f, e) in enumerate(files)]
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.wait(timeout=max(1.0, SHARD_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f, e in files:
            f.close()
            e.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(f"phase 16: check 4: launcher ranks {bad} failed:\n" + "\n".join(
            outs[r][1].read_text()[-3000:] for r in bad))
    return [o.read_text().splitlines() for o, _ in outs]


def run_sharded(device) -> dict:
    """Phase 16, with autograd on (``main`` turns it off for the others)."""
    import torch

    with torch.enable_grad():
        return sharded_phase(device)


def sharded_phase(device) -> dict:
    """Phase 16: deepseek-moe-16b trained at full width on four gloo ranks
    sharing the card, on (data, model) = (1, 4) and (2, 2) with 2-D
    experts, and its four checks. Returns the launches of every kernel
    over check 2's runs, summed over the ranks and both meshes."""
    import math
    import shutil
    import threading

    import torch
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import lr_at
    from repro_torch.train.step import init_train_state, make_train_step

    t_phase = time.perf_counter()
    scratch = ROOT / "build" / "phase16"
    shutil.rmtree(scratch, ignore_errors=True)
    scratch.mkdir(parents=True)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        # check 1's one-rank step: the updated parameters and AdamW's m to files
        c32 = shard_f32_config()
        tcfg = shard_tcfg(c32, aux_coef=0.0)
        t0 = time.perf_counter()
        model = Model(c32, device=device, seed=0)
        params, ost = init_train_state(model, tcfg)
        _, _, m32 = make_train_step(model, tcfg)(params, ost, 1, shard_f32_batch(c32.vocab))
        ref = {"params": {k: v.detach().cpu() for k, v in params.items()},
               "m": {k: v.cpu() for k, v in ost["m"].items()}}
        top = max(float(t.abs().max()) for t in ref["params"].values())
        top_m = max(float(t.abs().max()) for t in ref["m"].values())
        torch.save(ref, scratch / "f32_ref.pt")
        n32 = sum(p.numel() for p in params.values())
        one32 = {k: float(m32[k]) for k in ("loss", "grad_norm")}
        log(f"phase 16: check 1's cut (1 dense + 1 MoE, float32, capacity 8, {n32} parameters):"
            f" the one-rank step on {SHARD_F32_B} x {SHARD_F32_S} tokens, loss "
            f"{one32['loss']:.6f}, grad norm {one32['grad_norm']:.6f}, in "
            f"{time.perf_counter() - t0:.1f} s with its files")
        del model, params, ost, ref, m32
        torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32

    # check 2's one-rank run: SHARD_STEPS steps of its cut on the same batch
    cfg = shard_config()
    tcfg = shard_tcfg(cfg)
    model = Model(cfg, device=device, seed=0)
    params, ost = init_train_state(model, tcfg)
    n_params = sum(p.numel() for p in params.values())
    if n_params != cfg.param_count():
        raise AssertionError(f"phase 16: {n_params} parameters, the config counts "
                             f"{cfg.param_count()}")
    batch = next(iter(shard_loader(cfg, device)))
    step_fn = make_train_step(model, tcfg)
    one = []
    for s in range(SHARD_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss = float(step_fn(params, ost, s, batch)[2]["loss"])
        one.append((loss, (time.perf_counter() - t1) * 1e3))
    log(f"phase 16: one rank, {n_params} parameters: losses "
        + ", ".join(f"{l:.6f}" for l, _ in one) + "; step ms "
        + ", ".join(f"{t:.3f}" for _, t in one))
    del model, params, ost, step_fn, batch
    torch.cuda.empty_cache()

    # the ranks, the card's memory sampled meanwhile
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,"
                                  "noheader,nounits"], capture_output=True, text=True,
                                 timeout=60)
            if out.returncode == 0:
                samples.append(float(out.stdout.split()[0]) / 1e3)
            stop.wait(0.5)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    t0 = time.perf_counter()
    try:
        got = run_ranks(scratch, 16)
    finally:
        stop.set()
        sampler.join()
    log(f"phase 16: {MESH_WORLD} ranks on gloo sharing the card in "
        f"{time.perf_counter() - t0:.1f} s; the card's memory in use peaked at "
        f"{max(samples, default=float('nan')):.3f} GB (nvidia-smi, every 0.5 s)")

    n_moe = sum(s.ffn == "moe" for s in cfg.layer_list())
    lr1 = float(lr_at(1, tcfg.opt))
    total, failed = None, []
    for label, shape, _ in SHARD_MESHES:
        data, model_n = shape
        # check 1
        f32 = [g[label]["f32"] for g in got]
        m_err, live, dead = (max(r[k] for r in f32) for k in ("m_err", "live_err", "dead_err"))
        lerr = max(abs(r["loss"] - one32["loss"]) for r in f32)
        gerr = max(abs(r["grad_norm"] - one32["grad_norm"]) for r in f32)
        log(f"phase 16: check 1 on {label}: loss {f32[0]['loss']:.6f} (err {lerr:.3e}), grad "
            f"norm {f32[0]['grad_norm']:.6f} (err {gerr:.3e}); m (the gradient) max abs err "
            f"{m_err[0]:.3e} in {m_err[1]} (limit {SHARD_F32_TOL} x {top_m:.4e}); parameters "
            f"max abs err {live[0]:.3e} in {live[1]} (limit {SHARD_F32_TOL} x {top:.4f}), "
            f"{sum(r['dead'] for r in f32)} entries with |m| under {SHARD_ADAM_FLOOR} within "
            f"{dead[0]:.3e} in {dead[1]} (limit lr {lr1:.1e}); {f32[0]['block_params']} "
            f"parameters on rank 0")
        if not (lerr <= SHARD_F32_TOL * abs(one32["loss"])
                and gerr <= SHARD_F32_TOL * abs(one32["grad_norm"])
                and m_err[0] <= SHARD_F32_TOL * top_m and live[0] <= SHARD_F32_TOL * top
                and dead[0] <= lr1):
            failed.append(f"check 1 on {label}: off the one-rank step")
        # check 2
        runs = [g[label]["bf16"] for g in got]
        T = TRAIN_B * SHARD_S // (data * model_n)  # tokens a rank routes a micro-step
        K = cfg.moe_topk
        C = moe_capacity(T * K, MESH_WORLD, cfg.moe_capacity_factor)
        per_layer = moe_dispatch_launches(T, K, MESH_WORLD, C)
        want_step = {k: v * n_moe * TRAIN_ACCUM * (2 if cfg.remat else 1)
                     for k, v in per_layer.items()}
        want_step["flash_attention"] = 0
        want_data = dict(zip(per_layer, KEY_VALUE), flash_attention=0)
        want_run = {k: want_data[k] + SHARD_STEPS * want_step[k] for k in want_step}
        for r, run in enumerate(runs):
            med = statistics.median(run["step_ms"][1:])
            spent = run["spent_ms"]
            log(f"phase 16: check 2 on {label}, rank {r}: built in {run['build_s']:.2f} s, "
                f"{run['block_params']} parameters; losses "
                + ", ".join(f"{m['loss']:.6f}" for m in run["losses"]) + "; step ms "
                + ", ".join(f"{t:.3f}" for t in run["step_ms"])
                + f"; median after the first {med:.3f} ms, "
                f"{TRAIN_B * SHARD_S * TRAIN_ACCUM / med * 1e3:.1f} tokens/s (the global "
                f"batch's); peak {run['peak_gb']:.3f} GB; the last step, collectives timed, "
                f"{run['timed_ms']:.3f} ms: exchange (all_to_all) {spent['all_to_all']:.3f} ms "
                f"({spent['all_to_all'] / run['timed_ms']:.4f}), all-reduce {spent['all_sum']:.3f}"
                f" ms ({spent['all_sum'] / run['timed_ms']:.4f}), all-gather "
                f"{spent['all_gather']:.3f} ms ({spent['all_gather'] / run['timed_ms']:.4f}); "
                f"MoE drops by layer (assignments, at C, at the expert capacity) {run['drops']}; "
                f"launches {run['launches']} (data {run['data_launches']})")
            bad = [i for i, (m, (l, _)) in enumerate(zip(run["losses"], one))
                   if not (math.isfinite(m["loss"]) and abs(m["loss"] - l) <= SHARD_LOSS_TOL * l)]
            if bad or not all(run["same"]):
                failed.append(f"check 2 on {label}, rank {r}: losses off the one rank's at steps "
                              f"{bad}, replicas equal {run['same']}")
            # check 3
            if (run["data_launches"] != want_data or any(s != want_step
                                                         for s in run["step_launches"])
                    or run["launches"] != want_run):
                failed.append(f"check 3 on {label}, rank {r}: launches {run['launches']} (data "
                              f"{run['data_launches']}, steps {run['step_launches']}), derived "
                              f"{want_run}")
            total = (run["launches"] if total is None
                     else {k: total[k] + v for k, v in run["launches"].items()})
        log(f"phase 16: check 2 on {label}: losses within {SHARD_LOSS_TOL} of the one rank's and "
            f"replicas the same bits on every rank: {not any('check 2' in f for f in failed)}; "
            f"check 3: derived per rank {want_run} = the data round {want_data} + "
            f"{SHARD_STEPS} steps x {want_step} (per MoE layer and micro-step {per_layer}: {T} "
            f"tokens, {T * K} assignments, {MESH_WORLD} shards, C {C})")
    if not all(total[k] > 0 for k in ("bitonic_sort_rows_kv", "bitonic_merge_rows_kv")):
        failed.append(f"check 3: a kv kernel did not launch: {total}")

    # check 4: the launcher on 4 ranks, then resumed from its step-2 checkpoint
    ckpt = scratch / "launch"
    t0 = time.perf_counter()
    full = launch_ranks(scratch, "full", *SHARD_LAUNCH, "--steps", "3", "--ckpt-dir", str(ckpt))
    t_full = time.perf_counter() - t0
    shutil.rmtree(ckpt / "step_000000003")  # as if the run had died after step 2's checkpoint
    t0 = time.perf_counter()
    again = launch_ranks(scratch, "again", *SHARD_LAUNCH, "--steps", "1", "--resume",
                         "--ckpt-dir", str(ckpt))
    t_again = time.perf_counter() - t0
    step2 = [line for line in full[0] if line.startswith("[train] step 2:")]
    resumed = [line for line in again[0] if line.startswith("[train] step 2:")]
    saved = sorted(p.name for p in (ckpt / "step_000000003").iterdir())
    want_saved = sorted([*(f"COMMITTED_{r}" for r in range(MESH_WORLD)),
                         *(f"arrays_{r}.npz" for r in range(MESH_WORLD)),
                         *(f"tree_{r}.json" for r in range(MESH_WORLD)), "mesh.json"])
    log(f"phase 16: check 4: the launcher on {MESH_WORLD} ranks ({' '.join(SHARD_LAUNCH)}): "
        f"--steps 3 in {t_full:.1f} s: " + " | ".join(full[0])
        + f"; resumed in {t_again:.1f} s: " + " | ".join(again[0])
        + f"; every rank saved step 3 after it: {saved == want_saved}")
    if not (step2 and resumed and "[train] resumed from step 2" in again[0]
            and resumed[0].split(" (")[0] == step2[0].split(" (")[0] and saved == want_saved
            and all(lines == [] for lines in (*full[1:], *again[1:]))):
        failed.append("check 4: the resumed launcher is off the uninterrupted")
    if failed:
        raise AssertionError("phase 16: " + "; ".join(failed))
    shutil.rmtree(scratch, ignore_errors=True)
    log(f"phase 16: {time.perf_counter() - t_phase:.1f} s")
    return total


# ----------------------------------------------------------------- phase 17

# label: ((data, model), experts over ("data", "model"), decode_moe_ep, seq_shard)
SERVE_MESHES = (("(1, 4), expert-TP decode", (1, 4), False, False, False),
                ("(2, 2), decode_moe_ep", (2, 2), True, True, False),
                ("(1, 4), seq_shard", (1, 4), False, False, True))
SERVE_F32_B, SERVE_F32_S, SERVE_F32_NEW = 2, 1024, 8  # check 1
# check 1's capacity: the seeded routers send nearly every token to the
# same few experts (phase 16 drops most assignments at 1.25), so an expert may take
# all 2048 tokens; at 16 its capacity (3073) holds them and nothing drops
# at prefill. EP x TP decode's expert capacity at one token a rank is 1
# whatever the factor: there the reference applies the same rule
SERVE_F32_CF = 16.0
SERVE_F32_TOL = 1e-5  # of max |logit| and of max |k|, |v|
SERVE_B, SERVE_S, SERVE_NEW = 2, 8192, 16  # check 2, the published config
SERVE_MESH = (2, 2)  # check 2: 2-D experts, decode_moe_ep
SERVE_TOL = 5e-2  # of max |logit|, as phases 5, 10 and 12
SERVE_TIMEOUT_S = 300  # every gloo group of the phase


def serve_f32_config(decode_moe_ep: bool = False):
    """Check 1's cut: deepseek-moe-16b at full width, 1 dense + 1 MoE layer,
    float32, capacity factor SERVE_F32_CF, flash off (S < FLASH_MIN_SEQ)."""
    import dataclasses

    from repro_torch.configs.registry import get_config

    cfg = get_config("deepseek-moe-16b")
    (dense, _), (moe_period, _) = cfg.segments
    return dataclasses.replace(cfg, segments=((dense, 1), (moe_period, 1)), n_layers=2,
                               dtype="float32", moe_capacity_factor=SERVE_F32_CF,
                               decode_moe_ep=decode_moe_ep)


def serve_config():
    """Check 2's model: deepseek-moe-16b at full width cut to phase 11's 1
    dense + 3 MoE layers (bf16; cut from the published 28 so that phase 18
    fits the run's time), flash on, ``decode_moe_ep``
    (``repro``'s --opt serving), capacity 1.25."""
    import dataclasses

    return dataclasses.replace(train_config(), flash_attention=True, decode_moe_ep=True)


def serve_prompts(vocab: int, B: int, S: int, seed: int):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, vocab, (B, S)).astype(np.int32))


def prefill_blocks(shape, expert_2d: bool, B: int, S: int) -> list:
    """The global token indices (b * S + position) each source shard of the
    prefill's dispatch routes, in its order: the shards are the ranks of
    the expert axes, data-major, each with its rows and its slice of the
    sequence over "model"."""
    import torch

    data, model = shape
    rows = B // data if B % data == 0 else B
    sl = S // model
    out = []
    for d in range(data if expert_2d else 1):
        for m in range(model):
            b = torch.arange(rows) + (d * rows if expert_2d else 0)
            out.append((b[:, None] * S + m * sl + torch.arange(sl)).reshape(-1))
    return out


def dispatch_keep(ids, blocks: list, n_experts: int, cf: float):
    """Which assignments the sorted dispatch keeps (``moe._dispatch_body``'s
    capacities): ids (T, K) for every token; ``blocks``, each source
    shard's tokens in its order. A source sends the first C of its
    (expert, slot)-sorted assignments to each shard; a shard takes, per
    expert, the first cap_e of what it receives, sources in coordinate
    order. Returns a (T, K) bool mask."""
    import torch

    T, K = ids.shape
    n = len(blocks)
    e_loc = n_experts // n
    flat = ids.reshape(-1).long().cpu()
    keep = torch.zeros(T * K, dtype=torch.bool)
    taken = torch.zeros(n_experts, dtype=torch.long)
    for tokens in blocks:  # sources in coordinate order
        slots = (tokens[:, None] * K + torch.arange(K)).reshape(-1)
        keys = flat[slots]
        order = torch.sort(keys, stable=True).indices
        sk = keys[order]
        A = sk.numel()
        C = moe_capacity(A, n, cf)
        cap_e = max(1, int(A * n // n_experts * cf) + 1)
        pos = torch.arange(A)
        sent = pos - torch.searchsorted(sk, sk // e_loc * e_loc) < C
        rank = taken[sk] + pos - torch.searchsorted(sk, sk)
        keep[slots[order]] = sent & (rank < cap_e)
        taken += torch.bincount(sk[sent], minlength=n_experts)
    return keep.reshape(T, K)


def grouped_ffn(xf, layer, cfg, w, ids):
    """sum_k w[t, k] * FFN_{ids[t, k]}(x_t), each expert over the tokens it
    takes (float32 accumulation): the MoE without capacities."""
    import torch
    from repro_torch.models.layers import _act

    K = ids.shape[1]
    flat = ids.reshape(-1).long()
    order = torch.sort(flat, stable=True).indices
    counts = torch.bincount(flat, minlength=cfg.n_experts).tolist()
    out = torch.zeros(xf.shape, dtype=torch.float32, device=xf.device)
    start = 0
    for e, c in enumerate(counts):
        if c:
            sel = order[start:start + c]
            x = xf[sel // K]
            y = (_act(x @ layer.wg[e], cfg.act) * (x @ layer.wi[e])) @ layer.wo[e]
            out.index_add_(0, sel // K, y.float() * w.reshape(-1)[sel, None].float())
            start += c
    return out.to(xf.dtype)


class ReferenceMoE:
    """Within it, the one-rank model's MoE is ``grouped_ffn`` with each
    assignment weighted by what the ranks' dispatch keeps
    (``dispatch_keep`` at capacity ``cf``, over ``pre_blocks`` at prefill
    and ``dec_blocks`` at decode; None: every assignment, as expert-TP
    decode gathers). ``routes`` records every layer's (w, ids) and
    ``drops`` the assignments left out, in call order."""

    def __init__(self, pre_blocks, dec_blocks, cf: float):
        self.blocks = {False: pre_blocks, True: dec_blocks}
        self.cf = cf
        self.routes, self.drops = [], []

    def _forward(self, decode: bool):
        def forward(x, layer, cfg, axes=None, **kw):
            import torch
            from repro_torch.models import moe

            B, S, d = x.shape
            xf = x.reshape(-1, d)
            w, ids, aux = moe._router(xf, layer.router, cfg)
            self.routes.append((w.cpu(), ids.cpu()))
            blocks = self.blocks[decode]
            keep = (torch.ones_like(ids, dtype=torch.bool) if blocks is None
                    else dispatch_keep(ids, blocks, cfg.n_experts, self.cf).to(w.device))
            self.drops.append(int((~keep).sum()))
            return grouped_ffn(xf, layer, cfg, w * keep, ids).reshape(B, S, d), aux
        return forward

    def __enter__(self):
        from repro_torch.models import moe

        self.saved = moe.moe_forward, moe.moe_forward_decode
        moe.moe_forward, moe.moe_forward_decode = self._forward(False), self._forward(True)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.moe_forward, moe.moe_forward_decode = self.saved


def serve_reference(model, tokens, n_new: int, ref_moe) -> dict:
    """The one-rank port's prefill, ``extend_caches`` and greedy steps
    under ``ref_moe``: the last-position logits (float32, CPU), each step's,
    the tokens, the caches after prefill and after the last step
    (``caches_to_numpy``, float32 only), the routes and the drops."""
    import torch
    from repro_torch import convert
    from repro_torch.serve import engine

    cfg = model.cfg
    B, S = tokens.shape
    out = {}
    with ref_moe:
        logits, caches = engine.make_prefill(model)({"tokens": tokens})
        n_pre = len(ref_moe.routes)
        out["prefill"] = logits.float().cpu()
        if cfg.dtype == "float32":
            out["caches_prefill"] = convert.caches_to_numpy(cfg, caches)
        caches = engine.extend_caches(model, caches, S, S + n_new)
        step = engine.make_serve_step(model)
        tok = logits[..., :cfg.vocab].argmax(-1).to(torch.int32)
        toks, steps = [tok], []
        for i in range(n_new - 1):
            logits, caches = step(caches, tok, S + i)
            steps.append(logits.float().cpu())
            tok = logits[..., :cfg.vocab].argmax(-1).to(torch.int32)
            toks.append(tok)
    if cfg.dtype == "float32":
        out["caches_decoded"] = convert.caches_to_numpy(cfg, caches)
    out["steps"] = torch.stack(steps)
    out["tokens"] = torch.cat(toks, dim=1).cpu()
    out["routes_prefill"] = ref_moe.routes[:n_pre]
    out["routes_decode"] = ref_moe.routes[n_pre:]
    out["drops_prefill"] = ref_moe.drops[:n_pre]
    out["drops_decode"] = ref_moe.drops[n_pre:]
    return out


def rows_err(got, want) -> float:
    """max |got - want| over max |want| (float32)."""
    want = want.float()
    return float((got.float().cpu() - want).abs().max() / want.abs().max())


def caches_err(got: list, want: list) -> float:
    """The largest error of the caches (``caches_to_numpy``'s layout) over
    the largest |entry| of its leaf."""
    import numpy as np

    worst = 0.0
    for gs, ws in zip(got, want, strict=True):
        for gd, wd in zip(gs, ws, strict=True):
            for key in wd:
                for name in wd[key]:
                    a, b = np.asarray(gd[key][name], np.float32), np.asarray(wd[key][name],
                                                                               np.float32)
                    worst = max(worst, float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)))
    return worst


def logits_replicated(t, axes, B: int) -> bool:
    """Whether the ranks that hold the same rows hold the same bits."""
    import torch
    from repro_torch.sharding import parallel as par

    bax = par.batch_axes(B, axes) or ()
    g = par.group(axes, tuple(a for a in axes.mesh.mesh_dim_names if a not in bax))
    return g is None or all(torch.equal(t, o) for o in g.all_gather(t.contiguous()).unbind(0))


def serve_f32_rank(mesh, expert_2d, ep, seq_shard, device, ref) -> dict:
    """Check 1 on one rank: the f32 cut served over ``mesh``, the decode
    teacher-forced on the reference's tokens; each error over the
    reference's max."""
    import torch
    from repro_torch import convert
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.serve import engine
    from repro_torch.sharding import parallel as par
    from repro_torch.sharding import spec

    axes = spec.from_mesh(mesh, expert_2d=expert_2d)
    cfg = serve_f32_config(decode_moe_ep=ep)
    model = Model(cfg, axes=axes, device=device, seed=0)
    B, S, n_new = SERVE_F32_B, SERVE_F32_S, SERVE_F32_NEW
    tokens = serve_prompts(cfg.vocab, B, S, 71).to(device)
    rows = par.batch_rows(torch.arange(B), axes)
    with moe.recording_drops() as drops:
        logits, caches = engine.make_prefill(model)({"tokens": tokens}, seq_shard=seq_shard)
    same = logits_replicated(logits, axes, B)
    out = {"prefill": rows_err(logits, ref["prefill"][rows]), "prefill_drops": drops,
           "caches_prefill": caches_err(convert.caches_to_numpy(cfg, caches, axes, B),
                                        ref["caches_prefill"])}
    caches = engine.extend_caches(model, caches, S, S + n_new)
    step = engine.make_serve_step(model)
    errs = []
    with moe.recording_drops() as drops:
        for i in range(n_new - 1):
            logits, caches = step(caches, ref["tokens"][:, i:i + 1].to(device), S + i)
            same &= logits_replicated(logits, axes, B)
            errs.append(rows_err(logits, ref["steps"][i][rows]))
    out.update(steps=errs, decode_drops=drops, replicated=bool(same),
               caches_decoded=caches_err(convert.caches_to_numpy(cfg, caches, axes, B),
                                         ref["caches_decoded"]),
               local_cache=tuple(caches[1]["mix"]["k"].shape), layout=model.layout)
    del model, caches
    torch.cuda.empty_cache()
    return out


def replay_router(routes: list, rows_of):
    """``moe._router`` replaying ``routes`` (the reference's (w, ids) per
    call, in order): each call returns this rank's rows (``rows_of(i)``
    for call i) on the input's device, and a zero aux."""
    import torch

    it = iter(enumerate(routes))

    def router(xf, router_w, cfg):
        i, (w, ids) = next(it)
        r = rows_of(i)
        return (w[r].to(xf.device), ids[r].to(xf.device),
                torch.zeros((), dtype=torch.float32, device=xf.device))

    return router


def timed_collectives(spent: dict):
    """Patch ``AxisGroup``'s collectives named in ``spent`` to add their
    synchronised wall time to it; returns the originals."""
    import torch
    from repro_torch.sharding import spec

    real = {k: getattr(spec.AxisGroup, k) for k in spent}

    def timed(kind):
        def call(self, *a, **k):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            r = real[kind](self, *a, **k)
            torch.cuda.synchronize()
            spent[kind] += time.perf_counter() - t1
            return r
        return call

    for k in spent:
        setattr(spec.AxisGroup, k, timed(k))
    return real


def restore_collectives(real: dict) -> None:
    from repro_torch.sharding import spec

    for k, fn in real.items():
        setattr(spec.AxisGroup, k, fn)


def built_in_turns(make):
    """``make()`` on each rank of the world in turn (a barrier between
    turns), the allocator's cache emptied after: a rank draws each leaf
    whole before it keeps its block (deepseek-v3's routed experts are 14
    GB a leaf in float32), so four ranks drawing at once would not fit
    the card they share."""
    import torch
    import torch.distributed as dist

    out = None
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            out = make()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def serve_bf16_rank(mesh, device, rank: int, scratch, cfg=None, shape=None,
                    seq_shard: bool = False, seed: int = 73, turns: bool = False) -> dict:
    """Check 2 and check 3 on one rank: ``cfg`` (the published config)
    over (2, 2) with ``decode_moe_ep``, ``shape`` (B, S, n_new) (phase 17's
    SERVE_B, SERVE_S, SERVE_NEW by default); the held run with the
    reference's routing replayed (``scratch / "bf16_ref.pt"``) and its
    tokens fed; then the served run at capacity 1.25 (counts set to 0
    just before ``generate``, read just after), timed. ``seq_shard``: the
    caches' layout, ``turns`` the model built a rank at a time
    (``built_in_turns``; phase 18's check 2)."""
    import torch
    import torch.distributed as dist
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.serve import engine
    from repro_torch.sharding import parallel as par
    from repro_torch.sharding import spec

    axes = spec.from_mesh(mesh, expert_2d=True)
    cfg = serve_config() if cfg is None else cfg
    B, S, n_new = (SERVE_B, SERVE_S, SERVE_NEW) if shape is None else shape
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()

    def make():
        return Model(cfg, axes=axes, device=device, seed=0)

    model = built_in_turns(make) if turns else make()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    batch = {"tokens": serve_prompts(cfg.vocab, B, S, seed).to(device)}
    ref = torch.load(scratch / "bf16_ref.pt", weights_only=False)
    src = spec.axis_group(mesh, axes.expert).index
    data = spec.axis_group(mesh, "data").index
    model_idx = spec.axis_group(mesh, "model").index
    rows = par.batch_rows(torch.arange(B), axes)
    blocks = prefill_blocks(tuple(axes.mesh_shape[a] for a in ("data", "model")), True, B, S)
    n_pre = len(ref["routes_prefill"])
    prefill = engine.make_prefill(model)
    step = engine.make_serve_step(model)

    # the held run: routing replayed, the reference's tokens fed
    real_router = moe._router
    moe._router = replay_router(ref["routes_prefill"] + ref["routes_decode"],
                                lambda i: blocks[src] if i < n_pre else [data])
    try:
        with moe.recording_drops() as pre_drops:
            logits, caches = prefill(batch, seq_shard)
        held = {"prefill": rows_err(logits, ref["prefill"][rows])}
        caches = engine.extend_caches(model, caches, S, S + n_new)
        errs = []
        with moe.recording_drops() as dec_drops:
            for i in range(n_new - 1):
                logits, caches = step(caches, ref["tokens"][:, i:i + 1].to(device), S + i)
                errs.append(rows_err(logits, ref["steps"][i][rows]))
    finally:
        moe._router = real_router
    held.update(steps=errs, prefill_drops=[c + e for _, c, e in pre_drops],
                decode_drops=[c + e for _, c, e in dec_drops] if model_idx == 0 else [])
    del caches, logits
    torch.cuda.empty_cache()

    # the served run: ``generate``, counts set to 0 just before and read just
    # after; its pieces timed from inside (the engine's prefill and step
    # wrapped, the prefill's collectives timed, the experts' re-lays)
    relay_ms, step_ms, spent, kept = [], [], {"all_to_all": 0.0, "all_sum": 0.0,
                                              "all_gather": 0.0}, {}
    real_layout = model.set_layout

    def timed_layout(mode):
        if mode == model.layout:
            return
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        real_layout(mode)
        torch.cuda.synchronize()
        relay_ms.append((time.perf_counter() - t1) * 1e3)

    real_prefill, real_step = engine.make_prefill, engine.make_serve_step

    def make_prefill(m):
        fn = real_prefill(m)

        def timed_prefill(*a, **k):
            real = timed_collectives(spent)
            try:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                r = fn(*a, **k)
                torch.cuda.synchronize()
            finally:
                restore_collectives(real)
            kept["prefill_ms"] = (time.perf_counter() - t1) * 1e3
            return r
        return timed_prefill

    def make_serve_step(m):
        fn = real_step(m)

        def timed_step(caches, tok, pos):
            before = sum(relay_ms)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            r = fn(caches, tok, pos)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3 - (sum(relay_ms) - before))
            kept["caches"] = r[1]
            return r
        return timed_step

    timed_layout("train")  # generate's prefill starts from the train layout
    model.set_layout = timed_layout
    engine.make_prefill, engine.make_serve_step = make_prefill, make_serve_step
    try:
        torch.cuda.synchronize()
        dist.barrier()
        reset_counts()
        with moe.recording_drops() as served_drops:
            t0 = time.perf_counter()
            out = engine.generate(model, batch, n_new, seq_shard=seq_shard)
            torch.cuda.synchronize()
            gen_s = time.perf_counter() - t0
        launches = launch_counts()
    finally:
        engine.make_prefill, engine.make_serve_step = real_prefill, real_step
        del model.set_layout
    prefill_ms = kept["prefill_ms"]
    pre_spent = {k: v * 1e3 for k, v in spent.items()}
    n_moe = sum(sp.ffn == "moe" for sp in cfg.layer_list())
    served_dec_drops, served_drops = served_drops[n_moe:], served_drops[:n_moe]
    caches, tok, last = kept.pop("caches"), out[:, -1:].to(device), S + n_new - 1
    spent = {k: 0.0 for k in spent}
    real = timed_collectives(spent)
    try:
        torch.cuda.synchronize()
        dist.barrier()
        t1 = time.perf_counter()
        logits, _ = step(caches, tok, last)
        torch.cuda.synchronize()
        timed_step_ms = (time.perf_counter() - t1) * 1e3
    finally:
        restore_collectives(real)
    dist.barrier()
    if rank == 0:
        idle = device_breakdown(lambda: step(caches, tok, last))
    else:
        step(caches, tok, last)
        idle = None
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    result = dict(held=held, build_s=build_s, gen_s=gen_s, launches=launches,
                  tokens=out.cpu(), relay_ms=relay_ms, prefill_ms=prefill_ms,
                  prefill_spent=pre_spent, step_ms=step_ms, timed_step_ms=timed_step_ms,
                  step_spent={k: v * 1e3 for k, v in spent.items()},
                  served_drops=served_drops, served_dec_drops=served_dec_drops,
                  peak_gb=peak / 1e9,
                  idle=None if idle is None else (idle[0], idle[1], idle[2][:6]),
                  block_params=sum(p.numel() for p in model.parameters()))
    del model, caches, logits
    torch.cuda.empty_cache()
    return result


def serve_rank(rank: int, world: int, out_dir: str, device) -> None:
    """One of phase 17's ranks (``--mesh-rank r --mesh-phase 17``): a gloo
    group through a file store (SERVE_TIMEOUT_S on it and on every group
    made from it); check 1 on each mesh of SERVE_MESHES, then checks 2
    and 3 on (2, 2); results to ``rank<r>.pt``."""
    import datetime

    import torch
    import torch.distributed as dist
    from torch.distributed import distributed_c10d
    from torch.distributed.device_mesh import DeviceMesh

    sys.path.insert(0, str(ROOT / "src"))
    timeout = datetime.timedelta(seconds=SERVE_TIMEOUT_S)
    distributed_c10d.default_pg_timeout = timeout
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store", rank=rank,
                            world_size=world, timeout=timeout)
    scratch = pathlib.Path(out_dir)
    results = {}
    meshes = {}
    for label, shape, expert_2d, ep, seq_shard in SERVE_MESHES:
        mesh = meshes.setdefault(shape, DeviceMesh(device.type, torch.arange(world).reshape(shape),
                                                   mesh_dim_names=("data", "model")))
        ref = torch.load(scratch / f"f32_ref_{'ep' if ep else 'plain'}.pt", weights_only=False)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            results[label] = serve_f32_rank(mesh, expert_2d, ep, seq_shard, device, ref)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        del ref
        dist.barrier()
    results["bf16"] = serve_bf16_rank(meshes[SERVE_MESH], device, rank, scratch)
    torch.save(results, scratch / f"rank{rank}.pt")
    dist.destroy_process_group()


def hold_served(tag: str, bf: list, ref: dict, cfg, shape, mesh_shape, failed: list) -> dict:
    """Phase 17's checks 2 and 3 (phase 18's checks 2 and 4) on the ranks'
    ``serve_bf16_rank`` results ``bf``, against the one-rank reference
    ``ref``: the held run's logits within SERVE_TOL and its drops summed
    over the ranks equal to the reference's rule; the served run's pieces
    logged; every rank's tokens the same; each rank's launches equal to
    their derivation (the MoE layers' dispatches at prefill, a rank's row
    and slice of the sequence over MESH_WORLD shards, and at each decode
    step, one token over "data"; flash once a layer at prefill). Appends
    what fails to ``failed``; returns the launches summed over the ranks."""
    import torch

    B, S, n_new = shape
    held = [r["held"] for r in bf]
    h_pre = max(h["prefill"] for h in held)
    h_steps = max(max(h["steps"]) for h in held)
    rank_pre = [sum(x) for x in zip(*(h["prefill_drops"] for h in held))]
    rank_dec = sum(sum(h["decode_drops"]) for h in held)
    log(f"{tag}: check 2 on {mesh_shape}, decode_moe_ep, {B} x {S} + {n_new}, the "
        f"reference's routing replayed: prefill logits max error {h_pre:.4e} of max |logit|, "
        f"decode steps {h_steps:.4e} (limit {SERVE_TOL}); drops summed over the ranks, by "
        f"layer, prefill {rank_pre} (the reference's rule: {ref['drops_prefill']}), decode "
        f"{rank_dec} ({sum(ref['drops_decode'])})")
    if not (h_pre <= SERVE_TOL and h_steps <= SERVE_TOL and rank_pre == ref["drops_prefill"]
            and rank_dec == sum(ref["drops_decode"])):
        failed.append("check 2: the held run is off the one-rank reference")
    n_moe = sum(sp.ffn == "moe" for sp in cfg.layer_list())
    K, cf = cfg.moe_topk, cfg.moe_capacity_factor
    data, model_n = mesh_shape
    T_pre = (B // data) * S // model_n  # a rank's tokens at prefill: its rows, its slice
    pre = moe_dispatch_launches(T_pre, K, MESH_WORLD, moe_capacity(T_pre * K, MESH_WORLD, cf))
    dec = moe_dispatch_launches(1, K, data, moe_capacity(K, data, cf))
    want = {k: n_moe * (pre[k] + (n_new - 1) * dec[k]) for k in pre}
    want["flash_attention"] = cfg.n_layers
    total = None
    for r, run in enumerate(bf):
        med = statistics.median(run["step_ms"])
        ps, ss = run["prefill_spent"], run["step_spent"]
        drops_pre = run["served_drops"]
        drops_dec = [sum(c + e for _, c, e in run["served_dec_drops"][i::n_moe])
                     for i in range(n_moe)]
        idle = ("" if run["idle"] is None else
                f"; a decode step under torch.profiler {run['idle'][0]:.3f} ms wall, "
                f"{run['idle'][1]:.3f} ms device (idle {1 - run['idle'][1] / run['idle'][0]:.3f}),"
                " largest device events " + "; ".join(f"{n[:50]} {ms:.3f} ms"
                                                      for n, ms in run["idle"][2]))
        log(f"{tag}: check 2's served run, rank {r}: built in {run['build_s']:.1f} s, "
            f"{run['block_params']} parameters; generate {run['gen_s']:.1f} s; re-lay to train "
            f"{run['relay_ms'][0]:.1f} ms, to decode {run['relay_ms'][1]:.1f} ms; prefill "
            f"{run['prefill_ms']:.1f} ms (all-reduces {ps['all_sum'] / run['prefill_ms']:.4f}, "
            f"all-gathers {ps['all_gather'] / run['prefill_ms']:.4f}, exchange "
            f"{ps['all_to_all'] / run['prefill_ms']:.4f}); decode {med:.3f} ms a step (median of "
            f"{len(run['step_ms'])}), {B / med * 1e3:.3f} tokens/s; a timed step "
            f"{run['timed_step_ms']:.3f} ms: all-reduces {ss['all_sum'] / run['timed_step_ms']:.4f},"
            f" all-gathers {ss['all_gather'] / run['timed_step_ms']:.4f}, exchange "
            f"{ss['all_to_all'] / run['timed_step_ms']:.4f}; peak {run['peak_gb']:.3f} GB; "
            f"prefill drops by layer (assignments, at C, at the expert capacity) {drops_pre}; "
            f"decode drops by layer over the steps {drops_dec}; launches {run['launches']}{idle}")
        ok_tokens = (run["tokens"].shape == (B, n_new)
                     and torch.equal(run["tokens"], bf[0]["tokens"])
                     and bool(((run["tokens"] >= 0) & (run["tokens"] < cfg.vocab)).all()))
        if not ok_tokens:
            failed.append(f"check 2: rank {r}'s tokens")
        if run["launches"] != want or not all(run["launches"][k] > 0 for k in (
                "bitonic_sort_rows_kv", "bitonic_merge_rows_kv", "flash_attention")):
            failed.append(f"launches, rank {r}: {run['launches']}, derived {want}")
        total = (run["launches"] if total is None
                 else {k: total[k] + v for k, v in run["launches"].items()})
    log(f"{tag}: launches per rank derived {want}: {n_moe} MoE layers x (prefill "
        f"{pre}: {T_pre} tokens, {MESH_WORLD} shards; + {n_new - 1} steps x {dec}: 1 token, "
        f"{data} shards), flash one a layer; tokens {bf[0]['tokens'].tolist()}")
    return total


def run_sharded_serve(device) -> dict:
    """Phase 17: sharded prefill and decode of deepseek-moe-16b on four gloo
    ranks sharing the card, against the one-rank port. Returns each
    kernel's launches over the ranks' served runs, summed."""
    import math
    import shutil
    import threading

    import torch
    from repro_torch.models.model import Model

    t_phase = time.perf_counter()
    scratch = ROOT / "build" / "phase17"
    shutil.rmtree(scratch, ignore_errors=True)
    scratch.mkdir(parents=True)

    # check 1's references: the f32 cut on one rank, plain and with EP x
    # TP decode's drops (one token a data rank)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        c32 = serve_f32_config()
        model = Model(c32, device=device, seed=0)
        tokens = serve_prompts(c32.vocab, SERVE_F32_B, SERVE_F32_S, 71).to(device)
        for variant, shape, e2d, dec in (("plain", (1, 4), False, None),
                                         ("ep", (2, 2), True,
                                          [torch.tensor([b]) for b in range(SERVE_F32_B)])):
            blocks = prefill_blocks(shape, e2d, SERVE_F32_B, SERVE_F32_S)
            ref = serve_reference(model, tokens, SERVE_F32_NEW,
                                  ReferenceMoE(blocks, dec, SERVE_F32_CF))
            torch.save(ref, scratch / f"f32_ref_{variant}.pt")
            log(f"phase 17: check 1's reference ({variant}): prefill drops "
                f"{ref['drops_prefill']} (the ranks' capacity {SERVE_F32_CF}), decode drops "
                f"{sum(ref['drops_decode'])} over {SERVE_F32_NEW - 1} steps, tokens "
                f"{ref['tokens'].tolist()}")
            if any(ref["drops_prefill"]):
                raise AssertionError(f"phase 17: check 1's prefill drops at capacity "
                                     f"{SERVE_F32_CF}: {ref['drops_prefill']}")
        n32 = sum(p.numel() for p in model.parameters())
        del model, ref
        torch.cuda.empty_cache()
        log(f"phase 17: check 1's cut (1 dense + 1 MoE, float32, {n32} parameters): references "
            f"in {time.perf_counter() - t0:.1f} s")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32

    # check 2's reference: the published config on one rank, the ranks'
    # dispatch drops applied
    cfg = serve_config()
    t0 = time.perf_counter()
    model = Model(cfg, device=device, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != cfg.param_count():
        raise AssertionError(f"phase 17: {n_params} parameters, the config counts "
                             f"{cfg.param_count()}")
    tokens = serve_prompts(cfg.vocab, SERVE_B, SERVE_S, 73).to(device)
    built = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = serve_reference(model, tokens, SERVE_NEW, ReferenceMoE(
        prefill_blocks(SERVE_MESH, True, SERVE_B, SERVE_S),
        [torch.tensor([b]) for b in range(SERVE_B)], cfg.moe_capacity_factor))
    torch.save(ref, scratch / "bf16_ref.pt")
    log(f"phase 17: check 2's reference, one rank, {n_params} parameters (built in {built:.1f} "
        f"s): prefill and {SERVE_NEW - 1} steps in {time.perf_counter() - t0:.1f} s; the ranks' "
        f"dispatch at capacity {cfg.moe_capacity_factor} drops {sum(ref['drops_prefill'])} of "
        f"{SERVE_B * SERVE_S * cfg.moe_topk * len(ref['drops_prefill'])} prefill assignments "
        f"and {sum(ref['drops_decode'])} of "
        f"{SERVE_B * cfg.moe_topk * len(ref['drops_decode'])} decode ones; tokens "
        f"{ref['tokens'].tolist()}")
    del model
    torch.cuda.empty_cache()

    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            q = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,"
                                "noheader,nounits"], capture_output=True, text=True, timeout=60)
            if q.returncode == 0:
                samples.append(float(q.stdout.split()[0]) / 1e3)
            stop.wait(0.5)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    t0 = time.perf_counter()
    try:
        got = run_ranks(scratch, 17)
    finally:
        stop.set()
        sampler.join()
    card_gb = max(samples, default=float("nan"))
    log(f"phase 17: {MESH_WORLD} ranks on gloo sharing the card in "
        f"{time.perf_counter() - t0:.1f} s; the card's memory in use peaked at {card_gb:.3f} GB "
        f"(nvidia-smi, every 0.5 s)")

    failed = []
    # check 1
    for label, shape, _, ep, seq_shard in SERVE_MESHES:
        runs = [g[label] for g in got]
        worst = {k: max(max(r[k]) if isinstance(r[k], list) else r[k] for r in runs)
                 for k in ("prefill", "steps", "caches_prefill", "caches_decoded")}
        pre_drops = sum(c + e for r in runs for _, c, e in r["prefill_drops"])
        log(f"phase 17: check 1 on {label}: max error over max |reference| (limit "
            f"{SERVE_F32_TOL}): prefill logits {worst['prefill']:.3e}, {SERVE_F32_NEW - 1} decode "
            f"steps {worst['steps']:.3e}, caches after prefill {worst['caches_prefill']:.3e}, "
            f"after the last step {worst['caches_decoded']:.3e}; replicas the same bits "
            f"{all(r['replicated'] for r in runs)}; prefill drops {pre_drops}; rank 0's cache "
            f"block {runs[0]['local_cache']}, layout {runs[0]['layout']}")
        if not (max(worst.values()) <= SERVE_F32_TOL and pre_drops == 0
                and all(r["replicated"] and r["layout"] == "decode" for r in runs)):
            failed.append(f"check 1 on {label}")

    # checks 2 and 3
    total = hold_served("phase 17", [g["bf16"] for g in got], ref, serve_config(),
                        (SERVE_B, SERVE_S, SERVE_NEW), SERVE_MESH, failed)
    if failed:
        raise AssertionError("phase 17: " + "; ".join(failed))
    if not math.isfinite(card_gb):
        log("phase 17: nvidia-smi gave no memory reading")
    shutil.rmtree(scratch, ignore_errors=True)
    log(f"phase 17: {time.perf_counter() - t_phase:.1f} s")
    return total


# ----------------------------------------------------------------- phase 18

MIX_TOL = 1e-5  # check 1: of max |reference|
MIX_TIMEOUT_S = 300  # every gloo group of the phase
# check 1's meshes: (data, model), experts over ("data", "model"), seq_shard
MIX_MESHES = {"(1, 4)": ((1, 4), False, False), "(2, 2)": ((2, 2), True, False),
              "(1, 4), seq_shard": ((1, 4), False, True)}
# check 1's served runs: cut -> (meshes, [(B, S, n_new, memory positions), ...])
MIX_SERVE = {"mla": (("(1, 4)", "(1, 4), seq_shard"), [(1, 8192, 4, 0)]),
             "rec": (tuple(MIX_MESHES), [(2, 2560, 8, 0), (1, 1024, 8, 0)]),
             "mamba": (("(1, 4)", "(2, 2)"), [(2, 1024, 8, 0)]),
             "whisper": (tuple(MIX_MESHES), [(2, 4, 8, 1536)]),
             "vlm": (tuple(MIX_MESHES), [(2, 1024, 8, 1600)])}
# check 1's steps on (2, 2): cut -> (B, S) of one micro-batch
MIX_STEPS = {"mla": (2, 1024), "rec": (2, 512), "mamba": (2, 512), "whisper": (2, 512),
             "vlm-train": (2, 512)}
MIX_MEMORY_TRAIN = {"whisper": 1536, "vlm-train": 1600}
MIX_B, MIX_S, MIX_NEW = 2, 8192, 16  # check 2
MIX_CF = 1.25  # check 2's served run
MIX_TRAIN = (2, 4096, 2, 2)  # check 3: B, S, accum, steps
MIX_LOSS_TOL = 0.05  # check 3: tests/test_distributed.py's limit
MIX_SERVE_MESH = (2, 2)  # checks 2 and 3


def mix_cut(name: str, dtype: str = "float32"):
    """Check 1's cuts, every width as published: deepseek-v3-671b's first
    dense MLA layer (flash on: its 8192-token prefill takes the kernel's
    float32 MLA route); recurrentgemma-9b's first (rec, rec, local)
    period; falcon-mamba-7b's first 2 layers; whisper-base whole (6 + 6);
    llama-3.2-vision-11b's first period (self x 3, cross + self, self),
    and for its step (``vlm-train``, so that the four ranks' float32
    AdamW states fit the card) the period's last two layers."""
    import dataclasses

    from repro_torch.configs.registry import get_config

    arch = {"mla": "deepseek-v3-671b", "rec": "recurrentgemma-9b", "mamba": "falcon-mamba-7b",
            "whisper": "whisper-base", "vlm": "llama-3.2-vision-11b",
            "vlm-train": "llama-3.2-vision-11b"}[name]
    cfg = dataclasses.replace(get_config(arch), dtype=dtype)
    period = cfg.segments[0][0]
    if name == "mla":
        return dataclasses.replace(cfg, segments=((period, 1),), n_layers=1,
                                   flash_attention=True, opt_state_dtype="float32")
    if name == "mamba":
        return dataclasses.replace(cfg, segments=((period, 2),), n_layers=2)
    if name in ("rec", "vlm"):
        return dataclasses.replace(cfg, segments=((period, 1),), n_layers=len(period))
    if name == "vlm-train":
        return dataclasses.replace(cfg, segments=((period[3:], 1),), n_layers=2)
    return cfg


def mix_check2_config():
    """Check 2's model: phase 13's deepseek-v3 cut (3 dense + 1 MoE, bf16,
    flash) with ``decode_moe_ep`` and capacity MIX_CF."""
    import dataclasses

    return dataclasses.replace(mla_config(), decode_moe_ep=True, moe_capacity_factor=MIX_CF)


def mix_check3_config():
    """Check 3's model: deepseek-v3's first three dense MLA layers, bf16,
    Adafactor with the config's bfloat16 states, remat on."""
    import dataclasses

    from repro_torch.configs.registry import get_config

    cfg = get_config("deepseek-v3-671b")
    return dataclasses.replace(cfg, segments=(cfg.segments[0],), n_layers=cfg.segments[0][1],
                               remat=True)


def mix_tcfg(cfg):
    """The step's settings: the config's optimizer (check 1: AdamW, or
    deepseek-v3's Adafactor with float32 states), lr warming up over 2
    steps, the MoE aux loss off."""
    from repro_torch.optim import adamw
    from repro_torch.train.step import TrainConfig

    return TrainConfig(opt=adamw.OptConfig(name=cfg.optimizer, peak_lr=3e-4, warmup_steps=2,
                                           total_steps=8, state_dtype=cfg.opt_state_dtype),
                       aux_coef=0.0)


def mix_memory(cfg, B: int, M: int, device, lead=()):
    """Seeded memory inputs of ``cfg`` (the same on every rank)."""
    import torch

    if not M:
        return {}
    gen = torch.Generator(device=device).manual_seed(81)
    x = torch.randn((*lead, B, M, cfg.d_model), generator=gen, device=device)
    return {"frames" if cfg.encoder_segments else "vision": x.to(getattr(torch, cfg.dtype))}


def mix_model(cfg, device, axes=None):
    """The cut's model from seed 0 (this rank's blocks under ``axes``), its
    cross gates seeded nonzero (``seed_gates``, the same on every rank)."""
    import torch
    from repro_torch.models.model import Model

    model = Model(cfg, axes=axes, device=device, seed=0)
    with torch.no_grad():
        seed_gates(model.layers, torch.Generator(device=device).manual_seed(83))
    return model


def mix_serve_reference(model, batch: dict, n_new: int) -> dict:
    """The one-rank prefill, ``extend_caches`` and greedy steps: the logits
    (CPU), the tokens, and the caches after each (``caches_to_numpy``)."""
    import torch
    from repro_torch import convert
    from repro_torch.serve import engine

    cfg = model.cfg
    S = batch["tokens"].shape[1]
    logits, caches = engine.make_prefill(model)(batch)
    out = {"prefill": logits.float().cpu(), "caches_prefill": convert.caches_to_numpy(cfg, caches)}
    caches = engine.extend_caches(model, caches, S, S + n_new)
    out["caches_extended"] = convert.caches_to_numpy(cfg, caches)
    step = engine.make_serve_step(model)
    tok = logits[..., :cfg.vocab].argmax(-1).to(torch.int32)
    toks, steps = [tok], []
    for i in range(n_new - 1):
        logits, caches = step(caches, tok, S + i)
        steps.append(logits.float().cpu())
        tok = logits[..., :cfg.vocab].argmax(-1).to(torch.int32)
        toks.append(tok)
    out["caches_decoded"] = convert.caches_to_numpy(cfg, caches)
    out["steps"] = torch.stack(steps)
    out["tokens"] = torch.cat(toks, dim=1).cpu()
    return out


def mix_serve_rank(model, ref: dict, batch: dict, n_new: int, seq_shard: bool) -> dict:
    """Check 1's served run on one rank, the decode fed the reference's
    tokens: each error over the reference's max, the launches of the
    prefill and of the steps (counts set to 0 just before each)."""
    import torch
    from repro_torch import convert
    from repro_torch.serve import engine
    from repro_torch.sharding import parallel as par

    cfg, axes = model.cfg, model.axes
    B, S = batch["tokens"].shape
    rows = par.batch_rows(torch.arange(B), axes)
    reset_counts()
    logits, caches = engine.make_prefill(model)(batch, seq_shard=seq_shard)
    launches = {"prefill": launch_counts()}
    out = {"prefill": rows_err(logits, ref["prefill"][rows]),
           "caches_prefill": caches_err(convert.caches_to_numpy(cfg, caches, axes, B),
                                        ref["caches_prefill"])}
    caches = engine.extend_caches(model, caches, S, S + n_new)
    out["caches_extended"] = caches_err(convert.caches_to_numpy(cfg, caches, axes, B),
                                        ref["caches_extended"])
    step = engine.make_serve_step(model)
    device = batch["tokens"].device
    reset_counts()
    errs = []
    for i in range(n_new - 1):
        logits, caches = step(caches, ref["tokens"][:, i:i + 1].to(device), S + i)
        errs.append(rows_err(logits, ref["steps"][i][rows]))
    launches["decode"] = launch_counts()
    out.update(steps=errs, launches=launches,
               caches_decoded=caches_err(convert.caches_to_numpy(cfg, caches, axes, B),
                                         ref["caches_decoded"]))
    return out


def mix_tokens(vocab: int, accum: int, B: int, S: int, seed: int) -> dict:
    """(accum, B, S) seeded tokens and labels, a few labels ignored."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    out = {k: rng.integers(0, vocab, (accum, B, S)).astype(np.int32)
           for k in ("tokens", "labels")}
    out["labels"][0, 0, :64] = -1
    return {k: torch.from_numpy(v) for k, v in out.items()}


def mix_train_batch(cfg, B: int, S: int, M: int, device) -> dict:
    """Check 1's micro-batch (accum 1): tokens, labels and the memory of
    ``cfg``."""
    out = {k: v.to(device) for k, v in mix_tokens(cfg.vocab, 1, B, S, 93).items()}
    out.update(mix_memory(cfg, B, M, device, lead=(1,)))
    return out


def mix_dead(ref_params: dict, ref_state: dict, name: str, spec, axes, adafactor: bool):
    """The entries of a parameter's block whose step does not follow its
    gradient (held to lr, not to MIX_TOL): AdamW's |m| under
    SHARD_ADAM_FLOOR; Adafactor's unfactored v under 1e-12 of its leaf's
    largest (a gradient under 1e-6 of the largest, whose normalised step
    is +-1 whatever its size). None where there are none."""
    from repro_torch.sharding import parallel as par

    if not adafactor:
        m = par.shard_leaf(ref_state["m"][name], spec, axes)
        return m.abs() < SHARD_ADAM_FLOOR
    s = ref_state["v"][name]
    if "v" not in s:
        return None
    v = par.shard_leaf(s["v"], spec, axes)
    return v < 1e-12 * float(s["v"].abs().max())


def mix_train_rank(model, ref: dict, B: int, S: int, M: int) -> dict:
    """Check 1's step on one rank (launches counted), against the one-rank
    step's (``ref``): the loss, the grad norm, every block of the
    optimizer's states (AdamW's m; Adafactor's vr, vc and v, each rank's
    ZeRO block; each error over the largest |entry| of its kind in the
    model: a key bias's gradient is zero but for rounding) and of the
    parameters; replicas the same bits. Adafactor's second moments are
    squares of the gradient, so their rounding is twice the gradient's:
    they are held by their square roots, the RMS the update divides by,
    over the largest root of their kind (on the card a norm scale's v,
    a sum over 2048 tokens that cancels, came 1.05e-5-1.08e-5 of the
    largest v from one rank's: 5.4e-6 in its root)."""
    import torch
    from repro_torch.data.pipeline import batch_block
    from repro_torch.sharding import parallel as par
    from repro_torch.train.step import init_train_state, make_train_step, state_specs

    cfg, axes = model.cfg, model.axes
    tcfg = mix_tcfg(cfg)
    adafactor = tcfg.opt.name == "adafactor"
    params, ost = init_train_state(model, tcfg)
    batch = batch_block(mix_train_batch(cfg, B, S, M, model.device), axes)
    reset_counts()
    with torch.enable_grad():
        _, _, metrics = make_train_step(model, tcfg)(params, ost, 1, batch)
    launches = launch_counts()
    torch.cuda.empty_cache()  # four ranks share the card: give back the step's peak
    sspecs = state_specs(model, tcfg)
    state_err, raw_err, live_err, dead_err, dead_n = (0.0, ""), (0.0, ""), (0.0, ""), (0.0, ""), 0
    def pieces(t, *others):  # a leaf and its references, 2^24 elements at a time, on the card
        flat = [x.reshape(-1) for x in (t, *others)]
        for lo in range(0, flat[0].numel(), 1 << 24):
            yield [x[lo:lo + (1 << 24)].to(t.device) for x in flat]

    for name, p in params.items():
        kinds = ost["v"][name] if adafactor else {"m": ost["m"][name]}
        for kind, t in kinds.items():
            want = ref["state"]["v"][name][kind] if adafactor else ref["state"]["m"][name]
            spec = sspecs["v"][name][kind] if adafactor else sspecs["m"][name]
            w = par.shard_leaf(want, spec, axes).contiguous()
            raw = max(float((a.float() - b.float()).abs().max())
                      for a, b in pieces(t, w)) / ref["state_top"][kind]
            raw_err = max(raw_err, (raw, f"{name}.{kind}"))
            if adafactor:  # second moments by their square roots (docstring)
                raw = max(float((a.float().sqrt() - b.float().sqrt()).abs().max())
                          for a, b in pieces(t, w)) / ref["state_top"][kind] ** 0.5
            state_err = max(state_err, (raw, f"{name}.{kind}"))
        want = par.shard_leaf(ref["params"][name], model.specs[name], axes).contiguous()
        dead = mix_dead(ref["params"], ref["state"], name, model.specs[name], axes, adafactor)
        dead = None if dead is None else dead.contiguous()
        for a, b, *d in pieces(p.detach(), want, *(() if dead is None else (dead,))):
            diff = (a - b).abs()
            live = diff if not d else diff[~d[0]]
            if live.numel():
                live_err = max(live_err, (float(live.max()), name))
            if d and bool(d[0].any()):
                dead_err = max(dead_err, (float(diff[d[0]].max()), name))
                dead_n += int(d[0].sum())
    sums = checksums(params, model.specs, axes)
    out = dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
               state_err=state_err, raw_err=raw_err, live_err=live_err, dead_err=dead_err,
               dead=dead_n,
               launches=launches, same=all(bool((s == s[0]).all()) for s in sums.values()),
               block_params=sum(p.numel() for p in params.values()))
    del params, ost
    return out


def mix_train_bf16_rank(axes, device, scratch) -> dict:
    """Check 3 on one rank: deepseek-v3's 3 dense layers over (2, 2),
    Adafactor with bfloat16 states and ZeRO-1, remat; MIX_TRAIN's steps on
    this rank's block of one batch (counts set to 0 just before, read just
    after), each step's wall, its replicas' bits compared after each, the
    last step's collectives timed (synchronised on both sides)."""
    import torch
    import torch.distributed as dist
    from repro_torch.data.pipeline import batch_block
    from repro_torch.models.model import Model
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = mix_check3_config()
    tcfg = mix_tcfg(cfg)
    B, S, accum, steps = MIX_TRAIN
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, axes=axes, device=device, seed=0)
    params, ost = init_train_state(model, tcfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    batch = batch_block(torch.load(scratch / "train_batch.pt"), axes)
    batch = {k: v.to(device) for k, v in batch.items()}
    step_fn = make_train_step(model, tcfg)
    step_ms, losses, same = [], [], []
    spent = {"all_to_all": 0.0, "all_sum": 0.0, "all_gather": 0.0}
    torch.cuda.synchronize()
    dist.barrier()
    reset_counts()
    with torch.enable_grad():
        for i in range(1, steps + 1):  # lr(0) == 0; the last step's collectives timed
            real = timed_collectives(spent) if i == steps else None
            try:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                _, _, metrics = step_fn(params, ost, i, batch)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t1) * 1e3)
            finally:
                if real is not None:
                    restore_collectives(real)
            losses.append(float(metrics["loss"]))
            sums = checksums(params, model.specs, axes)
            same.append(all(bool((s == s[0]).all()) for s in sums.values()))
        launches = launch_counts()
    out = dict(build_s=build_s, step_ms=step_ms, losses=losses, same=same, launches=launches,
               timed_ms=step_ms[-1], spent_ms={k: v * 1e3 for k, v in spent.items()},
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               block_params=sum(p.numel() for p in params.values()))
    del model, params, ost, step_fn
    torch.cuda.empty_cache()
    return out


def mix_rank(rank: int, world: int, out_dir: str, device) -> None:
    """One of phase 18's ranks (``--mesh-rank r --mesh-phase 18``): a gloo
    group through a file store (MIX_TIMEOUT_S on it and on every group
    made from it); check 1's served runs and steps (TF32 off), each cut's
    model built once a mesh; checks 2 and 3 on (2, 2); results to
    ``rank<r>.pt``."""
    import datetime

    import torch
    import torch.distributed as dist
    from torch.distributed import distributed_c10d
    from torch.distributed.device_mesh import DeviceMesh

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.sharding import spec

    timeout = datetime.timedelta(seconds=MIX_TIMEOUT_S)
    distributed_c10d.default_pg_timeout = timeout
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store", rank=rank,
                            world_size=world, timeout=timeout)
    scratch = pathlib.Path(out_dir)
    meshes = {shape: DeviceMesh(device.type, torch.arange(world).reshape(shape),
                                mesh_dim_names=("data", "model"))
              for shape in {v[0] for v in MIX_MESHES.values()}}
    results, walls = {}, {}
    t0 = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for cut, (labels, requests) in MIX_SERVE.items():
            cfg = mix_cut(cut)
            for shape in dict.fromkeys(MIX_MESHES[lb][0] for lb in labels):
                axes = spec.from_mesh(meshes[shape], expert_2d=shape == MIX_SERVE_MESH)
                model = mix_model(cfg, device, axes)
                for label in labels:
                    if MIX_MESHES[label][0] != shape:
                        continue
                    for B, S, n_new, M in requests:
                        ref = torch.load(scratch / f"ref_{cut}_{B}x{S}.pt", weights_only=False)
                        batch = {"tokens": ref["prompt"].to(device),
                                 **mix_memory(cfg, B, M, device)}
                        results[f"{cut}/{label}/{B}x{S}"] = mix_serve_rank(
                            model, ref, batch, n_new, MIX_MESHES[label][2])
                        del ref
                        dist.barrier()
                del model
                torch.cuda.empty_cache()
            walls[f"check 1, {cut} served"] = time.perf_counter() - t0
            t0 = time.perf_counter()
        axes = spec.from_mesh(meshes[MIX_SERVE_MESH], expert_2d=True)
        for cut, (B, S) in MIX_STEPS.items():
            ref = torch.load(scratch / f"step_{cut}.pt", mmap=True, weights_only=False)
            model = mix_model(mix_cut(cut), device, axes)
            results[f"step/{cut}"] = mix_train_rank(model, ref, B, S,
                                                    MIX_MEMORY_TRAIN.get(cut, 0))
            del model, ref
            torch.cuda.empty_cache()
            dist.barrier()
            walls[f"check 1, {cut} step"] = time.perf_counter() - t0
            t0 = time.perf_counter()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    mesh = meshes[MIX_SERVE_MESH]
    results["bf16"] = serve_bf16_rank(mesh, device, rank, scratch, cfg=mix_check2_config(),
                                      shape=(MIX_B, MIX_S, MIX_NEW), seq_shard=True, seed=87,
                                      turns=True)
    dist.barrier()
    walls["check 2"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    results["train_bf16"] = mix_train_bf16_rank(spec.from_mesh(mesh, expert_2d=True), device,
                                                scratch)
    walls["check 3"] = time.perf_counter() - t0
    results["walls"] = walls
    torch.save(results, scratch / f"rank{rank}.pt")
    dist.destroy_process_group()


def mix_references(device, scratch) -> dict:
    """Check 1's references on one rank (TF32 off): each cut's served
    requests and its step, to files (written by a thread while the next
    reference runs on the card); their sizes and times."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from repro_torch.train.step import init_train_state, make_train_step

    info = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    writer = ThreadPoolExecutor(1)
    writes = []
    try:
        for cut, (_, requests) in MIX_SERVE.items():
            t0 = time.perf_counter()
            cfg = mix_cut(cut)
            model = mix_model(cfg, device)
            for B, S, n_new, M in requests:
                batch = {"tokens": serve_prompts(cfg.vocab, B, S, 89).to(device),
                         **mix_memory(cfg, B, M, device)}
                ref = mix_serve_reference(model, batch, n_new)
                ref["prompt"] = batch["tokens"].cpu()
                writes.append(writer.submit(torch.save, ref, scratch / f"ref_{cut}_{B}x{S}.pt"))
            info[cut] = (sum(p.numel() for p in model.parameters()), time.perf_counter() - t0)
            del model, ref
            torch.cuda.empty_cache()
        for cut, (B, S) in MIX_STEPS.items():
            t0 = time.perf_counter()
            cfg = mix_cut(cut)
            model = mix_model(cfg, device)
            tcfg = mix_tcfg(cfg)
            params, ost = init_train_state(model, tcfg)
            batch = mix_train_batch(cfg, B, S, MIX_MEMORY_TRAIN.get(cut, 0), device)
            with torch.enable_grad():
                _, _, m = make_train_step(model, tcfg)(params, ost, 1, batch)

            def host(tree):
                if isinstance(tree, dict):
                    return {k: host(v) for k, v in tree.items()}
                return tree.detach().cpu()

            state = host(ost) if tcfg.opt.name == "adafactor" else {"m": host(ost["m"])}
            tops: dict = {}  # each kind's largest |entry| over the model
            for name, kinds in (state["v"].items() if "v" in state else
                                ((n, {"m": t}) for n, t in state["m"].items())):
                for kind, t in kinds.items():
                    tops[kind] = max(tops.get(kind, 0.0), float(t.abs().max()))
            writes.append(writer.submit(
                torch.save, {"params": host(params), "state": state, "state_top": tops,
                             "top": max(float(p.abs().max()) for p in params.values())},
                scratch / f"step_{cut}.pt"))
            info[f"step/{cut}"] = ({k: float(m[k]) for k in ("loss", "grad_norm", "lr")},
                                   sum(p.numel() for p in params.values()),
                                   time.perf_counter() - t0)
            del model, params, ost, state
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        for w in writes:
            w.result()
        writer.shutdown()
    return info


def run_mixers(device) -> dict:
    """Phase 18: the other mixers across four gloo ranks sharing the card,
    against the one-rank port of the same seed, run in this process and
    freed before the ranks start. Returns each kernel's launches over the
    phase's counted runs, summed over the ranks."""
    import math
    import shutil
    import threading

    import torch
    from repro_torch.models.model import Model
    from repro_torch.train.step import init_train_state, make_train_step

    t_phase = time.perf_counter()
    scratch = ROOT / "build" / "phase18"
    shutil.rmtree(scratch, ignore_errors=True)
    scratch.mkdir(parents=True)
    info = mix_references(device, scratch)
    for cut, val in info.items():
        if cut.startswith("step/"):
            m, n, sec = val
            log(f"phase 18: check 1's reference step of {cut[5:]} ({n} parameters, float32, "
                f"{mix_tcfg(mix_cut(cut[5:])).opt.name}): loss {m['loss']:.6f}, grad norm "
                f"{m['grad_norm']:.6f}, in {sec:.1f} s")
        else:
            log(f"phase 18: check 1's references of {cut} ({val[0]} parameters, float32): "
                f"{MIX_SERVE[cut][1]} (B, S, new, memory) in {val[1]:.1f} s")

    # check 2's reference: the 15.1 B cut on one rank, the ranks' drops applied
    cfg2 = mix_check2_config()
    t0 = time.perf_counter()
    model = Model(cfg2, device=device, seed=0)
    n2 = sum(p.numel() for p in model.parameters())
    if n2 != MLA_PARAMS:
        raise AssertionError(f"phase 18: check 2's cut has {n2} parameters, not {MLA_PARAMS}")
    tokens = serve_prompts(cfg2.vocab, MIX_B, MIX_S, 87).to(device)
    ref2 = serve_reference(model, tokens, MIX_NEW, ReferenceMoE(
        prefill_blocks(MIX_SERVE_MESH, True, MIX_B, MIX_S),
        [torch.tensor([b]) for b in range(MIX_B)], cfg2.moe_capacity_factor))
    torch.save(ref2, scratch / "bf16_ref.pt")
    log(f"phase 18: check 2's reference, one rank, {n2} parameters: prefill and "
        f"{MIX_NEW - 1} steps in {time.perf_counter() - t0:.1f} s; the ranks' dispatch at "
        f"capacity {cfg2.moe_capacity_factor} drops {sum(ref2['drops_prefill'])} of "
        f"{MIX_B * MIX_S * cfg2.moe_topk * len(ref2['drops_prefill'])} prefill assignments and "
        f"{sum(ref2['drops_decode'])} of {MIX_B * cfg2.moe_topk * len(ref2['drops_decode'])} "
        f"decode ones; tokens {ref2['tokens'].tolist()}")
    del model
    torch.cuda.empty_cache()

    # check 3's reference: the same steps on one rank, on the same batch
    cfg3 = mix_check3_config()
    tcfg3 = mix_tcfg(cfg3)
    B3, S3, accum3, steps3 = MIX_TRAIN
    batch3 = mix_tokens(cfg3.vocab, accum3, B3, S3, 91)
    torch.save(batch3, scratch / "train_batch.pt")
    t0 = time.perf_counter()
    model = Model(cfg3, device=device, seed=0)
    params, ost = init_train_state(model, tcfg3)
    n3 = sum(p.numel() for p in params.values())
    step_fn = make_train_step(model, tcfg3)
    batch3 = {k: v.to(device) for k, v in batch3.items()}
    one = []
    with torch.enable_grad():
        for i in range(1, steps3 + 1):  # lr(0) == 0
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss = float(step_fn(params, ost, i, batch3)[2]["loss"])
            torch.cuda.synchronize()
            one.append((loss, (time.perf_counter() - t1) * 1e3))
    log(f"phase 18: check 3's one-rank run, {n3} parameters (Adafactor, {cfg3.opt_state_dtype} "
        f"states, remat), {B3} x {S3} x accum {accum3}: losses "
        + ", ".join(f"{l:.6f}" for l, _ in one) + "; step ms "
        + ", ".join(f"{t:.3f}" for _, t in one) + f"; in {time.perf_counter() - t0:.1f} s")
    del model, params, ost, step_fn, batch3
    torch.cuda.empty_cache()

    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            q = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,"
                                "noheader,nounits"], capture_output=True, text=True, timeout=60)
            if q.returncode == 0:
                samples.append(float(q.stdout.split()[0]) / 1e3)
            stop.wait(0.5)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    t0 = time.perf_counter()
    try:
        # four ranks' float32 steps fill the card: their allocators grow
        # segments rather than hold fragments
        got = run_ranks(scratch, 18, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    finally:
        stop.set()
        sampler.join()
    card_gb = max(samples, default=float("nan"))
    log(f"phase 18: {MESH_WORLD} ranks on gloo sharing the card in "
        f"{time.perf_counter() - t0:.1f} s; the card's memory in use peaked at {card_gb:.3f} GB "
        f"(nvidia-smi, every 0.5 s); rank 0's walls: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in got[0]["walls"].items()))

    failed, total = [], None

    def add(launches):
        nonlocal total
        total = dict(launches) if total is None else {k: total[k] + v
                                                      for k, v in launches.items()}

    zero = {k: 0 for k in launch_counts()}
    # check 1: served runs
    for cut, (labels, requests) in MIX_SERVE.items():
        for label in labels:
            for B, S, n_new, M in requests:
                key = f"{cut}/{label}/{B}x{S}"
                runs = [g[key] for g in got]
                worst = {k: max(max(r[k]) if isinstance(r[k], list) else r[k] for r in runs)
                         for k in ("prefill", "steps", "caches_prefill", "caches_extended",
                                   "caches_decoded")}
                # check 4: flash once a prefill on each rank for the MLA layer; else none
                want_pre = dict(zero, flash_attention=int(cut == "mla"))
                ok_launch = all(r["launches"]["prefill"] == want_pre
                                and r["launches"]["decode"] == zero for r in runs)
                log(f"phase 18: check 1, {cut} on {label}, {B} x {S}"
                    + (f" (+ {M} memory)" if M else "") + f" + {n_new}: max error over max "
                    f"|reference| (limit {MIX_TOL}): prefill logits {worst['prefill']:.3e}, "
                    f"{n_new - 1} steps {worst['steps']:.3e}, caches after prefill "
                    f"{worst['caches_prefill']:.3e}, extended {worst['caches_extended']:.3e}, "
                    f"after the last step {worst['caches_decoded']:.3e}; check 4: launches "
                    f"a rank {runs[0]['launches']} (derived: prefill {want_pre}, decode none)")
                if max(worst.values()) > MIX_TOL:
                    failed.append(f"check 1: {key}")
                if not ok_launch:
                    failed.append(f"check 4: {key}: {[r['launches'] for r in runs]}")
                for r in runs:
                    add(r["launches"]["prefill"])
                    add(r["launches"]["decode"])
    # check 1: steps
    for cut in MIX_STEPS:
        ref = info[f"step/{cut}"][0]
        top = torch.load(scratch / f"step_{cut}.pt", mmap=True, weights_only=False)["top"]
        runs = [g[f"step/{cut}"] for g in got]
        lerr = max(abs(r["loss"] - ref["loss"]) for r in runs)
        gerr = max(abs(r["grad_norm"] - ref["grad_norm"]) for r in runs)
        st, raw, live, dead = (max(r[k] for r in runs)
                               for k in ("state_err", "raw_err", "live_err", "dead_err"))
        name = mix_tcfg(mix_cut(cut)).opt.name
        held = ("their square roots' max err over the largest root" if name == "adafactor"
                else "max err over their max")
        log(f"phase 18: check 1, one {name} step of {cut} on {MIX_SERVE_MESH} (ZeRO-1): loss "
            f"{runs[0]['loss']:.6f} (err {lerr:.3e}), grad norm {runs[0]['grad_norm']:.6f} (err "
            f"{gerr:.3e}); states: {held} {st[0]:.3e} in {st[1]} (the states themselves "
            f"{raw[0]:.3e} in {raw[1]}); parameters "
            f"max abs err {live[0]:.3e} in {live[1]} (limit {MIX_TOL} x {top:.4f}), "
            f"{sum(r['dead'] for r in runs)} entries at the gradient's noise floor within "
            f"{dead[0]:.3e} in {dead[1]} (limit lr {ref['lr']:.1e}); replicas the same bits "
            f"{all(r['same'] for r in runs)}; {runs[0]['block_params']} parameters on rank 0; "
            f"check 4: launches {runs[0]['launches']} (derived none)")
        if not (lerr <= MIX_TOL * abs(ref["loss"]) and gerr <= MIX_TOL * abs(ref["grad_norm"])
                and st[0] <= MIX_TOL and live[0] <= MIX_TOL * top and dead[0] <= ref["lr"]
                and all(r["same"] for r in runs)):
            failed.append(f"check 1: the step of {cut}")
        if any(r["launches"] != zero for r in runs):
            failed.append(f"check 4: the step of {cut} launched {runs[0]['launches']}")
    # checks 2 and 4: the served deepseek-v3
    bf = [g["bf16"] for g in got]
    add_total = hold_served("phase 18", bf, ref2, cfg2, (MIX_B, MIX_S, MIX_NEW),
                            MIX_SERVE_MESH, failed)
    add(add_total)
    log(f"phase 18: check 2: each rank's peak {[round(r['peak_gb'], 3) for r in bf]} GB; the "
        f"card's {card_gb:.3f} GB")
    # check 3
    for r, run in enumerate(g["train_bf16"] for g in got):
        spent = run["spent_ms"]
        log(f"phase 18: check 3, rank {r}: built in {run['build_s']:.2f} s, "
            f"{run['block_params']} parameters; losses "
            + ", ".join(f"{x:.6f}" for x in run["losses"]) + "; step ms "
            + ", ".join(f"{t:.3f}" for t in run["step_ms"])
            + f" ({B3 * S3 * accum3 / run['step_ms'][-1] * 1e3:.1f} tokens/s, the global "
            f"batch's); peak {run['peak_gb']:.3f} GB; the last step, collectives timed, "
            f"{run['timed_ms']:.3f} ms: "
            f"all-reduce {spent['all_sum']:.3f} ms ({spent['all_sum'] / run['timed_ms']:.4f}), "
            f"all-gather {spent['all_gather']:.3f} ms "
            f"({spent['all_gather'] / run['timed_ms']:.4f}), all-to-all "
            f"{spent['all_to_all']:.3f} ms ({spent['all_to_all'] / run['timed_ms']:.4f}); "
            f"replicas the same bits {run['same']}; launches {run['launches']}")
        bad = [i for i, (x, (l, _)) in enumerate(zip(run["losses"], one))
               if not (math.isfinite(x) and abs(x - l) <= MIX_LOSS_TOL * l)]
        if bad or not all(run["same"]):
            failed.append(f"check 3, rank {r}: losses off the one rank's at steps {bad}, "
                          f"replicas equal {run['same']}")
        if run["launches"] != zero:
            failed.append(f"check 4: check 3's run launched {run['launches']}")
        add(run["launches"])
    if failed:
        raise AssertionError("phase 18: " + "; ".join(failed))
    if not math.isfinite(card_gb):
        log("phase 18: nvidia-smi gave no memory reading")
    shutil.rmtree(scratch, ignore_errors=True)
    log(f"phase 18: launches summed over the ranks and the counted runs {total}")
    log(f"phase 18: {time.perf_counter() - t_phase:.1f} s")
    return total


ALL_PHASES = frozenset(range(1, 19))


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of repro_torch on one GPU.")
    ap.add_argument("--phases", default="all",
                    help="for a development run, a comma-separated subset of 1-18: phase 1 "
                         "always runs, and phase 2 unless 1 alone is named; a partial run "
                         "prints no result lines")
    ap.add_argument("--mesh-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-dir", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-phase", type=int, default=9, help=argparse.SUPPRESS)
    args = ap.parse_args()
    # the sort, serving and MoE phases run forward passes only (parameters
    # require grad since the port trains); phase 11 turns grad on
    torch.set_grad_enabled(False)
    if args.mesh_rank is not None:  # one of phase 9's, 10's, 16's, 17's or 18's ranks
        if args.mesh_phase in (10, 16, 17, 18):
            torch.cuda.set_device(0)
            rank = {10: moe_rank, 16: shard_rank, 17: serve_rank, 18: mix_rank}[args.mesh_phase]
            rank(args.mesh_rank, MESH_WORLD, args.mesh_dir, torch.device("cuda", 0))
        else:
            mesh_rank(args.mesh_rank, MESH_WORLD, args.mesh_dir)
        return 0
    arg = args.phases
    phases = ALL_PHASES if arg == "all" else frozenset({1, *map(int, arg.split(","))})
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    if not ((csrc / "bitonic.cu").exists() and (csrc / "flash.cu").exists()):
        print("chip_smoke: the repro_torch sources are not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import bitonic, build, flash

    device = torch.device("cuda")
    card = card_line()
    log(f"phase 1: card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    sources = ["bitonic", "flash"]
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, started together
        libs = dict(zip(sources, pool.map(build.build, sources)))
    log(f"phase 1: built {', '.join(str(lib.relative_to(ROOT)) for lib in libs.values())} in "
        f"{time.perf_counter() - t0:.2f} s")
    reports = {name: lib.with_suffix(".log").read_text() for name, lib in libs.items()}
    for line in reports["flash"].splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry", "warning")):
            log("phase 1: ptxas:", line.strip())
    for line in reports["bitonic"].splitlines():
        if "warning" in line:
            log("phase 1: ptxas:", line.strip())
    check_ptxas(reports["flash"])
    check_sort_ptxas(reports["bitonic"])
    if phases == {1}:
        return 0

    numbers = check_kernels(device)
    if phases != ALL_PHASES:  # a partial run (development): no result lines
        for phase, run in ((3, run_main_path), (4, check_flash), (5, run_serve),
                           (6, run_stream), (7, run_x64), (8, run_serving), (9, run_mesh),
                           (10, run_moe), (11, run_train), (12, run_batch), (13, run_mla),
                           (14, run_recurrent), (15, run_cross), (16, run_sharded),
                           (17, run_sharded_serve), (18, run_mixers)):
            if phase in phases:
                run(device)
        finish_pending()
        return 0
    walls = {}

    def run(phase: int, fn):
        """One phase of the full run, its wall kept (the last lines say
        where the run's time went), the allocator's cache emptied after."""
        t = time.perf_counter()
        out = fn(device)
        walls[phase] = time.perf_counter() - t
        torch.cuda.empty_cache()
        return out

    launches = run(3, run_main_path)
    flash_num = run(4, check_flash)
    serve = run(5, run_serve)
    run(6, run_stream)
    launches_x64 = run(7, run_x64)
    launches_serve = run(8, run_serving)
    launches_mesh = run(9, run_mesh)
    launches_moe = run(10, run_moe)
    launches_train = run(11, run_train)
    launches_batch = run(12, run_batch)
    launches_mla = run(13, run_mla)
    launches_rec = run(14, run_recurrent)
    launches_cross = run(15, run_cross)
    finish_pending()  # phase 13's CPU side, run beside phases 14 and 15
    launches_sharded = run(16, run_sharded)
    launches_sharded_serve = run(17, run_sharded_serve)
    launches_tp = run(18, run_mixers)
    log("phase walls: " + ", ".join(f"{p} {w:.1f} s" for p, w in walls.items()))

    kernels = [
        dict(name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
             launches=launches[name], launches_serve=launches_serve[name],
             launches_mesh=launches_mesh[name], launches_moe=launches_moe[name],
             launches_train=launches_train[name], launches_batch=launches_batch[name],
             launches_mla=launches_mla[name], launches_rec=launches_rec[name],
             launches_cross=launches_cross[name], launches_sharded=launches_sharded[name],
             launches_sharded_serve=launches_sharded_serve[name], launches_tp=launches_tp[name],
             max_abs_err=num["max_abs_err"], ms=num["ms"],
             plain_ms=num["plain_ms"], bound_ms=num["bound_ms"], bound_by=num["bound_by"],
             library_ms=num["library_ms"], launches_x64=launches_x64[name],
             ms_x64=num["ms_x64"], plain_ms_x64=num["plain_ms_x64"],
             bound_ms_x64=num["bound_ms_x64"], library_ms_x64=num["library_ms_x64"])
        for name, num in numbers.items()
    ]
    kernels.append(dict(
        name="flash_attention", route="cuda", source=FLASH_SOURCE, replaces=FLASH_REPLACES,
        launches=serve["flash_launches"], launches_moe=launches_moe["flash_attention"],
        launches_train=launches_train["flash_attention"],
        launches_batch=launches_batch["flash_attention"],
        launches_mla=launches_mla["flash_attention"],
        launches_rec=launches_rec["flash_attention"],
        launches_cross=launches_cross["flash_attention"],
        launches_sharded=launches_sharded["flash_attention"],
        launches_sharded_serve=launches_sharded_serve["flash_attention"],
        launches_tp=launches_tp["flash_attention"],
        max_abs_err=flash_num["max_abs_err"],
        ms=flash_num["ms"], plain_ms=flash_num["plain_ms"], bound_ms=flash_num["bound_ms"],
        bound_by=flash_num["bound_by"], library_ms=flash_num["library_ms"],
        max_abs_err_mla=flash_num["max_abs_err_mla"], ms_mla=flash_num["ms_mla"],
        plain_ms_mla=flash_num["plain_ms_mla"], bound_ms_mla=flash_num["bound_ms_mla"],
        bound_by_mla=flash_num["bound_by_mla"], library_ms_mla=flash_num["library_ms_mla"]))
    assert {k["name"] for k in kernels} == {f.__name__ for f in (*bitonic.KERNELS,
                                                                  flash.flash_attention)}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
