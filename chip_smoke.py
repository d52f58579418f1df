#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without printing a result:

1. build every CUDA kernel of ``deeplearning4j_tpu_torch/csrc`` with nvcc
   (all sources at once) and print the build time and the card;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the serving, training and decode-variant paths give it (phases
   3-12 record the shape of every launch of #1-#5 and fail on one not held
   here; #5 at every (B, L, D) of phase 6's fits, from their vocabularies
   built beforehand), and time kernel, plain
   version, bound and one library call (a yardstick the port never calls;
   none computes int8 or paged decode). The decode kernel runs in bf16 and
   int8 mode, also at positions on either side of its split edges, in int8
   at the reference's default tile (one 640-row tile) and at 64 rows, with
   a tile too long for its scores to stay in shared memory (they go to the
   wrapper's scratch tensor), and each row of a B 8 launch again alone
   (B 1), bitwise; the decode kernels are timed eagerly (``ms``, as every
   kernel) and on the device alone (``graph_ms``: a CUDA graph of
   launches, since one call's host path outlasts the kernel), with the
   grid and cluster of their launch; the paged decode kernel in both modes
   at block sizes 8 and
   64 over shuffled tables with an aliased block, also held BITWISE against
   the slab kernel over the gathered slab; the fused embedding dot (#5)
   in its dense mode (the reference's function and the range flag) at
   Word2Vec's batch (4,096 pairs, D 100) for L 16 and for phase 6's
   longest Huffman path, and with masked rows and dots planted at 6 -+
   1e-3 (no library call computes it: the time of ``torch.bmm`` for the
   dot alone is printed beside it); and in its fused mode (the HS step's
   gathers, dots, g, grad_in and delta rows, written at the scatter
   plan's positions) at the same batch for L 16, for the longest path with
   planted dots and masked rows, on phase 6's first batch and at phase
   18's per-rank batches (B 2,048 and 1,024 over the longest path), each
   also timed on the device alone (``graph_ms``) and run twice, bitwise;
   and
   the threefry draw kernel the port adds (``csrc/sample.cu``, the
   reference's ``jax.random.categorical``) against ``categorical_plain``,
   tokens and winning values bitwise, in engine mode (8 slot keys folded with
   positions 0 to 639, a grammar-masked row, a planted exact tie) and flat
   mode (B 1 and 4, and on speculative decoding's log-probabilities), at
   V 50,304; phases 3-12 record the shape of every draw launch too; and
   #1 at the batched admission's shapes: BH 12, 24 and 48 (groups of 2, 4
   and 8 prompts of 6 heads) at every prefill bucket (8 to 128), each
   6-row block of a BH 48 launch also bitwise a BH 6 launch of the same
   rows and #1 and #2 at phase 14's mesh ranks
   (BH 8 at T 1024, BH 16 at T 64), each rank's rows of a BH 48 launch
   bitwise the rank's own launch; and phase 15's: #1 at a mesh rank's
   prefill (BH 8 at T 128), #1 and #2 at a training rank's (BH 8 at T
   256), #3 at a mesh rank's decode (B 4, Hkv*K 256) and at the
   single-device generate it is held against (B 8, Hkv*K 768), both Tpad
   160, and the draw over 8 rows; and ``train --tp 3``'s closing sample
   from its layout (#1 BH 2 at T 16, #3 B 1 over Hkv*K 256 at Tpad 64, 2
   and 12 layers); and phase 21's long-context shapes: #1 and #2 at T
   8,192 (BH 8 and 4) and 32,768 (BH 4), #1 at T 8,192 over BH 96, 6
   and 24 and at T 512 over BH 120, all past T 1,024 held against the
   row-blocked plain versions (query rows in blocks against every key row:
   no (BH, T, T) tensor), and the reference's own flash gate
   (bench.py:339: f32 gradients of sum(o sin o) through #1/#2 against
   dense autograd at T 2,048 and 4,096, err < 0.02 scale + 0.01); #3 in
   bf16 and int8 (its default tile, 4,352 rows: two tiles) at B 16, G 3,
   Hkv*K 256, Tpad 8,704 at positions 0, 4,351, 4,352, 8,191 and 8,447,
   at B 1 and 4 there and at B 20 over Tpad 584; #4 in both modes at B 4
   over bs-8 tables of 1,088 entries, bitwise #3 over the gathered slab;
   and #3 int8 over a row's ranks as phase 20a runs it, at 20a's (2, 3)
   rank (B 4, 2 of 6 KV heads, Tpad 160) and over 21b's two-tile row in 2
   ranks: the maxima pass and the full pass under the row's scales from
   outside bitwise their plain versions, the ranks' rows bitwise the
   single launch's; over the whole row under q scales that differ
   across every (group, KV head) lane, the maxima pass bitwise plain,
   the full pass within one bf16 step of plain and each lane bitwise its
   KV head launched alone; both modes timed at rank 0's shape; and phase
   22's: #1 at T 512 over BH 48 and 96 (groups of 8 and 16), #3 at B
   16, G 3, Hkv*K 256 over Tpad 584 (the engine) and 576 (generate), #4
   at B 16 over bs-8 tables of 73 entries, the draw over 16 rows;
3. serve the GPT-2-small configuration (random weights from a seed) through
   ``ServingEngine``: about eight greedy requests, some past the 128-token
   prefill bucket, with every kernel's launch count set to 0 just before and
   read just after; two streams are held against the port's
   ``transformer_generate``;
3b. the same with int8 weights and the int8 KV cache (``decode_int8``,
   ``quantize_decode_params``): the int8 mode of the decode kernel must
   launch, two streams are held against ``transformer_generate`` on the
   quantized model;
3c. the runs of 3 and 3b again with the KV cache block-paged (block size
   8): the engine must come up paged, the paged kernel must launch and the
   slab decode kernel not, every stream must be byte-identical to its slab
   run's, and every block must come back;
4. answer three ``POST /v1/generate`` and a ``GET /healthz`` through
   ``ServingServer`` on an ephemeral port, then stop it;
5. train the reference bench's "transformer" preset (GPT-2-small widths,
   seq 1024, batch 24, flash, remat ``dots_no_batch``, bf16 compute, f32
   params; random weights and one fixed batch from seed 0) through
   ``transformer_train_step`` with ``lm_optimizer``: 2 warm-up steps, then 6
   timed ones with the flash launch counts set to 0 just before and read just
   after; the loss must be finite and fall. Then, on a 2-layer model of the
   same widths at T 1024, B 2: flash vs dense attention (loss within 1e-2
   relative, every gradient leaf at cosine >= 0.99) and remat on vs off
   (bitwise equal: every kernel of the path is deterministic);
6. word2vec: Word2Vec.fit at full width (word2vec.c's size 100 and window
   5, batches of 4,096 pairs, HS) on a synthetic corpus of text8's shape
   (4,000 sentences of 1,000 tokens, Zipf(1.0) over 71,290 word types,
   seed 0); the same model with ``negative=5`` on the first 500 sentences
   (the per-batch HS+NS path); a small fit (the reference tests' topic
   corpus, D 32, 4 epochs) on the card and on the CPU from the same tables
   (within the CPU tests' tolerance) and twice on the card (bitwise equal,
   the first with TF32 allowed); the reference's topic-similarity check on
   the card; ParagraphVectors.fit_labeled with HS (the label pass; words
   and labels, the reference test's classification asserted), and with
   HS+NS. Kernel
   #5's launch count is set to 0 before every run and must be > 0 after;
   the full-width tables must be finite with max |syn0| under 1,000;
7. decode variants and checkpoints, at full width: ``cli.main(["train",
   "--preset", "gpt2s", ..., "--checkpoint-dir", D, "--save-every",
   "2"])`` for 4 steps (both checkpoints there, step 4 and the preset's
   config in the meta, the restored params bitwise the npz arrays, each
   write and the restore timed), then ``generate --beam 4`` and ``generate
   --int8 full --temperature 0`` from D (the reference's printed lines;
   flash prefill and the decode kernel, int8 mode in the second, must
   launch); beam search (B 1, W 4, prompt 128, 32 new) on phase 3's model
   in bf16 and int8 full: W 1 bitwise greedy generate, scores sorted and
   equal bitwise to the beams' own tokens teacher-forced through the same
   decode program (a planted stale cache must fail this check), and each
   within a stated tolerance of its sequence's log-likelihood by f32
   ``transformer_apply``, ms a beam step; speculative decoding at the
   reference bench's spec row (GQA 6/2 heads, rope, prompt 512, 64 new, k
   4, the int8-weight self-draft): greedy held against generate (at the
   first divergence generate's top-2 gap must be at most twice the largest
   logit difference between the two programs there), sampled runs equal
   per key seed, exactly one host sync a round (PyTorch's sync debug
   mode), rounds and acceptance, and tokens/s of speculative vs plain
   generate, 5 runs a side in turns. Phase 2 holds every shape these
   runs launch #1, #2 and #3 at, among them the draft steps' (B 1, G 3,
   Hkv 2, K 128, Tpad 584).

8. the serving engine's features at GPT-2-small's width (phase 3's model,
   8 slots, max_total 640, K 4): (a) the prefix cache on 32 greedy
   requests in 4 waves of 8 behind two shared system prompts of 96 and 256
   tokens (8 exact repeats), in bf16 slab, bf16 paged and int8 full slab,
   each with the cache off and on (streams byte-identical, the probe
   passing, full and partial hits, blocks in use = the segments'), a
   two-slab region (evictions while segments are pinned), and, measured
   beside the engine's route, the 8-row route it did not take (hits,
   dispatches, TTFT, streams equal to the cache-off run's); (b) recovery by
   replay on phase 3's prompts plus 4 repeats, greedy and sampled, slab and
   paged, stepwise and "auto" replay, under a crash at step check 6, a
   crash at the prefill check of a cache hit, seeded transients and a
   permanent fault at one prefill (every other stream equals the
   uninterrupted run's; recover() timed); (c) piggyback on and off, slab
   and paged, with 6 slots decoding 128-token prompts when two 512-token
   prompts arrive, and a crash while one is pending (the same bytes, 1
   host sync a horizon, the decoding slots' TPOT and longest gap); (d)
   ``ServingServer`` over a crash (/healthz 200, the uninterrupted tokens)
   and over crashes at every check with ``max_restarts=1`` (503, FAILED).
   The sampled runs draw on the reference's threefry key stream.
9. the sampling surface (``sampling_surface=True``) at that width: (a) 16
   unconstrained requests, greedy and T 0.8 top-k 40, slab and paged bs
   8, byte-identical to the plain engine's (the masked parity probe
   passing), slab runs in turns for tok/s, masked vs plain; (b) 8 regex
   and 8 JSON-schema requests (the README's schema, EOS 0, T 0 and 0.8):
   every token DFA-permitted, every stream ending in EOS at an accepting
   state, every JSON output valid, the compile cache's hits and misses;
   (c) top-p 1e-6 equal to greedy, stop sequences cutting the greedy
   stream exactly, a logit bias forcing a token, logprob records; (d) a
   crash mid-run with constrained sampled requests in flight (streams and
   logprob records equal the uninterrupted run's); (e) the port on the card
   against the port on the CPU at 2 layers of that width in f32, T 0.8
   (streams identical, or the near-tie gap at the first divergence).
10. the front end, tenancy and batched LoRA at that width: (a) SSE
   through ``ServingServer``, slab then paged: 8 greedy, 8 T 0.8 top-k 40
   and one stop-sequence request, streamed and not, on fresh
   sampling-surface engines fed in one order (the SSE tokens are the
   non-streamed tails byte for byte, 1 host sync a horizon either way),
   the caller's TTFT (first SSE token frame) beside the engine's, and a
   client that disconnects mid-stream (its slot freed within one horizon
   of the cancel); (b) ``/drain`` (``/readyz`` and new submits 503, the
   in-flight request finishing), ``/undrain``, and ``/metrics.json``'s
   keys against the reference server's; (c) a LoRA bank of 4 adapters of
   rank 4 from ``key(0)``: the adapter-0 probe passing on the card,
   adapter-0 streams equal to a bank-free engine's, a mixed batch
   (adapters 0-3 over 8 slots) equal to four single-adapter engines,
   greedy (slab, paged) and sampled (slab), but at a reported greedy
   near-tie, decode through kernels #3/#4; (d) three tenants from a JSON
   file (one flooding, one capped at 2 slots, one metered): the others
   finish well ahead of FIFO, 429 on the quota, 401 on an unknown key, the
   per-tenant series; (e) sampled mixed-adapter streams through a crash
   equal to the uninterrupted run, each streamed once.
11. the single-engine features still missing until now, at that width:
   (a) batched admission: 8 prompts of one bucket (128) submitted before
   one step, on engines with ``batch_admission`` False, "auto" and True,
   greedy and T 0.8 top-k 40: the probe's verdict, prefill dispatches (8
   against 1), #1 at BH 48, the group's TTFT against serial admission,
   streams against serial (identical where the probe passed, else a
   reported near-tie); then 8 prompts behind a cached 128-token prefix
   through the batched hit program (cache on against off); (b) the
   adaptive horizon: 24 requests into 8 slots at K 4, on and off: the
   streams, horizons at K 1 and K 4, the second wave's TTFT and tok/s; (c)
   two engines on one ``probe_cache`` file (slab with the prefix cache,
   the surface, a LoRA bank and a crash; paged): the second runs no
   probe; (d) a traced run (the export parses, every track has its spans)
   and the same run untraced (same streams, 0 events), the attribution
   families in ``/metrics``, ``ServingServer`` with ``flight_dir`` under
   an injected crash (a dump; ``/debug/dump`` 200 and redacted), ``POST
   /profile?s=2`` (a ``torch.profiler`` trace naming #1's and #3's
   kernels), ``trace-merge``; (e) ``serve``'s demo word2vec through
   ``/v1/embeddings`` (every vector the CPU model's, 400, 503), and
   generate streams unchanged by interleaved embedding requests.
12. the fleet at that width, every server in this process on the one card
   (TTFT numbers there are of a shared card): (a) the KV wire engine to
   engine: prompts of 128-400 tokens exported by a prefill engine (128
   through kernel #1, the rest through the chunk windows), framed,
   decoded and ingested by a decode engine with the prefix cache; the
   follow-up generates full-hit with 0 prefill dispatches (#1 silent
   there) and the streams of a monolithic engine byte for byte, greedy
   and T 0.8 top-k 40, in bf16 slab, bf16 paged (bs 8) and int8 full; the
   disagg probe's verdict (a decline in bf16 slab fails), frame bytes and
   encode, decode and ingest seconds per mode; (b) a ``FleetController``
   over a prefill and a decode ``ServingServer`` beside a monolithic one
   (threshold 128): long prompts take the transfer (0 prefill dispatches
   on the decode side) with the monolithic tokens, a session follow-up
   sticks, ``fleet_disagg_total``, ``fleet_sticky_total``,
   ``serve_transfers_total{result="ok"}`` and
   ``serve_kv_ingests_total{result="stored"}``, and the caller's TTFT
   through the transfer against local prefill (measured only); (c) a
   ``ReplicaRouter`` over two replicas: shared-prefix prompts pin to one,
   others spread, a stopped replica's requests retry on the survivor and
   its breaker opens, restarted it stays open under health polls and
   only a forwarded request (the half-open probe, the survivor drained)
   closes it; (d) ``POST /migrate`` mid-generation moves three live
   sessions to another server (another master seed) and the original
   clients get the uninterrupted run's streams byte for byte, greedy and
   sampled; a sampling-surface session stays local; (e) a KV push
   through a ``ChaosProxy`` that corrupts the request (refused, nothing
   seated) and one that truncates the answer (``pushed: false``) fail
   within their deadline, frames cut in half or with flipped header bytes
   are 400s, and a controller whose decode member sits behind the proxy
   falls back with the monolithic tokens; (f) the merged trace chains
   controller dispatch -> export prefill -> transfer -> kv_ingest under
   one trace id, with each transfer request's legs in ms. Every launch of
   #1, #3/#4 and the draw in phase 12 is held by phase 2
   (``check_launched``).
13. exact tensor-parallel serving at that width (phase 3's model and
   prompts, 8 slots, max_total 640, K 4), every rank on the one card
   (``tp_devices=["cuda:0"] * tp``), tp 1, 2 and 3 (GPT-2-small's 6 heads
   do not divide among 4 ranks), the TP request's dense programs at every
   width, one probe-verdict file for the phase: (a) bf16 slab, bf16 paged
   (bs 8) and int8 full, greedy and T 0.8 top-k 40, at tp 1 and 2 (bf16
   slab also at tp 3): the tp parity probe's verdict (a decline outside
   ``TP_KNOWN_DECLINES`` fails bf16 slab; a decline is served trusted and
   held to tp 1 at the near-tie rule), the streams against tp 1's
   (byte-identical where the probe passed), no launch of #1, #3 or #4
   and the draw on the sampled runs, tok/s and TPOT p50 per width; (b) the prefix cache behind a 256-token system prompt at
   tp 2 (full and partial hits, the bytes of the cache off); (c) a crash at
   step check 6 at tp 2, sampled (the uninterrupted streams); (d) a LoRA
   bank of 4 x rank 4 at tp 2 against tp 1; (e) a regex and a JSON-schema
   request through the masked step at tp 2 against tp 1; (f) a tp-2 frame
   byte-equal to tp 1's and seated by a tp-1 engine (no prefill, the
   monolithic stream); (g) tp 4 over the 6 heads falling back to tp 1
   with the caller's config (kernels #1 and #3 launch again) and
   ``cli.main(["serve", "--tp", "2", ...])`` exiting 2 on one card; (h)
   device records and host ms a steady decode substep at each width
   (``torch.profiler``).
14. MoE and the training mesh: (a) MoE serving at GPT-2-small's width
   (8 experts, top 2, dense decode over every expert; phase 3's
   geometry, prompts and prefix cache on), bf16 slab and paged (bs 8),
   greedy and T 0.8 top-k 40: greedy streams held against
   ``transformer_generate`` (near-tie rule), paged byte-identical to slab,
   #1, #3 and #4 launched; every parity probe's verdict on slab and paged
   engines of the MoE and the dense model (the MoE verdicts must be the
   dense model's, and all but chunked replay must pass); tok/s, TPOT p50
   and device records a steady decode substep beside the dense model's;
   (b) ``transformer_train_step`` on a (data, model) = (2, 3) mesh over
   ``["cuda:0"] * 6``: those widths with 3 experts (one a model rank, top
   2), seq 1024, batch 8, flash, remat, bf16, replicated and FSDP, one
   warm-up and 4 timed steps each on one fixed batch from one init:
   finite falling losses, FSDP within 2e-3 of replicated, #1 and #2 once
   a layer on every rank (BH 8: 4 rows x 2 heads), ms a step and each
   rank's parameter + AdamW bytes from the layout; (c) ``train --tp 3
   --n-experts 3 --fsdp --device cuda:0`` at that width and 2 layers
   writes a checkpoint and ``generate --checkpoint-dir`` restores it.
   Phase 2 holds #1 and #2 at the ranks' shapes, and each rank's rows of
   a whole-batch launch bitwise that rank's own launch (#1 and #2).
15. the rest of the transformer's path: (a) GPT-2-small (phase 3's
   geometry, bf16, flash) laid out by ``place_transformer_params`` on a
   (2, 3) mesh over ``["cuda:0"] * 6``, in bf16 and int8 weights (the int8
   scales' layout the reference's: wo_scale and w2_scale whole, w1_scale
   on d_ff), 8 prompts of 128 tokens and 32 new, greedy, straight from the
   layout: tokens identical to single-device ``transformer_generate`` or a
   reported near-tie, int8 against bf16 agreement >= 0.5, #1 once a layer
   on every rank and #3 once a layer, rank and step; a sampled run (T 0.8,
   top-k 40, one key) against single-device generate's, measured; (b) two
   ``train --coordinator 127.0.0.1:P --num-processes 2 --process-id I --tp
   3 --device cuda:0`` processes (each a (1, 3) mesh on the card, gloo,
   which stages the CUDA buckets through the host) at GPT-2-small's
   widths (byte vocabulary, seq 256, batch 8, 6 steps, bf16, flash,
   ``--checkpoint-backend orbax --save-every 6``), process 0 with
   ``--status-port 0``: ``/statetracker/phase`` polled while they run
   (``train``, then ``done``), ``status --port`` on it; both processes'
   final losses equal and within 2e-3 of the one-process run of the same
   recipe on ``dp_mp_mesh(2, 3, ["cuda:0"] * 6)``; #1 and #2 216 times in
   each; ms a step both ways over steps 2-6 (saves left out), the
   all-reduce's ms a step, and the bytes all-reduced a step; (c) the
   one-process run's params saved on their (2, 3) layout by
   ``AsyncShardedCheckpointManager`` and restored (bitwise, the same
   specs), the two processes' checkpoint restored onto the (2, 3) layout
   (every leaf within 2e-3 of the one-process params, |a - b| / |b|), and
   ``generate --checkpoint-backend orbax`` on it.
16. the DL4J-era core (none of it reaches kernels #1-#5, whose launches
   must stay 0 here): (a) ``cli.main(["train", "--model", "lenet",
   "--examples", "4096", "--batch", "256", "--epochs", "2"])`` (32 steps on
   synthetic MNIST, f32; the losses finite and falling) and the same at
   bench.py's batch of 1,024 (8 steps): ms a step over steps 2-N and
   samples a second as the CLI prints them, peak memory; (b) from LeNet's
   seed-0 weights carried as the reference's numpy arrays: the
   probabilities on the card within 1e-4 of the port's on the CPU, 5
   ``DataParallelTrainer`` steps' losses within rel 1e-4 of the CPU's, two
   seeded card runs bitwise, and, measured only, the same with TF32
   allowed and one MIXED_BF16 run's ms a step; (c) the reference's DBN on
   LFW (784-600-250-100-5 RBMs and an MCXENT softmax, 500 synthetic faces in
   one batch): CD-1 pretraining (20 iterations a layer, the first layer's
   reconstruction score must fall; ms a CD iteration), a CG finetune with
   full backprop (10 iterations; the score must fall), then GD, CG, L-BFGS
   and Hessian-free for 5 iterations each from the pretrained params: ms an
   iteration, the solvers' counted host reads and the CUDA syncs PyTorch's
   sync debug mode sees; (d) a LeNet npz checkpoint written on the card
   restored bitwise into a fresh network, and ``to_bytes`` of the card's
   net holding the CPU net's vector and config.
17. the DL4J nets across devices and processes, and the rest of the zoo
   (kernels #1-#5 must launch 0 times; the draw launches once a sampled
   character in (e), at the shape phase 2 holds): (a) ``train --model
   alexnet`` at batch 256 (32 steps) and 1,024 (24 steps) on synthetic
   CIFAR, the losses finite and falling, ms a step, samples a second and
   peak memory; AlexNet from its seed-0 weights carried as numpy: the
   probabilities on the card within 1e-6 of the CPU's, 5 trainer steps'
   losses within rel 1e-6, two seeded card runs bitwise; (b) ResNet-20 at
   full width (16/32/64 channels, 3 blocks a stage): 20 MIXED_BF16 steps
   at batch 1,024 (finite, falling, ms a step), one f32 step at batch 128
   card vs CPU (the loss rel 1e-5; params and BN state leaf by leaf within
   1e-4 of the leaf's max plus 5e-5), sync-BN dp 2 on ``["cuda:0"] * 2``
   against dp 1 (loss and BN state within 1e-5); (c) two ``train --model lenet
   --coordinator`` processes over gloo on the card, the final loss within
   rel 1e-5 of the one-process run's; (d) a 4-stage pipeline on
   ``["cuda:0"] * 4`` (width 512, 8 microbatches of 128: the output
   bitwise the sequential stack's microbatch by microbatch, gradients
   within 1e-6, 5 train steps falling), ``tp_mlp_block`` at tp 2 at
   AlexNet's dense widths against the dense block (1e-5),
   ``local_sgd_step`` on LeNet at dp 2 with 2 local steps against the CPU
   (rel 1e-5) with ``replica_consensus`` 0, ``sequence_sharded_lstm`` over
   4 ranks at T 128 bitwise ``scan_hidden``; (e) the char-LSTM on a built
   text: 2 epochs (the loss falls, ms an epoch), 50 sampled characters,
   the device beam equal to the host oracle (scores within 1e-5).
18. the NLP models and the vector tools (kernel #5 launches in 18a alone,
   at the per-rank shapes phase 2 holds): (a) ``Word2Vec.fit_distributed``
   at phase 6's width (D 100, window 5, batches of 4,096 pairs, HS) over
   phase 6's vocabulary on its first 500 sentences, over 2 and 4 data
   ranks on ``["cuda:0"] * n``: pairs/s, ms a batch, #5's launches exactly
   batches x ranks, the tables bounded; two seeded runs over 2 ranks on 250
   sentences bitwise; the first sentences' batches (at least 8) on the card
   within 1e-4 of the CPU's from the same tables; (b) GloVe at the
   reference's defaults (D 50, window 5, x_max 100, alpha 0.75, lr 0.05,
   batches of 4,096) for 2 epochs on the first 1,000 of phase 6's
   sentences: the count's seconds, the triples, V, ms a batch, triples/s,
   the loss per epoch
   (falling); the first 8 batches on the card within rel 1e-5 of the CPU's;
   on the first 500 sentences for 1 epoch, two seeded runs bitwise and
   ``fit_distributed`` over 2 ranks (the epoch's loss finite and under the
   first batch's); (c) the RNTN at d 25 with the
   tensor, batches of 27: the simplified model on 1,000 synthetic 5-class
   trees of 8-20 words, the untied one on the bundled treebank relabelled
   by category, each first step on the card within 1e-5 of the CPU's
   (loss rel, gradients of a leaf's max), ms a batch, the loss per epoch
   (falling); (d) on (b)'s vectors: PCA of the 2,000 most frequent words
   to 10 (card vs CPU up to sign, rel 1e-4), k-means with k 20
   (assignments equal off near ties), t-SNE of 1,000 words with
   ``use_pca`` (ms for 500 iterations; the first 10 on the card against
   the CPU's within 1e-4 of the map or 10x the CPU run's own one-ulp
   movement); (e) ``serve --demo --embed-models word2vec,glove`` in a
   process of its own: ``POST /v1/embeddings`` with ``model: glove``
   returns the CPU demo model's vectors within 1e-5.
19. the correctness tooling, the loader and provision: (a) ``serve
   --sanitize`` at GPT-2-small width (the serve phases' geometry, with the
   sampling surface), slab and paged, each beside the same run without
   ``--sanitize`` (four processes at once): four greedy requests together,
   then one sampled; ``sanitizers: clean``, no ``dispatch`` entry in the
   sync counts, process-phase syncs within the horizons, streams
   byte-identical to the run without it; #1, #3 (#4 paged) and the draw
   launch in the sanitized process, which reports its counts and shapes;
   (b) ``audit --strict`` exits 0, and the sanitized slab run's
   ``/metrics`` gives the decode family's ``serve_mfu``/``serve_mbu``; (c)
   ``lint --strict`` exits 0; (d) ``PrefetchingLoader`` on the card at
   MNIST's size (60,000 x 784 uint8, batch 256, 3 epochs) bitwise the CPU
   loader in order, epoch labels and content, and the ms a batch; (e) a
   ``provision`` dry run prints the rendered commands.
20. a model axis across processes and the int8 KV cache over the training
   layout: (a) int8-cache generate (``decode_int8``, quantized weights) from
   GPT-2-small laid out on the (2, 3) mesh over ``cuda:0`` x 6, 8 prompts
   of 128 and 32 new, greedy, against single-device int8-cache generate
   at the float layout's bar (15a's: identical, or a reported near-tie
   under 0.1), with the layout's max |dlogit|; each rank's #3 launch takes
   the row's q and softmax-weight scales (the max of the ranks' maxima
   passes); #3 in int8 mode and its maxima pass once a step, layer and
   rank; (b) two ``train --coordinator ... --tp 2``
   processes without ``--device`` (15b's widths and recipe): the
   processes find that they share the card and pick gloo, the model axis
   spans them, their final losses are equal and within 2e-3 of the
   one-process (1, 2) run, #1/#2 launch once a step and layer, and each
   prints its ms a step, its cross-process collectives' ms and bytes
   through the host; (c) ZeRO-3 over a data axis across two processes (2
   layers): equal losses, the one-process (2, 2) FSDP run's, and the
   split leaves' params and AdamW bytes a process half of HSDP's; (d) MoE
   (2 experts, one a process) and the ring over a data axis across two
   processes (2 layers), against the one-process runs. Every process
   reports the shapes it launched #1-#3 at, held in phase 2.
21. long context at the reference's widths: (a) bench.py's
   transformer-flash-8k (d 512, 8 layers, 4 heads of 128, d_ff 2,048, V
   8,192, T 8,192, B 2) and transformer-flash-32k (T 32,768, B 1) through
   ``transformer_train_step`` with AdamW(3e-4), flash, no remat, bf16: a
   warm-up and 4 timed steps each (losses finite and falling, #1/#2 once a
   layer and step, ms a step, tokens/s, peak memory), and flash vs dense
   on a 2-layer cut at T 8,192, B 1 (phase 5's bars); (b) the -gqa-8kctx
   rows (GPT-2-small widths, 6 query heads over 2 KV heads, RoPE): greedy
   ``transformer_generate`` of 256 tokens after 8,192-token prompts at B
   16, bf16 and int8 full (prefill ms, decode tokens/s, the int8 tokens'
   agreement with bf16), and at B 1 flash prefill against dense prefill
   (identical or a near-tie); (c) the serving engine on bench.py:1051's
   trace (4 slots, 24 requests, 4 of 8,192 tokens and 20 of 512, half
   behind a 448-token prefix, 64 new, prefix cache on, bucket 512,
   arrivals every 20 ms on average), slab and paged (bs 8), piggyback
   off and on: streams byte-identical across the four, every paged block
   back, each stream against ``transformer_generate`` (identical or a
   near-tie), the long prompts' TTFT and the short streams' TPOT p99;
   the trace is replayed through ``run_request_trace``.
22. the serve trace: bench.py's serve row (``_bench_decode_serve``,
   bench.py:784, at GPT-2-small widths with 6 query heads over 2 KV heads,
   RoPE, bf16, flash prefill; 48 requests of 512 random prompt tokens and
   64 new, exponential arrivals of mean 10 ms, 16 slots, a queue of 48)
   through the port's ``run_request_trace``: (a) greedy at
   ``time_scale=0``, K 1, K 4 and paged (bs 8): streams byte-identical, 0
   blocks in use after, each stream against ``transformer_generate``
   (identical or a near-tie), #1 and #3 (#4 paged) launched; (b) sampled
   (T 1.0, top-k 40) under bench.py's seeded transient faults (rate 0.02)
   byte-identical to a clean sampled engine, retries > 0; (c) greedy under
   seeded crashes: restarts >= 1, (a)'s streams, and with
   ``max_restarts=0`` the crash propagates; (d) 8 requests into 1 slot
   behind a queue of 2 all finish; (e) ``run(max_steps=20)`` on the first
   16 requests returns with the engine not idle and ``run()`` then gives
   (a)'s streams; (f) (a)'s K
   1 run writes its metrics as JSONL (the reference's tags, one occupancy
   record a step, each <= 16); (g) K 1 and K 4 replayed at the trace's
   own times: generated tok/s, TTFT and TPOT p50/p99, mean occupancy.

The last lines are the kernel table as one JSON object, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import random
import shutil
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM published peaks (dense): HBM bytes/s and bf16 tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

#: H100 SXM published dense int8 tensor rate (operations/s)
INT8_OPS = 1979e12

#: H100 SXM published f32 rate outside the tensor cores (FLOP/s)
F32_FLOPS = 67e12

#: stated tolerances, kernel vs plain version on the same bf16 inputs: the
#: kernel's online softmax rounds its probabilities to bf16 against the
#: running max of each tile (the flash kernels) or of each 32-row stage of
#: a T split (the decode kernel), the plain version against the row max
ATTN_TOL = 2e-2
LSE_TOL = 1e-3
#: int8 decode kernels vs their plain versions, in bf16 steps of the
#: output: the same integer products, divisions and roundings in the same
#: order; only l, the sum of a tile's softmax weights, is added up in
#: another order, which can move the output's bf16 rounding by one step
INT8_STEPS = 1
#: flash backward vs its plain version, per gradient: the reference's own
#: on-device gate for its flash backward (bench.py:392); bf16 gradients,
#: summed in other orders
GRAD_REL, GRAD_ABS = 0.02, 0.01
#: a greedy mismatch between engine and generate is reported as a near-tie
#: (cuBLAS reduces an M=1 and an M=8 product in different orders) when the
#: generate side's top-2 logit gap at that position is below this
NEAR_TIE = 0.1
#: kernel #5 vs its plain version (f32): the dot is summed in another order
#: (the reference's own test holds its kernel to XLA at 1e-5)
EMB_TOL = 1e-5
#: word2vec fit on the card vs on the CPU from the same tables: the CPU
#: tests' bar for the port against the JAX package (last-bit differences of
#: the sums carried through every later batch, in a configuration that does
#: not amplify them)
W2V_TOL = 1e-4


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, reps: int = 10, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph, replayed ``reps`` times between CUDA events, so the host's
    launch path (the Python wrapper, ctypes) is left out. For calls that
    the host, not the card, bounds when launched one by one."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def bound(nbytes: float, flops: float,
          peak: float = BF16_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 1 -----------------------------------------------------------------

def phase_build() -> float:
    from deeplearning4j_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    secs = time.perf_counter() - t0
    log(f"build: {', '.join(built) or 'cached'} in {secs:.2f} s "
        f"({', '.join(_build.sources())})")
    for stem, text in sorted(_build.build_logs.items()):
        for name, used, frame in _ptxas_entries(text):
            log(f"  ptxas[{stem}] {name}: {used}; {frame}")
    return secs


def _ptxas_entries(text: str) -> list[tuple[str, str, str]]:
    """(kernel, registers line, stack and spill line) of every entry
    function in a ``ptxas -v`` log, the names demangled where the toolkit's
    ``cu++filt`` is found."""
    import re
    import shutil

    from deeplearning4j_tpu_torch.ops import _build

    rows, cur, frame = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur, frame = m.group(1), ""
        elif "stack frame" in line:
            frame = line.strip()
        elif "Used" in line and "registers" in line and cur:
            rows.append([cur, line.split(":", 1)[-1].strip(), frame])
            cur = None
    filt = (shutil.which("cu++filt", path=str(Path(_build.nvcc()).parent))
            or shutil.which("c++filt"))
    if filt and rows:
        out = subprocess.run([filt], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True, timeout=60)
        names = out.stdout.splitlines()
        if out.returncode == 0 and len(names) == len(rows):
            for r, n in zip(rows, names):
                n = re.sub(r"\(anonymous namespace\)::|<unnamed>::", "", n)
                n = n.replace("(bool)0", "false").replace("(bool)1", "true")
                n = re.sub(r"\(int\)(-?\d+)", r"\1", n)
                r[0] = n.removeprefix("void ").split("(", 1)[0]
    return [tuple(r) for r in rows]


# -- phase 2 -----------------------------------------------------------------

#: (kernel, shape) of every case phase 2 held against a plain version;
#: the run fails on a launch of #1-#5 or the draw in phases 3-10 at a shape
#: that is not among them
CHECKED_SHAPES: set[tuple] = set()


def _attn_key(name: str, q, causal: bool) -> tuple:
    return (name, tuple(q.shape), str(q.dtype), bool(causal))


def _decode_key(q, kvcache, n_kv_heads: int, block_t, kv_scales,
                outside: bool = False) -> tuple:
    """A decode launch's kernel mode (int8 with its scales from outside a
    mode of its own), q and cache shapes, dtype, KV heads and tile
    (``_tile``: the int8 tile; 0 for the bf16/f32 mode)."""
    from deeplearning4j_tpu_torch.ops import flash_decode as fd

    int8 = kv_scales is not None
    name = "flash_decode_int8" if int8 else "flash_decode"
    return (name + (" (scales from outside)" if outside else ""),
            tuple(q.shape), tuple(kvcache.shape), str(q.dtype),
            int(n_kv_heads),
            fd._tile(block_t, kvcache, kvcache.shape[3], int8))


def _maxima_key(q, kvcache, n_kv_heads: int, block_t) -> tuple:
    """A launch of int8 mode's maxima pass: as :func:`_decode_key`."""
    return ("flash_decode_int8_maxima",) + _decode_key(
        q, kvcache, n_kv_heads, block_t, True)[1:]


def _paged_key(q, blocks, tables, n_kv_heads: int, block_t,
               block_scales) -> tuple:
    """A paged decode launch's mode, q and table shapes, block size,
    layers, row width, dtype, KV heads and tile; the pool's block count
    only sizes the allocation the tables index."""
    from deeplearning4j_tpu_torch.ops import flash_decode as fd

    int8 = block_scales is not None
    t = tables.shape[1] * blocks.shape[3]
    return ("flash_decode_paged", tuple(q.shape), tuple(tables.shape),
            blocks.shape[3], blocks.shape[0], blocks.shape[4], str(q.dtype),
            int(n_kv_heads), int8, fd._tile(block_t, blocks, t, int8))


def _emb_key(mode: str, b: int, L: int, d: int) -> tuple:
    """A launch of #5: its mode (``dense`` or ``fused``) and (B, L, D)."""
    return ("emb_dot", mode, int(b), int(L), int(d))


def _draw_key(logits, pos) -> tuple:
    """A launch of the threefry draw: its mode (``rows``: per-row keys
    folded with a position; ``flat``: one key over the array) and (R, V)."""
    return ("threefry_draw", "flat" if pos is None else "rows",
            *map(int, logits.shape))


@contextlib.contextmanager
def launched_shapes():
    """Yields a set that gathers the key (``_attn_key``, ``_decode_key``,
    ``_maxima_key``, ``_paged_key``, ``_emb_key``, ``_draw_key``) of every
    launch of kernels #1-#5 (both decode modes and int8's maxima pass, both
    #5 modes) and of the threefry draw made
    inside the block: the wrappers' launch functions are wrapped, the
    launches and their counts left as they are."""
    from deeplearning4j_tpu_torch.ops import emb_dot
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import flash_decode as fd
    from deeplearning4j_tpu_torch.ops import threefry

    seen: set[tuple] = set()
    fwd, bwd, dec = fa._launch, fa._launch_bwd, fd._launch
    paged, maxima = fd._launch_paged, fd._launch_maxima
    dense, fused = emb_dot._launch, emb_dot._launch_hs
    draw = threefry._launch

    def on_fwd(q, k, v, causal):
        seen.add(_attn_key("flash_attn_fwd", q, causal))
        return fwd(q, k, v, causal)

    def on_bwd(q, k, v, o, lse, do, causal):
        seen.add(_attn_key("flash_attn_bwd", q, causal))
        return bwd(q, k, v, o, lse, do, causal)

    def on_dec(q, kvcache, pos, n_kv_heads, layer, block_t=None,
               kv_scales=None, q_scales=None, p_scales=None):
        seen.add(_decode_key(q, kvcache, n_kv_heads, block_t, kv_scales,
                             q_scales is not None or p_scales is not None))
        return dec(q, kvcache, pos, n_kv_heads, layer, block_t, kv_scales,
                   q_scales, p_scales)

    def on_maxima(q, kvcache, pos, n_kv_heads, layer, block_t, kv_scales,
                  q_scales=None):
        seen.add(_maxima_key(q, kvcache, n_kv_heads, block_t))
        return maxima(q, kvcache, pos, n_kv_heads, layer, block_t,
                      kv_scales, q_scales)

    def on_paged(q, blocks, tables, pos, n_kv_heads, layer, block_t=None,
                 block_scales=None):
        seen.add(_paged_key(q, blocks, tables, n_kv_heads, block_t,
                            block_scales))
        return paged(q, blocks, tables, pos, n_kv_heads, layer, block_t,
                     block_scales)

    def on_dense(h, w_rows, mask):
        seen.add(_emb_key("dense", *w_rows.shape))
        return dense(h, w_rows, mask)

    def on_fused(S, v, inputs, codes, points, mask, lr, dest, out):
        seen.add(_emb_key("fused", *points.shape, S.shape[1]))
        return fused(S, v, inputs, codes, points, mask, lr, dest, out)

    def on_draw(logits, keys, pos):
        seen.add(_draw_key(logits, pos))
        return draw(logits, keys, pos)

    fa._launch, fa._launch_bwd, fd._launch = on_fwd, on_bwd, on_dec
    fd._launch_paged, fd._launch_maxima = on_paged, on_maxima
    emb_dot._launch, emb_dot._launch_hs = on_dense, on_fused
    threefry._launch = on_draw
    try:
        yield seen
    finally:
        fa._launch, fa._launch_bwd, fd._launch = fwd, bwd, dec
        fd._launch_paged, fd._launch_maxima = paged, maxima
        emb_dot._launch, emb_dot._launch_hs = dense, fused
        threefry._launch = draw


def check_launched(tag: str, seen: set[tuple]) -> None:
    """Fails unless phase 2 held every key in ``seen`` against the plain
    version."""
    unchecked = sorted(seen - CHECKED_SHAPES, key=str)
    log(f"{tag}: kernels #1-#5 and the draw launched at {len(seen)} "
        f"(kernel, shape) "
        f"keys, {len(seen) - len(unchecked)} of them held against the plain "
        f"version in phase 2")
    if unchecked:
        raise SystemExit(f"{tag}: launches at shapes phase 2 never held "
                         f"against the plain version: {unchecked}")


def _plain_attn(t: int):
    """The plain versions phase 2 holds #1 and #2 to at T: the row-blocked
    ones from :data:`LONG_T` on (the unblocked ones build (BH, T, T) f32
    tensors: 17 GB a tensor at BH 4, T 32,768)."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    if t >= LONG_T:
        return (fa.flash_attention_fwd_plain_blocked,
                fa.flash_attention_bwd_plain_blocked)
    return fa.flash_attention_fwd_plain, fa.flash_attention_bwd_plain


def _attn_case(t: int, causal: bool, bh: int = 6, d: int = 128,
               iters: int = 50) -> dict:
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    fwd_plain = _plain_attn(t)[0]
    warmup = min(5, iters)
    g = torch.Generator(device="cuda").manual_seed(1000 + t)
    q, k, v = (torch.randn((bh, t, d), generator=g, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    o_ref, lse_ref = fwd_plain(q, k, v, causal)
    CHECKED_SHAPES.add(_attn_key("flash_attn_fwd", q, causal))
    torch.cuda.synchronize()
    err = (o.float() - o_ref.float()).abs().max().item()
    lse_err = (lse - lse_ref).abs().max().item()
    finite = bool(torch.isfinite(o.float()).all())
    ok = finite and err <= ATTN_TOL and lse_err <= LSE_TOL
    ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal), iters,
                 warmup)
    plain_ms = time_ms(lambda: fwd_plain(q, k, v, causal), iters, warmup)
    q4, k4, v4 = (x.view(1, bh, t, d) for x in (q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=causal), iters, warmup)
    pairs = t * (t + 1) // 2 if causal else t * t
    b_ms, b_by = bound(4 * bh * t * d * 2 + bh * t * 4, 4 * bh * pairs * d)
    log(f"kernel flash_attn_fwd BH={bh} T={t} D={d} causal={causal}"
        f"{' (row-blocked plain)' if t >= LONG_T else ''}: "
        f"max_abs_err {err:.3e} (tol {ATTN_TOL}), lse err {lse_err:.3e} "
        f"(tol {LSE_TOL}), ms {ms:.4f}, plain_ms {plain_ms:.4f}, "
        f"bound_ms {b_ms:.6f} ({b_by}), library_ms {lib_ms:.4f} "
        f"-> {'ok' if ok else 'FAIL'}")
    _log_rate("flash_attn_fwd", fa.fwd_body(q.dtype, d),
              4 * bh * pairs * d, ms, b_ms, lib_ms)
    return dict(ok=ok, max_abs_err=max(err, lse_err), ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


#: batched admission's group sizes (padded to powers of two) and the
#: engine's prefill buckets (8 to 128 rows)
BATCH_ROWS = (2, 4, 8)
PREFILL_BUCKETS = (8, 16, 32, 64, 128)


def _attn_rows_case(t: int, nb: int, heads: int = 6, d: int = 128) -> dict:
    """Kernel #1 over ``nb`` prompts' heads in one launch against each
    prompt's heads launched alone: out and lse bitwise, block for block
    (each (b, h) tile is computed on its own)."""
    import torch

    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(2000 + t)
    q, k, v = (torch.randn((heads * nb, t, d), generator=g, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    same = 0
    for i in range(nb):
        rows = slice(i * heads, (i + 1) * heads)
        o1, lse1 = fa.flash_attention_fwd(q[rows], k[rows], v[rows], True)
        same += torch.equal(o[rows], o1) and torch.equal(lse[rows], lse1)
    log(f"kernel flash_attn_fwd BH={heads * nb} T={t} D={d} causal=True: "
        f"{same}/{nb} blocks of {heads} rows bitwise a BH {heads} launch of "
        f"the same rows -> {'ok' if same == nb else 'FAIL'}")
    return dict(ok=same == nb)


def _rank_rows_case(t: int, b: int, heads: int, dp: int, tp: int,
                    d: int = 128) -> dict:
    """#1 and #2 over each (data, model) rank's rows (its b/dp batch rows
    x heads/tp heads, as a mesh step launches them) against one launch
    over all b x heads rows: out, lse and dQ, dK, dV bitwise, rank for
    rank (each (b, h) tile is computed on its own)."""
    import torch

    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(4000 + t)
    q, k, v, do = (torch.randn((b * heads, t, d), generator=g, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
    fwd_same = bwd_same = 0
    for di in range(dp):
        for m in range(tp):
            idx = torch.tensor(
                [bi * heads + h
                 for bi in range(di * b // dp, (di + 1) * b // dp)
                 for h in range(m * heads // tp, (m + 1) * heads // tp)],
                device="cuda")
            qr, kr, vr, dor = (x[idx].contiguous() for x in (q, k, v, do))
            o1, lse1 = fa.flash_attention_fwd(qr, kr, vr, True)
            fwd_same += torch.equal(o[idx], o1) and torch.equal(lse[idx],
                                                                lse1)
            g1 = fa.flash_attention_bwd(qr, kr, vr, o1, lse1, dor, True)
            bwd_same += all(torch.equal(x[idx], y)
                            for x, y in zip(grads, g1))
    n = dp * tp
    ok = fwd_same == n and bwd_same == n
    log(f"kernel flash_attn_fwd/bwd BH={b * heads} T={t} D={d} causal=True "
        f"over a ({dp}, {tp}) mesh's ranks: forward {fwd_same}/{n}, "
        f"backward {bwd_same}/{n} ranks' rows bitwise a launch over those "
        f"rows alone (BH {b // dp * heads // tp}) -> "
        f"{'ok' if ok else 'FAIL'}")
    return dict(ok=ok)


def _log_rate(name: str, body: str, flops: float, ms: float, b_ms: float,
              lib_ms: float) -> None:
    """The body a flash call took, its rate on the work the function needs,
    its share of the bound, and its factor over the library call."""
    log(f"  {name} body {body}: {flops / ms / 1e9:.1f} TFLOP/s of needed "
        f"work, {b_ms / ms:.4f} of the bound, {ms / lib_ms:.3f}x the "
        f"library call")


def _bwd_case(t: int, causal: bool, bh: int = 6, d: int = 128,
              iters: int = 50) -> dict:
    """Kernel #2 against its plain version. Times the wrapper (the delta
    reduction and both passes), the plain version, and the library's
    backward: SDPA forward + backward minus its forward alone."""
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    bwd_plain = _plain_attn(t)[1]
    warmup = min(5, iters)
    g = torch.Generator(device="cuda").manual_seed(3000 + t + bh)
    q, k, v, do = (torch.randn((bh, t, d), generator=g, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    refs = bwd_plain(q, k, v, o, lse, do, causal)
    CHECKED_SHAPES.add(_attn_key("flash_attn_bwd", q, causal))
    torch.cuda.synchronize()
    ok, worst, same = True, 0.0, True
    for x, r, x2 in zip(grads, refs, again):
        err = (x.float() - r.float()).abs().max().item()
        tol = GRAD_REL * r.float().abs().max().item() + GRAD_ABS
        ok = ok and bool(torch.isfinite(x.float()).all()) and err <= tol
        worst = max(worst, err)
        same = same and torch.equal(x, x2)
    ms = time_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, causal),
                 iters, warmup)
    plain_ms = time_ms(lambda: bwd_plain(q, k, v, o, lse, do, causal), iters,
                       warmup)
    q4, k4, v4 = (x.view(1, bh, t, d).detach().requires_grad_()
                  for x in (q, k, v))
    do4 = do.view(1, bh, t, d)

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)

    lib_ms = (time_ms(lambda: torch.autograd.grad(sdpa(), (q4, k4, v4), do4),
                      iters, warmup)
              - time_ms(sdpa, iters, warmup))
    pairs = t * (t + 1) // 2 if causal else t * t
    # reads q, k, v, O, dO and lse, writes dQ, dK, dV; the 5 products the
    # backward needs (the kernel recomputes S and dP: 7)
    b_ms, b_by = bound(8 * bh * t * d * 2 + bh * t * 4, 10 * bh * pairs * d)
    log(f"kernel flash_attn_bwd BH={bh} T={t} D={d} causal={causal}"
        f"{' (row-blocked plain)' if t >= LONG_T else ''}: "
        f"max_abs_err {worst:.3e} (tol {GRAD_REL} * max|ref| + {GRAD_ABS} "
        f"per gradient), deterministic {same}, ms {ms:.4f}, plain_ms "
        f"{plain_ms:.4f}, bound_ms {b_ms:.6f} ({b_by}), library_ms "
        f"{lib_ms:.4f} -> {'ok' if ok and same else 'FAIL'}")
    _log_rate("flash_attn_bwd", fa.bwd_body(q.dtype, d),
              10 * bh * pairs * d, ms, b_ms, lib_ms)
    return dict(ok=ok and same, max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def _decode_case(b: int, g: int, hkv: int, kd: int, nl: int, tpad: int,
                 layer: int, pos: list[int]) -> dict:
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import flash_decode as fd

    hk = hkv * kd
    gen = torch.Generator(device="cuda").manual_seed(2000 + hk)
    q = torch.randn((b, g, hk), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    cache = torch.randn((nl, 2, b, tpad, hk), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
    p = torch.tensor(pos, dtype=torch.int32, device="cuda")
    out = fd.flash_decode_attention(q, cache, p, hkv, layer)
    grid, cluster = fd.last_launch()
    ref = fd.flash_decode_attention_plain(q, cache, p, hkv, layer)
    CHECKED_SHAPES.add(_decode_key(q, cache, hkv, None, None))
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    ok = bool(torch.isfinite(out.float()).all()) and err <= ATTN_TOL
    run = lambda: fd.flash_decode_attention(q, cache, p, hkv, layer)  # noqa
    ms, dev_ms = time_ms(run), graph_ms(run)
    plain_ms = time_ms(
        lambda: fd.flash_decode_attention_plain(q, cache, p, hkv, layer))
    q4 = q.view(b, g, hkv, kd).permute(0, 2, 1, 3)
    k4 = cache[layer, 0].view(b, tpad, hkv, kd).permute(0, 2, 1, 3)
    v4 = cache[layer, 1].view(b, tpad, hkv, kd).permute(0, 2, 1, 3)
    mask = (torch.arange(tpad, device="cuda")[None, :] <= p[:, None].long())
    mask = mask[:, None, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q4, k4, v4, attn_mask=mask)
    lib_ms, lib_dev_ms = time_ms(sdpa), graph_ms(sdpa)
    rows = sum(min(x + 1, tpad) for x in pos)
    b_ms, b_by = bound(2 * rows * hk * 2 + 2 * b * g * hk * 2 + 4 * b,
                       4 * rows * hk * g)
    log(f"kernel flash_decode B={b} G={g} Hkv*K={hk} nl={nl} Tpad={tpad} "
        f"layer={layer} pos={pos}: max_abs_err {err:.3e} (tol {ATTN_TOL}), "
        f"ms {ms:.4f} (graph_ms {dev_ms:.4f}; grid {grid}, cluster "
        f"{cluster}), plain_ms {plain_ms:.4f}, bound_ms {b_ms:.6f} "
        f"({b_by}), library_ms {lib_ms:.4f} (graph_ms {lib_dev_ms:.4f}) "
        f"-> {'ok' if ok else 'FAIL'}")
    return dict(ok=ok, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                graph_ms=dev_ms, library_graph_ms=lib_dev_ms)


def _int8_err(out, ref) -> tuple[float, float]:
    """max |out - ref|, and max |out - ref| in units of one bf16 step (ulp)
    of ref's binade."""
    import torch

    r = ref.float()
    err = (out.float() - r).abs()
    step = torch.ldexp(torch.ones_like(r), torch.frexp(r).exponent - 8)
    return err.max().item(), (err / step).max().item()


def _int8_store(gen, shape):
    import torch

    kv = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                       dtype=torch.int8)
    scales = torch.rand(shape[:4] + (1,), generator=gen, device="cuda") * 0.02
    return kv, scales


def _int8_bytes(rows: int, hk: int, b: int, g: int) -> int:
    """What int8 decode must move: each visible K and V row once (int8 plus
    a 4-byte scale), q read and out written in bf16, pos."""
    return 2 * rows * (hk + 4) + 2 * b * g * hk * 2 + 4 * b


def _decode_int8_case(b: int, g: int, hkv: int, kd: int, nl: int, tpad: int,
                      layer: int, pos: list[int],
                      block_t: int | None = None,
                      bitwise: bool = False) -> dict:
    """Kernel #3 in int8 mode against its plain version, at ``block_t``
    (default: the reference's tile for this cache). Reports whether the
    output is bitwise the plain version's; ``bitwise`` makes that the
    bar."""
    import torch

    from deeplearning4j_tpu_torch.ops import flash_decode as fd

    hk = hkv * kd
    gen = torch.Generator(device="cuda").manual_seed(4000 + hk + g)
    q = torch.randn((b, g, hk), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    cache, scales = _int8_store(gen, (nl, 2, b, tpad, hk))
    p = torch.tensor(pos, dtype=torch.int32, device="cuda")
    bt = block_t or fd.default_block_t(tpad, hk, 1)
    out = fd.flash_decode_attention(q, cache, p, hkv, layer, block_t,
                                    kv_scales=scales)
    grid, cluster = fd.last_launch()
    scores = ("scratch" if fd._needs_scratch(g, hkv, bt, tpad)
              else "shared memory")
    ref = fd.flash_decode_attention_plain(q, cache, p, hkv, layer, block_t,
                                          kv_scales=scales)
    CHECKED_SHAPES.add(_decode_key(q, cache, hkv, block_t, scales))
    torch.cuda.synchronize()
    err, steps = _int8_err(out, ref)
    same = torch.equal(out, ref)
    ok = (bool(torch.isfinite(out.float()).all()) and steps <= INT8_STEPS
          and (same or not bitwise))
    run = lambda: fd.flash_decode_attention(  # noqa: E731
        q, cache, p, hkv, layer, block_t, kv_scales=scales)
    ms, dev_ms = time_ms(run), graph_ms(run)
    plain_ms = time_ms(lambda: fd.flash_decode_attention_plain(
        q, cache, p, hkv, layer, block_t, kv_scales=scales), iters=10)
    rows = sum(min(x + 1, tpad) for x in pos)
    b_ms, b_by = bound(_int8_bytes(rows, hk, b, g), 4 * rows * hk * g,
                       INT8_OPS)
    log(f"kernel flash_decode_int8 B={b} G={g} Hkv*K={hk} nl={nl} "
        f"Tpad={tpad} layer={layer} pos={pos} block_t={bt}"
        f"{' (the reference default)' if block_t is None else ''}: "
        f"max_abs_err {err:.3e}, {steps:.3f} bf16 steps (tol {INT8_STEPS}), "
        f"bitwise {same}{' (required)' if bitwise else ''}, "
        f"ms {ms:.4f} (graph_ms {dev_ms:.4f}; grid {grid}, cluster "
        f"{cluster}; scores in {scores}), plain_ms {plain_ms:.4f}, bound_ms "
        f"{b_ms:.6f} ({b_by}), library_ms none -> {'ok' if ok else 'FAIL'}")
    return dict(ok=ok, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                graph_ms=dev_ms)


def _decode_int8_outside_case(b: int, g: int, hkv: int, tp: int, kd: int,
                              nl: int, tpad: int, layer: int,
                              pos: list[int]) -> dict[str, dict]:
    """int8 mode over ``tp`` ranks of a row of ``hkv`` KV heads, each rank
    launching over its ``hkv // tp`` heads at the row's default tile, as
    ``_MeshDecode.decode_ranks`` does: each rank's maxima pass, then the
    full pass under the row's q scales and the max of the ranks' maxima
    over 127. Both modes bitwise their plain versions, and the ranks'
    rows bitwise a single launch over the row. Over the whole row under
    random q scales that differ across every (group, KV head) lane: the
    maxima pass bitwise plain, the full pass within ``INT8_STEPS`` of
    plain (as every int8 case: l is summed in another order), and each
    lane bitwise its KV head launched alone under its own scale. Times
    both at rank 0's shape; returns {"maxima": ..., "outside": ...}."""
    import torch

    from deeplearning4j_tpu_torch.ops import flash_decode as fd

    hk, kv_r = hkv * kd, hkv // tp
    gen = torch.Generator(device="cuda").manual_seed(9000 + hk + g)
    q = torch.randn((b, g, hk), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    cache, scales = _int8_store(gen, (nl, 2, b, tpad, hk))
    p = torch.tensor(pos, dtype=torch.int32, device="cuda")
    bt = fd.default_block_t(tpad, hk, 1)
    want = fd.flash_decode_attention(q, cache, p, hkv, layer, bt,
                                     kv_scales=scales)
    qsc = fd._div127(q.float().abs().amax(-1).clamp_min(1e-8))
    ranks = [(q.view(b, g, hkv, kd)[:, :, m * kv_r:(m + 1) * kv_r]
              .reshape(b, g, -1).contiguous(),
              cache.view(nl, 2, b, tpad, hkv, kd)[..., m * kv_r:
                                                  (m + 1) * kv_r, :]
              .reshape(nl, 2, b, tpad, -1).contiguous()) for m in range(tp)]
    q_scales = qsc[..., None].expand(b, g, kv_r).contiguous()
    maxima = [fd.flash_decode_int8_maxima(qm, km, p, kv_r, layer, bt,
                                          scales, q_scales)
              for qm, km in ranks]
    max_plain = [fd.flash_decode_int8_maxima_plain(qm, km, p, kv_r, layer,
                                                   bt, scales, q_scales)
                 for qm, km in ranks]
    max_same = sum(map(torch.equal, maxima, max_plain))
    p_scales = fd._div127(torch.stack(maxima).amax(0).clamp_min(1e-30))
    outs = [fd.flash_decode_attention(qm, km, p, kv_r, layer, bt, scales,
                                      q_scales, p_scales)
            for qm, km in ranks]
    out_plain = [fd.flash_decode_attention_plain(qm, km, p, kv_r, layer, bt,
                                                 scales, q_scales, p_scales)
                 for qm, km in ranks]
    out_same = sum(map(torch.equal, outs, out_plain))
    errs = {mode: max((x.float() - y.float()).abs().max().item()
                      for x, y in zip(got, ref))
            for mode, got, ref in (("maxima", maxima, max_plain),
                                   ("outside", outs, out_plain))}
    rows_same = torch.equal(torch.stack(outs, 2).reshape(b, g, hk), want)
    # one launch over the whole row under q scales that differ across
    # every (group, KV head) lane: the maxima pass bitwise plain, the full
    # pass within INT8_STEPS of plain (l's sum order), and each lane
    # bitwise its KV head launched alone under that lane's scale, so each
    # lane reads its own
    lane_sc = (qsc[..., None] * (0.5 + torch.rand(
        (b, g, hkv), generator=gen, device="cuda"))).contiguous()
    lane_max = fd.flash_decode_int8_maxima(q, cache, p, hkv, layer, bt,
                                           scales, lane_sc)
    lane_psc = fd._div127(lane_max.clamp_min(1e-30))
    lane_out = fd.flash_decode_attention(q, cache, p, hkv, layer, bt, scales,
                                         lane_sc, lane_psc)
    lane_steps = _int8_err(lane_out, fd.flash_decode_attention_plain(
        q, cache, p, hkv, layer, bt, scales, lane_sc, lane_psc))[1]
    heads = cache[layer:layer + 1].view(1, 2, b, tpad, hkv, kd)
    alone = all(torch.equal(
        lane_out.view(b, g, hkv, kd)[:, :, h], fd.flash_decode_attention(
            q.view(b, g, hkv, kd)[:, :, h].contiguous(),
            heads[..., h, :].contiguous(), p, 1, 0, bt,
            scales[layer:layer + 1], lane_sc[:, :, h:h + 1].contiguous(),
            lane_psc)) for h in range(hkv))
    lanes_ok = (torch.equal(lane_max, fd.flash_decode_int8_maxima_plain(
        q, cache, p, hkv, layer, bt, scales, lane_sc))
        and lane_steps <= INT8_STEPS and alone)
    q0, k0 = ranks[0]
    CHECKED_SHAPES.add(_maxima_key(q0, k0, kv_r, bt))
    CHECKED_SHAPES.add(_decode_key(q0, k0, kv_r, bt, scales, True))
    torch.cuda.synchronize()
    ok = max_same == tp and out_same == tp and rows_same and lanes_ok
    hk_r = kv_r * kd
    verdict = (f"kernel flash_decode_int8 over {tp} ranks of a row (B={b} "
               f"G={g} Hkv*K={hk}, a rank's {hk_r}) nl={nl} Tpad={tpad} "
               f"layer={layer} pos={pos} block_t={bt} (the row's default): "
               f"maxima pass bitwise plain on {max_same}/{tp} ranks, scales "
               f"from outside bitwise plain on {out_same}/{tp}, the ranks' "
               f"rows bitwise the single launch's {rows_same}; over the "
               f"row under a q scale a lane (G {g} x Hkv {hkv}, each "
               f"different): maxima pass bitwise plain, the full pass "
               f"{lane_steps:.3f} bf16 steps from plain (tol {INT8_STEPS}), "
               f"each lane bitwise its KV head alone {alone} -> "
               f"{'ok' if lanes_ok else 'FAIL'}")
    rows = sum(min(x + 1, tpad) for x in pos)
    n_t = -(-tpad // bt)
    res = {}
    for mode, run, plain, nbytes, ops in (
            ("maxima",
             lambda: fd.flash_decode_int8_maxima(q0, k0, p, kv_r, layer, bt,
                                                 scales, q_scales),
             lambda: fd.flash_decode_int8_maxima_plain(
                 q0, k0, p, kv_r, layer, bt, scales, q_scales),
             # the K rows with both scales, q and its scales, the maxima
             rows * (hk_r + 8) + b * g * hk_r * 2 + b * g * kv_r * 4
             + b * n_t * 4 + 4 * b, 2 * rows * hk_r * g),
            ("outside",
             lambda: fd.flash_decode_attention(q0, k0, p, kv_r, layer, bt,
                                               scales, q_scales, p_scales),
             lambda: fd.flash_decode_attention_plain(
                 q0, k0, p, kv_r, layer, bt, scales, q_scales, p_scales),
             _int8_bytes(rows, hk_r, b, g) + b * g * kv_r * 4 + b * n_t * 4,
             4 * rows * hk_r * g)):
        ms, dev_ms = time_ms(run), graph_ms(run)
        plain_ms = time_ms(plain, iters=10)
        b_ms, b_by = bound(nbytes, ops, INT8_OPS)
        res[mode] = dict(ok=ok, max_abs_err=errs[mode], ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=None, graph_ms=dev_ms)
    log(f"{verdict}; at rank 0's shape maxima ms "
        f"{res['maxima']['ms']:.4f} (graph_ms {res['maxima']['graph_ms']:.4f}"
        f"), plain_ms {res['maxima']['plain_ms']:.4f}, bound_ms "
        f"{res['maxima']['bound_ms']:.6f} ({res['maxima']['bound_by']}); "
        f"scales from outside ms {res['outside']['ms']:.4f} (graph_ms "
        f"{res['outside']['graph_ms']:.4f}), plain_ms "
        f"{res['outside']['plain_ms']:.4f}, bound_ms "
        f"{res['outside']['bound_ms']:.6f} ({res['outside']['bound_by']}), "
        f"library_ms none -> {'ok' if ok else 'FAIL'}")
    return res


def _batch_case(int8: bool, pos: list[int], hkv: int = 6, kd: int = 128,
                nl: int = 12, tpad: int = 640, layer: int = 7) -> dict:
    """Every row of a B 8 launch of kernel #3 decoded again alone (B 1):
    bitwise equal, and a second B 8 launch bitwise equal to the first."""
    import torch

    from deeplearning4j_tpu_torch.ops import flash_decode as fd

    b, hk = len(pos), hkv * kd
    gen = torch.Generator(device="cuda").manual_seed(7000 + int8)
    q = torch.randn((b, 1, hk), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    if int8:
        cache, scales = _int8_store(gen, (nl, 2, b, tpad, hk))
    else:
        cache = torch.randn((nl, 2, b, tpad, hk), generator=gen,
                            device="cuda", dtype=torch.bfloat16)
        scales = None
    p = torch.tensor(pos, dtype=torch.int32, device="cuda")
    out = fd.flash_decode_attention(q, cache, p, hkv, layer,
                                    kv_scales=scales)
    again = torch.equal(out, fd.flash_decode_attention(
        q, cache, p, hkv, layer, kv_scales=scales))
    alone = [torch.equal(out[i], fd.flash_decode_attention(
        q[i:i + 1].contiguous(), cache[:, :, i:i + 1].contiguous(),
        p[i:i + 1], hkv, layer,
        kv_scales=None if scales is None
        else scales[:, :, i:i + 1].contiguous())[0]) for i in range(b)]
    ok = again and all(alone)
    log(f"kernel flash_decode{'_int8' if int8 else ''} B 1 vs B 8 pos={pos}: "
        f"rows bitwise equal {sum(alone)}/{b}, run vs run bitwise {again} "
        f"-> {'ok' if ok else 'FAIL'}")
    return dict(ok=ok)


def _paged_case(int8: bool, bs: int, pos: list[int], b: int = 8,
                hkv: int = 6, kd: int = 128, nl: int = 12, tpad: int = 640,
                layer: int = 7, g: int = 1) -> dict:
    """Kernel #4 against its plain version and BITWISE against kernel #3
    over the gathered slab: shuffled tables over a pool with spare blocks,
    one block aliased by rows 0 and 1, the sentinel zeroed."""
    import torch

    from deeplearning4j_tpu_torch.ops import flash_decode as fd

    hk = hkv * kd
    bps = tpad // bs
    gen = torch.Generator(device="cuda").manual_seed(5000 + bs + int8)
    q = torch.randn((b, g, hk), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    n_blocks = b * bps + 9
    perm = torch.randperm(n_blocks - 1, generator=gen, device="cuda") + 1
    tables = perm[:b * bps].reshape(b, bps).to(torch.int32).contiguous()
    tables[1, 0] = tables[0, 0]
    shape = (nl, 2, n_blocks, bs, hk)
    if int8:
        blocks, scales = _int8_store(gen, shape)
    else:
        blocks = torch.randn(shape, generator=gen, device="cuda",
                             dtype=torch.bfloat16)
        scales = None
    blocks[:, :, 0] = 0
    p = torch.tensor(pos, dtype=torch.int32, device="cuda")

    def run():
        return fd.flash_decode_attention_paged(q, blocks, tables, p, hkv,
                                               layer, block_scales=scales)

    def plain():
        return fd.flash_decode_attention_paged_plain(
            q, blocks, tables, p, hkv, layer, block_scales=scales)

    out = run()
    grid, cluster = fd.last_launch()
    ref = plain()
    CHECKED_SHAPES.add(_paged_key(q, blocks, tables, hkv, None, scales))
    slab = fd._gather_rows(blocks, tables, layer).contiguous()
    sslab = (None if scales is None
             else fd._gather_rows(scales, tables, layer).contiguous())
    slab_out = fd.flash_decode_attention(q, slab, p, hkv, 0,
                                         kv_scales=sslab)
    torch.cuda.synchronize()
    bitwise = torch.equal(out, slab_out)
    finite = bool(torch.isfinite(out.float()).all())
    if int8:
        err, steps = _int8_err(out, ref)
        ok = finite and steps <= INT8_STEPS
        tol = f"{steps:.3f} bf16 steps, tol {INT8_STEPS}"
    else:
        err = (out.float() - ref.float()).abs().max().item()
        ok = finite and err <= ATTN_TOL
        tol = f"tol {ATTN_TOL}"
    ms, dev_ms = time_ms(run), graph_ms(run)
    plain_ms = time_ms(plain, iters=10)
    rows = sum(min(x + 1, tpad) for x in pos)
    tab = 4 * sum(-(-min(x + 1, tpad) // bs) for x in pos)
    if int8:
        nbytes = _int8_bytes(rows, hk, b, g) + tab
        b_ms, b_by = bound(nbytes, 4 * rows * hk * g, INT8_OPS)
    else:
        b_ms, b_by = bound(2 * rows * hk * 2 + 2 * b * g * hk * 2 + 4 * b
                           + tab, 4 * rows * hk * g)
    ok = ok and bitwise
    log(f"kernel flash_decode_paged {'int8' if int8 else 'bf16'} bs={bs} "
        f"B={b} G={g} Hkv*K={hk} nl={nl} Tpad={tpad} layer={layer}: "
        f"max_abs_err "
        f"{err:.3e} ({tol}), bitwise == slab kernel on the gathered slab "
        f"{bitwise}, ms {ms:.4f} (graph_ms {dev_ms:.4f}; grid {grid}, "
        f"cluster {cluster}), plain_ms {plain_ms:.4f}, bound_ms {b_ms:.6f} "
        f"({b_by}), library_ms none -> {'ok' if ok else 'FAIL'}")
    return dict(ok=ok, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                graph_ms=dev_ms)


def _emb_dot_case(b: int, L: int, d: int, planted: bool = False,
                  iters: int = 50) -> dict:
    """Kernel #5 and its range flag against the plain version: HS-shaped
    inputs (each row's path a random length, the rest masked; dots of a
    few units, some saturated), and with ``planted`` a quarter of the rows
    masked out whole and dots planted at 6 -+ 1e-3."""
    import torch

    from deeplearning4j_tpu_torch.ops import emb_dot

    gen = torch.Generator(device="cuda").manual_seed(6000 + L + planted)
    h = torch.randn((b, d), generator=gen, device="cuda") * 0.5
    w = torch.randn((b, L, d), generator=gen, device="cuda") * 0.5
    lens = torch.randint(1, L + 1, (b, 1), generator=gen, device="cuda")
    mask = (torch.arange(L, device="cuda")[None] < lens).float()
    if planted:
        mask[: b // 4] = 0.0
        sel = torch.randint(0, 4, (b, L), generator=gen, device="cuda")
        target = torch.tensor([6 - 1e-3, -(6 - 1e-3), 6 + 1e-3, -(6 + 1e-3)],
                              dtype=torch.float64, device="cuda")[sel]
        h64 = h.double()
        w = (h64 / (h64 * h64).sum(-1, keepdim=True))[:, None, :] * target[
            ..., None]
        w = w.float().contiguous()
    CHECKED_SHAPES.add(_emb_key("dense", b, L, d))
    f, in_range = emb_dot.fused_embedding_dot_range(h, w, mask)
    f_ref, in_ref = emb_dot.fused_embedding_dot_range_plain(h, w, mask)
    torch.cuda.synchronize()
    err = (f - f_ref).abs().max().item()
    flags_equal = torch.equal(in_range, in_ref)
    ok = bool(torch.isfinite(f).all()) and err <= EMB_TOL and flags_equal
    if planted:
        ok = ok and torch.equal(in_range, (target.abs() < 6).float())
    saturated = int((in_range == 0).sum())
    run = lambda: emb_dot.fused_embedding_dot_range(h, w, mask)  # noqa: E731
    ms, dev_ms = time_ms(run, iters), graph_ms(run)
    plain_ms = time_ms(
        lambda: emb_dot.fused_embedding_dot_range_plain(h, w, mask), iters)
    hv = h[:, :, None]
    bmm_ms = time_ms(lambda: torch.bmm(w, hv), iters)
    # reads w, h and mask, writes f and the flag (f32); an FMA per element
    # of w
    b_ms, b_by = bound(4 * (b * L * d + b * d + 3 * b * L), 2 * b * L * d,
                       F32_FLOPS)
    log(f"kernel emb_dot B={b} L={L} D={d}"
        f"{' planted |dot| = 6 -+ 1e-3, masked rows' if planted else ''}: "
        f"max_abs_err {err:.3e} (tol {EMB_TOL}), range flags equal "
        f"{flags_equal} ({saturated} saturated of {b * L}), ms {ms:.4f} "
        f"(graph_ms {dev_ms:.4f}), plain_ms {plain_ms:.4f}, bound_ms {b_ms:.6f} ({b_by}), "
        f"library_ms none (torch.bmm of the dot alone: {bmm_ms:.4f}) -> "
        f"{'ok' if ok else 'FAIL'}")
    return dict(ok=ok, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                graph_ms=dev_ms, bmm_dot_ms=bmm_ms)


def _emb_dot_hs_batch(kind: str, model, corpus, gen, shape=None):
    """A fused-mode batch at phase 6's width (B 4,096, D 100): (S, v,
    inputs, codes, points, mask, planted dots or None). ``L16``: a random
    table of phase 6's size (V + V - 1 rows), random inputs and paths of
    16 entries (or of ``shape``'s (B, L, D)), each row a random prefix;
    ``planted``: phase 6's longest path, a quarter of the rows masked out whole, every entry its own syn1
    row with its dot planted at 6 -+ 1e-3; ``phase6``: phase 6's first
    batch of pairs (the fit's first chunk) and its Huffman paths over a
    random table of its size."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch import native_io

    b, d = W2V_BATCH, W2V_DIM
    nv = len(model.cache)
    L = model.cache.max_code_length
    dev = "cuda"
    t = None
    if kind == "phase6":
        codes, points, mask = model._huffman()
        ids = [np.asarray(model.cache.encode(model.tokenize(s)), np.int32)
               for s in corpus[:1]]
        ins, tgts = native_io.sg_pairs_chunk(ids, model.window, model.seed)
        if len(ins) < b:
            raise SystemExit(f"phase 6's first chunk holds {len(ins)} pairs, "
                             f"fewer than a batch")
        inputs = torch.from_numpy(ins[:b].astype(np.int64)).to(dev)
        tg = torch.from_numpy(tgts[:b].astype(np.int64)).to(dev)
        codes, points, mask = codes[tg], points[tg], mask[tg]
        S = torch.randn((2 * nv - 1, d), generator=gen, device=dev) * 0.5
        return S, nv, inputs, codes, points, mask, t
    if kind == "L16":
        b, L, d = shape or (b, 16, d)
        S = torch.randn((2 * nv - 1, d), generator=gen, device=dev) * 0.5
        v = nv
        inputs = torch.randint(0, nv, (b,), generator=gen, device=dev)
        points = torch.randint(0, nv - 1, (b, L), generator=gen, device=dev)
    else:  # planted
        v = b
        S = torch.randn((b + b * L, d), generator=gen, device=dev) * 0.5
        inputs = torch.randperm(b, generator=gen, device=dev)
        points = torch.randperm(b * L, generator=gen, device=dev).view(b, L)
    codes = torch.randint(0, 2, (b, L), generator=gen, device=dev).float()
    lens = torch.randint(1, L + 1, (b, 1), generator=gen, device=dev)
    mask = (torch.arange(L, device=dev)[None] < lens).float()
    if kind == "planted":
        mask[: b // 4] = 0.0
        sel = torch.randint(0, 4, (b, L), generator=gen, device=dev)
        t = torch.tensor([6 - 1e-3, -(6 - 1e-3), 6 + 1e-3, -(6 + 1e-3)],
                         dtype=torch.float64, device=dev)[sel]
        h64 = S[inputs].double()
        unit = h64 / (h64 * h64).sum(-1, keepdim=True)
        S[v + points] = (unit[:, None, :] * t[..., None]).float()
    return S, v, inputs, codes, points, mask, t


def _emb_dot_hs_case(kind: str, model, corpus, iters: int = 50,
                     shape=None, timed: bool = False) -> dict:
    """Kernel #5's fused mode as the HS step calls it (``dest`` from the
    scatter plan) against its plain version: every kept entry (grad_in and
    the delta rows of valid path entries) within EMB_TOL, written into a
    NaN-filled buffer; the range flags equal (a kept path entry's delta row
    is exactly zero where its dot is saturated; with planted dots, exactly
    where |t| > 6); the masked entries left unwritten (NaN); a second
    launch bitwise equal. Bound: each distinct row read once, the index
    arrays, and the kept delta rows written once (logged beside it: the
    bound with each row read per use, which the result line leaves out as
    it holds only measured numbers and ``bound_ms``). With ``shape``, a
    random batch at one (B, L, D) a phase-6 fit launches #5 at
    (``phase6_emb_dot_keys``), checked and not timed (timed too with
    ``timed``: phase 18's per-rank shapes)."""
    import torch

    from deeplearning4j_tpu_torch.models import word2vec as w2v
    from deeplearning4j_tpu_torch.ops import emb_dot

    gen = torch.Generator(device="cuda").manual_seed(
        7000 + ("L16", "planted", "phase6").index(kind) if shape is None
        else 7100 + sum(shape))
    S, v, inputs, codes, points, mask, t = _emb_dot_hs_batch(
        kind, model, corpus, gen, shape)
    b, L = points.shape
    d = S.shape[1]
    CHECKED_SHAPES.add(_emb_key("fused", b, L, d))
    lr = W2V_LR
    rows = torch.cat([inputs, (v + points).reshape(-1)])
    keep = torch.cat([torch.ones_like(inputs, dtype=torch.bool),
                      mask.reshape(-1) > 0])
    plan = w2v._scatter_plan(rows, keep, S.shape[0], inverse=True)
    dest = plan.dest
    at = dest[keep]
    args = (S, v, inputs, codes, points, mask, lr)
    nan = torch.full((len(rows), d), float("nan"), device="cuda")
    out = emb_dot.fused_hs_rows(*args, dest=dest, out=nan)
    again = emb_dot.fused_hs_rows(*args, dest=dest)
    ref = emb_dot.fused_hs_rows_plain(*args, dest=dest)
    torch.cuda.synchronize()
    err = (out[at] - ref[at]).abs().max().item()
    unwritten = bool(torch.isnan(out[dest[~keep]]).all())
    bitwise = torch.equal(out[at], again[at])
    zero = (out[at][b:] == 0).all(-1)
    flags_equal = torch.equal(zero, (ref[at][b:] == 0).all(-1))
    if t is not None:
        want = (t.abs() > 6).reshape(-1)[mask.reshape(-1) > 0]
        flags_equal = flags_equal and torch.equal(zero, want)
    ok = (bool(torch.isfinite(out[at]).all()) and err <= EMB_TOL
          and unwritten and bitwise and flags_equal)
    if shape is not None and not timed:
        log(f"kernel emb_dot fused HS rows, phase 6 shape B={b} L={L} "
            f"D={d}: max_abs_err {err:.3e} at dest (tol {EMB_TOL}), masked "
            f"entries unwritten {unwritten}, range flags equal "
            f"{flags_equal}, bitwise repeat {bitwise} -> "
            f"{'ok' if ok else 'FAIL'}")
        return dict(ok=ok)
    run = lambda: emb_dot.fused_hs_rows(*args, dest=dest)  # noqa: E731
    ms, dev_ms = time_ms(run, iters), graph_ms(run)
    plain_ms = time_ms(
        lambda: emb_dot.fused_hs_rows_plain(*args, dest=dest), iters)
    n_valid = int((mask > 0).sum())
    kept = b + n_valid
    distinct = int(torch.unique(rows[keep]).numel())
    # inputs and dest of the inputs; mask of every entry; points, codes and
    # dest of the valid ones; the kept delta rows written
    idx_bytes = 16 * b + 4 * b * L + 20 * n_valid
    out_bytes = 4 * d * kept
    flops = 5 * n_valid * d  # dot, grad_in (FMA each), g * h
    b_ms, b_by = bound(4 * d * distinct + idx_bytes + out_bytes, flops,
                       F32_FLOPS)
    use_ms, use_by = bound(4 * d * kept + idx_bytes + out_bytes, flops,
                           F32_FLOPS)
    saturated = int(zero.sum())
    label = "a phase 18 rank's shape" if shape is not None else kind
    log(f"kernel emb_dot fused HS rows ({label}) B={b} L={L} D={d}: "
        f"{n_valid} valid path entries of {b * L}, {distinct} distinct rows; "
        f"max_abs_err {err:.3e} at dest (tol {EMB_TOL}), masked entries "
        f"unwritten {unwritten}, range flags equal {flags_equal} ({saturated} "
        f"saturated), bitwise repeat {bitwise}, ms {ms:.4f} (graph_ms "
        f"{dev_ms:.4f}), plain_ms {plain_ms:.4f}, bound_ms {b_ms:.6f} "
        f"({b_by}; per use {use_ms:.6f}, {use_by}), library_ms none -> "
        f"{'ok' if ok else 'FAIL'}")
    return dict(ok=ok, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                graph_ms=dev_ms, mode="fused")


#: decode positions on either side of the kernels' split edges (rows per
#: split a multiple of 8 of (pos + 1) / 16: 8 -> 16 past pos 127, one
#: 32-row stage -> two past pos 511), and the first and last row
#: operations of the threefry draw a logit: 72 for the threefry rounds and
#: key injections, 2 for the counter, 6 for bits -> uniform (xor, shift,
#: or, subtract, add, max), 4 for -log(-log(u)), the add of the logit and
#: the compare of the argmax
DRAW_OPS = 86
#: phase 2's engine-mode draw: one position a slot (0 to 639), a
#: grammar-masked row (all -inf but 3 tokens) and a planted exact tie (two
#: tokens at 1e30, where the Gumbel noise vanishes: the lower id wins)
DRAW_POS = [0, 1, 127, 128, 300, 511, 600, 639]
DRAW_MASKED_ROW, DRAW_ALLOWED = 1, (5, 700, 50000)
DRAW_TIE_ROW, DRAW_TIE = 2, (100, 4000)


def _draw_case(r: int, v: int, flat: bool, spec: bool = False,
               iters: int = 50, positions: list[int] = DRAW_POS) -> dict:
    """The threefry draw kernel against ``categorical_plain`` on the same
    card tensors: tokens and winning values bitwise. Engine mode (``flat``
    False): R slot keys split from key(s) for s < R, folded with
    ``DRAW_POS``, with the masked row and the planted tie; flat mode: one
    key over (R, V); ``spec``: the logits speculative decoding draws from,
    log(p + 1e-30) of a top-40 temperature-1 softmax."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.ops import threefry

    gen = torch.Generator(device="cuda").manual_seed(7000 + r + flat + spec)
    logits = torch.randn((r, v), generator=gen, device="cuda") * 3.0
    if spec:
        p = torch.softmax(logits, dim=-1)
        kth = torch.topk(p, 40).values[:, -1:]
        p = torch.where(p < kth, 0.0, p)
        logits = torch.log(p / p.sum(-1, keepdim=True) + 1e-30)
    dev = torch.device("cuda")
    if flat:
        keys, pos = threefry.device_keys(threefry.key(11), dev), None
    else:
        keys = threefry.device_keys(
            [threefry.split(s)[1] for s in range(r)], dev)
        pos = torch.tensor(positions[:r], dtype=torch.int32, device=dev)
        allowed = torch.tensor(DRAW_ALLOWED, device=dev)
        row = torch.full((v,), float("-inf"), device=dev)
        row[allowed] = logits[DRAW_MASKED_ROW, allowed]
        logits[DRAW_MASKED_ROW] = row
        logits[DRAW_TIE_ROW, list(DRAW_TIE)] = 1e30
    logits = logits.contiguous()
    CHECKED_SHAPES.add(_draw_key(logits, pos))
    tok, val = threefry.draw(logits, keys, pos)
    tok_ref, val_ref = threefry.categorical_plain(logits, keys, pos)
    torch.cuda.synchronize()
    same_tok = torch.equal(tok, tok_ref)
    same_val = torch.equal(val.view(torch.int32), val_ref.view(torch.int32))
    err = (val - val_ref).abs().max().item()
    ok = same_tok and same_val
    if not flat:
        ok = (ok and int(tok[DRAW_TIE_ROW]) == DRAW_TIE[0]
              and int(tok[DRAW_MASKED_ROW]) in DRAW_ALLOWED)
    run = lambda: threefry.draw(logits, keys, pos)  # noqa: E731
    ms, dev_ms = time_ms(run, iters), graph_ms(run)
    plain_ms = time_ms(
        lambda: threefry.categorical_plain(logits, keys, pos), iters)
    # reads the logits, the keys (and positions), writes a token and a
    # value a row; DRAW_OPS a logit, against the f32 rate outside the
    # tensor cores (the guide's table has no int32 row)
    nbytes = 4 * r * v + 16 * (r if pos is not None else 1) + 4 * r * (
        pos is not None) + 8 * r
    b_ms, b_by = bound(nbytes, DRAW_OPS * r * v, F32_FLOPS)
    what = ("flat, one key" + (" (spec: log(p + 1e-30))" if spec else "")
            if flat else f"rows, pos {positions[:r]}, masked row "
            f"{DRAW_MASKED_ROW}, tie at {DRAW_TIE}")
    log(f"kernel threefry_draw R={r} V={v} {what}: tokens equal {same_tok}, "
        f"values bitwise {same_val} (max_abs_err {err:.3e}), ms {ms:.4f} "
        f"(graph_ms {dev_ms:.4f}), plain_ms {plain_ms:.4f}, bound_ms "
        f"{b_ms:.6f} ({b_by}), library_ms none -> {'ok' if ok else 'FAIL'}")
    return dict(ok=ok, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                graph_ms=dev_ms)


def phase_draw() -> list[dict]:
    """Phase 2's draw cases; the last is the engine's (R 8, V 50,304)."""
    vocab = 50304
    # the byte-level CLI runs' samples (phase 14c: V 256) first
    return [_draw_case(1, 256, flat=True),
            _draw_case(1, vocab, flat=True),
            _draw_case(4, vocab, flat=True),
            # phase 15a's sampled generate over 8 prompts
            _draw_case(P15_PROMPTS, vocab, flat=True),
            _draw_case(1, vocab, flat=True, spec=True),
            # phase 17e's char-LSTM samples over its text's characters
            _draw_case(1, p17_vocab(), flat=True),
            # phase 22b's sampled engines: 16 slots
            _draw_case(P22_SLOTS, vocab, flat=False,
                       positions=DRAW_POS + P22_POS[::2]),
            _draw_case(8, vocab, flat=False)]


SPLIT_EDGE_POS = [0, 7, 8, 127, 128, 511, 512, 639]


def phase_kernels(w2v_model, w2v_corpus) -> dict[str, dict]:
    """Kernel vs plain version at the slices' shapes. Returns, per kernel,
    the numbers of its main-path case (the last one listed: the training
    shape for the flash kernels, GPT-2-small serving for the decode
    kernels, int8 at block size 8 for the paged one, the fused mode on
    phase 6's first batch for the fused embedding dot)."""
    import numpy as np

    attn = [_attn_case(t, True) for t in (8, 64)]
    attn.append(_attn_case(128, False))
    attn.append(_attn_case(128, True))
    # prefills (6 heads of 128): phase 4's 20-token prompt (bucket 32),
    # phase 3's generate on 40 tokens; phase 7's: the CLI's 16-byte prompt,
    # the speculative prefill's 128-aligned prefix (384 of 511 rows), the
    # spec cell's plain generate (512); phase 5's 2-layer parity at B 2
    # and phase 7's train at batch CKPT_BATCH
    attn += [_attn_case(t, True)
             for t in (32, 40, GEN_PROMPT, 384, SPEC_PROMPT)]
    # batched admission (phase 11, and every engine whose batch probe
    # passes): #1 over groups of nb = 2, 4, 8 prompts of 6 heads at every
    # prefill bucket; then each 6-row block of an nb-8 launch bitwise
    # against a launch of those rows alone (so #1 cannot decide the batch
    # probe)
    attn += [_attn_case(t, True, bh=6 * nb, iters=20)
             for nb in BATCH_ROWS for t in PREFILL_BUCKETS]
    attn += [_attn_rows_case(t, 8) for t in PREFILL_BUCKETS]
    # phase 14's mesh ranks: 14c's (dp 1, tp 3: 8 rows x 2 heads, T 64)
    # and 14b's (dp 2, tp 3: 4 rows x 2 heads, T 1024), and each rank's
    # rows of a whole-batch launch bitwise that rank's launch, #1 and #2
    rank_bh = MESH_BATCH // MESH_DP * (6 // MESH_TP)
    attn.append(_attn_case(CLI_MESH_SEQ, True,
                           bh=CLI_MESH_BATCH * (6 // MESH_TP)))
    attn.append(_attn_case(TRAIN_SEQ, True, bh=rank_bh, iters=20))
    attn.append(_rank_rows_case(TRAIN_SEQ, MESH_BATCH, 6, MESH_DP, MESH_TP))
    # phase 15's ranks: 15a's mesh prefill (4 prompts x 2 heads at T 128)
    # and 15b's training (4 rows x 2 heads at T 256, both ways)
    attn.append(_attn_case(P15_PROMPT, True, bh=P15_RANK_BH))
    # train's closing sample from a (1, 3) layout (14c, 15b's trainers):
    # the CLI's 16-byte prompt over a rank's 2 heads
    attn.append(_attn_case(GEN_PROMPT, True, bh=6 // MESH_TP))
    attn.append(_attn_case(P15_SEQ, True, bh=P15_RANK_BH, iters=20))
    # phase 20's ranks at T 256: 20b's and 20d's model axis of 2 across
    # the processes (8 rows x 3 heads), 20c's ZeRO-3 (4 rows x 3 heads)
    attn += [_attn_case(P15_SEQ, True, bh=bh, iters=20)
             for bh in P20_RANK_BH]
    attn.append(_attn_case(TRAIN_SEQ, True, bh=2 * 6, iters=20))
    attn.append(_attn_case(TRAIN_SEQ, True, bh=CKPT_BATCH * 6, iters=20))
    # phase 21, against the row-blocked plain version: 21a's training rows
    # (B 2 x 4 heads at T 8,192, B 1 x 4 at 32,768) and their 2-layer
    # parity cut (B 1 at 8,192); 21b's prefill over the expanded KV heads
    # (B 16 x 6 heads) and its B 1 check; 21c's generate on the 4 long
    # prompts (B 4 x 6), then on the 20 short ones at T 512 (unblocked)
    attn += [_attn_case(t, True, bh=bh, iters=3) for t, bh in (
        (8192, 8), (32768, 4), (8192, 4), (P21_PROMPT, P21_BATCH * 6),
        (P21_PROMPT, 6), (P21_PROMPT, P21_LONG * 6))]
    attn.append(_attn_case(P21_SHORT, True,
                           bh=(P21_REQS - P21_LONG) * 6, iters=20))
    # 21c's batched admission of 2 and 4 of its 512-token prompts (4 slots)
    attn += [_attn_case(P21_SHORT, True, bh=6 * nb, iters=20)
             for nb in (2, 4)]
    # phase 22's admissions of its 512-token prompts in groups of 8 and of
    # 16 (its 16 slots; one alone is the spec cell's case above, groups of
    # 2 and 4 21c's)
    attn += [_attn_case(P22_PROMPT, True, bh=6 * nb, iters=20)
             for nb in (8, P22_SLOTS)]
    # the reference's own flash gate (bench.py:339), f32 at T 2,048 and
    # 4,096
    gate_rng = np.random.default_rng(0)
    attn += [_flash_gate_case(t, h, d, gate_rng) for t, h, d in P21_GATE]
    attn.append(_attn_case(TRAIN_SEQ, True, bh=TRAIN_BATCH * 6, iters=20))
    bwd = [_bwd_case(128, causal) for causal in (True, False)]
    bwd.append(_bwd_case(CLI_MESH_SEQ, True,
                         bh=CLI_MESH_BATCH * (6 // MESH_TP)))
    bwd.append(_bwd_case(TRAIN_SEQ, True, bh=rank_bh, iters=20))
    bwd.append(_bwd_case(P15_SEQ, True, bh=P15_RANK_BH, iters=20))
    bwd += [_bwd_case(P15_SEQ, True, bh=bh, iters=20) for bh in P20_RANK_BH]
    bwd.append(_bwd_case(TRAIN_SEQ, True, bh=2 * 6, iters=20))
    bwd.append(_bwd_case(TRAIN_SEQ, True, bh=CKPT_BATCH * 6, iters=20))
    bwd += [_bwd_case(t, True, bh=bh, iters=3)
            for t, bh in ((8192, 8), (32768, 4), (8192, 4))]
    bwd.append(_bwd_case(TRAIN_SEQ, True, bh=TRAIN_BATCH * 6, iters=20))
    rng = random.Random(0)
    pos = [0, 639] + [rng.randrange(1, 639) for _ in range(6)]
    # phase 21's B 16 decode positions, and the Tpad of 21c's short
    # prompts' generate (512 + 64 rows)
    p21_pos = P21_POS * 3 + [P21_POS[-1]]
    p21_short_t = P21_SHORT + P21_SERVE_NEW
    # phase 7's decode shapes on GPT-2-small (Hkv 6, K 128, 12 layers):
    # Tpad 64 (the CLI's 16-byte prompt and 48 new: train's closing sample
    # and greedy generate at B 1, generate --beam 4 at B 4) and Tpad 160
    # (beam search, prompt 128 + 32 new: W 1 and greedy at B 1, W 4 at
    # B 4; its 1-token timing runs at 136), beam rows all at one position;
    # the spec cell (6 query heads over 2 KV heads of 128): plain generate
    # at Tpad 576 (512 + 64) and the draft steps at 584 (512 + 64 + k + 1,
    # rounded to 8)
    gen_t, beam_t = GEN_PROMPT + GEN_NEW, BEAM_PROMPT + BEAM_NEW
    beam1_t, spec_t = BEAM_PROMPT + 8, SPEC_PROMPT + SPEC_NEW
    # phases 3-3b: the engine's paged-parity probe (B 2, Tpad 32, rows 8
    # to 10) and generate on prompts 1 and 5 (Tpad 72 and 232)
    serve_ts = [PROMPT_LENGTHS[i] + MAX_NEW for i in (1, 5)]
    dec = [
        _decode_case(4, 3, 2, 128, 2, 256, 1, [0, 17, 100, 255]),
        _decode_case(2, 1, 6, 128, 12, 32, 7, [8, 10]),
        # the LoRA probe's decode steps (phase 10): B 1, Tpad 32
        _decode_case(1, 1, 6, 128, 12, 32, 7, [8]),
        *[_decode_case(1, 1, 6, 128, 12, t, 7, [t - 1]) for t in serve_ts],
        _decode_case(1, 1, 6, 128, 12, gen_t, 7, [gen_t - 1]),
        # phase 14c's generate on its 2-layer checkpoint
        _decode_case(1, 1, 6, 128, CLI_MESH_LAYERS, gen_t, 1, [gen_t - 1]),
        _decode_case(4, 1, 6, 128, 12, gen_t, 7, [GEN_PROMPT] * 4),
        _decode_case(1, 1, 6, 128, 12, beam_t, 7, [beam_t - 1]),
        _decode_case(4, 1, 6, 128, 12, beam_t, 7, [beam_t - 1] * 4),
        _decode_case(4, 1, 6, 128, 12, beam1_t, 7, [BEAM_PROMPT] * 4),
        _decode_case(1, 3, 2, 128, 12, spec_t, 7, [spec_t - 1]),
        _decode_case(1, 3, 2, 128, 12, spec_t + 8, 7, [spec_t - 1]),
        # phase 15a: a mesh rank's decode (4 rows, its 2 KV heads) and the
        # single-device generate it is held against (8 rows), Tpad 160
        _decode_case(P15_PROMPTS // MESH_DP, 1, 6 // MESH_TP, 128, 12,
                     P15_TOTAL, 7, [P15_TOTAL - 1] * (P15_PROMPTS // MESH_DP)),
        _decode_case(P15_PROMPTS, 1, 6, 128, 12, P15_TOTAL, 7,
                     [P15_TOTAL - 1] * P15_PROMPTS),
        # train's closing sample from a (1, 3) layout: a rank's 2 KV heads
        # at B 1, Tpad 64, 2 layers (14c) and 12 (15b's trainers)
        _decode_case(1, 1, 6 // MESH_TP, 128, CLI_MESH_LAYERS, gen_t, 1,
                     [gen_t - 1]),
        _decode_case(1, 1, 6 // MESH_TP, 128, 12, gen_t, 7, [gen_t - 1]),
        _decode_case(8, 1, 6, 128, 12, 640, 7, SPLIT_EDGE_POS),
        # phase 21 (G 3 over Hkv*K 256, Tpad 8,704): 21b's B 16 and its B 1
        # check, 21c's 4 slots; 21c's generate on the short prompts (B 20,
        # Tpad 584)
        _decode_case(P21_BATCH, 3, 2, 128, 12, P21_TPAD, 7, p21_pos),
        _decode_case(1, 3, 2, 128, 12, P21_TPAD, 7, [P21_POS[-1]]),
        _decode_case(P21_SLOTS, 3, 2, 128, 12, P21_TPAD, 7, P21_POS[1:]),
        _decode_case(P21_REQS - P21_LONG, 3, 2, 128, 12, p21_short_t, 7,
                     [P21_SHORT, p21_short_t - 1] * 10),
        # the paged-parity probe of 21c's engines (B 2, Tpad 32) at G 3
        _decode_case(2, 3, 2, 128, 12, 32, 7, [8, 10]),
        # phase 22 (G 3 over Hkv*K 256): the engine's 16 slots over Tpad
        # 584, and generate on 16 of its prompts (Tpad 576)
        _decode_case(P22_SLOTS, 3, 2, 128, 12, P22_TPAD, 7, P22_POS),
        _decode_case(P22_SLOTS, 3, 2, 128, 12, P22_PROMPT + P22_NEW, 7,
                     P22_POS),
        _batch_case(False, pos),
        _decode_case(8, 1, 6, 128, 12, 640, 7, pos),
    ]
    dec8 = [
        _decode_int8_case(4, 3, 2, 128, 2, 256, 1, [0, 17, 100, 255]),
        _decode_int8_case(2, 1, 6, 128, 12, 32, 7, [8, 10]),
        *[_decode_int8_case(1, 1, 6, 128, 12, t, 7, [t - 1])
          for t in serve_ts],
        # phase 7's int8 decode shapes: generate --int8 full (B 1, Tpad 64)
        # and the int8 beam (B 1 and 4, Tpad 160; B 4 at 136 timing one
        # token), each at the reference's tile for its cache
        _decode_int8_case(1, 1, 6, 128, 12, gen_t, 7, [gen_t - 1]),
        _decode_int8_case(1, 1, 6, 128, 12, beam_t, 7, [beam_t - 1]),
        _decode_int8_case(4, 1, 6, 128, 12, beam_t, 7, [BEAM_PROMPT] * 4),
        _decode_int8_case(4, 1, 6, 128, 12, beam1_t, 7, [BEAM_PROMPT] * 4),
        _decode_int8_case(8, 1, 6, 128, 12, 640, 7, SPLIT_EDGE_POS),
        # phase 20a: a (2, 3) mesh rank's int8 decode (4 rows, its 2 KV
        # heads: Hkv*K 256) and the single-device int8-cache generate it
        # is held against (8 rows, Hkv*K 768), Tpad 160, the default tile
        _decode_int8_case(P15_PROMPTS // MESH_DP, 1, 6 // MESH_TP, 128, 12,
                          P15_TOTAL, 7,
                          [P15_TOTAL - 1] * (P15_PROMPTS // MESH_DP)),
        _decode_int8_case(P15_PROMPTS, 1, 6, 128, 12, P15_TOTAL, 7,
                          [P15_TOTAL - 1] * P15_PROMPTS),
        _decode_int8_case(8, 1, 6, 128, 12, 640, 7, pos, block_t=64),
        # one 1,592-row tile (the rule's cap at Hkv*K 768) over 48 lanes:
        # 200 rows a block, whose scores go to the wrapper's scratch tensor
        _decode_int8_case(2, 4, 12, 64, 2, 1592, 1, [1591, 700]),
        # phase 21b's int8 full generate at its default tile (4,352 rows:
        # two tiles over Tpad 8,704)
        _decode_int8_case(P21_BATCH, 3, 2, 128, 12, P21_TPAD, 7, p21_pos,
                          bitwise=True),
        _batch_case(True, pos),
        _decode_int8_case(8, 1, 6, 128, 12, 640, 7, pos),
    ]
    # the row's scales from outside: 21b's two-tile shape over 2 ranks of
    # one KV head, then phase 20a's (2, 3) rank (4 rows, 2 of the 6 KV
    # heads, Tpad 160), the maxima pass's row in the kernels line
    outside = [
        _decode_int8_outside_case(P21_BATCH, 3, 2, 2, 128, 12, P21_TPAD, 7,
                                  p21_pos),
        _decode_int8_outside_case(P15_PROMPTS // MESH_DP, 1, 6, MESH_TP, 128,
                                  12, P15_TOTAL, 7,
                                  [P15_TOTAL - 1] * (P15_PROMPTS // MESH_DP)),
    ]
    maxima = [c["maxima"] for c in outside]
    # the probe's paged leg (B 2, Tpad 32; phase 21c's at G 3 over Hkv*K
    # 256), then the serve shape
    paged = [_paged_case(int8, 8, [8, 10], b=2, tpad=32)
             for int8 in (False, True)]
    paged.append(_paged_case(False, 8, [8, 10], b=2, hkv=2, tpad=32, g=3))
    # phase 21c's 4 slots over bs-8 tables of 1,088 entries (G 3, Hkv*K
    # 256, Tpad 8,704), both modes
    paged += [_paged_case(int8, BLOCK_SIZE, P21_POS[1:], b=P21_SLOTS, hkv=2,
                          tpad=P21_TPAD, g=3) for int8 in (False, True)]
    # phase 22's paged engine: 16 slots over bs-8 tables of 73 entries
    paged.append(_paged_case(False, BLOCK_SIZE, P22_POS, b=P22_SLOTS, hkv=2,
                             tpad=P22_TPAD, g=3))
    paged += [_paged_case(int8, bs, pos) for bs in (64, 8)
              for int8 in (False, True)]
    code_len = w2v_model.cache.max_code_length
    emb = [_emb_dot_case(W2V_BATCH, 16, W2V_DIM),
           _emb_dot_case(W2V_BATCH, code_len, W2V_DIM, planted=True),
           _emb_dot_case(W2V_BATCH, code_len, W2V_DIM)]
    # every shape phase 6's fits launch the fused mode at, first
    emb += [_emb_dot_hs_case("L16", w2v_model, w2v_corpus, shape=key)
            for key in phase6_emb_dot_keys(w2v_model, w2v_corpus)]
    # phase 18a's data ranks: the fused mode at B 4,096 / n over the full
    # vocabulary's longest path, checked and timed
    emb += [_emb_dot_hs_case("L16", w2v_model, w2v_corpus, shape=key,
                             timed=True)
            for key in p18_emb_dot_keys(w2v_model)]
    emb += [_emb_dot_hs_case(kind, w2v_model, w2v_corpus)
            for kind in ("L16", "planted", "phase6")]
    draws = phase_draw()
    for name, cases in (("flash_attn_fwd", attn), ("flash_attn_bwd", bwd),
                        ("flash_decode", dec),
                        ("flash_decode_int8",
                         dec8 + [c["outside"] for c in outside]),
                        ("flash_decode_int8_maxima", maxima),
                        ("flash_decode_paged", paged), ("emb_dot", emb),
                        ("threefry_draw", draws)):
        if not all(c["ok"] for c in cases):
            raise SystemExit(f"kernel {name} disagrees with its plain "
                             f"version")
    return {"flash_attn_fwd": attn[-1], "flash_attn_bwd": bwd[-1],
            "flash_decode": dec[-1], "flash_decode_int8": dec8[-1],
            "flash_decode_int8_maxima": maxima[-1],
            "flash_decode_paged": paged[-1], "emb_dot": emb[-1],
            "threefry_draw": draws[-1]}


# -- phase 3 -----------------------------------------------------------------

#: the kernels of the serving and training paths, for the result line
KERNELS = {
    "flash_attn_fwd": dict(
        source="deeplearning4j_tpu_torch/csrc/flash_attn_fwd.cu",
        replaces="deeplearning4j_tpu/ops/pallas_kernels.py:125"),
    "flash_attn_bwd": dict(
        source="deeplearning4j_tpu_torch/csrc/flash_attn_bwd.cu",
        replaces="deeplearning4j_tpu/ops/pallas_kernels.py:213"),
    "flash_decode": dict(
        source="deeplearning4j_tpu_torch/csrc/flash_decode.cu",
        replaces="deeplearning4j_tpu/ops/pallas_kernels.py:502"),
    "flash_decode_int8": dict(
        source="deeplearning4j_tpu_torch/csrc/flash_decode.cu",
        replaces="deeplearning4j_tpu/ops/pallas_kernels.py:502"),
    # int8 mode's maxima pass: the reference's per-tile max of p * vsc
    # (pallas_kernels.py:610-611) on its own, for the scales from outside
    "flash_decode_int8_maxima": dict(
        source="deeplearning4j_tpu_torch/csrc/flash_decode.cu",
        replaces="deeplearning4j_tpu/ops/pallas_kernels.py:502"),
    "flash_decode_paged": dict(
        source="deeplearning4j_tpu_torch/csrc/flash_decode.cu",
        replaces="deeplearning4j_tpu/ops/pallas_kernels.py:783"),
    "emb_dot": dict(
        source="deeplearning4j_tpu_torch/csrc/emb_dot.cu",
        replaces="deeplearning4j_tpu/ops/pallas_kernels.py:906"),
    # a kernel the port adds: the reference draws in XLA, not in Pallas
    "threefry_draw": dict(
        source="deeplearning4j_tpu_torch/csrc/sample.cu",
        replaces="XLA's jax.random.categorical "
                 "(deeplearning4j_tpu/serving/engine.py:293)"),
}


def reset_launches() -> None:
    from deeplearning4j_tpu_torch.ops import emb_dot
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import flash_decode as fd
    from deeplearning4j_tpu_torch.ops import threefry

    fa.reset_launches()
    fd.reset_launches()
    emb_dot.reset_launches()
    threefry.reset_launches()


def read_launches() -> dict[str, int]:
    """Every kernel's launch count since its last reset."""
    from deeplearning4j_tpu_torch.ops import emb_dot
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import flash_decode as fd
    from deeplearning4j_tpu_torch.ops import threefry

    return {"flash_attn_fwd": fa.launches, "flash_attn_bwd": fa.bwd_launches,
            "flash_decode": fd.launches,
            "flash_decode_int8": fd.int8_launches,
            "flash_decode_int8_maxima": fd.maxima_launches,
            "flash_decode_paged": fd.paged_launches,
            "emb_dot": emb_dot.launches, "threefry_draw": threefry.launches}


#: prompt lengths of the served requests: bucketed prefill (<= 128, the
#: flash kernel) and chunked prefill past the 128-token bucket
PROMPT_LENGTHS = (16, 40, 77, 128, 130, 200, 257, 300)
MAX_NEW = 32
#: rows per KV block of the paged runs (the reference's default)
BLOCK_SIZE = 8


def gpt2s_config(**kw):
    import torch

    from deeplearning4j_tpu_torch.cli import PRESETS
    from deeplearning4j_tpu_torch.models.transformer import TransformerConfig

    p = dict(PRESETS["gpt2s"])
    p.pop("bf16")
    return TransformerConfig(**p, use_flash=True,
                             compute_dtype=torch.bfloat16, **kw)


def serve_model(int8: bool):
    """GPT-2-small with random weights from seed 0: bf16, or int8 weights
    and the int8 KV cache (the reference's ``--int8 full``)."""
    from deeplearning4j_tpu_torch.models.transformer import (
        init_params,
        quantize_decode_params,
    )

    cfg = gpt2s_config(decode_int8=int8)
    params = init_params(cfg, seed=0)
    return cfg, quantize_decode_params(params, cfg) if int8 else params


def _generate(gen, params, prompt):
    """The port's generate on one prompt alone: tokens and logits."""
    import torch

    toks, logits = gen(params, torch.from_numpy(prompt[None]).long().cuda(),
                       MAX_NEW, temperature=0.0, return_logits=True)
    return toks[0].cpu().numpy(), logits[:, 0]


def _parity(prompt, ref, logits, stream) -> str:
    """Hold one engine stream against generate's; a mismatch passes only
    at a near-tie of generate's logits."""
    import torch

    diff = (ref != stream).nonzero()[0]
    if not diff.size:
        return "identical"
    i = int(diff[0]) - len(prompt)
    top2 = torch.topk(logits[i], 2).values.tolist()
    gap = top2[0] - top2[1]
    msg = (f"first mismatch at generated position {i} (prompt "
           f"{len(prompt)}): top-2 logit gap {gap:.4g}")
    if gap >= NEAR_TIE:
        raise SystemExit(f"engine stream disagrees with generate: {msg}")
    return "near-tie: " + msg


def _serve_run(tag: str, cfg, params, *, must_launch, must_not_launch=(),
               refs=None, paged: bool = False):
    """Drive ``ServingEngine`` once through the 8 requests (every launch
    count set to 0 just before, read just after), check every stream, and
    print the run's numbers. Returns (engine, launches, streams)."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.serving import Request, ServingEngine

    t0 = time.perf_counter()
    engine = ServingEngine(cfg, params, n_slots=8, max_total=640,
                           decode_horizon=4, temperature=0.0, paged=paged,
                           block_size=BLOCK_SIZE)
    if paged and not engine._paged:
        raise SystemExit(f"{tag}: the engine did not come up paged")
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n),
                    max_new=MAX_NEW) for n in PROMPT_LENGTHS]
    torch.cuda.synchronize()
    layout = (f"paged, {engine.pool.n_blocks} blocks x {BLOCK_SIZE} rows"
              if paged else "slab")
    log(f"{tag}: GPT-2-small ({cfg.d_model}d x {cfg.n_layers}L, "
        f"{cfg.n_heads}x{cfg.head_dim} heads, vocab {cfg.vocab_size}, bf16"
        f"{', int8 weights + int8 KV cache' if cfg.decode_int8 else ''}) "
        f"8 slots, max_total 640 (Tpad {engine.pool.tpad}, {layout}), K=4; "
        f"set-up {time.perf_counter() - t0:.1f} s")

    reset_launches()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    log(f"{tag}: launches on the main path {launches}")
    for name in must_launch:
        if launches[name] <= 0:
            raise SystemExit(f"{tag}: kernel {name} never launched on the "
                             f"main path")
    for name in must_not_launch:
        if launches[name]:
            raise SystemExit(f"{tag}: kernel {name} launched "
                             f"{launches[name]} times; this path must not "
                             f"run it")
    for r in reqs:
        out = results[r.id]
        if (r.status.value != "finished"
                or out.shape != (len(r.prompt) + MAX_NEW,)
                or not ((out >= 0) & (out < cfg.vocab_size)).all()):
            raise SystemExit(f"request {r.id} ({len(r.prompt)} prompt "
                             f"tokens) came back wrong: {r.status}, "
                             f"{out.shape}")
    for i, (ref, logits) in (refs or {}).items():
        r = reqs[i]
        verdict = _parity(r.prompt, ref, logits, results[r.id])
        log(f"{tag}: parity vs transformer_generate, prompt "
            f"{len(r.prompt)}: {verdict}")
    # decode phase: from the first request's first token to the last
    # request's last token
    first = min(r.arrival_time + r.timing["ttft_s"] for r in reqs)
    last = max(r.arrival_time + r.timing["ttft_s"] + r.timing["decode_s"]
               for r in reqs)
    decode_tok_s = len(reqs) * (MAX_NEW - 1) / (last - first)
    s = engine.metrics.summary()
    log(f"{tag}: {s['n_generated']} tokens for {len(reqs)} requests in "
        f"{wall:.3f} s -> {s['n_generated'] / wall:.1f} generated tok/s, "
        f"decode phase {decode_tok_s:.1f} tok/s; "
        f"TTFT p50 {s['ttft_p50_s'] * 1e3:.2f} ms p99 "
        f"{s['ttft_p99_s'] * 1e3:.2f} ms; TPOT p50 "
        f"{s['tpot_p50_s'] * 1e3:.3f} ms p99 {s['tpot_p99_s'] * 1e3:.3f} ms; "
        f"prefill {s['phase_seconds']['prefill'] * 1e3:.1f} ms total; "
        f"occupancy {s['occupancy_mean']:.2f} slots; "
        f"{s['steps']} horizons")
    return engine, launches, [results[r.id] for r in reqs]


def phase_serve(int8: bool = False):
    """Phases 3 and 3b: GPT-2-small through the slab ``ServingEngine``,
    greedy, two streams held against ``transformer_generate`` on the same
    model (generated first: that also warms the card before the engine is
    timed). Returns the engine (phase 4 reuses the bf16 one), the launch
    counts and the streams."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models.transformer import (
        transformer_generate,
    )

    cfg, params = serve_model(int8)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in PROMPT_LENGTHS]
    gen = transformer_generate(cfg)
    refs = {i: _generate(gen, params, prompts[i]) for i in (1, 5)}
    torch.cuda.synchronize()
    decode = "flash_decode_int8" if int8 else "flash_decode"
    return _serve_run("serve int8" if int8 else "serve", cfg, params,
                      must_launch=("flash_attn_fwd", decode), refs=refs)


def phase_serve_paged(int8: bool, slab_streams) -> dict[str, int]:
    """Phase 3c: the run of phase 3 (or 3b) on a block-paged cache. Every
    stream must be byte-identical to the slab run's, the paged kernel must
    launch and neither slab decode mode may, and every block must come
    back. Returns the launch counts."""
    import numpy as np

    cfg, params = serve_model(int8)
    tag = "serve paged int8" if int8 else "serve paged"
    engine, launches, streams = _serve_run(
        tag, cfg, params, paged=True,
        must_launch=("flash_attn_fwd", "flash_decode_paged"),
        must_not_launch=("flash_decode", "flash_decode_int8"))
    same = [np.array_equal(a, b) for a, b in zip(streams, slab_streams)]
    log(f"{tag}: streams byte-identical to the slab run: {sum(same)}/"
        f"{len(same)}; blocks in use after the run "
        f"{engine.pool.n_blocks_in_use}")
    if not all(same):
        raise SystemExit(f"{tag}: streams differ from the slab engine's "
                         f"(prompts {[n for n, ok in zip(PROMPT_LENGTHS, same) if not ok]})")
    if engine.pool.n_blocks_in_use:
        raise SystemExit(f"{tag}: {engine.pool.n_blocks_in_use} blocks "
                         f"still in use after every request finished")
    return launches


# -- phase 4 -----------------------------------------------------------------

def _post(url: str, body: dict) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        if resp.status != 200:
            raise SystemExit(f"POST {url}: HTTP {resp.status}")
        return json.loads(resp.read())


def phase_server(engine) -> None:
    import numpy as np

    from deeplearning4j_tpu_torch.serving import ServingServer

    server = ServingServer(engine, port=0).start()
    try:
        host, port = server.address
        base = f"http://{host}:{port}"
        rng = np.random.default_rng(1)
        for n in (20, 60, 150):
            prompt = rng.integers(0, engine.cfg.vocab_size, n).tolist()
            t0 = time.perf_counter()
            body = _post(base + "/v1/generate",
                         {"prompt": prompt, "max_new": 16})
            if body["tokens"][:n] != prompt or len(body["tokens"]) != n + 16:
                raise SystemExit(f"/v1/generate returned a bad stream for "
                                 f"a {n}-token prompt")
            log(f"server: /v1/generate prompt {n} -> 16 tokens in "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms "
                f"(engine ttft {body['timing']['ttft_s'] * 1e3:.2f} ms)")
        with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
            if resp.status != 200 or not health["ok"]:
                raise SystemExit(f"/healthz not ok: {health}")
        log(f"server: /healthz {health}")
    finally:
        server.stop(drain_s=10.0)


# -- phase 5 -----------------------------------------------------------------

#: the reference bench's "transformer" preset (bench.py:207): GPT-2-small
#: widths with 6 heads of 128, seq 1024, batch 24
TRAIN_SEQ, TRAIN_BATCH = 1024, 24
TRAIN_STEPS, TRAIN_WARMUP = 8, 2
#: flash vs dense attention on the 2-layer model (both bf16)
PARITY_LOSS_RTOL, PARITY_COSINE = 1e-2, 0.99


def lm_flops_per_token(d: int, n_layers: int, d_ff: int, vocab: int,
                       seq: int) -> float:
    """Training FLOPs per token of a dense decoder-only LM, as the reference
    bench counts them (bench.py:192): 6 x matmul params + causal attention
    6 T d per layer."""
    per_layer = 4 * d * d + 2 * d * d_ff
    return 6.0 * (n_layers * per_layer + d * vocab) + 6.0 * seq * d * n_layers


def bench_config(n_layers: int = 12, remat: bool = True):
    import torch

    from deeplearning4j_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(
        vocab_size=50304, d_model=768, n_heads=6, n_layers=n_layers,
        d_ff=3072, max_len=TRAIN_SEQ + 1, use_flash=True, remat=remat,
        remat_policy="dots_no_batch", compute_dtype=torch.bfloat16)


def phase_train(card: str) -> dict[str, int]:
    """The training path: 8 steps of the bench preset. Returns each
    kernel's launches in the 6 timed steps."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models.transformer import (
        lm_optimizer,
        transformer_train_step,
    )

    cfg = bench_config()
    t0 = time.perf_counter()
    step, init_state, shard_tokens = transformer_train_step(
        None, cfg, optimizer=lm_optimizer(total_steps=TRAIN_STEPS))
    params, opt_state = init_state(0)
    toks = shard_tokens(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1)))
    losses = []
    for _ in range(TRAIN_WARMUP):
        params, opt_state, loss = step(params, opt_state, toks)
        losses.append(loss)
    torch.cuda.synchronize()
    log(f"train: bench 'transformer' preset ({cfg.d_model}d x "
        f"{cfg.n_layers}L, {cfg.n_heads}x{cfg.head_dim} heads, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, seq {TRAIN_SEQ}, batch "
        f"{TRAIN_BATCH}, flash, remat {cfg.remat_policy}, bf16 compute, f32 "
        f"params), lm_optimizer(total_steps={TRAIN_STEPS}); set-up and "
        f"{TRAIN_WARMUP} warm-up steps {time.perf_counter() - t0:.1f} s")

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS - TRAIN_WARMUP):
        params, opt_state, loss = step(params, opt_state, toks)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(x) for x in losses]
    n = TRAIN_STEPS - TRAIN_WARMUP
    ms_step = wall / n * 1e3
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (wall / n)
    share = lm_flops_per_token(cfg.d_model, cfg.n_layers, cfg.d_ff,
                               cfg.vocab_size, TRAIN_SEQ) * tok_s / BF16_FLOPS
    log(f"train: launches in the {n} timed steps {launches}")
    log(f"train: losses {' '.join(f'{x:.4f}' for x in losses)}")
    log(f"train: {ms_step:.2f} ms/step, {tok_s:.1f} tokens/s, "
        f"{share:.4f} of {BF16_FLOPS / 1e12:.0f} TFLOP/s bf16, peak memory "
        f"{peak_gib:.2f} GiB ({card})")
    for name in ("flash_attn_fwd", "flash_attn_bwd"):
        if launches[name] <= 0:
            raise SystemExit(f"kernel {name} never launched in training")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f"training loss not finite or not falling: {losses}")
    del params, opt_state
    torch.cuda.empty_cache()
    return launches


def phase_train_parity() -> None:
    """Flash vs dense attention, and remat on vs off, on 2 layers."""
    import dataclasses

    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models.transformer import (
        _leaves,
        _tree,
        init_params,
        transformer_loss,
        value_and_grad,
    )

    cfg = bench_config(n_layers=2, remat=False)
    params = init_params(cfg, seed=0)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, TRAIN_SEQ + 1))).cuda()

    def run(c):
        fresh = _tree((path, p.detach().clone())
                      for path, p in _leaves(params))
        loss, grads = value_and_grad(transformer_loss(c), fresh, toks)
        return float(loss), dict(_leaves(grads))

    flash = run(cfg)
    dense = run(dataclasses.replace(cfg, use_flash=False))
    rel = abs(flash[0] - dense[0]) / abs(dense[0])
    cos = {}
    for path, g in flash[1].items():
        a, b = g.double().flatten(), dense[1][path].double().flatten()
        cos["/".join(path)] = (a @ b / (a.norm() * b.norm())).item()
    worst = min(cos, key=cos.get)
    log(f"train parity (2 layers, T {TRAIN_SEQ}, B 2): loss flash "
        f"{flash[0]:.6f} dense {dense[0]:.6f} (rel {rel:.2e}, tol "
        f"{PARITY_LOSS_RTOL}); min grad cosine {cos[worst]:.6f} at {worst} "
        f"(tol {PARITY_COSINE})")
    if rel > PARITY_LOSS_RTOL or cos[worst] < PARITY_COSINE:
        raise SystemExit("flash training disagrees with dense attention")
    for policy in ("dots_no_batch", "full"):
        remat = run(dataclasses.replace(cfg, remat=True, remat_policy=policy))
        differ = [p for p, g in flash[1].items()
                  if not torch.equal(g, remat[1][p])]
        log(f"train parity: remat {policy} vs off: loss "
            f"{'identical' if remat[0] == flash[0] else 'DIFFERS'}, "
            f"{len(flash[1]) - len(differ)}/{len(flash[1])} grad leaves "
            f"identical {differ or ''}")
        if remat[0] != flash[0] or differ:
            raise SystemExit(f"remat {policy} changed the loss or grads")


# -- phase 6 -----------------------------------------------------------------

#: the full-width corpus has text8's shape: word2vec.c cuts text8 into
#: 1,000-word sentences, and text8 has 71,290 word types at min-count 5;
#: 4,000 sentences (4 M of its 17 M tokens) keep the smoke's time
W2V_SENTENCES, W2V_SENT_LEN, W2V_TYPES = 4000, 1000, 71290
#: word2vec.c's size and window; Word2Vec's own batch and learning rate
W2V_DIM, W2V_WINDOW, W2V_BATCH, W2V_LR = 100, 5, 4096, 0.025
#: sentences of the HS+NS run (the per-batch path)
W2V_NS_SENTENCES = 500
#: ceiling on max |syn0| after a full-width fit. Batched HS on this corpus
#: is chaotic (a 1e-6 change of syn0 moves over a thousand rows by more
#: than 1e-3 within 30 sentences), so the value is not reproducible, but it
#: stays in the tens (the JAX package reaches 66.3 on the CPU from
#: numpy-seeded tables); clipping saturated dots instead of skipping them
#: reaches 1e14 within 30 sentences (scripts/torch_w2v_reference.py)
W2V_SYN0_CEILING = 1000.0


def zipf_corpus(n_sent: int, n_tok: int, n_types: int,
                seed: int = 0) -> list[str]:
    """``n_sent`` sentences of ``n_tok`` words ``w<rank>``, the ranks drawn
    from Zipf(1.0) over ``n_types`` types."""
    import numpy as np

    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n_types + 1)
    ranks = rng.choice(n_types, size=(n_sent, n_tok), p=p / p.sum())
    names = np.array([f"w{r}" for r in range(n_types)])
    return [" ".join(names[row]) for row in ranks]


def topic_corpus(n: int, seed: int = 0) -> list[str]:
    """The reference tests' two-topic corpus (tests/test_nlp.py:28):
    day/sun/light/... vs night/moon/dark/... with filler words."""
    import numpy as np

    rng = np.random.default_rng(seed)
    day = ["day", "sun", "light", "morning", "bright", "noon"]
    night = ["night", "moon", "dark", "evening", "stars", "midnight"]
    fillers = ["the", "a", "was", "very", "and", "it", "sky", "time"]
    sents = []
    for _ in range(n):
        topic = day if rng.random() < 0.5 else night
        words = list(rng.choice(topic, size=4)) + list(
            rng.choice(fillers, size=3))
        rng.shuffle(words)
        sents.append(" ".join(words))
    return sents


#: the card-vs-CPU fits of phase 6. Batches of 256: at 1,024 pairs every
#: one of the 20 words recurs ~50 times a batch, the fit is chaotic and the
#: card and CPU fits ended 2.5 apart; at 256 the same fit holds the CPU
#: tests' bar against the JAX package (tests/test_torch_word2vec.py, case
#: "smoke_topic")
W2V_TOPIC_CFG = dict(layer_size=32, window=5, epochs=4, lr=0.05, seed=1,
                     batch_pairs=256)
#: phase 6's ParagraphVectors runs: the label pass alone, words and labels
#: (the reference's test_paragraph_vectors_dbow, tests/test_nlp.py:249,
#: whose classification it asserts), and words and labels with negative
#: sampling too (the HS+NS path; from the reference's initial tables this
#: fit classifies both documents as "nighttime" in the reference as well,
#: so its classification is reported, not asserted)
PV_RUNS = (("pv_hs", dict(train_words=False)),
           ("pv_hs_words", dict(train_words=True)),
           ("pv_hs_ns", dict(train_words=True, negative=5)))
#: the runs whose classification is the reference test's assertion
PV_CLASSIFIED = ("pv_hs_words",)


def w2v_ns_model(corpus, device=None):
    """Phase 6's HS+NS model, vocabulary built on its sentences."""
    from deeplearning4j_tpu_torch.models.word2vec import Word2Vec
    from deeplearning4j_tpu_torch.nlp.sentence_iterator import (
        CollectionSentenceIterator,
    )

    ns = Word2Vec(layer_size=W2V_DIM, window=W2V_WINDOW,
                  batch_pairs=W2V_BATCH, lr=W2V_LR, min_word_frequency=1,
                  epochs=1, negative=5, device=device)
    ns.build_vocab(CollectionSentenceIterator(corpus[:W2V_NS_SENTENCES]))
    return ns


def w2v_quality_model(device=None):
    """The reference test's topic fit (D 32, 24 epochs)."""
    from deeplearning4j_tpu_torch.models.word2vec import Word2Vec

    return Word2Vec(layer_size=32, window=5, epochs=24, lr=0.05, seed=1,
                    device=device)


def pv_docs() -> list[tuple[str, str]]:
    """Phase 6's labeled documents: 100 each of two topics."""
    import numpy as np

    gen = np.random.default_rng(5)
    docs = []
    for _ in range(100):
        docs.append(("daytime", " ".join(gen.choice(
            ["day", "sun", "light", "bright"], 5))))
        docs.append(("nighttime", " ".join(gen.choice(
            ["night", "moon", "dark", "stars"], 5))))
    return docs


def pv_model(kw: dict, device=None):
    from deeplearning4j_tpu_torch.models.paragraph_vectors import (
        ParagraphVectors,
    )

    return ParagraphVectors(layer_size=16, epochs=12, lr=0.05, seed=6,
                            device=device, **kw)


def phase6_emb_dot_keys(model, corpus) -> list[tuple[int, int, int]]:
    """(B, L, D) of every fused #5 launch phase 6's fits make: each fit's
    batch of pairs (the last one padded to it), its vocabulary's longest
    Huffman path and its layer size. The vocabularies are built here on
    the host from the same constructors, so phase 2 can hold each shape
    before phase 6 runs it."""
    from deeplearning4j_tpu_torch.models.word2vec import Word2Vec
    from deeplearning4j_tpu_torch.nlp.sentence_iterator import (
        CollectionSentenceIterator,
    )

    fits = [model, w2v_ns_model(corpus, device="cpu")]
    topic = Word2Vec(device="cpu", **W2V_TOPIC_CFG)
    topic.build_vocab(CollectionSentenceIterator(topic_corpus(300)))
    quality = w2v_quality_model(device="cpu")
    quality.build_vocab(CollectionSentenceIterator(topic_corpus(400)))
    fits += [topic, quality]
    sents = CollectionSentenceIterator([s for _, s in pv_docs()])
    for _, kw in PV_RUNS:
        pv = pv_model(kw, device="cpu")
        pv.build_vocab(sents)
        fits.append(pv)
    return sorted({(m.batch_pairs, m.cache.max_code_length, m.layer_size)
                   for m in fits})


def w2v_full_model():
    """The full-width Word2Vec (HS) with its vocabulary built, and its
    corpus. Phase 2 needs the vocabulary's longest Huffman path."""
    import torch

    from deeplearning4j_tpu_torch.models.word2vec import Word2Vec
    from deeplearning4j_tpu_torch.nlp.sentence_iterator import (
        CollectionSentenceIterator,
    )

    t0 = time.perf_counter()
    corpus = zipf_corpus(W2V_SENTENCES, W2V_SENT_LEN, W2V_TYPES)
    t1 = time.perf_counter()
    model = Word2Vec(layer_size=W2V_DIM, window=W2V_WINDOW,
                     batch_pairs=W2V_BATCH, lr=W2V_LR, min_word_frequency=1,
                     epochs=1)
    model.build_vocab(CollectionSentenceIterator(corpus))
    t2 = time.perf_counter()
    # the initial table (the reference's threefry uniform, drawn on the
    # card); the fit keeps it
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    model.reset_weights()
    torch.cuda.synchronize()
    draw_ms = (time.perf_counter() - t3) * 1e3
    log(f"word2vec: corpus {W2V_SENTENCES} sentences x {W2V_SENT_LEN} "
        f"tokens, Zipf(1.0) over {W2V_TYPES} types, seed 0, in "
        f"{t1 - t0:.1f} s; build_vocab {t2 - t1:.1f} s: "
        f"V {len(model.cache)}, max code length "
        f"{model.cache.max_code_length}; reset_weights (threefry uniform "
        f"of V x {W2V_DIM} on the card, first call) {draw_ms:.3f} ms")
    return model, corpus


def _w2v_run(tag: str, fn):
    """Run ``fn`` with every launch count set to 0 just before and read
    just after; kernel #5 must have launched. Returns (launches, seconds
    on the host clock, fn's result)."""
    import torch

    reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    if launches["emb_dot"] <= 0:
        raise SystemExit(f"{tag}: kernel emb_dot never launched")
    return launches, secs, out


def _count_pairs(fn) -> int:
    """Runs ``fn``; returns the skip-gram pairs its enumerator produced."""
    from deeplearning4j_tpu_torch import native_io

    real = native_io.sg_pairs_chunk
    pairs = 0

    def counted(*a):
        nonlocal pairs
        ins, tgts = real(*a)
        pairs += len(ins)
        return ins, tgts

    native_io.sg_pairs_chunk = counted
    try:
        fn()
    finally:
        native_io.sg_pairs_chunk = real
    return pairs


def _bounded(tag: str, model) -> float:
    """Every table finite and max |syn0| under W2V_SYN0_CEILING (the guard
    against clipping saturated dots instead of skipping them)."""
    import torch

    for name in ("syn0", "syn1", "syn1neg"):
        if not bool(torch.isfinite(getattr(model, name)).all()):
            raise SystemExit(f"{tag}: {name} is not finite")
    top = model.syn0.abs().max().item()
    if not top < W2V_SYN0_CEILING:
        raise SystemExit(f"{tag}: max |syn0| {top} is not < "
                         f"{W2V_SYN0_CEILING}")
    return top


def _w2v_fit_run(tag: str, model, sentences, card: str) -> dict[str, int]:
    launches, secs, pairs = _w2v_run(tag, lambda: _count_pairs(
        lambda: model.fit(sentences)))
    top = _bounded(tag, model)
    log(f"{tag}: V {len(model.cache)}, max code length "
        f"{model.cache.max_code_length}, {pairs} pairs, "
        f"{launches['emb_dot']} HS batches of {model.batch_pairs}; fit "
        f"{secs:.2f} s -> {pairs / secs:.1f} pairs/s (host clock, "
        f"tokenizing and pair enumeration included; {card}); max |syn0| "
        f"{top:.4f}; launches {launches}")
    return launches


def phase_word2vec(model, corpus, card: str) -> dict[str, dict[str, int]]:
    """Phase 6. Returns each run's launch counts."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models.word2vec import (
        Word2Vec,
        word2vec_state_from_jax,
    )
    from deeplearning4j_tpu_torch.nlp.sentence_iterator import (
        CollectionSentenceIterator,
    )

    runs = {"w2v_full": _w2v_fit_run(
        "w2v full width (HS)", model, CollectionSentenceIterator(corpus),
        card)}

    ns = w2v_ns_model(corpus)
    sub = CollectionSentenceIterator(corpus[:W2V_NS_SENTENCES])
    runs["w2v_hs_ns"] = _w2v_fit_run(
        f"w2v HS+NS ({W2V_NS_SENTENCES} sentences, negative 5)", ns, sub,
        card)
    del ns

    # card vs CPU from the same tables, and the card twice
    topic = topic_corpus(300)
    cfg = W2V_TOPIC_CFG
    probe = Word2Vec(device="cpu", **cfg)
    probe.build_vocab(CollectionSentenceIterator(topic))
    v, d = len(probe.cache), cfg["layer_size"]
    rng = np.random.default_rng(0)
    tables = (((rng.random((v, d)) - 0.5) / d).astype(np.float32),
              np.zeros((v - 1, d), np.float32), np.zeros((v, d), np.float32))

    def fit_on(device):
        m = Word2Vec(device=device, **cfg)
        m.build_vocab(CollectionSentenceIterator(topic))
        st = word2vec_state_from_jax(*tables, device=device)
        m.syn0, m.syn1, m.syn1neg = st["syn0"], st["syn1"], st["syn1neg"]
        m.fit(CollectionSentenceIterator(topic))
        return m

    host = fit_on("cpu")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True  # the step must not care
    try:
        runs["w2v_card_tf32"], _, first = _w2v_run("w2v card vs cpu",
                                                   lambda: fit_on("cuda"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    runs["w2v_card_repeat"], _, again = _w2v_run("w2v card repeat",
                                                 lambda: fit_on("cuda"))
    errs = {n: (getattr(first, n).cpu() - getattr(host, n)).abs().max().item()
            for n in ("syn0", "syn1")}
    bitwise = all(torch.equal(getattr(first, n), getattr(again, n))
                  for n in ("syn0", "syn1", "syn1neg"))
    log(f"w2v card vs cpu (topic corpus, V {v}, D {d}, 4 epochs, batches "
        f"of {cfg['batch_pairs']}, same tables): max |card - cpu| syn0 "
        f"{errs['syn0']:.3e}, syn1 {errs['syn1']:.3e} (tol {W2V_TOL}); "
        f"card repeat (TF32 allowed in the first run, not in the second) "
        f"bitwise equal: {bitwise}; launches per card run "
        f"{runs['w2v_card_repeat']['emb_dot']}")
    if max(errs.values()) > W2V_TOL or not bitwise:
        raise SystemExit("word2vec on the card disagrees with the CPU or "
                         "with itself")

    q = w2v_quality_model()
    runs["w2v_quality"], secs, _ = _w2v_run(
        "w2v quality", lambda: q.fit(CollectionSentenceIterator(
            topic_corpus(400))))
    same, cross = q.similarity("day", "sun"), q.similarity("day", "moon")
    log(f"w2v quality (the reference test's fit: 400 sentences, D 32, 24 "
        f"epochs, {secs:.2f} s): similarity(day, sun) {same:.4f} > "
        f"similarity(day, moon) {cross:.4f}: {same > cross}; nearest to "
        f"night {q.words_nearest('night', top=5)}")
    if not same > cross:
        raise SystemExit("word2vec on the card did not learn the topics")

    docs = pv_docs()
    for tag, kw in PV_RUNS:
        pv = pv_model(kw)
        runs[tag], secs, _ = _w2v_run(tag, lambda: pv.fit_labeled(docs))
        finite = bool(torch.isfinite(pv.syn0_labels).all())
        guess = (pv.infer_nearest_label("sun light bright day"),
                 pv.infer_nearest_label("moon stars dark night"))
        log(f"{tag} ({'label pass only' if not pv.train_words else 'words and labels'}"
            f", {secs:.2f} s): kernel #5 launches {runs[tag]['emb_dot']}, "
            f"labels finite {finite}, nearest labels {guess}")
        if not finite:
            raise SystemExit(f"{tag}: label vectors not finite")
        if tag in PV_CLASSIFIED and guess != ("daytime", "nighttime"):
            raise SystemExit(f"{tag}: documents classified as {guess}")
    return runs


# -- phase 7 -----------------------------------------------------------------

#: phase 7a: the train command that writes the two checkpoints
CKPT_BATCH = 8
CKPT_TRAIN = ["train", "--model", "transformer", "--preset", "gpt2s",
              "--flash", "--remat", "--steps", "4", "--batch",
              str(CKPT_BATCH), "--seq-len", str(TRAIN_SEQ), "--save-every",
              "2"]
#: the CLI's default prompt ("the quick brown ", 16 bytes) and --max-new,
#: as train's closing sample and phase 7b's generate run them
GEN_PROMPT, GEN_NEW = 16, 48
#: beam search on the serve smoke's model: B 1, W 4, prompt 128, 32 new
BEAM_W, BEAM_PROMPT, BEAM_NEW = 4, 128, 32
#: a beam's score (the decode's summed log-probs) vs its sequence's
#: log-likelihood by ``transformer_apply`` in f32 on the weights the decode
#: used, in nats per generated token: bf16 compute, and in int8 mode the
#: int8 KV cache, against f32 (on the H100 the four beams' largest gap is
#: 0.11 nats over 32 tokens in bf16, 0.14 in int8; with the planted stale
#: cache of ``planted_stale_cache`` 0.72 and 2.01)
BEAM_LL_TOL = 0.01
#: speculative decoding at the reference bench's spec row (bench.py:752,
#: _decode_bench_cfg(batch=1, gqa=True)): prompt 512, 64 new, k 4, the
#: int8-weight self-draft; the timed runs sample at temperature 1, top-k 40
SPEC_PROMPT, SPEC_NEW, SPEC_K, SPEC_TOP_K = 512, 64, 4, 40
#: timed runs a side, spec and plain generate in turns
SPEC_RUNS = 5


def _printable(line: str) -> str:
    return "".join(c if c.isprintable() else f"\\x{ord(c):02x}"
                   for c in line)


def _cli(tag: str, argv: list[str]) -> tuple[dict[str, int], str]:
    """``cli.main(argv)`` in this process with every launch count set to 0
    just before and read just after; its standard output is captured and
    logged. Exits unless it returns 0. Returns (launches, output)."""
    import io

    import torch

    from deeplearning4j_tpu_torch import cli

    buf = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    out = buf.getvalue()
    log(f"{tag}: `{' '.join(argv)}` -> exit {rc} in {secs:.2f} s; "
        f"launches {launches}")
    for line in out.splitlines():
        log(f"  | {_printable(line)}")
    if rc != 0:
        raise SystemExit(f"{tag}: exit code {rc}")
    return launches, out


def _expect_output(tag: str, out: str, lines: list[str]) -> None:
    """``out`` must be the printed ``lines``, each a regular expression
    (a decoded byte stream may hold line breaks of its own)."""
    import re

    if not re.fullmatch("\n".join(lines) + "\n", out, re.S):
        raise SystemExit(f"{tag}: printed {out!r}, expected lines matching "
                         f"{lines!r}")


def _must_launch(tag: str, launches: dict[str, int], names) -> None:
    for name in names:
        if launches[name] <= 0:
            raise SystemExit(f"{tag}: kernel {name} never launched")


def phase_checkpoint(workdir: Path, card: str) -> dict[str, dict[str, int]]:
    """Phase 7a-b: ``train --checkpoint-dir`` at full width, the two
    checkpoints read back bitwise, then ``generate`` from them (beam 4, and
    greedy int8 full). Returns the launches of each run."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch import cli
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig,
        param_shapes,
    )
    from deeplearning4j_tpu_torch.parallel import checkpoint as ckpt

    d = workdir / "ckpt"
    argv = CKPT_TRAIN + ["--checkpoint-dir", str(d)]
    # time each checkpoint write inside the train command
    writes, save = [], ckpt.save

    def timed_save(*a, **kw):
        t0 = time.perf_counter()
        out = save(*a, **kw)
        writes.append(time.perf_counter() - t0)
        return out

    ckpt.save = timed_save
    try:
        train, _ = _cli("checkpoint train", argv)
    finally:
        ckpt.save = save
    _must_launch("checkpoint train", train,
                 ("flash_attn_fwd", "flash_attn_bwd"))
    names = sorted(f.name for f in d.iterdir())
    meta = ckpt.CheckpointManager(d).read_meta()
    want = cli._cfg_from_args(cli.build_parser().parse_args(argv))
    got = TransformerConfig.from_json(meta["config"])
    path = d / "ckpt_4.npz"
    log(f"checkpoint: files {names}, {path.stat().st_size / 2**20:.1f} MiB "
        f"each; writes {', '.join(f'{w:.3f}' for w in writes)} s (host "
        f"clock, device-to-host copy included; {card}); meta step "
        f"{meta['step']}, loss {meta['loss']:.4f}, config == the preset's: "
        f"{got == want}")
    if (names != ["ckpt_2.npz", "ckpt_4.npz"] or meta["step"] != 4
            or got != want or len(writes) != 2):
        raise SystemExit("checkpoint: wrong files, step or config")
    t0 = time.perf_counter()
    params, _ = ckpt.restore(path, param_shapes(got))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files if k != "__manifest__"}
    same = [k for k, leaf in ckpt.flat_leaves(params)
            if torch.equal(leaf.cpu(), torch.from_numpy(flat[k]))]
    log(f"checkpoint: restore {restore_s:.3f} s onto the card; "
        f"{len(same)}/{len(flat)} leaves equal the npz arrays bitwise")
    if len(same) != len(flat):
        raise SystemExit("checkpoint: restored params differ from the file")
    del params, flat

    beam, out = _cli("generate beam", [
        "generate", "--checkpoint-dir", str(d), "--beam", "4",
        "--max-new", "48"])
    _expect_output("generate beam", out, [r"restored step 4 from \S+"] + [
        rf"beam {w} \(logp -?\d+\.\d\d\): the quick brown .*"
        for w in range(4)])
    _must_launch("generate beam", beam, ("flash_attn_fwd", "flash_decode"))
    greedy, out = _cli("generate int8", [
        "generate", "--checkpoint-dir", str(d), "--int8", "full",
        "--temperature", "0"])
    _expect_output("generate int8", out, [
        r"restored step 4 from \S+",
        r"int8 serving mode: full \(weights \+ kv cache\)",
        r"sample: the quick brown .*"])
    _must_launch("generate int8", greedy,
                 ("flash_attn_fwd", "flash_decode_int8"))
    return {"train_ckpt": train,
            "generate_ckpt": {k: beam[k] + greedy[k] for k in beam}}


def _dequantized(params):
    """The f32 weights an int8 tree stands for: every int8 leaf times its
    ``*_scale`` sibling (norm scales such as ``ln1_scale`` have no int8
    leaf beside them and stay)."""
    import torch

    def deq(tree):
        return {n: (a.float() * tree[n + "_scale"]
                    if a.dtype == torch.int8 else a)
                for n, a in tree.items()
                if not (n.endswith("_scale") and n[:-len("_scale")] in tree)}

    out = deq({k: v for k, v in params.items() if k != "blocks"})
    out["blocks"] = deq(params["blocks"])
    return out


def _ll_gap(cfg, params, int8: bool, toks, scores) -> float:
    """max over the beams of |score - its sequence's log-likelihood by
    ``transformer_apply`` in f32 on the weights the decode used|."""
    import dataclasses

    import torch

    from deeplearning4j_tpu_torch.models.transformer import transformer_apply

    ref_cfg = dataclasses.replace(cfg, compute_dtype=torch.float32,
                                  use_flash=False, decode_int8=False)
    with torch.no_grad():
        logits, _ = transformer_apply(ref_cfg)(
            _dequantized(params) if int8 else params, toks[0])
    tp = toks.shape[2] - BEAM_NEW
    logp = torch.log_softmax(logits, dim=-1)[:, tp - 1:-1]
    ll = logp.gather(-1, toks[0, :, tp:, None])[..., 0].sum(-1)
    return (scores[0] - ll).abs().max().item()


def _teacher_forced(cfg, params, prompt, toks):
    """Each beam's summed log-probs with its own tokens fed through the
    decode program the beam search runs (the prompt prefilled at B 1, its
    rows tiled to W, then one decode step a token at B W), added in the
    beam's order. A row's logits do not depend on the other rows, so this
    equals the beam's scores bitwise when every cache row and score
    followed its beam's parents."""
    import torch

    from deeplearning4j_tpu_torch.models.transformer import (
        _decode_builder,
        kv_map,
    )

    fwd1, init_caches, prefill, cast = _decode_builder(cfg)
    params = cast(params)
    _, w, total = toks.shape
    tp = prompt.shape[1]
    with torch.no_grad():
        caches, logits = prefill(params, init_caches(1, total, prompt.device),
                                 prompt)
        caches = kv_map(lambda a: a.repeat_interleave(w, dim=2), caches)
        logp = torch.log_softmax(logits, dim=-1).expand(w, -1)
        score = torch.zeros(w, device=prompt.device)
        for i in range(tp, total):
            tok = toks[0, :, i]
            score = score + logp.gather(-1, tok[:, None])[:, 0]
            logits, caches = fwd1(params, caches, tok, i)
            logp = torch.log_softmax(logits, dim=-1)
    return score


@contextlib.contextmanager
def planted_stale_cache():
    """A planted fault for phase 7c's checks: inside the block, beam search
    reorders its token history but not its caches (``kv_map``'s calls
    after the first, the W tiling, return the cache unchanged)."""
    from deeplearning4j_tpu_torch.models import transformer as tm

    real, calls = tm.kv_map, []

    def stale(fn, *caches):
        calls.append(fn)
        return real(fn, *caches) if len(calls) == 1 else caches[0]

    tm.kv_map = stale
    try:
        yield
    finally:
        tm.kv_map = real


def phase_beam(int8: bool, card: str) -> dict[str, int]:
    """Phase 7c: beam search, B 1, W 4, prompt 128, 32 new, on the serve
    smoke's model (bf16, or int8 full). W 1 must equal greedy generate
    bitwise; the W 4 scores must be sorted, equal bitwise the beams' own
    tokens teacher-forced through the same decode program, and each lie
    within BEAM_LL_TOL a token of its sequence's log-likelihood. A run
    with a planted stale cache must fail the teacher-forced check; its
    log-likelihood gap is logged beside the sound run's. Returns the W 4
    run's launches."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models.transformer import (
        transformer_beam_search,
        transformer_generate,
    )

    tag = "beam int8" if int8 else "beam"
    cfg, params = serve_model(int8)
    prompt = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (1, BEAM_PROMPT))).cuda()
    beam = transformer_beam_search(cfg)
    greedy = transformer_generate(cfg)(params, prompt, BEAM_NEW,
                                       temperature=0.0)
    w1, _ = beam(params, prompt, 1, BEAM_NEW)
    reset_launches()
    toks, scores = beam(params, prompt, BEAM_W, BEAM_NEW)
    torch.cuda.synchronize()
    launches = read_launches()
    times = {}
    for n in (1, BEAM_NEW):
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            beam(params, prompt, BEAM_W, n)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        times[n] = float(np.median(runs))
    step_ms = (times[BEAM_NEW] - times[1]) / (BEAM_NEW - 1) * 1e3
    gap = _ll_gap(cfg, params, int8, toks, scores)
    forced = _teacher_forced(cfg, params, prompt, toks)
    forced_same = torch.equal(forced, scores[0])
    with planted_stale_cache():
        bad_toks, bad_scores = beam(params, prompt, BEAM_W, BEAM_NEW)
    bad_forced = _teacher_forced(cfg, params, prompt, bad_toks)
    bad_seen = not torch.equal(bad_forced, bad_scores[0])
    bad_gap = _ll_gap(cfg, params, int8, bad_toks, bad_scores)
    same = torch.equal(w1[:, 0], greedy)
    ordered = bool((scores[0, :-1] >= scores[0, 1:]).all())
    log(f"{tag}: B 1, W {BEAM_W}, prompt {BEAM_PROMPT}, {BEAM_NEW} new; "
        f"W 1 == greedy generate bitwise: {same}; scores "
        f"{[round(x, 4) for x in scores[0].tolist()]} sorted {ordered}; "
        f"== teacher-forced bitwise: {forced_same} (max |diff| "
        f"{(forced - scores[0]).abs().max().item():.3g}); max |score - "
        f"log-likelihood (f32 transformer_apply)| {gap:.4f} (tol "
        f"{BEAM_LL_TOL * BEAM_NEW:.2f} = {BEAM_LL_TOL} a token); planted "
        f"stale cache: teacher-forced check fails {bad_seen} (max |diff| "
        f"{(bad_forced - bad_scores[0]).abs().max().item():.4g}), "
        f"log-likelihood gap {bad_gap:.4f}; {step_ms:.3f} ms a beam step "
        f"((median of 3 at {BEAM_NEW} new - median of 3 at 1) / "
        f"{BEAM_NEW - 1}, host clock; {card}); launches {launches}")
    if (not same or not ordered or not forced_same
            or gap > BEAM_LL_TOL * BEAM_NEW):
        raise SystemExit(f"{tag}: beam search failed its checks")
    if not bad_seen:
        raise SystemExit(f"{tag}: the teacher-forced check passed a beam "
                         f"search with a stale cache")
    _must_launch(tag, launches, ("flash_attn_fwd", "flash_decode_int8"
                                 if int8 else "flash_decode"))
    return launches


def spec_config():
    import torch

    from deeplearning4j_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(
        vocab_size=50304, d_model=768, n_heads=6, n_layers=12, d_ff=3072,
        max_len=SPEC_PROMPT + SPEC_NEW + 1, use_flash=True, n_kv_heads=2,
        rope=True, compute_dtype=torch.bfloat16)


@contextlib.contextmanager
def counted_syncs():
    """Counts the host syncs made inside the block (PyTorch's sync debug
    mode warns at every synchronizing CUDA call), except while
    ``box["paused"]`` is set. Yields the box: ``n`` the syncs, ``where``
    the innermost three frames of each, ``probe`` the syncs inside the
    engines' parity probes, counted apart: a probe runs once an engine and
    geometry (its verdict read back to decide the path, and persisted with
    ``probe_cache``), not on the serving path whose syncs ``n`` counts."""
    import collections
    import traceback
    import warnings

    import torch

    from deeplearning4j_tpu_torch.serving import ServingEngine

    box = {"n": 0, "paused": 0, "probing": 0, "probe": 0,
           "where": collections.Counter()}

    def record(message, category, filename, lineno, file=None, line=None):
        if box["paused"] or "synchroniz" not in str(message):
            return
        if box["probing"]:
            box["probe"] += 1
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if Path(f.filename).name != "warnings.py"][-3:]
        box["n"] += 1
        box["where"][" < ".join(f"{Path(f.filename).name}:{f.lineno}"
                                for f in reversed(frames))] += 1

    verdict = ServingEngine._probe_verdict

    def probing(self, *a, **kw):
        box["probing"] += 1
        try:
            return verdict(self, *a, **kw)
        finally:
            box["probing"] -= 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        box["paused"] += 1  # switching the mode warns: not the block's
        torch.cuda.set_sync_debug_mode("warn")
        box["paused"] -= 1
        ServingEngine._probe_verdict = probing
        try:
            yield box
        finally:
            ServingEngine._probe_verdict = verdict
            box["paused"] += 1
            torch.cuda.set_sync_debug_mode("default")


def _count_syncs(fn):
    """(fn's result, the host syncs it made, where they were made), by
    ``counted_syncs``."""
    with counted_syncs() as box:
        out = fn()
    return out, box["n"], dict(box["where"])


def phase_spec(card: str) -> dict[str, int]:
    """Phase 7d: speculative decoding at the bench's spec geometry with
    the int8-weight self-draft. Greedy: held against generate by the
    logit-difference rule; sampled: repeatable per key seed; the
    rounds, acceptance, host syncs a round and tokens/s against plain
    generate. Returns the greedy run's launches and the first sampled
    run's."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models.transformer import (
        init_params,
        quantize_decode_params,
        transformer_generate,
        transformer_speculative_generate,
    )

    cfg = spec_config()
    params = init_params(cfg, seed=0)
    draft = quantize_decode_params(params, cfg)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, SPEC_PROMPT))).cuda()
    spec = transformer_speculative_generate(cfg)
    gen = transformer_generate(cfg)
    ref, ref_logits = gen(params, prompt, SPEC_NEW, temperature=0.0,
                          return_logits=True)
    torch.cuda.synchronize()
    reset_launches()
    (out, logits, stats), syncs, where = _count_syncs(lambda: spec(
        params, draft, prompt, SPEC_NEW, draft_k=SPEC_K, temperature=0.0,
        return_logits=True, return_stats=True))
    torch.cuda.synchronize()
    launches = read_launches()
    delta = (logits - ref_logits).abs().amax(dim=(1, 2))
    diff = (out[0] != ref[0]).nonzero()
    if diff.numel():
        j = int(diff[0]) - SPEC_PROMPT
        top2 = torch.topk(ref_logits[j, 0], 2).values
        gap = (top2[0] - top2[1]).item()
        ok = gap <= 2 * delta[j].item()
        verdict = (f"first divergence at generated position {j}: generate's "
                   f"top-2 gap {gap:.4g}, max |delta logit| there "
                   f"{delta[j].item():.4g} (bar: gap <= 2 x that); max "
                   f"|delta logit| before it "
                   f"{delta[:j].max().item() if j else 0.0:.4g}")
    else:
        ok = True
        verdict = (f"identical to generate over {SPEC_NEW} tokens; max "
                   f"|delta logit| {delta.max().item():.4g}")
    spec_tokens = out[0, SPEC_PROMPT:]
    taken = bool((logits.argmax(-1)[:, 0] == spec_tokens).all())
    rounds = stats["rounds"]
    log(f"spec: {cfg.d_model}d x {cfg.n_layers}L, vocab {cfg.vocab_size}, "
        f"{cfg.n_heads} heads over {cfg.kv_heads} KV heads of "
        f"{cfg.head_dim}, rope, max_len {cfg.max_len}, bf16, int8-weight "
        f"self-draft, B 1, prompt "
        f"{SPEC_PROMPT}, {SPEC_NEW} new, k {SPEC_K}; greedy: {verdict}; "
        f"each token the argmax of its verify logits {taken}; {rounds} "
        f"rounds, accepted a round {stats['accepted']} (mean "
        f"{np.mean(stats['accepted']):.3f}), host syncs {syncs} "
        f"({syncs / rounds:.3f} a round, at {where}); launches {launches}")
    if not ok or not taken:
        raise SystemExit("spec: the greedy stream left generate's by more "
                         "than the logit difference explains")
    if syncs != rounds:
        raise SystemExit(f"spec: {syncs} host syncs in {rounds} rounds; one "
                         f"a round expected")
    _must_launch("spec", launches, ("flash_attn_fwd", "flash_decode"))

    def sampled(seed, stats=False):
        return spec(params, draft, prompt, SPEC_NEW, draft_k=SPEC_K,
                    temperature=1.0, top_k=SPEC_TOP_K, key=seed,
                    return_stats=stats)

    torch.cuda.synchronize()
    reset_launches()
    (a, a_stats), a_syncs, a_where = _count_syncs(
        lambda: sampled(1, stats=True))
    torch.cuda.synchronize()
    sampled_launches = read_launches()
    _must_launch("spec sampled", sampled_launches,
                 ("flash_decode", "threefry_draw"))
    b, c = sampled(1), sampled(2)
    same, differ = torch.equal(a, b), not torch.equal(a, c)
    log(f"spec sampled (temperature 1, top-k {SPEC_TOP_K}): seed 1 twice "
        f"equal {same}, seed 2 differs {differ}; {a_stats['rounds']} rounds, "
        f"accepted a round mean {np.mean(a_stats['accepted']):.3f}, host "
        f"syncs {a_syncs / a_stats['rounds']:.3f} a round (at {a_where}); "
        f"launches {sampled_launches}")
    if not same or not differ or a_syncs != a_stats["rounds"]:
        raise SystemExit("spec sampled: not repeatable per seed, or more "
                         "than one host sync a round")

    walls = {"spec": [], "generate": []}
    rounds_timed = []
    for i in range(SPEC_RUNS):
        order = ("spec", "generate") if i % 2 == 0 else ("generate", "spec")
        for side in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if side == "spec":
                _, st = spec(params, draft, prompt, SPEC_NEW, draft_k=SPEC_K,
                             temperature=1.0, top_k=SPEC_TOP_K, key=100 + i,
                             return_stats=True)
                rounds_timed.append(st["rounds"])
            else:
                gen(params, prompt, SPEC_NEW, temperature=1.0,
                    top_k=SPEC_TOP_K, key=100 + i)
            torch.cuda.synchronize()
            walls[side].append(time.perf_counter() - t0)
    rate = {k: [SPEC_NEW / w for w in v] for k, v in walls.items()}
    log("spec vs generate, B 1, sampled, tokens/s (64 new over the whole "
        f"call, prefill included; host clock, {SPEC_RUNS} runs a side in "
        f"turns; {card}): " + "; ".join(
            f"{k} median {np.median(v):.2f} (range {min(v):.2f}-"
            f"{max(v):.2f})" for k, v in rate.items())
        + f"; spec rounds per timed run {rounds_timed}")
    return launches, sampled_launches


def phase_decode_variants(card: str) -> dict[str, dict[str, int]]:
    """Phase 7: checkpoint train and generate, beam search and
    speculative decoding; reports its wall seconds. The checkpoints go to
    an ignored directory of the checkout, removed at the end."""
    import shutil

    import torch

    t0 = time.perf_counter()
    workdir = ROOT / ".scratch" / "chip_smoke_phase7"
    shutil.rmtree(workdir, ignore_errors=True)
    with launched_shapes() as seen:
        try:
            runs = phase_checkpoint(workdir, card)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        torch.cuda.empty_cache()
        runs["beam"] = phase_beam(False, card)
        runs["beam_int8"] = phase_beam(True, card)
        runs["spec"], runs["spec_sampled"] = phase_spec(card)
    torch.cuda.empty_cache()
    log(f"phase 7: {time.perf_counter() - t0:.1f} s wall")
    check_launched("phase 7", seen)
    return runs


# -- phase 8 -----------------------------------------------------------------

#: phase 8a: the two shared system prompts, the suffix lengths after each,
#: and the traffic: 4 waves of 8 requests, 32 new tokens each, 8 of the 32
#: exact repeats of a prompt of the wave before
SYS_PROMPTS = {96: (8, 32), 256: (32, 96)}
PREFIX_WAVES, PREFIX_WAVE, PREFIX_NEW = 4, 8, 32
PREFIX_REPEATS = {(1, 2), (1, 5), (2, 1), (2, 4), (2, 7), (3, 0), (3, 3),
                  (3, 6)}
#: phase 8b: the seeded transient rate and the scripted faults' checks
CHAOS_RATE, CRASH_STEP, POISON_PREFILL, CRASH_PREFILL = 0.05, 6, 2, 8
#: phase 8b: the requests phase 3 serves, then 4 exact repeats of them
RECOVERY_REPEATS = (1, 5, 7, 3)
#: phase 8c: 6 decoding slots of 128-token prompts, two 512-token prompts
#: arriving after 8 horizons, 64 new tokens each; the crash run's step
#: check, counted from the long prompts' arrival (the second one's chunks
#: are pending there)
PB_SHORT, PB_LONG, PB_NEW, PB_ARRIVAL, PB_CRASH = 6, 2, 64, 8, 2


def phase8_engine(cfg, params, cls=None, **kw):
    """Phase 8's engine: the serve smoke's geometry (8 slots, max_total
    640, K 4), greedy unless asked; ``cls`` a subclass to build instead."""
    from deeplearning4j_tpu_torch.serving import ServingEngine

    kw.setdefault("temperature", 0.0)
    return (cls or ServingEngine)(cfg, params, n_slots=8, max_total=640,
                                  decode_horizon=4, block_size=BLOCK_SIZE,
                                  **kw)


def fine_grain_engine_cls():
    """The prefix route the engine did not take, built only to measure it
    (phase 8a): with the cache on, a prompt of at most one bucket is
    computed in min-bucket (8-row) chunk windows instead of kernel #1's
    one-program prefill, and its segments serve partial hits at that
    8-row grain; the hit's suffix takes the same 8-row windows, so hit and
    miss rows agree by construction. Longer prompts keep the engine's
    route. The cache-off engine still prefills short prompts with #1, so
    its streams need not equal this route's."""
    import numpy as np

    from deeplearning4j_tpu_torch.serving import ServingEngine

    class FineGrainEngine(ServingEngine):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.prefix_cache.min_seg_len = self._min_bucket
            # segments whose rows took 8-row windows, by id
            self.fine_segs = {}

        def _fine(self, n):
            return 0 < n <= self._max_bucket

        def _compute_rows(self, slab, seq, start=0, adapter=0):
            n = int(len(seq))
            if not self._fine(n):
                return super()._compute_rows(slab, seq, start, adapter)
            g, lg = self._min_bucket, None
            for t0 in range(start, n, g):
                ln = min(g, n - t0)
                pad = np.zeros((1, g), np.int64)
                pad[0, :ln] = seq[t0:t0 + ln]
                slab, lg = self._chunk_fn(self.params, slab,
                                          self._upload(pad), t0, ln - 1,
                                          self._adapter_row(adapter))
                self.prefill_dispatches += 1
            return lg

        def _classify_plan(self, pl):
            n = len(pl.req.prompt)
            if not self._fine(n) or not self._prefix_reuse_ok():
                return super()._classify_plan(pl)
            seg, m = self.prefix_cache.lookup(pl.req.prompt)
            L = 0
            if seg is not None and m == n and seg.logits is not None:
                pl.kind, L = "full", n
            elif seg is not None and self.fine_segs.get(id(seg)) is seg:
                L = min(m, n - 1) // self._min_bucket * self._min_bucket
                pl.kind = "partial" if L else "miss"
            if pl.kind == "miss":
                self.metrics.record_prefix_lookup("miss", 0)
                return
            pl.seg, pl.matched = seg, L
            self.prefix_cache.pin(seg)
            self.metrics.record_prefix_lookup("hit_" + pl.kind, L)

        def _maybe_insert_prefix(self, pl):
            st = self._slots[pl.slot]
            k = len(st.segs)
            super()._maybe_insert_prefix(pl)
            if self._fine(len(pl.req.prompt)):
                for seg in st.segs[k:]:
                    self.fine_segs[id(seg)] = seg

    return FineGrainEngine


def _must(tag: str, ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(f"{tag}: {msg}")


def _launch_check(tag: str, launches: dict[str, int], must, must_not=()):
    log(f"{tag}: launches {launches}")
    for name in must:
        _must(tag, launches[name] > 0, f"kernel {name} never launched")
    for name in must_not:
        _must(tag, launches[name] == 0,
              f"kernel {name} launched {launches[name]} times")


def _add(total: dict[str, int], launches: dict[str, int]) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def _segment_blocks(engine) -> int:
    return len({b for s in engine.prefix_cache._segments
                for b in s.block_ids})


def prefix_traffic(vocab: int):
    """Phase 8a's waves of prompts (token ids from a seeded generator)."""
    import numpy as np

    rng = np.random.default_rng(8)
    systems = {n: rng.integers(0, vocab, n) for n in SYS_PROMPTS}
    waves = []
    for w in range(PREFIX_WAVES):
        wave = []
        for i in range(PREFIX_WAVE):
            if (w, i) in PREFIX_REPEATS:
                prev = waves[w - 1]
                wave.append(prev[int(rng.integers(0, len(prev)))].copy())
                continue
            n = list(SYS_PROMPTS)[i % 2]
            lo, hi = SYS_PROMPTS[n]
            sfx = rng.integers(0, vocab, int(rng.integers(lo, hi + 1)))
            wave.append(np.concatenate([systems[n], sfx]))
        waves.append(wave)
    return waves


def _prefix_run(tag, cfg, params, waves, *, paged=False, **kw):
    """Serve phase 8a's waves (each run to completion before the next is
    submitted) with every count set to 0 just before and read just after.
    Returns (engine, streams, launches)."""
    import torch

    from deeplearning4j_tpu_torch.serving import Request

    engine = phase8_engine(cfg, params, paged=paged, **kw)
    _must(tag, engine._paged == paged, "the engine did not come up paged")
    torch.cuda.synchronize()
    streams = []
    reset_launches()
    for wave in waves:
        reqs = [Request(prompt=p, max_new=PREFIX_NEW) for p in wave]
        for r in reqs:
            engine.submit(r)
        res = engine.run()
        for r in reqs:
            _must(tag, r.status.value == "finished"
                  and res[r.id].shape == (len(r.prompt) + PREFIX_NEW,),
                  f"request {r.id} came back {r.status}")
            streams.append(res[r.id])
    torch.cuda.synchronize()
    return engine, streams, read_launches()


def phase8_prefix(card: str) -> dict[str, int]:
    """Phase 8a: the prefix cache at full width in bf16 slab, bf16 paged
    and int8 full slab, each with the cache off and on (byte-identical
    streams, full and partial hits, the probe passing), and bf16 slab with
    a two-slab region (evictions while segments are pinned)."""
    import numpy as np
    import torch

    total: dict[str, int] = {}
    modes = (("bf16 slab", False, False), ("bf16 paged", False, True),
             ("int8 full slab", True, False))
    for name, int8, paged in modes:
        tag = f"phase 8a {name}"
        cfg, params = serve_model(int8)
        waves = prefix_traffic(cfg.vocab_size)
        decode = ("flash_decode_paged" if paged else
                  "flash_decode_int8" if int8 else "flash_decode")
        off, s_off, l_off = _prefix_run(tag, cfg, params, waves,
                                        paged=paged)
        _launch_check(tag + " cache off", l_off,
                      ("flash_attn_fwd", decode))
        m_off = off.metrics.summary()
        pf_off = off.prefill_dispatches
        del off
        runs = [("", {})]
        if name == "bf16 slab":
            runs.append((" region 2 x 640", dict(prefix_cache_tokens=1280)))
        for sub, kw in runs:
            t = tag + " cache on" + sub
            on, s_on, l_on = _prefix_run(t, cfg, params, waves,
                                         paged=paged, prefix_cache=True,
                                         **kw)
            _launch_check(t, l_on, ("flash_attn_fwd", decode),
                          ("flash_decode",) if paged else ())
            _add(total, l_on)
            m = on.metrics
            s = m.summary()
            pc = on.prefix_cache
            same = [np.array_equal(a, b) for a, b in zip(s_off, s_on)]
            log(f"{t}: probe {on._prefix_ok_memo} "
                f"({on.prefix_probe_detail or 'hit rows bitwise the miss '
                'path'}); hits full {m.n_prefix_hits_full} partial "
                f"{m.n_prefix_hits_partial} of {s.get('prefix_lookups', 0)} "
                f"lookups; tokens saved {m.prefix_tokens_saved}; prefill "
                f"dispatches on {on.prefill_dispatches} off {pf_off}; "
                f"segments {pc.n_segments}, evictions {m.n_prefix_evictions}"
                f", inserts declined {pc.n_insert_declined}; TTFT p50 "
                f"{s['ttft_p50_s'] * 1e3:.2f} ms p99 "
                f"{s['ttft_p99_s'] * 1e3:.2f} ms (off {m_off['ttft_p50_s'] * 1e3:.2f} "
                f"/ {m_off['ttft_p99_s'] * 1e3:.2f} ms); streams "
                f"byte-identical to the cache-off run {sum(same)}/{len(same)}"
                f" [{card}]")
            _must(t, on._prefix_ok_memo is True,
                  f"the prefix probe declined: {on.prefix_probe_detail}")
            _must(t, all(same), f"streams differ from the cache-off run "
                  f"(requests {[i for i, ok in enumerate(same) if not ok]})")
            if sub:
                _must(t, m.n_prefix_evictions > 0, "no segment was evicted")
            else:
                _must(t, m.n_prefix_hits_full > 0
                      and m.n_prefix_hits_partial > 0, "no hit of one kind")
            if paged:
                held = _segment_blocks(on)
                log(f"{t}: blocks in use {on.pool.n_blocks_in_use}, held by "
                    f"segments {held} [{card}]")
                _must(t, on.pool.n_blocks_in_use == held,
                      "blocks in use beyond the segments' own")
            del on
        if name == "bf16 slab":
            _fine_grain_run(tag, cfg, params, waves, s_off, m_off, pf_off,
                            card)
        torch.cuda.empty_cache()
    return total


def _fine_grain_run(tag, cfg, params, waves, s_off, m_off, pf_off, card):
    """Phase 8a's measurement of the 8-row route (fine_grain_engine_cls)
    beside the engine's: its hits, tokens saved, prefill dispatches, TTFT
    and how many streams equal the cache-off run's. Launches here are not
    part of the main path's count."""
    import numpy as np

    t = tag + " cache on, 8-row route (measured, not served)"
    fine, s_fine, _ = _prefix_run(t, cfg, params, waves, prefix_cache=True,
                                  cls=fine_grain_engine_cls(),
                                  batch_admission=False)
    m, s = fine.metrics, fine.metrics.summary()
    same = [np.array_equal(a, b) for a, b in zip(s_off, s_fine)]
    n = len(same)
    log(f"{t}: hits full {m.n_prefix_hits_full} partial "
        f"{m.n_prefix_hits_partial} of {n} requests (partial share "
        f"{m.n_prefix_hits_partial / n:.4f}); tokens saved "
        f"{m.prefix_tokens_saved}; prefill dispatches {fine.prefill_dispatches}"
        f" (off {pf_off}); TTFT p50 {s['ttft_p50_s'] * 1e3:.2f} ms p99 "
        f"{s['ttft_p99_s'] * 1e3:.2f} ms (off {m_off['ttft_p50_s'] * 1e3:.2f}"
        f" / {m_off['ttft_p99_s'] * 1e3:.2f} ms); streams byte-identical to "
        f"the cache-off run {sum(same)}/{n} [{card}]")
    _must(t, m.n_prefix_hits_partial > 0, "the 8-row route made no partial "
          "hit")


def recovery_traffic(vocab: int):
    """Phase 8b's prompts: phase 3's, then exact repeats of four of them."""
    import numpy as np

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, n) for n in PROMPT_LENGTHS]
    return prompts + [prompts[i].copy() for i in RECOVERY_REPEATS]


def _recovery_run(tag, cfg, params, prompts, faults=None, **kw):
    """Serve phase 8b's requests; returns (engine, requests, results,
    launches, [(recover s, slots replayed)])."""
    import torch

    from deeplearning4j_tpu_torch.serving import Request

    engine = phase8_engine(cfg, params, prefix_cache=True, faults=faults,
                           **kw)
    recoveries = []
    recover = engine.recover

    def timed_recover():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = recover()
        torch.cuda.synchronize()
        recoveries.append((time.perf_counter() - t0, n))
        return n

    engine.recover = timed_recover
    reqs = [Request(prompt=p, max_new=MAX_NEW) for p in prompts]
    torch.cuda.synchronize()
    reset_launches()
    for r in reqs:
        engine.submit(r)
    res = engine.run()
    torch.cuda.synchronize()
    return engine, reqs, res, read_launches(), recoveries


def phase8_recovery(card: str) -> dict[str, int]:
    """Phase 8b: recovery by replay at full width with the prefix cache on,
    slab and paged, stepwise and "auto" replay, greedy and sampled (T 0.8,
    top-k 40). Faults: a crash at step check 6, a crash at the prefill
    check of a request classified as a cache hit, seeded transients at the
    step site, a permanent fault at one request's prefill. Every stream
    but the poisoned one equals an uninterrupted run's over the same
    requests without the poisoned one (it never drew a seed)."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.serving import FaultInjector

    total: dict[str, int] = {}
    cfg, params = serve_model(False)
    prompts = recovery_traffic(cfg.vocab_size)
    kept = [p for i, p in enumerate(prompts) if i != POISON_PREFILL]
    for paged in (False, True):
        for sampling in (dict(temperature=0.0),
                         dict(temperature=0.8, top_k=40)):
            mode = (f"{'paged' if paged else 'slab'}, "
                    f"{'T 0.8 top-k 40' if sampling['temperature'] else 'greedy'}")
            _, rreqs, rres, _, _ = _recovery_run(
                f"phase 8b {mode} reference", cfg, params, kept,
                paged=paged, **sampling)
            ref = [rres[r.id] for r in rreqs]
            for replay in (False, "auto"):
                tag = f"phase 8b {mode}, chunked_replay={replay}"
                faults = (FaultInjector(0, transient_rate=CHAOS_RATE,
                                        sites=("step",))
                          .plan("step", CRASH_STEP, "crash")
                          .plan("prefill", POISON_PREFILL, "permanent")
                          .plan("prefill", CRASH_PREFILL, "crash"))
                hit_at_crash = []
                eng, reqs, res, launches, recs = _recovery_run(
                    tag, cfg, params, prompts, faults=faults, paged=paged,
                    chunked_replay=replay, **sampling)
                _launch_check(tag, launches,
                              ("flash_attn_fwd", "flash_decode_paged"
                               if paged else "flash_decode"))
                _add(total, launches)
                failed = [i for i, r in enumerate(reqs)
                          if r.status.value != "finished"]
                got = [res[r.id] for i, r in enumerate(reqs)
                       if i != POISON_PREFILL]
                same = [np.array_equal(a, b) for a, b in zip(ref, got)]
                m = eng.metrics
                log(f"{tag}: restarts {m.n_restarts}, retries "
                    f"{m.n_retries}, recover() s "
                    f"{[round(t, 4) for t, _ in recs]}, slots replayed "
                    f"{[n for _, n in recs]}, mode {eng.last_recover_mode}, "
                    f"chunked-replay probe {eng._chunked_ok}; full hits "
                    f"{m.n_prefix_hits_full}; failed {failed} "
                    f"({reqs[POISON_PREFILL].error}); streams identical to "
                    f"the uninterrupted run {sum(same)}/{len(same)} [{card}]")
                _must(tag, failed == [POISON_PREFILL]
                      and "permanent" in (reqs[POISON_PREFILL].error or ""),
                      "the poisoned request is not the only one FAILED")
                _must(tag, m.n_restarts == 2, "not both crashes recovered")
                _must(tag, m.n_prefix_hits_full > 0,
                      "no admission hit the cache")
                _must(tag, all(same), "streams differ from the "
                      "uninterrupted run")
                _must(tag, (eng.last_recover_mode == "chunked") ==
                      bool(replay and eng._chunked_ok),
                      "replay took the wrong mode")
                del eng
            torch.cuda.empty_cache()
    return total


def _piggyback_run(tag, cfg, params, *, paged, piggyback, crash=False):
    """Phase 8c's traffic: 6 decoding 128-token prompts, then after 8
    horizons two 512-token ones. Returns (streams, launches, syncs per
    horizon, TPOT p99 of the 6, the longest gap between two token blocks
    of one of them, the engine)."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.serving import FaultInjector, Request

    engine = phase8_engine(cfg, params, paged=paged, piggyback=piggyback)
    _must(tag, engine._paged == paged, "the engine did not come up paged")
    _must(tag, engine._piggyback == piggyback, "piggyback is not as asked")
    rng = np.random.default_rng(3)
    short = [Request(prompt=rng.integers(0, cfg.vocab_size, 128),
                     max_new=PB_NEW) for _ in range(PB_SHORT)]
    long = [Request(prompt=rng.integers(0, cfg.vocab_size, 512),
                    max_new=PB_NEW) for _ in range(PB_LONG)]
    arrivals = {r.id: [] for r in short}
    counts = {"horizons": 0, "readbacks": 0, "pending_at_crash": None}
    process, recover = engine._process, engine.recover

    def on_process(h):
        process(h)
        now = time.perf_counter()
        counts["horizons"] += 1
        counts["readbacks"] += h.event is not None  # the event's sync
        for _, st in h.snaps:
            if st.req.id in arrivals:
                arrivals[st.req.id].append(now)

    engine._process = on_process
    torch.cuda.synchronize()
    reset_launches()
    with counted_syncs() as box:
        def paused_recover():
            counts["pending_at_crash"] = len(engine._pending)
            box["paused"] += 1
            try:
                return recover()
            finally:
                box["paused"] -= 1

        engine.recover = paused_recover
        for r in short:
            engine.submit(r)
        for _ in range(PB_ARRIVAL):
            engine.step()
        if crash:
            engine.faults = FaultInjector().plan("step", PB_CRASH, "crash")
        for r in long:
            engine.submit(r)
        res = engine.run()
        torch.cuda.synchronize()
    launches = read_launches()
    for r in short + long:
        _must(tag, r.status.value == "finished", f"request {r.id} "
              f"came back {r.status}")
    if crash:
        _must(tag, engine.metrics.n_restarts == 1, "the crash never fired")
        _must(tag, not piggyback or counts["pending_at_crash"],
              "no prefill was pending at the crash")
    tpot = [r.timing["decode_s"] / (PB_NEW - 1) for r in short]
    gap = max(float(np.diff(t).max()) for t in arrivals.values())
    per = (box["n"] + counts["readbacks"]) / counts["horizons"]
    if box["n"]:
        log(f"{tag}: syncs beyond the readback at {dict(box['where'])}")
    if box["probe"]:
        log(f"{tag}: {box['probe']} syncs inside parity probes (once an "
            f"engine and geometry, not counted a horizon)")
    return ([res[r.id] for r in short + long], launches, per,
            float(np.percentile(tpot, 99)), gap, engine)


def phase8_piggyback(card: str) -> dict[str, int]:
    """Phase 8c: piggyback on and off at full width, slab and paged, and a
    run that crashes while a long prompt's chunks are pending: the same
    bytes, one host sync a horizon."""
    import numpy as np
    import torch

    total: dict[str, int] = {}
    cfg, params = serve_model(False)
    for paged in (False, True):
        layout = "paged" if paged else "slab"
        decode = "flash_decode_paged" if paged else "flash_decode"
        out = {}
        for pb, crash in ((False, False), (True, False), (True, True)):
            if crash and paged:
                continue
            tag = (f"phase 8c {layout}, piggyback {'on' if pb else 'off'}"
                   f"{', crash mid-prefill' if crash else ''}")
            streams, launches, per, tpot99, gap, eng = _piggyback_run(
                tag, cfg, params, paged=paged, piggyback=pb, crash=crash)
            _launch_check(tag, launches, ("flash_attn_fwd", decode))
            _add(total, launches)
            m = eng.metrics
            log(f"{tag}: {m.n_prefill_chunks} chunks ({m.prefill_chunk_tokens} "
                f"tokens) deferred, decode stall {m.decode_stall_seconds:.4f}"
                f" s; host syncs per horizon {per:.3f}; decoding slots' TPOT"
                f" p99 {tpot99 * 1e3:.3f} ms, longest gap between token "
                f"blocks {gap * 1e3:.2f} ms; restarts {m.n_restarts} "
                f"[{card}]")
            _must(tag, per == 1.0, f"{per:.3f} host syncs a horizon")
            if pb:
                _must(tag, m.n_prefill_chunks > 0, "no chunk was deferred")
            out[(pb, crash)] = streams
            del eng
            torch.cuda.empty_cache()
        for key, streams in out.items():
            same = [np.array_equal(a, b)
                    for a, b in zip(out[(False, False)], streams)]
            _must(f"phase 8c {layout} {key}", all(same),
                  f"streams differ from the blocking run ({sum(same)}/"
                  f"{len(same)} identical)")
        log(f"phase 8c {layout}: every run's streams byte-identical to the "
            f"blocking run's")
    return total


def _post_status(url: str, body: dict) -> tuple[int, dict]:
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _health(base: str) -> tuple[int, dict]:
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def phase8_server(card: str) -> dict[str, int]:
    """Phase 8d: ``ServingServer`` supervising the engine. A scripted crash
    is recovered (/healthz stays 200, the request returns the
    uninterrupted tokens); crashes at every check with ``max_restarts=1``
    kill the engine (503, the waiting request FAILED)."""
    import threading

    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.serving import (
        FaultInjector,
        Request,
        ServingServer,
    )

    tag = "phase 8d"
    cfg, params = serve_model(False)
    engine = phase8_engine(cfg, params, prefix_cache=True)
    prompt = np.random.default_rng(4).integers(0, cfg.vocab_size, 150)
    ref = Request(prompt=prompt, max_new=16)
    engine.submit(ref)
    want = engine.run()[ref.id].tolist()
    torch.cuda.synchronize()
    reset_launches()
    engine.faults = FaultInjector().plan("step", 2, "crash")
    server = ServingServer(engine, port=0).start()
    try:
        base = "http://%s:%d" % server.address
        status, body = _post_status(base + "/v1/generate",
                                    {"prompt": prompt.tolist(),
                                     "max_new": 16})
        code, health = _health(base)
        log(f"{tag}: a crash under the server: HTTP {status}, tokens "
            f"{'identical to' if body.get('tokens') == want else 'DIFFER from'}"
            f" the uninterrupted run's; /healthz {code} restarts "
            f"{health['restarts']} ok {health['ok']} [{card}]")
        _must(tag, status == 200 and body["tokens"] == want,
              "the request did not return the uninterrupted tokens")
        _must(tag, code == 200 and health["ok"] and health["restarts"] == 1,
              f"/healthz after the recovery: {code} {health}")
    finally:
        server.stop(drain_s=10.0)
    launches = read_launches()
    engine.faults = FaultInjector().plan("step", 0, "crash", times=10**9)
    server = ServingServer(engine, port=0, max_restarts=1).start()
    try:
        base = "http://%s:%d" % server.address
        out = {}
        t = threading.Thread(target=lambda: out.update(resp=_post_status(
            base + "/v1/generate", {"prompt": prompt.tolist(),
                                    "max_new": 16})))
        t.start()
        deadline = time.time() + 120
        code, health = _health(base)
        while code == 200 and time.time() < deadline:
            time.sleep(0.05)
            code, health = _health(base)
        t.join(timeout=120)
        status, body = out.get("resp", (None, {}))
        after, _ = _post_status(base + "/v1/generate",
                                {"prompt": [1, 2], "max_new": 2})
        log(f"{tag}: crashes at every check, max_restarts 1: /healthz {code}"
            f" ({health['last_error']}); the waiting request HTTP {status} "
            f"{body.get('status')}; a new request HTTP {after} [{card}]")
        _must(tag, code == 503 and not health["engine_alive"],
              "/healthz did not turn 503")
        _must(tag, status == 500 and body.get("status") == "failed",
              "the waiting request was not FAILED")
        _must(tag, after == 503, "a request to a dead engine was accepted")
    finally:
        server.stop()
    return launches


def phase_serving_features(card: str) -> dict[str, dict[str, int]]:
    """Phase 8: the serving engine's prefix cache, crash recovery and
    piggyback prefill at GPT-2-small's width; reports its wall seconds and
    fails on a launch of #1-#5 at a shape phase 2 did not hold."""
    import torch

    t0 = time.perf_counter()
    with launched_shapes() as seen:
        runs = {"prefix": phase8_prefix(card)}
        runs["recovery"] = phase8_recovery(card)
        runs["piggyback"] = phase8_piggyback(card)
        runs["server_recovery"] = phase8_server(card)
    torch.cuda.empty_cache()
    log(f"phase 8: {time.perf_counter() - t0:.1f} s wall [{card}]")
    check_launched("phase 8", seen)
    return runs


# -- phase 9 -----------------------------------------------------------------

#: phase 9: 16 unconstrained requests (phase 3's prompt lengths twice)
SURF_NEW = 32
#: 9b: the regexes (finite languages: every stream must end in EOS) and
#: the README's schema, EOS token 0
SURF_REGEXES = ("(yes|no)", "(yes|no|maybe)!?", "[a-c]{2,5}",
                "-?[0-9]{1,3}", "(red|green|blue)", "[A-Z][a-z]{1,4}",
                "(0|[1-9][0-9]?)", "(on|off)")
SURF_SCHEMA = {"type": "object",
               "properties": {"ok": {"type": "boolean"},
                              "tag": {"enum": ["a", "b"]}},
               "required": ["ok", "tag"]}
SURF_EOS, SURF_CONSTRAINED_NEW = 0, 40
#: 9d: the crash's step check
SURF_CRASH = 3
#: 9e: the 2-layer model's requests (prompt lengths), new tokens each
CROSS_PROMPTS, CROSS_NEW = (16, 24, 33, 40, 48, 57, 64, 72), 16


def surface_prompts(vocab: int):
    import numpy as np

    rng = np.random.default_rng(9)
    return [rng.integers(0, vocab, n) for n in PROMPT_LENGTHS * 2]


def _surface_run(tag, cfg, params, reqs, **kw):
    """Serve ``reqs`` on phase 8's engine geometry with every count set to
    0 just before and read just after. Returns (engine, results, launches,
    generated tokens/s over the run, host clock)."""
    import torch

    engine = phase8_engine(cfg, params, **kw)
    if kw.get("sampling_surface"):
        _must(tag, engine._surface, "the masked parity probe failed")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    res = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    new = sum(len(res[r.id]) - len(r.prompt) for r in reqs)
    return engine, res, read_launches(), new / wall


def _plain_reqs(prompts, **kw):
    from deeplearning4j_tpu_torch.serving import Request

    return [Request(prompt=p, max_new=SURF_NEW, **kw) for p in prompts]


def phase9_parity(card: str, cfg, params, total) -> None:
    """9a: unconstrained traffic through the armed engine equals the plain
    engine's bytes, greedy and T 0.8 top-k 40, slab and paged bs 8; slab
    runs in turns (plain, masked, masked, plain) for tok/s."""
    import numpy as np

    prompts = surface_prompts(cfg.vocab_size)
    for paged in (False, True):
        for sampling in (dict(temperature=0.0),
                         dict(temperature=0.8, top_k=40)):
            sampled = sampling["temperature"] > 0
            mode = (f"{'paged' if paged else 'slab'}, "
                    f"{'T 0.8 top-k 40' if sampled else 'greedy'}")
            tag = f"phase 9a {mode}"
            order = ((False, True, True, False) if not paged
                     else (False, True))
            streams, rates = {}, {False: [], True: []}
            for surface in order:
                eng, res, launches, rate = _surface_run(
                    tag, cfg, params, reqs := _plain_reqs(prompts),
                    paged=paged, sampling_surface=surface, **sampling)
                _must(tag, eng._paged == paged, "not paged")
                _launch_check(f"{tag} {'masked' if surface else 'plain'}",
                              launches, ("flash_attn_fwd",
                                         "flash_decode_paged" if paged
                                         else "flash_decode")
                              + (("threefry_draw",) if sampled else ()),
                              () if sampled else ("threefry_draw",))
                _add(total, launches)
                rates[surface].append(rate)
                got = [res[r.id] for r in reqs]
                if surface in streams:
                    _must(tag, all(np.array_equal(a, b) for a, b in
                                   zip(streams[surface], got)),
                          "a repeated run differs")
                streams[surface] = got
                del eng
            same = [np.array_equal(a, b)
                    for a, b in zip(streams[False], streams[True])]
            log(f"{tag}: masked vs plain streams identical "
                f"{sum(same)}/{len(same)}; tok/s plain "
                f"{[round(x, 2) for x in rates[False]]}, masked "
                f"{[round(x, 2) for x in rates[True]]} (16 requests, "
                f"{SURF_NEW} new; host clock) [{card}]")
            _must(tag, all(same), "masked streams differ from the plain "
                  "engine's")


def _constrained_reqs(n_regex=8, n_json=8, max_new=SURF_CONSTRAINED_NEW):
    """9b's requests: the regexes then the README's schema, alternating
    T 0 and T 0.8 a request (the engine's T is 0)."""
    import numpy as np

    from deeplearning4j_tpu_torch.serving import Request

    rng = np.random.default_rng(10)
    fmts = ([{"type": "regex", "regex": rx} for rx in SURF_REGEXES[:n_regex]]
            + [{"type": "json_schema", "schema": SURF_SCHEMA}] * n_json)
    return [Request(prompt=rng.integers(1, 256, 8 + 3 * i), max_new=max_new,
                    eos_token=SURF_EOS, response_format=f,
                    temperature=0.8 if i % 2 else None)
            for i, f in enumerate(fmts)]


def _check_constrained(tag, res, reqs) -> list[str]:
    """Every token DFA-permitted, the stream ends in EOS at an accepting
    state, and a schema's output parses and validates. Returns the
    decoded outputs."""
    import json

    from deeplearning4j_tpu_torch.serving.grammar import validate_json_value

    outs = []
    for r in reqs:
        toks = [int(t) for t in res[r.id][len(r.prompt):]]
        cg = r._grammar
        st = cg.start
        for t in toks[:-1]:
            _must(tag, cg.trans[st, t] >= 0,
                  f"request {r.id}: token {t} not permitted in state {st}")
            st = int(cg.trans[st, t])
        _must(tag, toks and toks[-1] == SURF_EOS and cg.accepting[st],
              f"request {r.id} did not end in EOS at an accepting state")
        text = bytes(toks[:-1]).decode("latin-1")
        if r.response_format["type"] == "json_schema":
            _must(tag, validate_json_value(json.loads(text), SURF_SCHEMA),
                  f"request {r.id}: {text!r} does not validate")
        outs.append(text)
    return outs


def phase9_constrained(card: str, cfg, params, total) -> None:
    """9b: 8 regex and 8 JSON-schema requests, greedy and T 0.8."""
    tag = "phase 9b"
    reqs = _constrained_reqs()
    eng, res, launches, _ = _surface_run(tag, cfg, params, reqs,
                                         sampling_surface=True)
    _launch_check(tag, launches, ("flash_attn_fwd", "flash_decode",
                                  "threefry_draw"))
    _add(total, launches)
    outs = _check_constrained(tag, res, reqs)
    m = eng.metrics._c_grammar_compiles
    log(f"{tag}: {len(reqs)} constrained requests, every token permitted "
        f"and every output valid: {outs}; compiles miss "
        f"{m.value(result='miss'):.0f}, hit {m.value(result='hit'):.0f}; "
        f"table rows {eng._gtable.rows_used} [{card}]")


def phase9_controls(card: str, cfg, params, total) -> None:
    """9c: stop, logit bias, logprobs and top-p 1e-6 (equal to greedy) on
    a T 0.8 top-k 40 engine."""
    import numpy as np

    from deeplearning4j_tpu_torch.serving import Request

    tag = "phase 9c"
    prompts = surface_prompts(cfg.vocab_size)[:8]
    _, ref, _, _ = _surface_run(f"{tag} greedy", cfg, params,
                                greedy := _plain_reqs(prompts),
                                temperature=0.0)
    ref = [[int(t) for t in ref[r.id][len(r.prompt):]] for r in greedy]
    stops = [ref[i][3:5] for i in (2, 3)]
    reqs = ([Request(prompt=p, max_new=SURF_NEW, top_p=1e-6)
             for p in prompts[:2]]
            + [Request(prompt=prompts[i], max_new=SURF_NEW, temperature=0.0,
                       stop=[st]) for i, st in zip((2, 3), stops)]
            + [Request(prompt=p, max_new=SURF_NEW, logit_bias={7: 1000.0})
               for p in prompts[4:6]]
            + [Request(prompt=p, max_new=SURF_NEW, temperature=0.0,
                       logprobs=True, top_logprobs=3) for p in prompts[6:]])
    eng, res, launches, _ = _surface_run(tag, cfg, params, reqs,
                                         sampling_surface=True,
                                         temperature=0.8, top_k=40)
    _launch_check(tag, launches, ("flash_decode", "threefry_draw"))
    _add(total, launches)
    got = [[int(t) for t in res[r.id][len(r.prompt):]] for r in reqs]
    top_p_ok = got[0] == ref[0] and got[1] == ref[1]
    stop_ok = True
    for j, (i, st) in enumerate(zip((2, 3), stops)):
        cut = next(c for c in range(len(ref[i]) - 1)
                   if ref[i][c:c + 2] == st)
        stop_ok &= got[2 + j] == ref[i][:cut]
    hits = eng.metrics._c_stop_hits.value()
    bias_ok = all(g == [7] * SURF_NEW for g in got[4:6])
    lp_ok = True
    for r, g, want in zip(reqs[6:], got[6:], ref[6:]):
        recs = r.logprobs_out
        lp_ok &= g == want and len(recs) == len(g)
        for tok, rec in zip(g, recs):
            tops = rec["top_logprobs"]
            lps = [t["logprob"] for t in tops]
            lp_ok &= (rec["token"] == tok and rec["logprob"] <= 0.0
                      and tops[0]["token"] == tok and len(tops) == 3
                      and lps == sorted(lps, reverse=True)
                      and np.isclose(tops[0]["logprob"], rec["logprob"]))
    log(f"{tag}: top-p 1e-6 equals greedy {top_p_ok}; stops cut exactly "
        f"{stop_ok} ({hits:.0f} stop hits); logit bias {{7: 1000}} forces "
        f"7 {bias_ok}; logprobs records consistent {lp_ok} (first: "
        f"{reqs[6].logprobs_out[0]}) [{card}]")
    _must(tag, top_p_ok and stop_ok and hits == 2 and bias_ok and lp_ok,
          "a sampling control misbehaved")


def phase9_recovery(card: str, cfg, params, total) -> None:
    """9d: a crash mid-run with constrained sampled requests in flight;
    streams equal the uninterrupted run's."""
    import numpy as np

    from deeplearning4j_tpu_torch.serving import FaultInjector, Request

    tag = "phase 9d"
    prompts = surface_prompts(cfg.vocab_size)[:4]

    def make():
        reqs = _constrained_reqs(n_regex=2, n_json=2)
        for r in reqs:
            r.temperature = None  # the engine's T 0.8
        reqs += _plain_reqs(prompts)
        reqs.append(Request(prompt=prompts[0], max_new=SURF_NEW,
                            logit_bias={9: 5.0}, logprobs=True))
        return reqs

    kw = dict(sampling_surface=True, temperature=0.8, top_k=40,
              prefix_cache=True)
    _, ref, _, _ = _surface_run(f"{tag} uninterrupted", cfg, params,
                                ref_reqs := make(), **kw)
    eng, res, launches, _ = _surface_run(
        tag, cfg, params, reqs := make(),
        faults=FaultInjector().plan("step", SURF_CRASH, "crash"), **kw)
    _add(total, launches)
    same = [np.array_equal(ref[a.id], res[b.id])
            for a, b in zip(ref_reqs, reqs)]
    _check_constrained(tag, res, reqs[:4])
    log(f"{tag}: restarts {eng.metrics.n_restarts} (mode "
        f"{eng.last_recover_mode}); streams identical to the "
        f"uninterrupted run {sum(same)}/{len(same)}; the logprob records "
        f"equal {reqs[-1].logprobs_out == ref_reqs[-1].logprobs_out} "
        f"[{card}]")
    _must(tag, eng.metrics.n_restarts == 1 and all(same)
          and reqs[-1].logprobs_out == ref_reqs[-1].logprobs_out,
          "the recovered run differs from the uninterrupted one")


def phase9_cross(card: str, total) -> None:
    """9e: the port on the card against the port on the CPU, at 2 layers
    of GPT-2-small's width in f32 (the kernels' f32 paths left out:
    ``use_flash`` and ``decode_kernel`` off, so the card's only kernel is
    the draw), T 0.8 top-k 40, 8 requests. The streams are identical, or at
    the first divergence both sides drew under the same key and position
    and the CPU side's perturbed top-2 gap is at most 2 |delta| + 1e-5,
    |delta| the largest difference between the two sides' scaled logits
    (the near-tie rule of ``tests/test_torch_sampled_parity.py``); it
    fails otherwise."""
    import dataclasses

    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models.transformer import init_params
    from deeplearning4j_tpu_torch.ops import threefry
    from deeplearning4j_tpu_torch.serving import Request, ServingEngine

    tag = "phase 9e"
    cfg = dataclasses.replace(gpt2s_config(), n_layers=2, use_flash=False,
                              decode_kernel=False,
                              compute_dtype=torch.float32)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in CROSS_PROMPTS]
    params = init_params(cfg, seed=0, device="cpu")

    def run(device, ps, max_new):
        eng = ServingEngine(cfg, params, n_slots=8, max_total=128,
                            decode_horizon=4, temperature=0.8, top_k=40,
                            device=device)
        reqs = [Request(prompt=p, max_new=max_new) for p in ps]
        reset_launches()
        for r in reqs:
            eng.submit(r)
        res = eng.run()
        return [res[r.id] for r in reqs], read_launches()

    t0 = time.perf_counter()
    card_out, launches = run("cuda", prompts, CROSS_NEW)
    _launch_check(tag, launches, ("threefry_draw",))
    _add(total, launches)
    cpu_out, _ = run("cpu", prompts, CROSS_NEW)
    same = [np.array_equal(a, b) for a, b in zip(card_out, cpu_out)]
    notes = []
    for i in (i for i, ok in enumerate(same) if not ok):
        j = int(np.nonzero(card_out[i] != cpu_out[i])[0][0])
        # the draw's inputs at the divergence, one request alone (a
        # stream does not depend on its batch), on each side
        seen = {}
        at = j  # the draw of stream index j runs at position j
        for dev, fn in (("cuda", "_launch"), ("cpu", "categorical_plain")):
            orig = getattr(threefry, fn)

            def spy(logits, keys, pos, orig=orig, dev=dev):
                if dev not in seen and int(pos[0]) == at:
                    seen[dev] = (logits[0].float().cpu(), keys[0].cpu(),
                                 pos[:1].cpu())
                return orig(logits, keys, pos)

            setattr(threefry, fn, spy)
            try:
                run(dev, [prompts[i]], j - len(prompts[i]) + 1)
            finally:
                setattr(threefry, fn, orig)
        lg, keys, pos = seen["cpu"]
        pert = (threefry.gumbel_from_bits(threefry.random_bits_rows(
            threefry.fold_in_rows(keys[None], pos), lg.shape[0]))[0] + lg)
        top2 = torch.topk(pert, 2).values
        gap = (top2[0] - top2[1]).item()
        delta = (seen["cuda"][0] - lg).abs()
        delta = delta[torch.isfinite(delta)].max().item()
        note = (f"request {i} at token {j - len(prompts[i])}: CPU perturbed "
                f"top-2 gap {gap:.3g}, max |delta scaled logit| card vs CPU "
                f"{delta:.3g}")
        notes.append(note)
        _must(tag, torch.equal(seen["cuda"][1], keys)
              and torch.equal(seen["cuda"][2], pos),
              f"{note}: the card drew under another key or position")
        _must(tag, gap <= 2 * delta + 1e-5,
              f"{note}: a divergence that is not a near-tie")
    log(f"{tag}: 2 layers x {cfg.d_model}d f32, T 0.8 top-k 40, card vs CPU "
        f"streams identical {sum(same)}/{len(same)}"
        f"{'; ' + '; '.join(notes) if notes else ''} "
        f"({time.perf_counter() - t0:.1f} s) [{card}]")


def phase_surface(card: str) -> dict[str, dict[str, int]]:
    """Phase 9: the sampling surface at GPT-2-small's width (phase 3's
    model, 8 slots, max_total 640, K 4); fails on a launch at a shape
    phase 2 did not hold."""
    import torch

    t0 = time.perf_counter()
    cfg, params = serve_model(False)
    runs = {k: {} for k in ("surface_parity", "surface_constrained",
                            "surface_controls", "surface_recovery",
                            "surface_cross")}
    with launched_shapes() as seen:
        phase9_parity(card, cfg, params, runs["surface_parity"])
        phase9_constrained(card, cfg, params, runs["surface_constrained"])
        phase9_controls(card, cfg, params, runs["surface_controls"])
        phase9_recovery(card, cfg, params, runs["surface_recovery"])
        del params
        torch.cuda.empty_cache()
        phase9_cross(card, runs["surface_cross"])
    torch.cuda.empty_cache()
    log(f"phase 9: {time.perf_counter() - t0:.1f} s wall [{card}]")
    check_launched("phase 9", seen)
    return runs


# -- phase 10 ----------------------------------------------------------------

#: 10a: new tokens a streamed request; the stop request's engine-wide T 0
STREAM_NEW = 32
#: 10c: the bank of ``serve --lora-adapters 4 --lora-rank 4 --lora-seed 0``
LORA_N, LORA_RANK, LORA_SEED = 4, 4, 0
#: 10d: the tenants (weights 1, 2, 1; the second capped at 2 slots, the
#: third's bucket holding two requests of 10d's cost, 64 + 16 tokens)
TENANT_NEW, TENANT_PROMPT = 16, 64
TENANTS = {"tenants": [
    {"id": "flood", "api_key": "k-flood", "weight": 1},
    {"id": "capped", "api_key": "k-capped", "weight": 2, "max_slots": 2},
    {"id": "metered", "api_key": "k-metered", "weight": 1,
     "rate_tokens_per_s": 1, "burst_tokens": 2 * (TENANT_PROMPT + TENANT_NEW)},
]}
#: 10e: the crash's step check
LORA_CRASH = 3
#: the keys of the reference server's ``/metrics.json`` on a single-tenant
#: engine without the prefix cache, after traffic (the program attribution
#: on, as both engines default), and those its summary adds when their
#: events happen (``tests/test_torch_streaming.py`` holds the port's
#: against the reference server's on the CPU)
REF_METRICS_JSON_KEYS = {
    "n_finished", "n_generated", "n_retries", "n_restarts", "n_failed",
    "n_cancelled", "n_expired", "steps", "decode_horizon", "ttft_p50_s",
    "ttft_p99_s", "tpot_p50_s", "tpot_p99_s", "queue_delay_p50_s",
    "queue_delay_p99_s", "sync_wait_mean_s", "dispatch_overlap_frac",
    "occupancy_mean", "queue_depth_max", "phase_seconds", "phase_frac",
    "n_slots", "slots_active", "queue_depth", "draining", "engine_alive",
    "last_error", "program_seconds", "program_dispatches"}
#: keys the reference's summary adds once their events happened
REF_METRICS_JSON_OPTIONAL = {"decode_stall_s", "rejections", "tenants",
                             "batched_admissions", "n_embeddings",
                             "embedding_p50_s"}


def _sse_request(base: str, body: dict, headers=None):
    """POST ``body`` with ``"stream": true``; returns (the frames, seconds
    from the send to the first token frame)."""
    import http.client
    from urllib.parse import urlparse

    u = urlparse(base)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", "/v1/generate",
                 body=json.dumps(dict(body, stream=True)),
                 headers={"Content-Type": "application/json",
                          **(headers or {})})
    resp = conn.getresponse()
    if resp.status != 200:
        raise SystemExit(f"a streamed request got HTTP {resp.status}")
    frames, t_first = [], None
    while True:
        line = resp.readline()
        if not line:
            break
        if line.startswith(b"data: "):
            frames.append(json.loads(line[len(b"data: "):]))
            if t_first is None and "token" in frames[-1]:
                t_first = time.perf_counter() - t0
    conn.close()
    return frames, t_first


def _submitted(engine) -> int:
    """Requests the engine has queued or seated (a request mid-admission
    counts later, never twice)."""
    return len(engine.scheduler) + len(engine.metrics.queue_delay)


def _in_order(engine, calls) -> list:
    """Run each HTTP call on its own thread, the next one started only once
    the engine holds the previous request: the scheduler's FIFO order (the
    order slot keys are split in) is the order of ``calls``. Returns the
    calls' results in order."""
    import threading

    out = [None] * len(calls)
    threads = []
    for i, call in enumerate(calls):
        base = _submitted(engine)

        def run(i=i, call=call):
            out[i] = call()

        t = threading.Thread(target=run)
        t.start()
        threads.append(t)
        deadline = time.time() + 120
        while _submitted(engine) <= base and time.time() < deadline:
            if out[i] is not None:
                break  # answered before it was seen queued (a reject)
            time.sleep(0.0005)
    for t in threads:
        t.join(timeout=600)
    return out


def _stream_bodies(vocab: int) -> list[dict]:
    """10a's requests: 8 greedy and 8 at T 0.8 top-k 40 over phase 3's
    prompt lengths, and one greedy request with a stop sequence taken from
    its own greedy stream (filled in by the caller)."""
    import numpy as np

    rng = np.random.default_rng(10)
    out = []
    for sampled in (False, True):
        for n in PROMPT_LENGTHS:
            b = {"prompt": rng.integers(0, vocab, n).tolist(),
                 "max_new": STREAM_NEW}
            if sampled:
                b.update(temperature=0.8, top_k=40)
            out.append(b)
    return out


def _serve_and_count(engine, fn):
    """Run ``fn`` against a started server of ``engine`` with the launch
    counts set to 0 and the host syncs counted; returns (fn's result,
    launches, host syncs a horizon)."""
    import torch

    counts = {"horizons": 0, "readbacks": 0}
    process = engine._process

    def on_process(h):
        process(h)
        counts["horizons"] += 1
        counts["readbacks"] += h.event is not None

    engine._process = on_process
    torch.cuda.synchronize()
    reset_launches()
    try:
        with counted_syncs() as box:
            out = fn()
            torch.cuda.synchronize()
    finally:
        engine._process = process
    per = (box["n"] + counts["readbacks"]) / max(1, counts["horizons"])
    if box["n"]:
        log(f"syncs beyond the readback at {dict(box['where'])}")
    if box["probe"]:
        log(f"{box['probe']} syncs inside parity probes (once an engine and "
            f"geometry, not counted a horizon)")
    return out, read_launches(), per


def phase10_streaming(card: str, cfg, params, total) -> None:
    """10a: SSE at full width, slab then paged: 8 greedy and 8 sampled
    requests and a stop-sequence request, streamed and not, on fresh
    sampling-surface engines fed in the same order; the SSE tokens are
    the non-streamed tails byte for byte, streaming adds no host sync a
    horizon, the caller's TTFT beside the engine's, and a client that
    disconnects frees its slot within one horizon of its cancel."""
    import socket

    import numpy as np

    from deeplearning4j_tpu_torch.serving import ServingServer

    bodies = _stream_bodies(cfg.vocab_size)
    # the stop request: a pair of tokens of its own greedy stream
    eng = phase8_engine(cfg, params, sampling_surface=True)
    eng.submit(req := _plain_reqs([np.asarray(bodies[0]["prompt"])])[0])
    tail = eng.run()[req.id][len(req.prompt):].tolist()
    bodies.append(dict(bodies[0], stop=[tail[10:12]]))
    del eng
    for paged in (False, True):
        layout = "paged" if paged else "slab"
        tag = f"phase 10a {layout}"
        got, syncs = {}, {}
        for stream in (False, True):
            engine = phase8_engine(cfg, params, paged=paged,
                                   sampling_surface=True)
            _must(tag, engine._surface and engine._paged == paged,
                  "the engine did not come up as asked")
            server = ServingServer(engine, port=0).start()
            base = "http://%s:%d" % server.address
            try:
                if stream:
                    calls = [lambda b=b: _sse_request(base, b)
                             for b in bodies]
                else:
                    calls = [lambda b=b: _post_status(
                        base + "/v1/generate", b) for b in bodies]
                out, launches, per = _serve_and_count(
                    engine, lambda: _in_order(engine, calls))
                s = engine.metrics.summary()
                ttft = np.asarray(engine.metrics.ttft.values)
            finally:
                server.stop(drain_s=10.0)
            _launch_check(f"{tag} stream={stream}", launches,
                          ("flash_attn_fwd", "threefry_draw",
                           "flash_decode_paged" if paged else "flash_decode"))
            _add(total, launches)
            syncs[stream] = per
            if stream:
                toks = [[f["token"] for f in frames if "token" in f]
                        for frames, _ in out]
                finals = [frames[-1] for frames, _ in out]
                _must(tag, all(f.get("done") and f["status"] == "finished"
                               and f["n_tokens"] == len(t)
                               for f, t in zip(finals, toks)),
                      "a stream did not end with its final frame")
                caller = np.asarray([t for _, t in out])
                log(f"{tag}: TTFT at the caller (first SSE token frame) "
                    f"p50 {np.percentile(caller, 50) * 1e3:.2f} ms p90 "
                    f"{np.percentile(caller, 90) * 1e3:.2f} ms; the "
                    f"engine's p50 {np.percentile(ttft, 50) * 1e3:.2f} ms "
                    f"p90 {np.percentile(ttft, 90) * 1e3:.2f} ms "
                    f"({len(bodies)} requests) [{card}]")
            else:
                _must(tag, all(c == 200 for c, _ in out),
                      "a request failed")
                toks = [r["tokens"][len(b["prompt"]):]
                        for (_, r), b in zip(out, bodies)]
            got[stream] = toks
            log(f"{tag}, streaming {'on' if stream else 'off'}: host syncs "
                f"per horizon {per:.3f} over {s['steps']} horizons; "
                f"launches {launches} [{card}]")
        same = [a == b for a, b in zip(got[False], got[True])]
        log(f"{tag}: SSE tokens vs the non-streamed tails identical "
            f"{sum(same)}/{len(same)} (8 greedy, 8 T 0.8 top-k 40, 1 with "
            f"a stop sequence; the stop stream {len(got[True][-1])} tokens "
            f"of {STREAM_NEW})")
        _must(tag, all(same), "SSE tokens differ from the non-stream tail")
        _must(tag, len(got[True][-1]) < STREAM_NEW,
              "the stop sequence never fired")
        _must(tag, syncs[True] == syncs[False] == 1.0,
              f"host syncs a horizon: {syncs}")
    # a client that disconnects mid-stream
    tag = "phase 10a disconnect"
    engine = phase8_engine(cfg, params)
    server = ServingServer(engine, port=0).start()
    try:
        host, port = server.address
        body = json.dumps({"prompt": bodies[0]["prompt"],
                           "max_new": 400, "stream": True}).encode()
        sock = socket.create_connection((host, port), timeout=120)
        sock.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Type: application/json\r\nContent-Length: "
                     + str(len(body)).encode() + b"\r\n\r\n" + body)
        buf = b""
        while buf.count(b"data: ") < 2:
            buf += sock.recv(4096)
        sock.close()
        deadline = time.time() + 60
        at_cancel = None
        while engine.pool.n_active and time.time() < deadline:
            st = next((s for s in engine._slots if s is not None), None)
            if at_cancel is None and st is not None and st.req.cancelled:
                at_cancel = engine.metrics._step
            time.sleep(0.0002)
        freed = engine.metrics._step
    finally:
        server.stop(drain_s=10.0)
    n = engine.metrics.n_cancelled
    log(f"{tag}: the client closed after 2 frames; request cancelled "
        f"({n}), slot freed {freed - (at_cancel or freed)} horizon(s) after "
        f"the cancel, {engine.metrics.n_generated} tokens finished "
        f"[{card}]")
    _must(tag, n == 1 and engine.pool.n_active == 0,
          "the slot was not freed")
    _must(tag, at_cancel is None or freed - at_cancel <= 1,
          "the slot outlived the cancel by more than one horizon")


def phase10_front_end(card: str, cfg, params) -> None:
    """10b: ``/drain`` turns ``/readyz`` to 503 and new submits to 503
    while the in-flight request finishes; ``/undrain`` restores 200;
    ``/metrics.json`` has the reference server's keys."""
    import threading

    from deeplearning4j_tpu_torch.serving import ServingServer

    tag = "phase 10b"
    engine = phase8_engine(cfg, params)
    server = ServingServer(engine, port=0).start()
    base = "http://%s:%d" % server.address

    def get(path):
        try:
            with urllib.request.urlopen(base + path, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        out = {}
        t = threading.Thread(target=lambda: out.update(r=_post_status(
            base + "/v1/generate", {"prompt": list(range(1, 41)),
                                    "max_new": 200})))
        t.start()
        deadline = time.time() + 60
        while engine.pool.n_active == 0 and time.time() < deadline:
            time.sleep(0.001)
        ready0 = get("/readyz")[0]
        drain = _post_status(base + "/drain", {})
        ready1, body1 = get("/readyz")
        new = _post_status(base + "/v1/generate", {"prompt": [1, 2],
                                                   "max_new": 2})
        t.join(timeout=120)
        code, res = out["r"]
        undrain = _post_status(base + "/undrain", {})
        ready2 = get("/readyz")[0]
        after = _post_status(base + "/v1/generate", {"prompt": [1, 2],
                                                     "max_new": 2})[0]
        mj = get("/metrics.json")[1]
    finally:
        server.stop()
    keys = set(mj)
    log(f"{tag}: /readyz {ready0}; /drain {drain[0]} (in flight "
        f"{drain[1]['in_flight']}); /readyz {ready1}; a new submit "
        f"{new[0]}; the in-flight request {code} with "
        f"{len(res.get('tokens', [])) - 40} tokens; /undrain {undrain[0]}; "
        f"/readyz {ready2}; a submit {after}; /metrics.json "
        f"{len(keys)} keys [{card}]")
    _must(tag, ready0 == 200 and drain[0] == 200 and ready1 == 503
          and not body1["ready"] and new[0] == 503, "drain did not hold")
    _must(tag, code == 200 and len(res["tokens"]) == 240,
          "the in-flight request did not finish")
    _must(tag, undrain[0] == 200 and ready2 == 200 and after == 200,
          "undrain did not restore readiness")
    allowed = REF_METRICS_JSON_KEYS | REF_METRICS_JSON_OPTIONAL
    _must(tag, REF_METRICS_JSON_KEYS <= keys <= allowed,
          f"/metrics.json keys: missing "
          f"{sorted(REF_METRICS_JSON_KEYS - keys)}, extra "
          f"{sorted(keys - allowed)}")


def _lora_reqs(prompts, adapters, **kw):
    from deeplearning4j_tpu_torch.serving import Request

    return [Request(prompt=p, max_new=SURF_NEW, adapter=int(a), **kw)
            for p, a in zip(prompts, adapters)]


def _lora_run(tag, cfg, params, reqs, **kw):
    """Serve ``reqs`` on phase 8's geometry (a fresh engine); returns
    (engine, streams, launches, generated tokens/s over the run)."""
    import torch

    engine = phase8_engine(cfg, params, **kw)
    if kw.get("lora_bank") is not None:
        _must(tag, engine.n_adapters == LORA_N,
              "the LoRA probe failed on the card")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    res = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    new = sum(len(res[r.id]) - len(r.prompt) for r in reqs)
    return engine, [res[r.id] for r in reqs], read_launches(), new / wall


def _near_tie(engine, stream, j: int, adapter: int) -> float:
    """The top-2 logit gap of ``engine``'s model at stream position ``j``:
    its admission path (the bucketed prefill or the chunk windows, at the
    shapes phase 2 held) over the tokens before it, with ``adapter``."""
    import torch

    slab = engine._init_caches(1, engine.max_total, engine.device)
    lg = engine._compute_rows(slab, stream[:j], adapter=adapter)
    top2 = torch.topk(lg[0].float(), 2).values
    return float(top2[0] - top2[1])


def phase10_lora(card: str, cfg, params, total) -> None:
    """10c: a bank of 4 adapters of rank 4 from key(0), slab and paged:
    the probe passes on the card; adapter-0 streams equal a bank-free
    engine's; a mixed batch (adapters 0-3 over 8 slots) equals four
    single-adapter engines stream for stream, greedy (slab, paged) and
    T 0.8 top-k 40 (slab), but where a greedy near-tie (top-2 gap <
    NEAR_TIE) is reported; decode tok/s with and without the bank."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models.transformer import init_lora_bank
    from deeplearning4j_tpu_torch.ops import threefry

    bank = init_lora_bank(threefry.key(LORA_SEED), cfg, LORA_N, LORA_RANK)
    prompts = surface_prompts(cfg.vocab_size)[:8]
    adapters = [i % LORA_N for i in range(8)]
    for paged, sampling in ((False, {}), (True, {}),
                            (False, dict(temperature=0.8, top_k=40))):
        sampled = bool(sampling)
        mode = (f"{'paged' if paged else 'slab'}, "
                f"{'T 0.8 top-k 40' if sampled else 'greedy'}")
        tag = f"phase 10c {mode}"
        decode = "flash_decode_paged" if paged else "flash_decode"
        kw = dict(paged=paged, **sampling)
        t0 = time.perf_counter()
        eng, mixed, launches, rate = _lora_run(
            tag, cfg, params, _lora_reqs(prompts, adapters), lora_bank=bank,
            **kw)
        probe_s = time.perf_counter() - t0
        _launch_check(tag, launches, ("flash_attn_fwd", decode)
                      + (("threefry_draw",) if sampled else ()))
        _add(total, launches)
        _, base, blaunch, base_rate = _lora_run(
            f"{tag} bank-free", cfg, params, _lora_reqs(prompts, [0] * 8),
            **kw)
        _add(total, blaunch)
        _, zero, zlaunch, _ = _lora_run(
            f"{tag} adapter 0", cfg, params, _lora_reqs(prompts, [0] * 8),
            lora_bank=bank, **kw)
        _add(total, zlaunch)
        zero_same = [np.array_equal(a, b) for a, b in zip(base, zero)]
        solo, notes = {}, []
        for a in range(LORA_N):
            e, solo[a], slaunch, _ = _lora_run(
                f"{tag} adapter {a} alone", cfg, params,
                _lora_reqs(prompts, [a] * 8), lora_bank=bank, **kw)
            _add(total, slaunch)
            for i in (i for i in range(8) if adapters[i] == a):
                x, y = solo[a][i], mixed[i]
                if np.array_equal(x, y):
                    continue
                j = int(np.nonzero(x != y)[0][0])
                gap = _near_tie(e, x, j, a)
                notes.append(f"request {i} (adapter {a}) at token "
                             f"{j - len(prompts[i])}: top-2 gap {gap:.3g}")
                _must(tag, not sampled and gap < NEAR_TIE,
                      f"{notes[-1]}: not a greedy near-tie")
            del e
        same = sum(np.array_equal(solo[adapters[i]][i], mixed[i])
                   for i in range(8))
        differ = sum(not np.array_equal(mixed[i], base[i])
                     for i in range(8) if adapters[i])
        log(f"{tag}: bank {LORA_N} x rank {LORA_RANK} (key {LORA_SEED}), "
            f"probe passed, engine set-up and run {probe_s:.1f} s; adapter-0 "
            f"streams identical to the bank-free engine's "
            f"{sum(zero_same)}/8; mixed batch vs single-adapter engines "
            f"identical {same}/8{'; ' + '; '.join(notes) if notes else ''}; "
            f"adapters 1-3 off the base stream {differ}/6; "
            f"launches (mixed run) #1 {launches['flash_attn_fwd']}, "
            f"{decode} {launches[decode]}, draw {launches['threefry_draw']};"
            f" generated tok/s mixed {rate:.2f} vs bank-free {base_rate:.2f}"
            f" (host clock, 8 requests x {SURF_NEW}) [{card}]")
        _must(tag, all(zero_same), "adapter 0 is not the base model")
        _must(tag, differ > 0, "the adapters did not act")
        del eng
        torch.cuda.empty_cache()


def phase10_tenancy(card: str, cfg, params, total) -> None:
    """10d: three tenants from a JSON file: one floods (24 requests ahead
    of the others), the capped tenant (weight 2, 2 slots) and the metered
    one (a bucket of two requests) still get their share; 429 on the
    quota, 401 on an unknown key, the per-tenant series in ``/metrics``."""
    import tempfile

    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.serving import (
        RequestScheduler,
        ServingServer,
        TenantRegistry,
    )

    tag = "phase 10d"
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "tenants.json"
        path.write_text(json.dumps(TENANTS))
        tenancy = TenantRegistry.from_file(path)
    engine = phase8_engine(cfg, params, tenancy=tenancy,
                           scheduler=RequestScheduler(tenancy=tenancy))
    peak = {"capped": 0}
    seat = engine._seat

    def on_seat(pl):
        seat(pl)
        peak["capped"] = max(peak["capped"], sum(
            1 for st in engine._slots
            if st is not None and st.req.tenant_id == "capped"))

    engine._seat = on_seat
    rng = np.random.default_rng(12)
    keys = ([("k-flood", i) for i in range(24)]
            + [("k-capped", i) for i in range(6)]
            + [("k-metered", i) for i in range(3)])
    prompts = {k: rng.integers(0, cfg.vocab_size, TENANT_PROMPT).tolist()
               for k in keys}
    server = ServingServer(engine, port=0).start()
    base = "http://%s:%d" % server.address
    done_at = {}

    def call(key, i):
        req = urllib.request.Request(
            base + "/v1/generate", method="POST",
            headers={"X-API-Key": key, "Content-Type": "application/json"},
            data=json.dumps({"prompt": prompts[(key, i)],
                             "max_new": TENANT_NEW}).encode())
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                code = r.status
        except urllib.error.HTTPError as e:
            code = e.code
        done_at[(key, i)] = time.perf_counter()
        return code

    try:
        torch.cuda.synchronize()
        reset_launches()
        codes = _in_order(engine, [lambda k=k: call(*k) for k in keys])
        launches = read_launches()
        unknown = _post_status(base + "/v1/generate",
                               {"prompt": [1, 2], "max_new": 2})[0]
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            prom = r.read().decode()
    finally:
        server.stop()
    _add(total, launches)
    ok = [k for k, c in zip(keys, codes) if c == 200]
    order = sorted(ok, key=done_at.get)
    pos = {k: i / (len(order) - 1) for i, k in enumerate(order)}
    victims = [pos[k] for k in ok if k[0] != "k-flood"]
    flood = [pos[k] for k in ok if k[0] == "k-flood"]
    # FIFO would finish the 8 admitted non-flood requests last
    fifo = float(np.mean(np.arange(len(ok) - 8, len(ok)) / (len(ok) - 1)))
    series = all(f'serve_tenant_requests_total{{tenant="{t}",outcome='
                 f'"finished"}}' in prom for t in ("flood", "capped",
                                                   "metered"))
    quota = 'serve_rejections_total{reason="quota",tenant="metered"} 1' in prom
    log(f"{tag}: 24 flood, 6 capped, 3 metered requests (submitted in that "
        f"order); HTTP codes flood {codes[:24].count(200)}x200, capped "
        f"{codes[24:30]}, metered {codes[30:]}; mean completion position "
        f"(0 first, 1 last) of the capped and metered requests "
        f"{np.mean(victims):.3f} vs the flood's {np.mean(flood):.3f} (FIFO "
        f"would put them at {fifo:.3f}); the capped tenant's "
        f"peak slots {peak['capped']}; unknown key {unknown}; per-tenant "
        f"series {series}, quota rejection labelled {quota} [{card}]")
    _must(tag, codes[:30].count(200) == 30 and codes[30:] == [200, 200, 429],
          f"HTTP codes {codes}")
    _must(tag, np.mean(victims) < fifo - 0.2,
          "the flood starved its classmates")
    _must(tag, peak["capped"] == 2, f"capped peak {peak['capped']} slots")
    _must(tag, unknown == 401 and series and quota,
          "401, the per-tenant series or the quota label")


def phase10_recovery(card: str, cfg, params, total) -> None:
    """10e: sampled mixed-adapter streams (T 0.8 top-k 40) with one
    injected crash equal the uninterrupted run, and no streamed token is
    repeated (the stream queues against the results)."""
    import queue

    import numpy as np

    from deeplearning4j_tpu_torch.models.transformer import init_lora_bank
    from deeplearning4j_tpu_torch.ops import threefry
    from deeplearning4j_tpu_torch.serving import FaultInjector

    tag = "phase 10e"
    bank = init_lora_bank(threefry.key(LORA_SEED), cfg, LORA_N, LORA_RANK)
    prompts = surface_prompts(cfg.vocab_size)[:8]
    adapters = [i % LORA_N for i in range(8)]
    kw = dict(lora_bank=bank, temperature=0.8, top_k=40)
    _, ref, _, _ = _lora_run(f"{tag} uninterrupted", cfg, params,
                             _lora_reqs(prompts, adapters), **kw)
    reqs = _lora_reqs(prompts, adapters)
    for r in reqs:
        r.stream = queue.Queue()
    eng, got, launches, _ = _lora_run(
        tag, cfg, params, reqs,
        faults=FaultInjector().plan("step", LORA_CRASH, "crash"), **kw)
    _add(total, launches)
    streamed = []
    for r in reqs:
        toks = []
        while (t := r.stream.get_nowait()) is not None:
            toks.append(t)
        streamed.append(toks)
    same = [np.array_equal(a, b) for a, b in zip(ref, got)]
    tails = [s == g[len(p):].tolist()
             for s, g, p in zip(streamed, got, prompts)]
    log(f"{tag}: restarts {eng.metrics.n_restarts} (mode "
        f"{eng.last_recover_mode}); streams identical to the uninterrupted "
        f"run {sum(same)}/8; streamed tokens equal to the results' tails "
        f"(none repeated) {sum(tails)}/8 [{card}]")
    _must(tag, eng.metrics.n_restarts == 1 and all(same) and all(tails),
          "the recovered run differs or repeated a token")


def phase_front_end(card: str) -> dict[str, dict[str, int]]:
    """Phase 10: streaming, the rest of the single-engine front end,
    batched LoRA and tenancy at GPT-2-small's width (phase 3's model);
    fails on a launch at a shape phase 2 did not hold."""
    import torch

    t0 = time.perf_counter()
    cfg, params = serve_model(False)
    runs = {k: {} for k in ("stream", "lora", "tenancy", "lora_recovery")}
    with launched_shapes() as seen:
        for name, fn in (("stream", phase10_streaming),
                         ("lora", phase10_lora),
                         ("tenancy", phase10_tenancy),
                         ("lora_recovery", phase10_recovery)):
            t1 = time.perf_counter()
            fn(card, cfg, params, runs[name])
            log(f"phase 10 {name}: {time.perf_counter() - t1:.1f} s")
            if name == "stream":
                phase10_front_end(card, cfg, params)
            torch.cuda.empty_cache()
    log(f"phase 10: {time.perf_counter() - t0:.1f} s wall [{card}]")
    check_launched("phase 10", seen)
    return runs


# -- phase 11 ----------------------------------------------------------------

#: 11a: the batched group (8 prompts of one bucket, 128) and its new tokens
BATCH_N, BATCH_NEW = 8, 32
#: 11a: the batched-hit wave: a 128-token prefix (the engine's hit grain,
#: the largest bucket), cached as the branch point of two 144-token seeds
#: (rows from the chunk windows), then 8 prompts of it plus 17-32 tokens
#: of their own (one 32-row window each)
HIT_PREFIX, HIT_SEED = 128, 144
#: 11b: 24 requests into 8 slots (prompts of bucket 128, 8-40 new tokens)
WAVE_N = 24
#: 11a's sampled runs (phase 9's and 10's sampler)
SAMPLE_T, SAMPLE_K = 0.8, 40


def _bucket128_prompts(vocab: int, n: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(65, 129)))
            for _ in range(n)]


@contextlib.contextmanager
def fwd_shapes():
    """Counts kernel #1's launches by BH inside the block (the wrapper's
    launch function wrapped, its count left as it is)."""
    import collections

    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    counts = collections.Counter()
    launch = fa._launch

    def on_fwd(q, k, v, causal):
        counts[int(q.shape[0])] += 1
        return launch(q, k, v, causal)

    fa._launch = on_fwd
    try:
        yield counts
    finally:
        fa._launch = launch


def _timed_run(engine, reqs):
    """Submit ``reqs`` before one step, run to the end; returns (streams,
    launches, wall s). Every count is set to 0 just before."""
    import torch

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    res = engine.run()
    torch.cuda.synchronize()
    return ([res[r.id] for r in reqs], read_launches(),
            time.perf_counter() - t0)


def _sampled_gap(engine, stream, j: int, key, temperature: float,
                 top_k: int) -> float:
    """The perturbed top-2 gap of a sampled draw at stream position ``j``
    (the slot ``key`` folded with ``j``: the threefry Gumbel noise plus the
    filtered logits over ``temperature``), the logits by the engine's
    serial admission path over the tokens before it."""
    import torch

    from deeplearning4j_tpu_torch.models.transformer import _top_k_filter
    from deeplearning4j_tpu_torch.ops import threefry

    slab = engine._init_caches(1, engine.max_total, engine.device)
    lg = engine._compute_rows(slab, stream[:j]).float().cpu()
    scaled = _top_k_filter(lg, top_k)[0] / temperature
    rk = threefry.fold_in_rows(torch.tensor([list(key)]),
                               torch.tensor([j]))
    g = threefry.gumbel_from_bits(threefry.random_bits_rows(
        rk, lg.shape[1]))[0]
    top2 = torch.topk(g + scaled, 2).values
    return float(top2[0] - top2[1])


def _against(tag, engine, ref, got, prompts, sampled, keys, verdict):
    """Streams of a batched engine against serial admission's: identical
    (required where the probe passed), else at the first divergence a
    near-tie (greedy top-2 logit gap, sampled perturbed top-2 gap, below
    NEAR_TIE), reported."""
    import numpy as np

    notes = []
    for i, (a, b) in enumerate(zip(ref, got)):
        if np.array_equal(a, b):
            continue
        _must(tag, not verdict, f"request {i} differs where the probe "
              f"passed")
        j = int(np.nonzero(a != b)[0][0])
        if sampled:
            gap = _sampled_gap(engine, a, j, keys[i], SAMPLE_T, SAMPLE_K)
        else:
            gap = _near_tie(engine, a, j, 0)
        notes.append(f"request {i} at token {j - len(prompts[i])}: gap "
                     f"{gap:.3g}")
        _must(tag, gap < NEAR_TIE, f"{notes[-1]}: not a near-tie")
    same = sum(np.array_equal(a, b) for a, b in zip(ref, got))
    return same, notes


def phase11_batch(card: str, cfg, params, total) -> None:
    """11a: 8 prompts of one bucket (128) submitted before one step, on
    engines with batch_admission False, "auto" and True, greedy and T 0.8
    top-k 40: the probe's verdict, prefill dispatches (8 against 1), #1's
    launches at BH 48, the group's TTFT against serial admission, streams
    against serial; then 8 prompts behind one cached 128-token prefix
    through the batched hit program (cache off against on)."""
    import numpy as np

    from deeplearning4j_tpu_torch.ops import threefry
    from deeplearning4j_tpu_torch.serving import Request

    prompts = _bucket128_prompts(cfg.vocab_size, BATCH_N, 21)
    sk, keys = threefry.key(0), []
    for _ in prompts:
        sk, sub = threefry.split(sk)
        keys.append(sub)
    for sampled in (False, True):
        kw = (dict(temperature=SAMPLE_T, top_k=SAMPLE_K) if sampled
              else {})
        mode = "T 0.8 top-k 40" if sampled else "greedy"
        runs = {}
        for batch in (False, "auto", True):
            tag = f"phase 11a {mode}, batch_admission={batch}"
            eng = phase8_engine(cfg, params, batch_admission=batch, **kw)
            with fwd_shapes() as bh:
                streams, launches, wall = _timed_run(
                    eng, [Request(prompt=p, max_new=BATCH_NEW)
                          for p in prompts])
            _launch_check(tag, launches, ("flash_attn_fwd", "flash_decode")
                          + (("threefry_draw",) if sampled else ()))
            _add(total, launches)
            s = eng.metrics.summary()
            runs[batch] = (eng, streams, s, dict(bh))
            log(f"{tag}: probe {eng.batch_verdicts}; prefill dispatches "
                f"{eng.prefill_dispatches}, batched admissions "
                f"{eng.metrics.n_batched_admissions}; #1 launches by BH "
                f"{dict(sorted(bh.items()))}; TTFT p50 "
                f"{s['ttft_p50_s'] * 1e3:.2f} ms p99 "
                f"{s['ttft_p99_s'] * 1e3:.2f} ms; {wall:.3f} s [{card}]")
        verdict = runs["auto"][0].batch_verdicts.get(("miss", 128, 8))
        ser = runs[False]
        _must(f"phase 11a {mode}", ser[0].prefill_dispatches == BATCH_N
              and runs[True][0].prefill_dispatches == 1
              and runs[True][3].get(48, 0) == cfg.n_layers,
              "serial took 8 dispatches and the forced group 1, with #1 "
              "at BH 48 once a layer")
        for batch in ("auto", True):
            eng, streams = runs[batch][0], runs[batch][1]
            same, notes = _against(f"phase 11a {mode} {batch}", ser[0],
                                   ser[1], streams, prompts, sampled, keys,
                                   verdict)
            log(f"phase 11a {mode}, batch_admission={batch}: streams "
                f"identical to serial admission {same}/{BATCH_N}"
                f"{'; ' + '; '.join(notes) if notes else ''}; TTFT p50 "
                f"{runs[batch][2]['ttft_p50_s'] * 1e3:.2f} vs serial "
                f"{ser[2]['ttft_p50_s'] * 1e3:.2f} ms, p99 "
                f"{runs[batch][2]['ttft_p99_s'] * 1e3:.2f} vs "
                f"{ser[2]['ttft_p99_s'] * 1e3:.2f} ms [{card}]")
        if verdict:
            _must("phase 11a", runs["auto"][0].prefill_dispatches == 1,
                  "the probe passed but the group did not batch")
        del runs
    # the batched hit program: a seed caches the 128-token prefix, then 8
    # prompts extend it by 17-32 tokens
    rng = np.random.default_rng(22)
    prefix = rng.integers(0, cfg.vocab_size, HIT_PREFIX)
    seeds = [np.concatenate([prefix, rng.integers(
        0, cfg.vocab_size, HIT_SEED - HIT_PREFIX)]) for _ in range(2)]
    exts = [np.concatenate([prefix, rng.integers(
        0, cfg.vocab_size, int(rng.integers(17, 33)))]) for _ in range(8)]
    out, engines = {}, {}
    for cache, batch in ((False, "auto"), (True, "auto"), (True, True)):
        tag = (f"phase 11a hits, prefix cache {'on' if cache else 'off'}, "
               f"batch_admission={batch}")
        eng = phase8_engine(cfg, params, prefix_cache=cache,
                            batch_admission=batch)
        for seed in seeds:
            eng.submit(Request(prompt=seed, max_new=4))
            eng.run()
        before = eng.prefill_dispatches
        streams, launches, wall = _timed_run(
            eng, [Request(prompt=p, max_new=BATCH_NEW) for p in exts])
        _add(total, launches)
        m = eng.metrics
        out[cache, batch], engines[cache, batch] = streams, eng
        log(f"{tag}: probe batch {eng.batch_verdicts} prefix "
            f"{eng._prefix_ok_memo}; prefill dispatches "
            f"{eng.prefill_dispatches - before} for 8 prompts; partial hits "
            f"{m.n_prefix_hits_partial}, tokens saved "
            f"{m.prefix_tokens_saved}, batched admissions "
            f"{m.n_batched_admissions}; TTFT p50 "
            f"{m.summary()['ttft_p50_s'] * 1e3:.2f} ms; {wall:.3f} s "
            f"[{card}]")
        if cache:
            _must(tag, m.n_prefix_hits_partial == 8
                  and m.prefix_tokens_saved == 8 * HIT_PREFIX,
                  "the 8 prompts did not hit the cached prefix")
            if batch is True or eng.batch_verdicts.get(("hit", 32, 8)):
                _must(tag, eng.prefill_dispatches - before == 1,
                      "the hits did not share one dispatch")
    verdict = engines[True, "auto"].batch_verdicts.get(("hit", 32, 8))
    for batch in ("auto", True):
        same, notes = _against(
            f"phase 11a hits {batch}", engines[False, "auto"],
            out[False, "auto"], out[True, batch], exts, False, None,
            verdict or batch == "auto")
        log(f"phase 11a hits, batch_admission={batch}: streams identical "
            f"cache on vs off {same}/8"
            f"{'; ' + '; '.join(notes) if notes else ''} [{card}]")


def _stepped(engine, reqs):
    """Submit ``reqs`` together and step to the end, counting the
    horizons dispatched at each K; returns (streams, {K: horizons},
    generated tok/s, host clock)."""
    import collections

    import torch

    torch.cuda.synchronize()
    reset_launches()
    ks = collections.Counter()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    while not engine.idle:
        n = engine.metrics._step
        engine.step()
        if engine.metrics._step > n:
            ks[engine.decode_horizon_current] += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = engine.results
    new = sum(len(res[r.id]) - len(r.prompt) for r in reqs)
    return [res[r.id] for r in reqs], dict(ks), new / wall


def phase11_horizon(card: str, cfg, params, total) -> None:
    """11b: 24 requests into 8 slots at K 4, the adaptive horizon on and
    off: identical streams, horizons dispatched at K 1 and K 4, the second
    wave's TTFT p50 (the 16 requests that waited for a slot) and tok/s."""
    import numpy as np

    from deeplearning4j_tpu_torch.serving import Request

    prompts = _bucket128_prompts(cfg.vocab_size, WAVE_N, 23)
    news = np.random.default_rng(24).integers(8, 41, WAVE_N)
    out = {}
    for adaptive in (False, True):
        tag = f"phase 11b adaptive_horizon={adaptive}"
        eng = phase8_engine(cfg, params, adaptive_horizon=adaptive)
        reqs = [Request(prompt=p, max_new=int(n))
                for p, n in zip(prompts, news)]
        streams, ks, rate = _stepped(eng, reqs)
        _add(total, read_launches())
        second = [r.timing["ttft_s"] for r in reqs[8:]]
        out[adaptive] = streams
        log(f"{tag}: horizons by K {dict(sorted(ks.items()))}; second "
            f"wave TTFT p50 {np.percentile(second, 50) * 1e3:.2f} ms p99 "
            f"{np.percentile(second, 99) * 1e3:.2f} ms; generated "
            f"{rate:.1f} tok/s (host clock); engine K now "
            f"{eng.decode_horizon_current} [{card}]")
        if adaptive:
            _must(tag, ks.get(1, 0) > 0 and ks.get(4, 0) > 0
                  and eng.decode_horizon_current == 4,
                  "the horizon did not shrink and restore")
        else:
            _must(tag, set(ks) == {4}, "a fixed horizon moved")
    same = sum(np.array_equal(a, b) for a, b in zip(out[False], out[True]))
    log(f"phase 11b: streams identical adaptive vs fixed {same}/{WAVE_N} "
        f"[{card}]")
    _must("phase 11b", same == WAVE_N, "the adaptive horizon changed a "
          "stream")


def phase11_probes(card: str, cfg, params, total) -> None:
    """11c: two engines on one probe_cache file, each configuration
    serving the same small traffic: the first runs its probes, the second
    runs none (every verdict read) and serves the same streams;
    construction seconds of both."""
    import tempfile

    import numpy as np

    from deeplearning4j_tpu_torch.models.transformer import init_lora_bank
    from deeplearning4j_tpu_torch.ops import threefry
    from deeplearning4j_tpu_torch.serving import FaultInjector, Request

    bank = init_lora_bank(threefry.key(LORA_SEED), cfg, LORA_N, LORA_RANK)
    configs = {
        "slab (prefix cache, surface, LoRA, a crash)": dict(
            prefix_cache=True, sampling_surface=True, lora_bank=bank),
        "paged bs 8": dict(paged=True),
    }
    rng = np.random.default_rng(25)
    a = rng.integers(0, cfg.vocab_size, HIT_SEED)
    traffic = ([rng.integers(0, cfg.vocab_size, 40) for _ in range(2)]
               + [a] + [np.concatenate([a[:HIT_PREFIX], rng.integers(
                   0, cfg.vocab_size, 20)]) for _ in range(3)])
    with tempfile.TemporaryDirectory() as tmp:
        for n, (name, kw) in enumerate(configs.items()):
            path = str(Path(tmp) / f"probes-{n}.json")
            got = []
            for i in range(2):
                tag = f"phase 11c {name}, engine {i + 1}"
                faults = (FaultInjector().plan("step", 3, "crash")
                          if "crash" in name else None)
                t0 = time.perf_counter()
                eng = phase8_engine(cfg, params, probe_cache=path,
                                    faults=faults, **kw)
                ctor = time.perf_counter() - t0
                built = list(eng.probes_run)
                streams = []
                t1 = time.perf_counter()
                for wave in (traffic[:3], traffic[3:]):
                    out, launches, _ = _timed_run(
                        eng, [Request(prompt=p, max_new=16) for p in wave])
                    streams += out
                    _add(total, launches)
                wall = time.perf_counter() - t1
                got.append(streams)
                log(f"{tag}: construction {ctor:.3f} s (probes run "
                    f"{built}); serving {wall:.3f} s (restarts "
                    f"{eng.metrics.n_restarts}, partial hits "
                    f"{eng.metrics.n_prefix_hits_partial}); probes run "
                    f"{eng.probes_run}, read from the file "
                    f"{eng.probes_from_cache} [{card}]")
                if i:
                    _must(tag, eng.probes_run == []
                          and eng.probes_from_cache, "a probe ran again")
                elif faults is not None:
                    _must(tag, {"prefix_reuse", "batch_admission",
                                "chunked_replay"} <= set(eng.probes_run),
                          "a lazy probe never ran")
            same = all(np.array_equal(x, y) for x, y in zip(*got))
            _must(f"phase 11c {name}", same, "the cached engine's streams "
                  "differ")


def phase11_observability(card: str, cfg, params, total, workdir) -> None:
    """11d: a traced run (export parses, every track has its spans) and
    the same run untraced (same streams, 0 events); the attribution
    families in /metrics; a ServingServer with flight_dir under an
    injected crash (a dump written, /debug/dump 200 and redacted); POST
    /profile?s=2 writes a torch.profiler trace naming #1's and #3's
    symbols; trace-merge of two exports."""
    import numpy as np

    from deeplearning4j_tpu_torch import cli
    from deeplearning4j_tpu_torch.obs import ProfileTrigger, Tracer, redact
    from deeplearning4j_tpu_torch.serving import (
        FaultInjector,
        Request,
        ServingServer,
    )

    tag = "phase 11d"
    prompts = surface_prompts(cfg.vocab_size)[:8]
    runs = {}
    for traced in (True, False):
        tracer = Tracer(enabled=traced, process_name="serve traced")
        eng = phase8_engine(cfg, params, tracer=tracer)
        streams, launches, wall = _timed_run(
            eng, [Request(prompt=p, max_new=SURF_NEW) for p in prompts])
        _add(total, launches)
        runs[traced] = (eng, tracer, streams, wall)
    eng, tracer, streams, wall = runs[True]
    path = tracer.export(workdir / "trace-a.json")
    doc = json.loads(path.read_text())
    names = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    spans = {}
    for e in doc["traceEvents"]:
        if e["ph"] != "M":
            spans.setdefault(names[e["tid"]], set()).add(e["name"])
    slots = [t for t in names.values() if t.startswith("slot-")]
    ok = ({"step", "dispatch", "sync"} <= spans.get("engine", set())
          and {"queued", "submit"} <= spans.get("scheduler", set())
          and len(slots) == 8 and all(
              {"prefill", "decode", "first_token", "finished"}
              <= spans[t] for t in slots))
    same = all(np.array_equal(a, b)
               for a, b in zip(streams, runs[False][2]))
    new = len(prompts) * SURF_NEW
    log(f"{tag}: traced run {tracer.n_events} events ({tracer.dropped} "
        f"dropped), tracks {sorted(spans)}; {new / wall:.1f} tok/s traced vs "
        f"{new / runs[False][3]:.1f} untraced (host clock); untraced "
        f"tracer {runs[False][1].n_events} events; streams identical "
        f"{same} [{card}]")
    _must(tag, ok and same and runs[False][1].n_events == 0,
          f"tracks/spans {spans}, streams or the untraced buffer")
    prom = eng.metrics.render_prometheus()
    fams = eng.metrics.summary()["program_seconds"]
    log(f"{tag}: attribution (dispatch to proving readback, s) "
        f"{ {k: round(v, 6) for k, v in fams.items()} }, dispatches "
        f"{eng.metrics.summary()['program_dispatches']} [{card}]")
    _must(tag, all(f'serve_program_seconds_total{{family="{f}"}}' in prom
                   for f in fams) and {"step"} <= set(fams),
          "the attribution families are not in /metrics")
    del runs
    # flight recorder under a crash, /debug/dump, /profile
    flight = workdir / "flight"
    eng = phase8_engine(cfg, params,
                        faults=FaultInjector().plan("step", 3, "crash"),
                        profile=ProfileTrigger(log_dir=workdir / "prof"),
                        tracer=Tracer(enabled=True,
                                      process_name="serve server"))
    server = ServingServer(eng, port=0, flight_dir=str(flight)).start()
    base = "http://%s:%d" % server.address
    try:
        torch_sync()
        reset_launches()
        code, out = _post_status(base + "/v1/generate",
                                 {"prompt": prompts[0].tolist(),
                                  "max_new": SURF_NEW})
        dumps = sorted(flight.glob("flight-*-engine_crash-*.json"))
        with urllib.request.urlopen(base + "/debug/dump", timeout=60) as r:
            dcode, bundle = r.status, json.loads(r.read())
        pcode, armed = _post_status(base + "/profile?s=2", {})
        twice = _post_status(base + "/profile?s=1", {})[0]
        gcode, _ = _post_status(base + "/v1/generate",
                                {"prompt": prompts[1].tolist(),
                                 "max_new": 8})
        deadline = time.monotonic() + 60
        while eng.profile.armed and time.monotonic() < deadline:
            time.sleep(0.01)
        torch_sync()
        _add(total, read_launches())
    finally:
        server.stop()
    crash = (json.loads(dumps[0].read_text()) if dumps else {})
    last_fault = [e for e in crash.get("events", ())
                  if e["kind"] == "fault"][-1:]
    log(f"{tag}: server under a crash: generate {code}, restarts "
        f"{eng.metrics.n_restarts}, flight dumps {[p.name for p in dumps]} "
        f"(last fault {last_fault}); /debug/dump {dcode} with "
        f"{bundle.get('n_events')} events, redacted "
        f"{redact(bundle) == bundle} [{card}]")
    _must(tag, code == 200 and len(dumps) == 1 and dcode == 200
          and last_fault and last_fault[0]["fault"] == "crash"
          and redact(bundle) == bundle and bundle["reason"] == "debug_dump",
          "the flight dump or /debug/dump")
    trace = eng.profile.last_capture_dir / "trace.json"
    kernels = set()
    if trace.exists():
        kernels = {e["name"] for e in json.loads(trace.read_text())[
            "traceEvents"] if e.get("cat") == "kernel"}
    # demangled names, e.g. "void (anonymous namespace)::tc::
    # flash_fwd_wgmma_kernel<128>(CUtensorMap_st, ...)"
    want = {"flash_fwd_wgmma_kernel", "flash_decode_split_kernel"}
    found = {w for w in want if any(w in k for k in kernels)}
    log(f"{tag}: POST /profile?s=2 {pcode} ({armed.get('dir')}), again "
        f"{twice}; the capture names {sorted(found)} among "
        f"{len(kernels)} CUDA kernels [{card}]")
    _must(tag, pcode == 200 and twice == 409 and gcode == 200
          and found == want, f"the capture misses {want - found}")
    # trace-merge of the two engines' exports
    eng.tracer.export(workdir / "trace-b.json")
    merged = workdir / "merged.json"
    rc = cli.main(["trace-merge", str(workdir / "trace-a.json"),
                   str(workdir / "trace-b.json"), "-o", str(merged)])
    mdoc = json.loads(merged.read_text())
    pids = {e["pid"] for e in mdoc["traceEvents"]}
    log(f"{tag}: trace-merge rc {rc}, {len(pids)} process tracks, "
        f"{len(mdoc['traceEvents'])} events [{card}]")
    _must(tag, rc == 0 and pids == {1, 2}, "trace-merge")


def torch_sync() -> None:
    import torch

    torch.cuda.synchronize()


def phase11_embeddings(card: str, cfg, params, total) -> None:
    """11e: serve's demo word2vec (drawn on the card, served from a host
    copy) through /v1/embeddings: every known word's vector equals the
    port's CPU model's, an unknown word is null, 400 on an empty
    ``words``, 503 on an engine without models; embedding requests
    interleaved with generation leave the generated streams
    byte-identical."""
    import numpy as np

    from deeplearning4j_tpu_torch import cli
    from deeplearning4j_tpu_torch.serving import Request, ServingServer
    from deeplearning4j_tpu_torch.serving.scheduler import EmbeddingRequest

    tag = "phase 11e"
    t0 = time.perf_counter()
    emb = cli._demo_embedders(["word2vec"])
    build_s = time.perf_counter() - t0
    cpu = cli._demo_embedders(["word2vec"], device="cpu")["word2vec"]
    words = [cpu.cache.index_to_word[i] for i in range(len(cpu.cache))]
    eng = phase8_engine(cfg, params, embedders=emb)
    server = ServingServer(eng, port=0).start()
    try:
        base = "http://%s:%d" % server.address
        code, out = _post_status(base + "/v1/embeddings",
                                 {"words": words + ["zebra"]})
        empty = _post_status(base + "/v1/embeddings", {"words": []})[0]
    finally:
        server.stop()
    bare = ServingServer(phase8_engine(cfg, params), port=0).start()
    try:
        none = _post_status("http://%s:%d/v1/embeddings" % bare.address,
                            {"words": ["fox"]})[0]
    finally:
        bare.stop()
    vec = out.get("vectors", {})
    equal = sum(np.array_equal(np.asarray(vec.get(w), np.float32),
                               cpu.get_word_vector(w)) for w in words)
    prompts = surface_prompts(cfg.vocab_size)[:8]
    got = {}
    for mixed in (False, True):
        e = phase8_engine(cfg, params, embedders=emb)
        gen, extra = [], []
        torch_sync()
        reset_launches()
        for i, p in enumerate(prompts):
            gen.append(Request(prompt=p, max_new=SURF_NEW))
            e.submit(gen[-1])
            if mixed:
                extra.append(EmbeddingRequest(words=(words[i], "zebra")))
                e.submit(extra[-1])
        res = e.run()
        torch_sync()
        _add(total, read_launches())
        got[mixed] = [res[r.id] for r in gen]
        _must(tag, all(x.status.value == "finished" for x in extra),
              "an embedding request did not finish")
    same = sum(np.array_equal(a, b) for a, b in zip(got[False], got[True]))
    log(f"{tag}: demo word2vec drawn on the card in {build_s:.3f} s; POST "
        f"/v1/embeddings {code}: {equal}/{len(words)} vectors bitwise the "
        f"CPU model's, unknown word {vec.get('zebra', 'missing')}; empty "
        f"words {empty}; engine without models {none}; generate streams "
        f"with interleaved embeddings identical {same}/8 [{card}]")
    _must(tag, code == 200 and equal == len(words)
          and vec.get("zebra", 0) is None and empty == 400 and none == 503
          and same == 8, "the embeddings endpoint")


def phase_single_engine(card: str, workdir: Path) -> dict[str, dict[str, int]]:
    """Phase 11: batched admission, the adaptive horizon, persisted probe
    verdicts, the observability layer and embeddings at GPT-2-small's
    width (phase 3's model, 8 slots, max_total 640, K 4); fails on a
    launch at a shape phase 2 did not hold."""
    import torch

    t0 = time.perf_counter()
    cfg, params = serve_model(False)
    workdir.mkdir(parents=True, exist_ok=True)
    runs = {k: {} for k in ("batch", "horizon", "probes", "observability",
                            "embeddings")}
    with launched_shapes() as seen:
        for name, fn in (("batch", phase11_batch),
                         ("horizon", phase11_horizon),
                         ("probes", phase11_probes),
                         ("embeddings", phase11_embeddings)):
            t1 = time.perf_counter()
            fn(card, cfg, params, runs[name])
            log(f"phase 11 {name}: {time.perf_counter() - t1:.1f} s")
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        phase11_observability(card, cfg, params, runs["observability"],
                              workdir)
        log(f"phase 11 observability: {time.perf_counter() - t1:.1f} s")
    log(f"phase 11: {time.perf_counter() - t0:.1f} s wall [{card}]")
    check_launched("phase 11", seen)
    return runs


# -- phase 12 ----------------------------------------------------------------

#: 12a: exported prompt lengths (128, the hit grain, through #1's bucketed
#: prefill; the rest past it, through the chunk windows), new tokens, seed
WIRE_LENGTHS, WIRE_NEW = (128, 160, 224, 300, 400), 24
#: 12b-12e: the controller's threshold (at least the port's hit grain, the
#: largest prefill bucket: a shorter segment is not seatable), new tokens
DISAGG_THRESHOLD, FLEET_NEW = 128, 16
#: 12d: new tokens a migrated request, and the source's throttle a step
#: check (so /migrate lands while the requests decode)
MIGRATE_NEW, MIGRATE_DELAY_S = 64, 0.03


def _wire_prompts(vocab: int, lengths, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lengths]


def _wire_frame(res: dict, gen=None) -> bytes:
    from deeplearning4j_tpu_torch.serving.disagg import encode_segment

    return encode_segment(config_hash=res["config_hash"],
                          tokens=res["tokens"], leaves=res["leaves"],
                          logits=res["logits"], layout=res["layout"],
                          block_size=res["block_size"], gen=gen)


def _counted(total: dict[str, int], fn):
    """``fn()`` with every count set to 0 just before and read just after
    (added to ``total``); returns (its result, the launches)."""
    torch_sync()
    reset_launches()
    out = fn()
    torch_sync()
    launches = read_launches()
    _add(total, launches)
    return out, launches


def _served(engine, reqs):
    """Submit ``reqs`` and run the engine to idle; their streams."""
    for r in reqs:
        engine.submit(r)
    res = engine.run()
    return [res.get(r.id) for r in reqs]


def phase12_wire(card: str, models, total) -> None:
    """12a: prompts exported by a prefill engine, framed, decoded and
    ingested by a decode engine with the prefix cache; the follow-up
    generates full-hit (0 prefill dispatches, kernel #1 silent there) with
    the streams of a monolithic engine, greedy and T 0.8 top-k 40, in bf16
    slab, bf16 paged (bs 8) and int8 full; the disagg probe's verdict, the
    frame bytes and the encode, decode and ingest seconds per mode."""
    import numpy as np

    from deeplearning4j_tpu_torch.serving import (
        KVExportRequest,
        KVIngestRequest,
        Request,
    )
    from deeplearning4j_tpu_torch.serving.disagg import decode_segment

    tag = "phase 12a"
    for mode in ("bf16 slab", "bf16 paged", "int8 full"):
        cfg, params = models[mode == "int8 full"]
        paged = mode == "bf16 paged"
        decode_kernel = ("flash_decode_paged" if paged else
                         "flash_decode_int8" if cfg.decode_int8
                         else "flash_decode")
        prompts = _wire_prompts(cfg.vocab_size, WIRE_LENGTHS, 12)
        pf = phase8_engine(cfg, params, paged=paged)
        exports = [KVExportRequest(prompt=p) for p in prompts]
        t0 = time.perf_counter()
        _, pf_l = _counted(total, lambda: _served(pf, exports))
        export_s = time.perf_counter() - t0
        _must(tag, all(r.status.value == "finished" for r in exports),
              f"{mode}: an export failed: {[r.error for r in exports]}")
        _must(tag, pf_l["flash_attn_fwd"] > 0,
              f"{mode}: the 128-token export never ran kernel #1")
        t0 = time.perf_counter()
        frames = [_wire_frame(r.result) for r in exports]
        encode_s = time.perf_counter() - t0
        verdict = {"prefill": pf._disagg_ok()}
        del pf
        notes = []
        for temp in (0.0, SAMPLE_T):
            kw = dict(temperature=temp, top_k=SAMPLE_K if temp else None,
                      rng_seed=12, paged=paged)
            dc = phase8_engine(cfg, params, prefix_cache=True, **kw)
            mono = phase8_engine(cfg, params, **kw)
            t0 = time.perf_counter()
            segs = [decode_segment(f, expect_hash=dc.config_hash)
                    for f in frames]
            decode_s = time.perf_counter() - t0
            ingests = [KVIngestRequest(segment=s) for s in segs]
            t0 = time.perf_counter()
            _counted(total, lambda: _served(dc, ingests))
            ingest_s = time.perf_counter() - t0
            verdict["decode"] = dc._disagg_ok()
            _must(tag, verdict["decode"] or mode != "bf16 slab",
                  "the disagg probe declines in bf16 slab (the seat is a "
                  "copy of the exported bytes)")
            _must(tag, all(r.result["stored"] for r in ingests),
                  f"{mode}: an ingest declined: "
                  f"{[r.result['reason'] for r in ingests]}")
            gens = [Request(prompt=p, max_new=WIRE_NEW) for p in prompts]
            got, dc_l = _counted(total, lambda: _served(dc, gens))
            _launch_check(f"{tag} {mode} T {temp} decode side", dc_l,
                          [decode_kernel] + (["threefry_draw"] if temp
                                             else []),
                          ["flash_attn_fwd"])
            _must(tag, dc.prefill_dispatches == 0,
                  f"{mode}: {dc.prefill_dispatches} prefill dispatches on "
                  f"the decode side")
            refs = [Request(prompt=p, max_new=WIRE_NEW) for p in prompts]
            ref, _ = _counted(total, lambda: _served(mono, refs))
            same = sum(np.array_equal(a, b) for a, b in zip(ref, got))
            notes.append(f"T {temp}: {same}/{len(prompts)} streams "
                         f"byte-identical to the monolithic engine's")
            _must(tag, same == len(prompts),
                  f"{mode} T {temp}: transfer streams left the monolithic "
                  f"ones")
            del dc, mono
        n = len(frames)
        log(f"{tag} {mode}: disagg probe {verdict}; {n} frames of "
            f"{len(frames[0])} bytes (prompts {list(WIRE_LENGTHS)}); "
            f"export {export_s:.4f} s (prefill + host copy), encode "
            f"{encode_s / n:.4f} s, decode {decode_s / n:.4f} s a frame, "
            f"ingest {ingest_s:.4f} s for {n}; 0 prefill dispatches on the "
            f"decode side; {'; '.join(notes)} [{card}]")
        import torch

        torch.cuda.empty_cache()


def _fleet_post(addr, path: str, body: dict, timeout: float = 120.0,
                headers=None):
    """POST JSON; (status, answer, X-Served-By, wall s)."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection(*addr, timeout=timeout)
    try:
        conn.request("POST", path, body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        r = conn.getresponse()
        raw = r.read()
        try:
            out = json.loads(raw)
        except ValueError:
            out = {"raw": raw[:200].decode("latin-1")}
        return (r.status, out, r.getheader("X-Served-By"),
                time.perf_counter() - t0)
    finally:
        conn.close()


def _prom_value(text: str, series: str) -> float:
    for line in text.splitlines():
        if line.startswith(series + " "):
            return float(line.split()[-1])
    return float("nan")


def _metrics_text(srv) -> str:
    base = "http://%s:%d" % srv.address
    with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
        return r.read().decode()


def _wait_health(ctl, name: str, timeout: float = 30.0) -> None:
    t0 = time.monotonic()
    while ctl._member(name).last_health is None:
        _must("phase 12", time.monotonic() - t0 < timeout,
              f"no health poll of {name}")
        time.sleep(0.02)


def phase12_fleet(card: str, cfg, params, total) -> None:
    """12b: one controller over a prefill and a decode ``ServingServer``
    beside a monolithic one (disagg threshold 128): long prompts take the
    transfer (0 prefill dispatches on the decode replica) with the
    monolithic server's tokens, a session follow-up sticks, the fleet and
    wire counters, and the caller's TTFT through the transfer against
    local prefill (measured only; the servers share one card). 12e: a KV
    push through a chaos proxy that corrupts (the receiver's HTTP layer
    refuses it, nothing seated) and one that truncates the answer
    (``pushed: false``) fail clean within the deadline; frames cut in half
    or with flipped header bytes are 400s; a controller whose decode
    member sits behind the proxy falls back with the monolithic tokens.
    12f: the merged trace chains controller dispatch -> export prefill ->
    transfer -> kv_ingest under one trace id."""
    import collections
    import http.client
    import threading

    import numpy as np

    from deeplearning4j_tpu_torch.obs import Tracer, merge_traces
    from deeplearning4j_tpu_torch.obs.trace import (
        format_traceparent,
        new_span_id,
        new_trace_id,
    )
    from deeplearning4j_tpu_torch.serving import (
        ChaosProxy,
        FleetController,
        KVExportRequest,
        ServingServer,
    )

    tag = "phase 12b"
    tr = {k: Tracer(process_name=k) for k in ("prefill", "decode",
                                              "controller")}
    pf = ServingServer(phase8_engine(cfg, params, tracer=tr["prefill"]),
                       port=0).start()
    dc_eng = phase8_engine(cfg, params, prefix_cache=True,
                           tracer=tr["decode"])
    dc = ServingServer(dc_eng, port=0).start()
    mono = ServingServer(phase8_engine(cfg, params), port=0).start()
    ctl = ctl2 = proxy = None
    torch_sync()
    reset_launches()
    try:
        ctl = FleetController(
            [pf.address + ("prefill",), dc.address + ("decode",)],
            disagg_threshold=DISAGG_THRESHOLD, affinity_min_match=16,
            health_interval_s=0.2, tracer=tr["controller"]).start()
        prompts = _wire_prompts(cfg.vocab_size, (160, 257, 300), 13)
        ttft = {"transfer": [], "local": []}
        trace_ids = [new_trace_id() for _ in prompts]
        for i, p in enumerate(prompts):
            body = {"prompt": p.tolist(), "max_new": FLEET_NEW}
            st, out, served, wall = _fleet_post(
                ctl.address, "/v1/generate", {**body, "session": f"s{i}"},
                headers={"traceparent": format_traceparent(
                    trace_ids[i], new_span_id())})
            _must(tag, st == 200 and served == dc.name,
                  f"generate through the controller: {st} {served} {out}")
            st2, ref, _, wall2 = _fleet_post(mono.address, "/v1/generate",
                                             body)
            _must(tag, st2 == 200 and out["tokens"] == ref["tokens"],
                  f"prompt {i}: the transfer's tokens left the monolithic "
                  f"server's")
            ttft["transfer"].append(wall - out["timing"]["decode_s"])
            ttft["local"].append(wall2 - ref["timing"]["decode_s"])
        _must(tag, dc_eng.prefill_dispatches == 0,
              f"{dc_eng.prefill_dispatches} prefill dispatches on the "
              f"decode replica")
        st, _, served, _ = _fleet_post(
            ctl.address, "/v1/generate",
            {"prompt": prompts[0][:32].tolist(), "max_new": 4,
             "session": "s0"})
        _must(tag, st == 200 and served == dc.name, "the session follow-up "
              "left its replica")
        prom = ctl.registry.render()
        ptext, dtext = _metrics_text(pf), _metrics_text(dc)
        counters = {
            "fleet_disagg_total": _prom_value(prom, "fleet_disagg_total"),
            "fleet_sticky_total": _prom_value(prom, "fleet_sticky_total"),
            "fleet_transfer_fallback_total": _prom_value(
                prom, "fleet_transfer_fallback_total"),
            'serve_transfers_total{result="ok"}': _prom_value(
                ptext, 'serve_transfers_total{result="ok"}'),
            'serve_kv_ingests_total{result="stored"}': _prom_value(
                dtext, 'serve_kv_ingests_total{result="stored"}'),
        }
        want = {"fleet_disagg_total": 3, "fleet_sticky_total": 1,
                "fleet_transfer_fallback_total": 0,
                'serve_transfers_total{result="ok"}': 3,
                'serve_kv_ingests_total{result="stored"}': 3}
        _must(tag, counters == want, f"counters {counters}, want {want}")
        med = {k: float(np.median(v)) * 1e3 for k, v in ttft.items()}
        log(f"{tag}: 3 long prompts ({[len(p) for p in prompts]} tokens) "
            f"through the transfer, tokens equal to the monolithic "
            f"server's, 0 prefill dispatches on the decode replica, the "
            f"follow-up sticky; {counters}; caller TTFT p50 (wall - "
            f"decode_s) transfer {med['transfer']:.2f} ms against local "
            f"prefill {med['local']:.2f} ms (every value: "
            f"{[round(x * 1e3, 2) for x in ttft['transfer']]} / "
            f"{[round(x * 1e3, 2) for x in ttft['local']]}; the servers "
            f"share one card and its default stream) [{card}]")

        tag = "phase 12e"
        proxy = ChaosProxy(dc.address, seed=12)
        ctl2 = FleetController(
            [pf.address + ("prefill",), ("127.0.0.1", proxy.port, "decode")],
            disagg_threshold=DISAGG_THRESHOLD, health_interval_s=600.0
        ).start()
        _wait_health(ctl2, proxy.address)
        deadline = {"X-Deadline-Ms": "20000"}
        notes = []
        for j, fault in enumerate(("corrupt", "truncate")):
            p = _wire_prompts(cfg.vocab_size, (200,), 20 + j)[0].tolist()
            stored0 = dc_eng.metrics.n_kv_ingests_stored
            proxy.plan(fault, at=proxy.n_connections)
            st, out, _, wall = _fleet_post(
                pf.address, "/v1/prefill",
                {"prompt": p, "push_to": proxy.address}, headers=deadline)
            _must(tag, st == 200 and out.get("pushed") is False
                  and wall < 20.0, f"{fault}: {st} {out} in {wall:.2f} s")
            err = out.get("ingest", {}).get("error", "")
            if fault == "corrupt":
                # the mangled head gets an HTTP error or a closed
                # connection, never a seat
                _must(tag, bool(err)
                      and dc_eng.metrics.n_kv_ingests_stored == stored0,
                      f"corrupt push not refused: {err}")
            proxy.plan(fault, at=proxy.n_connections)
            st, gen, served, wall2 = _fleet_post(
                ctl2.address, "/v1/generate",
                {"prompt": p, "max_new": FLEET_NEW}, headers=deadline)
            st2, ref, _, _ = _fleet_post(mono.address, "/v1/generate",
                                         {"prompt": p, "max_new": FLEET_NEW})
            _must(tag, st == 200 and gen["tokens"] == ref["tokens"]
                  and wall2 < 20.0,
                  f"{fault}: the fallback generate {st} in {wall2:.2f} s")
            notes.append(f"{fault}: push {wall:.3f} s, pushed false "
                         f"({err or 'no answer'}); generate through the "
                         f"controller {wall2:.3f} s, monolithic tokens")
        fallbacks = _prom_value(ctl2.registry.render(),
                                "fleet_transfer_fallback_total")
        _must(tag, fallbacks == 2, f"{fallbacks} transfer fallbacks, want 2")
        req = KVExportRequest(prompt=np.asarray(p, np.int32),
                              done=threading.Event())
        pf.engine.submit(req)
        _must(tag, req.done.wait(60), "the export never finished")
        frame = _wire_frame(req.result)
        mangled = bytearray(frame)
        for i in range(10, 26):
            mangled[i] ^= 0xFF
        codes = []
        for bad in (frame[:len(frame) // 2], bytes(mangled)):
            conn = http.client.HTTPConnection(*dc.address, timeout=60)
            try:
                conn.request("POST", "/v1/kv_segment", body=bad)
                codes.append(conn.getresponse().status)
            finally:
                conn.close()
        _must(tag, codes == [400, 400], f"bad frames answered {codes}")
        log(f"{tag}: {'; '.join(notes)}; fallbacks {fallbacks:g}; a frame "
            f"cut in half and one with flipped header bytes answered "
            f"{codes}; the proxy's counts {proxy.counts} [{card}]")
    finally:
        for s in (ctl, ctl2, proxy, pf, dc, mono):
            if s is not None:
                s.stop()
    torch_sync()
    _add(total, read_launches())

    tag = "phase 12f"
    merged = merge_traces([tr["controller"].chrome_trace(),
                           tr["prefill"].chrome_trace(),
                           tr["decode"].chrome_trace()])
    evs = [e for e in merged["traceEvents"] if e.get("ph") == "X"]
    by_span = {e["args"]["span_id"]: e for e in evs
               if "span_id" in e.get("args", {})}
    transfer = next((e for e in evs if e["name"] == "transfer"), None)
    _must(tag, transfer is not None, "no transfer span")
    export = by_span.get(transfer["args"].get("parent_span_id"))
    ingest = next((e for e in evs if e["name"] == "kv_ingest"
                   and e["args"].get("parent_span_id")
                   == transfer["args"]["span_id"]), None)
    dispatch = by_span.get((export or {}).get("args", {}).get(
        "parent_span_id"))
    tid = transfer["args"]["trace_id"]
    chain = (export is not None and export["name"] == "prefill"
             and export["args"].get("prefix") == "export"
             and ingest is not None and dispatch is not None
             and dispatch["name"] == "dispatch"
             and export["args"]["trace_id"] == tid
             and ingest["args"]["trace_id"] == tid
             and dispatch["args"]["trace_id"] == tid)
    _must(tag, chain, "the merged trace does not chain dispatch -> export "
          "-> transfer -> kv_ingest")
    # each transfer request's legs (ms): the controller's prefill-leg and
    # decode-leg dispatches, the export's prefill, the push, the ingest
    legs = []
    for t in trace_ids:
        mine = [e for e in evs if e.get("args", {}).get("trace_id") == t]
        legs.append({
            "/".join(str(x) for x in (e["name"], e["args"].get("leg")
                                      or e["args"].get("prefix")) if x):
            round(e["dur"] / 1e3, 2) for e in mine})
    log(f"{tag}: merged trace of {len(evs)} spans over 3 processes; "
        f"dispatch -> prefill(export) -> transfer -> kv_ingest under trace "
        f"{tid[:8]}...; the transfer requests' spans (ms) {legs}; spans by "
        f"name "
        f"{dict(sorted(collections.Counter(e['name'] for e in evs).items()))}")


def phase12_router(card: str, cfg, params, total) -> None:
    """12c: a ``ReplicaRouter`` over two replicas with the prefix cache:
    shared-prefix prompts pin to one replica, other prompts spread; a
    stopped replica's requests retry on the survivor and its breaker
    opens; restarted on its port, health polls leave the breaker open and,
    once the survivor drains, a forwarded request (the half-open probe)
    closes it."""
    from deeplearning4j_tpu_torch.serving import ReplicaRouter, ServingServer
    from deeplearning4j_tpu_torch.serving.rpc import CLOSED, OPEN

    tag = "phase 12c"
    servers = [ServingServer(phase8_engine(cfg, params, prefix_cache=True),
                             port=0).start() for _ in range(2)]
    router = ReplicaRouter([s.address for s in servers],
                           affinity_min_match=16,
                           health_interval_s=600.0).start()
    revived = None
    torch_sync()
    reset_launches()
    try:
        spread = set()
        for p in _wire_prompts(cfg.vocab_size, (24, 40, 56, 72), 30):
            st, out, served, _ = _fleet_post(
                router.address, "/v1/generate",
                {"prompt": p.tolist(), "max_new": 8})
            _must(tag, st == 200, f"{st} {out}")
            spread.add(served)
        system = _wire_prompts(cfg.vocab_size, (64,), 31)[0].tolist()
        pinned = set()
        for tail in _wire_prompts(cfg.vocab_size, (8, 12, 16, 20), 32):
            st, out, served, _ = _fleet_post(
                router.address, "/v1/generate",
                {"prompt": system + tail.tolist(), "max_new": 8})
            _must(tag, st == 200, f"{st} {out}")
            pinned.add(served)
        _must(tag, len(spread) == 2 and len(pinned) == 1,
              f"spread over {spread}, shared prefix over {pinned}")
        name = pinned.pop()
        victim = next(s for s in servers if s.name == name)
        survivor = next(s for s in servers if s is not victim)
        host, port = victim.address
        victim.stop()
        retried = set()
        for k in range(3):
            st, _, served, _ = _fleet_post(
                router.address, "/v1/generate",
                {"prompt": system + [k + 1] * 4, "max_new": 4})
            _must(tag, st == 200, f"retry {k}: {st}")
            retried.add(served)
        for _ in range(3):
            router.poll_health()
        state = router.replica_states()[name]
        _must(tag, retried == {survivor.name} and not state["healthy"]
              and state["breaker"]["state"] == OPEN,
              f"after the stop: served by {retried}, {state}")
        revived = ServingServer(phase8_engine(cfg, params), host=host,
                                port=port).start()
        router.poll_health()
        state = router.replica_states()[name]
        _must(tag, state["healthy"] and state["breaker"]["state"] == OPEN,
              f"a health poll closed the breaker: {state}")
        _fleet_post(survivor.address, "/drain", {})
        router.poll_health()
        t0 = time.monotonic()
        probe_served = None
        while router.replica_states()[name]["breaker"]["state"] != CLOSED:
            _must(tag, time.monotonic() - t0 < 30.0, "the breaker never "
                  "closed")
            time.sleep(0.25)
            st, _, probe_served, _ = _fleet_post(
                router.address, "/v1/generate",
                {"prompt": system[:16], "max_new": 4})
        _fleet_post(survivor.address, "/undrain", {})
        with urllib.request.urlopen("http://%s:%d/metrics" % router.address,
                                    timeout=60) as r:
            rtext = r.read().decode()
        retries = _prom_value(rtext, "router_retries_total")
        affinity = _prom_value(rtext, "router_affinity_total")
        _must(tag, retries >= 1, f"router_retries_total {retries}")
        log(f"{tag}: 4 distinct prompts over {len(spread)} replicas, 4 "
            f"shared-prefix prompts on one ({name}); the stopped replica's "
            f"3 requests served by the survivor, its breaker open; "
            f"restarted, a health poll left it open; with the survivor "
            f"drained the probe request (served by {probe_served}) closed "
            f"it; router_retries_total {retries:g}, router_affinity_total "
            f"{affinity:g} [{card}]")
    finally:
        for s in (router, *servers, revived):
            if s is not None:
                s.stop()
    torch_sync()
    _add(total, read_launches())


def phase12_migrate(card: str, cfg, params, total) -> None:
    """12d: ``POST /migrate`` mid-generation moves the live sessions of a
    source server (throttled so they are still decoding) to a destination
    with another master seed; the original clients get the uninterrupted
    run's streams byte for byte, greedy and T 0.8 top-k 40. A session using
    the sampling surface stays local (``export_sessions`` skips it)."""
    import threading

    import numpy as np

    from deeplearning4j_tpu_torch.serving import (
        FaultInjector,
        Request,
        ServingServer,
    )

    tag = "phase 12d"
    prompts = _wire_prompts(cfg.vocab_size, (64, 140, 200), 40)
    notes = []
    torch_sync()
    reset_launches()
    for temp in (0.0, SAMPLE_T):
        kw = dict(temperature=temp, top_k=SAMPLE_K if temp else None)
        src_eng = phase8_engine(cfg, params, rng_seed=5,
                                faults=FaultInjector(delay_s=MIGRATE_DELAY_S),
                                **kw)
        dst_eng = phase8_engine(cfg, params, rng_seed=99, **kw)
        dst = ServingServer(dst_eng, port=0).start()
        src = ServingServer(src_eng, port=0,
                            migrate_targets=("%s:%d" % dst.address,)).start()
        outs: dict[int, tuple] = {}
        threads = []
        try:
            for i, p in enumerate(prompts):
                t = threading.Thread(target=lambda i=i, p=p: outs.update(
                    {i: _fleet_post(src.address, "/v1/generate",
                                    {"prompt": p.tolist(),
                                     "max_new": MIGRATE_NEW})}))
                t.start()
                threads.append(t)
                t0 = time.monotonic()
                while sum(st is not None for st in src_eng._slots) <= i:
                    _must(tag, time.monotonic() - t0 < 30, "not admitted")
                    time.sleep(0.002)
            t_mig = time.perf_counter()
            st, res, _, _ = _fleet_post(src.address, "/migrate", {})
            mig_s = time.perf_counter() - t_mig
            for t in threads:
                t.join(timeout=120)
            _must(tag, st == 200 and res.get("exported") == len(prompts)
                  and res.get("migrated") == len(prompts),
                  f"/migrate answered {st} {res}")
        finally:
            src.stop()
            dst.stop()
        mono = phase8_engine(cfg, params, rng_seed=5, **kw)
        ref = _served(mono, [Request(prompt=p, max_new=MIGRATE_NEW)
                             for p in prompts])
        same = sum(outs[i][0] == 200
                   and np.array_equal(outs[i][1]["tokens"], ref[i])
                   for i in range(len(prompts)))
        _must(tag, same == len(prompts), f"T {temp}: {same}/{len(prompts)} "
              f"migrated streams equal the uninterrupted run")
        seated = dst_eng.metrics.n_migrations_seated
        notes.append(f"T {temp}: {res['exported']} sessions exported and "
                     f"seated ({seated}) in {mig_s:.3f} s, {same}/"
                     f"{len(prompts)} streams the uninterrupted run's")
        del src_eng, dst_eng, mono
    eng = phase8_engine(cfg, params, sampling_surface=True)
    req = Request(prompt=prompts[0], max_new=MIGRATE_NEW, top_k=SAMPLE_K)
    eng.submit(req)
    for _ in range(50):
        eng.step()
        st = next((s for s in eng._slots if s is not None), None)
        if st is not None and len(st.tokens) >= 2:
            break
    local = eng.export_sessions()
    _must(tag, local == [] and any(s is not None and s.req is req
                                   for s in eng._slots),
          "a sampling-surface session was exported")
    eng.run()
    torch_sync()
    _add(total, read_launches())
    log(f"{tag}: {'; '.join(notes)}; a sampling-surface session stayed "
        f"local ({req.status.value}) [{card}]")


def phase_fleet(card: str) -> dict[str, dict[str, int]]:
    """Phase 12: the KV wire, the fleet controller, the router, live
    migration and chaos at GPT-2-small's width (phase 3's model, 8 slots,
    max_total 640, K 4); fails on a launch at a shape phase 2 did not
    hold."""
    import torch

    t0 = time.perf_counter()
    models = (serve_model(False), serve_model(True))
    cfg, params = models[0]
    runs = {k: {} for k in ("wire", "fleet", "router", "migrate")}
    with launched_shapes() as seen:
        for name, fn in (("wire", lambda c, t: phase12_wire(c, models, t)),
                         ("fleet", lambda c, t: phase12_fleet(c, cfg, params,
                                                              t)),
                         ("router", lambda c, t: phase12_router(
                             c, cfg, params, t)),
                         ("migrate", lambda c, t: phase12_migrate(
                             c, cfg, params, t))):
            t1 = time.perf_counter()
            fn(card, runs[name])
            log(f"phase 12 {name}: {time.perf_counter() - t1:.1f} s")
            torch.cuda.empty_cache()
    log(f"phase 12: {time.perf_counter() - t0:.1f} s wall; launches "
        f"{ {k: v for k, v in runs.items()} } [{card}]")
    check_launched("phase 12", seen)
    return {f"fleet_{k}": v for k, v in runs.items()}


# -- phase 13 ----------------------------------------------------------------

#: 13: the widths served, every rank on the one card: GPT-2-small's 6
#: heads divide among 2 and 3 ranks, not 4 (13g: a tp-4 request falls back
#: to 1)
TP_WIDTHS = (1, 2, 3)
#: 13a's modes: (name, int8 full, paged, widths); tp 3 only in bf16 slab
#: (the phase's time budget)
TP_MODES = (("bf16 slab", False, False, TP_WIDTHS),
            ("bf16 paged", False, True, TP_WIDTHS[:2]),
            ("int8 full", True, False, TP_WIDTHS[:2]))
#: (mode, tp) pairs whose parity probe declines on the card for a product
#: PERF.md section 7 names; the phase then serves them trusted and holds
#: them to tp 1 at the near-tie rule. A decline outside it fails the phase
#: in bf16 slab and is reported in the others. None: the head product runs
#: in fixed-width vocab column blocks (``_head_cols``), the one product
#: cuBLAS rounded differently over a rank's narrower part
#: (``scripts/torch_tp_products.py``).
TP_KNOWN_DECLINES: frozenset = frozenset()
#: 13b: the shared system prompt, suffix lengths, exact repeats; 13c: the
#: crash's step check; 13h: steady-decode horizons profiled a width
TP_SYSTEM, TP_SUFFIXES, TP_REPEATS = 256, (8, 16, 24, 32, 40, 48), 2
TP_CRASH, TP_PROFILE_HORIZONS = 6, 3
#: the probe-verdict file every phase-13 engine shares (its directory is
#: made and removed by ``main``)
TP_PROBES = ROOT / ".scratch" / "chip_smoke_phase13" / "probes.json"


def _tp_engine(cfg, params, tp: int, **kw):
    """Phase 13's engine: the serve smoke's geometry (8 slots, max_total
    640, K 4) at tensor-parallel width ``tp``, every rank on cuda:0."""
    from deeplearning4j_tpu_torch.serving import ServingEngine

    kw.setdefault("temperature", 0.0)
    return ServingEngine(cfg, params, n_slots=8, max_total=640,
                         decode_horizon=4, block_size=BLOCK_SIZE, tp=tp,
                         tp_devices=["cuda:0"] * tp if tp > 1 else None,
                         probe_cache=str(TP_PROBES), **kw)


def _slot_keys(seed: int, n: int) -> list:
    """The first ``n`` slot keys an engine with master seed ``seed``
    splits off, in admission order."""
    from deeplearning4j_tpu_torch.ops import threefry

    k, out = threefry.key(seed), []
    for _ in range(n):
        k, sub = threefry.split(k)
        out.append(sub)
    return out


def _tp_run(tag, cfg, params, tp, prompts, *, must=(), **kw):
    """Build a width-``tp`` engine and serve ``prompts`` (MAX_NEW new each)
    with every count set to 0 just before and read just after; no prefill
    or decode kernel may launch (the TP path and its tp-1 comparator are
    dense). A declined probe is reported and, where TP_KNOWN_DECLINES
    names it (or outside bf16 slab), the engine is built again trusted
    (``tp_parity=True``). Returns (engine, probe verdict, streams,
    launches, summary)."""
    import torch

    from deeplearning4j_tpu_torch.serving import Request

    mode = tag.split(",")[0].removeprefix("phase 13a ")
    eng = _tp_engine(cfg, params, tp, **kw)
    ok = eng.tp == tp
    if tp > 1:
        log(f"{tag}: tp parity probe {'passed' if ok else 'DECLINED'}"
            f"{'' if ok else ' (' + str(eng.tp_probe_detail) + ')'}; "
            f"probes run {eng.probes_run}, from the cache "
            f"{eng.probes_from_cache}")
    if not ok:
        _must(tag, mode != "bf16 slab" or (mode, tp) in TP_KNOWN_DECLINES,
              "the probe declined in bf16 slab for no recorded product")
        del eng
        eng = _tp_engine(cfg, params, tp, tp_parity=True, **kw)
    streams, launches, wall = _timed_run(
        eng, [Request(prompt=p, max_new=MAX_NEW) for p in prompts])
    _launch_check(tag, launches, must,
                  ("flash_attn_fwd", "flash_decode", "flash_decode_int8",
                   "flash_decode_paged"))
    torch.cuda.empty_cache()
    s = eng.metrics.summary()
    s["wall_s"] = wall
    return eng, ok, streams, launches, s


def phase13_parity(card: str, models, total, perf) -> dict:
    """13a: bf16 slab, bf16 paged (bs 8) and int8 full, greedy and T 0.8
    top-k 40, at tp 1 and 2 (bf16 slab also at 3): the probe's verdict and
    the streams against tp 1's (byte-identical where the probe passed,
    else at the near-tie rule); tok/s and TPOT p50 per width. Returns the
    prompts, and the tp-2 bf16 slab T 0.8 streams for 13c."""
    import numpy as np

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, models[False][0].vocab_size, n)
               for n in PROMPT_LENGTHS]
    out = {"prompts": prompts}
    for mode, int8, paged, widths in TP_MODES:
        cfg, params = models[int8]
        for sampled in (False, True):
            kw = dict(paged=paged, **(dict(temperature=SAMPLE_T,
                                           top_k=SAMPLE_K) if sampled
                                      else {}))
            smode = f"{mode}, {'T 0.8 top-k 40' if sampled else 'greedy'}"
            ref = None
            for tp in widths:
                tag = f"phase 13a {smode}, tp {tp}"
                t0 = time.perf_counter()
                eng, ok, streams, launches, s = _tp_run(
                    tag, cfg, params, tp, prompts,
                    must=("threefry_draw",) if sampled else (), **kw)
                _add(total, launches)
                _must(tag, eng._paged == paged, "the paged probe failed")
                if tp == 1:
                    ref = (eng, streams)
                else:
                    same, notes = _against(
                        tag, ref[0], ref[1], streams, prompts, sampled,
                        _slot_keys(0, len(prompts)), ok)
                    log(f"{tag}: streams byte-identical to tp 1 {same}/"
                        f"{len(prompts)}"
                        f"{'; ' + '; '.join(notes) if notes else ''}")
                    if sampled and mode == "bf16 slab" and tp == 2:
                        out["crash_ref"] = streams
                log(f"{tag}: {s['n_generated']} tokens in "
                    f"{s['wall_s']:.3f} s -> "
                    f"{s['n_generated'] / s['wall_s']:.1f} generated tok/s; "
                    f"TPOT p50 {s['tpot_p50_s'] * 1e3:.3f} ms p99 "
                    f"{s['tpot_p99_s'] * 1e3:.3f} ms; TTFT p50 "
                    f"{s['ttft_p50_s'] * 1e3:.2f} ms; draws "
                    f"{launches['threefry_draw']}; "
                    f"{time.perf_counter() - t0:.1f} s with set-up "
                    f"[{card}]")
                perf.setdefault(smode, {})[tp] = (
                    s["n_generated"] / s["wall_s"], s["tpot_p50_s"] * 1e3)
                del eng
    return out


def phase13_prefix(card: str, cfg, params, total) -> None:
    """13b: at tp 2, prompts behind one 256-token system prompt with the
    prefix cache off and on, in two waves: two prompts first (the second
    one's insert cuts a branch-point segment at the system prompt), then
    four more (partial hits there) and exact repeats of the first two
    (full hits). The same bytes either way."""
    import numpy as np

    from deeplearning4j_tpu_torch.serving import Request

    rng = np.random.default_rng(13)
    system = rng.integers(0, cfg.vocab_size, TP_SYSTEM)
    prompts = [np.concatenate([system, rng.integers(0, cfg.vocab_size, n)])
               for n in TP_SUFFIXES]
    prompts += [p.copy() for p in prompts[:TP_REPEATS]]
    runs = {}
    for cache in (False, True):
        tag = f"phase 13b tp 2, prefix cache {'on' if cache else 'off'}"
        eng = _tp_engine(cfg, params, 2, prefix_cache=cache)
        _must(tag, eng.tp == 2, "the tp parity probe declined")
        streams, wall = [], 0.0
        for wave in (prompts[:2], prompts[2:]):
            got, launches, w = _timed_run(
                eng, [Request(prompt=p, max_new=MAX_NEW) for p in wave])
            _launch_check(tag, launches, (),
                          ("flash_attn_fwd", "flash_decode"))
            _add(total, launches)
            streams += got
            wall += w
        m = eng.metrics
        runs[cache] = streams
        log(f"{tag}: probe {eng._prefix_ok_memo}; full hits "
            f"{m.n_prefix_hits_full}, partial {m.n_prefix_hits_partial}, "
            f"tokens saved {m.prefix_tokens_saved}; prefill dispatches "
            f"{eng.prefill_dispatches}; TTFT p50 "
            f"{m.summary()['ttft_p50_s'] * 1e3:.2f} ms; {wall:.3f} s "
            f"[{card}]")
        if cache:
            _must(tag, m.n_prefix_hits_full == TP_REPEATS
                  and m.n_prefix_hits_partial == len(TP_SUFFIXES) - 2,
                  "the second wave did not hit the cache")
    same = sum(np.array_equal(a, b) for a, b in zip(runs[False], runs[True]))
    log(f"phase 13b: cache on vs off streams identical {same}/{len(prompts)}")
    _must("phase 13b", same == len(prompts), "cache-on streams differ")


def phase13_recovery(card: str, cfg, params, total, prompts, ref) -> None:
    """13c: the tp-2 bf16 slab T 0.8 top-k 40 run under a crash at step
    check 6: its streams equal the uninterrupted run's."""
    import numpy as np

    from deeplearning4j_tpu_torch.serving import FaultInjector

    tag = "phase 13c tp 2, crash at step check 6"
    eng, _, streams, launches, s = _tp_run(
        tag, cfg, params, 2, prompts, must=("threefry_draw",),
        temperature=SAMPLE_T, top_k=SAMPLE_K,
        faults=FaultInjector().plan("step", TP_CRASH, "crash"))
    _add(total, launches)
    same = sum(np.array_equal(a, b) for a, b in zip(ref, streams))
    log(f"{tag}: restarts {eng.metrics.n_restarts}, mode "
        f"{eng.last_recover_mode} (chunked-replay probe {eng._chunked_ok}); "
        f"streams identical to the uninterrupted run {same}/{len(prompts)} "
        f"[{card}]")
    _must(tag, eng.tp == 2 and eng.metrics.n_restarts == 1
          and same == len(prompts), "the recovered streams differ")


def phase13_lora(card: str, cfg, params, total, prompts) -> None:
    """13d: a bank of 4 adapters of rank 4 from key(0) at tp 2 against tp
    1, adapters 0-3 over the 8 slots, greedy."""
    import numpy as np

    from deeplearning4j_tpu_torch.models.transformer import init_lora_bank
    from deeplearning4j_tpu_torch.ops import threefry
    from deeplearning4j_tpu_torch.serving import Request

    bank = init_lora_bank(threefry.key(0), cfg, 4, 4)
    runs = {}
    for tp in (1, 2):
        tag = f"phase 13d LoRA 4 x rank 4, tp {tp}"
        eng = _tp_engine(cfg, params, tp, lora_bank=bank)
        _must(tag, eng.tp == tp and eng.n_adapters == 4,
              "the tp or LoRA probe declined")
        streams, launches, wall = _timed_run(eng, [
            Request(prompt=p, max_new=MAX_NEW, adapter=i % 4)
            for i, p in enumerate(prompts)])
        _launch_check(tag, launches, (), ("flash_attn_fwd", "flash_decode"))
        _add(total, launches)
        runs[tp] = streams
        log(f"{tag}: {wall:.3f} s [{card}]")
    same = sum(np.array_equal(a, b) for a, b in zip(runs[1], runs[2]))
    log(f"phase 13d: tp 2 vs tp 1 streams identical {same}/{len(prompts)}")
    _must("phase 13d", same == len(prompts), "LoRA streams differ")


def phase13_grammar(card: str, cfg, params, total) -> None:
    """13e: one regex and one JSON-schema request (T 0 and T 0.8) beside
    two plain ones through the masked step at tp 2 against tp 1."""
    import numpy as np

    from deeplearning4j_tpu_torch.serving import Request

    runs = {}
    for tp in (1, 2):
        tag = f"phase 13e grammar, tp {tp}"
        eng = _tp_engine(cfg, params, tp, sampling_surface=True)
        _must(tag, eng.tp == tp and eng._surface,
              "the tp or masked probe declined")
        rng = np.random.default_rng(14)
        reqs = _constrained_reqs(n_regex=1, n_json=1) + [
            Request(prompt=rng.integers(0, cfg.vocab_size, n), max_new=16)
            for n in (40, 77)]
        for r in reqs:
            eng.submit(r)
        res = eng.run()
        _check_constrained(tag, res, reqs[:2])
        runs[tp] = [res[r.id] for r in reqs]
        outs = [bytes(int(t) for t in res[r.id][len(r.prompt):-1])
                for r in reqs[:2]]
        log(f"{tag}: constrained outputs {outs} [{card}]")
    same = sum(np.array_equal(a, b) for a, b in zip(runs[1], runs[2]))
    log(f"phase 13e: tp 2 vs tp 1 streams identical {same}/4")
    _must("phase 13e", same == 4, "masked-step streams differ")


def phase13_wire(card: str, cfg, params, total) -> None:
    """13f: a 200-token prompt exported by a tp-2 engine: its frame is a
    tp-1 engine's byte for byte, a tp-1 decode engine seats it and the
    follow-up generate runs no prefill program with the monolithic
    stream."""
    import threading

    import numpy as np

    from deeplearning4j_tpu_torch.serving import (
        KVExportRequest,
        KVIngestRequest,
        Request,
        decode_segment,
        encode_segment,
    )

    def drain(eng, req):
        eng.submit(req)
        while not req.done.is_set():
            eng.step()
        return req

    prompt = np.random.default_rng(15).integers(0, cfg.vocab_size, 200)
    frames = {}
    for tp in (1, 2):
        eng = _tp_engine(cfg, params, tp)
        _must("phase 13f", eng.tp == tp, "the tp parity probe declined")
        res = drain(eng, KVExportRequest(prompt=prompt,
                                         done=threading.Event())).result
        frames[tp] = encode_segment(
            config_hash=res["config_hash"], tokens=res["tokens"],
            leaves=res["leaves"], logits=res["logits"], layout=res["layout"],
            block_size=res["block_size"])
    dc = _tp_engine(cfg, params, 1, prefix_cache=True)
    ing = drain(dc, KVIngestRequest(
        segment=decode_segment(frames[2], expect_hash=dc.config_hash),
        done=threading.Event()))
    got = drain(dc, Request(prompt=prompt, max_new=MAX_NEW,
                            done=threading.Event()))
    mono = _tp_engine(cfg, params, 1)
    mono.submit(ref := Request(prompt=prompt, max_new=MAX_NEW))
    want = mono.run()[ref.id]
    same = np.array_equal(dc.pop_result(got.id), want)
    log(f"phase 13f: frame bytes {len(frames[2])}, tp 2 == tp 1 "
        f"{frames[1] == frames[2]}; seated {ing.result}; prefill "
        f"dispatches after the seat {dc.prefill_dispatches}; stream equal "
        f"to the monolithic one {same} [{card}]")
    _must("phase 13f", frames[1] == frames[2] and ing.result["stored"]
          and dc.prefill_dispatches == 0 and same,
          "the tp-2 frame did not seat as a tp-1 one")


def phase13_cli(kcfg, params, total) -> None:
    """13g: an engine asked for tp 4 over the 6 heads serves at tp 1
    (``tp_parity_probe_failed``, the layout's refusal) with the caller's
    config, so kernels #1 and #3 launch again; ``serve --tp N`` with one
    card more than the machine has (2 on one card) exits 2 with the
    mesh's message."""
    import io

    import numpy as np
    import torch

    from deeplearning4j_tpu_torch import cli
    from deeplearning4j_tpu_torch.serving import Request

    tag = "phase 13g tp 4 fallback"
    eng = _tp_engine(kcfg, params, 4)
    log(f"{tag}: tp 4 over {kcfg.n_heads} heads -> tp {eng.tp} "
        f"({eng.tp_probe_detail})")
    _must(tag, eng.tp == 1 and eng.tp_mesh is None and eng.cfg == kcfg,
          "tp 4 over 6 heads did not fall back to tp 1 with the caller's "
          "config")
    rng = np.random.default_rng(17)
    _, launches, _ = _timed_run(eng, [
        Request(prompt=rng.integers(0, kcfg.vocab_size, n), max_new=8)
        for n in (40, 128)])
    _launch_check(tag, launches, ("flash_attn_fwd", "flash_decode"))
    _add(total, launches)
    del eng

    n = max(2, torch.cuda.device_count() + 1)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["serve", "--demo", "--preset", "gpt2s", "--tp",
                       str(n), "--port", "0"])
    log(f"phase 13g: serve --tp {n} on {torch.cuda.device_count()} "
        f"card(s): exit {rc}, "
        f"{err.getvalue().strip()!r}")
    _must("phase 13g", rc == 2 and f"need {n} devices" in err.getvalue(),
          f"serve --tp {n} did not exit 2 with the mesh's message")


def phase13_profile(card: str, cfg, params, perf) -> None:
    """13h: launches a decode substep at each width: 8 slots of 128-token
    prompts in steady decode, TP_PROFILE_HORIZONS horizons under
    ``torch.profiler`` (device records per substep), with the host's
    ms a substep over the same horizons untraced."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.serving import Request

    rng = np.random.default_rng(16)
    for tp in TP_WIDTHS:
        eng = _tp_engine(cfg, params, tp)
        if eng.tp != tp:  # a recorded decline (13a checked it): trusted
            eng = _tp_engine(cfg, params, tp, tp_parity=True)
        for _ in range(8):
            eng.submit(Request(prompt=rng.integers(0, cfg.vocab_size, 128),
                               max_new=4 * (3 * TP_PROFILE_HORIZONS + 4)))
        for _ in range(3):
            eng.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TP_PROFILE_HORIZONS):
            eng.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / (4 * TP_PROFILE_HORIZONS) * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(TP_PROFILE_HORIZONS):
                eng.step()
            torch.cuda.synchronize()
        recs = sum(ev.count for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA)
        per = recs / (4 * TP_PROFILE_HORIZONS)
        perf.setdefault("profile", {})[tp] = (per, ms)
        log(f"phase 13h tp {tp}: {per:.2f} device records a decode substep "
            f"({recs} over {4 * TP_PROFILE_HORIZONS} substeps), host "
            f"{ms:.3f} ms a substep untraced, 8 slots [{card}]")
        del eng
        torch.cuda.empty_cache()


def phase_tp(card: str) -> dict[str, dict[str, int]]:
    """Phase 13: exact tensor-parallel serving at GPT-2-small's width
    (phase 3's model and prompts, 8 slots, max_total 640, K 4) at tp 1, 2
    and 3 on ``["cuda:0"] * tp``, every engine built from one
    probe-verdict file (``TP_PROBES``); fails on a launch at a shape phase
    2 did not hold."""
    import dataclasses

    import torch

    t0 = time.perf_counter()
    TP_PROBES.parent.mkdir(parents=True, exist_ok=True)
    # the dense programs a TP request runs, at every width
    models = {}
    for int8 in (False, True):
        cfg, params = serve_model(int8)
        models[int8] = (dataclasses.replace(cfg, decode_kernel=False,
                                            use_flash=False), params)
    kcfg = serve_model(False)[0]
    cfg, params = models[False]
    total: dict[str, int] = {}
    perf: dict = {}
    with launched_shapes() as seen:
        got = phase13_parity(card, models, total, perf)
        for name, fn in (
                ("prefix", lambda: phase13_prefix(card, cfg, params, total)),
                ("recovery", lambda: phase13_recovery(
                    card, cfg, params, total, got["prompts"],
                    got["crash_ref"])),
                ("lora", lambda: phase13_lora(card, cfg, params, total,
                                              got["prompts"])),
                ("grammar", lambda: phase13_grammar(card, cfg, params,
                                                    total)),
                ("wire", lambda: phase13_wire(card, cfg, params, total)),
                ("cli", lambda: phase13_cli(kcfg, params, total)),
                ("profile", lambda: phase13_profile(card, cfg, params,
                                                    perf))):
            t1 = time.perf_counter()
            fn()
            log(f"phase 13 {name}: {time.perf_counter() - t1:.1f} s")
            torch.cuda.empty_cache()
    summary = {m: {tp: f"{r[0]:.1f} tok/s, TPOT p50 {r[1]:.3f} ms"
                   for tp, r in v.items()}
               for m, v in perf.items() if m != "profile"}
    log(f"phase 13: {time.perf_counter() - t0:.1f} s wall; tok/s and TPOT "
        f"by width {summary}; decode substep records and host ms by width "
        f"{perf.get('profile')} [{card}]")
    check_launched("phase 13", seen)
    return {"tp": total}


# -- phase 14 ----------------------------------------------------------------

#: 14a: the MoE serving model (GPT-2-small's widths, 8 experts, top 2);
#: 14b: the mesh, experts (one a model rank) and steps; 14c: the CLI run's
#: widths and depth
MOE_EXPERTS, MOE_K = 8, 2
# 14b's timed steps: 4 (cut from 6 when phase 20 joined; the losses fall
# from the first step on)
MESH_DP, MESH_TP, MESH_BATCH, MESH_STEPS, MESH_WARMUP = 2, 3, 8, 4, 1
MESH_FSDP_RTOL = 2e-3
CLI_MESH_LAYERS, CLI_MESH_SEQ, CLI_MESH_BATCH = 2, 64, 8
CLI_MESH_DIR = ROOT / ".scratch" / "chip_smoke_phase14"


def _decode_records(engine, prompts, horizons: int = 3) -> tuple:
    """Device records and host ms a steady decode substep (8 slots of
    ``prompts``, ``horizons`` horizons under ``torch.profiler``, the host
    ms over as many untraced)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.serving import Request

    k = engine.decode_horizon
    for p in prompts:
        engine.submit(Request(prompt=p, max_new=k * (3 * horizons + 4)))
    for _ in range(3):
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(horizons):
        engine.step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (k * horizons) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(horizons):
            engine.step()
        torch.cuda.synchronize()
    recs = sum(ev.count for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA)
    engine.run()
    return recs / (k * horizons), ms


def phase14_moe_serve(card: str, total) -> None:
    """14a: MoE serving at GPT-2-small's width (8 experts, top 2, dense
    decode over every expert), the serve smoke's geometry and prompts: bf16
    slab and paged (bs 8), greedy and T 0.8 top-k 40; greedy streams held
    against ``transformer_generate`` (near-tie rule), paged against slab
    byte for byte; every probe's verdict; #1, #3 and #4 launched; tok/s,
    TPOT p50 and device records a decode substep beside the dense
    model's."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models.transformer import (
        init_params,
        transformer_generate,
    )
    from deeplearning4j_tpu_torch.serving import Request, ServingEngine

    cfg = gpt2s_config(n_experts=MOE_EXPERTS, moe_k=MOE_K)
    params = init_params(cfg, seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in PROMPT_LENGTHS]
    gen = transformer_generate(cfg)
    refs = {i: _generate(gen, params, prompts[i]) for i in (1, 5)}

    def engine(c, p, **kw):
        return ServingEngine(c, p, n_slots=8, max_total=640,
                             decode_horizon=4, block_size=BLOCK_SIZE,
                             prefix_cache=True, **kw)

    perf = {}
    for sampled in (False, True):
        kw = (dict(temperature=SAMPLE_T, top_k=SAMPLE_K) if sampled
              else dict(temperature=0.0))
        mode = "T 0.8 top-k 40" if sampled else "greedy"
        slab = None
        for paged in (False, True):
            tag = f"phase 14a MoE {'paged bs 8' if paged else 'slab'}, {mode}"
            eng = engine(cfg, params, paged=paged, **kw)
            _must(tag, eng._paged == paged, "the paged probe failed")
            streams, launches, wall = _timed_run(
                eng, [Request(prompt=p, max_new=MAX_NEW) for p in prompts])
            _add(total, launches)
            _launch_check(tag, launches,
                          ("flash_attn_fwd", "flash_decode_paged" if paged
                           else "flash_decode"),
                          ("flash_decode",) if paged else ())
            s = eng.metrics.summary()
            for i, (ref, logits) in refs.items():
                if not sampled:
                    log(f"{tag}: parity vs transformer_generate, prompt "
                        f"{len(prompts[i])}: "
                        f"{_parity(prompts[i], ref, logits, streams[i])}")
            if slab is None:
                slab = streams
            else:
                same = sum(np.array_equal(a, b)
                           for a, b in zip(slab, streams))
                _must(tag, same == len(prompts),
                      f"paged streams equal the slab's {same}/"
                      f"{len(prompts)}")
                log(f"{tag}: streams byte-identical to slab "
                    f"{same}/{len(prompts)}")
            log(f"{tag}: {s['n_generated']} tokens in {wall:.3f} s -> "
                f"{s['n_generated'] / wall:.1f} generated tok/s; TPOT p50 "
                f"{s['tpot_p50_s'] * 1e3:.3f} ms p99 "
                f"{s['tpot_p99_s'] * 1e3:.3f} ms; TTFT p50 "
                f"{s['ttft_p50_s'] * 1e3:.2f} ms [{card}]")
            perf[tag] = (s["n_generated"] / wall, s["tpot_p50_s"] * 1e3)
            del eng
            torch.cuda.empty_cache()
    # every probe of the dense model, on fresh slab and paged engines of
    # both models: the MoE model's verdicts must be the dense model's (the
    # chunked-replay probe compares a chunk with decode steps, which no
    # library promises bitwise, so it may decline for both), and the
    # prefix, batching, paged and wire probes must pass
    dense_cfg, dense_params = serve_model(False)
    verdicts = {}
    for name, c, p in (("dense", dense_cfg, dense_params),
                       ("MoE", cfg, params)):
        for paged in (False, True):
            eng = engine(c, p, paged=paged, temperature=0.0)
            v = {"prefix_reuse": eng._prefix_reuse_ok(),
                 "chunked_replay": eng._use_chunked_replay(),
                 "disagg_wire": eng._disagg_ok()}
            if paged:
                v["paged_parity"] = eng._paged
            else:
                v["batch_admission (miss, 128, 8)"] = (
                    eng._batch_admission_ok("miss", 128, 8))
            verdicts[name, paged] = v
            log(f"phase 14a {name} {'paged' if paged else 'slab'} probe "
                f"verdicts {v}; probes run {eng.probes_run}")
            del eng
            torch.cuda.empty_cache()
    for paged in (False, True):
        moe_v = verdicts["MoE", paged]
        _must("phase 14a", moe_v == verdicts["dense", paged],
              f"MoE verdicts {moe_v} differ from the dense model's "
              f"{verdicts['dense', paged]}")
        _must("phase 14a", all(ok for k, ok in moe_v.items()
                               if k != "chunked_replay"),
              f"a parity probe declined on the MoE model: {moe_v}")
    # the dense model of phase 3 beside it: the same greedy slab run, then
    # steady decode for both
    eng = engine(dense_cfg, dense_params, temperature=0.0)
    _, _, wall = _timed_run(
        eng, [Request(prompt=p, max_new=MAX_NEW) for p in prompts])
    s = eng.metrics.summary()
    perf["phase 14a dense slab, greedy"] = (s["n_generated"] / wall,
                                            s["tpot_p50_s"] * 1e3)
    del eng
    prof = {}
    for name, c, p in (("dense", dense_cfg, dense_params),
                       ("MoE", cfg, params)):
        eng = engine(c, p, temperature=0.0)
        prof[name] = _decode_records(
            eng, [np.random.default_rng(16).integers(0, c.vocab_size, 128)
                  for _ in range(8)])
        del eng
        torch.cuda.empty_cache()
    log(f"phase 14a steady decode (8 slots, 128-token prompts, K 4): "
        f"device records and host ms a substep "
        f"{ {k: (round(r, 2), round(ms, 3)) for k, (r, ms) in prof.items()} }"
        f"; serve runs (generated tok/s, TPOT p50 ms) "
        f"{ {k: (round(a, 1), round(b, 3)) for k, (a, b) in perf.items()} }"
        f" [{card}]")
    del params, dense_params
    torch.cuda.empty_cache()


def mesh_config(n_layers: int = 12):
    """14b's model: the bench preset's widths at seq 1024 (flash, remat,
    bf16) with one expert a model rank, top 2."""
    import dataclasses

    return dataclasses.replace(bench_config(n_layers), n_experts=MESH_TP,
                               moe_k=2)


def phase14_mesh_train(card: str) -> dict[str, int]:
    """14b: the training step on a (data, model) = (2, 3) mesh over
    ``["cuda:0"] * 6``, MoE (3 experts, top 2) at GPT-2-small's widths,
    seq 1024, batch 8, flash, remat, bf16, with the replicated layout and
    with FSDP, one warm-up and 4 timed steps each on one fixed batch from
    one init: finite falling losses, FSDP's within MESH_FSDP_RTOL of
    replicated, #1 and #2 launched once a layer on every rank (BH 8: 4
    rows x 2 heads), ms a step and each rank's parameter + optimizer bytes
    from the layout. Returns the launches of both timed runs."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models.transformer import (
        layout_bytes,
        lm_optimizer,
        transformer_train_step,
    )
    from deeplearning4j_tpu_torch.parallel.mesh import dp_mp_mesh

    cfg = mesh_config()
    mesh = dp_mp_mesh(MESH_DP, MESH_TP, ["cuda:0"] * (MESH_DP * MESH_TP))
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (MESH_BATCH, TRAIN_SEQ + 1))
    losses, total = {}, {}
    per_step = cfg.n_layers * MESH_DP * MESH_TP
    for fsdp in (False, True):
        tag = f"phase 14b {'fsdp' if fsdp else 'replicated'}"
        t0 = time.perf_counter()
        step, init_state, shard_tokens = transformer_train_step(
            mesh, cfg, optimizer=lm_optimizer(total_steps=MESH_STEPS),
            fsdp=fsdp)
        params, opt_state = init_state(0)
        ts = shard_tokens(toks)
        ls = []
        for _ in range(MESH_WARMUP):
            params, opt_state, loss = step(params, opt_state, ts)
            ls.append(loss)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(MESH_STEPS):
            params, opt_state, loss = step(params, opt_state, ts)
            ls.append(loss)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / MESH_STEPS * 1e3
        launches = read_launches()
        _add(total, launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        ls = [float(x) for x in ls]
        losses[fsdp] = ls
        pb = layout_bytes(params)
        ob = [layout_bytes(opt_state[m]) for m in ("mu", "nu")]
        rank_bytes = {r: pb[r] + ob[0][r] + ob[1][r] for r in pb}
        log(f"{tag}: ({MESH_DP}, {MESH_TP}) mesh on cuda:0 x "
            f"{MESH_DP * MESH_TP}, {cfg.d_model}d x {cfg.n_layers}L, "
            f"{cfg.n_heads}x{cfg.head_dim} heads, {cfg.n_experts} experts "
            f"top {cfg.moe_k} (d_ff {cfg.d_ff}), vocab {cfg.vocab_size}, "
            f"seq {TRAIN_SEQ}, batch {MESH_BATCH}, flash, remat "
            f"{cfg.remat_policy}, bf16; set-up and {MESH_WARMUP} warm-up "
            f"{setup:.1f} s")
        log(f"{tag}: losses {' '.join(f'{x:.4f}' for x in ls)}")
        log(f"{tag}: {ms:.2f} ms/step, "
            f"{MESH_BATCH * TRAIN_SEQ / ms * 1e3:.1f} tokens/s, peak memory "
            f"{peak:.2f} GiB (every rank on one card); params + AdamW "
            f"bytes a rank from the layout "
            f"{ {f'{d},{m}': b for (d, m), b in sorted(rank_bytes.items())} }"
            f" ({sum(pb.values()) / 2**20:.1f} MiB of params over all ranks)"
            f" [{card}]")
        _launch_check(tag, launches, ("flash_attn_fwd", "flash_attn_bwd"))
        for name in ("flash_attn_fwd", "flash_attn_bwd"):
            _must(tag, launches[name] == MESH_STEPS * per_step,
                  f"{name} launched {launches[name]} times, not once a "
                  f"layer on each of the {MESH_DP * MESH_TP} ranks "
                  f"({MESH_STEPS * per_step})")
        _must(tag, all(np.isfinite(ls)) and ls[-1] < ls[0],
              f"losses not finite or not falling: {ls}")
        del params, opt_state, step
        torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(a) for a, b in zip(losses[False],
                                                   losses[True]))
    log(f"phase 14b: fsdp vs replicated losses, max rel diff {rel:.3e} "
        f"(tol {MESH_FSDP_RTOL})")
    _must("phase 14b", rel <= MESH_FSDP_RTOL,
          "fsdp's losses leave the replicated layout's")
    return total


def phase14_cli(card: str) -> dict[str, int]:
    """14c: ``train --tp 3 --n-experts 3 --fsdp --device cuda:0`` at
    GPT-2-small's width, 2 layers, writes a checkpoint; ``generate
    --checkpoint-dir`` on it exits 0 (dense decode over the experts)."""
    shutil.rmtree(CLI_MESH_DIR, ignore_errors=True)
    model = ["--d-model", "768", "--n-heads", "6", "--n-layers",
             str(CLI_MESH_LAYERS), "--seq-len", str(CLI_MESH_SEQ)]
    total: dict[str, int] = {}
    try:
        launches, out = _cli("phase 14c train", [
            "train", "--model", "transformer", "--tp", str(MESH_TP),
            "--n-experts", str(MESH_TP), "--fsdp", "--device", "cuda:0",
            "--steps", "4", "--batch", str(CLI_MESH_BATCH), "--flash",
            "--remat", "--bf16", "--checkpoint-dir", str(CLI_MESH_DIR),
            "--save-every", "4", *model])
        _add(total, launches)
        _must("phase 14c", (CLI_MESH_DIR / "ckpt_4.npz").is_file(),
              "no checkpoint written")
        _must("phase 14c", "training on a (data, model) = (1, 3) mesh" in out,
              "the run did not train on the mesh")
        _must_launch("phase 14c train", launches,
                     ("flash_attn_fwd", "flash_attn_bwd"))
        launches, out = _cli("phase 14c generate", [
            "generate", "--checkpoint-dir", str(CLI_MESH_DIR),
            "--temperature", "0"])
        _add(total, launches)
        _must("phase 14c", "restored step 4" in out, "no restore line")
        _must_launch("phase 14c generate", launches,
                     ("flash_attn_fwd", "flash_decode"))
    finally:
        shutil.rmtree(CLI_MESH_DIR, ignore_errors=True)
    return total


def phase_moe_mesh(card: str) -> dict[str, dict[str, int]]:
    """Phase 14: MoE serving on one card, then the transformer's training
    step on a (data, model) mesh and through ``train --tp``; fails on a
    launch at a shape phase 2 did not hold."""
    import torch

    t0 = time.perf_counter()
    out: dict[str, dict[str, int]] = {"moe_serve": {}}
    with launched_shapes() as seen:
        for name, fn in (
                ("a", lambda: phase14_moe_serve(card, out["moe_serve"])),
                ("b", lambda: out.__setitem__("mesh_train",
                                              phase14_mesh_train(card))),
                ("c", lambda: out.__setitem__("mesh_cli",
                                              phase14_cli(card)))):
            t1 = time.perf_counter()
            fn()
            log(f"phase 14{name}: {time.perf_counter() - t1:.1f} s")
            torch.cuda.empty_cache()
    log(f"phase 14: {time.perf_counter() - t0:.1f} s wall [{card}]")
    check_launched("phase 14", seen)
    return out


# -- phase 15 ----------------------------------------------------------------

#: 15a: prompts, their length and new tokens; a rank's prefill BH (its 4
#: rows x 2 heads); the cache rows; the sampled run's key
P15_PROMPTS, P15_PROMPT, P15_NEW = 8, 128, 32
P15_RANK_BH = P15_PROMPTS // 2 * (6 // 3)
P15_TOTAL = P15_PROMPT + P15_NEW
P15_KEY = 7
#: int8 weights' greedy tokens against bf16's, on the layout (the
#: reference's bar, __graft_entry__.py mode 9b)
P15_INT8_AGREE = 0.5
#: 15b: the trainers' widths and recipe (GPT-2-small widths, the byte
#: vocabulary), the one-process run's loss and params bars
P15_SEQ, P15_BATCH, P15_STEPS = 256, 8, 6
P15_REL = 2e-3
P15_DIR = ROOT / ".scratch" / "chip_smoke_phase15"
P15_MODEL = ["--d-model", "768", "--n-layers", "12", "--n-heads", "6",
             "--seq-len", str(P15_SEQ)]


def _p15_parity(tag: str, toks, ref, ref_logits) -> str:
    """The layout's greedy rows against single-device generate's: each row
    identical, or its first mismatch at a near-tie of generate's logits
    there (top-2 gap < NEAR_TIE)."""
    import torch

    notes = []
    for r in range(toks.shape[0]):
        diff = (toks[r, P15_PROMPT:] != ref[r, P15_PROMPT:]).nonzero()
        if not len(diff):
            continue
        i = int(diff[0])
        top2 = torch.topk(ref_logits[i, r].float(), 2).values.tolist()
        gap = top2[0] - top2[1]
        _must(tag, gap < NEAR_TIE,
              f"row {r} leaves single-device generate at new token {i}: "
              f"top-2 gap {gap:.4g} >= {NEAR_TIE}")
        notes.append(f"row {r} near-tie at {i} (gap {gap:.4g})")
    same = toks.shape[0] - len(notes)
    return (f"{same}/{toks.shape[0]} rows identical"
            + (f"; {'; '.join(notes)}" if notes else ""))


def _logit_gap(toks, ref, logits, ref_logits) -> float:
    """max |logit - single-device logit| over each row's new positions up
    to and including its first token mismatch (after it the two runs
    condition on other tokens)."""
    gap = 0.0
    for r in range(toks.shape[0]):
        diff = (toks[r, P15_PROMPT:] != ref[r, P15_PROMPT:]).nonzero()
        end = int(diff[0]) + 1 if len(diff) else P15_NEW
        gap = max(gap, (logits[:end, r].float() - ref_logits[:end, r].float())
                  .abs().max().item())
    return gap


def phase15_mesh_generate(card: str, total: dict) -> None:
    """15a: GPT-2-small (phase 3's geometry, bf16, flash) laid out by
    ``place_transformer_params`` on a (2, 3) mesh over ``["cuda:0"] * 6``,
    bf16 and int8 weights: 8 prompts of 128 tokens, 32 new, greedy, held
    against single-device ``transformer_generate``; the int8 scales'
    layout; int8 against bf16 agreement; #1 once a layer on every rank and
    #3 once a layer, rank and step; a sampled run (T 0.8, top-k 40, one
    key) against single-device generate's, measured; ms a generate."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models.transformer import (
        init_params,
        place_transformer_params,
        quantize_decode_params,
        transformer_generate,
    )
    from deeplearning4j_tpu_torch.parallel.mesh import dp_mp_mesh

    cfg = gpt2s_config()
    base = init_params(cfg, seed=0)
    mesh = dp_mp_mesh(MESH_DP, MESH_TP, ["cuda:0"] * (MESH_DP * MESH_TP))
    prompts = torch.from_numpy(np.random.default_rng(15).integers(
        0, cfg.vocab_size, (P15_PROMPTS, P15_PROMPT))).cuda()
    gen = transformer_generate(cfg)
    ranks = MESH_DP * MESH_TP
    new = {}
    for name in ("bf16", "int8"):
        tag = f"phase 15a {name} weights"
        params = quantize_decode_params(base, cfg) if name == "int8" else base
        laid = place_transformer_params(mesh, params, cfg)
        if name == "int8":
            want = {"wqkv_scale": (None, None, None, "model", None),
                    "wo_scale": (None,) * 4, "w1_scale": (None, None,
                                                          "model"),
                    "w2_scale": (None,) * 3}
            got = {k: laid["blocks"][k].spec for k in want}
            got["head_scale"] = laid["head_scale"].spec
            want["head_scale"] = (None, "model")
            log(f"{tag}: scale layouts {got}")
            _must(tag, got == want, f"scale layouts {got}, the reference's "
                  f"{want}")
        times = {}
        for where, p in (("single device", params), ("(2, 3) layout", laid)):
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            out = gen(p, prompts, P15_NEW, temperature=0.0,
                      return_logits=True)
            torch.cuda.synchronize()
            times[where] = (time.perf_counter() - t0) * 1e3
            launches = read_launches()
            if where == "single device":
                ref, ref_logits = out
            else:
                toks, logits = out
                _add(total, launches)
        log(f"{tag}: launches on the layout {launches}")
        for kname, want_n in (("flash_attn_fwd", cfg.n_layers * ranks),
                              ("flash_decode",
                               cfg.n_layers * ranks * P15_NEW)):
            _must(tag, launches[kname] == want_n,
                  f"{kname} launched {launches[kname]} times, not once a "
                  f"layer on each of the {ranks} ranks ({want_n})")
        log(f"{tag}: greedy on the layout vs single-device generate: "
            f"{_p15_parity(tag, toks, ref, ref_logits)}; max |dlogit| "
            f"{_logit_gap(toks, ref, logits, ref_logits):.6g} up to each "
            f"row's first mismatch; ms a generate "
            f"(8 x {P15_PROMPT} + {P15_NEW}) {times['(2, 3) layout']:.1f} "
            f"on the layout, {times['single device']:.1f} single device "
            f"[{card}]")
        new[name] = toks[:, P15_PROMPT:]
        del laid
    agree = (new["int8"] == new["bf16"]).float().mean().item()
    log(f"phase 15a: int8 vs bf16 greedy tokens on the layout agree "
        f"{agree:.4f} (bar {P15_INT8_AGREE})")
    _must("phase 15a", agree >= P15_INT8_AGREE, "int8 weights diverged")
    laid = place_transformer_params(mesh, base, cfg)
    kw = dict(temperature=SAMPLE_T, top_k=SAMPLE_K, key=P15_KEY)
    got = gen(laid, prompts, P15_NEW, **kw)
    ref = gen(base, prompts, P15_NEW, **kw)
    match = (got[:, P15_PROMPT:] == ref[:, P15_PROMPT:]).float().mean()
    first = (got[:, P15_PROMPT] == ref[:, P15_PROMPT]).sum().item()
    log(f"phase 15a sampled (T {SAMPLE_T}, top-k {SAMPLE_K}, key "
        f"{P15_KEY}): tokens equal to single-device generate's "
        f"{match.item():.4f}, first new token {first}/{P15_PROMPTS} "
        f"(measured: a draw flips where the two programs' logits differ "
        f"by their summation order)")
    del laid, base
    torch.cuda.empty_cache()


def _p15_one_process(card: str, dp: int = MESH_DP, tp: int = MESH_TP,
                     tag: str = "phase 15b"):
    """15b's one-process run: the CLI's model, corpus and batch recipe
    (``default_rng(0)``, batch 8) through ``transformer_train_step`` on
    ``dp_mp_mesh(dp, tp, ["cuda:0"] * (dp * tp))``, (2, 3) by default.
    Returns (losses, params, ms a step over the steps after the first,
    launches)."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch import cli
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig,
        lm_optimizer,
        transformer_train_step,
    )
    from deeplearning4j_tpu_torch.parallel.mesh import dp_mp_mesh

    cfg = TransformerConfig(vocab_size=256, d_model=768, n_heads=6,
                            n_layers=12, d_ff=3072, max_len=P15_SEQ + 1,
                            use_flash=True, compute_dtype=torch.bfloat16)
    mesh = dp_mp_mesh(dp, tp, ["cuda:0"] * (dp * tp))
    step, init_state, shard_tokens = transformer_train_step(
        mesh, cfg, optimizer=lm_optimizer(total_steps=P15_STEPS))
    params, opt_state = init_state(0)
    arr = np.frombuffer(cli._DEMO_TEXT, np.uint8).astype(np.int64)
    rng = np.random.default_rng(0)
    losses, marks = [], []
    reset_launches()
    for _ in range(P15_STEPS):
        starts = rng.integers(0, len(arr) - P15_SEQ - 1, P15_BATCH)
        toks = np.stack([arr[s:s + P15_SEQ + 1] for s in starts])
        params, opt_state, loss = step(params, opt_state, shard_tokens(toks))
        losses.append(float(loss))
        marks.append(time.perf_counter())
    launches = read_launches()
    ms = (marks[-1] - marks[0]) / (P15_STEPS - 1) * 1e3
    log(f"{tag} one process: ({dp}, {tp}) mesh on cuda:0 x {dp * tp}, "
        f"{cfg.d_model}d "
        f"x {cfg.n_layers}L, vocab {cfg.vocab_size}, seq {P15_SEQ}, batch "
        f"{P15_BATCH}, flash, bf16: losses "
        f"{' '.join(f'{x:.4f}' for x in losses)}; {ms:.2f} ms a step "
        f"(steps 2-{P15_STEPS}); launches {launches} [{card}]")
    return losses, params, ms, launches


def _p15_trainers(card: str, ckdir: Path):
    """Two ``train --coordinator`` processes (process 0 with
    ``--status-port 0``), the status REST polled while they run and
    ``status --port`` called on it. Returns both processes' output."""
    import re
    import socket
    import threading

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    argv = ["train", "--model", "transformer", "--coordinator",
            f"127.0.0.1:{port}", "--num-processes", "2", "--tp",
            str(MESH_TP), "--device", "cuda:0", *P15_MODEL, "--batch",
            str(P15_BATCH), "--steps", str(P15_STEPS), "--bf16", "--flash",
            "--checkpoint-dir", str(ckdir), "--checkpoint-backend", "orbax",
            "--save-every", str(P15_STEPS)]
    procs, outs = [], [[], []]
    phases, status_out = [], {}
    found = threading.Event()
    url = {}

    def read(i, proc):
        for line in proc.stdout:
            outs[i].append(line)
            m = re.search(r"status REST on (http://\S+/statetracker)", line)
            if m:
                url["base"] = m.group(1)
                found.set()

    t0 = time.perf_counter()
    try:
        for i in range(2):
            extra = ["--status-port", "0"] if i == 0 else []
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "deeplearning4j_tpu_torch", *argv,
                 "--process-id", str(i), *extra], cwd=ROOT, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        readers = [threading.Thread(target=read, args=(i, p), daemon=True)
                   for i, p in enumerate(procs)]
        for r in readers:
            r.start()
        _must("phase 15b", found.wait(300), "no status REST line")
        while procs[0].poll() is None:
            try:
                with urllib.request.urlopen(url["base"] + "/phase",
                                            timeout=5) as r:
                    ph = json.loads(r.read())
            except (urllib.error.URLError, OSError):
                break
            if not phases or phases[-1] != ph:
                phases.append(ph)
                if ph == "train" and not status_out:
                    status_out["out"] = _cli(
                        "phase 15b status", ["status", "--port",
                                             url["base"].split(":")[2]
                                             .split("/")[0]])[1]
            time.sleep(0.05)
        for p in procs:
            p.wait(timeout=600)
        for r in readers:
            r.join(timeout=60)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = time.perf_counter() - t0
    for i, (p, out) in enumerate(zip(procs, outs)):
        log(f"phase 15b process {i}: exit {p.returncode} in {secs:.1f} s "
            f"(both)")
        for line in out:
            log(f"  | {_printable(line.rstrip())}")
        _must("phase 15b", p.returncode == 0, f"process {i} failed")
    log(f"phase 15b: /statetracker/phase seen {phases}")
    _must("phase 15b", phases[:1] == ["train"] and "done" in phases,
          f"phases {phases}: not train, then done")
    _must("phase 15b", '"phase": "train"' in status_out.get("out", ""),
          "status --port did not print the trainer's state")
    return ["".join(o) for o in outs]


def _rel(a, b) -> float:
    """|a - b| / |b| of two tensors (Frobenius norms, f32)."""
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def phase15_cluster(card: str) -> dict[str, int]:
    """15b and 15c: two trainer processes over gloo on the card against
    the one-process run; the sharded checkpoints (live round trip,
    elastic restore, ``generate --checkpoint-backend orbax``)."""
    import re

    import torch

    from deeplearning4j_tpu_torch.models.transformer import _leaves
    from deeplearning4j_tpu_torch.parallel.checkpoint import (
        AsyncShardedCheckpointManager,
    )

    shutil.rmtree(P15_DIR, ignore_errors=True)
    ckdir = P15_DIR / "two_process"
    total: dict[str, int] = {}
    try:
        outs = _p15_trainers(card, ckdir)
        finals, stats = [], []
        for i, out in enumerate(outs):
            m = re.search(r"^final loss ([0-9.]+)$", out, re.M)
            _must("phase 15b", m is not None, f"process {i}: no final loss")
            finals.append(m.group(1))
            m = re.search(r"one bucket of (\d+) bytes all-reduced a step, "
                          r"(\d+) bytes through the host; ([0-9.]+) ms a "
                          r"step over steps 2-\d+ .*, ([0-9.]+) ms of it in "
                          r"all_reduce_mean; kernel launches flash_attn_fwd "
                          r"(\d+) flash_attn_bwd (\d+)", out)
            _must("phase 15b", m is not None, f"process {i}: no stats line")
            stats.append(m.groups())
            want = P15_STEPS * 12 * MESH_TP
            _must("phase 15b", int(m.group(5)) == want
                  and int(m.group(6)) == want,
                  f"process {i}: #1/#2 launched {m.group(5)}/{m.group(6)} "
                  f"times, not once a layer on each of its {MESH_TP} ranks "
                  f"a step ({want})")
        _must("phase 15b", finals[0] == finals[1],
              f"the processes' final losses differ: {finals}")
        losses, params, ms, launches = _p15_one_process(card)
        _add(total, launches)
        rel = abs(float(finals[0]) - losses[-1]) / abs(losses[-1])
        log(f"phase 15b: final loss {finals[0]} in both processes; one "
            f"process {losses[-1]:.4f}; rel {rel:.3e} (bar {P15_REL}); ms a "
            f"step over steps 2-{P15_STEPS} (host clock, saves left out): "
            f"two processes {stats[0][2]} / {stats[1][2]}, of it in "
            f"all_reduce_mean {stats[0][3]} / {stats[1][3]}; one process "
            f"{ms:.2f}; all-reduced a step {stats[0][0]} bytes, through the "
            f"host {stats[0][1]} [{card}]")
        _must("phase 15b", rel <= P15_REL,
              "the two processes' loss leaves the one-process run's")
        # 15c: the live round trip on the (2, 3) layout
        live = P15_DIR / "live"
        t0 = time.perf_counter()
        mgr = AsyncShardedCheckpointManager(live, keep=1)
        _must("phase 15c", mgr.maybe_save(P15_STEPS, params, {"mode": 11}),
              "save not queued")
        queued = time.perf_counter() - t0
        mgr.wait()
        written = time.perf_counter() - t0
        back, meta = mgr.restore_latest(params)
        restored = time.perf_counter() - t0 - written
        mgr.close()
        held = dict(_leaves(params))
        same = sum(back_leaf.spec == held[path].spec and all(
            torch.equal(a, b) for a, b in zip(back_leaf.flat(),
                                              held[path].flat()))
            for path, back_leaf in _leaves(back))
        log(f"phase 15c live round trip: {same}/{len(held)} leaves bitwise "
            f"with the same spec; meta {meta}; queued in {queued:.3f} s, "
            f"durable after {written:.3f} s, restored in {restored:.3f} s "
            f"[{card}]")
        _must("phase 15c", same == len(held) and meta["mode"] == 11,
              "the live round trip changed a leaf or its layout")
        # the elastic restore: 2 processes wrote it, 1 lays it out on (2, 3)
        mgr = AsyncShardedCheckpointManager(ckdir)
        res = mgr.restore_latest(params)
        mgr.close()
        _must("phase 15c", res is not None, "the trainers wrote nothing")
        el, meta = res
        worst = max((_rel(el_leaf.whole(), held[path].whole()), path)
                    for path, el_leaf in _leaves(el))
        log(f"phase 15c elastic restore (2 processes x (1, 3) -> 1 process "
            f"x (2, 3)): step {meta['step']}; worst leaf {worst[1]} rel "
            f"{worst[0]:.3e} (|a - b| / |b|, bar {P15_REL})")
        _must("phase 15c", int(meta["step"]) == P15_STEPS
              and worst[0] <= P15_REL,
              "the elastic restore leaves the one-process params")
        del params, back, el
        torch.cuda.empty_cache()
        launches, out = _cli("phase 15c generate", [
            "generate", "--checkpoint-dir", str(ckdir),
            "--checkpoint-backend", "orbax", "--temperature", "0"])
        _add(total, launches)
        _must("phase 15c", f"restored step {P15_STEPS} from" in out,
              "no restore line")
    finally:
        shutil.rmtree(P15_DIR, ignore_errors=True)
    return total


def phase_mesh_cluster(card: str) -> dict[str, dict[str, int]]:
    """Phase 15: generate from the training mesh's layout, multi-process
    training on torch.distributed and sharded checkpoints; fails on a
    launch at a shape phase 2 did not hold."""
    import torch

    t0 = time.perf_counter()
    out: dict[str, dict[str, int]] = {"mesh_generate": {}}
    with launched_shapes() as seen:
        for name, fn in (
                ("a", lambda: phase15_mesh_generate(card,
                                                    out["mesh_generate"])),
                ("b-c", lambda: out.__setitem__("cluster",
                                                phase15_cluster(card)))):
            t1 = time.perf_counter()
            fn()
            log(f"phase 15{name}: {time.perf_counter() - t1:.1f} s")
            torch.cuda.empty_cache()
    log(f"phase 15: {time.perf_counter() - t0:.1f} s wall [{card}]")
    check_launched("phase 15", seen)
    return out


# -- phase 16: the DL4J-era core ----------------------------------------------

P16_DIR = ROOT / ".scratch" / "chip_smoke_phase16"
#: the card phase 16 runs on (against the CPU)
P16_DEVICE = "cuda"
#: LeNet's probabilities, card vs CPU from the same carried weights (f32, no
#: TF32: the layers run cuDNN and cuBLAS with TF32 off). The bars lie
#: between f32's readings (5.96e-08 abs, rel 1.02e-07) and TF32's (4.25e-05
#: abs, rel 1.27e-05), and the TF32 control must fail them
P16_PROB_ATOL = 1e-6
#: DataParallelTrainer losses over P16_STEPS steps, card vs CPU
P16_LOSS_RTOL = 1e-6
P16_STEPS = 5
#: Hessian-free on LeNet (its Gauss-Newton products through torch.func):
#: iterations on one batch of 256, card vs CPU from the carried weights;
#: scores and params rel, between f32's readings (1.03e-07, 1.36e-08) and
#: TF32's (7.74e-06, 2.66e-05)
P16_HF_ITERS = 2
P16_HF_RTOL = 1e-6
#: 16a: the CLI at the reference's flags (32 steps of 256), then at
#: bench.py's batch of 1,024
P16_CLI = [["--examples", "4096", "--batch", "256", "--epochs", "2"],
           ["--examples", "8192", "--batch", "1024", "--epochs", "1"]]
#: 16c: the reference's DBN on LFW (BASELINE.md: 600/250/100 hidden RBMs,
#: an MCXENT softmax output) on the synthetic 28x28 faces
P16_DBN_SIZES = (600, 250, 100)
P16_CD_ITERS = 20
P16_FT_ITERS = 10
P16_SOLVER_ITERS = 5


def _p16_lenet_cli(card: str, total: dict) -> None:
    """16a: ``train --model lenet`` through ``cli.main`` on the card."""
    import math
    import re

    import torch

    for flags in P16_CLI:
        # the run's own peak: above what earlier phases still hold
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        launches, out = _cli("phase 16a", ["train", "--model", "lenet",
                                           *flags])
        _add(total, launches)
        peak = (torch.cuda.max_memory_allocated() - held) / 2**20
        steps = [float(v) for v in re.findall(r"^epoch \d+ step \d+ loss "
                                              r"(\S+)$", out, re.M)]
        final = re.search(r"^final loss (\S+)$", out, re.M)
        timing = re.search(r"^([0-9.]+) ms a step over steps (\d+)-(\d+) "
                           r"\(batch (\d+).*\), (\d+) samples/s$", out, re.M)
        _must("phase 16a", final is not None and timing is not None,
              "no final loss or timing line")
        losses = steps + [float(final.group(1))]
        _must("phase 16a", all(math.isfinite(v) for v in losses),
              f"a loss is not finite: {losses}")
        # falling: the last loss under the first printed (step 10), where
        # the run prints one
        _must("phase 16a", len(losses) == 1 or losses[-1] < losses[0],
              f"the loss did not fall: {losses}")
        log(f"phase 16a lenet batch {timing.group(4)}: {timing.group(1)} ms "
            f"a step over steps {timing.group(2)}-{timing.group(3)} (host "
            f"clock, device synced by the loss read each step), "
            f"{timing.group(5)} samples/s; losses {losses}; peak memory "
            f"{peak:.1f} MiB above the {held / 2**20:.1f} MiB held before "
            f"[{card}]")


def _p16_carried():
    """LeNet from seed 0 as the reference's numpy params (the carried
    weights), its config, and 5 batches of synthetic MNIST."""
    from deeplearning4j_tpu_torch.datasets import fetchers
    from deeplearning4j_tpu_torch.models import lenet
    from deeplearning4j_tpu_torch.models.multilayer import params_to_jax

    net, params = lenet.build_lenet(0, device="cpu")
    ds = fetchers.mnist(n=256 * P16_STEPS)
    batches = [(d.features, d.labels) for d in ds.batches(256)]
    return params_to_jax(params, net.conf), net.conf, batches


def _p16_train(np_params, conf, batches, device, policy=None):
    """P16_STEPS DataParallelTrainer steps of LeNet on ``device`` from the
    carried weights: (losses, final params, ms a step over steps 2..N)."""
    import torch

    from deeplearning4j_tpu_torch import dtypes, rng
    from deeplearning4j_tpu_torch.models import lenet
    from deeplearning4j_tpu_torch.models.multilayer import (
        MultiLayerNetwork,
        params_from_jax,
    )
    from deeplearning4j_tpu_torch.parallel.data_parallel import (
        DataParallelTrainer,
    )
    from deeplearning4j_tpu_torch.parallel.mesh import data_parallel_mesh

    net = MultiLayerNetwork(conf, device=device)
    trainer = DataParallelTrainer(lenet.lenet_loss(net),
                                  mesh=data_parallel_mesh(devices=[device]))
    state = trainer.init(params_from_jax(np_params, conf, device=device))
    losses, secs = [], []
    with dtypes.policy(policy or dtypes.FLOAT32):
        for i, (x, y) in enumerate(batches):
            t0 = time.perf_counter()
            state, loss = trainer.step(state, *trainer.shard_batch(x, y),
                                       rng.key_for(i))
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(loss)
    return ([v.item() for v in losses], state.params,
            1e3 * sum(secs[1:]) / max(1, len(secs) - 1))


def _p16_parity(card: str) -> tuple:
    """16b: card vs CPU from the same carried weights, two seeded card runs
    bitwise, TF32 measured, one MIXED_BF16 step."""
    import torch

    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.models.multilayer import (
        MultiLayerNetwork,
        params_from_jax,
    )

    np_params, conf, batches = _p16_carried()
    x = batches[0][0]
    probs = {}
    for dev, policy in ((P16_DEVICE, dtypes.FLOAT32), ("cpu", dtypes.FLOAT32),
                        ("tf32", dtypes.Policy(allow_tf32=True))):
        on = P16_DEVICE if dev == "tf32" else dev
        net = MultiLayerNetwork(conf, params_from_jax(np_params, conf,
                                                      device=on), device=on)
        with dtypes.policy(policy):
            probs[dev] = net.output(x).cpu()
    err = (probs[P16_DEVICE] - probs["cpu"]).abs().max().item()
    err32 = (probs["tf32"] - probs["cpu"]).abs().max().item()
    log(f"phase 16b LeNet probabilities, card vs CPU from the carried "
        f"weights (batch 256): max |a - b| {err:.3e} (bar {P16_PROB_ATOL}); "
        f"with TF32 allowed (the control, must fail the bar) {err32:.3e} "
        f"[{card}]")
    _must("phase 16b", err <= P16_PROB_ATOL, "card and CPU probabilities "
          "differ")
    _must("phase 16b", err32 > P16_PROB_ATOL, "the TF32 control's "
          "probabilities pass the f32 bar: the bar cannot see TF32")
    cpu_losses, _, cpu_ms = _p16_train(np_params, conf, batches, "cpu")
    runs = [_p16_train(np_params, conf, batches, P16_DEVICE) for _ in range(2)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs[0][0], cpu_losses))
    same = runs[0][0] == runs[1][0] and all(
        torch.equal(a, b) for la, lb in zip(runs[0][1], runs[1][1])
        for a, b in zip(la.values(), lb.values()))
    log(f"phase 16b {P16_STEPS} DataParallelTrainer steps (batch 256, SGD "
        f"0.01 momentum 0.9): card {runs[0][0]} vs CPU {cpu_losses}; max "
        f"rel {rel:.3e} (bar {P16_LOSS_RTOL}); two seeded card runs bitwise "
        f"{same}; ms a step over steps 2-{P16_STEPS}: card {runs[0][2]:.3f} "
        f"/ {runs[1][2]:.3f}, CPU {cpu_ms:.3f} [{card}]")
    _must("phase 16b", rel <= P16_LOSS_RTOL, "card losses leave the CPU's")
    _must("phase 16b", same, "two seeded card runs differ")
    tf32, _, tf32_ms = _p16_train(np_params, conf, batches, P16_DEVICE,
                                  dtypes.Policy(allow_tf32=True))
    rel32 = max(abs(a - b) / abs(b) for a, b in zip(tf32, cpu_losses))
    log(f"phase 16b the same steps with TF32 allowed (the control, must "
        f"fail the bar): max rel {rel32:.3e} against the CPU (bar "
        f"{P16_LOSS_RTOL}), {tf32_ms:.3f} ms a step [{card}]")
    _must("phase 16b", rel32 > P16_LOSS_RTOL, "the TF32 control's losses "
          "pass the f32 bar: the bar cannot see TF32")
    _p16_hf(card, np_params, conf, x, batches[0][1])
    bf16, _, bf16_ms = _p16_train(np_params, conf, batches, P16_DEVICE,
                                  dtypes.MIXED_BF16)
    _must("phase 16b", all(v == v for v in bf16), "a MIXED_BF16 loss is NaN")
    log(f"phase 16b MIXED_BF16 steps: losses {bf16}; {bf16_ms:.3f} ms a step "
        f"over steps 2-{P16_STEPS} [{card}]")
    return np_params, conf, runs[0][1]


def _p16_hf(card: str, np_params, conf, x, y) -> None:
    """16b: Hessian-free on LeNet (conv backward through ``torch.func``),
    card vs CPU from the carried weights; the TF32 control must fail the
    bar."""
    import torch

    from deeplearning4j_tpu_torch import dtypes, rng
    from deeplearning4j_tpu_torch.models.multilayer import (
        MultiLayerNetwork,
        params_from_jax,
    )
    from deeplearning4j_tpu_torch.nn import conf as C
    from deeplearning4j_tpu_torch.optimize import solvers
    from deeplearning4j_tpu_torch.optimize.api import ScoreIterationListener

    hf = conf.confs[-1].replace(
        optimization_algo=C.OptimizationAlgorithm.HESSIAN_FREE,
        num_iterations=P16_HF_ITERS)
    runs = {}
    for name, dev, policy in (("card", P16_DEVICE, dtypes.FLOAT32),
                              ("cpu", "cpu", dtypes.FLOAT32),
                              ("tf32", P16_DEVICE,
                               dtypes.Policy(allow_tf32=True))):
        net = MultiLayerNetwork(conf, device=dev)
        model = net._full_model_fns(net._tensor(x), net._tensor(y))
        listener = ScoreIterationListener(1000)
        t0 = time.perf_counter()
        with dtypes.policy(policy):
            params, _, iters = solvers.optimize(
                hf, model, params_from_jax(np_params, conf, device=dev),
                rng.key_for(11), listeners=[listener])
        if dev != "cpu":
            torch.cuda.synchronize()
        runs[name] = (listener.history, params, iters,
                      time.perf_counter() - t0)
    cpu_scores, cpu_params = runs["cpu"][0], runs["cpu"][1]

    def off(name):
        scores, params = runs[name][0], runs[name][1]
        rel = max(abs(a - b) / abs(b) for a, b in zip(scores, cpu_scores))
        num = sum(float(torch.sum((a.cpu() - b) ** 2)) for la, lb in zip(
            params, cpu_params) for a, b in zip(la.values(), lb.values()))
        den = sum(float(torch.sum(b ** 2)) for lb in cpu_params
                  for b in lb.values())
        return rel, (num / den) ** 0.5

    rel, prel = off("card")
    rel32, prel32 = off("tf32")
    log(f"phase 16b Hessian-free on LeNet ({P16_HF_ITERS} iterations, "
        f"batch {x.shape[0]}), card vs CPU from the carried weights: scores card "
        f"{runs['card'][0]} CPU {cpu_scores}, max rel {rel:.3e}, params "
        f"rel {prel:.3e} (bar {P16_HF_RTOL}); TF32 allowed (the control, "
        f"must fail the bar): scores rel {rel32:.3e}, params rel "
        f"{prel32:.3e}; s a solve card {runs['card'][3]:.3f}, CPU "
        f"{runs['cpu'][3]:.3f} [{card}]")
    _must("phase 16b", runs["card"][2] == runs["cpu"][2] == P16_HF_ITERS,
          "Hessian-free ran another number of iterations on the card")
    _must("phase 16b", max(rel, prel) <= P16_HF_RTOL, "Hessian-free on the "
          "card leaves the CPU's")
    _must("phase 16b", max(rel32, prel32) > P16_HF_RTOL, "the TF32 "
          "control's Hessian-free passes the f32 bar: the bar cannot see "
          "TF32")


def _p16_dbn(card: str) -> None:
    """16c: the DBN on LFW: CD-1 pretraining, a CG finetune with full
    backprop, then each solver's ms and host syncs an iteration."""
    import torch

    from deeplearning4j_tpu_torch import rng
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator, fetchers
    from deeplearning4j_tpu_torch.models.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn import conf as C
    from deeplearning4j_tpu_torch.optimize import api, solvers
    from deeplearning4j_tpu_torch.optimize.api import ScoreIterationListener
    from deeplearning4j_tpu_torch.utils import tree_math as tm

    ds = fetchers.lfw()
    base = C.LayerConfig(layer_type="rbm", activation="sigmoid",
                         visible_unit=C.VisibleUnit.BINARY,
                         hidden_unit=C.HiddenUnit.BINARY, lr=0.1, k=1,
                         num_iterations=P16_CD_ITERS,
                         optimization_algo=C.OptimizationAlgorithm.CONJUGATE_GRADIENT)
    mc = C.list_builder(base, sizes=list(P16_DBN_SIZES), n_in=784,
                        n_out=ds.num_outcomes(), hidden_layer_type="rbm",
                        backward=True,
                        overrides={len(P16_DBN_SIZES): lambda c: c.replace(
                            num_iterations=P16_FT_ITERS)})
    net = MultiLayerNetwork(mc, seed=3, device=P16_DEVICE)
    params = net.init()
    it = ListDataSetIterator(ds, ds.num_examples())
    x = net._tensor(ds.features)
    rbm, c0 = net.modules[0], mc.confs[0]
    before = rbm.score(params[0], c0, x, None).item()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.pretrain(it)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    after = rbm.score(net.params[0], c0, x, None).item()
    n_cd = P16_CD_ITERS * len(P16_DBN_SIZES)
    log(f"phase 16c DBN 784-{'-'.join(map(str, P16_DBN_SIZES))}-"
        f"{ds.num_outcomes()} on LFW ({ds.num_examples()} synthetic faces, "
        f"one batch): CD-1 pretraining {n_cd} iterations in {secs:.3f} s, "
        f"{1e3 * secs / n_cd:.3f} ms a CD iteration; layer 0 reconstruction "
        f"score {before:.4f} -> {after:.4f} [{card}]")
    _must("phase 16c", after < before, "pretraining did not lower the "
          "reconstruction score")
    pretrained = tm.tree_map(torch.clone, net.params)
    listener = ScoreIterationListener(1000)
    net.set_listeners([listener])
    s0 = net.score(ds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.finetune(it)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    s1 = net.score(ds)
    log(f"phase 16c CG finetune (full backprop, {len(listener.history)} "
        f"iterations, listener on): score {s0:.4f} -> {s1:.4f}, "
        f"{secs:.3f} s; scores {[round(v, 4) for v in listener.history]} "
        f"[{card}]")
    _must("phase 16c", s1 < s0, "the finetune did not lower the score")
    y = net._tensor(ds.labels)
    model = net._full_model_fns(x, y)
    for algo in (C.OptimizationAlgorithm.GRADIENT_DESCENT,
                 C.OptimizationAlgorithm.CONJUGATE_GRADIENT,
                 C.OptimizationAlgorithm.LBFGS,
                 C.OptimizationAlgorithm.HESSIAN_FREE):
        conf = mc.confs[-1].replace(optimization_algo=algo,
                                    num_iterations=P16_SOLVER_ITERS)

        def run():
            return solvers.optimize(conf, model,
                                    tm.tree_map(torch.clone, pretrained),
                                    rng.key_for(11))

        run()  # warm-up
        torch.cuda.synchronize()
        api.reset_host_syncs()
        t0 = time.perf_counter()
        _, score, iters = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        reads = api.host_syncs
        (_, score2, iters2), syncs, where = _count_syncs(run)
        _must("phase 16c", iters2 == iters and score2.item() == score.item(),
              f"{algo}: the counted run differs")
        log(f"phase 16c solver {algo} on the DBN finetune: {iters} "
            f"iterations, {1e3 * secs / iters:.3f} ms an iteration, "
            f"{reads / iters:.2f} host reads an iteration (api.host_reads), "
            f"{syncs / iters:.2f} CUDA syncs an iteration (sync debug "
            f"mode); score {score.item():.4f} [{card}]")


def _p16_checkpoints(card: str, np_params, conf, trained) -> None:
    """16d: an npz checkpoint written on the card restores bitwise in a
    fresh network; ``to_bytes`` of the card's net holds the CPU net's."""
    import io

    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models.multilayer import (
        MultiLayerNetwork,
        params_from_jax,
    )
    from deeplearning4j_tpu_torch.parallel.checkpoint import CheckpointManager

    shutil.rmtree(P16_DIR, ignore_errors=True)
    try:
        net = MultiLayerNetwork(conf, trained, device=P16_DEVICE)
        mgr = CheckpointManager(P16_DIR)
        mgr.maybe_save(P16_STEPS, net.checkpoint_tree(), {"loss": 0.0})
        fresh = MultiLayerNetwork(conf, device=P16_DEVICE)
        tree, meta = mgr.restore_latest(fresh.checkpoint_tree(fresh.init()),
                                        device=P16_DEVICE)
        fresh.params = fresh.from_checkpoint_tree(tree)
        same = all(torch.equal(a, b) for la, lb in zip(trained, fresh.params)
                   for a, b in zip(la.values(), [lb[k] for k in la]))
        log(f"phase 16d LeNet npz checkpoint on the card -> fresh network: "
            f"bitwise {same}; step {meta['step']}")
        _must("phase 16d", same, "the restored params differ")
        blobs = {}
        for dev in (P16_DEVICE, "cpu"):
            blob = MultiLayerNetwork(conf, params_from_jax(np_params, conf,
                                                           device=dev),
                                     device=dev).to_bytes()
            with np.load(io.BytesIO(blob), allow_pickle=False) as z:
                blobs[dev] = (z["params"], str(z["conf"]))
        equal = (np.array_equal(blobs[P16_DEVICE][0], blobs["cpu"][0])
                 and blobs[P16_DEVICE][1] == blobs["cpu"][1])
        log(f"phase 16d to_bytes card vs CPU from the carried weights: "
            f"params vector ({blobs['cpu'][0].size}) and config equal "
            f"{equal}")
        _must("phase 16d", equal, "to_bytes differs between card and CPU")
    finally:
        shutil.rmtree(P16_DIR, ignore_errors=True)


def phase_dl4j_core(card: str) -> dict[str, dict[str, int]]:
    """Phase 16: LeNet through ``train --model lenet``, card vs CPU, the
    DBN and its solvers, checkpoints; none of it reaches kernels #1-#5."""
    import torch

    t0 = time.perf_counter()
    total: dict[str, int] = {}

    def timed(name, fn):
        t1 = time.perf_counter()
        out = fn()
        log(f"phase 16{name}: {time.perf_counter() - t1:.1f} s")
        torch.cuda.empty_cache()
        return out

    # TF32 on for the whole process, as PyTorch leaves cuDNN out of the
    # box (cuBLAS too): FLOAT32 must hold by the port's own scoping
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = (mm.allow_tf32, dnn.allow_tf32, dnn.deterministic)
    mm.allow_tf32, dnn.allow_tf32, dnn.deterministic = True, True, False
    try:
        timed("a", lambda: _p16_lenet_cli(card, total))  # counts its own
        reset_launches()
        carried = timed("b", lambda: _p16_parity(card))
        timed("c", lambda: _p16_dbn(card))
        timed("d", lambda: _p16_checkpoints(card, *carried))
    finally:
        mm.allow_tf32, dnn.allow_tf32, dnn.deterministic = prev
    _add(total, read_launches())
    _must("phase 16", not any(total.values()),
          f"a kernel of #1-#5 launched on the DL4J-era path: {total}")
    log(f"phase 16: {time.perf_counter() - t0:.1f} s wall [{card}]")
    return {"dl4j_core": {name: total.get(name, 0) for name in KERNELS}}


# -- phase 17: the DL4J nets across devices and processes, and the zoo -------

#: the card phase 17 runs on (against the CPU)
P17_DEVICE = "cuda"
#: 17a: AlexNet through the CLI at the reference's batch of 256 (32 steps)
#: and at 1,024 (24 steps), synthetic CIFAR
P17_CLI = [["--examples", "4096", "--batch", "256", "--epochs", "2"],
           ["--examples", "12288", "--batch", "1024", "--epochs", "2"]]
#: 17a: AlexNet from the carried weights, card vs CPU (16b's bars)
P17_BATCH, P17_STEPS = 128, 5
P17_PROB_ATOL, P17_LOSS_RTOL = 1e-6, 1e-6
#: 17b: ResNet-20 at full width: the reference bench's batch and dtype
P17_RESNET_BATCH, P17_RESNET_STEPS = 1024, 20
#: 17b: one f32 step card vs CPU (batch 128): the loss rel
#: (P17_RESNET_LOSS_RTOL), and leaf by leaf over params and BN state |a -
#: b| <= RTOL * max|b| + ATOL. The BN scales' and biases' gradients are sums
#: over N*H*W = 131,072 terms that nearly cancel, so the card's and the
#: CPU's summation orders leave up to 1.97e-05 between them after one step
#: of lr 0.1 (a scale near 1; 8.3e-06 on a bias near 9e-3, where that is
#: 2.5e-3 of the leaf's max, also with cuDNN off), while the loss agrees to
#: rel 6.6e-08 and the tree to 6.0e-06 by norm; the bar leaves ~6x room over
#: both readings. Sync-BN dp 2 vs dp 1 at the same global batch
P17_RESNET_F32, P17_RESNET_LOSS_RTOL = 128, 1e-5
P17_RESNET_RTOL, P17_RESNET_ATOL = 1e-4, 5e-5
P17_SYNC_TOL = 1e-5
#: 17c: LeNet over two processes against one (unrounded final loss)
P17_PROC_RTOL = 1e-5
P17_LENET = ["--model", "lenet", "--examples", "4096", "--batch", "256",
             "--device", "cuda:0"]
#: 17d: the parallel modes' shapes and bars
P17_PIPE_STAGES, P17_PIPE_WIDTH, P17_PIPE_MICRO, P17_PIPE_MB = 4, 512, 8, 128
P17_PIPE_GRAD_TOL = 1e-6
P17_TP_WIDTHS, P17_TP_BATCH, P17_TP_TOL = (1024, 512, 256), 256, 1e-5
P17_LOCAL_RTOL = 1e-5
P17_LSTM_RANKS, P17_LSTM_T, P17_LSTM_V, P17_LSTM_B = 4, 128, 64, 32
#: 17e: the char-LSTM: 2 epochs on the built text, 50 sampled characters,
#: the device beam against the host oracle
P17_CHAR_EPOCHS, P17_SAMPLE, P17_BEAM_TOL = 2, 50, 1e-5


def p17_text() -> str:
    """The char-LSTM's corpus: 600 words drawn (seed 17) from a fixed list
    of English words, lower case and spaced, with a full stop every 12
    words."""
    import numpy as np

    words = ("the of and to in is was that for it with as his on be at by "
             "had are but from or have an they which one you were her all "
             "she there would their we him been has when who will more no "
             "if out so said what up its about into than them can only "
             "other new some could time these two may then do first any "
             "my now such like our over man me even most made after also "
             "did many before must through back years where much your way "
             "well down should because each just those people how too "
             "little state good very make world still own see men work "
             "long get here between both life being under never day same "
             "another know while last might us great old year off come "
             "since against go came right used take three").split()
    rs = np.random.default_rng(17)
    out = []
    for i, w in enumerate(rs.choice(words, 600)):
        out.append(w + (". " if i % 12 == 11 else " "))
    return "".join(out)


def p17_vocab() -> int:
    """The draw's V in 17e: the text's distinct characters."""
    return len(set(p17_text()))


def _p17_alexnet_cli(card: str, total: dict) -> None:
    """17a: ``train --model alexnet`` through ``cli.main`` on the card."""
    import math
    import re

    import torch

    for flags in P17_CLI:
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        launches, out = _cli("phase 17a", ["train", "--model", "alexnet",
                                           *flags])
        _add(total, launches)
        peak = (torch.cuda.max_memory_allocated() - held) / 2**20
        steps = [float(v) for v in re.findall(r"^epoch \d+ step \d+ loss "
                                              r"(\S+)$", out, re.M)]
        final = re.search(r"^final loss (\S+)$", out, re.M)
        timing = re.search(r"^([0-9.]+) ms a step over steps (\d+)-(\d+) "
                           r"\(batch (\d+).*\), (\d+) samples/s$", out, re.M)
        _must("phase 17a", final is not None and timing is not None,
              "no final loss or timing line")
        losses = steps + [float(final.group(1))]
        _must("phase 17a", all(math.isfinite(v) for v in losses),
              f"a loss is not finite: {losses}")
        _must("phase 17a", len(losses) > 1 and losses[-1] < losses[0],
              f"the loss did not fall: {losses}")
        log(f"phase 17a alexnet batch {timing.group(4)}: {timing.group(1)} "
            f"ms a step over steps {timing.group(2)}-{timing.group(3)} (host "
            f"clock, device synced by the loss read each step), "
            f"{timing.group(5)} samples/s; losses {losses}; peak memory "
            f"{peak:.1f} MiB above the {held / 2**20:.1f} MiB held before "
            f"[{card}]")


def _p17_alexnet_train(np_params, conf, x, y, device):
    """P17_STEPS DataParallelTrainer steps of AlexNet on one batch from
    the carried weights: (losses, params)."""
    from deeplearning4j_tpu_torch import rng
    from deeplearning4j_tpu_torch.models import lenet
    from deeplearning4j_tpu_torch.models.multilayer import (
        MultiLayerNetwork,
        params_from_jax,
    )
    from deeplearning4j_tpu_torch.parallel.data_parallel import (
        DataParallelTrainer,
    )
    from deeplearning4j_tpu_torch.parallel.mesh import data_parallel_mesh

    net = MultiLayerNetwork(conf, device=device)
    trainer = DataParallelTrainer(lenet.lenet_loss(net),
                                  mesh=data_parallel_mesh(devices=[device]))
    state = trainer.init(params_from_jax(np_params, conf, device=device))
    losses = []
    for i in range(P17_STEPS):
        state, loss = trainer.step(state, *trainer.shard_batch(x, y),
                                   rng.key_for(i))
        losses.append(loss)
    return [v.item() for v in losses], state.params


def _p17_alexnet_parity(card: str) -> None:
    """17a: AlexNet from its seed-0 weights carried as the reference's
    numpy arrays: card vs CPU probabilities and 5 trainer steps, two
    seeded card runs bitwise."""
    import torch

    from deeplearning4j_tpu_torch.models import alexnet
    from deeplearning4j_tpu_torch.models.multilayer import (
        MultiLayerNetwork,
        params_from_jax,
        params_to_jax,
    )

    net, params = alexnet.build_alexnet(0, device="cpu")
    np_params, conf = params_to_jax(params, net.conf), net.conf
    ds = alexnet.synthetic_cifar(P17_BATCH, seed=1)
    card_probs, cpu_probs = (MultiLayerNetwork(conf, params_from_jax(
        np_params, conf, device=dev), device=dev).output(ds.features).cpu()
        for dev in (P17_DEVICE, "cpu"))
    err = (card_probs - cpu_probs).abs().max().item()
    cpu, _ = _p17_alexnet_train(np_params, conf, ds.features, ds.labels,
                                "cpu")
    runs = [_p17_alexnet_train(np_params, conf, ds.features, ds.labels,
                               P17_DEVICE) for _ in range(2)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs[0][0], cpu))
    same = runs[0][0] == runs[1][0] and all(
        torch.equal(a, b) for la, lb in zip(runs[0][1], runs[1][1])
        for a, b in zip(la.values(), lb.values()))
    log(f"phase 17a AlexNet from the carried weights (batch {P17_BATCH}): "
        f"probabilities card vs CPU max |a - b| {err:.3e} (bar "
        f"{P17_PROB_ATOL}); {P17_STEPS} trainer steps card {runs[0][0]} vs "
        f"CPU {cpu}: max rel {rel:.3e} (bar {P17_LOSS_RTOL}); two seeded card "
        f"runs bitwise {same} [{card}]")
    _must("phase 17a", err <= P17_PROB_ATOL, "card and CPU probabilities "
          "differ")
    _must("phase 17a", rel <= P17_LOSS_RTOL, "card losses leave the CPU's")
    _must("phase 17a", same, "two seeded card runs differ")


def _p17_resnet(card: str) -> None:
    """17b: ResNet-20 at full width on synthetic CIFAR: MIXED_BF16 steps at
    the bench's batch, one f32 step card vs CPU, sync-BN dp 2 vs dp 1."""
    import math

    import torch

    from deeplearning4j_tpu_torch import dtypes, rng
    from deeplearning4j_tpu_torch.device import synchronize
    from deeplearning4j_tpu_torch.models import resnet
    from deeplearning4j_tpu_torch.models.alexnet import synthetic_cifar
    from deeplearning4j_tpu_torch.parallel.data_parallel import SGD
    from deeplearning4j_tpu_torch.parallel.mesh import data_parallel_mesh
    from deeplearning4j_tpu_torch.utils import tree_math as tm

    cfg = resnet.ResNetConfig()  # ResNet-20: 3 blocks a stage, 16/32/64
    ds = synthetic_cifar(P17_RESNET_BATCH, seed=2)
    x = ds.features.reshape(-1, 32, 32, 3)
    y = ds.labels
    step, init = resnet.resnet_train_step(cfg, device=P17_DEVICE)
    with dtypes.policy(dtypes.MIXED_BF16):
        params, state, opt = init(rng.key_for(0))
        xd, yd = (torch.from_numpy(a).to(P17_DEVICE) for a in (x, y))
        losses, secs = [], []
        for _ in range(P17_RESNET_STEPS):
            t0 = time.perf_counter()
            params, state, opt, loss = step(params, state, opt, xd, yd)
            synchronize(torch.device(P17_DEVICE))
            secs.append(time.perf_counter() - t0)
            losses.append(loss.item())
    ms = 1e3 * sum(secs[1:]) / (len(secs) - 1)
    log(f"phase 17b ResNet-20 MIXED_BF16 batch {P17_RESNET_BATCH}: "
        f"{ms:.3f} ms a step over steps 2-{P17_RESNET_STEPS} (host clock, "
        f"device synced), {1e3 * P17_RESNET_BATCH / ms:.0f} samples/s; "
        f"losses {[round(v, 4) for v in losses]} [{card}]")
    _must("phase 17b", all(math.isfinite(v) for v in losses),
          "a MIXED_BF16 loss is not finite")
    _must("phase 17b", losses[-1] < losses[0], "the loss did not fall")
    # one f32 step, card vs CPU, from the same init (drawn on the CPU)
    p0, s0 = resnet.init_resnet(rng.key_for(1), cfg, device="cpu")
    xb, yb = x[:P17_RESNET_F32], y[:P17_RESNET_F32]
    card_out, cpu_out = (
        tm.tree_map(lambda t: t.cpu(), resnet.resnet_train_step(
            cfg, device=dev)[0](*tm.tree_map(lambda t: t.to(dev), (p0, s0)),
                                SGD(0.1, 0.9).init(tm.tree_map(
                                    lambda t: t.to(dev), p0)), xb, yb))
        for dev in (P17_DEVICE, "cpu"))
    rel = abs(card_out[3].item() - cpu_out[3].item()) / abs(
        cpu_out[3].item())
    pairs = list(zip(tm.leaves(card_out[:2]), tm.leaves(cpu_out[:2])))
    # each leaf's |a - b| over its allowance (<= 1 passes)
    worst = max(((a - b).abs().max() / (P17_RESNET_RTOL * b.abs().max()
                                        + P17_RESNET_ATOL)).item()
                for a, b in pairs)
    maxabs = max((a - b).abs().max().item() for a, b in pairs)
    flat = [torch.cat([t.reshape(-1) for t in ts]) for ts in zip(*pairs)]
    norm = ((flat[0] - flat[1]).norm() / flat[1].norm()).item()
    log(f"phase 17b ResNet-20 f32 batch {P17_RESNET_F32}, one step card vs "
        f"CPU: loss {card_out[3].item()!r} vs {cpu_out[3].item()!r} "
        f"(rel {rel:.3e}, bar {P17_RESNET_LOSS_RTOL}); params and BN state "
        f"max |a - b| {maxabs:.3e}, the worst leaf at {worst:.3f} of its "
        f"allowance ({P17_RESNET_RTOL} max|b| + {P17_RESNET_ATOL}), the tree "
        f"by norm rel {norm:.3e} [{card}]")
    _must("phase 17b", rel <= P17_RESNET_LOSS_RTOL and worst <= 1.0,
          "the card's step leaves the CPU's")
    # sync-BN: dp 2 on one card against dp 1 at the same global batch
    sync = {}
    for dp in (1, 2):
        st, _ = resnet.resnet_train_step(cfg, mesh=data_parallel_mesh(
            devices=[P17_DEVICE] * dp))
        p, s = tm.tree_map(lambda t: t.to(P17_DEVICE), (p0, s0))
        sync[dp] = st(p, s, SGD(0.1, 0.9).init(p), xb, yb)
    lrel = abs(sync[2][3].item() - sync[1][3].item()) / abs(
        sync[1][3].item())
    srel = max((a - b).abs().max().item() for a, b in zip(
        tm.leaves(sync[2][1]), tm.leaves(sync[1][1])))
    log(f"phase 17b sync-BN dp 2 on [cuda:0] * 2 vs dp 1 (batch "
        f"{P17_RESNET_F32}): loss rel {lrel:.3e}, BN state max |a - b| "
        f"{srel:.3e} (bar {P17_SYNC_TOL}) [{card}]")
    _must("phase 17b", lrel <= P17_SYNC_TOL and srel <= P17_SYNC_TOL,
          "sync-BN over two ranks leaves the one-rank step")


def _p17_lenet_processes(card: str, total: dict) -> None:
    """17c: two ``train --model lenet --coordinator`` processes over gloo on
    the card against the one-process run."""
    import re
    import socket

    launches, one = _cli("phase 17c one process", ["train", *P17_LENET])
    _add(total, launches)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs, outs = [], []
    t0 = time.perf_counter()
    try:
        for i in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "deeplearning4j_tpu_torch", "train",
                 *P17_LENET, "--coordinator", f"127.0.0.1:{port}",
                 "--num-processes", "2", "--process-id", str(i)], cwd=ROOT,
                text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = time.perf_counter() - t0

    def final(text):
        m = re.search(r"^final loss unrounded (\S+)$", text, re.M)
        return float(m.group(1)) if m else float("nan")

    want = final(one)
    for i, (p, out) in enumerate(zip(procs, outs)):
        log(f"phase 17c process {i}: exit {p.returncode} in {secs:.1f} s "
            f"(both)")
        for line in out.splitlines():
            log(f"  | {_printable(line)}")
        _must("phase 17c", p.returncode == 0, f"process {i} failed")
        rel = abs(final(out) - want) / abs(want)
        log(f"phase 17c process {i}: final loss {final(out)!r} vs one "
            f"process {want!r}: rel {rel:.3e} (bar {P17_PROC_RTOL}) [{card}]")
        _must("phase 17c", rel <= P17_PROC_RTOL,
              "two processes' loss leaves the one-process run's")


def _p17_pipeline(card: str) -> None:
    import torch

    from deeplearning4j_tpu_torch.parallel import pipeline_parallel as pp
    from deeplearning4j_tpu_torch.parallel.data_parallel import SGD
    from deeplearning4j_tpu_torch.utils import tree_math as tm

    n, d = P17_PIPE_STAGES, P17_PIPE_WIDTH
    dev = P17_DEVICE
    gen = torch.Generator(device=dev).manual_seed(1700)
    stages = [{"w": torch.randn((d, d), generator=gen, device=dev)
               / d ** 0.5, "b": torch.randn((d,), generator=gen,
                                            device=dev) * 0.1}
              for _ in range(n)]

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    mesh = pp.pipeline_mesh(n, devices=[dev] * n)
    x = torch.randn((P17_PIPE_MICRO, P17_PIPE_MB, d), generator=gen,
                    device=dev)
    tgt = torch.randn(x.shape, generator=gen, device=dev)
    stacked = tm.tree_map(lambda a: a.requires_grad_(True),
                          pp.stack_stage_params(stages))
    y = pp.pipeline_apply(mesh, stage_fn)(stacked, x)
    seq = []
    for m in range(P17_PIPE_MICRO):
        h = x[m]
        for s in range(n):
            h = stage_fn(tm.tree_map(lambda a: a[s], stacked), h)
        seq.append(h)
    seq = torch.stack(seq)
    bitwise = torch.equal(y, seq)
    g_pipe = torch.autograd.grad(((y - tgt) ** 2).mean(),
                                 list(stacked.values()))
    g_seq = torch.autograd.grad(((seq - tgt) ** 2).mean(),
                                list(stacked.values()))
    gerr = max((a - b).abs().max().item() for a, b in zip(g_pipe, g_seq))
    head = {"w": torch.zeros((d, 4), device=dev),
            "b": torch.zeros((4,), device=dev)}
    labels = torch.eye(4, device=dev)[torch.randint(
        0, 4, (P17_PIPE_MICRO, P17_PIPE_MB), generator=gen, device=dev)]

    def head_loss(hp, h, yy):
        logits = h @ hp["w"] + hp["b"]
        return -(yy * torch.log_softmax(logits, dim=-1)).sum(-1).mean()

    step, opt_init, place = pp.pipeline_train_step(mesh, stage_fn, head_loss,
                                                   SGD(0.05, momentum=0.9))
    params = place((pp.stack_stage_params([tm.tree_map(
        lambda a: a.detach(), s) for s in stages]), head))
    opt = opt_init(params)
    losses = []
    for _ in range(5):
        params, opt, loss = step(params, opt, x, labels)
        losses.append(loss.item())
    log(f"phase 17d pipeline {n} stages on [cuda:0] * {n}, width {d}, "
        f"{P17_PIPE_MICRO} microbatches of {P17_PIPE_MB}: output bitwise the "
        f"sequential stack's (microbatch by microbatch) {bitwise}; gradients "
        f"max |a - b| {gerr:.3e} (bar {P17_PIPE_GRAD_TOL}); 5 train steps "
        f"{[round(v, 5) for v in losses]} [{card}]")
    _must("phase 17d", bitwise, "the pipeline's output is not the stack's")
    _must("phase 17d", gerr <= P17_PIPE_GRAD_TOL, "pipeline gradients differ")
    _must("phase 17d", losses[-1] < losses[0], "the pipeline loss did not "
          "fall")


def _p17_tp(card: str) -> None:
    import torch

    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.parallel import tensor_parallel as tp
    from deeplearning4j_tpu_torch.parallel.mesh import model_parallel_mesh

    d_in, hidden, d_out = P17_TP_WIDTHS
    gen = torch.Generator(device=P17_DEVICE).manual_seed(1701)
    w1, b1, w2, b2 = (torch.randn(s, generator=gen, device=P17_DEVICE)
                      * 0.05 for s in ((d_in, hidden), (hidden,),
                                       (hidden, d_out), (d_out,)))
    x = torch.randn((P17_TP_BATCH, d_in), generator=gen, device=P17_DEVICE)
    mesh = model_parallel_mesh(2, devices=[P17_DEVICE] * 2)
    y = tp.tp_mlp_block(mesh, torch.relu)(x, *tp.shard_dense_params(
        mesh, w1, b1, w2, b2))
    with dtypes.precision():
        ref = torch.relu(x @ w1 + b1) @ w2 + b2
    err = (y - ref).abs().max().item()
    log(f"phase 17d tp_mlp_block tp 2 on [cuda:0] * 2 at {d_in} -> {hidden} "
        f"-> {d_out} (relu, batch {P17_TP_BATCH}) vs the dense block: max "
        f"|a - b| {err:.3e} (bar {P17_TP_TOL}); psums {mesh.psums} [{card}]")
    _must("phase 17d", err <= P17_TP_TOL and mesh.psums == 1,
          "the TP block leaves the dense block")


def _p17_local_sgd(card_line: str) -> None:
    import torch

    from deeplearning4j_tpu_torch import rng
    from deeplearning4j_tpu_torch.datasets import fetchers
    from deeplearning4j_tpu_torch.models import lenet
    from deeplearning4j_tpu_torch.parallel.data_parallel import (
        local_sgd_step,
        replica_consensus,
    )
    from deeplearning4j_tpu_torch.parallel.mesh import data_parallel_mesh
    from deeplearning4j_tpu_torch.utils import tree_math as tm

    ds = fetchers.mnist(n=512)
    out = []
    for dev in (P17_DEVICE, "cpu"):
        net, params = lenet.build_lenet(0, device=dev)
        step = local_sgd_step(lenet.lenet_loss(net), data_parallel_mesh(
            devices=[dev] * 2), local_steps=2, lr=0.05)
        x, y = (torch.from_numpy(a).to(dev) for a in (ds.features,
                                                      ds.labels))
        losses = []
        for i in range(3):
            params, loss = step(params, x, y, rng.key_for(i))
            losses.append(loss.item())
        stacked = tm.tree_map(lambda *ts: torch.stack(ts), *step.replicas)
        out.append((losses, params, replica_consensus(stacked).item()))
    card, cpu = out
    rel = max(abs(a - b) / abs(b) for a, b in zip(card[0], cpu[0]))
    prel = max(((a.cpu() - b).norm() / b.norm()).item() for a, b in zip(
        tm.leaves(card[1]), tm.leaves(cpu[1])))
    log(f"phase 17d local_sgd_step LeNet dp 2 on [cuda:0] * 2, 2 local "
        f"steps, 3 rounds (batch 512): losses {card[0]} vs CPU {cpu[0]}, "
        f"max rel {rel:.3e}, params rel {prel:.3e} (bar {P17_LOCAL_RTOL}); "
        f"replica_consensus {card[2]} [{card_line}]")
    _must("phase 17d", rel <= P17_LOCAL_RTOL and prel <= P17_LOCAL_RTOL,
          "local SGD on the card leaves the CPU's")
    _must("phase 17d", card[2] == 0.0, "the replicas differ after "
          "averaging")


def _p17_lstm(card: str) -> None:
    import torch

    from deeplearning4j_tpu_torch import rng
    from deeplearning4j_tpu_torch.nn import conf as C
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.parallel.mesh import data_parallel_mesh
    from deeplearning4j_tpu_torch.parallel.sequence_parallel import (
        sequence_sharded_lstm,
    )

    v = P17_LSTM_V
    cfg = C.LayerConfig(layer_type="lstm", n_in=v, n_out=v, activation="tanh")
    mod = L.get("lstm")
    params = mod.init(rng.key_for(17), cfg, device=P17_DEVICE)
    x = rng.normal(rng.key_for(18), (P17_LSTM_B, P17_LSTM_T, v),
                   device=P17_DEVICE)
    with torch.no_grad():
        hs, cs = sequence_sharded_lstm(data_parallel_mesh(
            devices=[P17_DEVICE] * P17_LSTM_RANKS), mod, cfg)(params, x)
        hr, cr = mod.scan_hidden(params, cfg, x)
    same = torch.equal(hs, hr) and torch.equal(cs, cr)
    log(f"phase 17d sequence_sharded_lstm over {P17_LSTM_RANKS} ranks at T "
        f"{P17_LSTM_T} (B {P17_LSTM_B}, hidden {v}): bitwise scan_hidden "
        f"{same} [{card}]")
    _must("phase 17d", same, "the sharded LSTM leaves scan_hidden")


def _p17_char_lstm(card: str) -> None:
    """17e: the char-LSTM on the card: fit, sample (the draw kernel at R 1,
    V the vocabulary), the device beam against the host oracle."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.device import synchronize
    from deeplearning4j_tpu_torch.models.char_lstm import CharLSTM

    text = p17_text()
    m = CharLSTM(seed=0, device=P17_DEVICE)
    t0 = time.perf_counter()
    losses = m.fit(text, epochs=P17_CHAR_EPOCHS)
    synchronize(m.device)
    ms = 1e3 * (time.perf_counter() - t0) / P17_CHAR_EPOCHS
    sample = m.sample("t", length=P17_SAMPLE, temperature=0.8, rng_seed=1)
    emb = torch.eye(len(m.chars), device=P17_DEVICE)
    seed = emb[m.char_to_ix["t"]]
    dev = m.mod.beam_search(m.params, m.conf, seed, emb, beam_size=4,
                            n_steps=12)
    host = m.mod.beam_search_host(m.params, m.conf, seed, emb, beam_size=4,
                                  n_steps=12)
    same = [t for t, _ in dev] == [t for t, _ in host]
    err = max(abs(a - b) for (_, a), (_, b) in zip(dev, host))
    log(f"phase 17e char-LSTM ({len(text)} chars, V {len(m.chars)}, seq "
        f"{m.seq_len}, batch 16): epoch losses {losses}, {ms:.1f} ms an "
        f"epoch; sample {sample!r}; device beam (W 4, 12 steps) vs host "
        f"oracle: tokens equal {same}, scores max |a - b| {err:.3e} (bar "
        f"{P17_BEAM_TOL}) [{card}]")
    _must("phase 17e", bool(np.isfinite(losses).all())
          and losses[-1] < losses[0], f"the loss did not fall: {losses}")
    _must("phase 17e", len(sample) == P17_SAMPLE + 1
          and set(sample) <= set(text), "the sample is not of the text")
    _must("phase 17e", same and err <= P17_BEAM_TOL,
          "the device beam leaves the host oracle")


def phase_dl4j_parallel(card: str) -> dict[str, dict[str, int]]:
    """Phase 17: AlexNet, ResNet-20 and the char-LSTM, LeNet over two
    processes, the pipeline, TP, local SGD and the sequence-sharded LSTM;
    kernels #1-#5 launch 0 times, the draw in 17e's sampling."""
    import torch

    from deeplearning4j_tpu_torch.ops import threefry

    t0 = time.perf_counter()
    total: dict[str, int] = {}

    def timed(name, fn):
        t1 = time.perf_counter()
        fn()
        log(f"phase 17{name}: {time.perf_counter() - t1:.1f} s")
        torch.cuda.empty_cache()

    timed("a cli", lambda: _p17_alexnet_cli(card, total))  # counts its own
    timed("c", lambda: _p17_lenet_processes(card, total))  # counts its own
    reset_launches()
    timed("a parity", lambda: _p17_alexnet_parity(card))
    timed("b", lambda: _p17_resnet(card))
    timed("d", lambda: (_p17_pipeline(card), _p17_tp(card),
                        _p17_local_sgd(card), _p17_lstm(card)))
    draws = threefry.launches
    timed("e", lambda: _p17_char_lstm(card))
    sampled = threefry.launches - draws
    _add(total, read_launches())
    log(f"phase 17: launches {total}; the draw {sampled} times in 17e's "
        f"sampling (R 1, V {p17_vocab()})")
    _must("phase 17", not any(total[k] for k in KERNELS
                              if k != "threefry_draw"),
          f"a kernel of #1-#5 launched on the DL4J nets' path: {total}")
    _must("phase 17", sampled == P17_SAMPLE and total["threefry_draw"]
          == P17_SAMPLE, f"the draw launched {sampled} times in sampling, "
          f"{total['threefry_draw']} in the phase")
    log(f"phase 17: {time.perf_counter() - t0:.1f} s wall [{card}]")
    return {"dl4j_parallel": {name: total.get(name, 0) for name in KERNELS}}


# -- phase 18 ----------------------------------------------------------------

#: 18a: the data ranks of Word2Vec.fit_distributed (one card, repeated)
P18_RANKS = (2, 4)
#: 18a's sentences (phase 6's corpus cut from 4,000 to 500, and to 250 for
#: the seeded repeat, to keep the phase's time; the vocabulary is the whole
#: corpus's, so the widths and the longest Huffman path are phase 6's)
P18_W2V_SENTENCES, P18_W2V_REPEAT_SENTENCES = 500, 250
#: the card-vs-CPU runs of 18a (the first sentences, at least
#: P18_CPU_BATCHES batches at 2 ranks) and of 18b (the first batches)
P18_W2V_CPU_SENTENCES = 7
P18_CPU_BATCHES = 8
#: 18b: the reference's GloVe defaults, 2 epochs on the first 1,000 of
#: phase 6's 4,000 sentences (cut to keep the script's time with phases 21
#: and 22); the seeded repeat and the 2-rank fit take 1 epoch on its first
#: 500 sentences (the phase's time)
P18_GLOVE = dict(layer_size=50, window=5, x_max=100.0, alpha=0.75, lr=0.05,
                 batch=4096, epochs=2)
P18_GLOVE_SENTENCES = 1000
P18_GLOVE_SUB_SENTENCES = 500
#: GloVe card vs CPU after the first batches, of each table's largest entry
P18_GLOVE_RTOL = 1e-5
#: 18c: the RNTN paper's width with the tensor (Socher et al. 2013) and
#: CoreNLP's sentiment trainer's batch; 1,000 synthetic 5-class trees of
#: 8-20 words (the simplified model; cut from 2,000 for the script's
#: time), the bundled treebank (untied)
P18_RNTN_DIM, P18_RNTN_BATCH, P18_RNTN_EPOCHS = 25, 27, 2
P18_RNTN_TREES, P18_RNTN_CLASSES = 1000, 5
#: the first step on the card vs the CPU: the loss (rel) and each gradient
#: leaf (of its largest |g|)
P18_RNTN_TOL = 1e-5
#: 18d: on 18b's vectors
P18_PCA_WORDS, P18_PCA_DIMS, P18_PCA_RTOL = 2000, 10, 1e-4
P18_KMEANS_K, P18_KMEANS_TIE = 20, 1e-5
P18_TSNE_WORDS, P18_TSNE_ITERS, P18_TSNE_CHECK = 1000, 500, 10
#: the first t-SNE iterations, card vs CPU: within this of the map's
#: largest coordinate, or within P18_TSNE_ULPS_X times what one ulp in y0
#: moves the CPU run itself (t-SNE is chaotic; tests/test_torch_viz_
#: clustering.py)
P18_TSNE_RTOL, P18_TSNE_ULPS_X = 1e-4, 10
#: 18e: the served GloVe demo vs the CPU demo model
P18_EMBED_TOL = 1e-5
P18_DIR = ROOT / ".scratch" / "chip_smoke_phase18"
#: the card (and each data rank's view of it)
P18_DEVICE, P18_RANK_DEVICE = "cuda", "cuda:0"


def p18_emb_dot_keys(model) -> list[tuple[int, int, int]]:
    """(B, L, D) of #5's fused launches in 18a: a rank's share of a batch
    of 4,096 pairs, over the full vocabulary's longest Huffman path."""
    L = model.cache.max_code_length
    return [(W2V_BATCH // n, L, W2V_DIM) for n in P18_RANKS]


def _p18_w2v_model(src, device):
    """A full-width Word2Vec with phase 6's vocabulary, its table drawn
    from the seed on ``device``."""
    from deeplearning4j_tpu_torch.models.word2vec import Word2Vec

    m = Word2Vec(layer_size=W2V_DIM, window=W2V_WINDOW,
                 batch_pairs=W2V_BATCH, lr=W2V_LR, device=device)
    m.cache = src.cache
    m._codes, m._points, m._mask = src._codes, src._points, src._mask
    m.reset_weights()
    return m


def _p18_w2v_fit(src, sents, n: int, device=None):
    """fit_distributed over ``n`` ranks on ``device``: (model, pairs
    enumerated, seconds on the host clock, launches)."""
    import torch

    from deeplearning4j_tpu_torch.nlp.sentence_iterator import (
        CollectionSentenceIterator,
    )
    from deeplearning4j_tpu_torch.parallel.mesh import data_parallel_mesh

    device = device or P18_DEVICE
    dev = P18_RANK_DEVICE if device == P18_DEVICE else device
    m = _p18_w2v_model(src, device)
    mesh = data_parallel_mesh(devices=[dev] * n)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    pairs = _count_pairs(lambda: m.fit_distributed(
        CollectionSentenceIterator(sents), mesh=mesh))
    torch.cuda.synchronize()
    return m, pairs, time.perf_counter() - t0, read_launches()


def p18_word2vec(card: str, src, corpus, runs: dict) -> None:
    """18a: Word2Vec.fit_distributed at phase 6's width over 2 and 4 data
    ranks: pairs/s, ms a batch, #5's launches exactly batches x ranks, the
    tables bounded; two seeded card runs bitwise; at least 8 batches card
    vs CPU."""
    import torch

    sents = corpus[:P18_W2V_SENTENCES]
    for n in P18_RANKS:
        tag = f"phase 18a w2v fit_distributed over {n} ranks"
        m, pairs, secs, launches = _p18_w2v_fit(src, sents, n)
        b = W2V_BATCH - W2V_BATCH % n
        batches = pairs // b
        top = _bounded(tag, m)
        log(f"{tag}: {len(sents)} sentences, V {len(m.cache)}, max code "
            f"length {m.cache.max_code_length}, {pairs} pairs, {batches} "
            f"batches of {b} ({b // n} a rank); {secs:.2f} s -> "
            f"{batches * b / secs:.1f} pairs/s trained, "
            f"{secs * 1e3 / max(batches, 1):.3f} ms a batch (host clock, "
            f"tokenizing and pair enumeration included); #5 launches "
            f"{launches['emb_dot']} (batches x ranks {batches * n}); max "
            f"|syn0| {top:.4f} [{card}]")
        _must(tag, launches["emb_dot"] == batches * n,
              f"#5 launched {launches['emb_dot']} times, not {batches * n}")
        runs[f"w2v_dist_{n}"] = launches
        del m
    tag = "phase 18a repeat"
    rep = corpus[:P18_W2V_REPEAT_SENTENCES]
    one, _, _, runs["w2v_dist_repeat"] = _p18_w2v_fit(src, rep, P18_RANKS[0])
    two, _, _, again = _p18_w2v_fit(src, rep, P18_RANKS[0])
    _add(runs["w2v_dist_repeat"], again)
    bitwise = all(torch.equal(getattr(one, k), getattr(two, k))
                  for k in ("syn0", "syn1"))
    del one, two
    sub = corpus[:P18_W2V_CPU_SENTENCES]
    card_m, pairs, _, runs["w2v_dist_cpu"] = _p18_w2v_fit(src, sub,
                                                         P18_RANKS[0])
    host_m, _, _, _ = _p18_w2v_fit(src, sub, P18_RANKS[0], device="cpu")
    batches = pairs // (W2V_BATCH - W2V_BATCH % P18_RANKS[0])
    _must(tag, runs["w2v_dist_cpu"]["emb_dot"] == batches * P18_RANKS[0],
          f"#5 launched {runs['w2v_dist_cpu']['emb_dot']} times, not "
          f"{batches * P18_RANKS[0]}")
    errs = {k: (getattr(card_m, k).cpu() - getattr(host_m, k)).abs().max()
            .item() for k in ("syn0", "syn1")}
    log(f"{tag}: two seeded card runs over {P18_RANKS[0]} ranks "
        f"({len(rep)} sentences) bitwise {bitwise}; card vs CPU over "
        f"{P18_RANKS[0]} ranks from the same tables, {len(sub)} sentences, "
        f"{batches} batches: max |card - cpu| syn0 {errs['syn0']:.3e}, syn1 "
        f"{errs['syn1']:.3e} (tol {W2V_TOL}) [{card}]")
    _must(tag, bitwise, "two seeded card runs differ")
    _must(tag, batches >= P18_CPU_BATCHES,
          f"{batches} batches, fewer than {P18_CPU_BATCHES}")
    _must(tag, max(errs.values()) <= W2V_TOL, "the card left the CPU")


def _p18_glove_batches(model, data, k: int):
    """The first ``k`` batches of a GloVe fit's first epoch (the model's
    permutation from its seed) by ``_glove_math``, from the model's
    initial tables; returns the four merged tables ([w | b], [wc | bc] and
    their accumulators)."""
    import numpy as np

    from deeplearning4j_tpu_torch.device import upload
    from deeplearning4j_tpu_torch.models import glove as glove_mod

    rows, cols, vals = data
    logx, fx = model._init_weights(vals)
    dev = model.device
    arrays = [upload(np.ascontiguousarray(a, dt), dev) for a, dt in
              ((rows, np.int64), (cols, np.int64), (logx, np.float32),
               (fx, np.float32))]
    order = upload(np.random.default_rng(model.seed).permutation(len(rows)),
                   dev)
    tables = model._tables
    bsz = model.batch
    for s in range(0, k * bsz, bsz):
        idx = order[s:s + bsz]
        *tables, _ = glove_mod._glove_math(*tables, *(a[idx] for a in arrays),
                                           float(np.float32(model.lr)))
    return tables


def p18_glove(card: str, corpus, runs: dict):
    """18b: GloVe at the reference's defaults on phase 6's corpus: the
    count's seconds, the triples, V, ms a batch, triples/s, the loss per
    epoch (falling); the first batches card vs CPU from the fit's triples;
    two seeded card runs bitwise and fit_distributed over 2 ranks, both for
    1 epoch on the corpus's first sentences. Returns the fitted model
    (18d's vectors)."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models import glove as glove_mod
    from deeplearning4j_tpu_torch.models.glove import Glove
    from deeplearning4j_tpu_torch.nlp.sentence_iterator import (
        CollectionSentenceIterator,
    )
    from deeplearning4j_tpu_torch.parallel.mesh import data_parallel_mesh

    tag = "phase 18b GloVe"
    real_count = glove_mod.count_cooccurrences
    counted = []

    def count(encoded, window):
        t0 = time.perf_counter()
        out = real_count(encoded, window)
        counted.append((out, time.perf_counter() - t0))
        return out

    def timed_epochs(model):
        run, spent = model._run_epochs, {}

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(*a, **k)
            torch.cuda.synchronize()
            spent["s"] = time.perf_counter() - t0

        model._run_epochs = timed
        return spent

    def fitted(sentences, **kw):
        m = Glove(device=P18_DEVICE, **dict(P18_GLOVE, **kw))
        m.fit(CollectionSentenceIterator(sentences))
        return m

    corpus = corpus[:P18_GLOVE_SENTENCES]
    glove_mod.count_cooccurrences = count
    try:
        g = Glove(device=P18_DEVICE, **P18_GLOVE)
        spent = timed_epochs(g)
        reset_launches()
        t0 = time.perf_counter()
        g.fit(CollectionSentenceIterator(corpus))
        fit_s = time.perf_counter() - t0
        (rows, cols, vals), count_s = counted[0]
        n = len(rows)
        batches = n // g.batch * g.epochs
        losses = g.loss_history
        log(f"{tag} (D {g.layer_size}, window {g.window}, x_max {g.x_max}, "
            f"alpha {g.alpha}, lr {g.lr}, batches of {g.batch}, "
            f"{g.epochs} epochs) on {len(corpus)} sentences: count "
            f"{count_s:.2f} s, {n} triples, V {len(g.cache)}; fit "
            f"{fit_s:.2f} s, of it the epochs {spent['s']:.2f} s: "
            f"{spent['s'] * 1e3 / batches:.4f} ms a batch, "
            f"{batches * g.batch / spent['s']:.1f} triples/s; loss per "
            f"epoch {losses} [{card}]")
        _must(tag, np.isfinite(losses).all() and losses[-1] < losses[0],
              f"the loss did not fall: {losses}")
        # the first batches, card vs CPU, from the same initial tables
        outs = []
        for dev in (P18_DEVICE, "cpu"):
            m = Glove(device=dev, **P18_GLOVE)
            m.cache = g.cache
            outs.append(_p18_glove_batches(m, (rows, cols, vals),
                                           P18_CPU_BATCHES))
        errs = [((a.cpu() - b).abs().max() / b.abs().max()).item()
                for a, b in zip(*outs)]
        del outs
        # two seeded runs, 1 epoch on the first sentences
        sub = corpus[:P18_GLOVE_SUB_SENTENCES]
        a, b = (fitted(sub, epochs=1) for _ in range(2))
        bitwise = all(torch.equal(x, y) for x, y in zip(a._tables,
                                                         b._tables))
        log(f"{tag}: the first {P18_CPU_BATCHES} batches card vs CPU from "
            f"the same tables, max |card - cpu| / max |cpu| per table ([w | "
            f"b], [wc | bc], [hw | hb], [hwc | hbc]) "
            f"{[f'{e:.3e}' for e in errs]} (tol {P18_GLOVE_RTOL}); two "
            f"seeded card runs (1 epoch, {len(sub)} sentences, "
            f"{len(counted[1][0][0])} triples) bitwise {bitwise} [{card}]")
        _must(tag, bitwise, "two seeded card runs differ")
        _must(tag, max(errs) <= P18_GLOVE_RTOL, "the card left the CPU")
        del a, b
        runs["glove"] = read_launches()
        # the data axis: 2 ranks, 1 epoch
        gd = Glove(device=P18_DEVICE, **dict(P18_GLOVE, epochs=1))
        step, batch_losses = gd._distributed_step, []

        def recorded(*a):
            out = step(*a)
            batch_losses.append(out[-1])
            return out

        gd._distributed_step = recorded
        spent = timed_epochs(gd)
        reset_launches()
        gd.fit_distributed(CollectionSentenceIterator(sub),
                           mesh=data_parallel_mesh(
                               devices=[P18_RANK_DEVICE] * 2))
        runs["glove_dist"] = read_launches()
        first = float(batch_losses[0])
        log(f"{tag} fit_distributed over 2 ranks, 1 epoch, {len(sub)} "
            f"sentences: {len(batch_losses)} batches, "
            f"{spent['s'] * 1e3 / len(batch_losses):.4f} ms a batch; first "
            f"batch's loss {first:.6f}, the epoch's mean "
            f"{gd.loss_history[0]:.6f} [{card}]")
        _must(tag, np.isfinite(gd.loss_history[0])
              and gd.loss_history[0] < first,
              "the distributed loss did not fall against the first batch's")
        del gd
    finally:
        glove_mod.count_cooccurrences = real_count
    return g


def _p18_sentiment_trees(n: int, seed: int = 0):
    """``n`` trees of 8-20 words over P18_RNTN_CLASSES classes, built as
    the reference's test_rntn_learns_sentiment builds its 2-class ones:
    each class has its own words, half of a tree's words its class's and
    half filler words, shuffled; every node carries the root's label."""
    import numpy as np

    from deeplearning4j_tpu_torch.nlp.tree import (
        binarize,
        right_branching_tree,
    )

    rng = np.random.default_rng(seed)
    vocab = [[f"c{c}w{i}" for i in range(6)]
             for c in range(P18_RNTN_CLASSES)]
    fill = ["movie", "film", "plot", "was", "the", "a", "and", "it", "very",
            "scene", "actor", "story"]
    trees = []
    for _ in range(n):
        c = int(rng.integers(P18_RNTN_CLASSES))
        length = int(rng.integers(8, 21))
        k = length // 2
        words = list(rng.choice(vocab[c], k)) + list(
            rng.choice(fill, length - k))
        rng.shuffle(words)
        t = binarize(right_branching_tree(words, label=str(c)))
        for node in t.subtrees():
            node.label = t.label
        trees.append(t)
    return trees


def _p18_treebank():
    """The bundled treebank, binarized, each node relabelled by its
    category's index (the reference's untied-table test); the class
    count."""
    import copy

    from deeplearning4j_tpu_torch.models.rntn import basic_category
    from deeplearning4j_tpu_torch.nlp.parser import bundled_treebank
    from deeplearning4j_tpu_torch.nlp.tree import binarize

    trees = [binarize(t) for t in bundled_treebank()]
    cats = sorted({basic_category(x.label, False)
                   for t in trees for x in t.subtrees()})
    cat_id = {c: i for i, c in enumerate(cats)}

    def relabel(t):
        cat = basic_category(t.label, False)
        for c in t.children:
            relabel(c)
        t.label = str(cat_id[cat])

    out = [copy.deepcopy(t) for t in trees]
    for t in out:
        relabel(t)
    return out, len(cats)


def _p18_rntn_run(card: str, tag: str, trees, **kw):
    """The first step card vs CPU from the same tables, then the fit on
    the card: ms a batch, the loss per epoch (falling)."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models import rntn

    m = rntn.RNTN(dim=P18_RNTN_DIM, batch_size=P18_RNTN_BATCH, seed=0,
                  device=P18_DEVICE, **kw)
    m.cache.fit([t.words() for t in trees])
    m.discover_productions(trees)
    m.init_params()
    host = rntn.RNTN(dim=P18_RNTN_DIM, batch_size=P18_RNTN_BATCH, seed=0,
                     device="cpu", **kw)
    host.cache, host.prod_index, host.unary_index = (
        m.cache, m.prod_index, m.unary_index)
    host.params = rntn.params_from_jax(rntn.params_to_jax(m.params), "cpu")
    cols = [np.stack(c) for c in zip(*[m._pack_padded(t)
                                       for t in trees[:P18_RNTN_BATCH]])]
    w = np.ones(P18_RNTN_BATCH, np.float32)
    loss, grads = m._batch_loss_and_grads(m.params, m._upload(cols),
                                          torch.tensor(w, device=P18_DEVICE))
    hloss, hgrads = host._batch_loss_and_grads(host.params,
                                               host._upload(cols),
                                               torch.tensor(w))
    loss_rel = abs(float(loss) - float(hloss)) / abs(float(hloss))
    grad_rel = max(((grads[k].cpu() - g).abs().max()
                    / g.abs().max().clamp_min(1e-30)).item()
                   for k, g in hgrads.items() if g.abs().max() > 0)
    del host, hgrads, grads
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = m.fit_trees(trees, epochs=P18_RNTN_EPOCHS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    batches = -(-len(trees) // P18_RNTN_BATCH) * P18_RNTN_EPOCHS
    peak = torch.cuda.max_memory_allocated() / 2**20
    ev = rntn.RNTNEval()
    ev.eval(m, trees[:200])
    log(f"{tag}: {len(trees)} trees, d {P18_RNTN_DIM} with the tensor, "
        f"batch {P18_RNTN_BATCH}, max_nodes {m.max_nodes}, "
        f"{len(m.prod_index)} productions, {m.num_classes} classes; first "
        f"step card vs CPU: loss rel {loss_rel:.3e}, gradients "
        f"{grad_rel:.3e} of a leaf's max (tol {P18_RNTN_TOL}); "
        f"{P18_RNTN_EPOCHS} epochs {secs:.2f} s -> "
        f"{secs * 1e3 / batches:.2f} ms a batch, peak memory {peak:.1f} "
        f"MiB; loss per epoch {losses}; root accuracy on the first 200 "
        f"trees {ev.accuracy():.3f} [{card}]")
    _must(tag, loss_rel <= P18_RNTN_TOL and grad_rel <= P18_RNTN_TOL,
          "the first step on the card left the CPU's")
    _must(tag, np.isfinite(losses).all() and losses[-1] < losses[0],
          f"the loss did not fall: {losses}")


def p18_rntn(card: str, runs: dict) -> None:
    """18c: the simplified RNTN on synthetic 5-class trees, the untied one
    on the relabelled treebank."""
    reset_launches()
    trees = _p18_sentiment_trees(P18_RNTN_TREES)
    _p18_rntn_run(card, "phase 18c RNTN simplified", trees,
                  num_classes=P18_RNTN_CLASSES,
                  max_nodes=max(2 * len(t.words()) - 1 for t in trees))
    bank, n_cats = _p18_treebank()
    _p18_rntn_run(card, "phase 18c RNTN untied (bundled treebank)", bank,
                  num_classes=n_cats, simplified_model=False,
                  combine_classification=False,
                  max_nodes=max(sum(1 for _ in t.subtrees()) for t in bank))
    runs["rntn"] = read_launches()


def p18_vectors(card: str, glove, runs: dict) -> None:
    """18d: PCA, k-means and t-SNE on 18b's vectors, card vs CPU."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.clustering.kmeans import KMeans
    from deeplearning4j_tpu_torch.ops.pca import pca_factor
    from deeplearning4j_tpu_torch.plot import tsne as tsne_mod

    reset_launches()
    vecs = glove.syn0[:P18_PCA_WORDS].cpu().numpy()
    tag = "phase 18d"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    proj, comps = pca_factor(vecs, P18_PCA_DIMS, device=P18_DEVICE)
    pca_ms = (time.perf_counter() - t0) * 1e3
    hproj, hcomps = pca_factor(vecs, P18_PCA_DIMS, device="cpu")
    sign = np.sign((comps * hcomps).sum(1))
    pca_err = np.abs(proj * sign - hproj).max() / np.abs(hproj).max()
    log(f"{tag} PCA of the {P18_PCA_WORDS} most frequent words' vectors "
        f"(D {vecs.shape[1]}) to {P18_PCA_DIMS}: {pca_ms:.2f} ms on the "
        f"card; up to sign, max |card - cpu| / max |cpu| {pca_err:.3e} (tol "
        f"{P18_PCA_RTOL}); signs {sign.astype(int).tolist()} [{card}]")
    _must(tag, pca_err <= P18_PCA_RTOL, "PCA on the card left the CPU's")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    km = KMeans(k=P18_KMEANS_K, seed=0, device=P18_DEVICE).fit(vecs)
    km_ms = (time.perf_counter() - t0) * 1e3
    hk = KMeans(k=P18_KMEANS_K, seed=0, device="cpu").fit(vecs)
    d2 = ((vecs[:, None, :] - hk.centroids[None]) ** 2).sum(-1)
    two = np.sort(d2, axis=1)[:, :2]
    clear = (two[:, 1] - two[:, 0]) > P18_KMEANS_TIE
    same = int((km.labels_ == hk.labels_)[clear].sum())
    log(f"{tag} k-means k {P18_KMEANS_K}: {km_ms:.2f} ms on the card "
        f"(k-means++ on the host included), inertia {km.inertia:.4f} (CPU "
        f"{hk.inertia:.4f}); assignments equal on {same} of {int(clear.sum())} "
        f"points farther than {P18_KMEANS_TIE} from a tie "
        f"({int((~clear).sum())} near ties) [{card}]")
    _must(tag, same == int(clear.sum()), "k-means on the card left the CPU's")

    x = glove.syn0[:P18_TSNE_WORDS].cpu().numpy()
    ts = tsne_mod.Tsne(use_pca=True, n_iter=P18_TSNE_ITERS, seed=0,
                       device=P18_DEVICE)
    t0 = time.perf_counter()
    p, y0 = ts.prepare(x)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    args = (ts.learning_rate, ts.initial_momentum, ts.final_momentum)
    t0 = time.perf_counter()
    y = tsne_mod._tsne_loop(p, y0, *args, P18_TSNE_ITERS, ts.stop_lying_iter)
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3
    hp, hy0 = p.cpu(), y0.cpu()
    hy0_ulp = torch.from_numpy(np.nextafter(hy0.numpy(), np.float32(1)))
    k = P18_TSNE_CHECK
    got = tsne_mod._tsne_loop(p, y0, *args, k, ts.stop_lying_iter).cpu()
    want = tsne_mod._tsne_loop(hp, hy0, *args, k, ts.stop_lying_iter)
    moved = tsne_mod._tsne_loop(hp, hy0_ulp, *args, k, ts.stop_lying_iter)
    err = (got - want).abs().max().item()
    noise = (moved - want).abs().max().item()
    bar = max(P18_TSNE_RTOL * want.abs().max().item(),
              P18_TSNE_ULPS_X * noise)
    finite = bool(torch.isfinite(y).all())
    log(f"{tag} t-SNE of {P18_TSNE_WORDS} words (use_pca, PCA to "
        f"{ts.pca_dims}): P and y0 {prep_s:.2f} s (the perplexity search on "
        f"the host); {P18_TSNE_ITERS} iterations {loop_ms:.1f} ms on the "
        f"card, finite {finite}; after {k} iterations max |card - cpu| "
        f"{err:.3e} (bar {bar:.3e}: {P18_TSNE_RTOL} of the map's max "
        f"{want.abs().max().item():.4f}, or {P18_TSNE_ULPS_X} x the CPU "
        f"run's own one-ulp movement {noise:.3e}) [{card}]")
    _must(tag, finite and err <= bar, "t-SNE on the card left the CPU's")
    runs["vectors"] = read_launches()


def p18_serve(card: str) -> None:
    """18e: ``serve --embed-models word2vec,glove`` through the CLI in a
    process of its own: ``POST /v1/embeddings`` with ``model: glove``
    returns the CPU demo model's vectors within P18_EMBED_TOL."""
    import os
    import signal

    import numpy as np

    from deeplearning4j_tpu_torch import cli

    tag = "phase 18e"
    shutil.rmtree(P18_DIR, ignore_errors=True)
    P18_DIR.mkdir(parents=True)
    port_file = P18_DIR / "port.json"
    out = open(P18_DIR / "serve.log", "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "deeplearning4j_tpu_torch", "serve",
         "--demo", "--embed-models", "word2vec,glove", "--port", "0",
         "--port-file", str(port_file)], cwd=ROOT, stdout=out,
        stderr=subprocess.STDOUT, env=dict(os.environ))
    try:
        while not port_file.exists():
            _must(tag, proc.poll() is None and time.perf_counter() - t0 < 240,
                  f"serve did not start: {(P18_DIR / 'serve.log').read_text()}")
            time.sleep(0.2)
        time.sleep(0.2)
        addr = json.loads(port_file.read_text())
        up_s = time.perf_counter() - t0
        base = f"http://{addr['host']}:{addr['port']}"
        host = cli._demo_embedders(["glove"], device="cpu")["glove"]
        words = [host.cache.index_to_word[i] for i in range(len(host.cache))]
        code, res = _post_status(base + "/v1/embeddings",
                                 {"words": words + ["zebra"],
                                  "model": "glove"})
        w2v_code, _ = _post_status(base + "/v1/embeddings",
                                   {"words": words[:3], "model": "word2vec"})
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        out.close()
    vec = res.get("vectors", {})
    err = max(float(np.abs(np.asarray(vec.get(w), np.float32)
                           - host.get_word_vector(w)).max())
              if vec.get(w) is not None else float("inf") for w in words)
    log(f"{tag}: serve --embed-models word2vec,glove up in {up_s:.1f} s; "
        f"POST /v1/embeddings model glove {code}: {len(words)} vectors, max "
        f"|served - CPU demo model| {err:.3e} (tol {P18_EMBED_TOL}), unknown "
        f"word {vec.get('zebra', 'missing')}; model word2vec {w2v_code}; "
        f"serve exit {proc.returncode} [{card}]")
    shutil.rmtree(P18_DIR, ignore_errors=True)
    _must(tag, code == 200 and res.get("model") == "glove"
          and err <= P18_EMBED_TOL and vec.get("zebra", 0) is None
          and w2v_code == 200, "the GloVe demo served through the CLI")


def phase_nlp_vectors(card: str, w2v_src, corpus) -> dict[str, dict[str, int]]:
    """Phase 18: the embedding models over a data axis, GloVe, the RNTN,
    the vector tools and GloVe served; #5 launches in 18a alone."""
    import torch

    t0 = time.perf_counter()
    runs: dict[str, dict[str, int]] = {}

    def timed(name, fn):
        t1 = time.perf_counter()
        out = fn()
        log(f"phase 18{name}: {time.perf_counter() - t1:.1f} s")
        torch.cuda.empty_cache()
        return out

    timed("a", lambda: p18_word2vec(card, w2v_src, corpus, runs))
    glove = timed("b", lambda: p18_glove(card, corpus, runs))
    timed("c", lambda: p18_rntn(card, runs))
    timed("d", lambda: p18_vectors(card, glove, runs))
    timed("e", lambda: p18_serve(card))
    total: dict[str, int] = {}
    for r in runs.values():
        _add(total, r)
    log(f"phase 18: launches {total}")
    _must("phase 18", not any(total[k] for k in KERNELS if k != "emb_dot"),
          f"a kernel other than #5 launched: {total}")
    _must("phase 18", all(runs[k]["emb_dot"] == 0 for k in runs
                          if not k.startswith("w2v_")),
          "#5 launched outside Word2Vec's distributed fits")
    log(f"phase 18: {time.perf_counter() - t0:.1f} s wall [{card}]")
    return {k: {name: r.get(name, 0) for name in KERNELS}
            for k, r in runs.items()}


# -- phase 19 ------------------------------------------------------------------

#: phase 19's serve processes: GPT-2-small (the serve phases' geometry: 8
#: slots, 640 tokens a slot, K 4) with the sampling surface, so one request
#: samples (the draw kernel) while the rest decode greedily
P19_DIR = ROOT / ".scratch" / "chip_smoke_phase19"
P19_SERVE = ["serve", "--demo", "--preset", "gpt2s", "--flash", "--slots", "8",
             "--max-total", "640", "--decode-horizon", "4", "--temperature",
             "0", "--top-k", "0", "--sampling-surface", "--probe-cache",
             "off", "--port", "0"]
#: the concurrent greedy requests' prompt lengths (one bucketed and
#: batched, one chunked past the 128-row bucket) and the sampled request's
P19_GREEDY = (16, 40, 77, 130)
P19_SAMPLED = 60
P19_MAX_NEW = 24
#: the MNIST-sized table of 19d: 60,000 rows of 784 uint8, batch 256,
#: three epochs
P19_ROWS, P19_ROW_LEN, P19_BATCH, P19_EPOCHS = 60000, 784, 256, 3
#: the serve process's launch report: the counts and the launched shapes,
#: printed after the CLI returns (the counters live in that process)
P19_WRAPPER = (
    "import json, sys\n"
    "sys.path.insert(0, {root!r})\n"
    "import chip_smoke\n"
    "from deeplearning4j_tpu_torch import cli\n"
    "chip_smoke.reset_launches()\n"
    "with chip_smoke.launched_shapes() as seen:\n"
    "    rc = cli.main(sys.argv[1:])\n"
    "print('P19_LAUNCHES ' + json.dumps({{'launches': "
    "chip_smoke.read_launches(), 'shapes': sorted(seen, key=str)}}), "
    "flush=True)\n"
    "sys.exit(rc)\n")


def _tuples(x):
    return tuple(_tuples(v) for v in x) if isinstance(x, list) else x


def _p19_start(tag: str, extra: list[str]):
    """One ``serve`` process of phase 19 through the launch-reporting
    wrapper; returns (process, log path, port file)."""
    import os

    log_path = P19_DIR / f"{tag}.log"
    port_file = P19_DIR / f"{tag}.port"
    proc = subprocess.Popen(
        [sys.executable, "-u", "-c", P19_WRAPPER.format(root=str(ROOT)),
         *P19_SERVE, "--port-file", str(port_file), *extra],
        cwd=ROOT, stdout=open(log_path, "w"), stderr=subprocess.STDOUT,
        env=dict(os.environ))
    return proc, log_path, port_file


def _p19_drive(tag: str, proc, log_path: Path, port_file: Path,
               metrics: bool) -> dict:
    """Wait for the server, send the greedy requests together and then the
    sampled one alone (its key is the next split either way), read
    ``/metrics``, stop the server with SIGTERM and parse its report."""
    import signal
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    t0 = time.perf_counter()
    while not port_file.exists():
        _must(tag, proc.poll() is None and time.perf_counter() - t0 < 300,
              f"serve did not start: {log_path.read_text()[-3000:]}")
        time.sleep(0.2)
    time.sleep(0.2)
    up_s = time.perf_counter() - t0
    addr = json.loads(port_file.read_text())
    base = f"http://{addr['host']}:{addr['port']}"
    rng = np.random.default_rng(19)
    prompts = [rng.integers(0, 50304, n).tolist() for n in P19_GREEDY]
    sampled = rng.integers(0, 50304, P19_SAMPLED).tolist()
    try:
        with ThreadPoolExecutor(len(prompts)) as ex:
            greedy = list(ex.map(lambda p: _post_status(
                base + "/v1/generate", {"prompt": p,
                                        "max_new": P19_MAX_NEW}), prompts))
        drawn = _post_status(base + "/v1/generate", {
            "prompt": sampled, "max_new": P19_MAX_NEW, "temperature": 0.8,
            "top_k": 40})
        prom = ""
        if metrics:
            with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
                prom = r.read().decode()
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    text = log_path.read_text()
    codes = [c for c, _ in greedy] + [drawn[0]]
    _must(tag, all(c == 200 for c in codes),
          f"requests answered {codes}: {text[-3000:]}")
    report = next((json.loads(line.split(" ", 1)[1])
                   for line in text.splitlines()
                   if line.startswith("P19_LAUNCHES ")), None)
    _must(tag, report is not None and proc.returncode is not None,
          f"no launch report: {text[-3000:]}")
    return dict(streams=[r["tokens"] for _, r in greedy] + [
        drawn[1]["tokens"]], launches=report["launches"],
        shapes={_tuples(k) for k in report["shapes"]}, text=text,
        rc=proc.returncode, up_s=up_s, prom=prom)


def _p19_sanitizer_report(tag: str, run: dict) -> dict:
    """The sanitized run's summary: clean, no ``dispatch`` entry, process
    syncs within the horizons."""
    import ast

    line = next((x for x in run["text"].splitlines()
                 if x.startswith("sanitizers: ") and "locks tracked" in x), "")
    _must(tag, "sync counts {" in line, f"no sanitizer summary: "
          f"{run['text'][-3000:]}")
    counts = ast.literal_eval(line.split("sync counts ", 1)[1].split("}")[0]
                              + "}")
    horizons = int(line.rsplit("horizons ", 1)[1])
    clean = "sanitizers: clean" in run["text"]
    log(f"{tag}: {line}; {'clean' if clean else 'VIOLATIONS'}; exit "
        f"{run['rc']}")
    _must(tag, clean and run["rc"] == 0,
          f"sanitizer violations: {run['text'][-3000:]}")
    _must(tag, "dispatch" not in counts,
          f"a sync inside dispatch: {counts}")
    _must(tag, counts.get("process", 0) <= horizons,
          f"process-phase syncs {counts.get('process', 0)} over {horizons} "
          f"horizons")
    return counts


def p19_serve(card: str) -> dict[str, dict[str, int]]:
    """19a-b: ``serve --sanitize`` (slab and paged) against the same runs
    without it; the sanitized slab run's ``/metrics`` gives the decode
    family's ``serve_mfu``/``serve_mbu``."""
    runs = {}
    procs = {}
    for layout, extra in (("slab", []), ("paged", ["--paged",
                                                   "--block-size", "8"])):
        for sanitize in (True, False):
            tag = f"phase 19a {layout}{' --sanitize' if sanitize else ''}"
            procs[tag] = (layout, sanitize, _p19_start(
                f"{layout}_{'san' if sanitize else 'plain'}",
                extra + (["--sanitize"] if sanitize else [])))
    for tag, (layout, sanitize, (proc, log_path, pf)) in procs.items():
        runs[(layout, sanitize)] = _p19_drive(
            tag, proc, log_path, pf, metrics=sanitize and layout == "slab")
    launches = {}
    for layout in ("slab", "paged"):
        tag = f"phase 19a {layout}"
        san, plain = runs[(layout, True)], runs[(layout, False)]
        _p19_sanitizer_report(tag + " --sanitize", san)
        same = san["streams"] == plain["streams"]
        log(f"{tag}: {len(san['streams'])} streams ({len(P19_GREEDY)} "
            f"greedy together, 1 sampled), --sanitize vs without: "
            f"{'byte-identical' if same else 'DIFFER'}; up in "
            f"{san['up_s']:.1f} / {plain['up_s']:.1f} s; launches "
            f"{san['launches']} [{card}]")
        _must(tag, same, f"streams differ: {san['streams']} vs "
              f"{plain['streams']}")
        want = ["flash_attn_fwd", "threefry_draw",
                "flash_decode_paged" if layout == "paged" else "flash_decode"]
        _launch_check(tag, san["launches"], want)
        check_launched(tag, san["shapes"])
        launches[f"sanitize_{layout}"] = san["launches"]
    prom = runs[("slab", True)]["prom"]
    fam = "masked_step"
    mfu = _prom_value(prom, f'serve_mfu{{family="{fam}"}}')
    mbu = _prom_value(prom, f'serve_mbu{{family="{fam}"}}')
    n = _prom_value(prom, f'serve_program_dispatches_total{{family="{fam}"}}')
    secs = _prom_value(prom, f'serve_program_seconds_total{{family="{fam}"}}')
    log(f"phase 19b: /metrics of the sanitized slab run, decode family "
        f"{fam}: serve_mfu {mfu!r}, serve_mbu {mbu!r} over {n!r} dispatches "
        f"in {secs!r} s (budgets: the audit geometry's envelope, a scale "
        f"reference at GPT-2-small) [{card}]")
    _must("phase 19b", mfu == mfu and mbu == mbu and 0 < mfu <= 1
          and 0 < mbu <= 1, "serve_mfu/serve_mbu missing or out of (0, 1]")
    return launches


def p19_tools(card: str) -> None:
    """19b-c, 19e: ``audit --strict``, ``lint --strict`` and a
    ``provision`` dry run through the CLI."""
    for tag, args in (("phase 19b audit", ["audit", "--strict"]),
                      ("phase 19c lint", ["lint", "--strict"]),
                      ("phase 19e provision",
                       ["provision", "p19", "--num-workers", "1",
                        "--zone", "us-central1-a"])):
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "deeplearning4j_tpu_torch", *args],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        lines = out.stdout.strip().splitlines()
        shown = lines if tag.endswith("provision") else lines[-1:]
        for line in shown:
            log(f"{tag}: {line}")
        log(f"{tag}: exit {out.returncode} in "
            f"{time.perf_counter() - t0:.1f} s")
        _must(tag, out.returncode == 0, f"{out.stdout[-3000:]}"
              f"{out.stderr[-3000:]}")
    _must("phase 19e provision", any(
        "gcloud compute instances create p19-master" in x for x in lines),
        "no rendered create command")


def p19_loader(card: str) -> None:
    """19d: ``PrefetchingLoader`` on the card at MNIST's size against the
    CPU loader, bitwise in order, epoch labels and content, over three
    epochs; the ms a batch."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.native_io import PrefetchingLoader

    rng = np.random.default_rng(1919)
    feats = rng.integers(0, 256, (P19_ROWS, P19_ROW_LEN), dtype=np.uint8)
    labels = rng.integers(0, 10, P19_ROWS, dtype=np.uint8)
    steps = P19_EPOCHS * P19_ROWS // P19_BATCH
    card_l = PrefetchingLoader(feats, labels, 10, P19_BATCH, seed=7)
    host_l = PrefetchingLoader(feats, labels, 10, P19_BATCH, seed=7,
                               device="cpu")
    same, epochs = True, set()
    for _ in range(steps):
        x, y, e = card_l.next_batch()
        hx, hy, he = host_l.next_batch()
        epochs.add(e)
        same = (same and e == he and torch.equal(x.cpu(), hx)
                and torch.equal(y.cpu(), hy))
    card_l.close()
    host_l.close()
    timed = PrefetchingLoader(feats, labels, 10, P19_BATCH, seed=7)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        timed.next_batch()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    timed.close()
    log(f"phase 19d: PrefetchingLoader {P19_ROWS} x {P19_ROW_LEN} uint8, "
        f"batch {P19_BATCH}, {steps} batches ({P19_EPOCHS} epochs, labels "
        f"{sorted(epochs)}): card vs CPU {'bitwise' if same else 'DIFFER'} "
        f"(order, epoch labels, content); {ms:.4f} ms a batch on the card "
        f"(host clock, {steps} batches, depth 4) [{card}]")
    _must("phase 19d", same and epochs == set(range(P19_EPOCHS)),
          "the card's loader left the CPU loader")


def phase_tooling(card: str) -> dict[str, dict[str, int]]:
    """Phase 19: the correctness tooling (serve --sanitize, audit, lint),
    the loader and provision."""
    t0 = time.perf_counter()
    shutil.rmtree(P19_DIR, ignore_errors=True)
    P19_DIR.mkdir(parents=True)
    try:
        tools = subprocess.Popen(
            [sys.executable, "-c",
             f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
             f"import chip_smoke; chip_smoke.p19_tools({card!r})"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        launches = p19_serve(card)
        p19_loader(card)
        out, _ = tools.communicate(timeout=600)
        for line in out.strip().splitlines():
            log(line)
        _must("phase 19", tools.returncode == 0, "19b/c/e failed")
    finally:
        shutil.rmtree(P19_DIR, ignore_errors=True)
    log(f"phase 19: {time.perf_counter() - t0:.1f} s wall [{card}]")
    return launches


# -- phase 20: a model axis across processes, int8 cache on the layout -------

#: the card every rank of 20b-20d runs on
P20_DEVICE = "cuda:0"
#: #1/#2's rank BH at T 256 in 20b-20d: 8 rows x 3 heads (a model axis of
#: 2), 4 rows x 3 heads (20c's (2, 2) ZeRO-3)
P20_RANK_BH = (P15_BATCH * 6 // 2, P15_BATCH // 2 * 6 // 2)
#: 20c/20d's depth (cut from 12: the steps' collectives and the
#: one-process references fit the phase's budget) and steps
P20_LAYERS, P20_STEPS = 2, 3
#: the processes' launch and result report, after each one's work
P20_CLI_WRAPPER = (
    "import json, sys\n"
    "sys.path.insert(0, {root!r})\n"
    "import chip_smoke\n"
    "from deeplearning4j_tpu_torch import cli\n"
    "chip_smoke.reset_launches()\n"
    "with chip_smoke.launched_shapes() as seen:\n"
    "    rc = cli.main(sys.argv[1:])\n"
    "print('P20_SHAPES ' + json.dumps(sorted(seen, key=str)), flush=True)\n"
    "sys.exit(rc)\n")


def p20_config(**kw):
    """The trainers' model (15b's: GPT-2-small widths, the byte
    vocabulary, flash, bf16) at ``P20_LAYERS``, with ``kw``."""
    import torch

    from deeplearning4j_tpu_torch.models.transformer import TransformerConfig

    base = dict(vocab_size=256, d_model=768, n_heads=6, n_layers=P20_LAYERS,
                d_ff=3072, max_len=P15_SEQ + 1, use_flash=True,
                compute_dtype=torch.bfloat16)
    return TransformerConfig(**{**base, **kw})


def _p20_batches(t: int):
    """15b's batch recipe (the demo corpus, ``default_rng(0)``, batch 8):
    ``P20_STEPS`` (8, t) token arrays."""
    import numpy as np

    from deeplearning4j_tpu_torch import cli

    arr = np.frombuffer(cli._DEMO_TEXT, np.uint8).astype(np.int64)
    rng = np.random.default_rng(0)
    out = []
    for _ in range(P20_STEPS):
        starts = rng.integers(0, len(arr) - t, P15_BATCH)
        out.append(np.stack([arr[s:s + t] for s in starts]))
    return out


def _p20_train(mesh, cfg, fsdp: bool = False):
    """``P20_STEPS`` steps of ``lm_optimizer`` from ``init_params(seed 0)``
    on ``mesh``: (losses, params, opt_state, ms a step over the steps
    after the first, the last step's stats)."""
    from deeplearning4j_tpu_torch.device import synchronize
    from deeplearning4j_tpu_torch.models.transformer import (
        init_params,
        lm_optimizer,
        place_transformer_params,
        transformer_train_step,
    )

    opt = lm_optimizer(total_steps=P20_STEPS)
    step, _, shard_tokens = transformer_train_step(mesh, cfg, optimizer=opt,
                                                   fsdp=fsdp)
    params = place_transformer_params(
        mesh, init_params(cfg, seed=0, device=mesh.devices[0]), cfg, fsdp)
    state = opt.init(params)
    t = P15_SEQ if cfg.sequence_parallel else P15_SEQ + 1
    losses, marks = [], []
    for toks in _p20_batches(t):
        params, state, loss = step(params, state, shard_tokens(toks))
        losses.append(float(loss))
        synchronize(mesh.devices[0])
        marks.append(time.perf_counter())
    ms = (marks[-1] - marks[0]) / (len(marks) - 1) * 1e3
    return losses, params, state, ms, dict(step.stats)


def _p20_split_bytes(params, state) -> dict[str, int]:
    """Bytes this process holds of each leaf the data axis splits (params
    and both AdamW moments), by path."""
    from deeplearning4j_tpu_torch.models.transformer import (
        _leaves,
        layout_bytes,
    )

    out = {}
    for tree in (params, state["mu"], state["nu"]):
        for path, leaf in _leaves(tree):
            if leaf.dim_of("data") is not None:
                key = "/".join(path)
                out[key] = out.get(key, 0) + sum(layout_bytes(
                    {"leaf": leaf}).values())
    return out


#: 20c/20d in each worker process: name -> (ici, dcn, config kw, fsdp)
P20_RUNS = {
    "zero3": ({"data": 1, "model": 2}, {"data": 2}, {}, True),
    "moe": ({"data": 1, "model": 1}, {"model": 2}, {"n_experts": 2}, False),
    "ring": ({"data": 1, "model": 1}, {"data": 2},
             {"sequence_parallel": True, "use_flash": False}, False),
}
#: the one-process mesh each is held against: (dp, tp)
P20_ONE = {"zero3": (2, 2), "moe": (1, 2), "ring": (2, 1)}


def p20_worker(coordinator: str, pid: int) -> None:
    """One of 20c/20d's two processes on ``cuda:0`` (gloo): each run of
    ``P20_RUNS`` on its cross-process mesh; prints ``P20_RESULT`` (losses,
    ms a step, the last step's collectives; for ZeRO-3 the split leaves'
    bytes held here and under HSDP) and ``P20_SHAPES``."""
    import torch

    from deeplearning4j_tpu_torch.models.transformer import (
        init_params,
        place_transformer_params,
        lm_optimizer,
    )
    from deeplearning4j_tpu_torch.parallel import mesh as mesh_lib
    from deeplearning4j_tpu_torch.parallel.cluster import (
        initialize_distributed,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(coordinator, 2, pid, device=P20_DEVICE)
    out = {}
    reset_launches()
    with launched_shapes() as seen:
        for name, (ici, dcn, kw, fsdp) in P20_RUNS.items():
            n = ici["data"] * ici["model"]
            mesh = mesh_lib.hybrid_mesh(ici, dcn, [P20_DEVICE] * n)
            cfg = p20_config(**kw)
            losses, params, state, ms, stats = _p20_train(mesh, cfg, fsdp)
            res = dict(losses=losses, ms=ms, mesh=repr(mesh),
                       bucket=stats["bucket_bytes"],
                       bucket_host=stats["host_bytes"],
                       allreduce_ms=stats["allreduce_s"] * 1e3,
                       collectives=stats["collectives"])
            if fsdp:
                # HSDP: every process held the (1, 2) layout's shards, its
                # local data axis being 1
                local = mesh_lib.dp_mp_mesh(1, 2, [P20_DEVICE] * 2)
                hp = place_transformer_params(
                    local, init_params(cfg, seed=0, device=P20_DEVICE), cfg,
                    True)
                hs = lm_optimizer(total_steps=P20_STEPS).init(hp)
                res["held"] = _p20_split_bytes(params, state)
                res["hsdp"] = _p20_split_bytes(hp, hs)
                del hp, hs
            out[name] = res
            del params, state
            torch.cuda.empty_cache()
    print("P20_RESULT " + json.dumps(out), flush=True)
    print("P20_SHAPES " + json.dumps(sorted(seen, key=str)), flush=True)
    print("P20_LAUNCHES " + json.dumps(read_launches()), flush=True)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _p20_pair(tag: str, argvs) -> list[str]:
    """Two processes from ``argvs`` (one argv each), run together to the
    end; their output, logged. Fails unless both exit 0."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(a, cwd=ROOT, text=True, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for a in argvs]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    secs = time.perf_counter() - t0
    for i, (p, out) in enumerate(zip(procs, outs)):
        log(f"{tag} process {i}: exit {p.returncode} in {secs:.1f} s (both)")
        for line in out.splitlines():
            if not line.startswith(("P20_SHAPES ", "P20_RESULT ")):
                log(f"  | {_printable(line)}")
        _must(tag, p.returncode == 0, f"process {i} failed")
    return outs


def _p20_report(tag: str, out: str, key: str):
    line = next((x for x in out.splitlines() if x.startswith(key + " ")),
                None)
    _must(tag, line is not None, f"no {key} line")
    return json.loads(line.split(" ", 1)[1])


def phase20_mesh_int8(card: str, total: dict) -> None:
    """20a: int8-cache generate (``decode_int8``, quantized weights) from
    GPT-2-small on the (2, 3) layout over ``["cuda:0"] * 6`` against
    single-device int8-cache generate, at the float layout's bar (15a's
    ``_p15_parity``): each rank's #3 launch takes the row's q and
    softmax-weight scales. #3 in int8 mode and its maxima pass once a step,
    layer and rank; the layout's max |dlogit|; ms a generate."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models.transformer import (
        init_params,
        place_transformer_params,
        quantize_decode_params,
        transformer_generate,
    )
    from deeplearning4j_tpu_torch.parallel.mesh import dp_mp_mesh

    tag = "phase 20a"
    cfg = gpt2s_config(decode_int8=True)
    params = quantize_decode_params(init_params(cfg, seed=0), cfg)
    mesh = dp_mp_mesh(MESH_DP, MESH_TP, ["cuda:0"] * (MESH_DP * MESH_TP))
    laid = place_transformer_params(mesh, params, cfg)
    prompts = torch.from_numpy(np.random.default_rng(15).integers(
        0, cfg.vocab_size, (P15_PROMPTS, P15_PROMPT))).cuda()
    gen = transformer_generate(cfg)
    ranks = MESH_DP * MESH_TP
    times = {}
    for where, p in (("single device", params), ("(2, 3) layout", laid)):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = gen(p, prompts, P15_NEW, temperature=0.0, return_logits=True)
        torch.cuda.synchronize()
        times[where] = (time.perf_counter() - t0) * 1e3
        launches = read_launches()
        if where == "single device":
            ref, ref_logits = out
            _must(tag, launches["flash_decode_int8_maxima"] == 0,
                  "the single device ran the maxima pass")
        else:
            toks, logits = out
            _add(total, launches)
    log(f"{tag}: launches on the layout {launches}")
    for kname, want_n in (("flash_attn_fwd", cfg.n_layers * ranks),
                          ("flash_decode_int8",
                           cfg.n_layers * ranks * P15_NEW),
                          ("flash_decode_int8_maxima",
                           cfg.n_layers * ranks * P15_NEW),
                          ("flash_decode", 0)):
        _must(tag, launches[kname] == want_n,
              f"{kname} launched {launches[kname]} times, not {want_n} "
              f"(once a layer{' and step' if 'decode' in kname else ''} on "
              f"each of the {ranks} ranks)")
    log(f"{tag}: int8-cache greedy on the layout vs single-device "
        f"int8-cache generate: {_p15_parity(tag, toks, ref, ref_logits)}; "
        f"max |dlogit| {_logit_gap(toks, ref, logits, ref_logits):.6g} up "
        f"to each row's first mismatch; ms a generate "
        f"(8 x {P15_PROMPT} + {P15_NEW}) "
        f"{times['(2, 3) layout']:.1f} on the layout, "
        f"{times['single device']:.1f} single device [{card}]")
    del laid, params
    torch.cuda.empty_cache()


def phase20_cli(card: str) -> dict[str, int]:
    """20b: two ``train --coordinator ... --tp 2`` processes with no
    ``--device`` (15b's widths and recipe, every process on the one
    card): gloo picked from the shared card, the model axis across the
    processes, equal final losses within ``P15_REL`` of the one-process
    (1, 2) run, #1/#2 once a step and layer, ms a step, collective ms and
    bytes through the host."""
    import re

    tag = "phase 20b"
    argv = ["train", "--model", "transformer", "--coordinator",
            f"127.0.0.1:{_free_port()}", "--num-processes", "2", "--tp", "2",
            *P15_MODEL, "--batch", str(P15_BATCH), "--steps",
            str(P15_STEPS), "--bf16", "--flash"]
    wrapper = [sys.executable, "-u", "-c",
               P20_CLI_WRAPPER.format(root=str(ROOT))]
    outs = _p20_pair(tag, [[*wrapper, *argv, "--process-id", str(i)]
                           for i in range(2)])
    finals, stats, seen = [], [], set()
    for i, out in enumerate(outs):
        _must(tag, re.search(r"backend gloo \(processes share a card", out)
              is not None, f"process {i} did not pick gloo for the shared "
              f"card")
        _must(tag, re.search(rf"\(1, 2\) mesh across 2 processes \(process "
                             rf"{i}: model ranks {i}-{i}\)", out) is not None,
              f"process {i}: the model axis does not span the processes")
        m = re.search(r"^final loss ([0-9.]+)$", out, re.M)
        _must(tag, m is not None, f"process {i}: no final loss")
        finals.append(m.group(1))
        m = re.search(r"model axis across 2 processes \(gloo\): (\d+) "
                      r"collectives a step, (\d+) bytes received, (\d+) "
                      r"bytes through the host; ([0-9.]+) ms a step over "
                      r"steps 2-\d+ .*, ([0-9.]+) ms of it in the "
                      r"cross-process collectives; kernel launches "
                      r"flash_attn_fwd (\d+) flash_attn_bwd (\d+)", out)
        _must(tag, m is not None, f"process {i}: no collectives line")
        stats.append(m.groups())
        want = P15_STEPS * 12
        _must(tag, int(m.group(6)) == want and int(m.group(7)) == want,
              f"process {i}: #1/#2 launched {m.group(6)}/{m.group(7)} "
              f"times, not once a layer a step on its rank ({want})")
        seen |= {_tuples(k) for k in _p20_report(tag, out, "P20_SHAPES")}
    check_launched(tag + " processes", seen)
    _must(tag, finals[0] == finals[1],
          f"the processes' final losses differ: {finals}")
    losses, _, ms, launches = _p15_one_process(card, 1, 2, tag)
    rel = abs(float(finals[0]) - losses[-1]) / abs(losses[-1])
    log(f"{tag}: final loss {finals[0]} in both processes; one process "
        f"(1, 2) {losses[-1]:.4f}; rel {rel:.3e} (bar {P15_REL}); ms a step "
        f"over steps 2-{P15_STEPS} (host clock): two processes {stats[0][3]} "
        f"/ {stats[1][3]}, of it in the cross-process collectives "
        f"{stats[0][4]} / {stats[1][4]}; one process {ms:.2f}; a step "
        f"{stats[0][0]} collectives, {stats[0][1]} bytes received, "
        f"{stats[0][2]} bytes through the host [{card}]")
    _must(tag, rel <= P15_REL,
          "the two processes' loss leaves the one-process run's")
    return launches


def phase20_workers(card: str) -> dict[str, int]:
    """20c and 20d: ``p20_worker`` in two processes on the card, each run
    against its one-process counterpart."""
    port = _free_port()
    return _p20_check(card, _p20_pair("phase 20c-d", [[
        sys.executable, "-u", "-c",
        f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; "
        f"chip_smoke.p20_worker('127.0.0.1:{port}', {i})"] for i in range(2)]))


def _p20_check(card: str, outs: list[str]) -> dict[str, int]:
    """20c and 20d's checks on the two workers' output."""
    import torch

    from deeplearning4j_tpu_torch.parallel.mesh import dp_mp_mesh

    tag = "phase 20c-d"
    res = [_p20_report(tag, out, "P20_RESULT") for out in outs]
    seen = set()
    for out in outs:
        seen |= {_tuples(k) for k in _p20_report(tag, out, "P20_SHAPES")}
        log(f"{tag} process launches {_p20_report(tag, out, 'P20_LAUNCHES')}")
    check_launched(tag + " processes", seen)
    reset_launches()
    for name, (_, _, kw, fsdp) in P20_RUNS.items():
        sub = "phase 20c" if name == "zero3" else f"phase 20d {name}"
        a, b = (r[name] for r in res)
        _must(sub, a["losses"] == b["losses"],
              f"the processes' losses differ: {a['losses']} / "
              f"{b['losses']}")
        dp, tp = P20_ONE[name]
        one = _p20_train(dp_mp_mesh(dp, tp, [P20_DEVICE] * (dp * tp)),
                         p20_config(**kw), fsdp)
        rel = abs(a["losses"][-1] - one[0][-1]) / abs(one[0][-1])
        c = a["collectives"]
        log(f"{sub}: {a['mesh']}; losses {a['losses']} in both processes; "
            f"one process ({dp}, {tp}) {one[0]}; rel {rel:.3e} (bar "
            f"{P15_REL}); ms a step {a['ms']:.2f} / {b['ms']:.2f} (one "
            f"process {one[3]:.2f}); a step: {c['calls']} collectives, "
            f"{c['bytes']} bytes received, {c['host_bytes']} through the "
            f"host in {c['seconds'] * 1e3:.2f} ms, the data bucket "
            f"{a['bucket']} bytes ({a['bucket_host']} through the host) in "
            f"{a['allreduce_ms']:.2f} ms [{card}]")
        _must(sub, rel <= P15_REL, "the loss leaves the one-process run's")
        if fsdp:
            both = sorted(set(a["held"]) & set(a["hsdp"]))
            mine = [sum(r[name]["held"][k] for k in both) for r in res]
            hsdp = sum(a["hsdp"][k] for k in both)
            log(f"{sub}: params + AdamW bytes a process of the {len(both)} "
                f"leaves the global data axis splits: {mine[0]} / {mine[1]}"
                f", HSDP {hsdp} (the (1, 2) layout in every process)")
            _must(sub, len(both) == len(a["held"]) and mine[0] == mine[1]
                  and 2 * mine[0] == hsdp,
                  "ZeRO-3 does not hold half of HSDP's bytes")
        del one
        torch.cuda.empty_cache()
    return read_launches()


def phase_model_axis(card: str) -> dict[str, dict[str, int]]:
    """Phase 20: the int8 cache over the training layout and a model axis
    across processes; fails on a launch at a shape phase 2 did not
    hold."""
    import torch

    t0 = time.perf_counter()
    out: dict[str, dict[str, int]] = {"mesh_int8": {}}
    with launched_shapes() as seen:
        for name, fn in (
                ("a", lambda: phase20_mesh_int8(card, out["mesh_int8"])),
                ("b", lambda: out.__setitem__("model_axis_cli",
                                              phase20_cli(card))),
                ("c-d", lambda: out.__setitem__("model_axis_workers",
                                                phase20_workers(card)))):
            t1 = time.perf_counter()
            fn()
            log(f"phase 20{name}: {time.perf_counter() - t1:.1f} s")
            torch.cuda.empty_cache()
    check_launched("phase 20", seen)
    log(f"phase 20: {time.perf_counter() - t0:.1f} s wall [{card}]")
    return out


# -- phase 21: long context --------------------------------------------------

#: from this T on, phase 2 holds #1 and #2 to the row-blocked plain
#: versions
LONG_T = 8192
#: bench.py's transformer-flash-8k (:219) and -32k (:229): the widths, then
#: (seq, batch) a row; flash, no remat, bf16, AdamW 3e-4, tokens from
#: default_rng(0)
P21_TRAIN_WIDTHS = dict(vocab_size=8192, d_model=512, n_heads=4, n_layers=8,
                        d_ff=2048)
P21_TRAIN = {"transformer-flash-8k": (8192, 2),
             "transformer-flash-32k": (32768, 1)}
P21_WARMUP, P21_STEPS, P21_LR = 1, 4, 3e-4
#: the flash-vs-dense cut: 2 layers at T 8,192, B 1 (phase 5's bars)
P21_PARITY_LAYERS, P21_PARITY_SEQ = 2, 8192
#: bench.py's -gqa-8kctx rows (``_decode_bench_cfg(gqa=True, prompt_len=
#: 8192, new=256)``, :579): GPT-2-small widths, 6 query heads over 2 KV
#: heads, RoPE, flash prefill, B 16
P21_PROMPT, P21_NEW, P21_BATCH = 8192, 256, 16
#: the B 1 flash-vs-dense prefill check's new tokens (cut from 256)
P21_B1_NEW = 64
#: the serve row with 8k prompts (bench.py:1051): 4 slots, 24 requests, 4
#: of them 8,192-token prompts, the rest 512 tokens (the even ones a
#: 448-token shared prefix and 64 of their own), 64 new, prefix cache on,
#: prefill_max_bucket 512, exponential arrivals of mean 20 ms; greedy
P21_SLOTS, P21_REQS, P21_LONG = 4, 24, 4
P21_SHORT, P21_SUFFIX, P21_SERVE_NEW = 512, 64, 64
P21_BUCKET, P21_INTERARRIVAL = 512, 0.02
#: every cache of the slice: 8,192 + 256 + 1 positions (and the serve
#: row's 8,192 + 64 + 1) rounded up to 512 rows
P21_TPAD = 8704
#: decode positions phase 2 holds #3/#4 at over P21_TPAD: the first row,
#: either side of the int8 default tile's edge (4,352 rows), the last
#: prompt row and the last decode position
P21_POS = [0, 4351, 4352, 8191, 8447]
#: the reference's on-device gate for its flash backward (bench.py:339):
#: (T, heads, head dim) of its two f32 checks at B 1
P21_GATE = ((2048, 2, 64), (4096, 2, 128))


def _flash_gate_case(t: int, heads: int, d: int, rng) -> dict:
    """The reference's gate (bench.py:339) on the card: gradients of
    sum(o * sin(o)) through #1/#2 (f32 inputs: the FMA bodies) against
    dense attention's autograd in f32 (TF32 off), ``err < 0.02 * scale +
    0.01`` per gradient, inputs 0.5 * N(0, 1) from the shared generator."""
    import torch

    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops.attention import attention

    xs = [torch.from_numpy(rng.normal(size=(1, t, heads, d)).astype(
        "float32") * 0.5).cuda() for _ in range(3)]

    def grads(fn):
        leaves = [x.clone().requires_grad_() for x in xs]
        o = fn(*leaves)
        (o * torch.sin(o)).sum().backward()
        return [x.grad for x in leaves]

    got = grads(lambda q, k, v: fa.flash_attention_trainable(
        q, k, v, causal=True))
    ref = grads(lambda q, k, v: attention(q, k, v, causal=True))
    flat = torch.empty((heads, t, d), device="meta")
    CHECKED_SHAPES.add(_attn_key("flash_attn_fwd", flat, True))
    CHECKED_SHAPES.add(_attn_key("flash_attn_bwd", flat, True))
    ok, worst = True, []
    for name, a, b in zip(("dQ", "dK", "dV"), got, ref):
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        ok = ok and err < 0.02 * scale + 0.01
        worst.append(f"{name} {err:.3e} (scale {scale:.3e})")
    log(f"kernel flash gate (bench.py:339) T={t} heads={heads} D={d} f32 "
        f"(bodies {fa.fwd_body(torch.float32, d)}/"
        f"{fa.bwd_body(torch.float32, d)}): {', '.join(worst)}, tol 0.02 * "
        f"scale + 0.01 -> {'ok' if ok else 'FAIL'}")
    return dict(ok=ok)


def p21_gqa_config(int8: bool = False, use_flash: bool = True,
                   max_len: int = P21_PROMPT + P21_NEW + 1):
    """The -gqa-8kctx model: GPT-2-small widths, n_kv_heads 2 of 6, RoPE,
    bf16; ``int8`` the ``--int8 full`` row (int8 weights and cache)."""
    import dataclasses

    return dataclasses.replace(
        gpt2s_config(n_kv_heads=2, rope=True, decode_int8=int8),
        max_len=max_len, use_flash=use_flash)


def p21_train_config(seq: int, n_layers: int = 8):
    import torch

    from deeplearning4j_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(**{**P21_TRAIN_WIDTHS, "n_layers": n_layers},
                             max_len=seq + 1, use_flash=True, remat=False,
                             scan_layers=False, compute_dtype=torch.bfloat16)


def p21_train(card: str) -> dict[str, int]:
    """(A): bench.py's long-context training rows through
    ``transformer_train_step`` with AdamW(3e-4), a warm-up and 4 timed
    steps each; then flash vs dense on a 2-layer cut at T 8,192, B 1."""
    import dataclasses

    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models.transformer import (
        AdamW,
        _leaves,
        _tree,
        init_params,
        transformer_loss,
        transformer_train_step,
        value_and_grad,
    )

    total: dict[str, int] = {}
    for name, (seq, batch) in P21_TRAIN.items():
        cfg = p21_train_config(seq)
        t0 = time.perf_counter()
        step, init_state, shard_tokens = transformer_train_step(
            None, cfg, optimizer=AdamW(P21_LR))
        params, opt_state = init_state(0)
        toks = shard_tokens(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (batch, seq + 1)))
        losses = []
        for _ in range(P21_WARMUP):
            params, opt_state, loss = step(params, opt_state, toks)
            losses.append(loss)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(P21_STEPS):
            params, opt_state, loss = step(params, opt_state, toks)
            losses.append(loss)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        _add(total, launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = [float(x) for x in losses]
        ms = wall / P21_STEPS * 1e3
        tok_s = batch * seq / (wall / P21_STEPS)
        share = lm_flops_per_token(cfg.d_model, cfg.n_layers, cfg.d_ff,
                                   cfg.vocab_size, seq) * tok_s / BF16_FLOPS
        tag = f"phase 21a {name}"
        log(f"{tag}: {cfg.d_model}d x {cfg.n_layers}L, {cfg.n_heads}x"
            f"{cfg.head_dim} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
            f"seq {seq}, batch {batch}, flash, no remat, bf16, AdamW("
            f"{P21_LR}); set-up and {P21_WARMUP} warm-up step "
            f"{setup:.1f} s; launches in the {P21_STEPS} timed steps "
            f"{launches}")
        log(f"{tag}: losses {' '.join(f'{x:.4f}' for x in losses)}; {ms:.2f} "
            f"ms/step, {tok_s:.1f} tokens/s, {share:.4f} of "
            f"{BF16_FLOPS / 1e12:.0f} TFLOP/s bf16, peak memory {peak:.2f} "
            f"GiB [{card}]")
        _launch_check(tag, launches, ("flash_attn_fwd", "flash_attn_bwd"))
        _must(tag, launches["flash_attn_fwd"] == P21_STEPS * cfg.n_layers
              and launches["flash_attn_bwd"] == P21_STEPS * cfg.n_layers,
              "#1/#2 did not launch once a layer and step")
        _must(tag, all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"losses not finite or not falling: {losses}")
        del params, opt_state, step
        torch.cuda.empty_cache()

    cfg = p21_train_config(P21_PARITY_SEQ, P21_PARITY_LAYERS)
    params = init_params(cfg, seed=0)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, P21_PARITY_SEQ + 1))).cuda()

    def run(c):
        fresh = _tree((path, p.detach().clone())
                      for path, p in _leaves(params))
        loss, grads = value_and_grad(transformer_loss(c), fresh, toks)
        return float(loss), dict(_leaves(grads))

    reset_launches()
    flash = run(cfg)
    _add(total, read_launches())
    dense = run(dataclasses.replace(cfg, use_flash=False))
    rel = abs(flash[0] - dense[0]) / abs(dense[0])
    cos = {}
    for path, g in flash[1].items():
        a, b = g.double().flatten(), dense[1][path].double().flatten()
        cos["/".join(path)] = (a @ b / (a.norm() * b.norm())).item()
    worst = min(cos, key=cos.get)
    log(f"phase 21a parity ({P21_PARITY_LAYERS} layers, T {P21_PARITY_SEQ}, "
        f"B 1): loss flash {flash[0]:.6f} dense {dense[0]:.6f} (rel "
        f"{rel:.2e}, tol {PARITY_LOSS_RTOL}); min grad cosine "
        f"{cos[worst]:.6f} at {worst} (tol {PARITY_COSINE})")
    _must("phase 21a parity", rel <= PARITY_LOSS_RTOL
          and cos[worst] >= PARITY_COSINE,
          "flash training disagrees with dense attention")
    del params, flash, dense
    torch.cuda.empty_cache()
    return total


def _first_diff(a, b) -> int | None:
    import numpy as np

    d = np.nonzero(a != b)[0]
    return int(d[0]) if d.size else None


def _near_tie_rows(tag: str, got, ref, logits, n_prompt: int) -> list[str]:
    """Rows of ``got`` (B, T) held against ``ref``: identical, or the first
    mismatch at a near-tie of ``logits`` (new, B, V), the side ``ref``
    came from; fails otherwise."""
    import torch

    verdicts = []
    for row in range(got.shape[0]):
        i = _first_diff(got[row, n_prompt:], ref[row, n_prompt:])
        if i is None:
            verdicts.append("identical")
            continue
        top2 = torch.topk(logits[i, row].float(), 2).values.tolist()
        gap = top2[0] - top2[1]
        _must(tag, gap < NEAR_TIE, f"row {row} leaves the reference at "
              f"generated position {i} with a top-2 gap {gap:.4g}")
        verdicts.append(f"near-tie at {i} (gap {gap:.4g})")
    return verdicts


def p21_generate(card: str) -> dict[str, int]:
    """(B): ``transformer_generate`` at 8k context, B 16, bf16 and int8
    full; prefill ms (a generate of one token) and decode tokens/s; then
    at B 1 flash prefill against dense prefill."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models.transformer import (
        init_params,
        quantize_decode_params,
        transformer_generate,
    )

    total: dict[str, int] = {}
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, p21_gqa_config().vocab_size, (P21_BATCH, P21_PROMPT))).cuda()
    runs = {}
    for int8 in (False, True):
        cfg = p21_gqa_config(int8)
        params = init_params(cfg, seed=0)
        if int8:
            params = quantize_decode_params(params, cfg)
        gen = transformer_generate(cfg)
        mode = "int8 full" if int8 else "bf16"
        tag = f"phase 21b {mode}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen(params, prompt, 1, temperature=0.0)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        toks, logits = gen(params, prompt, P21_NEW, temperature=0.0,
                           return_logits=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        _add(total, launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        toks = toks.cpu().numpy()
        decode_tok_s = P21_BATCH * (P21_NEW - 1) / max(wall - prefill_s,
                                                       1e-9)
        log(f"{tag}: GPT-2-small widths, {cfg.n_heads} query heads over "
            f"{cfg.kv_heads} KV heads of {cfg.head_dim}, RoPE, max_len "
            f"{cfg.max_len}; B {P21_BATCH}, prompt {P21_PROMPT}, "
            f"{P21_NEW} new (Tpad {P21_TPAD}); launches {launches}")
        log(f"{tag}: prefill (a generate of 1 token) {prefill_s * 1e3:.1f} "
            f"ms, generate of {P21_NEW} {wall * 1e3:.1f} ms, decode "
            f"{decode_tok_s:.1f} tokens/s, peak memory {peak:.2f} GiB "
            f"[{card}]")
        decode = "flash_decode_int8" if int8 else "flash_decode"
        _launch_check(tag, launches, ("flash_attn_fwd", decode),
                      ("flash_decode_int8",) if not int8 else
                      ("flash_decode",))
        _must(tag, toks.shape == (P21_BATCH, P21_PROMPT + P21_NEW)
              and ((toks >= 0) & (toks < cfg.vocab_size)).all()
              and bool(torch.isfinite(logits).all()),
              "tokens out of range or logits not finite")
        runs[int8] = toks
        del params, gen, logits
        torch.cuda.empty_cache()
    agree = runs[True][:, P21_PROMPT:] == runs[False][:, P21_PROMPT:]
    firsts = [_first_diff(runs[True][r, P21_PROMPT:],
                          runs[False][r, P21_PROMPT:])
              for r in range(P21_BATCH)]
    log(f"phase 21b: int8 full vs bf16 tokens: {agree.mean():.4f} of the "
        f"generated tokens equal, rows identical "
        f"{sum(f is None for f in firsts)}/{P21_BATCH}, first divergence "
        f"per row {firsts}")

    # B 1: flash prefill vs dense prefill, the dense side's logits judge
    cfg = p21_gqa_config(False)
    params = init_params(cfg, seed=0)
    one = prompt[:1]
    reset_launches()
    flash_toks, _ = transformer_generate(cfg)(
        params, one, P21_B1_NEW, temperature=0.0, return_logits=True)
    _add(total, read_launches())
    dense_toks, dense_logits = transformer_generate(
        p21_gqa_config(False, use_flash=False))(
        params, one, P21_B1_NEW, temperature=0.0, return_logits=True)
    verdict = _near_tie_rows("phase 21b B 1", flash_toks.cpu().numpy(),
                             dense_toks.cpu().numpy(), dense_logits,
                             P21_PROMPT)
    log(f"phase 21b B 1: flash prefill vs dense prefill, {P21_B1_NEW} new: "
        f"{verdict[0]}")
    del params
    torch.cuda.empty_cache()
    return total


def p21_requests(vocab: int):
    """bench.py:1051's trace: (arrival s, prompt) of 24 requests, the 4
    long prompts spread through the middle."""
    import numpy as np

    rng = np.random.default_rng(0)
    arrivals = np.cumsum(rng.exponential(P21_INTERARRIVAL, P21_REQS))
    shared = rng.integers(0, vocab, (P21_SHORT - P21_SUFFIX,))
    uniq = rng.integers(0, vocab, (P21_REQS, P21_SHORT))
    longs = rng.integers(0, vocab, (P21_LONG, P21_PROMPT))
    long_at = sorted(set(np.linspace(P21_REQS // 4, 3 * P21_REQS // 4,
                                     P21_LONG).astype(int).tolist()))
    out = []
    for i in range(P21_REQS):
        if i in long_at:
            prompt = longs[long_at.index(i)]
        elif i % 2 == 0:
            prompt = np.concatenate([shared, uniq[i, :P21_SUFFIX]])
        else:
            prompt = uniq[i]
        out.append((float(arrivals[i]), prompt))
    return out


def _p21_serve_run(tag: str, cfg, params, trace, *, paged: bool,
                   piggyback: bool, card: str):
    """One engine over the trace through ``run_request_trace``, requests
    submitted at their arrival times; returns (streams, launches, TTFT of
    the long prompts, TPOT p99 of the short streams, engine)."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.serving import (
        Request,
        ServingEngine,
        run_request_trace,
    )

    engine = ServingEngine(
        cfg, params, n_slots=P21_SLOTS,
        max_total=P21_PROMPT + P21_SERVE_NEW + 1, temperature=0.0,
        prefix_cache=True, prefill_max_bucket=P21_BUCKET,
        piggyback=piggyback, paged=paged, block_size=BLOCK_SIZE)
    _must(tag, engine._paged == paged and engine._piggyback == piggyback
          and engine.pool.tpad == P21_TPAD,
          f"engine came up paged {engine._paged}, piggyback "
          f"{engine._piggyback}, Tpad {engine.pool.tpad}")
    reqs = [Request(prompt=p, max_new=P21_SERVE_NEW) for _, p in trace]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    run_request_trace(engine, [(t, r) for (t, _), r in zip(trace, reqs)],
                      time_scale=1.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    for r in reqs:
        out = engine.results[r.id]
        _must(tag, r.status.value == "finished"
              and out.shape == (len(r.prompt) + P21_SERVE_NEW,),
              f"request {r.id} came back {r.status}")
    longs = [r for r in reqs if len(r.prompt) == P21_PROMPT]
    shorts = [r for r in reqs if len(r.prompt) != P21_PROMPT]
    ttft = [r.timing["ttft_s"] for r in longs]
    tpot = [r.timing["decode_s"] / (P21_SERVE_NEW - 1) for r in shorts]
    m = engine.metrics
    s = m.summary()
    log(f"{tag}: {len(reqs)} requests in {wall:.2f} s, "
        f"{s['n_generated'] / wall:.1f} generated tok/s; TTFT of the "
        f"{P21_PROMPT}-token prompts {' '.join(f'{x * 1e3:.1f}' for x in ttft)}"
        f" ms; short streams' TPOT p50 {np.percentile(tpot, 50) * 1e3:.3f} "
        f"p99 {np.percentile(tpot, 99) * 1e3:.3f} ms; {m.n_prefill_chunks} "
        f"chunks deferred, decode stall {m.decode_stall_seconds:.4f} s; "
        f"prefix hits {s.get('prefix_hits', 0)}; launches {launches} "
        f"[{card}]")
    return ([engine.results[r.id] for r in reqs], launches, ttft,
            float(np.percentile(tpot, 99)), engine)


def p21_serve(card: str) -> dict[str, int]:
    """(C): the serving engine on bench.py:1051's trace, slab and paged
    (bs 8), piggyback off and on: streams byte-identical across the four
    runs, paged blocks all back, and every stream against
    ``transformer_generate`` on its prompt (identical, or a near-tie)."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models.transformer import (
        init_params,
        transformer_generate,
    )

    total: dict[str, int] = {}
    cfg = p21_gqa_config(False, max_len=P21_PROMPT + P21_SERVE_NEW + 1)
    params = init_params(cfg, seed=0)
    trace = p21_requests(cfg.vocab_size)
    runs = {}
    for paged in (False, True):
        for pb in (False, True):
            layout = "paged bs 8" if paged else "slab"
            tag = f"phase 21c {layout}, piggyback {'on' if pb else 'off'}"
            streams, launches, _, _, engine = _p21_serve_run(
                tag, cfg, params, trace, paged=paged, piggyback=pb,
                card=card)
            decode = "flash_decode_paged" if paged else "flash_decode"
            _launch_check(tag, launches, ("flash_attn_fwd", decode))
            _add(total, launches)
            if pb:
                _must(tag, engine.metrics.n_prefill_chunks > 0,
                      "no chunk was deferred")
            if paged:
                held = engine.pool.n_blocks_in_use
                while engine.prefix_cache.reclaim():
                    pass
                log(f"{tag}: blocks in use after the run {held} (the "
                    f"prefix cache's), after evicting it "
                    f"{engine.pool.n_blocks_in_use}")
                _must(tag, engine.pool.n_blocks_in_use == 0,
                      "blocks did not come back")
            runs[(paged, pb)] = streams
            del engine
            torch.cuda.empty_cache()
    base = runs[(False, False)]
    for key, streams in runs.items():
        same = [np.array_equal(a, b) for a, b in zip(base, streams)]
        _must(f"phase 21c {key}", all(same), f"streams differ from the "
              f"blocking slab run ({sum(same)}/{len(same)} identical)")
    log("phase 21c: every run's streams byte-identical to the blocking slab "
        "run's")
    # the engine's streams against generate, the long prompts and the
    # short ones each as one batch
    gen = transformer_generate(cfg)
    for want in (P21_PROMPT, P21_SHORT):
        rows = [i for i, (_, p) in enumerate(trace) if len(p) == want]
        prompts = torch.from_numpy(np.stack([trace[i][1] for i in rows]))
        toks, logits = gen(params, prompts.cuda(), P21_SERVE_NEW,
                           temperature=0.0, return_logits=True)
        got = np.stack([base[i] for i in rows])
        verdict = _near_tie_rows(f"phase 21c vs generate ({want})", got,
                                 toks.cpu().numpy(), logits, want)
        log(f"phase 21c: engine vs transformer_generate on the {len(rows)} "
            f"prompts of {want} tokens: {verdict}")
    del params
    torch.cuda.empty_cache()
    return total


def phase_long_context(card: str) -> dict[str, dict[str, int]]:
    """Phase 21: long context at the reference's widths: training at T
    8,192 and 32,768, generate at 8k context in bf16 and int8 full, the
    serving engine with 8,192-token prompts; fails on a launch at a shape
    phase 2 did not hold."""
    t0 = time.perf_counter()
    with launched_shapes() as seen:
        out = {"long_train": p21_train(card),
               "long_generate": p21_generate(card),
               "long_serve": p21_serve(card)}
    check_launched("phase 21", seen)
    log(f"phase 21: {time.perf_counter() - t0:.1f} s wall [{card}]")
    return out


# -- phase 22: the serve trace -----------------------------------------------

#: bench.py's serve row (``_bench_decode_serve``, :784, on
#: ``_decode_bench_cfg(gqa=True)``, :579): GPT-2-small widths, 6 query heads
#: over 2 KV heads, RoPE, bf16, flash prefill; 48 requests of 512 prompt
#: tokens from default_rng(0) and 64 new, exponential arrivals of mean 10
#: ms, 16 slots, a queue of 48, top-k 40 (approx, as the bench asks)
P22_SLOTS, P22_REQS, P22_PROMPT, P22_NEW = 16, 48, 512, 64
P22_INTERARRIVAL = 0.01
#: the engine's largest prefill bucket: at the default 128 a 512-token
#: prompt goes through four dense chunk windows, at 512 through #1
P22_BUCKET = 512
#: (b): bench.py:829-845's faults row, sampled at T 1.0
P22_FAULT_SEED, P22_TRANSIENT_RATE = 1234, 0.02
P22_BACKOFF, P22_MAX_BACKOFF = 0.002, 0.05
#: (c): crashes drawn at rate 0.02 from seed 1 (the 62nd and 94th fault
#: checks), capped at 2
P22_CRASH_SEED, P22_CRASH_RATE, P22_CRASH_MAX = 1, 0.02, 2
#: (d): 8 of the trace's requests flooded into 1 slot behind a queue of 2
P22_BP_REQS, P22_BP_DEPTH = 8, 2
#: (e): the steps ``run(max_steps=...)`` stops after, on (a)'s first 16
#: requests
P22_MAX_STEPS = 20
#: the engine's rows a slot: 512 + 64 + 1 positions rounded up to 8
P22_TPAD = 584
#: decode positions phase 2 holds #3/#4 at for phase 22's 16 slots: the
#: first decode position, every 4th after it, the last
P22_POS = [P22_PROMPT + 4 * i for i in range(15)] + [P22_PROMPT + P22_NEW - 1]
P22_DEVICE = "cuda"
P22_DIR = ROOT / ".scratch" / "chip_smoke_phase22"


def p22_config():
    return p21_gqa_config(False, max_len=P22_PROMPT + P22_NEW + 1)


def p22_trace(vocab: int):
    """bench.py:871-875: arrival offsets (s) and prompts, from
    default_rng(0)."""
    import numpy as np

    rng = np.random.default_rng(0)
    arrivals = np.cumsum(rng.exponential(P22_INTERARRIVAL, P22_REQS))
    prompts = rng.integers(0, vocab, (P22_REQS, P22_PROMPT)).astype(np.int32)
    return arrivals, prompts


def _p22_sync() -> None:
    import torch

    if P22_DEVICE != "cpu":
        torch.cuda.synchronize()


def _p22_engine(cfg, params, *, temperature: float = 0.0, horizon: int = 1,
                faults=None, paged: bool = False, metrics=None,
                n_slots: int = P22_SLOTS, depth: int = P22_REQS):
    """bench.py:877-889's ``make_engine``, with the 512-token bucket."""
    from deeplearning4j_tpu_torch.serving import (
        RequestScheduler,
        ServingEngine,
    )

    return ServingEngine(
        cfg, params, n_slots=n_slots, temperature=temperature, top_k=40,
        approx_top_k=True, decode_horizon=horizon,
        scheduler=RequestScheduler(max_queue_depth=depth), faults=faults,
        retry_backoff_s=P22_BACKOFF, max_backoff_s=P22_MAX_BACKOFF,
        prefill_max_bucket=P22_BUCKET, paged=paged, block_size=BLOCK_SIZE,
        metrics=metrics, device=P22_DEVICE)


def _p22_requests(trace, n: int = P22_REQS):
    from deeplearning4j_tpu_torch.serving import Request

    arrivals, prompts = trace
    return [(float(arrivals[i]), Request(prompt=prompts[i], max_new=P22_NEW))
            for i in range(n)]


def _p22_fresh_metrics(engine) -> None:
    """A warm engine's metrics started over, as bench.py:917-919 does
    before its timed replay."""
    from deeplearning4j_tpu_torch.serving import ServingMetrics

    engine.metrics = ServingMetrics()
    engine.metrics.decode_horizon = engine.decode_horizon
    engine.metrics.device = engine.device


def _p22_replay(tag: str, engine, trace, *, time_scale: float = 0.0,
                n: int = P22_REQS, **kw):
    """One ``run_request_trace`` of the trace's first ``n`` requests, every
    launch count set to 0 just before and read just after; every request
    must finish with its 64 tokens. Returns (streams, launches, wall s)."""
    from deeplearning4j_tpu_torch.serving import run_request_trace

    reqs = _p22_requests(trace, n)
    _p22_sync()
    reset_launches()
    t0 = time.perf_counter()
    res = run_request_trace(engine, reqs, time_scale=time_scale, **kw)
    _p22_sync()
    wall = time.perf_counter() - t0
    launches = read_launches()
    for _, r in reqs:
        out = res[r.id]
        _must(tag, r.status.value == "finished"
              and out.shape == (P22_PROMPT + P22_NEW,),
              f"request {r.id} came back {r.status}, {out.shape}")
    return [res[r.id] for _, r in reqs], launches, wall


def _p22_same(tag: str, got, want, what: str) -> None:
    import numpy as np

    same = [np.array_equal(a, b) for a, b in zip(got, want)]
    _must(tag, all(same), f"streams differ from {what} ({sum(same)}/"
          f"{len(same)} identical)")


def _p22_figures(tag: str, engine, wall: float, card: str) -> None:
    s = engine.metrics.summary()
    fig = dict(tok_s=s["n_generated"] / wall,
               ttft_p50_ms=s["ttft_p50_s"] * 1e3,
               ttft_p99_ms=s["ttft_p99_s"] * 1e3,
               tpot_p50_ms=s["tpot_p50_s"] * 1e3,
               tpot_p99_ms=s["tpot_p99_s"] * 1e3,
               occupancy_mean=s["occupancy_mean"])
    log(f"{tag}: {s['n_finished']} requests, {s['n_generated']} tokens in "
        f"{wall:.3f} s -> {fig['tok_s']:.1f} generated tok/s; TTFT p50 "
        f"{fig['ttft_p50_ms']:.2f} ms p99 {fig['ttft_p99_ms']:.2f} ms; TPOT "
        f"p50 {fig['tpot_p50_ms']:.3f} ms p99 {fig['tpot_p99_ms']:.3f} ms; "
        f"occupancy {fig['occupancy_mean']:.2f} of {P22_SLOTS} slots; "
        f"{s['steps']} horizons [{card}]")


def p22_greedy(card: str, cfg, params, trace, total: dict):
    """(a) greedy at ``time_scale=0``: K 1 (its metrics through the JSONL
    writer, (f)), K 4 and paged (bs 8), byte-identical, every paged block
    back, each stream against ``transformer_generate`` on its prompt
    (identical, or a near-tie); (e) ``run(max_steps)`` on the K 1 engine.
    Returns the K 1 and K 4 engines (warm, for (g)) and the K 1 streams."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models.transformer import (
        transformer_generate,
    )
    from deeplearning4j_tpu_torch.serving import ServingMetrics
    from deeplearning4j_tpu_torch.utils.metrics import MetricsWriter

    shutil.rmtree(P22_DIR, ignore_errors=True)
    path = P22_DIR / "serve.jsonl"
    writer = MetricsWriter(path)
    k1 = _p22_engine(cfg, params, metrics=ServingMetrics(writer=writer))
    tag = "phase 22a K 1"
    _must(tag, k1.pool.tpad == P22_TPAD and k1.n_slots == P22_SLOTS,
          f"the engine came up with Tpad {k1.pool.tpad}")
    streams, launches, _ = _p22_replay(tag, k1, trace)
    writer.close()
    _launch_check(tag, launches, ("flash_attn_fwd", "flash_decode"))
    _add(total, launches)
    # (f): the reference's four checked tags, one occupancy record a step
    records = MetricsWriter.read(path)
    shutil.rmtree(P22_DIR, ignore_errors=True)
    tags = {r["tag"] for r in records}
    s = k1.metrics.summary()
    occ = [r["value"] for r in records if r["tag"] == "serve/occupancy"]
    want = {"serve/ttft_seconds", "serve/tpot_seconds", "serve/occupancy",
            "serve/queue_depth"}
    _must("phase 22f", want <= tags, f"tags missing: {want - tags}")
    _must("phase 22f", len(occ) == s["steps"] and max(occ) <= P22_SLOTS,
          f"{len(occ)} occupancy records for {s['steps']} steps, max "
          f"{max(occ)}")
    log(f"phase 22f: {len(records)} JSONL records, tags {sorted(tags)}; "
        f"{len(occ)} serve/occupancy records = {s['steps']} steps, max "
        f"{max(occ):g} <= {P22_SLOTS}")
    _p22_fresh_metrics(k1)  # the writer is closed

    k4 = _p22_engine(cfg, params, horizon=4)
    tag = "phase 22a K 4"
    got, launches, _ = _p22_replay(tag, k4, trace)
    _launch_check(tag, launches, ("flash_attn_fwd", "flash_decode"))
    _add(total, launches)
    _p22_same(tag, got, streams, "K 1's")

    paged = _p22_engine(cfg, params, paged=True)
    tag = "phase 22a paged bs 8"
    _must(tag, paged._paged, "the engine did not come up paged")
    got, launches, _ = _p22_replay(tag, paged, trace)
    _launch_check(tag, launches, ("flash_attn_fwd", "flash_decode_paged"),
                  ("flash_decode",))
    _add(total, launches)
    _p22_same(tag, got, streams, "the slab K 1 run's")
    _must(tag, paged.pool.n_blocks_in_use == 0,
          f"{paged.pool.n_blocks_in_use} blocks still in use")
    del paged
    log("phase 22a: K 1, K 4 and paged streams byte-identical; 0 blocks "
        "in use after the paged run")

    gen = transformer_generate(cfg)
    verdicts = []
    for lo in range(0, P22_REQS, P22_SLOTS):
        rows = range(lo, lo + P22_SLOTS)
        prompts = torch.from_numpy(trace[1][lo:lo + P22_SLOTS]).long()
        toks, logits = gen(params, prompts.to(P22_DEVICE), P22_NEW,
                           temperature=0.0, return_logits=True)
        verdicts += _near_tie_rows(
            "phase 22a vs generate", np.stack([streams[i] for i in rows]),
            toks.cpu().numpy(), logits, P22_PROMPT)
    log(f"phase 22a: engine vs transformer_generate (B {P22_SLOTS} a "
        f"call), {sum(v == 'identical' for v in verdicts)}/{P22_REQS} "
        f"identical, others {[v for v in verdicts if v != 'identical']}")

    # (e): run(max_steps) stops with work left; run() finishes the same.
    # The first wave of (a) alone: the same 16 prompts admitted together
    tag = "phase 22e"
    reqs = [r for _, r in _p22_requests(trace, P22_SLOTS)]
    reset_launches()
    for r in reqs:
        k1.submit(r)
    k1.run(max_steps=P22_MAX_STEPS)
    _must(tag, not k1.idle, f"the engine went idle within "
          f"{P22_MAX_STEPS} steps")
    left = sum(r.status.value != "finished" for r in reqs)
    res = k1.run()
    _p22_sync()
    _add(total, read_launches())
    _p22_same(tag, [res[r.id] for r in reqs], streams, "(a)'s")
    log(f"{tag}: run(max_steps={P22_MAX_STEPS}) returned with the engine "
        f"not idle ({left} of {len(reqs)} requests open); run() then gave "
        f"(a)'s streams")
    return k1, k4, streams


def p22_faults(card: str, cfg, params, trace, total: dict,
               streams) -> None:
    """(b) sampled under seeded transient faults vs a clean sampled engine;
    (c) greedy under seeded crashes vs (a), and with ``max_restarts=0``."""
    from deeplearning4j_tpu_torch.serving import EngineCrash, FaultInjector

    tag = "phase 22b"
    clean, launches, _ = _p22_replay(
        tag + " clean", _p22_engine(cfg, params, temperature=1.0), trace)
    _launch_check(tag + " clean", launches,
                  ("flash_attn_fwd", "flash_decode", "threefry_draw"))
    _add(total, launches)
    faulted = _p22_engine(cfg, params, temperature=1.0,
                          faults=FaultInjector(
                              seed=P22_FAULT_SEED,
                              transient_rate=P22_TRANSIENT_RATE))
    got, launches, _ = _p22_replay(tag + " faults", faulted, trace)
    _add(total, launches)
    m = faulted.metrics
    _p22_same(tag, got, clean, "the clean sampled run's")
    _must(tag, m.n_retries > 0, "no transient fault was retried")
    log(f"{tag}: sampled (T 1.0, top-k 40) under transient faults at rate "
        f"{P22_TRANSIENT_RATE} (seed {P22_FAULT_SEED}): {m.n_retries} "
        f"retries, {m.n_restarts} restarts; streams byte-identical to the "
        f"clean run's")
    del faulted

    def crashing():
        return _p22_engine(cfg, params, faults=FaultInjector(
            seed=P22_CRASH_SEED, crash_rate=P22_CRASH_RATE,
            max_faults=P22_CRASH_MAX))

    tag = "phase 22c"
    engine = crashing()
    got, launches, _ = _p22_replay(tag, engine, trace)
    _add(total, launches)
    n = engine.metrics.n_restarts
    _must(tag, n >= 1, "the engine never crashed")
    _p22_same(tag, got, streams, "(a)'s K 1 run's")
    mode = engine.last_recover_mode or "no slot live"
    del engine
    engine = crashing()
    try:
        _p22_replay(tag + " max_restarts 0", engine, trace, max_restarts=0)
    except EngineCrash as e:
        raised = str(e)
    else:
        raised = None
    _p22_sync()
    _add(total, read_launches())
    _must(tag, raised is not None, "max_restarts=0 did not raise")
    log(f"{tag}: {n} crashes recovered by replay (the last: {mode}), streams "
        f"byte-identical to (a)'s; with max_restarts=0 EngineCrash "
        f"propagated ({raised})")


def p22_backpressure(card: str, cfg, params, trace, total: dict) -> None:
    """(d): 8 requests flooded into 1 slot behind a queue of 2."""
    tag = "phase 22d"
    engine = _p22_engine(cfg, params, horizon=4, n_slots=1,
                         depth=P22_BP_DEPTH)
    _, launches, wall = _p22_replay(tag, engine, trace, n=P22_BP_REQS)
    _add(total, launches)
    m = engine.metrics
    _must(tag, m.n_backpressure > 0, "no submit was refused")
    log(f"{tag}: {P22_BP_REQS} requests into 1 slot behind a queue of "
        f"{P22_BP_DEPTH}: {m.n_backpressure} submits refused and retried, "
        f"all {m.n_finished} finished in {wall:.2f} s")


def phase_serve_trace(card: str) -> dict[str, dict[str, int]]:
    """Phase 22: bench.py's serve trace at GPT-2-small width through the
    port's ``run_request_trace``: (a) greedy K 1 / K 4 / paged, (b)
    faults, (c) crashes, (d) backpressure, (e) ``run(max_steps)``, (f) the
    JSONL writer, (g) the timed replays at ``time_scale=1``; fails on a
    launch at a shape phase 2 did not hold."""
    import torch

    from deeplearning4j_tpu_torch.models.transformer import init_params

    t0 = time.perf_counter()
    cfg = p22_config()
    params = init_params(cfg, seed=0, device=P22_DEVICE)
    trace = p22_trace(cfg.vocab_size)
    total: dict[str, int] = {}
    with launched_shapes() as seen:
        k1, k4, streams = p22_greedy(card, cfg, params, trace, total)
        # (g): the warm K 1 and K 4 engines, metrics started over, replay
        # at the trace's own arrival times
        for k, engine in ((1, k1), (4, k4)):
            _p22_fresh_metrics(engine)
            tag = f"phase 22g K {k}"
            _, launches, wall = _p22_replay(tag, engine, trace,
                                            time_scale=1.0)
            _add(total, launches)
            _p22_figures(tag, engine, wall, card)
        del k1, k4
        p22_faults(card, cfg, params, trace, total, streams)
        p22_backpressure(card, cfg, params, trace, total)
    check_launched("phase 22", seen)
    del params
    if P22_DEVICE != "cpu":
        torch.cuda.empty_cache()
    log(f"phase 22: launches {total}; {time.perf_counter() - t0:.1f} s wall "
        f"[{card}]")
    return {"serve_trace": total}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "deeplearning4j_tpu_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repo "
              "(deeplearning4j_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log(f"card: {card}")
    phase_build()
    w2v_model, w2v_corpus = w2v_full_model()
    measured = phase_kernels(w2v_model, w2v_corpus)
    with launched_shapes() as early:
        engine, serve_launches, streams = phase_serve()
        phase_server(engine)
        del engine
        _, int8_launches, int8_streams = phase_serve(int8=True)
        by_phase = {
            "serve": serve_launches,
            "serve_int8": int8_launches,
            "serve_paged": phase_serve_paged(False, streams),
            "serve_paged_int8": phase_serve_paged(True, int8_streams),
        }
        torch.cuda.empty_cache()  # the serving engines' caches go back
        phase_train_parity()
        by_phase["train"] = phase_train(card)
        by_phase.update(phase_word2vec(w2v_model, w2v_corpus, card))
    check_launched("phases 3-6", early)
    # phase 18 trains again over phase 6's vocabulary: keep it, free the
    # tables
    w2v_model.syn0 = w2v_model.syn1 = w2v_model.syn1neg = None
    by_phase.update(phase_decode_variants(card))
    by_phase.update(phase_serving_features(card))
    by_phase.update(phase_surface(card))
    by_phase.update(phase_front_end(card))
    workdir = ROOT / ".scratch" / "chip_smoke_phase11"
    shutil.rmtree(workdir, ignore_errors=True)
    try:
        by_phase.update(phase_single_engine(card, workdir))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    by_phase.update(phase_fleet(card))
    shutil.rmtree(TP_PROBES.parent, ignore_errors=True)
    try:
        by_phase.update(phase_tp(card))
    finally:
        shutil.rmtree(TP_PROBES.parent, ignore_errors=True)
    by_phase.update(phase_moe_mesh(card))
    by_phase.update(phase_mesh_cluster(card))
    by_phase.update(phase_dl4j_core(card))
    with launched_shapes() as late:
        by_phase.update(phase_dl4j_parallel(card))
    check_launched("phase 17", late)
    with launched_shapes() as last:
        by_phase.update(phase_nlp_vectors(card, w2v_model, w2v_corpus))
    check_launched("phase 18", last)
    by_phase.update(phase_tooling(card))
    by_phase.update(phase_model_axis(card))
    by_phase.update(phase_long_context(card))
    by_phase.update(phase_serve_trace(card))
    kernels = [
        dict(name=name, route="cuda", **KERNELS[name],
             launches=sum(p[name] for p in by_phase.values()),
             launches_per_phase={ph: p[name] for ph, p in by_phase.items()},
             **{k: v for k, v in measured[name].items() if k != "ok"})
        for name in KERNELS
    ]
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
