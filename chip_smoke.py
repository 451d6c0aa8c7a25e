#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``llm_d_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. build    compile the eight CUDA kernels from llm_d_tpu_torch/csrc
            (six sources, one nvcc each, in parallel: D, E and F share
            moe_streamed_int8.cu) and load them;
2. path (i) serve deepseek-v3-bench at full width and depth (random
            weights from a seed) through EngineCore as bench.py configures
            it: int8 experts, int8 latent cache, block size 64, steps of
            up to 8192 tokens, 32 scheduler steps per dispatch with async
            scheduling (each decode block one CUDA graph replay), the
            block pool sized as bench.py sizes it.  Wave 1 (8 x 128-token
            prompts, 32 new tokens), wave 2 (96 x 32, 16 new), wave 3 (64
            x 128, 16 new: the bench's prefill, one 8192-token step), wave
            1 again (must repeat token for token) and wave 3 under
            LLMD_MOE_PREFILL_KERNEL=grouped; every wave's decode must run
            in blocks of 32 steps.  Kernels A-F (MLA decode and prefill,
            dense / routed / streamed / grouped int8 MoE) must all
            launch, and A, C and D inside graph replays.  Then a sampled
            block (8 rows at temperature 0.7, half seeded); one replay of
            the S = 8 and S = 128 greedy graphs and of the sampled one,
            each bit-equal to the block's eager body on the same inputs
            and cache; and waves 1-3 served in alternating rounds (1 a
            side) by the classic loop (one step per dispatch, the same
            weights) and the bench-configured engine: greedy tokens
            identical, decode tok/s and prefill seconds of each side;
2b. path (iii) serve deepseek-v3-bench on path (i)'s weights as bench.py's
            bench_spec and bench_mixed configure it: speculative decode
            with K = 4 drafts (every step one fused mixed round), one
            scheduler step, 384 sequences, 1984 blocks.  (a) Wave 1 with
            real verification, twice (must repeat), against the classic
            loop: first tokens (a differing one is reported with the
            classic step's top-2 logit margin), equal tokens and the
            drafted / accepted counts; then once more with the classic
            run's MoE routing replayed, where every row must keep the
            classic tokens up to a near tie (top-2 margin within
            2 * 5e-2 * max|logit|); (b) a verify step (8 rows, 4 live
            drafts each) of the first two layers through kernels B and C
            against the CPU reference (which takes the card's expert
            choice and computes its own gate weights, within 5e-2 of the
            card's): relative max logit error <= 5e-2, the same argmax
            at every live position whose reference top-2 margin exceeds
            2 * 5e-2 * max|logit|; (c) bench_spec's
            shape, 256 x 128-token prompts and 128 new tokens at the
            fixed acceptance 0.7: a warm-up and 1 timed run (accepted
            decode tok/s, acceptance, tokens per step), every request
            ending by length, the pool whole after each run, the
            acceptance coin of a run's steps drawn on the card bit-equal
            to the CPU's; (d) bench_mixed's shape at share 0.25: 64
            joiners (128-token prompts, 64 new) added one per step to the
            256 decoding rows, twice (emitted tok/s, p99 step ms), kernel
            B at Q = 128 over more than 256 rows; (e) the OpenAI server
            in process over the engine: wave 1's prompts one at a time
            with logprobs = 5, each reply the direct engine's tokens for
            that prompt alone, every logprob finite and <= 0, every top-5
            list sorted and headed by the greedy token; then 24 mixed
            requests at once (greedy, logprobs 0 and 5, seeded and
            unseeded sampling), each ending by length, with the graph
            layer's keys, pool bytes and drops (``graph_bounds``) before
            and after.  Kernels B and E must launch on this path.  Every fused round is one CUDA
            graph replay (the witness run of (a) goes eagerly: its tape
            reads each batch on the host); each captured key is then
            replayed against its eager body, bit-equal;
2c. path (iv) serve deepseek-v3-bench on path (i)'s weights as bench.py's
            bench_everything_on configures it: spec decode (K = 4) with
            N = 4 fused rounds per dispatch and async scheduling (the
            fused multistep pipeline, each dispatch one CUDA graph
            replay), 256 sequences, 1344 blocks, EPLB on (one card: the
            identity placement; every dispatch's routed ids ride its
            graph's outputs into the tracker); its yardsticks are the
            same engine at N = 1 (each single fused round one replay) and
            at N = 4 with EPLB off.  (a) Wave 1 with real verification
            through the three: equal tokens between N = 4 and N = 1 and
            against the classic loop, each first difference with the
            classic step's top-2 margin and decision bar (reported), and
            EPLB on and off token for token (required); (b) 256 x
            128-token prompts, 128 new at the fixed acceptance 0.7, a
            warm-up and 1 timed run a side in alternating rounds:
            accepted decode tok/s (EPLB's collection cost is on against
            off), acceptance and engine steps per dispatch, the
            imbalance, the routed ids recorded and migrations (0), every
            request ending by length, the pool whole after each run, the
            coins of a run's steps drawn on the card bit-equal to the
            CPU's and each graph's coin input the CPU's coin of its
            rounds; (c) each captured fused key replayed against its
            eager body, bit-equal (outputs, and the cache outside the
            trash block 0); the graphs' pool bytes and each key's cold
            cost.  Kernels B and E must launch inside its graphs;
2d. path (v) P/D disaggregation and the tiered KV cache on path (i)'s
            weights.  (a) A producer with path (i)'s configuration and a
            consumer with its full configuration (32-step blocks, async)
            over the native transport on 127.0.0.1: wave 3 with
            ``do_remote_decode`` on the producer (its 8192-token prefill,
            kernels E and B), each request's blocks pulled by the consumer
            (which steps once every pull has landed), scattered, its last
            prompt token recomputed (A with C) and decoded in a graph
            replay: every cache buffer of every scattered block equal to
            the producer's bytes, the producer's pins all released (pool
            empty), the wire bytes a request (header + 2 blocks of int8
            latent rows and f32 scales), pull ms, the producer's prefill
            seconds, the consumer's admission-to-first-token seconds, and
            warm decode tok/s (a second run, the same tokens) beside path
            (i)'s wave 3; tokens against path (i)'s with the classic
            loop's margins, and a witness run with the classic routing
            replayed (consumer eager) that may leave the classic tokens
            only at near ties; then wave 1's prompts one at a time.
            (b) Path (i)'s configuration with the prefix cache on, 448
            blocks, and a 2048-block host tier, against the same engine
            without the tier: wave 1's prompts, decode waves (64 x 128,
            128 new: the flush runs under async decode) in alternating
            rounds after a warm-up a side (decode tok/s, tier on and
            off), until wave 1's prefix is evicted, then wave 1 again:
            each restored block's bytes equal the saved slab's, tokens
            equal the tier-less engine's second pass (a device prefix
            hit, the same batch shapes), decode blocks graph replays;
            saves, loads, flush and restore ms.  (c) Two
            ``python -m llm_d_tpu_torch.server.openai`` processes with
            path (i)'s flags and ``--kv-transfer-config`` (producer,
            consumer); this process plays the routing sidecar for wave
            1's prompts one at a time: tokens equal (a)'s, the
            consumer's ``kv_transfer_seconds_count`` 8, exit 0 on
            SIGTERM (logs in build/kv_*.log);
2e. path (vi) and the EPLB, attribution and sizing phases, on path
            (i)'s weights: (a) bench_eplb_skew's configuration (spec K =
            4 at 0.7, one scheduler step, 256 sequences, EPLB with a
            512-step window and a 32-step interval): before each run a
            Zipf(1.2) trace recorded into the tracker, a warm-up and 2
            runs of 256 x 128-token prompts with 128 new (accepted decode
            tok/s, ep, migrations (0 on one card), migrated MB, flip
            stall ms); kernels B and E inside its graphs; (b) the EPLB
            controller at ep = 4 on path (i)'s int8 experts (P = 68
            slots): install, a per-layer Zipf trace, on_step ticks
            staging on the controller's side stream until the flip
            (stage device and host ms, flip host ms, bytes): every
            serving tensor keeps its data_ptr(), the physical _q/_s
            planes equal the logical ones gathered by the final plans bit
            for bit, and kernels C, D and E through the new tables (T =
            16, 256, 2048) give the logical launch's output; (c) the
            attribution sweep as bench.py --stub runs it: bench_model's
            engine at batch sizes 64 and 256 (256 runs kernel D),
            unstubbed and with each of
            attn, moe_ffn and shared_expert stubbed (a warm-up of one
            decode block, one timed run each): decode and prefill ms per
            step and each component's cost by difference; (d) pool
            sizing from a 4 GiB budget on deepseek-v3-bench (int8 latent)
            and, in phase 3, llama3-1b (bf16, int8-token, int8-head): the
            derived num_blocks equals the arithmetic and the allocated
            cache num_blocks x kv_block_bytes;
3. path(ii) serve llama3-1b at full width and depth, block size 64,
            8192-token steps: 64 x 128-token prompts with 32 new tokens on
            a bf16 cache (twice: must repeat token for token; then with
            32 scheduler steps per dispatch and async scheduling on the
            same weights: the classic run's tokens), then once on an int8
            cache with one scale per row and once with one per KV head.
            Kernels G and H (dense paged decode, dense flash prefill)
            must launch, and G inside graph replays;
4. kernels  each kernel against its plain PyTorch version on the inputs
            of its first launch in phases 2-3 (A: of each batch size S;
            B: of each (S, Q); C and E: of each token count T -- E's
            T=8192 is the bench's step at the default 512-token chunks;
            G and H: of each cache mode; A and G also on 8 sequences x
            4096 keys made from a seed; E also on the bench's 8192-token
            step as one chunk; C also at T = 8, D at T = 256 and 512,
            its 64-row blocks, and F at 128-row tiles, made from a seed),
            then timed
            against it; G and H on the bf16 cache also timed as one
            torch scaled_dot_product_attention call on the same K/V
            gathered to contiguous rows (``library_ms``, a yardstick the
            port never calls), and so are A and B on bf16 latents at
            wave 1's decode and wave 3's prefill shapes (K the 640-wide
            latent row, V its first 512 columns);
5. check    logits of the first two layers at full width through the
            kernels against the CPU reference path with the same weights:
            deepseek-v3-bench on a 100-token and on a 1024-token prompt
            (kernels B, D / B, E, then A, C), llama3-1b on a bf16 cache
            (H, then G);
6. parity   the port's repairs against the reference: kernel A on bf16
            latents in 128-row pages and int8 ones in 256-row pages (key
            tiles of 64 and 128 rows) against its plain version, splices
            exact, then phase 5's deepseek-v3-bench check (a 1024-token
            prompt, then a decode step through A) on each; kernels G and
            H at 256-row pages and D = 128 on a bf16 cache and an int8
            one with a scale per KV head against their plain versions,
            then phase 5's check on a 2-layer llama3-8b (D = 128) in
            256-row pages (a 300-token prompt: two pages through H, then
            a decode step through G; both must launch); ``tiny`` (rows too
            narrow for any kernel) served on the card through the chunked
            attention path, a greedy wave twice (must repeat) with first
            tokens equal to the CPU engine's on attn_backend="chunked";
            a soft-capped decode batch through the chunked path against
            the full-softmax reference (atol = rtol = 2e-2); Gumbel noise
            of the threefry sampler drawn on the card for fixed seeds,
            gen_idx values and step keys, bit-equal to the same draw on
            the CPU;
7. server   (a) the port's OpenAI server (``ModelServer``) in this
            process over path (i)'s engine, on a local socket, with a
            tokenizer that writes each token id as decimal text: wave 1's
            prompts as token-id lists one at a time (streamed and not in
            turn), each reply the direct engine's tokens for that prompt
            alone; then all eight at once, each ending by length with 32
            tokens (the count equal to the direct wave's is reported).
            Kernels A-E must launch in this run.  (b) With this process's
            engines freed, ``python -m llm_d_tpu_torch.server.openai``
            with bench.py's flags as a subprocess: readiness on
            /v1/models, wave 3's shape as 64 concurrent requests (half
            streamed: client-side TTFT, TPOT, decode tokens/s) twice, a
            cold load (the process's first prefill and graph capture)
            and a warm one, /metrics against what was served,
            /admin/drain (readiness 503), then SIGTERM: exit code 0
            within the drain time.  (c) Observability and resume, on
            path (i)'s engine and flags: (a) the in-process server with
            tracing on serves wave 1's prompts one at a time, then with
            tracing off (LLMD_TRACE=0): the same tokens and graph
            replays, one request_phase_seconds sample a request and
            phase both ways, and with tracing on one connected trace a
            request in /debug/traces (server.request over engine.queue,
            engine.prefill and engine.decode, a 32-step decode block
            among the engine.step spans); then wave 1 at once in
            alternating rounds, decode tok/s on against off (reported);
            (d) with --latency-training-url pointed at a local /samples
            endpoint, 8 requests give 8 ttft and 8 tpot samples whose
            actual_ms are the replies' usage; (b) path (v)(b)'s engine
            (prefix cache, 448 blocks, 2048-block host tier) with a KV
            events sink: the stored hashes are the manager's cached
            blocks, and after wave-3-shaped waves evict them the sink's
            live set is still the cache, one removal an eviction; the
            same events through ZMQ where zmq and msgpack import, else
            --kv-events-endpoint refused naming them; (c) on that
            engine a stream dropped after 8 tokens, its blocks flushed to
            the host tier and dropped from the device cache, resumed at
            offset 8: src "restored", restored tokens > 0, restore ms;
            after (b), two server processes with bench.py's flags (the
            second from YAML --config / --config-overlay files where
            yaml imports, else --config refused naming it: (e)): a
            97-token stream from the first, cut after 8 tokens by a
            SIGKILL, resumed on the second (continuous, src marked),
            its tokens against an uninterrupted run on the second and
            the classic loop's with its top-2 margins (reported).
            Kernels A-E must launch in the in-process part;
8. path (vii) MoE with GQA attention, once phase 7 has freed the
            card: qwen3-30b-a3b at full width, its depth cut to 8 of
            48 layers for the time limit (128 experts, top-8; random
            weights from a
            seed, the int8 experts drawn and quantized plane by plane)
            through path (i)'s configuration (int8 experts, int8 cache
            with per-token scales, block size 64, 8192-token steps, 32-step
            decode blocks under async scheduling, 576 blocks): the build's
            peak device memory; waves 1-3 and wave 1 again (must repeat),
            every decode in 32-step blocks, kernels C, D, E, G and H
            launching (G, C and D inside graph replays); the in-process
            server (wave 1 one at a time, each reply the direct engine's
            tokens for that prompt alone); waves 1-3 in 1 alternating
            rounds a side against the classic loop (tokens identical);
            the f32 head's time (``compute_logits``) against one bf16
            matmul; the first two layers against the CPU reference (a
            100- and 37-token batch, a 1024-token prompt; relative max
            logit error <= 5e-2, the same argmax; the CPU takes the
            card's expert choice, the flips its own would make are
            reported); C, D, E, G and H
            against their plain versions at the path's recorded inputs
            (G and H also timed as one SDPA call on the K/V gathered and
            dequantized to bf16).  Then the mixtral-8x22b witness, its
            depth cut to 2 of 56 layers (one card cannot hold 135 GB of
            int8 experts): waves 1 and 3 and wave 1 again, the 2-layer
            reference check on the 100- and 37-token batch, C, E, G and
            H at its recorded inputs and D from a seed at T = 256.
9. path (viii) tensor and expert parallelism, once phase 8 has freed
            the card: deepseek-v3-bench at full width and depth, tp = ep
            = 4, as four rank processes of one mesh on the one card
            (``parallel/launch.RankPool``; NCCL refuses two ranks on one
            GPU, so the backend rule picks gloo, each collective staged
            through host memory; classic steps, since gloo collectives
            cannot be captured), each holding its shards of seed 0's
            draws (path (i)'s weights).  Wave 1 to ``MESH_W1_NEW`` (8)
            new tokens (A and B at 4 heads a rank, E on each rank's
            received rows; wave 3, its 8192-token prefill, cut for the
            time limit: phase 10 runs it), and wave
            1 to 2 new tokens on the
            bf16 wire and with the psum dispatch: every rank's tokens
            identical, A, B and E launching on every rank; the a2a int8
            and int8-dispatch wires and the psum dispatch against a2a on
            the bf16 wire on one MoE layer (<= 2% rel-RMS); each recorded
            kernel input against its plain version (phase 4's
            tolerances, timed, with bounds and SDPA times); each rank's
            peak memory; ``collective_bytes_total`` beside the bytes the
            collectives moved.  Then the first two layers on the mesh
            against the one-rank engine on the same weights (relative max
            logit error <= 5e-2, the same argmax, with and without the
            mesh's expert choice replayed); the qwen3-30b-a3b witness at
            tp = ep = 4 cut to 2 of 48 layers (wave 1 and one 8192-token
            prefill: G at one KV head, H, E); the tp server (``python -m
            llm_d_tpu_torch.server.openai --tensor-parallel-size 4`` with
            path (i)'s flags in classic steps): wave 1's first 2 prompts
            one at a time, each reply the direct tp engine's tokens for
            that prompt alone, then SIGTERM: exit 0 and no rank left;
            last, the one-rank classic loop's wave 1 at full depth
            against the mesh's, tokens counted with and without the
            mesh's expert choice replayed;
10. path (ix) data parallelism on one host, on phase 9's four ranks once
            its engine is torn down: deepseek-v3-bench at full width and
            depth on a ``MeshConfig(dp=2, tp=2)`` mesh (ep = 4), each dp
            shard serving its own requests' attention over its half of
            the KV pool (each rank's plane ``[16, 18432, 640]`` and its
            routed-expert bytes a quarter of the total, both checked).
            Wave 1 to ``MESH_W1_NEW`` new tokens (A at 8 heads a rank on
            its shard's rows, E on the received rows; each shard's expert
            choice taped) and wave 3 to 2 new tokens (its 8192-token
            prefill, 4096 tokens a shard: B at 8 heads, E on two
            1024-token chunks a rank): every rank's tokens identical, A,
            B and E launching on every rank; each recorded rank-local
            kernel input against its plain version; peaks and collective
            bytes; the first two layers on the dp mesh (a request a
            region) against the one-rank engine, within 5e-2 with the
            same argmax, with and without the dp mesh's routing replayed.
            Then the dp server (``--data-parallel-size 2
            --tensor-parallel-size 2``, path (i)'s flags in classic
            steps, log build/dp_server.log): wave 1's first 2 prompts one
            at a time, each reply the direct dp engine's, SIGTERM: exit 0
            and no rank left; the one-rank classic loop's wave 1 against the
            dp mesh's, with and without its routing replayed; last a
            ``DPEngineGroup`` of two engines sharing the card (ranks
            mode) on the one-rank engine's weights: dispatch splits wave
            1 4 / 4, tokens against the one engine serving the same
            requests, and where they differ again with its routing
            replayed.
11. path (x) the wide-EP recipe (``deploy/wide-ep-lws``) on phase 10's
            ranks and mesh, once its engine is torn down: (a) DBO at the
            recipe's threshold (32): deepseek-v3-bench in phase 10's
            configuration with ``enable_dbo``, wave 1 to ``MESH_W1_NEW``
            and wave 3 to 2 new tokens: the EP exchange's chunks a rank
            (2 where phase 10 ran 1), tokens against phase 10's (equal, or
            differing first where the run's top-2 margin is within 2 x
            5e-2 x max|logit|), one MoE layer within 1e-2 of DBO off, the
            step times both ways (gloo is no interconnect: no claim);
            (b) EPLB at ep = 4 (68 physical slots, 17 a rank) on
            bench_eplb_skew's first 8 prompts (12 new tokens) and its
            Zipf trace, with an interval of 4 steps: at least one flip
            that moves slots between ranks, identical tables on every
            rank, each moved slot's bytes its source's (checksums),
            moves, bytes across ranks, stage and flip ms, tokens against
            EPLB off (DBO off on (a)'s engine) judged as in (a); (c) a
            producer engine of prefill-lws.yaml's flags and a consumer of
            decode-lws.yaml's (dp = 2, tp = 2, deepseek-v3-bench, less the
            16-step async blocks: the judges read classic steps' margins)
            on the same four ranks: the consumer's own wave 1 (8 new
            tokens), then 2 prompts one at a time and wave 1 disaggregated over the
            native transport, and wave 1 again with the consumer's own
            routing replayed (the witness, as path (v)(a)'s): every
            region rank's scattered shard equal to the slab, the pins
            released on every rank, tokens against the consumer's own
            prefill reported, the witness's differing first only at near
            ties; (d) the two servers with those flags, the consumer's
            with decode-lws.yaml's whole set (its 16-step async blocks,
            run eagerly where the ranks share the card) (logs
            build/wide_producer.log, build/wide_consumer.log), this
            process playing the sidecar: 2 prompts one at a time, each
            reply the direct pair's; SIGTERM: exit 0, no rank left.
12. path (xi) spec decode, the fused rounds and the host tier on phase
            10's ranks and mesh (dp = 2, tp = 2, deepseek-v3-bench at full
            width and depth, int8 experts and latent, block 64), every
            decode block and fused round run eagerly (gloo collectives
            go through the host: no CUDA graph can hold them): (a) wave
            1 to 8 new tokens with spec K = 4 (one fused round a step),
            against the same engine with spec set aside (its classic
            steps, to 16 new tokens, rank 0 taking the margins, each
            shard's expert choice taped), the spec run with that routing
            replayed on every rank: acceptance, tokens a step, tokens
            equal or differing first at a near tie (as path (iii) judges
            its witness), every rank's tokens identical and its free
            blocks back; (b) everything-on: N = 4
            rounds a dispatch, async scheduling and EPLB at ep = 4
            (bench_eplb_skew's trace, 68 physical slots) to 16 new tokens:
            at least one flip, tables identical on every rank, moved
            slots' bytes their sources', tokens judged as in (a), free
            blocks back; rank 0's kernel inputs of (a) and (b) (B at the
            verify shape, E at 17 slots a rank) held to their plain
            versions before each teardown; (c) the host tier (16 blocks,
            64 host blocks, prefix caching): a 257-token prompt served
            and served again from the device cache, 4 fillers thrash both
            regions, the prompt once more: each restored block's bytes
            on every rank of its region equal rank 0's saved slab, the
            tokens the run's before the thrash.
13. path (xii) multi-host data parallelism in ranks mode, once phase
            12's ranks are gone: deepseek-v3-bench at full width and
            depth in path (i)'s configuration, classic steps, two hosts
            of one rank each (``--data-parallel-size 2
            --data-parallel-size-local 1``) sharing the card; five entry
            points start at once.  (a) The leader in this process, built
            by the entry point's ``server_from_args`` (a
            ``DPEngineGroup(dp_size=1, start_rank=0)`` and a
            ``DPWorkerPool`` on one worker entry point started with
            ``--data-parallel-start-rank 1``, log build/mh_worker.log;
            both from seed 0): a 128-token prompt served locally, then
            forced to the worker (its tokens equal the local ones); a
            whole reply forced remote after the worker's depth was set
            stale (the reply's depth header taken by the pool); a
            1024-token prompt locally (E); a second prompt locally (32
            new), then forced remote with the worker SIGKILLed after two
            token chunks: the stream ends with [DONE], continuous
            (``verify_continuity``), its tokens equal to the leader's
            uninterrupted classic run or first different at a near tie
            (``classic_margins``, ``divergence``), the leader's
            ``llmd_tpu:stream_resume_total`` and recovery counted; after
            each exchange the pool's ``inflight`` and ``dispatching`` at
            0 and ``depth`` at 0 or above; the leader's kernel inputs held
            to their plain versions.  (b) Both hosts as entry points
            (logs build/mh_leader.log, mh_b_worker.log): the first
            prompt to the leader, the second once it is busy (proxied),
            each reply's tokens equal (a)'s, each host's /metrics one
            request served; then a pair with --data-parallel-hybrid-lb
            (logs build/mh_hybrid_*.log): each host its own request, the
            leader with no pool; every entry point exits 0 on SIGTERM.
14. path (xiii) the port's mesh as far as JAX's, once phase 13's hosts
            are gone: (a) one spmd mesh across the hosts of an LWS group:
            two entry points with phase 10's dp server flags and
            LWS_LEADER_ADDRESS=127.0.0.1:<port>, LWS_GROUP_SIZE=2 and
            LWS_WORKER_INDEX 0 / 1, two ranks each (logs
            build/lws_leader.log, build/lws_worker.log; started first,
            they build while (b) and (c) run): wave 1's first 2
            prompts to the leader one at a time, each reply equal to
            phase 10's direct dp engine; the worker answers /health and
            /v1/models and a completion with 404; SIGTERM to the leader:
            both exit 0 with no rank left; the four ranks' logged kernel
            launches show A, B and E on each.  (b) A fresh pool of four
            ranks: deepseek-v3-bench at full width and depth on
            ``MeshConfig(sp=2, tp=2)`` (each rank the whole KV pool, a
            quarter of the experts), wave 1 to 2 new tokens (every rank's
            tokens identical, A, B and E on every rank, rank 0's inputs
            against their plain versions), the 2-layer check against the
            one-rank engine within 5e-2, same argmax, with and without
            the routing replayed.  (c) Ring attention on those ranks at
            sp = 4 and sp = 2 x tp = 2, causal and not, T = 8192, H = KVH
            = 16, D = 128, bf16: each rank's rows against the dense
            oracle at 3e-2, timed.  (d) The int8-latent absorption report
            on the rows a bf16-latent 2-layer engine wrote serving wave 1
            (8 new): the card's report equal to the CPU's at 1e-3,
            ``within_bounds`` reported.
15. path (xiv) the tiered-prefix-cache recipe
            (``deploy/tiered-prefix-cache``) on two port meshes, once
            phase 14 is done: two pods (``chip_smoke.py --tier-pod``, the
            entry point's ``main`` with the recipe's flags: qwen3-32b at
            its published widths cut to 8 of 64 layers, tp 8 cut to 4,
            ``--kv-offload-blocks`` 41000 cut to 256, each pod's
            ``--kv-shared-tier-peers dns:localhost:<the other's port>``,
            ``--kv-events-endpoint`` where zmq imports, both under
            ``LLMD_STEP_TIME_TARGET_MS``; logs build/tier_a.log and
            build/tier_b.log), started once 14(a)'s hosts have exited and
            built while 14(d) runs: eight ranks share the card over gloo.  (a) A 1040-token
            prompt (32 full blocks) to A, then to B: B's shared-tier hits
            count the 32 blocks, B's tokens equal A's (or differ first at
            a near tie, top-2 logprob gaps reported), both TTFTs; (b) A
            SIGKILLed, a 512-token prompt (16 new) to B: recomputed, A's
            address backed off after one failure; (c) a 4096-token prompt
            to B once its step-time model has trained; SIGTERM: B exits 0
            with no rank left, its four ranks' prefill chunk sequences
            equal; (d) B's rank 0 holds its recorded G and H inputs to
            their plain versions as it stops (build/tier_b.json).
16. path (xv) the inference-scheduling recipe
            (``deploy/inference-scheduling``) and the pd-disaggregation
            recipe (``deploy/pd-disaggregation/pd.yaml``) through the
            port's own EPP gateway and routing sidecar, once phase 15's
            pods have exited: every process starts at the phase's start,
            each given its container's args and environment from the
            recipe file (the EPP configs from the recipes' ConfigMaps),
            the model servers as ``chip_smoke.py --gw-pod`` (the entry
            point's ``main``); qwen3-0.6b at its published widths, one
            card (logs build/xv_*.log).  (a) Two model servers (64-token
            blocks, the EPP profiles' size; ``--num-blocks`` 2048 cut to
            256, ``--kv-offload-blocks`` 4096 to 512) behind the gateway
            (``--discover dns:localhost:<port>`` twice,
            ``--kv-events-bind``): 4 prefix groups of 4 prompts (1024
            shared tokens, 64 of their own, 16 new), each group's first
            alone, the other 12 at once: every later request on its
            group's pod by the destination header, the ``local_hit``
            placement and the precise scorer's 16/17 in the gateway's
            traces; each reply's tokens those of the prompt straight to
            its pod (or first different at a near tie, top-2 logprob gap
            reported); the gateway's request count; the 12-way burst's
            TTFT beside the same burst (fresh suffixes on the same
            prefixes) straight to the groups' pods (gateway, pod, pod,
            gateway); the gateway's added
            TTFT against the pod's (alternating rounds) and its
            scheduling time; then a 512-token stream (32 new) whose pod
            is SIGKILLed after 8 tokens with three requests of its
            prefix in flight there: the stream reaches [DONE] on the
            survivor, continuous, the breaker opens, the in-flight
            requests and the next ones are served by the survivor.  (b) Two producers and a consumer
            (``--num-blocks`` 2048 cut to 512; llama3-70b at tp 8 cut to
            qwen3-0.6b at tp 1), the sidecar in front of the consumer
            (``--prefiller`` the first producer), the gateway with
            ``pd-config.yaml`` and ``--endpoints``: first each prompt's
            reference, served plainly by a producer that never prefills
            it; then 8 prompts of 1024 tokens (16 new) through the
            gateway, alternating with a fresh prompt straight to the
            consumer (its cold prefill's TTFT), each prefilled on the
            sidecar's prefiller (the recipe's config names none: it has
            no prefill-header-handler), the consumer's pulled bytes
            equal to that producer's staged bytes (their traces), tokens
            those of the reference (or a near tie); the first producer
            SIGKILLed, two fresh prompts carrying the hint the EPP's
            prefill-header-handler would send (the dead producer first)
            fail over to the second; it SIGKILLed too, the next request
            is prefilled on the consumer and carries
            ``x-llmd-prefill-fallback``, then one more through the
            gateway, each with its reference's tokens (or a near tie).
            (c) (a)'s survivor and the consumer exit 0 on SIGTERM and
            hold their recorded G and H inputs to their plain versions
            (build/xv_*.json).

Launch counts: every count is set to 0 just before a path is driven and
read just after it; kernels A-F count path (i), G and H path (ii), and
each row adds path (iii)'s run (phases (a) and (c)-(e), also given as
``spec_launches``), path (iv)'s run (phases (a) and (b), also given as
``everything_on_launches``), path (v)'s run (phases (a) and (b),
also given as ``pd_launches``; (c) runs in its own processes), path
(vi)'s run (phase 2e(a), ``eplb_launches``), the attribution sweep
(phase 2e(c), ``attribution_launches``; the controller's launches in
2e(b) are comparisons and do not count), the in-process server's run
(phase 7(a), also given as ``server_launches``) and phase 7(c)'s
in-process run (``observe_launches``; its classic-loop yardstick does
not count), and C, D, E, G and H add path (vii)'s waves and in-process
server run (``moe_gqa_launches``; the direct engine's one-at-a-time
yardstick and the classic rounds do not count) and the witness's waves
(``witness_launches``); A, B, E, G and H add path (viii)'s waves on
every rank (``mesh_launches``; its one-at-a-time yardstick for the
server does not count), and each row lists its rank-local inputs'
checks as ``mesh_inputs``; A, B and E add path (ix)'s waves on every
rank (``dp_launches``; the one-at-a-time yardstick, the 2-layer check
and the DP group do not count), its checks as ``dp_inputs``; A, B and E
add path (x)'s waves and P/D runs on every rank (``wide_launches``; its
inputs' checks as ``wide_inputs``); A, B and E add path (xi)'s (a) and
(b) waves on every rank (``xi_launches``; the plain yardstick and the
tier's run do not count; its inputs' checks as ``xi_inputs``); A-E add
path (xii)'s leader (``multihost_launches``; the yardstick engine does
not count, the worker processes' launches are not seen; its inputs'
checks as ``multihost_inputs``); A, B and E add path (xiii)(b)'s wave on
every rank and (a)'s four ranks' counts, each rank's logged as it stops
(``xiii_launches``; the 2-layer check, ring attention and (d) do not
count; (b)'s checks as ``xiii_inputs``); G and H add path (xiv)'s pod B's
four ranks' counts, each rank's logged as it stops (``xiv_launches``; pod
A is killed in (b) and logs none; rank 0's checks as ``xiv_inputs``); G
and H add path (xv)'s counts of (a)'s survivor and (b)'s consumer, each
written as it stops (``gateway_launches``; the killed pods write none;
their checks as ``gateway_inputs``).  A
count is the wrapper's own (eager launches, graph warm-ups included)
plus the launches inside graph replays: a capture records each graph's
launches, and every replay adds them (``engine/cuda_graph.py``); the
``kernels`` line gives the latter as ``graph_launches``.

Output, in this order: a ``{"bounds": [...]}`` line (the bytes and flops
each kernel's bound is derived from), a ``{"variants": [...]}`` line (the
fields of the kernels line for the other inputs of phase 4), an
``{"engine": ...}`` line, a ``{"server": ...}`` line (phase 7, with the
card's name and power limit), a ``{"spec": ...}`` line (path (iii), with
the card's name and power limit), an ``{"everything_on": ...}`` line
(path (iv), likewise), a ``{"pd": ...}`` line (path (v), likewise), an
``{"eplb": ...}`` line (path (vi) and the controller, likewise), an
``{"attribution": ...}`` line, a ``{"sizing": [...]}`` line, an
``{"observe": ...}`` line (phase 7(c), with the card's name and power
limit), a ``{"moe_gqa": ...}`` line (path (vii) and the witness, with
the card's name and power limit), a ``{"mesh": ...}`` line (path (viii),
likewise), a ``{"dp": ...}`` line (path (ix), likewise), a
``{"wide_ep": ...}`` line (path (x), likewise), a ``{"spec_mesh": ...}``
line (path (xi), likewise), a ``{"multihost": ...}`` line (path (xii),
likewise), a ``{"lws_sp": ...}`` line (path (xiii), likewise), a
``{"tiered": ...}`` line (path (xiv), likewise), a ``{"gateway": ...}``
line (path (xv), likewise), a ``{"kernels": [...]}`` line (one row per
kernel at its first launch: measured launches, errors and times, with
``bound_ms``), the card's name and power limit, and last ``{"ok": true,
"device": ...}``.  The engine line
holds the classic-against-multistep rounds, the graph checks and the
graphs' shared pool (``pool_bytes``, device memory the captures
reserved).  A kernel's ``ms``
is the event-timed mean of 20 eager calls of its wrapper, so the
wrapper's host cost is in it where it exceeds the kernel's; ``device_ms``
is the same calls queued behind a device sleep, the kernels' device time
alone.

    python3 chip_smoke.py --profile

adds a ``{"profile": ...}`` line: four wave-1 and four wave-2 decode
steps of the classic loop, one multistep block (32 decode iterations,
one graph replay) of wave 1 and of wave 2, and the 8192-token wave-3
prefill step of deepseek-v3-bench, one bench_spec decode step (256
rows) and one mixed round of path (iii) (each one graph replay), one
steady step of path (iv) (one N = 4 dispatch queued, one retired), and
llama3-1b's 8192-token prefill step and four of its decode steps (bf16
cache), and path (vii)'s one 32-step block of wave 1 and of wave 2 and
its 8192-token prefill step (qwen3-30b-a3b), under ``torch.profiler``, with the device's busy time, kernel
launches and the largest kernels per step (a measurement, not part of
the smoke's pass/fail contract); then, after the server phase, four
fresh processes (``--cold-probe``) each serving path (i)'s wave 3 up
to its first 32-step decode block, with that block's capture timed
part by part: by default, with CUDA modules loaded eagerly, with
another Python thread busy half the time meanwhile, and the same with
a 0.5 ms switch interval.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak

WAVE1 = dict(n=8, prompt=128, new=32)
WAVE2 = dict(n=96, prompt=32, new=16)
WAVE3 = dict(n=64, prompt=128, new=16)       # bench.py's prefill shape
DENSE_WAVE = dict(n=64, prompt=128, new=32)
BENCH_T = WAVE3["n"] * WAVE3["prompt"]       # 8192-token prefill step
BENCH_K = 32                                 # bench.py's num_scheduler_steps
ROUNDS = 1                                   # classic vs multistep, a side
WAVE2_S = 128                                # wave 2's sequence bucket
DENSE_MODES = (("bf16", None), ("int8", "token"), ("int8", "head"))
# Phase 7(b): the server entry point with path (i)'s configuration
# (bench.py:156-173), and its drain bound.
SERVER_FLAGS = ["--model", "deepseek-v3-bench", "--quantization", "int8",
                "--kv-cache-dtype", "int8", "--block-size", "64",
                "--num-blocks", "576", "--max-num-seqs", "128",
                "--max-num-batched-tokens", str(BENCH_T),
                "--num-scheduler-steps", str(BENCH_K), "--async-scheduling"]
DRAIN_S = 30
# Path (iii): speculative decode as bench.py's bench_spec and bench_mixed
# configure it (bench.py:273-274, 275-437).
SPEC_K = 4                                   # SPEC_BENCH_K
SPEC_ACCEPT = 0.7                            # SPEC_BENCH_ACCEPT
SPEC_WAVE = dict(n=256, prompt=128, new=128)
MIXED_SHARE = 0.25                           # MIXED_BENCH_SHARE
MIXED_JOIN = dict(n=int(MIXED_SHARE * SPEC_WAVE["n"]), prompt=128, new=64)
SPEC_ROUNDS = 1                              # timed runs after a warm-up
EON_N = 4                                    # EVERYTHING_BENCH_ROUNDS


# The smoke's clock: each log line says when, in seconds of this process.
_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def clone(obj, keep=frozenset()):
    """Deep copy of the tensors in ``obj``, except those whose storage is
    in ``keep`` (the model's weights, which nothing mutates)."""
    import torch
    if isinstance(obj, torch.Tensor):
        if obj.data_ptr() in keep:
            return obj
        return obj.detach().clone()
    if isinstance(obj, dict):
        return {k: clone(v, keep) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(clone(v, keep) for v in obj)
    return obj


def tensor_ptrs(tree) -> frozenset:
    if isinstance(tree, dict):
        return frozenset().union(*(tensor_ptrs(v) for v in tree.values()))
    return frozenset([tree.data_ptr()])


def cache_mode(args, kw) -> str:
    """Cache mode of a dense attention launch: bf16, int8-token or
    int8-head (the scale planes' width)."""
    ks = kw.get("k_scale")
    if ks is None:
        return "bf16"
    return "int8-token" if ks.shape[-1] == 1 else "int8-head"


# The unpadded token count of the engine step being built, noted by
# ``note_live_tokens`` for the MoE kernels' bounds (None: not noted).
LIVE_TOKENS = [None]


def note_live_tokens(engine) -> None:
    """Notes in ``LIVE_TOKENS`` the live token count of each batch
    ``engine`` builds: a classic step's scheduled tokens, a fused round's
    tokens and drafts (each live row's stride, in every round of a
    dispatch), a multistep block's rows (one token each)."""
    build, fused, ms = (engine._build_batch, engine._fms_build,
                        engine._ms_dispatch)

    def build_batch(out, *a, **kw):
        LIVE_TOKENS[0] = out.total_tokens
        return build(out, *a, **kw)

    def fms_build(shards, *a, **kw):
        # This rank's shard (its forward's tokens).
        own = shards[engine.dp_index] if len(shards) > 1 else shards[0]
        LIVE_TOKENS[0] = sum(sp["stride"] for sp in own if sp["active"])
        return fused(shards, *a, **kw)

    def ms_dispatch(meta, scheduled, *a, **kw):
        LIVE_TOKENS[0] = len(scheduled)
        return ms(meta, scheduled, *a, **kw)

    engine._build_batch = build_batch
    engine._fms_build = fms_build
    engine._ms_dispatch = ms_dispatch


class Recorder:
    """Wraps a kernel wrapper (a module attribute the model calls through)
    and keeps a copy of the inputs of its first call of each label
    (``label(args, kw)``), taken before the call so in-place cache updates
    do not leak into the copy, with ``LIVE_TOKENS`` at that call in
    ``notes``.  A wrapper bumps the ``launches`` of whatever its module
    name is bound to, so the count lives on the recording wrapper while
    it is installed."""

    def __init__(self, module, name: str, keep: frozenset, label=None):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.keep = keep
        self.calls, self.notes = {}, {}

        def wrapped(*args, **kw):
            key = label(args, kw) if label else "first"
            if key not in self.calls:
                self.calls[key] = (clone(args, keep), clone(kw, keep))
                self.notes[key] = LIVE_TOKENS[0]
            return self.fn(*args, **kw)

        wrapped.launches = 0
        self.wrapped = wrapped
        setattr(module, name, wrapped)


@contextlib.contextmanager
def capture(module, name: str, key=None):
    """Records the arguments of the calls to ``module.name`` inside the
    block (the call itself goes through), or with ``key`` counts the
    calls by ``key(args, kw)`` and hands the launches made in the block
    back to what was installed before."""
    import collections
    seen = [] if key is None else collections.Counter()
    inner = getattr(module, name)

    def spy(*args, **kw):
        if key is None:
            seen.append((args, kw))
        else:
            seen[key(args, kw)] += 1
        return inner(*args, **kw)

    spy.launches = 0        # a wrapper bumps what its module name holds
    setattr(module, name, spy)
    try:
        yield seen
    finally:
        setattr(module, name, inner)
        if key is not None:
            inner.launches += spy.launches


def time_ms(fn, iters: int, warmup: int = 2) -> float:
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


def device_ms(fn, iters: int = 20, warmup: int = 2):
    """``(device ms, host ms)`` per call of ``fn``: the ``iters`` calls
    are enqueued behind a device sleep, so they run back to back and the
    host's cost of issuing them (Python, allocation, launch), timed on the
    host clock meanwhile, is not in the device time.  The sleep is
    lengthened until it outlasts the enqueueing."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    cycles = 20_000_000
    while True:
        ev[0].record()
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        ev[1].record()
        for _ in range(iters):
            fn()
        ev[2].record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if ev[0].elapsed_time(ev[1]) > 1.5 * host_ms:
            return ev[1].elapsed_time(ev[2]) / iters, host_ms / iters
        cycles *= 4


def run_wave(engine, prompts, max_new: int, tag: str):
    from llm_d_tpu_torch.engine.request import Request
    from llm_d_tpu_torch.ops.sampling import SamplingParams
    import torch
    reqs = [Request(f"{tag}-{i}", p, SamplingParams(
        temperature=0.0, max_tokens=max_new, ignore_eos=True))
        for i, p in enumerate(prompts)]
    for r in reqs:
        engine.add_request(r)
    prefill_s = decode_s = 0.0
    decode_tokens = decode_steps = steps = 0
    counts0 = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while engine.has_work():
        all_prefilled = all(r.output_token_ids for r in reqs)
        if all_prefilled and counts0 is None:
            counts0 = (engine._dispatch_count, engine._step_count)
        ts = time.perf_counter()
        outs = engine.step()
        dt = time.perf_counter() - ts
        steps += 1
        if all_prefilled:
            decode_s += dt
            decode_steps += 1
            decode_tokens += sum(len(o.new_token_ids) for o in outs)
        else:
            prefill_s += dt
    torch.cuda.synchronize()
    counts0 = counts0 or (engine._dispatch_count, engine._step_count)
    total_s = time.perf_counter() - t0
    tokens = [list(r.output_token_ids) for r in reqs]
    vocab = engine.model_config.vocab_size
    for r, toks in zip(reqs, tokens):
        if len(toks) != max_new or not all(0 <= t < vocab for t in toks):
            raise RuntimeError(f"{r.request_id}: got {len(toks)} tokens "
                               f"(want {max_new} in [0, {vocab}))")
    spec = {}
    if engine.spec_k:
        spec = dict(spec_drafted=sum(r.spec_drafted for r in reqs),
                    spec_accepted=sum(r.spec_accepted for r in reqs))
    return tokens, dict(spec,requests=len(prompts), steps=steps,
                        seconds=total_s, prefill_seconds=prefill_s,
                        decode_steps=decode_steps, decode_seconds=decode_s,
                        decode_tokens=decode_tokens,
                        decode_tok_s=(decode_tokens / decode_s
                                      if decode_s else None),
                        # Device dispatches and engine steps of the decode
                        # phase: K steps per dispatch under multistep.
                        decode_dispatches=engine._dispatch_count
                        - counts0[0],
                        decode_engine_steps=engine._step_count - counts0[1])


def prompts_for(rng, vocab: int, wave: dict):
    return [rng.integers(1, vocab, wave["prompt"]).tolist()
            for _ in range(wave["n"])]


def clone_to(tree, device):
    if isinstance(tree, dict):
        return {k: clone_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def reference_check(mc, params, engine_kw, prompt_lens, seed: int,
                    card_routing: bool = False) -> dict:
    """The first two layers at full width (``mc``, ``params`` on the card),
    through the kernels and through the CPU reference path with the same
    weights: one prefill step of ``prompt_lens`` and one decode step, in
    which both sides decode the tokens the CPU reference picked.
    Deeper random-weight stacks amplify the expected bf16 rounding
    differences chaotically, so depth is cut here, not width; the context
    is cut to what the prompts need, because the reference path gathers
    every key of a sequence's block table for every query row.

    With ``card_routing`` the CPU side takes the card's expert choice of
    each MoE layer and computes the gate weights from its own scores, as
    path (iii)'s verify check does: a top-8 choice over 128 near-equal
    softmax scores flips at a one-ulp difference in the router's input
    (ROADMAP §3), which no logit tolerance covers.  The flips the CPU's
    own choice would have made at the step's live tokens are counted (by
    MoE layer, prefill then decode), with the largest gap in selection
    score they cost."""
    import numpy as np
    import torch
    from llm_d_tpu_torch.engine import EngineConfig, EngineCore
    from llm_d_tpu_torch.engine.request import Request
    from llm_d_tpu_torch.ops import moe as moe_ops
    from llm_d_tpu_torch.ops.sampling import SamplingParams

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, mc.vocab_size, n).tolist()
               for n in prompt_lens]
    engines, reqs = {}, {}
    for dev in ("cpu", "cuda"):
        engines[dev] = EngineCore(
            EngineConfig(model_config=mc, device=dev, **engine_kw),
            params=params if dev == "cuda" else clone_to(params, "cpu"))
        reqs[dev] = [Request(f"ref{i}", p, SamplingParams(
            temperature=0.0, max_tokens=2, ignore_eos=True))
            for i, p in enumerate(prompts)]
        for r in reqs[dev]:
            engines[dev].add_request(r)
    real_route = moe_ops.route
    taped, flips, gaps, live = [], [], [], [0]

    def route(logits_r, c, e_bias=None):
        w, idx = real_route(logits_r, c, e_bias=e_bias)
        if logits_r.is_cuda:
            taped.append(idx)
            return w, idx
        cidx = taped.pop(0).cpu()
        # The step's live tokens (pad rows route too, but are dropped).
        own, card = idx[:live[0]], cidx[:live[0]]
        flips.append(sum(set(x) != set(y) for x, y in
                         zip(own.tolist(), card.tolist())))
        scores, choice = moe_ops.route_scores(logits_r, c, e_bias)
        gaps.append(float((choice[:live[0]].gather(1, own.long()).sum(-1)
                           - choice[:live[0]].gather(1, card.long()).sum(-1)
                           ).abs().max()))
        return moe_ops.gate_weights(scores, cidx, c), cidx

    logits = {"cpu": [], "cuda": []}
    if card_routing:
        moe_ops.route = route
    try:
        for step in range(2):
            # The card first: with card_routing the CPU takes its choice.
            for dev in ("cuda", "cpu"):
                eng = engines[dev]
                sched = eng.scheduler.schedule()
                batch, _ = eng._build_batch(sched)
                live[0] = sched.total_tokens
                hidden = eng.model.forward(eng.params, eng.kv_cache, batch,
                                           mc, engine_kw["block_size"])
                n = len(sched.scheduled)
                logits[dev].append(eng.model.compute_logits(
                    eng.params, hidden, mc)[:n].float().cpu())
                for sr in sched.scheduled:
                    sr.request.num_computed_tokens += sr.num_new_tokens
            # Both sides decode the tokens the CPU reference picked.
            for dev in ("cuda", "cpu"):
                for r, tok in zip(reqs[dev],
                                  logits["cpu"][-1].argmax(-1).tolist()):
                    r.output_token_ids.append(tok)
    finally:
        moe_ops.route = real_route
    del engines
    got, want = torch.stack(logits["cuda"]), torch.stack(logits["cpu"])
    if not torch.isfinite(got).all():
        raise RuntimeError("non-finite logits from the kernel path")
    rel = float((got - want).abs().max() / want.abs().max())
    top = bool((got.argmax(-1) == want.argmax(-1)).all())
    res = dict(model=mc.name, layers=mc.num_layers, prompts=prompt_lens,
               rel_max_err=rel, top1_agree=top, shape=list(got.shape))
    if card_routing:
        res.update(card_routing=True, routing_flips_of_cpu_routing=flips,
                   routing_flip_max_score_gap=gaps)
    return res


def _profile_steps(engine, steps: int, drain: bool = False) -> dict:
    """``steps`` engine steps under ``torch.profiler`` (with ``drain``,
    every step until the engine is idle, counted as ``steps``): wall and
    device time per step, launches and the largest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if drain:
            while engine.has_work():
                engine.step()
        else:
            for _ in range(steps):
                engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0 and str(ev.device_type).endswith("CUDA"):
            kernels.append((ev.key, dev_us / 1e3 / steps, ev.count / steps))
    device_ms = sum(k[1] for k in kernels)
    kernels.sort(key=lambda k: -k[1])
    return dict(
        steps=steps, wall_ms_per_step=wall_ms,
        device_ms_per_step=device_ms if kernels else None,
        device_busy_share=device_ms / wall_ms if kernels else None,
        kernel_launches_per_step=sum(k[2] for k in kernels),
        top=[dict(name=n[:80], ms_per_step=m, launches_per_step=c)
             for n, m, c in kernels[:12]])


def add_requests(engine, prompts, tag: str, n: int):
    """Greedy requests for ``prompts`` (``n`` new tokens each), added to
    ``engine``."""
    from llm_d_tpu_torch.engine.request import Request
    from llm_d_tpu_torch.ops.sampling import SamplingParams
    reqs = [Request(f"{tag}-{i}", p, SamplingParams(
        temperature=0.0, max_tokens=n, ignore_eos=True))
        for i, p in enumerate(prompts)]
    for r in reqs:
        engine.add_request(r)
    return reqs


def profile_dense(engine, prompts) -> dict:
    """Device busy time of the single prefill step of ``prompts`` (an
    8192-token step through kernel H) and of four decode steps (kernel G)
    after one untraced one."""
    add_requests(engine, prompts, "profd", 8)
    out = {"prefill": dict(_profile_steps(engine, 1),
                           tokens=sum(map(len, prompts)))}
    engine.step()                         # one decode step outside the trace
    out["decode"] = dict(_profile_steps(engine, 4), batch=len(prompts))
    while engine.has_work():
        engine.step()
    return out


def profile_waves(engine, decode_prompts, routed_prompts,
                  prefill_prompts) -> dict:
    """Device busy time of four decode steps of ``decode_prompts`` and of
    ``routed_prompts`` (wave 2: kernel D) after their prefill and one
    untraced decode step, and of the single prefill step of
    ``prefill_prompts``."""
    out = {}
    for key, prompts in (("decode", decode_prompts),
                         ("decode_routed", routed_prompts)):
        reqs = add_requests(engine, prompts, f"prof-{key}", 8)
        while not all(r.output_token_ids for r in reqs):
            engine.step()
        engine.step()                     # one decode step outside the trace
        out[key] = dict(_profile_steps(engine, 4), batch=len(prompts))
        while engine.has_work():
            engine.step()
    add_requests(engine, prefill_prompts, "profp", 2)
    out["prefill"] = dict(_profile_steps(engine, 1),
                          tokens=sum(map(len, prefill_prompts)))
    while engine.has_work():
        engine.step()
    return out


def profile_blocks(engine, waves) -> dict:
    """Device busy time of one multistep block (``BENCH_K`` decode
    iterations, one graph replay) of each of ``waves`` ({name: prompts})
    after its prefill step: the dispatching step and the retiring one,
    until the engine is idle (one block: each request asks for
    ``1 + BENCH_K`` tokens)."""
    out = {}
    for key, prompts in waves.items():
        reqs = add_requests(engine, prompts, f"profb-{key}", 1 + BENCH_K)
        while not all(r.output_token_ids for r in reqs):
            engine.step()
        d0 = engine._dispatch_count
        out[key] = dict(_profile_steps(engine, 1, drain=True),
                        batch=len(prompts), engine_steps=BENCH_K,
                        dispatches=engine._dispatch_count - d0)
    return out


def path_i_engine(steps: int = BENCH_K, params=None, **over):
    """deepseek-v3-bench as bench.py serves it, random weights from seed 0
    (or ``params``): int8 experts, int8 latent cache, block size 64, steps
    of up to ``BENCH_T`` tokens, ``steps`` scheduler steps per dispatch
    with async scheduling (the classic loop at ``steps`` = 1), and the
    block pool sized as bench.py:157-163 sizes it: room for every
    sequence's prompt, its new tokens and one more block of steps.
    ``over`` replaces EngineConfig fields (path (v))."""
    from llm_d_tpu_torch.engine import EngineConfig, EngineCore
    max_seqs, bs = 128, 64
    per_seq = -(-(WAVE1["prompt"] + WAVE1["new"] + BENCH_K + 1) // bs)
    kw = dict(
        model="deepseek-v3-bench", quantization="int8",
        kv_cache_dtype="int8", block_size=bs,
        num_blocks=max_seqs * per_seq + bs, max_num_seqs=max_seqs,
        max_num_batched_tokens=BENCH_T, num_scheduler_steps=steps,
        async_scheduling=steps > 1, enable_prefix_caching=False,
        device="cuda", seed=0)
    kw.update(over)
    return EngineCore(EngineConfig(**kw), params=params)


def path_ii_engine(kv: str, gran, steps: int = 1, params=None, **over):
    """llama3-1b at full width and depth, random weights from seed 1 (or
    ``params``), on a ``kv`` cache (bf16, or int8 with scales per
    ``gran``: token or head): block size 64, steps of up to ``BENCH_T``
    tokens, 64 sequences, ``steps`` scheduler steps per dispatch (async
    scheduling when more than one).  ``over`` replaces EngineConfig
    fields (the pool-sizing check)."""
    from llm_d_tpu_torch.engine import EngineConfig, EngineCore
    kw = dict(
        model="llama3-1b", kv_cache_dtype=kv, kv_scale_granularity=gran,
        block_size=64, num_blocks=256, max_num_seqs=64,
        max_num_batched_tokens=BENCH_T, num_scheduler_steps=steps,
        async_scheduling=steps > 1, enable_prefix_caching=False,
        device="cuda", seed=1)
    kw.update(over)
    return EngineCore(EngineConfig(**kw), params=params)


def check_multistep(stats: dict, tag: str) -> None:
    """Every decode dispatch of a wave served by a multistep engine was a
    block of ``BENCH_K`` engine steps."""
    d, n = stats["decode_dispatches"], stats["decode_engine_steps"]
    if d == 0 or n != BENCH_K * d:
        raise RuntimeError(f"{tag}: decode ran {n} engine steps in {d} "
                           f"dispatches, not blocks of {BENCH_K}")


def spread(values) -> dict:
    """Median, quartiles and range of ``values``."""
    import numpy as np
    v = np.asarray(values, dtype=float)
    return dict(median=float(np.median(v)), q1=float(np.percentile(v, 25)),
                q3=float(np.percentile(v, 75)), min=float(v.min()),
                max=float(v.max()), n=len(v))


def classic_rounds(classic, bench, waves: dict, rounds: int) -> dict:
    """Each of ``waves`` ({name: (wave, prompts)}) served by the classic
    engine and by the bench-configured one in alternating rounds (the
    side that goes first alternates too).  Greedy tokens must be identical
    between the two sides in every round.  Per wave and side: the spread
    of decode tok/s and prefill seconds, and whether the multistep side's
    decode tok/s is resolved above the classic side's (every multistep
    round above every classic round)."""
    runs = {w: {"classic": [], "multistep": []} for w in waves}
    for r in range(rounds):
        sides = [("classic", classic), ("multistep", bench)]
        if r % 2:
            sides.reverse()
        for w, (wave, prompts) in waves.items():
            tokens = {}
            for side, eng in sides:
                tokens[side], st = run_wave(eng, prompts, wave["new"],
                                            f"{side[0]}{r}{w}")
                if side == "multistep":
                    check_multistep(st, f"round {r} {w}")
                runs[w][side].append(st)
            if tokens["classic"] != tokens["multistep"]:
                diff = sum(a != b for x, y in zip(tokens["classic"],
                                                  tokens["multistep"])
                           for a, b in zip(x, y))
                raise RuntimeError(f"round {r} {w}: multistep tokens differ "
                                   f"from the classic loop's in {diff}")
    out = {}
    for w, sides in runs.items():
        out[w] = {side: dict(
            decode_tok_s=spread([st["decode_tok_s"] for st in sts]),
            prefill_s=spread([st["prefill_seconds"] for st in sts]))
            for side, sts in sides.items()}
        out[w]["same_tokens"] = True
        out[w]["decode_resolved"] = (
            out[w]["multistep"]["decode_tok_s"]["min"]
            > out[w]["classic"]["decode_tok_s"]["max"])
    return out


def graph_equals_eager(engine, key) -> dict:
    """The decode-block graph of ``key`` ((S, random rows)) replayed on its
    static inputs against the block's eager body
    (``EngineCore._ms_body``) on the same inputs from the same cache:
    ids and cache planes bit-equal."""
    from llm_d_tpu_torch.engine.cuda_graph import replay_equals_eager
    g = engine._graphs.graphs[key]
    res = replay_equals_eager(g, engine.kv_cache, lambda out: engine._ms_body(
        g.inputs, g.inputs["keys"], out["ids"], key[1]))
    res = dict(S=key[0], random_rows=key[1], K=g.outputs["ids"].shape[0],
               live_rows=int(g.inputs["active"].sum()),
               ids_equal=res["outputs_equal"], cache_equal=res["cache_equal"])
    if not (res["ids_equal"] and res["cache_equal"]):
        raise RuntimeError(f"graph replay differs from the eager body: {res}")
    return res


def sampled_block(engine, vocab: int) -> list:
    """Eight requests at temperature 0.7 (top-p 0.9; every other one
    seeded) served by the multistep engine: a prefill step and one block
    with random rows."""
    import numpy as np
    from llm_d_tpu_torch.engine.request import Request
    from llm_d_tpu_torch.ops.sampling import SamplingParams
    rng = np.random.default_rng(4)
    reqs = [Request(f"smp-{i}", rng.integers(1, vocab, 64).tolist(),
                    SamplingParams(temperature=0.7, top_p=0.9,
                                   seed=1234 + i if i % 2 else None,
                                   max_tokens=1 + BENCH_K, ignore_eos=True))
            for i in range(8)]
    out = engine.generate(reqs)
    toks = [out[r.request_id] for r in reqs]
    if any(len(t) != 1 + BENCH_K for t in toks) or \
            len({t for row in toks for t in row}) < 2:
        raise RuntimeError(f"sampled block: {toks}")
    return toks


def path_iii_engine(params):
    """deepseek-v3-bench as bench.py's bench_mixed configures its spec
    engine (bench.py:366-377), on ``params``: int8 experts and latent,
    block size 64, steps of up to ``BENCH_T`` tokens, one scheduler step
    (spec decode owns the multi-token step), ``SPEC_K`` drafts, prefix
    caching off, and room for 1.5 x 256 sequences of prompt, new tokens
    and drafts, plus 64 blocks.  The drafter is random from seed 1."""
    from llm_d_tpu_torch.engine import EngineConfig, EngineCore
    bs = 64
    n_seqs = SPEC_WAVE["n"] + SPEC_WAVE["n"] // 2
    per_seq = -(-(SPEC_WAVE["prompt"] + SPEC_WAVE["new"] + SPEC_K + 2) // bs)
    return EngineCore(EngineConfig(
        model="deepseek-v3-bench", quantization="int8",
        kv_cache_dtype="int8", block_size=bs,
        num_blocks=n_seqs * per_seq + bs, max_num_seqs=n_seqs,
        max_num_batched_tokens=BENCH_T, num_scheduler_steps=1,
        enable_prefix_caching=False, spec_k=SPEC_K, device="cuda", seed=0),
        params=params)


@contextlib.contextmanager
def routing_tape(engine, tape: dict, replay: bool):
    """Inside the block, tapes the MoE expert choice of every live token
    of ``engine``'s forwards by (MoE layer, prompt index, position) (the
    request ids are ``tag-i``), or with ``replay`` gives each live token
    found on ``tape`` the taped choice, with gate weights from its own
    scores; yields a one-item list counting the token-layers replayed.
    ``engine`` may be a DP group (each rank's forwards read its own
    schedule, told apart by their cache) or a rank of a dp mesh (its
    shard's requests: ranks of other dp shards tape theirs)."""
    import torch
    from llm_d_tpu_torch.ops import moe as moe_ops
    engines = getattr(engine, "engines", [engine])
    model = engines[0].model
    real_scheds = [e.scheduler.schedule for e in engines]
    real_fwd, real_route = model.forward, moe_ops.route
    # Each engine's scheduled prompt indices in its batch's row order,
    # by the identity of its cache.
    rows_of = {}
    state = dict(keys=[], layer=0)
    replayed = [0]

    def tapped(e, real):
        def schedule(*a, **kw):
            out = real(*a, **kw)
            mine = e._split_by_shard(out.scheduled)[e.dp_index]
            rows_of[id(e.kv_cache)] = [
                int(sr.request.request_id.rsplit("-", 1)[1]) for sr in mine]
            return out
        return schedule

    def forward(params, kv_cache, batch, *a, **kw):
        T = batch["positions"].shape[0]
        qtok = batch["qtok_idx"].reshape(-1).cpu()
        pos, seq = batch["positions"].cpu(), batch["token_seq_ids"].cpu()
        rows = rows_of.get(id(kv_cache), [])
        # Pad rows of a multistep block (past the scheduled ones) have
        # no request.
        state["keys"] = [(t, rows[int(seq[t])], int(pos[t]))
                         for t in torch.unique(qtok[qtok < T]).tolist()
                         if int(seq[t]) < len(rows)]
        state["layer"] = 0
        return real_fwd(params, kv_cache, batch, *a, **kw)

    def route(logits, c, e_bias=None):
        w, idx = real_route(logits, c, e_bias=e_bias)
        layer = state["layer"]
        state["layer"] += 1
        if not replay:
            chosen = idx.cpu().tolist()
            for t, r, p in state["keys"]:
                tape[(layer, r, p)] = chosen[t]
            return w, idx
        hits = [(t, tape[(layer, r, p)]) for t, r, p in state["keys"]
                if (layer, r, p) in tape]
        if not hits:
            return w, idx
        idx = idx.clone()
        idx[torch.tensor([t for t, _ in hits], device=idx.device)] = \
            torch.tensor([e for _, e in hits], dtype=idx.dtype,
                         device=idx.device)
        replayed[0] += len(hits)
        scores, _ = moe_ops.route_scores(logits, c, e_bias)
        return moe_ops.gate_weights(scores, idx, c), idx

    for e, real in zip(engines, real_scheds):
        e.scheduler.schedule = tapped(e, real)
    model.forward, moe_ops.route = forward, route
    try:
        yield replayed
    finally:
        for e, real in zip(engines, real_scheds):
            e.scheduler.schedule = real
        model.forward, moe_ops.route = real_fwd, real_route


def classic_margins(classic, prompts, max_new: int):
    """The classic loop's wave on ``prompts`` with its routing taped
    (``routing_tape``): its tokens, the tape, and for each prompt's token
    at each step the top-2 logit margin and the decision bar ``2 * 5e-2 *
    max|logit|`` (``[step][row]``, one token a row a step)."""
    import torch
    from llm_d_tpu_torch.models import moe
    real, margins, bars, tape = moe.compute_logits, [], [], {}

    def spy(*a):
        out = real(*a)
        rows = out[:len(prompts)].float()
        top2 = torch.topk(rows, 2, dim=-1).values
        margins.append((top2[:, 0] - top2[:, 1]).tolist())
        bars.append((2 * 5e-2 * rows.abs().amax(-1)).tolist())
        return out

    moe.compute_logits = spy
    try:
        with routing_tape(classic, tape, replay=False):
            tokens, _ = run_wave(classic, prompts, max_new, "margin")
    finally:
        moe.compute_logits = real
    return tokens, tape, margins, bars


def divergence(tokens, ref, margins, bars) -> dict:
    """Where each row of ``tokens`` first differs from ``ref``, with the
    reference step's top-2 margin and decision bar there."""
    at = [next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), len(a))
          for a, b in zip(tokens, ref)]
    return dict(
        first_divergence_per_row=at,
        classic_top2_margin_there=[margins[j][i] if j < len(margins)
                                   else None for i, j in enumerate(at)],
        classic_bar_there=[bars[j][i] if j < len(bars) else None
                           for i, j in enumerate(at)],
        tokens_equal_to_classic=sum(a == b for x, y in zip(tokens, ref)
                                    for a, b in zip(x, y)))


def spec_greedy(engine, prompts, classic_tokens, yardstick) -> dict:
    """Phase (a): wave 1 through the spec engine with real verification,
    twice (must repeat); against the classic loop's tokens, each first
    token (a differing one reported with the classic step's top-2
    margin), the count of equal tokens, and where each row first differs
    with the classic step's top-2 margin there.  Then the witness: the
    classic loop again with its routing taped (``yardstick``, from
    ``classic_margins``), and the spec engine with that routing replayed (``routing_tape``), which takes out the MoE's
    top-8 flips; each row must then equal the classic run's tokens up to
    a near tie, a first difference where the classic top-2 margin is
    within the decision bar ``2 * 5e-2 * max|logit|``."""
    tok, st = run_wave(engine, prompts, WAVE1["new"], "sa")
    tok2, st2 = run_wave(engine, prompts, WAVE1["new"], "sa2")
    if tok2 != tok:
        raise RuntimeError("spec wave 1 did not repeat token for token")
    ref, tape, margins, bars = yardstick
    if ref != classic_tokens:
        raise RuntimeError("the classic loop did not repeat under the tape")
    differ = [dict(row=i, spec=a[0], classic=b[0],
                   classic_top2_margin=margins[0][i])
              for i, (a, b) in enumerate(zip(tok, classic_tokens))
              if a[0] != b[0]]
    # The tape reads the batch on the host and swaps expert choices at
    # every forward: this run's rounds go eagerly (graphs step aside).
    graphs, engine._graphs = engine._graphs, None
    try:
        with routing_tape(engine, tape, replay=True) as replayed:
            tok3, st3 = run_wave(engine, prompts, WAVE1["new"], "sr")
    finally:
        engine._graphs = graphs
    witness = dict(divergence(tok3, ref, margins, bars), wave=st3,
                   token_layers_replayed=replayed[0])
    witness["near_ties_only"] = all(
        m is None or m <= b for m, b in zip(
            witness["classic_top2_margin_there"],
            witness["classic_bar_there"]))
    res = dict(divergence(tok, classic_tokens, margins, bars), wave=st,
               repeat=st2, repeats=True,
               first_tokens_equal=len(prompts) - len(differ),
               first_tokens_differ=differ,
               tokens=WAVE1["new"] * len(prompts),
               classic_routing_replayed=witness)
    if not witness["near_ties_only"]:
        raise RuntimeError(f"with the classic routing replayed, the spec "
                           f"engine left the classic tokens at a decided "
                           f"position: {witness}")
    return res


def spec_reference_check(mc, params, draft_params, engine_kw, seed: int
                         ) -> dict:
    """Phase (b): a verify step of the first two layers at full width,
    through the kernels on the card and through the CPU reference path
    with the same weights: 8 prompts of 100 tokens prefilled, then each
    row verifies ``SPEC_K`` live drafts (from a seed) after the card's
    first token.  Logits of every live position are compared: relative
    max error <= 5e-2, and the same argmax wherever the reference's top-2
    margin exceeds twice that bar (``2 * 5e-2 * max|logit|``: random
    weights put near ties within the kernel path's rounding, which the
    other positions report).  The MoE routing is a top-8 choice over
    near-equal scores, which a one-ulp difference in the router's input
    flips between the card and the CPU (ROADMAP §3), so the CPU side
    takes the card's expert choice (the flips its own choice would have
    made are counted, with the gap in selection score they cost) and
    computes the gate weights from its own scores, which must match the
    card's within the phase's bar, 5e-2 of their largest."""
    import numpy as np
    import torch
    from llm_d_tpu_torch.engine import EngineConfig, EngineCore
    from llm_d_tpu_torch.engine.request import Request
    from llm_d_tpu_torch.ops import moe as moe_ops
    from llm_d_tpu_torch.ops.sampling import SamplingParams

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, mc.vocab_size, 100).tolist()
               for _ in range(8)]
    drafts = rng.integers(1, mc.vocab_size, (8, SPEC_K)).tolist()
    card = str(params["embed"].device)
    real_route = moe_ops.route
    routes, flips, gaps, w_err, first, logits = [], [], [], [], None, {}
    on_card = [True]

    def route(logits_r, c, e_bias=None):
        w, idx = real_route(logits_r, c, e_bias=e_bias)
        if on_card[0]:
            routes.append((w, idx))
            return w, idx
        cw, cidx = (t.cpu() for t in routes[len(flips)])
        flips.append(sum(set(x) != set(y) for x, y in
                         zip(idx.tolist(), cidx.tolist())))
        scores, choice = moe_ops.route_scores(logits_r, c, e_bias)
        gaps.append(float((choice.gather(1, idx.long()).sum(-1)
                           - choice.gather(1, cidx.long()).sum(-1)
                           ).abs().max()))
        w = moe_ops.gate_weights(scores, cidx, c)
        w_err.append(float((w - cw).abs().max() / cw.abs().max()))
        return w, cidx

    moe_ops.route = route
    try:
        for dev in (card, "cpu"):
            on_card[0] = dev == card
            eng = EngineCore(
                EngineConfig(model_config=mc, device=dev, spec_k=SPEC_K,
                             **engine_kw),
                params=params if dev == card else clone_to(params, "cpu"),
                draft_params=(draft_params if dev == card
                              else clone_to(draft_params, "cpu")))
            reqs = [Request(f"sref{i}", p, SamplingParams(
                temperature=0.0, max_tokens=8, ignore_eos=True))
                for i, p in enumerate(prompts)]
            for r in reqs:
                eng.add_request(r)
            for step in range(2):
                sched = eng.scheduler.schedule()
                if step == 1 and any(sr.num_draft_tokens != SPEC_K
                                     for sr in sched.scheduled):
                    raise RuntimeError("verify step without K live drafts")
                plan = eng._fms_plan(sched, 1)
                inp = {k: torch.as_tensor(v, device=eng.device) for k, v in
                       dict(plan["sbatch"], **plan["xs"],
                            **plan["carry"]).items()}
                batch = eng._fms_round_batch(inp, 0, inp["pos"], inp["last"],
                                             inp["drafts"])
                hidden = eng.model.forward(eng.params, eng.kv_cache, batch,
                                           mc, engine_kw["block_size"])
                n = len(sched.scheduled) * (SPEC_K + 1)
                out = eng.model.compute_logits(
                    eng.params, hidden, mc)[:n].float().cpu()
                if step == 1:
                    logits[dev] = out
                    continue
                if first is None:          # the card's first tokens
                    first = out[::SPEC_K + 1].argmax(-1).tolist()
                for sr, tok, d in zip(sched.scheduled, first, drafts):
                    req = sr.request
                    req.num_computed_tokens += sr.num_new_tokens
                    req.output_token_ids.append(tok)
                    req.spec_drafts, req.spec_drafts_at = d, req.num_tokens
            del eng
    finally:
        moe_ops.route = real_route
    got, want = logits[card], logits["cpu"]
    if not torch.isfinite(got).all():
        raise RuntimeError("non-finite logits from the kernel path")
    rel = float((got - want).abs().max() / want.abs().max())
    # A position's argmax is decided when the reference's top-2 margin
    # exceeds twice the error bar (both logits may move by it); a closer
    # pair is a near tie the check reports.
    top2 = torch.topk(want, 2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    err = (got - want).abs().amax(-1)
    agree = got.argmax(-1) == want.argmax(-1)
    decided = margin > 2 * 5e-2 * want.abs().max()
    differ = [dict(position=i, card=int(got[i].argmax()),
                   cpu=int(want[i].argmax()), cpu_top2_margin=float(margin[i]),
                   max_abs_err=float(err[i]))
              for i in range(got.shape[0]) if not agree[i]]
    top = bool(agree[decided].all())
    res = dict(model=mc.name, layers=mc.num_layers, rows=8,
               live_positions=int(got.shape[0]), rel_max_err=rel,
               top1_agree_where_decided=top,
               decided_positions=int(decided.sum()),
               top1_agree_all=bool(agree.all()), argmax_differ=differ,
               shape=list(got.shape), routing_flips_of_cpu_routing=flips,
               routing_flip_max_score_gap=gaps, gate_weight_rel_err=w_err,
               routed_tokens=[int(idx.shape[0]) for _, idx in routes])
    if not top or rel > 5e-2 or max(w_err) > 5e-2:
        raise RuntimeError(f"verify logits disagree with the CPU "
                           f"reference: {res}")
    return res


def spec_prompts(seed: int, n: int, prompt: int, vocab: int):
    import numpy as np
    return np.random.default_rng(seed).integers(1, vocab, (n, prompt)
                                                 ).tolist()


def spec_bench(engine, prompts) -> dict:
    """Phase (c): bench_spec's shape (``SPEC_WAVE``) at the fixed
    acceptance ``SPEC_ACCEPT``: a warm-up and ``SPEC_ROUNDS`` timed runs.
    Every request must end by length with its tokens and the pool must
    be back at its free count after each run.  Per run: accepted decode
    tok/s (tokens emitted after every prompt was prefilled, over that
    wall time, as bench.py's ``_run_workload`` counts), acceptance and
    tokens per step; then the coin of the first timed run's steps drawn
    on the card against the CPU, bit for bit."""
    import torch
    from llm_d_tpu_torch.ops.sampling import accept_coin
    engine.set_spec_fixed_accept(SPEC_ACCEPT)
    free0 = engine.kv_manager.num_free_blocks
    new = SPEC_WAVE["new"]
    runs, coin_steps = [], None
    for rep in range(1 + SPEC_ROUNDS):
        reqs = add_requests(engine, prompts, f"spec{rep}", new)
        step0 = engine._step_count
        t0 = time.perf_counter()
        while any(r.num_computed_tokens < r.num_prompt_tokens for r in reqs):
            engine.step()
        t1 = time.perf_counter()
        before, steps = sum(len(r.output_token_ids) for r in reqs), 0
        while engine.has_work():
            engine.step()
            steps += 1
        t2 = time.perf_counter()
        bad = [r.request_id for r in reqs if len(r.output_token_ids) != new
               or r.state.value != "length"]
        if bad:
            raise RuntimeError(f"spec bench: {bad[:4]} did not end by "
                               f"length with {new} tokens")
        if engine.kv_manager.num_free_blocks != free0:
            raise RuntimeError("spec bench: blocks leaked")
        drafted = sum(r.spec_drafted for r in reqs)
        accepted = sum(r.spec_accepted for r in reqs)
        tokens = sum(len(r.output_token_ids) for r in reqs) - before
        run = dict(prefill_s=t1 - t0, decode_s=t2 - t1, decode_steps=steps,
                   decode_tokens=tokens, decode_tok_s=tokens / (t2 - t1),
                   drafted=drafted, accepted=accepted,
                   acceptance=accepted / drafted,
                   tokens_per_step=tokens / steps,
                   tokens_per_row_step=1 + SPEC_K * accepted / drafted)
        if rep:
            runs.append(run)
            if coin_steps is None:
                coin_steps = (step0, engine._step_count)
        log(f"spec bench run {rep}: {json.dumps(run)}")
    S = SPEC_WAVE["n"]
    for step in range(*coin_steps):
        card = accept_coin(step, S, SPEC_K, engine.device).cpu()
        cpu = accept_coin(step, S, SPEC_K, "cpu")
        if not torch.equal(card.view(torch.int32), cpu.view(torch.int32)):
            raise RuntimeError(f"acceptance coin of step {step} differs on "
                               f"the card")
    return dict(requests=S, prompt=SPEC_WAVE["prompt"], new=new,
                spec_k=SPEC_K, fixed_accept=SPEC_ACCEPT, runs=runs,
                decode_tok_s=spread([r["decode_tok_s"] for r in runs]),
                acceptance=spread([r["acceptance"] for r in runs]),
                tokens_per_step=spread([r["tokens_per_step"] for r in runs]),
                coin_steps_bit_equal=coin_steps[1] - coin_steps[0],
                leak_free=True)


def mixed_bench(engine, base, joiners, runs: int = 2) -> list:
    """Phase (d): bench_mixed's shape at ``MIXED_SHARE`` (bench.py:380-
    406): ``base`` prefilled and decoding at the fixed acceptance, then
    ``joiners`` added one per step; the window's emitted tok/s and p99
    step ms.  Every request must end by length and the pool must come
    back whole; kernel B must run at Q = 128 for more than 256 rows."""
    from llm_d_tpu_torch.engine.request import Request
    from llm_d_tpu_torch.ops import mla_prefill
    from llm_d_tpu_torch.ops.sampling import SamplingParams
    engine.set_spec_fixed_accept(SPEC_ACCEPT)
    free0 = engine.kv_manager.num_free_blocks
    out = []
    for rep in range(runs):
        reqs = add_requests(engine, base, f"mixb{rep}", SPEC_WAVE["new"])
        while any(r.num_computed_tokens < r.num_prompt_tokens for r in reqs):
            engine.step()
        join = [Request(f"mixj{rep}-{i}", p, SamplingParams(
            temperature=0.0, max_tokens=MIXED_JOIN["new"], ignore_eos=True))
            for i, p in enumerate(joiners)]
        before = sum(len(r.output_token_ids) for r in reqs)
        step_ms, j = [], 0
        replays0 = {k: g.replays for k, g in engine._graphs.graphs.items()}
        with capture(mla_prefill, "mla_flash_prefill",
                     lambda a, kw: tuple(a[0].shape[:2])) as shapes:
            t0 = time.perf_counter()
            while engine.has_work() or j < len(join):
                if j < len(join):
                    engine.add_request(join[j])
                    j += 1
                s0 = time.perf_counter()
                engine.step()
                step_ms.append(1e3 * (time.perf_counter() - s0))
            dt = time.perf_counter() - t0
        # B inside graph replays: a fused key's (S, Q) is its launch's.
        for k, g in engine._graphs.graphs.items():
            n = (g.replays - replays0.get(k, 0)) \
                * g.launches.get("mla_flash_prefill", 0)
            if n:
                shapes[(k[1], k[3])] += n
        tokens = sum(len(r.output_token_ids) for r in reqs + join) - before
        bad = [r.request_id for r in reqs + join
               if r.state.value != "length" or len(r.output_token_ids)
               != r.sampling.max_tokens]
        if bad:
            raise RuntimeError(f"mixed bench: {bad[:4]} did not end by "
                               f"length")
        if engine.kv_manager.num_free_blocks != free0:
            raise RuntimeError("mixed bench: blocks leaked")
        wide = sum(n for (S, Q), n in shapes.items()
                   if Q == 128 and S > SPEC_WAVE["n"])
        if not wide:
            raise RuntimeError(f"mixed bench: kernel B never ran at Q = 128 "
                               f"over the decode rows: {dict(shapes)}")
        ordered = sorted(step_ms)
        out.append(dict(
            base=len(reqs), joiners=len(join), steps=len(step_ms),
            seconds=dt, tokens=tokens, tok_s=tokens / dt,
            p99_step_ms=ordered[min(len(ordered) - 1,
                                    int(0.99 * len(ordered)))],
            median_step_ms=ordered[len(ordered) // 2],
            b_launches_q128=wide,
            b_shapes={f"S={S} Q={Q}": n for (S, Q), n in shapes.items()}))
        log(f"mixed bench run {rep}: {json.dumps(out[-1])}")
    return out


def mixed_bodies(prompts, max_new: int) -> list:
    """Three requests a prompt, in turn greedy, greedy with ``logprobs``
    0 and 5, seeded and unseeded sampling at temperature 0.8, streamed
    and not: the flags that split the fused graph keys."""
    kinds = [dict(), dict(logprobs=0), dict(logprobs=5),
             dict(temperature=0.8, seed=7), dict(temperature=0.8)]
    return [dict(greedy_body(p, max_new, bool(i % 2)), **kinds[i % 5])
            for i, p in enumerate(prompts * 3)]


def spec_server(engine, prompts, alone) -> dict:
    """Phase (e): ``ModelServer`` in process over the spec engine (real
    verification), ``prompts`` one at a time with ``logprobs`` = 5: each
    reply's tokens are the direct engine's for that prompt alone, every
    logprob finite and <= 0, every top-5 list sorted and headed by the
    greedy token.  Then mixed traffic (``mixed_bodies``) all at once:
    each request must end by length; the graph layer's keys, pool bytes
    and drops are reported before and after it."""
    import math
    from llm_d_tpu_torch.server.openai import ModelServer
    server = ModelServer(engine, DecimalTokenizer(),
                         engine.model_config.name)
    url, close = serve_in_thread(server)
    checked = 0
    before = graph_bounds(engine)
    try:
        for i, (p, want) in enumerate(zip(prompts, alone)):
            status, _, reply = http_call(url, "/v1/completions", dict(
                greedy_body(p, len(want), False), logprobs=5))
            if status != 200:
                raise RuntimeError(f"logprobs request {i}: HTTP {status}")
            lp = reply["choices"][0]["logprobs"]
            toks = [int(t) for t in lp["tokens"]]
            if toks != want:
                raise RuntimeError(f"logprobs request {i}: tokens differ "
                                   f"from the direct spec engine's")
            for tok, v, top in zip(lp["tokens"], lp["token_logprobs"],
                                   lp["top_logprobs"]):
                vals = list(top.values())
                if not (math.isfinite(v) and v <= 0) or len(top) != 5 \
                        or vals != sorted(vals, reverse=True) \
                        or next(iter(top)) != tok \
                        or abs(vals[0] - v) > 1e-6:
                    raise RuntimeError(f"logprobs request {i}: token {tok} "
                                       f"logprob {v}, top {top}")
                checked += 1
        bodies = mixed_bodies(prompts, len(alone[0]))
        mixed = concurrently(url, bodies)
        for i, (b, r) in enumerate(zip(bodies, mixed)):
            if r["finish"] != "length" or r["n"] != b["max_tokens"]:
                raise RuntimeError(f"mixed request {i}: {r['n']} tokens, "
                                   f"finish {r['finish']}")
        if server.async_engine.dead is not None:
            raise RuntimeError("the engine thread died") \
                from server.async_engine.dead
    finally:
        close()
    return dict(requests=len(prompts), tokens_checked=checked,
                identical=True, mixed_requests=len(mixed),
                graphs_before=before, graphs_after=graph_bounds(engine))


def graph_bounds(engine) -> dict:
    """The graph layer's size against its caps: graphs held, their
    shared pool's bytes, graphs dropped and pool resets."""
    g = engine._graphs
    return dict(graphs=len(g.graphs), max_graphs=g.max_graphs,
                pool_bytes=g.pool_bytes, max_pool_bytes=g.max_pool_bytes,
                evictions=g.evictions, pool_resets=g.pool_resets)


def profile_spec(engine, prompts, joiner) -> dict:
    """Device busy time of one bench_spec decode step (256 rows at the
    fixed acceptance, after the prefill and one untraced step) and of
    one mixed round (a 128-token joiner's prefill beside them)."""
    from llm_d_tpu_torch.engine.request import Request
    from llm_d_tpu_torch.ops.sampling import SamplingParams
    engine.set_spec_fixed_accept(SPEC_ACCEPT)
    reqs = add_requests(engine, prompts, "profs", SPEC_WAVE["new"])
    while any(r.num_computed_tokens < r.num_prompt_tokens for r in reqs):
        engine.step()
    engine.step()
    out = {"spec_step": dict(_profile_steps(engine, 1), batch=len(prompts))}
    engine.add_request(Request("profj", joiner, SamplingParams(
        temperature=0.0, max_tokens=2, ignore_eos=True)))
    out["mixed_round"] = _profile_steps(engine, 1)
    while engine.has_work():
        engine.step()
    return out


def path_iv_engine(params, N: int, draft_params=None, eplb: bool = True):
    """deepseek-v3-bench as bench.py's bench_everything_on configures it
    (bench.py:466-489), on ``params``: int8 experts and latent, block
    size 64, steps of up to ``BENCH_T`` tokens, ``SPEC_WAVE["n"]``
    sequences, ``SPEC_K`` drafts at the fixed acceptance ``SPEC_ACCEPT``,
    ``N`` fused rounds per dispatch with async scheduling (N = 1: the
    single fused round), EPLB on (``eplb``; with one card its placement
    is the identity, and its controller copies the expert weights into
    its own physical table), prefix caching off, and room for every
    sequence's prompt, new tokens and two dispatches of drafts at
    ``EON_N`` (1344 blocks).  The drafter is random from seed 1 (or
    ``draft_params``)."""
    from llm_d_tpu_torch.engine import EngineConfig, EngineCore
    bs = 64
    cover = (SPEC_WAVE["prompt"] + SPEC_WAVE["new"]
             + 2 * EON_N * (SPEC_K + 1) + 2)
    return EngineCore(EngineConfig(
        model="deepseek-v3-bench", quantization="int8",
        kv_cache_dtype="int8", block_size=bs,
        num_blocks=SPEC_WAVE["n"] * -(-cover // bs) + bs,
        max_num_seqs=SPEC_WAVE["n"], max_num_batched_tokens=BENCH_T,
        num_scheduler_steps=N, async_scheduling=N > 1, enable_eplb=eplb,
        enable_prefix_caching=False, spec_k=SPEC_K,
        spec_fixed_accept=SPEC_ACCEPT, device="cuda", seed=0),
        params=params, draft_params=draft_params)


def side_label(N) -> str:
    """A path (iv) engine's label: its rounds per dispatch, or the N-round
    engine with EPLB off ("off")."""
    return f"N={EON_N} eplb off" if N == "off" else f"N={N}"


def count_routed(engine) -> list:
    """A running count of the routed ids ``engine``'s EPLB tracker is
    handed (its window keeps only the last ``window_size`` steps)."""
    import numpy as np
    counted = [0]
    tracker = engine.eplb.tracker
    real = tracker.record

    def record(ids, steps=1):
        counted[0] += int(np.asarray(ids).size)
        return real(ids, steps)

    tracker.record = record
    return counted


def eon_greedy(engines, prompts, classic_tokens, yardstick) -> dict:
    """Phase (iv)(a): wave 1 with real verification through the N-round
    engine, the single-round one and the N-round one with EPLB off
    (``engines``: {N or "off": engine}), each against the classic loop's
    tokens (``yardstick``: its margins and bars, ``classic_margins``) and
    against each other: equal tokens, and where each row first differs
    with the classic step's top-2 margin and decision bar there (a
    difference within the bar is a near tie).  EPLB on and off must give
    the same tokens: the identity table feeds C-E the same inputs."""
    _, _, margins, bars = yardstick
    toks, out = {}, {}
    for N, eng in engines.items():
        eng.set_spec_fixed_accept(None)
        toks[N], st = run_wave(eng, prompts, WAVE1["new"], f"eg{N}")
        d = divergence(toks[N], classic_tokens, margins, bars)
        d["near_ties_only"] = all(
            m is None or m <= b for m, b in zip(
                d["classic_top2_margin_there"], d["classic_bar_there"]))
        out[side_label(N)] = dict(d, wave=st)
        eng.set_spec_fixed_accept(SPEC_ACCEPT)
    a, b = toks[EON_N], toks[1]
    out["tokens"] = WAVE1["new"] * len(prompts)
    out["equal_tokens_between_n"] = sum(x == y for r, q in zip(a, b)
                                        for x, y in zip(r, q))
    if toks["off"] != toks[EON_N]:
        raise RuntimeError("path (iv): greedy tokens with EPLB on differ "
                           "from EPLB off")
    out["equal_tokens_eplb_on_off"] = True
    return out


def eon_run(engine, prompts, tag: str) -> dict:
    """One bench_everything_on run (``SPEC_WAVE`` at ``SPEC_ACCEPT``):
    accepted decode tok/s as bench.py's ``_run_workload`` counts it
    (tokens after every prompt was prefilled, over that wall time),
    acceptance, and engine steps per dispatch over the whole run, as
    bench.py quotes them.  Every request must end by length with its
    tokens and the pool must be whole after the run."""
    free0 = engine.kv_manager.num_free_blocks
    new = SPEC_WAVE["new"]
    reqs = add_requests(engine, prompts, tag, new)
    s0, d0 = engine._step_count, engine._dispatch_count
    g0 = len(engine._graphs.graphs)
    t0 = time.perf_counter()
    while any(r.num_computed_tokens < r.num_prompt_tokens for r in reqs):
        engine.step()
    t1 = time.perf_counter()
    before, steps = sum(len(r.output_token_ids) for r in reqs), 0
    while engine.has_work():
        engine.step()
        steps += 1
    t2 = time.perf_counter()
    bad = [r.request_id for r in reqs if len(r.output_token_ids) != new
           or r.state.value != "length"]
    if bad:
        raise RuntimeError(f"everything-on run: {bad[:4]} did not end by "
                           f"length with {new} tokens")
    if engine.kv_manager.num_free_blocks != free0:
        raise RuntimeError("everything-on run: blocks leaked")
    drafted = sum(r.spec_drafted for r in reqs)
    accepted = sum(r.spec_accepted for r in reqs)
    tokens = sum(len(r.output_token_ids) for r in reqs) - before
    return dict(prefill_s=t1 - t0, decode_s=t2 - t1, decode_host_steps=steps,
                decode_tokens=tokens, decode_tok_s=tokens / (t2 - t1),
                drafted=drafted, accepted=accepted,
                acceptance=accepted / drafted,
                engine_steps=engine._step_count - s0,
                dispatches=engine._dispatch_count - d0,
                steps_per_dispatch=(engine._step_count - s0)
                / max(1, engine._dispatch_count - d0),
                step_range=(s0, engine._step_count),
                graphs_captured=len(engine._graphs.graphs) - g0)


def eon_bench(engines, prompts) -> dict:
    """Phase (iv)(b): bench_everything_on's shape through the N-round
    engine and its yardsticks, the single-round one and the N-round one
    with EPLB off, in alternating rounds (the order of the sides
    reverses every round): a warm-up run each, then ``SPEC_ROUNDS``
    timed runs each.  Per side: the spread of
    accepted decode tok/s, acceptance and steps per dispatch, and
    whether the N-round side is resolved above the other (every run
    above every run).  Then the coins of the first timed run's steps
    drawn on the card against the CPU, bit for bit, and the coins the
    N-round engine's last dispatch fed its graph against the CPU's."""
    import torch
    from llm_d_tpu_torch.ops.sampling import accept_coin
    runs = {N: [] for N in engines}
    order = list(engines)
    for rep in range(1 + SPEC_ROUNDS):
        for N in (order if rep % 2 == 0 else order[::-1]):
            run = eon_run(engines[N], prompts, f"eon{N}r{rep}")
            log(f"everything-on {side_label(N)} run {rep}: "
                f"{json.dumps(run)}")
            if rep:
                runs[N].append(run)
    S = SPEC_WAVE["n"]
    coin_steps = 0
    for N, rs in runs.items():
        for step in range(*rs[0]["step_range"]):
            card = accept_coin(step, S, SPEC_K, "cuda").cpu()
            cpu = accept_coin(step, S, SPEC_K, "cpu")
            if not torch.equal(card.view(torch.int32), cpu.view(torch.int32)):
                raise RuntimeError(f"acceptance coin of step {step} "
                                   f"differs on the card")
            coin_steps += 1
    eng = engines[order[0]]
    fed = 0
    for key, g in eng._graphs.graphs.items():
        if key[0] != "fms" or g.graph is None \
                or float(g.inputs["rate"][0]) < 0:
            continue

        def bits(t):
            return t.contiguous().view(torch.int32)

        coin = g.inputs["coin"].cpu()
        N, Sg = coin.shape[:2]
        base = next((st for st in range(eng._step_count) if torch.equal(
            bits(coin[0]), bits(accept_coin(st, Sg, SPEC_K, "cpu")))), None)
        if base is None or not all(torch.equal(bits(coin[r]), bits(
                accept_coin(base + r, Sg, SPEC_K, "cpu"))) for r in range(N)):
            raise RuntimeError(f"graph {key}: its coin input is not the "
                               f"CPU's coin of its rounds' steps")
        fed += 1
    out = {}
    for N, rs in runs.items():
        out[side_label(N)] = dict(
            runs=rs, decode_tok_s=spread([r["decode_tok_s"] for r in rs]),
            acceptance=spread([r["acceptance"] for r in rs]),
            steps_per_dispatch=spread([r["steps_per_dispatch"] for r in rs]))
    a, b, off = (out[side_label(N)]["decode_tok_s"]
                 for N in (EON_N, 1, "off"))
    return dict(out, requests=S, prompt=SPEC_WAVE["prompt"],
                new=SPEC_WAVE["new"], spec_k=SPEC_K,
                fixed_accept=SPEC_ACCEPT, rounds_per_dispatch=order[0],
                resolved_above_single_round=a["min"] > b["max"],
                # EPLB's collection cost at N = EON_N, written down (the
                # on side below every off run, or above every one).
                eplb_on_resolved_below_off=a["max"] < off["min"],
                eplb_on_resolved_above_off=a["min"] > off["max"],
                coin_steps_bit_equal=coin_steps,
                graph_coin_inputs_checked=fed, leak_free=True)


def fused_graph_checks(engine) -> list:
    """Each captured fused key of ``engine`` replayed on its static inputs
    against its eager body (``EngineCore._fms_body``) from the same
    cache: every output and the cache outside block 0 bit-equal (block 0
    is the trash block dead slots write, in any order)."""
    from llm_d_tpu_torch.engine.cuda_graph import replay_equals_eager
    out = []
    for key, g in engine._graphs.graphs.items():
        if key[0] != "fms" or g.graph is None:
            continue
        _, S, T, Q, _, _, N, lp, top, rnd = key
        res = replay_equals_eager(
            g, engine.kv_cache,
            lambda o: engine._fms_body(g.inputs, o, N, lp, top, rnd),
            trash_rows=engine.config.block_size)
        out.append(dict(S=S, T=T, Q=Q, N=N, want_lp=lp, want_top=top,
                        random_rows=rnd, **res))
        if not all(res.values()):
            raise RuntimeError(f"fused graph {key} differs from its eager "
                               f"body: {res}")
    if not out:
        raise RuntimeError("no fused graph was captured")
    return out


def graph_costs(engine) -> dict:
    """The graph layer of ``engine``: its shared pool's bytes, and each
    captured key with its launches and cold cost (``BlockGraph.cold``)."""
    return dict(graph_bounds(engine), replays=engine._graphs.replays,
                graphs=[dict(key=[str(x) for x in key],
                             launches=sum(g.launches.values()), cold=g.cold)
                        for key, g in engine._graphs.graphs.items()
                        if g.graph is not None])


def profile_eon(engine, prompts) -> dict:
    """Device busy time of one step of the N-round engine in its steady
    state (after the prefill and two pipelined steps): the step queues
    one N-round dispatch (one graph replay) and retires the one before
    it."""
    reqs = add_requests(engine, prompts, "profe", SPEC_WAVE["new"])
    while any(r.num_computed_tokens < r.num_prompt_tokens for r in reqs):
        engine.step()
    for _ in range(2):
        engine.step()
    d0, s0 = engine._dispatch_count, engine._step_count
    out = dict(_profile_steps(engine, 1), batch=len(prompts),
               dispatches=engine._dispatch_count - d0,
               engine_steps=engine._step_count - s0)
    while engine.has_work():
        engine.step()
    return out


# Path (vi): bench_eplb_skew (bench.py:542-600) on path (i)'s weights,
# the EPLB controller at ep = 4 on the same weights, the attribution sweep
# (bench.py --stub, :1096-1110) and the pool-sizing check.
EPLB_SKEW_CONFIG = {"window_size": 512, "step_interval": 32}
EPLB_ZIPF = 1.2                              # EPLB_BENCH_ZIPF
EPLB_RUNS = 1                                # timed runs after a warm-up
CTRL_EP = 4
CTRL_TS = (16, 256, 2048)                    # kernels C, D, E
STUB_COMPONENTS = ("attn", "moe_ffn", "shared_expert")
ATTR_SIZES = (64, 256)
ATTR_PROMPT = 128
ATTR_DECODE = 64                             # cut from 128: the time limit
SIZING_BUDGET = 4 << 30


def path_vi_engine(params, draft_params):
    """deepseek-v3-bench as bench.py's bench_eplb_skew configures it
    (bench.py:568-585), on ``params`` and ``draft_params``: int8 experts
    and latent, block size 64, 8192-token steps, ``SPEC_WAVE["n"]``
    sequences, one scheduler step (every step one fused round, one graph
    replay), ``SPEC_K`` drafts at ``SPEC_ACCEPT``, EPLB with a 512-step
    window and a 32-step interval, prefix caching off, and
    ``n x ceil((128 + 128 + K + 2) / 64) + 64`` = 1344 blocks."""
    from llm_d_tpu_torch.engine import EngineConfig, EngineCore
    bs = 64
    per_seq = -(-(SPEC_WAVE["prompt"] + SPEC_WAVE["new"] + SPEC_K + 2) // bs)
    return EngineCore(EngineConfig(
        model="deepseek-v3-bench", quantization="int8",
        kv_cache_dtype="int8", block_size=bs,
        num_blocks=SPEC_WAVE["n"] * per_seq + bs,
        max_num_seqs=SPEC_WAVE["n"], max_num_batched_tokens=BENCH_T,
        num_scheduler_steps=1, enable_eplb=True,
        eplb_config=dict(EPLB_SKEW_CONFIG), enable_prefix_caching=False,
        spec_k=SPEC_K, spec_fixed_accept=SPEC_ACCEPT, device="cuda", seed=0),
        params=params, draft_params=draft_params)


def zipf_probs(E: int):
    import numpy as np
    p = np.arange(1, E + 1, dtype=np.float64) ** -EPLB_ZIPF
    return p / p.sum()


def eplb_skew(engine, prompts) -> dict:
    """Path (vi): bench_eplb_skew's runs.  Before each run a Zipf(1.2)
    trace (``RandomState(1234)``, ``[n_layers, 4096, 2]``) is recorded into
    the tracker, dominating its window; then ``SPEC_WAVE`` at
    ``SPEC_ACCEPT`` (``eon_run``: accepted decode tok/s, every request
    ending by length, the pool whole).  A warm-up and ``EPLB_RUNS`` timed
    runs.  With one card every plan aligns to the identity: migrations
    must be 0."""
    import numpy as np
    eplb = engine.eplb
    routed = count_routed(engine)
    p = zipf_probs(eplb.E)
    rng = np.random.RandomState(1234)
    runs, migrations = [], 0
    for rep in range(EPLB_RUNS + 1):
        eplb.tracker.record(rng.choice(eplb.E, size=(eplb.n_layers, 4096, 2),
                                       p=p))
        before = eplb.num_rebalances
        run = eon_run(engine, prompts, f"skew{rep}")
        run["imbalance"] = eplb.tracker.imbalance()
        log(f"eplb skew run {rep}: {json.dumps(run)}")
        if rep:
            runs.append(run)
            migrations += eplb.num_rebalances - before
    if migrations or eplb.num_rebalances:
        raise RuntimeError(f"path (vi): {eplb.num_rebalances} migrations "
                           f"at ep = {eplb.ep}")
    return dict(runs=runs,
                decode_tok_s=spread([r["decode_tok_s"] for r in runs]),
                zipf_skew=EPLB_ZIPF, spec_k=SPEC_K, fixed_accept=SPEC_ACCEPT,
                eplb_config=EPLB_SKEW_CONFIG, ep=eplb.ep,
                migrations=migrations,
                migrated_mb=eplb.migrated_bytes / 1e6,
                flip_stall_ms=eplb.last_flip_stall_s * 1e3,
                num_suppressed=eplb.num_suppressed,
                imbalance=eplb.tracker.imbalance(),
                routed_ids_recorded=routed[0])


def controller_phase(params, mc) -> dict:
    """The EPLB controller at ep = ``CTRL_EP`` on path (i)'s int8 expert
    weights (all MoE layers), on this one card: ``install`` gathers the
    physical table (P = E + r slots); a per-layer Zipf trace plans a
    migration; ``on_step`` ticks stage it on the controller's side stream
    (device time by events on that stream, host time per tick) until the
    flip.  Then the serving tensors kept their ``data_ptr()``, each
    physical ``_q``/``_s`` plane equals the logical one gathered by its
    layer's final plan bit for bit, the tables are the plans', and kernels
    C, D and E through ``to_physical_experts`` with the new tables give
    the logical-id launch's output on the same inputs (max error / max
    |output| <= 1e-2; whether bit-equal is reported)."""
    import numpy as np
    import torch
    from llm_d_tpu_torch.ops import moe as moe_ops
    from llm_d_tpu_torch.parallel.eplb import (EplbConfig, EplbController,
                                               _expert_major_keys)
    dev = torch.device("cuda")
    E, k = mc.num_experts, mc.num_experts_per_tok
    ctrl = EplbController(E, CTRL_EP, EplbConfig.from_dict(
        dict(EPLB_SKEW_CONFIG, imbalance_threshold=1.0)))
    logical = params["moe_layers"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    phys = ctrl.install(params)
    torch.cuda.synchronize()
    install_s = time.perf_counter() - t0
    ml = phys["moe_layers"]
    names = _expert_major_keys(ml)
    ptrs = {n: t.data_ptr() for n, t in ml.items()}
    Lm = ctrl.n_layers
    rng = np.random.RandomState(1234)
    p = zipf_probs(E)
    trace = np.stack([rng.choice(E, size=(4096, k), p=rng.permutation(p))
                      for _ in range(Lm)])
    ctrl._side = torch.cuda.Stream(dev)
    events, host_ms = [], []
    real_stage = ctrl._stage

    def stage(batch, params_):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(ctrl._side)
        t = time.perf_counter()
        n = real_stage(batch, params_)
        host_ms.append((time.perf_counter() - t) * 1e3)
        b.record(ctrl._side)
        events.append((a, b))
        return n

    ctrl._stage = stage
    step = EPLB_SKEW_CONFIG["step_interval"]
    ctrl.on_step(trace, step, phys)
    if not ctrl.migrating:
        raise RuntimeError("controller phase: the skewed trace planned no "
                           "migration")
    total = ctrl._migration.total_moves
    ticks, deferred = 1, 0
    t0 = time.perf_counter()
    while ctrl.migrating and time.perf_counter() - t0 < 60:
        step += 1
        if not ctrl._migration.moves:
            deferred += 1
        ctrl.on_step(None, step, phys)
        ticks += 1
    if ctrl.migrating:
        raise RuntimeError("controller phase: the migration never flipped")
    torch.cuda.synchronize()
    out = dict(ep=CTRL_EP, experts=E, physical=ml["w_gate_q"].shape[1],
               layers=Lm, moves=total, ticks=ticks, deferred_ticks=deferred,
               move_budget=ctrl.move_budget, install_s=install_s,
               stage_device_ms=sum(a.elapsed_time(b) for a, b in events),
               stage_host_ms=sum(host_ms),
               flip_host_ms=ctrl.last_flip_stall_s * 1e3,
               migrated_bytes=ctrl.migrated_bytes,
               replicas_max=int(max(pl.num_replicas.max()
                                    for pl in ctrl.plans)))
    if {n: t.data_ptr() for n, t in ml.items()} != ptrs:
        raise RuntimeError("controller phase: a serving tensor moved")
    for li, plan in enumerate(ctrl.plans):
        p2l = torch.as_tensor(plan.phys_to_logical, device=dev).long()
        for n in names:
            if not torch.equal(ml[n][li], logical[n][li].index_select(0, p2l)):
                raise RuntimeError(f"controller phase: {n} layer {li} is "
                                   f"not the logical weights by its plan")
    rt, nr = ctrl._stacked_tables(Lm)
    if not (torch.equal(ml["replica_table"].cpu(), torch.from_numpy(rt))
            and torch.equal(ml["num_replicas"].cpu(), torch.from_numpy(nr))):
        raise RuntimeError("controller phase: tables differ from the plans")
    out.update(weights_bit_equal=True, data_ptr_stable=True)
    li = int(np.argmax([pl.num_replicas.max() for pl in ctrl.plans]))
    qk = ("w_gate_q", "w_gate_s", "w_up_q", "w_up_s", "w_down_q", "w_down_s")
    kernels = []
    for T, glue in zip(CTRL_TS, (moe_ops._dense_int8_kernel_path,
                                 moe_ops._routed_int8_kernel_path,
                                 moe_ops._streamed_int8_kernel_path)):
        x, w, idx = moe_inputs(mc, T, seed=100 + T)
        want = glue(x, w, idx, dict({n: logical[n] for n in qk}, layer=li))
        idx_p = moe_ops.to_physical_experts(
            idx, ml["replica_table"][li], ml["num_replicas"][li], phase=li)
        got = glue(x, w, idx_p, dict({n: ml[n] for n in qk}, layer=li))
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.abs().max()) + 1e-9
        kernels.append(dict(T=T, glue=glue.__name__, max_abs_err=err,
                            scale=scale, bit_equal=torch.equal(got, want),
                            replicated_ids=int((idx_p != idx).sum())))
        if err / scale > 1e-2:
            raise RuntimeError(f"controller phase: T={T} through the "
                               f"physical table: error {err} / {scale}")
    out.update(layer=li, kernels=kernels)
    return out


def attribution_table(baseline: dict, stubbed: dict) -> dict:
    """Per-component decode / prefill ms per step by difference, as
    bench.py's ``_attribution_table`` computes it: baseline minus
    stubbed, per phase and batch size, and the residual no stub
    accounts for."""
    metrics = (("decode_ms_per_step", "decode"),
               ("prefill_ms_per_step", "prefill"))
    components = {}
    for stub, sweep in stubbed.items():
        row = {}
        for bs, base in baseline.items():
            for key, phase in metrics:
                row[f"{phase}_bs{bs}_ms"] = round(base[key] - sweep[bs][key], 2)
        components[stub] = row
    residual = {}
    for bs, base in baseline.items():
        for key, phase in metrics:
            cell = f"{phase}_bs{bs}_ms"
            residual[cell] = round(base[key] - sum(
                c[cell] for c in components.values()), 2)
    return {"components": components, "residual_ms": residual}


def bench_reqs(tag: str, n: int, decode_steps: int, offset: int):
    """bench.py's ``_make_reqs``: ``n`` greedy ``ATTR_PROMPT``-token
    prompts, ``decode_steps + 1`` new tokens each."""
    from llm_d_tpu_torch.engine.request import Request
    from llm_d_tpu_torch.ops.sampling import SamplingParams
    return [Request(f"{tag}-{i}", [(7 * i + 13 * j + offset) % 32000 + 1
                                   for j in range(ATTR_PROMPT)],
                    SamplingParams(temperature=0.0,
                                   max_tokens=decode_steps + 1,
                                   ignore_eos=True)) for i in range(n)]


def bench_workload(engine, reqs):
    """bench.py's ``_run_workload``: (prefill s, prefill steps, decode s,
    decode tokens)."""
    import torch
    for r in reqs:
        engine.add_request(r)
    steps = 0
    t0 = time.perf_counter()
    while any(r.num_computed_tokens < r.num_prompt_tokens for r in reqs):
        engine.step()
        steps += 1
    t_prefill = time.perf_counter() - t0
    before = sum(len(r.output_token_ids) for r in reqs)
    t1 = time.perf_counter()
    while engine.has_work():
        engine.step()
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t1
    return (t_prefill, steps, t_decode,
            sum(len(r.output_token_ids) for r in reqs) - before)


def attribution(params) -> tuple:
    """The attribution sweep as ``bench.py --stub`` runs it, on path (i)'s
    weights: deepseek-v3-bench at bench_model's configuration for the
    batch sizes ``ATTR_SIZES`` (block 64, 32-step decode blocks, async
    scheduling, 8192-token steps, the largest size's sequences and
    blocks for them), once unstubbed and
    once with each of ``attn``, ``moe_ffn`` and ``shared_expert`` (each an
    engine of its own, capturing its own stubbed blocks).  Per batch
    size a warm-up (the prefill and one decode block: the keys' captures)
    and one timed run (128-token prompts, ``ATTR_DECODE`` decode steps):
    decode and prefill ms per step, and the components' cost by
    difference.
    Returns (the sweep, the kernels' launches, inside graph replays)."""
    import gc
    import torch
    sweeps, replayed = {}, []
    for stub in ("none",) + STUB_COMPONENTS:
        eng = path_i_engine(params=params, max_num_seqs=max(ATTR_SIZES),
                            num_blocks=max(ATTR_SIZES) * -(-(
                                ATTR_PROMPT + ATTR_DECODE + BENCH_K + 1)
                                // 64) + 64,
                            stub_components=() if stub == "none"
                            else (stub,))
        sweep = {}
        for bs in ATTR_SIZES:
            bench_workload(eng, bench_reqs(f"aw{stub}{bs}", bs, BENCH_K,
                                           50000 + 1000 * bs))
            t_pre, n_pre, t_dec, toks = bench_workload(
                eng, bench_reqs(f"ab{stub}{bs}", bs, ATTR_DECODE, 1000 * bs))
            sweep[str(bs)] = dict(
                decode_ms_per_step=1000 * t_dec / ATTR_DECODE,
                prefill_ms_per_step=1000 * t_pre / max(n_pre, 1),
                prefill_steps=n_pre, decode_tok_s=toks / t_dec,
                prefill_tok_s=bs * ATTR_PROMPT / t_pre)
        log(f"attribution {stub}: {json.dumps(sweep)}")
        sweeps[stub] = sweep
        replayed.append(dict(eng._graphs.launches))
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return dict(sweeps=sweeps, sizes=list(ATTR_SIZES), prompt=ATTR_PROMPT,
                decode_steps=ATTR_DECODE, table=attribution_table(
                    sweeps["none"], {s: sweeps[s] for s in STUB_COMPONENTS})
                ), replayed


def sizing_check(engine, label: str) -> dict:
    """An engine built with ``kv_cache_hbm_bytes`` = 4 GiB: its derived
    ``num_blocks`` equals the arithmetic (budget // (layers x block x
    (payload bytes + scale bytes) per row)), and the cache it allocated
    equals ``num_blocks x kv_block_bytes``."""
    from llm_d_tpu_torch.engine.engine import kv_block_bytes
    c, cfg = engine.model_config, engine.config
    layout = engine.model.kv_cache_layout(c)
    row = sum(layout.values()) * (1 if engine.kv_quantized else 2) \
        + (len(layout) * engine.kv_scale_width * 4
           if engine.kv_quantized else 0)
    want = max(SIZING_BUDGET // (c.num_layers * cfg.block_size * row), 2)
    per_block = kv_block_bytes(layout, c.num_layers, cfg.block_size,
                               engine.kv_cache_dtype, engine.kv_scale_width)
    allocated = sum(t.numel() * t.element_size()
                    for t in engine.kv_cache.values())
    out = dict(label=label, budget=SIZING_BUDGET, num_blocks=cfg.num_blocks,
               arithmetic=want, kv_block_bytes=per_block,
               allocated=allocated)
    if cfg.num_blocks != want or allocated != cfg.num_blocks * per_block \
            or allocated > SIZING_BUDGET:
        raise RuntimeError(f"pool sizing: {out}")
    return out


# Path (v): P/D disaggregation and the tiered KV cache on path (i)'s
# configuration.  The tier's decode wave fills two blocks a row while
# decoding (so the flush runs under async scheduling); its pool is small
# enough that two such waves evict the first wave's cached prefix.
TIER_WAVE = dict(n=64, prompt=128, new=128)
TIER_BLOCKS = 448
TIER_HOST_BLOCKS = 2048
TIER_ROUNDS = 1                              # a side, alternating


def pd_engines(params):
    """Path (v)(a)'s pair on ``params``: a producer with path (i)'s
    configuration and a consumer with path (i)'s full configuration
    (32-step blocks, async), talking over the native transport on
    127.0.0.1."""
    from llm_d_tpu_torch.transfer import KVConnectorConfig, TpuConnector
    from llm_d_tpu_torch.transfer import transport
    if transport._load_native() is None:
        raise RuntimeError("the native KV transport did not build (g++)")
    prod = path_i_engine(BENCH_K, params)
    prod.kv_connector = TpuConnector(KVConnectorConfig(
        kv_role="kv_producer", host="127.0.0.1"))
    if not isinstance(prod.kv_connector.server,
                      transport.NativeTransferServer):
        raise RuntimeError("the producer is not serving the native transport")
    cons = path_i_engine(BENCH_K, params)
    cons.kv_connector = TpuConnector(KVConnectorConfig(kv_role="kv_consumer"))
    return prod, cons


def pd_prefill(prod, prompts, tag: str):
    """The sidecar's first leg on ``prod``: each prompt with one new token
    under ``do_remote_decode``; returns (requests, seconds until every
    prefill finished and pinned its blocks)."""
    import torch
    from llm_d_tpu_torch.engine.request import Request, RequestState
    from llm_d_tpu_torch.ops.sampling import SamplingParams
    reqs = [Request(f"{tag}-{i}", p, SamplingParams(
        temperature=0.0, max_tokens=1, ignore_eos=True),
        do_remote_decode=True) for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        prod.add_request(r)
    while not all(r.state is RequestState.FINISHED_REMOTE_PREFILL
                  for r in reqs):
        if not prod.scheduler.has_work():
            raise RuntimeError(f"{tag}: prefill ended without pinning: "
                               f"{[r.state.value for r in reqs]}")
        prod.step()
    return reqs, time.perf_counter() - t0


def cache_rows(engine, blocks):
    """Every cache buffer's rows of ``blocks``, in block order."""
    import torch
    ids = torch.tensor(blocks, dtype=torch.long, device=engine.device)
    bs = engine.config.block_size
    return {n: t.view(t.shape[0], -1, bs, t.shape[2]).index_select(1, ids)
            for n, t in engine.kv_cache.items()}


def pd_decode(cons, prod, preqs, prompts, max_new: int, check_bytes=False):
    """The sidecar's second leg on ``cons``: each request with its
    producer's ``kv_transfer_params``.  The consumer steps once every
    pull has landed, so it admits the wave in one poll (and decodes it
    in one batch, as the producer prefilled it).  With ``check_bytes``,
    every cache buffer of every block the consumer scattered must equal
    the producer's bytes for that request.  Returns (tokens, figures)."""
    import numpy as np
    import torch
    from llm_d_tpu_torch.engine.request import Request
    from llm_d_tpu_torch.ops.sampling import SamplingParams
    reqs = [Request(pr.request_id, p, SamplingParams(
        temperature=0.0, max_tokens=max_new, ignore_eos=True),
        do_remote_prefill=True, kv_transfer_params=pr.kv_transfer_params)
        for pr, p in zip(preqs, prompts)]
    conn = cons.kv_connector
    t0 = time.perf_counter()
    for r in reqs:
        cons.add_request(r)
    while conn._loaded.qsize() < len(reqs):
        if time.perf_counter() - t0 > 120:
            raise RuntimeError("KV pulls did not land in 120 s")
        time.sleep(0.0005)
    landed = list(conn._loaded.queue)
    failed = [(r.request_id, err) for r, _, err, _ in landed if err]
    if failed:
        raise RuntimeError(f"KV pulls failed: {failed[:4]}")
    pulls = [dt for _, _, _, dt in landed]
    sizes = [len(blob) for _, blob, _, _ in landed]
    torch.cuda.synchronize()
    t_admit = time.perf_counter()
    outs = conn.poll(cons)
    if outs or any(not r.block_ids for r in reqs):
        raise RuntimeError(f"admission failed: {outs}")
    same = None
    if check_bytes:
        pb = [b for r in preqs for b in r.block_ids]
        db = [b for r in reqs for b in r.block_ids]
        want, got = cache_rows(prod, pb), cache_rows(cons, db)
        same = {n: bool(torch.equal(got[n], want[n])) for n in want}
        if not all(same.values()):
            raise RuntimeError(f"scattered blocks differ from the "
                               f"producer's bytes: {same}")
    first_s = None
    decode_s, decode_tokens = 0.0, 0
    counts0 = None
    while cons.has_work():
        ts = time.perf_counter()
        outs = cons.step()
        dt = time.perf_counter() - ts
        if first_s is None:
            if all(r.output_token_ids for r in reqs):
                torch.cuda.synchronize()
                first_s = time.perf_counter() - t_admit
                counts0 = (cons._dispatch_count, cons._step_count)
            continue
        decode_s += dt
        decode_tokens += sum(len(o.new_token_ids) for o in outs)
    tokens = [list(r.output_token_ids) for r in reqs]
    if any(len(t) != max_new for t in tokens):
        raise RuntimeError(f"consumer tokens: {[len(t) for t in tokens]}")
    pulls_ms = np.asarray(pulls) * 1e3
    return tokens, dict(
        requests=len(reqs), blob_bytes=sorted(set(sizes)),
        pull_ms=dict(median=float(np.median(pulls_ms)),
                     p99=float(np.percentile(pulls_ms, 99)),
                     max=float(pulls_ms.max())),
        admission_to_first_token_s=first_s, decode_seconds=decode_s,
        decode_tokens=decode_tokens,
        decode_tok_s=decode_tokens / decode_s if decode_s else None,
        decode_dispatches=cons._dispatch_count - counts0[0],
        decode_engine_steps=cons._step_count - counts0[1],
        bytes_equal=same)


def pd_release(prod) -> float:
    """Steps the producer until every pin its consumer released is
    freed; its pool must then be empty.  Returns the seconds it took."""
    t0 = time.perf_counter()
    while prod.pinned_transfers:
        if time.perf_counter() - t0 > 30:
            raise RuntimeError(f"pins never released: "
                               f"{sorted(prod.pinned_transfers)[:4]}")
        prod.step()
        time.sleep(0.001)
    if prod.kv_manager.usage != 0.0:
        raise RuntimeError(f"producer pool not empty: "
                           f"{prod.kv_manager.usage}")
    return time.perf_counter() - t0


def pd_run(prod, cons, p3, tok3, yardstick3, p1, rounds_i) -> dict:
    """Path (v)(a): wave 3 disaggregated (the producer's 8192-token
    prefill, 64 pulls, the consumer's 32-step blocks), its bytes, pins
    and tokens; the routing-replay witness; wave 1's prompts one at a
    time (the tokens phase (c) must give)."""
    out = dict(transport="native",
               graph_pools={
                   "producer": (None if prod._graphs is None
                                else graph_bounds(prod)),
                   "consumer": graph_bounds(cons)})
    preqs, out["producer_prefill_s"] = pd_prefill(prod, p3, "pd")
    tok, st = pd_decode(cons, prod, preqs, p3, WAVE3["new"],
                        check_bytes=True)
    check_multistep(st, "P/D wave 3")
    out["wave3"] = st
    L, bs = cons.model_config.num_layers, cons.config.block_size
    nb = -(-WAVE3["prompt"] // bs)
    payload = sum(nb * L * bs * t.shape[2] * t.element_size()
                  for t in cons.kv_cache.values())
    header = 24 + 5 * len(cons.kv_cache)
    out["payload_bytes_per_request"] = payload
    out["wire_bytes_per_request"] = payload + header
    if st["blob_bytes"] != [payload + header]:
        raise RuntimeError(f"blob bytes {st['blob_bytes']} != "
                           f"{payload + header}")
    out["pins_released_s"] = pd_release(prod)
    # Again, warm (the first run's block captured the consumer's graph):
    # the same tokens, and the decode figures to set beside path (i)'s.
    replays0 = cons._graphs.replays
    preqs, out["producer_prefill_warm_s"] = pd_prefill(prod, p3, "pd2")
    tok2, out["wave3_warm"] = pd_decode(cons, prod, preqs, p3, WAVE3["new"])
    check_multistep(out["wave3_warm"], "P/D wave 3 warm")
    pd_release(prod)
    if tok2 != tok or cons._graphs.replays == replays0:
        raise RuntimeError("P/D wave 3 did not repeat through the "
                           "consumer's graph")
    out["consumer_graph_replays"] = cons._graphs.replays
    _, _, margins, bars = yardstick3
    d = divergence(tok, tok3, margins, bars)
    d["tokens"] = WAVE3["new"] * len(p3)
    out["against_path_i"] = d
    out["path_i_wave3_decode_tok_s"] = \
        rounds_i["wave3"]["multistep"]["decode_tok_s"]
    # The witness: wave 3 again, the consumer eager with the classic
    # loop's routing replayed (its recomputed last prompt tokens run other
    # kernels than the producer's prefill, and a one-ulp router
    # difference flips top-8 near ties): every row must keep the classic
    # tokens up to a near tie.
    ref, tape, _, _ = yardstick3
    wreqs, _ = pd_prefill(prod, p3, "pdw")
    graphs, cons._graphs = cons._graphs, None
    try:
        with routing_tape(cons, tape, replay=True) as replayed:
            wtok, _ = pd_decode(cons, prod, wreqs, p3, WAVE3["new"])
    finally:
        cons._graphs = graphs
    pd_release(prod)
    w = divergence(wtok, ref, margins, bars)
    w["near_ties_only"] = all(
        m is None or m <= b for m, b in zip(
            w["classic_top2_margin_there"], w["classic_bar_there"]))
    w["token_layers_replayed"] = replayed[0]
    out["classic_routing_replayed"] = w
    if not w["near_ties_only"]:
        raise RuntimeError(f"P/D with the classic routing replayed left the "
                           f"classic tokens at a decided position: {w}")
    # Wave 1's prompts one at a time: the CLI pair's reference.
    alone = []
    for i, p in enumerate(p1):
        pr, _ = pd_prefill(prod, [p], f"pd1{i}")
        t, _ = pd_decode(cons, prod, pr, [p], WAVE1["new"])
        alone.append(t[0])
    pd_release(prod)
    return out, alone


def chain_hashes(engine, prompt):
    """The prefix cache's chain hashes of ``prompt``'s full blocks."""
    from llm_d_tpu_torch.utils.hashing import hash_block
    km, out, parent = engine.kv_manager, [], None
    for i in range(len(prompt) // km.block_size):
        parent = hash_block(parent, prompt[i * km.block_size:
                                           (i + 1) * km.block_size],
                            km.hash_seed)
        out.append(parent)
    return out


def tier_run(params, p1, tok1, vocab):
    """Path (v)(b): path (i)'s configuration with the prefix cache on, a
    448-block pool and a 2048-block host tier (``on``), against the same
    engine without the tier (``off``).  ``off`` serves wave 1's prompts
    twice (the second pass hits its device prefix cache: the control);
    ``on`` serves them, then decode waves that evict their prefix, then
    them again (restored from the host tier): the tokens must be the
    control's, and each restored block's bytes the saved slab's.  The
    decode waves alternate between ``on`` and ``off``.  Returns the
    figures and the two engines' launches inside graph replays."""
    import numpy as np
    import torch
    from llm_d_tpu_torch.engine.offload import _pack_block_slab
    on = path_i_engine(BENCH_K, params, enable_prefix_caching=True,
                       num_blocks=TIER_BLOCKS,
                       kv_offload_blocks=TIER_HOST_BLOCKS)
    off = path_i_engine(BENCH_K, params, enable_prefix_caching=True,
                        num_blocks=TIER_BLOCKS)
    for e in (on, off):
        note_live_tokens(e)
    # Host seconds of each flush that queued copies (or packed earlier
    # ones), and of each restore.
    flush_s, restore_s = [], []
    real_flush = on.host_tier.flush

    def flush():
        t = time.perf_counter()
        pending = bool(on.host_tier._pending or on.host_tier._gathers)
        real_flush()
        if pending:
            flush_s.append(time.perf_counter() - t)

    on.host_tier.flush = flush
    out = dict(num_blocks=TIER_BLOCKS, host_blocks=TIER_HOST_BLOCKS)
    first_on, st = run_wave(on, p1, WAVE1["new"], "ta")
    check_multistep(st, "tier wave A")
    first_off, _ = run_wave(off, p1, WAVE1["new"], "ta")
    control, st = run_wave(off, p1, WAVE1["new"], "tc")
    if off.kv_manager.eviction_count:
        raise RuntimeError("the control evicted its prefix")
    out["first_pass_equal"] = first_on == first_off
    out["first_pass_equal_path_i"] = first_on == tok1
    rng = np.random.default_rng(31)
    runs = {"on": [], "off": []}
    replays0 = on._graphs.replays
    # A warm-up wave a side (each engine's first decode block of this
    # shape is its capture), then the rounds.
    for r in range(-1, TIER_ROUNDS):
        prompts = prompts_for(rng, vocab, TIER_WAVE)
        sides = [("on", on), ("off", off)]
        if r % 2:
            sides.reverse()
        toks = {}
        for side, eng in sides:
            toks[side], st = run_wave(eng, prompts, TIER_WAVE["new"],
                                      f"t{side}{r}")
            check_multistep(st, f"tier round {r} {side}")
            if r >= 0:
                runs[side].append(st)
        if toks["on"] != toks["off"]:
            raise RuntimeError(f"tier round {r}: the tier changed tokens")
    km = on.kv_manager
    hashes = [h for p in p1 for h in chain_hashes(on, p)]
    resident = sum(km.lookup_hash(h) is not None for h in hashes)
    if resident == len(hashes):
        raise RuntimeError("the decode waves did not evict wave A's prefix")
    real = km.secondary_lookup
    restored = []
    bs = on.config.block_size

    def restore(h, protected=frozenset(), region=0):
        t = time.perf_counter()
        b = real(h, protected, region)
        if b is not None:
            restore_s.append(time.perf_counter() - t)
            torch.cuda.synchronize()
            rows = {n: t[:, b * bs:(b + 1) * bs].cpu()
                    for n, t in on.kv_cache.items()}
            restored.append(_pack_block_slab(rows)
                            == on.host_tier._store[h])
        return b

    km.secondary_lookup = restore
    loads0 = on.host_tier.loads
    try:
        again, st = run_wave(on, p1, WAVE1["new"], "tr")
    finally:
        km.secondary_lookup = real
    check_multistep(st, "tier wave A restored")
    tier = on.host_tier
    out.update(
        evictions=km.eviction_count, prefix_blocks_resident=resident,
        prefix_blocks=len(hashes), restored=len(restored),
        restored_bytes_equal=sum(restored),
        saves=tier.saves, loads=tier.loads - loads0,
        host_blocks_held=tier.num_blocks,
        flush_ms=spread(np.asarray(flush_s) * 1e3),
        restore_ms=spread(np.asarray(restore_s) * 1e3),
        restore_total_ms=float(np.sum(restore_s) * 1e3),
        replays_during_rounds=on._graphs.replays - replays0,
        decode_tok_s={side: spread([x["decode_tok_s"] for x in v])
                      for side, v in runs.items()},
        restored_tokens_equal_control=again == control,
        graphs={"on": graph_bounds(on), "off": graph_bounds(off)})
    if not restored or not all(restored):
        raise RuntimeError(f"restored blocks differ from the saved slab: "
                           f"{sum(restored)} of {len(restored)} equal")
    if again != control:
        diff = sum(a != b for x, y in zip(again, control)
                   for a, b in zip(x, y))
        raise RuntimeError(f"the restored run's tokens differ from the "
                           f"control's in {diff}")
    on.host_tier.close()
    return out, [dict(on._graphs.launches), dict(off._graphs.launches)]


def pd_cli_pair(root, prompts, want) -> dict:
    """Path (v)(c): ``python -m llm_d_tpu_torch.server.openai`` twice with
    path (i)'s flags, a producer and a consumer (``--kv-transfer-config``);
    this process plays the routing sidecar: each prompt (one at a time)
    to the producer with ``{"kv_transfer_params": {"do_remote_decode":
    true}}`` and one new token, then to the consumer with the producer's
    returned params, streamed.  Tokens must equal ``want``; the
    consumer's ``/metrics`` must count one transfer per request; both
    servers must exit 0 on SIGTERM."""
    import signal
    procs, urls, logs = {}, {}, {}
    t0 = time.perf_counter()
    for role in ("kv_producer", "kv_consumer"):
        port = free_port()
        urls[role] = f"http://127.0.0.1:{port}"
        logs[role] = os.path.join(root, "build", f"{role}.log")
        procs[role] = start_server(root, [
            *SERVER_FLAGS, "--host", "127.0.0.1", "--port", str(port),
            "--kv-transfer-config",
            json.dumps({"kv_role": role, "kv_ip": "127.0.0.1"})],
            f"{role}.log")
    out = {}
    try:
        for role, url in urls.items():
            wait_ready(procs[role], url)
        out["startup_s"] = time.perf_counter() - t0
        tokens, ttft = [], []
        for p in prompts:
            body = greedy_body(p, WAVE1["new"], True)
            # The sidecar's prefill body (llm_d_tpu/sidecar/proxy.py).
            pbody = dict(body, stream=False, max_tokens=1,
                         kv_transfer_params={"do_remote_decode": True})
            ts = time.perf_counter()
            status, _, reply = http_call(urls["kv_producer"],
                                         "/v1/completions", pbody)
            if status != 200 or "kv_transfer_params" not in reply:
                raise RuntimeError(f"producer: HTTP {status}: {reply}")
            res = completion(urls["kv_consumer"], dict(
                body, kv_transfer_params=reply["kv_transfer_params"]))
            if res["finish"] != "length":
                raise RuntimeError(f"consumer: {res}")
            ttft.append(res["t_first"] - ts)
            tokens.append(res["tokens"])
        out["ttft_s"] = spread(ttft)
        out["tokens_equal"] = sum(a == b for x, y in zip(tokens, want)
                                  for a, b in zip(x, y))
        out["tokens"] = WAVE1["new"] * len(prompts)
        model = SERVER_FLAGS[SERVER_FLAGS.index("--model") + 1]
        lab = f'{{model_name="{model}"}}'
        m = scrape(urls["kv_consumer"])
        out["consumer_kv_transfer_seconds_count"] = \
            m["llmd_tpu:kv_transfer_seconds_count" + lab]
        t1 = time.perf_counter()
        while scrape(urls["kv_producer"])["vllm:kv_cache_usage_perc" + lab]:
            if time.perf_counter() - t1 > 30:
                raise RuntimeError("the producer kept its pins")
            time.sleep(0.05)
        if tokens != want:
            raise RuntimeError(f"the CLI pair's tokens differ from the "
                               f"in-process pair's: {out['tokens_equal']} "
                               f"of {out['tokens']} equal")
        if out["consumer_kv_transfer_seconds_count"] != len(prompts):
            raise RuntimeError(f"consumer /metrics: {out}")
        out["exit"] = {}
        for role, proc in procs.items():
            t_term = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=DRAIN_S + 60)
            out["exit"][role] = dict(code=rc,
                                     seconds=time.perf_counter() - t_term)
            if rc != 0:
                raise RuntimeError(f"{role} exited with {rc} on SIGTERM")
    except BaseException:
        for role, path in logs.items():
            with open(path, "rb") as f:
                sys.stderr.write(f"--- {role} ---\n"
                                 + f.read()[-4000:].decode(errors="replace"))
        raise
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    return out


COLD_MODES = ("default", "eager", "busy", "busy-switch")
COLD_PROBE_S = 240


def cold_probe(root: str, mode: str) -> dict:
    """The first decode block of a fresh process, as the server meets it:
    ``python3 chip_smoke.py --cold-probe MODE`` builds path (i)'s engine,
    serves wave 3's shape (one 8192-token prefill step, then the first
    32-step block: its graph's warm-up, capture and first replay) and
    prints the parts' host seconds.  ``MODE``: "default"; "eager" (CUDA
    modules loaded at context creation, ``CUDA_MODULE_LOADING=EAGER``);
    "busy" (another Python thread busy half of every 10 ms meanwhile, as
    a server's event loop under load competes for the interpreter);
    "busy-switch" (the same, with the interpreter's switch interval at
    0.5 ms instead of 5 ms).  A probe still running after
    ``COLD_PROBE_S`` seconds is stopped and reported so."""
    env = dict(os.environ)
    if mode == "eager":
        env["CUDA_MODULE_LOADING"] = "EAGER"
    t0 = time.perf_counter()
    try:
        res = subprocess.run(
            [sys.executable, os.path.join(root, "chip_smoke.py"),
             "--cold-probe", mode], cwd=root, env=env, capture_output=True,
            text=True, timeout=COLD_PROBE_S)
    except subprocess.TimeoutExpired:
        return dict(mode=mode, timed_out_s=COLD_PROBE_S)
    if res.returncode != 0:
        raise RuntimeError(f"cold probe {mode}: {res.stderr[-4000:]}")
    return dict(json.loads(res.stdout.strip().splitlines()[-1]),
                process_s=time.perf_counter() - t0)


def cold_probe_main(mode: str) -> int:
    """The body of ``--cold-probe`` (in its own process)."""
    import threading
    import numpy as np
    import torch
    from llm_d_tpu_torch.ops import _build
    t0 = time.perf_counter()
    torch.zeros(1, device="cuda")
    ctx_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine = path_i_engine()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    stop = threading.Event()
    spins = [0]

    def busy():
        while not stop.is_set():
            t_end = time.perf_counter() + 0.005
            while time.perf_counter() < t_end:
                spins[0] += 1
            time.sleep(0.005)

    if mode.startswith("busy"):
        if mode == "busy-switch":
            sys.setswitchinterval(0.0005)
        threading.Thread(target=busy, daemon=True).start()
    prompts = prompts_for(np.random.default_rng(5),
                          engine.model_config.vocab_size, WAVE3)
    reqs = add_requests(engine, prompts, "cold", 1 + BENCH_K)
    t0 = time.perf_counter()
    engine.step()                        # the 8192-token prefill step
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.step()                        # dispatches the first block
    dispatch_s = time.perf_counter() - t0
    while engine.has_work():
        engine.step()
    torch.cuda.synchronize()
    block_s = time.perf_counter() - t0
    stop.set()
    if any(len(r.output_token_ids) != 1 + BENCH_K for r in reqs):
        raise RuntimeError("cold probe: a request did not finish")
    (key, g), = engine._graphs.graphs.items()
    print(json.dumps(dict(
        mode=mode, context_s=ctx_s, engine_init_s=init_s,
        kernels_loaded_before_block=sorted(_build._libs),
        prefill_s=prefill_s, first_block_dispatch_s=dispatch_s,
        first_block_s=block_s, graph=dict(key=list(key), **g.cold),
        launches=sum(g.launches.values()), spins=spins[0])))
    return 0


def dense_prompts(vocab: int):
    """The path (ii) wave's prompts (the same in every cache mode)."""
    import numpy as np
    return prompts_for(np.random.default_rng(2), vocab, DENSE_WAVE)


def long_decode_inputs(args, kw, S: int, keys: int, seed: int):
    """Kernel A's inputs at long context, from a seed: S sequences of
    ``keys`` keys each on one int8 layer plane, at the row width, heads,
    block size, block-table width and scale of the recorded launch
    ``(args, kw)``."""
    q0, _, cache, bt0 = args[:4]
    return decode_inputs(True, kw["block_size"], [keys] * S, seed,
                         H=q0.shape[1], F=cache.shape[-1], scale=kw["scale"],
                         B=bt0.shape[1])


def decode_inputs(quantized: bool, bs: int, seq_lens, seed: int,
                  H: int = 16, F: int = 640, scale: float = 0.1,
                  B: int = 0):
    """Kernel A's inputs from a seed: ``seq_lens`` sequences on one latent
    layer plane (int8 with a row scale, or bf16) holding just their pages
    of ``bs`` rows, in random order; block tables ``B`` entries wide, or
    as wide as the longest sequence needs."""
    import torch
    from llm_d_tpu_torch.ops.quant import quantize_kv_block
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    S = len(seq_lens)
    pages = [-(-n // bs) for n in seq_lens]
    nblk = sum(pages) + 1
    kv = torch.randn((1, nblk * bs, F), generator=g, device=dev).bfloat16()
    row = torch.randn((S, F), generator=g, device=dev).bfloat16()
    ks = row_s = None
    if quantized:
        kv, ks = quantize_kv_block(kv, 1)
        row, row_s = quantize_kv_block(row, 1)
    bt = random_tables(g, pages, B)
    lens = torch.tensor(seq_lens, dtype=torch.int32, device=dev)
    q = torch.randn((S, H, F), generator=g, device=dev).bfloat16()
    return (q, row, kv, bt, lens), dict(
        block_size=bs, scale=scale, layer=0, kv_scale=ks,
        row_scale_new=row_s)


def random_tables(g, pages, B: int = 0):
    """Block tables of sequences holding ``pages[i]`` pages each, drawn
    in random order from blocks 1 .. sum(pages) (block 0 stays the trash
    block), ``B`` entries wide or as wide as the longest needs."""
    import torch
    dev = torch.device("cuda")
    nblk = sum(pages) + 1
    perm = (torch.randperm(nblk - 1, generator=g, device=dev) + 1).to(
        torch.int32)
    bt = torch.zeros((len(pages), max(B, max(pages))), dtype=torch.int32,
                     device=dev)
    for s, (start, n) in enumerate(zip(
            [sum(pages[:i]) for i in range(len(pages))], pages)):
        bt[s, :n] = perm[start:start + n]
    return bt


def dense_rows(g, shape, sw: int):
    """bf16 rows from ``g``, or int8 ones with ``sw`` f32 scale columns:
    ``(rows, scales or None)``."""
    import torch
    from llm_d_tpu_torch.ops.quant import quantize_kv_block
    rows = torch.randn(shape, generator=g, device="cuda").bfloat16()
    return (rows, None) if sw == 0 else quantize_kv_block(rows, sw)


def dense_decode_inputs(sw: int, bs: int, seq_lens, seed: int, H: int = 32,
                        KVH: int = 8, D: int = 64, scale: float = 0.125,
                        B: int = 0):
    """Kernel G's inputs from a seed: ``seq_lens`` sequences on one K and
    one V layer plane (bf16, or int8 with ``sw`` scale columns) holding
    just their pages of ``bs`` rows, in random order, and each sequence's
    new K/V rows; block tables ``B`` entries wide, or as wide as the
    longest sequence needs."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    S, F = len(seq_lens), KVH * D
    pages = [-(-n // bs) for n in seq_lens]
    slots = (sum(pages) + 1) * bs
    (kc, ks), (vc, vs) = (dense_rows(g, (1, slots, F), sw) for _ in range(2))
    (kn, kns), (vn, vns) = (dense_rows(g, (S, F), sw) for _ in range(2))
    bt = random_tables(g, pages, B)
    lens = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
    q = torch.randn((S, H, D), generator=g, device="cuda").bfloat16()
    return (q, kn, vn, kc, vc, bt, lens), dict(
        block_size=bs, num_kv_heads=KVH, scale=scale, layer=0, k_scale=ks,
        v_scale=vs, k_scale_new=kns, v_scale_new=vns)


def long_dense_decode_inputs(args, kw, S: int, keys: int, seed: int):
    """Kernel G's inputs at long context, from a seed: S sequences of
    ``keys`` keys each on a bf16 layer plane, at the heads, block size,
    block-table width and scale of the recorded launch ``(args, kw)``."""
    q0, bt0 = args[0], args[5]
    return dense_decode_inputs(0, kw["block_size"], [keys] * S, seed,
                               H=q0.shape[1], KVH=kw["num_kv_heads"],
                               D=q0.shape[2], scale=kw["scale"],
                               B=bt0.shape[1])


def dense_prefill_inputs(sw: int, bs: int, seq_lens, q_lens, seed: int,
                         H: int = 32, KVH: int = 8, D: int = 128,
                         scale: float = 0.09):
    """Kernel H's inputs from a seed: sequence i's last ``q_lens[i]``
    positions are the queries (padded to the longest, pad rows at
    position -1) over a bf16 or int8 (``sw`` scale columns) layer plane
    holding just its pages of ``bs`` rows."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    S, F, Q = len(seq_lens), KVH * D, max(q_lens)
    pages = [max(-(-n // bs), 1) for n in seq_lens]
    slots = (sum(pages) + 1) * bs
    (kc, ks), (vc, vs) = (dense_rows(g, (1, slots, F), sw) for _ in range(2))
    bt = random_tables(g, pages)
    q_pos = torch.full((S, Q), -1, dtype=torch.int32, device="cuda")
    for i, (n, m) in enumerate(zip(seq_lens, q_lens)):
        q_pos[i, :m] = torch.arange(n - m, n, device="cuda")
    qs = torch.randn((S, Q, H, D), generator=g, device="cuda").bfloat16()
    qs[q_pos < 0] = 0
    lens = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
    return (qs, q_pos, kc, vc, bt, lens), dict(
        block_size=bs, num_kv_heads=KVH, scale=scale, layer=0, k_scale=ks,
        v_scale=vs)


# The MLA latent's value columns (kv_lora_rank of deepseek-v3-bench); the
# rest of the 640-wide row is rope and padding.
MLA_V_COLS = 512


def sdpa_ms(name: str, args, kw) -> float:
    """Eager ms of one ``torch.nn.functional.scaled_dot_product_attention``
    call computing the attention of kernel A (``mla_decode``), B
    (``mla_prefill``), G (``paged_decode``) or H (``flash_prefill``) on a
    bf16 cache: the same queries, and K/V gathered (untimed) from the
    cache into contiguous [S, KVH, L, D] rows of each sequence's live
    keys (MLA: the query heads over one shared K, the whole latent row,
    and V, its first ``MLA_V_COLS`` columns; an int8 cache or latent
    dequantized to bf16 as it is gathered), causal where every query row
    attends its own prefix.  A yardstick only; the port never calls
    it."""
    import torch
    import torch.nn.functional as Fn
    bs, scale = kw["block_size"], kw["scale"]
    KVH = kw.get("num_kv_heads", 1)
    if name == "mla_decode":
        q, kc, bt, sl = args[0], args[2], args[3], args[4]
        vc = kc
    elif name == "mla_prefill":
        qs, q_pos, kc, bt, sl = args[:5]
        vc = kc
    elif name == "paged_decode":
        q, kc, vc, bt, sl = args[0], args[3], args[4], args[5], args[6]
    else:
        qs, q_pos, kc, vc, bt, sl = args[:6]
    if name.endswith("decode"):
        q = q[:, :, None, :]                                 # [S, H, 1, D]
        q_pos = (sl.long() - 1)[:, None]                     # [S, 1]
    else:
        q = qs.permute(0, 2, 1, 3).contiguous()              # [S, H, Q, D]
        q_pos = q_pos.long()
    S, H, Q, D = q.shape
    L = int(sl.max())
    keys = torch.arange(L, device=q.device)
    slots = bt.long()[:, keys // bs] * bs + keys % bs        # [S, L]
    layer = kw.get("layer") or 0

    def gather(cache, scale):
        plane = cache[layer] if cache.ndim == 3 else cache
        rows = plane[slots]                                  # [S, L, F]
        if scale is not None:
            # An int8 cache: the same rows dequantized to bf16.
            sc = (scale[layer] if scale.ndim == 3 else scale)[slots]
            rows = (rows.float().view(S, L, sc.shape[-1], -1)
                    * sc[..., None]).view(S, L, -1).bfloat16()
        return rows.view(S, L, KVH, D).permute(0, 2, 1, 3).contiguous()

    if name.startswith("mla_"):
        # An int8 latent has one scale plane for its shared K and V.
        k = v = gather(kc, kw.get("kv_scale"))
    else:
        k, v = gather(kc, kw.get("k_scale")), gather(vc, kw.get("v_scale"))
    if name.startswith("mla_"):
        v = v[..., :MLA_V_COLS].contiguous()
    causal = Q == L and bool((sl == L).all()) and bool(
        (q_pos == keys[None, :]).all())
    mask = None
    if not causal:
        mask = ((keys[None, None, :] <= q_pos[:, :, None])
                & (keys[None, None, :] < sl.long()[:, None, None]))[:, None]
    try:
        Fn.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                        is_causal=causal, scale=scale,
                                        enable_gqa=True)
        extra = dict(enable_gqa=True)
    except TypeError:                    # torch without enable_gqa
        k = k.repeat_interleave(H // KVH, dim=1)
        v = v.repeat_interleave(H // KVH, dim=1)
        extra = {}
    return time_ms(lambda: Fn.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal, scale=scale, **extra),
        iters=20)


def mla_prefill_inputs(bs: int, seq_lens, q_lens, seed: int, H: int = 16,
                       F: int = 640, scale: float = 0.1):
    """Kernel B's inputs on a bf16 latent from a seed: sequence i's last
    ``q_lens[i]`` positions are the queries (padded to the longest, pad
    rows at position -1) over one layer plane holding just its pages of
    ``bs`` rows, in random order."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    S, Q = len(seq_lens), max(q_lens)
    pages = [max(-(-n // bs), 1) for n in seq_lens]
    kv = torch.randn((1, (sum(pages) + 1) * bs, F), generator=g,
                     device="cuda").bfloat16()
    bt = random_tables(g, pages)
    q_pos = torch.full((S, Q), -1, dtype=torch.int32, device="cuda")
    for i, (n, m) in enumerate(zip(seq_lens, q_lens)):
        q_pos[i, :m] = torch.arange(n - m, n, device="cuda")
    qs = torch.randn((S, Q, H, F), generator=g, device="cuda").bfloat16()
    qs[q_pos < 0] = 0
    lens = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
    return (qs, q_pos, kv, bt, lens), dict(block_size=bs, scale=scale,
                                           layer=0, kv_scale=None)


def moe_inputs(mc, T: int, seed: int):
    """``T`` tokens of hidden rows and top-k routing over the model's
    experts, from a seed, on the card."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    E, k = mc.num_experts, mc.num_experts_per_tok
    x = torch.randn((T, mc.hidden_size), generator=g,
                    device=dev).bfloat16()
    idx = torch.argsort(torch.rand((T, E), generator=g, device=dev),
                        dim=1)[:, :k].to(torch.int32)
    w = torch.rand((T, k), generator=g, device=dev) / k
    return x, w, idx


def large_page_reference(mc, params, quantized: bool, bs: int,
                         wrappers) -> dict:
    """``reference_check`` (a 1024-token prefill, then one decode step
    through kernel A) on a latent cache in pages of ``bs`` rows, larger
    than two of which fit A's shared memory; each of ``wrappers``
    (``(module, name)`` of kernels A and B) must launch."""
    engine_kw = dict(quantization="int8",
                     kv_cache_dtype="int8" if quantized else "bf16",
                     block_size=bs, num_blocks=1536 // bs + 1,
                     max_num_seqs=8, max_num_batched_tokens=1024,
                     enable_prefix_caching=False)
    before = [getattr(m, f).launches for m, f in wrappers]
    ref = reference_check(mc, params, engine_kw, [1024], 8)
    ref.update(latent=engine_kw["kv_cache_dtype"], block_size=bs,
               launches=[getattr(m, f).launches - b
                         for (m, f), b in zip(wrappers, before)])
    if min(ref["launches"]) == 0:
        raise RuntimeError(f"kernel A or B did not launch: {ref}")
    return ref


def dense_large_page_reference(wrappers) -> dict:
    """``reference_check`` of a 2-layer llama3-8b (D = 128, random weights
    from a seed) on a bf16 cache in 256-row pages: a 300-token prefill (two
    pages through kernel H), then one decode step through kernel G; each
    of ``wrappers`` (``(module, name)`` of G and H) must launch."""
    import dataclasses
    import torch
    from llm_d_tpu_torch.models import llama
    from llm_d_tpu_torch.models.config import get_config
    mc = dataclasses.replace(get_config("llama3-8b"), num_layers=2,
                             max_model_len=1024)
    params = llama.init_params(
        mc, torch.Generator(device="cuda").manual_seed(4),
        torch.device("cuda"))
    engine_kw = dict(block_size=256, num_blocks=5, max_num_seqs=8,
                     max_num_batched_tokens=512, enable_prefix_caching=False)
    before = [getattr(m, f).launches for m, f in wrappers]
    ref = reference_check(mc, params, engine_kw, [300], 13)
    ref.update(block_size=256, launches=[
        getattr(m, f).launches - b for (m, f), b in zip(wrappers, before)])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if min(ref["launches"]) == 0:
        raise RuntimeError(f"kernel G or H did not launch: {ref}")
    if not ref["top1_agree"] or ref["rel_max_err"] > 5e-2:
        raise RuntimeError(f"kernel path disagrees with the CPU "
                           f"reference: {ref}")
    return ref


def tiny_on_the_card() -> dict:
    """``tiny`` (KVH*D = 32: no kernel takes its rows) on the card: a
    greedy wave through the chunked attention path, served twice (must
    repeat), first tokens against the CPU engine on the 'chunked'
    backend."""
    import numpy as np
    import torch
    from llm_d_tpu_torch.engine import EngineConfig, EngineCore
    from llm_d_tpu_torch.ops import attention
    kw = dict(model="tiny", block_size=32, num_blocks=128, max_num_seqs=16,
              max_num_batched_tokens=512, enable_prefix_caching=False)
    card = EngineCore(EngineConfig(device="cuda", **kw))
    host = EngineCore(EngineConfig(device="cpu", attn_backend="chunked",
                                   **kw),
                      params=clone_to(card.params, "cpu"))
    prompts = [np.random.default_rng(3).integers(
        1, card.model_config.vocab_size, n).tolist()
        for n in (7, 40, 100, 3, 64, 33)]
    with capture(attention, "ragged_paged_attention_chunked") as seen:
        tok, stats = run_wave(card, prompts, 16, "tiny")
    tok2, _ = run_wave(card, prompts, 16, "tiny2")
    ref = cpu_tokens(host, prompts, 16)
    res = dict(wave=stats, repeat=tok2 == tok,
               first_tokens_match_cpu=[t[0] for t in tok]
               == [t[0] for t in ref],
               tokens_match_cpu=tok == ref,
               chunked_calls=len(seen),
               chunked_on_cuda=all(a[0].is_cuda for a, _ in seen))
    if not (res["repeat"] and res["first_tokens_match_cpu"] and seen
            and res["chunked_on_cuda"]):
        raise RuntimeError(f"tiny on the card: {res}")
    return res


def cpu_tokens(engine, prompts, max_new: int):
    """Greedy tokens of ``prompts`` from a CPU engine."""
    from llm_d_tpu_torch.engine.request import Request
    from llm_d_tpu_torch.ops.sampling import SamplingParams
    reqs = [Request(f"cpu-{i}", p, SamplingParams(
        temperature=0.0, max_tokens=max_new, ignore_eos=True))
        for i, p in enumerate(prompts)]
    out = engine.generate(reqs)
    return [out[r.request_id] for r in reqs]


def soft_cap_through_chunked() -> dict:
    """A soft-capped decode batch (no kernel takes one) through
    ``attention_with_kv_update`` on the card, which sends it to the
    chunked path, against the full-softmax reference on the same cache:
    atol = rtol = 2e-2, the K/V rows written identically outside the
    trash block."""
    import torch
    from llm_d_tpu_torch.ops import attention
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    H, KVH, D, bs, L = 32, 8, 64, 64, 2
    lens = [1, 63, 64, 65, 700, 2000, 0, 0]
    S, B = len(lens), 32
    T = S
    nblk = S * B + 1
    caches = [torch.randn((L, nblk * bs, KVH * D), generator=g,
                          device=dev).bfloat16() for _ in range(2)]
    bt = (torch.randperm(nblk - 1, generator=g, device=dev)[:S * B] + 1
          ).reshape(S, B).to(torch.int32)
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    bt[sl == 0] = 0
    pos = (sl - 1).clamp(min=0)
    rows = torch.arange(S, device=dev)
    slot = torch.where(sl > 0, bt[rows, pos // bs] * bs + pos % bs, 0)
    batch = dict(positions=pos.int(), token_seq_ids=rows.int(),
                 token_qpos=torch.zeros(T, dtype=torch.int32, device=dev),
                 slot_mapping=slot.int(), block_tables=bt.contiguous(),
                 seq_lens=sl,
                 qtok_idx=torch.where(sl > 0, rows, T).int()[:, None])
    q = torch.randn((T, H, D), generator=g, device=dev).bfloat16()
    kn = torch.randn((T, KVH, D), generator=g, device=dev).bfloat16()
    vn = torch.randn((T, KVH, D), generator=g, device=dev).bfloat16()
    outs = []
    with capture(attention, "ragged_paged_attention_chunked") as seen:
        for backend in ("kernel", "reference"):
            kc, vc = (c.clone() for c in caches)
            outs.append((attention.attention_with_kv_update(
                q, kn, vn, kc, vc, batch, block_size=bs, scale=0.125,
                soft_cap=30.0, backend=backend, layer=1)))
    torch.cuda.synchronize()
    live = sl > 0
    got, want = outs[0][0][live].float(), outs[1][0][live].float()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
    # Block 0 is the trash block: the pad rows all write slot 0, in no
    # fixed order, and no unmasked read touches it.
    for a, b in zip(outs[0][1:], outs[1][1:]):
        if not torch.equal(a[:, bs:], b[:, bs:]):
            raise RuntimeError("soft-capped batch: cache writes differ")
    if len(seen) != 1 or not torch.isfinite(outs[0][0]).all():
        raise RuntimeError(f"soft-capped batch: {len(seen)} chunked calls")
    return dict(shape=[T, H, D], seq_lens=lens, chunked_calls=len(seen),
                max_abs_err=float((got - want).abs().max()))


def noise_on_the_card() -> dict:
    """The sampler's Gumbel noise drawn on the card and on the CPU for the
    same rows: seeded (seeds 0, 7, 2**31 - 1 at several gen_idx) and
    unseeded (step keys split from the engine key of seeds 0 and 3), bit
    for bit."""
    import torch
    from llm_d_tpu_torch.ops import prng, sampling
    seeds = torch.tensor([0, 7, 2**31 - 1, -1, 7, -1, 0, -1],
                         dtype=torch.int32)
    gen = torch.tensor([0, 1, 1000, 5, 15, 0, 3, 2], dtype=torch.int32)
    rows = 0
    for engine_seed in (0, 3):
        key = prng.prng_key(engine_seed)
        for _ in range(3):
            key, step = prng.split(key)
            cpu = sampling.row_noise(8, 64, torch.device("cpu"), step,
                                     seeds, gen)
            card = sampling.row_noise(8, 64, torch.device("cuda"), step,
                                      seeds.cuda(), gen.cuda()).cpu()
            if not torch.equal(cpu.view(torch.int32),
                               card.view(torch.int32)):
                bad = int((cpu.view(torch.int32)
                           != card.view(torch.int32)).sum())
                raise RuntimeError(f"Gumbel noise differs on the card in "
                                   f"{bad} of {cpu.numel()} values")
            rows += 8
    return dict(rows=rows, values_per_row=64, bit_equal=True)


class DecimalTokenizer:
    """Decodes each id as its decimal text and a space (so a reply's text
    carries its token ids, and the text of a prefix is a prefix of the
    text); no special tokens."""
    bos_token_id = eos_token_id = pad_token_id = None

    def encode(self, text: str, add_bos: bool = True):
        return [int(t) for t in text.split()]

    def decode(self, ids) -> str:
        return "".join(f"{i} " for i in ids)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_call(url: str, path: str, body=None, timeout: float = 600.0,
              headers=None):
    """``(status, headers, reply)`` of one call (a POST when ``body`` is
    given, with the request ``headers`` added); a JSON reply is parsed,
    any other is text.  The reply's ``headers`` look names up without
    regard to case."""
    import urllib.error
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url + path, data=data,
        headers={**({"Content-Type": "application/json"} if data else {}),
                 **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, headers, raw = r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        status, headers, raw = e.code, e.headers, e.read()
    if headers.get("Content-Type", "").startswith("application/json"):
        return status, headers, json.loads(raw)
    return status, headers, raw.decode()


def completion(url: str, body: dict, timeout: float = 600.0,
               headers=None) -> dict:
    """One /v1/completions call (the request ``headers`` added), streamed
    or not: its token count (from the usage block of a whole reply), its
    token ids (a stream's from each chunk's ``llmd`` meta; a whole reply's
    from its text, read as the ``DecimalTokenizer`` writes it, when the
    server uses that tokenizer), finish reason, the reply's headers, and
    client-side clock readings (``perf_counter``) at the send, the first
    and the last token chunk, and the end."""
    import urllib.request
    t_send = time.perf_counter()
    if not body.get("stream"):
        status, hdr, reply = http_call(url, "/v1/completions", body, timeout,
                                       headers)
        if status != 200:
            raise RuntimeError(f"completion: HTTP {status}: {reply}")
        choice = reply["choices"][0]
        words = choice["text"].split()
        return dict(n=reply["usage"]["completion_tokens"],
                    tokens=([int(t) for t in words]
                            if all(w.isdigit() for w in words) else None),
                    finish=choice["finish_reason"], t_send=t_send,
                    t_first=None, t_last=None, t_end=time.perf_counter(),
                    headers=hdr)
    req = urllib.request.Request(
        url + "/v1/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    tokens, finish, t_first, t_last, done = [], None, None, None, False
    with urllib.request.urlopen(req, timeout=timeout) as r:
        hdr = r.headers
        for line in r:
            if not line.startswith(b"data: "):
                continue
            data = line[len(b"data: "):].strip()
            if data == b"[DONE]":
                done = True
                break
            chunk = json.loads(data)
            now = time.perf_counter()
            if chunk["llmd"]["tok"]:
                t_first = t_first or now
                t_last = now
            tokens += chunk["llmd"]["tok"]
            finish = chunk["choices"][0]["finish_reason"] or finish
    if not done:
        raise RuntimeError("completion: the stream ended before [DONE]")
    return dict(n=len(tokens), tokens=tokens, finish=finish, t_send=t_send,
                t_first=t_first, t_last=t_last, t_end=time.perf_counter(),
                headers=hdr)


def concurrently(url: str, bodies) -> list:
    """``completion`` of every body at once, one thread each."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(bodies)) as ex:
        return list(ex.map(lambda b: completion(url, b), bodies))


def serve_in_thread(server):
    """Start ``server`` (a ``ModelServer``) on a local socket, on an event
    loop in its own thread; returns ``(url, close)``."""
    import asyncio
    import threading
    loop = asyncio.new_event_loop()
    app = server.build_app()
    box = {}
    ready = threading.Event()

    def run():
        asyncio.set_event_loop(loop)
        try:
            box["port"] = loop.run_until_complete(app.start("127.0.0.1", 0))
        except BaseException as e:            # reported to the caller
            box["error"] = e
            ready.set()
            return
        ready.set()
        loop.run_forever()

    thread = threading.Thread(target=run, name="smoke-server", daemon=True)
    thread.start()
    if not ready.wait(120) or "error" in box:
        raise RuntimeError(f"the in-process server did not start: "
                           f"{box.get('error')}")

    def close():
        asyncio.run_coroutine_threadsafe(app.close(), loop).result(120)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(60)
        if thread.is_alive():
            raise RuntimeError("the in-process server did not stop")

    return f"http://127.0.0.1:{box['port']}", close


def start_server(root: str, argv, log_name: str, env=None):
    """``python -m llm_d_tpu_torch.server.openai`` with ``argv`` (its log
    in build/``log_name``; ``env`` added to the environment); returns the
    process."""
    log_path = os.path.join(root, "build", log_name)
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    with open(log_path, "wb") as log_f:
        return subprocess.Popen(
            [sys.executable, "-m", "llm_d_tpu_torch.server.openai", *argv],
            cwd=root, stdout=log_f, stderr=subprocess.STDOUT,
            env=dict(os.environ, LLMD_DRAIN_TIMEOUT_S=str(DRAIN_S),
                     **(env or {})))


def wait_ready(proc, url: str, limit_s: float = 300) -> float:
    t0 = time.perf_counter()
    while True:
        if proc.poll() is not None:
            raise RuntimeError(f"the server at {url} exited with "
                               f"{proc.returncode} before it was ready")
        if time.perf_counter() - t0 > limit_s:
            raise RuntimeError(f"the server at {url} was not ready in "
                               f"{limit_s} s")
        try:
            if http_call(url, "/v1/models", timeout=5)[0] == 200:
                return time.perf_counter() - t0
        except OSError:
            pass
        time.sleep(0.1)


def greedy_body(prompt, max_new: int, stream: bool) -> dict:
    return dict(prompt=prompt, max_tokens=max_new, temperature=0.0,
                ignore_eos=True, stream=stream)


def server_in_process(engine, prompts, max_new: int, alone, together):
    """Phase 7(a): ``ModelServer`` over ``engine`` (path (i)'s, already
    served and captured), the ``DecimalTokenizer`` as its tokenizer.
    ``prompts`` one at a time, streamed and not in turn: each reply must
    hold ``alone`` (the direct engine's tokens for that prompt alone);
    then all at once: each must end by length with ``max_new`` tokens,
    and the count of tokens equal to ``together`` (the direct engine's
    wave) is reported."""
    from llm_d_tpu_torch.server.openai import ModelServer
    server = ModelServer(engine, DecimalTokenizer(),
                         engine.model_config.name)
    url, close = serve_in_thread(server)
    try:
        got = [completion(url, greedy_body(p, max_new, bool(i % 2)))
               for i, p in enumerate(prompts)]
        bad = [i for i, (g, want) in enumerate(zip(got, alone))
               if g["tokens"] != want or g["finish"] != "length"]
        if bad:
            raise RuntimeError(f"server replies {bad} differ from the "
                               f"direct engine's tokens")
        conc = concurrently(url, [greedy_body(p, max_new, bool(i % 2))
                                  for i, p in enumerate(prompts)])
        for i, r in enumerate(conc):
            if r["finish"] != "length" or r["tokens"] is None \
                    or len(r["tokens"]) != max_new:
                raise RuntimeError(f"concurrent request {i}: {r['n']} "
                                   f"tokens, finish {r['finish']}")
        agree = sum(a == b for r, want in zip(conc, together)
                    for a, b in zip(r["tokens"], want))
        if server.async_engine.dead is not None:
            raise RuntimeError("the engine thread died") \
                from server.async_engine.dead
    finally:
        close()
    return dict(one_at_a_time=len(got), identical=True,
                concurrent=len(conc),
                concurrent_tokens_equal_to_the_wave=agree,
                concurrent_tokens=max_new * len(conc))


def scrape(url: str) -> dict:
    from llm_d_tpu_torch.utils.metrics import parse_prometheus_text
    status, _, text = http_call(url, "/metrics", timeout=60)
    if status != 200:
        raise RuntimeError(f"/metrics: HTTP {status}")
    return parse_prometheus_text(text)


def server_subprocess(root: str, vocab: int) -> dict:
    """Phase 7(b): ``python -m llm_d_tpu_torch.server.openai`` with the
    bench flags on a free port (its log in build/server.log, whose end is
    written to stderr if the phase fails).  Wave
    3's shape as concurrent requests (half streamed), a cold load and then
    a warm one, each with client-side TTFT, TPOT and decode tokens/s;
    ``/metrics`` against what was served (and scraped every 50 ms during
    the loads), then ``/admin/drain``, readiness 503, and SIGTERM: the
    process must exit 0 within the drain time."""
    import signal
    import threading
    import numpy as np
    from llm_d_tpu_torch.utils.lifecycle import DRAINING_HEADER
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    log_path = os.path.join(root, "build", "server.log")
    proc = start_server(root, [*SERVER_FLAGS, "--host", "127.0.0.1",
                               "--port", str(port)], "server.log")
    try:
        startup_s = wait_ready(proc, url)
        rng = np.random.default_rng(5)
        n, new = WAVE3["n"], WAVE3["new"]
        peak = dict(running=0.0, waiting=0.0, kv_usage=0.0)
        stop = threading.Event()

        def watch():
            while not stop.wait(0.05):
                m = scrape(url)
                peak["running"] = max(peak["running"],
                                      m["vllm:num_requests_running"])
                peak["waiting"] = max(peak["waiting"],
                                      m["vllm:num_requests_waiting"])
                peak["kv_usage"] = max(peak["kv_usage"],
                                       m["vllm:kv_cache_usage_perc"])

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        loads = {}
        try:
            # The cold load meets the process's first prefill step and
            # captures the decode graph; the warm one is the steady state.
            for name in ("cold", "warm"):
                bodies = [greedy_body(
                    rng.integers(1, vocab, WAVE3["prompt"]).tolist(), new,
                    i % 2 == 0) for i in range(n)]
                loads[name] = load_stats(concurrently(url, bodies), new,
                                         vocab)
        finally:
            stop.set()
            watcher.join(30)
        n *= len(loads)
        m = scrape(url)
        model = SERVER_FLAGS[SERVER_FLAGS.index("--model") + 1]
        lab = f'{{model_name="{model}"}}'
        counts = dict(
            generation_tokens=m["vllm:generation_tokens_total" + lab],
            request_success=m['vllm:request_success_total{finished_reason='
                              f'"length",model_name="{model}"}}'],
            ttft_count=m["vllm:time_to_first_token_seconds_count" + lab],
            itl_count=m["vllm:inter_token_latency_seconds_count" + lab],
            running=m["vllm:num_requests_running" + lab],
            waiting=m["vllm:num_requests_waiting" + lab],
            kv_usage=m["vllm:kv_cache_usage_perc" + lab])
        want = dict(generation_tokens=n * new, request_success=n,
                    ttft_count=n, running=0, waiting=0, kv_usage=0)
        wrong = {k: (counts[k], v) for k, v in want.items()
                 if counts[k] != v}
        if wrong or not n <= counts["itl_count"] <= n * (new - 1):
            raise RuntimeError(f"/metrics disagrees with what was served "
                               f"(got, want): {wrong}, itl_count "
                               f"{counts['itl_count']}")
        if not (0 < peak["running"] <= n and peak["kv_usage"] > 0):
            raise RuntimeError(f"load gauges during the load: {peak}")
        status, _, reply = http_call(url, "/admin/drain", {})
        if status != 200 or reply.get("status") != "draining":
            raise RuntimeError(f"/admin/drain: HTTP {status}: {reply}")
        status, headers, _ = http_call(url, "/v1/models")
        if status != 503 or headers.get(DRAINING_HEADER) != "1":
            raise RuntimeError(f"/v1/models while draining: HTTP {status}")
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=DRAIN_S + 60)
        exit_s = time.perf_counter() - t_term
        if rc != 0 or exit_s > DRAIN_S:
            raise RuntimeError(f"after SIGTERM the server exited with {rc} "
                               f"in {exit_s:.1f} s")
    except BaseException:
        with open(log_path, "rb") as log_f:
            sys.stderr.write(log_f.read()[-8000:].decode(errors="replace"))
        raise
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    # Each graph the server captured, with its cold cost (logged by
    # engine/cuda_graph.py).
    with open(log_path, errors="replace") as log_f:
        captures = [ln.split("captured graph ", 1)[1].strip()
                    for ln in log_f if "captured graph " in ln]
    return dict(startup_s=startup_s, requests=n, new_tokens=new, **loads,
                metrics=counts, load_peak=peak, drain_exit_code=rc,
                exit_s=exit_s, graph_captures=captures)


def load_stats(res, new: int, vocab: int) -> dict:
    """Client-side figures of one concurrent load (``completion`` results,
    ``new`` tokens each): TTFT and TPOT of the streamed requests, and
    decode tokens/s from the last first token to the last reply."""
    for i, r in enumerate(res):
        if r["finish"] != "length" or r["n"] != new or not all(
                0 <= t < vocab for t in r["tokens"] or ()):
            raise RuntimeError(f"request {i}: {r['n']} tokens, finish "
                               f"{r['finish']}")
    streamed = [r for r in res if r["t_first"] is not None]
    t_decode = (max(r["t_end"] for r in res)
                - max(r["t_first"] for r in streamed))
    return dict(
        streamed=len(streamed),
        ttft_s=spread([r["t_first"] - r["t_send"] for r in streamed]),
        tpot_s=spread([(r["t_last"] - r["t_first"]) / (new - 1)
                       for r in streamed]),
        decode_tok_s=len(res) * (new - 1) / t_decode,
        decode_seconds=t_decode)


# Phase 7(c): observability and resume, on path (i)'s engine and flags.
OBS_ROUNDS = 1                       # tracing on / off, a side, alternating
RESUME_AT = 8                        # the journal's length at the kill
RESUME_NEW = 3 * BENCH_K + 1         # the stream is mid-way at the kill
PHASE_COUNT = "llmd_tpu:request_phase_seconds_count{"


def phase_counts(m: dict) -> dict:
    """``request_phase_seconds`` sample counts by phase."""
    out = {}
    for k, v in m.items():
        if k.startswith(PHASE_COUNT):
            ph = k.split('phase="', 1)[1].split('"', 1)[0]
            out[ph] = out.get(ph, 0) + v
    return out


def debug_traces(url: str, drain: bool = False) -> dict:
    """``/debug/traces`` as ``{trace id: [span, ...]}``."""
    import urllib.request
    path = "/debug/traces" + ("?drain=1" if drain else "")
    with urllib.request.urlopen(url + path, timeout=60) as r:
        if r.status != 200:
            raise RuntimeError(f"{path}: HTTP {r.status}")
        text = r.read().decode()
    by = {}
    for ln in text.splitlines():
        if ln.strip():
            span = json.loads(ln)
            by.setdefault(span["trace"], []).append(span)
    return by


def check_trace(spans, fused: int) -> int:
    """One request's trace: one ``server.request`` root, no orphan, the
    engine's queue, prefill and decode spans under the root, and a decode
    block of ``fused`` steps among its step spans.  Returns its spans."""
    ids = {s["span"] for s in spans}
    roots = [s["name"] for s in spans if not s.get("parent")]
    orphans = [s["name"] for s in spans
               if s.get("parent") and s["parent"] not in ids]
    if roots != ["server.request"] or orphans:
        raise RuntimeError(f"trace not connected: roots {roots}, "
                           f"orphans {orphans}")
    root = next(s["span"] for s in spans if not s.get("parent"))
    phases = sorted(s["name"] for s in spans if s["parent"] == root
                    and s["name"] != "engine.step")
    if phases != ["engine.decode", "engine.prefill", "engine.queue"]:
        raise RuntimeError(f"phase spans under server.request: {phases}")
    if not any(s["name"] == "engine.step"
               and s.get("attrs", {}).get("kind") == "decode"
               and s["attrs"].get("fused") == fused for s in spans):
        raise RuntimeError(f"no {fused}-step decode block span in a trace")
    return len(spans)


def sse_stream(url: str, body: dict, headers=None, stop_after=None,
               on_frame=None):
    """One streamed /v1/completions call: the chunks' ``llmd`` metas and
    whether ``[DONE]`` came.  With ``stop_after`` the client hangs up once
    it holds that many tokens; ``on_frame(n)`` is called after the n-th
    token chunk."""
    import urllib.request
    req = urllib.request.Request(
        url + "/v1/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    metas, done, n = [], False, 0
    with urllib.request.urlopen(req, timeout=600) as r:
        for line in r:
            if not line.startswith(b"data: "):
                continue
            data = line[len(b"data: "):].strip()
            if data == b"[DONE]":
                done = True
                break
            metas.append(json.loads(data)["llmd"])
            n += len(metas[-1]["tok"])
            if on_frame is not None:
                on_frame(len(metas))
            if stop_after is not None and n >= stop_after:
                break
    return metas, done


def journal_of(metas, n: int):
    """The first ``n`` tokens of a stream and their metas, as a relay's
    journal holds them when the replica dies after delivering ``n``."""
    out, kept = [], []
    for m in metas:
        take = m["tok"][:n - len(out)]
        if take:
            kept.append(dict(off=m["off"], tok=take))
            out += take
    return out, kept


def refusal(argv) -> str:
    """The parser error ``check_served`` gives for ``argv`` (raises when
    it is served)."""
    import io
    from llm_d_tpu_torch.server import openai as srv
    p = srv.build_arg_parser()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        try:
            srv.check_served(p, p.parse_args(argv))
        except SystemExit as e:
            if e.code == 2:
                return err.getvalue().strip().splitlines()[-1]
            raise
    raise RuntimeError(f"{argv} is served here")


def importable(*names) -> bool:
    import importlib
    try:
        for n in names:
            importlib.import_module(n)
    except ImportError:
        return False
    return True


def sample_sidecar():
    """A standard-library ``/samples`` endpoint (the latency-training
    sidecar's): ``(url, samples received, server)``."""
    import http.server
    import threading
    got = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            body = json.loads(self.rfile.read(
                int(self.headers.get("Content-Length", 0))))
            if self.path == "/samples":
                got.extend(body if isinstance(body, list) else [body])
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"{}")

        def log_message(self, *args):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{srv.server_address[1]}", got, srv


def graph_replays(engine) -> int:
    """The engine's graph replays (0 for an engine that runs eagerly)."""
    return engine._graphs.replays if engine._graphs is not None else 0


def observe_server(engine, prompts, max_new: int, vocab: int) -> dict:
    """Phase 7(c)(a) and (d) on the in-process server over path (i)'s
    engine.  (a) ``prompts`` one at a time, tracing on and then off: the
    same tokens and graph replays, one phase sample per request and phase
    either way, and with tracing on one connected trace a request in
    ``/debug/traces``; then all at once in alternating rounds, decode
    tok/s on against off (reported).  (d) With the latency-training URL
    set to a local ``/samples`` endpoint, the prompts at once, not
    streamed: one ``ttft`` and one ``tpot`` sample a request, their
    ``actual_ms`` the replies' usage."""
    import math
    from concurrent.futures import ThreadPoolExecutor
    from llm_d_tpu_torch.server.openai import ModelServer
    server = ModelServer(engine, DecimalTokenizer(),
                         engine.model_config.name)
    url, close = serve_in_thread(server)
    out = {}
    try:
        debug_traces(url, drain=True)
        runs = {}
        for side in ("on", "off"):
            with env_set("LLMD_TRACE", "1" if side == "on" else "0"):
                m0, r0 = phase_counts(scrape(url)), graph_replays(engine)
                toks = [completion(url, greedy_body(p, max_new, bool(i % 2)))
                        ["tokens"] for i, p in enumerate(prompts)]
                m1 = phase_counts(scrape(url))
                runs[side] = dict(
                    tokens=toks, replays=graph_replays(engine) - r0,
                    phases={k: m1.get(k, 0) - m0.get(k, 0)
                            for k in ("queue", "prefill", "decode")})
            if side == "on":
                traces = debug_traces(url, drain=True)
        on, off = runs["on"], runs["off"]
        if on["tokens"] != off["tokens"] or on["replays"] != off["replays"]:
            raise RuntimeError(f"tracing changed the run: replays "
                               f"{on['replays']} on, {off['replays']} off")
        for side, run in runs.items():
            if set(run["phases"].values()) != {len(prompts)}:
                raise RuntimeError(f"phase samples (tracing {side}): "
                                   f"{run['phases']}")
        if len(traces) != len(prompts):
            raise RuntimeError(f"{len(traces)} traces for {len(prompts)} "
                               f"requests")
        spans = [check_trace(v, BENCH_K) for v in traces.values()]
        if debug_traces(url):
            raise RuntimeError("spans recorded with tracing off")
        tok_s = {"on": [], "off": []}
        for r in range(OBS_ROUNDS):
            for side in (("on", "off") if r % 2 == 0 else ("off", "on")):
                with env_set("LLMD_TRACE", "1" if side == "on" else "0"):
                    tok_s[side].append(load_stats(concurrently(url, [
                        greedy_body(p, max_new, i % 2 == 0)
                        for i, p in enumerate(prompts)]), max_new,
                        vocab)["decode_tok_s"])
        debug_traces(url, drain=True)
        out["tracing"] = dict(
            requests=len(prompts), replays=on["replays"],
            tokens_equal_off=True, phase_samples=on["phases"],
            spans_per_trace=spans,
            decode_tok_s={k: spread(v) for k, v in tok_s.items()},
            decode_tok_s_rounds=tok_s)
        # (d) the predictor's training feed
        feed_url, got, sidecar = sample_sidecar()
        server.latency_training_url = feed_url
        try:
            with ThreadPoolExecutor(len(prompts)) as ex:
                replies = list(ex.map(lambda p: http_call(
                    url, "/v1/completions", greedy_body(p, max_new, False)),
                    prompts))
            usage = [r[2]["usage"] for r in replies if r[0] == 200]
            t0 = time.perf_counter()
            while len(got) < 2 * len(prompts) \
                    and time.perf_counter() - t0 < 10:
                time.sleep(0.05)
        finally:
            server.latency_training_url = None
            sidecar.shutdown()
        by = {t: sorted(s["actual_ms"] for s in got if s["target"] == t)
              for t in ("ttft", "tpot")}
        want = {"ttft": sorted(u["ttft_ms"] for u in usage),
                "tpot": sorted(u["avg_tpot_ms"] for u in usage)}
        if len(usage) != len(prompts) or by != want or not all(
                math.isfinite(x) for v in by.values() for x in v):
            raise RuntimeError(f"training samples {by} != usage {want}")
        keys = sorted({tuple(sorted(s["features"])) for s in got})
        out["feed"] = dict(samples={t: len(v) for t, v in by.items()},
                           feature_keys=keys,
                           ttft_ms=spread(by["ttft"]),
                           tpot_ms=spread(by["tpot"]))
        if server.async_engine.dead is not None:
            raise RuntimeError("the engine thread died") \
                from server.async_engine.dead
    finally:
        close()
    return out


def observe_events(obs, prompts, vocab: int) -> dict:
    """Phase 7(c)(b): the port's ``InprocKvEventSink`` on the prefix-
    caching engine ``obs`` (path (v)(b)'s) into a collector.  After wave
    1's prompts the stored hashes must be the manager's cached blocks
    (each prompt's chain among them); after wave-3-shaped waves that evict
    them, the collector's live set (stores less removals) must still be
    the manager's cache, with one removal an eviction.  Where ``zmq`` and
    ``msgpack`` import, the same events must arrive through a
    ``ZmqKvEventPublisher`` on a SUB socket on 127.0.0.1; otherwise
    ``--kv-events-endpoint`` must be refused naming them."""
    import numpy as np
    from llm_d_tpu_torch.events.kv_events import (
        InprocKvEventSink, ZmqKvEventPublisher)

    class Collector:
        def __init__(self):
            self.events = []

        def on_event(self, pod, etype, hashes):
            self.events += [(etype, bytes(h)) for h in hashes]

    km = obs.kv_manager
    col = Collector()
    sink = InprocKvEventSink(col, "smoke:8200")
    hooks = (list(km.on_block_stored), list(km.on_block_removed))
    sink.attach(km)
    zmq_ok = importable("zmq", "msgpack")
    pub = sub = None
    if zmq_ok:
        import zmq
        sub = zmq.Context.instance().socket(zmq.SUB)
        port = sub.bind_to_random_port("tcp://127.0.0.1")
        sub.setsockopt(zmq.SUBSCRIBE, b"kv@")
        pub = ZmqKvEventPublisher(f"tcp://127.0.0.1:{port}", "smoke:8200",
                                  model="deepseek-v3-bench")
        pub.attach(km)
        pub.start()
        # A socket takes in new peers (and a SUB forwards its subscription
        # to them) inside its own calls: poll while the publisher joins.
        for _ in range(10):
            sub.poll(50)
    out = {}
    try:
        ev0 = km.eviction_count
        run_wave(obs, prompts, WAVE1["new"], "ev")
        stored = [h for e, h in col.events if e == "BlockStored"]
        chains = {h for p in prompts for h in chain_hashes(obs, p)}
        if set(stored) != set(km._cached) or not chains <= set(stored):
            raise RuntimeError("stored events differ from the cached blocks")
        out["stored_wave1"] = len(stored)
        rng = np.random.default_rng(41)
        waves = 0
        while km.eviction_count == ev0 and waves < 4:
            run_wave(obs, prompts_for(rng, vocab, WAVE3), WAVE3["new"],
                     f"ev{waves}")
            waves += 1
        live = set()
        for etype, h in col.events:
            (live.add if etype == "BlockStored" else live.discard)(h)
        removed = sum(e == "BlockRemoved" for e, _ in col.events)
        if km.eviction_count == ev0 or live != set(km._cached) \
                or removed != km.eviction_count - ev0:
            raise RuntimeError(f"after {waves} waves: {removed} removals, "
                               f"{km.eviction_count - ev0} evictions, live "
                               f"set == cache: {live == set(km._cached)}")
        out.update(events=len(col.events), removed=removed,
                   evicted_wave1_blocks=len(chains - set(km._cached)),
                   eviction_waves=waves)
        if zmq_ok:
            import msgpack
            import zmq
            got, quiet = [], time.perf_counter()
            while time.perf_counter() - quiet < 1.0:
                if sub.poll(100):
                    _, payload = sub.recv_multipart()
                    for ev in msgpack.unpackb(payload)["events"]:
                        got += [(ev["type"], bytes(h))
                                for h in ev["block_hashes"]]
                    quiet = time.perf_counter()
            if got != col.events:
                raise RuntimeError(f"zmq delivered {len(got)} events, the "
                                   f"sink {len(col.events)}")
            out["zmq"] = dict(events=len(got))
        else:
            msg = refusal(["--kv-events-endpoint", "tcp://127.0.0.1:5557"])
            if "--kv-events-endpoint" not in msg or not any(
                    m in msg for m in ("zmq", "msgpack")):
                raise RuntimeError(f"refusal does not name it: {msg}")
            out["zmq"] = dict(missing=[m for m in ("zmq", "msgpack")
                                       if not importable(m)], refused=msg)
    finally:
        km.on_block_stored[:], km.on_block_removed[:] = hooks
        if pub is not None:
            pub.stop()
            sub.close(0)
    return out


def observe_restore(obs, prompt) -> dict:
    """Phase 7(c)(c), in process: the in-process server over ``obs`` (the
    host tier on).  A stream of ``prompt`` is dropped by its client after
    ``RESUME_AT`` tokens; once its blocks are in the host tier and out of
    the device cache, the stream is resumed at that offset: its first
    chunk must say ``restored`` with restored tokens > 0, and journal and
    continuation must be continuous.  Reports the restores' host ms."""
    from llm_d_tpu_torch.server.openai import ModelServer
    from llm_d_tpu_torch.server.stream_resume import (
        OUTCOME_RESTORED, verify_continuity)
    from llm_d_tpu_torch.utils.lifecycle import RESUME_OFFSET_HEADER
    server = ModelServer(obs, DecimalTokenizer(), "deepseek-v3-bench")
    url, close = serve_in_thread(server)
    km, tier = obs.kv_manager, obs.host_tier
    real, restore_s = km.secondary_lookup, []
    try:
        body = greedy_body(prompt, RESUME_NEW, True)
        metas, _ = sse_stream(url, body, stop_after=RESUME_AT)
        journal, kept = journal_of(metas, RESUME_AT)
        t0 = time.perf_counter()
        while obs.has_work() or server.async_engine._streams:
            if time.perf_counter() - t0 > 60:
                raise RuntimeError("the dropped stream was not aborted")
            time.sleep(0.05)
        tier.flush()
        tier.complete(wait=True)
        hashes = chain_hashes(obs, prompt + journal)
        if any(h not in tier._store for h in hashes):
            raise RuntimeError("the stream's blocks are not in the host tier")
        dropped = 0
        for h in hashes:
            b = km.lookup_hash(h)
            if b is not None:
                km.uncache_block(b)
                dropped += 1

        def restore(h, protected=frozenset(), region=0):
            t = time.perf_counter()
            b = real(h, protected, region)
            if b is not None:
                restore_s.append(time.perf_counter() - t)
            return b

        km.secondary_lookup = restore
        resumed, done = sse_stream(
            url, dict(body, resume={"offset": RESUME_AT,
                                    "token_ids": journal}),
            headers={RESUME_OFFSET_HEADER: str(RESUME_AT)})
    finally:
        km.secondary_lookup = real
        close()
    problems = verify_continuity(kept + resumed, RESUME_NEW)
    first = resumed[0] if resumed else {}
    if not done or problems or first.get("src") != OUTCOME_RESTORED \
            or not first.get("restored"):
        raise RuntimeError(f"host-tier resume: done {done}, {problems}, "
                           f"first meta {first}")
    return dict(prompt_tokens=len(prompt), offset=RESUME_AT,
                device_blocks_dropped=dropped, restored_blocks=len(restore_s),
                restored_tokens=first["restored"], src=first["src"],
                restore_host_ms=[x * 1e3 for x in restore_s],
                restore_total_ms=sum(restore_s) * 1e3)


def resume_pair(root: str, prompt, yardstick) -> dict:
    """Phase 7(c)(c) and (e) across processes: two servers with path
    (i)'s flags; the second from ``--config`` + ``--config-overlay``
    files where ``yaml`` imports (the overlay sets its port, so serving
    there shows the merge), else with ``--config`` checked refused by
    name.  A stream of ``prompt`` from the first is cut after
    ``RESUME_AT`` tokens by a SIGKILL of that server and re-posted to the
    second with ``resume`` and the offset header: journal and
    continuation must be continuous and the first resumed chunk must
    carry ``src``.  The tokens are held against an uninterrupted run on
    the second server (reported beside ``yardstick``, the classic loop's
    tokens and top-2 margins for ``prompt``)."""
    import signal
    from llm_d_tpu_torch.server.stream_resume import verify_continuity
    from llm_d_tpu_torch.utils.lifecycle import RESUME_OFFSET_HEADER
    ports = [free_port(), free_port()]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    out = {}
    layered = importable("yaml")
    if layered:
        base = os.path.join(root, "build", "smoke_base.yaml")
        over = os.path.join(root, "build", "smoke_overlay.yaml")
        os.makedirs(os.path.dirname(base), exist_ok=True)
        flags = [*SERVER_FLAGS, "--host", "127.0.0.1", "--port", "1"]
        with open(base, "w") as f:
            i = 0
            while i < len(flags):
                # "--name value" -> "name: value"; a switch -> "name: true".
                value = flags[i + 1] if i + 1 < len(flags) \
                    and not flags[i + 1].startswith("--") else None
                f.write(f"{flags[i][2:]}: "
                        f"{'true' if value is None else value}\n")
                i += 1 if value is None else 2
        with open(over, "w") as f:
            f.write(f"port: {ports[1]}\n")
        argv_b = ["--config", base, "--config-overlay", over]
    else:
        argv_b = [*SERVER_FLAGS, "--host", "127.0.0.1", "--port",
                  str(ports[1])]
        msg = refusal(["--config", "layers.yaml"])
        if "--config" not in msg or "yaml" not in msg:
            raise RuntimeError(f"refusal does not name it: {msg}")
        out["yaml"] = dict(missing=True, refused=msg)
    procs = [start_server(root, [*SERVER_FLAGS, "--host", "127.0.0.1",
                                 "--port", str(ports[0])], "resume_a.log"),
             start_server(root, argv_b, "resume_b.log")]
    try:
        out["startup_s"] = [wait_ready(p, u) for p, u in zip(procs, urls)]
        if layered:
            out["yaml"] = dict(missing=False, served_on_overlay_port=True)
        body = greedy_body(prompt, RESUME_NEW, True)
        metas, _ = sse_stream(urls[0], body, stop_after=RESUME_AT)
        procs[0].send_signal(signal.SIGKILL)
        procs[0].wait(timeout=60)
        journal, kept = journal_of(metas, RESUME_AT)
        t0 = time.perf_counter()
        resumed, done = sse_stream(
            urls[1], dict(body, resume={"offset": RESUME_AT,
                                        "token_ids": journal}),
            headers={RESUME_OFFSET_HEADER: str(RESUME_AT)})
        resume_s = time.perf_counter() - t0
        problems = verify_continuity(kept + resumed, RESUME_NEW)
        if not done or problems or "src" not in resumed[0]:
            raise RuntimeError(f"resume across servers: done {done}, "
                               f"{problems}, first meta {resumed[0]}")
        tokens = journal + [t for m in resumed for t in m["tok"]]
        whole = completion(urls[1], body)["tokens"]
        ref, _, margins, bars = yardstick
        out.update(
            killed_rc=procs[0].returncode, offset=RESUME_AT,
            new_tokens=RESUME_NEW, src=resumed[0]["src"],
            restored_tokens=resumed[0].get("restored", 0),
            resume_request_s=resume_s,
            tokens_equal_uninterrupted=sum(a == b for a, b in
                                           zip(tokens, whole)),
            uninterrupted_equal_classic=whole == ref[0],
            vs_uninterrupted=divergence([tokens], [whole], margins, bars),
            vs_classic=divergence([tokens], ref, margins, bars))
        procs[1].send_signal(signal.SIGTERM)
        out["exit_code"] = procs[1].wait(timeout=DRAIN_S + 60)
        if out["exit_code"] != 0:
            raise RuntimeError(f"the resume server exited with "
                               f"{out['exit_code']}")
    except BaseException:
        for name in ("resume_a.log", "resume_b.log"):
            with open(os.path.join(root, "build", name), "rb") as log_f:
                sys.stderr.write(log_f.read()[-4000:].decode(
                    errors="replace"))
        raise
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
    return out


# Path (vii): MoE with GQA attention.  qwen3-30b-a3b at full width with
# its depth cut to GQA_MOE_LAYERS of 48 for the smoke's time limit (all 48,
# 29.0 GB of int8 experts, fit the card but take 137-150 s of smoke), and
# mixtral-8x22b at full width with its depth cut: 56 layers of int8
# experts (135 GB) cannot fit one card.
GQA_MOE_MODEL = "qwen3-30b-a3b"
GQA_MOE_LAYERS = 8
GQA_MOE_ROUNDS = 1                           # classic vs multistep, a side
WITNESS_MODEL = "mixtral-8x22b"
WITNESS_LAYERS = 2
GQA_MOE_KERNELS = ("moe_dense_int8", "moe_routed_int8", "moe_streamed_int8",
                   "paged_decode", "flash_prefill")


def gqa_moe_config(name: str):
    """The model config path (vii) serves: ``name``'s preset cut to
    ``GQA_MOE_LAYERS`` layers, the witness to ``WITNESS_LAYERS``."""
    import dataclasses
    from llm_d_tpu_torch.models.config import get_config
    mc = get_config(name)
    layers = WITNESS_LAYERS if name == WITNESS_MODEL else GQA_MOE_LAYERS
    return dataclasses.replace(mc, num_layers=layers)


def gqa_moe_label(name: str, tag: str):
    """Recorder label of path (vii)'s launches: the MoE kernels by token
    count, H by its query batch, G by its first launch."""
    if name in ("moe_dense_int8", "moe_routed_int8", "moe_streamed_int8"):
        return lambda a, kw: f"{tag} T={a[0].shape[0]}"
    if name == "flash_prefill":
        return lambda a, kw: f"{tag} S={a[0].shape[0]} Q={a[0].shape[1]}"
    return lambda a, kw: f"{tag} first"


def replayed_launches(engine) -> dict:
    """Kernel launches inside ``engine``'s graph replays so far, by
    wrapper name."""
    return dict(engine._graphs.launches)


def head_ms(engine, rows: int) -> dict:
    """``compute_logits`` on ``rows`` hidden rows (f32 operands: its f32
    copy of the head on every call) against one bf16 matmul of the same
    head, event-timed."""
    import torch
    mc, params = engine.model_config, engine.params
    g = torch.Generator(device=engine.device).manual_seed(rows)
    h = torch.randn((rows, mc.hidden_size), generator=g,
                    device=engine.device).bfloat16()
    head = params.get("lm_head")
    head = params["embed"].T if head is None else head
    return dict(rows=rows, head_shape=list(head.shape),
                f32_copy_bytes=head.numel() * 4,
                compute_logits_ms=time_ms(lambda: engine.model.compute_logits(
                    params, h, mc), iters=10),
                bf16_matmul_ms=time_ms(lambda: torch.matmul(h, head),
                                       iters=10))


def profile_gqa_moe(engine, p1, p2, p3) -> dict:
    """``--profile`` of path (vii): one 32-step block of wave 1 and of
    wave 2 (one graph replay each) and the 8192-token prefill step of
    wave 3."""
    out = {"blocks": profile_blocks(engine, {"wave1": p1, "wave2": p2})}
    add_requests(engine, p3, "profgp", 2)
    out["prefill"] = dict(_profile_steps(engine, 1),
                          tokens=sum(map(len, p3)))
    while engine.has_work():
        engine.step()
    return out


def gqa_moe_path(name: str, kernels, check, smi: str, witness: bool,
                 prof) -> tuple:
    """Path (vii) on ``name`` (``gqa_moe_config``), random weights from
    seed 0, through path (i)'s configuration (int8 experts, int8 cache
    with per-token scales, block size 64, 8192-token steps, 32-step decode
    blocks under async scheduling, 576 blocks).  Waves 1, 2 (not on the
    witness) and 3, then wave 1 again (must repeat); every decode in
    32-step blocks; G, H, C, E and (but on the witness) D launch, G and C
    (and D) inside graph replays.  Not on the witness: the classic loop
    on the same weights in ``GQA_MOE_ROUNDS`` alternating rounds (tokens
    identical), the in-process server (wave 1 one at a time, each reply
    the direct engine's tokens for that prompt alone) and the head's
    time.  Then the first two layers against the CPU reference, and the
    kernels against their plain versions (``check``) at the path's
    recorded inputs (on the witness D from a seed).  The path's own
    recorders wrap the kernel wrappers while it runs.  Returns (result,
    launches, launches inside graph replays) by kernel name."""
    import dataclasses
    import numpy as np
    import torch
    from llm_d_tpu_torch.ops import moe as moe_ops
    tag = "witness" if witness else "vii"
    mc = gqa_moe_config(name)
    t_path = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = path_i_engine(BENCH_K, model=name, model_config=mc)
    torch.cuda.synchronize()
    total = torch.cuda.get_device_properties(0).total_memory
    out = dict(card=smi, model=name, layers=mc.num_layers,
               init_s=time.perf_counter() - t0,
               num_blocks=engine.config.num_blocks,
               build=dict(
                   before_gib=before / 2**30,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   peak_over_before_gib=(torch.cuda.max_memory_allocated()
                                         - before) / 2**30,
                   held_gib=(torch.cuda.memory_allocated() - before)
                   / 2**30, card_gib=total / 2**30))
    from llm_d_tpu_torch.models.config import get_config
    out["reduced"] = (f"num_layers {get_config(name).num_layers} -> "
                      f"{mc.num_layers}: " + (
                          "one card cannot hold the int8 experts of every "
                          "layer" if witness else "the smoke's time limit"))
    log(f"path (vii) {name}: build {json.dumps(out['build'])}")
    if torch.cuda.max_memory_allocated() >= total:
        raise RuntimeError(f"{name}: the build's peak exceeds the card")
    note_live_tokens(engine)
    keep = tensor_ptrs(engine.params)
    mine = [k for k in kernels if k["name"] in GQA_MOE_KERNELS]
    recs = {k["name"]: Recorder(k["mod"], k["fn"], keep,
                                gqa_moe_label(k["name"], tag))
            for k in mine}

    def install(on: bool):
        for r in recs.values():
            setattr(r.module, r.name, r.wrapped if on else r.fn)

    rng = np.random.default_rng(7)
    vocab = mc.vocab_size
    p1 = prompts_for(rng, vocab, WAVE1)
    p2 = prompts_for(rng, vocab, WAVE2)
    p3 = prompts_for(rng, vocab, WAVE3)
    waves = {}
    t1 = time.perf_counter()
    tok1, waves["wave1"] = run_wave(engine, p1, WAVE1["new"], f"{tag}w1")
    if not witness:
        _, waves["wave2"] = run_wave(engine, p2, WAVE2["new"], f"{tag}w2")
    _, waves["wave3"] = run_wave(engine, p3, WAVE3["new"], f"{tag}w3")
    tok1b, waves["wave1_repeat"] = run_wave(engine, p1, WAVE1["new"],
                                            f"{tag}w1b")
    for w, st in waves.items():
        check_multistep(st, f"{name} {w}")
        log(f"path (vii) {name} {w}: {json.dumps(st)}")
    if tok1b != tok1:
        raise RuntimeError(f"{name}: wave 1 did not repeat token for token")
    out["waves"] = waves
    out["waves_s"] = time.perf_counter() - t1
    install(False)
    replayed = replayed_launches(engine)
    if not witness:
        # The direct engine's tokens of each wave-1 prompt alone (the
        # server's yardstick, not the path's run), then the server's run.
        t1 = time.perf_counter()
        alone = [run_wave(engine, [p], WAVE1["new"], f"{tag}alone{i}")[0][0]
                 for i, p in enumerate(p1)]
        yard = {f: n - replayed[f]
                for f, n in replayed_launches(engine).items()}
        install(True)
        out["server"] = server_in_process(engine, p1, WAVE1["new"], alone,
                                          tok1)
        install(False)
        replayed = {f: n - yard[f]
                    for f, n in replayed_launches(engine).items()}
        out["server"]["seconds"] = time.perf_counter() - t1
    counts = {k["name"]: recs[k["name"]].wrapped.launches
              + replayed[k["fn"]] for k in mine}
    in_graphs = {k["name"]: replayed[k["fn"]] for k in mine}
    out.update(launches=counts, graph_launches=in_graphs,
               graphs=graph_costs(engine))
    log(f"launches (vii) {name}: {json.dumps(counts)}, inside graph "
        f"replays: {json.dumps(in_graphs)}")
    need = [n for n in GQA_MOE_KERNELS
            if not (witness and n == "moe_routed_int8")]
    missing = [n for n in need if counts[n] == 0]
    missing += [f"{n} (graphs)" for n in ("paged_decode", "moe_dense_int8")
                + (() if witness else ("moe_routed_int8",))
                if in_graphs[n] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on path (vii) {name}: "
                           f"{missing}")
    if not witness:
        t1 = time.perf_counter()
        classic = path_i_engine(1, engine.params, model=name,
                                model_config=mc)
        note_live_tokens(classic)
        out["classic_vs_multistep"] = classic_rounds(classic, engine, {
            "wave1": (WAVE1, p1), "wave2": (WAVE2, p2),
            "wave3": (WAVE3, p3)}, GQA_MOE_ROUNDS)
        log(f"path (vii) {name} classic vs multistep: "
            f"{json.dumps(out['classic_vs_multistep'])}")
        del classic
        out["rounds_s"] = time.perf_counter() - t1
        out["head"] = [head_ms(engine, n) for n in (8, 128)]
        log(f"path (vii) {name} head: {json.dumps(out['head'])}")
        if prof is not None:
            prof[f"vii {name}"] = profile_gqa_moe(engine, p1, p2, p3)
            log(f"profile (vii) {name}: "
                f"{json.dumps(prof[f'vii {name}'])}")
    # The first two layers against the CPU reference.
    mc2 = dataclasses.replace(mc, num_layers=2, max_model_len=1152)
    Ld = min(mc.first_dense_layers, 2)
    params2 = dict(engine.params)
    params2["dense_layers"] = {k: v[:Ld] for k, v in
                               engine.params["dense_layers"].items()}
    params2["moe_layers"] = {k: v[:2 - Ld] for k, v in
                             engine.params["moe_layers"].items()}
    moe_kw = dict(quantization="int8", kv_cache_dtype="int8", block_size=64,
                  num_blocks=24, max_num_seqs=8,
                  max_num_batched_tokens=1024, enable_prefix_caching=False)
    t1 = time.perf_counter()
    checks = (([100, 37], 27),) if witness else (([100, 37], 27),
                                                 ([1024], 28))
    out["reference"] = [reference_check(mc2, params2, moe_kw, lens, seed,
                                        card_routing=True)
                        for lens, seed in checks]
    out["reference_s"] = time.perf_counter() - t1
    for ref in out["reference"]:
        log(f"reference: {json.dumps(ref)}")
        if not ref["top1_agree"] or ref["rel_max_err"] > 5e-2:
            raise RuntimeError(f"kernel path disagrees with the CPU "
                               f"reference: {ref}")
    del params2
    # The kernels against their plain versions at the path's inputs.
    t1 = time.perf_counter()
    checked = []
    for k in mine:
        rec = recs[k["name"]]
        for label, (args, kw) in rec.calls.items():
            check(k, label, args, kw, count=False,
                  live_tokens=rec.notes[label], keep=keep)
            checked.append(label)
        rec.calls.clear()
    if witness:
        k = next(kk for kk in mine if kk["name"] == "moe_routed_int8")
        quant = {n: engine.params["moe_layers"][n] for n in
                 ("w_gate_q", "w_gate_s", "w_up_q", "w_up_s", "w_down_q",
                  "w_down_s")}
        quant["layer"] = 0
        x, w, idx = moe_inputs(mc, 256, seed=256)
        with capture(k["mod"], k["fn"]) as seen:
            moe_ops._routed_int8_kernel_path(x, w, idx, quant)
        check(k, f"{tag} T=256 (from a seed)", *seen[0], count=False,
              keep=keep)
        checked.append(f"{tag} T=256 (from a seed)")
        del quant, x, w, idx, seen
    out.update(kernel_checks=checked,
               kernel_checks_s=time.perf_counter() - t1)
    del engine, recs, rec
    LIVE_TOKENS[0] = None
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_path
    return out, counts, in_graphs


@contextlib.contextmanager
def env_set(name: str, value: str):
    """Sets environment variable ``name`` inside the block."""
    prev = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if prev is None:
            del os.environ[name]
        else:
            os.environ[name] = prev


@contextlib.contextmanager
def bench_glue_recorder(moe_ops):
    """Keeps (in the dict it yields, under "args") the glue inputs of the
    first ``BENCH_T``-token streamed MoE call inside the block."""
    got = {}
    real = moe_ops._streamed_int8_kernel_path

    def glue(x, weights_, idx, quant, **kw):
        if x.shape[0] == BENCH_T and not got:
            got["args"] = (x.clone(), weights_.clone(), idx.clone(), quant)
        return real(x, weights_, idx, quant, **kw)

    moe_ops._streamed_int8_kernel_path = glue
    try:
        yield got
    finally:
        moe_ops._streamed_int8_kernel_path = real


def bench_step_as_one_chunk(moe_ops, moe_routed_stream, glue_args):
    """Kernel E's inputs for the recorded 8192-token MoE step laid out as
    one chunk of ``BENCH_T`` rows."""
    with capture(moe_routed_stream, "streamed_moe_int8") as seen:
        moe_ops._streamed_int8_kernel_path(*glue_args, chunk_t=BENCH_T)
    return seen[0]

# Phase 9, path (viii): tensor and expert parallelism.  deepseek-v3-bench
# at tp = ep = 4 in path (i)'s configuration but classic steps, as four
# rank processes of one mesh on the one card: NCCL refuses two ranks on a
# GPU, so the ranks talk over gloo, each collective staged through host
# memory, and gloo collectives cannot be captured in a CUDA graph.  The
# witness: qwen3-30b-a3b at tp = ep = 4.
MESH_TP = 4
# The ranks of phases 9 and 10 (one pool).
MESH_WORLD = 4
MESH_MODEL = "deepseek-v3-bench"
MESH_WITNESS = "qwen3-30b-a3b"
# The witness's depth, cut for the smoke's time limit (48 layers at
# tp = 4 over gloo take ~125 s for wave 1 and the prefill).
MESH_WITNESS_LAYERS = 2
# New tokens of wave 1 on the meshes (phases 9-11, the witness, and
# their one-rank yardstick), cut from wave 1's 32 for the time limit (16
# before phase 12); and the prompts each mesh server serves one at a time
# (wave 1's first).
MESH_W1_NEW = 8
MESH_SERVER_PROMPTS = 2
# Phase 11's servers (the recipe's) and their direct yardstick (cut from 4
# for the time limit).
WIDE_SERVER_PROMPTS = 2
# New tokens of the waves on the bf16 wire and the psum dispatch, of
# wave 3 on the mesh, and of each request the tp server serves alone.
MESH_SIDE_NEW = 2
MESH_W3_NEW = 2
MESH_SERVER_NEW = 2
MESH_KERNELS = ("mla_decode", "mla_prefill", "moe_streamed_int8")
MESH_WITNESS_KERNELS = ("paged_decode", "flash_prefill", "moe_streamed_int8")
# Path (i)'s server flags less the captured blocks (refused on gloo).
MESH_SERVER_FLAGS = SERVER_FLAGS[:SERVER_FLAGS.index("--num-scheduler-steps")]
# The wrapper each kernel of the mesh paths launches through, and its
# plain version: (module, wrapper, plain).
MESH_WRAPPERS = {
    "mla_decode": ("mla_decode", "mla_paged_decode_update",
                   "mla_paged_decode_update_plain"),
    "mla_prefill": ("mla_prefill", "mla_flash_prefill",
                    "mla_flash_prefill_plain"),
    "moe_streamed_int8": ("moe_routed_stream", "streamed_moe_int8",
                          "streamed_moe_int8_plain"),
    "moe_dense_int8": ("moe_int8", "dense_moe_int8", "dense_moe_int8_plain"),
    "moe_routed_int8": ("moe_routed", "routed_moe_int8",
                        "routed_moe_int8_plain"),
    "paged_decode": ("paged_attention", "paged_attention_decode_update",
                     "paged_attention_decode_update_plain"),
    "flash_prefill": ("flash_prefill", "flash_prefill_paged",
                      "flash_prefill_paged_plain"),
}
# A rank's engine and recorders between the pool's calls.
MESH_STATE = {}


def _mesh_module(name: str):
    import importlib
    return importlib.import_module(f"llm_d_tpu_torch.ops.{name}")


def _mesh_launches(names) -> dict:
    return {n: getattr(_mesh_module(MESH_WRAPPERS[n][0]),
                       MESH_WRAPPERS[n][1]).launches for n in names}


def _mesh_reset(names) -> None:
    for n in names:
        getattr(_mesh_module(MESH_WRAPPERS[n][0]),
                MESH_WRAPPERS[n][1]).launches = 0


def mesh_config(model: str, layers=None):
    import dataclasses
    from llm_d_tpu_torch.models.config import get_config
    mc = get_config(model)
    if layers is not None:
        mc = dataclasses.replace(mc, num_layers=layers,
                                 max_model_len=min(mc.max_model_len, 1152))
    return mc


def mesh_setup(model: str, names, layers=None, record: bool = True,
               path: str = "viii", **over) -> dict:
    """Rank side: this rank's engine of ``model`` on the mesh (its
    shards of seed 0's draws, path (i)'s configuration in classic steps;
    ``over`` replaces fields, the mesh among them), kept for the calls
    that follow; rank 0 records the first inputs of each kernel label
    (labelled by ``path``).  Returns the build's seconds and memory, the
    rank's cache planes and its routed-expert bytes."""
    import torch
    from llm_d_tpu_torch.parallel.mesh import MeshConfig
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mc = mesh_config(model, layers)
    kw = dict(model=model, model_config=mc, device=None,
              mesh=MeshConfig(tp=MESH_TP))
    kw.update(over)
    eng = path_i_engine(1, **kw)
    torch.cuda.synchronize()
    ml = eng.params.get("moe_layers", {})
    out = dict(rank=eng.mesh.rank, coord=eng.mesh.coord,
               backend=eng.mesh.backend,
               staged_through_host=eng.mesh.stage_host,
               device=str(eng.device), init_s=time.perf_counter() - t0,
               held_gib=torch.cuda.memory_allocated(eng.device) / 2**30,
               collective_wire=eng._collective_wire,
               kv_planes={k: list(v.shape) for k, v in eng.kv_cache.items()},
               pool_slots=eng.config.num_blocks * eng.config.block_size,
               expert_bytes=sum(v.numel() * v.element_size()
                                for k, v in ml.items()
                                if k.startswith(("w_gate", "w_up",
                                                 "w_down"))))
    MESH_STATE.clear()
    MESH_STATE.update(engine=eng, names=tuple(names), recs={})
    if eng.mesh.rank == 0 and record:
        mesh_record([eng], names, path)
    return out


def mesh_label(name: str, path="viii"):
    """Recorder label of a mesh path's launches: E by its received rows,
    A and G by their sequences, B and H by sequences and query rows;
    ``path`` is the label's prefix, or a function that returns it at the
    launch."""
    tag = path if callable(path) else (lambda: path)
    if name.startswith("moe_"):
        return lambda a, kw: f"{tag()} rows={a[0].shape[0]}"
    if name in ("mla_prefill", "flash_prefill"):
        return lambda a, kw: f"{tag()} S={a[0].shape[0]} Q={a[0].shape[1]}"
    return lambda a, kw: f"{tag()} S={a[0].shape[0]}"


def mesh_record(engines, names, path) -> None:
    """Rank 0: record the first inputs of each kernel label of ``names``
    (``mesh_label``) the ``engines`` launch, their weights shared, for
    ``mesh_kernel_checks``."""
    keep = frozenset().union(*(tensor_ptrs(e.params) for e in engines))
    MESH_STATE["keep"] = keep
    for n in names:
        mod, fn, _ = MESH_WRAPPERS[n]
        MESH_STATE["recs"][n] = Recorder(_mesh_module(mod), fn, keep,
                                         mesh_label(n, path))


def mesh_wave(tag: str, prompts, new: int, env=None, tape: bool = False
              ) -> dict:
    """Rank side: rank 0 serves ``prompts`` (``new`` greedy tokens each)
    on the mesh and the other ranks follow, every rank under ``env``;
    each kernel's launches on this rank are counted from 0.  With
    ``tape`` the first tp rank of each dp shard (rank 0 alone at dp = 1)
    tapes its shard's MoE expert choice (``routing_tape``)."""
    import torch
    eng, names = MESH_STATE["engine"], MESH_STATE["names"]
    _mesh_reset(names)
    wire0 = dict(eng.mesh.wire_bytes)
    with contextlib.ExitStack() as stack:
        for k, v in (env or {}).items():
            stack.enter_context(env_set(k, v))
        taped = None
        if tape and eng.mesh.coord["tp"] == 0:
            taped = {}
            stack.enter_context(routing_tape(eng, taped, replay=False))
        if eng.mesh.rank != 0:
            tokens = eng.follow()
            tokens = [tokens[f"{tag}-{i}"] for i in range(len(prompts))]
            stats = None
        else:
            tokens, stats = run_wave(eng, prompts, new, tag)
            eng.stop_mesh()
    torch.cuda.synchronize()
    # A recorder installed on rank 0 holds its kernel's count.
    launches = _mesh_launches(names)
    return dict(tokens=tokens, stats=stats, launches=launches, tape=taped,
                wire_bytes={k: v - wire0.get(k, 0)
                            for k, v in eng.mesh.wire_bytes.items()},
                peak_gib=torch.cuda.max_memory_allocated(eng.device) / 2**30)


def mesh_alone(prompts, new: int) -> list:
    """Rank side: rank 0 serves each of ``prompts`` alone (``new`` greedy
    tokens), the other ranks follow; the tokens of each."""
    eng = MESH_STATE["engine"]
    if eng.mesh.rank != 0:
        got = eng.follow()
        return [got[f"alone{i}-0"] for i in range(len(prompts))]
    out = [run_wave(eng, [p], new, f"alone{i}")[0][0]
           for i, p in enumerate(prompts)]
    eng.stop_mesh()
    return out


def mesh_wires(T: int, seed: int) -> dict:
    """Rank side: one MoE layer of the engine (its first, int8 experts)
    on rows and routing from ``seed`` through the a2a dispatch on the
    int8, int8-dispatch and bf16 wires and the psum dispatch on the bf16
    and int8 wires: every output against a2a on the bf16 wire, rel-RMS
    (the JAX harness's bound: 2% per collective).  The same on every
    rank."""
    import torch
    from llm_d_tpu_torch.ops import moe as moe_ops
    eng = MESH_STATE["engine"]
    x, w, idx = moe_inputs(eng.model_config, T, seed=seed)
    quant = {n: eng.params["moe_layers"][n] for n in
             ("w_gate_q", "w_gate_s", "w_up_q", "w_up_s", "w_down_q",
              "w_down_s")}
    quant["layer"] = 0
    outs = {}
    for dispatch, wire in (("a2a", "bf16"), ("a2a", "int8"),
                           ("a2a", "int8-dispatch"), ("psum", "bf16"),
                           ("psum", "int8")):
        outs[f"{dispatch} {wire}"] = moe_ops.expert_ffn(
            x, w, idx, None, None, None, quant=quant, mesh=eng.mesh,
            dispatch=dispatch, collective_dtype=wire).float()
    ref = outs["a2a bf16"]
    rms = float(ref.pow(2).mean().sqrt()) + 1e-12
    return {k: float((v - ref).pow(2).mean().sqrt()) / rms
            for k, v in outs.items() if k != "a2a bf16"}


def mesh_kernel_checks(notes: bool = False) -> list:
    """Rank side (rank 0): each recorded kernel input (rank-local shapes)
    against the kernel's plain version with phase 4's tolerances, timed
    (eager ms, device ms, the plain version's ms), with its bound from
    ``work``; G and H also as one SDPA call on the dequantized K/V.  E's
    live work is its received rows with a nonzero combine weight (the
    fixed-region layout's empty region tails go to expert 0 with weight
    0); with ``notes`` (one engine, no mesh) an MoE kernel's is the step's
    live tokens (``note_live_tokens``), as in phase 4."""
    import torch
    keep = MESH_STATE.get("keep")
    out = []
    for n, rec in MESH_STATE["recs"].items():
        mod, fn_name, plain_name = MESH_WRAPPERS[n]
        fn, plain = rec.fn, getattr(_mesh_module(mod), plain_name)
        for label, (args, kw) in rec.calls.items():
            a_k, kw_k = clone(args, keep), clone(kw, keep)
            a_p, kw_p = clone(args, keep), clone(kw, keep)
            got = fn(*a_k, **kw_k)
            want = plain(*a_p, **kw_p)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            name = f"{n} [{label}]"
            if n in ("mla_decode", "mla_prefill", "paged_decode",
                     "flash_prefill"):
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=2e-2, rtol=2e-2)
                spliced = {"mla_decode": ([2], ["kv_scale"]),
                           "paged_decode": ([3, 4], ["k_scale", "v_scale"])}
                pos, planes = spliced.get(n, ([], []))
                for i in pos:
                    if not torch.equal(a_k[i], a_p[i]):
                        raise RuntimeError(f"{name}: cache planes differ")
                for pl in planes:
                    if kw_k.get(pl) is not None and \
                            not torch.equal(kw_k[pl], kw_p[pl]):
                        raise RuntimeError(f"{name}: {pl} planes differ")
                live = None
            else:
                scale = float(want.abs().max()) + 1e-9
                if err / scale > 1e-2:
                    raise RuntimeError(f"{name}: error {err} / scale "
                                       f"{scale} > 1e-2")
                live = (rec.notes[label] if notes
                        else int((args[2] != 0).sum()))
            ms = time_ms(lambda: fn(*a_k, **kw_k), iters=20)
            dev_ms, _ = device_ms(lambda: fn(*a_k, **kw_k))
            plain_ms = time_ms(lambda: plain(*a_p, **kw_p), iters=3,
                               warmup=1)
            nbytes, flops = work(n, args, kw, got, live)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / BF16_FLOPS * 1e3
            lib = None
            if n in ("paged_decode", "flash_prefill", "mla_decode",
                     "mla_prefill"):
                lib = sdpa_ms(n, a_k, kw_k)
            out.append(dict(name=n, inputs=label, shape=shape_of(args),
                            max_abs_err=err, ms=ms, device_ms=dev_ms,
                            plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                            bound_by="bytes" if t_bytes >= t_ops
                            else "operations", library_ms=lib,
                            live_rows=live))
            log(f"mesh {name}: err {err:.3g}, {ms:.4f} ms ({dev_ms:.4f} on "
                f"the device) vs plain {plain_ms:.4f} ms, bound "
                f"{max(t_bytes, t_ops):.4f} ms, library {lib}")
        rec.calls.clear()
        setattr(rec.module, rec.name, rec.fn)
    return out


def mesh_metrics() -> dict:
    """Rank side: rank 0's ``llmd_tpu:collective_bytes_total`` by
    collective, and the bytes this rank's collectives put on the wire."""
    eng = MESH_STATE["engine"]
    counted = {}
    if eng.mesh.rank == 0:
        for line in eng.metrics.render().decode().splitlines():
            if line.startswith("llmd_tpu:collective_bytes_total{"):
                labels, value = line.rsplit(" ", 1)
                key = labels.split('collective="')[1].split('"')[0]
                counted[key] = float(value)
    return dict(counter=counted, wire_bytes=dict(eng.mesh.wire_bytes))


def mesh_teardown() -> dict:
    """Rank side: free the engine; returns this rank's peak memory."""
    import torch
    eng = MESH_STATE.get("engine")
    dev = eng.device if eng is not None else None
    for rec in MESH_STATE.get("recs", {}).values():
        setattr(rec.module, rec.name, rec.fn)
    MESH_STATE.clear()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return dict(peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)


def mesh_two_layer(prompt_lens, seed: int, **over) -> dict:
    """Rank side: the first two layers of deepseek-v3-bench (seed 0's
    draws of a 2-layer model) on the mesh, through the kernels: a prefill
    step of ``prompt_lens`` and one decode step of each row's argmax.
    Rank 0 returns the logits of both steps, the tokens decoded and its
    expert choice of every MoE layer call (the one-rank check replays
    it)."""
    import numpy as np
    import torch
    from llm_d_tpu_torch.engine.request import Request
    from llm_d_tpu_torch.ops import moe as moe_ops
    from llm_d_tpu_torch.ops.sampling import SamplingParams
    mesh_setup(MESH_MODEL, (), layers=2, record=False, num_blocks=24,
               max_num_seqs=8, max_num_batched_tokens=1024, **over)
    eng = MESH_STATE["engine"]
    mc = eng.model_config
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, mc.vocab_size, n).tolist()
               for n in prompt_lens]
    reqs = [Request(f"ref{i}", p, SamplingParams(
        temperature=0.0, max_tokens=2, ignore_eos=True))
        for i, p in enumerate(prompts)]
    for r in reqs:
        eng.scheduler.add_request(r)
    real_route, tape = moe_ops.route, []

    def route(logits_r, c, e_bias=None):
        w, idx = real_route(logits_r, c, e_bias=e_bias)
        tape.append(idx.cpu())
        return w, idx
    moe_ops.route = route
    logits, picks = [], []
    try:
        for _ in range(2):
            sched = eng.scheduler.schedule()
            batch, _ = eng._build_batch(sched)
            hidden = eng.model.forward(eng.params, eng.kv_cache, batch, mc,
                                       eng.config.block_size, mesh=eng.mesh)
            n = len(sched.scheduled)
            lg = eng.model.compute_logits(eng.params, hidden, mc,
                                          mesh=eng.mesh)[:n].float().cpu()
            logits.append(lg)
            for sr in sched.scheduled:
                sr.request.num_computed_tokens += sr.num_new_tokens
            pick = lg.argmax(-1).tolist()
            picks.append(pick)
            for r, tok in zip(reqs, pick):
                r.output_token_ids.append(tok)
    finally:
        moe_ops.route = real_route
    rank = eng.mesh.rank
    mesh_teardown()
    if rank != 0:
        return {}
    return dict(prompts=prompts, logits=[lg.numpy() for lg in logits],
                picks=picks, tape=[t.numpy() for t in tape])


def mesh_reference(tp: dict, replay: bool) -> dict:
    """The one-rank engine on the same 2-layer weights on the card (seed
    0's draws): the steps ``mesh_two_layer`` took, decoding its tokens,
    with its expert choice replayed at every MoE layer call where
    ``replay`` (gate weights from the one-rank engine's own scores):
    relative max logit error and argmax agreement, and the routed tokens
    whose expert set the replay changed."""
    import torch
    from llm_d_tpu_torch.engine.request import Request
    from llm_d_tpu_torch.ops import moe as moe_ops
    from llm_d_tpu_torch.ops.sampling import SamplingParams
    eng = path_i_engine(1, model_config=mesh_config(MESH_MODEL, 2),
                        num_blocks=24, max_num_seqs=8,
                        max_num_batched_tokens=1024)
    mc = eng.model_config
    reqs = [Request(f"ref{i}", p, SamplingParams(
        temperature=0.0, max_tokens=2, ignore_eos=True))
        for i, p in enumerate(tp["prompts"])]
    for r in reqs:
        eng.scheduler.add_request(r)
    real_route, tape, flips = moe_ops.route, list(tp["tape"]), []

    def route(logits_r, c, e_bias=None):
        w, idx = real_route(logits_r, c, e_bias=e_bias)
        theirs = torch.from_numpy(tape.pop(0)).to(idx.device)
        flips.append(int((theirs.sort(-1).values
                          != idx.sort(-1).values).any(-1).sum()))
        if not replay:
            return w, idx
        scores, _ = moe_ops.route_scores(logits_r, c, e_bias)
        return moe_ops.gate_weights(scores, theirs, c), theirs
    moe_ops.route = route
    logits = []
    try:
        for step in range(2):
            sched = eng.scheduler.schedule()
            batch, _ = eng._build_batch(sched)
            hidden = eng.model.forward(eng.params, eng.kv_cache, batch, mc,
                                       eng.config.block_size)
            n = len(sched.scheduled)
            logits.append(eng.model.compute_logits(
                eng.params, hidden, mc)[:n].float().cpu())
            for sr in sched.scheduled:
                sr.request.num_computed_tokens += sr.num_new_tokens
            for r, tok in zip(reqs, tp["picks"][step]):
                r.output_token_ids.append(tok)
    finally:
        moe_ops.route = real_route
    del eng
    got = torch.stack([torch.from_numpy(lg) for lg in tp["logits"]])
    want = torch.stack(logits)
    if not torch.isfinite(got).all():
        raise RuntimeError("non-finite logits from the mesh")
    return dict(replayed=replay,
                rel_max_err=float((got - want).abs().max()
                                  / want.abs().max()),
                top1_agree=bool((got.argmax(-1) == want.argmax(-1)).all()),
                routed_rows_differing_per_call=flips, shape=list(got.shape))


def token_agreement(got, want) -> dict:
    """Greedy tokens of two runs of the same prompts: equal positions,
    rows equal throughout, and each row's first differing position."""
    same = sum(a == b for g, w in zip(got, want) for a, b in zip(g, w))
    first = [next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
             for g, w in zip(got, want)]
    return dict(equal_tokens=same, tokens=sum(map(len, want)),
                equal_rows=sum(f is None for f in first), rows=len(want),
                first_difference=first)


def mesh_server(root: str, prompts, direct, layout=None,
                log_name: str = "mesh_server.log") -> dict:
    """Phase 9's server: ``python -m llm_d_tpu_torch.server.openai
    --tensor-parallel-size 4`` (or the flags ``layout``, phase 10's dp
    layout) with path (i)'s flags in classic steps (its log in
    build/``log_name``).  Wave 1's prompts one at a time
    (``MESH_SERVER_NEW`` greedy tokens, streamed), each reply's tokens the
    direct mesh engine's for that prompt alone (``direct``: a batch of
    other rows changes cuBLAS's GEMM choice, and 16 random layers amplify
    the rounding); then SIGTERM: exit 0, and no rank process left."""
    import signal
    layout = layout or ["--tensor-parallel-size", str(MESH_TP)]
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    log_path = os.path.join(root, "build", log_name)
    proc = start_server(root, [*MESH_SERVER_FLAGS, *layout, "--host",
                               "127.0.0.1", "--port", str(port)], log_name)
    try:
        startup_s = wait_ready(proc, url, limit_s=600)
        ranks = _child_pids(proc.pid)
        if len(ranks) < MESH_WORLD - 1:
            raise RuntimeError(f"the server started {len(ranks)} ranks")
        t0 = time.perf_counter()
        res = [completion(url, greedy_body(p, MESH_SERVER_NEW, True))
               for p in prompts]
        serve_s = time.perf_counter() - t0
        got = [r["tokens"] for r in res]
        if got != direct:
            raise RuntimeError(f"the mesh server's replies ({layout}) "
                               f"differ from the direct mesh engine's: "
                               f"{token_agreement(got, direct)}")
        status, _, health = http_call(url, "/health")
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=DRAIN_S + 120)
        exit_s = time.perf_counter() - t_term
        time.sleep(1.0)
        left = [p for p in ranks if _pid_alive(p)]
        if rc != 0 or left:
            raise RuntimeError(f"after SIGTERM the mesh server ({layout}) "
                               f"exited with {rc}; ranks left: {left}")
    except BaseException:
        with open(log_path, "rb") as log_f:
            sys.stderr.write(log_f.read()[-8000:].decode(errors="replace"))
        raise
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        for p in _child_pids(proc.pid):
            os.kill(p, 9)
    return dict(flags=layout, startup_s=startup_s, ranks=len(ranks) + 1,
                requests=len(prompts), replies_equal_direct=True,
                serve_s=serve_s, health=status, exit_code=rc,
                exit_s=exit_s)


def _child_pids(pid: int) -> list:
    """The live rank processes ``pid`` started (multiprocessing's spawned
    children; its resource tracker is not a rank)."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read()
        except OSError:
            continue
        if int(fields[1]) == pid and fields[0] != "Z" \
                and b"spawn_main" in cmd:
            out.append(int(d))
    return out


def _pid_alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


# Phase 10, path (ix): data parallelism on one host.  deepseek-v3-bench
# at dp = 2, tp = 2 (ep = 4: 16 of 64 experts a layer on each rank) as the
# four ranks of phase 9's pool, each dp shard serving its own requests'
# attention over its half of the KV pool (classic steps, gloo as in phase
# 9); then the dp server (--data-parallel-size 2 --tensor-parallel-size 2)
# and a DPEngineGroup of two one-device engines sharing the card.
DP_SIZE, DP_TP = 2, 2
DP_LAYOUT = ["--data-parallel-size", str(DP_SIZE), "--tensor-parallel-size",
             str(DP_TP)]


def dp_mesh():
    from llm_d_tpu_torch.parallel.mesh import MeshConfig
    return MeshConfig(dp=DP_SIZE, tp=DP_TP)


def _expert_total_bytes(mc) -> int:
    """The routed experts' int8 payloads and f32 scales, every layer."""
    Lm = mc.num_layers - mc.first_dense_layers
    E, H, Im = mc.num_experts, mc.hidden_size, mc.moe_intermediate_size
    return Lm * E * (3 * H * Im + 4 * (2 * Im + H))


def _logits_by_request(eng, host, hidden, reqs):
    """The f32 logits of ``reqs`` in their order, from a step's gathered
    sampling rows."""
    lg = eng._logits(hidden).float().cpu()
    row_of = {sr.request.request_id: int(row)
              for sr, row in zip(host["scheduled"], host["rows"])}
    return lg[[row_of[r.request_id] for r in reqs]]


def dp_two_layer(prompt_lens, seed: int) -> dict:
    """Rank side: the first two layers of deepseek-v3-bench on the dp mesh
    through the kernels: a prefill step of ``prompt_lens`` (a request a
    region) and one decode step of each row's argmax, each through the
    engine's own shard batch and forward (the shards' sampling rows
    gathered over dp).  Rank 0 returns the logits of both steps by
    request, the tokens decoded and each request's region; the first tp
    rank of each shard its shard's expert choice."""
    import numpy as np
    from llm_d_tpu_torch.engine.request import Request
    from llm_d_tpu_torch.ops.sampling import SamplingParams
    mesh_setup(MESH_MODEL, (), layers=2, record=False, num_blocks=24,
               max_num_seqs=8, max_num_batched_tokens=1024, mesh=dp_mesh())
    eng = MESH_STATE["engine"]
    mc = eng.model_config
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, mc.vocab_size, n).tolist()
               for n in prompt_lens]
    reqs = [Request(f"ref-{i}", p, SamplingParams(
        temperature=0.0, max_tokens=2, ignore_eos=True))
        for i, p in enumerate(prompts)]
    for r in reqs:
        eng.scheduler.add_request(r)
    tape, logits, picks = {}, [], []
    with contextlib.ExitStack() as stack:
        if eng.mesh.coord["tp"] == 0:
            stack.enter_context(routing_tape(eng, tape, replay=False))
        for _ in range(2):
            sched = eng.scheduler.schedule()
            batch, host = eng._build_batch(sched)
            hidden, _ = eng._forward(batch)
            lg = _logits_by_request(eng, host, hidden, reqs)
            logits.append(lg)
            for sr in sched.scheduled:
                sr.request.num_computed_tokens += sr.num_new_tokens
            pick = lg.argmax(-1).tolist()
            picks.append(pick)
            for r, tok in zip(reqs, pick):
                r.output_token_ids.append(tok)
    regions = [eng.kv_manager.region_of_request(r) for r in reqs]
    coord = eng.mesh.coord
    mesh_teardown()
    out = dict(tape=tape if coord["tp"] == 0 else None)
    if coord["dp"] == coord["tp"] == 0:
        out.update(prompts=prompts, logits=[lg.numpy() for lg in logits],
                   picks=picks, regions=regions)
    return out


def dp_reference(two: dict, tape: dict, replay: bool) -> dict:
    """The one-rank engine on the same 2-layer weights on the card: the
    steps ``dp_two_layer`` took (its requests, decoding its tokens), with
    the dp mesh's expert choice replayed where ``replay`` (by layer,
    request and position; gate weights from its own scores): relative max
    logit error, argmax agreement, the token-layers replayed."""
    import torch
    from llm_d_tpu_torch.engine.request import Request
    from llm_d_tpu_torch.ops.sampling import SamplingParams
    eng = path_i_engine(1, model_config=mesh_config(MESH_MODEL, 2),
                        num_blocks=24, max_num_seqs=8,
                        max_num_batched_tokens=1024)
    reqs = [Request(f"ref-{i}", p, SamplingParams(
        temperature=0.0, max_tokens=2, ignore_eos=True))
        for i, p in enumerate(two["prompts"])]
    for r in reqs:
        eng.scheduler.add_request(r)
    logits = []
    with (routing_tape(eng, tape, replay=True) if replay
          else contextlib.nullcontext([0])) as replayed:
        for step in range(2):
            sched = eng.scheduler.schedule()
            batch, host = eng._build_batch(sched)
            hidden, _ = eng._forward(batch)
            logits.append(_logits_by_request(eng, host, hidden, reqs))
            for sr in sched.scheduled:
                sr.request.num_computed_tokens += sr.num_new_tokens
            for r, tok in zip(reqs, two["picks"][step]):
                r.output_token_ids.append(tok)
    del eng
    got = torch.stack([torch.from_numpy(lg) for lg in two["logits"]])
    want = torch.stack(logits)
    if not torch.isfinite(got).all():
        raise RuntimeError("non-finite logits from the dp mesh")
    return dict(replayed=replay, token_layers_replayed=replayed[0],
                rel_max_err=float((got - want).abs().max()
                                  / want.abs().max()),
                top1_agree=bool((got.argmax(-1) == want.argmax(-1)).all()),
                shape=list(got.shape))


def dp_pool_phase(pool, p1, p3) -> dict:
    """Phase 10 on the pool's four ranks: deepseek-v3-bench at dp = tp =
    2, full width and depth: each rank's cache plane (half the pool) and
    routed-expert bytes (a quarter), wave 1 (``MESH_W1_NEW`` new tokens,
    its expert choice taped by each shard) and wave 3 to 2 new tokens
    (its 8192-token prefill, 4096 tokens a shard): every rank's tokens
    identical and A, B and E launching on every rank; wave 1's prompts
    one at a time (the server's yardstick); each recorded rank-local
    kernel input against its plain version; collective bytes and peaks;
    then the 2-layer check against the one-rank engine."""
    t0 = time.perf_counter()
    mc = mesh_config(MESH_MODEL)
    out = dict(dp=DP_SIZE, tp=DP_TP, ep=DP_SIZE * DP_TP, model=MESH_MODEL,
               steps="classic (gloo collectives are not capturable)")
    out["build"] = pool.run(mesh_setup, MESH_MODEL, MESH_KERNELS,
                            path="ix", mesh=dp_mesh())
    out["build_s"] = time.perf_counter() - t0
    total = _expert_total_bytes(mc)
    for b in out["build"]:
        want_kv = [mc.num_layers, b["pool_slots"] // DP_SIZE,
                   -(-(mc.kv_lora_rank + mc.qk_rope_head_dim) // 128) * 128]
        if b["kv_planes"]["kv"] != want_kv:
            raise RuntimeError(f"dp rank {b['rank']}: KV plane "
                               f"{b['kv_planes']['kv']}, want {want_kv}")
        if b["expert_bytes"] * DP_SIZE * DP_TP != total:
            raise RuntimeError(f"dp rank {b['rank']}: {b['expert_bytes']} "
                               f"expert bytes, want {total} / "
                               f"{DP_SIZE * DP_TP}")
    out["kv_plane_fraction"] = 1 / DP_SIZE
    out["expert_bytes"] = dict(total=total, per_rank=[
        b["expert_bytes"] for b in out["build"]], fraction=1 / (
            DP_SIZE * DP_TP))
    log(f"dp: build {json.dumps(out['build'])}")
    waves, launches, tape = {}, {}, {}
    for tag, prompts, new, taped in (("d1", p1, MESH_W1_NEW, True),
                                     ("d3", p3, MESH_W3_NEW, False)):
        res = pool.run(mesh_wave, tag, prompts, new, None, taped)
        toks = [r["tokens"] for r in res]
        if any(t != toks[0] for t in toks):
            raise RuntimeError(f"dp wave {tag}: the ranks' tokens differ")
        waves[tag] = dict(res[0]["stats"], ranks_identical=True,
                          launches_by_rank=[r["launches"] for r in res],
                          wire_bytes_by_rank=[r["wire_bytes"] for r in res],
                          peak_gib_by_rank=[r["peak_gib"] for r in res],
                          timing="gloo through the host, classic steps")
        waves[tag]["tokens"] = toks[0]
        for r in res:
            tape.update(r["tape"] or {})
        log(f"dp wave {tag}: {json.dumps(res[0]['stats'])}, launches "
            f"{json.dumps([r['launches'] for r in res])}")
    for n in MESH_KERNELS:
        per_rank = [sum(waves[w]["launches_by_rank"][r][n] for w in waves)
                    for r in range(MESH_WORLD)]
        if min(per_rank) == 0:
            raise RuntimeError(f"{n} never launched on a rank of path (ix): "
                               f"{per_rank}")
        launches[n] = sum(per_rank)
    t1 = time.perf_counter()
    alone = pool.run(mesh_alone, p1[:MESH_SERVER_PROMPTS], MESH_SERVER_NEW)
    if any(a != alone[0] for a in alone):
        raise RuntimeError("dp alone: the ranks' tokens differ")
    out["alone_s"] = time.perf_counter() - t1
    checks = pool.run(mesh_kernel_checks)[0]
    m = pool.run(mesh_metrics)
    out["collective_bytes"] = dict(
        counter=m[0]["counter"],
        wire_bytes_by_rank=[r["wire_bytes"] for r in m])
    out["peak_gib_by_rank"] = [r["peak_gib"] for r in pool.run(mesh_teardown)]
    log(f"dp: peaks {out['peak_gib_by_rank']}, collective bytes "
        f"{json.dumps(out['collective_bytes'])}")
    t1 = time.perf_counter()
    two = pool.run(dp_two_layer, [100, 37], 27)
    two_tape = {}
    for r in two:
        two_tape.update(r["tape"] or {})
    ref = two[0]
    out["reference_regions"] = ref["regions"]
    out["reference"] = [dp_reference(ref, two_tape, replay)
                        for replay in (False, True)]
    out["reference_s"] = time.perf_counter() - t1
    log(f"dp reference: {json.dumps(out['reference'])}")
    if sorted(ref["regions"]) != list(range(DP_SIZE)):
        raise RuntimeError(f"the 2-layer requests' regions: "
                           f"{ref['regions']}")
    best = out["reference"][1]
    if not best["top1_agree"] or best["rel_max_err"] > 5e-2:
        raise RuntimeError(f"the dp mesh disagrees with the one-rank "
                           f"engine: {best}")
    out["pool_s"] = time.perf_counter() - t0
    return dict(out=out, waves=waves, launches=launches, checks=checks,
                tape=tape, alone=alone[0])


def dp_group_check(one, prompts, new: int) -> dict:
    """Path (ix), ranks mode: a ``DPEngineGroup`` of two engines on the
    card (the same card twice: they step one after another) on the
    weights of ``one`` (the one-rank engine, classic steps) and in its
    configuration: wave 1's prompts (``new`` greedy tokens), dispatch
    split between the ranks, tokens against ``one`` serving the same
    requests and, where they differ, again with ``one``'s expert choice
    replayed on the group."""
    import torch
    from llm_d_tpu_torch.engine.dp_group import DPEngineGroup
    from llm_d_tpu_torch.engine.request import Request
    from llm_d_tpu_torch.ops.sampling import SamplingParams
    t0 = time.perf_counter()
    group = DPEngineGroup(one.config, 2, params=one.params,
                          devices=[one.device, one.device])
    out = dict(ranks=len(group.engines),
               devices=[str(e.device) for e in group.engines],
               shared_weights=group.engines[1].params["embed"]
               is one.params["embed"],
               build_s=time.perf_counter() - t0)
    tape = {}
    with routing_tape(one, tape, replay=False):
        want, stats = run_wave(one, prompts, new, "g1")
    out["one_engine_s"] = stats["seconds"]

    def serve(replay: bool):
        reqs = [Request(f"g1-{i}", p, SamplingParams(
            temperature=0.0, max_tokens=new, ignore_eos=True))
            for i, p in enumerate(prompts)]
        with (routing_tape(group, tape, replay=True) if replay
              else contextlib.nullcontext([0])) as replayed:
            t1 = time.perf_counter()
            for r in reqs:
                group.add_request(r)
            split = [e.scheduler.num_waiting for e in group.engines]
            while group.has_work():
                group.step()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t1
        return [list(r.output_token_ids) for r in reqs], split, secs, \
            replayed[0]

    got, split, secs, _ = serve(False)
    if sorted(split) != [len(prompts) // 2] * 2:
        raise RuntimeError(f"the group's dispatch split {split}")
    out.update(split=split, group_s=secs,
               tokens=token_agreement(got, want))
    if got != want:
        again, _, _, n = serve(True)
        out["tokens_routing_replayed"] = dict(token_agreement(again, want),
                                              token_layers_replayed=n)
    group.close()
    del group
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


# Phase 11, path (x): the wide-EP recipe (deploy/wide-ep-lws) on phase 10's
# dp = 2, tp = 2 mesh: (a) DBO in the EP exchange at the recipe's threshold
# against phase 10's waves (DBO off, the same weights and configuration);
# (b) EPLB at ep = 4 with live migrations between ranks, on
# bench_eplb_skew's prompts and Zipf trace, against the same engine with
# EPLB off; (c) a P/D pair of meshes on the same four ranks, built from the
# recipe's flags; (d) the recipe's two servers.
WIDE_DBO = 32                        # decode-lws.yaml's two thresholds
# bench_eplb_skew's prompts (SPEC_WAVE, seed 5), the first of them, with
# fewer new tokens: the smoke's time limit (a gloo step is ~0.4 s).
WIDE_SKEW_PROMPTS = 8
WIDE_SKEW_NEW = 12
# New tokens of wave 1's P/D runs (and the consumer's own run), cut from
# 32 for the time limit.
WIDE_PD_NEW = 8
# Flips within the wave: the interval after 4 steps, a budget that stages
# a migration in a few ticks (the recipe's 1000 / 3000 never flips in a
# smoke).
WIDE_EPLB = {"num_redundant_experts": 4, "window_size": 512,
             "step_interval": 4, "move_budget": 256}
# The recipe's flag sets at dp = 2, tp = 2 on deepseek-v3-bench; (c)'s
# engines take the decode set less --num-scheduler-steps 16
# --async-scheduling (its judges read the margins of classic steps), (d)'s
# consumer server the whole set (WIDE_DECODE_SERVER_FLAGS).
WIDE_PREFILL_FLAGS = [
    "--model", MESH_MODEL, *DP_LAYOUT, "--max-num-batched-tokens", "8192",
    "--kv-transfer-config",
    '{"kv_connector":"TPUConnector","kv_role":"kv_producer",'
    '"kv_port":8300}']
WIDE_DECODE_FLAGS = [
    "--model", MESH_MODEL, *DP_LAYOUT, "--enable-eplb", "--eplb-config",
    '{"window_size":1000,"step_interval":3000,"num_redundant_experts":32}',
    "--enable-dbo", "--dbo-decode-token-threshold", str(WIDE_DBO),
    "--dbo-prefill-token-threshold", str(WIDE_DBO), "--kv-transfer-config",
    '{"kv_connector":"TPUConnector","kv_role":"kv_consumer",'
    '"kv_load_failure_policy":"recompute"}']


def wide_flags(flags, kv_port=None, port=None):
    """A recipe flag set with this run's ports: the producer's transfer
    port (the recipe's 8300) and the HTTP port (its 8200)."""
    out = list(flags)
    if kv_port is not None:
        i = out.index("--kv-transfer-config") + 1
        out[i] = out[i].replace('"kv_port":8300', f'"kv_port":{kv_port}')
    if port is not None:
        out += ["--host", "127.0.0.1", "--port", str(port)]
    return out


@contextlib.contextmanager
def margin_spy(eng, margins: dict):
    """Rank 0: each sampled row's top-2 logit margin and decision bar
    ``2 * 5e-2 * max|logit|`` by (request id, output position), from the
    rows a classic step's ``_build_batch`` maps to its requests."""
    import torch
    real_build, real_logits = eng._build_batch, eng._logits
    state = {}

    def build(sched):
        batch, host = real_build(sched)
        state["host"] = host
        return batch, host

    def logits(hidden):
        out = real_logits(hidden)
        host = state.pop("host", None)
        if host is not None:
            lg = out.float()
            top2 = torch.topk(lg, 2, dim=-1).values
            margin = (top2[:, 0] - top2[:, 1]).tolist()
            bar = (2 * 5e-2 * lg.abs().amax(-1)).tolist()
            for sr, row in zip(host["scheduled"], host["rows"]):
                r = sr.request
                margins[(r.request_id, len(r.output_token_ids))] = (
                    margin[row], bar[row])
        return out

    eng._build_batch, eng._logits = build, logits
    try:
        yield margins
    finally:
        eng._build_batch, eng._logits = real_build, real_logits


def near_tie_judge(tokens, ref, margins: dict, tag: str) -> dict:
    """``tokens`` against ``ref`` (rows of the same prompts): each row's
    first difference must fall where the run's top-2 margin is within its
    bar (``margins`` by (request id, position); rows ``tag-i``)."""
    out = dict(token_agreement(tokens, ref), near_ties=[])
    for i, j in enumerate(out["first_difference"]):
        if j is None:
            continue
        m = margins.get((f"{tag}-{i}", j))
        out["near_ties"].append(dict(row=i, at=j, margin=m and m[0],
                                     bar=m and m[1]))
        if m is None or m[0] > m[1]:
            raise RuntimeError(f"{tag}: row {i} differs at {j} where the "
                               f"top-2 margin {m} is no near tie")
    return out


def _slot_sums(eng):
    """This rank's expert slots' checksums, every expert-major key:
    ``[Lm, slots, 2 * keys]`` (byte sum, position-weighted byte sum)."""
    import torch
    ml = eng.params["moe_layers"]
    names = [n for n in sorted(ml) if n.startswith(("w_gate", "w_up",
                                                    "w_down"))]
    out = []
    for n in names:
        t = ml[n]
        per = []
        for li in range(t.shape[0]):
            b = t[li].contiguous().view(torch.uint8).reshape(t.shape[1], -1)
            w = torch.arange(b.shape[1], device=b.device) % 7 + 1
            per.append(torch.stack([b.to(torch.int64).sum(-1),
                                    (b.to(torch.int64) * w).sum(-1)], -1))
        out.append(torch.stack(per))
    return torch.cat(out, -1)


def wide_instrument(eng) -> dict:
    """Every rank: chunk counts of the EP exchange (by the step's rows),
    and under EPLB the host ms of each staging tick and flip, each
    migration's moves, and per flip (a collective: every rank flips at
    the same step) whether each moved slot holds its source slot's bytes
    and every other slot kept its own, with this rank's tables."""
    import collections
    import torch
    from llm_d_tpu_torch.ops import moe as moe_ops
    from llm_d_tpu_torch.parallel.eplb import plan_delta
    from llm_d_tpu_torch.parallel.mesh import AXIS_EP
    st = dict(chunks=collections.Counter(), stage_ms=[], flips=[])
    real_chunks = moe_ops.dbo_chunk_tokens

    def chunks(T, ep, chunk, thr):
        c = real_chunks(T, ep, chunk, thr)
        st["chunks"][f"T={T} chunks={T // ep // c}"] += 1
        return c
    moe_ops.dbo_chunk_tokens = chunks
    st["restore"] = [(moe_ops, "dbo_chunk_tokens", real_chunks)]
    ctl = eng.eplb
    if ctl is None:
        return st
    real_stage, real_flip = ctl._stage_mesh, ctl._flip

    def stage(batch, params):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = real_stage(batch, params)
        torch.cuda.synchronize()
        st["stage_ms"].append((time.perf_counter() - t0) * 1e3)
        return n

    def flip(params):
        m = ctl._migration
        moves = [(li, dst, src) for li, t in enumerate(m.plans)
                 for dst, src in plan_delta(ctl.plans[li], t)]
        before = eng.mesh.all_gather(_slot_sums(eng), AXIS_EP, dim=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_flip(params)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = eng.mesh.all_gather(_slot_sums(eng), AXIS_EP, dim=1)
        want = before.clone()
        for li, dst, src in moves:
            want[li, dst] = before[li, src]
        ml = out["moe_layers"]
        st["flips"].append(dict(
            moves=len(moves), flip_ms=ms,
            moved_bytes_equal_sources=bool(torch.equal(after, want)),
            cross_rank_moves=sum(dst // m.plans[0].slots_per_shard
                                 != src // m.plans[0].slots_per_shard
                                 for _, dst, src in moves),
            tables=[ml["replica_table"].cpu().numpy().tolist(),
                    ml["num_replicas"].cpu().numpy().tolist()]))
        return out
    ctl._stage_mesh, ctl._flip = stage, flip
    return st


def wide_wave(tag: str, prompts, new: int, dbo=None, skew: bool = False
              ) -> dict:
    """Rank side: ``mesh_wave`` on this rank's engine, DBO switched on or
    off (``dbo``), with bench_eplb_skew's Zipf trace recorded into the
    EPLB tracker first (``skew``, every rank the same draws), the chunk
    counts and EPLB events of ``wide_instrument``, and on rank 0 the
    margins of its sampled rows."""
    import dataclasses
    import numpy as np
    eng = MESH_STATE["engine"]
    if dbo is not None:
        eng.config = dataclasses.replace(eng.config, enable_dbo=dbo)
    if skew and eng.eplb is not None:
        rng = np.random.RandomState(1234)
        eng.eplb.tracker.record(rng.choice(
            eng.eplb.E, size=(eng.eplb.n_layers, 4096, 2),
            p=zipf_probs(eng.eplb.E)))
    st = wide_instrument(eng)
    margins = {}
    calls0 = eng.mesh.calls.get("all_to_all", 0)
    try:
        with (margin_spy(eng, margins) if eng.mesh.rank == 0
              else contextlib.nullcontext()):
            res = mesh_wave(tag, prompts, new)
    finally:
        for mod, name, fn in st.pop("restore"):
            setattr(mod, name, fn)
    res.update(chunks=dict(st["chunks"]), stage_ms=st["stage_ms"],
               flips=st["flips"], margins=margins if margins else None,
               all_to_all_calls=eng.mesh.calls.get("all_to_all", 0) - calls0)
    if eng.eplb is not None:
        res.update(sent_bytes=eng.eplb.sent_bytes,
                   received_bytes=eng.eplb.received_bytes,
                   migrations=eng.eplb.num_rebalances,
                   physical=eng.eplb.plans[0].num_physical)
    return res


def wide_layer(T: int, seed: int) -> dict:
    """Rank side: the engine's first MoE layer on ``T`` rows a dp shard
    (routing from ``seed``) through the a2a exchange with DBO at
    ``WIDE_DBO`` and off: the relative max error, the chunks each ran."""
    from llm_d_tpu_torch.ops import moe as moe_ops
    from llm_d_tpu_torch.parallel.mesh import AXIS_DP
    eng = MESH_STATE["engine"]
    x, w, idx = moe_inputs(eng.model_config, T, seed=seed)
    quant = {n: eng.params["moe_layers"][n] for n in
             ("w_gate_q", "w_gate_s", "w_up_q", "w_up_s", "w_down_q",
              "w_down_s")}
    quant["layer"] = 0
    outs, calls = {}, {}
    for thr in (WIDE_DBO, -1):
        c0 = eng.mesh.calls.get("all_to_all", 0)
        outs[thr] = moe_ops.expert_ffn(x, w, idx, None, None, None,
                                       quant=quant, mesh=eng.mesh,
                                       dbo_min_tokens=thr).float()
        calls[thr] = (eng.mesh.calls["all_to_all"] - c0) // 2
    ref = outs[-1]
    return dict(rows=T * eng.mesh.axis_size(AXIS_DP),
                rel_max_err=float((outs[WIDE_DBO] - ref).abs().max()
                                  / (ref.abs().max() + 1e-12)),
                chunks_dbo=calls[WIDE_DBO], chunks_off=calls[-1])


def wide_pd_setup(kv_port: int) -> dict:
    """Rank side: the producer engine of the prefill recipe's flags and the
    consumer of the decode recipe's (path (x)(c)), both on this rank's
    card; rank 0 holds their KV connectors (the producer's transfer
    server on ``kv_port``)."""
    import torch
    from llm_d_tpu_torch.engine import EngineCore
    from llm_d_tpu_torch.server import openai as srv
    p = srv.build_arg_parser()
    t0 = time.perf_counter()
    built = []
    for flags in (wide_flags(WIDE_PREFILL_FLAGS, kv_port),
                  WIDE_DECODE_FLAGS):
        args = p.parse_args(flags)
        srv.check_served(p, args)
        srv.check_mesh_flags(p, args)
        built.append((EngineCore(srv.engine_config_from_args(args)), args))
    (prod, pargs), (cons, cargs) = built
    MESH_STATE.clear()
    MESH_STATE.update(prod=prod, cons=cons, names=MESH_KERNELS, recs={},
                      role="x pd consumer")
    if prod.mesh.rank == 0:
        prod.kv_connector = srv.kv_connector_from_args(pargs)
        cons.kv_connector = srv.kv_connector_from_args(cargs)
        # Each engine's launches under its role's label.
        mesh_record([prod, cons], MESH_KERNELS, lambda: MESH_STATE["role"])
    torch.cuda.synchronize()
    return dict(rank=prod.mesh.rank, build_s=time.perf_counter() - t0,
                held_gib=torch.cuda.memory_allocated(prod.device) / 2**30,
                consumer_physical=cons.eplb.plans[0].num_physical,
                consumer_dbo=cons.config.enable_dbo)


def _pd_scatter_checks():
    """Every rank: wrap the connector's scatter (called on the ranks of
    the blocks' region) to hold this rank's rows of the blocks to its
    shard of the slab; returns the list of (region, held here, rows
    equal)."""
    import torch
    from llm_d_tpu_torch.transfer import connector as conn
    seen = []
    real = conn.scatter_blocks

    def checked(eng, block_ids, blob):
        real(eng, block_ids, blob)
        r, local = conn._local_blocks(eng, block_ids)
        if r != eng.dp_index:
            seen.append((r, False, None))
            return
        bs, nb = eng.config.block_size, len(block_ids)
        bnb = conn._HEADER.unpack_from(blob, 0)[5]
        ids = torch.tensor(local, device=eng.device)
        same = True
        for name, off, count, dtype, width in conn.check_slab(eng, blob, nb):
            have = eng.kv_cache[name]
            L, w = have.shape[0], have.shape[2]
            wire = conn.host_tensor(blob, off, count, dtype, False).view(
                L, bnb, bs, width)[:, :nb]
            if w != width:
                t = eng.mesh.axis_index("tp")
                wire = wire[..., t * w:(t + 1) * w]
            rows = have.view(L, -1, bs, w).index_select(1, ids).cpu()
            same &= bool(torch.equal(rows, wire))
        seen.append((r, True, same))
    conn.scatter_blocks = checked
    return seen, (conn, "scatter_blocks", real)


def wide_pd_run(tag: str, prompts, new: int, alone: bool = False,
                tape=None) -> dict:
    """Rank side: ``prompts`` through the P/D pair (path (x)(c)): rank 0
    prefills them on the producer (``do_remote_decode``, one token), the
    consumer pulls each request's blocks over the native transport and
    decodes ``new`` tokens, the producer steps until the consumer's
    releases free its pins; the other ranks follow each engine in turn.
    With ``alone`` the prompts go one at a time; with ``tape`` every
    rank replays the taped expert choice on the consumer
    (``routing_tape``).  Every rank checks the slabs it scattered; A, B
    and E count from 0."""
    import torch
    from llm_d_tpu_torch.engine.request import Request, RequestState
    from llm_d_tpu_torch.ops.sampling import SamplingParams
    prod, cons = MESH_STATE["prod"], MESH_STATE["cons"]
    _mesh_reset(MESH_KERNELS)
    seen, restore = _pd_scatter_checks()
    groups = [[i] for i in range(len(prompts))] if alone \
        else [list(range(len(prompts)))]
    out = dict(tokens=[None] * len(prompts))
    t0 = time.perf_counter()
    stack = contextlib.ExitStack()
    if tape is not None:
        stack.enter_context(routing_tape(cons, tape, replay=True))
    try:
        for group in groups:
            if prod.mesh.rank != 0:
                prod.follow(record=False)
                got = cons.follow()
                prod.follow(record=False)
                for i in group:
                    out["tokens"][i] = got[f"{tag}-{i}"]
                continue
            preqs = [Request(f"{tag}-{i}", prompts[i], SamplingParams(
                temperature=0.0, max_tokens=1, ignore_eos=True),
                do_remote_decode=True) for i in group]
            for r in preqs:
                prod.add_request(r)
            MESH_STATE["role"] = "x pd producer"
            while any(r.state is not RequestState.FINISHED_REMOTE_PREFILL
                      for r in preqs):
                prod.step()
            prod.stop_mesh()
            MESH_STATE["role"] = "x pd consumer"
            dreqs = [Request(r.request_id, prompts[i], SamplingParams(
                temperature=0.0, max_tokens=new, ignore_eos=True),
                do_remote_prefill=True,
                kv_transfer_params=r.kv_transfer_params)
                for i, r in zip(group, preqs)]
            got = cons.generate(dreqs)
            cons.stop_mesh()
            MESH_STATE["role"] = "x pd producer"
            for _ in range(30000):
                if not prod.pinned_transfers:
                    break
                prod.step()
                time.sleep(0.001)
            prod.stop_mesh()
            MESH_STATE["role"] = "x pd consumer"
            if prod.pinned_transfers:
                raise RuntimeError(f"P/D {tag}: the producer kept its pins")
            for i, r in zip(group, dreqs):
                out["tokens"][i] = got[r.request_id]
    finally:
        stack.close()
        setattr(*restore)
    torch.cuda.synchronize()
    out.update(seconds=time.perf_counter() - t0, scatters=seen,
               pins_left=len(prod.pinned_transfers),
               free_blocks=(prod.kv_manager.num_free_blocks,
                            cons.kv_manager.num_free_blocks),
               launches=_mesh_launches(MESH_KERNELS))
    return out


def wide_pd_local(tag: str, prompts, new: int) -> dict:
    """Rank side: the consumer engine serves ``prompts`` itself (its own
    prefill), rank 0 keeping each sampled row's margin and the first tp
    rank of each dp shard taping its shard's expert choice: the
    yardstick of the P/D runs' tokens."""
    cons = MESH_STATE["cons"]
    MESH_STATE["engine"] = cons
    margins = {}
    with (margin_spy(cons, margins) if cons.mesh.rank == 0
          else contextlib.nullcontext()):
        res = mesh_wave(tag, prompts, new, tape=True)
    res["margins"] = margins or None
    return res


def wide_pd_teardown() -> dict:
    """Rank side: close the connectors and free both engines."""
    import torch
    prod, cons = MESH_STATE["prod"], MESH_STATE["cons"]
    for e in (prod, cons):
        if e.kv_connector is not None:
            e.kv_connector.close()
    dev = prod.device
    MESH_STATE.clear()
    del prod, cons
    gc.collect()
    torch.cuda.empty_cache()
    return dict(peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)


def wide_pool_phase(pool, p1, p3, dp_tokens: dict) -> dict:
    """Phase 11 (path (x)) on the pool's four ranks (module docstring):
    (a) DBO at ``WIDE_DBO`` on phase 10's configuration against its
    waves (``dp_tokens``: d1, d3, DBO off), one MoE layer both ways;
    (b) EPLB at ep = 4 (``WIDE_EPLB``) on bench_eplb_skew's first
    prompts and trace against the same engine with EPLB off; (c) the
    recipe's producer and consumer engines: the consumer's own wave 1,
    ``WIDE_SERVER_PROMPTS`` prompts one at a time disaggregated (the
    servers' yardstick), then wave 1 disaggregated."""
    import numpy as np
    t0 = time.perf_counter()
    out = dict(dp=DP_SIZE, tp=DP_TP, ep=DP_SIZE * DP_TP, model=MESH_MODEL,
               steps="classic (gloo collectives are not capturable)")
    launches, checks = {}, []

    def count(res, key):
        for n in MESH_KERNELS:
            per_rank = [r["launches"][n] for r in res]
            launches.setdefault(n, [0] * MESH_WORLD)
            launches[n] = [a + b for a, b in zip(launches[n], per_rank)]
        toks = [r["tokens"] for r in res]
        if any(t != toks[0] for t in toks):
            raise RuntimeError(f"path (x) {key}: the ranks' tokens differ")
        return toks[0]

    # (a) DBO.
    ta = time.perf_counter()
    pool.run(mesh_setup, MESH_MODEL, MESH_KERNELS, path="x", mesh=dp_mesh(),
             enable_dbo=True, dbo_decode_token_threshold=WIDE_DBO,
             dbo_prefill_token_threshold=WIDE_DBO)
    dbo = {}
    for tag, prompts, new, ref in (("x1", p1, MESH_W1_NEW, "d1"),
                                   ("x3", p3, MESH_W3_NEW, "d3")):
        res = pool.run(wide_wave, tag, prompts, new, True)
        toks = count(res, tag)
        want = [t[:new] for t in dp_tokens[ref]]
        dbo[tag] = dict(res[0]["stats"], chunks=res[0]["chunks"],
                        all_to_all_calls=res[0]["all_to_all_calls"],
                        tokens_vs_dbo_off=near_tie_judge(
                            toks, want, res[0]["margins"], tag))
        log(f"path (x)(a) {tag}: {json.dumps(dbo[tag])}")
    # The decode and both prefills above the threshold: 2 chunks a rank.
    for tag in dbo:
        if not any(k.endswith("chunks=2") for k in dbo[tag]["chunks"]):
            raise RuntimeError(f"path (x)(a) {tag}: DBO never split the "
                               f"exchange: {dbo[tag]['chunks']}")
    layer = pool.run(wide_layer, 256, 256)
    if any(abs(l["rel_max_err"]) > 1e-2 for l in layer):
        raise RuntimeError(f"path (x)(a): one MoE layer with DBO "
                           f"{layer[0]} off by more than 1e-2")
    dbo["one_layer"] = layer[0]
    # (b)'s yardstick: EPLB off (DBO off) on the skew prompts.
    sp = prompts_for(np.random.default_rng(5), mesh_config(MESH_MODEL)
                     .vocab_size, dict(SPEC_WAVE, n=WIDE_SKEW_PROMPTS))
    off = pool.run(wide_wave, "xs", sp, WIDE_SKEW_NEW, False)
    off_tokens = count(off, "xs off")
    checks += pool.run(mesh_kernel_checks)[0]
    pool.run(mesh_teardown)
    dbo["seconds"] = time.perf_counter() - ta
    out["dbo"] = dbo
    # (b) EPLB at ep = 4 with migrations between ranks.
    tb = time.perf_counter()
    build = pool.run(mesh_setup, MESH_MODEL, MESH_KERNELS, path="x eplb",
                     mesh=dp_mesh(), enable_eplb=True,
                     eplb_config=dict(WIDE_EPLB))
    install = pool.run(wide_install)
    res = pool.run(wide_wave, "xs", sp, WIDE_SKEW_NEW, False, True)
    toks = count(res, "xs eplb")
    flips = [r["flips"] for r in res]
    if not flips[0] or any(len(f) != len(flips[0]) for f in flips):
        raise RuntimeError(f"path (x)(b): flips by rank "
                           f"{[len(f) for f in flips]}")
    for i in range(len(flips[0])):
        if any(f[i]["tables"] != flips[0][i]["tables"] for f in flips):
            raise RuntimeError(f"path (x)(b): flip {i}'s tables differ "
                               f"between ranks")
        if not all(f[i]["moved_bytes_equal_sources"] for f in flips):
            raise RuntimeError(f"path (x)(b): flip {i}: a moved slot's "
                               f"bytes are not its source's")
    if not any(f["cross_rank_moves"] for f in flips[0]):
        raise RuntimeError("path (x)(b): no slot moved between ranks")
    out["eplb"] = dict(
        config=WIDE_EPLB, prompts=WIDE_SKEW_PROMPTS, new=WIDE_SKEW_NEW,
        zipf_skew=EPLB_ZIPF, physical=res[0]["physical"],
        install=install, build_s=[b["init_s"] for b in build],
        migrations=res[0]["migrations"],
        flips=[{k: v for k, v in f.items() if k != "tables"}
               for f in flips[0]],
        flip_ms_by_rank=[[f["flip_ms"] for f in fl] for fl in flips],
        stage_ms_by_rank=[r["stage_ms"] for r in res],
        migration_bytes_sent_by_rank=[
            r["sent_bytes"] - i["sent_bytes"] for r, i in zip(res, install)],
        migration_bytes_received_by_rank=[
            r["received_bytes"] - i["received_bytes"]
            for r, i in zip(res, install)],
        tables_identical_on_every_rank=True,
        wave=res[0]["stats"], tokens_vs_eplb_off=near_tie_judge(
            toks, off_tokens, res[0]["margins"], "xs"))
    checks += pool.run(mesh_kernel_checks)[0]
    pool.run(mesh_teardown)
    out["eplb"]["seconds"] = time.perf_counter() - tb
    log(f"path (x)(b): {json.dumps(out['eplb'])}")
    # (c) P/D between two meshes on the same ranks: the consumer's own
    # prefill of wave 1 first (the yardstick), then the servers' prompts
    # one at a time on a producer as fresh as theirs, then wave 1.
    tc = time.perf_counter()
    pd = dict(build=pool.run(wide_pd_setup, free_port()))
    local = pool.run(wide_pd_local, "xp", p1, WIDE_PD_NEW)
    local_tokens = count(local, "xp local")
    alone = pool.run(wide_pd_run, "xq", p1[:WIDE_SERVER_PROMPTS],
                     MESH_SERVER_NEW, True)
    count(alone, "xq alone")
    run = pool.run(wide_pd_run, "xp", p1, WIDE_PD_NEW)
    toks = count(run, "xp P/D")
    # The witness, as path (v)(a)'s: the same prompts again, the consumer
    # replaying its own run's expert choice (the producer's prompt KV
    # comes from other kernels' rounding, and at 64 experts a one-ulp
    # router difference flips top-8 near ties): every row must keep the
    # consumer's own tokens up to a near tie.
    tape = {}
    for r in local:
        tape.update(r["tape"] or {})
    witness = pool.run(wide_pd_run, "xp", p1, WIDE_PD_NEW, False, tape)
    if any(w["tokens"] != witness[0]["tokens"] for w in witness):
        raise RuntimeError("path (x)(c) witness: the ranks' tokens differ")
    # Only a request's region's ranks write its slab, each its shard,
    # equal to the producer's bytes; the region's ranks write the same
    # slabs, and every request's slab is written.
    for res in (run, witness):
        for rank, r in enumerate(res):
            if not all(h and same and reg == rank // DP_TP
                       for reg, h, same in r["scatters"]) or \
                    r["scatters"] != res[rank // DP_TP * DP_TP]["scatters"]:
                raise RuntimeError(f"path (x)(c) rank {rank}: scatters "
                                   f"{r['scatters']}")
            if r["pins_left"]:
                raise RuntimeError(f"path (x)(c) rank {rank}: pins left")
        if sum(len(res[d * DP_TP]["scatters"]) for d in range(DP_SIZE)) \
                != len(p1):
            raise RuntimeError("path (x)(c): a request's slab was not "
                               "written")
    regions = sorted({reg for r in run for reg, _, _ in r["scatters"]})
    pd.update(requests=len(p1), new=WIDE_PD_NEW, regions_served=regions,
              scattered_bytes_equal_producer=True, pins_released=True,
              seconds_pd=run[0]["seconds"],
              free_blocks_after=run[0]["free_blocks"],
              local=local[0]["stats"],
              tokens_vs_local_prefill=token_agreement(toks, local_tokens),
              local_routing_replayed=near_tie_judge(
                  witness[0]["tokens"], local_tokens, local[0]["margins"],
                  "xp"))
    checks += pool.run(mesh_kernel_checks)[0]
    pd["peak_gib_by_rank"] = [r["peak_gib"]
                              for r in pool.run(wide_pd_teardown)]
    pd["seconds"] = time.perf_counter() - tc
    out["pd"] = pd
    log(f"path (x)(c): {json.dumps(pd)}")
    for n, per_rank in launches.items():
        if min(per_rank) == 0:
            raise RuntimeError(f"{n} never launched on a rank of path (x): "
                               f"{per_rank}")
    out["pool_s"] = time.perf_counter() - t0
    return dict(out=out, launches={n: sum(v) for n, v in launches.items()},
                checks=checks, alone=alone[0]["tokens"])


def wide_install() -> dict:
    """Rank side: the EPLB engine's installed table on this rank: its
    slots, the bytes its install sent and received, the tables."""
    eng = MESH_STATE["engine"]
    ctl = eng.eplb
    ml = eng.params["moe_layers"]
    return dict(slots=int(ml["w_gate_q"].shape[1]),
                physical=ctl.plans[0].num_physical,
                sent_bytes=ctl.sent_bytes, received_bytes=ctl.received_bytes)


def wide_servers(root: str, prompts, direct) -> dict:
    """Path (x)(d): ``python -m llm_d_tpu_torch.server.openai`` with the
    prefill recipe's flags (the producer) and the decode recipe's (the
    consumer), each at dp = 2, tp = 2 (four ranks: eight on the card);
    this process plays the routing sidecar: each prompt alone to the
    producer with ``do_remote_decode`` and one token, then to the
    consumer with the producer's params, streamed; each reply must be
    the direct pair's (``direct``).  Then SIGTERM: exit 0 and no rank
    left."""
    import signal
    procs, urls, logs = {}, {}, {}
    t0 = time.perf_counter()
    for role, flags in (("producer", wide_flags(WIDE_PREFILL_FLAGS,
                                                free_port())),
                        ("consumer", WIDE_DECODE_SERVER_FLAGS)):
        port = free_port()
        urls[role] = f"http://127.0.0.1:{port}"
        logs[role] = os.path.join(root, "build", f"wide_{role}.log")
        procs[role] = start_server(root, wide_flags(flags, port=port),
                                   f"wide_{role}.log")
    out = dict(flags=dict(producer=WIDE_PREFILL_FLAGS,
                          consumer=WIDE_DECODE_SERVER_FLAGS))
    try:
        for role, url in urls.items():
            wait_ready(procs[role], url, limit_s=600)
        out["startup_s"] = time.perf_counter() - t0
        ranks = {role: _child_pids(p.pid) for role, p in procs.items()}
        tokens = []
        for p in prompts:
            body = greedy_body(p, MESH_SERVER_NEW, True)
            pbody = dict(body, stream=False, max_tokens=1,
                         kv_transfer_params={"do_remote_decode": True})
            status, _, reply = http_call(urls["producer"], "/v1/completions",
                                         pbody)
            if status != 200 or "kv_transfer_params" not in reply:
                raise RuntimeError(f"producer: HTTP {status}: {reply}")
            res = completion(urls["consumer"], dict(
                body, kv_transfer_params=reply["kv_transfer_params"]))
            tokens.append(res["tokens"])
        if tokens != direct:
            raise RuntimeError(f"the recipe servers' replies differ from "
                               f"the direct pair's: "
                               f"{token_agreement(tokens, direct)}")
        out["replies_equal_direct"] = len(tokens)
        out["exit"] = {}
        for role, proc in procs.items():
            t_term = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=DRAIN_S + 120)
            time.sleep(1.0)
            left = [p for p in ranks[role] if _pid_alive(p)]
            out["exit"][role] = dict(code=rc, ranks=len(ranks[role]) + 1,
                                     seconds=time.perf_counter() - t_term,
                                     ranks_left=left)
            if rc != 0 or left:
                raise RuntimeError(f"the {role} exited with {rc} on "
                                   f"SIGTERM; ranks left: {left}")
    except BaseException:
        for role, path in logs.items():
            with open(path, "rb") as f:
                sys.stderr.write(f"--- {role} ---\n"
                                 + f.read()[-4000:].decode(errors="replace"))
        raise
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
            for pid in _child_pids(proc.pid):
                os.kill(pid, 9)
    out["seconds"] = time.perf_counter() - t0
    return out


# Phase 12 (path (xi)): spec decode, the fused rounds and the host tier
# on phase 10's dp mesh, every body run eagerly (gloo through the host).
# (a) wave 1 to XI_NEW new tokens with spec K = 4, one fused round a
# step, against the same engine with spec set aside (the plain mesh's
# classic steps, rank 0 taking its rows' margins); (b) everything-on:
# N = XI_EON_N rounds a dispatch, async, EPLB at ep = 4 on bench_eplb_skew's
# trace, to XI_EON_NEW new tokens (an N-round dispatch is one EPLB tick:
# the tokens give it the ticks to begin a migration and flip it); (c) the
# host tier on a pool of XI_TIER_BLOCKS blocks.
XI_NEW = 8
XI_EON_N = 4
XI_EON_NEW = 16
# Phase 11's EPLB with a move budget that stages a migration in one tick.
XI_EPLB = dict(WIDE_EPLB, move_budget=4096)
XI_TIER_BLOCKS = 16
XI_TIER_HOST = 64
XI_TIER_PROMPT = 4 * 64 + 1          # four full blocks and one token
XI_TIER_FILLERS = 4
XI_TIER_NEW = 4
# The decode recipe's whole flag set for path (x)(d)'s consumer server.
WIDE_DECODE_SERVER_FLAGS = WIDE_DECODE_FLAGS + [
    "--num-scheduler-steps", "16", "--async-scheduling"]


def xi_wave(tag: str, prompts, new: int, plain: bool = False,
            skew: bool = False, tape=None) -> dict:
    """Rank side: ``mesh_wave`` on this rank's spec engine, or with
    ``plain`` on the same engine with spec decode set aside (its classic
    steps: rank 0 takes its rows' margins, each dp shard's first tp rank
    tapes its expert choice); with ``tape`` (every shard's, merged) that
    expert choice replayed on every rank (``routing_tape``); EPLB's
    events (``wide_instrument``), bench_eplb_skew's trace recorded first
    with ``skew``; each rank's free blocks before and after."""
    import numpy as np
    eng = MESH_STATE["engine"]
    k = eng.spec_k
    free0 = eng.kv_manager.num_free_blocks
    if skew and eng.eplb is not None:
        rng = np.random.RandomState(1234)
        eng.eplb.tracker.record(rng.choice(
            eng.eplb.E, size=(eng.eplb.n_layers, 4096, 2),
            p=zipf_probs(eng.eplb.E)))
    st = wide_instrument(eng)
    margins, taped = {}, None
    if plain:
        eng.spec_k = 0
    try:
        with contextlib.ExitStack() as stack:
            if plain and eng.mesh.rank == 0:
                stack.enter_context(margin_spy(eng, margins))
            if plain and eng.mesh.coord["tp"] == 0:
                taped = {}
                stack.enter_context(routing_tape(eng, taped, replay=False))
            replayed = [0]
            if tape is not None:
                replayed = stack.enter_context(
                    routing_tape(eng, tape, replay=True))
            res = mesh_wave(tag, prompts, new)
    finally:
        eng.spec_k = k
        for mod, name, fn in st.pop("restore"):
            setattr(mod, name, fn)
    res.update(free_before=free0, free_after=eng.kv_manager.num_free_blocks,
               graphs=eng._graphs is not None, flips=st["flips"],
               stage_ms=st["stage_ms"], margins=margins or None, tape=taped,
               token_layers_replayed=replayed[0])
    if eng.eplb is not None:
        res.update(migrations=eng.eplb.num_rebalances,
                   physical=eng.eplb.plans[0].num_physical)
    stats = res["stats"]
    if stats is not None and stats.get("spec_drafted") is not None:
        stats["acceptance"] = stats["spec_accepted"] / max(
            1, stats["spec_drafted"])
        stats["tokens_a_step"] = stats["decode_tokens"] / max(
            1, stats["decode_engine_steps"]) / len(prompts)
    return res


def _sha(t) -> str:
    """A tensor's bytes' sha256."""
    import hashlib
    import torch
    return hashlib.sha256(t.contiguous().view(-1).view(torch.uint8).cpu()
                          .numpy().tobytes()).hexdigest()


def xi_tier(prompt, fillers, new: int) -> dict:
    """Rank side, path (xi)(c): ``prompt`` served (its blocks saved), again
    from the device prefix cache (the control), ``fillers`` thrash both
    regions, then ``prompt`` once more from the host tier.  Each restore
    (``secondary_lookup``) is read back on the ranks of its region, each
    buffer's rows hashed, beside the hash of rank 0's saved slab."""
    import torch
    from llm_d_tpu_torch.engine.offload import _unpack_block_slab
    eng = MESH_STATE["engine"]
    km, tier = eng.kv_manager, eng.host_tier
    bs = eng.config.block_size
    L = eng.model_config.num_layers
    restored = []
    real = km.secondary_lookup

    def lookup(h, protected=frozenset(), region=0):
        b = real(h, protected, region)
        if b is not None:
            entry = dict(block=b, region=km.region_of_block(b), rows=None)
            if entry["region"] == eng.dp_index:
                local = km.local_block_id(b)
                entry["rows"] = {
                    name: _sha(buf.view(L, -1, bs, buf.shape[2])[:, local])
                    for name, buf in eng.kv_cache.items()}
            if tier.leader:
                slab = _unpack_block_slab(tier._store[h], tier._full_layout(),
                                          L, bs)
                entry["slab"] = {n: _sha(v) for n, v in slab.items()}
            restored.append(entry)
        return b

    km.secondary_lookup = lookup
    out = dict(rank=eng.mesh.rank, dp=eng.dp_index)
    try:
        if eng.mesh.rank != 0:
            eng.follow()
        else:
            t0 = time.perf_counter()
            first, _ = run_wave(eng, [prompt], new, "xt0")
            control, _ = run_wave(eng, [prompt], new, "xt1")
            out["saves"] = tier.saves
            for i, f in enumerate(fillers):
                run_wave(eng, [f], 2, f"xf{i}")
            out.update(evictions=km.eviction_count, loads_before=tier.loads)
            again, st = run_wave(eng, [prompt], new, "xt2")
            eng.stop_mesh()
            out.update(first=first[0], control=control[0], again=again[0],
                       restore_wave=st, seconds=time.perf_counter() - t0)
    finally:
        km.secondary_lookup = real
    torch.cuda.synchronize()
    out.update(restored=restored, loads=tier.loads,
               host_blocks=tier.num_blocks)
    return out


def spec_mesh_phase(pool, p1) -> dict:
    """Phase 12 (path (xi)) on the pool's four ranks (constants above):
    (a) spec alone and (b) everything-on, each wave's tokens judged
    against the plain mesh's (equal, or first different at a near tie of
    the plain run), every rank's tokens identical and its free blocks
    back; rank 0's kernel inputs held to their plain versions before each
    teardown; (c) the host tier's restore: bytes equal to the saved slab
    on every rank of the region, tokens equal to the run before the
    thrash."""
    import numpy as np
    t0 = time.perf_counter()
    out = dict(dp=DP_SIZE, tp=DP_TP, ep=DP_SIZE * DP_TP, model=MESH_MODEL,
               spec_k=SPEC_K, bodies="eager (gloo through the host)")
    launches, checks = {}, []

    def count(res, key):
        for n in MESH_KERNELS:
            per_rank = [r["launches"][n] for r in res]
            launches.setdefault(n, [0] * MESH_WORLD)
            launches[n] = [a + b for a, b in zip(launches[n], per_rank)]
        toks = [r["tokens"] for r in res]
        if any(t != toks[0] for t in toks):
            raise RuntimeError(f"path (xi) {key}: the ranks' tokens differ")
        leaks = [(r["free_before"], r["free_after"]) for r in res
                 if r["free_after"] != r["free_before"]]
        if leaks:
            raise RuntimeError(f"path (xi) {key}: blocks leaked: {leaks}")
        if any(r["graphs"] for r in res):
            raise RuntimeError(f"path (xi) {key}: graphs on a gloo mesh")
        return toks[0]

    # (a) spec alone; the plain yardstick on the same engine first, its
    # expert choice taped.  Random weights put top-8 choices at near ties
    # that the verify rows' other rounding flips (path (iii); a spec run
    # without the replay kept 13 of 64 tokens): the spec run with the
    # plain run's routing replayed must keep the plain tokens up to a
    # near tie.
    ta = time.perf_counter()
    build = pool.run(mesh_setup, MESH_MODEL, MESH_KERNELS, path="xi spec",
                     mesh=dp_mesh(), spec_k=SPEC_K)
    plain = pool.run(xi_wave, "xa", p1, XI_EON_NEW, True)
    plain_tokens = count(plain, "plain")
    margins = plain[0]["margins"] or {}
    tape = {}
    for r in plain:
        tape.update(r["tape"] or {})
    plain_launches = {n: list(v) for n, v in launches.items()}
    launches.clear()
    ref = [t[:XI_NEW] for t in plain_tokens]
    res = pool.run(xi_wave, "xa", p1, XI_NEW, False, False, tape)
    toks = count(res, "spec, plain routing replayed")
    out["spec"] = dict(
        build_s=[b["init_s"] for b in build], plain=plain[0]["stats"],
        wave=res[0]["stats"], new=XI_NEW,
        plain_routing_replayed=dict(
            near_tie_judge(toks, ref, margins, "xa"),
            token_layers_replayed=[r["token_layers_replayed"] for r in res]),
        free_blocks_by_rank=[r["free_after"] for r in res])
    if min(r["token_layers_replayed"] for r in res) == 0:
        raise RuntimeError("path (xi)(a): the replay replayed nothing")
    checks += pool.run(mesh_kernel_checks)[0]
    out["spec"]["peak_gib_by_rank"] = [r["peak_gib"]
                                       for r in pool.run(mesh_teardown)]
    out["spec"]["seconds"] = time.perf_counter() - ta
    log(f"path (xi)(a): {json.dumps(out['spec'])}")
    # (b) everything-on with EPLB at ep = 4, the plain run's routing
    # replayed (the judge as (a)'s witness); EPLB records the replayed ids.
    tb = time.perf_counter()
    build = pool.run(mesh_setup, MESH_MODEL, MESH_KERNELS, path="xi eon",
                     mesh=dp_mesh(), spec_k=SPEC_K,
                     num_scheduler_steps=XI_EON_N, async_scheduling=True,
                     enable_eplb=True, eplb_config=dict(XI_EPLB))
    res = pool.run(xi_wave, "xa", p1, XI_EON_NEW, False, True, tape)
    toks = count(res, "everything-on")
    flips = [r["flips"] for r in res]
    if not flips[0] or any(len(f) != len(flips[0]) for f in flips):
        raise RuntimeError(f"path (xi)(b): flips by rank "
                           f"{[len(f) for f in flips]}")
    for i in range(len(flips[0])):
        if any(f[i]["tables"] != flips[0][i]["tables"] for f in flips):
            raise RuntimeError(f"path (xi)(b): flip {i}'s tables differ "
                               f"between ranks")
        if not all(f[i]["moved_bytes_equal_sources"] for f in flips):
            raise RuntimeError(f"path (xi)(b): flip {i}: a moved slot's "
                               f"bytes are not its source's")
    out["everything_on"] = dict(
        build_s=[b["init_s"] for b in build], N=XI_EON_N, new=XI_EON_NEW,
        eplb=XI_EPLB, physical=res[0]["physical"],
        migrations=res[0]["migrations"],
        flips=[{k: v for k, v in f.items() if k != "tables"}
               for f in flips[0]],
        stage_ms_by_rank=[r["stage_ms"] for r in res],
        wave=res[0]["stats"],
        plain_routing_replayed=dict(
            near_tie_judge(toks, plain_tokens, margins, "xa"),
            token_layers_replayed=[r["token_layers_replayed"] for r in res]),
        free_blocks_by_rank=[r["free_after"] for r in res])
    checks += pool.run(mesh_kernel_checks)[0]
    out["everything_on"]["peak_gib_by_rank"] = [
        r["peak_gib"] for r in pool.run(mesh_teardown)]
    out["everything_on"]["seconds"] = time.perf_counter() - tb
    log(f"path (xi)(b): {json.dumps(out['everything_on'])}")
    for n, per_rank in launches.items():
        if min(per_rank) == 0:
            raise RuntimeError(f"{n} never launched on a rank of path (xi) "
                               f"(a)-(b): {per_rank}")
    # (c) the host tier.
    tc = time.perf_counter()
    pool.run(mesh_setup, MESH_MODEL, MESH_KERNELS, record=False,
             path="xi tier", mesh=dp_mesh(), num_blocks=XI_TIER_BLOCKS,
             kv_offload_blocks=XI_TIER_HOST, enable_prefix_caching=True)
    rng = np.random.default_rng(12)
    vocab = mesh_config(MESH_MODEL).vocab_size
    prompt = rng.integers(1, vocab, XI_TIER_PROMPT).tolist()
    fillers = [rng.integers(1, vocab, XI_TIER_PROMPT).tolist()
               for _ in range(XI_TIER_FILLERS)]
    tier = pool.run(xi_tier, prompt, fillers, XI_TIER_NEW)
    lead = tier[0]
    if not lead["evictions"] or lead["loads"] <= lead["loads_before"]:
        raise RuntimeError(f"path (xi)(c): no restore: {lead['evictions']} "
                           f"evictions, loads {lead['loads_before']} -> "
                           f"{lead['loads']}")
    if any(len(t["restored"]) != len(lead["restored"]) for t in tier):
        raise RuntimeError("path (xi)(c): the ranks restored differently")
    equal = 0
    for t in tier:
        for e, e0 in zip(t["restored"], lead["restored"]):
            if (e["block"], e["region"]) != (e0["block"], e0["region"]):
                raise RuntimeError(f"path (xi)(c): rank {t['rank']} "
                                   f"restored {e}, rank 0 {e0}")
            if e["region"] != t["dp"]:
                continue
            if e["rows"] != e0["slab"]:
                raise RuntimeError(f"path (xi)(c): rank {t['rank']}'s "
                                   f"restored rows differ from the slab")
            equal += 1
    if lead["again"] != lead["control"]:
        raise RuntimeError(f"path (xi)(c): restored tokens "
                           f"{lead['again']} != {lead['control']}")
    out["tier"] = dict(
        blocks=XI_TIER_BLOCKS, host_blocks=XI_TIER_HOST,
        prompt=XI_TIER_PROMPT, fillers=XI_TIER_FILLERS,
        saves=lead["saves"], evictions=lead["evictions"],
        loads=lead["loads"] - lead["loads_before"],
        restored_blocks=len(lead["restored"]),
        regions=sorted({e["region"] for e in lead["restored"]}),
        restored_shards_equal_slab=equal,
        tokens_equal_before_thrash=lead["again"] == lead["control"],
        tokens_equal_first_run=lead["again"] == lead["first"],
        restore_wave=lead["restore_wave"], seconds_scenario=lead["seconds"])
    out["tier"]["peak_gib_by_rank"] = [r["peak_gib"]
                                       for r in pool.run(mesh_teardown)]
    out["tier"]["seconds"] = time.perf_counter() - tc
    log(f"path (xi)(c): {json.dumps(out['tier'])}")
    out["plain_launches"] = {n: sum(v) for n, v in plain_launches.items()}
    out["pool_s"] = time.perf_counter() - t0
    return dict(out=out, launches={n: sum(v) for n, v in launches.items()},
                checks=checks)


def mesh_path(root: str, smi: str) -> tuple:
    """Phase 9, path (viii): ``MESH_TP`` rank processes on the card (a
    ``RankPool``; the backend the rule picks) serve deepseek-v3-bench at
    full width and depth, tp = ep = 4: wave 1 (A and B at 4 heads, E on
    the received rows), and wave 1 again on the bf16 wire and with the
    psum dispatch.  Every rank's
    tokens identical; the wires against each other on one MoE layer
    (2% rel-RMS); each recorded kernel input against its plain version;
    each rank's peak; ``collective_bytes_total`` beside the bytes the
    collectives moved.  Then the 2-layer check against the one-rank
    engine (with and without the routing replayed), the tp server, the
    qwen3-30b-a3b witness (wave 1 and one 8192-token prefill: G at one
    KV head, H, E), and the one-rank classic loop's wave 1 at full depth
    against the mesh's (with and without the routing replayed).  Phase
    10 (path (ix)) shares the pool and the one-rank engine: its pool
    part (``dp_pool_phase``) runs after the witness, its server after
    phase 9's, its one-rank comparison and the DP group
    (``dp_group_check``) after phase 9's.  Phase 11 (path (x)) runs on
    the pool after phase 10 (``wide_pool_phase``), its servers after
    phase 10's (``wide_servers``).  Phase 12 (path (xi)) runs on the pool
    after phase 11 (``spec_mesh_phase``).  Returns (result, launches by
    kernel, per-kernel checks, path (ix)'s {out, launches, checks}, path
    (x)'s {out, launches, checks, alone}, path (xi)'s {out, launches,
    checks})."""
    import numpy as np
    import torch
    from llm_d_tpu_torch.parallel.launch import RankPool
    t_path = time.perf_counter()
    rng = np.random.default_rng(0)
    vocab = mesh_config(MESH_MODEL).vocab_size
    p1 = prompts_for(rng, vocab, WAVE1)
    prompts_for(rng, vocab, WAVE2)
    p3 = prompts_for(rng, vocab, WAVE3)
    out = dict(card=smi, tp=MESH_TP, ep=MESH_TP, model=MESH_MODEL,
               steps="classic (gloo collectives are not capturable)")
    launches, checks = {}, []
    pool = RankPool(MESH_TP, device=None, threads=2, timeout_s=900)
    try:
        t0 = time.perf_counter()
        out["build"] = pool.run(mesh_setup, MESH_MODEL, MESH_KERNELS)
        out["build_s"] = time.perf_counter() - t0
        b0 = out["build"][0]
        out["backend"] = b0["backend"]
        out["transport"] = ("gloo, every collective staged through host "
                            "memory (the ranks share one card)"
                            if b0["staged_through_host"] else b0["backend"])
        log(f"mesh: {MESH_TP} ranks on {out['transport']}, build "
            f"{json.dumps(out['build'])}")
        waves = {}
        for tag, prompts, new, env, tape in (
                ("m1", p1, MESH_W1_NEW, None, True),
                ("m1bf16", p1, MESH_SIDE_NEW,
                 {"LLMD_COLLECTIVE_DTYPE": "bf16"}, False),
                ("m1psum", p1, MESH_SIDE_NEW, {"LLMD_MOE_DISPATCH": "psum"},
                 False)):
            res = pool.run(mesh_wave, tag, prompts, new, env, tape)
            toks = [r["tokens"] for r in res]
            if any(t != toks[0] for t in toks):
                raise RuntimeError(f"mesh wave {tag}: the ranks' tokens "
                                   f"differ")
            waves[tag] = dict(res[0]["stats"], env=env,
                              launches_by_rank=[r["launches"] for r in res],
                              wire_bytes_by_rank=[r["wire_bytes"]
                                                  for r in res],
                              ranks_identical=True,
                              timing="gloo through the host, classic "
                                     "steps")
            waves[tag]["tokens"] = toks[0]
            if tape:
                waves[tag]["tape"] = res[0]["tape"]
            log(f"mesh wave {tag}: {json.dumps(res[0]['stats'])}, "
                f"launches {json.dumps(res[0]['launches'])}")
        main_runs = ("m1",)
        for n in MESH_KERNELS:
            per_rank = [sum(waves[w]["launches_by_rank"][r][n]
                            for w in main_runs) for r in range(MESH_TP)]
            if min(per_rank) == 0:
                raise RuntimeError(f"{n} never launched on a rank of path "
                                   f"(viii): {per_rank}")
            launches[n] = sum(per_rank)
        tok1 = waves["m1"]["tokens"]
        head = [t[:MESH_SIDE_NEW] for t in tok1]
        out["wire_tokens"] = dict(
            bf16_wire=token_agreement(waves["m1bf16"]["tokens"], head),
            psum=token_agreement(waves["m1psum"]["tokens"], head))
        t0 = time.perf_counter()
        alone = pool.run(mesh_alone, p1[:MESH_SERVER_PROMPTS],
                         MESH_SERVER_NEW)
        if any(a != alone[0] for a in alone):
            raise RuntimeError("mesh alone: the ranks' tokens differ")
        out["alone_s"] = time.perf_counter() - t0
        wires = pool.run(mesh_wires, 256, 256)
        out["wires_rel_rms_vs_a2a_bf16"] = wires[0]
        if any(w != wires[0] for w in wires):
            raise RuntimeError("mesh wires: the ranks' outputs differ")
        bad = {k: v for k, v in wires[0].items() if v > 2e-2}
        if bad:
            raise RuntimeError(f"mesh wires past 2% rel-RMS: {bad}")
        log(f"mesh wires: {json.dumps(wires[0])}")
        checks = pool.run(mesh_kernel_checks)[0]
        m = pool.run(mesh_metrics)
        out["collective_bytes"] = dict(
            counter=m[0]["counter"],
            wire_bytes_by_rank=[r["wire_bytes"] for r in m],
            note="the counter is the JAX byte model (routed rows); the "
                 "fixed-region exchange ships each region whole")
        out["peak_gib_by_rank"] = [r["peak_gib"]
                                   for r in pool.run(mesh_teardown)]
        log(f"mesh: peaks {out['peak_gib_by_rank']}, collective bytes "
            f"{json.dumps(out['collective_bytes'])}")
        # The first two layers against the one-rank engine.
        t0 = time.perf_counter()
        tp2 = pool.run(mesh_two_layer, [100, 37], 27)[0]
        out["reference"] = [mesh_reference(tp2, replay)
                            for replay in (False, True)]
        out["reference_s"] = time.perf_counter() - t0
        log(f"mesh reference: {json.dumps(out['reference'])}")
        ref = out["reference"][1]
        if not ref["top1_agree"] or ref["rel_max_err"] > 5e-2:
            raise RuntimeError(f"the mesh disagrees with the one-rank "
                               f"engine: {ref}")
        # The witness: qwen3-30b-a3b at tp = ep = 4.
        t0 = time.perf_counter()
        wvocab = mesh_config(MESH_WITNESS).vocab_size
        wrng = np.random.default_rng(7)
        w1 = prompts_for(wrng, wvocab, WAVE1)
        w3 = prompts_for(wrng, wvocab, dict(WAVE3, new=1))
        full = mesh_config(MESH_WITNESS).num_layers
        wit = dict(model=MESH_WITNESS, layers=MESH_WITNESS_LAYERS,
                   reduced=f"num_layers {full} -> {MESH_WITNESS_LAYERS}, "
                           f"wave 1 to {MESH_W1_NEW} new tokens: the "
                           "smoke's time limit (each decode step of 48 "
                           "layers is ~2.4 s over gloo)")
        wit["build"] = pool.run(mesh_setup, MESH_WITNESS,
                                MESH_WITNESS_KERNELS,
                                layers=MESH_WITNESS_LAYERS)
        wit["waves"] = {}
        wl = {}
        for tag, prompts, new in (("q1", w1, MESH_W1_NEW), ("q3", w3, 1)):
            res = pool.run(mesh_wave, tag, prompts, new)
            if any(r["tokens"] != res[0]["tokens"] for r in res):
                raise RuntimeError(f"witness wave {tag}: the ranks' "
                                   f"tokens differ")
            wit["waves"][tag] = dict(res[0]["stats"], ranks_identical=True)
            for n in MESH_WITNESS_KERNELS:
                wl[n] = wl.get(n, 0) + sum(r["launches"][n] for r in res)
            log(f"mesh witness {tag}: {json.dumps(res[0]['stats'])}")
        missing = [n for n, c in wl.items() if c == 0]
        if missing:
            raise RuntimeError(f"kernels never launched on the mesh "
                               f"witness: {missing}")
        wit["launches"] = wl
        wit_checks = pool.run(mesh_kernel_checks)[0]
        for c in wit_checks:
            c["witness"] = True
        checks += wit_checks
        wit["peak_gib_by_rank"] = [r["peak_gib"]
                                   for r in pool.run(mesh_teardown)]
        wit["seconds"] = time.perf_counter() - t0
        out["witness"] = wit
        log(f"mesh witness: {json.dumps({k: v for k, v in wit.items() if k != 'waves'})}")
        out["seconds_pool"] = time.perf_counter() - t_path
        # Phase 10, path (ix): the dp mesh on the same ranks.
        dp = dp_pool_phase(pool, p1, p3)
        # Phase 11, path (x): the wide-EP recipe on the dp mesh.
        wide = wide_pool_phase(pool, p1, p3, {
            k: dp["waves"][k]["tokens"] for k in ("d1", "d3")})
        # Phase 12, path (xi): spec decode, the fused rounds and the host
        # tier on the dp mesh.
        xi = spec_mesh_phase(pool, p1)
    finally:
        pool.close()
    gc.collect()
    torch.cuda.empty_cache()
    # The servers, with the ranks of the pool gone.
    t0 = time.perf_counter()
    out["server"] = mesh_server(root, p1[:MESH_SERVER_PROMPTS], alone[0])
    out["server"]["seconds"] = time.perf_counter() - t0
    log(f"mesh server: {json.dumps(out['server'])}")
    dpo = dp["out"]
    t0 = time.perf_counter()
    dpo["server"] = mesh_server(root, p1[:MESH_SERVER_PROMPTS], dp["alone"],
                                layout=DP_LAYOUT,
                                log_name="dp_server.log")
    dpo["server"]["seconds"] = time.perf_counter() - t0
    log(f"dp server: {json.dumps(dpo['server'])}")
    wo = wide["out"]
    wo["servers"] = wide_servers(root, p1[:WIDE_SERVER_PROMPTS],
                                 wide["alone"])
    log(f"path (x)(d): {json.dumps(wo['servers'])}")
    # The one-rank classic loop's wave 1 at full depth on the same
    # weights, without and with the mesh's routing replayed.
    t0 = time.perf_counter()
    one = path_i_engine(1, model=MESH_MODEL)
    tape = waves["m1"].pop("tape")
    alone, _ = run_wave(one, p1, MESH_W1_NEW, "m1")
    with routing_tape(one, tape, replay=True) as replayed:
        again, _ = run_wave(one, p1, MESH_W1_NEW, "m1")
    out["one_rank_tokens"] = dict(
        own_routing=token_agreement(tok1, alone),
        mesh_routing_replayed=dict(token_agreement(tok1, again),
                                   token_layers_replayed=replayed[0]))
    out["one_rank_s"] = time.perf_counter() - t0
    log(f"mesh vs one rank: {json.dumps(out['one_rank_tokens'])}")
    # Path (ix)'s wave 1 against the one-rank loop, without and with the
    # dp mesh's routing replayed; then the DP group on the same weights.
    t0 = time.perf_counter()
    dtok = dp["waves"]["d1"].pop("tokens")
    with routing_tape(one, dp["tape"], replay=True) as replayed:
        dagain, _ = run_wave(one, p1, MESH_W1_NEW, "d1")
    dpo["one_rank_tokens"] = dict(
        own_routing=token_agreement(dtok, alone),
        mesh_routing_replayed=dict(token_agreement(dtok, dagain),
                                   token_layers_replayed=replayed[0]))
    dpo["one_rank_s"] = time.perf_counter() - t0
    log(f"dp vs one rank: {json.dumps(dpo['one_rank_tokens'])}")
    dpo["group"] = dp_group_check(one, p1, MESH_W1_NEW)
    log(f"dp group: {json.dumps(dpo['group'])}")
    del one
    gc.collect()
    torch.cuda.empty_cache()
    for w in waves.values():
        w.pop("tokens", None)
    out["waves"] = waves
    dp["waves"]["d3"].pop("tokens", None)
    dpo["waves"] = dp["waves"]
    out["seconds"] = time.perf_counter() - t_path
    dpo["card"] = wo["card"] = xi["out"]["card"] = smi
    return out, launches, checks, dict(out=dpo, launches=dp["launches"],
                                       checks=dp["checks"],
                                       alone=dp["alone"]), wide, xi



# Phase 13, path (xii): multi-host data parallelism in ranks mode, two
# hosts on the one card (each its own process and engine; the leader's
# engine in this process in (a)): deepseek-v3-bench at full width and
# depth in path (i)'s configuration, classic steps (a captured block would
# only add capture time here).
MH_FLAGS = MESH_SERVER_FLAGS + ["--host", "127.0.0.1"]
MH_RANKS = ["--data-parallel-mode", "ranks", "--data-parallel-size", "2",
            "--data-parallel-size-local", "1"]
MH_NEW = 16                 # new tokens of a request
MH_STREAM_NEW = 32          # of the second prompt's requests (the killed
#                             stream and its yardsticks)
MH_LONG = 1024              # a prompt whose prefill passes 512 tokens (E)
MH_KILL_AFTER = 2           # token chunks before the worker's SIGKILL
MH_KERNELS = ("mla_decode", "mla_prefill", "moe_dense_int8",
              "moe_routed_int8", "moe_streamed_int8")
MH_LOGS = {"a_worker": "mh_worker.log", "b_leader": "mh_leader.log",
           "b_worker": "mh_b_worker.log",
           "h_leader": "mh_hybrid_leader.log",
           "h_worker": "mh_hybrid_worker.log"}


def mh_metric(m: dict, name: str) -> float:
    """The sum of ``name``'s labelled samples in a parsed scrape."""
    return sum(v for k, v in m.items() if k.startswith(name + "{"))


def mh_settled(pool, what: str) -> list:
    """After an exchange: every worker's slot settled (the leader's
    finally runs just after the client has read the reply's end)."""
    deadline = time.monotonic() + 10
    while any(w["inflight"] for w in pool.workers) \
            and time.monotonic() < deadline:
        time.sleep(0.02)
    state = [dict(inflight=w["inflight"], dispatching=len(w["dispatching"]),
                  depth=w["depth"]) for w in pool.workers]
    if any(st["inflight"] or st["dispatching"] or st["depth"] < 0
           for st in state):
        raise RuntimeError(f"path (xii) {what}: the pool's slots are not "
                           f"settled: {state}")
    return state


@contextlib.contextmanager
def mh_forced(pool, worker: int):
    """The pool's pick forced to its ``worker``-th worker inside the
    block (an idle leader serves locally otherwise)."""
    pool.pick = lambda engine: pool.workers[worker]
    try:
        yield
    finally:
        del pool.pick


def mh_leader_exchanges(lurl, server, worker_proc, p0, p1, long_p,
                        yardstick) -> dict:
    """Phase 13(a) through the in-process leader at ``lurl``: (1) ``p0``
    alone, served locally (nothing dispatched); (2) ``p0`` forced to the
    worker, its tokens equal (1)'s; (3) a whole reply forced remote after
    the worker's depth was set stale (99): the reply carries the depth,
    the pool takes it; (4) ``long_p`` locally (its prefill launches E);
    (5) ``p1`` locally (the served, uninterrupted run); (6) ``p1`` forced
    remote, the worker SIGKILLed after ``MH_KILL_AFTER`` token chunks:
    the stream must end with [DONE], continuous, its tokens equal to
    ``yardstick``'s (the leader engine's uninterrupted classic run) or
    first different at a near tie; the leader counts the resume and its
    recovery.  The pool's slots are settled after each exchange."""
    import signal
    from llm_d_tpu_torch.server.stream_resume import verify_continuity
    from llm_d_tpu_torch.utils.lifecycle import SCHED_DEPTH_HEADER
    pool = server.dp_pool
    w = pool.workers[0]
    out = {}
    seq = w["seq"]
    t0 = time.perf_counter()
    local0 = completion(lurl, greedy_body(p0, MH_NEW, True))
    if w["seq"] != seq:
        raise RuntimeError("path (xii): an idle leader dispatched p0")
    out["local_s"] = time.perf_counter() - t0
    with mh_forced(pool, 0):
        t0 = time.perf_counter()
        remote0 = completion(lurl, greedy_body(p0, MH_NEW, True))
        out["remote_s"] = time.perf_counter() - t0
    out["after_remote"] = mh_settled(pool, "remote")
    if remote0["tokens"] != local0["tokens"] or w["seq"] != seq + 1:
        raise RuntimeError(f"path (xii): the remote reply differs from the "
                           f"local one: {remote0['tokens']} against "
                           f"{local0['tokens']}")
    w["depth"] = 99
    with mh_forced(pool, 0):
        status, headers, reply = http_call(
            lurl, "/v1/completions", greedy_body(p0, MH_NEW, False))
    out["after_whole"] = mh_settled(pool, "whole")
    depth = headers.get(SCHED_DEPTH_HEADER)
    if status != 200 or depth is None or w["depth"] >= 99 \
            or reply["usage"]["completion_tokens"] != MH_NEW:
        raise RuntimeError(f"path (xii): the depth report: HTTP {status}, "
                           f"header {depth}, pool depth {w['depth']}")
    out["depth_reported"] = int(depth)
    long_r = completion(lurl, greedy_body(long_p, MH_NEW, True))
    local1 = completion(lurl, greedy_body(p1, MH_STREAM_NEW, True))
    for r in (long_r, local1):
        if r["finish"] != "length":
            raise RuntimeError(f"path (xii): a local reply ended by "
                               f"{r['finish']}")
    ref, _, margins, bars = yardstick
    out["served_equal_yardstick"] = local1["tokens"] == ref[0]

    def kill(n):
        if n == MH_KILL_AFTER:
            worker_proc.send_signal(signal.SIGKILL)

    seq = w["seq"]
    with mh_forced(pool, 0):
        t0 = time.perf_counter()
        metas, done = sse_stream(lurl, greedy_body(p1, MH_STREAM_NEW, True),
                                 on_frame=kill)
        out["killed_stream_s"] = time.perf_counter() - t0
    out["worker_rc"] = worker_proc.wait(timeout=60)
    out["after_kill"] = mh_settled(pool, "kill")
    got = [t for m in metas for t in m["tok"]]
    problems = verify_continuity(metas, MH_STREAM_NEW)
    srcs = [m["src"] for m in metas if "src" in m]
    if not done or problems or len(srcs) != 1 or w["seq"] != seq + 1:
        raise RuntimeError(f"path (xii): the killed stream: done {done}, "
                           f"{problems}, src {srcs}")
    div = divergence([got], ref, margins, bars)
    at = div["first_divergence_per_row"][0]
    if at < len(got) and not margins[at][0] <= bars[at][0]:
        raise RuntimeError(f"path (xii): the resumed stream differs from "
                           f"the uninterrupted run at {at}, where the "
                           f"top-2 margin {margins[at][0]} is no near tie "
                           f"(bar {bars[at][0]})")
    m = scrape(lurl)
    resumes = mh_metric(m, "llmd_tpu:stream_resume_total")
    n_rec = mh_metric(m, "llmd_tpu:request_recovery_seconds_count")
    rec_s = mh_metric(m, "llmd_tpu:request_recovery_seconds_sum")
    if resumes < 1 or n_rec < 1:
        raise RuntimeError(f"path (xii): the leader counted {resumes} "
                           f"resumes, {n_rec} recoveries")
    out.update(
        resume_src=srcs[0], resume_chunk_offset=next(
            mm["off"] for mm in metas if "src" in mm),
        stream_resume_total=resumes, recoveries=n_rec,
        recovery_s=rec_s / n_rec, tokens=len(got),
        vs_uninterrupted=div,
        worker_backed_off=w["down_until"] > time.monotonic())
    return dict(out, p0_tokens=local0["tokens"], p1_tokens=local1["tokens"])


def mh_entry_points(root, procs, url, want) -> dict:
    """Phase 13(b): both hosts as entry points, this process the client.
    The pair (the leader with ``--data-parallel-workers``): ``p0`` to the
    leader, then ``p1`` to the leader once it is busy (proxied, the
    worker less loaded); each reply's tokens equal (a)'s (``want``), each
    host's /metrics shows one request served.  Then the hybrid-lb pair:
    each host its own request at once, served where it was sent (the
    leader has no pool).  SIGTERM: every process exits 0."""
    from concurrent.futures import ThreadPoolExecutor
    import signal
    (p0, tok0), (p1, tok1) = want
    out = {}
    for tag, lead, work, hybrid in (("pair", "b_leader", "b_worker", False),
                                    ("hybrid_lb", "h_leader", "h_worker",
                                     True)):
        t0 = time.perf_counter()
        res = dict(ready_after_s=[wait_ready(procs[n], url[n])
                                  for n in (work, lead)])
        t1 = time.perf_counter()
        with ThreadPoolExecutor(2) as ex:
            first = ex.submit(completion, url[lead],
                              greedy_body(p0, MH_NEW, True))
            if not hybrid:
                # The leader is busy once p0 is in its scheduler.
                deadline = time.monotonic() + 60
                while time.monotonic() < deadline:
                    m = scrape(url[lead])
                    if mh_metric(m, "vllm:num_requests_running") \
                            + mh_metric(m, "vllm:num_requests_waiting") >= 1:
                        break
                    time.sleep(0.01)
            second = ex.submit(completion, url[work if hybrid else lead],
                               greedy_body(p1, MH_STREAM_NEW, True))
            r0, r1 = first.result(), second.result()
        res["requests_s"] = time.perf_counter() - t1
        if r0["tokens"] != tok0 or r1["tokens"] != tok1:
            raise RuntimeError(f"path (xii)(b) {tag}: the replies differ "
                               f"from (a)'s direct ones")
        served = [mh_metric(scrape(url[n]), "vllm:request_success_total")
                  for n in (lead, work)]
        if served != [1, 1]:
            raise RuntimeError(f"path (xii)(b) {tag}: requests served by "
                               f"leader and worker {served}, want [1, 1]")
        for n in (lead, work):
            procs[n].send_signal(signal.SIGTERM)
        res["exit_codes"] = [procs[n].wait(timeout=DRAIN_S + 60)
                             for n in (lead, work)]
        if res["exit_codes"] != [0, 0]:
            raise RuntimeError(f"path (xii)(b) {tag}: exit codes "
                               f"{res['exit_codes']}")
        with open(os.path.join(root, "build", MH_LOGS[lead]),
                  errors="replace") as f:
            text = f.read()
        pooled = "DP leader dispatching across 1 worker hosts" in text
        if pooled == hybrid or ("hybrid-lb" in text) != hybrid:
            raise RuntimeError(f"path (xii)(b) {tag}: the leader's pool "
                               f"attached: {pooled}")
        res.update(served_by_leader_worker=served, leader_pool=pooled,
                   proxied=0 if hybrid else 1,
                   seconds=time.perf_counter() - t0)
        out[tag] = res
        log(f"path (xii)(b) {tag}: {json.dumps(res)}")
    return out


def multihost_path(root: str, smi: str) -> tuple:
    """Phase 13, path (xii): multi-host DP in ranks mode
    (``--data-parallel-size 2 --data-parallel-size-local 1``), every host
    started at once: (a) the leader in this process, built by the entry
    point's own ``server_from_args`` (``DPEngineGroup(dp_size=1,
    start_rank=0)`` with a ``DPWorkerPool`` on one worker host, the entry
    point with ``--data-parallel-start-rank 1``; both from seed 0), its
    kernel inputs recorded and its launches counted
    (``mh_leader_exchanges``); (b) two pairs of entry points, the second
    with ``--data-parallel-hybrid-lb`` (``mh_entry_points``).  The
    yardstick of the killed stream is an engine of the leader's
    configuration and weights without prefix caching (the leader's
    uninterrupted classic run, margins taped).  Returns (result, launches
    by kernel, per-kernel checks against the plain versions)."""
    import dataclasses
    import numpy as np
    import torch
    from llm_d_tpu_torch.engine import EngineCore
    from llm_d_tpu_torch.server import openai as srv
    t_path = time.perf_counter()
    ports = {n: free_port() for n in MH_LOGS}
    url = {n: f"http://127.0.0.1:{p}" for n, p in ports.items()}
    argv = {"a_worker": ["--data-parallel-start-rank", "1"],
            "b_worker": ["--data-parallel-start-rank", "1"],
            "b_leader": ["--data-parallel-workers", url["b_worker"]],
            "h_worker": ["--data-parallel-start-rank", "1",
                         "--data-parallel-hybrid-lb"],
            "h_leader": ["--data-parallel-hybrid-lb",
                         "--data-parallel-workers", url["h_worker"]]}
    out = dict(card=smi, model=MH_FLAGS[MH_FLAGS.index("--model") + 1],
               layout="--data-parallel-mode ranks --data-parallel-size 2 "
                      "--data-parallel-size-local 1: two hosts of one "
                      "rank each, sharing the card",
               steps="classic", new_tokens=[MH_NEW, MH_STREAM_NEW],
               long_prompt=MH_LONG)
    procs = {}
    try:
        for n in ("a_worker", "b_worker", "b_leader", "h_worker",
                  "h_leader"):
            procs[n] = start_server(
                root, [*MH_FLAGS, *MH_RANKS, "--port", str(ports[n]),
                       *argv[n]], MH_LOGS[n])
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        p = srv.build_arg_parser()
        args = p.parse_args([*MH_FLAGS, *MH_RANKS,
                             "--data-parallel-start-rank", "0",
                             "--data-parallel-workers", url["a_worker"]])
        srv.check_served(p, args)
        srv.check_mesh_flags(p, args)
        server = srv.server_from_args(args)
        group, pool = server.engine, server.dp_pool
        if pool is None or group.start_rank != 0 or len(group.engines) != 1:
            raise RuntimeError("path (xii): the leader was not wired as "
                               "one rank with a worker pool")
        eng = group.engines[0]
        out["leader_build_s"] = time.perf_counter() - t0
        vocab = eng.model_config.vocab_size
        rng = np.random.default_rng(13)
        p0, p1 = prompts_for(rng, vocab, dict(WAVE1, n=2))
        long_p = rng.integers(1, vocab, MH_LONG).tolist()
        t0 = time.perf_counter()
        yard = EngineCore(dataclasses.replace(
            eng.config, enable_prefix_caching=False), params=eng.params)
        yardstick = classic_margins(yard, [p1], MH_STREAM_NEW)
        del yard
        out["yardstick_s"] = time.perf_counter() - t0
        note_live_tokens(eng)
        MESH_STATE.clear()
        MESH_STATE.update(recs={}, names=MH_KERNELS)
        mesh_record([eng], MH_KERNELS, "xii")
        _mesh_reset(MH_KERNELS)
        t0 = time.perf_counter()
        out["worker_ready_after_s"] = wait_ready(procs["a_worker"],
                                                 url["a_worker"])
        lurl, close = serve_in_thread(server)
        try:
            a = mh_leader_exchanges(lurl, server, procs["a_worker"], p0, p1,
                                    long_p, yardstick)
        finally:
            close()
        launches = _mesh_launches(MH_KERNELS)
        torch.cuda.synchronize()
        out["leader_peak_gib"] = \
            torch.cuda.max_memory_allocated(eng.device) / 2**30
        want = [(p0, a.pop("p0_tokens")), (p1, a.pop("p1_tokens"))]
        a["seconds"] = time.perf_counter() - t0
        out["a"] = a
        log(f"path (xii)(a): {json.dumps(a)}, launches "
            f"{json.dumps(launches)}")
        missing = [n for n, c in launches.items() if c == 0]
        if missing:
            raise RuntimeError(f"kernels never launched by the leader of "
                               f"path (xii): {missing}")
        t0 = time.perf_counter()
        checks = mesh_kernel_checks(notes=True)
        out["checks_s"] = time.perf_counter() - t0
        MESH_STATE.clear()
        del server, group, pool, eng
        gc.collect()
        torch.cuda.empty_cache()
        out["b"] = mh_entry_points(root, procs, url, want)
    except BaseException:
        for n, name in MH_LOGS.items():
            path = os.path.join(root, "build", name)
            if os.path.exists(path):
                with open(path, "rb") as f:
                    sys.stderr.write(f"--- {name}\n" + f.read()[-3000:]
                                     .decode(errors="replace"))
        raise
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    out["seconds"] = time.perf_counter() - t_path
    return out, launches, checks


# Phase 14, path (xiii): the port's mesh as far as JAX's.  (a) One spmd
# mesh across the hosts of a LeaderWorkerSet group: two entry points with
# phase 10's dp server flags and LWS_LEADER_ADDRESS / LWS_GROUP_SIZE=2 /
# LWS_WORKER_INDEX on loopback, two ranks each, all sharing the card over
# gloo.  (b) deepseek-v3-bench at full width and depth (16 layers) on a
# MeshConfig(sp=2, tp=2) engine of four ranks, classic steps.  (c) Ring
# attention on the same ranks.  (d) The int8-latent absorption report on
# rows a bf16-latent engine wrote.
LWS_LOGS = {"leader": "lws_leader.log", "worker": "lws_worker.log"}
SP_MESH = (1, 2, 2)                  # (dp, sp, tp)
SP_NEW = 2                           # wave 1's new tokens on the sp mesh
RING_SHAPE = dict(T=8192, H=16, KVH=16, D=128)
RING_MESHES = {"sp4": (1, 4, 1), "sp2-tp2": (1, 2, 2)}
ABSORB_LAYERS = 2
ABSORB_RTOL = 1e-3                   # the card's report against the CPU's


def sp_mesh():
    from llm_d_tpu_torch.parallel.mesh import MeshConfig
    return MeshConfig(*SP_MESH)


def lws_start(root: str) -> dict:
    """Phase 14(a)'s start: the leader and the worker host of an LWS
    group as entry points (``MESH_SERVER_FLAGS`` + ``DP_LAYOUT``, logs
    build/lws_leader.log and build/lws_worker.log), started at once and
    left to build while (b) and (c) run."""
    leader_port = free_port()
    ports = {n: free_port() for n in LWS_LOGS}
    procs = {}
    for i, n in enumerate(LWS_LOGS):
        procs[n] = start_server(
            root, [*MESH_SERVER_FLAGS, *DP_LAYOUT, "--host", "127.0.0.1",
                   "--port", str(ports[n])], LWS_LOGS[n],
            env={"LWS_LEADER_ADDRESS": f"127.0.0.1:{leader_port}",
                 "LWS_GROUP_SIZE": "2", "LWS_WORKER_INDEX": str(i)})
    return dict(procs=procs, t0=time.perf_counter(),
                url={n: f"http://127.0.0.1:{p}" for n, p in ports.items()})


def lws_stop(started: dict) -> None:
    for p in started["procs"].values():
        if p.poll() is None:
            p.kill()
            p.wait(timeout=60)
        for c in _child_pids(p.pid):
            os.kill(c, 9)


def lws_group(root: str, started: dict, prompts, direct) -> dict:
    """Phase 14(a) on the entry points ``lws_start`` started: both ready;
    ``prompts`` to the leader one at a time (``MESH_SERVER_NEW`` greedy
    tokens, streamed): each reply's tokens equal ``direct`` (phase 10's
    dp engine, each prompt alone); the worker answers /health and
    /v1/models and refuses a completion (404); SIGTERM to the leader:
    both exit 0 with no rank left.  Each rank logs its kernel launches as
    it stops: A, B and E must have launched on all four."""
    import re
    import signal
    procs, url, t0 = started["procs"], started["url"], started["t0"]
    try:
        waited = time.perf_counter()
        out = dict(flags=[*DP_LAYOUT], hosts=2,
                   ready_wait_s=[wait_ready(procs[n], url[n], limit_s=600)
                                 for n in LWS_LOGS],
                   started_before_s=waited - t0)
        ranks = {n: _child_pids(procs[n].pid) for n in LWS_LOGS}
        out["rank_processes"] = {n: len(r) + (n == "leader")
                                 for n, r in ranks.items()}
        if out["rank_processes"] != {"leader": 2, "worker": 2}:
            raise RuntimeError(f"path (xiii)(a): rank processes "
                               f"{out['rank_processes']}, want 2 a host")
        t1 = time.perf_counter()
        got = [completion(url["leader"],
                          greedy_body(p, MESH_SERVER_NEW, True))["tokens"]
               for p in prompts]
        out["serve_s"] = time.perf_counter() - t1
        if got != direct:
            raise RuntimeError(f"path (xiii)(a): the leader's replies "
                               f"differ from the direct dp engine's: "
                               f"{token_agreement(got, direct)}")
        out["replies_equal_direct"] = True
        probes = {p: http_call(url["worker"], p)[0]
                  for p in ("/health", "/v1/models")}
        refused = http_call(url["worker"], "/v1/completions",
                            greedy_body(prompts[0], 1, False))[0]
        if probes != {"/health": 200, "/v1/models": 200} or refused != 404:
            raise RuntimeError(f"path (xiii)(a): the worker answered "
                               f"{probes}, a completion with {refused}")
        out.update(worker_probes=probes, worker_completion_status=refused)
        t_term = time.perf_counter()
        procs["leader"].send_signal(signal.SIGTERM)
        out["exit_codes"] = [procs[n].wait(timeout=DRAIN_S + 120)
                             for n in LWS_LOGS]
        out["exit_s"] = time.perf_counter() - t_term
        time.sleep(1.0)
        left = [p for r in ranks.values() for p in r if _pid_alive(p)]
        if out["exit_codes"] != [0, 0] or left:
            raise RuntimeError(f"path (xiii)(a): after SIGTERM exit codes "
                               f"{out['exit_codes']}, ranks left {left}")
        by_rank = {}
        for n in LWS_LOGS:
            with open(os.path.join(root, "build", LWS_LOGS[n]),
                      errors="replace") as f:
                for m in re.finditer(r"mesh rank (\d+) stopped: kernel "
                                     r"launches (\{.*\})", f.read()):
                    by_rank[int(m.group(1))] = json.loads(m.group(2))
        wrappers = {n: MESH_WRAPPERS[n][1] for n in MESH_KERNELS}
        launches = {n: [by_rank.get(r, {}).get(w, 0) for r in range(4)]
                    for n, w in wrappers.items()}
        if sorted(by_rank) != [0, 1, 2, 3] or \
                min(min(v) for v in launches.values()) == 0:
            raise RuntimeError(f"path (xiii)(a): kernel launches by rank "
                               f"{launches} (ranks logged "
                               f"{sorted(by_rank)})")
        out["launches_by_rank"] = launches
    except BaseException:
        for n in procs:
            with open(os.path.join(root, "build", LWS_LOGS[n]), "rb") as f:
                sys.stderr.write(f"--- {LWS_LOGS[n]}\n")
                sys.stderr.write(f.read()[-6000:].decode(errors="replace"))
        raise
    finally:
        lws_stop(started)
    out["seconds"] = time.perf_counter() - t0
    return out


def ring_rank(label: str, causal: bool, seed: int, iters: int = 3) -> dict:
    """Rank side of phase 14(c): the full ``RING_SHAPE`` q, k, v from
    ``seed`` (bf16, the same on every rank), this rank's ``P(sp, tp,
    None)`` shards through ``ring_attention`` on a ``RING_MESHES[label]``
    mesh of the pool's ranks (one untimed call, then ``iters`` timed),
    held to ``attention_reference_dense`` on its rows and heads (computed
    a head at a time) at 3e-2."""
    import torch
    import torch.distributed as dist
    from llm_d_tpu_torch.ops.ring_attention import (
        attention_reference_dense, ring_attention, shard_qkv)
    from llm_d_tpu_torch.parallel.mesh import Mesh, MeshConfig
    from llm_d_tpu_torch.utils.device import resolve_device
    dev = resolve_device(None, dist.get_rank())
    mesh = Mesh.from_process_group(MeshConfig(*RING_MESHES[label]), dev)
    T, H, KVH, D = (RING_SHAPE[k] for k in ("T", "H", "KVH", "D"))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, k, v = (torch.randn((T, h, D), generator=gen, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)
               for h in (H, KVH, KVH))
    parts = [shard_qkv(x, mesh) for x in (q, k, v)]
    out = ring_attention(*parts, mesh, causal=causal)
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = ring_attention(*parts, mesh, causal=causal)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / iters * 1e3
    Tl, Hl = out.shape[0], out.shape[1]
    r0, h0 = mesh.coord["sp"] * Tl, mesh.coord["tp"] * Hl
    G = H // KVH
    err = 0.0
    for h in range(h0, h0 + Hl, G):
        kv = h // G
        ref = attention_reference_dense(q[:, h:h + G], k[:, kv:kv + 1],
                                         v[:, kv:kv + 1], causal=causal)
        got = out[:, h - h0:h - h0 + G]
        want = ref[r0:r0 + Tl]
        torch.testing.assert_close(got.float(), want.float(), atol=3e-2,
                                   rtol=3e-2)
        err = max(err, float((got.float() - want.float()).abs().max()))
        del ref
    res = dict(mesh=label, causal=causal, rank=mesh.rank,
               rows=list(parts[0].shape), ms=ms, max_abs_err=err,
               ring_bytes=mesh.wire_bytes.get("ring_shift", 0) // (iters + 1),
               backend=mesh.backend, staged_through_host=mesh.stage_host)
    del q, k, v, parts, out
    torch.cuda.empty_cache()
    return res


def sp_pool_phase(pool, p1) -> dict:
    """Phase 14(b) and (c) on a pool of four ranks: deepseek-v3-bench at
    ``MeshConfig(sp=2, tp=2)``, full width and depth, classic steps: each
    rank's KV plane (the whole pool: attention is replicated over sp) and
    routed-expert bytes (a quarter), wave 1 to ``SP_NEW`` new tokens
    (every rank's tokens identical, A, B and E launching on every rank),
    each recorded rank-local kernel input against its plain version, the
    2-layer check against the one-rank engine with and without the sp
    mesh's routing replayed; then ring attention at sp = 4 and sp = 2 x
    tp = 2, causal and not."""
    t0 = time.perf_counter()
    mc = mesh_config(MESH_MODEL)
    dp, sp, tp = SP_MESH
    out = dict(dp=dp, sp=sp, tp=tp, ep=dp * sp * tp, model=MESH_MODEL,
               layers=mc.num_layers,
               steps="classic (gloo collectives are not capturable)")
    out["build"] = pool.run(mesh_setup, MESH_MODEL, MESH_KERNELS,
                            path="xiii", mesh=sp_mesh())
    out["build_s"] = time.perf_counter() - t0
    total = _expert_total_bytes(mc)
    for b in out["build"]:
        want_kv = [mc.num_layers, b["pool_slots"],
                   -(-(mc.kv_lora_rank + mc.qk_rope_head_dim) // 128) * 128]
        if b["kv_planes"]["kv"] != want_kv or \
                b["expert_bytes"] * dp * sp * tp != total:
            raise RuntimeError(f"sp rank {b['rank']}: KV plane "
                               f"{b['kv_planes']['kv']} (want {want_kv}), "
                               f"{b['expert_bytes']} expert bytes (want "
                               f"{total} / {dp * sp * tp})")
    res = pool.run(mesh_wave, "s1", p1, SP_NEW, None, True)
    toks = [r["tokens"] for r in res]
    if any(t != toks[0] for t in toks):
        raise RuntimeError("sp wave s1: the ranks' tokens differ")
    out["wave"] = dict(res[0]["stats"], ranks_identical=True,
                       launches_by_rank=[r["launches"] for r in res],
                       wire_bytes_by_rank=[r["wire_bytes"] for r in res],
                       peak_gib_by_rank=[r["peak_gib"] for r in res],
                       timing="gloo through the host, classic steps")
    launches = {}
    for n in MESH_KERNELS:
        per_rank = [r["launches"][n] for r in res]
        if min(per_rank) == 0:
            raise RuntimeError(f"{n} never launched on a rank of path "
                               f"(xiii)(b): {per_rank}")
        launches[n] = sum(per_rank)
    log(f"sp wave s1: {json.dumps(res[0]['stats'])}, launches "
        f"{json.dumps([r['launches'] for r in res])}")
    checks = pool.run(mesh_kernel_checks)[0]
    pool.run(mesh_teardown)
    t1 = time.perf_counter()
    two = pool.run(mesh_two_layer, [100, 37], 27, mesh=sp_mesh())[0]
    out["reference"] = [mesh_reference(two, replay)
                        for replay in (False, True)]
    out["reference_s"] = time.perf_counter() - t1
    log(f"sp reference: {json.dumps(out['reference'])}")
    for ref in out["reference"]:
        if not ref["top1_agree"] or ref["rel_max_err"] > 5e-2:
            raise RuntimeError(f"the sp mesh disagrees with the one-rank "
                               f"engine: {ref}")
    out["mesh_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    ring = []
    for i, (label, causal) in enumerate(
            (lb, c) for lb in RING_MESHES for c in (True, False)):
        by_rank = pool.run(ring_rank, label, causal, 100 + i)
        ring.append(dict(mesh=label, causal=causal, shape=RING_SHAPE,
                         ms_by_rank=[r["ms"] for r in by_rank],
                         max_abs_err=max(r["max_abs_err"] for r in by_rank),
                         rows_by_rank=[r["rows"] for r in by_rank],
                         ring_bytes_by_rank=[r["ring_bytes"]
                                             for r in by_rank],
                         timing="perf_counter around 3 calls after one "
                                "untimed, gloo through the host"))
        log(f"ring {label} causal={causal}: {json.dumps(ring[-1])}")
    out["ring"] = dict(cases=ring, tolerance=3e-2,
                       seconds=time.perf_counter() - t1)
    return dict(out=out, launches=launches, checks=checks)


def absorption_check(p1) -> dict:
    """Phase 14(d): a bf16-latent deepseek-v3-bench engine of
    ``ABSORB_LAYERS`` layers (seed 0) serves wave 1 (``MESH_W1_NEW`` new
    tokens); the latent rows it wrote, and its first MoE layer's absorbed
    queries of 8 hidden rows from a seed, through
    ``absorption_error_report`` on the card and on the CPU: the two
    reports' numbers equal at ``ABSORB_RTOL``; ``within_bounds`` is
    reported, not required (a miss is a finding)."""
    import torch
    from llm_d_tpu_torch.ops import mla_accuracy as acc
    t0 = time.perf_counter()
    eng = path_i_engine(1, model_config=mesh_config(MESH_MODEL,
                                                    ABSORB_LAYERS),
                        kv_cache_dtype="bf16")
    if eng.kv_cache["kv"].dtype != torch.bfloat16:
        raise RuntimeError("path (xiii)(d): the latent is not bf16")
    run_wave(eng, p1, MESH_W1_NEW, "ab")
    mc = eng.model_config
    rows = acc.harvest_latent_rows(eng)
    lp = {k: v[0] for k, v in eng.params["moe_layers"].items()}
    gen = torch.Generator(device=eng.device)
    gen.manual_seed(0)
    x = torch.randn((8, mc.hidden_size), generator=gen, device=eng.device
                    ).to(torch.bfloat16)
    pos = torch.arange(8, dtype=torch.int32, device=eng.device)
    q_eff, w_uv = acc.absorbed_queries(lp, mc, x, pos)
    scale = (mc.qk_nope_head_dim + mc.qk_rope_head_dim) ** -0.5
    card = acc.absorption_error_report(rows, q_eff, w_uv, mc.kv_lora_rank,
                                       scale=scale)
    cpu = acc.absorption_error_report(rows.cpu(), q_eff.cpu(), w_uv.cpu(),
                                      mc.kv_lora_rank, scale=scale)
    del eng
    for term in ("score", "value", "end_to_end"):
        for key in ("max_abs", "rel_rms"):
            a, b = card[term][key], cpu[term][key]
            if abs(a - b) > ABSORB_RTOL * abs(b):
                raise RuntimeError(f"path (xiii)(d): {term} {key} on the "
                                   f"card {a}, on the CPU {b}")
    return dict(layers=ABSORB_LAYERS, rows=card["rows"],
                row_width=int(rows.shape[1]), card=card, cpu=cpu,
                within_bounds=card["within_bounds"], rtol=ABSORB_RTOL,
                seconds=time.perf_counter() - t0)


def lws_sp_path(root: str, smi: str, dp_alone, hosts_gone=None) -> tuple:
    """Phase 14, path (xiii), after phase 13: (a)'s entry points start
    (``lws_start``) and build while (b) and (c) run ``sp_pool_phase`` on a
    fresh pool of four ranks (eight ranks share the card meanwhile); then
    (a) ``lws_group`` against phase 10's one-at-a-time tokens
    ``dp_alone``, once the pool is gone; ``hosts_gone()``, where given,
    once (a)'s hosts have exited; (d) ``absorption_check``.
    Returns (result, launches by kernel: (b)'s waves on every rank plus
    (a)'s ranks' logged counts, (b)'s per-kernel checks against the plain
    versions)."""
    import numpy as np
    import torch
    from llm_d_tpu_torch.parallel.launch import RankPool
    t_path = time.perf_counter()
    rng = np.random.default_rng(0)
    p1 = prompts_for(rng, mesh_config(MESH_MODEL).vocab_size, WAVE1)
    out = dict(card=smi)
    started = lws_start(root)
    try:
        pool = RankPool(MESH_WORLD, device=None, threads=2, timeout_s=900)
        try:
            sp = sp_pool_phase(pool, p1)
        finally:
            pool.close()
    except BaseException:
        lws_stop(started)
        raise
    gc.collect()
    torch.cuda.empty_cache()
    out["sp"] = sp["out"]
    log(f"path (xiii)(b), (c): {json.dumps(out['sp'])}")
    out["lws"] = lws_group(root, started, p1[:MESH_SERVER_PROMPTS], dp_alone)
    log(f"path (xiii)(a): {json.dumps(out['lws'])}")
    if hosts_gone is not None:
        hosts_gone()
    out["absorption"] = absorption_check(p1)
    log(f"path (xiii)(d): {json.dumps(out['absorption'])}")
    launches = dict(sp["launches"])
    for n, per_rank in out["lws"]["launches_by_rank"].items():
        launches[n] = launches.get(n, 0) + sum(per_rank)
    out["seconds"] = time.perf_counter() - t_path
    return out, launches, sp["checks"]



# Phase 15, path (xiv): the tiered-prefix-cache recipe
# (deploy/tiered-prefix-cache/modelserver.yaml) on two port meshes: two
# entry points with the recipe's flags, each the other's shared-tier peer
# by a dns: spec, qwen3-32b at its published widths on tp = 4 (eight ranks
# share the card over gloo), both under LLMD_STEP_TIME_TARGET_MS.  Each
# pod is ``chip_smoke.py --tier-pod``: the entry point's own ``main`` with
# the preset cut to XIV_LAYERS (random weights from the seed; the spawned
# ranks import this file as their main module and cut it too), rank 0
# recording G's and H's inputs and, once the server has stopped, holding
# them to their plain versions.
XIV_MODEL = "qwen3-32b"
XIV_LAYERS = 8                      # of 64: the time limit
XIV_TP = 4                          # the recipe's tp = 8: one card
XIV_HOST_BLOCKS = 256               # the recipe's 41000 (1 MiB a block)
XIV_DEVICE_BLOCKS = 512             # the entry point's 2048 (memory)
XIV_BLOCK = 32                      # the entry point's block size
XIV_BATCH = 2048                    # its max_num_batched_tokens
XIV_PROMPT = 32 * XIV_BLOCK + 16   # (a): 32 full blocks and 16 tokens
XIV_NEW = 4
XIV_TRAIN = dict(prompt=512, new=16)   # (b): B's step-time model trains
XIV_LONG = 4096                     # (c)
XIV_TARGET_MS = 1500                # LLMD_STEP_TIME_TARGET_MS of both pods
XIV_NEAR_TIE = 0.1                  # top-2 logprob gap (nats) of a near tie
XIV_KERNELS = ("paged_decode", "flash_prefill")
XIV_LOGS = {"a": "tier_a.log", "b": "tier_b.log"}
DEPTH_ENV = "LLMD_SMOKE_DEPTH"


def xiv_start(root: str) -> dict:
    """Phase 15's start: pods A and B (logs build/tier_a.log and
    build/tier_b.log, results build/tier_*.json), each in a process group
    of its own, left to build."""
    ports = {n: free_port() for n in XIV_LOGS}
    tier = {n: free_port() for n in XIV_LOGS}
    events = importable("zmq", "msgpack")
    procs, results = {}, {}
    for n, other in (("a", "b"), ("b", "a")):
        flags = ["--model", XIV_MODEL,
                 "--tensor-parallel-size", str(XIV_TP),
                 "--kv-offload-blocks", str(XIV_HOST_BLOCKS),
                 "--kv-shared-tier-port", str(tier[n]),
                 "--kv-shared-tier-peers", f"dns:localhost:{tier[other]}",
                 "--pod-identity", f"127.0.0.1:{ports[n]}",
                 "--host", "127.0.0.1", "--port", str(ports[n]),
                 "--num-blocks", str(XIV_DEVICE_BLOCKS)]
        if events:
            flags += ["--kv-events-endpoint",
                      f"tcp://127.0.0.1:{free_port()}"]
        results[n] = os.path.join(root, "build", f"tier_{n}.json")
        if os.path.exists(results[n]):
            os.remove(results[n])
        log_path = os.path.join(root, "build", XIV_LOGS[n])
        os.makedirs(os.path.dirname(log_path), exist_ok=True)
        with open(log_path, "wb") as log_f:
            procs[n] = subprocess.Popen(
                [sys.executable, os.path.join(root, "chip_smoke.py"),
                 "--tier-pod", results[n], *flags],
                cwd=root, stdout=log_f, stderr=subprocess.STDOUT,
                start_new_session=True,
                env=dict(os.environ, LLMD_DRAIN_TIMEOUT_S=str(DRAIN_S),
                         LLMD_STEP_TIME_TARGET_MS=str(XIV_TARGET_MS),
                         **{DEPTH_ENV: f"{XIV_MODEL}={XIV_LAYERS}"}))
    return dict(procs=procs, results=results, tier=tier, events=events,
                t0=time.perf_counter(),
                url={n: f"http://127.0.0.1:{p}" for n, p in ports.items()})


def xiv_stop(started: dict) -> None:
    import signal
    for p in started["procs"].values():
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait(timeout=60)


def _cut_depth() -> None:
    """With ``LLMD_SMOKE_DEPTH=<model>=<layers>`` set (phase 15's pods and
    the ranks they spawn), the model's preset cut to that depth."""
    spec = os.environ.get(DEPTH_ENV)
    if not spec:
        return
    import dataclasses
    from llm_d_tpu_torch.models import config as model_configs
    name, layers = spec.split("=")
    model_configs.PRESETS[name] = dataclasses.replace(
        model_configs.PRESETS[name], num_layers=int(layers))


_cut_depth()


def xiv_pod_main(argv) -> int:
    """One pod of phase 15 (``chip_smoke.py --tier-pod RESULT FLAGS``): the
    entry point's ``main(FLAGS)`` with G's and H's first inputs of each
    label recorded on rank 0; after the server stops, those inputs against
    the plain versions (skipped on the CPU, where the wrappers ran their
    plain versions), written to RESULT.  Exits with the server's code, or
    1 when a check failed."""
    import torch
    from llm_d_tpu_torch.server import openai as srv
    result_path, flags = argv[0], argv[1:]
    MESH_STATE.clear()
    MESH_STATE.update(recs={}, names=XIV_KERNELS)
    mesh_record([], XIV_KERNELS, "xiv")
    code = 0
    try:
        srv.main(flags)
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
    out = dict(server_exit=code, labels={
        n: sorted(r.calls) for n, r in MESH_STATE["recs"].items()})
    if code == 0 and torch.cuda.is_available():
        out["rank0_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        try:
            out["checks"] = mesh_kernel_checks()
        except Exception as e:                  # reported to the smoke
            out["error"] = repr(e)
            code = 1
    with open(result_path, "w") as f:
        json.dump(out, f)
    return code


def xiv_tie(url: dict, prompt, new: int) -> dict:
    """Both pods' top-2 logprob gaps at each of ``new`` greedy tokens of
    ``prompt`` (a whole reply with ``logprobs`` = 2)."""
    gaps = {}
    for n, u in url.items():
        status, _, reply = http_call(u, "/v1/completions", dict(
            greedy_body(prompt, new, False), logprobs=2))
        if status != 200:
            raise RuntimeError(f"path (xiv): logprobs: HTTP {status}")
        tops = reply["choices"][0]["logprobs"]["top_logprobs"]
        gaps[n] = [None if len(t) < 2 else
                   float(sorted(t.values())[-1] - sorted(t.values())[-2])
                   for t in tops]
    return gaps


def xiv_log_lines(root: str, name: str, pattern: str) -> list:
    import re
    with open(os.path.join(root, "build", XIV_LOGS[name]),
              errors="replace") as f:
        return re.findall(pattern, f.read())


def xiv_run(root: str, started: dict) -> dict:
    """Phase 15's checks on the pods ``xiv_start`` started: (a) a prompt
    of 32 full blocks to A, then to B: B's shared-tier hits count them,
    B's tokens equal A's (or differ first at a near tie, both gaps
    reported), both TTFTs; (b) A SIGKILLed, a new prompt to B: served by
    recompute, A's address backed off after one failure (its log), B's
    step-time model trained by the request's steps; (c) a 4096-token
    prompt to B; SIGTERM: B exits 0, its four ranks logged the same
    prefill chunk sequence and their kernel launches, and rank 0's G and H
    inputs held to their plain versions (build/tier_b.json)."""
    import signal
    import numpy as np
    from llm_d_tpu_torch.models.config import get_config
    procs, url, tier = started["procs"], started["url"], started["tier"]
    t0 = time.perf_counter()
    out = dict(model=XIV_MODEL, layers=XIV_LAYERS, tp=XIV_TP,
               host_blocks=XIV_HOST_BLOCKS,
               device_blocks=XIV_DEVICE_BLOCKS,
               step_time_target_ms=XIV_TARGET_MS,
               kv_events=started["events"],
               peers={n: f"dns:localhost:{tier[o]}"
                      for n, o in (("a", "b"), ("b", "a"))})
    out["ready_wait_s"] = [wait_ready(procs[n], url[n], limit_s=600)
                           for n in XIV_LOGS]
    out["started_before_s"] = t0 - started["t0"]
    out["card_memory_used"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    ranks = {n: _child_pids(procs[n].pid) for n in XIV_LOGS}
    out["rank_processes"] = {n: len(r) + 1 for n, r in ranks.items()}
    if out["rank_processes"] != {"a": XIV_TP, "b": XIV_TP}:
        raise RuntimeError(f"path (xiv): rank processes "
                           f"{out['rank_processes']}, want {XIV_TP} a pod")
    vocab = get_config(XIV_MODEL).vocab_size
    rng = np.random.default_rng(15)
    prompt = rng.integers(1, vocab, XIV_PROMPT).tolist()
    # (a) A prefills; B pulls A's blocks.
    full = (XIV_PROMPT - 1) // XIV_BLOCK
    hits0 = mh_metric(scrape(url["b"]), "llmd_tpu:kv_shared_tier_hits_total")
    got = {n: completion(url[n], greedy_body(prompt, XIV_NEW, True))
           for n in ("a", "b")}
    m_b = scrape(url["b"])
    hits = mh_metric(m_b, "llmd_tpu:kv_shared_tier_hits_total") - hits0
    a = dict(prompt=XIV_PROMPT, full_blocks=full, new=XIV_NEW,
             b_shared_tier_hits=hits,
             b_restored_blocks=mh_metric(
                 m_b, "llmd_tpu:kv_offload_loaded_blocks_total"),
             ttft_s={n: r["t_first"] - r["t_send"] for n, r in got.items()},
             seconds={n: r["t_end"] - r["t_send"] for n, r in got.items()},
             tokens=got["a"]["tokens"])
    if hits < full:
        raise RuntimeError(f"path (xiv)(a): B counted {hits} shared-tier "
                           f"hits for a prompt of {full} full blocks")
    if got["b"]["tokens"] != got["a"]["tokens"]:
        i = next(k for k, (x, y) in enumerate(zip(got["a"]["tokens"],
                                                  got["b"]["tokens"]))
                 if x != y)
        gaps = xiv_tie(url, prompt, i + 1)
        a.update(first_difference=i, b_tokens=got["b"]["tokens"],
                 gap={n: g[i] for n, g in gaps.items()})
        if min(g for g in a["gap"].values() if g is not None) \
                > XIV_NEAR_TIE:
            raise RuntimeError(f"path (xiv)(a): B's tokens differ from A's "
                               f"at {i} outside a near tie: {a}")
    a["tokens_equal"] = got["b"]["tokens"] == got["a"]["tokens"]
    out["a"] = a
    log(f"path (xiv)(a): {json.dumps(a)}")
    # (b) A dies; B recomputes a new prompt and backs A off.
    refused = (rf"shared-tier peer 127\.0\.0\.1:{tier['a']} failed "
               r"\(unreachable, backing off\)")
    before = len(xiv_log_lines(root, "b", refused))
    os.killpg(procs["a"].pid, signal.SIGKILL)
    procs["a"].wait(timeout=60)
    misses0 = mh_metric(scrape(url["b"]),
                        "llmd_tpu:kv_shared_tier_misses_total")
    p2 = rng.integers(1, vocab, XIV_TRAIN["prompt"]).tolist()
    r2 = completion(url["b"], greedy_body(p2, XIV_TRAIN["new"], True))
    m_b = scrape(url["b"])
    b = dict(prompt=XIV_TRAIN["prompt"], new=XIV_TRAIN["new"],
             tokens=r2["n"], seconds=r2["t_end"] - r2["t_send"],
             ttft_s=r2["t_first"] - r2["t_send"],
             b_misses=mh_metric(m_b, "llmd_tpu:kv_shared_tier_misses_total")
             - misses0,
             a_backoffs=len(xiv_log_lines(root, "b", refused)) - before,
             ipv6_peer_backoffs=len(xiv_log_lines(
                 root, "b", r"shared-tier peer \[::1\]:\d+ failed "
                            r"\(unreachable, backing off\)")))
    out["b"] = b
    log(f"path (xiv)(b): {json.dumps(b)}")
    if r2["n"] != XIV_TRAIN["new"] or r2["finish"] != "length" \
            or b["a_backoffs"] != 1 or b["b_misses"] < 1:
        raise RuntimeError(f"path (xiv)(b): {b}")
    # (c) A long prompt once B's step-time model has trained.
    p3 = rng.integers(1, vocab, XIV_LONG).tolist()
    r3 = completion(url["b"], greedy_body(p3, 2, True))
    c = dict(prompt=XIV_LONG, seconds=r3["t_end"] - r3["t_send"],
             ttft_s=r3["t_first"] - r3["t_send"], tokens=r3["n"])
    t_term = time.perf_counter()
    procs["b"].send_signal(signal.SIGTERM)
    out["b_exit_code"] = procs["b"].wait(timeout=DRAIN_S + 300)
    out["b_exit_s"] = time.perf_counter() - t_term
    time.sleep(1.0)
    left = [p for r in ranks.values() for p in r if _pid_alive(p)]
    if out["b_exit_code"] != 0 or left:
        raise RuntimeError(f"path (xiv): B exited with "
                           f"{out['b_exit_code']}, ranks left {left}")
    chunks = {int(r): json.loads(v) for r, v in xiv_log_lines(
        root, "b", r"mesh rank (\d+) prefill chunks (\[.*\])")}
    # (c)'s steps: the last chunks, summing to its prompt.
    steps, total = 0, 0
    for n in reversed(chunks.get(0, [])):
        if total >= XIV_LONG:
            break
        steps, total = steps + 1, total + n
    c.update(chunks_by_rank=chunks, chunks=chunks.get(0), steps=steps,
             capped=steps > -(-XIV_LONG // XIV_BATCH))
    out["c"] = c
    log(f"path (xiv)(c): {json.dumps(c)}")
    if sorted(chunks) != list(range(XIV_TP)) or any(
            v != chunks[0] for v in chunks.values()):
        raise RuntimeError(f"path (xiv)(c): the ranks' prefill chunks "
                           f"differ: {chunks}")
    by_rank = {int(r): json.loads(v) for r, v in xiv_log_lines(
        root, "b", r"mesh rank (\d+) stopped: kernel launches (\{.*\})")}
    launches = {n: [by_rank.get(r, {}).get(MESH_WRAPPERS[n][1], 0)
                    for r in range(XIV_TP)] for n in XIV_KERNELS}
    if min(min(v) for v in launches.values()) == 0:
        raise RuntimeError(f"path (xiv)(d): kernel launches by rank "
                           f"{launches}")
    with open(started["results"]["b"]) as f:
        pod = json.load(f)
    if pod.get("error") or not pod.get("checks"):
        raise RuntimeError(f"path (xiv)(d): rank 0's checks: {pod}")
    out["d"] = dict(launches_by_rank=launches, labels=pod["labels"],
                    rank0_peak_gib=pod.get("rank0_peak_gib"))
    out["seconds"] = time.perf_counter() - t0
    return dict(out=out, launches={n: sum(v) for n, v in launches.items()},
                checks=pod["checks"])


def xiv_path(root: str, started: dict) -> tuple:
    """Phase 15, path (xiv), after phase 14: ``xiv_run`` on the pods
    ``xiv_start`` started before it; the pods' logs go to stderr if it
    fails.  Returns (result, launches by kernel summed over B's ranks,
    rank 0's per-kernel checks)."""
    try:
        res = xiv_run(root, started)
    except BaseException:
        for n, name in XIV_LOGS.items():
            path = os.path.join(root, "build", name)
            if os.path.exists(path):
                with open(path, "rb") as f:
                    sys.stderr.write(f"--- {name}\n" + f.read()[-6000:]
                                     .decode(errors="replace"))
        raise
    finally:
        xiv_stop(started)
    return res["out"], res["launches"], res["checks"]


# Phase 16, path (xv): the inference-scheduling recipe
# (deploy/inference-scheduling/{gateway,modelserver}.yaml) and the
# pd-disaggregation recipe (deploy/pd-disaggregation/pd.yaml) end to end on
# the port's own EPP gateway (``python -m llm_d_tpu_torch.epp.service``) and
# routing sidecar (``python -m llm_d_tpu_torch.sidecar.proxy``), each entry
# point given its container's args and environment as the recipe file
# writes them (the EPP configs read from the recipes' ConfigMaps), with the
# cuts below.  Every model server is ``chip_smoke.py --gw-pod``: the entry
# point's own ``main``, its kernel launches (and, where it records, G's and
# H's first inputs of each shape class held to their plain versions after
# it stops) written to build/xv_<pod>.json.  All eight processes start at
# the phase's start, so their builds overlap.
XV_MODEL = "qwen3-0.6b"             # the inference-scheduling recipe's
XV_BLOCK = 64                       # the EPP profiles' blockSize
XV_DEVICE_BLOCKS = 256              # (a) the entry point's 2048 (memory)
XV_PD_DEVICE_BLOCKS = 512           # (b) the same, at 32-token blocks
XV_OFFLOAD_BLOCKS = 512             # (a) the recipe's 4096 (host memory)
XV_GROUPS, XV_GROUP = 4, 4          # (a) prefix groups, requests a group
XV_PREFIX, XV_OWN, XV_NEW = 1024, 64, 16
XV_STREAM = dict(prompt=512, new=32, kill_after=8, inflight=3, after=2)
XV_ROUNDS, XV_PROBE = 8, 128        # (a) overhead rounds, probe prompt
XV_PD = dict(prompts=8, prompt=1024, new=16)
XV_NEAR_TIE = XIV_NEAR_TIE
XV_KERNELS = XIV_KERNELS
XV_RECORD = ("a1", "a2", "c")       # the pods that record G's and H's inputs
XV_EXTRA = []                       # every model server's extra flags
XV_RECIPES = dict(
    sched_gw="deploy/inference-scheduling/gateway.yaml",
    sched_ms="deploy/inference-scheduling/modelserver.yaml",
    pd="deploy/pd-disaggregation/pd.yaml")


def xv_docs(root: str, rel: str) -> list:
    import yaml
    with open(os.path.join(root, rel)) as f:
        return [d for d in yaml.safe_load_all(f) if d]


def xv_container(root: str, rel: str, deployment: str, container: str):
    """(args, env) of ``container`` in ``deployment`` of a recipe file
    (env entries with a literal value)."""
    dep = next(d for d in xv_docs(root, rel) if d.get("kind") ==
               "Deployment" and d["metadata"]["name"] == deployment)
    c = next(c for c in dep["spec"]["template"]["spec"]["containers"]
             if c["name"] == container)
    return ([str(a) for a in c.get("args", [])],
            {e["name"]: str(e["value"]) for e in c.get("env", [])
             if "value" in e})


def xv_configmap(root: str, rel: str, key: str) -> str:
    return next(d for d in xv_docs(root, rel)
                if d.get("kind") == "ConfigMap")["data"][key]


def xv_flags(args, sub: dict, add=()) -> list:
    """``args`` with each flag of ``sub`` given its value there (a flag the
    recipe lacks raises: the recipe drifted), then ``add``."""
    out = list(args)
    for flag, val in sub.items():
        out[out.index(flag) + 1] = str(val)
    return out + [str(a) for a in add]


def xv_label(name: str):
    """G's and H's recording labels: a shape class each (G: one row or
    several; H: a prompt's whole prefill or a short tail), so a pod keeps
    at most four copies of its stacked cache."""
    if name == "flash_prefill":
        return lambda a, kw: ("xv prefill Q>256" if a[0].shape[1] > 256
                              else "xv prefill Q<=256")
    return lambda a, kw: ("xv decode S=1" if a[0].shape[0] == 1
                          else "xv decode S>1")


def xv_start(root: str) -> dict:
    """Phase 16's start: (a)'s two model servers and gateway, (b)'s two
    producers, consumer, sidecar and gateway, each in a process group of
    its own (logs build/xv_*.log)."""
    ports = {n: free_port() for n in ("a1", "a2", "ga", "p1", "p2", "c",
                                      "side", "gb", "kv1", "kv2")}
    kv_bind = f"tcp://127.0.0.1:{free_port()}"
    url = {n: f"http://127.0.0.1:{ports[n]}" for n in ports}
    build = os.path.join(root, "build")
    os.makedirs(build, exist_ok=True)
    procs, results = {}, {}
    started = dict(procs=procs, results=results, url=url, ports=ports,
                   t0=time.perf_counter())

    def spawn(name, cmd, env):
        with open(os.path.join(build, f"xv_{name}.log"), "wb") as f:
            procs[name] = subprocess.Popen(
                cmd, cwd=root, stdout=f, stderr=subprocess.STDOUT,
                start_new_session=True, env=dict(os.environ, **env))

    def pod(name, flags, env):
        results[name] = os.path.join(build, f"xv_{name}.json")
        if os.path.exists(results[name]):
            os.remove(results[name])
        spawn(name, [sys.executable, os.path.join(root, "chip_smoke.py"),
                     "--gw-pod", results[name],
                     "1" if name in XV_RECORD else "0",
                     *flags, *XV_EXTRA], env)

    try:
        _xv_spawn_all(root, build, ports, url, kv_bind, spawn, pod)
    except BaseException:
        xv_stop(started)
        raise
    return started


def _xv_spawn_all(root, build, ports, url, kv_bind, spawn, pod) -> None:
    # (a) the inference-scheduling recipe.
    args, env = xv_container(root, XV_RECIPES["sched_ms"],
                             "ms-inference-scheduling", "vllm")
    for n in ("a1", "a2"):
        pod(n, xv_flags(args, {
            "--model": XV_MODEL, "--port": ports[n],
            "--kv-offload-blocks": XV_OFFLOAD_BLOCKS,
            "--kv-events-endpoint": kv_bind,
            "--pod-identity": f"127.0.0.1:{ports[n]}"},
            ["--host", "127.0.0.1", "--block-size", XV_BLOCK,
             "--num-blocks", XV_DEVICE_BLOCKS]), env)
    cfg = {"a": os.path.join(build, "xv_default-config.yaml"),
           "b": os.path.join(build, "xv_pd-config.yaml")}
    with open(cfg["a"], "w") as f:
        f.write(xv_configmap(root, XV_RECIPES["sched_gw"],
                             "default-config.yaml"))
    with open(cfg["b"], "w") as f:
        f.write(xv_configmap(root, XV_RECIPES["pd"], "pd-config.yaml"))
    args, env = xv_container(root, XV_RECIPES["sched_gw"],
                             "gaie-inference-scheduling", "epp")
    spawn("ga", [sys.executable, "-m", "llm_d_tpu_torch.epp.service",
                 *xv_flags(args, {
                     "--port": ports["ga"], "--config": cfg["a"],
                     "--discover": f"dns:localhost:{ports['a1']},"
                                   f"dns:localhost:{ports['a2']}",
                     "--kv-events-bind": kv_bind},
                     ["--host", "127.0.0.1"])], env)
    # (b) the pd-disaggregation recipe.
    args, env = xv_container(root, XV_RECIPES["pd"], "ms-pd-prefill", "vllm")
    for n, kv in (("p1", "kv1"), ("p2", "kv2")):
        conf = json.loads(args[args.index("--kv-transfer-config") + 1])
        conf.update(kv_ip="127.0.0.1", kv_port=ports[kv])
        pod(n, xv_flags(args, {
            "--model": XV_MODEL, "--port": ports[n],
            "--tensor-parallel-size": 1,
            "--kv-transfer-config": json.dumps(conf)},
            ["--host", "127.0.0.1", "--num-blocks", XV_PD_DEVICE_BLOCKS]),
            env)
    args, env = xv_container(root, XV_RECIPES["pd"], "ms-pd-decode", "vllm")
    pod("c", xv_flags(args, {"--model": XV_MODEL, "--port": ports["c"],
                             "--tensor-parallel-size": 1},
                      ["--host", "127.0.0.1",
                       "--num-blocks", XV_PD_DEVICE_BLOCKS]), env)
    args, env = xv_container(root, XV_RECIPES["pd"], "ms-pd-decode",
                             "routing-proxy")
    spawn("side", [sys.executable, "-m", "llm_d_tpu_torch.sidecar.proxy",
                   *xv_flags(args, {
                       "--port": ports["side"], "--decode-url": url["c"],
                       "--prefiller": f"127.0.0.1:{ports['p1']}"},
                       ["--host", "127.0.0.1"])], env)
    args, env = xv_container(root, XV_RECIPES["pd"], "gaie-pd", "epp")
    spawn("gb", [sys.executable, "-m", "llm_d_tpu_torch.epp.service",
                 *xv_flags(args, {
                     "--port": ports["gb"], "--config": cfg["b"],
                     "--endpoints": f"127.0.0.1:{ports['p1']}=prefill,"
                                    f"127.0.0.1:{ports['p2']}=prefill,"
                                    f"127.0.0.1:{ports['side']}=decode"},
                     ["--host", "127.0.0.1"])], env)


def xv_stop(started: dict) -> None:
    import signal
    for p in started["procs"].values():
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait(timeout=60)


def xv_pod_main(argv) -> int:
    """One model server of phase 16 (``chip_smoke.py --gw-pod RESULT
    RECORD FLAGS``): the entry point's ``main(FLAGS)`` with the
    ``DecimalTokenizer`` (token-id prompts; each id's text its own);
    with RECORD 1, G's
    and H's first inputs of each ``xv_label`` class recorded and, once the
    server has stopped, held to their plain versions (skipped on the CPU).
    RESULT gets the exit code, the kernel launches and the checks; exits
    with the server's code, or 1 when a check failed."""
    import torch
    from llm_d_tpu_torch.engine.cuda_graph import kernel_counts
    from llm_d_tpu_torch.server import openai as srv
    result_path, record, flags = argv[0], argv[1] == "1", argv[2:]
    # Each id's own text, so a reply's top_logprobs keep both of a near
    # tie's tokens apart (the byte tokenizer writes every id past 255 as
    # the same empty text).
    srv.get_tokenizer = lambda name: DecimalTokenizer()
    MESH_STATE.clear()
    MESH_STATE.update(recs={}, names=XV_KERNELS, keep=frozenset())
    if record:
        for n in XV_KERNELS:
            mod, fn, _ = MESH_WRAPPERS[n]
            MESH_STATE["recs"][n] = Recorder(_mesh_module(mod), fn,
                                             frozenset(), xv_label(n))
    code = 0
    try:
        srv.main(flags)
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
    out = dict(server_exit=code, launches=kernel_counts(), labels={
        n: sorted(r.calls) for n, r in MESH_STATE["recs"].items()})
    print(f"xv pod stopped: kernel launches {json.dumps(out['launches'])}",
          flush=True)
    if code == 0 and record and torch.cuda.is_available():
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        try:
            out["checks"] = mesh_kernel_checks()
        except Exception as e:                  # reported to the smoke
            out["error"] = repr(e)
            code = 1
    with open(result_path, "w") as f:
        json.dump(out, f)
    return code


def xv_traces(url: str) -> list:
    """The spans of ``url``'s ``/debug/traces`` (JSON lines)."""
    import urllib.request
    with urllib.request.urlopen(url + "/debug/traces", timeout=60) as r:
        return [json.loads(ln) for ln in r.read().decode().splitlines()
                if ln.strip()]


def xv_tie(url: str, prompt, got, want) -> dict:
    """The first difference of ``got`` from ``want`` (``url``'s own greedy
    tokens for ``prompt``) and that pod's top-2 logprob gap there."""
    i = next(k for k, (x, y) in enumerate(zip(got, want)) if x != y)
    return dict(first_difference=i,
                gap=xiv_tie({"pod": url}, prompt, i + 1)["pod"][i])


def xv_ready(started: dict, names, limit_s: float = 600) -> dict:
    """Seconds after the phase's start at which each of ``names`` answered
    /v1/models with 200 (the gateways: once their scrapes found a ready
    model server)."""
    out = {}
    for n in names:
        wait_ready(started["procs"][n], started["url"][n], limit_s=limit_s)
        out[n] = time.perf_counter() - started["t0"]
    return out


def xv_sched(root: str, started: dict, vocab: int) -> dict:
    """Phase 16(a) on the pods ``xv_start`` started (module comment)."""
    import signal
    import threading
    import numpy as np
    from llm_d_tpu_torch.server.stream_resume import verify_continuity
    url, procs = started["url"], started["procs"]
    out = dict(ready_s=xv_ready(started, ("a1", "a2", "ga")))
    pods = {f"127.0.0.1:{started['ports'][n]}": n for n in ("a1", "a2")}
    gw = url["ga"]
    time.sleep(0.5)             # two scrapes: both pods ready at the gateway
    rng = np.random.default_rng(16)
    prefixes = [rng.integers(1, vocab, XV_PREFIX).tolist()
                for _ in range(XV_GROUPS)]
    prompts = [[p + rng.integers(1, vocab, XV_OWN).tolist()
                for _ in range(XV_GROUP)] for p in prefixes]
    full = (XV_PREFIX + XV_OWN) // XV_BLOCK
    shared = XV_PREFIX // XV_BLOCK
    replies, home = {}, {}

    def send(g, k):
        rid = f"xv-a-{g}-{k}"
        replies[(g, k)] = completion(gw, greedy_body(
            prompts[g][k], XV_NEW, True), headers={"x-request-id": rid})

    for g in range(XV_GROUPS):
        send(g, 0)
        home[g] = replies[(g, 0)]["headers"][
            "x-gateway-destination-endpoint"]
    t0 = time.perf_counter()
    while scrape(gw).get("inference_extension_prefix_indexer_size", 0) \
            < full * XV_GROUPS:
        if time.perf_counter() - t0 > 30:
            raise RuntimeError(f"path (xv)(a): the gateway's index holds "
                               f"{scrape(gw)} blocks")
        time.sleep(0.05)
    out["index_wait_s"] = time.perf_counter() - t0
    from concurrent.futures import ThreadPoolExecutor
    later = [(g, k) for g in range(XV_GROUPS) for k in range(1, XV_GROUP)]
    with ThreadPoolExecutor(len(later)) as ex:
        list(ex.map(lambda gk: send(*gk), later))
    bad = {}
    for (g, k), r in replies.items():
        dest = r["headers"]["x-gateway-destination-endpoint"]
        if r["n"] != XV_NEW:
            bad[(g, k)] = f"{r['n']} tokens"
        elif k and dest != home[g]:
            bad[(g, k)] = f"routed to {dest}, its group's pod is {home[g]}"
        elif k and r["headers"].get("x-llmd-kv-placement") != "local_hit":
            bad[(g, k)] = "placement " \
                f"{r['headers'].get('x-llmd-kv-placement')}"
    if bad:
        raise RuntimeError(f"path (xv)(a): {bad}")
    # The precise index's score of the chosen pod: the group's shared
    # blocks of the prompt's full ones.
    spans = xv_traces(gw)
    rid_of = {s["trace"]: s["attrs"].get("request_id") for s in spans
              if s["name"] == "gateway.request"}
    precise = {}
    sched_ms = []
    for s in spans:
        if s["name"] != "gateway.schedule":
            continue
        sched_ms.append(s["dur"] * 1e3)
        rid = rid_of.get(s["trace"]) or ""
        if rid.startswith("xv-a-") and not rid.endswith("-0"):
            precise[rid] = s["attrs"]["scores"]["default"][
                "precise-prefix-cache-scorer"]
    low = {r: v for r, v in precise.items() if v < shared / full - 1e-6}
    if len(precise) != XV_GROUPS * (XV_GROUP - 1) or low:
        raise RuntimeError(f"path (xv)(a): precise scores {precise}")
    # Each reply's tokens against the same prompt straight to its pod.
    ties = {}
    replay_ttft = []
    for (g, k), r in sorted(replies.items()):
        d = completion(f"http://{home[g]}", greedy_body(prompts[g][k],
                                                        XV_NEW, True))
        replay_ttft.append(d["t_first"] - d["t_send"])
        if d["tokens"] != r["tokens"]:
            ties[f"{g}-{k}"] = xv_tie(f"http://{home[g]}", prompts[g][k],
                                      r["tokens"], d["tokens"])
    far = {k: v for k, v in ties.items()
           if v["gap"] is None or v["gap"] > XV_NEAR_TIE}
    if far:
        raise RuntimeError(f"path (xv)(a): tokens differ from the pod's "
                           f"outside a near tie: {far}")
    m = scrape(gw)
    counted = sum(v for k, v in m.items()
                  if k.startswith("inference_objective_request_total{"))
    if counted != XV_GROUPS * XV_GROUP:
        raise RuntimeError(f"path (xv)(a): the gateway counted {counted} "
                           f"requests of {XV_GROUPS * XV_GROUP}")
    # The control of the 12-way burst: the same burst of fresh suffixes
    # on the same prefixes straight to each group's pod, twice, then once
    # more through the gateway (gateway, pod, pod, gateway).
    runs = [("via", [replies[gk]["t_first"] - replies[gk]["t_send"]
                     for gk in later])]
    for side in ("direct", "direct", "via"):
        urls = [gw if side == "via" else f"http://{home[g]}"
                for g, _ in later]
        bodies = [greedy_body(prefixes[g] + rng.integers(
            1, vocab, XV_OWN).tolist(), XV_NEW, True) for g, _ in later]
        with ThreadPoolExecutor(len(later)) as ex:
            runs.append((side, [r["t_first"] - r["t_send"]
                                for r in ex.map(completion, urls, bodies)]))
    burst = {n: [t for side, ts in runs if side == n for t in ts]
             for n in ("via", "direct")}
    out.update(groups=XV_GROUPS, per_group=XV_GROUP, prefix=XV_PREFIX,
               own=XV_OWN, new=XV_NEW, homes={g: pods[h]
                                              for g, h in home.items()},
               precise_scores=sorted(set(precise.values())),
               near_ties=ties, tokens_equal=not ties,
               ttft_s=spread([r["t_first"] - r["t_send"]
                              for r in replies.values()]),
               burst=dict(
                   requests=len(later), order="gateway pod pod gateway",
                   runs_ttft_s=[spread(ts) for _, ts in runs],
                   via_gateway_ttft_s=spread(burst["via"]),
                   direct_ttft_s=spread(burst["direct"]),
                   added_ms=(float(np.median(burst["via"]))
                             - float(np.median(burst["direct"]))) * 1e3),
               replay_ttft_s=spread(replay_ttft),
               gateway_requests_counted=counted)
    # The gateway's cost: TTFT of a fresh prompt through the gateway and
    # straight to the pod it picked, in alternating rounds.
    via, direct = [], []
    for r in range(XV_ROUNDS):
        pa, pb = (rng.integers(1, vocab, XV_PROBE).tolist()
                  for _ in range(2))
        order = ("gw", "pod") if r % 2 == 0 else ("pod", "gw")
        target = None
        for side in order:
            if side == "gw":
                res = completion(gw, greedy_body(pa, 1, True))
                via.append(res["t_first"] - res["t_send"])
                target = res["headers"]["x-gateway-destination-endpoint"]
            else:
                res = completion(f"http://{target or home[0]}",
                                 greedy_body(pb, 1, True))
                direct.append(res["t_first"] - res["t_send"])
    out["overhead"] = dict(
        rounds=XV_ROUNDS, probe=XV_PROBE, via_gateway_ttft_s=spread(via),
        direct_ttft_s=spread(direct),
        added_ms=(float(np.median(via)) - float(np.median(direct))) * 1e3)
    buckets = sorted((float(k.split('le="')[1].split('"')[0]), v)
                     for k, v in scrape(gw).items() if k.startswith(
        "inference_extension_scheduler_e2e_duration_seconds_bucket{"))
    n_obs = buckets[-1][1]
    out["scheduling"] = dict(
        histogram_median_le_s=next(b for b, c in buckets
                                   if c >= n_obs / 2),
        observations=n_obs, span_ms=spread(sched_ms))
    # Failure: the pod serving a stream dies after 8 tokens, with
    # requests of the same prefix in flight on it (sent once the
    # gateway's index holds the stream's prompt blocks, so they go where
    # those blocks are).
    stream_prompt = rng.integers(1, vocab, XV_STREAM["prompt"]).tolist()
    state, inflight = {}, []
    base = scrape(gw).get("inference_extension_prefix_indexer_size", 0)
    first = threading.Event()
    counted = [0]

    def killer():
        first.wait(120)
        t0 = time.perf_counter()
        while scrape(gw).get("inference_extension_prefix_indexer_size",
                             0) < base + XV_STREAM["prompt"] // XV_BLOCK:
            if time.perf_counter() - t0 > 30:
                state["error"] = "the stream's blocks never reached the index"
                return
            time.sleep(0.01)
        # Released together, so the gateway schedules them all before a
        # scrape can count them on the pod.
        gate = threading.Barrier(XV_STREAM["inflight"])

        def one(j):
            body = greedy_body(stream_prompt + [j + 1] * 8,
                               XV_STREAM["new"], False)
            gate.wait()
            state[j] = http_call(gw, "/v1/completions", body)

        for j in range(XV_STREAM["inflight"]):
            t = threading.Thread(target=one, args=(j,))
            t.start()
            inflight.append(t)
        time.sleep(0.05)            # the in-flight requests reach the pod
        while counted[0] < XV_STREAM["kill_after"]:
            time.sleep(0.002)
        victim = pods[state["dest"]]
        os.killpg(procs[victim].pid, signal.SIGKILL)
        state.update(killed=victim, t_kill=time.perf_counter(),
                     killed_at=counted[0])

    kill_thread = threading.Thread(target=killer)
    kill_thread.start()
    body = greedy_body(stream_prompt, XV_STREAM["new"], True)
    import urllib.request
    req = urllib.request.Request(
        gw + "/v1/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    metas, toks, done = [], [], False
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            state["dest"] = r.headers["x-gateway-destination-endpoint"]
            for line in r:
                if not line.startswith(b"data: "):
                    continue
                data = line[len(b"data: "):].strip()
                if data == b"[DONE]":
                    done = True
                    break
                meta = json.loads(data)["llmd"]
                metas.append(meta)
                toks += meta["tok"]
                counted[0] = len(toks)
                if meta["tok"]:
                    first.set()
    finally:
        first.set()
        counted[0] = 1 << 30
        kill_thread.join()
    if "killed" not in state or state["killed_at"] >= XV_STREAM["new"]:
        raise RuntimeError(f"path (xv)(a): the kill missed the stream "
                           f"({state.get('error')}, at "
                           f"{state.get('killed_at')} tokens)")
    t_done = time.perf_counter()
    for t in inflight:
        t.join()
    procs[state["killed"]].wait(timeout=60)
    survivor = next(a for a, n in pods.items() if n != state["killed"])
    problems = verify_continuity(metas, XV_STREAM["new"])
    m = scrape(gw)
    breaker = m.get(f'llmd_tpu:endpoint_breaker_state{{endpoint='
                    f'"{state["dest"]}"}}')
    retried = {j: (status, hdr.get("x-gateway-destination-endpoint"),
                   hdr.get("x-llmd-retry-budget"))
               for j, (status, hdr, _) in sorted(
                   (k, v) for k, v in state.items() if isinstance(k, int))}
    after = [completion(gw, greedy_body(rng.integers(1, vocab, 64).tolist(),
                                        4, False))["headers"].get(
        "x-gateway-destination-endpoint") for _ in range(2)]
    fail = dict(prompt=XV_STREAM["prompt"], new=XV_STREAM["new"],
                killed=state["killed"], done=done, tokens=len(toks),
                continuity=problems, breaker_state=breaker,
                breaker_opened=m.get(
                    f'llmd_tpu:endpoint_breaker_transitions_total{{endpoint='
                    f'"{state["dest"]}",to="open"}}'),
                killed_at_token=state["killed_at"],
                inflight=retried, next_requests=after,
                recovery_s=m.get("llmd_tpu:request_recovery_seconds_sum"),
                resumes={k.split('"')[1]: v for k, v in m.items()
                         if k.startswith("llmd_tpu:stream_resume_total{")},
                kill_to_done_s=t_done - state["t_kill"])
    out["failure"] = fail
    log(f"path (xv)(a): {json.dumps(out)}")
    if not done or problems or breaker != 1.0 \
            or any(v[0] != 200 or v[1] != survivor for v in retried.values()) \
            or len(retried) != XV_STREAM["inflight"] \
            or any(a != survivor for a in after):
        raise RuntimeError(f"path (xv)(a) failure: {fail}")
    out["survivor"] = pods[survivor]
    return out


def xv_pd(root: str, started: dict, vocab: int) -> dict:
    """Phase 16(b) on the pods ``xv_start`` started (module comment)."""
    import signal
    import numpy as np
    url, procs, ports = started["url"], started["procs"], started["ports"]
    out = dict(ready_s=xv_ready(started, ("p1", "p2", "c", "side", "gb")))
    time.sleep(0.5)             # the gateway's scrapes see every pod
    rng = np.random.default_rng(161)

    def fresh(n):
        return [rng.integers(1, vocab, XV_PD["prompt"]).tolist()
                for _ in range(n)]

    # The P/D prompts, fresh prompts straight to the consumer (its cold
    # prefill), and those of the failovers and the local fallbacks.
    prompts, cold, fo_prompts, local_prompts = (
        fresh(XV_PD["prompts"]), fresh(XV_PD["prompts"]), fresh(2), fresh(2))
    kv_of = {f"127.0.0.1:{ports['kv1']}": "p1",
             f"127.0.0.1:{ports['kv2']}": "p2"}

    def staged(name):
        """request id -> bytes each producer staged (its kv.stage spans)."""
        return {s["attrs"]["request_id"]: s["attrs"]["bytes"]
                for s in xv_traces(url[name]) if s["name"] == "kv.stage"}

    def pulled():
        """request id -> (bytes, producer) of the consumer's pulls."""
        return {s["attrs"]["request_id"]: (s["attrs"]["bytes"],
                                           kv_of.get(s["attrs"]["source"]))
                for s in xv_traces(url["c"]) if s["name"] == "kv.transfer"}

    # The references, before any P/D traffic: each prompt served plainly
    # by a producer that will not prefill it (the P/D prompts by p2, the
    # failover and fallback prompts by p1), so no reply below can share
    # its KV with its reference.
    ref = {}
    for name, ps in (("p2", prompts), ("p1", fo_prompts + local_prompts)):
        for p in ps:
            ref[tuple(p)] = (name, completion(url[name],
                                           greedy_body(p, XV_PD["new"], True)))
    ref_ttft = [r["t_first"] - r["t_send"] for _, r in ref.values()]

    def tie(p, got, live):
        """None where ``got`` holds ``p``'s reference tokens, else the
        first difference and its top-2 gap on the pod ``live``."""
        want = ref[tuple(p)][1]["tokens"]
        return None if got == want else xv_tie(url[live], p, got, want)

    via, direct, ties = [], [], {}
    for i, p in enumerate(prompts):
        body = greedy_body(p, XV_PD["new"], True)
        for side in (("gw", "c") if i % 2 == 0 else ("c", "gw")):
            if side == "c":
                d = completion(url["c"], greedy_body(cold[i], XV_PD["new"],
                                                     True))
                direct.append(d["t_first"] - d["t_send"])
                continue
            r = completion(url["gb"], body,
                           headers={"x-request-id": f"xv-b-{i}"})
            if r["headers"].get("x-gateway-destination-endpoint") != \
                    f"127.0.0.1:{ports['side']}":
                raise RuntimeError(f"path (xv)(b): request {i} routed to "
                                   f"{dict(r['headers'])}")
            via.append(r["t_first"] - r["t_send"])
            t = tie(p, r["tokens"], "p2")
            if t is not None:
                ties[i] = t
    far = {k: v for k, v in ties.items()
           if v["gap"] is None or v["gap"] > XV_NEAR_TIE}
    got_pulls, by_producer = pulled(), {n: staged(n) for n in ("p1", "p2")}
    rids = [f"xv-b-{i}" for i in range(len(prompts))]
    where = {rid: [n for n, s in by_producer.items() if rid in s]
             for rid in rids}
    mismatch = {rid: (got_pulls.get(rid), {n: by_producer[n].get(rid)
                                           for n in by_producer})
                for rid in rids
                if rid not in got_pulls or len(where[rid]) != 1
                or got_pulls[rid][1] != where[rid][0]
                or got_pulls[rid][0] != by_producer[where[rid][0]][rid]}
    out.update(prompts=len(prompts), prompt=XV_PD["prompt"],
               new=XV_PD["new"], prefilled_on={r: w for r, w in
                                               where.items()},
               sidecar_prefiller="p1", reference_pods=dict(
                   pd="p2", failover_and_fallback="p1"),
               pulled_bytes=sorted({v[0] for v in got_pulls.values()}),
               via_gateway_sidecar_ttft_s=spread(via),
               direct_consumer_cold_ttft_s=spread(direct),
               reference_producer_cold_ttft_s=spread(ref_ttft),
               near_ties=ties, tokens_equal=not ties)
    if far or mismatch or any(w != ["p1"] for w in where.values()):
        raise RuntimeError(f"path (xv)(b): far from a tie {far}, pulls "
                           f"{mismatch}, prefilled on {where}")
    # Failure: p1 dies; the next two requests carry the hint the EPP's
    # prefill-header-handler would send (p1 first) and fail over to p2;
    # then p2 dies and the next request is prefilled on the consumer.
    hint = {"x-prefiller-host-port":
            f"127.0.0.1:{ports['p1']},127.0.0.1:{ports['p2']}"}
    os.killpg(procs["p1"].pid, signal.SIGKILL)
    procs["p1"].wait(timeout=60)
    fo = []
    for j, p in enumerate(fo_prompts):
        rid = f"xv-b-fo-{j}"
        r = completion(url["side"], greedy_body(p, XV_PD["new"], True),
                       headers=dict(hint, **{"x-request-id": rid}))
        fo.append(dict(rid=rid,
                       fallback=r["headers"].get("x-llmd-prefill-fallback"),
                       tie=tie(p, r["tokens"], "p2"),
                       seconds=r["t_end"] - r["t_send"]))
    p2_staged = staged("p2")
    os.killpg(procs["p2"].pid, signal.SIGKILL)
    procs["p2"].wait(timeout=60)
    r = completion(url["side"], greedy_body(local_prompts[0], XV_PD["new"],
                                            True),
                   headers=dict(hint, **{"x-request-id": "xv-b-local"}))
    g = completion(url["gb"], greedy_body(local_prompts[1], XV_PD["new"],
                                          True),
                   headers={"x-request-id": "xv-b-local-gw"})
    local = dict(fallback=r["headers"].get("x-llmd-prefill-fallback"),
                 tie=tie(local_prompts[0], r["tokens"], "c"),
                 seconds=r["t_end"] - r["t_send"], via_gateway=dict(
                     tie=tie(local_prompts[1], g["tokens"], "c"),
                     seconds=g["t_end"] - g["t_send"]))
    out["failover"] = fo
    out["local"] = local
    out["failover_prefilled_on_p2"] = [f["rid"] in p2_staged for f in fo]
    log(f"path (xv)(b): {json.dumps(out)}")
    far = [t for t in [f["tie"] for f in fo] + [local["tie"],
                                                local["via_gateway"]["tie"]]
           if t is not None and (t["gap"] is None or t["gap"] > XV_NEAR_TIE)]
    if any(f["fallback"] for f in fo) \
            or not all(out["failover_prefilled_on_p2"]) \
            or local["fallback"] != "local" or far:
        raise RuntimeError(f"path (xv)(b) failure: {fo}, {local}")
    return out


def xv_path(root: str, started: dict) -> tuple:
    """Phase 16, path (xv), after phase 15: (a) and (b) on the pods
    ``xv_start`` started at the phase's start, then (c): the launches of
    the pods that stopped cleanly (the survivor of (a), the consumer of
    (b)) and their G and H inputs against the plain versions.  The logs
    go to stderr if it fails.  Returns (result, launches by kernel,
    checks)."""
    import signal
    from llm_d_tpu_torch.models.config import get_config
    vocab = get_config(XV_MODEL).vocab_size
    t0 = time.perf_counter()
    try:
        out = dict(model=XV_MODEL, block=XV_BLOCK,
                   device_blocks=dict(a=XV_DEVICE_BLOCKS,
                                      b=XV_PD_DEVICE_BLOCKS),
                   offload_blocks=XV_OFFLOAD_BLOCKS)
        out["a"] = xv_sched(root, started, vocab)
        out["b"] = xv_pd(root, started, vocab)
        # (a)'s survivor and (b)'s consumer stop together; their launches
        # and checks are in their results.
        stopping = (out["a"]["survivor"], "c")
        t_term = time.perf_counter()
        for name in stopping:
            started["procs"][name].send_signal(signal.SIGTERM)
        out["exit"] = {name: started["procs"][name].wait(
            timeout=DRAIN_S + 300) for name in stopping}
        out["exit_s"] = time.perf_counter() - t_term
        if any(out["exit"].values()):
            raise RuntimeError(f"path (xv): exit codes {out['exit']}")
        launches, checks, pods = {}, [], {}
        for name in stopping:
            with open(started["results"][name]) as f:
                res = json.load(f)
            pods[name] = {k: res.get(k) for k in ("labels", "peak_gib",
                                                  "launches")}
            if res.get("error") or not res.get("checks"):
                raise RuntimeError(f"path (xv)(c): {name}'s checks: {res}")
            checks += res["checks"]
            for n in XV_KERNELS:
                k = MESH_WRAPPERS[n][1]
                launches[n] = launches.get(n, 0) + res["launches"].get(k, 0)
        if min(launches.values()) == 0:
            raise RuntimeError(f"path (xv)(c): launches {launches}")
        out["c"] = dict(launches=launches, pods=pods)
        out["seconds"] = time.perf_counter() - t0
        out["since_start_s"] = time.perf_counter() - started["t0"]
    except BaseException:
        for n in started["procs"]:
            path = os.path.join(root, "build", f"xv_{n}.log")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    sys.stderr.write(f"--- xv_{n}.log\n" + f.read()[-4000:]
                                     .decode(errors="replace"))
        raise
    finally:
        xv_stop(started)
    return out, launches, checks


def main() -> int:
    import torch
    if "--tier-pod" in sys.argv[1:]:
        # One of phase 15's pods (on the CPU too, for a rehearsal).
        return xiv_pod_main(sys.argv[sys.argv.index("--tier-pod") + 1:])
    if "--gw-pod" in sys.argv[1:]:
        # One of phase 16's model servers (on the CPU too, for a rehearsal).
        return xv_pod_main(sys.argv[sys.argv.index("--gw-pod") + 1:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    if "--cold-probe" in sys.argv[1:]:
        return cold_probe_main(sys.argv[sys.argv.index("--cold-probe") + 1])
    import dataclasses
    import numpy as np
    from llm_d_tpu_torch.models.config import get_config
    from llm_d_tpu_torch.ops import _build, flash_prefill, mla_decode, \
        mla_prefill, moe_int8, moe_routed, moe_routed_stream, \
        paged_attention
    from llm_d_tpu_torch.ops import moe as moe_ops

    # 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"build: {len(libs)} libraries in {build_s:.1f} s")
    for src, lib in libs.items():
        # ptxas -v: registers, shared memory and spills of every kernel.
        report = lib.with_suffix(".log").read_text(errors="replace")
        usage = [ln.split(":", 1)[1].strip() for ln in report.splitlines()
                 if "Used" in ln and "registers" in ln]
        spills = [ln.strip() for ln in report.splitlines() if "spill" in ln
                  and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        log(f"ptxas {src}: {len(usage)} kernels, max "
            f"{max((int(u.split()[1]) for u in usage), default=0)} "
            f"registers, spills: {spills or 'none'}")

    pallas = "llm_d_tpu/ops/pallas/"
    kernels = [
        dict(name="mla_decode", mod=mla_decode, fn="mla_paged_decode_update",
             plain="mla_paged_decode_update_plain", path="i",
             label=lambda a, kw: f"S={a[0].shape[0]}",
             source="llm_d_tpu_torch/csrc/mla_decode.cu",
             replaces=pallas + "mla_attention.py:224"),
        dict(name="mla_prefill", mod=mla_prefill, fn="mla_flash_prefill",
             plain="mla_flash_prefill_plain", path="i",
             label=lambda a, kw: f"S={a[0].shape[0]} Q={a[0].shape[1]}",
             source="llm_d_tpu_torch/csrc/mla_prefill.cu",
             replaces=pallas + "mla_prefill.py:165"),
        dict(name="moe_dense_int8", mod=moe_int8, fn="dense_moe_int8",
             plain="dense_moe_int8_plain", path="i",
             label=lambda a, kw: f"T={a[0].shape[0]}",
             source="llm_d_tpu_torch/csrc/moe_dense_int8.cu",
             replaces=pallas + "moe_int8.py:182"),
        dict(name="moe_routed_int8", mod=moe_routed, fn="routed_moe_int8",
             plain="routed_moe_int8_plain", path="i",
             label=lambda a, kw: f"T={a[0].shape[0]}",
             source="llm_d_tpu_torch/csrc/moe_streamed_int8.cu",
             replaces=pallas + "moe_routed.py:183"),
        dict(name="moe_streamed_int8", mod=moe_routed_stream,
             fn="streamed_moe_int8", plain="streamed_moe_int8_plain",
             path="i", label=lambda a, kw: f"T={a[0].shape[0]}",
             source="llm_d_tpu_torch/csrc/moe_streamed_int8.cu",
             replaces=pallas + "moe_routed_stream.py:124"),
        dict(name="moe_grouped_int8", mod=moe_int8, fn="grouped_moe_int8",
             plain="grouped_moe_int8_plain", path="i",
             source="llm_d_tpu_torch/csrc/moe_streamed_int8.cu",
             replaces=pallas + "moe_int8.py:78"),
        dict(name="paged_decode", mod=paged_attention,
             fn="paged_attention_decode_update",
             plain="paged_attention_decode_update_plain", path="ii",
             label=cache_mode, source="llm_d_tpu_torch/csrc/paged_decode.cu",
             replaces=pallas + "paged_attention.py:282"),
        dict(name="flash_prefill", mod=flash_prefill,
             fn="flash_prefill_paged", plain="flash_prefill_paged_plain",
             path="ii", label=cache_mode,
             source="llm_d_tpu_torch/csrc/flash_prefill.cu",
             replaces=pallas + "flash_prefill.py:188"),
    ]

    # 2. path (i): deepseek-v3-bench as bench.py serves it ------------------
    t0 = time.perf_counter()
    engine = path_i_engine()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # The classic loop (one step per dispatch) on the same weights: the
    # yardstick of the rounds below, not the path.
    classic = path_i_engine(1, engine.params)
    note_live_tokens(engine)
    note_live_tokens(classic)
    log(f"engine: init {init_s:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{engine.config.num_blocks} blocks")
    weights = tensor_ptrs(engine.params)
    recorders = {k["name"]: Recorder(k["mod"], k["fn"], weights,
                                     k.get("label"))
                 for k in kernels}
    def reset_counts():
        for rec in recorders.values():
            rec.wrapped.launches = 0

    def read_counts(path, replayed):
        """Each kernel's launches on ``path``: its wrapper's count (eager
        launches, graph warm-ups included) plus its launches inside graph
        replays (``replayed``: the ``DecodeGraphs.launches`` of the path's
        multistep engines, by wrapper name)."""
        in_graphs = {k["name"]: sum(r[k["fn"]] for r in replayed)
                     for k in kernels if k["path"] == path}
        counts = {n: recorders[n].wrapped.launches + c
                  for n, c in in_graphs.items()}
        missing = [n for n, c in counts.items() if c == 0]
        if missing:
            raise RuntimeError(f"kernels never launched on path ({path}): "
                               f"{missing}")
        return counts, in_graphs

    rng = np.random.default_rng(0)
    vocab = engine.model_config.vocab_size
    p1 = prompts_for(rng, vocab, WAVE1)
    p2 = prompts_for(rng, vocab, WAVE2)
    p3 = prompts_for(rng, vocab, WAVE3)
    waves_i = {}
    reset_counts()
    # The glue inputs of the bench's 8192-token step, to run kernel E on
    # it as one chunk in phase 4.
    with bench_glue_recorder(moe_ops) as bench_glue:
        tok1, waves_i["wave1"] = run_wave(engine, p1, WAVE1["new"], "w1")
        log(f"wave 1: {json.dumps(waves_i['wave1'])}")
        _, waves_i["wave2"] = run_wave(engine, p2, WAVE2["new"], "w2")
        log(f"wave 2: {json.dumps(waves_i['wave2'])}")
        tok3, waves_i["wave3"] = run_wave(engine, p3, WAVE3["new"], "w3")
        log(f"wave 3: {json.dumps(waves_i['wave3'])}")
        tok1b, waves_i["wave1_repeat"] = run_wave(engine, p1, WAVE1["new"],
                                                  "w1b")
        log(f"wave 1 again: {json.dumps(waves_i['wave1_repeat'])}")
        with env_set("LLMD_MOE_PREFILL_KERNEL", "grouped"):
            tok3g, waves_i["wave3_grouped"] = run_wave(engine, p3, WAVE3["new"],
                                                       "w3g")
        waves_i["wave3_grouped"]["same_tokens_as_streamed"] = tok3g == tok3
        log(f"wave 3 grouped: {json.dumps(waves_i['wave3_grouped'])}")
    launches, graph_launches = read_counts(
        "i", [dict(engine._graphs.launches)])
    log(f"launches (i): {json.dumps(launches)}, inside graph replays: "
        f"{json.dumps(graph_launches)}")
    for w, st in waves_i.items():
        check_multistep(st, w)
    if tok1b != tok1:
        raise RuntimeError("wave 1 did not repeat token for token")
    if not bench_glue:
        raise RuntimeError(f"no {BENCH_T}-token MoE step was recorded")
    for name in ("mla_decode", "moe_dense_int8", "moe_routed_int8"):
        if graph_launches[name] == 0:
            raise RuntimeError(f"{name} never launched inside a graph")

    # Graph replays against the eager body; the multistep engine against
    # the classic loop.
    sampled_block(engine, vocab)
    graphs_i = [graph_equals_eager(engine, key)
                for key in ((8, False), (WAVE2_S, False), (8, True))]
    log(f"graph vs eager: {json.dumps(graphs_i)}")
    rounds_i = classic_rounds(classic, engine, {
        "wave1": (WAVE1, p1), "wave2": (WAVE2, p2), "wave3": (WAVE3, p3)},
        ROUNDS)
    log(f"classic vs multistep: {json.dumps(rounds_i)}")
    graphs_info = dict(
        pool_bytes=engine._graphs.pool_bytes,
        graphs=[dict(S=k[0], random_rows=k[1], launches=g.launches,
                     cold=g.cold)
                for k, g in engine._graphs.graphs.items()],
        replays=engine._graphs.replays)
    log(f"graphs (i): {json.dumps(graphs_info)}")

    prof = None
    if "--profile" in sys.argv[1:]:
        prof = profile_waves(classic, p1, p2, p3)
        prof["blocks"] = profile_blocks(engine, {"wave1": p1, "wave2": p2})
        log(f"profile: {json.dumps(prof)}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()

    # 2b. path (iii): speculative decode as bench_spec / bench_mixed ------
    t0 = time.perf_counter()
    spec_eng = path_iii_engine(engine.params)
    note_live_tokens(spec_eng)
    torch.cuda.synchronize()
    spec = dict(card=smi, init_s=time.perf_counter() - t0,
                num_blocks=spec_eng.config.num_blocks,
                max_num_seqs=spec_eng.config.max_num_seqs)
    # The first two layers, for the verify check (b) and phase 5.
    mc = dataclasses.replace(engine.model_config, num_layers=2,
                             max_model_len=1152)
    Lm = mc.num_layers - mc.first_dense_layers
    params = dict(engine.params)
    params["moe_layers"] = {k: v[:Lm] for k, v in
                            engine.params["moe_layers"].items()}
    moe_kw = dict(quantization="int8", kv_cache_dtype="int8", block_size=64,
                  num_blocks=24, max_num_seqs=8,
                  max_num_batched_tokens=1024, enable_prefix_caching=False)
    # The classic loop's taped run is a yardstick, not the path's run.
    yardstick = classic_margins(classic, p1, WAVE1["new"])
    reset_counts()
    spec["greedy"] = spec_greedy(spec_eng, p1, tok1, yardstick)
    log(f"spec (a) greedy: {json.dumps(spec['greedy'])}")
    # (b) compares kernels with the CPU reference: not the path's run, so
    # the recorders step aside.
    for rec in recorders.values():
        setattr(rec.module, rec.name, rec.fn)
    spec["verify_reference"] = spec_reference_check(
        mc, params, spec_eng.draft_params, moe_kw, 10)
    log(f"spec (b) verify logits: {json.dumps(spec['verify_reference'])}")
    for rec in recorders.values():
        setattr(rec.module, rec.name, rec.wrapped)
    sp = spec_prompts(21, SPEC_WAVE["n"], SPEC_WAVE["prompt"], vocab)
    spec["bench_spec"] = spec_bench(spec_eng, sp)
    log(f"spec (c) bench_spec: {json.dumps(spec['bench_spec'])}")
    joiners = spec_prompts(22, MIXED_JOIN["n"], MIXED_JOIN["prompt"], vocab)
    spec["bench_mixed"] = mixed_bench(spec_eng, sp, joiners, runs=1)
    spec_eng.set_spec_fixed_accept(None)
    alone = [run_wave(spec_eng, [p], WAVE1["new"], f"salone{i}")[0][0]
             for i, p in enumerate(p1)]
    spec["server"] = spec_server(spec_eng, p1, alone)
    log(f"spec (e) server: {json.dumps(spec['server'])}")
    # Path (iii)'s fused rounds are graph replays too.
    spec_counts = {k["name"]: recorders[k["name"]].wrapped.launches
                   + spec_eng._graphs.launches[k["fn"]]
                   for k in kernels if k["path"] == "i"}
    log(f"launches (iii): {json.dumps(spec_counts)}")
    missing = [n for n in ("mla_prefill", "moe_streamed_int8")
               if spec_counts[n] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on path (iii): "
                           f"{missing}")
    for n, c in spec_counts.items():
        launches[n] += c
        graph_launches[n] += spec_eng._graphs.launches[
            next(k["fn"] for k in kernels if k["name"] == n)]
    # Each fused key against its eager body (a comparison: its launches
    # are not the path's, and the recorders step aside).
    for rec in recorders.values():
        setattr(rec.module, rec.name, rec.fn)
    spec["graph_vs_eager"] = fused_graph_checks(spec_eng)
    for rec in recorders.values():
        setattr(rec.module, rec.name, rec.wrapped)
    spec["graphs"] = graph_costs(spec_eng)
    log(f"spec graphs: {json.dumps(spec['graph_vs_eager'])} "
        f"{json.dumps(spec['graphs'])}")
    if prof is not None:
        prof["spec"] = profile_spec(spec_eng, sp, joiners[0])
        log(f"profile spec: {json.dumps(prof['spec'])}")
    del spec_eng, alone
    gc.collect()
    torch.cuda.empty_cache()

    # 2c. path (iv): the fused multistep pipeline as bench_everything_on --
    t0 = time.perf_counter()
    eon = {EON_N: path_iv_engine(engine.params, EON_N)}
    eon[1] = path_iv_engine(engine.params, 1, eon[EON_N].draft_params)
    # The yardstick of EPLB's collection: the N-round engine without it.
    eon["off"] = path_iv_engine(engine.params, EON_N,
                                eon[EON_N].draft_params, eplb=False)
    for e in eon.values():
        note_live_tokens(e)
    routed_iv = count_routed(eon[EON_N])
    torch.cuda.synchronize()
    everything = dict(card=smi, init_s=time.perf_counter() - t0,
                      num_blocks=eon[EON_N].config.num_blocks,
                      max_num_seqs=eon[EON_N].config.max_num_seqs)
    reset_counts()
    everything["greedy"] = eon_greedy(eon, p1, tok1, yardstick)
    log(f"everything-on (a) greedy: {json.dumps(everything['greedy'])}")
    everything["bench_everything_on"] = eon_bench(eon, sp)
    log(f"everything-on (b): {json.dumps(everything['bench_everything_on'])}")
    eplb_iv = eon[EON_N].eplb
    everything["eplb"] = dict(
        ep=eplb_iv.ep, physical=eon[EON_N].params["moe_layers"][
            "w_gate_q"].shape[1], imbalance=eplb_iv.tracker.imbalance(),
        routed_ids_recorded=routed_iv[0],
        routed_ids_in_window=float(eplb_iv.tracker.load.sum()),
        migrations=eplb_iv.num_rebalances,
        num_suppressed=eplb_iv.num_suppressed,
        single_round_migrations=eon[1].eplb.num_rebalances)
    log(f"everything-on eplb: {json.dumps(everything['eplb'])}")
    if eplb_iv.num_rebalances or eon[1].eplb.num_rebalances \
            or not routed_iv[0]:
        raise RuntimeError(f"path (iv): EPLB at ep = 1 migrated or recorded "
                           f"nothing: {everything['eplb']}")
    eon_graph = {k["name"]: sum(e._graphs.launches[k["fn"]]
                                for e in eon.values())
                 for k in kernels if k["path"] == "i"}
    eon_counts = {n: recorders[n].wrapped.launches + c
                  for n, c in eon_graph.items()}
    everything.update(launches=eon_counts, graph_launches=eon_graph)
    log(f"launches (iv): {json.dumps(eon_counts)}, inside graph replays: "
        f"{json.dumps(eon_graph)}")
    missing = [n for n in ("mla_prefill", "moe_streamed_int8")
               if eon_graph[n] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched inside path (iv)'s "
                           f"graphs: {missing}")
    for n, c in eon_counts.items():
        launches[n] += c
        graph_launches[n] += eon_graph[n]
    for rec in recorders.values():
        setattr(rec.module, rec.name, rec.fn)
    everything["graph_vs_eager"] = {side_label(N): fused_graph_checks(e)
                                    for N, e in eon.items() if N != "off"}
    for rec in recorders.values():
        setattr(rec.module, rec.name, rec.wrapped)
    everything["graphs"] = {side_label(N): graph_costs(e)
                            for N, e in eon.items()}
    log(f"everything-on graphs: "
        f"{json.dumps(everything['graph_vs_eager'])} "
        f"{json.dumps(everything['graphs'])}")
    if prof is not None:
        prof["everything_on"] = profile_eon(eon[EON_N], sp)
        log(f"profile everything-on: {json.dumps(prof['everything_on'])}")
    draft_params = eon[EON_N].draft_params
    del eon, e, eplb_iv
    gc.collect()
    torch.cuda.empty_cache()

    # 2e. path (vi): bench_eplb_skew; the controller at ep = 4; the
    # attribution sweep; pool sizing ----------------------------------------
    t0 = time.perf_counter()
    skew_eng = path_vi_engine(engine.params, draft_params)
    note_live_tokens(skew_eng)
    eplb_out = dict(card=smi, init_s=time.perf_counter() - t0,
                    num_blocks=skew_eng.config.num_blocks,
                    max_num_seqs=skew_eng.config.max_num_seqs)
    reset_counts()
    eplb_out["bench_eplb_skew"] = eplb_skew(skew_eng, sp)
    log(f"eplb (vi): {json.dumps(eplb_out['bench_eplb_skew'])}")
    skew_graph = {k["name"]: skew_eng._graphs.launches[k["fn"]]
                  for k in kernels if k["path"] == "i"}
    skew_counts = {n: recorders[n].wrapped.launches + c
                   for n, c in skew_graph.items()}
    eplb_out.update(launches=skew_counts, graph_launches=skew_graph)
    log(f"launches (vi): {json.dumps(skew_counts)}, inside graph replays: "
        f"{json.dumps(skew_graph)}")
    missing = [n for n in ("mla_prefill", "moe_streamed_int8")
               if skew_graph[n] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched inside path (vi)'s "
                           f"graphs: {missing}")
    for n, c in skew_counts.items():
        launches[n] += c
        graph_launches[n] += skew_graph[n]
    eplb_out["seconds"] = time.perf_counter() - t0
    del skew_eng, draft_params
    gc.collect()
    torch.cuda.empty_cache()
    # The controller's kernel launches compare the physical table with
    # the logical one: not a path's run, so the recorders step aside.
    for rec in recorders.values():
        setattr(rec.module, rec.name, rec.fn)
    t0 = time.perf_counter()
    eplb_out["controller"] = controller_phase(engine.params,
                                              engine.model_config)
    eplb_out["controller"]["seconds"] = time.perf_counter() - t0
    for rec in recorders.values():
        setattr(rec.module, rec.name, rec.wrapped)
    log(f"eplb controller: {json.dumps(eplb_out['controller'])}")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reset_counts()
    attr, replayed_attr = attribution(engine.params)
    attr_graph = {k["name"]: sum(r[k["fn"]] for r in replayed_attr)
                  for k in kernels if k["path"] == "i"}
    attr_counts = {n: recorders[n].wrapped.launches + c
                   for n, c in attr_graph.items()}
    attr.update(card=smi, launches=attr_counts, graph_launches=attr_graph,
                seconds=time.perf_counter() - t0)
    log(f"attribution: {json.dumps(attr['table'])}")
    missing = [n for n in ("mla_decode", "mla_prefill", "moe_dense_int8",
                           "moe_routed_int8", "moe_streamed_int8")
               if attr_counts[n] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched by the attribution "
                           f"sweep: {missing}")
    for n, c in attr_counts.items():
        launches[n] += c
        graph_launches[n] += attr_graph[n]
    sizing = [sizing_check(path_i_engine(
        1, engine.params, kv_cache_hbm_bytes=SIZING_BUDGET),
        "deepseek-v3-bench int8 latent")]
    log(f"sizing: {json.dumps(sizing[-1])}")
    gc.collect()
    torch.cuda.empty_cache()

    # 2d. path (v): P/D disaggregation and the tiered KV cache ------------
    t0 = time.perf_counter()
    # The classic loop's wave 3 with its routing taped: the witness's
    # yardstick (not the path's run).
    yardstick3 = classic_margins(classic, p3, WAVE3["new"])
    if yardstick3[0] != tok3:
        raise RuntimeError("the classic loop's wave 3 differs from path (i)'s")
    reset_counts()
    prod, cons = pd_engines(engine.params)
    for e in (prod, cons):
        note_live_tokens(e)
    pd_out, pd_alone = pd_run(prod, cons, p3, tok3, yardstick3, p1,
                              rounds_i)
    pd_out["card"] = smi
    log(f"P/D (a): {json.dumps(pd_out)}")
    replayed_v = [dict(cons._graphs.launches)]
    del prod, cons, classic, yardstick3
    gc.collect()
    torch.cuda.empty_cache()
    pd_out["tier"], tier_launches = tier_run(engine.params, p1, tok1, vocab)
    replayed_v += tier_launches
    log(f"P/D (b) tier: {json.dumps(pd_out['tier'])}")
    pd_graph = {k["name"]: sum(r[k["fn"]] for r in replayed_v)
                for k in kernels if k["path"] == "i"}
    pd_counts = {n: recorders[n].wrapped.launches + c
                 for n, c in pd_graph.items()}
    pd_out.update(launches=pd_counts, graph_launches=pd_graph)
    log(f"launches (v): {json.dumps(pd_counts)}, inside graph replays: "
        f"{json.dumps(pd_graph)}")
    missing = [n for n in ("mla_prefill", "moe_streamed_int8", "mla_decode",
                           "moe_dense_int8") if pd_counts[n] == 0]
    missing += [f"{n} (graphs)" for n in ("mla_decode", "moe_dense_int8")
                if pd_graph[n] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on path (v): {missing}")
    for n, c in pd_counts.items():
        launches[n] += c
        graph_launches[n] += pd_graph[n]
    LIVE_TOKENS[0] = None
    gc.collect()
    torch.cuda.empty_cache()
    pd_out["cli_pair"] = pd_cli_pair(root, p1, pd_alone)
    log(f"P/D (c) CLI pair: {json.dumps(pd_out['cli_pair'])}")
    pd_out["seconds"] = time.perf_counter() - t0

    # 3. path (ii): llama3-1b on a bf16 and on int8 caches ------------------
    waves_ii = {}
    graphs_ii = []
    llama_params2 = None
    reset_counts()
    for kv, gran in DENSE_MODES:
        tag = kv if gran is None else f"{kv}-{gran}"
        t0 = time.perf_counter()
        eng = path_ii_engine(kv, gran)
        torch.cuda.synchronize()
        log(f"llama3-1b {tag}: init {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        sizing.append(sizing_check(path_ii_engine(
            kv, gran, params=eng.params, kv_cache_hbm_bytes=SIZING_BUDGET),
            f"llama3-1b {tag}"))
        log(f"sizing: {json.dumps(sizing[-1])}")
        gc.collect()
        torch.cuda.empty_cache()
        pd = dense_prompts(eng.model_config.vocab_size)
        tokd, waves_ii[tag] = run_wave(eng, pd, DENSE_WAVE["new"], tag)
        log(f"llama3-1b {tag} wave: {json.dumps(waves_ii[tag])}")
        if kv == "bf16":
            tokd2, waves_ii["bf16_repeat"] = run_wave(
                eng, pd, DENSE_WAVE["new"], "bf16b")
            log(f"llama3-1b bf16 wave again: "
                f"{json.dumps(waves_ii['bf16_repeat'])}")
            if tokd2 != tokd:
                raise RuntimeError("llama3-1b bf16 wave did not repeat "
                                   "token for token")
            # The same wave through multistep blocks (as bench.py would
            # serve it), on the same weights, twice: the classic run's
            # tokens.
            ms = path_ii_engine(kv, gran, BENCH_K, eng.params)
            tokm, waves_ii["bf16_multistep"] = run_wave(
                ms, pd, DENSE_WAVE["new"], "bf16m")
            waves_ii["bf16_multistep"]["same_tokens_as_classic"] = \
                tokm == tokd
            log(f"llama3-1b bf16 multistep wave: "
                f"{json.dumps(waves_ii['bf16_multistep'])}")
            # Again, with the graph captured: the steady state.
            tokm2, waves_ii["bf16_multistep_repeat"] = run_wave(
                ms, pd, DENSE_WAVE["new"], "bf16m2")
            log(f"llama3-1b bf16 multistep wave again: "
                f"{json.dumps(waves_ii['bf16_multistep_repeat'])}")
            for w in ("bf16_multistep", "bf16_multistep_repeat"):
                check_multistep(waves_ii[w], f"llama3-1b {w}")
            if tokm != tokd or tokm2 != tokd:
                raise RuntimeError("llama3-1b bf16 multistep tokens differ "
                                   "from the classic loop's")
            graphs_ii.append(dict(ms._graphs.launches))
            graphs_info["llama3-1b"] = dict(
                pool_bytes=ms._graphs.pool_bytes,
                graphs=[dict(S=k[0], random_rows=k[1], launches=g.launches)
                        for k, g in ms._graphs.graphs.items()])
            del ms
            if prof is not None:
                # The profiled steps are not the path's run: their launches
                # do not count.
                held = {n: r.wrapped.launches for n, r in recorders.items()}
                prof["llama3-1b"] = profile_dense(eng, pd)
                log(f"profile llama3-1b: {json.dumps(prof['llama3-1b'])}")
                for n, r in recorders.items():
                    r.wrapped.launches = held[n]
            # The first two layers, for phase 5 (copies: a slice would
            # keep every layer alive).
            llama_params2 = {
                k: ({kk: vv[:2].clone() for kk, vv in v.items()}
                    if k == "layers" else v)
                for k, v in eng.params.items()}
        del eng                       # free each engine before the next
        gc.collect()
        torch.cuda.empty_cache()
    counts_ii, graph_ii = read_counts("ii", graphs_ii)
    launches.update(counts_ii)
    graph_launches.update(graph_ii)
    log(f"launches (ii): {json.dumps(counts_ii)}, inside graph replays: "
        f"{json.dumps(graph_ii)}")
    if graph_launches["paged_decode"] == 0:
        raise RuntimeError("paged_decode never launched inside a graph")

    # 4. kernels against their plain versions --------------------------------
    rows, variants, bounds = [], [], []
    raw = {n: rec.fn for n, rec in recorders.items()}
    attention = ("mla_decode", "mla_prefill", "paged_decode", "flash_prefill")

    def check(k, label, args, kw, count: bool, live_tokens=None,
              keep=None):
        """``k``'s kernel against its plain version on ``(args, kw)``
        (copies, but of the tensors in ``keep``: path (i)'s weights by
        default), then timed."""
        fn, plain = raw[k["name"]], getattr(k["mod"], k["plain"])
        keep = weights if keep is None else keep
        a_k, kw_k = clone(args, keep), clone(kw, keep)
        a_p, kw_p = clone(args, keep), clone(kw, keep)
        got = fn(*a_k, **kw_k)
        want = plain(*a_p, **kw_p)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        name = f"{k['name']} [{label}]"
        if k["name"] in attention:
            torch.testing.assert_close(got.float(), want.float(),
                                       atol=2e-2, rtol=2e-2)
            # The in-place splices: cache and scale planes exactly.
            spliced = {"mla_decode": ([2], ["kv_scale"]),
                       "paged_decode": ([3, 4], ["k_scale", "v_scale"])}
            pos, names = spliced.get(k["name"], ([], []))
            for i in pos:
                if not torch.equal(a_k[i], a_p[i]):
                    raise RuntimeError(f"{name}: cache planes differ")
            for n in names:
                if kw_k.get(n) is not None and \
                        not torch.equal(kw_k[n], kw_p[n]):
                    raise RuntimeError(f"{name}: {n} planes differ")
        else:
            scale = float(want.abs().max()) + 1e-9
            if err / scale > 1e-2:
                raise RuntimeError(f"{name}: error {err} / scale "
                                   f"{scale} > 1e-2")
        ms = time_ms(lambda: fn(*a_k, **kw_k), iters=20)
        dev_ms, _ = device_ms(lambda: fn(*a_k, **kw_k))
        plain_ms = time_ms(lambda: plain(*a_p, **kw_p), iters=3, warmup=1)
        nbytes, flops = work(k["name"], args, kw, got, live_tokens)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        row = dict(
            name=k["name"], route="cuda", source=k["source"],
            replaces=k["replaces"], launches=launches[k["name"]],
            graph_launches=graph_launches[k["name"]],
            spec_launches=spec_counts.get(k["name"], 0),
            everything_on_launches=eon_counts.get(k["name"], 0),
            pd_launches=pd_counts.get(k["name"], 0),
            eplb_launches=skew_counts.get(k["name"], 0),
            attribution_launches=attr_counts.get(k["name"], 0),
            max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None)
        # One SDPA call on the gathered K/V (an int8 cache or latent
        # dequantized to bf16 as it is gathered) computes each attention
        # kernel's function at every input.
        if k["name"] in attention:
            row["library_ms"] = sdpa_ms(k["name"], a_k, kw_k)
        if count:
            rows.append(row)
        else:
            variants.append(dict(row, variant=label))
        bounds.append(dict(name=k["name"], variant=label,
                           shape=shape_of(args), bytes=nbytes, flops=flops,
                           bytes_ms=t_bytes, ops_ms=t_ops))
        log(f"{name}: err {err:.3g}, {ms:.4f} ms ({dev_ms:.4f} on the "
            f"device) vs plain {plain_ms:.4f} ms, bound "
            f"{max(t_bytes, t_ops):.4f} ms, library {row['library_ms']}")

    for k in kernels:
        calls = recorders[k["name"]].calls
        if not calls:
            raise RuntimeError(f"{k['name']}: no recorded launch")
        for i, (label, (args, kw)) in enumerate(calls.items()):
            check(k, label, args, kw, count=i == 0,
                  live_tokens=recorders[k["name"]].notes[label])
    # Kernel A at long context: 8 sequences x 4096 keys.
    decode = next(k for k in kernels if k["name"] == "mla_decode")
    first = next(iter(recorders["mla_decode"].calls.values()))
    check(decode, "S=8 keys=4096",
          *long_decode_inputs(*first, S=8, keys=4096, seed=11), count=False)
    # Kernel G at long context: 8 sequences x 4096 keys, split over blocks.
    dense_decode = next(k for k in kernels if k["name"] == "paged_decode")
    first = next(iter(recorders["paged_decode"].calls.values()))
    check(dense_decode, "S=8 keys=4096",
          *long_dense_decode_inputs(*first, S=8, keys=4096, seed=12),
          count=False)
    # Kernel E on the bench's 8192-token step as one chunk (the default
    # chunks are its recorded T=8192 launch).
    streamed = next(k for k in kernels if k["name"] == "moe_streamed_int8")
    args, kw = bench_step_as_one_chunk(moe_ops, moe_routed_stream,
                                       bench_glue["args"])
    check(streamed, f"T={BENCH_T} chunk_t={BENCH_T}", clone(args, weights),
          clone(kw, weights), count=False)
    # Kernels C-F at other shapes, on the engine's first MoE layer with
    # routing from a seed: C at T = 8 (a decode block of 8 rows), D at T =
    # 256 and 512 (64-row blocks; the waves' T = 128 runs 32-row ones), F
    # at 128-row tiles (the waves' grouped step runs 256-row ones).
    quant = {n: engine.params["moe_layers"][n] for n in
             ("w_gate_q", "w_gate_s", "w_up_q", "w_up_s", "w_down_q",
              "w_down_s")}
    quant["layer"] = 0
    for name, glue, T, kwg in (
            ("moe_dense_int8", moe_ops._dense_int8_kernel_path, 8, {}),
            ("moe_routed_int8", moe_ops._routed_int8_kernel_path, 256, {}),
            ("moe_routed_int8", moe_ops._routed_int8_kernel_path, 512, {}),
            ("moe_grouped_int8", moe_ops._grouped_int8_kernel_path, 1024,
             dict(row_tile=128))):
        k = next(kk for kk in kernels if kk["name"] == name)
        x, w, idx = moe_inputs(engine.model_config, T, seed=T)
        with capture(k["mod"], k["fn"]) as seen:
            glue(x, w, idx, quant, **kwg)
        check(k, f"T={T}" + (" rt=128" if kwg else ""),
              *clone(seen[0], weights), count=False)
    # Kernels A and B on bf16 latents at wave 1's decode and wave 3's
    # prefill shapes, each also timed as one SDPA call (library_ms).
    check(decode, "bf16 S=8 keys=160",
          *decode_inputs(False, 64, [160] * 8, seed=13), count=False)
    prefill = next(k for k in kernels if k["name"] == "mla_prefill")
    check(prefill, "bf16 S=64 Q=128",
          *mla_prefill_inputs(64, [128] * 64, [128] * 64, seed=14),
          count=False)
    for rec in recorders.values():
        setattr(rec.module, rec.name, rec.fn)

    # 5. reference checks ----------------------------------------------------
    refs = [reference_check(mc, params, moe_kw, lens, seed)
            for lens, seed in (([100], 7), ([1024], 8))]
    lc = dataclasses.replace(get_config("llama3-1b"), num_layers=2,
                             max_model_len=1152)
    dense_kw = dict(block_size=64, num_blocks=24, max_num_seqs=8,
                    max_num_batched_tokens=1024, enable_prefix_caching=False)
    refs.append(reference_check(lc, llama_params2, dense_kw, [100, 37], 9))
    for ref in refs:
        log(f"reference: {json.dumps(ref)}")
        if not ref["top1_agree"] or ref["rel_max_err"] > 5e-2:
            raise RuntimeError(f"kernel path disagrees with the CPU "
                               f"reference: {ref}")

    # 6. parity repairs ------------------------------------------------------
    parity = dict(decode_pages=[], engines=[])
    for quantized, bs in ((False, 128), (True, 256)):
        label = f"{'int8' if quantized else 'bf16'} bs={bs}"
        kt = mla_decode.decode_key_tile(640, bs, 1, quantized)
        if not 0 < kt < bs:
            raise RuntimeError(f"{label}: key tile {kt}")
        a_args, a_kw = decode_inputs(quantized, bs, [5, kt, bs, 2 * bs + 3,
                                                     9 * bs + 1, 0, 1, 0],
                                     seed=bs)
        check(decode, f"{label} kt={kt}", a_args, a_kw, count=False)
        parity["decode_pages"].append(dict(label=label, key_tile=kt))
        ref = large_page_reference(
            mc, params, quantized, bs,
            [(mla_decode, "mla_paged_decode_update"),
             (mla_prefill, "mla_flash_prefill")])
        log(f"reference: {json.dumps(ref)}")
        if not ref["top1_agree"] or ref["rel_max_err"] > 5e-2:
            raise RuntimeError(f"kernel path disagrees with the CPU "
                               f"reference: {ref}")
        parity["engines"].append(ref)
    dense_prefill = next(k for k in kernels if k["name"] == "flash_prefill")
    parity["dense_pages"] = []
    for sw in (0, 8):
        label = f"{'int8-head' if sw else 'bf16'} bs=256 D=128"
        check(dense_decode, label,
              *dense_decode_inputs(sw, 256, [5, 256, 300, 769, 1, 0],
                                   seed=20 + sw, D=128, scale=0.09),
              count=False)
        check(dense_prefill, label,
              *dense_prefill_inputs(sw, 256, [300, 256, 600, 0],
                                    [300, 44, 72, 0], seed=30 + sw),
              count=False)
        parity["dense_pages"].append(label)
    parity["llama3-8b"] = dense_large_page_reference(
        [(paged_attention, "paged_attention_decode_update"),
         (flash_prefill, "flash_prefill_paged")])
    log(f"reference: {json.dumps(parity['llama3-8b'])}")
    parity["tiny"] = tiny_on_the_card()
    log(f"parity: tiny {json.dumps(parity['tiny'])}")
    parity["soft_cap"] = soft_cap_through_chunked()
    log(f"parity: soft cap {json.dumps(parity['soft_cap'])}")
    parity["noise"] = noise_on_the_card()
    log(f"parity: noise {json.dumps(parity['noise'])}")

    # 7. the server ----------------------------------------------------------
    # (a) In process, over path (i)'s engine: the direct engine's tokens
    # for each wave-1 prompt alone first (not the server's run), then the
    # server's run, its launches counted from 0.
    alone = [run_wave(engine, [p], WAVE1["new"], f"alone{i}")[0][0]
             for i, p in enumerate(p1)]
    for k in kernels:
        getattr(k["mod"], k["fn"]).launches = 0
    replayed0 = dict(engine._graphs.launches)
    server = {"card": smi}
    server["in_process"] = server_in_process(engine, p1, WAVE1["new"],
                                             alone, tok1)
    in_graphs = {k["name"]: engine._graphs.launches[k["fn"]]
                 - replayed0[k["fn"]] for k in kernels}
    server_counts = {k["name"]: getattr(k["mod"], k["fn"]).launches
                     + in_graphs[k["name"]] for k in kernels}
    log(f"server (in process): {json.dumps(server['in_process'])}, "
        f"launches {json.dumps(server_counts)}, inside graph replays "
        f"{json.dumps(in_graphs)}")
    missing = [n for n in ("mla_decode", "mla_prefill", "moe_dense_int8",
                           "moe_routed_int8", "moe_streamed_int8")
               if server_counts[n] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched by the server: {missing}")
    for row in rows:
        row["server_launches"] = server_counts[row["name"]]
        row["launches"] += server_counts[row["name"]]
        row["graph_launches"] += in_graphs[row["name"]]
    # (c) Observability and resume: tracing, the training feed, KV events
    # and the host-tier resume in this process, on path (i)'s engine and,
    # for the events and the restore, on path (v)(b)'s prefix-caching
    # engine with the host tier; the resume across server processes after
    # (b).  The classic loop's tokens and margins for the resumed prompt
    # come first (a yardstick, not the phase's run).
    t_obs = time.perf_counter()
    classic = path_i_engine(1, engine.params)
    yardstick_r = classic_margins(classic, [p1[0]], RESUME_NEW)
    del classic
    for k in kernels:
        getattr(k["mod"], k["fn"]).launches = 0
    replayed0 = dict(engine._graphs.launches)
    observe = {"card": smi}
    observe.update(observe_server(engine, p1, WAVE1["new"], vocab))
    log(f"observe (a), (d): {json.dumps(observe)}")
    obs = path_i_engine(BENCH_K, engine.params, enable_prefix_caching=True,
                        num_blocks=TIER_BLOCKS,
                        kv_offload_blocks=TIER_HOST_BLOCKS)
    note_live_tokens(obs)
    observe["events"] = observe_events(obs, p1, vocab)
    log(f"observe (b): {json.dumps(observe['events'])}")
    # With the journal, the prompt fills two blocks and two rows: the
    # second block holds generated tokens, so its restore counts some.
    observe["restore"] = observe_restore(
        obs, p1[0][:2 * obs.config.block_size - RESUME_AT + 2])
    log(f"observe (c) host tier: {json.dumps(observe['restore'])}")
    in_graphs = {k["name"]: engine._graphs.launches[k["fn"]]
                 - replayed0[k["fn"]] + obs._graphs.launches[k["fn"]]
                 for k in kernels}
    obs_counts = {k["name"]: getattr(k["mod"], k["fn"]).launches
                  + in_graphs[k["name"]] for k in kernels}
    log(f"observe launches {json.dumps(obs_counts)}, inside graph replays "
        f"{json.dumps(in_graphs)}")
    missing = [n for n in ("mla_decode", "mla_prefill", "moe_dense_int8",
                           "moe_routed_int8", "moe_streamed_int8")
               if obs_counts[n] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched in phase 7(c): "
                           f"{missing}")
    for row in rows:
        row["observe_launches"] = obs_counts[row["name"]]
        row["launches"] += obs_counts[row["name"]]
        row["graph_launches"] += in_graphs[row["name"]]
    obs.host_tier.close()
    del obs
    LIVE_TOKENS[0] = None
    observe["in_process_s"] = time.perf_counter() - t_obs
    # (b) The entry point as a subprocess, with this process's engines and
    # recorded inputs freed first.
    del engine, params, quant, recorders, rec, bench_glue, llama_params2, \
        decode, dense_decode, dense_prefill, streamed, first, args, kw, \
        x, w, idx, seen, prefill
    gc.collect()
    torch.cuda.empty_cache()
    log(f"server: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still "
        f"allocated in this process")
    server["entry_point"] = server_subprocess(root, vocab)
    log(f"server (entry point): {json.dumps(server['entry_point'])}")
    t_obs = time.perf_counter()
    observe["resume"] = resume_pair(root, p1[0], yardstick_r)
    observe["resume"]["seconds"] = time.perf_counter() - t_obs
    log(f"observe (c), (e): {json.dumps(observe['resume'])}")
    # 8. path (vii): qwen3-30b-a3b at full width and depth, then the
    # mixtral-8x22b witness at 8 layers, on a card the earlier phases have
    # left; each path's kernels held to their plain versions as it ends.
    gqa = {}
    for name, witness in ((GQA_MOE_MODEL, False), (WITNESS_MODEL, True)):
        res, counts, in_graphs = gqa_moe_path(name, kernels, check, smi,
                                              witness, prof)
        gqa[name] = res
        for row in rows:
            n = row["name"]
            row["witness_launches" if witness else "moe_gqa_launches"] = \
                counts.get(n, 0)
            row["launches"] += counts.get(n, 0)
            row["graph_launches"] += in_graphs.get(n, 0)
        log(f"path (vii) {name}: {res['seconds']:.1f} s")
    # 9. path (viii): tp = ep = 4 as four ranks, once phase 8 has freed the
    # card.
    # 10. path (ix): dp = 2 x tp = 2 on the same ranks, its server and a
    # DP group of two engines (inside mesh_path: they share its pool and
    # its one-rank engine).
    mesh, mesh_counts, mesh_checks, dp, wide, xi = mesh_path(root, smi)
    for row in rows:
        n = row["name"]
        row["mesh_launches"] = mesh_counts.get(n, 0) + \
            mesh["witness"]["launches"].get(n, 0)
        row["launches"] += row["mesh_launches"]
        row["mesh_inputs"] = [{k: v for k, v in c.items() if k != "name"}
                              for c in mesh_checks if c["name"] == n]
        row["dp_launches"] = dp["launches"].get(n, 0)
        row["launches"] += row["dp_launches"]
        row["dp_inputs"] = [{k: v for k, v in c.items() if k != "name"}
                            for c in dp["checks"] if c["name"] == n]
        row["wide_launches"] = wide["launches"].get(n, 0)
        row["launches"] += row["wide_launches"]
        row["wide_inputs"] = [{k: v for k, v in c.items() if k != "name"}
                              for c in wide["checks"] if c["name"] == n]
        row["xi_launches"] = xi["launches"].get(n, 0)
        row["launches"] += row["xi_launches"]
        row["xi_inputs"] = [{k: v for k, v in c.items() if k != "name"}
                            for c in xi["checks"] if c["name"] == n]
    log(f"paths (viii)-(xi): {mesh['seconds']:.1f} s")
    # 13. path (xii): multi-host DP in ranks mode, with phase 12's ranks
    # gone.
    multihost, mh_counts, mh_checks = multihost_path(root, smi)
    for row in rows:
        n = row["name"]
        row["multihost_launches"] = mh_counts.get(n, 0)
        row["launches"] += row["multihost_launches"]
        row["multihost_inputs"] = [{k: v for k, v in c.items()
                                    if k != "name"}
                                   for c in mh_checks if c["name"] == n]
    log(f"path (xii): {multihost['seconds']:.1f} s")
    # 14. path (xiii): an LWS group's mesh, the sp engine, ring attention
    # and the absorption report, with phase 13's hosts gone; phase 15's
    # pods start once 14(a)'s hosts have exited (the card's memory would
    # not hold both builds) and build while 14(d) runs.
    tier = {}
    try:
        lws_sp, xiii_counts, xiii_checks = lws_sp_path(
            root, smi, dp["alone"],
            hosts_gone=lambda: tier.update(xiv_start(root)))
    except BaseException:
        if tier:
            xiv_stop(tier)
        raise
    for row in rows:
        n = row["name"]
        row["xiii_launches"] = xiii_counts.get(n, 0)
        row["launches"] += row["xiii_launches"]
        row["xiii_inputs"] = [{k: v for k, v in c.items() if k != "name"}
                              for c in xiii_checks if c["name"] == n]
    log(f"path (xiii): {lws_sp['seconds']:.1f} s")
    # 15. path (xiv): the tiered-prefix-cache recipe on two tp = 4 pods.
    tiered, xiv_counts, xiv_checks = xiv_path(root, tier)
    tiered["card"] = smi
    for row in rows:
        n = row["name"]
        row["xiv_launches"] = xiv_counts.get(n, 0)
        row["launches"] += row["xiv_launches"]
        row["xiv_inputs"] = [{k: v for k, v in c.items() if k != "name"}
                             for c in xiv_checks if c["name"] == n]
    log(f"path (xiv): {tiered['seconds']:.1f} s")
    # 16. path (xv): the inference-scheduling and pd-disaggregation
    # recipes through the port's gateway and sidecar, once phase 15's pods
    # have exited.
    gateway, xv_counts, xv_checks = xv_path(root, xv_start(root))
    gateway["card"] = smi
    for row in rows:
        n = row["name"]
        row["gateway_launches"] = xv_counts.get(n, 0)
        row["launches"] += row["gateway_launches"]
        row["gateway_inputs"] = [{k: v for k, v in c.items() if k != "name"}
                                 for c in xv_checks if c["name"] == n]
    log(f"path (xv): {gateway['since_start_s']:.1f} s")
    if prof is not None:
        # The first decode block of a fresh process, part by part.
        prof["cold_first_block"] = []
        for m in COLD_MODES:
            prof["cold_first_block"].append(cold_probe(root, m))
            log(f"profile cold: {json.dumps(prof['cold_first_block'][-1])}")
    # The direct engine's steady wave 3 in the same call (the rounds).
    server["direct_engine_wave3_decode_tok_s"] = \
        rounds_i["wave3"]["multistep"]["decode_tok_s"]
    # The bound's inputs, derived from the recorded launches (not timed).
    print(json.dumps({"bounds": bounds}))
    print(json.dumps({"variants": variants}))
    print(json.dumps({"engine": {
        "build_s": build_s, "init_s": init_s,
        "deepseek-v3-bench": waves_i, "llama3-1b": waves_ii,
        "classic_vs_multistep": rounds_i, "graph_vs_eager": graphs_i,
        "graphs": graphs_info, "reference": refs}}))
    if prof is not None:
        print(json.dumps({"profile": prof}))
    print(json.dumps({"server": server}))
    print(json.dumps({"spec": spec}))
    print(json.dumps({"everything_on": everything}))
    print(json.dumps({"pd": pd_out}))
    print(json.dumps({"eplb": eplb_out}))
    print(json.dumps({"attribution": attr}))
    print(json.dumps({"sizing": sizing}))
    print(json.dumps({"observe": observe}))
    print(json.dumps({"moe_gqa": gqa}))
    print(json.dumps({"mesh": mesh}))
    print(json.dumps({"dp": dp["out"]}))
    print(json.dumps({"wide_ep": wide["out"]}))
    print(json.dumps({"spec_mesh": xi["out"]}))
    print(json.dumps({"multihost": multihost}))
    print(json.dumps({"lws_sp": lws_sp}))
    print(json.dumps({"tiered": tiered}))
    print(json.dumps({"gateway": gateway}))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def shape_of(args):
    return [list(a.shape) for a in args if hasattr(a, "shape")][:2]


def _kv_row_bytes(cache, scale) -> int:
    """One cache row with its scales."""
    return cache.shape[-1] * cache.element_size() + (
        scale.shape[-1] * 4 if scale is not None else 0)


def _expert_bytes(E: int, H: int, I: int, experts: int) -> int:
    """int8 weights and f32 scales of ``experts`` experts."""
    return experts * (3 * H * I + (2 * I + H) * 4)


def work(name: str, args, kw, out, live_tokens=None):
    """(bytes moved, flops) the function needs on these inputs: each input
    it uses read once, each output written once.  Data-dependent parts
    count what this run's data needs: live query rows (their outputs
    alone: a pad row's zeros are not needed), the keys and block-table
    entries below each causal bound, the experts with a routed token
    (each expert's weights once per launch) and the routed (token,
    expert) pairs.  ``live_tokens`` (the engine step's unpadded token
    count, ``note_live_tokens``) limits an MoE kernel's tokens to the
    step's: the pad rows of a token bucket route like tokens but are
    thrown away."""
    import torch
    if name in ("mla_decode", "mla_prefill", "paged_decode",
                "flash_prefill"):
        out_row_b = out.shape[-2] * out.shape[-1] * out.element_size()
    if name in ("mla_decode", "mla_prefill"):
        q, _, cache, _, sl = args[:5]
        bs = kw["block_size"]
        row_b = _kv_row_bytes(cache, kw.get("kv_scale"))
        H, F = q.shape[-2], cache.shape[-1]
        q_row_b = H * F * q.element_size()
    if name == "mla_decode":
        S = q.shape[0]
        sl = sl.long().clamp(min=0)
        keys = int(sl.sum())
        live = int((sl > 0).sum())
        pages = int(((sl + bs - 1) // bs).sum())
        # Position seq_len-1 comes from the new row, not from the cache.
        nbytes = (live * q_row_b + live * row_b + S * 4 + pages * 4
                  + (keys - live) * row_b + live * out_row_b + live * row_b)
        return nbytes, 4 * H * F * keys
    if name == "mla_prefill":
        q_pos = args[1]
        S = q.shape[0]
        n_keys = torch.minimum(sl.long()[:, None],
                               q_pos.long() + 1).clamp(min=0)     # [S, Q]
        live_rows = int((n_keys > 0).sum())
        seq_keys = n_keys.max(dim=1).values
        pages = int(((seq_keys + bs - 1) // bs).sum())
        nbytes = (live_rows * q_row_b + q_pos.numel() * 4 + S * 4
                  + pages * 4 + int(seq_keys.sum()) * row_b
                  + live_rows * out_row_b)
        return nbytes, 4 * H * F * int(n_keys.sum())
    if name == "moe_dense_int8":
        x, comb = args[:2]
        _, E, H, I = args[3].shape
        T = live_tokens or x.shape[0]
        routed = comb[:T] != 0                                     # [T, E]
        experts = int(routed.any(dim=0).sum())
        pairs = int(routed.sum())
        nbytes = (T * H * x.element_size() + T * E * 4
                  + _expert_bytes(E, H, I, experts) + T * H * 4)
        return nbytes, 2 * 3 * pairs * H * I
    if name == "moe_routed_int8":
        x, tok_pad, wslot, tile_expert, num_tiles, pos = args[:6]
        _, E, H, I = args[7].shape
        T, k = live_tokens or pos.shape[0], pos.shape[1]
        nt = int(num_tiles.reshape(-1)[0])
        slots = nt * kw["row_tile"]
        experts = int(torch.unique(tile_expert[:nt]).numel())
        nbytes = (T * H * x.element_size() + slots * (tok_pad.element_size()
                  + wslot.element_size()) + nt * 4 + 4 + T * k * 4
                  + _expert_bytes(E, H, I, experts) + T * H * 4)
        return nbytes, 2 * 3 * T * k * H * I
    if name == "moe_streamed_int8":
        x, tok_pad, wslot, tile_expert, num_tiles, pos = args[:6]
        _, E, H, I = args[7].shape
        Tp, k = live_tokens or pos.shape[0], pos.shape[1]
        C, NT = num_tiles.numel(), tile_expert.numel()
        tiles = torch.arange(NT, device=tile_expert.device)
        live = (tiles % (NT // C)) < num_tiles.long()[tiles // (NT // C)]
        n_live = int(live.sum())
        experts = int(torch.unique(tile_expert[live]).numel())
        nbytes = (Tp * H * x.element_size() + n_live * kw["row_tile"] * 8
                  + n_live * 4 + C * 4 + Tp * k * 4
                  + _expert_bytes(E, H, I, experts) + Tp * H * 4)
        return nbytes, 2 * 3 * Tp * k * H * I
    if name == "moe_grouped_int8":
        x_pad, wslot, tile_expert, num_tiles = args[:4]
        _, E, H, I = args[5].shape
        nt = int(num_tiles.reshape(-1)[0])
        routed = int((wslot != 0).sum())
        experts = int(torch.unique(tile_expert[:nt]).numel())
        # The whole padded output is written (zeros past the live tiles).
        nbytes = (routed * (H * x_pad.element_size() + 4) + nt * 4 + 4
                  + _expert_bytes(E, H, I, experts)
                  + out.numel() * out.element_size())
        return nbytes, 2 * 3 * routed * H * I
    if name == "paged_decode":
        q, k_new, v_new, kc, vc, bt, sl = args[:7]
        bs = kw["block_size"]
        S, H, D = q.shape
        row_b = _kv_row_bytes(kc, kw.get("k_scale"))
        sl = sl.long().clamp(min=0)
        keys = int(sl.sum())
        live = int((sl > 0).sum())
        pages = int(((sl + bs - 1) // bs).sum())
        # K and V: the cached keys below the new position, the new rows
        # read from the input and written to their slots.
        nbytes = (live * H * D * q.element_size() + S * 4 + pages * 4
                  + 2 * (keys - live) * row_b + 2 * 2 * live * row_b
                  + live * out_row_b)
        return nbytes, 4 * H * D * keys
    if name == "flash_prefill":
        qs, q_pos, kc, vc, bt, sl = args[:6]
        bs = kw["block_size"]
        S, Q, H, D = qs.shape
        row_b = _kv_row_bytes(kc, kw.get("k_scale"))
        n_keys = torch.minimum(sl.long()[:, None],
                               q_pos.long() + 1).clamp(min=0)     # [S, Q]
        live_rows = int((n_keys > 0).sum())
        seq_keys = n_keys.max(dim=1).values
        pages = int(((seq_keys + bs - 1) // bs).sum())
        nbytes = (live_rows * H * D * qs.element_size() + q_pos.numel() * 4
                  + S * 4 + pages * 4 + 2 * int(seq_keys.sum()) * row_b
                  + live_rows * out_row_b)
        return nbytes, 4 * H * D * int(n_keys.sum())
    raise KeyError(name)


if __name__ == "__main__":
    sys.exit(main())
