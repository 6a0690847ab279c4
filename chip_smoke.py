#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (src/repro_torch/).

    python3 chip_smoke.py [--out report.json]

Needs one CUDA card and ``nvcc``; exits non-zero, printing no result, when
either is missing or any phase fails. Each phase's start ("phase X (at N
s)") and its seconds ("phase X took N s") are printed on lines of their
own. Phases, in order:

1. build  : compiles every kernel of src/repro_torch/csrc/ (one nvcc per
            source, in parallel) and prints the build time.
2. kernels: holds each kernel against its plain PyTorch version on the card,
            at the shapes the serving path gives it and at small ragged
            shapes. INT8 q and scales must match bit for bit; bf16 outputs
            within one bf16 ulp of the largest plain output (2**-7 * max|ref|:
            both sides round an f32 sum, summed in another order); f32
            outputs within 1e-5 * max|ref|.
            The training kernels are held at the training step's shapes:
            quantize_int4 and dequantize_int4_sum (d = 2) bit for bit, and
            quantize_int4 also at blocks 8 ... 2,048 in bf16 and f32 with
            the block count ragged against a warp's and a CTA's run, x off
            the 16-byte grid and a block of 96, each on the variant
            (quantize_int4_path: wide or warp) the rule names;
            matmul_quant (bits 4 and 8, with and without pad_to) with scales
            within 1e-5 relative, q within +-1 in at most 1e-3 of the entries
            and the dequantized C within one quant step of the plain product
            (the two sum M in another order). Its two paths: each case must
            take the path its shape names (matmul_quant_path), and its line
            ends in that path: bf16 operands at the seven shapes on the
            tensor cores, the same in f32 on the SIMT path, bf16 ragged
            (M = 130 and 2,047, K = 72 and 328, blocks 8 and 64) on the
            tensor cores and K = 10 or 70 or block 256 on the SIMT path.
            selective_scan is held in f32 within 1e-5 * max|ref| for y and
            h_last (a last-bit difference of exp per step in a decaying
            recurrence, and another order of the N-sum) at the prefill shape
            (B=1, S=128, D=8192, N=16, h0 = 0), at S=2048 (also with small
            dt, softplus(normal - 6), where a rounding difference in the
            decay lasts longest) and ragged (D off the kernel's channel tile,
            S off its chunk, D % 4 != 0); and its gradients (dt, x, b, c, a,
            h0 through both outputs, the kernel's forward against the plain
            one) within the same tolerance, also at a training rank's shape
            (B = 2, S = 1,024, D = 8,192: the backward rematerialises four
            256-step blocks).
            falcon-mamba-7b's shapes too: dequant_matmul at w_in, w_dt and
            w_out for M = 4 and 128 and its LM head at M = 1 and 4;
            dequantize_int8 of w_xproj; quantize_int8 and dequantize_int8
            of the whole 2^32-element w_in stack (plain versions per chunk);
            dequantize_int8 of q as a view at byte offset 1 (its path for
            any alignment and block), with n a multiple of 16 and not.
            dequantize_int8_sum (the bits=8 receive side, d = 2 at the
            embedding's size, and ragged) and dequantize_int4 (136.1 M
            elements, block 128, to f32 and bf16, and ragged) bit for bit;
            dequant_matmul_blocked at qwen2's w_up (tensor cores), ragged
            M and N with bk 64 (tensor cores) and bk 32 / 20 with K of 3 and
            2 blocks (SIMT), each on the path its shape names
            (dequant_matmul_blocked_path), within BLOCKED_RTOL * |ref| +
            BLOCKED_ATOL * max|ref|.
            dequant_matmul's rounding is reported (not held): the share of
            bf16 outputs off the exact product, kernel, SIMT kernel and
            plain version, at five shapes (two at the decode M). Its three
            paths: each case must take the path its shape names
            (dequant_matmul_path, held to expected_path): both tied LM
            heads (qwen2's and falcon-mamba's, M = 1 and 4), f32, and x @
            W.T at M = 12 and 16 and block 32, NeoX's untied heads
            (gpt-neox-20b's (50,432 x 6,144).T and 10B's (50,432 x
            5,120).T at M = 1 and 4) and bf16 x @ W.T past N = 4,096 (N =
            4,112 at block 16, 8,192, K = 333 ragged, M = 16) on the wide
            kernel of the decode path, and every decode-step layer product
            (bf16 x @ W at M = 1 and 4, qwen2's and falcon-mamba's, M = 8,
            K ragged against the 64-row step) on the decode path; bf16 at
            M = 2,048 in both orientations at qwen2's four shapes, each side
            of the thresholds, ragged tiles (block 64, M = 130 and 2,047, K =
            72 and 328) on the tensor cores; f32 at M = 128, K = 333 (rows
            off the 16-byte grid), x @ W at block 32, x @ W.T at M = 17
            ... 63 and f32 x @ W.T past N = 4,096 on the SIMT path; q as a
            view at byte offset 1 of a larger buffer on each path;
            flash_attention in bf16 (the tensor-core kernel) at the
            training shape, ragged,
            with a query offset and with a window; all within one bf16 ulp
            of max|ref|; non-causal (cross-attention: 16 heads of 64, Sq
            128 and 100 over Sk 1,536) in bf16 and f32. flash_attention at head dim 128 (gpt-neox-10b's
            prefill, 40 heads at S = 128, in bf16 and f32; a ragged Sq with
            GQA and a query offset; a window; f32 ragged) and at the NeoX
            training step's forward (2 rows of 1,024, D = 96 with 64 heads
            and D = 128 with 40, in bf16 and f32), within one bf16 ulp /
            F32_TOL of max|ref|; head dim 80 must raise. flash_attention
            at head dim 256 (gemma3-1b's prefill, 4 heads over 1 at S =
            640, with its window of 512 and causal; a ragged Sq of 100 with
            GQA 8/2 and a query offset; a window of 32 that skips key tiles
            on both sides; f32 at gemma's local shape and ragged; its
            training step's forward, 2 rows of 1,024, with the window of
            512 and causal), within the same tolerances.
2b. ops    : two ops-level paths, each with the counters zeroed before and
            read after: benchmarks/quant_error.py's experiment (2^16
            heavy-tailed values, INT8 and INT4 round trips at blocks 64 ...
            16384, each bit for bit with the plain versions; block 64 must
            beat block 16384) and the reference's test of the 2-D-blocked
            dequant-matmul at its three shapes.
3. serve  : zeroes the launch counters, builds the qwen2-0.5b INT8 residency
            at published width from the seeded init and serves 4 requests
            (4 slots, prompt 128, 32 new tokens, max_len 256) through the
            continuous batcher, then reads the counters: every serving kernel
            must have launched. The first request's prefill logits are held
            against the same prefill through the plain versions on the card
            (bf16 compute across 24 layers: max|d| <= 5e-2 * max|ref|), each
            attention sublayer of that kernel prefill against the plain
            versions on its own input (within 5e-2 * max|ref|), and
            one prefill is traced by torch.profiler (device ms, top kernels;
            a flash or scan event the trace lost is recorded beside the
            launches counted).
            One decode step of all 4 slots after a prefill of the first 4
            prompts (every layer product at M = 4), from the same plain
            caches: kernels against plain within the prefill's tolerance
            in bf16 and PREFILL_F32_TOL in f32, and the bf16 step at most
            PREFILL_BF16_RATIO x as far from the f32 plain one as the bf16
            plain step (both archs).
            The same prefill in f32 (kernels against plain, max|d| <=
            PREFILL_F32_TOL * max|ref|) and in bf16 against the f32 plain
            one: the kernels' gap at most PREFILL_BF16_RATIO x the plain
            versions' (both archs).
3b. ssm   : the same for falcon-mamba-7b at published width and depth (64
            mamba layers, d_inner 8192, INT8 residency of 7.0 GB built leaf
            by leaf): the same traffic, its own kernel list (quantize_int8,
            dequantize_int8, dequant_matmul, selective_scan), prefill logits
            against the plain versions (64 layers of bf16: reported, held
            by the bf16 / f32 ratio, SSM_BF16_TOL) and again with f32
            activations on the same
            weights (max|d| <= PREFILL_F32_TOL * max|ref|, which rounding
            alone meets and a fault would not), the decode step's check
            (its bf16 logits also held by the ratio),
            peak device memory, the decode step replayed as a CUDA graph
            (with its layer products on their own path and forced onto the
            SIMT kernel, in turns), the traced prefill's scan
            total, the scan's device time at S=128 and S=2048 beside its
            bytes bound and its SFU floor (B*S*D*N exps over 132 SMs x 16 a
            clock x nvidia-smi's clocks.max.sm), and dequantize_int8 of one
            layer's w_xproj leaf of the residency (8192 x 288 -> bf16, the
            call every layer makes); then its residency is freed.
3c. neox  : the same for gpt-neox-20b at published width and depth (44
            neox layers: parallel residual, LayerNorm, GELU MLP, 64 heads of
            96; d_model 6,144, d_ff 24,576, vocab 50,432, untied head; INT8
            residency of 21.2 GB built leaf by leaf) under SERVE_KERNELS:
            the prefill (PREFILL_TOL), f32 and f32-ratio prefill checks and
            the decode step's check, peak device memory, the decode graphs
            in turns; the traced prefill must show 44 launches of the
            tensor-core flash kernel and its head (M = 1) on the decode
            path's wide kernel. flash_attention at head dim 96 against
            its plain version (the prefill's 64 heads at S = 128, a ragged
            Sq of 100 with GQA 8/2 and a query offset, a window, f32; one
            bf16 ulp / F32_TOL of max|ref|), its prefill-shape device time
            in bf16 and f32 beside plain, SDPA and the bound; NeoX's six
            layer products at M = 4 (own path, SIMT forced, bf16 cuBLAS,
            bound) and M = 128, its head at M = 4 and 1 on the decode
            path's wide kernel (the same four times), and one prefill's 265
            products; then its residency is freed.
3d. neox10b: the same for gpt-neox-10b at published width and
            NEOX10B_L of its 32 neox layers (d_model 5,120, 40 heads of 128,
            d_ff 20,480, vocab 50,432) under SERVE_KERNELS: the
            prefill, f32 and f32-ratio prefill checks, the decode step's
            check, peak device memory, the decode graphs in turns; the
            traced prefill must show NEOX10B_L launches of the tensor-core flash
            kernel at head dim 128 and its head on the decode path's wide
            kernel; its prefill attention timed in bf16 and f32 beside
            plain, SDPA and the bound; its head at M = 4 and 1 on its own
            path, on SIMT (forced) and with bf16 cuBLAS beside the bytes
            bound; then its residency is
            freed.
3e. gemma : the same for gemma3-1b at published width and depth (26
            layers, 5:1 local (sliding window 512, ring caches) to global,
            d_model 1,152, 4 heads of 256 over 1 KV head, GELU-GLU d_ff
            6,912, tied vocab 262,144, embed_scale; INT8 residency of 1.03
            GB) under SERVE_KERNELS with prompts of 640, past the window
            (the rings wrap in prefill and in decode): the prefill, f32
            and f32-ratio prefill checks, the decode step's check (its ring
            writes and ring_decode), peak device memory, the decode graphs
            in turns; the traced prefill must show 26 launches of the
            tensor-core flash kernel at head dim 256; each of its seven
            layer products and its tied head at M = 4 and 640 (head M = 1)
            on the path expected_path names, timed beside bf16 cuBLAS and
            the bound; its prefill attention (global, local, f32) timed
            beside plain, SDPA and the bound; then its residency is freed.
3f. deepseek: the same for deepseek-7b at published width and depth (30
            attn layers, d_model 4,096, 32 heads of 128 over 32, SiLU-GLU
            d_ff 11,008, RMSNorm, untied vocab 102,400; INT8 residency of
            7.1 GB) under SERVE_KERNELS: the prefill, f32 and f32-ratio
            prefill checks, the decode step's check, peak device memory,
            the decode graphs in turns; the traced prefill must show 30
            launches of the tensor-core flash kernel at head dim 128 and
            its head (rows of 4,096) on the decode path's dmm_dec_tn_kernel;
            its seven layer products and its head at M = 4 and 128 (head
            M = 1) on the paths expected_path names beside bf16 cuBLAS and
            the bound, the head also on SIMT and plain; its attention timed
            at its prefill and training shapes; then its residency is freed
            before the training ranks start. Every serving phase
            fails if any attention call fell back to the chunked plain path
            (ops.dispatch_counters), at these fusable shapes.
3g. mla   : minicpm3-4b (MLA) at published width and depth (62 layers,
            d_model 2,560, 40 heads, q_lora 768, kv_lora 256, qk_nope 64,
            qk_rope 32, v_head 64; INT8 residency of 4.39 GB) under
            MLA_SERVE_KERNELS through the batcher (its latent paged): every
            prefill attention on the chunked plain path (the value width is
            not the key width: exactly one mla_dv_mismatch fallback a layer
            an admission, held by held_fallbacks, as every phase's
            fallbacks are, reason by reason and count by count), the
            prefill (PREFILL_TOL, each MLA sublayer on its own input), f32
            and f32-ratio checks, the decode step's check (the absorbed
            decode over the latent), a B = 1 prefill's and a 4-slot decode
            step's launches held to MLA_PREFILL_LAUNCHES /
            MLA_STEP_LAUNCHES, the decode graphs in turns, kernel 2 at one
            layer's w_dkv and w_ukv.
Every training run's ranks (and the collectives phase's) are processes
forked from the launcher's fork server, which imports torch once for the
whole script (launch.train.PRELOAD), started before the build.
4. train  : repro_torch.launch.train with --devices 4: qwen2-0.5b at full
            width and TRAIN_L of its 24 layers (4h and 4c run the same
            model) under zero_topo on the mesh (data, node, gcd) =
            (1, 2, 2), four ranks (processes) on this one card over gloo,
            quant block 128, bf16, global batch 8 x seq 1024, 5 steps from
            seed 0, the last one traced by torch.profiler, saving a
            checkpoint after step 3 (for 4h). Each rank zeroes
            its counters before its steps and reads them after: every kernel
            of TRAIN_KERNELS must have launched on every rank (the report
            gives every kernel's count). Then the first PLAIN_STEPS steps
            from the same state with --kernel-impl plain (no kernel may
            launch); per-step loss and grad norm must agree
            (TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL). Every training phase's
            plain run is PLAIN_STEPS steps long, so that its last step runs
            on weights each run updated itself (an MoE model's grad norm is
            held at MOE_GNORM_STEPS). Every rank's traced step must show the
            tensor-core matmul_quant kernel as many times as a step launches
            matmul_quant, and the SIMT one never.
4d. train_neox: gpt-neox-20b at published width (d_model 6,144, 64
            heads of 96, d_ff 24,576, vocab 50,432, untied head, LayerNorm
            biases) and NEOX_TRAIN_L layers, the train phase's mesh, batch
            and sequence, 3 steps (the last traced), and again with
            --kernel-impl plain, held as the train phase is held; the
            traced step must also show flash_attention_tc_kernel<96> as often
            as a step launches flash_attention. Prints step_s, tok/s, each
            rank's peak memory and their sum beside the card's, the phase's
            seconds. No training rank may record an attention fallback.
            The step updates its state in place (the reference's donated
            step), so 3 layers leave TRAIN_HEADROOM of the card free;
            NEOX_TRAIN_L is cut below that for the script's time. The
            phase prints the summed peak as bytes a parameter.
4g. train_deepseek: deepseek-7b at published width and DEEPSEEK_TRAIN_L
            layers, held as train_neox is; the traced step must show
            flash_attention_tc_kernel<128> as often as a step launches
            flash_attention.
4e. train_ssm: falcon-mamba-7b at published width (d_model 4,096,
            d_inner 8,192, d_state 16, dt_rank 256, vocab 65,024, tied)
            and SSM_TRAIN_L layers, held as train_neox is under
            SSM_TRAIN_KERNELS (the scan in place of flash); the traced step
            must show selective_scan_kernel as often as a step launches
            selective_scan.
4f. train_gemma: gemma3-1b at published width (d_model 1,152, 4 heads of
            256 over 1, GELU-GLU d_ff 6,912, tied vocab 262,144, window
            512) and GEMMA_TRAIN_L layers (its pattern cut to one 5:1
            period: 5 local, 1 global), held as train_neox is; the traced
            step must show flash_attention_tc_kernel<256> as often as a
            step launches flash_attention. Both print what train_neox
            prints, and no training rank may record an attention fallback.
4h. ckpt   : the train phase's kernel run also saves a checkpoint after
            its step 3 (CKPT_DIR, per_process: a file a rank a leaf; the
            JAX package's v1 format). (a) The same run resumed from it on
            the same 4 ranks for 2 steps, whose losses and grad norms must
            be the kernel run's steps 4 and 5 bit for bit; (b) resumed on
            2 ranks, (1, 1, 2), for one step (elastic restore: the
            optimizer shards double, each rank reads two writers' files),
            its loss held against step 4's at TRAIN_LOSS_RTOL, its grad
            norm reported; (c) --strict-restore on 2 ranks must fail with
            MeshMismatch before any rank starts. Leg (a) runs in trace
            mode (segments fenced, probes every step, a metrics lane, a
            Chrome trace and a heartbeat a rank; held as 4i holds them), so
            its bit-for-bit match shows that tracing changes nothing on the
            card. In (a) and (b) each rank
            reports the sha256 of every shard it restored and this script
            hashes the same slices read from the files with numpy, by its
            own code; every kernel of TRAIN_KERNELS must launch on every
            rank, with no attention fallback. Prints the bytes on disk,
            save and restore seconds a rank, each leg's step_s and peak
            memory; CKPT_DIR is removed at the end, and on a failure.
4i. replica: qwen2-0.5b at full width and REPLICA_L layers under zero_topo on the
            mesh (data, node, gcd) = (2, 1, 2) (W = gcd, E = node of size 1,
            R = data of size 2: the replica tier is real), four ranks, batch
            8 x 1,024, bf16, quant block 128, REPLICA_STEPS steps from seed 0
            with cross_replica="reduce_scatter" and quantize_update_gather
            (REPLICA_OPTS, through launch.train.run's engine_opts), in trace
            mode with the probes every step; then the same run through the
            plain versions (untraced), held at TRAIN_LOSS_RTOL /
            TRAIN_GNORM_RTOL. Every kernel of TRAIN_KERNELS must launch on
            every rank, and the update all-gather quantize_int8 and
            dequantize_int8 once a leaf a step on every rank (counted inside
            update_all_gather, the probes' launches taken out); no attention
            fallback. Each rank's five segments must sum to its step's wall
            time within SEGMENT_SUM_RTOL; its metrics lane must hold a record
            a step and its Chrome trace every span; rank 0's heartbeat
            report must read every rank ok at the last step. Prints the
            cross_replica and update segments and the five probes by step,
            the segment sums beside the wall times, overlap_efficiency, the
            wire bytes a rank a step of the INT8 update gather beside the
            bf16 gather's and of the reduce-scatter over R beside the
            all-reduce's (the same shapes), step_s, tok/s and peak memory.
4j. serve_mesh: qwen2-0.5b at published width and depth served on the mesh
            (2, 1, 2) by one spawn of four ranks sharing the card (W = gcd,
            R = data; the decode batch over data, the full-attention caches
            along the sequence over (node, gcd), the residency over (gcd,
            node), degree 2), bf16, quant block 128, the weights
            ZeroEngine.init_primaries(seed 0); SERVE_MESH_REQUESTS
            requests of 128 tokens, 4 slots, max length 256,
            SERVE_MESH_GEN new tokens, through continuous batching. Each
            leg but (sp) is the serve launcher's rank (launch.serve.
            serve_rank, the entry point of `--devices 4 --mesh-shape
            2,1,2`), its prefills and steps recorded by its hook. Legs:
            (g) the gathered backend through the kernels; (r) the resident
            backend (degree 2): every prefill's and decode step's logits bit
            for bit (g)'s on every rank, tokens and counters equal; (p) the
            gathered backend through the plain versions, fed (g)'s tokens:
            prefill and decode-step logits within PREFILL_TOL * max|ref|
            of (g)'s, its greedy tokens counted against (g)'s; (sp) one B = 1
            prefill sequence-parallel and not, on (g)'s engine and weights:
            logits and this rank's chunk of every cache entry bit for bit,
            flash_attention launched at q_offset 64 on the second sequence
            rank (Sq 64, Sk 128); no attention fallback on any rank in any
            leg; then (1) the bare one-card launch (serve_rank, (1, 1, 1),
            the default backend) in this process, fed (g)'s tokens: its
            prefills and first decode step bit for bit the mesh's, every
            step within PREFILL_TOL. Prints each leg's prefill_ms,
            decode_step_ms, tok_s, the peak bytes a rank, the payload bytes
            a rank a decode step by collective label beside the prediction
            from the leaf sizes, and the launches a rank of kernels 1, 2, 8
            and 10. Then the MLA leg (minicpm3-4b at MLA_MESH_L layers,
            serve_rank, the latent sharded along the sequence over (node,
            gcd)): (g) through the kernels, (p) through the plain versions
            on (g)'s tokens (PREFILL_TOL), (sp) a sequence-parallel B = 1
            prefill within PREFILL_TOL of (p)'s (the latent gathered under
            lat_gather, no K / V gathered), its fallbacks exact.
4k. plan  : the topology planner and the calibration loop (topo/,
            obs/calibrate.py), on four gloo ranks sharing the card on the
            train phase's mesh (1, 2, 2). (a) Host only: the planner CLI
            (planner.main in this process) on frontier / gpt_neox_20b (its
            own assert: no preset ranks above its choice), with --serve
            --model qwen2-0.5b, and against the calibrated file of (c). (b)
            qwen2-0.5b at published width and REPLICA_L layers trained
            PLAN_STEPS steps through launch.train.run with --scheme auto
            --budget-gb 80 --trace (probes every step): every rank's config
            must equal plan_for_mesh's first choice computed in this process
            with the CLI's overrides (PLAN_AXES: W = (gcd, node), an INT8
            secondary over gcd inside it, no E); every kernel of
            TRAIN_KERNELS launched on every rank, no attention fallback; held
            against the same run through the plain versions at
            TRAIN_LOSS_RTOL / TRAIN_GNORM_RTOL; its trace held as 4i holds
            it. Prints the payload bytes a rank a step by collective label
            (the probes' taken out) beside phase_volumes' figures for the
            same config (neither held: the paper's accounting counts logical
            parameters without scales). (c) Rank 0's measured phase seconds
            (the median of the steps after the first) priced by
            phase_breakdown, back-solved (solve_bandwidths) into
            calibrated(Topology.from_mesh(mesh)), written under PLAN_DIR and
            read back by load_topology; prints each axis's effective
            bandwidth beside its preset (gloo through host memory on one
            card: these describe this machine, no cluster). Then
            obs.calibrate's CLI (its main) with --quick --mesh 1,2,2 at its
            reduced defaults must return 0 and write a topology that
            load_topology reads. PLAN_DIR is removed at the end.
4l. dryrun: the dry run (launch/dryrun.py) in subprocesses on the host,
            started at once (dryrun_phase): (a) the train phase's
            configuration, rank 0 of (1, 2, 2) traced on meta tensors over a
            fake group: its would-be launches equal the train step's
            per_rank_step_launches and its payload by label rank 0's a step,
            exactly; (b) the serve phase's 4-slot decode step on one card:
            launches equal step_launches', and the bytes and operations
            the census bills its kernels equal the kernels line's for the
            same calls, exactly; (c) (a)'s H100 roofline: compute and
            memory terms at most rank 0's traced device seconds a step,
            and each kernel's compute term at most its traced device time
            (its memory term reported beside it);
            (d) on the card, one bf16 matmul of 8,192^3 and a 1 GiB copy
            timed with CUDA events, each rate at most 1.05 x H100_SXM's; (e)
            gpt-neox-20b train_4k on the production mesh (16, 16) under
            zero3, zeropp and zero_topo, then launch.validate on them
            (exit 0: every census inside the paper's window). The census's
            argument and temp bytes are printed beside rank 0's peak.
4b. collectives: four gloo ranks sharing the card on (1, 2, 2) run the
            quantized reduce-scatter at bits 4 and 8 over W, E and all four
            ranks on an embedding-sized f32 shard each; every kernel of
            COLLECTIVE_KERNELS must launch on every rank; wire bytes bit for
            bit and sums within one f32 ulp of the same calls through the
            plain versions; the error against the exact f32 reduce-scatter
            within the reference scenario's bound.
4c. regimes: the train phase's run again for REGIME_STEPS steps with
            --overlap, then with --overlap --stream-grads: TRAIN_KERNELS on
            every rank, losses and grad norms held against the seed run's
            first REGIME_STEPS steps (bitwise reported, failing
            beyond TRAIN_LOSS_RTOL / TRAIN_GNORM_RTOL), step time, tokens/s,
            peak memory, grad_buffer and prefetch_buffer beside the seed's.
5. timing : device time of each kernel, its plain version and, where one
            PyTorch call computes the same function, that call, at the
            serving and training shapes (CUDA graphs of repeated launches,
            CUDA events). dequant_matmul also: one decode step's 169 calls
            all on the SIMT kernel (forced: the head as before its decode path), one
            layer's 7 products at the training M in each orientation beside
            bf16 cuBLAS, one prefill's 169 calls, each decode / prefill shape
            with its path (decode shapes also on SIMT, through the plain
            version and beside bf16 cuBLAS), falcon-mamba's three M = 128
            shapes and its four decode shapes at M = 4, and all three
            paths forced at M = 1 ... 16, 32,
            64, 128 (x @ W) and M = 4 ... 128 (x @ W.T) (the threshold
            rows); the qwen2 decode step as a CUDA graph with its layer
            products on their own path and on SIMT, in turns; dequant_matmul_blocked at w_up on its path
            and on SIMT (forced); flash_attention also at the training shape
            beside SDPA and in f32 at the prefill shape beside f32 SDPA;
            matmul_quant on one layer's seven dW shapes with bf16 operands
            (tensor cores, beside bf16 cuBLAS x.T @ g) and with f32 operands
            (SIMT, beside f32 cuBLAS), each also per shape; flash_attention
            at the NeoX training shapes (D = 96 and 128) beside SDPA; NeoX's
            training products at M = 2,048 (forward and dX on 8a, dW on 9a)
            per shape beside bf16 cuBLAS; flash_attention at gemma3-1b's
            training shape (D = 256, 2 rows x 4/1 heads, S = 1,024, window
            512 and causal) and the scan at falcon-mamba-7b's (B = 2, S =
            1,024) beside the plain versions, SDPA and the bounds.
5b. moe   : phi3.5-moe-42b-a6.6b at published width and depth (32 moe
            layers, 16 experts of 6,400, top 2, LayerNorm, 32 heads of 128
            over 8) served from its INT8 residency (MOE_SERVE_ARGS), held as
            the attention phases hold theirs (attn_serve: the prefill, its
            32 attention sublayers and a decode step against the plain
            versions, 32 launches of flash_attention_tc_kernel<128> and the
            head on 8b in the traced prefill, the decode graphs), after
            flash attention at its prefill's shape (32/8 heads of 128, S =
            128) against its plain version (one bf16 ulp of max|ref|); every
            comparison of two runs pins the expert choices of one (Routing)
            and keeps an f32 run's slots f32 (f32_slots); the bf16 logits
            held by the bf16 / f32 ratio (MOE_BF16_TOL); the residency
            build's peak beside
            its prediction (the residency + one expert row's f32 draw and
            bf16 copy: iter_primaries draws a stack one row at a time); one
            decode step's launches; dequantize_int8 at one layer's expert
            row (419 M int8) against its bound and bit for bit its plain
            version; the products by shape, each against its plain version
            (BF16_TOL).
5c. mixtral: mixtral-8x7b at published width and MIXTRAL_L layers (8
            experts of 14,336, window 4,096: ring caches on an MoE kind), a
            short serve of prompts of 4,224, past the window (the rings
            wrap in prefill and in decode), flash attention at its
            prefill's shape with the window against its plain version, its
            traced prefill (each attention sublayer held) and a decode step
            against the plain versions (bf16 logits by the ratio, as
            phi3.5's).
5d. vlm    : internvl2-1b at published width and depth, 256 seeded patch
            rows before each prompt, through ResidentServeEngine's prefill
            and decode (vlm_phase): SERVE_KERNELS launched, no fallback,
            prefill ms at 384 positions, decode step ms and tok/s; the
            prefill and a decode step against the plain versions.
5f. whisper: whisper-medium at published width and depth (24 encoder
            layers over 1,500 seeded frames, 24 decoder layers with
            cross-attention) through engine_phase, as vlm: a B = 1 prefill
            launches flash 24 times (the decoder at D = 64) and records 48
            seq_unaligned fallbacks (the encoder and the cross-attention);
            both engine phases also trace a prefill and time a decode step
            as a CUDA graph.
5e. train_moe, train_vlm, train_mla, train_whisper: phi3.5-moe at
            MOE_TRAIN_L layers, internvl2-1b at VLM_TRAIN_L, minicpm3-4b at
            MLA_TRAIN_L (no flash: its traced matmul_quant calls held;
            two mla_dv_mismatch fallbacks a layer a step) and
            whisper-medium at WHISPER_TRAIN_L + WHISPER_TRAIN_L (two
            seq_unaligned fallbacks a layer of each a step) trained as
            train_neox is
            (cut_train_phase: the train phase's mesh and batch, 3 steps,
            held against the plain versions, phi3.5's grad norm at
            MOE_GNORM_STEPS; the traced step's tensor-core flash calls at
            head dim 128 and 64).
6. report : JSON lines (serve, serve_ssm, serve_neox, serve_neox10b,
            serve_gemma, serve_deepseek, serve_moe, serve_mixtral,
            serve_vlm, serve_mla, serve_whisper, train, train_neox,
            train_deepseek, train_ssm, train_gemma, train_moe, train_vlm,
            train_mla, train_whisper,
            regimes, collectives, ckpt, replica, serve_mesh, plan, dryrun,
            kernels_extra with the extra
            timing rows and every dequant_matmul shape's path, then the
            kernels line: all 11 kernels with their launches on every
            path, the ckpt legs', the replica run's and the plan run's
            included), the
            card's name and
            power limit (nvidia-smi), and last the line
            {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import hashlib
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.launch.roofline import H100_SXM  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense; the roofline's own, one source):
# bytes/s of HBM, ops/s by type
HBM_BPS = H100_SXM.hbm_bw
PEAK = {"bf16": H100_SXM.peak_flops, "f32": H100_SXM.peak_flops_f32}
# SMs, and special-function (SFU) results a clock an SM on sm_90: the
# scan's exp floor, B*S*D*N exps over SMS * SFU_PER_SM * the SM clock
SMS, SFU_PER_SM = 132, 16
BF16_TOL = 2.0 ** -7
F32_TOL = 1e-5
PREFILL_TOL = 5e-2
# the same prefill with f32 activations on the same INT8 weights: kernels and
# plain versions then differ only by f32 rounding (another order of the
# matmul sums, exp's last bit), about 1e-7 relative per operation; even grown
# 100x through 64 layers that stays 10x under this limit, while a wrong tile,
# split or offset at the served shapes moves whole products
PREFILL_F32_TOL = 1e-4
# the bf16 prefill through the kernels against the f32 plain one may lie at
# most this many times as far off as the bf16 plain prefill does, in the same
# run: two correct bf16 runs differ by rounding alone (about 1x), while a
# wrong tile moves whole products, far above 1.5x
PREFILL_BF16_RATIO = 1.5
# falcon-mamba-7b's bf16 logits, kernels against plain, are held by that
# ratio alone (reported beside PREFILL_TOL): through 64 mamba layers two
# correct bf16 runs differ by 5-6 % of max|ref| (0.3125 of 6.344 on the
# seed's weights, 0.3203 of 5.31 on weights drawn a row at a time, both
# with correct kernels: each run 0.32-0.35 from the f32 plain one), so
# PREFILL_TOL's 5 % lies inside their rounding and decides nothing
SSM_BF16_TOL = None
# the same for an MoE model: its expert outputs, thousands of times the
# attention's, carry the bf16 noise of their inputs into the residual
# stream; with the expert choices pinned (Routing), the bf16 logits of two
# correct phi3.5-moe runs differed by 0.656 of 4.78 (13.7 %). Its bf16
# kernels are held per attention sublayer (attention_held), per product
# (layer_shapes), flash at its shape and the expert row bit for bit
MOE_BF16_TOL = None

# 4 requests (cut from 8 for the script's time): one wave of the 4 slots,
# every decode step full
SERVE_ARGS = ["--arch", "qwen2-0.5b", "--requests", "4", "--slots", "4",
              "--prompt-len", "128", "--gen", "32", "--max-len", "256",
              "--seed", "0", "--backend", "resident"]
TRAIN_ARGS = ["--arch", "qwen2-0.5b", "--scheme", "zero_topo", "--devices", "4",
              "--batch", "8", "--seq", "1024", "--steps", "5",
              "--quant-block", "128", "--compute-dtype", "bfloat16",
              "--seed", "0", "--timeout", "600"]
PROFILE_STEP = 4        # the kernel run traces its last step
# qwen2-0.5b at TRAIN_L of its 24 layers in the train, ckpt and regimes
# phases (cut for the script's time: every leaf trains the same way at any
# depth, and the serving phase runs all 24 layers)
TRAIN_L = 6
# the kernel run also saves a checkpoint after its step CKPT_EVERY (of 5),
# which the ckpt phase resumes on 4 ranks for CKPT_HELD_STEPS steps (held
# against the kernel run's next ones), on 2 ranks for one step, and
# strictly on 2 ranks (refused); the phase removes it
CKPT_DIR = ROOT / "build" / "ckpt_smoke"
CKPT_EVERY = 3
CKPT_HELD_STEPS = 2
# kernels vs plain versions through 5 bf16 training steps, set at 24
# layers: about 20x (loss) and 9x (grad norm) the largest relative differences of
# the first runs on the H100 (4.8e-5 and 1.1e-3). The loss is a mean over
# 8,192 tokens, so bf16 rounding differences average out; the grad norm
# also carries INT4 rounding flips of the gradients.
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GNORM_RTOL = 1e-2
# each training phase's run through the plain versions takes its first
# PLAIN_STEPS steps (qwen2's 5 cut to 3 for the script's time), held step
# by step against the kernel run's: steps 1 and 2 start from the same
# weights in both runs (step 1's learning rate is 0), so they hold the
# kernels' arithmetic alone; step 3 runs on the weights each run's own
# step 2 updated, so it also holds the update path (the optimizer, the
# update gather, the regimes' prefetch of updated weights)
PLAIN_STEPS = 3
# an MoE model's grad norm is held at its first MOE_GNORM_STEPS steps
# only, its loss at all PLAIN_STEPS: from step 3 each run's own update
# sends some (layer, token) rows to other experts (bf16 noise at a top-k
# boundary), and a routed row moves its experts' gradients wholly: the
# grad norm with them (phi3.5 at 1 layer: 8.2e-4, 2.5e-3, then 4.1e-2
# apart), while the loss, a mean over 8,192 tokens, stays within 1.7e-4
# (PERF.md §6) and carries the update: it drops from 11.19 to 9.07 at
# step 3
MOE_GNORM_STEPS = 2
# phase 4i: qwen2-0.5b on the replica mesh (data, node, gcd) = (2, 1, 2):
# W = gcd, E = node of size 1, R = data of size 2, the one mesh whose
# replica tier is real; 3 steps with the reference's two beyond-paper
# options, under trace mode (probes every step), then with --kernel-impl
# plain (untraced: a traced step is bit for bit the untraced one)
REPLICA_STEPS = 3
# at REPLICA_L of qwen2's 24 layers (cut for the script's time: the
# replica tier's reduce-scatter and INT8 update gather run every leaf the
# same way at any depth)
REPLICA_L = 6
REPLICA_ARGS = TRAIN_ARGS[:TRAIN_ARGS.index("--steps") + 1] \
    + [str(REPLICA_STEPS)] + TRAIN_ARGS[TRAIN_ARGS.index("--steps") + 2:] \
    + ["--mesh-shape", "2,1,2"]
REPLICA_OPTS = dict(cross_replica="reduce_scatter", quantize_update_gather=True)
TRACE_DIR = ROOT / "build" / "trace_smoke"
# phase 4k: qwen2-0.5b at REPLICA_L layers trained under --scheme auto on
# the train phase's mesh (1, 2, 2); the planner's choice there (with the
# tier defaults of Topology.from_mesh) is W = (gcd, node) with an INT8
# secondary partition of degree 2 over gcd inside it: no preset's layout
PLAN_STEPS = 3
PLAN_BUDGET_GB = 80
# the replica phase's flags but its arch, scheme and mesh
PLAN_ARGS = ["--arch", "qwen2-0.5b", "--scheme", "auto", "--budget-gb",
             str(PLAN_BUDGET_GB)] + REPLICA_ARGS[4:REPLICA_ARGS.index(
                 "--mesh-shape")]
PLAN_AXES = dict(weight=("gcd", "node"), extra_grad=(), replica=("data",),
                 secondary=("gcd",))
PLAN_DIR = ROOT / "build" / "plan_smoke"
# phase 4j: qwen2-0.5b served on (2, 1, 2), four ranks sharing the card
SERVE_MESH_SHAPE = (2, 1, 2)
SERVE_MESH_REQUESTS, SERVE_MESH_SLOTS = 4, 4
# 3 new tokens a request (cut from 8 to 4 in PR 29 and to 3 in PR 30 for
# the script's time: each leg's step moves 325 MB a rank through gloo; two
# full decode steps a leg remain)
SERVE_MESH_PROMPT, SERVE_MESH_MAX_LEN, SERVE_MESH_GEN = 128, 256, 3
SERVE_MESH_KERNELS = ("quantize_int8", "dequantize_int8", "dequant_matmul",
                      "flash_attention")
# the reference's bound: the fenced segments sum to the step's wall time
SEGMENT_SUM_RTOL = 0.10
SERVE_KERNELS = ("quantize_int8", "dequantize_int8", "dequant_matmul",
                 "flash_attention")
SSM_SERVE_ARGS = ["--arch", "falcon-mamba-7b"] + SERVE_ARGS[2:]
SSM_SERVE_KERNELS = ("quantize_int8", "dequantize_int8", "dequant_matmul",
                     "selective_scan")
# gpt-neox-20b runs the serving kernels of qwen2 (attention at head dim 96)
NEOX_SERVE_ARGS = ["--arch", "gpt-neox-20b"] + SERVE_ARGS[2:]
NEOX_H, NEOX_HD, NEOX_L = 64, 96, 44   # heads (all KV), head dim, layers
NEOX_LEAVES = ("wq", "wk", "wv", "wo", "w_in", "w_out_ff")
# gpt-neox-10b, the paper's second size: the same traffic, head dim 128,
# served at NEOX10B_L of its 32 layers (cut for the script's time: kernel
# 10 at D = 128 runs 30 layers of deepseek-7b and 32 of phi3.5-moe
# besides, and NeoX's layer and 8e head run here and in gpt-neox-20b's 44)
NEOX10B_SERVE_ARGS = ["--arch", "gpt-neox-10b"] + SERVE_ARGS[2:]
NEOX10B_H, NEOX10B_HD, NEOX10B_L = 40, 128, 8
# gemma3-1b at published width and depth: a prompt of 640 (5 x 128) past the
# sliding window of 512, so the 22 local layers' flash calls skip key tiles
# and their rings wrap in prefill and again in decode (positions 640-671)
GEMMA_SERVE_ARGS = ["--arch", "gemma3-1b", "--requests", "4", "--slots", "4",
                    "--prompt-len", "640", "--gen", "32", "--max-len", "768",
                    "--seed", "0", "--backend", "resident"]
# query heads, KV heads, head dim, layers, window
GEMMA_H, GEMMA_HKV, GEMMA_HD, GEMMA_L, GEMMA_W = 4, 1, 256, 26, 512
GEMMA_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
# gpt-neox-20b trained at published width and a cut depth on the qwen2
# train phase's mesh, batch and sequence, 3 steps (the last traced). Each
# layer holds 453 M parameters and embed + head 620 M. NEOX_TRAIN_L is the
# deepest cut whose ranks' max_memory_allocated, summed (the phase prints
# it beside the card's memory and as bytes a parameter), leaves at least
# TRAIN_HEADROOM of the card free and whose plain run fits too
# (probes/train_phases.py --phase depth): at 4 layers the kernel run's sum
# was 64.0 GB (26.3 bytes a parameter) but the plain versions' f32
# temporaries ran the card out of memory, with each rank's CUDA context
# and libraries, about 2 GiB outside the allocator, beside them. Until the
# step updated its state in place, as the reference's donated step does,
# two layers ran the four ranks out of the card in the optimizer update.
# That gave 3 layers (PR 25); cut to 1 for the script's time (kernel 10 at
# D = 96 and NeoX's products also run in its 44 served layers)
NEOX_TRAIN_L = 1
NEOX_TRAIN_ARGS = ["--arch", "gpt-neox-20b"] + TRAIN_ARGS[2:]
NEOX_TRAIN_ARGS[NEOX_TRAIN_ARGS.index("--steps") + 1] = "3"
NEOX_PROFILE_STEP = 2
NEOX_D, NEOX_FF = 6144, 24576
# the untied LM heads' rows (vocab) and widths: gpt-neox-20b, gpt-neox-10b
NEOX_V, NEOX10B_D = 50_432, 5120
# (K, N) of one NeoX layer's six products (wq wk wv wo w_in w_out_ff)
NEOX_LAYER_KN = ((NEOX_D, NEOX_D),) * 4 + ((NEOX_D, NEOX_FF),
                                           (NEOX_FF, NEOX_D))
# each path is held to the kernels it runs, so a kernel that only another
# path launches never fails it
TRAIN_KERNELS = ("quantize_int8", "dequantize_int8", "dequant_matmul",
                 "flash_attention", "quantize_int4", "dequantize_int4_sum",
                 "matmul_quant")
# falcon-mamba-7b and gemma3-1b trained at published width and a cut depth,
# as gpt-neox-20b is (the train phase's mesh, batch and sequence, 3 steps,
# the last traced): falcon-mamba at 1 of its 64 mamba layers (266 M embed +
# 105 M), gemma3-1b at 6 of its 26 layers, one of its 5:1 local / global
# periods (302 M embed + 6 x 26.85 M); cut from 2 and 12 for the script's
# time
SSM_TRAIN_L, GEMMA_TRAIN_L = 1, 6
SSM_TRAIN_ARGS = ["--arch", "falcon-mamba-7b"] + NEOX_TRAIN_ARGS[2:]
GEMMA_TRAIN_ARGS = ["--arch", "gemma3-1b"] + NEOX_TRAIN_ARGS[2:]
# deepseek-7b (arXiv:2401.02954), dense MHA: served at published width and
# depth (30 layers, d_model 4,096, 32 heads of 128, SiLU-GLU d_ff 11,008,
# untied vocab 102,400; its head's rows of 4,096 take the decode path's
# dmm_dec_tn_kernel, 8b), and trained like gpt-neox-20b at DEEPSEEK_TRAIN_L
# layers (839 M embed + head, 202.4 M a layer), chosen the same way: the
# kernel run fit up to 10 layers (74.9 GB summed, 26.2 bytes a parameter),
# the plain one not at 10, and at 7 with its reserved memory and the
# ranks' contexts within about 1 GB of the card, too little beside this
# script's own process; cut from 6 to 1 for the script's time
# (train_moe trains kernel 10 at D = 128 too)
DEEPSEEK_SERVE_ARGS = ["--arch", "deepseek-7b"] + SERVE_ARGS[2:]
DEEPSEEK_H, DEEPSEEK_HD, DEEPSEEK_L = 32, 128, 30
DEEPSEEK_LEAVES = GEMMA_LEAVES      # wq wk wv wo w_gate w_up w_down
DEEPSEEK_TRAIN_L = 1
DEEPSEEK_TRAIN_ARGS = ["--arch", "deepseek-7b"] + NEOX_TRAIN_ARGS[2:]
# phi3.5-moe-42b-a6.6b (hf:microsoft/Phi-3.5-MoE-instruct) at published
# width and depth: 32 ``moe`` layers (32 heads of 128 over 8 KV heads,
# LayerNorm, 16 SiLU-GLU experts of 6,400 a layer, top 2), untied vocab
# 32,064; 41.87 G parameters, an INT8 residency of 41.9 GB + 1.3 GB of
# scales. Served by the resident backend (its bf16 primaries, 84 GB, do not
# fit the card) with 4 requests: each decode step dequantizes the layer's
# three expert stacks (16 x 4,096 x 6,400 each) whole
MOE_SERVE_ARGS = ["--arch", "phi3.5-moe-42b-a6.6b", "--requests", "4",
                  "--slots", "4", "--prompt-len", "128", "--gen", "32",
                  "--max-len", "256", "--seed", "0", "--backend", "resident"]
MOE_H, MOE_HD, MOE_L = 32, 128, 32
MOE_LEAVES = ("wq", "wk", "wv", "wo")
# mixtral-8x7b (arXiv:2401.04088) at published width, 2 of its 32 layers
# (8 experts of 14,336, window 4,096: the ring caches on an MoE kind), a
# short serve held against the plain versions, its prompts of 4,224 past
# the window (as gemma3's 640 run past 512): the flash calls skip key
# tiles, the rings wrap in prefill and again in decode
MIXTRAL_L, MIXTRAL_W = 2, 4096
MIXTRAL_SERVE_ARGS = ["--arch", "mixtral-8x7b", "--requests", "2",
                      "--slots", "2", "--prompt-len", "4224", "--gen", "8",
                      "--max-len", "4352", "--seed", "0", "--backend",
                      "resident"]
# phi3.5 trained on the train phase's mesh, batch and sequence at
# MOE_TRAIN_L layers (1.32 G parameters a layer, 263 M embed + head)
MOE_TRAIN_L = 1
MOE_TRAIN_ARGS = ["--arch", "phi3.5-moe-42b-a6.6b"] + NEOX_TRAIN_ARGS[2:]
# internvl2-1b (arXiv:2404.16821): qwen2-0.5b's decoder (14 heads of 64
# over 2, tied vocab 151,655) behind 256 patch embeddings (the vision tower
# is a stub: its output is an input, drawn from the seed). Served at
# published width and depth through ResidentServeEngine's prefill and
# decode (the continuous batcher takes text prompts only, as the
# reference's), VLM_SLOTS prompts of VLM_PROMPT tokens behind the patches,
# VLM_GEN new tokens; trained at VLM_TRAIN_L of its 24 layers (the train
# phase's 1,024 positions a row: 256 patches + 768 text tokens)
VLM_SERVE_ARGS = ["--arch", "internvl2-1b", "--seed", "0", "--backend",
                  "resident"]
VLM_P, VLM_D, VLM_H, VLM_HD, VLM_L = 256, 896, 14, 64, 24
VLM_PROMPT, VLM_SLOTS, VLM_GEN = 128, 4, 32
VLM_TRAIN_L = 6
VLM_TRAIN_ARGS = ["--arch", "internvl2-1b"] + NEOX_TRAIN_ARGS[2:]
# minicpm3-4b (hf:openbmb/MiniCPM3-4B): 62 MLA layers (d_model 2,560, 40
# heads, q_lora 768, kv_lora 256, qk_nope 64, qk_rope 32, v_head 64,
# SiLU-GLU d_ff 6,400, untied vocab 73,448) served at published width and
# depth with the qwen2 phase's traffic. Its value width (64) is not its key
# width (96), so every prefill attention takes the chunked plain path, as
# the reference's gate says (one mla_dv_mismatch a layer a prefill), and
# flash never launches; w_dkv (2,560 x 288: not whole blocks of 128) is
# dequantized whole in every prefill and decode step, w_ukv read whole
# (absorbed) in every decode step
MLA_SERVE_ARGS = ["--arch", "minicpm3-4b"] + SERVE_ARGS[2:]
MLA_L = 62
MLA_SERVE_KERNELS = ("quantize_int8", "dequantize_int8", "dequant_matmul")
MLA_FALLBACK = "attention/fallback/mla_dv_mismatch"
UNALIGNED = "attention/fallback/seq_unaligned"
# predicted from the code before the first card run: a B = 1 prefill
# dequantizes w_dkv a layer and the prompt's embedding rows (kernel 2) and
# runs w_dq, w_uq, w_ukv, wo, w_gate, w_up, w_down a layer on 8a and the
# head on 8b (kernel 8); a decode step of 4 slots dequantizes w_dkv and
# w_ukv a layer and the embedding rows, and runs the six other products a
# layer on 8d and the head on 8b
MLA_PREFILL_LAUNCHES = {"dequantize_int8": MLA_L + 1,
                        "dequant_matmul": 7 * MLA_L + 1}
MLA_STEP_LAUNCHES = {"dequantize_int8": 2 * MLA_L + 1,
                     "dequant_matmul": 6 * MLA_L + 1}
# trained at published width and MLA_TRAIN_L layers (63.2 M parameters a
# layer, 376 M embed + head; 2 layers summed 20.70 GB, cut to 1 for the
# script's time), the train phase's mesh, batch and sequence;
# no flash launch (the chunked plain path, two fallbacks a layer a step:
# the forward and its checkpointed recompute), so its traced step is held
# on matmul_quant's tensor-core kernel
MLA_TRAIN_L = 1
MLA_TRAIN_ARGS = ["--arch", "minicpm3-4b"] + NEOX_TRAIN_ARGS[2:]
MLA_TRAIN_KERNELS = tuple(k for k in TRAIN_KERNELS if k != "flash_attention")
# and served on (2, 1, 2) in phase 4j at MLA_MESH_L layers: the latent
# cache sharded along the sequence over (node, gcd)
MLA_MESH_L = 2
# whisper-medium (arXiv:2212.04356): 24 encoder layers over 1,500 frame
# embeddings (the front end is a stub: its output is an input, drawn from
# the seed), 24 decoder layers with cross-attention, d_model 1,024, 16
# heads of 64, LayerNorm, GELU MLP with biases, untied vocab 51,865. Served
# at published width and depth through ResidentServeEngine (the batcher
# takes text prompts only), WHISPER_SLOTS prompts of WHISPER_PROMPT tokens;
# the decoder's self-attention on flash at D = 64, the encoder and the
# cross-attention on the chunked plain path (1,500 is not a multiple of
# 128). Trained with encoder and decoder cut alike to WHISPER_TRAIN_L
# (2 + 2 summed 9.31 GB; cut to 1 + 1 for the script's time)
WHISPER_SERVE_ARGS = ["--arch", "whisper-medium", "--seed", "0",
                      "--backend", "resident"]
WHISPER_L = 24
WHISPER_PROMPT, WHISPER_SLOTS, WHISPER_GEN = 128, 4, 32
WHISPER_TRAIN_L = 1
WHISPER_TRAIN_ARGS = ["--arch", "whisper-medium"] + NEOX_TRAIN_ARGS[2:]
# jamba-v0.1-52b (arXiv:2403.19887), the mamba / attention hybrid, at
# published width and depth: 32 layers of d_model 4,096, 28 mamba mixers
# (d_inner 8,192, d_state 16) and 4 attention layers (4, 12, 20, 28: 32
# heads over 8 of 128, no RoPE), the MoE FFN (16 SiLU-GLU experts of
# 14,336, top 2) behind the 16 odd layers and a SiLU-GLU MLP of 14,336
# behind the others, untied vocab 65,536; 51.57 G parameters, an INT8
# residency of 53.18 GB with its scales. Served through the batcher with
# phi3.5-moe's traffic: the attention layers' K/V paged, the mamba states
# per slot in the same pool
JAMBA_SERVE_ARGS = ["--arch", "jamba-v0.1-52b"] + MOE_SERVE_ARGS[2:]
JAMBA_L, JAMBA_ATTN_L, JAMBA_MAMBA_L, JAMBA_MOE_L = 32, 4, 28, 16
JAMBA_SERVE_KERNELS = SERVE_KERNELS + ("selective_scan",)
# predicted from the code before the first card run: a forward pass (a
# B = 1 prefill or a 4-slot decode step) dequantizes the 48 expert stacks
# (3 an MoE layer), each mamba layer's w_xproj (8,192 x 288: not whole
# blocks) and the embedding rows (kernel 2), and runs w_in, w_dt, w_out a
# mamba layer, w_gate, w_up, w_down an MLP, wq, wk, wv, wo an attention
# layer and the head (kernel 8); a prefill also runs flash an attention
# layer and the scan a mamba layer (a decode step's scan is the O(1)
# update in plain torch)
JAMBA_STEP_LAUNCHES = {
    "dequantize_int8": 3 * JAMBA_MOE_L + JAMBA_MAMBA_L + 1,
    "dequant_matmul": 3 * JAMBA_MAMBA_L + 3 * (JAMBA_L - JAMBA_MOE_L)
    + 4 * JAMBA_ATTN_L + 1}
JAMBA_PREFILL_LAUNCHES = dict(JAMBA_STEP_LAUNCHES,
                              flash_attention=JAMBA_ATTN_L,
                              selective_scan=JAMBA_MAMBA_L)
# trained at published width and its first layer (mamba_mlp: 0.82 G
# parameters); layer 1 is mamba_moe, whose expert stacks alone hold 2.82 G
# parameters (about 100 GB summed at phi3.5-moe's 29.2 bytes a parameter),
# so mamba_moe and attn_mlp train at reduced size on the CPU
# (tests/test_torch_jamba.py)
JAMBA_TRAIN_L = 1
JAMBA_TRAIN_ARGS = ["--arch", "jamba-v0.1-52b"] + NEOX_TRAIN_ARGS[2:]
# the summed peak a cut-depth phase is chosen to stay under: the card's
# memory less this headroom (printed, not held)
TRAIN_HEADROOM = 8 * 2 ** 30
# the mamba block runs the scan where an attention block runs flash
SSM_TRAIN_KERNELS = tuple("selective_scan" if k == "flash_attention" else k
                          for k in TRAIN_KERNELS)
# the reference's own tolerance between dequant_matmul_pallas and its
# oracle (tests/test_kernels.py): the f32 sums run in another order
BLOCKED_RTOL, BLOCKED_ATOL = 2e-5, 5e-4
# phase 4l: the dry run (launch/dryrun.py) in subprocesses on the host
DRYRUN_DIR = ROOT / "build" / "dryrun_smoke"
DRYRUN_TIMEOUT = 300
NEOX_SCHEMES = ("zero3", "zeropp", "zero_topo")
PEAK_MATMUL_N = 8192            # attained bf16 matmul: one N^3 product
PEAK_COPY_BYTES = 2 ** 30       # attained copy: 1 GiB device to device
PEAK_SLACK = 1.05               # a reading above 1.05 x its peak is wrong
# each CUDA kernel's device function (csrc/*.cu) by the kernels/ops.py
# wrapper that launches it: a traced step's device time by wrapper
DEVICE_KERNELS = {
    "quantize_int8_kernel": "quantize_int8",
    "dequantize_int8_vec": "dequantize_int8",
    "dequantize_int8_elem": "dequantize_int8",
    "dequantize_int8_sum_vec4": "dequantize_int8_sum",
    "dequantize_int8_sum_elem": "dequantize_int8_sum",
    "quantize_int4_kernel": "quantize_int4",
    "quantize_int4_wide_kernel": "quantize_int4",
    "dequantize_int4_vec4": "dequantize_int4",
    "dequantize_int4_byte": "dequantize_int4",
    "dequantize_int4_sum_vec4": "dequantize_int4_sum",
    "dequantize_int4_sum_byte": "dequantize_int4_sum",
    "dequant_matmul_blocked_kernel": "dequant_matmul_blocked",
    "dmb_tc_kernel": "dequant_matmul_blocked",
    "flash_attention_kernel": "flash_attention",
    "flash_attention_tc_kernel": "flash_attention",
    "matmul_quant_simt_kernel": "matmul_quant",
    "matmul_quant_tc_kernel": "matmul_quant",
    "selective_scan_kernel": "selective_scan",
} | {f"dmm_{p}_kernel": "dequant_matmul"
     for p in ("nt", "split_sum", "tn", "tc_tn", "tc_nt", "dec_tn",
               "dec_tn_wide", "dec_nt")}
QUANT_ERROR_BLOCKS = (64, 256, 1024, 4096, 16384)   # benchmarks/quant_error.py
# the bits 4 and 8 quantized reduce-scatters run these on every rank
COLLECTIVE_KERNELS = ("quantize_int8", "quantize_int4", "dequantize_int4_sum",
                      "dequantize_int8_sum")
REGIME_STEPS = 3        # the --overlap [--stream-grads] runs
# the prefetch alone, then with the streaming grads: each one's peak memory
# against the seed run's shows what each regime does to it
REGIME_FLAGS = (("--overlap",), ("--overlap", "--stream-grads"))
SCAN_D, SCAN_N = 8192, 16           # falcon-mamba-7b's d_inner and d_state
MAMBA_D, MAMBA_DTR, MAMBA_V, MAMBA_L = 4096, 256, 65_024, 64

KERNEL_INFO = {
    "quantize_int8": ("src/repro_torch/csrc/quant_int8.cu",
                      "src/repro/kernels/quant_blockwise.py:40"),
    "dequantize_int8": ("src/repro_torch/csrc/quant_int8.cu",
                        "src/repro/kernels/quant_blockwise.py:63"),
    "dequant_matmul": ("src/repro_torch/csrc/dequant_matmul.cu",
                       "src/repro/kernels/dequant_matmul.py:113"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:92"),
    "quantize_int4": ("src/repro_torch/csrc/quant_int4.cu",
                      "src/repro/kernels/quant_int4.py:46"),
    "dequantize_int4_sum": ("src/repro_torch/csrc/quant_int4.cu",
                            "src/repro/kernels/quant_int4.py:105"),
    "matmul_quant": ("src/repro_torch/csrc/matmul_quant.cu",
                     "src/repro/kernels/dequant_matmul.py:209"),
    "selective_scan": ("src/repro_torch/csrc/selective_scan.cu",
                       "src/repro/kernels/selective_scan.py:56"),
    "dequantize_int8_sum": ("src/repro_torch/csrc/quant_int8.cu",
                            "src/repro/kernels/quant_blockwise.py:92"),
    "dequantize_int4": ("src/repro_torch/csrc/quant_int4.cu",
                        "src/repro/kernels/quant_int4.py:68"),
    "dequant_matmul_blocked": ("src/repro_torch/csrc/dequant_matmul_blocked.cu",
                               "src/repro/kernels/dequant_matmul.py:39"),
}
# the flat dequant-matmul's paths (PERF.md's rows 8a-8e) and their kernels
# (csrc/dequant_matmul.cu), named in the kernels line
DMM_PATHS = {
    "8a": "tensor_core: dmm_tc_tn_kernel, dmm_tc_nt_kernel",
    "8b": "decode, x @ W.T up to N = 4,096: dmm_dec_tn_kernel",
    "8c": "simt: dmm_nt_kernel, dmm_tn_kernel",
    "8d": "decode, bf16 x @ W: dmm_dec_nt_kernel",
    "8e": "decode, bf16 x @ W.T past N = 4,096: dmm_dec_tn_wide_kernel",
}
# (K, N) of one layer's seven dW products (wq wk wv wo w_gate w_up w_down)
LAYER_KN = ((896, 896), (896, 128), (896, 128), (896, 896), (896, 4864),
            (896, 4864), (4864, 896))
TRAIN_M = 2048                      # tokens per rank: 8 x 1024 over 4 ranks
SCAN_TRAIN_B = TRAIN_M // 1024      # a rank's rows of 1,024 in training
# bf16 rows from which dequant_matmul takes the tensor cores, x @ W and
# x @ W.T (chosen by the timing phase's dequant_matmul_threshold rows;
# csrc/dequant_matmul.cu's TC_MIN_M, TC_MIN_M_T): the checks hold the path
# of each shape to them
TC_MIN_M, TC_MIN_M_T = 5, 64
# rows up to which the decode path takes an x @ W.T call
# (csrc/dequant_matmul.cu's DEC_MAX_M_T; chosen by the timing phase's
# dequant_matmul_threshold rows), and the largest row its f32 kernel takes
# (one 16-byte chunk a thread); bf16 rows past it take the wide kernel
DEC_MAX_M_T, DEC_TN_MAX_N = 16, 4096
# rows up to which the decode path takes a bf16 x @ W call
# (csrc/dequant_matmul.cu's DEC_MAX_M; chosen by the same rows)
DEC_MAX_M = 8
EMBED_N = 151_936 * 896             # the tied embedding's padded length


class Failed(RuntimeError):
    pass


def bound_ms(n_bytes: float, n_ops: float, op_type: str):
    t_bytes = n_bytes / HBM_BPS * 1e3
    t_ops = n_ops / PEAK[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(fn, reps: int = 10, replays: int = 3) -> float:
    """Device time of one ``fn()``: ``reps`` calls captured in one CUDA graph,
    replayed ``replays`` times between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(replays):
        graph.replay()
    e1.record()
    e1.synchronize()
    ms = e0.elapsed_time(e1) / (reps * replays)
    del graph
    torch.cuda.synchronize()
    return ms


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, max |want|), in f32."""
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise Failed("non-finite kernel output")
    return float((g - w).abs().max()), float(w.abs().max())


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def add_check(checks, name, what, err, tol):
    checks.setdefault(name, []).append(dict(case=what, max_abs_err=err,
                                            tolerance=tol))
    print(f"  {name:16s} {what:44s} max_abs_err={err:.3e} tol={tol}")


def expected_path(m, k, n, block, transpose, dtype) -> str:
    """The flat dequant-matmul's path by the rule csrc/dequant_matmul.cu
    documents: decode for x @ W.T at M <= DEC_MAX_M_T with block % 16 == 0
    (f32 or bf16 up to N = DEC_TN_MAX_N, bf16 past it) and for bf16 x @ W at
    M <= DEC_MAX_M with block % 64 == 0 and K % 8 == 0, then the tensor
    cores for bf16 (block % 64 == 0, K % 8 == 0, M >= TC_MIN_M /
    TC_MIN_M_T), else SIMT."""
    if transpose and m <= DEC_MAX_M_T and block % 16 == 0 \
            and (n <= DEC_TN_MAX_N or dtype == torch.bfloat16):
        return "decode"
    if not transpose and m <= DEC_MAX_M and dtype == torch.bfloat16 \
            and block % 64 == 0 and k % 8 == 0:
        return "decode"
    if dtype == torch.bfloat16 and block % 64 == 0 and k % 8 == 0 and \
            m >= (TC_MIN_M_T if transpose else TC_MIN_M):
        return "tensor_core"
    return "simt"


def expected_int4_path(block, aligned) -> str:
    """quantize_int4's variant by the rule csrc/quant_int4.cu documents:
    wide for blocks of 8 times a power of two up to 2,048 elements on x
    aligned to 16 bytes, else warp."""
    units = block // 8
    if aligned and block % 8 == 0 and 0 < units <= 256 \
            and units & (units - 1) == 0:
        return "wide"
    return "warp"


def attn_case(checks, gen, dev, what, b, h, hkv, sq, sk, q_offset, window,
              dtype, hd, causal: bool = True):
    """flash_attention (B, S, H, hd) through the kernel against its plain
    version: bf16 within one bf16 ulp of max|ref|, f32 within F32_TOL."""
    from repro_torch.models import layers

    q = torch.randn((b, sq, h, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, sk, hkv, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, sk, hkv, hd), generator=gen, device=dev).to(dtype)
    ok = layers.flash_attention(q, k, v, causal=causal, window=window,
                                q_offset=q_offset)
    op = layers.flash_attention(q, k, v, causal=causal, window=window,
                                q_offset=q_offset, impl="plain")
    err, scale = rel_err(ok, op)
    tol = (BF16_TOL if dtype == torch.bfloat16 else F32_TOL) * scale
    if ok.shape != op.shape or err > tol:
        raise Failed(f"flash_attention {what}: err {err} > {tol}")
    add_check(checks, "flash_attention", what, err, f"{tol:.3e}")


def check_kernels(dev, gen, checks):
    from repro_torch.kernels import ops
    from repro_torch.kernels.dequant_matmul import (PATHS, dequant_matmul_path,
                                                    matmul_quant_path)
    from repro_torch.kernels.quant_int4 import INT4_PATHS, quantize_int4_path

    def record(name, what, err, tol):
        add_check(checks, name, what, err, tol)

    def quant_case(what, n_blocks, block, dtype, scale_spread=True):
        x = torch.randn((n_blocks, block), generator=gen, device=dev)
        if scale_spread:
            x *= torch.rand((n_blocks, 1), generator=gen, device=dev) * 50
        x[n_blocks // 2] = 0.0
        x = x.to(dtype).reshape(-1)
        qk, sk = ops.quantize_int8(x, block)
        qp, sp = ops.quantize_int8(x, block, impl="plain")
        if not (torch.equal(qk, qp) and torch.equal(sk.view(torch.int32),
                                                    sp.view(torch.int32))):
            raise Failed(f"quantize_int8 {what}: not bitwise equal")
        record("quantize_int8", what, 0.0, "bitwise")
        for odt in (torch.bfloat16, torch.float32):
            dk = ops.dequantize_int8(qk, sk, block, odt)
            dp = ops.dequantize_int8(qk, sk, block, odt, impl="plain")
            if not torch.equal(dk, dp):
                raise Failed(f"dequantize_int8 {what} -> {odt}: not bitwise")
            record("dequantize_int8", f"{what} -> {str(odt)[6:]}", 0.0,
                   "bitwise")

    # w_gate stack of qwen2-0.5b (24 x 896*4864) in bf16, the residency's
    # largest quantize; the prefill embedding rows (128 x 896); ragged
    quant_case("(24*896*4864/128, 128) bf16", 24 * 896 * 4864 // 128, 128,
               torch.bfloat16, scale_spread=False)
    quant_case("(128*896/128, 128) bf16", 128 * 896 // 128, 128, torch.bfloat16)
    quant_case("(37, 128) f32 ragged", 37, 128, torch.float32)
    quant_case("(37, 64) bf16 ragged", 37, 64, torch.bfloat16)
    # falcon-mamba-7b's w_xproj (8192 x 288: not a whole number of blocks per
    # row, so every layer dequantizes it whole to bf16)
    quant_case(f"({SCAN_D}*288/128, 128) bf16 (w_xproj)", SCAN_D * 288 // 128,
               128, torch.bfloat16)

    def stack_case(what, n, block, chunk=1 << 28):
        """One n-element bf16 quantize_int8 and dequantize_int8 (to bf16)
        call, as the residency's largest stack runs them, held bit for bit
        against the plain versions run per chunk of whole blocks (blocks are
        independent; chunks keep the plain f32 temporaries small)."""
        x = torch.empty(n, dtype=torch.bfloat16, device=dev)
        for part in x.split(chunk):
            part.copy_(torch.randn(part.shape, generator=gen, device=dev))
        qk, sk = ops.quantize_int8(x, block)
        dk = ops.dequantize_int8(qk, sk, block, torch.bfloat16)
        for i in range(0, n, chunk):
            j, bi, bj = min(n, i + chunk), i // block, min(n, i + chunk) // block
            qp, sp = ops.quantize_int8(x[i:j], block, impl="plain")
            if not (torch.equal(qk[i:j], qp) and torch.equal(
                    sk[bi:bj].view(torch.int32), sp.view(torch.int32))):
                raise Failed(f"quantize_int8 {what}: not bitwise equal at "
                             f"elements {i}..{j}")
            dp = ops.dequantize_int8(qk[i:j], sk[bi:bj], block, torch.bfloat16,
                                     impl="plain")
            if not torch.equal(dk[i:j], dp):
                raise Failed(f"dequantize_int8 {what} -> bfloat16: not bitwise "
                             f"at elements {i}..{j}")
        record("quantize_int8", what, 0.0, "bitwise")
        record("dequantize_int8", f"{what} -> bfloat16", 0.0, "bitwise")

    # falcon-mamba-7b's w_in stack (64 x 4096*16384 = 2^32 elements), the
    # residency's largest quantize: offsets past 2^31 and 2^32
    stack_case(f"({MAMBA_L}*{MAMBA_D}*{2 * SCAN_D}/128, 128) bf16 (w_in stack)",
               MAMBA_L * MAMBA_D * 2 * SCAN_D, 128)

    def offset_case(what, n_blocks, block, offset):
        """dequantize_int8 of q as a view at byte ``offset`` into a larger
        int8 buffer (off the 16-byte grid), to bf16 and f32, bit for bit."""
        x = torch.randn(n_blocks * block, generator=gen, device=dev) * 3
        q, sc = ops.quantize_int8(x, block)
        buf = torch.zeros(q.numel() + 16, dtype=torch.int8, device=dev)
        buf[offset:offset + q.numel()] = q
        qv = buf[offset:offset + q.numel()]
        for odt in (torch.bfloat16, torch.float32):
            dk = ops.dequantize_int8(qv, sc, block, odt)
            dp = ops.dequantize_int8(qv, sc, block, odt, impl="plain")
            if not torch.equal(dk, dp):
                raise Failed(f"dequantize_int8 {what} -> {odt}: not bitwise")
            record("dequantize_int8", f"{what} -> {str(odt)[6:]}", 0.0,
                   "bitwise")

    # q off the 16-byte grid, with n a multiple of 16 and not
    offset_case("(37, 20) q at offset 1, n % 16 != 0", 37, 20, 1)
    offset_case("(300, 128) q at offset 1", 300, 128, 1)

    def mm_case(what, m, k, n, block, transpose, dtype, offset=0):
        """One dequant_matmul against its plain version; the shape must take
        the path ``expected_path`` names. ``offset`` puts q at that byte
        offset into a larger int8 buffer (a view off the 16-byte grid)."""
        w = torch.randn(k * n + 3 * block, generator=gen, device=dev) * 0.05
        q, s = ops.quantize_int8(w, block)
        if offset:
            buf = torch.zeros(q.numel() + 16, dtype=torch.int8, device=dev)
            buf[offset:offset + q.numel()] = q
            q = buf[offset:offset + q.numel()]
        x = torch.randn((m, n if transpose else k), generator=gen,
                        device=dev).to(dtype)
        took = PATHS[dequant_matmul_path(m, k, n, block, transpose, dtype)]
        path = expected_path(m, k, n, block, transpose, dtype)
        if took != path:
            raise Failed(f"dequant_matmul {what}: took the {took} path, not "
                         f"{path}")
        yk = ops.dequant_matmul(x, q, s, (k, n), block, transpose=transpose,
                                dtype=dtype)
        yp = ops.dequant_matmul(x, q, s, (k, n), block, transpose=transpose,
                                dtype=dtype, impl="plain")
        err, scale = rel_err(yk, yp)
        tol = (BF16_TOL if dtype == torch.bfloat16 else F32_TOL) * scale
        if yk.shape != yp.shape or err > tol:
            raise Failed(f"dequant_matmul {what} ({took}): err {err} > {tol}")
        record("dequant_matmul", f"{what} {took}", err, f"{tol:.3e}")

    d, ff, hd, V = 896, 4864, 64, 151_936
    for m in (1, 4, 128):
        for k, n in ((d, 14 * hd), (d, 2 * hd), (14 * hd, d), (d, ff), (ff, d)):
            mm_case(f"M={m} ({k}, {n}) bf16", m, k, n, 128, False, torch.bfloat16)
    for m in (1, 4):
        mm_case(f"M={m} ({V}, {d}).T bf16 (LM head)", m, V, d, 128, True,
                torch.bfloat16)
    # falcon-mamba-7b: w_in, w_dt, w_out at decode (M = 1, 4 slots) and
    # prefill (M = 128) sizes, the tied LM head at M = 1 and 4
    for m in (1, 4, 128):
        for k, n in ((MAMBA_D, 2 * SCAN_D), (MAMBA_DTR, SCAN_D),
                     (SCAN_D, MAMBA_D)):
            mm_case(f"M={m} ({k}, {n}) bf16 (falcon-mamba)", m, k, n, 128,
                    False, torch.bfloat16)
    for m in (1, 4):
        mm_case(f"M={m} ({MAMBA_V}, {MAMBA_D}).T bf16 (falcon-mamba LM head)",
                m, MAMBA_V, MAMBA_D, 128, True, torch.bfloat16)
    # the decode path's wide kernel (bf16 x @ W.T past DEC_TN_MAX_N):
    # NeoX's untied heads at M = 1 and 4; the first row past the old limit
    # (N = 4,112 at block 16: a last stage of one k16 slice), N = 8,192,
    # block 48 (blocks across stages, a last stage of 2 slices), block 256
    # (a block over two stages), K ragged against the 16-row tile, M = 8, 9
    # (x in two n8 tiles) and 16, and the first M past it and f32 (SIMT)
    bf = torch.bfloat16
    for dm, arch in ((NEOX_D, "gpt-neox-20b"), (NEOX10B_D, "gpt-neox-10b")):
        for m in (1, 4):
            mm_case(f"M={m} ({NEOX_V}, {dm}).T bf16 ({arch} LM head)", m,
                    NEOX_V, dm, 128, True, bf)
    mm_case("M=4 (1000, 4112).T bf16 block 16", 4, 1000, 4112, 16, True, bf)
    mm_case("M=4 (2000, 8192).T bf16", 4, 2000, 8192, 128, True, bf)
    mm_case("M=4 (500, 4128).T bf16 block 48", 4, 500, 4128, 48, True, bf)
    mm_case("M=2 (500, 4608).T bf16 block 256", 2, 500, 4608, 256, True, bf)
    mm_case("M=3 (333, 6144).T bf16 ragged", 3, 333, 6144, 128, True, bf)
    for m in (8, 9, DEC_MAX_M_T, DEC_MAX_M_T + 1):
        mm_case(f"M={m} (1000, 6144).T bf16", m, 1000, 6144, 128, True, bf)
    mm_case("M=4 (1000, 6144).T f32", 4, 1000, 6144, 128, True, torch.float32)
    # the decode path (x @ W.T): f32 and ragged K (a last stage cut short),
    # three row tiles (M = 12), the last decode M and the first past it (bf16
    # and f32), block 32 (x @ W: SIMT); x @ W at M = 3, f32, ragged: SIMT
    mm_case("M=3 (200, 192) f32 ragged", 3, 200, 192, 64, False, torch.float32)
    # the decode path's x @ W: the last decode M and the first past it, K
    # ragged against its 64-row step (block 64, three column tiles), and K
    # off the 16-byte grid of x's rows (SIMT)
    for m in (DEC_MAX_M, DEC_MAX_M + 1):
        mm_case(f"M={m} ({ff}, {d}) bf16", m, ff, d, 128, False, torch.bfloat16)
    mm_case("M=3 (200, 192) bf16 ragged", 3, 200, 192, 64, False,
            torch.bfloat16)
    mm_case("M=4 (333, 192) bf16 ragged", 4, 333, 192, 64, False,
            torch.bfloat16)
    mm_case("M=7 (333, 192).T f32 ragged", 7, 333, 192, 64, True, torch.float32)
    mm_case(f"M=12 ({ff}, {d}).T bf16", 12, ff, d, 128, True, torch.bfloat16)
    for m in (DEC_MAX_M_T, DEC_MAX_M_T + 1):
        mm_case(f"M={m} ({ff}, {d}).T bf16", m, ff, d, 128, True,
                torch.bfloat16)
        mm_case(f"M={m} ({ff}, {d}).T f32", m, ff, d, 64, True, torch.float32)
    for tr in (False, True):
        mm_case(f"M=4 (64, 192){'.T' if tr else ''} bf16 block 32", 4, 64, 192,
                32, tr, torch.bfloat16)
    mm_case("M=130 (72, 256) bf16 ragged", 130, 72, 256, 64, False,
            torch.bfloat16)
    # the tensor-core path: the training M in both orientations at qwen2's
    # four shapes, each side of the thresholds, f32 at the prefill M
    for k, n in sorted(set(LAYER_KN)):
        for tr in (False, True):
            mm_case(f"M={TRAIN_M} ({k}, {n}){'.T' if tr else ''} bf16", TRAIN_M,
                    k, n, 128, tr, torch.bfloat16)
    for tr, first in ((False, TC_MIN_M), (True, TC_MIN_M_T)):
        for m in (first - 1, first, first + 1):
            mm_case(f"M={m} ({d}, {ff}){'.T' if tr else ''} bf16", m, d, ff, 128,
                    tr, torch.bfloat16)
    mm_case("M=128 (896, 4864) f32", 128, d, ff, 128, False, torch.float32)
    # ragged against the 128 x 128 tile but 16-byte aligned rows (block 64):
    # tensor cores; K = 333 leaves x (or out) rows off the 16-byte grid: SIMT
    for m, k, n in ((130, 72, 192), (2047, 328, 256), (130, 328, 64),
                    (2047, 72, 320)):
        for tr in (False, True):
            mm_case(f"M={m} ({k}, {n}){'.T' if tr else ''} bf16 ragged", m, k, n,
                    64, tr, torch.bfloat16)
    for tr in (False, True):
        mm_case(f"M=130 (333, 192){'.T' if tr else ''} bf16 ragged", 130, 333,
                192, 64, tr, torch.bfloat16)
    # q as a view at byte offset 1 of a larger buffer, on each path
    for m, n in ((128, ff), (20, ff), (4, ff), (4, d)):
        for tr in (False, True):
            mm_case(f"M={m} ({d}, {n}){'.T' if tr else ''} bf16 q at offset 1",
                    m, d, n, 128, tr, torch.bfloat16, offset=1)

    def attn(what, b, h, hkv, sq, sk, q_offset, window, dtype):
        attn_case(checks, gen, dev, what, b, h, hkv, sq, sk, q_offset, window,
                  dtype, 64)

    attn("B=1 H=14/2 S=128 causal bf16 (prefill)", 1, 14, 2, 128, 128, 0, 0,
         torch.bfloat16)
    attn("B=2 H=6/2 S=100 causal f32 ragged", 2, 6, 2, 100, 100, 0, 0,
         torch.float32)
    attn("B=1 H=4/1 Sq=64 Sk=128 q_offset=64 f32", 1, 4, 1, 64, 128, 64, 0,
         torch.float32)
    attn("B=1 H=14/2 S=256 window=32 bf16", 1, 14, 2, 256, 256, 0, 32,
         torch.bfloat16)
    # the tensor-core kernel: the training step's shape, ragged, a query
    # offset, and a window that skips key tiles on both sides
    attn("B=2 H=14/2 S=1024 causal bf16 (training)", 2, 14, 2, 1024, 1024, 0,
         0, torch.bfloat16)
    attn("B=2 H=6/2 S=100 causal bf16 ragged", 2, 6, 2, 100, 100, 0, 0,
         torch.bfloat16)
    attn("B=1 H=4/1 Sq=64 Sk=128 q_offset=64 bf16", 1, 4, 1, 64, 128, 64, 0,
         torch.bfloat16)
    attn("B=1 H=14/2 S=512 window=32 bf16", 1, 14, 2, 512, 512, 0, 32,
         torch.bfloat16)
    # non-causal, the encoder-decoder's cross-attention (whisper's 16 heads
    # of 64; 1,536 frames, the aligned count nearest its 1,500): every
    # query reads every key tile, in both kernels, and a ragged Sq
    for dt in (torch.bfloat16, torch.float32):
        for sq in (128, 100):
            attn_case(checks, gen, dev, f"B=2 H=16/16 Sq={sq} Sk=1536 "
                      f"non-causal {str(dt)[6:]} (cross-attention)", 2, 16,
                      16, sq, 1536, 0, 0, dt, 64, causal=False)
    # head dim 128 (gpt-neox-10b): its prefill's 40 heads at S = 128 in
    # both dtypes, a ragged Sq with GQA and a query offset, a window, f32
    # ragged; then the NeoX training step's forward (2 rows of 1,024 a
    # rank) at D = 96 (gpt-neox-20b's 64 heads) and 128 (gpt-neox-10b's 40)
    hd, h = NEOX10B_HD, NEOX10B_H
    for what, b, hq, hkv, sq, sk, off, win, dt in (
            (f"B=1 H={h}/{h} S=128 causal bf16 D={hd} (NeoX-10B prefill)", 1,
             h, h, 128, 128, 0, 0, torch.bfloat16),
            (f"B=1 H={h}/{h} S=128 causal f32 D={hd} (NeoX-10B prefill)", 1,
             h, h, 128, 128, 0, 0, torch.float32),
            (f"B=2 H=8/2 Sq=100 Sk=256 q_offset=156 bf16 D={hd}", 2, 8, 2,
             100, 256, 156, 0, torch.bfloat16),
            (f"B=1 H=16/16 S=512 window=32 bf16 D={hd}", 1, 16, 16, 512, 512,
             0, 32, torch.bfloat16),
            (f"B=2 H=6/2 S=100 causal f32 ragged D={hd}", 2, 6, 2, 100, 100,
             0, 0, torch.float32)):
        attn_case(checks, gen, dev, what, b, hq, hkv, sq, sk, off, win, dt, hd)
    for hd, h in ((NEOX_HD, NEOX_H), (NEOX10B_HD, NEOX10B_H)):
        for dt in (torch.bfloat16, torch.float32):
            attn_case(checks, gen, dev, f"B=2 H={h}/{h} S=1024 causal "
                      f"{str(dt)[6:]} D={hd} (NeoX training)", 2, h, h, 1024,
                      1024, 0, 0, dt, hd)
    # head dim 256 (gemma3-1b): its prefill's GQA 4/1 at S = 640, local
    # (window 512) and global (causal), a ragged Sq with a query offset, a
    # window that skips key tiles on both sides, and f32
    hd, h, hkv, w = GEMMA_HD, GEMMA_H, GEMMA_HKV, GEMMA_W
    for what, b, hq, nkv, sq, sk, off, win, dt in (
            (f"B=1 H={h}/{hkv} S=640 window={w} bf16 D={hd} (gemma local)", 1,
             h, hkv, 640, 640, 0, w, torch.bfloat16),
            (f"B=1 H={h}/{hkv} S=640 causal bf16 D={hd} (gemma global)", 1, h,
             hkv, 640, 640, 0, 0, torch.bfloat16),
            (f"B=2 H={h}/{hkv} S=1024 window={w} bf16 D={hd} (gemma training "
             f"local)", 2, h, hkv, 1024, 1024, 0, w, torch.bfloat16),
            (f"B=2 H={h}/{hkv} S=1024 causal bf16 D={hd} (gemma training "
             f"global)", 2, h, hkv, 1024, 1024, 0, 0, torch.bfloat16),
            (f"B=2 H=8/2 Sq=100 Sk=256 q_offset=156 bf16 D={hd}", 2, 8, 2,
             100, 256, 156, 0, torch.bfloat16),
            (f"B=1 H=4/1 S=512 window=32 bf16 D={hd}", 1, 4, 1, 512, 512, 0,
             32, torch.bfloat16),
            (f"B=1 H={h}/{hkv} S=640 window={w} f32 D={hd} (gemma local)", 1,
             h, hkv, 640, 640, 0, w, torch.float32),
            (f"B=2 H=6/2 S=100 causal f32 ragged D={hd}", 2, 6, 2, 100, 100,
             0, 0, torch.float32)):
        attn_case(checks, gen, dev, what, b, hq, nkv, sq, sk, off, win, dt, hd)
    # any other head dim raises, in both dtypes
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    for dt in (torch.bfloat16, torch.float32):
        odd = torch.zeros((2, 16, 80), dtype=dt, device=dev)
        try:
            flash_attention_cuda(odd, odd, odd)
        except ValueError:
            continue
        raise Failed(f"flash_attention ran at head dim 80 ({dt})")

    def int4_case(what, n_blocks, block, dtype, d=2, offset=0):
        """quantize_int4 and dequantize_int4_sum bit for bit against their
        plain versions; quantize_int4 must take the variant
        ``expected_int4_path`` names. ``offset`` puts x at that element
        offset into a larger buffer."""
        x = torch.randn((n_blocks, block), generator=gen, device=dev)
        x *= torch.rand((n_blocks, 1), generator=gen, device=dev) * 50
        x[n_blocks // 2] = 0.0
        x = x.to(dtype).reshape(-1)
        if offset:
            buf = torch.zeros(x.numel() + 16, dtype=dtype, device=dev)
            buf[offset:offset + x.numel()] = x
            x = buf[offset:offset + x.numel()]
        aligned = x.data_ptr() % 16 == 0
        took = INT4_PATHS[quantize_int4_path(block, dtype, aligned)]
        want = expected_int4_path(block, aligned)
        if took != want:
            raise Failed(f"quantize_int4 {what}: took the {took} variant, not "
                         f"{want}")
        what = f"{what} {took}"
        qk, sk = ops.quantize_int4(x, block)
        qp, sp = ops.quantize_int4(x, block, impl="plain")
        if not (torch.equal(qk, qp) and torch.equal(sk.view(torch.int32),
                                                    sp.view(torch.int32))):
            raise Failed(f"quantize_int4 {what}: not bitwise equal")
        record("quantize_int4", what, 0.0, "bitwise")
        rk = ops.dequantize_int4_sum(qk, sk, d, block)
        rp = ops.dequantize_int4_sum(qk, sk, d, block, impl="plain")
        if not torch.equal(rk.view(torch.int32), rp.view(torch.int32)):
            raise Failed(f"dequantize_int4_sum {what} d={d}: not bitwise")
        record("dequantize_int4_sum", f"{what} d={d}", 0.0, "bitwise")

    # the tied embedding's stage-1 grad (bf16, 151,936 x 896), ragged
    int4_case("(151936*896/128, 128) bf16 (embed grad)", EMBED_N // 128, 128,
              torch.bfloat16)
    int4_case("(36, 8) f32 ragged", 36, 8, torch.float32, d=4)
    int4_case("(34, 4) bf16 ragged", 34, 4, torch.bfloat16)
    int4_case("(38, 64) f32 ragged", 38, 64, torch.float32)
    # every lane-group width and units a lane of the wide variant, nb ragged
    # against a warp's and a CTA's run of blocks; x off the 16-byte grid,
    # and a block of 12 units, a lane group that is not a power of two
    # (both warp)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        for block in (8, 16, 64, 128, 256, 2048):
            int4_case(f"(1038, {block}) {name} ragged", 1038, block, dtype)
        int4_case(f"(1038, 128) {name} x at offset 1", 1038, 128, dtype,
                  offset=1)
        int4_case(f"(38, 96) {name} ragged", 38, 96, dtype)

    def mq_case(what, m, k, n, block, bits, dtype, path, pad=0):
        """One matmul_quant against its plain version on the same operands
        (drawn in f32, then rounded to ``dtype``); ``path`` is the path the
        shape must take."""
        x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        g = (torch.randn((m, n), generator=gen, device=dev) * 1e-2).to(dtype)
        took = PATHS[matmul_quant_path(m, k, n, block, dtype)]
        if took != path:
            raise Failed(f"matmul_quant {what}: took the {took} path, not {path}")
        pad_to = k * n + pad if pad else None
        qk, sk = ops.matmul_quant(x, g, block, bits=bits, pad_to=pad_to)
        qp, sp = ops.matmul_quant(x, g, block, bits=bits, pad_to=pad_to,
                                  impl="plain")
        if qk.shape != qp.shape or sk.shape != sp.shape:
            raise Failed(f"matmul_quant {what}: shapes")
        srel = float(((sk - sp).abs() / sp.abs()).max())

        def levels(q):
            if bits == 8:
                return q.int()
            return torch.stack([(q & 0xF).int() - 8, (q >> 4).int() - 8],
                               dim=-1).reshape(-1)

        lk, lp = levels(qk), levels(qp)
        diff = (lk - lp).abs()
        frac = float((diff != 0).float().mean())
        step = sk.repeat_interleave(block)
        c = (x.float().T @ g.float()).reshape(-1)
        deq_err = float(((lk[:c.numel()] * step[:c.numel()] - c).abs()
                         / step[:c.numel()]).max())
        if srel > 1e-5 or int(diff.max()) > 1 or frac > 1e-3 or deq_err > 1.0:
            raise Failed(f"matmul_quant {what} ({took}): scale rel {srel}, q "
                         f"diff {int(diff.max())} in {frac}, dequant {deq_err} "
                         "steps")
        record("matmul_quant", f"{what} {took}", float(((
            lk * step - lp * sp.repeat_interleave(block)).abs()).max()),
            f"scales 1e-5 rel, q +-1 in <= 1e-3 (here {frac:.1e}), C within 1 "
            f"step (here {deq_err:.2f})")

    # the training step's seven shapes: bf16 on the tensor cores, f32 SIMT
    bf, f32 = torch.bfloat16, torch.float32
    for dtype, path in ((bf, "tensor_core"), (f32, "simt")):
        for k, n in sorted(set(LAYER_KN)):
            for bits in (4, 8):
                mq_case(f"M={TRAIN_M} ({k}, {n}) bits={bits} {str(dtype)[6:]}",
                        TRAIN_M, k, n, 128, bits, dtype, path)
        mq_case(f"M={TRAIN_M} (896, 128) bits=4 pad_to +512 {str(dtype)[6:]}",
                TRAIN_M, 896, 128, 128, 4, dtype, path, pad=512)
    mq_case("M=100 (72, 192) bits=8 pad_to +64 ragged f32", 100, 72, 192, 64, 8,
            f32, "simt", pad=64)
    mq_case("M=33 (10, 512) bits=4 block 256 ragged f32", 33, 10, 512, 256, 4,
            f32, "simt")
    mq_case("M=20 (70, 1024) bits=8 block 512 ragged f32", 20, 70, 1024, 512, 8,
            f32, "simt")
    # bf16 ragged against the 128 x 128 tile and the 64-row stage (tensor
    # cores: M = 130, 2,047; K = 72, 328; N = 192, 200; blocks 8 and 64),
    # and K off TMA's 16-byte row grid or a block past the tile (SIMT)
    mq_case("M=130 (72, 256) bits=8 block 64 ragged bf16", 130, 72, 256, 64, 8,
            bf, "tensor_core")
    mq_case("M=2047 (328, 192) bits=4 block 64 ragged bf16", 2047, 328, 192, 64,
            4, bf, "tensor_core")
    mq_case("M=2047 (72, 200) bits=8 block 8 ragged bf16", 2047, 72, 200, 8, 8,
            bf, "tensor_core")
    mq_case("M=130 (10, 256) bits=4 ragged bf16", 130, 10, 256, 128, 4, bf,
            "simt")
    mq_case("M=2047 (70, 512) bits=8 block 64 ragged bf16", 2047, 70, 512, 64, 8,
            bf, "simt")
    mq_case("M=33 (72, 512) bits=4 block 256 ragged bf16", 33, 72, 512, 256, 4,
            bf, "simt")

    def scan_case(what, b, seq, d, h0_zero, dt_shift):
        dt, x, bm, cm, a, h0 = scan_inputs(gen, dev, b, seq, d, h0_zero,
                                           dt_shift)
        yk, hk = ops.selective_scan(dt, x, bm, cm, a, h0)
        yp, hp = ops.selective_scan(dt, x, bm, cm, a, h0, impl="plain")
        for out, got, want in (("y", yk, yp), ("h_last", hk, hp)):
            err, scale = rel_err(got, want)
            tol = F32_TOL * scale
            if got.shape != want.shape or err > tol:
                raise Failed(f"selective_scan {what} {out}: err {err} > {tol}")
            record("selective_scan", f"{what} {out}", err, f"{tol:.3e}")

    scan_case(f"B=1 S=128 D={SCAN_D} h0=0 (prefill)", 1, 128, SCAN_D, True, 3.0)
    scan_case(f"B=1 S=2048 D={SCAN_D} h0=0", 1, 2048, SCAN_D, True, 3.0)
    scan_case("B=3 S=37 D=96 h0!=0 ragged", 3, 37, 96, False, 0.0)
    # small dt (softplus(normal - 6), about 2.5e-3): exp(dt * a) near 1, so
    # the state forgets slowly and rounding differences last longest
    scan_case(f"B=1 S=2048 D={SCAN_D} h0=0 small dt", 1, 2048, SCAN_D, True,
              6.0)
    # D off the channel tile and S off the staged chunk and the run of steps
    # the N-sum takes at once; D % 4 != 0 stages dt and x 4 bytes at a time
    scan_case("B=2 S=1001 D=8200 h0!=0 ragged tile", 2, 1001, 8200, False, 3.0)
    scan_case("B=1 S=77 D=8190 h0!=0 ragged, D % 4 != 0", 1, 77, 8190, False,
              3.0)

    def scan_grad_case(what, b, seq, d):
        """The scan's gradients through the kernel forward (autograd through
        the plain version at the saved inputs) against autograd through the
        plain forward, on the same random cotangents of y and h_last: dt, x,
        b, c, a and h0 each within F32_TOL * max|ref| (the two backwards run
        the same ops on the same inputs, so they agree to the last bit; the
        kernel's forward is held to the same tolerance)."""
        inputs = scan_inputs(gen, dev, b, seq, d, False, 3.0)
        gy = torch.randn((b, seq, d), generator=gen, device=dev)
        gh = torch.randn((b, d, SCAN_N), generator=gen, device=dev)
        out = {}
        for impl in (None, "plain"):
            leaves = [t.clone().requires_grad_() for t in inputs]
            before = ops.launches()["selective_scan"]
            y, h = ops.selective_scan(*leaves, impl=impl)
            launched = ops.launches()["selective_scan"] - before
            if launched != (impl is None):
                raise Failed(f"selective_scan grads {what}: {launched} launches "
                             f"with impl={impl}")
            out[impl] = (y.detach(), h.detach()) + torch.autograd.grad(
                (y, h), leaves, (gy, gh))
        names = ("y", "h_last", "d dt", "d x", "d b", "d c", "d a", "d h0")
        for name, got, want in zip(names, out[None], out["plain"]):
            err, scale = rel_err(got, want)
            tol = F32_TOL * scale
            if got.shape != want.shape or err > tol:
                raise Failed(f"selective_scan grads {what} {name}: err {err} > "
                             f"{tol}")
            record("selective_scan", f"{what} {name}", err, f"{tol:.3e}")

    scan_grad_case("grads B=2 S=64 D=256", 2, 64, 256)
    # a training rank's shape (falcon-mamba-7b, 2 rows of 1,024): the
    # backward rematerialises four 256-step blocks
    scan_grad_case(f"grads B={SCAN_TRAIN_B} S=1024 D={SCAN_D} (training)",
                   SCAN_TRAIN_B, 1024, SCAN_D)


def blocked_quant(w: torch.Tensor, bk: int):
    """w (K, N) f32 -> (q (K, N) int8, scales (K // bk, N) f32): each column
    quantized down K in runs of bk rows, as the reference's test of
    dequant_matmul_pallas quantizes its weight."""
    k, n = w.shape
    wb = w.reshape(k // bk, bk, n)
    absmax = wb.abs().amax(dim=1)
    scales = torch.where(absmax == 0, 1.0, absmax / 127.0)
    q = torch.clamp(torch.round(wb / scales[:, None, :]), -127, 127)
    return q.to(torch.int8).reshape(k, n), scales


def check_dequant_kernels(dev, gen, checks):
    """dequantize_int8_sum, dequantize_int4 and dequant_matmul_blocked
    against their plain versions: the two dequantizes bit for bit, the
    blocked matmul within BLOCKED_RTOL * |ref| + BLOCKED_ATOL * max|ref|."""
    from repro_torch.kernels import ops

    def sum8_case(what, nb, block, d):
        x = torch.randn((d * nb, block), generator=gen, device=dev)
        x *= torch.rand((d * nb, 1), generator=gen, device=dev) * 50
        x[nb // 2] = 0.0
        q, s = ops.quantize_int8(x.reshape(-1), block)
        del x
        rk = ops.dequantize_int8_sum(q, s, d, block)
        rp = ops.dequantize_int8_sum(q, s, d, block, impl="plain")
        if not torch.equal(rk.view(torch.int32), rp.view(torch.int32)):
            raise Failed(f"dequantize_int8_sum {what}: not bitwise")
        add_check(checks, "dequantize_int8_sum", what, 0.0, "bitwise")

    # the tied embedding's stage-1 receive at bits 8 (W = 2), ragged
    sum8_case(f"d=2 x ({EMBED_N // 2}/128, 128) (embed grad)",
              EMBED_N // 2 // 128, 128, 2)
    sum8_case("d=4 (3, 128) ragged", 3, 128, 4)
    sum8_case("d=3 (5, 6) ragged", 5, 6, 3)

    def int4_dequant_case(what, nb, block):
        x = torch.randn((nb, block), generator=gen, device=dev)
        x *= torch.rand((nb, 1), generator=gen, device=dev) * 50
        x[nb // 2] = 0.0
        q, s = ops.quantize_int4(x.reshape(-1), block)
        del x
        for odt in (torch.float32, torch.bfloat16):
            dk = ops.dequantize_int4(q, s, block, odt)
            dp = ops.dequantize_int4(q, s, block, odt, impl="plain")
            if dk.dtype != odt or not torch.equal(dk, dp):
                raise Failed(f"dequantize_int4 {what} -> {odt}: not bitwise")
            add_check(checks, "dequantize_int4", f"{what} -> {str(odt)[6:]}",
                      0.0, "bitwise")

    int4_dequant_case(f"({EMBED_N}/128, 128)", EMBED_N // 128, 128)
    int4_dequant_case("(3, 16384) ragged", 3, 16384)
    int4_dequant_case("(5, 8) ragged", 5, 8)
    int4_dequant_case("(7, 6) ragged", 7, 6)

    def blocked_case(what, m, k, n, bk):
        blocked_check(checks, gen, dev, what, m, k, n, bk)

    # qwen2's w_up at the training M (tensor cores), ragged M and N against
    # the 128 x 128 tile with bk 64 (tensor cores), and bk 32 or 20 with K
    # of 3 and 2 blocks (SIMT), so a mixed-up scale layout cannot pass (the
    # reference test's own shapes are the blocked_matmul path's)
    blocked_case(f"({TRAIN_M}, 896, 4864) bk=128 (w_up)", TRAIN_M, 896, 4864, 128)
    blocked_case("(130, 192, 200) bk=64 ragged", 130, 192, 200, 64)
    blocked_case("(70, 96, 100) bk=32 ragged", 70, 96, 100, 32)
    blocked_case("(5, 40, 3) bk=20 ragged", 5, 40, 3, 20)


def blocked_path(m, k, n, bk) -> str:
    """The blocked dequant-matmul's path by the rule
    csrc/dequant_matmul_blocked.cu documents: tensor cores for bk % 64 == 0,
    K % 8 == 0 and N % 8 == 0, else SIMT."""
    return "tensor_core" if bk % 64 == 0 and k % bk == 0 and k % 8 == 0 \
        and n % 8 == 0 else "simt"


def blocked_check(checks, gen, dev, what, m, k, n, bk):
    """One dequant_matmul_blocked call on x (m, k) and a (k, n) weight
    quantized down K in runs of bk rows, held against the plain version
    within BLOCKED_RTOL * |ref| + BLOCKED_ATOL * max|ref|; the shape must
    take the path ``blocked_path`` names, and the check line ends in it."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.dequant_matmul import (
        PATHS, dequant_matmul_blocked_path)

    took = PATHS[dequant_matmul_blocked_path(m, k, n, bk)]
    if took != blocked_path(m, k, n, bk):
        raise Failed(f"dequant_matmul_blocked {what}: took the {took} path, "
                     f"not {blocked_path(m, k, n, bk)}")
    x = torch.randn((m, k), generator=gen, device=dev) * 3.0
    w = torch.randn((k, n), generator=gen, device=dev) * 3.0
    q, s = blocked_quant(w, bk)
    yk = ops.dequant_matmul_blocked(x, q, s)
    yp = ops.dequant_matmul_blocked(x, q, s, impl="plain")
    err, scale = rel_err(yk, yp)
    worst = float(((yk - yp).abs() - BLOCKED_RTOL * yp.abs()).max())
    tol = BLOCKED_ATOL * scale
    if yk.shape != yp.shape or worst > tol:
        raise Failed(f"dequant_matmul_blocked {what}: |d| - rtol*|ref| "
                     f"{worst} > {tol}")
    add_check(checks, "dequant_matmul_blocked", f"{what} {took}", err,
              f"rtol {BLOCKED_RTOL} + {tol:.3e}")


def blocked_matmul_path(gen, dev, checks):
    """The ops-level blocked dequant-matmul: the reference's own test of
    dequant_matmul_pallas (tests/test_kernels.py) through the port's ops, at
    its three shapes with bk 128. Returns the launch counts of the run."""
    from repro_torch.kernels import ops

    ops.reset_launches()
    for m, k, n in ((128, 128, 128), (256, 128, 256), (128, 256, 384)):
        blocked_check(checks, gen, dev, f"({m}, {k}, {n}) bk=128 (ref. test)",
                      m, k, n, 128)
    launches = ops.launches()
    if launches["dequant_matmul_blocked"] == 0:
        raise Failed("dequant_matmul_blocked not launched on its path")
    return launches


def quant_error_path(gen, dev, checks):
    """benchmarks/quant_error.py's experiment through the port's ops: 2^16
    heavy-tailed values (normal, 1 % of them x10) block-quantized to INT8
    and INT4 and back at blocks 64 ... 16384. Each round trip is held bit
    for bit against the plain versions; block 64 must beat block 16384 (the
    benchmark's assertion). Returns (RMSE rows, launch counts of the run)."""
    from repro_torch.kernels import ops

    n = 1 << 16
    x = torch.randn((n,), generator=gen, device=dev)
    x = torch.where(torch.rand((n,), generator=gen, device=dev) < 0.01,
                    x * 10.0, x)
    ops.reset_launches()
    rows = []
    for block in QUANT_ERROR_BLOCKS:
        r = {"block": block}
        for bits, quant, dequant in ((8, ops.quantize_int8, ops.dequantize_int8),
                                     (4, ops.quantize_int4, ops.dequantize_int4)):
            qk, sk = quant(x, block)
            dk = dequant(qk, sk, block)
            qp, sp = quant(x, block, impl="plain")
            dp = dequant(qp, sp, block, impl="plain")
            if not (torch.equal(qk, qp) and torch.equal(dk, dp)):
                raise Failed(f"quant_error INT{bits} block {block}: kernels "
                             "and plain versions differ")
            r[f"int{bits}_rmse"] = float(((dk - x) ** 2).mean().sqrt())
        rows.append(r)
        print(f"  quant_error block {block:6d}: INT8 rmse {r['int8_rmse']:.5f} "
              f"INT4 rmse {r['int4_rmse']:.5f} scales {400.0 / block:.2f} %")
    launches = ops.launches()
    add_check(checks, "dequantize_int4", "quant_error 2^16, blocks 64..16384",
              0.0, "bitwise")
    if not rows[0]["int8_rmse"] < rows[-1]["int8_rmse"]:
        raise Failed("quant_error: block 64 does not beat block 16384")
    missing = [k for k in ("quantize_int8", "dequantize_int8", "quantize_int4",
                           "dequantize_int4") if launches[k] == 0]
    if missing:
        raise Failed(f"kernels not launched on the quant_error path: {missing}")
    return rows, launches


def scan_inputs(gen, dev, b, seq, d, h0_zero=True, dt_shift=3.0):
    """Scan inputs with d_state 16: dt = softplus(normal - dt_shift) (a
    shift of 3 puts dt near the [1e-3, 1e-1] of falcon-mamba's dt_bias),
    A = -exp(log(1..N) + noise), x, B, C normal."""
    n = SCAN_N
    dt = torch.nn.functional.softplus(
        torch.randn((b, seq, d), generator=gen, device=dev) - dt_shift)
    x = torch.randn((b, seq, d), generator=gen, device=dev)
    bm = torch.randn((b, seq, n), generator=gen, device=dev)
    cm = torch.randn((b, seq, n), generator=gen, device=dev)
    a = -torch.exp(torch.log(torch.arange(1, n + 1, device=dev).float())
                   + 0.1 * torch.randn((d, n), generator=gen, device=dev))
    h0 = torch.randn((b, d, n), generator=gen, device=dev)
    if h0_zero:
        h0.zero_()
    return dt, x, bm, cm, a, h0


def scan_work(b, seq, d, n=SCAN_N):
    """(bytes, f32 operations) of one scan: dt, x and y, B and C, A, h0 and
    h_last once each; per (t, d, n) dt*a, exp, da*h, dx*b, the add, h*c and
    the N-sum's add (exp counted as one operation), per (t, d) dt*x."""
    n_bytes = 4 * (3 * b * seq * d + 2 * b * seq * n + d * n + 2 * b * d * n)
    return n_bytes, b * seq * d * (7 * n + 1)


# ---------------------------------------------------------------------------
# phase 3: the serving path
# ---------------------------------------------------------------------------

class Collect:
    """Per-step batcher records, kept in memory."""

    def __init__(self):
        self.records = []

    def write(self, record):
        self.records.append(record)


def held_fallbacks(where: str, counts: dict, want: dict | None = None) -> None:
    """The model-level fallbacks a path recorded (``ops.dispatch_counters``
    or a rank's ``fallbacks``) must be exactly ``want``, reason by reason
    and count by count (none where ``want`` is None): every attention call
    at a fusable shape reaches the kernel dispatch, and a shape the
    reference's gate rejects (MLA's value width, whisper's 1,500 frames)
    falls back exactly as often as the path makes such calls."""
    if counts != (want or {}):
        raise Failed(f"{where}: attention fallbacks {counts}, expected "
                     f"{want or {}}")


SERVE_RECORD = ("args", "arch", "reqs", "launches", "counters", "setup_s",
                "run_s", "tokens", "steps", "decode_step_ms",
                "decode_steps_full", "decode_step_graph_ms",
                "decode_step_graph_runs", "memory", "peak_bytes",
                "setup_peak_bytes")


def serve_phase(argv, kernels, arch=None):
    """Serve ``argv``'s traffic from its seeded residency (of ``arch``, an
    ArchConfig, in place of ``--arch`` where given); every kernel of
    ``kernels`` must launch in the run (the counters are zeroed just before
    the residency is built and read just after the last request). Also
    records the peak of the residency's build alone."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    args = serve.build_parser().parse_args(argv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    ops.reset_dispatch_counters()
    t0 = time.perf_counter()
    device, arch, model, layout, residency = serve.setup(args, arch)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated()
    metrics = Collect()
    cb = serve.make_batcher(args, model, layout, device, metrics)
    reqs = serve.make_requests(args, arch)
    t0 = time.perf_counter()
    cb.run(residency, reqs)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = ops.launches()
    peak = torch.cuda.max_memory_allocated()

    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise Failed(f"{arch.name}: kernels not launched on the serving "
                     f"path: {missing}")
    c = cb.counters
    if c["retired"] != len(reqs) or c["rejected"] or \
            c["admitted"] != c["retired"] + c["preempted"]:
        raise Failed(f"batcher counters {c}")
    for r in reqs:
        if len(r.out) != args.gen or not all(0 <= t < arch.vocab for t in r.out):
            raise Failed(f"request {r.rid}: tokens {r.out}")
    n_tok = sum(len(r.out) for r in reqs)
    full = [r["phase_ms"]["serve_decode"] for r in metrics.records
            if r["active_slots"] == args.slots]
    return dict(args=args, device=device, arch=arch, model=model,
                layout=layout, residency=residency, reqs=reqs, batcher=cb,
                launches=launches, counters=c, setup_s=t_setup, run_s=t_run,
                tokens=n_tok, steps=cb.step_count,
                decode_step_ms=statistics.median(full),
                decode_steps_full=len(full),
                memory=layout.memory_report(), peak_bytes=peak,
                setup_peak_bytes=setup_peak)


# the kernels whose launches a traced prefill's trace is counted for
# (counter: a device kernel's name part)
TRACED_KERNELS = {"flash_attention": "flash_attention_",
                  "selective_scan": "selective_scan_kernel"}


def trace_prefill(s, pre_k, batch) -> dict:
    """One kernel prefill traced by torch.profiler (_device_summary: its
    device time and kernels), with train.trainer.pad_trace's idle card at
    each end of the trace (the profiler drops events it reads outside its
    window). The trace's events of each kernel of TRACED_KERNELS are
    recorded beside the launches the counters counted in that prefill
    (``counted``, ``missed``): an MoE prefill's trace of some 5,000
    launches has lost one flash event in some runs on an H100 (31 of 32),
    and a 2-layer one one of its two. A missed event is printed and kept in
    the record; the launches are held by the counters, and the outputs by
    the checks against the plain versions."""
    from repro_torch.kernels import ops
    from repro_torch.train.trainer import _device_summary, _profiler, pad_trace

    before = ops.launches()
    prof = _profiler(s["device"])
    with prof:
        pad_trace(s["device"])
        t0 = time.perf_counter()
        pre_k(s["residency"], batch)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        pad_trace(s["device"])
    traced = _device_summary(prof, 0, wall_s, top=8)
    after = ops.launches()
    traced["counted"], traced["missed"] = {}, {}
    for k, part in TRACED_KERNELS.items():
        seen = sum(row["calls"] for row in traced["kernels"]
                   if part in row["name"])
        counted = after[k] - before[k]
        traced["counted"][k] = counted
        traced["missed"][k] = counted - seen
        if seen > counted:
            raise Failed(f"traced {s['arch'].name} prefill: {seen} {k} "
                         f"events, {counted} launches counted")
        if seen < counted:
            print(f"  traced {s['arch'].name} prefill: the trace holds {seen} "
                  f"of the {counted} {k} launches counted", flush=True)
    return traced


class Routing:
    """An MoE model's expert choices, recorded in one run and replayed in
    another, so that a comparison of two runs compares their arithmetic on
    the same dispatch. Top-k routing is discontinuous: where a token's
    k-th and (k+1)-th gates lie within rounding of each other, two correct
    runs (kernels and plain versions sum in other orders) send it to
    different experts, and with random weights an expert's output is
    thousands of times the attention's, so such a token moves its logits
    wholly. ``record(key)`` keeps each ``moe._top_k`` call's indices;
    ``replay(key)`` hands them back in call order. Everything else is the
    replaying run's own: the chosen gates' values, the slots, the experts'
    input. A model with no MoE layer makes no such call: both are no-ops."""

    def __init__(self):
        self.calls: dict[str, list] = {}

    @contextlib.contextmanager
    def _patched(self, top_k):
        from repro_torch.models import moe

        own = moe._top_k
        moe._top_k = lambda gates, k: top_k(own, gates, k)
        try:
            yield
        finally:
            moe._top_k = own

    def record(self, key: str):
        idxs = self.calls[key] = []

        def top_k(own, gates, k):
            vals, idx = own(gates, k)
            idxs.append(idx.clone())
            return vals, idx
        return self._patched(top_k)

    def replay(self, key: str):
        idxs = iter(self.calls[key])

        def top_k(own, gates, k):
            idx = next(idxs)
            if idx.shape != (gates.shape[0], k):
                raise Failed(f"routing replay: {tuple(idx.shape)} for gates "
                             f"{tuple(gates.shape)}")
            return gates.gather(-1, idx), idx
        return self._patched(top_k)

    def rows_differ(self, a: str, b: str) -> tuple[int, int]:
        """(token rows whose expert choices differ between runs a and b,
        rows)."""
        diff = sum(int((x != y).any(-1).sum())
                   for x, y in zip(self.calls[a], self.calls[b]))
        return diff, sum(x.shape[0] for x in self.calls[a])


@contextlib.contextmanager
def f32_slots(dtype: str):
    """In a run of ``dtype`` float32, an MoE layer's slots stay f32 (the
    model rounds them to bf16 whatever the compute dtype). That rounding is
    a step: two correct f32 runs 1e-7 apart round some slot elements to
    neighbouring bf16 values, which moved phi3.5's f32 logits 1.9 % apart.
    The f32 checks hold both runs without it, each on its own slots (the
    dispatch one-hots widened to f32 to meet them); a bf16 run's slots are
    its bf16 tokens either way."""
    from repro_torch.models import moe

    own = moe._slots, moe._dispatch_combine

    def dispatch_combine(gates, top_k, capacity):
        disp, comb, aux = own[1](gates, top_k, capacity)
        return disp.float(), comb, aux
    if dtype == "float32":
        moe._slots = lambda xc: xc
        moe._dispatch_combine = dispatch_combine
    try:
        yield
    finally:
        moe._slots, moe._dispatch_combine = own


@contextlib.contextmanager
def attention_held(plain_layout, rows: list):
    """Each attention sublayer (``transformer._attn_fwd``: the q, k, v
    products, flash attention, the output product; or an MLA layer's
    ``transformer._mla_fwd``: the low-rank query, the latent, its
    decompression, the chunked attention, the output product) of the
    prefill run inside, through the kernels on its own input and again
    through the plain versions (``plain_layout`` over the same residency)
    on that input: appends (max|d|, max|ref|) a call to ``rows``. An MoE
    model's residual stream is the experts' (thousands of times the
    attention's), so a wrong attention kernel barely moves its logits; this
    holds the attention kernels at the model's own shapes and inputs."""
    from repro_torch.models import transformer
    from repro_torch.serve.resident import ResidentView

    own = {n: getattr(transformer, n) for n in ("_attn_fwd", "_mla_fwd")}

    def held(fn):
        def sublayer(v, p, cfg, m, x, ctx):
            out, cache = fn(v, p, cfg, m, x, ctx)
            ref, _ = fn(ResidentView(plain_layout, v._p, v._layer), p, cfg,
                        m, x, ctx)
            rows.append(rel_err(out, ref))
            return out, cache
        return sublayer
    for n, fn in own.items():
        setattr(transformer, n, held(fn))
    try:
        yield
    finally:
        for n, fn in own.items():
            setattr(transformer, n, fn)


def check_prefill(s, tol: float | None = PREFILL_TOL):
    """The first request's prefill through the kernels vs the plain versions
    (max|d| <= ``tol`` * max|ref|; ``tol`` None: reported, the bf16 prefill
    held by check_prefill_f32's ratio alone), every attention sublayer of
    the held kernel prefill against the plain versions on its own input
    (``attention_held``, within PREFILL_TOL * max|ref|: one sublayer
    differs by a few bf16 roundings, a wrong tile by whole products), and
    one kernel prefill traced by torch.profiler (trace_prefill: its device
    time and largest kernels). An MoE model's kernel prefill is held on the
    plain run's expert choices (``Routing``); the rows its own routing
    sends elsewhere are counted."""
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.transformer import kind_meta
    from repro_torch.serve.resident import ResidentLayout, ResidentServeEngine

    layout = s["layout"]
    plain = ResidentLayout(layout.specs,
                           dataclasses.replace(layout.cfg, impl="plain"),
                           layout.res_axes)
    shape = ShapeConfig("p", s["args"].prompt_len, 1, "decode")
    tokens = torch.as_tensor(s["reqs"][0].prompt[None]).long().to(s["device"])
    pre_k = ResidentServeEngine(s["model"], layout, shape).make_prefill()
    pre_p = ResidentServeEngine(s["model"], plain, shape).make_prefill()
    times = []
    routing = Routing()
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with routing.record("kernel") if i == 0 else contextlib.nullcontext():
            lk, _ = pre_k(s["residency"], {"tokens": tokens})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    traced = trace_prefill(s, pre_k, {"tokens": tokens})
    with routing.record("plain"):
        lp, _ = pre_p(s["residency"], {"tokens": tokens})
    own_err = rel_err(lk, lp)[0]
    attn = []
    with routing.replay("plain"), attention_held(plain, attn):
        lk, _ = pre_k(s["residency"], {"tokens": tokens})
    if lk.shape != (1, s["arch"].vocab) or lk.dtype != torch.float32:
        raise Failed(f"prefill logits {lk.shape} {lk.dtype}")
    err, scale = rel_err(lk, lp)
    if tol is not None and err > tol * scale:
        raise Failed(f"prefill logits: err {err} > {tol} * {scale}")
    n_attn = sum(kind_meta(k, s["arch"]).mixer != "mamba"
                 for k in s["arch"].pattern)
    worst = max((e / r for e, r in attn), default=0.0)
    if len(attn) != n_attn or worst > PREFILL_TOL:
        raise Failed(f"{s['arch'].name} attention sublayers against the "
                     f"plain versions ({n_attn} wanted): {attn}")
    out = dict(prefill_ms=statistics.median(times), logits_err=err,
               logits_scale=scale, logits_tol=tol, traced=traced,
               argmax_equal=bool(lk.argmax() == lp.argmax()),
               attention_sublayers_held=len(attn),
               attention_sublayer_worst=worst)
    if routing.calls["plain"]:
        out["routing_rows_differ"] = routing.rows_differ("kernel", "plain")
        out["own_routing_logits_err"] = own_err
    return out


def check_prefill_f32(s):
    """The first request's prefill with f32 activations, through the kernels
    and through the plain versions, on the same INT8 weights (the residency's
    dense leaves widened to f32): they must agree within PREFILL_F32_TOL *
    max|ref|. Each bf16 prefill (kernels, plain) is also held against the
    f32 plain one: the kernels' may lie at most PREFILL_BF16_RATIO times as
    far off as the plain versions' (the bf16 tensor-core paths against the
    f32 truth, not against another bf16 run). Every run of an MoE model
    takes the f32 plain run's expert choices (``Routing``), and its f32
    runs keep their slots in f32 (``f32_slots``)."""
    from repro_torch.serve.resident import ResidentLayout, ResidentServeEngine
    from repro_torch.models.config import ShapeConfig

    layout = s["layout"]
    res32 = {k: v if isinstance(v, dict) else v.float()
             for k, v in s["residency"].items()}
    shape = ShapeConfig("p", s["args"].prompt_len, 1, "decode")
    tokens = torch.as_tensor(s["reqs"][0].prompt[None]).long().to(s["device"])
    out = {}
    routing = Routing()
    for impl, dt in (("plain", "float32"), (None, "float32"),
                     (None, layout.cfg.compute_dtype),
                     ("plain", layout.cfg.compute_dtype)):
        cfg = dataclasses.replace(layout.cfg, impl=impl, compute_dtype=dt)
        lay = ResidentLayout(layout.specs, cfg, layout.res_axes)
        pre = ResidentServeEngine(s["model"], lay, shape).make_prefill()
        with routing.record("f32") if out == {} else \
                routing.replay("f32"), f32_slots(dt):
            logits, _ = pre(res32 if dt == "float32" else s["residency"],
                            {"tokens": tokens})
        out[impl or "kernel", dt] = logits
    ref32 = out["plain", "float32"]
    err, scale = rel_err(out["kernel", "float32"], ref32)
    if err > PREFILL_F32_TOL * scale:
        raise Failed(f"f32 prefill logits: err {err} > {PREFILL_F32_TOL} * "
                     f"{scale}")
    bf = layout.cfg.compute_dtype
    bf_kernel = rel_err(out["kernel", bf], ref32)[0]
    bf_plain = rel_err(out["plain", bf], ref32)[0]
    if bf_kernel > PREFILL_BF16_RATIO * bf_plain:
        raise Failed(f"{bf} prefill logits against the f32 plain ones: kernels "
                     f"{bf_kernel} > {PREFILL_BF16_RATIO} x plain {bf_plain}")
    return dict(f32_logits_err=err, f32_logits_scale=scale,
                bf16_kernel_vs_f32_plain=bf_kernel,
                bf16_plain_vs_f32_plain=bf_plain)


def print_held(pf):
    """check_prefill's bf16 tolerance and its attention sublayers."""
    print(f"  prefill logits tol {pf['logits_tol']} (None: held by the f32 "
          f"ratio); attention sublayers held {pf['attention_sublayers_held']}"
          f", worst max|d| / max|ref| {pf['attention_sublayer_worst']:.3e} "
          f"(tol {PREFILL_TOL}); traced flash / scan launches missed by the "
          f"trace {pf['traced']['missed']}")


def print_prefill_f32(pf):
    print(f"  f32 prefill logits max_abs_err {pf['f32_logits_err']:.3e} (max|ref| "
          f"{pf['f32_logits_scale']:.3e}, tol {PREFILL_F32_TOL}); bf16 vs f32 "
          f"plain: kernels {pf['bf16_kernel_vs_f32_plain']:.3e}, plain "
          f"{pf['bf16_plain_vs_f32_plain']:.3e} (kernels at most "
          f"{PREFILL_BF16_RATIO}x plain)")


def grow_caches(model, caches, n: int):
    """Prefill caches made ``n`` positions longer for decode: each
    sequence-indexed entry (full-attention K/V, an MLA latent) zero-padded
    along its sequence, the rest (rings, cross caches, mamba states)
    copied."""
    from repro_torch.models.config import ShapeConfig

    seq = {(kind, name) for kind, e in model.cache_shapes(
        ShapeConfig("g", 1, 1, "decode")).items()
        for name, (_, _, seq_indexed) in e.items() if seq_indexed}
    return {kind: c.clone() if kind == "pos" else
            {name: torch.nn.functional.pad(t, (0, 0) * (t.ndim - 3) + (0, n))
             if (kind, name) in seq and n else t.clone()
             for name, t in c.items()}
            for kind, c in caches.items()}


def check_decode_step(s, tol: float | None = PREFILL_TOL):
    """One decode step of all slots after a prefill of the first requests'
    prompts: every layer product of the step at M = slots. Each compute
    dtype's prefill runs once, through the plain versions, and each step
    starts from a copy of its caches (the full-attention caches one position
    longer, the sliding-window rings as they are), so the step alone is
    held: through the kernels against the
    plain versions in bf16 (max|d| <= PREFILL_TOL * max|ref|) and in f32
    (PREFILL_F32_TOL), and the bf16 step through the kernels at most
    PREFILL_BF16_RATIO times as far from the f32 plain step as the bf16
    plain step is (``tol`` None: the bf16 step held by that ratio alone).
    Every run of an MoE model takes the f32 plain run's expert choices
    (``Routing``), and its f32 runs keep their slots in f32
    (``f32_slots``)."""
    from repro_torch.models.config import ShapeConfig
    from repro_torch.serve.resident import ResidentLayout, ResidentServeEngine

    layout, dev = s["layout"], s["device"]
    slots = s["args"].slots
    reqs = s["reqs"][:slots]
    tokens = torch.stack([torch.as_tensor(r.prompt) for r in reqs]).long().to(dev)
    tok = torch.as_tensor([r.out[0] for r in reqs]).long().to(dev)
    res32 = {k: v if isinstance(v, dict) else v.float()
             for k, v in s["residency"].items()}
    shape = ShapeConfig("d", s["args"].prompt_len, slots, "decode")

    def engine(impl, dt):
        cfg = dataclasses.replace(layout.cfg, impl=impl, compute_dtype=dt)
        return ResidentServeEngine(
            s["model"], ResidentLayout(layout.specs, cfg, layout.res_axes),
            shape)

    def copied(caches):
        # a sliding window's ring keeps its W slots; the step writes one
        return grow_caches(s["model"], caches, 1)

    bf = layout.cfg.compute_dtype
    out = {}
    routing = Routing()
    for dt in ("float32", bf):
        res = res32 if dt == "float32" else s["residency"]
        with routing.record("prefill") if dt == "float32" else \
                routing.replay("prefill"), f32_slots(dt):
            _, caches = engine("plain", dt).make_prefill()(res,
                                                           {"tokens": tokens})
        for impl in ("plain", None):
            with routing.record("step") if not out else \
                    routing.replay("step"), f32_slots(dt):
                out[impl or "kernel", dt], _ = engine(impl, dt).make_decode()(
                    res, copied(caches), {"token": tok})
        del caches
    err, scale = rel_err(out["kernel", bf], out["plain", bf])
    if tol is not None and err > tol * scale:
        raise Failed(f"{bf} decode-step logits: err {err} > {tol} * {scale}")
    ref32 = out["plain", "float32"]
    err32, scale32 = rel_err(out["kernel", "float32"], ref32)
    if err32 > PREFILL_F32_TOL * scale32:
        raise Failed(f"f32 decode-step logits: err {err32} > "
                     f"{PREFILL_F32_TOL} * {scale32}")
    bf_kernel = rel_err(out["kernel", bf], ref32)[0]
    bf_plain = rel_err(out["plain", bf], ref32)[0]
    if bf_kernel > PREFILL_BF16_RATIO * bf_plain:
        raise Failed(f"{bf} decode-step logits against the f32 plain ones: "
                     f"kernels {bf_kernel} > {PREFILL_BF16_RATIO} x plain "
                     f"{bf_plain}")
    return dict(decode_logits_err=err, decode_logits_scale=scale,
                decode_logits_tol=tol, decode_argmax_equal=bool(torch.equal(
                    out["kernel", bf].argmax(-1), out["plain", bf].argmax(-1))),
                decode_f32_logits_err=err32, decode_f32_logits_scale=scale32,
                decode_bf16_kernel_vs_f32_plain=bf_kernel,
                decode_bf16_plain_vs_f32_plain=bf_plain)


def print_decode_step(ds):
    print(f"  decode step logits max_abs_err {ds['decode_logits_err']:.3e} "
          f"(max|ref| {ds['decode_logits_scale']:.3e}, tol "
          f"{ds['decode_logits_tol']}, "
          f"argmax equal {ds['decode_argmax_equal']}); f32 "
          f"{ds['decode_f32_logits_err']:.3e} (max|ref| "
          f"{ds['decode_f32_logits_scale']:.3e}, tol {PREFILL_F32_TOL}); bf16 "
          f"vs f32 plain: kernels {ds['decode_bf16_kernel_vs_f32_plain']:.3e}, "
          f"plain {ds['decode_bf16_plain_vs_f32_plain']:.3e} (kernels at most "
          f"{PREFILL_BF16_RATIO}x plain)")


def decode_graph_ms(s):
    """Device time of the batcher's whole paged decode step (assemble, the
    layers, LM head, writeback) with every slot active, replayed as a CUDA
    graph: the step without host launch overhead."""
    cb, dev = s["batcher"], s["device"]
    slots, plen = s["args"].slots, s["args"].prompt_len
    table = cb.paged.device_table(dev)
    tok = torch.zeros((slots,), dtype=torch.long, device=dev)
    pos = torch.arange(plen, plen + slots, dtype=torch.long, device=dev)
    active = torch.ones((slots,), dtype=torch.bool, device=dev)
    return device_ms(lambda: cb._paged_step(s["residency"], table, tok, pos,
                                            active), reps=3)


@contextlib.contextmanager
def layers_on_simt():
    """Inside: dequant_matmul's x @ W calls that the decode path takes go to
    the SIMT kernel, as the layer products of a decode step ran before the
    decode path took them (that kernel is unchanged since)."""
    from repro_torch.kernels import dequant_matmul as dm

    own = dm.dequant_matmul_path

    def path(m, k, n, block, transpose, dtype):
        p = own(m, k, n, block, transpose, dtype)
        return dm.PATHS.index("simt") \
            if not transpose and dm.PATHS[p] == "decode" else p

    dm.dequant_matmul_path = path
    try:
        yield
    finally:
        dm.dequant_matmul_path = own


def decode_graphs(s):
    """The decode step as a CUDA graph (decode_graph_ms) with its layer
    products on their own path and forced onto the SIMT kernel, in turns
    (SIMT, own, own, SIMT): {"own": [ms, ms], "simt": [ms, ms]}."""
    out = {"own": [], "simt": []}
    for which in ("simt", "own", "own", "simt"):
        with layers_on_simt() if which == "simt" else contextlib.nullcontext():
            out[which].append(decode_graph_ms(s))
    return out


def row_timing(s, name: str, reps: int = 50, plain_reps: int = 50):
    """dequantize_int8 of one layer's row of the residency's WIRE leaf
    ``name`` to bf16, as ResidentView reads it (falcon-mamba's ``w_xproj``,
    8192 x 288: not a whole number of blocks a row, dequantized whole and
    multiplied dense in every layer; an MoE layer's expert stack, read
    whole at every use), beside the plain version and the bytes bound; the
    kernel's output bit for bit the plain version's."""
    from repro_torch.kernels import ops

    block = s["layout"].leaf_cfg[name].quant_block
    q, sc = s["residency"][name]["q"][0], s["residency"][name]["s"][0]
    n = q.numel()
    if not torch.equal(ops.dequantize_int8(q, sc, block, torch.bfloat16),
                       ops.dequantize_int8(q, sc, block, torch.bfloat16,
                                           impl="plain")):
        raise Failed(f"dequantize_int8 {name} of one layer: not bitwise")
    return dict(
        work=f"{name} of one layer: {n} int8 -> bf16, block {block} "
             f"({tuple(s['layout'].specs[name].shape)})",
        ms=device_ms(lambda: ops.dequantize_int8(q, sc, block, torch.bfloat16),
                     reps=reps),
        plain_ms=device_ms(lambda: ops.dequantize_int8(
            q, sc, block, torch.bfloat16, impl="plain"), reps=plain_reps),
        library_ms=None,
        bound=bound_ms(*dequant_int8_work(n, block), "f32"))


def ssm_phase(gen, dev):
    """falcon-mamba-7b served at published width and depth, its prefill
    held against the plain versions, its decode step and scan timed. Returns
    the serve record and the scan's timing; the residency is freed."""
    from repro_torch.kernels import ops

    s = serve_phase(SSM_SERVE_ARGS, SSM_SERVE_KERNELS)
    pf = check_prefill(s, tol=SSM_BF16_TOL)
    pf.update(check_prefill_f32(s))
    pf.update(check_decode_step(s, tol=SSM_BF16_TOL))
    graphs = decode_graphs(s)
    s["decode_step_graph_ms"] = statistics.mean(graphs["own"])
    s["decode_step_graph_runs"] = graphs
    scan_rows = [k for k in pf["traced"]["kernels"]
                 if "selective_scan" in k["name"]]
    pf["traced_scan_ms"] = sum(k["ms"] for k in scan_rows)
    pf["traced_scan_calls"] = sum(k["calls"] for k in scan_rows)
    plen = s["args"].prompt_len
    timing = {seq: scan_timing(gen, dev, 1, seq, "one layer's prefill scan")
              for seq in (plen, 2048)}
    xproj = row_timing(s, next(k for k in s["layout"].specs
                                if k.endswith("w_xproj")))
    held_fallbacks(s["arch"].name, ops.dispatch_counters())
    record = {k: s[k] for k in SERVE_RECORD}
    del s
    gc.collect()
    torch.cuda.empty_cache()
    return record, pf, timing, xproj


def scan_timing(gen, dev, b, seq, what) -> dict:
    """The scan's forward at (B, S, D = 8,192, N = 16): device time of the
    kernel and of its plain version beside its bytes bound and its SFU
    floor (B*S*D*N exps over SMS * SFU_PER_SM a clock at
    clocks.max.sm)."""
    from repro_torch.kernels import ops

    args = scan_inputs(gen, dev, b, seq, SCAN_D)
    n_bytes, n_ops = scan_work(b, seq, SCAN_D)
    clock_hz = sm_clock_mhz() * 1e6
    out = dict(
        work=f"{what}: B={b}, S={seq}, D={SCAN_D}, N={SCAN_N}, f32",
        ms=device_ms(lambda: ops.selective_scan(*args), reps=20),
        plain_ms=device_ms(lambda: ops.selective_scan(*args, impl="plain"),
                           reps=1, replays=2),
        library_ms=None, bound=bound_ms(n_bytes, n_ops, "f32"),
        sfu_floor_ms=b * seq * SCAN_D * SCAN_N / (SMS * SFU_PER_SM * clock_hz)
        * 1e3)
    del args
    return out


def flash_timing(gen, dev, b, h, seq, hd, dtype, what, hkv=None, window=0,
                 sk=None, causal=True):
    """flash_attention at (B, H, S, hd) over ``hkv`` KV heads (default: all
    H) and ``sk`` keys (default: S), causal (or not), within ``window``
    where it is > 0: device time of the kernel, its plain version and SDPA
    (K and V repeated to H heads beforehand; the window as a boolean mask),
    and the bound (q, k, v, o moved once; 4 hd operations an unmasked
    (query, key) pair)."""
    from repro_torch.kernels import ops

    hkv, sk = hkv or h, sk or seq
    q = torch.randn((b * h, seq, hd), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((b * hkv, sk, hd), generator=gen, device=dev)
            .to(dtype) for _ in range(2))
    size = torch.empty((), dtype=dtype).element_size()
    keys = [min(i + 1, window or seq) if causal else sk for i in range(seq)]
    pairs = b * h * sum(keys)
    reps = max(2, 50 * 128 // max(seq, sk))
    kx, vx = (t.view(b, hkv, sk, hd).repeat_interleave(h // hkv, dim=1)
              for t in (k, v))
    mask = None
    if window:
        i = torch.arange(seq, device=dev)
        mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
    out = dict(
        work=f"{what}: B={b} x {h} heads over {hkv}, "
             f"{f'S={seq}' if sk == seq else f'Sq={seq} Sk={sk}'}, D={hd}, "
             f"{'causal' if causal else 'non-causal'}"
             f"{f', window {window}' if window else ''}, {str(dtype)[6:]}",
        ms=device_ms(lambda: ops.flash_attention(q, k, v, causal=causal,
                                                 window=window), reps=reps),
        plain_ms=device_ms(lambda: ops.flash_attention(
            q, k, v, causal=causal, window=window, impl="plain"),
            reps=reps if max(seq, sk) <= 128 else 2),
        library_ms=device_ms(lambda: torch.nn.functional
                             .scaled_dot_product_attention(
                                 q.view(b, h, seq, hd), kx, vx,
                                 attn_mask=mask,
                                 is_causal=causal and mask is None),
                             reps=reps),
        bound=bound_ms(size * 2 * b * (h * seq + hkv * sk) * hd,
                       4 * hd * pairs,
                       "bf16" if dtype == torch.bfloat16 else "f32"))
    del q, k, v, kx, vx
    return out


def neox_flash(gen, dev, checks, seq):
    """flash_attention at GPT-NeoX's head width (96) against its plain
    version: the prefill's shape (64 heads, S = seq, causal), a ragged Sq
    of 100 with GQA 8 over 2 and a query offset, a window, and f32; then the
    prefill shape's device time in bf16 (tensor cores) and f32 (CUDA
    cores), each beside its plain version, SDPA and its bound."""
    hd, h = NEOX_HD, NEOX_H
    for what, b, hq, hkv, sq, sk, off, win, dt in (
            (f"B=1 H={h}/{h} S={seq} causal bf16 D={hd} (NeoX prefill)", 1, h,
             h, seq, seq, 0, 0, torch.bfloat16),
            (f"B=2 H=8/2 Sq=100 Sk=256 q_offset=156 bf16 D={hd}", 2, 8, 2,
             100, 256, 156, 0, torch.bfloat16),
            (f"B=1 H=16/16 S=512 window=32 bf16 D={hd}", 1, 16, 16, 512, 512,
             0, 32, torch.bfloat16),
            (f"B=1 H={h}/{h} S={seq} causal f32 D={hd}", 1, h, h, seq, seq, 0,
             0, torch.float32),
            (f"B=2 H=6/2 S=100 causal f32 ragged D={hd}", 2, 6, 2, 100, 100, 0,
             0, torch.float32)):
        attn_case(checks, gen, dev, what, b, hq, hkv, sq, sk, off, win, dt, hd)
    return {key: flash_timing(gen, dev, 1, h, seq, hd, dt,
                              "NeoX prefill attention")
            for key, dt in (("flash_attention_d96", torch.bfloat16),
                            ("flash_attention_f32_d96", torch.float32))}


def shape_row(step, leaf, call, simt: bool) -> dict:
    """One dequant_matmul call of a served model, per call: its path, its
    device ms there, bf16 cuBLAS on the dequantized weight and the bound;
    with ``simt`` also on the SIMT kernel (forced), and for the LM head
    also the plain version."""
    from repro_torch.kernels.dequant_matmul import PATHS

    x, _, _, (k, n), _, tr = call
    dense = dense_weights([call])
    b, o = matmul_work([call])
    row = dict(step=step, leaf=leaf, M=x.shape[0], K=k, N=n, transpose=tr,
               path=call_path(call),
               ms_per_call=device_ms(run_matmuls([call]), reps=5),
               library_ms_per_call=device_ms(run_dense([call], dense), reps=5),
               bound_ms_per_call=bound_ms(b, o, "bf16")[0])
    if simt:
        row["simt_ms_per_call"] = device_ms(
            run_on_path([call], PATHS.index("simt")), reps=5)
    if leaf == "lm_head":
        row["plain_ms_per_call"] = device_ms(run_matmuls([call], "plain"),
                                             reps=1, replays=2)
    if leaf == "lm_head" and n > DEC_TN_MAX_N and row["path"] != "decode":
        raise Failed(f"{step} head ({k}, {n}).T at M={x.shape[0]}: "
                     f"{row['path']} path, not decode")
    return row


def head_shapes(s, gen, label):
    """A served model's untied LM head at the decode step's M = slots and the
    prefill's M = 1 (shape_row, SIMT too)."""
    return [shape_row(f"{label} {step}", "lm_head",
                      matmul_calls(s, 1, m, gen, n_layers=0)[0], True)
            for step, m in (("decode", s["args"].slots), ("prefill", 1))]


def neox_shapes(s, gen):
    """NeoX's products, from layer 0 of the residency and its LM head, per
    call (shape_row): the six layer products and the head at the decode
    step's M = slots (SIMT too) and at the prefill's M = prompt_len, head
    M = 1 (the head SIMT too); then one prefill's calls on the whole
    residency, beside 44 x layer 0's bf16 cuBLAS time plus the head's (the
    41 GB of all the dequantized weights do not fit beside the
    residency)."""
    slots, plen = s["args"].slots, s["args"].prompt_len
    rows = []
    for step, m, m_head in (("neox decode", slots, slots),
                            ("neox prefill", plen, 1)):
        calls = matmul_calls(s, m, m_head, gen, n_layers=1)
        for call, leaf in zip(calls, NEOX_LEAVES + ("lm_head",)):
            rows.append(shape_row(step, leaf, call, step == "neox decode"
                                  or leaf == "lm_head"))
    lib = {r["leaf"]: r["library_ms_per_call"] for r in rows
           if r["step"] == "neox prefill"}
    pre = matmul_calls(s, plen, 1, gen)
    b, o = matmul_work(pre)
    prefill = dict(
        work=f"one NeoX prefill: {len(pre)} calls at M={plen} (head M=1)",
        ms=device_ms(run_matmuls(pre), reps=2), plain_ms=None,
        library_ms=NEOX_L * sum(lib[leaf] for leaf in NEOX_LEAVES)
        + lib["lm_head"],
        library=f"bf16 cuBLAS per call on layer 0's dequantized weights x "
                f"{NEOX_L}, plus the head's",
        bound=bound_ms(b, o, "bf16"))
    return rows, prefill


def attn_serve(argv, n_attn: int, hd: int, arch=None,
               tol: float | None = PREFILL_TOL, kernels=SERVE_KERNELS,
               n_scan: int = 0):
    """A model with attention served at published width and depth under
    ``kernels``, its prefill (against plain, f32, and the bf16 / f32
    ratio) and decode step held against the plain versions, the traced
    prefill's tensor-core flash launches held to one an attention layer
    (``n_attn`` of them) at head dim ``hd`` and its scan launches to
    ``n_scan`` (a hybrid's mamba layers), the decode graphs in turns
    (``arch``: an ArchConfig in place of ``--arch``; ``tol``: the bf16
    logits' bound, check_prefill's). Returns (the serve state, the prefill
    checks)."""
    from repro_torch.kernels import ops

    s = serve_phase(argv, kernels, arch)
    pf = check_prefill(s, tol)
    pf.update(check_prefill_f32(s))
    pf.update(check_decode_step(s, tol))
    held_fallbacks(s["arch"].name, ops.dispatch_counters())
    # the traced prefill: one flash launch a layer (counted), every traced
    # one on the tensor-core kernel at head dim hd; a flash event the trace
    # lost is recorded (trace_prefill)
    traced = pf["traced"]
    flash_rows = [k for k in traced["kernels"]
                  if f"flash_attention_tc_kernel<{hd}>" in k["name"]]
    pf["traced_flash_ms"] = sum(k["ms"] for k in flash_rows)
    pf["traced_flash_calls"] = sum(k["calls"] for k in flash_rows)
    pf["traced_flash_names"] = sorted({k["name"] for k in flash_rows})
    pf["traced_flash_missed"] = traced["missed"]["flash_attention"]
    if traced["counted"]["flash_attention"] != n_attn or \
            pf["traced_flash_calls"] + pf["traced_flash_missed"] != n_attn:
        raise Failed(f"traced {s['arch'].name} prefill: "
                     f"{traced['counted']['flash_attention']} flash launches "
                     f"counted, {pf['traced_flash_calls']} traced on "
                     f"flash_attention_tc_kernel<{hd}>, not {n_attn}")
    scan_rows = [k for k in traced["kernels"]
                 if "selective_scan_kernel" in k["name"]]
    pf["traced_scan_ms"] = sum(k["ms"] for k in scan_rows)
    pf["traced_scan_calls"] = sum(k["calls"] for k in scan_rows)
    if traced["counted"]["selective_scan"] != n_scan or \
            pf["traced_scan_calls"] + traced["missed"]["selective_scan"] \
            != n_scan:
        raise Failed(f"traced {s['arch'].name} prefill: "
                     f"{traced['counted']['selective_scan']} scan launches "
                     f"counted, {pf['traced_scan_calls']} traced, not "
                     f"{n_scan}")
    # the head (x @ W.T at M = 1, N = d_model) on the decode path: its wide
    # kernel (8e) where the rows are wider than DEC_TN_MAX_N, else 8b
    wide = int(s["arch"].d_model > DEC_TN_MAX_N)
    pf["traced_head_calls"] = {}
    for kernel, want in (("dmm_dec_tn_wide_kernel", wide),
                         ("dmm_dec_tn_kernel", 1 - wide)):
        rows = [k for k in pf["traced"]["kernels"] if kernel in k["name"]]
        calls = sum(k["calls"] for k in rows)
        pf["traced_head_calls"][kernel] = calls
        if kernel == "dmm_dec_tn_wide_kernel":
            pf["traced_head_wide_calls"] = calls
            pf["traced_head_wide_ms"] = sum(k["ms"] for k in rows)
        if calls != want:
            raise Failed(f"traced {s['arch'].name} prefill: {calls} "
                         f"launches of {kernel}, not {want}")
    graphs = decode_graphs(s)
    s["decode_step_graph_ms"] = statistics.mean(graphs["own"])
    s["decode_step_graph_runs"] = graphs
    return s, pf


def neox_phase(gen, dev, checks):
    """gpt-neox-20b served at published width and depth, its prefill and
    decode step held against the plain versions, flash_attention at head
    dim 96 held and timed, its products timed by shape. Returns the serve
    record, the prefill checks and the timings; the residency is freed."""
    s, pf = attn_serve(NEOX_SERVE_ARGS, NEOX_L, NEOX_HD)
    timing = neox_flash(gen, dev, checks, s["args"].prompt_len)
    timing["shapes"], timing["dequant_matmul_prefill_neox"] = neox_shapes(s,
                                                                         gen)
    record = {k: s[k] for k in SERVE_RECORD}
    del s
    gc.collect()
    torch.cuda.empty_cache()
    return record, pf, timing


def neox10b_phase(gen, dev):
    """gpt-neox-10b served at published width and NEOX10B_L layers (40
    heads of 128), held as neox_phase holds gpt-neox-20b, with a launch of
    the tensor-core flash kernel at head dim 128 a layer in the traced
    prefill; then
    its prefill attention timed in bf16 and f32 and its head by shape
    (head_shapes). Returns the serve record,
    the prefill checks and the timings; the residency is freed."""
    s, pf = attn_serve(NEOX10B_SERVE_ARGS, NEOX10B_L, NEOX10B_HD,
                       cut_train_arch("gpt-neox-10b", NEOX10B_L))
    seq = s["args"].prompt_len
    timing = {key: flash_timing(gen, dev, 1, NEOX10B_H, seq, NEOX10B_HD, dt,
                                "NeoX-10B prefill attention")
              for key, dt in (("flash_attention_d128", torch.bfloat16),
                              ("flash_attention_f32_d128", torch.float32))}
    timing["shapes"] = head_shapes(s, gen, "neox10b")
    record = {k: s[k] for k in SERVE_RECORD}
    del s
    gc.collect()
    torch.cuda.empty_cache()
    return record, pf, timing


def layer_shapes(s, gen, label: str, leaves, simt_head: bool = False):
    """A served model's products, from layer 0 of its first stack and its
    head (the tied embedding or lm_head), per call (shape_row): the layer
    products ``leaves`` and the head at the decode step's M = slots and at
    the prefill's M = prompt_len (head M = 1), each held to the path
    expected_path names (a call on another path fails the run), with its
    time, bf16 cuBLAS on the dequantized weight and the bound, and its
    output against the plain version's (within BF16_TOL * max|ref|, as
    check_kernels holds the kernel); with ``simt_head`` the head also on
    the SIMT kernel (forced)."""
    from repro_torch.kernels import ops

    slots, plen = s["args"].slots, s["args"].prompt_len
    head = "embed" if s["arch"].tie_embeddings else "lm_head"
    rows = []
    for step, m, m_head in ((f"{label} decode", slots, slots),
                            (f"{label} prefill", plen, 1)):
        calls = matmul_calls(s, m, m_head, gen, n_layers=1)
        for call, leaf in zip(calls, tuple(leaves) + (head,)):
            x, _, _, (k, n), block, tr = call
            path = call_path(call)
            want = expected_path(x.shape[0], k, n, block, tr, x.dtype)
            if path != want:
                raise Failed(f"{step} {leaf} M={x.shape[0]} ({k}, {n}): path "
                             f"{path}, expected {want}")
            _, q, sc, _, _, _ = call
            yk, yp = (ops.dequant_matmul(x, q, sc, (k, n), block,
                                         transpose=tr, dtype=torch.bfloat16,
                                         impl=impl) for impl in (None, "plain"))
            err, scale = rel_err(yk, yp)
            if yk.shape != yp.shape or err > BF16_TOL * scale:
                raise Failed(f"{step} {leaf} M={x.shape[0]} ({k}, {n}) on "
                             f"{path}: err {err} > {BF16_TOL} * {scale}")
            del yk, yp
            rows.append(dict(shape_row(step, leaf, call,
                                       simt_head and leaf == head),
                             max_abs_err=err, max_abs_ref=scale))
    return rows


def gemma_phase(gen, dev):
    """gemma3-1b served at published width and depth (26 layers, 22 of them
    sliding-window with ring caches), held as neox_phase holds
    gpt-neox-20b, with 26 launches of the tensor-core flash kernel at head
    dim 256 in the traced prefill; its products' paths held and timed, its
    prefill attention timed (global and local, bf16 and f32). Returns the
    serve record, the prefill checks and the timings; the residency is
    freed."""
    s, pf = attn_serve(GEMMA_SERVE_ARGS, GEMMA_L, GEMMA_HD)
    seq = s["args"].prompt_len
    timing = {"shapes": layer_shapes(s, gen, "gemma", GEMMA_LEAVES)}
    for key, dt, win in (("flash_attention_d256", torch.bfloat16, 0),
                         ("flash_attention_d256_window", torch.bfloat16,
                          GEMMA_W),
                         ("flash_attention_f32_d256", torch.float32, 0)):
        timing[key] = flash_timing(gen, dev, 1, GEMMA_H, seq, GEMMA_HD, dt,
                                   "gemma prefill attention", hkv=GEMMA_HKV,
                                   window=win)
    record = {k: s[k] for k in SERVE_RECORD}
    del s
    gc.collect()
    torch.cuda.empty_cache()
    return record, pf, timing


def deepseek_phase(gen, dev):
    """deepseek-7b served at published width and depth (30 layers, 32 heads
    of 128), held as neox_phase holds gpt-neox-20b, with 30 launches of the
    tensor-core flash kernel at head dim 128 and its untied head on the
    decode path (8b: rows of 4,096) in the traced prefill; its seven layer
    products and its head at M = 4 and 128 (head M = 1) on the paths
    expected_path names, the head also on SIMT and plain; its prefill and
    training attention timed. Returns the serve record, the prefill checks
    and the timings; the residency is freed."""
    s, pf = attn_serve(DEEPSEEK_SERVE_ARGS, DEEPSEEK_L, DEEPSEEK_HD)
    seq = s["args"].prompt_len
    timing = {"shapes": layer_shapes(s, gen, "deepseek", DEEPSEEK_LEAVES,
                                     simt_head=True)}
    timing["flash_attention_d128_deepseek"] = flash_timing(
        gen, dev, 1, DEEPSEEK_H, seq, DEEPSEEK_HD, torch.bfloat16,
        "deepseek prefill attention")
    timing["flash_attention_train_d128_deepseek"] = flash_timing(
        gen, dev, TRAIN_M // 1024, DEEPSEEK_H, 1024, DEEPSEEK_HD,
        torch.bfloat16, "deepseek training attention")
    record = {k: s[k] for k in SERVE_RECORD}
    del s
    gc.collect()
    torch.cuda.empty_cache()
    return record, pf, timing


def step_launches(s):
    """The kernel launches of one decode step of all slots after a
    prefill of the first requests' prompts (the residency's engine)."""
    from repro_torch.kernels import ops
    from repro_torch.models.config import ShapeConfig
    from repro_torch.serve.resident import ResidentServeEngine

    slots, plen = s["args"].slots, s["args"].prompt_len
    reqs = s["reqs"][:slots]
    tokens = torch.stack([torch.as_tensor(r.prompt) for r in reqs]).long()
    eng = ResidentServeEngine(s["model"], s["layout"],
                              ShapeConfig("d", plen + 1, slots, "decode"))
    _, caches = eng.make_prefill()(s["residency"],
                                   {"tokens": tokens.to(s["device"])})
    caches = grow_caches(s["model"], caches, 1)
    tok = torch.as_tensor([r.out[0] for r in reqs]).long().to(s["device"])
    _, launched, fell = counted(lambda: eng.make_decode()(
        s["residency"], caches, {"token": tok}))
    held_fallbacks(f"{s['arch'].name} decode step", fell)
    return launched


def held_launches(s, prefill_want: dict, step_want: dict,
                  prefill_fallbacks: dict | None = None) -> None:
    """One B = 1 prefill's and one 4-slot decode step's kernel launches
    (``s["prefill_launches"]``, ``s["step_launches"]``) held to their
    predictions, the prefill's attention fallbacks to
    ``prefill_fallbacks`` (none by default)."""
    from repro_torch.models.config import ShapeConfig
    from repro_torch.serve.resident import ResidentServeEngine

    pre = ResidentServeEngine(s["model"], s["layout"], ShapeConfig(
        "p", s["args"].prompt_len, 1, "decode")).make_prefill()
    tokens = torch.as_tensor(s["reqs"][0].prompt[None]).long().to(
        s["device"])
    _, s["prefill_launches"], fell = counted(
        lambda: pre(s["residency"], {"tokens": tokens}))
    held_fallbacks(f"{s['arch'].name} prefill", fell, prefill_fallbacks)
    s["step_launches"] = step_launches(s)
    for what, got, want in (("prefill", s["prefill_launches"], prefill_want),
                            ("decode step", s["step_launches"], step_want)):
        if got != want:
            raise Failed(f"{s['arch'].name} {what}: launches {got}, "
                         f"predicted {want}")


def build_peak_predicted(layout) -> int:
    """The residency build's predicted peak: the residency, then one
    stacked leaf's largest row as its f32 draw and its compute-dtype copy
    (``iter_primaries`` draws a stack one layer row at a time)."""
    row = max(sp.logical_size for sp in layout.specs.values() if sp.stack)
    return layout.memory_report()["total_bytes"] + 4 * row + 2 * row


def counted(fn):
    """(``fn()``, the kernel launches it made by kernel, the attention
    fallbacks it recorded), the device synchronized after it."""
    from repro_torch.kernels import ops

    before = ops.launches()
    ops.reset_dispatch_counters()
    out = fn()
    torch.cuda.synchronize()
    after = ops.launches()
    return out, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}, ops.dispatch_counters()


def moe_phase(gen, dev, checks):
    """phi3.5-moe-42b-a6.6b served at published width and depth from its
    INT8 residency: flash attention at its prefill's shape (GQA 32/8, D =
    128, S = 128) against its plain version; attn_serve (the prefill, each
    attention sublayer of it, and a decode step held against the plain
    versions, the traced prefill's 32 launches of the tensor-core flash
    kernel at head dim 128 and its untied head on 8b, the decode graphs);
    the residency build's peak beside its prediction, one decode step's
    launches, one layer's expert row dequantized (kernel 2 at its largest
    shape) against its bound, and the layer products and head by shape,
    each against its plain version. Returns the serve record, the prefill
    checks and the timings; the residency is freed."""
    plen = int(MOE_SERVE_ARGS[MOE_SERVE_ARGS.index("--prompt-len") + 1])
    attn_case(checks, gen, dev, f"B=1 H={MOE_H}/8 S={plen} causal bf16 "
              f"D={MOE_HD} (phi3.5 prefill)", 1, MOE_H, 8, plen, plen, 0, 0,
              torch.bfloat16, MOE_HD)
    s, pf = attn_serve(MOE_SERVE_ARGS, MOE_L, MOE_HD, tol=MOE_BF16_TOL)
    s["build_peak_predicted"] = build_peak_predicted(s["layout"])
    timing = {"shapes": layer_shapes(s, gen, "phi35", MOE_LEAVES,
                                     simt_head=True),
              "dequantize_int8_expert_row": row_timing(s, "moe.w_gate",
                                                         reps=3,
                                                         plain_reps=1)}
    s["step_launches"] = step_launches(s)
    record = {k: s[k] for k in SERVE_RECORD + ("build_peak_predicted",
                                               "step_launches")}
    del s
    gc.collect()
    torch.cuda.empty_cache()
    return record, pf, timing


def jamba_phase(gen, dev, checks):
    """jamba-v0.1-52b served at published width and depth from its 53.18
    GB INT8 residency through the continuous batcher (the pool holding the
    attention layers' paged K/V and the mamba layers' per-slot states):
    flash at its prefill's shape (GQA 32/8, D = 128, S = 128, no RoPE)
    against its plain version; attn_serve (the prefill on the plain run's
    expert choices, each of its 4 attention sublayers on its own input,
    the f32 prefill, a decode step; the traced prefill's 4 launches of the
    tensor-core flash kernel at D = 128 and its 28 scans, its head on 8b;
    the decode graphs in turns); a B = 1 prefill's and a 4-slot decode
    step's launches held to JAMBA_PREFILL_LAUNCHES / JAMBA_STEP_LAUNCHES;
    the build's peak beside its prediction; one layer's ``w_gate`` expert
    row dequantized (kernel 2 at its largest shape, 939.5 M int8) against
    its bound. Returns the serve record, the prefill checks and the
    timing; the residency is freed."""
    plen = int(JAMBA_SERVE_ARGS[JAMBA_SERVE_ARGS.index("--prompt-len") + 1])
    attn_case(checks, gen, dev, f"B=1 H={MOE_H}/8 S={plen} causal bf16 "
              f"D={MOE_HD} (jamba prefill, no RoPE)", 1, MOE_H, 8, plen, plen,
              0, 0, torch.bfloat16, MOE_HD)
    s, pf = attn_serve(JAMBA_SERVE_ARGS, JAMBA_ATTN_L, MOE_HD,
                       tol=MOE_BF16_TOL, kernels=JAMBA_SERVE_KERNELS,
                       n_scan=JAMBA_MAMBA_L)
    s["build_peak_predicted"] = build_peak_predicted(s["layout"])
    held_launches(s, JAMBA_PREFILL_LAUNCHES, JAMBA_STEP_LAUNCHES)
    timing = row_timing(s, "mamba_moe.w_gate", reps=3, plain_reps=1)
    record = {k: s[k] for k in SERVE_RECORD + (
        "build_peak_predicted", "prefill_launches", "step_launches")}
    del s
    gc.collect()
    torch.cuda.empty_cache()
    return record, pf, timing


def mixtral_phase(gen, dev, checks):
    """mixtral-8x7b at published width and MIXTRAL_L layers, served from
    its residency (MIXTRAL_SERVE_ARGS, prompts past the window): flash
    attention at its prefill's shape (GQA 32/8, D = 128, window 4,096)
    against its plain version, then its prefill (each attention sublayer
    held too) and a decode step over the wrapped rings held against the
    plain versions, no attention fallback. Returns the serve record and
    the checks; the residency is freed."""
    from repro_torch.kernels import ops

    plen = int(MIXTRAL_SERVE_ARGS[MIXTRAL_SERVE_ARGS.index("--prompt-len")
                                  + 1])
    attn_case(checks, gen, dev, f"B=1 H={MOE_H}/8 S={plen} window="
              f"{MIXTRAL_W} bf16 D={MOE_HD} (mixtral prefill)", 1, MOE_H, 8,
              plen, plen, 0, MIXTRAL_W, torch.bfloat16, MOE_HD)
    s = serve_phase(MIXTRAL_SERVE_ARGS, SERVE_KERNELS,
                    arch=cut_train_arch("mixtral-8x7b", MIXTRAL_L))
    pf = check_prefill(s, MOE_BF16_TOL)
    pf.update(check_decode_step(s, MOE_BF16_TOL))
    held_fallbacks(s["arch"].name, ops.dispatch_counters())
    record = {k: s.get(k) for k in SERVE_RECORD}      # no decode graphs
    del s
    gc.collect()
    torch.cuda.empty_cache()
    return record, pf


def engine_phase(gen, argv, n_prompt: int, slots: int, n_new: int,
                 extra, positions: int, fallbacks: dict):
    """``argv``'s model at published width and depth served from its INT8
    residency through ResidentServeEngine (a model the continuous batcher
    cannot take: a patch prefix or an encoder): ``slots`` prompts of
    ``n_prompt`` tokens with the inputs ``extra(arch, device, b)`` gives
    (seeded patch rows or frame embeddings), ``positions`` cache positions
    a prompt; one B = 1 prefill timed, then a batched prefill and ``n_new``
    - 1 greedy decode steps (each timed; the caches ``n_new`` positions
    longer). Every kernel of SERVE_KERNELS must launch in that run (the
    counters zeroed before the residency is built), and each prefill call
    record exactly ``fallbacks``. One B = 1 prefill alone: its launches
    (one flash launch a layer) and fallbacks (``fallbacks``), traced
    (device ms); one decode step alone: its launches, no fallback, and as a
    CUDA graph (per-row positions). Then the B = 1 prefill and one decode
    step through the kernels against the plain versions (within
    PREFILL_TOL * max|ref|). Returns the record; the residency is freed."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.config import ShapeConfig
    from repro_torch.serve.resident import ResidentLayout, ResidentServeEngine

    args = serve.build_parser().parse_args(argv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    ops.reset_dispatch_counters()
    t0 = time.perf_counter()
    device, arch, model, layout, res = serve.setup(args)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(args.seed)
    tokens = torch.as_tensor(rng.integers(0, arch.vocab,
                                          (slots, n_prompt))).to(device)
    batch = dict(extra(arch, device, slots), tokens=tokens)
    one = {k: v[:1] for k, v in batch.items()}
    pre1 = ResidentServeEngine(model, layout, ShapeConfig(
        "p", positions, 1, "decode")).make_prefill()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        l1, _ = pre1(res, one)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    eng = ResidentServeEngine(model, layout, ShapeConfig(
        "g", positions + n_new, slots, "decode"))
    dec = eng.make_decode()
    t_run = time.perf_counter()
    logits, caches = eng.make_prefill()(res, batch)
    caches = grow_caches(model, caches, n_new)
    out = [logits.argmax(-1)]
    steps = []
    for _ in range(n_new - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = dec(res, caches, {"token": out[-1]})
        out.append(logits.argmax(-1))
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    run_s = time.perf_counter() - t_run
    launches = ops.launches()
    peak = torch.cuda.max_memory_allocated()
    missing = [k for k in SERVE_KERNELS if launches[k] == 0]
    if missing:
        raise Failed(f"{arch.name}: kernels not launched: {missing}")
    # four prefill calls: the three timed and the batched one
    held_fallbacks(arch.name, ops.dispatch_counters(),
                   {k: 4 * n for k, n in fallbacks.items()})
    toks = torch.stack(out, dim=1)
    if toks.shape != (slots, n_new) or int(toks.min()) < 0 or \
            int(toks.max()) >= arch.vocab:
        raise Failed(f"{arch.name}: tokens {toks.shape}")
    # one B = 1 prefill and one decode step alone, counted; the prefill
    # traced, the step as a CUDA graph at per-row positions
    _, pre_launches, pre_fell = counted(lambda: pre1(res, one))
    held_fallbacks(f"{arch.name} prefill", pre_fell, fallbacks)
    if pre_launches.get("flash_attention") != arch.n_layers:
        raise Failed(f"{arch.name} prefill: launches {pre_launches}, not "
                     f"{arch.n_layers} of flash_attention")
    traced = trace_prefill(dict(device=device, residency=res, arch=arch),
                           pre1, one)
    row_pos = torch.full((slots,), positions + n_new - 1, dtype=torch.long,
                         device=device)
    step_in = {"token": out[-1], "row_pos": row_pos}
    _, step_launched, step_fell = counted(lambda: dec(res, caches, step_in))
    held_fallbacks(f"{arch.name} decode step", step_fell)
    graph_ms = [device_ms(lambda: dec(res, caches, step_in), reps=3)
                for _ in range(2)]
    # kernels against the plain versions, outside the counted run
    plain = ResidentLayout(layout.specs,
                           dataclasses.replace(layout.cfg, impl="plain"),
                           layout.res_axes)
    lp, _ = ResidentServeEngine(model, plain, ShapeConfig(
        "p", positions, 1, "decode")).make_prefill()(res, one)
    err, scale = rel_err(l1, lp)
    if l1.shape != (1, arch.vocab) or err > PREFILL_TOL * scale:
        raise Failed(f"{arch.name} prefill logits: err {err} > "
                     f"{PREFILL_TOL} * {scale}")
    _, pc = ResidentServeEngine(model, plain, ShapeConfig(
        "p", positions, slots, "decode")).make_prefill()(res, batch)
    pc = grow_caches(model, pc, 1)
    shape_d = ShapeConfig("d", positions + 1, slots, "decode")
    step = {}
    for impl, lay in (("kernel", layout), ("plain", plain)):
        step[impl], _ = ResidentServeEngine(model, lay, shape_d).make_decode()(
            res, grow_caches(model, pc, 0), {"token": out[0]})
    derr, dscale = rel_err(step["kernel"], step["plain"])
    if derr > PREFILL_TOL * dscale:
        raise Failed(f"{arch.name} decode-step logits: err {derr} > "
                     f"{PREFILL_TOL} * {dscale}")
    record = dict(
        arch=arch.name, n_layers=arch.n_layers, enc_layers=arch.enc_layers,
        n_patches=arch.n_patches, n_frames=arch.n_frames, slots=slots,
        prompt_len=n_prompt, positions=positions, gen=n_new,
        prefill_ms=statistics.median(times), prefill_ms_runs=times,
        traced_prefill_wall_ms=traced["wall_ms"],
        traced_prefill_device_ms=traced["device_ms"],
        traced_prefill_top_kernels=traced["top"],
        traced_prefill_missed=traced["missed"],
        prefill_launches=pre_launches, prefill_fallbacks=pre_fell,
        decode_step_launches=step_launched,
        decode_step_ms=statistics.median(steps), decode_steps=len(steps),
        decode_step_graph_ms=statistics.mean(graph_ms),
        decode_step_graph_runs=graph_ms,
        tok_s=slots * n_new / run_s, run_s=run_s, setup_s=setup_s,
        residency_bytes=layout.memory_report()["wire_bytes"],
        scale_bytes=layout.memory_report()["wire_bytes"]
        - sum(sp.logical_size * (sp.stack or 1)
              for n, sp in layout.specs.items() if layout.mode(n) == "wire"),
        max_memory_allocated=peak, launches=launches,
        prefill_logits_max_abs_err=err, prefill_logits_max_abs_ref=scale,
        prefill_argmax_equal=bool(l1.argmax() == lp.argmax()),
        decode_logits_max_abs_err=derr, decode_logits_max_abs_ref=dscale,
        decode_argmax_equal=bool(torch.equal(step["kernel"].argmax(-1),
                                             step["plain"].argmax(-1))))
    del res, caches, pc
    gc.collect()
    torch.cuda.empty_cache()
    return record


def vlm_phase(gen, dev):
    """internvl2-1b at published width and depth, VLM_SLOTS prompts of
    VLM_PROMPT tokens behind VLM_P seeded patch rows each (engine_phase):
    no attention fallback."""
    def patches(arch, device, b):
        return {"patches": (torch.randn((b, arch.n_patches, arch.d_model),
                                        generator=gen, device=device) * 0.02
                            ).to(torch.bfloat16)}
    return engine_phase(gen, VLM_SERVE_ARGS, VLM_PROMPT, VLM_SLOTS, VLM_GEN,
                        patches, VLM_P + VLM_PROMPT, {})


def whisper_phase(gen, dev):
    """whisper-medium at published width and depth (24 + 24 layers,
    WHISPER_F seeded frame embeddings a prompt), WHISPER_SLOTS prompts of
    WHISPER_PROMPT tokens (engine_phase): the decoder's self-attention on
    the flash kernel at D = 64 (24 launches a prefill), the encoder and the
    cross-attention on the chunked plain path over 1,500 frames (24 + 24
    seq_unaligned fallbacks a prefill, as the reference's gate says)."""
    def frames(arch, device, b):
        return {"frames": (torch.randn((b, arch.n_frames, arch.d_model),
                                       generator=gen, device=device) * 0.02
                           ).to(torch.bfloat16)}
    return engine_phase(gen, WHISPER_SERVE_ARGS, WHISPER_PROMPT,
                        WHISPER_SLOTS, WHISPER_GEN, frames, WHISPER_PROMPT,
                        {UNALIGNED: 2 * WHISPER_L})


def mla_phase(gen, dev):
    """minicpm3-4b served at published width and depth (62 MLA layers) from
    its INT8 residency through the continuous batcher (serve_phase, under
    MLA_SERVE_KERNELS: no flash launch, every prefill attention on the
    chunked plain path, MLA_L mla_dv_mismatch fallbacks an admission and
    nothing else); check_prefill (bf16 within PREFILL_TOL, each of the 62
    MLA sublayers held on its own input), check_prefill_f32 and the
    decode-step check against the plain versions; one B = 1 prefill's and
    one 4-slot decode step's launches held to MLA_PREFILL_LAUNCHES and
    MLA_STEP_LAUNCHES; the batcher's decode step as a CUDA graph; kernel 2
    at one layer's w_dkv and w_ukv. Returns the record, the prefill checks
    and the timings; the residency is freed."""
    from repro_torch.kernels import ops

    s = serve_phase(MLA_SERVE_ARGS, MLA_SERVE_KERNELS)
    held_fallbacks(f"{s['arch'].name} serving", ops.dispatch_counters(),
                   {MLA_FALLBACK: MLA_L * s["counters"]["admitted"]})
    pf = check_prefill(s)
    pf.update(check_prefill_f32(s))
    pf.update(check_decode_step(s))
    held_launches(s, MLA_PREFILL_LAUNCHES, MLA_STEP_LAUNCHES,
                  {MLA_FALLBACK: MLA_L})
    graphs = decode_graphs(s)
    s["decode_step_graph_ms"] = statistics.mean(graphs["own"])
    s["decode_step_graph_runs"] = graphs
    timing = {f"dequantize_int8_{leaf}": row_timing(s, f"mla.{leaf}")
              for leaf in ("w_dkv", "w_ukv")}
    record = {k: s[k] for k in SERVE_RECORD + ("prefill_launches",
                                               "step_launches")}
    del s
    gc.collect()
    torch.cuda.empty_cache()
    return record, pf, timing


def print_vlm(v):
    print(f"  {v['arch']}: a B = 1 prefill's launches "
          f"{v['prefill_launches']} (fallbacks {v['prefill_fallbacks']}), a "
          f"decode step's {v['decode_step_launches']}")
    print(f"  launches {v['launches']}; prefill (B=1, {v['positions']} "
          f"positions) logits max_abs_err {v['prefill_logits_max_abs_err']:.3e}"
          f" (max|ref| {v['prefill_logits_max_abs_ref']:.3e}, argmax equal "
          f"{v['prefill_argmax_equal']}); decode step logits max_abs_err "
          f"{v['decode_logits_max_abs_err']:.3e} (max|ref| "
          f"{v['decode_logits_max_abs_ref']:.3e}, argmax equal "
          f"{v['decode_argmax_equal']})")
    print(f"  prefill_ms {v['prefill_ms']:.3f} (traced device ms "
          f"{v['traced_prefill_device_ms']:.3f}) decode_step_ms "
          f"{v['decode_step_ms']:.3f} decode_step_graph_ms "
          f"{v['decode_step_graph_runs']} tok_s {v['tok_s']:.3f} setup_s "
          f"{v['setup_s']:.1f} max_memory_allocated "
          f"{v['max_memory_allocated']} residency_bytes "
          f"{v['residency_bytes']} (scales {v['scale_bytes']})")


def print_routing(pf):
    diff, rows = pf["routing_rows_differ"]
    print(f"  on its own routing the kernel prefill sends {diff} of {rows} "
          f"token rows (layers x tokens) to other experts than the plain one "
          f"(logits max_abs_err {pf['own_routing_logits_err']:.3e}); held on "
          f"the plain run's routing")


def print_moe(mo, mpf, mo_t):
    print_attn(mo, mpf)
    print_routing(mpf)
    print(f"  residency build: peak {mo['setup_peak_bytes']} bytes, predicted "
          f"{mo['build_peak_predicted']} (residency + one expert row's f32 "
          f"draw and its bf16 copy); one decode step's launches "
          f"{mo['step_launches']}")
    for key, tm in mo_t.items():
        if key != "shapes":
            print_timing(key, tm)
    print_shapes(mo_t["shapes"])


def print_jamba(jb, jpf, jb_t):
    print_attn(jb, jpf)
    print_routing(jpf)
    print(f"  traced prefill: {jpf['traced_scan_calls']} scans "
          f"{jpf['traced_scan_ms']:.4f} ms")
    print(f"  residency build: peak {jb['setup_peak_bytes']} bytes, predicted "
          f"{jb['build_peak_predicted']} (residency "
          f"{jb['memory']['total_bytes']} + one expert row's f32 draw and "
          f"its bf16 copy); a prefill's launches {jb['prefill_launches']}, a "
          f"decode step's {jb['step_launches']} (as predicted)")
    print_timing("dequantize_int8_expert_row_jamba", jb_t)


def jamba_line(jb, jpf, jb_t) -> dict:
    return dict(
        serve_attn_line(jb, jpf), n_experts=jb["arch"].moe.n_experts,
        pattern=dict(collections.Counter(jb["arch"].pattern)),
        build_peak_bytes=jb["setup_peak_bytes"],
        build_peak_predicted=jb["build_peak_predicted"],
        total_bytes=jb["memory"]["total_bytes"],
        prefill_launches=jb["prefill_launches"],
        decode_step_launches=jb["step_launches"],
        traced_prefill_scan_calls=jpf["traced_scan_calls"],
        traced_prefill_scan_ms=jpf["traced_scan_ms"],
        traced_prefill_missed=jpf["traced"]["missed"],
        routing_rows_differ=jpf["routing_rows_differ"],
        own_routing_logits_err=jpf["own_routing_logits_err"],
        expert_row=dict(work=jb_t["work"], ms=jb_t["ms"],
                        plain_ms=jb_t["plain_ms"], bound_ms=jb_t["bound"][0],
                        bound_by=jb_t["bound"][1]))


def mixtral_line(mx, mpf) -> dict:
    return dict(
        arch=mx["arch"].name, n_layers=mx["arch"].n_layers,
        window=mx["arch"].sliding_window,
        n_experts=mx["arch"].moe.n_experts, requests=len(mx["reqs"]),
        slots=mx["args"].slots, prompt_len=mx["args"].prompt_len,
        gen=mx["args"].gen, tokens=mx["tokens"], steps=mx["steps"],
        prefill_ms=mpf["prefill_ms"], decode_step_ms=mx["decode_step_ms"],
        tok_s=mx["tokens"] / mx["run_s"], setup_s=mx["setup_s"],
        residency_bytes=mx["memory"]["wire_bytes"],
        max_memory_allocated=mx["peak_bytes"], launches=mx["launches"],
        prefill_logits_max_abs_err=mpf["logits_err"],
        prefill_logits_max_abs_ref=mpf["logits_scale"],
        prefill_argmax_equal=mpf["argmax_equal"],
        routing_rows_differ=mpf["routing_rows_differ"],
        own_routing_logits_err=mpf["own_routing_logits_err"],
        traced_prefill_device_ms=mpf["traced"]["device_ms"],
        traced_prefill_missed=mpf["traced"]["missed"],
        attention_sublayers_held=mpf["attention_sublayers_held"],
        attention_sublayer_worst=mpf["attention_sublayer_worst"],
        **{k: v for k, v in mpf.items() if k.startswith("decode_")})


# ---------------------------------------------------------------------------
# phase 4: the training step
# ---------------------------------------------------------------------------

def plain_argv(argv):
    """``argv`` through the plain versions, for PLAIN_STEPS steps."""
    argv = list(argv) + ["--kernel-impl", "plain"]
    argv[argv.index("--steps") + 1] = str(PLAIN_STEPS)
    return argv


def hold_train_runs(kern, plain, steps: int, label: str,
                    kernels=TRAIN_KERNELS, profiled: bool = True,
                    gnorm_steps: int = PLAIN_STEPS,
                    fallbacks: dict | None = None) -> dict:
    """A training run through the kernels against the same run through the
    plain versions: every kernel of ``kernels`` (the path's own: TRAIN_KERNELS
    or SSM_TRAIN_KERNELS) launched on every rank
    and none in the plain run, the attention fallbacks a rank records
    exactly ``fallbacks`` a step (none where it is None), the traced step's
    fused dW all on the tensor-core matmul_quant kernel (as many as a step
    launches, none on SIMT), the same finite global loss and grad norm on
    every rank, and the kernel run's within TRAIN_LOSS_RTOL /
    TRAIN_GNORM_RTOL of the plain one's at the plain run's PLAIN_STEPS
    steps (``steps`` the kernel run's; the grad norm at the first
    ``gnorm_steps`` of them: MOE_GNORM_STEPS for an MoE model, whose later
    grad norms are reported). Returns the relative differences
    and the traced matmul_quant calls by rank (``profiled=False``: the run
    traced no step with torch.profiler, and none are read)."""
    for r in kern:
        missing = [k for k in kernels if r["launches"][k] == 0]
        if missing:
            raise Failed(f"{label} rank {r['rank']}: kernels not launched on "
                         f"the training path: {missing}")
    for run, n in ((kern, steps), (plain, PLAIN_STEPS)):
        for r in run:
            held_fallbacks(f"{label} rank {r['rank']}", r["fallbacks"],
                           {k: c * n for k, c in (fallbacks or {}).items()})
    # the traced step ran every fused dW on the tensor-core kernel (its bf16
    # operands), none on the SIMT one
    mq_traced = []
    for r in kern if profiled else ():
        per_step = r["launches"]["matmul_quant"] / steps
        calls = {path: sum(row["calls"] for row in r["profile"]["kernels"]
                           if f"matmul_quant_{path}_kernel" in row["name"])
                 for path in ("tc", "simt")}
        mq_traced.append(dict(rank=r["rank"], launches_per_step=per_step,
                              traced_calls=calls,
                              traced_ms=sum(row["ms"] for row in r["profile"]
                                            ["kernels"] if "matmul_quant_"
                                            in row["name"])))
        if calls["tc"] != per_step or calls["simt"]:
            raise Failed(f"{label} rank {r['rank']}: traced matmul_quant "
                         f"calls {calls}, {per_step} launches a step")
    for r in plain:
        if any(r["launches"].values()):
            raise Failed(f"{label} rank {r['rank']}: kernels launched in the "
                         "plain run")
    for run, n in ((kern, steps), (plain, PLAIN_STEPS)):
        for r in run:
            vals = r["losses"] + r["grad_norms"]
            if len(r["losses"]) != n or \
                    not all(math.isfinite(v) for v in vals):
                raise Failed(f"{label} rank {r['rank']}: losses "
                             f"{r['losses']}, grad norms {r['grad_norms']}")
            if (r["losses"], r["grad_norms"]) != (run[0]["losses"],
                                                  run[0]["grad_norms"]):
                raise Failed(f"{label}: ranks disagree on the global loss or "
                             "grad norm")
    k0, p0 = kern[0], plain[0]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(k0["losses"], p0["losses"])]
    gn_rel = [abs(a - b) / abs(b)
              for a, b in zip(k0["grad_norms"], p0["grad_norms"])]
    if max(loss_rel) > TRAIN_LOSS_RTOL or \
            max(gn_rel[:gnorm_steps]) > TRAIN_GNORM_RTOL:
        raise Failed(f"{label} kernel vs plain training: loss rel {loss_rel}, "
                     f"grad norm rel {gn_rel} (held at {gnorm_steps} steps)")
    return dict(loss_rel=loss_rel, grad_norm_rel=gn_rel,
                grad_norm_held_steps=gnorm_steps,
                matmul_quant_traced=mq_traced)


def train_phase():
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    ap = train.build_parser()
    arch = train_arch()
    t0 = time.perf_counter()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    kern = train.run(ap.parse_args(TRAIN_ARGS + [
        "--profile-step", str(PROFILE_STEP), "--ckpt-dir", str(CKPT_DIR),
        "--ckpt-every", str(CKPT_EVERY)]), arch)
    t_kern = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = train.run(ap.parse_args(plain_argv(TRAIN_ARGS)), arch)
    t_plain = time.perf_counter() - t0
    steps = int(TRAIN_ARGS[TRAIN_ARGS.index("--steps") + 1])
    held = hold_train_runs(kern, plain, steps, "qwen2-0.5b")
    launches = {k: sum(r["launches"][k] for r in kern) for k in ops.KERNELS}
    return dict(kernel=kern, plain=plain, steps=steps, launches=launches,
                arch=arch, per_rank_step_launches={
                    k: kern[0]["launches"][k] / steps for k in ops.KERNELS},
                run_s=t_kern, plain_run_s=t_plain, **held)


def train_arch():
    """qwen2-0.5b at published width and TRAIN_L layers."""
    return cut_train_arch("qwen2-0.5b", TRAIN_L)


def cut_train_arch(name: str, n_layers: int):
    """``name`` at published width and its first ``n_layers`` layers (its
    own block pattern, cut; an encoder cut alike)."""
    from repro_torch.models.registry import get_arch

    a = get_arch(name)
    return dataclasses.replace(a, n_layers=n_layers,
                               block_pattern=a.pattern[:n_layers],
                               enc_layers=min(a.enc_layers, n_layers))


def neox_train_arch():
    """gpt-neox-20b at published width and NEOX_TRAIN_L layers."""
    return cut_train_arch("gpt-neox-20b", NEOX_TRAIN_L)


def cut_train_phase(argv, arch, kernels, traced, profile_step: int,
                    fallbacks: dict | None = None):
    """``arch`` (published width, a cut depth) trained with ``argv`` on the
    train phase's mesh and batch, the step ``profile_step`` traced, through
    the kernels and again through the plain versions (hold_train_runs on
    ``kernels``). ``traced`` = (counter, name, instance): on every rank the
    traced step must show the device kernels whose names hold ``name`` as
    often as a step launches ``counter``, each name holding ``instance``.
    Also reports each rank's peak memory summed beside the card's and the
    traced step's kernel calls. ``fallbacks``: the attention fallbacks a
    rank records a step (hold_train_runs)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    ap = train.build_parser()
    gc.collect()
    torch.cuda.empty_cache()
    # what the card has free as the ranks start, and what this process holds
    card_free, _ = torch.cuda.mem_get_info()
    parent_reserved = torch.cuda.memory_reserved()
    t_phase = time.perf_counter()
    kern = train.run(ap.parse_args(argv + ["--profile-step",
                                           str(profile_step)]), arch)
    t_kern = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    plain = train.run(ap.parse_args(plain_argv(argv)), arch)
    t_plain = time.perf_counter() - t0
    steps = int(argv[argv.index("--steps") + 1])
    moe = any(k.startswith("moe") for k in arch.pattern)
    held = hold_train_runs(kern, plain, steps, arch.name, kernels,
                           gnorm_steps=MOE_GNORM_STEPS if moe else PLAIN_STEPS,
                           fallbacks=fallbacks)
    counter, name, instance = traced
    rows_traced = []
    for r in kern:
        per_step = r["launches"][counter] / steps
        rows = [row for row in r["profile"]["kernels"] if name in row["name"]]
        calls = sum(row["calls"] for row in rows)
        rows_traced.append(dict(rank=r["rank"], launches_per_step=per_step,
                                traced_calls=calls,
                                traced_ms=sum(row["ms"] for row in rows),
                                names=sorted({row["name"] for row in rows})))
        if calls != per_step or any(instance not in row["name"]
                                    for row in rows):
            raise Failed(f"{arch.name} rank {r['rank']}: traced {name} calls "
                         f"{calls} ({rows_traced[-1]['names']}), {per_step} "
                         f"{counter} launches a step")
    launches = {k: sum(r["launches"][k] for r in kern) for k in ops.KERNELS}
    return dict(kernel=kern, plain=plain, steps=steps, launches=launches,
                arch=arch, per_rank_step_launches={
                    k: kern[0]["launches"][k] / steps for k in ops.KERNELS},
                run_s=t_kern, plain_run_s=t_plain, traced=rows_traced,
                traced_kernel_calls=[sum(row["calls"] for row in
                                         r["profile"]["kernels"])
                                     for r in kern],
                peak_bytes_sum=sum(r["peak_bytes"] for r in kern),
                plain_peak_bytes_sum=sum(r["peak_bytes"] for r in plain),
                peak_reserved_sum=sum(r["peak_reserved_bytes"] for r in kern),
                plain_peak_reserved_sum=sum(r["peak_reserved_bytes"]
                                            for r in plain),
                card_free_at_start=card_free, parent_reserved=parent_reserved,
                params=arch_params(arch),
                card_bytes=torch.cuda.get_device_properties(0).total_memory,
                phase_s=time.perf_counter() - t_phase, **held)


def arch_params(arch) -> int:
    """The parameters of ``arch`` (logical sizes, unpadded)."""
    from repro_torch.models.transformer import LM

    return sum(s.logical_size * (s.stack or 1)
               for s in LM(arch).leaf_specs().values())


def neox_train_phase():
    """gpt-neox-20b at published width and depth NEOX_TRAIN_L, 3 steps
    (the last traced); the traced step must also show the tensor-core flash
    kernel at head dim 96 as often as a step launches flash_attention."""
    return cut_train_phase(NEOX_TRAIN_ARGS, neox_train_arch(), TRAIN_KERNELS,
                           ("flash_attention", "flash_attention_tc_kernel<",
                            f"<{NEOX_HD}>"), NEOX_PROFILE_STEP)


def ssm_train_phase():
    """falcon-mamba-7b at published width and SSM_TRAIN_L layers, 3 steps
    (the last traced), under SSM_TRAIN_KERNELS; the traced step must show
    the scan kernel as often as a step launches selective_scan."""
    return cut_train_phase(SSM_TRAIN_ARGS,
                           cut_train_arch("falcon-mamba-7b", SSM_TRAIN_L),
                           SSM_TRAIN_KERNELS, ("selective_scan",
                                               "selective_scan_kernel",
                                               "selective_scan_kernel"),
                           NEOX_PROFILE_STEP)


def deepseek_train_phase():
    """deepseek-7b at published width and DEEPSEEK_TRAIN_L layers, 3 steps
    (the last traced); the traced step must show the tensor-core flash
    kernel at head dim 128 as often as a step launches flash_attention."""
    return cut_train_phase(DEEPSEEK_TRAIN_ARGS,
                           cut_train_arch("deepseek-7b", DEEPSEEK_TRAIN_L),
                           TRAIN_KERNELS, ("flash_attention",
                                           "flash_attention_tc_kernel<",
                                           f"<{DEEPSEEK_HD}>"),
                           NEOX_PROFILE_STEP)


def gemma_train_phase():
    """gemma3-1b at published width and GEMMA_TRAIN_L layers (5 local with
    the window of 512, 1 global), 3 steps (the last traced); the traced
    step must show the tensor-core flash kernel at head dim 256 as often as
    a step launches flash_attention."""
    return cut_train_phase(GEMMA_TRAIN_ARGS,
                           cut_train_arch("gemma3-1b", GEMMA_TRAIN_L),
                           TRAIN_KERNELS, ("flash_attention",
                                           "flash_attention_tc_kernel<",
                                           f"<{GEMMA_HD}>"),
                           NEOX_PROFILE_STEP)


def moe_train_phase():
    """phi3.5-moe-42b-a6.6b at published width and MOE_TRAIN_L layers, 3
    steps (the last traced); the expert stacks' gradients take stage 1's
    unfused INT4 quantize; the traced step must show the tensor-core flash
    kernel at head dim 128 as often as a step launches flash_attention."""
    return cut_train_phase(MOE_TRAIN_ARGS,
                           cut_train_arch("phi3.5-moe-42b-a6.6b", MOE_TRAIN_L),
                           TRAIN_KERNELS, ("flash_attention",
                                           "flash_attention_tc_kernel<",
                                           f"<{MOE_HD}>"), NEOX_PROFILE_STEP)


def vlm_train_phase():
    """internvl2-1b at published width and VLM_TRAIN_L layers, 3 steps (the
    last traced), its batches from SyntheticTokens with the patch prefix;
    the traced step must show the tensor-core flash kernel at head dim 64
    as often as a step launches flash_attention."""
    return cut_train_phase(VLM_TRAIN_ARGS,
                           cut_train_arch("internvl2-1b", VLM_TRAIN_L),
                           TRAIN_KERNELS, ("flash_attention",
                                           "flash_attention_tc_kernel<",
                                           f"<{VLM_HD}>"), NEOX_PROFILE_STEP)


def mla_train_phase():
    """minicpm3-4b at published width and MLA_TRAIN_L layers, 3 steps (the
    last traced), under MLA_TRAIN_KERNELS: the attention's forward and
    backward on the chunked plain path (two mla_dv_mismatch fallbacks a
    layer a step on every rank), w_dkv's gradient on the unfused INT4
    quantize; the traced step must show matmul_quant's tensor-core kernel
    as often as a step launches matmul_quant."""
    return cut_train_phase(MLA_TRAIN_ARGS,
                           cut_train_arch("minicpm3-4b", MLA_TRAIN_L),
                           MLA_TRAIN_KERNELS, ("matmul_quant",
                                               "matmul_quant_tc_kernel",
                                               "matmul_quant_tc_kernel"),
                           NEOX_PROFILE_STEP,
                           fallbacks={MLA_FALLBACK: 2 * MLA_TRAIN_L})


def whisper_train_phase():
    """whisper-medium at published width, WHISPER_TRAIN_L encoder and
    decoder layers, 3 steps (the last traced), its batches from
    SyntheticTokens with 1,500 frames a row: the decoder's self-attention on
    flash at D = 64 (the traced step's tensor-core flash calls as often as
    a step launches flash_attention), the encoder and the cross-attention
    on the chunked plain path (two seq_unaligned fallbacks a layer of each
    a step on every rank)."""
    return cut_train_phase(WHISPER_TRAIN_ARGS,
                           cut_train_arch("whisper-medium", WHISPER_TRAIN_L),
                           TRAIN_KERNELS, ("flash_attention",
                                           "flash_attention_tc_kernel<",
                                           "<64>"), NEOX_PROFILE_STEP,
                           fallbacks={UNALIGNED: 4 * WHISPER_TRAIN_L})


def jamba_train_phase():
    """jamba-v0.1-52b at published width and JAMBA_TRAIN_L layers (its
    ``mamba_mlp`` layer 0: the mixer, then the SiLU-GLU MLP of 14,336), 3
    steps (the last traced), under SSM_TRAIN_KERNELS; the traced step must
    show the scan kernel as often as a step launches selective_scan."""
    return cut_train_phase(JAMBA_TRAIN_ARGS,
                           cut_train_arch("jamba-v0.1-52b", JAMBA_TRAIN_L),
                           SSM_TRAIN_KERNELS, ("selective_scan",
                                               "selective_scan_kernel",
                                               "selective_scan_kernel"),
                           NEOX_PROFILE_STEP)


def regime_phase(tr, flags):
    """The training step again with ``flags`` (--overlap, --stream-grads)
    for 3 steps, the same batches from the same seed: every kernel of
    TRAIN_KERNELS must launch on every rank, and the per-step loss and grad
    norm are held against the seed kernel run's first 3 steps (bitwise is
    expected: the kernels are deterministic and the arithmetic the same; the
    run fails beyond TRAIN_LOSS_RTOL / TRAIN_GNORM_RTOL)."""
    from repro_torch.launch import train

    argv = list(TRAIN_ARGS)
    argv[argv.index("--steps") + 1] = str(REGIME_STEPS)
    t0 = time.perf_counter()
    runs = train.run(train.build_parser().parse_args(argv + list(flags)),
                     tr["arch"])
    run_s = time.perf_counter() - t0
    for r in runs:
        missing = [k for k in TRAIN_KERNELS if r["launches"][k] == 0]
        if missing:
            raise Failed(f"rank {r['rank']}: kernels not launched on the "
                         f"{' '.join(flags)} path: {missing}")
        held_fallbacks(f"{' '.join(flags)} rank {r['rank']}", r["fallbacks"])
        if (r["losses"], r["grad_norms"]) != (runs[0]["losses"],
                                              runs[0]["grad_norms"]):
            raise Failed("ranks disagree on the global loss or grad norm")
    seed = tr["kernel"][0]
    r0 = runs[0]
    loss_rel = [abs(a - b) / abs(b)
                for a, b in zip(r0["losses"], seed["losses"][:REGIME_STEPS])]
    gn_rel = [abs(a - b) / abs(b) for a, b in
              zip(r0["grad_norms"], seed["grad_norms"][:REGIME_STEPS])]
    if len(r0["losses"]) != REGIME_STEPS or \
            not all(math.isfinite(v) for v in r0["losses"] + r0["grad_norms"]) \
            or max(loss_rel) > TRAIN_LOSS_RTOL or max(gn_rel) > TRAIN_GNORM_RTOL:
        raise Failed(f"{' '.join(flags)} vs seed: losses {r0['losses']}, "
                     f"loss rel {loss_rel}, grad norm rel {gn_rel}")
    bitwise = (r0["losses"] == seed["losses"][:REGIME_STEPS]
               and r0["grad_norms"] == seed["grad_norms"][:REGIME_STEPS])
    return dict(flags=list(flags), ranks=runs, loss_rel=loss_rel,
                grad_norm_rel=gn_rel, bitwise=bitwise, run_s=run_s,
                launches={k: sum(r["launches"][k] for r in runs)
                          for k in runs[0]["launches"]})


# ---------------------------------------------------------------------------
# phase 4h: checkpoints, resumed on the writing layout and on half the ranks
# ---------------------------------------------------------------------------

def ckpt_file_digest(step_dir: Path, meta: dict, key: str, shape, rank: int,
                     width: int) -> str:
    """The sha256 of the columns of leaf ``key`` that ``rank`` of a
    zero_topo mesh ``shape`` = (data, node, gcd) holds, ``width`` wide,
    read straight from the per-process files with numpy (zero past the
    saved width): the writer's shards placed by its device map and the
    axes its scheme records, the reader's by W = gcd and the optimizer
    state over (gcd, node, data)."""
    axes = meta["scheme"]["axes"]
    cat = key.split("/", 1)[0]
    cat_axes = axes["weight"] if cat == "primaries" else \
        axes["weight"] + axes["extra_grad"] + axes["replica"]
    names, sizes = meta["mesh"]["axes"], meta["mesh"]["shape"]
    base = meta["names"][key]
    shards = {}
    for w, coords in meta["device_map"]["coords"].items():
        c = dict(zip(names, coords))
        i = 0
        for a in cat_axes:
            i = i * sizes[names.index(a)] + c[a]
        shards.setdefault(i, w)
    glob = meta["global_shapes"][key]
    per = glob[-1] // len(shards)
    data, node, gcd = shape
    mine = dict(data=rank // (node * gcd), node=rank // gcd % node,
                gcd=rank % gcd)
    i = mine["gcd"] if cat == "primaries" else \
        (mine["gcd"] * node + mine["node"]) * data + mine["data"]
    lo, hi = i * width, (i + 1) * width
    got = None
    for j in range(len(shards)):
        a, b = max(lo, j * per), min(hi, (j + 1) * per)
        f = np.load(step_dir / f"{base}.p{int(shards[j]):03d}.npy",
                    mmap_mode="r")[0]
        if got is None:
            got = np.zeros(tuple(glob[:-1]) + (width,), f.dtype)
        if a < b:
            got[..., a - lo:b - lo] = f[..., a - j * per:b - j * per]
    return hashlib.sha256(got).hexdigest()


def ckpt_leg(label: str, argv, steps: int, kern):
    """``argv`` resumed from CKPT_DIR for ``steps`` steps (the schedule of
    ``--steps`` kept): every rank resumed from step CKPT_EVERY with each
    restored shard equal (sha256) to the files' slice, every kernel of
    TRAIN_KERNELS launched on every rank, no attention fallback, the same
    finite global metrics on every rank. Returns the runs, the metrics
    against the kernel run's next steps and the leg's seconds."""
    from repro_torch.launch import train

    n = int(argv[argv.index("--devices") + 1])
    shape = (1, 1, n) if n in (1, 2) else (n // 4, 2, 2)
    t0 = time.perf_counter()
    runs = train.run(train.build_parser().parse_args(
        argv + ["--resume", "--ckpt-dir", str(CKPT_DIR)]), train_arch(),
        steps=steps)
    run_s = time.perf_counter() - t0
    step_dir = CKPT_DIR / f"step_{CKPT_EVERY:08d}"
    meta = json.loads((step_dir / "meta.json").read_text())
    jobs = [(r["rank"], k, d["shape"][-1]) for r in runs
            for k, d in r["restored_shards"].items()]
    with ThreadPoolExecutor(8) as pool:
        want = list(pool.map(lambda j: ckpt_file_digest(
            step_dir, meta, j[1], shape, j[0], j[2]), jobs))
    bad = [(rank, k) for (rank, k, _), h in zip(jobs, want)
           if runs[rank]["restored_shards"][k]["sha256"] != h]
    if bad or len(jobs) != len(runs) * len(meta["names"]) - len(runs):
        raise Failed(f"ckpt leg {label}: restored shards differ from the "
                     f"files' slices: {bad[:8]} ({len(jobs)} compared)")
    for r in runs:
        if r["resumed_from"] != CKPT_EVERY:
            raise Failed(f"ckpt leg {label} rank {r['rank']}: resumed from "
                         f"{r['resumed_from']}")
        missing = [k for k in TRAIN_KERNELS if r["launches"][k] == 0]
        if missing:
            raise Failed(f"ckpt leg {label} rank {r['rank']}: kernels not "
                         f"launched: {missing}")
        held_fallbacks(f"ckpt leg {label} rank {r['rank']}", r["fallbacks"])
        vals = r["losses"] + r["grad_norms"]
        if len(r["losses"]) != steps or \
                not all(math.isfinite(v) for v in vals) or \
                (r["losses"], r["grad_norms"]) != (runs[0]["losses"],
                                                  runs[0]["grad_norms"]):
            raise Failed(f"ckpt leg {label}: losses {r['losses']}, grad "
                         f"norms {r['grad_norms']} (rank {r['rank']})")
    k0, r0 = kern[0], runs[0]
    held = slice(CKPT_EVERY, CKPT_EVERY + steps)
    return dict(
        label=label, ranks=runs, mesh=list(shape), run_s=run_s,
        digests_equal=len(jobs),
        losses=r0["losses"], grad_norms=r0["grad_norms"],
        kernel_run_losses=k0["losses"][held],
        kernel_run_grad_norms=k0["grad_norms"][held],
        loss_rel=[abs(a - b) / abs(b)
                  for a, b in zip(r0["losses"], k0["losses"][held])],
        grad_norm_rel=[abs(a - b) / abs(b)
                       for a, b in zip(r0["grad_norms"], k0["grad_norms"][held])],
        bitwise=(r0["losses"], r0["grad_norms"]) == (
            k0["losses"][held], k0["grad_norms"][held]),
        restore_s=[r["ckpt_restore_s"] for r in runs],
        step_s=[r["step_times"] for r in runs],
        peak_bytes=[r["peak_bytes"] for r in runs],
        launches={k: sum(r["launches"][k] for r in runs)
                  for k in runs[0]["launches"]})


def ckpt_phase(tr) -> dict:
    """The train phase's kernel run saved step CKPT_EVERY on its 4 ranks.
    (a) Resumed on the same layout for CKPT_HELD_STEPS steps: their losses
    and grad norms must be the kernel run's next steps' bit for bit (the
    kernels are deterministic and the arithmetic the same; the second
    step's loss is the first one to follow an update from the restored
    optimizer state). (b) Resumed on 2 ranks, (1, 1, 2), as a job that
    lost half its GPUs: the first loss held against the kernel run's at
    TRAIN_LOSS_RTOL (W = gcd on both meshes, the rows summed by det_psum),
    the grad norm reported (stage 2 over E is gone, so the INT4 roundings
    differ). (c) --strict-restore on 2 ranks must fail with MeshMismatch
    before any rank starts. The caller removes CKPT_DIR."""
    from repro_torch.launch import train
    from repro_torch.train.checkpoint import MeshMismatch

    t_phase = time.perf_counter()
    kern = tr["kernel"]
    for r in kern:
        if list(r["ckpt_save_s"]) != [CKPT_EVERY]:
            raise Failed(f"train rank {r['rank']} saved {r['ckpt_save_s']}")
    files = [f for f in CKPT_DIR.rglob("*") if f.is_file()]
    disk = sum(f.stat().st_size for f in files)
    shutil.rmtree(TRACE_DIR / "ckpt_a", ignore_errors=True)
    a = ckpt_leg("a", TRAIN_ARGS + trace_args("ckpt_a"), CKPT_HELD_STEPS,
                 kern)
    if not a["bitwise"]:
        raise Failed(f"ckpt leg a (traced) vs the kernel run: not bit for "
                     f"bit; loss rel {a['loss_rel']}, grad norm rel "
                     f"{a['grad_norm_rel']}")
    a["trace"] = hold_trace(a["ranks"], "ckpt_a")
    half = list(TRAIN_ARGS)
    half[half.index("--devices") + 1] = "2"
    b = ckpt_leg("b", half, 1, kern)
    if b["loss_rel"][0] > TRAIN_LOSS_RTOL:
        raise Failed(f"ckpt leg b vs the kernel run: loss rel "
                     f"{b['loss_rel']}")
    t0 = time.perf_counter()
    try:
        train.run(train.build_parser().parse_args(half + [
            "--resume", "--strict-restore", "--ckpt-dir", str(CKPT_DIR)]),
            train_arch(), steps=1)
    except MeshMismatch as e:
        refused = f"MeshMismatch: {e}"
    else:
        raise Failed("ckpt leg c: a strict restore onto 2 ranks ran")
    if "reshard=True" not in refused:
        raise Failed(f"ckpt leg c: MeshMismatch without the reshard=True "
                     f"hint:\n{refused}")
    c_s = time.perf_counter() - t0
    return dict(bytes_on_disk=disk, files=len(files),
                save_s=[r["ckpt_save_s"][CKPT_EVERY] for r in kern],
                legs=[a, b], strict=dict(
                    mesh=[1, 1, 2], refused="MeshMismatch", run_s=c_s,
                    message=refused[refused.index("MeshMismatch:"):][:400]),
                phase_s=time.perf_counter() - t_phase)


def print_ckpt(ck):
    print(f"  checkpoint: {ck['bytes_on_disk']} bytes on disk in "
          f"{ck['files']} files; save s per rank {ck['save_s']}")
    for leg in ck["legs"]:
        print(f"  leg {leg['label']} on {leg['mesh']}: restore s "
              f"{leg['restore_s']}, restored shards equal to the files' "
              f"slices ({leg['digests_equal']}), losses {leg['losses']} grad "
              f"norms {leg['grad_norms']} vs the kernel run's "
              f"{leg['kernel_run_losses']} {leg['kernel_run_grad_norms']} "
              f"(loss rel {leg['loss_rel']}, grad norm rel "
              f"{leg['grad_norm_rel']}, bitwise {leg['bitwise']}), step_s "
              f"{leg['step_s']}, peak_bytes {leg['peak_bytes']}, "
              f"{leg['run_s']:.1f} s")
        if "trace" in leg:
            t = leg["trace"]
            print(f"  leg {leg['label']} traced: segment sums "
                  f"{[x['segment_sum_s'] for x in t['segment_sums']]} s, "
                  f"Chrome events {t['chrome_events']}, metrics records "
                  f"{t['metrics_records']}, heartbeat ok {t['heartbeat']['ok']} "
                  f"at step {t['heartbeat']['max_step']}")
    print(f"  leg c: strict restore on {ck['strict']['mesh']} refused "
          f"({ck['strict']['message']}) in {ck['strict']['run_s']:.1f} s; "
          f"phase {ck['phase_s']:.1f} s")


def ckpt_line(ck) -> dict:
    legs = [{k: v for k, v in leg.items() if k != "ranks"}
            for leg in ck["legs"]]
    return dict(arch="qwen2-0.5b", scheme="zero_topo", saved_step=CKPT_EVERY,
                bytes_on_disk=ck["bytes_on_disk"], files=ck["files"],
                save_s_per_rank=ck["save_s"], legs=legs, strict=ck["strict"],
                phase_s=ck["phase_s"])


# ---------------------------------------------------------------------------
# phase 4i: the replica tier, the reduce-scatter over R and the INT8 update
# gather, traced
# ---------------------------------------------------------------------------

def trace_args(label: str) -> list[str]:
    """Trace mode's flags, writing under TRACE_DIR / label."""
    d = TRACE_DIR / label
    return ["--metrics-jsonl", str(d / "metrics.jsonl"), "--chrome-trace",
            str(d / "trace.json"), "--heartbeat-dir", str(d / "heartbeat"),
            "--probe-every", "1"]


def hold_trace(runs, label: str) -> dict:
    """A traced run's records: every rank's fenced segments within
    SEGMENT_SUM_RTOL of its step's wall time, rank 0's heartbeat report all
    ok at the last step, each rank's metrics lane with a record a step (the
    schema checked as it is read) and its Chrome trace with every span."""
    from repro_torch.obs import metrics

    steps = len(runs[0]["losses"])
    d = TRACE_DIR / label
    sums = []
    for r in runs:
        tr = r["trace"]
        seg = [sum(sp.values()) for sp in tr["segments"]]
        rel = [abs(a - b) / b for a, b in zip(seg, r["step_times"])]
        sums.append(dict(rank=r["rank"], segment_sum_s=seg,
                         step_s=r["step_times"], rel=rel))
        if max(rel) > SEGMENT_SUM_RTOL:
            raise Failed(f"{label} rank {r['rank']}: segments {seg} s vs "
                         f"step wall {r['step_times']} s")
        events = json.loads(metrics.lane_path(
            d / "trace.json", r["rank"], len(runs)).read_text())["traceEvents"]
        if len(events) != tr["chrome_events"]:
            raise Failed(f"{label} rank {r['rank']}: {len(events)} Chrome "
                         f"events on disk, {tr['chrome_events']} spans")
    records = metrics.read_lanes(d / "metrics.jsonl")
    start = runs[0]["resumed_from"] or 0
    want = [(start + i + 1, r["rank"]) for i in range(steps) for r in runs]
    if [(x["step"], x["rank"]) for x in records] != sorted(want):
        raise Failed(f"{label}: metrics records "
                     f"{[(x['step'], x['rank']) for x in records]}")
    hb = runs[0]["heartbeat"]
    if not hb["ok"] or hb["max_step"] != steps:
        raise Failed(f"{label}: heartbeat {hb}")
    return dict(segment_sums=sums, metrics_records=len(records),
                chrome_events=[r["trace"]["chrome_events"] for r in runs],
                heartbeat=hb)


def replica_phase() -> dict:
    """qwen2-0.5b at full width and REPLICA_L layers under zero_topo on (2, 1, 2), four
    ranks, REPLICA_STEPS steps from seed 0 with REPLICA_OPTS, traced with
    probes every step: every kernel of TRAIN_KERNELS on every rank, the
    update all-gather's quantize_int8 and dequantize_int8 once a leaf a step
    on every rank (counted inside ``update_all_gather``, less the probes'),
    no attention fallback; held against the same run through the plain
    versions; the trace's records held (``hold_trace``). Returns the runs
    and the wire bytes of the reduce-scatter over R and of the INT8 update
    gather beside the flows they replace, from the same shapes."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    ap = train.build_parser()
    t_phase = time.perf_counter()
    shutil.rmtree(TRACE_DIR / "replica", ignore_errors=True)
    arch = cut_train_arch("qwen2-0.5b", REPLICA_L)
    kern = train.run(ap.parse_args(REPLICA_ARGS + trace_args("replica")),
                     arch, engine_opts=REPLICA_OPTS)
    t_kern = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    plain = train.run(ap.parse_args(plain_argv(REPLICA_ARGS)), arch,
                      engine_opts=REPLICA_OPTS)
    t_plain = time.perf_counter() - t0
    held = hold_train_runs(kern, plain, REPLICA_STEPS, "replica",
                           profiled=False)
    traced = hold_trace(kern, "replica")
    leaves = len(kern[0]["trace"]["probe_inventory"]["update_gather"]["leaves"])
    update = []
    for r in kern:
        probe = r["trace"]["probe_counts"]["update_gather"]
        step = {k: r["update_gather_launches"].get(k, 0) - probe.get(k, 0)
                for k in ("quantize_int8", "dequantize_int8")}
        update.append(step)
        if any(v != leaves * REPLICA_STEPS for v in step.values()):
            raise Failed(f"replica rank {r['rank']}: the update gather "
                         f"launched {step}, {leaves} leaves x "
                         f"{REPLICA_STEPS} steps wanted")
    # bytes a rank a step, from the payload each rank handed to gloo: a
    # gather over d members sends its input to d - 1 of them, the
    # reduce-scatter over R sends (R - 1) / R of its input; the all-reduce
    # flow (the reference's psum) and the bf16 gather from the same shapes
    r0 = kern[0]
    pay = {k: v / REPLICA_STEPS for k, v in r0["payload_bytes"].items()}
    probe_pay = {k: v / REPLICA_STEPS for k, v in
                 r0["trace"]["probe_counts"]["payload"].items()}
    r_deg = 2
    ug = pay["update_gather"] - probe_pay.get("update_gather", 0)
    os_elems = r0["memory"]["optimizer"] // 12
    rs = pay["reduce_scatter"]
    wire = dict(
        update_gather_int8=ug * (r_deg - 1),
        update_gather_bf16=2 * os_elems * (r_deg - 1),
        cross_replica_reduce_scatter=rs * (r_deg - 1) / r_deg,
        cross_replica_allreduce=rs * 2 * (r_deg - 1) / r_deg)
    wire["update_gather_ratio"] = wire["update_gather_int8"] / \
        wire["update_gather_bf16"]
    wire["cross_replica_ratio"] = wire["cross_replica_reduce_scatter"] / \
        wire["cross_replica_allreduce"]
    step_launches = {k: sum(r["launches"][k] - r["trace"]["probe_counts"]
                            ["launches"].get(k, 0) for r in kern)
                     for k in ops.KERNELS}
    return dict(kernel=kern, plain=plain, steps=REPLICA_STEPS,
                launches=step_launches,
                probe_launches={k: sum(r["trace"]["probe_counts"]["launches"]
                                       .get(k, 0) for r in kern)
                                for k in ops.KERNELS},
                update_gather_launches=update, leaves=leaves, wire=wire,
                payload_per_step=pay, probe_payload_per_step=probe_pay,
                run_s=t_kern, plain_run_s=t_plain,
                phase_s=time.perf_counter() - t_phase, **held, **traced)


def print_replica(rp):
    for r in rp["kernel"]:
        t = r["trace"]
        for i, (seg, pr) in enumerate(zip(t["segments"], t["probes"])):
            print(f"  rank {r['rank']} step {i}: cross_replica "
                  f"{seg['cross_replica']:.4f} s update {seg['update']:.4f} s "
                  f"probes {json.dumps(pr)}")
        print(f"  rank {r['rank']}: loss {r['losses']} grad_norm "
              f"{r['grad_norms']} step_s {r['step_times']} tok/s "
              f"{r['tokens_per_s']} peak_bytes {r['peak_bytes']} "
              f"overlap_efficiency {t['overlap_efficiency']}")
    for x in rp["segment_sums"]:
        print(f"  rank {x['rank']}: segment sum {x['segment_sum_s']} s vs "
              f"wall {x['step_s']} s (rel {x['rel']})")
    w = rp["wire"]
    print(f"  wire bytes a rank a step: update gather INT8 "
          f"{w['update_gather_int8']:.0f} vs bf16 "
          f"{w['update_gather_bf16']:.0f} ({w['update_gather_ratio']:.4f}); "
          f"cross-replica reduce-scatter "
          f"{w['cross_replica_reduce_scatter']:.0f} vs all-reduce "
          f"{w['cross_replica_allreduce']:.0f} ({w['cross_replica_ratio']:.4f})")
    print(f"  update gather launches a rank (less the probes'): "
          f"{rp['update_gather_launches']} ({rp['leaves']} leaves x "
          f"{rp['steps']} steps); Chrome events {rp['chrome_events']}; "
          f"metrics records {rp['metrics_records']}")
    from repro_torch.obs import heartbeat
    print(f"  {heartbeat.format_report(rp['heartbeat'])}")
    print(f"  kernel vs plain: loss rel {rp['loss_rel']}, grad norm rel "
          f"{rp['grad_norm_rel']}; peak bytes summed "
          f"{sum(r['peak_bytes'] for r in rp['kernel'])}; phase "
          f"{rp['phase_s']:.1f} s")


def replica_line(rp) -> dict:
    k0 = rp["kernel"][0]
    return dict(
        arch="qwen2-0.5b", n_layers=REPLICA_L, scheme="zero_topo",
        mesh=[2, 1, 2], ranks=4,
        engine_opts=REPLICA_OPTS, global_batch=8, seq=1024,
        steps=rp["steps"], losses=k0["losses"], grad_norms=k0["grad_norms"],
        plain_losses=rp["plain"][0]["losses"],
        plain_grad_norms=rp["plain"][0]["grad_norms"],
        loss_rel=rp["loss_rel"], grad_norm_rel=rp["grad_norm_rel"],
        step_s=k0["step_times"], plain_step_s=rp["plain"][0]["step_times"],
        tok_s=k0["tokens_per_s"],
        tflops_per_rank=k0["tflops_per_gpu"],
        peak_bytes_per_rank=[r["peak_bytes"] for r in rp["kernel"]],
        peak_bytes_sum=sum(r["peak_bytes"] for r in rp["kernel"]),
        segments=[r["trace"]["segments"] for r in rp["kernel"]],
        probes=[r["trace"]["probes"] for r in rp["kernel"]],
        overlap_efficiency=[r["trace"]["overlap_efficiency"]
                            for r in rp["kernel"]],
        segment_sums=rp["segment_sums"], wire_bytes_per_step=rp["wire"],
        payload_bytes_per_step_per_rank=rp["payload_per_step"],
        probe_payload_bytes_per_step_per_rank=rp["probe_payload_per_step"],
        update_gather_launches_per_rank=rp["update_gather_launches"],
        leaves=rp["leaves"], probe_launches=rp["probe_launches"],
        chrome_events=rp["chrome_events"],
        metrics_records=rp["metrics_records"], heartbeat=rp["heartbeat"],
        probe_inventory=k0["trace"]["probe_inventory"],
        run_s=rp["run_s"], plain_run_s=rp["plain_run_s"],
        phase_s=rp["phase_s"])


# ---------------------------------------------------------------------------
# phase 4k: the topology planner and the calibration loop
# ---------------------------------------------------------------------------

def planner_cli(argv) -> str:
    """``python -m repro_torch.topo.planner`` with ``argv``, run in this
    process (``planner.main``): its standard output."""
    from repro_torch.topo import planner

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = planner.main(argv)
    if code != 0:
        raise Failed(f"planner {argv} returned {code}")
    return buf.getvalue()


def plan_phase() -> dict:
    """Phase 4k: the planner CLI (host only), qwen2-0.5b at REPLICA_L layers
    trained under --scheme auto on (1, 2, 2) and held against plain, its
    measured phases calibrated into a Topology that the planner re-plans
    from, and the calibration CLI's quick run. Returns the runs, the
    planner's outputs, the wire bytes beside phase_volumes', the measured
    phase seconds beside their prediction and the solved bandwidths."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.launch.mesh import TEST_AXES, Mesh
    from repro_torch.obs import calibrate
    from repro_torch.topo import cost, planner
    from repro_torch.topo.model import Topology, calibrated, load_topology

    ap = train.build_parser()
    t_phase = time.perf_counter()
    shutil.rmtree(PLAN_DIR, ignore_errors=True)
    shutil.rmtree(TRACE_DIR / "plan", ignore_errors=True)
    PLAN_DIR.mkdir(parents=True)
    # (a) host only: the paper's cluster and model, and a serving plan
    t0 = time.perf_counter()
    cli = dict(frontier=planner_cli([]),
               serve=planner_cli(["--serve", "--model", "qwen2-0.5b"]))
    host_s = time.perf_counter() - t0
    # (b) the planner's first choice for the live mesh, in this process,
    # with the overrides the train CLI applies to it
    arch = cut_train_arch("qwen2-0.5b", REPLICA_L)
    psi = arch_params(arch)
    args = ap.parse_args(PLAN_ARGS)
    mesh = Mesh(train.mesh_shape(args), TEST_AXES)
    best = planner.plan_for_mesh(mesh, psi=psi, n_layers=arch.n_layers,
                                 memory_budget=PLAN_BUDGET_GB * 1e9,
                                 top_k=1)[0]
    want = dataclasses.replace(best.cfg, quant_block=args.quant_block,
                               overlap=False, compute_dtype=args.compute_dtype,
                               impl=None)
    if dataclasses.asdict(want.axes) != PLAN_AXES:
        raise Failed(f"plan: the planner chose {best.label}, not {PLAN_AXES}")
    t0 = time.perf_counter()
    kern = train.run(ap.parse_args(PLAN_ARGS + ["--trace"]
                                   + trace_args("plan")), arch)
    t_kern = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = train.run(ap.parse_args(plain_argv(PLAN_ARGS)), arch)
    t_plain = time.perf_counter() - t0
    for run, impl in ((kern, None), (plain, "plain")):
        for r in run:
            if r["cfg"] != dataclasses.replace(want, impl=impl):
                raise Failed(f"plan rank {r['rank']}: trained {r['cfg']}, "
                             f"the planner's choice is {want}")
    held = hold_train_runs(kern, plain, PLAN_STEPS, "plan", profiled=False)
    traced = hold_trace(kern, "plan")
    r0 = kern[0]
    probe_pay = r0["trace"]["probe_counts"]["payload"]
    payload = {k: (v - probe_pay.get(k, 0)) / PLAN_STEPS
               for k, v in r0["payload_bytes"].items()}
    volumes = cost.phase_volumes(want, float(psi))
    # (c) rank 0's measured phases after the first step, priced and solved
    steps = r0["trace"]["phase_s"][1:]
    measured = {k: statistics.median(p[k] for p in steps) for k in steps[0]}
    topo = Topology.from_mesh(mesh)
    wl = cost.Workload(psi=float(psi), n_layers=arch.n_layers,
                       tokens_per_device_mb=args.batch * args.seq // mesh.size,
                       n_microbatch=args.microbatches)
    pred = cost.phase_breakdown(want, topo, wl)
    eff = calibrate.solve_bandwidths(pred, measured)
    cal = calibrated(topo, eff)
    cal_path = PLAN_DIR / "topo_calibrated.json"
    cal.save(cal_path)
    if load_topology(str(cal_path)).to_dict() != cal.to_dict():
        raise Failed(f"plan: {cal_path} does not read back")
    cli["calibrated"] = planner_cli(["--topology", str(cal_path), "--model",
                                     "qwen2-0.5b", "--top", "4"])
    # the calibration CLI at its reduced defaults, its ranks on the card
    quick_path = PLAN_DIR / "calibrate_quick.json"
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = calibrate.main(["--quick", "--mesh", "1,2,2",
                               "--out-topology", str(quick_path)])
    quick_s = time.perf_counter() - t0
    if code != 0:
        raise Failed(f"obs.calibrate --quick returned {code}")
    quick = load_topology(str(quick_path))
    if sorted(quick.axis_sizes) != sorted(mesh.shape.items()):
        raise Failed(f"obs.calibrate wrote {quick.to_dict()}")
    launches = {k: sum(r["launches"][k] - r["trace"]["probe_counts"]
                       ["launches"].get(k, 0) for r in kern)
                for k in ops.KERNELS}
    shutil.rmtree(PLAN_DIR, ignore_errors=True)
    return dict(kernel=kern, plain=plain, steps=PLAN_STEPS, arch=arch,
                params=psi, cfg=want, label=best.label, launches=launches,
                payload_per_step=payload, volumes=volumes, measured=measured,
                predicted={k: v["seconds"] for k, v in pred.items()},
                bandwidths={a: dict(effective=eff.get(a),
                                    preset=topo.link(a).bandwidth)
                            for a in topo.axis_names},
                calibrated=cal.to_dict(), calibrate_quick=buf.getvalue(),
                calibrate_quick_topology=quick.to_dict(), cli=cli,
                host_s=host_s, run_s=t_kern, plain_run_s=t_plain,
                quick_s=quick_s, phase_s=time.perf_counter() - t_phase,
                **held, **traced)


def dryrun_args(name: str) -> list[str]:
    """The dry-run CLI's arguments of phase 4l's traces: ``train`` is the
    train phase's configuration, ``decode`` the serve phase's decode step,
    ``neox_<scheme>`` gpt-neox-20b's train_4k on the production mesh."""
    if name == "train":
        at = TRAIN_ARGS.index
        return ["--arch", "qwen2-0.5b", "--layers", str(TRAIN_L),
                "--shape", "train_4k", "--mesh", "1,2,2",
                "--batch", TRAIN_ARGS[at("--batch") + 1],
                "--seq", TRAIN_ARGS[at("--seq") + 1],
                "--scheme", TRAIN_ARGS[at("--scheme") + 1],
                "--quant-block", TRAIN_ARGS[at("--quant-block") + 1]]
    if name == "decode":
        at = SERVE_ARGS.index
        return ["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                "--mesh", "1,1,1", "--serve-mode", "resident",
                "--batch", SERVE_ARGS[at("--slots") + 1],
                "--seq", str(int(SERVE_ARGS[at("--prompt-len") + 1]) + 1),
                "--quant-block", "128"]
    return ["--arch", "gpt-neox-20b", "--shape", "train_4k", "--mesh",
            "prod", "--scheme", name.removeprefix("neox_")]


def host_run(argv, timeout: float) -> tuple[int, str, float]:
    """(exit code, output, seconds) of this repo's Python run with ``argv``
    on the host alone (no card visible); killed at ``timeout``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    try:
        res = subprocess.run([sys.executable] + argv, cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired as e:
        return -1, f"killed after {timeout} s: {e.stdout}{e.stderr}", \
            time.perf_counter() - t0
    return res.returncode, res.stdout + res.stderr, time.perf_counter() - t0


def attained_peaks(dev) -> dict:
    """One bf16 matmul of PEAK_MATMUL_N^3 and one device-to-device copy of
    PEAK_COPY_BYTES, timed with CUDA events (``device_ms``): the rates
    they attain beside H100_SXM's."""
    n = PEAK_MATMUL_N
    a = torch.randn(n, n, device=dev, dtype=torch.bfloat16)
    b = torch.randn(n, n, device=dev, dtype=torch.bfloat16)
    out = torch.empty(n, n, device=dev, dtype=torch.bfloat16)
    mm_ms = device_ms(lambda: torch.matmul(a, b, out=out), reps=5)
    del a, b, out
    src = torch.empty(PEAK_COPY_BYTES, device=dev, dtype=torch.uint8)
    dst = torch.empty_like(src)
    cp_ms = device_ms(lambda: dst.copy_(src), reps=5)
    del src, dst
    torch.cuda.empty_cache()
    return dict(matmul_tflops=2.0 * n ** 3 / (mm_ms / 1e3) / 1e12,
                peak_tflops=H100_SXM.peak_flops / 1e12,
                matmul_ms=mm_ms,
                copy_gbps=2.0 * PEAK_COPY_BYTES / (cp_ms / 1e3) / 1e9,
                peak_gbps=H100_SXM.hbm_bw / 1e9, copy_ms=cp_ms)


def dryrun_phase(tr, s, dev) -> dict:
    """4l: the dry run (launch/dryrun.py: one rank's step traced on meta
    tensors over a fake group, its census and H100 roofline) held against
    the card's runs. Every trace runs in a subprocess of the host, all at
    once, beside (d) on the card:
    (a) the train phase's configuration, rank 0: the census's would-be
        launches equal ``per_rank_step_launches`` and its payload by label
        a step of rank 0's, exactly;
    (b) the serve phase's decode step (qwen2-0.5b resident on one card, its
        slots and prompt): the launches equal ``step_launches(s)``, and the
        bytes and operations the census bills its kernels equal those the
        kernels line bounds the same calls by (``matmul_work`` of the
        step's 169 dequant_matmul calls on the residency,
        ``dequant_int8_work`` of its embedding rows), exactly;
    (c) the roofline of (a): its compute and memory terms at most the
        traced step's device seconds on rank 0, and each kernel's compute
        term (the census's FLOPs of its calls at the bf16 peak) at most
        that kernel's traced device time in the same step (a term above it
        is an impossible reading: a census that counts too many FLOPs fails
        on every kernel that attains more than its share of the peak).
        Each kernel's memory term is reported beside it and not held: an
        input the previous kernel left in the 50 MB L2 is read faster than
        HBM's rate, so that term above the traced time is possible; (b)
        holds the billed bytes instead;
    (d) attained bf16 matmul TFLOP/s and copy GB/s at most PEAK_SLACK x
        H100_SXM's;
    (e) gpt-neox-20b train_4k on the production mesh under NEOX_SCHEMES,
        then ``launch.validate`` on them: every ratio inside its window
        (its exit code), the analytic split printed."""
    from repro_torch.kernels import ops

    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    names = ["train", "decode"] + [f"neox_{sc}" for sc in NEOX_SCHEMES]
    with ThreadPoolExecutor(len(names)) as pool:
        runs = {n: pool.submit(host_run, ["-m", "repro_torch.launch.dryrun",
                                          "--out", str(DRYRUN_DIR / n)]
                               + dryrun_args(n), DRYRUN_TIMEOUT)
                for n in names}
        peaks = attained_peaks(dev)
        step_want = step_launches(s)
        done = {n: f.result() for n, f in runs.items()}
    out = dict(peaks=peaks, trace_s={}, records={})
    for n in names:
        rc, log, sec = done[n]
        out["trace_s"][n] = sec
        if rc != 0:
            raise Failed(f"dry run {n}: exit {rc}\n{log[-4000:]}")
        [path] = (DRYRUN_DIR / n).glob("*.json")
        out["records"][n] = json.loads(path.read_text())
    vdir = DRYRUN_DIR / "neox"
    vdir.mkdir()
    for sc in NEOX_SCHEMES:
        [path] = (DRYRUN_DIR / f"neox_{sc}").glob("*.json")
        shutil.copy(path, vdir / path.name)
    rc, vlog, sec = host_run(["-m", "repro_torch.launch.validate", "--arch",
                              "gpt-neox-20b", "--dir", str(vdir)],
                             DRYRUN_TIMEOUT)
    out.update(validate=vlog, validate_rc=rc, validate_s=sec)
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)

    # (a) launches and payload a step, rank 0
    steps, r0 = tr["steps"], tr["kernel"][0]
    census = out["records"]["train"]["census"]
    want = {k: tr["per_rank_step_launches"][k] for k in ops.KERNELS}
    if census["launches"] != want:
        raise Failed(f"dry run (a): launches {census['launches']}, the "
                     f"train step's {want}")
    paid = {k: v / steps for k, v in r0["payload_bytes"].items()}
    if {k: v * steps for k, v in census["payload"].items()} \
            != r0["payload_bytes"]:
        raise Failed(f"dry run (a): payload {census['payload']}, the train "
                     f"step's {paid}")
    # (b) one decode step's launches, and its kernels' bytes and operations
    # as the kernels line counts them for the same calls
    dec = out["records"]["decode"]["census"]
    got = {k: v for k, v in dec["launches"].items() if v}
    if got != step_want:
        raise Failed(f"dry run (b): launches {got}, the serve phase's "
                     f"decode step {step_want}")
    slots = s["args"].slots
    gen = torch.Generator(device=dev).manual_seed(0)
    block = s["layout"].leaf_cfg["embed"].quant_block
    work = {"dequant_matmul": matmul_work(matmul_calls(s, slots, slots, gen)),
            "dequantize_int8": dequant_int8_work(
                slots * s["layout"].specs["embed"].shape[1], block)}
    # the census counts the FLOPs of products alone (hlo.py's), so the
    # operations are held for the product
    billed = dict(dec["kernel_bytes"],
                  dequant_matmul_flops=dec["kernel_flops"]["dequant_matmul"])
    want = dict({k: w[0] for k, w in work.items()},
                dequant_matmul_flops=work["dequant_matmul"][1])
    if billed != want:
        raise Failed(f"dry run (b): the census bills {billed}, the kernels "
                     f"line's work of the same calls {want}")
    # (c) the roofline's terms against the traced step, and each kernel's
    rl = out["records"]["train"]["roofline"]
    device_s = r0["profile"]["device_ms"] / 1e3
    for term in ("compute_s", "memory_s"):
        if rl[term] > device_s:
            raise Failed(f"dry run (c): {term} {rl[term]:.4f} s above the "
                         f"traced step's {device_s:.4f} s of device time")
    traced = traced_kernel_ms(r0["profile"])
    kernel_terms = {}
    for k, n_bytes in census["kernel_bytes"].items():
        t = sum(traced.get(part, 0.0) for part in k.split("+"))
        compute_ms = census["kernel_flops"][k] / PEAK["bf16"] * 1e3
        kernel_terms[k] = dict(traced_ms=t, compute_ms=compute_ms,
                               memory_ms=n_bytes / HBM_BPS * 1e3)
        if not t or compute_ms > t:
            raise Failed(f"dry run (c): {k}'s compute term {compute_ms:.4f} "
                         f"ms above its traced {t:.4f} ms")
    # (d) attained rates
    if peaks["matmul_tflops"] > PEAK_SLACK * peaks["peak_tflops"] or \
            peaks["copy_gbps"] > PEAK_SLACK * peaks["peak_gbps"]:
        raise Failed(f"dry run (d): attained {peaks} above the peaks")
    # (e) the paper's volumes
    if rc != 0:
        raise Failed(f"dry run (e): validate exit {rc}\n{vlog}")
    out.update(step_launches=step_want, train_launches=want,
               payload_per_step=paid, device_s=device_s,
               peak_bytes=r0["peak_bytes"], decode_work=work,
               kernel_terms=kernel_terms)
    return out


def traced_kernel_ms(profile) -> dict[str, float]:
    """A traced step's device ms by kernels/ops.py wrapper
    (DEVICE_KERNELS), from its rows by full kernel name."""
    out = collections.Counter()
    for row in profile["kernels"]:
        hit = [DEVICE_KERNELS[w] for w in re.findall(r"\w+", row["name"])
               if w in DEVICE_KERNELS]
        if hit:
            out[hit[0]] += row["ms"]
    return dict(out)


def print_dryrun(dr):
    recs = dr["records"]
    tr = recs["train"]
    print(f"  (a) census launches {tr['census']['launches']} = the train "
          f"step's; payload a step {tr['census']['payload']} = rank 0's")
    print(f"  (a) memory: argument {tr['memory']['argument_bytes']} + temp "
          f"{tr['memory']['temp_bytes']} bytes (census) beside rank 0's "
          f"peak {dr['peak_bytes']} (card)")
    print(f"  (b) decode step launches {dr['step_launches']} = the census's; "
          f"its kernels' (bytes, operations) {dr['decode_work']} = the "
          f"kernels line's")
    rl = tr["roofline"]
    print(f"  (c) roofline compute {rl['compute_s']:.5f} s, memory "
          f"{rl['memory_s']:.5f} s, collective {rl['collective_s']:.5f} s "
          f"(census flops {tr['census']['flops']:.4e}, by dtype "
          f"{tr['census']['flops_by_dtype']}, hbm bytes "
          f"{tr['census']['hbm_bytes']:.4e}) <= traced device "
          f"{dr['device_s']:.5f} s")
    for k, v in dr["kernel_terms"].items():
        print(f"  (c) {k}: compute {v['compute_ms']:.4f} ms "
              f"({v['compute_ms'] / v['traced_ms']:.3f} of) traced "
              f"{v['traced_ms']:.4f} ms; memory {v['memory_ms']:.4f} ms "
              f"({v['memory_ms'] / v['traced_ms']:.3f})")
    pk = dr["peaks"]
    print(f"  (d) bf16 matmul {PEAK_MATMUL_N}^3: {pk['matmul_tflops']:.1f} "
          f"TFLOP/s ({pk['matmul_ms']:.4f} ms) of H100_SXM "
          f"{pk['peak_tflops']:.0f}; copy {PEAK_COPY_BYTES} B: "
          f"{pk['copy_gbps']:.1f} GB/s ({pk['copy_ms']:.4f} ms) of "
          f"{pk['peak_gbps']:.0f}")
    for sc in NEOX_SCHEMES:
        r = recs[f"neox_{sc}"]
        print(f"  (e) gpt-neox-20b {sc}: wire {r['census']['total_wire_bytes']:.4e}"
              f" B, terms c/m/x {r['roofline']['compute_s']:.4f}/"
              f"{r['roofline']['memory_s']:.4f}/"
              f"{r['roofline']['collective_s']:.4f} s, trace "
              f"{r['compile_s']} s")
    for line in dr["validate"].splitlines():
        print(f"  (e) {line}")
    print(f"  subprocess seconds {dict((k, round(v, 1)) for k, v in dr['trace_s'].items())}, "
          f"validate {dr['validate_s']:.1f}")


def dryrun_line(dr) -> dict:
    recs = dr["records"]
    return dict(
        train=dict(launches=recs["train"]["census"]["launches"],
                   payload=recs["train"]["census"]["payload"],
                   memory=recs["train"]["memory"],
                   roofline=recs["train"]["roofline"],
                   flops=recs["train"]["census"]["flops"],
                   flops_by_dtype=recs["train"]["census"]["flops_by_dtype"],
                   hbm_bytes=recs["train"]["census"]["hbm_bytes"],
                   wire_bytes=recs["train"]["census"]["wire_bytes"],
                   device_s=dr["device_s"], peak_bytes=dr["peak_bytes"],
                   kernel_terms=dr["kernel_terms"]),
        decode=dict(launches=dr["step_launches"],
                    roofline=recs["decode"]["roofline"],
                    kernel_work=dr["decode_work"]),
        peaks=dr["peaks"],
        neox={sc: dict(wire_bytes=recs[f"neox_{sc}"]["census"]["wire_bytes"],
                       total_wire_bytes=recs[f"neox_{sc}"]["census"][
                           "total_wire_bytes"],
                       roofline=recs[f"neox_{sc}"]["roofline"],
                       trace_s=recs[f"neox_{sc}"]["compile_s"])
              for sc in NEOX_SCHEMES},
        validate=dr["validate"], subprocess_s=dr["trace_s"],
        validate_s=dr["validate_s"])


def print_plan(pl):
    print(f"  planner (frontier / gpt_neox_20b):")
    for line in pl["cli"]["frontier"].splitlines()[:4] \
            + pl["cli"]["frontier"].splitlines()[-1:]:
        print(f"    {line}")
    print(f"  planner --serve --model qwen2-0.5b: "
          f"{pl['cli']['serve'].splitlines()[-1]}")
    print(f"  auto: {pl['label']} (psi {pl['params']:,}, "
          f"{pl['arch'].n_layers} layers, budget {PLAN_BUDGET_GB} GB)")
    for r in pl["kernel"]:
        print(f"  rank {r['rank']}: loss {r['losses']} grad_norm "
              f"{r['grad_norms']} step_s {r['step_times']} peak_bytes "
              f"{r['peak_bytes']} memory_report {r['memory']}")
    for x in pl["segment_sums"]:
        print(f"  rank {x['rank']}: segment sum {x['segment_sum_s']} s vs "
              f"wall {x['step_s']} s (rel {x['rel']})")
    print(f"  payload bytes a rank a step (probes out): "
          f"{json.dumps(pl['payload_per_step'])}")
    print(f"  phase_volumes (bytes a device a step): "
          f"{json.dumps(pl['volumes'])}")
    for ph, m in pl["measured"].items():
        print(f"  phase {ph}: measured {m * 1e3:.2f} ms, predicted "
              f"{pl['predicted'].get(ph, 0.0) * 1e3:.4f} ms")
    for a, b in pl["bandwidths"].items():
        eff = "none" if b["effective"] is None \
            else f"{b['effective'] / 1e9:.4f} GB/s"
        print(f"  effective bandwidth[{a}]: {eff} (preset "
              f"{b['preset'] / 1e9:.3f} GB/s; gloo through host memory)")
    for line in pl["cli"]["calibrated"].splitlines()[:4]:
        print(f"    {line}")
    for line in pl["calibrate_quick"].splitlines():
        print(f"    {line}")
    print(f"  kernel vs plain: loss rel {pl['loss_rel']}, grad norm rel "
          f"{pl['grad_norm_rel']}; peak bytes summed "
          f"{sum(r['peak_bytes'] for r in pl['kernel'])}; host "
          f"{pl['host_s']:.1f} s, run {pl['run_s']:.1f} s, plain "
          f"{pl['plain_run_s']:.1f} s, calibrate --quick {pl['quick_s']:.1f} "
          f"s; phase {pl['phase_s']:.1f} s")


def plan_line(pl) -> dict:
    k0 = pl["kernel"][0]
    return dict(
        arch="qwen2-0.5b", n_layers=pl["arch"].n_layers, scheme="auto",
        budget_gb=PLAN_BUDGET_GB, mesh=[1, 2, 2], ranks=4, choice=pl["label"],
        fingerprint=pl["cfg"].fingerprint(), params=pl["params"],
        global_batch=8, seq=1024, steps=pl["steps"], losses=k0["losses"],
        grad_norms=k0["grad_norms"], plain_losses=pl["plain"][0]["losses"],
        plain_grad_norms=pl["plain"][0]["grad_norms"],
        loss_rel=pl["loss_rel"], grad_norm_rel=pl["grad_norm_rel"],
        step_s=k0["step_times"], plain_step_s=pl["plain"][0]["step_times"],
        tok_s=k0["tokens_per_s"],
        peak_bytes_per_rank=[r["peak_bytes"] for r in pl["kernel"]],
        peak_bytes_sum=sum(r["peak_bytes"] for r in pl["kernel"]),
        memory_report=k0["memory"], launches=pl["launches"],
        segments=[r["trace"]["segments"] for r in pl["kernel"]],
        probes=[r["trace"]["probes"] for r in pl["kernel"]],
        segment_sums=pl["segment_sums"],
        payload_bytes_per_step_per_rank=pl["payload_per_step"],
        phase_volumes=pl["volumes"], measured_phase_s=pl["measured"],
        predicted_phase_s=pl["predicted"], bandwidths=pl["bandwidths"],
        calibrated=pl["calibrated"],
        calibrate_quick_topology=pl["calibrate_quick_topology"],
        host_s=pl["host_s"], run_s=pl["run_s"],
        plain_run_s=pl["plain_run_s"], quick_s=pl["quick_s"],
        phase_s=pl["phase_s"])

# ---------------------------------------------------------------------------
# phase 4j: serving on the mesh (2, 1, 2)
# ---------------------------------------------------------------------------

def serve_mesh_tree(obj, leaf):
    """``obj`` with every tensor / array mapped by ``leaf``: a rank's result
    crosses the process boundary as numpy (pickled by value), not as
    tensors shared through file descriptors the rank takes with it."""
    if isinstance(obj, dict):
        return {k: serve_mesh_tree(v, leaf) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and obj and \
            isinstance(obj[0], (torch.Tensor, np.ndarray, dict, list)):
        return type(obj)(serve_mesh_tree(v, leaf) for v in obj)
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        return leaf(obj)
    return obj


def serve_mesh_args(devices: int, backend: str | None = None,
                    arch: str = "qwen2-0.5b"):
    """The serve launcher's arguments of phase 4j: ``arch``, zero_topo,
    bf16, quant block 128, seed 0 (``ZeroEngine.init_primaries``: the same
    global weights on any mesh) and the phase's traffic; ``devices`` 4 on
    SERVE_MESH_SHAPE, or 1 (a bare one-card run, the default backend when
    ``backend`` is None)."""
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--scheme", "zero_topo", "--quant-block",
            "128", "--seed", "0", "--devices", str(devices),
            "--requests", str(SERVE_MESH_REQUESTS),
            "--slots", str(SERVE_MESH_SLOTS),
            "--prompt-len", str(SERVE_MESH_PROMPT),
            "--max-len", str(SERVE_MESH_MAX_LEN), "--gen", str(SERVE_MESH_GEN)]
    if backend is not None:
        argv += ["--backend", backend]
    if devices > 1:
        argv += ["--mesh-shape", ",".join(map(str, SERVE_MESH_SHAPE))]
    args = serve.build_parser().parse_args(argv)
    serve.launch_config(args)
    return args


def serve_mesh_hook(rec: dict, forced=None):
    """A ``hook(cb, params)`` for ``launch.serve.serve_rank``: it records in
    ``rec`` this rank's prefill and decode-step logits (on the host), each
    prefill's host ms, each decode step's global input tokens, the payload
    bytes a decode-only step hands gloo by collective label, the per-step
    metrics, the batcher's rows and sequence range, and the model, mesh,
    engine and weights (the (sp) leg's). ``forced``: another leg's decode
    inputs, fed in place of this batcher's own tokens (its host state keeps
    its own)."""
    from repro_torch.core import collectives as col

    def hook(cb, params):
        blocks = cb.paged.blocks
        rec.update(prefill=[], prefill_ms=[], decode=[], inputs=[],
                   step_payload=[], metrics=Collect(), row0=cb.serve.row0,
                   seq_index=blocks.start // (blocks.stop - blocks.start),
                   model=cb.model, mesh=cb.serve.mesh,
                   engine=getattr(cb.serve, "engine", None), params=params)
        cb.metrics = rec["metrics"]
        pre, dec, step = cb._prefill1, cb._decode, cb.step

        def prefill(params, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, c = pre(params, batch)
            torch.cuda.synchronize()
            rec["prefill_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["prefill"].append(logits.float().cpu())
            return logits, c

        def decode(params, caches, batch):
            if forced is not None:
                batch = dict(batch, token=forced[len(rec["decode"])].to(
                    batch["token"].device))
            rec["inputs"].append(batch["token"].cpu())
            logits, c = dec(params, caches, batch)
            rec["decode"].append(logits.float().cpu())
            return logits, c

        def stepped(params):
            n_pre = len(rec["prefill"])
            before = collections.Counter(col.PAYLOAD)
            active = step(params)
            if active and len(rec["prefill"]) == n_pre:
                rec["step_payload"].append(
                    dict(collections.Counter(col.PAYLOAD) - before))
            return active

        cb._prefill1, cb._decode, cb.step = prefill, decode, stepped
    return hook


def serve_mesh_leg(res: dict, rec: dict) -> dict:
    """One leg's record: ``serve_rank``'s result ``res`` (tokens, counters,
    timings, launches, fallbacks, peak bytes) and the hook's ``rec``."""
    full = [r["phase_ms"]["serve_decode"] for r in rec["metrics"].records
            if r["active_slots"] == SERVE_MESH_SLOTS]
    n_tok = sum(len(t) for t in res["tokens"])
    return dict(
        prefill=rec["prefill"], decode=rec["decode"], inputs=rec["inputs"],
        tokens=res["tokens"], counters=res["counters"], steps=res["steps"],
        row0=rec["row0"], seq_index=rec["seq_index"],
        prefill_ms=statistics.median(rec["prefill_ms"]),
        decode_step_ms=statistics.median(full), decode_steps_full=len(full),
        tok_s=n_tok / res["run_s"], run_s=res["run_s"], tokens_total=n_tok,
        setup_s=res["setup_s"], build_s=res["build_s"],
        launches=res["launches"], fallbacks=res["fallbacks"],
        step_payload=rec["step_payload"], memory=res["memory"],
        peak_bytes=res["peak_bytes"])


def serve_mesh_rank(rank: int, world: int) -> dict:
    """One of the four ranks of phase 4j (forked from the launcher's fork
    server): legs (g), (r) and (p) through the serve launcher's
    ``serve_rank``, and (sp) on (g)'s engine and weights."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.config import ShapeConfig
    from repro_torch.serve.engine import ServeEngine

    out = dict(rank=rank, legs={})
    forced = None
    for leg, backend, opts in (("g", "gathered", None),
                               ("r", "resident", None),
                               ("p", "gathered", dict(impl="plain"))):
        rec = {}
        res = serve.serve_rank(
            rank, world, serve_mesh_args(world, backend), engine_opts=opts,
            hook=serve_mesh_hook(rec, forced if leg == "p" else None))
        out["legs"][leg] = serve_mesh_leg(res, rec)
        if leg == "g":
            forced = rec["inputs"]
            model, mesh = rec["model"], rec["mesh"]
            eng, prim = rec["engine"], rec["params"]
        del rec, res
    # (sp): one B = 1 prefill of the first prompt, sequence-parallel and not
    se = ServeEngine(model, eng, mesh,
                     ShapeConfig("sp", SERVE_MESH_PROMPT, 1, "decode"))
    args = serve_mesh_args(world)
    tokens = torch.as_tensor(serve.make_requests(args, model.arch)[0]
                             .prompt[None]).long().to(prim["embed"].device)
    ops.reset_launches()
    ops.reset_dispatch_counters()
    lp, cp = se.make_prefill(seq_parallel=False)(prim, {"tokens": tokens})
    calls, real = [], ops.flash_attention_cuda

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw["q_offset"]))
        return real(q, k, v, **kw)

    ops.flash_attention_cuda = spy
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ls, cs = se.make_prefill(seq_parallel=True)(prim, {"tokens": tokens})
        torch.cuda.synchronize()
        sp_ms = (time.perf_counter() - t0) * 1e3
    finally:
        ops.flash_attention_cuda = real
    # this rank's sequence chunk of every cache entry, both prefills
    cache = dict(entries=0, equal=0, max_abs_err=0.0, max_abs=0.0)
    for kind, entry in cp.items():
        if kind == "pos":
            continue
        for name, t in entry.items():
            e, sc = rel_err(cs[kind][name], t)
            cache["entries"] += 1
            cache["equal"] += int(cs[kind][name].shape == t.shape
                                  and torch.equal(cs[kind][name], t))
            cache["max_abs_err"] = max(cache["max_abs_err"], e)
            cache["max_abs"] = max(cache["max_abs"], sc)
            cache.setdefault("shape", list(t.shape))
    out["sp"] = dict(plain=lp.float().cpu(), sp=ls.float().cpu(), calls=calls,
                     n_layers=model.arch.n_layers, cache=cache,
                     sp_ms=sp_ms, launches=ops.launches(),
                     fallbacks=ops.dispatch_counters())
    del se, model, mesh, eng, prim
    out["mla"] = serve_mesh_mla(rank, world)
    return serve_mesh_tree(out, lambda t: t.numpy())


def serve_mesh_mla(rank: int, world: int) -> dict:
    """The MLA leg of phase 4j on this rank: minicpm3-4b at published width
    and MLA_MESH_L layers through the serve launcher's ``serve_rank`` on
    SERVE_MESH_SHAPE, the latent sharded along the sequence over (node,
    gcd), decode's partial softmax combined over them: (g) the gathered
    backend through the kernels, (p) through the plain versions fed (g)'s
    tokens; (sp) one B = 1 prefill of the first prompt on (g)'s engine and
    weights, sequence-parallel (the latent gathered, under ``lat_gather``)
    and not, each with its payload bytes by label."""
    from repro_torch.core import collectives as col
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.config import ShapeConfig
    from repro_torch.serve.engine import ServeEngine

    arch = cut_train_arch("minicpm3-4b", MLA_MESH_L)
    args = serve_mesh_args(world, "gathered", "minicpm3-4b")
    out, forced = dict(legs={}), None
    for leg, opts in (("g", None), ("p", dict(impl="plain"))):
        rec = {}
        res = serve.serve_rank(rank, world, args, arch, engine_opts=opts,
                               hook=serve_mesh_hook(rec, forced))
        out["legs"][leg] = serve_mesh_leg(res, rec)
        if leg == "g":
            forced = rec["inputs"]
            model, mesh = rec["model"], rec["mesh"]
            eng, prim = rec["engine"], rec["params"]
        del rec, res
    se = ServeEngine(model, eng, mesh,
                     ShapeConfig("sp", SERVE_MESH_PROMPT, 1, "decode"))
    tokens = torch.as_tensor(serve.make_requests(args, arch)[0]
                             .prompt[None]).long().to(prim["embed"].device)
    ops.reset_launches()
    ops.reset_dispatch_counters()
    got = {}
    for key, sp in (("plain", False), ("sp", True)):
        col.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got[key] = se.make_prefill(seq_parallel=sp)(prim, {"tokens": tokens})
        torch.cuda.synchronize()
        got[key + "_ms"] = (time.perf_counter() - t0) * 1e3
        got[key + "_payload"] = dict(col.PAYLOAD)
    (lp, cp), (ls, cs) = got["plain"], got["sp"]
    lat_sp, lat = cs["mla"]["lat"], cp["mla"]["lat"]
    e, sc = rel_err(lat_sp, lat)
    out["sp"] = dict(
        plain=lp.float().cpu(), sp=ls.float().cpu(),
        bitwise=bool(torch.equal(ls, lp)),
        cache=dict(shape=list(lat.shape), equal=bool(
            lat_sp.shape == lat.shape and torch.equal(lat_sp, lat)),
            max_abs_err=e, max_abs=sc),
        plain_ms=got["plain_ms"], sp_ms=got["sp_ms"],
        payload_plain=got["plain_payload"], payload_sp=got["sp_payload"],
        launches=ops.launches(), fallbacks=ops.dispatch_counters(),
        n_layers=model.arch.n_layers,
        lat_width=model.arch.mla.kv_lora + model.arch.mla.qk_rope)
    return out


def hold_serve_mesh_mla(ranks) -> None:
    """The MLA leg on every rank: the requests retired with their tokens,
    the kernels of MLA_SERVE_KERNELS launched in (g), one mla_dv_mismatch
    fallback a layer a prefill and nothing else in every leg and in (sp);
    (p)'s logits within PREFILL_TOL * max|ref| of (g)'s on (g)'s inputs;
    (sp): the sequence-parallel prefill's logits within PREFILL_TOL *
    max|ref| of (p)'s first prefill (the plain versions on the same
    prompt), this rank's chunk of the latent the plain prefill's shape,
    the latent gathered once a layer (the other rank's half of the
    prompt's positions in bf16) under ``lat_gather``, and no K / V
    gathered; the greedy tokens the same on every rank."""
    for r in ranks:
        m = r["mla"]
        g, pl, sp = m["legs"]["g"], m["legs"]["p"], m["sp"]
        for leg, x in m["legs"].items():
            held_fallbacks(f"serve_mesh mla ({leg}) rank {r['rank']}",
                           x["fallbacks"],
                           {MLA_FALLBACK: MLA_MESH_L
                            * x["counters"]["admitted"]})
            c = x["counters"]
            if c["retired"] != SERVE_MESH_REQUESTS or c["rejected"] or \
                    any(len(t) != SERVE_MESH_GEN for t in x["tokens"]):
                raise Failed(f"serve_mesh mla ({leg}) rank {r['rank']}: "
                             f"counters {c}, tokens {x['tokens']}")
        missing = [k for k in MLA_SERVE_KERNELS if g["launches"][k] == 0]
        if missing:
            raise Failed(f"serve_mesh mla rank {r['rank']}: {missing} not "
                         "launched")
        errs = [rel_err(b, a) for a, b in
                zip(g["prefill"] + g["decode"], pl["prefill"] + pl["decode"])]
        m["plain_rel_err"] = max(e / sc for e, sc in errs)
        if m["plain_rel_err"] > PREFILL_TOL:
            raise Failed(f"serve_mesh mla rank {r['rank']}: plain logits "
                         f"{m['plain_rel_err']:.3e} of max|ref| off the "
                         "kernels'")
        held_fallbacks(f"serve_mesh mla (sp) rank {r['rank']}",
                       sp["fallbacks"], {MLA_FALLBACK: 2 * MLA_MESH_L})
        e, sc = rel_err(sp["sp"], pl["prefill"][0])
        m["sp_vs_plain_rel_err"] = e / sc
        if e > PREFILL_TOL * sc:
            raise Failed(f"serve_mesh mla (sp) rank {r['rank']}: logits "
                         f"{e / sc:.3e} of max|ref| off the plain leg's")
        want = MLA_MESH_L * (SERVE_MESH_PROMPT // 2) * sp["lat_width"] * 2
        if sp["payload_sp"].get("lat_gather") != want or \
                "seq_gather" in sp["payload_sp"] or \
                "lat_gather" in sp["payload_plain"] or \
                not sp["cache"]["shape"][2] == SERVE_MESH_PROMPT // 2:
            raise Failed(f"serve_mesh mla (sp) rank {r['rank']}: payload "
                         f"{sp['payload_sp']} (lat_gather {want} wanted), "
                         f"latent chunk {sp['cache']['shape']}")
    if len({tuple(map(tuple, r["mla"]["legs"]["g"]["tokens"]))
            for r in ranks}) != 1:
        raise Failed("serve_mesh mla: the ranks' tokens differ")


def serve_mesh_one(forced) -> dict:
    """(1): the same weights and traffic on one rank (1, 1, 1) in this
    process, the bare one-card launch (``serve_rank`` with the default
    backend, gathered) through the kernels, fed the mesh's decode inputs
    ``forced``."""
    from repro_torch.launch import serve

    rec = {}
    res = serve.serve_rank(0, 1, serve_mesh_args(1),
                           hook=serve_mesh_hook(rec, forced))
    out = dict(prefill=rec["prefill"], decode=rec["decode"],
               tokens=res["tokens"], counters=res["counters"],
               backend=res["backend"], mesh=res["mesh"],
               run_s=res["run_s"], tokens_total=sum(map(len, res["tokens"])))
    del rec, res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_mesh_prediction() -> dict:
    """The payload bytes a rank hands gloo in one decode step, by label,
    from the leaf sizes (before any run): each WIRE leaf's INT8 shard and
    its f32 scales once a use (the tied embed twice: lookup and head), over
    W (gathered, "all_gather") or the residency axes (resident,
    "residency_gather"), both of size 2; the gathered backend also hands
    its PLAIN leaves' bf16 shards over W; the flash-decode combine hands
    its f32 max ("seq_max"), numerator and denominator ("seq_sum") a
    full-attention layer, and the tokens gather its int32 rows."""
    from repro_torch.core.partition import GATHER_Q, MATMUL, padded_flat_size
    from repro_torch.launch.mesh import TEST_AXES, Mesh, scheme_config
    from repro_torch.models.registry import build_model, get_arch

    arch = get_arch("qwen2-0.5b")
    mesh = Mesh(SERVE_MESH_SHAPE, TEST_AXES)
    cfg = scheme_config("zero_topo", mesh, quant_block=128)
    w = cfg.size(cfg.axes.weight)
    wire = plain = 0
    for name, spec in build_model(arch).leaf_specs().items():
        uses = 2 if name == "embed" else (spec.stack or 1)
        pad = padded_flat_size(spec.logical_size, cfg)
        lcfg = cfg.for_leaf(spec.logical_size)
        if spec.kind in (MATMUL, GATHER_Q) and lcfg.quantize_weights:
            wire += uses * (pad + 4 * pad // lcfg.quant_block) // w
        else:
            plain += uses * 2 * pad // w
    b_loc = SERVE_MESH_SLOTS // SERVE_MESH_SHAPE[0]
    heads = b_loc * arch.n_heads
    seq = dict(seq_max=arch.n_layers * heads * 4,
               seq_sum=arch.n_layers * (heads * arch.hdim + heads) * 4,
               batch_gather=b_loc * 4)
    return dict(g=dict(all_gather=wire + plain, **seq),
                r=dict(residency_gather=wire, **seq))


def serve_mesh_phase() -> dict:
    """Phase 4j: one spawn of four ranks (serve_mesh_rank), held leg by
    leg, then (1) in this process."""
    from repro_torch.launch import train

    t_phase = time.perf_counter()
    ranks = [serve_mesh_tree(r, torch.from_numpy) for r in train.spawn(
        serve_mesh_rank, 4, 900, True, (), what="serve_mesh")]
    t_ranks = time.perf_counter() - t_phase
    for r in ranks:
        g, rl, pl = r["legs"]["g"], r["legs"]["r"], r["legs"]["p"]
        for leg, x in r["legs"].items():
            held_fallbacks(f"serve_mesh ({leg}) rank {r['rank']}",
                        x["fallbacks"])
            c = x["counters"]
            if c["retired"] != SERVE_MESH_REQUESTS or c["rejected"] or \
                    any(len(t) != SERVE_MESH_GEN for t in x["tokens"]):
                raise Failed(f"serve_mesh ({leg}) rank {r['rank']}: "
                             f"counters {c}, tokens {x['tokens']}")
        for k in SERVE_MESH_KERNELS:
            if k != "quantize_int8" and rl["launches"][k] == 0 or \
                    g["launches"][k] == 0:
                raise Failed(f"serve_mesh rank {r['rank']}: {k} not "
                             f"launched (g {g['launches'][k]}, r "
                             f"{rl['launches'][k]})")
        # (r) bit for bit (g)
        pairs = list(zip(g["prefill"], rl["prefill"])) \
            + list(zip(g["decode"], rl["decode"]))
        if len(g["prefill"]) != len(rl["prefill"]) or \
                len(g["decode"]) != len(rl["decode"]) or \
                not all(torch.equal(a, b) for a, b in pairs):
            raise Failed(f"serve_mesh rank {r['rank']}: resident logits not "
                         "bit for bit the gathered ones")
        if rl["tokens"] != g["tokens"] or rl["counters"] != g["counters"]:
            raise Failed(f"serve_mesh rank {r['rank']}: resident tokens or "
                         "counters differ")
        # (p) within PREFILL_TOL of (g), on (g)'s inputs
        errs = [rel_err(b, a) for a, b in
                zip(g["prefill"] + g["decode"], pl["prefill"] + pl["decode"])]
        worst = max(e / s for e, s in errs)
        if worst > PREFILL_TOL:
            raise Failed(f"serve_mesh rank {r['rank']}: plain logits "
                         f"{worst:.3e} of max|ref| off the kernels'")
        r["plain_rel_err"] = worst
        r["plain_argmax_equal"] = sum(
            int((a.argmax(-1) == b.argmax(-1)).sum())
            for a, b in zip(g["prefill"] + g["decode"],
                            pl["prefill"] + pl["decode"]))
        r["plain_argmax_total"] = sum(
            a.shape[0] for a in g["prefill"] + g["decode"])
        # (sp): bit for bit the plain prefill, logits and this rank's chunk
        # of every cache entry (as every call has measured them)
        sp = r["sp"]
        held_fallbacks(f"serve_mesh (sp) rank {r['rank']}", sp["fallbacks"])
        e, sc = rel_err(sp["sp"], sp["plain"])
        r["sp_rel_err"] = e / sc
        if not torch.equal(sp["sp"], sp["plain"]):
            raise Failed(f"serve_mesh (sp) rank {r['rank']}: logits "
                         f"{e / sc:.3e} of max|ref| off the plain prefill's")
        ca = sp["cache"]
        if ca["entries"] == 0 or ca["equal"] != ca["entries"]:
            raise Failed(f"serve_mesh (sp) rank {r['rank']}: caches {ca} "
                         "not bit for bit the plain prefill's")
        seq_i = g["seq_index"]
        want = (SERVE_MESH_PROMPT // 2) * seq_i
        if len(sp["calls"]) != sp["n_layers"] or any(
                q[1] != SERVE_MESH_PROMPT // 2 or k[1] != SERVE_MESH_PROMPT
                or off != want for q, k, off in sp["calls"]):
            raise Failed(f"serve_mesh (sp) rank {r['rank']}: flash calls "
                         f"{sp['calls'][:2]} ... ({len(sp['calls'])})")
    tokens = {tuple(map(tuple, r["legs"]["g"]["tokens"])) for r in ranks}
    if len(tokens) != 1:
        raise Failed("serve_mesh: the ranks' tokens differ")
    # (1): one rank, the bare one-card launch fed the mesh's decode inputs:
    # its four prefills and first decode step bit for bit the mesh's (as
    # every call has measured them), every step within PREFILL_TOL (from
    # the second step on, the second sequence rank holds more than one
    # position and the combine sums in another order than one shard)
    t0 = time.perf_counter()
    one = serve_mesh_one(ranks[0]["legs"]["g"]["inputs"])
    t_one = time.perf_counter() - t0
    mesh_pre = ranks[0]["legs"]["g"]["prefill"]
    by_step = []
    for i in range(len(ranks[0]["legs"]["g"]["decode"])):
        by_row = {}
        for r in ranks:
            g = r["legs"]["g"]
            for j, row in enumerate(g["decode"][i]):
                by_row[g["row0"] + j] = row
        by_step.append(torch.stack([by_row[j]
                                    for j in range(SERVE_MESH_SLOTS)]))
    if one["backend"] != "gathered" or one["mesh"] != [1, 1, 1]:
        raise Failed(f"serve_mesh (1): backend {one['backend']} on "
                     f"{one['mesh']}, not the bare launch's")
    if one["counters"] != ranks[0]["legs"]["g"]["counters"]:
        raise Failed(f"serve_mesh (1): counters {one['counters']} not the "
                     "mesh's")
    errs = [rel_err(b, a) for a, b in zip(mesh_pre + by_step,
                                          one["prefill"] + one["decode"])]
    if len(one["prefill"]) != len(mesh_pre) or len(one["decode"]) != \
            len(by_step) or not all(
                torch.equal(a, b) for a, b in
                zip(mesh_pre + by_step[:1], one["prefill"] + one["decode"])):
        raise Failed("serve_mesh (1): the prefills and first decode step "
                     "not bit for bit the mesh's: max|diff| / max|ref| "
                     f"{[f'{e / sc:.2e}' for e, sc in errs]}")
    one_worst = max(e / sc for e, sc in errs)
    if one_worst > PREFILL_TOL:
        raise Failed(f"serve_mesh (1): a decode step {one_worst:.3e} of "
                     "max|ref| off the mesh's")
    one["argmax_equal"] = sum(
        int((a.argmax(-1) == b.argmax(-1)).sum())
        for a, b in zip(by_step, one["decode"]))
    one["argmax_total"] = sum(a.shape[0] for a in by_step)
    hold_serve_mesh_mla(ranks)
    launches = {k: sum(r["legs"][leg]["launches"][k] + (
        r["sp"]["launches"][k] if leg == "g" else 0)
        for r in ranks for leg in ("g", "r"))
        + sum(r["mla"]["legs"]["g"]["launches"][k]
              + r["mla"]["sp"]["launches"][k] for r in ranks)
        for k in KERNEL_INFO}
    return dict(ranks=ranks, launches=launches, one_rel_err=one_worst,
                one=one, prediction=serve_mesh_prediction(),
                ranks_s=t_ranks, one_s=t_one,
                phase_s=time.perf_counter() - t_phase)


def print_serve_mesh(sm):
    pred = sm["prediction"]
    for r in sm["ranks"]:
        for leg, x in r["legs"].items():
            pay = x["step_payload"]
            step = {k: statistics.median(p.get(k, 0) for p in pay)
                    for k in sorted({k for p in pay for k in p})}
            print(f"  rank {r['rank']} ({leg}): prefill_ms "
                  f"{x['prefill_ms']:.1f} decode_step_ms "
                  f"{x['decode_step_ms']:.1f} ({x['decode_steps_full']} full "
                  f"steps) tok_s {x['tok_s']:.3f} peak_bytes "
                  f"{x['peak_bytes']} payload bytes a decode step {step}"
                  + (f" (predicted {pred[leg]})" if leg in pred else "")
                  + f" launches " + json.dumps(
                      {k: x["launches"][k] for k in SERVE_MESH_KERNELS}))
        ca = r["sp"]["cache"]
        print(f"  rank {r['rank']}: (r) bit for bit (g); (p) logits "
              f"{r['plain_rel_err']:.3e} of max|ref|, argmax equal "
              f"{r['plain_argmax_equal']} of {r['plain_argmax_total']}; (sp) "
              f"bit for bit ({ca['equal']} of {ca['entries']} cache entries "
              f"{ca.get('shape')}), {r['sp']['sp_ms']:.1f} ms, "
              f"flash q_offsets {sorted({c[2] for c in r['sp']['calls']})} x "
              f"{len(r['sp']['calls'])}; setup_s "
              f"{[round(x['setup_s'], 1) for x in r['legs'].values()]} "
              f"(build {r['legs']['g']['build_s']:.1f})")
    for r in sm["ranks"]:
        m = r["mla"]
        for leg, x in m["legs"].items():
            pay = x["step_payload"]
            step = {k: statistics.median(p.get(k, 0) for p in pay)
                    for k in sorted({k for p in pay for k in p})}
            print(f"  rank {r['rank']} mla ({leg}): prefill_ms "
                  f"{x['prefill_ms']:.1f} decode_step_ms "
                  f"{x['decode_step_ms']:.1f} tok_s {x['tok_s']:.3f} "
                  f"peak_bytes {x['peak_bytes']} payload bytes a decode "
                  f"step {step} fallbacks {x['fallbacks']}")
        sp = m["sp"]
        print(f"  rank {r['rank']} mla: (p) logits {m['plain_rel_err']:.3e} "
              f"of max|ref|; (sp) logits {m['sp_vs_plain_rel_err']:.3e} of "
              f"max|ref| off (p)'s first prefill, bit for bit the kernels' "
              f"own prefill {sp['bitwise']}, latent chunk {sp['cache']}, "
              f"{sp['sp_ms']:.1f} ms (not sequence-parallel "
              f"{sp['plain_ms']:.1f}), payload {sp['payload_sp']} (not "
              f"sequence-parallel {sp['payload_plain']})")
    one = sm["one"]
    print(f"  (1) the bare one-card launch (backend {one['backend']}): "
          f"prefills and first step bit for bit the mesh's, every step "
          f"{sm['one_rel_err']:.3e} of max|ref|, argmax equal "
          f"{one['argmax_equal']} of {one['argmax_total']}; "
          f"{one['tokens_total']} tokens "
          f"in {one['run_s']:.2f} s; ranks {sm['ranks_s']:.1f} s, (1) "
          f"{sm['one_s']:.1f} s, phase {sm['phase_s']:.1f} s")


def serve_mesh_line(sm) -> dict:
    r0 = sm["ranks"][0]
    legs = {}
    for leg in ("g", "r", "p"):
        xs = [r["legs"][leg] for r in sm["ranks"]]
        pay = xs[0]["step_payload"]
        legs[leg] = dict(
            prefill_ms=[x["prefill_ms"] for x in xs],
            run_s=[x["run_s"] for x in xs],
            decode_step_ms=[x["decode_step_ms"] for x in xs],
            tok_s=[x["tok_s"] for x in xs],
            peak_bytes_per_rank=[x["peak_bytes"] for x in xs],
            payload_bytes_per_decode_step_rank0={
                k: statistics.median(p.get(k, 0) for p in pay)
                for k in sorted({k for p in pay for k in p})},
            launches_per_rank=[{k: x["launches"][k]
                                for k in SERVE_MESH_KERNELS} for x in xs],
            tokens=xs[0]["tokens"], counters=xs[0]["counters"],
            steps=xs[0]["steps"])
    return dict(
        arch="qwen2-0.5b", scheme="zero_topo", mesh=list(SERVE_MESH_SHAPE),
        ranks=4, requests=SERVE_MESH_REQUESTS, slots=SERVE_MESH_SLOTS,
        prompt_len=SERVE_MESH_PROMPT, max_len=SERVE_MESH_MAX_LEN,
        gen=SERVE_MESH_GEN, res_degree=r0["legs"]["r"]["memory"]["res_degree"],
        residency_wire_bytes_per_rank=r0["legs"]["r"]["memory"]["wire_bytes"],
        legs=legs, predicted_payload_bytes_per_decode_step=sm["prediction"],
        resident_bitwise_gathered=True,
        plain_rel_err=[r["plain_rel_err"] for r in sm["ranks"]],
        plain_argmax_equal=[r["plain_argmax_equal"] for r in sm["ranks"]],
        plain_argmax_total=r0["plain_argmax_total"],
        sp_rel_err=[r["sp_rel_err"] for r in sm["ranks"]],
        sp_cache=[r["sp"]["cache"] for r in sm["ranks"]],
        sp_ms=[r["sp"]["sp_ms"] for r in sm["ranks"]],
        sp_flash_q_offsets=[sorted({c[2] for c in r["sp"]["calls"]})
                            for r in sm["ranks"]],
        mla=dict(
            arch="minicpm3-4b", n_layers=MLA_MESH_L, legs={
                leg: dict(prefill_ms=[r["mla"]["legs"][leg]["prefill_ms"]
                                      for r in sm["ranks"]],
                          decode_step_ms=[r["mla"]["legs"][leg]
                                          ["decode_step_ms"]
                                          for r in sm["ranks"]],
                          tok_s=[r["mla"]["legs"][leg]["tok_s"]
                                 for r in sm["ranks"]],
                          peak_bytes_per_rank=[r["mla"]["legs"][leg]
                                               ["peak_bytes"]
                                               for r in sm["ranks"]],
                          tokens=r0["mla"]["legs"][leg]["tokens"])
                for leg in ("g", "p")},
            plain_rel_err=[r["mla"]["plain_rel_err"] for r in sm["ranks"]],
            sp_vs_plain_rel_err=[r["mla"]["sp_vs_plain_rel_err"]
                                 for r in sm["ranks"]],
            sp_bitwise_kernel_prefill=[r["mla"]["sp"]["bitwise"]
                                       for r in sm["ranks"]],
            sp_cache=[r["mla"]["sp"]["cache"] for r in sm["ranks"]],
            sp_payload=[r["mla"]["sp"]["payload_sp"] for r in sm["ranks"]]),
        one_rank_rel_err=sm["one_rel_err"],
        one_rank_argmax_equal=sm["one"]["argmax_equal"],
        one_rank_tok_s=sm["one"]["tokens_total"] / sm["one"]["run_s"],
        setup_s=[[x["setup_s"] for x in r["legs"].values()]
                 for r in sm["ranks"]], ranks_s=sm["ranks_s"],
        one_s=sm["one_s"], phase_s=sm["phase_s"])


# ---------------------------------------------------------------------------
# phase 4b: the quantized reduce-scatters on four ranks
# ---------------------------------------------------------------------------

def collective_rank(rank: int, port: int, queue) -> None:
    """One of the four gloo ranks of the collectives phase (forked from the
    launcher's fork server)."""
    import torch.distributed as dist
    from datetime import timedelta
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=4,
                                timeout=timedelta(seconds=300))
        queue.put((rank, collective_checks(rank), None))
    except Exception:
        queue.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def collective_checks(rank: int) -> dict:
    """a2a_quant_reduce_scatter at bits 4 and 8 over W, over E and over all
    four ranks on (1, 2, 2), on an embed-sized f32 shard per rank: the
    kernel run with the counters zeroed, then the same calls through the
    plain versions. Wire payloads must match bit for bit, the sums within one
    f32 ulp of their largest value, and each error against the exact f32
    reduce-scatter within the reference scenario's bound (d half-steps of the
    group's largest value)."""
    from repro_torch.core import collectives as col
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import (TEST_AXES, Mesh, config_axis_tuples,
                                         scheme_config)

    dev = torch.device("cuda", 0)
    mesh = Mesh((1, 2, 2), TEST_AXES, rank)
    cfg = scheme_config("zero_topo", mesh, quant_block=128)
    plain = dataclasses.replace(cfg, impl="plain")
    mesh.bind(config_axis_tuples(cfg))
    col.bind(mesh)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1000 + rank)
    x = torch.randn((EMBED_N,), generator=gen, device=dev) * 1e-3
    cases = [(name, getattr(cfg.axes, cat), bits)
             for name, cat in (("W", "weight"), ("E", "extra_grad"),
                               ("all", "all")) for bits in (4, 8)]
    ops.reset_launches()
    got = {}
    for name, axes, bits in cases:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q2, s2 = col.a2a_rs_issue(x, axes, cfg, bits)
        red = col.a2a_rs_wait(q2, s2, cfg.size(axes), cfg, bits)
        torch.cuda.synchronize()
        got[name, bits] = (q2, s2, red, time.perf_counter() - t0)
    launches = ops.launches()
    out = dict(rank=rank, launches=launches, cases=[])
    for name, axes, bits in cases:
        q2, s2, red, secs = got.pop((name, bits))
        d = cfg.size(axes)
        q2p, s2p = col.a2a_rs_issue(x, axes, plain, bits)
        redp = col.a2a_rs_wait(q2p, s2p, d, plain, bits)
        if not (torch.equal(q2, q2p) and torch.equal(s2.view(torch.int32),
                                                     s2p.view(torch.int32))):
            raise Failed(f"rank {rank} {name} bits={bits}: wire bytes differ")
        err, scale = rel_err(red, redp)
        ulp = float(torch.finfo(torch.float32).eps) * 2.0 ** math.floor(
            math.log2(scale)) if scale > 0 else 0.0
        if err > ulp:
            raise Failed(f"rank {rank} {name} bits={bits}: sum err {err} > "
                         f"one ulp {ulp}")
        exact = col.psum_scatter(x, axes, cfg)
        gmax = float(col.all_gather_flat(x.abs().max()[None], axes, cfg).max())
        qmax = 7.0 if bits == 4 else 127.0
        ratio = float((red - exact).abs().max()) / (d * (gmax / (2 * qmax)
                                                         + 1e-6))
        if ratio > 1.0:
            raise Failed(f"rank {rank} {name} bits={bits}: error over bound "
                         f"{ratio}")
        out["cases"].append(dict(axes=name, bits=bits, d=d, max_abs_err=err,
                                 ulp=ulp, abs_over_bound=ratio, host_s=secs))
        del q2, s2, red, q2p, s2p, redp, exact
    return out


def collectives_phase() -> list[dict]:
    """Four gloo ranks (processes) sharing the card run collective_checks;
    every kernel of COLLECTIVE_KERNELS must launch on every rank."""
    import multiprocessing as mp
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    from repro_torch.launch import train

    ctx = train.fork_context()
    queue = ctx.Queue()
    procs = [ctx.Process(target=collective_rank, args=(r, port, queue))
             for r in range(4)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        while len(results) + len(errors) < 4:
            rank, res, err = queue.get(timeout=600)
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
            else:
                results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise Failed("collectives phase failed\n" + "\n".join(errors))
    for r in results.values():
        missing = [k for k in COLLECTIVE_KERNELS if r["launches"][k] == 0]
        if missing:
            raise Failed(f"rank {r['rank']}: kernels not launched in the "
                         f"reduce-scatters: {missing}")
    return [results[r] for r in range(4)]


# ---------------------------------------------------------------------------
# phase 5: timing at the serving and training shapes
# ---------------------------------------------------------------------------

def matmul_calls(s, m_layers: int, m_head: int, gen, n_layers=None):
    """The dequant_matmul calls of one serving step on the residency's own
    weights: each of the first ``n_layers`` layers' (default: all) INT8
    projections in leaf order (qwen2's 7, NeoX's 6, an MoE layer's 4: its
    expert stacks are dequantized whole) at M=m_layers, then the
    LM head (the tied embedding or lm_head, x @ W.T) at M=m_head. Returns
    [(x, q, s, (k, n), block, transpose)]."""
    from repro_torch.core.linear import _w_kn

    layout, res, dev, arch = s["layout"], s["residency"], s["device"], s["arch"]
    kind = arch.pattern[0]
    names = [n for n in layout.specs
             if n.startswith(kind + ".") and layout.mode(n) == "wire"
             and layout.specs[n].kind == "matmul"]
    calls = []
    for i in range(arch.n_layers if n_layers is None else n_layers):
        for name in names:
            k, n = _w_kn(layout.specs[name])
            x = torch.randn((m_layers, k), generator=gen, device=dev)
            calls.append((x.to(torch.bfloat16), res[name]["q"][i],
                          res[name]["s"][i], (k, n),
                          layout.leaf_cfg[name].quant_block, False))
    head = "embed" if arch.tie_embeddings else "lm_head"
    k, n = _w_kn(layout.specs[head])
    x = torch.randn((m_head, n), generator=gen, device=dev).to(torch.bfloat16)
    calls.append((x, res[head]["q"], res[head]["s"], (k, n),
                  layout.leaf_cfg[head].quant_block, True))
    return calls


def dequant_int8_work(n: int, block: int) -> tuple[float, int]:
    """(bytes, operations) of dequantizing ``n`` INT8 values of ``block``
    to bf16: the int8 and f32 scales read, the bf16 written."""
    return n + 4 * n / block + 2 * n, n


def matmul_work(calls):
    n_bytes = n_ops = 0
    for x, _, _, (k, n), block, transpose in calls:
        m = x.shape[0]
        out = k if transpose else n
        n_bytes += k * n + 4 * k * n // block + 2 * x.numel() + 2 * m * out
        n_ops += 2 * m * k * n
    return n_bytes, n_ops


def run_matmuls(calls, impl=None):
    from repro_torch.kernels import ops

    def fn():
        for x, q, sc, kn, block, transpose in calls:
            ops.dequant_matmul(x, q, sc, kn, block, transpose=transpose,
                               dtype=torch.bfloat16, impl=impl)
    return fn


def run_on_path(calls, path):
    """The calls on path ``path`` (an index into PATHS), forced: to time a
    shape on another path than its own (the SIMT kernel the heads' decode
    path replaced, the threshold rows). The launches are not counted."""
    from repro_torch.kernels.dequant_matmul import dequant_matmul_flat_cuda

    def fn():
        for x, q, sc, (k, n), block, transpose in calls:
            dequant_matmul_flat_cuda(x, q[:k * n].view(k, n),
                                     sc[:k * n // block].view(k, n // block),
                                     block, transpose=transpose, path=path)
    return fn


def dense_weights(calls):
    """Each call's weight dequantized to a bf16 (K, N) tensor beforehand:
    the library yardstick's operand."""
    from repro_torch.kernels import ref

    return [ref.dequant_w_flat_ref(q[:kn[0] * kn[1]].view(kn),
                                   sc[:kn[0] * kn[1] // block].view(
                                       kn[0], kn[1] // block),
                                   block).to(torch.bfloat16)
            for _, q, sc, kn, block, _ in calls]


def run_dense(calls, dense):
    def fn():
        for (x, _, _, _, _, transpose), w in zip(calls, dense):
            x @ (w.T if transpose else w)
    return fn


def timing_phase(s, gen):
    from repro_torch.kernels import ops
    from repro_torch.kernels.dequant_matmul import PATHS
    from repro_torch.serve.resident import init_primaries

    layout, res, dev = s["layout"], s["residency"], s["device"]
    out = {}

    # quantize: the residency's largest call (the stacked w_gate leaf, bf16)
    prim = init_primaries(layout, s["args"].seed, dev)["attn.w_gate"].reshape(-1)
    block = layout.leaf_cfg["attn.w_gate"].quant_block
    n = prim.numel()
    out["quantize_int8"] = dict(
        work=f"attn.w_gate stack: {n} bf16 elements, block {block}",
        ms=device_ms(lambda: ops.quantize_int8(prim, block), reps=5),
        plain_ms=device_ms(lambda: ops.quantize_int8(prim, block, impl="plain"),
                           reps=5),
        library_ms=None,
        bound=bound_ms(2 * n + n + 4 * n / block, 4 * n, "f32"))
    del prim

    # dequantize: the prefill's embedding lookup (128 rows of 896)
    ids = torch.as_tensor(s["reqs"][0].prompt).long().to(dev)
    vocab, d = layout.specs["embed"].shape
    block = layout.leaf_cfg["embed"].quant_block
    rows = res["embed"]["q"][: vocab * d].view(vocab, d)[ids].reshape(-1)
    srows = res["embed"]["s"][: vocab * d // block].view(vocab, d // block)[ids] \
        .reshape(-1)
    n = rows.numel()
    out["dequantize_int8"] = dict(
        work=f"prefill embedding rows: {n} int8 -> bf16, block {block}",
        ms=device_ms(lambda: ops.dequantize_int8(rows, srows, block,
                                                 torch.bfloat16), reps=50),
        plain_ms=device_ms(lambda: ops.dequantize_int8(
            rows, srows, block, torch.bfloat16, impl="plain"), reps=50),
        library_ms=None,
        bound=bound_ms(*dequant_int8_work(n, block), "f32"))

    # dequant_matmul: one decode step's 169 calls (M = slots) and one
    # prefill's (M = prompt_len, LM head M = 1), on the residency's weights
    slots, plen = s["args"].slots, s["args"].prompt_len
    dec = matmul_calls(s, slots, slots, gen)
    b, o = matmul_work(dec)
    dense = dense_weights(dec)
    took = [call_path(c) for c in dec]
    if set(took) != {"decode"}:
        raise Failed(f"decode step's dequant_matmul paths {set(took[:-1])} "
                     f"(layers), {took[-1]} (head)")
    out["dequant_matmul"] = dict(
        work=f"one decode step: {len(dec)} calls at M={slots} (layers and "
             "head on the decode path)",
        ms=device_ms(run_matmuls(dec), reps=5),
        plain_ms=device_ms(run_matmuls(dec, "plain"), reps=2, replays=2),
        library_ms=device_ms(run_dense(dec, dense), reps=5),
        library="torch.matmul by the dequantized bf16 weights, product only",
        bound=bound_ms(b, o, "bf16"))
    # the same calls all on the SIMT kernel (as they ran before the decode
    # path)
    out["dequant_matmul_decode_simt"] = dict(
        work=f"one decode step: {len(dec)} calls at M={slots}, SIMT path forced",
        ms=device_ms(run_on_path(dec, PATHS.index("simt")), reps=5),
        bound=out["dequant_matmul"]["bound"])
    del dense
    # the backward's dX at the training M: one layer's 7 transposed calls
    dx = [(torch.randn((TRAIN_M, kn[1]), generator=gen, device=dev)
           .to(torch.bfloat16), q, sc, kn, block, True)
          for _, q, sc, kn, block, _ in dec[:7]]
    dense = dense_weights(dx)
    b, o = matmul_work(dx)
    out["dequant_matmul_dx"] = dict(
        work=f"one layer's 7 dX products at M={TRAIN_M} (transposed)",
        ms=device_ms(run_matmuls(dx), reps=2),
        plain_ms=device_ms(run_matmuls(dx, "plain"), reps=1, replays=2),
        library_ms=device_ms(run_dense(dx, dense), reps=2),
        bound=bound_ms(b, o, "bf16"))
    # the training forward (and its recompute): the same 7 weights, x @ W
    fw = [(torch.randn((TRAIN_M, kn[0]), generator=gen, device=dev)
           .to(torch.bfloat16), q, sc, kn, block, False)
          for _, q, sc, kn, block, _ in dec[:7]]
    b, o = matmul_work(fw)
    out["dequant_matmul_fwd"] = dict(
        work=f"one layer's 7 forward products at M={TRAIN_M}",
        ms=device_ms(run_matmuls(fw), reps=2),
        plain_ms=device_ms(run_matmuls(fw, "plain"), reps=1, replays=2),
        library_ms=device_ms(run_dense(fw, dense), reps=2),
        bound=bound_ms(b, o, "bf16"))
    del dense, dx, fw
    out["dequant_matmul_threshold"] = path_threshold(dec[:7], gen, dev)
    pre = matmul_calls(s, plen, 1, gen)
    b, o = matmul_work(pre)
    dense = dense_weights(pre)
    out["dequant_matmul_prefill"] = dict(
        work=f"one prefill: {len(pre)} calls at M={plen} (head M=1)",
        ms=device_ms(run_matmuls(pre), reps=3),
        plain_ms=device_ms(run_matmuls(pre, "plain"), reps=1, replays=2),
        library_ms=device_ms(run_dense(pre, dense), reps=3),
        library="torch.matmul by the dequantized bf16 weights, product only",
        bound=bound_ms(b, o, "bf16"))
    del dense
    shapes = []
    for label, calls in (("decode", dec), ("prefill", pre)):
        for per, reps in [(calls[j:-1:7], 3) for j in range(7)] \
                + [(calls[-1:], 10)]:                # one shape, all layers
            b, o = matmul_work(per)
            x, _, _, kn, _, tr = per[0]
            row = dict(step=label, M=x.shape[0], K=kn[0], N=kn[1],
                       transpose=tr, path=call_path(per[0]),
                       ms_per_call=device_ms(run_matmuls(per), reps=reps)
                       / len(per),
                       bound_ms_per_call=bound_ms(b, o, "bf16")[0] / len(per))
            if label == "decode":
                dense = dense_weights(per)
                row["library_ms_per_call"] = device_ms(
                    run_dense(per, dense), reps=reps) / len(per)
                row["simt_ms_per_call"] = device_ms(
                    run_on_path(per, PATHS.index("simt")), reps=reps) / len(per)
                row["plain_ms_per_call"] = device_ms(
                    run_matmuls(per, "plain"), reps=1, replays=2) / len(per)
                del dense
            shapes.append(row)
    shapes += falcon_prefill_shapes(gen, dev)
    shapes += falcon_decode_shapes(gen, dev, slots)
    out["dequant_matmul_shapes"] = shapes

    # the whole decode step as a CUDA graph, beside the host-clock
    # decode_step_ms, and with its layer products on the SIMT kernel
    out["decode_step_graph_runs"] = decode_graphs(s)
    out["decode_step_graph_ms"] = statistics.mean(
        out["decode_step_graph_runs"]["own"])

    # flash_attention: one layer's prefill attention (B=1, 14 heads over 2,
    # S=128, D=64, causal, bf16); the library yardstick is PyTorch's SDPA
    h, hkv, hd, S = 14, 2, 64, plen
    q = torch.randn((h, S, hd), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((hkv, S, hd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((hkv, S, hd), generator=gen, device=dev).to(torch.bfloat16)
    q4 = q[None]
    k4 = k.repeat_interleave(h // hkv, dim=0)[None].contiguous()
    v4 = v.repeat_interleave(h // hkv, dim=0)[None].contiguous()
    pairs = h * S * (S + 1) // 2
    out["flash_attention"] = dict(
        work=f"prefill attention: {h} heads over {hkv}, S={S}, D={hd}, "
             "causal, bf16",
        ms=device_ms(lambda: ops.flash_attention(q, k, v), reps=50),
        plain_ms=device_ms(lambda: ops.flash_attention(q, k, v, impl="plain"),
                           reps=50),
        library_ms=device_ms(lambda: torch.nn.functional
                             .scaled_dot_product_attention(q4, k4, v4,
                                                           is_causal=True),
                             reps=50),
        bound=bound_ms(2 * (2 * h + 2 * hkv) * S * hd, 4 * hd * pairs, "bf16"))
    # the f32 kernel (CUDA cores) at the same prefill shape, beside f32 SDPA
    q, k, v, q4, k4, v4 = (t.float() for t in (q, k, v, q4, k4, v4))
    out["flash_attention_f32"] = dict(
        work=f"prefill attention: {h} heads over {hkv}, S={S}, D={hd}, "
             "causal, f32",
        ms=device_ms(lambda: ops.flash_attention(q, k, v), reps=50),
        plain_ms=device_ms(lambda: ops.flash_attention(q, k, v, impl="plain"),
                           reps=50),
        library_ms=device_ms(lambda: torch.nn.functional
                             .scaled_dot_product_attention(q4, k4, v4,
                                                           is_causal=True),
                             reps=50),
        bound=bound_ms(4 * (2 * h + 2 * hkv) * S * hd, 4 * hd * pairs, "f32"))
    # the training step's forward: B = 2 x 14 heads over 2, S = 1024, causal
    bsz, S = TRAIN_M // 1024, 1024
    q = torch.randn((bsz * h, S, hd), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((bsz * hkv, S, hd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((bsz * hkv, S, hd), generator=gen, device=dev).to(torch.bfloat16)
    q4 = q.view(bsz, h, S, hd)
    k4 = k.view(bsz, hkv, S, hd).repeat_interleave(h // hkv, dim=1).contiguous()
    v4 = v.view(bsz, hkv, S, hd).repeat_interleave(h // hkv, dim=1).contiguous()
    pairs = bsz * h * S * (S + 1) // 2
    out["flash_attention_train"] = dict(
        work=f"training attention: B={bsz} x {h} heads over {hkv}, S={S}, "
             f"D={hd}, causal, bf16",
        ms=device_ms(lambda: ops.flash_attention(q, k, v), reps=20),
        plain_ms=device_ms(lambda: ops.flash_attention(q, k, v, impl="plain"),
                           reps=5),
        library_ms=device_ms(lambda: torch.nn.functional
                             .scaled_dot_product_attention(q4, k4, v4,
                                                           is_causal=True),
                             reps=20),
        bound=bound_ms(2 * (2 * h + 2 * hkv) * bsz * S * hd, 4 * hd * pairs,
                       "bf16"))
    return out


def rounding_flips(gen, dev):
    """Share of bf16 outputs that round away from the exact product (f64 on
    the f32 weights, rounded once to bf16), for the kernel on its own path,
    on the SIMT kernel (forced) and for the plain version (f32 cuBLAS), at
    falcon-mamba's w_in at M = 128 and 4, qwen2's w_down at M = 4 and
    2,048 and its w_up.T at M = 2,048: how close each path's f32 sums come
    to exact before their one bf16 rounding."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.dequant_matmul import (PATHS,
                                                    dequant_matmul_flat_cuda)

    rows = []
    for k, n, m, tr in ((MAMBA_D, 2 * SCAN_D, 128, False),
                        (MAMBA_D, 2 * SCAN_D, 4, False), (4864, 896, 4, False),
                        (4864, 896, TRAIN_M, False), (896, 4864, TRAIN_M, True)):
        w = torch.randn(k * n, generator=gen, device=dev) * 0.05
        q, sc = ops.quantize_int8(w, 128)
        del w
        x = torch.randn((m, n if tr else k), generator=gen, device=dev) \
            .to(torch.bfloat16)
        w64 = (q.view(k, n).double()
               * sc.view(k, n // 128).double().repeat_interleave(128, 1))
        exact = (x.double() @ (w64.T if tr else w64)).to(torch.bfloat16)
        del w64
        row = dict(M=m, K=k, N=n, transpose=tr,
                   path=call_path((x, q, sc, (k, n), 128, tr)))
        for impl in (None, "plain"):
            y = ops.dequant_matmul(x, q, sc, (k, n), 128, transpose=tr,
                                   impl=impl)
            row["plain_flips" if impl else "kernel_flips"] = float(
                (y != exact).double().mean())
        y = dequant_matmul_flat_cuda(x, q[:k * n].view(k, n),
                                     sc[:k * n // 128].view(k, n // 128), 128,
                                     transpose=tr, path=PATHS.index("simt"))
        row["simt_flips"] = float((y != exact).double().mean())
        rows.append(row)
        print(f"  dequant_matmul rounding M={m} ({k}, {n}){'.T' if tr else ''}: "
              f"outputs off the exact bf16 {row['kernel_flips']:.5f} "
              f"({row['path']}), SIMT {row['simt_flips']:.5f}, plain "
              f"{row['plain_flips']:.5f}")
    return rows


def call_path(call) -> str:
    """The path ("simt" | "tensor_core") a dequant_matmul call takes."""
    from repro_torch.kernels.dequant_matmul import PATHS, dequant_matmul_path

    x, _, _, (k, n), block, transpose = call
    return PATHS[dequant_matmul_path(x.shape[0], k, n, block, transpose,
                                     x.dtype)]


def path_threshold(layer, gen, dev):
    """One layer's 7 products on each of the three paths, forced: x @ W at
    M = 1 ... 16, 32, 64, 128 and x @ W.T at M = 4 ... 128: where each path
    stops winning. A path that does not take one of the seven shapes (the
    decode path's x @ W.T past DEC_TN_MAX_N) times the layer without it, and
    the row says which; one that takes none of them gets no time."""
    from repro_torch.kernels.dequant_matmul import PATHS, dequant_matmul_takes

    rows = []
    shapes = [(m, False) for m in (*range(1, 17), 32, 64, 128)] \
        + [(m, True) for m in (4, 8, 16, 32, 64, 128)]
    for m, tr in shapes:
        calls = [(torch.randn((m, kn[1] if tr else kn[0]), generator=gen,
                              device=dev).to(torch.bfloat16), q, sc, kn,
                  block, tr) for _, q, sc, kn, block, _ in layer]
        row = dict(M=m, transpose=tr, paths=[call_path(c) for c in calls])
        for path, name in enumerate(PATHS):
            takes = [dequant_matmul_takes(m, *c[3], c[4], tr, c[0].dtype,
                                          path) for c in calls]
            row[f"{name}_ms"] = device_ms(run_on_path(
                [c for c, t in zip(calls, takes) if t], path), reps=5) \
                if any(takes) else None
            if not all(takes):
                row[f"{name}_skips"] = [list(c[3]) for c, t
                                        in zip(calls, takes) if not t]
        rows.append(row)
    return rows


def falcon_prefill_shapes(gen, dev):
    """falcon-mamba-7b's three prefill products (w_in, w_dt, w_out) at
    M = 128 on seeded weights, per call: kernel, bf16 cuBLAS on the
    dequantized weight, bound."""
    from repro_torch.kernels import ops

    rows = []
    for k, n in ((MAMBA_D, 2 * SCAN_D), (MAMBA_DTR, SCAN_D), (SCAN_D, MAMBA_D)):
        w = torch.randn(k * n, generator=gen, device=dev) * 0.05
        q, sc = ops.quantize_int8(w, 128)
        del w
        call = (torch.randn((128, k), generator=gen, device=dev)
                .to(torch.bfloat16), q, sc, (k, n), 128, False)
        dense = dense_weights([call])
        b, o = matmul_work([call])
        rows.append(dict(step="falcon-mamba prefill", M=128, K=k, N=n,
                         transpose=False, path=call_path(call),
                         ms_per_call=device_ms(run_matmuls([call]), reps=10),
                         library_ms_per_call=device_ms(
                             run_dense([call], dense), reps=10),
                         bound_ms_per_call=bound_ms(b, o, "bf16")[0]))
        del q, sc, dense, call
    return rows


def falcon_decode_shapes(gen, dev, slots):
    """falcon-mamba-7b's four decode products at M = slots on seeded
    weights, per call: w_in, w_dt, w_out (x @ W, SIMT) and the tied LM head
    (x @ W.T, decode), each on its own path, on the SIMT kernel (forced),
    bf16 cuBLAS on the dequantized weight, the plain version, and the
    bound."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.dequant_matmul import PATHS

    rows = []
    for k, n, tr in ((MAMBA_D, 2 * SCAN_D, False), (MAMBA_DTR, SCAN_D, False),
                     (SCAN_D, MAMBA_D, False), (MAMBA_V, MAMBA_D, True)):
        w = torch.randn(k * n, generator=gen, device=dev) * 0.05
        q, sc = ops.quantize_int8(w, 128)
        del w
        call = (torch.randn((slots, n if tr else k), generator=gen, device=dev)
                .to(torch.bfloat16), q, sc, (k, n), 128, tr)
        dense = dense_weights([call])
        b, o = matmul_work([call])
        reps = 5 if k * n > 1 << 27 else 10
        rows.append(dict(step="falcon-mamba decode", M=slots, K=k, N=n,
                         transpose=tr, path=call_path(call),
                         ms_per_call=device_ms(run_matmuls([call]), reps=reps),
                         simt_ms_per_call=device_ms(
                             run_on_path([call], PATHS.index("simt")), reps=reps),
                         library_ms_per_call=device_ms(
                             run_dense([call], dense), reps=reps),
                         plain_ms_per_call=device_ms(
                             run_matmuls([call], "plain"), reps=1, replays=2),
                         bound_ms_per_call=bound_ms(b, o, "bf16")[0]))
        del q, sc, dense, call
    return rows


def train_timing(gen, dev):
    """The training kernels at the step's shapes: the tied embedding's
    stage-1 quantize and receive-side sum, one layer's seven dW products."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.dequant_matmul import (
        PATHS, dequant_matmul_blocked_cuda, dequant_matmul_blocked_path)
    from repro_torch.kernels.quant_int4 import INT4_PATHS, quantize_int4_path

    out = {}
    n, block = EMBED_N, 128
    g = (torch.randn((n,), generator=gen, device=dev) * 1e-3).to(torch.bfloat16)
    variant = INT4_PATHS[quantize_int4_path(block, g.dtype,
                                            g.data_ptr() % 16 == 0)]
    out["quantize_int4"] = dict(
        work=f"embed grad stage 1: {n} bf16 elements, block {block} "
             f"({variant})",
        ms=device_ms(lambda: ops.quantize_int4(g, block), reps=5),
        plain_ms=device_ms(lambda: ops.quantize_int4(g, block, impl="plain"),
                           reps=2),
        library_ms=None,
        bound=bound_ms(2 * n + n / 2 + 4 * n / block, 4 * n, "f32"))
    # W = 2: each rank receives d = 2 chunks of n / 2 elements and sums them
    q, s = ops.quantize_int4(g, block)
    del g
    half = n // 2
    out["dequantize_int4_sum"] = dict(
        work=f"embed grad stage 1 receive: d=2 chunks of {half} elements",
        ms=device_ms(lambda: ops.dequantize_int4_sum(q, s, 2, block), reps=5),
        plain_ms=device_ms(lambda: ops.dequantize_int4_sum(
            q, s, 2, block, impl="plain"), reps=2),
        library_ms=None,
        bound=bound_ms(n / 2 + 4 * n / block + 4 * half, 2 * n, "f32"))
    del q, s

    # bits=8 receive side at the same size: d = 2 chunks of n / 2 int8
    g32 = torch.randn((n,), generator=gen, device=dev) * 1e-3
    q, s = ops.quantize_int8(g32, block)
    del g32
    out["dequantize_int8_sum"] = dict(
        work=f"embed grad stage 1 receive at bits 8: d=2 chunks of {half} "
             "int8",
        ms=device_ms(lambda: ops.dequantize_int8_sum(q, s, 2, block), reps=5),
        plain_ms=device_ms(lambda: ops.dequantize_int8_sum(
            q, s, 2, block, impl="plain"), reps=2),
        library_ms=None,
        bound=bound_ms(n + 4 * n / block + 4 * half, 1.5 * n, "f32"))
    del q, s

    # INT4 dequantize (the quant_error round trip) at the same size
    q, s = ops.quantize_int4(torch.randn((n,), generator=gen, device=dev),
                             block)
    per_dtype = {}
    for odt, size in ((torch.float32, 4), (torch.bfloat16, 2)):
        per_dtype[str(odt)[6:]] = dict(
            ms=device_ms(lambda: ops.dequantize_int4(q, s, block, odt), reps=5),
            plain_ms=device_ms(lambda: ops.dequantize_int4(
                q, s, block, odt, impl="plain"), reps=2),
            bound=bound_ms(n / 2 + 4 * n / block + size * n, n, "f32"))
    del q, s
    f32 = per_dtype["float32"]
    out["dequantize_int4"] = dict(
        work=f"{n} elements, block {block}, to f32 (bf16 in per_dtype)",
        ms=f32["ms"], plain_ms=f32["plain_ms"], library_ms=None,
        bound=f32["bound"], per_dtype=per_dtype)

    # the blocked dequant-matmul at qwen2's w_up shape and the training M;
    # the library yardstick multiplies by the weight already dequantized
    k, nn = 896, 4864
    x = torch.randn((TRAIN_M, k), generator=gen, device=dev)
    qb, sb = blocked_quant(torch.randn((k, nn), generator=gen, device=dev), 128)
    wdense = qb.float() * sb.repeat_interleave(128, dim=0)
    path = PATHS[dequant_matmul_blocked_path(TRAIN_M, k, nn, 128)]
    if path != blocked_path(TRAIN_M, k, nn, 128):
        raise Failed(f"dequant_matmul_blocked timing: took the {path} path")
    n_bytes = 4 * TRAIN_M * k + k * nn + 4 * k * nn / 128 + 4 * TRAIN_M * nn
    out["dequant_matmul_blocked"] = dict(
        work=f"x ({TRAIN_M}, {k}) f32 @ w_up ({k}, {nn}) int8, bk 128 ({path})",
        path=path,
        ms=device_ms(lambda: ops.dequant_matmul_blocked(x, qb, sb), reps=5),
        plain_ms=device_ms(lambda: ops.dequant_matmul_blocked(
            x, qb, sb, impl="plain"), reps=5),
        library_ms=device_ms(lambda: x @ wdense, reps=5),
        library="torch.matmul by the dequantized f32 weight (TF32 off)",
        bound=bound_ms(n_bytes, 2 * TRAIN_M * k * nn, "f32"),
        # the tensor-core path's own work: three bf16 products (h, m, l)
        bound_bf16_split=bound_ms(n_bytes, 3 * 2 * TRAIN_M * k * nn, "bf16"),
        bound_bytes=bound_ms(n_bytes, 0, "bf16"))
    # the same call on the SIMT kernel it took before the tensor-core path
    out["dequant_matmul_blocked_simt"] = dict(
        work=f"the same, SIMT path forced",
        ms=device_ms(lambda: dequant_matmul_blocked_cuda(
            x, qb, sb, path=PATHS.index("simt")), reps=5),
        bound=out["dequant_matmul_blocked"]["bound"])
    del x, qb, sb, wdense

    # one layer's seven dW products: bf16 operands on the tensor cores (the
    # training step's), f32 operands on the SIMT path, each beside cuBLAS's
    # bare x.T @ g in the same dtype
    for key, dtype, path in (("matmul_quant", torch.bfloat16, "tensor_core"),
                             ("matmul_quant_simt", torch.float32, "simt")):
        out[key] = mq_timing(gen, dev, dtype, path, block)
    return out


def neox_train_shapes(gen, dev):
    """gpt-neox-20b's training products at one rank's M = TRAIN_M, bf16,
    block 128, per distinct (K, N) of a layer: the forward x @ W and dX = g
    @ W.T on 8a and the fused dW (matmul_quant, bits 4) on 9a, each beside
    bf16 cuBLAS on the dequantized weight (x.T @ g for dW, no quantize
    epilogue) and its bound; then one layer's six of each summed."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.dequant_matmul import (PATHS, dequant_matmul_path,
                                                    matmul_quant_path)

    block, m = 128, TRAIN_M
    rows = []
    for k, n in dict.fromkeys(NEOX_LAYER_KN):
        w = torch.randn((k * n,), generator=gen, device=dev) / math.sqrt(k)
        q, sc = ops.quantize_int8(w, block)
        del w
        dense = ref.dequant_w_flat_ref(q.view(k, n), sc.view(k, n // block),
                                       block).to(torch.bfloat16)
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        g = (torch.randn((m, n), generator=gen, device=dev) * 1e-2) \
            .to(torch.bfloat16)
        w_bytes = k * n + 4 * k * n / block
        for what, fn, lib, n_bytes, path in (
                ("fwd", lambda: ops.dequant_matmul(x, q, sc, (k, n), block),
                 lambda: x @ dense, w_bytes + 2 * m * (k + n),
                 PATHS[dequant_matmul_path(m, k, n, block, False,
                                           torch.bfloat16)]),
                ("dX", lambda: ops.dequant_matmul(g, q, sc, (k, n), block,
                                                  transpose=True),
                 lambda: g @ dense.T, w_bytes + 2 * m * (k + n),
                 PATHS[dequant_matmul_path(m, k, n, block, True,
                                           torch.bfloat16)]),
                ("dW", lambda: ops.matmul_quant(x, g, block, bits=4),
                 lambda: x.T @ g, 2 * m * (k + n) + k * n / 2
                 + 4 * k * n / block,
                 PATHS[matmul_quant_path(m, k, n, block, torch.bfloat16)])):
            if path != "tensor_core":
                raise Failed(f"NeoX training {what} ({k}, {n}): took the "
                             f"{path} path")
            rows.append(dict(product=what, M=m, K=k, N=n, path=path,
                             ms=device_ms(fn, reps=5),
                             cublas_ms=device_ms(lib, reps=5),
                             bound_ms=bound_ms(n_bytes, 2 * m * k * n,
                                               "bf16")[0]))
        del q, sc, dense, x, g
    per_layer = {}
    for what in ("fwd", "dX", "dW"):
        mine = {(r["K"], r["N"]): r for r in rows if r["product"] == what}
        per_layer[what] = {key: sum(mine[kn][key] for kn in NEOX_LAYER_KN)
                           for key in ("ms", "cublas_ms", "bound_ms")}
    return dict(per_shape=rows, per_layer=per_layer)


def mq_timing(gen, dev, dtype, path, block):
    """One layer's seven matmul_quant calls at M = TRAIN_M, bits 4, operands
    in ``dtype`` (each call must take ``path``): kernel, plain version,
    cuBLAS's x.T @ g, and per distinct shape."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.dequant_matmul import PATHS, matmul_quant_path

    size = torch.finfo(dtype).bits // 8
    op_type = "bf16" if dtype == torch.bfloat16 else "f32"
    calls = [(torch.randn((TRAIN_M, k), generator=gen, device=dev).to(dtype),
              (torch.randn((TRAIN_M, nn), generator=gen, device=dev) * 1e-2)
              .to(dtype)) for k, nn in LAYER_KN]
    for k, nn in LAYER_KN:
        took = PATHS[matmul_quant_path(TRAIN_M, k, nn, block, dtype)]
        if took != path:
            raise Failed(f"matmul_quant timing ({k}, {nn}) {dtype}: took the "
                         f"{took} path, not {path}")

    def work(k, nn):
        return (size * TRAIN_M * (k + nn) + k * nn / 2 + 4 * k * nn / block,
                2 * TRAIN_M * k * nn)

    def run(impl=None):
        def fn():
            for x, gg in calls:
                ops.matmul_quant(x, gg, block, bits=4, impl=impl)
        return fn

    def cublas():
        for x, gg in calls:
            x.T @ gg

    per = []
    for j in (0, 1, 4, 6):           # the four distinct shapes
        (k, nn), (x, gg) = LAYER_KN[j], calls[j]
        per.append(dict(M=TRAIN_M, K=k, N=nn, path=path, ms=device_ms(
            lambda: ops.matmul_quant(x, gg, block, bits=4), reps=5),
            cublas_ms=device_ms(lambda: x.T @ gg, reps=5),
            bound_ms=bound_ms(*work(k, nn), op_type)[0]))
    n_bytes = sum(work(k, nn)[0] for k, nn in LAYER_KN)
    n_ops = sum(work(k, nn)[1] for k, nn in LAYER_KN)
    return dict(
        work=f"one layer's 7 dW products at M={TRAIN_M}, {op_type} operands "
             f"({path}), bits 4, block {block}",
        ms=device_ms(run(), reps=3), plain_ms=device_ms(run("plain"), reps=3),
        library_ms=device_ms(cublas, reps=3),
        library=f"x.T @ g (cuBLAS {op_type}, no quantize epilogue)",
        bound=bound_ms(n_bytes, n_ops, op_type), per_shape=per)


def print_attn(nx, npf):
    print(f"  launches {nx['launches']}; counters {nx['counters']}; prefill "
          f"logits max_abs_err {npf['logits_err']:.3e} (max|ref| "
          f"{npf['logits_scale']:.3e}, argmax equal {npf['argmax_equal']})")
    print_held(npf)
    print_prefill_f32(npf)
    print_decode_step(npf)
    print(f"  prefill_ms {npf['prefill_ms']:.3f} decode_step_ms "
          f"{nx['decode_step_ms']:.3f} decode_step_graph_ms "
          f"{nx['decode_step_graph_ms']:.3f} (layers on SIMT and own path in "
          f"turns: {nx['decode_step_graph_runs']}) tok_s "
          f"{nx['tokens'] / nx['run_s']:.3f} "
          f"setup_s {nx['setup_s']:.1f} max_memory_allocated {nx['peak_bytes']} "
          f"residency_bytes {nx['memory']['wire_bytes']}")
    print(f"  traced prefill: {npf['traced_flash_calls']} flash_attention "
          f"(missed by the trace: {npf['traced_flash_missed']}) "
          f"{npf['traced_flash_ms']:.4f} ms of "
          f"{npf['traced']['device_ms']:.3f} ms device time "
          f"({npf['traced_flash_names']}); the head's decode kernel: "
          f"{npf['traced_head_calls']} calls, the wide one "
          f"{npf['traced_head_wide_ms']:.4f} ms")


def print_mla(ml, mpf, ml_t):
    """The mla phase: its checks, times and launches."""
    print(f"  launches {ml['launches']}; counters {ml['counters']}; prefill "
          f"logits max_abs_err {mpf['logits_err']:.3e} (max|ref| "
          f"{mpf['logits_scale']:.3e}, argmax equal {mpf['argmax_equal']})")
    print_held(mpf)
    print_prefill_f32(mpf)
    print_decode_step(mpf)
    mem = ml["memory"]
    print(f"  prefill_ms {mpf['prefill_ms']:.3f} (traced device ms "
          f"{mpf['traced']['device_ms']:.3f}) decode_step_ms "
          f"{ml['decode_step_ms']:.3f} decode_step_graph_ms "
          f"{ml['decode_step_graph_ms']:.3f} (layers on SIMT and own path in "
          f"turns: {ml['decode_step_graph_runs']}) tok_s "
          f"{ml['tokens'] / ml['run_s']:.3f} setup_s {ml['setup_s']:.1f} "
          f"max_memory_allocated {ml['peak_bytes']} residency_bytes "
          f"{mem['wire_bytes']} (dense {mem['dense_bytes']})")
    print(f"  a B = 1 prefill's launches {ml['prefill_launches']} (predicted "
          f"{MLA_PREFILL_LAUNCHES}); a 4-slot decode step's "
          f"{ml['step_launches']} (predicted {MLA_STEP_LAUNCHES})")
    for key, tm in ml_t.items():
        print_timing(key, tm)


def mla_line(ml, mpf) -> dict:
    """The mla phase's JSON line."""
    return dict(
        arch=ml["arch"].name, n_layers=ml["arch"].n_layers,
        requests=len(ml["reqs"]), slots=ml["args"].slots,
        prompt_len=ml["args"].prompt_len, gen=ml["args"].gen,
        max_len=ml["args"].max_len, tokens=ml["tokens"], steps=ml["steps"],
        prefill_ms=mpf["prefill_ms"], decode_step_ms=ml["decode_step_ms"],
        decode_step_graph_ms=ml["decode_step_graph_ms"],
        decode_step_graph_runs=ml["decode_step_graph_runs"],
        tok_s=ml["tokens"] / ml["run_s"], run_s=ml["run_s"],
        setup_s=ml["setup_s"], residency_bytes=ml["memory"]["wire_bytes"],
        dense_bytes=ml["memory"]["dense_bytes"],
        max_memory_allocated=ml["peak_bytes"], launches=ml["launches"],
        prefill_launches=ml["prefill_launches"],
        prefill_launches_predicted=MLA_PREFILL_LAUNCHES,
        decode_step_launches=ml["step_launches"],
        decode_step_launches_predicted=MLA_STEP_LAUNCHES,
        prefill_logits_max_abs_err=mpf["logits_err"],
        prefill_logits_max_abs_ref=mpf["logits_scale"],
        prefill_argmax_equal=mpf["argmax_equal"],
        prefill_f32_logits_max_abs_err=mpf["f32_logits_err"],
        prefill_f32_logits_max_abs_ref=mpf["f32_logits_scale"],
        prefill_bf16_kernel_vs_f32_plain=mpf["bf16_kernel_vs_f32_plain"],
        prefill_bf16_plain_vs_f32_plain=mpf["bf16_plain_vs_f32_plain"],
        **{k: v for k, v in mpf.items() if k.startswith("decode_")},
        traced_prefill_wall_ms=mpf["traced"]["wall_ms"],
        traced_prefill_device_ms=mpf["traced"]["device_ms"],
        traced_prefill_top_kernels=mpf["traced"]["top"],
        attention_sublayers_held=mpf["attention_sublayers_held"],
        attention_sublayer_worst=mpf["attention_sublayer_worst"])


def print_shapes(rows):
    for r in rows:
        extra = "".join(f", {label} {r[key]:.5f}" for key, label in (
            ("simt_ms_per_call", "SIMT"), ("plain_ms_per_call", "plain"))
            if key in r)
        print(f"  {r['step']} {r['leaf']} M={r['M']} ({r['K']}, {r['N']})"
              f"{'.T' if r['transpose'] else ''} {r['path']}: "
              f"{r['ms_per_call']:.5f} ms{extra}, bf16 cuBLAS "
              f"{r['library_ms_per_call']:.5f}, bound "
              f"{r['bound_ms_per_call']:.5f} "
              f"({r['bound_ms_per_call'] / r['ms_per_call']:.0%} of it)")


def print_timing(key, tm):
    lib = tm["library_ms"]
    print(f"  {key} ({tm['work']}): {tm['ms']:.5f} ms, plain "
          f"{tm['plain_ms']} ms, library "
          f"{'none' if lib is None else f'{lib:.5f}'} ms, bound "
          f"{tm['bound'][0]:.5f} ms ({tm['bound'][1]})")


def print_cut_train(tc, what: str):
    """A cut-depth training phase's ranks, its traced kernel by rank and
    the ranks' summed peak memory beside the card's."""
    print_train(tc)
    print(f"  traced step, {what} by rank: {tc['traced']}; device kernel "
          f"calls by rank: {tc['traced_kernel_calls']}")
    spare = (tc["card_bytes"] - tc["peak_bytes_sum"]) / 2 ** 30
    print(f"  {tc['arch'].name} at {tc['arch'].n_layers} layers "
          f"({tc['params']} parameters): max_memory_allocated summed over "
          f"the ranks {tc['peak_bytes_sum']} of {tc['card_bytes']} bytes "
          f"({spare:.2f} GiB to spare, {TRAIN_HEADROOM / 2 ** 30:.0f} "
          f"wanted), {tc['peak_bytes_sum'] / tc['params']:.2f} bytes a "
          f"parameter; plain run {tc['plain_peak_bytes_sum']} bytes; "
          f"max_memory_reserved summed {tc['peak_reserved_sum']} (plain "
          f"{tc['plain_peak_reserved_sum']}); the card had "
          f"{tc['card_free_at_start']} bytes free as the ranks started, this "
          f"process reserving {tc['parent_reserved']}; phase "
          f"{tc['phase_s']:.1f} s")


def cut_train_line(tc, traced_key: str, **extra) -> dict:
    """A cut-depth training phase's JSON line (train_neox, train_deepseek,
    train_ssm, train_gemma): step 0 pays for first use and the last is
    traced, so
    step 1 is the timed one."""
    a, n0 = tc["arch"], tc["kernel"][0]
    return dict(
        arch=a.name, n_layers=a.n_layers, pattern=dict(collections.Counter(
            a.pattern)), d_model=a.d_model, n_heads=a.n_heads,
        head_dim=a.hdim, d_ff=a.d_ff, vocab=a.vocab, **extra,
        scheme="zero_topo", mesh=[1, 2, 2], ranks=4,
        global_batch=8, seq=1024, steps=tc["steps"], losses=n0["losses"],
        grad_norms=n0["grad_norms"], plain_losses=tc["plain"][0]["losses"],
        plain_grad_norms=tc["plain"][0]["grad_norms"],
        loss_rel=tc["loss_rel"], grad_norm_rel=tc["grad_norm_rel"],
        grad_norm_held_steps=tc["grad_norm_held_steps"],
        step_s=n0["step_times"], step_s_timed=n0["step_times"][1],
        tok_s_timed=n0["tokens_per_s"][1],
        plain_step_s=tc["plain"][0]["step_times"],
        peak_bytes_per_rank=[r["peak_bytes"] for r in tc["kernel"]],
        peak_bytes_sum=tc["peak_bytes_sum"], card_bytes=tc["card_bytes"],
        params=tc["params"],
        peak_bytes_per_param=tc["peak_bytes_sum"] / tc["params"],
        plain_peak_bytes_per_rank=[r["peak_bytes"] for r in tc["plain"]],
        plain_peak_bytes_sum=tc["plain_peak_bytes_sum"],
        peak_reserved_sum=tc["peak_reserved_sum"],
        plain_peak_reserved_sum=tc["plain_peak_reserved_sum"],
        card_free_at_start=tc["card_free_at_start"],
        parent_reserved=tc["parent_reserved"],
        payload_bytes_per_step_per_rank={
            op: b / tc["steps"] for op, b in n0["payload_bytes"].items()},
        phase_s_per_step=[{k: v / tc["steps"] for k, v in r["phase_s"].items()}
                          for r in tc["kernel"]],
        traced_step_wall_ms=[r["profile"]["wall_ms"] for r in tc["kernel"]],
        traced_step_device_ms=[r["profile"]["device_ms"] for r in tc["kernel"]],
        traced_step_kernel_calls=tc["traced_kernel_calls"],
        traced_step_top_kernels_rank0=n0["profile"]["top"],
        traced_step_matmul_quant=tc["matmul_quant_traced"],
        **{f"traced_step_{traced_key}": tc["traced"]},
        launches_per_step_per_rank=tc["per_rank_step_launches"],
        state_bytes_per_rank=n0["memory"], run_s=tc["run_s"],
        plain_run_s=tc["plain_run_s"], phase_s=tc["phase_s"])


def print_train(tr):
    print(f"  qwen2-0.5b at {tr['arch'].n_layers} layers")
    for label, run in (("kernels", tr["kernel"]), ("plain", tr["plain"])):
        for r in run:
            print(f"  {label} rank {r['rank']}: loss {r['losses']} grad_norm "
                  f"{r['grad_norms']} step_s {r['step_times']} tok/s "
                  f"{r['tokens_per_s']} peak_bytes {r['peak_bytes']} "
                  f"launches {r['launches']} payload_bytes {r['payload_bytes']}")
    print(f"  kernel vs plain: loss rel {tr['loss_rel']}, grad norm rel "
          f"{tr['grad_norm_rel']} (held at {tr['grad_norm_held_steps']} "
          f"steps)")
    print(f"  traced step, matmul_quant by path: {tr['matmul_quant_traced']}")


def serve_attn_line(nx, npf) -> dict:
    """A served attention model's JSON line (NeoX, gemma, deepseek)."""
    return dict(
        arch=nx["arch"].name, requests=len(nx["reqs"]), slots=nx["args"].slots,
        prompt_len=nx["args"].prompt_len, gen=nx["args"].gen,
        max_len=nx["args"].max_len, tokens=nx["tokens"], steps=nx["steps"],
        prefill_ms=npf["prefill_ms"], decode_step_ms=nx["decode_step_ms"],
        decode_step_graph_ms=nx["decode_step_graph_ms"],
        decode_step_graph_runs=nx["decode_step_graph_runs"],
        tok_s=nx["tokens"] / nx["run_s"], run_s=nx["run_s"],
        setup_s=nx["setup_s"], residency_bytes=nx["memory"]["wire_bytes"],
        dense_bytes=nx["memory"]["dense_bytes"],
        max_memory_allocated=nx["peak_bytes"], launches=nx["launches"],
        prefill_logits_max_abs_err=npf["logits_err"],
        prefill_logits_max_abs_ref=npf["logits_scale"],
        prefill_argmax_equal=npf["argmax_equal"],
        prefill_f32_logits_max_abs_err=npf["f32_logits_err"],
        prefill_f32_logits_max_abs_ref=npf["f32_logits_scale"],
        prefill_bf16_kernel_vs_f32_plain=npf["bf16_kernel_vs_f32_plain"],
        prefill_bf16_plain_vs_f32_plain=npf["bf16_plain_vs_f32_plain"],
        **{k: v for k, v in npf.items() if k.startswith("decode_")},
        traced_prefill_wall_ms=npf["traced"]["wall_ms"],
        traced_prefill_device_ms=npf["traced"]["device_ms"],
        traced_prefill_top_kernels=npf["traced"]["top"],
        traced_prefill_flash_ms=npf["traced_flash_ms"],
        traced_prefill_flash_calls=npf["traced_flash_calls"],
        traced_prefill_flash_missed=npf["traced_flash_missed"],
        attention_sublayers_held=npf["attention_sublayers_held"],
        attention_sublayer_worst=npf["attention_sublayer_worst"],
        traced_prefill_head_wide_ms=npf["traced_head_wide_ms"],
        traced_prefill_head_wide_calls=npf["traced_head_wide_calls"],
        traced_prefill_head_calls=npf["traced_head_calls"])


def sm_clock_mhz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), in MHz."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, timeout=60, check=True)
    return float(res.stdout.strip().splitlines()[0])


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="",
                    help="also write the full report (per-shape timings, "
                         "ptxas output) to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    # the training phases' ranks fork from this server; its imports run
    # beside the build and the serving phases
    train.start_fork_server()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    card = nvidia_smi()
    t_start = time.perf_counter()
    phases = {}                     # phase name -> seconds since the start

    def phase(name):
        now = time.perf_counter() - t_start
        if phases:
            last = next(reversed(phases))
            print(f"phase {last} took {now - phases[last]:.1f} s", flush=True)
        phases[name] = now
        print(f"phase {name} (at {now:.1f} s)", flush=True)

    phase("build")
    t0 = time.perf_counter()
    kcuda.build_all()
    print(f"  built {kcuda.BUILD_LOG['built']} in {time.perf_counter() - t0:.1f} s"
          f" -> {kcuda.BUILD_LOG['dir']}")
    for stem, log in kcuda.BUILD_LOG["ptxas"].items():
        for line in log.splitlines():
            if "registers" in line or re.search(r"[1-9]\d* bytes spill", line):
                print(f"  ptxas {stem}: {line.strip()}")

    phase("kernels")
    checks: dict[str, list] = {}
    check_kernels(dev, gen, checks)
    check_dequant_kernels(dev, gen, checks)

    flips = rounding_flips(gen, dev)

    phase("ops (quant_error, blocked matmul)")
    qe_rows, qe_launches = quant_error_path(gen, dev, checks)
    bm_launches = blocked_matmul_path(gen, dev, checks)
    print(f"  launches: quant_error {qe_launches}; blocked matmul "
          f"{bm_launches}")

    phase("serve")
    s = serve_phase(SERVE_ARGS, SERVE_KERNELS)
    pf = check_prefill(s)
    pf.update(check_prefill_f32(s))
    pf.update(check_decode_step(s))
    held_fallbacks(s["arch"].name, ops.dispatch_counters())
    print(f"  launches {s['launches']}; counters {s['counters']}; prefill "
          f"logits max_abs_err {pf['logits_err']:.3e} (max|ref| "
          f"{pf['logits_scale']:.3e}, argmax equal {pf['argmax_equal']})")
    print_held(pf)
    print_prefill_f32(pf)
    print_decode_step(pf)

    phase("ssm")
    m, mpf, scan_t, xproj_t = ssm_phase(gen, dev)
    print(f"  launches {m['launches']}; counters {m['counters']}; prefill "
          f"logits max_abs_err {mpf['logits_err']:.3e} (max|ref| "
          f"{mpf['logits_scale']:.3e}, argmax equal {mpf['argmax_equal']})")
    print_held(mpf)
    print_prefill_f32(mpf)
    print_decode_step(mpf)
    print(f"  prefill_ms {mpf['prefill_ms']:.3f} decode_step_ms "
          f"{m['decode_step_ms']:.3f} decode_step_graph_ms "
          f"{m['decode_step_graph_ms']:.3f} (layers on SIMT and own path in "
          f"turns: {m['decode_step_graph_runs']}) tok_s "
          f"{m['tokens'] / m['run_s']:.3f} "
          f"setup_s {m['setup_s']:.1f} max_memory_allocated {m['peak_bytes']} "
          f"residency_bytes {m['memory']['wire_bytes']}")
    for seq, tm in scan_t.items():
        print(f"  selective_scan S={seq}: {tm['ms']:.4f} ms, plain "
              f"{tm['plain_ms']:.4f} ms, bound {tm['bound'][0]:.4f} ms "
              f"({tm['bound'][1]}), SFU floor {tm['sfu_floor_ms']:.4f} ms")
    print(f"  traced prefill: {mpf['traced_scan_calls']} scans "
          f"{mpf['traced_scan_ms']:.4f} ms of {mpf['traced']['device_ms']:.3f} "
          f"ms device time")
    print(f"  dequantize_int8 {xproj_t['work']}: {xproj_t['ms']:.5f} ms, "
          f"plain {xproj_t['plain_ms']:.5f} ms, bound "
          f"{xproj_t['bound'][0]:.5f} ms")

    phase("neox")
    nx, npf, nx_t = neox_phase(gen, dev, checks)
    print_attn(nx, npf)
    for key in ("flash_attention_d96", "flash_attention_f32_d96",
                "dequant_matmul_prefill_neox"):
        print_timing(key, nx_t[key])
    print_shapes(nx_t["shapes"])

    phase("neox10b")
    x10, x10pf, x10_t = neox10b_phase(gen, dev)
    print_attn(x10, x10pf)
    for key, tm in x10_t.items():
        if key != "shapes":
            print_timing(key, tm)
    print_shapes(x10_t["shapes"])

    phase("gemma")
    gm, gpf, gm_t = gemma_phase(gen, dev)
    print_attn(gm, gpf)
    for key, tm in gm_t.items():
        if key != "shapes":
            print_timing(key, tm)
    print_shapes(gm_t["shapes"])

    phase("deepseek")
    ds, dspf, ds_t = deepseek_phase(gen, dev)
    print_attn(ds, dspf)
    for key, tm in ds_t.items():
        if key != "shapes":
            print_timing(key, tm)
    print_shapes(ds_t["shapes"])

    phase("mla")
    ml, mlpf, ml_t = mla_phase(gen, dev)
    print_mla(ml, mlpf, ml_t)

    phase("train")
    try:
        tr = train_phase()
        print_train(tr)
        phase("ckpt")
        ck = ckpt_phase(tr)
        print_ckpt(ck)
        phase("replica")
        rp = replica_phase()
        print_replica(rp)
        phase("serve_mesh")
        sm = serve_mesh_phase()
        print_serve_mesh(sm)
        phase("plan")
        pl = plan_phase()
        print_plan(pl)
        phase("dryrun")
        dr = dryrun_phase(tr, s, dev)
        print_dryrun(dr)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
        shutil.rmtree(TRACE_DIR, ignore_errors=True)
        shutil.rmtree(PLAN_DIR, ignore_errors=True)
        shutil.rmtree(DRYRUN_DIR, ignore_errors=True)

    phase("train_neox")
    tn = neox_train_phase()
    print_cut_train(tn, "tensor-core flash")

    phase("train_deepseek")
    tds = deepseek_train_phase()
    print_cut_train(tds, "tensor-core flash")

    phase("train_ssm")
    tsm = ssm_train_phase()
    print_cut_train(tsm, "selective_scan")

    phase("train_gemma")
    tgm = gemma_train_phase()
    print_cut_train(tgm, "tensor-core flash")

    phase("collectives")
    cl = collectives_phase()
    for r in cl:
        print(f"  rank {r['rank']}: launches {r['launches']}")
        for c in r["cases"]:
            print(f"    {c['axes']:3s} bits={c['bits']} d={c['d']}: sum vs plain "
                  f"{c['max_abs_err']:.3e} (ulp {c['ulp']:.3e}), error/bound "
                  f"{c['abs_over_bound']:.4f}, host_s {c['host_s']:.3f}")
    cl_launches = {k: sum(r["launches"][k] for r in cl) for k in ops.KERNELS}

    regimes = []
    for flags in REGIME_FLAGS:
        phase(f"regimes ({' '.join(flags)})")
        rg = regime_phase(tr, flags)
        for r, sr in zip(rg["ranks"], tr["kernel"]):
            print(f"  rank {r['rank']}: loss {r['losses']} grad_norm "
                  f"{r['grad_norms']} step_s {r['step_times']} (seed "
                  f"{sr['step_times'][:REGIME_STEPS]}) tok/s "
                  f"{r['tokens_per_s']} (seed "
                  f"{sr['tokens_per_s'][:REGIME_STEPS]}) peak_bytes "
                  f"{r['peak_bytes']} (seed {sr['peak_bytes']}) grad_buffer "
                  f"{r['memory']['grad_buffer']} (seed "
                  f"{sr['memory']['grad_buffer']}) prefetch_buffer "
                  f"{r['memory']['prefetch_buffer']} payload_bytes "
                  f"{r['payload_bytes']}")
        print(f"  vs the seed run's first {REGIME_STEPS} steps: bitwise "
              f"{rg['bitwise']}, loss rel {rg['loss_rel']}, grad norm rel "
              f"{rg['grad_norm_rel']}")
        regimes.append(rg)

    phase("timing")
    t = timing_phase(s, gen)
    t.update(train_timing(gen, dev))
    plen = m["args"].prompt_len
    t["selective_scan"] = scan_t[plen]
    t["dequantize_int8_w_xproj"] = xproj_t
    t.update({k: v for k, v in nx_t.items() if k != "shapes"})
    t["dequant_matmul_shapes"] += nx_t["shapes"] + x10_t["shapes"] \
        + gm_t["shapes"] + ds_t["shapes"]
    t.update({k: v for k, v in x10_t.items() if k != "shapes"})
    t.update({k: v for k, v in gm_t.items() if k != "shapes"})
    t.update({k: v for k, v in ds_t.items() if k != "shapes"})
    # the NeoX training step's attention forward (2 rows of 1,024 a rank) at
    # both models' head widths, and its products on 8a / 9a
    for key, h, hd in (("flash_attention_train_d96", NEOX_H, NEOX_HD),
                       ("flash_attention_train_d128", NEOX10B_H, NEOX10B_HD)):
        t[key] = flash_timing(gen, dev, TRAIN_M // 1024, h, 1024, hd,
                              torch.bfloat16, "NeoX training attention")
    # gemma3-1b's training attention (2 rows of 1,024 a rank, 4 heads of 256
    # over 1, local and global) and falcon-mamba-7b's training scan
    for key, window in (("flash_attention_train_d256_window", GEMMA_W),
                        ("flash_attention_train_d256", 0)):
        t[key] = flash_timing(gen, dev, TRAIN_M // 1024, GEMMA_H, 1024,
                              GEMMA_HD, torch.bfloat16,
                              "gemma training attention", hkv=GEMMA_HKV,
                              window=window)
    t["selective_scan_train"] = scan_timing(
        gen, dev, SCAN_TRAIN_B, 1024, "one layer's training scan, a rank")
    nts = neox_train_shapes(gen, dev)
    for key in ("flash_attention_d128", "flash_attention_f32_d128",
                "flash_attention_train_d96", "flash_attention_train_d128",
                "flash_attention_train_d256",
                "flash_attention_train_d256_window", "selective_scan_train"):
        print_timing(key, t[key])
    for r in nts["per_shape"]:
        print(f"  NeoX training {r['product']} M={r['M']} ({r['K']}, "
              f"{r['N']}) {r['path']}: {r['ms']:.5f} ms, bf16 cuBLAS "
              f"{r['cublas_ms']:.5f}, bound {r['bound_ms']:.5f}")
    print(f"  NeoX training, one layer's six: {nts['per_layer']}")

    phase("moe")
    mo, mopf, mo_t = moe_phase(gen, dev, checks)
    print_moe(mo, mopf, mo_t)
    t["dequantize_int8_expert_row"] = mo_t["dequantize_int8_expert_row"]
    t["dequant_matmul_shapes"] += mo_t["shapes"]
    t.update(ml_t)

    phase("jamba")
    jb, jbpf, jb_t = jamba_phase(gen, dev, checks)
    print_jamba(jb, jbpf, jb_t)
    t["dequantize_int8_expert_row_jamba"] = jb_t

    phase("mixtral")
    mx, mxpf = mixtral_phase(gen, dev, checks)
    print(f"  launches {mx['launches']}; prefill logits max_abs_err "
          f"{mxpf['logits_err']:.3e} (max|ref| {mxpf['logits_scale']:.3e}, "
          f"argmax equal {mxpf['argmax_equal']}); prefill_ms "
          f"{mxpf['prefill_ms']:.3f} decode_step_ms {mx['decode_step_ms']:.3f}"
          f" tok_s {mx['tokens'] / mx['run_s']:.3f}")
    print_held(mxpf)
    print_decode_step(mxpf)
    print_routing(mxpf)

    phase("vlm")
    vl = vlm_phase(gen, dev)
    print_vlm(vl)

    phase("whisper")
    wh = whisper_phase(gen, dev)
    print_vlm(wh)
    # the non-causal kernel at whisper's cross-attention (16 heads of 64,
    # its 128 served positions) over 1,536 frames, the aligned count nearest
    # its 1,500 (which take the chunked plain path)
    for key, dt in (("flash_attention_cross", torch.bfloat16),
                    ("flash_attention_f32_cross", torch.float32)):
        t[key] = flash_timing(gen, dev, 1, 16, WHISPER_PROMPT, 64, dt,
                              "cross-attention over 1,536 frames", sk=1536,
                              causal=False)
        print_timing(key, t[key])

    phase("train_moe")
    tmo = moe_train_phase()
    print_cut_train(tmo, "tensor-core flash")

    phase("train_vlm")
    tvl = vlm_train_phase()
    print_cut_train(tvl, "tensor-core flash")

    phase("train_mla")
    tml = mla_train_phase()
    print_cut_train(tml, "tensor-core matmul_quant")

    phase("train_whisper")
    twh = whisper_train_phase()
    print_cut_train(twh, "tensor-core flash")

    phase("train_jamba")
    tjb = jamba_train_phase()
    print_cut_train(tjb, "selective_scan")

    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        tm = t[name]
        bms, by = tm["bound"]
        by_path = dict(serve=s["launches"][name],
                       serve_ssm=m["launches"][name],
                       serve_neox=nx["launches"][name],
                       serve_neox10b=x10["launches"][name],
                       serve_gemma=gm["launches"][name],
                       serve_deepseek=ds["launches"][name],
                       serve_moe=mo["launches"][name],
                       serve_mixtral=mx["launches"][name],
                       serve_vlm=vl["launches"][name],
                       serve_mla=ml["launches"][name],
                       serve_whisper=wh["launches"][name],
                       serve_jamba=jb["launches"][name],
                       train=tr["launches"][name],
                       train_neox=tn["launches"][name],
                       train_deepseek=tds["launches"][name],
                       train_ssm=tsm["launches"][name],
                       train_gemma=tgm["launches"][name],
                       train_moe=tmo["launches"][name],
                       train_vlm=tvl["launches"][name],
                       train_mla=tml["launches"][name],
                       train_whisper=twh["launches"][name],
                       train_jamba=tjb["launches"][name],
                       ckpt=sum(leg["launches"][name] for leg in ck["legs"]),
                       replica=rp["launches"][name],
                       serve_mesh=sm["launches"][name],
                       plan=pl["launches"][name],
                       collectives=cl_launches[name],
                       regimes=sum(rg["launches"][name] for rg in regimes),
                       quant_error=qe_launches[name],
                       blocked_matmul=bm_launches[name])
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
            launches_per_train_step_per_rank=tr["per_rank_step_launches"][name],
            launches_per_neox_train_step_per_rank=tn[
                "per_rank_step_launches"][name],
            launches_per_deepseek_train_step_per_rank=tds[
                "per_rank_step_launches"][name],
            launches_per_ssm_train_step_per_rank=tsm[
                "per_rank_step_launches"][name],
            launches_per_gemma_train_step_per_rank=tgm[
                "per_rank_step_launches"][name],
            launches_per_moe_train_step_per_rank=tmo[
                "per_rank_step_launches"][name],
            launches_per_vlm_train_step_per_rank=tvl[
                "per_rank_step_launches"][name],
            launches_per_mla_train_step_per_rank=tml[
                "per_rank_step_launches"][name],
            launches_per_whisper_train_step_per_rank=twh[
                "per_rank_step_launches"][name],
            launches_per_jamba_train_step_per_rank=tjb[
                "per_rank_step_launches"][name],
            launches_per_jamba_prefill=jb["prefill_launches"].get(name, 0),
            launches_per_jamba_decode_step=jb["step_launches"].get(name, 0),
            launches_per_mla_prefill=ml["prefill_launches"].get(name, 0),
            launches_per_mla_decode_step=ml["step_launches"].get(name, 0),
            launches_per_whisper_prefill=wh["prefill_launches"].get(name, 0),
            launches_per_whisper_decode_step=wh["decode_step_launches"].get(
                name, 0),
            launches_per_moe_decode_step=mo["step_launches"].get(name, 0),
            launches_serve_mesh_per_rank=[
                r["legs"]["g"]["launches"][name]
                + r["legs"]["r"]["launches"][name]
                + r["sp"]["launches"][name] for r in sm["ranks"]],
            max_abs_err=max(c["max_abs_err"] for c in checks[name]),
            tolerance=[c["tolerance"] for c in checks[name]],
            ms=tm["ms"], plain_ms=tm["plain_ms"], bound_ms=bms, bound_by=by,
            library_ms=tm["library_ms"], work=tm["work"],
            **(dict(paths=DMM_PATHS, untied_heads=[
                r for r in t["dequant_matmul_shapes"]
                if r.get("leaf") == "lm_head" and "simt_ms_per_call" in r])
               if name == "dequant_matmul" else {})))
    dq4 = t["dequantize_int4"]["per_dtype"]["bfloat16"]
    kernels_extra = {
        key: dict(work=t[key]["work"], ms=t[key]["ms"],
                  plain_ms=t[key].get("plain_ms"),
                  library_ms=t[key].get("library_ms"),
                  bound_ms=t[key]["bound"][0], bound_by=t[key]["bound"][1])
        for key in ("dequant_matmul_dx", "dequant_matmul_fwd",
                    "dequant_matmul_prefill", "dequant_matmul_decode_simt",
                    "dequant_matmul_blocked_simt", "flash_attention_train",
                    "flash_attention_f32", "matmul_quant_simt",
                    "dequantize_int8_w_xproj", "flash_attention_d96",
                    "flash_attention_f32_d96", "dequant_matmul_prefill_neox",
                    "flash_attention_d128", "flash_attention_f32_d128",
                    "flash_attention_train_d96",
                    "flash_attention_train_d128", "flash_attention_d256",
                    "flash_attention_d256_window",
                    "flash_attention_f32_d256", "flash_attention_train_d256",
                    "flash_attention_train_d256_window",
                    "selective_scan_train", "flash_attention_d128_deepseek",
                    "flash_attention_train_d128_deepseek",
                    "dequantize_int8_expert_row",
                    "dequantize_int8_expert_row_jamba",
                    "dequantize_int8_w_dkv", "dequantize_int8_w_ukv",
                    "flash_attention_cross", "flash_attention_f32_cross")}
    blk = t["dequant_matmul_blocked"]
    kernels_extra.update(
        dequant_matmul_blocked_bounds=dict(
            path=blk["path"], f32_operations_ms=blk["bound"][0],
            bf16_split_ms=blk["bound_bf16_split"][0],
            bytes_ms=blk["bound_bytes"][0]),
        dequant_matmul_rounding=flips,
        neox_train_products=nts,
        dequant_matmul_threshold=t["dequant_matmul_threshold"],
        dequant_matmul_shapes=t["dequant_matmul_shapes"],
        matmul_quant_per_shape=t["matmul_quant"]["per_shape"],
        matmul_quant_simt_per_shape=t["matmul_quant_simt"]["per_shape"],
        dequantize_int4_bf16=dict(ms=dq4["ms"], plain_ms=dq4["plain_ms"],
                                  bound_ms=dq4["bound"][0],
                                  bound_by=dq4["bound"][1]))
    serve_line = dict(
        arch=s["arch"].name, requests=len(s["reqs"]), slots=s["args"].slots,
        prompt_len=s["args"].prompt_len, gen=s["args"].gen,
        max_len=s["args"].max_len, tokens=s["tokens"], steps=s["steps"],
        prefill_ms=pf["prefill_ms"], decode_step_ms=s["decode_step_ms"],
        decode_step_graph_ms=t["decode_step_graph_ms"],
        decode_step_graph_runs=t["decode_step_graph_runs"],
        tok_s=s["tokens"] / s["run_s"], run_s=s["run_s"],
        setup_s=s["setup_s"], residency_bytes=s["memory"]["wire_bytes"],
        prefill_logits_max_abs_err=pf["logits_err"],
        prefill_logits_max_abs_ref=pf["logits_scale"],
        prefill_f32_logits_max_abs_err=pf["f32_logits_err"],
        prefill_f32_logits_max_abs_ref=pf["f32_logits_scale"],
        prefill_bf16_kernel_vs_f32_plain=pf["bf16_kernel_vs_f32_plain"],
        prefill_bf16_plain_vs_f32_plain=pf["bf16_plain_vs_f32_plain"],
        **{k: v for k, v in pf.items() if k.startswith("decode_")},
        traced_prefill_wall_ms=pf["traced"]["wall_ms"],
        traced_prefill_device_ms=pf["traced"]["device_ms"],
        traced_prefill_top_kernels=pf["traced"]["top"],
        traced_prefill_missed=pf["traced"]["missed"],
        attention_sublayers_held=pf["attention_sublayers_held"],
        attention_sublayer_worst=pf["attention_sublayer_worst"])
    ssm_line = dict(
        arch=m["arch"].name, requests=len(m["reqs"]), slots=m["args"].slots,
        prompt_len=plen, gen=m["args"].gen, max_len=m["args"].max_len,
        tokens=m["tokens"], steps=m["steps"], prefill_ms=mpf["prefill_ms"],
        decode_step_ms=m["decode_step_ms"],
        decode_step_graph_ms=m["decode_step_graph_ms"],
        decode_step_graph_runs=m["decode_step_graph_runs"],
        tok_s=m["tokens"] / m["run_s"], run_s=m["run_s"], setup_s=m["setup_s"],
        residency_bytes=m["memory"]["wire_bytes"],
        dense_bytes=m["memory"]["dense_bytes"],
        max_memory_allocated=m["peak_bytes"],
        prefill_logits_max_abs_err=mpf["logits_err"],
        prefill_logits_max_abs_ref=mpf["logits_scale"],
        prefill_logits_tol=mpf["logits_tol"],
        prefill_argmax_equal=mpf["argmax_equal"],
        prefill_f32_logits_max_abs_err=mpf["f32_logits_err"],
        prefill_f32_logits_max_abs_ref=mpf["f32_logits_scale"],
        prefill_bf16_kernel_vs_f32_plain=mpf["bf16_kernel_vs_f32_plain"],
        prefill_bf16_plain_vs_f32_plain=mpf["bf16_plain_vs_f32_plain"],
        **{k: v for k, v in mpf.items() if k.startswith("decode_")},
        traced_prefill_wall_ms=mpf["traced"]["wall_ms"],
        traced_prefill_device_ms=mpf["traced"]["device_ms"],
        traced_prefill_top_kernels=mpf["traced"]["top"],
        traced_prefill_scan_ms=mpf["traced_scan_ms"],
        traced_prefill_scan_calls=mpf["traced_scan_calls"],
        traced_prefill_missed=mpf["traced"]["missed"],
        scan={str(seq): dict(ms=tm["ms"], plain_ms=tm["plain_ms"],
                             bound_ms=tm["bound"][0], bound_by=tm["bound"][1],
                             sfu_floor_ms=tm["sfu_floor_ms"])
              for seq, tm in scan_t.items()})
    neox_line = serve_attn_line(nx, npf)
    neox10b_line = serve_attn_line(x10, x10pf)
    gemma_line = serve_attn_line(gm, gpf)
    deepseek_line = serve_attn_line(ds, dspf)
    moe_line = dict(serve_attn_line(mo, mopf),
                    n_experts=mo["arch"].moe.n_experts,
                    build_peak_bytes=mo["setup_peak_bytes"],
                    build_peak_predicted=mo["build_peak_predicted"],
                    decode_step_launches=mo["step_launches"],
                    routing_rows_differ=mopf["routing_rows_differ"],
                    own_routing_logits_err=mopf["own_routing_logits_err"])
    mixtral_line_ = mixtral_line(mx, mxpf)
    jamba_line_ = jamba_line(jb, jbpf, jb_t)
    train_jamba_line = cut_train_line(
        tjb, "scan", pattern_published=dict(collections.Counter(
            jb["arch"].pattern)), d_inner=tjb["arch"].d_inner)
    train_moe_line = cut_train_line(tmo, "flash",
                                    n_experts=tmo["arch"].moe.n_experts)
    train_vlm_line = cut_train_line(tvl, "flash",
                                    n_patches=tvl["arch"].n_patches)
    train_mla_line = cut_train_line(
        tml, "matmul_quant_tc", mla=dataclasses.asdict(tml["arch"].mla),
        fallbacks_per_step_per_rank={MLA_FALLBACK: 2 * MLA_TRAIN_L})
    train_whisper_line = cut_train_line(
        twh, "flash", enc_layers=twh["arch"].enc_layers,
        n_frames=twh["arch"].n_frames,
        fallbacks_per_step_per_rank={UNALIGNED: 4 * WHISPER_TRAIN_L})
    mla_line_ = mla_line(ml, mlpf)
    k0 = tr["kernel"][0]
    # the first step pays for the kernels' first use, the last is traced
    timed = slice(1, PROFILE_STEP)
    train_line = dict(
        arch="qwen2-0.5b", n_layers=tr["arch"].n_layers, scheme="zero_topo",
        mesh=[1, 2, 2], ranks=4,
        global_batch=8, seq=1024, steps=tr["steps"], losses=k0["losses"],
        grad_norms=k0["grad_norms"], plain_losses=tr["plain"][0]["losses"],
        plain_grad_norms=tr["plain"][0]["grad_norms"],
        step_s=k0["step_times"],
        step_s_median=statistics.median(k0["step_times"][timed]),
        tok_s_median=statistics.median(k0["tokens_per_s"][timed]),
        plain_step_s=tr["plain"][0]["step_times"],
        peak_bytes_per_rank=[r["peak_bytes"] for r in tr["kernel"]],
        payload_bytes_per_step_per_rank={
            op: b / tr["steps"] for op, b in k0["payload_bytes"].items()},
        phase_s_per_step=[{k: v / tr["steps"] for k, v in r["phase_s"].items()}
                          for r in tr["kernel"]],
        collective_s_per_step=[{k: v / tr["steps"]
                                for k, v in r["collective_s"].items()}
                               for r in tr["kernel"]],
        traced_step_wall_ms=[r["profile"]["wall_ms"] for r in tr["kernel"]],
        traced_step_device_ms=[r["profile"]["device_ms"] for r in tr["kernel"]],
        traced_step_top_kernels_rank0=k0["profile"]["top"],
        traced_step_matmul_quant=tr["matmul_quant_traced"],
        state_bytes_per_rank=k0["memory"], run_s=tr["run_s"],
        plain_run_s=tr["plain_run_s"])
    train_neox_line = cut_train_line(tn, "flash")
    train_deepseek_line = cut_train_line(tds, "flash")
    sm_arch = tsm["arch"]
    train_ssm_line = cut_train_line(
        tsm, "scan", d_inner=sm_arch.d_inner, d_state=sm_arch.ssm.d_state,
        dt_rank=sm_arch.dt_rank)
    train_gemma_line = cut_train_line(
        tgm, "flash", window=tgm["arch"].sliding_window)
    regimes_line = dict(
        steps=REGIME_STEPS, seed_losses=k0["losses"][:REGIME_STEPS],
        seed_grad_norms=k0["grad_norms"][:REGIME_STEPS],
        seed_step_s=k0["step_times"][:REGIME_STEPS],
        seed_peak_bytes_per_rank=[r["peak_bytes"] for r in tr["kernel"]],
        seed_grad_buffer=k0["memory"]["grad_buffer"], runs=[])
    for rg in regimes:
        r0 = rg["ranks"][0]
        regimes_line["runs"].append(dict(
            flags=rg["flags"], losses=r0["losses"],
            grad_norms=r0["grad_norms"], bitwise_vs_seed=rg["bitwise"],
            loss_rel=rg["loss_rel"], grad_norm_rel=rg["grad_norm_rel"],
            step_s=r0["step_times"],
            step_s_median=statistics.median(r0["step_times"][1:]),
            tok_s_median=statistics.median(r0["tokens_per_s"][1:]),
            peak_bytes_per_rank=[r["peak_bytes"] for r in rg["ranks"]],
            grad_buffer=r0["memory"]["grad_buffer"],
            prefetch_buffer=r0["memory"]["prefetch_buffer"],
            payload_bytes_per_step_per_rank={
                op: b / REGIME_STEPS for op, b in r0["payload_bytes"].items()},
            phase_s_per_step=[{k: v / REGIME_STEPS
                               for k, v in r["phase_s"].items()}
                              for r in rg["ranks"]],
            run_s=rg["run_s"]))
    collectives_line = dict(
        mesh=[1, 2, 2], ranks=4, elements_per_rank=EMBED_N, quant_block=128,
        cases=cl[0]["cases"],
        max_abs_over_bound=max(c["abs_over_bound"] for r in cl
                               for c in r["cases"]),
        quant_error=qe_rows)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(
            card=card, phases=phases, kernels=kernels,
            kernels_extra=kernels_extra,
            serve=serve_line, serve_ssm=ssm_line, serve_neox=neox_line,
            serve_neox10b=neox10b_line, serve_gemma=gemma_line,
            serve_deepseek=deepseek_line, serve_moe=moe_line,
            serve_mixtral=mixtral_line_, serve_vlm=vl,
            serve_mla=mla_line_, serve_whisper=wh, serve_jamba=jamba_line_,
            train_jamba=train_jamba_line,
            train_jamba_ranks=tjb["kernel"], train_jamba_plain_ranks=tjb["plain"],
            train_moe=train_moe_line, train_vlm=train_vlm_line,
            train_mla=train_mla_line, train_whisper=train_whisper_line,
            train=train_line,
            train_neox=train_neox_line, train_deepseek=train_deepseek_line,
            train_ssm=train_ssm_line,
            train_gemma=train_gemma_line,
            regimes=regimes_line, collectives=collectives_line,
            ckpt=ckpt_line(ck), ckpt_ranks=[leg["ranks"] for leg in ck["legs"]],
            replica=replica_line(rp), replica_ranks=rp["kernel"],
            serve_mesh=serve_mesh_line(sm),
            replica_plain_ranks=rp["plain"],
            plan=plan_line(pl), plan_ranks=pl["kernel"],
            dryrun=dryrun_line(dr),
            plan_plain_ranks=pl["plain"],
            collective_ranks=cl,
            regime_ranks=[rg["ranks"] for rg in regimes],
            train_ranks=tr["kernel"], train_plain_ranks=tr["plain"],
            train_neox_ranks=tn["kernel"], train_neox_plain_ranks=tn["plain"],
            train_deepseek_ranks=tds["kernel"],
            train_deepseek_plain_ranks=tds["plain"],
            train_ssm_ranks=tsm["kernel"], train_ssm_plain_ranks=tsm["plain"],
            train_gemma_ranks=tgm["kernel"],
            train_gemma_plain_ranks=tgm["plain"],
            train_moe_ranks=tmo["kernel"], train_moe_plain_ranks=tmo["plain"],
            train_vlm_ranks=tvl["kernel"], train_vlm_plain_ranks=tvl["plain"],
            train_mla_ranks=tml["kernel"], train_mla_plain_ranks=tml["plain"],
            train_whisper_ranks=twh["kernel"],
            train_whisper_plain_ranks=twh["plain"],
            checks=checks, timing={k: v for k, v in t.items()},
            launches=s["launches"], launches_ssm=m["launches"],
            launches_neox=nx["launches"], launches_neox10b=x10["launches"],
            launches_gemma=gm["launches"], launches_deepseek=ds["launches"],
            build=kcuda.BUILD_LOG,
            torch=torch.__version__, cuda=torch.version.cuda),
            indent=1, default=str))

    phase("report")
    print("serve " + json.dumps(serve_line))
    print("serve_ssm " + json.dumps(ssm_line))
    print("serve_neox " + json.dumps(neox_line))
    print("serve_neox10b " + json.dumps(neox10b_line))
    print("serve_gemma " + json.dumps(gemma_line))
    print("serve_deepseek " + json.dumps(deepseek_line))
    print("serve_moe " + json.dumps(moe_line))
    print("serve_mixtral " + json.dumps(mixtral_line_))
    print("serve_vlm " + json.dumps(vl))
    print("serve_mla " + json.dumps(mla_line_))
    print("serve_whisper " + json.dumps(wh))
    print("serve_jamba " + json.dumps(jamba_line_))
    print("train " + json.dumps(train_line))
    print("train_neox " + json.dumps(train_neox_line))
    print("train_deepseek " + json.dumps(train_deepseek_line))
    print("train_ssm " + json.dumps(train_ssm_line))
    print("train_gemma " + json.dumps(train_gemma_line))
    print("train_moe " + json.dumps(train_moe_line))
    print("train_vlm " + json.dumps(train_vlm_line))
    print("train_mla " + json.dumps(train_mla_line))
    print("train_whisper " + json.dumps(train_whisper_line))
    print("train_jamba " + json.dumps(train_jamba_line))
    print("regimes " + json.dumps(regimes_line))
    print("collectives " + json.dumps(collectives_line))
    print("ckpt " + json.dumps(ckpt_line(ck)))
    print("replica " + json.dumps(replica_line(rp)))
    print("serve_mesh " + json.dumps(serve_mesh_line(sm)))
    print("plan " + json.dumps(plan_line(pl)))
    print("dryrun " + json.dumps(dryrun_line(dr)))
    print("kernels_extra " + json.dumps(kernels_extra))
    print(json.dumps({"kernels": kernels}))
    print(f"device: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        # the launcher's fork server, where this run started one
        launcher = sys.modules.get("repro_torch.launch.train")
        if launcher is not None:
            launcher.stop_fork_server()
    sys.exit(code)
